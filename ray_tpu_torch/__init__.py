"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

The JAX package ``ray_tpu`` is the reference; this package carries its
counterparts slice by slice, with PyTorch for tensor code and kernels
written by hand for NVIDIA Hopper in place of the Pallas TPU kernels. It
imports nothing of ``ray_tpu`` and nothing of JAX.
"""

__version__ = "0.1.0"
