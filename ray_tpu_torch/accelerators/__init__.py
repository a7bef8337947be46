"""Accelerator detection: the cards of this host as scheduler resources.

The counterpart of ``ray_tpu/accelerators/tpu.py``'s ``tpu_resources()``
(``TPU`` count plus a ``TPU-<version>`` marker): :func:`gpu_resources`
registers ``GPU`` at the card count plus a ``GPU-<model>`` marker at the
same count (``GPU-H100``), so ``accelerator_type="H100"`` (a ``GPU-H100:
0.001`` request) places work on that model. With no card it registers
nothing: work that asks for ``num_gpus`` is then infeasible, never run on
the CPU.
"""

from __future__ import annotations

from typing import Dict

import torch


_BRANDS = {"NVIDIA", "TESLA", "GEFORCE", "QUADRO"}


def gpu_model(device_name: str) -> str:
    """The model token of a CUDA device name, upper-cased, with the vendor
    and brand words dropped: ``"NVIDIA H100 80GB HBM3"`` -> ``"H100"``,
    ``"Tesla V100-SXM2-16GB"`` -> ``"V100"``."""
    words = [w for w in device_name.upper().split() if w not in _BRANDS]
    return words[0].split("-")[0] if words else "UNKNOWN"


def gpu_resources() -> Dict[str, float]:
    """Scheduler resources for this host's cards: ``{"GPU": n,
    "GPU-<model>": n}``, ``{}`` with no card."""
    if not torch.cuda.is_available():
        return {}
    n = torch.cuda.device_count()
    if n == 0:
        return {}
    return {"GPU": float(n),
            f"GPU-{gpu_model(torch.cuda.get_device_name(0))}": float(n)}
