"""ray_tpu_torch.dag — compiled static actor DAGs.

The port's copy of ``ray_tpu/dag/__init__.py``: ``InputNode``, multi-arg
``.bind()`` on actor methods, ``MultiOutputNode`` for gathered leaves,
``experimental_compile()`` → resident actor loops over mutable multi-slot
shm ring channels (same host), credit-windowed socket channels (cross
host), or device channels (torch tensors landing on the reader's device
through pinned staging and a side-stream copy).
"""

from ray_tpu_torch.dag.channel import (Channel, ChannelClosed, ChannelTimeout,
                                       SocketChannel)
from ray_tpu_torch.dag.compiled_dag import CompiledDAG, DAGRef
from ray_tpu_torch.dag.dag_node import (ClassMethodNode, DAGNode, InputNode,
                                        MultiOutputNode)
from ray_tpu_torch.dag.device_channel import DeviceChannel

__all__ = [
    "InputNode",
    "DAGNode",
    "ClassMethodNode",
    "MultiOutputNode",
    "CompiledDAG",
    "DAGRef",
    "Channel",
    "SocketChannel",
    "ChannelClosed",
    "ChannelTimeout",
    "DeviceChannel",
]
