"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
device given and no GPU present they raise: a caller who meant the card must
never end up on the CPU without knowing it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but no CUDA "
                               f"device is available")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
