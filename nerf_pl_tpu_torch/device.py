"""The device a CLI or a training system runs on."""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[torch.device | str] = None
                   ) -> torch.device:
    """`device` as given, or cuda:0 when none is given. Without CUDA that
    raises: nothing falls back to the CPU unless the caller asks for it
    with device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "false. Pass device='cpu' to run on the CPU.")
    return torch.device("cuda", 0)
