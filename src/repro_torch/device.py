"""Device and dtype resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Asking for CUDA on a machine without it raises; nothing
    falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the port's plain PyTorch path on the CPU"
        )
    return dev


def resolve_dtype(dtype: Optional[Union[str, torch.dtype]],
                  device: torch.device) -> torch.dtype:
    """bf16 on the card and float32 on the CPU unless the caller picks."""
    if dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of {sorted(DTYPES)}")
    return DTYPES[dtype]
