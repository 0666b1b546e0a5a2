"""The device helpers of every entry point, serving and training alike."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU:
    a CUDA device without a usable card raises rather than falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def no_tf32():
    """The reference is full f32. cuDNN convolutions default to TF32 on
    Ampere and later cards (about three decimal digits), which would break
    the 1e-3 chain bar, so every serving entry point and the trainer turn
    both TF32 switches off when they are built."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
