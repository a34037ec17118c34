"""Device resolution and the parity precision switch.

The port's entry points run on the card: ``device=None`` means ``cuda``,
and a missing CUDA runtime is an error, never a silent move to the CPU.
The CPU is used only when the caller asks for it (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_parity_precision() -> None:
    """Full float32 for convolutions and matmuls on the card.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the JAX reference pins float32 matmul
    precision, so the parity path turns TF32 off for both.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
