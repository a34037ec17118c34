"""Hand-written Hopper kernels of the port and their wrappers.

Every kernel is CUDA C++ under ``gaze_tpu_torch/csrc/``, compiled at
first use (``build.py``). Each wrapper takes the kernel's plain PyTorch
version for CPU tensors and launches the kernel for CUDA tensors; there
is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Dict

from gaze_tpu_torch.ops.cuda import build, conv_int8, tvl1_pd, warp


def kernels() -> Dict[str, build.CudaKernel]:
    """Every kernel the port has, by name."""
    return {"warp3": warp.KERNEL, "tvl1_pd": tvl1_pd.KERNEL, "conv3x3_int8": conv_int8.KERNEL}


def reset_launch_counts() -> None:
    for k in kernels().values():
        k.launches = 0


def build_all() -> float:
    """Compile every kernel source together; returns the seconds spent."""
    return build.build(sorted({k.source for k in kernels().values()}))
