"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """-> torch.device for `device` (CUDA with an explicit index); raises
    RuntimeError if CUDA is asked for and unavailable (no silent fall back
    to the CPU).

    Also turns TF32 off for matmuls and cuDNN: the JAX reference computes
    float32 products in full float32 on the CPU, and TF32 keeps only ~3
    decimal digits, which would break the CPU-vs-card comparisons.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (use 'cuda' or 'cpu')")
    if dev.type == "cuda" and dev.index is None:
        # explicit index, so it compares equal to a tensor's .device
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
