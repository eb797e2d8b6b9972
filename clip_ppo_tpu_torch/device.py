"""Device selection for the entry points: CUDA unless the caller asks for
the CPU, and never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(cuda: bool = True) -> torch.device:
    """``cuda=True`` requires a GPU and raises without one; ``cuda=False``
    is the CPU (what the tests use)."""
    if not cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--cuda (the default) needs a CUDA device and torch.cuda.is_available() "
            "is False; pass --no-cuda to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
