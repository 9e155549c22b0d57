"""Explicit device choice: the port never picks a device behind the
caller's back.  `cuda` must be available when asked for; the CPU runs only
when the caller names it (the tests, and the plain-version cross-check)."""

from __future__ import annotations

import torch


def pick_device(name: str | torch.device = "cuda") -> torch.device:
    """Return `torch.device(name)`; raise if it is a CUDA device and CUDA
    is not available (there is no silent fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False "
            "(pass device='cpu' explicitly to run the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # tensors report cuda:<n>; name the card so devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

