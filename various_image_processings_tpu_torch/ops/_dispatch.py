"""Implementation dispatch: every op has a `torch` path (eager PyTorch, the
plain version each kernel is tested against, runs on any device) and a
`cuda` path (the hand-written kernel).

`impl="auto"` is decided by the input tensor's device alone: a CUDA tensor
takes the kernel, a CPU tensor the plain version.  Nothing falls back: a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

VALID_IMPLS = ("auto", "torch", "cuda")


def check_impl(impl: str) -> None:
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS}, got {impl!r}")


def resolve_impl(impl: str, tensor: torch.Tensor) -> str:
    check_impl(impl)
    if impl == "auto":
        return "cuda" if tensor.is_cuda else "torch"
    if impl == "cuda" and not tensor.is_cuda:
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on {tensor.device}")
    return impl
