"""Hand-written CUDA kernels and their plain PyTorch versions."""
from __future__ import annotations

import torch


def forbid_autograd(kernel: str, *tensors) -> None:
    """Raise where autograd would record a call of ``kernel``.

    A kernel writes its output through a raw pointer, so the output has no
    ``grad_fn``: a backward through it would finish and leave the inputs'
    grads unset.  None of the kernels has a backward (the reference's
    Pallas kernels have none either), so a call with grad enabled and a
    floating-point input that requires grad is refused."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.is_floating_point() and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an input requires grad; call it under"
            " torch.no_grad() or torch.inference_mode(), or run the model on the CPU, where the"
            " plain version is differentiable")
