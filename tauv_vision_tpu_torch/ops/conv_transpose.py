"""Depthwise transposed-conv upsample of the CenterNet aggregation stage.

A groups=C ``ConvTranspose2d(kernel=2f, stride=f, padding=f//2,
bias=False)``.  ``depthwise_upsample`` is the plain version;
``depthwise_upsample_cuda`` wraps ``csrc/depthwise_upsample.cu``, the
counterpart of ``tauv_vision_tpu/ops/pallas/depthwise_upsample.py``;
``depthwise_upsample_train`` is that wrapper under autograd.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from tauv_vision_tpu_torch import kernels


def bilinear_kernel(k: int) -> np.ndarray:
    """The fill_up_weights bilinear upsample kernel [k, k]."""
    f = int(np.ceil(k / 2))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w = np.zeros((k, k), np.float32)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
    return w


ENTRY_POINTS = {torch.float32: "tauv_depthwise_upsample_f32",
                torch.bfloat16: "tauv_depthwise_upsample_bf16"}
CARD_FACTORS = (1, 2, 4, 8)   # the divisors of the kernel's 8-output run
BACKWARD_RANGE = "depthwise_upsample/backward"


def depthwise_upsample(x: torch.Tensor, weight: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain version: x [B, C, H, W], weight [C, 1, 2f, 2f], both f32 or
    both bf16.  bf16 runs the f32 version on the upcast values (the
    products of bf16 values are exact in f32) and rounds once to bf16."""
    dtype = x.dtype
    if dtype == torch.bfloat16:
        x, weight = x.float(), weight.float()
    return F.conv_transpose2d(
        x, weight, stride=factor, padding=factor // 2, groups=x.shape[1]
    ).to(dtype)


def depthwise_upsample_cuda(
    x: torch.Tensor, weight: torch.Tensor, factor: int
) -> torch.Tensor:
    """Kernel C: ``depthwise_upsample`` as one CUDA op.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  x [B, C, H, W] and weight [C, 1, 2f, 2f], both f32
    or both bf16 (the bf16 variant accumulates in f32 and rounds once);
    on the card f is 1, 2, 4 or 8 (DLA-34 upsamples by 2, 4 and 8)."""
    b, c, h, w = x.shape
    k = 2 * factor
    if factor < 1 or tuple(weight.shape) != (c, 1, k, k):
        raise ValueError(
            f"weight must be [C, 1, 2f, 2f] = [{c}, 1, {k}, {k}] for "
            f"factor {factor}, got {tuple(weight.shape)}"
        )
    if x.device.type == "cpu":
        return depthwise_upsample(x, weight, factor)
    if factor not in CARD_FACTORS:
        raise ValueError(f"factor must be one of {CARD_FACTORS} on the card, got {factor}")
    if x.dtype not in ENTRY_POINTS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    kernels.check_cuda_tensor(x, "x", x.dtype, 4)
    kernels.check_cuda_tensor(weight, "weight", x.dtype, 4)
    pad = factor // 2
    ho = (h - 1) * factor - 2 * pad + k
    wo = (w - 1) * factor - 2 * pad + k
    out = torch.empty((b, c, ho, wo), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    kernels.launch(
        ENTRY_POINTS[x.dtype], "depthwise_upsample",
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), b, c, h, w, factor,
    )
    return out


class _DepthwiseUpsampleFunction(torch.autograd.Function):
    """Kernel C under autograd.  The forward is ``depthwise_upsample_cuda``
    (the kernel on a CUDA tensor, the plain version on a CPU one) and
    saves only its inputs.  The backward recomputes the plain version from
    them under ``torch.enable_grad()`` and takes ``torch.autograd.grad``
    of it, to x and to the weight as they need: stock PyTorch autograd,
    the counterpart of XLA's autodiff of the dilated conv that the JAX
    package trains through (it has no backward kernel).  It is not a
    fallback: the forward on the card is the kernel or raises.  The
    backward is the ``torch.profiler`` range ``BACKWARD_RANGE``."""

    @staticmethod
    def forward(ctx, x, weight, factor):
        ctx.save_for_backward(x, weight)
        ctx.factor = factor
        return depthwise_upsample_cuda(x, weight, factor)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        needs = ctx.needs_input_grad[:2]
        inputs = [t.detach().requires_grad_(n) for t, n in zip((x, weight), needs)]
        with record_function(BACKWARD_RANGE), torch.enable_grad():
            out = depthwise_upsample(*inputs, ctx.factor)
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if n else None for n in needs) + (None,)


def depthwise_upsample_train(x: torch.Tensor, weight: torch.Tensor, factor: int) -> torch.Tensor:
    """``depthwise_upsample_cuda`` with gradients to x and weight (see
    ``_DepthwiseUpsampleFunction``)."""
    return _DepthwiseUpsampleFunction.apply(x, weight, factor)
