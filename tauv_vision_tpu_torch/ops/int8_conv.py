"""The integer convolution core of the int8 chain: int8 NHWC codes and an
int8 HWIO kernel -> the exact int32 accumulator.

The JAX chain runs these convs as XLA int8 convolutions
(``conv_general_dilated(..., preferred_element_type=int32)``), not as
Pallas kernels, so stock PyTorch may carry them; PyTorch has no int8
convolution on CUDA, so:

- on the card: im2col of the padded int8 map (a strided view made
  contiguous: [B*Ho*Wo, kh*kw*C]) times the kernel as [kh*kw*C, O]
  through ``torch._int_mm`` (cuBLASLt int8 x int8 -> int32).  Its shape
  conditions are checked here and raise; there is no quiet fallback;
- on the CPU: a float64 ``F.conv2d`` of the codes rounded to int32,
  exact because 127^2 * kh * kw * C < 2^53.

Integer sums are exact in any order, so both equal the JAX accumulator.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _pairs(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d_int8_f64(q: torch.Tensor, qk: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """The float64 convolution of the codes, rounded to int32: exact, the
    CPU path and the reference on the card."""
    acc = F.conv2d(q.permute(0, 3, 1, 2).to(torch.float64),
                   qk.permute(3, 2, 0, 1).to(torch.float64),
                   stride=_pairs(stride), padding=_pairs(padding))
    return acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv2d_int8(q: torch.Tensor, qk: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """q [B, H, W, C] int8, qk [kh, kw, C, O] int8 -> [B, Ho, Wo, O] int32.

    ``stride`` and ``padding`` are ints or (h, w) pairs; the padding is
    symmetric."""
    if q.dtype != torch.int8 or qk.dtype != torch.int8:
        raise TypeError(f"q and qk must be int8, got {q.dtype} and {qk.dtype}")
    if q.dim() != 4 or qk.dim() != 4 or qk.shape[2] != q.shape[3]:
        raise ValueError(
            f"q must be [B, H, W, C] and qk [kh, kw, C, O], got "
            f"{tuple(q.shape)} and {tuple(qk.shape)}"
        )
    if q.device.type == "cpu":
        return conv2d_int8_f64(q, qk, stride, padding)
    sh, sw = _pairs(stride)
    ph, pw = _pairs(padding)
    b, h, w, c = q.shape
    kh, kw, _, o = qk.shape
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    rows, k = b * ho * wo, kh * kw * c
    if rows <= 16 or k % 8 or o % 8:
        raise ValueError(
            f"torch._int_mm needs more than 16 rows and K, N multiples of 8; "
            f"this conv gives rows {rows}, K {k}, N {o}"
        )
    x = F.pad(q.contiguous(), (0, 0, pw, pw, ph, ph)) if ph or pw else q.contiguous()
    s = x.stride()
    cols = x.as_strided((b, ho, wo, kh, kw, c),
                        (s[0], sh * s[1], sw * s[2], s[1], s[2], s[3]))
    cols = cols.reshape(rows, k)
    weight = qk.reshape(k, o).t().contiguous().t()  # column-major [K, O]
    return torch._int_mm(cols, weight).reshape(b, ho, wo, o)
