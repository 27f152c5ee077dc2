"""The integer convolution core of the int8 chain: int8 NHWC codes and an
int8 HWIO kernel -> the exact int32 accumulator.

The JAX chain runs these convs as XLA int8 convolutions
(``conv_general_dilated(..., preferred_element_type=int32)``), not as
Pallas kernels, so stock PyTorch may carry them; PyTorch has no int8
convolution on CUDA, so:

- on the card: im2col of the padded int8 map (a strided view made
  contiguous: [B*Ho*Wo, kh*kw*C]) times the kernel as [kh*kw*C, O]
  through ``torch._int_mm`` (cuBLASLt int8 x int8 -> int32), with zero
  rows added where a conv has 16 or fewer, and the kernel's output
  channels zero-padded to a multiple of 8 where a conv has other (the
  CenterNet chain's heads: 1, 2 or 4).  Its other shape conditions are
  checked here and raise; there is no quiet fallback;
- on the CPU: a float64 ``F.conv2d`` of the codes rounded to int32,
  exact because 127^2 * kh * kw * C < 2^53.

Integer sums are exact in any order, so both equal the JAX accumulator.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


MIN_INT_MM_ROWS = 16   # torch._int_mm takes more rows than this
PADDED_ROWS = 32
INT_MM_ALIGN = 8       # torch._int_mm's K and N are multiples of this


def _pairs(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d_int8_f64(q: torch.Tensor, qk: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """The float64 convolution of the codes, rounded to int32: exact, the
    CPU path and the reference on the card."""
    acc = F.conv2d(q.permute(0, 3, 1, 2).to(torch.float64),
                   qk.permute(3, 2, 0, 1).to(torch.float64),
                   stride=_pairs(stride), padding=_pairs(padding))
    return acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv2d_int8_im2col(q: torch.Tensor, qk: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """The card's route: im2col of the padded map times the kernel through
    ``torch._int_mm``, which needs more than 16 rows and K and N multiples
    of 8.  A conv with 16 rows or fewer (a batch-1 frame's last FPN
    levels) runs with zero rows up to 32, and one whose O is not a
    multiple of 8 (a head of 1, 2 or 4 channels) with zero output
    channels up to the next; both are sliced off after, which is exact.
    K = kh kw C must be a multiple of 8 (C >= 16 in every chain conv):
    otherwise this raises."""
    sh, sw = _pairs(stride)
    ph, pw = _pairs(padding)
    b, h, w, c = q.shape
    kh, kw, _, o = qk.shape
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    rows, k = b * ho * wo, kh * kw * c
    if k % INT_MM_ALIGN or qk.shape[2] != c:
        raise ValueError(
            f"torch._int_mm needs K a multiple of {INT_MM_ALIGN}; this conv gives K {k} "
            f"(q {tuple(q.shape)}, qk {tuple(qk.shape)})"
        )
    x = F.pad(q.contiguous(), (0, 0, pw, pw, ph, ph)) if ph or pw else q.contiguous()
    s = x.stride()
    cols = x.as_strided((b, ho, wo, kh, kw, c),
                        (s[0], sh * s[1], sw * s[2], s[1], s[2], s[3]))
    cols = cols.reshape(rows, k)
    if rows <= MIN_INT_MM_ROWS:
        cols = torch.cat((cols, cols.new_zeros(PADDED_ROWS - rows, k)))
    weight = qk.reshape(k, o)
    if o % INT_MM_ALIGN:
        weight = F.pad(weight, (0, -o % INT_MM_ALIGN))
    weight = weight.t().contiguous().t()  # column-major [K, N]
    acc = torch._int_mm(cols, weight)
    if acc.shape != (rows, o):
        acc = acc[:rows, :o]
    return acc.reshape(b, ho, wo, o)


def conv2d_int8(q: torch.Tensor, qk: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """q [B, H, W, C] int8, qk [kh, kw, C, O] int8 -> [B, Ho, Wo, O] int32.

    ``stride`` and ``padding`` are ints or (h, w) pairs; the padding is
    symmetric.  A CPU tensor takes ``conv2d_int8_f64``, a CUDA tensor
    ``conv2d_int8_im2col``."""
    if q.dtype != torch.int8 or qk.dtype != torch.int8:
        raise TypeError(f"q and qk must be int8, got {q.dtype} and {qk.dtype}")
    if q.dim() != 4 or qk.dim() != 4 or qk.shape[2] != q.shape[3]:
        raise ValueError(
            f"q must be [B, H, W, C] and qk [kh, kw, C, O], got "
            f"{tuple(q.shape)} and {tuple(qk.shape)}"
        )
    if q.device.type == "cpu":
        return conv2d_int8_f64(q, qk, stride, padding)
    return conv2d_int8_im2col(q, qk, stride, padding)
