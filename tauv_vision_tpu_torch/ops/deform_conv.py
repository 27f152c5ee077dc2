"""Modulated deformable convolution v2 (DCNv2), 3x3, stride 1, padding 1.

The sample of output pixel (y, x) at tap k = 3 ky + kx sits at
(y - 1 + ky + dy_k, x - 1 + kx + dx_k), each bilinear corner outside the
map reads zero, and the mask multiplies the sample.  NCHW throughout: x
[B, C, H, W], offset [B, 18, H, W] f32 with channel 2k = dy and 2k + 1 =
dx of tap k (taps row-major), mask [B, 9, H, W] (already sigmoided, x's
dtype) or None, weight [O, C, 3, 3] in x's dtype, bias [O] f32 or None.

Offsets are unbounded (torchvision's semantics) unless ``max_offset`` R
is set: then, as in the JAX package's ``deform_conv2d_shift`` and its
Pallas kernel, a corner whose integer shift from the tap's base lies
outside [-ceil(R), floor(R) + 1] adds zero (``window``).

How each case rounds, as the JAX package computes it:

- f32, no window: the gather formulation of
  ``tauv_vision_tpu/ops/deform_conv.deform_conv2d``;
- f32 with a window: ``deform_conv2d_shift``'s hat formulation, the hat
  weights max(0, 1 - |d - s|) of the offset d at the shifts s = floor(d)
  and floor(d) + 1, each row's column pair summed first, then the rows,
  then x mask, every step an f32 op;
- bf16: the same hats, as the Pallas kernel's body
  (``tauv_vision_tpu/ops/pallas/deform_conv._dcn_kernel``, variant
  "full") rounds: the sample rounded to bf16, its product with the bf16
  weight summed in f32, + the f32 bias, rounded to bf16;
- ``variant="lerp"`` (a window of R <= 1 only): the Pallas body's
  variant "lerp", exact where every |offset| <= 1.  On each axis the
  corners at shifts 0 and sign(d) (+1 at d == 0) from the tap's base,
  lerp0 = t00 + |dx| (t0s - t00), lerps the same on the row at sign(dy),
  then lerp0 + |dy| (lerps - lerp0), x mask, every step an f32 op; the
  sample rounded to x's dtype, then as above.  Past |d| = 1 it would
  extrapolate from those two corners (weights 1 - |d| < 0 and |d|)
  where the window drops the corners outside it, so the port takes it
  only where the offsets are bounded inside it (``dcn_variant``).

``deform_conv2d`` is the plain version; ``deform_conv2d_cuda`` wraps
``csrc/deform_conv.cu`` (kernel E, entry points ``tauv_deform_conv_f32``
and ``tauv_deform_conv_bf16``), the counterpart of
``tauv_vision_tpu/ops/pallas/deform_conv.deform_conv2d_pallas``;
``deform_conv2d_train`` is that wrapper under autograd.
``DeformConv2d`` holds the weight and bias under the reference's
``DeformConv2d`` names.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.params import cast_parameter

N_TAPS = 9
IMPLS = ("kernel", "plain")
DTYPES = {torch.float32: "tauv_deform_conv_f32", torch.bfloat16: "tauv_deform_conv_bf16"}
MAX_O = 256
# The kernel's block tiles: BN output channels (O padded up to the next),
# and BM pixels, 128 where O fits in 64 and the call has pixels enough.
TILE_N = (64, 128, 256)
MIN_SPLIT_STEPS = 8     # K steps a split keeps at least
BACKWARD_RANGE = "deform_conv/backward"
# The (lo, hi) that tells kernel E "no window": lo at INT_MIN.
NO_WINDOW = (-2**31, 0)
# The sampling bodies: the hats (or, with no window, the gather), and the
# sign-selected lerp of the Pallas kernel, exact for |offset| <= LERP_REACH.
VARIANTS = ("full", "lerp")
LERP_REACH = 1.0


def _check_shapes(x, offset, mask, weight, bias) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(
            f"weight must be [O, {c}, 3, 3] (stride, padding and dilation "
            f"1 only), got {tuple(weight.shape)}"
        )
    if tuple(offset.shape) != (b, 2 * N_TAPS, h, w):
        raise ValueError(
            f"offset must be [{b}, 18, {h}, {w}], got {tuple(offset.shape)}"
        )
    if mask is not None and tuple(mask.shape) != (b, N_TAPS, h, w):
        raise ValueError(f"mask must be [{b}, 9, {h}, {w}], got {tuple(mask.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be [{weight.shape[0]}], got {tuple(bias.shape)}")


def _gather(flat: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor,
            h: int, w: int) -> torch.Tensor:
    """flat [B, C, H*W] at integer-valued float positions yi, xi [B, P],
    zero outside the map, as f32 [B, C, P]."""
    valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
    idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
    vals = torch.gather(flat, 2, idx[:, None, :].expand(-1, flat.shape[1], -1))
    return vals.float() * valid[:, None, :]


def _bilinear_sample(flat: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                     h: int, w: int) -> torch.Tensor:
    """Sample flat [B, C, H*W] f32 at float positions y, x [B, P] with zero
    outside the map; returns [B, C, P]."""
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    return (_gather(flat, y0, x0, h, w) * (wy0 * wx0)[:, None]
            + _gather(flat, y0, x0 + 1, h, w) * (wy0 * wx1)[:, None]
            + _gather(flat, y0 + 1, x0, h, w) * (wy1 * wx0)[:, None]
            + _gather(flat, y0 + 1, x0 + 1, h, w) * (wy1 * wx1)[:, None])


def _hats(d: torch.Tensor):
    """floor(d) and the Pallas body's hat weights of d at floor(d) and
    floor(d) + 1."""
    f = torch.floor(d)
    return f, 1.0 - (d - f), torch.clamp_min(1.0 - torch.abs(d - (f + 1.0)), 0.0)


def _deform_conv2d_bf16(x, offset, mask, weight, bias):
    b, c, h, w = x.shape
    flat = x.reshape(b, c, h * w)
    grid_y = torch.arange(h, dtype=torch.float32, device=x.device) - 1
    grid_x = torch.arange(w, dtype=torch.float32, device=x.device) - 1
    base_y = grid_y[:, None].expand(h, w).reshape(1, h * w)
    base_x = grid_x[None, :].expand(h, w).reshape(1, h * w)
    weight = weight.float()
    out = torch.zeros((b, weight.shape[0], h * w), dtype=torch.float32, device=x.device)
    for tap in range(N_TAPS):
        ky, kx = divmod(tap, 3)
        fy, wy0, wy1 = _hats(offset[:, 2 * tap].reshape(b, h * w).float())
        fx, wx0, wx1 = _hats(offset[:, 2 * tap + 1].reshape(b, h * w).float())
        ry, rx = base_y + ky + fy, base_x + kx + fx
        rows = [_gather(flat, ry + i, rx, h, w) * wx0[:, None]
                + _gather(flat, ry + i, rx + 1, h, w) * wx1[:, None] for i in (0, 1)]
        sampled = rows[0] * wy0[:, None] + rows[1] * wy1[:, None]
        if mask is not None:
            sampled = sampled * mask[:, tap].reshape(b, 1, h * w).float()
        sampled = sampled.to(torch.bfloat16).float()
        out = out + torch.einsum("bcp,oc->bop", sampled, weight[:, :, ky, kx])
    if bias is not None:
        out = out + bias.float()[:, None]
    return out.to(torch.bfloat16).reshape(b, -1, h, w)


def dcn_variant(max_offset: Optional[float], offset_bound: Optional[float]) -> str:
    """The sampling body a DCN serves with: "lerp" where both the window
    ``max_offset`` and the tanh bound ``offset_bound`` are set and at most
    ``LERP_REACH`` (``bench.py --dcn-bound --dcn-max-offset R`` with R <= 1),
    so that every offset lies where the lerp is exact; else "full".  The
    JAX package serves "lerp" wherever R <= 1 (``centerpoint_dla.py:515-521``,
    ``quantize_chain.py:981-992``) and its kernel checks only R, not the
    offsets: unbounded, an offset past one cell is extrapolated there
    (ROADMAP, "Known defects on the reference side"), where the port's
    window drops the corners outside it."""
    bounded = (max_offset is not None and offset_bound is not None
               and max_offset <= LERP_REACH and offset_bound <= LERP_REACH)
    return "lerp" if bounded else "full"


def _check_variant(variant: str, max_offset: Optional[float]) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if variant == "lerp" and (max_offset is None or max_offset > LERP_REACH):
        raise ValueError(f"the lerp is exact for offsets within {LERP_REACH} only: it needs a "
                         f"window max_offset <= {LERP_REACH}, got {max_offset}")


def window(max_offset: Optional[float]) -> Optional[Tuple[int, int]]:
    """The shifts [lo, hi] from a tap's base that a ``max_offset`` window
    keeps (``tauv_vision_tpu/ops/pallas/deform_conv._window``): the bilinear
    corners of every |offset| <= R; None with no window."""
    if max_offset is None:
        return None
    return -math.ceil(max_offset), math.floor(max_offset) + 1


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] as f32 rows [B H W, C]: a pixel's channels contiguous."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1]).float()


def _corners(rows: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
             h: int, w: int) -> torch.Tensor:
    """rows (``_rows``) at the integer-valued float positions ys, xs
    [N, B, P] of each pixel's own image, zero outside the map: f32
    [N, B, P, C].  One row index for all the corners, so that autograd's
    backward is one ``index_put_`` with accumulation, which PyTorch sums
    in a fixed order on the card (it sorts the indices).  A corner
    outside the map reads its own pixel's row, times 0: pointing them all
    at one row (a zero row, or the map's edge) would pile their zero
    gradients onto it, which that sum adds one by one."""
    b, p = ys.shape[1:]
    valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    own = torch.arange(b * p, device=rows.device).reshape(b, p)
    idx = torch.where(valid, (ys.long() * w + xs.long()) + (own - own % p), own)
    vals = rows[idx.reshape(-1)].reshape(*idx.shape, rows.shape[1])
    return vals * valid[..., None]


def _absj(u: torch.Tensor) -> torch.Tensor:
    """|u| with derivative +1 at 0, as ``jax.grad(jnp.abs)`` takes it."""
    return torch.where(u >= 0, u, -u)


# The corners of an axis a window reads, as shifts from floor(d): 0 and 1
# carry the bilinear weights, -1 weighs exactly 0 but carries shift's
# subgradient at an integral d (see ``_window_hats``).  A tap reads the 8
# (row, column) pairs of them but (-1, -1), whose value and derivatives
# are all 0.
SHIFTS = (0, 1, -1)
PAIRS = tuple((i, j) for i in range(3) for j in range(3) if (i, j) != (2, 2))


def _window_hats(d: torch.Tensor, lo: int, hi: int):
    """floor(d) and the hat weights max(0, 1 - |d - s|) at the shifts
    s = floor(d) + ``SHIFTS`` (the Pallas body's values), each zero where s
    lies outside [lo, hi], with ``deform_conv2d_shift``'s subgradients at
    ties: ``jnp.abs``' derivative +1 at 0 and ``jnp.maximum``'s half to
    each side.  So where d is integral the derivative is
    -x[s] + x[s + 1] / 2 - x[s - 1] / 2, not the gather's x[s + 1] - x[s]."""
    f = torch.floor(d)
    zero = torch.zeros_like(d)
    weights = []
    for k in SHIFTS:
        s = f + float(k)
        inside = (s >= lo) & (s <= hi)
        weights.append(torch.maximum(1.0 - _absj(d - s), zero) * inside)
    return f, weights


def _per_tap(x, offset, mask, weight, bias, sample):
    """The windowed and lerp plain versions' common frame, NCHW in and out:
    per tap, ``sample(rows, dy, dx, ry, rx)`` -> f32 [B, P, C] from x's rows
    (``_rows``), the tap's offsets dy, dx [B, P] f32 and its base rows and
    columns ry, rx [B, P]; x mask, rounded to x's dtype, its product with
    the tap's weight summed in f32; + bias, rounded to x's dtype."""
    b, c, h, w = x.shape
    p = h * w
    rows = _rows(x)
    grid_y = torch.arange(h, dtype=torch.float32, device=x.device) - 1
    grid_x = torch.arange(w, dtype=torch.float32, device=x.device) - 1
    base_y = grid_y[:, None].expand(b, h, w).reshape(b, p)
    base_x = grid_x[None, :].expand(b, h, w).reshape(b, p)
    out = torch.zeros((b, p, weight.shape[0]), dtype=torch.float32, device=x.device)
    for tap in range(N_TAPS):
        ky, kx = divmod(tap, 3)
        sampled = sample(rows, offset[:, 2 * tap].reshape(b, p).float(),
                         offset[:, 2 * tap + 1].reshape(b, p).float(), base_y + ky, base_x + kx)
        if mask is not None:
            sampled = sampled * mask[:, tap].reshape(b, p, 1).float()
        sampled = sampled.to(x.dtype).float()
        out = out + torch.einsum("bpc,oc->bpo", sampled, weight[:, :, ky, kx].float())
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype).permute(0, 2, 1).reshape(b, -1, h, w).contiguous()


def _deform_conv2d_window(x, offset, mask, weight, bias, lo: int, hi: int):
    """The windowed plain version (see ``deform_conv2d``): per tap, 8
    corners gathered as rows of x's channels, each row's columns summed
    first (shifts 0, 1, then -1 at weight 0), then the rows, every step an
    f32 op (the Pallas body's order, and ``deform_conv2d_shift``'s)."""
    h, w = x.shape[2:]

    def sample(rows, dy, dx, ry, rx):
        fy, wy = _window_hats(dy, lo, hi)
        fx, wx = _window_hats(dx, lo, hi)
        corner = dict(zip(PAIRS, _corners(
            rows, torch.stack([ry + fy + SHIFTS[i] for i, _ in PAIRS]),
            torch.stack([rx + fx + SHIFTS[j] for _, j in PAIRS]), h, w)))
        sampled = None
        for i in range(len(SHIFTS)):
            row = None
            for j in range(len(SHIFTS)):
                if (i, j) in corner:
                    term = corner[i, j] * wx[j][..., None]
                    row = term if row is None else row + term
            term = row * wy[i][..., None]
            sampled = term if sampled is None else sampled + term
        return sampled

    return _per_tap(x, offset, mask, weight, bias, sample)


def _deform_conv2d_lerp(x, offset, mask, weight, bias):
    """The plain lerp (``variant="lerp"``): per tap the 4 corners at shifts
    0 and sign(d) of each axis gathered as rows of x's channels, then the
    Pallas body's lerps, each step an f32 op."""
    h, w = x.shape[2:]

    def sample(rows, dy, dx, ry, rx):
        sy = torch.where(dy < 0, -1.0, 1.0)
        sx = torch.where(dx < 0, -1.0, 1.0)
        t00, t0s, ts0, tss = _corners(rows, torch.stack([ry, ry, ry + sy, ry + sy]),
                                      torch.stack([rx, rx + sx, rx, rx + sx]), h, w)
        ax, ay = dx.abs()[..., None], dy.abs()[..., None]
        lerp0 = t00 + ax * (t0s - t00)
        lerps = ts0 + ax * (tss - ts0)
        return lerp0 + ay * (lerps - lerp0)

    return _per_tap(x, offset, mask, weight, bias, sample)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  mask: Optional[torch.Tensor], weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  max_offset: Optional[float] = None, variant: str = "full") -> torch.Tensor:
    """Plain version: per tap, the corner gathers, x mask, then a GEMM with
    ``weight[:, :, ky, kx]`` accumulated in f32.  Returns [B, O, H, W] in
    x's dtype; the module docstring says how each case rounds.  With a
    ``max_offset`` window, x's gradient sums in a fixed order on the card
    (``_corners``); without one, through ``gather``'s scatter-adds.
    ``variant="lerp"`` samples by the Pallas body's lerp and needs a
    window of at most ``LERP_REACH`` (the caller bounds the offsets)."""
    _check_shapes(x, offset, mask, weight, bias)
    _check_variant(variant, max_offset)
    if variant == "lerp":
        return _deform_conv2d_lerp(x, offset, mask, weight, bias)
    if max_offset is not None:
        return _deform_conv2d_window(x, offset, mask, weight, bias, *window(max_offset))
    if x.dtype == torch.bfloat16:
        return _deform_conv2d_bf16(x, offset, mask, weight, bias)
    b, c, h, w = x.shape
    flat = x.reshape(b, c, h * w)
    grid_y = torch.arange(h, dtype=x.dtype, device=x.device) - 1
    grid_x = torch.arange(w, dtype=x.dtype, device=x.device) - 1
    base_y = grid_y[:, None].expand(h, w).reshape(1, h * w)
    base_x = grid_x[None, :].expand(h, w).reshape(1, h * w)
    out = torch.zeros((b, weight.shape[0], h * w), dtype=torch.float32,
                      device=x.device)
    for tap in range(N_TAPS):
        ky, kx = divmod(tap, 3)
        pos_y = base_y + ky + offset[:, 2 * tap].reshape(b, h * w)
        pos_x = base_x + kx + offset[:, 2 * tap + 1].reshape(b, h * w)
        sampled = _bilinear_sample(flat, pos_y, pos_x, h, w)
        if mask is not None:
            sampled = sampled * mask[:, tap].reshape(b, 1, h * w)
        out = out + torch.einsum("bcp,oc->bop", sampled, weight[:, :, ky, kx])
    if bias is not None:
        out = out + bias[:, None]
    return out.reshape(b, -1, h, w)


def kernel_weights(weight: torch.Tensor, dtype=None) -> torch.Tensor:
    """[O, C, 3, 3] -> kernel E's weight layout [9, BN, C] in ``dtype``
    (the weight's when None): tap t = 3 ky + kx of output channel o, its C
    input channels contiguous (the K-contiguous B operand of the kernel's
    mma.sync, read by ldmatrix), and zero rows from O up to the block's
    BN output channels."""
    o = weight.shape[0]
    bn = next((n for n in TILE_N if o <= n), o)
    taps = weight.to(dtype or weight.dtype).permute(2, 3, 0, 1).reshape(
        N_TAPS, o, -1)
    return torch.nn.functional.pad(taps, (0, 0, 0, bn - o)).contiguous()


def plan(b: int, c: int, h: int, w: int, o: int, dtype, sms: int) -> tuple:
    """Kernel E's launch for a call on a card of ``sms`` streaming
    multiprocessors: (BM, BN, splits).  BN covers O; BM is 128 pixels for
    O <= 64 where that still gives a block an SM, else 64.  A grid of few
    pixel tiles splits K in two, four or eight while the grid stays within
    the blocks the SMs hold at once (one an SM at BN = 256, two at
    BN <= 128), keeping at least MIN_SPLIT_STEPS K steps a split.
    ``scripts/kernel_times.py --e-plans`` times the others."""
    bn = next(n for n in TILE_N if o <= n)
    m = b * h * w
    bm = 128 if bn == 64 and -(-m // 128) >= sms else 64
    tiles = -(-m // bm)
    resident = sms * (1 if bn == 256 else 2)
    steps = N_TAPS * c * (2 if dtype == torch.bfloat16 else 4) // 64
    split = 1
    while tiles * split * 2 <= resident and steps >= 2 * split * MIN_SPLIT_STEPS:
        split *= 2
    return bm, bn, split


def deform_conv2d_cuda(x: torch.Tensor, offset: torch.Tensor,
                       mask: Optional[torch.Tensor], weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       max_offset: Optional[float] = None, variant: str = "full",
                       taps: Optional[torch.Tensor] = None,
                       launch_plan: Optional[tuple] = None) -> torch.Tensor:
    """Kernel E: ``deform_conv2d`` as one CUDA op.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  x, weight and mask f32 or bf16 alike (the entry
    point follows x), offset and bias f32, all contiguous on the current
    device; C a multiple of 32, O a multiple of 8 and at most 256.  The
    kernel reads x as NHWC: the entry point first transposes the NCHW x
    into a scratch copy.  ``taps`` is ``kernel_weights(weight)`` from a
    caller that keeps it across calls (built here when None);
    ``launch_plan`` is a (BM, BN, splits) other than ``plan``'s, for
    timing.  ``max_offset`` is the plain version's: the kernel reads no
    corner outside the window (and then rounds as the bf16 entry point
    does, in f32).  ``variant="lerp"`` runs the kernel's lerp body, counted
    in ``kernels.VARIANT_LAUNCHES[("deform_conv", "lerp")]``."""
    _check_shapes(x, offset, mask, weight, bias)
    _check_variant(variant, max_offset)
    if x.device.type == "cpu":
        return deform_conv2d(x, offset, mask, weight, bias, max_offset=max_offset,
                             variant=variant)
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    b, c, h, w = x.shape
    o = weight.shape[0]
    if c % 32:
        raise ValueError(f"C must be a multiple of 32, got {c}")
    if o % 8 or o > MAX_O:
        raise ValueError(f"O must be a multiple of 8 and at most {MAX_O}, got {o}")
    kernels.check_cuda_tensor(x, "x", x.dtype, 4)
    kernels.check_cuda_tensor(offset, "offset", torch.float32, 4)
    kernels.check_cuda_tensor(weight, "weight", x.dtype, 4)
    if mask is not None:
        kernels.check_cuda_tensor(mask, "mask", x.dtype, 4)
    if bias is not None:
        kernels.check_cuda_tensor(bias, "bias", torch.float32, 1)
    bm, bn, split = launch_plan or plan(
        b, c, h, w, o, x.dtype, torch.cuda.get_device_properties(x.device).multi_processor_count)
    if taps is None:
        taps = kernel_weights(weight)
    kernels.check_cuda_tensor(taps, "taps", x.dtype, 3)
    if tuple(taps.shape) != (N_TAPS, bn, c):
        raise ValueError(f"taps must be [9, {bn}, {c}], got {tuple(taps.shape)}")
    if taps.data_ptr() % 16:
        raise ValueError("taps must be 16-byte aligned")
    if max(x.numel(), offset.numel(), split * b * o * h * w) >= 2**31:
        raise ValueError("tensors of 2^31 elements or more are not supported")
    out = torch.empty((b, o, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    nhwc = torch.empty((b, h, w, c), dtype=x.dtype, device=x.device)
    partial = (torch.empty((split, b, o, h, w), dtype=torch.float32, device=x.device)
               if split > 1 else None)
    kernels.launch(
        DTYPES[x.dtype], "deform_conv",
        x.data_ptr(), nhwc.data_ptr(), offset.data_ptr(),
        None if mask is None else mask.data_ptr(), taps.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        b, c, h, w, o, bm, bn, split, *(window(max_offset) or NO_WINDOW),
        VARIANTS.index(variant), variant="lerp" if variant == "lerp" else None,
    )
    return out


class _DeformConvFunction(torch.autograd.Function):
    """A DCN under autograd.  The forward is ``forward``: kernel E's wrapper
    (``deform_conv2d_cuda``: the kernel on a CUDA tensor, the plain version
    on a CPU one) or the plain version itself, both at ``max_offset``; it
    saves only its inputs.  The backward recomputes the plain version from
    them under ``torch.enable_grad()`` and takes ``torch.autograd.grad`` of
    it, to x, offset, mask, weight and bias as they need (by the window's
    hats, whatever the forward's variant): stock PyTorch
    autograd, the counterpart of XLA's autodiff of ``deform_conv2d_shift``
    that the JAX package trains through (it has no backward kernel).  With
    a window its subgradients are shift's (``_window_hats``) and x's
    gradient sums in a fixed order (``_corners``), so such a backward
    repeats itself bit for bit on the card.  Recomputing keeps one call's intermediates alive at a
    time, not every block's.  It is not a fallback: the kernel's forward
    on the card is the kernel or raises.  The backward is the
    ``torch.profiler`` range ``BACKWARD_RANGE``."""

    @staticmethod
    def forward(ctx, forward, max_offset, variant, x, offset, mask, weight, bias):
        ctx.save_for_backward(x, offset, mask, weight, bias)
        ctx.max_offset = max_offset
        return forward(x, offset, mask, weight, bias, max_offset=max_offset, variant=variant)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(saved, needs)]
        with record_function(BACKWARD_RANGE), torch.enable_grad():
            out = deform_conv2d(*inputs, max_offset=ctx.max_offset)
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, None, None) + tuple(next(grads) if n else None for n in needs)


def deform_conv2d_train(x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor],
                        weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                        max_offset: Optional[float] = None, variant: str = "full",
                        taps: Optional[torch.Tensor] = None, plain: bool = False) -> torch.Tensor:
    """``deform_conv2d_cuda`` (``plain``: ``deform_conv2d``) at
    ``max_offset`` and ``variant`` with gradients to every input, the
    plain version recomputed in the backward (see ``_DeformConvFunction``)."""
    forward = deform_conv2d if plain else functools.partial(deform_conv2d_cuda, taps=taps)
    return _DeformConvFunction.apply(forward, max_offset, variant, x, offset, mask, weight, bias)


class DeformConv2d(nn.Module):
    """The deformable 3x3 conv of a DCN block: ``weight`` [O, C, 3, 3] and
    ``bias`` [O], the reference's ``DeformConv2d`` parameters, kept f32,
    the block's ``max_offset`` window (None: torchvision's unbounded
    offsets) and the tanh bound its offsets come through
    (``offset_bound``, None: none), which pick ``variant``
    (``dcn_variant``).  A call that autograd does not record (the
    serving paths, under ``torch.inference_mode``) samples by ``variant``;
    one it records (a train step) by the window's hats, as JAX trains
    through ``deform_conv2d_shift`` at every R.

    It computes in its input's dtype (f32 or bf16), with the weight cast
    to it (``params.cast_parameter``: made once and kept until the weight
    changes, or built in the graph where autograd records, with kernel E's
    layout of it).  ``impl="kernel"`` runs kernel E on a CUDA tensor (the
    plain version on a CPU one), ``impl="plain"`` always the plain
    version, for comparisons on the card; either way through
    ``deform_conv2d_train``, whose backward recomputes the plain version.
    A call's ``impl`` overrides the module's (the int8 chain passes its
    own)."""

    def __init__(self, in_channels: int, out_channels: int, impl: str = "kernel",
                 max_offset: Optional[float] = None, offset_bound: Optional[float] = None):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.impl = impl
        self.max_offset = max_offset
        self.offset_bound = offset_bound
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.normal_(self.weight, 0.0, 1.0 / math.sqrt(9 * in_channels))

    @property
    def variant(self) -> str:
        return dcn_variant(self.max_offset, self.offset_bound)

    def forward(self, x, offset, mask, impl: Optional[str] = None):
        weight = cast_parameter(self, "weight", x.dtype)
        variant = "full" if torch.is_grad_enabled() else self.variant
        plain = (impl or self.impl) == "plain"
        taps = None
        if not plain and x.device.type != "cpu":
            taps = cast_parameter(self, "weight", x.dtype, layout=kernel_weights)
        return deform_conv2d_train(x, offset, mask, weight, self.bias,
                                   max_offset=self.max_offset, variant=variant, taps=taps,
                                   plain=plain)
