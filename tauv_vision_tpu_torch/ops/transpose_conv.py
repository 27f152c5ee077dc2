"""Int8 k3 s2 p1 op1 transposed conv with the chain's fused epilogue
(kernel D): the YOLACT protonet's two 2x upsamples in the int8 chain.

NHWC, as the chain keeps its activations.  ``x_q`` [B, H, W, C] int8 and
the HWIO kernel ``qk`` [3, 3, C, O] int8 of the JAX ``TorchConvTranspose``
(the port's ``ConvTranspose2d`` weight ``[C, O, 3, 3]`` permuted
``(2, 3, 0, 1)``, no flip) give ``[B, 2H, 2W, O]``:

    y = act(acc * deq + bias)   # one fused multiply-add, f32
    out = clip(round(y / out_scale), -127, 127) as int8, or y as bf16/f32

- ``transpose_conv2x_int8`` is the plain version, the counterpart of
  ``tauv_vision_tpu/ops/pallas/transpose_conv.py:transpose_conv2x_int8_xla``
  as XLA compiles it: the accumulator is a float64 transposed conv of the
  codes (exact: |acc| <= 127^2 * 9 * C < 2^53), and ``acc * deq + bias``
  is one fused multiply-add (``torch.addcmul``), because XLA contracts it
  into one in the compiled graph (run op by op, eager JAX rounds twice);
- ``transpose_conv2x_int8_cuda`` wraps ``csrc/transpose_conv.cu``, the
  counterpart of ``transpose_conv2x_int8_pallas``: a CPU tensor takes the
  plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tauv_vision_tpu_torch import kernels

ACTS = {"none": 0, "leaky": 1, "relu": 2}
OUT_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
# The largest C the kernel takes: its block keeps the taps of 64 output
# channels ([9][64][C] bytes) and two input stages (2 x 81 x C bytes each)
# in shared memory, 900 C bytes, within a Hopper block's 232,448.
MAX_C = 256

# k[i, j] of the 3x3 kernel at flat index 3 i + j, in the tap order of
# phase_tap_matrices: ee, eo (x, x col+1), oe (x, x row+1), oo (x, x col+1,
# x row+1, x both).
_TAP_ORDER = (4, 5, 3, 7, 1, 8, 6, 2, 0)


def phase_tap_matrices(qk: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, O] HWIO kernel -> [9, C, O] per-phase tap stack:

      y[2m,   2n  ] = x[m, n]   @ k[1,1]
      y[2m,   2n+1] = x[m, n]   @ k[1,2] + x[m, n+1]   @ k[1,0]
      y[2m+1, 2n  ] = x[m, n]   @ k[2,1] + x[m+1, n]   @ k[0,1]
      y[2m+1, 2n+1] = x[m, n]   @ k[2,2] + x[m, n+1]   @ k[2,0]
                    + x[m+1, n] @ k[0,2] + x[m+1, n+1] @ k[0,0]
    """
    return qk.reshape(9, *qk.shape[2:])[list(_TAP_ORDER)]


def _vector(v, n: int, device) -> torch.Tensor:
    """A scalar or [n] vector as a contiguous f32 [n] tensor."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1).expand(n).contiguous()


def _check(x_q, qk, act, out_dtype):
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}, got {act!r}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {tuple(OUT_DTYPES)}, got {out_dtype}")
    if x_q.dim() != 4 or qk.dim() != 4 or tuple(qk.shape[:3]) != (3, 3, x_q.shape[-1]):
        raise ValueError(
            f"x_q must be [B, H, W, C] and qk [3, 3, C, O], got "
            f"{tuple(x_q.shape)} and {tuple(qk.shape)}"
        )


def _epilogue(acc: torch.Tensor, deq, bias, out_scale, act: str, out_dtype) -> torch.Tensor:
    """f32 accumulator -> ``act(acc * deq + bias)`` requantized by
    ``out_scale`` (int8) or cast (bf16, f32)."""
    y = torch.addcmul(bias, acc, deq)
    if act == "leaky":
        y = torch.where(y >= 0, y, 0.01 * y)
    elif act == "relu":
        y = torch.clamp_min(y, 0.0)
    if out_dtype == torch.int8:
        return torch.clamp(torch.round(y / out_scale), -127, 127).to(torch.int8)
    return y.to(out_dtype)


def transpose_conv2x_int8(x_q: torch.Tensor, qk: torch.Tensor, deq, bias, out_scale,
                          *, act: str = "leaky", out_dtype=torch.int8) -> torch.Tensor:
    """Plain version: [B, H, W, C] int8 -> [B, 2H, 2W, O]."""
    _check(x_q, qk, act, out_dtype)
    o = qk.shape[-1]
    acc = F.conv_transpose2d(
        x_q.permute(0, 3, 1, 2).to(torch.float64),
        qk.permute(2, 3, 0, 1).to(torch.float64),
        stride=2, padding=1, output_padding=1,
    ).permute(0, 2, 3, 1).to(torch.float32)
    device = x_q.device
    return _epilogue(acc, _vector(deq, o, device), _vector(bias, o, device),
                     _vector(out_scale, o, device), act, out_dtype)


def kernel_taps(qk: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, O] int8 -> the kernel's tap layout [9, O, C] of int8:
    tap t of phase_tap_matrices for output channel o, its C input
    channels contiguous (the K-contiguous B operand of the kernel's
    mma.sync, read by ldmatrix)."""
    return phase_tap_matrices(qk).permute(0, 2, 1).contiguous()


def transpose_conv2x_int8_cuda(x_q: torch.Tensor, qk: torch.Tensor, deq, bias, out_scale,
                               *, act: str = "leaky", out_dtype=torch.int8,
                               taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel D: ``transpose_conv2x_int8`` as one CUDA op.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  x_q contiguous int8 and 16-byte aligned, with C a
    multiple of 32 (one mma.sync K step) and at most ``MAX_C`` = 256 (the
    block's shared memory).  ``taps`` is
    ``kernel_taps(qk)`` from a caller that keeps it across calls (built
    here when None); ``deq``, ``bias`` and ``out_scale`` given as
    contiguous f32 [O] device vectors are used as they are."""
    _check(x_q, qk, act, out_dtype)
    if x_q.device.type == "cpu":
        return transpose_conv2x_int8(x_q, qk, deq, bias, out_scale, act=act,
                                     out_dtype=out_dtype)
    b, h, w, c = x_q.shape
    o = qk.shape[-1]
    if c % 32 or c > MAX_C:
        raise ValueError(f"C must be a multiple of 32 and at most {MAX_C}, got {c}")
    kernels.check_cuda_tensor(x_q, "x_q", torch.int8, 4)
    if taps is None:
        kernels.check_cuda_tensor(qk.contiguous(), "qk", torch.int8, 4)
        taps = kernel_taps(qk)
    kernels.check_cuda_tensor(taps, "taps", torch.int8, 3)
    if tuple(taps.shape) != (9, o, c):
        raise ValueError(f"taps must be [9, {o}, {c}], got {tuple(taps.shape)}")
    if x_q.data_ptr() % 16 or taps.data_ptr() % 16:
        raise ValueError("x_q and taps must be 16-byte aligned")
    deq, bias, out_scale = (_vector(v, o, x_q.device) for v in (deq, bias, out_scale))
    out = torch.empty((b, 2 * h, 2 * w, o), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    kernels.launch(
        "tauv_transpose_conv2x_int8", "transpose_conv",
        x_q.data_ptr(), taps.data_ptr(), deq.data_ptr(), bias.data_ptr(),
        out_scale.data_ptr(), out.data_ptr(), b, h, w, c, o,
        ACTS[act], OUT_DTYPES[out_dtype],
    )
    return out
