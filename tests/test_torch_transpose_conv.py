"""Kernel D's plain version against the JAX package, bit for bit.

``transpose_conv2x_int8`` (float64 transposed conv of the int8 codes,
then ``torch.addcmul`` and the f32 epilogue) must equal, element for
element and for int8, bf16 and f32 output with each activation:

- ``transpose_conv2x_int8_xla`` compiled with ``jax.jit``.  Compiled, XLA
  contracts ``acc * deq + bias`` into one fused multiply-add, as it does
  in the served chain and in the Pallas kernel; run op by op (eager), JAX
  rounds the product first, and 25% of f32 outputs then differ by one ulp
  from the compiled graph.  The port follows the compiled graph;
- ``transpose_conv2x_int8_pallas(..., interpret=True)``.

Codes, kernels and epilogue vectors come from a numpy seed, as in
``tests/test_pallas_transpose_conv.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.ops.pallas.transpose_conv import (
    phase_tap_matrices as jax_phase_tap_matrices,
    transpose_conv2x_int8_pallas,
    transpose_conv2x_int8_xla,
)
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.ops.transpose_conv import (
    _epilogue,
    kernel_taps,
    phase_tap_matrices,
    transpose_conv2x_int8,
    transpose_conv2x_int8_cuda,
)

ACTS = ("leaky", "relu", "none")
OUT_DTYPES = {"int8": (jnp.int8, torch.int8), "bf16": (jnp.bfloat16, torch.bfloat16),
              "f32": (jnp.float32, torch.float32)}
SHAPES = [(h, w, c) for h, w in ((6, 8), (4, 16), (5, 7)) for c in (32, 128)]


def _case(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (b, h, w, c)).astype(np.int8),
            rng.integers(-127, 128, (3, 3, c, c)).astype(np.int8),
            rng.uniform(1e-4, 1e-2, c).astype(np.float32),
            rng.normal(size=c).astype(np.float32),
            rng.uniform(1e-3, 1e-1, c).astype(np.float32))


def _port(args, act, out_dtype):
    return transpose_conv2x_int8(*(torch.from_numpy(a) for a in args), act=act,
                                 out_dtype=out_dtype).float().numpy()


@pytest.mark.parametrize("out", list(OUT_DTYPES))
@pytest.mark.parametrize("h,w,c", SHAPES)
def test_torch_transpose_conv_plain_matches_jax(h, w, c, out):
    jax_dtype, torch_dtype = OUT_DTYPES[out]
    args = _case(h * w + c, 2, h, w, c)
    for act in ACTS:
        want = np.asarray(jax.jit(lambda *a: transpose_conv2x_int8_xla(
            *a, act=act, out_dtype=jax_dtype))(*args)).astype(np.float32)
        got = _port(args, act, torch_dtype)
        assert got.shape == (2, 2 * h, 2 * w, c)
        np.testing.assert_array_equal(got, want, err_msg=f"{act} vs xla")
    # The Pallas kernel in interpret mode, one activation a case.
    act = ACTS[(h + w + c + list(OUT_DTYPES).index(out)) % 3]
    x, qk, deq, bias, scale = args
    pallas = transpose_conv2x_int8_pallas(
        x, jax_phase_tap_matrices(jnp.asarray(qk)), deq, bias, scale, act=act,
        out_dtype=jax_dtype, interpret=True)
    np.testing.assert_array_equal(_port(args, act, torch_dtype),
                                  np.asarray(pallas).astype(np.float32),
                                  err_msg=f"{act} vs pallas")


def test_torch_phase_tap_matrices_match_jax():
    qk = np.random.default_rng(1).integers(-127, 128, (3, 3, 32, 16)).astype(np.int8)
    np.testing.assert_array_equal(phase_tap_matrices(torch.from_numpy(qk)).numpy(),
                                  np.asarray(jax_phase_tap_matrices(jnp.asarray(qk))))


def test_torch_kernel_taps_layout():
    """Byte [t, o, c] of the kernel's tap layout is input channel c of
    tap t (phase_tap_matrices' order) for output channel o: K contiguous
    for each output channel, the B operand the kernel's ldmatrix reads."""
    qk = torch.from_numpy(np.random.default_rng(2).integers(-127, 128, (3, 3, 32, 12)).astype(np.int8))
    taps = kernel_taps(qk)
    assert taps.shape == (9, 12, 32) and taps.dtype == torch.int8 and taps.is_contiguous()
    phase = phase_tap_matrices(qk)
    for t in range(9):
        np.testing.assert_array_equal(taps[t].numpy(), phase[t].T.numpy())


# The kernel's phases: (output row parity, column parity) -> the (tap,
# row shift, column shift) it sums, in phase_tap_matrices' tap order.
PHASE_TAPS = {(0, 0): ((0, 0, 0),),
              (0, 1): ((1, 0, 0), (2, 0, 1)),
              (1, 0): ((3, 0, 0), (4, 1, 0)),
              (1, 1): ((5, 0, 0), (6, 0, 1), (7, 1, 0), (8, 1, 1))}


def _phase_gemm(x, taps):
    """The kernel's sums from its tap bytes: for each phase, the input
    shifted by each tap's (dy, dx) with zeros past the edge, times that
    tap's [O, C] matrix, as int32 products."""
    b, h, w, c = x.shape
    o = taps.shape[1]
    padded = torch.zeros((b, h + 1, w + 1, c), dtype=torch.int32)
    padded[:, :h, :w] = x.to(torch.int32)
    acc = torch.zeros((b, 2 * h, 2 * w, o), dtype=torch.int32)
    for (py, px), phase in PHASE_TAPS.items():
        for t, dy, dx in phase:
            acc[:, py::2, px::2] += torch.matmul(padded[:, dy:dy + h, dx:dx + w],
                                                 taps[t].to(torch.int32).T)
    return acc


@pytest.mark.parametrize("h,w,c", SHAPES + [(3, 100, 32)])  # + two segments, one ragged
def test_torch_kernel_taps_phase_gemm_matches_jax(h, w, c):
    """The phase GEMMs the kernel runs, rebuilt on the CPU from
    ``kernel_taps``'s bytes and passed through the plain epilogue, equal
    the compiled JAX op bit for bit: a wrong tap order or shift shows
    here before any card run."""
    args = _case(7 * h + w + c, 2, h, w, c)
    x, qk, deq, bias, scale = (torch.from_numpy(a) for a in args)
    acc = _phase_gemm(x, kernel_taps(qk)).to(torch.float32)
    for act, out in zip(ACTS, OUT_DTYPES):
        jax_dtype, torch_dtype = OUT_DTYPES[out]
        want = np.asarray(jax.jit(lambda *a: transpose_conv2x_int8_xla(
            *a, act=act, out_dtype=jax_dtype))(*args)).astype(np.float32)
        got = _epilogue(acc, deq, bias, scale, act, torch_dtype)
        assert got.dtype == torch_dtype
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=f"{act} {out}")


def test_torch_transpose_conv_wrapper_takes_plain_on_cpu():
    args = [torch.from_numpy(a) for a in _case(3, 1, 5, 7, 32)]
    before = dict(kernels.LAUNCHES)
    got = transpose_conv2x_int8_cuda(*args, act="leaky", out_dtype=torch.int8)
    assert kernels.LAUNCHES == before
    assert torch.equal(got, transpose_conv2x_int8(*args, act="leaky", out_dtype=torch.int8))
    with pytest.raises(ValueError):
        transpose_conv2x_int8_cuda(*args, act="gelu")
    with pytest.raises(ValueError):
        transpose_conv2x_int8_cuda(args[0], args[1][:2], *args[2:])
