"""The port's DCN with a ``max_offset`` window against the JAX package's.

JAX trains and serves its DCN with a window of R = 3 cells
(``deform_conv2d_shift``, ``dcn_max_offset=3``; the Pallas kernel at the
same R): a bilinear corner whose integer shift from the tap's base lies
outside [-ceil(R), floor(R) + 1] adds zero.  The port's plain
``deform_conv2d(max_offset=R)`` is held to it here:

- f32, against ``deform_conv2d_shift``: the value and ``jax.grad`` to
  all five inputs (x, offset, mask, weight, bias), through autograd of
  the plain version and through ``deform_conv2d_train`` (whose backward
  recomputes it), at offsets exactly 0, exactly integral (+-1, +-3),
  generic, and past the window (+-4.5, +-7, where one corner of an axis
  or all of them drop).  At an integral offset shift's derivative is
  -x[s] + x[s + 1] / 2 - x[s - 1] / 2 (``jnp.abs``' derivative +1 at 0,
  ``jnp.maximum``'s tie split in halves), which the port's third corner
  gives.  Tolerance ``F32_TOL`` (rtol and atol): 9 C f32 products summed
  in another order, and shift's hats are taken of offset + base, the
  port's of the offset (a rounding of 1e-7 in a weight);
- bf16, against the Pallas kernel in interpret mode at R = 3 (variant
  "full", as ``tests/test_pallas_kernels.py`` runs it), offsets to +-5
  so that samples leave the window: within one bf16 ulp of the output's
  largest magnitude, as ``tests/test_torch_deform_conv.py`` holds the
  unwindowed case (the f32 sums of exact bf16 products in another order
  than XLA's dot);
- with no window (None) the port keeps torchvision's unbounded offsets
  and the gather's subgradient (``tests/test_torch_train_losses.py``
  pins it at zero offsets), and a window wide enough for every offset
  gives the unwindowed values.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.ops.deform_conv import deform_conv2d_shift as jax_shift
from tauv_vision_tpu.ops.pallas.deform_conv import deform_conv2d_pallas
from tauv_vision_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_train, window
from torch_parity import torch_threads

R = 3
F32_TOL = 2e-5
B, H, W, C, O = 2, 7, 9, 32, 16
# case: offsets a pixel and tap, each drawn from these values
OFFSETS = {
    "zero": [0.0],
    "integral": [-3.0, -1.0, 0.0, 1.0, 3.0],
    "generic": None,            # uniform in (-2.9, 2.9)
    "past_window": [-7.0, -4.5, 4.5, 7.0],
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _inputs(case, seed=0):
    """NHWC numpy inputs: x, offset [B, H, W, 18], mask, weight HWIO, bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    values = OFFSETS[case]
    if values is None:
        offset = rng.uniform(-2.9, 2.9, (B, H, W, 18))
    else:
        offset = rng.choice(values, (B, H, W, 18))
    mask = rng.uniform(0, 1, (B, H, W, 9)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, C, O)) / np.sqrt(9 * C)).astype(np.float32)
    bias = rng.standard_normal(O).astype(np.float32)
    return x, offset.astype(np.float32), mask, weight, bias


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


def _to_port(x, offset, mask, weight, bias):
    return [torch.from_numpy(a) for a in (
        _nchw(x), _nchw(offset), _nchw(mask),
        np.ascontiguousarray(np.transpose(weight, (3, 2, 0, 1))), bias)]


def _from_port(out, grads):
    """The port's NCHW output and gradients in JAX's layouts."""
    gx, goff, gmask, gw, gb = (g.float().numpy() for g in grads)
    return (np.moveaxis(out.float().numpy(), 1, -1),
            [np.moveaxis(gx, 1, -1), np.moveaxis(goff, 1, -1), np.moveaxis(gmask, 1, -1),
             np.transpose(gw, (2, 3, 1, 0)), gb])


def _jax_grads(inputs, seed):
    """``jax.grad`` of shift, op by op: jitting its 9 x 64 shifted windows
    and their gradient takes ~3 minutes to compile here, eager ~40 s once
    and ~5 s a call after."""
    def f(*a):
        out = jax_shift(*a, padding=1, max_offset=R)
        return jnp.sum(out * seed), out
    grads, out = jax.grad(f, argnums=range(5), has_aux=True)(*(jnp.asarray(a) for a in inputs))
    return np.asarray(out), [np.asarray(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _shift_case(case):
    inputs = _inputs(case)
    seed = np.random.default_rng(9).standard_normal((B, H, W, O)).astype(np.float32)
    return inputs, seed, _jax_grads(inputs, seed)


def _port_grads(fn, inputs, seed):
    leaves = [t.requires_grad_(True) for t in _to_port(*inputs)]
    out = fn(*leaves)
    out.backward(torch.from_numpy(_nchw(seed)))
    return _from_port(out.detach(), [t.grad for t in leaves])


@pytest.mark.parametrize("route", ["autograd", "train"])
@pytest.mark.parametrize("case", ["integral", "generic", "past_window"])
def test_torch_dcn_window_f32_matches_jax_shift(case, route, record_property):
    inputs, seed, (want_out, want_grads) = _shift_case(case)
    fn = deform_conv2d if route == "autograd" else deform_conv2d_train
    got_out, got_grads = _port_grads(lambda *a: fn(*a, max_offset=R), inputs, seed)
    np.testing.assert_allclose(got_out, want_out, rtol=F32_TOL, atol=F32_TOL)
    for name, g, w in zip(("x", "offset", "mask", "weight", "bias"), got_grads, want_grads):
        record_property(f"{name}_max_abs_err", float(np.abs(g - w).max()))
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL, err_msg=name)
    if case == "integral":
        # The tie's subgradient is not the gather's x[s + 1] - x[s].
        gather = _port_grads(deform_conv2d, inputs, seed)[1][1]
        assert np.abs(gather - want_grads[1]).max() > 0.1


def test_torch_dcn_window_train_at_zero_offsets_matches_shift():
    """``deform_conv2d_train(max_offset=3)`` at the flax init's offsets, 0:
    the offsets' gradient is shift's, where without a window it is the
    gather's."""
    inputs, seed, (_, want) = _shift_case("zero")
    _, got = _port_grads(lambda *a: deform_conv2d_train(*a, max_offset=R), inputs, seed)
    np.testing.assert_allclose(got[1], want[1], rtol=F32_TOL, atol=F32_TOL)
    _, unwindowed = _port_grads(deform_conv2d_train, inputs, seed)
    assert np.abs(unwindowed[1] - want[1]).max() > 0.1


@pytest.mark.parametrize("with_mask", [True, False])
def test_torch_dcn_window_bf16_matches_pallas_interpret(with_mask, record_property):
    x, _, mask, weight, bias = _inputs("generic", seed=3)
    offset = np.random.default_rng(6).uniform(-5, 5, (B, H, W, 18)).astype(np.float32)
    bf = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
          for a in (x, mask, weight)]
    x, mask, weight = bf[0], bf[1] if with_mask else None, bf[2]
    want = np.asarray(deform_conv2d_pallas(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask).astype(jnp.bfloat16),
        jnp.asarray(weight).astype(jnp.bfloat16), jnp.asarray(bias), padding=1,
        max_offset=R, cols_per_block=8, interpret=True).astype(jnp.float32))
    t = lambda a: torch.from_numpy(_nchw(a))  # noqa: E731
    got = deform_conv2d(
        t(x).to(torch.bfloat16), t(offset), None if mask is None else t(mask).to(torch.bfloat16),
        torch.from_numpy(np.ascontiguousarray(np.transpose(weight, (3, 2, 0, 1)))).to(
            torch.bfloat16), torch.from_numpy(bias), max_offset=R)
    got = np.moveaxis(got.float().numpy(), 1, -1)
    lo, hi = window(R)
    record_property("offsets_past_window", float(((offset < lo) | (offset > hi - 1)).mean()))
    record_property("outputs_one_ulp_apart", int((got != want).sum()))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
    # The window is not a no-op here: unwindowed, the samples past it count.
    full = deform_conv2d(t(x).to(torch.bfloat16), t(offset),
                         None if mask is None else t(mask).to(torch.bfloat16),
                         torch.from_numpy(np.ascontiguousarray(
                             np.transpose(weight, (3, 2, 0, 1)))).to(torch.bfloat16),
                         torch.from_numpy(bias))
    assert np.abs(np.moveaxis(full.float().numpy(), 1, -1) - want).max() > 10 * ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_dcn_wide_window_keeps_every_sample(dtype):
    """A window wider than every offset reads the same corners as none;
    in bf16 the hats are the same arithmetic, so the values are equal."""
    x, offset, mask, weight, bias = _to_port(*_inputs("generic", seed=7))
    args = (x.to(dtype), offset, mask.to(dtype), weight.to(dtype), bias)
    wide, none = deform_conv2d(*args, max_offset=8), deform_conv2d(*args)
    if dtype == torch.bfloat16:
        assert torch.equal(wide, none)
    else:
        torch.testing.assert_close(wide, none, rtol=F32_TOL, atol=F32_TOL)


def test_torch_dcn_window_bounds():
    assert window(None) is None
    assert window(3) == (-3, 4) and window(3.0) == (-3, 4)
    assert window(0.5) == (-1, 1) and window(1) == (-1, 2)
