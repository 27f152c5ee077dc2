"""The port's DCN lerp body against the JAX package's Pallas "lerp" variant.

JAX serves its DCN with the sign-selected lerp wherever the window R is at
most one cell (``deform_conv2d_pallas(variant="lerp")``, chosen by
``models/centerpoint_dla.py:515-521`` and ``serving/quantize_chain.py:981-992``):
on each axis the neighbours at 0 and sign(d), ``lerp0 = t00 + |dx| (t0s -
t00)``, ``lerps`` the same on the row at sign(dy), ``lerp0 + |dy| (lerps -
lerp0)``, x mask, each an f32 op.  The port's plain ``deform_conv2d(...,
variant="lerp")`` is held to the Pallas body in interpret mode (as
``tests/test_pallas_kernels.py`` runs it):

- bf16 and f32, R in {0.5, 1}, with and without a mask, on offsets bounded
  by ``R tanh`` (as ``--dcn-bound`` squashes them) and on offsets of exactly
  -1, 0 and +1 (the sign's tie at 0, the far corner at 1): in bf16 within
  one bf16 ulp of the output's largest magnitude, in f32 within
  ``F32_TOL``, the bars of ``tests/test_torch_dcn_window.py`` (the f32
  sums of the same products in another order than XLA's dot);
- the defect the port does not copy: at R = 1 with unbounded offsets (to
  +-3 cells), the port serves its window's hats (``dcn_variant`` picks the
  lerp only for bounded offsets), JAX the lerp, which extrapolates past
  one cell.  The two agree on every output pixel whose 9 taps all have
  |d| <= 1 and part elsewhere; the count of parted pixels is recorded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.ops.pallas.deform_conv import deform_conv2d_pallas
from tauv_vision_tpu_torch.ops.deform_conv import dcn_variant, deform_conv2d
from torch_parity import torch_threads

F32_TOL = 2e-5
B, H, W, C, O = 2, 7, 9, 32, 16
PARTED_TOL = 1e-2      # a pixel parted by the extrapolation moves by far more


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _inputs(case, r, seed=0):
    """NHWC numpy inputs: x, offset [B, H, W, 18], mask, weight HWIO, bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    if case == "bounded":
        offset = r * np.tanh(rng.standard_normal((B, H, W, 18)) * 1.5 / r)
    elif case == "integral":
        offset = rng.choice([-1.0, 0.0, 1.0], (B, H, W, 18))
    else:   # "unbounded": some pixels' taps all within a cell, the rest to +-3
        far = rng.uniform(0, 1, (B, H, W, 1)) < 0.5
        offset = np.where(far, rng.uniform(-3, 3, (B, H, W, 18)),
                          rng.uniform(-1, 1, (B, H, W, 18)))
    mask = rng.uniform(0, 1, (B, H, W, 9)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, C, O)) / np.sqrt(9 * C)).astype(np.float32)
    bias = rng.standard_normal(O).astype(np.float32)
    return x, offset.astype(np.float32), mask, weight, bias


def _rounded(a, dtype):
    return a if dtype == torch.float32 else np.asarray(
        jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _jax_lerp(x, offset, mask, weight, bias, r, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out = deform_conv2d_pallas(
        jnp.asarray(x).astype(jdt), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask).astype(jdt),
        jnp.asarray(weight).astype(jdt), jnp.asarray(bias), padding=1, max_offset=r,
        cols_per_block=8, interpret=True, variant="lerp")
    return np.asarray(out.astype(jnp.float32))


def _port(x, offset, mask, weight, bias, r, dtype, variant):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))  # noqa: E731
    out = deform_conv2d(
        t(x).to(dtype), t(offset), None if mask is None else t(mask).to(dtype),
        torch.from_numpy(np.ascontiguousarray(np.transpose(weight, (3, 2, 0, 1)))).to(dtype),
        torch.from_numpy(bias), max_offset=r, variant=variant)
    assert out.dtype == dtype
    return np.moveaxis(out.float().numpy(), 1, -1)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("case", ["bounded", "integral"])
@pytest.mark.parametrize("r", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_torch_dcn_lerp_matches_pallas_interpret(dtype, r, case, with_mask, record_property):
    x, offset, mask, weight, bias = _inputs(case, r, seed=3)
    x, mask, weight = (_rounded(a, dtype) for a in (x, mask, weight))
    mask = mask if with_mask else None
    want = _jax_lerp(x, offset, mask, weight, bias, r, dtype)
    got = _port(x, offset, mask, weight, bias, r, dtype, "lerp")
    record_property("outputs_apart", int((got != want).sum()))
    record_property("max_abs_err", float(np.abs(got - want).max()))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


def test_torch_dcn_variant_takes_lerp_only_for_bounded_offsets():
    assert dcn_variant(1.0, 1.0) == dcn_variant(0.5, 0.5) == "lerp"
    assert dcn_variant(1.0, None) == dcn_variant(3.0, 3.0) == dcn_variant(None, 1.0) == "full"
    x, offset, mask, weight, bias = _inputs("bounded", 1.0)
    with pytest.raises(ValueError):
        _port(x, offset, mask, weight, bias, 3.0, torch.float32, "lerp")
    with pytest.raises(ValueError):
        _port(x, offset, mask, weight, bias, None, torch.float32, "lerp")


def test_torch_dcn_unbounded_r1_parts_from_jax_lerp_past_one_cell(record_property):
    """JAX serves the lerp at R = 1 whatever the offsets; the port, with
    no bound, its window's hats.  Equal (f32, ``F32_TOL``) wherever an
    output pixel's taps all lie within a cell, parted elsewhere."""
    r = 1.0
    x, offset, mask, weight, bias = _inputs("unbounded", r, seed=5)
    assert dcn_variant(r, None) == "full"
    want = _jax_lerp(x, offset, mask, weight, bias, r, torch.float32)
    got = _port(x, offset, mask, weight, bias, r, torch.float32, dcn_variant(r, None))
    inside = (np.abs(offset) <= 1).all(axis=-1)           # [B, H, W]
    assert 0 < inside.sum() < inside.size
    np.testing.assert_allclose(got[inside], want[inside], rtol=F32_TOL, atol=F32_TOL)
    apart = (np.abs(got - want) > PARTED_TOL).any(axis=-1)
    record_property("pixels", int(inside.size))
    record_property("pixels_within_a_cell", int(inside.sum()))
    record_property("pixels_parted", int(apart.sum()))
    assert not (apart & inside).any()
    assert apart.sum() == (~inside).sum(), (apart.sum(), (~inside).sum())
