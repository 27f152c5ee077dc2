"""The port's rotation, angle, depth and PnP ops against the JAX package's.

The same seeded numpy inputs go through both; both compute in f32.

- ``so3_exp``, ``so3_log``, ``rpy_to_matrix`` / ``matrix_to_rpy`` and
  ``angle_decode`` within 1e-6 (the same f32 formulas; ``sin``, ``cos``,
  ``atan2`` and ``arccos`` of the two libraries may round an ulp apart),
  at random inputs, at w = 0 (where PnP linearises, so the Jacobian of
  ``so3_exp`` must be finite and equal) and at the +-pi seam.
- ``depth_decode`` within 2 f32 ulps of 1 + depth: XLA's ``exp`` and
  PyTorch's round an ulp apart on about 0.3% of inputs, so the sigmoids
  do, and ``1/sigmoid - 1`` carries that ulp of ``1/sigmoid`` (about 1 +
  depth) into a small depth, where it is a large share of the value
  (measured over 10^6 logits: 1.41 ulps of 1 + depth at most); so the
  decode cannot be bit-exact against the JAX package's.  ``depth_encode``
  within 4 f32 ulps of 1.
- ``solve_pnp`` and ``solve_pnp_batch`` on the cases of
  ``tests/test_se3_pnp.py``: ``valid`` equal, rotation and translation
  within 1e-4 of JAX's (the same f32 LM on the same inputs; the two
  frameworks' reverse-mode Jacobians round their entries apart), and
  against the truth within JAX's own tolerances there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.ops import angles as jax_angles
from tauv_vision_tpu.ops import depth as jax_depth
from tauv_vision_tpu.ops import pnp as jax_pnp
from tauv_vision_tpu.ops import se3 as jax_se3
from tauv_vision_tpu_torch.ops import angles, depth, pnp, se3

ATOL = 1e-6
POSE_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _axis_angles():
    """Random rotations, w = 0, tiny angles on both sides of the Taylor
    switch, and angles at and near pi (the seam where so3_log's sin
    vanishes)."""
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    norms = np.array([0.0, 1e-6, 5e-5, 2e-4, 0.3, 1.0, 2.0, 3.0, 3.1, 3.14, np.pi - 1e-3,
                      np.pi])
    return np.concatenate([(axes * norms[:, None]), rng.normal(size=(8, 3))]).astype(np.float32)


def test_torch_so3_exp_log_match_jax():
    w = _axis_angles()
    r_jax = np.asarray(jax_se3.so3_exp(jnp.asarray(w)))
    r = se3.so3_exp(_t(w)).numpy()
    np.testing.assert_allclose(r, r_jax, rtol=0, atol=ATOL)
    # so3_log of the same matrices, the seam (where sin(theta) -> 0) included.
    np.testing.assert_allclose(se3.so3_log(_t(r_jax)).numpy(),
                               np.asarray(jax_se3.so3_log(jnp.asarray(r_jax))),
                               rtol=0, atol=ATOL)


def test_torch_so3_exp_jacobian_at_zero_matches_jax():
    w = np.zeros(3, np.float32)
    want = np.asarray(jax.jacobian(jax_se3.so3_exp)(jnp.asarray(w)))
    got = torch.func.jacrev(se3.so3_exp)(_t(w)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(se3.hat(_t([1.0, 2.0, 3.0])).numpy(),
                               np.asarray(jax_se3.hat(jnp.asarray([1.0, 2.0, 3.0]))))


def test_torch_rpy_matches_jax():
    rng = np.random.default_rng(1)
    rpy = rng.uniform(-np.pi, np.pi, (3, 16)).astype(np.float32)
    rpy[1] /= 2.0   # pitch within (-pi/2, pi/2)
    rpy[:, 0] = (np.pi, 0.0, -np.pi)   # roll and yaw at the seam
    want = np.asarray(jax_se3.rpy_to_matrix(*map(jnp.asarray, rpy)))
    got = se3.rpy_to_matrix(*map(_t, rpy)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for a, b in zip(se3.matrix_to_rpy(_t(want)), jax_se3.matrix_to_rpy(jnp.asarray(want))):
        # atan2 at the seam: +-pi are the same angle.
        diff = np.abs(a.numpy() - np.asarray(b))
        np.testing.assert_allclose(np.minimum(diff, np.abs(diff - 2 * np.pi)), 0.0, atol=ATOL)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(se3.se3_transform(_t(want[1]), _t(t), _t(pts)).numpy(),
                               np.asarray(jax_se3.se3_transform(jnp.asarray(want[1]),
                                                                jnp.asarray(t), jnp.asarray(pts))),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("theta_range", [2 * np.pi, np.pi / 2])
def test_torch_angle_decode_matches_jax(theta_range):
    rng = np.random.default_rng(2)
    n = 256
    bins = rng.normal(size=(n, 4)).astype(np.float32) * 2
    offsets = rng.normal(size=(n, 4)).astype(np.float32)
    # The +-pi seam of atan2: sin of +-0 and tiny, cos negative.
    offsets[:8, 0] = offsets[:8, 2] = np.array([0.0, -0.0, 1e-8, -1e-8] * 2, np.float32)
    offsets[:8, 1] = offsets[:8, 3] = -1.0
    want = np.asarray(jax_angles.angle_decode(jnp.asarray(bins), jnp.asarray(offsets),
                                              theta_range, np.pi / 3))
    got = angles.angle_decode(_t(bins), _t(offsets), theta_range, np.pi / 3).numpy()
    # An angle at the top of [0, theta_range) and one at 0 are the same.
    diff = np.abs(got - want)
    np.testing.assert_allclose(np.minimum(diff, np.abs(diff - theta_range)), 0.0, atol=ATOL)
    assert angles.angle_get_bins(0.5) == jax_angles.angle_get_bins(0.5)
    x = rng.uniform(-10, 10, n).astype(np.float32)
    for lo, hi in ((-0.5, np.pi + 0.5), (-np.pi - 0.5, 0.5)):
        np.testing.assert_array_equal(angles.angle_in_range(_t(x), lo, hi).numpy(),
                                      np.asarray(jax_angles.angle_in_range(jnp.asarray(x), lo, hi)))


def test_torch_depth_codec_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=16384).astype(np.float32) * 3
    want = np.asarray(jax_depth.depth_decode(jnp.asarray(logits)))
    got = depth.depth_decode(_t(logits)).numpy()
    assert_depth_close(got, want)
    d = rng.uniform(0.1, 20.0, 512).astype(np.float32)
    np.testing.assert_allclose(depth.depth_encode(_t(d)).numpy(),
                               np.asarray(jax_depth.depth_encode(jnp.asarray(d))),
                               rtol=0, atol=4 * 2.0 ** -23)


def assert_depth_close(got, want):
    """Decoded depths within 2 f32 ulps of 1 + depth (see the module
    docstring)."""
    err = np.abs(got.astype(np.float64) - want)
    bar = 2 * 2.0 ** -23 * (1.0 + np.abs(want.astype(np.float64)))
    assert (err <= bar).all(), float((err / bar).max())


def _case(seed, n_points=8):
    """``tests/test_se3_pnp.py``'s synthetic correspondences."""
    rng = np.random.default_rng(seed)
    object_points = rng.uniform(-0.2, 0.2, (n_points, 3)).astype(np.float32)
    w_true = rng.normal(size=3).astype(np.float32) * 0.4
    r_true = np.asarray(jax_se3.so3_exp(jnp.asarray(w_true)))
    t_true = np.asarray([0.1, -0.05, 1.5], np.float32)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    camera = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    pts_cam = object_points @ r_true.T + t_true
    u = fx * pts_cam[:, 0] / pts_cam[:, 2] + cx
    v = fy * pts_cam[:, 1] / pts_cam[:, 2] + cy
    return object_points, np.stack([u, v], -1).astype(np.float32), camera, r_true, t_true


def _both(fn_jax, fn_port, *args, **kwargs):
    want = fn_jax(*map(jnp.asarray, args), **kwargs)
    with torch.inference_mode():
        got = fn_port(*map(torch.from_numpy, args), **kwargs)
    for name in ("rotation", "translation", "valid"):
        assert getattr(got, name).shape == np.asarray(getattr(want, name)).shape, name
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), rtol=0,
                               atol=POSE_ATOL)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), rtol=0,
                               atol=POSE_ATOL)
    return got


def test_torch_pnp_exact_recovery_matches_jax():
    obj, img, cam, r_true, t_true = _case(1)
    got = _both(jax_pnp.solve_pnp, pnp.solve_pnp, obj, img, cam, np.ones(len(obj), bool),
                n_iterations=40)
    assert bool(got.valid) and float(got.error) < 1e-3
    np.testing.assert_allclose(got.translation.numpy(), t_true, atol=1e-2)
    np.testing.assert_allclose(got.rotation.numpy(), r_true, atol=1e-2)


def test_torch_pnp_masked_and_insufficient_match_jax():
    obj, img, cam, _, t_true = _case(2, n_points=10)
    mask = np.ones(10, bool)
    mask[7:] = False   # 7 valid >= 6
    got = _both(jax_pnp.solve_pnp, pnp.solve_pnp, obj, img, cam, mask, n_iterations=40)
    assert bool(got.valid)
    np.testing.assert_allclose(got.translation.numpy(), t_true, atol=5e-2)

    mask[:] = False
    mask[:5] = True    # 5 < 6: invalid
    got = _both(jax_pnp.solve_pnp, pnp.solve_pnp, obj, img, cam, mask)
    assert not bool(got.valid)


def test_torch_pnp_batch_matches_jax():
    cases = [_case(s) for s in (3, 4, 5)]
    obj = np.stack([c[0] for c in cases])
    img = np.stack([c[1] for c in cases])
    mask = np.ones((3, obj.shape[1]), bool)
    mask[1, 5:] = False   # a problem with too few points in the batch
    got = _both(jax_pnp.solve_pnp_batch, pnp.solve_pnp_batch, obj, img, cases[0][2], mask,
                n_iterations=40)
    assert got.translation.shape == (3, 3)
    assert got.valid.tolist() == [True, False, True]
    for i in (0, 2):
        np.testing.assert_allclose(got.translation[i].numpy(), cases[i][4], atol=2e-2)


def test_torch_solve_spd_6_matches_jax():
    rng = np.random.default_rng(4)
    m = rng.normal(size=(5, 6, 6)).astype(np.float32)
    a = m @ np.swapaxes(m, -1, -2) + 0.1 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(5, 6)).astype(np.float32)
    want = np.asarray(jax_pnp._solve_spd_6(jnp.asarray(a), jnp.asarray(b)))
    got = pnp._solve_spd_6(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.linalg.solve(a.astype(np.float64), b[..., None])[..., 0],
                               rtol=1e-3, atol=1e-3)


def test_torch_pnp_jacobian_matches_jacrev_in_every_mode():
    """The analytic Jacobian against ``vmap(jacrev)`` of the same residual
    (``scripts/jacrev_probe.py``, the probe that is run on the card too),
    at w = 0 and at random w, under autograd, ``no_grad`` and
    ``inference_mode``: within 1e-6 of the largest entry (f32 rounding of
    entries up to ~1,500 px), and the solver recovers the probe's 160 exact
    poses within 1e-5 with either Jacobian."""
    from tauv_vision_tpu_torch.scripts import jacrev_probe

    for mode, row in jacrev_probe.probe(torch.device("cpu")).items():
        for name in ("w0", "w_random"):
            assert row[f"jacobian_{name}_max_abs_diff"] <= 1e-6 * row[f"jacobian_{name}_max_abs"], (
                mode, name)
        for route in ("analytic", "jacrev"):
            assert row[f"solve_{route}_valid"] == jacrev_probe.N_PROBLEMS, (mode, route)
            assert row[f"solve_{route}_translation_err_m"] < 1e-5, (mode, route)
            assert row[f"solve_{route}_rotation_err"] < 1e-5, (mode, route)
