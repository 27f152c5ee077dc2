"""The port's training losses and targets against the JAX package's.

The same seeded numpy inputs go through ``tauv_vision_tpu``'s loss
primitives, target generators, angle and depth codecs, ``centernet_loss``
and synthetic data generator and through their counterparts in
``tauv_vision_tpu_torch``, in f32 on the CPU.  Tolerance: 1e-6 relative
(and 1e-6 absolute for values near 0): the same formula in the same
precision, where only transcendental functions and sums may round in
another order.  One DCN at offsets of exactly 0, where the JAX package
trains (its offset convs start at zero) through ``deform_conv2d_shift``
with a 3-cell window.  At offsets of 0 only the shifts -1, 0 and +1
carry a non-zero hat weight or derivative, so shift's 1-cell window
gives the 3-cell window's output and gradients, bit for bit, and
compiles ~20x faster; the test takes it.  The port's output and its gradients to x, mask,
weight and bias equal JAX's shift and gather alike within 1e-5 (sums of
288 products in another order).  The gradient to the offsets sits on a
kink of the bilinear weights there: the port takes the one-sided
derivative of ``floor`` (x[s + 1] - x[s]), as gather does, where shift's
subgradients of ``|.|`` and ``max`` at the ties give another value; the
port's equals gather's.  ``centernet_loss`` sums whole maps (thousands of terms
in another order than XLA's), so its fields are held to 1e-5 relative,
the bar of the train-step tests.  The data generator is numpy in both
and must be bit-equal.
"""

import dataclasses
from math import pi

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.data import synthetic as jax_synthetic
from tauv_vision_tpu.models.centernet import Prediction as JaxPrediction
from tauv_vision_tpu.ops import angles as jax_angles
from tauv_vision_tpu.ops import depth as jax_depth
from tauv_vision_tpu.ops import heatmap as jax_heatmap
from tauv_vision_tpu.ops import losses as jax_losses
from tauv_vision_tpu.ops.deform_conv import deform_conv2d as jax_gather
from tauv_vision_tpu.ops.deform_conv import deform_conv2d_shift as jax_shift
from tauv_vision_tpu.train import centernet_task as jax_task
from tauv_vision_tpu_torch.configs import samples_torpedo
from tauv_vision_tpu_torch.data import synthetic
from tauv_vision_tpu_torch.models.centernet import Prediction
from tauv_vision_tpu_torch.ops import angles, depth, heatmap, losses
from tauv_vision_tpu_torch.ops.deform_conv import deform_conv2d_train
from tauv_vision_tpu_torch.train import centernet_task
from torch_parity import (
    PREDICTION_FIELDS,
    jax_centernet_config,
    jax_object_config,
    jax_train_config,
    square_configs,
    torch_threads,
)

RTOL = ATOL = 1e-6


LOSS_RTOL = 1e-5
DCN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def close(port, want, rtol=RTOL, **kw):
    np.testing.assert_allclose(np.asarray(port), np.asarray(want), rtol=rtol, atol=ATOL, **kw)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_torch_focal_loss_matches_jax(rng):
    pred = rng.uniform(0, 1, (2, 3, 9, 11)).astype(np.float32)
    truth = rng.uniform(0, 1, (2, 3, 9, 11)).astype(np.float32)
    truth[0, 1, 4, 5] = truth[1, 2, 0, 0] = 1.0
    for truth_case in (truth, truth * 0.5):   # with peaks, and with none
        want = jax_losses.focal_loss(jnp.asarray(pred), jnp.asarray(truth_case), 2.0, 4.0)
        close(losses.focal_loss(t(pred), t(truth_case), 2.0, 4.0), want)


def test_torch_elementwise_losses_match_jax(rng):
    a = rng.normal(size=(4, 7)).astype(np.float32) * 2
    b = rng.normal(size=(4, 7)).astype(np.float32) * 2
    close(losses.smooth_l1(t(a), t(b)), jax_losses.smooth_l1(jnp.asarray(a), jnp.asarray(b)))
    p, q = rng.uniform(-0.1, 1.1, (2, 4, 7)).astype(np.float32)
    close(losses.binary_cross_entropy(t(p), t(q)),
          jax_losses.binary_cross_entropy(jnp.asarray(p), jnp.asarray(q)))
    labels = rng.integers(0, 7, (4,)).astype(np.int32)
    close(losses.softmax_cross_entropy(t(a), t(labels)),
          jax_losses.softmax_cross_entropy(jnp.asarray(a), jnp.asarray(labels)))


def _objects(rng, b=3, n=5):
    center = rng.uniform(0, 1, (b, n, 2)).astype(np.float32)
    label = rng.integers(0, 2, (b, n)).astype(np.int32)
    valid = rng.uniform(size=(b, n)) < 0.7
    return center, label, valid


def test_torch_generate_heatmap_matches_jax(rng):
    center, label, valid = _objects(rng)
    args = dict(n_labels=2, in_h=40, in_w=56, downsample_ratio=4, sigma=2.0)
    close(heatmap.generate_heatmap(t(center), t(label), t(valid), **args),
          jax_heatmap.generate_heatmap(jnp.asarray(center), jnp.asarray(label),
                                       jnp.asarray(valid), **args))


def test_torch_generate_keypoint_heatmap_matches_jax(rng):
    center, _, _ = _objects(rng)
    k = 12
    kp_center = rng.uniform(0, 1, (3, k, 2)).astype(np.float32)
    kp_label = rng.integers(0, 4, (3, k)).astype(np.int32)
    kp_valid = rng.uniform(size=(3, k)) < 0.8
    kp_object = rng.integers(0, 5, (3, k)).astype(np.int32)
    args = dict(n_keypoints=4, in_h=40, in_w=56, downsample_ratio=4, heatmap_sigma=2.0,
                affinity_sigma=1.5)
    port = heatmap.generate_keypoint_heatmap(t(kp_center), t(kp_label), t(kp_valid),
                                             t(kp_object), t(center), **args)
    want = jax_heatmap.generate_keypoint_heatmap(
        *(jnp.asarray(a) for a in (kp_center, kp_label, kp_valid, kp_object, center)), **args)
    for p, w in zip(port, want):
        close(p, w)


def test_torch_out_index_for_position_matches_jax(rng):
    position = rng.uniform(-0.2, 1.2, (3, 9, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        heatmap.out_index_for_position(t(position), 40, 56, 4).numpy(),
        np.asarray(jax_heatmap.out_index_for_position(jnp.asarray(position), 40, 56, 4)))


def test_torch_angle_encode_and_loss_match_jax(rng):
    truth = rng.uniform(-3 * pi, 3 * pi, (5, 6)).astype(np.float32)
    theta_range = np.where(rng.uniform(size=(5, 6)) < 0.5, pi / 2, 2 * pi).astype(np.float32)
    inside, offsets = angles.angle_encode(t(truth), t(theta_range), pi / 3)
    want_inside, want_offsets = jax_angles.angle_encode(jnp.asarray(truth),
                                                        jnp.asarray(theta_range), pi / 3)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(want_inside))
    close(offsets, want_offsets)
    bins = rng.normal(size=(5, 6, 4)).astype(np.float32)
    offs = rng.normal(size=(5, 6, 4)).astype(np.float32)
    close(angles.angle_loss(t(bins), t(offs), t(truth), t(theta_range), pi / 3),
          jax_angles.angle_loss(jnp.asarray(bins), jnp.asarray(offs), jnp.asarray(truth),
                                jnp.asarray(theta_range), pi / 3))


def test_torch_depth_loss_matches_jax(rng):
    pred = rng.normal(size=(4, 6)).astype(np.float32)
    truth = rng.uniform(0.1, 10, (4, 6)).astype(np.float32)
    close(depth.depth_loss(t(pred), t(truth)),
          jax_depth.depth_loss(jnp.asarray(pred), jnp.asarray(truth)))


def test_torch_generate_square_batch_matches_jax():
    cfg = dict(in_h=48, in_w=80, max_objects=4, min_side=6, max_side=14, keypoints=True)
    img, truth = synthetic.generate_square_batch(
        np.random.default_rng(5), 3, synthetic.SquareDatasetConfig(**cfg))
    want_img, want = jax_synthetic.generate_square_batch(
        np.random.default_rng(5), 3, jax_synthetic.SquareDatasetConfig(**cfg))
    np.testing.assert_array_equal(img, want_img)
    for field in dataclasses.fields(truth):
        np.testing.assert_array_equal(getattr(truth, field.name), getattr(want, field.name),
                                      err_msg=field.name)
    assert synthetic.SQUARE_CORNERS == jax_synthetic.SQUARE_CORNERS


@pytest.mark.parametrize("all_terms", [False, True])
def test_torch_centernet_loss_matches_jax(all_terms):
    """``centernet_loss`` on random heads: the square object with yaw and
    keypoints under samples_torpedo's lambdas, and (``all_terms``) with
    roll, pitch and depth heads and every lambda non-zero."""
    oc, mc = square_configs(48, 80, all_terms=all_terms)
    tc = samples_torpedo.train_config
    if all_terms:
        tc = dataclasses.replace(tc, loss_lambda_offset=1.0, loss_lambda_depth=0.5)
    rng = np.random.default_rng(1)
    _, truth = synthetic.generate_square_batch(rng, 3, synthetic.SquareDatasetConfig(
        in_h=mc.in_h, in_w=mc.in_w, max_objects=4, min_side=6, max_side=14, keypoints=True))
    truth = dataclasses.replace(truth, roll=rng.uniform(-4, 4, truth.yaw.shape).astype(np.float32),
                                depth=rng.uniform(0.5, 8, truth.yaw.shape).astype(np.float32))
    b, h, w = 3, mc.out_h, mc.out_w
    shapes = {"heatmap": (1,), "keypoint_heatmap": (4,), "keypoint_affinity": (4, 2),
              "size": (2,), "offset": (2,)}
    for name in ("yaw", "pitch", "roll"):
        if getattr(oc, f"train_{name}"):
            shapes[f"{name}_bin"] = shapes[f"{name}_offset"] = (4,)
    if oc.train_depth:
        shapes["depth"] = (1,)
    heads = {name: rng.normal(size=(b, h, w) + shapes[name]).astype(np.float32)
             if name in shapes else None for name in PREDICTION_FIELDS}
    port = centernet_task.centernet_loss(
        Prediction(**{k: None if v is None else t(v) for k, v in heads.items()}),
        truth.to("cpu"), mc, tc, oc).detach()
    want = jax_task.centernet_loss(
        JaxPrediction(**{k: None if v is None else jnp.asarray(v) for k, v in heads.items()}),
        jax_task.CenternetTruth(**{f.name: None if getattr(truth, f.name) is None
                                   else jnp.asarray(getattr(truth, f.name))
                                   for f in dataclasses.fields(truth)}),
        jax_centernet_config(mc), jax_train_config(tc), jax_object_config(oc))
    for field in dataclasses.fields(port):
        close(getattr(port, field.name), getattr(want, field.name), LOSS_RTOL,
              err_msg=field.name)


def test_torch_dcn_at_zero_offsets_matches_jax_shift():
    rng = np.random.default_rng(4)
    b, h, w, c, o = 2, 6, 7, 32, 16
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, h, w, 9)).astype(np.float32)
    weight = (rng.normal(size=(3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    bias = rng.normal(size=(o,)).astype(np.float32)
    offset = np.zeros((b, h, w, 18), np.float32)
    seed = rng.normal(size=(b, h, w, o)).astype(np.float32)

    def jax_grads(fn, **kw):
        def f(*a):
            out = fn(*a, padding=1, **kw)
            return jnp.sum(out * seed), out
        grads, out = jax.jit(jax.grad(f, argnums=range(5), has_aux=True))(
            *(jnp.asarray(a) for a in (x, offset, mask, weight, bias)))
        return np.asarray(out), [np.asarray(g) for g in grads]

    shift = jax_grads(jax_shift, max_offset=1)
    gather = jax_grads(jax_gather, stride=1)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (
        x.transpose(0, 3, 1, 2), offset.transpose(0, 3, 1, 2), mask.transpose(0, 3, 1, 2),
        weight.transpose(3, 2, 0, 1), bias)]
    out = deform_conv2d_train(*leaves)
    out.backward(torch.from_numpy(seed.transpose(0, 3, 1, 2)))
    port = [out.detach().numpy().transpose(0, 2, 3, 1),
            [leaves[0].grad.numpy().transpose(0, 2, 3, 1),
             leaves[1].grad.numpy().transpose(0, 2, 3, 1),
             leaves[2].grad.numpy().transpose(0, 2, 3, 1),
             leaves[3].grad.numpy().transpose(2, 3, 1, 0), leaves[4].grad.numpy()]]
    for want in (shift, gather):
        np.testing.assert_allclose(port[0], want[0], rtol=DCN_TOL, atol=DCN_TOL)
        for i in (0, 2, 3, 4):   # x, mask, weight, bias
            np.testing.assert_allclose(port[1][i], want[1][i], rtol=DCN_TOL, atol=DCN_TOL)
    np.testing.assert_allclose(port[1][1], gather[1][1], rtol=DCN_TOL, atol=DCN_TOL)
    assert np.abs(port[1][1] - shift[1][1]).max() > 0.1
