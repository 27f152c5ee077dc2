"""The keypoint path of the PyTorch port against the JAX package's.

``bench.py --keypoints`` serves the CenterNet node's full configuration:
``CenterpointDLA34`` with keypoint heatmap, affinity and depth heads
(``configs.keypoints_config``), decoded by ``decode_keypoints`` (kernel A
on both heatmaps, the greedy affinity matcher, LM PnP), and the node
servers place its detections in 3D.  Both stacks run here on the same
numpy weights and inputs, on the CPU:

- ``decode_keypoints`` on the same ``Prediction`` (JAX's raw heads of the
  keypoint net at 72x104, converted), at keypoint threshold 0 and 0.3:
  detections, indices, labels, ``keypoint_valid``, slot positions and
  affinities exact, scores within 1e-6 (the sigmoids of XLA and of
  PyTorch round an ulp apart); poses compared where JAX's
  ``pose_error`` is below 1 px^2, within 1e-3 of the largest entry, and
  the fit of every valid pose within 1e-5 relative: LM on
  random correspondences (2-3 a detection here, fewer than the 6 that
  validate a pose) is chaotic, and where the fit is poor the two
  frameworks' Jacobians, a few ulps apart, may lead LM apart.
- The planted scene of ``tests/test_serving.py``: one detection claims
  its 7 keypoints into the right slots and the pose is valid (its
  object points are collinear, so only its fit is compared).
- ``decode`` with yaw / pitch / roll (``AngleConfig(train=True)``) and
  depth heads: angles within 1e-6, depth within 2 f32 ulps of 1 + depth
  (not exact: see ``tests/test_torch_pnp.py``).
- The keypoint net end to end through ``make_centernet_keypoint_pipeline``
  on uint8 80x96 frames resized to 72x104: in f32, raw heads within 2e-4
  of JAX's compiled graph and detections 100% matched with every p95 <=
  1e-5; in the served bf16 recipe (``configs.KEYPOINTS``), no further from
  JAX's op-by-op graph than JAX's own compiled graph is, p95 by p95 (see
  ``tests/test_torch_north_star.py``).
- ``CenternetServer`` and ``YolactServer`` against the JAX package's, at
  the sizes of ``tests/test_serving_nodes_utils.py`` (64x64, 4
  detections and 8 keypoint peaks, 2 frames; YOLACT top 5), and the
  CenterNet also with 2 detections and 50 peaks, where PnP places some:
  published tags, counts and orientations equal, positions within 1e-4,
  with a depth plane, a depth image whose holes drop some detections, and
  (CenterNet) none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.configs import ClassConfig as JaxClassConfig
from tauv_vision_tpu.configs import ClassConfigSet as JaxClassConfigSet
from tauv_vision_tpu.models.centerpoint_dla import (
    CenterpointDLA34 as JaxCenterpointDLA34,
)
from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu.ops.depth import depth_encode as jax_depth_encode
from tauv_vision_tpu.ops.image import preprocess as jax_preprocess
from tauv_vision_tpu.serving import centernet_decode as jax_decode
from tauv_vision_tpu.serving import nodes as jax_nodes
from tauv_vision_tpu.serving import pipeline as jax_pipeline
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import (
    KEYPOINTS,
    AngleConfig,
    ClassConfig,
    ClassConfigSet,
    ObjectConfig,
    ObjectConfigSet,
    get_head_channels,
    keypoints_config,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.serving import centernet_decode
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.nodes import CenternetServer, YolactServer
from tauv_vision_tpu_torch.serving.pipeline import (
    DecodeKnobs,
    IMAGENET_MEAN,
    IMAGENET_STDDEV,
    back_project,
    depth_window_z,
    make_centernet_keypoint_pipeline,
    mask_mean_z,
)
from tauv_vision_tpu_torch.weights import centerpoint_state_dict_from_flax
from test_serving import MC as SCENE_MC, _blank_prediction, _keypoint_object_config
from test_torch_pnp import assert_depth_close
from torch_parity import (
    SMALL_YOLACT,
    jax_centernet_config,
    jax_object_config,
    port_object_config,
    port_prediction,
    random_variables,
    yolact_pair,
)

H, W = 72, 104
ALL_SLOTS = DecodeKnobs(score_threshold=0.0, keypoint_score_threshold=0.0)
JAX_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
SCORE_ATOL = 1e-6
POSE_RTOL = 1e-3
FIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def net():
    """(port object config, model config, projection, JAX model, numpy
    variables, port model in f32 on the same weights)."""
    oc, mc, projection = keypoints_config(H, W)
    jax_model = JaxCenterpointDLA34(object_config=jax_object_config(oc), deform=False)
    variables = random_variables(jax_model, (1, H, W, 3), 0)
    port = CenterpointDLA34(oc, device="cpu").eval()
    port.load_state_dict(centerpoint_state_dict_from_flax(variables))
    return oc, mc, projection, jax_model, variables, port


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, 80, 96, 3), np.uint8)


@pytest.fixture(scope="module")
def jax_heads(net, frames):
    _, mc, _, jax_model, variables, _ = net
    img = jax_preprocess(jnp.asarray(frames), (mc.in_h, mc.in_w), IMAGENET_MEAN,
                         IMAGENET_STDDEV, dtype=jnp.float32)
    return jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, img)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_keypoints_equal(got, want):
    """Slots exact, scores within SCORE_ATOL, poses within POSE_RTOL where
    JAX's fit is below 1 px^2, and the fit of every valid pose within
    FIT_RTOL; returns how many poses were compared."""
    for name in ("valid", "label", "y", "x", "h", "w"):
        np.testing.assert_array_equal(_np(getattr(got.detections, name)),
                                      _np(getattr(want.detections, name)), err_msg=name)
    np.testing.assert_allclose(_np(got.detections.score), _np(want.detections.score),
                               rtol=0, atol=SCORE_ATOL)
    for name in ("keypoint_valid", "keypoint_y", "keypoint_x", "keypoint_affinity",
                 "pose_valid"):
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(_np(got.keypoint_score), _np(want.keypoint_score),
                               rtol=0, atol=SCORE_ATOL)
    valid = _np(want.pose_valid)
    np.testing.assert_allclose(_np(got.pose_error)[valid], _np(want.pose_error)[valid],
                               rtol=FIT_RTOL, atol=0)
    fit = _np(want.pose_error) < 1.0
    for name in ("pose_rotation", "pose_translation"):
        a, b = _np(getattr(got, name))[fit], _np(getattr(want, name))[fit]
        scale = np.abs(b).reshape(len(b), -1).max(-1)
        err = np.abs(a - b).reshape(len(b), -1).max(-1)
        assert (err <= POSE_RTOL * scale).all(), (name, float((err / scale).max()))
    return int(fit.sum())


@pytest.mark.parametrize("keypoint_threshold", [0.0, 0.3, 0.6])
def test_torch_decode_keypoints_matches_jax_on_the_same_heads(net, jax_heads,
                                                              keypoint_threshold,
                                                              record_property):
    oc, mc, projection, *_ = net
    want = jax_decode.decode_keypoints(jax_heads, jax_centernet_config(mc),
                                       jax_object_config(oc), jnp.asarray(projection), 10, 50,
                                       0.0, keypoint_threshold)
    with torch.inference_mode():
        got = centernet_decode.decode_keypoints(
            port_prediction(jax_heads), mc, oc, torch.tensor(projection), 10, 50, 0.0,
            keypoint_threshold, impl="plain")
    claimed = int(_np(want.keypoint_valid).sum())
    assert claimed > 0       # the matcher has work at every threshold
    n_poses = _assert_keypoints_equal(got, want)
    assert n_poses > 0
    record_property("claimed_keypoints", claimed)
    record_property("poses_compared", n_poses)
    assert got.detections.depth is not None
    assert_depth_close(_np(got.detections.depth), _np(want.detections.depth))


def _planted_scene():
    """``tests/test_serving.py::test_decode_keypoints_matching``'s scene:
    one detection and its 7 keypoint peaks, affinities pointing from the
    detection centre to each."""
    oc = _keypoint_object_config()
    out_h, out_w = SCENE_MC.out_h, SCENE_MC.out_w
    pred = _blank_prediction(n_labels=1)
    pred = pred.replace(
        keypoint_heatmap=jnp.full((1, out_h, out_w, oc.n_keypoints), -10.0),
        keypoint_affinity=jnp.zeros((1, out_h, out_w, oc.n_keypoints, 2)),
    )
    dy, dx = 8, 12
    pred = pred.replace(heatmap=pred.heatmap.at[0, dy, dx, 0].set(6.0))
    cells = [(6, 10), (6, 14), (10, 10), (10, 14), (8, 15), (5, 12), (11, 12)]
    for ch, (ky, kx) in enumerate(cells):
        vec = np.asarray([ky / out_h - dy / out_h, kx / out_w - dx / out_w])
        pred = pred.replace(
            keypoint_heatmap=pred.keypoint_heatmap.at[0, ky, kx, ch].set(6.0),
            keypoint_affinity=pred.keypoint_affinity.at[0, ky, kx, ch].set(
                jnp.asarray(vec / np.linalg.norm(vec))),
        )
    return oc, pred, cells


def test_torch_decode_keypoints_planted_scene_matches_jax():
    jax_oc, pred, cells = _planted_scene()
    cam = np.asarray([[100.0, 0, 48], [0, 100.0, 32], [0, 0, 1]], np.float32)
    args = (2, 10, 0.5, 0.5)
    want = jax_decode.decode_keypoints(pred, SCENE_MC, jax_oc, jnp.asarray(cam), *args)
    with torch.inference_mode():
        got = centernet_decode.decode_keypoints(
            port_prediction(pred), SCENE_MC, port_object_config(jax_oc), torch.from_numpy(cam),
            *args, impl="plain")
    assert bool(got.detections.valid[0, 0]) and bool(got.pose_valid[0, 0])
    claimed = got.keypoint_valid[0, 0].numpy()
    assert claimed.sum() == 7
    for ch, (ky, kx) in enumerate(cells):
        assert claimed[ch]
        assert float(got.keypoint_y[0, 0, ch]) == pytest.approx(ky / SCENE_MC.out_h)
        assert float(got.keypoint_x[0, 0, ch]) == pytest.approx(kx / SCENE_MC.out_w)
    # Its 7 object points lie on a line, so the rotation about it is not
    # observable: LM stops at a fit of ~104 px^2, where the pose itself is
    # not determined and only the fit is compared.
    assert float(want.pose_error[0, 0]) > 1.0
    _assert_keypoints_equal(got, want)


def test_torch_decode_angles_and_depth_match_jax():
    """Random heads of a config that trains all three angles and depth."""
    trained = AngleConfig(train=True, modulo=2 * np.pi)
    oc = ObjectConfigSet(configs=tuple(
        ObjectConfig(id=name, yaw=trained, pitch=trained, roll=trained, train_depth=True,
                     train_keypoints=False) for name in ("a", "b", "c")))
    assert get_head_channels(oc) == (3, 2, 2, 4, 4, 4, 4, 4, 4, 1)
    _, mc, _ = keypoints_config(H, W)
    rng = np.random.default_rng(5)
    shape = (2, mc.out_h, mc.out_w)
    heads = {name: rng.normal(size=shape + (c,)).astype(np.float32) * scale
             for name, c, scale in (("heatmap", 3, 3.0), ("size", 2, 1.0), ("offset", 2, 1.0),
                                    ("yaw_bin", 4, 2.0), ("yaw_offset", 4, 1.0),
                                    ("pitch_bin", 4, 2.0), ("pitch_offset", 4, 1.0),
                                    ("roll_bin", 4, 2.0), ("roll_offset", 4, 1.0),
                                    ("depth", 1, 3.0))}
    pred = _blank_prediction().replace(keypoint_heatmap=None, keypoint_affinity=None,
                                       **{k: jnp.asarray(v) for k, v in heads.items()})
    want = jax_decode.decode(pred, jax_centernet_config(mc), 20, 0.3)
    got = centernet_decode.decode(port_prediction(pred), mc, 20, 0.3, impl="plain")
    for name in ("valid", "label", "y", "x", "h", "w"):
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)))
    for name in ("yaw", "pitch", "roll"):
        diff = np.abs(_np(getattr(got, name)) - _np(getattr(want, name)))
        # The top of [0, 2 pi) and 0 are the same angle.
        np.testing.assert_allclose(np.minimum(diff, np.abs(diff - 2 * np.pi)), 0.0,
                                   atol=SCORE_ATOL, err_msg=name)
    assert_depth_close(_np(got.depth), _np(want.depth))
    # A planted depth decodes to its value, as in tests/test_serving.py.
    pred = pred.replace(depth=pred.depth.at[0, 5, 11, 0].set(jax_depth_encode(jnp.asarray(3.0))),
                        heatmap=pred.heatmap.at[0, 5, 11, 1].set(40.0))
    got = centernet_decode.decode(port_prediction(pred), mc, 20, 0.3, impl="plain")
    assert float(got.depth[0, 0]) == pytest.approx(3.0, rel=1e-4)


def test_torch_depth_helpers_match_jax():
    rng = np.random.default_rng(6)
    depth = rng.uniform(0.5, 4.0, (2, 30, 40)).astype(np.float32)
    depth[0, :8, :8] = 0.0
    depth[1, 10:20, 5:9] = np.nan
    centers = np.stack([rng.integers(0, 30, (2, 6)), rng.integers(0, 40, (2, 6))], -1)
    centers[0, 0] = (3, 3)     # a window with no valid depth
    masks = rng.uniform(0, 1, (2, 6, 30, 40)).astype(np.float32)
    masks[1, 2] = 0.0          # an empty mask
    want_w = np.asarray(jax_pipeline.depth_window_z(jnp.asarray(depth),
                                                    jnp.asarray(centers, jnp.int32), 5))
    got_w = depth_window_z(torch.from_numpy(depth), torch.from_numpy(centers), 5).numpy()
    want_m = np.asarray(jax_pipeline.mask_mean_z(jnp.asarray(depth), jnp.asarray(masks)))
    got_m = mask_mean_z(torch.from_numpy(depth), torch.from_numpy(masks)).numpy()
    assert np.isnan(got_w[0, 0]) and np.isnan(got_m[1, 2])
    np.testing.assert_allclose(got_w, want_w, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_m, want_m, rtol=1e-6, atol=0)
    intr = np.asarray([[100.0, 0, 32], [0, 110.0, 30], [0, 0, 1]], np.float32)
    y, x, z = (rng.uniform(0, 1, (2, 6)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        back_project(*map(torch.from_numpy, (y, x, z, intr)), (60, 80)).numpy(),
        np.asarray(jax_pipeline.back_project(*map(jnp.asarray, (y, x, z, intr)), (60, 80))),
        rtol=1e-6, atol=1e-6)


def _jax_keypoint_pipeline(net, dtype, model, variables, jit):
    oc, mc, projection, *_ = net
    fn = jax_pipeline.make_centernet_keypoint_pipeline(
        model, jax_centernet_config(mc), jax_object_config(oc), projection,
        ALL_SLOTS.n_detections, ALL_SLOTS.keypoint_n_detections, ALL_SLOTS.score_threshold,
        ALL_SLOTS.keypoint_score_threshold, dtype=dtype, jit=jit)
    return lambda frames: fn(variables, jnp.asarray(frames))


def test_torch_keypoint_pipeline_f32_matches_jax(net, frames, jax_heads):
    oc, mc, projection, jax_model, variables, port = net
    with torch.inference_mode():
        heads = port(torch.from_numpy(np.array(
            jax_preprocess(jnp.asarray(frames), (H, W), IMAGENET_MEAN, IMAGENET_STDDEV,
                           dtype=jnp.float32))).permute(0, 3, 1, 2))
    for name in ("heatmap", "keypoint_heatmap", "keypoint_affinity", "size", "offset", "depth"):
        np.testing.assert_allclose(_np(getattr(heads, name)), _np(getattr(jax_heads, name)),
                                   rtol=0, atol=2e-4, err_msg=name)
    want = _jax_keypoint_pipeline(net, jnp.float32, jax_model, variables, True)(frames)
    pipe = make_centernet_keypoint_pipeline(port, mc, oc, projection, "cpu", knobs=ALL_SLOTS,
                                            impl="plain")
    before = dict(kernels.LAUNCHES)
    got = pipe(frames)
    assert kernels.LAUNCHES == before
    stats = detection_deltas(want.detections, got.detections, score_threshold=0.0)
    assert stats["total"] == got.detections.valid.numel()
    assert stats["matched_fraction"] == 1.0, stats
    for what in ("center", "score", "size"):
        assert stats[f"{what}_delta_p95"] <= 1e-5, stats
    assert got.keypoint_valid.shape == (2, 10, 8) and got.pose_translation.shape == (2, 10, 3)
    assert int(got.keypoint_valid.sum()) > 0


def test_torch_keypoint_pipeline_bf16_matches_jax(net, frames, record_property):
    """``configs.KEYPOINTS``: bf16 convs, f32 BatchNorm outputs, a bf16
    input, against JAX's op-by-op graph (the reference) with JAX's
    compiled graph as the yardstick."""
    oc, mc, projection, _, variables, _ = net
    recipe = KEYPOINTS.centernet
    jax_model = JaxCenterpointDLA34(object_config=jax_object_config(oc), deform=False,
                                    dtype=JAX_DTYPE[recipe.dtype], bn_out=JAX_DTYPE[recipe.bn_out],
                                    f32_stages=recipe.f32_stages)
    port = CenterpointDLA34(oc, device="cpu", **KEYPOINTS.centernet_kwargs()).eval()
    port.load_state_dict(centerpoint_state_dict_from_flax(variables))
    dtype = JAX_DTYPE[KEYPOINTS.input_dtype]
    want = _jax_keypoint_pipeline(net, dtype, jax_model, variables, False)(frames)
    compiled = _jax_keypoint_pipeline(net, dtype, jax_model, variables, True)(frames)
    yardstick = detection_deltas(want.detections, compiled.detections, score_threshold=0.0)
    record_property("jax_compiled_vs_op_by_op", yardstick)
    got = make_centernet_keypoint_pipeline(port, mc, oc, projection, "cpu", knobs=ALL_SLOTS,
                                           impl="plain", dtype=KEYPOINTS.input_dtype)(frames)
    stats = detection_deltas(want.detections, got.detections, score_threshold=0.0)
    record_property("port_vs_jax", stats)
    assert stats["total"] == got.detections.valid.numel()
    assert stats["matched_fraction"] >= min(0.99, yardstick["matched_fraction"]), stats
    for what in ("center", "score", "size"):
        key = f"{what}_delta_p95"
        assert stats[key] <= max(yardstick[key], 1e-5), (what, stats, yardstick)


def _published(results):
    return [[(d.tag, np.asarray(d.position, np.float64),
              None if d.orientation is None else np.asarray(d.orientation, np.float64),
              d.confidence) for d in sample] for sample in results]


def _assert_published_equal(got, want, what):
    assert [len(s) for s in got] == [len(s) for s in want], what
    for sample_got, sample_want in zip(got, want):
        for (tag, pos, rot, conf), (tag_w, pos_w, rot_w, conf_w) in zip(sample_got, sample_want):
            assert tag == tag_w, what
            np.testing.assert_allclose(pos, pos_w, rtol=0, atol=1e-4, err_msg=what)
            assert (rot is None) == (rot_w is None), what
            assert conf == pytest.approx(conf_w, abs=1e-4), what


def _depth_frames(b, h, w, value):
    """A plane at ``value`` metres whose left half is NaN and whose top
    half is 0 (both invalid), so that the detections there have no depth
    and are dropped unless PnP places them."""
    depth = np.full((b, h, w), value, np.float32)
    depth[:, :, : w // 2] = np.nan
    depth[:, : h // 2] = 0.0
    return depth


def _serve_both(want_server, server, color, depth, world_t_cam):
    want = want_server.process(color, depth, pose_lookup=lambda: world_t_cam)
    published = []
    got = server.process(color, depth, pose_lookup=lambda: world_t_cam,
                         publish=published.append)
    assert len(published) == len(color)
    return _published(got), _published(want)


@pytest.mark.parametrize("n_detections,keypoint_n_detections,keypoint_threshold", [
    (4, 8, 0.3),    # tests/test_serving_nodes_utils.py's sizes: no pose, depth holes drop
    (2, 50, 0.0),   # few detections and many peaks: PnP places every detection
])
def test_torch_centernet_server_matches_jax(n_detections, keypoint_n_detections,
                                            keypoint_threshold):
    """``CenternetServer`` on the keypoint net at 64x64 (detections at
    threshold 0) against the JAX package's on the same weights, colour
    frames, depth and pose."""
    oc, mc, _ = keypoints_config(64, 64)
    jax_model = JaxCenterpointDLA34(object_config=jax_object_config(oc), deform=False)
    variables = random_variables(jax_model, (1, 64, 64, 3), 3)
    color = np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    if keypoint_n_detections == 50:
        # A random net's keypoint channels differ in their mean logit, and
        # the top peaks come from 2-3 of them; shift each channel's bias by
        # its mean on these frames so that every channel peaks and a
        # detection can claim 6 keypoints.
        img = jax_preprocess(jnp.asarray(color), (64, 64), IMAGENET_MEAN, IMAGENET_STDDEV,
                             dtype=jnp.bfloat16)
        heads = jax_model.apply(variables, img, train=False).keypoint_heatmap
        variables["params"]["model"]["head_1_out"]["bias"] -= np.asarray(
            heads.mean(axis=(0, 1, 2)), np.float32)
    port = CenterpointDLA34(oc, device="cpu").eval()
    port.load_state_dict(centerpoint_state_dict_from_flax(variables))
    intr = np.asarray([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]])
    kwargs = dict(n_detections=n_detections, keypoint_n_detections=keypoint_n_detections,
                  score_threshold=0.0, keypoint_score_threshold=keypoint_threshold)
    want_server = jax_nodes.CenternetServer(jax_model, variables, jax_centernet_config(mc),
                                            jax_object_config(oc), intr, **kwargs)
    server = CenternetServer(port, mc, oc, intr, device="cpu", **kwargs)
    world_t_cam = np.eye(4)
    world_t_cam[:3, 3] = (1.0, -2.0, 0.5)
    counts = {}
    for name, depth in (("plane", np.full((2, 64, 64), 2.0, np.float32)),
                        ("holes", _depth_frames(2, 64, 64, 2.0)), ("none", None)):
        got, want = _serve_both(want_server, server, color, depth, world_t_cam)
        _assert_published_equal(got, want, f"centernet {name}")
        assert all(tag == "torpedo_24" and np.isfinite(pos).all()
                   for s in got for tag, pos, _, _ in s)
        counts[name] = (sum(len(s) for s in got),
                        sum(rot is not None for s in got for _, _, rot, _ in s))
    # Without depth only PnP places a detection; with it every valid one
    # is placed, by PnP where its pose is valid.
    n_posed = counts["none"][0]
    assert counts["plane"] == (2 * n_detections, n_posed)
    if keypoint_n_detections == 50:
        assert counts["holes"] == counts["none"] == counts["plane"]
    else:
        assert n_posed == 0 and 0 < counts["holes"][0] < counts["plane"][0]


def test_torch_yolact_server_matches_jax():
    """``YolactServer`` on the small YOLACT of ``tests/
    test_serving_nodes_utils.py`` (top 5, confidence 0) against the JAX
    package's."""
    from tauv_vision_tpu_torch.configs import YolactModelConfig

    cfg = YolactModelConfig(**SMALL_YOLACT)
    jax_cfg, jax_model, variables, port = yolact_pair(cfg, 1)
    assert isinstance(jax_model, JaxYolact)
    classes = (("bg", 0), ("a", 1), ("b", 2))
    jax_classes = JaxClassConfigSet(tuple(JaxClassConfig(*c) for c in classes))
    port_classes = ClassConfigSet(tuple(ClassConfig(*c) for c in classes))
    intr = np.asarray([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]])
    kwargs = dict(top_k=5, iou_threshold=0.5, confidence_threshold=0.0)
    want_server = jax_nodes.YolactServer(jax_model, variables, jax_cfg, jax_classes, intr,
                                         **kwargs)
    server = YolactServer(port, cfg, port_classes, intr, device="cpu", **kwargs)
    color = np.random.default_rng(1).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    counts = []
    for depth in (np.full((2, 64, 64), 1.5, np.float32), _depth_frames(2, 64, 64, 1.5)):
        got, want = _serve_both(want_server, server, color, depth, np.eye(4))
        _assert_published_equal(got, want, "yolact")
        counts.append(sum(len(s) for s in got))
        assert all(tag in ("a", "b") and np.isfinite(pos).all()
                   for s in got for tag, pos, _, _ in s)
    assert 0 < counts[1] < counts[0] and server.last_latency > 0
