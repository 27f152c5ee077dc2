"""The port's int8 CenterNet chain against the JAX package's, on the CPU.

``bench.py --chain-int8`` serves both nets as int8 chains
(``configs.CHAIN_INT8``): per-tensor scales, every conv with 16 input
channels or more int8 (heads included), f32 joins (the JAX default), the
float ops in bf16 on a bf16 image.  Both stacks run the same numpy weights
(``torch_parity.random_variables``) with JAX's scales (JAX ``calibrate``
of the JAX bf16 model on the frames), the JAX chain op by op
(``jit=False``), and both chains start from JAX's stem output (the one
float op the port sums in another order; ``tests/test_torch_chain.py``):

- ``calibrate`` of the port's own model (``paths_of=
  weights.centerpoint_calibration_paths``) records JAX's keys: every conv
  with 16 input channels or more, the two projections the JAX trees
  compute and discard among them, and (``tests/test_torch_dcn_chain.py``)
  no DCN offset or mask conv, which the JAX block serves merged, not as
  an ``nn.Conv``; its values are within ``SCALE_RTOL`` of JAX's (measured
  7.5e-3 on the plain net);

- at 64x128, where the reference's ``pad_to_match`` and the JAX chain's
  symmetric one agree: the whole request through
  ``make_centernet_chain_pipeline`` on uint8 frames.  Every trunk map
  (int8 and float) is equal.  After the trunk the upsamples and joins are
  float boundaries, where one ulp could flip a code: the int8 codes are
  held to equal or 1 apart on at most ``CODE_SHARE`` of them, and the
  decoded detections at threshold 0 to 100% matched with every p95 <=
  1e-3 (measured: every map and head equal, every p95 0).  The port runs
  no projection of its own input in a tree of depth 2, which the JAX
  chain computes and discards: those two paths are the only ones JAX has
  and the port has not;
- at 72x104, against the JAX chain with its ``models.dla.pad_to_match``
  replaced by the reference's ``models.centerpoint_dla.pad_to_match``
  (the chain imports it at call time, so the module attribute is
  patched here; nothing in the JAX package changes): held as at 64x128
  (measured: equal);
- the finding: the JAX chain as it is differs there.  The final
  ``ida_up``'s x4 branch overshoots its target by 2 rows and 2 columns
  (20x28 against 18x26); the reference pads one zero row and column at
  the top and left and crops, where the symmetric matcher crops the tail,
  so ``ida_up/node_2`` and the heads move (at 640x360 the same branch
  is 92 rows against 90);
- the keypoint chain (``bench.py --keypoints``' ``int8_fps``, on the net of
  ``configs.KEYPOINTS``) at 64x128 through
  ``make_centernet_keypoint_chain_pipeline``: the maps held as above, the
  decode slot for slot and PnP's poses within
  ``tests/test_torch_keypoints.py``'s bars where the fit is below 1 px^2.

The YOLACT side of ``CHAIN_INT8`` is held in ``tests/test_torch_chain.py``
(``test_torch_yolact_chain_int8_recipe_matches_jax``), on that file's
small YOLACT.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models import centerpoint_dla as jax_centerpoint_dla
from tauv_vision_tpu.models import dla as jax_dla
from tauv_vision_tpu.models.centerpoint_dla import (
    CenterpointDLA34 as JaxCenterpointDLA34,
)
from tauv_vision_tpu.ops.image import preprocess as jax_preprocess
from tauv_vision_tpu.serving import centernet_decode as jax_decode
from tauv_vision_tpu.serving import quantize as jax_quantize
from tauv_vision_tpu.serving import quantize_chain as jax_chain
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import (
    CHAIN_INT8,
    KEYPOINTS,
    centernet_config,
    keypoints_config,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.serving import quantize_chain as port_chain
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.pipeline import IMAGENET_MEAN, IMAGENET_STDDEV, DecodeKnobs
from tauv_vision_tpu_torch.serving.quantize import calibrate
from tauv_vision_tpu_torch.weights import (
    centerpoint_calibration_paths,
    centerpoint_state_dict_from_flax,
)
from test_torch_keypoints import _assert_keypoints_equal
from torch_parity import (
    ChainRecorder,
    jax_centernet_config,
    jax_object_config,
    random_variables,
)

H, W = 64, 128
ALL_SLOTS = DecodeKnobs(score_threshold=0.0, keypoint_score_threshold=0.0,
                        confidence_threshold=0.0)
JAX_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
CN_STEM = "model/base/base_conv"
# The convs the JAX chain runs and the port's does not: a depth-2 tree's
# projection of its own input, which the JAX chain computes and discards.
JAX_ONLY = {"model/base/level3/project_conv", "model/base/level4/project_conv"}
# After the trunk: int8 codes equal or one apart, on at most this share.
CODE_SHARE = 1e-3
DECODE_P95 = 1e-3     # the PARITY.md bar
# The port's calibration scales against JAX's: absmaxes of bf16 conv
# outputs (through an f32 BatchNorm), two bf16 ulps apart at most.
SCALE_RTOL = 2 ** -6
# The port's own stem against JAX's: a bf16 conv output one ulp apart,
# through the BatchNorm's gain (up to ~2 here): within two bf16 ulps of the
# largest output.
STEM_ULPS = 2 ** -6


def _jax_model(oc, recipe, **dcn):
    cn = recipe.centernet
    return JaxCenterpointDLA34(object_config=jax_object_config(oc), deform=cn.deform,
                               dtype=JAX_DTYPE[cn.dtype], bn_out=JAX_DTYPE[cn.bn_out],
                               f32_stages=cn.f32_stages, **dcn)


def _frames(seed, h, w, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), np.uint8)


def _net(oc, mc, recipe, seed, **dcn):
    """(JAX model, numpy variables, port model on the same weights, JAX's
    scales: JAX ``calibrate`` of the JAX model on 2 frames).  ``dcn`` goes
    to the JAX model (its DCN implementation and window)."""
    jax_model = _jax_model(oc, recipe, **dcn)
    variables = random_variables(jax_model, (1, mc.in_h, mc.in_w, 3), seed)
    port = CenterpointDLA34(oc, device="cpu", **recipe.centernet_kwargs()).eval()
    port.load_state_dict(centerpoint_state_dict_from_flax(variables))
    img = jax_preprocess(jnp.asarray(_frames(seed + 100, mc.in_h, mc.in_w)),
                         (mc.in_h, mc.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                         dtype=JAX_DTYPE[recipe.input_dtype])
    scales = jax_quantize.calibrate(lambda b: jax_model.apply(variables, b, train=False), [img])
    return jax_model, variables, port, scales, img


def assert_calibrate_matches_jax(port, img, scales, record_property):
    """The port's ``calibrate`` of its own model on the same image: JAX's
    keys, and values within ``SCALE_RTOL`` of JAX's."""
    mine = calibrate(port, [torch.from_numpy(np.array(img.astype(jnp.float32))).permute(
        0, 3, 1, 2).to(port.model.base.base_layer[0].compute_dtype)],
        paths_of=centerpoint_calibration_paths)
    assert set(mine) == set(scales)
    err = max(abs(mine[p] / scales[p] - 1) for p in scales)
    record_property("calibrate_scales_max_rel_err", err)
    assert err <= SCALE_RTOL, err


@pytest.fixture(scope="module")
def net():
    oc, mc = centernet_config(H, W)
    return (oc,) + _net(oc, mc, CHAIN_INT8, 0)


def assert_maps_held(recorder, record_property, tag="", code_share=CODE_SHARE):
    """Trunk maps equal; after the trunk int8 codes within one on at most
    ``code_share`` of them.  Returns the share of later codes that differ."""
    jax_maps, port_maps = recorder.maps["jax"], recorder.maps["port"]
    stem_port, stem_jax = recorder.stems["port"], recorder.stems["jax"]
    np.testing.assert_allclose(stem_port, stem_jax, rtol=0,
                               atol=STEM_ULPS * np.abs(stem_jax).max())
    record_property(f"{tag}stem_share_differ", float((stem_port != stem_jax).mean()))
    assert set(jax_maps) - set(port_maps) <= JAX_ONLY and set(port_maps) <= set(jax_maps)
    differ, total = 0, 0
    for path, got in port_maps.items():
        want = jax_maps[path]
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if path.startswith("model/base/"):
            np.testing.assert_array_equal(got, want, err_msg=path)
        elif got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want)
            assert diff.max() <= 1, (path, diff.max())
            differ, total = differ + int((diff > 0).sum()), total + diff.size
    share = differ / max(total, 1)
    record_property(f"{tag}codes_after_trunk_share_differ", share)
    record_property(f"{tag}codes_after_trunk", total)
    assert share <= code_share, share
    return share


def _decode_held(want, got, record_property, tag=""):
    stats = detection_deltas(want, got, score_threshold=0.0)
    record_property(f"{tag}port_vs_jax", stats)
    assert stats["total"] == got.valid.numel() and stats["matched_fraction"] == 1.0, stats
    for what in ("center", "score", "size"):
        assert stats[f"{what}_delta_p95"] <= DECODE_P95, stats
    return stats


def _pipelines(net, h, w):
    """(JAX op-by-op chain pipeline, the port's, on the plain versions)."""
    oc, jax_model, variables, port, scales, _ = net
    _, mc = centernet_config(h, w)
    recipe = CHAIN_INT8
    want = jax_chain.make_centernet_chain_pipeline(
        jax_centernet_config(mc), jax_object_config(oc), variables, scales,
        n_detections=ALL_SLOTS.n_detections, score_threshold=0.0,
        dtype=JAX_DTYPE[recipe.input_dtype], jit=False)
    got = port_chain.make_centernet_chain_pipeline(port, mc, scales, "cpu", ALL_SLOTS,
                                                   impl="plain")
    return (lambda f: want(jnp.asarray(f))), got


def test_torch_centernet_calibrate_matches_jax(net, record_property):
    *_, port, scales, img = net
    assert_calibrate_matches_jax(port, img, scales, record_property)


def test_torch_centernet_chain_matches_jax(net, record_property):
    want_pipe, got_pipe = _pipelines(net, H, W)
    frames = _frames(1, H, W)
    before = dict(kernels.LAUNCHES)
    with ChainRecorder(jax_chain, port_chain, CN_STEM) as rec:
        want, got = want_pipe(frames), got_pipe(frames)
    assert kernels.LAUNCHES == before
    assert len(net[-2]) == 60 and set(rec.maps["jax"]) - set(rec.maps["port"]) == JAX_ONLY
    assert_maps_held(rec, record_property)
    _decode_held(want, got, record_property)


def test_torch_centernet_chain_reference_pad_to_match(net, monkeypatch, record_property):
    """72x104, against the JAX chain with the reference's matcher."""
    want_pipe, got_pipe = _pipelines(net, 72, 104)
    frames = _frames(2, 72, 104)
    monkeypatch.setattr(jax_dla, "pad_to_match", jax_centerpoint_dla.pad_to_match)
    with ChainRecorder(jax_chain, port_chain, CN_STEM) as rec:
        want, got = want_pipe(frames), got_pipe(frames)
    assert_maps_held(rec, record_property)
    _decode_held(want, got, record_property)


def test_torch_centernet_chain_symmetric_pad_to_match_finding(net, record_property):
    """The JAX chain as it is, at 72x104: equal up to the final ida_up's
    x4 branch, which its symmetric matcher does not shift."""
    want_pipe, got_pipe = _pipelines(net, 72, 104)
    frames = _frames(2, 72, 104)
    with ChainRecorder(jax_chain, port_chain, CN_STEM) as rec:
        want_pipe(frames)
        got_pipe(frames)
    jax_maps, port_maps = rec.maps["jax"], rec.maps["port"]
    order = list(port_maps)
    moved = order.index("model/ida_up/node_2/conv")
    for path in order[:moved]:
        np.testing.assert_array_equal(port_maps[path], jax_maps[path], err_msg=path)
    for path in order[moved:]:
        assert not np.array_equal(port_maps[path], jax_maps[path]), path
    heatmap = "model/head_0_out"
    record_property("heatmap_max_abs_diff",
                    float(np.abs(port_maps[heatmap] - jax_maps[heatmap]).max()))


@pytest.fixture(scope="module")
def keypoint_net():
    oc, mc, projection = keypoints_config(H, W)
    return (oc, mc, projection) + _net(oc, mc, KEYPOINTS, 3)


def test_torch_keypoint_chain_matches_jax(keypoint_net, record_property):
    oc, mc, projection, _, variables, port, scales, img = keypoint_net
    assert_calibrate_matches_jax(port, img, scales, record_property)
    dtype = JAX_DTYPE[KEYPOINTS.input_dtype]
    jax_forward = jax_chain.dla34_chain_forward(jax_object_config(oc), variables, scales,
                                                dtype=dtype)
    frames = _frames(4, H, W)
    img = jax_preprocess(jnp.asarray(frames), (H, W), IMAGENET_MEAN, IMAGENET_STDDEV,
                         dtype=dtype)
    pipe = port_chain.make_centernet_keypoint_chain_pipeline(port, mc, scales, projection,
                                                             "cpu", ALL_SLOTS, impl="plain")
    with ChainRecorder(jax_chain, port_chain, CN_STEM) as rec:
        heads = jax_forward(img)
        got = pipe(frames)
    assert_maps_held(rec, record_property)
    want = jax_decode.decode_keypoints(
        heads, jax_centernet_config(mc), jax_object_config(oc), jnp.asarray(projection),
        ALL_SLOTS.n_detections, ALL_SLOTS.keypoint_n_detections, 0.0, 0.0)
    claimed = int(np.asarray(want.keypoint_valid).sum())
    assert claimed > 0
    n_poses = _assert_keypoints_equal(got, want)
    record_property("claimed_keypoints", claimed)
    record_property("poses_compared", n_poses)
    assert n_poses > 0
