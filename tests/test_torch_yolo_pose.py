"""YOLO-Pose in the PyTorch port against the JAX package, in f32.

The small config of ``tests/test_yolo_pose.py`` (96x64), the JAX
package's weights drawn with numpy (``torch_parity.random_variables``)
and carried over by ``weights.yolo_pose_state_dict_from_flax``, seeded
numpy inputs, on the CPU:

- the config's JSON round trip, and the weights: every flax leaf of the
  small and of the bench config consumed exactly once;
- the Pointnet stage by stage within 1e-5, and every field of the raw
  ``YoloPosePrediction`` within 2e-4;
- the decode on JAX's own prediction against JAX's decode run op by op
  (compiled, XLA turns ``/ bw`` into a multiply by the reciprocal, an
  ulp apart): ``valid``, labels and scores equal, boxes within one f32
  ulp (``box_decode``'s ``exp`` rounds an ulp apart between XLA and
  torch on a few inputs; JAX's compiled decode differs from its
  op-by-op one in the same elements); the belief maps within 1e-6; and
  the whole port (preprocess, net, decode) against JAX's on the same
  uint8 frames: ``valid`` and labels equal, boxes and scores within
  1e-5.  Keypoints are equal but on maps whose top two values lie
  within ``TIE`` (kernel B and the plain version sum the prototypes in
  another order than XLA's einsum), counted and recorded;
- the plain belief assembly (kernel B's plain version, no crop) against
  ``assemble_mask_pallas`` in interpret mode and against the decode's
  einsum, at the decode's shapes;
- PnP through ``attach_pnp`` on planted keypoints at the bench's camera
  and object points (a random net's keypoints are random correspondences,
  where LM is chaotic and two f32 solvers part): ``pose_valid`` equal,
  rotation and translation within 1e-3 of JAX's, and near the planted
  poses;
- ``BENCH_YOLO_POSE`` at full width, batch 1: the port's forward, decode
  and PnP on the CPU against the shapes and anchor count of JAX's
  ``YoloPose`` at that config (``jax.eval_shape``: nothing compiles).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tauv_vision_tpu.configs.yolo_pose import YoloPoseModelConfig as JaxYoloPoseModelConfig
from tauv_vision_tpu.models.pointnet import Pointnet as JaxPointnet
from tauv_vision_tpu.models.yolo_pose import YoloPose as JaxYoloPose
from tauv_vision_tpu.ops.image import preprocess as jax_preprocess
from tauv_vision_tpu.ops.pallas.mask_assembly import assemble_mask_pallas
from tauv_vision_tpu.serving import yolo_pose_decode as jax_decode
from tauv_vision_tpu.serving.pipeline import IMAGENET_MEAN, IMAGENET_STDDEV
from tauv_vision_tpu_torch.configs import BENCH_YOLO_POSE, YoloPoseModelConfig
from tauv_vision_tpu_torch.models.yolo_pose import YoloPose, YoloPosePrediction
from tauv_vision_tpu_torch.ops.masks import assemble_mask_batch
from tauv_vision_tpu_torch.ops.se3 import so3_exp
from tauv_vision_tpu_torch.serving.pipeline import YOLO_POSE_DECODE, make_yolo_pose_pipeline
from tauv_vision_tpu_torch.serving.yolo_pose_decode import (
    YoloPoseDetections,
    attach_pnp,
    decode_yolo_pose,
)
from tauv_vision_tpu_torch.weights import yolo_pose_flax_path, yolo_pose_state_dict_from_flax
from torch_parity import random_variables, torch_threads

# tests/test_yolo_pose.py:18-30.
SMALL = dict(
    in_w=96, in_h=64, feature_depth=16, n_classes=2, n_prototype_masks=4,
    n_masknet_layers_pre_upsample=1, n_masknet_layers_post_upsample=1,
    pointnet_layers=((5, 3, 16), (5, 3, 16)),
    pointnet_feature_depth=16,
    prototype_belief_depth=4, prototype_affinity_depth=4,
    belief_depth=3, affinity_depth=6,
    n_prediction_head_layers=1, n_fpn_downsample_layers=2,
    belief_sigma=2.0, affinity_radius=4.0,
    anchor_scales=(12, 24, 48, 96, 192), anchor_aspect_ratios=(1.0,),
    box_variances=(0.1, 0.2),
    iou_pos_threshold=0.4, iou_neg_threshold=0.3, negative_example_ratio=3,
)
CFG = YoloPoseModelConfig(**SMALL)
JAX_CFG = JaxYoloPoseModelConfig(**SMALL)
BATCH = 4
TOP_K, IOU = 10, 0.5          # the served decode's; confidence 0: every slot
RAW_ATOL = 2e-4
STAGE_ATOL = 1e-5
SCORE_ATOL = 1e-5
BELIEF_ATOL = 1e-6
POSE_ATOL = 1e-3
TIE = 1e-5                    # a belief map's top two values this close: a near-tie
FIELDS = ("classification", "box_encoding", "mask_coeff", "belief_coeff", "affinity_coeff",
          "anchor", "mask_prototype")
STAGE_FIELDS = ("belief_prototypes", "affinity_prototypes")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def yolo_pose_pair(dtype, seed, cfg=CFG):
    """(JAX model, numpy variables, the port's model on the same weights)."""
    jax_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_model = JaxYoloPose(JaxYoloPoseModelConfig(**dataclasses.asdict(cfg)), dtype=jax_dtype)
    variables = random_variables(jax_model, (1, cfg.in_h, cfg.in_w, 3), seed)
    port = YoloPose(cfg, device="cpu", dtype=dtype).eval()
    port.load_state_dict(yolo_pose_state_dict_from_flax(variables))
    return jax_model, variables, port


def frames(seed, batch=BATCH, cfg=CFG):
    """uint8 camera frames at 1.5x the net's input, so preprocess resizes."""
    shape = (batch, cfg.in_h * 3 // 2, cfg.in_w * 3 // 2, 3)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def port_prediction(p) -> YoloPosePrediction:
    """A JAX ``YoloPosePrediction`` as the port's, on the CPU."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    return YoloPosePrediction(**{f: t(getattr(p, f)) for f in FIELDS},
                              **{f: tuple(t(x) for x in getattr(p, f)) for f in STAGE_FIELDS})


def near_ties(belief) -> np.ndarray:
    """[..., h, w] maps -> bool [...]: the top two values within ``TIE``."""
    flat = np.sort(np.asarray(belief, np.float64).reshape(*belief.shape[:-2], -1), axis=-1)
    return flat[..., -1] - flat[..., -2] <= TIE


def check_keypoints(got, want, record_property, name):
    """Keypoints equal on every map but the near-ties of ``want``'s maps,
    whose count is recorded."""
    tie = near_ties(want.belief)
    moved = np.zeros_like(tie)
    for f in ("keypoint_y", "keypoint_x"):
        moved |= getattr(got, f).numpy() != np.asarray(getattr(want, f))
    record_property(f"{name}_near_ties", int(tie.sum()))
    record_property(f"{name}_keypoints_moved", int(moved.sum()))
    assert not (moved & ~tie).any(), (name, np.argwhere(moved & ~tie))


@pytest.fixture(scope="module")
def small():
    """The small pair, JAX's compiled forward of the frames' preprocessed
    image, and JAX's decode of it run op by op."""
    jax_model, variables, port = yolo_pose_pair(torch.float32, 0)
    raw = frames(1)
    img = jax.jit(lambda x: jax_preprocess(x, (CFG.in_h, CFG.in_w), IMAGENET_MEAN,
                                           IMAGENET_STDDEV, dtype=jnp.float32))(raw)
    pred = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, img)
    dets = jax_decode.decode_yolo_pose(pred, JAX_CFG, TOP_K, IOU, 0.0)
    return dict(jax_model=jax_model, variables=variables, port=port, raw=raw,
                img=np.array(img), pred=pred, dets=dets)


def test_torch_yolo_pose_config_round_trip(tmp_path):
    path = tmp_path / "config.json"
    CFG.save(path)
    loaded = YoloPoseModelConfig.load(path)
    assert loaded == CFG and isinstance(loaded.pointnet_layers[0], tuple)
    assert loaded.n_anchors_per_cell == 1 and loaded.n_fpn_levels == 5
    # The JAX package reads what the port writes, and the other way round.
    assert dataclasses.asdict(JaxYoloPoseModelConfig.load(path)) == CFG.to_dict()
    JAX_CFG.save(tmp_path / "jax.json")
    assert YoloPoseModelConfig.load(tmp_path / "jax.json") == CFG
    # Every depth of the JAX ``ResnetFeatures`` builds; another raises.
    assert YoloPose(YoloPoseModelConfig(**{**SMALL, "backbone_depth": 50}),
                    device="cpu").backbone.tap_depths == (512, 1024, 2048)
    with pytest.raises(ValueError, match="backbone_depth"):
        YoloPoseModelConfig(**{**SMALL, "backbone_depth": 42})


def _flax_leaves(variables):
    out = set()
    for col in ("params", "batch_stats"):
        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    out.add((col, "/".join(path), k))
        walk(variables.get(col, {}), ())
    return out


@pytest.mark.parametrize("which", ["small", "bench"])
def test_torch_yolo_pose_weights_consume_every_leaf(which):
    """Each flax leaf becomes exactly one port tensor, equal after the
    layout change, and the port's state dict is complete."""
    cfg = CFG if which == "small" else BENCH_YOLO_POSE.model
    jax_model = JaxYoloPose(JaxYoloPoseModelConfig(**dataclasses.asdict(cfg)))
    variables = random_variables(jax_model, (1, cfg.in_h, cfg.in_w, 3), 2)
    state = yolo_pose_state_dict_from_flax(variables)
    port = YoloPose(cfg, device="cpu")
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    consumed = []
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        path = yolo_pose_flax_path(module)
        node = variables["params"]
        for k in path.split("/"):
            node = node[k]
        col, name = {
            "weight": ("params", "kernel" if "kernel" in node else "scale"),
            "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var"),
        }[leaf]
        consumed.append((col, path, name))
        flax = variables[col]
        for k in path.split("/"):
            flax = flax[k]
        flax = flax[name]
        if flax.ndim == 4:
            transposed = path.startswith("protonet/upsample")
            flax = np.transpose(flax, (2, 3, 0, 1) if transposed else (3, 2, 0, 1))
        np.testing.assert_array_equal(value.numpy(), flax, err_msg=key)
    assert len(consumed) == len(set(consumed))
    assert set(consumed) == _flax_leaves(variables)


def test_torch_pointnet_stages_match_jax(small):
    """The cascade fed one FPN map: each stage's belief and affinity
    prototypes within 1e-5 (f32 convs summed in another order)."""
    fpn = np.random.default_rng(3).normal(size=(2, 8, 12, CFG.feature_depth)).astype(np.float32)
    jax_pointnet = JaxPointnet(CFG.pointnet_layers, CFG.pointnet_feature_depth,
                               CFG.prototype_belief_depth, CFG.prototype_affinity_depth)
    beliefs, affinities = jax_pointnet.apply(
        {"params": small["variables"]["params"]["pointnet"]}, jnp.asarray(fpn))
    with torch.inference_mode():
        got = small["port"].pointnet(torch.from_numpy(fpn).permute(0, 3, 1, 2).contiguous())
    for stage in range(len(CFG.pointnet_layers)):
        for i, want in enumerate((beliefs, affinities)):
            g = got[i][stage]
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(want[stage]),
                                       rtol=0, atol=STAGE_ATOL, err_msg=f"stage {stage} {i}")


@pytest.mark.parametrize("field", FIELDS + STAGE_FIELDS)
def test_torch_yolo_pose_forward_matches_jax(small, field):
    with torch.inference_mode():
        got = getattr(small["port"](torch.from_numpy(small["img"]).permute(0, 3, 1, 2)
                                    .contiguous()), field)
    want = getattr(small["pred"], field)
    if field in STAGE_FIELDS:
        assert len(got) == len(want) == len(CFG.pointnet_layers)
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, field
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=RAW_ATOL, err_msg=field)


def test_torch_yolo_pose_decode_matches_jax(small, record_property):
    """The decode alone, on JAX's prediction."""
    want = small["dets"]
    with torch.inference_mode():
        got = decode_yolo_pose(port_prediction(small["pred"]), CFG, TOP_K, IOU, 0.0)
    assert got.pose_valid is None
    for f in ("valid", "label", "score"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    np.testing.assert_array_max_ulp(got.box.numpy(), np.asarray(want.box), maxulp=1)
    record_property("boxes_an_ulp_apart", int((got.box.numpy() != np.asarray(want.box)).sum()))
    assert got.belief.shape == (BATCH, TOP_K, CFG.belief_depth, 4, 6)
    np.testing.assert_allclose(got.belief.numpy(), np.asarray(want.belief), rtol=0,
                               atol=BELIEF_ATOL)
    np.testing.assert_allclose(got.keypoint_score.numpy(), np.asarray(want.keypoint_score),
                               rtol=0, atol=BELIEF_ATOL)
    check_keypoints(got, want, record_property, "decode")


def test_torch_yolo_pose_pipeline_matches_jax(small, record_property):
    """Preprocess, net and decode of the port against JAX's on the same
    uint8 frames, every slot decoded."""
    want = small["dets"]
    pipe = make_yolo_pose_pipeline(small["port"], CFG, device="cpu", dtype=torch.float32,
                                   knobs=dataclasses.replace(YOLO_POSE_DECODE,
                                                             confidence_threshold=0.0))
    got = pipe(small["raw"])
    for f in ("valid", "label"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    for f in ("box", "score", "keypoint_score"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=SCORE_ATOL, err_msg=f)
    check_keypoints(got, want, record_property, "pipeline")


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("shape", [(BATCH, TOP_K * 3, 4, 4, 6), (2, 90, 16, 30, 60)],
                         ids=["small", "bench"])
def test_torch_belief_assembly_matches_pallas_and_einsum(interpret_pallas, shape):
    """[B, K*Kp, Pb] coefficients against [B, Pb, bh, bw] prototypes, no
    crop: the decode's call of kernel B (its plain version here)."""
    b, rows, p, h, w = shape
    rng = np.random.default_rng(4)
    proto_nhwc = rng.normal(size=(b, h, w, p)).astype(np.float32)
    coeff = np.tanh(rng.normal(size=(b, rows, p))).astype(np.float32)
    proto = torch.from_numpy(proto_nhwc).permute(0, 3, 1, 2)
    got = assemble_mask_batch(proto, torch.from_numpy(coeff)).numpy()
    pallas = assemble_mask_pallas(jnp.asarray(np.ascontiguousarray(proto.numpy())),
                                  jnp.asarray(coeff))
    einsum = jax.nn.sigmoid(jnp.einsum("bkp,bhwp->bkhw", jnp.asarray(coeff),
                                       jnp.asarray(proto_nhwc),
                                       preferred_element_type=jnp.float32))
    for want in (pallas, einsum):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=BELIEF_ATOL)


def planted_keypoints(n_images=2, seed=5):
    """Detections whose keypoints are the bench's object points seen by its
    camera at known poses, normalised as the decode's, with per-slot
    keypoint counts above the threshold of 9, 5, 4 and 3 (3 is too few)
    and every fifth slot not kept."""
    serve = BENCH_YOLO_POSE
    cfg, k, n_kp = serve.model, TOP_K, len(serve.object_points)
    rng = np.random.default_rng(seed)
    n = n_images * k
    obj = np.asarray(serve.object_points, np.float32)
    cam = np.asarray(serve.camera_matrix, np.float64)
    w = rng.normal(size=(n, 3)) * 0.4
    t = np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-0.1, 0.1, n),
                  rng.uniform(1.0, 3.0, n)], -1)
    with torch.inference_mode():
        r = so3_exp(torch.from_numpy(w)).numpy()
    pts = np.einsum("nij,pj->npi", r, obj.astype(np.float64)) + t[:, None]
    u = cam[0, 0] * pts[..., 0] / pts[..., 2] + cam[0, 2]
    v = cam[1, 1] * pts[..., 1] / pts[..., 2] + cam[1, 2]
    counts = np.resize([9, 5, 4, 3], n)
    score = np.where(np.arange(n_kp)[None] < counts[:, None], 0.9, 0.1)
    keep = np.arange(n) % 5 != 4
    arrays = dict(
        keypoint_y=(v / cfg.in_h).reshape(n_images, k, n_kp),
        keypoint_x=(u / cfg.in_w).reshape(n_images, k, n_kp),
        keypoint_score=score.reshape(n_images, k, n_kp),
        valid=keep.reshape(n_images, k))
    arrays = {name: a.astype(bool if name == "valid" else np.float32)
              for name, a in arrays.items()}
    truth = (r.reshape(n_images, k, 3, 3), t.reshape(n_images, k, 3), counts >= 4, keep)
    return arrays, truth


def test_torch_yolo_pose_pnp_matches_jax():
    serve = BENCH_YOLO_POSE
    arrays, (r_true, t_true, enough, keep) = planted_keypoints()
    n_images, k, n_kp = arrays["keypoint_y"].shape
    rest = dict(score=np.zeros((n_images, k), np.float32),
                label=np.ones((n_images, k), np.int32),
                box=np.zeros((n_images, k, 4), np.float32),
                belief=np.zeros((n_images, k, n_kp, 1, 1), np.float32))
    jax_cfg = JaxYoloPoseModelConfig(**dataclasses.asdict(serve.model))
    want = jax_decode.attach_pnp(
        jax_decode.YoloPoseDetections(**{n: jnp.asarray(a) for n, a in {**arrays,
                                                                       **rest}.items()}),
        jax_cfg, np.asarray(serve.object_points, np.float32),
        np.asarray(serve.camera_matrix, np.float32))
    with torch.inference_mode():
        got = attach_pnp(
            YoloPoseDetections(**{n: torch.from_numpy(a) for n, a in {**arrays,
                                                                     **rest}.items()}),
            serve.model, torch.tensor(serve.object_points), torch.tensor(serve.camera_matrix))
    valid = got.pose_valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.pose_valid))
    np.testing.assert_array_equal(valid.reshape(-1), enough & keep)
    for f, truth in (("pose_rotation", r_true), ("pose_translation", t_true)):
        g = getattr(got, f).numpy()
        np.testing.assert_allclose(g[valid], np.asarray(getattr(want, f))[valid], rtol=0,
                                   atol=POSE_ATOL, err_msg=f)
        np.testing.assert_allclose(g[valid], truth[valid], rtol=0, atol=1e-2, err_msg=f)


def test_torch_yolo_pose_bench_config_shapes():
    """``BENCH_YOLO_POSE`` at full width, batch 1, on the CPU in f32."""
    serve = BENCH_YOLO_POSE
    cfg = serve.model
    jax_model = JaxYoloPose(JaxYoloPoseModelConfig(**dataclasses.asdict(cfg)))
    img = jnp.zeros((1, cfg.in_h, cfg.in_w, 3))
    want = jax.eval_shape(lambda: jax_model.apply(
        jax_model.init(jax.random.key(0), img, train=False), img, train=False))
    port = YoloPose(cfg, torch.Generator().manual_seed(0), device="cpu", init="flax").eval()
    pipe = make_yolo_pose_pipeline(port, cfg, serve.object_points, serve.camera_matrix,
                                   device="cpu", dtype=torch.float32)
    raw = np.random.default_rng(6).integers(0, 256, (1, 480, 640, 3), np.uint8)
    with torch.inference_mode():
        pred = port(torch.zeros(1, 3, cfg.in_h, cfg.in_w))
    n = want.anchor.shape[0]
    assert n == 60 * 120 + 30 * 60 + 15 * 30 + 8 * 15 + 4 * 8 == pred.anchor.shape[0]
    for f in FIELDS:
        assert tuple(getattr(pred, f).shape) == getattr(want, f).shape, f
    for f in STAGE_FIELDS:
        assert [tuple(t.shape) for t in getattr(pred, f)] == [t.shape for t in getattr(want, f)]
    assert tuple(pred.belief_prototypes[-1].shape) == (1, 30, 60, 16)
    dets = pipe(raw)
    k = YOLO_POSE_DECODE.top_k
    assert dets.belief.shape == (1, k, 9, 30, 60)
    assert dets.pose_rotation.shape == (1, k, 3, 3) and dets.pose_translation.shape == (1, k, 3)
    for f in ("score", "box", "keypoint_y", "keypoint_x", "keypoint_score"):
        assert torch.isfinite(getattr(dets, f)).all(), f
    assert not (dets.pose_valid & ~dets.valid).any()
