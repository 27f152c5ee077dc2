"""The int8 rungs of ``bench.py --yolo-pose`` in the PyTorch port against the
JAX package: the chain-fused YOLO-Pose (``make_yolo_pose_chain_pipeline``,
the bench's ``value``) and ``--per-layer-int8`` (``quantized_call``).

``test_torch_yolo_pose.py``'s small config (96x64) and weights, seeded
uint8 frames, on the CPU.  The JAX chain and JAX ``quantized_call`` run op
by op (``jit=False``, eager), where each op rounds once, as each PyTorch
op of the port does; compiled, XLA fuses multiply-adds and casts, and an
int8 net carries a last-bit difference on to a code one apart.  Both
stacks read JAX's scales (JAX ``calibrate`` of the JAX net on the frames'
image):

- ``calibrate(paths_of=yolo_pose_flax_path)`` records JAX's key set, every
  non-transposed conv with 16 input channels or more (54 at the small
  config; at the bench's widths the 64 that the JAX net's kernels give),
  f32 values within 1e-5 relative (measured 1.2e-6), bf16 values within
  ``BF16_SCALE_RTOL``, two bf16 ulps (measured one, 7.7e-3);
- ``ChainCtx(path_of=yolo_pose_flax_path)`` finds every JAX module path,
  and ``make_yolo_pose_chain_pipeline``'s context keeps f32 joins
  (``join_dtype`` None) and the YOLO-Pose paths: on the YOLACT defaults
  (bf16 joins, ``yolact_flax_path``) it fails;
- the whole chain from JAX's stem output (``ChainRecorder``: the float
  stem is the one op the port sums in another order), f32 and bf16: all
  23 int8 maps equal, the float maps within ``FLOAT_MAP_ULPS``, every
  ``YoloPosePrediction`` field within 2e-4, and the decode at confidence
  0 slot for slot: ``valid`` and labels equal, scores, boxes and keypoint
  scores within 1e-5, the belief maps within 1e-6, keypoints equal but on
  near-tied maps (counted; measured: none moved);
- the Pointnet cascade and the head on each FPN level, layer by layer on
  the JAX chain's own FPN maps: every map equal as above and the outputs
  equal (the head's tanh'd f32 outputs within ``TANH_RTOL``);
- the unaltered chain pipeline, stem and preprocess included, in bf16
  against JAX's op by op on the same frames and scales: its decode no
  further from JAX's than JAX's compiled pipeline is (``PIPELINE_SPREAD``;
  measured: the port's decode equal to JAX's op-by-op one);
- ``quantized_call`` on the bf16 net: each calibrated conv, given JAX's
  input, bit-equal to JAX's ``_quantized_conv``, and each field of the
  forward within JAX's own compiled-vs-op-by-op spread
  (``QUANTIZED_SPREAD``); and the same on ``SMALL_YOLACT``'s widths, on
  ``quantized_call``'s default paths (``yolact_flax_path``;
  ``YOLACT_SPREAD``), run at the YOLO-Pose's 96x64 so that its JAX ops,
  compiled once a shape, are mostly shared.

The spreads are stated, not measured in each run (a compiled JAX run
takes seconds to compile); ``python tests/test_torch_yolo_pose_int8.py``
measures them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.configs.yolo_pose import YoloPoseModelConfig as JaxYoloPoseModelConfig
from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu.models.yolo_pose import YoloPose as JaxYoloPose
from tauv_vision_tpu.ops.image import preprocess as jax_preprocess
from tauv_vision_tpu.serving import quantize as jax_quantize
from tauv_vision_tpu.serving import quantize_chain as jax_chain
from tauv_vision_tpu.serving import yolo_pose_decode as jax_decode
from tauv_vision_tpu.serving.pipeline import IMAGENET_MEAN, IMAGENET_STDDEV
from tauv_vision_tpu_torch.configs import BENCH_YOLO_POSE, YolactModelConfig
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.models.yolo_pose import HEAD_OUTPUTS, YoloPose
from tauv_vision_tpu_torch.serving import quantize_chain as port_chain
from tauv_vision_tpu_torch.serving.pipeline import YoloPoseKnobs
from tauv_vision_tpu_torch.serving.quantize import _QuantizedConv, calibrate, quantized_call
from tauv_vision_tpu_torch.serving.yolo_pose_decode import decode_yolo_pose
from tauv_vision_tpu_torch.weights import (
    yolact_flax_path,
    yolact_state_dict_from_flax,
    yolo_pose_flax_path,
)
from test_torch_yolo_pose import (
    CFG,
    FIELDS,
    IOU,
    JAX_CFG,
    STAGE_FIELDS,
    TOP_K,
    check_keypoints,
    frames,
    yolo_pose_pair,
)
from test_torch_yolo_pose_bf16 import _decode_distance, _rel_l2
from torch_parity import (
    SMALL_YOLACT,
    ChainRecorder,
    jax_yolact_config,
    random_variables,
    torch_threads,
    yolact_pair,
)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
RAW_ATOL = 2e-4
SCORE_ATOL = 1e-5
BELIEF_ATOL = 1e-6
# A bf16 net's conv inputs are bf16 numbers: a conv that rounds one output
# apart moves an absmax by a bf16 ulp (2^-7 relative at the most); two.
BF16_SCALE_RTOL = 2.0 ** -6
# f32 tanh: torch's and XLA's each within an ulp or two of the true value
# (measured 2.4e-7 relative), so the head's f32 mask, belief and affinity
# coefficients agree to a few ulps; bf16 rounds both alike.
TANH_OUTPUTS = ("mask", "belief", "affinity")
TANH_RTOL = 5e-7
ALL_SLOTS = YoloPoseKnobs(top_k=TOP_K, iou_threshold=IOU, confidence_threshold=0.0)
STEM = "backbone/conv1"
# A float map of an uncalibrated conv with an f32 BatchNorm (the head's
# bottleneck conv3, 4 input channels at the small config) against XLA's
# rsqrt, which is not correctly rounded: within 4 f32 ulps of the map's
# largest value.
FLOAT_MAP_ULPS = 2.0 ** -21


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _nchw(a) -> torch.Tensor:
    """A JAX NHWC array as a contiguous NCHW f32 tensor."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).permute(
        0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def nets():
    return _nets()


def _nets():
    """{dtype: (JAX model, variables, port, JAX image of the frames, JAX
    scales)}: the f32 and bf16 nets on the same weights, each calibrated
    by JAX on its own image."""
    raw = frames(1)
    out = {}
    for name, (jax_dtype, torch_dtype) in DTYPES.items():
        jax_model, variables, port = yolo_pose_pair(torch_dtype, 0)
        img = jax_preprocess(jnp.asarray(raw), (CFG.in_h, CFG.in_w), IMAGENET_MEAN,
                             IMAGENET_STDDEV, dtype=jax_dtype)
        scales = jax_quantize.calibrate(
            lambda b: jax_model.apply(variables, b, train=False), [img])
        out[name] = (jax_model, variables, port, img, scales)
    return out


def _flax_modules(tree, prefix=()):
    if any(not isinstance(v, dict) for v in tree.values()):
        yield "/".join(prefix)
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_modules(v, prefix + (k,))


def _calibrated_paths(variables):
    """The paths JAX ``calibrate`` records, from the weights alone: every
    conv kernel with 16 input channels or more but the protonet's
    transposed convs."""
    out = set()
    for path in _flax_modules(variables["params"]):
        node = variables["params"]
        for k in path.split("/"):
            node = node[k]
        kernel = node.get("kernel")
        if kernel is not None and kernel.shape[2] >= 16 and "upsample" not in path:
            out.add(path)
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_yolo_pose_calibrate_matches_jax(nets, dtype, record_property):
    _, variables, port, img, want = nets[dtype]
    got = calibrate(port, [_nchw(img)], paths_of=yolo_pose_flax_path)
    assert set(got) == set(want) == _calibrated_paths(variables) and len(got) == 54
    rtol = 1e-5 if dtype == "f32" else BF16_SCALE_RTOL
    worst = max(abs(got[p] / want[p] - 1) for p in want)
    record_property("max_rel_err", worst)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, rtol=rtol, atol=0, err_msg=path)


def test_torch_yolo_pose_calibrate_bench_widths():
    """At ``BENCH_YOLO_POSE``'s widths (a 64x96 input on the CPU) the port
    records the 64 convs the JAX net's kernels give."""
    cfg = BENCH_YOLO_POSE.model
    jax_model = JaxYoloPose(JaxYoloPoseModelConfig(**dataclasses.asdict(cfg)))
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.key(0), jnp.zeros((1, 64, 96, 3)), train=False))
    port = YoloPose(cfg, torch.Generator().manual_seed(0), device="cpu",
                    dtype=BENCH_YOLO_POSE.dtype, init="flax").eval()
    img = torch.randn(1, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    got = calibrate(port, [img.to(BENCH_YOLO_POSE.input_dtype)], paths_of=yolo_pose_flax_path)
    assert set(got) == _calibrated_paths(shapes) and len(got) == 64


def test_torch_yolo_pose_chain_ctx_paths(nets, monkeypatch):
    """The chain pipeline's context reads every JAX module by its path and
    keeps f32 joins; a context on the YOLACT defaults cannot read a
    YOLO-Pose."""
    _, variables, port, _, scales = nets["bf16"]
    made = []

    class Recording(port_chain.ChainCtx):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(port_chain, "ChainCtx", Recording)
    port_chain.make_yolo_pose_chain_pipeline(port, scales, device="cpu")
    (ctx,) = made
    assert set(ctx.modules) == set(_flax_modules(variables["params"]))
    assert ctx.join_dtype is None and ctx.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="YOLACT"):
        port_chain.ChainCtx(port, scales)


def test_torch_yolo_pose_chain_refuses_other_models(nets):
    _, _, port, _, scales = nets["f32"]
    yolact = yolact_pair(YolactModelConfig(**SMALL_YOLACT), 0)[3]
    with pytest.raises(TypeError, match="YoloPose"):
        port_chain.yolo_pose_chain_forward(port_chain.ChainCtx(yolact, {}))
    cfg = dataclasses.replace(CFG)
    object.__setattr__(cfg, "backbone_depth", 50)
    model = YoloPose(CFG, device="cpu")
    model.config = cfg
    with pytest.raises(NotImplementedError, match="ResNet-18"):
        port_chain.yolo_pose_chain_forward(port_chain.ChainCtx(
            model, scales, path_of=yolo_pose_flax_path))


@pytest.fixture(scope="module")
def chains(nets):
    """{dtype: (recorder maps and stems, JAX chain prediction, port chain
    prediction)}: both chains from JAX's stem output, f32 joins."""
    out = {}
    for name, (jax_dtype, torch_dtype) in DTYPES.items():
        _, variables, port, img, scales = nets[name]
        with ChainRecorder(jax_chain, port_chain, STEM) as rec:
            want = jax_chain.yolo_pose_chain_forward(JAX_CFG, variables, scales,
                                                     dtype=jax_dtype)(img)
            got = port_chain.yolo_pose_chain_forward(port_chain.ChainCtx(
                port, scales, dtype=torch_dtype, join_dtype=None, impl="plain",
                path_of=yolo_pose_flax_path))(_nchw(img))
        out[name] = (rec, want, got)
    return out


def check_maps(maps, record_property):
    """Every int8 map equal, every float map within ``FLOAT_MAP_ULPS`` of
    its largest value; returns the int8 maps' count."""
    assert maps["port"].keys() == maps["jax"].keys()
    n_int8, float_err = 0, 0.0
    for path, g in maps["port"].items():
        w = maps["jax"][path]
        assert g.dtype == w.dtype, path
        if g.dtype == np.int8:
            n_int8 += 1
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_MAP_ULPS * np.abs(w).max(),
                                       err_msg=path)
            float_err = max(float_err, float(np.abs(g - w).max()))
    record_property("int8_maps", n_int8)
    record_property("float_maps_max_abs_err", float_err)
    return n_int8


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_yolo_pose_chain_matches_jax(chains, dtype, record_property):
    rec, want, got = chains[dtype]
    # 8 ResNet blocks' conv1 -> conv2 links, the two bf16 transposes and
    # post_0 (their next convs are calibrated), and 3 links in each of the
    # 4 Pointnet branch-stages.
    assert check_maps(rec.maps, record_property) == 23
    for field in FIELDS + STAGE_FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        pairs = zip(g, w) if field in STAGE_FIELDS else [(g, w)]
        for gi, wi in pairs:
            assert gi.dtype == torch.float32 and tuple(gi.shape) == wi.shape, field
            np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0, atol=RAW_ATOL,
                                       err_msg=field)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_yolo_pose_chain_decode_matches_jax(chains, dtype, record_property):
    _, want_pred, got_pred = chains[dtype]
    want = jax_decode.decode_yolo_pose(want_pred, JAX_CFG, TOP_K, IOU, 0.0)
    got = decode_yolo_pose(got_pred, CFG, TOP_K, IOU, 0.0, impl="plain")
    for f in ("valid", "label"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    for f, atol in (("score", SCORE_ATOL), ("box", SCORE_ATOL),
                    ("keypoint_score", SCORE_ATOL), ("belief", BELIEF_ATOL)):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=atol, err_msg=f)
    check_keypoints(got, want, record_property, f"chain_{dtype}")


def _layer_maps(nets, chains, dtype, jax_fn, port_fn):
    """Run ``jax_fn(ctx)`` and ``port_fn(ctx)`` under a recorder: (maps, JAX
    outputs, port outputs)."""
    jax_dtype, torch_dtype = DTYPES[dtype]
    _, variables, port, _, scales = nets[dtype]
    with ChainRecorder(jax_chain, port_chain, STEM) as rec, torch.inference_mode():
        want = jax_fn(jax_chain.ChainCtx(variables, scales, dtype=jax_dtype))
        got = port_fn(port_chain.ChainCtx(port, scales, dtype=torch_dtype, join_dtype=None,
                                          impl="plain", path_of=yolo_pose_flax_path))
    check_maps(rec.maps, lambda *_: None)
    return rec.maps, want, got


def _fpn_map(chains, dtype, level):
    """The JAX chain's FPN output ``level`` as (JAX array, port tensor)."""
    jax_dtype, torch_dtype = DTYPES[dtype]
    m = chains[dtype][0].maps["jax"][f"fpn/prediction_{level}" if level < 3
                                     else f"fpn/downsample_{level - 3}"]
    return jnp.asarray(m).astype(jax_dtype), torch.from_numpy(np.array(m)).to(torch_dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_yolo_pose_pointnet_chain_matches_jax(nets, chains, dtype):
    fpn1, fpn1_t = _fpn_map(chains, dtype, 1)
    layers = CFG.pointnet_layers
    maps, want, got = _layer_maps(
        nets, chains, dtype, lambda ctx: jax_chain._pointnet_chain(ctx, fpn1, layers),
        lambda ctx: port_chain._pointnet_chain(ctx, fpn1_t, layers))
    # Each branch's count - 1 k x k convs, reduce and out: all but out emit int8.
    assert sum(m.dtype == np.int8 for m in maps["port"].values()) == 2 * sum(
        count for _, count, _ in layers)
    for w, g in zip(want, got):
        for ws, gs in zip(w, g):
            assert gs.dtype == torch.float32 and gs.is_contiguous()
            np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("level", range(5))
def test_torch_yolo_pose_head_chain_matches_jax(nets, chains, dtype, level):
    fpn, fpn_t = _fpn_map(chains, dtype, level)
    shapes = nets[dtype][2].prediction_head.shapes
    _, want, got = _layer_maps(
        nets, chains, dtype, lambda ctx: jax_chain._yolo_pose_head_chain(ctx, fpn, JAX_CFG),
        lambda ctx: port_chain._yolo_pose_head_chain(ctx, fpn_t, CFG.n_prediction_head_layers,
                                                     shapes))
    for name, w, g in zip(HEAD_OUTPUTS, want, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        w = np.asarray(w)
        if dtype == "f32" and name in TANH_OUTPUTS:
            np.testing.assert_allclose(g.numpy(), w, rtol=TANH_RTOL, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)




# JAX's own spread, its compiled run (``jax.jit``, the weights as arguments)
# against the same function op by op, on this module's seeds; printed by
# ``python tests/test_torch_yolo_pose_int8.py``.  The served chain
# pipeline's decode at confidence 0 (``test_torch_yolo_pose_bf16``'s
# distance: slots whose validity, label or box differ, keypoints that
# differ, the largest score difference), of 40 slots and 120 keypoints:
PIPELINE_SPREAD = (37, 58, 0.0329)
# ``quantized_call``'s bf16 forward, each field's relative L2 distance
# (rounded up in the third digit):
QUANTIZED_SPREAD = {
    "classification": 0.0450, "box_encoding": 0.0291, "mask_coeff": 0.0580,
    "belief_coeff": 0.0438, "affinity_coeff": 0.0549, "mask_prototype": 0.0260,
    "belief_prototypes/0": 0.0398, "belief_prototypes/1": 0.0421,
    "affinity_prototypes/0": 0.0367, "affinity_prototypes/1": 0.0466,
}
# and on the YOLACT's widths:
YOLACT_SPREAD = {"classification": 0.0896, "box_encoding": 0.0459, "mask_coeff": 0.0510,
                 "mask_prototype": 0.0383}
YOLACT_FIELDS = ("classification", "box_encoding", "mask_coeff", "mask_prototype")


def _chain_pipeline(v, x, scales):
    """JAX's served chain pipeline (bf16, no PnP) at every slot, op by op."""
    return jax_chain.make_yolo_pose_chain_pipeline(
        JAX_CFG, v, scales, top_k=TOP_K, iou_threshold=IOU, confidence_threshold=0.0,
        dtype=jnp.bfloat16, jit=False)(x)


def test_torch_yolo_pose_chain_pipeline_matches_jax(nets, record_property):
    """The served bf16 chain pipeline, unaltered (the port's own stem and
    preprocess), against JAX's op by op on the same frames and scales,
    every slot decoded: no further from it than JAX's compiled pipeline
    (``PIPELINE_SPREAD``)."""
    _, variables, port, _, scales = nets["bf16"]
    want = _chain_pipeline(variables, jnp.asarray(frames(1)), scales)
    got = port_chain.make_yolo_pose_chain_pipeline(port, scales, device="cpu", knobs=ALL_SLOTS,
                                                   impl="plain")(frames(1))
    err = _decode_distance(got, want)
    record_property("port", str(err))
    assert got.belief.shape == want.belief.shape
    for name, e, bar in zip(("slots", "keypoints", "score"), err, PIPELINE_SPREAD):
        assert e <= bar, (name, err, PIPELINE_SPREAD)


class QuantizedConvRecorder:
    """Inside the ``with``, every JAX ``_quantized_conv`` call's (path, input,
    output) is kept, in call order."""

    def __enter__(self):
        self.calls, self._saved = [], jax_quantize._quantized_conv

        def record(module, x, act_scale):
            y = self._saved(module, x, act_scale)
            self.calls.append(("/".join(module.path), x, y))
            return y

        jax_quantize._quantized_conv = record
        return self

    def __exit__(self, *exc):
        jax_quantize._quantized_conv = self._saved


def _jax_quantized(jax_model, variables, scales, img):
    """(JAX ``quantized_call``'s forward op by op, its convs' calls)."""
    with QuantizedConvRecorder() as rec:
        out = jax_quantize.quantized_call(
            lambda b: jax_model.apply(variables, b, train=False), scales)(img)
    return out, rec.calls


@pytest.fixture(scope="module")
def quantized(nets):
    """JAX ``quantized_call`` on the bf16 net, op by op: (its forward, its
    convs' calls)."""
    jax_model, variables, _, img, scales = nets["bf16"]
    return _jax_quantized(jax_model, variables, scales, img)


def _check_quantized_convs(calls, port, scales, path_of):
    """Each recorded JAX call against the port's quantized conv of that
    path on the same input: bit-equal, in the same dtype."""
    convs = {path_of(name): m for name, m in port.named_modules()
             if isinstance(m, torch.nn.Conv2d)}
    assert {path for path, _, _ in calls} == set(scales)
    for path, x, y in calls:
        dtype = torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32
        with torch.inference_mode():
            got = _QuantizedConv(convs[path], scales[path])(_nchw(x).to(dtype))
        want = np.asarray(jnp.asarray(y).astype(jnp.float32))
        assert got.dtype == (torch.bfloat16 if y.dtype == jnp.bfloat16 else torch.float32), path
        np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want,
                                      err_msg=path)


def test_torch_yolo_pose_quantized_convs_match_jax(nets, quantized):
    """Every calibrated conv of JAX's ``quantized_call`` forward on the bf16
    net, given its input there (bf16, or the f32 BatchNorm outputs),
    bit-equal to the port's."""
    _check_quantized_convs(quantized[1], nets["bf16"][2], nets["bf16"][4], yolo_pose_flax_path)


def _fields(pred, names):
    """A prediction's fields as {name: f32 numpy}, stages one by one."""
    out = {}
    for f in names:
        value = getattr(pred, f)
        for i, v in enumerate(value) if f in STAGE_FIELDS else [(None, value)]:
            v = v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(
                jnp.asarray(v).astype(jnp.float32))
            out[f if i is None else f"{f}/{i}"] = v
    return out


def _check_within(got, want, spread, record_property):
    for name, w in want.items():
        err = _rel_l2(got[name], w)
        record_property(f"{name}_rel_l2", err)
        assert err <= spread[name], (name, err, spread[name])


def test_torch_yolo_pose_quantized_call_matches_jax(nets, quantized, record_property):
    """``--per-layer-int8``: the bf16 net with its calibrated convs in int8,
    each field within JAX's own spread (``QUANTIZED_SPREAD``); the swap of
    the convs' forwards lasts the call only."""
    _, _, port, img, scales = nets["bf16"]
    with torch.inference_mode():
        got = quantized_call(port, scales, paths_of=yolo_pose_flax_path)(_nchw(img))
    assert all("forward" not in vars(m) for m in port.modules())
    fields = tuple(f for f in FIELDS if f != "anchor") + STAGE_FIELDS
    _check_within(_fields(got, fields), _fields(quantized[0], fields),
                  QUANTIZED_SPREAD, record_property)


def _yolact(img):
    """(JAX model, variables, port, JAX scales) of ``SMALL_YOLACT``'s widths
    at the YOLO-Pose's input size, bf16."""
    cfg = YolactModelConfig(**{**SMALL_YOLACT, "in_w": CFG.in_w, "in_h": CFG.in_h})
    jax_cfg = jax_yolact_config(cfg)
    jax_model = JaxYolact(jax_cfg, dtype=jnp.bfloat16)
    variables = random_variables(jax_model, (1, cfg.in_h, cfg.in_w, 3), 0)
    port = Yolact(cfg, device="cpu", dtype=torch.bfloat16).eval()
    port.load_state_dict(yolact_state_dict_from_flax(variables))
    scales = jax_quantize.calibrate(lambda b: jax_model.apply(variables, b, train=False), [img])
    return jax_model, variables, port, scales


def test_torch_quantized_call_yolact_matches_jax(nets, record_property):
    """``quantized_call`` on a second model, on its default paths
    (``yolact_flax_path``): every conv bit-equal, each field within JAX's
    spread (``YOLACT_SPREAD``)."""
    img = nets["bf16"][3]
    jax_model, variables, port, scales = _yolact(img)
    want, calls = _jax_quantized(jax_model, variables, scales, img)
    _check_quantized_convs(calls, port, scales, yolact_flax_path)
    with torch.inference_mode():
        got = quantized_call(port, scales)(_nchw(img))
    _check_within(_fields(got, YOLACT_FIELDS), _fields(want, YOLACT_FIELDS), YOLACT_SPREAD,
                  record_property)


def jax_spreads():
    """Measure the stated spreads: JAX's compiled runs against op by op."""
    raw = jnp.asarray(frames(1))
    jax_model, variables, _, img, scales = _nets()["bf16"]
    want = _chain_pipeline(variables, raw, scales)
    compiled = jax.jit(lambda v, x: _chain_pipeline(v, x, scales))(variables, raw)
    print("PIPELINE_SPREAD", _decode_distance(compiled, want))
    fields = tuple(f for f in FIELDS if f != "anchor") + STAGE_FIELDS
    yolact_model, yolact_variables, _, yolact_scales = _yolact(img)
    for tag, model, v, sc, names in (
            ("QUANTIZED_SPREAD", jax_model, variables, scales, fields),
            ("YOLACT_SPREAD", yolact_model, yolact_variables, yolact_scales, YOLACT_FIELDS)):
        def forward(v, x, model=model, sc=sc):
            return jax_quantize.quantized_call(lambda b: model.apply(v, b, train=False), sc)(x)
        want = _fields(forward(v, img), names)
        compiled = _fields(jax.jit(forward)(v, img), names)
        print(tag, {n: float(_rel_l2(compiled[n], w)) for n, w in want.items()})


if __name__ == "__main__":
    jax_spreads()
