"""The custom-DLA CenterNet (``models/dla.py``, ``models/centernet.py``)
in the PyTorch port against the JAX package's, on the CPU.

The JAX model's weights are drawn with numpy
(``torch_parity.random_variables``) and carried over by
``weights.centernet_state_dict_from_flax``; inputs are seeded numpy.  At
JAX's test widths (``tests/test_models.py``: heights (1, 1), channels
(8, 8, 16), 2 downsamples) with every head (the squares' object config
with roll, pitch and depth trained), in f32:

- ``pad_to_match`` equal to JAX's (a pad, then a top-left crop);
- ``DLABackbone`` and the raw heads within 2e-4 at 64x96 and at 92x160,
  whose level 0 is 23x40: every upsample into levels 0 and 1 overshoots
  and is cropped; and the heads of a net of three trees at 88x96, where
  the reverse IDA's x4 upsample overshoots level 0 by two rows (the
  reference DLA-34's matcher would shift it);
- a height-2 tree with a one-level ``IDAUpReverse`` (which returns its
  level unchanged) within 2e-4;
- the weight map flax -> port -> flax bit for bit over every leaf,
  ``batch_stats`` included, at these widths and at ``samples_torpedo``'s
  (its shapes by ``jax.eval_shape``: 20,961,428 parameters, each flax
  leaf mapped once), and the flax path of every port module;
- ``make_centernet_pipeline`` and ``make_centernet_keypoint_pipeline``
  on uint8 frames against JAX's compiled pipelines, every slot decoded:
  100% matched with every p95 <= 1e-5 (``decoded_pair_deltas``), the
  keypoint slots claimed alike and placed within 1e-5; ``CenternetServer`` against JAX's on the JAX
  test's net (``tests/test_serving_nodes_utils.py``: one level, 64x64);
- one ``make_centernet_train_step`` against JAX's loss, gradients and
  batch statistics, each within the larger of a bar and YARDSTICK times
  the port's own move when the input is scaled by 1 + 1e-6;
- per-layer int8 (``calibrate`` + ``quantized_call``, JAX's run op by
  op): the same calibrated paths (the transposed convs in neither), the
  scales within f32 rounding, every quantized conv bit-equal on JAX's
  input, and the heads within JAX's own compiled-vs-op-by-op spread
  (``INT8_SPREAD``, printed by ``python tests/test_torch_dla.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.centernet import Centernet as JaxCenternet
from tauv_vision_tpu.models.dla import DLABackbone as JaxDLABackbone
from tauv_vision_tpu.models.dla import pad_to_match as jax_pad_to_match
from tauv_vision_tpu.ops.image import preprocess as jax_preprocess
from tauv_vision_tpu.serving import nodes as jax_nodes
from tauv_vision_tpu.serving import pipeline as jax_pipeline
from tauv_vision_tpu.serving import quantize as jax_quantize
from tauv_vision_tpu.train.centernet_task import CenternetTruth as JaxTruth
from tauv_vision_tpu.train.centernet_task import centernet_loss as jax_centernet_loss
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import (
    AngleConfig,
    ObjectConfig,
    ObjectConfigSet,
    samples_torpedo,
)
from tauv_vision_tpu_torch.data.synthetic import SquareDatasetConfig, generate_square_batch
from tauv_vision_tpu_torch.models.centernet import Centernet
from tauv_vision_tpu_torch.models.dla import pad_to_match
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.nodes import CenternetServer
from tauv_vision_tpu_torch.serving.pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STDDEV,
    DecodeKnobs,
    make_centernet_keypoint_pipeline,
    make_centernet_pipeline,
)
from tauv_vision_tpu_torch.serving.quantize import _QuantizedConv, calibrate, quantized_call
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import make_centernet_train_step
from tauv_vision_tpu_torch.weights import (
    centernet_flax_from_state_dict,
    centernet_flax_path,
    centernet_state_dict_from_flax,
)
from test_torch_keypoints import _assert_published_equal, _serve_both
from torch_parity import (
    PREDICTION_FIELDS,
    jax_centernet_config,
    jax_object_config,
    jax_train_config,
    random_variables,
    square_configs,
    torch_threads,
)

H, W = 64, 96
ODD = (92, 160)            # level 0 23x40: upsamples into levels 0 and 1 are cropped
DEEP = (88, 96)            # level 0 22x24, level 2 6x6: its x4 upsample is cropped by 2
HEIGHTS, CHANNELS = (1, 1), (8, 8, 16)
HEADS_ATOL = 2e-4
DECODE_P95 = 1e-5
ALL_SLOTS = DecodeKnobs(score_threshold=0.0, keypoint_score_threshold=0.0)
PROJECTION = ((100.0, 0.0, 48.0, 0.0), (0.0, 100.0, 32.0, 0.0), (0.0, 0.0, 1.0, 0.0))
TORPEDO_PARAMETERS = 20_961_428

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATS_TOL = 1e-5
YARDSTICK = 4.0
NUDGE = 1 + 1e-6

# JAX's own spread of the per-layer int8 heads: its compiled
# ``quantized_call`` against the same function op by op, the largest of the
# fields' relative L2 distances on this module's net and frames (the depth
# head's, 1.134e-3, rounded up in the second digit; the others below 2e-7;
# ``python tests/test_torch_dla.py`` prints it).
INT8_SPREAD = 1.2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _configs(in_h=H, in_w=W, heights=HEIGHTS, channels=CHANNELS):
    oc, mc = square_configs(in_h, in_w, all_terms=True)
    return oc, dataclasses.replace(mc, backbone_heights=heights, backbone_channels=channels)


def _pair(oc, mc, seed=0):
    """(JAX Centernet, numpy variables, port Centernet on the CPU in f32
    with the same weights, eval mode)."""
    jax_model = JaxCenternet(object_config=jax_object_config(oc),
                             backbone_heights=mc.backbone_heights,
                             backbone_channels=mc.backbone_channels, downsamples=mc.downsamples)
    variables = random_variables(jax_model, (1, mc.in_h, mc.in_w, 3), seed)
    port = Centernet(oc, mc.backbone_heights, mc.backbone_channels, mc.downsamples,
                     device="cpu").eval()
    port.load_state_dict(centernet_state_dict_from_flax(variables), strict=True)
    return jax_model, variables, port


@pytest.fixture(scope="module")
def small():
    oc, mc = _configs()
    return (oc, mc) + _pair(oc, mc)


def _images(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    # Contiguous, as the trainer hands images on: with a channels-last view
    # torch's CPU training step of this net aborts on a heap corruption.
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2).contiguous()


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_heads_close(got, want, atol=HEADS_ATOL):
    for name in PREDICTION_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert tuple(g.shape) == tuple(w.shape), name
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("target", [(23, 40), (45, 80), (8, 9), (6, 8), (24, 40)])
def test_torch_dla_pad_to_match_is_jax(target):
    x = _images((1, 24, 40, 3))
    want = jax_pad_to_match(jnp.asarray(x), target)
    got = pad_to_match(_nchw(x), target)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


@pytest.mark.parametrize("hw", [(H, W), ODD], ids=["64x96", "92x160"])
def test_torch_dla_backbone_matches_jax(small, hw):
    *_, variables, port = small
    x = _images((2, *hw, 3))
    jax_backbone = JaxDLABackbone(heights=HEIGHTS, channels=CHANNELS, downsamples=2)
    sub = {c: variables[c]["DLABackbone_0"] for c in ("params", "batch_stats")}
    want = jax.jit(lambda v, x: jax_backbone.apply(v, x))(sub, jnp.asarray(x))
    with torch.inference_mode():
        got = port.backbone(_nchw(x))
    assert got.shape == (2, CHANNELS[0], hw[0] // 4, hw[1] // 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=0,
                               atol=HEADS_ATOL)


@pytest.fixture(scope="module")
def deep():
    """Three trees: the reverse IDA upsamples level 2 by 4, which at DEEP
    overshoots level 0 by 2 rows (24 into 22, as 23 x 4 into 90 at
    ``samples_torpedo``'s 360x640), where the reference DLA-34's matcher
    would shift the map down."""
    oc, mc = _configs(*DEEP, (1, 1, 1), (8, 8, 8, 16))
    return (oc, mc) + _pair(oc, mc, seed=7)


@pytest.mark.parametrize("which,hw", [("small", (H, W)), ("small", ODD), ("deep", DEEP)],
                         ids=["64x96", "92x160", "deep_88x96"])
def test_torch_centernet_heads_match_jax(small, deep, which, hw):
    *_, jax_model, variables, port = small if which == "small" else deep
    x = _images((2, *hw, 3))
    want = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = port(_nchw(x))
    assert got.keypoint_affinity.shape == (2, hw[0] // 4, hw[1] // 4, 4, 2)
    assert got.depth is not None and got.roll_bin is not None
    _assert_heads_close(got, want)


@pytest.fixture(scope="module")
def tall():
    """A height-2 tree over one level: ``IDAUpReverse`` gets one level."""
    oc = ObjectConfigSet(configs=(ObjectConfig(
        id="gate", yaw=AngleConfig(train=False, modulo=None),
        pitch=AngleConfig(train=False, modulo=None), roll=AngleConfig(train=False, modulo=None),
        train_depth=False, train_keypoints=True,
        keypoints=((0, 0, 0), (1, 0, 0), (0, 1, 0))),))
    _, mc = _configs(64, 64, (2,), (8, 8))
    return (oc, mc) + _pair(oc, mc, seed=2)


def test_torch_dla_height2_tree_and_one_level_reverse(tall):
    *_, jax_model, variables, port = tall
    tree = port.backbone.down.trees[0]
    assert tree.tree2.root.conv.in_channels == 3 * 8 and tree.tree1.root.conv.in_channels == 16
    assert not list(port.backbone.ida_reverse.parameters())
    assert "IDAUpReverse_0" not in variables["params"]["DLABackbone_0"]
    x = _images((2, 64, 64, 3), seed=3)
    want = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = port(_nchw(x))
    assert got.keypoint_heatmap.shape == (2, 16, 16, 3)
    _assert_heads_close(got, want)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _torpedo_variables():
    """``samples_torpedo``'s Centernet: numpy weights in the shapes of JAX's
    init (``jax.eval_shape``), and the port model at that width."""
    mc, oc = samples_torpedo.model_config, samples_torpedo.object_config
    return _pair(oc, dataclasses.replace(mc, in_h=64, in_w=64))[1:]


@pytest.mark.parametrize("which", ["small", "tall", "samples_torpedo"])
def test_torch_centernet_weights_round_trip(small, tall, which):
    """flax -> port -> flax bit for bit, every leaf mapped to one port
    tensor; every port module's flax path leads back to its name."""
    if which == "samples_torpedo":
        variables, port = _torpedo_variables()
        assert sum(p.numel() for p in port.parameters()) == TORPEDO_PARAMETERS
    else:
        *_, variables, port = small if which == "small" else tall
    state = port.state_dict()
    flax_leaves = dict(_leaves(variables))
    assert len(flax_leaves) == sum(not k.endswith("num_batches_tracked") for k in state)
    back = centernet_flax_from_state_dict(state)
    assert set(dict(_leaves(back))) == set(flax_leaves)
    for path, value in _leaves(back):
        want = flax_leaves[path]
        assert value.dtype == want.dtype and np.array_equal(value, want), path
    # The map is a bijection on module names.
    names = [n for n, m in port.named_modules() if list(m.parameters(recurse=False))]
    paths = {centernet_flax_path(n) for n in names}
    assert len(paths) == len(names) and paths == {"/".join(p[1:-1]) for p in flax_leaves}


def test_torch_centernet_ida_upsample_is_flipped(small):
    """The IDA upsamples' kernels are flax's flipped in space: without the
    flip the port's upsample differs from flax's ``ConvTranspose``."""
    *_, variables, port = small
    kernel = variables["params"]["DLABackbone_0"]["IDAUpReverse_0"]["ConvTranspose_0"]["kernel"]
    up = port.backbone.ida_reverse.up[0]
    assert torch.equal(up.weight, torch.from_numpy(np.ascontiguousarray(
        np.transpose(kernel[::-1, ::-1], (2, 3, 0, 1)))))
    assert not torch.equal(up.weight, torch.from_numpy(np.transpose(kernel, (2, 3, 0, 1))))


def test_torch_centernet_init_is_jax(small):
    """The JAX model's initialisers from an explicit generator: the same
    seed draws the same weights; head kernels xavier-uniform, biases zero
    but the heatmap heads' -2.19 (mean sigmoid near 0.1, as JAX's own test
    has it); trunk convs LeCun (truncated) normal."""
    oc, mc = small[:2]

    def build(seed):
        return Centernet(oc, HEIGHTS, CHANNELS, 2, torch.Generator().manual_seed(seed),
                         device="cpu")

    a, b, c = build(0), build(0), build(1)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert not torch.equal(a.heatmap.conv.weight, c.heatmap.conv.weight)
    for name in a.head_names:
        head = getattr(a, name)
        bias = -2.19 if name in ("heatmap", "keypoint_heatmap") else 0.0
        assert torch.all(head.out.bias == bias) and not head.conv.bias.any(), name
        for conv in (head.conv, head.out):
            fan_in, fan_out = conv.weight[0].numel(), conv.weight[:, 0].numel()
            assert conv.weight.abs().max() <= np.sqrt(6 / (fan_in + fan_out)), name
    stem = a.backbone.down.stem.conv.weight.detach()
    assert abs(float(stem.std()) - 1 / np.sqrt(stem[0].numel())) < 0.2 / np.sqrt(stem[0].numel())
    with torch.inference_mode():
        p = torch.sigmoid(a.eval()(torch.zeros(1, 3, H, W)).heatmap)
    assert 0.02 < float(p.mean()) < 0.3


def _frames(mc, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (2, mc.in_h + 16, mc.in_w + 16, 3),
                                                np.uint8)


def _assert_decodes_match(got, want):
    stats = detection_deltas(want, got, score_threshold=0.0)
    assert stats["total"] == got.valid.numel() and stats["matched_fraction"] == 1.0, stats
    for what in ("center", "score", "size"):
        assert stats[f"{what}_delta_p95"] <= DECODE_P95, stats


def test_torch_centernet_pipeline_matches_jax(small):
    """``make_centernet_pipeline`` at 92x160 (cropping levels), f32."""
    oc, _, jax_model, variables, port = small
    _, mc = _configs(*ODD)
    frames = _frames(mc)
    want = jax_pipeline.make_centernet_pipeline(
        jax_model, jax_centernet_config(mc), ALL_SLOTS.n_detections, 0.0,
        dtype=jnp.float32)(variables, jnp.asarray(frames))
    before = dict(kernels.LAUNCHES)
    got = make_centernet_pipeline(port, mc, "cpu", knobs=ALL_SLOTS, impl="plain")(frames)
    assert kernels.LAUNCHES == before
    _assert_decodes_match(got, want)
    assert got.yaw.shape == (2, ALL_SLOTS.n_detections) and got.depth is not None


def test_torch_centernet_keypoint_pipeline_matches_jax():
    """``make_centernet_keypoint_pipeline`` on ``samples_torpedo``'s heads
    (4 classes, one keypoint each) at the small widths, f32."""
    oc = samples_torpedo.object_config
    mc = dataclasses.replace(samples_torpedo.model_config, in_h=H, in_w=W,
                             backbone_heights=HEIGHTS, backbone_channels=CHANNELS)
    jax_model, variables, port = _pair(oc, mc, seed=4)
    frames = _frames(mc, seed=1)
    # A random net's channels differ in their mean logit, and the top peaks
    # come from one or two of them: shift each heatmap channel's bias by
    # its mean on these frames, so that every class detects and every
    # keypoint channel peaks, and the matcher has work.
    img = _nchw(jax_preprocess(jnp.asarray(frames), (mc.in_h, mc.in_w), IMAGENET_MEAN,
                               IMAGENET_STDDEV, dtype=jnp.float32))
    with torch.inference_mode():
        pred = port(img)
    for name in ("heatmap", "keypoint_heatmap"):
        variables["params"][name]["Conv_1"]["bias"] -= _np(getattr(pred, name)).mean(
            axis=(0, 1, 2))
    port.load_state_dict(centernet_state_dict_from_flax(variables))
    want = jax_pipeline.make_centernet_keypoint_pipeline(
        jax_model, jax_centernet_config(mc), jax_object_config(oc), PROJECTION,
        ALL_SLOTS.n_detections, ALL_SLOTS.keypoint_n_detections, 0.0, 0.0,
        dtype=jnp.float32)(variables, jnp.asarray(frames))
    got = make_centernet_keypoint_pipeline(port, mc, oc, PROJECTION, "cpu", knobs=ALL_SLOTS,
                                           impl="plain")(frames)
    _assert_decodes_match(got.detections, want.detections)
    assert int(got.keypoint_valid.sum()) > 0
    for name in ("keypoint_valid", "pose_valid"):
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)),
                                      err_msg=name)
    for name in ("keypoint_y", "keypoint_x"):   # the offsets' heads an ulp apart
        np.testing.assert_allclose(_np(getattr(got, name)), _np(getattr(want, name)), rtol=0,
                                   atol=DECODE_P95, err_msg=name)


def test_torch_centernet_server_matches_jax():
    """``CenternetServer`` on the JAX server test's custom net (64x64, one
    level, 6 keypoints; 4 detections and 8 keypoint peaks at threshold 0)
    against the JAX package's, with a depth plane and without depth."""
    oc = ObjectConfigSet(configs=(ObjectConfig(
        id="torpedo", yaw=AngleConfig(train=False, modulo=None),
        pitch=AngleConfig(train=False, modulo=None), roll=AngleConfig(train=False, modulo=None),
        train_depth=False, train_keypoints=True,
        keypoints=tuple((0.1 * i, 0.0, 0.0) for i in range(6))),))
    _, mc = _configs(64, 64, (1,), (8, 8))
    jax_model, variables, port = _pair(oc, mc, seed=5)
    intr = np.asarray([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]])
    kwargs = dict(n_detections=4, keypoint_n_detections=8, score_threshold=0.0)
    want_server = jax_nodes.CenternetServer(jax_model, variables, jax_centernet_config(mc),
                                            jax_object_config(oc), intr, **kwargs)
    server = CenternetServer(port, mc, oc, intr, device="cpu", **kwargs)
    color = np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    for name, depth in (("plane", np.full((2, 64, 64), 2.0, np.float32)), ("none", None)):
        got, want = _serve_both(want_server, server, color, depth, np.eye(4))
        _assert_published_equal(got, want, name)
        if depth is not None:
            assert [len(s) for s in got] == [4, 4]
            assert all(tag == "torpedo" and np.isfinite(pos).all()
                       for s in got for tag, pos, _, _ in s)


def rel_l2(port, want):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(port - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def train_step(small):
    """JAX's loss, gradients and batch statistics of one training forward,
    and the port's one step from the same weights on the image and on the
    image scaled by NUDGE (the losses, a copy of the model holding the
    step's statistics and the raw gradients)."""
    oc, mc, jax_model, variables, _ = small
    tc = samples_torpedo.train_config
    jax_oc, jax_mc, jax_tc = jax_object_config(oc), jax_centernet_config(mc), jax_train_config(tc)
    img, truth = generate_square_batch(np.random.default_rng(0), 2, SquareDatasetConfig(
        in_h=H, in_w=W, max_objects=4, min_side=8, max_side=16, keypoints=True))
    jax_truth = JaxTruth(**{f.name: None if getattr(truth, f.name) is None
                            else jnp.asarray(getattr(truth, f.name))
                            for f in dataclasses.fields(truth)})

    def loss_fn(params, batch_stats):
        prediction, mutated = jax_model.apply(
            {"params": params, "batch_stats": batch_stats}, jnp.asarray(img), train=True,
            mutable=["batch_stats"])
        losses = jax_centernet_loss(prediction, jax_truth, jax_mc, jax_tc, jax_oc)
        return losses.total, (losses, mutated["batch_stats"])

    (_, (losses, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    want = dict(losses=jax.device_get(losses), grads=centernet_state_dict_from_flax(
        {"params": jax.device_get(grads), "batch_stats": jax.device_get(stats)}))

    step = make_centernet_train_step(mc, tc, oc)
    port = {}
    for key, scale in (("port", 1.0), ("nudged", NUDGE)):
        model = Centernet(oc, HEIGHTS, CHANNELS, 2, device="cpu")
        model.load_state_dict(centernet_state_dict_from_flax(variables))
        state = TrainState(model, adam_with_clip(model.parameters(), tc.lr, tc.grad_max_norm))
        raw = {}
        state.optimizer.register_step_pre_hook(lambda *_: raw.update(
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}))
        img_t = _nchw(img) * scale
        state, step_losses = step(state, img_t, truth.to("cpu"))
        port[key] = dict(losses=step_losses, grads=raw, buffers=dict(model.named_buffers()))
    return want, port


def _bar(base, port, nudged):
    return max(base, YARDSTICK * rel_l2(nudged, port))


def test_torch_centernet_train_step_matches_jax(small, train_step):
    want, port = train_step
    got, nudged = port["port"], port["nudged"]
    assert float(want["losses"].keypoint_heatmap) > 0 and float(want["losses"].depth) > 0
    for field in dataclasses.fields(got["losses"]):
        p, w = getattr(got["losses"], field.name), np.asarray(getattr(want["losses"], field.name))
        if not w.any():
            assert not p.any(), field.name
            continue
        err = rel_l2(p, w)
        assert err <= _bar(LOSS_RTOL, p, getattr(nudged["losses"], field.name)), (field.name, err)

    # A conv's bias just before a BatchNorm on batch statistics has a
    # gradient of 0 in exact arithmetic: held by its size.
    before_bn = {f"backbone.{n}.bias" for n, m in small[-1].backbone.named_modules()
                 if isinstance(m, torch.nn.Conv2d)}
    bad, n_grads = {}, 0
    for name, g in got["grads"].items():
        if name in before_bn:
            weight = name[:-len("bias")] + "weight"
            for gb, gw in ((g, got["grads"][weight]), (want["grads"][name], want["grads"][weight])):
                assert gb.norm() <= GRAD_RTOL * gw.norm(), name
            continue
        n_grads += 1
        err = rel_l2(g, want["grads"][name])
        if err > _bar(GRAD_RTOL, g, nudged["grads"][name]):
            bad[name] = err
    assert n_grads > 100 and not bad, bad

    stats = [n for n in got["buffers"] if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in small[-1].modules())
    for name in stats:
        err = rel_l2(got["buffers"][name], want["grads"][name])
        assert err <= _bar(STATS_TOL, got["buffers"][name], nudged["buffers"][name]), (name, err)


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


@pytest.fixture(scope="module")
def int8(small):
    """JAX ``calibrate`` and ``quantized_call`` on the f32 net, op by op:
    (image, scales, the forward, its quantized convs' calls)."""
    *_, jax_model, variables, _ = small
    img = jnp.asarray(_images((2, H, W, 3), seed=6))
    apply = lambda b: jax_model.apply(variables, b, train=False)  # noqa: E731
    scales = jax_quantize.calibrate(apply, [img])
    with QuantizedConvRecorder() as rec:
        out = jax_quantize.quantized_call(apply, scales)(img)
    return img, scales, out, rec.calls


def test_torch_centernet_calibrate_matches_jax(small, int8):
    *_, port = small
    img, want, _, _ = int8
    got = calibrate(port, [_nchw(img)], paths_of=centernet_flax_path)
    assert set(got) == set(want) and len(want) > 10
    assert not any("ConvTranspose" in p for p in want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, rtol=1e-5, atol=0, err_msg=path)


def test_torch_centernet_quantized_call_matches_jax(small, int8):
    """Every JAX quantized conv bit-equal to the port's on JAX's input, and
    the per-layer int8 heads within JAX's own spread."""
    *_, port = small
    img, scales, want, calls = int8
    convs = {centernet_flax_path(n): m for n, m in port.named_modules()
             if isinstance(m, torch.nn.Conv2d)}
    assert {path for path, _, _ in calls} == set(scales)
    for path, x, y in calls:
        with torch.inference_mode():
            got = _QuantizedConv(convs[path], scales[path])(_nchw(x))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(y),
                                      err_msg=path)
    with torch.inference_mode():
        got = quantized_call(port, scales, paths_of=centernet_flax_path)(_nchw(img))
    assert all("forward" not in vars(m) for m in port.modules())
    for name in PREDICTION_FIELDS:
        w = getattr(want, name)
        if w is not None:
            assert rel_l2(_np(getattr(got, name)), w) <= INT8_SPREAD, name


def jax_spread():
    """JAX's compiled per-layer int8 heads against its op-by-op ones."""
    oc, mc = _configs()
    jax_model, variables, _ = _pair(oc, mc)
    img = jnp.asarray(_images((2, H, W, 3), seed=6))
    apply = lambda b: jax_model.apply(variables, b, train=False)  # noqa: E731
    scales = jax_quantize.calibrate(apply, [img])
    op_by_op = jax_quantize.quantized_call(apply, scales)(img)
    compiled = jax.jit(jax_quantize.quantized_call(apply, scales))(img)
    return max(rel_l2(getattr(compiled, n), getattr(op_by_op, n))
               for n in PREDICTION_FIELDS if getattr(op_by_op, n) is not None)


if __name__ == "__main__":
    print("INT8_SPREAD", jax_spread())
