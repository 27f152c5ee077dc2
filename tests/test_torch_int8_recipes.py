"""The pair's two other int8 profiles of ``bench.py`` in the PyTorch port
against the JAX package, on the CPU: ``--parity-int8`` with its options
(``configs.PARITY_INT8``: ``calibrate(percentile=)``, ``refine_scales_mse``,
``calibrate_bias_correction``, ``calibrate_sequential`` and the chains'
gains and corrections) and ``--per-layer-int8`` on the CenterNet
(``configs.PER_LAYER_INT8``: ``quantized_call`` with
``centerpoint_calibration_paths``).

The nets: the DLA-34 CenterNet of ``configs.centernet_config`` at 64x128
(where the JAX chain's symmetric ``pad_to_match`` and the reference's
agree, ``tests/test_torch_centernet_chain.py``) in the recipe's bf16 with
f32 BatchNorm outputs, and the small YOLACT of ``torch_parity.SMALL_YOLACT``
in bf16, on the same numpy weights in both stacks, fed the same seeded
uint8 frames.  The JAX calibrations and chains run op by op.

- ``_percentile`` is ``jnp.percentile`` (linear interpolation) on the same
  data, bf16 and f32, per tensor and per channel, and past 2^24 elements,
  where ``torch.quantile`` refuses: equal within 1e-6 relative (measured:
  equal).
- ``calibrate(percentile=)``, ``refine_scales_mse`` and
  ``calibrate_bias_correction`` read each conv's input, and so are held
  on JAX's own conv inputs: a replay module calls the port's convs on the
  inputs that JAX's forward gave its convs (``Replay``), so that only
  each function's own arithmetic differs.  The scales within 1e-6
  relative; the MSE factors equal but where the port's two best errors of
  a channel lie within 1e-6 relative of each other (near-ties, counted
  and named); the bias corrections within 1e-4 of each path's largest
  magnitude.  JAX's forward runs the two projections of a depth-2 tree's
  own input that its parent computes and discards
  (``JAX_ONLY``); the port's does not, and its replay leaves them out:
  their keys still come out, from the input of the tree's own projection,
  with JAX's values.
- On the whole nets, the port's ``int8_pair.calibrate_pair`` gives JAX's
  key sets for each option.
- ``calibrate_sequential`` with JAX's scales, both chains starting from
  JAX's stem output (``ChainRecorder``): gains and corrections within
  ``SEQ_RTOL`` of each path's largest magnitude, the key sets equal but
  for ``JAX_ONLY``, whose projections the port's chain never runs (a fit
  there would be of a map nothing reads).
- Each option's two chains, served through ``int8_pair``'s pipelines on
  JAX's calibration, against JAX's chain pipelines: every int8 map equal,
  the float maps within ``FLOAT_ULPS`` of their largest value, and the
  decodes at threshold 0 100% matched, every p95 <= 1e-3.
- ``quantized_call`` on the bf16 CenterNet: each int8 conv given JAX's input
  bit-equal to JAX's ``_quantized_conv``, the tree's discarded
  projections included, and the heads within JAX's own compiled-vs-op-by-op
  spread (``QUANTIZED_SPREAD``, measured by ``python
  tests/test_torch_int8_recipes.py``).
"""

import dataclasses
from dataclasses import replace

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu.ops.image import preprocess as jax_preprocess
from tauv_vision_tpu.serving import quantize as jax_quantize
from tauv_vision_tpu.serving import quantize_chain as jax_chain
from tauv_vision_tpu.serving.pipeline import IMAGENET_MEAN, IMAGENET_STDDEV
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import (
    PARITY_INT8,
    PER_LAYER_INT8,
    YolactModelConfig,
    centernet_config,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.ops.image import preprocess
from tauv_vision_tpu_torch.serving import quantize_chain as port_chain
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.int8_pair import (
    NetCalibration,
    calibrate_pair,
    make_int8_pair_pipelines,
)
from tauv_vision_tpu_torch.serving.pipeline import DecodeKnobs
from tauv_vision_tpu_torch.serving.quantize import (
    _percentile,
    calibrate,
    calibrate_bias_correction,
    mse_errors,
    quantized_call,
    refine_scales_mse,
)
from tauv_vision_tpu_torch.weights import (
    centerpoint_calibration_paths,
    centerpoint_flax_path,
    centerpoint_state_dict_from_flax,
    yolact_flax_path,
    yolact_state_dict_from_flax,
)
from test_torch_centernet_chain import JAX_ONLY, _jax_model
from test_torch_yolo_pose_bf16 import _rel_l2
from test_torch_yolo_pose_int8 import QuantizedConvRecorder, _check_quantized_convs
from torch_parity import (
    SMALL_YOLACT,
    ChainRecorder,
    jax_centernet_config,
    jax_object_config,
    jax_yolact_config,
    random_variables,
    torch_threads,
)

H, W = 64, 128
N_FRAMES = 2
ALL_SLOTS = DecodeKnobs(score_threshold=0.0, confidence_threshold=0.0)
SCALE_RTOL = 1e-6
MSE_TIE = 1e-6
BIAS_ATOL = 1e-4      # of a path's largest correction
SEQ_RTOL = 1e-5       # a fit's f32 means in another order (see its test)
DECODE_P95 = 1e-3
# A float conv of the chain (bf16, its f32 BatchNorm output) on JAX's
# input, against JAX's: the port's bf16 CPU conv rounds some outputs to the
# neighbouring bf16 number (measured on 7% of the first trunk conv's), two
# bf16 ulps of the map's largest value at most.
FLOAT_ULPS = 2.0 ** -7
# A float map of the quantized layers (the dequantized accumulator, gains,
# corrections, BatchNorm) from equal codes: f32 ops, each rounded once as
# JAX's op by op; within 4 f32 ulps of the map's largest value (XLA's
# rsqrt in the BatchNorm fold is not correctly rounded).
QUANTIZED_ULPS = 2.0 ** -21
OPTIONS = {"plain": PARITY_INT8, "mse_bias": replace(PARITY_INT8, mse=True, bias_correct=True),
           "mse_seq": replace(PARITY_INT8, mse=True, seq_correct=True)}
# JAX's ``quantized_call`` forward of the bf16 CenterNet, compiled against
# op by op: each head's relative L2 distance, on this module's seeds
# (rounded up in the third digit).
QUANTIZED_SPREAD = {"heatmap": 0.0434, "size": 0.0489, "offset": 0.0609}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _frames(seed=5):
    return np.random.default_rng(seed).integers(0, 256, (N_FRAMES, H, W, 3), np.uint8)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).permute(
        0, 3, 1, 2).contiguous()


@dataclasses.dataclass
class Net:
    """One net of the pair in both stacks."""

    name: str
    apply: object             # JAX: image -> prediction, op by op
    variables: dict
    port: torch.nn.Module
    paths_of: object          # port conv name -> JAX path(s)
    path_of: object           # port module name -> JAX path
    chain: object             # the recipe's scales (``centernet_scales`` or ``yolact_scales``)
    jax_img: object           # JAX image of the calibration frames
    jax_forward: object       # JAX chain forward (ctx) -> fn(uint8 frames)
    jax_pipeline: object      # JAX chain pipeline (scales, gains, corrections)
    stem: str
    jax_only: frozenset = frozenset()


def _centernet(frames) -> Net:
    oc, mc = centernet_config(H, W)
    jax_model = _jax_model(oc, PARITY_INT8)
    variables = random_variables(jax_model, (1, H, W, 3), 0)
    port = CenterpointDLA34(oc, device="cpu", **PARITY_INT8.centernet_kwargs()).eval()
    port.load_state_dict(centerpoint_state_dict_from_flax(variables))
    jax_oc = jax_object_config(oc)

    def image(f):
        return jax_preprocess(jnp.asarray(f), (H, W), IMAGENET_MEAN, IMAGENET_STDDEV,
                              dtype=jnp.bfloat16)

    def forward(ctx):
        fwd = jax_chain.dla34_chain_forward(jax_oc, variables, ctx.scales, ctx=ctx)
        return lambda f: fwd(image(f))

    def pipeline(scales, gains, corrections):
        return jax_chain.make_centernet_chain_pipeline(
            jax_centernet_config(mc), jax_oc, variables, scales, n_detections=10,
            score_threshold=0.0, jit=False, gains=gains, corrections=corrections)

    return Net("centernet", lambda b: jax_model.apply(variables, b, train=False), variables,
               port, centerpoint_calibration_paths, centerpoint_flax_path,
               PARITY_INT8.centernet_scales, image(frames[:2]), forward, pipeline,
               "model/base/base_conv", frozenset(JAX_ONLY))


def _yolact(frames) -> Net:
    cfg = YolactModelConfig(**SMALL_YOLACT)
    jax_cfg = jax_yolact_config(cfg)
    jax_model = JaxYolact(jax_cfg, dtype=jnp.bfloat16)
    variables = random_variables(jax_model, (1, cfg.in_h, cfg.in_w, 3), 1)
    port = Yolact(cfg, device="cpu", dtype=torch.bfloat16).eval()
    port.load_state_dict(yolact_state_dict_from_flax(variables))

    def image(f):
        return jax_preprocess(jnp.asarray(f), (cfg.in_h, cfg.in_w), cfg.img_mean,
                              cfg.img_stddev, dtype=jnp.bfloat16)

    def forward(ctx):
        fwd = jax_chain.yolact_chain_forward(jax_cfg, variables, ctx.scales, ctx=ctx)
        return lambda f: fwd(image(f))

    def pipeline(scales, gains, corrections):
        return jax_chain.make_yolact_chain_pipeline(
            jax_cfg, variables, scales, top_k=ALL_SLOTS.top_k,
            iou_threshold=ALL_SLOTS.iou_threshold, confidence_threshold=0.0, jit=False,
            gains=gains, corrections=corrections)

    return Net("yolact", lambda b: jax_model.apply(variables, b, train=False), variables,
               port, yolact_flax_path, yolact_flax_path, PARITY_INT8.yolact_scales,
               image(frames[:2]), forward, pipeline, "backbone/conv1")


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def nets(frames):
    return {"centernet": _centernet(frames), "yolact": _yolact(frames)}


_JAX_CALIBRATION = {}


def jax_calibration(net: Net, frames, option: str):
    """JAX's calibration of ``net`` by ``bench.py``'s steps for ``option``:
    (scales, gains, corrections); cached by net and option."""
    key = (net.name, option)
    if key not in _JAX_CALIBRATION:
        recipe = OPTIONS[option]
        scales = jax_quantize.strip_scales(
            jax_quantize.calibrate(net.apply, [net.jax_img], per_channel=net.chain.per_channel),
            net.chain.float_paths)
        gains = corrections = None
        if recipe.mse:
            scales = jax_quantize.refine_scales_mse(net.apply, [net.jax_img], scales)
        if recipe.bias_correct:
            corrections = jax_quantize.calibrate_bias_correction(net.apply, [net.jax_img],
                                                                 scales)
        if recipe.seq_correct:
            gains, corrections = jax_chain.calibrate_sequential(
                net.jax_forward, net.variables, scales, jnp.asarray(frames))
        _JAX_CALIBRATION[key] = (scales, gains, corrections)
    return _JAX_CALIBRATION[key]


# ------------------------------------------------------------ percentile


PERCENTILE_CASES = {
    "f32_tensor": ((3, 16, 24, 20), torch.float32, None, 99.9),
    "bf16_tensor": ((3, 16, 24, 20), torch.bfloat16, None, 99.99),
    "f32_channels": ((1153, 24), torch.float32, 0, 99.9),
    "bf16_channels": ((1153, 24), torch.bfloat16, 0, 50.0),
    "edges": ((7, 5), torch.float32, 0, 100.0),
    "past_2_24": ((2 ** 24 + 3,), torch.float32, None, 99.9),
}


@pytest.mark.parametrize("case", list(PERCENTILE_CASES))
def test_torch_percentile_matches_jnp(case, record_property):
    shape, dtype, dim, q = PERCENTILE_CASES[case]
    x = np.abs(np.random.default_rng(7).standard_normal(shape)).astype(np.float32)
    t = torch.from_numpy(x).to(dtype)
    if case == "past_2_24":
        with pytest.raises(RuntimeError):
            torch.quantile(t, q / 100)
    jx = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                else jnp.float32)
    want = np.asarray(jnp.percentile(jx, q, axis=dim).astype(jnp.float32), np.float64)
    got = _percentile(t, q, dim=dim)
    assert got.dtype == dtype
    got = got.float().numpy().astype(np.float64)
    record_property("max_rel_err", float(np.max(np.abs(got - want) / want)))
    np.testing.assert_allclose(got, want, rtol=SCALE_RTOL)


# ----------------------------------------------- calibration on JAX's inputs


def jax_conv_inputs(net: Net):
    """[(path, NHWC input)] of every ``nn.Conv`` call of JAX's forward of
    its calibration image with 16 input channels or more, in call order."""
    calls = []

    def record(next_fn, args, kwargs, context):
        if (context.method_name == "__call__" and isinstance(context.module, flax_nn.Conv)
                and args and args[0].ndim == 4 and args[0].shape[-1] >= 16):
            calls.append(("/".join(context.module.path), args[0]))
        return next_fn(*args, **kwargs)

    with flax_nn.intercept_methods(record):
        net.apply(net.jax_img)
    return calls


class Replay(torch.nn.Module):
    """Calls ``net``'s own convs on JAX's recorded inputs (as NCHW in the
    input's dtype), but for the calls of ``skip``, which the port never
    makes; a batch argument is ignored."""

    def __init__(self, net: Net, calls, skip=frozenset()):
        super().__init__()
        self.net = net.port
        own = {}
        for name, m in net.port.named_modules():
            if isinstance(m, torch.nn.Conv2d):
                paths = net.paths_of(name)
                own[paths if isinstance(paths, str) or paths is None else paths[0]] = m
        dtype = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
        self.calls = [(own[path], _nchw(x).to(dtype[x.dtype.type])) for path, x in calls
                      if path not in skip]
        self.paths_of = lambda name: net.paths_of(name[len("net."):])

    def forward(self, _):
        for conv, x in self.calls:
            conv(x)


@pytest.fixture(scope="module")
def replays(nets):
    """{net: (Replay, the set of paths JAX's forward called)}."""
    out = {}
    for name, net in nets.items():
        calls = jax_conv_inputs(net)
        out[name] = (Replay(net, calls, net.jax_only), {path for path, _ in calls})
    return out


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_torch_calibrate_percentile_matches_jax(nets, replays, per_channel, record_property):
    """On the CenterNet's convs (f32 inputs after its f32 BatchNorms, bf16
    at the heads)."""
    net, (replay, called) = nets["centernet"], replays["centernet"]
    want = jax_quantize.calibrate(net.apply, [net.jax_img], percentile=99.9,
                                  per_channel=per_channel)
    got = calibrate(replay, [None], per_channel=per_channel, paths_of=replay.paths_of,
                    percentile=99.9)
    assert set(got) == set(want) == called
    err = max(float(np.max(np.abs(np.asarray(got[p]) / np.asarray(want[p]) - 1)))
              for p in want)
    record_property("max_rel_err", err)
    assert err <= SCALE_RTOL, err


def _near_tie(errors) -> bool:
    best = np.sort(errors)
    return best[1] - best[0] <= MSE_TIE * best[0]


@pytest.mark.parametrize("name", ["centernet", "yolact"])
def test_torch_refine_scales_mse_matches_jax(nets, replays, name, record_property):
    """The recipe's per-channel factors equal but at near-ties of the
    port's errors, counted."""
    net, (replay, _) = nets[name], replays[name]
    per_channel = net.chain.per_channel
    scales = jax_calibration(net, None, "plain")[0]
    want = jax_calibration(net, None, "mse_bias")[0]
    got = refine_scales_mse(replay, [None], scales, paths_of=replay.paths_of)
    errs = mse_errors(replay, [None], scales, paths_of=replay.paths_of)
    assert set(got) == set(want) == set(scales) == set(errs)
    ties, n = [], 0
    for path, w in want.items():
        g, w = np.atleast_1d(got[path]), np.atleast_1d(w)
        e = errs[path] if per_channel else errs[path].sum(axis=1, keepdims=True)
        for c in range(len(w)):
            n += 1
            if g[c] != w[c]:
                assert _near_tie(e[:, c]), (path, c, g[c], w[c], e[:, c])
                ties.append(f"{path}[{c}]")
    record_property("factors", n)
    record_property("near_ties_differing", str(ties))
    assert len(ties) <= n // 100, ties


@pytest.mark.parametrize("name", ["centernet", "yolact"])
def test_torch_bias_correction_matches_jax(nets, replays, name, record_property):
    """On JAX's inputs; the discarded projections' keys come from the
    inputs of the trees' own projections, with JAX's values."""
    net, (replay, called) = nets[name], replays[name]
    scales, _, _ = jax_calibration(net, None, "plain")
    want = jax_quantize.calibrate_bias_correction(net.apply, [net.jax_img], scales)
    got = calibrate_bias_correction(replay, [None], scales, paths_of=replay.paths_of)
    assert set(got) == set(want) == set(scales) & called
    assert net.jax_only <= set(got)
    worst = 0.0
    for path, w in want.items():
        atol = BIAS_ATOL * np.abs(w).max()
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg=path)
        worst = max(worst, float(np.abs(got[path] - w).max() / np.abs(w).max()))
    record_property("max_err_of_largest", worst)


# ------------------------------------------------- sequential calibration


def _vector_err(got, want) -> float:
    """The largest difference over the largest magnitude of ``want``."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def port_forward(net: Net, chain_forward):
    cfg_hw = ((H, W) if net.name == "centernet"
              else (net.port.config.in_h, net.port.config.in_w))
    mean, std = ((IMAGENET_MEAN, IMAGENET_STDDEV) if net.name == "centernet"
                 else (net.port.config.img_mean, net.port.config.img_stddev))

    def build(ctx):
        fwd = chain_forward(ctx)
        return lambda f: fwd(preprocess(torch.from_numpy(np.asarray(f)), cfg_hw, mean, std,
                                        torch.bfloat16))
    return build


@pytest.mark.parametrize("name", ["centernet", "yolact"])
def test_torch_calibrate_sequential_matches_jax(nets, frames, name, record_property):
    """Each fit on JAX's maps (``from_jax="all"``): pass A's captures and
    every layer's output are JAX's, so that each path's fit reads the same
    accumulator and target in both stacks.  A fit's means are f32 sums in
    another order than XLA's: gains within ``SEQ_RTOL``; a correction
    ``mean(target) - a * mean(accumulator)`` within ``SEQ_RTOL`` of the
    sizes of the two terms (the target's mean magnitude, and a times the
    accumulator's mean), beyond what the gain's own difference moves the
    second term.  The port's own float maps within
    ``FLOAT_ULPS``; its own codes, from its own fits, differ in a few
    places (counted)."""
    net = nets[name]
    scales = jax_calibration(net, frames, "mse_bias")[0]
    build = port_forward(net, port_chain.dla34_chain_forward if name == "centernet"
                         else port_chain.yolact_chain_forward)
    with ChainRecorder(jax_chain, port_chain, net.stem, from_jax="all") as rec:
        want_gains, want_corr = jax_chain.calibrate_sequential(
            net.jax_forward, net.variables, scales, jnp.asarray(frames))
        gains, corr = port_chain.calibrate_sequential(
            build, net.port, scales, frames, dtype=torch.bfloat16, path_of=net.path_of,
            impl="plain")
    _JAX_CALIBRATION.setdefault((name, "mse_seq"), (scales, want_gains, want_corr))
    float_err = max(rec.float_errs.values())
    record_property("float_maps_max_err_of_largest", float_err)
    record_property("port_codes_differing", sum(rec.code_diffs.values()))
    record_property("codes", sum(rec.maps["jax"][k].size for k in rec.code_diffs))
    assert float_err <= FLOAT_ULPS
    assert set(gains) == set(corr) == set(want_gains) - net.jax_only
    assert set(want_gains) & net.jax_only == net.jax_only
    worst = {"gains": 0.0, "corrections": 0.0}
    for path in gains:
        g, wg = np.asarray(gains[path], np.float64), np.asarray(want_gains[path], np.float64)
        err = float(np.max(np.abs(g - wg) / np.abs(wg)))
        worst["gains"] = max(worst["gains"], err)
        assert err <= SEQ_RTOL, ("gains", path, err)
        target = rec.captures[path].astype(np.float64)
        target_mean, target_size = target.mean(axis=(0, 1, 2)), np.abs(target).mean(axis=(0, 1, 2))
        c, wc = np.asarray(corr[path], np.float64), np.asarray(want_corr[path], np.float64)
        scaled_mean = np.abs(target_mean - wc)            # |a * mean(accumulator)|
        inherited = np.abs(g - wg) * scaled_mean / np.abs(wg)
        err = float(np.max((np.abs(c - wc) - inherited) / (target_size + scaled_mean)))
        worst["corrections"] = max(worst["corrections"], err)
        assert err <= SEQ_RTOL, ("corrections", path, err)
    record_property("max_err", str(worst))


@pytest.mark.parametrize("option", ["mse_bias", "mse_seq"])
def test_torch_calibrate_pair_keys_match_jax(nets, frames, option):
    """``int8_pair.calibrate_pair`` on the whole nets: JAX's key sets (the
    sequential fits but for the discarded projections)."""
    recipe = OPTIONS[option]
    mc = centernet_config(H, W)[1]
    got = calibrate_pair(recipe, nets["centernet"].port, mc, nets["yolact"].port,
                         torch.from_numpy(frames), impl="plain")
    for net, cal in zip(nets.values(), got):
        scales, gains, corrections = jax_calibration(net, frames, option)
        assert set(cal.scales) == set(scales), net.name
        assert set(cal.corrections) == set(corrections) - (net.jax_only if gains else set())
        assert (cal.gains is None) == (gains is None)
        if gains is not None:
            assert set(cal.gains) == set(gains) - net.jax_only


# ------------------------------------------------- the chains with each option


@pytest.mark.parametrize("option", list(OPTIONS))
def test_torch_parity_chains_match_jax(nets, frames, option, record_property):
    """Both chains of ``option`` through ``int8_pair``'s pipelines on JAX's
    calibration, from JAX's stem output: int8 maps equal, float maps within
    ``FLOAT_ULPS``, decodes 100% matched at threshold 0."""
    recipe = OPTIONS[option]
    cals = [NetCalibration(*jax_calibration(net, frames, option)) for net in nets.values()]
    mc = centernet_config(H, W)[1]
    pipes = make_int8_pair_pipelines(recipe, nets["centernet"].port, mc, nets["yolact"].port,
                                     cals, "cpu", ALL_SLOTS, impl="plain")
    before = dict(kernels.LAUNCHES)
    for net, cal, pipe in zip(nets.values(), cals, pipes):
        with ChainRecorder(jax_chain, port_chain, net.stem, from_jax="float") as rec:
            want = net.jax_pipeline(cal.scales, cal.gains, cal.corrections)(jnp.asarray(frames))
            got = pipe(frames)
        assert set(rec.maps["port"]) == set(rec.maps["jax"]) - net.jax_only
        float_err = max(rec.float_errs.values())
        assert float_err <= FLOAT_ULPS, float_err
        n_int8, int8_float_err = 0, 0.0
        for path, g in rec.maps["port"].items():
            w = rec.maps["jax"][path]
            assert g.dtype == w.dtype and g.shape == w.shape, path
            if g.dtype == np.int8:
                np.testing.assert_array_equal(g, w, err_msg=f"{net.name} {path}")
                n_int8 += 1
            else:
                err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
                int8_float_err = max(int8_float_err, err)
                assert err <= QUANTIZED_ULPS, (net.name, path, err)
        assert n_int8 > 0
        stats = detection_deltas(want, got, score_threshold=0.0)
        record_property(f"{net.name}_int8_maps", n_int8)
        record_property(f"{net.name}_float_convs_max_err_of_largest", float_err)
        record_property(f"{net.name}_other_float_maps_max_err_of_largest", int8_float_err)
        record_property(f"{net.name}_port_vs_jax", stats)
        assert stats["total"] == got.valid.numel() and stats["matched_fraction"] == 1.0, stats
        for what in ("center", "score", "size"):
            assert stats[f"{what}_delta_p95"] <= DECODE_P95, (net.name, stats)
    assert kernels.LAUNCHES == before


# ------------------------------------------- per-layer int8 on the CenterNet


def _jax_quantized(net: Net, scales):
    with QuantizedConvRecorder() as rec:
        out = jax_quantize.quantized_call(net.apply, scales)(net.jax_img)
    return out, rec.calls


@pytest.fixture(scope="module")
def per_layer(nets):
    """(JAX's per-tensor scales of the bf16 CenterNet, JAX
    ``quantized_call``'s forward op by op, its convs' calls)."""
    net = nets["centernet"]
    scales = jax_quantize.calibrate(net.apply, [net.jax_img])
    return (scales,) + _jax_quantized(net, scales)


def test_torch_centernet_quantized_convs_match_jax(nets, per_layer):
    """Every int8 conv of JAX's forward, the discarded projections
    included, bit-equal to the port's on JAX's input."""
    net = nets["centernet"]
    scales, _, calls = per_layer
    assert net.jax_only <= {path for path, _, _ in calls}
    assert PER_LAYER_INT8.centernet_scales.float_paths == ()
    _check_quantized_convs(calls, net.port, scales, centerpoint_flax_path)


def test_torch_centernet_quantized_call_matches_jax(nets, per_layer, record_property):
    """The heads within JAX's own compiled-vs-op-by-op spread; a tree's
    projection computed once, with its own scale (the first of
    ``centerpoint_calibration_paths``)."""
    net = nets["centernet"]
    scales, want, _ = per_layer
    with torch.inference_mode():
        got = quantized_call(net.port, scales, paths_of=centerpoint_calibration_paths)(
            _nchw(net.jax_img).to(torch.bfloat16))
    for head, bar in QUANTIZED_SPREAD.items():
        err = _rel_l2(getattr(got, head).float().numpy(),
                      np.asarray(getattr(want, head).astype(jnp.float32)))
        record_property(f"{head}_rel_l2", err)
        assert err <= bar, (head, err, bar)


def jax_spreads():
    """Measure ``QUANTIZED_SPREAD``: JAX's compiled ``quantized_call``
    forward against op by op."""
    net = _centernet(_frames())
    scales = jax_quantize.calibrate(net.apply, [net.jax_img])
    want = jax_quantize.quantized_call(net.apply, scales)(net.jax_img)
    compiled = jax.jit(jax_quantize.quantized_call(net.apply, scales))(net.jax_img)
    print("QUANTIZED_SPREAD", {
        head: _rel_l2(np.asarray(getattr(compiled, head).astype(jnp.float32)),
                      np.asarray(getattr(want, head).astype(jnp.float32)))
        for head in QUANTIZED_SPREAD})


if __name__ == "__main__":
    jax_spreads()
