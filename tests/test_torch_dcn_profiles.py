"""The DCN CenterNet in ``bench.py``'s other serving profiles, the port
against the JAX package on the CPU.

``bench.py --deform`` with ``--parity-int8`` (and its ``--mse``,
``--bias-correct``, ``--seq-correct`` options), ``--per-layer-int8`` and
``--bf16`` (``configs.DCN_PARITY_INT8``, ``DCN_PER_LAYER_INT8``,
``DCN_BF16_PAIR``); its knobs (``--dcn-max-offset``, ``--dcn-bound``,
``--bf16-joins``, ``--fused``) on the same nets in
``tests/test_torch_dcn_knobs.py``.  The nets: the DLA-34 CenterNet of
``configs.centernet_config`` at 64x128 (where both ``pad_to_match`` forms
agree) with its 16 IDA blocks deformable, bf16 with f32 BatchNorm outputs,
on the same numpy weights in both stacks (``torch_parity.random_variables``:
offsets reach a few cells), fed the same seeded uint8 frames.  The JAX
model serves its DCN through the Pallas kernel, run here in interpret mode
by replacing ``deform_conv2d_pallas`` for this module, as
``tests/test_torch_dcn_chain.py`` does; the JAX chains and calibrations
run op by op.  Every profile runs on JAX's calibration:

- the parity chain, plain and in its ``--mse --bias-correct`` and ``--mse
  --seq-correct`` forms, from JAX's float maps in the trunk (the parity
  tail keeps every IDA and DLA-up conv, so every DCN block, bf16; only the
  trunk's levels 2-5 are int8): every int8 map equal, the trunk's float
  maps within ``FLOAT_ULPS``.  From there the port's own DCN blocks and
  bf16 heads run on, and the decodes at threshold 0 are held by
  ``tests/test_torch_dcn_chain.py``'s bars: ``MATCHED`` (95% at the served
  3-cell window, where the two stacks sum the same bf16 products of the
  offset/mask conv and the DCN contraction in another order and a head
  rounds to the other side of a midpoint now and then: ROADMAP, Queue 3
  item 1; 100% at a 4-cell window), centre and score p95 <= 1e-3, size
  p95 within ``SIZE_ULPS`` bf16 ulps of the largest size.  The JAX
  sequential fit is given the DCN chain (``deform=True``): ``bench.py``
  builds it without (``bench.py:1470-1475``), which the DCN net's
  parameters do not fit (ROADMAP, "Known defects on the reference side");
- ``--per-layer-int8``: ``quantized_call`` on the DCN net, the port's
  ``calibrate`` keys equal to JAX's (44: no DCN offset or mask conv, which
  JAX serves merged) and the heads within JAX's own compiled-vs-op-by-op
  spread (``QUANTIZED_SPREAD``);
- ``--bf16``: the bf16 DCN CenterNet of ``DCN_BF16_PAIR``, its heads held
  as ``tests/test_torch_dcn_north_star.py`` holds the north-star DCN net's:
  within ``NET_ATOL`` of JAX's op-by-op graph, and no larger a share of
  elements differing than JAX's own compiled graph shows
  (``BF16_COMPILED_SHARE``; by relative L2 the port sits ~4% above the
  compiled graph's distance, 4.7e-3 against 4.6e-3 on the heatmap).

``PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/test_torch_dcn_profiles.py``
measures the two spreads again (JAX's graphs compiled, several minutes).
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.ops.image import preprocess as jax_preprocess
from tauv_vision_tpu.ops.pallas import deform_conv as pallas_deform_conv
from tauv_vision_tpu.serving import quantize as jax_quantize
from tauv_vision_tpu.serving import quantize_chain as jax_chain
from tauv_vision_tpu.serving.pipeline import IMAGENET_MEAN, IMAGENET_STDDEV
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import (
    DCN_BF16_PAIR,
    DCN_CHAIN_INT8,
    DCN_PARITY_INT8,
    DCN_PER_LAYER_INT8,
    YolactModelConfig,
    centernet_config,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.serving import quantize_chain as port_chain
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.int8_pair import NetCalibration, make_int8_pair_pipelines
from tauv_vision_tpu_torch.serving.quantize import calibrate, quantized_call
from tauv_vision_tpu_torch.weights import (
    centerpoint_calibration_paths,
    centerpoint_state_dict_from_flax,
)
from test_torch_centernet_chain import (
    ALL_SLOTS,
    CN_STEM,
    DECODE_P95,
    JAX_ONLY,
    _frames,
    _jax_model,
)
from test_torch_dcn_chain import MATCHED
from test_torch_int8_recipes import FLOAT_ULPS, QUANTIZED_ULPS
from test_torch_yolo_pose_bf16 import _rel_l2
from torch_parity import (
    SMALL_YOLACT,
    ChainRecorder,
    dcn_window,
    jax_centernet_config,
    jax_object_config,
    random_variables,
    torch_threads,
)

H, W = 64, 128
SERVED_WINDOW = 3.0
SIZE_ULPS = 2        # decoded sizes: bf16 ulps of the largest (chip_smoke's NS_SIZE_ULPS)
TRUNK = "model/base/"
OPTIONS = {"plain": DCN_PARITY_INT8,
           "mse_bias": replace(DCN_PARITY_INT8, mse=True, bias_correct=True),
           "mse_seq": replace(DCN_PARITY_INT8, mse=True, seq_correct=True)}
HEADS = ("heatmap", "size", "offset")
# JAX's forwards of the DCN net compiled against op by op, on this
# module's seeds (``jax_spreads``): ``quantized_call``'s heads' relative
# L2 distance, rounded up in the third digit; the bf16 net's share of head
# elements that differ, rounded down.
QUANTIZED_SPREAD = {"heatmap": 0.0136, "size": 0.00982, "offset": 0.0389}
BF16_COMPILED_SHARE = {"heatmap": 0.874, "size": 0.692, "offset": 0.748}
NET_ATOL = 2 * 0.0078125   # tests/test_torch_bf16_centernet.py's bar for the bf16 net


@pytest.fixture(scope="module", autouse=True)
def pallas_interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_deform_conv, "deform_conv2d_pallas", functools.partial(
            pallas_deform_conv.deform_conv2d_pallas, interpret=True))
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


class Net:
    """The DCN CenterNet of a recipe in both stacks, on one draw of
    weights: JAX's model (Pallas DCN at the recipe's window and bound),
    its variables, the port's model, the frames and JAX's image of them."""

    def __init__(self, recipe, seed=0):
        cn = recipe.centernet
        self.oc, self.mc = centernet_config(H, W)
        self.jax_oc = jax_object_config(self.oc)
        self.model = _jax_model(self.oc, recipe, dcn_impl="pallas",
                                dcn_max_offset=cn.dcn_max_offset, offset_bound=cn.offset_bound)
        self.variables = random_variables(self.model, (1, H, W, 3), seed)
        self.port = CenterpointDLA34(self.oc, device="cpu", **recipe.centernet_kwargs()).eval()
        self.port.load_state_dict(centerpoint_state_dict_from_flax(self.variables))
        self.frames = _frames(5, H, W)
        self.img = self.image(self.frames)

    def image(self, frames):
        return jax_preprocess(jnp.asarray(frames), (H, W), IMAGENET_MEAN, IMAGENET_STDDEV,
                              dtype=jnp.bfloat16)

    def apply(self, img):
        return self.model.apply(self.variables, img, train=False)

    def jax_pipeline(self, scales, window, gains=None, corrections=None, offset_bound=None,
                     join_dtype=None):
        return jax_chain.make_centernet_chain_pipeline(
            jax_centernet_config(self.mc), self.jax_oc, self.variables, scales,
            n_detections=ALL_SLOTS.n_detections, score_threshold=0.0, jit=False, gains=gains,
            corrections=corrections, deform=True, dcn_max_offset=float(window),
            offset_bound=offset_bound, join_dtype=join_dtype)


@pytest.fixture(scope="module")
def net():
    assert DCN_PARITY_INT8.centernet == DCN_CHAIN_INT8.centernet == DCN_BF16_PAIR.centernet
    return Net(DCN_PARITY_INT8)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).permute(
        0, 3, 1, 2).contiguous()


_CALIBRATIONS = {}


def jax_calibration(net: Net, option: str):
    """JAX's calibration of the DCN net by ``bench.py``'s steps for
    ``option``: (scales, gains, corrections), cached; per tensor for the
    chain-int8 profile (``"per_tensor"``)."""
    if option not in _CALIBRATIONS:
        if option == "per_tensor":
            _CALIBRATIONS[option] = (jax_quantize.calibrate(net.apply, [net.img]), None, None)
            return _CALIBRATIONS[option]
        recipe = OPTIONS[option]
        scales = jax_quantize.strip_scales(
            jax_quantize.calibrate(net.apply, [net.img], per_channel=True),
            recipe.centernet_scales.float_paths)
        gains = corrections = None
        if recipe.mse:
            scales = jax_quantize.refine_scales_mse(net.apply, [net.img], scales)
        if recipe.bias_correct:
            corrections = jax_quantize.calibrate_bias_correction(net.apply, [net.img], scales)
        if recipe.seq_correct:
            def forward(ctx):
                fwd = jax_chain.dla34_chain_forward(net.jax_oc, net.variables, ctx.scales,
                                                    ctx=ctx, deform=True,
                                                    dcn_max_offset=SERVED_WINDOW)
                return lambda f: fwd(net.image(f))
            gains, corrections = jax_chain.calibrate_sequential(
                forward, net.variables, scales, jnp.asarray(net.frames))
        _CALIBRATIONS[option] = (scales, gains, corrections)
    return _CALIBRATIONS[option]


def _decode_held(want, got, matched, record_property):
    stats = detection_deltas(want, got, score_threshold=0.0)
    record_property("port_vs_jax", stats)
    assert stats["total"] == got.valid.numel()
    size_atol = SIZE_ULPS * 2.0 ** (np.floor(np.log2(max(
        np.abs(np.asarray(want.h)).max(), np.abs(np.asarray(want.w)).max()))) - 7)
    assert stats["matched_fraction"] >= matched, stats
    assert stats["center_delta_p95"] <= DECODE_P95 and stats["score_delta_p95"] <= DECODE_P95
    assert stats["size_delta_p95"] <= size_atol, (stats, size_atol)


def _small_yolact():
    cfg = YolactModelConfig(**{**SMALL_YOLACT, "in_h": H, "in_w": W})
    return Yolact(cfg, generator=torch.Generator().manual_seed(3), device="cpu",
                  dtype=torch.bfloat16).eval()


# ------------------------------------------------------ --parity-int8


def assert_parity_chain_held(net, option, window, record_property):
    """The parity chain of ``option`` at ``window`` (see the module
    docstring)."""
    recipe = OPTIONS[option]
    scales, gains, corrections = jax_calibration(net, option)
    assert all(p.startswith(TRUNK) for p in scales)     # the tail keeps every DCN block bf16
    cal = (NetCalibration(scales, gains, corrections), NetCalibration({}))
    got_pipe = make_int8_pair_pipelines(recipe, net.port, net.mc, _small_yolact(), cal, "cpu",
                                        ALL_SLOTS, impl="plain")[0]
    want_pipe = net.jax_pipeline(scales, window, gains, corrections)
    before = dict(kernels.LAUNCHES)
    with ChainRecorder(jax_chain, port_chain, CN_STEM, from_jax="float",
                       substitutes=lambda p: p.startswith(TRUNK)) as rec, \
            dcn_window(net.port, window):
        want = want_pipe(jnp.asarray(net.frames))
        got = got_pipe(net.frames)
    assert kernels.LAUNCHES == before
    assert set(rec.maps["port"]) == set(rec.maps["jax"]) - JAX_ONLY
    n_int8, quantized_err = 0, 0.0
    for path, g in rec.maps["port"].items():
        w = rec.maps["jax"][path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=path)
            n_int8 += 1
        elif path in scales:
            err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
            quantized_err = max(quantized_err, err)
            assert err <= QUANTIZED_ULPS, (path, err)
    float_err = max(rec.float_errs.values())
    record_property("int8_maps", n_int8)
    record_property("trunk_float_convs_max_err_of_largest", float_err)
    record_property("quantized_float_maps_max_err_of_largest", quantized_err)
    assert n_int8 > 0 and float_err <= FLOAT_ULPS
    _decode_held(want, got, MATCHED[int(window)], record_property)


@pytest.mark.parametrize("option,window", [(option, SERVED_WINDOW) for option in OPTIONS]
                         + [("plain", 4.0)])
def test_torch_dcn_parity_chain_matches_jax(net, option, window, record_property):
    """Each form at the served window; the plain chain also at a 4-cell
    one, where the offsets all fall inside it."""
    assert_parity_chain_held(net, option, window, record_property)


# --------------------------------------------------- --per-layer-int8


def test_torch_dcn_quantized_call_matches_jax(net, record_property):
    """The port's ``calibrate`` keys are JAX's; the heads of
    ``quantized_call`` on JAX's scales within JAX's compiled-vs-op-by-op
    spread."""
    scales = jax_calibration(net, "per_tensor")[0]
    assert DCN_PER_LAYER_INT8.centernet_scales == replace(DCN_PER_LAYER_INT8.centernet_scales,
                                                          float_paths=())
    img = _nchw(net.img).to(torch.bfloat16)
    mine = calibrate(net.port, [img], paths_of=centerpoint_calibration_paths)
    assert set(mine) == set(scales) and len(scales) == 44
    assert not any("offset" in p or "mask" in p for p in scales)
    want = jax_quantize.quantized_call(net.apply, scales)(net.img)
    with torch.inference_mode(), dcn_window(net.port, SERVED_WINDOW):
        got = quantized_call(net.port, scales, paths_of=centerpoint_calibration_paths)(img)
    for head, bar in QUANTIZED_SPREAD.items():
        err = _rel_l2(getattr(got, head).float().numpy(),
                      np.asarray(getattr(want, head).astype(jnp.float32)))
        record_property(f"{head}_rel_l2", err)
        assert err <= bar, (head, err, bar)


# -------------------------------------------------------------- --bf16


def test_torch_dcn_bf16_centernet_matches_jax(net, record_property):
    want = net.apply(net.img)
    with torch.inference_mode():
        got = net.port(_nchw(net.img).to(DCN_BF16_PAIR.input_dtype))
    for head, share in BF16_COMPILED_SHARE.items():
        g = getattr(got, head).float().numpy()
        w = np.asarray(getattr(want, head).astype(jnp.float32))
        record_property(f"{head}_max_abs_err", float(np.abs(g - w).max()))
        record_property(f"{head}_share_differ", float((g != w).mean()))
        np.testing.assert_allclose(g, w, rtol=0, atol=NET_ATOL, err_msg=head)
        assert (g != w).mean() <= share, head


def jax_spreads():
    """Measure ``QUANTIZED_SPREAD`` and ``BF16_COMPILED_SHARE``: JAX's
    compiled forwards of the DCN net against op by op."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_deform_conv, "deform_conv2d_pallas", functools.partial(
            pallas_deform_conv.deform_conv2d_pallas, interpret=True))
        net = Net(DCN_PARITY_INT8)
        scales = jax_quantize.calibrate(net.apply, [net.img])
        for name, fn in (("QUANTIZED_SPREAD", jax_quantize.quantized_call(net.apply, scales)),
                         ("BF16_COMPILED_SHARE", net.apply)):
            eager, compiled = fn(net.img), jax.jit(fn)(net.img)
            pairs = {head: (np.asarray(getattr(compiled, head).astype(jnp.float32)),
                            np.asarray(getattr(eager, head).astype(jnp.float32)))
                     for head in HEADS}
            print(name, "relative L2", {h: _rel_l2(c, e) for h, (c, e) in pairs.items()},
                  "share differing", {h: float((c != e).mean()) for h, (c, e) in pairs.items()})


if __name__ == "__main__":
    jax_spreads()
