"""The int8 recipes of ``scripts/quantize_accuracy_check.py``'s ladder in the
PyTorch port against the JAX package, on the CPU: ``calibrate_range`` and
the asymmetric chain (``ChainCtx(ranges=)``, ``_asym_offset_map``,
``_quant_asym``), ``f32_paths``, and ``calibrate_sequential(mode="mean")``
(``calibrate_gptq`` and ``ChainCtx(wq_override=)`` in
``tests/test_torch_quantize_gptq.py``).

The nets are those of ``tests/test_torch_int8_recipes.py``: the DLA-34
CenterNet at 64x128 in bf16 with f32 BatchNorm outputs and the small
YOLACT in bf16, on the same numpy weights in both stacks, fed the same
seeded uint8 frames; the JAX calibrations and chains run op by op.

- ``calibrate_range`` on JAX's own conv inputs (``Replay``): every (min,
  max) within ``SCALE_RTOL`` of JAX's, the key sets equal (the CenterNet's
  discarded projections from the input of the tree's own projection).
- ``ChainCtx.asym``'s scales and zero points equal to JAX's; the offset map
  equal to JAX's at every conv shape of the DLA-34 chain (strided, padded
  and not), and the integer core's accumulator less the map equal to the
  float64 conv of (q - z) zero-padded, at each shape, on random codes.
- The asymmetric chains (the CenterNet's with its level-5 convs
  symmetric, the YOLACT's with both protonet upsamples' inputs
  asymmetric too, which the transposed convs then dequantize), from JAX's
  float maps (``ChainRecorder(from_jax="float")``): every int8 map equal,
  the dequantized maps within ``QUANTIZED_ULPS``, the decodes at threshold
  0 100% matched with every p95 <= 1e-3.
- ``calibrate_gptq`` and ``ChainCtx(wq_override=)``: in
  ``tests/test_torch_quantize_gptq.py``, on these nets and helpers.
- ``f32_paths=("head_",)`` with the heads float: each head conv in f32
  within ``F32_CONV_RTOL`` of JAX's on JAX's input.
- ``calibrate_sequential(mode="mean")``: every gain 1 in both, the
  offsets within ``SEQ_RTOL`` as in the affine fit's test.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.serving import quantize as jax_quantize
from tauv_vision_tpu.serving import quantize_chain as jax_chain
from tauv_vision_tpu_torch.configs import centernet_config
from tauv_vision_tpu_torch.configs.centernet import get_head_channels
from tauv_vision_tpu_torch.ops.int8_conv import conv2d_int8
from tauv_vision_tpu_torch.serving import quantize_chain as port_chain
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.quantize import calibrate_range, strip_scales
from tauv_vision_tpu_torch.serving.quantize_chain import (
    ChainCtx,
    _asym_offset_map,
    _wq,
)
from tauv_vision_tpu_torch.serving.pipeline import make_centernet_pipeline, make_yolact_pipeline
from tauv_vision_tpu_torch.weights import centerpoint_flax_path
from test_torch_int8_recipes import (
    ALL_SLOTS,
    DECODE_P95,
    FLOAT_ULPS,
    QUANTIZED_ULPS,
    SCALE_RTOL,
    SEQ_RTOL,
    Replay,
    _centernet,
    _frames,
    _yolact,
    jax_conv_inputs,
    port_forward,
)
from torch_parity import ChainRecorder, torch_threads

# An f32 head conv (3x3 over 64 channels, 1x1 over 256) on JAX's input
# against XLA's: sums in another order, within this of the map's largest
# value, the f32 conv bar of tests/test_torch_chain.py (``STEM_RTOL``;
# measured here 7.1e-7).
F32_CONV_RTOL = 2e-6
# The CenterNet's symmetric convs in the mixed asymmetric chain.
SYMMETRIC = ("level5",)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def nets(frames):
    return {"centernet": _centernet(frames), "yolact": _yolact(frames)}


@pytest.fixture(scope="module")
def replays(nets):
    """{net: (Replay, JAX's conv calls [(path, input)])}."""
    out = {}
    for name, net in nets.items():
        calls = jax_conv_inputs(net)
        out[name] = (Replay(net, calls, net.jax_only), calls)
    return out


_CACHE = {}


def jax_scales(net):
    """JAX's per-channel scales of ``net`` (its calibration image)."""
    key = ("scales", net.name)
    if key not in _CACHE:
        _CACHE[key] = jax_quantize.calibrate(net.apply, [net.jax_img], per_channel=True)
    return _CACHE[key]


def jax_ranges(net):
    key = ("ranges", net.name)
    if key not in _CACHE:
        _CACHE[key] = jax_quantize.calibrate_range(net.apply, [net.jax_img])
    return _CACHE[key]


def upsample_ranges(port, batches):
    """(min, max) of the small YOLACT's two protonet upsamples' inputs, by
    ``calibrate_range``'s rule, which records no transposed conv."""
    lo, hi = {}, {}

    def recorder(path):
        def hook(module, args):
            x = args[0].float()
            mn = x.amin(dim=(0, 2, 3)).double().numpy()
            mx = x.amax(dim=(0, 2, 3)).double().numpy()
            lo[path] = np.minimum(lo.get(path, mn), mn)
            hi[path] = np.maximum(hi.get(path, mx), mx)
        return hook

    hooks = [getattr(port._masknet, f"_upsample_layer_{i}").register_forward_pre_hook(
        recorder(f"protonet/upsample_{i}")) for i in (1, 2)]
    try:
        with torch.inference_mode():
            for batch in batches:
                port(batch)
    finally:
        for h in hooks:
            h.remove()
    return {p: (np.minimum(lo[p], 0.0), np.maximum(hi[p], np.minimum(lo[p], 0.0) + 1e-6))
            for p in lo}


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).permute(
        0, 3, 1, 2).contiguous()


# ------------------------------------------------------------ ranges


@pytest.mark.parametrize("name", ["centernet", "yolact"])
def test_torch_calibrate_range_matches_jax(nets, replays, name, record_property):
    net, (replay, calls) = nets[name], replays[name]
    want = jax_ranges(net)
    got = calibrate_range(replay, [None], paths_of=replay.paths_of)
    assert set(got) == set(want) == {path for path, _ in calls}
    assert net.jax_only <= set(got)
    worst = 0.0
    for path, (wmn, wmx) in want.items():
        gmn, gmx = got[path]
        assert gmn.dtype == gmx.dtype == np.float64
        assert np.all(gmn <= 0) and np.all(gmx >= gmn + 1e-6)
        for g, w in ((gmn, wmn), (gmx, wmx)):
            np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, atol=0, err_msg=path)
            worst = max(worst, float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30))))
    record_property("paths", len(want))
    record_property("max_rel_err", worst)


def test_torch_asym_scale_and_zero_match_jax(nets):
    net = nets["centernet"]
    ranges = jax_ranges(net)
    want = jax_chain.ChainCtx(net.variables, {}, ranges=ranges)
    got = ChainCtx(net.port, {}, ranges=ranges, path_of=centerpoint_flax_path)
    for path in ranges:
        (ws, wz), (gs, gz) = want.asym(path), got.asym(path)
        assert gs.dtype == np.float32 and gz.dtype == np.int32
        np.testing.assert_array_equal(gs, ws, err_msg=path)
        np.testing.assert_array_equal(gz, wz, err_msg=path)
    # A ReLU input (min 0) puts its zero point at the grid's bottom.
    assert any(np.all(got.asym(p)[1] == -128) for p in ranges)


def _conv_shapes(net, calls):
    """{(kernel, in_hw, stride, pad, O, C): (path, the port conv)} of every
    distinct calibrated conv call of JAX's forward."""
    modules = ChainCtx(net.port, {}, path_of=centerpoint_flax_path).modules
    shapes = {}
    for path, x in calls:
        m = modules[path]
        key = (tuple(m.kernel_size), tuple(x.shape[1:3]), tuple(m.stride), tuple(m.padding),
               m.out_channels, m.in_channels)
        shapes.setdefault(key, (path, m))
    return shapes


def test_torch_asym_offset_map_matches_jax(nets, replays, record_property):
    """At every conv shape of the DLA-34 chain: the map equal to JAX's
    (int32), and the accumulator less it equal to the float64 conv of
    (q - z) with zero padding, on random codes of the full grid."""
    net, (_, calls) = nets["centernet"], replays["centernet"]
    ranges = jax_ranges(net)
    ctx = ChainCtx(net.port, {}, ranges=ranges, path_of=centerpoint_flax_path)
    rng = np.random.default_rng(3)
    shapes = _conv_shapes(net, calls)
    strided = padded = 0
    for (k, in_hw, stride, pad, o, c), (path, m) in shapes.items():
        s, z = ctx.asym(path)
        qk, _ = _wq(port_chain._hwio(m).detach(), in_scale=s)
        out_hw = tuple((n + 2 * p - kk) // st + 1 for n, p, kk, st in zip(in_hw, pad, k, stride))
        want = np.asarray(jax_chain._asym_offset_map(
            jnp.asarray(qk.numpy()), z, out_hw, in_hw, stride, tuple((p, p) for p in pad)))
        got = _asym_offset_map(qk, z, out_hw, in_hw, stride, pad)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
        q = torch.from_numpy(rng.integers(-128, 128, (2, *in_hw, c)).astype(np.int8))
        acc = conv2d_int8(q, qk, stride, pad) - got
        exact = torch.nn.functional.conv2d(
            (q.double() - torch.from_numpy(z).double()).permute(0, 3, 1, 2),
            qk.double().permute(3, 2, 0, 1), stride=stride, padding=pad).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(acc.numpy(), exact.round().to(torch.int32).numpy(),
                                      err_msg=path)
        strided += stride != (1, 1)
        padded += pad != (0, 0)
    record_property("shapes", len(shapes))
    record_property("strided", strided)
    record_property("padded", padded)
    assert strided and padded and len(shapes) > 10


# ------------------------------------------------------------ the chains


def _chains(net, frames, monkeypatch, scales, **options):
    """(recorder, JAX decode, port decode) of both chain pipelines of
    ``net`` with ``options`` (``ranges``, ``wq_override``, ``f32_paths``),
    from JAX's float maps.  The pipeline builders of both stacks take no
    such options: the port's chain forward gets them through its
    ``ChainCtx``, as the script builds it, and JAX's through its keywords."""
    ctx = ChainCtx(net.port, scales, dtype=torch.bfloat16, join_dtype=None, impl="plain",
                   path_of=net.path_of, **options)
    if net.name == "centernet":
        forward = "dla34_chain_forward"
        pipe = make_centernet_pipeline(port_chain.dla34_chain_forward(ctx),
                                       centernet_config(64, 128)[1], "cpu", ALL_SLOTS,
                                       impl="plain", dtype=torch.bfloat16)
    else:
        forward = "yolact_chain_forward"
        pipe = make_yolact_pipeline(port_chain.yolact_chain_forward(ctx), net.port.config,
                                    "cpu", ALL_SLOTS, impl="plain", dtype=torch.bfloat16)
    monkeypatch.setattr(jax_chain, forward,
                        functools.partial(getattr(jax_chain, forward), **options))
    with ChainRecorder(jax_chain, port_chain, net.stem, from_jax="float") as rec:
        want = net.jax_pipeline(scales, None, None)(jnp.asarray(frames))
        got = pipe(frames)
    monkeypatch.undo()
    return rec, want, got


def _assert_chains(net, rec, want, got, record_property, tag=""):
    """Every int8 map equal, every dequantized map within
    ``QUANTIZED_ULPS``, the port's float convs within ``FLOAT_ULPS``, the
    decodes 100% matched at threshold 0 with every p95 within
    ``DECODE_P95``; returns the number of int8 maps."""
    assert set(rec.maps["port"]) == set(rec.maps["jax"]) - net.jax_only
    assert not any(rec.code_diffs.values()), rec.code_diffs
    n_int8 = 0
    for path, g in rec.maps["port"].items():
        w = rec.maps["jax"][path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=f"{net.name} {path}")
            n_int8 += 1
        elif path not in rec.float_errs:
            err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
            assert err <= QUANTIZED_ULPS, (net.name, path, err)
    stats = detection_deltas(want, got, score_threshold=0.0)
    record_property(f"{tag}int8_maps", n_int8)
    record_property(f"{tag}port_vs_jax", stats)
    assert stats["total"] == got.valid.numel() and stats["matched_fraction"] == 1.0, stats
    for what in ("center", "score", "size"):
        assert stats[f"{what}_delta_p95"] <= DECODE_P95, (net.name, stats)
    return n_int8


@pytest.mark.parametrize("name", ["centernet", "yolact"])
def test_torch_asym_chain_matches_jax(nets, frames, name, monkeypatch, record_property):
    net = nets[name]
    scales = jax_scales(net)
    ranges = {p: r for p, r in jax_ranges(net).items()
              if p in scales and not any(s in p for s in SYMMETRIC)}
    if name == "yolact":
        with torch.inference_mode():
            img = _nchw(net.jax_img).to(torch.bfloat16)
        ranges.update(upsample_ranges(net.port, [img]))
    rec, want, got = _chains(net, frames, monkeypatch, scales, ranges=ranges)
    float_err = max(rec.float_errs.values(), default=0.0)
    record_property("asymmetric_paths", len(ranges))
    record_property("float_convs_max_err_of_largest", float_err)
    assert float_err <= FLOAT_ULPS
    assert _assert_chains(net, rec, want, got, record_property) > 0
    if name == "yolact":
        # Both transposed convs read asymmetric int8 codes.
        for path in ("protonet/pre_0", "protonet/mid_0"):
            assert rec.maps["port"][path].dtype == np.int8, path


# ------------------------------------------------------------ f32 heads


def test_torch_f32_heads_match_jax(nets, frames, monkeypatch, record_property):
    """The ladder's ``ida-int8+f32heads``: IDA and DLAUp int8, the trunk
    float in bf16, the heads float in f32 (``f32_paths=("head_",)``): each
    head conv's own f32 output within ``F32_CONV_RTOL`` of the largest
    value of JAX's on JAX's input."""
    net = nets["centernet"]
    scales = strip_scales(jax_scales(net), ("head_", "base"))
    rec, want, got = _chains(net, frames, monkeypatch, scales, f32_paths=("head_",))
    heads = {k: v for k, v in rec.float_errs.items() if "head_" in k}
    assert len(heads) == 2 * len(get_head_channels(net.port.object_config))
    assert all(rec.maps["port"][k].dtype == np.float32 for k in heads)
    record_property("head_convs_max_err_of_largest", max(heads.values()))
    for k, err in heads.items():
        assert err <= F32_CONV_RTOL, (k, err)
    others = [v for k, v in rec.float_errs.items() if k not in heads]
    assert max(others) <= FLOAT_ULPS
    _assert_chains(net, rec, want, got, record_property)


# ------------------------------------------------- sequential, mean mode


@pytest.mark.parametrize("name", ["centernet", "yolact"])
def test_torch_calibrate_sequential_mean_matches_jax(nets, frames, name, record_property):
    """``mode="mean"`` on JAX's maps (``from_jax="all"``): gains all 1 in
    both stacks; each offset ``mean(target) - mean(accumulator)`` within
    ``SEQ_RTOL`` of the two terms' sizes, as the affine fit's test holds
    them."""
    net = nets[name]
    scales = jax_scales(net)
    build = port_forward(net, port_chain.dla34_chain_forward if name == "centernet"
                         else port_chain.yolact_chain_forward)
    with ChainRecorder(jax_chain, port_chain, net.stem, from_jax="all") as rec:
        want_gains, want_corr = jax_chain.calibrate_sequential(
            net.jax_forward, net.variables, scales, jnp.asarray(frames), mode="mean")
        gains, corr = port_chain.calibrate_sequential(
            build, net.port, scales, frames, mode="mean", dtype=torch.bfloat16,
            path_of=net.path_of, impl="plain")
    assert set(gains) == set(corr) == set(want_gains) - net.jax_only
    worst = 0.0
    for path in gains:
        assert np.all(gains[path] == 1) and np.all(want_gains[path] == 1), path
        target = rec.captures[path].astype(np.float64)
        c, wc = np.asarray(corr[path], np.float64), np.asarray(want_corr[path], np.float64)
        target_mean = target.mean(axis=(0, 1, 2))
        size = np.abs(target).mean(axis=(0, 1, 2)) + np.abs(target_mean - wc)
        err = float(np.max(np.abs(c - wc) / size))
        worst = max(worst, err)
        assert err <= SEQ_RTOL, (path, err)
    record_property("max_err", worst)
    with pytest.raises(ValueError):
        port_chain.calibrate_sequential(build, net.port, scales, frames, mode="median",
                                        path_of=net.path_of, impl="plain")
