"""The port's int8 YOLACT chain against the JAX package's.

The JAX chain is run op by op (``jit=False``, eager), where each op
rounds once, as each PyTorch op of the port does.  Compiled, XLA also
contracts multiply-adds into fused ones, and an int8 chain carries a
one-ulp difference on to a code that differs by one, and that code on to
more.  Kernel D's epilogue is the compiled graph's one fused
multiply-add, as the Pallas kernel has it, so the int8 transpose's float
output is held to the compiled JAX op.

- ``run_layer``, each ported branch on the same input: int8 outputs and
  the quantized branches' float outputs bit-equal; the float branches
  (f32 convs in another summation order) emit int8 and are bit-equal
  there too.
- The small chain of ``tests/test_quantize_chain.py`` (16 wide), with and
  without the protonet upsample scales, in f32 and in bf16 with bf16
  joins.  The float stem conv is the one op whose rounding the port does
  not share: its 147 products are summed in another order, so the port's
  stem is a few ulps from JAX's (held to that), and a code that then
  differs by one spreads through the chain.  So both chains go on from
  JAX's stem output: every int8 map is then equal and every output
  within 2e-4 (measured: f32 1.8e-7 in ``mask_coeff``, 0 elsewhere; bf16
  0).  The FPN's bilinear resize rounds as ``jax.image.resize`` does
  (``ops/image.resize_bilinear_nhwc``), bit for bit in bf16 and f32, and
  so does the pipelines' frame resize (``ops/image.resize_frames``).
- The served recipe at full width (256-wide FPN, 7 classes, 8
  prototypes) at 64x96, batch 2, through ``make_yolact_chain_pipeline``
  on shared weights and scales (per-channel ``calibrate`` of the port's
  f32 forward, the prediction head and ``protonet/output`` stripped, the
  two upsample scales added, int8 transposes), unaltered, stem included:
  in bf16 with bf16 joins (the served dtypes) and in f32, 100% of
  decoded detections matched with every p95 <= 1e-3 (measured: bf16 0,
  f32 1e-6).
- The chain-int8 recipe of ``bench.py --chain-int8``
  (``configs.CHAIN_INT8.yolact``: per-tensor scales, the prediction head
  and ``protonet/output`` int8, f32 joins, bf16 transposes) on the small
  chain from JAX's stem output: every int8 map and every output bit for
  bit, the f32 BatchNorm outputs of its float convs within a few f32 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.ops.image import resize_bilinear as jax_resize_bilinear
from tauv_vision_tpu.ops.image import resize_bilinear_nhwc as jax_resize_bilinear_nhwc
from tauv_vision_tpu.ops.pallas.transpose_conv import transpose_conv2x_int8_xla
from tauv_vision_tpu.serving import quantize_chain as jax_chain
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import CHAIN_INT8, YolactModelConfig, yolact_config
from tauv_vision_tpu_torch.ops.image import preprocess, resize_bilinear_nhwc, resize_frames
from tauv_vision_tpu_torch.serving import quantize_chain as port_chain
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.pipeline import DecodeKnobs
from tauv_vision_tpu_torch.serving.quantize import calibrate, strip_scales
from torch_parity import SMALL_YOLACT, ChainRecorder, upsample_scales, yolact_pair

ALL_SLOTS = DecodeKnobs(confidence_threshold=0.0)
FIELDS = ("classification", "box_encoding", "mask_coeff", "mask_prototype")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# An f32 BatchNorm output against XLA's rsqrt: within 4 f32 ulps of the
# map's largest value.
FLOAT_MAP_ULPS = 2.0 ** -21


@pytest.fixture(scope="module")
def small():
    jax_cfg, jax_model, variables, port = yolact_pair(YolactModelConfig(**SMALL_YOLACT), 0)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    scales = calibrate(port, [xt], per_channel=True)
    return jax_cfg, variables, port, x, xt, scales, upsample_scales(port, [xt])


# (in, out) of the FPN's top-down resizes: the served 640x360 levels,
# the 64x96 and 64x64 test levels (the latter a tie of XLA's contraction
# order), and an odd up- and downsample.
RESIZES = [((23, 40), (45, 80)), ((12, 20), (23, 40)), ((4, 6), (8, 12)), ((4, 4), (8, 8)),
           ((3, 5), (7, 11)), ((8, 8), (5, 7))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw,out_hw", RESIZES, ids=[f"{a}x{b}_{c}x{d}" for (a, b), (c, d) in RESIZES])
def test_torch_resize_bilinear_nhwc_matches_jax(hw, out_hw, dtype):
    """Bit-equal in bf16 and in f32: XLA's first dot sums its two taps
    as one fused multiply-add and its second as two rounded products, and
    the port does the same in float64 with the roundings placed there."""
    jax_dtype, torch_dtype = DTYPES[dtype]
    x = jnp.asarray(np.random.default_rng(hw[0]).normal(size=(2, *hw, 16)), jax_dtype)
    want = np.asarray(jax_resize_bilinear_nhwc(x, out_hw).astype(jnp.float32))
    got = resize_bilinear_nhwc(torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch_dtype),
                               out_hw)
    assert got.dtype == torch_dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


# (frame, resized) sizes: the served 640x480 -> 640x360 (one axis) and
# the tests' 96x80 -> 104x72 (both axes).
FRAME_RESIZES = [((480, 640), (360, 640)), ((80, 96), (72, 104))]


@pytest.mark.parametrize("hw,out_hw", FRAME_RESIZES, ids=["served", "tests"])
def test_torch_resize_frames_matches_jax(hw, out_hw, record_property):
    """The pipelines' frame resize, uint8 NHWC to f32 NCHW, against the
    JAX pipeline's ``resize_bilinear`` of the NCHW view: bit-equal at the
    served size.  At 96 -> 104 columns, compiled XLA computes output
    column 17's sample position (i + 0.5) / scale - 0.5 as one fused
    multiply-add and the other columns' as two roundings (it fuses by
    shape, not by a rule the port can follow), so that column's two
    weights are 16 ulps apart (2.8e-6 relative) and its values within
    4e-6 relative."""
    frames = np.random.default_rng(7).integers(0, 256, (1, *hw, 3), np.uint8)
    img = jnp.moveaxis(jnp.asarray(frames).astype(jnp.float32), -1, -3)
    want = np.asarray(jax_resize_bilinear(img, out_hw))
    got = resize_frames(torch.from_numpy(frames), out_hw).numpy()
    record_property("elements_differ", int((got != want).sum()))
    if out_hw == (360, 640):
        np.testing.assert_array_equal(got, want)
    else:
        columns = np.unique(np.argwhere(got != want)[:, 3])
        assert set(columns.tolist()) <= {17}, columns
        np.testing.assert_allclose(got, want, rtol=4e-6, atol=0)


# name: (path, run_layer arguments, input channels, int8 input, per-channel scales)
RUN_LAYER = {
    "int8_conv_bn_relu_per_tensor": (
        "backbone/layer2_0/conv1", dict(strides=(2, 2), padding=1, bn_path="backbone/layer2_0/bn1",
                                        act="relu", next_path="backbone/layer2_0/conv2"), 64, True, False),
    "int8_conv_bn_relu_per_channel": (
        "backbone/layer2_0/conv1", dict(strides=(2, 2), padding=1, bn_path="backbone/layer2_0/bn1",
                                        act="relu", next_path="backbone/layer2_0/conv2"), 64, True, True),
    "int8_conv_bias_leaky": (
        "fpn/prediction_0", dict(padding=1, act="leaky", next_path="protonet/pre_0"), 16, True, True),
    "int8_conv_bn_float_out": (
        "backbone/layer2_0/conv2", dict(padding=1, bn_path="backbone/layer2_0/bn2"), 128, True, True),
    "int8_conv_bias_dtype_out": ("fpn/lateral_0", dict(padding=0), 128, True, True),
    "int8_transpose_int8_out": (
        "protonet/upsample_1", dict(transpose=True, act="leaky", next_path="protonet/mid_0"), 16, True, True),
    "int8_transpose_float_out": (
        "protonet/upsample_1", dict(transpose=True, act="leaky"), 16, True, True),
    "float_transpose": (
        "protonet/upsample_2", dict(transpose=True, act="leaky", next_path="protonet/post_0"), 16, False, True),
    "float_conv_bn": (
        "prediction_head/shared_0/bottleneck/conv2",
        dict(padding=1, bn_path="prediction_head/shared_0/bottleneck/bn2", act="relu",
             next_path="prediction_head/shared_0/bottleneck/conv3"), 4, False, True),
}
NEXT_CHANNELS = {"backbone/layer2_0/conv2": 128, "protonet/pre_0": 16, "protonet/mid_0": 16,
                 "protonet/post_0": 16, "prediction_head/shared_0/bottleneck/conv3": 4}


@pytest.mark.parametrize("case", list(RUN_LAYER))
def test_torch_run_layer_matches_jax(small, case):
    _, variables, port, *_ = small
    path, kwargs, c, int8_in, per_channel = RUN_LAYER[case]
    rng = np.random.default_rng(len(case))

    def scale(n):
        return rng.uniform(0.01, 0.05, n) if per_channel else float(rng.uniform(0.01, 0.05))

    scales = {} if case.startswith("float") else {path: scale(c)}
    if "next_path" in kwargs:
        scales[kwargs["next_path"]] = scale(NEXT_CHANNELS[kwargs["next_path"]])
    hw = 16 if "layer2_0/conv1" in path or path.endswith("upsample_2") else 8
    x = (rng.integers(-127, 128, (2, hw, hw, c)).astype(np.int8) if int8_in
         else rng.normal(size=(2, hw, hw, c)).astype(np.float32))
    transpose = "int8" if kwargs.get("transpose") else None

    def jax_run(v, inp):
        ctx = jax_chain.ChainCtx(v, scales, dtype=jnp.float32,
                                 int8_transpose="xla" if transpose else None)
        return ctx.run_layer(inp, path, **kwargs)

    ctx = port_chain.ChainCtx(port, scales, dtype=torch.float32, join_dtype=None, impl="plain")
    got = ctx.run_layer(torch.from_numpy(x), path, **kwargs)
    if case == "int8_transpose_float_out":
        # Kernel D's epilogue is the compiled op's fused multiply-add: the
        # compiled JAX op on the JAX chain's own weight quantization.
        module = variables["params"]["protonet"]["upsample_1"]
        qk, deq = jax_chain._wq(module["kernel"], in_scale=scales[path])
        want = jax.jit(lambda *a: transpose_conv2x_int8_xla(*a, act="leaky", out_dtype=jnp.float32))(
            x, qk, deq, module["bias"], jnp.ones(()))
    else:
        want = jax_run(variables, jnp.asarray(x))
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_chain_stem_conv_rounds_as_jax(small, dtype, record_property):
    """The chain's float stem conv alone (no BatchNorm): in f32 PyTorch's
    CPU conv equals XLA's bit for bit, so the stem's few-ulp difference
    (``STEM_RTOL``) comes from the BatchNorm, whose XLA ``rsqrt`` is not
    correctly rounded; in bf16 an f32 conv of the bf16 values rounded once
    equals XLA's, where PyTorch's own bf16 CPU conv rounds a few outputs
    apart (recorded).  The port keeps bf16 convs: on the card they run on
    the tensor cores."""
    _, variables, port, x, *_ = small
    jax_dtype, torch_dtype = DTYPES[dtype]
    ctx = jax_chain.ChainCtx(variables, {}, dtype=jax_dtype)
    want = np.asarray(ctx.run_layer(jnp.asarray(x).astype(jax_dtype), "backbone/conv1",
                                    strides=(2, 2), padding=3).astype(jnp.float32))
    stem = port_chain.ChainCtx(port, {}, dtype=torch_dtype, impl="plain")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch_dtype)
    weight = stem.float_weight("backbone/conv1")
    once = torch.nn.functional.conv2d(xt.float(), weight.float(), stride=2, padding=3)
    np.testing.assert_array_equal(once.to(torch_dtype).float().permute(0, 2, 3, 1).numpy(), want)
    got = stem.run_layer(torch.from_numpy(x).to(torch_dtype), "backbone/conv1", strides=(2, 2),
                         padding=3).float().numpy()
    record_property("port_outputs_differ", int((got != want).sum()))
    if dtype == "f32":
        np.testing.assert_array_equal(got, want)


def _chain_scales(small, with_upsample):
    *_, scales, ups = small
    return {**scales, **ups} if with_upsample else dict(scales)


# The port's own stem against JAX's: the same f32 (bf16) products summed
# in another order, a few ulps apart.
STEM_RTOL = {"f32": 2e-6, "bf16": 2 ** -7}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_upsample", [False, True], ids=["bf16_transposes", "int8_transposes"])
def test_torch_small_chain_matches_jax(small, dtype, with_upsample, record_property):
    """Both chains start from JAX's stem output, then every int8 map is
    equal and every output within 2e-4."""
    jax_cfg, variables, port, x, xt, *_ = small
    jax_dtype, torch_dtype = DTYPES[dtype]
    join = None if dtype == "f32" else jax_dtype
    scales = _chain_scales(small, with_upsample)
    with ChainRecorder(jax_chain, port_chain, "backbone/conv1") as rec:
        want = jax_chain.yolact_chain_forward(
            jax_cfg, variables, scales, dtype=jax_dtype, join_dtype=join,
            int8_transpose="xla" if with_upsample else None)(jnp.asarray(x).astype(jax_dtype))
        got = port_chain.yolact_chain_forward(port_chain.ChainCtx(
            port, scales, dtype=torch_dtype, join_dtype=None if join is None else torch_dtype,
            impl="plain"))(xt)
    stem = rec.stems
    codes = {side: [m for m in maps.values() if m.dtype == np.int8]
             for side, maps in rec.maps.items()}

    np.testing.assert_allclose(stem["port"], stem["jax"], rtol=STEM_RTOL[dtype], atol=1e-6)
    record_property("stem_max_abs_err", float(np.abs(stem["port"] - stem["jax"]).max()))
    # 8 ResNet blocks' conv1 -> conv2 links, the two upsamples and post_0;
    # with the upsample scales also pre_0 and mid_0 emit int8.
    assert len(codes["jax"]) == len(codes["port"]) == (13 if with_upsample else 11)
    for i, (a, b) in enumerate(zip(codes["jax"], codes["port"])):
        np.testing.assert_array_equal(b, a, err_msg=f"int8 map {i}")
    for field in FIELDS:
        w = np.asarray(getattr(want, field)).astype(np.float32)
        g = getattr(got, field).float().numpy()
        record_property(f"{field}_max_abs_err", float(np.abs(g - w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=field)


@pytest.fixture(scope="module")
def full_width():
    cfg = yolact_config(64, 96)
    jax_cfg, _, variables, port = yolact_pair(cfg, 3)
    frames = np.random.default_rng(4).integers(0, 256, (2, 64, 96, 3), np.uint8)
    img = preprocess(torch.from_numpy(frames), (64, 96), cfg.img_mean, cfg.img_stddev)
    scales = strip_scales(calibrate(port, [img], per_channel=True),
                          ("prediction_head", "protonet/output"))
    scales.update(upsample_scales(port, [img]))
    return jax_cfg, variables, port, frames, scales


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_chain_pipeline_matches_jax(full_width, dtype, record_property):
    """bf16 with bf16 joins is the served recipe (the defaults of the
    port's ``make_yolact_chain_pipeline``)."""
    jax_cfg, variables, port, frames, scales = full_width
    jax_dtype, torch_dtype = DTYPES[dtype]
    assert len(scales) == 32 and "protonet/upsample_2" in scales

    want = jax_chain.make_yolact_chain_pipeline(
        jax_cfg, variables, scales, top_k=ALL_SLOTS.top_k,
        iou_threshold=ALL_SLOTS.iou_threshold, confidence_threshold=0.0,
        dtype=jax_dtype, jit=False, int8_transpose="xla", join_dtype=jax_dtype)(jnp.asarray(frames))
    before = dict(kernels.LAUNCHES)
    if dtype == "bf16":
        port_pipeline = port_chain.make_yolact_chain_pipeline(port, scales, "cpu", ALL_SLOTS,
                                                              impl="plain")
    else:
        port_pipeline = port_chain.make_yolact_chain_pipeline(
            port, scales, "cpu", ALL_SLOTS, dtype=torch_dtype, join_dtype=torch_dtype,
            impl="plain")
    got = port_pipeline(frames)
    assert kernels.LAUNCHES == before
    stats = detection_deltas(want, got, score_threshold=0.0)
    record_property("port_vs_jax_eager", stats)
    assert stats["total"] == 40 and stats["matched_fraction"] == 1.0, stats
    for what in ("center", "score", "size"):
        assert stats[f"{what}_delta_p95"] <= 1e-3, stats


def test_torch_yolact_chain_int8_recipe_matches_jax(small, record_property):
    """``CHAIN_INT8.yolact`` on the small YOLACT: per-tensor ``calibrate``
    scales of the port's f32 forward, nothing stripped, f32 joins, bf16
    float ops and transposes.  Every int8 map and every output equal; the
    float maps within ``FLOAT_MAP_ULPS`` of their largest value: in the
    small YOLACT the head's bottleneck conv3 (4 input channels) stays
    float, and its f32 BatchNorm output is a few f32 ulps from XLA's, whose
    ``rsqrt`` is not correctly rounded (measured at most 2.4e-7 on maps up
    to 1.3, on each FPN level; every output equal)."""
    recipe = CHAIN_INT8.yolact
    jax_cfg, variables, port, x, xt, *_ = small
    scales = calibrate(port, [xt], per_channel=recipe.per_channel)
    assert "prediction_head/box" in scales and "protonet/output" in scales
    dtype = jnp.bfloat16
    with ChainRecorder(jax_chain, port_chain, "backbone/conv1") as rec:
        want = jax_chain.yolact_chain_forward(jax_cfg, variables, scales, dtype=dtype,
                                              join_dtype=recipe.join_dtype)(
            jnp.asarray(x).astype(dtype))
        got = port_chain.yolact_chain_forward(port_chain.ChainCtx(
            port, scales, dtype=recipe.dtype, join_dtype=recipe.join_dtype, impl="plain"))(xt)
    assert set(rec.maps["port"]) == set(rec.maps["jax"])
    n_int8, float_err = 0, 0.0
    for path, g in rec.maps["port"].items():
        w = rec.maps["jax"][path]
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=path)
            n_int8 += 1
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_MAP_ULPS * np.abs(w).max(),
                                       err_msg=path)
            float_err = max(float_err, float(np.abs(g - w).max()))
    record_property("int8_maps", n_int8)
    record_property("float_maps_max_abs_err", float_err)
    for field in ("classification", "box_encoding", "mask_coeff", "mask_prototype"):
        np.testing.assert_array_equal(getattr(got, field).float().numpy(),
                                      np.asarray(getattr(want, field)).astype(np.float32),
                                      err_msg=field)
