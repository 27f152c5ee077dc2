"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and
skips without one.  The file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: peak decode index/label exact and score 1e-6; mask assembly
1e-5 (an 8- or 32-term dot summed in another order); depthwise upsample rtol =
atol = 1e-5 (4 f32 taps in another order than cuDNN), in bf16 one bf16
ulp (the same f32 sum, rounded once); probe P1's dots 1e-4 (f32 sums of
exact bf16 products in another order), its copies exact; deformable conv
in f32 rtol = atol = 1e-4 (9 C f32 products an output, up to 4,608 at the
served shapes, summed in another order than the plain per-tap GEMMs, on
3xTF32 products), in bf16 one bf16 ulp plus the f32 accumulation-order
term (``assert_dcn_close``), at the 7 served shapes and a ragged tile;
its lerp body (``variant="lerp"``, ``bench.py --dcn-bound`` at R <= 1)
by the same bars, on offsets bounded by ``R tanh`` and at exactly 0 and
+-1, at R = 1 and 0.5.
Exact: the int8 transposed conv (integer sums, the same fused
multiply-add epilogue; at the served shapes and at ragged column and
channel tiles), the chain's integer conv core against the
float64 conv (also at 1-17 rows, where ``torch._int_mm`` takes zero
rows added, and at 1, 2 and 4 output channels, padded to 8), and probe
P2 (small integers).  The CenterNet int8 chain at 640x360, batch 2, on
the kernels against the plain versions: kernels C and E in bf16 at each
of its calls, on the chain's own inputs, within the bars above, and with
plain IDA every int8 code and head equal.
"""

import numpy as np
import pytest
import torch

from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import (
    CHAIN_INT8,
    DCN_CHAIN_INT8,
    centernet_config,
    keypoints_config,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34, DeformConvBlock
from tauv_vision_tpu_torch.models.layers import init_parameters
from tauv_vision_tpu_torch.ops.conv_transpose import (
    depthwise_upsample,
    depthwise_upsample_cuda,
)
from tauv_vision_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_cuda
from tauv_vision_tpu_torch.ops.int8_conv import conv2d_int8, conv2d_int8_f64
from tauv_vision_tpu_torch.ops.masks import assemble_mask_batch, assemble_mask_cuda
from tauv_vision_tpu_torch.ops.peaks import peak_decode, peak_decode_cuda
from tauv_vision_tpu_torch.ops.transpose_conv import (
    kernel_taps,
    transpose_conv2x_int8,
    transpose_conv2x_int8_cuda,
)
from tauv_vision_tpu_torch.scripts import op_probe
from tauv_vision_tpu_torch.scripts.int8_dot_probe import dot_probe, dot_probe_cuda, inputs
from tauv_vision_tpu_torch.serving import quantize_chain
from tauv_vision_tpu_torch.serving.quantize import calibrate
from tauv_vision_tpu_torch.weights import centerpoint_calibration_paths, centerpoint_flax_path

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _planted_ties(shape):
    x = _normal(shape, 7, 3.0) - 6.0
    x[:, 2, 3, 4] = 20.0       # sigmoid == 1.0 exactly in f32
    x[:, 0, 10, 20] = 25.0
    x[:, 1, 5, 5] = 30.0
    x[:, 0, 15, 8] = x[:, 0, 15, 9] = 12.0   # a 2-cell plateau
    return x


def _band_ties(shape):
    """Saturated cells and plateaus on both sides of kernel A's 16-row band
    edges, in several channels: equal scores from different tiles."""
    x = _normal(shape, 8, 3.0) - 6.0
    x[:, 2, 15, 4] = 20.0
    x[:, 0, 16, 100] = 25.0
    x[:, 1, 31, 7] = 30.0
    x[:, 3, 32, 60] = 40.0
    x[:, 3, 47:49, 120] = 12.0   # a plateau across a band edge
    x[:, 1, 63, 30:32] = 12.0
    return x


def _sparse(shape):
    """3 positive cells (sigmoid(-200) is 0 in f32): fewer than K peaks, so
    the zeros tie and go to the smallest flat index."""
    x = torch.full(shape, -200.0)
    x[:, 1, 0, 0] = 2.0
    x[:, 2, 16, shape[3] - 1] = 3.0
    x[:, 0, shape[2] - 1, 80] = 1.0
    return x


def _net_heatmap():
    oc, cfg = centernet_config(72, 104)
    net = CenterpointDLA34(oc, generator=torch.Generator().manual_seed(0), device="cpu").eval()
    with torch.inference_mode():
        return net(_normal((2, 3, cfg.in_h, cfg.in_w), 9)).heatmap_nchw().contiguous()


def _keypoint_heatmap():
    """The keypoint net's (``configs.keypoints_config``) keypoint heatmap,
    [2, 8, 18, 26]."""
    oc, cfg, _ = keypoints_config(72, 104)
    net = CenterpointDLA34(oc, generator=torch.Generator().manual_seed(0), device="cpu").eval()
    with torch.inference_mode():
        return net(_normal((2, 3, cfg.in_h, cfg.in_w), 9)).keypoint_heatmap_nchw().contiguous()


PEAK_CASES = {
    "random": lambda shape: _normal(shape, 0, 3.0),
    "ties": _planted_ties,
    "band_ties": _band_ties,
    "sparse": _sparse,
    "flat": torch.zeros,           # every cell 0.5 and a peak: the full tile sort
    "net_heatmap": lambda shape: _net_heatmap(),
    "keypoint_heatmap": lambda shape: _keypoint_heatmap(),
}


@pytest.mark.parametrize("name,shape,k,kernel_size", [
    ("random", (2, 3, 24, 32), 7, 3),
    ("random", (8, 4, 90, 160), 10, 3),     # the main path
    ("random", (8, 4, 90, 160), 1, 3),
    ("random", (1, 4, 90, 160), 128, 3),
    ("random", (2, 3, 37, 300), 10, 3),     # H not a multiple of 16, two column tiles
    ("random", (2, 3, 37, 300), 128, 3),
    ("random", (2, 4, 90, 160), 10, 5),     # a 5x5 window
    ("random", (2, 4, 90, 160), 10, 1),     # no suppression
    ("ties", (2, 3, 24, 32), 12, 3),
    ("band_ties", (2, 4, 90, 160), 10, 3),
    ("band_ties", (2, 4, 90, 160), 128, 3),
    ("sparse", (2, 4, 90, 160), 10, 3),
    ("sparse", (2, 4, 90, 160), 128, 3),
    ("flat", (2, 4, 90, 160), 128, 3),
    ("net_heatmap", None, 10, 3),
    ("net_heatmap", None, 128, 3),
    # the keypoints path: the object heatmap (C = 1, K = 10) and the
    # keypoint heatmap (C = 8, K = 50) at batch 16
    ("random", (16, 1, 90, 160), 10, 3),
    ("random", (16, 1, 90, 160), 50, 3),
    ("random", (16, 8, 90, 160), 10, 3),
    ("random", (16, 8, 90, 160), 50, 3),
    ("sparse", (2, 8, 90, 160), 50, 3),
    ("keypoint_heatmap", None, 50, 3),
])
def test_torch_peak_decode_kernel_on_card(cuda, name, shape, k, kernel_size):
    x = PEAK_CASES[name](shape).to(cuda)
    before = kernels.LAUNCHES["peak_decode"]
    got = peak_decode_cuda(x, k, kernel_size)
    want = peak_decode(x, k, kernel_size)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["peak_decode"] == before + 1
    assert kernels.VARIANT_LAUNCHES[("peak_decode", f"K={k}")] >= 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("p,w", [(8, 320), (32, 320), (8, 78)], ids=["p8", "p32", "w78"])
@pytest.mark.parametrize("crop", [True, False])
def test_torch_assemble_mask_kernel_on_card(cuda, crop, p, w, layout):
    b, k, h = 2, 20, 180
    rng = np.random.default_rng(1)
    proto = _normal((b, h, w, p), 2).to(cuda).permute(0, 3, 1, 2)   # the NHWC view
    if layout == "nchw":
        proto = proto.contiguous()
    coeff = torch.tanh(_normal((b, k, p), 3)).to(cuda)
    box = torch.from_numpy(np.concatenate(
        [rng.uniform(0.0, 1.0, (b, k, 2)), rng.uniform(0.0, 0.6, (b, k, 2))], -1
    ).astype(np.float32)).to(cuda) if crop else None
    before = kernels.LAUNCHES["mask_assembly"]
    got = assemble_mask_cuda(proto, coeff, box)
    want = assemble_mask_batch(proto, coeff, box)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mask_assembly"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("b", [16, 1])
def test_torch_assemble_belief_kernel_on_card(cuda, b, layout):
    """The YOLO-Pose decode's call: 10 detections x 9 keypoints against 16
    belief prototypes at 30x60, no crop."""
    k, p, h, w = 90, 16, 30, 60
    proto = _normal((b, h, w, p), 4).to(cuda).permute(0, 3, 1, 2)   # the NHWC view
    if layout == "nchw":
        proto = proto.contiguous()
    coeff = torch.tanh(_normal((b, k, p), 5)).to(cuda)
    before = kernels.VARIANT_LAUNCHES.get(("mask_assembly", "no crop"), 0)
    got = assemble_mask_cuda(proto, coeff)
    want = assemble_mask_batch(proto, coeff)
    torch.cuda.synchronize()
    assert kernels.VARIANT_LAUNCHES[("mask_assembly", "no crop")] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# Served shapes (f = 2 and 4 at batch 2) and f = 8, ragged row ends (Wo =
# 14, 20 and 26: not a multiple of an 8-output run), rows wider than one
# 256-column band (Wo = 300), and f = 1.
UPSAMPLE_CASES = [
    (2, 45, 80, 64), (4, 23, 40, 64), (8, 12, 20, 64), (2, 12, 20, 256), (2, 23, 40, 128),
    (2, 5, 7, 8), (4, 3, 5, 16), (2, 5, 13, 8), (8, 3, 5, 16), (2, 4, 150, 8), (1, 5, 7, 8),
]


@pytest.mark.parametrize("f,h,w,c", UPSAMPLE_CASES)
def test_torch_depthwise_upsample_kernel_on_card(cuda, f, h, w, c):
    x = _normal((2, c, h, w), 4).to(cuda)
    weight = _normal((c, 1, 2 * f, 2 * f), 5).to(cuda)
    got = depthwise_upsample_cuda(x, weight, f)
    want = depthwise_upsample(x, weight, f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f,h,w,c", UPSAMPLE_CASES)
def test_torch_depthwise_upsample_bf16_kernel_on_card(cuda, f, h, w, c):
    x = _normal((2, c, h, w), 4).to(torch.bfloat16).to(cuda)
    weight = _normal((c, 1, 2 * f, 2 * f), 5).to(torch.bfloat16).to(cuda)
    before = kernels.ENTRY_LAUNCHES["tauv_depthwise_upsample_bf16"]
    got = depthwise_upsample_cuda(x, weight, f)
    want = depthwise_upsample(x, weight, f)
    torch.cuda.synchronize()
    assert kernels.ENTRY_LAUNCHES["tauv_depthwise_upsample_bf16"] == before + 1
    assert got.dtype == want.dtype == torch.bfloat16
    mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((got.float() - want.float()).abs() <= ulp).all())
    assert torch.equal(want.cpu(), depthwise_upsample(x.cpu(), weight.cpu(), f))


@pytest.mark.parametrize("k,m,n", op_probe.DOT_SHAPES)
def test_torch_op_probe_dot_on_card(cuda, k, m, n):
    w, x = op_probe.dot_inputs(m, k, n, cuda)
    before = kernels.LAUNCHES["op_probe"]
    for n_iter in (1, 6):
        got = op_probe.dot_cuda(w, x, n_iter)
        want = op_probe.dot(w, x, n_iter)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert kernels.LAUNCHES["op_probe"] == before + 2


@pytest.mark.parametrize("n_iter", [1, 6, 17])
def test_torch_op_probe_copies_on_card(cuda, n_iter):
    xc, xd, xt = (op_probe.copy_input(cuda), op_probe.decimate_input(cuda),
                  op_probe.transpose_input(cuda))
    pairs = [(op_probe.slice_copy_cuda(xc, n_iter), op_probe.slice_copy(xc, n_iter)),
             (op_probe.lane_shift_cuda(xc, n_iter), op_probe.lane_shift(xc, n_iter)),
             (op_probe.transpose_cuda(xt, n_iter), op_probe.transpose(xt, n_iter))]
    pairs += [(op_probe.decimate_cuda(xd, n_iter, v), op_probe.decimate(xd, n_iter, v))
              for v in op_probe.DECIMATE_VARIANTS]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.dtype == want.dtype and torch.equal(got, want)


def _dcn_inputs(case, b, c, o, h, w, dtype=torch.float32):
    """x, offset, mask, weight, bias on the CPU; x, mask and weight in
    ``dtype`` (rounded from f32), offset and bias f32.  ``block``: the
    offsets and masks of a seeded DeformConvBlock, as the served net
    makes them; ``planted_40``: offsets uniform in +-40 cells, far past
    the map; ``negative_fraction``: positions in (-1, 0) of the tap,
    where a truncating floor would go wrong; ``no_mask``: the block's
    offsets and no mask."""
    x = _normal((b, c, h, w), 8)
    block = DeformConvBlock(c, o, deform=True)
    init_parameters(block, torch.Generator().manual_seed(9))
    with torch.no_grad():
        offset = block.offset(x)
        mask = torch.sigmoid(block.mask(x))
    rng = np.random.default_rng(10)
    if case == "planted_40":
        offset = torch.from_numpy(rng.uniform(-40, 40, offset.shape).astype(np.float32))
    elif case == "negative_fraction":
        offset = torch.from_numpy(rng.uniform(-1, 0, offset.shape).astype(np.float32))
    bias = _normal((o,), 11, 0.1)
    return (x.to(dtype), offset, None if case == "no_mask" else mask.to(dtype),
            block.conv.weight.detach().clone().to(dtype), bias)


def assert_dcn_close(got, want, c):
    """f32: rtol = atol = 1e-4.  bf16: one bf16 ulp of the larger output,
    plus the f32 accumulation-order term 9 C 2^-24 max|want| (the same
    exact bf16 products summed in another order, then rounded once).
    Returns how many outputs differ."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        return int((got != want).sum())
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    bar = ulp + 9 * c * 2.0 ** -24 * w.abs().max()
    assert bool(((g - w).abs() <= bar).all()), float(((g - w).abs() - bar).max())
    return int((got != want).sum())


# The 7 distinct DCN calls of the served CenterNet (C, O, H, W) at
# batch 2, and a ragged pixel tile with the smallest C and O.
DCN_SHAPES = [(2, 512, 256, 12, 20), (2, 256, 256, 23, 40), (2, 256, 128, 23, 40),
              (2, 128, 128, 45, 80), (2, 128, 64, 45, 80), (2, 64, 64, 90, 160),
              (2, 256, 64, 23, 40), (1, 32, 8, 9, 11)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["block", "planted_40", "negative_fraction", "no_mask"])
@pytest.mark.parametrize("b,c,o,h,w", DCN_SHAPES, ids=lambda v: str(v))
def test_torch_deform_conv_kernel_on_card(cuda, case, b, c, o, h, w, dtype):
    cpu_args = _dcn_inputs(case, b, c, o, h, w, dtype)
    args = [None if a is None else a.to(cuda) for a in cpu_args]
    want = deform_conv2d(*args)
    entry = "tauv_deform_conv_" + ("f32" if dtype == torch.float32 else "bf16")
    before = kernels.ENTRY_LAUNCHES[entry]
    got = deform_conv2d_cuda(*args)
    torch.cuda.synchronize()
    assert kernels.ENTRY_LAUNCHES[entry] == before + 1
    assert_dcn_close(got, want, c)
    assert_dcn_close(got.cpu(), deform_conv2d(*cpu_args), c)
    # Deterministic: the split-K pass adds its partial sums in one order.
    assert torch.equal(deform_conv2d_cuda(*args), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_torch_deform_conv_kernel_every_plan_on_card(cuda, dtype):
    """Every launch plan ``kernel_times --e-plans`` times (pixel tile 64
    or 128, K split 1-8) computes the call within the kernel's bar."""
    b, c, o, h, w = 2, 256, 64, 23, 40
    args = [None if a is None else a.to(cuda) for a in _dcn_inputs("block", b, c, o, h, w, dtype)]
    want = deform_conv2d(*args)
    for bm in (64, 128):
        for split in (1, 2, 4, 8):
            got = deform_conv2d_cuda(*args, launch_plan=(bm, 64, split))
            torch.cuda.synchronize()
            assert_dcn_close(got, want, c)


def _lerp_inputs(case, r, b, c, o, h, w, dtype):
    """``_dcn_inputs("block", ...)`` with the offsets the lerp serves:
    ``bounded``, the block's through ``r tanh(offset / r)`` as
    ``DeformConvBlock.offset_bound`` squashes them; ``integral``, each of
    -1, 0 and +1 (the sign's tie at 0, the far corner at 1);
    ``no_mask``, bounded and no mask."""
    x, offset, mask, weight, bias = _dcn_inputs("block", b, c, o, h, w, dtype)
    if case == "integral":
        rng = np.random.default_rng(12)
        offset = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], offset.shape).astype(np.float32))
    else:
        offset = r * torch.tanh(offset / r)
    return x, offset, None if case == "no_mask" else mask, weight, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["bounded", "integral", "no_mask"])
@pytest.mark.parametrize("r", [1.0, 0.5])
@pytest.mark.parametrize("b,c,o,h,w", DCN_SHAPES, ids=lambda v: str(v))
def test_torch_deform_conv_lerp_kernel_on_card(cuda, r, case, b, c, o, h, w, dtype):
    cpu_args = _lerp_inputs(case, r, b, c, o, h, w, dtype)
    args = [None if a is None else a.to(cuda) for a in cpu_args]
    want = deform_conv2d(*args, max_offset=r, variant="lerp")
    before = kernels.VARIANT_LAUNCHES.get(("deform_conv", "lerp"), 0)
    got = deform_conv2d_cuda(*args, max_offset=r, variant="lerp")
    torch.cuda.synchronize()
    assert kernels.VARIANT_LAUNCHES[("deform_conv", "lerp")] == before + 1
    assert_dcn_close(got, want, c)
    assert_dcn_close(got.cpu(), deform_conv2d(*cpu_args, max_offset=r, variant="lerp"), c)
    assert torch.equal(deform_conv2d_cuda(*args, max_offset=r, variant="lerp"), got)
    if dtype == torch.float32:
        # Where every offset lies within a cell the window's hats compute
        # the same bilinear samples, rounded otherwise in f32 (in bf16 a
        # sample may round to the neighbouring bf16 number).
        assert_dcn_close(deform_conv2d_cuda(*args, max_offset=r), got, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_torch_deform_conv_lerp_kernel_every_plan_on_card(cuda, dtype):
    b, c, o, h, w = 2, 256, 64, 23, 40
    args = [None if a is None else a.to(cuda)
            for a in _lerp_inputs("bounded", 1.0, b, c, o, h, w, dtype)]
    want = deform_conv2d(*args, max_offset=1.0, variant="lerp")
    for bm in (64, 128):
        for split in (1, 2, 4, 8):
            got = deform_conv2d_cuda(*args, max_offset=1.0, variant="lerp",
                                     launch_plan=(bm, 64, split))
            torch.cuda.synchronize()
            assert_dcn_close(got, want, c)


def _codes(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["leaky", "relu", "none"])
@pytest.mark.parametrize("b,h,w,c,o", [
    (2, 45, 80, 256, 256),   # the first protonet upsample of the served net
    (8, 90, 160, 256, 256),  # the second, at the served batch
    (1, 5, 7, 32, 32),       # ragged column and channel tiles
    (2, 9, 33, 64, 40),      # O not a multiple of the 64-channel tile
    (2, 6, 100, 96, 72),     # W = 80 + 20: a whole and a ragged column tile
])
def test_torch_transpose_conv_kernel_on_card(cuda, b, h, w, c, o, act, out_dtype):
    rng = np.random.default_rng(12)
    x, qk = _codes((b, h, w, c), 13), _codes((3, 3, c, o), 14)
    deq = torch.from_numpy(rng.uniform(1e-6, 1e-5, o).astype(np.float32))
    bias = _normal((o,), 15)
    scale = torch.from_numpy(rng.uniform(0.01, 0.1, o).astype(np.float32))
    args = [t.to(cuda) for t in (x, qk, deq, bias, scale)]
    before = kernels.LAUNCHES["transpose_conv"]
    got = transpose_conv2x_int8_cuda(*args, act=act, out_dtype=out_dtype)
    want = transpose_conv2x_int8(*args, act=act, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["transpose_conv"] == before + 1
    assert got.shape == (b, 2 * h, 2 * w, o) and got.dtype == out_dtype
    assert torch.equal(got, want)
    if x.numel() <= 2 * 45 * 80 * 256:   # the float64 conv on the CPU is slow past that
        assert torch.equal(got.cpu(), transpose_conv2x_int8(x, qk, deq, bias, scale, act=act,
                                                            out_dtype=out_dtype))
    prebuilt = transpose_conv2x_int8_cuda(*args, act=act, out_dtype=out_dtype,
                                          taps=kernel_taps(args[1]))
    assert torch.equal(prebuilt, want)


@pytest.mark.parametrize("b,h,w,c,o,k,stride,padding", [
    (2, 45, 80, 256, 256, 3, 1, 1),   # protonet pre_0
    (2, 23, 40, 128, 256, 3, 2, 1),   # a stride-2 ResNet conv1
    (2, 23, 40, 128, 256, 1, 2, 0),   # its downsample conv
    (2, 12, 20, 512, 256, 1, 1, 0),   # an FPN lateral
])
def test_torch_conv2d_int8_on_card(cuda, b, h, w, c, o, k, stride, padding):
    q, qk = _codes((b, h, w, c), 16).to(cuda), _codes((k, k, c, o), 17).to(cuda)
    got = conv2d_int8(q, qk, stride, padding)
    want = conv2d_int8_f64(q, qk, stride, padding)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("b,h,w,c,k,stride,padding", [
    (1, 1, 1, 64, 1, 1, 0),      # 1 row
    (1, 3, 5, 256, 1, 1, 0),     # 15 rows: a batch-1 frame's last FPN level
    (1, 6, 10, 256, 3, 2, 1),    # 15 rows from a 3x3 stride-2 conv
    (1, 4, 4, 128, 3, 1, 1),     # 16 rows
    (1, 1, 17, 32, 1, 1, 0),     # 17 rows: torch._int_mm's own minimum
])
def test_torch_conv2d_int8_few_rows_on_card(cuda, b, h, w, c, k, stride, padding):
    q, qk = _codes((b, h, w, c), 22).to(cuda), _codes((k, k, c, 64), 23).to(cuda)
    got = conv2d_int8(q, qk, stride, padding)
    want = conv2d_int8_f64(q, qk, stride, padding)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("b,h,w,c,k", [
    (1, 90, 160, 256, 1),    # a CenterNet head's out conv, one camera frame
    (2, 90, 160, 256, 1),
    (1, 3, 5, 256, 1),       # 15 rows as well
    (1, 90, 160, 64, 3),
])
def test_torch_conv2d_int8_narrow_outputs_on_card(cuda, b, h, w, c, k, n):
    q, qk = _codes((b, h, w, c), 24).to(cuda), _codes((k, k, c, n), 25).to(cuda)
    got = conv2d_int8(q, qk, 1, (k - 1) // 2)
    want = conv2d_int8_f64(q, qk, 1, (k - 1) // 2)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (b, h, w, n) and torch.equal(got, want)


def _chain_calls(forward, model, img):
    """One chain forward's kernel C inputs (x, weight, factor) and kernel E
    inputs (x, offset, mask, weight, bias), recorded on its plain
    versions."""
    up_calls, dcn_calls = [], []
    plain = quantize_chain.depthwise_upsample

    def record(x, w, f):
        up_calls.append((x.clone(), w, f))
        return plain(x, w, f)

    hooks = [m.register_forward_pre_hook(lambda m, a: dcn_calls.append(
        (*(t.clone() for t in a), m.weight.detach().to(a[0].dtype), m.bias.detach())))
        for m in model.deform_convs()]
    quantize_chain.depthwise_upsample = record
    try:
        heads = forward(img)
    finally:
        quantize_chain.depthwise_upsample = plain
        for h in hooks:
            h.remove()
    return heads, up_calls, dcn_calls


@pytest.mark.parametrize("recipe", [CHAIN_INT8, DCN_CHAIN_INT8], ids=["plain_ida", "dcn"])
def test_torch_centernet_chain_kernels_on_card(cuda, recipe):
    oc, mc = centernet_config()
    net = CenterpointDLA34(oc, generator=torch.Generator().manual_seed(0), device=cuda,
                           **recipe.centernet_kwargs()).eval()
    img = _normal((2, 3, mc.in_h, mc.in_w), 30).to(cuda).to(recipe.input_dtype)
    scales = calibrate(net, [img], paths_of=centerpoint_calibration_paths)
    forward = {impl: quantize_chain.dla34_chain_forward(quantize_chain.ChainCtx(
        net, scales, dtype=recipe.input_dtype, join_dtype=None, impl=impl,
        path_of=centerpoint_flax_path)) for impl in ("kernel", "plain")}
    plain_heads, up_calls, dcn_calls = _chain_calls(forward["plain"], net, img)
    assert len(up_calls) == 8 and len(dcn_calls) == (16 if recipe.centernet.deform else 0)
    for x, w, f in up_calls:
        assert x.dtype == torch.bfloat16
        got, want = depthwise_upsample_cuda(x, w, f), depthwise_upsample(x, w, f)
        mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((got.float() - want.float()).abs() <= ulp).all())
    for x, offset, mask, w, bias in dcn_calls:
        assert x.dtype == mask.dtype == torch.bfloat16 and offset.dtype == torch.float32
        assert_dcn_close(deform_conv2d_cuda(x, offset, mask, w, bias),
                         deform_conv2d(x, offset, mask, w, bias), x.shape[1])
    before = dict(kernels.ENTRY_LAUNCHES)
    with torch.inference_mode():
        heads = forward["kernel"](img)
    torch.cuda.synchronize()
    for entry, n in (("tauv_depthwise_upsample_bf16", 8),
                     ("tauv_deform_conv_bf16", len(dcn_calls))):
        assert kernels.ENTRY_LAUNCHES[entry] == before[entry] + n, entry
    for name in ("heatmap", "size", "offset"):
        got, want = getattr(heads, name), getattr(plain_heads, name)
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        if not recipe.centernet.deform:
            assert torch.equal(got, want), name


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_torch_int8_dot_probe_on_card(cuda, dtype):
    a, b = inputs(dtype, cuda)
    before = kernels.LAUNCHES["int8_dot_probe"]
    got = dot_probe_cuda(a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int8_dot_probe"] == before + 1
    assert torch.equal(got.to(torch.int64), dot_probe(a, b))


def test_torch_kernel_wrappers_reject_bad_input(cuda):
    x = _normal((1, 4, 8, 8), 6).to(cuda)
    with pytest.raises(TypeError):
        peak_decode_cuda(x.double(), 3)
    with pytest.raises(ValueError):
        peak_decode_cuda(x.transpose(2, 3), 3)
    with pytest.raises(ValueError):
        depthwise_upsample_cuda(x, torch.ones(4, 1, 3, 3, device=cuda), 2)
    with pytest.raises(TypeError):
        depthwise_upsample_cuda(x.half(), torch.ones(4, 1, 4, 4, device=cuda).half(), 2)
    with pytest.raises(TypeError):
        depthwise_upsample_cuda(x.bfloat16(), torch.ones(4, 1, 4, 4, device=cuda), 2)
    with pytest.raises(ValueError):
        op_probe.dot_cuda(*op_probe.dot_inputs(16, 24, 640, cuda), 1)
    with pytest.raises(ValueError):
        op_probe.slice_copy_cuda(op_probe.copy_input(cuda)[:, :, :640].contiguous(), 1)
    x, offset, mask, weight, bias = (
        a.to(cuda) for a in _dcn_inputs("block", 1, 32, 8, 6, 7))
    with pytest.raises(TypeError):
        deform_conv2d_cuda(x.double(), offset, mask, weight.double(), bias)
    with pytest.raises(TypeError):    # f16: the kernel takes f32 or bf16
        deform_conv2d_cuda(x.half(), offset, mask.half(), weight.half(), bias)
    with pytest.raises(TypeError):    # weight in another dtype than x
        deform_conv2d_cuda(x.bfloat16(), offset, mask.bfloat16(), weight, bias)
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, offset.transpose(2, 3).contiguous().transpose(2, 3),
                           mask, weight, bias)
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, offset, mask.cpu(), weight, bias)
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, offset, mask, weight[:, :, :2, :2].contiguous(), bias)
    with pytest.raises(ValueError):   # C = 48, not a multiple of 32
        deform_conv2d_cuda(*(a.to(cuda) for a in _dcn_inputs("block", 1, 48, 8, 6, 7)))
    with pytest.raises(ValueError):   # O = 320, above 256
        deform_conv2d_cuda(*(a.to(cuda) for a in _dcn_inputs("block", 1, 32, 320, 6, 7)))
    with pytest.raises(ValueError):   # the lerp is exact within one cell only
        deform_conv2d_cuda(x, offset, mask, weight, bias, max_offset=3.0, variant="lerp")
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, offset, mask, weight, bias, variant="lerp")
    with pytest.raises(ValueError):   # f = 3 does not divide the kernel's 8-output run
        depthwise_upsample_cuda(x, torch.ones(4, 1, 6, 6, device=cuda), 3)
    q, qk = _codes((1, 4, 5, 32), 18).to(cuda), _codes((3, 3, 32, 8), 19).to(cuda)
    ones = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        transpose_conv2x_int8_cuda(q.float(), qk, ones, ones, ones)
    with pytest.raises(ValueError):   # C not a multiple of 32
        transpose_conv2x_int8_cuda(q[..., :16].contiguous(), qk[:, :, :16], ones, ones, ones)
    with pytest.raises(ValueError):   # C = 288: taps and stages exceed shared memory
        transpose_conv2x_int8_cuda(_codes((1, 4, 5, 288), 20).to(cuda),
                                   _codes((3, 3, 288, 8), 21).to(cuda), ones, ones, ones)
    with pytest.raises(TypeError):    # taps as the [C/4, 9, O] int32 words of a dp4a layout
        transpose_conv2x_int8_cuda(q, qk, ones, ones, ones,
                                   taps=kernel_taps(qk).view(torch.int32).reshape(8, 9, 8))
    with pytest.raises(ValueError):   # [9, O, C] taps of too few output channels
        transpose_conv2x_int8_cuda(q, qk, ones, ones, ones, taps=kernel_taps(qk)[:, :4].contiguous())
    with pytest.raises(ValueError):   # K = 9 x 4 not a multiple of 8
        conv2d_int8(q[..., :4].contiguous(), qk[:, :, :4].contiguous(), 1, 1)
    proto = _normal((1, 8, 6, 12), 24).to(cuda)
    coeff = torch.ones(1, 3, 8, device=cuda)
    with pytest.raises(ValueError):   # neither NCHW nor the NHWC view
        assemble_mask_cuda(proto.transpose(2, 3), coeff)
