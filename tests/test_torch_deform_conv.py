"""DCNv2 of the PyTorch port against the JAX package.

The port's plain ``deform_conv2d`` (NCHW, torchvision's offset layout,
weight [O, C, 3, 3]) is held to the JAX gather formulation
``ops/deform_conv.deform_conv2d`` (NHWC, weight [3, 3, C, O]) within
atol 2e-5, rtol 1e-4 (the bound of test_torch_dcn_parity.py: 9 C f32
products summed in another order), with offsets in +-2.5, planted
offsets in +-12 that reach past the map, positions in (-1, 0) that a
truncating floor would get wrong, and without a mask.  Where
|offset| <= 2 it is also held to the Pallas kernel in interpret mode
(1e-4, the bound of test_pallas_kernels.py).  ``DeformConvBlock``
(offset and mask convs, the optional tanh bound, the sigmoid mask, BN,
ReLU) is held to the JAX block with ``dcn_impl="gather"``.  Every offset
and mask kernel is random: a zero offset would hide a sampler that
ignores offsets.  Kernel E itself is compared on the card by
test_torch_kernels_cuda.py.

In bf16 the plain version rounds as the Pallas kernel's body does (see
``tauv_vision_tpu_torch/ops/deform_conv.py``) and is held to the Pallas
kernel in interpret mode in bf16, variant "full", |offset| <= 2, with and
without a mask: within one bf16 ulp of the output's largest magnitude
(the f32 sums of exact bf16 products may be taken in another order than
XLA's dot, and one ulp is where the rounding to bf16 could then land);
the outputs that differ are counted (measured: none).  The bf16
``DeformConvBlock`` is held to the JAX block at ``dtype=bf16`` with
``dcn_impl="pallas"``, its Pallas call run in interpret mode by
replacing ``deform_conv2d_pallas`` for the test, to the same bar
(measured: equal).  XLA expands a bf16 sigmoid into bf16 ops, each
rounded, and the port's block does the same.  With unbounded offsets
the JAX block is given a Pallas window (``dcn_max_offset``) that covers
every offset of the data, since the Pallas kernel drops samples past it.
"""

import functools


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tauv_vision_tpu.models.centerpoint_dla import (
    DeformConvBlock as JaxDeformConvBlock,
)
from tauv_vision_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from tauv_vision_tpu.ops.pallas import deform_conv as pallas_deform_conv
from tauv_vision_tpu.ops.pallas.deform_conv import deform_conv2d_pallas
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.models.centerpoint_dla import DeformConvBlock
from tauv_vision_tpu_torch.ops.deform_conv import (
    DeformConv2d,
    deform_conv2d,
    deform_conv2d_cuda,
    kernel_weights,
    plan,
)
from tauv_vision_tpu_torch.params import cast_parameter

SHAPES = [(2, 9, 11, 6, 5), (2, 11, 16, 8, 8)]  # b, h, w, c, o
OFFSETS = {  # case: (low, high) of the uniform offsets
    "within_2.5": (-2.5, 2.5),
    "planted_12": (-12.0, 12.0),
    "no_mask": (-2.5, 2.5),
    "negative_fraction": (-1.0, 0.0),
}


def _inputs(b, h, w, c, o, low, high, seed):
    """NHWC numpy inputs: x, offset [B, H, W, 18], mask, weight HWIO, bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    offset = rng.uniform(low, high, (b, h, w, 18)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, h, w, 9)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, c, o)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    return x, offset, mask, weight, bias


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _port(x, offset, mask, weight, bias):
    out = deform_conv2d(
        _nchw(x), _nchw(offset), None if mask is None else _nchw(mask),
        torch.from_numpy(np.ascontiguousarray(np.transpose(weight, (3, 2, 0, 1)))),
        torch.from_numpy(bias))
    return np.moveaxis(out.numpy(), 1, -1)


@pytest.mark.parametrize("case", list(OFFSETS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_torch_deform_conv_matches_jax_gather(shape, case):
    x, offset, mask, weight, bias = _inputs(*shape, *OFFSETS[case], seed=len(case))
    if case == "no_mask":
        mask = None
    want = jax_deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask), jnp.asarray(weight),
        jnp.asarray(bias), stride=1, padding=1)
    got = _port(x, offset, mask, weight, bias)
    assert got.shape == shape[:3] + (shape[4],)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("with_mask", [True, False])
def test_torch_deform_conv_matches_pallas_interpret(with_mask):
    x, offset, mask, weight, bias = _inputs(2, 11, 16, 8, 8, -2.0, 2.0, seed=3)
    mask = mask if with_mask else None
    want = deform_conv2d_pallas(
        jnp.asarray(x), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask), jnp.asarray(weight),
        jnp.asarray(bias), padding=1, max_offset=2, cols_per_block=8,
        interpret=True)
    np.testing.assert_allclose(_port(x, offset, mask, weight, bias),
                               np.asarray(want), atol=1e-4, rtol=1e-4)


def test_torch_deform_conv_zero_offset_is_plain_conv():
    """Zero offsets and a unit mask reduce DCNv2 to a 3x3 conv: pins the
    tap order and the (dy, dx) channel order."""
    x, _, _, weight, bias = _inputs(1, 8, 8, 4, 3, 0.0, 0.0, seed=5)
    xt = _nchw(x)
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(weight, (3, 2, 0, 1))))
    bt = torch.from_numpy(bias)
    got = deform_conv2d(xt, torch.zeros(1, 18, 8, 8), torch.ones(1, 9, 8, 8), wt, bt)
    torch.testing.assert_close(got, F.conv2d(xt, wt, bt, padding=1),
                               rtol=1e-5, atol=1e-5)
    # A whole-cell offset of +1 in x on every tap moves the 3x3 window one
    # column right: columns x .. x + 2 of the input, zero past its edge.
    offset = torch.zeros(1, 18, 8, 8)
    offset[:, 1::2] = 1.0
    torch.testing.assert_close(deform_conv2d(xt, offset, None, wt, bt),
                               F.conv2d(F.pad(xt, (0, 2, 1, 1)), wt, bt),
                               rtol=1e-5, atol=1e-5)


def _torch_inputs(*args, **kwargs):
    x, offset, mask, weight, bias = _inputs(*args, **kwargs)
    return (_nchw(x), _nchw(offset), _nchw(mask),
            torch.from_numpy(np.ascontiguousarray(np.transpose(weight, (3, 2, 0, 1)))),
            torch.from_numpy(bias))


def test_torch_deform_conv_wrapper_takes_plain_on_cpu():
    x, offset, mask, weight, bias = _torch_inputs(2, 9, 11, 6, 5, -2.5, 2.5, seed=6)
    before = dict(kernels.LAUNCHES)
    got = deform_conv2d_cuda(x, offset, mask, weight, bias)
    assert kernels.LAUNCHES == before
    assert torch.equal(got, deform_conv2d(x, offset, mask, weight, bias))
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, offset, mask, weight[:, :5], bias)   # C mismatch
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, offset, mask, weight.repeat(1, 1, 2, 2), bias)  # 6x6
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, offset[:, :9], mask, weight, bias)
    with pytest.raises(ValueError):
        DeformConv2d(6, 5, impl="fast")


def _randomize_block(variables, c, seed):
    """Random offset and mask convs, DCN weight, BN parameters and stats."""
    rng = np.random.default_rng(seed)
    params = {k: dict(v) if isinstance(v, dict) else v
              for k, v in variables["params"].items()}
    fan = np.sqrt(9 * c)
    for name, n_out, scale in (("offset", 18, 1.5), ("mask", 9, 1.0)):
        params[name] = {
            "kernel": (rng.standard_normal((3, 3, c, n_out)) * scale / fan).astype(np.float32),
            "bias": rng.uniform(-1, 1, n_out).astype(np.float32),
        }
    o = params["bias"].shape[0]
    params["weight"] = (rng.standard_normal((3, 3, c, o)) / fan).astype(np.float32)
    params["bias"] = rng.standard_normal(o).astype(np.float32)
    params["bn"] = {"scale": rng.uniform(0.5, 1.5, o).astype(np.float32),
                    "bias": rng.uniform(-0.3, 0.3, o).astype(np.float32)}
    stats = {"bn": {"mean": rng.uniform(-0.3, 0.3, o).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, o).astype(np.float32)}}
    return {"params": params, "batch_stats": stats}


def _block_state_dict(variables):
    p, s = variables["params"], variables["batch_stats"]

    def oihw(k):
        return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))

    return {
        "offset.weight": oihw(p["offset"]["kernel"]),
        "offset.bias": torch.from_numpy(p["offset"]["bias"]),
        "mask.weight": oihw(p["mask"]["kernel"]),
        "mask.bias": torch.from_numpy(p["mask"]["bias"]),
        "conv.weight": oihw(p["weight"]),
        "conv.bias": torch.from_numpy(p["bias"]),
        "actf.0.weight": torch.from_numpy(p["bn"]["scale"]),
        "actf.0.bias": torch.from_numpy(p["bn"]["bias"]),
        "actf.0.running_mean": torch.from_numpy(s["bn"]["mean"]),
        "actf.0.running_var": torch.from_numpy(s["bn"]["var"]),
        "actf.0.num_batches_tracked": torch.tensor(0),
    }


@pytest.mark.parametrize("offset_bound", [None, 1.0])
def test_torch_deform_conv_block_matches_jax(offset_bound):
    b, h, w, c, o = 2, 9, 11, 8, 6
    x = np.random.default_rng(7).standard_normal((b, h, w, c)).astype(np.float32)
    block = JaxDeformConvBlock(o, deform=True, dcn_impl="gather",
                               offset_bound=offset_bound)
    variables = _randomize_block(block.init(
        jax.random.key(0), jnp.asarray(x), train=False), c, seed=8)
    want = np.asarray(block.apply(variables, jnp.asarray(x), train=False))

    port = DeformConvBlock(c, o, deform=True, offset_bound=offset_bound).eval()
    port.load_state_dict(_block_state_dict(variables), strict=True)
    offsets = []
    port.conv.register_forward_pre_hook(lambda m, args: offsets.append(args[1]))
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    reach = offsets[0].abs().max().item()
    if offset_bound is None:
        assert reach > 2.0, reach    # samples move by whole cells, off the map
    else:
        assert 0.5 < reach < offset_bound, reach
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def _bf16_ulp(a):
    """One bf16 ulp at the largest magnitude of ``a``."""
    return float(2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7))


def _bf16(a):
    """numpy f32 -> the nearest bf16 values, as f32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("shape", [(2, 11, 16, 8, 8), (2, 9, 13, 32, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_torch_deform_conv_bf16_matches_pallas_interpret(shape, with_mask, record_property):
    x, offset, mask, weight, bias = _inputs(*shape, -2.0, 2.0, seed=3)
    x, mask, weight = _bf16(x), _bf16(mask) if with_mask else None, _bf16(weight)
    want = np.asarray(deform_conv2d_pallas(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask).astype(jnp.bfloat16),
        jnp.asarray(weight).astype(jnp.bfloat16), jnp.asarray(bias), padding=1,
        max_offset=2, cols_per_block=8, interpret=True).astype(jnp.float32))
    got = deform_conv2d(
        _nchw(x).to(torch.bfloat16), _nchw(offset),
        None if mask is None else _nchw(mask).to(torch.bfloat16),
        torch.from_numpy(np.ascontiguousarray(np.transpose(weight, (3, 2, 0, 1)))).to(
            torch.bfloat16), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    got = np.moveaxis(got.float().numpy(), 1, -1)
    record_property("outputs_one_ulp_apart", int((got != want).sum()))
    np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp(want))


@pytest.mark.parametrize("offset_bound", [None, 1.0])
def test_torch_deform_conv_block_bf16_matches_jax(offset_bound, monkeypatch, record_property):
    monkeypatch.setattr(pallas_deform_conv, "deform_conv2d_pallas",
                        functools.partial(deform_conv2d_pallas, interpret=True))
    b, h, w, c, o = 2, 9, 11, 32, 16
    x = np.random.default_rng(7).standard_normal((b, h, w, c)).astype(np.float32)
    # The served window (3 cells) where the tanh bounds the offsets; one
    # that covers every offset of these data where they are unbounded.
    window = 3 if offset_bound is not None else 8
    block = JaxDeformConvBlock(o, deform=True, dcn_impl="pallas", dcn_max_offset=window,
                               offset_bound=offset_bound, dtype=jnp.bfloat16,
                               bn_out=jnp.bfloat16)
    variables = _randomize_block(block.init(
        jax.random.key(0), jnp.asarray(x), train=False), c, seed=8)
    want = np.asarray(block.apply(variables, jnp.asarray(x), train=False).astype(jnp.float32))

    port = DeformConvBlock(c, o, deform=True, offset_bound=offset_bound,
                           dtype=torch.bfloat16, bn_out=torch.bfloat16).eval()
    port.load_state_dict(_block_state_dict(variables), strict=True)
    seen = []
    port.conv.register_forward_pre_hook(lambda m, args: seen.append(args))
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1)
    x_in, offset, mask = seen[0]
    assert (x_in.dtype, offset.dtype, mask.dtype, got.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16)
    reach = offset.abs().max().item()
    if offset_bound is None:
        assert 3.0 < reach < window, reach   # past the served window, within this one
    else:
        assert 0.5 < reach <= offset_bound, reach
    got = got.float().numpy()
    record_property("outputs_differ", int((got != want).sum()))
    np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp(want))


def test_torch_deform_conv2d_module_casts_weight_once():
    """``DeformConv2d`` computes in its input's dtype with its f32 weight
    cast once and kept; an in-place update of the weight casts again."""
    conv = DeformConv2d(32, 8)
    x, offset, mask, _, _ = _torch_inputs(1, 5, 6, 32, 8, -1.5, 1.5, seed=12)
    with torch.no_grad():
        out = conv(x.to(torch.bfloat16), offset, mask.to(torch.bfloat16))
        first = conv._cast_cache["weight"][1]
        conv(x.to(torch.bfloat16), offset, mask.to(torch.bfloat16))
        assert conv._cast_cache["weight"][1] is first
        assert out.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
        assert torch.equal(out, deform_conv2d(x.to(torch.bfloat16), offset,
                                              mask.to(torch.bfloat16),
                                              conv.weight.to(torch.bfloat16), conv.bias))
        conv.weight.mul_(2.0)
        conv(x.to(torch.bfloat16), offset, mask.to(torch.bfloat16))
        assert torch.equal(conv._cast_cache["weight"][1], conv.weight.to(torch.bfloat16))
        assert conv(x, offset, mask).dtype == torch.float32


def test_torch_deform_conv_kernel_weights_layout():
    """[O, C, 3, 3] -> [9, BN, C]: tap 3 ky + kx of output o at [t, o],
    zero rows up to the block's output tile."""
    weight = torch.randn(40, 32, 3, 3, generator=torch.Generator().manual_seed(0))
    taps = kernel_weights(weight, torch.bfloat16)
    assert taps.shape == (9, 64, 32) and taps.dtype == torch.bfloat16 and taps.is_contiguous()
    for t in range(9):
        ky, kx = divmod(t, 3)
        assert torch.equal(taps[t, :40], weight[:, :, ky, kx].to(torch.bfloat16))
    assert not taps[:, 40:].any()
    assert kernel_weights(weight[:8]).shape == (9, 64, 32)
    assert kernel_weights(torch.zeros(256, 64, 3, 3)).shape == (9, 256, 64)


@pytest.mark.parametrize("b,c,h,w,o,sms,want", [
    (8, 512, 12, 20, 256, 132, (64, 256, 4)),   # 30 pixel tiles: K split in 4
    (8, 512, 12, 20, 256, 114, (64, 256, 2)),   # fewer SMs hold fewer split blocks
    (8, 256, 23, 40, 256, 132, (64, 256, 1)),   # 115 tiles, one block an SM at BN = 256
    (8, 256, 23, 40, 128, 132, (64, 128, 2)),
    (8, 256, 23, 40, 64, 132, (64, 64, 2)),     # too few pixels for 128-pixel tiles
    (8, 128, 45, 80, 128, 132, (64, 128, 1)),
    (8, 128, 45, 80, 64, 132, (128, 64, 1)),
    (8, 64, 90, 160, 64, 132, (128, 64, 1)),
    (1, 64, 90, 160, 64, 132, (64, 64, 1)),     # batch 1: 225 tiles of 64
])
def test_torch_deform_conv_plan(b, c, h, w, o, sms, want):
    """``plan`` on an H100 SXM (132 SMs) and on a card of 114."""
    assert plan(b, c, h, w, o, torch.bfloat16, sms) == want
    assert plan(b, c, h, w, o, torch.float32, sms) == want


def test_torch_deform_conv_module_keeps_kernel_layout_until_weight_changes():
    """``DeformConv2d``'s kernel layout (``cast_parameter(..., layout=
    kernel_weights)``): without autograd (serving), built once a weight
    version and dtype, beside the plain cast, and built again after an
    in-place update; where autograd records (training), built in the graph
    from the weight on every call, so no cached copy cuts the gradient."""
    conv = DeformConv2d(32, 8)
    with torch.no_grad():
        taps = cast_parameter(conv, "weight", torch.bfloat16, layout=kernel_weights)
        assert cast_parameter(conv, "weight", torch.bfloat16, layout=kernel_weights) is taps
        assert torch.equal(taps, kernel_weights(conv.weight, torch.bfloat16))
        cast = cast_parameter(conv, "weight", torch.bfloat16)
        assert cast.shape == (8, 32, 3, 3) and cast_parameter(
            conv, "weight", torch.bfloat16, layout=kernel_weights) is taps
        f32 = cast_parameter(conv, "weight", torch.float32, layout=kernel_weights)
        assert f32.dtype == torch.float32 and torch.equal(f32, kernel_weights(conv.weight))
        conv.weight.mul_(2.0)
        again = cast_parameter(conv, "weight", torch.bfloat16, layout=kernel_weights)
        assert again is not taps
        assert torch.equal(again, kernel_weights(conv.weight, torch.bfloat16))
    graph = cast_parameter(conv, "weight", torch.bfloat16, layout=kernel_weights)
    assert graph is not again and graph.grad_fn is not None
    assert torch.equal(graph, again)
    graph.float().sum().backward()
    assert conv.weight.grad is not None