"""The bf16 CenterNet of the PyTorch port against the JAX package's.

``bench.py`` serves ``CenterpointDLA34`` with ``dtype=bf16``,
``bn_out=bf16`` and an f32 stem (``configs.NORTH_STAR``).  Both stacks
run the same numpy weights (carried over by ``weights.py``) on the same
numpy inputs, on the CPU:

- ``batch_norm(out_dtype)`` against ``_bn``: bf16 outputs bit-equal on
  these inputs; f32 outputs within 2 f32 ulps (XLA's ``rsqrt`` is
  faithfully, not correctly, rounded: one ulp off for about 15% of the
  statistics, and its rounding is not reproduced).
- Each module fed the same input: the stem (f32), level0 and level1 (the
  trunk's inline stages, restated as ``DLATrunk`` writes them), a
  ``BasicBlock``, a ``Root``, a ``Tree``, an ``IDAUpStage`` and a head.
  bf16 outputs equal or within 1 bf16 ulp of the map's largest magnitude:
  a bf16 conv is an f32 sum rounded once, summed in another order than
  XLA's, so an element may round one ulp apart, and where a later op of
  the module sums it with cancellation (a residual join, the next conv)
  the result moves by that ulp, more than one ulp of its own magnitude.
  Measured: level0 1.3e-5 of elements differ, level1 and the IDAUp stage
  none; BasicBlock 4.8e-4, Root 1.7e-5, Tree 5.8e-3, head 5.3e-4.
- The whole net at 72x104, the odd size that reaches ``pad_to_match``'s
  shift: raw heads within ``NET_ATOL``.  One bf16 ulp that differs
  inside the net changes the f32 sums of every output that reads it, so
  differences spread; measured over seeds 0-2: 0.0059, 0.0049, 0.0078
  (worst 0.0078125, 2 bf16 ulps at 0.5), held to twice the worst.
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.centerpoint_dla import (
    BasicBlock as JaxBasicBlock,
    CenterpointDLA34 as JaxCenterpointDLA34,
    IDAUpStage as JaxIDAUpStage,
    Root as JaxRoot,
    Tree as JaxTree,
    _bn,
)
from tauv_vision_tpu_torch.configs import NORTH_STAR, centernet_config
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34, DeformConvBlock
from tauv_vision_tpu_torch.models.layers import batch_norm
from tauv_vision_tpu_torch.weights import centerpoint_state_dict_from_flax
from torch_parity import random_variables

H, W = 72, 104
NET_ATOL = 2 * 0.0078125
BF16, F32 = (jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)
RECIPE = dict(dtype=jnp.bfloat16, bn_out=jnp.bfloat16, f32_stages=("stem",))


def _jax_model(recipe=RECIPE):
    oc, _ = centernet_config(H, W)
    return JaxCenterpointDLA34(object_config=oc, deform=False, **recipe)


@pytest.fixture(scope="module")
def net():
    """(JAX model, numpy variables, the port's model on the same weights)."""
    jax_model = _jax_model()
    variables = random_variables(jax_model, (1, H, W, 3), 0)
    port = CenterpointDLA34(centernet_config(H, W)[0], device="cpu",
                            **NORTH_STAR.centernet_kwargs()).eval()
    port.load_state_dict(centerpoint_state_dict_from_flax(variables))
    return jax_model, variables, port


def _sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        node = variables[col]["model"]
        for key in path:
            node = node.get(key, {})
        out[col] = node
    return out


def _bf16_input(shape, seed, dtype=BF16):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(dtype[0]).astype(jnp.float32))


def _nchw(x, dtype):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _assert_bf16_close(got, want, record_property, name):
    """Within one bf16 ulp of the map's largest magnitude; the share of
    elements that differ at all, and of those that differ by more than
    one ulp of their own magnitude (a sum with cancellation), recorded."""
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    ulp_of = lambda v: 2.0 ** (np.floor(np.log2(np.maximum(v, 2.0 ** -126))) - 7)  # noqa: E731
    own = ulp_of(np.maximum(np.abs(got), np.abs(want)))
    record_property(f"{name}_share_differ", float((got != want).mean()))
    record_property(f"{name}_share_beyond_own_ulp", float((err > own).mean()))
    scale = ulp_of(np.abs(want).max())
    assert err.max() <= scale, (name, float(err.max() / scale), float((got != want).mean()))


class _Bn(nn.Module):
    out_dtype: object

    @nn.compact
    def __call__(self, x):
        return _bn(False, "bn", self.out_dtype)(x)


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("inp", ["bf16", "f32"])
def test_torch_batch_norm_out_dtype_matches_bn(inp, out):
    in_dt, out_dt = (BF16 if inp == "bf16" else F32), (BF16 if out == "bf16" else F32)
    rng = np.random.default_rng(0)
    c = 32
    x = _bf16_input((2, 24, 40, c), 1, in_dt)
    p = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.uniform(-0.1, 0.1, c)}
    s = {"mean": rng.uniform(-0.3, 0.3, c), "var": rng.uniform(0.5, 1.5, c)}
    p, s = ({k: v.astype(np.float32) for k, v in d.items()} for d in (p, s))
    want = _Bn(out_dt[0]).apply({"params": {"bn": p}, "batch_stats": {"bn": s}},
                                jnp.asarray(x).astype(in_dt[0]))
    assert want.dtype == out_dt[0]
    bn = batch_norm(c, out_dt[1]).eval()
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    with torch.inference_mode():
        got = bn(_nchw(x, in_dt[1]))
    assert got.dtype == out_dt[1]
    got, want = _nhwc(got), np.asarray(want.astype(jnp.float32))
    if out == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -23, atol=1e-7)


@pytest.mark.parametrize("a,b", [("bf16", "bf16"), ("bf16", "f32"), ("f32", "bf16"), ("f32", "f32")])
def test_torch_ida_join_promotion_matches_jnp(a, b):
    """``upsampled + layers[i-1]`` (``centerpoint_dla.py:693``) promotes
    as jnp does: bf16 + bf16 stays bf16, and bf16 + f32 is f32."""
    dt = {"bf16": BF16, "f32": F32}
    jax_sum = jnp.zeros(2, dt[a][0]) + jnp.zeros(2, dt[b][0])
    torch_sum = torch.zeros(2, dtype=dt[a][1]) + torch.zeros(2, dtype=dt[b][1])
    assert str(torch_sum.dtype) == f"torch.{jax_sum.dtype}"
    assert torch_sum.dtype == (torch.bfloat16 if a == b == "bf16" else torch.float32)


def test_torch_f32_ida_up_stage_joins_in_f32():
    """An ``ida_up`` named in ``f32_stages`` fed the bf16 ``dla_up`` maps:
    its f32 proj-up output joins the bf16 map in f32, in both stacks."""
    oc, _ = centernet_config(H, W)
    recipe = dict(RECIPE, f32_stages=("stem", "ida_up"))
    variables = random_variables(_jax_model(recipe), (1, H, W, 3), 5)
    port = CenterpointDLA34(oc, device="cpu", dtype=torch.bfloat16, bn_out=torch.bfloat16,
                            f32_stages=("stem", "ida_up")).eval()
    port.load_state_dict(centerpoint_state_dict_from_flax(variables))
    shapes = [(1, 18, 26, 64), (1, 9, 13, 128), (1, 5, 7, 256)]
    layers = [_bf16_input(s, 20 + i) for i, s in enumerate(shapes)]
    stage = JaxIDAUpStage(64, [1, 2, 4], deform=False, up_impl="dilated",
                          dtype=jnp.float32, bn_out=jnp.float32)
    want = stage.apply(_sub(variables, "ida_up"),
                       [jnp.asarray(x).astype(jnp.bfloat16) for x in layers], train=False)
    with torch.inference_mode():
        got = port.model.ida_up([_nchw(x, torch.bfloat16) for x in layers])
    assert [str(t.dtype) for t in want] == ["bfloat16", "float32", "float32"]
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
    np.testing.assert_allclose(_nhwc(got[-1]), np.asarray(want[-1]), rtol=1e-4, atol=1e-4)


class _TrunkStage(nn.Module):
    """One of ``DLATrunk``'s inline stages, as ``centerpoint_dla.py:372-394``
    writes them: conv (no bias) in ``dtype``, ``_bn`` to ``bn_out``, relu."""

    features: int
    kernel: int
    stride: int
    dtype: object
    bn_out: object
    conv_name: str
    bn_name: str

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(self.features, (self.kernel,) * 2, strides=(self.stride,) * 2,
                    padding=self.kernel // 2, use_bias=False, dtype=self.dtype,
                    name=self.conv_name)(x)
        return nn.relu(_bn(False, self.bn_name, self.bn_out)(x))


class _Head(nn.Module):
    """A head as ``DLASeg`` writes it (``centerpoint_dla.py:803-821``)."""

    n_out: int
    dtype: object

    @nn.compact
    def __call__(self, x):
        h = nn.relu(nn.Conv(256, (3, 3), padding=1, dtype=self.dtype, name="head_0_conv")(x))
        return nn.Conv(self.n_out, (1, 1), dtype=self.dtype,
                       name="head_0_out")(h).astype(jnp.float32)


def _trunk_variables(variables, conv, bn):
    sub = _sub(variables, "base")
    return {"params": {conv: sub["params"][conv], bn: sub["params"][bn]},
            "batch_stats": {bn: sub["batch_stats"][bn]}}


# name: (flax module, its variables, port module, input shapes, input dtype)
def _cases(variables, port):
    base, model = port.model.base, port.model
    bf16, f32 = jnp.bfloat16, jnp.float32
    return {
        "stem_f32": (_TrunkStage(16, 7, 1, f32, f32, "base_conv", "base_bn"),
                     _trunk_variables(variables, "base_conv", "base_bn"),
                     base.base_layer, [(2, H, W, 3)], F32),
        "level0": (_TrunkStage(16, 3, 1, bf16, bf16, "level0_conv0", "level0_bn0"),
                   _trunk_variables(variables, "level0_conv0", "level0_bn0"),
                   base.level0, [(2, H, W, 16)], F32),
        "level1": (_TrunkStage(32, 3, 2, bf16, bf16, "level1_conv0", "level1_bn0"),
                   _trunk_variables(variables, "level1_conv0", "level1_bn0"),
                   base.level1, [(2, H, W, 16)], BF16),
        "basic_block": (JaxBasicBlock(64, 2, dtype=bf16, bn_out=bf16),
                        _sub(variables, "base", "level2", "tree1"), base.level2.tree1,
                        [(2, 36, 52, 32), (2, 18, 26, 64)], BF16),
        "root": (JaxRoot(64, False, dtype=bf16, bn_out=bf16),
                 _sub(variables, "base", "level2", "root"), base.level2.root,
                 [(2, 18, 26, 64), (2, 18, 26, 64)], BF16),
        "tree": (JaxTree(1, 32, 64, stride=2, dtype=bf16, bn_out=bf16),
                 _sub(variables, "base", "level2"), base.level2, [(2, 36, 52, 32)], BF16),
        "ida_up_stage": (JaxIDAUpStage(256, [1, 2], deform=False, up_impl="dilated",
                                       dtype=bf16, bn_out=bf16),
                         _sub(variables, "dla_up", "ida_0"), model.dla_up.ida_0,
                         [(2, 5, 7, 256), (2, 3, 4, 512)], BF16),
        "head": (_Head(4, bf16), {"params": {
            "head_0_conv": _sub(variables)["params"]["head_0_conv"],
            "head_0_out": _sub(variables)["params"]["head_0_out"]}},
                 getattr(model, "0"), [(2, 18, 26, 64)], BF16),
    }


CASES = ["stem_f32", "level0", "level1", "basic_block", "root", "tree", "ida_up_stage", "head"]


@pytest.mark.parametrize("case", CASES)
def test_torch_bf16_module_matches_flax(net, case, record_property):
    _, variables, port = net
    module, sub, port_module, shapes, in_dt = _cases(variables, port)[case]
    xs = [_bf16_input(s, i + 1, in_dt) for i, s in enumerate(shapes)]
    jx = [jnp.asarray(x).astype(in_dt[0]) for x in xs]
    tx = [_nchw(x, in_dt[1]) for x in xs]
    with torch.inference_mode():
        if case == "basic_block":
            want, got = module.apply(sub, jx[0], jx[1], train=False), port_module(tx[0], tx[1])
        elif case == "root":
            want, got = module.apply(sub, jx, train=False), port_module(tx)
        elif case == "tree":
            want, got = module.apply(sub, jx[0], train=False), port_module(tx[0])
        elif case == "ida_up_stage":
            want, got = module.apply(sub, jx, train=False)[-1], port_module(tx)[-1]
        elif case == "head":
            want, got = module.apply(sub, jx[0]), port_module(tx[0]).float()
        else:
            want, got = module.apply(sub, jx[0]), port_module(tx[0])
    want_np, got_np = np.asarray(want.astype(jnp.float32)), _nhwc(got)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
    if case == "stem_f32":
        # f32: 147 products summed in another order, and the BatchNorm's rsqrt
        np.testing.assert_allclose(got_np, want_np, rtol=1e-5, atol=1e-5)
        record_property("max_abs_err", float(np.abs(got_np - want_np).max()))
    else:
        # bf16 maps (the head's f32 output is its bf16 1x1 conv, cast up)
        _assert_bf16_close(got_np, want_np, record_property, case)


def test_torch_north_star_centernet_matches_flax(net, record_property):
    """Also records the share of raw head elements that differ from JAX's
    op-by-op graph, and holds it to no more than the share by which JAX's
    own compiled graph differs from it."""
    jax_model, variables, port = net
    x = np.random.default_rng(10).normal(size=(2, H, W, 3)).astype(np.float32)
    want = jax_model.apply(variables, jnp.asarray(x), train=False)
    compiled = jax.jit(lambda a: jax_model.apply(variables, a, train=False))(jnp.asarray(x))
    with torch.inference_mode():
        got = port(_nchw(x, torch.float32))
    assert len(port.depthwise_upsamples()) == 8
    for name in ("heatmap", "size", "offset"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        c = np.asarray(getattr(compiled, name))
        assert g.dtype == np.float32 and g.shape == w.shape == (2, H // 4, W // 4, g.shape[-1])
        record_property(f"{name}_max_abs_err", float(np.abs(g - w).max()))
        record_property(f"{name}_share_differ", float((g != w).mean()))
        record_property(f"{name}_jax_compiled_share_differ", float((c != w).mean()))
        np.testing.assert_allclose(g, w, rtol=0, atol=NET_ATOL, err_msg=name)
        assert (g != w).mean() <= (c != w).mean(), name


def test_torch_centernet_weights_cast_once(net):
    """A bf16 conv casts its f32 weight once and keeps it; a new weight
    (``load_state_dict``) is cast again at the next call."""
    _, _, port = net
    conv = port.model.base.level0[0]
    x = torch.zeros((1, 16, 8, 8), dtype=torch.bfloat16)
    with torch.inference_mode():
        conv(x)
        first = conv._cast_cache["weight"][1]
        conv(x)
        assert conv._cast_cache["weight"][1] is first
    assert conv.weight.dtype == torch.float32
    with torch.no_grad():
        conv.weight.mul_(2.0)
    with torch.inference_mode():
        conv(x)
    assert conv._cast_cache["weight"][1] is not first
    torch.testing.assert_close(conv._cast_cache["weight"][1], conv.weight.to(torch.bfloat16))
    with torch.no_grad():
        conv.weight.mul_(0.5)


def test_torch_centernet_rejects_unknown_stage_and_bf16_dcn():
    oc, _ = centernet_config(H, W)
    with pytest.raises(ValueError, match="f32_stages"):
        CenterpointDLA34(oc, device="cpu", dtype=torch.bfloat16, f32_stages=("stem", "level6"))
    # A bf16 DCN is served since kernel E has a bf16 entry point
    # (tests/test_torch_dcn_north_star.py): its offset and mask convs
    # compute in bf16; the DCN takes bf16 x, weight and mask.
    net = CenterpointDLA34(oc, device="cpu", dtype=torch.bfloat16, deform=True)
    assert len(net.deform_convs()) == 16
    block = DeformConvBlock(32, 16, deform=True, dtype=torch.bfloat16).eval()
    assert block.offset.compute_dtype == block.mask.compute_dtype == torch.bfloat16
    with torch.inference_mode():
        assert block(torch.randn(1, 32, 5, 6)).dtype == torch.float32   # bn_out f32
    # "early" and every trunk and DLASeg stage are accepted, as in JAX.
    CenterpointDLA34(oc, device="cpu", dtype=torch.bfloat16,
                     f32_stages=("early", "level5", "dla_up", "ida_up", "heads"))
