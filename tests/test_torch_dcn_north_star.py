"""The ``dcn_north_star`` pair of the PyTorch port against the JAX package's.

``bench.py --deform --north-star`` serves the north-star pair with DCNv2
in the CenterNet's 16 IDA blocks: the flax bf16 CenterNet (bf16 convs and
BatchNorm outputs, an f32 stem) whose DCN runs the Pallas kernel
(``dcn_impl="pallas"``, ``dcn_max_offset=3``, variant "full"), beside
the int8-chain YOLACT (``configs.DCN_NORTH_STAR``).  The Pallas call runs
here in interpret mode, by replacing ``deform_conv2d_pallas`` for this
module; nothing in the JAX package changes.  Both stacks run the same
numpy weights (``torch_parity.random_variables``: offsets reach a few
cells, some samples leave the map) on the same inputs:

- the CenterNet's raw heads at 72x104 against JAX's op-by-op graph,
  with the bar of ``tests/test_torch_bf16_centernet.py``'s plain-IDA net
  (within ``NET_ATOL``, and no larger a share of elements differing than
  JAX's own compiled graph shows), once with the served 3-cell window
  (the recipe's ``dcn_max_offset``) and once with a 4-cell one, the port's
  DCNs given the same window as the Pallas kernel each time.  The net's
  offsets reach 3.6 cells here, so the served window drops samples and
  the 4-cell one covers them all;
- ``make_combined_pipeline`` on uint8 frames, decode thresholds 0: the
  CenterNet centre and score p95 <= 1e-3 (the PARITY.md bar), its
  matched share of JAX's op-by-op graph's 20 slots at least JAX's
  compiled graph's (the yardstick of ``tests/test_torch_north_star.py``),
  and every matched slot's size within ``SIZE_ULPS`` bf16 ulps of the
  largest size, as ``tests/test_torch_dcn_chain.py`` holds its decode
  (measured at the served window: the port matches 20 of 20, its
  farthest size two ulps off, 1.95e-3, its size p95 1.025e-3; JAX
  compiled matches 19 of 20, every matched size within one ulp, p95
  9.77e-4), the YOLACT chain bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.centerpoint_dla import (
    CenterpointDLA34 as JaxCenterpointDLA34,
)
from tauv_vision_tpu.ops.pallas import deform_conv as pallas_deform_conv
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import DCN_NORTH_STAR, NORTH_STAR, centernet_config, yolact_config
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.ops.image import preprocess
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.pipeline import make_combined_pipeline
from tauv_vision_tpu_torch.serving.quantize import calibrate, strip_scales
from tauv_vision_tpu_torch.serving.quantize_chain import ChainCtx, yolact_chain_forward
from tauv_vision_tpu_torch.weights import centerpoint_state_dict_from_flax
from test_torch_north_star import ALL_SLOTS, JAX_DTYPE, _jax_pipeline
from torch_parity import dcn_window, random_variables, yolact_pair

H, W = 72, 104
NET_ATOL = 2 * 0.0078125   # tests/test_torch_bf16_centernet.py's bar for the bf16 net
SERVED_WINDOW = 3          # bench.py's dcn_max_offset
SIZE_ULPS = 2              # decoded sizes: bf16 ulps of the largest (chip_smoke's NS_SIZE_ULPS)


@pytest.fixture(scope="module", autouse=True)
def pallas_interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_deform_conv, "deform_conv2d_pallas", functools.partial(
            pallas_deform_conv.deform_conv2d_pallas, interpret=True))
        yield


def _jax_centernet(window):
    oc, _ = centernet_config(H, W)
    cn = DCN_NORTH_STAR.centernet
    return JaxCenterpointDLA34(object_config=oc, deform=cn.deform, dcn_impl="pallas",
                               dcn_max_offset=window, dtype=JAX_DTYPE[cn.dtype],
                               bn_out=JAX_DTYPE[cn.bn_out], f32_stages=cn.f32_stages)


@pytest.fixture(scope="module")
def pair():
    oc, cn_cfg = centernet_config(H, W)
    assert DCN_NORTH_STAR.yolact == NORTH_STAR.yolact   # _jax_pipeline's chain
    cn_jax = _jax_centernet(SERVED_WINDOW)
    cn_vars = random_variables(cn_jax, (1, H, W, 3), 0)
    cn_port = CenterpointDLA34(oc, device="cpu", **DCN_NORTH_STAR.centernet_kwargs()).eval()
    cn_port.load_state_dict(centerpoint_state_dict_from_flax(cn_vars))

    yl_cfg = yolact_config(H, W, feature_depth=32)
    jax_yl_cfg, _, yl_vars, yl_port = yolact_pair(yl_cfg, 1)
    frames = np.random.default_rng(0).integers(0, 256, (2, 80, 96, 3), np.uint8)
    img = preprocess(torch.from_numpy(frames), (H, W), yl_cfg.img_mean, yl_cfg.img_stddev)
    recipe = DCN_NORTH_STAR.yolact
    scales = strip_scales(calibrate(yl_port, [img], per_channel=recipe.per_channel),
                          recipe.float_paths)
    return (cn_jax, cn_vars, cn_port, cn_cfg), (jax_yl_cfg, yl_vars, yl_port, yl_cfg), \
        frames, scales


@pytest.mark.parametrize("window", [SERVED_WINDOW, 4])
def test_torch_dcn_north_star_centernet_matches_flax(pair, window, record_property):
    (_, cn_vars, port, _), _, _, _ = pair
    jax_model = _jax_centernet(window)
    x = np.random.default_rng(10).normal(size=(2, H, W, 3)).astype(np.float32)
    want = jax_model.apply(cn_vars, jnp.asarray(x), train=False)
    compiled = jax.jit(lambda a: jax_model.apply(cn_vars, a, train=False))(jnp.asarray(x))

    dcns = port.deform_convs()
    assert len(dcns) == 16
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(args)) for m in dcns]
    assert DCN_NORTH_STAR.centernet.dcn_max_offset == SERVED_WINDOW
    with torch.inference_mode(), dcn_window(port, window):
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for h in hooks:
        h.remove()
    assert all(a[0].dtype == a[2].dtype == torch.bfloat16 and a[1].dtype == torch.float32
               for a in seen)
    reach = max(a[1].abs().max().item() for a in seen)
    record_property("offset_reach", reach)
    record_property("offsets_past_served_window",
                    sum(int((a[1].abs() > SERVED_WINDOW).sum()) for a in seen))
    assert 2.0 < reach < 4.0, reach
    for name in ("heatmap", "size", "offset"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        c = np.asarray(getattr(compiled, name))
        assert g.dtype == np.float32 and g.shape == w.shape == (2, H // 4, W // 4, g.shape[-1])
        record_property(f"{name}_max_abs_err", float(np.abs(g - w).max()))
        record_property(f"{name}_share_differ", float((g != w).mean()))
        record_property(f"{name}_jax_compiled_share_differ", float((c != w).mean()))
        np.testing.assert_allclose(g, w, rtol=0, atol=NET_ATOL, err_msg=name)
        assert (g != w).mean() <= (c != w).mean(), name


def test_torch_dcn_north_star_pair_matches_jax(pair, record_property):
    (_, _, cn_port, cn_cfg), (_, _, yl_port, yl_cfg), frames, scales = pair
    want_cn, want_yl = _jax_pipeline(pair, jnp.float32)(jnp.asarray(frames))
    jit_cn, _ = _jax_pipeline(pair, jnp.float32, jit=True)(jnp.asarray(frames))
    yardstick = detection_deltas(want_cn, jit_cn, score_threshold=0.0)
    record_property("jax_compiled_vs_op_by_op_centernet", yardstick)

    port_pipe = make_combined_pipeline(
        cn_port, cn_cfg, yolact_chain_forward(ChainCtx(yl_port, scales, impl="plain")),
        yl_cfg, "cpu", knobs=ALL_SLOTS, impl="plain", dtype=DCN_NORTH_STAR.input_dtype)
    before = dict(kernels.LAUNCHES)
    got_cn, got_yl = port_pipe(frames)
    assert kernels.LAUNCHES == before

    stats = {name: detection_deltas(want, got, score_threshold=0.0)
             for name, got, want in (("centernet", got_cn, want_cn), ("yolact", got_yl, want_yl))}
    record_property("port_vs_jax", stats)
    for name, got, want in (("centernet", got_cn, want_cn), ("yolact", got_yl, want_yl)):
        s = stats[name]
        assert s["total"] == got.valid.numel() > 0
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        if name == "yolact":
            assert s["matched_fraction"] == 1.0, s
        else:
            # Slots at the tail of the top-K whose scores lie within a bf16
            # ulp swap in and out; JAX's compiled graph swaps one too.
            assert s["matched_fraction"] >= yardstick["matched_fraction"], (s, yardstick)
        for what in ("center", "score", "size"):
            key = f"{what}_delta_p95"
            if name == "yolact":
                assert s[key] == 0.0, (name, what, s)
            elif what == "size":
                # Every matched slot, not a percentile: JAX compiled's fused
                # sizes are not rounded to bf16, so its p95 sits below one
                # ulp where a bf16 graph's is a whole ulp.
                size_atol = SIZE_ULPS * 2.0 ** (np.floor(np.log2(max(
                    np.abs(np.asarray(want_cn.h)).max(),
                    np.abs(np.asarray(want_cn.w)).max()))) - 7)
                assert s["size_delta_max"] <= size_atol, (what, s, yardstick, size_atol)
            else:
                assert s[key] <= 1e-3, (name, what, s)
