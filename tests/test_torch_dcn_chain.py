"""The port's int8 CenterNet chain with DCN IDA against the JAX package's.

``bench.py --deform`` serves the chain-int8 profile with the CenterNet's
16 IDA blocks deformable (``configs.DCN_CHAIN_INT8``): an int8 trunk, the
DCN blocks in bf16 (``dla34_chain_forward(deform=True)``, the JAX Pallas
kernel with ``dcn_max_offset=3``, variant "full").  The Pallas call runs
here in interpret mode, by replacing ``deform_conv2d_pallas`` for this
module, as ``tests/test_torch_dcn_north_star.py`` does; nothing in the
JAX package changes.  Both stacks run the same numpy weights
(``torch_parity.random_variables``: offsets reach a few cells, some
samples leave the map) with JAX's scales (JAX ``calibrate`` of the JAX
bf16 model, its DCN in the "gather" form), the JAX chain op by op, both
from JAX's stem output, at 64x128 (where both ``pad_to_match`` forms
agree):

- the port's ``calibrate`` records JAX's 44 keys, no DCN offset or mask
  conv among them (the JAX block serves them merged, not as an
  ``nn.Conv``), with values within ``SCALE_RTOL``;

- the whole request through ``make_centernet_chain_pipeline``, once with
  the served 3-cell window (the recipe's ``dcn_max_offset``) and once
  with a 4-cell one, the port's DCNs given the same window as the Pallas
  kernel each time.  The served window drops the 25 sampled offsets past
  3 cells, and the 4-cell window covers them all.  Every trunk map is
  equal; the DCN blocks are float boundaries (a bf16 conv for the offsets
  and mask, the sampling, an f32 BatchNorm), so after the trunk the int8
  codes (the heads' conv -> out links) are held to equal or 1 apart on at
  most ``CODE_SHARE`` of them, the raw heads within ``HEAD_ATOL`` (heads
  of magnitude up to ~0.5).  At both windows, where the two compute the
  same function, the decoded detections at threshold 0 are held to
  centre and score p95 <= 1e-3, and size p95 within ``SIZE_ULPS`` bf16
  ulps of the largest size: where a head code is one apart, a size moves
  by a bf16 ulp of the head.  At the 4-cell window 100% of them are
  matched; at the served window 95%, 19 of the 20 slots, since there a
  code one apart flips an NMS tie between neighbouring tail slots
  (``MATCHED``);
- the offset and mask convs: the chain runs them as one 27-channel bf16
  conv, as the JAX block serves them; on the CPU that equals the port
  block's two convs bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tauv_vision_tpu.ops.pallas import deform_conv as pallas_deform_conv
from tauv_vision_tpu.serving import quantize_chain as jax_chain
from tauv_vision_tpu_torch.configs import DCN_CHAIN_INT8, centernet_config
from tauv_vision_tpu_torch.serving import quantize_chain as port_chain
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from test_torch_centernet_chain import (
    ALL_SLOTS,
    CN_STEM,
    DECODE_P95,
    JAX_DTYPE,
    _frames,
    _net,
    assert_calibrate_matches_jax,
    assert_maps_held,
)
from torch_parity import ChainRecorder, dcn_window, jax_centernet_config, jax_object_config

H, W = 64, 128
SERVED_WINDOW = 3          # bench.py's dcn_max_offset
CODE_SHARE = 0.1
HEAD_ATOL = 1e-2     # raw heads: what the codes one apart move them by
SIZE_ULPS = 2        # decoded sizes: bf16 ulps of the largest (chip_smoke's NS_SIZE_ULPS)
# The decode's matched share at each window.  At the served one a head
# code one apart flips a 3x3 NMS tie between neighbouring tail slots:
# the port matches 19 of the 20 slots (JAX's own compiled chain 17 of
# its op-by-op chain's), so 100% is not reached there.
MATCHED = {SERVED_WINDOW: 0.95, 4: 1.0}


@pytest.fixture(scope="module", autouse=True)
def pallas_interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_deform_conv, "deform_conv2d_pallas", functools.partial(
            pallas_deform_conv.deform_conv2d_pallas, interpret=True))
        yield


@pytest.fixture(scope="module")
def net():
    oc, mc = centernet_config(H, W)
    jax_model, variables, port, scales, img = _net(oc, mc, DCN_CHAIN_INT8, 0,
                                                   dcn_impl="gather")
    return oc, mc, variables, port, scales, img


def test_torch_dcn_calibrate_matches_jax(net, record_property):
    *_, port, scales, img = net
    assert len(scales) == 44 and not any("offset" in p or "mask" in p for p in scales)
    assert_calibrate_matches_jax(port, img, scales, record_property)


@pytest.mark.parametrize("window", [SERVED_WINDOW, 4])
def test_torch_dcn_chain_matches_jax(net, window, record_property):
    oc, mc, variables, port, scales, _ = net
    recipe = DCN_CHAIN_INT8
    want_pipe = jax_chain.make_centernet_chain_pipeline(
        jax_centernet_config(mc), jax_object_config(oc), variables, scales,
        n_detections=ALL_SLOTS.n_detections, score_threshold=0.0,
        dtype=JAX_DTYPE[recipe.input_dtype], jit=False, deform=True,
        dcn_max_offset=float(window))
    got_pipe = port_chain.make_centernet_chain_pipeline(port, mc, scales, "cpu", ALL_SLOTS,
                                                        impl="plain")
    frames = _frames(1, H, W)
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(args[1]))
             for m in port.deform_convs()]
    assert recipe.centernet.dcn_max_offset == SERVED_WINDOW
    try:
        with ChainRecorder(jax_chain, port_chain, CN_STEM) as rec, dcn_window(port, window):
            want = want_pipe(jnp.asarray(frames))
            got = got_pipe(frames)
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == 16 and all(o.dtype == torch.float32 for o in seen)
    reach = max(o.abs().max().item() for o in seen)
    record_property("offset_reach", reach)
    record_property("offsets_past_served_window",
                    sum(int((o.abs() > SERVED_WINDOW).sum()) for o in seen))
    share = assert_maps_held(rec, record_property, code_share=CODE_SHARE)
    assert share > 0        # the DCN blocks are float boundaries
    for i in range(3):
        path = f"model/head_{i}_out"
        g, w = rec.maps["port"][path], rec.maps["jax"][path]
        record_property(f"head_{i}_max_abs_err", float(np.abs(g - w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=HEAD_ATOL, err_msg=path)
    stats = detection_deltas(want, got, score_threshold=0.0)
    record_property("port_vs_jax", stats)
    assert stats["total"] == got.valid.numel()
    size_atol = SIZE_ULPS * 2.0 ** (np.floor(np.log2(max(
        np.abs(np.asarray(want.h)).max(), np.abs(np.asarray(want.w)).max()))) - 7)
    assert stats["matched_fraction"] >= MATCHED[window], stats
    assert stats["center_delta_p95"] <= DECODE_P95 and stats["score_delta_p95"] <= DECODE_P95
    assert stats["size_delta_p95"] <= size_atol, (stats, size_atol)


def test_torch_dcn_chain_merged_offset_mask_conv(net):
    """The chain's one 27-channel conv against the port block's two, on
    the bf16 inputs of the first DCN block of a forward."""
    port = net[3]
    block = port.model.dla_up.ida_0.proj_1
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 512, 2, 4))).to(torch.bfloat16)
    with torch.inference_mode():
        two = torch.cat([block.offset(x), block.mask(x)], dim=1)
        w = torch.cat([block.offset.weight, block.mask.weight]).to(torch.bfloat16)
        b = torch.cat([block.offset.bias, block.mask.bias]).to(torch.bfloat16)
        merged = F.conv2d(x, w, padding=1) + b[:, None, None]
    assert torch.equal(two, merged)
