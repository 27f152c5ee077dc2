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
  (``MATCHED``).  The cause (``parting`` below, ``PYTHONPATH=.:tests
  JAX_PLATFORMS=cpu python tests/test_torch_dcn_chain.py``): two float
  ops of the DCN blocks sum the same exact bf16 products in another
  order than XLA's CPU ops and so round to bf16 on the other side of a
  midpoint now and then.  The 27-channel offset/mask conv of
  ``ida_2/node_1`` (the 8th DCN call), offset channel 0 at (b, y, x) =
  (1, 11, 30): its exact sum 0.0175171020 lies 1.2e-8 above the bf16
  midpoint 0.0175170898; XLA's conv rounds it up, torch's down, and
  after the bias JAX has 0.9375, the port 0.93359375.  The DCN sampling's
  per-tap contraction (kernel E's plain version against the Pallas body
  in interpret mode): 17 output elements of 5 calls part from equal
  inputs, ``ida_0/node_1`` at (b, y, x, o) = (0, 0, 2, 36) the first,
  exact 0.0146789599, JAX 0.014709473 (the nearest bf16), the port
  0.014648438; JAX rounds to the nearest in 8 of the 17, the port in 8.
  With JAX's outputs of those two ops put into the port's chain wherever
  their inputs are equal, the decode is 100% matched and every head code
  equal; XLA's rsqrt in the BatchNorms changes nothing.  Neither stack is
  at fault, and the port cannot follow XLA's CPU summation order, so the
  served window keeps its 95%;
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
# its op-by-op chain's), so 100% is not reached there.  The code parts
# where XLA and torch sum the offset/mask conv and the DCN contraction in
# other orders (module docstring, ``parting``).
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


def parting(window=SERVED_WINDOW):
    """Where the two chains part at ``window``, printed: each DCN block's
    offset/mask conv and sampling (kernel E's plain version against the
    Pallas body in interpret mode) compared on equal inputs, each output
    element that parts with the exact (float64) sum of the same bf16
    products, and the port's decode with JAX's outputs of those two ops
    put in wherever their inputs are equal (then with XLA's rsqrt in the
    BatchNorms).  ``PYTHONPATH=.:tests JAX_PLATFORMS=cpu python
    tests/test_torch_dcn_chain.py`` (~4 min)."""
    import jax

    from tauv_vision_tpu_torch.ops import deform_conv as port_dcn
    from tauv_vision_tpu_torch.serving.quantize_chain import BN_EPS

    jax_calls, calls, mode = [], [0], {"dcn": False, "om": False, "bn": False}
    pallas = pallas_deform_conv.deform_conv2d_pallas

    def recording_pallas(x, offset, mask, weight, bias, **kw):
        out = pallas(x, offset, mask, weight, bias, interpret=True, **kw)
        jax_calls.append([np.asarray(a.astype(jnp.float32)) for a in (x, offset, mask, out)])
        return out

    def nhwc(t):
        return t.detach().float().permute(0, 2, 3, 1).numpy()

    module_forward = port_dcn.DeformConv2d.forward

    def substituting_forward(self, x, offset, mask, impl=None):
        out = module_forward(self, x, offset, mask, impl=impl)
        k = calls[0]
        calls[0] += 1
        jx, jo, jm, jout = jax_calls[k]
        if not np.array_equal(nhwc(x), jx):
            return out
        first = not any(mode.values())
        if not (np.array_equal(nhwc(offset), jo) and np.array_equal(nhwc(mask), jm)):
            if not mode["om"] and not first:
                return out
            block = next(b for b in port.modules() if getattr(b, "conv", None) is self)
            w = torch.cat([block.offset.weight, block.mask.weight]).to(torch.bfloat16)
            exact = F.conv2d(x.double(), w.double(), padding=1).permute(0, 2, 3, 1).numpy()
            for name, got, want in (("offset", nhwc(offset), jo), ("mask", nhwc(mask), jm)):
                for idx in map(tuple, np.argwhere(got != want) if first else ()):
                    c = idx[3] + (0 if name == "offset" else 18)
                    print(f"  DCN call {k}: x equal, {name} {idx} JAX {want[idx]!r} port "
                          f"{got[idx]!r}; the conv's exact sum {exact[idx[:3] + (c,)]!r}")
            if not mode["om"]:
                return out
        elif not np.array_equal(nhwc(out), jout) and first:
            sums = []
            einsum = torch.einsum

            def recording_einsum(eq, a, b):
                sums.append(einsum(eq, a.double(), b.double()))
                return einsum(eq, a, b)

            torch.einsum = recording_einsum
            try:
                port_dcn.deform_conv2d(x, offset, mask, self.weight.to(x.dtype), self.bias,
                                       max_offset=self.max_offset)
            finally:
                torch.einsum = einsum
            b, _, h, w = x.shape
            total = (sum(sums) + self.bias.double()).permute(0, 2, 1).reshape(b, -1, h, w)
            total = total.permute(0, 2, 3, 1).detach().numpy()
            for idx in map(tuple, np.argwhere(nhwc(out) != jout)):
                near = float(torch.tensor(total[idx]).to(torch.bfloat16))
                print(f"  DCN call {k}: inputs equal, out {idx} JAX {jout[idx]!r} port "
                      f"{nhwc(out)[idx]!r}; exact sum {total[idx]!r} -> bf16 {near!r}")
        if mode["dcn"]:
            return torch.from_numpy(jout.copy()).permute(0, 3, 1, 2).to(out.dtype).contiguous()
        return out

    bn_exact = port_chain.ChainCtx.bn_exact

    def xla_bn(self, y, path):
        if not mode["bn"]:
            return bn_exact(self, y, path)
        bn = self.modules[path]
        mul = np.asarray(jax.lax.rsqrt(jnp.asarray(bn.running_var.float().numpy()) + BN_EPS)
                         * jnp.asarray(bn.weight.detach().float().numpy()))
        return ((y.to(torch.float32) - bn.running_mean.float()) * torch.from_numpy(mul)
                + bn.bias.float())

    oc, mc = centernet_config(H, W)
    _, variables, port, scales, _ = _net(oc, mc, DCN_CHAIN_INT8, 0, dcn_impl="gather")
    want_pipe = jax_chain.make_centernet_chain_pipeline(
        jax_centernet_config(mc), jax_object_config(oc), variables, scales,
        n_detections=ALL_SLOTS.n_detections, score_threshold=0.0,
        dtype=JAX_DTYPE[DCN_CHAIN_INT8.input_dtype], jit=False, deform=True,
        dcn_max_offset=float(window))
    got_pipe = port_chain.make_centernet_chain_pipeline(port, mc, scales, "cpu", ALL_SLOTS,
                                                        impl="plain")
    frames = _frames(1, H, W)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_deform_conv, "deform_conv2d_pallas", recording_pallas)
        mp.setattr(port_dcn.DeformConv2d, "forward", substituting_forward)
        mp.setattr(port_chain.ChainCtx, "bn_exact", xla_bn)
        with ChainRecorder(jax_chain, port_chain, CN_STEM) as rec, dcn_window(port, window):
            want = want_pipe(jnp.asarray(frames))
            for dcn, om, bn in ((False, False, False), (True, False, False),
                                (True, True, False), (True, True, True)):
                mode.update(dcn=dcn, om=om, bn=bn)
                calls[0] = 0
                rec.maps["port"].clear()
                stats = detection_deltas(want, got_pipe(frames), score_threshold=0.0)
                codes = sum(int((rec.maps["port"][f"model/head_{i}_out"]
                                 != rec.maps["jax"][f"model/head_{i}_out"]).sum())
                            for i in range(3))
                print(f"window {window}: JAX's DCN sampling put in {dcn}, its offset/mask conv "
                      f"{om}, XLA's rsqrt in the BatchNorms {bn}: matched "
                      f"{stats['matched_fraction']} of {stats['total']}, {codes} head codes "
                      f"differ")


if __name__ == "__main__":
    parting()
