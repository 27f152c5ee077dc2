"""``bench.py --deform``'s DCN knobs in the port against the JAX package,
on the CPU: ``--dcn-max-offset`` and ``--dcn-bound`` (``configs.dcn_knobs``),
``--bf16-joins`` (``configs.int8_knobs``) and ``--fused`` on the chain
profiles, on the nets, weights and frames of
``tests/test_torch_dcn_profiles.py`` (its helpers; the Pallas DCN in
interpret mode here too):

- ``--dcn-max-offset 1 --dcn-bound`` on the int8 chain: every DCN block
  takes the lerp (``dcn_variant``), JAX's chain the Pallas kernel's "lerp"
  variant on all 16 calls.  The maps are held as
  ``tests/test_torch_dcn_chain.py`` holds them (trunk equal, later codes
  within one on at most ``CODE_SHARE``), the decodes at threshold 0 to
  ``BOUNDED_MATCHED``: the lerp's samples are the Pallas body's bit for bit
  on equal bf16 inputs (``tests/test_torch_dcn_lerp.py``), and as at the
  served window the two stacks part where they sum the same bf16 products
  of the offset/mask conv and the DCN contraction in another order, so a
  head code one apart flips a tail slot (measured: 19 of the 20 slots
  matched, 2.8% of the codes after the trunk one apart);
- ``--bf16-joins`` on the DCN int8 chain at the served window: the joins
  bf16 in both chains, held as the chain at that window is;
- ``--fused`` on the chain pair (``make_chain_pair_pipeline``): the
  combined pipeline equal bit for bit to the two requests.
"""

import functools

import jax.numpy as jnp
import pytest
import torch

from tauv_vision_tpu.ops.pallas import deform_conv as pallas_deform_conv
from tauv_vision_tpu.serving import quantize as jax_quantize
from tauv_vision_tpu.serving import quantize_chain as jax_chain
from tauv_vision_tpu_torch.configs import DCN_CHAIN_INT8, DCN_PARITY_INT8, dcn_knobs, int8_knobs
from tauv_vision_tpu_torch.ops.image import preprocess
from tauv_vision_tpu_torch.serving import quantize_chain as port_chain
from tauv_vision_tpu_torch.serving.quantize import calibrate
from test_torch_centernet_chain import ALL_SLOTS, CN_STEM, assert_maps_held
from test_torch_dcn_chain import CODE_SHARE, MATCHED
from test_torch_dcn_profiles import (
    SERVED_WINDOW,
    Net,
    _decode_held,
    _small_yolact,
    jax_calibration,
)
from torch_parity import ChainRecorder, torch_threads

H, W = 64, 128
BOUNDED = dcn_knobs(DCN_CHAIN_INT8, 1.0, bound=True)
JOINS = int8_knobs(DCN_CHAIN_INT8, bf16_joins=True)
BOUNDED_MATCHED = MATCHED[int(SERVED_WINDOW)]


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


@pytest.fixture(scope="module")
def net():
    return Net(DCN_PARITY_INT8)


def test_torch_dcn_bounded_lerp_chain_matches_jax(net, record_property):
    """The bounded R = 1 int8 chain on the same weights: the port's 16
    DCNs take the lerp, JAX's Pallas calls its "lerp" variant."""
    bounded = Net(BOUNDED)
    assert [m.variant for m in bounded.port.deform_convs()] == ["lerp"] * 16
    cn = BOUNDED.centernet
    scales = jax_quantize.calibrate(bounded.apply, [bounded.img])
    variants = []
    pallas = pallas_deform_conv.deform_conv2d_pallas

    def recording(*args, **kwargs):
        variants.append(kwargs.get("variant"))
        return pallas(*args, **kwargs)

    want_pipe = bounded.jax_pipeline(scales, cn.dcn_max_offset, offset_bound=cn.offset_bound)
    got_pipe = port_chain.make_centernet_chain_pipeline(bounded.port, bounded.mc, scales, "cpu",
                                                        ALL_SLOTS, impl="plain")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_deform_conv, "deform_conv2d_pallas", recording)
        with ChainRecorder(jax_chain, port_chain, CN_STEM) as rec:
            want = want_pipe(jnp.asarray(bounded.frames))
            got = got_pipe(bounded.frames)
    assert variants == ["lerp"] * 16
    assert_maps_held(rec, record_property, code_share=CODE_SHARE)
    _decode_held(want, got, BOUNDED_MATCHED, record_property)


# ------------------------------------------------------- --bf16-joins


def test_torch_dcn_chain_bf16_joins_matches_jax(net, record_property):
    assert JOINS.yolact.join_dtype == torch.bfloat16
    scales = jax_calibration(net, "per_tensor")[0]
    want_pipe = net.jax_pipeline(scales, SERVED_WINDOW, join_dtype=jnp.bfloat16)
    got_pipe = port_chain.make_centernet_chain_pipeline(
        net.port, net.mc, scales, "cpu", ALL_SLOTS, impl="plain",
        join_dtype=JOINS.yolact.join_dtype)
    with ChainRecorder(jax_chain, port_chain, CN_STEM) as rec:
        want = want_pipe(jnp.asarray(net.frames))
        got = got_pipe(net.frames)
    assert_maps_held(rec, record_property, code_share=CODE_SHARE)
    _decode_held(want, got, MATCHED[int(SERVED_WINDOW)], record_property)


# ------------------------------------------------------------ --fused


def test_torch_dcn_chain_pair_fused_equals_two_requests(net):
    yl = _small_yolact()
    frames = torch.from_numpy(net.frames)
    cn_scales = jax_calibration(net, "per_tensor")[0]
    with torch.inference_mode():
        yl_img = preprocess(frames, (H, W), yl.config.img_mean, yl.config.img_stddev,
                            torch.bfloat16)
        yl_scales = calibrate(yl, [yl_img])
    pipes = [port_chain.make_chain_pair_pipeline(
        net.port, net.mc, cn_scales, yl, yl_scales, "cpu", ALL_SLOTS, impl="plain",
        join_dtype=JOINS.yolact.join_dtype, fused=fused) for fused in (False, True)]
    assert len(pipes[0].requests) == 2
    for want, got in zip(*(pipe(frames) for pipe in pipes)):
        for name, value in vars(want).items():
            other = getattr(got, name)
            assert (value is None and other is None) or torch.equal(other, value), name
