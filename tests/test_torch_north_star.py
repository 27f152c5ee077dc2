"""The ``north_star`` pair of the PyTorch port against the JAX package's.

``bench.py`` with no flags serves the bf16 CenterNet (bf16 convs and
BatchNorm outputs, an f32 stem) beside the int8-chain YOLACT, both behind
one ``make_combined_pipeline``: the recipe ``configs.NORTH_STAR``.  Here
both stacks run it on the same weights and uint8 frames (80x96, resized
to 72x104): the full-width CenterNet, and ``test_torch_slice.py``'s narrow
YOLACT (feature depth 32) as the int8 chain on shared scales (per-channel
``calibrate`` of the port's f32 forward with ``NORTH_STAR``'s float paths
stripped: 30 convs, and no scale for the two protonet upsamples, which
``calibrate`` never records, so both chains run them as bf16 transposed
convs: ``int8_transpose=None``, ``bench.py``'s no-flag graph).

The JAX pipeline is ``make_combined_pipeline(..., dtype=jnp.float32,
jit=False)``: f32 is the input the f32 stem was certified on (the port
normalises in f32 too), and run op by op the chain rounds as the port's
does (compiled, XLA fuses multiply-adds and a code may move by one; see
``tests/test_torch_chain.py``).  The decode thresholds are 0, so every
slot is compared: 100% matched by ``detection_deltas`` with every p95 <=
1e-3 (the PARITY.md bar), but for the CenterNet's size, which is the size
head's bf16 output: one bf16 ulp of a decoded size (2^-9 at the sizes
here, 1.95e-3) is the finest step it has, and a bf16 net rounds a few
elements of each conv one ulp apart from XLA's sums, which spreads
(``tests/test_torch_bf16_centernet.py``).  So the CenterNet is also held
to a yardstick, p95 by p95: no further from JAX's op-by-op graph than
JAX's own compiled graph is on the same frames.  Measured: port centre
3.1e-5, score 5.0e-4, size 2.93e-3 (1.5 bf16 ulps); JAX compiled 4.8e-5,
7.2e-4, 3.17e-3.  The YOLACT chain decodes bit for bit (p95 0: the frame
resize rounds as JAX's does).  The CenterNet's top-K may swap one slot
where two bf16 logits tie within an ulp; the test would then count it
and require ``matched_fraction`` >= 0.99.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.centerpoint_dla import (
    CenterpointDLA34 as JaxCenterpointDLA34,
)
from tauv_vision_tpu.serving import quantize_chain as jax_chain
from tauv_vision_tpu.serving.pipeline import (
    make_combined_pipeline as jax_make_combined_pipeline,
)
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import NORTH_STAR, centernet_config, yolact_config
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.ops.image import preprocess
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.pipeline import DecodeKnobs, make_combined_pipeline
from tauv_vision_tpu_torch.serving.quantize import calibrate, strip_scales
from tauv_vision_tpu_torch.serving.quantize_chain import ChainCtx, yolact_chain_forward
from tauv_vision_tpu_torch.weights import centerpoint_state_dict_from_flax
from torch_parity import random_variables, yolact_pair

H, W = 72, 104
ALL_SLOTS = DecodeKnobs(score_threshold=0.0, confidence_threshold=0.0)
JAX_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


@pytest.fixture(scope="module")
def pair():
    oc, cn_cfg = centernet_config(H, W)
    cn = NORTH_STAR.centernet
    cn_jax = JaxCenterpointDLA34(object_config=oc, deform=cn.deform, dtype=JAX_DTYPE[cn.dtype],
                                 bn_out=JAX_DTYPE[cn.bn_out], f32_stages=cn.f32_stages)
    cn_vars = random_variables(cn_jax, (1, H, W, 3), 0)
    cn_port = CenterpointDLA34(oc, device="cpu", **NORTH_STAR.centernet_kwargs()).eval()
    cn_port.load_state_dict(centerpoint_state_dict_from_flax(cn_vars))

    yl_cfg = yolact_config(H, W, feature_depth=32)
    jax_yl_cfg, _, yl_vars, yl_port = yolact_pair(yl_cfg, 1)
    frames = np.random.default_rng(0).integers(0, 256, (2, 80, 96, 3), np.uint8)
    img = preprocess(torch.from_numpy(frames), (H, W), yl_cfg.img_mean, yl_cfg.img_stddev)
    recipe = NORTH_STAR.yolact
    assert not recipe.int8_transposes   # bench.py leaves int8_transpose None
    scales = strip_scales(calibrate(yl_port, [img], per_channel=recipe.per_channel),
                          recipe.float_paths)
    return (cn_jax, cn_vars, cn_port, cn_cfg), (jax_yl_cfg, yl_vars, yl_port, yl_cfg), \
        frames, scales


def _jax_pipeline(pair, dtype, cn_forward=None, jit=False):
    (cn_jax, cn_vars, _, cn_cfg), (jax_yl_cfg, yl_vars, _, _), _, scales = pair
    recipe = NORTH_STAR.yolact
    return jax_make_combined_pipeline(
        cn_forward or (lambda img: cn_jax.apply(cn_vars, img, train=False)), cn_cfg,
        jax_chain.yolact_chain_forward(
            jax_yl_cfg, yl_vars, scales, dtype=JAX_DTYPE[recipe.dtype],
            join_dtype=JAX_DTYPE[recipe.join_dtype], int8_transpose=None),
        jax_yl_cfg, ALL_SLOTS.n_detections, ALL_SLOTS.score_threshold, ALL_SLOTS.top_k,
        ALL_SLOTS.iou_threshold, ALL_SLOTS.confidence_threshold, dtype=dtype, jit=jit)


def test_torch_north_star_pair_matches_jax(pair, record_property):
    (_, _, cn_port, cn_cfg), (_, _, yl_port, yl_cfg), frames, scales = pair
    assert len(scales) == 30 and "protonet/upsample_2" not in scales
    want_cn, want_yl = _jax_pipeline(pair, jnp.float32)(jnp.asarray(frames))
    # The yardstick: JAX's compiled graph against its own op-by-op one.
    jit_cn, _ = _jax_pipeline(pair, jnp.float32, jit=True)(jnp.asarray(frames))
    yardstick = detection_deltas(want_cn, jit_cn, score_threshold=0.0)
    record_property("jax_compiled_vs_op_by_op_centernet", yardstick)

    ctx = ChainCtx(yl_port, scales, impl="plain")
    assert (ctx.dtype, ctx.join_dtype) == (NORTH_STAR.yolact.dtype, NORTH_STAR.yolact.join_dtype)
    port_pipe = make_combined_pipeline(cn_port, cn_cfg, yolact_chain_forward(ctx), yl_cfg,
                                       "cpu", knobs=ALL_SLOTS, impl="plain",
                                       dtype=NORTH_STAR.input_dtype)
    before = dict(kernels.LAUNCHES)
    got_cn, got_yl = port_pipe(frames)
    assert kernels.LAUNCHES == before

    stats = {name: detection_deltas(want, got, score_threshold=0.0)
             for name, got, want in (("centernet", got_cn, want_cn), ("yolact", got_yl, want_yl))}
    record_property("port_vs_jax", stats)
    for name, got, want in (("centernet", got_cn, want_cn), ("yolact", got_yl, want_yl)):
        s = stats[name]
        assert s["total"] == got.valid.numel() > 0   # every slot, at threshold 0
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        if s["matched_fraction"] < 1.0:
            # The one tolerated difference: a top-K slot swapped at a tie.
            record_property(f"{name}_tie_swaps", s["total"] - round(s["matched_fraction"] * s["total"]))
            assert name == "centernet" and s["matched_fraction"] >= 0.99, s
        for what in ("center", "score", "size"):
            key = f"{what}_delta_p95"
            if name == "centernet":
                assert s[key] <= yardstick[key], (what, s, yardstick)
            if name == "yolact" or what != "size":
                assert s[key] <= 1e-3, (name, what, s)


def test_torch_north_star_input_dtype_finding(pair):
    """The JAX package's ``make_combined_pipeline`` normalises to its
    ``dtype``, bf16 unless told otherwise (``bench.py`` passes none), so in
    the served graph the f32 stem convolves a bf16-rounded image; with
    ``dtype=f32`` it gets the f32 image it was certified on."""
    seen = {}

    class Seen(Exception):
        pass

    for dtype in (jnp.bfloat16, jnp.float32):
        def record(img, dtype=dtype):
            seen[dtype] = np.asarray(img.astype(jnp.float32))
            assert img.dtype == dtype
            raise Seen

        with pytest.raises(Seen):
            _jax_pipeline(pair, dtype, cn_forward=record)(jnp.asarray(pair[2]))
    assert not np.array_equal(seen[jnp.bfloat16], seen[jnp.float32])
    np.testing.assert_array_equal(
        seen[jnp.bfloat16], np.asarray(jnp.asarray(seen[jnp.float32]).astype(jnp.bfloat16)
                                       .astype(jnp.float32)))
