"""The float ``--bf16`` profile of the pair and its ladder
(``configs.BF16_PAIR``, ``configs.bf16_pair``), and ``decode_yolact``'s
``mask_hw`` and ``crop_masks``, against the JAX package, on the CPU.

- ``decode_yolact(mask_hw=, crop_masks=False)`` on one shared random
  prediction: detections as JAX's (valid and labels equal, scores and
  boxes within 1e-6: ``box_decode``'s ``exp`` rounds an ulp apart), masks
  within ``MASK_ATOL`` (an 8-term f32 dot summed in another order, then
  the bilinear resize, whose weights sum to 1); and the port's resize of
  JAX's own uncropped masks bit-equal to JAX's resized ones.
- ``bf16_pair(fused=True)`` decodes bit for bit as the unfused pair (the
  JAX package states its fusion bit-identical, ``pipeline.py:323-325``):
  the shared resize is ``preprocess``'s, and the bf16 YOLACT's stem rounds
  an f32 image to bf16 as its own image is rounded.
- ``bf16_pair`` raises on an unknown stage, as ``bench.py --f32-from``
  does, and feeds the CenterNet the f32 image only on a rung that names
  ``stem`` or ``early``.
- One ladder rung (level3 onwards in f32) and the ``--bn-bf16`` rung: the
  full-width DLA-34 at 72x104 on the same weights and image as JAX's,
  run op by op: raw heads within ``NET_ATOL`` (as
  ``tests/test_torch_bf16_centernet.py`` holds the bf16 CenterNet), and no
  further from JAX's op-by-op graph, head by head, than JAX's own compiled
  graph is (``YARDSTICK`` times its largest difference; the port sums
  each conv in another order than XLA, and so does XLA's compiled graph).
  Measured, largest head difference against JAX op by op: the ladder
  rung 1.1e-3 (JAX compiled 3.1e-3), the ``--bn-bf16`` rung 7.8e-3 (8.3e-3).
- The input-dtype finding of the ``stem``/``early`` rungs: the JAX
  pipeline rounds the image to bf16 before the f32 convs read it.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.centerpoint_dla import CenterpointDLA34 as JaxCenterpointDLA34
from tauv_vision_tpu.models.yolact import YolactPrediction as JaxYolactPrediction
from tauv_vision_tpu.serving import pipeline as jax_pipeline
from tauv_vision_tpu.serving.yolact_decode import decode_yolact as jax_decode_yolact
from tauv_vision_tpu_torch.configs import (
    BF16_PAIR,
    F32_IMAGE_STAGES,
    bf16_pair,
    centernet_config,
    yolact_config,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import F32_STAGES, CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact, YolactPrediction
from tauv_vision_tpu_torch.ops.image import resize_bilinear
from tauv_vision_tpu_torch.serving.pipeline import (
    DecodeKnobs,
    make_centernet_pipeline,
    make_float_pair_pipeline,
)
from tauv_vision_tpu_torch.serving.yolact_decode import decode_yolact
from tauv_vision_tpu_torch.weights import centerpoint_state_dict_from_flax
from torch_parity import jax_yolact_config, random_variables, torch_threads

H, W = 72, 104
MASK_HW = (H, W)           # twice the prototypes' 36x52, as 180x320 -> 360x640 served
MASK_ATOL = 1e-5
NET_ATOL = 2 * 0.0078125   # tests/test_torch_bf16_centernet.py's bar
YARDSTICK = 2.0
ALL_SLOTS = DecodeKnobs(score_threshold=0.0, confidence_threshold=0.0)
LADDER = ("level3", "level4", "level5", "dla_up", "ida_up", "heads")
JAX_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


def _prediction_arrays(cfg, seed=5):
    rng = np.random.default_rng(seed)
    b, n, p, c = 2, 60, cfg.n_prototype_masks, cfg.n_classes + 1
    return dict(
        classification=rng.normal(size=(b, n, c)).astype(np.float32) * 2,
        box_encoding=rng.normal(size=(b, n, 4)).astype(np.float32),
        mask_coeff=np.tanh(rng.normal(size=(b, n, p))).astype(np.float32),
        anchor=np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))],
                              -1).astype(np.float32),
        mask_prototype=rng.normal(size=(b, H // 2, W // 2, p)).astype(np.float32),
    )


def test_torch_decode_yolact_mask_hw_no_crop_matches_jax():
    cfg = yolact_config(H, W, feature_depth=32)
    arrays = _prediction_arrays(cfg)
    jax_pred = JaxYolactPrediction(**{k: jnp.asarray(v) for k, v in arrays.items()})
    port_pred = YolactPrediction(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    want = jax_decode_yolact(jax_pred, jax_yolact_config(cfg), 8, 0.5, 0.2, mask_hw=MASK_HW,
                             crop_masks=False)
    unresized = jax_decode_yolact(jax_pred, jax_yolact_config(cfg), 8, 0.5, 0.2,
                                  crop_masks=False)
    for impl in ("plain", "kernel"):   # on a CPU tensor kernel B's wrapper is the plain version
        got = decode_yolact(port_pred, cfg, 8, 0.5, 0.2, mask_hw=MASK_HW, crop_masks=False,
                            impl=impl)
        assert got.valid.any() and got.mask.shape == (2, 8) + MASK_HW
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.label.numpy(), np.asarray(want.label))
        for name in ("score", "box"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.mask.numpy(), np.asarray(want.mask), rtol=0,
                                   atol=MASK_ATOL)
    # Uncropped: no mask is zero outside its box.
    assert (np.asarray(unresized.mask) > 0).all()
    np.testing.assert_array_equal(
        resize_bilinear(torch.from_numpy(np.array(unresized.mask)), MASK_HW).numpy(),
        np.asarray(want.mask))


def _pair_nets(recipe, seed=0):
    oc, cn_cfg = centernet_config(H, W)
    cn = CenterpointDLA34(oc, generator=torch.Generator().manual_seed(seed), device="cpu",
                          up_impl="plain", **recipe.centernet_kwargs()).eval()
    yl = Yolact(yolact_config(H, W, feature_depth=32),
                generator=torch.Generator().manual_seed(seed + 1), device="cpu",
                dtype=recipe.yolact_dtype).eval()
    return cn, cn_cfg, yl


@pytest.mark.parametrize("stages", [(), ("early",)], ids=["bf16_image", "f32_image"])
def test_torch_bf16_pair_fused_equals_unfused(stages):
    recipe = bf16_pair(f32_stages=stages)
    assert recipe.input_dtype == (torch.float32 if stages else torch.bfloat16)
    cn, cn_cfg, yl = _pair_nets(recipe)
    frames = np.random.default_rng(1).integers(0, 256, (2, 80, 96, 3), np.uint8)
    unfused = make_float_pair_pipeline(recipe, cn, cn_cfg, yl, "cpu", ALL_SLOTS, impl="plain")
    fused = make_float_pair_pipeline(bf16_pair(f32_stages=stages, fused=True), cn, cn_cfg, yl,
                                     "cpu", ALL_SLOTS, impl="plain")
    assert len(unfused.requests) == 2 and not hasattr(fused, "requests")
    for got, want in zip(fused(frames), unfused(frames)):
        for name, value in vars(want).items():
            other = getattr(got, name)
            assert (other is None and value is None) or torch.equal(other, value), name
        assert want.valid.numel() > 0


def test_torch_bf16_pair_rungs():
    assert bf16_pair() == BF16_PAIR
    assert (BF16_PAIR.centernet.dtype, BF16_PAIR.centernet.bn_out, BF16_PAIR.yolact_dtype,
            BF16_PAIR.input_dtype, BF16_PAIR.fused) == (torch.bfloat16, torch.float32,
                                                       torch.bfloat16, torch.bfloat16, False)
    assert bf16_pair(bn_bf16=True).centernet.bn_out == torch.bfloat16
    for bad in (("level6",), ("stem", "Level3"), ("ida",)):
        with pytest.raises(ValueError, match="f32_stages"):
            bf16_pair(f32_stages=bad)
    for stage in F32_STAGES:
        rung = bf16_pair(f32_stages=(stage,))
        assert rung.centernet.f32_stages == (stage,)
        assert rung.input_dtype == (torch.float32 if stage in F32_IMAGE_STAGES
                                    else torch.bfloat16), stage


@pytest.fixture(scope="module")
def rung_nets():
    """{rung: (JAX model, variables, the port's model, the image)}."""
    oc, _ = centernet_config(H, W)
    nets = {}
    for name, recipe in (("ladder", bf16_pair(f32_stages=LADDER)),
                         ("bn_bf16", bf16_pair(bn_bf16=True))):
        cn = recipe.centernet
        jax_model = JaxCenterpointDLA34(object_config=oc, deform=False,
                                        dtype=JAX_DTYPE[cn.dtype], bn_out=JAX_DTYPE[cn.bn_out],
                                        f32_stages=cn.f32_stages)
        variables = random_variables(jax_model, (1, H, W, 3), 3)
        port = CenterpointDLA34(oc, device="cpu", **recipe.centernet_kwargs()).eval()
        port.load_state_dict(centerpoint_state_dict_from_flax(variables))
        x = np.random.default_rng(11).normal(size=(2, H, W, 3)).astype(np.float32)
        img = np.asarray(jnp.asarray(x).astype(JAX_DTYPE[recipe.input_dtype])
                         .astype(jnp.float32))
        nets[name] = (jax_model, variables, port, img, recipe.input_dtype)
    return nets


@pytest.mark.parametrize("rung", ["ladder", "bn_bf16"])
def test_torch_bf16_rung_matches_flax(rung_nets, rung, record_property):
    jax_model, variables, port, img, dtype = rung_nets[rung]
    x = jnp.asarray(img).astype(JAX_DTYPE[dtype])
    want = jax_model.apply(variables, x, train=False)
    compiled = jax.jit(lambda a: jax_model.apply(variables, a, train=False))(x)
    with torch.inference_mode():
        got = port(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().to(dtype))
    assert len(port.depthwise_upsamples()) == 8
    for name in ("heatmap", "size", "offset"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        c = np.asarray(getattr(compiled, name))
        assert g.dtype == np.float32 and g.shape == w.shape == (2, H // 4, W // 4, g.shape[-1])
        err, spread = float(np.abs(g - w).max()), float(np.abs(c - w).max())
        record_property(f"{name}_max_abs_err", err)
        record_property(f"{name}_jax_compiled_max_abs_err", spread)
        np.testing.assert_allclose(g, w, rtol=0, atol=NET_ATOL, err_msg=name)
        assert err <= YARDSTICK * spread, (name, err, spread)


def test_torch_f32_image_rungs_input_dtype_finding():
    """JAX's ``make_centernet_pipeline`` normalises to its ``dtype``, bf16
    unless told otherwise (``bench.py`` passes none), so on an ``early``
    or ``stem`` rung its f32 convs read a bf16-rounded image; the port's
    rung feeds them the f32 image."""
    assert inspect.signature(jax_pipeline.make_centernet_pipeline).parameters[
        "dtype"].default == jnp.bfloat16
    oc, cfg = centernet_config(H, W)
    frames = np.random.default_rng(2).integers(0, 256, (1, 80, 96, 3), np.uint8)
    seen = {}

    class Seen(Exception):
        pass

    class Recorder:
        def apply(self, variables, img, train):
            seen["jax"] = img
            raise Seen

    with pytest.raises(Seen):
        jax_pipeline.make_centernet_pipeline(Recorder(), cfg, jit=False)({}, jnp.asarray(frames))

    def record(img):
        seen["port"] = img
        raise Seen

    for stages in (("stem",), ("early", "level5")):
        recipe = bf16_pair(f32_stages=stages)
        with pytest.raises(Seen):
            make_centernet_pipeline(record, cfg, "cpu", dtype=recipe.input_dtype)(frames)
        assert seen["jax"].dtype == jnp.bfloat16 and seen["port"].dtype == torch.float32
        port_img = seen["port"].permute(0, 2, 3, 1).numpy()
        jax_img = np.asarray(seen["jax"].astype(jnp.float32))
        assert not np.array_equal(jax_img, port_img)
        np.testing.assert_array_equal(
            jax_img, np.asarray(jnp.asarray(port_img).astype(jnp.bfloat16).astype(jnp.float32)))
