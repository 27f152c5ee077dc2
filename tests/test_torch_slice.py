"""The f32 serving slice of the PyTorch port against the JAX package.

Both stacks run the same weights (JAX init, carried over by
``tauv_vision_tpu_torch.weights``) on the same numpy inputs:

- the full-width ``CenterpointDLA34(deform=False)`` at 72x104, an odd
  size that reaches ``pad_to_match``'s pad-then-crop shift: raw heads
  within 2e-4 (f32 conv accumulation order);
- a narrow YOLACT (feature depth 32, 8 prototypes, 7 classes) at 72x104:
  raw outputs within 2e-4;
- ``make_combined_pipeline`` on uint8 80x96 frames resized to 72x104:
  100% of decoded detections matched by ``decoded_pair_deltas`` with
  every p95 <= 1e-5, and the masks within 1e-5; the per-net pipelines
  decode exactly as the fused one.
The decode thresholds are 0 so that every decoded slot is compared
(random weights put nothing above the served thresholds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.centerpoint_dla import (
    CenterpointDLA34 as JaxCenterpointDLA34,
)
from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu.serving.pipeline import (
    make_combined_pipeline as jax_make_combined_pipeline,
)
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import centernet_config, yolact_config
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.pipeline import (
    DecodeKnobs,
    make_centernet_pipeline,
    make_combined_pipeline,
    make_yolact_pipeline,
)
from tauv_vision_tpu_torch.weights import (
    centerpoint_state_dict_from_flax,
    yolact_state_dict_from_flax,
)

H, W = 72, 104
ALL_SLOTS = DecodeKnobs(score_threshold=0.0, confidence_threshold=0.0)


def _randomize_stats(variables, seed):
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(variables))

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "mean":
                node[k] = rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    walk(tree["batch_stats"])
    return tree


@pytest.fixture(scope="module")
def centernet():
    oc, mc = centernet_config(H, W)
    jax_model = JaxCenterpointDLA34(object_config=oc, deform=False)
    variables = _randomize_stats(jax.jit(
        lambda k: jax_model.init(k, jnp.zeros((1, 32, 32, 3)), train=False)
    )(jax.random.key(0)), 0)
    port = CenterpointDLA34(oc, device="cpu").eval()
    port.load_state_dict(centerpoint_state_dict_from_flax(variables))
    return jax_model, variables, port, mc


@pytest.fixture(scope="module")
def yolact():
    cfg = yolact_config(H, W, feature_depth=32)
    jax_model = JaxYolact(cfg)
    variables = _randomize_stats(jax.jit(
        lambda k: jax_model.init(k, jnp.zeros((1, H, W, 3)), train=False)
    )(jax.random.key(1)), 1)
    port = Yolact(cfg, device="cpu").eval()
    port.load_state_dict(yolact_state_dict_from_flax(variables))
    return jax_model, variables, port, cfg


def _image(seed):
    return np.random.default_rng(seed).normal(size=(2, H, W, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def test_torch_centerpoint_dla34_matches_jax(centernet):
    jax_model, variables, port, _ = centernet
    x = _image(3)
    want = jax_model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(_nchw(x))
    assert len(port.depthwise_upsamples()) == 8
    for name in ("heatmap", "size", "offset"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape == (2, H // 4, W // 4, g.shape[-1]), name
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=name)
    np.testing.assert_array_equal(got.heatmap_nchw().numpy(),
                                  np.transpose(got.heatmap.numpy(), (0, 3, 1, 2)))


def test_torch_yolact_matches_jax(yolact):
    jax_model, variables, port, _ = yolact
    x = _image(4)
    want = jax_model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(_nchw(x))
    for name in ("classification", "box_encoding", "mask_coeff", "anchor",
                 "mask_prototype"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=name)


def test_torch_combined_pipeline_matches_jax(centernet, yolact):
    cn_jax, cn_vars, cn_port, cn_cfg = centernet
    yl_jax, yl_vars, yl_port, yl_cfg = yolact
    frames = np.random.default_rng(0).integers(0, 256, (2, 80, 96, 3), np.uint8)

    jax_pipe = jax_make_combined_pipeline(
        lambda img: cn_jax.apply(cn_vars, img, train=False), cn_cfg,
        lambda img: yl_jax.apply(yl_vars, img, train=False), yl_cfg,
        ALL_SLOTS.n_detections, ALL_SLOTS.score_threshold, ALL_SLOTS.top_k,
        ALL_SLOTS.iou_threshold, ALL_SLOTS.confidence_threshold,
        dtype=jnp.float32,
    )
    port_pipe = make_combined_pipeline(
        cn_port, cn_cfg, yl_port, yl_cfg, torch.device("cpu"), knobs=ALL_SLOTS,
    )
    want_cn, want_yl = jax_pipe(jnp.asarray(frames))
    before = dict(kernels.LAUNCHES)
    got_cn, got_yl = port_pipe(frames)
    assert kernels.LAUNCHES == before  # CPU tensors take the plain versions

    assert got_cn.score.shape == (2, ALL_SLOTS.n_detections)
    assert got_yl.mask.shape == (2, ALL_SLOTS.top_k, H // 2, W // 2)
    for got, want in ((got_cn, want_cn), (got_yl, want_yl)):
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        stats = detection_deltas(want, got)
        assert stats["total"] == int(got.valid.sum()) > 0
        assert stats["matched_fraction"] == 1.0, stats
        for what in ("center", "score", "size"):
            assert stats[f"{what}_delta_p95"] <= 1e-5, stats
    np.testing.assert_allclose(got_yl.mask.numpy(), np.asarray(want_yl.mask),
                               rtol=0, atol=1e-5)

    # The per-net pipelines resize the same way, so they decode identically.
    cpu = torch.device("cpu")
    alone = (make_centernet_pipeline(cn_port, cn_cfg, cpu, ALL_SLOTS)(frames),
             make_yolact_pipeline(yl_port, yl_cfg, cpu, ALL_SLOTS)(frames))
    for fused, single in zip((got_cn, got_yl), alone):
        for name, value in vars(fused).items():
            if value is not None:
                assert torch.equal(value, getattr(single, name)), name
