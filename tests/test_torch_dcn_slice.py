"""The DCN-IDA CenterNet of the PyTorch port against the JAX package.

The reference's deployed net, ``CenterpointDLA34(deform=True)`` at full
width, with the JAX package's torchvision-exact ``dcn_impl="gather"``.
Both stacks run the same weights, carried over by
``tauv_vision_tpu_torch.weights``, on the same numpy inputs.  Every
weight and BatchNorm statistic is drawn with numpy from a seed
(``torch_parity.random_variables``): the JAX init zeroes the offset and
mask kernels, which would let a sampler that ignores offsets pass, so
here offsets reach a few cells, fractional, and some samples leave the
map:

- raw heads at 72x104, an odd size whose ida_up x4 branch reaches
  ``pad_to_match``'s pad-then-crop shift in front of a DCN node: within
  2e-4, the bound of the plain-IDA slice (f32 conv and DCN sums in
  another order, through 16 DCN blocks);
- ``make_combined_pipeline`` with this net and a narrow YOLACT on uint8
  80x96 frames resized to 72x104: 100% of decoded detections matched,
  every p95 <= 1e-5, at decode thresholds 0 so that every slot counts.
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
from tauv_vision_tpu_torch.serving.pipeline import DecodeKnobs, make_combined_pipeline
from tauv_vision_tpu_torch.weights import (
    centerpoint_state_dict_from_flax,
    yolact_state_dict_from_flax,
)
from torch_parity import random_variables

H, W = 72, 104
ALL_SLOTS = DecodeKnobs(score_threshold=0.0, confidence_threshold=0.0)


@pytest.fixture(scope="module")
def dcn_centernet():
    oc, mc = centernet_config(H, W)
    jax_model = JaxCenterpointDLA34(object_config=oc, deform=True, dcn_impl="gather")
    variables = random_variables(jax_model, (1, 32, 32, 3), 0)
    port = CenterpointDLA34(oc, deform=True, device="cpu").eval()
    port.load_state_dict(centerpoint_state_dict_from_flax(variables), strict=True)
    return jax_model, variables, port, mc


@pytest.fixture(scope="module")
def yolact():
    cfg = yolact_config(H, W, feature_depth=32)
    jax_model = JaxYolact(cfg)
    variables = random_variables(jax_model, (1, H, W, 3), 1)
    port = Yolact(cfg, device="cpu").eval()
    port.load_state_dict(yolact_state_dict_from_flax(variables), strict=True)
    return jax_model, variables, port, cfg


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def test_torch_dcn_centerpoint_dla34_matches_jax(dcn_centernet):
    jax_model, variables, port, _ = dcn_centernet
    x = np.random.default_rng(3).normal(size=(2, H, W, 3)).astype(np.float32)
    want = jax_model.apply(variables, jnp.asarray(x), train=False)

    dcns = port.deform_convs()
    assert len(dcns) == 16
    offsets = []
    hooks = [m.register_forward_pre_hook(lambda m, args: offsets.append(args[1]))
             for m in dcns]
    with torch.no_grad():
        got = port(_nchw(x))
    for h in hooks:
        h.remove()
    assert len(offsets) == 16
    reach = max(o.abs().max().item() for o in offsets)
    assert reach > 2.0, reach   # whole-cell moves, some of them off the map
    for name in ("heatmap", "size", "offset"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape == (2, H // 4, W // 4, g.shape[-1]), name
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=name)


def test_torch_dcn_combined_pipeline_matches_jax(dcn_centernet, yolact):
    cn_jax, cn_vars, cn_port, cn_cfg = dcn_centernet
    yl_jax, yl_vars, yl_port, yl_cfg = yolact
    frames = np.random.default_rng(0).integers(0, 256, (2, 80, 96, 3), np.uint8)

    jax_pipe = jax_make_combined_pipeline(
        lambda img: cn_jax.apply(cn_vars, img, train=False), cn_cfg,
        lambda img: yl_jax.apply(yl_vars, img, train=False), yl_cfg,
        ALL_SLOTS.n_detections, ALL_SLOTS.score_threshold, ALL_SLOTS.top_k,
        ALL_SLOTS.iou_threshold, ALL_SLOTS.confidence_threshold,
        dtype=jnp.float32, jit=False,
    )
    port_pipe = make_combined_pipeline(
        cn_port, cn_cfg, yl_port, yl_cfg, torch.device("cpu"), knobs=ALL_SLOTS,
    )
    want_cn, want_yl = jax_pipe(jnp.asarray(frames))
    before = dict(kernels.LAUNCHES)
    got_cn, got_yl = port_pipe(frames)
    assert kernels.LAUNCHES == before  # CPU tensors take the plain versions

    for got, want in ((got_cn, want_cn), (got_yl, want_yl)):
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        stats = detection_deltas(want, got)
        assert stats["total"] == int(got.valid.sum()) > 0
        assert stats["matched_fraction"] == 1.0, stats
        for what in ("center", "score", "size"):
            assert stats[f"{what}_delta_p95"] <= 1e-5, stats
