"""Mask assembly of the PyTorch port against the JAX package.

The port's plain ``assemble_mask_batch`` (and its ``box_to_mask`` crop)
is held to the XLA ``ops/masks.assemble_mask_batch`` and to the Pallas
kernel in interpret mode, within 1e-5 (f32 matmul accumulation order),
with the crop and without, also fed the NHWC view of the prototypes
that the int8 chain makes (kernel B reads it in place), and through
``decode_yolact``.  The crop edges are inclusive and must agree to the
bit. The CUDA kernel itself is compared on the card by
test_torch_kernels_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tauv_vision_tpu.ops.boxes import box_to_mask as box_to_mask_jax
from tauv_vision_tpu.ops.masks import assemble_mask_batch as assemble_xla
from tauv_vision_tpu.models.yolact import YolactPrediction as JaxYolactPrediction
from tauv_vision_tpu.ops.pallas.mask_assembly import assemble_mask_pallas
from tauv_vision_tpu.serving.yolact_decode import decode_yolact as jax_decode_yolact
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import yolact_config
from tauv_vision_tpu_torch.models.yolact import YolactPrediction
from tauv_vision_tpu_torch.ops.boxes import box_to_mask
from tauv_vision_tpu_torch.ops.masks import assemble_mask_batch, assemble_mask_cuda
from tauv_vision_tpu_torch.serving.yolact_decode import decode_yolact
from torch_parity import jax_yolact_config


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _inputs(b=2, p=8, k=6, h=24, w=32, seed=1):
    rng = np.random.default_rng(seed)
    proto = rng.normal(size=(b, p, h, w)).astype(np.float32)
    coeff = rng.normal(size=(b, k, p)).astype(np.float32)
    box = np.concatenate(
        [rng.uniform(0.2, 0.8, (b, k, 2)), rng.uniform(0.1, 0.6, (b, k, 2))], -1
    ).astype(np.float32)
    return proto, coeff, box


def _port(proto, coeff, box):
    return assemble_mask_batch(
        torch.from_numpy(proto), torch.from_numpy(coeff),
        None if box is None else torch.from_numpy(box),
    ).numpy()


@pytest.mark.parametrize("crop", [True, False])
def test_torch_assemble_mask_matches_xla(crop):
    proto, coeff, box = _inputs()
    box = box if crop else None
    want = assemble_xla(jnp.asarray(proto), jnp.asarray(coeff),
                        None if box is None else jnp.asarray(box))
    np.testing.assert_allclose(_port(proto, coeff, box), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("crop", [True, False])
def test_torch_assemble_mask_matches_pallas_interpret(interpret_pallas, crop):
    proto, coeff, box = _inputs(b=1, p=4, k=3, h=16, w=16, seed=2)
    box = box if crop else None
    want = assemble_mask_pallas(
        jnp.asarray(proto), jnp.asarray(coeff),
        None if box is None else jnp.asarray(box), crop,
    )
    np.testing.assert_allclose(_port(proto, coeff, box), np.asarray(want),
                               rtol=0, atol=1e-5)


def test_torch_box_to_mask_inclusive_edges_bit_equal():
    """Edges that land exactly on pixel coordinates are inside, and random
    boxes rasterise to the same pixels as the JAX package's."""
    exact = np.array([[0.5, 0.5, 0.25, 0.5], [0.25, 0.75, 0.5, 0.25]], np.float32)
    rng = np.random.default_rng(3)
    rand = rng.uniform(0.0, 1.0, (64, 4)).astype(np.float32)
    for box, hw in ((exact, (16, 32)), (rand, (180, 320)), (rand, (23, 41))):
        got = box_to_mask(torch.from_numpy(box), hw).numpy()
        np.testing.assert_array_equal(got, np.asarray(box_to_mask_jax(jnp.asarray(box), hw)))
    m = box_to_mask(torch.from_numpy(exact), (16, 32)).numpy()
    assert m[0, 6, 8] == 1.0 and m[0, 10, 24] == 1.0 and m[0, 11, 24] == 0.0


def test_torch_assemble_mask_wrapper_takes_plain_on_cpu():
    proto, coeff, box = (torch.from_numpy(a) for a in _inputs())
    before = dict(kernels.LAUNCHES)
    got = assemble_mask_cuda(proto, coeff, box)
    assert kernels.LAUNCHES == before
    assert torch.equal(got, assemble_mask_batch(proto, coeff, box))
    with pytest.raises(ValueError):
        assemble_mask_cuda(proto, coeff[:, :, :3], box)



@pytest.mark.parametrize("crop", [True, False])
def test_torch_assemble_mask_wrapper_nhwc_view_matches_jax(interpret_pallas, crop):
    """The wrapper fed the NHWC view (as the int8 chain's decode feeds it)
    equals the XLA function and the Pallas kernel on the NCHW array."""
    proto, coeff, box = _inputs(b=2, p=8, k=5, h=18, w=30, seed=4)
    box = box if crop else None
    view = torch.from_numpy(np.ascontiguousarray(proto.transpose(0, 2, 3, 1))).permute(0, 3, 1, 2)
    assert not view.is_contiguous() and view.permute(0, 2, 3, 1).is_contiguous()
    before = dict(kernels.LAUNCHES)
    got = assemble_mask_cuda(view, torch.from_numpy(coeff),
                             None if box is None else torch.from_numpy(box)).numpy()
    assert kernels.LAUNCHES == before
    jax_box = None if box is None else jnp.asarray(box)
    for want in (assemble_xla(jnp.asarray(proto), jnp.asarray(coeff), jax_box),
                 assemble_mask_pallas(jnp.asarray(proto), jnp.asarray(coeff), jax_box, crop)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_torch_decode_yolact_nhwc_prototypes_matches_jax():
    """``decode_yolact`` on a prediction whose prototypes are a contiguous
    NHWC array (the int8 chain's), which it hands to mask assembly as a
    view: the JAX decode's detections, masks within 1e-5."""
    cfg = yolact_config(72, 104, feature_depth=32)
    rng = np.random.default_rng(5)
    b, n, p, c = 2, 60, cfg.n_prototype_masks, cfg.n_classes + 1
    arrays = dict(
        classification=rng.normal(size=(b, n, c)).astype(np.float32) * 2,
        box_encoding=rng.normal(size=(b, n, 4)).astype(np.float32),
        mask_coeff=np.tanh(rng.normal(size=(b, n, p))).astype(np.float32),
        anchor=np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))],
                              -1).astype(np.float32),
        mask_prototype=rng.normal(size=(b, 36, 52, p)).astype(np.float32),
    )
    got = decode_yolact(YolactPrediction(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                        cfg, 8, 0.5, 0.2)
    want = jax_decode_yolact(JaxYolactPrediction(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                             jax_yolact_config(cfg), 8, 0.5, 0.2)
    assert got.valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.label.numpy(), np.asarray(want.label))
    for name in ("score", "box"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.mask.numpy(), np.asarray(want.mask), rtol=0, atol=1e-5)
