"""Gradients through the port's model on the CPU.

- Kernels C and E under autograd (``depthwise_upsample_train``,
  ``deform_conv2d_train``): on a CPU tensor their forward is the plain
  version and their backward recomputes it, so their gradients must equal
  autograd straight through the plain versions, in f32 and bf16, to every
  input that takes one.
- The bf16 DCN DLA-34 as the JAX package trains it (``dtype=bf16``, f32
  BatchNorm outputs, DCN IDA, the flax init): one train step gives every parameter that
  the forward reads a finite, non-zero gradient.  That shows that the bf16
  casts of the f32 parameters are in the graph (``params.cast_parameter``)
  here, where the kernels do not run.
- ``init="flax"``: offset and mask convs zero, so the first offsets are
  0; the DCN weights He normal, truncated as flax's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tauv_vision_tpu_torch.configs import samples_torpedo
from tauv_vision_tpu_torch.data.synthetic import SquareDatasetConfig, generate_square_batch
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34, DeformConvBlock
from tauv_vision_tpu_torch.ops.conv_transpose import (
    depthwise_upsample,
    depthwise_upsample_train,
)
from tauv_vision_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_train
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import make_centernet_train_step
from torch_parity import DISCARDED_PROJECTIONS, square_configs, torch_threads

DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _grads(fn, inputs):
    leaves = [t.detach().clone().requires_grad_(True) if t is not None else None
              for t in inputs]
    out = fn(*leaves)
    seed = torch.from_numpy(np.random.default_rng(9).normal(size=out.shape).astype(np.float32))
    out.backward(seed.to(out.dtype))
    return out.detach(), [None if t is None else t.grad for t in leaves]


def _assert_same(port, want):
    (out, grads), (want_out, want_grads) = port, want
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for g, w in zip(grads, want_grads):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("factor", [2, 4])
def test_torch_upsample_function_grads_equal_plain(dtype, factor):
    rng = np.random.default_rng(factor)
    x = torch.from_numpy(rng.normal(size=(2, 8, 5, 7)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(8, 1, 2 * factor, 2 * factor)).astype(np.float32))
    inputs = (x, w.to(dtype))
    _assert_same(_grads(lambda a, b: depthwise_upsample_train(a, b, factor), inputs),
                 _grads(lambda a, b: depthwise_upsample(a, b, factor), inputs))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_mask", [True, False])
def test_torch_deform_conv_function_grads_equal_plain(dtype, with_mask):
    rng = np.random.default_rng(3)
    b, c, h, w, o = 2, 32, 6, 9, 16
    x = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32)).to(dtype)
    offset = torch.from_numpy(rng.uniform(-2.5, 2.5, (b, 18, h, w)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(0, 1, (b, 9, h, w)).astype(np.float32)).to(dtype)
    weight = torch.from_numpy(rng.normal(size=(o, c, 3, 3)).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.normal(size=(o,)).astype(np.float32))
    inputs = (x, offset, mask if with_mask else None, weight, bias)
    _assert_same(_grads(lambda *a: deform_conv2d_train(*a), inputs),
                 _grads(deform_conv2d, inputs))


def test_torch_flax_init_zeroes_offsets_and_masks():
    oc, _ = square_configs(64, 96)
    model = CenterpointDLA34(oc, deform=True, device="cpu", init="flax",
                             generator=torch.Generator().manual_seed(0))
    blocks = [m for m in model.modules() if isinstance(m, DeformConvBlock)]
    assert len(blocks) == 16
    for block in blocks:
        for conv in (block.offset, block.mask):
            assert not conv.weight.any() and not conv.bias.any()
        # He normal, truncated at 2 standard deviations: std sqrt(2 / (9 C)).
        w = block.conv.weight
        std = (2.0 / w[0].numel()) ** 0.5
        assert abs(float(w.detach().std()) / std - 1) < 0.05
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    heads = model.model
    assert torch.all(getattr(heads, "0")[2].bias == -2.19)


def test_torch_bf16_train_step_reaches_every_parameter():
    oc, mc = square_configs(64, 96)
    # samples_torpedo's lambdas, with the offset term on so that the offset
    # head is read too (its lambda is 0 there).
    tc = dataclasses.replace(samples_torpedo.train_config, loss_lambda_offset=1.0)
    model = CenterpointDLA34(oc, deform=True, device="cpu", dtype=torch.bfloat16, init="flax",
                             generator=torch.Generator().manual_seed(0)).eval()
    img, truth = generate_square_batch(np.random.default_rng(0), 2, SquareDatasetConfig(
        in_h=64, in_w=96, max_objects=4, min_side=8, max_side=16, keypoints=True))
    state = TrainState(model, adam_with_clip(model.parameters(), tc.lr, tc.grad_max_norm))
    step = make_centernet_train_step(mc, tc, oc)
    _, losses = step(state, torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(),
                     truth.to("cpu"))
    assert torch.isfinite(losses.total)
    named = dict(model.named_parameters())
    assert len(named) == 281
    for name, p in named.items():
        assert p.dtype == torch.float32, name
        if name.startswith(DISCARDED_PROJECTIONS):
            assert p.grad is None or not p.grad.any(), name
            continue
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
    assert not model.training
