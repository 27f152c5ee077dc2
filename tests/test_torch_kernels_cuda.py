"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and
skips without one.  The file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: peak decode index/label exact and score 1e-6; mask assembly
1e-5 (an 8-term dot summed in another order); depthwise upsample rtol =
atol = 1e-5 (4 f32 taps in another order than cuDNN); deformable conv
rtol = atol = 1e-4 (9 C f32 products an output, up to 4,608 at the
served shapes, summed in another order than the plain per-tap GEMMs).
"""

import numpy as np
import pytest
import torch

from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.models.centerpoint_dla import DeformConvBlock
from tauv_vision_tpu_torch.models.layers import init_parameters
from tauv_vision_tpu_torch.ops.conv_transpose import (
    depthwise_upsample,
    depthwise_upsample_cuda,
)
from tauv_vision_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_cuda
from tauv_vision_tpu_torch.ops.masks import assemble_mask_batch, assemble_mask_cuda
from tauv_vision_tpu_torch.ops.peaks import peak_decode, peak_decode_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _planted_ties(shape):
    x = _normal(shape, 7, 3.0) - 6.0
    x[:, 2, 3, 4] = 20.0       # sigmoid == 1.0 exactly in f32
    x[:, 0, 10, 20] = 25.0
    x[:, 1, 5, 5] = 30.0
    x[:, 0, 15, 8] = x[:, 0, 15, 9] = 12.0   # a 2-cell plateau
    return x


@pytest.mark.parametrize("name,shape,k", [
    ("random", (2, 3, 24, 32), 7),
    ("main_path", (8, 4, 90, 160), 10),
    ("ties", (2, 3, 24, 32), 12),
    ("k_max", (1, 4, 90, 160), 128),
])
def test_torch_peak_decode_kernel_on_card(cuda, name, shape, k):
    x = (_planted_ties(shape) if name == "ties" else _normal(shape, 0, 3.0)).to(cuda)
    before = kernels.LAUNCHES["peak_decode"]
    got = peak_decode_cuda(x, k)
    want = peak_decode(x, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["peak_decode"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("crop", [True, False])
def test_torch_assemble_mask_kernel_on_card(cuda, crop):
    b, p, k, h, w = 2, 8, 20, 180, 320
    rng = np.random.default_rng(1)
    proto = _normal((b, p, h, w), 2).to(cuda)
    coeff = torch.tanh(_normal((b, k, p), 3)).to(cuda)
    box = torch.from_numpy(np.concatenate(
        [rng.uniform(0.0, 1.0, (b, k, 2)), rng.uniform(0.0, 0.6, (b, k, 2))], -1
    ).astype(np.float32)).to(cuda) if crop else None
    got = assemble_mask_cuda(proto, coeff, box)
    want = assemble_mask_batch(proto, coeff, box)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("f,h,w,c", [
    (2, 45, 80, 64), (4, 23, 40, 64), (2, 12, 20, 256), (2, 23, 40, 128),
    (2, 5, 7, 8), (4, 3, 5, 16),
])
def test_torch_depthwise_upsample_kernel_on_card(cuda, f, h, w, c):
    x = _normal((2, c, h, w), 4).to(cuda)
    weight = _normal((c, 1, 2 * f, 2 * f), 5).to(cuda)
    got = depthwise_upsample_cuda(x, weight, f)
    want = depthwise_upsample(x, weight, f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _dcn_inputs(case, b, c, o, h, w):
    """x, offset, mask, weight, bias on the CPU.  ``block``: the offsets
    and masks of a seeded DeformConvBlock, as the served net makes them;
    ``planted_40``: offsets uniform in +-40 cells, far past the map;
    ``negative_fraction``: positions in (-1, 0) of the tap, where a
    truncating floor would go wrong; ``no_mask``: the block's offsets and
    no mask."""
    x = _normal((b, c, h, w), 8)
    block = DeformConvBlock(c, o, deform=True)
    init_parameters(block, torch.Generator().manual_seed(9))
    with torch.no_grad():
        offset = block.offset(x)
        mask = torch.sigmoid(block.mask(x))
    rng = np.random.default_rng(10)
    if case == "planted_40":
        offset = torch.from_numpy(rng.uniform(-40, 40, offset.shape).astype(np.float32))
    elif case == "negative_fraction":
        offset = torch.from_numpy(rng.uniform(-1, 0, offset.shape).astype(np.float32))
    bias = _normal((o,), 11, 0.1)
    return (x, offset, None if case == "no_mask" else mask,
            block.conv.weight.detach().clone(), bias)


@pytest.mark.parametrize("case", ["block", "planted_40", "negative_fraction", "no_mask"])
@pytest.mark.parametrize("b,c,o,h,w", [
    (2, 128, 64, 45, 80),    # ida_2 proj and ida_up proj_1 of the served net
    (1, 6, 5, 9, 11),        # ragged pixel, channel and output tiles
])
def test_torch_deform_conv_kernel_on_card(cuda, case, b, c, o, h, w):
    args = _dcn_inputs(case, b, c, o, h, w)
    want = deform_conv2d(*(None if a is None else a.to(cuda) for a in args))
    before = kernels.LAUNCHES["deform_conv"]
    got = deform_conv2d_cuda(*(None if a is None else a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["deform_conv"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.cpu(), deform_conv2d(*args), rtol=1e-4, atol=1e-4)


def test_torch_kernel_wrappers_reject_bad_input(cuda):
    x = _normal((1, 4, 8, 8), 6).to(cuda)
    with pytest.raises(TypeError):
        peak_decode_cuda(x.double(), 3)
    with pytest.raises(ValueError):
        peak_decode_cuda(x.transpose(2, 3), 3)
    with pytest.raises(ValueError):
        depthwise_upsample_cuda(x, torch.ones(4, 1, 3, 3, device=cuda), 2)
    x, offset, mask, weight, bias = (
        a.to(cuda) for a in _dcn_inputs("block", 1, 4, 3, 6, 7))
    with pytest.raises(TypeError):
        deform_conv2d_cuda(x.double(), offset, mask, weight.double(), bias)
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, offset.transpose(2, 3).contiguous().transpose(2, 3),
                           mask, weight, bias)
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, offset, mask.cpu(), weight, bias)
    with pytest.raises(ValueError):
        deform_conv2d_cuda(x, offset, mask, weight[:, :, :2, :2].contiguous(), bias)
