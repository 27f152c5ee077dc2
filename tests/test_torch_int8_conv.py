"""The int8 chain's integer conv core on the CPU, at the few rows a
batch-1 frame gives its last FPN levels.

``conv2d_int8_im2col`` is the card's route (im2col + ``torch._int_mm``),
which needs more than 16 rows: below that it adds zero rows up to 32 and
slices them off.  ``torch._int_mm`` also runs on the CPU, so the route is
held here to the float64 convolution ``conv2d_int8_f64`` (the CPU path and
the reference on the card) at 1-17 rows, kernel sizes 1 and 3, strides 1
and 2: exactly, since integer sums are exact in any order.  A conv whose
output channels are not a multiple of 8 (the CenterNet chain's heads: 1,
2 and 4) runs with zero output channels up to the next multiple, sliced
off after: held at N = 1, 2, 4 and 16 at batch 1, at the heads' 90x160
map and at a few pixels, and the YOLO-Pose chain's shapes: the Pointnet's 7x7
convs (K = 3,136 and 4,704) and its heads' 4 and 22 outputs.  The card
repeats the check on ``conv2d_int8``
(``test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

from tauv_vision_tpu_torch.ops.int8_conv import (
    conv2d_int8,
    conv2d_int8_f64,
    conv2d_int8_im2col,
)


def _codes(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (1, 2), (3, 2)])
@pytest.mark.parametrize("rows", range(1, 18))
def test_torch_conv2d_int8_im2col_few_rows_matches_f64(rows, k, stride):
    # One output row of `rows` pixels: input width (rows - 1) * stride + 1,
    # padding (k - 1) / 2.
    q = _codes((1, 1, (rows - 1) * stride + 1, 8), rows)
    qk = _codes((k, k, 8, 16), 100 + rows)
    got = conv2d_int8_im2col(q, qk, stride, (k - 1) // 2)
    want = conv2d_int8_f64(q, qk, stride, (k - 1) // 2)
    assert got.shape == want.shape == (1, 1, rows, 16) and got.dtype == torch.int32
    assert torch.equal(got, want)


def test_torch_conv2d_int8_im2col_batch_and_rows_above_padding():
    """Rows spread over a batch (3 frames of 5 pixels), and a conv of more
    than 32 rows, where nothing is padded."""
    for q, qk, stride in ((_codes((3, 2, 5, 16), 1), _codes((3, 3, 16, 8), 2), (2, 1)),
                          (_codes((2, 6, 7, 24), 3), _codes((3, 3, 24, 8), 4), 1)):
        assert torch.equal(conv2d_int8_im2col(q, qk, stride, 1), conv2d_int8_f64(q, qk, stride, 1))


def test_torch_conv2d_int8_im2col_rejects_unaligned_depth():
    """torch._int_mm on the card needs K and N multiples of 8: the route
    pads N, and raises on a K that is not (no chain conv has one), on the
    CPU too, as it would there."""
    q = _codes((1, 4, 4, 4), 5)
    with pytest.raises(ValueError):
        conv2d_int8_im2col(q, _codes((3, 3, 4, 8), 6), 1, 1)     # K = 36
    with pytest.raises(ValueError):
        conv2d_int8_im2col(q, _codes((1, 1, 4, 8), 7)[..., :4], 1, 0)   # K 4, N 4
    # conv2d_int8 on a CPU tensor takes the float64 route, which has no such rule.
    assert torch.equal(conv2d_int8(q, _codes((3, 3, 4, 8), 6), 1, 1),
                       conv2d_int8_f64(q, _codes((3, 3, 4, 8), 6), 1, 1))


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("hw,k", [((90, 160), 1), ((3, 5), 1), ((4, 6), 3)],
                         ids=["head_90x160", "rows_15", "k3_rows_24"])
def test_torch_conv2d_int8_im2col_pads_output_channels(n, hw, k):
    """Batch 1, K = 256 (a head's out conv) or 9 x 32: exact at every N."""
    c = 256 if k == 1 else 32
    q = _codes((1, *hw, c), n)
    qk = _codes((k, k, c, n), 200 + n)
    got = conv2d_int8_im2col(q, qk, 1, (k - 1) // 2)
    want = conv2d_int8_f64(q, qk, 1, (k - 1) // 2)
    assert got.shape == want.shape == (1, *hw, n) and got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,fill", [(64, None), (96, None), (96, 127)],
                         ids=["c64", "c96", "c96_saturated"])
def test_torch_conv2d_int8_im2col_pointnet_7x7_matches_f64(c, fill):
    """The YOLO-Pose Pointnet's 7x7 convs at the bench's 30x60 map, batch 1
    (K = 3,136 and 4,704; saturated codes give the largest accumulator,
    127^2 49 96): exact."""
    shapes = (1, 30, 60, c), (7, 7, c, 64)
    q, qk = ((torch.full(s, fill, dtype=torch.int8) if fill else _codes(s, c + i))
             for i, s in enumerate(shapes))
    got = conv2d_int8_im2col(q, qk, 1, 3)
    assert got.shape == (1, 30, 60, 64) and torch.equal(got, conv2d_int8_f64(q, qk, 1, 3))


@pytest.mark.parametrize("n", [4, 22])
def test_torch_conv2d_int8_im2col_yolo_pose_head_widths(n):
    """The YOLO-Pose head's box (4) and class (22) output convs, 3x3 over
    64 channels, padded to 8 and 24 output channels: exact."""
    q, qk = _codes((2, 4, 8, 64), n), _codes((3, 3, 64, n), 300 + n)
    assert torch.equal(conv2d_int8_im2col(q, qk, 1, 1), conv2d_int8_f64(q, qk, 1, 1))
