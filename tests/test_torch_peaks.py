"""Peak decode of the PyTorch port against the JAX package.

The port's plain ``peak_decode`` is held to the XLA ``ops/peaks.peak_decode``
and to the Pallas kernel in interpret mode: index and label exactly,
score within 1e-6 (sigmoid implementations may differ by an ulp).  The
planted-ties case pins the tie rule (equal scores in ascending flat-index
order).  Kernel A's design, a top-K a tile and an exact merge an image, is
replayed here in numpy on the port's tiling (``peak_tiles``) and held to
the same references, with ties planted across tile edges and maps with
fewer than K peaks.  The CUDA kernel itself is compared on the card by
test_torch_kernels_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tauv_vision_tpu.ops.pallas.peak_decode import peak_decode_pallas
from tauv_vision_tpu.ops.peaks import peak_decode as peak_decode_xla
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.ops.peaks import (
    heatmap_nms,
    peak_decode,
    peak_decode_cuda,
    peak_tiles,
)


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _random_logits(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 3).astype(np.float32)


def _planted_ties(shape=(2, 3, 24, 32)):
    """Saturated logits (sigmoid == 1.0 exactly in f32) on isolated cells
    of several channels, plus a 2-cell plateau that survives the 3x3
    equality NMS whole."""
    x = _random_logits(shape, 7) - 6.0
    for b in range(shape[0]):
        x[b, 2, 3, 4] = 20.0
        x[b, 0, 10, 20] = 25.0
        x[b, 1, 5, 5] = 30.0
        x[b, 0, 15, 8] = x[b, 0, 15, 9] = 12.0
    return x


def _assert_same(port, ref):
    index, label, score = (t.numpy() for t in port)
    np.testing.assert_array_equal(index, np.asarray(ref[0]))
    np.testing.assert_array_equal(label, np.asarray(ref[1]))
    np.testing.assert_allclose(score, np.asarray(ref[2]), rtol=0, atol=1e-6)


CASES = [
    ("random", (2, 3, 24, 32), 7),
    ("main_path", (2, 4, 90, 160), 10),
    ("ties", None, 12),
]


def _case(name, shape):
    return _planted_ties() if name == "ties" else _random_logits(shape, 0)


@pytest.mark.parametrize("name,shape,k", CASES)
def test_torch_peak_decode_matches_xla(name, shape, k):
    x = _case(name, shape)
    _assert_same(peak_decode(torch.from_numpy(x), k),
                 peak_decode_xla(jnp.asarray(x), k))


@pytest.mark.parametrize("name,shape,k", CASES[::2])
def test_torch_peak_decode_matches_pallas_interpret(interpret_pallas, name, shape, k):
    x = _case(name, shape)
    _assert_same(peak_decode(torch.from_numpy(x), k),
                 peak_decode_pallas(jnp.asarray(x), k))


def test_torch_peak_decode_tie_order():
    """Equal scores come out in ascending flat index: the three saturated
    cells (label 0 before 1 before 2 by flat index), then the plateau."""
    index, label, score = peak_decode(torch.from_numpy(_planted_ties()), 5)
    np.testing.assert_array_equal(score[0, :3].numpy(), [1.0, 1.0, 1.0])
    np.testing.assert_array_equal(label[0].numpy(), [0, 1, 2, 0, 0])
    np.testing.assert_array_equal(
        index[0].numpy(), [[10, 20], [5, 5], [3, 4], [15, 8], [15, 9]]
    )
    assert score[0, 3] == score[0, 4]


def test_torch_peak_decode_wrapper_takes_plain_on_cpu():
    x = torch.from_numpy(_random_logits((2, 4, 18, 26), 1))
    before = dict(kernels.LAUNCHES)
    got = peak_decode_cuda(x, 10)
    assert kernels.LAUNCHES == before
    for a, b in zip(got, peak_decode(x, 10)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        peak_decode_cuda(x, 0)



def _tile_merge(logits, k, kernel_size=3):
    """Kernel A's selection in numpy: each tile's best K positive cells
    under the key (score, -flat index), the image's best K of their union,
    and, past the positive cells, the zeros of smallest flat index."""
    supp = heatmap_nms(torch.sigmoid(torch.from_numpy(logits)), kernel_size).numpy()
    b, c, h, w = supp.shape
    tile_h, tile_w, tiles = peak_tiles(c, h, w)
    index, label, score = [], [], []
    for img in supp:
        cand, n_tiles = [], 0
        for ch in range(c):
            for y0 in range(0, h, tile_h):
                for x0 in range(0, w, tile_w):
                    n_tiles += 1
                    ys, xs = np.nonzero(img[ch, y0:y0 + tile_h, x0:x0 + tile_w] > 0)
                    flat = (ch * h + y0 + ys) * w + x0 + xs
                    keys = sorted(zip(img.reshape(-1)[flat], -flat), reverse=True)
                    cand += keys[:k]
        assert n_tiles == tiles
        best = sorted(cand, reverse=True)[:k]
        positive = {-f for _, f in best}
        zeros = (j for j in range(c * h * w) if j not in positive)
        best += [(np.float32(0), -next(zeros)) for _ in range(k - len(best))]
        flat = np.array([-f for _, f in best])
        index.append(np.stack(((flat % (h * w)) // w, flat % w), -1))
        label.append(flat // (h * w))
        score.append(np.array([v for v, _ in best], np.float32))
    return np.array(index), np.array(label), np.array(score)


def _band_ties(shape):
    """Saturated cells and plateaus on both sides of the 16-row band edges
    and a 256-column tile edge, in several channels."""
    x = _random_logits(shape, 8) - 6.0
    x[:, 2, 15, 4] = 20.0
    x[:, 0, 16, 100] = 25.0
    x[:, 1, 31, 255] = 30.0
    x[:, 3, 32, 256] = 40.0
    x[:, 3, 15:17, 120] = 12.0
    x[:, 1, 20, 255:257] = 12.0
    return x


def _sparse(shape):
    x = np.full(shape, -200.0, np.float32)   # sigmoid == 0 in f32
    x[:, 1, 0, 0] = 2.0
    x[:, 2, 16, shape[3] - 1] = 3.0
    return x


TILE_CASES = {
    "band_ties": (_band_ties, (2, 4, 37, 300)),
    "sparse": (_sparse, (2, 3, 40, 160)),
    "flat": (lambda shape: np.zeros(shape, np.float32), (1, 2, 20, 24)),
    "random": (lambda shape: _random_logits(shape, 3), (2, 4, 90, 160)),
}


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("name", list(TILE_CASES))
def test_torch_peak_decode_tile_merge_is_exact(name, k):
    make, shape = TILE_CASES[name]
    x = make(shape)
    _assert_same([torch.from_numpy(a) for a in _tile_merge(x, k)],
                 peak_decode_xla(jnp.asarray(x), k))
