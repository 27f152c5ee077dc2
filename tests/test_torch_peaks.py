"""Peak decode of the PyTorch port against the JAX package.

The port's plain ``peak_decode`` is held to the XLA ``ops/peaks.peak_decode``
and to the Pallas kernel in interpret mode: index and label exactly,
score within 1e-6 (sigmoid implementations may differ by an ulp).  The
planted-ties case pins the tie rule (equal scores in ascending flat-index
order). The CUDA kernel itself is compared on the card by
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
from tauv_vision_tpu_torch.ops.peaks import peak_decode, peak_decode_cuda


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

