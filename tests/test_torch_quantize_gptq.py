"""GPTQ of ``scripts/quantize_accuracy_check.py``'s ladder in the PyTorch
port against the JAX package, on the CPU: ``calibrate_gptq`` and
``ChainCtx(wq_override=)``, on the nets, fixtures and chain helpers of
``tests/test_torch_quantize_accuracy.py`` (the DLA-34 CenterNet at 64x128
in bf16 with f32 BatchNorm outputs, the same numpy weights in both stacks,
JAX's calibrations op by op):

- ``calibrate_gptq`` on JAX's inputs, symmetric and asymmetric, on the
  CenterNet's convs but the widest (``GPTQ_SKIP``; the discarded
  projections kept): the int8 codes equal to JAX's but at near-ties (a
  column's first differing code must have W / ws within ``GPTQ_TIE`` of a
  .5 tie in the port's own rounding; counted and named), weight scales
  within ``SCALE_RTOL``; the draws' order is checked by the codes, since a
  draw out of order changes H everywhere.  The widest conv of level 5
  (symmetric) and of level 4 (asymmetric), each alone, by the same bar.
  JAX's weights through both chains (``wq_override``): every int8 map
  equal.
"""

import numpy as np
import pytest
import torch

from tauv_vision_tpu.serving import quantize as jax_quantize
from tauv_vision_tpu_torch.serving import quantize as port_quantize
from tauv_vision_tpu_torch.serving import quantize_chain as port_chain
from tauv_vision_tpu_torch.serving.quantize import calibrate_gptq, strip_scales
from tauv_vision_tpu_torch.serving.quantize_chain import ChainCtx, _wq
from tauv_vision_tpu_torch.weights import centerpoint_flax_path
from test_torch_int8_recipes import SCALE_RTOL, Replay, _centernet, _frames, _yolact, jax_conv_inputs
from test_torch_quantize_accuracy import (
    _assert_chains,
    _chains,
    _conv_shapes,
    jax_ranges,
    jax_scales,
)
from torch_parity import torch_threads

# The CenterNet convs left out of the GPTQ checks: the widest (level 4 and
# 5, DLAUp: 2,304-4,608 input rows, minutes of row-by-row rounding in two
# stacks on the CPU), but the tree projections, whose draws' order the
# JAX-only one decides.
GPTQ_SKIP = ("level4", "level5", "dla_up")
# The input rows of the widest conv of level 5 and of level 4 (3x3 over 512
# and 256 channels), each checked alone.
WIDEST_ROWS = {"level5": 9 * 512, "level4": 9 * 256}
# A code differing from JAX's at a column's first difference: W / ws this
# close to a .5 tie in the port's rounding (an f64 Hessian, its inverse and
# Cholesky factor in another order than numpy's part near 1e-12).
GPTQ_TIE = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def nets(frames):
    return {"centernet": _centernet(frames), "yolact": _yolact(frames)}


@pytest.fixture(scope="module")
def replays(nets):
    """{net: (Replay, JAX's conv calls [(path, input)])}."""
    out = {}
    for name, net in nets.items():
        calls = jax_conv_inputs(net)
        out[name] = (Replay(net, calls, net.jax_only), calls)
    return out


# --------------------------------------------------------------- GPTQ


def _gptq_scales(net, asym: bool):
    scales = {p: s for p, s in jax_scales(net).items()
              if "project_conv" in p or not any(k in p for k in GPTQ_SKIP)}
    if asym:
        return {p: r for p, r in jax_ranges(net).items() if p in scales}
    return scales


def _port_gptq(replay, fold):
    """The port's ``calibrate_gptq`` on ``replay`` and its rounding inputs
    {path: (wf, hinv, ws)}."""
    seen, original = [], port_quantize._gptq_round

    def spy(wf, hinv, ws):
        seen.append((wf, hinv, ws))
        return original(wf, hinv, ws)

    port_quantize._gptq_round = spy
    try:
        got = calibrate_gptq(replay, [None], fold, paths_of=replay.paths_of)
    finally:
        port_quantize._gptq_round = original
    return got, dict(zip(got, seen))


@pytest.fixture(scope="module")
def gptq(nets, replays):
    """{"sym"/"asym": (the fold, JAX's result, the port's, the port's
    rounding inputs {path: (wf, hinv, ws)})} on JAX's conv inputs."""
    net, (replay, _) = nets["centernet"], replays["centernet"]
    out = {}
    for kind in ("sym", "asym"):
        fold = _gptq_scales(net, kind == "asym")
        want = jax_quantize.calibrate_gptq(net.apply, [net.jax_img], fold)
        out[kind] = (fold, want, *_port_gptq(replay, fold))
    return out


def _column_rounding(wf, hinv, ws, col):
    """W[i, col] / ws[col] at each row of the port's rounding of one
    column (a column's rounding reads only its own errors)."""
    w, out = wf[:, col].clone(), []
    for i in range(w.shape[0]):
        out.append(float(w[i] / ws[col]))
        q = torch.clamp(torch.round(w[i] / ws[col]), -127, 127)
        err = (w[i] - q * ws[col]) / hinv[i, i]
        w[i + 1:] -= hinv[i, i + 1:] * err
    return out


def _assert_gptq(want, got, rounding, record_property):
    """JAX's and the port's ``calibrate_gptq`` results: the codes equal
    but at near-ties (counted and named), the weight scales within
    ``SCALE_RTOL``."""
    assert list(got) == list(want)
    ties, codes, scale_err = [], 0, 0.0
    for path, (wq, ws) in want.items():
        gq, gs = got[path]
        assert gq.dtype == np.int8 and gq.shape == wq.shape and gs.dtype == np.float32, path
        np.testing.assert_allclose(gs, ws, rtol=SCALE_RTOL, atol=0, err_msg=path)
        scale_err = max(scale_err, float(np.max(np.abs(gs / ws - 1))))
        codes += wq.size
        differ = (gq != wq).reshape(-1, wq.shape[-1])
        for col in np.flatnonzero(differ.any(axis=0)):
            row = int(np.argmax(differ[:, col]))
            v = _column_rounding(*rounding[path], col)[row]
            assert abs(abs(v - np.floor(v)) - 0.5) <= GPTQ_TIE, (path, row, col, v)
            ties.append(f"{path}[{row},{col}] ({int(differ[:, col].sum())} codes after)")
    record_property("paths", len(want))
    record_property("codes", codes)
    record_property("near_ties_differing", str(ties))
    record_property("weight_scale_max_rel_err", scale_err)
    assert len(ties) <= len(want)


@pytest.mark.parametrize("kind", ["sym", "asym"])
def test_torch_calibrate_gptq_matches_jax(nets, gptq, kind, record_property):
    net = nets["centernet"]
    fold, want, got, rounding = gptq[kind]
    assert net.jax_only <= set(got)
    _assert_gptq(want, got, rounding, record_property)


@pytest.mark.parametrize("kind,level", [("sym", "level5"), ("asym", "level4")])
def test_torch_calibrate_gptq_widest_conv_matches_jax(nets, replays, kind, level,
                                                      record_property):
    """``calibrate_gptq`` on the widest conv of a level that ``GPTQ_SKIP``
    leaves out above, alone, on JAX's input to it, as above: level 5's (a
    3x3 conv over 512 channels, 4,608 rows of row-by-row rounding) and
    level 4's (over 256, 2,304 rows)."""
    net, (replay, calls) = nets["centernet"], replays["centernet"]
    (k, _, _, _, _, c), (path, _) = max(
        ((key, v) for key, v in _conv_shapes(net, calls).items() if f"/{level}/" in v[0]),
        key=lambda kv: kv[0][0][0] * kv[0][0][1] * kv[0][5])
    assert k[0] * k[1] * c == WIDEST_ROWS[level], (path, k, c)
    fold = {path: (jax_ranges(net) if kind == "asym" else jax_scales(net))[path]}
    want = jax_quantize.calibrate_gptq(net.apply, [net.jax_img], fold)
    _assert_gptq(want, *_port_gptq(replay, fold), record_property)
    record_property("path", path)


@pytest.mark.parametrize("kind", ["sym", "asym"])
def test_torch_gptq_chain_matches_jax(nets, frames, gptq, kind, monkeypatch, record_property):
    """JAX's GPTQ weights through both chains: every int8 map equal."""
    net = nets["centernet"]
    fold, want_wq, _, _ = gptq[kind]
    scales = strip_scales(jax_scales(net), ("dla_up", "level4", "level5"))
    options = {"wq_override": want_wq}
    if kind == "asym":
        options["ranges"] = {p: r for p, r in fold.items() if p in scales}
    rec, want, got = _chains(net, frames, monkeypatch, scales, **options)
    assert _assert_chains(net, rec, want, got, record_property) > 0
    # The override took: a code of JAX's GPTQ weights differs from _wq's.
    ctx = ChainCtx(net.port, scales, path_of=centerpoint_flax_path, **options)
    assert any(not np.array_equal(ctx.int8_weights(p)[0].numpy(), _wq(
        port_chain._hwio(ctx.modules[p]).detach(),
        in_scale=ctx.asym(p)[0] if kind == "asym" else scales[p])[0].numpy())
        for p in want_wq if p in scales)
