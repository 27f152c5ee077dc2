"""``scripts/dcn_offset_stats.py`` in the PyTorch port against the JAX
package's, on the CPU.

- The parser takes every JAX flag with its type, default, choices and
  nargs.
- ``offset_stats`` on JAX's weights: both scripts' ``main`` with
  ``--steps 0 --skip-unregularized`` (no training: the statistics of the
  weights the net starts from) at 64x128 on 2 batches of 2 frames, the
  squares' sides ``SIDES`` (the script's 24-96 pixels do not fit a
  64-pixel frame), each net holding the same random weights from ``SEED``
  (``torch_parity.random_variables``: the offset kernels scaled by 1.5
  and the offset and mask biases uniform in +-1, so that offsets reach a
  few cells; a flax init zeroes them), carried into the port by
  ``weights.centerpoint_state_dict_from_flax``.  JAX's net is its bf16
  ``CenterpointDLA34(deform=True, dcn_impl="gather")``, compiled; the
  port's the bf16 DCN net with unbounded offsets, op by op.  For the JAX
  call, ``jax.config.update`` (the script's persistent compile cache) and
  its cache directory's ``mkdir`` do nothing, and the model's ``init``
  returns these weights (its state starts from them; compiling flax's
  init would take ~15 s).  Bar: the
  JSON keys equal, ``n`` equal (the count of sown offset elements), each
  percentile and the largest within ``ULPS`` bf16 ulps of JAX's at its
  magnitude (the bf16 DCN net's stated spread: within 2 bf16 ulps of
  JAX's heads), ``frac_le_1`` within ``FRAC_ATOL``.  Measured: every percentile and the largest equal (p50
  0.4551, p95 1.1719, p99 1.5938, p999 2.0781, max 2.5625), ``n``
  249,408 in both, ``frac_le_1`` 0.888724 (port) against 0.888761 (JAX):
  9 of the 249,408 offsets lie on the other side of one cell.
- The port's ``main --steps 2`` (both trainings, the penalty's weight 1
  and 0) emits the JAX script's keys, with finite losses, the penalty
  term logged on the regularised run only.
"""

import argparse
import dataclasses
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import pytest

import tauv_vision_tpu.data.synthetic as jax_synthetic
from tauv_vision_tpu.models.centerpoint_dla import CenterpointDLA34 as JaxCenterpointDLA34
from tauv_vision_tpu.scripts import dcn_offset_stats as jax_script
from tauv_vision_tpu_torch.scripts import dcn_offset_stats as port_script
from tauv_vision_tpu_torch.weights import centerpoint_state_dict_from_flax
from torch_parity import jax_object_config, random_variables, torch_threads

H, W = 64, 128
SIDES = (8, 24)
SEED = 3
ARGV = ["--batch-size", "2", "--eval-batches", "2"]
ULPS = 2
FRAC_ATOL = 1e-3
STATS = ("p50", "p95", "p99", "p999", "max", "frac_le_1", "n")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture
def small(monkeypatch):
    """Both scripts at ``H`` x ``W`` with the squares' sides ``SIDES``."""
    for module in (jax_script, port_script):
        monkeypatch.setattr(module, "IN_H", H)
        monkeypatch.setattr(module, "IN_W", W)
    squares = jax_synthetic.SquareDatasetConfig
    monkeypatch.setattr(jax_synthetic, "SquareDatasetConfig", lambda **kw: squares(
        **{**kw, "min_side": SIDES[0], "max_side": SIDES[1]}))
    port_squares = port_script.square_config
    monkeypatch.setattr(port_script, "square_config", lambda: dataclasses.replace(
        port_squares(), min_side=SIDES[0], max_side=SIDES[1]))


class _Parsed(Exception):
    pass


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.type, a.default, a.choices, a.nargs,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_torch_dcn_offset_stats_flags_match_jax(monkeypatch):
    caught = []

    def grab(self, argv=None, namespace=None):
        caught.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            jax_script.main([])
    assert _options(port_script.parser()) == _options(caught[0])


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at ``x`` (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def test_torch_offset_stats_match_jax(small, monkeypatch, record_property):
    """``--steps 0 --skip-unregularized`` on JAX's weights in both scripts
    (see the module docstring)."""
    variables = random_variables(JaxCenterpointDLA34(
        object_config=jax_object_config(port_script.object_config()), dtype=jnp.bfloat16,
        deform=True, dcn_impl="gather"), (1, H, W, 3), SEED)
    planted = jax.tree_util.tree_map(jnp.asarray, variables)
    argv = ["--steps", "0", "--skip-unregularized"] + ARGV
    made = []
    with monkeypatch.context() as m:
        m.setattr(jax.config, "update", lambda *a, **k: None)
        m.setattr(pathlib.Path, "mkdir", lambda self, *a, **k: made.append(self))
        m.setattr(JaxCenterpointDLA34, "init", lambda self, *a, **k: planted)
        want = jax_script.main(argv)
    assert [p.name for p in made] == [".jax_cache"]
    build = port_script.build_model

    def loaded(oc, device):
        model = build(oc, device)
        model.load_state_dict(centerpoint_state_dict_from_flax(variables))
        return model

    monkeypatch.setattr(port_script, "build_model", loaded)
    got = port_script.main(argv, device="cpu")
    record_property("jax", json.dumps(want))
    record_property("port", json.dumps(got))
    assert list(got) == list(want) == ["steps", "lambda_dcn", "offset_range", "regularized"]
    g, w = got["regularized"], want["regularized"]
    assert list(g) == list(w) == list(STATS) + ["final_loss"]
    assert g["final_loss"] is w["final_loss"] is None
    assert g["n"] == w["n"] > 0
    # The planted offsets reach past one cell.
    assert w["max"] > 1.0 and w["frac_le_1"] < 1.0
    for key in ("p50", "p95", "p99", "p999", "max"):
        assert abs(g[key] - w[key]) <= ULPS * bf16_ulp(w[key]), (key, g[key], w[key])
    assert abs(g["frac_le_1"] - w["frac_le_1"]) <= FRAC_ATOL


def test_torch_dcn_offset_stats_main_trains_both(small, capsys):
    """The port's ``main --steps 2``: the JAX script's keys, both runs."""
    result = port_script.main(["--steps", "2"] + ARGV, device="cpu")
    assert list(result) == ["steps", "lambda_dcn", "offset_range", "regularized",
                            "unregularized"]
    assert (result["steps"], result["lambda_dcn"], result["offset_range"]) == (2, 1.0, 1.0)
    for run in ("regularized", "unregularized"):
        stats = result[run]
        assert list(stats) == list(STATS) + ["final_loss"]
        assert math.isfinite(stats["final_loss"]) and stats["n"] > 0
        assert 0 <= stats["p50"] <= stats["p95"] <= stats["p99"] <= stats["p999"] <= stats["max"]
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("lam=")]
    assert [line.split(" step ")[0] for line in lines] == ["lam=1.0"] * 2 + ["lam=0.0"] * 2
    assert all("dcn_offset=0.000000" in line for line in lines[2:])
    assert json.dumps(result, indent=2) in out
