"""``scripts/quantize_accuracy_check.py`` in the PyTorch port against the JAX
package's, and the CenterNet's weights both ways, on the CPU.

- ``weights.centerpoint_flax_from_state_dict`` inverts
  ``centerpoint_state_dict_from_flax``: the JAX model's variables tree
  (plain and DCN IDA; its init's tree, numpy weights from a seed) -> the
  port -> back equals the tree leaf for leaf (keys, shapes, dtypes,
  values).
- The pickles: one the JAX script writes (its ``--save-model`` code: the
  tree's leaves through ``np.asarray``) loads in the port, one the port
  writes (``write_flax_variables``) loads as the JAX script loads it, and a
  flax ``FrozenDict`` pickle reads as a dict without flax's class.
- ``SWEEP_LADDER`` equals the JAX module constant; the parser takes every
  JAX flag with its type, default, choices and nargs but ``--early-pack``.
- Both scripts' ``main`` end to end once, ``--keypoints --sweep --baseline
  f32`` over ``E2E_RUNGS``: the control ``pc+none`` (the chain with no int8
  conv), ``flax-bf16`` (the bf16 net) and ``float-f32heads`` (the chain's
  float path with f32 heads), each against the f32 net, through
  ``pair_deltas_kp``, at 64x128 on 2 batches of 2 frames from one
  ``--load-model`` pickle: random weights from a seed, the object and
  keypoint heatmap heads' kernels made zero-mean over their input channels
  and scaled by ``HEATMAP_GAIN`` (so that the peaks stand apart from the
  field), their biases planted at ``HEATMAP_BIAS``.  The f32 net's peak
  logits (bias 0) lie within 0.34 of each other over the 40 object slots,
  and the bf16 net departs from them by up to 0.032 (p95 0.019); the
  object bias puts the 0.3 threshold in the middle of the widest gap of
  the middle ranks (0.025, between ranks 14 and 15), the keypoint bias in
  the gap under the single top keypoint peak (0.036 at its gain, the
  noise 0.004), so that the f32 reference decodes 14 of 40 slots and one
  keypoint and no slot's fate is decided by rounding in either stack.
  Both modules' ``IN_H`` and ``IN_W`` are set to 64x128 and the squares'
  sides to ``SIDES`` (the script's 24-96 pixels do not fit a 64-pixel
  frame; the same in both).  For the JAX call, ``jax.config.update`` (the
  script's persistent compile cache) and its cache directory's ``mkdir``
  do nothing.  Bar: the JSON keys equal, the counts equal
  (``n_eval_samples``, ``bf16_detections``, ``int8_convs``, ``total``,
  ``kp_total``), each matched fraction within ``MATCHED_ATOL`` and each
  p95 (score, center, size, kp_center, kp_score) within ``P95_ATOL`` of
  JAX's; in each stack the control's row equal to ``flax-bf16``'s.  The
  float rungs' deltas are the bf16 net's rounding, which the two stacks
  draw apart (JAX's jit contracts multiply-adds where the port rounds op
  by op), so their sizes agree and their values do not: measured, the
  matched fractions 1.0 in both, score p95 0.002851 (JAX) and 0.003225
  (port) for ``flax-bf16``, 0.002228 and 0.00291 for ``float-f32heads``
  (the largest gap, 6.8e-4), size p95 0.001921 and 0.001433 (gap 4.9e-4),
  center p95 2.2e-5 and 2.5e-5, kp_score p95 0.000886 and 0.00014 (gap
  7.5e-4), kp_center 0.0 in both.  An int8 rung's numbers on random
  weights are larger draws of the same noise (the calibration's scales,
  from bf16 forwards that part by an ulp here and there, shift each
  stack's int8 grid): in 4 runs of the default mode at this size the
  matched fractions parted by up to 0.1 and the size p95 by up to 2.6e-3,
  and with JAX's scales in both stacks the matched fractions still by
  0.05.  So the int8 rungs are held op by op in
  ``tests/test_torch_quantize_accuracy.py``, and here the port's default
  mode and its QAT mode are run for their outputs' form
  (``test_torch_quantize_accuracy_script_modes``).
"""

import argparse
import json
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import FrozenDict

import tauv_vision_tpu.data.synthetic as jax_synthetic
from tauv_vision_tpu.models.centerpoint_dla import CenterpointDLA34 as JaxCenterpointDLA34
from tauv_vision_tpu.scripts import quantize_accuracy_check as jax_script
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.scripts import quantize_accuracy_check as port_script
from tauv_vision_tpu_torch.weights import (
    centerpoint_calibration_paths,
    centerpoint_flax_from_state_dict,
    centerpoint_state_dict_from_flax,
    read_flax_variables,
    write_flax_variables,
)
from torch_parity import jax_object_config, random_variables, square_configs, torch_threads

H, W = 64, 128
SIDES = (8, 24)
# The object and the keypoint heatmap heads (see the module docstring).
HEATMAP_GAIN = (10.0, 2.0)
HEATMAP_BIAS = (-3.0827, -1.3046875)
MATCHED_ATOL = 0.05
P95_ATOL = 1e-3
ARGV = ["--batch-size", "2", "--eval-batches", "2", "--cal-batches", "2"]
E2E_RUNGS = ("pc+none", "flax-bf16", "float-f32heads")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg="/".join(k))


@pytest.mark.parametrize("deform", [False, True], ids=["plain_ida", "dcn_ida"])
def test_torch_centernet_export_round_trips(deform, record_property):
    oc, _ = square_configs(H, W)
    variables = random_variables(JaxCenterpointDLA34(object_config=jax_object_config(oc),
                                                     deform=deform, dcn_impl="gather"),
                                 (1, H, W, 3), 4)
    port = CenterpointDLA34(oc, device="cpu", deform=deform)
    port.load_state_dict(centerpoint_state_dict_from_flax(variables))
    back = centerpoint_flax_from_state_dict(port.state_dict())
    _assert_trees_equal(back, variables)
    record_property("leaves", len(dict(_leaves(variables))))


def test_torch_variables_pickles_cross_load(tmp_path):
    oc, _ = square_configs(H, W)
    jax_tree = jax.tree_util.tree_map(jnp.asarray, random_variables(
        JaxCenterpointDLA34(object_config=jax_object_config(oc), deform=False), (1, H, W, 3), 5))
    # The JAX script's --save-model: the leaves through np.asarray, pickled.
    with open(tmp_path / "jax.pkl", "wb") as fp:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jax_tree), fp)
    port = CenterpointDLA34(oc, device="cpu")
    port.load_state_dict(centerpoint_state_dict_from_flax(read_flax_variables(tmp_path / "jax.pkl")))
    exported = centerpoint_flax_from_state_dict(port.state_dict())
    _assert_trees_equal(exported, jax.tree_util.tree_map(np.asarray, jax_tree))
    # The port's file, read as the JAX script's --load-model reads it.
    write_flax_variables(tmp_path / "port.pkl", exported)
    with open(tmp_path / "port.pkl", "rb") as fp:
        loaded = jax.tree_util.tree_map(jnp.asarray, pickle.load(fp))
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, loaded), exported)
    # An older flax's FrozenDict tree reads as plain dicts.
    with open(tmp_path / "frozen.pkl", "wb") as fp:
        pickle.dump(FrozenDict(exported), fp)
    frozen = read_flax_variables(tmp_path / "frozen.pkl")
    assert type(frozen) is dict
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, dict(frozen)), exported)


def test_torch_sweep_ladder_matches_jax():
    assert port_script.SWEEP_LADDER == jax_script.SWEEP_LADDER
    assert len(port_script.SWEEP_LADDER) == 46


class _Parsed(Exception):
    pass


def jax_parser(monkeypatch):
    """The JAX script's parser, caught at its ``parse_args``."""
    caught = []

    def grab(self, argv=None, namespace=None):
        caught.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            jax_script.main([])
    return caught[0]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.type, a.default, a.choices, a.nargs,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_torch_script_flags_match_jax(monkeypatch):
    want = _options(jax_parser(monkeypatch))
    got = _options(port_script.parser())
    assert "early_pack" in want and "early_pack" not in got
    del want["early_pack"]
    assert got == want
    with pytest.raises(SystemExit):
        port_script.parser().parse_args(["--early-pack", "2"])
    with pytest.raises(SystemExit):
        port_script.main(["--keypoints"], device="cpu")


def planted_weights(path, keypoints: bool, seed: int, bias=HEATMAP_BIAS):
    """Pickle random DLA-34 weights of the script's object config at
    ``path``, the heatmap heads planted (see the module docstring) with
    the biases ``bias``."""
    oc = port_script.setup(port_script.parser().parse_args(
        ["--keypoints", "--sweep"] if keypoints else [])).object_config
    variables = random_variables(JaxCenterpointDLA34(
        object_config=jax_object_config(oc), dtype=jnp.bfloat16, deform=False),
        (1, H, W, 3), seed)
    for i in (0, 1) if keypoints else (0,):
        head = variables["params"]["model"][f"head_{i}_out"]
        kernel = head["kernel"] - head["kernel"].mean(axis=2, keepdims=True)
        head["kernel"] = (kernel * HEATMAP_GAIN[i]).astype(np.float32)
        head["bias"] = np.full_like(head["bias"], bias[i])
    write_flax_variables(path, variables)
    return path


def small_squares(cls):
    return lambda **kw: cls(**{**kw, "min_side": SIDES[0], "max_side": SIDES[1]})


def run_both(tmp_path, monkeypatch, argv):
    """(JAX's result, the port's) of both scripts' ``main`` on ``argv``
    (see the module docstring)."""
    for module in (jax_script, port_script):
        monkeypatch.setattr(module, "IN_H", H)
        monkeypatch.setattr(module, "IN_W", W)
    monkeypatch.setattr(jax_synthetic, "SquareDatasetConfig",
                        small_squares(jax_synthetic.SquareDatasetConfig))
    monkeypatch.setattr(port_script, "SquareDatasetConfig",
                        small_squares(port_script.SquareDatasetConfig))
    made = []
    with monkeypatch.context() as m:
        m.setattr(jax.config, "update", lambda *a, **k: None)
        m.setattr(pathlib.Path, "mkdir", lambda self, *a, **k: made.append(self))
        want = jax_script.main(argv)
    assert [p.name for p in made] == [".jax_cache"]
    return want, port_script.main(argv, device="cpu")


def test_torch_quantize_accuracy_script_matches_jax(tmp_path, monkeypatch, capsys,
                                                    record_property):
    """``--keypoints --sweep --baseline f32`` over ``E2E_RUNGS`` in both
    scripts (see the module docstring)."""
    weights = planted_weights(tmp_path / "planted.pkl", keypoints=True, seed=6)
    argv = (["--load-model", str(weights), "--keypoints", "--sweep", "--baseline", "f32",
             "--rungs", *E2E_RUNGS] + ARGV)
    want, got = run_both(tmp_path, monkeypatch, argv)
    assert json.dumps(got, indent=2) in capsys.readouterr().out
    record_property("jax", json.dumps(want))
    record_property("port", json.dumps(got))
    assert list(got) == list(want)
    assert got["n_eval_samples"] == want["n_eval_samples"] == 4
    assert got["bf16_detections"] == want["bf16_detections"]
    # The f32 reference decodes part of its 40 slots above 0.3.
    assert 0 < want["bf16_detections"] < 40
    assert [r["name"] for r in got["sweep"]] == [r["name"] for r in want["sweep"]]
    gaps = {}
    for g, w in zip(got["sweep"], want["sweep"]):
        assert list(g) == list(w), w["name"]
        for key in ("int8_convs", "total", "kp_total"):
            assert g[key] == w[key], (w["name"], key)
        assert w["kp_total"] > 0
        for key, value in w.items():
            if key.endswith("matched_fraction"):
                assert abs(g[key] - value) <= MATCHED_ATOL, (w["name"], key, g[key], value)
            elif "_p95" in key:
                assert abs(g[key] - value) <= P95_ATOL, (w["name"], key, g[key], value)
            if key.endswith("matched_fraction") or "_p95" in key:
                gaps[key] = max(gaps.get(key, 0.0), abs(g[key] - value))
    record_property("max_gaps", json.dumps(gaps))
    for result in (want, got):
        rows = {r["name"]: r for r in result["sweep"]}
        # The control: the chain with no int8 conv decodes as the bf16 net.
        assert ({k: v for k, v in rows["pc+none"].items() if k != "name"}
                == {k: v for k, v in rows["flax-bf16"].items() if k != "name"})
        # The float rungs' deltas from the f32 net are real.
        for name in ("flax-bf16", "float-f32heads"):
            assert rows[name]["score_delta_p95"] > 0 and rows[name]["kp_score_delta_p95"] > 0
        assert rows["float-f32heads"] != {**rows["flax-bf16"], "name": "float-f32heads"}


def test_torch_quantize_accuracy_script_modes(tmp_path, monkeypatch, record_property):
    """The port's default mode (per-layer int8 and the chain, bias
    corrections, AP with the bootstrap) and its QAT mode (one step,
    ``--qat-save``, then ``--qat-load`` of that file giving the same
    numbers), on the planted weights with the object bias 0 (every slot
    decodes): the JAX script's keys, the convs counted as the JAX
    calibration records them and as QAT strips them."""
    weights = planted_weights(tmp_path / "planted.pkl", keypoints=False, seed=6, bias=(0.0,))
    monkeypatch.setattr(port_script, "IN_H", H)
    monkeypatch.setattr(port_script, "IN_W", W)
    monkeypatch.setattr(port_script, "SquareDatasetConfig",
                        small_squares(port_script.SquareDatasetConfig))
    base = ["--load-model", str(weights)] + ARGV
    paths = _calibrated_paths()
    default = port_script.main(base + ["--bias-correct", "--bootstrap", "5"], device="cpu")
    assert list(default)[:8] == ["steps", "quantized_convs", "percentile", "per_channel",
                                 "bias_correct", "bf16_heads", "n_eval_samples",
                                 "bf16_ap_iou0.5"]
    assert default["quantized_convs"] == len(paths) == 60
    assert default["n_eval_samples"] == 4 and default["bf16_detections"] == 40
    for tag in ("bf16", "int8", "int8_chain"):
        lo, hi = default[f"{tag}_ap_ci95"]
        assert lo <= default[f"{tag}_ap_iou0.5"] <= hi or lo == hi
    for tag in ("int8", "int8_chain"):
        assert 0 < default[f"{tag}_matched_fraction"] <= 1
    qat = port_script.main(base + ["--qat-steps", "1", "--qat-save", str(tmp_path / "qat.pkl")],
                           device="cpu")
    again = port_script.main(base + ["--qat-load", str(tmp_path / "qat.pkl")], device="cpu")
    assert list(qat)[:5] == ["mode", "qat_steps", "qat_lr", "qat_strip", "int8_convs"]
    assert qat["qat_strip"] == ("head_",)
    assert qat["int8_convs"] == sum(1 for p in paths if "head_" not in p) == 54
    assert {k: v for k, v in again.items() if k != "qat_steps"} == {
        k: v for k, v in qat.items() if k != "qat_steps"}
    record_property("runs", json.dumps({"default": default, "qat": qat}))


def _calibrated_paths():
    """The 60 JAX paths the DLA-34's calibration records (a conv of 16
    input channels or more, the discarded projections included)."""
    oc = port_script.setup(port_script.parser().parse_args([])).object_config
    model = CenterpointDLA34(oc, device="cpu", deform=False)
    paths = set()
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d) and m.in_channels >= 16:
            p = centerpoint_calibration_paths(name)
            paths.update((p,) if isinstance(p, str) else p)
    return paths
