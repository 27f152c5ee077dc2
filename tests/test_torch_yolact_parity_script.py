"""``scripts/yolact_parity_check.py`` in the PyTorch port against the JAX
package's, the YOLACT's and YOLO-Pose's weights both ways, and
``--int8-transpose``, on the CPU.

- ``weights.yolact_flax_from_state_dict`` and
  ``yolo_pose_flax_from_state_dict`` invert the imports: the JAX model's
  variables tree (its init's tree, numpy weights from a seed; the
  script's YOLACT and ``configs.BENCH_YOLO_POSE``'s net) -> the port ->
  back equals the tree leaf for leaf (keys, shapes, dtypes, values), the
  protonet's transposed kernels included.
- The pickles: one the JAX script writes (its ``--save-model`` code: the
  leaves through ``np.asarray``) loads in the port's ``load_model``, and
  the port's ``save_model`` file loads as the JAX script's
  ``--load-model`` loads it.
- ``LADDER`` equals the JAX module constant; the parser takes every JAX
  flag with its type, default, choices and nargs; ``pair_deltas`` equals
  JAX's on the same numpy detections (labels, centers within and beyond
  0.05, masks), key for key.
- Both scripts' ``main`` end to end once, ``--baseline f32`` over
  ``E2E_RUNGS`` (``flax-bf16``, ``float+f32head``, ``pc+outputs+head``,
  ``pc+outputs+head+int8T``), at 64x128 on one batch of 16 frames
  (``--cal-frames 2``) from one ``--load-model`` pickle: random weights
  from ``SEED``, the FPN, protonet and head ``WIDTH`` wide (both stacks'
  model configs narrowed in the test: the JAX script's 256-wide int8
  chain takes ~23 s a rung to compile here, ~10 s at 32), the squares'
  sides ``SIDES`` (the script's 32-128 pixels do not fit a 64-pixel
  frame).  The class head is planted: its background kernel and bias 0,
  its square kernel made zero-mean over its input channels and scaled by
  ``CLASS_GAIN``, its bias ``CLASS_BIAS``, which puts the 0.5 confidence
  threshold in the gap of the f32 net's logit differences between ranks
  19 and 20 (measured in the port: every anchor's difference lies at
  least 5.09 times its bf16 net's and its ``float+f32head`` chain's
  departure from it away from the threshold; the Fast-NMS IoUs among the
  19 lie at least 0.119 from 0.5, and one of them is suppressed), so that
  the f32 reference decodes 18 slots and no slot's fate is decided by
  rounding; the mask coefficients and prototypes are planted so that
  about half of each box's pixels pass 0.5 (``COEFF_BIAS``,
  ``PROTO_GAIN``, ``PROTO_BIAS``).  For the JAX call, ``jax.config.update``
  (the script's persistent compile cache) and its cache directory's
  ``mkdir`` do nothing.  Bar: the JSON keys equal, the counts equal
  (``n_eval_images``, ``total``, ``int8_convs``), the float rungs'
  matched fractions within ``MATCHED_ATOL`` and their p95s (score,
  center, size, mask) within ``P95_ATOL`` of JAX's, their mask IoU within
  ``IOU_ATOL``; in each stack the ``int8T`` row equal to the
  ``pc+outputs+head`` row but its name.  The float rungs' deltas are the
  bf16 net's rounding, which the two stacks draw apart (JAX's jit
  contracts multiply-adds where the port rounds op by op), so their sizes
  agree and their values do not: measured, both rungs 1.0 matched in
  both stacks; ``flax-bf16`` score p95 0.001733 (JAX) and 0.002139 (port,
  the largest gap, 4.1e-4); ``float+f32head`` size p95 0.000895 and
  0.001088 (1.9e-4), mask IoU 0.9913 and 0.9923 (1.0e-3); the mask p95s
  within 5.8e-5 and the center p95s within 1.2e-5.  The int8 rungs'
  numbers are larger draws of the same noise (the calibrations' bf16
  forwards part by an ulp here and there, and so do the int8 grids:
  ``pc+outputs+head`` matched 1.0 in JAX and 0.9444 in the port), so
  they are not held across stacks; the chains are held op by op in
  ``tests/test_torch_chain.py``.
- ``--int8-transpose``: JAX's chain on JAX ``calibrate``'s scales (the
  end-to-end run's, on its weights) traced with ``int8_transpose`` None,
  ``"phase-xla"`` and ``"pallas"`` gives one program (equal jaxprs and
  constants), with the three int8 transposed-conv functions patched to
  raise: the int8 branch is never reached, so whether the Pallas kernel
  would run in interpret mode does not arise.  With the two upsample
  scales added, ``"phase-xla"`` and ``"pallas"`` reach their functions
  (the control).  ``configs.int8_knobs`` returns every chain profile
  unchanged for each ``--int8-transpose`` value and raises on the
  per-layer profile, off the int8 recipes and on another value.
"""

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import pathlib
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
from jax.extend import core as jax_core
import numpy as np
import pytest
import torch

import tauv_vision_tpu.configs as jax_configs
import tauv_vision_tpu.data.synthetic as jax_synthetic
import tauv_vision_tpu.ops.pallas.transpose_conv as jax_transpose_conv
import tauv_vision_tpu.serving.quantize as jax_quantize
from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu.models.yolo_pose import YoloPose as JaxYoloPose
from tauv_vision_tpu.scripts import yolact_parity_check as jax_script
from tauv_vision_tpu.serving import quantize_chain as jax_chain
from tauv_vision_tpu_torch import configs
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.models.yolo_pose import YoloPose
from tauv_vision_tpu_torch.scripts import yolact_parity_check as port_script
from tauv_vision_tpu_torch.weights import (
    write_flax_variables,
    yolact_flax_from_state_dict,
    yolact_state_dict_from_flax,
    yolo_pose_flax_from_state_dict,
    yolo_pose_state_dict_from_flax,
)
from torch_parity import jax_yolact_config, random_variables, torch_threads

H, W = 64, 128
WIDTH = 32
SIDES = (8, 24)
SEED = 6
CLASS_GAIN = 1.0
CLASS_BIAS = -0.8089
# The masks: every coefficient near tanh(1.5), the prototypes scaled by 10
# and shifted by -0.3, so that about half of each box's pixels pass 0.5.
COEFF_BIAS = 1.5
PROTO_GAIN, PROTO_BIAS = 10.0, -0.3
MATCHED_ATOL = 0.0
P95_ATOL = 1e-3
IOU_ATOL = 5e-3
ARGV = ["--eval-batches", "1", "--cal-frames", "2", "--baseline", "f32"]
E2E_RUNGS = ("flax-bf16", "float+f32head", "pc+outputs+head", "pc+outputs+head+int8T")
FLOAT_RUNGS = ("flax-bf16", "float+f32head")
SERVED_TAIL = ("prediction_head", "protonet/output")
UPSAMPLES = ("protonet/upsample_1", "protonet/upsample_2")


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
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg="/".join(k))


def script_config(width=256):
    """The script's YOLACT config at ``H`` x ``W`` and ``width``."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(port_script, "IN_H", H)
        m.setattr(port_script, "IN_W", W)
        return dataclasses.replace(port_script.model_config(), feature_depth=width)


@pytest.mark.parametrize("which", ["yolact", "yolo_pose"])
def test_torch_yolact_and_yolo_pose_exports_round_trip(which, record_property):
    if which == "yolact":
        cfg = script_config()
        jax_model = JaxYolact(jax_yolact_config(cfg), dtype=jnp.bfloat16)
        port = Yolact(cfg, device="cpu")
        export, load = yolact_flax_from_state_dict, yolact_state_dict_from_flax
    else:
        cfg = configs.BENCH_YOLO_POSE.model
        jax_model = JaxYoloPose(jax_configs.YoloPoseModelConfig(**dataclasses.asdict(cfg)))
        port = YoloPose(cfg, device="cpu")
        export, load = yolo_pose_flax_from_state_dict, yolo_pose_state_dict_from_flax
    variables = random_variables(jax_model, (1, cfg.in_h, cfg.in_w, 3), 4)
    port.load_state_dict(load(variables))
    back = export(port.state_dict())
    _assert_trees_equal(back, variables)
    kernel = variables["params"]["protonet"]["upsample_1"]["kernel"]
    assert kernel.shape[0] == 3 and not np.array_equal(kernel, np.swapaxes(kernel, 2, 3))
    record_property("leaves", len(dict(_leaves(variables))))


def test_torch_yolact_pickles_cross_load(tmp_path):
    cfg = script_config(WIDTH)
    jax_tree = jax.tree_util.tree_map(jnp.asarray, random_variables(
        JaxYolact(jax_yolact_config(cfg), dtype=jnp.bfloat16), (1, H, W, 3), 5))
    # The JAX script's --save-model: the leaves through np.asarray, pickled.
    with open(tmp_path / "jax.pkl", "wb") as fp:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jax_tree), fp)
    port = port_script.load_model(tmp_path / "jax.pkl", cfg, "cpu")
    assert port.dtype == torch.bfloat16 and not port.training
    _assert_trees_equal(yolact_flax_from_state_dict(port.state_dict()),
                        jax.tree_util.tree_map(np.asarray, jax_tree))
    # The port's --save-model, read as the JAX script's --load-model reads it.
    port_script.save_model(tmp_path / "port.pkl", port)
    with open(tmp_path / "port.pkl", "rb") as fp:
        loaded = jax.tree_util.tree_map(jnp.asarray, pickle.load(fp))
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, loaded),
                        jax.tree_util.tree_map(np.asarray, jax_tree))


def test_torch_yolact_ladder_matches_jax():
    assert port_script.LADDER == jax_script.LADDER
    assert len(port_script.LADDER) == 11


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch):
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


def test_torch_yolact_script_flags_match_jax(monkeypatch):
    assert _options(port_script.parser()) == _options(_jax_parser(monkeypatch))
    with pytest.raises(SystemExit):
        port_script.parser().parse_args(["--baseline", "f16"])


def _detections(rng, batch=3, k=6, hw=(6, 8)):
    """Numpy decodes of ``batch`` frames of ``k`` slots: random validity,
    labels 1-2, centers and sizes, masks in [0, 1]."""
    box = rng.uniform(0.2, 0.8, (batch, k, 4)).astype(np.float32)
    return SimpleNamespace(valid=rng.random((batch, k)) < 0.7,
                           score=rng.uniform(0.5, 1.0, (batch, k)).astype(np.float32),
                           label=rng.integers(1, 3, (batch, k)).astype(np.int32), box=box,
                           mask=rng.random((batch, k, *hw)).astype(np.float32))


def _perturbed(rng, d):
    """``d`` with each slot moved by less or more than the match radius,
    and its score, size and mask nudged."""
    box = d.box.copy()
    box[..., :2] += rng.choice([0.01, 0.03, 0.08], box.shape[:2])[..., None] \
        * rng.choice([-1, 1], box.shape[:2])[..., None]
    box[..., 2:] += rng.normal(0, 0.01, box[..., 2:].shape)
    return SimpleNamespace(valid=d.valid ^ (rng.random(d.valid.shape) < 0.1),
                           score=d.score + rng.normal(0, 1e-3, d.score.shape).astype(np.float32),
                           label=np.where(rng.random(d.label.shape) < 0.1, 3 - d.label, d.label),
                           box=box,
                           mask=np.clip(d.mask + rng.normal(0, 0.05, d.mask.shape), 0, 1)
                           .astype(np.float32))


def test_torch_yolact_pair_deltas_match_jax():
    rng = np.random.default_rng(0)
    dets_a = [_detections(rng) for _ in range(4)]
    dets_b = [_perturbed(rng, d) for d in dets_a]
    want = jax_script.pair_deltas(dets_a, dets_b)
    got = port_script.pair_deltas(dets_a, dets_b)
    assert list(got) == list(want) and got == want
    assert 0 < want["matched_fraction"] < 1 and "mask_iou_mean" in want
    assert port_script.pair_deltas(dets_a[:0], dets_b[:0]) == jax_script.pair_deltas([], [])


def planted_weights(path):
    """Pickle random YOLACT weights of the narrowed script config at
    ``path``, the class head planted (see the module docstring); returns
    the variables tree."""
    variables = random_variables(JaxYolact(jax_yolact_config(script_config(WIDTH))),
                                 (1, H, W, 3), SEED)
    head = variables["params"]["prediction_head"]["classification"]
    kernel = np.zeros_like(head["kernel"])
    square = head["kernel"][..., 1]
    kernel[..., 1] = CLASS_GAIN * (square - square.mean(axis=2, keepdims=True))
    head["kernel"] = kernel.astype(np.float32)
    head["bias"] = np.asarray([0.0, CLASS_BIAS], np.float32)
    params = variables["params"]
    params["prediction_head"]["mask"]["bias"] = np.full_like(
        params["prediction_head"]["mask"]["bias"], COEFF_BIAS)
    proto = params["protonet"]["output"]
    proto["kernel"] = (proto["kernel"] * PROTO_GAIN).astype(np.float32)
    proto["bias"] = np.full_like(proto["bias"], PROTO_BIAS)
    write_flax_variables(path, variables)
    return variables


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts' ``main`` on the planted weights (see the module
    docstring): (JAX's result, the port's, the port's stdout, JAX
    ``calibrate``'s scales, the variables tree)."""
    path = tmp_path_factory.mktemp("yolact_parity") / "planted.pkl"
    variables = planted_weights(path)
    argv = ["--load-model", str(path), "--rungs", *E2E_RUNGS] + ARGV
    scales, made = [], []
    port_config, port_squares = port_script.model_config, port_script.square_config
    jax_model_config = jax_configs.YolactModelConfig
    squares = jax_synthetic.SquareDatasetConfig
    jax_calibrate = jax_quantize.calibrate

    def spy(*args, **kwargs):
        scales.append(jax_calibrate(*args, **kwargs))
        return scales[-1]

    with pytest.MonkeyPatch.context() as m:
        for module in (jax_script, port_script):
            m.setattr(module, "IN_H", H)
            m.setattr(module, "IN_W", W)
        m.setattr(jax_configs, "YolactModelConfig",
                  lambda **kw: jax_model_config(**{**kw, "feature_depth": WIDTH}))
        m.setattr(jax_synthetic, "SquareDatasetConfig", lambda **kw: squares(
            **{**kw, "min_side": SIDES[0], "max_side": SIDES[1]}))
        m.setattr(port_script, "model_config",
                  lambda: dataclasses.replace(port_config(), feature_depth=WIDTH))
        m.setattr(port_script, "square_config", lambda: dataclasses.replace(
            port_squares(), min_side=SIDES[0], max_side=SIDES[1]))
        m.setattr(jax_quantize, "calibrate", spy)
        with m.context() as cache:
            cache.setattr(jax.config, "update", lambda *a, **k: None)
            cache.setattr(pathlib.Path, "mkdir", lambda self, *a, **k: made.append(self))
            want = jax_script.main(argv)
        assert [p.name for p in made] == [".jax_cache"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            got = port_script.main(argv, device="cpu")
    assert len(scales) == 1
    return want, got, out.getvalue(), scales[0], variables


def _row(result, name):
    return next({k: v for k, v in r.items() if k != "name"} for r in result["sweep"]
                if r["name"] == name)


def test_torch_yolact_parity_script_matches_jax(runs, record_property):
    """``--baseline f32`` over ``E2E_RUNGS`` in both scripts (see the
    module docstring)."""
    want, got, out, _, _ = runs
    assert json.dumps(got, indent=2) in out
    record_property("jax", json.dumps(want))
    record_property("port", json.dumps(got))
    assert list(got) == list(want)
    assert got["n_eval_images"] == want["n_eval_images"] == 16
    assert [r["name"] for r in got["sweep"]] == [r["name"] for r in want["sweep"]] == [
        n for n, *_ in jax_script.LADDER if n in E2E_RUNGS]
    gaps = {}
    for g, w in zip(got["sweep"], want["sweep"]):
        assert list(g) == list(w), w["name"]
        for key in ("int8_convs", "total"):
            assert g[key] == w[key], (w["name"], key)
        # The f32 reference decodes 18 slots (the planted class head).
        assert w["total"] == 18
        if w["name"] not in FLOAT_RUNGS:
            continue
        for key, value in w.items():
            if key.endswith("matched_fraction"):
                bar = MATCHED_ATOL
            elif "_p95" in key:
                bar = P95_ATOL
            elif key == "mask_iou_mean":
                bar = IOU_ATOL
            else:
                continue
            gaps[f"{w['name']}/{key}"] = abs(g[key] - value)
            assert abs(g[key] - value) <= bar, (w["name"], key, g[key], value)
    record_property("gaps", json.dumps(gaps))
    for result in (want, got):
        assert _row(result, "pc+outputs+head+int8T") == _row(result, "pc+outputs+head")
        assert _row(result, "pc+outputs+head")["int8_convs"] == 30
        for name in FLOAT_RUNGS:
            assert _row(result, name)["matched_fraction"] == 1.0
            assert _row(result, name)["score_delta_p95"] > 0


class _Reached(Exception):
    pass


def _unreachable(name):
    def fn(*args, **kwargs):
        raise _Reached(name)
    return fn


def _canonical(value):
    """A jaxpr (open or closed), a constant or an equation parameter as
    nested tuples, variables numbered by first appearance in their jaxpr:
    equal for two traces of one program, whatever names the printer
    gives their shared sub-jaxprs."""
    if isinstance(value, jax_core.ClosedJaxpr):
        return ("closed", _canonical(value.jaxpr), tuple(_canonical(c) for c in value.consts))
    if isinstance(value, jax_core.Jaxpr):
        names = {}

        def var(x):
            if isinstance(x, jax_core.Literal):
                return ("literal", repr(x.val), str(x.aval))
            return names.setdefault(x, (len(names), str(x.aval)))

        return ("jaxpr", tuple(var(x) for x in value.constvars + value.invars),
                tuple((e.primitive.name, tuple(var(x) for x in e.invars),
                       tuple(var(x) for x in e.outvars),
                       tuple((k, _canonical(v)) for k, v in sorted(e.params.items())))
                      for e in value.eqns),
                tuple(var(x) for x in value.outvars))
    if isinstance(value, (tuple, list)):
        return tuple(_canonical(v) for v in value)
    if isinstance(value, (np.ndarray, jax.Array)):
        a = np.asarray(value)
        return ("array", a.dtype.str, a.shape, hashlib.sha256(a.tobytes()).hexdigest())
    return repr(value)


def test_torch_jax_int8_transpose_is_a_no_op_on_calibrate_scales(runs, monkeypatch):
    """JAX's chain on the end-to-end run's calibrated scales (see the
    module docstring)."""
    *_, scales, variables = runs
    for name in ("transpose_conv2x_int8_xla", "transpose_conv2x_int8_phase_xla",
                 "transpose_conv2x_int8_pallas"):
        monkeypatch.setattr(jax_transpose_conv, name, _unreachable(name))
    cfg = jax_yolact_config(script_config(WIDTH))
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    img = jnp.zeros((2, H, W, 3), jnp.bfloat16)
    served = jax_quantize.strip_scales(scales, SERVED_TAIL)
    assert not set(UPSAMPLES) & set(scales)

    def traced(scales, int8_transpose):
        return jax.make_jaxpr(jax_chain.yolact_chain_forward(
            cfg, params, scales, int8_transpose=int8_transpose))(img)

    base = _canonical(traced(served, None))
    for mode in ("phase-xla", "pallas"):
        assert _canonical(traced(served, mode)) == base, mode
    # The control: with the upsamples' scales the int8 branch is taken.
    with_upsamples = {**served, **{p: np.full(WIDTH, 0.02) for p in UPSAMPLES}}
    for mode, name in (("phase-xla", "transpose_conv2x_int8_phase_xla"),
                       ("pallas", "transpose_conv2x_int8_pallas")):
        with pytest.raises(_Reached, match=name):
            traced(with_upsamples, mode)


CHAIN_PROFILES = {"north_star": configs.NORTH_STAR, "chain_int8": configs.CHAIN_INT8,
                  "dcn_north_star": configs.DCN_NORTH_STAR,
                  "dcn_chain_int8": configs.DCN_CHAIN_INT8,
                  "parity_int8": configs.PARITY_INT8, "dcn_parity_int8": configs.DCN_PARITY_INT8}


@pytest.mark.parametrize("profile", list(CHAIN_PROFILES))
def test_torch_int8_knobs_int8_transpose_changes_no_recipe(profile):
    recipe = CHAIN_PROFILES[profile]
    for value in configs.INT8_TRANSPOSES:
        assert configs.int8_knobs(recipe, int8_transpose=value) == recipe
    assert configs.int8_knobs(recipe, bf16_joins=True, int8_transpose="pallas") == \
        configs.int8_knobs(recipe, bf16_joins=True)
    with pytest.raises(ValueError, match="--int8-transpose takes"):
        configs.int8_knobs(recipe, int8_transpose="on")


def test_torch_int8_knobs_int8_transpose_off_the_chain_profiles():
    with pytest.raises(ValueError, match="reach only the chain profiles"):
        configs.int8_knobs(configs.PER_LAYER_INT8, int8_transpose="pallas")
    with pytest.raises(TypeError):
        configs.int8_knobs(configs.BF16_PAIR, int8_transpose="phase-xla")
