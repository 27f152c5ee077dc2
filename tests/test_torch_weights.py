"""Weight carriage between the JAX package and the PyTorch port.

- The port's CenterNet ``state_dict`` goes through the JAX package's own
  reference-torch importer (``load_centerpoint_dla34_state_dict``) and
  rebuilds the flax tree leaf for leaf: the live check that the port
  keeps the reference torch names.  The same holds with DCN IDA
  (``deform=True``), whose blocks carry the deformable kernel as
  block-level ``weight`` / ``bias`` leaves in flax and as ``conv`` in
  torch; there every leaf is random, so a transposition cannot hide.
- ``yolact_state_dict_from_flax`` equals the JAX package's
  ``export_yolact_state_dict`` and loads into the port strictly.
- The port, ``chip_smoke.py`` and the card-only tests import no JAX and
  nothing of the JAX package; the port's copies of the configuration
  dataclasses equal the JAX package's field by field for the served
  configurations.
- Models and pipelines run on the card unless the caller asks for the
  CPU: without CUDA, building one with no device raises.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.centerpoint_dla import (
    CenterpointDLA34 as JaxCenterpointDLA34,
    load_centerpoint_dla34_state_dict,
)
from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu.models.yolact import export_yolact_state_dict
from tauv_vision_tpu import configs as jax_configs
from tauv_vision_tpu_torch import configs as port_configs
from tauv_vision_tpu_torch.configs import centernet_config, yolact_config
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.serving.pipeline import make_combined_pipeline, make_yolact_pipeline
from tauv_vision_tpu_torch.weights import (
    centerpoint_state_dict_from_flax,
    yolact_state_dict_from_flax,
)
from torch_parity import random_variables

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "tauv_vision_tpu_torch"


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _randomize_stats(variables, seed):
    """numpy tree with non-trivial BatchNorm statistics."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(variables))
    for path, leaf in _flat(tree.get("batch_stats", {})):
        node = tree["batch_stats"]
        for k in path[:-1]:
            node = node[k]
        lo, hi = (-0.3, 0.3) if path[-1] == "mean" else (0.5, 1.5)
        node[path[-1]] = rng.uniform(lo, hi, leaf.shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def centernet_variables():
    oc, _ = centernet_config()
    model = JaxCenterpointDLA34(object_config=oc, deform=False)
    variables = jax.jit(
        lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)), train=False)
    )(jax.random.key(0))
    return oc, _randomize_stats(variables, 0)


def test_torch_centerpoint_names_rebuild_flax_tree(centernet_variables):
    """A freshly built port model's state_dict imports into exactly the
    flax tree structure (every path, every shape)."""
    oc, variables = centernet_variables
    port = CenterpointDLA34(oc, generator=torch.Generator().manual_seed(0), device="cpu")
    rebuilt = load_centerpoint_dla34_state_dict(port.state_dict())
    want = {p: a.shape for p, a in _flat(variables)}
    got = {p: np.asarray(a).shape for p, a in _flat(rebuilt)}
    assert got == want


def test_torch_centerpoint_weights_round_trip(centernet_variables):
    """flax -> port (strict load) -> reference importer == flax, leaf for leaf."""
    oc, variables = centernet_variables
    port = CenterpointDLA34(oc, device="cpu")
    port.load_state_dict(centerpoint_state_dict_from_flax(variables), strict=True)
    rebuilt = dict(_flat(load_centerpoint_dla34_state_dict(port.state_dict())))
    want = dict(_flat(variables))
    assert rebuilt.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(rebuilt[path]), leaf, err_msg=str(path))


@pytest.fixture(scope="module")
def dcn_variables():
    oc, _ = centernet_config()
    model = JaxCenterpointDLA34(object_config=oc, deform=True, dcn_impl="gather")
    return oc, random_variables(model, (1, 32, 32, 3), 2)


def test_torch_dcn_centerpoint_names_rebuild_flax_tree(dcn_variables):
    oc, variables = dcn_variables
    port = CenterpointDLA34(oc, deform=True, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    rebuilt = load_centerpoint_dla34_state_dict(port.state_dict())
    want = {p: a.shape for p, a in _flat(variables)}
    got = {p: np.asarray(a).shape for p, a in _flat(rebuilt)}
    assert got == want
    assert len(port.deform_convs()) == 16


def test_torch_dcn_centerpoint_weights_round_trip(dcn_variables):
    """flax (DCN IDA) -> port (strict load) -> reference importer == flax."""
    oc, variables = dcn_variables
    port = CenterpointDLA34(oc, deform=True, device="cpu")
    port.load_state_dict(centerpoint_state_dict_from_flax(variables), strict=True)
    rebuilt = dict(_flat(load_centerpoint_dla34_state_dict(port.state_dict())))
    want = dict(_flat(variables))
    assert rebuilt.keys() == want.keys()
    assert ("params", "model", "ida_up", "node_2", "weight") in want
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(rebuilt[path]), leaf, err_msg=str(path))


def test_torch_yolact_weights_match_export():
    cfg = yolact_config(72, 104, feature_depth=32)
    model = JaxYolact(cfg)
    variables = _randomize_stats(
        jax.jit(lambda k: model.init(k, jnp.zeros((1, 72, 104, 3)), train=False))(
            jax.random.key(1)
        ), 1,
    )
    got = yolact_state_dict_from_flax(variables)
    want = export_yolact_state_dict(variables)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    port = Yolact(cfg, device="cpu")
    port.load_state_dict(got, strict=True)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_torch_port_imports_no_jax():
    sources = sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_kernels_cuda.py"]
    assert len(sources) > 10
    for path in sources:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "flax", "optax", "tauv_vision_tpu"), (path, name)


def _fields(config):
    """Every dataclass field, nested dataclasses and tuples of them as
    (class name, fields), and the derived properties the port reads."""
    if dataclasses.is_dataclass(config):
        value = {f.name: _fields(getattr(config, f.name)) for f in dataclasses.fields(config)}
        for prop in ("n_anchors_per_cell", "n_fpn_levels", "downsample_ratio", "out_h",
                     "out_w", "train_yaw", "train_pitch", "train_roll", "train_depth",
                     "train_keypoints", "n_labels", "n_keypoints"):
            if hasattr(config, prop):
                value[prop] = getattr(config, prop)
        return type(config).__name__, value
    if isinstance(config, tuple):
        return tuple(_fields(c) for c in config)
    return config


def test_torch_configs_match_jax():
    oc, cn = centernet_config()
    jax_oc = jax_configs.ObjectConfigSet(configs=tuple(
        jax_configs.ObjectConfig(
            id=c.id, yaw=jax_configs.AngleConfig(**dataclasses.asdict(c.yaw)),
            pitch=jax_configs.AngleConfig(**dataclasses.asdict(c.pitch)),
            roll=jax_configs.AngleConfig(**dataclasses.asdict(c.roll)),
            train_depth=c.train_depth, train_keypoints=c.train_keypoints,
            keypoints=c.keypoints)
        for c in oc.configs))
    served = [
        (oc, jax_oc),
        (cn, jax_configs.CenternetModelConfig(**dataclasses.asdict(cn))),
        (yolact_config(), jax_configs.YolactModelConfig(**dataclasses.asdict(yolact_config()))),
    ]
    for port, jax_config in served:
        assert [f.name for f in dataclasses.fields(port)] == [
            f.name for f in dataclasses.fields(jax_config)]
        assert _fields(port) == _fields(jax_config)
    assert port_configs.get_head_channels(oc) == jax_configs.get_head_channels(jax_oc) == (4, 2, 2)


def test_torch_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    oc, cn_cfg = centernet_config()
    yl_cfg = yolact_config(72, 104, feature_depth=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Yolact(yl_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        CenterpointDLA34(oc)
    model = Yolact(yl_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_yolact_pipeline(model, yl_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_combined_pipeline(model, cn_cfg, model, yl_cfg)
    assert next(model.parameters()).device.type == "cpu"
