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
- ``centerpoint_flax_path`` is the inverse of the importer's naming: every
  conv, BatchNorm, depthwise upsample and DCN block (with its offset,
  mask and BatchNorm) of the plain, DCN and keypoint nets maps to a flax
  module of the net's tree that names it back, and
  ``centerpoint_calibration_paths`` keys a conv as JAX ``calibrate``
  does (its values and its keys against JAX's are held in
  ``tests/test_torch_centernet_chain.py`` and
  ``tests/test_torch_dcn_chain.py``, which run JAX ``calibrate``).
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
from tauv_vision_tpu_torch.configs import centernet_config, keypoints_config, yolact_config
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.serving.nodes import CenternetServer, YolactServer
from tauv_vision_tpu_torch.serving.pipeline import (
    make_centernet_keypoint_pipeline,
    make_combined_pipeline,
    make_yolact_pipeline,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import DeformConvBlock, DepthwiseUpsample
from tauv_vision_tpu_torch.weights import (
    _centerpoint_name,
    centerpoint_calibration_paths,
    centerpoint_flax_path,
    centerpoint_state_dict_from_flax,
    yolact_state_dict_from_flax,
)
from torch_parity import jax_object_config, random_variables

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


def test_torch_keypoint_centerpoint_weights_round_trip():
    """The keypoint-and-depth net of ``bench.py --keypoints`` (heads:
    heatmap, keypoint heatmap, affinity, size, offset, depth): flax ->
    port (strict load) -> reference importer == flax, every leaf random."""
    oc, _, _ = keypoints_config()
    model = JaxCenterpointDLA34(object_config=jax_object_config(oc), deform=False)
    variables = random_variables(model, (1, 32, 32, 3), 4)
    assert len([k for k in variables["params"]["model"] if k.endswith("_out")]) == 6
    port = CenterpointDLA34(oc, device="cpu")
    port.load_state_dict(centerpoint_state_dict_from_flax(variables), strict=True)
    rebuilt = dict(_flat(load_centerpoint_dla34_state_dict(port.state_dict())))
    want = dict(_flat(variables))
    assert rebuilt.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(rebuilt[path]), leaf, err_msg=str(path))


def _flax_modules(variables):
    """The paths of the flax modules that hold parameters, "model/...",
    and the leaves of each."""
    modules = {}
    for path, _ in _flat(variables["params"]):
        modules.setdefault("/".join(path[:-1]), set()).add(path[-1])
    return modules


@pytest.mark.parametrize("net", ["plain", "dcn", "keypoints"])
def test_torch_centerpoint_flax_path_round_trips(net, centernet_variables, dcn_variables):
    if net == "keypoints":
        oc, _, _ = keypoints_config()
        variables = random_variables(JaxCenterpointDLA34(
            object_config=jax_object_config(oc), deform=False), (1, 32, 32, 3), 4)
    else:
        oc, variables = centernet_variables if net == "plain" else dcn_variables
    port = CenterpointDLA34(oc, device="cpu", deform=net == "dcn")
    modules = _flax_modules(variables)
    seen = set()
    for name, m in port.named_modules():
        if isinstance(m, DeformConvBlock) and not m.deform:
            continue
        if not isinstance(m, (torch.nn.Conv2d, torch.nn.BatchNorm2d, DepthwiseUpsample,
                              DeformConvBlock)):
            continue
        path = centerpoint_flax_path(name)
        assert path in modules, (name, path)
        if isinstance(m, DeformConvBlock):
            assert modules[path] == {"weight", "bias"}, path
        assert _centerpoint_name(tuple(path.split("/")[1:])) == name
        seen.add(path)
    assert seen == set(modules)
    calibrated = {}
    for name, m in port.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            paths = centerpoint_calibration_paths(name)
            calibrated[name] = () if paths is None else (
                (paths,) if isinstance(paths, str) else paths)
    offset_mask = [n for n in calibrated if n.endswith((".offset", ".mask"))]
    assert len(offset_mask) == (32 if net == "dcn" else 0)
    assert all(calibrated[n] == () for n in offset_mask)
    doubled = {n: p for n, p in calibrated.items() if len(p) == 2}
    assert doubled == {f"model.base.level{i}.tree1.project.0": (
        f"model/base/level{i}/tree1/project_conv", f"model/base/level{i}/project_conv")
        for i in (3, 4)}
    for name, paths in calibrated.items():
        assert all(p in modules for p in paths), name


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
    for module in ("models/layers.py", "models/centerpoint_dla.py", "configs/__init__.py",
                   "scripts/op_probe.py", "scripts/int8_dot_probe.py", "ops/image.py",
                   "ops/pnp.py", "serving/nodes.py", "serving/centernet_decode.py",
                   "serving/qat.py", "serving/int8_pair.py", "serving/executor.py",
                   "serving/host_io.py", "serving/pipeline.py", "ops/masks.py",
                   "scripts/quantize_accuracy_check.py", "ops/deform_conv.py",
                   "serving/quantize_chain.py", "scripts/kernel_times.py", "kernels.py"):
        assert PORT / module in sources, module
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


def test_torch_keypoint_codec_matches_jax():
    """The keypoint-index codec of ``ObjectConfigSet``, on the served
    keypoint config and on a set with a keypoint-less class between two
    with keypoints."""
    oc, cn, projection = keypoints_config()
    angle = port_configs.AngleConfig(train=False, modulo=None)
    mixed = port_configs.ObjectConfigSet(configs=tuple(
        port_configs.ObjectConfig(id=name, yaw=angle, pitch=angle, roll=angle,
                                  train_depth=False, train_keypoints=kps is not None,
                                  keypoints=kps)
        for name, kps in (("a", ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0))), ("b", None),
                          ("c", ((0.0, 1.0, 0.0),) * 3))))
    for port in (oc, mixed):
        jax_oc = jax_object_config(port)
        assert _fields(port) == _fields(jax_oc)
        assert port.keypoint_owner_labels() == jax_oc.keypoint_owner_labels()
        assert port.label_id_to_index == jax_oc.label_id_to_index
        for flat in range(port.n_keypoints):
            assert port.decode_keypoint_index(flat) == jax_oc.decode_keypoint_index(flat)
            assert port.encode_keypoint_index(*port.decode_keypoint_index(flat)) == flat
        for c in port.configs:
            assert port.get_by_label(c.id) == c
    assert mixed.keypoint_owner_labels() == (0, 0, 2, 2, 2)
    assert port_configs.get_head_channels(oc) == jax_configs.get_head_channels(
        jax_object_config(oc)) == (1, 8, 16, 2, 2, 1)
    assert cn == centernet_config()[1]
    assert np.asarray(projection).shape == (3, 4)


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
    kp_oc, kp_cfg, projection = keypoints_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_centernet_keypoint_pipeline(model, kp_cfg, kp_oc, projection)
    with pytest.raises(RuntimeError, match="CUDA"):
        CenternetServer(model, kp_cfg, kp_oc, np.eye(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        YolactServer(model, yl_cfg, None, np.eye(3))
    assert next(model.parameters()).device.type == "cpu"
