"""Carry weights between the JAX package and the port.

Each function takes the JAX package's ``{"params", "batch_stats"}`` tree
as nested dicts of numpy arrays (for example ``jax.device_get`` of a
flax ``init``) and returns the port model's ``state_dict``: conv kernels
HWIO -> OIHW, the depthwise upsample ``[k, k, 1, C]`` -> ``[C, 1, k, k]``,
a DCN block's own ``weight`` [3, 3, C, O] / ``bias`` leaves -> its
``conv.weight`` [O, C, 3, 3] / ``conv.bias``,
the protonet's transposed-conv ``[kh, kw, Cin, Cout]`` ->
``[Cin, Cout, kh, kw]``, BatchNorm ``scale/bias/mean/var`` ->
``weight/bias/running_mean/running_var`` (+ ``num_batches_tracked``).
The port never needs JAX for this.

``centerpoint_flax_from_state_dict``, ``yolact_flax_from_state_dict`` and
``yolo_pose_flax_from_state_dict`` are the ways back, and
``read_flax_variables`` / ``write_flax_variables`` read and write such a
tree as the pickle of the JAX package's
``scripts/quantize_accuracy_check.py`` and ``scripts/yolact_parity_check.py``
``--save-model``, so that weights trained in either stack load in the
other.
"""

from __future__ import annotations

import pickle
import re
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]

_HWIO_TO_OIHW = (3, 2, 0, 1)
_HWIO_TO_TRANSPOSED = (2, 3, 0, 1)


def _modules(tree: dict, path: Path = ()) -> Iterator[Tuple[Path, dict]]:
    """Yield (path, leaves) for every flax module that holds arrays."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    if leaves:
        yield path, leaves
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _modules(v, path + (k,))


def _get(tree: dict, path: Path) -> dict:
    for k in path:
        tree = tree[k]
    return tree


def _convert(variables: dict, name_of: Callable[[Path], str],
             root: Path = (),
             transpose_of: Callable[[Path], tuple] = lambda p: _HWIO_TO_OIHW,
             ) -> Dict[str, torch.Tensor]:
    params = _get(variables["params"], root)
    stats = _get(variables.get("batch_stats", {}), root)
    out: Dict[str, torch.Tensor] = {}

    def put(key, value, dtype=np.float32):
        out[key] = torch.from_numpy(np.array(value, dtype=dtype, order="C"))

    for path, leaves in _modules(params):
        name = name_of(path)
        if "kernel" in leaves:
            put(f"{name}.weight", np.transpose(
                np.asarray(leaves["kernel"], np.float32), transpose_of(path)))
            if "bias" in leaves:
                put(f"{name}.bias", leaves["bias"])
        elif "weight" in leaves:  # a DCN block's deformable conv
            put(f"{name}.conv.weight", np.transpose(
                np.asarray(leaves["weight"], np.float32), _HWIO_TO_OIHW))
            put(f"{name}.conv.bias", leaves["bias"])
        elif "scale" in leaves:
            s = _get(stats, path)
            put(f"{name}.weight", leaves["scale"])
            put(f"{name}.bias", leaves["bias"])
            put(f"{name}.running_mean", s["mean"])
            put(f"{name}.running_var", s["var"])
            put(f"{name}.num_batches_tracked", 0, np.int64)
        else:
            raise ValueError(
                f"unsupported module at {'/'.join(path)}: {sorted(leaves)}"
            )
    return out


def _centerpoint_name(path: Path) -> str:
    head = re.fullmatch(r"head_(\d+)_(conv|out)", path[0])
    if head:
        return f"model.{head[1]}.{0 if head[2] == 'conv' else 2}"
    tokens = list(path)
    if tokens[0] == "base":
        conv_level = re.fullmatch(r"(level[01])_(conv|bn)(\d+)", tokens[1])
        if tokens[1] in ("base_conv", "base_bn"):
            tokens[1:2] = ["base_layer", "0" if tokens[1] == "base_conv" else "1"]
        elif conv_level:
            idx = 3 * int(conv_level[3]) + (conv_level[2] == "bn")
            tokens[1:2] = [conv_level[1], str(idx)]
        else:
            tokens = [{"project_conv": "project.0", "project_bn": "project.1"}
                      .get(t, t) for t in tokens]
    elif tokens[0] in ("dla_up", "ida_up") and tokens[-1] == "bn":
        tokens[-1] = "actf.0"  # the IDA blocks' BatchNorm
    return "model." + ".".join(tokens)


# (port module name pattern, JAX path template) for the names whose
# tokens differ; every other name maps dot for slash.
_CENTERPOINT_PATHS = (
    (r"model\.(\d+)\.0", r"model/head_\1_conv"),
    (r"model\.(\d+)\.2", r"model/head_\1_out"),
    (r"model\.base\.base_layer\.0", "model/base/base_conv"),
    (r"model\.base\.base_layer\.1", "model/base/base_bn"),
    (r"model\.base\.level([01])\.0", r"model/base/level\1_conv0"),
    (r"model\.base\.level([01])\.1", r"model/base/level\1_bn0"),
    (r"(model\.base\..*)\.project\.0", r"\1.project_conv"),
    (r"(model\.base\..*)\.project\.1", r"\1.project_bn"),
    (r"(model\.(?:dla_up\.ida_\d+|ida_up)\.(?:proj|node)_\d+)\.actf\.0", r"\1.bn"),
)


def centerpoint_flax_path(name: str) -> str:
    """The JAX package's module path (``model/base/level0_conv0``,
    ``model/dla_up/ida_0/proj_1/conv``) of a port ``CenterpointDLA34``
    module name (``model.base.level0.0``, ``model.dla_up.ida_0.proj_1.conv``):
    the inverse of the naming used by ``centerpoint_state_dict_from_flax``,
    so that calibration scales are keyed the same in both stacks.  It
    covers the convs and BatchNorms, the depthwise upsamples (``up_1``),
    a DCN block (``proj_1``, whose flax module holds the deformable
    ``weight`` and ``bias``) with its ``offset``, ``mask`` and ``bn``, and
    the heads (``model.0.0`` -> ``model/head_0_conv``)."""
    for pattern, template in _CENTERPOINT_PATHS:
        if re.fullmatch(pattern, name):
            name = re.sub(pattern, template, name)
            break
    return name.replace(".", "/")


def centerpoint_calibration_paths(name: str):
    """The JAX paths whose conv input a port ``CenterpointDLA34`` conv
    ``name`` stands for in ``serving.quantize.calibrate``, which records
    what the JAX forward records:

    - a DCN block's ``offset`` and ``mask`` convs: none, since the JAX
      block serves them as one merged conv that is not an ``nn.Conv``
      call (``merge_offset_mask``);
    - the projection of a level-1 tree that is its parent's ``tree1``
      (``level3``, ``level4``): its own path and its parent's, since the
      JAX parent tree also projects the same pooled input (and discards
      it), where the port's runs no such conv;
    - any other conv: its ``centerpoint_flax_path``."""
    path = centerpoint_flax_path(name)
    if re.fullmatch(r"model/(dla_up/ida_\d+|ida_up)/(proj|node)_\d+/(offset|mask)", path):
        return None
    parent = re.fullmatch(r"(model/base/.+)/tree1/project_conv", path)
    if parent:
        return (path, f"{parent[1]}/project_conv")
    return path


def centerpoint_state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """``CenterpointDLA34`` weights, plain-conv or DCN IDA (flax tree
    under ``model``) -> the port's ``CenterpointDLA34`` state dict."""
    return _convert(variables, _centerpoint_name, root=("model",))


_HEAD_GROUPS = {"shared": "_extra", "cls": "_classification_extra",
                "box": "_box_extra", "mask": "_mask_extra"}
_HEAD_OUTPUTS = {"classification": "_classification_layer",
                 "box": "_box_encoding_layer", "mask": "_mask_coeff_layer"}


def _yolact_name(path: Path) -> str:
    top, rest = path[0], path[1:]
    if top == "backbone":
        block = re.fullmatch(r"layer(\d)_(\d)", rest[0])
        if block is None:
            return "_backbone." + rest[0]
        sub = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}.get(rest[1], rest[1])
        return f"_backbone.layer{block[1]}.{block[2]}.{sub}"
    if top == "fpn":
        kind, i = rest[0].rsplit("_", 1)
        return f"_feature_pyramid._{kind}_layers.{i}"
    if top == "protonet":
        name = rest[0]
        if name == "output":
            return "_masknet._output_layer"
        kind, i = name.rsplit("_", 1)
        if kind == "upsample":
            return f"_masknet._upsample_layer_{i}"
        stack = {"pre": 1, "mid": 2, "post": 3}[kind]
        return f"_masknet._layers_{stack}.{i}.0"
    if top == "prediction_head":
        if len(rest) == 1 and rest[0] in _HEAD_OUTPUTS:
            return f"_prediction_head.{_HEAD_OUTPUTS[rest[0]]}"
        group, i = rest[0].rsplit("_", 1)
        prefix = f"_prediction_head.{_HEAD_GROUPS[group]}"
        if rest[1] == "bottleneck":
            return f"{prefix}_layers.{i}.{rest[2]}"
        return f"{prefix}_{rest[1]}_layers.{i}"
    raise ValueError(f"unrecognised YOLACT module {'/'.join(path)}")


_HEAD_GROUP_OF = {v: k for k, v in _HEAD_GROUPS.items()}
_HEAD_OUTPUT_OF = {v: k for k, v in _HEAD_OUTPUTS.items()}
_PROTONET_STACKS = {"1": "pre", "2": "mid", "3": "post"}


def yolact_flax_path(name: str) -> str:
    """The JAX package's module path (``backbone/layer1_0/conv1``) of a
    port ``Yolact`` module name (``_backbone.layer1.0.conv1``): the
    inverse of the naming used by ``yolact_state_dict_from_flax``, so that
    calibration scales are keyed the same in both stacks."""
    top, _, rest = name.partition(".")
    parts = rest.split(".")
    if top == "_backbone":
        if len(parts) == 1:
            return f"backbone/{parts[0]}"
        layer, block, sub = parts[0], parts[1], ".".join(parts[2:])
        sub = {"downsample.0": "downsample_conv",
               "downsample.1": "downsample_bn"}.get(sub, sub)
        return f"backbone/{layer}_{block}/{sub}"
    if top == "_feature_pyramid":
        kind = re.fullmatch(r"_(\w+)_layers", parts[0])[1]
        return f"fpn/{kind}_{parts[1]}"
    if top == "_masknet":
        if parts[0] == "_output_layer":
            return "protonet/output"
        upsample = re.fullmatch(r"_upsample_layer_(\d)", parts[0])
        if upsample:
            return f"protonet/upsample_{upsample[1]}"
        stack = re.fullmatch(r"_layers_(\d)", parts[0])[1]
        return f"protonet/{_PROTONET_STACKS[stack]}_{parts[1]}"
    if top == "_prediction_head":
        if parts[0] in _HEAD_OUTPUT_OF:
            return f"prediction_head/{_HEAD_OUTPUT_OF[parts[0]]}"
        kind = re.fullmatch(r"(_\w+?)(_conv|_bn)?_layers", parts[0])
        prefix = f"prediction_head/{_HEAD_GROUP_OF[kind[1]]}_{parts[1]}"
        if kind[2] is None:
            return f"{prefix}/bottleneck/{parts[2]}"
        return f"{prefix}/{kind[2][1:]}"
    raise ValueError(f"unrecognised YOLACT module {name}")


def _protonet_upsample(path: Path) -> bool:
    """Whether a flax module path is one of the protonet's transposed
    convs, whose kernels are ``[kh, kw, Cin, Cout]`` in both stacks'
    order ``_HWIO_TO_TRANSPOSED``."""
    return path[0] == "protonet" and path[1].startswith("upsample")


def _yolact_transpose_of(path: Path) -> tuple:
    return _HWIO_TO_TRANSPOSED if _protonet_upsample(path) else _HWIO_TO_OIHW


def yolact_state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """``Yolact`` weights -> the port's ``Yolact`` state dict."""
    return _convert(variables, _yolact_name, transpose_of=_yolact_transpose_of)


# The YOLO-Pose trunk, FPN and protonet are the YOLACT's under the JAX
# package's own module names.
_YOLACT_PREFIXES = {"backbone": "_backbone", "fpn": "_feature_pyramid", "protonet": "_masknet"}
_YOLACT_PREFIX_OF = {v: k for k, v in _YOLACT_PREFIXES.items()}


def _yolo_pose_name(path: Path) -> str:
    top, rest = path[0], path[1:]
    if top in _YOLACT_PREFIXES:
        prefix, _, name = _yolact_name(path).partition(".")
        return f"{_YOLACT_PREFIX_OF[prefix]}.{name}"
    if top == "pointnet":
        branch, i = rest[0].rsplit("_", 1)
        conv = re.fullmatch(r"conv_(\d+)", rest[1])
        layer = f"convs.{conv[1]}" if conv else rest[1]
        return f"pointnet.{branch}.{i}.{layer}"
    if top == "prediction_head":
        shared = re.fullmatch(r"shared_(\d+)", rest[0])
        if shared:
            return ".".join(("prediction_head.shared", shared[1]) + rest[1:])
        return f"prediction_head.{rest[0]}"
    raise ValueError(f"unrecognised YOLO-Pose module {'/'.join(path)}")


def yolo_pose_flax_path(name: str) -> str:
    """The JAX package's module path (``pointnet/belief_0/conv_1``,
    ``prediction_head/shared_0/bottleneck/conv1``, ``backbone/layer1_0/conv1``)
    of a port ``YoloPose`` module name (``pointnet.belief.0.convs.1``,
    ``prediction_head.shared.0.bottleneck.conv1``,
    ``backbone.layer1.0.conv1``): the inverse of the naming used by
    ``yolo_pose_state_dict_from_flax``."""
    top, _, rest = name.partition(".")
    if top in _YOLACT_PREFIXES:
        return yolact_flax_path(f"{_YOLACT_PREFIXES[top]}.{rest}")
    parts = rest.split(".")
    if top == "pointnet":
        layer = f"conv_{parts[3]}" if parts[2] == "convs" else parts[2]
        return f"pointnet/{parts[0]}_{parts[1]}/{layer}"
    if top == "prediction_head":
        if parts[0] == "shared":
            return "/".join([f"prediction_head/shared_{parts[1]}"] + parts[2:])
        return f"prediction_head/{parts[0]}"
    raise ValueError(f"unrecognised YOLO-Pose module {name}")


def yolo_pose_state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """``YoloPose`` weights -> the port's ``YoloPose`` state dict."""
    return _convert(variables, _yolo_pose_name, transpose_of=_yolact_transpose_of)


_OIHW_TO_HWIO = (2, 3, 1, 0)
_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _put(tree: dict, path: str, leaf: str, value: np.ndarray) -> None:
    node = tree
    for k in path.split("/"):
        node = node.setdefault(k, {})
    node[leaf] = value


def _flax_from_state_dict(state_dict: Dict[str, torch.Tensor], flax_path: Callable[[str], str],
                          transposed: Callable[[Path], bool] = lambda path: False) -> dict:
    """A port state dict -> the JAX package's ``{"params", "batch_stats"}``
    tree of f32 numpy arrays, each module at ``flax_path(name)``: conv
    kernels OIHW -> HWIO (a transposed conv's, where ``transposed`` holds
    for its path's tokens, ``[Cin, Cout, kh, kw]`` -> ``[kh, kw, Cin,
    Cout]`` by ``_HWIO_TO_TRANSPOSED``, its own inverse), a DCN block's
    ``conv.weight`` / ``conv.bias`` -> its own ``weight`` / ``bias``
    leaves, BatchNorm ``weight/bias`` -> ``scale/bias`` under ``params``
    and ``running_mean/var`` -> ``mean/var`` under ``batch_stats``;
    ``num_batches_tracked`` has no counterpart."""
    variables: dict = {"params": {}, "batch_stats": {}}

    def array(t):
        return np.array(t.detach().cpu().float().numpy(), np.float32, order="C")

    for key, value in state_dict.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        if f"{module}.running_mean" in state_dict:
            collection, name = _BN_LEAVES[leaf]
            _put(variables[collection], flax_path(module), name, array(value))
            continue
        block = module[:-len(".conv")]
        if module.endswith(".conv") and f"{block}.offset.weight" in state_dict:
            module, name = block, leaf   # a DCN block's deformable conv
        else:
            name = "kernel" if leaf == "weight" else leaf
        path = flax_path(module)
        value = array(value)
        if leaf == "weight":
            order = _HWIO_TO_TRANSPOSED if transposed(tuple(path.split("/"))) else _OIHW_TO_HWIO
            value = np.ascontiguousarray(np.transpose(value, order))
        _put(variables["params"], path, name, value)
    return variables


def centerpoint_flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``centerpoint_state_dict_from_flax``: a port
    ``CenterpointDLA34`` state dict -> the JAX package's variables tree
    (``_flax_from_state_dict``)."""
    return _flax_from_state_dict(state_dict, centerpoint_flax_path)


def yolact_flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``yolact_state_dict_from_flax``: a port ``Yolact``
    state dict -> the JAX package's variables tree, the protonet's two
    transposed convs permuted back as they were imported."""
    return _flax_from_state_dict(state_dict, yolact_flax_path, _protonet_upsample)


def yolo_pose_flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``yolo_pose_state_dict_from_flax``: a port
    ``YoloPose`` state dict (the YOLACT's trunk, FPN and protonet, the
    Pointnet's 7x7 convs, the shared head) -> the JAX package's variables
    tree."""
    return _flax_from_state_dict(state_dict, yolo_pose_flax_path, _protonet_upsample)


class _VariablesUnpickler(pickle.Unpickler):
    """Reads a pickled variables tree without flax: an older flax pickles
    its trees as ``FrozenDict``, read here as a ``dict`` (flax 0.12 pickles
    plain dicts)."""

    def find_class(self, module, name):
        if module.startswith("flax.") and name == "FrozenDict":
            return dict
        return super().find_class(module, name)


def read_flax_variables(path) -> dict:
    """The ``{"params", "batch_stats"}`` tree of numpy arrays that
    ``write_flax_variables``, or the JAX package's
    ``scripts/quantize_accuracy_check.py --save-model``, pickled at
    ``path``."""
    with open(path, "rb") as fp:
        return _VariablesUnpickler(fp).load()


def write_flax_variables(path, variables: dict) -> None:
    """Pickle a variables tree of numpy arrays (for example
    ``centerpoint_flax_from_state_dict``'s) as the JAX package's
    ``--save-model`` does, so that either stack reads it."""
    with open(path, "wb") as fp:
        pickle.dump(variables, fp)
