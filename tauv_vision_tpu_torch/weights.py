"""Carry weights from the JAX package into the port.

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
"""

from __future__ import annotations

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


def yolact_state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """``Yolact`` weights -> the port's ``Yolact`` state dict."""
    return _convert(
        variables, _yolact_name,
        transpose_of=lambda p: (_HWIO_TO_TRANSPOSED
                                if p[0] == "protonet" and p[1].startswith("upsample")
                                else _HWIO_TO_OIHW),
    )
