"""The port's ResNet trunks of every depth YOLO-Pose takes (18, 34, 50,
101: ``models/resnet.py``) against the JAX package's ``ResnetFeatures``,
and YOLO-Pose on the ResNet-50 trunk, on the CPU.

The JAX model's weights are drawn with numpy
(``torch_parity.random_variables``), carried over by the YOLO-Pose weight
map; inputs are seeded numpy, f32:

- ``ResnetFeatures`` at 34 and 50 on 64x64 images: the three taps within
  2e-4 of JAX's, at its tap depths;
- the block counts of every depth (a Bottleneck trunk projects the
  identity of every layer's first block, layer 1's included; a
  BasicBlock trunk of layers 2-4 only), and the weight map flax -> port
  -> flax bit for bit over every leaf of ``YoloPose`` at each depth (the
  JAX shapes by ``jax.eval_shape``; at 101 no JAX forward);
- ``YoloPose(backbone_depth=50)`` at the small config of
  ``tests/test_yolo_pose.py``: every raw field within 2e-4, the FPN
  reading the trunk's 512/1024/2048 taps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.resnet import RESNET_LAYER_COUNTS as JAX_LAYER_COUNTS
from tauv_vision_tpu.models.resnet import ResnetFeatures as JaxResnetFeatures
from tauv_vision_tpu_torch.configs import YoloPoseModelConfig
from tauv_vision_tpu_torch.models.resnet import (
    RESNET_LAYER_COUNTS,
    BottleneckBlock,
    ResnetFeatures,
)
from tauv_vision_tpu_torch.weights import (
    _convert,
    _yolact_name,
    yolo_pose_flax_from_state_dict,
    yolo_pose_flax_path,
)
from test_torch_yolo_pose import FIELDS, SMALL, STAGE_FIELDS, yolo_pose_pair
from torch_parity import random_variables, torch_threads

TAP_ATOL = 2e-4
RAW_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("depth", [34, 50])
def test_torch_resnet_features_match_jax(depth):
    jax_model = JaxResnetFeatures(depth=depth)
    variables = random_variables(jax_model, (1, 64, 64, 3), depth)
    port = ResnetFeatures(depth).eval()
    # The trunk's flax names are YOLO-Pose's under its "backbone".
    port.load_state_dict(_convert(
        variables, lambda path: _yolact_name(("backbone",) + path).partition(".")[2]),
        strict=True)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jax_model.apply(v, x))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = port(_nchw(x))
    assert port.tap_depths == jax_model.tap_depths
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape[1] == port.tap_depths[i]
        assert g.shape[-2:] == (8 >> i, 8 >> i)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=0,
                                   atol=TAP_ATOL, err_msg=f"tap {i}")


@pytest.mark.parametrize("depth", [18, 34, 50, 101])
def test_torch_resnet_block_counts(depth):
    assert RESNET_LAYER_COUNTS[depth] == JAX_LAYER_COUNTS[depth]
    port = ResnetFeatures(depth)
    layers = [getattr(port, f"layer{i}") for i in (1, 2, 3, 4)]
    assert tuple(len(layer) for layer in layers) == RESNET_LAYER_COUNTS[depth]
    bottleneck = depth >= 50
    assert all(isinstance(b, BottleneckBlock) == bottleneck for layer in layers for b in layer)
    projected = [[b.downsample is not None for b in layer] for layer in layers]
    assert projected == [[i > 0 or bottleneck if j == 0 else False for j in range(len(layer))]
                         for i, layer in enumerate(layers)]
    with pytest.raises(ValueError, match="depth"):
        ResnetFeatures(42)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("depth", [18, 34, 50, 101])
def test_torch_yolo_pose_weights_round_trip(depth):
    """Every flax leaf of ``YoloPose`` at ``depth`` maps to one port tensor
    and back bit for bit; the flax path of every port module is JAX's."""
    cfg = YoloPoseModelConfig(**{**SMALL, "backbone_depth": depth})
    _, variables, port = yolo_pose_pair(torch.float32, 0, cfg)
    state = port.state_dict()
    flax_leaves = dict(_leaves(variables))
    assert len(flax_leaves) == sum(not k.endswith("num_batches_tracked") for k in state)
    back = dict(_leaves(yolo_pose_flax_from_state_dict(state)))
    assert set(back) == set(flax_leaves)
    for path, value in back.items():
        assert np.array_equal(value, flax_leaves[path]), path
    names = [n for n, m in port.named_modules() if list(m.parameters(recurse=False))]
    assert {yolo_pose_flax_path(n) for n in names} == {"/".join(p[1:-1]) for p in flax_leaves}
    if depth == 101:
        assert len(port.backbone.layer3) == 23
        assert "layer3_22" in variables["params"]["backbone"]


def test_torch_yolo_pose_resnet50_matches_jax():
    cfg = YoloPoseModelConfig(**{**SMALL, "backbone_depth": 50})
    jax_model, variables, port = yolo_pose_pair(torch.float32, 1, cfg)
    assert [c.in_channels for c in port.fpn._lateral_layers] == [512, 1024, 2048]
    x = np.random.default_rng(2).standard_normal((2, cfg.in_h, cfg.in_w, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = port(_nchw(x))
    for name in FIELDS:
        g = getattr(got, name)
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)), rtol=0,
                                   atol=RAW_ATOL, err_msg=name)
    for name in STAGE_FIELDS:
        for i, (g, w) in enumerate(zip(getattr(got, name), getattr(want, name))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=RAW_ATOL,
                                       err_msg=f"{name}/{i}")


def test_torch_yolo_pose_config_takes_every_depth():
    for depth in (18, 34, 50, 101):
        assert dataclasses.replace(YoloPoseModelConfig(**SMALL),
                                   backbone_depth=depth).backbone_depth == depth
    with pytest.raises(ValueError, match="backbone_depth"):
        YoloPoseModelConfig(**{**SMALL, "backbone_depth": 42})
