"""The CenterNet prediction container and the custom-DLA CenterNet
(counterpart of ``Prediction``, ``Head`` and ``Centernet`` in
``tauv_vision_tpu/models/centernet.py``).

Fields are NHWC like the JAX package's, so tests compare like with like.
The models fill them with NHWC views of their NCHW head outputs, so
``heatmap_nchw()`` gives back the contiguous NCHW tensor at no cost.

``Centernet`` is the CenterNet family's own model: ``DLABackbone`` and
one ``Head`` a predicted quantity, built in the JAX model's order
(``head_names``) under its flax names (``heatmap``, ``size``, ...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from tauv_vision_tpu_torch.configs.centernet import ObjectConfigSet, get_head_channels
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.models.dla import DLABackbone
from tauv_vision_tpu_torch.models.layers import (
    Conv2d,
    flax_init_parameters,
    leaky_relu,
    xavier_init_parameters,
)

HEATMAP_BIAS = -2.19


@dataclass
class Prediction:
    heatmap: torch.Tensor                       # [B, H, W, n_labels] logits
    keypoint_heatmap: Optional[torch.Tensor]    # [B, H, W, n_keypoints]
    keypoint_affinity: Optional[torch.Tensor]   # [B, H, W, n_keypoints, 2]

    size: torch.Tensor                          # [B, H, W, 2]
    offset: torch.Tensor                        # [B, H, W, 2]

    roll_bin: Optional[torch.Tensor] = None     # [B, H, W, 4]
    roll_offset: Optional[torch.Tensor] = None
    pitch_bin: Optional[torch.Tensor] = None
    pitch_offset: Optional[torch.Tensor] = None
    yaw_bin: Optional[torch.Tensor] = None
    yaw_offset: Optional[torch.Tensor] = None

    depth: Optional[torch.Tensor] = None        # [B, H, W, 1]

    def heatmap_nchw(self) -> torch.Tensor:
        return self.heatmap.permute(0, 3, 1, 2)

    def keypoint_heatmap_nchw(self) -> torch.Tensor:
        return self.keypoint_heatmap.permute(0, 3, 1, 2)


def head_names(object_config: ObjectConfigSet) -> Tuple[str, ...]:
    """The heads' names in the order of ``get_head_channels``, which is the
    order the JAX ``Centernet`` creates them in."""
    oc = object_config
    names = ["heatmap"]
    if oc.train_keypoints:
        names += ["keypoint_heatmap", "keypoint_affinity"]
    names += ["size", "offset"]
    for angle in ("yaw", "pitch", "roll"):
        if getattr(oc, f"train_{angle}"):
            names += [f"{angle}_bin", f"{angle}_offset"]
    if oc.train_depth:
        names.append("depth")
    return tuple(names)


def prediction_from_heads(object_config: ObjectConfigSet,
                          heads: Sequence[torch.Tensor]) -> Prediction:
    """The ``Prediction`` of the heads' NHWC outputs, in the order of
    ``head_names`` (the JAX models' unpacking); the keypoint affinity
    [B, H, W, 2K] is reshaped to [B, H, W, K, 2]."""
    fields = dict(zip(head_names(object_config), heads))
    aff = fields.get("keypoint_affinity")
    if aff is not None:
        b, h, w, _ = aff.shape
        fields["keypoint_affinity"] = aff.reshape(b, h, w, object_config.n_keypoints, 2)
    return Prediction(**{"keypoint_heatmap": None, "keypoint_affinity": None, **fields})


class Head(nn.Module):
    """3x3 conv, leaky ReLU (slope 0.01, flax's), 1x1 conv; the output in
    f32."""

    def __init__(self, in_channels: int, hidden: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, hidden, 3, padding=1, compute_dtype=dtype)
        self.out = Conv2d(hidden, out_channels, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(leaky_relu(self.conv(x))).float()


class Centernet(nn.Module):
    """``DLABackbone`` (``backbone_heights``, ``backbone_channels``,
    ``downsamples``) and the heads of ``object_config``, each with hidden
    width 2 * channels[0].  Every conv computes in ``dtype`` (the JAX
    ``Centernet(dtype=)``), BatchNorms output f32, the heads' outputs are
    f32.  Weights are drawn from ``generator`` (the torch default
    generator when None) by the JAX model's initialisers (the other port
    models' ``init="flax"``): the backbone's convs and transposed convs
    LeCun normal, the heads' kernels xavier-uniform, biases zero but the
    heatmap heads', which start at -2.19.  The module is moved to
    ``device`` (the card unless the caller passes "cpu"); call ``.eval()``
    to serve."""

    def __init__(self, object_config: ObjectConfigSet, backbone_heights: Sequence[int],
                 backbone_channels: Sequence[int], downsamples: int,
                 generator: Optional[torch.Generator] = None, device=DEFAULT_DEVICE,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.object_config = object_config
        self.backbone = DLABackbone(backbone_heights, backbone_channels, downsamples, dtype)
        self.head_names = head_names(object_config)
        c = backbone_channels[0]
        for name, n_out in zip(self.head_names, get_head_channels(object_config)):
            self.add_module(name, Head(c, 2 * c, n_out, dtype))
        generator = torch.default_generator if generator is None else generator
        flax_init_parameters(self.backbone, generator)
        with torch.no_grad():
            for name in self.head_names:
                xavier_init_parameters(getattr(self, name), generator)
                if name in ("heatmap", "keypoint_heatmap"):
                    getattr(self, name).out.bias.fill_(HEATMAP_BIAS)
        self.to(device)

    def forward(self, img: torch.Tensor) -> Prediction:
        """img: [B, 3, H, W] normalised (the stem casts it to ``dtype``);
        the fields are f32, at H / 2^downsamples x W / 2^downsamples."""
        features = self.backbone(img)
        return prediction_from_heads(
            self.object_config,
            [getattr(self, name)(features).permute(0, 2, 3, 1) for name in self.head_names])
