"""DLA-34 CenterNet with plain-conv or deformable (DCNv2) IDA.

Counterpart of ``tauv_vision_tpu/models/centerpoint_dla.py``: the DLA-34
trunk, DLAUp / IDAUp aggregation whose 16 conv blocks are plain 3x3 convs
(``deform=False``, the served ``bench.py`` default) or modulated
deformable convs (``deform=True``, the reference's deployed net; kernel
E), the trainable bilinear depthwise upsamples (kernel C), and the heads
(3x3 conv, ReLU, 1x1 conv; the heatmap head's bias starts at -2.19).
NCHW inside; the ``Prediction`` is NHWC.

Module and parameter names follow the reference torch layout that
``tauv_vision_tpu.models.centerpoint_dla.load_centerpoint_dla34_state_dict``
reads (``base.base_layer.0``, ``dla_up.ida_{i}.{proj,up,node}_{j}``,
heads ``{idx}.0`` / ``{idx}.2``), so one state dict serves both stacks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu.configs.centernet import ObjectConfigSet, get_head_channels
from tauv_vision_tpu_torch.models.centernet import Prediction
from tauv_vision_tpu_torch.models.layers import batch_norm, init_parameters
from tauv_vision_tpu_torch.ops.conv_transpose import (
    bilinear_kernel,
    depthwise_upsample,
    depthwise_upsample_cuda,
)
from tauv_vision_tpu_torch.ops.deform_conv import DeformConv2d

DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)
FIRST_LEVEL = 2   # down ratio 4
LAST_LEVEL = 5
HEAD_CONV = 256
HEATMAP_BIAS = -2.19
UP_IMPLS = ("kernel", "plain")


def pad_to_match(feature: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """The reference's size matcher, exactly: when the feature overshoots
    the target by >= 2 it pads (over // 2) zero rows/cols at the top/left
    and then keeps the first target rows/cols, shifting content down/right.
    The reference trains with that shift, so it is kept verbatim."""
    h, w = feature.shape[-2], feature.shape[-1]
    th, tw = int(target_hw[0]), int(target_hw[1])
    if (h, w) == (th, tw):
        return feature
    pad_top = max(0, (h - th) // 2)
    pad_bottom = max(0, th - h - pad_top)
    pad_left = max(0, (w - tw) // 2)
    pad_right = max(0, tw - w - pad_left)
    feature = F.pad(feature, (pad_left, pad_right, pad_top, pad_bottom))
    return feature[..., :th, :tw]


class BasicBlock(nn.Module):
    """conv3x3(s)-bn-relu-conv3x3-bn (+ supplied residual) - relu."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(planes)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + pad_to_match(residual, out.shape[-2:]))


class Root(nn.Module):
    """concat -> 1x1 conv -> bn (+ children[0] if residual) -> relu."""

    def __init__(self, in_channels: int, out_channels: int, residual: bool):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.bn = batch_norm(out_channels)
        self.residual = residual

    def forward(self, children: List[torch.Tensor]):
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """HDA tree; ceil-mode max-pool downsampling."""

    def __init__(self, levels: int, in_channels: int, out_channels: int,
                 stride: int = 1, level_root: bool = False, root_dim: int = 0,
                 root_residual: bool = False):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        if levels == 1:
            self.tree1 = BasicBlock(in_channels, out_channels, stride)
            self.tree2 = BasicBlock(out_channels, out_channels, 1)
            self.root = Root(root_dim, out_channels, root_residual)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_dim=0, root_residual=root_residual)
            self.tree2 = Tree(levels - 1, out_channels, out_channels,
                              root_dim=root_dim + out_channels,
                              root_residual=root_residual)
        self.project = None
        if in_channels != out_channels:
            self.project = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, bias=False),
                batch_norm(out_channels),
            )

    def forward(self, x, children=None):
        children = [] if children is None else list(children)
        bottom = x
        if self.stride > 1:
            bottom = F.max_pool2d(x, self.stride, self.stride, ceil_mode=True)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        # A deeper tree's projection is never read: tree1 projects anew.
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


def _conv_level(in_channels: int, out_channels: int, stride: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=False),
        batch_norm(out_channels),
        nn.ReLU(inplace=True),
    )


class DLATrunk(nn.Module):
    """DLA-34 feature trunk returning all six level outputs."""

    def __init__(self):
        super().__init__()
        levels, channels = DLA34_LEVELS, DLA34_CHANNELS
        self.base_layer = nn.Sequential(
            nn.Conv2d(3, channels[0], 7, 1, 3, bias=False),
            batch_norm(channels[0]),
            nn.ReLU(inplace=True),
        )
        self.level0 = _conv_level(channels[0], channels[0], 1)
        self.level1 = _conv_level(channels[0], channels[1], 2)
        for i in (2, 3, 4, 5):
            self.add_module(f"level{i}", Tree(
                levels[i], channels[i - 1], channels[i], 2,
                level_root=(i != 2),
            ))

    def forward(self, img):
        x = self.base_layer(img)
        outputs = []
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            outputs.append(x)
        return outputs


class DeformConvBlock(nn.Module):
    """The IDA conv block, then BN + ReLU (``actf``).

    ``deform=False``: a plain 3x3 conv (``conv``), the reference's
    plain-IDA layout.  ``deform=True``: DCNv2 as the reference builds it
    (``offset`` 3x3 conv to 18 channels, ``mask`` 3x3 conv to 9 channels
    and sigmoid, ``conv`` the ``DeformConv2d``); ``offset_bound`` squashes
    the offsets through ``bound * tanh(offset / bound)`` as the JAX
    block's option does, and ``dcn_impl`` picks kernel E or the plain
    version (see ``DeformConv2d``)."""

    def __init__(self, in_channels: int, out_channels: int, deform: bool = False,
                 offset_bound: Optional[float] = None, dcn_impl: str = "kernel"):
        super().__init__()
        self.deform = deform
        self.offset_bound = offset_bound
        if deform:
            self.offset = nn.Conv2d(in_channels, 18, 3, padding=1)
            self.mask = nn.Conv2d(in_channels, 9, 3, padding=1)
            self.conv = DeformConv2d(in_channels, out_channels, dcn_impl)
        else:
            self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.actf = nn.Sequential(batch_norm(out_channels), nn.ReLU(inplace=True))

    def forward(self, x):
        if not self.deform:
            return self.actf(self.conv(x))
        offset = self.offset(x)
        if self.offset_bound is not None:
            offset = self.offset_bound * torch.tanh(offset / self.offset_bound)
        mask = torch.sigmoid(self.mask(x))
        return self.actf(self.conv(x, offset, mask))


class DepthwiseUpsample(nn.Module):
    """groups=C ConvTranspose(kernel 2f, stride f, padding f//2, no bias),
    initialised to bilinear interpolation and trainable.

    ``impl="kernel"`` runs ``depthwise_upsample_cuda`` (kernel C on a CUDA
    tensor, the plain version on a CPU one); ``impl="plain"`` always runs
    the plain version, for comparisons on the card."""

    def __init__(self, channels: int, factor: int, impl: str = "kernel"):
        super().__init__()
        if impl not in UP_IMPLS:
            raise ValueError(f"impl must be one of {UP_IMPLS}, got {impl!r}")
        self.factor = factor
        self.impl = impl
        k = 2 * factor
        self.weight = nn.Parameter(torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(bilinear_kernel(k), (channels, 1, k, k))
        )))

    def forward(self, x):
        fn = depthwise_upsample_cuda if self.impl == "kernel" else depthwise_upsample
        return fn(x, self.weight, self.factor)


class IDAUpStage(nn.Module):
    """One IDAUp: for i in 1..n-1,
    layers[i] = node(up(proj(layers[i])) + layers[i-1])."""

    def __init__(self, out_channels: int, in_channels: Sequence[int],
                 up_factors: Sequence[int], up_impl: str = "kernel", **block):
        super().__init__()
        self.up_factors = [int(f) for f in up_factors]
        for i in range(1, len(in_channels)):
            self.add_module(f"proj_{i}", DeformConvBlock(
                in_channels[i], out_channels, **block))
            if self.up_factors[i] > 1:
                self.add_module(f"up_{i}", DepthwiseUpsample(
                    out_channels, self.up_factors[i], up_impl))
            self.add_module(f"node_{i}", DeformConvBlock(
                out_channels, out_channels, **block))

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        for i in range(1, len(layers)):
            x = getattr(self, f"proj_{i}")(layers[i])
            if self.up_factors[i] > 1:
                x = getattr(self, f"up_{i}")(x)
            x = pad_to_match(x, layers[i - 1].shape[-2:])
            layers[i] = getattr(self, f"node_{i}")(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Aggregate the consumed levels down to the finest one."""

    def __init__(self, channels: Sequence[int], up_impl: str = "kernel", **block):
        super().__init__()
        channels = list(channels)
        in_channels = list(channels)
        n = len(channels)
        scales = np.array([2**i for i in range(n)], dtype=int)
        self.n_stages = n - 1
        for i in range(n - 1):
            j = -i - 2
            self.add_module(f"ida_{i}", IDAUpStage(
                channels[j], in_channels[j:], (scales[j:] // scales[j]).tolist(),
                up_impl, **block,
            ))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        out = [layers[-1]]
        layers = list(layers)
        for i in range(self.n_stages):
            j = -i - 2
            layers[j:] = getattr(self, f"ida_{i}")(layers[j:])
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """Trunk + DLAUp + IDAUp + heads; returns the NCHW head outputs.
    ``block`` (``deform``, ``offset_bound``, ``dcn_impl``) reaches every
    IDA conv block."""

    def __init__(self, head_channels: Sequence[int], up_impl: str = "kernel",
                 **block):
        super().__init__()
        self.n_heads = len(head_channels)
        self.base = DLATrunk()
        channels = list(DLA34_CHANNELS[FIRST_LEVEL:])
        self.dla_up = DLAUp(channels, up_impl, **block)
        n_ida = LAST_LEVEL - FIRST_LEVEL
        self.ida_up = IDAUpStage(
            channels[0], channels[:n_ida], [2**i for i in range(n_ida)], up_impl,
            **block,
        )
        for i, n_out in enumerate(head_channels):
            self.add_module(str(i), nn.Sequential(
                nn.Conv2d(channels[0], HEAD_CONV, 3, padding=1),
                nn.ReLU(inplace=True),
                nn.Conv2d(HEAD_CONV, n_out, 1),
            ))

    def forward(self, img) -> List[torch.Tensor]:
        levels = self.base(img)
        dla_up_out = self.dla_up(levels[FIRST_LEVEL:])
        y = self.ida_up(dla_up_out[: LAST_LEVEL - FIRST_LEVEL])
        features = y[-1]
        return [getattr(self, str(i))(features) for i in range(self.n_heads)]


class CenterpointDLA34(nn.Module):
    """Head-order wrapper emitting a ``Prediction`` with NHWC fields.

    Weights are drawn from ``generator`` (the torch default generator
    when None), the heatmap heads' biases start at -2.19, and the module
    is moved to ``device``; call ``.eval()`` to serve.  ``deform`` and
    ``offset_bound`` mean what they mean in the JAX package, whose
    ``dcn_impl="gather"`` the port's DCN matches; ``up_impl`` and
    ``dcn_impl`` pick kernels C and E or their plain versions."""

    def __init__(self, object_config: ObjectConfigSet, up_impl: str = "kernel",
                 generator: Optional[torch.Generator] = None, device=None,
                 deform: bool = False, offset_bound: Optional[float] = None,
                 dcn_impl: str = "kernel"):
        super().__init__()
        self.object_config = object_config
        self.model = DLASeg(get_head_channels(object_config), up_impl=up_impl,
                            deform=deform, offset_bound=offset_bound,
                            dcn_impl=dcn_impl)
        if generator is None:
            generator = torch.default_generator
        init_parameters(self, generator)
        heatmap_heads = (0, 1) if object_config.train_keypoints else (0,)
        with torch.no_grad():
            for i in heatmap_heads:
                getattr(self.model, str(i))[2].bias.fill_(HEATMAP_BIAS)
        if device is not None:
            self.to(device)

    def depthwise_upsamples(self) -> List[DepthwiseUpsample]:
        return [m for m in self.modules() if isinstance(m, DepthwiseUpsample)]

    def deform_convs(self) -> List[DeformConv2d]:
        return [m for m in self.modules() if isinstance(m, DeformConv2d)]

    def forward(self, img: torch.Tensor) -> Prediction:
        """img: [B, 3, H, W] normalised f32."""
        oc = self.object_config
        out = [o.permute(0, 2, 3, 1) for o in self.model(img)]  # NHWC views
        heatmap = out.pop(0)
        keypoint_heatmap = keypoint_affinity = None
        if oc.train_keypoints:
            keypoint_heatmap = out.pop(0)
            aff = out.pop(0)
            b, h, w, _ = aff.shape
            keypoint_affinity = aff.reshape(b, h, w, oc.n_keypoints, 2)
        size = out.pop(0)
        offset = out.pop(0)
        fields = {}
        for name in ("yaw", "pitch", "roll"):
            if getattr(oc, f"train_{name}"):
                fields[f"{name}_bin"] = out.pop(0)
                fields[f"{name}_offset"] = out.pop(0)
        if oc.train_depth:
            fields["depth"] = out.pop(0)
        return Prediction(
            heatmap=heatmap, keypoint_heatmap=keypoint_heatmap,
            keypoint_affinity=keypoint_affinity, size=size, offset=offset,
            **fields,
        )
