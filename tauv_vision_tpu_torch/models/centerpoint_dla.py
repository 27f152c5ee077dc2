"""DLA-34 CenterNet with plain-conv or deformable (DCNv2) IDA.

Counterpart of ``tauv_vision_tpu/models/centerpoint_dla.py``: the DLA-34
trunk, DLAUp / IDAUp aggregation whose 16 conv blocks are plain 3x3 convs
(``deform=False``, the served ``bench.py`` default) or modulated
deformable convs (``deform=True``, the reference's deployed net; kernel
E), the trainable bilinear depthwise upsamples (kernel C), and the heads
(3x3 conv, ReLU, 1x1 conv; the heatmap head's bias starts at -2.19).
NCHW inside; the ``Prediction`` is NHWC.

The JAX package's dtype knobs, with its numerics: ``dtype`` is the convs'
compute dtype (input, weight and bias cast to it, the bias added after
the conv rounds), ``bn_out`` the dtype each BatchNorm rounds its f32
result to, and ``f32_stages`` the stages that run in f32 whatever the
other two say.  Parameters stay f32; a bf16 conv casts its weight once
and keeps the copy (``layers.cast_parameter``).  Joins follow PyTorch's
type promotion, which is jnp's for these dtypes: bf16 + bf16 stays bf16,
bf16 + f32 is f32.

Module and parameter names follow the reference torch layout that
``tauv_vision_tpu.models.centerpoint_dla.load_centerpoint_dla34_state_dict``
reads (``base.base_layer.0``, ``dla_up.ida_{i}.{proj,up,node}_{j}``,
heads ``{idx}.0`` / ``{idx}.2``), so one state dict serves both stacks.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu_torch.configs.centernet import ObjectConfigSet, get_head_channels
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.models.centernet import Prediction
from tauv_vision_tpu_torch.models.layers import (
    Conv2d,
    batch_norm,
    cast_parameter,
    flax_init_parameters,
    init_parameters,
)
from tauv_vision_tpu_torch.ops.conv_transpose import (
    bilinear_kernel,
    depthwise_upsample,
    depthwise_upsample_train,
)
from tauv_vision_tpu_torch.ops.deform_conv import DeformConv2d

DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)
FIRST_LEVEL = 2   # down ratio 4
LAST_LEVEL = 5
HEAD_CONV = 256
HEATMAP_BIAS = -2.19
UP_IMPLS = ("kernel", "plain")
INITS = {"lecun": init_parameters, "flax": flax_init_parameters}
# Stage names of ``f32_stages``: DLATrunk's ("early" is stem, level0 and
# level1) and DLASeg's.
TRUNK_STAGES = ("stem", "level0", "level1", "level2", "level3", "level4", "level5")
F32_STAGES = TRUNK_STAGES + ("early", "dla_up", "ida_up", "heads")


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
    """conv3x3(s)-bn-relu-conv3x3-bn (+ supplied residual) - relu; convs
    in ``dtype``, BatchNorm outputs in ``bn_out``, the residual cast to
    the second BatchNorm's dtype before the join."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype=torch.float32, bn_out=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn1 = batch_norm(planes, bn_out)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn2 = batch_norm(planes, bn_out)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + pad_to_match(residual, out.shape[-2:]).to(out.dtype))


class Root(nn.Module):
    """concat -> 1x1 conv -> bn (+ children[0] if residual) -> relu."""

    def __init__(self, in_channels: int, out_channels: int, residual: bool,
                 dtype=torch.float32, bn_out=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1, bias=False, compute_dtype=dtype)
        self.bn = batch_norm(out_channels, bn_out)
        self.residual = residual

    def forward(self, children: List[torch.Tensor]):
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0].to(x.dtype)
        return F.relu(x)


class Tree(nn.Module):
    """HDA tree; ceil-mode max-pool downsampling."""

    def __init__(self, levels: int, in_channels: int, out_channels: int,
                 stride: int = 1, level_root: bool = False, root_dim: int = 0,
                 root_residual: bool = False, dtype=torch.float32,
                 bn_out=torch.float32):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        dt = dict(dtype=dtype, bn_out=bn_out)
        if levels == 1:
            self.tree1 = BasicBlock(in_channels, out_channels, stride, **dt)
            self.tree2 = BasicBlock(out_channels, out_channels, 1, **dt)
            self.root = Root(root_dim, out_channels, root_residual, **dt)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_dim=0, root_residual=root_residual, **dt)
            self.tree2 = Tree(levels - 1, out_channels, out_channels,
                              root_dim=root_dim + out_channels,
                              root_residual=root_residual, **dt)
        self.project = None
        if in_channels != out_channels:
            self.project = nn.Sequential(
                Conv2d(in_channels, out_channels, 1, bias=False, compute_dtype=dtype),
                batch_norm(out_channels, bn_out),
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


def _conv_level(in_channels: int, out_channels: int, stride: int,
                dtype=torch.float32, bn_out=torch.float32) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(in_channels, out_channels, 3, stride, 1, bias=False, compute_dtype=dtype),
        batch_norm(out_channels, bn_out),
        nn.ReLU(inplace=True),
    )


def check_f32_stages(f32_stages: Sequence[str]) -> Tuple[str, ...]:
    """``f32_stages`` as a tuple; raises on a name the JAX model does not
    know."""
    unknown = sorted(set(f32_stages) - set(F32_STAGES))
    if unknown:
        raise ValueError(f"unknown f32_stages {unknown}; known: {F32_STAGES}")
    return tuple(f32_stages)


def _stage_dtypes(f32: bool, dtype, bn_out) -> dict:
    """A stage's ``dtype`` and ``bn_out``: all f32 for a stage in
    ``f32_stages``, else the model's."""
    if f32:
        return dict(dtype=torch.float32, bn_out=torch.float32)
    return dict(dtype=dtype, bn_out=bn_out)


class DLATrunk(nn.Module):
    """DLA-34 feature trunk returning all six level outputs.

    ``f32_stages`` (a subset of ``TRUNK_STAGES`` and "early", which is
    stem, level0 and level1) runs those stages' convs and BatchNorm
    outputs in f32 whatever ``dtype`` and ``bn_out`` say."""

    def __init__(self, dtype=torch.float32, bn_out=torch.float32,
                 f32_stages: Sequence[str] = ()):
        super().__init__()
        f32_stages = check_f32_stages(f32_stages)

        def dts(stage):
            early = "early" in f32_stages and stage in ("stem", "level0", "level1")
            return _stage_dtypes(stage in f32_stages or early, dtype, bn_out)

        levels, channels = DLA34_LEVELS, DLA34_CHANNELS
        stem = dts("stem")
        self.base_layer = nn.Sequential(
            Conv2d(3, channels[0], 7, 1, 3, bias=False, compute_dtype=stem["dtype"]),
            batch_norm(channels[0], stem["bn_out"]),
            nn.ReLU(inplace=True),
        )
        self.level0 = _conv_level(channels[0], channels[0], 1, **dts("level0"))
        self.level1 = _conv_level(channels[0], channels[1], 2, **dts("level1"))
        for i in (2, 3, 4, 5):
            self.add_module(f"level{i}", Tree(
                levels[i], channels[i - 1], channels[i], 2,
                level_root=(i != 2), **dts(f"level{i}"),
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
    block's option does, ``dcn_max_offset`` is the DCN's window (None:
    unbounded offsets; ``DeformConv2d``), and ``dcn_impl`` picks kernel E
    or the plain version.  Every conv computes in ``dtype`` and
    the BatchNorm rounds to ``bn_out``.  In bf16 the block computes as the
    JAX block (``tauv_vision_tpu/models/centerpoint_dla.py:447-537``): the
    offset and mask convs in bf16 with the bias added after the conv's
    rounding (JAX merges them into one 27-channel conv, bit-identical,
    its comment says), the tanh bound and the sigmoid in bf16 (the
    sigmoid op by op, as XLA expands it), and the
    DCN with x, weight and mask in bf16 and the offsets in f32 (kernel
    E's bf16 entry point).  Under ``flax_init_parameters`` the offset
    and mask convs start at zero, as the JAX block's do.  Inside
    ``sow_dcn_offsets`` the block hands its offsets (after the bound, in
    the convs' dtype) to the collector, as the JAX block sows them into
    "intermediates"."""

    def __init__(self, in_channels: int, out_channels: int, deform: bool = False,
                 offset_bound: Optional[float] = None, dcn_impl: str = "kernel",
                 dtype=torch.float32, bn_out=torch.float32,
                 dcn_max_offset: Optional[float] = None):
        super().__init__()
        self.deform = deform
        self.offset_bound = offset_bound
        self.dtype = dtype
        if deform:
            self.offset = Conv2d(in_channels, 18, 3, padding=1, compute_dtype=dtype)
            self.mask = Conv2d(in_channels, 9, 3, padding=1, compute_dtype=dtype)
            self.offset.zero_init = self.mask.zero_init = True
            self.conv = DeformConv2d(in_channels, out_channels, dcn_impl, dcn_max_offset)
        else:
            self.conv = Conv2d(in_channels, out_channels, 3, padding=1, compute_dtype=dtype)
        self.sow = None
        self.actf = nn.Sequential(batch_norm(out_channels, bn_out), nn.ReLU(inplace=True))

    def modulation(self, offset: torch.Tensor, mask: torch.Tensor):
        """(offsets in f32, mask) of the DCN from the offset and mask
        convs' outputs: the offsets through the tanh bound where one is
        set, the mask through the sigmoid, both in the convs' dtype."""
        if self.offset_bound is not None:
            offset = self.offset_bound * torch.tanh(offset / self.offset_bound)
        if self.sow is not None:
            self.sow(offset)
        if mask.dtype == torch.float32:
            mask = torch.sigmoid(mask)
        else:
            # XLA expands a bf16 logistic into bf16 exp, add and divide,
            # each rounded; torch.sigmoid would round once.
            mask = torch.reciprocal(1.0 + torch.exp(-mask))
        return offset.float(), mask

    def forward(self, x):
        if not self.deform:
            return self.actf(self.conv(x))
        offset, mask = self.modulation(self.offset(x), self.mask(x))
        return self.actf(self.conv(x.to(self.dtype), offset, mask))


@contextlib.contextmanager
def sow_dcn_offsets(model: nn.Module) -> Iterator[List[torch.Tensor]]:
    """A list that collects the offsets of every deformable block of
    ``model`` on each forward inside the ``with``; the blocks stop handing
    them over when it ends."""
    offsets: List[torch.Tensor] = []
    blocks = [m for m in model.modules() if isinstance(m, DeformConvBlock) and m.deform]
    for block in blocks:
        block.sow = offsets.append
    try:
        yield offsets
    finally:
        for block in blocks:
            block.sow = None


class DepthwiseUpsample(nn.Module):
    """groups=C ConvTranspose(kernel 2f, stride f, padding f//2, no bias),
    initialised to bilinear interpolation and trainable.

    ``impl="kernel"`` runs ``depthwise_upsample_train`` (kernel C on a CUDA
    tensor, the plain version on a CPU one, gradients by the plain
    version); ``impl="plain"`` always runs the plain version, for
    comparisons on the card.  It computes in
    ``dtype`` (f32 or bf16) with the weight cast to it, as the JAX
    module's dilated lowering does."""

    def __init__(self, channels: int, factor: int, impl: str = "kernel",
                 dtype=torch.float32):
        super().__init__()
        if impl not in UP_IMPLS:
            raise ValueError(f"impl must be one of {UP_IMPLS}, got {impl!r}")
        self.factor = factor
        self.impl = impl
        self.dtype = dtype
        k = 2 * factor
        self.weight = nn.Parameter(torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(bilinear_kernel(k), (channels, 1, k, k))
        )))

    def forward(self, x):
        fn = depthwise_upsample_train if self.impl == "kernel" else depthwise_upsample
        return fn(x.to(self.dtype), cast_parameter(self, "weight", self.dtype), self.factor)


class IDAUpStage(nn.Module):
    """One IDAUp: for i in 1..n-1,
    layers[i] = node(up(proj(layers[i])) + layers[i-1])."""

    def __init__(self, out_channels: int, in_channels: Sequence[int],
                 up_factors: Sequence[int], up_impl: str = "kernel",
                 dtype=torch.float32, bn_out=torch.float32, **block):
        super().__init__()
        self.up_factors = [int(f) for f in up_factors]
        block = dict(block, dtype=dtype, bn_out=bn_out)
        for i in range(1, len(in_channels)):
            self.add_module(f"proj_{i}", DeformConvBlock(
                in_channels[i], out_channels, **block))
            if self.up_factors[i] > 1:
                self.add_module(f"up_{i}", DepthwiseUpsample(
                    out_channels, self.up_factors[i], up_impl, dtype))
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
    """Trunk + DLAUp + IDAUp + heads; returns the NCHW head outputs in
    f32.  ``block`` (``deform``, ``offset_bound``, ``dcn_max_offset``,
    ``dcn_impl``) reaches
    every IDA conv block.  ``f32_stages`` may also name "dla_up",
    "ida_up" and "heads", which then run in f32."""

    def __init__(self, head_channels: Sequence[int], up_impl: str = "kernel",
                 dtype=torch.float32, bn_out=torch.float32,
                 f32_stages: Sequence[str] = (), **block):
        super().__init__()
        f32_stages = check_f32_stages(f32_stages)

        def dts(stage):
            return _stage_dtypes(stage in f32_stages, dtype, bn_out)

        self.n_heads = len(head_channels)
        self.base = DLATrunk(dtype, bn_out, f32_stages)
        channels = list(DLA34_CHANNELS[FIRST_LEVEL:])
        self.dla_up = DLAUp(channels, up_impl, **block, **dts("dla_up"))
        n_ida = LAST_LEVEL - FIRST_LEVEL
        self.ida_up = IDAUpStage(
            channels[0], channels[:n_ida], [2**i for i in range(n_ida)], up_impl,
            **block, **dts("ida_up"),
        )
        heads = dts("heads")["dtype"]
        for i, n_out in enumerate(head_channels):
            self.add_module(str(i), nn.Sequential(
                Conv2d(channels[0], HEAD_CONV, 3, padding=1, compute_dtype=heads),
                nn.ReLU(inplace=True),
                Conv2d(HEAD_CONV, n_out, 1, compute_dtype=heads),
            ))

    def forward(self, img) -> List[torch.Tensor]:
        levels = self.base(img)
        dla_up_out = self.dla_up(levels[FIRST_LEVEL:])
        y = self.ida_up(dla_up_out[: LAST_LEVEL - FIRST_LEVEL])
        features = y[-1]
        return [getattr(self, str(i))(features).to(torch.float32)
                for i in range(self.n_heads)]


class CenterpointDLA34(nn.Module):
    """Head-order wrapper emitting a ``Prediction`` with NHWC fields.

    Weights are drawn from ``generator`` (the torch default generator
    when None): ``init="lecun"`` draws every conv LeCun normal, the DCN
    offset convs included (``layers.init_parameters``: the served paths'
    seeded weights, whose offsets reach a few cells), ``init="flax"`` by
    the JAX package's initialisers (``layers.flax_init_parameters``: the
    offset and mask convs at zero), as training starts.  The heatmap
    heads' biases start at -2.19, and the module
    is moved to ``device`` (the card unless the caller passes "cpu"); call
    ``.eval()`` to serve.  ``deform``, ``offset_bound``,
    ``dcn_max_offset``, ``dtype``, ``bn_out`` and ``f32_stages`` mean what
    they mean in the JAX package: with ``dcn_max_offset`` None the port's
    f32 DCN is JAX's ``dcn_impl="gather"``, with R set its
    ``dcn_impl="shift"`` (the JAX default, R = 3), and in bf16 it rounds
    as the Pallas kernel does; ``up_impl`` and
    ``dcn_impl`` pick kernels C and E or their plain versions.  The served
    recipe is ``configs.NORTH_STAR``."""

    def __init__(self, object_config: ObjectConfigSet, up_impl: str = "kernel",
                 generator: Optional[torch.Generator] = None,
                 device=DEFAULT_DEVICE,
                 deform: bool = False, offset_bound: Optional[float] = None,
                 dcn_impl: str = "kernel", dtype=torch.float32,
                 bn_out=torch.float32, f32_stages: Sequence[str] = (), init: str = "lecun",
                 dcn_max_offset: Optional[float] = None):
        super().__init__()
        if init not in INITS:
            raise ValueError(f"init must be one of {sorted(INITS)}, got {init!r}")
        device = resolve_device(device)
        self.object_config = object_config
        self.model = DLASeg(get_head_channels(object_config), up_impl=up_impl,
                            deform=deform, offset_bound=offset_bound,
                            dcn_max_offset=dcn_max_offset, dcn_impl=dcn_impl,
                            dtype=dtype, bn_out=bn_out,
                            f32_stages=f32_stages)
        if generator is None:
            generator = torch.default_generator
        INITS[init](self, generator)
        heatmap_heads = (0, 1) if object_config.train_keypoints else (0,)
        with torch.no_grad():
            for i in heatmap_heads:
                getattr(self.model, str(i))[2].bias.fill_(HEATMAP_BIAS)
        self.to(device)

    def depthwise_upsamples(self) -> List[DepthwiseUpsample]:
        return [m for m in self.modules() if isinstance(m, DepthwiseUpsample)]

    def deform_convs(self) -> List[DeformConv2d]:
        return [m for m in self.modules() if isinstance(m, DeformConv2d)]

    def forward(self, img: torch.Tensor) -> Prediction:
        """img: [B, 3, H, W] normalised, f32 (the stem casts it to its
        dtype); the fields are f32."""
        return prediction_from_heads(self.object_config,
                                     [o.permute(0, 2, 3, 1) for o in self.model(img)])


def prediction_from_heads(object_config: ObjectConfigSet,
                          heads: Sequence[torch.Tensor]) -> Prediction:
    """The ``Prediction`` of the heads' NHWC outputs, in the order of
    ``get_head_channels`` (the JAX ``CenterpointDLA34``'s unpacking)."""
    oc = object_config
    out = list(heads)
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
