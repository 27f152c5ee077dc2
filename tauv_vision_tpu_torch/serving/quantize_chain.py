"""The chain-fused int8 forwards of the YOLACT, the DLA-34 CenterNet and
YOLO-Pose (counterpart of ``tauv_vision_tpu/serving/quantize_chain.py``).

Activations stay int8 from conv to conv: each calibrated conv runs as an
int8 x int8 -> int32 convolution (``ops/int8_conv.py``), and its epilogue
(dequant, bias, folded BatchNorm, relu / leaky-relu, requant to the NEXT
conv's calibrated input scale) emits int8 when that next conv is
calibrated.  Uncalibrated convs run in the context's float ``dtype``;
residual joins, feature taps and BatchNorm outputs keep the flax forward's
dtype flow (f32, or ``join_dtype``).  With the protonet upsamples'
scales supplied, the two transposed convs run int8 in and out through
kernel D (``ops/transpose_conv.py``).  One ``impl`` picks the kernels or
their plain versions for the whole request: kernel D here and the
decode kernels of ``make_yolact_pipeline``.

Activations are NHWC, as in the JAX chain, so that four int8 channels
share one 32-bit word for the kernels and the tests compare without
transposes; the float convs run ``F.conv2d`` on the NCHW views.

The chain reads the port's ``Yolact``, ``CenterpointDLA34`` or ``YoloPose``
module; its parameters and scales are found by the JAX module path
(``weights.yolact_flax_path``, ``weights.centerpoint_flax_path``,
``weights.yolo_pose_flax_path``).  The
quantized weights, folded BatchNorm affines and float weights are
computed at first use and kept, so the module's weights must not change
while a context serves.

The CenterNet chain (``dla34_chain_forward``) keeps the JAX chain's
dataflow: every calibrated conv int8 (the BasicBlocks' conv1 -> conv2
and the heads' conv -> out links int8 in and out), the 3-channel stem
float, BatchNorm outputs and joins f32 (or ``join_dtype``), the depthwise
upsamples in ``dtype`` through kernel C, and with DCN IDA the 16 blocks
in ``dtype``: the offset and mask convs merged into one 27-channel conv
as the JAX block serves them, then kernel E.  Two places differ from the
JAX chain on purpose: the IDA size matcher is the reference's
(``models.centerpoint_dla.pad_to_match``, which shifts an overshooting
branch down and right by half the overshoot), where the JAX chain imports
the symmetric ``models.dla.pad_to_match``; and a tree of depth 2 runs no
projection of its own input, which the JAX chain computes and discards.

The YOLO-Pose chain (``yolo_pose_chain_forward``) is the YOLACT's
ResNet-18, FPN and protonet chains (the protonet's transposed convs in
``dtype``: the JAX YOLO-Pose chain takes no int8 transpose), the Pointnet
cascade on FPN level 1 with every conv -> leaky -> conv link of a stage
int8, each stage's output f32 and a later stage's input the (belief,
affinity, FPN level 1) concatenation in ``dtype``, and the shared head's
five output convs, with f32 joins (``join_dtype=None``) as the JAX chain
keeps them.

Rounding: every epilogue op here is one PyTorch op that rounds once, as
the JAX chain's ops do when run one by one, so that a layer's int8 codes
equal the JAX ``run_layer``'s on the same int8 input.  Compiled, XLA
also contracts multiply-adds into fused ones, so the compiled JAX chain
differs from both in the last bit of some floats; kernel D's epilogue is
the one fused multiply-add of the Pallas kernel
(``ops/transpose_conv.py``).  PyTorch's CPU ``sqrt`` is not always
correctly rounded, so the BatchNorm folds take an f64 root.

``ChainCtx(gains=, corrections=)`` scale and shift a calibrated conv's
dequantized accumulator per output channel before its bias and
BatchNorm, as the JAX chain does (``refine_scales_mse``'s scales,
``calibrate_bias_correction``'s corrections and ``calibrate_sequential``'s
fits feed ``configs.PARITY_INT8``); on the card they are two elementwise
passes more, where XLA folds them into the epilogue.

Not ported here: asymmetric ranges (``calibrate_range``), ``wq_override``
(``calibrate_gptq``), ``f32_paths``, ``calibrate_sequential(mode="mean")``
(only ``scripts/quantize_accuracy_check.py`` reaches these), and the
YOLO-Pose pipeline's ``split_pnp`` (a dispatch split that fences a TPU
runtime fault; the port runs PnP after the decode in any case).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu_torch.configs import BENCH_YOLO_POSE, CHAIN_INT8, KEYPOINTS, NORTH_STAR
from tauv_vision_tpu_torch.configs.centernet import CenternetModelConfig, get_head_channels
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE
from tauv_vision_tpu_torch.models.centernet import Prediction
from tauv_vision_tpu_torch.models.centerpoint_dla import (
    DLA34_CHANNELS,
    DLA34_LEVELS,
    FIRST_LEVEL,
    LAST_LEVEL,
    CenterpointDLA34,
    DeformConvBlock,
    DepthwiseUpsample,
    pad_to_match,
    prediction_from_heads,
)
from tauv_vision_tpu_torch.models.yolact import Yolact, YolactPrediction
from tauv_vision_tpu_torch.models.yolo_pose import HEAD_OUTPUTS, YoloPose, YoloPosePrediction
from tauv_vision_tpu_torch.ops.conv_transpose import depthwise_upsample, depthwise_upsample_cuda
from tauv_vision_tpu_torch.ops.image import resize_bilinear_nhwc
from tauv_vision_tpu_torch.ops.int8_conv import conv2d_int8
from tauv_vision_tpu_torch.ops.transpose_conv import (
    kernel_taps,
    transpose_conv2x_int8,
    transpose_conv2x_int8_cuda,
)
from tauv_vision_tpu_torch.params import cast_parameter
from tauv_vision_tpu_torch.serving.pipeline import (
    SERVING_DECODE,
    YOLO_POSE_DECODE,
    DecodeKnobs,
    YoloPoseKnobs,
    make_centernet_keypoint_pipeline,
    make_centernet_pipeline,
    make_yolact_pipeline,
    make_yolo_pose_pipeline,
)
from tauv_vision_tpu_torch.weights import (
    centerpoint_flax_path,
    yolact_flax_path,
    yolo_pose_flax_path,
)

BN_EPS = 1e-5
IMPLS = ("kernel", "plain")


# ---------------------------------------------------------------- helpers


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _is_per_channel(scale) -> bool:
    return getattr(scale, "ndim", 0) >= 1


def _wq(kernel: torch.Tensor, in_scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 weight quantization of an HWIO
    kernel; a per-input-channel activation scale ``in_scale`` is folded
    into the kernel first, so the accumulator dequantizes with the weight
    scale alone."""
    kernel = kernel.to(torch.float32)
    if in_scale is not None:
        s = torch.as_tensor(in_scale, dtype=torch.float32, device=kernel.device)
        kernel = kernel * s.reshape((1,) * (kernel.dim() - 2) + (-1, 1))
    absmax = kernel.reshape(-1, kernel.shape[-1]).abs().amax(dim=0)
    scale = torch.clamp_min(absmax, 1e-6) / 127.0
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_weights(kernel: torch.Tensor, act_scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """(qk int8 HWIO, deq [O] f32) of a calibrated conv's HWIO kernel: with
    a per-channel activation scale folded into the kernel, deq is the
    weight scale; else activation scale x weight scale."""
    if _is_per_channel(act_scale):
        return _wq(kernel, in_scale=act_scale)
    qk, w_scale = _wq(kernel)
    return qk, torch.as_tensor(act_scale, dtype=torch.float32, device=kernel.device) * w_scale


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization; ``scale`` is a scalar or a
    per-channel vector broadcast over the trailing (channel) axis."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (PyTorch's CPU ``sqrt`` is not
    always; the f64 root rounded to f32 is)."""
    return torch.sqrt(x.double()).float()


def _bn_affine(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as y = g * x + b (per channel, f32)."""
    g = bn.weight.float() / _sqrt(bn.running_var.float() + BN_EPS)
    return g, bn.bias.float() - bn.running_mean.float() * g


def _leaky(y: torch.Tensor) -> torch.Tensor:
    """Leaky relu, slope 0.01 (the reference default).  The slope is cast
    to ``y``'s dtype first, as JAX casts a Python scalar: in bf16 the
    slope is bf16(0.01), not 0.01."""
    slope = torch.tensor(0.01, dtype=y.dtype, device=y.device)
    return torch.where(y >= 0, y, y * slope)


def _hwio(m: nn.Module) -> torch.Tensor:
    """The JAX package's HWIO kernel of a conv or a transposed conv."""
    if isinstance(m, nn.ConvTranspose2d):
        return m.weight.permute(2, 3, 0, 1)   # [Cin, Cout, kh, kw], no flip
    return m.weight.permute(2, 3, 1, 0)       # [O, I, kh, kw]


# The modules a chain reads by JAX path.
CHAIN_MODULES = (nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d, DepthwiseUpsample,
                 DeformConvBlock)


class ChainCtx:
    """A module's parameters plus calibration scales for a chain-fused
    forward: a ``Yolact`` (``path_of=weights.yolact_flax_path``, the
    default), a ``CenterpointDLA34`` (``weights.centerpoint_flax_path``) or
    a ``YoloPose`` (``weights.yolo_pose_flax_path``).

    ``scales`` values are floats (per tensor) or per-input-channel
    vectors (``calibrate(per_channel=True)``).  A transposed conv with a
    scale (``calibrate`` records none; the caller adds the protonet
    upsamples') runs int8 through kernel D with ``impl="kernel"``, through
    its plain version with ``"plain"``; without one it runs in ``dtype``.
    ``join_dtype`` rounds residual joins and feature taps (None keeps the
    flax flow's f32).  ``impl`` picks kernels C, D and E or their plain
    versions.  The defaults are the served YOLACT recipe
    (``configs.NORTH_STAR.yolact``)."""

    def __init__(self, model: nn.Module, scales: Dict[str, object],
                 dtype=NORTH_STAR.yolact.dtype, join_dtype=NORTH_STAR.yolact.join_dtype,
                 impl: str = "kernel", path_of: Callable[[str], str] = yolact_flax_path,
                 gains: Optional[Dict[str, object]] = None,
                 corrections: Optional[Dict[str, object]] = None):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.model = model
        self.modules = {
            path_of(name): m for name, m in model.named_modules() if isinstance(m, CHAIN_MODULES)
        }
        self.device = next(model.parameters()).device
        self.scales = dict(scales)
        self.dtype = dtype
        self.join_dtype = join_dtype
        self.impl = impl
        self.gains = dict(gains or {})
        self.corrections = dict(corrections or {})
        # ``hook(path, y, quantized)``, when set, sees every conv's pre-bias
        # output (not the transposed convs') and returns what the layer
        # goes on with: ``calibrate_sequential``'s passes.
        self.hook: Optional[Callable[[str, torch.Tensor, bool], torch.Tensor]] = None
        self._cache: Dict[tuple, object] = {}

    def _memo(self, key, make):
        if key not in self._cache:
            with torch.no_grad():
                self._cache[key] = make()
        return self._cache[key]

    def join(self, x: torch.Tensor) -> torch.Tensor:
        """Round a cross-layer join tensor to ``join_dtype``."""
        return x if self.join_dtype is None else x.to(self.join_dtype)

    def s(self, path: str) -> torch.Tensor:
        """The activation scale of ``path`` as an f32 tensor on the device."""
        return self._memo(("scale", path), lambda: torch.as_tensor(
            self.scales[path], dtype=torch.float32, device=self.device))

    def bn(self, path: str) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._memo(("bn", path), lambda: _bn_affine(self.modules[path]))

    def bn_exact(self, y: torch.Tensor, path: str) -> torch.Tensor:
        """Inference BatchNorm with flax's op order and dtypes: promote to
        f32, y = (x - mean) * (rsqrt(var + eps) * scale) + bias."""
        bn = self.modules[path]

        def make():
            mul = (1.0 / _sqrt(bn.running_var.float() + BN_EPS)) * bn.weight.float()
            return bn.running_mean.float(), mul, bn.bias.float()

        mean, mul, bias = self._memo(("bn_exact", path), make)
        return (y.to(torch.float32) - mean) * mul + bias

    def int8_weights(self, path: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(qk int8 HWIO, deq [O] f32) of a calibrated conv
        (``_int8_weights``)."""
        return self._memo(("int8", path), lambda: _int8_weights(
            _hwio(self.modules[path]).detach(), self.scales[path]))

    def transpose_args(self, path: str, next_path: Optional[str]):
        """Kernel D's weights of a calibrated transposed conv: (qk, deq,
        bias, out scale) as contiguous device tensors, with the kernel's
        tap words (None for the plain version).  The out scale is
        ``next_path``'s when that layer is calibrated (int8 out), else 1."""
        def make():
            qk, deq = self.int8_weights(path)
            if path in self.gains:
                deq = deq * self.vector("gains", path)
            bias = self.modules[path].bias
            bias = torch.zeros_like(deq) if bias is None else bias.detach().float().contiguous()
            if path in self.corrections:
                bias = bias + self.vector("corrections", path)
            emit_int8 = next_path is not None and next_path in self.scales
            out_scale = (self.s(next_path) if emit_int8 else torch.ones_like(deq))
            taps = kernel_taps(qk) if self.impl == "kernel" else None
            return qk, deq, bias, out_scale.expand_as(deq).contiguous(), taps
        return self._memo(("transpose", path, next_path), make)

    def vector(self, kind: str, path: str) -> torch.Tensor:
        """A path's gain or correction (``kind`` "gains" or "corrections")
        as an f32 tensor on the device."""
        return self._memo((kind, path), lambda: torch.tensor(
            np.asarray(getattr(self, kind)[path]), dtype=torch.float32, device=self.device))

    def float_weight(self, path: str) -> torch.Tensor:
        """The conv's weight in the context's float dtype."""
        return self._memo(("float", path), lambda: self.modules[path].weight.detach().to(self.dtype))

    def run_layer(self, inp: torch.Tensor, path: str, *, strides=(1, 1), padding=1,
                  transpose: bool = False, bn_path: Optional[str] = None,
                  act: Optional[str] = None, next_path: Optional[str] = None) -> torch.Tensor:
        """One conv (or k3s2 transposed conv) + fused epilogue, NHWC.

        Runs int8 when the layer is calibrated and the float dtype
        otherwise; emits int8 in ``next_path``'s scale when that layer is
        calibrated, else float: BatchNorm outputs f32, conv(+bias)
        outputs ``dtype`` (the flax forward's flow)."""
        m = self.modules[path]
        bias = None if m.bias is None else m.bias.detach().float()

        quantized = False
        if (
            transpose
            and path in self.scales
            and tuple(m.kernel_size) == (3, 3)
            and bn_path is None
            and act in (None, "leaky", "relu")
        ):
            q = inp if inp.dtype == torch.int8 else _quant(inp, self.s(path))
            qk, deq, bias_eff, out_scale, taps = self.transpose_args(path, next_path)
            out_dtype = torch.int8 if next_path is not None and next_path in self.scales else self.dtype
            if self.impl == "kernel":
                return transpose_conv2x_int8_cuda(q, qk, deq, bias_eff, out_scale, act=act or "none",
                                                  out_dtype=out_dtype, taps=taps)
            return transpose_conv2x_int8(q, qk, deq, bias_eff, out_scale, act=act or "none",
                                         out_dtype=out_dtype)
        if transpose:
            if inp.dtype == torch.int8:
                xf = inp.to(torch.float32) * self.s(path)
            else:
                xf = inp
            y = _nhwc(F.conv_transpose2d(
                _nchw(xf.to(self.dtype)), self.float_weight(path), stride=m.stride, padding=m.padding,
                output_padding=m.output_padding))
        elif path in self.scales:
            quantized = True
            q = inp if inp.dtype == torch.int8 else _quant(inp, self.s(path))
            qk, deq = self.int8_weights(path)
            acc = conv2d_int8(q, qk, tuple(strides), padding)
            y = acc.to(torch.float32) * deq
            if path in self.gains:
                y = y * self.vector("gains", path)
            if path in self.corrections:
                y = y + self.vector("corrections", path)
        else:
            if inp.dtype == torch.int8:
                raise ValueError(f"producer emitted int8 but {path} is uncalibrated")
            y = _nhwc(F.conv2d(_nchw(inp.to(self.dtype)), self.float_weight(path),
                               stride=tuple(strides), padding=padding))
        if self.hook is not None and not transpose:
            y = self.hook(path, y, quantized)

        if bias is not None:
            # int8: an f32 add on the dequantized accumulator; float: flax
            # Conv adds its bias in the conv dtype.
            y = y + (bias if quantized else bias.to(y.dtype))
        if bn_path is not None:
            if quantized:
                g, b = self.bn(bn_path)
                y = y * g + b
            else:
                y = self.bn_exact(y, bn_path)
        if act == "relu":
            y = torch.clamp_min(y, 0)
        elif act == "leaky":
            y = _leaky(y)
        if next_path is not None and next_path in self.scales:
            return _quant(y, self.s(next_path))
        if quantized and bn_path is None:
            return y.to(self.dtype)
        return y


class _Capture:
    """Pass A of ``calibrate_sequential``: keeps the first float pre-bias
    output of each of ``paths`` in ``captured``."""

    def __init__(self, paths):
        self.paths = set(paths)
        self.captured: Dict[str, torch.Tensor] = {}

    def __call__(self, path: str, y: torch.Tensor, quantized: bool) -> torch.Tensor:
        if not quantized and path in self.paths and path not in self.captured:
            self.captured[path] = y.to(torch.float32)
        return y


class _Fit:
    """Pass B of ``calibrate_sequential``: at the first call of each path of
    ``targets`` (pass A's captures), the per-channel affine a * y + b of
    least squared error from the dequantized accumulator y to the captured
    float map, a clipped to [0.5, 2] (1 where y is flat), every op in f32
    as the JAX fit; at every call of the path, the fit applied."""

    def __init__(self, targets: Dict[str, torch.Tensor]):
        self.targets = targets
        self.gains: Dict[str, np.ndarray] = {}
        self.corrections: Dict[str, np.ndarray] = {}

    def __call__(self, path: str, y: torch.Tensor, quantized: bool) -> torch.Tensor:
        if not quantized or path not in self.targets:
            return y
        if path not in self.gains:
            yf = self.targets[path]
            mq = y.mean(dim=(0, 1, 2))
            mf = yf.mean(dim=(0, 1, 2))
            var = torch.square(y - mq).mean(dim=(0, 1, 2))
            cov = ((y - mq) * (yf - mf)).mean(dim=(0, 1, 2))
            a = torch.where(var > 1e-10, cov / torch.clamp_min(var, 1e-10),
                            torch.ones_like(var))
            a = torch.clamp(a, 0.5, 2.0)
            self.gains[path] = a.cpu().numpy()
            self.corrections[path] = (mf - a * mq).cpu().numpy()
        y = y * torch.as_tensor(self.gains[path], device=y.device)
        return y + torch.as_tensor(self.corrections[path], device=y.device)


def calibrate_sequential(build_forward: Callable[[ChainCtx], Callable], model: nn.Module,
                         scales: Dict[str, object], batch, *,
                         dtype=torch.bfloat16, path_of: Callable[[str], str] = yolact_flax_path,
                         impl: str = "kernel") -> Tuple[Dict[str, np.ndarray],
                                                        Dict[str, np.ndarray]]:
    """(gains, corrections) of the JAX ``calibrate_sequential``: two passes
    of one chain forward over one batch.  Pass A runs the chain float
    (no scales) and keeps each calibrated path's pre-bias conv output
    (``_Capture``); pass B runs it int8 and fits, per path and output
    channel, the affine ``a * y + b`` of least squared error from the
    dequantized accumulator as it arrives (every earlier fit applied) to
    that output, then applies it (``_Fit``).  ``build_forward(ctx)``
    returns ``fn(batch)``, the chain forward on ``ctx`` with its
    preprocessing (``dla34_chain_forward`` or ``yolact_chain_forward``).
    Each pass has a context of its own, with f32 joins, as the JAX passes.
    The CenterNet chain runs no projection of a depth-2 tree's own input,
    so the two paths the JAX chain fits there and discards
    (``model/base/level3/project_conv``, ``level4``) get no fit."""
    ctx_a = ChainCtx(model, {}, dtype=dtype, join_dtype=None, impl=impl, path_of=path_of)
    ctx_a.hook = _Capture(scales)
    build_forward(ctx_a)(batch)

    ctx_b = ChainCtx(model, scales, dtype=dtype, join_dtype=None, impl=impl, path_of=path_of)
    ctx_b.hook = fit = _Fit(ctx_a.hook.captured)
    build_forward(ctx_b)(batch)
    return fit.gains, fit.corrections


# ------------------------------------------------------- ResNet-18 chain


def _basic_block(ctx: ChainCtx, x, prefix: str, stride: int, downsample: bool):
    """BasicBlock with the conv1 -> conv2 link in int8; returns (out,
    pre-residual tap)."""
    q1 = ctx.run_layer(x, f"{prefix}/conv1", strides=(stride, stride), padding=1,
                       bn_path=f"{prefix}/bn1", act="relu", next_path=f"{prefix}/conv2")
    pre_residual = ctx.join(ctx.run_layer(q1, f"{prefix}/conv2", padding=1,
                                          bn_path=f"{prefix}/bn2"))
    if downsample:
        identity = ctx.join(ctx.run_layer(
            x, f"{prefix}/downsample_conv", strides=(stride, stride), padding=0,
            bn_path=f"{prefix}/downsample_bn"))
    else:
        identity = x
    out = torch.clamp_min(pre_residual + identity.to(pre_residual.dtype), 0)
    return out, pre_residual


def resnet18_chain(ctx: ChainCtx, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The ResNet-18 trunk; the 3-channel stem stays float (it falls
    below calibration's ``MIN_IN_CHANNELS``)."""
    x = ctx.run_layer(img, "backbone/conv1", strides=(2, 2), padding=3,
                      bn_path="backbone/bn1", act="relu")
    x = _nhwc(F.max_pool2d(_nchw(x), 3, 2, 1))
    taps = []
    plan = [(1, False), (2, True), (2, True), (2, True)]
    for layer_i, (stride, downsample) in enumerate(plan, start=1):
        x, _ = _basic_block(ctx, x, f"backbone/layer{layer_i}_0", stride, downsample)
        x, tap = _basic_block(ctx, x, f"backbone/layer{layer_i}_1", 1, False)
        if layer_i >= 2:
            taps.append(tap if ctx.join_dtype is not None else tap.to(torch.float32))
    return tuple(taps)


# ------------------------------------------------------------- FPN chain


def fpn_chain(ctx: ChainCtx, backbone_outputs, n_downsample: int):
    """The feature pyramid; the top-down bilinear-resize sum stays float."""
    n_in = len(backbone_outputs)
    laterals = [ctx.run_layer(backbone_outputs[i], f"fpn/lateral_{i}", padding=0)
                for i in range(n_in)]
    pyramid = [None] * n_in
    pyramid[-1] = laterals[-1]
    for i in range(n_in - 2, -1, -1):
        above = resize_bilinear_nhwc(pyramid[i + 1], laterals[i].shape[1:3])
        pyramid[i] = laterals[i] + above.to(laterals[i].dtype)
    outputs = [ctx.run_layer(pyramid[i], f"fpn/prediction_{i}", padding=1, act="leaky")
               for i in range(n_in)]
    for i in range(n_downsample):
        outputs.append(ctx.run_layer(outputs[-1], f"fpn/downsample_{i}", strides=(2, 2),
                                     padding=1, act="leaky"))
    return outputs


# -------------------------------------------------------- protonet chain


def protonet_chain(ctx: ChainCtx, fpn0, n_pre: int, n_post: int) -> torch.Tensor:
    """The protonet: every conv -> leaky -> conv(T) link stays int8 where
    both ends are calibrated.  Returns f32 NHWC prototypes."""
    chain = ([f"protonet/pre_{i}" for i in range(n_pre)] + ["protonet/upsample_1"]
             + [f"protonet/mid_{i}" for i in range(n_post)] + ["protonet/upsample_2"]
             + [f"protonet/post_{i}" for i in range(n_post)] + ["protonet/output"])
    x = fpn0
    for i, path in enumerate(chain):
        x = ctx.run_layer(x, path, transpose="upsample" in path,
                          padding=0 if path.endswith("output") else 1, act="leaky",
                          next_path=chain[i + 1] if i + 1 < len(chain) else None)
    return x.to(torch.float32)


# ------------------------------------------------- prediction head chain


def _extra_stage(ctx: ChainCtx, x, prefix: str):
    """relu(conv1x1(x) + bn(bottleneck(x))), the bottleneck convs chained
    in int8 where calibrated."""
    bp = f"{prefix}/bottleneck"
    q = ctx.run_layer(x, f"{bp}/conv1", padding=0, bn_path=f"{bp}/bn1", act="relu",
                      next_path=f"{bp}/conv2")
    q = ctx.run_layer(q, f"{bp}/conv2", padding=1, bn_path=f"{bp}/bn2", act="relu",
                      next_path=f"{bp}/conv3")
    pre = ctx.run_layer(q, f"{bp}/conv3", padding=0, bn_path=f"{bp}/bn3")
    bottleneck = torch.clamp_min(pre + x.to(torch.float32), 0.0)
    bn_out = ctx.bn_exact(bottleneck, f"{prefix}/bn")
    conv_out = ctx.run_layer(x, f"{prefix}/conv", padding=0)
    return torch.clamp_min(conv_out.to(torch.float32) + bn_out, 0.0)


def prediction_head_chain(ctx: ChainCtx, fpn_output, *, n_classes: int,
                          n_prototype_masks: int, n_shared: int, n_cls: int,
                          n_box: int, n_mask: int):
    """The shared prediction head on one FPN level."""
    x = fpn_output
    for i in range(n_shared):
        x = _extra_stage(ctx, x, f"prediction_head/shared_{i}")

    def branch(x, stages, stage_fmt, out_path):
        for i in range(stages):
            x = _extra_stage(ctx, x, stage_fmt.format(i))
        return ctx.run_layer(x, out_path, padding=1)

    b = fpn_output.shape[0]
    classification = branch(x, n_cls, "prediction_head/cls_{}",
                            "prediction_head/classification").reshape(b, -1, n_classes + 1)
    box = branch(x, n_box, "prediction_head/box_{}", "prediction_head/box").reshape(b, -1, 4)
    mask = torch.tanh(branch(x, n_mask, "prediction_head/mask_{}", "prediction_head/mask")
                      .reshape(b, -1, n_prototype_masks)).to(torch.float32)
    return classification.to(torch.float32), box.to(torch.float32), mask


# ------------------------------------------------------ YOLACT assembly


def yolact_chain_forward(ctx: ChainCtx) -> Callable[[torch.Tensor], YolactPrediction]:
    """``fn(img) -> YolactPrediction`` running the chain-int8 YOLACT
    forward of ``ctx``'s model; ``img`` is the normalised NCHW f32 image
    the model itself takes, cast to ``ctx.dtype`` inside."""
    model = ctx.model
    cfg = model.config

    def forward(img: torch.Tensor) -> YolactPrediction:
        with torch.inference_mode():
            taps = resnet18_chain(ctx, _nhwc(img.to(ctx.dtype)))
            fpn_outputs = fpn_chain(ctx, taps, cfg.n_fpn_downsample_layers)
            proto = protonet_chain(ctx, fpn_outputs[0], cfg.n_masknet_layers_pre_upsample,
                                   cfg.n_masknet_layers_post_upsample)
            heads = [prediction_head_chain(
                ctx, f, n_classes=cfg.n_classes, n_prototype_masks=cfg.n_prototype_masks,
                n_shared=cfg.n_prediction_head_layers, n_cls=cfg.n_classification_layers,
                n_box=cfg.n_box_layers, n_mask=cfg.n_mask_layers) for f in fpn_outputs]
            classification, box, coeff = (torch.cat(t, dim=1) for t in zip(*heads))
        return YolactPrediction(classification=classification, box_encoding=box,
                                mask_coeff=coeff, anchor=model.anchor, mask_prototype=proto)

    return forward


def make_yolact_chain_pipeline(model: Yolact, scales: Dict[str, object],
                               device=DEFAULT_DEVICE, knobs: DecodeKnobs = SERVING_DECODE,
                               *, dtype=NORTH_STAR.yolact.dtype,
                               join_dtype=NORTH_STAR.yolact.join_dtype,
                               impl: str = "kernel", gains=None, corrections=None):
    """uint8 frames -> ``YolactDetections`` through the chain-int8
    forward (``make_yolact_pipeline`` with the chain in place of the
    model).  The defaults serve the recipe of ``ChainCtx``; ``impl``
    picks kernel D and the decode kernels, or their plain versions;
    ``gains`` and ``corrections`` are ``ChainCtx``'s."""
    ctx = ChainCtx(model, scales, dtype=dtype, join_dtype=join_dtype, impl=impl, gains=gains,
                   corrections=corrections)
    return make_yolact_pipeline(yolact_chain_forward(ctx), model.config, device, knobs,
                                impl=impl, dtype=dtype)


# ---------------------------------------------- CenterNet DLA-34 chain


def _match(x: torch.Tensor, target_hw) -> torch.Tensor:
    """The reference's ``pad_to_match`` on an NHWC map."""
    if tuple(x.shape[1:3]) == tuple(target_hw):
        return x
    return _nhwc(pad_to_match(_nchw(x), target_hw))


def _nchw_contiguous(x: torch.Tensor, dtype) -> torch.Tensor:
    """An NHWC map as a contiguous NCHW tensor in ``dtype`` (one copy), the
    layout kernels C and E take."""
    return _nchw(x).to(dtype, memory_format=torch.contiguous_format)


def _dla_basic_block(ctx: ChainCtx, x, prefix: str, stride: int, residual):
    """BasicBlock: the conv1 -> conv2 link int8, the residual join in the
    BatchNorm's dtype."""
    q = ctx.run_layer(x, f"{prefix}/conv1", strides=(stride, stride), padding=1,
                      bn_path=f"{prefix}/bn1", act="relu", next_path=f"{prefix}/conv2")
    out = ctx.join(ctx.run_layer(q, f"{prefix}/conv2", padding=1, bn_path=f"{prefix}/bn2"))
    return torch.clamp_min(out + _match(residual, out.shape[1:3]).to(out.dtype), 0)


def _dla_root(ctx: ChainCtx, children, prefix: str):
    jd = ctx.join_dtype or torch.float32
    x = torch.cat([c.to(jd) for c in children], dim=-1)
    out = ctx.join(ctx.run_layer(x, f"{prefix}/conv", padding=0, bn_path=f"{prefix}/bn"))
    return torch.clamp_min(out, 0)


def _dla_tree(ctx: ChainCtx, x, prefix: str, levels: int, in_ch: int, out_ch: int,
              stride: int = 1, level_root: bool = False, children=None):
    """The HDA tree; the 2x2 downsampling is a ceil-mode max-pool, which
    is flax's max-pool padded with -inf."""
    children = [] if children is None else list(children)
    bottom = x
    if stride > 1:
        bottom = _nhwc(F.max_pool2d(_nchw(x), stride, stride, ceil_mode=True))
    if level_root:
        children.append(bottom)
    if levels == 1:
        proj = bottom
        if in_ch != out_ch:
            proj = ctx.run_layer(bottom, f"{prefix}/project_conv", padding=0,
                                 bn_path=f"{prefix}/project_bn")
        x1 = _dla_basic_block(ctx, x, f"{prefix}/tree1", stride, proj)
        x2 = _dla_basic_block(ctx, x1, f"{prefix}/tree2", 1, x1)
        return _dla_root(ctx, [x2, x1] + children, f"{prefix}/root")
    x1 = _dla_tree(ctx, x, f"{prefix}/tree1", levels - 1, in_ch, out_ch, stride=stride)
    children.append(x1)
    return _dla_tree(ctx, x1, f"{prefix}/tree2", levels - 1, out_ch, out_ch,
                     children=children)


def dla_trunk_chain(ctx: ChainCtx, img: torch.Tensor) -> List[torch.Tensor]:
    """The DLA-34 trunk's six level outputs (NHWC); the 3-channel stem
    stays float (it falls below calibration's ``MIN_IN_CHANNELS``)."""
    x = ctx.run_layer(img, "model/base/base_conv", padding=3, bn_path="model/base/base_bn",
                      act="relu")
    outputs = []
    for level_i in (0, 1):
        stride = 1 if level_i == 0 else 2
        for conv_i in range(DLA34_LEVELS[level_i]):
            x = ctx.run_layer(x, f"model/base/level{level_i}_conv{conv_i}",
                              strides=(stride if conv_i == 0 else 1,) * 2, padding=1,
                              bn_path=f"model/base/level{level_i}_bn{conv_i}", act="relu")
        outputs.append(x)
    for level_i in (2, 3, 4, 5):
        x = _dla_tree(ctx, x, f"model/base/level{level_i}", DLA34_LEVELS[level_i],
                      DLA34_CHANNELS[level_i - 1], DLA34_CHANNELS[level_i], stride=2,
                      level_root=level_i != 2)
        outputs.append(x)
    return outputs


def _depthwise_upsample(ctx: ChainCtx, x, path: str) -> torch.Tensor:
    """DepthwiseUpsample in ``ctx.dtype``: kernel C (``impl="kernel"``) or
    its plain version, on the input cast to ``ctx.dtype``."""
    m = ctx.modules[path]
    fn = depthwise_upsample_cuda if ctx.impl == "kernel" else depthwise_upsample
    return _nhwc(fn(_nchw_contiguous(x, ctx.dtype), cast_parameter(m, "weight", ctx.dtype),
                    m.factor))


def _dcn_block_chain(ctx: ChainCtx, x, path: str) -> torch.Tensor:
    """DeformConvBlock (deform=True) in ``ctx.dtype``: the offset and mask
    convs as one 27-channel conv with its bias added after the conv's
    rounding, as the JAX block serves them, the tanh bound and the sigmoid
    (``DeformConvBlock.modulation``), the DCN through kernel E or its
    plain version at the model's window (``DeformConv2d.max_offset``),
    then flax's BatchNorm and the relu."""
    block = ctx.modules[path]

    def merged():
        w = torch.cat([block.offset.weight, block.mask.weight]).to(ctx.dtype)
        b = torch.cat([block.offset.bias, block.mask.bias]).to(ctx.dtype)
        return w, b[:, None, None]

    weight, bias = ctx._memo(("offset_mask", path), merged)
    xf = _nchw_contiguous(x, ctx.dtype)
    om = F.conv2d(xf, weight, padding=1) + bias
    n_offset = block.offset.out_channels
    offset, mask = block.modulation(om[:, :n_offset], om[:, n_offset:])
    out = block.conv(xf, offset.contiguous(), mask.contiguous(), impl=ctx.impl)
    return torch.clamp_min(ctx.bn_exact(_nhwc(out), f"{path}/bn"), 0.0)


def _ida_stage_chain(ctx: ChainCtx, layers, prefix: str, up_factors, deform: bool):
    """IDAUpStage: for i in 1..n-1, layers[i] = node(up(proj(layers[i])) +
    layers[i-1]), the joins in f32 (or ``join_dtype``)."""
    layers = list(layers)
    jd = ctx.join_dtype or torch.float32
    for i in range(1, len(layers)):
        if deform:
            x = _dcn_block_chain(ctx, layers[i], f"{prefix}/proj_{i}")
        else:
            x = ctx.run_layer(layers[i], f"{prefix}/proj_{i}/conv", padding=1,
                              bn_path=f"{prefix}/proj_{i}/bn", act="relu")
        if up_factors[i] > 1:
            x = _depthwise_upsample(ctx, x, f"{prefix}/up_{i}")
        joined = _match(x, layers[i - 1].shape[1:3]).to(jd) + layers[i - 1].to(jd)
        if deform:
            layers[i] = _dcn_block_chain(ctx, joined, f"{prefix}/node_{i}")
        else:
            layers[i] = ctx.run_layer(joined, f"{prefix}/node_{i}/conv", padding=1,
                                      bn_path=f"{prefix}/node_{i}/bn", act="relu")
    return layers


def dla34_chain_forward(ctx: ChainCtx) -> Callable[[torch.Tensor], Prediction]:
    """``fn(img) -> Prediction`` running the chain-int8 forward of ``ctx``'s
    ``CenterpointDLA34`` (plain or DCN IDA, as the model is built); ``img``
    is the normalised NCHW image, cast to ``ctx.dtype`` inside.  The heads
    are f32 NHWC views of contiguous NCHW maps, as the model's are."""
    model = ctx.model
    if not isinstance(model, CenterpointDLA34):
        raise TypeError(f"dla34_chain_forward needs a CenterpointDLA34, got {type(model)}")
    deform = bool(model.deform_convs())
    n_heads = len(get_head_channels(model.object_config))

    def forward(img: torch.Tensor) -> Prediction:
        with torch.inference_mode():
            levels = dla_trunk_chain(ctx, _nhwc(img.to(ctx.dtype)))
            layers = list(levels[FIRST_LEVEL:])
            n = len(layers)
            scl = np.array([2 ** i for i in range(n)], dtype=int)
            out = [layers[-1]]
            for i in range(n - 1):
                j = -i - 2
                layers[j:] = _ida_stage_chain(ctx, layers[j:], f"model/dla_up/ida_{i}",
                                              (scl[j:] // scl[j]).tolist(), deform)
                scl[j + 1:] = scl[j]
                out.insert(0, layers[-1])
            n_ida = LAST_LEVEL - FIRST_LEVEL
            features = _ida_stage_chain(ctx, out[:n_ida], "model/ida_up",
                                        [2 ** i for i in range(n_ida)], deform)[-1]
            heads = []
            for i in range(n_heads):
                h = ctx.run_layer(features, f"model/head_{i}_conv", padding=1, act="relu",
                                  next_path=f"model/head_{i}_out")
                h = ctx.run_layer(h, f"model/head_{i}_out", padding=0)
                heads.append(_nhwc(_nchw(h).to(torch.float32,
                                               memory_format=torch.contiguous_format)))
        return prediction_from_heads(model.object_config, heads)

    return forward


def make_centernet_chain_pipeline(model: CenterpointDLA34, model_config: CenternetModelConfig,
                                  scales: Dict[str, object], device=DEFAULT_DEVICE,
                                  knobs: DecodeKnobs = SERVING_DECODE, *,
                                  dtype=CHAIN_INT8.input_dtype, impl: str = "kernel",
                                  gains=None, corrections=None):
    """uint8 frames -> ``Detections`` through the chain-int8 DLA-34 forward
    (``make_centernet_pipeline`` with the chain in place of the model, on
    the image in ``dtype``, which is also the chain's float dtype), f32
    joins.  The defaults serve ``bench.py --chain-int8``
    (``configs.CHAIN_INT8``); the model's IDA (plain or DCN) is the
    chain's.  ``impl`` picks kernels C and E and the decode's kernel A, or
    their plain versions; ``gains`` and ``corrections`` are
    ``ChainCtx``'s (``configs.PARITY_INT8``)."""
    ctx = ChainCtx(model, scales, dtype=dtype, join_dtype=None, impl=impl,
                   path_of=centerpoint_flax_path, gains=gains, corrections=corrections)
    return make_centernet_pipeline(dla34_chain_forward(ctx), model_config, device, knobs,
                                   impl=impl, dtype=dtype)


def make_centernet_keypoint_chain_pipeline(model: CenterpointDLA34,
                                           model_config: CenternetModelConfig,
                                           scales: Dict[str, object], projection_matrix,
                                           device=DEFAULT_DEVICE,
                                           knobs: DecodeKnobs = SERVING_DECODE, *,
                                           dtype=KEYPOINTS.input_dtype, impl: str = "kernel"):
    """uint8 frames -> ``KeypointDetections``: the CenterNet node's full
    configuration over the chain-int8 DLA-34 forward, which emits every
    head, so only the decode differs from ``make_centernet_chain_pipeline``.
    The defaults serve the ``int8_fps`` of ``bench.py --keypoints`` (the
    net of ``configs.KEYPOINTS``)."""
    ctx = ChainCtx(model, scales, dtype=dtype, join_dtype=None, impl=impl,
                   path_of=centerpoint_flax_path)
    return make_centernet_keypoint_pipeline(dla34_chain_forward(ctx), model_config,
                                            model.object_config, projection_matrix, device,
                                            knobs, impl=impl, dtype=dtype)


# ------------------------------------------------------- YOLO-Pose chain


def _pointnet_stage_chain(ctx: ChainCtx, x, prefix: str, kernel: int, count: int):
    """A Pointnet stage: conv_0 .. conv_{count-2} (k x k), reduce and out
    (1x1), leaky between convs and none after ``out``, each link int8
    where both ends are calibrated.  Returns the stage's f32 NHWC map."""
    chain = ([f"{prefix}/conv_{i}" for i in range(count - 1)]
             + [f"{prefix}/reduce", f"{prefix}/out"])
    pads = [kernel // 2] * (count - 1) + [0, 0]
    for i, (path, pad) in enumerate(zip(chain, pads)):
        last = i == len(chain) - 1
        x = ctx.run_layer(x, path, padding=pad, act=None if last else "leaky",
                          next_path=None if last else chain[i + 1])
    return x.to(torch.float32, memory_format=torch.contiguous_format)


def _pointnet_chain(ctx: ChainCtx, fpn1, pointnet_layers):
    """The Pointnet cascade on FPN level 1: stage 0 reads the level; a later
    stage reads (belief, affinity, level) cast to ``ctx.dtype`` and
    concatenated on the channel axis in that order, its affinity branch
    the belief the stage has just made.  Returns (beliefs, affinities)."""
    def joined(belief, affinity):
        return torch.cat([t.to(ctx.dtype) for t in (belief, affinity, fpn1)], dim=-1)

    beliefs, affinities = [], []
    for i, (kernel, count, _) in enumerate(pointnet_layers):
        x = fpn1 if i == 0 else joined(beliefs[-1], affinities[-1])
        belief = _pointnet_stage_chain(ctx, x, f"pointnet/belief_{i}", kernel, count)
        x = fpn1 if i == 0 else joined(belief, affinities[-1])
        affinities.append(_pointnet_stage_chain(ctx, x, f"pointnet/affinity_{i}", kernel, count))
        beliefs.append(belief)
    return beliefs, affinities


def _yolo_pose_head_chain(ctx: ChainCtx, fpn_output, n_shared: int,
                          shapes) -> Tuple[torch.Tensor, ...]:
    """The shared head on one FPN level: ``n_shared`` extra stages, then the
    five 3x3 output convs in ``HEAD_OUTPUTS`` order, each flattened from
    NHWC to [B, h*w*A, *shapes[name]] (``YoloPoseHead.shapes``), the mask,
    belief and affinity coefficients tanh'd in the conv's output dtype;
    all f32."""
    x = fpn_output
    for i in range(n_shared):
        x = _extra_stage(ctx, x, f"prediction_head/shared_{i}")
    b = fpn_output.shape[0]
    outs = []
    for name in HEAD_OUTPUTS:
        y = ctx.run_layer(x, f"prediction_head/{name}", padding=1).reshape(b, -1, *shapes[name])
        outs.append((y if name in ("classification", "box") else torch.tanh(y))
                    .to(torch.float32))
    return tuple(outs)


def yolo_pose_chain_forward(ctx: ChainCtx) -> Callable[[torch.Tensor], YoloPosePrediction]:
    """``fn(img) -> YoloPosePrediction`` running the chain-int8 forward of
    ``ctx``'s ``YoloPose`` (ResNet-18 only, as the JAX chain); ``img`` is
    the normalised NCHW image, cast to ``ctx.dtype`` inside.  The
    prototypes are f32 NHWC maps."""
    model = ctx.model
    if not isinstance(model, YoloPose):
        raise TypeError(f"yolo_pose_chain_forward needs a YoloPose, got {type(model)}")
    cfg = model.config
    if cfg.backbone_depth != 18:
        raise NotImplementedError("the chain forward covers the ResNet-18 backbone")
    shapes = model.prediction_head.shapes

    def forward(img: torch.Tensor) -> YoloPosePrediction:
        with torch.inference_mode():
            taps = resnet18_chain(ctx, _nhwc(img.to(ctx.dtype)))
            fpn_outputs = fpn_chain(ctx, taps, cfg.n_fpn_downsample_layers)
            proto = protonet_chain(ctx, fpn_outputs[0], cfg.n_masknet_layers_pre_upsample,
                                   cfg.n_masknet_layers_post_upsample)
            beliefs, affinities = _pointnet_chain(ctx, fpn_outputs[1], cfg.pointnet_layers)
            heads = [_yolo_pose_head_chain(ctx, f, cfg.n_prediction_head_layers, shapes)
                     for f in fpn_outputs]
            classification, box, mask, belief, affinity = (torch.cat(t, dim=1)
                                                           for t in zip(*heads))
        return YoloPosePrediction(
            classification=classification, box_encoding=box, mask_coeff=mask,
            belief_coeff=belief, affinity_coeff=affinity, anchor=model.anchor,
            mask_prototype=proto, belief_prototypes=tuple(beliefs),
            affinity_prototypes=tuple(affinities))

    return forward


def make_yolo_pose_chain_pipeline(model: YoloPose, scales: Dict[str, object],
                                  object_points=None, camera_matrix=None,
                                  device=DEFAULT_DEVICE, knobs: YoloPoseKnobs = YOLO_POSE_DECODE,
                                  *, impl: str = "kernel", dtype=BENCH_YOLO_POSE.chain.dtype):
    """uint8 frames -> ``YoloPoseDetections`` through the chain-int8
    YOLO-Pose forward (``make_yolo_pose_pipeline`` with the chain in place
    of the model, on the image in ``dtype``, which is also the chain's
    float dtype), and PnP when ``object_points`` and ``camera_matrix`` are
    given; joins stay f32 (``configs.BENCH_YOLO_POSE.chain.join_dtype``), as
    the JAX chain keeps them.  The defaults serve the ``value`` of
    ``bench.py --yolo-pose``; ``impl`` picks kernel B or its plain version
    for the belief maps."""
    ctx = ChainCtx(model, scales, dtype=dtype, join_dtype=BENCH_YOLO_POSE.chain.join_dtype,
                   impl=impl, path_of=yolo_pose_flax_path)
    return make_yolo_pose_pipeline(yolo_pose_chain_forward(ctx), model.config, object_points,
                                   camera_matrix, device, knobs, impl=impl, dtype=dtype)
