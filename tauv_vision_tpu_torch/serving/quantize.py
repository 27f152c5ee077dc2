"""Post-training int8 quantization: the calibration of the int8 chains and
the per-layer int8 forward (counterpart of ``calibrate``, ``strip_scales``
and ``quantized_call`` in ``tauv_vision_tpu/serving/quantize.py``).

``calibrate`` records the input absmax of every ``nn.Conv2d`` of a model
over some batches, with the JAX package's rules: a conv is recorded when
its input has at least ``MIN_IN_CHANNELS`` channels; the scale is
max(absmax, 1e-6) / 127, per tensor or per input channel.  Transposed
convs, depthwise upsamples and deformable convs are not recorded, as in
the JAX package, whose ``calibrate`` sees only ``nn.Conv`` modules.
Scales are keyed by the JAX module path of the port's module name
(``weights.yolact_flax_path`` for the YOLACT,
``weights.centerpoint_calibration_paths`` for the CenterNet), so one
scales dict feeds both stacks.  The JAX ``percentile`` option is not ported.

``quantized_call`` runs a model with every calibrated conv as the JAX
``_quantized_conv``: the input quantized with the layer's scale, the
weights per output channel, the exact integer conv
(``ops/int8_conv.conv2d_int8``), the accumulator times (activation scale
x weight scale) and the bias in f32, the result cast to the conv's
compute dtype; every other op is the float model's.  The JAX
``_quantized_s2d_stem`` is not ported (the port has no space-to-depth
stem).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from tauv_vision_tpu_torch.ops.int8_conv import conv2d_int8
from tauv_vision_tpu_torch.serving.quantize_chain import _hwio, _int8_weights, _quant
from tauv_vision_tpu_torch.weights import yolact_flax_path

# Convs with fewer input channels (the 3-channel stem) stay float.
MIN_IN_CHANNELS = 16


Paths = Optional[Union[str, Sequence[str]]]


def calibrate(model: nn.Module, batches: Iterable[torch.Tensor],
              per_channel: bool = False,
              paths_of: Callable[[str], Paths] = yolact_flax_path) -> Dict[str, Any]:
    """Run ``model(batch)`` over ``batches`` (NCHW, as the model takes
    them) and return {JAX module path: activation scale}: a float, or with
    ``per_channel`` a float64 [C_in] array.  ``paths_of(name)`` gives the
    JAX path of the conv ``name``, several paths where the JAX forward
    runs more than one conv on that input, or None where it runs none."""
    absmax: Dict[str, Any] = {}

    def recorder(paths):
        def hook(module, args):
            x = args[0]
            if x.dim() != 4 or x.shape[1] < MIN_IN_CHANNELS:
                return
            magnitude = x.abs()
            for path in paths:
                if per_channel:
                    value = magnitude.amax(dim=(0, 2, 3)).cpu().numpy().astype(np.float64)
                    prev = absmax.get(path)
                    absmax[path] = value if prev is None else np.maximum(prev, value)
                else:
                    absmax[path] = max(absmax.get(path, 0.0), float(magnitude.max()))
        return hook

    hooks = []
    for name, m in model.named_modules():
        paths = paths_of(name) if isinstance(m, nn.Conv2d) else None
        if paths is not None:
            paths = (paths,) if isinstance(paths, str) else tuple(paths)
            hooks.append(m.register_forward_pre_hook(recorder(paths)))
    try:
        with torch.inference_mode():
            for batch in batches:
                model(batch)
    finally:
        for h in hooks:
            h.remove()
    if per_channel:
        return {path: np.maximum(v, 1e-6) / 127.0 for path, v in absmax.items()}
    return {path: max(v, 1e-6) / 127.0 for path, v in absmax.items()}


def strip_scales(scales: Dict[str, Any], substrings) -> Dict[str, Any]:
    """Drop calibration entries whose path contains any substring: those
    layers run in the chain's float dtype."""
    return {p: s for p, s in scales.items()
            if not any(sub in p for sub in substrings)}


class _QuantizedConv:
    """The forward of a calibrated ``nn.Conv2d`` as the JAX
    ``_quantized_conv``, its int8 weights made at first use and kept."""

    def __init__(self, conv: nn.Conv2d, act_scale):
        if conv.groups != 1 or tuple(conv.dilation) != (1, 1) or isinstance(conv.padding, str):
            raise ValueError(f"quantized_call takes ungrouped, undilated convs with numeric "
                             f"padding, got {conv}")
        self.conv, self.act_scale = conv, act_scale
        self.weights: Optional[Tuple[torch.Tensor, ...]] = None

    def _make_weights(self):
        m = self.conv
        with torch.no_grad():
            kernel = _hwio(m).detach()
            scale = torch.as_tensor(self.act_scale, dtype=torch.float32, device=kernel.device)
            bias = None if m.bias is None else m.bias.detach().float()
            return (scale, *_int8_weights(kernel, self.act_scale), bias)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.weights is None:
            self.weights = self._make_weights()
        scale, qk, deq, bias = self.weights
        m = self.conv
        acc = conv2d_int8(_quant(x.permute(0, 2, 3, 1), scale), qk, tuple(m.stride),
                          tuple(m.padding))
        y = acc.to(torch.float32) * deq
        if bias is not None:
            y = y + bias
        return y.to(getattr(m, "compute_dtype", x.dtype)).permute(0, 3, 1, 2)


@contextlib.contextmanager
def _forwards(convs: List[Tuple[nn.Conv2d, _QuantizedConv]]):
    """Each conv's ``forward`` replaced by its quantized one inside the
    ``with``."""
    for m, fwd in convs:
        m.forward = fwd
    try:
        yield
    finally:
        for m, _ in convs:
            del m.forward


def quantized_call(model: nn.Module, scales: Dict[str, Any],
                   paths_of: Callable[[str], Paths] = yolact_flax_path
                   ) -> Callable[[torch.Tensor], Any]:
    """``fn(img)``: ``model(img)`` with every ``nn.Conv2d`` of at least
    ``MIN_IN_CHANNELS`` inputs whose JAX path (``paths_of(name)``) has a
    scale computed in int8 as the JAX ``_quantized_conv`` does, and not
    also in float: the conv's ``forward`` is swapped for the call's
    duration.  Usage::

        scales = calibrate(net, [img], paths_of=yolo_pose_flax_path)
        fn = quantized_call(net, scales, paths_of=yolo_pose_flax_path)
        make_yolo_pose_pipeline(fn, net.config)   # --per-layer-int8

    The int8 weights are made at first use and kept, so the model's
    weights must not change while ``fn`` serves."""
    convs = []
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d) and m.in_channels >= MIN_IN_CHANNELS:
            paths = paths_of(name)
            # a conv's own path comes first where paths_of gives several
            path = paths if paths is None or isinstance(paths, str) else paths[0]
            if path in scales:
                convs.append((m, _QuantizedConv(m, scales[path])))

    def fn(img: torch.Tensor):
        with _forwards(convs):
            return model(img)

    return fn
