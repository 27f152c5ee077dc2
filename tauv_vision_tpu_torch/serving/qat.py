"""Quantization-aware distillation (QAT) for the int8 chain (counterpart of
``tauv_vision_tpu/serving/qat.py``).

``qat_distill`` fine-tunes a fake-quantized copy of a model toward the
frozen float model's outputs:

    minimize  E_x  sum_leaf  w_leaf * MSE(student_int8(x), teacher(x))

The fake-quant conv (``fake_quant_call``) is the JAX ``_fake_quant_conv``:
the serving chain's quantization points (the per-input-channel
activation scale folded into the weights, per-output-channel weight
scales, [-127, 127] grids) with straight-through rounding, run as an f32
conv on the dequantized grids, so that gradients reach the weights and
the biases.  The weight scale is taken again from the current weight at
every call and carries no gradient; the activation scales are fixed.
Unlike ``quantize._QuantizedConv``, nothing is cached: the weights change
at every step.  The clip's gradient is JAX's: 1/2 at +-127, where each
output channel's largest weight lands (``ops/losses.clip``).

The forward swaps each conv's ``forward`` for the call's duration
(``quantize._forwards``), so a model being distilled must not serve
another thread at the same time.  The f32 fake-quant convs, forward and
backward, run without TF32 whatever the global setting
(``quantize.f32_convs``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu_torch.ops.losses import clip
from tauv_vision_tpu_torch.serving.quantize import MIN_IN_CHANNELS, Paths, _forwards, f32_convs
from tauv_vision_tpu_torch.train.state import adam_with_clip
from tauv_vision_tpu_torch.weights import yolact_flax_path


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() (half to even) with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


class _FakeQuantConv:
    """The forward of a calibrated ``nn.Conv2d`` as the JAX
    ``_fake_quant_conv``, differentiable to the conv's current weight, its
    bias and its input."""

    def __init__(self, conv: nn.Conv2d, act_scale):
        if conv.groups != 1 or tuple(conv.dilation) != (1, 1) or isinstance(conv.padding, str):
            raise ValueError(f"fake_quant_call takes ungrouped, undilated convs with numeric "
                             f"padding, got {conv}")
        self.conv = conv
        self.act_scale = torch.as_tensor(act_scale, dtype=torch.float32,
                                         device=conv.weight.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        m, s = self.conv, self.act_scale
        per_channel = s.dim() >= 1
        kernel = m.weight.to(torch.float32)                     # [O, I, kh, kw]
        if per_channel:
            kernel = kernel * s.reshape(1, -1, 1, 1)
        w_absmax = kernel.detach().abs().amax(dim=(1, 2, 3))
        w_scale = torch.clamp_min(w_absmax, 1e-6) / 127.0
        q_kernel = clip(ste_round(kernel / w_scale.reshape(-1, 1, 1, 1)), -127.0, 127.0)
        x_scale = s.reshape(1, -1, 1, 1) if per_channel else s
        q_x = clip(ste_round(x.to(torch.float32) / x_scale), -127.0, 127.0)
        acc = F.conv2d(q_x, q_kernel, None, m.stride, m.padding)
        out = acc * (w_scale if per_channel else s * w_scale).reshape(1, -1, 1, 1)
        if m.bias is not None:
            out = out + m.bias.to(torch.float32).reshape(1, -1, 1, 1)
        return out.to(getattr(m, "compute_dtype", x.dtype))


def fake_quant_call(model: nn.Module, scales: Dict[str, object],
                    paths_of: Callable[[str], Paths] = yolact_flax_path):
    """``fn(img)``: ``model(img)`` with every ``nn.Conv2d`` of at least
    ``MIN_IN_CHANNELS`` inputs whose JAX path (the first of
    ``paths_of(name)``) has a scale run fake-quantized (``_FakeQuantConv``),
    differentiably, without TF32 (``f32_convs``); the convs' forwards are
    swapped for the call's duration."""
    convs = []
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d) and m.in_channels >= MIN_IN_CHANNELS:
            paths = paths_of(name)
            path = paths if paths is None or isinstance(paths, str) else paths[0]
            if path in scales:
                convs.append((m, _FakeQuantConv(m, scales[path])))

    def fn(img: torch.Tensor):
        with _forwards(convs), f32_convs():
            return model(img)

    return fn


def leaf_loss(name: str, student: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """The JAX ``_default_leaf_loss``: the mean squared difference in f32,
    after a sigmoid on the leaves whose name holds ``heatmap`` or ``bin``
    (the decode thresholds their sigmoid), raw on the regression maps."""
    s, t = student.to(torch.float32), teacher.to(torch.float32)
    if "heatmap" in name or "bin" in name:
        s, t = torch.sigmoid(s), torch.sigmoid(t)
    return torch.mean((s - t) ** 2)


def distillation_loss(student, teacher, leaf_weights: Optional[Dict[str, float]] = None
                      ) -> torch.Tensor:
    """The sum over a prediction's fields (a dataclass, in field order,
    ``None`` fields skipped as JAX's pytree skips them) of ``leaf_loss``
    times the weight of the last key of ``leaf_weights`` that the field's
    name holds (1 where none does)."""
    total = 0.0
    for field in dataclasses.fields(student):
        s, t = getattr(student, field.name), getattr(teacher, field.name)
        if s is None:
            continue
        w = 1.0
        for key, wv in (leaf_weights or {}).items():
            if key in field.name:
                w = wv
        total = total + w * leaf_loss(field.name, s, t)
    return total


def qat_distill(model: nn.Module, scales: Dict[str, object], batches: Iterable[torch.Tensor],
                steps: int, lr: float = 2e-5, leaf_weights: Optional[Dict[str, float]] = None,
                teacher: Optional[nn.Module] = None,
                paths_of: Callable[[str], Paths] = yolact_flax_path,
                log_every: int = 25, log_fn: Callable[[str], None] = print) -> nn.Module:
    """A copy of ``model`` fine-tuned for ``steps`` steps so that its
    fake-quantized forward (``fake_quant_call``) matches the frozen
    ``teacher``'s float forward (default: ``model`` itself, unchanged) on
    ``batches`` (images as the model takes them), by
    ``distillation_loss``.  Both run with BatchNorm on its running
    statistics (eval mode), the teacher without gradients; the student's
    f32 convs, forward and backward, without TF32; every parameter of the
    copy trains, by ``train/state.adam_with_clip(lr,
    1.0)`` (optax's ``chain(clip_by_global_norm(1.0), adam(lr))``)."""
    teacher = model if teacher is None else teacher
    teacher.eval()
    student = copy.deepcopy(model).eval()
    for p in student.parameters():
        p.requires_grad_(True)
    optimizer = adam_with_clip(student.parameters(), lr, 1.0)
    forward = fake_quant_call(student, scales, paths_of=paths_of)
    it = iter(batches)
    for i in range(steps):
        img = next(it)
        with torch.no_grad():
            target = teacher(img)
        loss = distillation_loss(forward(img), target, leaf_weights)
        optimizer.zero_grad(set_to_none=True)
        with f32_convs():
            loss.backward()
        optimizer.step()
        if log_every and i % log_every == 0:
            log_fn(f"qat step {i}: distill loss {loss.item():.3e}")
    return student
