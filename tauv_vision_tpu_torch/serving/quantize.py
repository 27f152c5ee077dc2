"""Post-training int8 quantization: the calibration of the int8 chains and
the per-layer int8 forward (counterpart of ``calibrate``,
``calibrate_range``, ``refine_scales_mse``, ``calibrate_bias_correction``,
``calibrate_gptq``, ``strip_scales`` and ``quantized_call`` in
``tauv_vision_tpu/serving/quantize.py``).

``calibrate`` records the input range of every ``nn.Conv2d`` of a model
over some batches, with the JAX package's rules: a conv is recorded when
its input has at least ``MIN_IN_CHANNELS`` channels; the scale is
max(range, 1e-6) / 127, per tensor or per input channel, where the range
is the absmax or, with ``percentile``, that percentile of |input|,
interpolated as XLA's ``jnp.percentile`` does.  Transposed convs, depthwise
upsamples and deformable convs are not recorded, as in the JAX package,
whose ``calibrate`` sees only ``nn.Conv`` modules.  Scales are keyed by
the JAX module path of the port's module name (``weights.yolact_flax_path``
for the YOLACT, ``weights.centerpoint_calibration_paths`` for the
DLA-34 CenterNet, ``weights.centernet_flax_path`` for the custom-DLA
``Centernet``), so one scales dict feeds both stacks.  ``refine_scales_mse``
(the clip factor of least squared quantization error, per channel) and
``calibrate_bias_correction`` (each conv's mean output error in int8,
per output channel) read the calibrated convs' inputs the same way, and
so do ``calibrate_range`` (each input channel's (min, max), for the
chain's asymmetric ranges) and ``calibrate_gptq`` (error-compensated int8
weights, for ``ChainCtx(wq_override=)``).  A path that the JAX forward
runs and the port's does not (the CenterNet's discarded parent
projection, ``centerpoint_calibration_paths``) is computed from the input
of the conv that stands for it, with that path's own conv.

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
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu_torch.ops.int8_conv import conv2d_int8
from tauv_vision_tpu_torch.serving.quantize_chain import (
    _hwio,
    _int8_weights,
    _quant,
    f32_convs,
)
from tauv_vision_tpu_torch.weights import yolact_flax_path

# Convs with fewer input channels (the 3-channel stem) stay float.
MIN_IN_CHANNELS = 16


Paths = Optional[Union[str, Sequence[str]]]


def _as_paths(paths: Paths) -> Tuple[str, ...]:
    if paths is None:
        return ()
    return (paths,) if isinstance(paths, str) else tuple(paths)


def _run_hooked(model: nn.Module, batches: Iterable[torch.Tensor],
                paths_of: Callable[[str], Paths], record) -> None:
    """Run ``model(batch)`` over ``batches`` with ``record(convs, x)`` called
    on the input ``x`` of every ``nn.Conv2d`` that has JAX paths and at
    least ``MIN_IN_CHANNELS`` input channels; ``convs`` is ((path, the conv
    whose own path it is), ...), in ``paths_of``'s order."""
    own = {}
    for name, m in model.named_modules():
        paths = _as_paths(paths_of(name)) if isinstance(m, nn.Conv2d) else ()
        if paths:
            own.setdefault(paths[0], m)
    hooks = []
    for name, m in model.named_modules():
        paths = _as_paths(paths_of(name)) if isinstance(m, nn.Conv2d) else ()
        if not paths:
            continue

        def hook(module, args, paths=paths):
            x = args[0]
            if x.dim() == 4 and x.shape[1] >= MIN_IN_CHANNELS:
                record(tuple((p, own.get(p, module)) for p in paths), x)

        hooks.append(m.register_forward_pre_hook(hook))
    try:
        with torch.inference_mode():
            for batch in batches:
                model(batch)
    finally:
        for h in hooks:
            h.remove()


def _percentile(x: torch.Tensor, q: float, dim: Optional[int] = None) -> torch.Tensor:
    """``jnp.percentile(x, q, axis=dim)`` (linear interpolation) as XLA
    compiles it: the position q * f32(0.01 * (n - 1)) in f32 (XLA divides
    by 100 as a multiply by its reciprocal and folds that into the
    constant n - 1), the order statistics either side of it
    (``torch.kthvalue``, which takes any size, where ``torch.quantile``
    refuses more than 2^24 elements), the blend high * w + (low * (1 - w))
    with one rounding (XLA's fused multiply-add), rounded to x's dtype."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    f32 = dict(dtype=torch.float32, device=x.device)
    n = torch.tensor(x.shape[dim], **f32)
    pos = torch.tensor(q, **f32) * (torch.tensor(0.01, **f32) * (n - 1))
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1 - w_high
    values = x.to(torch.float32)

    def order_statistic(i):
        k = int(torch.clamp(i, torch.zeros((), **f32), n - 1)) + 1
        return torch.kthvalue(values, k, dim=dim).values

    v_low = order_statistic(low)
    v_high = v_low if bool(high == low) else order_statistic(high)
    blend = v_high.double() * w_high.double() + (v_low * w_low).double()
    return blend.to(torch.float32).to(x.dtype)


def calibrate(model: nn.Module, batches: Iterable[torch.Tensor],
              per_channel: bool = False,
              paths_of: Callable[[str], Paths] = yolact_flax_path,
              percentile: Optional[float] = None) -> Dict[str, Any]:
    """Run ``model(batch)`` over ``batches`` (NCHW, as the model takes
    them) and return {JAX module path: activation scale}: a float, or with
    ``per_channel`` a float64 [C_in] array.  The range is the input's
    absmax, or with ``percentile`` that
    percentile of |input| in each batch, and the largest over the batches.
    ``paths_of(name)`` gives the JAX path of the conv ``name``, several
    paths where the JAX forward runs more than one conv on that input, or
    None where it runs none."""
    absmax: Dict[str, Any] = {}

    def record(convs, x):
        magnitude = x.abs()
        if per_channel:
            flat = magnitude.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
            if percentile is None:
                value = flat.amax(dim=0)
            else:
                value = _percentile(flat, percentile, dim=0)
            value = value.double().cpu().numpy()
        elif percentile is None:
            value = float(magnitude.max())
        else:
            value = float(_percentile(magnitude, percentile))
        for path, _ in convs:
            prev = absmax.get(path)
            if per_channel:
                absmax[path] = value if prev is None else np.maximum(prev, value)
            else:
                absmax[path] = max(prev or 0.0, value)

    _run_hooked(model, batches, paths_of, record)
    if per_channel:
        return {path: np.maximum(v, 1e-6) / 127.0 for path, v in absmax.items()}
    return {path: max(v, 1e-6) / 127.0 for path, v in absmax.items()}


def calibrate_range(model: nn.Module, batches: Iterable[torch.Tensor],
                    paths_of: Callable[[str], Paths] = yolact_flax_path
                    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{JAX module path: (min [C_in], max [C_in]) float64}: each recorded
    conv input's per-channel range over the batches (the convs
    ``calibrate`` records), widened to hold 0 (min <= 0) and to at least
    1e-6 (max >= min + 1e-6), as the JAX ``calibrate_range``: the
    asymmetric chain's ``ChainCtx(ranges=)``."""
    lo: Dict[str, np.ndarray] = {}
    hi: Dict[str, np.ndarray] = {}

    def record(convs, x):
        flat = x.to(torch.float32).permute(0, 2, 3, 1).reshape(-1, x.shape[1])
        mn = flat.amin(dim=0).double().cpu().numpy()
        mx = flat.amax(dim=0).double().cpu().numpy()
        for path, _ in convs:
            lo[path] = mn if path not in lo else np.minimum(lo[path], mn)
            hi[path] = mx if path not in hi else np.maximum(hi[path], mx)

    _run_hooked(model, batches, paths_of, record)
    out = {}
    for path in lo:
        mn = np.minimum(lo[path], 0.0)
        out[path] = (mn, np.maximum(hi[path], mn + 1e-6))
    return out


# ``refine_scales_mse``'s candidate clip factors, 0.5 to 1.0 by 0.05.
MSE_FACTORS = tuple(0.5 + 0.05 * i for i in range(11))


def mse_errors(model: nn.Module, batches: Iterable[torch.Tensor], scales: Dict[str, Any],
               factors: Sequence[float] = MSE_FACTORS,
               paths_of: Callable[[str], Paths] = yolact_flax_path) -> Dict[str, np.ndarray]:
    """{path: float64 [F, C_in]}: for each calibrated conv of ``scales`` and
    each factor f, the summed squared error of quantizing its input with
    the scale times f, each channel summed in f32 over a call's pixels and
    the calls added in float64, as the JAX ``refine_scales_mse`` does."""
    errs: Dict[str, np.ndarray] = {}

    def record(convs, x):
        flat = x.to(torch.float32).permute(0, 2, 3, 1).reshape(-1, x.shape[1])
        for path, _ in convs:
            if path not in scales:
                continue
            s = torch.as_tensor(scales[path], dtype=torch.float32, device=x.device)
            per_err = []
            for f in factors:
                sf = s * torch.tensor(float(f), dtype=torch.float32)
                q = torch.clamp(torch.round(flat / sf), -127, 127) * sf
                per_err.append(torch.square(flat - q).sum(dim=0))
            e = torch.stack(per_err).cpu().numpy().astype(np.float64)
            errs[path] = errs.get(path, 0.0) + e

    _run_hooked(model, batches, paths_of, record)
    return errs


def refine_scales_mse(model: nn.Module, batches: Iterable[torch.Tensor],
                      scales: Dict[str, Any], factors: Sequence[float] = MSE_FACTORS,
                      paths_of: Callable[[str], Paths] = yolact_flax_path) -> Dict[str, Any]:
    """A copy of ``scales`` with each calibrated conv's scale times the
    factor of least summed squared quantization error over the batches
    (``mse_errors``): per input channel for a per-channel scale, for the
    tensor (errors summed over its channels) for a float."""
    factors = np.asarray(list(factors), np.float64)
    refined = dict(scales)
    for path, e in mse_errors(model, batches, scales, factors, paths_of).items():
        s = np.asarray(scales[path], np.float64)
        refined[path] = (s * factors[np.argmin(e, axis=0)] if s.ndim
                         else float(s * factors[int(np.argmin(e.sum(axis=1)))]))
    return refined


def calibrate_bias_correction(model: nn.Module, batches: Iterable[torch.Tensor],
                              scales: Dict[str, Any],
                              paths_of: Callable[[str], Paths] = yolact_flax_path
                              ) -> Dict[str, np.ndarray]:
    """{path: float64 [C_out]}: each calibrated conv's mean over batch,
    rows and columns of its f32 output on the f32 input less the
    dequantized integer conv of the quantized input and the folded,
    quantized weights (no bias on either side), averaged over its calls,
    as the JAX ``calibrate_bias_correction`` computes it (the f32 conv
    without TF32, ``f32_convs``).  The chain adds it to the dequantized
    accumulator (``ChainCtx(corrections=)``)."""
    sums: Dict[str, np.ndarray] = {}
    counts: Dict[str, int] = {}

    def record(convs, x):
        xf = x.to(torch.float32)
        for path, conv in convs:
            if path not in scales:
                continue
            if conv.groups != 1 or tuple(conv.dilation) != (1, 1):
                raise ValueError(f"calibrate_bias_correction takes ungrouped, undilated "
                                 f"convs, got {path}: {conv}")
            s_in = torch.as_tensor(scales[path], dtype=torch.float32, device=x.device)
            kernel = _hwio(conv).detach().to(torch.float32)
            folded = kernel * (s_in.reshape(1, 1, -1, 1) if s_in.dim() else s_in)
            w_absmax = folded.reshape(-1, folded.shape[-1]).abs().amax(dim=0)
            w_scale = torch.clamp_min(w_absmax, 1e-6) / 127.0
            qk = torch.clamp(torch.round(folded / w_scale), -127, 127).to(torch.int8)
            qx = _quant(xf.permute(0, 2, 3, 1), s_in)
            stride, padding = tuple(conv.stride), tuple(conv.padding)
            with f32_convs():
                out_f = F.conv2d(xf, conv.weight.detach().to(torch.float32), None, stride,
                                 padding)
            out_q = conv2d_int8(qx, qk, stride, padding).to(torch.float32) * w_scale
            diff = (out_f.permute(0, 2, 3, 1) - out_q).mean(dim=(0, 1, 2))
            sums[path] = sums.get(path, 0.0) + diff.cpu().numpy().astype(np.float64)
            counts[path] = counts.get(path, 0) + 1

    _run_hooked(model, batches, paths_of, record)
    return {path: sums[path] / counts[path] for path in sums}


def _gptq_fold(scale) -> np.ndarray:
    """The activation scale a conv's kernel is multiplied by in the chain:
    a symmetric scale (float or per-channel vector) as it is, an
    asymmetric (min, max) range its width over 255 (``ChainCtx.asym``)."""
    if isinstance(scale, tuple):
        mn, mx = scale
        return np.maximum(np.asarray(mx) - np.asarray(mn), 1e-6) / 255.0
    return np.asarray(scale, np.float64)


def _gptq_rows(x: torch.Tensor, conv: nn.Conv2d, take_of, rng: np.random.Generator
               ) -> torch.Tensor:
    """[take, kh*kw*C] float64 im2col rows of ``x`` (NCHW) under ``conv``'s
    window: output positions drawn by ``rng.choice(n_pos, take,
    replace=False)``, take = ``take_of(n_pos)``, with batch, row and column
    from the flat position as the JAX ``calibrate_gptq``'s, each row in
    (tap row, tap column, channel) order."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    ph, pw = conv.padding
    xp = F.pad(x.permute(0, 2, 3, 1).to(torch.float64), (0, 0, pw, pw, ph, ph))
    b, hp, wp, c = xp.shape
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    n_pos = b * oh * ow
    idx = torch.as_tensor(rng.choice(n_pos, size=take_of(n_pos), replace=False),
                          device=x.device)
    bi, rest = idx // (oh * ow), idx % (oh * ow)
    ys = (rest // ow * sh)[:, None] + torch.arange(kh, device=x.device)
    xs = (rest % ow * sw)[:, None] + torch.arange(kw, device=x.device)
    return xp[bi[:, None, None], ys[:, :, None], xs[:, None, :]].reshape(len(idx), kh * kw * c)


def _gptq_round(wf: torch.Tensor, hinv: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """GPTQ's row-by-row rounding of the folded kernel ``wf`` [n, O] on the
    grid ``ws`` [O]: each row rounded to nearest, its error over the inverse
    Hessian's diagonal carried onto the rows after it through the upper
    Cholesky factor ``hinv`` of the damped inverse Hessian."""
    w = wf.clone()
    q_all = torch.zeros_like(w)
    for i in range(w.shape[0]):
        q = torch.clamp(torch.round(w[i] / ws), -127, 127)
        q_all[i] = q
        err = (w[i] - q * ws) / hinv[i, i]
        if i + 1 < w.shape[0]:
            w[i + 1:] -= torch.outer(hinv[i, i + 1:], err)
    return q_all


def calibrate_gptq(model: nn.Module, batches: Iterable[torch.Tensor], scales: Dict[str, Any],
                   paths_of: Callable[[str], Paths] = yolact_flax_path, max_rows: int = 8192,
                   damp: float = 0.01, seed: int = 0
                   ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{path: (qk int8 [kh, kw, C, O], w_scale [O] f32)}: error-compensated
    int8 weights (GPTQ, Frantar et al., 2022) for every recorded conv of
    ``scales``, as the JAX ``calibrate_gptq``, for
    ``ChainCtx(wq_override=)``.

    Each kernel is folded as the chain folds it (``_gptq_fold``: a
    symmetric scale, or an asymmetric range's width over 255), its weight
    scale fixed at absmax / 127, and its input dimensions rounded in order
    (``_gptq_round``) against H = X^T X of im2col rows of its calibration
    inputs in the folded units, damped by ``damp`` times H's mean diagonal.
    The rows: per path, in the order the JAX forward first meets the paths,
    and per batch, ``max_rows // n_batches + 1`` output positions drawn
    without replacement from one ``np.random.default_rng(seed)``
    (``_gptq_rows``), as JAX draws them, so that H is JAX's.  The JAX
    forward runs the projection a port conv also stands for
    (``centerpoint_calibration_paths``) before that conv's own, so its
    draws come first.  H, its damped inverse's Cholesky factor and the
    rounding run in float64 on the model's device."""
    inputs: Dict[str, List[torch.Tensor]] = {}
    convs: Dict[str, nn.Conv2d] = {}

    def record(hooked, x):
        for path, conv in reversed(hooked):
            if path in scales:
                convs.setdefault(path, conv)
                inputs.setdefault(path, []).append(x.detach().clone())

    _run_hooked(model, batches, paths_of, record)
    rng = np.random.default_rng(seed)
    out = {}
    for path, conv in convs.items():
        if conv.groups != 1 or tuple(conv.dilation) != (1, 1):
            raise ValueError(f"calibrate_gptq takes ungrouped, undilated convs, got {path}: "
                             f"{conv}")
        kernel = _hwio(conv).detach().to(torch.float64)
        kh, kw, c, o = kernel.shape
        dev = dict(dtype=torch.float64, device=kernel.device)
        fold = torch.as_tensor(np.broadcast_to(_gptq_fold(scales[path]), (c,)).copy(), **dev)
        wf = (kernel * fold.reshape(1, 1, -1, 1)).reshape(kh * kw * c, o)
        n_batches = len(inputs[path])
        # The rows are in the activation's units; the chain quantizes x / fold.
        x = torch.cat([_gptq_rows(t, conv, lambda n: min(max_rows // n_batches + 1, n), rng)
                       for t in inputs[path]]) / fold.repeat(kh * kw)
        h = x.T @ x
        h = h + torch.eye(h.shape[0], **dev) * damp * torch.mean(torch.diagonal(h))
        hinv = torch.linalg.cholesky(torch.linalg.inv(h)).mT
        ws = torch.clamp_min(wf.abs().amax(dim=0), 1e-6) / 127.0
        qk = _gptq_round(wf, hinv, ws)
        out[path] = (qk.reshape(kh, kw, c, o).to(torch.int8).cpu().numpy(),
                     ws.to(torch.float32).cpu().numpy())
    return out


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
