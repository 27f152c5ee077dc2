"""Post-training int8 calibration for the int8 chain (counterpart of
``calibrate`` and ``strip_scales`` in ``tauv_vision_tpu/serving/quantize.py``).

``calibrate`` records the input absmax of every ``nn.Conv2d`` of a model
over some batches, with the JAX package's rules: a conv is recorded when
its input has at least ``MIN_IN_CHANNELS`` channels; the scale is
max(absmax, 1e-6) / 127, per tensor or per input channel.  Transposed
convs are not recorded, as in the JAX package, whose ``calibrate`` sees
only ``nn.Conv`` modules.  Scales are keyed by the JAX module path of the
YOLACT (``weights.yolact_flax_path`` of the port's module name), so one
scales dict feeds both stacks.  The JAX ``percentile`` option is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import numpy as np
import torch
from torch import nn

from tauv_vision_tpu_torch.weights import yolact_flax_path

# Convs with fewer input channels (the 3-channel stem) stay float.
MIN_IN_CHANNELS = 16


def calibrate(model: nn.Module, batches: Iterable[torch.Tensor],
              per_channel: bool = False) -> Dict[str, Any]:
    """Run ``model(batch)`` over ``batches`` (NCHW, as the model takes
    them) and return {JAX module path: activation scale}: a float, or with
    ``per_channel`` a float64 [C_in] array."""
    absmax: Dict[str, Any] = {}

    def recorder(path):
        def hook(module, args):
            x = args[0]
            if x.dim() != 4 or x.shape[1] < MIN_IN_CHANNELS:
                return
            magnitude = x.abs()
            if per_channel:
                value = magnitude.amax(dim=(0, 2, 3)).cpu().numpy().astype(np.float64)
                prev = absmax.get(path)
                absmax[path] = value if prev is None else np.maximum(prev, value)
            else:
                absmax[path] = max(absmax.get(path, 0.0), float(magnitude.max()))
        return hook

    hooks = [m.register_forward_pre_hook(recorder(yolact_flax_path(name)))
             for name, m in model.named_modules() if type(m) is nn.Conv2d]
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
