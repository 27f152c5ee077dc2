"""Tensors derived from a module's parameters, made once and kept until a
parameter changes."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


def derived(module: nn.Module, slot, tensors, build: Callable[[], object], tag=None):
    """``build()``, kept in ``module`` under ``slot`` until one of
    ``tensors`` changes or ``tag`` differs: a move to another device or an
    in-place update (``load_state_dict``, an optimizer step) gives a
    tensor a new address or version, and the next call builds again."""
    key = tuple((t.data_ptr(), t._version) for t in tensors) + (tag,)
    cache = module.__dict__.setdefault("_cast_cache", {})
    if cache.get(slot, (None,))[0] != key:
        with torch.no_grad():
            cache[slot] = (key, build())
    return cache[slot][1]


def cast_parameter(module: nn.Module, name: str, dtype,
                   layout: Optional[Callable] = None) -> torch.Tensor:
    """``module``'s parameter ``name`` in ``dtype``.  The parameter itself
    stays f32, as flax's do.  ``layout(p, dtype)``, where given, builds a
    kernel's own arrangement of it instead of the plain cast.

    Where autograd records (grad enabled and the parameter trainable),
    the cast is built in the graph from the parameter on every call, so
    that its gradient reaches the parameter; otherwise it is made once and
    kept until the parameter changes (``derived``, under its own slot for
    a layout)."""
    p = getattr(module, name)
    if layout is None and p.dtype == dtype:
        return p
    build = (lambda: p.to(dtype)) if layout is None else (lambda: layout(p, dtype))
    if torch.is_grad_enabled() and p.requires_grad:
        return build()
    slot = name if layout is None else (name, layout.__name__)
    return derived(module, slot, (p,), build, dtype)
