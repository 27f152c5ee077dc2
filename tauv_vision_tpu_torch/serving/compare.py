"""Decoded-detection agreement in the repo's parity format.

Turns ``Detections`` / ``YolactDetections`` of either stack into the
per-image lists that ``tauv_vision_tpu.eval.detection_eval.
decoded_pair_deltas`` matches (same label, nearest centre).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from tauv_vision_tpu_torch.eval.detection_eval import (
    EvalDetection,
    decoded_pair_deltas,
    detections_from_arrays,
)


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu()
    return np.asarray(a)


def eval_lists(dets, score_threshold: Optional[float] = None) -> List[List[EvalDetection]]:
    """Per-image detection lists.  ``score_threshold`` None keeps the
    ``valid`` mask; a number keeps every detection scoring at least it."""
    score = _np(dets.score)
    valid = _np(dets.valid) if score_threshold is None else score >= score_threshold
    if hasattr(dets, "box"):
        box = _np(dets.box)
        y, x, h, w = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    else:
        y, x, h, w = (_np(dets.y), _np(dets.x), _np(dets.h), _np(dets.w))
    return detections_from_arrays(valid, score, _np(dets.label), y, x, h, w)


def detection_deltas(dets_a, dets_b, score_threshold: Optional[float] = None) -> dict:
    """``decoded_pair_deltas`` between two decodes of the same frames."""
    return decoded_pair_deltas(eval_lists(dets_a, score_threshold),
                               eval_lists(dets_b, score_threshold))
