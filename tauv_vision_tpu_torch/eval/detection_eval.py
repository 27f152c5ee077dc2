"""Detection evaluation: greedy matching, precision/recall, PR curves.

A copy of ``tauv_vision_tpu/eval/detection_eval.py`` (numpy only), so the
port imports nothing of the JAX package.

Parity targets:
- box IoU matching + PR sweep   centernet/scripts/evaluate.py:106-233
- center-distance matching      centernet/scripts/evaluate_keypoints.py:61-71

The reference matches detections to truths greedily in score order at a
fixed IoU (or center-distance) threshold, removing claimed truths, and
sweeps 10 score thresholds for the PR curve.  Host-side numpy — eval runs
over decoded, already-static detection tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class EvalDetection:
    label: int
    score: float
    y: float
    x: float
    h: float
    w: float


def detections_from_arrays(
    valid: np.ndarray, score: np.ndarray, label: np.ndarray,
    y: np.ndarray, x: np.ndarray, h: np.ndarray, w: np.ndarray,
) -> List[List[EvalDetection]]:
    """[B, K] decoded tensors -> per-sample lists of valid detections."""
    out = []
    for b in range(valid.shape[0]):
        sample = [
            EvalDetection(
                int(label[b, k]), float(score[b, k]), float(y[b, k]),
                float(x[b, k]), float(h[b, k]), float(w[b, k]),
            )
            for k in range(valid.shape[1])
            if valid[b, k]
        ]
        out.append(sample)
    return out


def truths_from_batch(truth) -> List[List[EvalDetection]]:
    """CenternetTruth -> per-sample truth lists (evaluate.py:132-163)."""
    valid = np.asarray(truth.valid)
    label = np.asarray(truth.label)
    center = np.asarray(truth.center)
    size = np.asarray(truth.size)
    out = []
    for b in range(valid.shape[0]):
        sample = [
            EvalDetection(
                int(label[b, i]), 1.0, float(center[b, i, 0]),
                float(center[b, i, 1]), float(size[b, i, 0]),
                float(size[b, i, 1]),
            )
            for i in range(valid.shape[1])
            if valid[b, i]
        ]
        out.append(sample)
    return out


def detection_iou(d1: EvalDetection, d2: EvalDetection) -> float:
    ya = max(d1.y - d1.h / 2, d2.y - d2.h / 2)
    xa = max(d1.x - d1.w / 2, d2.x - d2.w / 2)
    yb = min(d1.y + d1.h / 2, d2.y + d2.h / 2)
    xb = min(d1.x + d1.w / 2, d2.x + d2.w / 2)
    intersection = max(yb - ya, 0) * max(xb - xa, 0)
    if intersection == 0:
        return 0.0
    union = d1.w * d1.h + d2.w * d2.h - intersection
    return intersection / union


def iou_match(iou_threshold: float) -> Callable[[EvalDetection, EvalDetection], bool]:
    def match(d, t):
        return d.label == t.label and detection_iou(d, t) >= iou_threshold
    return match


def center_distance_match(
    distance_threshold: float,
) -> Callable[[EvalDetection, EvalDetection], bool]:
    """evaluate_keypoints.py:61-71 matching rule."""
    def match(d, t):
        dist = ((d.y - t.y) ** 2 + (d.x - t.x) ** 2) ** 0.5
        return d.label == t.label and dist <= distance_threshold
    return match


def precision_recall(
    detections: Sequence[List[EvalDetection]],
    truths: Sequence[List[EvalDetection]],
    match_fn: Callable[[EvalDetection, EvalDetection], bool],
    score_threshold: float = 0.0,
) -> Tuple[float, float]:
    """Greedy score-sorted matching (evaluate.py:167-208)."""
    n_tp = 0
    n_det = 0
    n_truth = 0
    for sample_dets, sample_truths in zip(detections, truths):
        kept = [d for d in sample_dets if d.score >= score_threshold]
        remaining = list(sample_truths)
        n_det += len(kept)
        n_truth += len(sample_truths)
        for det in sorted(kept, key=lambda d: -d.score):
            for t in remaining:
                if match_fn(det, t):
                    n_tp += 1
                    remaining.remove(t)
                    break
    precision = n_tp / n_det if n_det > 0 else 1.0
    recall = n_tp / n_truth if n_truth > 0 else 1.0
    return precision, recall


def precision_recall_curve(
    detections: Sequence[List[EvalDetection]],
    truths: Sequence[List[EvalDetection]],
    match_fn: Callable[[EvalDetection, EvalDetection], bool],
    n_thresholds: int = 10,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sweep score thresholds (evaluate.py:211-233).
    Returns (thresholds, precision, recall)."""
    thresholds = np.linspace(0, 1, n_thresholds)
    precision = np.zeros(n_thresholds)
    recall = np.zeros(n_thresholds)
    for i, threshold in enumerate(thresholds):
        precision[i], recall[i] = precision_recall(
            detections, truths, match_fn, float(threshold)
        )
    return thresholds, precision, recall


def average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """AP via trapezoid over the (recall, precision) sweep, with the
    curve sorted by recall."""
    order = np.argsort(recall)
    r = np.concatenate([[0.0], recall[order], [recall[order][-1]]])
    p = np.concatenate([[precision[order][0]], precision[order],
                        [precision[order][-1]]])
    return float(np.trapezoid(p, r))


def plot_pr_curve(
    precision: np.ndarray, recall: np.ndarray, path: Optional[str] = None
):
    """matplotlib PR plot (evaluate.py:225-233)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.plot(recall, precision)
    plt.xlabel("recall")
    plt.ylabel("precision")
    plt.xlim(0, 1)
    plt.ylim(0, 1)
    plt.grid()
    if path is not None:
        plt.savefig(path)
    plt.close()


def decoded_pair_deltas(dets_a, dets_b, match_radius: float = 0.05) -> dict:
    """Greedy same-label nearest-center matching of decoded detections
    (per image), returning agreement stats — the decoded-parity evidence
    format used across PARITY.md (p50/p95/max deltas of center distance,
    |score|, |size| in normalized image units, plus matched fraction and
    the BASELINE <=1e-3 verdict).

    The same statistic quantize_accuracy_check/yolact_parity_check
    compute between serving rungs, factored out so the shared-weights
    transplant harness (scripts/transplant_parity.py) reports
    torch-vs-rebuild deltas in the identical format.
    """
    center_deltas, score_deltas, size_deltas = [], [], []
    matched, total = 0, 0
    for db, di in zip(dets_a, dets_b):
        total += len(db)
        used = set()
        for d in db:
            best, best_dist = None, match_radius
            for j, q in enumerate(di):
                if j in used or q.label != d.label:
                    continue
                dist = ((d.y - q.y) ** 2 + (d.x - q.x) ** 2) ** 0.5
                if dist < best_dist:
                    best, best_dist = j, dist
            if best is not None:
                used.add(best)
                matched += 1
                q = di[best]
                center_deltas.append(best_dist)
                score_deltas.append(abs(d.score - q.score))
                size_deltas.append(max(abs(d.h - q.h), abs(d.w - q.w)))

    stats = {
        "total": total,
        "matched_fraction": round(matched / max(total, 1), 4),
    }
    for vals, what in ((center_deltas, "center"),
                       (score_deltas, "score"),
                       (size_deltas, "size")):
        if not vals:
            continue
        for p in (50, 95):
            stats[f"{what}_delta_p{p}"] = round(
                float(np.percentile(vals, p)), 6
            )
        stats[f"{what}_delta_max"] = round(float(np.max(vals)), 6)
    if score_deltas:
        stats["all_deltas_le_1e3"] = bool(
            np.percentile(score_deltas, 95) <= 1e-3
            and np.percentile(center_deltas, 95) <= 1e-3
            and np.percentile(size_deltas, 95) <= 1e-3
        )
    return stats
