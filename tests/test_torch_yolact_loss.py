"""The port's YOLACT loss and its gradients against the JAX package's.

``yolact_loss`` on the same numpy predictions and truths, made from a
seed, in both stacks: the JAX side is its jitted ``value_and_grad`` with
respect to the four predicted tensors (``classification``,
``box_encoding``, ``mask_coeff``, ``mask_prototype``).  The anchors are
the 64x64 configuration's (all their coordinates dyadic, so an anchor
copied as a truth box has an IoU of exactly 1 in both stacks).  Held:

- each loss term within 1e-6 relative, ``mask_clipped`` equal;
- each gradient within 1e-5 by relative L2 (the norm of the difference
  over the norm of JAX's);
- the anchors each stack trains, read from where the gradients are
  non-zero: the classification rows (positives and OHEM's negatives), the
  box rows (positives) and the mask-coefficient rows (the mask loss's
  anchors) are the same sets.

Cases: random boxes (squares of ``generate_square_seg_batch``) with a cap
that does not bind, one that binds and no cap (the exact mode); planted
ties, where truth boxes copy anchors (IoU ties across anchors, and a
duplicated object: an argmax tie across objects, whose second copy has an
empty mask) and groups of anchors share one classification row
(background-confidence ties across OHEM's cut), with a binding cap and no
cap; a sample with no positive; a batch with none.  Every case carries a
254 region (``img_valid`` False) that crops the mask loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.yolact import YolactPrediction as JaxPrediction
from tauv_vision_tpu.train.yolact_task import YolactTruth as JaxTruth
from tauv_vision_tpu.train.yolact_task import yolact_loss as jax_yolact_loss
from tauv_vision_tpu_torch.configs import YolactModelConfig, YolactTrainConfig
from tauv_vision_tpu_torch.data.synthetic import SquareDatasetConfig, generate_square_seg_batch
from tauv_vision_tpu_torch.models.yolact import YolactPrediction
from tauv_vision_tpu_torch.ops.anchors import get_all_anchors
from tauv_vision_tpu_torch.train.yolact_task import YolactTruth, _rank_desc, yolact_loss
from torch_parity import SMALL_YOLACT, jax_yolact_config, jax_yolact_train_config, torch_threads

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
H = W = 64
BATCH, M = 3, 4
CFG = YolactModelConfig(**dict(SMALL_YOLACT, iou_pos_threshold=0.4, iou_neg_threshold=0.3))
ANCHOR = get_all_anchors(H, W, CFG.n_fpn_levels, CFG.anchor_scales, CFG.anchor_aspect_ratios)
PROTO_HW = (H // 2, W // 2)
FIELDS = ("classification", "box_encoding", "mask_coeff", "mask_prototype")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def train_config(cap):
    return YolactTrainConfig(lr=1e-3, momentum=0.9, weight_decay=0.0, grad_max_norm=1.0,
                             n_epochs=1, batch_size=BATCH, epoch_n_batches=1, max_objects=M,
                             max_positive_anchors=cap)


def predictions(rng):
    a, c, p = len(ANCHOR), CFG.n_classes + 1, CFG.n_prototype_masks
    return {
        "classification": rng.normal(0, 2, (BATCH, a, c)),
        "box_encoding": rng.normal(0, 0.7, (BATCH, a, 4)),
        "mask_coeff": np.tanh(rng.normal(0, 1, (BATCH, a, p))),
        "mask_prototype": rng.normal(0, 2, (BATCH, *PROTO_HW, p)),
    }


def paint(box, index, seg):
    """Paint a (y, x, h, w) box's pixels with ``index`` in seg [H, W]."""
    y0, x0 = int(round((box[0] - box[2] / 2) * H)), int(round((box[1] - box[3] / 2) * W))
    y1, x1 = int(round((box[0] + box[2] / 2) * H)), int(round((box[1] + box[3] / 2) * W))
    seg[max(y0, 0):y1, max(x0, 0):x1] = index


def random_truth(rng):
    _, f = generate_square_seg_batch(rng, BATCH, SquareDatasetConfig(
        in_h=H, in_w=W, max_objects=M, min_side=10, max_side=24))
    f["classification"] = np.where(f["valid"], rng.integers(1, CFG.n_classes + 1, f["valid"].shape),
                                   0).astype(np.int32)
    return f


def tied_truth(rng):
    """Truth boxes that copy level-0 and level-1 anchors (IoU exactly 1:
    ties across anchors), the last object a copy of the first (its mask is
    painted over: empty)."""
    level0 = (H // 8) * (W // 8)
    f = {"valid": np.ones((BATCH, M), bool),
         "classification": rng.integers(1, CFG.n_classes + 1, (BATCH, M)).astype(np.int32),
         "box": np.zeros((BATCH, M, 4), np.float32),
         "seg": np.full((BATCH, H, W), 255, np.uint8),
         "img_valid": np.ones((BATCH, H, W), bool)}
    for b in range(BATCH):
        picks = [int(rng.integers(level0)), int(rng.integers(level0)),
                 level0 + int(rng.integers((H // 16) * (W // 16)))]
        for i, j in enumerate(picks + picks[:1]):
            f["box"][b, i] = ANCHOR[j]
            paint(ANCHOR[j], i, f["seg"][b])
    return f


def plant_bg_ties(pred, rng):
    """Groups of 12 consecutive anchors share one classification row, so
    their background confidences tie."""
    cls = pred["classification"]
    for b in range(BATCH):
        for start in rng.choice(len(ANCHOR) - 12, 6, replace=False):
            cls[b, start:start + 12] = cls[b, start]


def make_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    pred = predictions(rng)
    truth = tied_truth(rng) if name.startswith("ties") else random_truth(rng)
    if name.startswith("ties"):
        plant_bg_ties(pred, rng)
    if name == "no_positive_sample":
        truth["valid"][0] = False
    if name == "no_positive_batch":
        truth["valid"][:] = False
    # A 254 (invalid) band crops the mask loss.
    truth["img_valid"][:, :, W - 10:] = False
    truth["seg"][:, :, W - 10:] = 254
    pred = {k: v.astype(np.float32) for k, v in pred.items()}
    return pred, truth


CASES = {
    "random_cap64": 64,
    "random_cap2": 2,
    "random_exact": None,
    "ties_cap2": 2,
    "ties_exact": None,
    "no_positive_sample": 64,
    "no_positive_batch": 64,
}


def jax_side(pred, truth, cap):
    def loss(cls, box, coeff, proto):
        prediction = JaxPrediction(classification=cls, box_encoding=box, mask_coeff=coeff,
                                   anchor=jnp.asarray(ANCHOR), mask_prototype=proto)
        jt = JaxTruth(valid=jnp.asarray(truth["valid"]),
                      classification=jnp.asarray(truth["classification"]),
                      box=jnp.asarray(truth["box"]),
                      seg_map=jnp.asarray(truth["seg"].astype(np.int32)),
                      img_valid=jnp.asarray(truth["img_valid"]))
        losses = jax_yolact_loss(prediction, jt, jax_yolact_config(CFG),
                                 jax_yolact_train_config(train_config(cap)))
        return losses.total, losses

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))
    (_, losses), grads = fn(*(jnp.asarray(pred[k]) for k in FIELDS))
    return jax.device_get(losses), [np.asarray(g) for g in grads]


def port_side(pred, truth, cap):
    tensors = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in pred.items()}
    prediction = YolactPrediction(anchor=torch.from_numpy(ANCHOR), **tensors)
    port_truth = YolactTruth(valid=truth["valid"], classification=truth["classification"],
                             box=truth["box"], seg_map=truth["seg"].astype(np.int32),
                             img_valid=truth["img_valid"]).to("cpu")
    losses = yolact_loss(prediction, port_truth, CFG, train_config(cap))
    losses.total.backward()
    return losses.detach(), [tensors[k].grad.numpy() for k in FIELDS]


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_torch_yolact_loss_matches_jax(name):
    cap = CASES[name]
    pred, truth = make_case(name)
    want, want_grads = jax_side(pred, truth, cap)
    got, got_grads = port_side(pred, truth, cap)

    assert int(got.mask_clipped) == int(want.mask_clipped)
    if name == "random_cap2" or name == "ties_cap2":
        assert int(want.mask_clipped) > 0   # the cap binds
    elif cap is not None:
        assert int(want.mask_clipped) == 0
    for field in ("total", "classification", "box", "mask"):
        w, g = float(getattr(want, field)), float(getattr(got, field))
        assert abs(g - w) <= LOSS_RTOL * abs(w), (field, g, w)
    if name == "no_positive_batch":
        assert float(want.box) == float(want.mask) == 0.0
    else:
        assert float(want.mask) > 0 and float(want.box) > 0

    for field, g, w in zip(FIELDS, got_grads, want_grads):
        if not w.any():
            assert not g.any(), field
            continue
        assert rel_l2(g, w) <= GRAD_RTOL, (field, rel_l2(g, w))
    # The trained anchor sets: rows with a non-zero gradient.
    for i, field in enumerate(FIELDS[:3]):
        rows_got = (got_grads[i] != 0).any(axis=-1)
        rows_want = (want_grads[i] != 0).any(axis=-1)
        assert np.array_equal(rows_got, rows_want), field


def test_torch_yolact_ties_cross_the_cuts():
    """The tie cases do what they are for: a tie of background confidence
    spans OHEM's cut in some sample, and a tie of match IoU spans the cap's
    cut (read from the port's ranks, which the gradients above hold to
    JAX's)."""
    from tauv_vision_tpu_torch.train.yolact_task import match_anchors

    pred, truth = make_case("ties_cap2")
    prediction = YolactPrediction(anchor=torch.from_numpy(ANCHOR),
                                  **{k: torch.from_numpy(v) for k, v in pred.items()})
    port_truth = YolactTruth(valid=truth["valid"], classification=truth["classification"],
                             box=truth["box"], seg_map=truth["seg"].astype(np.int32),
                             img_valid=truth["img_valid"]).to("cpu")
    sets = match_anchors(prediction, port_truth, CFG, train_config(2))
    bg = torch.softmax(prediction.classification, -1)[..., 0]
    ohem_tie = iou_tie = False
    for b in range(BATCH):
        neg = ~sets.positive[b] & (sets.match_iou[b] <= CFG.iou_neg_threshold)
        chosen = sets.selected[b] & neg
        dropped = neg & ~sets.selected[b]
        ohem_tie |= bool(set(bg[b][chosen].tolist()) & set(bg[b][dropped].tolist()))
        kept = torch.zeros_like(sets.positive[b])
        kept[sets.top_anchor[b][sets.top_valid[b]]] = True
        iou = sets.match_iou[b]
        iou_tie |= bool(set(iou[kept].tolist()) & set(iou[sets.positive[b] & ~kept].tolist()))
    assert ohem_tie and iou_tie


def test_torch_rank_desc_is_stable():
    scores = torch.tensor([[0.5, 1.0, 0.5, -torch.inf, 1.0, 0.5]])
    assert _rank_desc(scores).tolist() == [[2, 0, 3, 5, 1, 4]]
    jax_rank = jnp.argsort(jnp.argsort(-jnp.asarray(scores.numpy()), axis=-1), axis=-1)
    assert np.asarray(jax_rank).tolist() == _rank_desc(scores).tolist()


def test_torch_yolact_loss_fields():
    assert [f.name for f in dataclasses.fields(YolactTruth)] == [
        f.name for f in dataclasses.fields(JaxTruth)]
