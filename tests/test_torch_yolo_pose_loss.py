"""The port's YOLO-Pose targets, loss and its gradients against the JAX
package's.

At ``tests/test_yolo_pose.py``'s small configuration (3 keypoints, 4
prototypes of each kind, two Pointnet stages on FPN level 1) at 64x128,
not its 64x96: there every anchor coordinate is dyadic, so an anchor
copied as a truth box has an IoU of exactly 1 in both stacks and ties of
IoU can be planted.  On the same numpy predictions and truths made from
a seed:

- ``create_belief`` and ``create_affinity`` on points that are invalid,
  on the map's edge and off it: the belief within ``BELIEF_ULPS`` f32
  ulps of 1 (``exp`` may round an ulp apart between XLA and torch), the
  affinity's inside mask (``dist <= radius``) equal and its unit vectors
  within ``AFFINITY_ULPS`` ulps (a correctly rounded sqrt and divide in
  both);
- ``yolo_pose_loss`` against JAX's jitted ``value_and_grad`` with
  respect to all eight predicted fields (each Pointnet stage's prototypes
  apart): each loss term within ``LOSS_RTOL`` relative, each gradient
  within ``GRAD_RTOL`` by relative L2 (the norm of the difference over
  the norm of JAX's; f32 sums in another order); and the anchors each
  stack trains, read from the rows whose gradient is non-zero, the same
  sets: the classification rows (positives and OHEM's negatives), the box
  rows (positives), the mask, belief and affinity coefficient rows (the
  capped positives).

Cases: random boxes with a cap that binds (2) and one that does not (the
default 16); planted ties, where truth boxes copy anchors (IoU ties across
anchors, across the cap's cut) and groups of anchors share one
classification row (background-confidence ties across OHEM's cut),
one of them a duplicated object (an argmax tie across objects, whose
second copy has no pixels: the mask term's ``area > 0`` guard); a sample
with no positive; a batch with none.  Every case has invalid keypoints
and keypoints off the belief map.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.configs.yolo_pose import YoloPoseModelConfig as JaxYoloPoseModelConfig
from tauv_vision_tpu.models.yolo_pose import YoloPosePrediction as JaxPrediction
from tauv_vision_tpu.train import yolo_pose_task as jax_task
from tauv_vision_tpu_torch.configs import YoloPoseModelConfig
from tauv_vision_tpu_torch.models.yolo_pose import YoloPosePrediction
from tauv_vision_tpu_torch.ops.anchors import get_all_anchors
from tauv_vision_tpu_torch.train.yolact_task import match_anchor_sets
from tauv_vision_tpu_torch.train.yolo_pose_task import (
    YoloPoseLosses,
    YoloPoseTruth,
    create_affinity,
    create_belief,
    yolo_pose_loss,
)
from torch_parity import torch_threads

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
BELIEF_ULPS = 2
AFFINITY_ULPS = 1
H, W = 64, 128
BATCH, M = 3, 4
# tests/test_yolo_pose.py:18-30.
SMALL = dict(
    in_w=W, in_h=H, feature_depth=16, n_classes=2, n_prototype_masks=4,
    n_masknet_layers_pre_upsample=1, n_masknet_layers_post_upsample=1,
    pointnet_layers=((5, 3, 16), (5, 3, 16)),
    pointnet_feature_depth=16,
    prototype_belief_depth=4, prototype_affinity_depth=4,
    belief_depth=3, affinity_depth=6,
    n_prediction_head_layers=1, n_fpn_downsample_layers=2,
    belief_sigma=2.0, affinity_radius=4.0,
    anchor_scales=(12, 24, 48, 96, 192), anchor_aspect_ratios=(1.0,),
    box_variances=(0.1, 0.2),
    iou_pos_threshold=0.4, iou_neg_threshold=0.3, negative_example_ratio=3,
)
CFG = YoloPoseModelConfig(**SMALL)
JAX_CFG = JaxYoloPoseModelConfig(**SMALL)
K = CFG.belief_depth
ANCHOR = get_all_anchors(H, W, CFG.n_fpn_levels, CFG.anchor_scales, CFG.anchor_aspect_ratios)
PROTO_HW = (H // 2, W // 2)
BELIEF_HW = (H // 16, W // 16)      # the Pointnet runs on FPN level 1
N_STAGES = len(CFG.pointnet_layers)
FIELDS = ("classification", "box_encoding", "mask_coeff", "belief_coeff", "affinity_coeff",
          "mask_prototype")
STAGE_FIELDS = ("belief_prototypes", "affinity_prototypes")
LOSS_FIELDS = tuple(f.name for f in dataclasses.fields(YoloPoseLosses))
TRUTH_FIELDS = tuple(f.name for f in dataclasses.fields(YoloPoseTruth))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def predictions(rng):
    a, c = len(ANCHOR), CFG.n_classes + 1
    pb, pa = CFG.prototype_belief_depth, CFG.prototype_affinity_depth
    pred = {
        "classification": rng.normal(0, 2, (BATCH, a, c)),
        "box_encoding": rng.normal(0, 0.7, (BATCH, a, 4)),
        "mask_coeff": np.tanh(rng.normal(0, 1, (BATCH, a, CFG.n_prototype_masks))),
        "belief_coeff": np.tanh(rng.normal(0, 1, (BATCH, a, K, pb))),
        "affinity_coeff": np.tanh(rng.normal(0, 1, (BATCH, a, 2 * K, pa))),
        "mask_prototype": rng.normal(0, 2, (BATCH, *PROTO_HW, CFG.n_prototype_masks)),
        "belief_prototypes": [rng.normal(0, 2, (BATCH, *BELIEF_HW, pb)) for _ in range(N_STAGES)],
        "affinity_prototypes": [rng.normal(0, 2, (BATCH, *BELIEF_HW, pa))
                                for _ in range(N_STAGES)],
    }
    return {k: [a.astype(np.float32) for a in v] if isinstance(v, list) else v.astype(np.float32)
            for k, v in pred.items()}


def paint(box, index, seg):
    """Paint a (y, x, h, w) box's pixels with ``index`` in seg [H, W]."""
    y0, x0 = int(round((box[0] - box[2] / 2) * H)), int(round((box[1] - box[3] / 2) * W))
    y1, x1 = int(round((box[0] + box[2] / 2) * H)), int(round((box[1] + box[3] / 2) * W))
    seg[max(y0, 0):y1, max(x0, 0):x1] = index


def keypoint_fields(rng, f):
    """Keypoints around each box (some off the frame), a third of them
    invalid, and centres at the boxes' centres (pixels)."""
    centre = f["box"][..., :2] * np.asarray([H, W], np.float32)
    spread = f["box"][..., None, 2:] * np.asarray([H, W], np.float32)
    f["keypoints"] = (centre[..., None, :] + rng.uniform(-0.8, 0.8, (BATCH, M, K, 2)) * spread
                      ).astype(np.float32)
    f["keypoints"][:, 0, 0] = (-3.0, W + 2.0)        # off the map
    f["keypoint_valid"] = rng.random((BATCH, M, K)) > 0.3
    f["centers"] = centre.astype(np.float32)
    return f


def random_truth(rng):
    f = {"valid": np.zeros((BATCH, M), bool), "box": np.zeros((BATCH, M, 4), np.float32),
         "seg_map": np.full((BATCH, H, W), 255, np.int32)}
    f["box"][..., 2:] = 1e-3
    for b in range(BATCH):
        for i in range(int(rng.integers(2, M + 1))):
            side = rng.uniform(10, 28)
            cy, cx = rng.uniform(side / 2, H - side / 2), rng.uniform(side / 2, W - side / 2)
            f["box"][b, i] = (cy / H, cx / W, side / H, side / W)
            f["valid"][b, i] = True
            paint(f["box"][b, i], i, f["seg_map"][b])
    f["classification"] = np.where(f["valid"], rng.integers(1, CFG.n_classes + 1, (BATCH, M)),
                                   0).astype(np.int32)
    return keypoint_fields(rng, f)


def tied_truth(rng):
    """Truth boxes that copy level-0 and level-1 anchors (IoU exactly 1:
    ties across anchors), the last object a copy of the first (its mask is
    painted over: empty)."""
    level0 = (H // 8) * (W // 8)
    f = {"valid": np.ones((BATCH, M), bool),
         "classification": rng.integers(1, CFG.n_classes + 1, (BATCH, M)).astype(np.int32),
         "box": np.zeros((BATCH, M, 4), np.float32),
         "seg_map": np.full((BATCH, H, W), 255, np.int32)}
    for b in range(BATCH):
        picks = [int(rng.integers(level0)), int(rng.integers(level0)),
                 level0 + int(rng.integers((H // 16) * (W // 16)))]
        for i, j in enumerate(picks + picks[:1]):
            f["box"][b, i] = ANCHOR[j]
            paint(ANCHOR[j], i, f["seg_map"][b])
    return keypoint_fields(rng, f)


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
    return pred, truth


CASES = {
    "random_cap16": 16,
    "random_cap2": 2,
    "ties_cap2": 2,
    "ties_cap16": 16,
    "no_positive_sample": 16,
    "no_positive_batch": 16,
}


def jax_truth(truth):
    return jax_task.YoloPoseTruth(**{k: jnp.asarray(truth[k]) for k in TRUTH_FIELDS})


def port_truth(truth) -> YoloPoseTruth:
    return YoloPoseTruth(**{k: truth[k] for k in TRUTH_FIELDS}).to("cpu")


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """JAX's jitted loss and gradients, one function for every case (a
    compile for each cap)."""
    def loss(fields, anchor, truth, cap):
        prediction = JaxPrediction(anchor=anchor, **fields)
        losses = jax_task.yolo_pose_loss(prediction, truth, JAX_CFG, cap)
        return losses.total, losses

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True), static_argnums=3)

    def run(pred, truth, cap):
        fields = {k: tuple(map(jnp.asarray, v)) if isinstance(v, list) else jnp.asarray(v)
                  for k, v in pred.items()}
        (_, losses), grads = fn(fields, jnp.asarray(ANCHOR), jax_truth(truth), cap)
        return jax.device_get(losses), jax.device_get(grads)

    return run


def port_side(pred, truth, cap):
    tensors = {k: [torch.from_numpy(a.copy()).requires_grad_() for a in v]
               if isinstance(v, list) else torch.from_numpy(v.copy()).requires_grad_()
               for k, v in pred.items()}
    prediction = YoloPosePrediction(anchor=torch.from_numpy(ANCHOR),
                                    **{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in tensors.items()})
    losses = yolo_pose_loss(prediction, port_truth(truth), CFG, cap)
    losses.total.backward()
    grads = {k: [t.grad.numpy() for t in v] if isinstance(v, list) else v.grad.numpy()
             for k, v in tensors.items()}
    return losses.detach(), grads


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def each_gradient(grads):
    """(name, array) of every gradient, the stages apart."""
    for k in FIELDS:
        yield k, np.asarray(grads[k])
    for k in STAGE_FIELDS:
        for i, g in enumerate(grads[k]):
            yield f"{k}[{i}]", np.asarray(g)


def positives_a_sample(pred, truth, cap):
    prediction = YoloPosePrediction(
        anchor=torch.from_numpy(ANCHOR), classification=torch.from_numpy(pred["classification"]),
        box_encoding=None, mask_coeff=None, belief_coeff=None, affinity_coeff=None,
        mask_prototype=None, belief_prototypes=None, affinity_prototypes=None)
    return match_anchor_sets(prediction, port_truth(truth), CFG, cap)


@pytest.mark.parametrize("name", list(CASES))
def test_torch_yolo_pose_loss_matches_jax(name, jax_value_and_grad):
    cap = CASES[name]
    pred, truth = make_case(name)
    want, want_grads = jax_value_and_grad(pred, truth, cap)
    got, got_grads = port_side(pred, truth, cap)

    n_pos = positives_a_sample(pred, truth, cap).positive.sum(dim=1)
    if name.endswith("cap2"):
        assert int(n_pos.max()) > cap        # the cap binds
    elif cap is not None:
        assert int(n_pos.max()) <= cap
    for field in LOSS_FIELDS:
        w, g = float(getattr(want, field)), float(getattr(got, field))
        assert abs(g - w) <= LOSS_RTOL * abs(w), (field, g, w)
    if name == "no_positive_batch":
        assert all(float(getattr(want, f)) == 0.0 for f in LOSS_FIELDS)
    else:
        assert all(float(getattr(want, f)) > 0 for f in LOSS_FIELDS)

    for (field, g), (_, w) in zip(each_gradient(got_grads), each_gradient(want_grads)):
        assert np.isfinite(g).all(), field
        if not w.any():
            assert not g.any(), field
            continue
        assert rel_l2(g, w) <= GRAD_RTOL, (field, rel_l2(g, w))
    # The trained anchor sets: rows with a non-zero gradient.
    for field in FIELDS[:5]:
        rows_got = np.asarray(got_grads[field]).reshape(BATCH, len(ANCHOR), -1) != 0
        rows_want = np.asarray(want_grads[field]).reshape(BATCH, len(ANCHOR), -1) != 0
        assert np.array_equal(rows_got.any(-1), rows_want.any(-1)), field


def test_torch_yolo_pose_ties_cross_the_cuts():
    """The tie cases do what they are for: a tie of background confidence
    spans OHEM's cut in some sample, and a tie of match IoU spans the cap's
    cut (the port's ranks, which the gradients above hold to JAX's)."""
    pred, truth = make_case("ties_cap2")
    sets = positives_a_sample(pred, truth, 2)
    bg = torch.softmax(torch.from_numpy(pred["classification"]), -1)[..., 0]
    ohem_tie = iou_tie = False
    for b in range(BATCH):
        neg = ~sets.positive[b] & (sets.match_iou[b] <= CFG.iou_neg_threshold)
        chosen, dropped = sets.selected[b] & neg, neg & ~sets.selected[b]
        ohem_tie |= bool(set(bg[b][chosen].tolist()) & set(bg[b][dropped].tolist()))
        kept = torch.zeros_like(sets.positive[b])
        kept[sets.top_anchor[b][sets.top_valid[b]]] = True
        iou = sets.match_iou[b]
        iou_tie |= bool(set(iou[kept].tolist()) & set(iou[sets.positive[b] & ~kept].tolist()))
    assert ohem_tie and iou_tie


def target_points():
    """Keypoints [2, 4, K, 2] and centres [2, 4, 2] on the 4x8 first-stage
    map and around it: inside, on the edge, off the map, and a
    centre on its keypoint (a zero vector); validity mixed."""
    rng = np.random.default_rng(3)
    points = rng.uniform(-3.0, 9.0, (2, 4, K, 2)).astype(np.float32)
    points[0, 0] = ((0.0, 0.0), (3.0, 5.0), (-2.5, 7.5))
    centers = rng.uniform(0.0, 6.0, (2, 4, 2)).astype(np.float32)
    centers[0, 1] = points[0, 1, 0]
    valid = rng.random((2, 4, K)) > 0.25
    valid[0, 0] = True
    return points, valid, centers


def ulps(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("size", [BELIEF_HW, (16, 32)])
def test_torch_yolo_pose_targets_match_jax(size):
    points, valid, centers = target_points()
    scale = np.float32(size[0] / BELIEF_HW[0])
    points, centers = points * scale, centers * scale
    want_b = np.asarray(jax_task.create_belief(size, jnp.asarray(points), jnp.asarray(valid),
                                               CFG.belief_sigma))
    got_b = create_belief(size, torch.from_numpy(points), torch.from_numpy(valid),
                          CFG.belief_sigma).numpy()
    assert got_b.shape == want_b.shape == (2, 4, K, *size)
    assert np.abs(got_b - want_b).max() <= BELIEF_ULPS * np.spacing(np.float32(1))
    assert not got_b[~valid].any() and not want_b[~valid].any()

    want_a = np.asarray(jax_task.create_affinity(
        size, jnp.asarray(points), jnp.asarray(valid), jnp.asarray(centers),
        CFG.affinity_radius))
    got_a = create_affinity(size, torch.from_numpy(points), torch.from_numpy(valid),
                            torch.from_numpy(centers), CFG.affinity_radius).numpy()
    assert got_a.shape == want_a.shape == (2, 4, 2 * K, *size)
    # The inside mask: where either component of a keypoint's pair is set.
    inside_got = (got_a.reshape(2, 4, K, 2, *size) != 0).any(axis=3)
    inside_want = (want_a.reshape(2, 4, K, 2, *size) != 0).any(axis=3)
    assert np.array_equal(inside_got, inside_want)
    assert inside_want.any() and not inside_want.all()
    assert np.all(np.abs(got_a - want_a) <= AFFINITY_ULPS * ulps(want_a))


def test_torch_yolo_pose_truth_fields():
    assert TRUTH_FIELDS == tuple(f.name for f in dataclasses.fields(jax_task.YoloPoseTruth))
    assert LOSS_FIELDS == tuple(f.name for f in dataclasses.fields(jax_task.YoloPoseLosses))
