"""The served bf16 YOLO-Pose (``bench.py --yolo-pose``'s bf16 rung:
``YoloPose(dtype=bf16)`` fed the bf16 image) of the port against the JAX
package's, on ``test_torch_yolo_pose.py``'s small config and weights.

A bf16 net is chaotic: the port's convs sum in another order than XLA's,
so outputs round a bf16 ulp apart and the differences spread.  So the
port is held to JAX's own spread, its compiled graph against the same
graph run op by op (XLA fuses casts away and sums in another order),
whose rounding the port follows; both JAX runs and the port read the
same bf16 image, which the port's preprocess makes bit-equal to JAX's:

- **Forward**: each field's relative L2 distance from JAX's op-by-op
  output at most JAX compiled's.  Measured on these seeds: the port
  0.45-0.76%, JAX compiled 0.68-1.28%.
- **Decode** at confidence 0 (every slot): the slots whose validity,
  label or box (beyond 1e-3) differ from JAX op by op's, the keypoints
  that differ, and the largest score difference, each at most JAX
  compiled's.  Measured: the port 8 slots, 16 keypoints and 0.0063, JAX
  compiled 18 slots, 26 keypoints and 0.0080, of 40 slots and 120
  keypoints.  Slots swap where Fast-NMS ranks near-equal confidences,
  and keypoints move on near-tied belief peaks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.ops.image import preprocess as jax_preprocess
from tauv_vision_tpu.serving import yolo_pose_decode as jax_decode
from tauv_vision_tpu.serving.pipeline import IMAGENET_MEAN, IMAGENET_STDDEV
from tauv_vision_tpu_torch.ops.image import preprocess
from tauv_vision_tpu_torch.serving.pipeline import YoloPoseKnobs, make_yolo_pose_pipeline
from test_torch_yolo_pose import (
    CFG,
    FIELDS,
    IOU,
    JAX_CFG,
    STAGE_FIELDS,
    TOP_K,
    frames,
    yolo_pose_pair,
)
from torch_parity import torch_threads

BOX_ATOL = 1e-3   # a box further than this from JAX's: its slot differs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def served():
    """JAX's bf16 forward and decode of the frames' bf16 image, compiled and
    op by op, and the port's bf16 forward and pipeline on the frames."""
    jax_model, variables, port = yolo_pose_pair(torch.bfloat16, 0)
    raw = frames(1)
    out_hw = (CFG.in_h, CFG.in_w)
    img = jax_preprocess(jnp.asarray(raw), out_hw, IMAGENET_MEAN, IMAGENET_STDDEV,
                         dtype=jnp.bfloat16)
    port_img = preprocess(torch.from_numpy(raw), out_hw, IMAGENET_MEAN, IMAGENET_STDDEV,
                          torch.bfloat16)
    assert torch.equal(port_img.permute(0, 2, 3, 1).float(),
                       torch.from_numpy(np.array(img.astype(jnp.float32))))
    compiled = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, img)
    op_by_op = jax_model.apply(variables, img, train=False)
    with torch.inference_mode():
        pred = port(port_img)
    pipe = make_yolo_pose_pipeline(port, CFG, device="cpu", knobs=YoloPoseKnobs(
        top_k=TOP_K, iou_threshold=IOU, confidence_threshold=0.0))
    return dict(
        compiled=compiled, op_by_op=op_by_op, port=pred, port_dets=pipe(raw),
        dets={name: jax_decode.decode_yolo_pose(p, JAX_CFG, TOP_K, IOU, 0.0)
              for name, p in (("compiled", compiled), ("op_by_op", op_by_op))})


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("field", tuple(f for f in FIELDS if f != "anchor") + tuple(
    f"{f}/{i}" for f in STAGE_FIELDS for i in range(len(CFG.pointnet_layers))))
def test_torch_yolo_pose_bf16_forward_within_jax_spread(served, field, record_property):
    name, _, stage = field.partition("/")

    def get(pred):
        value = getattr(pred, name)
        return value[int(stage)] if stage else value

    got = get(served["port"])
    assert got.dtype == torch.float32
    want = np.asarray(get(served["op_by_op"]), np.float32)
    spread = _rel_l2(np.asarray(get(served["compiled"]), np.float32), want)
    err = _rel_l2(got.numpy(), want)
    record_property("rel_l2", err)
    record_property("jax_spread", spread)
    assert err <= spread, (field, err, spread)


def _decode_distance(got, want):
    """(slots whose validity, label or box differ, keypoints that differ,
    the largest score difference)."""
    def a(d, f):
        v = getattr(d, f)
        return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    box_far = np.abs(a(got, "box") - a(want, "box")).max(-1) > BOX_ATOL
    slots = (a(got, "valid") != a(want, "valid")) | (a(got, "label") != a(want, "label")) | box_far
    keypoints = ((a(got, "keypoint_y") != a(want, "keypoint_y"))
                 | (a(got, "keypoint_x") != a(want, "keypoint_x")))
    return int(slots.sum()), int(keypoints.sum()), float(np.abs(a(got, "score")
                                                               - a(want, "score")).max())


def test_torch_yolo_pose_bf16_decode_within_jax_spread(served, record_property):
    want = served["dets"]["op_by_op"]
    spread = _decode_distance(served["dets"]["compiled"], want)
    got = _decode_distance(served["port_dets"], want)
    record_property("port", str(got))
    record_property("jax_spread", str(spread))
    assert served["port_dets"].belief.shape == want.belief.shape
    for name, g, s in zip(("slots", "keypoints", "score"), got, spread):
        assert g <= s, (name, got, spread)
