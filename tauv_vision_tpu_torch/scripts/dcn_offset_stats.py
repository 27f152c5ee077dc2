"""DCN offset ranges on trained weights (counterpart of
``tauv_vision_tpu/scripts/dcn_offset_stats.py``, with its flags).

Trains the DCN DLA-34 CenterNet in bf16 on synthetic squares at its
640x360 (``data/synthetic.generate_square_batch``, seed 7) through the
train step and Adam of ``train/``, once with the offset penalty
(``CenternetTrainConfig.loss_lambda_dcn_offset``: ``--lambda-dcn`` times
the mean squared excess of |offset| over ``--offset-range``,
``train/steps.dcn_offset_penalty``) and once without, then reports the
distribution of |offset| over every DCN block's forward of a seeded
evaluation set (seed 1007): p50, p95, p99, p99.9, the largest, the share
within one cell and the count.  That share is the evidence that the
penalty keeps offsets inside R = 1, where kernel E's lerp body
(``--dcn-bound``'s R <= 1 rows) is exact.

The offsets are unbounded, as the JAX script trains its net
(``dcn_impl="gather"``): no tanh bound and no window
(``dcn_max_offset=None``), so kernel E samples every corner in the
forward and the backward is the unwindowed plain version's
(``ops/deform_conv._DeformConvFunction``).  The offsets are collected by
``models/centerpoint_dla.sow_dcn_offsets``, in the convs' dtype, as the
JAX blocks sow ``"dcn_offset"``.

On the card:

  python -m tauv_vision_tpu_torch.scripts.dcn_offset_stats --steps 200 \\
      --out dcn_offsets.json

``main(argv, device="cpu")`` runs it on the CPU; the frame size is the
module's ``IN_H`` and ``IN_W``, read at each call, which a small run sets
first.  The result is JSON with the JAX script's keys.
"""

from __future__ import annotations

import argparse
from math import pi
from typing import Callable, List, Tuple

import numpy as np
import torch

from tauv_vision_tpu_torch.configs.centernet import (
    AngleConfig,
    CenternetModelConfig,
    CenternetTrainConfig,
    ObjectConfig,
    ObjectConfigSet,
)
from tauv_vision_tpu_torch.data.synthetic import SquareDatasetConfig, generate_square_batch
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34, sow_dcn_offsets
from tauv_vision_tpu_torch.scripts.quantize_accuracy_check import _emit
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import make_centernet_train_step

IN_H, IN_W = 360, 640
INIT_SEED = 0        # the JAX script's jax.random.key(0)
TRAIN_SEED = 7
EVAL_SEED = 1007
LOG_EVERY = 25


def object_config() -> ObjectConfigSet:
    """One class, no angle, depth or keypoint trained."""
    return ObjectConfigSet(configs=(ObjectConfig(
        id="square",
        yaw=AngleConfig(train=False, modulo=2 * pi),
        pitch=AngleConfig(train=False, modulo=2 * pi),
        roll=AngleConfig(train=False, modulo=2 * pi),
        train_depth=False, train_keypoints=False, keypoints=None,
    ),))


def model_config() -> CenternetModelConfig:
    return CenternetModelConfig(in_h=IN_H, in_w=IN_W, backbone_heights=(2, 2, 2, 2, 2),
                                backbone_channels=(128,) * 6, downsamples=2,
                                angle_bin_overlap=pi / 3)


def train_config(args, lam: float) -> CenternetTrainConfig:
    """The JAX script's train config with the penalty's weight ``lam``."""
    return CenternetTrainConfig(
        lr=args.lr, batch_size=args.batch_size, n_batches=0, n_epochs=1,
        heatmap_focal_loss_a=2.0, heatmap_focal_loss_b=4.0, heatmap_sigma_factor=0.1,
        keypoint_heatmap_sigma=2.0, keypoint_affinity_sigma=2.0,
        loss_lambda_keypoint_heatmap=1.0, loss_lambda_keypoint_affinity=1.0,
        loss_lambda_size=0.1, loss_lambda_offset=1.0, loss_lambda_angle=1.0,
        loss_lambda_depth=1.0, max_objects=4, max_keypoints=4,
        loss_lambda_dcn_offset=lam, dcn_offset_range=args.offset_range)


def square_config() -> SquareDatasetConfig:
    return SquareDatasetConfig(in_h=IN_H, in_w=IN_W, max_objects=4, min_side=24, max_side=96,
                               rotate=False)


def build_model(oc: ObjectConfigSet, device) -> CenterpointDLA34:
    """The bf16 DCN DLA-34 with unbounded offsets (no bound, no window),
    initialised from ``INIT_SEED`` by the flax initialisers (the offset
    and mask convs at zero)."""
    return CenterpointDLA34(oc, device=device, deform=True, dtype=torch.bfloat16, init="flax",
                            generator=torch.Generator().manual_seed(INIT_SEED))


def offset_stats(model: CenterpointDLA34, eval_imgs: List[torch.Tensor]) -> dict:
    """The distribution of |offset| over every DCN block's forward of each
    of ``eval_imgs`` (NCHW f32), the net in eval mode, as the JAX script's
    ``offset_stats``."""
    mags = []
    with torch.inference_mode(), sow_dcn_offsets(model) as offsets:
        for img in eval_imgs:
            model(img)
            mags.append(torch.cat([o.float().abs().reshape(-1) for o in offsets]).cpu().numpy())
            offsets.clear()
    mags = np.concatenate(mags)
    return {
        "p50": round(float(np.percentile(mags, 50)), 4),
        "p95": round(float(np.percentile(mags, 95)), 4),
        "p99": round(float(np.percentile(mags, 99)), 4),
        "p999": round(float(np.percentile(mags, 99.9)), 4),
        "max": round(float(mags.max()), 4),
        "frac_le_1": round(float((mags <= 1.0).mean()), 6),
        "n": int(mags.size),
    }


def train(args, lam: float, device, log: Callable[[str], None] = print
          ) -> Tuple[CenterpointDLA34, float]:
    """(the net in eval mode, the last logged total loss) after
    ``args.steps`` Adam steps (clipped at 1.0) on fresh batches of squares
    from ``default_rng(TRAIN_SEED)``, the penalty weighted ``lam``; the
    total and the penalty logged every ``LOG_EVERY`` steps and at the
    last."""
    oc = object_config()
    model = build_model(oc, device)
    state = TrainState(model, adam_with_clip(model.parameters(), args.lr, 1.0))
    step_fn = make_centernet_train_step(model_config(), train_config(args, lam), oc)
    square = square_config()
    rng = np.random.default_rng(TRAIN_SEED)
    final_loss = None
    for step in range(args.steps):
        img, truth = generate_square_batch(rng, args.batch_size, square)
        img = torch.from_numpy(img).to(device).permute(0, 3, 1, 2).contiguous()
        state, losses = step_fn(state, img, truth.to(device))
        if step % LOG_EVERY == 0 or step == args.steps - 1:
            final_loss = float(losses.total)
            log(f"lam={lam} step {step}: total={final_loss:.4f} "
                f"dcn_offset={float(losses.dcn_offset):.6f}")
    return model.eval(), final_loss


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lambda-dcn", type=float, default=1.0)
    p.add_argument("--offset-range", type=float, default=1.0)
    p.add_argument("--eval-batches", type=int, default=2)
    p.add_argument("--skip-unregularized", action="store_true")
    p.add_argument("--out", default=None)
    return p


def main(argv=None, device=DEFAULT_DEVICE) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(device)

    def log(line):
        print(line, flush=True)

    eval_rng = np.random.default_rng(EVAL_SEED)
    eval_imgs = [torch.from_numpy(generate_square_batch(eval_rng, args.batch_size,
                                                        square_config())[0])
                 .to(device).permute(0, 3, 1, 2).contiguous()
                 for _ in range(args.eval_batches)]

    result = {"steps": args.steps, "lambda_dcn": args.lambda_dcn,
              "offset_range": args.offset_range}
    log("training regularized DCN DLA-34...")
    model, loss = train(args, args.lambda_dcn, device, log)
    result["regularized"] = offset_stats(model, eval_imgs)
    result["regularized"]["final_loss"] = loss
    if not args.skip_unregularized:
        del model
        log("training unregularized DCN DLA-34...")
        model, loss = train(args, 0.0, device, log)
        result["unregularized"] = offset_stats(model, eval_imgs)
        result["unregularized"]["final_loss"] = loss
    return _emit(args, result)


if __name__ == "__main__":
    main()
