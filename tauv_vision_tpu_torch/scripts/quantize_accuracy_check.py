"""int8 accuracy of the DLA-34 CenterNet on trained weights (counterpart of
``tauv_vision_tpu/scripts/quantize_accuracy_check.py``, with the same
flags but ``--early-pack``: the port has no ``early_pack`` net).

Trains the bf16 plain-IDA ``CenterpointDLA34`` on synthetic squares at its
640x360 (``data/synthetic.generate_square_batch``, seed 7) through the
train step and Adam of ``train/``, or loads weights (``--load-model``, the
pickle both stacks read and write: ``weights.read_flax_variables``), then
decodes a seeded evaluation set (seed 1007) through the bf16 model, its
int8 forms and recipes, and reports:

- the default mode: AP at IoU 0.5 against the truth for bf16, per-layer
  int8 (``quantize.quantized_call``) and the int8 chain, with image
  bootstrap intervals, and each int8 form's agreement with bf16;
- ``--sweep``: each rung of ``SWEEP_LADDER`` (scales, strips, MSE
  clipping, bias correction, sequential fits, headroom, asymmetric
  ranges, GPTQ weights, f32 heads) as the int8 chain's decoded agreement
  with the float reference (``--baseline bf16`` or ``f32``);
- ``--keypoints``: the same with the keypoint decode (``decode_keypoints``,
  the CenterNet node's outputs);
- ``--qat-steps`` / ``--qat-load``: the chain on QAT-distilled weights
  (``serving/qat.qat_distill``) against the original bf16 model.

On the card:

  python -m tauv_vision_tpu_torch.scripts.quantize_accuracy_check \\
      --steps 300 --sweep --out quant_acc.json

``main(argv, device="cpu")`` runs it on the CPU; the frame size is the
module's ``IN_H`` and ``IN_W``, read at each call, which a small run sets
first.  The result is JSON with the JAX script's keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from math import pi
from typing import Callable, List

import numpy as np
import torch

from tauv_vision_tpu_torch.configs.centernet import (
    AngleConfig,
    CenternetModelConfig,
    CenternetTrainConfig,
    ObjectConfig,
    ObjectConfigSet,
)
from tauv_vision_tpu_torch.data.synthetic import (
    SQUARE_CORNERS,
    SquareDatasetConfig,
    generate_square_batch,
)
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.eval.detection_eval import (
    average_precision,
    decoded_pair_deltas,
    detections_from_arrays,
    iou_match,
    precision_recall_curve,
    truths_from_batch,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.serving.centernet_decode import decode, decode_keypoints
from tauv_vision_tpu_torch.serving.qat import qat_distill
from tauv_vision_tpu_torch.serving.quantize import (
    calibrate,
    calibrate_bias_correction,
    calibrate_gptq,
    calibrate_range,
    quantized_call,
    refine_scales_mse,
    strip_scales,
)
from tauv_vision_tpu_torch.serving.quantize_chain import (
    ChainCtx,
    calibrate_sequential,
    dla34_chain_forward,
    f32_convs,
)
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import make_centernet_train_step
from tauv_vision_tpu_torch.weights import (
    centerpoint_calibration_paths,
    centerpoint_flax_from_state_dict,
    centerpoint_flax_path,
    centerpoint_state_dict_from_flax,
    read_flax_variables,
    write_flax_variables,
)

IN_H, IN_W = 360, 640
INIT_SEED = 0        # the JAX script's jax.random.key(0)
TRAIN_SEED = 7
EVAL_SEED = 1007
QAT_SEED = 2027
BOOTSTRAP_SEED = 42
LOG_EVERY = 25

SWEEP_LADDER = (
    # 1: per-tensor absmax -> per-channel -> bias correction -> float tail stages.
    ("absmax", dict(per_channel=False, bias_correct=False, strip=())),
    ("per_channel", dict(per_channel=True, bias_correct=False, strip=())),
    ("pc+biascorr", dict(per_channel=True, bias_correct=True, strip=())),
    ("pc+bc+bf16heads",
     dict(per_channel=True, bias_correct=True, strip=("head_",))),
    ("pc+bc+bf16heads+idaup",
     dict(per_channel=True, bias_correct=True,
          strip=("head_", "ida_up"))),
    ("pc+bc+bf16heads+idaup+dlaup",
     dict(per_channel=True, bias_correct=True,
          strip=("head_", "ida_up", "dla_up"))),
    ("pc+bc+bf16tail+lvl5",
     dict(per_channel=True, bias_correct=True,
          strip=("head_", "ida_up", "dla_up", "level5"))),
    # 2: the early trunk levels float instead of the tail.
    ("pc+bf16heads",
     dict(per_channel=True, bias_correct=False, strip=("head_",))),
    ("pc+bf16heads+early01",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_"))),
    ("pc+bf16heads+early012",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level2"))),
    ("pc+bf16heads+early0123",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level2", "level3"))),
    ("pc+bf16heads+early01+updown",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "ida_up", "dla_up"))),
    # 3: MSE-optimal per-channel clipping (``refine_scales_mse``).
    ("mse+bf16heads+early01",
     dict(per_channel=True, bias_correct=False, mse=True,
          strip=("head_", "level0_", "level1_"))),
    ("mse+bf16heads+early01+updown",
     dict(per_channel=True, bias_correct=False, mse=True,
          strip=("head_", "level0_", "level1_", "ida_up", "dla_up"))),
    ("mse+bc+bf16heads+early01+updown",
     dict(per_channel=True, bias_correct=True, mse=True,
          strip=("head_", "level0_", "level1_", "ida_up", "dla_up"))),
    # 4: the plain per-channel ladder deeper into the trunk.
    ("pc+bf16heads+early012+updown",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level2",
                 "ida_up", "dla_up"))),
    ("pc+bf16heads+early01+updown+lvl5",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level5",
                 "ida_up", "dla_up"))),
    ("pc+bf16heads+early0123+updown",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level2", "level3",
                 "ida_up", "dla_up"))),
    # 5: sequential recalibration (``calibrate_sequential``, offsets or affine).
    ("seqmean+bf16heads+early01+updown",
     dict(per_channel=True, bias_correct=False, seq="mean",
          strip=("head_", "level0_", "level1_", "ida_up", "dla_up"))),
    ("seq+bf16heads+early01+updown",
     dict(per_channel=True, bias_correct=False, seq="affine",
          strip=("head_", "level0_", "level1_", "ida_up", "dla_up"))),
    ("seq+bf16heads+early012+updown",
     dict(per_channel=True, bias_correct=False, seq="affine",
          strip=("head_", "level0_", "level1_", "level2",
                 "ida_up", "dla_up"))),
    ("seq+bf16heads+early0123+updown",
     dict(per_channel=True, bias_correct=False, seq="affine",
          strip=("head_", "level0_", "level1_", "level2", "level3",
                 "ida_up", "dla_up"))),
    # 6: one trunk level int8 at a time.
    ("pc+only-lvl2",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level3", "level4",
                 "level5", "ida_up", "dla_up"))),
    ("pc+only-lvl23",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level4", "level5",
                 "ida_up", "dla_up"))),
    ("pc+only-lvl234",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level5",
                 "ida_up", "dla_up"))),
    ("pc+only-lvl5",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level2", "level3",
                 "level4", "ida_up", "dla_up"))),
    ("pc+only-lvl4",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level2", "level3",
                 "level5", "ida_up", "dla_up"))),
    ("pc+only-lvl34",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level0_", "level1_", "level2",
                 "level5", "ida_up", "dla_up"))),
    # The control: no int8 conv, the chain's float path against the model's.
    ("pc+none",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "level", "ida_up", "dla_up", "base"))),
    # 7: MSE clipping on the best rung; headroom factors on the scales.
    ("mse+bf16heads+early0123+updown",
     dict(per_channel=True, bias_correct=False, mse=True,
          strip=("head_", "level0_", "level1_", "level2", "level3",
                 "ida_up", "dla_up"))),
    ("pc+early0123+updown+margin1.1",
     dict(per_channel=True, bias_correct=False, margin=1.1,
          strip=("head_", "level0_", "level1_", "level2", "level3",
                 "ida_up", "dla_up"))),
    ("pc+early0123+updown+margin1.25",
     dict(per_channel=True, bias_correct=False, margin=1.25,
          strip=("head_", "level0_", "level1_", "level2", "level3",
                 "ida_up", "dla_up"))),
    ("pc+only-lvl5+margin1.25",
     dict(per_channel=True, bias_correct=False, margin=1.25,
          strip=("head_", "level0_", "level1_", "level2", "level3",
                 "level4", "ida_up", "dla_up"))),
    # 8: asymmetric activations (``calibrate_range``, the zero-point offset).
    ("asym+early0123+updown",
     dict(per_channel=True, bias_correct=False, asym=True,
          strip=("head_", "level0_", "level1_", "level2", "level3",
                 "ida_up", "dla_up"))),
    ("asym+early01+updown",
     dict(per_channel=True, bias_correct=False, asym=True,
          strip=("head_", "level0_", "level1_", "ida_up", "dla_up"))),
    ("asym+early012+updown",
     dict(per_channel=True, bias_correct=False, asym=True,
          strip=("head_", "level0_", "level1_", "level2",
                 "ida_up", "dla_up"))),
    # 9: GPTQ weight rounding (``calibrate_gptq``) on asymmetric activations.
    ("gptq+asym+early0123+updown",
     dict(per_channel=True, bias_correct=False, asym=True, gptq=True,
          strip=("head_", "level0_", "level1_", "level2", "level3",
                 "ida_up", "dla_up"))),
    ("gptq+asym+early012+updown",
     dict(per_channel=True, bias_correct=False, asym=True, gptq=True,
          strip=("head_", "level0_", "level1_", "level2",
                 "ida_up", "dla_up"))),
    ("gptq+asym+early01+updown",
     dict(per_channel=True, bias_correct=False, asym=True, gptq=True,
          strip=("head_", "level0_", "level1_", "ida_up", "dla_up"))),
    # Pseudo-rungs: the bf16 model itself, and with bf16 BatchNorm outputs
    # (read with --baseline f32).
    ("flax-bf16", dict(per_channel=True, bias_correct=False, strip=(),
                       flax_bf16=True)),
    ("flax-bf16-bn16", dict(per_channel=True, bias_correct=False, strip=(),
                            flax_bf16=True, bn16=True)),
    # 10: served-dtype rungs: f32 heads (``f32_paths``), int8 IDA / DLAUp only.
    ("float-f32heads",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "base", "ida_up", "dla_up"),
          f32=("head_",))),
    ("ida-int8",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "base"))),
    ("ida-int8+f32heads",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "base"), f32=("head_",))),
    ("dlaup-int8+f32heads",  # ida_up (the final stage) stays bf16
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "base", "model/ida_up"), f32=("head_",))),
    ("dlaup-int8",
     dict(per_channel=True, bias_correct=False,
          strip=("head_", "base", "model/ida_up"))),
)


@dataclasses.dataclass
class Setup:
    """The run's configurations."""

    object_config: ObjectConfigSet
    model_config: CenternetModelConfig
    train_config: CenternetTrainConfig
    square_config: SquareDatasetConfig


def setup(args) -> Setup:
    """The JAX script's object, model, train and data configurations at
    ``IN_H`` x ``IN_W``: one class, no angle or depth trained, the 4 square
    corners as keypoints with ``--keypoints``."""
    kp = args.keypoints
    oc = ObjectConfigSet(configs=(ObjectConfig(
        id="square",
        yaw=AngleConfig(train=False, modulo=2 * pi),
        pitch=AngleConfig(train=False, modulo=2 * pi),
        roll=AngleConfig(train=False, modulo=2 * pi),
        train_depth=False, train_keypoints=kp,
        keypoints=tuple((x, y, 0.0) for y, x in SQUARE_CORNERS) if kp else None,
    ),))
    mc = CenternetModelConfig(
        in_h=IN_H, in_w=IN_W, backbone_heights=(2, 2, 2, 2, 2), backbone_channels=(128,) * 6,
        downsamples=2, angle_bin_overlap=pi / 3)
    tc = CenternetTrainConfig(
        lr=args.lr, batch_size=args.batch_size, n_batches=0, n_epochs=1,
        heatmap_focal_loss_a=2.0, heatmap_focal_loss_b=4.0, heatmap_sigma_factor=0.1,
        keypoint_heatmap_sigma=2.0, keypoint_affinity_sigma=2.0,
        loss_lambda_keypoint_heatmap=1.0, loss_lambda_keypoint_affinity=1.0,
        loss_lambda_size=0.1, loss_lambda_offset=1.0, loss_lambda_angle=1.0,
        loss_lambda_depth=1.0, max_objects=4, max_keypoints=16 if kp else 4)
    square = SquareDatasetConfig(in_h=IN_H, in_w=IN_W, max_objects=4, min_side=24, max_side=96,
                                 rotate=False, keypoints=kp)
    return Setup(oc, mc, tc, square)


def build_model(object_config: ObjectConfigSet, device, dtype=torch.bfloat16,
                bn_out=torch.float32, init: str = "flax") -> CenterpointDLA34:
    """The script's net: the plain-IDA ``CenterpointDLA34`` in ``dtype``,
    initialised from ``INIT_SEED`` by the flax initialisers, as the JAX
    script trains it (a net whose weights are loaded next takes the
    cheaper ``init="lecun"``)."""
    return CenterpointDLA34(object_config, device=device, deform=False, dtype=dtype,
                            bn_out=bn_out, init=init,
                            generator=torch.Generator().manual_seed(INIT_SEED))


def train_model(args, s: Setup, device, log: Callable[[str], None] = print) -> CenterpointDLA34:
    """``args.steps`` Adam steps (clipped at 1.0) of the bf16 net on fresh
    batches of squares from ``default_rng(TRAIN_SEED)``, the total loss
    logged every ``LOG_EVERY`` steps; the net comes back in eval mode."""
    model = build_model(s.object_config, device)
    state = TrainState(model, adam_with_clip(model.parameters(), args.lr, 1.0))
    step_fn = make_centernet_train_step(s.model_config, s.train_config, s.object_config)
    rng = np.random.default_rng(TRAIN_SEED)
    log("training DLA-34 on synthetic squares...")
    for step in range(args.steps):
        img, truth = generate_square_batch(rng, args.batch_size, s.square_config)
        img = torch.from_numpy(img).to(device).permute(0, 3, 1, 2).contiguous()
        state, losses = step_fn(state, img, truth.to(device))
        if step % LOG_EVERY == 0:
            log(f"step {step}: total={float(losses.total):.4f}")
    return model.eval()


def save_model(path, model: CenterpointDLA34) -> None:
    """``--save-model``: the JAX script's pickle of the variables tree."""
    write_flax_variables(path, centerpoint_flax_from_state_dict(model.state_dict()))


def load_model(path, object_config: ObjectConfigSet, device) -> CenterpointDLA34:
    """``--load-model``: the bf16 net on the pickled variables, eval mode."""
    model = build_model(object_config, device, init="lecun")
    model.load_state_dict(centerpoint_state_dict_from_flax(read_flax_variables(path)))
    return model.eval()


def image(frames: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 NHWC frames -> the NCHW image in [0, 1] (``/ 255`` in
    ``dtype``, no resize and no normalisation, as the JAX script feeds
    its net)."""
    return frames.permute(0, 3, 1, 2).to(dtype) / 255.0


def _numpy(tree):
    """A decode's dataclass (nested) with every tensor as numpy."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _numpy(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def pair_deltas_kp(dets_a, dets_b) -> dict:
    """Keypoint-pipeline agreement (the JAX script's closure): greedy
    same-label center match of the parent detections within 0.05, then per
    matched pair every keypoint slot both sides decoded (position, score)
    and the parent's score, center and size; ``dets_a`` and ``dets_b`` are
    lists of numpy ``KeypointDetections``."""
    kc_d, ks_d, center_d, score_d, size_d = [], [], [], [], []
    matched = total = kp_total = kp_matched = 0
    for da, db in zip(dets_a, dets_b):
        pa, pb = da.detections, db.detections
        for b in range(pa.valid.shape[0]):
            ia = [i for i in range(pa.valid.shape[1]) if pa.valid[b, i]]
            ib = [j for j in range(pb.valid.shape[1]) if pb.valid[b, j]]
            total += len(ia)
            used = set()
            for i in ia:
                best, best_dist = None, 0.05
                for j in ib:
                    if j in used or pa.label[b, i] != pb.label[b, j]:
                        continue
                    dist = float((pa.y[b, i] - pb.y[b, j]) ** 2
                                 + (pa.x[b, i] - pb.x[b, j]) ** 2) ** 0.5
                    if dist < best_dist:
                        best, best_dist = j, dist
                if best is None:
                    continue
                used.add(best)
                matched += 1
                j = best
                center_d.append(best_dist)
                score_d.append(abs(float(pa.score[b, i]) - float(pb.score[b, j])))
                size_d.append(max(abs(float(pa.h[b, i] - pb.h[b, j])),
                                  abs(float(pa.w[b, i] - pb.w[b, j]))))
                for sl in range(da.keypoint_valid.shape[2]):
                    va = bool(da.keypoint_valid[b, i, sl])
                    vb = bool(db.keypoint_valid[b, j, sl])
                    kp_total += int(va)
                    if not (va and vb):
                        continue
                    kp_matched += 1
                    kc_d.append(float((da.keypoint_y[b, i, sl] - db.keypoint_y[b, j, sl]) ** 2
                                      + (da.keypoint_x[b, i, sl] - db.keypoint_x[b, j, sl]) ** 2)
                                ** 0.5)
                    ks_d.append(abs(float(da.keypoint_score[b, i, sl])
                                    - float(db.keypoint_score[b, j, sl])))
    stats = {
        "total": total,
        "matched_fraction": round(matched / max(total, 1), 4),
        "kp_total": kp_total,
        "kp_matched_fraction": round(kp_matched / max(kp_total, 1), 4),
    }
    for vals, what in ((center_d, "center"), (score_d, "score"), (size_d, "size"),
                       (kc_d, "kp_center"), (ks_d, "kp_score")):
        if not vals:
            continue
        for pct in (50, 95):
            stats[f"{what}_delta_p{pct}"] = round(float(np.percentile(vals, pct)), 6)
        stats[f"{what}_delta_max"] = round(float(np.max(vals)), 6)
    if score_d and kc_d:
        stats["all_deltas_le_1e3"] = bool(
            np.percentile(score_d, 95) <= 1e-3 and np.percentile(center_d, 95) <= 1e-3
            and np.percentile(size_d, 95) <= 1e-3 and np.percentile(kc_d, 95) <= 1e-3
            and np.percentile(ks_d, 95) <= 1e-3)
    return stats


def _emit(args, result: dict) -> dict:
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(result, fp, indent=2)
    return result


def run_sweep(args, model, cal_images, make_chain_fn, collect, pair_deltas, dets_ref, truths,
              seq_calibrate, bn16_pipeline, raw_pipeline) -> dict:
    """Walk ``SWEEP_LADDER`` (``--rungs`` picks rungs), reporting each
    rung's decoded agreement with the reference, as the JAX
    ``_run_sweep``; every calibration reads the bf16 net on the
    calibration images."""
    paths = centerpoint_calibration_paths
    print("calibrating (absmax + per-channel)...", flush=True)
    scales_absmax = calibrate(model, cal_images, percentile=args.percentile, paths_of=paths)
    scales_pc = calibrate(model, cal_images, per_channel=True, percentile=args.percentile,
                          paths_of=paths)
    ladder = [(name, cfg) for name, cfg in SWEEP_LADDER
              if args.rungs is None or name in args.rungs]
    scales_mse = None
    if any(cfg.get("mse") for _, cfg in ladder):
        print("refining scales (MSE-optimal clipping)...", flush=True)
        scales_mse = refine_scales_mse(model, cal_images, scales_pc, paths_of=paths)
    ranges_all = None
    if any(cfg.get("asym") for _, cfg in ladder):
        print("calibrating (min, max) ranges for asymmetric...", flush=True)
        ranges_all = calibrate_range(model, cal_images, paths_of=paths)

    rows = []
    for name, cfg in ladder:
        base = scales_pc if cfg["per_channel"] else scales_absmax
        if cfg.get("mse"):
            base = scales_mse
        scales = strip_scales(base, cfg["strip"]) if cfg["strip"] else base
        if cfg.get("margin"):
            scales = {k: v * cfg["margin"] for k, v in scales.items()}
        ranges = None
        if cfg.get("asym"):
            ranges = {k: v for k, v in ranges_all.items() if k in scales}
        wq = None
        if cfg.get("gptq"):
            print(f"  GPTQ weight rounding for {name}...", flush=True)
            wq = calibrate_gptq(model, cal_images, ranges if ranges is not None else scales,
                                paths_of=paths)
        corr = gains = None
        if cfg["bias_correct"]:
            print(f"  bias corrections for {name}...", flush=True)
            corr = calibrate_bias_correction(model, cal_images, scales, paths_of=paths)
        if cfg.get("seq"):
            print(f"  sequential {cfg['seq']} recalibration for {name}...", flush=True)
            gains, corr = seq_calibrate(scales, cfg["seq"])
        if cfg.get("flax_bf16"):
            tag = "bn16" if cfg.get("bn16") else "bf16"
            print(f"rung flax-{tag} (serving pipeline, no chain)...", flush=True)
            scales = {}
            dets = collect(bn16_pipeline if cfg.get("bn16") else raw_pipeline)
        else:
            f32 = cfg.get("f32", ())
            print(f"rung {name}: {len(scales)} int8 convs{f' (f32: {f32})' if f32 else ''}...",
                  flush=True)
            dets = collect(make_chain_fn(scales, corr, gains, ranges, wq, f32_paths=f32))
        stats = pair_deltas(dets_ref, dets)
        stats["name"] = name
        stats["int8_convs"] = len(scales)
        rows.append(stats)
        print(f"  match={stats['matched_fraction']}"
              f" score_p95={stats.get('score_delta_p95')}"
              f" center_p95={stats.get('center_delta_p95')}"
              f" size_p95={stats.get('size_delta_p95')}"
              f" le_1e3={stats.get('all_deltas_le_1e3')}", flush=True)

    return _emit(args, {"sweep": rows, "n_eval_samples": len(truths),
                        "bf16_detections": rows[0]["total"] if rows else 0,
                        "percentile": args.percentile})


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags but ``--early-pack``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--eval-batches", type=int, default=32,
                   help="eval set = eval_batches * batch_size images (default 512 images at "
                        "batch 16)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--percentile", type=float, default=None,
                   help="activation calibration percentile (None=absmax)")
    p.add_argument("--per-channel", action="store_true",
                   help="per-input-channel activation scales")
    p.add_argument("--bias-correct", action="store_true",
                   help="fold E[quant error] into conv epilogues")
    p.add_argument("--bf16-heads", action="store_true",
                   help="leave the output head convs in bf16")
    p.add_argument("--cal-batches", type=int, default=4,
                   help="number of eval batches used for calibration")
    p.add_argument("--bootstrap", type=int, default=1000,
                   help="bootstrap resamples for AP CIs (0=off)")
    p.add_argument("--save-model", default=None,
                   help="save the trained variables (the JAX script's pickle)")
    p.add_argument("--load-model", default=None)
    p.add_argument("--sweep", action="store_true",
                   help="walk the mixed-precision ladder and report decoded deltas per rung")
    p.add_argument("--rungs", nargs="*", default=None,
                   help="subset of SWEEP_LADDER rung names to run")
    p.add_argument("--qat-steps", type=int, default=0,
                   help="QAT distillation fine-tuning (serving/qat.py), then the int8 chain's "
                        "decoded deltas against the original bf16 baseline")
    p.add_argument("--qat-lr", type=float, default=2e-5)
    p.add_argument("--qat-strip", default="head_",
                   help="comma-separated path substrings kept bf16 during QAT and in the "
                        "evaluated chain")
    p.add_argument("--qat-size-weight", type=float, default=1.0,
                   help="distillation loss weight on the size head")
    p.add_argument("--qat-save", default=None, help="save QAT fine-tuned variables (pickle)")
    p.add_argument("--qat-load", default=None, help="skip fine-tuning, load QAT variables")
    p.add_argument("--baseline", choices=("bf16", "f32"), default="bf16",
                   help="float reference for the decoded-delta comparison: the bf16 model "
                        "(default) or the f32 model")
    p.add_argument("--keypoints", action="store_true",
                   help="keypoint-pipeline parity: train with the 4 square-corner keypoints "
                        "and compare decode_keypoints' outputs between the reference and the "
                        "int8 chain")
    p.add_argument("--out", default=None)
    return p


def main(argv=None, device=DEFAULT_DEVICE) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    if args.keypoints and not args.sweep:
        ap.error("--keypoints requires --sweep (decoded-delta rows; the AP path decodes plain "
                 "detections only)")
    device = resolve_device(device)
    s = setup(args)
    oc, mc = s.object_config, s.model_config

    if args.load_model:
        model = load_model(args.load_model, oc, device)
        print(f"loaded trained variables from {args.load_model}", flush=True)
    else:
        model = train_model(args, s, device, log=lambda line: print(line, flush=True))
        if args.save_model:
            save_model(args.save_model, model)
            print(f"saved trained variables to {args.save_model}", flush=True)
    model_f32 = build_model(oc, device, dtype=torch.float32, init="lecun")
    model_bn16 = build_model(oc, device, bn_out=torch.bfloat16, init="lecun")
    for m in (model_f32, model_bn16):
        m.load_state_dict(model.state_dict())
        m.eval()

    projection = torch.tensor([[500.0, 0.0, IN_W / 2], [0.0, 500.0, IN_H / 2],
                               [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)

    def decode_fn(prediction):
        if args.keypoints:
            return decode_keypoints(prediction, mc, oc, projection, n_detections=10,
                                    keypoint_n_detections=50, score_threshold=0.3,
                                    keypoint_score_threshold=0.3)
        return decode(prediction, mc, 10, 0.3)

    def model_pipeline(net, dtype=torch.bfloat16):
        def pipeline(frames):
            with torch.inference_mode():
                return decode_fn(net(image(frames, dtype)))
        return pipeline

    raw_pipeline = model_pipeline(model)
    bn16_pipeline = model_pipeline(model_bn16)
    f32_forward = model_pipeline(model_f32, torch.float32)

    def f32_pipeline(frames):
        with f32_convs():
            return f32_forward(frames)

    eval_rng = np.random.default_rng(EVAL_SEED)
    eval_sets = [generate_square_batch(eval_rng, args.batch_size, s.square_config)
                 for _ in range(args.eval_batches)]
    eval_frames = [torch.from_numpy((np.clip(img, 0, 1) * 255).astype(np.uint8)).to(device)
                   for img, _ in eval_sets]

    def collect(fn) -> List:
        out = []
        for frames in eval_frames:
            d = fn(frames)
            if args.keypoints:
                out.append(_numpy(d))
                continue
            out.extend(detections_from_arrays(*(getattr(d, f).cpu().numpy() for f in (
                "valid", "score", "label", "y", "x", "h", "w"))))
        return out

    pair_deltas = pair_deltas_kp if args.keypoints else decoded_pair_deltas
    print(f"decoding {args.baseline} reference...", flush=True)
    dets_ref = collect(f32_pipeline if args.baseline == "f32" else raw_pipeline)
    truths = []
    for _, truth in eval_sets:
        truths.extend(truths_from_batch(truth))
    cal_frames = [f[:4] for f in eval_frames[:args.cal_batches]]
    cal_images = [image(f) for f in cal_frames]

    def make_chain_fn(scales, corrections=None, gains=None, ranges=None, wq_override=None,
                      net=None, f32_paths=()):
        ctx = ChainCtx(model if net is None else net, scales, dtype=torch.bfloat16,
                       join_dtype=None, path_of=centerpoint_flax_path, gains=gains,
                       corrections=corrections, ranges=ranges, wq_override=wq_override,
                       f32_paths=f32_paths)
        forward = dla34_chain_forward(ctx)

        def chain_pipeline(frames):
            with torch.inference_mode():
                return decode_fn(forward(image(frames)))
        return chain_pipeline

    def seq_calibrate(scales, mode):
        def build_forward(ctx):
            forward = dla34_chain_forward(ctx)
            return lambda f: forward(image(f))
        return calibrate_sequential(build_forward, model, scales, torch.cat(cal_frames),
                                    mode=mode, dtype=torch.bfloat16,
                                    path_of=centerpoint_flax_path)

    def ap_of(dets, indices=None):
        indices = range(len(truths)) if indices is None else indices
        _, precision, recall = precision_recall_curve(
            [dets[i] for i in indices], [truths[i] for i in indices], iou_match(0.5))
        return average_precision(precision, recall)

    if args.qat_steps or args.qat_load:
        strip = tuple(t for t in args.qat_strip.split(",") if t)
        print(f"calibrating per-channel scales (bf16 tail: {strip})...", flush=True)
        scales = strip_scales(calibrate(model, cal_images, per_channel=True,
                                        paths_of=centerpoint_calibration_paths), strip)
        if args.qat_load:
            qat_model = load_model(args.qat_load, oc, device)
            print(f"loaded QAT variables from {args.qat_load}", flush=True)
        else:
            qat_rng = np.random.default_rng(QAT_SEED)

            def qat_batches():
                while True:
                    img, _ = generate_square_batch(qat_rng, args.batch_size, s.square_config)
                    frames = torch.from_numpy((np.clip(img, 0, 1) * 255).astype(np.uint8))
                    yield image(frames.to(device), torch.float32)

            print(f"QAT distillation: {args.qat_steps} steps, {len(scales)} int8 convs, "
                  f"lr {args.qat_lr}...", flush=True)
            qat_model = qat_distill(model, scales, qat_batches(), steps=args.qat_steps,
                                    lr=args.qat_lr, leaf_weights={"size": args.qat_size_weight},
                                    paths_of=centerpoint_calibration_paths)
            if args.qat_save:
                save_model(args.qat_save, qat_model)
                print(f"saved QAT variables to {args.qat_save}", flush=True)
        print(f"evaluating QAT chain ({len(scales)} int8 convs) vs ORIGINAL bf16 baseline...",
              flush=True)
        dets_qat = collect(make_chain_fn(scales, net=qat_model))
        result = {"mode": "qat", "qat_steps": args.qat_steps, "qat_lr": args.qat_lr,
                  "qat_strip": strip, "int8_convs": len(scales),
                  "n_eval_samples": len(truths), **pair_deltas(dets_ref, dets_qat)}
        if not args.keypoints:
            result["bf16_ap_iou0.5"] = round(ap_of(dets_ref), 4)
            result["qat_int8_ap_iou0.5"] = round(ap_of(dets_qat), 4)
        return _emit(args, result)

    if args.sweep:
        return run_sweep(args, model, cal_images, make_chain_fn, collect, pair_deltas, dets_ref,
                         truths, seq_calibrate, bn16_pipeline, raw_pipeline)

    print("calibrating int8...", flush=True)
    scales = calibrate(model, cal_images, percentile=args.percentile,
                       per_channel=args.per_channel, paths_of=centerpoint_calibration_paths)
    if args.bf16_heads:
        scales = strip_scales(scales, ("head_",))
    corrections = None
    if args.bias_correct:
        print("computing bias corrections...", flush=True)
        corrections = calibrate_bias_correction(model, cal_images, scales,
                                                paths_of=centerpoint_calibration_paths)
    int8_fn = model_pipeline(quantized_call(model, scales, paths_of=centerpoint_calibration_paths))
    chain_fn = make_chain_fn(scales, corrections)

    print("decoding int8 (per-layer + chain)...", flush=True)
    dets_int8 = collect(int8_fn)
    dets_chain = collect(chain_fn)
    result = {"steps": args.steps, "quantized_convs": len(scales),
              "percentile": args.percentile, "per_channel": args.per_channel,
              "bias_correct": args.bias_correct, "bf16_heads": args.bf16_heads,
              "n_eval_samples": len(truths)}
    boot_rng = np.random.default_rng(BOOTSTRAP_SEED)
    for name, dets in (("bf16", dets_ref), ("int8", dets_int8), ("int8_chain", dets_chain)):
        result[f"{name}_ap_iou0.5"] = round(ap_of(dets), 4)
        if args.bootstrap:
            # Images resampled, not detections: AP is a function of the image set.
            aps = [ap_of(dets, boot_rng.integers(0, len(truths), len(truths)))
                   for _ in range(args.bootstrap)]
            result[f"{name}_ap_ci95"] = [round(float(np.percentile(aps, 2.5)), 4),
                                         round(float(np.percentile(aps, 97.5)), 4)]
    for dets, tag in ((dets_int8, "int8"), (dets_chain, "int8_chain")):
        stats = decoded_pair_deltas(dets_ref, dets)
        result["bf16_detections"] = stats.pop("total")
        for k, v in stats.items():
            result[f"{tag}_{k}"] = v
    return _emit(args, result)


if __name__ == "__main__":
    main()
