"""Decoded parity of the served int8 YOLACT on trained weights (counterpart
of ``tauv_vision_tpu/scripts/yolact_parity_check.py``, with its flags).

Trains the served architecture (ResNet-18 trunk, 256-wide FPN, 8
prototypes, the one-layer shared prediction head) on one class of
synthetic instance squares at its 640x360
(``data/synthetic.generate_square_seg_batch``, seed 11) through the bf16
train step and Adam of ``train/``, or loads weights (``--load-model``, the
pickle both stacks read and write: ``weights.read_flax_variables``), then
decodes a seeded evaluation set (``--eval-batches`` batches of 16, seed
2024) through the bf16 net (or the f32 one, ``--baseline f32``) and
through each rung of ``LADDER``: the int8 chain
(``quantize_chain.yolact_chain_forward``) on per-channel ``calibrate``
scales of the bf16 net on the first ``--cal-frames`` frames, the rung's
paths stripped to bf16 (or f32), then ``decode_yolact`` (top 20, IoU 0.5,
confidence 0.5; kernel B on the card).  Each rung's row is
``pair_deltas`` of its detections against the reference's: boxes,
scores and masks.

The ``pc+outputs+head+int8T`` rung changes nothing, as in the JAX
package: the JAX chain takes its int8 transpose only for a transposed
conv with a scale (``tauv_vision_tpu/serving/quantize_chain.py:303-311``),
and ``calibrate`` records none (``tauv_vision_tpu/serving/quantize.py:40-45``).
So on ``calibrate``'s scales the rung runs the bf16 transposes of
``pc+outputs+head`` and its row is that rung's.  The port passes the
scales on unchanged and launches no kernel D; ``configs.int8_knobs``
rules ``bench.py --int8-transpose`` the same way.

On the card:

  python -m tauv_vision_tpu_torch.scripts.yolact_parity_check \\
      --steps 300 --out yolact_parity.json

``main(argv, device="cpu")`` runs it on the CPU; the frame size is the
module's ``IN_H`` and ``IN_W``, read at each call, which a small run sets
first.  The result is JSON with the JAX script's keys.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Tuple

import numpy as np
import torch

from tauv_vision_tpu_torch.configs.yolact import YolactModelConfig, YolactTrainConfig
from tauv_vision_tpu_torch.data.synthetic import (
    SquareDatasetConfig,
    generate_square_seg_batch,
    seg_truth,
)
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.scripts.quantize_accuracy_check import _emit, _numpy, image
from tauv_vision_tpu_torch.serving.quantize import calibrate, strip_scales
from tauv_vision_tpu_torch.serving.quantize_chain import ChainCtx, f32_convs, yolact_chain_forward
from tauv_vision_tpu_torch.serving.yolact_decode import decode_yolact
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import make_yolact_train_step
from tauv_vision_tpu_torch.weights import (
    read_flax_variables,
    write_flax_variables,
    yolact_flax_from_state_dict,
    yolact_flax_path,
    yolact_state_dict_from_flax,
)

IN_H, IN_W = 360, 640
INIT_SEED = 0        # the JAX script's jax.random.key(0)
TRAIN_SEED = 11
EVAL_SEED = 2024
EVAL_BATCH = 16      # frames of an evaluation batch, whatever --batch-size
LOG_EVERY = 25
TOP_K, IOU_THRESHOLD, CONFIDENCE_THRESHOLD = 20, 0.5, 0.5

# Which chain stages stay int8: the JAX script's ``LADDER``.  An entry's
# second element names the paths stripped to bf16, a third the stripped
# paths that run in f32, a fourth the rung's mode: "flax_bf16" (the bf16
# net, no chain), "int8_transpose" (the JAX chain's ``int8_transpose=
# "phase-xla"``, a no-op on ``calibrate``'s scales: see the module
# docstring) or "join16" (bf16 residual joins and feature taps).
LADDER = (
    ("pc_all", ()),
    ("pc+outputs",
     ("prediction_head/classification", "prediction_head/box",
      "prediction_head/mask", "protonet/output")),
    ("pc+outputs+head",
     ("prediction_head", "protonet/output")),
    ("pc+outputs+protonet",
     ("prediction_head/classification", "prediction_head/box",
      "prediction_head/mask", "protonet/")),
    ("pc+outputs+fpn",
     ("prediction_head/classification", "prediction_head/box",
      "prediction_head/mask", "protonet/output", "fpn/")),
    ("pc+outputs+backbone",
     ("prediction_head/classification", "prediction_head/box",
      "prediction_head/mask", "protonet/output", "backbone/")),
    ("flax-bf16", (), (), "flax_bf16"),
    ("pc+f32head",
     ("prediction_head", "protonet/output"),
     ("prediction_head", "protonet/output")),
    ("float+f32head",
     ("backbone", "fpn", "protonet", "prediction_head"),
     ("prediction_head", "protonet/output")),
    ("pc+outputs+head+int8T",
     ("prediction_head", "protonet/output"), (), "int8_transpose"),
    ("pc+outputs+head+join16",
     ("prediction_head", "protonet/output"), (), "join16"),
)


def pair_deltas(dets_a, dets_b) -> dict:
    """Greedy same-label nearest-center matching (within 0.05) between two
    decoded sets, the JAX script's ``pair_deltas``: the matched fraction,
    center, score and size deltas (p50, p95, max), the mask deltas where
    either mask exceeds 0.05 (p50, p95) and the masks' IoU at 0.5 (mean).
    ``dets_a`` and ``dets_b`` are lists of numpy ``YolactDetections``, a
    batch each."""
    center_d, score_d, size_d, mask_d, mask_iou = [], [], [], [], []
    matched = total = 0
    for da, db in zip(dets_a, dets_b):
        va, vb = np.asarray(da.valid), np.asarray(db.valid)
        for b in range(va.shape[0]):
            ia = [i for i in range(va.shape[1]) if va[b, i]]
            ib = [j for j in range(vb.shape[1]) if vb[b, j]]
            total += len(ia)
            used = set()
            for i in ia:
                best, best_dist = None, 0.05
                for j in ib:
                    if j in used or int(db.label[b, j]) != int(da.label[b, i]):
                        continue
                    dist = float((da.box[b, i, 0] - db.box[b, j, 0]) ** 2
                                 + (da.box[b, i, 1] - db.box[b, j, 1]) ** 2) ** 0.5
                    if dist < best_dist:
                        best, best_dist = j, dist
                if best is None:
                    continue
                used.add(best)
                matched += 1
                j = best
                center_d.append(best_dist)
                score_d.append(abs(float(da.score[b, i]) - float(db.score[b, j])))
                size_d.append(max(abs(float(da.box[b, i, 2] - db.box[b, j, 2])),
                                  abs(float(da.box[b, i, 3] - db.box[b, j, 3]))))
                ma = np.asarray(da.mask[b, i], np.float32)
                mb = np.asarray(db.mask[b, j], np.float32)
                sel = np.maximum(ma, mb) > 0.05
                if sel.any():
                    mask_d.append(np.abs(ma - mb)[sel])
                ba, bb = ma > 0.5, mb > 0.5
                union = (ba | bb).sum()
                if union:
                    mask_iou.append((ba & bb).sum() / union)

    stats = {"total": total, "matched_fraction": round(matched / max(total, 1), 4)}
    for vals, what in ((center_d, "center"), (score_d, "score"), (size_d, "size")):
        if not vals:
            continue
        for pct in (50, 95):
            stats[f"{what}_delta_p{pct}"] = round(float(np.percentile(vals, pct)), 6)
        stats[f"{what}_delta_max"] = round(float(np.max(vals)), 6)
    if mask_d:
        pooled = np.concatenate(mask_d)
        stats["mask_delta_p50"] = round(float(np.percentile(pooled, 50)), 6)
        stats["mask_delta_p95"] = round(float(np.percentile(pooled, 95)), 6)
        stats["mask_iou_mean"] = round(float(np.mean(mask_iou)), 4)
    if score_d:
        stats["all_deltas_le_1e3"] = bool(
            np.percentile(score_d, 95) <= 1e-3 and np.percentile(center_d, 95) <= 1e-3
            and np.percentile(size_d, 95) <= 1e-3)
    return stats


def model_config() -> YolactModelConfig:
    """The served architecture (``configs.yolact_config``'s widths) on the
    1-class task at ``IN_H`` x ``IN_W``, as the JAX script builds it."""
    return YolactModelConfig(
        in_w=IN_W, in_h=IN_H, feature_depth=256, n_classes=1, n_prototype_masks=8,
        n_masknet_layers_pre_upsample=1, n_masknet_layers_post_upsample=1,
        n_prediction_head_layers=1, n_classification_layers=0, n_box_layers=0,
        n_mask_layers=0, n_fpn_downsample_layers=2, anchor_scales=(24, 48, 96, 192, 384),
        anchor_aspect_ratios=(1.0,), box_variances=(0.1, 0.2), iou_pos_threshold=0.4,
        iou_neg_threshold=0.3, negative_example_ratio=3)


def square_config() -> SquareDatasetConfig:
    """The JAX script's squares: up to 4 a frame, sides 32-128 pixels."""
    return SquareDatasetConfig(in_h=IN_H, in_w=IN_W, max_objects=4, min_side=32, max_side=128,
                               rotate=False)


def build_model(cfg: YolactModelConfig, device, dtype=torch.bfloat16,
                init: str = "flax") -> Yolact:
    """The script's net in ``dtype``, initialised from ``INIT_SEED`` by the
    flax initialisers, as the JAX script trains it (a net whose weights
    are loaded next takes the cheaper ``init="lecun"``)."""
    return Yolact(cfg, generator=torch.Generator().manual_seed(INIT_SEED), device=device,
                  dtype=dtype, init=init)


def train_model(args, cfg: YolactModelConfig, square: SquareDatasetConfig, device,
                log: Callable[[str], None] = print) -> Yolact:
    """``args.steps`` Adam steps (clipped at 1.0) of the bf16 net on fresh
    batches of squares from ``default_rng(TRAIN_SEED)``, the total loss
    logged every ``LOG_EVERY`` steps; the net comes back in eval mode."""
    tc = YolactTrainConfig(lr=args.lr, momentum=0.9, weight_decay=0.0, grad_max_norm=1.0,
                           n_epochs=1, batch_size=args.batch_size, epoch_n_batches=1,
                           max_objects=square.max_objects)
    model = build_model(cfg, device)
    state = TrainState(model, adam_with_clip(model.parameters(), args.lr, 1.0))
    step_fn = make_yolact_train_step(cfg, tc)
    rng = np.random.default_rng(TRAIN_SEED)
    log("training YOLACT on synthetic seg squares...")
    for step in range(args.steps):
        img, fields = generate_square_seg_batch(rng, args.batch_size, square)
        img = torch.from_numpy(img).to(device).permute(0, 3, 1, 2).contiguous()
        state, losses = step_fn(state, img, seg_truth(fields).to(device))
        if step % LOG_EVERY == 0:
            log(f"step {step}: total={float(losses.total):.4f}")
    return model.eval()


def save_model(path, model: Yolact) -> None:
    """``--save-model``: the JAX script's pickle of the variables tree."""
    write_flax_variables(path, yolact_flax_from_state_dict(model.state_dict()))


def load_model(path, cfg: YolactModelConfig, device, dtype=torch.bfloat16) -> Yolact:
    """``--load-model``: the net in ``dtype`` on the pickled variables,
    eval mode."""
    model = build_model(cfg, device, dtype=dtype, init="lecun")
    model.load_state_dict(yolact_state_dict_from_flax(read_flax_variables(path)))
    return model.eval()


def rung_forward(model: Yolact, scales: dict, entry) -> Tuple[Callable, int]:
    """(a forward of NCHW images, its int8 convs) of the chain rung
    ``entry`` of ``LADDER``: the int8 chain on ``scales`` with the entry's
    paths stripped (f32 where it says), bf16 joins on "join16", f32 joins
    elsewhere, as the JAX script's ``yolact_chain_forward``;
    "int8_transpose" passes the scales on unchanged (the module
    docstring)."""
    name, strip = entry[0], entry[1]
    f32_paths = entry[2] if len(entry) > 2 else ()
    mode = entry[3] if len(entry) > 3 else None
    if mode == "flax_bf16":
        raise ValueError(f"{name} is the bf16 net, not a chain")
    ctx = ChainCtx(model, strip_scales(scales, strip) if strip else scales,
                   dtype=torch.bfloat16,
                   join_dtype=torch.bfloat16 if mode == "join16" else None,
                   path_of=yolact_flax_path, f32_paths=f32_paths)
    return yolact_chain_forward(ctx), len(ctx.scales)


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--eval-batches", type=int, default=32,
                   help="eval set = eval_batches * 16 images")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cal-frames", type=int, default=16)
    p.add_argument("--rungs", nargs="*", default=None)
    p.add_argument("--save-model", default=None)
    p.add_argument("--load-model", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--baseline", choices=("bf16", "f32"), default="bf16",
                   help="f32: compare rungs against the float32 pipeline (the served-dtype "
                        "certification frame)")
    return p


def main(argv=None, device=DEFAULT_DEVICE) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(device)
    cfg, square = model_config(), square_config()

    if args.load_model:
        model = load_model(args.load_model, cfg, device)
        print(f"loaded trained variables from {args.load_model}", flush=True)
    else:
        model = train_model(args, cfg, square, device, log=lambda line: print(line, flush=True))
        if args.save_model:
            save_model(args.save_model, model)
            print(f"saved trained variables to {args.save_model}", flush=True)

    def decoded(forward, dtype=torch.bfloat16):
        def pipeline(frames):
            with torch.inference_mode():
                return decode_yolact(forward(image(frames, dtype)), cfg, top_k=TOP_K,
                                     iou_threshold=IOU_THRESHOLD,
                                     confidence_threshold=CONFIDENCE_THRESHOLD)
        return pipeline

    raw_pipeline = decoded(model)
    if args.baseline == "f32":
        model_f32 = build_model(cfg, device, dtype=torch.float32, init="lecun")
        model_f32.load_state_dict(model.state_dict())
        f32_forward = decoded(model_f32.eval(), torch.float32)

    def f32_pipeline(frames):
        with f32_convs():
            return f32_forward(frames)

    eval_rng = np.random.default_rng(EVAL_SEED)
    eval_frames = []
    for _ in range(args.eval_batches):
        img, _ = generate_square_seg_batch(eval_rng, EVAL_BATCH, square)
        eval_frames.append(torch.from_numpy((np.clip(img, 0, 1) * 255).astype(np.uint8))
                           .to(device))

    def collect(fn) -> List:
        return [_numpy(fn(frames)) for frames in eval_frames]

    print(f"decoding {args.baseline} reference...", flush=True)
    dets_ref = collect(f32_pipeline if args.baseline == "f32" else raw_pipeline)

    print("calibrating (per-channel)...", flush=True)
    cal = [image(f[:args.cal_frames]) for f in eval_frames[:1]]
    scales_pc = calibrate(model, cal, per_channel=True, paths_of=yolact_flax_path)

    rows = []
    for entry in LADDER:
        name = entry[0]
        if args.rungs is not None and name not in args.rungs:
            continue
        if len(entry) > 3 and entry[3] == "flax_bf16":
            print("rung flax-bf16 (serving pipeline, no chain)...", flush=True)
            stats = pair_deltas(dets_ref, collect(raw_pipeline))
            stats["name"] = name
            stats["int8_convs"] = 0
            rows.append(stats)
            print(f"  score_p95={stats.get('score_delta_p95')}"
                  f" center_p95={stats.get('center_delta_p95')}"
                  f" size_p95={stats.get('size_delta_p95')}"
                  f" mask_iou={stats.get('mask_iou_mean')}"
                  f" le_1e3={stats.get('all_deltas_le_1e3')}", flush=True)
            continue
        forward, n_int8 = rung_forward(model, scales_pc, entry)
        f32_paths = entry[2] if len(entry) > 2 else ()
        print(f"rung {name}: {n_int8} int8 convs{f' (f32: {f32_paths})' if f32_paths else ''}...",
              flush=True)
        stats = pair_deltas(dets_ref, collect(decoded(forward)))
        stats["name"] = name
        stats["int8_convs"] = n_int8
        rows.append(stats)
        print(f"  match={stats['matched_fraction']}"
              f" score_p95={stats.get('score_delta_p95')}"
              f" center_p95={stats.get('center_delta_p95')}"
              f" size_p95={stats.get('size_delta_p95')}"
              f" mask_p95={stats.get('mask_delta_p95')}"
              f" mask_iou={stats.get('mask_iou_mean')}"
              f" le_1e3={stats.get('all_deltas_le_1e3')}", flush=True)

    return _emit(args, {"sweep": rows, "n_eval_images": EVAL_BATCH * args.eval_batches})


if __name__ == "__main__":
    main()
