#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Two served paths, each CenterNet beside the same YOLACT: ``plain_ida``,
the CenterpointDLA34 with plain-conv IDA that ``bench.py`` serves with no
flags, and ``dcn_ida``, the reference's deployed CenterpointDLA34 with
DCNv2 in its 16 IDA blocks (``deform=True``, kernel E).

Phases, each fatal on failure (exit code != 0, no result line):

1. device: require CUDA, print the card and its power limit, and turn
   TF32 off (this slice is f32);
2. build: compile the port's CUDA kernels from ``tauv_vision_tpu_torch/
   csrc`` (one nvcc a source, in parallel) and print the build time and
   each kernel's registers and spills;
3. check: each kernel against its plain PyTorch version on the card at
   the served shapes (batch 8), tolerances printed beside each result;
   kernel E at each distinct shape of the 16 DCN calls of one forward,
   with the net's own offsets and masks, with planted offsets of up to
   40 cells and without a mask;
4. serve: for each path, the served pair at full width on seeded random
   weights answers 4 requests of 8 random 640x480 uint8 frames through
   ``make_combined_pipeline``; outputs must be finite and well shaped,
   the launch counters (zeroed just before the path) must show every
   kernel of the path on every request, and the same frames through the
   plain versions must decode the same;
5. time: each kernel against its plain version (CUDA events, after
   warm-up), each path's frames/s at batch 32, and its stages one by one.

Prints one JSON line describing the kernels, then, as the last line,
``{"ok": true, "device": {...}}``.  ``--profile DIR`` also writes a
``torch.profiler`` table of three batch-32 requests of each path into DIR.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import centernet_config, yolact_config
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.ops.conv_transpose import (
    depthwise_upsample,
    depthwise_upsample_cuda,
)
from tauv_vision_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_cuda
from tauv_vision_tpu_torch.ops.image import normalize_image, resize_frames
from tauv_vision_tpu_torch.ops.masks import assemble_mask_batch, assemble_mask_cuda
from tauv_vision_tpu_torch.ops.peaks import peak_decode, peak_decode_cuda
from tauv_vision_tpu_torch.serving.centernet_decode import decode
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STDDEV,
    SERVING_DECODE,
    make_combined_pipeline,
)
from tauv_vision_tpu_torch.serving.yolact_decode import decode_yolact

FRAME_H, FRAME_W = 480, 640
CHECK_BATCH = 8
N_REQUESTS = 4
FPS_BATCH = 32

PEAK_ATOL = 1e-6      # score; index and label exact
MASK_ATOL = 1e-5      # sigmoid of an 8-term dot, summed in another order
UPSAMPLE_TOL = 1e-5   # rtol and atol: 4 f32 taps in another order than cuDNN
HEAD_ATOL = {         # raw heads, kernel path against the plain path
    "plain_ida": 1e-4,   # kernel C against cuDNN inside the net
    # kernels C and E: a sample position that moves by one ulp moves every
    # later DCN block's samples, through 16 blocks; the bound the CPU
    # tests hold this net to against the JAX package
    "dcn_ida": 2e-4,
}
DCN_TOL = 1e-4        # rtol and atol: 9 C (up to 4,608) f32 products an
                      # output, summed in another order than the plain
                      # version's per-tap GEMMs, weight x mask folded first
PLANTED_OFFSET = 40.0  # cells: past the map edge, as torch-trained offsets go
N_DCN = 16            # DeformConv2d calls of one DCN-IDA forward
N_DCN_SHAPES = 7      # distinct (x shape, O) among them

KERNELS = {
    "peak_decode": ("tauv_vision_tpu_torch/csrc/peak_decode.cu",
                    "tauv_vision_tpu/ops/pallas/peak_decode.py:99"),
    "mask_assembly": ("tauv_vision_tpu_torch/csrc/mask_assembly.cu",
                      "tauv_vision_tpu/ops/pallas/mask_assembly.py:62"),
    "depthwise_upsample": ("tauv_vision_tpu_torch/csrc/depthwise_upsample.cu",
                           "tauv_vision_tpu/ops/pallas/depthwise_upsample.py:81"),
    "deform_conv": ("tauv_vision_tpu_torch/csrc/deform_conv.cu",
                    "tauv_vision_tpu/ops/pallas/deform_conv.py:409"),
}
PATHS = ("plain_ida", "dcn_ida")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---- phase 1 ------------------------------------------------------------

def device_phase() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi.splitlines()[0]


# ---- phase 2 ------------------------------------------------------------

def build_phase() -> None:
    path, seconds, log = kernels.build(("-Xptxas", "-v"))
    kernels.library()
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    print(f"build: {path.name} in {seconds:.1f} s "
          f"({'cached' if seconds == 0 else 'compiled'}), {len(sources)} kernel "
          f"sources {sources}, entry points {sorted(kernels._SIGNATURES)}")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas: " + line.split("ptxas info    : ")[-1].strip())


# ---- models -------------------------------------------------------------

def build_models(device):
    """{path: (CenterNet on the kernels, the same weights on the plain
    versions)}, the CenterNet config, YOLACT and its config."""
    oc, cn_cfg = centernet_config()
    yl_cfg = yolact_config()
    nets = {}
    for path, seed, deform in (("plain_ida", 0, False), ("dcn_ida", 2, True)):
        cn = CenterpointDLA34(oc, generator=torch.Generator().manual_seed(seed),
                              device=device, deform=deform).eval()
        cn_plain = CenterpointDLA34(oc, up_impl="plain", device=device,
                                    deform=deform, dcn_impl="plain").eval()
        cn_plain.load_state_dict(cn.state_dict())
        nets[path] = (cn, cn_plain)
    yl = Yolact(yl_cfg, generator=torch.Generator().manual_seed(1),
                device=device).eval()
    return nets, cn_cfg, yl, yl_cfg


def hooked_calls(cn_plain, modules, img, record):
    """``record(module, args)`` of every call of ``modules`` in one forward."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, args: calls.append(record(m, args)))
             for m in modules]
    with torch.inference_mode():
        cn_plain(img)
    for h in hooks:
        h.remove()
    return calls


def upsample_calls(cn_plain, img):
    """(x, weight, factor) of every DepthwiseUpsample call of one forward."""
    return hooked_calls(cn_plain, cn_plain.depthwise_upsamples(), img, lambda m, args: (
        args[0].clone(), m.weight.detach(), m.factor))


def dcn_calls(cn_plain, img):
    """(x, offset, mask, weight, bias) of every DeformConv2d call of one
    forward: the net's own offsets and masks."""
    return hooked_calls(cn_plain, cn_plain.deform_convs(), img, lambda m, args: (
        *(a.clone() for a in args), m.weight.detach(), m.bias.detach()))


def dcn_shapes(calls):
    """{(x shape, O): (the first call of that shape, how many calls)}."""
    shapes = {}
    for call in calls:
        key = (tuple(call[0].shape), call[3].shape[0])
        first, n = shapes.get(key, (call, 0))
        shapes[key] = (first, n + 1)
    return shapes


def dcn_flop(calls) -> int:
    """Multiply-adds x 2 of the DCN products (the sampling not counted)."""
    return sum(2 * 9 * x.numel() * w.shape[0] for x, _, _, w, _ in calls)


# ---- phase 3 ------------------------------------------------------------

def planted_ties(shape, gen):
    x = torch.randn(shape, generator=gen, device="cuda") * 3 - 6
    for b in range(shape[0]):
        x[b, 2, 3, 4] = 20.0          # sigmoid == 1.0 exactly in f32
        x[b, 0, 40, 100] = 25.0
        x[b, 1, 70, 7] = 30.0
        x[b, 3, 50, 60] = x[b, 3, 50, 61] = 12.0   # 2-cell plateau
    return x


def check_phase(nets, cn_cfg, yl_cfg):
    cn_plain = nets["plain_ida"][1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    b = CHECK_BATCH
    hh, ww = cn_cfg.out_h, cn_cfg.out_w
    k = SERVING_DECODE.n_detections
    img = torch.randn((b, 3, cn_cfg.in_h, cn_cfg.in_w), generator=gen, device="cuda")
    with torch.inference_mode():
        real_heatmap = cn_plain(img).heatmap_nchw().contiguous()
    cases = {
        "random": torch.randn((b, 4, hh, ww), generator=gen, device="cuda") * 3,
        "planted_ties": planted_ties((b, 4, hh, ww), gen),
        "net_heatmap": real_heatmap,
    }
    err = 0.0
    for name, x in cases.items():
        got, want = peak_decode_cuda(x, k), peak_decode(x, k)
        torch.cuda.synchronize()
        require(torch.equal(got[0], want[0]), f"peak_decode {name}: index differs")
        require(torch.equal(got[1], want[1]), f"peak_decode {name}: label differs")
        e = (got[2] - want[2]).abs().max().item()
        require(e <= PEAK_ATOL, f"peak_decode {name}: score err {e}")
        err = max(err, e)
        print(f"check peak_decode {name} {tuple(x.shape)} K={k}: index/label "
              f"exact, score max_abs_err {e:.3g} (atol {PEAK_ATOL})")
    errs["peak_decode"] = err

    p, kk = yl_cfg.n_prototype_masks, SERVING_DECODE.top_k
    ph, pw = yl_cfg.in_h // 2, yl_cfg.in_w // 2
    proto = torch.randn((b, p, ph, pw), generator=gen, device="cuda")
    coeff = torch.tanh(torch.randn((b, kk, p), generator=gen, device="cuda"))
    box = torch.cat([torch.rand((b, kk, 2), generator=gen, device="cuda"),
                     torch.rand((b, kk, 2), generator=gen, device="cuda") * 0.6], -1)
    err = 0.0
    for crop in (True, False):
        bx = box if crop else None
        got, want = assemble_mask_cuda(proto, coeff, bx), assemble_mask_batch(proto, coeff, bx)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        require(e <= MASK_ATOL, f"mask_assembly crop={crop}: err {e}")
        err = max(err, e)
        print(f"check mask_assembly crop={crop} proto {tuple(proto.shape)} K={kk}: "
              f"max_abs_err {e:.3g} (atol {MASK_ATOL})")
    errs["mask_assembly"] = err

    err = 0.0
    seen = set()
    for x, w, f in upsample_calls(cn_plain, img):
        shape = (tuple(x.shape), f)
        if shape in seen:
            continue
        seen.add(shape)
        for wname, weight in (("bilinear", w),
                              ("random", torch.randn(w.shape, generator=gen, device="cuda"))):
            got, want = depthwise_upsample_cuda(x, weight, f), depthwise_upsample(x, weight, f)
            torch.cuda.synchronize()
            require(got.shape == want.shape, f"depthwise_upsample shape {got.shape}")
            bad = (got - want).abs() > UPSAMPLE_TOL + UPSAMPLE_TOL * want.abs()
            e = (got - want).abs().max().item()
            require(not bad.any().item(), f"depthwise_upsample {shape}: err {e}")
            err = max(err, e)
            print(f"check depthwise_upsample f={f} {tuple(x.shape)} {wname}: "
                  f"max_abs_err {e:.3g} (rtol=atol={UPSAMPLE_TOL})")
    errs["depthwise_upsample"] = err

    calls = dcn_calls(nets["dcn_ida"][1], img)
    require(len(calls) == N_DCN, f"{len(calls)} DCN calls a forward, expected {N_DCN}")
    by_shape = dcn_shapes(calls)
    require(len(by_shape) == N_DCN_SHAPES,
            f"{len(by_shape)} distinct DCN shapes, expected {N_DCN_SHAPES}")
    err = 0.0
    for (shape, o), ((x, offset, mask, w, bias), _) in by_shape.items():
        planted = (torch.rand(offset.shape, generator=gen, device="cuda") * 2 - 1
                   ) * PLANTED_OFFSET
        reach = offset.abs().max().item()
        for case, args in (("net", (x, offset, mask, w, bias)),
                           ("planted_40", (x, planted, mask, w, bias)),
                           ("no_mask", (x, offset, None, w, bias))):
            got, want = deform_conv2d_cuda(*args), deform_conv2d(*args)
            torch.cuda.synchronize()
            require(got.shape == want.shape == (shape[0], o) + shape[2:],
                    f"deform_conv shape {tuple(got.shape)}")
            require(bool(torch.isfinite(got).all()), f"deform_conv {shape} {case}: non-finite")
            e = (got - want).abs().max().item()
            bad = (got - want).abs() > DCN_TOL + DCN_TOL * want.abs()
            require(not bad.any().item(), f"deform_conv {shape}->{o} {case}: err {e}")
            err = max(err, e)
            print(f"check deform_conv {shape} -> O={o} {case}"
                  f"{f' (net |offset| <= {reach:.2f})' if case == 'net' else ''}: "
                  f"max_abs_err {e:.3g}, max |plain| {want.abs().max().item():.3g} "
                  f"(rtol=atol={DCN_TOL})")
    errs["deform_conv"] = err
    return errs


# ---- phase 4 ------------------------------------------------------------

def finite(*ts):
    return all(torch.isfinite(t.float()).all().item() for t in ts)


def serve_phase(path, cn, cn_plain, cn_cfg, yl, yl_cfg):
    device = torch.device("cuda")
    frames = np.random.default_rng(0).integers(
        0, 256, (N_REQUESTS, CHECK_BATCH, FRAME_H, FRAME_W, 3), np.uint8)
    requests = [torch.from_numpy(f).pin_memory() for f in frames]
    pipe = make_combined_pipeline(cn, cn_cfg, yl, yl_cfg, device)
    plain = make_combined_pipeline(cn_plain, cn_cfg, yl, yl_cfg, device, impl="plain")
    n_up, n_dcn = len(cn.depthwise_upsamples()), len(cn.deform_convs())
    require(n_dcn == (N_DCN if path == "dcn_ida" else 0),
            f"{path}: {n_dcn} DeformConv2d modules")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [pipe(r) for r in requests]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"serve {path}: {N_REQUESTS} requests x {CHECK_BATCH} frames, launches "
          f"{launches}, {n_up} DepthwiseUpsample and {n_dcn} DeformConv2d modules")
    want = {"peak_decode": N_REQUESTS, "mask_assembly": N_REQUESTS,
            "depthwise_upsample": N_REQUESTS * n_up, "deform_conv": N_REQUESTS * n_dcn}
    require(launches == want, f"{path}: launch counts {launches}, expected {want}")

    b, k, kk = CHECK_BATCH, SERVING_DECODE.n_detections, SERVING_DECODE.top_k
    mask_hw = (yl_cfg.in_h // 2, yl_cfg.in_w // 2)
    for cn_d, yl_d in answers:
        require(all(t.shape == (b, k) for t in
                    (cn_d.valid, cn_d.score, cn_d.label, cn_d.y, cn_d.x, cn_d.h, cn_d.w)),
                "CenterNet detection shapes")
        require(finite(cn_d.score, cn_d.y, cn_d.x, cn_d.h, cn_d.w), "CenterNet non-finite")
        require(bool(((cn_d.label >= 0) & (cn_d.label < 4)).all()), "CenterNet labels")
        require(yl_d.box.shape == (b, kk, 4) and yl_d.score.shape == (b, kk)
                and yl_d.mask.shape == (b, kk) + mask_hw, "YOLACT shapes")
        require(finite(yl_d.score, yl_d.box, yl_d.mask), "YOLACT non-finite")
        require(bool(((yl_d.mask >= 0) & (yl_d.mask <= 1)).all()), "YOLACT mask range")

    head_err = 0.0
    for r in requests:
        with torch.inference_mode():
            img = resize_frames(r.to(device), (cn_cfg.in_h, cn_cfg.in_w))
            cn_in = normalize_image(img, IMAGENET_MEAN, IMAGENET_STDDEV)
            got, ref = cn(cn_in), cn_plain(cn_in)
        for name in ("heatmap", "size", "offset"):
            head_err = max(head_err, (getattr(got, name) - getattr(ref, name)).abs().max().item())
    atol = HEAD_ATOL[path]
    print(f"serve {path}: CenterNet raw heads kernel vs plain max_abs_err "
          f"{head_err:.3g} (atol {atol})")
    require(head_err <= atol, f"{path}: raw heads differ by {head_err}")

    mask_err, cn_p95 = 0.0, {}
    for r, (cn_d, yl_d) in zip(requests, answers):
        cn_p, yl_p = plain(r)
        for name, got, ref in (("CenterNet", cn_d, cn_p), ("YOLACT", yl_d, yl_p)):
            stats = detection_deltas(ref, got, score_threshold=0.0)
            require(stats["matched_fraction"] == 1.0,
                    f"{path}: {name} decode kernel vs plain: {stats}")
            if name == "CenterNet":
                for what in ("center", "score", "size"):
                    key = f"{what}_delta_p95"
                    cn_p95[key] = max(cn_p95.get(key, 0.0), stats[key])
        require(torch.equal(yl_d.valid, yl_p.valid), "YOLACT keep masks differ")
        mask_err = max(mask_err, (yl_d.mask - yl_p.mask).abs().max().item())
    require(mask_err <= MASK_ATOL, f"served masks differ by {mask_err}")
    print(f"serve {path}: decoded kernel vs plain 100% matched (score threshold 0), "
          f"CenterNet p95 {cn_p95}, mask max_abs_err {mask_err:.3g}; "
          f"{sum(int(a[0].valid.sum()) for a in answers)} CenterNet and "
          f"{sum(int(a[1].valid.sum()) for a in answers)} YOLACT detections valid "
          f"at the served thresholds")
    return launches


# ---- phase 5 ------------------------------------------------------------

def time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def abba(kernel_fn, plain_fn, iters: int, warmup: int = 3):
    """Mean ms per call of (kernel, plain), timed kernel, plain, plain, kernel."""
    for _ in range(warmup):
        kernel_fn()
        plain_fn()
    torch.cuda.synchronize()
    k1 = time_ms(kernel_fn, iters)
    p1 = time_ms(plain_fn, iters)
    p2 = time_ms(plain_fn, iters)
    k2 = time_ms(kernel_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_phase(nets, cn_cfg, yl, yl_cfg, card, profile_dir):
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = CHECK_BATCH
    times = {}
    logits = torch.randn((b, 4, cn_cfg.out_h, cn_cfg.out_w), generator=gen, device="cuda") * 3
    k = SERVING_DECODE.n_detections
    times["peak_decode"] = abba(lambda: peak_decode_cuda(logits, k),
                                lambda: peak_decode(logits, k), 50)
    p, kk = yl_cfg.n_prototype_masks, SERVING_DECODE.top_k
    proto = torch.randn((b, p, yl_cfg.in_h // 2, yl_cfg.in_w // 2), generator=gen, device="cuda")
    coeff = torch.tanh(torch.randn((b, kk, p), generator=gen, device="cuda"))
    box = torch.cat([torch.rand((b, kk, 2), generator=gen, device="cuda"),
                     torch.rand((b, kk, 2), generator=gen, device="cuda") * 0.6], -1)
    times["mask_assembly"] = abba(lambda: assemble_mask_cuda(proto, coeff, box),
                                  lambda: assemble_mask_batch(proto, coeff, box), 50)
    img = torch.randn((b, 3, cn_cfg.in_h, cn_cfg.in_w), generator=gen, device="cuda")
    calls = upsample_calls(nets["plain_ida"][1], img)
    times["depthwise_upsample"] = abba(
        lambda: [depthwise_upsample_cuda(x, w, f) for x, w, f in calls],
        lambda: [depthwise_upsample(x, w, f) for x, w, f in calls], 50)
    dcns = dcn_calls(nets["dcn_ida"][1], img)
    times["deform_conv"] = abba(lambda: [deform_conv2d_cuda(*c) for c in dcns],
                                lambda: [deform_conv2d(*c) for c in dcns], 20)
    what = {
        "peak_decode": f"[{b},4,{cn_cfg.out_h},{cn_cfg.out_w}] K={k}",
        "mask_assembly": f"proto [{b},{p},{yl_cfg.in_h // 2},{yl_cfg.in_w // 2}] K={kk} crop",
        "depthwise_upsample": f"all {len(calls)} calls of one batch-{b} forward",
        "deform_conv": f"all {len(dcns)} calls of one batch-{b} DCN-IDA forward",
    }
    for name, (k_ms, p_ms) in times.items():
        print(f"time {name} {what[name]}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"({card})")
        times[name] = (k_ms, p_ms, what[name])
    gflop = dcn_flop(dcns) / 1e9
    print(f"time deform_conv: {gflop:.2f} GFLOP in the products for {b} frames, "
          f"kernel {gflop / times['deform_conv'][0]:.2f} TFLOP/s, plain "
          f"{gflop / times['deform_conv'][1]:.2f} TFLOP/s (f32 peak 67 off the tensor cores)")
    for shape, (c, n) in dcn_shapes(dcns).items():
        k_ms, p_ms = abba(lambda: deform_conv2d_cuda(*c), lambda: deform_conv2d(*c), 20)
        print(f"time deform_conv {shape[0]} -> O={shape[1]} (x{n} a forward): kernel "
              f"{k_ms:.4f} ms = {dcn_flop([c]) / 1e9 / k_ms:.2f} TFLOP/s, plain "
              f"{p_ms:.4f} ms ({card})")

    device = torch.device("cuda")
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (FPS_BATCH, FRAME_H, FRAME_W, 3), np.uint8)).pin_memory()
    pipes = {}
    for path, (cn, cn_plain) in nets.items():
        pipe = make_combined_pipeline(cn, cn_cfg, yl, yl_cfg, device)
        plain = make_combined_pipeline(cn_plain, cn_cfg, yl, yl_cfg, device, impl="plain")
        k_ms, p_ms = abba(lambda: pipe(frames), lambda: plain(frames), 10)
        print(f"time pipeline {path} batch {FPS_BATCH} (upload + resize + both nets + "
              f"decode, f32): kernels {k_ms:.3f} ms = {FPS_BATCH * 1000 / k_ms:.2f} "
              f"frames/s, plain {p_ms:.3f} ms = {FPS_BATCH * 1000 / p_ms:.2f} frames/s "
              f"({card})")
        pipes[path] = pipe

    # The request's stages one by one, on device-resident frames.
    knobs = SERVING_DECODE
    cn, dcn, dcn_plain = nets["plain_ida"][0], *nets["dcn_ida"]
    with torch.inference_mode():
        on_card = frames.to(device)
        img = resize_frames(on_card, (cn_cfg.in_h, cn_cfg.in_w))
        cn_in = normalize_image(img, IMAGENET_MEAN, IMAGENET_STDDEV)
        yl_in = normalize_image(img, yl_cfg.img_mean, yl_cfg.img_stddev)
        cn_pred, yl_pred = cn(cn_in), yl(yl_in)

        def preprocess_both():
            x = resize_frames(on_card, (cn_cfg.in_h, cn_cfg.in_w))
            return (normalize_image(x, IMAGENET_MEAN, IMAGENET_STDDEV),
                    normalize_image(x, yl_cfg.img_mean, yl_cfg.img_stddev))

        stages = {
            "upload": lambda: frames.to(device, non_blocking=True),
            "resize + normalise": preprocess_both,
            "CenterNet forward": lambda: cn(cn_in),
            "CenterNet DCN-IDA forward": lambda: dcn(cn_in),
            "CenterNet DCN-IDA forward, plain DCN": lambda: dcn_plain(cn_in),
            "YOLACT forward": lambda: yl(yl_in),
            "CenterNet decode": lambda: decode(cn_pred, cn_cfg, knobs.n_detections,
                                               knobs.score_threshold),
            "YOLACT decode": lambda: decode_yolact(yl_pred, yl_cfg, knobs.top_k,
                                                   knobs.iou_threshold,
                                                   knobs.confidence_threshold),
        }
        for fn in stages.values():
            fn()
        stage_ms = {name: time_ms(fn, 5) for name, fn in stages.items()}
    print(f"time stages batch {FPS_BATCH}: " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in stage_ms.items()) + f" ({card})")
    print(f"peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        out = pathlib.Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        for path, pipe in pipes.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    pipe(frames)
                torch.cuda.synchronize()
            table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
            (out / f"pipeline_profile_{path}.txt").write_text(f"{card}\n{table}\n")
            print(f"profile {path} (3 batch-32 requests), top kernels by device time:")
            print("\n".join(table.splitlines()[:22]))
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also write a torch.profiler table into DIR")
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    card = device_phase()
    build_phase()
    nets, cn_cfg, yl, yl_cfg = build_models(torch.device("cuda"))
    errs = check_phase(nets, cn_cfg, yl_cfg)
    launches = {path: serve_phase(path, *nets[path], cn_cfg, yl, yl_cfg)
                for path in PATHS}
    times = time_phase(nets, cn_cfg, yl, yl_cfg, card, args.profile)

    # ``launches``: the DCN-IDA path's run, which goes through all four
    # kernels; ``launches_by_path``: each path's own run.
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches["dcn_ida"][name],
         "launches_by_path": {path: launches[path][name] for path in PATHS},
         "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1], "timed": times[name][2]}
        for name, (src, replaces) in KERNELS.items()
    ]}
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
