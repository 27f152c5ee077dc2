#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Three served paths, each a CenterNet beside a YOLACT through
``make_combined_pipeline``: ``plain_ida``, the CenterpointDLA34 with
plain-conv IDA that ``bench.py`` serves with no flags, beside the f32
YOLACT; ``dcn_ida``, the reference's deployed CenterpointDLA34 with DCNv2
in its 16 IDA blocks (``deform=True``, kernel E), beside the f32 YOLACT;
``int8_chain``, the plain-IDA CenterNet beside the int8-chain YOLACT that
``bench.py`` serves (per-channel scales calibrated on 2 frames, the
prediction head and ``protonet/output`` in bf16, bf16 joins), with the
protonet's two upsamples' scales added so both run int8 through kernel D.

Phases, each fatal on failure (exit code != 0, no result line):

1. device: require CUDA, print the card and its power limit, and turn
   TF32 off (the f32 paths are f32);
2. build: compile the port's CUDA kernels from ``tauv_vision_tpu_torch/
   csrc`` (one nvcc a source, in parallel) and print the build time and
   each kernel's registers and spills;
3. check: each kernel against its plain PyTorch version on the card at
   the served shapes (batch 8), tolerances printed beside each result:
   kernel E at each distinct shape of the 16 DCN calls of one forward;
   kernel D bit-equal at both protonet upsamples (int8 and bf16 out,
   leaky/relu/none, and one odd width); the chain's integer convolution
   core (im2col + ``torch._int_mm``) bit-equal to the float64 cuDNN
   convolution at every distinct calibrated conv shape; probe P2 exact;
4. serve: for each path, the served pair at full width on seeded random
   weights answers 4 requests of 8 random 640x480 uint8 frames; outputs
   must be finite and well shaped, the launch counters (zeroed just
   before the path) must show every kernel of the path on every
   request, and the same frames through the plain versions must decode
   the same (for ``int8_chain`` the int8 protonet maps bit-equal too,
   and ``make_yolact_chain_pipeline``, YOLACT alone on its defaults,
   launches kernel D twice a request and decodes as the pair's YOLACT);
   the chain's decode against the f32 YOLACT's is printed, not gated
   (random weights);
5. time: each kernel against its plain version (CUDA events, after
   warm-up), probe P2's rates, the integer core against cuDNN's bf16
   convolution per calibrated shape, each path's frames/s at batch 32,
   and its stages one by one.

Prints one JSON line describing the kernels, with each kernel's bound
(the larger of its bytes over 3.35 TB/s and its operations over the
peak rate of their type, H100 SXM data sheet at 700 W), then, as the last
line, ``{"ok": true, "device": {...}}``.  ``--profile DIR`` also writes a
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
import torch.nn.functional as F

from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import centernet_config, yolact_config
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.ops.conv_transpose import (
    depthwise_upsample,
    depthwise_upsample_cuda,
)
from tauv_vision_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_cuda
from tauv_vision_tpu_torch.ops.image import normalize_image, preprocess, resize_frames
from tauv_vision_tpu_torch.ops.int8_conv import conv2d_int8_f64
from tauv_vision_tpu_torch.ops.masks import assemble_mask_batch, assemble_mask_cuda
from tauv_vision_tpu_torch.ops.peaks import peak_decode, peak_decode_cuda
from tauv_vision_tpu_torch.ops.transpose_conv import (
    transpose_conv2x_int8,
    transpose_conv2x_int8_cuda,
)
from tauv_vision_tpu_torch.scripts import int8_dot_probe
from tauv_vision_tpu_torch.serving import quantize_chain
from tauv_vision_tpu_torch.serving.centernet_decode import decode
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STDDEV,
    SERVING_DECODE,
    make_combined_pipeline,
    make_yolact_pipeline,
)
from tauv_vision_tpu_torch.serving.quantize import calibrate, strip_scales
from tauv_vision_tpu_torch.serving.quantize_chain import (
    ChainCtx,
    make_yolact_chain_pipeline,
    yolact_chain_forward,
)
from tauv_vision_tpu_torch.serving.yolact_decode import decode_yolact

FRAME_H, FRAME_W = 480, 640
CHECK_BATCH = 8
N_REQUESTS = 4
FPS_BATCH = 32
N_CALIBRATION = 2     # frames, as bench.py calibrates

PEAK_ATOL = 1e-6      # score; index and label exact
MASK_ATOL = 1e-5      # sigmoid of an 8-term dot, summed in another order
UPSAMPLE_TOL = 1e-5   # rtol and atol: 4 f32 taps in another order than cuDNN
HEAD_ATOL = {         # raw heads, kernel path against the plain path
    "plain_ida": 1e-4,   # kernel C against cuDNN inside the net
    # kernels C and E: a sample position that moves by one ulp moves every
    # later DCN block's samples, through 16 blocks; the bound the CPU
    # tests hold this net to against the JAX package
    "dcn_ida": 2e-4,
    "int8_chain": 1e-4,  # the same CenterNet as plain_ida
}
DCN_TOL = 1e-4        # rtol and atol: 9 C (up to 4,608) f32 products an
                      # output, summed in another order than the plain
                      # version's per-tap GEMMs, weight x mask folded first
PLANTED_OFFSET = 40.0  # cells: past the map edge, as torch-trained offsets go
N_DCN = 16            # DeformConv2d calls of one DCN-IDA forward
N_DCN_SHAPES = 7      # distinct (x shape, O) among them
UPSAMPLES = ("protonet/upsample_1", "protonet/upsample_2")
D_NEXT = {"protonet/upsample_1": "protonet/mid_0", "protonet/upsample_2": "protonet/post_0"}

# H100 SXM data sheet, dense, at the 700 W power limit.
PEAK = {"bytes": 3.35e12, "f32": 67e12, "int8": 1979e12}

KERNELS = {
    "peak_decode": ("tauv_vision_tpu_torch/csrc/peak_decode.cu",
                    "tauv_vision_tpu/ops/pallas/peak_decode.py:99"),
    "mask_assembly": ("tauv_vision_tpu_torch/csrc/mask_assembly.cu",
                      "tauv_vision_tpu/ops/pallas/mask_assembly.py:62"),
    "depthwise_upsample": ("tauv_vision_tpu_torch/csrc/depthwise_upsample.cu",
                           "tauv_vision_tpu/ops/pallas/depthwise_upsample.py:81"),
    "deform_conv": ("tauv_vision_tpu_torch/csrc/deform_conv.cu",
                    "tauv_vision_tpu/ops/pallas/deform_conv.py:409"),
    "transpose_conv": ("tauv_vision_tpu_torch/csrc/transpose_conv.cu",
                       "tauv_vision_tpu/ops/pallas/transpose_conv.py:85"),
    "int8_dot_probe": ("tauv_vision_tpu_torch/csrc/int8_dot_probe.cu",
                       "tauv_vision_tpu/scripts/mosaic_int8_dot_probe.py:64"),
}
PATHS = ("plain_ida", "dcn_ida", "int8_chain")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(n_bytes: float, ops: float, peak_ops: float):
    """(least ms, "bytes" or "operations") for moving n_bytes and doing ops."""
    t_bytes, t_ops = n_bytes / PEAK["bytes"], ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


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

def request_frames(seed: int, shape):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, np.uint8))


def upsample_scales(yl, img):
    """Per-input-channel scales of the protonet's two transposed convs by
    ``calibrate``'s rule (max(absmax, 1e-6) / 127 of the f32 forward's
    input), which ``calibrate`` itself does not record."""
    absmax = {}
    hooks = [getattr(yl._masknet, f"_upsample_layer_{i}").register_forward_pre_hook(
        lambda m, args, i=i: absmax.__setitem__(
            f"protonet/upsample_{i}", args[0].abs().amax(dim=(0, 2, 3)).double().cpu().numpy()))
        for i in (1, 2)]
    with torch.inference_mode():
        yl(img)
    for h in hooks:
        h.remove()
    return {path: np.maximum(v, 1e-6) / 127.0 for path, v in absmax.items()}


def build_models(device):
    """{path: (CenterNet on the kernels, the same weights on the plain
    versions)}, the CenterNet config, YOLACT, its config and the int8
    chains of that YOLACT: {"kernel", "plain", "cudnn_transposes"}."""
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
    nets["int8_chain"] = nets["plain_ida"]
    yl = Yolact(yl_cfg, generator=torch.Generator().manual_seed(1), device=device).eval()

    # bench.py's int8 YOLACT rung: per-channel scales on the first 2
    # frames, head and protonet output stripped, bf16 with bf16 joins.
    cal = request_frames(0, (N_CALIBRATION, FRAME_H, FRAME_W, 3)).to(device)
    img = preprocess(cal, (yl_cfg.in_h, yl_cfg.in_w), yl_cfg.img_mean, yl_cfg.img_stddev)
    scales = strip_scales(calibrate(yl, [img], per_channel=True),
                          ("prediction_head", "protonet/output"))
    served = {**scales, **upsample_scales(yl, img)}
    chains = {}
    for name, s, impl in (("kernel", served, "kernel"), ("plain", served, "plain"),
                          ("cudnn_transposes", scales, "kernel")):
        ctx = ChainCtx(yl, s, impl=impl)
        chains[name] = (ctx, yolact_chain_forward(ctx))
    print(f"int8 chain: {len(served)} calibrated convs ({len(scales)} by calibrate, "
          f"{sorted(set(served) - set(scales))} added), bf16 head and joins")
    return nets, cn_cfg, yl, yl_cfg, chains


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


def chain_calls(ctx, forward, img):
    """One chain forward of ``img``: {"transpose": [(x_q, qk, deq, bias,
    out_scale, act, out_dtype, taps)] of kernel D's two calls, "int8_conv":
    [(q, qk, stride, padding)] of every integer conv, "maps": {path:
    output} of the protonet's layers}."""
    record = {"transpose": [], "int8_conv": [], "maps": {}}
    run_layer, conv = ctx.run_layer, quantize_chain.conv2d_int8

    def run(inp, path, **kwargs):
        y = run_layer(inp, path, **kwargs)
        if path.startswith("protonet/"):
            record["maps"][path] = y
        if path in UPSAMPLES:
            qk, deq, bias, out_scale, taps = ctx.transpose_args(path, D_NEXT[path])
            record["transpose"].append((inp, qk, deq, bias, out_scale, "leaky", torch.int8, taps))
        return y

    def int8_conv(q, qk, stride, padding):
        record["int8_conv"].append((q, qk, stride, padding))
        return conv(q, qk, stride, padding)

    ctx.run_layer, quantize_chain.conv2d_int8 = run, int8_conv
    try:
        forward(img)
    finally:
        del ctx.run_layer
        quantize_chain.conv2d_int8 = conv
    return record


# ---- phase 3 ------------------------------------------------------------

def planted_ties(shape, gen):
    x = torch.randn(shape, generator=gen, device="cuda") * 3 - 6
    for b in range(shape[0]):
        x[b, 2, 3, 4] = 20.0          # sigmoid == 1.0 exactly in f32
        x[b, 0, 40, 100] = 25.0
        x[b, 1, 70, 7] = 30.0
        x[b, 3, 50, 60] = x[b, 3, 50, 61] = 12.0   # 2-cell plateau
    return x


def check_phase(nets, cn_cfg, yl_cfg, chains, yl_img):
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

    # Kernel D: bit-equal, at both served shapes with the net's codes,
    # weights and epilogue, each activation, int8 and bf16 out.
    ctx, forward = chains["kernel"]
    record = chain_calls(ctx, forward, yl_img)
    require(len(record["transpose"]) == 2, f"{len(record['transpose'])} kernel D calls")
    cases = []
    for x_q, qk, deq, bias_, scale, _, _, taps in record["transpose"]:
        for act in ("leaky", "relu", "none"):
            for out_dtype in (torch.int8, torch.bfloat16):
                cases.append((x_q, qk, deq, bias_, scale, act, out_dtype, taps))
    x_q, qk, deq, bias_, scale, _, _, taps = record["transpose"][0]
    odd = x_q[:, :, :x_q.shape[2] - 1].contiguous()
    cases.append((odd, qk, deq, bias_, scale, "leaky", torch.int8, taps))
    err = 0.0
    for x_q, qk, deq, bias_, scale, act, out_dtype, taps in cases:
        got = transpose_conv2x_int8_cuda(x_q, qk, deq, bias_, scale, act=act,
                                         out_dtype=out_dtype, taps=taps)
        want = transpose_conv2x_int8(x_q, qk, deq, bias_, scale, act=act, out_dtype=out_dtype)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        require(torch.equal(got, want), f"transpose_conv {tuple(x_q.shape)} {act} "
                                        f"{out_dtype}: not bit-equal, max_abs_err {e}")
        err = max(err, e)
        print(f"check transpose_conv {tuple(x_q.shape)} -> {tuple(got.shape)} {act} "
              f"{str(out_dtype).split('.')[-1]}: bit-equal (|code| = 127 in "
              f"{(want.float().abs() == 127).float().mean().item():.4f})")
    errs["transpose_conv"] = err

    # The integer core: bit-equal to the float64 convolution at every
    # distinct calibrated shape of one forward.
    shapes = {}
    for q, qk, stride, padding in record["int8_conv"]:
        shapes.setdefault((tuple(q.shape), tuple(qk.shape), tuple(stride), padding),
                          (q, qk, stride, padding))
    for key, (q, qk, stride, padding) in shapes.items():
        got = quantize_chain.conv2d_int8(q, qk, stride, padding)
        want = conv2d_int8_f64(q, qk, stride, padding)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"conv2d_int8 {key}: differs from float64")
    print(f"check conv2d_int8: im2col + torch._int_mm bit-equal to the float64 cuDNN "
          f"conv at all {len(shapes)} distinct calibrated shapes "
          f"({len(record['int8_conv'])} integer convs a forward)")

    err = 0.0
    for dtype in (torch.int8, torch.bfloat16):
        a, bb = int8_dot_probe.inputs(dtype, "cuda")
        got, want = int8_dot_probe.dot_probe_cuda(a, bb), int8_dot_probe.dot_probe(a, bb)
        torch.cuda.synchronize()
        require(torch.equal(got.to(torch.int64), want), f"int8_dot_probe {dtype}: not exact")
        err = max(err, (got.to(torch.int64) - want).abs().max().item())
        print(f"check int8_dot_probe {dtype} [{int8_dot_probe.M},{int8_dot_probe.K}]@"
              f"[{int8_dot_probe.K},{int8_dot_probe.N}] x{int8_dot_probe.REPS}: exact")
    errs["int8_dot_probe"] = err
    return errs, record, shapes


# ---- phase 4 ------------------------------------------------------------

def finite(*ts):
    return all(torch.isfinite(t.float()).all().item() for t in ts)


def serve_phase(path, cn, cn_plain, cn_cfg, yl, yl_cfg, chains):
    device = torch.device("cuda")
    requests = [request_frames(0, (N_REQUESTS, CHECK_BATCH, FRAME_H, FRAME_W, 3))[i].pin_memory()
                for i in range(N_REQUESTS)]
    chain = path == "int8_chain"
    yl_fwd, yl_plain = (chains["kernel"][1], chains["plain"][1]) if chain else (yl, yl)
    pipe = make_combined_pipeline(cn, cn_cfg, yl_fwd, yl_cfg, device)
    plain = make_combined_pipeline(cn_plain, cn_cfg, yl_plain, yl_cfg, device, impl="plain")
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
            "depthwise_upsample": N_REQUESTS * n_up, "deform_conv": N_REQUESTS * n_dcn,
            "transpose_conv": N_REQUESTS * 2 if chain else 0, "int8_dot_probe": 0}
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

    if chain:
        with torch.inference_mode():
            yl_in = preprocess(requests[0].to(device), (yl_cfg.in_h, yl_cfg.in_w),
                               yl_cfg.img_mean, yl_cfg.img_stddev)
        maps = {name: chain_calls(*chains[name], yl_in)["maps"] for name in ("kernel", "plain")}
        require(maps["kernel"].keys() == maps["plain"].keys(), "protonet layers differ")
        for layer, y in maps["kernel"].items():
            require(torch.equal(y, maps["plain"][layer]),
                    f"int8_chain: protonet {layer} differs between kernel D and plain D")
        layers = ", ".join(f"{name} {y.dtype}" for name, y in maps["kernel"].items())
        print(f"serve {path}: protonet maps bit-equal with kernel D and with its plain "
              f"version ({layers})")

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

    if chain:
        # The slice's own entry point, YOLACT alone, on its defaults (the
        # served recipe on the kernels): the same launches a request and
        # the same decode as the pair's YOLACT.
        alone = make_yolact_chain_pipeline(yl, chains["kernel"][0].scales, device)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        alone_answers = [alone(r) for r in requests]
        torch.cuda.synchronize()
        alone_want = {**{name: 0 for name in KERNELS}, "mask_assembly": N_REQUESTS,
                      "transpose_conv": 2 * N_REQUESTS}
        require(kernels.LAUNCHES == alone_want,
                f"make_yolact_chain_pipeline: launch counts {dict(kernels.LAUNCHES)}, "
                f"expected {alone_want}")
        for got, (_, yl_d) in zip(alone_answers, answers):
            stats = detection_deltas(yl_d, got, score_threshold=0.0)
            require(stats["matched_fraction"] == 1.0 and torch.equal(got.valid, yl_d.valid),
                    f"make_yolact_chain_pipeline against the pair's YOLACT: {stats}")
        print(f"serve {path}: make_yolact_chain_pipeline (YOLACT alone, served defaults) "
              f"launches {dict(kernels.LAUNCHES)}, decode 100% matched with the pair's YOLACT")

        f32 = make_yolact_pipeline(yl, yl_cfg, device)
        stats = [detection_deltas(f32(r), a[1], score_threshold=0.0)
                 for r, a in zip(requests, answers)]
        total = sum(s["total"] for s in stats)
        matched = sum(s["matched_fraction"] * s["total"] for s in stats) / max(total, 1)
        worst = {key: max(s.get(key, 0.0) for s in stats)
                 for key in ("center_delta_p95", "score_delta_p95", "size_delta_p95")}
        print(f"report {path}: int8-chain YOLACT decode against the f32 YOLACT on the "
              f"same weights and frames (random weights, not gated): {matched:.4f} of "
              f"{total} matched at score threshold 0, worst request p95 {worst}")
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


def time_phase(nets, cn_cfg, yl, yl_cfg, chains, record, int8_shapes, card, profile_dir):
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = CHECK_BATCH
    times, bounds = {}, {}
    logits = torch.randn((b, 4, cn_cfg.out_h, cn_cfg.out_w), generator=gen, device="cuda") * 3
    k = SERVING_DECODE.n_detections
    times["peak_decode"] = abba(lambda: peak_decode_cuda(logits, k),
                                lambda: peak_decode(logits, k), 50)
    # sigmoid (4 flops), 3x3 max (8 compares) and the peak test (1) an element
    bounds["peak_decode"] = bound(nbytes(logits) + b * k * 16, 13 * logits.numel(), PEAK["f32"])
    p, kk = yl_cfg.n_prototype_masks, SERVING_DECODE.top_k
    proto = torch.randn((b, p, yl_cfg.in_h // 2, yl_cfg.in_w // 2), generator=gen, device="cuda")
    coeff = torch.tanh(torch.randn((b, kk, p), generator=gen, device="cuda"))
    box = torch.cat([torch.rand((b, kk, 2), generator=gen, device="cuda"),
                     torch.rand((b, kk, 2), generator=gen, device="cuda") * 0.6], -1)
    times["mask_assembly"] = abba(lambda: assemble_mask_cuda(proto, coeff, box),
                                  lambda: assemble_mask_batch(proto, coeff, box), 50)
    n_out = b * kk * proto.shape[2] * proto.shape[3]
    # the P-term dot, the sigmoid (4) and the crop's multiply an output
    bounds["mask_assembly"] = bound(nbytes(proto, coeff, box) + 4 * n_out,
                                    (2 * p + 5) * n_out, PEAK["f32"])
    img = torch.randn((b, 3, cn_cfg.in_h, cn_cfg.in_w), generator=gen, device="cuda")
    calls = upsample_calls(nets["plain_ida"][1], img)
    times["depthwise_upsample"] = abba(
        lambda: [depthwise_upsample_cuda(x, w, f) for x, w, f in calls],
        lambda: [depthwise_upsample(x, w, f) for x, w, f in calls], 50)
    outs = [depthwise_upsample(x, w, f) for x, w, f in calls]
    bounds["depthwise_upsample"] = bound(
        sum(nbytes(x, w) for x, w, _ in calls) + nbytes(*outs),
        sum(8 * o.numel() for o in outs), PEAK["f32"])
    library = {"depthwise_upsample": time_ms(lambda: [F.conv_transpose2d(
        x, w, stride=f, padding=f // 2, groups=x.shape[1]) for x, w, f in calls], 50)}
    dcns = dcn_calls(nets["dcn_ida"][1], img)
    times["deform_conv"] = abba(lambda: [deform_conv2d_cuda(*c) for c in dcns],
                                lambda: [deform_conv2d(*c) for c in dcns], 20)
    bounds["deform_conv"] = bound(
        sum(nbytes(*c) + 4 * c[0].shape[0] * c[3].shape[0] * c[0].shape[2] * c[0].shape[3]
            for c in dcns), dcn_flop(dcns), PEAK["f32"])
    d_calls = record["transpose"]
    times["transpose_conv"] = abba(
        lambda: [transpose_conv2x_int8_cuda(*c[:5], act=c[5], out_dtype=c[6], taps=c[7])
                 for c in d_calls],
        lambda: [transpose_conv2x_int8(*c[:5], act=c[5], out_dtype=c[6]) for c in d_calls], 10)
    d_ops = sum(2 * 9 * c[0].numel() * c[1].shape[-1] for c in d_calls)
    bounds["transpose_conv"] = bound(
        sum(nbytes(c[0], c[1]) + 12 * c[1].shape[-1] + 4 * c[0].numel() // c[0].shape[-1]
            * c[1].shape[-1] for c in d_calls), d_ops, PEAK["int8"])
    probe = int8_dot_probe.measure()
    row = probe["rows"]["int8->int32"]
    times["int8_dot_probe"] = (row["ms"], row["plain_ms"])
    m, kd, n = probe["m"], probe["k"], probe["n"]
    bounds["int8_dot_probe"] = bound(m * kd + kd * n + 4 * m * n, probe["ops"], PEAK["int8"])
    what = {
        "peak_decode": f"[{b},4,{cn_cfg.out_h},{cn_cfg.out_w}] K={k}",
        "mask_assembly": f"proto [{b},{p},{yl_cfg.in_h // 2},{yl_cfg.in_w // 2}] K={kk} crop",
        "depthwise_upsample": f"all {len(calls)} calls of one batch-{b} forward",
        "deform_conv": f"all {len(dcns)} calls of one batch-{b} DCN-IDA forward",
        "transpose_conv": f"both calls of one batch-{b} int8-chain forward, int8 in and out",
        "int8_dot_probe": f"[{m},{kd}]@[{kd},{n}] x{probe['reps']} int8->int32",
    }
    for name, (k_ms, p_ms) in times.items():
        b_ms, by = bounds[name]
        print(f"time {name} {what[name]}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({by}), library "
              f"{library.get(name, float('nan')):.4f} ms ({card})")
        times[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                       "library_ms": library.get(name), "timed": what[name]}
    gflop = dcn_flop(dcns) / 1e9
    print(f"time deform_conv: {gflop:.2f} GFLOP in the products for {b} frames, "
          f"kernel {gflop / times['deform_conv']['ms']:.2f} TFLOP/s, plain "
          f"{gflop / times['deform_conv']['plain_ms']:.2f} TFLOP/s (f32 peak 67 off the tensor cores)")
    for shape, (c, n_calls) in dcn_shapes(dcns).items():
        k_ms, p_ms = abba(lambda: deform_conv2d_cuda(*c), lambda: deform_conv2d(*c), 20)
        print(f"time deform_conv {shape[0]} -> O={shape[1]} (x{n_calls} a forward): kernel "
              f"{k_ms:.4f} ms = {dcn_flop([c]) / 1e9 / k_ms:.2f} TFLOP/s, plain "
              f"{p_ms:.4f} ms ({card})")
    for c in d_calls:
        k_ms, p_ms = abba(lambda: transpose_conv2x_int8_cuda(*c[:5], act=c[5], out_dtype=c[6],
                                                             taps=c[7]),
                          lambda: transpose_conv2x_int8(*c[:5], act=c[5], out_dtype=c[6]), 10)
        ops = 2 * 9 * c[0].numel() * c[1].shape[-1]
        print(f"time transpose_conv {tuple(c[0].shape)}: kernel {k_ms:.4f} ms = "
              f"{ops / k_ms / 1e9:.2f} TOP/s, plain {p_ms:.4f} ms, bound "
              f"{ops / PEAK['int8'] * 1e3:.4f} ms at 1979 TOP/s int8 ({card})")
    for tag, r in probe["rows"].items():
        print(f"time int8_dot_probe {tag}: {r['ms'] * 1e3:.2f} us = {r['tops']:.1f} TOP/s "
              f"(exact {r['exact']}); one torch library call of the same [M,K]@[K,N] "
              f"{r['library_ms_one_product'] * 1e3:.2f} us = {r['library_tops']:.1f} TOP/s ({card})")

    # The integer core per distinct calibrated shape (batch 8): im2col +
    # _int_mm against cuDNN's bf16 convolution of the same shape.
    for (q_shape, k_shape, stride, padding), (q, qk, _, _) in int8_shapes.items():
        xb = q.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = qk.permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
        i_ms, c_ms = abba(lambda: quantize_chain.conv2d_int8(q, qk, stride, padding),
                          lambda: F.conv2d(xb, wb, stride=stride, padding=padding), 10)
        ho = (q.shape[1] + 2 * padding - k_shape[0]) // stride[0] + 1
        wo = (q.shape[2] + 2 * padding - k_shape[1]) // stride[1] + 1
        ops = 2 * q.shape[0] * ho * wo * k_shape[0] * k_shape[1] * k_shape[2] * k_shape[3]
        print(f"time conv2d_int8 {q_shape} k{k_shape[0]}x{k_shape[1]} {k_shape[2]}->"
              f"{k_shape[3]} s{stride[0]}: im2col+_int_mm {i_ms:.4f} ms = {ops / i_ms / 1e9:.1f} "
              f"TOP/s, cuDNN bf16 {c_ms:.4f} ms = {ops / c_ms / 1e9:.1f} TFLOP/s ({card})")

    device = torch.device("cuda")
    frames = request_frames(1, (FPS_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    pipes = {}
    for path, (cn, cn_plain) in nets.items():
        chain = path == "int8_chain"
        yl_fwd = chains["kernel"][1] if chain else yl
        yl_plain = chains["plain"][1] if chain else yl
        pipe = make_combined_pipeline(cn, cn_cfg, yl_fwd, yl_cfg, device)
        plain = make_combined_pipeline(cn_plain, cn_cfg, yl_plain, yl_cfg, device, impl="plain")
        k_ms, p_ms = abba(lambda: pipe(frames), lambda: plain(frames), 10)
        print(f"time pipeline {path} batch {FPS_BATCH} (upload + resize + both nets + "
              f"decode): kernels {k_ms:.3f} ms = {FPS_BATCH * 1000 / k_ms:.2f} "
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
        chain_pred = chains["kernel"][1](yl_in)

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
            "YOLACT forward, f32": lambda: yl(yl_in),
            "YOLACT int8 chain forward, kernel D": lambda: chains["kernel"][1](yl_in),
            "YOLACT int8 chain forward, plain D": lambda: chains["plain"][1](yl_in),
            "YOLACT int8 chain forward, bf16 cuDNN transposes":
                lambda: chains["cudnn_transposes"][1](yl_in),
            "CenterNet decode": lambda: decode(cn_pred, cn_cfg, knobs.n_detections,
                                               knobs.score_threshold),
            "YOLACT decode": lambda: decode_yolact(yl_pred, yl_cfg, knobs.top_k,
                                                   knobs.iou_threshold,
                                                   knobs.confidence_threshold),
            "YOLACT decode, int8 chain": lambda: decode_yolact(
                chain_pred, yl_cfg, knobs.top_k, knobs.iou_threshold,
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
    nets, cn_cfg, yl, yl_cfg, chains = build_models(torch.device("cuda"))
    yl_img = preprocess(request_frames(0, (N_REQUESTS, CHECK_BATCH, FRAME_H, FRAME_W, 3))[0]
                        .cuda(), (yl_cfg.in_h, yl_cfg.in_w), yl_cfg.img_mean, yl_cfg.img_stddev)
    errs, record, int8_shapes = check_phase(nets, cn_cfg, yl_cfg, chains, yl_img)
    launches = {path: serve_phase(path, *nets[path], cn_cfg, yl, yl_cfg, chains)
                for path in PATHS}
    for name in ("peak_decode", "mask_assembly", "depthwise_upsample", "deform_conv",
                 "transpose_conv"):
        require(any(launches[path][name] for path in PATHS), f"{name} never launched")
    times = time_phase(nets, cn_cfg, yl, yl_cfg, chains, record, int8_shapes, card,
                       args.profile)

    # ``launches``: the served runs of all paths, each counted from 0;
    # ``launches_by_path``: each path's own run.
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(launches[path][name] for path in PATHS),
         "launches_by_path": {path: launches[path][name] for path in PATHS},
         "max_abs_err": errs[name], **times[name]}
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
