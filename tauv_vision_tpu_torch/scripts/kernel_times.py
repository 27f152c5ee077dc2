"""Time kernels A-E on the device at the shapes a batch-8 request gives them.

    python3 -m tauv_vision_tpu_torch.scripts.kernel_times

Kernel A: the CenterNet's peak decode, [8,4,90,160] logits, K = 10, and
the same on a map with no peaks, which leaves its selection no work.
Kernel B: the YOLACT's mask assembly, prototypes [8,8,180,320], K = 20,
with the crop, once NCHW-contiguous and once as the NHWC view the int8
chain makes (where an older checkout's kernel refuses the view, the row
times the ``.contiguous()`` copy its decode made, and says so).  Kernel
C: the 8 depthwise upsamples of one CenterNet forward (f = 2 at
[8,256,12,20], twice [8,128,23,40] and four times [8,64,45,80]; f = 4 at
[8,64,23,40]), in f32 and in bf16, with the bilinear weights.  Kernel D:
the int8 chain's two protonet upsamples ([8,45,80,256] and
[8,90,160,256] to 256 channels, int8 in and out, leaky).  Kernel E: the
16 DCN calls of one DCN-IDA forward, 7 distinct shapes with their counts
(``E_CALLS``), in f32 and in bf16 (x, weight and mask; offsets f32,
uniform in +-3 cells, the mask uniform in (0, 1)), the NCHW input's NHWC
copy in the time; where an older checkout's kernel takes f32 only, its
bf16 row is null.  ``chip_smoke.py``
fails if these shapes are not the ones its nets give the kernels.  Inputs
are seeded random tensors of those shapes.  Each call is timed on the
device: the calls are queued behind a spin of the card, so the host's
cost of a launch is not in the time (``queued_ms``); A and B also back to
back (``time_ms``), the host's cost in.

Prints one JSON line: the card, its power limit, and each call's ms with
its bytes (B, C) or operations (D).  The script uses only the wrappers'
public signatures, ``kernel_taps`` and (where the checkout has it)
``kernel_weights``, so a copy of it run from the root
of an older checkout times that checkout's kernels: run old, new, new,
old on one card, one after another, to compare two versions.

    python3 -m tauv_vision_tpu_torch.scripts.kernel_times --e-plans

instead times kernel E alone at each of ``E_CALLS`` under every launch
plan it takes (pixel tile, output tile, K splits; ``ops/deform_conv.plan``
picks one), in both dtypes, one JSON line: the measurements behind
``plan``'s choices.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from tauv_vision_tpu_torch.ops import deform_conv
from tauv_vision_tpu_torch.ops.conv_transpose import bilinear_kernel, depthwise_upsample_cuda
from tauv_vision_tpu_torch.ops.masks import assemble_mask_cuda
from tauv_vision_tpu_torch.ops.peaks import peak_decode_cuda
from tauv_vision_tpu_torch.ops.transpose_conv import kernel_taps, transpose_conv2x_int8_cuda

A_CALL = ((8, 4, 90, 160), 10)      # (logits shape, K)
B_CALL = ((8, 8, 180, 320), 20)     # (prototypes [B, P, H, W], K)
C_CALLS = [((8, 256, 12, 20), 2), ((8, 128, 23, 40), 2), ((8, 128, 23, 40), 2),
           ((8, 64, 45, 80), 2), ((8, 64, 45, 80), 2), ((8, 64, 45, 80), 2),
           ((8, 64, 45, 80), 2), ((8, 64, 23, 40), 4)]
D_CALLS = [(8, 45, 80, 256, 256), (8, 90, 160, 256, 256)]
# (x [B, C, H, W], O, calls a forward), in the order a forward first meets them.
E_CALLS = [((8, 512, 12, 20), 256, 1), ((8, 256, 23, 40), 256, 1),
           ((8, 256, 23, 40), 128, 2), ((8, 128, 45, 80), 128, 2),
           ((8, 128, 45, 80), 64, 4), ((8, 64, 90, 160), 64, 5), ((8, 256, 23, 40), 64, 1)]
ITERS = 50        # calls a timing of A, B and C; D and E, ~20x longer a call, a fifth
SPIN_HZ = 2.0e9   # cycles a second of torch.cuda._sleep's spin, >= the SM clock


def time_ms(fn, iters: int) -> float:
    """Mean ms a call between CUDA events around ``iters`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int) -> float:
    """Device ms a call: the calls are queued behind a spin of the card
    (``torch.cuda._sleep``) twice as long as the host took to issue and
    run them, so all are issued before the first starts and the host's
    cost of a launch (tens of us for a wrapper through ctypes) is not in
    the time, as it is not where the card has work queued."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * (time.perf_counter() - t0) * SPIN_HZ))
    return time_ms(fn, iters)


def _row(fn, **info) -> dict:
    """A kernel row: ``info`` with the call's device ms and back-to-back ms."""
    fn()
    return {**info, "ms": queued_ms(fn, ITERS), "back_to_back_ms": time_ms(fn, ITERS)}


def _e_inputs(rng, shape, o, dev):
    b, c, h, w = shape
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    offset = torch.from_numpy(rng.uniform(-3, 3, (b, 18, h, w)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.uniform(0, 1, (b, 9, h, w)).astype(np.float32)).to(dev)
    weight = torch.from_numpy((rng.standard_normal((o, c, 3, 3)) / np.sqrt(9 * c))
                              .astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(o).astype(np.float32) * 0.1).to(dev)
    return x, offset, mask, weight, bias


def e_plans(dev) -> dict:
    """{dtype: [{shape, o, plan, ms}]} of kernel E at each E_CALLS shape
    under each plan (BM in 64, 128 where BN = 64; splits 1-8), with the
    plan ``deform_conv.plan`` picks marked, and the time of torch's NHWC
    copy of the call's input beside the chosen plan."""
    rng = np.random.default_rng(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {"f32": [], "bf16": []}
    for shape, o, _ in E_CALLS:
        x, offset, mask, weight, bias = _e_inputs(rng, shape, o, dev)
        bn = next(n for n in deform_conv.TILE_N if o <= n)
        for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            xd, md, wd = x.to(dtype), mask.to(dtype), weight.to(dtype)
            taps = deform_conv.kernel_weights(wd)
            pick = deform_conv.plan(*shape, o, dtype, sms)
            for bm in ((64, 128) if bn == 64 else (64,)):
                for split in (1, 2, 4, 8):
                    fn = lambda p=(bm, bn, split): deform_conv.deform_conv2d_cuda(  # noqa: E731
                        xd, offset, md, wd, bias, taps=taps, launch_plan=p)
                    fn()
                    rows[key].append({"x": list(shape), "o": o, "plan": [bm, bn, split],
                                      "chosen": (bm, bn, split) == pick,
                                      "ms": queued_ms(fn, ITERS // 5)})
            rows[key].append({
                "x": list(shape), "o": o, "plan": list(pick),
                "nhwc_copy_ms": queued_ms(lambda: xd.permute(0, 2, 3, 1).contiguous(),
                                          ITERS // 5)})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    dev = torch.device("cuda")
    if "--e-plans" in sys.argv[1:]:
        print(json.dumps({"device": torch.cuda.get_device_name(0), "e_plans": e_plans(dev)}))
        return 0
    rng = np.random.default_rng(0)
    rows = {"a": [], "a_no_peaks": [], "b_nchw": [], "b_nhwc": [], "c_f32": [], "c_bf16": [],
            "d": [], "e_f32": [], "e_bf16": []}
    shape, k = A_CALL
    logits = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3).to(dev)
    rows["a"].append(_row(lambda: peak_decode_cuda(logits, k), x=list(shape), k=k,
                          bytes=logits.numel() * 4))
    # The same call on a map without peaks (sigmoid(-200) is 0 in f32): no
    # key to select, so launches, loads and the NMS alone.
    empty = torch.full(shape, -200.0, device=dev)
    rows["a_no_peaks"].append(_row(lambda: peak_decode_cuda(empty, k), x=list(shape), k=k,
                                   bytes=empty.numel() * 4))
    (b, p, h, w), k = B_CALL
    nhwc = torch.from_numpy(rng.standard_normal((b, h, w, p)).astype(np.float32)).to(dev)
    coeff = torch.from_numpy(np.tanh(rng.standard_normal((b, k, p))).astype(np.float32)).to(dev)
    box = torch.from_numpy(np.concatenate([rng.uniform(0, 1, (b, k, 2)),
                                           rng.uniform(0, 0.6, (b, k, 2))], -1)
                           .astype(np.float32)).to(dev)
    n_bytes = (nhwc.numel() + coeff.numel() + box.numel() + b * k * h * w) * 4
    for key, proto in (("b_nchw", nhwc.permute(0, 3, 1, 2).contiguous()),
                       ("b_nhwc", nhwc.permute(0, 3, 1, 2))):
        copy = False
        try:
            assemble_mask_cuda(proto, coeff, box)
        except ValueError:   # an older kernel B: NCHW-contiguous only
            copy = True
        fn = ((lambda: assemble_mask_cuda(proto.contiguous(), coeff, box)) if copy  # noqa: E731
              else (lambda: assemble_mask_cuda(proto, coeff, box)))
        rows[key].append(_row(fn, x=list(proto.shape), k=k, crop=True, bytes=n_bytes,
                              with_copy=copy))
    for shape, f in C_CALLS:
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        w = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            bilinear_kernel(2 * f), (shape[1], 1, 2 * f, 2 * f)))).to(dev)
        for key, dtype in (("c_f32", torch.float32), ("c_bf16", torch.bfloat16)):
            xd, wd = x.to(dtype), w.to(dtype)
            out = depthwise_upsample_cuda(xd, wd, f)
            n_bytes = (xd.numel() + wd.numel() + out.numel()) * xd.element_size()
            rows[key].append({"x": list(shape), "f": f, "bytes": n_bytes,
                              "ms": queued_ms(lambda: depthwise_upsample_cuda(xd, wd, f),
                                              ITERS)})
    for b, h, w_, c, o in D_CALLS:
        q = torch.from_numpy(rng.integers(-127, 128, (b, h, w_, c)).astype(np.int8)).to(dev)
        qk = torch.from_numpy(rng.integers(-127, 128, (3, 3, c, o)).astype(np.int8)).to(dev)
        deq = torch.from_numpy(rng.uniform(1e-6, 1e-5, o).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.standard_normal(o).astype(np.float32)).to(dev)
        scale = torch.from_numpy(rng.uniform(0.01, 0.1, o).astype(np.float32)).to(dev)
        taps = kernel_taps(qk)
        fn = lambda: transpose_conv2x_int8_cuda(q, qk, deq, bias, scale, act="leaky",  # noqa: E731
                                                out_dtype=torch.int8, taps=taps)
        fn()
        rows["d"].append({"x": [b, h, w_, c], "o": o, "ops": 2 * 9 * q.numel() * o,
                          "ms": queued_ms(fn, ITERS // 5)})
    for shape, o, n in E_CALLS:
        x, offset, mask, weight, bias = _e_inputs(rng, shape, o, dev)
        for key, dtype in (("e_f32", torch.float32), ("e_bf16", torch.bfloat16)):
            xd, md, wd = x.to(dtype), mask.to(dtype), weight.to(dtype)
            kwargs = ({"taps": deform_conv.kernel_weights(wd)}
                      if hasattr(deform_conv, "kernel_weights") else {})
            fn = lambda: deform_conv.deform_conv2d_cuda(xd, offset, md, wd, bias, **kwargs)  # noqa: E731
            try:
                fn()
            except TypeError:   # an older kernel E: f32 only
                rows[key].append({"x": list(shape), "o": o, "calls": n, "ms": None})
                continue
            ms = queued_ms(fn, ITERS // 5)
            rows[key].append({"x": list(shape), "o": o, "calls": n,
                              "flop": 2 * 9 * x.numel() * o, "ms": ms,
                              "tflops": 2 * 9 * x.numel() * o / ms / 1e9})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    totals = {f"{key}_ms": (None if any(r["ms"] is None for r in calls)
                            else sum(r["ms"] * r.get("calls", 1) for r in calls))
              for key, calls in rows.items()}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      **totals, **rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
