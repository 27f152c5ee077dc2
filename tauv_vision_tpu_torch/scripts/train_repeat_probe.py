"""Probe: does the f32 train step's kernel path repeat itself, and do
kernels C and E read memory that they did not write?

    python -m tauv_vision_tpu_torch.scripts.train_repeat_probe [--repeats N]

Run it from the repository root on a CUDA card: it reuses the set-up of
``chip_smoke.py``'s phase 6 (the flax-initialised DCN DLA-34 with the
3-cell window, the synthetic squares at 360x640).  Between runs it
poisons the memory that PyTorch's caching allocator hands out next: it
fills blocks of both pools with a value (NaN, 1e30, 0) and frees them
back to the cache.  A kernel whose output depends on what lay there reads
memory it did not write.

1. Kernels E (at the window and without it) and C at the calls of one
   training-mode forward at batch 8, f32 and bf16: each call run once
   clean and once after each poison, bit for bit, and against its plain
   version.
2. The f32 train step's kernel path and plain path from the same seed,
   ``--repeats`` times each with a poison before each run, and the
   kernel path again with cuDNN held to its deterministic algorithms:
   the total loss's bits and the gradients that differ from the first
   run's.
3. ``chip_smoke.check_train_step`` in f32 ``--repeats`` times: its line,
   or the failure it raises.

Prints the card's name and power limit, one line a finding, and a JSON
line of the counts.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

import chip_smoke as smoke
from tauv_vision_tpu_torch.ops.conv_transpose import depthwise_upsample, depthwise_upsample_cuda
from tauv_vision_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_cuda
from tauv_vision_tpu_torch.train.steps import model_mode

FILLS = (math.nan, 1e30, 0.0)
BATCH = smoke.TRAIN_F32_BATCH


def poison(value: float) -> None:
    """Fill what the caching allocator hands out next with ``value``: most
    of the card's free memory in 256 MiB blocks (the large pool) and 1 GiB
    in 512 KiB blocks (the small pool), freed back to the cache."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    big = [torch.full((64 << 20,), value, device="cuda")
           for _ in range(int(free * 0.8) // (256 << 20))]
    small = [torch.full((128 << 10,), value, device="cuda") for _ in range(2048)]
    torch.cuda.synchronize()
    del big, small


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bit patterns, so that NaNs compare equal to themselves."""
    return t.detach().contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def kernel_calls(data, dtype):
    """The 8 C and 16 E calls of a training-mode forward at BATCH."""
    oc, _, _, img_np, truth_np = data
    img, _ = smoke.on_card(img_np, truth_np, BATCH)
    model = smoke.train_model(oc, dtype, "plain")
    ups, dcns = [], []
    hooks = [m.register_forward_pre_hook(lambda m, a: ups.append(
                 (a[0].to(m.dtype).clone(), m.weight.detach().to(m.dtype), m.factor)))
             for m in model.depthwise_upsamples()]
    hooks += [m.register_forward_pre_hook(lambda m, a: dcns.append(
                  (*(t.clone() for t in a), m.weight.detach().to(a[0].dtype), m.bias.detach())))
              for m in model.deform_convs()]
    with torch.no_grad(), model_mode(model, True):
        model(img)
    for h in hooks:
        h.remove()
    return ups, dcns


def repeat_kernels(data, out):
    for dtype in (torch.float32, torch.bfloat16):
        ups, dcns = kernel_calls(data, dtype)
        cases = [(f"E {dtype} R={r}", tuple(a[0].shape),
                  lambda a=a, r=r: deform_conv2d_cuda(*a, max_offset=r),
                  lambda a=a, r=r: deform_conv2d(*a, max_offset=r))
                 for a in dcns for r in (smoke.DCN_WINDOW, None)]
        cases += [(f"C {dtype}", tuple(a[0].shape), lambda a=a: depthwise_upsample_cuda(*a),
                   lambda a=a: depthwise_upsample(*a)) for a in ups]
        for name, shape, kernel, plain in cases:
            clean = kernel().clone()
            want = plain()
            differ = []
            for fill in FILLS:
                poison(fill)
                got = kernel()
                if not torch.equal(bits(got), bits(clean)):
                    differ.append((fill, int((bits(got) != bits(clean)).sum()),
                                   bool(torch.isnan(got).any())))
            err = (clean.float() - want.float()).abs().max().item()
            row = out.setdefault(name, {"calls": 0, "differ": 0, "max_abs_err": 0.0})
            row["calls"] += 1
            row["differ"] += bool(differ)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if differ:
                print(f"kernels: {name} {shape}: differs after a poison (fill, elements, "
                      f"NaN): {differ}")
        del ups, dcns
        torch.cuda.empty_cache()
    for name, row in out.items():
        print(f"kernels: {name}: {row['differ']} of {row['calls']} calls differ after a "
              f"poison; against the plain version max_abs_err {row['max_abs_err']:.3g}")


def repeat_steps(data, repeats, out):
    oc, mc, tc, img_np, truth_np = data
    img, truth = smoke.on_card(img_np, truth_np, BATCH)
    for impl, deterministic in (("kernel", False), ("plain", False), ("kernel", True)):
        runs = []
        torch.backends.cudnn.deterministic = deterministic
        try:
            for i in range(repeats):
                poison(FILLS[i % len(FILLS)])
                model = smoke.train_model(oc, torch.float32, impl)
                losses, grads = smoke.step_grads(model, img, truth, mc, tc, oc)
                runs.append((float(losses.total), {n: g.clone() for n, g in grads.items()}))
                del model, losses, grads
        finally:
            torch.backends.cudnn.deterministic = False
        first = runs[0]
        differ = [sorted(n for n in first[1] if not torch.equal(bits(first[1][n]), bits(g[n])))
                  for _, g in runs[1:]]
        out[f"{impl}, cudnn.deterministic={deterministic}"] = {
            "losses": [r[0] for r in runs], "gradients_differing": [len(d) for d in differ]}
        print(f"steps: f32 batch {BATCH}, {impl} path, cudnn.deterministic={deterministic}, "
              f"{repeats} runs from the seed, a poison "
              f"before each: total losses {[r[0] for r in runs]}; gradients differing from "
              f"run 1's: {[len(d) for d in differ]} of {len(first[1])}, e.g. "
              f"{[d[:4] for d in differ]}")
        del runs
        torch.cuda.empty_cache()


def repeat_checks(data, repeats, out):
    out["check_failures"] = 0
    for i in range(repeats):
        try:
            smoke.check_train_step(torch.float32, BATCH, data)
        except SystemExit as exc:
            out["check_failures"] += 1
            print(f"check {i + 1}: {exc}")
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    smoke.device_phase()
    smoke.build_phase()
    data = smoke.train_setup()
    kernels_out, steps_out, checks_out = {}, {}, {}
    repeat_kernels(data, kernels_out)
    repeat_steps(data, args.repeats, steps_out)
    repeat_checks(data, args.repeats, checks_out)
    print(json.dumps({"kernels": kernels_out, "steps": steps_out, **checks_out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
