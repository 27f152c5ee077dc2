"""P1: the cost of short-K tensor-core dots, shared-memory slice copies
(aligned and shifted by 1 and 2 bf16 elements), stride-2 decimation and
a transpose, inside kernels written by hand for Hopper (counterpart of
``tauv_vision_tpu/scripts/mosaic_op_probe.py``; ``csrc/op_probe.cu``).

    python -m tauv_vision_tpu_torch.scripts.op_probe

The question: should a hand-written conv for the short-K layers (the
CenterNet's early trunk, C_in = 3, 16, 32; the int8 chain's convs)
accumulate a K = C_in dot a tap with its patches read shifted from
shared memory, or build im2col patches for one K = 9 C_in dot?

Each op has a plain version here and a wrapper (``*_cuda``) that launches
its kernel for a CUDA tensor, raises on a shape the kernel does not take,
and takes the plain version for a CPU tensor.  The outputs are the JAX
kernels': the dot's accumulator bank 0, and the last iteration's buffer
for the others (the slice copy's buffer starts zeroed: its rows 0-2 are
never written).  ``measure`` times each kernel per iteration as the JAX
probe does, (t(2N) - t(N)) / N with CUDA events around single launches,
beside its bound: the dots' FLOPs at 989 TFLOP/s bf16 dense, the copies'
bytes (read and written once) over the card's shared-memory rate, 132 SMs
x 128 bytes a clock at the maximum SM clock.  The main prints one JSON
object.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from tauv_vision_tpu_torch import kernels

BANKS = 4
# (K, M, N) of the JAX probe's dot rows (mosaic_op_probe.py:143-155)
DOT_SHAPES = ((16, 16, 640), (48, 16, 640), (48, 48, 640), (144, 16, 640), (144, 32, 640),
              (144, 48, 640), (144, 96, 640), (144, 32, 2560), (48, 48, 2560),
              (48, 96, 2560), (256, 128, 640))
COPY_SHAPE = (18, 16, 642)
COPY_ROWS = (3, 21, 40)         # the slice copy's destination rows
COPY_BUF_ROWS = 160
SHIFT_OUT = 640
DECIMATE_SHAPE = (8, 32, 640)
DECIMATE_VARIANTS = ("strided", "reshape_minor", "transpose_first")
TRANSPOSE_SHAPE = (8, 32, 320)
N_ITER = 20_000                 # N of (t(2N) - t(N)) / N
SM_COUNT, SMEM_BYTES_A_CLOCK = 132, 128
PEAK_BF16 = 989e12


# ---- inputs, as the JAX probe draws them --------------------------------

def dot_inputs(m: int, k: int, n: int, device="cpu"):
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((m, k)).astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2 * k, n)).astype(np.float32))
    return w.to(torch.bfloat16).to(device), x.to(torch.bfloat16).to(device)


def copy_input(device="cpu"):
    x = np.random.default_rng(2).standard_normal(COPY_SHAPE).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).to(device)


def decimate_input(device="cpu"):
    return torch.from_numpy(np.random.default_rng(2).standard_normal(DECIMATE_SHAPE)
                            .astype(np.float32)).to(device)


def transpose_input(device="cpu"):
    return torch.from_numpy(np.random.default_rng(2).standard_normal(TRANSPOSE_SHAPE)
                            .astype(np.float32)).to(device)


# ---- plain versions -----------------------------------------------------

def dot(w: torch.Tensor, x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """banks[i % 4] += w @ x[(i % 2) K : (i % 2) K + K] in f32, for i <
    n_iter; returns bank 0 [M, N]."""
    m, k = w.shape
    wf, xf = w.float(), x.float()
    banks = torch.zeros((BANKS, m, x.shape[1]), dtype=torch.float32, device=w.device)
    for i in range(n_iter):
        banks[i % BANKS] += wf @ xf[(i % 2) * k:(i % 2) * k + k]
    return banks[0]


def slice_copy(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """buf[3:19] = x[j]; buf[21:37] = x[j + 1]; buf[40:56] = x[j + 2],
    j = i % 16; returns buf[0:16] [16, 642]."""
    buf = torch.zeros((COPY_BUF_ROWS, COPY_SHAPE[2]), dtype=x.dtype, device=x.device)
    for i in range(n_iter):
        for c, row in enumerate(COPY_ROWS):
            buf[row:row + COPY_SHAPE[1]] = x[i % 16 + c]
    return buf[:COPY_SHAPE[1]]


def lane_shift(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """buf[0:16] = x[j, :, 1:641]; buf[16:32] = x[j, :, 2:642]; returns
    buf[0:16] [16, 640]."""
    rows = COPY_SHAPE[1]
    buf = torch.zeros((2 * rows, SHIFT_OUT), dtype=x.dtype, device=x.device)
    for i in range(n_iter):
        buf[:rows] = x[i % 16, :, 1:1 + SHIFT_OUT]
        buf[rows:] = x[i % 16, :, 2:2 + SHIFT_OUT]
    return buf[:rows]


def decimate(x: torch.Tensor, n_iter: int, variant: str = "strided") -> torch.Tensor:
    """buf = x[j, :, ::2], j = i % 8, written as ``variant`` writes it;
    returns buf [32, 320]."""
    if variant not in DECIMATE_VARIANTS:
        raise ValueError(f"variant must be one of {DECIMATE_VARIANTS}, got {variant!r}")
    _, rows, cols = x.shape
    buf = torch.zeros((rows, cols // 2), dtype=x.dtype, device=x.device)
    for i in range(n_iter):
        xj = x[i % 8]
        if variant == "strided":
            buf[:] = xj[:, ::2]
        elif variant == "reshape_minor":
            buf[:] = xj.reshape(rows, cols // 2, 2)[:, :, 0]
        else:
            buf[:] = xj.T.reshape(cols // 2, 2, rows)[:, 0, :].T
    return buf


def transpose(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """buf = x[i % 8].T in bf16; returns buf [320, 32]."""
    buf = torch.zeros(x.shape[2:0:-1], dtype=torch.bfloat16, device=x.device)
    for i in range(n_iter):
        buf[:] = x[i % 8].T.to(torch.bfloat16)
    return buf


# ---- kernels ------------------------------------------------------------

def _check(t, name, dtype, shape):
    kernels.check_cuda_tensor(t, name, dtype, len(shape))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _n_iter(n_iter: int) -> int:
    if not 1 <= n_iter < 2 ** 31:
        raise ValueError(f"n_iter must be in [1, 2^31), got {n_iter}")
    return n_iter


def dot_cuda(w: torch.Tensor, x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """``dot`` as one kernel: w [M, K], x [2K, N] bf16; M and K multiples
    of 16 (K at most 256), N of 32."""
    m, k = w.shape
    if w.device.type == "cpu":
        return dot(w, x, n_iter)
    if m % 16 or k % 16 or not 16 <= k <= 256 or x.dim() != 2 or x.shape[0] != 2 * k \
            or x.shape[1] % 32:
        raise ValueError(f"unsupported dot shape w {tuple(w.shape)} x {tuple(x.shape)}")
    _check(w, "w", torch.bfloat16, (m, k))
    _check(x, "x", torch.bfloat16, (2 * k, x.shape[1]))
    out = torch.empty((m, x.shape[1]), dtype=torch.float32, device=w.device)
    kernels.launch("tauv_op_probe_dot", "op_probe", w.data_ptr(), x.data_ptr(), out.data_ptr(),
                   m, k, x.shape[1], _n_iter(n_iter))
    return out


def _copy_cuda(x, n_iter, shifted, plain):
    if x.device.type == "cpu":
        return plain(x, n_iter)
    _check(x, "x", torch.bfloat16, COPY_SHAPE)
    out = torch.empty((COPY_SHAPE[1], SHIFT_OUT if shifted else COPY_SHAPE[2]),
                      dtype=torch.bfloat16, device=x.device)
    kernels.launch("tauv_op_probe_copy", "op_probe", x.data_ptr(), out.data_ptr(),
                   int(shifted), _n_iter(n_iter))
    return out


def slice_copy_cuda(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """``slice_copy`` as one kernel: x [18, 16, 642] bf16."""
    return _copy_cuda(x, n_iter, False, slice_copy)


def lane_shift_cuda(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """``lane_shift`` as one kernel: x [18, 16, 642] bf16."""
    return _copy_cuda(x, n_iter, True, lane_shift)


def decimate_cuda(x: torch.Tensor, n_iter: int, variant: str = "strided") -> torch.Tensor:
    """``decimate`` as one kernel: x [8, 32, 640] f32."""
    if x.device.type == "cpu":
        return decimate(x, n_iter, variant)
    if variant not in DECIMATE_VARIANTS:
        raise ValueError(f"variant must be one of {DECIMATE_VARIANTS}, got {variant!r}")
    _check(x, "x", torch.float32, DECIMATE_SHAPE)
    out = torch.empty((DECIMATE_SHAPE[1], DECIMATE_SHAPE[2] // 2), dtype=torch.float32,
                      device=x.device)
    kernels.launch("tauv_op_probe_decimate", "op_probe", x.data_ptr(), out.data_ptr(),
                   DECIMATE_VARIANTS.index(variant), _n_iter(n_iter))
    return out


def transpose_cuda(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """``transpose`` as one kernel: x [8, 32, 320] f32."""
    if x.device.type == "cpu":
        return transpose(x, n_iter)
    _check(x, "x", torch.float32, TRANSPOSE_SHAPE)
    out = torch.empty(TRANSPOSE_SHAPE[2:0:-1], dtype=torch.bfloat16, device=x.device)
    kernels.launch("tauv_op_probe_transpose", "op_probe", x.data_ptr(), out.data_ptr(),
                   _n_iter(n_iter))
    return out


# ---- the probe's rows ---------------------------------------------------

def ops():
    """{op name: (kernel(n_iter), plain(n_iter), work a iteration, blocks)}
    on the card; work is ("flop", n) or ("bytes", n) with elements."""
    table = {}
    for k, m, n in DOT_SHAPES:
        w, x = dot_inputs(m, k, n, "cuda")
        table[f"dot[{m}x{k}xN{n}]"] = (
            lambda it, w=w, x=x: dot_cuda(w, x, it), lambda it, w=w, x=x: dot(w, x, it),
            ("flop", 2 * m * k * n), (n // 32) * (m // 16))
    xc = copy_input("cuda")
    el = 3 * COPY_SHAPE[1] * COPY_SHAPE[2]
    table["slice_copy 3x[16,642]"] = (lambda it: slice_copy_cuda(xc, it),
                                      lambda it: slice_copy(xc, it), ("bytes", 2 * 2 * el, el), 3)
    el = 2 * COPY_SHAPE[1] * SHIFT_OUT
    table["lane-shift copy 2x[16,640]"] = (lambda it: lane_shift_cuda(xc, it),
                                           lambda it: lane_shift(xc, it),
                                           ("bytes", 2 * 2 * el, el), 4)
    xd = decimate_input("cuda")
    el = DECIMATE_SHAPE[1] * DECIMATE_SHAPE[2] // 2
    for variant in DECIMATE_VARIANTS:
        table[f"decimate/{variant} [32,640]->[32,320]"] = (
            lambda it, v=variant: decimate_cuda(xd, it, v),
            lambda it, v=variant: decimate(xd, it, v), ("bytes", 2 * 4 * el, el), 4)
    xt = transpose_input("cuda")
    el = TRANSPOSE_SHAPE[1] * TRANSPOSE_SHAPE[2]
    table["transpose [32,320]->[320,32]+bf16"] = (
        lambda it: transpose_cuda(xt, it), lambda it: transpose(xt, it),
        ("bytes", (4 + 2) * el, el), 2)
    return table


def _launch_ms(fn, n_iter: int, reps: int = 3) -> float:
    """Mean ms of one launch of ``fn(n_iter)``, CUDA events around it."""
    fn(n_iter)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(n_iter)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return float(out.splitlines()[0]) * 1e6


def measure(n_iter: int = N_ITER, plain_iter: int = 16) -> dict:
    """The probe's rows on the current card: ns a iteration ((t(2N) -
    t(N)) / N), the rate, the bound beside it, the blocks the kernel runs
    on (the SMs it can use) and the plain version's ns a iteration."""
    clock = max_sm_clock_hz()
    smem_rate = SM_COUNT * SMEM_BYTES_A_CLOCK * clock
    rows = []
    for op, (kernel, plain, work, blocks) in ops().items():
        ns = (_launch_ms(kernel, 2 * n_iter) - _launch_ms(kernel, n_iter)) / n_iter * 1e6
        plain_ns = (_launch_ms(plain, 2 * plain_iter, 1) - _launch_ms(plain, plain_iter, 1)) \
            / plain_iter * 1e6
        row = {"op": op, "ns": ns, "blocks": blocks, "plain_ns": plain_ns}
        if work[0] == "flop":
            row.update(eff_tflops=work[1] / ns / 1e3, bound_ns=work[1] / PEAK_BF16 * 1e9,
                       bound_by="operations")
        else:
            row.update(gel_per_s=work[2] / ns, bound_ns=work[1] / smem_rate * 1e9,
                       bound_by="bytes")
        rows.append(row)
    return {"n_iter": n_iter, "max_sm_clock_mhz": clock / 1e6,
            "smem_tb_per_s": smem_rate / 1e12, "rows": rows}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("op_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
