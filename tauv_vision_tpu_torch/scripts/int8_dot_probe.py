"""P2: the int8 (and bf16) tensor-core dot rate inside a kernel written by
hand for Hopper (counterpart of
``tauv_vision_tpu/scripts/mosaic_int8_dot_probe.py``).

    python -m tauv_vision_tpu_torch.scripts.int8_dot_probe

``dot_probe(a, b, reps)`` is the plain version: sum over r = 1..reps of
``roll(a, -r rows) @ b``, exact (products in float64 of small integers,
summed in int64).  ``dot_probe_cuda`` wraps ``csrc/int8_dot_probe.cu``
(warp-level ``mma.sync``, int8 -> int32 or bf16 -> f32): a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
``measure`` times both arms on the card (CUDA graphs of launches, so
host time does not hide the device time) beside ``torch._int_mm`` and
``torch.matmul`` at the same shape; the main prints it as one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from tauv_vision_tpu_torch import kernels

M, K, N = 960, 256, 256
REPS = 16
SPLITS = 2          # blocks sharing a tile's products: 120 blocks on 132 SMs
DTYPES = {torch.int8: (0, torch.int32), torch.bfloat16: (1, torch.float32)}


def dot_probe(a: torch.Tensor, b: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """Plain version: int64 [M, N]."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64, device=a.device)
    for r in range(1, reps + 1):
        out += (torch.roll(a64, -r, 0) @ b64).round().to(torch.int64)
    return out


def dot_probe_cuda(a: torch.Tensor, b: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """P2 as one CUDA op: a [M, K], b [K, N], int8 (-> int32) or bf16 (->
    f32); M, N multiples of 64, K bytes a multiple of 256, reps a
    multiple of SPLITS and at most 16 a split."""
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be int8 or bf16, got {a.dtype}, {b.dtype}")
    kind, out_dtype = DTYPES[a.dtype]
    m, k = a.shape
    if b.dim() != 2 or b.shape[0] != k:
        raise ValueError(f"b must be [{k}, N], got {tuple(b.shape)}")
    n = b.shape[1]
    if a.device.type == "cpu":
        return dot_probe(a, b, reps).to(out_dtype)
    if m % 64 or n % 64 or (k * a.element_size()) % 256 or reps % SPLITS or reps > 16 * SPLITS:
        raise ValueError(f"unsupported shape M={m} K={k} N={n} reps={reps}")
    bt = b.t().contiguous()
    kernels.check_cuda_tensor(a, "a", a.dtype, 2)
    kernels.check_cuda_tensor(bt, "b", b.dtype, 2)
    out = torch.zeros((m, n), dtype=out_dtype, device=a.device)
    _launch(a, bt, out, reps)
    return out


def _launch(a, bt, out, reps):
    """One launch adding the products into ``out``, inputs as checked by
    ``dot_probe_cuda``."""
    kernels.launch("tauv_int8_dot_probe", "int8_dot_probe", a.data_ptr(), bt.data_ptr(),
                   out.data_ptr(), a.shape[0], bt.shape[0], a.shape[1], reps,
                   DTYPES[a.dtype][0], SPLITS)


def inputs(dtype, device, seed: int = 0):
    """Integers in [-10, 10): every product and sum is exact in both arms."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randint(-10, 10, (M, K), generator=gen).to(dtype)
    b = torch.randint(-10, 10, (K, N), generator=gen).to(dtype)
    return a.to(device), b.to(device)


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Device ms of one ``fn()``: ``per_graph`` calls captured in one CUDA
    graph and replayed, so that host launch time (longer than these
    microsecond kernels) does not set the figure."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return _time_ms(graph.replay, replays) / per_graph


def measure() -> dict:
    """Both arms on the current card: exactness against the plain version,
    device ms of one launch and TOP/s, beside one ``torch._int_mm`` (int8)
    or ``torch.matmul`` (bf16) of one of the REPS products."""
    ops = 2 * M * K * N * REPS
    rows = {}
    for dtype, tag in ((torch.int8, "int8->int32"), (torch.bfloat16, "bf16->f32")):
        a, b = inputs(dtype, "cuda")
        got = dot_probe_cuda(a, b)
        want = dot_probe(a, b)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got.to(torch.int64), want))
        bt, scratch = b.t().contiguous(), torch.zeros_like(got)
        ms = _graph_ms(lambda: _launch(a, bt, scratch, REPS))
        plain_ms = _time_ms(lambda: dot_probe(a, b), 5)
        if dtype == torch.int8:
            b_col = bt.t()
            lib_ms = _graph_ms(lambda: torch._int_mm(a, b_col))
        else:
            lib_ms = _graph_ms(lambda: a @ b)
        rows[tag] = {"exact": exact, "ms": ms, "tops": ops / ms / 1e9, "plain_ms": plain_ms,
                     "library_ms_one_product": lib_ms,
                     "library_tops": ops / REPS / lib_ms / 1e9}
    return {"m": M, "k": K, "n": N, "reps": REPS, "ops": ops, "rows": rows}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("int8_dot_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
