"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded
with ``ctypes``.  The build runs at first use, into ``_build/`` beside
this file, and the library is named by a hash of its sources and flags,
so a stale library is never loaded.  Nothing here runs at import time:
the CPU test suite imports every module of the port on machines with no
``nvcc`` and no card.

``LAUNCHES`` counts kernel launches per wrapper.  A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that the
served path went through the kernels (``chip_smoke.py``);
``ENTRY_LAUNCHES`` counts the same launches by C entry point, which tells
a kernel's variants apart (kernels C's and E's f32 and bf16), and
``VARIANT_LAUNCHES`` by (counter, variant) where a wrapper names one
(kernel A its K, kernel B whether it crops).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

LAUNCHES = {"peak_decode": 0, "mask_assembly": 0, "depthwise_upsample": 0,
            "deform_conv": 0, "transpose_conv": 0, "int8_dot_probe": 0,
            "op_probe": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (pointers, then ints, then device and stream).
    "tauv_peak_decode_f32": [_P] * 5 + [_I] * 9 + [_P],
    "tauv_mask_assembly_f32": [_P] * 4 + [_I] * 7 + [_P],
    "tauv_depthwise_upsample_f32": [_P] * 3 + [_I] * 6 + [_P],
    "tauv_depthwise_upsample_bf16": [_P] * 3 + [_I] * 6 + [_P],
    "tauv_deform_conv_f32": [_P] * 8 + [_I] * 11 + [_P],
    "tauv_deform_conv_bf16": [_P] * 8 + [_I] * 11 + [_P],
    "tauv_transpose_conv2x_int8": [_P] * 6 + [_I] * 8 + [_P],
    "tauv_int8_dot_probe": [_P] * 3 + [_I] * 7 + [_P],
    "tauv_op_probe_dot": [_P] * 3 + [_I] * 5 + [_P],
    "tauv_op_probe_copy": [_P] * 2 + [_I] * 3 + [_P],
    "tauv_op_probe_decimate": [_P] * 2 + [_I] * 3 + [_P],
    "tauv_op_probe_transpose": [_P] * 2 + [_I] * 2 + [_P],
}
ENTRY_LAUNCHES = {name: 0 for name in _SIGNATURES}
VARIANT_LAUNCHES = {}   # (counter, variant) -> launches

_lib = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ENTRY_LAUNCHES):
        for name in counts:
            counts[name] = 0
    VARIANT_LAUNCHES.clear()


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtauv_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(extra_flags=()) -> tuple[pathlib.Path, float, str]:
    """Compile ``csrc/*.cu`` unless the hashed library exists.

    One ``nvcc -c`` a source, all started together, then one link.
    Returns (library path, seconds spent compiling, compiler output).
    ``extra_flags`` (for example ``("-Xptxas", "-v")``) only reach a
    fresh build."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    obj_dir = BUILD_DIR / f"obj.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = obj_dir / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    seconds = time.perf_counter() - start
    os.replace(tmp, out)
    shutil.rmtree(obj_dir)
    return out, seconds, "".join(logs) + link.stdout + link.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, counter: str, *args, variant=None) -> None:
    """Call a C entry point on the current stream; raise on a CUDA error.

    ``args`` are the entry point's arguments up to, not including, the
    device and stream, which are filled in here; ``variant``, if given,
    also counts the launch under (counter, variant)."""
    fn = getattr(library(), name)
    if len(args) + 2 != len(fn.argtypes):
        raise TypeError(f"{name} takes {len(fn.argtypes) - 2} arguments before the "
                        f"device and stream, got {len(args)}")
    device = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    code = fn(*args, device, stream)
    if code != 0:
        raise RuntimeError(f"{name} failed with CUDA error {code}")
    LAUNCHES[counter] += 1
    ENTRY_LAUNCHES[name] += 1
    if variant is not None:
        VARIANT_LAUNCHES[(counter, variant)] = VARIANT_LAUNCHES.get((counter, variant), 0) + 1


def check_cuda_tensor(t, name: str, dtype, ndim: int) -> None:
    """Shape, type, device and layout checks shared by the wrappers."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(
            f"{name} is on {t.device}, not the current device "
            f"cuda:{torch.cuda.current_device()}"
        )
