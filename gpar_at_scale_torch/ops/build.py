"""Build, load and launch the port's CUDA kernels.

Each source in ``gpar_at_scale_torch/csrc/`` (with the headers there) is compiled at first use by its
own ``nvcc`` process (all started together) into a shared library with a
plain C interface, under ``build/kernels/`` at the repository root (listed
in ``.gitignore``), and loaded with ``ctypes``.  A library's file name
carries a hash of its source and flags, so an edited source is rebuilt.
Nothing here runs at import time: hosts without ``nvcc`` import the port and
use the kernels' plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("kalman_scan", "whiten", "suffix_scan", "adjoint", "dense", "smoothing")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    "kalman_phase1": [_I, _P, _P, _P, _P, _LL, _LL, _I, _P, _P, _P, _P, _P, _P],
    "kalman_phase3": [_I, _P, _P, _P, _P, _LL, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "whiten_columns": [_I, _P, _P, _LL, _I, _I, _I, _P, _P, _P, _P, _P],
    "suffix_reduce": [_I, _P, _P, _P, _LL, _LL, _I, _I, _P, _P, _P, _P],
    "suffix_replay": [_I, _P, _P, _P, _LL, _LL, _I, _I, _P, _P, _P, _P, _P],
    "adjoint_elements": [_I, _P, _P, _P, _P, _LL, _I, _P, _P, _P, _P],
    "adjoint_scores": [_I] + [_P] * 10 + [_LL, _I] + [_P] * 5,
    "dense_chol_solve": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "dense_tri_ut": [_P, _P, _I, _I, _I, _P, _P],
    "dense_tri_u": [_P, _P, _I, _I, _I, _P, _P],
    "smoothing_elements": [_I, _P, _P, _P, _P, _LL, _I, _P, _P, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


@functools.lru_cache(maxsize=None)
def build_all():
    """Compile every missing library, one ``nvcc`` per source, all in
    parallel.  Returns {name: (path, compiler output)}; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            jobs[name] = (out, None)
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (out, (proc, tmp))
    result = {}
    failed = []
    for name, (out, job) in jobs.items():
        if job is None:
            result[name] = (out, "")
            continue
        proc, tmp = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        result[name] = (out, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = ctypes.CDLL(str(build_all()[name][0]))
    for fn, args in _ARGTYPES.items():
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int
    return lib


def ptr(x):
    """Device pointer of a tensor for a ctypes argument (None stays NULL)."""
    return None if x is None else x.data_ptr()


class CudaKernel:
    """One C entry of a kernel library, with its launch count.

    Calling it launches on PyTorch's current stream and raises if the
    launcher returns a CUDA error; ``launches`` counts successful launches
    and nothing else, so a run can show which kernels its path went
    through.  ``replaces`` names the TPU kernel it ports."""

    def __init__(self, name: str, library: str, symbol: str, replaces: str):
        self.name, self.library, self.symbol, self.replaces = name, library, symbol, replaces
        self.launches = 0

    @property
    def source(self) -> str:
        return f"gpar_at_scale_torch/csrc/{self.library}.cu"

    def __call__(self, *args) -> None:
        fn = getattr(library(self.library), self.symbol)
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with cudaError {rc}")
        self.launches += 1


def aligned16(x):
    """x, or a contiguous copy of it when its data does not start on a
    16-byte boundary (the staged kernels K1, K2 and K4b copy 16-byte units)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def require_f32(name: str, *tensors) -> None:
    """Raise unless every tensor is float32, contiguous and on one device."""
    dev = tensors[0].device
    for x in tensors:
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev:
            raise ValueError(
                f"{name}: expected contiguous float32 tensors on {dev}, "
                f"got {x.dtype} contiguous={x.is_contiguous()} on {x.device}"
            )
