"""Build and load the hand-written CUDA kernels under csrc/.

Each csrc/<name>.cu is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

plus the source's -D constants (DEFINES), into mulactseg_tpu_torch/_build/
(git-ignored) as <name>-<hash>.so, where the hash covers the source, the
shared headers of csrc/ (*.cuh) and the flags, and loaded with ctypes. Every C
entry point returns cudaGetLastError(); `check` raises on a non-zero code.
`build_all` starts one nvcc per source at once, so a cold start costs the
slowest file's compile rather than the sum.

The launch counters live here too: each wrapper adds one to its kernel's
count where it launches the kernel, and nowhere else. The attention of
models/segformer.py adds `sdpa` (one a call of
F.scaled_dot_product_attention) and the products a bound needs,
`sdpa.bhnmd` (B h N M d: B h N queries of width d against M keys) and
`sdpa.bhnpmd` (B h (N + M) d), on every device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# the CUDA kernel libraries, csrc/*.cu: what a train step on the card
# builds at once (build_all) before its first launch
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

# Compile-time constants of a source that Python needs as well, passed as
# -D<name>=<value> and set by the source's wrapper module (segment.py sets
# K3's span and slot count for csrc/segment.cu).
DEFINES: Dict[str, Dict[str, int]] = {}

LAUNCHES: Counter = Counter()
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def flags(name: str) -> tuple:
    """nvcc's flags for csrc/<name>.cu: NVCC_FLAGS and its -D constants."""
    return NVCC_FLAGS + tuple(f"-D{k}={v}"
                              for k, v in DEFINES.get(name, {}).items())


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "mulactseg_tpu_torch are built on the machine "
                           "with the card")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every missing library in parallel; returns each source's
    nvcc -Xptxas -v report (empty where the library was cached)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name), "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        reports[name] = log
    return reports


def load(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use, with each
    entry point of `argtypes` typed (pointers and the stream as c_void_p,
    or ctypes would cut them to 32 bits) and returning an int error."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, args in argtypes.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
