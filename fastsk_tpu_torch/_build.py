"""Build the port's native code at first use.

The CUDA kernels (``csrc/*.cu``) are compiled with ``nvcc`` into one shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The copied FASTA parser
(``native/fasta_parser.cpp``) is compiled with ``g++`` into the same
directory. Outputs land in ``build/fastsk_tpu_torch/`` beside the package,
named by a hash of their sources and flags, so an edited source rebuilds
and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fastsk_tpu_torch")
CSRC = os.path.join(_PKG, "csrc")
KERNEL_SOURCES = ("pairs.cu", "smo.cu", "pairs_packed.cu")

# --fmad=false: kernels B and C must follow their plain twins' f32
# trajectories op for op, and a contracted multiply-add rounds once where
# the twin rounds twice.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_KERNELS: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's stderr from the build in this process (ptxas -v)


def _digest(paths: List[str], flags: List[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _compile(cmd: List[str], out: str) -> str:
    """Run ``cmd`` (which writes ``out + '.tmp<pid>'``) and move the result
    into place; raises with the compiler's stderr on failure."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"build failed ({' '.join(cmd)}):\n{proc.stderr}{proc.stdout}"
        )
    os.replace(cmd[cmd.index("-o") + 1], out)
    return proc.stderr


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build_parallel(srcs: List[str], out: str) -> str:
    """One ``nvcc -c`` per source, all started together, then one link
    into ``out``; returns the compilers' stderr (ptxas -v)."""
    nvcc = nvcc_path()
    tag = f"{out}.tmp{os.getpid()}"
    objs = [f"{tag}.{i}.o" for i in range(len(srcs))]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    log = []
    for cmd_src, proc in zip(srcs, procs):
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            for other in procs:
                other.wait()
            raise RuntimeError(f"build failed ({cmd_src}):\n{stderr}{stdout}")
        log.append(stderr)
    try:
        log.append(_compile([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tag], out))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(log)


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first call."""
    global _KERNELS, build_log
    with _LOCK:
        if _KERNELS is not None:
            return _KERNELS
        srcs = [os.path.join(CSRC, s) for s in KERNEL_SOURCES]
        headers = sorted(
            os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
        )
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(
            BUILD_DIR, f"libfastsk_kernels_{_digest(srcs + headers, NVCC_FLAGS)}.so"
        )
        if not os.path.exists(out):
            build_log = _build_parallel(srcs, out)
        lib = ctypes.CDLL(out)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pairs_counts_launch.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp]
        lib.pairs_counts_launch.restype = ci
        for fn in (lib.smo_solve_launch, lib.smo_nu_solve_launch):
            fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, cf, ci, vp]
            fn.restype = ci
        ll = ctypes.c_longlong
        lib.packed_band_launch.argtypes = [vp, vp, vp, vp, ll, ll, ci, ci, ci, ci, vp]
        lib.packed_pairlist_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp
        ]
        lib.packed_grouped_launch.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, vp, ci, ci, ci, ci, ci, ci, ci, vp
        ]
        for fn in (lib.packed_band_launch, lib.packed_pairlist_launch,
                   lib.packed_grouped_launch):
            fn.restype = ci
        _KERNELS = lib
        return lib


def native_library(src: str, stem: str) -> str:
    """Compile a host C++ source with g++ into the build directory (reused
    when its hash matches); returns the library path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    flags = ["-O2", "-shared", "-fPIC", "-std=c++14"]
    out = os.path.join(BUILD_DIR, f"{stem}_{_digest([src], flags)}.so")
    if not os.path.exists(out):
        tmp = f"{out}.tmp{os.getpid()}"
        _compile(["g++", *flags, src, "-o", tmp], out)
    return out


def check_launch(status: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
