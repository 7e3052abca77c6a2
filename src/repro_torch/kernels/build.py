"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (``build/<name>-<hash>.so`` at the
repository root), loaded with ``ctypes``.  The hash covers the sources
(every ``.cu`` and ``.cuh`` in ``csrc/``) and the flags, so a stale
library is never loaded.  Missing libraries are built at first use, all
sources at once with one ``nvcc`` process each.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.

Launch counters: each kernel wrapper calls :func:`launched` once per
kernel launch, and nowhere else, so a run can show which kernels its
path went through (:func:`reset_counts`, :func:`counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("packed_matmul", "paged_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every entry point, per library
SIGNATURES = {
    "packed_matmul": {
        # x, wp, acc, a_sum, M, K, Np, a_bits, n_seg, stride, acc_chunk, overlap, stream
        "packed_dense_fused": (_P, _P, _P, _P) + (_I,) * 8 + (_P,),
        # a, wp, acc, M, K, Np, n_seg, stride, acc_chunk, overlap, block_k, stream
        "packed_matmul": (_P, _P, _P) + (_I,) * 8 + (_P,),
    },
    "paged_gather": {
        # table, pos, window, pool_k, pool_v, k_out, v_out, mask,
        # S, NB, PS, row_bytes, C, stream
        "paged_gather_fp": (_P, _P, _I, _P, _P, _P, _P, _P) + (_I,) * 5 + (_P,),
        # table, pos, window, pool_k, pool_v, k_scale, v_scale, k_out, v_out,
        # mask, S, NB, PS, D, C, out_bf16, stream
        "paged_gather_i8": (_P, _P, _I) + (_P,) * 7 + (_I,) * 6 + (_P,),
    },
}

# the kernel-library handles and the launch counters: the port's only
# module-level state
_LIBS: dict[str, ctypes.CDLL] = {}
COUNTS: dict[str, int] = {"packed_dense_fused": 0, "packed_matmul": 0, "paged_gather": 0}


def launched(kernel: str) -> None:
    COUNTS[kernel] += 1


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def counts() -> dict[str, int]:
    return dict(COUNTS)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all in
    parallel.  Returns each library's ``ptxas -v`` report (empty for a
    library that was already built); raises if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {n: "" for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(prefix=f"{n}-", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports, failed = {n: "" for n in names}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[n] = out
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
