"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (``build/<name>-<hash>.so`` at the
repository root), loaded with ``ctypes``.  The hash covers the sources
(every ``.cu`` and ``.cuh`` in ``csrc/``) and the flags, so a stale
library is never loaded.  Missing libraries are built at first use, all
sources at once with one ``nvcc`` process each.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.  A
kernel that fails to build, load or launch raises :class:`KernelError`,
which the serving engine's fault layer never recovers.

Launch counters: each kernel wrapper calls :func:`launched` once per
kernel launch, and nowhere else, so a run can show which kernels its
path went through (:func:`reset_counts`, :func:`counts`).  A replay of a
captured CUDA graph calls no wrapper: its replayer adds the launches the
capture counted (:func:`replayed`), and :func:`graph_census` reads the
graph's own kernel nodes to hold that count against.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("packed_matmul", "paged_gather", "quant_matmul", "filter_conv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int


class KernelError(RuntimeError):
    """A kernel library failed to build or load, or a kernel reported a
    CUDA error."""


# C signature of every entry point, per library
SIGNATURES = {
    "packed_matmul": {
        # x, wp, acc, a_sum, ws, counters, E, M, K, Np, a_bits, n_seg, stride,
        # acc_chunk, overlap, vec, splits, k_per_split, stream
        "packed_dense_fused": (_P,) * 6 + (_I,) * 12 + (_P,),
        # a, wp, acc, ws, counters, E, M, K, Np, n_seg, stride, acc_chunk,
        # overlap, block_k, vec, splits, k_per_split, stream
        "packed_matmul": (_P,) * 5 + (_I,) * 12 + (_P,),
    },
    "paged_gather": {
        # table, pos, window, pool_k, pool_v, k_out, v_out, mask,
        # S, NB, PS, row_bytes, C, stream
        "paged_gather_fp": (_P, _P, _I, _P, _P, _P, _P, _P) + (_I,) * 5 + (_P,),
        # table, pos, window, pool_k, pool_v, k_scale, v_scale, k_out, v_out,
        # mask, S, NB, PS, D, C, out_bf16, rows, threads, stream
        "paged_gather_i8": (_P, _P, _I) + (_P,) * 7 + (_I,) * 8 + (_P,),
    },
    "quant_matmul": {
        # a, w, scale, out, ws, counters, M, K, N, bm, copy, splits,
        # k_per_split, stream
        "quant_matmul": (_P,) * 6 + (_I,) * 7 + (_P,),
        # a, wp, acc, ws, counters, M, K, Np, n_seg, stride, acc_chunk, overlap,
        # copy, splits, k_per_split, stream
        "quant_packed_matmul": (_P,) * 5 + (_I,) * 10 + (_P,),
    },
    "filter_conv": {
        # s, fp, out, B, C, n_pad, n_fc, k_p, n_p, stride, acc_chunk, overlap, n_out,
        # T, cs, cp, nv_max, stream
        "filter_conv": (_P,) * 3 + (_I,) * 14 + (_P,),
    },
}

# the kernel-library handles and the launch counters: the port's only
# module-level state
_LIBS: dict[str, ctypes.CDLL] = {}
COUNTS: dict[str, int] = {
    "packed_dense_fused": 0, "packed_matmul": 0, "paged_gather": 0,
    "quant_matmul": 0, "quant_packed_matmul": 0, "filter_conv": 0,
}


def launched(kernel: str) -> None:
    COUNTS[kernel] += 1


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def counts() -> dict[str, int]:
    return dict(COUNTS)


def replayed(launches: dict[str, int]) -> None:
    """Count one replay of a CUDA graph whose capture launched ``launches``."""
    for k, n in launches.items():
        COUNTS[k] += n


@contextlib.contextmanager
def uncounted():
    """Leave the counters as they were before the block (warm-up calls and
    captures, whose launches no run should count)."""
    saved = counts()
    try:
        yield
    finally:
        COUNTS.update(saved)


# CUgraphNodeType values (cuda.h)
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}
# each csrc kernel's name (mangled or not) -> its wrapper's launch counter;
# packed_ring_kernel's third template argument tells K1 (fused) from K2
_NAMED_COUNTERS = (
    (re.compile(r"packed_ring_kernel(?:ILi\d+ELb\dELb1E|<\d+, \w+, true)"), "packed_dense_fused"),
    (re.compile(r"packed_ring_kernel(?:ILi\d+ELb\dELb0E|<\d+, \w+, false)"), "packed_matmul"),
    (re.compile(r"gather_(?:fp|i8)"), "paged_gather"),
    (re.compile(r"quant_mma_kernel"), "quant_matmul"),
    (re.compile(r"quant_packed_mma_kernel"), "quant_packed_matmul"),
    (re.compile(r"filter_tile_kernel"), "filter_conv"),
)


# the function-name family of each csrc kernel (its name without template
# arguments): gather_fp and gather_i8 share the paged_gather counter
_FAMILY = re.compile(r"packed_ring_kernel|gather_fp|gather_i8|quant_packed_mma_kernel|quant_mma_kernel"
                     r"|filter_tile_kernel")


class _KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem", ctypes.c_uint), ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_census(graph) -> dict:
    """What a captured ``torch.cuda.CUDAGraph(keep_graph=True)`` runs, read
    from its nodes with libcuda: ``{"kinds": {node kind: n}, "kernels":
    {launch counter: n}, "families": {kernel name: n}}``, the kernel nodes
    of this package's kernels counted under their wrappers' counters and
    every other kernel node under ``"other"``; ``"families"`` counts this
    package's kernel nodes by function name (``gather_fp``, ``gather_i8``,
    ``packed_ring_kernel``, ...)."""
    cuda = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        err = getattr(cuda, fn)(*args)
        if err != 0:
            raise RuntimeError(f"{fn} failed: CUresult {err}")

    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    call("cuGraphGetNodes", raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
    kinds: dict[str, int] = {}
    kernels: dict[str, int] = {}
    families: dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        name = GRAPH_NODE_KINDS.get(kind.value, str(kind.value))
        kinds[name] = kinds.get(name, 0) + 1
        if name != "kernel":
            continue
        p = _KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(p))
        fname = ctypes.c_char_p()
        if p.func:
            call("cuFuncGetName", ctypes.byref(fname), ctypes.c_void_p(p.func))
        else:
            call("cuKernelGetName", ctypes.byref(fname), ctypes.c_void_p(p.kern))
        text = fname.value.decode()
        counter = next((c for pat, c in _NAMED_COUNTERS if pat.search(text)), "other")
        kernels[counter] = kernels.get(counter, 0) + 1
        family = _FAMILY.search(text) if counter != "other" else None
        if family:
            families[family.group()] = families.get(family.group(), 0) + 1
    return {"kinds": kinds, "kernels": kernels, "families": families}


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
        raise KernelError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
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
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing); a library
    that does not load, or lacks an entry point, raises :class:`KernelError`."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        try:
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
        except (OSError, AttributeError) as err:  # not loadable, or an entry point missing
            raise KernelError(f"{name}: {path} does not load as the kernel library: {err}") from err
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise KernelError(f"{what}: CUDA error {err}: {msg}")
