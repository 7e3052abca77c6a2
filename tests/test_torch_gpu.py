"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips when no
CUDA device is present (decided inside the fixture, so every pytest
worker collects the same tests).  On a machine with the card (which needs
no JAX: ``--noconftest`` skips the repo's conftest, which imports it):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py

Integer results must be bit-exact; the plain versions run on the same
CUDA tensors (their chunk dots in float64, which is exact).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels.packed_matmul import ref as pm
from repro_torch.kernels.packed_matmul.kernel import (
    packed_dense_fused_plain,
    packed_dense_fused_raw,
    packed_matmul_plain,
    packed_matmul_raw,
)
from repro_torch.kernels.packed_matmul.ops import choose_config
from repro_torch.kernels.paged_gather.kernel import paged_gather_plain, paged_gather_raw
from repro_torch.serving import EngineConfig, build_engine

pytestmark = pytest.mark.gpu

PAIRS = [(4, 4, True), (4, 4, False), (2, 3, True), (2, 2, True), (3, 4, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


def _packed(w_bits, a_bits, overpack, m, k, n_groups, seed, dev):
    cfg = choose_config(w_bits, a_bits, allow_overpack=overpack)
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.uniform(-0.1, 1.1, (m, k)).astype(np.float32)).to(dev)
    w_lvl = torch.from_numpy(g.integers(0, 1 << w_bits, (k, n_groups * cfg.n_seg)).astype(np.int32))
    wp = pm.pack_weights(w_lvl, cfg.n_seg, cfg.stride).to(dev)
    return cfg, x, wp


@pytest.mark.parametrize("w_bits,a_bits,overpack", PAIRS)
@pytest.mark.parametrize("m,k,n_groups", [(8, 3072, 96), (3, 517, 300), (13, 40, 7)])
def test_fused_kernel_bit_exact(cuda, w_bits, a_bits, overpack, m, k, n_groups):
    cfg, x, wp = _packed(w_bits, a_bits, overpack, m, k, n_groups, seed=m + k, dev=cuda)
    kw = dict(a_bits=a_bits, n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk,
              overlap=cfg.overlap)
    acc, a_sum = packed_dense_fused_raw(x, wp, **kw)
    p_acc, p_sum = packed_dense_fused_plain(x, wp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, p_acc) and torch.equal(a_sum, p_sum)


@pytest.mark.parametrize("w_bits,a_bits,overpack", PAIRS)
@pytest.mark.parametrize("block_k", [None, 64, 100])
def test_blocked_kernel_bit_exact(cuda, w_bits, a_bits, overpack, block_k):
    cfg, x, wp = _packed(w_bits, a_bits, overpack, 9, 1000, 33, seed=1, dev=cuda)
    a_lvl = torch.round(torch.clamp(x, 0, 1) * ((1 << a_bits) - 1)).to(torch.int32)
    kw = dict(n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap,
              block_k=block_k)
    acc = packed_matmul_raw(a_lvl, wp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, packed_matmul_plain(a_lvl, wp, **kw))


@pytest.mark.parametrize("pool", ["bfloat16", "float32", "int8-bf16", "int8-f32"])
@pytest.mark.parametrize("window,chunk", [(0, 1), (7, 1), (0, 3)])
def test_gather_kernel_bit_exact(cuda, pool, window, chunk):
    g = np.random.default_rng(window + chunk)
    S, nb, ps, D, P = 5, 6, 16, 64, 40
    table = np.zeros((S, nb), np.int32)
    pos = np.zeros((S,), np.int32)
    free = list(range(1, P))
    for s in range(S - 1):  # the last slot stays inactive
        n = int(g.integers(1, nb + 1))
        table[s, :n] = [free.pop(int(g.integers(len(free)))) for _ in range(n)]
        pos[s] = int(g.integers((n - 1) * ps, n * ps))
    fp = torch.from_numpy(g.normal(size=(2, P, ps, D)).astype(np.float32))
    scales = (None, None)
    if pool.startswith("int8"):
        sc = fp.abs().amax(-1, keepdim=True) / 127 + 1e-12
        lv = torch.clamp(torch.round(fp / sc), -127, 127).to(torch.int8)
        pools = (lv[0].to(cuda), lv[1].to(cuda))
        scales = (sc[0].to(cuda), sc[1].to(cuda))
        out = torch.bfloat16 if pool.endswith("bf16") else torch.float32
    else:
        out = getattr(torch, pool)
        pools = (fp[0].to(cuda, out), fp[1].to(cuda, out))
    args = (torch.from_numpy(table).to(cuda), torch.from_numpy(pos).to(cuda), window, *pools, *scales)
    got = paged_gather_raw(*args, chunk=chunk, out_dtype=out)
    want = paged_gather_plain(*args, chunk=chunk, out_dtype=out)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_engine_runs_through_the_kernels(cuda):
    cfg = get_config("llama3.2-3b", smoke=True)
    eng = build_engine(cfg, EngineConfig(n_slots=4, page_size=8, max_len=64, packed_head=True,
                                         head_bits=(4, 4), gather_backend="kernel"),
                       quant="packed", w_bits=4, a_bits=4, device=cuda)
    for n in (3, 7, 5):
        eng.submit(list(range(1, n + 1)), 6)
    eng.warmup()
    build.reset_counts()
    m = eng.run(realtime=False)
    assert m["statuses"] == {"ok": 3}
    per_step = {"packed_dense_fused": cfg.n_layers * 7 + 1, "packed_matmul": 0,
                "paged_gather": cfg.n_layers}
    assert build.counts() == {k: v * m["steps"] for k, v in per_step.items()}
