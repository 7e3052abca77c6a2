"""The port's CUDA kernels against their plain versions, and the engine's
captured step against its eager one (``capture=False``), on the card.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips when no
CUDA device is present (decided inside the fixture, so every pytest
worker collects the same tests).  On a machine with the card (which needs
no JAX: ``--noconftest`` skips the repo's conftest, which imports it):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py

Integer results must be bit-exact; the plain versions run on the same
CUDA tensors (their chunk dots in float64, which is exact).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.quant import weight_to_int_levels
from repro_torch.kernels import build
from repro_torch.kernels.filter_conv import ref as fc
from repro_torch.kernels.filter_conv.kernel import filter_conv_plain, filter_conv_raw
from repro_torch.kernels.filter_conv.ops import choose_filter_config, packed_conv1d
from repro_torch.kernels.packed_matmul import ref as pm
from repro_torch.kernels.packed_matmul.kernel import (
    packed_dense_fused_plain,
    packed_dense_fused_raw,
    packed_matmul_plain,
    packed_matmul_raw,
)
from repro_torch.kernels.packed_matmul.ops import choose_config
from repro_torch.kernels.paged_gather.kernel import paged_gather_plain, paged_gather_raw
from repro_torch.kernels.quant_matmul.kernel import (
    quant_matmul_plain,
    quant_matmul_raw,
    quant_packed_matmul_plain,
    quant_packed_matmul_raw,
)
from repro_torch.kernels.quant_matmul.ops import choose_mxu_config, quant_dense, quant_packed_dense
from repro_torch.serving import EngineConfig, build_engine

pytestmark = pytest.mark.gpu

# w5a4 (n_seg 2, stride 10, acc_chunk 4) and w3a2 (n_seg 3, stride 6,
# acc_chunk 6) are the placements of the searched llama3.2-3b plan
PAIRS = [(4, 4, True), (4, 4, False), (2, 3, True), (2, 2, True), (3, 4, False), (5, 4, True),
         (3, 2, True)]


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


# n_groups (the packed width Np) picks the copy path: 96 and 300 take
# 16-byte copies, 33 and 7 the 4-byte path; K = 517 and 40 end mid-stage;
# M = 1, 8, 33 fill one, one and five row tiles, M = 128 (8 slots x a chunk
# of 16) sixteen; K = 3072 at Np = 96 splits K
@pytest.mark.parametrize("w_bits,a_bits,overpack", PAIRS)
@pytest.mark.parametrize("m,k,n_groups", [(8, 3072, 96), (3, 517, 300), (13, 40, 7), (1, 3072, 96),
                                          (33, 517, 33), (8, 8192, 7), (33, 40, 96),
                                          (128, 3072, 1536)])
def test_fused_kernel_bit_exact(cuda, w_bits, a_bits, overpack, m, k, n_groups):
    cfg, x, wp = _packed(w_bits, a_bits, overpack, m, k, n_groups, seed=m + k, dev=cuda)
    kw = dict(a_bits=a_bits, n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk,
              overlap=cfg.overlap)
    acc, a_sum = packed_dense_fused_raw(x, wp, **kw)
    p_acc, p_sum = packed_dense_fused_plain(x, wp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, p_acc) and torch.equal(a_sum, p_sum)


# block_k 7 restarts chunks below acc_chunk; 100 and 512 mid-stage
@pytest.mark.parametrize("w_bits,a_bits,overpack", PAIRS)
@pytest.mark.parametrize("block_k", [None, 7, 64, 100, 512])
@pytest.mark.parametrize("m,k,n_groups", [(9, 1000, 33), (8, 3072, 96)])
def test_blocked_kernel_bit_exact(cuda, w_bits, a_bits, overpack, block_k, m, k, n_groups):
    cfg, x, wp = _packed(w_bits, a_bits, overpack, m, k, n_groups, seed=1, dev=cuda)
    a_lvl = torch.round(torch.clamp(x, 0, 1) * ((1 << a_bits) - 1)).to(torch.int32)
    kw = dict(n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap,
              block_k=block_k)
    acc = packed_matmul_raw(a_lvl, wp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, packed_matmul_plain(a_lvl, wp, **kw))


@pytest.mark.parametrize("block_k", [None, 512], ids=["K1", "K2"])
def test_padded_n_seg_3_projection_drops_its_padding(cuda, block_k):
    """w3a2 packs 3 segments a word, so N = 1024 (wk, wv of llama3.2-3b)
    pads to 1026: ``packed_dense`` on the card returns the 1024 columns of
    the CPU's, bit for bit, from the same packed words."""
    from repro_torch.kernels.packed_matmul.ops import packed_dense, prepack_dense

    g = np.random.default_rng(20)
    w = torch.from_numpy(g.normal(size=(3072, 1024)).astype(np.float32))
    x = torch.from_numpy(g.uniform(0, 1, (8, 3072)).astype(np.float32))
    pre = prepack_dense(w, w_bits=3, a_bits=2, block_k=block_k, device="cpu")
    assert pre.cfg.n_seg == 3 and pre.w_packed.shape == (3072, 342)
    build.reset_counts()
    got = packed_dense(x.to(cuda), pre.to(cuda))
    torch.cuda.synchronize()
    assert build.counts()["packed_dense_fused" if block_k is None else "packed_matmul"] == 1
    want = packed_dense(x, pre)
    assert got.shape == want.shape == (8, 1024) and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n_groups", [96, 33])
def test_split_kernels_replay_in_a_cuda_graph(cuda, n_groups):
    """K1 and K2 at shapes that split K, captured once and replayed three
    times on new activations: every replay must be exact, so the split
    reduction's arrival counters must return to zero after each launch."""
    cfg, x, wp = _packed(4, 4, True, 8, 3072, n_groups, seed=5, dev=cuda)
    kw = dict(n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap)
    a_lvl = torch.round(torch.clamp(x, 0, 1) * 15).to(torch.int32)
    packed_dense_fused_raw(x, wp, a_bits=4, **kw)  # the counters are allocated outside the capture
    packed_matmul_raw(a_lvl, wp, block_k=512, **kw)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        acc, a_sum = packed_dense_fused_raw(x, wp, a_bits=4, **kw)
        acc2 = packed_matmul_raw(a_lvl, wp, block_k=512, **kw)
    rng = np.random.default_rng(6)
    for _ in range(3):
        x.copy_(torch.from_numpy(rng.uniform(-0.1, 1.1, tuple(x.shape)).astype(np.float32)))
        a_lvl.copy_(torch.round(torch.clamp(x, 0, 1) * 15).to(torch.int32))
        for t in (acc, a_sum, acc2):
            t.fill_(-1)
        g.replay()
        torch.cuda.synchronize()
        p_acc, p_sum = packed_dense_fused_plain(x, wp, a_bits=4, **kw)
        assert torch.equal(acc, p_acc) and torch.equal(a_sum, p_sum)
        assert torch.equal(acc2, packed_matmul_plain(a_lvl, wp, block_k=512, **kw))


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



def _k3_pools(cuda, S, nb, ps, D, seed, lengths, offset=0):
    """Block table, positions and K/V pools for K3 on the card: live slots
    of ``lengths`` tokens (the last slot inactive), pages from a shuffled
    free list, a NaN null page; bf16 pools and int8 levels with per-row
    scales of the same values.  ``offset``: each pool (and scale pool) is
    a view ``offset`` bytes into a larger allocation."""
    g = np.random.default_rng(seed)
    P = S * nb + 1
    table = np.zeros((S, nb), np.int32)
    pos = np.zeros((S,), np.int32)
    free = g.permutation(np.arange(1, P)).tolist()
    for s in range(S - 1):
        length = int(g.integers(*lengths))
        n = min(nb, length // ps + 1)
        table[s, :n] = [free.pop() for _ in range(n)]
        pos[s] = length
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    fp = torch.randn((2, P, ps, D), generator=gen, device=cuda)
    fp[:, 0] = float("nan")
    sc = fp.abs().amax(-1, keepdim=True).nan_to_num(1.0) / 127 + 1e-12
    lv = torch.clamp(torch.round(fp.nan_to_num(0.0) / sc), -127, 127).to(torch.int8)
    bf = fp.to(torch.bfloat16)
    del fp

    def place(t):  # t's values in a fresh allocation, ``offset`` bytes in
        n, e = t.numel(), t.element_size()
        flat = torch.empty(n + (offset + 256) // e, dtype=t.dtype, device=cuda)
        out = flat[offset // e:offset // e + n].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 256 == offset % 256
        return out

    pools = {"bf16": tuple(place(bf[i]) for i in range(2)),
             "int8": tuple(place(lv[i]) for i in range(2)) + tuple(place(sc[i]) for i in range(2))}
    return torch.from_numpy(table).to(cuda), torch.from_numpy(pos).to(cuda), pools


def _k3_exact(table, pos, pools, pool, window, chunk):
    out = {"bfloat16": torch.bfloat16, "int8-bf16": torch.bfloat16, "int8-f32": torch.float32}[pool]
    ops = pools["bf16"] if pool == "bfloat16" else pools["int8"]
    args = (table, pos, window, *ops)
    got = paged_gather_raw(*args, chunk=chunk, out_dtype=out)
    want = paged_gather_plain(*args, chunk=chunk, out_dtype=out)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (pool, window, chunk)


@pytest.mark.parametrize("pool", ["bfloat16", "int8-bf16", "int8-f32"])
@pytest.mark.parametrize("S,nb,ps,D,lengths", [
    (32, 256, 16, 1024, (1024, 4096)),  # chip_smoke.py's long-context geometry
    (8, 16, 16, 256, (17, 256)), (8, 16, 16, 1536, (17, 256)),
    (8, 32, 8, 1024, (17, 256)), (8, 8, 32, 1024, (17, 256)),
], ids=["long", "D256", "D1536", "ps8", "ps32"])
def test_gather_kernel_bit_exact_at_other_geometries(cuda, pool, S, nb, ps, D, lengths):
    table, pos, pools = _k3_pools(cuda, S, nb, ps, D, seed=S + D + ps, lengths=lengths)
    for window, chunk in ((0, 1), (40, 16)):
        _k3_exact(table, pos, pools, pool, window, chunk)


@pytest.mark.parametrize("pool", ["bfloat16", "int8-bf16", "int8-f32"])
def test_gather_kernel_bit_exact_on_offset_pools(cuda, pool):
    """Pools (and scale pools) 16 bytes past a 256-byte boundary: the
    kernels' 16-byte vectors need no more."""
    table, pos, pools = _k3_pools(cuda, 8, 16, 16, 1024, seed=5, lengths=(17, 256), offset=16)
    for window, chunk in ((0, 1), (40, 16)):
        _k3_exact(table, pos, pools, pool, window, chunk)

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
    per_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                "paged_gather": cfg.n_layers}
    assert build.counts() == {k: v * m["steps"] for k, v in per_step.items()}


# chunked on-demand engine on the card against the CPU, on the same packed
# words.  Both run float32, so a sampled row differs only by float sum order
# (CLEAN_ABS_TOL) unless an activation sits within an ulp of a 4-bit
# rounding boundary and flips a level, which moves the row by about a level
# step and cascades (FLIP_REL_TOL, relative L2); such flips must stay rare
CLEAN_ABS_TOL = 1e-3
FLIP_REL_TOL = 0.2


def test_chunked_on_demand_engine_matches_the_cpu(cuda):
    """chunk_tokens=4 and on-demand admission into a pool too small for the
    worst case: the card preempts as the CPU does, launches K1 and K3 every
    step, and samples the CPU's rows."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import prepack_lm_head
    from repro_torch.serving.api import quantize_params_packed

    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True), dtype=torch.float32)
    params = T.init_params(cfg, seed=3, device="cpu")
    head = prepack_lm_head(params["embed"], w_bits=4, a_bits=4, device="cpu")
    packed = quantize_params_packed(params, w_bits=4, a_bits=4, device="cpu")
    ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=7, chunk_tokens=4,
                        admit="on-demand", packed_head=True, head_bits=(4, 4), gather_backend="kernel")
    g = np.random.default_rng(7)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 11, 5)]
    runs = {}
    for dev in ("cpu", cuda):
        eng = build_engine(cfg, ecfg, params=packed, head=head, device=dev)
        rows = {}
        eng.on_sample = lambda rid, t, row, rows=rows: rows.__setitem__((rid, t), row.copy())
        for p in prompts:
            eng.submit(p, 6)
        build.reset_counts()
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 4} and m["preemptions"] > 0
        eng.assert_no_leaks()
        runs[str(dev)] = (m, build.counts(), rows, {r.rid: r.out_tokens for r in eng.finished})
    (m_c, _, rows_c, toks_c), (m_g, counts, rows_g, toks_g) = runs["cpu"], runs[str(cuda)]
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m_g[key] == m_c[key], key
    per_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                "paged_gather": cfg.n_layers}
    assert counts == {k: v * m_g["steps"] for k, v in per_step.items()}
    clean = flipped = 0
    for rid, theirs in toks_c.items():
        div = next((t for t in range(len(theirs)) if toks_g[rid][t] != theirs[t]), len(theirs) - 1)
        for t in range(div + 1):
            a, b = rows_g[(rid, t)], rows_c[(rid, t)]
            if np.abs(a - b).max() <= CLEAN_ABS_TOL:
                clean += 1
            else:
                flipped += 1
                assert np.linalg.norm(a - b) / np.linalg.norm(b) <= FLIP_REL_TOL, (rid, t)
    assert flipped <= clean


# row tiles by M: 8 (M 1-8), 32 (13, 17), 64 (64), 128 (128, 130); N = 1024,
# 3072, 512, 64, 96 take 16-byte weight copies, 36 and 300 4-byte ones, 129,
# 7 and 33 byte loads; K = 257, 40, 517, 9 are not multiples of 16 (byte
# loads of activations, a ragged last slab); (8, 3072, 1024), (17, 8192,
# 36), (128, 3072, 3072), (64, 3072, 96) and (1, 3072, 512) split K
@pytest.mark.parametrize("m,k,n", [(8, 3072, 1024), (3, 257, 129), (130, 512, 64), (8, 40, 7),
                                   (17, 8192, 36), (128, 3072, 3072), (64, 517, 300), (64, 3072, 96),
                                   (13, 9, 33), (128, 9, 20), (1, 3072, 512)])
def test_quant_matmul_kernel_bit_exact(cuda, m, k, n):
    """K4, ragged M, N and K included, with and without a K split."""
    g = np.random.default_rng(m + k + n)
    a = torch.from_numpy(g.integers(-127, 128, (m, k)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(g.integers(-127, 128, (k, n)).astype(np.int8)).to(cuda)
    scale = torch.from_numpy(g.uniform(1e-6, 1e-3, (1, n)).astype(np.float32)).to(cuda)
    out = quant_matmul_raw(a, w, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, quant_matmul_plain(a, w, scale))


# K = 9, 40, 517 are not multiples of 16 (activations by byte loads, the last
# slab ragged); Np = 75, 7, 1 take the byte-load weight path, 36 and 17000
# the 4-byte copies, the rest 16-byte copies; (8, 3072, 512), (128, 3072,
# 96), (8, 8192, 48) and (1, 3072, 36) split K, (8, 517, 17000) and (16,
# 3072, 16896) fill the card unsplit, M = 128 takes 16 row tiles
@pytest.mark.parametrize("w_bits,a_bits,overpack", [(2, 2, True), (2, 3, True), (2, 2, False)])
@pytest.mark.parametrize("m,k,n_groups", [(8, 3072, 512), (3, 517, 75), (13, 40, 7), (1, 9, 1),
                                          (128, 3072, 96), (8, 8192, 48), (1, 3072, 36),
                                          (13, 517, 75), (128, 9, 20), (8, 517, 17000),
                                          (16, 3072, 16896)])
def test_quant_packed_matmul_kernel_bit_exact(cuda, w_bits, a_bits, overpack, m, k, n_groups):
    """K5 at both int8-lane placements (acc_chunk 7 and 3) and the
    no-overpack w2a2 one, ragged M, K and packed widths included."""
    cfg = choose_mxu_config(w_bits, a_bits, allow_overpack=overpack)
    g = np.random.default_rng(m * k)
    a = torch.from_numpy(g.integers(0, 1 << a_bits, (m, k)).astype(np.int8)).to(cuda)
    w_lvl = torch.from_numpy(g.integers(0, 1 << w_bits, (k, n_groups * cfg.n_seg)).astype(np.int32))
    wp = pm.pack_weights(w_lvl, cfg.n_seg, cfg.stride).to(torch.int8).to(cuda)
    kw = dict(n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap)
    acc = quant_packed_matmul_raw(a, wp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, quant_packed_matmul_plain(a, wp, **kw))
    assert torch.equal(acc.cpu().long(), a.cpu().long() @ w_lvl.long())


@pytest.mark.parametrize("w_bits,a_bits,k_len", [(2, 2, 3), (3, 4, 3), (4, 4, 3), (2, 2, 7),
                                                 (3, 3, 5)])
@pytest.mark.parametrize("b,c,n", [(160, 3, 320), (10, 64, 20), (3, 6, 19), (2, 1, 300), (1, 5, 7),
                                   (1, 64, 40), (2, 3000, 9)])
def test_filter_conv_kernel_bit_exact(cuda, w_bits, a_bits, k_len, b, c, n):
    """K6 at every instantiated coefficient count, both overlap values, rows
    wider than one tile, ragged N, C = 1, C not a multiple of acc_chunk,
    B = 1, and a C staged in several pieces."""
    cfg = choose_filter_config(w_bits, a_bits, k_len)
    g = np.random.default_rng(b + c + n + k_len)
    s = torch.from_numpy(g.integers(0, 1 << a_bits, (b, c, n)).astype(np.int32)).to(cuda)
    f = torch.from_numpy(g.integers(0, 1 << w_bits, (c, k_len)).astype(np.int32)).to(cuda)
    n_pad = -(-n // cfg.n_p) * cfg.n_p
    sp = torch.nn.functional.pad(s, (0, n_pad - n)).contiguous()
    fp = fc.pack_filter(f, cfg.k_p, cfg.stride)
    kw = dict(k_p=cfg.k_p, n_p=cfg.n_p, stride=cfg.stride, acc_chunk=cfg.acc_chunk,
              k_len=k_len, n_len=n, overlap=cfg.overlap)
    out = filter_conv_raw(sp, fp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, filter_conv_plain(sp, fp, **kw))
    assert torch.equal(out, fc.conv_full_levels(f, s))
    assert torch.equal(packed_conv1d(s, f, w_bits=w_bits, a_bits=a_bits), out)


def _filter_placements():
    """(w_bits, a_bits, k_len, overpack) of the first pair that picks each
    distinct placement choose_filter_config selects for bit pairs 2..8 x
    2..8, 3/5/7 taps, overpacked or not."""
    seen = {}
    for k_len in (3, 5, 7):
        for w_bits in range(2, 9):
            for a_bits in range(2, 9):
                for overpack in (True, False):
                    cfg = choose_filter_config(w_bits, a_bits, k_len, allow_overpack=overpack)
                    if cfg is not None and cfg.k_p * cfg.n_p > 1:
                        seen.setdefault((tuple(cfg), k_len), (w_bits, a_bits, k_len, overpack))
    return sorted(seen.values())


@pytest.mark.parametrize("w_bits,a_bits,k_len,overpack", _filter_placements())
def test_filter_conv_kernel_launches_every_placement(cuda, w_bits, a_bits, k_len, overpack):
    """K6 at every placement the chooser can pick, at all-maximum levels
    (every chunk sum at its bound) and random ones: bit-exact."""
    cfg = choose_filter_config(w_bits, a_bits, k_len, allow_overpack=overpack)
    g = np.random.default_rng(w_bits * 100 + a_bits * 10 + k_len)
    b, c, n = 3, 9, 23
    n_pad = -(-n // cfg.n_p) * cfg.n_p
    kw = dict(k_p=cfg.k_p, n_p=cfg.n_p, stride=cfg.stride, acc_chunk=cfg.acc_chunk,
              k_len=k_len, n_len=n, overlap=cfg.overlap)
    for levels in ("max", "random"):
        if levels == "max":
            s = np.full((b, c, n), (1 << a_bits) - 1, np.int32)
            f = np.full((c, k_len), (1 << w_bits) - 1, np.int32)
        else:
            s = g.integers(0, 1 << a_bits, (b, c, n)).astype(np.int32)
            f = g.integers(0, 1 << w_bits, (c, k_len)).astype(np.int32)
        s, f = torch.from_numpy(s).to(cuda), torch.from_numpy(f).to(cuda)
        sp = torch.nn.functional.pad(s, (0, n_pad - n)).contiguous()
        fp = fc.pack_filter(f, cfg.k_p, cfg.stride)
        out = filter_conv_raw(sp, fp, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, filter_conv_plain(sp, fp, **kw))
        assert torch.equal(out, fc.conv_full_levels(f, s))


@pytest.mark.parametrize("n_groups", [512, 36])
def test_quant_packed_split_replays_in_a_cuda_graph(cuda, n_groups):
    """K5 at shapes that split K (16-byte and 4-byte copies), captured once
    and replayed three times on new activations: every replay exact, so the
    split reduction's arrival counters return to zero after each launch."""
    cfg = choose_mxu_config(2, 2)
    g = np.random.default_rng(7)
    a = torch.from_numpy(g.integers(0, 4, (8, 3072)).astype(np.int8)).to(cuda)
    w_lvl = torch.from_numpy(g.integers(0, 4, (3072, 2 * n_groups)).astype(np.int32))
    wp = pm.pack_weights(w_lvl, cfg.n_seg, cfg.stride).to(torch.int8).to(cuda)
    kw = dict(n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap)
    quant_packed_matmul_raw(a, wp, **kw)  # the counters are allocated outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        acc = quant_packed_matmul_raw(a, wp, **kw)
    for _ in range(3):
        a.copy_(torch.from_numpy(g.integers(0, 4, (8, 3072)).astype(np.int8)))
        acc.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(acc, quant_packed_matmul_plain(a, wp, **kw))
        assert torch.equal(acc.cpu().long(), a.cpu().long() @ w_lvl.long())


def _device_kernels(fn):
    """Names of the device-side events (kernels, copies, memsets) of one
    call, from a ``torch.profiler`` trace.  A trace of one short call now and
    then comes back without its device events (the activity buffer misses
    the profiler's flush at exit), so a call is traced again, up to 5 times,
    until one records any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        if evs:
            break
    return [e.name for e in evs]


def test_filter_conv_is_one_kernel_node_and_replays_in_a_cuda_graph(cuda):
    """A K6 call runs one kernel and no memset, and a captured call replays
    exactly on new sequence levels."""
    cfg = choose_filter_config(2, 2, 3)
    g = np.random.default_rng(8)
    b, c, n = 10, 64, 20
    s = torch.from_numpy(g.integers(0, 4, (b, c, n)).astype(np.int32)).to(cuda)
    f = torch.from_numpy(g.integers(0, 4, (c, 3)).astype(np.int32)).to(cuda)
    fp = fc.pack_filter(f, cfg.k_p, cfg.stride)
    kw = dict(k_p=cfg.k_p, n_p=cfg.n_p, stride=cfg.stride, acc_chunk=cfg.acc_chunk, k_len=3, n_len=n,
              overlap=cfg.overlap)
    names = _device_kernels(lambda: filter_conv_raw(s, fp, **kw))
    assert len(names) == 1 and "filter_tile_kernel" in names[0], names
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = filter_conv_raw(s, fp, **kw)
    for _ in range(3):
        s.copy_(torch.from_numpy(g.integers(0, 4, (b, c, n)).astype(np.int32)))
        out.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fc.conv_full_levels(f, s))


def _k4_operands(m, k, n, seed, dev):
    g = np.random.default_rng(seed)
    a = torch.from_numpy(g.integers(-128, 128, (m, k)).astype(np.int8)).to(dev)
    w = torch.from_numpy(g.integers(-128, 128, (k, n)).astype(np.int8)).to(dev)
    scale = torch.from_numpy(g.uniform(1e-6, 1e-3, (1, n)).astype(np.float32)).to(dev)
    return a, w, scale


@pytest.mark.parametrize("m,n", [(8, 1024), (128, 3072), (5, 36)])
def test_quant_matmul_split_replays_in_a_cuda_graph(cuda, m, n):
    """K4 at shapes that split K (row tiles of 8 and 128, 16-byte and
    4-byte copies), captured once and replayed three times on new
    activations: every replay exact, so the split reduction's arrival
    counters return to zero after each launch."""
    a, w, scale = _k4_operands(m, 3072, n, 10, cuda)
    quant_matmul_raw(a, w, scale)  # the counters are allocated outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = quant_matmul_raw(a, w, scale)
    g = np.random.default_rng(11)
    for _ in range(3):
        a.copy_(torch.from_numpy(g.integers(-128, 128, tuple(a.shape)).astype(np.int8)))
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, quant_matmul_plain(a, w, scale))


def test_quant_matmul_is_one_kernel_node(cuda):
    """A K4 call that splits K runs one kernel: no memset, no second pass."""
    a, w, scale = _k4_operands(8, 3072, 1024, 12, cuda)
    names = _device_kernels(lambda: quant_matmul_raw(a, w, scale))
    assert len(names) == 1 and "quant_mma_kernel" in names[0], names


def test_split_launches_on_two_streams_keep_their_own_counters(cuda):
    """K1, K5 and K4 at shapes that split K, launched in turns on two
    streams for many rounds with no synchronisation between the streams:
    each stream's launches take their own arrival counters, so every output
    equals its plain version."""
    from repro_torch.kernels.packed_matmul.kernel import _split_scratch

    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    ptrs = []
    for st in streams:
        with torch.cuda.stream(st):
            _, _, _, counters = _split_scratch(cuda, 8, 3072, 96, 64)
            ptrs.append(counters.data_ptr())
    assert ptrs[0] != ptrs[1]
    c1, c5 = choose_config(4, 4), choose_mxu_config(2, 2)
    kw1 = dict(n_seg=c1.n_seg, stride=c1.stride, acc_chunk=c1.acc_chunk, overlap=c1.overlap)
    kw5 = dict(n_seg=c5.n_seg, stride=c5.stride, acc_chunk=c5.acc_chunk, overlap=c5.overlap)
    ops = []
    for i in range(len(streams)):
        _, x, wp = _packed(4, 4, True, 8, 3072, 96, seed=20 + i, dev=cuda)
        g = np.random.default_rng(30 + i)
        a5 = torch.from_numpy(g.integers(0, 4, (8, 3072)).astype(np.int8)).to(cuda)
        w5 = pm.pack_weights(torch.from_numpy(g.integers(0, 4, (3072, 1024)).astype(np.int32)),
                             c5.n_seg, c5.stride).to(torch.int8).to(cuda)
        ops.append((x, wp, a5, w5, *_k4_operands(8, 3072, 1024, 40 + i, cuda)))
    torch.cuda.synchronize()
    outs = [[] for _ in streams]
    for _ in range(50):
        for i, st in enumerate(streams):
            x, wp, a5, w5, a4, w4, s4 = ops[i]
            with torch.cuda.stream(st):
                outs[i].append((packed_dense_fused_raw(x, wp, a_bits=4, **kw1),
                                quant_packed_matmul_raw(a5, w5, **kw5), quant_matmul_raw(a4, w4, s4)))
    torch.cuda.synchronize()
    for i in range(len(streams)):
        x, wp, a5, w5, a4, w4, s4 = ops[i]
        want = (packed_dense_fused_plain(x, wp, a_bits=4, **kw1), quant_packed_matmul_plain(a5, w5, **kw5),
                quant_matmul_plain(a4, w4, s4))
        for (acc1, sum1), acc5, out4 in outs[i]:
            assert torch.equal(acc1, want[0][0]) and torch.equal(sum1, want[0][1])
            assert torch.equal(acc5, want[1]) and torch.equal(out4, want[2])


def test_quant_packed_matmul_is_one_kernel_node(cuda):
    """A K5 call that splits K runs one kernel: no memset, no second pass."""
    cfg = choose_mxu_config(2, 3)
    g = np.random.default_rng(9)
    a = torch.from_numpy(g.integers(0, 8, (8, 3072)).astype(np.int8)).to(cuda)
    wp = torch.from_numpy(g.integers(0, 100, (3072, 512)).astype(np.int8)).to(cuda)
    kw = dict(n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap)
    names = _device_kernels(lambda: quant_packed_matmul_raw(a, wp, **kw))
    assert len(names) == 1 and "quant_packed_mma_kernel" in names[0], names


@pytest.mark.parametrize("w_bits,a_bits", [(2, 2), (2, 3), (4, 4), (8, 8)])
def test_int8_lane_dense_layers_match_the_cpu(cuda, w_bits, a_bits):
    """quant_packed_dense (K5, or the plain integer path in float64 for
    w4a4 and w8a8) and quant_dense (K4) on the card against the CPU, on
    columns whose weight levels agree (tanh may round differently)."""
    g = np.random.default_rng(w_bits * 10 + a_bits)
    x = torch.from_numpy(g.uniform(-0.1, 1.1, (8, 300)).astype(np.float32))
    w = torch.from_numpy(g.normal(size=(300, 98)).astype(np.float32))
    got = quant_packed_dense(x.to(cuda), w.to(cuda), w_bits=w_bits, a_bits=a_bits).cpu()
    want = quant_packed_dense(x, w, w_bits=w_bits, a_bits=a_bits)
    clean = (weight_to_int_levels(w.to(cuda), w_bits)[0].cpu()
             == weight_to_int_levels(w, w_bits)[0]).all(dim=0)
    assert int(clean.sum()) >= 94
    assert torch.equal(got[:, clean], want[:, clean])
    assert torch.equal(quant_dense(x.to(cuda), w.to(cuda)).cpu(), quant_dense(x, w))


def test_default_bits_engine_serves(cuda):
    """build_engine's default w4a8 and the (8, 8) packed head run the plain
    integer path on the card and launch no packing kernel."""
    cfg = get_config("llama3.2-3b", smoke=True)
    eng = build_engine(cfg, EngineConfig(n_slots=4, page_size=8, max_len=64, packed_head=True),
                       quant="packed", device=cuda)
    for n in (3, 7, 5):
        eng.submit(list(range(1, n + 1)), 6)
    eng.warmup()
    build.reset_counts()
    m = eng.run(realtime=False)
    assert m["statuses"] == {"ok": 3}
    assert build.counts() == dict.fromkeys(build.COUNTS, 0)


# -- the captured step ----------------------------------------------------------------


def _packed_smoke(cuda, cfg=None, seed=3):
    """w4a4 packed projections and the packed (4, 4) head on the card."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import prepack_lm_head
    from repro_torch.serving.api import quantize_params_packed

    cfg = cfg or get_config("llama3.2-3b", smoke=True)
    params = T.init_params(cfg, seed=seed, device=cuda)
    head = prepack_lm_head(params["embed"], w_bits=4, a_bits=4, device=cuda)
    return cfg, quantize_params_packed(params, w_bits=4, a_bits=4, device=cuda), head


def _step_logits(eng) -> list:
    """Spy on an engine's step program: a copy of every step's logits."""
    seen, run = [], eng._program.run

    def spy(*args):
        out = run(*args)
        seen.append(out.copy())
        return out

    eng._program.run = spy
    return seen


@pytest.mark.parametrize("chunk,admit,n_pages", [(1, "reserve", 0), (4, "on-demand", 7)])
def test_captured_engine_equals_the_eager_engine(cuda, chunk, admit, n_pages):
    """The captured step against capture=False on the same weights: every
    step's logits bit-identical, the same tokens, steps and preemptions,
    and the launch counters of the eager run."""
    from repro_torch.serving import Engine

    cfg, packed, head = _packed_smoke(cuda)
    ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=n_pages, chunk_tokens=chunk,
                        admit=admit, packed_head=True, head_bits=(4, 4), gather_backend="kernel")
    g = np.random.default_rng(7)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 11, 5)]
    runs = []
    for capture in (False, True):
        eng = Engine(cfg, packed, ecfg, head=head, device=cuda, capture=capture)
        logits = _step_logits(eng)
        for p in prompts:
            eng.submit(p, 6)
        build.reset_counts()
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 4}
        assert (eng._program.graph is not None) == capture
        runs.append((m, build.counts(), logits, {r.rid: r.out_tokens for r in eng.finished}))
        eng.close()
    (m_e, counts_e, logits_e, toks_e), (m_c, counts_c, logits_c, toks_c) = runs
    if admit == "on-demand":
        assert m_c["preemptions"] > 0
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m_c[key] == m_e[key], key
    assert toks_c == toks_e and counts_c == counts_e
    assert len(logits_c) == len(logits_e) == m_c["steps"]
    for t, (a, b) in enumerate(zip(logits_c, logits_e)):
        assert a.tobytes() == b.tobytes(), t


@pytest.mark.parametrize("block_k", [None, 16], ids=["K1", "K2"])
def test_captured_step_graph_nodes_equal_its_launches(cuda, block_k):
    """The captured graph's kernel nodes are the launches its capture
    counted, per replay: K1 at every projection and the head (or K2 at
    every projection with block_k), K3 at every layer; no memset."""
    import dataclasses as dc

    from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine

    cfg, packed, head = _packed_smoke(cuda)
    if block_k:
        packed = T.map_leaves(packed, lambda a: dc.replace(a, block_k=block_k)
                              if isinstance(a, PackedDenseParams) else a)
    eng = Engine(cfg, packed, EngineConfig(n_slots=4, page_size=8, max_len=64, gather_backend="kernel"),
                 head=head, device=cuda)
    eng.warmup()
    L = cfg.n_layers
    want = ({"packed_dense_fused": 7 * L + 1} if block_k is None
            else {"packed_dense_fused": 1, "packed_matmul": 7 * L})
    want["paged_gather"] = L
    census = build.graph_census(eng._program.graph)
    assert eng._program.launches == want
    assert {k: v for k, v in census["kernels"].items() if k != "other"} == want
    assert "memset" not in census["kinds"], census
    eng.close()


@pytest.mark.parametrize("chunk", [1, 4])
def test_eager_step_reads_nothing_back_to_the_host(cuda, chunk):
    """After the warm-up, an eager step makes no synchronising call
    (``.item()``, a device-to-host copy): it can be captured."""
    cfg, packed, head = _packed_smoke(cuda)
    eng = build_engine(cfg, EngineConfig(n_slots=4, page_size=8, max_len=64, chunk_tokens=chunk,
                                         packed_head=True, head_bits=(4, 4), gather_backend="kernel"),
                       params=packed, head=head, device=cuda, capture=False)
    eng.warmup()
    prog = eng._program
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode(), prog._on_stream():
            prog._forward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_two_engines_replay_on_their_own_streams(cuda):
    """Two captured engines whose projections split K, each replayed in
    turns on its own stream with no synchronisation between the streams:
    every replay's logits equal its eager twin's, so the two graphs hold
    different split-K counter slots."""
    import dataclasses as dc

    from repro_torch.kernels.packed_matmul.kernel import _COUNTERS
    from repro_torch.serving import Engine

    cfg = dc.replace(get_config("llama3.2-3b", smoke=True), n_layers=1, d_model=1024, n_heads=8,
                     kv_heads=2, head_dim=128, d_ff=2048)
    cfg, packed, head = _packed_smoke(cuda, cfg)
    ecfg = EngineConfig(n_slots=4, page_size=8, max_len=64, packed_head=True, head_bits=(4, 4),
                        gather_backend="kernel")
    g = np.random.default_rng(12)
    progs, want = [], []
    for i in range(2):
        table = np.zeros((4, ecfg.blocks_per_slot), np.int32)
        table[:3, :2] = np.arange(1, 7).reshape(3, 2) + 6 * i
        batch = (g.integers(1, cfg.vocab, (4, 1)).astype(np.int32), np.array([3, 9, 12, 0], np.int32),
                 np.array([1, 1, 1, 0], np.int32), table)
        eager = Engine(cfg, packed, ecfg, head=head, device=cuda, capture=False)
        want.append(eager._program.run(*batch).copy())
        eng = Engine(cfg, packed, ecfg, head=head, device=cuda)
        assert eng._program.run(*batch).tobytes() == want[-1].tobytes()
        progs.append(eng._program)
    slots = _COUNTERS[torch.cuda.current_device()][1]._of
    streams = [p.stream.cuda_stream for p in progs]
    assert streams[0] != streams[1] and set(streams) <= set(slots)
    outs = [[], []]
    for _ in range(20):
        for i, p in enumerate(progs):
            with torch.cuda.stream(p.stream):
                p.graph.replay()
                outs[i].append(p.logits.clone())
    torch.cuda.synchronize()
    for i in range(2):
        for out in outs[i]:
            assert out.cpu().numpy().tobytes() == want[i].tobytes(), i


def test_captured_plan_engine_equals_the_eager_engine(cuda):
    """``build_engine(plan=...)`` on a 3-layer plan of three pairs (w8a8 on
    the plain integer path, w5a4 at block_k 16 on K2, w3a2 on K1) and a
    (4, 4) head, captured against capture=False from the same float
    weights: every step's logits bit-identical, the same tokens and
    launch counters."""
    from repro_torch.models import transformer as T
    from repro_torch.plan import plan_from_bits

    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True), n_layers=3)
    plan = plan_from_bits(cfg, arch="llama3.2-3b", bits=[(8, 8), (5, 4), (3, 2)], head_bits=(4, 4))
    plan = dataclasses.replace(plan, layers=[plan.layers[0], dataclasses.replace(plan.layers[1], block_k=16),
                                             plan.layers[2]])
    params = T.init_params(cfg, seed=4, device=cuda)
    ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=7, chunk_tokens=4,
                        admit="on-demand", gather_backend="kernel")
    g = np.random.default_rng(8)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 11, 5)]
    runs = []
    for capture in (False, True):
        eng = build_engine(cfg, ecfg, params=params, plan=plan, device=cuda, capture=capture)
        logits = _step_logits(eng)
        for p in prompts:
            eng.submit(p, 6)
        build.reset_counts()
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 4} and m["preemptions"] > 0
        eng.assert_no_leaks()
        runs.append((m, build.counts(), logits, {r.rid: r.out_tokens for r in eng.finished}))
        if capture:
            assert eng._program.launches == {"packed_dense_fused": 7 + 1, "packed_matmul": 7,
                                             "paged_gather": 3}
        eng.close()
    (m_e, counts_e, logits_e, toks_e), (m_c, counts_c, logits_c, toks_c) = runs
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m_c[key] == m_e[key], key
    assert toks_c == toks_e and counts_c == counts_e
    assert counts_c["packed_matmul"] == 7 * m_c["steps"]
    for t, (a, b) in enumerate(zip(logits_c, logits_e)):
        assert a.tobytes() == b.tobytes(), t


# -- int8 KV pools and int8 serving weights ------------------------------------------


def _run_captured_and_eager(cfg, params, ecfg, cuda, head=None, n_prompts=4):
    """Serve the same prompts captured and with capture=False: per mode the
    metrics, launch counters, every step's logits, tokens and the graph's
    census (None eagerly)."""
    from repro_torch.serving import Engine

    g = np.random.default_rng(7)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 11, 5)[:n_prompts]]
    runs = []
    for capture in (False, True):
        eng = Engine(cfg, params, ecfg, head=head, device=cuda, capture=capture)
        logits = _step_logits(eng)
        for p in prompts:
            eng.submit(p, 6)
        build.reset_counts()
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": len(prompts)}
        eng.assert_no_leaks()
        census = build.graph_census(eng._program.graph) if capture else None
        runs.append((m, build.counts(), logits, {r.rid: r.out_tokens for r in eng.finished}, census))
        eng.close()
    return runs


def _assert_same_runs(runs) -> None:
    (m_e, counts_e, logits_e, toks_e, _), (m_c, counts_c, logits_c, toks_c, _) = runs
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m_c[key] == m_e[key], key
    assert toks_c == toks_e and counts_c == counts_e
    assert len(logits_c) == len(logits_e) == m_c["steps"]
    for t, (a, b) in enumerate(zip(logits_c, logits_e)):
        assert a.tobytes() == b.tobytes(), t


@pytest.mark.parametrize("chunk,admit,n_pages", [(1, "reserve", 0), (4, "on-demand", 7)])
def test_captured_int8_kv_engine_equals_the_eager_engine(cuda, chunk, admit, n_pages):
    """w4a4 packed projections on int8 KV pools: the captured step against
    capture=False, every step's logits bit-identical (preemption and replay
    rewrite levels and scales in both), and every K3 node of the graph
    ``gather_i8``."""
    cfg, packed, head = _packed_smoke(cuda)
    cfg = dataclasses.replace(cfg, kv_dtype="int8")
    ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=n_pages, chunk_tokens=chunk,
                        admit=admit, packed_head=True, head_bits=(4, 4), gather_backend="kernel")
    runs = _run_captured_and_eager(cfg, packed, ecfg, cuda, head=head)
    _assert_same_runs(runs)
    m, counts, _, _, census = runs[1]
    if admit == "on-demand":
        assert m["preemptions"] > 0
    assert counts["paged_gather"] == cfg.n_layers * m["steps"]
    assert census["families"]["gather_i8"] == cfg.n_layers and "gather_fp" not in census["families"]
    assert "memset" not in census["kinds"], census


def test_int8_kv_kernel_gather_equals_the_xla_gather(cuda):
    """2 layers on int8 KV pools, chunked on demand: K3's int8 path and the
    ``pool[block_table]`` view give bit-identical sampled rows."""
    cfg, packed, head = _packed_smoke(cuda)
    cfg = dataclasses.replace(cfg, kv_dtype="int8", n_layers=2)
    rows = {}
    for gather in ("kernel", "xla"):
        ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=7, chunk_tokens=4,
                            admit="on-demand", packed_head=True, head_bits=(4, 4), gather_backend=gather)
        eng = build_engine(cfg, ecfg, params=packed, head=head, device=cuda)
        rec = rows[gather] = {}
        eng.on_sample = lambda rid, t, row, rec=rec: rec.__setitem__((rid, t), row.copy())
        g = np.random.default_rng(9)
        for n in (9, 6, 11, 5):
            eng.submit(g.integers(1, cfg.vocab, n).tolist(), 6)
        build.reset_counts()
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 4} and m["preemptions"] > 0
        assert build.counts()["paged_gather"] == (cfg.n_layers * m["steps"] if gather == "kernel" else 0)
        eng.close()
    assert rows["kernel"].keys() == rows["xla"].keys()
    for k, row in rows["kernel"].items():
        assert row.tobytes() == rows["xla"][k].tobytes(), k


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_captured_int8_weight_engine_equals_the_eager_engine(cuda, kv_dtype):
    """``build_engine(quant="int8")``: the captured step against
    capture=False on the same int8 levels and scales, every step's logits
    bit-identical; K3 is the only port kernel of the step."""
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("llama3.2-3b", smoke=True), kv_dtype=kv_dtype)
    params = T.init_params(cfg, seed=5, device=cuda)
    ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=7, chunk_tokens=4,
                        admit="on-demand", gather_backend="kernel")
    q = build_engine(cfg, ecfg, params=params, quant="int8", device=cuda, capture=False).params
    assert q["layers"][0]["attn"]["wq"]["w"]["levels"].dtype == torch.int8
    runs = _run_captured_and_eager(cfg, q, ecfg, cuda)
    _assert_same_runs(runs)
    m, counts, _, _, census = runs[1]
    assert counts == {**dict.fromkeys(build.COUNTS, 0), "paged_gather": cfg.n_layers * m["steps"]}
    assert {k: v for k, v in census["kernels"].items() if k != "other"} == {"paged_gather": cfg.n_layers}
    family = "gather_i8" if kv_dtype == "int8" else "gather_fp"
    assert census["families"] == {family: cfg.n_layers}


# -- the request lifecycle -----------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_captured_lifecycle_engine_equals_the_eager_engine(cuda, kv_dtype):
    """Two slots in a pool of 10 usable pages: request 0 is cancelled at its
    3rd token, request 1 is shed on its deadline mid-decode, and requests 2
    and 3, waiting meanwhile, are admitted into pages the two freed.  The
    captured engine (one capture across the cancel and the shed) against
    capture=False on the same schedule: every step's logits bit-identical,
    the same statuses, tokens and launch counters, which are the graph's
    per-step launches times the steps."""
    from repro_torch.serving import Engine

    cfg, packed, head = _packed_smoke(cuda)
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    ecfg = EngineConfig(n_slots=2, page_size=4, max_len=32, n_pages=11, packed_head=True,
                        head_bits=(4, 4), gather_backend="kernel")
    g = np.random.default_rng(11)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 7, 5)]
    runs = []
    for capture in (False, True):
        eng = Engine(cfg, packed, ecfg, head=head, device=cuda, capture=capture)
        logits = _step_logits(eng)
        reqs = [eng.submit(prompts[0], 8), eng.submit(prompts[1], 12, deadline=12.0),
                eng.submit(prompts[2], 6, arrival=2.0), eng.submit(prompts[3], 6, arrival=3.0)]
        pages: dict = {}

        def on_sample(rid, t, row, eng=eng, reqs=reqs, pages=pages):
            pages.setdefault(rid, set()).update(reqs[rid].pages)
            if rid == 0 and t == 2:
                eng.cancel(reqs[0])

        eng.on_sample = on_sample
        build.reset_counts()
        m = eng.run(realtime=False)
        assert [(r.status, r.shed_reason) for r in reqs] == [
            ("cancelled", None), ("shed", "deadline"), ("ok", None), ("ok", None)]
        assert len(reqs[0].out_tokens) == 3 and reqs[1].out_tokens
        for late in reqs[2:]:
            assert late.t_admit >= min(reqs[0].t_finish, reqs[1].t_finish)
        assert pages[2] & (pages[0] | pages[1]) and pages[3] & (pages[0] | pages[1])
        eng.assert_no_leaks()
        counts = build.counts()
        if capture:
            prog = eng._program
            assert prog.captures == 1
            assert counts == {k: prog.launches.get(k, 0) * m["steps"] for k in build.COUNTS}
        runs.append((m, counts, logits, {r.rid: r.out_tokens for r in reqs}))
        eng.close()
    (m_e, counts_e, logits_e, toks_e), (m_c, counts_c, logits_c, toks_c) = runs
    assert m_c["steps"] == m_e["steps"] and m_c["statuses"] == m_e["statuses"]
    assert toks_c == toks_e and counts_c == counts_e
    assert len(logits_c) == len(logits_e) == m_c["steps"]
    for t, (a, b) in enumerate(zip(logits_c, logits_e)):
        assert a.tobytes() == b.tobytes(), t


# -- gemma3-1b at its served geometry ------------------------------------------------

# phase 14's engine: one KV head of width 256, page 16, max_len 2048 (128 blocks
# a slot), live slots of 1100-1532 tokens, past the 1024-token window
GEMMA_WINDOW = 1024


@pytest.mark.parametrize("pool", ["bfloat16", "int8-bf16", "int8-f32"])
def test_gather_kernel_bit_exact_at_gemma_geometry(cuda, pool):
    """K3 at 8 slots x 128 blocks of 16 rows, D 256, window 1024 and 0,
    chunk 1 and 16: bit-exact, and the window drops live keys of every
    live slot."""
    table, pos, pools = _k3_pools(cuda, 8, 128, 16, 256, seed=26, lengths=(1100, 1533))
    for window in (GEMMA_WINDOW, 0):
        for chunk in (1, 16):
            _k3_exact(table, pos, pools, pool, window, chunk)
    z = pools["bf16"]
    masks = [paged_gather_raw(table, pos, w, *z, chunk=1, out_dtype=torch.bfloat16)[2].reshape(8, -1)
             for w in (GEMMA_WINDOW, 0)]
    dropped = (masks[1] & ~masks[0]).sum(dim=1)
    live = table[:, 0] != 0
    assert bool((dropped[live] == pos[live] + 1 - GEMMA_WINDOW).all()), dropped
    assert not bool((masks[0] & ~masks[1]).any())


# (K, N) of gemma3-1b's decode step: wq, wk|wv, wo, w_up|w_gate, w_down, the head
GEMMA_SHAPES = [(1152, 1024), (1152, 256), (1024, 1152), (1152, 6912), (6912, 1152), (1152, 262144)]


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("k,n", GEMMA_SHAPES)
def test_fused_kernel_bit_exact_at_gemma_shapes(cuda, m, k, n):
    """K1 at w4a4 (n_seg 2: packed widths 512, 128, 576, 3456 and 131072
    words, every one on the 16-byte copy path) against its plain version."""
    cfg = choose_config(4, 4)
    g = torch.Generator(device=cuda)
    g.manual_seed(m + k + n)
    x = torch.rand((m, k), generator=g, device=cuda) * 1.2 - 0.1
    w_lvl = torch.randint(0, 16, (k, n), generator=g, device=cuda, dtype=torch.int32)
    wp = pm.pack_weights(w_lvl, cfg.n_seg, cfg.stride)
    del w_lvl
    kw = dict(a_bits=4, n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap)
    acc, a_sum = packed_dense_fused_raw(x, wp, **kw)
    p_acc, p_sum = packed_dense_fused_plain(x, wp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, p_acc) and torch.equal(a_sum, p_sum)


def test_captured_gemma_engine_past_the_window_equals_the_eager_engine(cuda):
    """2 layers of gemma3-1b at full width (both windowed, 1024), w4a4 and
    the packed (4, 4) head, chunked prefill of 1030- and 1100-token prompts:
    every step's logits of the captured step bit-identical to
    capture=False's, one capture, equal tokens and launch counters."""
    from repro_torch.serving import Engine

    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=2)
    assert cfg.windows() == [GEMMA_WINDOW] * 2
    cfg, packed, head = _packed_smoke(cuda, cfg)
    ecfg = EngineConfig(n_slots=2, page_size=16, max_len=1280, chunk_tokens=16, packed_head=True,
                        head_bits=(4, 4), gather_backend="kernel")
    g = np.random.default_rng(26)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (1030, 1100)]
    runs = []
    for capture in (False, True):
        eng = Engine(cfg, packed, ecfg, head=head, device=cuda, capture=capture)
        logits = _step_logits(eng)
        for p in prompts:
            eng.submit(p, 6)
        build.reset_counts()
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 2}
        eng.assert_no_leaks()
        assert eng._program.captures == int(capture)
        runs.append((m, build.counts(), logits, {r.rid: r.out_tokens for r in eng.finished}))
        eng.close()
    (m_e, counts_e, logits_e, toks_e), (m_c, counts_c, logits_c, toks_c) = runs
    assert m_c["steps"] == m_e["steps"] and toks_c == toks_e and counts_c == counts_e
    assert counts_c["paged_gather"] == cfg.n_layers * m_c["steps"]
    assert len(logits_c) == len(logits_e) == m_c["steps"]
    for t, (a, b) in enumerate(zip(logits_c, logits_e)):
        assert a.tobytes() == b.tobytes(), t


# -- mamba2-130m: the SSM family's recurrent state ----------------------------------

# (K, N) of mamba2-130m's decode step: in_z, in_xbc, out_proj, the head
MAMBA_SHAPES = [(768, 1536), (768, 1792), (1536, 768), (768, 50432)]


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("k,n", MAMBA_SHAPES)
def test_fused_kernel_bit_exact_at_mamba_shapes(cuda, m, k, n):
    """K1 at w4a4 against its plain version at mamba2-130m's projections and
    head, at one row and at the 16 slots of the served cell."""
    cfg = choose_config(4, 4)
    g = torch.Generator(device=cuda)
    g.manual_seed(m + k + n)
    x = torch.rand((m, k), generator=g, device=cuda) * 1.2 - 0.1
    w_lvl = torch.randint(0, 16, (k, n), generator=g, device=cuda, dtype=torch.int32)
    wp = pm.pack_weights(w_lvl, cfg.n_seg, cfg.stride)
    del w_lvl
    kw = dict(a_bits=4, n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap)
    acc, a_sum = packed_dense_fused_raw(x, wp, **kw)
    p_acc, p_sum = packed_dense_fused_plain(x, wp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, p_acc) and torch.equal(a_sum, p_sum)


def _sampled_rows(eng) -> dict:
    rows = {}
    eng.on_sample = lambda rid, t, row: rows.__setitem__((rid, t), row.copy())
    return rows


@pytest.mark.parametrize("chunk,admit,n_pages", [(1, "reserve", 0), (4, "on-demand", 7)])
def test_captured_mamba_engine_equals_the_eager_engine(cuda, chunk, admit, n_pages):
    """mamba2-130m at its smoke size, w4a4 and the packed (4, 4) head, two
    slots: request 0 is cancelled at its 3rd token and the waiting requests
    are admitted into its slot and the other, their states zeroed between
    replays (on demand: preempted and re-admitted too).  The captured step
    (one capture) against capture=False: every step's logits bit-identical,
    the same tokens, resets and launch counters, which are the graph's
    per-step launches (3 K1 a layer and lane, and the head) times the steps."""
    from repro_torch.serving import Engine

    cfg, packed, head = _packed_smoke(cuda, get_config("mamba2-130m", smoke=True))
    ecfg = EngineConfig(n_slots=2, page_size=4, max_len=32, n_pages=n_pages, chunk_tokens=chunk,
                        admit=admit, packed_head=True, head_bits=(4, 4))
    g = np.random.default_rng(13)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 11, 5)]
    runs = []
    for capture in (False, True):
        eng = Engine(cfg, packed, ecfg, head=head, device=cuda, capture=capture)
        logits = _step_logits(eng)
        resets, reset = [], eng._reset_slot
        eng._reset_slot = lambda slot, resets=resets, reset=reset: (resets.append(slot), reset(slot))
        reqs = [eng.submit(p, 6) for p in prompts]

        def on_sample(rid, t, row, eng=eng, reqs=reqs):
            if rid == 0 and t == 2:
                eng.cancel(reqs[0])

        eng.on_sample = on_sample
        build.reset_counts()
        m = eng.run(realtime=False)
        assert [r.status for r in reqs] == ["cancelled", "ok", "ok", "ok"]
        assert len(resets) == len(prompts) + m["preemptions"] and len(set(resets)) == 2
        eng.assert_no_leaks()
        counts = build.counts()
        if capture:
            prog = eng._program
            assert prog.captures == 1
            assert prog.launches == {"packed_dense_fused": 3 * cfg.n_layers * chunk + 1}
            assert counts == {k: prog.launches.get(k, 0) * m["steps"] for k in build.COUNTS}
        runs.append((m, counts, logits, {r.rid: r.out_tokens for r in reqs}, resets))
        eng.close()
    (m_e, counts_e, logits_e, toks_e, resets_e), (m_c, counts_c, logits_c, toks_c, resets_c) = runs
    if admit == "on-demand":
        assert m_c["preemptions"] > 0
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m_c[key] == m_e[key], key
    assert toks_c == toks_e and counts_c == counts_e and resets_c == resets_e
    assert len(logits_c) == len(logits_e) == m_c["steps"]
    for t, (a, b) in enumerate(zip(logits_c, logits_e)):
        assert a.tobytes() == b.tobytes(), t


def test_mamba_forced_preemption_equals_its_unpreempted_twin(cuda):
    """The reference's forced-preemption fixture on the card (mamba2-130m
    smoke, w4a4, the packed (4, 4) head, C = 4, on demand): 5 usable pages
    preempt and replay; with pages for every request nothing is preempted.
    Every sampled row of the two captured runs is bit-identical."""
    from repro_torch.serving import Engine

    cfg, packed, head = _packed_smoke(cuda, get_config("mamba2-130m", smoke=True))
    g = np.random.default_rng(7)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 11)]
    runs = []
    for n_pages in (6, 0):
        ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=n_pages, chunk_tokens=4,
                            admit="on-demand", packed_head=True, head_bits=(4, 4))
        eng = Engine(cfg, packed, ecfg, head=head, device=cuda)
        rows = _sampled_rows(eng)
        for p in prompts:
            eng.submit(p, 6)
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 3}
        eng.assert_no_leaks()
        eng.close()
        runs.append((m, rows))
    (m_p, rows_p), (m_u, rows_u) = runs
    assert m_p["preemptions"] > 0 and m_u["preemptions"] == 0
    assert rows_p.keys() == rows_u.keys() and len(rows_p) == 18
    for k, row in rows_u.items():
        assert row.tobytes() == rows_p[k].tobytes(), k


# -- MoE: K1/K2 over an expert grid axis, the MoE engine ----------------------------------

# (E, K, N): qwen3-moe-30b-a3b's served experts (w_up|w_gate 2048x768,
# w_down 768x2048, 128 of each), whose 128 x tiles fill the card unsplit;
# and 16 experts (llama4-scout-17b-a16e's count) at K = 5120 (its d_model)
# and narrow N, whose few tiles split K
MOE_SHAPES = [(128, 2048, 768), (128, 768, 2048), (16, 5120, 512), (16, 5120, 136)]


@pytest.mark.parametrize("m", [1, 12])
@pytest.mark.parametrize("e,k,n", MOE_SHAPES)
def test_batched_kernels_bit_exact_at_moe_shapes(cuda, e, k, n, m):
    """K1 and K2 (block_k 512) over E experts in one launch, w4a4: bit-exact
    against their plain versions, each expert's slice equal to the 2-D call
    on that expert alone, and one captured call a single kernel node (read
    from the graph's nodes)."""
    from repro_torch.kernels.packed_matmul.kernel import grid_plan

    cfg = choose_config(4, 4)
    kw = dict(n_seg=cfg.n_seg, stride=cfg.stride, acc_chunk=cfg.acc_chunk, overlap=cfg.overlap)
    g = torch.Generator(device=cuda).manual_seed(e + k + n + m)
    x = torch.rand((e, m, k), generator=g, device=cuda) * 1.2 - 0.1
    wp = torch.stack([pm.pack_weights(torch.randint(0, 16, (k, n), generator=g, device=cuda,
                                                    dtype=torch.int32), cfg.n_seg, cfg.stride)
                      for _ in range(e)])
    a_lvl = torch.round(torch.clamp(x, 0, 1) * 15).to(torch.int32)
    splits, _ = grid_plan(m, k, wp.shape[-1], torch.cuda.get_device_properties(0).multi_processor_count,
                          batch=e)
    assert (splits > 1) == (e == 16)
    acc, a_sum = packed_dense_fused_raw(x, wp, a_bits=4, **kw)
    acc2 = packed_matmul_raw(a_lvl, wp, block_k=512, **kw)
    p_acc, p_sum = packed_dense_fused_plain(x, wp, a_bits=4, **kw)
    torch.cuda.synchronize()
    assert acc.shape == (e, m, n) and a_sum.shape == (e, m)
    assert torch.equal(acc, p_acc) and torch.equal(a_sum, p_sum)
    assert torch.equal(acc2, packed_matmul_plain(a_lvl, wp, block_k=512, **kw))
    one, one_sum = packed_dense_fused_raw(x[e // 2].contiguous(), wp[e // 2], a_bits=4, **kw)
    assert torch.equal(one, acc[e // 2]) and torch.equal(one_sum, a_sum[e // 2])
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        packed_dense_fused_raw(x, wp, a_bits=4, **kw)
    census = build.graph_census(graph)
    assert census["kinds"] == {"kernel": 1} and census["kernels"] == {"packed_dense_fused": 1}, census


def _moe_smoke(cuda, packed: bool, seed=3):
    """qwen3-moe-30b-a3b at its smoke size on the card: w4a4 projections and
    experts with the packed (4, 4) head, or float weights."""
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    if packed:
        return _packed_smoke(cuda, cfg, seed)
    return cfg, T.init_params(cfg, seed=seed, device=cuda), None


@pytest.mark.parametrize("weights", ["packed", "float"])
def test_captured_moe_engine_equals_the_eager_engine(cuda, weights):
    """qwen3-moe at its smoke size, 3 slots, C = 4, on demand in 6 pages:
    the engine preempts and replays.  The captured step (one capture)
    against capture=False: every step's logits bit-identical, the same
    tokens, steps, tokens fed and preemptions; the counters are the graph's
    per-step launches (7 K1 a layer and the head, packed; one K3 a layer)
    times the steps."""
    from repro_torch.serving import Engine

    cfg, params, head = _moe_smoke(cuda, weights == "packed")
    ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4, admit="on-demand",
                        packed_head=head is not None, head_bits=(4, 4), gather_backend="kernel")
    g = np.random.default_rng(7)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 11)]
    runs = []
    for capture in (False, True):
        eng = Engine(cfg, params, ecfg, head=head, device=cuda, capture=capture)
        logits = _step_logits(eng)
        for p in prompts:
            eng.submit(p, 6)
        build.reset_counts()
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 3}
        eng.assert_no_leaks()
        counts = build.counts()
        if capture:
            prog = eng._program
            want = {"paged_gather": cfg.n_layers}
            if head is not None:
                want["packed_dense_fused"] = 7 * cfg.n_layers + 1
            assert prog.captures == 1 and prog.launches == want
            assert build.graph_census(prog.graph)["kernels"].get("packed_dense_fused", 0) == want.get(
                "packed_dense_fused", 0)
            assert counts == {k: want.get(k, 0) * m["steps"] for k in build.COUNTS}
        runs.append((m, counts, logits, {r.rid: r.out_tokens for r in eng.finished}))
        eng.close()
    (m_e, counts_e, logits_e, toks_e), (m_c, counts_c, logits_c, toks_c) = runs
    assert m_c["preemptions"] > 0
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m_c[key] == m_e[key], key
    assert toks_c == toks_e and counts_c == counts_e
    assert len(logits_c) == len(logits_e) == m_c["steps"]
    for t, (a, b) in enumerate(zip(logits_c, logits_e)):
        assert a.tobytes() == b.tobytes(), t


# -- chaos and snapshots -------------------------------------------------------------

CHAOS_DECISIONS = ("statuses", "steps", "fed_tokens", "preemptions", "quarantines", "step_retries",
                   "hard_recoveries", "injected")


def _plant_after_write(eng, at_step: int) -> None:
    """A hard fault: the step program raises once at engine step
    ``at_step``, after its replay has written the state."""
    run, tripped = eng._program.run, []

    def dying(*args):
        out = run(*args)
        if eng.n_steps == at_step and not tripped:
            tripped.append(1)
            raise ValueError("planted hard fault after the step")
        return out

    eng._program.run = dying


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-130m"])
def test_captured_chaos_engine_equals_the_eager_engine(cuda, tmp_path, arch):
    """Every fault family at rate 0.2 (seed 3) on demand in a tight pool,
    and a hard fault after step 5 has written the state, restored from a
    snapshot (``snapshot_every=2``) in place: the captured engine (one
    capture) against capture=False, the same decisions and every sampled
    row bit-identical; the state's tensors are never rebound."""
    from repro_torch.serving import ChaosConfig, Engine

    cfg, packed, head = _packed_smoke(cuda, get_config(arch, smoke=True))
    ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=7, chunk_tokens=4, admit="on-demand",
                        packed_head=True, head_bits=(4, 4), max_request_retries=64, snapshot_every=2,
                        gather_backend="kernel" if cfg.family == "attn" else "xla",
                        chaos=ChaosConfig(seed=3, step_fault_rate=0.2, alloc_fault_rate=0.2, nan_rate=0.2))
    g = np.random.default_rng(17)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 11, 5)]
    runs = []
    for capture in (False, True):
        e = dataclasses.replace(ecfg, snapshot_dir=str(tmp_path / f"capture-{capture}"))
        eng = Engine(cfg, packed, e, head=head, device=cuda, capture=capture)
        rows = _sampled_rows(eng)
        ptrs = {k: t.data_ptr() for k, t in eng.state.items()}
        restored, restore = [], eng._restore_state
        eng._restore_state = lambda restored=restored, restore=restore, eng=eng: (
            restored.append(eng._ckpt.latest_step()), restore())
        _plant_after_write(eng, 5)
        reqs = [eng.submit(p, 6) for p in prompts]
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 4} and m["hard_recoveries"] == 1
        assert min(m["injected"].values()) > 0 and m["quarantines"] > 0 and m["step_retries"] > 0
        assert len(restored) == 1 and restored[0] is not None  # from a snapshot
        assert {k: t.data_ptr() for k, t in eng.state.items()} == ptrs
        assert (eng._program.graph is not None) == capture
        if capture:
            assert eng._program.captures == 1
        eng.assert_no_leaks()
        runs.append(({k: m[k] for k in CHAOS_DECISIONS},
                     [(r.n_faults, r.n_preempted, r.out_tokens) for r in reqs], rows))
        eng.close()
    (d_e, r_e, rows_e), (d_c, r_c, rows_c) = runs
    assert d_c == d_e and r_c == r_e
    assert rows_c.keys() == rows_e.keys()
    for k, row in rows_c.items():
        assert row.tobytes() == rows_e[k].tobytes(), k


def test_chaos_engine_does_not_recover_a_failed_device(cuda, monkeypatch):
    """A fault after which the device no longer synchronises (a sticky
    CUDA error, simulated by the probe raising) leaves run() with the
    fault, unrecovered; so does a kernel's own error."""
    from repro_torch.serving import Engine

    cfg, packed, head = _packed_smoke(cuda)
    ecfg = EngineConfig(n_slots=2, page_size=4, max_len=32, packed_head=True, head_bits=(4, 4),
                        gather_backend="kernel")
    g = np.random.default_rng(19)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6)]
    eng = Engine(cfg, packed, ecfg, head=head, device=cuda)
    _plant_after_write(eng, 2)
    for p in prompts:
        eng.submit(p, 6)
    eng.warmup()

    def lost(device=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", lost)
    with pytest.raises(ValueError, match="planted") as info:
        eng.run(realtime=False)
    assert eng.hard_recoveries == 0 and any("device probe" in n for n in info.value.__notes__)
    monkeypatch.undo()
    eng.close()

    eng = Engine(cfg, packed, ecfg, head=head, device=cuda)
    run = eng._program.run

    def failing(*args):
        if eng.n_steps == 1:
            raise build.KernelError("paged_gather: CUDA error 700: an illegal memory access")
        return run(*args)

    eng._program.run = failing
    for p in prompts:
        eng.submit(p, 6)
    with pytest.raises(build.KernelError):
        eng.run(realtime=False)
    assert eng.hard_recoveries == 0 and eng.n_steps == 1
    eng.close()


def _attributed(eng) -> list:
    """Spy on an engine's attributor: after each sample, whether the head
    segment's rows equal the step's logits bit for bit."""
    equal, inner = [], eng._attrib.sample

    def sample(*args, **kw):
        out = inner(*args, **kw)
        equal.append(eng._attrib.logits.cpu().numpy().tobytes() == eng._program._host_np.tobytes())
        return out

    eng._attrib.sample = sample
    return equal


@pytest.mark.parametrize("chunk,admit,n_pages", [(1, "reserve", 0), (4, "on-demand", 7)])
def test_obs_attributed_engine_equals_the_untraced_engine(cuda, chunk, admit, n_pages):
    """chip_smoke.py phase 18's checks at the llama3.2-3b smoke size, w4a4,
    the packed (4, 4) head, the kernel gather: a traced run attributed every
    2 steps against an untraced one on the same weights.  Every sample's
    segment graphs (captured once) give the step's logits bit for bit and
    launch the step's kernels; the step is captured once and its counters
    are its graph's launches times the steps; the sampled rows, tokens and
    steps equal the untraced run's; the trace has a dispatch, device_wait
    and step span a step."""
    from repro_torch.obs.trace import TraceRecorder
    from repro_torch.serving import Engine, ObsConfig

    cfg, packed, head = _packed_smoke(cuda)
    ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=n_pages, chunk_tokens=chunk,
                        admit=admit, packed_head=True, head_bits=(4, 4), gather_backend="kernel")
    g = np.random.default_rng(7)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 11, 5)]
    runs = []
    for obs in (ObsConfig(), ObsConfig(attrib_every=2)):
        eng = Engine(cfg, packed, dataclasses.replace(ecfg, obs=obs), head=head, device=cuda)
        rows = _sampled_rows(eng)
        equal = _attributed(eng) if obs.attrib_every else None
        for p in prompts:
            eng.submit(p, 6)
        tr = TraceRecorder() if obs.attrib_every else None
        build.reset_counts()
        m = eng.run(realtime=False, trace=tr)
        counts, prog = build.counts(), eng._program
        assert m["statuses"] == {"ok": 4} and prog.captures == 1
        assert counts == {k: prog.launches.get(k, 0) * m["steps"] for k in build.COUNTS}
        if obs.attrib_every:
            at = eng._attrib
            assert len(equal) == m["steps"] // 2 == len(at.samples) and all(equal)
            assert at.captures == 1 and at.launches == {k: v * len(at.samples) for k, v in prog.launches.items()}
            spans = [e["name"] for e in tr.events if e["ph"] == "X" and e["tid"] == 0]
            assert all(spans.count(n) == m["steps"] for n in ("dispatch", "device_wait", "step"))
        runs.append((m, rows, {r.rid: r.out_tokens for r in eng.finished}))
        eng.close()
    (m0, rows0, toks0), (m1, rows1, toks1) = runs
    assert m0["steps"] == m1["steps"] and toks0 == toks1 and rows0.keys() == rows1.keys()
    assert all(rows0[k].tobytes() == rows1[k].tobytes() for k in rows0)


@pytest.mark.parametrize("planted", [False, True], ids=["restored", "planted-skipped-restore"])
def test_obs_mamba_attribution_restores_each_rep(cuda, monkeypatch, planted):
    """mamba2-130m at its smoke size at attrib_reps=2 on the card: each SSM
    slice is restored before each replay of its segment graph, so the head
    rows equal the step's logits bit for bit; with the restore skipped
    before the second replay the recurrence advances twice and they differ."""
    from repro_torch.obs.attrib import LayerAttributor
    from repro_torch.serving import Engine, ObsConfig

    if planted:
        real, done = LayerAttributor._restore, set()

        def once(self, i):  # restore before a layer's first run of each sample only
            key = (len(self.samples), self.captures, i)
            if key not in done:
                done.add(key)
                real(self, i)

        monkeypatch.setattr(LayerAttributor, "_restore", once)
    cfg, packed, head = _packed_smoke(cuda, get_config("mamba2-130m", smoke=True))
    ecfg = EngineConfig(n_slots=2, page_size=4, max_len=32, chunk_tokens=4, packed_head=True, head_bits=(4, 4),
                        obs=ObsConfig(attrib_every=1, attrib_reps=2))
    eng = Engine(cfg, packed, ecfg, head=head, device=cuda)
    equal = _attributed(eng)
    g = np.random.default_rng(13)
    for n in (9, 6, 11):
        eng.submit(g.integers(1, cfg.vocab, n).tolist(), 6)
    m = eng.run(realtime=False)
    eng.close()
    assert m["statuses"] == {"ok": 3} and len(equal) == m["steps"]
    assert not any(equal) if planted else all(equal)


# -- qwen2-vl-7b's M-RoPE and the serve CLI ------------------------------------------------

MROPE_ATOL = 1e-4  # float32 pow/cos/sin of the card against the CPU's (see tests/test_torch_mrope.py)


@pytest.mark.parametrize("sections", [(2, 1, 1), (3, 2, 2)], ids=["2x1x1", "3x2x2"])
@pytest.mark.parametrize("hd", [16, 128])
def test_mrope_on_the_card_matches_the_cpu(cuda, hd, sections):
    """M-RoPE at distinct (t, h, w) streams (t up to 4095, h and w under 64),
    float32 and bfloat16, on the card against the CPU; ``rope`` on the
    temporal stream (a planted fault) misses by far more."""
    from repro_torch.models import layers as L

    g = np.random.default_rng(hd)
    x = torch.from_numpy(g.normal(size=(8, 16, 4, hd)).astype(np.float32))
    pos3 = torch.from_numpy(np.stack([g.integers(0, 4096, (8, 16)), g.integers(0, 64, (8, 16)),
                                      g.integers(0, 64, (8, 16))], axis=-1).astype(np.int32))
    want = L.mrope(x, pos3, theta=1e6, sections=sections)
    got = L.mrope(x.to(cuda), pos3.to(cuda), theta=1e6, sections=sections).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=MROPE_ATOL)
    planted = L.rope(x.to(cuda), pos3[..., 0].to(cuda), theta=1e6).cpu()
    assert (planted - want).abs().max() > 100 * MROPE_ATOL
    xb = x.to(torch.bfloat16)
    got_b = L.mrope(xb.to(cuda), pos3.to(cuda), theta=1e6, sections=sections).cpu().float()
    want_b = L.mrope(xb, pos3, theta=1e6, sections=sections).float()
    np.testing.assert_allclose(got_b.numpy(), want_b.numpy(), rtol=0, atol=2 ** -7 * 8)


def test_serve_cli_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """``repro_torch.launch.serve.main`` on qwen2-vl-7b at its smoke size,
    float32, w4a4 projections and the float head, on the card and with
    ``--device cpu`` on the same weights and prompts: on the card one
    capture, K1 counted (its graph's launches times the steps), and the
    tokens equal the CPU's up to a tie (a top-2 gap under TIE_BOUND: an
    activation-level flip moves a logit by about 0.1 at most)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    tie_bound = 0.25
    monkeypatch.setattr(serve, "get_config", lambda *a, **k: dataclasses.replace(
        get_config(*a, **k), dtype=torch.float32))
    monkeypatch.setattr(serve, "init_params", lambda cfg, seed, device: T.map_leaves(
        T.init_params(cfg, seed=seed, device="cpu"), lambda a: a.to(device)))
    inner, runs = serve.build_engine, {}

    def catching(*a, **kw):
        eng = inner(*a, **kw)
        rows = {}
        eng.on_sample = lambda rid, t, row, rows=rows: rows.__setitem__((rid, t), row.copy())
        runs[str(kw["device"])] = (eng, rows)
        return eng

    monkeypatch.setattr(serve, "build_engine", catching)
    argv = ["--arch", "qwen2-vl-7b", "--packed", "--batch", "3", "--tokens", "6", "--max-len", "32",
            "--prompt-len", "7", "--requests", "5"]
    out_c = serve.main(argv + ["--device", "cpu"])
    build.reset_counts()
    out_g = serve.main(argv)
    counts = build.counts()
    (eng_c, rows_c), (eng_g, rows_g) = runs["cpu"], runs["cuda"]
    assert out_g["statuses"] == out_c["statuses"] == {"ok": 5} and out_g["steps"] == out_c["steps"]
    prog = eng_g._program
    assert prog.captures == 1 and prog.graph is not None
    assert prog.launches == {"packed_dense_fused": eng_g.cfg.n_layers * 7}
    assert counts == {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": prog.launches[
        "packed_dense_fused"] * out_g["steps"]}
    toks_c = {r.rid: r.out_tokens for r in eng_c.finished}
    for r in eng_g.finished:
        theirs = toks_c[r.rid]
        div = next((t for t in range(len(theirs)) if r.out_tokens[t] != theirs[t]), None)
        if div is not None:
            top2 = np.sort(rows_c[(r.rid, div)])[-2:]
            assert top2[1] - top2[0] < tie_bound, (r.rid, div, top2)


@pytest.mark.parametrize("arch", ["whisper-tiny", "zamba2-1.2b"])
def test_static_serve_cli_on_the_card_matches_the_cpu(cuda, monkeypatch, arch):
    """``repro_torch.launch.serve.main`` with the fixed-batch loop (the
    default engine of the encdec and hybrid families) at the smoke size,
    float32, w4a4 projections, on the card and with ``--device cpu`` on the
    same weights: on the card one capture, K1 counted (a replay's launches
    times the steps, plus whisper's encoder once), every step's logits
    bit-identical to a ``capture=False`` run on the same weights, and the
    greedy tokens equal the CPU's up to a tie (a top-2 gap under
    TIE_BOUND: an activation-level flip moves a logit by about 0.1 at
    most)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    tie_bound, n_tokens = 0.25, 6
    monkeypatch.setattr(serve, "get_config", lambda *a, **k: dataclasses.replace(
        get_config(*a, **k), dtype=torch.float32))
    monkeypatch.setattr(serve, "init_params", lambda cfg, seed, device: T.map_leaves(
        T.init_params(cfg, seed=seed, device="cpu"), lambda a: a.to(device)))
    steps = []

    class Recording(serve.StaticStep):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.rows = []
            self.on_step = lambda t, logits: self.rows.append(logits.clone())
            steps.append(self)

    monkeypatch.setattr(serve, "StaticStep", Recording)
    argv = ["--arch", arch, "--packed", "--batch", "3", "--tokens", str(n_tokens), "--max-len", "32"]
    serve.main(argv + ["--device", "cpu"])
    build.reset_counts()
    serve.main(argv)
    torch.cuda.synchronize()
    counts = build.counts()
    cpu, card = steps
    cfg = card.cfg
    if cfg.family == "encdec":  # q, k, v, o, cross q, o, w_up, w_down a layer; the encoder once
        per_step, per_serve = 8 * cfg.n_layers, 6 * cfg.enc_layers + 2 * cfg.n_layers
    else:  # in_z, in_xbc, out_proj a layer; 4 + 3 an application of the shared block
        per_step, per_serve = 3 * cfg.n_layers + 7 * len(T._hybrid_segments(cfg)), 0
    assert card.captures == 1 and cpu.captures == 0 and card.launches == {"packed_dense_fused": per_step}
    assert counts == {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": per_step * n_tokens + per_serve}
    args = argparse.Namespace(device="cuda", batch=3, max_len=32, tokens=n_tokens)
    serve._serve_static(args, cfg, card.params, card.head, capture=False)
    torch.cuda.synchronize()
    eager = steps[2]
    assert eager.captures == 0 and len(eager.rows) == len(card.rows) == n_tokens
    for t, (a, b) in enumerate(zip(card.rows, eager.rows)):
        assert torch.equal(a, b), t
    for t in range(n_tokens):
        c = cpu.rows[t]
        differ = card.rows[t].cpu().argmax(-1) != c.argmax(-1)
        if differ.any():
            top2 = torch.topk(c[differ], 2, dim=-1).values
            assert bool(((top2[:, 0] - top2[:, 1]) < tie_bound).all()), (t, top2)
            break


# -- the training path (no port kernel on it) ----------------------------------------

# one arch per family: attn (dense and MoE), ssm, hybrid, encdec
TRAIN_ARCHS = ("llama3.2-3b", "qwen3-moe-30b-a3b", "mamba2-130m", "zamba2-1.2b", "whisper-tiny")
TRAIN_PROJ = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_up", "mlp_gate", "mlp_down", "ssm_in", "ssm_dt",
              "ssm_out", "xattn_q", "xattn_k", "xattn_v", "xattn_o")


def _train_batch(cfg, b: int = 2, s: int = 16) -> dict:
    g = np.random.default_rng(0)
    batch = {"tokens": g.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": g.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = g.normal(size=(b, s // 2, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class _QuantTape:
    """The CPU's run records each ``fake_quant_act`` input and
    ``fake_quant_weight`` output in call order; the card's run quantizes
    those values at the same call (its own gradient), so that a level flip
    at a rounding boundary (tanh and sigmoid round differently on the card)
    does not cascade.  The card's own values are kept: its activation
    inputs must lie within 1e-5 of the CPU's, and its weight-level flips
    (values more than half a level step, 1/15, apart: the card divides by
    15 as a multiplication by the reciprocal, one ulp off at the same
    level) are counted."""

    def __init__(self, monkeypatch):
        from repro_torch.models import layers as L

        self.act, self.weight, self.mode = L.fake_quant_act, L.fake_quant_weight, "record"
        self.acts, self.weights, self.own_acts, self.weight_flips = [], [], [], 0
        self.calls = [0, 0]
        monkeypatch.setattr(L, "fake_quant_act", self._act)
        monkeypatch.setattr(L, "fake_quant_weight", self._weight)

    def replay(self):
        self.mode, self.calls = "replay", [0, 0]

    def _act(self, x, bits):
        i = self.calls[0]
        self.calls[0] += 1
        if self.mode == "record":
            self.acts.append(x.detach().clone())
            return self.act(x, bits)
        self.own_acts.append((self.acts[i], x.detach().cpu()))
        return self.act(x + (self.acts[i].to(x.device) - x).detach(), bits)

    def _weight(self, w, bits):
        i = self.calls[1]
        self.calls[1] += 1
        out = self.weight(w, bits)
        if self.mode == "record":
            self.weights.append(out.detach().clone())
            return out
        r = self.weights[i].to(out.device)
        self.weight_flips += int(((out.detach() - r).abs() > 1 / 15).sum())
        return out + (r - out).detach()


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat-w4a4"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch, arch, qat):
    """``forward_train`` with every gradient leaf, then one
    ``make_train_step`` step (2 micro-batches), on the card and on the
    CPU from the same weights and batch, at float32 and the smoke size: the
    losses within 1e-5 relative, each gradient leaf (the backward's and the
    one the step hands its optimizer) within 1e-4 relative L2, and the
    card's AdamW step on the CPU's gradients within 1e-5 of the CPU's
    params after it (each side's own step is not compared: its first
    update is g / (|g| + eps), which turns a gradient near eps's rounding
    into a share of its update); QAT at w4a4 on every projection through
    :class:`_QuantTape`."""
    from repro_torch.launch import steps as S
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32,
                              quant=L.QuantConfig(bits={p: (4, 4) for p in TRAIN_PROJ}) if qat else L.NO_QUANT)
    init = T.init_params(cfg, seed=3, device="cpu")
    batch = _train_batch(cfg)
    tape = _QuantTape(monkeypatch) if qat else None
    seen: list = []
    inner = AdamW.update
    monkeypatch.setattr(AdamW, "update", lambda self, grads, st, p: (
        seen.append(tree_map(lambda g: g.detach().cpu().clone(), grads)), inner(self, grads, st, p))[1])
    out = {}
    for dev in ("cpu", "cuda"):
        if tape is not None and dev == "cuda":
            tape.replay()
        params = T.map_leaves(init, lambda a: a.clone().to(dev).requires_grad_(True))
        loss = T.forward_train(params, cfg, {k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        grads = [p.grad.cpu() for p in tree_leaves(params)]
        step = S.make_train_step(cfg, None, S.TrainStepConfig(n_micro=2, lr=1e-3))
        params = T.map_leaves(init, lambda a: a.clone().to(dev))
        step_loss, params, _ = step(params, step.optimizer.init(params), {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(loss.detach()), grads, float(step_loss), [p.detach().cpu() for p in tree_leaves(params)])
    (lc, gc, sc, pc), (lg, gg, sg, _) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(sg - sc) <= 1e-5 * abs(sc), (lg, lc, sg, sc)
    for k, (a, b) in enumerate(zip(gg + tree_leaves(seen[1]), gc + tree_leaves(seen[0]))):
        assert _rel(a, b) <= 1e-4, (k, _rel(a, b))
    # the card's optimizer on the CPU's step gradients
    params = T.map_leaves(init, lambda a: a.clone().to("cuda"))
    grads = tree_map(lambda g: g.to("cuda", copy=True), seen[0])
    params, _ = inner(step.optimizer, grads, step.optimizer.init(params), params)
    for k, (a, b) in enumerate(zip(tree_leaves(params), pc)):
        assert _rel(a.cpu(), b) <= 1e-5, (k, _rel(a.cpu(), b))
    if tape is not None:
        act_err = max(float((r - o).abs().max()) for r, o in tape.own_acts)
        assert act_err <= 1e-5, act_err
        assert tape.weight_flips <= 1e-4 * sum(w.numel() for w in tape.weights), tape.weight_flips


class _NasTape:
    """The super-net's discrete decisions in call order: the CPU's run
    records each ``fake_quant_act`` input, ``fake_quant_weight`` output and
    ReLU input; the card's run takes each on the CPU's value at the same
    call (its own gradient), so that neither a level flip nor a
    pre-activation within rounding of 0 moves one side only.  The card's
    own activation inputs are kept beside the CPU's."""

    def __init__(self, monkeypatch):
        import torch.nn.functional as F

        from repro_torch.core.nas import supernet as S

        self.fns = {"act": S.fake_quant_act, "weight": S.fake_quant_weight, "relu": F.relu}
        self.taped = {k: [] for k in self.fns}
        self.calls = dict.fromkeys(self.fns, 0)
        self.mode, self.own_acts = "record", []
        monkeypatch.setattr(S, "fake_quant_act", lambda x, b: self.fns["act"](self._take("act", x), b))
        monkeypatch.setattr(S, "fake_quant_weight", lambda w, b: self._take("weight", self.fns["weight"](w, b)))
        monkeypatch.setattr(F, "relu", lambda x: self.fns["relu"](self._take("relu", x)))

    def replay(self):
        self.mode, self.calls = "replay", dict.fromkeys(self.fns, 0)

    def _take(self, kind, x):
        i = self.calls[kind]
        self.calls[kind] += 1
        if self.mode == "record":
            self.taped[kind].append(x.detach().clone())
            return x
        r = self.taped[kind][i].to(x.device)
        if kind == "act":
            self.own_acts.append((self.taped[kind][i], x.detach().cpu()))
        return x + (r - x).detach()


@pytest.mark.parametrize("name,hw", [("vgg_tiny", (16, 16)), ("ultranet", (32, 64)), ("skynet", (32, 64))])
def test_nas_search_step_on_the_card_matches_the_cpu(cuda, monkeypatch, name, hw):
    """One ``search`` step's loss (the task loss plus 0.25 times the DSP
    proxy) and every gradient leaf of params and architecture logits, on
    the card and on the CPU from the same weights, random logits and
    batch, at float32 (TF32 off) over all seven bit choices: the loss
    within 1e-5 relative, weight gradients within 1e-4 and the logits'
    within 1e-3 relative L2 (chip_smoke.py phase 22 (c)'s bounds)."""
    from repro_torch.core.nas import supernet as S
    from repro_torch.core.packing import DSP48E2, build_lut
    from repro_torch.data import synthetic
    from repro_torch.models import convnets as C

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    spec, space = C.CONVNETS[name](in_hw=hw), S.SearchSpace()
    luts = {k: build_lut(DSP48E2, kernel_len=k, seq_len=32) for k in (1, 3)}
    init = C.init_params(3, spec, device="cpu")
    g = torch.Generator().manual_seed(4)
    alphas0 = {k: {kk: torch.randn(v.shape, generator=g) for kk, v in d.items()}
               for k, d in S.init_alphas(spec, space, device="cpu").items()}
    if spec.head == "classify":
        x, y = synthetic.classification_set(5, 4, hw=hw[0])
    else:
        x, y = synthetic.detection_set(5, 4, hw=hw)
    tape = _NasTape(monkeypatch)
    out = {}
    for dev in ("cpu", "cuda"):
        if dev == "cuda":
            tape.replay()
        params = {k: {kk: v.to(dev).clone().requires_grad_(True) for kk, v in d.items()} for k, d in init.items()}
        alphas = {k: {kk: v.to(dev).clone().requires_grad_(True) for kk, v in d.items()} for k, d in alphas0.items()}
        pred = S.supernet_apply(params, alphas, spec, x.to(dev), space)
        loss = C.task_loss(pred, y.to(dev), spec.head) + 0.25 * S.complexity_loss(
            alphas, S.t_mul_tables(spec, luts, space, device=dev), S.op_muls(spec, device=dev))
        loss.backward()
        grads = {(f"{k}/{kk}", tree is alphas): (v.grad if v.grad is not None else torch.zeros_like(v)).cpu()
                 for tree in (params, alphas) for k, d in tree.items() for kk, v in d.items()}
        out[dev] = (float(loss.detach()), grads)
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    for (k, is_alpha), b in gc.items():
        if not torch.any(b != 0):
            assert not torch.any(gg[(k, is_alpha)] != 0), k
            continue
        assert _rel(gg[(k, is_alpha)], b) <= (1e-3 if is_alpha else 1e-4), (k, _rel(gg[(k, is_alpha)], b))
    assert max(float((r.clamp(0, 1) - o.clamp(0, 1)).abs().max()) for r, o in tape.own_acts) <= 1e-4


@pytest.mark.parametrize("w_bits,a_bits", [(4, 4), (3, 2), (2, 2)])
def test_nas_k6_int_conv_equivalence_on_a_layer(cuda, w_bits, a_bits):
    """Phase 22 (e) at a small layer: a 3x3 conv's weight and activation
    levels through ``packed_conv1d`` (K6, one launch a row convolution)
    bit-exact against a float64 ``conv2d`` of the levels, and folded by
    ``int_conv_equivalence`` within 1e-5 relative L2 of ``conv2d`` of the
    fake-quant tensors."""
    import torch.nn.functional as F

    from repro_torch.core.quant import fake_quant as FQ

    cfg = choose_filter_config(w_bits, a_bits, 3)
    assert cfg is not None and cfg.k_p * cfg.n_p > 1
    g = torch.Generator(device="cuda").manual_seed(w_bits * 10 + a_bits)
    cin, cout, h, wd = 16, 12, 8, 13
    w = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") / 12
    x = torch.rand((1, cin, h, wd), generator=g, device="cuda") * 1.2 - 0.1
    w_lvl, s_w, z_w = FQ.weight_to_int_levels(w, w_bits)
    a_lvl, s_a = FQ.act_to_int_levels(x, a_bits)
    (wi, ai), scale, zero = FQ.int_conv_equivalence(w_lvl, a_lvl, s_w, z_w, s_a)
    rows = F.pad(ai[0], (0, 0, 1, 1))
    seqs = [rows[:, dy:dy + h].permute(1, 0, 2).contiguous() for dy in range(3)]
    build.reset_counts()
    ints = torch.stack([sum(packed_conv1d(seqs[dy], torch.flip(wi[o, :, dy], (1,)).contiguous(), w_bits=w_bits,
                                          a_bits=a_bits)[:, 1:wd + 1].to(torch.int64) for dy in range(3))
                        for o in range(cout)])
    torch.cuda.synchronize()
    assert build.counts()["filter_conv"] == 3 * cout
    want = F.conv2d(ai.to(torch.float64), wi.to(torch.float64), padding=1)[0]
    assert torch.equal(ints.to(torch.float64), want)
    ones = F.conv2d(ai.to(torch.float64), torch.ones((1, cin, 3, 3), dtype=torch.float64, device="cuda"), padding=1)[0]
    folded = scale * (ints.to(torch.float64) - zero * ones)
    fq = F.conv2d(FQ.fake_quant_act(x, a_bits), FQ.fake_quant_weight(w, w_bits), padding=1)[0].to(torch.float64)
    assert _rel(folded, fq) <= 1e-5


def test_nas_search_runs_on_the_card(cuda):
    """``search`` and ``finetune`` end to end on the card at a small size:
    finite history, the bits of the space, the params on the card."""
    from repro_torch.core import nas as N
    from repro_torch.core.packing import DSP48E2, build_lut
    from repro_torch.models import convnets as C

    spec = C.ultranet(in_hw=(32, 64))
    luts = {k: build_lut(DSP48E2, kernel_len=k, seq_len=32) for k in (1, 3)}
    res = N.search(spec, luts, eta=0.25, steps=4, batch=8, n_data=32, device="cuda")
    assert all(np.isfinite(h["loss"]) for h in res.history) and len(res.bits) == len(spec.layers)
    assert all(v.is_cuda for d in res.params.values() for v in d.values())
    ft = N.finetune(spec, res.bits, steps=3, batch=8, n_data=32, params=res.params, device="cuda")
    assert np.isfinite(ft["train_loss"]) and np.isfinite(ft["test_loss"]) and 0.0 <= ft["metric"] <= 1.0


# -- mesh serving: dp replicas x mp tensor-parallel ranks, every rank on the card -----


def _replica_logits(eng) -> list:
    """Spy on every replica's step program: a copy of each replica's logits
    a step (a single-replica engine's ``run`` calls ``launch``/``wait`` too)."""
    seen = [[] for _ in eng.replicas]
    for rep in eng.replicas:
        wait = rep.program.wait

        def spy(wait=wait, out=seen[rep.index]):
            rows = wait()
            out.append(rows.copy())
            return rows

        rep.program.wait = spy
    return seen


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (2, 1)], ids=["1x2", "2x2", "2x1"])
@pytest.mark.parametrize("arch,quant", [("llama3.2-3b", "packed"), ("mamba2-130m", None),
                                        ("qwen3-moe-30b-a3b", "packed")])
def test_captured_mesh_engine_equals_the_eager_engine(cuda, arch, quant, mesh):
    """A mesh engine with every rank on the card, each replica one captured
    graph on its own stream, against capture=False on the same shards:
    every replica's logits a step bit-identical, the same tokens, steps and
    preemptions; the counters are the graphs' launches times the steps and
    the replicas; the graph holds a rank's kernels twice (mp = 2)."""
    from repro_torch.serving import Engine, MeshConfig

    dp, mp = mesh
    cfg = get_config(arch, smoke=True)
    ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4, admit="on-demand",
                        packed_head=quant == "packed", head_bits=(4, 4), gather_backend="kernel",
                        mesh=MeshConfig(dp, mp))
    devices = [cuda] * (dp * mp)
    base = build_engine(cfg, ecfg, quant=quant, w_bits=4, a_bits=4, seed=3, device=cuda, devices=devices)
    g = np.random.default_rng(7)
    prompts = [g.integers(1, cfg.vocab, n).tolist() for n in (9, 6, 11, 7)]
    runs = []
    for capture in (False, True):
        eng = Engine(cfg, None if mp > 1 else base.params, ecfg, head=base._head, device=cuda,
                     capture=capture, shard_params=base.params if mp > 1 else None, devices=devices)
        logits = _replica_logits(eng)
        for p in prompts:
            eng.submit(p, 6)
        build.reset_counts()
        m = eng.run(realtime=False)
        assert m["statuses"] == {"ok": 4} and (m["dp"], m["mp"]) == mesh
        eng.assert_no_leaks()
        counts = build.counts()
        if capture:
            want = {}
            if cfg.family == "attn":
                want["paged_gather"] = mp * cfg.n_layers
            if quant == "packed":
                want["packed_dense_fused"] = mp * (7 * cfg.n_layers + 1)
            for rep in eng.replicas:
                prog = rep.program
                assert prog.captures == 1 and prog.launches == want
                census = build.graph_census(prog.graph)["kernels"]
                assert {k: census.get(k, 0) for k in want} == want
            assert counts == {k: want.get(k, 0) * m["steps"] * dp for k in build.COUNTS}
        runs.append((m, counts, logits, {r.rid: r.out_tokens for r in eng.finished}))
        eng.close()
    (m_e, counts_e, logits_e, toks_e), (m_c, counts_c, logits_c, toks_c) = runs
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m_c[key] == m_e[key], key
    assert toks_c == toks_e and counts_c == counts_e
    for i in range(dp):
        assert len(logits_c[i]) == len(logits_e[i]) == m_c["steps"]
        for t, (a, b) in enumerate(zip(logits_c[i], logits_e[i])):
            assert a.tobytes() == b.tobytes(), (i, t)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-130m", "qwen3-moe-30b-a3b"])
def test_mesh_engine_on_the_card_matches_the_cpu(cuda, arch):
    """dp 2 x mp 2 at float32 on the forced-preemption workload, the card's
    ranks against the CPU's on the same float weights: the same tokens,
    steps and preemptions, every sampled row within 1e-4."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import MeshConfig

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    params = T.init_params(cfg, seed=5, device="cpu")
    ecfg = EngineConfig(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4, admit="on-demand",
                        gather_backend="kernel", mesh=MeshConfig(2, 2))
    out = []
    for dev in (cuda, torch.device("cpu")):
        eng = build_engine(cfg, ecfg, params=T.map_leaves(params, lambda a: a.to(dev)), device=dev,
                           devices=[dev] * 4)
        rows = {}
        eng.on_sample = lambda rid, t, row, rows=rows: rows.__setitem__((rid, t), row.copy())
        rng = np.random.default_rng(17)
        for ln in (9, 6, 11, 9, 6, 11):
            eng.submit(rng.integers(1, cfg.vocab, size=ln).tolist(), 6)
        m = eng.run(realtime=False)
        eng.assert_no_leaks()
        out.append(({r.rid: r.out_tokens for r in eng.finished}, m["steps"], m["preemptions"], rows))
        eng.close()
    (toks_g, steps_g, pre_g, rows_g), (toks_c, steps_c, pre_c, rows_c) = out
    assert toks_g == toks_c and (steps_g, pre_g) == (steps_c, pre_c) and pre_g > 0
    assert sorted(rows_g) == sorted(rows_c)
    for k in rows_c:
        np.testing.assert_allclose(rows_g[k], rows_c[k], rtol=0, atol=1e-4)


# -- the training half of the mesh (mesh_train) -----------------------------------------


@pytest.mark.parametrize("fsdp", [None, "data"], ids=["replicated", "zero3"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b", "mamba2-130m"])
def test_mesh_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch, arch, fsdp):
    """``make_train_step`` on a 2 x 2 mesh (ZeRO-3 with ``fsdp="data"``, the
    MoE over the all_to_all path), every rank on the card against every
    rank on the CPU, at float32 (TF32 off) and the smoke size from the same
    weights and batch: the loss within 1e-5 relative, each gradient leaf
    within 1e-4 relative L2 over every rank's copy, and one step's params
    within 2.5 lr (Adam's sign(g) steps on elements whose gradient is at
    rounding scale)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding as PS

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32, zero3_regather=fsdp is not None)
    init = T.init_params(cfg, seed=4, device="cpu")
    batch = _train_batch(cfg, b=4)
    lr = 3e-4
    out = []
    for dev in (cuda, torch.device("cpu")):
        mesh = LM.make_mesh(2, 2, [dev] * 4)
        rules = PS.ShardingRules(mesh=mesh, batch="data", fsdp=fsdp)
        params = LM.shard_tree(init, PS.param_shardings(init, rules), mesh)
        step = S.make_train_step(cfg, rules, S.TrainStepConfig(n_micro=2, lr=lr))
        loss, grads = step.loss_and_grads(params, {k: v.to(dev) for k, v in batch.items()})
        grads = [[q.detach().cpu().clone() for q in g.parts] for g in tree_leaves(grads)]
        for x in tree_leaves(params):
            for q in x.parts:
                q.grad = None
        step(params, step.optimizer.init(params), {k: v.to(dev) for k, v in batch.items()})
        out.append((float(loss), grads, [[q.detach().cpu() for q in x.parts] for x in tree_leaves(params)]))
    (lg, gg, pg), (lc, gc, pc) = out
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        assert _rel(torch.cat([t.reshape(-1) for t in a]), torch.cat([t.reshape(-1) for t in b])) <= 1e-4
    for a, b in zip(pg, pc):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=2.5 * lr)


def test_mesh_train_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """Params sharded on a 2 x 2 CPU mesh, saved, restored onto a 1 x 4 mesh
    of the card (``restore(shardings=)``): every part its block bit for
    bit; saved again from the card, the files byte-equal."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import mesh as LM
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding as PS

    cfg = get_config("mamba2-130m", smoke=True)
    init = T.init_params(cfg, seed=6, device="cpu")
    cpu_mesh = LM.make_mesh(2, 2, ["cpu"] * 4)
    specs = PS.param_shardings(init, PS.ShardingRules(mesh=cpu_mesh, batch="data", fsdp="data"))
    CheckpointManager(tmp_path / "a").save(3, LM.shard_tree(init, specs, cpu_mesh))
    card_mesh = LM.make_mesh(1, 4, [cuda] * 4)
    cspecs = PS.param_shardings(init, PS.ShardingRules(mesh=card_mesh, batch="data", fsdp="data"))

    def named(tree):
        return {k: named(v) for k, v in tree.items()} if isinstance(tree, dict) else LM.NamedSharding(card_mesh, tree)

    step, got = CheckpointManager(tmp_path / "a").restore(init, shardings=named(cspecs))
    assert step == 3
    for a, b in zip(tree_leaves(got), tree_leaves(init)):
        assert a.parts[0].device.type == "cuda" and torch.equal(LM.gather_array(a, "cpu"), b)
    CheckpointManager(tmp_path / "b").save(3, got)
    for f in sorted((tmp_path / "a" / "step_00000003").iterdir()):
        assert (tmp_path / "b" / "step_00000003" / f.name).read_bytes() == f.read_bytes(), f.name
