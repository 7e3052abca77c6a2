"""The engine's step program (``Engine._build_step``, the port of the
reference's jitted step) on the CPU, at the llama3.2-3b smoke size.

On the CPU the program runs its step eagerly on its static buffers (the
card captures the same step in a CUDA graph; ``tests/test_torch_gpu.py``
holds the capture against ``capture=False`` there).  Its logits must be
bit-identical to a plain ``forward_decode_paged`` call on the same inputs
and a twin of the pools, and the engine's sampled rows must stay within
``ATOL`` of the reference engine's (``tests/test_torch_model.py``'s
fixture and tolerance).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from test_serving import _prompts
from test_torch_chunked import LENS, POS, TABLE, _check_streams, _engines
from test_torch_model import _recording, shared  # noqa: F401 (shared: fixture)

from repro_torch.models import transformer as T
from repro_torch.serving import Engine, EngineConfig, build_engine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU engine on one intra-op thread (at the smoke size
    thread hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the forced-preemption fixture of tests/test_torch_chunked.py (5 usable
# pages of 4 tokens for 3 requests of worst case 4-5 pages each)
PREEMPT_KW = dict(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4, admit="on-demand")


def _eager_twin(eng):
    """A plain ``forward_decode_paged`` call on copies of ``eng``'s pools,
    taking the step program's host arguments.  The engine is warmed up
    first: its warm-up step writes rows of null page 0."""
    eng.warmup()
    twin = {k: v.clone() for k, v in eng.state.items()}
    C = eng.ecfg.chunk_tokens

    def step(tokens, pos, lens, table):
        logits, _ = T.forward_decode_paged(
            eng.params, eng.cfg, twin, torch.from_numpy(table.copy()), torch.from_numpy(tokens),
            torch.from_numpy(pos), head=eng._head, lens=torch.from_numpy(lens) if C > 1 else None,
            gather=eng.ecfg.gather_backend)
        return logits.numpy()

    return twin, step


def _same_pools(eng, twin) -> bool:
    return all(torch.equal(eng.state[k], twin[k]) for k in twin)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float"])
def test_step_program_equals_the_eager_forward(shared, packed, chunk):
    """Two steps over an inactive slot, a decoding slot and partial and
    full chunks (tests/test_torch_chunked.py's geometry): logits and pools
    bit-identical to the plain forward, the pools updated in place."""
    params, head = (shared["tpk"], shared["thead"]) if packed else (shared["tp"], None)
    ecfg = EngineConfig(n_slots=4, page_size=8, max_len=32, chunk_tokens=chunk,
                        gather_backend="kernel")
    eng = build_engine(shared["cfg"], ecfg, params=params, head=head, device="cpu")
    state, ptrs = eng.state, {k: v.data_ptr() for k, v in eng.state.items()}
    twin, eager = _eager_twin(eng)
    rng = np.random.default_rng(chunk)
    lens = LENS if chunk > 1 else np.minimum(LENS, 1)
    pos = POS.copy()
    for _ in range(2):
        tokens = rng.integers(0, shared["cfg"].vocab, (4, chunk)).astype(np.int32)
        got = eng._program.run(tokens, pos, lens, TABLE).copy()
        assert got.tobytes() == eager(tokens, pos, lens, TABLE).tobytes()
        assert _same_pools(eng, twin)
        pos = np.minimum(pos + lens, 31 - chunk).astype(np.int32)
    assert eng.state is state and {k: v.data_ptr() for k, v in state.items()} == ptrs
    assert eng._program.graph is None and not eng._program.capture


@pytest.mark.parametrize("gather", ["xla", "kernel"])
def test_step_program_equals_the_eager_forward_under_preemption(shared, gather):
    """The forced-preemption fixture at C = 4: every step's logits
    bit-identical to the plain forward on the same inputs, while
    preemption rewrites the block table between steps."""
    eng = build_engine(shared["cfg"], EngineConfig(**PREEMPT_KW, gather_backend=gather),
                       params=shared["tp"], device="cpu")
    twin, eager = _eager_twin(eng)
    run, tables, same = eng._program.run, [], []

    def spy(tokens, pos, lens, table):
        want = eager(tokens, pos, lens, table)
        got = run(tokens, pos, lens, table)
        same.append(got.tobytes() == want.tobytes() and _same_pools(eng, twin))
        tables.append(table.copy())
        return got

    eng._program.run = spy
    for p in _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], shared["cfg"].vocab):
        eng.submit(p, 6)
    m = eng.run(realtime=False)
    assert m["statuses"] == {"ok": 3} and m["preemptions"] > 0
    assert len(same) == m["steps"] and all(same)
    # a slot's pages were taken away and its row rewritten between two steps
    assert any(((a != 0) & (b != a)).any() for a, b in zip(tables, tables[1:]))
    eng.assert_no_leaks()


@pytest.mark.parametrize("kw", [
    dict(n_slots=4, page_size=8, max_len=64, chunk_tokens=1),
    PREEMPT_KW,
], ids=["decode", "chunked-preemption"])
def test_step_program_engine_matches_reference(shared, kw):
    """w4a4 packed projections and the packed (4, 4) head from the
    reference's own packed words, the kernel gather: the port's sampled
    rows within ATOL of the reference engine's, the same steps, tokens
    fed and preemptions."""
    reng, peng = _engines(shared, dict(kw, gather_backend="kernel"), packed=True, packed_head=True)
    rrec, prec = _recording(reng, ref=True), _recording(peng, ref=False)
    prompts = _prompts(jax.random.PRNGKey(7), 3, [9, 6, 11], shared["cfg"].vocab)
    ms = []
    for eng in (reng, peng):
        for p in prompts:
            eng.submit(p, 6)
        ms.append(eng.run(realtime=False))
    rm, m = ms
    assert m["statuses"] == {"ok": 3}
    assert (m["preemptions"] > 0) == (kw.get("admit") == "on-demand")
    for key in ("steps", "fed_tokens", "preemptions"):
        assert m[key] == rm[key], key
    _check_streams(reng, peng, rrec, prec)


@pytest.mark.parametrize("chunk", [1, 4])
def test_step_reads_nothing_back_to_the_host(shared, chunk, monkeypatch):
    """After one warm step, a float-weight step (the "xla" gather) calls
    none of the tensor methods that read a value back to the host, so the
    same code can be captured on the card."""
    eng = build_engine(shared["cfg"], EngineConfig(n_slots=4, page_size=8, max_len=32,
                                                   chunk_tokens=chunk, gather_backend="xla"),
                       params=shared["tp"], device="cpu")
    eng.warmup()
    tokens = np.random.default_rng(5).integers(0, shared["cfg"].vocab, (4, chunk)).astype(np.int32)
    lens = LENS if chunk > 1 else np.minimum(LENS, 1)
    want = eng._program.run(tokens, POS, lens, TABLE).copy()

    def host_read(*args, **kwargs):
        raise AssertionError("the step read a tensor back to the host")

    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    got = eng._program.run(tokens, POS, lens, TABLE)
    monkeypatch.undo()
    assert np.isfinite(got).all() and got.shape == want.shape


def test_capture_needs_a_cuda_device(shared):
    with pytest.raises(ValueError, match="CUDA"):
        Engine(shared["cfg"], shared["tp"], EngineConfig(), device="cpu", capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        build_engine(shared["cfg"], EngineConfig(), params=shared["tp"], device="cpu", capture=True)
    assert not build_engine(shared["cfg"], EngineConfig(), params=shared["tp"],
                            device="cpu")._program.capture
