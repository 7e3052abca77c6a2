"""The port's serve CLI (``python -m repro_torch.launch.serve``) against
the reference's (``repro.launch.serve``), on the CPU (``--device cpu``).

Both CLIs run with the same arguments on the same weights and prompts:
the port's ``init_params`` is replaced by the reference's ``PRNGKey(0)``
params carried across by :mod:`repro_torch.bridge`, and its
``_synth_prompts`` by the reference's ``PRNGKey(2)`` draws.  Each CLI's
engine is caught as ``build_engine`` returns it, so that every sampled
logits row is recorded.  Per request the token streams must be equal, and
per run the statuses, step retries, quarantines, injected faults, steps,
tokens fed and preemptions.  Both engines run on the wall clock
(``realtime=True``, as the CLIs do), so the cases set no deadline that a
run could reach: every decision is then a function of the schedule, the
chaos seed and the token counts.

Every case but ``bf16`` runs at float32 (each CLI's ``get_config``
returns its config with ``dtype`` float32, as in every other test of the
port against the reference): the rows agree to ``ATOL``, and a token may
differ only where the reference's top-2 gap is under ``TIE_BOUND`` (one
activation-level flip of the packed path moves a logit by about 0.1 at
most; float32 rounding of XLA's and PyTorch's sums), and then the rest of
that request's stream is not compared.  ``bf16`` runs at the configs'
own bfloat16, as the CLIs do by default: its rows agree to
``BF16_ULPS`` units of bfloat16's last place at each row's largest
logit, under the same tie rule.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import TIE_BOUND, _recording
from test_torch_obs import _events

import repro.launch.serve as ref_serve
import repro.serving as ref_serving
from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.obs.promcheck import check_exposition
from repro_torch.serving import EngineConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLAN = ROOT / "artifacts" / "plans" / "drift-mixed.json"
ATOL = 1e-4
BF16_ULPS = 4
RUN_KEYS = ("statuses", "step_retries", "quarantines", "injected", "steps", "fed_tokens", "preemptions",
            "n_requests", "generated_tokens")
SMALL = ["--batch", "2", "--tokens", "4", "--max-len", "32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU engine on one intra-op thread (at the smoke size
    thread hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_prompts(vocab: int, n: int, prompt_len: int) -> list[list[int]]:
    """The reference CLI's prompts (``_serve_continuous``'s loop)."""
    rng, out = jax.random.PRNGKey(2), []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        out.append(jax.random.randint(k, (prompt_len,), 0, vocab).tolist())
    return out


def _run_both(monkeypatch, argv: list[str], float32: bool = True, port_argv: list[str] | None = None):
    """Run the reference's ``main(argv)`` and the port's ``main(port_argv
    or argv, + --device cpu)`` on shared weights and prompts (``float32``:
    both configs at float32); return both outputs, engines and sampled
    rows."""
    caught = {}
    if float32:
        monkeypatch.setattr(ref_serve, "get_config", lambda *a, **k: dataclasses.replace(
            ref_get_config(*a, **k), dtype=jnp.float32))
        monkeypatch.setattr(serve, "get_config", lambda *a, **k: dataclasses.replace(
            get_config(*a, **k), dtype=torch.float32))

    def catching(side, inner):
        def build(*a, **kw):
            eng = inner(*a, **kw)
            caught[side] = (eng, _recording(eng, ref=side == "ref"))
            return eng
        return build

    def port_params(cfg, *, seed, device):
        assert seed == 0 and str(device) == "cpu"
        rcfg = ref_get_config(cfg.name.removesuffix("-smoke"), smoke=cfg.name.endswith("-smoke"))
        return params_from_jax(jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(0), rcfg)))

    monkeypatch.setattr(ref_serving, "build_engine", catching("ref", ref_serving.build_engine))
    monkeypatch.setattr(serve, "build_engine", catching("port", serve.build_engine))
    monkeypatch.setattr(serve, "init_params", port_params)
    monkeypatch.setattr(serve, "_synth_prompts", lambda cfg, n, plen: _ref_prompts(cfg.vocab, n, plen))
    rout = ref_serve.main(list(argv))
    out = serve.main(list(port_argv or argv) + ["--device", "cpu"])
    return rout, out, caught["ref"], caught["port"]


def _check(rout, out, ref, port, bf16: bool = False) -> None:
    """Equal decisions; token streams equal up to a tie (see the module
    docstring), the rows before it within ATOL (``bf16``: BF16_ULPS)."""
    (reng, rrec), (peng, prec) = ref, port
    for key in RUN_KEYS:
        assert out[key] == rout[key], (key, out[key], rout[key])
    assert out["tokens_per_s"] > 0 and out["latency_ms_per_step"] > 0
    ref_out = {r.rid: (r.status, r.out_tokens) for r in reng.finished}
    ours = {r.rid: (r.status, r.out_tokens) for r in peng.finished}
    assert sorted(ours) == sorted(ref_out)
    for rid, (status, theirs) in ref_out.items():
        assert ours[rid][0] == status, rid
        mine = ours[rid][1]
        assert len(mine) == len(theirs), rid
        div = next((t for t in range(len(theirs)) if mine[t] != theirs[t]), None)
        for t in range(len(theirs) if div is None else div + 1):
            theirs_row = rrec[(rid, t)]
            atol = BF16_ULPS * 2.0 ** -7 * np.abs(theirs_row).max() if bf16 else ATOL
            np.testing.assert_allclose(prec[(rid, t)], theirs_row, rtol=0, atol=atol)
        if div is not None:
            top2 = np.sort(rrec[(rid, div)])[-2:]
            assert top2[1] - top2[0] < TIE_BOUND, (rid, div, top2)
    peng.assert_no_leaks()


CASES = {
    "bf16": ["--arch", "llama3.2-3b", *SMALL],
    "int8": ["--arch", "llama3.2-3b", *SMALL, "--int8"],
    "packed": ["--arch", "llama3.2-3b", *SMALL, "--packed", "--wbits", "4", "--abits", "4", "--packed-head"],
    "plan": ["--plan", str(PLAN), *SMALL],
    "chunked-on-demand": ["--arch", "llama3.2-3b", "--batch", "3", "--tokens", "6", "--max-len", "32",
                          "--prompt-len", "9", "--requests", "5", "--page-size", "4", "--chunk-tokens", "4",
                          "--admit", "on-demand", "--pages", "9"],
    "lifecycle-flags": ["--arch", "llama3.2-3b", *SMALL, "--deadline", "600", "--ttft-deadline", "600",
                        "--max-waiting", "64"],
    "chaos": ["--arch", "llama3.2-3b", *SMALL, "--requests", "6", "--chaos-step-rate", "0.2",
              "--chaos-alloc-rate", "0.2", "--chaos-nan-rate", "0.2", "--chaos-seed", "3"],
    "mamba2-130m": ["--arch", "mamba2-130m", *SMALL],
    "qwen2-vl-7b": ["--arch", "qwen2-vl-7b", *SMALL],
    "qwen2-vl-7b-packed": ["--arch", "qwen2-vl-7b", *SMALL, "--packed", "--packed-head", "--chunk-tokens", "4",
                           "--prompt-len", "9"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_reference(monkeypatch, case):
    bf16 = case == "bf16"
    rout, out, ref, port = _run_both(monkeypatch, CASES[case], float32=not bf16)
    _check(rout, out, ref, port, bf16=bf16)
    assert port[0].cfg.dtype == (torch.bfloat16 if bf16 else torch.float32)
    if case == "chunked-on-demand":
        assert out["preemptions"] > 0 and out["fed_tokens"] > out["steps"]
    if case == "chaos":
        assert all(out["injected"][k] > 0 for k in ("step", "alloc", "nan")), out["injected"]
        assert out["step_retries"] > 0 and out["quarantines"] > 0
    if case == "plan":
        assert port[0].cfg.name == "gemma3-1b-smoke"


def test_cli_trace_metrics_and_attribution(monkeypatch, tmp_path):
    """``--trace`` (rewritten every 2 steps), ``--metrics-out`` and
    ``--attrib-every 2``: the two traces' events without their wall-clock
    readings are equal, the port's exposition passes the port's checker,
    and the attribution samples the same steps and bit pairs."""
    def argv(side):
        return ["--arch", "llama3.2-3b", *SMALL, "--packed", "--packed-head", "--trace",
                str(tmp_path / f"{side}.json"), "--trace-checkpoint-every", "2", "--metrics-out",
                str(tmp_path / side / "metrics.prom"), "--attrib-every", "2"]

    rout, out, ref, port = _run_both(monkeypatch, argv("ref"), port_argv=argv("port"))
    _check(rout, out, ref, port)
    traces = [json.loads((tmp_path / f"{side}.json").read_text()) for side in ("ref", "port")]
    events = [_events(d, TIMING_ARGS) for d in traces]
    assert events[1] == events[0] and len(events[0]) > 50
    assert {e["name"] for e in events[1]} >= {"dispatch", "device_wait", "step"}
    text = (tmp_path / "port" / "metrics.prom").read_text()
    assert check_exposition(text) == []
    counters = _counters(text)
    assert counters == _counters((tmp_path / "ref" / "metrics.prom").read_text()) and len(counters) > 3
    rs, s = rout["attrib"], out["attrib"]
    assert s["n_samples"] == rs["n_samples"] > 0
    assert [p["pair"] for p in s["pairs"]] == [p["pair"] for p in rs["pairs"]] == ["w4a4"]
    assert abs(sum(r["mean_share"] for r in s["layers"]) - 1.0) < 1e-6


# wall-clock readings of a realtime run, left out of the comparison: the
# events' ts and dur, and the arguments that carry seconds
TIMING_ARGS = ("seconds", "share")


def _counters(text: str) -> list[str]:
    """The exposition's counter samples that count events (not seconds)."""
    kinds = {ln.split()[2]: ln.split()[3] for ln in text.splitlines() if ln.startswith("# TYPE")}
    names = [(ln, ln.split("{")[0].split()[0]) for ln in text.splitlines() if ln and not ln.startswith("#")]
    return [ln for ln, name in names if kinds.get(name) == "counter" and "seconds" not in name]


def test_cli_telemetry_server_runs_for_the_run_only(monkeypatch):
    """``--telemetry-port 0``: a TelemetryServer serves ``/metrics`` and
    ``/livez`` while the engine runs (scraped from inside ``run``) and is
    closed when ``main`` returns; the reference's CLI does the same."""
    from repro_torch.obs import server as port_server

    servers, scraped = [], []

    class Recording(port_server.TelemetryServer):
        def __init__(self, **kw):
            super().__init__(**kw)
            servers.append(self)

    monkeypatch.setattr(port_server, "TelemetryServer", Recording)
    inner = serve.build_engine

    def build(*a, **kw):
        eng = inner(*a, **kw)
        run = eng.run

        def scraping_run(**rkw):
            for path in ("/metrics", "/livez", "/trace?since=0"):
                with urllib.request.urlopen(servers[-1].url + path, timeout=10) as r:
                    scraped.append((path, r.status, r.read().decode()))
            return run(**rkw)

        eng.run = scraping_run
        return eng

    monkeypatch.setattr(serve, "build_engine", build)
    argv = ["--arch", "llama3.2-3b", *SMALL, "--telemetry-port", "0", "--device", "cpu"]
    out = serve.main(argv)
    assert out["statuses"] == {"ok": 4}
    assert len(servers) == 1 and [s[:2] for s in scraped] == [
        ("/metrics", 200), ("/livez", 200), ("/trace?since=0", 200)]
    assert check_exposition(scraped[0][2]) == []
    assert json.loads(scraped[1][2])["active_slots"] == 0
    assert json.loads(scraped[2][2]) == {"events": [], "cursor": 0, "missed": 0}  # no --trace
    assert not servers[0]._thread.is_alive()
    with pytest.raises(OSError):
        urllib.request.urlopen(servers[0].url + "/livez", timeout=2)
    rout = ref_serve.main(argv[:-2])
    assert rout["statuses"] == out["statuses"]


def test_cli_kernel_error_ends_the_run(monkeypatch, tmp_path):
    """A kernel library that does not load, met inside a step, leaves
    ``main`` with ``build.KernelError`` (no fallback to the plain versions,
    no strike); the telemetry server is closed on the way out."""
    from repro_torch.kernels import build
    from repro_torch.obs import server as port_server

    bad = tmp_path / "paged_gather.so"
    bad.write_bytes(b"not a shared object")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "library_path", lambda name: bad)
    servers = []

    class Recording(port_server.TelemetryServer):
        def __init__(self, **kw):
            super().__init__(**kw)
            servers.append(self)

    monkeypatch.setattr(port_server, "TelemetryServer", Recording)
    inner = serve.build_engine
    engines = []

    def build_planted(*a, **kw):
        eng = inner(*a, **kw)
        run = eng._program.run

        def first_kernel_call(*args):
            if eng.n_steps == 2:
                build.library("paged_gather")
            return run(*args)

        eng._program.run = first_kernel_call
        engines.append(eng)
        return eng

    monkeypatch.setattr(serve, "build_engine", build_planted)
    with pytest.raises(build.KernelError, match="paged_gather"):
        serve.main(["--arch", "llama3.2-3b", *SMALL, "--telemetry-port", "0", "--device", "cpu"])
    (eng,) = engines
    assert eng.n_steps == 2 and eng.hard_recoveries == 0 and eng.fault_log == []
    assert not servers[0]._thread.is_alive()


def test_cli_needs_a_card_unless_told_cpu(monkeypatch):
    """Without ``--device cpu`` the CLI runs on the card, and raises where
    there is none (``device.resolve_device``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-3b", *SMALL])


# every conflict check of the reference's CLI, in its words (the port names
# its own plan compiler)
CONFLICTS = {
    "plan-and-packed": ["--plan", str(PLAN), "--packed"],
    "plan-and-int8": ["--plan", str(PLAN), "--int8"],
    "plan-and-packed-head": ["--plan", str(PLAN), "--packed-head"],
    "plan-arch": ["--plan", str(PLAN), "--arch", "llama3.2-3b"],
    "plan-full": ["--plan", str(PLAN), "--full"],
    "static-chunk": ["--engine", "static", "--chunk-tokens", "4"],
    "static-admit": ["--engine", "static", "--admit", "on-demand"],
    "static-mesh": ["--engine", "static", "--mesh", "2x1"],
    "encdec-chunk": ["--arch", "whisper-tiny", "--chunk-tokens", "4"],
    "static-deadline": ["--engine", "static", "--deadline", "1"],
    "static-chaos": ["--engine", "static", "--chaos-nan-rate", "0.1"],
    "hybrid-max-waiting": ["--arch", "zamba2-1.2b", "--max-waiting", "2"],
    "static-trace": ["--engine", "static", "--trace", "t.json"],
    "static-metrics": ["--engine", "static", "--metrics-out", "m.prom"],
    "static-telemetry": ["--engine", "static", "--telemetry-port", "0"],
    "static-attrib": ["--engine", "static", "--attrib-every", "2"],
    "checkpoint-without-trace": ["--trace-checkpoint-every", "2"],
}


@pytest.mark.parametrize("case", list(CONFLICTS))
def test_cli_conflicts_exit_as_the_reference(case):
    argv = CONFLICTS[case]
    with pytest.raises(SystemExit) as theirs:
        ref_serve.main(list(argv))
    with pytest.raises(SystemExit) as ours:
        serve.main(list(argv) + ["--device", "cpu"])
    want = str(theirs.value.code).replace("`repro.plan.compile", "`repro_torch.plan.compile")
    assert isinstance(ours.value.code, str) and ours.value.code == want


@pytest.mark.parametrize("argv,port_argv", [
    (["--mesh", "2", "--chunk-tokens", "2", *SMALL],
     ["--mesh", "2x2", "--mesh-devices", "cpu,cpu,cpu,cpu", "--chunk-tokens", "2", *SMALL]),
    (["--mesh", "1", *SMALL], None)], ids=["mesh-2x2", "mesh-1"])
def test_cli_refuses_what_the_port_lacks(monkeypatch, argv, port_argv):
    """``--mesh`` against the reference's CLI.  ``mesh-1``: both serve one
    replica.  ``mesh-2x2``: with one device each, both CLIs refuse a 2 x 2
    mesh (the reference asserts its host devices, the port names the
    device list it needs); the port's 2 x 2 on four CPU ranks then serves
    as the reference's dp 2 does (the tensor-parallel sums change rows by
    float rounding only)."""
    if port_argv is not None:
        with pytest.raises(AssertionError, match="not enough host devices"):
            ref_serve.main(["--mesh", "2x2", *SMALL])
        with pytest.raises(ValueError, match="a 2x2 mesh needs 4 devices, 1 cpu"):
            serve.main(["--mesh", "2x2", *SMALL, "--device", "cpu"])
    rout, out, ref, port = _run_both(monkeypatch, argv, port_argv=port_argv)
    _check(rout, out, ref, port)
    assert (out["dp"], out["mp"]) == ((2, 2) if port_argv else (1, 1))
    assert rout["dp"] == out["dp"]


def _ref_static_inputs(cfg, batch: int, enc_len: int):
    """The reference's static loop inputs (``_serve_static``'s draws), as
    the port's ``_static_inputs`` returns them."""
    enc = None
    if cfg.family == "encdec":
        enc = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(1), (batch, enc_len, cfg.d_model))))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (batch, 1), 0, cfg.vocab))
    return enc, torch.from_numpy(tokens.astype(np.int32))


def _fed_steps(monkeypatch, side: str) -> list:
    """Record every ``forward_decode`` call of one side's static loop: the
    tokens it was fed, its position and its logits (the reference's jitted
    step reports them through ``jax.debug.callback``)."""
    rec = []
    if side == "ref":
        inner = RT.forward_decode

        def wrapped(params, cfg, cache, tokens, pos, head=None):
            logits, cache = inner(params, cfg, cache, tokens, pos, head=head)
            jax.debug.callback(lambda t, p, lg: rec.append((np.asarray(t).copy(), int(p), np.asarray(lg).copy())),
                               tokens, pos, logits, ordered=True)
            return logits, cache

        monkeypatch.setattr(RT, "forward_decode", wrapped)
    else:
        inner = T.forward_decode

        def wrapped(params, cfg, cache, tokens, pos, head=None):
            logits, cache = inner(params, cfg, cache, tokens, pos, head=head)
            rec.append((tokens.numpy().copy(), int(pos), logits.numpy().copy()))
            return logits, cache

        monkeypatch.setattr(T, "forward_decode", wrapped)
    return rec


def _arch_line(text: str) -> str:
    """The CLI's ``arch=...`` line without its wall-clock readings."""
    (line,) = [ln for ln in text.splitlines() if ln.startswith("arch=")]
    return re.sub(r"tokens/s=\S+ latency=\S+ ms/step", "tokens/s=_ latency=_ ms/step", line)


STATIC_CASES = {
    "static": ["--engine", "static", "--plan", str(PLAN), *SMALL],
    "encdec": ["--arch", "whisper-tiny", *SMALL],
    "encdec-packed": ["--arch", "whisper-tiny", *SMALL, "--packed", "--packed-head"],
    "encdec-static-int8": ["--arch", "whisper-tiny", "--engine", "static", "--int8", *SMALL],
    "hybrid": ["--arch", "zamba2-1.2b", *SMALL],
}


@pytest.mark.parametrize("case", list(STATIC_CASES))
def test_cli_static_matches_reference(monkeypatch, capsys, case):
    """``--engine static`` (the default for encdec and hybrid) against the
    reference's CLI at float32 on shared weights, encoder frames and first
    tokens: the tokens each step feeds are equal (the greedy stream up to a
    tie, as :func:`_check` rules), the rows before any tie agree to
    ``ATOL``, and the ``arch=`` line is the reference's but for its times.
    ``static`` serves the gemma3-1b plan (per-layer list, w_down at block_k
    64 < K: K2's plain version) through the static loop."""
    argv = STATIC_CASES[case]
    monkeypatch.setattr(ref_serve, "get_config", lambda *a, **k: dataclasses.replace(
        ref_get_config(*a, **k), dtype=jnp.float32))
    monkeypatch.setattr(serve, "get_config", lambda *a, **k: dataclasses.replace(
        get_config(*a, **k), dtype=torch.float32))

    def port_params(cfg, *, seed, device):
        assert seed == 0 and str(device) == "cpu"
        rcfg = ref_get_config(cfg.name.removesuffix("-smoke"), smoke=cfg.name.endswith("-smoke"))
        return params_from_jax(jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(0), rcfg)))

    monkeypatch.setattr(serve, "init_params", port_params)
    monkeypatch.setattr(serve, "_static_inputs", _ref_static_inputs)
    theirs, ours = _fed_steps(monkeypatch, "ref"), _fed_steps(monkeypatch, "port")
    ref_serve.main(list(argv))
    ref_text = capsys.readouterr().out
    out = serve.main(list(argv) + ["--device", "cpu"])
    assert _arch_line(capsys.readouterr().out) == _arch_line(ref_text) and "engine=static" in _arch_line(ref_text)
    assert out["tokens_per_s"] > 0 and out["latency_ms_per_step"] > 0
    n = int(argv[argv.index("--tokens") + 1])
    assert [p for _, p, _ in ours] == [p for _, p, _ in theirs] == list(range(n))
    for t, ((tok, _, row), (rtok, _, rrow)) in enumerate(zip(ours, theirs)):
        if not np.array_equal(tok, rtok):  # a tie in the previous step decided it
            top2 = np.sort(theirs[t - 1][2], axis=-1)[:, -2:]
            lanes = np.flatnonzero(tok[:, 0] != rtok[:, 0])
            assert t > 0 and np.all(top2[lanes, 1] - top2[lanes, 0] < TIE_BOUND), (t, top2[lanes])
            break
        np.testing.assert_allclose(row, rrow, rtol=0, atol=ATOL, err_msg=f"step {t}")


def test_cli_hybrid_continuous_fails_as_the_reference():
    """``--engine continuous`` on zamba2-1.2b: both engines refuse the
    hybrid family at construction with the same words (the port adds that
    it decodes through ``--engine static``)."""
    argv = ["--arch", "zamba2-1.2b", "--engine", "continuous", *SMALL]
    with pytest.raises(NotImplementedError) as theirs:
        ref_serve.main(list(argv))
    with pytest.raises(NotImplementedError) as ours:
        serve.main(list(argv) + ["--device", "cpu"])
    assert str(ours.value).startswith(str(theirs.value)) and "--engine static" in str(ours.value)


def _namespace(argv):
    """The reference CLI's parsed arguments for ``argv``, without running it."""
    import argparse

    seen, real = {}, argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        seen["ns"] = real(self, args, namespace)
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(SystemExit):
            ref_serve.main(argv)
    return seen["ns"]


@pytest.mark.parametrize("argv", [
    [], ["--packed", "--wbits", "3", "--abits", "2", "--packed-head"], ["--packed-head"],
    ["--batch", "4", "--max-len", "64", "--pages", "9", "--page-size", "8", "--chunk-tokens", "4",
     "--admit", "on-demand", "--max-waiting", "3", "--attrib-every", "2", "--attrib-reps", "3",
     "--trace-checkpoint-every", "5", "--telemetry-port", "0", "--chaos-step-rate", "0.1",
     "--chaos-alloc-rate", "0.2", "--chaos-nan-rate", "0.3", "--chaos-seed", "7"]],
    ids=["defaults", "packed", "packed-head", "every-knob"])
def test_engine_config_from_cli_matches_reference(argv):
    """``EngineConfig.from_cli`` field for field the reference's, on the
    reference CLI's own parsed arguments; a partial namespace takes the
    defaults, and a mesh spec parses as the reference's."""
    import argparse

    from repro.serving import EngineConfig as RefEngineConfig

    ns = _namespace(argv)
    theirs, ours = RefEngineConfig.from_cli(ns), EngineConfig.from_cli(ns)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name in ("obs", "chaos", "mesh"):
            assert dataclasses.asdict(a) == {k: v for k, v in dataclasses.asdict(b).items()
                                             if k in dataclasses.asdict(a)}, f.name
        else:
            assert a == b, f.name
    assert EngineConfig.from_cli(argparse.Namespace()) == EngineConfig()
    for spec in ("2x2", "2", "1x4"):
        mesh_ns = argparse.Namespace(**{**vars(ns), "mesh": spec})
        assert (dataclasses.asdict(EngineConfig.from_cli(mesh_ns).mesh)
                == dataclasses.asdict(RefEngineConfig.from_cli(mesh_ns).mesh))
