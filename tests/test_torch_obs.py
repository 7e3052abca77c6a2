"""The port's observability layer (``repro_torch.obs`` and the engine's
hooks) against the reference's ``repro.obs``, on the CPU, at the
llama3.2-3b smoke size.

* The pure modules (trace recorder, metrics registry, windowed series,
  exposition checker, telemetry server, kernel timer): every test of
  ``tests/test_obs.py`` that needs no engine, run on both packages with
  the same calls; their outputs must be equal (the exposition text, the
  checker's error lists, ``to_chrome()`` with each event's ``ts`` and
  ``dur`` left out: wall-clock readings).
* The engine on the virtual clock: the reference's engine and the port's
  serve the same schedule on identical weights (the fixture of
  ``tests/test_torch_model.py``), both traced.  Every lifecycle and fault
  decision is a function of the schedule alone, so the event sequences
  must be equal with ``ts`` and ``dur`` left out (and, where attribution
  runs, the child spans' ``seconds`` and ``share`` args: measured times),
  and so must ``live_metrics()`` mid-run, the shared ``metrics()`` keys
  and the exposition (``repro_step_seconds``, a wall-clock histogram,
  left out).  The reference's trace gate must accept the port's traces.
* Attribution: the samples, counters and child spans the reference's
  tests require; bit pairs from a mixed plan; the segmented re-run's head
  rows equal to the fused step's logits bit for bit (llama3.2-3b, and
  mamba2-130m at ``attrib_reps=2``, where a planted skipped restore of
  the SSM slice must break the equality); a traced and attributed run's
  sampled rows equal to an untraced run's.
* Drift: on the same measured rows, the port's report equals the
  reference's.
"""
from __future__ import annotations

import copy
import json
import math
import pathlib
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from test_serving import _prompts
from test_torch_mamba import mamba  # noqa: F401 (fixture)
from test_torch_model import shared  # noqa: F401 (fixture)

import repro.obs.drift as ref_drift
import repro_torch.obs.drift as drift
from repro.kernels import common as ref_common
from repro.obs import TelemetryServer as RefTelemetryServer
from repro.obs import metrics as RM
from repro.obs.promcheck import check_exposition as ref_check_exposition
from repro.obs.trace import TraceRecorder as RefTraceRecorder
from repro.plan.search import plan_from_bits as ref_plan_from_bits
from repro.serving import ChaosConfig as RefChaosConfig
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import build_engine as ref_build_engine
from repro_torch.configs import get_config
from repro_torch.kernels import common
from repro_torch.models import transformer as T
from repro_torch.obs import TelemetryServer
from repro_torch.obs import metrics as M
from repro_torch.obs.attrib import LayerAttributor, layer_bit_pair, pair_label
from repro_torch.obs.promcheck import check_exposition
from repro_torch.obs.trace import ATTRIB_TID, ENGINE_PID, REQUEST_PID, TraceRecorder
from repro_torch.plan.apply import apply_plan
from repro_torch.plan.search import plan_from_bits
from repro_torch.serving import ChaosConfig, Engine, EngineConfig, ObsConfig, build_engine

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "benchmarks"))
import check_invariants as ci  # noqa: E402

# the args of the attribution's child spans that carry measured times
TIMING_ARGS = ("seconds", "share")
# the run metrics both engines report (the port adds a host step time,
# the reference its mesh counters)
METRIC_KEYS = ("engine", "admit", "chunk_tokens", "n_requests", "n_ok", "statuses", "generated_tokens",
               "generated_tokens_ok", "prompt_tokens", "fed_tokens", "preemptions", "quarantines",
               "step_retries", "hard_recoveries", "injected", "steps", "wall", "tokens_per_s",
               "latency_p50", "latency_p99", "ttft_p50", "ttft_p99", "slot_occupancy")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU engine on one intra-op thread (at the smoke size
    thread hand-offs cost more than the arithmetic); the count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(d: dict, timing_args=()) -> list[dict]:
    """A Chrome trace's events without their wall-clock readings."""
    out = []
    for e in d["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur")}
        if timing_args and "args" in e:
            e["args"] = {k: v for k, v in e["args"].items() if k not in timing_args}
        out.append(e)
    return out


def _both(fn):
    """``fn`` on the reference's recorder/metrics modules and the port's."""
    return fn(RefTraceRecorder, RM), fn(TraceRecorder, M)


# ---------------------------------------------------------------------------
# the pure modules
# ---------------------------------------------------------------------------


def test_trace_ring_buffer_bounds_and_counts_drops():
    def run(TR, _):
        tr = TR(capacity=4)
        for i in range(10):
            tr.instant(f"e{i}")
        return tr

    ref, ours = _both(run)
    assert len(ours) == 4 and ours.n_dropped == 6
    assert [e["name"] for e in ours.events] == ["e6", "e7", "e8", "e9"]
    assert _events(ours.to_chrome()) == _events(ref.to_chrome())
    assert ours.to_chrome()["repro"] == ref.to_chrome()["repro"] == {"dropped": 6, "n_events": 4}
    for TR in (RefTraceRecorder, TraceRecorder):
        with pytest.raises(ValueError):
            TR(capacity=0)


def test_trace_request_phases_close_automatically():
    def run(TR, _):
        tr = TR()
        tr.req_begin(7, prompt_tokens=3)
        tr.req_begin(7)  # idempotent
        tr.req_phase(7, "queued")
        tr.req_phase(7, "queued")  # a no-op
        tr.req_phase(7, "prefill", slot=0)
        tr.req_event(7, "prefill_chunk", start=0, n=3)
        tr.req_phase(7, "decode", slot=0)
        tr.req_end(7, "ok", reason=None, out_tokens=2)
        return tr

    ref, ours = _both(run)
    assert _events(ours.to_chrome()) == _events(ref.to_chrome())
    assert [e["name"] for e in ours.events if e["ph"] == "e"] == ["queued", "prefill", "decode", "request"]
    assert ours.phase(7) is None


def test_trace_complete_span_and_chrome_shape(tmp_path):
    def run(TR, _):
        tr = TR()
        t0 = tr.now()
        tr.complete("step", t0, tr.now(), step=1)
        return tr

    ref, ours = _both(run)
    d = ours.to_chrome()
    assert _events(d) == _events(ref.to_chrome())
    assert d["displayTimeUnit"] == "ms" and d["traceEvents"][-1]["dur"] >= 0
    p = ours.save(tmp_path / "sub" / "t.json")
    assert json.loads(p.read_text())["repro"]["n_events"] == 1


@pytest.mark.parametrize("xs,q", [([], 99), ([1.0, 2.0, 3.0], 50), ([5.0], 99), ([3.0, 1.0, 2.0, 10.0], 90)])
def test_percentile_none_never_nan(xs, q):
    ours = M.percentile(xs, q)
    assert ours == RM.percentile(xs, q)
    assert ours is None or not math.isnan(ours)


def test_counter_gauge_labels_and_monotonicity():
    def run(_, mod):
        reg = mod.MetricsRegistry()
        c = reg.counter("c")
        c.inc(status="ok")
        c.inc(2, status="ok")
        c.inc(status="shed")
        with pytest.raises(ValueError):
            c.inc(-1)
        g = reg.gauge("g")
        g.set(5)
        g.inc(-2)
        return reg, c.value(status="ok"), g.value()

    (rreg, *rv), (reg, *v) = _both(run)
    assert v == rv == [3.0, 3.0]
    assert reg.prometheus_text() == rreg.prometheus_text()


def test_histogram_buckets_and_nan_guard():
    def run(_, mod):
        h = mod.Histogram("h", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 2.0, float("nan")):
            h.observe(v)
        return h

    ref, ours = _both(run)
    assert ours.count == ref.count == 3 and not math.isnan(ours.sum)
    assert ours.samples() == ref.samples()
    assert ours.pct(50) == ref.pct(50) == 0.5


def test_registry_exposition_and_kind_clash():
    def run(_, mod):
        reg = mod.MetricsRegistry()
        reg.counter("requests", "total requests").inc(3)
        reg.gauge("depth").set(2)
        reg.histogram("lat", "latency").observe(0.3)
        assert reg.counter("requests") is reg.counter("requests")
        with pytest.raises(TypeError):
            reg.gauge("requests")
        return reg

    ref, ours = _both(run)
    assert ours.prometheus_text() == ref.prometheus_text()
    assert ours.snapshot() == ref.snapshot()
    assert ours.snapshot()["requests"] == 3


def test_windowed_series_prunes_and_rates():
    def run(_, mod):
        w = mod.WindowedSeries()
        for t in range(10):
            w.add(float(t), 2.0)
        return [w.sum(now=9.0, window=3.0), w.rate(now=9.0, window=4.0), w.rate(now=9.0, window=0.0)]

    ref, ours = _both(run)
    assert ours == ref == [8.0, 2.0, None]


def test_trace_metadata_names_every_used_track():
    def run(TR, _):
        tr = TR()
        t0 = tr.now()
        tr.complete("step", t0, tr.now(), step=1)
        tr.complete("layer00 w5a4", t0, tr.now(), tid=ATTRIB_TID)
        tr.req_begin(3)
        tr.req_end(3, "ok")
        return tr

    ref, ours = _both(run)
    assert ours.name_metadata() == ref.name_metadata()
    rows = [(e["name"], e["pid"], e["tid"], e["args"]["name"]) for e in ours.name_metadata()]
    assert rows == [("process_name", ENGINE_PID, 0, "repro-engine"),
                    ("process_name", REQUEST_PID, 0, "repro-requests"),
                    ("thread_name", ENGINE_PID, 0, "fused-step"),
                    ("thread_name", ENGINE_PID, ATTRIB_TID, "layer-attribution"),
                    ("thread_name", REQUEST_PID, 0, "requests")]


def test_trace_counter_events_and_segment_cursor():
    def run(TR, _):
        tr = TR(capacity=4)
        tr.counter("pages", free=7)
        tr.counter("slots", active=2, waiting=1)
        first = tr.segment(0)
        again = tr.segment(first[1])
        for i in range(6):
            tr.instant(f"e{i}")
        stale = tr.segment(2)
        with pytest.raises(ValueError):
            tr.segment(-1)
        return [(_events({"traceEvents": seg}), cur, missed) for seg, cur, missed in (first, again, stale)]

    ref, ours = _both(run)
    assert ours == ref
    assert [(cur, missed) for _, cur, missed in ours] == [(2, 0), (2, 0), (8, 2)]


def test_registry_exposition_passes_conformance_with_hostile_labels():
    def run(_, mod):
        reg = mod.MetricsRegistry()
        reg.counter("req_total", "requests by status").inc(2, status='we"ird\\x')
        reg.counter("req_total").inc(1, status="with\nnewline")
        reg.gauge("depth", "queue depth").set(3)
        reg.histogram("lat_seconds", "latency").observe(0.3)
        return reg.prometheus_text()

    ref, ours = _both(run)
    assert ours == ref
    assert check_exposition(ours) == ref_check_exposition(ours) == []
    assert 'status="we\\"ird\\\\x"' in ours and "\\nnewline" in ours


@pytest.mark.parametrize("doctored, needle", [
    ("# TYPE m counter\n# HELP m late\nm 1\n", "HELP for m after its TYPE"),
    ("# TYPE m counter\nm 1\n# TYPE m counter\n", "duplicate TYPE"),
    ("# TYPE m bogus\nm 1\n", "unknown TYPE"),
    ("m 1\n", "no TYPE declaration"),
    ("# TYPE m counter\n# TYPE n counter\nm 1\nn 1\nm 2\n", "interleave"),
    ('# TYPE m counter\nm{l="a", l="b"} 1\n', "duplicate label"),
    ("# TYPE m gauge\nm NaN\n", "non-finite"),
    ("# TYPE m gauge\nm +Inf\n", "non-finite"),
    ("# TYPE m counter\nm -4\n", "negative counter"),
    ("# TYPE m counter\nm{} garbage\n", "unparseable value"),
    ("# TYPE h histogram\nh_bucket 1\nh_sum 1\nh_count 1\n", "le label"),
    ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\nh_sum 1\nh_count 3\n', "cumulative"),
    ('# TYPE h histogram\nh_bucket{le="1"} 1\nh_sum 1\nh_count 1\n', "+Inf"),
    ('# TYPE h histogram\nh_bucket{le="+Inf"} 2\nh_sum 1\nh_count 3\n', "!= _count"),
])
def test_promcheck_flags_each_violation(doctored, needle):
    errs = check_exposition(doctored)
    assert errs == ref_check_exposition(doctored)
    assert any(needle in e for e in errs), (doctored, errs)


def test_promcheck_accepts_plain_metric_named_like_histogram_series():
    text = "# TYPE x_count counter\nx_count 4\n"
    assert check_exposition(text) == ref_check_exposition(text) == []


def test_metric_values_reject_nonfinite():
    for mod in (RM, M):
        c, g = mod.Counter("c"), mod.Gauge("g")
        for call in (lambda: c.inc(float("nan")), lambda: c.inc(float("inf")),
                     lambda: g.set(float("nan")), lambda: g.inc(float("inf"))):
            with pytest.raises(ValueError):
                call()


def test_kernel_timer_records_and_bests():
    outs = []
    for timed, KT, timing, kw in ((ref_common.timed, ref_common.KernelTimer, ref_common.kernel_timing, {}),
                                  (common.timed, common.KernelTimer, common.kernel_timing, {"device": "cpu"})):
        timer = KT()
        with timing(timer):
            out, dt = timed(lambda x: x * 2, np.ones(4), label="mul", **kw)
            timed(lambda x: x * 2, np.ones(4), label="mul", **kw)
        timed(lambda x: x, np.ones(2), label="mul", **kw)  # no timer installed: recorded nowhere
        assert dt > 0 and (np.asarray(out) == 2.0).all()
        assert timer.best("mul") == min(timer.records["mul"]) and timer.total_best() == timer.best("mul")
        outs.append({k: len(v) for k, v in timer.records.items()})
    assert outs[1] == outs[0] == {"mul": 2}


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_telemetry_server_routes_and_errors():
    def serve(TR, mod, Server):
        reg = mod.MetricsRegistry()
        reg.counter("t_total", "things").inc(2, kind="a")
        tr = TR()
        tr.instant("tick")
        with Server(metrics_fn=reg.prometheus_text, livez_fn=lambda: {"steps": 3}, trace_fn=tr.segment) as srv:
            assert srv.port > 0
            metrics = _get(srv.url + "/metrics")
            livez = _get(srv.url + "/livez")
            seg = json.loads(_get(srv.url + "/trace?since=0")[2])
            seg2 = json.loads(_get(srv.url + f"/trace?since={seg['cursor']}")[2])
            with pytest.raises(urllib.error.HTTPError) as e404:
                urllib.request.urlopen(srv.url + "/nope", timeout=10)
        seg["events"] = _events({"traceEvents": seg["events"]})
        return metrics, livez, seg, seg2, e404.value.code

    ref = serve(RefTraceRecorder, RM, RefTelemetryServer)
    ours = serve(TraceRecorder, M, TelemetryServer)
    assert ours == ref
    metrics, livez, seg, seg2, code = ours
    assert check_exposition(metrics[2].decode()) == [] and json.loads(livez[2]) == {"steps": 3}
    assert len(seg["events"]) == 1 and seg["missed"] == 0 and seg2["events"] == [] and code == 404

    def boom():
        raise RuntimeError("scrape-time failure")

    with TelemetryServer(metrics_fn=boom) as srv:  # unwired routes 404, a broken callable 500
        for route, code in (("/livez", 404), ("/metrics", 500), ("/metrics", 500)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(srv.url + route, timeout=10)
            assert err.value.code == code


# ---------------------------------------------------------------------------
# the engine on the virtual clock, against the reference's
# ---------------------------------------------------------------------------

# tests/test_obs.py _engine(): 2 slots, pages of 8, C = 4, 3 prompts of 6
ENGINE = dict(n_slots=2, page_size=8, max_len=32, chunk_tokens=4)
# tests/test_torch_chunked.py's forced preemption: 5 usable pages of 4 for 3 requests
PREEMPT = dict(n_slots=3, page_size=4, max_len=32, n_pages=6, chunk_tokens=4, admit="on-demand")
# tests/test_obs.py test_traced_chaos_run_reconciles_injections
CHAOS_KW = dict(n_slots=2, page_size=8, max_len=32, chunk_tokens=4, n_pages=5, admit="on-demand",
                max_request_retries=64)
CHAOS = dict(seed=5, step_fault_rate=0.2, alloc_fault_rate=0.2, nan_rate=0.2)


def _obs_prompts(vocab: int) -> list:
    """tests/test_obs.py _engine()'s prompts: 3 of 6 tokens from PRNGKey(1)."""
    rng, out = jax.random.PRNGKey(1), []
    for _ in range(3):
        rng, k = jax.random.split(rng)
        out.append(jax.random.randint(k, (6,), 1, vocab).tolist())
    return out


def _pair(shared, kw: dict, obs: dict | None = None, chaos: dict | None = None):
    """The reference's engine and the port's on ``kw`` (float weights at
    float32; ``obs``: the observability knobs, flat for the reference and
    in ``ObsConfig`` for the port; ``chaos``: a ``ChaosConfig`` for both)."""
    obs = obs or {}
    rk, pk = dict(kw, **obs), dict(kw, obs=ObsConfig(**obs))
    if chaos is not None:
        rk["chaos"], pk["chaos"] = RefChaosConfig(**chaos), ChaosConfig(**chaos)
    reng = ref_build_engine(shared["rcfg"], RefEngineConfig(**rk), params=shared["rp"])
    peng = build_engine(shared["cfg"], EngineConfig(**pk), params=shared["tp"], device="cpu")
    return reng, peng


def _schedule(name: str, vocab: int) -> tuple[dict, list, int]:
    if name == "obs":
        return ENGINE, _obs_prompts(vocab), 5
    if name == "preempt":
        return PREEMPT, _prompts(jax.random.PRNGKey(7), 3, [5, 9, 3], vocab), 8
    return CHAOS_KW, _obs_prompts(vocab), 5


def _exposition(text: str) -> list:
    return [ln for ln in text.splitlines() if "repro_step_seconds" not in ln]


@pytest.mark.parametrize("schedule", ["obs", "preempt", "chaos"])
def test_traced_engine_matches_reference(shared, schedule):
    """tests/test_obs.py's traced runs (its _engine() fixture, the chaos
    fixture through EngineConfig.chaos) and a chunked on-demand run with
    preemptions, served in slices of 3 steps: the same events, live
    metrics between slices, metrics and exposition; the reference's gate
    accepts the port's trace."""
    kw, prompts, new = _schedule(schedule, shared["cfg"].vocab)
    reng, peng = _pair(shared, kw, chaos=CHAOS if schedule == "chaos" else None)
    out = []
    for eng, TR in ((reng, RefTraceRecorder), (peng, TraceRecorder)):
        for p in prompts:
            eng.submit(p, new)
        tr, live = TR(), []
        eng.run(realtime=False, max_steps=3, trace=tr)
        while eng._pending or not eng.scheduler.all_done():
            live.append(eng.live_metrics())
            m = eng.run(realtime=False, max_steps=eng.n_steps + 3)
        out.append((tr.to_chrome(), live, m, eng.prometheus_text()))
    (rd, rlive, rm, rtext), (d, live, m, text) = out
    assert ci.check_trace(d) == [] and ci.check_trace(rd) == []
    assert _events(d) == _events(rd)
    assert d["repro"] == rd["repro"]
    assert live == rlive and len(live) >= 2
    assert {k: m[k] for k in METRIC_KEYS} == {k: rm[k] for k in METRIC_KEYS}
    assert _exposition(text) == _exposition(rtext) and check_exposition(text) == []
    names = {e["name"] for e in d["traceEvents"]}
    assert {"request", "queued", "prefill", "decode", "prefill_chunk", "step", "dispatch", "device_wait"} <= names
    if schedule == "preempt":
        assert m["preemptions"] > 0 and "preempt" in names
    if schedule == "chaos":
        assert sum(m["injected"].values()) > 0 and {"fault_strike", "quarantine", "step_retry"} <= names


def test_trace_path_and_live_metrics_across_runs(shared, tmp_path):
    """run(trace=<path>) writes the file the gate accepts, equal to the
    reference's, and a resumed run keeps the recorder and saves it again;
    live windows span both runs."""
    kw, prompts, new = _schedule("obs", shared["cfg"].vocab)
    reng, peng = _pair(shared, kw)
    files, lives = [], []
    for eng, tag in ((reng, "ref"), (peng, "port")):
        for p in prompts:
            eng.submit(p, new)
        out = tmp_path / f"{tag}.json"
        eng.run(realtime=False, max_steps=4, trace=str(out))
        v1 = eng._vclock
        full1 = eng.live_metrics(window=v1 + 1.0)
        eng.run(realtime=False)  # the armed recorder stays armed and is saved again
        v2 = eng._vclock
        lives.append((full1, eng.live_metrics(window=v2 + 1.0), eng.live_metrics(window=2.0)))
        files.append(json.loads(out.read_text()))
        assert ci.run(str(out), "trace") == []
    assert lives[1] == lives[0]
    assert lives[1][0]["steps_per_s_window"] == pytest.approx(4 / (v1 + 1.0))
    assert _events(files[1]) == _events(files[0]) and files[1]["repro"] == files[0]["repro"]


def test_trace_checkpointing_writes_partial_trace(shared, tmp_path, monkeypatch):
    kw, prompts, new = _schedule("obs", shared["cfg"].vocab)
    saves = {}
    for cls in (RefTraceRecorder, TraceRecorder):
        orig = cls.save
        monkeypatch.setattr(cls, "save", lambda self, path, orig=orig, cls=cls: (
            saves.setdefault(cls, []).append(str(path)), orig(self, path))[1])
    reng, peng = _pair(shared, kw, obs=dict(trace_checkpoint_every=2))
    steps = []
    for eng, tag in ((reng, "ref"), (peng, "port")):
        for p in prompts:
            eng.submit(p, new)
        steps.append(eng.run(realtime=False, trace=str(tmp_path / f"{tag}.json"))["steps"])
    assert steps[0] == steps[1]
    assert len(saves[TraceRecorder]) == len(saves[RefTraceRecorder]) == steps[1] // 2 + 1
    assert set(saves[TraceRecorder]) == {str(tmp_path / "port.json")}
    final = json.loads((tmp_path / "port.json").read_text())
    assert final["repro"]["statuses"] == {"ok": 3} and ci.check_trace(final) == []
    saves.clear()  # no path: checkpointing has nowhere to write
    eng = build_engine(shared["cfg"], EngineConfig(**kw, obs=ObsConfig(trace_checkpoint_every=2)),
                       params=shared["tp"], device="cpu")
    for p in prompts:
        eng.submit(p, new)
    eng.run(realtime=False, trace=TraceRecorder())
    assert saves == {}


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------


def test_attrib_sampling_matches_counters_spans_and_reference(shared, tmp_path):
    """tests/test_obs.py's attribution test on both engines: a sample
    every 2 steps, the registry's counter in step, every layer in each
    sample with positive seconds and shares summing to 1, one child span
    a layer a sample, a counter sample a step; the event sequences equal
    with the measured times left out."""
    kw, prompts, new = _schedule("obs", shared["cfg"].vocab)
    reng, peng = _pair(shared, kw, obs=dict(attrib_every=2))
    ds = []
    for eng, tag in ((reng, "ref"), (peng, "port")):
        for p in prompts:
            eng.submit(p, new)
        out = tmp_path / f"{tag}.json"
        m = eng.run(realtime=False, trace=str(out))
        ds.append(json.loads(out.read_text()))
    at, d = peng._attrib, ds[1]
    assert m["statuses"] == {"ok": 3}
    assert len(at.samples) == m["steps"] // 2 == len(reng._attrib.samples) >= 1
    assert peng.registry.counter("repro_attrib_steps_total").value() == len(at.samples)
    for s in at.samples:
        assert {r["index"] for r in s["layers"]} == set(range(s["n_layers"]))
        assert sum(r["share"] for r in s["layers"]) == pytest.approx(1.0)
        assert all(r["seconds"] > 0 for r in s["layers"])
    text = peng.prometheus_text()
    assert "repro_attrib_layer_seconds_total" in text and check_exposition(text) == []
    assert ci.check_trace(d) == []
    child = [e for e in d["traceEvents"] if e.get("ph") == "X" and e.get("tid") == ATTRIB_TID
             and e.get("pid") == ENGINE_PID]
    assert len(child) == len(at.samples) * peng.cfg.n_layers
    assert {e["name"] for e in d["traceEvents"] if e.get("ph") == "C"} == {
        "pages", "slots", "tokens_per_s_window", "preemptions_total", "shed_total"}
    assert _events(d, TIMING_ARGS) == _events(ds[0], TIMING_ARGS)
    summ = at.summary()
    assert summ["n_samples"] == len(at.samples)
    assert sum(p["mean_share"] for p in summ["pairs"]) == pytest.approx(1.0)
    assert [p["pair"] for p in summ["pairs"]] == [p["pair"] for p in reng._attrib.summary()["pairs"]]


def test_attrib_bit_pairs_from_mixed_plan():
    """tests/test_obs.py's gemma3-1b mixed plan: the pairs read from the
    packed layers and the sample's rows, as the reference reads them."""
    cfg = get_config("gemma3-1b", smoke=True)
    bits = [(5, 4), (8, 4), (2, 2)]
    plan = plan_from_bits(cfg, arch="gemma3-1b", bits=bits, n_slots=2)
    ref_plan = ref_plan_from_bits(__import__("repro.configs", fromlist=["get_config"]).get_config(
        "gemma3-1b", smoke=True), arch="gemma3-1b", bits=bits, n_slots=2)
    assert plan.content_hash() == ref_plan.content_hash()
    params, head = apply_plan(T.init_params(cfg, seed=0, device="cpu"), cfg, plan, verbose=False, device="cpu")
    assert [layer_bit_pair(p) for p in params["layers"]] == bits
    assert pair_label((5, 4)) == "w5a4" and pair_label(None) == "fp"
    eng = Engine(cfg, params, EngineConfig(n_slots=2, page_size=8, max_len=32, chunk_tokens=4,
                                           obs=ObsConfig(attrib_every=2)), head=head, device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(2):
        eng.submit(rng.integers(1, cfg.vocab, 6).tolist(), 4)
    eng.run(realtime=False)
    s = eng._attrib.samples[0]
    assert [r["pair"] for r in s["layers"]] == ["w5a4", "w8a4", "w2a2"]
    assert sum(r["share"] for r in s["layers"]) == pytest.approx(1.0)


@pytest.mark.parametrize("bad", [dict(attrib_reps=0), dict(attrib_every=-1), dict(trace_checkpoint_every=-1)])
def test_attrib_rejects_bad_config(shared, bad):
    with pytest.raises(ValueError):
        ref_build_engine(shared["rcfg"], RefEngineConfig(n_slots=2, page_size=8, max_len=32, **bad),
                         params=shared["rp"])
    with pytest.raises(ValueError):
        build_engine(shared["cfg"], EngineConfig(n_slots=2, page_size=8, max_len=32, obs=ObsConfig(**bad)),
                     params=shared["tp"], device="cpu")
    with pytest.raises(ValueError):
        LayerAttributor(shared["cfg"], shared["tp"], reps=0, device="cpu")


def _segment_run(cfg, params, head, ecfg, prompts, new):
    """Serve ``prompts`` with every step attributed, and record each
    sample's segmented head rows against its step's logits; returns the
    (untraced) sampled rows, the per-sample equalities and the engine."""
    eng = Engine(cfg, params, ecfg, head=head, device="cpu")
    rows, equal = {}, []
    eng.on_sample = lambda rid, t, row: rows.__setitem__((rid, t), row.copy())
    inner = eng._attrib.sample

    def sample(*args, **kw):
        out = inner(*args, **kw)
        equal.append(np.array_equal(eng._attrib.logits.numpy(), eng._program._host_np))
        return out

    eng._attrib.sample = sample
    for p in prompts:
        eng.submit(p, new)
    eng.run(realtime=False, trace=TraceRecorder())
    return rows, equal, eng


def _plain_rows(cfg, params, head, ecfg, prompts, new) -> dict:
    eng = Engine(cfg, params, ecfg, head=head, device="cpu")
    rows = {}
    eng.on_sample = lambda rid, t, row: rows.__setitem__((rid, t), row.copy())
    for p in prompts:
        eng.submit(p, new)
    eng.run(realtime=False)
    return rows


@pytest.mark.parametrize("reps", [1, 2])
def test_segmented_rerun_equals_the_fused_step_llama(shared, reps):
    """w4a4 projections, the (4, 4) head, the kernel gather, C = 4 under
    on-demand admission with preemptions: every sample's head rows equal
    its step's logits bit for bit (an attention layer's second run rewrites
    its rows with the same values), and the traced, attributed run samples
    the rows an untraced run samples."""
    kw = dict(PREEMPT, packed_head=True, head_bits=(4, 4), gather_backend="kernel")
    prompts = _prompts(jax.random.PRNGKey(7), 3, [5, 9, 3], shared["cfg"].vocab)
    ecfg = EngineConfig(**kw, obs=ObsConfig(attrib_every=1, attrib_reps=reps))
    rows, equal, eng = _segment_run(shared["cfg"], shared["tpk"], shared["thead"], ecfg, prompts, 8)
    assert eng.scheduler.n_preemptions > 0 and len(equal) == eng.n_steps and all(equal)
    assert eng._attrib.captures == 0 and eng._attrib.launches == {}  # eager on the CPU
    plain = _plain_rows(shared["cfg"], shared["tpk"], shared["thead"], EngineConfig(**kw), prompts, 8)
    assert rows.keys() == plain.keys() and all(np.array_equal(rows[k], plain[k]) for k in rows)


@pytest.mark.parametrize("planted", [False, True], ids=["restored", "planted-skipped-restore"])
def test_segmented_rerun_equals_the_fused_step_mamba(mamba, monkeypatch, planted):
    """mamba2-130m (w4a4, the (4, 4) head) at attrib_reps=2: each SSM
    layer's slice is restored before each run of its segment, so the head
    rows equal the step's bit for bit; with the restore skipped before the
    second run the recurrence advances twice and the rows differ."""
    if planted:
        real, done = LayerAttributor._restore, set()

        def once(self, i):  # restore before a layer's first run of each sample only
            key = (len(self.samples), i)
            if key not in done:
                done.add(key)
                real(self, i)

        monkeypatch.setattr(LayerAttributor, "_restore", once)
    ecfg = EngineConfig(n_slots=2, page_size=4, max_len=32, chunk_tokens=4, packed_head=True, head_bits=(4, 4),
                        obs=ObsConfig(attrib_every=1, attrib_reps=2))
    prompts = _prompts(jax.random.PRNGKey(7), 3, [5, 9, 3], mamba["cfg"].vocab)
    rows, equal, eng = _segment_run(mamba["cfg"], mamba["tpk"], mamba["thead"], ecfg, prompts, 6)
    assert len(equal) == eng.n_steps > 0
    if planted:
        assert not any(equal)
        return
    assert all(equal)
    plain = _plain_rows(mamba["cfg"], mamba["tpk"], mamba["thead"],
                        EngineConfig(**{k: getattr(ecfg, k) for k in ("n_slots", "page_size", "max_len",
                                                                       "chunk_tokens", "packed_head",
                                                                       "head_bits")}), prompts, 6)
    assert rows.keys() == plain.keys() and all(np.array_equal(rows[k], plain[k]) for k in rows)


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_discordant_pairs_equal_reference(seed):
    rng = np.random.default_rng(seed)
    pred, meas = rng.uniform(size=7).tolist(), rng.uniform(size=7).tolist()
    assert drift._discordant_pairs(pred, meas) == ref_drift._discordant_pairs(pred, meas)


def test_drift_report_equals_reference_on_the_same_rows(monkeypatch):
    """Both packages' build_report on one measured set (the port's CPU
    measurement, handed to both): every field equal but ``backend`` (the
    port names its device, the reference its Pallas mode)."""
    from repro.configs import get_config as ref_get_config

    bits = [(5, 4), (8, 4), (2, 2)]
    cfg, rcfg = get_config("gemma3-1b", smoke=True), ref_get_config("gemma3-1b", smoke=True)
    plan = plan_from_bits(cfg, arch="gemma3-1b", bits=bits, n_slots=4)
    rplan = ref_plan_from_bits(rcfg, arch="gemma3-1b", bits=bits, n_slots=4)
    rows = drift.measure_layer_times(plan, cfg, n_slots=4, reps=1, device="cpu")
    in_rows, in_meta = drift.measure_layer_times_in_situ(plan, cfg, n_slots=4, device="cpu")
    assert all(r["measured_us"] > 0 for r in rows + in_rows) and in_meta["n_samples"] >= 1
    reports = []
    for mod in (ref_drift, drift):
        monkeypatch.setattr(mod, "measure_layer_times", lambda *a, **k: copy.deepcopy(rows))
        monkeypatch.setattr(mod, "measure_layer_times_in_situ",
                            lambda *a, **k: (copy.deepcopy(in_rows), dict(in_meta)))
    reports = [ref_drift.build_report(rplan, rcfg, n_slots=4, reps=1),
               drift.build_report(plan, cfg, n_slots=4, reps=1, device="cpu")]
    for r in reports:
        r.pop("backend")
    assert reports[1] == reports[0]
    assert ci.check_drift(reports[1]) == []
    bad = copy.deepcopy(reports[1])
    bad["in_situ"]["n_samples"] = 0
    assert any("n_samples" in e for e in ci.check_drift(bad))
    json.loads(json.dumps(reports[1], allow_nan=False))
