"""Serving CLI (``repro.launch.serve``): the continuous-batching
engine (default for the attn and ssm families) or the fixed-batch decode
loop (``--engine static``, default for the encdec and hybrid families).

Continuous: requests, synthesized here from
``--batch``/``--prompt-len``/``--tokens`` (``--requests`` of them, by
default twice the batch), flow through the admission scheduler of
:class:`repro_torch.serving.Engine` into a paged KV (or SSM) state, and
one captured step advances every active slot per iteration, refilling
slots as sequences finish.  ``--chunk-tokens N`` prefills prompts N tokens
a step, and ``--admit on-demand`` grows pages just in time, preempting the
lowest-progress request when the pool runs dry.  Engine construction goes
through :func:`repro_torch.serving.build_engine`; weights are random, from
:func:`~repro_torch.models.transformer.init_params` with seed 0.

Static: ``--batch`` sequences decode in lockstep on a flat ``[L, B, T,
...]`` cache (:func:`~repro_torch.models.transformer.init_cache`, the
encoder's cross K/V filled once for encdec from random frame embeddings),
greedy, ``--tokens`` steps from one random token a sequence; the first
step is a warm-up outside the timed loop.  On the card the step is one
captured CUDA graph over static token and position buffers, the cache
updated in place (the reference's jitted step donating its cache).

Weight options: ``--int8`` stores every projection as int8 levels and
scales; ``--packed`` quantizes and bit-packs every projection once at
load (``--wbits``/``--abits``), so each step calls the packed matmul
kernels; ``--packed-head`` packs the tied LM head too (w8a8 unless
``--packed`` sets the bits).  ``--plan path.json`` serves a deployment
plan (``python -m repro_torch.plan.compile``) instead: per-layer bit
pairs, tuned block shapes and the plan's LM head.

Lifecycle and fault flags (continuous engine only): ``--deadline``/``--ttft-deadline`` shed
requests that blow their budget, ``--max-waiting`` bounds the queue, and
``--chaos-step-rate``/``--chaos-alloc-rate``/``--chaos-nan-rate`` (with
``--chaos-seed``) arm the deterministic fault injector; the run ends with
a per-status summary.  ``--trace out.json`` writes a Chrome trace of every
request's lifecycle and every step (Perfetto loads it), rewritten every
``--trace-checkpoint-every`` steps; ``--metrics-out FILE`` writes the
Prometheus exposition; ``--telemetry-port P`` serves ``/metrics``,
``/livez`` and ``/trace?since=N`` on a background thread during the run;
``--attrib-every N`` times each layer and bit pair inside every N-th step.

``--device`` is ``cuda`` (the default: the CUDA kernels, the step one
captured graph) or ``cpu`` (the plain PyTorch versions).  A kernel that
fails to build or launch ends the run with its error; nothing falls back
to the plain versions on the card.

``--mesh DPxMP`` serves the continuous engine on a mesh: ``DP`` data
replicas (their own page pools and schedulers) of ``MP`` tensor-parallel
ranks (weights sliced, then packed).  Its ranks take one visible device
each unless ``--mesh-devices`` lists them (``DP * MP`` entries, repeats
allowed: ``cpu,cpu,cpu,cpu``, or ``cuda:0,cuda:0`` for two ranks on one
card); a mesh of more ranks than visible devices raises otherwise, and
with ``MP`` 1 every replica runs on ``--device``.  ``--engine static``
refuses ``--mesh``, as the reference's does.  The continuous engine
refuses the encdec and hybrid families, as the reference's does: they
decode through ``--engine static``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --tokens 64
  PYTHONPATH=src python -m repro_torch.launch.serve --packed --wbits 4 --abits 4 --packed-head
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --int8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch whisper-tiny --tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mesh 2x2 --mesh-devices cpu,cpu,cpu,cpu
"""
from __future__ import annotations

import argparse
import pathlib
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.models import transformer as T
from repro_torch.models.layers import prepack_lm_head
from repro_torch.models.transformer import init_params
from repro_torch.serving import EngineConfig, build_engine
from repro_torch.serving.api import quantize_params_int8, quantize_params_packed
from repro_torch.serving.engine import on_stream

# encoder frames of the static loop's encdec input (the reference's enc_len=16)
ENC_LEN = 16


def _synth_prompts(cfg, n: int, prompt_len: int) -> list[list[int]]:
    """``n`` prompts of ``prompt_len`` uniform token ids from a generator
    seeded 2 (the reference draws its own from ``PRNGKey(2)``)."""
    g = torch.Generator().manual_seed(2)
    return torch.randint(0, cfg.vocab, (n, prompt_len), generator=g).tolist()


def _static_inputs(cfg, batch: int, enc_len: int) -> tuple[torch.Tensor | None, torch.Tensor]:
    """The static loop's random inputs, on the host: encdec's frame
    embeddings ``[batch, enc_len, d]`` float32 from a generator seeded 1
    (None for other families), and the first tokens ``[batch, 1]`` int32
    from one seeded 2 (the reference draws its own from ``PRNGKey(1)`` and
    ``PRNGKey(2)``)."""
    enc = None
    if cfg.family == "encdec":
        enc = torch.randn((batch, enc_len, cfg.d_model), generator=torch.Generator().manual_seed(1))
    tokens = torch.randint(0, cfg.vocab, (batch, 1), generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32)
    return enc, tokens


class StaticStep:
    """The fixed-batch loop's step: :func:`~repro_torch.models.transformer.forward_decode`
    over static buffers.

    The tokens ``[B, 1]`` and the position ``[]`` (int32) live in device
    buffers that the step reads; it updates the cache in place and writes
    its logits ``[B, V]`` float32 into a static output.  On a CUDA device
    everything runs on the step's own stream, and with ``capture`` the
    step that follows the first (eager) one is captured as one CUDA graph
    and every later step replays it: the counterpart of the reference's
    ``jax.jit(..., donate_argnums=(1,))``.  The capture stream holds its
    own split-K counter slot (``kernels/packed_matmul/kernel.py
    _split_scratch``), and replays are serial.  Otherwise (the CPU, or
    ``capture=False``) every step runs eagerly on the same buffers."""

    def __init__(self, params: dict, cfg, cache: dict, head=None, *, batch: int,
                 device: torch.device, capture: bool):
        cuda = device.type == "cuda"
        if capture and not cuda:
            raise ValueError("capture=True needs a CUDA device; the CPU runs the step eagerly")
        self.params, self.cfg, self.cache, self.head = params, cfg, cache, head
        self.capture = capture
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        self.pos = torch.zeros((), dtype=torch.int32, device=device)
        self.logits = torch.zeros((batch, cfg.vocab), dtype=torch.float32, device=device)
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}  # kernel launches of one replay
        self.captures = 0
        # called as on_step(t, logits) after each step's launch, with the
        # logits buffer (valid until the next step; None adds nothing)
        self.on_step = None

    def _forward(self) -> None:
        logits, self.cache = T.forward_decode(self.params, self.cfg, self.cache, self.tokens, self.pos,
                                              head=self.head)
        self.logits.copy_(logits)

    def _capture(self) -> None:
        """Capture the step (not run: a capture records its launches) and
        count its launches a replay; the cache's tensors must be the ones
        the graph writes."""
        before_cache = dict(self.cache)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with build.uncounted(), torch.cuda.graph(graph, stream=self.stream):
            before = build.counts()
            self._forward()
            self.launches = {k: v - before[k] for k, v in build.counts().items() if v != before[k]}
        if any(self.cache[k] is not v for k, v in before_cache.items()):
            raise RuntimeError("the captured step rebound a cache tensor")
        graph.instantiate()
        self.graph = graph
        self.captures += 1

    @torch.inference_mode()
    def step(self, t: int, tokens: torch.Tensor | None = None) -> None:
        """Decode position ``t``, fed ``tokens [B, 1]`` or, by default, the
        greedy argmax of the last step's logits, enqueued on the step's
        stream (nothing waits for it: :meth:`synchronize`).  With
        ``capture`` the first call runs eagerly, which builds the kernels
        and every one-time object, then captures the graph."""
        with on_stream(self.stream):
            if tokens is None:
                self.tokens.copy_(torch.argmax(self.logits, dim=-1, keepdim=True))
            else:
                self.tokens.copy_(tokens)
            self.pos.fill_(t)
            if self.graph is not None:
                self.graph.replay()
                build.replayed(self.launches)
            else:
                self._forward()
                if self.capture:
                    self._capture()
            if self.on_step is not None:
                self.on_step(t, self.logits)

    def synchronize(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()

    def close(self) -> None:
        """Release the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None


def _static_weights(args, cfg, plan, device: torch.device):
    """The static loop's weights from ``init_params`` (seed 0), prepared as
    the reference's ``main`` prepares them: the plan, or ``--packed``, or
    ``--int8``; then ``--packed-head`` at the packed bits or (8, 8)."""
    params, head = init_params(cfg, seed=0, device=device), None
    if plan is not None:
        from repro_torch.plan import apply_plan

        params, head = apply_plan(params, cfg, plan, device=device)
    elif args.packed:
        params = quantize_params_packed(params, w_bits=args.wbits, a_bits=args.abits, device=device)
    elif args.int8:
        params = quantize_params_int8(params)
    if head is None and args.packed_head:
        wb, ab = (args.wbits, args.abits) if args.packed else (8, 8)
        head = prepack_lm_head(params["embed"], w_bits=wb, a_bits=ab, device=device)
    return params, head


def _serve_static(args, cfg, params, head, *, capture: bool | None = None) -> dict:
    """The fixed-batch decode loop on a flat ``[L, B, T, ...]`` cache:
    one warm-up step (kernel builds and, on the card, the capture) outside
    the timed loop, then greedy feedback for ``--tokens - 1`` steps.
    ``capture`` defaults to the device being CUDA."""
    dev = resolve_device(args.device)
    B = args.batch
    cache = T.init_cache(cfg, B, args.max_len, enc_len=ENC_LEN, device=dev)
    enc, tokens = _static_inputs(cfg, B, ENC_LEN)
    if cfg.family == "encdec":
        with torch.inference_mode():
            cache.update(T.encode_for_decode(params, cfg, enc.to(dev)))
    step = StaticStep(params, cfg, cache, head, batch=B, device=dev,
                      capture=dev.type == "cuda" if capture is None else capture)
    try:
        step.step(0, tokens.to(dev))
        step.synchronize()
        t0 = time.time()
        for t in range(1, args.tokens):
            step.step(t)
        step.synchronize()
        dt = time.time() - t0
    finally:
        step.close()
    return {"tokens_per_s": (args.tokens - 1) * B / dt, "latency_ms_per_step": dt / (args.tokens - 1) * 1e3}


def _serve_continuous(args, cfg, plan=None) -> dict:
    """The continuous-batching engine over a synthetic same-arrival workload."""
    ecfg = EngineConfig.from_cli(args)
    quant = "packed" if args.packed else ("int8" if args.int8 else None)
    dev = resolve_device(args.device)
    # the float params are dropped once quantized: no reference is kept here
    eng = build_engine(
        cfg, ecfg, params=init_params(cfg, seed=0, device=dev), quant=quant,
        w_bits=args.wbits, a_bits=args.abits, plan=plan, device=dev,
        devices=args.mesh_devices.split(",") if args.mesh_devices else None,
    )
    for prompt in _synth_prompts(cfg, args.requests or 2 * args.batch, args.prompt_len):
        eng.submit(prompt, args.tokens, deadline=args.deadline, ttft_deadline=args.ttft_deadline)
    eng.warmup()  # kernel builds and the capture stay out of the timed run
    server = None
    if ecfg.obs.telemetry_port is not None:
        from repro_torch.obs.server import TelemetryServer

        def trace_segment(since):
            tr = eng._trace  # armed by run(trace=...); None until then
            return tr.segment(since) if tr is not None else ([], since, 0)

        server = TelemetryServer(metrics_fn=eng.prometheus_text, livez_fn=eng.live_metrics,
                                 trace_fn=trace_segment, port=ecfg.obs.telemetry_port)
        print(f"telemetry at {server.url} (/metrics /livez /trace)")
    try:
        m = eng.run(realtime=True, trace=args.trace)
    finally:
        if server is not None:
            server.close()
    m["latency_ms_per_step"] = m["wall"] / max(1, m["steps"]) * 1e3
    if eng._attrib is not None:
        summ = eng._attrib.summary()
        m["attrib"] = summ
        pairs = ", ".join(f"{p['pair']}: {p['mean_share']:.1%} ({p['n_layers']} layers)" for p in summ["pairs"])
        print(f"attribution ({summ['n_samples']} sampled steps): {pairs}")
    if args.trace:
        print(f"trace written to {args.trace} (load at https://ui.perfetto.dev)")
    if args.metrics_out:
        p = pathlib.Path(args.metrics_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(eng.prometheus_text())
        print(f"metrics exposition written to {p}")
    return m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # default=None so an explicitly-passed arch is distinguishable from the
    # default when checking it against a --plan artifact's arch
    ap.add_argument("--arch", choices=ARCHS, default=None,
                    help="architecture (default llama3.2-3b, or the plan's arch)")
    ap.add_argument("--engine", choices=("continuous", "static"), default=None,
                    help="continuous-batching engine (default for attn/ssm archs) or the "
                    "fixed-batch decode loop (default for encdec/hybrid)")
    ap.add_argument("--batch", type=int, default=8, help="decode slots (batch size)")
    ap.add_argument("--tokens", type=int, default=32, help="generated tokens per request")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=0, help="total requests (default 2x batch)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16, help="KV page size (tokens)")
    ap.add_argument("--pages", type=int, default=0, help="KV page-pool budget (0 = full residency)")
    ap.add_argument("--chunk-tokens", type=int, default=1,
                    help="prefill chunk budget per slot per step (1 = one-token-per-step prefill)")
    ap.add_argument("--admit", choices=("reserve", "on-demand"), default="reserve",
                    help="worst-case page reservation at admit, or on-demand growth with "
                    "lowest-progress preemption")
    ap.add_argument("--mesh", metavar="DPxMP", default=None,
                    help="continuous engine: shard across a data x model mesh (e.g. 2x2: two data replicas "
                    "with their own page pools/schedulers, two tensor-parallel model ranks)")
    ap.add_argument("--mesh-devices", metavar="LIST", default=None,
                    help="comma-separated device of each mesh rank, replica-major (default: one visible "
                    "device a rank)")
    ap.add_argument("--int8", action="store_true", help="int8 weights (levels + per-column scales)")
    ap.add_argument("--plan", metavar="JSON",
                    help="deployment plan artifact (repro_torch.plan.compile): per-layer mixed-precision "
                    "quantize + prepack, tuned block shapes, packed LM head")
    ap.add_argument("--packed", action="store_true",
                    help="sub-8-bit weights, bit-packed once at load (Kernel-Packing serve path)")
    ap.add_argument("--wbits", type=int, default=4, help="--packed weight bits")
    ap.add_argument("--abits", type=int, default=4, help="--packed activation bits")
    ap.add_argument("--packed-head", action="store_true",
                    help="prepack the LM head too (w8a8 unless --packed sets bits)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request total deadline (seconds after arrival); expired requests are shed")
    ap.add_argument("--ttft-deadline", type=float, default=None,
                    help="time-to-first-token deadline (seconds after arrival)")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="waiting-queue bound (0 = unbounded); overflow sheds the least-slack request")
    ap.add_argument("--chaos-step-rate", type=float, default=0.0, help="chaos: P(fused step raises) per attempt")
    ap.add_argument("--chaos-alloc-rate", type=float, default=0.0,
                    help="chaos: P(page alloc transiently fails) per call")
    ap.add_argument("--chaos-nan-rate", type=float, default=0.0,
                    help="chaos: P(sampling logits NaN-poisoned) per slot/step")
    ap.add_argument("--chaos-seed", type=int, default=0, help="chaos: fault-injection RNG seed")
    ap.add_argument("--trace", metavar="JSON", default=None,
                    help="write a Perfetto-loadable Chrome trace (request spans + step/dispatch/"
                    "device-wait timing)")
    ap.add_argument("--metrics-out", metavar="FILE", default=None,
                    help="write the Prometheus text exposition of the engine's metrics after the run")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    help="serve /metrics, /livez and /trace on this port (0 = ephemeral) during the run")
    ap.add_argument("--attrib-every", type=int, default=0,
                    help="every N steps, re-run the step segmented per layer and attribute device time "
                    "to each layer / bit pair (0 = off)")
    ap.add_argument("--attrib-reps", type=int, default=1,
                    help="timing repetitions per attribution segment (min-of-reps)")
    ap.add_argument("--trace-checkpoint-every", type=int, default=0,
                    help="with --trace: rewrite the partial trace every N steps (0 = only at the end)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default: the CUDA kernels) or cpu (the plain "
                    "PyTorch versions)")
    args = ap.parse_args(argv)

    plan = None
    smoke = not args.full
    if args.plan:
        from repro_torch.plan import DeployPlan, summarize

        if args.packed or args.int8 or args.packed_head:
            raise SystemExit(
                "--plan already fixes per-layer quantization and the LM head; "
                "drop --packed/--int8/--packed-head"
            )
        plan = DeployPlan.load(args.plan)
        if args.arch is not None and args.arch != plan.arch:
            raise SystemExit(f"--arch {args.arch} conflicts with plan arch {plan.arch}")
        args.arch = plan.arch
        if args.full and plan.smoke:
            raise SystemExit(
                "--full conflicts with a smoke-compiled plan; recompile with "
                "`repro_torch.plan.compile --full`"
            )
        smoke = plan.smoke  # the plan's layer shapes fix the config variant
        print(f"plan: {summarize(plan)}")
    elif args.arch is None:
        args.arch = "llama3.2-3b"

    cfg = get_config(args.arch, smoke=smoke)
    engine = args.engine
    if engine is None:
        engine = "continuous" if cfg.family in ("attn", "ssm") else "static"
    # the reference's conflict checks, in its order and words
    if engine != "continuous" and (
        args.chunk_tokens != 1 or args.admit != "reserve" or args.mesh is not None
    ):
        raise SystemExit(
            "--chunk-tokens/--admit/--mesh drive the continuous engine; they "
            "have no effect on --engine static — drop them or switch engines"
        )
    lifecycle_flags = (
        args.deadline is not None or args.ttft_deadline is not None
        or args.max_waiting or args.chaos_step_rate or args.chaos_alloc_rate
        or args.chaos_nan_rate
    )
    if engine != "continuous" and lifecycle_flags:
        raise SystemExit(
            "--deadline/--ttft-deadline/--max-waiting/--chaos-* drive the "
            "continuous engine's request lifecycle; they have no effect on "
            "--engine static — drop them or switch engines"
        )
    if engine != "continuous" and (args.trace or args.metrics_out):
        raise SystemExit(
            "--trace/--metrics-out record the continuous engine's request "
            "lifecycle and step timeline; they have no effect on --engine "
            "static — drop them or switch engines"
        )
    if engine != "continuous" and (
        args.telemetry_port is not None or args.attrib_every
        or args.trace_checkpoint_every
    ):
        raise SystemExit(
            "--telemetry-port/--attrib-every/--trace-checkpoint-every drive "
            "the continuous engine's observability; they have no effect on "
            "--engine static — drop them or switch engines"
        )
    if args.trace_checkpoint_every and not args.trace:
        raise SystemExit(
            "--trace-checkpoint-every rewrites the --trace file mid-run; "
            "add --trace PATH or drop it"
        )
    if engine == "continuous":
        out = _serve_continuous(args, cfg, plan=plan)
    else:
        dev = resolve_device(args.device)
        out = _serve_static(args, cfg, *_static_weights(args, cfg, plan, dev))

    if plan is not None:
        mode = f"plan[{plan.n_distinct_bit_pairs} bit pairs]"
    else:
        mode = "packed" if args.packed else ("int8" if args.int8 else "fp")
    if args.packed_head:
        mode += "+packed_head"
    tps = out["tokens_per_s"]
    tps_str = f"{tps:.1f}" if tps is not None else "n/a"
    mesh_str = f" mesh={args.mesh}" if args.mesh else ""
    print(
        f"arch={cfg.name} engine={engine} weights={mode} batch={args.batch}{mesh_str} tokens/s={tps_str} "
        f"latency={out['latency_ms_per_step']:.1f} ms/step"
    )
    if "statuses" in out:
        parts = " ".join(f"{k}={v}" for k, v in sorted(out["statuses"].items()))
        print(
            f"statuses: {parts or 'none'}  (retries={out.get('step_retries', 0)} "
            f"quarantines={out.get('quarantines', 0)} injected={out.get('injected', {})})"
        )
    return out


if __name__ == "__main__":
    main()
