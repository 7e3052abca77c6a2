"""In-situ per-layer attribution (``repro.obs.attrib``): the served step
re-run segment by segment.

The engine's step is one captured graph: its trace span knows only the
whole step's ``device_wait``, never which layer (or which ``(w_bits,
a_bits)`` pair) the time went to.  Every ``attrib_every`` engine steps
the step is re-run **segmented**, on the step's own inputs (tokens,
positions, lens, block table) and a copy of its pre-step state: the
embedding (:func:`~repro_torch.models.transformer.embed_paged`), each
layer (:func:`~repro_torch.models.transformer.decode_paged_layer`, the
body that ``forward_decode_paged`` loops over) and the LM head
(:func:`~repro_torch.models.transformer.head_paged`).  A sample gives
each layer's seconds and share (the shares sum to 1), adds them to the
registry's counters, and the engine cuts its ``device_wait`` span into
child spans by those shares.

Where the port differs from the reference, and why:

* **Device time.**  A layer's eager call is some 130 PyTorch launches,
  so a clock around it measures the host's launch rate.  On the card
  each segment is captured as a CUDA graph of its own, at the first
  sample (the reference's untimed compile pass: one eager pass, then the
  captures), on the attributor's own stream (so its split-K launches keep
  a counter slot of their own) and its own static buffers; a segment's
  time is the least of ``reps`` replays, read from CUDA events.  On the
  CPU the segments run eagerly, timed by ``time.perf_counter``.
* **In-place state.**  ``decode_paged_layer`` writes its layer's state in
  place, where the reference's segments return a new one.  The pre-step
  copy lives in buffers the attributor owns, allocated at the first
  :meth:`LayerAttributor.stage` and ``copy_``'d from the engine's state
  on the step's stream before the step runs; the engine's state is never
  touched.  An attention layer rewrites its pool rows with the same
  values, so its segment can run twice; an SSM layer advances its
  recurrent state, so its slice is restored from the pre-step copy before
  every run of its segment (a second copy, the working one, takes the
  writes).
* **Launch counters.**  The captures and the eager pass run under
  ``build.uncounted()`` and the replays add nothing to the launch
  counters, so the step's counts stay the step graph's nodes times its
  steps; :attr:`LayerAttributor.launches` tallies the segments' own.
* **The step's graph stays as it is**: it is captured once, and the
  attributor never touches it.
* **Memory**: the copy doubles the state (the reference's cost too),
  and the SSM family keeps a second one.

:mod:`repro_torch.obs.drift` reads :attr:`LayerAttributor.samples` for
its in-situ mode.
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import MetricsRegistry


def _iter_packed(tree):
    """Yield every PackedDenseParams leaf of a params subtree."""
    if isinstance(tree, PackedDenseParams):
        yield tree
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_packed(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_packed(v)


def layer_bit_pair(layer_params) -> tuple[int, int] | None:
    """The ``(w_bits, a_bits)`` pair of a layer's packed projections, or
    None for a float layer.  A plan gives one pair a layer; a tree that
    mixes pairs inside one layer reports the smallest."""
    pairs = sorted({(p.w_bits, p.a_bits) for p in _iter_packed(layer_params)})
    return pairs[0] if pairs else None


def pair_label(pair: tuple[int, int] | None) -> str:
    """Metric-label form of a bit pair: ``w5a4``, or ``fp`` for float."""
    return f"w{pair[0]}a{pair[1]}" if pair is not None else "fp"


class LayerAttributor:
    """Sampled segmented profiler of the paged decode step.

    Built once per engine on the engine's per-layer params, head and
    gather.  Each sample is :meth:`stage` (before the step: copy the
    pre-step state) and :meth:`sample` (after it: the segments over the
    step's inputs).  ``device`` decides the clock, as the engine's does;
    on a CUDA device the segments run as CUDA graphs or raise."""

    def __init__(self, cfg, params: dict, *, head=None, reps: int = 1,
                 registry: MetricsRegistry | None = None, max_samples: int = 1024,
                 gather: str = "xla", device: str | torch.device = "cuda"):
        if cfg.family not in ("attn", "ssm"):
            raise NotImplementedError(f"attribution covers the paged attn/ssm step, not {cfg.family!r}")
        if reps < 1:
            raise ValueError("reps must be >= 1")
        self.cfg = cfg
        self.params = T.unstack_layers(params, cfg.n_layers)
        if len(self.params["layers"]) != cfg.n_layers:
            raise ValueError(f"params carry {len(self.params['layers'])} layers, config {cfg.n_layers}")
        self.head = head
        self.reps = reps
        self.registry = registry if registry is not None else MetricsRegistry()
        self.max_samples = max_samples
        self.gather = gather
        self.device = resolve_device(device)
        self.samples: list[dict] = []
        self.n_sample_drops = 0  # samples beyond max_samples (oldest evicted)
        self.bit_pairs = [layer_bit_pair(p) for p in self.params["layers"]]
        self._windows = cfg.windows()
        self._ssm = cfg.family == "ssm"
        self._cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._pre: dict | None = None  # the pre-step state copy
        self._work: dict | None = None  # what the segments write (the copy itself, but for SSM)
        self._inputs: tuple | None = None  # static copies of the step's inputs
        self._segs: list | None = None  # (name, fn, layer or None) a segment
        self._graphs: list | None = None  # (CUDA graph, its launches) a segment, from the first sample
        self._outs: list = []  # each captured segment's static output: the next one's input
        self.logits: torch.Tensor | None = None  # the head segment's output, [S, V] float32
        self.launches: dict[str, int] = {}  # kernel launches of the segments' replays so far
        self.captures = 0

    # -- the segments --------------------------------------------------------

    def _segments(self) -> list:
        """``(name, fn, layer)`` for the embedding, every layer and the
        head; each ``fn`` maps the previous segment's output (the
        embedding: the tokens) to its own (the head: the logits)."""
        cfg, p = self.cfg, self.params
        _, pos, lens, table = self._inputs

        def embed(tokens):
            return T.embed_paged(p, cfg, tokens)

        def layer(i):
            def run(h):
                st = {k: v[i] for k, v in self._work.items()}
                return T.decode_paged_layer(p["layers"][i], cfg, st, table, h, pos, window=self._windows[i],
                                            lens=lens, gather=self.gather)
            return run

        def head(h):
            return T.head_paged(p, cfg, h, lens=lens, head=self.head)

        return ([("embed", embed, None)] + [(f"layer{i}", layer(i), i) for i in range(cfg.n_layers)]
                + [("head", head, None)])

    def _restore(self, i: int) -> None:
        """Put layer ``i``'s pre-step SSM state back before a run of its
        segment (which advances it in place)."""
        for k, w in self._work.items():
            w[i].copy_(self._pre[k][i])

    def stage(self, state: dict, stream: torch.cuda.Stream | None = None) -> None:
        """Copy the engine's pre-step ``state`` into the attributor's own
        buffers, on ``stream`` (the step's; None on the CPU), before the
        step writes it."""
        if self._pre is None:
            self._pre = {k: torch.empty_like(v) for k, v in state.items()}
            self._work = ({k: torch.empty_like(v) for k, v in state.items()} if self._ssm else self._pre)
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with ctx, torch.inference_mode():
            for k, v in state.items():
                self._pre[k].copy_(v)

    # -- timing --------------------------------------------------------------

    def _run_cpu(self) -> list[float]:
        secs = []
        x = self._inputs[0]
        with build.uncounted():
            for _, fn, i in self._segs:
                best = float("inf")
                for _ in range(self.reps):
                    if self._ssm and i is not None:
                        self._restore(i)
                    t0 = time.perf_counter()
                    out = fn(x)
                    best = min(best, time.perf_counter() - t0)
                secs.append(best)
                x = out
        self.logits = x
        return secs

    def _capture(self) -> None:
        """The reference's untimed compile pass: every segment once
        eagerly (kernel libraries, cuBLAS handles and split-K counter slot
        made outside any capture), then one graph a segment, all on one
        memory pool and replayed in the order of their capture."""
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        with build.uncounted():
            x = self._inputs[0]
            for _, fn, i in self._segs:
                if self._ssm and i is not None:
                    self._restore(i)
                x = fn(x)
            self.stream.synchronize()
            x = self._inputs[0]
            for _, fn, _ in self._segs:
                before = build.counts()
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=pool, stream=self.stream):
                    x = fn(x)
                graphs.append((g, {k: v - before[k] for k, v in build.counts().items() if v != before[k]}))
                self._outs.append(x)
        self._graphs = graphs
        self.logits = x
        self.captures += 1

    def _run_cuda(self) -> list[float]:
        if self._graphs is None:
            self._capture()
        events = []
        for (g, launched), (_, _, i) in zip(self._graphs, self._segs):
            pairs = []
            for _ in range(self.reps):
                if self._ssm and i is not None:
                    self._restore(i)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record(self.stream)
                g.replay()
                e1.record(self.stream)
                pairs.append((e0, e1))
                for k, n in launched.items():
                    self.launches[k] = self.launches.get(k, 0) + n
            events.append(pairs)
        self.stream.synchronize()
        return [min(a.elapsed_time(b) for a, b in pairs) / 1e3 for pairs in events]

    # -- sampling ------------------------------------------------------------

    @torch.inference_mode()
    def sample(self, tokens: torch.Tensor, pos: torch.Tensor, lens: torch.Tensor | None,
               table: torch.Tensor, *, stream: torch.cuda.Stream | None = None,
               step: int | None = None) -> dict:
        """One attribution sample over a step's exact inputs (the step
        program's device views; ``lens`` None at ``C = 1``), run on the
        state :meth:`stage` copied before that step.  ``stream`` is the
        step's (its inputs and the copy were written there)."""
        if self._pre is None:
            raise RuntimeError("stage() the pre-step state before sampling")
        if self._cuda:
            if tokens.device.type != "cuda":
                raise ValueError("a CUDA attributor samples the step's CUDA tensors")
            self.stream.wait_stream(stream if stream is not None else torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                self._copy_inputs(tokens, pos, lens, table)
                secs = self._run_cuda()
        else:
            self._copy_inputs(tokens, pos, lens, table)
            secs = self._run_cpu()
        t_embed, per_layer_s, t_head = secs[0], secs[1:-1], secs[-1]
        return self._record(t_embed, per_layer_s, t_head, step)

    def _copy_inputs(self, tokens, pos, lens, table) -> None:
        if self._inputs is None:
            self._inputs = tuple(None if t is None else torch.empty_like(t) for t in (tokens, pos, lens, table))
            self._segs = self._segments()
        for dst, src in zip(self._inputs, (tokens, pos, lens, table)):
            if dst is not None:
                dst.copy_(src)

    def _record(self, t_embed: float, per_layer_s: list, t_head: float, step) -> dict:
        total = sum(per_layer_s)
        rows = []
        reg = self.registry
        layer_sec = reg.counter("repro_attrib_layer_seconds_total", "segmented in-situ device seconds by layer")
        pair_sec = reg.counter("repro_attrib_pair_seconds_total",
                               "segmented in-situ device seconds by (w_bits, a_bits) pair")
        for i, s in enumerate(per_layer_s):
            pair = self.bit_pairs[i]
            label = pair_label(pair)
            rows.append({
                "index": i,
                "w_bits": pair[0] if pair else None,
                "a_bits": pair[1] if pair else None,
                "pair": label,
                "seconds": s,
                "share": s / total if total > 0 else None,
            })
            layer_sec.inc(s, layer=str(i), pair=label)
            pair_sec.inc(s, pair=label)
        reg.counter("repro_attrib_steps_total", "engine steps attributed in situ").inc()
        out = {
            "step": step,
            "reps": self.reps,
            "n_layers": self.cfg.n_layers,
            "embed_seconds": t_embed,
            "head_seconds": t_head,
            "total_layer_seconds": total,
            "layers": rows,
        }
        self.samples.append(out)
        if len(self.samples) > self.max_samples:
            del self.samples[0]
            self.n_sample_drops += 1
        return out

    # -- aggregation ---------------------------------------------------------

    def summary(self) -> dict:
        """Mean attribution over the retained samples: per-layer mean
        seconds and share, and per-pair totals."""
        n = len(self.samples)
        if n == 0:
            return {"n_samples": 0, "layers": [], "pairs": []}
        n_layers = self.cfg.n_layers
        sec = [0.0] * n_layers
        shr = [0.0] * n_layers
        for s in self.samples:
            for row in s["layers"]:
                sec[row["index"]] += row["seconds"]
                shr[row["index"]] += row["share"] or 0.0
        layers = []
        by_pair: dict[str, dict] = {}
        for i in range(n_layers):
            pair = self.bit_pairs[i]
            label = pair_label(pair)
            layers.append({
                "index": i,
                "pair": label,
                "w_bits": pair[0] if pair else None,
                "a_bits": pair[1] if pair else None,
                "mean_seconds": sec[i] / n,
                "mean_share": shr[i] / n,
            })
            agg = by_pair.setdefault(label, {"pair": label, "n_layers": 0, "mean_seconds": 0.0,
                                             "mean_share": 0.0})
            agg["n_layers"] += 1
            agg["mean_seconds"] += sec[i] / n
            agg["mean_share"] += shr[i] / n
        return {
            "n_samples": n,
            "n_sample_drops": self.n_sample_drops,
            "layers": layers,
            "pairs": [by_pair[k] for k in sorted(by_pair)],
        }
