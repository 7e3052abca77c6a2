"""Continuous-batching decode engine (``repro.serving.engine``).

Each iteration runs one fused step over every slot: a chunk of up to
``chunk_tokens`` prompt (or replayed) tokens for a request still
prefilling, its one newest token for a request decoding.  The batch ships
as dense ``[S, C]`` tokens with per-slot positions, valid lengths (at
``C > 1``) and the block table;
:func:`~repro_torch.models.transformer.forward_decode_paged` writes each
slot's valid K/V rows into the paged pools in place and returns the
logits of each slot's last valid lane, and the host samples them (greedy
argmax, as the reference) and admits, funds, preempts and finishes
requests between steps.

``admit="reserve"`` reserves each request's worst-case pages at
admission; ``admit="on-demand"`` grants pages before each step and, when
the pool runs dry, preempts the lowest-progress slot (its pages freed, the
request requeued with its generated prefix and replayed chunked later).

The step is built once per engine (:meth:`Engine._build_step`, the
reference's jitted ``_step``): a :class:`StepProgram` over static batch,
logits and pool buffers.  On a CUDA device it is one CUDA graph, captured
on the engine's own stream and replayed every step; ``capture=False``
runs the same step eagerly (the reference's ``jax.disable_jit()``), as the
CPU always does.

With ``cfg.kv_dtype == "int8"`` the pools hold int8 levels and float32
per-row scale pools; the step writes both in place (captured in the graph
like every other write), and a replayed request rewrites both.

**Request lifecycle** (the reference's).  Every request ends in exactly
one terminal status, ``ok``, ``cancelled``, ``shed`` or ``failed`` (see
:mod:`repro_torch.serving.lifecycle`).  Between steps, on the host, the
engine polices cooperative cancellation (:meth:`Engine.cancel`), TTFT and
total deadlines (shedding requests that expired or provably cannot meet
their deadline) and a bounded waiting queue (``max_waiting``) that sheds
the request with the least deadline slack.  A stall watchdog sheds the
head of the waiting queue after ``watchdog_ticks`` idle loop iterations,
so ``run()`` never raises on a stall.  ``policy="static"`` admits only
when every slot is free (gang admission, the fixed-batch baseline).  A
cancelled or shed request's slot and pages are freed between two steps:
the next step stages the cleared block-table row, so the slot's lanes
land on null page 0; the graph is never captured again.

**The SSM family** (mamba2) carries a slot-indexed recurrent state in
place of KV pools: each step updates every slot's state in place (a
slot's lanes past its ``lens`` leave it alone), and :meth:`Engine._reset_slot`
zeroes a slot's state between steps whenever the scheduler admits a
request into it, first admissions and re-admissions after a preemption
alike, so that a replayed request rebuilds its state from position 0.
The scheduler still allocates pages for SSM requests (the block table is
ignored), so admission and preemption follow the reference's.

**Faults** (the reference's fault layer).  A step that raises an
:class:`~repro_torch.serving.chaos.InjectedFault` (``ecfg.chaos``, fired
before the batch is staged, so nothing was touched) is retried up to
``max_step_retries`` times, then the lowest-progress request is struck.
A sampled row that is not finite (a NaN-poisoned one under chaos, or a
real one) is never sampled: its request is struck.  A strike preempts the
request for a token-identical replay and quarantines its slot for
``quarantine_ticks`` ticks; past ``max_request_retries`` strikes the
request ends ``failed``.  Any other exception out of the step is a hard
fault: every resident request is struck and the state is restored from
the latest snapshot (``snapshot_every``: the state is saved through a
:class:`~repro_torch.checkpoint.CheckpointManager` every N steps) or
zeroed, and the replays rebuild every resident row.

Two rules are the port's own.  A restore writes into the state tensors
in place (``copy_``/``zero_``): the captured graph (and the eager step's
closure) hold those tensors, so a restore that rebinds ``self.state``
would leave the step reading the old ones while the engine resets the
new.  And an error of the device is never recovered: a
:class:`~repro_torch.kernels.build.KernelError`, or any fault after which
``torch.cuda.synchronize`` fails (a sticky CUDA error), propagates out of
``run()``, where the reference would replay it until every request ends
``failed``.

**Observability** (the reference's, :mod:`repro_torch.obs`).  The engine
keeps a :class:`~repro_torch.obs.metrics.MetricsRegistry` (``registry``;
``prometheus_text()``) and windowed series behind ``live_metrics()``,
both readable between ``run(max_steps=)`` slices.  ``run(trace=...)``
records every request's phases and events and every step's ``dispatch``,
``device_wait`` and ``step`` spans in a
:class:`~repro_torch.obs.trace.TraceRecorder`; with
``ObsConfig(attrib_every=N)`` every N-th step is re-run segment by segment
(:class:`~repro_torch.obs.attrib.LayerAttributor`) on a copy of its
pre-step state, which attributes the step's device time to each layer and
bit pair.  Off, each hook is one ``is not None`` test, and the step adds
no synchronisation and no timestamp.

``ObsConfig.telemetry_port`` is read by the serve CLI alone
(:mod:`repro_torch.launch.serve`), which runs a
:class:`~repro_torch.obs.server.TelemetryServer` around ``run()``; the
engine never opens a socket.

**Mesh parallelism** (the reference's).  ``EngineConfig.mesh =
MeshConfig(dp, mp)`` serves ``dp`` data replicas, each with its own page
pool, block table, scheduler, state and step program (requests are routed
round-robin over the live replicas at admission), every replica stepped
each iteration.  ``mp > 1`` also splits the model over ``mp``
tensor-parallel ranks: heads, ``d_ff``, SSM heads, experts and the vocab
are sliced, weights sliced first and then packed against the global
normalizers (:func:`repro_torch.serving.api.build_engine`), and a
replica's step runs its ranks in lockstep
(:func:`~repro_torch.models.transformer.forward_decode_paged_tp`: one
reduction before each residual, the logits gathered over the vocab).  The
ranks sit on the devices of a :class:`~repro_torch.launch.mesh.Mesh`
(``devices=``; one per visible device by default, raising when there are
fewer).  With ``mp == 1`` and no device list every replica runs on the
engine's device, as the reference's dp-only engine dispatches its one
compiled step per replica, so each replica's tokens equal the single
engine's bit for bit.  A replica whose ranks share one card is one
captured CUDA graph on a stream of its own (its own split-K counters);
ranks on several devices run eagerly.  Under ``mp > 1`` int8 KV pools
and in-situ attribution are refused, as the reference refuses them.  A
replica that stalls alone (waiting work, nothing placeable) while a
sibling is live is quarantined whole for ``quarantine_ticks`` and its
queue re-routed (the reference's replica watchdog).

Not ported, and refused where asked for: the reference's flat
observability keywords (``EngineConfig(attrib_every=...)``; use
``obs=ObsConfig(...)``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.paged_gather.ops import check_gather_backend
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as T
from repro_torch.models.layers import prepack_lm_head
from repro_torch.obs.attrib import LayerAttributor
from repro_torch.obs.metrics import MetricsRegistry, WindowedSeries, percentile
from repro_torch.obs.trace import ATTRIB_TID, TraceRecorder
from repro_torch.serving.chaos import ChaosConfig, ChaosInjector, InjectedFault
from repro_torch.serving.lifecycle import SLO, TERMINAL_STATUSES, Request
from repro_torch.serving.paged_kv import BlockTable, PageAllocator
from repro_torch.serving.scheduler import Scheduler


# idle run()-loop iterations with waiting but unplaceable work before the
# stall watchdog sheds the head of the waiting queue: the default of
# ``EngineConfig.watchdog_ticks``, the reference's
WATCHDOG_TICKS = 64


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (the reference's)."""

    # > 0: every N steps, re-run the step segment by segment on a copy of
    # its pre-step state and attribute device time to each layer and bit
    # pair (repro_torch.obs.attrib).  0 (off) costs one test per step.
    attrib_every: int = 0
    # timed replays of each attribution segment (the least counts)
    attrib_reps: int = 1
    # > 0 with run(trace=<path>): rewrite the partial trace to disk every
    # N steps, so a crashed run still leaves a loadable trace behind
    trace_checkpoint_every: int = 0
    # the serve CLI's /metrics, /livez and /trace port (0: an ephemeral
    # one) for the duration of its run; None: no server.  The engine
    # itself never reads it.
    telemetry_port: int | None = None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh shape for the serving engine: ``dp`` data replicas x ``mp``
    tensor-parallel model ranks.  ``(1, 1)`` (the default) is the
    single-device engine."""

    dp: int = 1
    mp: int = 1

    def __post_init__(self):
        if self.dp < 1 or self.mp < 1:
            raise ValueError(f"mesh axes must be >= 1, got dp={self.dp} mp={self.mp}")

    @property
    def enabled(self) -> bool:
        return self.dp > 1 or self.mp > 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.mp

    @classmethod
    def parse(cls, spec) -> "MeshConfig":
        """``"2x2"`` / ``"2"`` / ``(2, 2)`` / ``None`` -> MeshConfig."""
        if spec is None:
            return cls()
        if isinstance(spec, MeshConfig):
            return spec
        if isinstance(spec, str):
            parts = [int(p) for p in spec.lower().split("x")]
        else:
            parts = [int(p) for p in spec]
        if len(parts) == 1:
            return cls(dp=parts[0])
        if len(parts) == 2:
            return cls(dp=parts[0], mp=parts[1])
        raise ValueError(f"mesh spec must be DP or DPxMP, got {spec!r}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 8
    page_size: int = 16
    max_len: int = 128  # per-sequence cap: prompt + generated tokens
    n_pages: int = 0  # page-pool budget; 0 => every slot can hold max_len
    policy: str = "continuous"  # or "static" (gang admission baseline)
    chunk_tokens: int = 1
    admit: str = "reserve"
    packed_head: bool = False
    head_bits: tuple[int, int] = (8, 8)
    # waiting-queue bound; 0 = unbounded.  Overflow sheds the request with
    # the least deadline slack.
    max_waiting: int = 0
    watchdog_ticks: int = WATCHDOG_TICKS
    # ticks a slot sits out of admission after hosting a fault
    quarantine_ticks: int = 8
    # injected step faults retried before a victim is struck, and strikes a
    # request survives before it ends "failed"
    max_step_retries: int = 4
    max_request_retries: int = 3
    # > 0: snapshot the state every N steps (restored on a hard fault) into
    # snapshot_dir (None: a new temporary directory)
    snapshot_every: int = 0
    snapshot_dir: str | None = None
    gather_backend: str = "xla"  # "xla": pool[block_table]; "kernel": CUDA gather
    chaos: ChaosConfig = ChaosConfig()  # fault injection; off by default
    obs: ObsConfig = ObsConfig()  # tracing and attribution knobs; off by default
    mesh: MeshConfig = MeshConfig()  # data replicas x tensor-parallel ranks

    @property
    def blocks_per_slot(self) -> int:
        return -(-self.max_len // self.page_size)

    def pool_pages(self) -> int:
        return self.n_pages or self.n_slots * self.blocks_per_slot + 1

    @classmethod
    def from_cli(cls, args) -> "EngineConfig":
        """An EngineConfig from an argparse namespace (the serve CLI's flag
        set), field for field the reference's: missing attributes take the
        field defaults, so partial namespaces work; ``--mesh DPxMP`` enters
        the engine here or through an explicit :class:`MeshConfig`."""
        g = lambda name, default: getattr(args, name, default)  # noqa: E731
        packed = bool(g("packed", False))
        return cls(
            n_slots=g("batch", 8),
            page_size=g("page_size", 16),
            max_len=g("max_len", 128),
            n_pages=g("pages", 0),
            chunk_tokens=g("chunk_tokens", 1),
            admit=g("admit", "reserve"),
            packed_head=bool(g("packed_head", False)),
            head_bits=(g("wbits", 8), g("abits", 8)) if packed else (8, 8),
            max_waiting=g("max_waiting", 0),
            gather_backend=g("gather_backend", "xla"),
            obs=ObsConfig(
                attrib_every=g("attrib_every", 0),
                attrib_reps=g("attrib_reps", 1),
                trace_checkpoint_every=g("trace_checkpoint_every", 0),
                telemetry_port=g("telemetry_port", None),
            ),
            chaos=ChaosConfig(
                seed=g("chaos_seed", 0),
                step_fault_rate=g("chaos_step_rate", 0.0),
                alloc_fault_rate=g("chaos_alloc_rate", 0.0),
                nan_rate=g("chaos_nan_rate", 0.0),
            ),
            mesh=MeshConfig.parse(g("mesh", None)),
        )


@contextlib.contextmanager
def on_stream(stream: torch.cuda.Stream | None):
    """Run the block on ``stream``, after the work already queued on the
    caller's stream (which wrote the pools, caches and params it reads);
    None (the CPU) runs it as it is."""
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        yield


class StepProgram:
    """One engine's fused step over static buffers.

    The batch (block table ``[S, n_blocks]``, tokens ``[S, C]``, ``pos
    [S]`` and, at ``C > 1``, ``lens [S]``, all int32) is written into one
    host staging buffer and copied to one device buffer whose views the
    step reads; the step updates the pools in place and writes its logits
    ``[S, V]`` float32 into a static output, which is copied to a host
    buffer.  On a CUDA device the host buffers are pinned and everything
    runs on the program's own stream; with ``capture`` the step is one CUDA
    graph, captured by :meth:`prepare` and replayed by every :meth:`run`.
    Otherwise (the CPU, or ``capture=False``) :meth:`run` calls the step
    eagerly on the same buffers.

    The graph keeps the split-K counter slot of its capture stream (see
    ``kernels/packed_matmul/kernel.py _split_scratch``): each program
    captures on a stream of its own, and its replays are serial, since
    :meth:`run` waits for each step's logits."""

    def __init__(self, step, *, n_slots: int, chunk: int, n_blocks: int, vocab: int,
                 device: torch.device, capture: bool):
        """``step(tokens, pos, lens, table)`` returns the logits; ``lens`` is
        None at ``chunk == 1``, as in the reference's C = 1 step."""
        cuda = device.type == "cuda"
        if capture and not cuda:
            raise ValueError("capture=True needs a CUDA device; the CPU runs the step eagerly")
        self._step = step
        self.device = device
        self.capture = capture
        S, C = n_slots, chunk
        sizes = (S * n_blocks, S * C, S, S if C > 1 else 0)
        ends = np.cumsum(sizes).tolist()
        self._stage = torch.zeros(ends[-1], dtype=torch.int32, pin_memory=cuda)
        self._stage_np = self._stage.numpy()
        self._slices = [slice(a, b) for a, b in zip([0] + ends[:-1], ends)]
        batch = torch.zeros(ends[-1], dtype=torch.int32, device=device)
        table, tokens, pos, lens = (batch[sl] for sl in self._slices)
        self._batch = batch
        self._args = (tokens.view(S, C), pos, lens if C > 1 else None, table.view(S, n_blocks))
        self.logits = torch.zeros((S, vocab), dtype=torch.float32, device=device)
        self._host = torch.zeros((S, vocab), dtype=torch.float32, pin_memory=cuda)
        self._host_np = self._host.numpy()
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}  # kernel launches of one replay
        self.captures = 0  # graphs captured by this program
        self._ready = False

    def _on_stream(self):
        return on_stream(self.stream)

    def _forward(self) -> None:
        self.logits.copy_(self._step(*self._args))

    @torch.inference_mode()
    def prepare(self) -> None:
        """Run the step once eagerly with every slot inactive (a zero batch,
        so its rows land on null page 0), which loads the kernel libraries
        and makes every one-time object (kernel attributes, cuBLAS handles,
        the split-K counters, cached scalars) outside any capture; then,
        with ``capture``, capture the graph and record its launches per
        replay.  Neither call is counted (:mod:`build`)."""
        if self._ready:
            return
        with build.uncounted(), self._on_stream():
            self._batch.zero_()
            self._forward()
            if self.capture:
                before = build.counts()
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(graph, stream=self.stream):  # its own memory pool
                    self._forward()
                self.launches = {k: v - before[k] for k, v in build.counts().items() if v != before[k]}
                graph.instantiate()
                self.graph = graph
                self.captures += 1
        if self.stream is not None:
            self.stream.synchronize()
        self._ready = True

    @property
    def inputs(self) -> tuple:
        """The device views the step reads: ``(tokens [S, C], pos [S], lens
        [S] or None, table [S, n_blocks])``; they hold the last step's batch
        until the next step stages its own."""
        return self._args

    @torch.inference_mode()
    def run(self, tokens: np.ndarray, pos: np.ndarray, lens: np.ndarray,
            table: np.ndarray, launched=None) -> np.ndarray:
        """One step in two stages: the launch (the batch staged and copied,
        the graph replayed or the step called, the logits' host copy, all
        enqueued on the program's stream), then the wait for the stream.
        ``launched`` (tracing's split of the host's dispatch from the
        device's wait) is called with no argument between the two; None
        adds nothing to the step.  Returns the logits ``[S, V]`` as a view
        of the host buffer, valid until the next step.  A failed replay
        raises."""
        self.launch(tokens, pos, lens, table)
        if launched is not None:
            launched()
        return self.wait()

    @torch.inference_mode()
    def launch(self, tokens: np.ndarray, pos: np.ndarray, lens: np.ndarray, table: np.ndarray) -> None:
        """The first stage of :meth:`run`: stage the batch and enqueue the
        step and the logits' host copy on the program's stream (a mesh
        engine launches every replica before it waits for any)."""
        self.prepare()
        for sl, a in zip(self._slices, (table, tokens, pos, lens)):
            if sl.stop > sl.start:
                self._stage_np[sl] = a.reshape(-1)
        with self._on_stream():
            self._batch.copy_(self._stage, non_blocking=True)
            if self.graph is not None:
                self.graph.replay()
                build.replayed(self.launches)
            else:
                self._forward()
            self._host.copy_(self.logits, non_blocking=True)

    def wait(self) -> np.ndarray:
        """The second stage of :meth:`run`: wait for the stream; the logits
        as a view of the host buffer."""
        if self.stream is not None:
            self.stream.synchronize()
        return self._host_np

    def close(self) -> None:
        """Release the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self._ready = False




@dataclasses.dataclass
class _Replica:
    """One data-parallel replica's serving state: its own page pool, block
    table, scheduler (waiting queue and active slots), device state (one
    state dict, or its ranks' under ``mp > 1``) and step program."""

    index: int
    allocator: PageAllocator  # possibly chaos-wrapped; the injector is shared
    block_table: BlockTable
    scheduler: Scheduler
    state: dict | list | None = None
    program: StepProgram | None = None
    idle: int = 0  # consecutive stalled ticks (the replica watchdog's clock)
    quarantined_until: float | None = None  # the tick the replica re-enters

    @property
    def quarantined(self) -> bool:
        return self.quarantined_until is not None


def _tensors(tree) -> list:
    """The tensors of a state tree (dicts and lists), in a fixed order."""
    out = []
    T.map_leaves(tree, out.append)
    return out


class Engine:
    """Request-level serving engine: ``submit()`` prompts, ``run()`` to completion."""

    def __init__(self, cfg: T.ModelConfig, params: dict, ecfg: EngineConfig = EngineConfig(),
                 head=None, *, device: str | torch.device = "cuda", capture: bool | None = None,
                 shard_params=None, devices=None):
        """``head`` injects prepacked LM-head weights (with ``mp > 1`` the
        ranks' vocab slices: a list, or ``[mp]``-stacked); otherwise
        ``ecfg.packed_head`` prepacks the tied embedding at
        ``ecfg.head_bits`` here.  ``params`` must already lie on ``device``.
        ``capture``: run the step as one captured CUDA graph (None: on a
        CUDA device); False runs it eagerly, True on the CPU raises.  The
        encdec and hybrid families raise, as the reference's engine does:
        they decode through the fixed-batch loop.

        With ``ecfg.mesh.mp > 1``, ``params`` are float or int8-dict weights
        that the engine slices per rank, or ``shard_params`` holds the
        ranks' trees already sliced and packed (a list, or ``[mp]``-stacked;
        :func:`repro_torch.serving.api.build_engine` makes them, the
        recommended front door).  ``devices`` places the ``dp x mp`` ranks
        (:func:`~repro_torch.launch.mesh.make_mesh`); by default every
        replica runs on ``device`` when ``mp == 1``, and a mesh with
        ``mp > 1`` takes one rank per visible device."""
        T._check_paged(cfg)
        if ecfg.chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        if ecfg.max_step_retries < 0 or ecfg.max_request_retries < 0:
            raise ValueError("retry budgets must be >= 0")
        if ecfg.obs.attrib_every < 0 or ecfg.obs.trace_checkpoint_every < 0:
            raise ValueError("attrib_every/trace_checkpoint_every must be >= 0")
        if ecfg.obs.attrib_reps < 1:
            raise ValueError("attrib_reps must be >= 1")
        check_gather_backend(ecfg.gather_backend)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.dp, self.mp = ecfg.mesh.dp, ecfg.mesh.mp
        if self.mp > 1 and cfg.kv_dtype == "int8" and cfg.family == "attn":
            raise NotImplementedError(
                "int8 KV pools carry one scale per page row over the full "
                "kv-head dim; a model-parallel slice would change every "
                "scale.  Serve int8 KV with mp=1 or switch kv_dtype."
            )
        if ecfg.obs.attrib_every > 0 and self.mp > 1:
            raise ValueError(
                "in-situ attribution re-executes the step single-shard; it "
                "is not supported with model parallelism (mesh.mp > 1) — "
                "set attrib_every=0"
            )
        if devices is None and self.mp == 1:
            devices = [self.device] * self.dp
        self.mesh = make_mesh(self.dp, self.mp, devices, device_type=self.device.type)
        self._chaos = ChaosInjector(ecfg.chaos) if ecfg.chaos.enabled else None
        self.replicas: list[_Replica] = []
        for r in range(self.dp):
            allocator = PageAllocator(ecfg.pool_pages())
            if self._chaos is not None:
                allocator = self._chaos.wrap_allocator(allocator)
            table = BlockTable(ecfg.n_slots, ecfg.blocks_per_slot)
            sched = Scheduler(ecfg.n_slots, allocator, table, ecfg.page_size, policy=ecfg.policy,
                              admit=ecfg.admit)
            self.replicas.append(_Replica(r, allocator, table, sched))
        # replica 0's: the single-replica names every caller already holds
        self.allocator = self.replicas[0].allocator
        self.block_table = self.replicas[0].block_table
        self.scheduler = self.replicas[0].scheduler
        self._rr = 0  # round-robin request -> replica routing cursor
        self.replica_quarantines = 0
        # -- params and head: whole, or the ranks' shards when mp > 1
        self._local_cfg = cfg if self.mp == 1 else dataclasses.replace(cfg, tp_shards=self.mp)
        if self.mp == 1:
            if head is None and ecfg.packed_head:
                head = prepack_lm_head(params["embed"], w_bits=ecfg.head_bits[0], a_bits=ecfg.head_bits[1],
                                       device=self.device)
            self._head = head
            # the per-layer list form, sliced once instead of on every step
            self.params = T.unstack_layers(params, cfg.n_layers)
            self._weights = [self.params]
            self._heads = [head]
        else:
            from repro_torch.core.quant import weight_tanh_max
            from repro_torch.parallel.sharding import slice_decode_params, unstack_decode_shards

            if shard_params is None:
                shard_params = [slice_decode_params(params, cfg, self.mp, r) for r in range(self.mp)]
            shards = unstack_decode_shards(shard_params, self.mp)
            if head is None and ecfg.packed_head:
                emb = params["embed"]
                vs = emb.shape[0] // self.mp
                t_max = weight_tanh_max(emb)
                head = [prepack_lm_head(emb[r * vs:(r + 1) * vs], w_bits=ecfg.head_bits[0],
                                        a_bits=ecfg.head_bits[1], t_max=t_max, device=self.device)
                        for r in range(self.mp)]
            self._weights = [T.unstack_layers(sh, cfg.n_layers) for sh in shards]
            self._heads = [None] * self.mp if head is None else unstack_decode_shards(head, self.mp)
            self.params = self._weights  # the ranks' trees
            self._head = head
        self._placed: dict = {}
        for rep in self.replicas:
            devs = self.mesh.replica_devices(rep.index)
            states = [T.init_paged_state(self._local_cfg, ecfg.n_slots, ecfg.pool_pages(), ecfg.page_size,
                                         dtype=cfg.dtype, device=dv) for dv in devs]
            rep.state = states[0] if self.mp == 1 else states
        self._ckpt = None
        if ecfg.snapshot_every > 0:
            from repro_torch.checkpoint import CheckpointManager

            snap_dir = ecfg.snapshot_dir or tempfile.mkdtemp(prefix="engine-snap-")
            self._ckpt = CheckpointManager(snap_dir, keep=2)
        capture = self.device.type == "cuda" if capture is None else capture
        for rep in self.replicas:
            rep.program = self._build_step(rep, capture)
        self._program = self.replicas[0].program
        self._pending: list[Request] = []  # sorted by arrival
        self._next_rid = 0
        self.n_steps = 0
        self.ticks = 0  # run()-loop iterations
        self.slot_token_steps = 0
        self.fed_tokens = 0  # valid token lanes summed over steps
        self.finished: list[Request] = []  # in the order they became terminal
        self.step_retries = 0  # step attempts lost to injected faults
        self.hard_recoveries = 0  # state restores after hard step faults
        self.fault_log: list[str] = []  # one line per recovered hard fault
        self.step_seconds: list[float] = []
        self._step_time_ewma: float | None = None  # realtime deadline estimator
        # called as on_sample(rid, t, row) with every logits row sampled for
        # request rid's token t (a finite row); row is a view into the step's
        # host logits
        self.on_sample = None
        self._realtime = True
        self._vclock = 0.0
        self._t_wall0: float | None = None  # run() start (monotonic)
        self._t_run_end: float | None = None  # elapsed, frozen when run() returns
        # -- observability: every hook is one `is not None` test while off
        self._trace: TraceRecorder | None = None  # armed by run(trace=...)
        self._trace_path = None
        self.registry = MetricsRegistry()
        self._win_tokens = WindowedSeries()
        self._win_steps = WindowedSeries()
        self._win_sheds = WindowedSeries()
        self._win_preempts = WindowedSeries()
        self._attrib: LayerAttributor | None = None
        if ecfg.obs.attrib_every > 0:
            # with dp > 1 (mp == 1) replica 0's step is sampled
            self._attrib = LayerAttributor(cfg, self.params, head=self._head, reps=ecfg.obs.attrib_reps,
                                           registry=self.registry, gather=ecfg.gather_backend,
                                           device=self.mesh.device(0, 0))

    @property
    def state(self):
        """Replica 0's device state (the single-replica name); a step
        program holds the tensors it was built on, so rebinding this
        reaches the resets and restores, never the step."""
        return self.replicas[0].state

    @state.setter
    def state(self, value) -> None:
        self.replicas[0].state = value

    # -- construction helpers ---------------------------------------------------

    def _on(self, rank: int, device: torch.device):
        """Rank ``rank``'s weights and head on ``device``: the engine's own
        where they already lie there, else copies made once per device."""
        key = (rank, device)
        if key not in self._placed:
            move = lambda a: a.to(device)  # noqa: E731 (no copy when already there)
            head = self._heads[rank]
            self._placed[key] = (T.map_leaves(self._weights[rank], move),
                                 None if head is None else head.to(device))
        return self._placed[key]

    def _build_step(self, rep: _Replica, capture: bool) -> StepProgram:
        """Replica ``rep``'s step program: :func:`forward_decode_paged` (or,
        with ``mp > 1``, :func:`forward_decode_paged_tp` over its ranks)
        over static buffers, the replica's state updated in place (the
        reference's donated state).  ``lens`` reaches the model only at
        ``C > 1``, as in the reference, so the C = 1 step is the plain
        decode step.  A replica whose ranks sit on several devices runs
        eagerly: one CUDA graph cannot span devices."""
        devs = self.mesh.replica_devices(rep.index)
        gather, state = self.ecfg.gather_backend, rep.state
        if self.mp == 1:
            cfg = self.cfg
            params, head = self._on(0, devs[0])

            def step(tokens, pos, lens, table):
                logits, _ = T.forward_decode_paged(params, cfg, state, table, tokens, pos, head=head,
                                                   lens=lens, gather=gather)
                return logits
        else:
            cfg = self._local_cfg
            placed = [self._on(r, dv) for r, dv in enumerate(devs)]
            shards = [p for p, _ in placed]
            heads = None if placed[0][1] is None else [h for _, h in placed]
            capture = capture and all(dv == devs[0] for dv in devs)

            def step(tokens, pos, lens, table):
                logits, _ = T.forward_decode_paged_tp(shards, cfg, state, table, tokens, pos, heads=heads,
                                                      lens=lens, gather=gather)
                return logits

        return StepProgram(step, n_slots=self.ecfg.n_slots, chunk=self.ecfg.chunk_tokens,
                           n_blocks=self.ecfg.blocks_per_slot, vocab=self.cfg.vocab, device=devs[0],
                           capture=capture)

    def _reset_slot(self, slot: int, replica: int = 0) -> None:
        """Zero one slot's recurrent (SSM) state on (re-)admission, in place
        and outside the step's graph (on every rank of the replica): the
        next step's stream waits for the writes
        (:meth:`StepProgram._on_stream`), and the graph, captured on the
        same buffers, is never captured again.  Other families keep no such
        state: nothing to do."""
        state = self.replicas[replica].state
        for st in (state if self.mp > 1 else [state]):
            T.reset_paged_slot(self._local_cfg, st, slot)

    def _states_tree(self):
        """The device state a snapshot saves: the state dict of a
        single-device engine, else every replica's."""
        if self.dp == 1 and self.mp == 1:
            return self.state
        return [rep.state for rep in self.replicas]

    def _live_replicas(self) -> list[_Replica]:
        return [r for r in self.replicas if not r.quarantined]

    def _any_active(self) -> bool:
        return any(rep.scheduler.active for rep in self.replicas)

    def _all_done(self) -> bool:
        return all(rep.scheduler.all_done() for rep in self.replicas)

    def _active_items(self):
        """(replica, slot, request) triples over every replica's batch."""
        for rep in self.replicas:
            for slot, req in rep.scheduler.active.items():
                yield rep, slot, req

    def warmup(self) -> None:
        """Prepare every replica's step program (:meth:`StepProgram.prepare`:
        one eager step with every slot inactive, then the capture on the
        card), so kernel builds, first-call costs and the captures stay out
        of the timed run.  ``run`` prepares them before its clock starts
        otherwise."""
        for rep in self.replicas:
            rep.program.prepare()

    def close(self) -> None:
        """Release the steps' CUDA graphs and their memory pools."""
        for rep in self.replicas:
            rep.program.close()

    def submit(self, prompt, max_new_tokens: int, arrival: float = 0.0, *,
               deadline: float | None = None, ttft_deadline: float | None = None,
               slo: SLO | None = None) -> Request:
        """Queue a request.  ``deadline``/``ttft_deadline`` are absolute
        engine-clock times; an :class:`SLO` instead carries relative
        budgets resolved against ``arrival`` (explicit deadlines win)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.ecfg.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) exceeds max_len {self.ecfg.max_len}"
            )
        slo_name = None
        if slo is not None:
            slo_ttft, slo_total = slo.resolve(arrival)
            ttft_deadline = ttft_deadline if ttft_deadline is not None else slo_ttft
            deadline = deadline if deadline is not None else slo_total
            slo_name = slo.name
        req = Request(self._next_rid, prompt, max_new_tokens, arrival=arrival, deadline=deadline,
                      ttft_deadline=ttft_deadline, slo=slo_name)
        self._next_rid += 1
        self._pending.append(req)
        self._pending.sort(key=lambda r: r.arrival)
        if self._trace is not None:
            self._trace_attach(req)
        return req

    def cancel(self, req: Request) -> bool:
        """Request cooperative cancellation.  Returns False if the request
        already carries a terminal status; otherwise it is finalized
        ``cancelled`` (slot and pages reclaimed, partial output kept) at the
        next between-steps policing pass."""
        if req.status is not None:
            return False
        req.cancel()
        return True

    # -- tracing --------------------------------------------------------------

    def _trace_attach(self, req: Request) -> None:
        """Open the request's envelope and ``queued`` phase spans (idempotent,
        so arming a recorder after submissions begins nothing twice)."""
        self._trace.req_begin(req.rid, prompt_tokens=len(req.prompt), max_new_tokens=req.max_new_tokens,
                              arrival=req.arrival, slo=req.slo)
        if self._trace.phase(req.rid) is None:
            self._trace.req_phase(req.rid, "queued")

    def _arm_trace(self, trace) -> None:
        """``trace`` is a :class:`TraceRecorder`, or a path to save a fresh
        one to at the end of ``run()``.  Requests already submitted
        (pending, waiting, or resident from an earlier run) are attached."""
        if isinstance(trace, TraceRecorder):
            self._trace, self._trace_path = trace, None
        else:
            self._trace, self._trace_path = TraceRecorder(), trace
        for req in self._pending:
            self._trace_attach(req)
        for rep in self.replicas:
            for req in rep.scheduler.waiting:
                self._trace_attach(req)
            for req in rep.scheduler.active.values():
                self._trace_attach(req)
                self._trace.req_phase(req.rid, "prefill", slot=req.slot)
        if self._chaos is not None:
            self._chaos.trace = self._trace

    def _seal_trace(self) -> None:
        """Stamp the run's metadata into the recorder (the block the trace
        gate reconciles the events with), and save it when run() owns the
        file."""
        tr = self._trace
        m = self.metrics()
        tr.metadata.update(
            arch=self.cfg.name, family=self.cfg.family, policy=self.ecfg.policy, admit=self.ecfg.admit,
            chunk_tokens=self.ecfg.chunk_tokens, realtime=self._realtime, steps=self.n_steps,
            n_requests=len(self.finished), statuses=m["statuses"], injected=m["injected"],
            preemptions=m["preemptions"], step_retries=self.step_retries,
            chaos_seed=self._chaos.cfg.seed if self._chaos is not None else None, dp=self.dp, mp=self.mp,
        )
        if self._trace_path is not None:
            tr.save(self._trace_path)

    def _emit_attrib_spans(self, sample: dict, t0: float, t1: float) -> None:
        """Child spans under ``device_wait`` on the attribution track: the
        step's device interval cut in proportion to the measured shares."""
        tr = self._trace
        span = max(t1 - t0, 0.0)
        acc = t0
        for row in sample["layers"]:
            frac = row["share"] or 0.0
            dt = span * frac
            tr.complete(f"layer{row['index']:02d} {row['pair']}", acc, acc + dt, tid=ATTRIB_TID,
                        step=sample["step"], share=frac, seconds=row["seconds"])
            acc += dt

    def _emit_counter_tracks(self, tr: TraceRecorder) -> None:
        """One sample a step on each counter track: pool pressure, slot
        occupancy, windowed throughput and the monotone fault counters
        (summed over the replicas)."""
        window = 5.0 if self._realtime else 32.0
        tps = self._win_tokens.rate(self._elapsed(), window)
        tr.counter("pages", free=sum(r.allocator.n_free for r in self.replicas))
        tr.counter("slots", active=sum(len(r.scheduler.active) for r in self.replicas),
                   waiting=sum(len(r.scheduler.waiting) for r in self.replicas) + len(self._pending))
        tr.counter("tokens_per_s_window", tokens_per_s=tps or 0.0)
        tr.counter("preemptions_total", preemptions=self.preemptions)
        tr.counter("shed_total", shed=self.registry.counter("repro_requests_total").value(status="shed"))

    # -- lifecycle policing: host bookkeeping only, no device work ------------

    def _route_replica(self) -> _Replica:
        """Round-robin over the live (not quarantined) replicas: the
        deterministic request -> replica assignment."""
        pool = self._live_replicas() or self.replicas
        rep = pool[self._rr % len(pool)]
        self._rr += 1
        return rep

    def _admit(self, now: float) -> None:
        while self._pending and self._pending[0].arrival <= now:
            req = self._pending.pop(0)
            rep = self._route_replica()
            req.replica = rep.index
            rep.scheduler.submit(req)
        for rep in self.replicas:
            if rep.quarantined:
                continue
            for req in rep.scheduler.admit(now):
                # a (re-)admitted SSM request rebuilds its state from position 0
                if self.dp == 1:
                    self._reset_slot(req.slot)
                else:
                    self._reset_slot(req.slot, rep.index)
                if self._trace is not None:
                    self._trace.req_phase(req.rid, "prefill", slot=req.slot, replayed=req.n_preempted > 0)

    def _finalize(self, req: Request, status: str, now: float, reason: str | None = None) -> None:
        """Move a request to its terminal status exactly once, reclaiming
        its slot and pages through its replica's scheduler if it is
        resident."""
        assert req.status is None, f"rid {req.rid} already terminal ({req.status})"
        assert status in TERMINAL_STATUSES, status
        if req.slot != -1:
            self.replicas[req.replica].scheduler.finish(req, now)
        else:
            req.t_finish = now
        req.status = status
        if reason is not None:
            req.shed_reason = reason
        self.finished.append(req)
        self.registry.counter("repro_requests_total", "requests by terminal status").inc(status=status)
        if status == "shed":
            self._win_sheds.add(now)
        if self._trace is not None:
            self._trace.req_end(req.rid, status, reason=reason, out_tokens=len(req.out_tokens))

    def _est_service_time(self, req: Request) -> float | None:
        """Optimistic remaining service time on the engine clock, or None
        before the first realtime step (no step-time estimate yet)."""
        per_step = 1.0 if not self._realtime else self._step_time_ewma
        if per_step is None:
            return None
        return req.min_steps_left(self.ecfg.chunk_tokens) * per_step

    def _expired_reason(self, req: Request, now: float) -> str | None:
        if req.deadline is not None and now >= req.deadline and not req.done:
            return "deadline"
        if req.ttft_deadline is not None and req.t_first_token is None and now >= req.ttft_deadline:
            return "ttft"
        return None

    def _slack(self, req: Request, now: float) -> float:
        """Deadline slack under the optimistic service estimate; +inf for a
        request without a deadline."""
        if req.deadline is None:
            return float("inf")
        est = self._est_service_time(req)
        return req.deadline - now - (est if est is not None else 0.0)

    def _police(self, now: float) -> None:
        """Between-steps lifecycle pass, on every replica: cooperative
        cancellation, deadline expiry and infeasibility shedding, and
        bounded-queue backpressure (``max_waiting`` a replica)."""
        for req in [r for r in self._pending if r.cancel_requested]:
            self._pending.remove(req)
            self._finalize(req, "cancelled", now)
        for rep in self.replicas:
            sched = rep.scheduler
            for req in [r for r in sched.waiting if r.cancel_requested]:
                sched.remove_waiting(req)
                self._finalize(req, "cancelled", now)
            for req in [r for r in sched.active.values() if r.cancel_requested]:
                self._finalize(req, "cancelled", now)
            # active requests past a deadline are dropped mid-decode: their
            # pages fund work that can still meet its deadline
            for req in list(sched.active.values()):
                reason = self._expired_reason(req, now)
                if reason is not None:
                    self._finalize(req, "shed", now, reason=reason)
            for req in list(sched.waiting):
                reason = self._expired_reason(req, now)
                if reason is None and req.deadline is not None:
                    est = self._est_service_time(req)
                    if est is not None and now + est > req.deadline:
                        reason = "infeasible"
                if reason is not None:
                    sched.remove_waiting(req)
                    self._finalize(req, "shed", now, reason=reason)
            if self.ecfg.max_waiting:
                while len(sched.waiting) > self.ecfg.max_waiting:
                    victim = min(sched.waiting, key=lambda r: (self._slack(r, now), -r.arrival, -r.rid))
                    sched.remove_waiting(victim)
                    self._finalize(victim, "shed", now, reason="queue-overflow")

    # -- faults: host bookkeeping, and the state restored in place ------------

    def _strike(self, req: Request, now: float) -> None:
        """One fault strike against a resident request: preempt it for a
        token-identical replay and quarantine its slot; past
        ``max_request_retries`` strikes it ends ``failed`` instead."""
        sched = self.replicas[req.replica].scheduler
        slot = req.slot
        req.n_faults += 1
        sched.preempt(req, now)
        sched.quarantine_slot(slot, self.ticks + self.ecfg.quarantine_ticks)
        self._win_preempts.add(now)
        if self._trace is not None:
            self._trace.req_event(req.rid, "fault_strike", n_faults=req.n_faults)
            self._trace.req_event(req.rid, "quarantine", slot=slot,
                                  until_tick=self.ticks + self.ecfg.quarantine_ticks)
            self._trace.req_phase(req.rid, "queued", reason="fault")
        if req.n_faults > self.ecfg.max_request_retries:
            sched.remove_waiting(req)
            self._finalize(req, "failed", now)

    def _pick_victim(self) -> Request:
        """The lowest-progress active request over every replica (ties: the
        youngest rid), the global twin of ``Scheduler.pick_victim``."""
        return min((req for _, _, req in self._active_items()), key=lambda r: (r.n_fed, -r.rid))

    def _device_failed(self, exc: Exception) -> bool:
        """Whether a step's exception is the device's: a kernel library's
        own error, or any fault after which a device of the mesh no longer
        synchronises (a sticky CUDA error).  Those are never recovered."""
        if isinstance(exc, build.KernelError):
            return True
        for dev in dict.fromkeys(self.mesh.devices):
            if dev.type != "cuda":
                continue
            try:
                torch.cuda.synchronize(dev)
            except RuntimeError as err:
                exc.add_note(f"the device probe after the fault failed: {err}")
                return True
        return False

    def _recover_hard_fault(self, exc: Exception, now: float) -> None:
        """A hard fault escaped the step, whose state writes can no longer
        be trusted: strike every resident request and restore the state.
        The replays rewrite every resident row, so the result does not
        depend on the snapshot's age."""
        self.hard_recoveries += 1
        self.fault_log.append(f"step {self.n_steps}: {type(exc).__name__}: {exc}")
        for _, _, req in list(self._active_items()):
            self._strike(req, now)
        self._restore_state()

    def _restore_state(self) -> None:
        """Write the latest snapshot (after the writer is done), or zeros,
        into every replica's state tensors in place: the steps' graphs and
        closures hold these tensors, so they must never be rebound."""
        tree = self._states_tree()
        snap = None
        if self._ckpt is not None:
            self._ckpt.wait()
            if self._ckpt.latest_step() is not None:
                _, snap = self._ckpt.restore(tree)
        if snap is None:
            for t in _tensors(tree):
                t.zero_()
            return
        for t, src in zip(_tensors(tree), _tensors(snap)):
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(f"a snapshot leaf is {src.dtype}{tuple(src.shape)}, the state's "
                                 f"{t.dtype}{tuple(t.shape)}")
            t.copy_(src)

    def _snapshot(self) -> None:
        """Save the state (copied to the host now, on the first replica's
        stream, after every replica's step has ended; written to disk in the
        background)."""
        with self._program._on_stream():
            self._ckpt.save_async(self.n_steps, self._states_tree())

    def _fund_pages(self, now: float) -> None:
        """On-demand admission: before the step, grow every active slot's
        page list to cover its chunk, each replica from its own pool.
        Slots are funded in descending progress; when a pool runs dry its
        lowest-progress slot is preempted (its pages freed for the rest),
        possibly the requester itself, which then leaves the batch and
        replays later.  The highest-progress slot can always be funded
        (``submit`` bounds every request by the pool), so each step advances
        at least one request a replica."""
        C = self.ecfg.chunk_tokens
        for rep in self.replicas:
            sched = rep.scheduler
            for req in sorted(sched.active.values(), key=lambda r: (-r.n_fed, r.rid)):
                if req.slot == -1:
                    continue  # already preempted as someone else's victim
                last_pos = req.n_fed + req.n_feed(C) - 1
                while not sched.ensure_pages(req, last_pos):
                    victim = sched.pick_victim()
                    sched.preempt(victim)
                    self._win_preempts.add(now)
                    if self._trace is not None:
                        self._trace.req_event(victim.rid, "preempt", reason="pages")
                        self._trace.req_phase(victim.rid, "queued", reason="preempt")
                    if victim is req:
                        break

    def _dispatch(self, tokens, pos, lens, tables, launched=None) -> list:
        """Every replica's step: one program's :meth:`StepProgram.run`, or
        every replica's launch before any wait.  Returns each replica's
        logits ``[S, V]`` (views of the programs' host buffers)."""
        if self.dp == 1:
            if launched is None:
                return [self._program.run(tokens[0], pos[0], lens[0], tables[0])]
            return [self._program.run(tokens[0], pos[0], lens[0], tables[0], launched)]
        for rep in self.replicas:
            i = rep.index
            rep.program.launch(tokens[i], pos[i], lens[i], tables[i])
        if launched is not None:
            launched()
        return [rep.program.wait() for rep in self.replicas]

    def _step_once(self, now_fn) -> bool:
        """Fund (on-demand), step every replica and sample once; False when
        no step completed: funding preempted every slot, injected faults
        used up the retries, or a hard fault was recovered."""
        R, S, C = self.dp, self.ecfg.n_slots, self.ecfg.chunk_tokens
        if self.ecfg.admit == "on-demand":
            self._fund_pages(now_fn())
            if not self._any_active():
                return False  # everything preempted; admission retries next loop
        tokens = np.zeros((R, S, C), np.int32)
        pos = np.zeros((R, S), np.int32)
        lens = np.zeros((R, S), np.int32)
        for rep, slot, req in self._active_items():
            chunk, start = req.next_chunk(C)
            tokens[rep.index, slot, : len(chunk)] = chunk
            pos[rep.index, slot] = start
            lens[rep.index, slot] = len(chunk)
        tables = [rep.block_table.as_array() for rep in self.replicas]
        tr = self._trace
        if tr is not None:
            for rep, slot, req in self._active_items():
                if lens[rep.index, slot] and tr.phase(req.rid) == "prefill":
                    tr.req_event(req.rid, "prefill_chunk", start=int(pos[rep.index, slot]),
                                 n=int(lens[rep.index, slot]))
        attrib = self._attrib is not None and (self.n_steps + 1) % self.ecfg.obs.attrib_every == 0
        if attrib:
            # replica 0's pre-step state, copied before the step writes it;
            # injected faults raise before anything is staged, so the copy
            # outlives the retries, and a hard fault drops it
            self._attrib.stage(self.state, self._program.stream)
        t_span = [0.0, 0.0]  # the step's dispatch start and end (tracing only)
        for attempt in range(self.ecfg.max_step_retries + 1):
            try:
                if self._chaos is not None:
                    self._chaos.before_step()  # raises before anything is staged
                if tr is None:
                    logits = self._dispatch(tokens, pos, lens, tables)
                else:
                    t_span[0] = tr.now()
                    logits = self._dispatch(tokens, pos, lens, tables,
                                            lambda: t_span.__setitem__(1, tr.now()))
                break
            except InjectedFault:
                self.step_retries += 1
                if tr is not None:
                    tr.instant("step_retry", attempt=attempt)
                if attempt == self.ecfg.max_step_retries:
                    # the fault outlasted the retries: strike the lowest-progress request
                    self._strike(self._pick_victim(), now_fn())
                    return False
            except Exception as exc:  # a hard fault: the state writes are suspect
                if self._device_failed(exc):
                    raise
                if tr is not None:
                    tr.instant("hard_fault", exc=type(exc).__name__)
                self._recover_hard_fault(exc, now_fn())
                return False
        self.n_steps += 1
        n_active = sum(len(r.scheduler.active) for r in self.replicas)
        self.slot_token_steps += n_active
        self.fed_tokens += int(lens.sum())
        if tr is not None:
            t_wait = tr.now()  # the dispatch returned after the streams' waits
            tr.complete("dispatch", t_span[0], t_span[1], step=self.n_steps)
            tr.complete("device_wait", t_span[1], t_wait, step=self.n_steps)
            tr.complete("step", t_span[0], t_wait, step=self.n_steps, active=n_active, fed=int(lens.sum()))
        if attrib:
            sample = self._attrib.sample(*self._program.inputs, stream=self._program.stream,
                                         step=self.n_steps)
            if tr is not None:
                self._emit_attrib_spans(sample, t_span[1], t_wait)
        if tr is not None:
            self._emit_counter_tracks(tr)
            if (self._trace_path is not None and self.ecfg.obs.trace_checkpoint_every > 0
                    and self.n_steps % self.ecfg.obs.trace_checkpoint_every == 0):
                tr.save(self._trace_path)  # a partial trace a crash leaves behind
        if self._chaos is not None:
            logits = [rows.copy() for rows in logits]  # the programs' host buffers stay clean
            for rep in self.replicas:
                sampling = [s for s, r in rep.scheduler.active.items()
                            if r.n_fed + int(lens[rep.index, s]) >= len(r.seq)]
                self._chaos.poison_logits(logits[rep.index], sampling)
        t = now_fn()
        if self._ckpt is not None and self.n_steps % self.ecfg.snapshot_every == 0:
            self._snapshot()
        n_new = 0
        for rep, slot, req in list(self._active_items()):
            req.n_fed += int(lens[rep.index, slot])
            if req.n_fed < len(req.seq):
                continue  # mid-prompt / mid-replay: logits not sampled
            if tr is not None:
                tr.req_phase(req.rid, "decode", slot=slot)
            row = logits[rep.index][slot]
            if not np.isfinite(row).all():
                # never sample a non-finite row: strike the request, whose
                # replay samples this token again
                self._strike(req, t)
                continue
            if self.on_sample is not None:
                self.on_sample(req.rid, len(req.out_tokens), row)
            if not req.out_tokens:
                req.t_first_token = t
            req.out_tokens.append(int(np.argmax(row)))
            n_new += 1
            if req.done:
                self._finalize(req, "ok", t)
        self._win_steps.add(t)
        if n_new:
            self._win_tokens.add(t, n_new)
        reg = self.registry
        reg.counter("repro_steps_total", "fused engine steps").inc()
        reg.counter("repro_generated_tokens_total", "sampled tokens").inc(n_new)
        reg.counter("repro_fed_tokens_total", "valid token lanes fed").inc(float(lens.sum()))
        return True

    def _replica_watchdog(self) -> None:
        """dp > 1 only: a replica with waiting work and an empty batch while
        a sibling is live is quarantined whole after ``watchdog_ticks``
        stalled ticks, and its waiting queue re-routed to the least-loaded
        live replica, so a wedged pool degrades capacity instead of wedging
        every request routed to it."""
        if self.dp == 1:
            return
        for rep in self.replicas:
            sched = rep.scheduler
            stalled = bool(sched.waiting) and not sched.active and not rep.quarantined
            rep.idle = rep.idle + 1 if stalled else 0
            if rep.idle <= self.ecfg.watchdog_ticks:
                continue
            others = [o for o in self.replicas if o is not rep and not o.quarantined]
            if not others:
                continue  # nowhere to re-route; the global watchdog sheds
            rep.idle = 0
            rep.quarantined_until = self.ticks + self.ecfg.quarantine_ticks
            self.replica_quarantines += 1
            target = min(others, key=lambda o: (len(o.scheduler.active) + len(o.scheduler.waiting), o.index))
            moved = 0
            while sched.waiting:
                req = sched.waiting.popleft()
                req.replica = target.index
                target.scheduler.submit(req)
                moved += 1
            if self._trace is not None:
                self._trace.instant("replica_quarantine", replica=rep.index, until_tick=rep.quarantined_until,
                                    rerouted=moved, target=target.index)

    def run(self, *, realtime: bool = True, max_steps: int | None = None, trace=None) -> dict:
        """Drive the engine until every submitted request reaches a terminal
        status, or until ``max_steps`` steps in all (a later call resumes).

        ``realtime=False`` uses a deterministic virtual clock (1.0 per step;
        idle ticks also advance it, idle gaps jump to the next arrival).
        Each loop iteration polices, then admits, then steps.  The step
        programs are prepared (on the card: captured) before the clock
        starts, so neither the capture nor first-call costs enter the
        step-time estimate that realtime deadlines use.

        ``trace`` arms span recording: a :class:`TraceRecorder` to read in
        process, or a path the run writes Perfetto-loadable Chrome trace
        JSON to when it returns.  An armed recorder stays armed for later
        runs.  None (the default) leaves every tracing hook one test."""
        self._realtime = realtime
        if trace is not None:
            self._arm_trace(trace)
        self.warmup()
        t_wall0 = self._t_wall0 = time.monotonic()
        self._t_run_end = None
        idle = 0

        def now() -> float:
            return (time.monotonic() - t_wall0) if realtime else self._vclock

        while self._pending or not self._all_done():
            if max_steps is not None and self.n_steps >= max_steps:
                break
            self.ticks += 1
            for rep in self.replicas:
                rep.scheduler.release_quarantined(self.ticks)
                if rep.quarantined and self.ticks >= rep.quarantined_until:
                    rep.quarantined_until = None
            self._police(now())
            self._admit(now())
            self._replica_watchdog()
            if not self._any_active():
                if self._pending:
                    # nothing running: wait for (or jump to) the next arrival
                    nxt = self._pending[0].arrival
                    if realtime:
                        time.sleep(min(max(nxt - now(), 0.0), 0.01))
                    else:
                        self._vclock = max(self._vclock, nxt)
                    idle = 0
                    continue
                if self._all_done():
                    continue  # the loop condition exits
                # waiting work but nothing placeable (quarantined slots, a
                # flaky allocator, or a stall): after watchdog_ticks idle
                # ticks the watchdog sheds a head, so run() neither raises
                # nor spins forever
                idle += 1
                if realtime:
                    time.sleep(0.001)
                else:
                    self._vclock += 1.0
                if idle > self.ecfg.watchdog_ticks:
                    for rep in self.replicas:
                        if rep.scheduler.waiting:
                            victim = rep.scheduler.waiting[0]
                            rep.scheduler.remove_waiting(victim)
                            self._finalize(victim, "shed", now(), reason="watchdog")
                            break
                    idle = 0
                continue
            idle = 0
            t0 = time.monotonic()
            stepped = self._step_once(now)
            if realtime:
                dt = time.monotonic() - t0
                if stepped:
                    self.step_seconds.append(dt)
                self.registry.histogram("repro_step_seconds", "fused step wall time").observe(dt)
                ewma = self._step_time_ewma
                self._step_time_ewma = dt if ewma is None else 0.8 * ewma + 0.2 * dt
            else:
                self._vclock += 1.0
        if not self._pending and self._all_done():
            for rep in self.replicas:
                rep.scheduler.release_quarantined(None)
                rep.quarantined_until = None
            if self._ckpt is not None:
                self._ckpt.wait()
            self.assert_no_leaks()
        self._t_run_end = time.monotonic() - t_wall0
        out = self.metrics()
        if self._trace is not None:
            self._seal_trace()
        return out

    @property
    def preemptions(self) -> int:
        return sum(rep.scheduler.n_preemptions for rep in self.replicas)

    def assert_no_leaks(self) -> None:
        """On every replica: every page back on its free list, every slot
        free, the block table cleared; raises AssertionError naming the
        leaking replica otherwise."""
        for rep in self.replicas:
            try:
                rep.allocator.assert_no_leaks()
                rep.scheduler.assert_all_reclaimed()
            except AssertionError as exc:
                if self.dp == 1:
                    raise
                raise AssertionError(f"replica {rep.index}: {exc}") from exc

    def _elapsed(self) -> float:
        """Engine-clock time since run() started: the virtual clock, or wall
        time (frozen once the run returns).  0.0 before any run."""
        if not self._realtime:
            return self._vclock
        if self._t_run_end is not None:
            return self._t_run_end
        if self._t_wall0 is None:
            return 0.0
        return time.monotonic() - self._t_wall0

    def metrics(self) -> dict:
        """End-of-run (or so-far) summary on the engine's own clock.
        Latency counts ``ok`` requests, TTFT every request with a first
        token; an empty percentile is None, never NaN."""
        wall = self._elapsed()
        done = self.finished
        ok = [r for r in done if r.status == "ok"]
        lat = [r.t_finish - r.arrival for r in ok if r.t_finish is not None]
        ttft = [r.t_first_token - r.arrival for r in done if r.t_first_token is not None]
        gen = sum(len(r.out_tokens) for r in done)
        return {
            "engine": self.ecfg.policy,
            "admit": self.ecfg.admit,
            "chunk_tokens": self.ecfg.chunk_tokens,
            "dp": self.dp,
            "mp": self.mp,
            "n_requests": len(done),
            "n_ok": len(ok),
            "statuses": dict(Counter(r.status for r in done)),
            "generated_tokens": gen,
            "generated_tokens_ok": sum(len(r.out_tokens) for r in ok),
            "prompt_tokens": sum(len(r.prompt) for r in done),
            "fed_tokens": self.fed_tokens,
            "preemptions": self.preemptions,
            "quarantines": sum(r.scheduler.n_quarantines for r in self.replicas),
            "replica_quarantines": self.replica_quarantines,
            "step_retries": self.step_retries,
            "hard_recoveries": self.hard_recoveries,
            "injected": (self._chaos.counters() if self._chaos is not None
                         else {"step": 0, "alloc": 0, "nan": 0}),
            "steps": self.n_steps,
            "wall": wall,
            "tokens_per_s": gen / wall if wall > 0 else None,
            "step_s_p50": percentile(self.step_seconds, 50),
            "latency_p50": percentile(lat, 50),
            "latency_p99": percentile(lat, 99),
            "ttft_p50": percentile(ttft, 50),
            "ttft_p99": percentile(ttft, 99),
            "slot_occupancy": (self.slot_token_steps / (self.n_steps * self.ecfg.n_slots * self.dp)
                               if self.n_steps else 0.0),
        }

    def live_metrics(self, window: float | None = None) -> dict:
        """A trailing-window snapshot, callable mid-run (between ``run(max_steps=k)``
        slices): unlike :meth:`metrics`, the rates cover only the last
        ``window`` engine-clock units (default 5 s wall, 32 virtual steps)."""
        if window is None:
            window = 5.0 if self._realtime else 32.0
        now = self._elapsed()
        n_active = sum(len(r.scheduler.active) for r in self.replicas)
        n_waiting = sum(len(r.scheduler.waiting) for r in self.replicas)
        return {
            "now": now,
            "window": window,
            "tokens_per_s_window": self._win_tokens.rate(now, window),
            "steps_per_s_window": self._win_steps.rate(now, window),
            "shed_rate_window": self._win_sheds.rate(now, window),
            "preemption_rate_window": self._win_preempts.rate(now, window),
            "queue_depth": len(self._pending) + n_waiting,
            "active_slots": n_active,
            "slot_occupancy": n_active / (self.ecfg.n_slots * self.dp),
            "free_pages": sum(r.allocator.n_free for r in self.replicas),
            "steps": self.n_steps,
            "statuses": dict(Counter(r.status for r in self.finished)),
        }

    def prometheus_text(self) -> str:
        """Prometheus text exposition of :attr:`registry`, its point-in-time
        gauges refreshed at the scrape."""
        reg = self.registry
        reg.gauge("repro_queue_depth", "pending + waiting requests").set(
            len(self._pending) + sum(len(r.scheduler.waiting) for r in self.replicas))
        reg.gauge("repro_active_slots", "slots decoding/prefilling").set(
            sum(len(r.scheduler.active) for r in self.replicas))
        reg.gauge("repro_free_pages", "page-pool headroom").set(sum(r.allocator.n_free for r in self.replicas))
        reg.gauge("repro_preemptions", "scheduler preemptions so far").set(self.preemptions)
        return reg.prometheus_text()
