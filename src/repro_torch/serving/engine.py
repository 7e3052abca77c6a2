"""Continuous-batching decode engine (``repro.serving.engine``), one replica.

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

Not ported yet, and refused where asked for: int8 KV pools, deadlines
and cancellation, fault injection, snapshots, observability and mesh
parallelism (see ROADMAP.md, port queue).
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_gather.ops import check_gather_backend
from repro_torch.models import transformer as T
from repro_torch.models.layers import prepack_lm_head
from repro_torch.serving.lifecycle import Request
from repro_torch.serving.paged_kv import BlockTable, PageAllocator
from repro_torch.serving.scheduler import Scheduler


def percentile(xs, q: float) -> float | None:
    """``float(np.percentile(xs, q))``, or None for an empty sample."""
    xs = list(xs)
    return float(np.percentile(xs, q)) if xs else None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 8
    page_size: int = 16
    max_len: int = 128  # per-sequence cap: prompt + generated tokens
    n_pages: int = 0  # page-pool budget; 0 => every slot can hold max_len
    chunk_tokens: int = 1
    admit: str = "reserve"
    packed_head: bool = False
    head_bits: tuple[int, int] = (8, 8)
    gather_backend: str = "xla"  # "xla": pool[block_table]; "kernel": CUDA gather

    @property
    def blocks_per_slot(self) -> int:
        return -(-self.max_len // self.page_size)

    def pool_pages(self) -> int:
        return self.n_pages or self.n_slots * self.blocks_per_slot + 1


class Engine:
    """Request-level serving engine: ``submit()`` prompts, ``run()`` to completion."""

    def __init__(self, cfg: T.ModelConfig, params: dict, ecfg: EngineConfig = EngineConfig(),
                 head=None, *, device: str | torch.device = "cuda"):
        """``head`` injects prepacked LM-head weights; otherwise
        ``ecfg.packed_head`` prepacks the tied embedding at
        ``ecfg.head_bits`` here.  ``params`` must already lie on ``device``."""
        if ecfg.chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        if cfg.kv_dtype == "int8":
            raise NotImplementedError("int8 KV pools in the engine come in a later slice")
        check_gather_backend(ecfg.gather_backend)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.allocator = PageAllocator(ecfg.pool_pages())
        self.block_table = BlockTable(ecfg.n_slots, ecfg.blocks_per_slot)
        self.scheduler = Scheduler(ecfg.n_slots, self.allocator, self.block_table, ecfg.page_size,
                                   admit=ecfg.admit)
        if head is None and ecfg.packed_head:
            head = prepack_lm_head(params["embed"], w_bits=ecfg.head_bits[0],
                                   a_bits=ecfg.head_bits[1], device=self.device)
        self._head = head
        # the per-layer list form, sliced once instead of on every step
        self.params = T.unstack_layers(params, cfg.n_layers)
        self.state = T.init_paged_state(cfg, ecfg.n_slots, ecfg.pool_pages(), ecfg.page_size,
                                        dtype=cfg.dtype, device=self.device)
        self._pending: list[Request] = []
        self._next_rid = 0
        self.n_steps = 0
        self.slot_token_steps = 0
        self.fed_tokens = 0  # valid token lanes summed over steps
        self.finished: list[Request] = []
        self.step_seconds: list[float] = []
        # called as on_sample(rid, t, row) with every logits row sampled for
        # request rid's token t; row is a view into the step's host logits
        self.on_sample = None
        self._realtime = True
        self._vclock = 0.0
        self._wall = 0.0

    @torch.inference_mode()
    def _step(self, tokens: np.ndarray, pos: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        """One fused step; ``lens`` reaches the model only at ``C > 1``, as
        in the reference, so the C = 1 step is the plain decode step."""
        dev = self.device
        logits, self.state = T.forward_decode_paged(
            self.params, self.cfg, self.state,
            torch.from_numpy(self.block_table.as_array()).to(dev),
            torch.from_numpy(tokens).to(dev), torch.from_numpy(pos).to(dev),
            head=self._head,
            lens=torch.from_numpy(lens).to(dev) if self.ecfg.chunk_tokens > 1 else None,
            gather=self.ecfg.gather_backend,
        )
        return logits

    def warmup(self) -> None:
        """Run one step with every slot inactive (rows land on null page 0),
        so kernel builds and first-call costs stay out of the timed run."""
        S, C = self.ecfg.n_slots, self.ecfg.chunk_tokens
        self._step(np.zeros((S, C), np.int32), np.zeros((S,), np.int32),
                   np.zeros((S,), np.int32)).cpu()

    def submit(self, prompt, max_new_tokens: int, arrival: float = 0.0) -> Request:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.ecfg.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) exceeds max_len {self.ecfg.max_len}"
            )
        req = Request(self._next_rid, prompt, max_new_tokens, arrival=arrival)
        self._next_rid += 1
        self._pending.append(req)
        self._pending.sort(key=lambda r: r.arrival)
        return req

    def _fund_pages(self) -> None:
        """On-demand admission: before the step, grow every active slot's
        page list to cover its chunk.  Slots are funded in descending
        progress; when the pool runs dry the lowest-progress slot is
        preempted (its pages freed for the rest), possibly the requester
        itself, which then leaves the batch and replays later.  The
        highest-progress slot can always be funded (``submit`` bounds every
        request by the pool), so each step advances at least one request."""
        C = self.ecfg.chunk_tokens
        sched = self.scheduler
        for req in sorted(sched.active.values(), key=lambda r: (-r.n_fed, r.rid)):
            if req.slot == -1:
                continue  # already preempted as someone else's victim
            last_pos = req.n_fed + req.n_feed(C) - 1
            while not sched.ensure_pages(req, last_pos):
                victim = sched.pick_victim()
                sched.preempt(victim)
                if victim is req:
                    break

    def _step_once(self, now_fn) -> bool:
        """Fund (on-demand), step and sample once; False when the step was
        skipped because funding preempted every slot."""
        S, C = self.ecfg.n_slots, self.ecfg.chunk_tokens
        if self.ecfg.admit == "on-demand":
            self._fund_pages()
            if not self.scheduler.active:
                return False  # everything preempted; admission retries next loop
        tokens = np.zeros((S, C), np.int32)
        pos = np.zeros((S,), np.int32)
        lens = np.zeros((S,), np.int32)
        for slot, req in self.scheduler.active.items():
            chunk, start = req.next_chunk(C)
            tokens[slot, : len(chunk)] = chunk
            pos[slot] = start
            lens[slot] = len(chunk)
        logits_np = self._step(tokens, pos, lens).cpu().numpy()  # waits for the device
        self.n_steps += 1
        self.slot_token_steps += len(self.scheduler.active)
        self.fed_tokens += int(lens.sum())
        t = now_fn()
        for slot, req in list(self.scheduler.active.items()):
            req.n_fed += int(lens[slot])
            if req.n_fed < len(req.seq):
                continue  # mid-prompt / mid-replay: logits not sampled
            row = logits_np[slot]
            if not np.isfinite(row).all():
                raise FloatingPointError(f"non-finite logits for request {req.rid} at step {self.n_steps}")
            if self.on_sample is not None:
                self.on_sample(req.rid, len(req.out_tokens), row)
            if not req.out_tokens:
                req.t_first_token = t
            req.out_tokens.append(int(np.argmax(row)))
            if req.done:
                self.scheduler.finish(req, t)
                req.status = "ok"
                self.finished.append(req)
        return True

    def run(self, *, realtime: bool = True) -> dict:
        """Drive the engine until every submitted request is done.

        ``realtime=False`` uses a deterministic virtual clock (1.0 per step)."""
        self._realtime = realtime
        t_wall0 = time.monotonic()

        def now() -> float:
            return (time.monotonic() - t_wall0) if realtime else self._vclock

        while self._pending or not self.scheduler.all_done():
            while self._pending and self._pending[0].arrival <= now():
                self.scheduler.submit(self._pending.pop(0))
            self.scheduler.admit(now())
            if not self.scheduler.active:
                if not self._pending:
                    # submit() bounds every request by the pool and nothing
                    # holds a page while no slot is active, so admission
                    # always places the head of a non-empty waiting queue
                    raise RuntimeError("waiting requests cannot be admitted")
                if realtime:
                    time.sleep(min(max(self._pending[0].arrival - now(), 0.0), 0.01))
                else:
                    self._vclock = max(self._vclock, self._pending[0].arrival)
                continue
            t0 = time.monotonic()
            stepped = self._step_once(now)
            if not realtime:
                self._vclock += 1.0
            elif stepped:
                self.step_seconds.append(time.monotonic() - t0)
        self.assert_no_leaks()
        self._wall = time.monotonic() - t_wall0
        return self.metrics()

    def assert_no_leaks(self) -> None:
        """Every page back on the free list, every slot free, the block
        table cleared; raises AssertionError otherwise."""
        self.allocator.assert_no_leaks()
        self.scheduler.assert_all_reclaimed()

    def metrics(self) -> dict:
        wall = self._wall if self._realtime else self._vclock
        done = self.finished
        lat = [r.t_finish - r.arrival for r in done]
        ttft = [r.t_first_token - r.arrival for r in done]
        gen = sum(len(r.out_tokens) for r in done)
        return {
            "admit": self.ecfg.admit,
            "chunk_tokens": self.ecfg.chunk_tokens,
            "n_requests": len(done),
            "statuses": dict(Counter(r.status for r in done)),
            "generated_tokens": gen,
            "prompt_tokens": sum(len(r.prompt) for r in done),
            "fed_tokens": self.fed_tokens,
            "preemptions": self.scheduler.n_preemptions,
            "steps": self.n_steps,
            "wall": wall,
            "tokens_per_s": gen / wall if wall > 0 else None,
            "step_s_p50": percentile(self.step_seconds, 50),
            "latency_p50": percentile(lat, 50),
            "ttft_p50": percentile(ttft, 50),
            "slot_occupancy": (self.slot_token_steps / (self.n_steps * self.ecfg.n_slots)
                               if self.n_steps else 0.0),
        }
