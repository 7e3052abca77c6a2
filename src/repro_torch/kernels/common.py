"""Kernel timing (the timing discipline of ``repro.kernels.common.timed``).

The device is named by the caller and decides the clock; nothing falls
back from one to the other:

* ``"cuda"``: CUDA events recorded on the current stream around the
  call, read after the end event completes (device time);
* ``"cpu"``: ``time.perf_counter`` around the call, for the plain
  versions the CPU tests run.

:func:`repeat` turns ``reps`` calls into one timed unit: one CUDA graph
of them on the card (so a call of a few microseconds is not measured as
the host's enqueue), a Python loop on the CPU.

:class:`KernelTimer` collects labelled :func:`timed` calls while it is
installed by :func:`kernel_timing` (``obs/drift.py`` times each
projection of a plan through it, as the reference's does).
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.device import resolve_device


_ACTIVE_TIMER: "KernelTimer | None" = None


class KernelTimer:
    """Collects labelled kernel timings while installed via
    :func:`kernel_timing`: ``records[label]`` holds seconds per call."""

    def __init__(self):
        self.records: dict[str, list[float]] = {}

    def record(self, label: str, seconds: float) -> None:
        self.records.setdefault(label, []).append(seconds)

    def best(self, label: str) -> float:
        """Minimum over the label's calls (beats the mean against the
        noise floor of a shared machine)."""
        return min(self.records[label])

    def total_best(self) -> float:
        return sum(min(v) for v in self.records.values())


@contextlib.contextmanager
def kernel_timing(timer: KernelTimer):
    """Install ``timer`` as the sink of :func:`timed`'s labels."""
    global _ACTIVE_TIMER
    prev, _ACTIVE_TIMER = _ACTIVE_TIMER, timer
    try:
        yield timer
    finally:
        _ACTIVE_TIMER = prev


def timed(fn, *args, device: str | torch.device, label: str | None = None):
    """Run ``fn(*args)`` to completion on ``device``; returns ``(result,
    seconds)``.  With a :class:`KernelTimer` installed and ``label`` given,
    the seconds are also recorded there."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn(*args)
        end.record(stream)
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    elif dev.type == "cpu":
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
    else:
        raise ValueError(f"no timer for device {dev}")
    if label is not None and _ACTIVE_TIMER is not None:
        _ACTIVE_TIMER.record(label, dt)
    return out, dt


def best_time(fn, *args, device: str | torch.device, reps: int) -> float:
    """Least of ``reps`` :func:`timed` calls after one warm-up call, in
    seconds (the minimum beats the mean against a shared machine's noise)."""
    timed(fn, *args, device=device)
    return min(timed(fn, *args, device=device)[1] for _ in range(reps))


def repeat(fn, reps: int, device: str | torch.device):
    """A callable that runs ``fn(i)`` for ``i`` in ``range(reps)``: on the
    card one replay of a CUDA graph that captured those calls (after
    ``fn(0)`` once outside the capture, which makes one-time objects such
    as split-K counters), on the CPU a loop."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return lambda: [fn(i) for i in range(reps)]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for i in range(reps):
                fn(i)
    torch.cuda.current_stream(dev).wait_stream(side)
    return graph.replay
