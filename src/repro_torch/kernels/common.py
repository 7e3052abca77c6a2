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
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device


def timed(fn, *args, device: str | torch.device):
    """Run ``fn(*args)`` to completion on ``device``; returns ``(result,
    seconds)``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn(*args)
        end.record(stream)
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    if dev.type == "cpu":
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0
    raise ValueError(f"no timer for device {dev}")


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
