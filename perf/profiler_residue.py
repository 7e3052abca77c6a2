#!/usr/bin/env python3
"""Does a ``torch.profiler`` session slow the later eager steps of its
process?  On one card, in one process: the host time of 20,000 tiny
launches and the p50 of 5 ``make_train_step`` steps of mamba2-130m at full
width (the training CLI's settings: 8 x 256 tokens, 2 micro-batches),
before any profiler session and after each of three short ones.

    python3 perf/profiler_residue.py

chip_smoke.py runs its phase 21 in a process of its own, and traces that
phase's steps last, because of what this prints.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T

    if not torch.cuda.is_available():
        print("profiler_residue: no CUDA device", file=sys.stderr)
        return 2
    x = torch.zeros(1024, device="cuda")

    def per_launch_us(n: int = 20000) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e6

    def train_step_ms() -> float:
        cfg = dataclasses.replace(get_config("mamba2-130m"), ssm_chunk=256)
        params = T.init_params(cfg, seed=0, device="cuda")
        step = S.make_train_step(cfg, None, S.TrainStepConfig(n_micro=2))
        state = step.optimizer.init(params)
        batch = {k: torch.randint(0, cfg.vocab, (8, 256), dtype=torch.int32, device="cuda")
                 for k in ("tokens", "labels")}
        times = []
        for _ in range(6):
            t = time.perf_counter()
            loss, params, state = step(params, state, batch)
            float(loss)
            times.append(time.perf_counter() - t)
        return sorted(times[1:])[2] * 1e3

    print(f"before any profiler session: {per_launch_us():.2f} us a launch; mamba2-130m train step "
          f"{train_step_ms():.1f} ms", flush=True)
    for i in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                x.add_(1.0)
            torch.cuda.synchronize()
        prof.key_averages()
        print(f"after profiler session {i + 1}: {per_launch_us():.2f} us a launch; mamba2-130m train step "
              f"{train_step_ms():.1f} ms", flush=True)
    print(torch.cuda.get_device_name(0), torch.__version__)
    return 0


if __name__ == "__main__":
    sys.exit(main())
