#!/usr/bin/env python3
"""Time mamba2's depthwise causal conv in training on one card, two ways,
in alternating turns in one process: ``F.conv1d`` with ``groups=C`` on the
left-padded input (``repro_torch.models.mamba._conv1d_causal``) against a
sum of ``K`` shifted slices times each tap.

    python3 perf/train_conv.py [--pairs 5] [--out FILE]

The shapes are one micro-batch of chip_smoke.py phase 21 (b): mamba2-130m
at full width (conv channels 1536 + 2 x 128 = 1792, width 4), 4 sequences
of 256 tokens, bfloat16, forward and backward (the input's, the taps' and
the bias's gradients), 24 calls a turn (one a layer), each turn timed by
CUDA events.  Both must agree with a float64 reference within bfloat16's
rounding; the card's name and power limit are printed beside the times.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src")]
    import torch
    import torch.nn.functional as F

    from repro_torch.models.mamba import _conv1d_causal

    if not torch.cuda.is_available():
        print("train_conv: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    def shifted(w, bias, x):
        K = w.shape[0]
        xp = F.pad(x, (0, 0, K - 1, 0))
        S = x.shape[1]
        out = xp[:, 0:S] * w[0].to(x.dtype)
        for k in range(1, K):
            out = out + xp[:, k:k + S] * w[k].to(x.dtype)
        return out + bias.to(x.dtype)

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    B, S, C, K, calls = 4, 256, 1792, 4, 24
    x = torch.randn((B, S, C), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((K, C), generator=g, device="cuda") * 0.2
    b = torch.zeros(C, device="cuda")
    cot = torch.randn((B, S, C), generator=g, device="cuda").to(torch.bfloat16)

    def turn(fn):
        xs = [x.clone().requires_grad_(True) for _ in range(calls)]
        ws = [w.clone().requires_grad_(True) for _ in range(calls)]
        bs = [b.clone().requires_grad_(True) for _ in range(calls)]
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for xi, wi, bi in zip(xs, ws, bs):
            fn(wi, bi, xi).backward(cot)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1), xs[0].grad, ws[0].grad

    ref = _conv1d_causal(w.double(), b.double(), x.double())
    for name, fn in (("conv1d", _conv1d_causal), ("shifted", shifted)):
        out = fn(w, b, x).double()
        err = float((out - ref).abs().max() / ref.abs().max())
        assert err < 2 ** -6, (name, err)
    turn(_conv1d_causal), turn(shifted)  # warm-up: cuDNN's algorithm choice, allocations
    times = {"conv1d": [], "shifted": []}
    order = ("conv1d", "shifted")
    for i in range(args.pairs):
        for name in (order if i % 2 == 0 else order[::-1]):
            ms, _, _ = turn(_conv1d_causal if name == "conv1d" else shifted)
            times[name].append(ms)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"{smi}: {calls} calls (one micro-batch's layers) forward + backward at [{B}, {S}, {C}] bf16, width {K}: "
          + ", ".join(f"{k} median {v:.3f} ms ({v / calls:.3f} a call)" for k, v in med.items()), flush=True)
    report = {"card": smi, "shape": [B, S, C], "width": K, "calls": calls, "ms": times, "median_ms": med}
    if args.out:
        args.out.parent.mkdir(exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
