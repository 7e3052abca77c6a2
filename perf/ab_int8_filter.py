#!/usr/bin/env python3
"""Time K4, K5 and K6 of two checkouts on one card, in turns.

    python3 perf/ab_int8_filter.py --trees OLD NEW NEW OLD [--out FILE]

Each tree is a repository root (this checkout, or an older commit unpacked
with ``git archive``).  Each turn runs in a process of its own, builds that
tree's ``quant_matmul`` and ``filter_conv`` libraries and times, with that
tree's own ``chip_smoke.py`` CUDA-graph timer:

* K4 (``quant_matmul``, W8A8) at every phase-6 shape: the full-width
  llama3.2-3b decode shapes at M = 8 and wq|wo at M = 128, the int8 weights
  cycled through 256 MB;
* K5 (``quant_packed_matmul``) at w2a2 and w2a3 at every phase-6 shape: the
  full-width llama3.2-3b decode shapes at M = 8 and wq|wo at M = 128, the
  packed words cycled through 256 MB (cold, as a decode step finds them);
* K6 (``filter_conv``) at phase 7's 16 cases (UltraNet's five 3x3 layers as
  row convolutions at w2a2, w3a4 and w4a4, and one 7-tap case).

The operands come from the same seeds in every turn, and every result is
checked against the tree's plain version once before it is timed.  Prints
one line per turn, then the sums per tree, and writes everything to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def worker(root: Path) -> dict:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.filter_conv import ref as fc
    from repro_torch.kernels.filter_conv.kernel import filter_conv_plain, filter_conv_raw
    from repro_torch.kernels.filter_conv.ops import choose_filter_config
    from repro_torch.kernels.packed_matmul import ref as pm
    from repro_torch.kernels.quant_matmul.kernel import (
        quant_matmul_plain, quant_matmul_raw, quant_packed_matmul_plain, quant_packed_matmul_raw,
    )
    from repro_torch.kernels.quant_matmul.ops import choose_mxu_config

    if not torch.cuda.is_available():
        raise SystemExit("ab_int8_filter: no CUDA device")
    build.build_all(("quant_matmul", "filter_conv"))
    timer = chip_smoke.Timer(torch)
    cfg = get_config("llama3.2-3b")
    shapes = [(name, K, N, 8, per_step) for name, (K, N, per_step) in chip_smoke.decode_matmul_shapes(cfg).items()]
    shapes.append(("wq|wo, M=128", cfg.d_model, cfg.n_heads * cfg.hd, 128, 0))
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    k4 = []
    for name, K, N, m, per_step in shapes:
        a8 = torch.randint(-128, 128, (m, K), generator=g, device="cuda", dtype=torch.int8)
        w8 = torch.randint(-128, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        sc = torch.rand((1, N), generator=g, device="cuda") * 1e-4
        if not torch.equal(quant_matmul_raw(a8, w8, sc), quant_matmul_plain(a8, w8, sc)):
            raise SystemExit(f"ab_int8_filter: K4 differs from its plain version at {name}")
        w8s = chip_smoke.cold_copies(w8)
        k4.append(dict(shape=name, M=m, K=K, N=N, per_step=per_step,
                       ms=timer.graph(lambda i: quant_matmul_raw(a8, w8s[i % len(w8s)], sc))))
        del a8, w8, w8s
        torch.cuda.empty_cache()
    g.manual_seed(6)
    k5 = []
    for name, K, N, m, per_step in shapes:
        for pair in ((2, 2), (2, 3)):
            c = choose_mxu_config(*pair)
            a = torch.randint(0, 1 << pair[1], (m, K), generator=g, device="cuda", dtype=torch.int8)
            w_lvl = torch.randint(0, 1 << pair[0], (K, N), generator=g, device="cuda", dtype=torch.int32)
            wp = pm.pack_weights(w_lvl, c.n_seg, c.stride).to(torch.int8)
            del w_lvl
            kw = dict(n_seg=c.n_seg, stride=c.stride, acc_chunk=c.acc_chunk, overlap=c.overlap)
            if not torch.equal(quant_packed_matmul_raw(a, wp, **kw), quant_packed_matmul_plain(a, wp, **kw)):
                raise SystemExit(f"ab_int8_filter: K5 differs from its plain version at {name} {pair}")
            wps = chip_smoke.cold_copies(wp)
            k5.append(dict(shape=name, pair=f"w{pair[0]}a{pair[1]}", M=m, K=K, N=N, per_step=per_step,
                           ms=timer.graph(lambda i: quant_packed_matmul_raw(a, wps[i % len(wps)], **kw))))
            del a, wp, wps
            torch.cuda.empty_cache()
    g.manual_seed(7)
    k6 = []
    cases = [(shape, pair, 3) for shape in chip_smoke.ULTRANET_ROWS for pair in chip_smoke.FILTER_PAIRS]
    cases.append((chip_smoke.ULTRANET_ROWS[2], (2, 2), 7))
    for (B, C, N), (wb, ab), k in cases:
        s = torch.randint(0, 1 << ab, (B, C, N), generator=g, device="cuda", dtype=torch.int32)
        f = torch.randint(0, 1 << wb, (C, k), generator=g, device="cuda", dtype=torch.int32)
        c = choose_filter_config(wb, ab, k)
        n_pad = -(-N // c.n_p) * c.n_p
        sp = F.pad(s, (0, n_pad - N)).contiguous()
        fp = fc.pack_filter(f, c.k_p, c.stride)
        kw = dict(k_p=c.k_p, n_p=c.n_p, stride=c.stride, acc_chunk=c.acc_chunk, k_len=k, n_len=N,
                  overlap=c.overlap)
        if not torch.equal(filter_conv_raw(sp, fp, **kw), filter_conv_plain(sp, fp, **kw)):
            raise SystemExit(f"ab_int8_filter: K6 differs from its plain version at {(B, C, N)} w{wb}a{ab}")
        k6.append(dict(B=B, C=C, N=N, K=k, pair=f"w{wb}a{ab}",
                       ms=timer.graph(lambda i: filter_conv_raw(sp, fp, **kw))))

    def step(pair):
        return sum(r["ms"] * r["per_step"] for r in k5 if r["pair"] == pair)

    return dict(tree=str(root), card=chip_smoke.smi("name,power.limit"), k4=k4, k5=k5, k6=k6,
                k4_step_ms=sum(r["ms"] * r["per_step"] for r in k4),
                k5_step_ms_w2a2=step("w2a2"), k5_step_ms_w2a3=step("w2a3"),
                k6_sum_ms=sum(r["ms"] for r in k6))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path, help="repository roots, timed in this order")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker.resolve())))
        return 0
    turns = []
    keys = ("tree", "card", "k4_step_ms", "k5_step_ms_w2a2", "k5_step_ms_w2a3", "k6_sum_ms")
    for root in args.trees:
        out = subprocess.run([sys.executable, __file__, "--worker", str(root)], capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        t = turns[-1]
        print(f"{t['tree']}: K4 {t['k4_step_ms']:.4f} ms/step; "
              + ", ".join(f"{r['shape']} {r['ms']:.4f}" for r in t["k4"])
              + f"; K5 {t['k5_step_ms_w2a2']:.4f} ms/step w2a2, {t['k5_step_ms_w2a3']:.4f} w2a3; "
              + ", ".join(f"{r['shape']} {r['pair']} {r['ms']:.4f}" for r in t["k5"])
              + f"; K6 {t['k6_sum_ms']:.4f} ms over {len(t['k6'])} cases: "
              + ", ".join(f"{r['B']}x{r['C']}x{r['N']} K{r['K']} {r['pair']} {1e3 * r['ms']:.2f}us"
                          for r in t["k6"]), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(turns, indent=1))
    print(json.dumps([{k: t[k] for k in keys} for t in turns]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
