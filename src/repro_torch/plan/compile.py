"""Plan-compile CLI (``repro.plan.compile``): search + autotune + save a
deployment plan.

  PYTHONPATH=src python -m repro_torch.plan.compile --arch llama3.2-3b --full \\
      --objective footprint --budget-frac 0.85 [--autotune]
  PYTHONPATH=src python -m repro_torch.plan.compile --uniform 4 4   # global-4bit

The artifact (``artifacts/plans/*.json`` unless ``--out``) is what
``serving.build_engine(..., plan=DeployPlan.load(path))`` serves.
``--autotune`` times ``block_k`` candidates on the card.  ``--from-nas``
waits for the convnet NAS (ROADMAP.md, port queue, "Training, QAT and
NAS") and ``--trace-cost`` for a step-cost tracer of the port (the
reference traces a jaxpr with ``repro/launch/cost.py``; ROADMAP.md, port
queue, "CLIs and benches").
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.plan import autotune as plan_autotune
from repro_torch.plan import plan as plan_mod
from repro_torch.plan import search as plan_search

NOT_PORTED = {
    "from_nas": "--from-nas needs the convnet NAS, not ported yet (ROADMAP.md, port queue, "
                "'Training, QAT and NAS')",
    "trace_cost": "--trace-cost needs a step-cost tracer, not ported yet (the reference's "
                  "repro/launch/cost.py; ROADMAP.md, port queue, 'CLIs and benches')",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config shapes")
    ap.add_argument("--objective", choices=("footprint", "latency"), default="footprint")
    ap.add_argument("--budget-frac", type=float, default=0.85,
                    help="cost budget as a fraction of uniform w4a4")
    ap.add_argument("--bits", type=int, nargs="+",
                    default=list(plan_search.DEFAULT_BIT_CHOICES))
    ap.add_argument("--beam", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8, help="serving batch the plan targets")
    ap.add_argument("--head-bits", type=int, nargs=2, default=(8, 8), metavar=("W", "A"))
    ap.add_argument("--uniform", type=int, nargs=2, metavar=("W", "A"),
                    help="emit a global single-bit-pair plan instead of searching")
    ap.add_argument("--layer-bits", nargs="+", metavar="W,A",
                    help="explicit per-layer pairs, e.g. --layer-bits 2,2 4,4 5,3")
    ap.add_argument("--from-nas", metavar="JSON", help="not ported: " + NOT_PORTED["from_nas"])
    ap.add_argument("--autotune", action="store_true",
                    help="time block_k per unique shape on the card")
    ap.add_argument("--reps", type=int, default=3, help="autotune timing repetitions")
    ap.add_argument("--trace-cost", action="store_true", help="not ported: " + NOT_PORTED["trace_cost"])
    ap.add_argument("--out", help="output path (default artifacts/plans/<auto>.json)")
    ap.add_argument("--name", help="artifact stem under artifacts/plans/")
    args = ap.parse_args(argv)

    for flag, msg in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(msg)
    cfg = get_config(args.arch, smoke=not args.full)
    if args.uniform:
        plan = plan_search.uniform_plan(
            cfg, arch=args.arch, w_bits=args.uniform[0], a_bits=args.uniform[1],
            n_slots=args.slots, head_bits=tuple(args.head_bits), smoke=not args.full,
        )
    elif args.layer_bits:
        bits = [tuple(int(b) for b in pair.split(",")) for pair in args.layer_bits]
        plan = plan_search.plan_from_bits(
            cfg, arch=args.arch, bits=bits, n_slots=args.slots,
            head_bits=tuple(args.head_bits), smoke=not args.full,
        )
    else:
        plan = plan_search.search_plan(
            cfg, arch=args.arch, objective=args.objective,
            budget_frac=args.budget_frac, bit_choices=tuple(args.bits),
            beam=args.beam, n_slots=args.slots,
            head_bits=tuple(args.head_bits), smoke=not args.full,
        )
    if args.autotune:
        plan = plan_autotune.autotune_plan(plan, cfg, n_slots=args.slots, reps=args.reps, verbose=True)

    path = plan.save(args.out, name=args.name)
    print(plan_mod.summarize(plan))
    print(f"plan written to {path}")
    return path


if __name__ == "__main__":
    main()
