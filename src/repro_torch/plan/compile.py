"""Plan-compile CLI (``repro.plan.compile``): search + autotune + save a
deployment plan.

  PYTHONPATH=src python -m repro_torch.plan.compile --arch llama3.2-3b --full \\
      --objective footprint --budget-frac 0.85 [--autotune]
  PYTHONPATH=src python -m repro_torch.plan.compile --uniform 4 4   # global-4bit
  PYTHONPATH=src python -m repro_torch.plan.compile --from-nas build/selected_bits.json \\
      --nas-spec ultranet

The artifact (``artifacts/plans/*.json`` unless ``--out``) is what
``serving.build_engine(..., plan=DeployPlan.load(path))`` serves.
``--autotune`` times ``block_k`` candidates on the card.  ``--from-nas``
adapts a convnet NAS result (``{model: {"bits": [[w, a], ...], "op_dsp":
..., "metric": ...}}``, as ``repro_torch.core.nas.search`` selects it) into
a plan, as the reference does.  ``--trace-cost`` waits for a step-cost
tracer of the port (the reference traces a jaxpr with
``repro/launch/cost.py``; ROADMAP.md, port queue 1, item 4).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import types

from repro_torch.configs import get_config
from repro_torch.core.packing import DSP48E2, cached_luts
from repro_torch.models import convnets
from repro_torch.plan import autotune as plan_autotune
from repro_torch.plan import plan as plan_mod
from repro_torch.plan import search as plan_search

NOT_PORTED = {
    "trace_cost": "--trace-cost needs a step-cost tracer, not ported yet (the reference's "
                  "repro/launch/cost.py; ROADMAP.md, port queue 1, item 4: the step-cost tracer)",
}


def _plan_from_nas(path: str, nas_spec: str) -> plan_mod.DeployPlan:
    """The plan of one model of a ``selected_bits.json`` (``nas_spec``'s
    entry, else the first), scored by the DSP48E2 LUTs of kernel lengths
    1, 3 and 5 from the LUT cache."""
    payload = json.loads(pathlib.Path(path).read_text())
    key = nas_spec if nas_spec in payload else next(iter(payload))
    bits = [tuple(b) for b in payload[key]["bits"]]
    spec = getattr(convnets, key.replace("-", "_"))()
    luts = cached_luts(plan_search.DEFAULT_LUT_PATH, profile=DSP48E2, kernel_lens=(1, 3, 5))
    result = types.SimpleNamespace(
        bits=bits, op_dsp=payload[key].get("op_dsp"), final_metric=payload[key].get("metric"),
    )
    return plan_search.plan_from_nas_result(result, spec, luts, arch=key)


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
    ap.add_argument("--from-nas", metavar="JSON",
                    help="adapt a core.nas selected-bits artifact (convnet path)")
    ap.add_argument("--nas-spec", default="vgg_tiny",
                    help="convnets spec name for --from-nas (vgg_tiny|ultranet|...)")
    ap.add_argument("--autotune", action="store_true",
                    help="time block_k per unique shape on the card")
    ap.add_argument("--reps", type=int, default=3, help="autotune timing repetitions")
    ap.add_argument("--trace-cost", action="store_true", help="not ported: " + NOT_PORTED["trace_cost"])
    ap.add_argument("--out", help="output path (default artifacts/plans/<auto>.json)")
    ap.add_argument("--name", help="artifact stem under artifacts/plans/")
    args = ap.parse_args(argv)

    if args.from_nas:
        if args.autotune or args.trace_cost:
            raise SystemExit(
                "--autotune/--trace-cost need serving-family layer shapes; "
                "they do not apply to --from-nas convnet plans"
            )
        plan = _plan_from_nas(args.from_nas, args.nas_spec)
    else:
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
