"""Plan drift (``repro.obs.drift``): predicted per-layer cost against
*measured* per-layer time.

The plan compiler ranks per-layer bit choices by the packing LUT's
``T_mul`` (paper Eq. 6: predicted layer time ∝ ``Op / T_mul``), a model
blind to a backend's own overheads.  This module closes the loop: every
layer of a served plan is timed and set beside the plan's predicted
``T_mul``/cost fields.  The report normalizes both sides to per-layer
*shares* of the step (shares survive the absolute noise of a shared
machine) and counts ranking inversions (layer pairs whose predicted and
measured orders disagree: Kendall disagreement).

Two measurement modes, selected by ``--mode`` (default ``both``):

* **standalone**: each projection timed alone through the serving entry
  point (:func:`~repro_torch.kernels.packed_matmul.ops.packed_dense` on
  :func:`~repro_torch.kernels.packed_matmul.ops.prepack_dense` words at the
  plan's ``block_k``), by :func:`repro_torch.kernels.common.timed`
  (CUDA events on the card, ``perf_counter`` on the CPU) into a
  :class:`~repro_torch.kernels.common.KernelTimer`;
* **in-situ**: the plan is served by the port's engine with attribution
  on (:mod:`repro_torch.obs.attrib`), and a layer's time is its segment's
  inside the served step, attention, norms and overheads included.

The activations, weights and prompts are drawn with numpy from ``seed``
(the reference draws them with ``jax.random``), so the two packages time
different values of the same shapes.

  PYTHONPATH=src python -m repro_torch.obs.drift --plan artifacts/plans/drift-mixed.json
  PYTHONPATH=src python -m repro_torch.obs.drift --plan p.json --mode in-situ --device cpu

The report goes to ``artifacts/plan_drift_torch.json`` (git-ignored; the
reference's committed ``artifacts/plan_drift.json`` stays its own).
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.common import KernelTimer, kernel_timing, timed

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_OUT = _REPO_ROOT / "artifacts" / "plan_drift_torch.json"
MODES = ("standalone", "in-situ", "both")


def measure_layer_times(plan, cfg, *, n_slots: int | None = None, reps: int = 3, seed: int = 0,
                        device: str | torch.device = "cuda") -> list[dict]:
    """Measured decode-step seconds per plan layer, standalone.

    Each projection is prepacked at the layer's ``(w_bits, a_bits)`` and
    timed through :func:`~repro_torch.kernels.common.timed` at the plan's
    ``block_k``; the least of ``reps`` calls counts (after one untimed
    call), and a layer's time is its projections' summed by count."""
    from repro_torch.kernels.packed_matmul.ops import packed_dense, prepack_dense
    from repro_torch.plan.search import layer_matmul_shapes

    dev = resolve_device(device)
    n_slots = n_slots or int(plan.budget.get("n_slots", 8))
    shapes = layer_matmul_shapes(cfg, n_slots)
    if len(shapes) != len(plan.layers):
        raise ValueError(f"plan has {len(plan.layers)} layers but config yields {len(shapes)}")
    # identical (shape, bits, block_k) projections share one measurement
    cache: dict[tuple, float] = {}
    rows = []
    for lp, projs in zip(plan.layers, shapes):
        timer = KernelTimer()
        per_proj = {}
        for p in projs:
            key = (p.m, p.k, p.n, lp.w_bits, lp.a_bits, lp.block_k)
            if key not in cache:
                rng = np.random.default_rng(seed)
                x = torch.from_numpy(rng.uniform(0.0, 1.0, (p.m, p.k)).astype(np.float32)).to(dev)
                w = torch.from_numpy(rng.standard_normal((p.k, p.n)).astype(np.float32)).to(dev)
                pre = prepack_dense(w, w_bits=lp.w_bits, a_bits=lp.a_bits, device=dev)

                def run(x, pre=pre, bk=lp.block_k):
                    return packed_dense(x, pre, block_k=bk)

                with torch.inference_mode():
                    timed(run, x, device=dev)  # first-call costs stay untimed
                    with kernel_timing(timer):
                        for _ in range(reps):
                            timed(run, x, device=dev, label=p.name)
                cache[key] = timer.best(p.name)
            per_proj[p.name] = cache[key] * 1e6 * p.count
        rows.append({
            "index": lp.index,
            "name": lp.name,
            "w_bits": lp.w_bits,
            "a_bits": lp.a_bits,
            "block_k": lp.block_k,
            "t_mul": lp.t_mul,
            "measured_us": sum(per_proj.values()),
            "per_proj_us": per_proj,
        })
    return rows


def measure_layer_times_in_situ(plan, cfg, *, n_slots: int | None = None, attrib_every: int = 2,
                                reps: int = 1, seed: int = 0,
                                device: str | torch.device = "cuda") -> tuple[list[dict], dict]:
    """Per-layer microseconds measured inside the served step.

    Serves the plan on the port's engine (random params from ``seed``,
    the plan applied, its LM head), ``2 * n_slots`` prompts of 6 tokens
    drawn with numpy from ``seed + 1``, 5 new tokens each, on the virtual
    clock with attribution every ``attrib_every`` steps, and averages each
    layer's seconds over the samples.  Returns ``(rows, meta)``."""
    from repro_torch.models import transformer as T
    from repro_torch.plan.apply import apply_plan
    from repro_torch.serving import Engine, EngineConfig, ObsConfig

    dev = resolve_device(device)
    n_slots = n_slots or int(plan.budget.get("n_slots", 8))
    params = T.init_params(cfg, seed=seed, device=dev)
    params, head = apply_plan(params, cfg, plan, verbose=False, device=dev)
    eng = Engine(cfg, params, EngineConfig(n_slots=n_slots, page_size=8, max_len=32, chunk_tokens=4,
                                           admit="reserve",
                                           obs=ObsConfig(attrib_every=attrib_every, attrib_reps=reps)),
                 head=head, device=dev)
    rng = np.random.default_rng(seed + 1)
    for _ in range(2 * n_slots):
        eng.submit(rng.integers(1, cfg.vocab, 6).tolist(), 5)
    eng.run(realtime=False)
    eng.close()
    samples = eng._attrib.samples
    if not samples:
        raise RuntimeError(f"attribution produced no samples over {eng.n_steps} steps "
                           f"(attrib_every={attrib_every})")
    sec = [0.0] * cfg.n_layers
    for s in samples:
        for r in s["layers"]:
            sec[r["index"]] += r["seconds"]
    rows = [{"index": i, "name": lp.name, "w_bits": lp.w_bits, "a_bits": lp.a_bits,
             "measured_us": sec[i] / len(samples) * 1e6} for i, lp in enumerate(plan.layers)]
    meta = {"n_samples": len(samples), "attrib_every": attrib_every, "reps": reps, "steps": eng.n_steps}
    return rows, meta


def _predicted_dsp_ops(lp, projs) -> float:
    """The plan's predicted cost (Eq. 6 ``Op / T_mul``), recomputed from
    the layer's matmul shapes when a plan lacks the ``cost`` block."""
    if lp.cost.get("dsp_ops"):
        return float(lp.cost["dsp_ops"])
    mul_ops = sum(p.mul_ops for p in projs)
    return mul_ops / max(lp.t_mul, 1e-9)


def _discordant_pairs(pred: list[float], meas: list[float]) -> list[tuple[int, int]]:
    """Layer-index pairs whose predicted and measured orders disagree
    (the ranking inversions that flip plan-search decisions)."""
    out = []
    n = len(pred)
    for i in range(n):
        for j in range(i + 1, n):
            dp, dm = pred[i] - pred[j], meas[i] - meas[j]
            if dp * dm < 0:
                out.append((i, j))
    return out


def _annotate_and_rank(rows: list[dict], pred: list[float]) -> dict:
    """Shares, drift ratios and inversions over one set of per-layer
    measurements (standalone or in-situ)."""
    meas = [r["measured_us"] for r in rows]
    pred_total, meas_total = sum(pred), sum(meas)
    for r, p, m in zip(rows, pred, meas):
        r["predicted_dsp_ops"] = p
        r["predicted_share"] = p / pred_total if pred_total else None
        r["measured_share"] = m / meas_total if meas_total else None
        # drift > 1: the layer costs more, relative to its siblings, than
        # the plan compiler believed; < 1: less
        r["drift"] = r["measured_share"] / r["predicted_share"] if r["predicted_share"] else None
    inversions = _discordant_pairs(pred, meas)
    n = len(rows)
    by_pair: dict[tuple[int, int], dict] = {}
    for r, p in zip(rows, pred):
        key = (r["w_bits"], r["a_bits"])
        agg = by_pair.setdefault(key, {"w_bits": key[0], "a_bits": key[1], "n_layers": 0,
                                       "predicted_dsp_ops": 0.0, "measured_us": 0.0})
        agg["n_layers"] += 1
        agg["predicted_dsp_ops"] += p
        agg["measured_us"] += r["measured_us"]
    pairs = [by_pair[k] for k in sorted(by_pair)]
    pair_inversions = _discordant_pairs([p["predicted_dsp_ops"] / p["n_layers"] for p in pairs],
                                        [p["measured_us"] / p["n_layers"] for p in pairs])
    drifts = [r["drift"] for r in rows if r["drift"] is not None]
    return {
        "layers": rows,
        "pairs": pairs,
        "rank_inversions": len(inversions),
        "inverted_layer_pairs": inversions,
        "n_layer_pairs": n * (n - 1) // 2,
        "pair_rank_inversions": len(pair_inversions),
        "max_drift": max(drifts) if drifts else None,
        "min_drift": min(drifts) if drifts else None,
    }


def build_report(plan, cfg, *, n_slots: int | None = None, reps: int = 3, seed: int = 0, mode: str = "both",
                 attrib_every: int = 2, device: str | torch.device = "cuda") -> dict:
    """The drift report of one plan on ``device`` (its ``backend``).

    ``mode="standalone"`` times each projection alone, ``"in-situ"``
    serves the plan with attribution, ``"both"`` (the default) gives the
    standalone report with an ``in_situ`` block beside it."""
    from repro_torch.plan.search import layer_matmul_shapes

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    dev = resolve_device(device)
    n_slots = n_slots or int(plan.budget.get("n_slots", 8))
    shapes = layer_matmul_shapes(cfg, n_slots)
    pred = [_predicted_dsp_ops(lp, projs) for lp, projs in zip(plan.layers, shapes)]
    report = {
        "arch": plan.arch,
        "plan_hash": plan.content_hash(),
        "backend": dev.type,
        "mode": mode,
        "n_slots": n_slots,
        "reps": reps,
        "n_layers": len(plan.layers),
        "n_distinct_bit_pairs": plan.n_distinct_bit_pairs,
    }
    if mode in ("standalone", "both"):
        rows = measure_layer_times(plan, cfg, n_slots=n_slots, reps=reps, seed=seed, device=dev)
        report.update(_annotate_and_rank(rows, pred))
    if mode in ("in-situ", "both"):
        # in situ, the noise is averaged over sampled steps, not repeated
        # segments: reps=1 keeps sampling cheap beside the steps it rides on
        in_rows, in_meta = measure_layer_times_in_situ(plan, cfg, n_slots=n_slots, attrib_every=attrib_every,
                                                       seed=seed, device=dev)
        block = _annotate_and_rank(in_rows, pred)
        block.update(in_meta)
        report["in_situ"] = block
    return report


def main(argv=None) -> pathlib.Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", required=True, help="deployment-plan artifact (repro_torch.plan.compile output)")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="report path (default artifacts/plan_drift_torch.json)")
    ap.add_argument("--reps", type=int, default=3, help="timing repetitions")
    ap.add_argument("--slots", type=int, default=None, help="serving batch (default: the plan's budget)")
    ap.add_argument("--mode", choices=MODES, default="both",
                    help="standalone projection timing, in-situ serving attribution, or both (default)")
    ap.add_argument("--attrib-every", type=int, default=2,
                    help="in-situ: attribution sampling period (engine steps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.plan import DeployPlan

    plan = DeployPlan.load(args.plan)
    cfg = get_config(plan.arch, smoke=plan.smoke)
    report = build_report(plan, cfg, n_slots=args.slots, reps=args.reps, seed=args.seed, mode=args.mode,
                          attrib_every=args.attrib_every, device=args.device)
    report["plan"] = str(args.plan)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    for r in report.get("layers", []):
        print(f"drift {r['name']} w{r['w_bits']}a{r['a_bits']}: predicted {r['predicted_share']:.3f} vs "
              f"measured {r['measured_share']:.3f} of step time (drift {r['drift']:.2f}x)")
    if "layers" in report:
        print(f"rank inversions: {report['rank_inversions']}/{report['n_layer_pairs']} layer pairs on "
              f"backend={report['backend']} (standalone)")
    if "in_situ" in report:
        blk = report["in_situ"]
        print(f"rank inversions: {blk['rank_inversions']}/{blk['n_layer_pairs']} layer pairs in situ "
              f"({blk['n_samples']} sampled steps, every {blk['attrib_every']})")
    print(f"report -> {out}")
    return out


if __name__ == "__main__":
    main()
