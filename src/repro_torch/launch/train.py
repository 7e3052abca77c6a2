"""Training CLI (``repro.launch.train``) on one device: fault-tolerant
LM training of any registry architecture (smoke-reduced unless
``--full``) on the deterministic token stream
(:class:`~repro_torch.data.tokens.TokenStream`), with checkpointing every
``--ckpt-every`` steps (and at step 0) under ``--ckpt-dir``, auto-resume
from its latest checkpoint, straggler monitoring and optional gradient
compression.

The step is :func:`repro_torch.launch.steps.make_train_step`: ``--batch``
rows of ``--seq`` tokens in ``--n-micro`` micro-batches, the model's
dtype for compute (bfloat16 by default) over float32 masters and
moments, activations recomputed layer by layer in the backward (the
configs' ``remat``), one AdamW step (weight decay 0.01, gradient norm
clipped to 1.0).  Weights are random, from
:func:`~repro_torch.models.transformer.init_params` with seed 0.  The SSM
and hybrid families clamp their SSD chunk to ``--seq``.  A resumed run
starts at the checkpoint's step and feeds that step's batch again to the
state saved after it, as the reference does.

``--device`` is ``cuda`` (the default) or ``cpu``; without a card the
default raises.  As in the reference, qwen2-vl-7b (M-RoPE positions) and
whisper-tiny (encoder frames) fail: the token stream carries neither.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --steps 40
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch llama3.2-3b --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models.transformer import init_params
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--ckpt-dir", default="artifacts/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-grads", choices=("none", "int8", "topk"), default="none")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    if cfg.family in ("ssm", "hybrid"):
        cfg = dataclasses.replace(cfg, ssm_chunk=min(cfg.ssm_chunk, args.seq))
    step_cfg = S.TrainStepConfig(n_micro=args.n_micro, lr=args.lr, compress_grads=args.compress_grads)
    train_step = S.make_train_step(cfg, None, step_cfg)
    opt = train_step.optimizer

    params = init_params(cfg, seed=0, device=dev)
    state = (params, opt.init(params))
    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    def stepper(st, batch):
        loss, p, o = train_step(st[0], st[1], batch)
        return loss, (p, o)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    runner = FaultTolerantRunner(stepper, ckpt, RunnerConfig(ckpt_every=args.ckpt_every))
    start, state = runner.resume_or_init(state)

    def batches(step):
        return {k: torch.from_numpy(v).to(dev) for k, v in stream.batch(step).items()}

    t0 = time.time()
    state, stats = runner.run(state, batches, args.steps, start_step=start)
    dt = time.time() - t0
    first, last = (stats.step_times[0], stats.step_times[-1]) if stats.step_times else (0, 0)
    print(
        f"arch={cfg.name} steps={stats.steps} loss={stats.last_loss:.4f} "
        f"wall={dt:.1f}s step0={first:.2f}s stepN={last:.3f}s "
        f"restarts={stats.restarts} stragglers={stats.stragglers}"
    )
    return {"loss": stats.last_loss, "steps": stats.steps}


if __name__ == "__main__":
    main()
