"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 50 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 20 \\
        --batch 8 --seq 512 --attn-impl flash

The flags of ``repro.launch.train``, plus ``--device`` (default ``cuda``;
pass ``--device cpu`` to run on the CPU) and ``--attn-impl`` (default
``torch``, the reference's default route; ``flash`` runs the prefill
kernel under its autograd.Function on the card).  Batches come from
``repro_torch.data.make_batch``, a pure function of (seed, step), so a run
restarted from a checkpoint sees the batches an uninterrupted run would.

Fault tolerance: an async checkpoint every ``--ckpt-every`` steps under
``--ckpt-dir``; on start the latest checkpoint there is restored.
``--die-at-step`` simulates a preemption: the process waits for its
checkpoint and exits with code 42 after that step.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="warmup_cosine")
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--die-at-step", type=int, default=None,
                    help="simulate preemption: exit(42) after this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--attn-impl", default="torch",
                    choices=["torch", "flash", "naive"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import make_batch
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.training import (
        TrainerConfig, batch_to_torch, make_train_step,
    )

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainerConfig(
        lr=args.lr, schedule=args.schedule, warmup=max(args.steps // 10, 1),
        total_steps=args.steps, remat=args.remat, grad_accum=args.grad_accum,
        loss_chunk=args.loss_chunk, attn_impl=args.attn_impl,
    )
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq} device={device}")

    params = init_params(cfg, args.seed, device=device)
    opt = adamw_init(params)
    start_step = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        got = restore(args.ckpt_dir, {"params": params, "opt": opt})
        params, opt = got["params"], got["opt"]
        start_step = latest_step(args.ckpt_dir)
        print(f"[train] restored checkpoint at step {start_step}")

    step_fn = make_train_step(cfg, tcfg)
    t0 = time.time()
    tokens_done = 0
    m = None
    for step in range(start_step, args.steps):
        batch = batch_to_torch(
            make_batch(cfg, seq_len=args.seq, batch=args.batch, step=step,
                       seed=args.seed, reduced=args.reduced), device)
        params, opt, m = step_fn(params, opt, batch)
        tokens_done += args.batch * args.seq
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  lr {float(m['lr']):.2e}  "
                  f"tok/s {tokens_done/max(dt,1e-9):,.0f}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, {"params": params, "opt": opt},
                            metadata={"arch": cfg.name})
        if args.die_at_step is not None and step + 1 >= args.die_at_step:
            if ckpt:
                ckpt.wait()
            print(f"[train] simulated preemption at step {step + 1}")
            return 42
    if ckpt:
        ckpt.save_async(args.steps, {"params": params, "opt": opt},
                        metadata={"arch": cfg.name})
        ckpt.wait()
    if m is not None:
        print(f"[train] done: final loss {float(m['loss']):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
