"""Serving launcher: one continuous batcher per tenant on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --reduced --tenants 2 --requests 16

The same flags as ``repro.launch.serve``, plus ``--device`` (default
``cuda``; pass ``--device cpu`` to run on the CPU).  Each tenant runs a
``ContinuousBatcher`` on the dense chunked hot path (one dispatch and one
host sync per ``--chunk`` tokens).  The reference leases each tenant a
disjoint core set from a ``VirtualAcceleratorPool``; that lease arrives
with the tenancy slice (ROADMAP.md Queue 1 item 8), so here every tenant
shares the one card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps fused per dispatch (1 = per-step)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(cfg, args.seed, device=device)
    rng = np.random.default_rng(args.seed)

    print(f"[serve] arch={cfg.name} tenants={args.tenants} device={device}")
    total_toks = 0
    t0 = time.time()
    for t in range(args.tenants):
        batcher = ContinuousBatcher(
            params, cfg,
            ServingConfig(slots=args.slots, prompt_len=args.prompt_len,
                          max_len=args.prompt_len + args.max_new + 2,
                          chunk=args.chunk),
            device=device,
        )
        for r in range(args.requests):
            plen = int(rng.integers(2, args.prompt_len))
            batcher.submit(Request(
                rid=r, prompt=rng.integers(1, cfg.vocab, size=plen).astype(np.int32),
                max_new=args.max_new,
            ))
        stats = batcher.run()
        print(f"  tenant{t}: completed={stats.completed}/{args.requests}, "
              f"decode steps={stats.steps} in {stats.chunks} chunks "
              f"({stats.dispatches} dispatches, {stats.host_syncs} syncs, "
              f"{stats.dispatches_per_token:.3f} disp/token), "
              f"occupancy={stats.occupancy:.2f}")
        total_toks += stats.tokens
    dt = time.time() - t0
    print(f"[serve] done in {dt:.1f}s (~{total_toks/dt:,.0f} tokens/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
