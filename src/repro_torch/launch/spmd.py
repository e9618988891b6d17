"""Start an SPMD program: ``world`` processes that form one gloo process
group, each running ``fn(rank, world, *args)``.

The ranks are started with the ``spawn`` method (never forked, so a parent
that has initialised CUDA is safe), meet at a ``file://`` store in a fresh
directory, and each writes its result to a file there (``torch.save``; a
rank should return CPU tensors and plain values).  The parent waits for
all of them: if a rank fails, or the whole run outlasts ``timeout``
seconds, it kills every rank and raises, with the failed rank's traceback.
A collective that waits more than ``INIT_TIMEOUT_S`` seconds for the
other ranks fails its rank.  Each rank runs one intra-op thread: ranks on
one machine share its cores.  CUDA kernels must be built before the ranks start
(``kernels._build.build``): ranks that reach their first kernel together
would each build it into the same directory.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

INIT_TIMEOUT_S = 120.0     # a collective's wait for the other ranks
POLL_S = 0.05


def _rank_main(fn, rank: int, world: int, workdir: str, args) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(workdir, "store"),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        path = os.path.join(workdir, f"rank{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, *, args: Sequence = (),
              timeout: float = 600.0) -> List[Any]:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one gloo
    group; their results in rank order.  ``fn`` and ``args`` must pickle
    (a module-level function).  Raises ``RuntimeError`` naming the first rank that failed, or
    ``TimeoutError`` after ``timeout`` seconds; every rank is stopped
    either way."""
    import torch

    ctx = mp.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="spmd-")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, workdir, tuple(args)))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                err = os.path.join(workdir, f"rank{r}.err")
                why = (open(err).read() if os.path.exists(err)
                       else f"exit code {codes[r]}")
                raise RuntimeError(f"rank {r} of {world} failed:\n{why}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"the {world} ranks did not finish in {timeout} s "
                    f"(done: {[r for r, c in enumerate(codes) if c == 0]})")
            time.sleep(POLL_S)
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10)
        shutil.rmtree(workdir, ignore_errors=True)


__all__ = ["run_ranks"]
