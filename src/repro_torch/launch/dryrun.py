"""Dry-run of every (arch × shape) cell over the production meshes: trace
each program once on ``meta`` tensors, count its cost, lay its arguments
out over each mesh, and report its roofline terms on H100 peaks.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
one SPMD program a cell and mesh on 512 host devices; the port traces each
cell's global program on meta tensors (``distributed.op_static``) and lays
it out over each mesh description (``launch.mesh``):

* ``argument_bytes_per_device`` — each argument's bytes over the mesh axes
  its spec splits it across (the reference's ``argument_size_in_bytes``);
* ``static_per_device`` — the program's counted flops and bytes divided
  evenly over the chips (the reference's are the compiled per-device
  module's);
* ``roofline`` — ``op_analysis.Roofline.as_dict()`` at the mesh's chips;
* ``per_device_estimate`` — the arguments per device plus the global
  program's peak temporaries split evenly, labelled as such;
* ``collectives`` — what one device's share of the program would send:
  every cell is built under ``distributed.spmd.make_policy``, and on a
  mesh description each of its hooks records its collective's ring wire
  bytes a device (by op and by site); a train cell's record holds its
  backward's collectives (sites ``"bwd:..."``, each adjoint recording what
  it would issue) and the step's gradient sums, norm and counts;
  ``collectives_reason`` says why a cell records none (only a cell on one
  device).

Each record goes to ``<out>/<arch>__<shape>__<mesh>.json`` (default
``build/dryrun_torch/``, git-ignored).  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, cell_status
from ..distributed.op_analysis import Roofline
from ..tree import leaves
from .cells import argument_bytes_per_device, build_cell
from .mesh import make_production_mesh


def collectives_reason(cell):
    """Why a cell records no collectives, or None: only a cell whose mesh
    is one device has nothing to send."""
    return ("one device: nothing to communicate" if cell.mesh.size == 1
            else None)


#: the kernels' route of each kind of cell: training differentiates the
#: prefill kernel through ``"flash"``, serving launches it through ``"cuda"``
KERNEL_ROUTES = {"train": "flash", "prefill": "cuda", "decode": "cuda"}


def cell_route(attn_impl: str, shape_name: str) -> str:
    """``attn_impl`` for one cell: ``"cuda"`` or ``"flash"`` asks for the
    kernels' route of the cell's kind, any other name is taken as it is."""
    if attn_impl in ("cuda", "flash"):
        return KERNEL_ROUTES[SHAPES[shape_name].kind]
    return attn_impl


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             skip_existing: bool = True, attn_impl: str = "torch",
             remat: str = "full", dp_tp=None, fsdp: bool = True,
             moe_ep: bool = True, traced=None) -> dict:
    """One cell over one production mesh; writes and returns its record.
    ``traced`` (a dict) keeps each cell's abstract arguments and counted
    cost between meshes, so a sweep over both meshes traces each program
    once."""
    mesh = make_production_mesh(multi_pod=multi_pod, dp_tp=dp_tp)
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}.json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("ok"):
            print(f"[skip] {arch} {shape_name} {mesh_tag} (cached)")
            return rec

    runs, reason = cell_status(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "multi_pod": multi_pod, "ok": False}
    if not runs:
        rec.update({"skipped": True, "reason": reason, "ok": True})
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[SKIP-by-design] {arch} {shape_name}: {reason}")
        return rec

    t_start = time.time()
    try:
        attn_impl = cell_route(attn_impl, shape_name)
        cell = build_cell(arch, shape_name, mesh, attn_impl=attn_impl,
                          remat=remat, fsdp=fsdp, moe_ep=moe_ep)
        # the recorded collectives are the mesh's own: trace it again
        key = (arch, shape_name, attn_impl, remat, mesh_tag)
        if traced is not None and key in traced:
            # the program is the mesh's own; its arguments and their count
            # are the first mesh's
            args, st = traced[key]
            cell = dataclasses.replace(cell, abstract_args=args)
        else:
            st = cell.analyze()
            if traced is not None:
                traced[key] = (cell.abstract_args, st)
        trace_s = st.trace_s
        chips = mesh.size
        coll = {
            "per_device_wire_bytes": st.collective_bytes,
            "by_op_bytes": st.collective_by_op,
            "by_op_count": st.collective_count,
            "by_site_bytes": dict(cell.policy.log.wire),
            "by_site_count": dict(cell.policy.log.count),
            "basis": "ring wire bytes one device sends (all-reduce 2 S "
                     "(n - 1) / n, reduce-scatter S (n - 1) / n of an "
                     "S-byte operand, all-gather (n - 1) S of an S-byte "
                     "block), recorded by the policy's hooks on the mesh "
                     "description",
        }
        roof = Roofline(chips=chips, hlo_flops=st.flops, hlo_bytes=st.bytes,
                        collective_bytes=st.collective_bytes * chips,
                        model_flops=cell.model_flops)
        args_dev = argument_bytes_per_device(cell, st)
        args_global = sum(t.numel() * t.element_size()
                          for t in leaves(cell.abstract_args)
                          if isinstance(t, torch.Tensor))
        temps = max(st.peak_live_bytes - args_global, 0)
        rec.update({
            "ok": True,
            "attn_impl": attn_impl,
            "chips": chips,
            "trace_s": trace_s,
            "aten_ops": st.ops,
            "argument_bytes_per_device": args_dev,
            "peak_live_bytes": st.peak_live_bytes,
            "per_device_estimate": {
                "bytes": args_dev + temps / chips,
                "basis": "arguments laid out by their specs + the global "
                         "program's peak temporaries / chips (an even "
                         "split; no SPMD program was compiled)",
            },
            "static_per_device": {
                "flops": st.flops / chips,
                "bytes": st.bytes / chips,
                "basis": "the global program's counts / chips (an even split)",
            },
            "kernels": st.kernels,
            "collectives": coll,
            "collectives_reason": collectives_reason(cell),
            "roofline": roof.as_dict(),
            "t_bound": roof.t_bound,
        })
        print(f"[ok] {arch} {shape_name} {mesh_tag}: trace {trace_s:.1f}s "
              f"flops {st.flops:.3e} bytes {st.bytes:.3e} "
              f"bound={roof.bound} t_bound {roof.t_bound * 1e3:.3f} ms "
              f"useful={roof.useful_flops_ratio:.3f} "
              f"args/dev {args_dev / 2**30:.3f} GiB")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update({"error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[FAIL] {arch} {shape_name} {mesh_tag}: {type(e).__name__}: {e}")
    rec["wall_s"] = time.time() - t_start
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true", help="run 1-pod and 2-pod")
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--force", action="store_true", help="ignore cached results")
    ap.add_argument("--attn-impl", default="torch",
                    help="the programs' route: torch (the reference's xla), "
                         "naive, or cuda / flash: the kernels' route of each "
                         "kind (flash for train cells, cuda for serving)")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--dp-tp", default=None,
                    help="override per-pod (data,model) split, e.g. 64,4")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="serving layout: params TP-only (no data-axis shard)")
    ap.add_argument("--no-moe-ep", action="store_true",
                    help="expert-TP instead of expert-parallel MoE sharding")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both else [args.multi_pod]
    dp_tp = tuple(int(x) for x in args.dp_tp.split(",")) if args.dp_tp else None

    n_fail = 0
    skipped = set()
    traced: dict = {}
    t0 = time.time()
    for a in archs:
        for s in shapes:
            for mp in meshes:
                rec = run_cell(a, s, multi_pod=mp, out_dir=args.out,
                               skip_existing=not args.force,
                               attn_impl=args.attn_impl, remat=args.remat,
                               dp_tp=dp_tp, fsdp=not args.no_fsdp,
                               moe_ep=not args.no_moe_ep, traced=traced)
                n_fail += not rec.get("ok")
                if rec.get("skipped"):
                    skipped.add((a, s))
            traced.clear()
    print(f"dryrun finished: {n_fail} failures, {len(skipped)} cells skipped "
          f"by design, {time.time() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
