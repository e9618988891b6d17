#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device   — needs ``torch.cuda.is_available()``; prints the card's name and
              power limit as ``nvidia-smi`` reports them.  f32 comparisons
              run with TF32 off (``torch.backends.cuda.matmul.allow_tf32``
              and ``torch.backends.cudnn.allow_tf32`` both False).
2. build    — builds the CUDA kernels from ``src/repro_torch/csrc``.
3. kernels  — each kernel against its plain PyTorch version at the serving
              path's shapes plus windowed, q_offset, ragged, pos = -1 and
              wrapped-ring cases.  Tolerance: max abs error <= 1e-4 in f32
              (only the summation order differs) and <= 2e-2 in bf16 (the
              output is rounded to bf16 once, about 2^-8 of its magnitude).
              Times the kernel, the plain version and one PyTorch library
              call (``scaled_dot_product_attention``, a yardstick only).
4. model    — full-width qwen3-0.6b cut to 2 layers, f32: prefill + 4 decode
              steps with attn_impl="cuda" against attn_impl="torch"; logits
              within 2e-3 max abs, greedy tokens identical.
5. serve    — the main path: full qwen3-0.6b (28 layers, bf16, seeded random
              weights) behind ``ContinuousBatcher`` in dense mode, 16
              requests after a short warm-up; every request completes and
              the launch counters show that every prefill and decode step
              went through the kernels.
6. trace    — the first rounds of the same requests, untraced and under
              ``torch.profiler``: device busy time, idle share and device
              time by kernel class.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_TOL, BF16_TOL, MODEL_TOL = 1e-4, 2e-2, 2e-3


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def device_ms(fn, arg_sets, iters: int = 40) -> float:
    """Mean device time of ``fn(*args)`` in ms, cycling through ``arg_sets``
    (copies whose total exceeds the 50 MB L2, so each call finds its inputs
    cold, as the serving path does).  The stream is first held by a spin
    kernel so the host enqueues every launch before the first one runs: the
    events then bracket device time, not Python launch overhead."""
    import torch

    for args in arg_sets:
        fn(*args)                              # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)             # ~0.1 s of spinning
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_over_l2(tensors, l2_bytes: int = 50 * 2**20):
    one = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, -(-2 * l2_bytes // max(one, 1)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _rand(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def check_flash(gen):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    def run_case(name, B, Sq, Sk, H, Hkv, dh, dtype, *, window=None,
                 q_offset=0, causal=True):
        q = _rand(gen, (B, Sq, H, dh), dtype)
        k = _rand(gen, (B, Sk, Hkv, dh), dtype)
        v = _rand(gen, (B, Sk, Hkv, dh), dtype)
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
        want = ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, q_offset=q_offset).transpose(1, 2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        log(f"  flash {name:<28} max_abs_err={err:.3e} (tol {tol:g})")
        check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite output")
        check(err <= tol, f"flash {name}: max abs error {err} > {tol}")
        return err, (q, k, v)

    f32, bf16 = torch.float32, torch.bfloat16
    main = dict(B=8, Sq=256, Sk=256, H=16, Hkv=8, dh=128)
    err, (q, k, v) = run_case("main bf16", dtype=bf16, **main)
    run_case("main f32", dtype=f32, **main)
    run_case("window=64 f32", dtype=f32, window=64, **main)
    run_case("q_offset=200 f32", 2, 100, 300, 16, 8, 128, f32, q_offset=200)
    run_case("ragged Sq=Sk=77 f32", 3, 77, 77, 16, 8, 128, f32)
    run_case("ragged+window+offset f32", 2, 130, 200, 16, 8, 128, f32,
             q_offset=70, window=50)
    run_case("gqa 8:1 dh=64 bf16", 2, 96, 96, 8, 1, 64, bf16)

    # timings at the serving path's prefill shape (B=8 rows of 256, bf16)
    B, S, H, Hkv, dh = 8, 256, 16, 8, 128
    sets = copies_over_l2([q, k, v])
    kernel = device_ms(lambda a, b, c: ops.flash_attention(a, b, c), sets)
    plain = device_ms(
        lambda a, b, c: ref.flash_attention_ref(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2)), sets)
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    library = device_ms(
        lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=True, enable_gqa=True), lib_sets)
    pairs = S * (S + 1) // 2                    # causal (row, col) pairs
    n_bytes = 2 * (2 * B * S * H * dh + 2 * B * S * Hkv * dh)   # q, out, k, v
    flops = 4.0 * dh * pairs * B * H            # QK^T and PV
    bms, by = bound_ms(n_bytes, flops)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:99",
                max_abs_err=err, ms=kernel, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=library)


def _ring_pos(rng, B, C, cur, *, holes: float = 0.0):
    """pos (B, C) int32 of a ring that has seen positions 0..cur[b]: slot c
    holds the newest position p <= cur with p % C == c, or -1."""
    c = np.arange(C)[None, :]
    cur = np.asarray(cur)[:, None]
    pos = cur - ((cur - c) % C)
    pos = np.where(pos >= 0, pos, -1)
    if holes:
        pos = np.where(rng.random((B, C)) < holes, -1, pos)
    return pos.astype(np.int32)


def check_decode(gen):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops, ref

    rng = np.random.default_rng(0)

    def run_case(name, B, C, H, Hkv, dh, dtype, cur, *, window=None,
                 holes=0.0):
        q = _rand(gen, (B, H, dh), dtype)
        k = _rand(gen, (B, C, Hkv, dh), dtype)
        v = _rand(gen, (B, C, Hkv, dh), dtype)
        pos = torch.from_numpy(_ring_pos(rng, B, C, cur, holes=holes)).cuda()
        cur_t = torch.as_tensor(np.asarray(cur, np.int32)).cuda()
        got = ops.decode_attention(q, k, v, pos, cur_t, window=window)
        want = ref.decode_attention_ref(q, k, v, pos, cur_t, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        log(f"  decode {name:<27} max_abs_err={err:.3e} (tol {tol:g})")
        check(bool(torch.isfinite(got).all()), f"decode {name}: non-finite output")
        check(err <= tol, f"decode {name}: max abs error {err} > {tol}")
        return err, (q, k, v, pos, cur_t)

    f32, bf16 = torch.float32, torch.bfloat16
    B, C, H, Hkv, dh = 8, 322, 16, 8, 128
    cur = rng.integers(256, 320, size=B)       # prompt 256 + decode so far
    err, (q, k, v, pos, cur_t) = run_case("main bf16", B, C, H, Hkv, dh, bf16, cur)
    run_case("main f32", B, C, H, Hkv, dh, f32, cur)
    run_case("pos=-1 holes f32", B, C, H, Hkv, dh, f32, cur, holes=0.3)
    run_case("wrapped ring window=64 f32", B, 64, H, Hkv, dh, f32,
             rng.integers(100, 300, size=B), window=64)
    run_case("wrapped ring no window f32", 4, 100, H, Hkv, dh, f32,
             rng.integers(150, 400, size=4))
    run_case("gqa 16:1 dh=64 bf16", 4, 130, 16, 1, 64, bf16,
             rng.integers(0, 129, size=4), holes=0.2)

    sets = copies_over_l2([q, k, v, pos, cur_t])
    kernel = device_ms(lambda *a: ops.decode_attention(*a), sets)
    plain = device_ms(lambda *a: ref.decode_attention_ref(*a), sets)
    valid = (pos >= 0) & (pos <= cur_t[:, None])

    def lib_args(s):
        qq, kk, vv, pp, cc = s
        mask = ((pp >= 0) & (pp <= cc[:, None]))[:, None, None, :]
        return (qq[:, :, None, :].contiguous(), kk.transpose(1, 2).contiguous(),
                vv.transpose(1, 2).contiguous(), mask)

    library = device_ms(
        lambda a, b, c, m: F.scaled_dot_product_attention(
            a, b, c, attn_mask=m, enable_gqa=True),
        [lib_args(s) for s in sets])
    n_valid = int(valid.sum().item())          # slots this data attends to
    n_bytes = (2 * B * H * dh * 2              # q in, out
               + n_valid * Hkv * dh * 2 * 2    # valid K and V rows
               + B * C * 4 + B * 4)            # pos, cur
    flops = 4.0 * dh * H * n_valid             # q·k and p·v per q head
    bms, by = bound_ms(n_bytes, flops)
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention/kernel.py:76",
                max_abs_err=err, ms=kernel, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=library)


# ---------------------------------------------------------------------------
# phase 4: the model through the kernels against the plain path
# ---------------------------------------------------------------------------


def check_model():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, 0, device="cuda")
    B, S, steps = 4, 64, 4
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)).cuda()
    runs = {}
    for impl in ("cuda", "torch"):
        logits, caches = prefill(params, toks, cfg, max_len=S + steps + 1,
                                 impl=impl)
        runs[impl] = [logits, caches]
    worst = 0.0
    cur = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for step in range(steps + 1):
        lk, lt = runs["cuda"][0], runs["torch"][0]
        err = (lk - lt).abs().max().item()
        worst = max(worst, err)
        tk = torch.argmax(lk[:, :cfg.vocab], -1).to(torch.int32)
        tt = torch.argmax(lt[:, :cfg.vocab], -1).to(torch.int32)
        check(err <= MODEL_TOL, f"model step {step}: logits differ by {err}")
        check(bool((tk == tt).all()), f"model step {step}: greedy tokens differ")
        if step == steps:
            break
        for impl in ("cuda", "torch"):
            runs[impl][0], runs[impl][1] = decode_step(
                params, tt, runs[impl][1], cur, cfg, impl=impl)
        cur = cur + 1
    log(f"  prefill + {steps} decode steps, 2 layers f32: max |logit diff| "
        f"{worst:.3e} (tol {MODEL_TOL:g}), greedy tokens identical")
    del params, runs


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------


def _requests(cfg, n=16, seed=0):
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(32, 257))
        max_new = int(rng.integers(16, 65))
        prompt = rng.integers(1, cfg.vocab, size=plen).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new=max_new))
    return reqs


def _batcher(params, cfg, reqs):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(
        params, cfg, ServingConfig(slots=8, prompt_len=256, max_len=322, chunk=8))
    for r in reqs:
        batcher.submit(r)
    return batcher


def _serve(params, cfg, reqs):
    batcher = _batcher(params, cfg, reqs)
    return batcher, batcher.run()


def serve_main_path(card: str):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import init_params

    cfg = get_config("qwen3-0.6b")
    params = init_params(cfg, 0, device="cuda")
    # warm-up: first-use costs (cuBLAS handles, lazily loaded GEMM kernels)
    # stay out of the measured run
    t0 = time.perf_counter()
    _serve(params, cfg, _requests(cfg, n=8, seed=1))
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s")

    reqs = _requests(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.flash_attention.launches = 0
    da_ops.decode_attention.launches = 0
    t0 = time.perf_counter()
    _, stats = _serve(params, cfg, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa_n = fa_ops.flash_attention.launches
    da_n = da_ops.decode_attention.launches

    for r in reqs:
        check(r.done and not r.dropped, f"request {r.rid} did not complete")
        check(len(r.out) == r.max_new, f"request {r.rid}: {len(r.out)} tokens, "
              f"expected {r.max_new}")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"request {r.rid}: token outside the vocab")
    L = cfg.n_layers
    check(stats.prefills > 0 and stats.steps > 0, "nothing was served")
    check(fa_n == L * stats.prefills,
          f"flash_attention launches {fa_n} != {L} x {stats.prefills} prefills")
    check(da_n == L * stats.steps,
          f"decode_attention launches {da_n} != {L} x {stats.steps} steps")
    check(stats.dispatches == stats.prefills + stats.chunks,
          "dispatches != prefills + chunks")
    check(stats.host_syncs == stats.prefills + stats.chunks,
          "host syncs != one per admission + one per chunk")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {stats.completed}/16 requests, {stats.tokens} tokens, "
        f"{stats.prefills} prefills, {stats.chunks} chunks, {stats.steps} "
        f"decode steps in {wall:.3f} s [{card}]")
    log(f"  tokens/s={stats.tokens / wall:.1f} dispatches_per_token="
        f"{stats.dispatches_per_token:.4f} peak_memory="
        f"{peak / 2**30:.3f} GiB [{card}]")
    log(f"  launches: flash_attention={fa_n} (= {L} x {stats.prefills}), "
        f"decode_attention={da_n} (= {L} x {stats.steps})")
    return {"flash_attention": fa_n, "decode_attention": da_n}, (params, cfg)


# ---------------------------------------------------------------------------
# phase 6: where the time goes (a traced window of the same requests)
# ---------------------------------------------------------------------------


_KERNEL_CLASSES = (("flash_attention", ("fa_kernel",)),
                   ("decode_attention", ("dec_kernel",)),
                   # cuBLASLt's Hopper GEMMs are named nvjet_*
                   ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "cublas",
                                        "nvjet")))


def _rounds(params, cfg, n_rounds: int) -> float:
    """Wall time of the first ``n_rounds`` scheduling rounds of the main
    path's request set (admission of 8, then chunks), ending in a sync."""
    import torch

    batcher = _batcher(params, cfg, _requests(cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        batcher.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def trace_main_path(card: str, params, cfg, n_rounds: int = 3):
    """The first rounds of the main path, once untraced and once under
    ``torch.profiler`` (device activity only): device busy time (union of
    kernel intervals), the idle share against the untraced window's wall
    time, and device time by kernel class."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    clean = _rounds(params, cfg, n_rounds)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = _rounds(params, cfg, n_rounds)
    spans, by_class, by_name = [], {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        if end <= start:
            continue
        spans.append((start, end))
        name = evt.name.lower()
        cls = "other (elementwise, reductions, copies)"
        for label, keys in _KERNEL_CLASSES:
            if any(k in name for k in keys):
                cls = label
                break
        by_class[cls] = by_class.get(cls, 0.0) + (end - start)
        by_name[evt.name] = by_name.get(evt.name, 0.0) + (end - start)
    log(f"  profiler post-processing {time.perf_counter() - t0 - traced:.1f} s")
    if not spans:
        log("  device time not measured: the profiler saw no CUDA kernels")
        return
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    busy_s = busy * 1e-6
    log(f"  first {n_rounds} rounds: {len(spans)} device kernels, device busy "
        f"{busy_s * 1e3:.1f} ms; wall {clean:.3f} s untraced ({traced:.3f} s "
        f"traced) -> device idle share {1 - busy_s / clean:.3f} [{card}]")
    total = sum(by_class.values())
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"    {cls:<42} {us * 1e-3:9.2f} ms  {us / total:6.1%} of kernel time")
    log("  top kernels by device time:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us * 1e-3:9.2f} ms  {us / total:6.1%}  {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this smoke test runs on a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    log("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")

    log("phase 2: build")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load_library()
    log(f"  built {_build.LIB_NAME} in {time.perf_counter() - t0:.1f} s")
    for line in "\n".join(_build.BUILD_LOG).splitlines():
        if "registers" in line or "spill" in line or "==" in line:
            log("  " + line.strip())

    log("phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = [check_flash(gen), check_decode(gen)]

    log("phase 4: model (cuda kernels) against the plain path")
    check_model()
    torch.cuda.empty_cache()

    log("phase 5: main path, qwen3-0.6b behind ContinuousBatcher")
    launches, (params, cfg) = serve_main_path(card)

    log("phase 6: where the time goes")
    trace_main_path(card, params, cfg)

    for row in rows:
        row["launches"] = launches[row["name"]]
        log(f"  {row['name']}: {row['ms'] * 1e3:.1f} us kernel, "
            f"{row['plain_ms'] * 1e3:.1f} us plain, {row['library_ms'] * 1e3:.1f}"
            f" us library, bound {row['bound_ms'] * 1e3:.2f} us "
            f"({row['bound_by']}) [{card}]")
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
