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
              paths' shapes plus edge cases (flash: windowed, q_offset,
              ragged, GQA 8:1 at dh=64, dh=32, each in f32 and bf16, the
              two dtypes taking different kernels; dense decode: pos = -1,
              wrapped ring, and the split pass and merge with C not a
              multiple of the split, C below one split, a split whose
              slots are all masked, a row with no valid slot, a window
              ring wrapping across a split boundary and GQA 16:1, in f32
              and bf16; paged: holes, a cur_pos sweep across
              page boundaries, a fully unmapped slot, GQA 16:1, with the
              trash page poisoned to 1e4, and the page split (a split
              whose pages are all holes, more splits than mapped pages,
              pages of 4 and 8), in f32 and bf16; verify: the same, a row 0 without
              keys, W = 2, 6 and 8, dh 32 and 64, and the page split
              (windows across split boundaries, more splits than mapped
              pages, 32 rows a kv head), in f32 and bf16; prefix: ragged
              Lp and Sq, q_offset > 0, Lp = 0, GQA 8:1 at dh=64, in f32
              and bf16, the two dtypes taking different kernels; SSD scan
              (bf16 through its five passes, f32 through its f32 kernel,
              each case's route logged and checked): the
              admission shape (also as views of one xBC tensor, as the SSM
              block passes them), S not a multiple of the chunk, S < chunk, a
              single chunk, G = 2, large dt where exp(cum) underflows,
              slow decay (dt ~ 1e-3, the carried state matters) at the
              admission shape and at chunk 32, and every (hd, N) it
              takes; rmsnorm: the qwen3-0.6b admission (2048, 1024),
              decode (8, 1024) and q/k-norm (32768, 128) rows, d = 4096,
              5120 and 12288, d = 130 and a view off the 16-byte boundary,
              f32 and bf16, mixed x and scale dtypes, each case's route
              logged and checked (rows in registers except d = 130 and
              the view, which take the two-pass kernel);
              matmul: (2048, 1024) @ (1024, 3072), (2048, 3072) @
              (3072, 1024), (8, 1024) @ (1024, 3072) and a ragged
              (100, 300) @ (300, 72), bf16 -> bf16, bf16 -> f32 and
              f32 -> f32; each case's route logged and checked: bf16
              through wgmma + TMA except the ragged case, which TMA
              cannot describe, and f32 on the CUDA cores; the host time
              of a launch on each route).  Tolerance: max abs error <= 1e-4 in
              f32 (only the summation order differs) and <= 2e-2 in bf16
              (the output is rounded to bf16 once, about 2^-8 of its
              magnitude); rmsnorm's error is relative where the output
              exceeds 1; the SSD scan's and matmul's errors are relative
              to the plain version's largest magnitude (see ``check_ssd``
              and ``check_matmul``: matmul <= 1e-5 at f32 output, <= 8e-3
              at bf16).  Times the kernel, the plain version and one
              PyTorch library call (``scaled_dot_product_attention``,
              after a torch page gather for the paged kernel;
              ``F.rms_norm``; ``torch.matmul``; a yardstick only; no
              PyTorch call computes the SSD scan).  Flash, dense decode,
              paged decode, verify and prefix also take group 1 (H = Hkv =
              16, dh 128, deepseek-moe-16b's heads) in f32 and bf16, and
              their bf16 times at group 1 are logged beside the PyTorch
              call's.
4. model    — full-width qwen3-0.6b cut to 2 layers, f32: prefill + 4 decode
              steps with attn_impl="cuda" against attn_impl="torch"; the
              same decode on a shuffled paged pool (``page_table=``); one
              ``verify_step`` window on the pool, kernel against plain and
              each row against the sequential decode steps; and
              ``prefix_prefill`` through the prefix kernel against a cold
              prefill.  Full-width mamba2-370m cut to 2 layers, f32:
              with Mamba-2's dt and A init: prefill (SSD kernel) + 4
              decode steps against the plain path, and decode of token
              S + 1 against a prefill over S + 1.
              Logits within 2e-3 max abs, greedy tokens identical.
4c. moe     — deepseek-moe-16b and mixtral-8x22b at full width, each
              freed before the next: cut to 2 layers in f32 with phase 4's
              rule (logits within 2e-3, greedy tokens identical), then in
              bf16, deepseek at full depth (28 layers, 64 routed experts
              top-6 + 2 shared) and mixtral cut to 2 layers, against two
              plain routes ("torch" and "naive"): logits finite and the
              kernels' within ``MOE_SPREAD`` x the plain routes' own
              difference (see ``check_moe_model``).  A prefill of 2 x 256
              tokens and 4 decode steps each; the flash and decode kernels
              launched once a layer on the cuda route only.
5. serve    — the dense main path: full qwen3-0.6b (28 layers, bf16, seeded
              random weights) behind ``ContinuousBatcher`` in dense mode, 16
              requests after a short warm-up; every request completes and
              the launch counters show that every prefill and decode step
              went through the kernels.
5b. paged   — the paged main path: the same model behind a paged batcher
              with the prefix cache (128 pages of 16, below the 168 of dense
              capacity), 16 requests sharing a 192-token system prompt;
              every request completes, prefixes hit, every admission went
              through the flash or the prefix kernel and every decode step
              through the paged kernel, and the page ledger balances.
5c. spec    — the speculative path: phase 5b's batcher with speculative
              decode (windows of 4) and overlap, 16 requests whose tails
              repeat a phrase; every request completes, every verify window
              went through the verify kernel, the device-counted accepted
              drafts equal the host's, admission overlapped decode, the
              ledger balances.  Token identity with a non-speculative run
              of the same requests is reported (bf16 sums differ in order),
              with both runs' tokens/s and the batcher's host time per
              verify window and per decode step.
              A dense leg of 4 requests shows no verify kernel on rings.
5d. mamba2  — the Mamba-2 path: full mamba2-370m (48 layers, bf16, seeded
              random weights) behind ``ContinuousBatcher`` in dense mode,
              16 prompts of 300-1024 tokens left-padded to 1024; every
              request completes, every admission scanned through the SSD
              kernel's bf16 passes (48 calls each, five kernels a call),
              no attention kernel ran, one
              dispatch and one host sync per admission and per chunk.
5e. tenancy — two qwen3-0.6b tenants on one card through the hypervisor
              (``VirtualAcceleratorPool`` of 16 logical cores over cuda:0
              with 256 kv pages, ``make_serving_hypervisor(policy=
              "priority")``): the static stage warms the tenant program
              ``matmul(rmsnorm(x, s), w)`` (x (2048, 1024), w (1024, 3072),
              bf16) for lease sizes 12 and 16; alice (12 cores, the
              program) and bob (4 cores) each serve 16 requests on a paged
              batcher; bob drains and departs, and alice's regrow to 16
              cores lands between two of her chunks and migrates her live
              state.  Every request completes, alice's tokens equal an
              uninterrupted run's, the regrow hits the program cache, every
              kv lease change reaches ``set_page_limit`` and no batcher
              outgrows its lease, the pool's isolation and bandwidth
              invariants hold, rmsnorm and matmul launch in the static
              stage and after the regrow (the rmsnorm on its register
              route, the matmul on its wgmma route),
              and the program's output agrees
              with its plain version.  Prints the static stage's seconds
              per lease size beside the regrow's ``t_context``.
5f. guards  — phase 5b's batcher and requests with ``audit=True,
              watchdog_s=5.0``: after two clean rounds (one host sync per
              admission and per chunk), an out-of-range id in a live
              slot's page table, then a live slot mapping another live
              slot's private page, then a synthetic 6 s stall blamed on a
              third live slot, one round apart.  Every request completes
              its ``max_new`` tokens; the audit repairs at least 3
              entries, quarantines exactly the stolen page (in no table
              row, not on the free stack), the watchdog trips once, mapped,
              free, shared and quarantined pages partition the pool and the
              ledger checks; every admission went through the flash or the
              prefix kernel and every decode step through the paged decode
              kernel.  Token identity with phase 5b for the requests never
              requeued is reported, not gated.
5g. moe     — full deepseek-moe-16b, its weights made once for three legs:
              phase 5's dense batcher and 16 requests, phase 5b's paged
              batcher and requests (prefix cache), and 4 of phase 5c's
              requests with speculation and overlap (2 arriving after the
              first round, so their admission runs behind a chunk).  Every
              request completes its ``max_new``; one dispatch (plus page
              pushes) and one host sync per admission and per chunk; each
              leg's kernels launched 28 x their calls and no other
              attention kernel; the page ledger balances; ``init_params`` peaks
              below 1.1 x the weights and each leg below weights + its
              cache + 10 % of the weights (all three printed).  Reports
              tokens/s and the wall ms of a dense decode step beside the
              floor to read the routed experts once.
6. trace    — the first rounds of the dense, the paged, the spec, the
              Mamba-2 and the MoE path,
              all untraced first, then each under ``torch.profiler``: device
              busy time, idle share and device time by kernel class; the
              dense path must run the tensor-core flash kernel and the
              decode split and merge kernels, the paged path the former,
              the tensor-core prefix kernel and the paged decode split and
              merge kernels, the spec path the verify
              split (tensor-core) and merge kernels and the prefix kernel,
              the Mamba-2 path the SSD's five bf16 passes; the MoE path
              (phase 5g's dense leg, with its host ops traced) splits out
              the expert products and the dispatch ops by the profiler
              ranges of ``models/moe.py``, and a window of its pure decode
              chunks (8 requests admitted before it opens), split the same
              way, gives the device ms of a decode step.  Each window's
              batcher is built before the window opens.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --memory

runs phase 1 and only the memory probe of phase 5 (device memory of one
dense admission prefill at the main path's shape), against the
``src/repro_torch`` beside the script: a copy of the script placed in
another checkout measures that checkout.

    python3 chip_smoke.py --kernel-times

runs phase 1 and times the flash, dense decode, prefix, paged verify,
SSD scan (on views of one xBC tensor), matmul (the tenant program's
shape and a decode-shaped one), paged decode and rmsnorm (the tenant
program's (2048, 1024)) kernels, their plain versions and their
PyTorch calls at the main paths' bf16 shapes (phase 3's timings without
its correctness cases), against
the ``src/repro_torch`` beside the script: a copy in another checkout
times that checkout's kernels, so two trees compare in turns in one chip
call.  Prints one JSON line ``{"kernel_times": ...}``.

    python3 chip_smoke.py --ssd-faults

runs phase 1 and then checks the SSD checks themselves: it builds copies of
the SSD kernel with planted faults (``SSD_FAULTS``, in the bf16 passes and
in the f32 kernel: the inter-chunk term dropped, the carried state
dropped, carried without its decay, far key tiles skipped, and in the
passes a chunk's own state not passed on) and exits non-zero unless each
fails a slow-decay case of phase 3; it also reports whether phase 4's
Mamba-2 check (f32) fails each.
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
# phase 4c at bf16: the kernels' logits may differ from each plain route by
# up to this multiple of the two plain routes' own difference (see
# check_moe_model)
MOE_SPREAD = 2.0


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
    # every mask case in both dtypes: bf16 takes the tensor-core kernel,
    # f32 the CUDA-core one
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        run_case(f"window=64 {tag}", dtype=dtype, window=64, **main)
        run_case(f"q_offset=200 {tag}", 2, 100, 300, 16, 8, 128, dtype,
                 q_offset=200)
        run_case(f"ragged Sq=Sk=77 {tag}", 3, 77, 77, 16, 8, 128, dtype)
        run_case(f"ragged+window+offset {tag}", 2, 130, 200, 16, 8, 128,
                 dtype, q_offset=70, window=50)
        run_case(f"gqa 8:1 dh=64 {tag}", 2, 96, 96, 8, 1, 64, dtype)
        run_case(f"dh=32 {tag}", 2, 100, 100, 4, 2, 32, dtype)
        # group 1 (H = Hkv = 16, deepseek-moe-16b's prefill)
        run_case(f"group 1 16:16 {tag}", dtype=dtype, **dict(main, Hkv=16))
    return dict(time_flash(q, k, v), max_abs_err=err)


def time_flash(q, k, v):
    """Kernel, plain and SDPA times (and the bound) at the serving path's
    prefill shape (B=8 rows of 256, bf16), from ``q, k, v`` there."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    B, S, H, dh = q.shape
    Hkv = k.shape[2]
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
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


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

    from repro_torch.kernels.decode_attention import kernel, ops, ref

    rng = np.random.default_rng(0)

    def run_case(name, B, C, H, Hkv, dh, dtype, cur, *, window=None,
                 holes=0.0, edit=None):
        q = _rand(gen, (B, H, dh), dtype)
        k = _rand(gen, (B, C, Hkv, dh), dtype)
        v = _rand(gen, (B, C, Hkv, dh), dtype)
        pos_np = _ring_pos(rng, B, C, cur, holes=holes)
        if edit is not None:
            edit(pos_np, kernel.plan_splits(B, C, Hkv)[1])
        pos = torch.from_numpy(pos_np).cuda()
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

    def empty_split_1(pos, split_len):         # a split whose slots are masked
        pos[:, split_len:2 * split_len] = -1

    def empty_row_0(pos, split_len):           # a row with no valid slot
        pos[0] = -1

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
    # the split pass and the merge (kernel.plan_splits picks split_len)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        run_case(f"split: C=100 ragged {tag}", 2, 100, H, Hkv, dh, dtype,
                 [99, 150])
        run_case(f"split: C=20 < one {tag}", 2, 20, H, Hkv, dh, dtype, [7, 19])
        run_case(f"split: all masked {tag}", B, C, H, Hkv, dh, dtype, cur,
                 edit=empty_split_1)
        run_case(f"split: no valid slot {tag}", 3, 70, H, Hkv, dh, dtype,
                 [100, 69, 30], edit=empty_row_0)
        run_case(f"split: window wraps {tag}", 4, 48, H, Hkv, dh, dtype,
                 [70, 90, 100, 119], window=40)
        run_case(f"split: gqa 16:1 {tag}", 4, 130, 16, 1, 64, dtype,
                 [129, 60, 200, 5])
        # group 1: one query row a kv head in the m16 tile, twice the grid
        run_case(f"group 1 16:16 {tag}", B, C, H, H, dh, dtype, cur)
        run_case(f"group 1 holes {tag}", B, C, H, H, dh, dtype, cur,
                 holes=0.3)
    return dict(time_decode(q, k, v, pos, cur_t), max_abs_err=err)


def time_decode(q, k, v, pos, cur_t):
    """Kernel, plain and SDPA + mask times (and the bound) at the dense
    serving path's decode shape (B=8, C=322, bf16), from its inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops, ref

    B, H, dh = q.shape
    C, Hkv = k.shape[1], k.shape[2]
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
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


def group1_times(gen, rng):
    """The five attention kernels at group 1 (H = Hkv = 16, dh 128, bf16;
    deepseek-moe-16b's heads), every other dimension the main paths':
    kernel, plain and PyTorch-call times and the bound, one row each,
    named ``<kernel> group 1``."""
    import torch

    bf16 = torch.bfloat16
    B, S, H, dh, C = 8, 256, 16, 128, 322
    W, ps, maxp, P = 4, 16, 21, 168
    kp = _rand(gen, (P + 1, ps, H, dh), bf16)
    vp = _rand(gen, (P + 1, ps, H, dh), bf16)
    kp[P] = 1e4
    vp[P] = 1e4
    cur = rng.integers(256, 320, size=B)
    vcur = rng.integers(256, 322 - W + 1, size=B)
    rows = [
        time_flash(*(_rand(gen, (B, S, H, dh), bf16) for _ in range(3))),
        time_decode(_rand(gen, (B, H, dh), bf16),
                    _rand(gen, (B, C, H, dh), bf16),
                    _rand(gen, (B, C, H, dh), bf16),
                    torch.from_numpy(_ring_pos(rng, B, C, cur)).cuda(),
                    torch.as_tensor(np.asarray(cur, np.int32)).cuda()),
        time_paged_decode(
            _rand(gen, (B, H, dh), bf16), kp, vp,
            torch.from_numpy(_page_table(rng, B, maxp, P, cur, ps)).cuda(),
            torch.as_tensor(np.asarray(cur, np.int32)).cuda()),
        time_prefix(*(_rand(gen, shape, bf16) for shape in (
            (B, 64, H, dh), (B, 192, H, dh), (B, 192, H, dh), (B, 64, H, dh),
            (B, 64, H, dh)))),
        time_verify(
            _rand(gen, (B, W, H, dh), bf16), kp, vp,
            torch.from_numpy(
                _verify_table(rng, B, maxp, P, vcur, W, ps)).cuda(),
            torch.as_tensor(np.asarray(vcur, np.int32)).cuda()),
    ]
    for row in rows:
        row["name"] += " group 1"
    return rows


def _log_time_row(row, card: str) -> None:
    library = ("none" if row["library_ms"] is None
               else f"{row['library_ms'] * 1e3:.2f} us")
    extra = (f", {row['copy_ms'] * 1e3:.2f} us copy of x" if "copy_ms" in row
             else "")
    if "floor_ms" in row:
        extra += f", {row['floor_ms'] * 1e3:.2f} us one-element fill"
    log(f"  {row['name']}: {row['ms'] * 1e3:.2f} us kernel, "
        f"{row['plain_ms'] * 1e3:.2f} us plain, {library} library{extra}, "
        f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}) [{card}]")


def kernel_times(card: str) -> int:
    """``--kernel-times``: the flash, dense decode, prefix, paged verify,
    SSD scan, matmul, paged decode and rmsnorm kernels, their plain
    versions and their PyTorch calls at the main paths' bf16 shapes (the
    matmul also decode-shaped), timed against the ``src/repro_torch``
    beside this script, without the correctness cases: a copy of the
    script placed in another checkout (e.g. the parent commit unpacked
    with ``git archive``) times that checkout's kernels, so two trees
    compare in turns within one chip call.  It calls only the ``ops`` and
    ``ref`` functions every tree since the matmul kernel's port has."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    B, S, H, Hkv, dh, C = 8, 256, 16, 8, 128, 322
    flash = time_flash(_rand(gen, (B, S, H, dh), bf16),
                       _rand(gen, (B, S, Hkv, dh), bf16),
                       _rand(gen, (B, S, Hkv, dh), bf16))
    cur = rng.integers(256, 320, size=B)
    decode = time_decode(
        _rand(gen, (B, H, dh), bf16), _rand(gen, (B, C, Hkv, dh), bf16),
        _rand(gen, (B, C, Hkv, dh), bf16),
        torch.from_numpy(_ring_pos(rng, B, C, cur)).cuda(),
        torch.as_tensor(np.asarray(cur, np.int32)).cuda())
    Sq, Lp = 64, 192                           # a cached admission
    prefix = time_prefix(*(_rand(gen, shape, bf16) for shape in (
        (B, Sq, H, dh), (B, Lp, Hkv, dh), (B, Lp, Hkv, dh), (B, Sq, Hkv, dh),
        (B, Sq, Hkv, dh))))
    W, ps, maxp, P = 4, 16, 21, 168            # a verify window
    kp = _rand(gen, (P + 1, ps, Hkv, dh), bf16)
    vp = _rand(gen, (P + 1, ps, Hkv, dh), bf16)
    kp[P] = 1e4
    vp[P] = 1e4
    cur = rng.integers(256, 322 - W + 1, size=B)
    verify = time_verify(
        _rand(gen, (B, W, H, dh), bf16), kp, vp,
        torch.from_numpy(_verify_table(rng, B, maxp, P, cur, W, ps)).cuda(),
        torch.as_tensor(np.asarray(cur, np.int32)).cuda())
    ssd = time_ssd(_ssd_inputs(gen, *(SSD_MAIN[k] for k in (
        "B", "S", "nh", "hd", "G", "N")), bf16, 1.0, xbc=True),
        SSD_MAIN["chunk"])
    mm = time_matmul(_rand(gen, (2048, 1024), bf16),
                     _rand(gen, (1024, 3072), bf16))
    mm_decode = time_matmul(_rand(gen, (8, 1024), bf16),
                            _rand(gen, (1024, 3072), bf16))
    mm_decode["name"] = "matmul (8, 1024) @ (1024, 3072)"
    cur = rng.integers(256, 322, size=B)       # a paged decode step
    paged = time_paged_decode(
        _rand(gen, (B, H, dh), bf16), kp, vp,
        torch.from_numpy(_page_table(rng, B, maxp, P, cur, ps)).cuda(),
        torch.as_tensor(np.asarray(cur, np.int32)).cuda())
    rms = time_rmsnorm(_rand(gen, (2048, 1024), bf16),
                       _rand(gen, (1024,), bf16))
    rows = [flash, decode, prefix, verify, ssd, mm, mm_decode, paged, rms]
    rows += group1_times(gen, rng)
    for row in rows:
        _log_time_row(row, card)
    print(json.dumps({"kernel_times": {"root": str(ROOT), "card": card,
                                       "rows": rows}}), flush=True)
    return 0


def _err(got, want) -> float:
    """Max abs error, relative where |want| > 1 (the poisoned trash page
    of the paged checks averages to 1e4, where f32 keeps ~1e-3 abs)."""
    return ((got.float() - want.float()).abs()
            / want.float().abs().clamp(min=1.0)).max().item()


def _page_table(rng, B, max_pages, n_pages, cur, ps, *, holes=0.0):
    """A shuffled (B, max_pages) int32 table: slot b maps logical pages
    0..cur[b] // ps to distinct random pool pages, later pages unmapped
    (-1); ``holes`` unmaps earlier pages at random, never the page that
    holds cur[b]."""
    perm = rng.permutation(n_pages)
    table = np.full((B, max_pages), -1, np.int32)
    for b in range(B):
        last = int(cur[b]) // ps
        ids = perm[b * max_pages:b * max_pages + last + 1]
        table[b, :last + 1] = ids
        if holes:
            drop = rng.random(last) < holes
            table[b, :last][drop] = -1
    return table


def check_paged_decode(gen):
    import torch

    from repro_torch.kernels.paged_attention import kernel, ops, ref

    rng = np.random.default_rng(2)

    def pools(P, ps, Hkv, dh, dtype):
        kp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
        vp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
        kp[P] = 1e4                    # poisoned trash page: leaks are loud
        vp[P] = 1e4
        return kp, vp

    def run_case(name, B, H, Hkv, dh, ps, max_pages, P, dtype, cur, *,
                 holes=0.0, table=None):
        q = _rand(gen, (B, H, dh), dtype)
        kp, vp = pools(P, ps, Hkv, dh, dtype)
        if table is None:
            table = _page_table(rng, B, max_pages, P, cur, ps, holes=holes)
        tab = torch.from_numpy(table).cuda()
        cur_t = torch.as_tensor(np.asarray(cur, np.int32)).cuda()
        got = ops.paged_decode_attention(q, kp, vp, tab, cur_t)
        want = ref.paged_decode_attention_ref(q, kp, vp, tab, cur_t)
        torch.cuda.synchronize()
        err = _err(got, want)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        log(f"  paged {name:<28} max_abs_err={err:.3e} (tol {tol:g})")
        check(bool(torch.isfinite(got).all()), f"paged {name}: non-finite output")
        check(err <= tol, f"paged {name}: max abs error {err} > {tol}")
        return err, (q, kp, vp, tab, cur_t)

    f32, bf16 = torch.float32, torch.bfloat16
    # the paged main path: 8 slots of up to 21 pages of 16 over 168 pages
    B, H, Hkv, dh, ps, maxp, P = 8, 16, 8, 128, 16, 21, 168
    cur = rng.integers(256, 322, size=B)       # prompt 256 + decode so far
    err, main = run_case("main bf16", B, H, Hkv, dh, ps, maxp, P, bf16, cur)
    run_case("main f32", B, H, Hkv, dh, ps, maxp, P, f32, cur)
    run_case("holes f32", B, H, Hkv, dh, ps, maxp, P, f32, cur, holes=0.3)
    for c in (14, 15, 16, 17, 31, 32):         # across page boundaries
        run_case(f"cur_pos={c} sweep f32", 2, H, Hkv, dh, ps, 4, 8, f32,
                 [c, c])
    unmapped = np.full((2, maxp), -1, np.int32)
    unmapped[1, :3] = [5, 9, 2]
    run_case("fully unmapped slot f32", 2, H, Hkv, dh, ps, maxp, 16, f32,
             [40, 40], table=unmapped)
    run_case("gqa 16:1 dh=64 f32", 4, 16, 1, 64, ps, maxp, 96, f32,
             rng.integers(0, 330, size=4), holes=0.2)
    run_case("gqa 16:1 dh=128 bf16", 4, 16, 1, 128, 8, 12, 64, bf16,
             rng.integers(0, 96, size=4))
    # the page split (kernel.plan_page_splits: 6 splits of 4 pages at the
    # main shape): a split whose pages are all holes, more splits than
    # mapped pages, and pages of 4 and 8 (a 32-row tile over 8 or 4 pages)
    n_split, pps = kernel.plan_page_splits(B, Hkv, maxp)
    check((n_split, pps) == (6, 4), f"paged decode split {(n_split, pps)}")
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        skipped = _page_table(rng, B, maxp, P, cur, ps)
        skipped[:, pps:2 * pps] = -1           # split 1 sees no key
        run_case(f"split all skipped {tag}", B, H, Hkv, dh, ps, maxp, P,
                 dtype, cur, table=skipped)
        run_case(f"splits > mapped pages {tag}", B, H, Hkv, dh, ps, maxp, P,
                 dtype, rng.integers(0, 40, size=B))
        for small in (4, 8):                   # 96 positions, 4 slots
            run_case(f"page size {small} {tag}", 4, H, Hkv, dh, small,
                     96 // small, 4 * 96 // small, dtype,
                     rng.integers(0, 96, size=4), holes=0.2)
        # group 1: twice the kv heads, so fewer and longer splits
        _, pps1 = kernel.plan_page_splits(B, H, maxp)
        skipped1 = _page_table(rng, B, maxp, P, cur, ps)
        skipped1[:, pps1:2 * pps1] = -1        # split 1 sees no key
        run_case(f"group 1 16:16 {tag}", B, H, H, dh, ps, maxp, P, dtype, cur)
        run_case(f"group 1 split all skipped {tag}", B, H, H, dh, ps, maxp, P,
                 dtype, cur, table=skipped1)
    return dict(time_paged_decode(*main), max_abs_err=err)


def time_paged_decode(q, kp, vp, tab, cur_t):
    """Kernel, plain and page gather + SDPA times (and the bound) at the
    paged serving path's decode shape (B=8, 21 pages of 16, bf16), from
    its inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops, ref

    B, H, dh = q.shape
    P, ps, Hkv = kp.shape[0] - 1, kp.shape[1], kp.shape[2]
    maxp = tab.shape[1]
    sets = copies_over_l2([q, kp, vp, tab, cur_t])
    kernel = device_ms(lambda *a: ops.paged_decode_attention(*a), sets)
    plain = device_ms(lambda *a: ref.paged_decode_attention_ref(*a), sets)
    L = maxp * ps

    def library_call(qq, kk, vv, tt, cc):
        # a torch page gather, then SDPA with a boolean mask
        mapped = tt >= 0
        g = torch.where(mapped, tt, P).long()
        kg = kk[g].reshape(B, L, Hkv, dh).transpose(1, 2)
        vg = vv[g].reshape(B, L, Hkv, dh).transpose(1, 2)
        pos = torch.arange(L, device=qq.device)
        valid = mapped[:, pos // ps] & (pos[None, :] <= cc[:, None])
        return F.scaled_dot_product_attention(
            qq[:, :, None, :], kg, vg, attn_mask=valid[:, None, None, :],
            enable_gqa=True)

    library = device_ms(library_call, sets)
    pos = torch.arange(L, device="cuda")
    n_valid = int(((tab >= 0)[:, pos // ps] & (pos[None, :] <= cur_t[:, None]))
                  .sum().item())              # (slot, key) pairs attended
    n_bytes = (2 * B * H * dh * 2                       # q in, out
               + n_valid * Hkv * dh * 2 * 2             # valid K and V rows
               + B * maxp * 4 + B * 4)                  # table, cur_pos
    flops = 4.0 * dh * H * n_valid
    bms, by = bound_ms(n_bytes, flops)
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/csrc/paged_decode_attention.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:91",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


def check_prefix(gen):
    import torch

    from repro_torch.kernels.prefix_attention import ops, ref

    def run_case(name, B, Sq, Lp, Sk, H, Hkv, dh, dtype, *, q_offset=0):
        q = _rand(gen, (B, Sq, H, dh), dtype)
        pk = _rand(gen, (B, Lp, Hkv, dh), dtype)
        pv = _rand(gen, (B, Lp, Hkv, dh), dtype)
        k = _rand(gen, (B, Sk, Hkv, dh), dtype)
        v = _rand(gen, (B, Sk, Hkv, dh), dtype)
        got = ops.prefix_flash_attention(q, pk, pv, k, v, q_offset=q_offset)
        want = ref.prefix_flash_attention_ref(q, pk, pv, k, v,
                                              q_offset=q_offset)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        log(f"  prefix {name:<27} max_abs_err={err:.3e} (tol {tol:g})")
        check(bool(torch.isfinite(got).all()), f"prefix {name}: non-finite output")
        check(err <= tol, f"prefix {name}: max abs error {err} > {tol}")
        return err, (q, pk, pv, k, v)

    f32, bf16 = torch.float32, torch.bfloat16
    # cached admission on the paged main path: 12 cached pages of 16 and a
    # 64-token suffix
    B, Sq, Lp, H, Hkv, dh = 8, 64, 192, 16, 8, 128
    err, main = run_case("main bf16", B, Sq, Lp, Sq, H, Hkv, dh, bf16)
    run_case("main f32", B, Sq, Lp, Sq, H, Hkv, dh, f32)
    run_case("ragged Lp=77 Sq=45 f32", 3, 45, 77, 45, H, Hkv, dh, f32)
    run_case("q_offset=30 f32", 2, 40, 100, 70, H, Hkv, dh, f32, q_offset=30)
    run_case("no prefix Lp=0 f32", 2, 50, 0, 50, H, Hkv, dh, f32)
    run_case("gqa 8:1 dh=64 bf16", 2, 96, 64, 96, 8, 1, 64, bf16)
    run_case("gqa 8:1 dh=64 ragged f32", 2, 33, 21, 33, 8, 1, 64, f32)
    # the bf16 route (tensor cores) on the f32 route's edge cases
    run_case("ragged Lp=77 Sq=45 bf16", 3, 45, 77, 45, H, Hkv, dh, bf16)
    run_case("q_offset=30 bf16", 2, 40, 100, 70, H, Hkv, dh, bf16, q_offset=30)
    run_case("no prefix Lp=0 bf16", 2, 50, 0, 50, H, Hkv, dh, bf16)
    run_case("gqa 8:1 dh=64 ragged bf16", 2, 33, 21, 33, 8, 1, 64, bf16)
    run_case("dh=32 Lp=130 q_offset=7 bf16", 2, 70, 130, 77, 4, 2, 32, bf16,
             q_offset=7)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        run_case(f"group 1 16:16 {tag}", B, Sq, Lp, Sq, H, H, dh, dtype)
        run_case(f"group 1 ragged q_offset=30 {tag}", 2, 40, 100, 70, H, H, dh,
                 dtype, q_offset=30)
    return dict(time_prefix(*main), max_abs_err=err)


def time_prefix(q, pk, pv, k, v):
    """Kernel, plain and SDPA times (and the bound) at the paged path's
    cached-admission shape (B=8, 64 suffix rows over Lp=192, bf16), from its
    inputs; only the ``ops`` API, so a copy of this script times another
    checkout's kernel."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.prefix_attention import ops, ref

    B, Sq, H, dh = q.shape
    Lp, Hkv = pk.shape[1], pk.shape[2]
    sets = copies_over_l2([q, pk, pv, k, v])
    kernel = device_ms(lambda *a: ops.prefix_flash_attention(*a), sets)
    plain = device_ms(lambda *a: ref.prefix_flash_attention_ref(*a), sets)
    rows = torch.arange(Sq, device="cuda")
    cols = torch.arange(Lp + Sq, device="cuda") - Lp
    mask = cols[None, :] <= rows[:, None]

    def lib_args(s):
        q, pk, pv, k, v = s
        return (q.transpose(1, 2).contiguous(),
                torch.cat([pk, k], 1).transpose(1, 2).contiguous(),
                torch.cat([pv, v], 1).transpose(1, 2).contiguous())

    library = device_ms(
        lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, attn_mask=mask, enable_gqa=True),
        [lib_args(s) for s in sets])
    n_bytes = 2 * (2 * B * Sq * H * dh + 2 * B * (Lp + Sq) * Hkv * dh)
    pairs = Sq * Lp + Sq * (Sq + 1) // 2        # prefix + causal suffix
    flops = 4.0 * dh * pairs * B * H
    bms, by = bound_ms(n_bytes, flops)
    return dict(name="prefix_flash_attention", route="cuda",
                source="src/repro_torch/csrc/prefix_flash_attention.cu",
                replaces="src/repro/kernels/prefix_attention/kernel.py:94",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


def _verify_table(rng, B, max_pages, n_pages, cur, W, ps, *, holes=0.0):
    """A shuffled table that maps every page a window at ``cur`` reaches
    (positions through cur + W - 1, within the table), holes as in
    :func:`_page_table`."""
    last = np.minimum(np.asarray(cur) + W - 1, max_pages * ps - 1)
    return _page_table(rng, B, max_pages, n_pages, last, ps, holes=holes)


def check_paged_verify(gen):
    import torch

    from repro_torch.kernels.paged_attention import kernel, ops, ref

    rng = np.random.default_rng(5)

    def run_case(name, B, W, H, Hkv, dh, ps, max_pages, P, dtype, cur, *,
                 holes=0.0, table=None):
        q = _rand(gen, (B, W, H, dh), dtype)
        kp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
        vp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
        kp[P] = 1e4                    # poisoned trash page: leaks are loud
        vp[P] = 1e4
        if table is None:
            table = _verify_table(rng, B, max_pages, P, cur, W, ps, holes=holes)
        tab = torch.from_numpy(table).cuda()
        cur_t = torch.as_tensor(np.asarray(cur, np.int32)).cuda()
        got = ops.paged_verify_attention(q, kp, vp, tab, cur_t)
        want = ref.paged_verify_attention_ref(q, kp, vp, tab, cur_t)
        torch.cuda.synchronize()
        err = _err(got, want)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        log(f"  verify {name:<27} max_abs_err={err:.3e} (tol {tol:g})")
        check(bool(torch.isfinite(got).all()), f"verify {name}: non-finite output")
        check(err <= tol, f"verify {name}: max abs error {err} > {tol}")
        return err, (q, kp, vp, tab, cur_t)

    f32, bf16 = torch.float32, torch.bfloat16
    # the speculative main path: windows of 4 on 8 slots of up to 21 pages
    # of 16 over 168 pages
    B, W, H, Hkv, dh, ps, maxp, P = 8, 4, 16, 8, 128, 16, 21, 168
    cur = rng.integers(256, 322 - W + 1, size=B)
    err, main = run_case("main bf16", B, W, H, Hkv, dh, ps, maxp, P, bf16, cur)
    run_case("main f32", B, W, H, Hkv, dh, ps, maxp, P, f32, cur)
    run_case("holes f32", B, W, H, Hkv, dh, ps, maxp, P, f32, cur, holes=0.3)
    for c in (12, 13, 14, 15, 16, 29, 31):     # windows across page boundaries
        run_case(f"cur_pos={c} sweep f32", 2, W, H, Hkv, dh, ps, 4, 8, f32,
                 [c, c])
    unmapped = np.full((2, maxp), -1, np.int32)
    unmapped[1, :3] = [5, 9, 2]
    run_case("fully unmapped slot f32", 2, W, H, Hkv, dh, ps, maxp, 16, f32,
             [40, 40], table=unmapped)
    # row 0 has no key (its pages unmapped), the window's later rows do
    late = np.full((2, 4), -1, np.int32)
    late[:, 1] = [3, 6]
    run_case("row 0 without keys f32", 2, W, H, Hkv, dh, ps, 4, 8, f32,
             [14, 15], table=late)
    run_case("gqa 16:1 W=2 dh=64 f32", 4, 2, 16, 1, 64, ps, maxp, 96, f32,
             rng.integers(0, 330, size=4), holes=0.2)
    run_case("W=2 bf16", B, 2, H, Hkv, dh, ps, maxp, P, bf16, cur)
    run_case("W=8 f32", 4, 8, H, Hkv, dh, ps, maxp, 96, f32,
             rng.integers(0, 320, size=4), holes=0.2)
    run_case("dh=32 W=6 ps=4 f32", 3, 6, 4, 2, 32, 4, 12, 40, f32,
             rng.integers(0, 42, size=3), holes=0.2)
    run_case("dh=64 gqa 8:8 bf16", 3, 4, 8, 8, 64, 8, 6, 20, bf16,
             rng.integers(0, 44, size=3))
    # the bf16 route (tensor cores) on the f32 route's edge cases, and the
    # split: kernel.plan_page_splits gives the main shape 6 splits of 4
    # pages (64 positions), so these windows straddle split boundaries
    n_split, pps = kernel.plan_page_splits(B, Hkv, maxp)
    log(f"  verify main: {n_split} splits of {pps} pages")
    edges = np.asarray([62, 63, 64, 126, 127, 128, 190, 318])
    check(bool(((edges // (pps * ps)) != ((edges + W - 1) // (pps * ps)))
               .any()), "no window straddles a split boundary")
    run_case("holes bf16", B, W, H, Hkv, dh, ps, maxp, P, bf16, cur, holes=0.3)
    for c in (12, 13, 14, 15, 16, 29, 31):
        run_case(f"cur_pos={c} sweep bf16", 2, W, H, Hkv, dh, ps, 4, 8, bf16,
                 [c, c])
    run_case("fully unmapped slot bf16", 2, W, H, Hkv, dh, ps, maxp, 16, bf16,
             [40, 40], table=unmapped)
    run_case("row 0 without keys bf16", 2, W, H, Hkv, dh, ps, 4, 8, bf16,
             [14, 15], table=late)
    for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
        run_case(f"split boundaries {tag}", B, W, H, Hkv, dh, ps, maxp, P,
                 dtype, edges, holes=0.2)
        # most splits' pages are unmapped or past the window: skipped
        run_case(f"splits > mapped pages {tag}", B, W, H, Hkv, dh, ps, maxp,
                 P, dtype, rng.integers(0, 40, size=B))
        run_case(f"gqa 16:1 W=2 dh=128 {tag}", 4, 2, 16, 1, 128, ps, maxp, 96,
                 dtype, rng.integers(0, 330, size=4), holes=0.2)
        run_case(f"W=8 gqa 4:1 32 rows ps=8 {tag}", 4, 8, 16, 4, dh, 8, 40,
                 160, dtype, rng.integers(0, 310, size=4), holes=0.2)
        # group 1: W = 4 rows a kv head
        run_case(f"group 1 16:16 {tag}", B, W, H, H, dh, ps, maxp, P, dtype,
                 cur)
        run_case(f"group 1 split boundaries {tag}", B, W, H, H, dh, ps, maxp,
                 P, dtype, edges, holes=0.2)
    return dict(time_verify(*main), max_abs_err=err)


def time_verify(q, kp, vp, tab, cur_t):
    """Kernel, plain and page gather + SDPA times (and the bound) at the
    speculative path's verify shape (B=8, W=4 over 21 pages of 16, bf16),
    from its inputs; only the ``ops`` API, so a copy of this script times
    another checkout's kernel."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops, ref

    B, W, H, dh = q.shape
    P, ps, Hkv = kp.shape[0] - 1, kp.shape[1], kp.shape[2]
    maxp = tab.shape[1]
    sets = copies_over_l2([q, kp, vp, tab, cur_t])
    kernel = device_ms(lambda *a: ops.paged_verify_attention(*a), sets)
    plain = device_ms(lambda *a: ref.paged_verify_attention_ref(*a), sets)
    L = maxp * ps
    pos = torch.arange(L, device="cuda")
    wi = torch.arange(W, device="cuda")

    def library_call(qq, kk, vv, tt, cc):
        # a torch page gather, then SDPA with the (W, L) boolean mask
        mapped = tt >= 0
        g = torch.where(mapped, tt, P).long()
        kg = kk[g].reshape(B, L, Hkv, dh).transpose(1, 2)
        vg = vv[g].reshape(B, L, Hkv, dh).transpose(1, 2)
        valid = (mapped[:, pos // ps][:, None, :]
                 & (pos[None, None, :] <= (cc[:, None] + wi[None, :])[:, :, None]))
        return F.scaled_dot_product_attention(
            qq.transpose(1, 2), kg, vg, attn_mask=valid[:, None], enable_gqa=True)

    library = device_ms(library_call, sets)
    # bytes: q, out, the K/V rows some query of the window attends (the
    # last query's valid rows, which hold every other query's), the table
    # and cur_pos
    valid = ((tab >= 0)[:, pos // ps][:, None, :]
             & (pos[None, None, :] <= (cur_t[:, None] + wi[None, :])[:, :, None]))
    n_valid = int(valid.sum().item())          # (slot, w, key) pairs
    n_rows = int(valid[:, -1].sum().item())    # (slot, key) rows
    n_bytes = (2 * B * W * H * dh * 2                       # q in, out
               + n_rows * Hkv * dh * 2 * 2                  # K and V rows
               + B * maxp * 4 + B * 4)                      # table, cur_pos
    flops = 4.0 * dh * H * n_valid
    bms, by = bound_ms(n_bytes, flops)
    log(f"  verify main: {n_bytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP")
    return dict(name="paged_verify_attention", route="cuda",
                source="src/repro_torch/csrc/paged_verify_attention.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:195",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


def _rel_err(got, want) -> float:
    """Max abs error relative to the plain version's largest magnitude."""
    scale = want.float().abs().max().clamp(min=1e-30)
    return ((got.float() - want.float()).abs().max() / scale).item()


# The SSD scan's cases, as (name, shape, dtype, dt).  dt is a scale of
# softplus(randn) (about 0.8 a row: the chunk's decay exp(cum_L) is e^-20
# or less, so the carried state barely reaches the next chunk) or a
# (low, high) range dt is drawn from log-uniformly; the "slow decay" ranges
# put exp(cum_L) near 0.5, as Mamba-2's slow heads have it, so that y of
# every chunk after the first depends on the carried state and on the
# far-off key tiles of its own chunk.
SSD_MAIN = dict(B=8, S=1024, nh=32, hd=64, G=1, N=128, chunk=256)
SSD_REDUCED = dict(B=4, S=96, nh=8, hd=32, G=1, N=16, chunk=32)
SSD_SLOW = {256: (1e-4, 1e-2), 32: (1e-3, 1e-1)}    # chunk -> dt range


def _ssd_cases():
    import torch

    f32, bf16 = torch.float32, torch.bfloat16

    def shape(B, S, nh, hd, G, N, chunk):
        return dict(B=B, S=S, nh=nh, hd=hd, G=G, N=N, chunk=chunk)

    return [
        # every admission of the Mamba-2 path: 8 prompts of 1024 in 4 chunks
        ("main bf16", SSD_MAIN, bf16, 1.0),
        # the same as the SSM block hands it over: views of its conv output
        ("main bf16, xBC views", dict(SSD_MAIN, xbc=True), bf16, 1.0),
        ("main f32", SSD_MAIN, f32, 1.0),
        ("main slow decay bf16", SSD_MAIN, bf16, SSD_SLOW[256]),
        ("main slow decay f32", SSD_MAIN, f32, SSD_SLOW[256]),
        ("S=700 ragged tail f32", shape(2, 700, 8, 64, 1, 128, 256), f32, 1.0),
        ("S=100 < chunk f32", shape(2, 100, 8, 64, 1, 128, 256), f32, 1.0),
        ("single chunk S=256 bf16", shape(2, 256, 8, 64, 1, 128, 256), bf16,
         1.0),
        ("G=2 rep 4 f32", shape(2, 512, 8, 64, 2, 128, 128), f32, 1.0),
        ("large dt, exp(cum) underflows f32",
         shape(2, 512, 8, 64, 1, 128, 256), f32, 40.0),
        ("reduced hd=32 N=16 chunk=32 f32", SSD_REDUCED, f32, 1.0),
        ("reduced hd=32 N=16 chunk=32 bf16", SSD_REDUCED, bf16, 1.0),
        ("reduced slow decay f32", SSD_REDUCED, f32, SSD_SLOW[32]),
        ("reduced slow decay bf16", SSD_REDUCED, bf16, SSD_SLOW[32]),
        ("hd=32 N=128 chunk=64 f32", shape(2, 160, 4, 32, 2, 128, 64), f32,
         1.0),
        ("hd=64 N=16 chunk=48 f32", shape(2, 144, 4, 64, 1, 16, 48), f32, 1.0),
    ]


def _ssd_inputs(gen, B, S, nh, hd, G, N, dtype, dt, *, xbc=False):
    """x, dt, A, Bm, Cm of one case; with ``xbc``, x, Bm and Cm are views
    of one (B, S, nh hd + 2 G N) tensor, as the SSM block slices them out
    of its conv output ``xBC`` (row stride the conv width)."""
    import torch
    import torch.nn.functional as F

    x = (_rand(gen, (B, S, nh, hd), torch.float32) * 0.5).to(dtype)
    if isinstance(dt, tuple):
        lo, hi = dt
        u = torch.rand((B, S, nh), generator=gen, device="cuda")
        dts = lo * (hi / lo) ** u
    else:
        dts = F.softplus(_rand(gen, (B, S, nh), torch.float32)) * dt
    A = -torch.exp(_rand(gen, (nh,), torch.float32) * 0.5)
    Bm = (_rand(gen, (B, S, G, N), torch.float32) * 0.3).to(dtype)
    Cm = (_rand(gen, (B, S, G, N), torch.float32) * 0.3).to(dtype)
    if xbc:
        buf = torch.cat([t.reshape(B, S, -1) for t in (x, Bm, Cm)], dim=-1)
        d_in, gn = nh * hd, G * N
        x = buf[..., :d_in].view(B, S, nh, hd)
        Bm = buf[..., d_in:d_in + gn].view(B, S, G, N)
        Cm = buf[..., d_in + gn:].view(B, S, G, N)
    return x, dts, A, Bm, Cm


def _chunk_decay(dt, A, L):
    """exp(cum_L), the decay of the carried state over each whole chunk:
    its 10th, 50th and 90th percentiles."""
    import torch

    B, S, nh = dt.shape
    n = S // L * L
    total = (dt[:, :n] * A).reshape(B, -1, L, nh).sum(2)
    q = torch.tensor([0.1, 0.5, 0.9], device=dt.device)
    return torch.quantile(torch.exp(total).flatten(), q).tolist()


def _ssd_case(gen, shape, dtype, dt):
    """One case of the SSD scan (``ops.ssd``, the model-layout wrapper the
    SSM prefill calls) against ``ssd_chunked``, its plain version, on the
    same inputs: the errors of y and of the final state relative to the
    plain version's largest magnitude, and whether each is finite."""
    import torch

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models.ssm import ssd_chunked

    chunk = shape["chunk"]
    args = _ssd_inputs(gen, *(shape[k] for k in ("B", "S", "nh", "hd", "G",
                                                 "N")), dtype, dt,
                       xbc=shape.get("xbc", False))
    before = ops.ssd.launches
    routes = dict(ops.ssd.route_calls)
    y, st = ops.ssd(*args, chunk=chunk, return_state=True)
    routes = [k for k, n in ops.ssd.route_calls.items() if n != routes[k]]
    want_y, want_st = ssd_chunked(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    return dict(
        args=args, launched=ops.ssd.launches - before, routes=routes,
        shape_ok=y.shape == args[0].shape and y.dtype == dtype,
        finite=bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
        err_y=_rel_err(y, want_y), err_st=_rel_err(st, want_st),
        abs_y=(y.float() - want_y.float()).abs().max().item(),
        max_y=want_y.float().abs().max().item(),
        tol_y=BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
        decay=_chunk_decay(args[1], args[2], min(chunk, shape["S"])))


def _ssd_passes(r) -> bool:
    return (r["finite"] and r["err_y"] <= r["tol_y"]
            and r["err_st"] <= F32_TOL)


def check_ssd(gen):
    """The SSD scan against its plain version over :func:`_ssd_cases`: y
    and the final state.  Errors are relative to the plain version's
    largest magnitude: 1e-4 in f32 (only the summation order differs); in
    bf16 2e-2 for y, because the plain version rounds C.B^T, the scores and
    both halves of y to bf16 where the kernel keeps f32 and rounds y once
    (a few 2^-9 roundings of terms near |y|), and 1e-4 for the state, which
    both build in f32 from the same bf16 inputs.  The slow-decay cases must
    keep the chunk's median decay within [0.1, 0.9], or they would no
    longer test the carry.  bf16 cases take the kernel's five passes, f32
    ones its f32 kernel (``kernel.ssd_route``), as the route counters
    show; the main shape is timed on views of one ``xBC`` tensor, as the
    SSM block passes them."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_route

    for name, shape, dtype, dt in _ssd_cases():
        r = _ssd_case(gen, shape, dtype, dt)
        want = ssd_route(dtype)
        log(f"  ssd {name:<34} route {'+'.join(r['routes'])}; "
            f"y rel err={r['err_y']:.3e} (tol "
            f"{r['tol_y']:g}, abs {r['abs_y']:.3e} of max {r['max_y']:.3g}) "
            f"state rel err={r['err_st']:.3e} (tol {F32_TOL:g}); chunk decay "
            f"p10/p50/p90 {r['decay'][0]:.2g}/{r['decay'][1]:.2g}/"
            f"{r['decay'][2]:.2g}")
        check(r["launched"] == 1, f"ssd {name}: no kernel launch")
        check(r["routes"] == [want], f"ssd {name}: route {r['routes']}, "
              f"expected {want}")
        check(r["shape_ok"], f"ssd {name}: wrong shape or dtype of y")
        check(r["finite"], f"ssd {name}: non-finite output")
        check(r["err_y"] <= r["tol_y"],
              f"ssd {name}: y error {r['err_y']} > {r['tol_y']}")
        check(r["err_st"] <= F32_TOL,
              f"ssd {name}: state error {r['err_st']} > {F32_TOL}")
        if isinstance(dt, tuple):
            check(0.1 <= r["decay"][1] <= 0.9,
                  f"ssd {name}: median chunk decay {r['decay'][1]} outside "
                  f"[0.1, 0.9]")
        if name == "main bf16, xBC views":
            err, args = r["abs_y"], r["args"]
    torch.cuda.empty_cache()
    return dict(time_ssd(args, SSD_MAIN["chunk"]), max_abs_err=err)


def time_ssd(args, chunk):
    """Kernel and plain times (and the bound) of one ``ops.ssd`` call (a
    bf16 call launches five kernels) at the Mamba-2 path's admission shape
    (B=8, S=1024 in chunks of 256, nh=32, hd=64, G=1, N=128, bf16), from
    ``args`` there; no PyTorch call computes the scan."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models.ssm import ssd_chunked

    x, _, _, Bm, _ = args
    B, S, nh, hd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    sets = copies_over_l2(list(args))
    kernel = device_ms(lambda *a: ops.ssd(*a, chunk=L, return_state=True),
                       sets)
    plain = device_ms(lambda *a: ssd_chunked(*a, chunk=L, return_state=True),
                      sets)
    # bytes: x, dt, A, B, C read once (bf16 x, B, C; f32 dt, A), y written
    # once (bf16), the f32 final state written once
    n_bytes = (2 * B * S * nh * hd * 2 + B * S * nh * 4 + nh * 4
               + 2 * B * S * G * N * 2 + B * nh * hd * N * 4)
    # operations: the causal (row, col) pairs of each chunk: C.B^T once per
    # group, its product with x per head; the state read and update per head
    nc, pairs = S // L, L * (L + 1) // 2
    flops = 2.0 * B * nc * (G * pairs * N
                            + nh * (pairs * hd + 2 * L * N * hd))
    bms, by = bound_ms(n_bytes, flops)
    log(f"  ssd main: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP")
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan/kernel.py:85",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=None)


def check_rmsnorm(gen):
    """RMSNorm against its plain version at the qwen3-0.6b shapes (an
    admission's 2048 rows of d_model 1024, a decode step's 8, the q/k norm's
    32768 rows of d_head 128), at d = 4096, 5120 and 12288 (block-wide
    rows), and at d = 130 (scalar head and tail around the vectors) and on
    a row view one element off the 16-byte boundary, each case's route
    (``kernel.rmsnorm_route``) logged and checked: rows in registers
    wherever rows start on 16-byte boundaries and span a multiple of 16
    bytes, two passes elsewhere.  The error is ``_err``: absolute where the
    plain output is below 1, relative above, within ``F32_TOL`` /
    ``BF16_TOL``: both round the same f32 value to bf16 once, but their
    sums of squares differ in order, which can move an output across a
    rounding boundary, one bf16 step (2^-8 of its magnitude; outputs reach
    ~15 with a random scale)."""
    import torch

    from repro_torch.kernels.rmsnorm import ops, ref

    f32, bf16 = torch.float32, torch.bfloat16
    reg, two = "registers", "two_pass"
    # (name, shape, x dtype, scale dtype, route, one element off the boundary)
    cases = [("main (2048, 1024)", (2048, 1024), bf16, bf16, reg, False),
             ("main (2048, 1024)", (2048, 1024), f32, f32, reg, False),
             ("decode (8, 1024)", (8, 1024), bf16, bf16, reg, False),
             ("decode (8, 1024)", (8, 1024), f32, f32, reg, False),
             ("qk-norm (32768, 128)", (32768, 128), bf16, bf16, reg, False),
             ("qk-norm (32768, 128)", (32768, 128), f32, f32, reg, False),
             ("d=4096 (16, 4096)", (16, 4096), bf16, f32, reg, False),
             ("d=4096 (16, 4096)", (16, 4096), f32, bf16, reg, False),
             ("d=5120 (7, 5120)", (7, 5120), bf16, bf16, reg, False),
             ("d=5120 (7, 5120)", (7, 5120), f32, f32, reg, False),
             ("d=12288 (3, 12288)", (3, 12288), bf16, bf16, reg, False),
             ("d=12288 (3, 12288)", (3, 12288), f32, f32, reg, False),
             ("d=130 (33, 130)", (33, 130), bf16, bf16, two, False),
             ("d=130 (33, 130)", (33, 130), f32, f32, two, False),
             ("misaligned view (64, 256)", (64, 256), bf16, bf16, two, True),
             ("bf16 x, f32 scale (2048, 1024)", (2048, 1024), bf16, f32, reg,
              False),
             ("bf16 x, f32 scale (3, 130)", (3, 130), bf16, f32, two, False)]
    before = ops.rmsnorm.launches
    for name, shape, xdt, sdt, route, off in cases:
        if off:
            x = _rand(gen, (1 + shape[0] * shape[1],), xdt)[1:].view(shape)
        else:
            x = _rand(gen, shape, xdt)
        s = _rand(gen, (shape[-1],), sdt)
        routes = dict(ops.rmsnorm.route_launches)
        got = ops.rmsnorm(x, s)
        want = ref.rmsnorm_ref(x, s)
        torch.cuda.synchronize()
        err = _err(got, want)
        tol = BF16_TOL if xdt == bf16 else F32_TOL
        took = [k for k, n in ops.rmsnorm.route_launches.items()
                if n != routes[k]]
        log(f"  rmsnorm {name:<31} x {str(xdt)[6:]:<8} scale "
            f"{str(sdt)[6:]:<8} route {took} err={err:.3e} (tol {tol:g})")
        check(took == [route], f"rmsnorm {name}: route {took}, not {route}")
        check(got.shape == x.shape and got.dtype == x.dtype,
              f"rmsnorm {name}: wrong shape or dtype")
        check(bool(torch.isfinite(got).all()), f"rmsnorm {name}: non-finite")
        check(err <= tol, f"rmsnorm {name}: error {err} > {tol}")
        if name.startswith("main") and xdt == bf16:
            main_err, args = (got.float() - want.float()).abs().max().item(), (x, s)
    check(ops.rmsnorm.launches - before == len(cases),
          "rmsnorm: a case did not launch the kernel")
    return dict(time_rmsnorm(*args), max_abs_err=main_err)


def time_rmsnorm(x, s):
    """Kernel, plain and ``F.rms_norm`` times (and the bound) at the tenant
    program's shape ((2048, 1024), bf16), from its inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops, ref

    T, d = x.shape
    sets = copies_over_l2([x, s])
    kernel = device_ms(lambda x, s: ops.rmsnorm(x, s), sets)
    plain = device_ms(lambda x, s: ref.rmsnorm_ref(x, s), sets)
    library = device_ms(lambda x, s: F.rms_norm(x, (d,), s, eps=1e-6), sets)
    # a copy of x moves the same bytes; a one-element fill moves none: the
    # least device time of any launch under this timer
    copy = device_ms(lambda x, s: x.clone(), sets)
    one = torch.zeros(1, device=x.device)
    floor = device_ms(lambda x, s: one.fill_(1.0), sets)
    n_bytes = 2 * T * d * 2 + d * 2          # x read, y written, scale read
    flops = 4.0 * T * d                      # square, sum, two products
    bms, by = bound_ms(n_bytes, flops)
    return dict(name="rmsnorm", route="cuda",
                source="src/repro_torch/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm/kernel.py:36",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library, copy_ms=copy, floor_ms=floor)


def check_matmul(gen):
    """The tiled matmul against its plain version (``a.float() @ b.float()``,
    TF32 off) at the qwen3-0.6b admission's MLP shapes (2048 rows, d_model
    1024, d_ff 3072, both ways), a decode step's 8 rows, and a ragged
    (100, 300) @ (300, 72); bf16 -> bf16, bf16 -> f32 and f32 -> f32.  The
    error is relative to the plain version's largest magnitude: with K =
    3072 outputs reach ~50 and bf16's rounding of them alone exceeds the
    absolute ``BF16_TOL``.  Limits: 1e-5 at f32 output (only the summation
    order differs), 8e-3 at bf16 output (one rounding, 2^-9 of an output,
    and a flip across a rounding boundary).  The route counters must show
    the bf16 2048-row and decode cases on the ``wgmma`` route, the ragged
    case (a 600-byte row of a, which TMA cannot describe) and f32 on the
    CUDA cores.  Also logs the host time of a launch on each route: the
    ``wgmma`` route encodes two TMA tensor maps a call."""
    import torch

    from repro_torch.kernels.matmul import kernel, ops, ref

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [("admission up", 2048, 1024, 3072),
              ("admission down", 2048, 3072, 1024),
              ("decode", 8, 1024, 3072),
              ("ragged", 100, 300, 72)]
    kinds = [(bf16, bf16), (bf16, f32), (f32, f32)]
    before = ops.matmul.launches
    for name, M, K, N in shapes:
        for in_dt, out_dt in kinds:
            a = _rand(gen, (M, K), in_dt)
            b = _rand(gen, (K, N), in_dt)
            routes = dict(ops.matmul.route_launches)
            got = ops.matmul(a, b, out_dtype=out_dt)
            want = ref.matmul_ref(a, b, out_dtype=out_dt)
            torch.cuda.synchronize()
            route = [k for k, n in ops.matmul.route_launches.items()
                     if n != routes[k]]
            expected = ("wgmma" if in_dt == bf16 and name != "ragged"
                        else "cuda_core")
            err = _rel_err(got, want)
            tol = 8e-3 if out_dt == bf16 else 1e-5
            log(f"  matmul {name:<14} ({M}, {K}) @ ({K}, {N}) "
                f"{str(in_dt)[6:]:>8} -> {str(out_dt)[6:]:<8} route "
                f"{'+'.join(route):<9} rel err={err:.3e} (tol {tol:g}) of "
                f"max {want.float().abs().max().item():.3g}")
            check(route == [expected],
                  f"matmul {name}: route {route}, expected {expected}")
            check(got.shape == (M, N) and got.dtype == out_dt,
                  f"matmul {name}: wrong shape or dtype")
            check(bool(torch.isfinite(got).all()), f"matmul {name}: non-finite")
            check(err <= tol, f"matmul {name}: relative error {err} > {tol}")
            if name == "admission up" and in_dt == out_dt == bf16:
                main_err = (got.float() - want.float()).abs().max().item()
                args = (a, b)
    check(ops.matmul.launches - before == len(shapes) * len(kinds),
          "matmul: a case did not launch the kernel")

    a, b = _rand(gen, (128, 64), bf16), _rand(gen, (64, 128), bf16)
    host = {}
    for route in kernel.ROUTES:
        kernel.matmul_kernel(a, b, route=route)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            kernel.matmul_kernel(a, b, route=route)
        host[route] = (time.perf_counter() - t0) / 500
        torch.cuda.synchronize()
    log(f"  matmul host time a launch, (128, 64) @ (64, 128) bf16: wgmma "
        f"{host['wgmma'] * 1e6:.1f} us (two TMA maps encoded), CUDA cores "
        f"{host['cuda_core'] * 1e6:.1f} us")
    torch.cuda.empty_cache()
    return dict(time_matmul(*args), max_abs_err=main_err)


def time_matmul(a, b):
    """Kernel, plain and ``torch.matmul`` times (and the bound) of one
    ``ops.matmul`` call on bf16 ``a``, ``b``: the tenant program's (2048,
    1024) @ (1024, 3072), or a decode-shaped 8 rows."""
    import torch

    from repro_torch.kernels.matmul import ops, ref

    (M, K), N = a.shape, b.shape[1]
    sets = copies_over_l2([a, b])
    kernel = device_ms(lambda a, b: ops.matmul(a, b), sets, iters=20)
    plain = device_ms(lambda a, b: ref.matmul_ref(a, b), sets, iters=20)
    library = device_ms(lambda a, b: torch.matmul(a, b), sets, iters=20)
    n_bytes = (M * K + K * N + M * N) * 2     # a, b read, c written (bf16)
    flops = 2.0 * M * N * K
    bms, by = bound_ms(n_bytes, flops)
    log(f"  matmul main: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP; "
        f"kernel {kernel / library:.1f}x torch.matmul's time")
    return dict(name="matmul", route="cuda",
                source="src/repro_torch/csrc/matmul.cu",
                replaces="src/repro/kernels/matmul/kernel.py:50",
                ms=kernel, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library)


# Faults planted in a copy of ssd_scan.cu, as (name, original, fault), in
# the bf16 passes and in the f32 kernel: y without the inter-chunk term, a
# state passing that drops the carried state (keeping only the last
# chunk's own), one that keeps it without its decay, query tiles that skip
# every key tile more than one below the diagonal, and (bf16) a passing
# that never adds a chunk's own state.
SSD_FAULTS = (
    ("passes: reads no carried state",
     "const float e = i < L ? exp2f(cum_s[i] * LOG2E) : 0.f;",
     "const float e = 0.f;"),
    ("passes: drops the carried state",
     "st = st * et + states[o];", "st = states[o];"),
    ("passes: carries the state undecayed",
     "st = st * et + states[o];", "st = st + states[o];"),
    ("passes: skips the far key tiles",
     "const int k_first = 0;", "const int k_first = max(0, k_last - 1);"),
    ("passes: passes no chunk state on",
     "st = st * et + states[o];", "st = st * et;"),
    ("f32: reads no carried state",
     "const float e = (i < L) ? expf(s.cum[i]) : 0.f;",
     "const float e = 0.f;"),
    ("f32: drops the carried state",
     "*e = et * *e + sacc[a][c];", "*e = sacc[a][c];"),
    ("f32: carries the state undecayed",
     "*e = et * *e + sacc[a][c];", "*e = *e + sacc[a][c];"),
    ("f32: skips the far key tiles",
     "for (int k0 = 0; k0 < k_end; k0 += TK) {",
     "for (int k0 = max(0, q0 - TK); k0 < k_end; k0 += TK) {"),
)


def _build_fault(name, original, fault, out_dir):
    """Compile csrc/ssd_scan.cu with ``original`` replaced by ``fault`` into
    its own shared library under ``out_dir``; returns the started nvcc and
    the library's path."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "ssd_scan.cu").read_text()
    check(src.count(original) == 1, f"fault {name!r}: the line to replace "
          f"is not in ssd_scan.cu once")
    tag = name.replace(":", "").replace(" ", "_")
    cu = out_dir / f"ssd_scan_{tag}.cu"
    cu.write_text(src.replace(original, fault))
    lib = out_dir / f"libssd_{tag}.so"
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared",
           f"-I{_build.CSRC}", str(cu), "-o", str(lib)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def ssd_fault_check() -> int:
    """The kernel, then each fault of :data:`SSD_FAULTS` in its own build,
    run through the phase-3 SSD cases and phase 4's Mamba-2 check: the run
    fails unless the kernel passes them all and every fault fails some
    slow-decay case of phase 3.  Prints, for each fault and case, the
    errors against their tolerances, and phase 4's verdict."""
    import ctypes

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    out_dir = ROOT / "build" / "ssd_faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    builds = [(f[0], *_build_fault(*f, out_dir)) for f in SSD_FAULTS]
    libs = {"no fault": _build.load_library()}   # the kernel as it is
    for name, proc, path in builds:
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"fault {name!r} did not build:\n{out}")
        lib = ctypes.CDLL(str(path))
        lib.repro_ssd_scan.argtypes = _build.SIGNATURES["repro_ssd_scan"]
        lib.repro_ssd_scan.restype = ctypes.c_int
        libs[name] = lib
    log(f"  built the kernels and {len(SSD_FAULTS)} faulty copies in "
        f"{time.perf_counter() - t0:.1f} s")
    results, all_caught = {}, True
    real = ssd_kernel.load_library
    try:
        for name, lib in libs.items():
            ssd_kernel.load_library = lambda lib=lib: lib
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            fails, slow_fails = [], []
            for case, shape, dtype, dt in _ssd_cases():
                r = _ssd_case(gen, shape, dtype, dt)
                ok = _ssd_passes(r)
                log(f"  fault {name!r:<29} {case:<34} y rel err="
                    f"{r['err_y']:.3e} (tol {r['tol_y']:g}) state rel err="
                    f"{r['err_st']:.3e} -> {'passes' if ok else 'FAILS'}")
                if not ok:
                    fails.append(case)
                    if isinstance(dt, tuple):
                        slow_fails.append(case)
            try:
                check_mamba_model()
                model = "passes"
            except AssertionError as e:
                model = f"FAILS ({e})"
            log(f"  fault {name!r}: phase 4 Mamba-2 check {model}")
            caught = bool(slow_fails)
            if name == "no fault":           # the kernel must pass it all
                all_caught &= not fails and model == "passes"
            else:
                all_caught &= caught
            results[name] = dict(failed_cases=fails, phase4=model,
                                 caught=caught)
    finally:
        ssd_kernel.load_library = real
    print(json.dumps({"ssd_faults": results}))
    return 0 if all_caught else 1


# ---------------------------------------------------------------------------
# phase 4: the model through the kernels against the plain path
# ---------------------------------------------------------------------------


def check_model():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops
    from repro_torch.models import (
        decode_step, init_paged_caches, init_params, prefill, prefix_prefill,
        verify_step)
    from repro_torch.models.transformer import prefill_kv

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, 0, device="cuda")
    B, S, steps = 4, 64, 4
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)).cuda()

    def greedy(logits):
        return torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)

    # dense: prefill + decode through the kernels against the plain path
    runs = {}
    for impl in ("cuda", "torch"):
        logits, caches = prefill(params, toks, cfg, max_len=S + steps + 1,
                                 impl=impl)
        runs[impl] = [logits, caches]
    worst = 0.0
    dense_tokens, dense_logits = [], []
    cur = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for step in range(steps + 1):
        lk, lt = runs["cuda"][0], runs["torch"][0]
        err = (lk - lt).abs().max().item()
        worst = max(worst, err)
        tk, tt = greedy(lk), greedy(lt)
        check(err <= MODEL_TOL, f"model step {step}: logits differ by {err}")
        check(bool((tk == tt).all()), f"model step {step}: greedy tokens differ")
        dense_tokens.append(tt)
        dense_logits.append(lt)
        if step == steps:
            break
        for impl in ("cuda", "torch"):
            runs[impl][0], runs[impl][1] = decode_step(
                params, tt, runs[impl][1], cur, cfg, impl=impl)
        cur = cur + 1
    log(f"  dense: prefill + {steps} decode steps, 2 layers f32: max |logit "
        f"diff| {worst:.3e} (tol {MODEL_TOL:g}), greedy tokens identical")
    del runs

    # paged: the prompt's K/V packed into a shuffled pool, then the same
    # decode steps with page_table=, kernels against the plain path
    ps = 16
    max_pages = -(-(S + steps + 1) // ps)
    n_pages = B * max_pages
    table = torch.from_numpy(rng.permutation(n_pages).astype(np.int32)
                             .reshape(B, max_pages)).cuda()
    logits0, fresh = prefill_kv(params, toks, cfg, impl="torch")
    prompt_pages = table[:, :S // ps].reshape(-1).long()
    runs = {}
    for impl in ("cuda", "torch"):
        caches = init_paged_caches(cfg, B, n_pages, ps, device="cuda")
        for p, view in caches.kv.items():
            k, v = fresh[p]
            view.k[:, prompt_pages] = k.reshape(k.shape[0], -1, ps, *k.shape[3:])
            view.v[:, prompt_pages] = v.reshape(v.shape[0], -1, ps, *v.shape[3:])
        runs[impl] = [logits0, caches]
    before = pa_ops.paged_decode_attention.launches
    worst = 0.0
    cur = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for step in range(steps):
        for impl in ("cuda", "torch"):
            runs[impl][0], runs[impl][1] = decode_step(
                params, dense_tokens[step], runs[impl][1], cur, cfg,
                impl=impl, page_table=table)
        cur = cur + 1
        lk, lt = runs["cuda"][0], runs["torch"][0]
        err = (lk - lt).abs().max().item()
        worst = max(worst, err)
        check(err <= MODEL_TOL, f"paged step {step}: logits differ by {err}")
        check(bool((greedy(lk) == dense_tokens[step + 1]).all()),
              f"paged step {step}: greedy tokens differ from the dense run")
    check(pa_ops.paged_decode_attention.launches - before
          == cfg.n_layers * steps, "paged decode missed the kernel")
    log(f"  paged: {steps} decode steps on a shuffled pool of {n_pages} pages "
        f"of {ps}: max |logit diff| {worst:.3e} (tol {MODEL_TOL:g}), greedy "
        f"tokens identical to the dense run")
    del runs

    # verify: one window of the dense run's first `steps` tokens at S on a
    # fresh shuffled pool, through the verify kernel against the plain
    # path; row w against the dense run's logits after w + 1 decode steps
    window = torch.stack(dense_tokens[:steps], dim=1)          # (B, W)
    outs = {}
    for impl in ("cuda", "torch"):
        caches = init_paged_caches(cfg, B, n_pages, ps, device="cuda")
        for p, view in caches.kv.items():
            k, v = fresh[p]
            view.k[:, prompt_pages] = k.reshape(k.shape[0], -1, ps, *k.shape[3:])
            view.v[:, prompt_pages] = v.reshape(v.shape[0], -1, ps, *v.shape[3:])
        before = pa_ops.paged_verify_attention.launches
        outs[impl], _ = verify_step(
            params, window, caches, torch.full((B,), S, dtype=torch.int32,
                                               device="cuda"),
            cfg, impl=impl, page_table=table)
        ran = pa_ops.paged_verify_attention.launches - before
        check(ran == (cfg.n_layers if impl == "cuda" else 0),
              f"verify_step impl={impl}: {ran} verify kernel launches")
        del caches
    err = (outs["cuda"] - outs["torch"]).abs().max().item()
    check(err <= MODEL_TOL, f"verify_step: kernel and plain logits differ by {err}")
    seq = 0.0
    for w in range(steps):
        d = (outs["cuda"][:, w] - dense_logits[w + 1]).abs().max().item()
        seq = max(seq, d)
        check(d <= MODEL_TOL, f"verify row {w}: logits differ from {w + 1} "
              f"decode steps by {d}")
        check(bool((greedy(outs["cuda"][:, w]) == dense_tokens[w + 1]).all()),
              f"verify row {w}: greedy token differs from sequential decode")
    log(f"  verify: one window of {steps} on a shuffled pool, kernel against "
        f"the plain path: max |logit diff| {err:.3e}; rows against 1..{steps} "
        f"sequential decode steps: {seq:.3e} (tol {MODEL_TOL:g}), greedy "
        f"tokens identical")
    del outs

    # prefix: suffix prefill against the first 3 pages' K/V, through the
    # prefix kernel, against a cold prefill of the whole prompt
    Lp = 3 * ps
    cold, _ = prefill(params, toks, cfg, max_len=S, impl="cuda")
    _, pkv = prefill_kv(params, toks[:, :Lp], cfg, impl="cuda")
    before = pfx_ops.prefix_flash_attention.launches
    warm, _ = prefix_prefill(params, toks[:, Lp:], pkv, cfg, prefix_len=Lp,
                             impl="cuda")
    check(pfx_ops.prefix_flash_attention.launches - before == cfg.n_layers,
          "prefix_prefill missed the prefix kernel")
    err = (warm - cold).abs().max().item()
    check(err <= MODEL_TOL, f"prefix_prefill: logits differ by {err}")
    check(bool((greedy(warm) == greedy(cold)).all()),
          "prefix_prefill: next token differs from the cold prefill")
    log(f"  prefix: suffix {S - Lp} rows over a cached {Lp}: max |logit diff| "
        f"{err:.3e} against a cold prefill (tol {MODEL_TOL:g}), next token "
        f"identical")
    del params


def mamba2_dt_init(params, seed: int) -> None:
    """Set each SSM layer's ``dt_bias`` and ``A_log`` in place as Mamba-2
    initialises them: dt log-uniform over [1e-3, 1e-1] (``dt_bias`` its
    inverse softplus) and A uniform over [1, 16].  The port's init, like
    the reference's, has A = -1 and dt_bias = 0, so every head forgets its
    state within a few rows and a check could not see the carried state;
    the slow heads here keep it across a chunk of 256."""
    import math

    import torch

    rng = np.random.default_rng(seed)
    for block in params["blocks"]:
        ssm = block["ssm"]
        shape = tuple(ssm["dt_bias"].shape)
        dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), size=shape))
        ssm["dt_bias"].copy_(torch.from_numpy(dt + np.log(-np.expm1(-dt))))
        ssm["A_log"].copy_(torch.from_numpy(np.log(rng.uniform(1, 16,
                                                               size=shape))))


def check_mamba_model():
    """Full-width mamba2-370m cut to 2 layers, f32, with Mamba-2's own dt
    and A init (:func:`mamba2_dt_init`): prefill over a ragged S = 1000
    (four chunks of 256, the last padded; a state carried wrongly shows
    from the third) and 4 decode steps with impl="cuda" (the SSD kernel)
    against impl="torch"; then decode of token S + 1 after a prefill over
    S against a prefill over S + 1."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, 0, device="cuda")
    mamba2_dt_init(params, 1)
    B, S, steps = 4, 1000, 4
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab, size=(B, S + 1)).astype(np.int32)).cuda()

    def greedy(logits):
        return torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)

    runs = {}
    for impl in ("cuda", "torch"):
        before = ssd_ops.ssd.launches
        runs[impl] = list(prefill(params, toks[:, :S], cfg,
                                  max_len=S + steps + 1, impl=impl))
        ran = ssd_ops.ssd.launches - before
        check(ran == (cfg.n_layers if impl == "cuda" else 0),
              f"mamba prefill impl={impl}: {ran} ssd kernel launches")
    worst = 0.0
    cur = torch.full((B,), S, dtype=torch.int32, device=toks.device)
    for step in range(steps + 1):
        lk, lt = runs["cuda"][0], runs["torch"][0]
        err = (lk - lt).abs().max().item()
        worst = max(worst, err)
        tt = greedy(lt)
        check(err <= MODEL_TOL, f"mamba step {step}: logits differ by {err}")
        check(bool((greedy(lk) == tt).all()),
              f"mamba step {step}: greedy tokens differ")
        if step == steps:
            break
        for impl in ("cuda", "torch"):
            runs[impl][0], runs[impl][1] = decode_step(
                params, tt, runs[impl][1], cur, cfg, impl=impl)
        cur = cur + 1
    log(f"  mamba2: prefill S={S} + {steps} decode steps, 2 layers f32: max "
        f"|logit diff| {worst:.3e} (tol {MODEL_TOL:g}), greedy tokens "
        f"identical")
    del runs

    full, _ = prefill(params, toks, cfg, max_len=S + 2)
    _, caches = prefill(params, toks[:, :S], cfg, max_len=S + 2)
    step_logits, _ = decode_step(params, toks[:, S], caches,
                                 torch.full((B,), S, dtype=torch.int32,
                                            device=toks.device), cfg)
    err = (step_logits - full).abs().max().item()
    check(err <= MODEL_TOL, f"mamba decode after prefill: logits differ from "
          f"a prefill over S + 1 by {err}")
    check(bool((greedy(step_logits) == greedy(full)).all()),
          "mamba decode after prefill: next token differs")
    log(f"  mamba2: decode of token {S + 1} after a prefill over {S} against "
        f"a prefill over {S + 1}: max |logit diff| {err:.3e} (tol "
        f"{MODEL_TOL:g}), next token identical")
    del params


# ---------------------------------------------------------------------------
# phase 4c: the MoE family at full width through the kernels
# ---------------------------------------------------------------------------


def _attn_counters():
    """The five attention kernels' wrappers, each with its ``launches``."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops

    return {"flash_attention": fa_ops.flash_attention,
            "prefix_flash_attention": pfx_ops.prefix_flash_attention,
            "decode_attention": da_ops.decode_attention,
            "paged_decode_attention": pa_ops.paged_decode_attention,
            "paged_verify_attention": pa_ops.paged_verify_attention}


def _free_device_memory() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_moe_model(card: str, arch: str, *, n_layers=None,
                    dtype: str = "bfloat16"):
    """``arch`` at full width (cut to ``n_layers`` when given) in ``dtype``,
    from the port's ``init_params``: a prefill of 2 x 256 tokens and 4
    decode steps through the kernels (impl="cuda") and the plain path
    (impl="torch"), every route fed the plain path's greedy tokens, the
    flash and dense decode kernels launched once a layer on the cuda route
    only.

    f32 takes phase 4's rule: logits within ``MODEL_TOL``, greedy tokens
    identical.  bf16, the serving dtype, runs a second plain route
    (impl="naive") as well: over many layers the routes' roundings move
    some tokens' top-k experts, so even two plain routes disagree by more
    than a fixed tolerance could allow.  The kernels' logits must then lie
    as close to both plain routes as those do to each other: each
    difference, relative to the largest plain logit, within
    ``MOE_SPREAD`` x the plain routes' own (at least ``BF16_TOL``).  A
    kernel wrong at group 1 moves the logits by their own size.  Greedy
    token agreement is reported.  Frees the model after."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}, {cfg.n_layers} layers, {dtype}: params "
        f"{_gib(_param_bytes(params))} made in {time.perf_counter() - t0:.1f} "
        f"s [{card}]")
    B, S, steps = 2, 256, 4
    L = cfg.n_layers
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)).cuda()
    counters = _attn_counters()
    fa, da = counters["flash_attention"], counters["decode_attention"]
    impls = ("cuda", "torch") if dtype == "float32" else ("cuda", "torch",
                                                          "naive")

    def greedy(logits):
        return torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    runs = {}
    for impl in impls:
        fa.launches = 0
        runs[impl] = list(prefill(params, toks, cfg, max_len=S + steps + 1,
                                  impl=impl))
        check(fa.launches == (L if impl == "cuda" else 0),
              f"{cfg.name} prefill impl={impl}: {fa.launches} flash launches")
    worst, same = {}, {}
    cur = torch.full((B,), S, dtype=torch.int32, device=toks.device)
    for step in range(steps + 1):
        logits = {impl: runs[impl][0].float() for impl in impls}
        tt = greedy(logits["torch"])
        for impl in impls:
            check(bool(torch.isfinite(logits[impl]).all()),
                  f"{cfg.name} step {step} impl={impl}: non-finite logits")
            same[impl] = same.get(impl, 0) + int(
                (greedy(logits[impl]) == tt).sum())
        if dtype == "float32":
            err = (logits["cuda"] - logits["torch"]).abs().max().item()
            worst["cuda-torch"] = max(worst.get("cuda-torch", 0.0), err)
            check(err <= MODEL_TOL, f"{cfg.name} step {step}: logits differ "
                  f"by {err}")
            check(bool((greedy(logits["cuda"]) == tt).all()),
                  f"{cfg.name} step {step}: greedy tokens differ")
        else:
            d = {"cuda-torch": rel(logits["cuda"], logits["torch"]),
                 "cuda-naive": rel(logits["cuda"], logits["naive"]),
                 "naive-torch": rel(logits["naive"], logits["torch"])}
            for key, v in d.items():
                worst[key] = max(worst.get(key, 0.0), v)
            bound = MOE_SPREAD * max(d["naive-torch"], BF16_TOL)
            check(max(d["cuda-torch"], d["cuda-naive"]) <= bound,
                  f"{cfg.name} step {step}: the kernels' logits differ from "
                  f"the plain routes' by {d} (bound {bound:.3e})")
        if step == steps:
            break
        for impl in impls:
            da.launches = 0
            runs[impl][0], runs[impl][1] = decode_step(
                params, tt, runs[impl][1], cur, cfg, impl=impl)
            check(da.launches == (L if impl == "cuda" else 0),
                  f"{cfg.name} decode impl={impl}: {da.launches} decode "
                  f"launches")
        cur = cur + 1
    n = B * (steps + 1)
    rule = (f"tol {MODEL_TOL:g} abs" if dtype == "float32" else
            f"relative to the largest plain logit, bound {MOE_SPREAD:g} x "
            f"max(naive-torch, {BF16_TOL:g})")
    log(f"  {cfg.name}: prefill {B} x {S} + {steps} decode steps, {dtype}, "
        f"{L} layers: max logit differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" ({rule}); greedy tokens equal to the plain path's: "
        + ", ".join(f"{k} {v}/{n}" for k, v in same.items() if k != "torch")
        + f"; launches: flash {L} a prefill, decode {L} a step on the cuda "
        f"route [{card}]")
    del runs, params
    _free_device_memory()


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------


def _requests(cfg, n=16, seed=0, max_new=None):
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(32, 257))
        budget = int(rng.integers(16, 65))
        prompt = rng.integers(1, cfg.vocab, size=plen).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt,
                            max_new=max_new or budget))
    return reqs


def _admitted(batcher):
    """``batcher`` after its first round (the admission of every queued
    request that fits, and one chunk), synchronised."""
    import torch

    batcher.step()
    torch.cuda.synchronize()
    return batcher


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


def _gib(n_bytes: int) -> str:
    return f"{n_bytes / 2**30:.3f} GiB"


def _param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") else 0


def admission_memory(params, cfg, card: str, B: int = 8, S: int = 256,
                     max_len: int = 322):
    """Device memory of one dense admission prefill at the main path's
    shape (``prefill`` of B prompts of S tokens into rings of ``max_len``):
    the allocator's peak above the memory allocated at its start, and what
    its result (logits and rings) holds afterwards."""
    import torch

    from repro_torch.models import prefill

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    toks = torch.randint(1, cfg.vocab, (B, S), generator=gen, device="cuda",
                         dtype=torch.int32)
    out = prefill(params, toks, cfg, max_len=max_len)   # builds, warms up
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = prefill(params, toks, cfg, max_len=max_len)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    del out
    log(f"  one dense admission prefill (B={B}, S={S}, max_len={max_len}): "
        f"peak {peak / 2**20:.1f} MiB above its start, result holds "
        f"{held / 2**20:.1f} MiB [{card}]")
    return peak, held


def serve_main_path(card: str):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import init_params

    cfg = get_config("qwen3-0.6b")
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"  allocated after init_params: {_gib(torch.cuda.memory_allocated())} "
        f"(params {_gib(_param_bytes(params))})")
    # warm-up: first-use costs (cuBLAS handles, lazily loaded GEMM kernels)
    # stay out of the measured run
    t0 = time.perf_counter()
    _serve(params, cfg, _requests(cfg, n=8, seed=1))
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s; "
        f"allocated after it: {_gib(torch.cuda.memory_allocated())}")

    admission_memory(params, cfg, card)

    reqs = _requests(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
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
        f"{stats.dispatches_per_token:.4f} peak_memory={_gib(peak)} "
        f"({_gib(peak - base)} above the {_gib(base)} allocated at the start, "
        f"params {_gib(_param_bytes(params))}) [{card}]")
    log(f"  launches: flash_attention={fa_n} (= {L} x {stats.prefills}), "
        f"decode_attention={da_n} (= {L} x {stats.steps})")
    return {"flash_attention": fa_n, "decode_attention": da_n}, (params, cfg)


# ---------------------------------------------------------------------------
# phase 5b: the paged main path (paged pool + shared-prefix admission)
# ---------------------------------------------------------------------------


PAGED_CONFIG = dict(slots=8, prompt_len=256, max_len=322, chunk=8, paged=True,
                    page_size=16, n_pages=128, prefix_cache=True)


def _paged_requests(cfg, n=16, seed=0, namespace="tenant0"):
    """``n`` prompts of 256 tokens, one 192-token system prompt shared by
    all and a 64-token random tail each; ``max_new`` 16-64."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab, size=192).astype(np.int32)
    reqs = []
    for rid in range(n):
        tail = rng.integers(1, cfg.vocab, size=64).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=np.concatenate([system, tail]),
                            max_new=int(rng.integers(16, 65)),
                            namespace=namespace))
    return reqs


def _paged_batcher(params, cfg, reqs):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**PAGED_CONFIG))
    for r in reqs:
        batcher.submit(r)
    return batcher


def serve_paged_path(card: str, params, cfg):
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops

    t0 = time.perf_counter()
    _paged_batcher(params, cfg, _paged_requests(cfg, n=8, seed=1,
                                                namespace="warm-up")).run()
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s")

    reqs = _paged_requests(cfg)
    torch.cuda.synchronize()
    # the reset precedes the batcher, whose page pool then counts in the
    # peak above the start as phase 5's rings do
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batcher = _paged_batcher(params, cfg, reqs)
    torch.cuda.synchronize()
    counters = (fa_ops.flash_attention, pfx_ops.prefix_flash_attention,
                pa_ops.paged_decode_attention, da_ops.decode_attention)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    stats = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa_n, pfx_n, pa_n, da_n = (c.launches for c in counters)

    for r in reqs:
        check(r.done and not r.dropped, f"paged request {r.rid} did not complete")
        check(len(r.out) == r.max_new, f"paged request {r.rid}: {len(r.out)} "
              f"tokens, expected {r.max_new}")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"paged request {r.rid}: token outside the vocab")
    L = cfg.n_layers
    check(stats.prefills > 0 and stats.steps > 0, "nothing was served")
    check(stats.prefix_hits > 0, "no admission hit the prefix cache")
    check(pfx_n > 0, "no admission went through the prefix kernel")
    check(fa_n + pfx_n == L * stats.prefills,
          f"flash {fa_n} + prefix {pfx_n} launches != {L} x {stats.prefills} "
          f"prefills")
    check(pa_n == L * stats.steps,
          f"paged_decode_attention launches {pa_n} != {L} x {stats.steps} steps")
    check(da_n == 0, f"the dense decode kernel ran {da_n} times on the paged path")
    # a cache eviction is a dispatch (a page push) with no host sync
    check(stats.dispatches - batcher.page_pushes == stats.prefills + stats.chunks,
          "dispatches != prefills + chunks + page pushes")
    check(stats.host_syncs == stats.prefills + stats.chunks,
          "host syncs != one per admission + one per chunk")
    pool = batcher.kv_pool
    pool.check()
    free_top = int(batcher.pages.free_top)
    check(free_top + pool.shared == batcher.n_pages,
          f"free_top {free_top} + shared {pool.shared} != {batcher.n_pages} pages")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {stats.completed}/16 requests, {stats.tokens} tokens, "
        f"{stats.prefills} prefills ({stats.prefix_hits} prefix hits, "
        f"{stats.prefill_tokens_skipped} prompt tokens from shared pages), "
        f"{stats.chunks} chunks, {stats.steps} decode steps, "
        f"{batcher.page_pushes} page pushes in {wall:.3f} s [{card}]")
    log(f"  tokens/s={stats.tokens / wall:.1f} dispatches_per_token="
        f"{stats.dispatches_per_token:.4f} peak_memory={_gib(peak)} "
        f"({_gib(peak - base)} above the {_gib(base)} allocated at the start) "
        f"peak_pages_in_use={stats.peak_pages_in_use}/{batcher.n_pages} "
        f"[{card}]")
    log(f"  ledger: free_top {free_top} + shared {pool.shared} = "
        f"{batcher.n_pages} pages; launches: flash_attention={fa_n} + "
        f"prefix_flash_attention={pfx_n} (= {L} x {stats.prefills}), "
        f"paged_decode_attention={pa_n} (= {L} x {stats.steps}), "
        f"decode_attention={da_n}")
    return ({"flash_attention": fa_n, "prefix_flash_attention": pfx_n,
             "paged_decode_attention": pa_n},
            {r.rid: list(r.out) for r in reqs})


# ---------------------------------------------------------------------------
# phase 5c: the speculative path (draft-and-verify windows, overlap)
# ---------------------------------------------------------------------------


SPEC_CONFIG = dict(PAGED_CONFIG, speculative=True, draft_window=4, overlap=True)


def _spec_requests(cfg, n=16, seed=0, namespace="tenant0"):
    """``n`` prompts of 256 tokens: the 192-token system prompt of
    :func:`_paged_requests`, then a 64-token tail that repeats one 16-token
    phrase of its own four times (a tenant whose answers quote their input,
    as extraction or code editing do); ``max_new`` 16-64."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab, size=192).astype(np.int32)
    reqs = []
    for rid in range(n):
        phrase = rng.integers(1, cfg.vocab, size=16).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=np.concatenate([system] + [phrase] * 4),
                            max_new=int(rng.integers(16, 65)),
                            namespace=namespace))
    return reqs


def _spec_batcher(params, cfg, reqs, config=SPEC_CONFIG, telemetry=None):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**config),
                                telemetry=telemetry)
    for r in reqs:
        batcher.submit(r)
    return batcher


def _host_split(tracer, steps: int) -> str:
    """The batcher's own spans, per decode step or verify window: host time
    to enqueue the chunks (``dispatch``), host time blocked on their fetch
    (``host_sync``), and admission planning and dispatch (``admission``)."""
    tot = {"dispatch": 0.0, "host_sync": 0.0, "admission": 0.0}
    for ev in tracer.events:
        if ev["ph"] == "X" and ev["name"] in tot:
            tot[ev["name"]] += ev["dur"]
    return ", ".join(f"{k} {v / steps * 1e3:.1f} ms" for k, v in tot.items())


def serve_spec_path(card: str, params, cfg):
    import torch

    from repro_torch.obs import Telemetry, Tracer

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops

    t0 = time.perf_counter()
    _spec_batcher(params, cfg, _spec_requests(cfg, n=8, seed=1,
                                              namespace="warm-up")).run()
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s")

    # the same requests without speculation, for the token comparison and
    # the same traffic's non-speculative tokens/s
    # both runs record the batcher's host spans (a few events a round)
    reqs, plain_reqs = _spec_requests(cfg), _spec_requests(cfg)
    plain_trace, spec_trace = Tracer(), Tracer()
    t0 = time.perf_counter()
    plain_stats = _spec_batcher(params, cfg, plain_reqs, PAGED_CONFIG,
                                Telemetry(tracer=plain_trace)).run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batcher = _spec_batcher(params, cfg, reqs,
                            telemetry=Telemetry(tracer=spec_trace))
    torch.cuda.synchronize()
    counters = (fa_ops.flash_attention, pfx_ops.prefix_flash_attention,
                pa_ops.paged_verify_attention, pa_ops.paged_decode_attention,
                da_ops.decode_attention)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    stats = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa_n, pfx_n, pv_n, pa_n, da_n = (c.launches for c in counters)

    for r in reqs:
        check(r.done and not r.dropped, f"spec request {r.rid} did not complete")
        check(len(r.out) == r.max_new, f"spec request {r.rid}: {len(r.out)} "
              f"tokens, expected {r.max_new}")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"spec request {r.rid}: token outside the vocab")
    L, W = cfg.n_layers, SPEC_CONFIG["draft_window"]
    windows = stats.steps // W            # verify passes, every slot in each
    check(stats.prefills > 0 and windows > 0, "nothing was served")
    check(stats.spec_windows > 0, "no speculative window committed a token")
    check(pv_n == L * windows,
          f"paged_verify_attention launches {pv_n} != {L} x {windows} windows")
    check(fa_n + pfx_n == L * stats.prefills,
          f"flash {fa_n} + prefix {pfx_n} launches != {L} x {stats.prefills} "
          f"prefills")
    check(pa_n == 0 and da_n == 0,
          f"decode kernels ran on the spec path (paged {pa_n}, dense {da_n})")
    check(stats.device_draft_accepted == stats.accepted_tokens,
          f"device-counted accepted drafts {stats.device_draft_accepted} != "
          f"{stats.accepted_tokens} on the host")
    check(stats.dispatches - batcher.page_pushes == stats.prefills + stats.chunks,
          "dispatches != prefills + chunks + page pushes")
    check(stats.host_syncs == stats.prefills + stats.chunks,
          "host syncs != one per admission + one per chunk")
    check(stats.overlap_rounds >= 1, "no round overlapped admission and decode")
    pool = batcher.kv_pool
    pool.check()
    free_top = int(batcher.pages.free_top)
    check(free_top + pool.shared == batcher.n_pages,
          f"free_top {free_top} + shared {pool.shared} != {batcher.n_pages} pages")
    same = sum(a.out == b.out for a, b in zip(reqs, plain_reqs))
    verify_launches = pv_n
    peak = torch.cuda.max_memory_allocated()
    log(f"  {stats.completed}/16 requests, {stats.tokens} tokens, "
        f"{stats.prefills} prefills ({stats.prefix_hits} prefix hits), "
        f"{stats.chunks} chunks of {windows} verify windows, "
        f"{stats.spec_windows} slot-windows committed, {stats.overlap_rounds} "
        f"overlap rounds, {batcher.page_pushes} page pushes in {wall:.3f} s "
        f"[{card}]")
    log(f"  tokens/s={stats.tokens / wall:.1f}, {wall / windows * 1e3:.1f} ms "
        f"a window (the same requests without speculation: "
        f"{plain_stats.tokens / plain_wall:.1f} tokens/s, {plain_stats.steps} "
        f"decode steps, {plain_wall / plain_stats.steps * 1e3:.1f} ms a step) "
        f"acceptance_rate={stats.acceptance_rate:.3f} tokens_per_window="
        f"{stats.decode_tokens / max(stats.spec_windows, 1):.3f} "
        f"dispatches_per_token={stats.dispatches_per_token:.4f} "
        f"peak_memory={_gib(peak)} ({_gib(peak - base)} above the {_gib(base)} "
        f"allocated at the start) [{card}]")
    log(f"  host time per verify window: {_host_split(spec_trace, windows)}; "
        f"per decode step without speculation: "
        f"{_host_split(plain_trace, plain_stats.steps)} [{card}]")
    log(f"  bf16 token identity with the non-speculative run (reported, not "
        f"gated): {same}/16 requests ({same / 16:.3f})")
    log(f"  ledger: free_top {free_top} + shared {pool.shared} = "
        f"{batcher.n_pages} pages; launches: flash_attention={fa_n} + "
        f"prefix_flash_attention={pfx_n} (= {L} x {stats.prefills}), "
        f"paged_verify_attention={pv_n} (= {L} x {windows}), "
        f"paged_decode_attention={pa_n}, decode_attention={da_n}")

    # dense leg: 4 requests on dense rings; no multi-query kernel there
    dense = dict(slots=8, prompt_len=256, max_len=322, chunk=8,
                 speculative=True, draft_window=4, overlap=True)
    dreqs = _spec_requests(cfg, n=4, seed=2, namespace=None)
    for c in counters:
        c.launches = 0
    dstats = _spec_batcher(params, cfg, dreqs, dense).run()
    torch.cuda.synchronize()
    for r in dreqs:
        check(r.done and len(r.out) == r.max_new,
              f"dense spec request {r.rid} did not complete its budget")
    fa_n, pfx_n, pv_n, pa_n, da_n = (c.launches for c in counters)
    check(pv_n == 0 and pa_n == 0 and da_n == 0 and pfx_n == 0,
          f"dense spec leg launched verify {pv_n}, paged {pa_n}, decode "
          f"{da_n}, prefix {pfx_n}")
    check(fa_n == L * dstats.prefills,
          f"dense spec leg: flash launches {fa_n} != {L} x {dstats.prefills}")
    log(f"  dense leg: 4 requests, {dstats.tokens} tokens, {dstats.spec_windows} "
        f"slot-windows, acceptance_rate={dstats.acceptance_rate:.3f}; "
        f"launches: flash_attention={fa_n} (= {L} x {dstats.prefills}), "
        f"paged_verify_attention={pv_n}")
    return {"paged_verify_attention": verify_launches}


# ---------------------------------------------------------------------------
# phase 5d: the Mamba-2 path (mamba2-370m, dense mode)
# ---------------------------------------------------------------------------


MAMBA_CONFIG = dict(slots=8, prompt_len=1024, max_len=1088, chunk=8)


def _mamba_requests(cfg, n=16, seed=0):
    """``n`` prompts of 300-1024 tokens (left-padded to 1024, so every
    admission scans 4 chunks of 256) with ``max_new`` 16-64."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(300, 1025))
        max_new = int(rng.integers(16, 65))
        prompt = rng.integers(1, cfg.vocab, size=plen).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new=max_new))
    return reqs


def _mamba_batcher(params, cfg, reqs):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**MAMBA_CONFIG))
    for r in reqs:
        batcher.submit(r)
    return batcher


def serve_mamba_path(card: str):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import init_params

    cfg = get_config("mamba2-370m")
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"  params {_gib(_param_bytes(params))}; allocated "
        f"{_gib(torch.cuda.memory_allocated())}")
    t0 = time.perf_counter()
    _mamba_batcher(params, cfg, _mamba_requests(cfg, n=8, seed=1)).run()
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s")

    reqs = _mamba_requests(cfg)
    torch.cuda.synchronize()
    # the reset precedes the batcher, whose SSM state then counts in the
    # peak above the start
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batcher = _mamba_batcher(params, cfg, reqs)
    torch.cuda.synchronize()
    attn = (fa_ops.flash_attention, da_ops.decode_attention,
            pa_ops.paged_decode_attention, pa_ops.paged_verify_attention,
            pfx_ops.prefix_flash_attention)
    for c in (ssd_ops.ssd,) + attn:
        c.launches = 0
    ssd_ops.ssd.route_calls.update(dict.fromkeys(ssd_ops.ssd.route_calls, 0))
    t0 = time.perf_counter()
    stats = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ssd_n = ssd_ops.ssd.launches
    attn_n = {c.__name__: c.launches for c in attn}

    for r in reqs:
        check(r.done and not r.dropped, f"mamba request {r.rid} did not complete")
        check(len(r.out) == r.max_new, f"mamba request {r.rid}: {len(r.out)} "
              f"tokens, expected {r.max_new}")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"mamba request {r.rid}: token outside the vocab")
    L = cfg.n_layers
    check(stats.prefills > 0 and stats.steps > 0, "nothing was served")
    check(ssd_n == L * stats.prefills,
          f"ssd launches {ssd_n} != {L} x {stats.prefills} admissions")
    check(ssd_ops.ssd.route_calls["passes"] == ssd_n,
          f"ssd routes {ssd_ops.ssd.route_calls}: every bf16 admission "
          f"should take the five passes")
    check(not any(attn_n.values()),
          f"attention kernels ran on the Mamba-2 path: {attn_n}")
    check(stats.dispatches == stats.prefills + stats.chunks,
          "dispatches != prefills + chunks")
    check(stats.host_syncs == stats.prefills + stats.chunks,
          "host syncs != one per admission + one per chunk")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {stats.completed}/16 requests, {stats.tokens} tokens, "
        f"{stats.prefills} prefills, {stats.chunks} chunks, {stats.steps} "
        f"decode steps in {wall:.3f} s [{card}]")
    log(f"  tokens/s={stats.tokens / wall:.1f} dispatches_per_token="
        f"{stats.dispatches_per_token:.4f} peak_memory={_gib(peak)} "
        f"({_gib(peak - base)} above the {_gib(base)} allocated at the start, "
        f"params {_gib(_param_bytes(params))}, decode state "
        f"{_gib(stats.cache_bytes)}) [{card}]")
    log(f"  launches: ssd_scan={ssd_n} calls (= {L} x {stats.prefills}), "
        f"routes {ssd_ops.ssd.route_calls}, 5 kernels a call; attention "
        f"kernels {attn_n}")
    return {"ssd_scan": ssd_n}, (params, cfg)


# ---------------------------------------------------------------------------
# phase 5e: tenancy (two tenants served through the hypervisor)
# ---------------------------------------------------------------------------


TENANT_CONFIG = {k: v for k, v in PAGED_CONFIG.items() if k != "prefix_cache"}
TENANT_KV_PAGES = 128        # leased between the two tenants' batchers
NORM_PROJ_SHAPES = dict(x=(2048, 1024), s=(1024,), w=(1024, 3072))


def norm_proj(x, s, w):
    """The tenant program the static stage compiles: an admission's MLP
    input projection, ``matmul(rmsnorm(x, s), w)``, through the kernels."""
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    return mm_ops.matmul(rms_ops.rmsnorm(x, s), w)


def _tenant_requests(cfg, n=16):
    """``2n`` requests from one ``default_rng(0)`` (phase 5's shapes:
    prompts of 32-256 tokens, ``max_new`` 16-64): alice's n, then bob's."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(2 * n):
        plen = int(rng.integers(32, 257))
        max_new = int(rng.integers(16, 65))
        reqs.append(Request(rid=rid, prompt=rng.integers(
            1, cfg.vocab, size=plen).astype(np.int32), max_new=max_new))
    return reqs[:n], reqs[n:]


def _tenant_batcher(params, cfg, reqs):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**TENANT_CONFIG))
    for r in reqs:
        batcher.submit(r)
    return batcher


def _replay(params, cfg, reqs, limits):
    """The same requests through the same batcher configuration with no
    hypervisor and no migration: each ``(rounds, pages)`` of ``limits``
    sets the page limit after that many rounds, as alice's leases did."""
    batcher = _tenant_batcher(params, cfg, reqs)
    rounds = 0
    for at, pages in limits:
        while rounds < at:
            batcher.step()
            rounds += 1
        batcher.set_page_limit(pages)
    return batcher.run()


def serve_tenancy_path(card: str, params, cfg, build_s: float):
    """Two tenants on one card through the hypervisor, as
    ``examples/serve_multitenant.py`` wires them: a pool of 16 logical
    cores over the card, the ``priority`` policy; the static stage warms
    the ``norm_proj`` program for lease sizes 12 and 16; alice (12 cores,
    priority 2, the program) and bob (4 cores) each serve 16 requests on a
    paged batcher of 128 pages, the most a lease can give it, while the
    pool leases 128 pages between them, so neither may fill its batcher
    while both are resident.  Bob drains and departs, alice's lease grows
    back, and her regrow to 16 cores lands between two of her chunks and
    migrates her live state.  Returns the rmsnorm and matmul launches of
    the run."""
    import torch

    from repro_torch.core import TenantSpec
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.serving import (
        TensorSpec, VirtualAcceleratorPool, make_serving_hypervisor,
    )
    from repro_torch.serving.tenancy import HBM_BYTES_PER_DEVICE

    dev = resolve_device("cuda")
    total = torch.cuda.get_device_properties(0).total_memory
    check(HBM_BYTES_PER_DEVICE <= total, f"HBM_BYTES_PER_DEVICE "
          f"{HBM_BYTES_PER_DEVICE} > the card's {total}")
    log(f"  HBM_BYTES_PER_DEVICE {HBM_BYTES_PER_DEVICE / 1e9:.1f} GB <= "
        f"the card's {total / 1e9:.2f} GB")
    pool = VirtualAcceleratorPool(devices=[dev] * 16,
                                  kv_pages=TENANT_KV_PAGES)
    hv, ex = make_serving_hypervisor(pool, policy="priority")
    alice_reqs, bob_reqs = _tenant_requests(cfg)
    alice = _tenant_batcher(params, cfg, alice_reqs)
    bob = _tenant_batcher(params, cfg, bob_reqs)
    n_pages = TENANT_CONFIG["n_pages"]
    alice_rounds = 0
    limits = {"alice": [], "bob": []}      # (alice's rounds so far, pages)

    def kv_sink(name, batcher):
        def set_limit(n):
            limits[name].append((alice_rounds, n))
            batcher.set_page_limit(n)
        return set_limit

    ex.register_kv_limit("alice", kv_sink("alice", alice))
    ex.register_kv_limit("bob", kv_sink("bob", bob))
    ex.register_state("alice", alice.live_state, on_migrate=alice.adopt_state)

    counters = (rms_ops.rmsnorm, mm_ops.matmul, fa_ops.flash_attention,
                pa_ops.paged_decode_attention)
    for c in counters:
        c.launches = 0
    for c in (mm_ops.matmul, rms_ops.rmsnorm):
        c.route_launches.update(dict.fromkeys(c.route_launches, 0))
    bf16 = torch.bfloat16
    specs = tuple(TensorSpec(NORM_PROJ_SHAPES[k], bf16) for k in "xsw")
    progs = ex.compiler.static_compile("norm_proj", norm_proj, specs,
                                       lease_sizes=[12, 16])
    static_launches = (rms_ops.rmsnorm.launches, mm_ops.matmul.launches)
    check(static_launches == (2, 2),
          f"static stage launched rmsnorm/matmul {static_launches} times, "
          f"expected (2, 2)")
    check(hv.admit(TenantSpec("alice", 12, priority=2.0, artifact="norm_proj",
                              requested_kv_pages=n_pages, min_kv_pages=32)),
          "alice was not admitted")
    check(hv.admit(TenantSpec("bob", 4, priority=1.0, artifact=None,
                              requested_kv_pages=n_pages, min_kv_pages=32)),
          "bob was not admitted")
    check(hv.allocation() == {"alice": 12, "bob": 4},
          f"allocation {hv.allocation()}")
    shared = hv.kv_allocation()
    check(shared["alice"] < n_pages and shared["bob"] < n_pages and
          sum(shared.values()) == TENANT_KV_PAGES,
          f"kv leases {shared} while both are resident: each should be "
          f"below the batcher's {n_pages} pages")
    check(ex.program_of("alice") is progs[12], "alice's program is not the "
          "static stage's lease-12 program")
    t0 = time.perf_counter()
    for _ in range(3):
        alice.step()                          # alice's chunks in flight
        alice_rounds += 1
    bob_stats = bob.run()                     # bob drains
    shared_peak = {"alice": alice.stats.peak_pages_in_use,
                   "bob": bob_stats.peak_pages_in_use}
    shared_resident = alice.stats.peak_resident
    hv.depart("bob")
    hv.resize_request("alice", 16)            # between two of alice's chunks
    alice_stats = alice.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen = torch.Generator()
    gen.manual_seed(7)
    x, s, w = (torch.randn(NORM_PROJ_SHAPES[k], generator=gen).to(dev, bf16)
               for k in "xsw")
    y = ex.program_of("alice").executable(x, s, w)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}

    for name, reqs in (("alice", alice_reqs), ("bob", bob_reqs)):
        for r in reqs:
            check(r.done and not r.dropped and len(r.out) == r.max_new,
                  f"{name}'s request {r.rid} did not complete")
    ref_reqs = _tenant_requests(cfg)[0]
    _replay(params, cfg, ref_reqs, limits["alice"])   # uninterrupted
    same = sum(a.out == b.out for a, b in zip(alice_reqs, ref_reqs))
    check(same == len(alice_reqs), f"alice's tokens differ from an "
          f"uninterrupted run in {len(alice_reqs) - same} requests")
    regrow = [e for e in ex.reconfig_log
              if e.get("tenant") == "alice" and e.get("n_cores") == 16]
    check(len(regrow) == 1 and "t_migrate" in regrow[0],
          f"alice's regrow is not in reconfig_log: {ex.reconfig_log}")
    check(hv.allocation() == {"alice": 16}, f"allocation {hv.allocation()}")
    check(ex.program_of("alice") is progs[16],
          "the regrow did not hit the lease-16 program")
    alone = hv.kv_allocation()["alice"]
    for name in ("alice", "bob"):
        logged = [e["kv_pages"] for e in ex.reconfig_log
                  if e.get("tenant") == name and "kv_pages" in e]
        check(logged == [n for _, n in limits[name]] and logged,
              f"{name}'s kv leases {logged} != set_page_limit calls "
              f"{limits[name]}")
        # while both were resident each batcher stayed within its shrunk
        # lease, which is below the pages the batcher holds
        check(shared_peak[name] <= shared[name],
              f"{name}'s peak pages {shared_peak[name]} while both were "
              f"resident > lease {shared[name]}")
    check(alone == n_pages, f"alice's lease alone is {alone}, not {n_pages}")
    # the shrunk lease held alice back: she kept more requests resident
    # once her lease grew back
    check(shared_resident < alice_stats.peak_resident,
          f"alice kept {shared_resident} requests resident under her "
          f"shrunk lease and at most {alice_stats.peak_resident} after")
    for batcher, st in ((alice, alice_stats), (bob, bob_stats)):
        check(st.peak_pages_in_use <= n_pages, "peak pages above the pool")
        batcher.kv_pool.check()
    pool.pool.check_isolation()
    pool.pool.check_bandwidth()
    check(launches["rmsnorm"] == 3 and launches["matmul"] == 3,
          f"rmsnorm/matmul launches {launches}: expected 2 in the static "
          f"stage and 1 after the regrow")
    check(mm_ops.matmul.route_launches["wgmma"] == 3,
          f"matmul routes {mm_ops.matmul.route_launches}: the program's bf16 "
          f"product should take the wgmma route")
    check(rms_ops.rmsnorm.route_launches["registers"] == 3,
          f"rmsnorm routes {rms_ops.rmsnorm.route_launches}: the program's "
          f"aligned (2048, 1024) rows should take the register route")
    L = cfg.n_layers
    prefills = alice_stats.prefills + bob_stats.prefills
    steps = alice_stats.steps + bob_stats.steps
    check(launches["flash_attention"] == L * prefills,
          f"flash launches {launches['flash_attention']} != {L} x {prefills}")
    check(launches["paged_decode_attention"] == L * steps,
          f"paged decode launches {launches['paged_decode_attention']} != "
          f"{L} x {steps}")
    want = mm_ref.matmul_ref(rms_ref.rmsnorm_ref(x, s), w)
    err = _rel_err(y, want)
    check(y.shape == want.shape and y.dtype == bf16, "norm_proj: wrong shape")
    check(err <= 8e-3, f"norm_proj: relative error {err} > 8e-3")

    timing = regrow[0]
    log(f"  static stage: " + ", ".join(
        f"lease {n}: {p.lowered_seconds * 1e3:.3f} ms tensors + "
        f"{p.compile_seconds * 1e3:.3f} ms first call" for n, p in
        progs.items()) + f" (after phase 2's {build_s:.1f} s kernel build) "
        f"[{card}]")
    log(f"  regrow 12 -> 16 cores: t_context {timing['t_context'] * 1e3:.3f} "
        f"ms (lookup {timing['t_lookup'] * 1e3:.3f} ms, migrate "
        f"{timing['t_migrate'] * 1e3:.3f} ms) [{card}]")
    log(f"  alice: {alice_stats.completed}/16 requests, {alice_stats.tokens} "
        f"tokens, {alice_stats.prefills} prefills, {alice_stats.chunks} "
        f"chunks, peak pages {alice_stats.peak_pages_in_use}; bob: "
        f"{bob_stats.completed}/16, {bob_stats.tokens} tokens, peak pages "
        f"{bob_stats.peak_pages_in_use}; {wall:.3f} s in all [{card}]")
    log(f"  kv leases of {TENANT_KV_PAGES} pages over two batchers of "
        f"{n_pages}: alice {[n for _, n in limits['alice']]}, bob "
        f"{[n for _, n in limits['bob']]}; peak pages while both were "
        f"resident: alice {shared_peak['alice']}, bob {shared_peak['bob']}; "
        f"alice's peak residents {shared_resident} under the shrunk lease, "
        f"{alice_stats.peak_resident} in all; tokens equal to an "
        f"uninterrupted run: {same}/{len(alice_reqs)}; norm_proj rel err "
        f"{err:.3e}")
    log(f"  launches: rmsnorm={launches['rmsnorm']} matmul="
        f"{launches['matmul']} (2 static + 1 after the regrow; routes "
        f"{rms_ops.rmsnorm.route_launches}, {mm_ops.matmul.route_launches}), "
        f"flash_attention={launches['flash_attention']} (= {L} x {prefills}),"
        f" paged_decode_attention={launches['paged_decode_attention']} "
        f"(= {L} x {steps})")
    return {"rmsnorm": launches["rmsnorm"], "matmul": launches["matmul"]}


# ---------------------------------------------------------------------------
# phase 5f: the fault guards (page-table audit, quarantine, watchdog)
# ---------------------------------------------------------------------------


GUARD_CONFIG = dict(PAGED_CONFIG, audit=True, watchdog_s=5.0)


def _guarded_batcher(params, cfg, reqs):
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    batcher = ContinuousBatcher(params, cfg, ServingConfig(**GUARD_CONFIG))
    for r in reqs:
        batcher.submit(r)
    return batcher


def _private_page(batcher, slot: int):
    """The first page of ``slot``'s row past its pinned prefix that is
    mapped and not owned by the prefix cache, or None."""
    row = batcher.pages.table[slot].cpu().numpy()
    pin = int(batcher.pages.pinned[slot])
    shared = batcher.kv_pool.shared_ids()
    for pid in row[pin:]:
        if pid >= 0 and int(pid) not in shared:
            return int(pid)
    return None


def serve_guarded_path(card: str, params, cfg, paged_tokens):
    """Phase 5b's batcher with ``audit=True, watchdog_s=5.0`` and its 16
    requests: after two clean rounds, an out-of-range id in a live slot's
    table, then a live slot mapping another live slot's private page, then
    a synthetic 6 s stall blamed on a third live slot, one round apart.
    ``paged_tokens`` ({rid: tokens}) is phase 5b's run of the same
    requests."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops

    t0 = time.perf_counter()
    _guarded_batcher(params, cfg, _paged_requests(cfg, n=8, seed=1,
                                                  namespace="warm-up")).run()
    torch.cuda.synchronize()
    log(f"  warm-up run (8 other requests): {time.perf_counter() - t0:.3f} s")

    reqs = _paged_requests(cfg)
    batcher = _guarded_batcher(params, cfg, reqs)
    stats = batcher.stats
    torch.cuda.synchronize()
    counters = (fa_ops.flash_attention, pfx_ops.prefix_flash_attention,
                pa_ops.paged_decode_attention, da_ops.decode_attention)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    for _ in range(2):
        batcher.step()
    check(stats.chunks > 0 and stats.host_syncs == stats.prefills
          + stats.chunks, f"guarded path, clean rounds: {stats.host_syncs} "
          f"host syncs for {stats.prefills} admissions + {stats.chunks} "
          f"chunks")
    check(stats.dispatches - batcher.page_pushes == stats.prefills
          + stats.chunks, "guarded path, clean rounds: dispatches != "
          "prefills + chunks + page pushes")
    check(stats.audit_repairs == 0 and stats.watchdog_trips == 0,
          "a guard fired in a clean round")
    clean = (stats.prefills, stats.chunks, stats.host_syncs)

    def live():
        return [i for i, r in enumerate(batcher.slot_req) if r is not None]

    requeued = set()

    def faulted_round(what: str):
        before = {r.rid for r in batcher.slot_req if r is not None}
        batcher.step()
        back = sorted(r.rid for r in batcher.queue if r.rid in before)
        requeued.update(back)
        log(f"  {what}: requests {back} requeued; audit_repairs="
            f"{stats.audit_repairs} quarantined_pages="
            f"{stats.quarantined_pages} watchdog_trips={stats.watchdog_trips}")

    slots = live()
    check(len(slots) >= 3, f"only {len(slots)} live slots after two rounds")
    batcher.inject_kv_corruption(slots[0])
    faulted_round(f"out-of-range id in slot {slots[0]}'s table")
    check(stats.audit_repairs >= 1, "the audit missed an out-of-range id")

    slots = live()
    check(len(slots) >= 2, f"only {len(slots)} live slots for the double "
          f"mapping")
    thief, owner = slots[0], slots[1]
    stolen = _private_page(batcher, owner)
    check(stolen is not None, f"slot {owner} maps no private page")
    batcher.inject_kv_corruption(thief, pid=stolen)
    faulted_round(f"slot {thief} maps page {stolen}, private to slot {owner}")
    check(stolen in batcher._quarantined,
          f"the double-mapped page {stolen} was not quarantined")

    slots = [i for i in live() if i not in (thief, owner)]
    check(bool(slots), "no third live slot to stall")
    batcher.inject_stall(slots[0], 6.0)
    faulted_round(f"synthetic 6 s stall blamed on slot {slots[0]}")
    check(stats.watchdog_trips == 1, "the watchdog missed a 6 s stall")

    batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa_n, pfx_n, pa_n, da_n = (c.launches for c in counters)

    for r in reqs:
        check(r.done and not r.dropped,
              f"guarded request {r.rid} did not complete")
        check(len(r.out) == r.max_new, f"guarded request {r.rid}: "
              f"{len(r.out)} tokens, expected {r.max_new}")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"guarded request {r.rid}: token outside the vocab")
    L = cfg.n_layers
    check(stats.audit_repairs >= 3, f"audit_repairs {stats.audit_repairs} < 3")
    check(stats.quarantined_pages == 1 and batcher._quarantined == {stolen},
          f"quarantined {sorted(batcher._quarantined)}, expected [{stolen}]")
    check(stats.watchdog_trips == 1,
          f"watchdog_trips {stats.watchdog_trips}: a real chunk took > 5 s")
    tab = batcher.pages.table.cpu().numpy()
    top = int(batcher.pages.free_top)
    mapped = set(tab[tab >= 0].tolist())
    free = set(batcher.pages.free[:top].tolist())
    shared = batcher.kv_pool.shared_ids()
    quarantined = batcher._quarantined
    check(not (quarantined & (mapped | free | shared)),
          "a quarantined page is mapped, free or shared")
    check(len(mapped) + len(free) + len(shared) + len(quarantined)
          == batcher.n_pages and sorted(mapped | free | shared | quarantined)
          == list(range(batcher.n_pages)),
          f"mapped {len(mapped)} + free {len(free)} + shared {len(shared)} + "
          f"quarantined {len(quarantined)} do not partition "
          f"{batcher.n_pages} pages")
    batcher.kv_pool.check()
    check(fa_n + pfx_n == L * stats.prefills,
          f"flash {fa_n} + prefix {pfx_n} launches != {L} x {stats.prefills} "
          f"prefills")
    check(pa_n == L * stats.steps,
          f"paged_decode_attention launches {pa_n} != {L} x {stats.steps} steps")
    check(da_n == 0, f"the dense decode kernel ran {da_n} times on the "
          f"guarded path")
    kept = [r for r in reqs if r.rid not in requeued]
    same = sum(r.out == paged_tokens[r.rid] for r in kept)
    log(f"  {stats.completed}/16 requests, {stats.tokens} tokens, "
        f"{stats.prefills} prefills, {stats.chunks} chunks, {stats.steps} "
        f"decode steps, {batcher.page_pushes} page pushes in {wall:.3f} s "
        f"[{card}]")
    log(f"  guards: audit_repairs={stats.audit_repairs} quarantined_pages="
        f"{stats.quarantined_pages} (page {stolen}) watchdog_trips="
        f"{stats.watchdog_trips} requeued requests {sorted(requeued)}; "
        f"clean rounds: {clean[2]} host syncs for {clean[0]} admissions + "
        f"{clean[1]} chunks; whole run: {stats.host_syncs} host syncs for "
        f"{stats.prefills} admissions + {stats.chunks} chunks [{card}]")
    log(f"  pool: mapped {len(mapped)} + free {len(free)} + shared "
        f"{len(shared)} + quarantined {len(quarantined)} = {batcher.n_pages} "
        f"pages; launches: flash_attention={fa_n} + prefix_flash_attention="
        f"{pfx_n} (= {L} x {stats.prefills}), paged_decode_attention={pa_n} "
        f"(= {L} x {stats.steps}), decode_attention={da_n}")
    log(f"  bf16 token identity with phase 5b for the {len(kept)} requests "
        f"never requeued (reported, not gated): {same}/{len(kept)} "
        f"({same / max(len(kept), 1):.3f})")


# ---------------------------------------------------------------------------
# phase 5g: the MoE family (deepseek-moe-16b, dense, paged, speculative)
# ---------------------------------------------------------------------------


def _moe_leg(card, label, params, cfg, config, reqs, base, pbytes, *,
             late: int = 0):
    """One leg of phase 5g: a 2-request warm-up of ``config``, then
    ``reqs`` through a fresh batcher with every attention kernel's count
    set to 0; the last ``late`` requests arrive after the first round.
    Gates completion, one dispatch (plus page pushes) and one host sync
    per admission and per chunk, and the peak device memory above ``base``
    (taken before the weights were made) against the weights, the leg's
    cache and 10 % of the weights.  Returns (batcher, stats, wall,
    launches)."""
    import torch

    from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

    warm = [Request(rid=r.rid, prompt=r.prompt[-64:], max_new=8,
                    namespace="warm-up") for r in reqs[:2]]
    warm_b = ContinuousBatcher(params, cfg, ServingConfig(**config))
    for r in warm:
        warm_b.submit(r)
    warm_b.run()
    del warm_b
    _free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(params, cfg, ServingConfig(**config))
    for r in reqs[:len(reqs) - late]:
        batcher.submit(r)
    counters = _attn_counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if late:
        batcher.step()
        for r in reqs[len(reqs) - late:]:
            batcher.submit(r)
    stats = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    for r in reqs:
        check(r.done and not r.dropped and len(r.out) == r.max_new,
              f"{label}: request {r.rid} gave {len(r.out)} of {r.max_new} "
              f"tokens")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"{label}: request {r.rid}: token outside the vocab")
    pushes = batcher.page_pushes if batcher.paged else 0
    check(stats.dispatches - pushes == stats.prefills + stats.chunks,
          f"{label}: dispatches != admissions + chunks + page pushes")
    check(stats.host_syncs == stats.prefills + stats.chunks,
          f"{label}: host syncs != one per admission + one per chunk")
    peak = torch.cuda.max_memory_allocated() - base
    cache = stats.cache_bytes
    limit = pbytes + cache + 0.1 * pbytes
    log(f"  {label}: {stats.completed}/{len(reqs)} requests, {stats.tokens} "
        f"tokens, {stats.prefills} admissions, {stats.chunks} chunks, "
        f"{stats.steps} decode steps in {wall:.3f} s: tokens/s="
        f"{stats.tokens / wall:.1f} [{card}]")
    log(f"  {label}: peak {_gib(peak)} above the start of the phase; params "
        f"{_gib(pbytes)} + cache {_gib(cache)} + 10 % of params "
        f"{_gib(0.1 * pbytes)} = {_gib(limit)} [{card}]")
    check(peak <= limit, f"{label}: peak device memory {_gib(peak)} > params "
          f"+ cache + 10 % of params ({_gib(limit)})")
    return batcher, stats, wall, launches


def _moe_step_ms(params, cfg, n_rounds: int = 4):
    """Wall ms per decode step of phase 5's dense batcher once 8 requests
    of ``max_new`` 64 are resident: one round admits all 8, then
    ``n_rounds`` rounds are pure chunks of 8 steps, timed between syncs."""
    import torch

    batcher = _admitted(_batcher(params, cfg, _requests(cfg, n=8, seed=9,
                                                        max_new=64)))
    prefills, steps = batcher.stats.prefills, batcher.stats.steps
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        batcher.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(batcher.stats.prefills == prefills, "an admission ran in the "
          "timed decode rounds")
    return wall * 1e3 / (batcher.stats.steps - steps)


def serve_moe_path(card: str):
    """Phase 5g: full deepseek-moe-16b, its weights made once for three
    legs: phase 5's dense batcher and 16 requests, phase 5b's paged batcher
    and requests with the prefix cache, and 4 of phase 5c's requests on its
    speculative batcher with overlap.  Each kernel's launches are 28 x its
    calls on its leg and no other attention kernel runs there."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("deepseek-moe-16b")
    L = cfg.n_layers
    _free_device_memory()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pbytes = _param_bytes(params)
    init_peak = torch.cuda.max_memory_allocated() - base
    log(f"  {cfg.name}: params {_gib(pbytes)} ({pbytes / 1e9:.2f} GB) made in "
        f"{init_s:.1f} s; init_params peak {_gib(init_peak)} above the start "
        f"[{card}]")
    check(init_peak <= 1.1 * pbytes, f"init_params peaked at {_gib(init_peak)}"
          f" > 1.1 x params: a stacked copy of the weights")

    expert_bytes = L * cfg.moe.n_experts * 3 * cfg.d_model \
        * cfg.moe.expert_d_ff * 2
    step_bytes = pbytes - params["embed"]["w"].numel() * 2
    floor_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    step_floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3

    _, st, _, n = _moe_leg(card, "dense leg", params, cfg,
                           dict(slots=8, prompt_len=256, max_len=322, chunk=8),
                           _requests(cfg), base, pbytes)
    check(n["flash_attention"] == L * st.prefills
          and n["decode_attention"] == L * st.steps
          and n["prefix_flash_attention"] == n["paged_decode_attention"]
          == n["paged_verify_attention"] == 0,
          f"dense leg launches {n}: flash != {L} x {st.prefills} admissions "
          f"or decode != {L} x {st.steps} steps")
    log(f"  dense leg launches: flash_attention={n['flash_attention']} (= {L} "
        f"x {st.prefills}), decode_attention={n['decode_attention']} (= {L} x "
        f"{st.steps})")

    b, st, _, n = _moe_leg(card, "paged leg", params, cfg, PAGED_CONFIG,
                           _paged_requests(cfg), base, pbytes)
    check(st.prefix_hits > 0 and n["prefix_flash_attention"] > 0,
          "paged leg: no admission went through the prefix cache's kernel")
    check(n["flash_attention"] + n["prefix_flash_attention"] == L * st.prefills
          and n["paged_decode_attention"] == L * st.steps
          and n["decode_attention"] == n["paged_verify_attention"] == 0,
          f"paged leg launches {n}: flash + prefix != {L} x {st.prefills} "
          f"admissions or paged decode != {L} x {st.steps} steps")
    b.kv_pool.check()
    free_top = int(b.pages.free_top)
    check(free_top + b.kv_pool.shared == b.n_pages,
          f"paged leg: free_top {free_top} + shared {b.kv_pool.shared} != "
          f"{b.n_pages} pages")
    log(f"  paged leg: {st.prefix_hits} prefix hits; ledger free_top "
        f"{free_top} + shared {b.kv_pool.shared} = {b.n_pages} pages; "
        f"launches: flash_attention={n['flash_attention']} + "
        f"prefix_flash_attention={n['prefix_flash_attention']} (= {L} x "
        f"{st.prefills}), paged_decode_attention="
        f"{n['paged_decode_attention']} (= {L} x {st.steps})")
    del b

    W = SPEC_CONFIG["draft_window"]
    # two of the four arrive after the first round, so their admission
    # runs behind a verify chunk (overlap)
    b, st, _, n = _moe_leg(card, "speculative leg", params, cfg, SPEC_CONFIG,
                           _spec_requests(cfg, n=4), base, pbytes, late=2)
    windows = st.steps // W
    check(st.spec_windows > 0 and windows > 0, "speculative leg: no window")
    check(st.overlap_rounds >= 1, "speculative leg: no admission overlapped "
          "a verify chunk")
    check(n["paged_verify_attention"] == L * windows
          and n["flash_attention"] + n["prefix_flash_attention"]
          == L * st.prefills
          and n["decode_attention"] == n["paged_decode_attention"] == 0,
          f"speculative leg launches {n}: verify != {L} x {windows} windows "
          f"or flash + prefix != {L} x {st.prefills} admissions")
    check(st.device_draft_accepted == st.accepted_tokens,
          f"speculative leg: device-counted accepted drafts "
          f"{st.device_draft_accepted} != {st.accepted_tokens} on the host")
    b.kv_pool.check()
    free_top = int(b.pages.free_top)
    check(free_top + b.kv_pool.shared == b.n_pages,
          f"speculative leg: free_top {free_top} + shared {b.kv_pool.shared} "
          f"!= {b.n_pages} pages")
    log(f"  speculative leg: {windows} verify windows, acceptance_rate="
        f"{st.acceptance_rate:.3f}, {st.overlap_rounds} overlap rounds; "
        f"launches: paged_verify_attention={n['paged_verify_attention']} (= "
        f"{L} x {windows}), flash_attention={n['flash_attention']} + "
        f"prefix_flash_attention={n['prefix_flash_attention']} (= {L} x "
        f"{st.prefills})")
    del b

    step_ms = _moe_step_ms(params, cfg)
    log(f"  dense decode, 8 slots resident: {step_ms:.2f} ms a step (wall); "
        f"floor {floor_ms:.2f} ms to read the {expert_bytes / 1e9:.1f} GB of "
        f"routed experts once, {step_floor_ms:.2f} ms for all "
        f"{step_bytes / 1e9:.1f} GB a step reads [{card}]")
    return params, cfg, floor_ms


# ---------------------------------------------------------------------------
# phase 6: where the time goes (a traced window of the same requests)
# ---------------------------------------------------------------------------


# the SSD scan's bf16 passes, in launch order
SSD_KERNELS = ("ssd_cumsum_kernel", "ssd_cb_kernel", "ssd_chunk_state_kernel",
               "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")
# the first match names the class (the SSD's f32 route is ssd_f32_kernel);
# the dense decode kernels are dec_split_kernel and dec_merge_kernel, the
# paged ones paged_decode_split_kernel and paged_decode_merge_kernel,
# the verify kernels paged_verify_{mma,f32}_kernel and
# paged_verify_merge_kernel
_KERNEL_CLASSES = (("flash_attention", ("fa_kernel", "fa_mma_kernel")),
                   ("ssd_scan", SSD_KERNELS + ("ssd_f32_kernel",)),
                   ("paged_verify_attention", ("paged_verify_mma_kernel",
                                               "paged_verify_f32_kernel",
                                               "paged_verify_merge_kernel")),
                   ("prefix_flash_attention", ("pfx_kernel", "pfx_mma_kernel")),
                   ("paged_decode_attention", ("paged_decode_split_kernel",
                                               "paged_decode_merge_kernel")),
                   ("decode_attention", ("dec_split_kernel",
                                         "dec_merge_kernel")),
                   ("matmul (port)", ("mm_wgmma_kernel", "mm_simt_kernel")),
                   # cuBLASLt's Hopper GEMMs are named nvjet_*
                   ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "cublas",
                                        "nvjet")))


# on the MoE path, device time is also split by the op that launched each
# kernel and the profiler range of models/moe.py it ran in: the expert
# products (the batched matmuls in "moe.expert_products") and the dispatch
# ops (top-k, sorts, scatters, gathers and index copies in "moe.dispatch")
_MOE_PRODUCT_OPS = ("aten::bmm", "aten::mm", "aten::matmul", "aten::baddbmm",
                    "aten::addmm")
_MOE_DISPATCH_OPS = ("aten::topk", "aten::sort", "aten::argsort",
                     "aten::scatter", "aten::scatter_", "aten::scatter_add_",
                     "aten::gather", "aten::index", "aten::index_put_",
                     "aten::_index_put_impl_", "aten::index_add_",
                     "aten::index_select", "aten::cumsum")
MOE_PRODUCTS = "MoE expert products"
MOE_DISPATCH = "MoE dispatch (top-k, sort, scatter, gather)"


def _kernel_class(name: str) -> str:
    name = name.lower()
    for cls_name, keys in _KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls_name
    return "other (elementwise, reductions, copies)"


def _moe_op_class(evt):
    """MOE_PRODUCTS or MOE_DISPATCH for a profiled op inside the matching
    range of ``models/moe.py`` (found through the profiler's
    ``cpu_parent`` links), else None."""
    scope = evt.cpu_parent
    while scope is not None and not scope.name.startswith("moe."):
        scope = scope.cpu_parent
    if scope is None:
        return None
    if scope.name == "moe.expert_products" and evt.name in _MOE_PRODUCT_OPS:
        return MOE_PRODUCTS
    if scope.name == "moe.dispatch" and evt.name in _MOE_DISPATCH_OPS:
        return MOE_DISPATCH
    return None


def _rounds(batcher, n_rounds: int) -> float:
    """Wall time of ``n_rounds`` scheduling rounds of ``batcher``
    (admissions, then chunks), from a sync to a sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        batcher.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def trace_main_paths(card: str, paths, n_rounds: int = 3):
    """The first rounds of a fresh batcher of each main path in ``paths``
    ((label, make_batcher, must_run, moe) tuples), first all untraced,
    then each under ``torch.profiler`` (device activity; with ``moe``, also
    the host's ops, whose ``models/moe.py`` ranges name the MoE's classes),
    so no untraced window runs after a profiler session: device busy time
    (union of kernel intervals), the idle share against the untraced
    window's wall time, and device time by kernel class, with ``moe`` the
    expert products and the dispatch ops as classes of their own.  Fails
    unless a kernel whose name holds each of ``must_run`` ran in the
    path's traced window and, with ``moe``, unless both MoE classes took
    device time.  Returns {label: (device busy ms,
    decode steps in the traced window)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # each window is a fresh batcher from make_batcher(), built (and for
    # the decode window, admitted) before the window opens
    clean = {label: _rounds(make(), n_rounds) for label, make, _, _ in paths}
    busy_by_label = {}
    for label, make, must_run, moe in paths:
        batcher = make()
        steps = batcher.stats.steps
        t0 = time.perf_counter()
        activities = [ProfilerActivity.CUDA]
        if moe:
            activities.append(ProfilerActivity.CPU)
        with profile(activities=activities) as prof:
            traced = _rounds(batcher, n_rounds)
        steps = batcher.stats.steps - steps
        del batcher
        spans, by_class, by_name = [], {}, {}
        for evt in prof.events():
            if moe and evt.device_type == torch.autograd.DeviceType.CPU:
                cls = _moe_op_class(evt) if evt.kernels else None
                for k in (evt.kernels if cls else ()):
                    by_class[cls] = by_class.get(cls, 0.0) + k.duration
                    old = _kernel_class(k.name)
                    by_class[old] = by_class.get(old, 0.0) - k.duration
                continue
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or evt.name.startswith("moe.")):
                continue              # the ranges' device spans are no kernels
            start, end = evt.time_range.start, evt.time_range.end
            if end <= start:
                continue
            spans.append((start, end))
            cls = _kernel_class(evt.name)
            by_class[cls] = by_class.get(cls, 0.0) + (end - start)
            by_name[evt.name] = by_name.get(evt.name, 0.0) + (end - start)
        log(f"  {label}: profiler post-processing "
            f"{time.perf_counter() - t0 - traced:.1f} s")
        if not spans:
            log(f"  {label}: device time not measured: the profiler saw no "
                f"CUDA kernels")
            continue
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
        log(f"  {label}, first {n_rounds} rounds: {len(spans)} device kernels, "
            f"device busy {busy_s * 1e3:.1f} ms; wall {clean[label]:.3f} s "
            f"untraced ({traced:.3f} s traced) -> device idle share "
            f"{1 - busy_s / clean[label]:.3f} [{card}]")
        total = sum(by_class.values())
        for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
            log(f"    {cls:<42} {us * 1e-3:9.2f} ms  {us / total:6.1%} of "
                f"kernel time")
        log("  top kernels by device time:")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {us * 1e-3:9.2f} ms  {us / total:6.1%}  {name[:90]}")
        for key in must_run:
            names = [n for n in by_name if key in n]
            check(bool(names), f"{label}: no {key} ran in the traced window")
            log(f"  {label} ran {key}: "
                f"{sum(by_name[n] for n in names) * 1e-3:.2f} ms "
                f"({names[0][:70]})")
        if moe:
            check(by_class.get(MOE_PRODUCTS, 0) > 0
                  and by_class.get(MOE_DISPATCH, 0) > 0,
                  f"{label}: no device time traced to the MoE expert "
                  f"products or dispatch ops")
        busy_by_label[label] = (busy_s * 1e3, steps)
    return busy_by_label


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

    if "--memory" in sys.argv[1:]:
        from repro_torch.configs import get_config
        from repro_torch.models import init_params

        cfg = get_config("qwen3-0.6b")
        admission_memory(init_params(cfg, 0, device="cuda"), cfg, card)
        return 0
    if "--ssd-faults" in sys.argv[1:]:
        log("SSD scan with planted faults against phases 3 and 4")
        return ssd_fault_check()
    if "--kernel-times" in sys.argv[1:]:
        log("flash, dense decode, prefix, verify, SSD, matmul, paged "
            "decode and rmsnorm kernels timed at the main paths' shapes")
        return kernel_times(card)

    log("phase 2: build")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load_library()
    build_s = time.perf_counter() - t0
    log(f"  built {_build.LIB_NAME} in {build_s:.1f} s")
    for line in "\n".join(_build.BUILD_LOG).splitlines():
        if ("Function properties for" in line or "registers" in line
                or "spill" in line or "==" in line):
            log("  " + line.strip())

    log("phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = [check_flash(gen), check_decode(gen), check_paged_decode(gen),
            check_paged_verify(gen), check_prefix(gen), check_ssd(gen),
            check_rmsnorm(gen), check_matmul(gen)]
    log("  the five attention kernels at group 1 (H = Hkv = 16, dh 128, "
        "bf16), deepseek-moe-16b's heads:")
    for row in group1_times(gen, np.random.default_rng(7)):
        _log_time_row(row, card)
    torch.cuda.empty_cache()

    log("phase 4: model (cuda kernels) against the plain path")
    check_model()
    check_mamba_model()
    torch.cuda.empty_cache()

    log("phase 4c: the MoE family at full width, bf16, cuda kernels against "
        "the plain path")
    for arch in ("deepseek-moe-16b", "mixtral-8x22b"):
        check_moe_model(card, arch, n_layers=2, dtype="float32")
    check_moe_model(card, "deepseek-moe-16b")
    check_moe_model(card, "mixtral-8x22b", n_layers=2)

    log("phase 5: main path, qwen3-0.6b behind ContinuousBatcher")
    launches, (params, cfg) = serve_main_path(card)

    log("phase 5b: paged main path, qwen3-0.6b behind a paged batcher with "
        "the prefix cache")
    path_launches, paged_tokens = serve_paged_path(card, params, cfg)

    log("phase 5c: speculative path, qwen3-0.6b behind a paged batcher with "
        "the prefix cache, speculative decode and overlap")
    path_launches.update(serve_spec_path(card, params, cfg))

    log("phase 5d: Mamba-2 path, mamba2-370m behind ContinuousBatcher")
    mamba_launches, (mparams, mcfg) = serve_mamba_path(card)
    path_launches.update(mamba_launches)

    log("phase 5e: tenancy, qwen3-0.6b tenants served through the "
        "hypervisor (leases, static stage, regrow between chunks)")
    path_launches.update(serve_tenancy_path(card, params, cfg, build_s))

    log("phase 5f: fault guards, qwen3-0.6b behind phase 5b's batcher with "
        "the page-table audit and the watchdog, three faults injected")
    serve_guarded_path(card, params, cfg, paged_tokens)

    log("phase 5g: MoE path, full deepseek-moe-16b behind the dense, the "
        "paged (prefix cache) and the speculative (overlap) batchers")
    dparams, dcfg, floor_ms = serve_moe_path(card)

    log("phase 6: where the time goes")
    # the bf16 paths' prefill, prefix, decode, paged decode and verify
    # take the redesigned kernels
    dense_kernels = ("fa_mma_kernel", "dec_split_kernel", "dec_merge_kernel")
    busy = trace_main_paths(card, [
        ("dense path", lambda: _batcher(params, cfg, _requests(cfg)),
         dense_kernels, False),
        ("paged path", lambda: _paged_batcher(params, cfg,
                                              _paged_requests(cfg)),
         ("fa_mma_kernel", "pfx_mma_kernel", "paged_decode_split_kernel",
          "paged_decode_merge_kernel"), False),
        ("spec path", lambda: _spec_batcher(params, cfg,
                                            _spec_requests(cfg)),
         ("paged_verify_mma_kernel", "paged_verify_merge_kernel",
          "pfx_mma_kernel"), False),
        ("mamba2 path", lambda: _mamba_batcher(mparams, mcfg,
                                               _mamba_requests(mcfg)),
         SSD_KERNELS, False),
        ("moe path", lambda: _batcher(dparams, dcfg, _requests(dcfg)),
         dense_kernels, True),
        # 8 requests admitted before the window: its rounds are pure chunks
        ("moe decode", lambda: _admitted(_batcher(
            dparams, dcfg, _requests(dcfg, n=8, seed=9, max_new=64))),
         ("dec_split_kernel", "dec_merge_kernel"), True)])
    if "moe decode" in busy:
        busy_ms, steps = busy["moe decode"]
        log(f"  moe decode: {busy_ms / steps:.2f} ms of device time a decode "
            f"step ({steps} steps), beside the {floor_ms:.2f} ms floor to "
            f"read the routed experts once [{card}]")

    for row in rows:
        # each kernel's launches on the path that runs it: flash on the
        # dense path (it runs on both), the others on their own path
        row["launches"] = (launches[row["name"]] if row["name"] in launches
                           else path_launches[row["name"]])
        _log_time_row(row, card)
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
