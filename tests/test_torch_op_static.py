"""The op counter (``repro_torch.distributed.op_static``), the twin of
``tests/test_hlo_static.py``: programs with costs known by hand, the
kernels' ``meta`` routes against the bound column of PERF.md §6, the
tensor-parallel sums, the reference's static analysis of a compiled cell,
and a dry-run record of a full-width cell.

Exact counts are asserted exactly.  Against ``hlo_static.analyze_hlo`` on
the reference's compiled reduced cell the dot FLOPs agree within 2 % for
prefill and decode (they agree exactly for every reference arch at the
time of writing) and within 3 % for the train step (0.9885 to 1.0217 of
the reference's over the six reference archs: the two packages' backward
passes contract different products).
"""

import json

import jax
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.distributed.hlo_static import analyze_hlo
from repro.launch.cells import build_cell as jax_build_cell
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro_torch.distributed import ShardGroup, TP_POLICY, make_tp_mesh
from repro_torch.distributed.op_analysis import H100_SXM, Roofline
from repro_torch.distributed.op_static import analyze
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.prefix_attention import ops as pfx_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import dryrun
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.attention import flash_attention_train

F32, BF16 = torch.float32, torch.bfloat16


def meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# flops and bytes of programs known by hand
# ---------------------------------------------------------------------------


def test_matmul_flops_and_bytes_exact():
    c = analyze(lambda x, y: x @ y, meta(128, 256), meta(256, 64))
    assert c.flops == 2 * 128 * 256 * 64
    assert c.bytes == (128 * 256 + 256 * 64 + 128 * 64) * 4
    assert c.ops == 1 and c.peak_live_bytes == c.bytes


def test_python_loop_counts_every_layer():
    """The counterpart of the scan bug ``hlo_static`` fixes: a Python loop
    runs every layer, so 7 layers count 7 times and 3 x 5 nested 15."""
    def seven(w, x):
        for i in range(7):
            x = torch.tanh(x @ w[i])
        return x

    def nested(w, x):
        for i in range(3):
            for j in range(5):
                x = x @ w[i, j]
        return x

    assert analyze(seven, meta(7, 64, 64), meta(8, 64)).flops == 7 * 2 * 8 * 64 * 64
    assert (analyze(nested, meta(3, 5, 32, 32), meta(4, 32)).flops
            == 15 * 2 * 4 * 32 * 32)


def test_grad_is_three_forwards():
    def loss(w, x):
        return ((x @ w) ** 2).sum()

    w = meta(128, 32).requires_grad_(True)
    x = meta(64, 128).requires_grad_(True)
    fwd = analyze(loss, w, x).flops
    bwd = analyze(lambda w, x: torch.autograd.grad(loss(w, x), (w, x)), w, x)
    assert bwd.flops == 3 * fwd          # x @ w, then dL/dw and dL/dx


def test_views_move_no_bytes():
    x = meta(4, 8, 16)
    c = analyze(lambda x: x.view(32, 16).t().reshape(16, 32)[2:5].unsqueeze(0)
                .expand(3, 3, 32).detach(), x)
    assert c.bytes == 0 and c.flops == 0
    # a reshape that must copy is one kernel: read and write
    c = analyze(lambda x: x.transpose(0, 1).reshape(-1), x)
    assert c.bytes == 2 * x.numel() * 4


def test_gather_and_scatter_move_their_rows_not_the_buffer():
    table, ids = meta(50_000, 64), meta(16, dtype=torch.int64)
    c = analyze(lambda t, i: t[i], table, ids)
    assert c.bytes == 2 * 16 * 64 * 4
    cache, rows = meta(8, 4096, 64), meta(8, 64)
    b, slot = meta(8, dtype=torch.int64), meta(8, dtype=torch.int64)
    c = analyze(lambda c_, r, b_, s: c_.index_put_((b_, s), r), cache, rows,
                b, slot)
    assert c.bytes == 2 * 8 * 64 * 4


def test_conv_flops():
    x, w = meta(2, 16, 32, 32), meta(8, 16, 3, 3)
    c = analyze(lambda x, w: torch.nn.functional.conv2d(x, w), x, w)
    assert c.flops == 2 * (2 * 8 * 30 * 30) * (16 * 3 * 3)
    # depthwise (groups = channels), as Mamba-2's short conv
    x, w = meta(2, 64, 100), meta(64, 1, 4)
    c = analyze(lambda x, w: torch.nn.functional.conv1d(x, w, groups=64), x, w)
    assert c.flops == 2 * (2 * 64 * 97) * 4


def test_peak_live_bytes_follows_storages():
    def f(x):
        a = x * 2          # +1 MiB
        b = a * 2          # +1 MiB
        del a              # -1 MiB
        return b * 2       # +1 MiB

    x = meta(256, 1024)
    mib = 256 * 1024 * 4
    assert analyze(f, x).peak_live_bytes == 3 * mib
    # autograd keeps what it saved until the graph dies
    w = meta(1024, 256).requires_grad_(True)
    saved = analyze(lambda w: (torch.tanh(w) * 2).sum(), w)
    assert saved.peak_live_bytes >= 2 * mib


# ---------------------------------------------------------------------------
# the kernels' meta routes
# ---------------------------------------------------------------------------


def test_kernel_meta_routes_give_shapes_and_the_bound_bytes():
    """Each wrapper on meta tensors launches nothing, returns its output's
    shape and dtype, and adds its kernel's cost: at the §6 shapes, the
    bound column's bytes (flash 25.2 MB, prefix 12.6 MB, matmul 12.88
    GFLOP, SSD 80.7 MB ...)."""
    B, S, H, Hkv, dh = 8, 256, 16, 8, 128
    q, k = meta(B, S, H, dh, dtype=BF16), meta(B, S, Hkv, dh, dtype=BF16)
    launches = fa_ops.flash_attention.launches
    c = analyze(fa_ops.flash_attention, q, k, k)
    assert fa_ops.flash_attention.launches == launches
    assert c.kernels == {"flash_attention": [1, c.flops, c.bytes]}
    assert c.bytes == 25_165_824                      # 25.2 MB
    assert c.flops == 4 * dh * (S * (S + 1) // 2) * B * H
    out = analyze(lambda *a: fa_ops.flash_attention(*a, return_lse=True),
                  meta(8, 512, H, dh, dtype=BF16),
                  *(meta(8, 512, Hkv, dh, dtype=BF16),) * 2)
    assert out.bytes == 50_593_792                    # 8 x 512 + LSE, 50.6 MB

    got = fa_ops.flash_attention(q, k, k, return_lse=True)
    assert [t.shape for t in got] == [q.shape, (B, S, H)]
    assert got[1].dtype == F32 and got[0].device.type == "meta"

    # a window and q_offset count only the pairs they let through
    c = analyze(lambda *a: fa_ops.flash_attention(*a, window=16, q_offset=4),
                meta(1, 10, 1, 8), meta(1, 14, 1, 8), meta(1, 14, 1, 8))
    pairs = sum(min(i + 4, 13) - max(0, i + 4 - 15) + 1 for i in range(10))
    assert c.flops == 4 * 8 * pairs

    c = analyze(pfx_ops.prefix_flash_attention, meta(B, 64, H, dh, dtype=BF16),
                *(meta(B, 192, Hkv, dh, dtype=BF16),) * 2,
                *(meta(B, 64, Hkv, dh, dtype=BF16),) * 2)
    assert c.bytes == 12_582_912                      # 12.6 MB
    assert c.flops == 4 * dh * (64 * 192 + 64 * 65 // 2) * B * H

    c = analyze(mm_ops.matmul, meta(2048, 1024, dtype=BF16),
                meta(1024, 3072, dtype=BF16))
    assert c.flops == 12_884_901_888                  # 12.88 GFLOP
    assert c.bytes == (2048 * 1024 + 1024 * 3072 + 2048 * 3072) * 2
    assert mm_ops.matmul(meta(2, 3, 8), meta(8, 5),
                         out_dtype=BF16).shape == (2, 3, 5)

    c = analyze(rms_ops.rmsnorm, meta(2048, 1024, dtype=BF16),
                meta(1024, dtype=BF16))
    assert c.bytes == 2 * 2048 * 1024 * 2 + 1024 * 2

    x = meta(8, 1024, 32, 64, dtype=BF16)
    dt, A = meta(8, 1024, 32), meta(32)
    Bm = meta(8, 1024, 1, 128, dtype=BF16)
    c = analyze(lambda *a: ssd_ops.ssd(*a, chunk=256, return_state=True),
                x, dt, A, Bm, Bm)
    assert c.bytes == 80_740_480                      # PERF.md §6 row 6
    y, st = ssd_ops.ssd(x, dt, A, Bm, Bm, chunk=256, return_state=True)
    assert y.shape == x.shape and st.shape == (8, 32, 64, 128)

    # decode-shaped kernels: on meta every slot counts (a full cache)
    qd = meta(B, H, dh, dtype=BF16)
    kd = meta(B, 322, Hkv, dh, dtype=BF16)
    c = analyze(da_ops.decode_attention, qd, kd, kd,
                meta(B, 322, dtype=torch.int32), meta(B, dtype=torch.int32))
    assert c.bytes == 2 * B * H * dh * 2 + 2 * B * 322 * Hkv * dh * 2 + B * 322 * 4 + B * 4
    pool = meta(169, 16, Hkv, dh, dtype=BF16)
    tab, cur = meta(B, 21, dtype=torch.int32), meta(B, dtype=torch.int32)
    c = analyze(pa_ops.paged_decode_attention, qd, pool, pool, tab, cur)
    assert c.flops == 4 * dh * H * B * 21 * 16
    qv = meta(B, 4, H, dh, dtype=BF16)
    c = analyze(pa_ops.paged_verify_attention, qv, pool, pool, tab, cur)
    assert c.flops == 4 * dh * H * B * 4 * 21 * 16
    assert pa_ops.paged_verify_attention(qv, pool, pool, tab, cur).shape == qv.shape


def test_decode_costs_count_the_valid_rows_of_real_data():
    """On real tensors the decode-shaped costs count what the data attends
    to: the filled slots at or before each row's position (the valid K/V
    rows of PERF.md §6's bound), the mapped pages of a table."""
    rng = np.random.default_rng(0)
    B, C, H, Hkv, dh = 4, 40, 4, 2, 8
    pos = torch.from_numpy(rng.integers(-1, 50, (B, C)).astype(np.int32))
    cur = torch.from_numpy(rng.integers(10, 45, B).astype(np.int32))
    q, k = torch.zeros(B, H, dh), torch.zeros(B, C, Hkv, dh)
    n = int(((pos >= 0) & (pos <= cur[:, None])).sum())
    flops, n_bytes = da_ops.decode_attention.cost(q, k, k, pos, cur)
    assert flops == 4 * dh * H * n
    assert n_bytes == 2 * B * H * dh * 4 + 2 * n * Hkv * dh * 4 + B * C * 4 + B * 4
    tab = torch.tensor([[0, -1, 2], [1, 3, -1]], dtype=torch.int32)
    cur = torch.tensor([9, 4], dtype=torch.int32)
    q, pool = torch.zeros(2, 2, H, dh), torch.zeros(5, 4, Hkv, dh)
    flops, n_bytes = pa_ops.paged_verify_attention.cost(q, pool, pool, tab, cur)
    # slot 0: pages 0 and 2 mapped (positions 0-3, 8-11): rows w=0 see
    # 0-3 and 8-9, w=1 0-3 and 8-10; slot 1: pages 1, 3: w=0 0-4, w=1 0-5
    assert flops == 4 * dh * H * (6 + 7 + 5 + 6)
    assert n_bytes == (2 * 2 * 2 * H * dh * 4 + (7 + 6) * 2 * Hkv * dh * 4
                       + 2 * 3 * 4 + 2 * 4)


def test_flash_attention_fn_meta_route_counts_the_torch_backward():
    q = meta(2, 64, 4, 32).requires_grad_(True)
    k = meta(2, 64, 2, 32).requires_grad_(True)

    def step(q, k, v):
        out = flash_attention_train(q, k, v)
        return torch.autograd.grad(out.sum(), (q, k, v))

    c = analyze(step, q, k, k.detach().requires_grad_(True))
    assert c.kernels["flash_attention"][0] == 1      # the forward kernel
    fwd = c.kernels["flash_attention"][1]
    assert c.flops > fwd                             # the backward's products


# ---------------------------------------------------------------------------
# collectives: the tensor-parallel sums
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_group_sums_count_ring_all_reduce_bytes(tp):
    group = ShardGroup(make_tp_mesh(tp, ["cpu"] * tp))
    x = meta(8, 1024, dtype=BF16)
    size = 8 * 1024 * 2

    def program(x):
        y = TP_POLICY(x @ torch.empty(1024, 1024, dtype=BF16, device="meta"),
                      "attn_out")
        return TP_POLICY(y, "mlp_out")

    try:
        c = analyze(lambda: group.run(program, [(x,)] * tp))
    finally:
        group.close()
    # two sums a shard, each shard's wire bytes 2 size (N - 1) / N
    assert c.collective_count == {"all-reduce": 2 * tp}
    assert c.collective_bytes == pytest.approx(2 * tp * 2 * size * (tp - 1) / tp)
    assert c.raw_collective_bytes == 2 * tp * size
    assert c.collective_stats().total_count == 2 * tp
    # every shard's product is counted, worker threads too
    assert c.flops == tp * 2 * 8 * 1024 * 1024


def test_roofline_terms_on_h100_peaks():
    r = Roofline(chips=4, hlo_flops=4 * 989e12, hlo_bytes=8 * 3.35e12,
                 collective_bytes=None, model_flops=2 * 989e12)
    assert r.t_compute == 1.0 and r.t_memory == 2.0
    assert r.t_collective is None and r.bound == "memory" and r.t_bound == 2.0
    assert r.useful_flops_ratio == 0.5 and r.roofline_fraction == 0.5
    assert r.as_dict()["t_collective"] is None
    r = Roofline(chips=1, hlo_flops=0, hlo_bytes=0,
                 collective_bytes=H100_SXM["nvlink_bw"], model_flops=0)
    assert r.bound == "collective" and r.t_bound == 1.0


# ---------------------------------------------------------------------------
# against the reference's analysis of its compiled cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,tol", [("prefill_32k", 0.02),
                                       ("decode_32k", 0.02),
                                       ("train_4k", 0.03)])
def test_reduced_cell_flops_match_hlo_static(shape, tol):
    jmesh = jax_host_mesh(shape=(1, 1))
    jcell = jax_build_cell("qwen3-0.6b", shape, jmesh, reduced=True)
    with jmesh:
        want = analyze_hlo(jcell.lower().compile().as_text()).flops
    cell = build_cell("qwen3-0.6b", shape, make_host_mesh((1, 1), device="cpu"),
                      reduced=True)
    got = cell.analyze().flops
    assert got == pytest.approx(want, rel=tol)


def test_dryrun_writes_a_full_width_record(tmp_path, capsys):
    rec = dryrun.run_cell("qwen3-0.6b", "decode_32k", multi_pod=False,
                          out_dir=str(tmp_path))
    on_disk = json.loads((tmp_path / "qwen3-0.6b__decode_32k__pod16x16.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert rec["ok"] and rec["chips"] == 256
    for key in ("trace_s", "argument_bytes_per_device", "peak_live_bytes",
                "per_device_estimate", "static_per_device", "roofline",
                "collectives", "collectives_reason", "t_bound", "wall_s"):
        assert key in rec, key
    # the serving cell under make_policy: 8 kv heads do not divide 16, so
    # the cache's length is split over "model"; per layer the FSDP blocks
    # of wq, wk, wv, wo and the MLP's two are gathered over "data" and the
    # four attention blocks over "model" (10 all-gathers), the MLP output
    # is summed and the merge takes a MAX and a SUM (3 all-reduces); once a
    # step the embedding sum and the logits gather
    coll = rec["collectives"]
    assert rec["collectives_reason"] is None
    assert coll["by_op_count"] == {"all-gather": 28 * 10 + 1,
                                   "all-reduce": 28 * 3 + 1}
    assert coll["by_site_count"] == {
        "embed": 1, "gather-data": 28 * 6, "gather-model": 28 * 4,
        "mlp_out": 28, "attn-merge-max": 28, "attn-merge-sum": 28,
        "logits": 1}
    assert coll["per_device_wire_bytes"] == pytest.approx(
        sum(coll["by_op_bytes"].values()))
    # the logits: 8 rows a device (128 over "data" 16) of 152,064 bf16,
    # each device holding 1/16 of the vocab
    assert coll["by_site_bytes"]["logits"] == 15 * 8 * 152064 * 2 / 16
    roof = rec["roofline"]
    assert roof["chips"] == 256 and roof["bound"] in ("compute", "memory")
    assert roof["collective_bytes"] == pytest.approx(
        256 * coll["per_device_wire_bytes"])
    assert 0 < roof["useful_flops_ratio"] < 1.25
    # 28 layers of a 128 x 32768 cache (bf16, 8 kv heads of 128) and the
    # weights, laid out over 16 x 16: the cache's length over "model" (8
    # kv heads do not divide 16) and its batch over "data"
    cache = 28 * 2 * 128 * 32768 * 8 * 128 * 2
    assert rec["peak_live_bytes"] > cache
    assert cache / 256 < rec["argument_bytes_per_device"] < cache / 256 + 2**30
    # every family's serving cell records its collectives: mamba2's 32
    # heads split 2 a device over "model" 16, its one group of B and C
    # gathered whole (the FSDP and "model" blocks of wb and wc), the gated
    # norm's sum and the output's sum a layer
    other = dryrun.run_cell("mamba2-370m", "decode_32k", multi_pod=False,
                            out_dir=str(tmp_path))
    assert other["collectives_reason"] is None
    assert other["collectives"]["by_site_count"] == {
        "embed": 1, "gather-data": 48 * 6, "gather-model": 48 * 2,
        "ssm-norm": 48, "attn_out": 48, "logits": 1}
    # a train cell too, backward included (full remat, 2 x 4096 rows a
    # data group of 16 at 128 rows): a layer's 6 FSDP and 4 attention
    # gathers in the forward and again in its recompute, each FSDP gather's
    # reduce-scatter; the MLP's sum once (the recompute stops before it)
    # and its entry's sum backward; the vocab-parallel loss's MAX and
    # packed SUM for each of 32 chunks of 128 positions and the hidden
    # state's entry sum; the count and the loss over "data"; the gradients
    # of the replicated leaves (the table, the norms) summed, and the
    # norm's two packed sums (over "data" and over "model")
    train = dryrun.run_cell("qwen3-0.6b", "train_4k", multi_pod=False,
                            out_dir=str(tmp_path))
    assert train["collectives_reason"] is None
    assert train["collectives"]["by_site_count"] == {
        "embed": 1, "gather-data": 28 * 6 * 2, "gather-model": 28 * 4 * 2,
        "bwd:gather-data": 28 * 6, "mlp_out": 28, "bwd:mlp_in": 28,
        "loss-max": 32, "loss-sum": 32, "bwd:logits_in": 1, "tokens": 1,
        "loss": 1, "grad-sum": 1, "grad-norm": 2}
    assert train["collectives"]["by_op_count"] == {
        "all-gather": 28 * 10 * 2, "reduce-scatter": 28 * 6,
        "all-reduce": 1 + 28 * 2 + 32 * 2 + 1 + 1 + 1 + 1 + 2}
    one = build_cell("qwen3-0.6b", "train_4k",
                     make_host_mesh((1, 1), device="cpu"), reduced=True)
    assert one.policy is not None
    assert "one device" in dryrun.collectives_reason(one)
    skip = dryrun.run_cell("qwen3-0.6b", "long_500k", multi_pod=True,
                           out_dir=str(tmp_path))
    assert skip["skipped"] and skip["ok"] and "quadratic" in skip["reason"]
    assert "[ok] qwen3-0.6b decode_32k pod16x16" in capsys.readouterr().out
