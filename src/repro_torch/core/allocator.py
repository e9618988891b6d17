"""Workload-balanced IFP allocator — paper §5.2.2 (Eqs. 4-6).

Copy of ``repro.core.allocator`` for the port, which imports nothing of
``repro``; it is pure Python and must keep the reference's behaviour
(``tests/test_torch_vengine.py`` holds the two against each other).

Given the latencies ``T(i)`` of a layer's N IFPs and K allocated cores, find
``Alloc(i, k)`` minimizing the makespan ``max_k sum_i Alloc(i,k) T(i)`` with
every IFP assigned to exactly one core.

Two solvers, both on the ~1 ms dynamic-compilation path:

* :func:`allocate_contiguous_dp` — exact DP over *contiguous* chunks (the
  classic linear-partition problem, O(N^2 K)).  Contiguity is what the
  hardware wants anyway: each core receives one concatenated instruction
  sequence, and contiguous same-layer tiles enable the on-chip reuse dedupe.
* :func:`allocate_lpt` — longest-processing-time greedy (non-contiguous),
  a 4/3-approximation, used as a cross-check and for very large N.

``allocate`` runs the DP and returns per-core index lists.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def allocate_contiguous_dp(
    times: Sequence[float], k: int, *, run_overhead: float = 0.0
) -> Tuple[List[List[int]], float]:
    """Exact minimal-makespan partition of ``times`` into <= k contiguous runs.

    ``run_overhead`` is a fixed cost added once per non-empty run — it models
    the one cold load each core pays before on-chip reuse kicks in for the
    rest of its contiguous tile run (shared weights under WIDTH tiling,
    replicated input under OC tiling), so ``times`` should then be the
    *cached* per-IFP latencies.

    Returns (per-core index lists, makespan).  Cores beyond ``len(times)``
    receive empty lists.
    """
    n = len(times)
    if n == 0:
        return [[] for _ in range(k)], 0.0
    k_eff = min(k, n)
    prefix = [0.0]
    for t in times:
        prefix.append(prefix[-1] + t)

    INF = float("inf")
    # dp[j][i] = best makespan splitting the first i items into j runs
    dp = [[INF] * (n + 1) for _ in range(k_eff + 1)]
    cut = [[0] * (n + 1) for _ in range(k_eff + 1)]
    dp[0][0] = 0.0
    for j in range(1, k_eff + 1):
        for i in range(j, n + 1):
            # last run is (p, i]; sweep p from high to low, prune when the
            # last-run sum already exceeds the best found (it only grows).
            best, best_p = INF, j - 1
            for p in range(i - 1, j - 2, -1):
                last = prefix[i] - prefix[p] + run_overhead
                if last >= best:
                    break  # larger p won't help; smaller p only grows `last`
                cand = max(dp[j - 1][p], last)
                if cand < best:
                    best, best_p = cand, p
            dp[j][i] = best
            cut[j][i] = best_p
    # backtrack
    bounds = [n]
    i = n
    for j in range(k_eff, 0, -1):
        i = cut[j][i]
        bounds.append(i)
    bounds.reverse()
    runs = [list(range(bounds[j], bounds[j + 1])) for j in range(k_eff)]
    runs += [[] for _ in range(k - k_eff)]
    return runs, dp[k_eff][n]


def partition_candidates(
    times: Sequence[float], *, run_overhead: float = 0.0
) -> Tuple[List[float], List[float]]:
    """(prefix sums, sorted candidate makespans) for the binary-search solver.
    Depends only on the latency LUT, so the static compiler precomputes it —
    the dynamic path then binary-searches in O(N log N)."""
    prefix = [0.0]
    for t in times:
        prefix.append(prefix[-1] + t)
    n = len(times)
    cands = sorted(
        {prefix[j] - prefix[i] + run_overhead for i in range(n) for j in range(i + 1, n + 1)}
    )
    return prefix, cands


def allocate_contiguous_bs(
    times: Sequence[float], k: int, *, run_overhead: float = 0.0,
    precomputed: Optional[Tuple[List[float], List[float]]] = None,
) -> Tuple[List[List[int]], float]:
    """Exact contiguous partition via binary search over candidate makespans.

    The optimal makespan equals some contiguous run sum (+ overhead), i.e. one
    of the O(N²) prefix-sum differences.  Binary-search those candidates with
    a greedy O(N) feasibility check (pack greedily; feasible iff ≤ k runs).
    O(N² + N² log N) with tiny constants — ~40× faster than the O(N²K) DP on
    the dynamic-compilation path, and verified equal-makespan against the DP
    in tests (hypothesis property).
    """
    n = len(times)
    if n == 0:
        return [[] for _ in range(k)], 0.0
    k_eff = min(k, n)
    if precomputed is not None:
        prefix, cands = precomputed
    else:
        prefix, cands = partition_candidates(times, run_overhead=run_overhead)
    if k_eff >= n:
        # one tile per core: assignment is the identity
        runs = [[i] for i in range(n)] + [[] for _ in range(k - n)]
        return runs, max(times) + run_overhead

    def runs_needed(cap: float) -> int:
        """Greedy: max-length runs with sum+overhead <= cap."""
        runs, i, eps = 0, 0, cap * 1e-12
        while i < n:
            runs += 1
            if runs > k_eff:
                return runs
            start = prefix[i]
            j = i
            while j < n and (prefix[j + 1] - start) + run_overhead <= cap + eps:
                j += 1
            if j == i:       # single item exceeds cap -> infeasible
                return k_eff + 1
            i = j
        return runs

    lo, hi = 0, len(cands) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if runs_needed(cands[mid]) <= k_eff:
            hi = mid
        else:
            lo = mid + 1
    cap = cands[lo]

    # reconstruct: greedy packing, but never strand more items than cores left
    runs: List[List[int]] = []
    i, eps = 0, cap * 1e-12
    while i < n:
        start = prefix[i]
        j = i
        while j < n and (prefix[j + 1] - start) + run_overhead <= cap + eps:
            j += 1
        j = max(j, i + 1)
        # leave at least one item per remaining core
        remaining_cores = k_eff - len(runs) - 1
        j = min(j, n - remaining_cores)
        runs.append(list(range(i, j)))
        i = j
    runs += [[] for _ in range(k - len(runs))]
    makespan = max(
        (prefix[r[-1] + 1] - prefix[r[0]] + run_overhead) for r in runs if r
    )
    return runs, makespan


def allocate_lpt(times: Sequence[float], k: int) -> Tuple[List[List[int]], float]:
    """Longest-processing-time greedy onto k cores (non-contiguous)."""
    import heapq

    order = sorted(range(len(times)), key=lambda i: -times[i])
    heap = [(0.0, c) for c in range(k)]
    heapq.heapify(heap)
    assign: List[List[int]] = [[] for _ in range(k)]
    for i in order:
        load, c = heapq.heappop(heap)
        assign[c].append(i)
        heapq.heappush(heap, (load + times[i], c))
    makespan = max((sum(times[i] for i in a) for a in assign), default=0.0)
    for a in assign:
        a.sort()
    return assign, makespan


def allocate_weighted(
    times: Sequence[float], speeds: Sequence[float]
) -> Tuple[List[List[int]], float]:
    """LPT onto heterogeneous cores: item i on core c costs ``times[i] /
    speeds[c]``.  Used by straggler mitigation (a slow core has speed < 1)."""
    import heapq

    k = len(speeds)
    order = sorted(range(len(times)), key=lambda i: -times[i])
    heap = [(0.0, c) for c in range(k)]
    heapq.heapify(heap)
    assign: List[List[int]] = [[] for _ in range(k)]
    loads = [0.0] * k
    for i in order:
        # pick the core minimizing its finish time after taking item i
        best_c, best_t = 0, float("inf")
        for load, c in heap:
            t = loads[c] + times[i] / max(speeds[c], 1e-9)
            if t < best_t:
                best_c, best_t = c, t
        assign[best_c].append(i)
        loads[best_c] = best_t
        heap = [(loads[c], c) for c in range(k)]
    for a in assign:
        a.sort()
    return assign, max(loads) if loads else 0.0


def allocate(
    times: Sequence[float], k: int, *, run_overhead: float = 0.0,
    precomputed: Optional[Tuple[List[float], List[float]]] = None,
) -> Tuple[List[List[int]], float]:
    """Workload-balanced allocation (Eq. 4-6): exact contiguous partition via
    the binary-search solver (equal makespan to the O(N²K) DP, much faster —
    this sits on the ~1 ms dynamic-compilation path).  When no per-run reuse
    is at stake (run_overhead == 0), an LPT cross-check is used in case
    contiguity binds."""
    runs_bs, ms_bs = allocate_contiguous_bs(
        times, k, run_overhead=run_overhead, precomputed=precomputed
    )
    if len(times) > k and run_overhead == 0.0:
        runs_lpt, ms_lpt = allocate_lpt(times, k)
        if ms_lpt < ms_bs * (1.0 - 1e-9):
            return runs_lpt, ms_lpt
    return runs_bs, ms_bs
