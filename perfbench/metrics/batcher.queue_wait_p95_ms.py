"""95th percentile (nearest rank) of the queue wait, the program's
``Request.t_admit - Request.t_submit`` (the batcher's stamps, on its
clock), over the requests whose first token reached the host in the
window: the part of ``ttft_p95_ms``'s requests' time spent waiting for a
slot or for pages before their admission dispatch.  A program whose
requests carry no stamps reads nothing."""

from perfbench import yardstick


def window_requests(run):
    """The requests whose first token reached the host in the window.  The
    view keeps their TTFTs in request order (``run.ttft``), not the
    window's bounds; the window is an interval of the host clock, so its
    requests are consecutive in first-token order, and they are the run of
    ``len(run.ttft)`` such requests, whole admissions, whose TTFTs are
    ``run.ttft``.  Only requests first served after the window follow it."""
    n = len(run.ttft)
    if n == 0:
        return []
    got = sorted((r for r in run.reqs.values() if r.first_t is not None),
                 key=lambda r: (r.first_t, r.rid))
    want = sorted(run.ttft)
    for end in range(len(got), n - 1, -1):
        lo = end - n
        if (end < len(got) and got[end].first_t == got[end - 1].first_t) \
                or (lo > 0 and got[lo - 1].first_t == got[lo].first_t):
            continue                     # the cut splits one admission
        block = got[lo:end]
        if sorted(r.first_t - r.submit_t for r in block) == want:
            return block
    return []


def read(run):
    waits = []
    for r in window_requests(run):
        t_admit = getattr(r.req, "t_admit", None)
        t_submit = getattr(r.req, "t_submit", None)
        if t_admit is not None and t_submit is not None:
            waits.append(t_admit - t_submit)
    if not waits:
        return None
    return 1e3 * yardstick.percentile(waits, 0.95)
