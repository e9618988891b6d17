"""Share (%) of the card's busy time that kernels launched inside the
program's ``moe.expert_products`` profiler range take (the traced segment
with the host's ops)."""


def read(run):
    seg = run.host_seg
    if seg is None or not seg.kernels:
        return None
    us = seg.range_us.get("moe.expert_products")
    if not us:
        return None
    return 100.0 * us * 1e-6 / seg.busy_s
