"""Share (%) of the traced segment's wall time (sync to sync) in which no
kernel ran on the card: 1 - union of kernel intervals / wall."""


def read(run):
    seg = run.seg
    if seg is None or not seg.kernels or seg.wall_s <= 0:
        return None
    return 100.0 * (1.0 - seg.busy_s / seg.wall_s)
