"""Share (%) of its roofline that the paged-decode kernel reaches in the
traced segment: the least time of every launch (each layer of each decode
step, over the rows that decoded a token there, each reading its real K/V
rows once) over the summed time of the kernel's launches (split and
merge)."""

from perfbench import yardstick

KERNELS = ("paged_decode_split_kernel", "paged_decode_merge_kernel")


def read(run):
    seg = run.seg
    if seg is None:
        return None
    spent = seg.kernel_us(KERNELS) * 1e-6
    bound = 0.0
    for rnd in seg.rounds:
        for T, rows in rnd.chunks:
            for t in range(T):
                ctx = [run.reqs[rid].n_prompt + n0 + t
                       for rid, n0, c in rows if c > t]
                if ctx:
                    bound += run.dims.n_layers * yardstick.paged_decode_bound_s(
                        run.dims, ctx, run.page_size)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
