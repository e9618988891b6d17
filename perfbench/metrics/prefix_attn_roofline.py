"""Share (%) of its roofline that the prefix-flash kernel reaches in the
traced segment: the least time of every launch (each layer of each
admission that mapped cached pages, over its rows' real new tokens and
real cached keys; the padding and the bucket's duplicate rows left out)
over the summed time of the kernel's launches."""

from perfbench import yardstick

KERNELS = ("pfx_kernel", "pfx_mma_kernel")


def read(run):
    seg = run.seg
    if seg is None:
        return None
    spent = seg.kernel_us(KERNELS) * 1e-6
    bound = 0.0
    for rnd in seg.rounds:
        for k, rows in rnd.admissions:
            if k:
                bound += run.dims.n_layers * yardstick.prefill_attn_bound_s(
                    run.dims, [(n_new, cached) for _, n_new, cached in rows])
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent
