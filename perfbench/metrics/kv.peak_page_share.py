"""Share (%) of the KV pool's pages in use at the run's peak
(``peak_pages_in_use`` over the pool's pages)."""


def read(run):
    return 100.0 * run.stats_end["peak_pages_in_use"] / run.n_pages
