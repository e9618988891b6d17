"""The window's milliseconds over the decode steps the batcher ran in it
(``BatcherStats.steps``): a window average, admissions included."""


def read(run):
    steps = run.counters["steps"]
    return 1e3 * run.window_s / steps if steps else None
