"""95th percentile (nearest rank) of submit -> first token over every
request whose first token reached the host in the window: the end-to-end
metric's own definition, kept per layer in the cells where it does not
repeat closely enough to bound (one admission bucket's duration sets it)."""

from perfbench import yardstick


def read(run):
    if not run.ttft:
        return None
    return 1e3 * yardstick.percentile(run.ttft, 0.95)
