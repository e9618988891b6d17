"""Share (%) of the window's decode chunks that the batcher served by
replaying a captured CUDA graph (``BatcherStats.graph_chunks`` over
``chunks``); None where the program keeps no such counter."""


def read(run):
    c = run.counters
    if "graph_chunks" not in c or not c["chunks"]:
        return None
    return 100.0 * c["graph_chunks"] / c["chunks"]
