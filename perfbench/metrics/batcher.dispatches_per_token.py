"""Admission, chunk and page-push dispatches of the batcher in the window
for each token delivered (``BatcherStats`` counters)."""


def read(run):
    c = run.counters
    tokens = c["decode_tokens"] + c["admit_tokens"] - c["oom_discarded_tokens"]
    if tokens <= 0:
        return None
    return c["dispatches"] / tokens
