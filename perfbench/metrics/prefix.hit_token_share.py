"""Share (%) of the real prompt tokens admitted in the window that came
from shared pages of the prefix cache (``prefill_tokens_skipped``)."""


def read(run):
    if run.prompt_tokens <= 0:
        return None
    return 100.0 * run.counters["prefill_tokens_skipped"] / run.prompt_tokens
