"""Share (%) of the card's bf16 peak that the model FLOPs the window's
traffic needed fill over the window: 2 x active parameters a token under
the published routing, the LM head at each output, QK^T and PV over the
real context; padding and an already-cached shared prefix left out."""

from perfbench import yardstick


def read(run):
    share = yardstick.mfu(run.work, run.dims, run.window_s)
    return None if share is None else 100.0 * share
