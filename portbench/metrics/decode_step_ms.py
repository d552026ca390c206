"""Milliseconds a decode step: CUDA events from the end of each batch's
prefill to its end, summed over the window, over the decode steps they
hold; the steps inside the traced slice are left out (in a batch whose
slice closed mid-way, the time from there to its end counts)."""

LAYER = "session decode loop"
UNIT = "ms"
MOVES = "output_tok_s"


def read(ctx, got, trace):
    parts = [b.untraced_decode() for b in got["run"].batches]
    steps = sum(n for _, n in parts)
    if not steps:
        return None
    return sum(ms for ms, _ in parts) / steps
