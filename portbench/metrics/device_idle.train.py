"""The share of the traced slice in which nothing ran on the device:
1 - (the union of the device operations' intervals / the slice's wall
time)."""

LAYER = "device"
UNIT = "%"
MOVES = "train_tok_s"


def read(ctx, got, trace):
    if not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
