"""Decode attention's share of the decode steps: the device time of the
program's ``decode_attention`` spans over that of the ``serve.decode_step``
spans that hold them, in the traced slice (a step still open when the
slice closed is cut at its last device operation). None without spans."""
from portbench import spans as spanlog

LAYER = "decode attention"
UNIT = "%"
MOVES = "output_tok_s"


def read(ctx, got, trace):
    spans = spanlog.log()
    pairs = spanlog.under(spans or [], "decode_attention", "serve.decode_step")
    if not pairs:
        return None
    end = spanlog.slice_end_us(trace)
    steps = {p.id: p for _, p in pairs}.values()
    attn = sum(spanlog.device_s(s, end) for s, _ in pairs)
    return 100.0 * attn / sum(spanlog.device_s(p, end) for p in steps)
