"""Device operations a decode step: those of the trace that start inside
the device intervals of the program's ``serve.decode_step`` spans, over
the number of those spans, in the traced slice. None without spans."""
from portbench import spans as spanlog

LAYER = "session decode loop"
UNIT = "ops"
MOVES = "output_tok_s"


def read(ctx, got, trace):
    steps = [s for s in spanlog.log() or [] if s.name == "serve.decode_step"]
    if not steps or not trace.ops:
        return None
    end = spanlog.slice_end_us(trace)
    return spanlog.ops_inside(trace, [spanlog.device_us(s, end) for s in steps]) / len(steps)
