"""Milliseconds of the AdamW update a step: the mean device time of the
program's ``train.optimizer`` spans in the traced steps. None without
spans."""
from portbench import spans as spanlog

LAYER = "optimizer"
UNIT = "ms"
MOVES = "train_tok_s"


def read(ctx, got, trace):
    opt = [s for s in spanlog.log() or [] if s.name == "train.optimizer"]
    if not opt:
        return None
    return 1e3 * sum(spanlog.device_s(s) for s in opt) / len(opt)
