"""Each per-layer metric's reader on synthetic records, against numbers
worked out by hand."""
from types import SimpleNamespace as NS

import pytest

from portbench import harness, yardstick
from portbench.reference import decoder
from portbench.trace import Trace

DENSE = harness.config("deepseek-7b")["model"]
MOE = harness.config("deepseek-moe-16b.l8")["model"]
TRAIN_MIX = {"batch": 2, "seq_len": 4096, "remat": "full", "trace": {"steps": 2}}


class Ev:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def batch(rows, S, new, t0, prefill_ms, decode_ms, traced=False, after=None):
    """A batch record; ``after`` (ms, steps) outside a traced slice that
    closed mid-batch."""
    untraced = (decode_ms, new - 1) if not traced else (after or (0.0, 0))
    return NS(rows=rows, prompt_len=S, new_tokens=new, traced=traced,
              decode_steps=new - 1, ttft_ms=lambda: prefill_ms,
              decode_ms=lambda: decode_ms, untraced_decode=lambda: untraced)


def serve_ctx(model=DENSE):
    return NS(model=model, mix={"trace": {"batch": 0}}, family=decoder)


def test_prefill_mfu():
    b = [batch(4, 6640, 24, 0, 1000.0, 1200.0), batch(4, 8632, 24, 0, 1300.0, 1300.0)]
    got = {"run": NS(batches=b)}
    flops = decoder.forward_flops(DENSE, 4, 6640, 0) + decoder.forward_flops(DENSE, 4, 8632, 0)
    want = 100 * flops / (2.3 * 989e12)
    assert harness.reader("prefill_mfu").read(serve_ctx(), got, None) == pytest.approx(want)


def test_flash_fwd_roofline_and_its_missing_kernel():
    b = [batch(4, 6640, 24, 0, 1.0, 1.0, traced=True), batch(4, 7304, 24, 0, 1.0, 1.0)]
    got = {"run": NS(batches=b)}
    trace = Trace(ops=[("void flash_fwd_kernel<128>(x)", 0.0, 1000.0)] * 30 +
                  [("gemm", 0.0, 5000.0)], window_s=1.0)
    least = 30 * yardstick.bound_s(*yardstick.attention_cost(4, 6640, 6640, 32, 32, 128))
    got_v = harness.reader("flash_fwd_roofline").read(serve_ctx(), got, trace)
    assert got_v == pytest.approx(100 * least / 0.030)
    with pytest.raises(RuntimeError):
        harness.reader("flash_fwd_roofline").read(serve_ctx(), got, Trace(ops=[("gemm", 0, 1)]))


def test_decode_step_ms_leaves_out_the_traced_steps():
    b = [batch(4, 6640, 24, 0, 1.0, 999.0, traced=True),
         batch(4, 6640, 24, 0, 1.0, 230.0), batch(4, 6640, 24, 0, 1.0, 460.0)]
    read = harness.reader("decode_step_ms").read
    assert read(serve_ctx(), {"run": NS(batches=b)}, None) == pytest.approx(690.0 / 46)
    b[0] = batch(32, 1200, 200, 0, 1.0, 9999.0, traced=True, after=(1590.0, 159))
    assert read(serve_ctx(), {"run": NS(batches=b)}, None) == pytest.approx(2280.0 / 205)
    assert read(serve_ctx(), {"run": NS(batches=b[:1])}, None) == pytest.approx(10.0)
    assert read(serve_ctx(), {"run": NS(batches=[batch(4, 8, 24, 0, 1.0, 5.0,
                                                        traced=True)])}, None) is None


@pytest.mark.parametrize("name", ["device_idle.serve", "device_idle.train"])
def test_device_idle_is_the_union(name):
    trace = Trace(ops=[("a", 0.0, 100.0), ("b", 50.0, 150.0), ("c", 300.0, 400.0)],
                  window_s=500e-6)
    assert trace.busy_s() == pytest.approx(250e-6)
    assert harness.reader(name).read(None, None, trace) == pytest.approx(50.0)
    gaps = trace.idle_gaps()
    assert gaps[0] == ["after b", pytest.approx(150e-6)]


def test_train_mfu_skips_the_traced_steps():
    ctx = NS(model=DENSE, mix=TRAIN_MIX, family=decoder)
    got = {"run": NS(steps=[(9.0, 8192), (9.0, 8192), (2.0, 8192), (2.0, 8192)])}
    want = 100 * 2 * 3 * decoder.forward_flops(DENSE, 2, 4096, 0) / (4.0 * 989e12)
    assert harness.reader("train_mfu").read(ctx, got, None) == pytest.approx(want)


def test_flash_bwd_roofline():
    ctx = NS(model=DENSE, mix=TRAIN_MIX)
    ops = [("flash_bwd_dkdv_kernel", 0, 400.0), ("flash_bwd_dq_kernel", 0, 250.0),
           ("flash_bwd_delta_kernel", 0, 50.0)] * 60
    least = 60 * yardstick.bound_s(*yardstick.attention_bwd_cost(2, 4096, 4096, 32, 32, 128))
    assert harness.reader("flash_bwd_roofline").read(ctx, {}, Trace(ops=ops)) == \
        pytest.approx(100 * least / (60 * 700e-6))


def test_gmm_roofline_counts_routed_rows_and_the_recompute():
    mix = dict(TRAIN_MIX, batch=4)
    ctx = NS(model=MOE, mix=mix)
    ops = [("void gmm_wgmma_kernel<2, 128>(...)", 0, 500.0)] * (2 * 7 * (3 * 2 + 3 * 2))
    seconds = len(ops) * 500e-6
    rows = 4 * 4096 * 6
    E = 64
    one = sum(2 * yardstick.bound_s(*yardstick.gmm_cost(E, rows / E, a, b)) +
              yardstick.bound_s(*yardstick.gmm_bwd_cost(E, rows / E, a, b))
              for a, b in ((2048, 1408), (2048, 1408), (1408, 2048)))
    want = 100 * 2 * 7 * one / seconds
    assert harness.reader("gmm_roofline").read(ctx, {}, Trace(ops=ops)) == pytest.approx(want)
    assert harness.reader("gmm_roofline").read(NS(model=DENSE, mix=mix), {}, Trace()) is None
