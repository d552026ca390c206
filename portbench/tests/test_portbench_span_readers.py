"""The readers of the program's spans (``portbench/spans.py`` and the four
metrics that read it) on synthetic span logs and traces, against numbers
worked out by hand; None where the program recorded no span."""
from types import SimpleNamespace as NS

import pytest

from portbench import harness, yardstick
from portbench import spans as spanlog
from portbench.trace import Trace

DENSE = harness.config("deepseek-7b")["model"]
READERS = ["decode_attn_share", "launches_per_decode_step", "optimizer_ms",
           "flash_fwd_roofline.prefill"]


def span(id, name, parent, device_ms, host_ms=None):
    """A recorded span; intervals given in ms, held in ns as the program's."""
    dev = tuple(round(t * 1e6) for t in device_ms)
    host = tuple(None if t is None else round(t * 1e6) for t in (host_ms or device_ms))
    return NS(id=id, name=name, parent=parent, device=dev, host=host, attrs={})


def decode_log(rag_like: bool):
    """Two decode steps of 10 ms, two decode attentions each (5 and 3 ms),
    and one outside any step; RAG-like: a third step that the slice closed
    inside, open on the device until 90 ms, its attention 3 ms."""
    log = [span(1, "serve.generate", None, (0, 30)),
           span(2, "serve.decode_step", 1, (0, 10)),
           span(3, "decode_attention", 2, (1, 4)),
           span(4, "decode_attention", 2, (5, 7)),
           span(5, "serve.decode_step", 1, (10, 20)),
           span(6, "layer", 5, (10.5, 15)),
           span(7, "decode_attention", 6, (11, 13)),    # a step's, one level down
           span(8, "decode_attention", 5, (14, 15)),
           span(9, "decode_attention", 1, (0, 29))]     # under no step
    if rag_like:
        log += [span(10, "serve.decode_step", 1, (20, 90)),
                span(11, "decode_attention", 10, (21, 24))]
    return log


# device operations in µs; the slice's last ends at 25 ms
OPS = [("h", -50.0, -10.0), ("a", 100.0, 200.0), ("b", 2000.0, 2500.0),
       ("c", 9000.0, 9900.0), ("d", 10500.0, 11000.0), ("e", 19999.0, 20000.0),
       ("f", 20000.0, 21000.0), ("g", 24000.0, 25000.0)]


def serve_ctx():
    return NS(model=DENSE, mix={"trace": {"batch": 0}})


@pytest.fixture
def with_log(monkeypatch):
    def plant(log):
        monkeypatch.setattr(spanlog, "log", lambda: log)
    return plant


@pytest.mark.parametrize("rag_like, want", [(False, 100 * 8 / 20), (True, 100 * 11 / 25)])
def test_decode_attn_share(with_log, rag_like, want):
    with_log(decode_log(rag_like))
    got = harness.reader("decode_attn_share").read(serve_ctx(), {}, Trace(ops=OPS))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("rag_like, want", [(False, 5 / 2), (True, 7 / 3)])
def test_launches_per_decode_step(with_log, rag_like, want):
    with_log(decode_log(rag_like))
    got = harness.reader("launches_per_decode_step").read(serve_ctx(), {}, Trace(ops=OPS))
    assert got == pytest.approx(want)


def test_optimizer_ms(with_log):
    with_log([span(1, "train.step", None, (0, 1000)),
              span(2, "train.optimizer", 1, (800, 920)),
              span(3, "train.step", None, (1000, 2000)),
              span(4, "train.optimizer", 3, (1850, 1980))])
    got = harness.reader("optimizer_ms").read(NS(model=DENSE, mix={}), {}, Trace())
    assert got == pytest.approx(125.0)


def test_flash_fwd_roofline_prefill_reads_the_prefills_calls(with_log):
    log = [span(1, "serve.generate", None, (0, 1000)), span(2, "serve.prefill", 1, (0, 500))]
    log += [span(10 + i, "flash_attention", 2, (10 * i, 10 * i + 2.5)) for i in range(29)]
    log += [span(50, "layer", 2, (400, 450)), span(51, "flash_attention", 50, (400, 402.5)),
            span(60, "serve.decode_step", 1, (500, 600)),
            span(61, "flash_attention", 60, (510, 600))]     # a decode step's
    with_log(log)
    b = [NS(rows=4, prompt_len=6640, traced=True), NS(rows=4, prompt_len=7304, traced=False)]
    least = 30 * yardstick.bound_s(*yardstick.attention_cost(4, 6640, 6640, 32, 32, 128))
    got = harness.reader("flash_fwd_roofline.prefill").read(
        serve_ctx(), {"run": NS(batches=b)}, Trace(ops=OPS))
    assert got == pytest.approx(100 * least / (30 * 2.5e-3))


@pytest.mark.parametrize("name", READERS)
def test_no_spans_read_none(with_log, monkeypatch, name):
    got = {"run": NS(batches=[NS(rows=4, prompt_len=8, traced=True)])}
    ctx, trace = serve_ctx(), Trace(ops=OPS, window_s=1.0)
    with_log(None)
    assert harness.reader(name).read(ctx, got, trace) is None
    with_log([span(1, "other", None, (0, 1))])
    assert harness.reader(name).read(ctx, got, trace) is None


def test_the_program_without_a_recorder_gives_no_log(monkeypatch):
    from repro_torch import census
    census.clear_spans()
    assert spanlog.log() is None                  # nothing recorded
    monkeypatch.delattr(census, "spans")          # an older program
    assert spanlog.log() is None


def test_idle_gaps_are_put_down_to_the_innermost_open_span():
    ops = [("a", 0.0, 100.0), ("b", 300.0, 400.0), ("c", 1000.0, 1100.0),
           ("d", 5000.0, 5100.0)]
    log = [span(1, "serve.generate", None, (0, 2), host_ms=(0, 2)),
           span(2, "serve.decode_step", 1, (0.2, 0.6), host_ms=(0.25, 0.5)),
           span(3, "serve.decode_step", 1, (2, 3), host_ms=(1.9, None))]   # still open
    got = spanlog.idle_gaps(Trace(ops=ops), log)
    assert got == [["serve.decode_step", pytest.approx(3900e-6)],
                   ["serve.generate", pytest.approx(600e-6)],
                   ["serve.decode_step", pytest.approx(200e-6)]]
    assert spanlog.idle_gaps(Trace(ops=ops), None)[0] == [spanlog.OUTSIDE,
                                                         pytest.approx(3900e-6)]


def test_the_clock_join_finds_each_prefill_call_holding_its_kernel():
    log = [span(1, "serve.prefill", None, (0, 10)),
           span(2, "flash_attention", 1, (1, 2)), span(3, "flash_attention", 1, (3, 4))]
    ops = [("void flash_fwd_kernel<128>", 1001.0, 1998.0),
           ("void flash_fwd_kernel<128>", 3002.0, 4001.0)]
    got = spanlog.clock_join(Trace(ops=ops), log)
    assert got["spans"] == 2 and got["holding_one"] == 2
    assert got["lead_us"] == [pytest.approx(1.0), pytest.approx(2.0)]
    assert got["tail_us"] == [pytest.approx(-1.0), pytest.approx(2.0)]
