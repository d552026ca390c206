"""The readers of the decode layer's shares: ``decode_attn_roofline`` (the
program's ``decode_attention_kernel`` spans) on synthetic span logs and
traces, and ``decode_mfu`` (the benchmark's own decode-step events), against
numbers worked out by hand; None where there is nothing to read."""
from types import SimpleNamespace as NS

import pytest

from portbench import harness, yardstick
from portbench import spans as spanlog
from portbench.trace import Trace

DENSE = harness.config("deepseek-7b")["model"]
# device operations in µs; the slice's last ends at 25 ms
OPS = [("a", 100.0, 200.0), ("b", 9000.0, 9900.0), ("g", 24000.0, 25000.0)]


def span(id, name, parent, device_ms, attrs=None):
    """A recorded span; its device interval given in ms, held in ns."""
    dev = tuple(round(t * 1e6) for t in device_ms)
    return NS(id=id, name=name, parent=parent, device=dev, host=dev, attrs=attrs or {})


def serve_ctx():
    return NS(model=DENSE, mix={"trace": {"batch": 0}})


@pytest.fixture
def with_log(monkeypatch):
    def plant(log):
        monkeypatch.setattr(spanlog, "log", lambda: log)
    return plant


def kernel_log(rag_like: bool):
    """Two decode steps (index 0 and 1) of one batch, each with two layers'
    ``decode_attention`` spans holding a ``decode_attention_kernel`` span of
    0.1 ms (the second step's one level further down), and a kernel span
    under no step; RAG-like: a third step that the slice (ending at 25 ms)
    closes inside, one kernel span ending before the slice's end and one
    after it."""
    log = [span(1, "serve.generate", None, (0, 30)),
           span(2, "serve.decode_step", 1, (0, 10), {"index": 0}),
           span(3, "decode_attention", 2, (1, 2)),
           span(4, "decode_attention_kernel", 3, (1.0, 1.1)),
           span(5, "decode_attention", 2, (3, 4)),
           span(6, "decode_attention_kernel", 5, (3.0, 3.1)),
           span(7, "serve.decode_step", 1, (10, 20), {"index": 1}),
           span(8, "layer", 7, (10, 15)),
           span(9, "decode_attention", 8, (11, 12)),
           span(10, "decode_attention_kernel", 9, (11.0, 11.1)),
           span(11, "decode_attention", 7, (16, 17)),
           span(12, "decode_attention_kernel", 11, (16.0, 16.1)),
           span(13, "decode_attention_kernel", 1, (18.0, 18.1))]    # under no step
    if rag_like:
        log += [span(14, "serve.decode_step", 1, (20, 90), {"index": 2}),
                span(15, "decode_attention", 14, (21, 22)),
                span(16, "decode_attention_kernel", 15, (21.0, 21.1)),
                span(17, "decode_attention", 14, (24.5, 26)),
                span(18, "decode_attention_kernel", 17, (24.95, 25.05))]
    return log


@pytest.mark.parametrize("rag_like", [False, True])
def test_decode_attn_roofline(with_log, rag_like):
    """deepseek-7b (H = KVH = 32, D = 128) at 4 rows of a 100-token prompt:
    a call over kv positions reads 2 x 2 x 4 x 32 x 128 B = 65 536 B a
    position, and q and the output 65 536 B, against 65 536 kv FLOPs: bound
    by bytes, 65 536 (kv + 1) / 3.35e12 s. Steps 0 and 1 see 101 and 102
    positions, two calls each; the RAG-like step 2 one more call at 103
    (its second ends past the slice)."""
    with_log(kernel_log(rag_like))
    b = [NS(rows=4, prompt_len=100, traced=True), NS(rows=32, prompt_len=7, traced=False)]
    kvs = [101, 101, 102, 102] + ([103] if rag_like else [])
    least = sum(65536 * (kv + 1) / 3.35e12 for kv in kvs)
    assert least == pytest.approx(sum(yardstick.bound_s(*yardstick.attention_cost(
        4, 1, kv, 32, 32, 128, q_offset=kv - 1)) for kv in kvs))
    got = harness.reader("decode_attn_roofline").read(
        serve_ctx(), {"run": NS(batches=b)}, Trace(ops=OPS))
    assert got == pytest.approx(100 * least / (len(kvs) * 1e-4))


def test_decode_attn_roofline_reads_none_without_kernel_spans(with_log):
    got = {"run": NS(batches=[NS(rows=4, prompt_len=8, traced=True)])}
    for log in (None, [span(1, "serve.decode_step", None, (0, 1), {"index": 0}),
                       span(2, "decode_attention", 1, (0, 1))]):
        with_log(log)
        assert harness.reader("decode_attn_roofline").read(
            serve_ctx(), got, Trace(ops=OPS)) is None


def decode_batch(rows, prompt_len, steps, untraced):
    """A batch record whose decode steps outside the traced slice are
    ``untraced`` = (ms, steps)."""
    return NS(rows=rows, prompt_len=prompt_len, decode_steps=steps,
              untraced_decode=lambda: untraced)


def test_decode_mfu():
    """deepseek-7b: 2 x 6 490 685 440 parameters a token (30 layers of
    attention 4 x 4096^2 and SiLU FFN 3 x 4096 x 11008, the lm_head 4096 x
    102 400) x rows, and 4 x rows x 32 x 128 x kv x 30 layers of attention.
    Batch 1: untraced, 3 steps over 11, 12, 13 positions in 2 ms; batch 0,
    traced: its last 2 of 5 steps (over 1 004 and 1 005) in 1 ms."""
    per_token = 30 * 4 * 4096 ** 2 + 30 * 3 * 4096 * 11008 + 4096 * 102400
    assert per_token == 6490685440 == sum(yardstick.matmul_params(DENSE).values())
    b = [decode_batch(4, 1000, 5, (1.0, 2)), decode_batch(32, 10, 3, (2.0, 3))]
    flops = 2 * per_token * (4 * 2 + 32 * 3) + \
        4 * 32 * 128 * 30 * (4 * (1004 + 1005) + 32 * (11 + 12 + 13))
    got = harness.reader("decode_mfu").read(serve_ctx(), {"run": NS(batches=b)}, Trace())
    assert got == pytest.approx(100 * flops / (3e-3 * 989e12))


def test_decode_mfu_reads_none_without_untraced_steps():
    none = [decode_batch(4, 1000, 5, (0.0, 0))]
    assert harness.reader("decode_mfu").read(serve_ctx(), {"run": NS(batches=none)},
                                             Trace()) is None
