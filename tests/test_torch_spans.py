"""The span recorder of ``repro_torch.census`` on the CPU: it records while
torch.profiler is on and only then, sets no census, nests spans per
thread, brackets the session's steps, decode attention, the train step and
every kernel-wrapper call, stamps the profiler's clock, and leaves both the
profiler's events and a dry run's counts as they were."""
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import census  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as mg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import serve as serve_rt  # noqa: E402
from repro_torch.runtime import train as train_rt  # noqa: E402


@pytest.fixture(autouse=True)
def _empty_log():
    census.clear_spans()
    yield
    census.clear_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _session():
    model = build_model(get_config("deepseek-7b", reduced=True))
    params = model.init(torch.Generator().manual_seed(0))
    return serve_rt.ServeSession(model, params, device="cpu")


def _by_id(spans):
    return {s.id: s for s in spans}


def test_nothing_is_recorded_without_a_profiler():
    with census.span("stage", x=1):
        with census.kernel("k", lambda: (1, 2)):
            pass
    _session().generate(torch.zeros(1, 4, dtype=torch.long), 3)
    assert census.span("stage") is census.kernel("k", None)    # the shared no-op
    assert census.spans() == []


def test_recording_sets_no_census():
    with _cpu_profile():
        assert census.active() is None
        with census.span("stage"), census.kernel("k", lambda: (1, 2)):
            assert census.active() is None
    assert census.active() is None
    assert [s.name for s in census.spans()] == ["stage", "k"]


def test_spans_nest_with_one_stack_per_thread():
    seen = {}

    def other():
        with census.span("other") as s:
            seen["other"] = s
            with census.kernel("k2", lambda: (3, 4)):
                pass

    with _cpu_profile():
        with census.span("outer", a=1) as outer:
            with census.span("inner") as inner:
                with census.kernel("k", lambda: (5, 6)) as k:
                    with census.kernel("nested", lambda: (7, 8)) as nested:
                        pass             # the outer call's
                t = threading.Thread(target=other)
                t.start()
                t.join()
            with census.span("sibling") as sibling:
                pass
    spans = census.spans()
    assert [s.name for s in spans] == ["outer", "inner", "k", "other", "k2", "sibling"]
    assert nested is None                  # no span of its own
    assert (outer.parent, inner.parent, k.parent, sibling.parent) == \
        (None, outer.id, inner.id, outer.id)
    assert seen["other"].parent is None and spans[4].parent == seen["other"].id
    assert seen["other"].thread != outer.thread
    assert outer.attrs == {"a": 1} and k.cost == (5, 6) and outer.cost is None
    assert len({s.id for s in spans}) == len(spans)
    for s in spans:
        assert s.host[0] <= s.host[1] and s.device == s.host    # no CUDA here
    for child in (inner, sibling):
        assert outer.host[0] <= child.host[0] <= child.host[1] <= outer.host[1]


def test_a_span_open_when_the_profiler_stops_is_kept():
    prof = _cpu_profile()
    prof.__enter__()
    with census.span("step") as step:
        prof.__exit__(None, None, None)
        with census.span("after"):
            pass
    assert [s.name for s in census.spans()] == ["step"]
    assert step.host[1] is not None and step.device == step.host


def test_generate_records_the_session_steps_and_decode_attention():
    sess = _session()
    layers = sess.model.cfg.n_layers
    with _cpu_profile():
        out = sess.generate(torch.zeros(2, 5, dtype=torch.long), 4)
    assert out.shape == (2, 4)
    spans = census.spans()
    by = _by_id(spans)
    gen = [s for s in spans if s.name == "serve.generate"]
    assert len(gen) == 1 and gen[0].attrs == {"rows": 2, "prompt_len": 5,
                                              "new_tokens": 4}
    prefill = [s for s in spans if s.name == "serve.prefill"]
    steps = [s for s in spans if s.name == "serve.decode_step"]
    attn = [s for s in spans if s.name == "decode_attention"]
    assert len(prefill) == 1 and prefill[0].parent == gen[0].id
    assert [s.attrs["index"] for s in steps] == [0, 1, 2]
    assert all(s.parent == gen[0].id for s in steps)
    assert len(attn) == layers * len(steps)
    assert all(by[a.parent].name == "serve.decode_step" for a in attn)
    assert [a.attrs["Sk"] for a in attn] == [9] * len(attn)     # the cache's length
    assert all(a.attrs["B"] == 2 for a in attn)
    assert prefill[0].host[1] <= steps[0].host[0]


def test_the_train_step_records_the_optimizer():
    model = build_model(get_config("deepseek-7b", reduced=True))
    opts = train_rt.TrainOptions(remat_policy=None, opt=adamw.AdamWConfig())
    gen = torch.Generator().manual_seed(0)
    state = train_rt.init_train_state(model, gen, opts)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=gen)
    step = train_rt.build_train_step(model, opts)
    with _cpu_profile():
        step(state, {"tokens": tokens.int(), "labels": tokens.roll(-1, 1).int()})
    spans = census.spans()
    assert [s.name for s in spans] == ["train.step", "train.optimizer"]
    assert spans[1].parent == spans[0].id


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _flash(grad):
    q = _meta(1, 128, 2, 64).requires_grad_(grad)
    out = fa.flash_attention_cuda(q, q, q)
    if grad:
        torch.autograd.grad(out, q, torch.ones_like(out))
    return fa._cost(q, q, dict(causal=True, window=0, q_offset=0, kv_valid=None),
                    with_lse=grad), fa._bwd_cost(q, q, dict(causal=True, window=0,
                                                            kv_valid=None))


def _gmm(grad):
    x, w = _meta(4, 16, 64).requires_grad_(grad), _meta(4, 64, 32)
    out = mg.gmm_cuda(x, w)
    if grad:
        torch.autograd.grad(out, x, torch.ones_like(out))
    return mg._cost(x, w), mg._cost(x, w, mg.gmm_bwd_cost)


def _ssd(grad):
    B, L, H, P, G, N = 1, 256, 4, 64, 1, 64
    x = _meta(B, L, H, P).requires_grad_(grad)
    dt = _meta(B, L, H, dtype=torch.float32)
    bc = _meta(B, L, G, N)
    a, d = _meta(H, dtype=torch.float32), _meta(H, dtype=torch.float32)
    y, _ = ss.ssd_scan_cuda(x, dt, a, bc, bc, d, chunk=128)
    if grad:
        torch.autograd.grad(y, x, torch.ones_like(y))
    return ss._cost(x, bc, 128), ss._cost(x, bc, 128, ss.ssd_bwd_cost)


@pytest.mark.parametrize("name, call", [("flash_attention", _flash), ("gmm", _gmm),
                                        ("ssd_scan", _ssd)])
@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
def test_kernel_calls_are_spans_on_meta_tensors(name, call, grad):
    with _cpu_profile():
        with census.span("step") as step:
            fwd_cost, bwd_cost = call(grad)
    spans = census.spans()
    want = [("step", None), (name, fwd_cost)] + ([(name + "_bwd", bwd_cost)] if grad else [])
    assert [(s.name, s.cost) for s in spans] == want
    assert all(s.parent == step.id for s in spans[1:])


def test_decode_attention_holds_one_kernel_span_on_meta_tensors():
    """``ops.decode_attention`` records its stage span and inside it one
    ``decode_attention_kernel`` span at the visible prefix's cost: a name
    of its own, so that ``decode_attn_share``, which reads the stage span,
    counts the call once."""
    q, k = _meta(2, 1, 8, 64), _meta(2, 40, 2, 64)
    with _cpu_profile():
        ops.decode_attention(q, k, k, q_offset=30, kv_len=31, window=16)
    spans = census.spans()
    assert [(s.name, s.cost) for s in spans] == [
        ("decode_attention", None),
        ("decode_attention_kernel", da.decode_attention_cost(2, 1, 16, 8, 2, 64))]
    assert spans[1].parent == spans[0].id


def test_host_spans_enclose_the_profilers_events():
    """The clock: each op's kineto CPU event lies inside the host interval
    of the span around it."""
    a = torch.randn(64, 64)
    with _cpu_profile() as prof:
        marks = []
        for _ in range(5):
            with census.span("mm") as s:
                torch.mm(a, a)
            marks.append(s)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(events) == len(marks) == 5
    for s, e in zip(marks, sorted(events, key=lambda e: e.start_ns())):
        assert s.host[0] <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.host[1]


def _event_names(monkeypatch, recording: bool):
    if not recording:
        monkeypatch.setattr(census, "_profiler",
                            SimpleNamespace(_is_profiler_enabled=False))
    sess = _session()
    with _cpu_profile() as prof:
        sess.generate(torch.zeros(1, 4, dtype=torch.long), 3)
    monkeypatch.undo()
    return sorted(e.name() for e in prof.profiler.kineto_results.events())


def test_the_profilers_events_are_the_same_with_spans(monkeypatch):
    without = _event_names(monkeypatch, recording=False)
    assert census.spans() == []
    with_spans = _event_names(monkeypatch, recording=True)
    assert len(census.spans()) == 1 + 1 + 2 + 2 * 2
    assert with_spans == without


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_dry_run_counts_alike_under_the_profiler(kind):
    cfg = get_config("deepseek-moe-16b", reduced=True).replace(head_dim=64)
    cell = ShapeCell(kind, 32, 2, kind)
    off = dryrun.lower_cell(cfg, cell).census.summary()
    with _cpu_profile():
        on = dryrun.lower_cell(cfg, cell).census.summary()
    assert on == off
    assert off["kernel_calls"] or kind == "decode"


# ---------------------------------------------------------------------------
# On the card (skip here): the device intervals against the profiler's
# ---------------------------------------------------------------------------

# how far (µs) a span's device interval may miss the kernel it brackets:
# the marks' host readings and the events' clock against the profiler's
PLACE_US = 10.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: spans place CUDA events")
    return torch.device("cuda")


def _flash_calls(device, n, pause_every=0):
    q = torch.randn(4, 2048, 32, 128, device=device, dtype=torch.bfloat16)
    fa.flash_attention_cuda(q, q, q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with census.span("layer", i=i):
                fa.flash_attention_cuda(q, q, q)
                q = q * 1.0
            if pause_every and i % pause_every == pause_every - 1:
                torch.cuda.synchronize()
                time.sleep(0.05)
        torch.cuda.synchronize()
    return prof


def _device_ops(prof):
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA),
                  key=lambda o: o[1])


@pytest.mark.cuda
@pytest.mark.parametrize("pause_every", [0, 8], ids=["queued", "paused"])
def test_kernel_spans_hold_their_kernels_on_the_card(cuda, pause_every):
    prof = _flash_calls(cuda, 40, pause_every)
    torch.cuda.synchronize()
    calls = [s for s in census.spans() if s.name == "flash_attention"]
    kernels = [o for o in _device_ops(prof) if "flash_fwd_kernel" in o[0]]
    assert len(calls) == len(kernels) == 40
    lead = [(k[1] - s.device[0]) / 1e3 for s, k in zip(calls, kernels)]
    tail = [(s.device[1] - k[2]) / 1e3 for s, k in zip(calls, kernels)]
    print(f"lead µs {min(lead):.2f}..{max(lead):.2f}, tail µs {min(tail):.2f}..{max(tail):.2f}")
    assert min(lead) > -PLACE_US and min(tail) > -PLACE_US
    for s in calls:     # and no other call's kernel
        a, b = s.device
        assert sum(a - PLACE_US * 1e3 < k[1] < b for k in kernels) == 1


@pytest.mark.cuda
def test_recording_adds_no_device_op(cuda, monkeypatch):
    on = [n for n, _, _ in _device_ops(_flash_calls(cuda, 8))]
    assert len(census.spans()) == 16
    census.clear_spans()
    monkeypatch.setattr(census, "_profiler", SimpleNamespace(_is_profiler_enabled=False))
    off = [n for n, _, _ in _device_ops(_flash_calls(cuda, 8))]
    assert census.spans() == []
    assert on == off
