"""Agent library: interfaces, schemas, implementations (paper §3.2).

An *interface* is what tasks bind to ("speech_to_text"); an *implementation*
is a concrete model/tool that satisfies it ("whisper-large",
"seamless-m4t-large-v2"), each with its own quality score, hardware support
and workload model. Murakkab selects among implementations at runtime — this
indirection is the fungibility the paper builds on.

Implementations backed by the model zoo carry ``arch=<assigned architecture>``;
their FLOP/byte workload models are derived from the config (same math as the
roofline analysis), and the real executor can run their reduced configs on
CPU end-to-end.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable

from ..configs.registry import get_config
from ..models.model_zoo import build_model
from .spec import ARTIFACTS, CardinalityModel, TokenModel


@dataclass(frozen=True)
class Work:
    """Device-agnostic workload of one task invocation.

    ``flops``/``hbm_bytes`` are the single-item totals the seed roofline
    consumes. A work model may additionally declare a *prefill/decode phase
    split* (DESIGN.md §7): per-phase FLOPs plus the HBM traffic partitioned
    into ``weight_bytes`` — the parameter stream, read once per decode step
    *regardless of batch size* — and per-item activation/KV bytes. The
    split is what makes ``energy.batch_roofline_latency`` batch-aware:
    shared weight streams amortize across a batch, per-item bytes do not.
    """

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    # -- prefill/decode phase split (all zero => no phase info) --------------
    prefill_flops: float = 0.0     # forward over the prompt, per item
    decode_flops: float = 0.0      # autoregressive steps, per item
    prefill_bytes: float = 0.0     # per-item prompt/activation HBM traffic
    decode_bytes: float = 0.0      # per-item KV/activation traffic, all steps
    weight_bytes: float = 0.0      # parameter bytes streamed per decode step
    decode_steps: float = 0.0      # number of decode steps (~tokens_out)

    @property
    def has_phases(self) -> bool:
        """True when the model declared a prefill/decode split."""
        return self.weight_bytes > 0.0 and self.decode_steps > 0.0

    @property
    def shared_bytes(self) -> float:
        """HBM traffic amortized across a batch: the weights stream, read
        once per decode step however many items are co-scheduled."""
        return self.weight_bytes * self.decode_steps

    @property
    def per_item_bytes(self) -> float:
        """HBM traffic that scales with batch size (activations, KV)."""
        return max(self.hbm_bytes - self.shared_bytes, 0.0)

    @staticmethod
    def two_phase(prefill_flops: float, decode_flops: float,
                  prefill_bytes: float, decode_bytes: float,
                  weight_bytes: float, decode_steps: float,
                  coll_bytes: float = 0.0) -> "Work":
        """Build a phased Work whose legacy totals are consistent with the
        split, so the batch model reduces to the seed roofline at batch=1."""
        steps = max(decode_steps, 0.0)
        return Work(flops=prefill_flops + decode_flops,
                    hbm_bytes=weight_bytes * steps + prefill_bytes
                    + decode_bytes,
                    coll_bytes=coll_bytes,
                    prefill_flops=prefill_flops, decode_flops=decode_flops,
                    prefill_bytes=prefill_bytes, decode_bytes=decode_bytes,
                    weight_bytes=weight_bytes, decode_steps=steps)

    def __mul__(self, k: float) -> "Work":
        # k items: extensive quantities scale; the resident weights do not
        # (k items means k * decode_steps weight streams, not k * weights).
        return Work(self.flops * k, self.hbm_bytes * k, self.coll_bytes * k,
                    self.prefill_flops * k, self.decode_flops * k,
                    self.prefill_bytes * k, self.decode_bytes * k,
                    self.weight_bytes, self.decode_steps * k)

    __rmul__ = __mul__

    def __add__(self, o: "Work") -> "Work":
        # combined shared stream must equal the sum of both works' streams
        # (keeps shared + per_item == hbm and the b=1 == seed invariant);
        # the larger residency stands in as the stream granularity.
        wb = max(self.weight_bytes, o.weight_bytes)
        shared = self.shared_bytes + o.shared_bytes
        return Work(self.flops + o.flops, self.hbm_bytes + o.hbm_bytes,
                    self.coll_bytes + o.coll_bytes,
                    self.prefill_flops + o.prefill_flops,
                    self.decode_flops + o.decode_flops,
                    self.prefill_bytes + o.prefill_bytes,
                    self.decode_bytes + o.decode_bytes,
                    wb,
                    shared / wb if wb else
                    self.decode_steps + o.decode_steps)


@dataclass(frozen=True)
class AgentInterface:
    """A capability tasks can bind to, with a toolcall schema.

    The interface *declares* its workload shape (DESIGN.md §2): how one
    invocation fans out over the job's input units (``cardinality``) and its
    per-item token footprint (``tokens``). Planners read these; no lowering
    path carries per-interface constants.
    """

    name: str
    description: str
    schema: dict[str, str]            # arg name -> type (toolcall schema)
    keywords: tuple[str, ...]         # rule-planner matching terms
    produces: str                     # artifact type: frames|transcript|...
    consumes: tuple[str, ...] = ()
    cardinality: CardinalityModel = CardinalityModel()
    tokens: TokenModel = TokenModel()


@dataclass(frozen=True)
class AgentImpl:
    """One concrete model/tool implementing an interface."""

    name: str
    interface: str
    quality: float                      # relative result quality in [0, 1]
    hw_kinds: tuple[str, ...]           # device kinds this impl can run on
    # workload per work-item as a function of (tokens_in, tokens_out):
    work_fn: Callable[[int, int], Work]
    min_devices: dict[str, int] = field(default_factory=dict)
    max_devices: dict[str, int] = field(default_factory=dict)
    chunkable: bool = True              # intra-task fan-out allowed
    mxu_efficiency: float = 0.6         # fraction of peak when compute-bound
    power_frac: float = 1.0             # fraction of (active-idle) power drawn
    load_time_s: float = 0.0            # cold-start (weights load) latency
    arch: str | None = None             # model-zoo backing (real execution)
    params_bytes: float = 0.0
    overhead_s: float = 0.0             # per-step invocation overhead
    # batching lever. Impls whose work model declares a prefill/decode phase
    # split (``Work.has_phases``) get the batch-aware roofline
    # (``energy.batch_roofline_latency``): weights stream once per decode
    # step regardless of batch, so per-item latency falls until the compute
    # knee. ``batch_alpha`` is the DEPRECATED scalar fallback — time(batch
    # of b) = per_item * b**alpha — kept only for impls without a phase
    # split and for *single-point* pinned (measured) profile rows; pinned
    # rows with a per-batch latency curve (ProfileStore.pin, DESIGN.md
    # §7.2) batch over their calibration instead.
    max_batch: int = 1
    batch_alpha: float = 1.0
    # KV-cache bytes one context token keeps resident (2 * kv_heads *
    # head_dim * layers * 2 B for bf16 K+V). Zero means the impl never
    # caches prefixes (tools, encoder models) — the serving engine only
    # builds a prefix ledger for impls that declare a footprint
    # (DESIGN.md §9).
    kv_bytes_per_token: float = 0.0


@functools.lru_cache(maxsize=None)
def _lm_work(arch: str) -> tuple[Callable[[int, int], Work], float]:
    """LLM workload model from a zoo config, as a two-phase ``Work``.

    prefill: flops = 2 * N_active * tokens_in — compute-bound; weights are
             read ~once for the whole (batched) forward, negligible against
             the decode stream below, so no per-item byte charge. (The seed
             model charged 2 * N_active bytes *per prompt token* here —
             contradicting its own "negligible" note and drowning the
             batch-shared decode stream; the roofline split removes it.)
    decode:  flops = 2 * N_active * tokens_out; weights (params_bytes)
             stream once per decode step — ``max(tokens_out, 1)`` steps,
             the floor standing in for the single prefill pass of
             decode-free works — shared across every item co-scheduled in
             a batch. Per-item KV/activation traffic is negligible at
             these context lengths (decode_bytes=0).
    """
    cfg = get_config(arch)
    model = build_model(cfg)
    n_active = model.active_param_count()
    pbytes = model.param_count() * 2.0  # bf16

    def work(tokens_in: int, tokens_out: int) -> Work:
        """Two-phase LLM workload for one (tokens_in, tokens_out) item."""
        return Work.two_phase(
            prefill_flops=2.0 * n_active * tokens_in,
            decode_flops=2.0 * n_active * tokens_out,
            prefill_bytes=0.0,
            decode_bytes=0.0,
            weight_bytes=pbytes,
            decode_steps=max(tokens_out, 1))

    return work, pbytes


def _fixed_work(flops: float, bytes_: float) -> Callable[[int, int], Work]:
    return lambda ti, to: Work(flops=flops, hbm_bytes=bytes_)


# ---------------------------------------------------------------------------
# Library
# ---------------------------------------------------------------------------


class AgentLibrary:
    """Registry of agent interfaces and their implementations."""

    def __init__(self):
        self.interfaces: dict[str, AgentInterface] = {}
        self.impls: dict[str, AgentImpl] = {}

    def register_interface(self, iface: AgentInterface):
        """Add a capability; its artifact types must be registered."""
        ARTIFACTS[iface.produces]             # typo -> registration error
        for c in iface.consumes:
            ARTIFACTS[c]
        self.interfaces[iface.name] = iface

    def register_impl(self, impl: AgentImpl):
        """Add a model/tool implementing a registered interface."""
        if impl.interface not in self.interfaces:
            raise KeyError(f"unknown interface {impl.interface!r}")
        self.impls[impl.name] = impl

    def impls_for(self, interface: str) -> list[AgentImpl]:
        """All registered implementations of one interface."""
        return [i for i in self.impls.values() if i.interface == interface]

    def match_interface(self, text: str) -> str | None:
        """Keyword-match a task description to an interface (rule planner)."""
        low = text.lower()
        best, score = None, 0
        for iface in self.interfaces.values():
            s = sum(len(k) for k in iface.keywords if k in low)
            if s > score:
                best, score = iface.name, s
        return best

    def toolcall(self, interface: str, args: dict) -> str:
        """Render the executable toolcall string (paper §3.2 example)."""
        iface = self.interfaces[interface]
        known = {k: v for k, v in args.items() if k in iface.schema}
        arg_s = ", ".join(f"{k}={v!r}" for k, v in sorted(known.items()))
        return f"{_camel(interface)}({arg_s})"


_TOOLNAMES = {"frame_extract": "FrameExtractor", "speech_to_text":
              "SpeechToText", "object_detect": "ObjectDetector"}


def _camel(s: str) -> str:
    if s in _TOOLNAMES:
        return _TOOLNAMES[s]
    return "".join(p.capitalize() for p in s.split("_"))


# ---------------------------------------------------------------------------
# Default library: the Video-Understanding agents + zoo-backed LLM tiers
# ---------------------------------------------------------------------------


def default_library() -> AgentLibrary:
    """The built-in library: video/RAG/doc-ingest interfaces + zoo tiers."""
    lib = AgentLibrary()

    lib.register_interface(AgentInterface(
        "frame_extract", "Extract frames from video at a sampling rate",
        schema={"file": "str", "start_time": "float", "end_time": "float",
                "num_frames": "int"},
        keywords=("frame", "extract", "sample", "video"),
        produces="frames", consumes=("video",),
        cardinality=CardinalityModel(("scenes",))))
    lib.register_interface(AgentInterface(
        "speech_to_text", "Transcribe speech audio to text",
        schema={"file": "str", "language": "str"},
        keywords=("speech", "transcri", "audio", "text", "stt"),
        produces="transcript", consumes=("video",),
        cardinality=CardinalityModel(("scenes",))))
    lib.register_interface(AgentInterface(
        "object_detect", "Detect/classify objects in images",
        schema={"frames": "list", "labels": "list"},
        keywords=("object", "detect", "classif", "recogni"),
        produces="objects", consumes=("frames",),
        cardinality=CardinalityModel(("scenes",))))
    lib.register_interface(AgentInterface(
        "summarize", "Summarize scenes from frames, objects and transcripts",
        schema={"context": "str", "max_tokens": "int"},
        keywords=("summar", "describe", "caption"),
        produces="summary", consumes=("frames", "objects", "transcript"),
        cardinality=CardinalityModel(("frames",)),
        tokens=TokenModel(tokens_in=900, tokens_out=120)))
    lib.register_interface(AgentInterface(
        "embed", "Embed text into a vector DB for retrieval",
        schema={"texts": "list"},
        keywords=("embed", "vector", "index", "insert"),
        produces="vectors",
        consumes=("summary", "grounded_answer", "chunk_summaries",
                  "chat_reply"),
        cardinality=CardinalityModel(("scenes", "chunks", "queries",
                                      "turns"))))
    lib.register_interface(AgentInterface(
        "qa", "Answer questions over retrieved context",
        schema={"question": "str", "top_k": "int"},
        keywords=("answer", "question", "qa"),
        produces="answer", consumes=("vectors",),
        cardinality=CardinalityModel(("queries", "scenes")),
        tokens=TokenModel(tokens_in=900, tokens_out=120)))

    # ---- retrieval-augmented generation interfaces ----
    lib.register_interface(AgentInterface(
        "retrieve", "Retrieve candidate passages for a query from a corpus",
        schema={"query": "str", "k": "int"},
        keywords=("retriev", "corpus", "search"),
        produces="passages", consumes=("query", "vectors"),
        cardinality=CardinalityModel(("queries",)),
        tokens=TokenModel(tokens_in=64, tokens_out=0)))
    lib.register_interface(AgentInterface(
        "rerank", "Rerank retrieved passages by relevance to the query",
        schema={"passages": "list", "top_k": "int"},
        keywords=("rerank", "relevance"),
        produces="ranked_passages", consumes=("passages",),
        cardinality=CardinalityModel(("passages",)),
        tokens=TokenModel(tokens_in=256, tokens_out=8)))
    lib.register_interface(AgentInterface(
        "synthesize", "Synthesize a grounded answer from ranked passages",
        schema={"query": "str", "max_tokens": "int"},
        keywords=("synthes", "grounded", "compose"),
        produces="grounded_answer", consumes=("ranked_passages", "query"),
        cardinality=CardinalityModel(("queries",)),
        tokens=TokenModel(tokens_in=1200, tokens_out=200)))

    # ---- document-ingest interfaces ----
    lib.register_interface(AgentInterface(
        "parse_doc", "Parse a document and split it into text chunks",
        schema={"file": "str", "chunk_tokens": "int"},
        keywords=("parse", "ingest", "ocr", "pdf", "chunk"),
        produces="text_chunks", consumes=("document",),
        cardinality=CardinalityModel(("pages", "documents"))))
    lib.register_interface(AgentInterface(
        "digest", "Write a digest of each document chunk",
        schema={"chunks": "list", "max_tokens": "int"},
        keywords=("digest", "condense"),
        produces="chunk_summaries", consumes=("text_chunks",),
        cardinality=CardinalityModel(("chunks",)),
        tokens=TokenModel(tokens_in=700, tokens_out=90)))

    # ---- multi-turn chat interface (the stateful-serving scenario) ----
    # the prompt grows with the conversation (in_units adds the history to
    # tokens_in) and that same history is the session-shared prefix a
    # resident KV cache can serve (prefix_units, DESIGN.md §9)
    lib.register_interface(AgentInterface(
        "chat_respond", "Generate the assistant's reply for one chat turn",
        schema={"message": "str", "max_tokens": "int"},
        keywords=("chat", "respond", "reply", "assistant", "converse"),
        produces="chat_reply", consumes=("chat_turn",),
        cardinality=CardinalityModel(("turns",)),
        # tool-calling-agent geometry: a fat prompt (user message plus
        # retrieved/tool context) and a short structured reply, so turn
        # latency is prefill-compute-bound — the regime where a resident
        # session prefix actually moves the roofline (DESIGN.md §9)
        tokens=TokenModel(tokens_in=640, tokens_out=24,
                          in_units="history_tokens",
                          prefix_units="history_tokens")))

    # ---- tools ----
    lib.register_impl(AgentImpl(
        "opencv", "frame_extract", quality=1.0, hw_kinds=("cpu",),
        work_fn=_fixed_work(flops=2.0e9, bytes_=6.0e8),   # per scene
        max_devices={"cpu": 16}, power_frac=1.0, overhead_s=0.5))
    lib.register_impl(AgentImpl(
        "clip", "object_detect", quality=0.90, hw_kinds=("cpu", "gpu", "tpu"),
        work_fn=_fixed_work(flops=4.0e11, bytes_=3.0e10),  # per scene (frames)
        max_devices={"cpu": 8, "gpu": 1, "tpu": 1}, power_frac=0.5,
        overhead_s=0.5))

    # ---- STT tiers ----
    lib.register_impl(AgentImpl(
        "whisper-large", "speech_to_text", quality=0.97,
        hw_kinds=("cpu", "gpu", "tpu"),
        # ~60 s of audio per scene; enc-dec forward + decode streaming
        work_fn=_fixed_work(flops=6.0e12, bytes_=2.5e11),
        min_devices={"cpu": 8}, max_devices={"cpu": 64, "gpu": 1, "tpu": 1},
        power_frac=0.55, load_time_s=4.0, params_bytes=3.2e9,
        max_batch=2, batch_alpha=0.5, overhead_s=1.0))
    lib.register_impl(AgentImpl(
        "fast-conformer", "speech_to_text", quality=0.93,
        hw_kinds=("cpu", "gpu", "tpu"),
        work_fn=_fixed_work(flops=1.2e12, bytes_=6.0e10),
        min_devices={"cpu": 8}, max_devices={"cpu": 64, "gpu": 1, "tpu": 1},
        power_frac=0.5, load_time_s=2.0, params_bytes=2.3e8))
    stt_work, stt_bytes = _lm_work("seamless-m4t-large-v2")
    lib.register_impl(AgentImpl(
        "seamless-m4t-large-v2", "speech_to_text", quality=0.96,
        hw_kinds=("tpu",), work_fn=lambda ti, to: stt_work(1500, 200),
        max_devices={"tpu": 8}, power_frac=0.6, load_time_s=6.0,
        arch="seamless-m4t-large-v2", params_bytes=stt_bytes,
        max_batch=8, batch_alpha=0.3, overhead_s=0.5))

    # ---- vision tier (zoo) ----
    vlm_work, vlm_bytes = _lm_work("llama-3.2-vision-90b")
    lib.register_impl(AgentImpl(
        "llama-3.2-vision-90b", "object_detect", quality=0.98,
        hw_kinds=("tpu",), work_fn=lambda ti, to: vlm_work(4096, 128),
        min_devices={"tpu": 8}, max_devices={"tpu": 64}, power_frac=0.7,
        load_time_s=30.0, arch="llama-3.2-vision-90b",
        params_bytes=vlm_bytes))

    # ---- summarize / LLM tiers (the model-zoo ladder) ----
    # (quality scores: relative ladder for the scheduler, not benchmarks)
    for arch, quality, hw in [
        ("deepseek-7b", 0.88, ("gpu", "tpu")),
        ("gemma2-9b", 0.90, ("gpu", "tpu")),
        ("stablelm-12b", 0.89, ("gpu", "tpu")),
        ("deepseek-moe-16b", 0.87, ("gpu", "tpu")),
        ("zamba2-7b", 0.86, ("gpu", "tpu")),
        ("command-r-plus-104b", 0.97, ("tpu",)),
        ("kimi-k2-1t-a32b", 0.99, ("tpu",)),
    ]:
        wfn, pbytes = _lm_work(arch)
        big = pbytes > 60e9
        lib.register_impl(AgentImpl(
            arch, "summarize", quality=quality, hw_kinds=hw,
            work_fn=wfn,
            min_devices={"tpu": 8 if big else 1, "gpu": 8 if big else 1},
            max_devices={"tpu": 256, "gpu": 8},
            power_frac=0.65, load_time_s=8.0 if not big else 45.0,
            arch=arch, params_bytes=pbytes, max_batch=128, batch_alpha=0.15,
            overhead_s=0.3))

    # NVLM-class profile from the paper's setup (8xA100 summarize)
    lib.register_impl(AgentImpl(
        "nvlm-72b", "summarize", quality=0.96, hw_kinds=("gpu",),
        work_fn=lambda ti, to: Work.two_phase(
            prefill_flops=2.0 * 72e9 * ti, decode_flops=2.0 * 72e9 * to,
            prefill_bytes=0.0, decode_bytes=0.0,
            weight_bytes=144e9, decode_steps=max(to, 1)),
        min_devices={"gpu": 8}, max_devices={"gpu": 8},
        power_frac=0.55, load_time_s=40.0, params_bytes=144e9,
        max_batch=128, batch_alpha=0.15, overhead_s=0.3))
    lib.register_impl(AgentImpl(
        "nvlm-embed", "embed", quality=1.0, hw_kinds=("gpu", "tpu"),
        work_fn=_fixed_work(flops=1.5e12, bytes_=1.5e11),
        min_devices={"gpu": 2}, max_devices={"gpu": 2, "tpu": 2},
        power_frac=0.45, load_time_s=20.0, overhead_s=0.5,
        max_batch=8, batch_alpha=0.3))

    lib.register_impl(AgentImpl(
        "minilm-embed", "embed", quality=0.88, hw_kinds=("cpu",),
        work_fn=_fixed_work(flops=2.0e10, bytes_=2.0e9),
        max_devices={"cpu": 8}, power_frac=0.8, load_time_s=1.0,
        overhead_s=0.3, max_batch=8, batch_alpha=0.4))

    # ---- qa tiers (zoo) ----
    for arch, quality in [("command-r-plus-104b", 0.97),
                          ("kimi-k2-1t-a32b", 0.99),
                          ("deepseek-7b", 0.85)]:
        wfn, pbytes = _lm_work(arch)
        big = pbytes > 60e9
        lib.register_impl(AgentImpl(
            f"{arch}-qa", "qa", quality=quality, hw_kinds=("tpu",),
            work_fn=wfn, min_devices={"tpu": 8 if big else 1},
            max_devices={"tpu": 256}, power_frac=0.65,
            load_time_s=45.0 if big else 8.0, arch=arch,
            params_bytes=pbytes, max_batch=16, batch_alpha=0.15,
            overhead_s=0.3))

    # draft/cheap tier: attention-free SSM
    mwork, mbytes = _lm_work("mamba2-370m")
    lib.register_impl(AgentImpl(
        "mamba2-370m-draft", "summarize", quality=0.55,
        hw_kinds=("cpu", "gpu", "tpu"), work_fn=mwork,
        max_devices={"cpu": 16, "gpu": 1, "tpu": 1}, power_frac=0.4,
        load_time_s=1.0, arch="mamba2-370m", params_bytes=mbytes,
        overhead_s=0.2))

    # ---- retrieval tiers: the keyword-vs-vector routing lever ----
    # (beyond-vector-search: lexical BM25 is orders of magnitude cheaper and
    #  often good enough; dense/hybrid retrieval buys recall with compute)
    lib.register_impl(AgentImpl(
        "bm25-keyword", "retrieve", quality=0.82, hw_kinds=("cpu",),
        work_fn=_fixed_work(flops=5.0e9, bytes_=2.0e9),
        max_devices={"cpu": 8}, power_frac=0.9, overhead_s=0.1))
    lib.register_impl(AgentImpl(
        "dense-retrieval", "retrieve", quality=0.92,
        hw_kinds=("cpu", "gpu", "tpu"),
        work_fn=_fixed_work(flops=2.0e11, bytes_=2.0e10),
        max_devices={"cpu": 16, "gpu": 1, "tpu": 1}, power_frac=0.5,
        load_time_s=2.0, params_bytes=4.0e8, max_batch=16, batch_alpha=0.4,
        overhead_s=0.2))
    lib.register_impl(AgentImpl(
        "hybrid-retrieval", "retrieve", quality=0.97,
        hw_kinds=("cpu", "gpu", "tpu"),
        work_fn=_fixed_work(flops=3.0e11, bytes_=3.2e10),
        max_devices={"cpu": 16, "gpu": 1, "tpu": 1}, power_frac=0.55,
        load_time_s=2.0, params_bytes=4.0e8, max_batch=16, batch_alpha=0.4,
        overhead_s=0.3))

    # ---- rerank tiers ----
    lib.register_impl(AgentImpl(
        "minilm-cross-encoder", "rerank", quality=0.90,
        hw_kinds=("cpu", "gpu", "tpu"),
        work_fn=_fixed_work(flops=4.0e10, bytes_=4.0e9),
        max_devices={"cpu": 16, "gpu": 1, "tpu": 1}, power_frac=0.6,
        load_time_s=1.0, params_bytes=1.3e8, max_batch=32, batch_alpha=0.3,
        overhead_s=0.1))
    rr_work, rr_bytes = _lm_work("gemma2-9b")
    lib.register_impl(AgentImpl(
        "gemma2-9b-rerank", "rerank", quality=0.97, hw_kinds=("gpu", "tpu"),
        work_fn=rr_work, max_devices={"gpu": 8, "tpu": 8}, power_frac=0.65,
        load_time_s=8.0, arch="gemma2-9b", params_bytes=rr_bytes,
        max_batch=64, batch_alpha=0.2, overhead_s=0.2))

    # ---- synthesis tiers (zoo ladder over the synthesize interface) ----
    for arch, quality, hw in [
        ("deepseek-7b", 0.86, ("gpu", "tpu")),
        ("gemma2-9b", 0.90, ("gpu", "tpu")),
        ("command-r-plus-104b", 0.97, ("tpu",)),
    ]:
        wfn, pbytes = _lm_work(arch)
        big = pbytes > 60e9
        lib.register_impl(AgentImpl(
            f"{arch}-synth", "synthesize", quality=quality, hw_kinds=hw,
            work_fn=wfn,
            min_devices={"tpu": 8 if big else 1, "gpu": 8 if big else 1},
            max_devices={"tpu": 64, "gpu": 8}, power_frac=0.65,
            load_time_s=45.0 if big else 8.0, arch=arch, params_bytes=pbytes,
            max_batch=32, batch_alpha=0.15, overhead_s=0.3))

    # ---- document parsing tiers ----
    lib.register_impl(AgentImpl(
        "pypdf-parse", "parse_doc", quality=0.90, hw_kinds=("cpu",),
        work_fn=_fixed_work(flops=1.0e9, bytes_=5.0e8),    # per page
        max_devices={"cpu": 16}, power_frac=1.0, overhead_s=0.2))
    lib.register_impl(AgentImpl(
        "layout-ocr", "parse_doc", quality=0.98,
        hw_kinds=("cpu", "gpu", "tpu"),
        work_fn=_fixed_work(flops=8.0e11, bytes_=6.0e10),
        max_devices={"cpu": 16, "gpu": 1, "tpu": 1}, power_frac=0.55,
        load_time_s=3.0, params_bytes=9.0e8, max_batch=8, batch_alpha=0.4,
        overhead_s=0.3))

    # ---- digest tiers (batch summarization over chunks) ----
    for arch, quality in [("deepseek-7b", 0.87), ("gemma2-9b", 0.90),
                          ("stablelm-12b", 0.88),
                          ("command-r-plus-104b", 0.97)]:
        wfn, pbytes = _lm_work(arch)
        big = pbytes > 60e9
        lib.register_impl(AgentImpl(
            f"{arch}-digest", "digest", quality=quality,
            hw_kinds=("tpu",) if big else ("gpu", "tpu"), work_fn=wfn,
            min_devices={"tpu": 8 if big else 1, "gpu": 8 if big else 1},
            max_devices={"tpu": 64, "gpu": 8}, power_frac=0.65,
            load_time_s=45.0 if big else 8.0, arch=arch, params_bytes=pbytes,
            max_batch=64, batch_alpha=0.15, overhead_s=0.3))

    # ---- chat tiers (zoo ladder with declared KV footprints) ----
    # kv_bytes_per_token ~ 2 (K+V) * 2 B (bf16) * layers * kv_heads *
    # head_dim (GQA keeps it ~1e5 for the small tiers); min 2 devices so
    # weights + a useful prefix budget fit the smallest SKU. overhead_s is
    # low: these run in a high-QPS serving stack, not a batch harness.
    for arch, quality, hw, kvb in [
        ("deepseek-7b", 0.86, ("gpu", "tpu"), 1.3e5),
        ("gemma2-9b", 0.90, ("gpu", "tpu"), 1.7e5),
        ("command-r-plus-104b", 0.97, ("tpu",), 4.1e5),
    ]:
        wfn, pbytes = _lm_work(arch)
        big = pbytes > 60e9
        lib.register_impl(AgentImpl(
            f"{arch}-chat", "chat_respond", quality=quality, hw_kinds=hw,
            work_fn=wfn,
            min_devices={"tpu": 8 if big else 2, "gpu": 8 if big else 2},
            max_devices={"tpu": 64, "gpu": 8}, power_frac=0.65,
            load_time_s=45.0 if big else 8.0, arch=arch, params_bytes=pbytes,
            kv_bytes_per_token=kvb, max_batch=32, batch_alpha=0.15,
            overhead_s=0.05))
    return lib
