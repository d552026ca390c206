"""Real executor: run a workflow DAG as PyTorch computation on the card.

Counterpart of ``repro.core.executor``. Every agent invocation is real
tensor work, and outputs flow along the DAG's dataflow edges by the type
each interface produces, so a mis-wired dependency fails loudly:

  frame_extract   strided frame sampling
  speech_to_text  seamless-m4t enc-dec generate over audio features
  object_detect   CLIP-style dual-encoder cosine scoring of frames vs labels
  summarize       zoo LM prefill + decode over a context prompt
  embed           mean-pooled embedding-table vectors into an in-memory DB
  qa              nearest-vector retrieval + LM generate

``run`` reads only ``dag.topo_order``, ``dag.nodes[tid].agent`` / ``.args``,
``plan[tid].impl``, ``library.impls[name].arch`` and
``library.interfaces[agent].produces``, so it takes the objects the caller
planned with ``repro.core`` (or any with those attributes) and imports none
of them.

The reference draws three things from ``jax.random``, which torch cannot
reproduce; here each comes from the caller, or from a seeded
``torch.Generator`` by default: the models' parameters (``sessions``, a
factory arch -> ``ServeSession``, which also fixes the configs: reduced as
the reference's, or full width on the card), the media
(``Media.synthesize``) and the object detector's two projections
(``projections``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from .._bridge import resolve_device
from ..configs.registry import get_config
from ..models.model_zoo import build_model
from ..runtime.serve import ServeSession

LABELS = ["cat", "car", "tree", "person", "dog", "road", "sky", "wheel",
          "helmet", "grass", "sign", "flag", "track", "ball", "house",
          "water"]
DETECT_DIM = 64           # the CLIP-style detector's embedding width


@dataclass
class Media:
    """Synthetic decoded video: frames + audio features per scene."""

    name: str
    frames: torch.Tensor       # (scenes, fps, 32, 32, 3) floats in [0, 1)
    audio: torch.Tensor        # (scenes, T, d_audio) float32

    @classmethod
    def synthesize(cls, name: str, scenes: int = 4, fps: int = 10,
                   seed: int = 0, device=None) -> "Media":
        """Deterministic random media standing in for a decoded video, drawn
        as the reference draws it (uniform frames, normal audio of 64 steps
        x 80 features) from a torch generator seeded with ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        frames = torch.rand((scenes, fps, 32, 32, 3), generator=gen, device=dev)
        audio = torch.randn((scenes, 64, 80), generator=gen, device=dev)
        return cls(name, frames, audio)


def seeded_sessions(seed: int = 0, *, reduced: bool | None = None,
                    device=None):
    """A session factory: arch -> ``ServeSession`` over the zoo config
    (reduced, as the reference's executor runs, or full width), with
    parameters from a torch generator seeded with ``seed``, on ``device``.
    ``reduced`` defaults to the device: reduced on the CPU, full width on
    the card (the reduced configs' head_dim 16 is below the flash kernel's
    smallest)."""
    dev = resolve_device(device)
    if reduced is None:
        reduced = dev.type == "cpu"

    def make(arch: str) -> ServeSession:
        model = build_model(get_config(arch, reduced=reduced))
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        return ServeSession(model, params, device=dev)

    return make


def detect_projections(seed: int, device=None):
    """The detector's image projection (32*32*3, DETECT_DIM), scaled as the
    reference's, and its label embeddings (len(LABELS), DETECT_DIM)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    img = torch.randn((32 * 32 * 3, DETECT_DIM), generator=gen, device=dev)
    txt = torch.randn((len(LABELS), DETECT_DIM), generator=gen, device=dev)
    return img / 55.4, txt


class RealExecutor:
    """Executes DAG nodes with real zoo models through ``ServeSession``.

    ``sessions`` defaults to ``seeded_sessions(seed)`` on ``device`` (reduced
    configs on the CPU, full width on the card) and ``projections`` to
    ``detect_projections(seed + 1)``, as the reference keys them; ``device``
    defaults to ``cuda``.
    """

    def __init__(self, library, sessions=None, *, seed: int = 0,
                 default_arch: str = "deepseek-7b", projections=None,
                 device=None):
        self.library = library
        self.default_arch = default_arch
        device = resolve_device(device)
        self._make_session = sessions or seeded_sessions(seed, device=device)
        self.projections = projections or detect_projections(seed + 1, device)
        self._sessions: dict[str, ServeSession] = {}
        self._vector_db: list[tuple[torch.Tensor, torch.Tensor]] = []

    # -- model sessions ------------------------------------------------------
    def session(self, arch: str) -> ServeSession:
        """The serving session for one arch, built on first use."""
        if arch not in self._sessions:
            self._sessions[arch] = self._make_session(arch)
        return self._sessions[arch]

    # -- agent implementations -----------------------------------------------
    def frame_extract(self, media: list[Media], args: dict) -> torch.Tensor:
        """Strided frame sampling over all scenes."""
        stride = max(int(args.get("sampling_rate", 15)) // 15, 1)
        return torch.cat([m.frames[:, ::stride] for m in media], 0)

    def speech_to_text(self, media: list[Media], arch: str | None) \
            -> torch.Tensor:
        """Transcribe audio features with an enc-dec (or a decoder-only LM)."""
        sess = self.session(arch or "seamless-m4t-large-v2")
        cfg = sess.model.cfg
        audio = torch.cat([m.audio for m in media], 0)         # (S, T, 80)
        B = audio.shape[0]
        if cfg.family == "encdec":
            # audio features tiled to d_model "frames" (stub frontend)
            reps = -(-cfg.d_model // audio.shape[-1])
            frames = audio.repeat(1, 1, reps)[..., :cfg.d_model].to(torch.bfloat16)
            bos = torch.zeros((B, 1), dtype=torch.long, device=audio.device)
            return sess.generate(bos, max_new_tokens=8,
                                 extras={"frames": frames})
        bos = (audio[:, 0, :8].abs() * 100).long() % cfg.vocab_size
        return sess.generate(bos, max_new_tokens=8)    # (scenes, 8) ids

    def object_detect(self, frames: torch.Tensor, arch: str | None) \
            -> torch.Tensor:
        """CLIP-style: random-projection image/text encoders, cosine top-1."""
        S, F = frames.shape[:2]
        img_proj, txt_emb = self.projections
        img = frames.reshape(S, F, -1) @ img_proj                   # (S,F,d)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt_emb / txt_emb.norm(dim=-1, keepdim=True)
        scores = torch.einsum("sfd,ld->sfl", img, txt)
        return scores.argmax(-1)                # (scenes, frames) label ids

    def summarize(self, frames, objects, transcript, arch: str | None) \
            -> torch.Tensor:
        """LM generate over a deterministic per-scene context prompt."""
        sess = self.session(arch or self.default_arch)
        V = sess.model.cfg.vocab_size
        S = objects.shape[0]
        ctx = torch.cat([
            objects[:, :8].long() % V,
            transcript[:, :8].long() % V,
            (frames.reshape(S, -1).mean(-1, keepdim=True) * 1000).long() % V,
        ], dim=1)
        return sess.generate(ctx, max_new_tokens=8)    # (scenes, 8) summaries

    def embed(self, summaries: torch.Tensor, arch: str | None) -> torch.Tensor:
        """Mean-pooled embedding vectors (fp32 sums, the table's dtype out, as
        ``jnp.mean`` of bf16 gives), inserted into the in-memory DB."""
        emb = self.session(arch or self.default_arch).params["embed"]
        vecs = emb[summaries % emb.shape[0]].float().mean(1).to(emb.dtype)
        for i in range(vecs.shape[0]):
            self._vector_db.append((vecs[i].float(), summaries[i]))
        return vecs                                  # (scenes, d)

    def qa(self, vectors, question: str, arch: str | None) -> torch.Tensor:
        """Nearest-vector retrieval + LM generate over the question."""
        sess = self.session(arch or self.default_arch)
        V = sess.model.cfg.vocab_size
        q = torch.tensor([[ord(c) % V for c in question[:16]]],
                         device=sess.device)
        if self._vector_db:
            emb = sess.params["embed"]
            qv = emb[q[0]].float().mean(0).to(emb.dtype).float()
            sims = torch.stack([v for v, _ in self._vector_db]) @ qv
            best = self._vector_db[int(sims.argmax())][1][None]
            q = torch.cat([q, best.long() % V], 1)
        return sess.generate(q, max_new_tokens=8)

    # -- DAG walk ------------------------------------------------------------
    def run(self, dag, plan, media: list[Media], question: str = "") -> dict:
        """Execute in topological order; returns {task_id: output} and
        ``"_timings"``: {task_id: seconds}, each ending in a device sync."""
        outputs: dict[str, object] = {}
        by_type: dict[str, object] = {}
        timings: dict[str, float] = {}
        for tid in dag.topo_order:
            node = dag.nodes[tid]
            impl_name = plan[tid].impl if plan else None
            arch = (self.library.impls[impl_name].arch
                    if impl_name and impl_name in self.library.impls else None)
            t0 = time.perf_counter()
            if node.agent == "frame_extract":
                out = self.frame_extract(media, node.args)
            elif node.agent == "speech_to_text":
                out = self.speech_to_text(media, arch)
            elif node.agent == "object_detect":
                out = self.object_detect(by_type["frames"], arch)
            elif node.agent == "summarize":
                out = self.summarize(by_type["frames"], by_type["objects"],
                                     by_type["transcript"], arch)
            elif node.agent == "embed":
                out = self.embed(by_type["summary"], arch)
            elif node.agent == "qa":
                out = self.qa(by_type.get("vectors"), question or
                              node.args.get("question", ""), arch)
            else:
                raise ValueError(f"real executor: unknown agent {node.agent}")
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            timings[tid] = time.perf_counter() - t0
            outputs[tid] = out
            by_type[self.library.interfaces[node.agent].produces] = out
        outputs["_timings"] = timings
        return outputs
