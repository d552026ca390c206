"""Video-Understanding workflow: paper-cluster calibration (§4, Fig. 3, Tab. 2).

The paper's evaluation runs the OmAgent-derived workflow on 2x Azure
ND96amsr_A100_v4 (16x A100-80GB + 192 EPYC vCPUs): OpenCV frame extraction
(CPUs), NVLM frame summarization (8 GPUs) + embeddings (2 GPUs), CLIP object
detection (CPUs), Whisper STT (1 GPU or 64 CPU cores).

The constants below are the *pinned execution profiles* for that cluster —
the stand-in for the offline profiling runs the paper amortizes (§3.3a).
They are chosen so the modeled workflow reproduces the published endpoints:

    baseline   ~283-285 s, ~155 Wh        (sequential, fixed resources)
    Murakkab   77-83 s,    34-43 Wh       (three STT configs)
    MIN_COST selects the CPU config  =>  ~4.5x energy efficiency

Workload: 2 videos x 4 scenes x 10 frames (matching the paper's two-video
input; the scene/frame granularity is OmAgent's segmentation).
"""
from __future__ import annotations

from ..core.profiles import ProfileStore
from ..core.spec import SCENARIOS, Scenario
from ..core.workflow import VideoInput

# the two input videos of paper Listing 1/2
PAPER_VIDEOS = (
    VideoInput("cats.mov", duration_s=240.0, scenes=4, frames_per_scene=10),
    VideoInput("formula_1.mov", duration_s=240.0, scenes=4,
               frames_per_scene=10),
)

N_SCENES = sum(v.scenes for v in PAPER_VIDEOS)          # 8
FRAMES = N_SCENES * PAPER_VIDEOS[0].frames_per_scene    # 80

# representative decode-bound stage for the batch-roofline knee sweep
# (benchmarks/planner_bench.py): (impl, tokens_in, tokens_out) — the
# summarize interface's declared token footprint on a mid-tier LLM.
BATCH_KNEE_REFERENCE = ("gemma2-9b", 900, 120)


# pinned (impl, device, n_devices) -> latency [, power_frac]. Latency is a
# per-item scalar at batch=1, or a measured *batch curve* {batch:
# per_item_s} for impls with a batching lever (DESIGN.md §7.2) — curves
# retire the deprecated ``batch ** alpha`` fallback for these rows. The
# curve points below sit on the alpha power law the seed calibration
# implied (``per_item(b) = lat1 * b ** (alpha - 1)``), and the store's
# log-log interpolation reproduces a power law exactly, so every
# previously-chosen configuration costs the same and the published
# endpoints (Fig. 3 / Table 2) are unmoved.
# work-items: scenes for frame/stt/obj/embed; frames for summarize.
PAPER_PROFILES: dict[tuple[str, str, int], tuple[object, float]] = {
    # OpenCV frame extraction: ~4 s/scene on one vCPU
    ("opencv", "epyc-7v12-core", 1): (4.0, 1.0),
    # Whisper STT: 1 A100 ~11.5 s/scene(60s audio); 64 vCPUs ~17.5 s/scene
    # (CPU batching is off in the scheduler, so the CPU row stays scalar)
    ("whisper-large", "a100-80g", 1): (
        {1: 11.5, 2: 11.5 * 2 ** -0.5}, 1.0),
    ("whisper-large", "epyc-7v12-core", 64): (17.5, 1.0),
    # CLIP object detection: ~4 s/scene on 2 vCPUs
    ("clip", "epyc-7v12-core", 2): (4.0, 1.0),
    # NVLM summarize on 8 A100: ~1.4 s per frame sequential; decode-bound,
    # so the measured per-item latency keeps falling through the batch range
    ("nvlm-72b", "a100-80g", 8): (
        {1: 1.4, 8: 1.4 * 8 ** -0.85, 128: 1.4 * 128 ** -0.85}, 0.55),
    # NVLM embeddings on 2 A100: ~3.4 s/scene insert
    ("nvlm-embed", "a100-80g", 2): ({1: 3.4, 8: 3.4 * 8 ** -0.7}, 0.45),
}


def calibrate_paper_profiles(store: ProfileStore):
    for (impl, dev, n), (lat, pf) in PAPER_PROFILES.items():
        store.pin(impl, dev, n, lat, power_frac=pf)


# ---------------------------------------------------------------------------
# Scenario registration: the video pipeline as one workload among peers
# ---------------------------------------------------------------------------


def _first_video(job) -> VideoInput:
    vids = [v for v in job.inputs if isinstance(v, VideoInput)]
    return vids[0] if vids else VideoInput("input")


def _frame_extract_args(job) -> dict:
    first = _first_video(job)
    return {"file": first.name, "start_time": 0,
            "end_time": int(first.duration_s),
            "num_frames": first.frames_per_scene}


VIDEO_SCENARIO = SCENARIOS.register(Scenario(
    name="video_understanding",
    input_artifacts=("video",),
    # paper Listing 2's t1..t3 (RulePlanner fallback when the job gives no
    # sub-task hints) ...
    default_tasks=(
        "Extract frames from each video",
        "Run speech-to-text on all scenes",
        "Detect objects in the frames",
    ),
    # ... plus the aggregation stages of the evaluated workflow
    aggregate_tasks=(
        "Summarize each scene using the gathered context",
        "Embed the summaries into the vector database",
    ),
    arg_builders={
        "frame_extract": _frame_extract_args,
        "speech_to_text": lambda job: {"file": _first_video(job).name,
                                       "language": "en"},
        "object_detect": lambda job: {"frames": "$frames", "labels": "auto"},
        "summarize": lambda job: {"context": "$frames+$objects+$transcript",
                                  "max_tokens": 120},
        "embed": lambda job: {"texts": "$summary"},
        "qa": lambda job: {"question": job.description, "top_k": 5},
    }))


def make_baseline_workflow():
    """Paper Listing 1: pinned models, explicit resources, sequential flow."""
    from ..core.workflow import LLM, MLModel, Tool, Workflow
    frame_ext = Tool(name="OpenCV", params={"sampling_rate": 15},
                     key="ON_PREM_SSH_KEY", resources={"CPUs": 1})
    stt = MLModel(name="Whisper", key="OPENAI_API_KEY",
                  resources={"PTUs": 1})
    obj_det = MLModel(name="CLIP", key="AWS_SSH_KEY", resources={"CPUs": 2})
    summarize = LLM(
        name="llama", key="DATABRICKS_API_KEY",
        params={"context_len": 4096},
        resources={"GPUs": 8},
        system_prompt="You are an agent that can describe images in detail.",
        user_prompt="Summarize the scenes using frames, detected objects and "
                    "transcripts.")
    embed = MLModel(name="nvlm-embed", resources={"GPUs": 2})
    return Workflow(frame_ext >> stt >> obj_det >> summarize >> embed)


def make_declarative_job(constraints=None):
    """Paper Listing 2: description + optional sub-task hints + constraint."""
    from ..core.workflow import MIN_COST, Job
    return Job(
        description="List objects shown/mentioned in the videos",
        inputs=PAPER_VIDEOS,
        tasks=("Extract frames from each video",
               "Run speech-to-text on all scenes",
               "Detect objects in the frames"),
        constraints=MIN_COST if constraints is None else constraints,
        # reproduce-quality gate: per-interface floors = the baseline's impls
        # ("The execution output and accuracy are the same in all
        #  comparisons") — Whisper stays Whisper, CLIP stays CLIP.
        quality_floor={"speech_to_text": 0.97, "object_detect": 0.90,
                       "summarize": 0.96, "frame_extract": 0.9,
                       "embed": 0.9})


# -- open-loop serving preset (core/arrivals.py) ------------------------------
# Video understanding is the heavy tail of the serving mix: long chunkable
# pipelines that dominate device-seconds, so it gets a small arrival share
# and a generous span SLO (unloaded makespan ~105 s on the 64x v5e cluster).
from ..core.arrivals import ServingPreset, register_preset  # noqa: E402

SERVING_PRESET = register_preset(ServingPreset(
    scenario="video", make_job=make_declarative_job, weight=0.15,
    base_slo_s=360.0))
