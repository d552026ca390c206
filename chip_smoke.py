#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one or
outside a checkout of the repository. Phases, each printed as JSON lines:

1. card:    the card's name and power limit, and the kernel build time
            (``nvcc`` builds every ``src/repro_torch/csrc/*.cu`` at once);
            per library its SASS census (``HGMMA`` wgmma, ``UTMALDG`` TMA
            loads, ``HMMA`` mma.sync; the flash, flash backward, gmm, SSD
            and SSD backward libraries must hold both of the first two, and
            the flash backward no ``HMMA``; the SSD backward's wgmma kernels
            no spills and no serialized wgmma),
            ptxas's registers and spills per
            kernel and any line where ptxas says it serialized wgmma; the
            host cost of encoding the gmm's tensor maps; whether ``triton``
            imports, and its version (no kernel of the port uses it).
2. kernel:  the flash-attention kernel against its plain PyTorch version on
            the card, bf16, on the kernel-test grid (at head_dim 64/128, and
            again at 160 and 256), on deepseek-7b's serving
            shape (B=4, S=2048, H=KVH=32, D=128, causal), on zamba2-7b's
            (the same at D=112), on gemma2-9b's (H=16, KVH=8, D=256, scale
            224^-0.5, softcap 50: the global layers at 4 x 2048, the local
            layers at 1 x 6144 past their 4096 window), on stablelm-12b's
            (H=32, KVH=8, D=160), on llama-3.2-vision-90b's cross-attention
            (4 x 2048 queries over 4096 patches, H=64, KVH=8, D=128), on
            seamless-m4t-large-v2's over 1500
            frames (H=KVH=16, D=64: the encoder's non-causal self-attention,
            the cross-attention of one query row, the decoder's 1-token
            self-attention), and on the video executor's (the same heads
            over 64 audio steps; deepseek-7b's prefills of 4 x 17 and 1 x 24
            tokens): elementwise within 2e-2, and the worst row
            and the whole output within relative-norm limits that two
            injected faults (the last K/V tile dropped or stale) are shown to
            exceed. At the serving shapes, kernel and plain version against
            an fp32-output reference (what rounding P to bf16 adds), and
            medians of CUDA-event timings of the kernel, the plain version
            and ``F.scaled_dot_product_attention`` (a yardstick the port
            never calls; it takes no softcap or window, and is timed
            without them, as the line says); the faults and timings also
            at the gemma2, stablelm, VLM-cross and seamless shapes; at
            gemma2's two shapes also the kernel's errors with the softcap
            off, against the plain version and an fp32-output reference.
   flash_bwd: the flash backward kernel against autograd through the
            plain version in fp32: first the forward's row log-sum-exp at
            every head dim within LSE_TOL; a call where no row has a key
            (LSE -inf, every gradient 0); dQ, dK and dV on the grid at every
            head dim (64, 112, 128, 160, 256) and at the training shapes of
            deepseek-7b and deepseek-moe-16b (B=2, S=2048, D=128, causal),
            zamba2-7b (H=32, D=112), gemma2-9b (H=16, KVH=8, D=256, softcap
            50) and stablelm-12b (H=32, KVH=8, D=160) within an elementwise,
            a worst-row and a whole-tensor limit that two injected faults
            (the last K/V tile's dK dropped; Delta left at zero) are shown to
            exceed, sdpa's backward's errors beside them where it takes the
            options; the backward run twice bitwise equal; timings of the
            kernel (its kernels split by torch.profiler), the plain version
            and the backward of ``F.scaled_dot_product_attention`` (a
            yardstick the port never calls; no softcap) beside the bound.
   ssd:     the SSD-scan kernels against their plain version: the
            kernel-test grid in fp32 (the ``fma`` variant) within 1e-4 on y
            and on the state, and the prefill shapes of zamba2-7b and
            mamba2-370m (B=4, L=2048, chunk 256) in bf16, and a rank's share
            of them where the Mamba2 blocks split their heads over model
            (zamba2-7b's 28 heads of one group on (1, 4), 56 over B=2 on
            (2, 2); mamba2-370m's 8 on (1, 4)), which must take the
            ``wgmma`` variant, within an elementwise limit on y and
            relative-norm limits on y and the fp32 state that three injected
            faults (the carried state dropped in the last chunk; one 64-step
            tile of the last chunk dropped; the last chunk boundary not
            decayed) are shown to exceed. There the ``fma`` variant is held to
            the same limits through the module's launch function, and both
            variants and the plain version are timed, with the ``wgmma``
            variant's three kernels timed apart by torch.profiler.
   gmm:     the grouped-GEMM kernel against its plain version: the kernel-test
            grid in fp32 and bf16 within TOL * sqrt(d), two ragged shapes,
            and deepseek-moe-16b's expert products in bf16 (prefill gate/up
            and down at capacity 968, decode gate/up at capacity 8) within an
            elementwise limit and a relative-norm limit that two injected
            faults (the last 32-deep step of d dropped; the ragged last
            C-tile of one expert left unwritten) are shown to exceed; timings
            of the kernel, the plain version and ``torch.bmm`` (a yardstick
            the port never calls) there.
   gmm_bwd: the grouped GEMM's backward (dx and dw, two kernel launches)
            against the two einsums: the grid in fp32 and bf16, and
            deepseek-moe-16b's expert products at the training capacity
            (488 for 2 x 2048 tokens), there on the ``wgmma_bwd`` variant
            with no memory allocated beyond dx and dw (no transposed copy),
            each product's two forward faults shown to exceed the norm
            limit; timings beside the backward of ``torch.bmm``, the call's
            kernels split by torch.profiler.
   ssd_bwd: the SSD backward kernels against autograd through the plain
            version in fp32: all six gradients on the fp32 grid (the ``fma``
            variant) with a non-zero state cotangent, and at the training
            shapes of zamba2-7b (H=112, P=64, N=64, G=2) and mamba2-370m
            (H=32, P=64, N=128, G=1), B=2, L=2048, chunk 256, in bf16, and a
            rank's share of them as in phase ssd (B=1 on (2, 2)), which
            must take the ``wgmma`` variant (chunk_state, state_pass, rows,
            cols, reduce), there with the ``fma`` variant (states, chunks,
            reduce) held too, each within an elementwise and a relative-norm
            limit by the gradient's dtype that three planted faults (the
            state gradient not carried into the previous chunk; d cum used
            without its reverse scan; db from one head of each group) are
            shown to exceed; each backward run twice bitwise equal; timings
            of both variants (their kernels apart by torch.profiler) and the
            plain backward beside the bound.
   train:   the training paths, through ``runtime.train`` at full width:
            deepseek-7b (30 layers), deepseek-moe-16b (8 of 28 layers),
            mamba2-370m (48 layers), zamba2-7b (81 SSM layers and 13
            shared attention blocks), gemma2-9b (32 of 42 layers) and
            stablelm-12b (20 of 40), B=2 x 2048 tokens of the reference's
            synthetic stream, remat "full", bf16 moments. Step 1's loss, the
            worst leaf's gradient norm and each leaf's whole gradient
            through the kernels against the plain versions within 3 x a
            noise floor measured in the run (MoE routing replayed), with
            faults planted in the flash backward (a K/V tile's dK dropped;
            Delta zero) and in the SSD backward (d cum without its reverse
            scan; db from one head; the state gradient not carried) shown
            to fail that gate where a whole leaf can see them (on the SSM
            paths, whose floors are wide, d cum's); on the SSM paths every
            SSD call of the plain run replayed through the backward kernel
            (``wgmma``) on its own inputs, within the ssd_bwd limits, each
            SSD fault past them in some call; then 8 steps: losses finite,
            each kernel's launches as predicted (remat runs every forward
            launch twice; every SSD launch, backward too, on ``wgmma``),
            step time, tokens/s, peak memory (below 80 GB), model
            TFLOP/s, and the idle share of one more step under
            torch.profiler; the loss lower at step 8 (on the SSM paths: over
            8 steps on one batch). Then
            the restart loop at a REDUCED size: a run with two injected
            failures ends bitwise equal to a clean one.
3. serve:   the main paths: ``ServeSession.generate`` at full width, random
            bf16 weights from a seeded generator, two batches of 4 prompts of
            2048 tokens, 48 new greedy tokens each, on deepseek-7b (30
            layers, d_model 4096), zamba2-7b (81 SSM layers and 13 shared
            attention blocks, d_model 3584), mamba2-370m (48 layers, d_model
            1024), deepseek-moe-16b (28 layers, d_model 2048, 27 MoE layers
            of 64 routed experts, top 6), seamless-m4t-large-v2 (24
            encoder and 24 decoder layers, d_model 1024; 1-token prompts over
            1500 frames of random embeddings), gemma2-9b (42 layers, d_model
            3584), stablelm-12b (40 layers, d_model 5120),
            llama-3.2-vision-90b (d_model 8192, depth cut to 10 of 100
            layers: 8 self- and 2 cross-attention, over 4096 random patches of
            width 1280) and command-r-plus-104b (d_model 12288, depth cut to
            4 of 64 layers); each path prints its parameter count, peak
            memory and any depth cut. The kernels' launch counts are
            reset just before each path and read just after it; each must
            equal, per batch, one prefill's (one flash launch per attention
            block, the encoder's and cross-attention's included, one SSD
            launch per SSM layer, three grouped-GEMM launches per MoE layer)
            plus 47 decode steps' (one flash launch per cross-attention
            block, the grouped GEMMs again), and every grouped-GEMM and SSD
            launch must take its wgmma variant.
4. agree:   every path but mamba2-370m's: one full-width prefill through
            the kernels and the same prefill
            through their plain versions: logits at every prompt position
            within a stated multiple of the network's own bf16 noise floor,
            argmax equal wherever the top-2 margin exceeds that limit, and a
            prefill with an injected fault shown to exceed it. For zamba2-7b,
            seamless, gemma2-9b, stablelm-12b and the VLM also 8 decode steps
            from each prefill's cache, held the same way, with a dropped
            prefill-to-decode handoff (SSM states; the encoder's K/V; the
            whole cache elsewhere) shown to exceed the limit;
            for seamless also the encoder's final states at all 4 x 1500
            frames. gemma2-9b is held on 1 x 6144-token prompts, so that its
            local layers' 4096 window binds in the prefill and in decode.
            For seamless, gemma2, stablelm, the VLM and command-r every attention
            call of the plain run is replayed through the kernel, held per
            shape to a floor of its own, with the last K/V tile's fault shown
            to exceed it.
5. trace:   torch.profiler over one prefill and a few decode steps of each
            of those paths: device busy time, idle share and the kernels that
            take the most time.
   mesh:    the mesh path on a one-rank NCCL group (an in-memory store) and
            a (1, 1) DeviceMesh named (data, model): ``compressed_psum``
            bitwise against compress then decompress; deepseek-moe-16b's
            train path (8 of 28 layers, as phase train) through
            ``jit_train_step`` for 3 steps, its state DTensors placed as
            ``state_shardings`` says, each step's loss and grad norm and the
            updated params bitwise equal to the local ``build_train_step``
            from the same init and batches (the local path first shown to
            repeat itself bitwise); the gmm kernel at the per-rank shapes
            of expert parallelism (deepseek-moe-16b's prefill on (data 2,
            model 2) and (data 1, model 8) meshes), ``wgmma`` required,
            within phase gmm's model-shape limits, timed beside
            ``torch.bmm`` and the bound; the flash kernel at the per-rank
            shapes of tensor parallelism over a model axis of 4
            (command-r-plus-104b's prefill, H=24 over KVH=2, D=128;
            stablelm-12b's training backward, H=8 over KVH=2, D=160) within
            phase 2's and phase flash_bwd's limits, timed beside sdpa and
            the bound; after phase 3's deepseek-moe-16b and
            command-r-plus-104b paths, each one's serve path (full depth;
            command-r at its 4 layers) through ``jit_prefill_step`` /
            ``jit_decode_step`` (params on SERVING_RULES, the dense layers
            through the tensor-parallel code, the MoE layers on the
            expert-parallel body, the cache on ``mesh_cache``) for one
            prefill of 4 x 2048 tokens and 8 greedy decode steps, logits
            and tokens bitwise equal to the local steps'. Each mesh run's
            kernel launches are counted from 0 and must be the local
            path's. Tensor parallelism over more than one card is
            ``tests/_torch_tp_card.py``'s (four cards).
6. executor: the video workflow planned by the port's ``repro_torch.core``
            (``Murakkab.paper_cluster()``: the MIN_COST declarative job and
            the baseline lowered for the first paper video; each plan's rows
            and the planner's simulated makespan and energy of the MIN_COST
            job printed, with the host seconds they took), then
            ``RealExecutor.run`` over both plans on full-width
            seamless-m4t-large-v2 and deepseek-7b: output shapes, outputs
            bitwise equal across two runs, summaries equal across the
            MIN_COST and baseline plans, the flash launches of each run, and
            per-task times; every attention call of a run through the plain
            attention replayed through the kernel, as in phase 4.

   dryrun:  the dry-run (``repro_torch.launch.dryrun``) of deepseek-7b's
            train step (B=2 x 2048, remat full, bf16 moments, the local
            path) and its serve prefill (4 x 2048), traced on meta tensors
            in a child process on the host (the card hidden from it) while
            the kernel phases run, is held against the card in phases
            train and 3: its kernel calls per kernel must equal the
            launches torch.profiler counts (and the wrappers count) in one
            traced step or prefill, its peak live bytes must be within 10%
            of ``torch.cuda.max_memory_allocated`` over that step or
            prefill, and its FLOPs are printed beside ``train_model_flops``
            as a ratio (remat makes them differ by design), each on a
            ``dryrun_check`` line beside the card's name and power limit.

Then a ``kernels`` line (one entry per kernel of the paths), the card's
``nvidia-smi`` name and power limit, and last the device line. Any failure
raises, so the script never prints the last line after a failed phase.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

KERNEL_TOL = 2e-2          # bf16 kernel vs plain, elementwise (the JAX kernel tests' bf16 tolerance)
ROW_RTOL = 2e-2            # worst (b, q, h) row: |kernel - plain| / |plain|, 2-norms over D
NORM_RTOL = 5e-3           # whole output: |kernel - plain| / |plain|, 2-norms
FLOOR_MULT = 3.0           # full-width logits: limit = FLOOR_MULT x the noise floor (phase 4)
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 peak outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
SSD_GRID_TOL = 1e-4        # fp32 grid, y and state (tests/test_kernels.py TestSSDScan)
SSD_Y_TOL = 2e-2           # bf16 y at the model shapes, elementwise
SSD_Y_RTOL = 1e-3          # bf16 y at the model shapes, whole-tensor relative norm
SSD_STATE_RTOL = 1e-4      # fp32 state at the model shapes, relative norm
GMM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # x sqrt(d): tests/test_kernels.py TestGMM
GMM_NORM_RTOL = 1e-3       # bf16 model shapes, whole output, relative norm
GMM_STEP = 32              # half the wgmma gmm's 64-deep stage (two k16 slices), a fault's unit
GMM_TILE = 128             # the gmm's prefill C tile, the unit of a fault

# (name, B, Sq, Sk, H, KVH, D, options): the TestFlashAttention grid of
# tests/test_kernels.py at head_dim 64 and 128 (the kernel's), one non-causal
# cross case, and the serving prefill shape.
GRID = [
    ("mha", 1, 128, 128, 4, 4, 64, {}),
    ("gqa_2to1", 2, 128, 128, 4, 2, 64, {}),
    ("ragged_100", 1, 100, 100, 4, 2, 64, {}),
    ("cross_64x192", 1, 64, 192, 2, 2, 128, {}),
    ("window_32", 1, 128, 128, 4, 2, 64, {"window": 32}),
    ("softcap_20", 1, 128, 128, 4, 2, 64, {"softcap": 20.0}),
    ("window_32_softcap_20", 1, 128, 128, 4, 2, 64, {"window": 32, "softcap": 20.0}),
    ("decode_q99_kv100", 1, 1, 256, 4, 2, 64, {"q_offset": 99, "kv_valid": 100}),
    ("noncausal_cross_70x130", 1, 70, 130, 4, 2, 128, {"causal": False}),
]
SERVE_SHAPE = ("serve_prefill", 4, 2048, 2048, 32, 32, 128, {})
ZAMBA_SHAPE = ("zamba2_prefill", 4, 2048, 2048, 32, 32, 112, {})
# the grid again at the head dims of gemma2-9b and stablelm-12b
GRID_WIDE = [(f"{name}_d{d}", B, Sq, Sk, H, KVH, d, opts)
             for d in (160, 256)
             for name, B, Sq, Sk, H, KVH, _, opts in GRID]
# gemma2-9b (16 heads of 256 over 8 kv heads; scale (3584 / 16)^-0.5, not
# 256^-0.5; softcap 50): a global layer's prefill of 4 x 2048 tokens, and a
# local layer's of 1 x 6144, past its 4096 window; stablelm-12b (32 heads of
# 160 over 8); the VLM's cross-attention (64 heads of 128 over 8, 4 x 2048
# queries over 4096 patches)
GEMMA2_OPTS = {"scale": 224 ** -0.5, "softcap": 50.0}
GEMMA2_GLOBAL = ("gemma2_global", 4, 2048, 2048, 16, 8, 256, GEMMA2_OPTS)
GEMMA2_LOCAL = ("gemma2_local_past_window", 1, 6144, 6144, 16, 8, 256,
                {**GEMMA2_OPTS, "window": 4096})
STABLELM_SHAPE = ("stablelm_prefill", 4, 2048, 2048, 32, 8, 160, {})
VLM_CROSS = ("vlm_cross", 4, 2048, 4096, 64, 8, 128, {"causal": False})
FAMILY_SHAPES = [GEMMA2_GLOBAL, GEMMA2_LOCAL, STABLELM_SHAPE, VLM_CROSS]
# seamless-m4t-large-v2 (16 heads of 64) over ENC_LEN frames: the encoder's
# self-attention, the cross-attention of the prefill and of every decode
# step (one query row over the encoder's keys), and the decoder's
# self-attention in the prefill of a 1-token prompt
ENC_LEN = 1500             # the agent library's speech_to_text work, stt_work(1500, 200)
SEAMLESS_ENCODER = ("seamless_encoder", 4, ENC_LEN, ENC_LEN, 16, 16, 64,
                    {"causal": False})
SEAMLESS_CROSS = ("seamless_cross", 4, 1, ENC_LEN, 16, 16, 64, {"causal": False})
SEAMLESS_SHAPES = [SEAMLESS_ENCODER, SEAMLESS_CROSS,
                   ("seamless_decoder_self", 4, 1, 1, 16, 16, 64, {})]
# the video executor's calls (phase 6): seamless over the media's 64 audio
# steps (encoder, cross-attention), deepseek-7b's summarize prefill (4
# scenes x 17 context tokens) and qa's (1 x 24)
EXECUTOR_SHAPES = [
    ("executor_encoder", 4, 64, 64, 16, 16, 64, {"causal": False}),
    ("executor_cross", 4, 1, 64, 16, 16, 64, {"causal": False}),
    ("executor_summarize", 4, 17, 17, 32, 32, 128, {}),
    ("executor_qa", 1, 24, 24, 32, 32, 128, {}),
]
KV_TILE = 64               # keys of an injected fault: no more than the flash kernel's K/V tile (96 rows; 64 at D=256)
LOCAL_FAULT_ROWS = 0.02    # a fault moving fewer rows than this share need not move the whole output's norm
NUM_PATCHES = 4096         # the VLM's patches (llama-3.2-vision-90b's vision.num_patches)
SERVE_BATCHES, SERVE_BATCH, PROMPT_LEN, MAX_NEW = 2, 4, 2048, 48
# (name, B, L, H, P, N, G, chunk, dtype): the TestSSDScan grid of
# tests/test_kernels.py in fp32, and the models' prefill shapes in bf16
SSD_GRID = [
    ("grid_64", 1, 64, 2, 16, 16, 1, 16, "float32"),
    ("grid_128_g2", 2, 128, 4, 32, 16, 2, 32, "float32"),
    ("grid_96", 1, 96, 2, 16, 32, 1, 32, "float32"),
]
SSD_MODEL_SHAPES = [
    ("zamba2-7b", 4, 2048, 112, 64, 64, 2, 256, "bfloat16"),
    ("mamba2-370m", 4, 2048, 32, 64, 128, 1, 256, "bfloat16"),
]
# a rank's share of those where the Mamba2 blocks split their heads over
# model (models/ssm.py): zamba2-7b on (data 1, model 4) and (2, 2), a
# rank's heads inside one of its 2 groups, and mamba2-370m on (1, 4); the
# serve batch of 4 cut over data
SSD_RANK_SHAPES = [
    ("zamba2-7b_tp4", 4, 2048, 28, 64, 64, 1, 256, "bfloat16"),
    ("zamba2-7b_tp2x2", 2, 2048, 56, 64, 64, 1, 256, "bfloat16"),
    ("mamba2-370m_tp4", 4, 2048, 8, 64, 128, 1, 256, "bfloat16"),
]
SSD_TILE = 64              # the SSD kernel's (t, s) tile, the unit of a fault
# the SSD backward (phase ssd_bwd): the fp32 grid above with a state
# cotangent, and the training paths' shapes (B=2 x 2048) in bf16 with none.
# Limits by the gradient's dtype against autograd through the plain version
# in fp32, rounded to that dtype: the largest difference as a share of the
# largest |plain| value, and the relative norm. A bf16 gradient is rounded
# once on each side, so they differ by one ulp (2^-8 relative) where the
# fp32 sums straddle a rounding boundary; the norm limit is one ulp on
# average, since in a short vector (da_log: one value a head, summed with
# cancellation) a single flipped element moves the norm by 2^-8 / sqrt(H)
SSD_TRAIN_SHAPES = [
    ("zamba2-7b", 2, 2048, 112, 64, 64, 2, 256, "bfloat16"),
    ("mamba2-370m", 2, 2048, 32, 64, 128, 1, 256, "bfloat16"),
]
# the training batch of 2's share of SSD_RANK_SHAPES
SSD_RANK_TRAIN_SHAPES = [
    ("zamba2-7b_tp4", 2, 2048, 28, 64, 64, 1, 256, "bfloat16"),
    ("zamba2-7b_tp2x2", 1, 2048, 56, 64, 64, 1, 256, "bfloat16"),
    ("mamba2-370m_tp4", 2, 2048, 8, 64, 128, 1, 256, "bfloat16"),
]
SSD_BWD_ELEM = {"float32": 1e-4, "bfloat16": 1e-2}
SSD_BWD_RTOL = {"float32": 1e-4, "bfloat16": 2 ** -8}
SSD_GRADS = ("dx", "ddt", "da_log", "db", "dc", "dd_skip")
# the SSD backward's kernels by variant, as torch.profiler names them
SSD_BWD_STAGES = {"wgmma": ("chunk_state_kernel", "state_pass_kernel", "rows_kernel",
                            "cols_kernel", "reduce_kernel"),
                  "fma": ("ssd_bwd_states", "ssd_bwd_chunks", "ssd_bwd_reduce")}
# (name, E, C, d, f, dtype): the TestGMM grid of tests/test_kernels.py in
# fp32 and bf16, two ragged shapes (the second not a multiple of 8 in d or
# f: element-wise loads), and deepseek-moe-16b's expert products: 64
# experts, d_model 2048, expert width 1408, capacity 968 for a prefill of
# 4 x 2048 tokens (top 6, factor 1.25) and 8 for a decode step of 4
GMM_GRID = [(f"grid_{E}x{C}x{d}x{f}", E, C, d, f, dt)
            for dt in ("float32", "bfloat16")
            for E, C, d, f in ((2, 16, 32, 64), (8, 64, 128, 64),
                               (4, 8, 256, 128), (3, 100, 72, 200),
                               (2, 37, 30, 50))]
GMM_MODEL_SHAPES = [
    ("prefill_gate_up", 64, 968, 2048, 1408, "bfloat16"),
    ("prefill_down", 64, 968, 1408, 2048, "bfloat16"),
    ("decode_gate_up", 64, 8, 2048, 1408, "bfloat16"),
]
# The backward kernels (phases flash_bwd and gmm_bwd). dQ, dK and dV (dx,
# dw) against the plain version's autograd in fp32: the largest elementwise
# difference as a share of the tensor's largest |plain| value, the worst row
# (a (b, s, h) vector over D) and the whole tensor in relative norm. The
# kernel rounds P and dS to bf16 for its products, as the forward rounds P.
BWD_ELEM_TOL = 2e-2
BWD_ROW_RTOL = 1e-1
BWD_NORM_RTOL = 1e-2
# a row's error is taken against its own norm, or this share of the median
# row norm where that is larger. Delta comes from the bf16 output (as in
# every flash backward, sdpa's too: its errors are printed beside), so each
# dQ row carries an error of about the same absolute size, largest where
# the output's rounding is (early causal rows, which see few keys and whose
# true dQ is small: the first row's is exactly 0); measured up to 5.2% of
# the median row at deepseek-7b's training shape, against faults at 70-100%
BWD_ROW_FLOOR = 1.0
LSE_TOL = 1e-4             # the forward's row log-sum-exp (base 2), absolute
BWD_KV_TILE = 64           # keys of the backward's K/V tile, a fault's unit
BWD_KERNELS = ("dkdv", "dq")   # the flash backward's tiled kernels, by pass
# the flash grid of phase 2 that the backward takes (no q_offset: training
# passes none), again at head_dims 112, 160 and 256, and a call where no row
# has a key
BWD_GRID = [(f"bwd_{name}", B, Sq, Sk, H, KVH, D, opts)
            for name, B, Sq, Sk, H, KVH, D, opts in GRID
            if not opts.get("q_offset")] + \
    [(f"bwd_{name}_d{d}", B, Sq, Sk, H, KVH, d, opts)
     for d in (112, 160, 256) for name, B, Sq, Sk, H, KVH, _, opts in GRID[:7]]
BWD_NO_KEYS = ("bwd_no_keys", 1, 64, 64, 2, 2, 64, {"kv_valid": 0, "causal": False})
# the training paths (phase train): full width, deepseek-7b at all 30
# layers, deepseek-moe-16b cut to 8 of 28 (1 dense and 7 MoE layers, 4.6e9
# parameters: 16.4e9 x 8 bytes of params, grads and bf16 moments do not fit
# 80 GB), mamba2-370m at all 48 and zamba2-7b at all 81 (6.67e9 x 8 bytes =
# 53.4 GB, as deepseek-7b's 6.91e9 took 57.8 GB at peak), gemma2-9b cut to
# 32 of 42 (16 local/global pairs: 7.26e9 parameters, 0.92e9 of them the
# 256 000-entry embedding; 24 layers peaked at 59.8 GB, and each layer adds
# 0.198e9 x 8 bytes; 42 layers' 9.2e9 x 8 bytes do not fit) and
# stablelm-12b to 20 of 40 (about 6.6e9; 12.1e9 x 8 bytes do not fit);
# batches of TRAIN_BATCH x TRAIN_SEQ tokens of the reference's synthetic
# stream, remat "full", bf16 moments, TRAIN_STEPS steps; the run's peak
# device memory must stay below the card's 80 GB
TRAIN_PATHS = ("deepseek-7b", "deepseek-moe-16b", "mamba2-370m", "zamba2-7b",
               "gemma2-9b", "stablelm-12b")
TRAIN_DEPTH_CUTS = {"deepseek-moe-16b": 8, "gemma2-9b": 32, "stablelm-12b": 20}
TRAIN_PEAK_BYTES = 80e9
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 8
TRAIN_LR, TRAIN_WARMUP = 1e-3, 1
# the paths the dry-run (repro_torch.launch.dryrun, on meta tensors in a
# child process) predicts and the card is held to: name -> (arch, kind)
DRYRUN_PATHS = {"train:deepseek-7b": ("deepseek-7b", "train"),
                "serve:deepseek-7b": ("deepseek-7b", "prefill")}
DRYRUN_PEAK_RTOL = 0.10    # predicted peak live bytes vs max_memory_allocated
DRYRUN_TIMEOUT_S = 300
DRYRUN: dict = {}          # the child process and its records
# per kernel wrapper on DRYRUN_PATHS, the kernel each call launches exactly
# once, by which the profiler's launches count the calls
PROFILED_KERNELS = {"flash_attention": "flash_fwd_kernel",
                    "flash_attention_bwd": "flash_bwd_dq_kernel"}
# faults planted in the flash backward of a training run, and whether the
# step-1 gate must fail on each. The last K/V tile's dK is reported only:
# under causal attention its 64 keys are seen by the last 64 queries alone
# and carry under 1% of dK's squared norm, so no leaf moves past its
# rounding floor (phase flash_bwd holds that fault on dK itself)
TRAIN_FAULTS = {"first_tile_dk_dropped": True, "last_tile_dk_dropped": False,
                "delta_zero": True}
# and in the SSD backward (paths with SSM layers). There the gate's floors
# are wide: at the reference's initialisation (dt = softplus of about N(0,
# 1), no residual scaling by depth) a rounding difference in one layer grows
# by about 1.5x a layer (measured on the CPU: 0.6% of every leaf's gradient
# at 2 bf16 layers, 8% at 8), so at 48 and 81 layers every leaf's floor is
# tens of percent. Only d cum without its reverse scan (ddt, hence dt_bias
# and a_log, off by several times) must fail the gate there; the flash
# faults, db from one head and the state gradient not carried are reported,
# and are held instead per call (the plain run's SSD calls replayed through
# the backward kernel, ``checking_ssd``) and in phases flash_bwd and ssd_bwd
SSD_TRAIN_FAULTS = {"dcum_no_reverse_scan": True, "db_one_head": False,
                    "state_grad_not_carried": False}
# the flash backward at the training paths' attention (B=2, S=2048,
# causal): deepseek-7b's 32 heads of 128, deepseek-moe-16b's 16, zamba2-7b's
# shared block's 32 of 112 (its faults are held here: on the SSM paths the
# step-1 gate's floors hide them, see SSD_TRAIN_FAULTS), gemma2-9b's 16 of
# 256 over 8 (softcap 50, scale 224^-0.5; its local layers' 4096 window does
# not bind at 2048) and stablelm-12b's 32 of 160 over 8
FLASH_TRAIN_SHAPES = [("deepseek7b_train", 2, 2048, 2048, 32, 32, 128, {}),
                      ("moe16b_train", 2, 2048, 2048, 16, 16, 128, {}),
                      ("zamba2_train", 2, 2048, 2048, 32, 32, 112, {}),
                      ("gemma2_train", 2, 2048, 2048, 16, 8, 256, GEMMA2_OPTS),
                      ("stablelm_train", 2, 2048, 2048, 32, 8, 160, {})]

# the main paths in order, each with the decode steps its agreement phase
# holds (None: no agreement and trace phases)
SERVE_PATHS = (("deepseek-7b", 0), ("zamba2-7b", 8), ("mamba2-370m", None),
               ("deepseek-moe-16b", 0), ("seamless-m4t-large-v2", 8),
               ("gemma2-9b", 8), ("stablelm-12b", 8),
               ("llama-3.2-vision-90b", 8), ("command-r-plus-104b", 0))
# full width, depth cut where 80 GB cannot hold the model in bf16 (8.8e10
# and 1.04e11 parameters): the VLM keeps 2 of its 20 five-layer groups
DEPTH_CUTS = {"llama-3.2-vision-90b": 10, "command-r-plus-104b": 4}
# the agreement phase's prompts where they differ from the serve phase's
# (B, S): gemma2-9b's 6144 tokens take its local layers past their window
AGREE_PROMPTS = {"gemma2-9b": (1, 6144)}
# the paths whose agreement phase replays every attention call of the plain
# run through the kernel (``call_check``)
REPLAY_CALLS = ("seamless-m4t-large-v2", "gemma2-9b", "stablelm-12b",
                "llama-3.2-vision-90b", "command-r-plus-104b")

VIDEO_SCENES, VIDEO_FPS = 4, 10   # Media.synthesize's defaults, as the reference's
VIDEO_QUESTION = "what objects appear?"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Median time of ``fn`` on the card, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(cost, peak=PEAK_BF16_FLOPS) -> tuple[float, str]:
    """Least time on the card for a call of (FLOPs, HBM bytes) ``cost`` (a
    kernel module's count), and what sets it: the operations at ``peak`` or
    the bytes at the HBM rate."""
    flops, nbytes = cost
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def attention_bound_ms(B, Sq, Sk, H, KVH, D, opts) -> tuple[float, str]:
    """The forward's bound: ``flash_attention.attention_cost`` (4 B H D an
    attended pair; q, k, v, o in bf16 read or written once) at the bf16
    peak or HBM rate."""
    from repro_torch.kernels import flash_attention as fa
    return bound_ms(fa.attention_cost(
        B, Sq, Sk, H, KVH, D, causal=opts.get("causal", True),
        window=opts.get("window", 0), q_offset=opts.get("q_offset", 0),
        kv_valid=opts.get("kv_valid")))


KERNEL_SOURCES = ("flash_attention", "flash_attention_bwd", "moe_gmm", "ssd_scan",
                  "ssd_scan_bwd")


def ptxas_kernels(report: str) -> list[dict]:
    """Registers and spill bytes of each kernel in one ptxas report."""
    out = []
    for chunk in report.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        out.append({"kernel": chunk.split("'", 1)[0][:90],
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None})
    return out


# the libraries whose kernels must be built from wgmma fed by TMA
HOPPER_LIBRARIES = ("flash_attention", "flash_attention_bwd", "moe_gmm", "ssd_scan",
                    "ssd_scan_bwd")
# the SSD backward's wgmma kernels: ptxas must report no spills for them
SSD_BWD_WGMMA_KERNELS = ("chunk_state_kernel", "rows_kernel", "cols_kernel")


def phase_card():
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ssd_scan as ss

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        libs = dict(zip(KERNEL_SOURCES, pool.map(_build.build, KERNEL_SOURCES)))
    build_s = time.perf_counter() - t0
    # what each library was compiled to: wgmma (HGMMA), TMA loads (UTMALDG),
    # mma.sync (HMMA); registers and spills from ptxas
    census = {}
    for name, lib in libs.items():
        census[name] = _build.sass_census(lib)
        report = _build.ptxas_report(lib).read_text()
        emit({"phase": "sass", "library": name, **census[name],
              "ptxas": ptxas_kernels(report),
              "wgmma_serialized": [line.strip() for line in report.splitlines()
                                   if "serialized" in line]})
    for name in HOPPER_LIBRARIES:
        if not (census[name]["HGMMA"] and census[name]["UTMALDG"]):
            raise AssertionError(f"{name}: no HGMMA or no UTMALDG in its SASS "
                                 f"({census[name]})")
    bwd_report = _build.ptxas_report(libs["ssd_scan_bwd"]).read_text()
    spills = [k for k in ptxas_kernels(bwd_report)
              if any(n in k["kernel"] for n in SSD_BWD_WGMMA_KERNELS) and
              k["spill_store_bytes"]]
    serialized = [line for line in bwd_report.splitlines() if "serialized" in line]
    if spills or serialized:
        raise AssertionError(f"ssd_scan_bwd's wgmma kernels: spills {spills}, "
                             f"serialized wgmma {serialized}")
    if census["flash_attention_bwd"]["HMMA"]:        # no mma.sync backward is left
        raise AssertionError(f"flash_attention_bwd: HMMA in its SASS "
                             f"({census['flash_attention_bwd']})")
    lib = fa._lib()
    for d in fa.HEAD_DIMS:
        if lib.flash_attention_smem_bytes(d) != fa.smem_bytes(d=d):
            raise AssertionError(f"smem_bytes({d}) disagrees with the kernel")
    for d in fa.BWD_HEAD_DIMS:
        for i, kernel in enumerate(BWD_KERNELS):
            if fa._bwd_lib().flash_attention_bwd_smem_bytes(d, i) != \
                    fa.bwd_smem_bytes(d, kernel):
                raise AssertionError(f"bwd_smem_bytes({d}, {kernel}) "
                                     "disagrees with the kernel")
    for n in (16, 32, 64, 128):
        if ss._lib().ssd_scan_smem_bytes(n) != ss.smem_bytes(n):
            raise AssertionError(f"ssd smem_bytes({n}) disagrees with the kernel")
    for i, kernel in enumerate(("chunk_state", "chunk_scan")):
        for n in (64, 128):
            if ss._lib().ssd_scan_wgmma_smem_bytes(i, n) != \
                    ss.wgmma_smem_bytes(kernel, n):
                raise AssertionError(f"ssd wgmma_smem_bytes({kernel}, {n}) "
                                     "disagrees with the kernel")
    for i, kernel in enumerate(("states", "chunks")):
        for n in (16, 64, 128):
            for ps in (16, 32, 64):
                if ss._bwd_lib().ssd_scan_bwd_smem_bytes(i, n, ps) != \
                        ss.bwd_smem_bytes(kernel, n, ps):
                    raise AssertionError(f"ssd bwd_smem_bytes({kernel}, {n}, "
                                         f"{ps}) disagrees with the kernel")
    for i, kernel in enumerate(ss.BWD_WGMMA_KERNELS):
        for n in (64, 128):
            if ss._bwd_lib().ssd_scan_bwd_wgmma_smem_bytes(i, n) != \
                    ss.bwd_wgmma_smem_bytes(kernel, n):
                raise AssertionError(f"ssd bwd_wgmma_smem_bytes({kernel}, {n}) "
                                     "disagrees with the kernel")
    for dtype, code in mg.DTYPES.items():
        if mg._lib().moe_gmm_smem_bytes(code) != mg.smem_bytes(dtype):
            raise AssertionError(f"gmm smem_bytes({dtype}) disagrees with the kernel")
    for block_c in mg.WGMMA_TILES:
        if mg._lib().moe_gmm_wgmma_smem_bytes(block_c // 64) != \
                mg.wgmma_smem_bytes(block_c):
            raise AssertionError(f"gmm wgmma_smem_bytes({block_c}) disagrees "
                                 "with the kernel")
    # the host cost of the wgmma path's two tensor maps, at decode's shape
    x = torch.empty(64, 8, 2048, dtype=torch.bfloat16, device="cuda")
    w = torch.empty(64, 2048, 1408, dtype=torch.bfloat16, device="cuda")
    encode_ns = mg._lib().moe_gmm_encode_ns(x.data_ptr(), w.data_ptr(),
                                            64, 8, 2048, 1408, 10000)
    if encode_ns < 0:
        raise AssertionError("cuTensorMapEncodeTiled refused the gmm tensor maps")
    del x, w
    try:
        import triton
        triton_version = triton.__version__
    except ImportError as err:
        triton_version = f"does not import: {err}"
    emit({"phase": "card", "card": card_line(), "triton": triton_version,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "smem_bytes_d128": fa.smem_bytes(d=128),
          "smem_bytes_d112": fa.smem_bytes(d=112),
          "smem_bytes_d160": fa.smem_bytes(d=160),
          "smem_bytes_d256": fa.smem_bytes(d=256),
          "bwd_smem_bytes": {d: {k: fa.bwd_smem_bytes(d, k) for k in BWD_KERNELS}
                             for d in fa.BWD_HEAD_DIMS},
          "bwd_tiles": fa.BWD_TILES,
          "bwd_blocks_per_sm": {d: {k: fa.bwd_blocks_per_sm(d, k) for k in BWD_KERNELS}
                                for d in fa.BWD_HEAD_DIMS},
          "block_threads": {d: fa.block_threads(d) for d in fa.HEAD_DIMS},
          "ssd_smem_bytes_n64": ss.smem_bytes(64),
          "ssd_smem_bytes_n128": ss.smem_bytes(128),
          "ssd_wgmma_smem_bytes": {k: {n: ss.wgmma_smem_bytes(k, n) for n in (64, 128)}
                                   for k in ("chunk_state", "chunk_scan")},
          "ssd_bwd_smem_bytes": {k: {n: ss.bwd_smem_bytes(k, n, 64) for n in (64, 128)}
                                 for k in ("states", "chunks")},
          "ssd_bwd_wgmma_smem_bytes": {k: {n: ss.bwd_wgmma_smem_bytes(k, n)
                                           for n in (64, 128)}
                                       for k in ss.BWD_WGMMA_KERNELS},
          "gmm_smem_bytes_mma": mg.smem_bytes(torch.bfloat16),
          "gmm_smem_bytes_wgmma": {c: mg.wgmma_smem_bytes(c) for c in mg.WGMMA_TILES},
          "gmm_bwd_tiles_at_train_capacity": mg.wgmma_bwd_tiles(train_capacity()),
          "gmm_tensor_map_encode_ns_per_call": encode_ns})
    return census


def row_errors(got, want):
    """|got - want| / |want| of each (b, q, h) row, 2-norms over D."""
    d, w = got.float() - want.float(), want.float()
    return d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)


def rel_errors(got, want) -> tuple[float, float]:
    """(worst row, whole tensor) of |got - want| / |want|, 2-norms; a row is
    one (b, q, h) vector over D."""
    d = got.float() - want.float()
    return row_errors(got, want).max().item(), \
        (d.norm() / want.float().norm()).item()


def moved_rows(got, want) -> float:
    """Share of the (b, q, h) rows that ``got`` moves beyond ROW_RTOL from
    ``want``."""
    return (row_errors(got, want) > ROW_RTOL).float().mean().item()


def injected_faults(q, k, v, kw):
    """The plain version's output under two faults a tiled kernel can have
    that move only the longest rows: the last K/V tile dropped, and the last
    tile computed with the previous tile's K/V (a stale pipeline stage);
    with a window, also the window's first tile dropped (a kernel that
    starts each window a tile late), which moves every row past it."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    Sk = k.shape[1]
    dropped = flash_attention_plain(q, k, v, **{**kw, "kv_valid": Sk - KV_TILE})
    ks, vs = k.clone(), v.clone()
    ks[:, -KV_TILE:] = k[:, -2 * KV_TILE:-KV_TILE]
    vs[:, -KV_TILE:] = v[:, -2 * KV_TILE:-KV_TILE]
    faults = {"last_tile_dropped": dropped,
              "last_tile_stale": flash_attention_plain(q, ks, vs, **kw)}
    if kw.get("window"):
        faults["window_first_tile_dropped"] = flash_attention_plain(
            q, k, v, **{**kw, "window": kw["window"] - KV_TILE})
    return faults


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst, failures, timings = 0.0, [], {}
    serving = (SERVE_SHAPE[0], ZAMBA_SHAPE[0], SEAMLESS_ENCODER[0],
               SEAMLESS_CROSS[0], *(shape[0] for shape in FAMILY_SHAPES))
    for name, B, Sq, Sk, H, KVH, D, opts in \
            GRID + GRID_WIDE + [SERVE_SHAPE, ZAMBA_SHAPE] + FAMILY_SHAPES + \
            SEAMLESS_SHAPES + EXECUTOR_SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, KVH, D), rnd(B, Sk, KVH, D)
        kw = dict(causal=opts.get("causal", True), window=opts.get("window", 0),
                  softcap=opts.get("softcap", 0.0), scale=opts.get("scale"),
                  q_offset=opts.get("q_offset", 0),
                  kv_valid=opts.get("kv_valid"))
        got = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        row_rel, norm_rel = rel_errors(got, want)
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), atol=KERNEL_TOL, rtol=KERNEL_TOL) \
            and row_rel <= ROW_RTOL and norm_rel <= NORM_RTOL
        worst = max(worst, err)
        line = {"phase": "kernel", "shape": name,
                "B_Sq_Sk_H_KVH_D": [B, Sq, Sk, H, KVH, D], "options": opts,
                "max_abs_err": err, "tol": KERNEL_TOL,
                "row_rel_err": row_rel, "row_rtol": ROW_RTOL,
                "norm_rel_err": norm_rel, "norm_rtol": NORM_RTOL}
        if name in serving:
            # the checks must have the power to see a one-tile fault
            line["faults"] = {}
            # A fault must exceed the worst-row limit; and the whole-output
            # limit too, unless it moves fewer than LOCAL_FAULT_ROWS of the
            # rows (the last tile of one 6144-row sequence moves 1%), which
            # no whole-output norm can see
            for fault, out in injected_faults(q, k, v, kw).items():
                f_row, f_norm = rel_errors(out, want)
                moved = moved_rows(out, want)
                line["faults"][fault] = {"row_rel_err": f_row,
                                         "norm_rel_err": f_norm,
                                         "rows_moved": moved}
                if f_row <= ROW_RTOL or (f_norm <= NORM_RTOL and
                                         moved >= LOCAL_FAULT_ROWS):
                    failures.append(f"{name}: limits miss {fault}")
                del out
            # what rounding P to bf16 adds: both against fp32 output
            exact = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
            line["vs_fp32_output"] = {
                "kernel_norm_rel_err": rel_errors(got, exact)[1],
                "plain_norm_rel_err": rel_errors(want, exact)[1],
                "kernel_max_abs_err": (got.float() - exact).abs().max().item(),
                "plain_max_abs_err": (want.float() - exact).abs().max().item()}
            del exact
        if kw["softcap"]:
            # the softcap's share of the kernel's error (gemma2-9b): the same
            # inputs without it, against the plain version and against an
            # fp32-output reference, beside the errors with it above
            kw0 = {**kw, "softcap": 0.0}
            got0 = flash_attention_cuda(q, k, v, **kw0)
            want0 = flash_attention_plain(q, k, v, **kw0)
            exact0 = flash_attention_plain(q.float(), k.float(), v.float(), **kw0)
            row0, norm0 = rel_errors(got0, want0)
            line["softcap_off"] = {
                "max_abs_err": (got0.float() - want0.float()).abs().max().item(),
                "row_rel_err": row0, "norm_rel_err": norm0,
                "kernel_norm_rel_err_vs_fp32": rel_errors(got0, exact0)[1],
                "plain_norm_rel_err_vs_fp32": rel_errors(want0, exact0)[1]}
            del got0, want0, exact0
        emit({**line, "ok": ok})
        if not ok:
            failures.append(name)
        if name in serving and ok:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bound_ms, bound_by = attention_bound_ms(B, Sq, Sk, H, KVH, D, opts)
            timing = timings[name] = {
                "ms": cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
                "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, **kw),
                                    warmup=1, iters=5),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=kw["causal"], scale=kw["scale"],
                    enable_gqa=H != KVH)),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            if kw["softcap"] or kw["window"]:
                # sdpa takes neither: it computes the causal attention over
                # every key, without the softcap; the kernel is timed so too
                timing["library_note"] = "sdpa without " + " or ".join(
                    o for o in ("softcap", "window") if kw[o])
                timing["ms_without_softcap_or_window"] = cuda_ms(
                    lambda: flash_attention_cuda(q, k, v, **{
                        **kw, "softcap": 0.0, "window": 0}))
            emit({"phase": "kernel_timing", "shape": name, **timing})
        del q, k, v, got, want
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return worst, timings


def ssd_bound_ms(B, L, H, P, N, G, chunk, dtype) -> tuple[float, str]:
    """One SSD scan's bound: ``ssd_scan.ssd_cost`` at the peak for the
    inputs' type or the HBM rate."""
    from repro_torch.kernels import ssd_scan as ss
    bf16 = dtype == "bfloat16"
    return bound_ms(ss.ssd_cost(B, L, H, P, N, G, chunk, 2 if bf16 else 4),
                    PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)


def ssd_inputs(gen, B, L, H, P, N, G, dtype):
    """Inputs of one SSD scan on the card. dt and A follow Mamba2's own
    initialisation (dt log-uniform in [1e-3, 1e-1], the configs' dt_min and
    dt_max; A in [1, 16]), so some heads keep their state across chunks and
    a fault in the state handoff shows."""
    import torch
    dt_ = getattr(torch, dtype)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")

    x = rnd(B, L, H, P, scale=0.5).to(dt_)
    dt = torch.exp(uni(math.log(1e-3), math.log(1e-1), B, L, H))
    a_log = torch.log(uni(1.0, 16.0, H))
    b = rnd(B, L, G, N, scale=0.3).to(dt_)
    c = rnd(B, L, G, N, scale=0.3).to(dt_)
    return x, dt, a_log, b, c, rnd(H)


def ssd_faults(args, chunk):
    """The plain version's (y, state) under three faults a chunked kernel can
    have; ``None`` where a fault leaves that output as it is:

    - the carried state dropped in the last chunk (it is scanned from zero);
    - one 64-step tile of the last chunk dropped (its b zeroed, so it enters
      neither y nor the state);
    - the final state not decayed at the last chunk boundary
      (S = S_prev + s_loc instead of e^{tot} S_prev + s_loc).
    """
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    x, dt, a_log, b, c, d_skip = args
    y, state = ssd_scan_plain(*args, chunk=chunk)
    y_last, s_loc = ssd_scan_plain(x[:, -chunk:], dt[:, -chunk:], a_log,
                                   b[:, -chunk:], c[:, -chunk:], d_skip,
                                   chunk=chunk)
    y[:, -chunk:] = y_last
    _, s_prev = ssd_scan_plain(x[:, :-chunk], dt[:, :-chunk], a_log,
                               b[:, :-chunk], c[:, :-chunk], d_skip,
                               chunk=chunk)
    tot = (dt[:, -chunk:].float() * -torch.exp(a_log.float())).sum(1)
    undecayed = state + (1 - torch.exp(tot))[..., None, None] * s_prev
    return {"last_chunk_state_dropped": (y, s_loc),
            "last_chunk_tile_dropped": dropped_tile_ssd(*args, chunk=chunk),
            "last_boundary_not_decayed": (None, undecayed)}


SSD_STAGES = ("chunk_state", "state_pass", "chunk_scan")   # the wgmma variant's kernels


def device_split(fn, iters: int = 5):
    """Every kernel one call of ``fn`` runs on the card: name, device ms per
    call and launches per call, from torch.profiler over ``iters`` calls
    after one warm-up; "not measured" where the profiler shows no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = [{"name": e.key[:100], "ms": _self_device_us(e) / 1e3 / iters,
            "calls": e.count / iters}
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(out, key=lambda k: -k["ms"]) if any(k["ms"] for k in out) \
        else "not measured"


def device_ms_by_kernel(fn, names, iters: int = 5):
    """Device ms per call of ``fn`` in each kernel whose name holds one of
    ``names`` (``device_split`` summed by name); "not measured" where the
    profiler shows no device time."""
    split = device_split(fn, iters)
    if split == "not measured":
        return split
    return {name: sum(k["ms"] for k in split if name in k["name"]) for name in names}


def phase_ssd():
    """The SSD kernels against their plain version (see the module
    docstring)."""
    import torch
    from repro_torch.kernels import ssd_scan as ss

    def norm_rel(got, want):
        return ((got.float() - want.float()).norm() / want.float().norm()).item()

    def held(y, state, y_p, state_p):
        """Errors against the plain version, and whether the bf16 limits
        hold."""
        errs = {"y_max_abs_err": (y.float() - y_p.float()).abs().max().item(),
                "state_max_abs_err": (state - state_p).abs().max().item(),
                "y_norm_rel_err": norm_rel(y, y_p),
                "state_norm_rel_err": norm_rel(state, state_p)}
        ok = bool(torch.isfinite(y).all() and torch.isfinite(state).all()) \
            and torch.allclose(y.float(), y_p.float(), atol=SSD_Y_TOL, rtol=SSD_Y_TOL) \
            and errs["y_norm_rel_err"] <= SSD_Y_RTOL \
            and errs["state_norm_rel_err"] <= SSD_STATE_RTOL
        return errs, ok

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst, failures, timings = 0.0, [], {}
    model_shapes = {s[0] for s in SSD_MODEL_SHAPES + SSD_RANK_SHAPES}
    for name, B, L, H, P, N, G, chunk, dtype in \
            SSD_GRID + SSD_MODEL_SHAPES + SSD_RANK_SHAPES:
        args = ssd_inputs(gen, B, L, H, P, N, G, dtype)
        variant = ss.ssd_variant(args[0], args[3], chunk)
        if name in model_shapes and variant != "wgmma":
            failures.append(f"{name}: takes the {variant} variant, not wgmma")
        y, state = ss.ssd_scan_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
        y_p, state_p = ss.ssd_scan_plain(*args, chunk=chunk)
        line = {"phase": "ssd", "shape": name, "dtype": dtype,
                "B_L_H_P_N_G_chunk": [B, L, H, P, N, G, chunk],
                "variant": variant}
        if dtype == "float32":
            tol = SSD_GRID_TOL
            line.update(y_max_abs_err=(y - y_p).abs().max().item(),
                        state_max_abs_err=(state - state_p).abs().max().item(),
                        y_norm_rel_err=norm_rel(y, y_p),
                        state_norm_rel_err=norm_rel(state, state_p), tol=tol)
            ok = bool(torch.isfinite(y).all() and torch.isfinite(state).all()) \
                and torch.allclose(y, y_p, atol=tol, rtol=tol) \
                and torch.allclose(state, state_p, atol=tol, rtol=tol)
        else:
            errs, ok = held(y, state, y_p, state_p)
            line.update(errs, y_tol=SSD_Y_TOL, y_rtol=SSD_Y_RTOL,
                        state_rtol=SSD_STATE_RTOL, faults={})
            # the limits must have the power to see a one-chunk fault: the
            # y limit each fault that moves y, the state limit the state's
            # own handoff fault
            for fault, (fy, fs) in ssd_faults(args, chunk).items():
                f_y = None if fy is None else norm_rel(fy, y_p)
                f_s = norm_rel(fs, state_p)
                line["faults"][fault] = {"y_norm_rel_err": f_y,
                                         "state_norm_rel_err": f_s}
                if f_y is not None and f_y <= SSD_Y_RTOL:
                    failures.append(f"{name}: y limit misses {fault}")
                if f_y is None and f_s <= SSD_STATE_RTOL:
                    failures.append(f"{name}: state limit misses {fault}")
            # the previous kernel, held to the same limits on the same inputs
            y_f, state_f = ss._launch("fma", *args, chunk=chunk)
            torch.cuda.synchronize()
            f_errs, f_ok = held(y_f, state_f, y_p, state_p)
            line["fma"] = {**f_errs, "ok": f_ok}
            if not f_ok:
                failures.append(f"{name}: fma variant")
            del y_f, state_f
        worst = max(worst, line["y_max_abs_err"])
        emit({**line, "ok": ok})
        if not ok:
            failures.append(name)
        if dtype == "bfloat16" and ok:
            bound_ms, bound_by = ssd_bound_ms(B, L, H, P, N, G, chunk, dtype)
            timings[name] = {
                "ms": cuda_ms(lambda: ss.ssd_scan_cuda(*args, chunk=chunk)),
                "fma_ms": cuda_ms(lambda: ss._launch("fma", *args, chunk=chunk)),
                "plain_ms": cuda_ms(lambda: ss.ssd_scan_plain(*args, chunk=chunk),
                                    warmup=1, iters=5),
                "library_ms": None,     # no one PyTorch call computes the SSD
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "variant": variant,
                "stage_ms": device_ms_by_kernel(
                    lambda: ss._launch(variant, *args, chunk=chunk), SSD_STAGES),
            }
            emit({"phase": "ssd_timing", "shape": name, **timings[name]})
        del args, y, state, y_p, state_p
    if failures:
        raise AssertionError(f"ssd kernel checks failed: {failures}")
    return worst, timings


def gmm_bound_ms(E, C, d, f, dtype) -> tuple[float, str]:
    """One grouped matmul's bound: ``moe_gmm.gmm_cost`` at the peak for the
    inputs' type or the HBM rate."""
    from repro_torch.kernels import moe_gmm as mg
    bf16 = dtype == "bfloat16"
    return bound_ms(mg.gmm_cost(E, C, d, f, 2 if bf16 else 4),
                    PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)


def gmm_faults(x, w):
    """The plain version's output under two faults a tiled grouped GEMM can
    have: the last GMM_STEP-deep step of the contraction dropped, and the
    last (ragged) C-tile of the last expert left unwritten (zero here)."""
    unwritten = plain_gmm(x, w)
    unwritten[-1, (x.shape[1] - 1) // GMM_TILE * GMM_TILE:] = 0
    return {"last_d_step_dropped": dropped_step_gmm(x, w),
            "last_c_tile_unwritten": unwritten}


def phase_gmm():
    """The grouped-GEMM kernel against its plain version (module docstring)."""
    import torch
    from repro_torch.kernels.moe_gmm import gmm_cuda, gmm_plain, gmm_variant

    def norm_rel(got, want):
        return ((got.float() - want.float()).norm() / want.float().norm()).item()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    worst, failures, timings = 0.0, [], {}
    for name, E, C, d, f, dtype in GMM_GRID + GMM_MODEL_SHAPES:
        model = name in {s[0] for s in GMM_MODEL_SHAPES}
        dt_ = getattr(torch, dtype)
        # the grid draws both factors N(0, 1) as TestGMM does; the model
        # shapes scale w by d^-1/2 so that outputs are O(1)
        x = torch.randn(E, C, d, generator=gen, device="cuda").to(dt_)
        w = (torch.randn(E, d, f, generator=gen, device="cuda")
             * (d ** -0.5 if model else 1.0)).to(dt_)
        got = gmm_cuda(x, w)
        torch.cuda.synchronize()
        want = gmm_plain(x, w)
        err = (got.float() - want.float()).abs().max().item()
        line = {"phase": "gmm", "shape": name, "dtype": dtype,
                "E_C_d_f": [E, C, d, f], "variant": gmm_variant(x, w),
                "max_abs_err": err,
                "norm_rel_err": norm_rel(got, want)}
        finite = bool(torch.isfinite(got).all())
        if model:
            ok = finite and torch.allclose(got.float(), want.float(),
                                           atol=KERNEL_TOL, rtol=KERNEL_TOL) \
                and line["norm_rel_err"] <= GMM_NORM_RTOL
            line.update(tol=KERNEL_TOL, norm_rtol=GMM_NORM_RTOL, faults={})
            # the norm limit must have the power to see a one-step fault
            # and a one-tile fault
            for fault, out in gmm_faults(x, w).items():
                f_norm = norm_rel(out, want)
                line["faults"][fault] = {"norm_rel_err": f_norm}
                if f_norm <= GMM_NORM_RTOL:
                    failures.append(f"{name}: norm limit misses {fault}")
                del out
        else:
            tol = GMM_TOL[dtype]
            ok = finite and torch.allclose(got.float(), want.float(),
                                           atol=tol * d ** 0.5, rtol=tol)
            line.update(atol=tol * d ** 0.5, rtol=tol)
        worst = max(worst, err)
        emit({**line, "ok": ok})
        if not ok:
            failures.append(name)
        if model and ok:
            bound_ms, bound_by = gmm_bound_ms(E, C, d, f, dtype)
            timings[name] = {
                "ms": cuda_ms(lambda: gmm_cuda(x, w)),
                "plain_ms": cuda_ms(lambda: gmm_plain(x, w), warmup=1, iters=5),
                "library_ms": cuda_ms(lambda: torch.bmm(x, w)),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            emit({"phase": "gmm_timing", "shape": name, **timings[name]})
        del x, w, got, want
    if failures:
        raise AssertionError(f"gmm kernel checks failed: {failures}")
    return worst, timings


def attention_bwd_bound_ms(B, Sq, Sk, H, KVH, D, opts) -> tuple[float, str]:
    """One attention backward's bound: ``flash_attention.attention_bwd_cost``
    (the five products, 10 B H D an attended pair; q, k, v, o, dO, LSE read
    and dQ, dK, dV written once) at the bf16 peak or HBM rate."""
    from repro_torch.kernels import flash_attention as fa
    return bound_ms(fa.attention_bwd_cost(
        B, Sq, Sk, H, KVH, D, causal=opts.get("causal", True),
        window=opts.get("window", 0), kv_valid=opts.get("kv_valid")))


def attention_grads_naive(q, k, v, dout, *, causal=True, window=0, softcap=0.0,
                          scale=None, zero_delta=False):
    """dQ, dK, dV of the attention from its formulas in fp32, one batch row
    at a time (q_offset 0): P from the full scores, dP = dO V^T, Delta =
    rowsum(dO o O), dS = P (dP - Delta) (times 1 - tanh^2 under a softcap).
    ``zero_delta`` leaves Delta at zero: a backward that never computed it."""
    import torch
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = D ** -0.5 if scale is None else scale
    keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril()
    if window:
        keep = keep.triu(1 - window)
    grads = [torch.empty(t.shape, dtype=torch.float32, device=q.device)
             for t in (q, k, v)]
    for b in range(B):
        qb = q[b].float().reshape(Sq, KVH, G, D)
        kb, vb = k[b].float(), v[b].float()
        dob = dout[b].float().reshape(Sq, KVH, G, D)
        x = torch.einsum("qhgd,khd->hgqk", qb, kb) * scale
        dy = 1.0
        if softcap:
            t = torch.tanh(x / softcap)
            x, dy = softcap * t, 1 - t * t
        p = torch.softmax(x.masked_fill(~keep, float("-inf")), dim=-1)
        dp = torch.einsum("qhgd,khd->hgqk", dob, vb)
        if zero_delta:
            delta = 0.0
        else:
            o = torch.einsum("hgqk,khd->qhgd", p, vb)
            delta = (dob * o).sum(-1).permute(1, 2, 0)[..., None]
        ds = p * (dp - delta) * dy
        grads[0][b] = torch.einsum("hgqk,khd->qhgd", ds, kb).reshape(Sq, H, D) * scale
        grads[1][b] = torch.einsum("hgqk,qhgd->khd", ds, qb) * scale
        grads[2][b] = torch.einsum("hgqk,qhgd->khd", p, dob)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def grad_errors(got, want) -> dict:
    """Elementwise (largest |got - want| over the largest |want|), worst row
    (against BWD_ROW_FLOOR) and whole-tensor relative errors of one
    gradient."""
    import torch
    diff = got.float() - want.float()
    d = diff.abs().max().item()
    rows = want.float().norm(dim=-1)
    scale = torch.maximum(rows, BWD_ROW_FLOOR * rows.median())
    return {"elem": d / max(want.float().abs().max().item(), 1e-30),
            "row": (diff.norm(dim=-1) / scale.clamp_min(1e-30)).max().item(),
            "norm": (diff.norm() / want.float().norm().clamp_min(1e-30)).item(),
            "max_abs": d}


def within_bwd_limits(e) -> bool:
    return e["elem"] <= BWD_ELEM_TOL and e["row"] <= BWD_ROW_RTOL and \
        e["norm"] <= BWD_NORM_RTOL


def phase_flash_bwd():
    """The flash backward kernel against its plain version (autograd through
    the plain forward in fp32): dQ, dK and dV on the grid and at the
    training shapes within BWD_ELEM_TOL, BWD_ROW_RTOL and BWD_NORM_RTOL,
    which two injected faults must exceed (the last K/V tile's dK dropped;
    Delta left at zero); the forward's row log-sum-exp at every head dim
    within LSE_TOL; a call with no key to attend to giving zero gradients;
    the backward run twice bitwise equal; timings beside the bound, the
    plain version and the backward of ``F.scaled_dot_product_attention``
    (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def options(opts):
        return dict(causal=opts.get("causal", True), window=opts.get("window", 0),
                    softcap=opts.get("softcap", 0.0), scale=opts.get("scale"),
                    kv_valid=opts.get("kv_valid"))

    failures, worst, timings = [], 0.0, {}
    # the forward's LSE at every head dim (one consumer warpgroup at 160, 256)
    lse_err = {}
    for d in fa.HEAD_DIMS:
        for name, opts in (("causal", {}), ("window_softcap",
                                            {"window": 48, "softcap": 30.0}),
                           ("noncausal", {"causal": False})):
            q, k, v = rnd(2, 300, 4, d), rnd(2, 300, 2, d), rnd(2, 300, 2, d)
            kw = options(opts)
            _, lse = fa._forward(q, k, v, q_offset=0, with_lse=True, **kw)
            want = fa.attention_lse_plain(q, k, causal=kw["causal"],
                                          window=kw["window"],
                                          softcap=kw["softcap"])
            lse_err[f"d{d}_{name}"] = err = (lse - want).abs().max().item()
            if not err <= LSE_TOL:
                failures.append(f"lse d{d} {name}: {err}")
    emit({"phase": "flash_lse", "max_abs_err": lse_err, "tol": LSE_TOL})

    for name, B, Sq, Sk, H, KVH, D, opts in [BWD_NO_KEYS] + BWD_GRID + \
            FLASH_TRAIN_SHAPES:
        q, k, v, do = rnd(B, Sq, H, D), rnd(B, Sk, KVH, D), rnd(B, Sk, KVH, D), \
            rnd(B, Sq, H, D)
        kw = options(opts)
        out, lse = fa._forward(q, k, v, q_offset=0, with_lse=True, **kw)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        if name == BWD_NO_KEYS[0]:
            ok = bool(torch.isneginf(lse).all()) and \
                all(bool((g == 0).all()) for g in got)
            emit({"phase": "flash_bwd", "shape": name, "lse_all_neg_inf":
                  bool(torch.isneginf(lse).all()), "grads_all_zero": ok, "ok": ok})
            if not ok:
                failures.append(name)
            continue
        want = fa.flash_attention_bwd_plain(q, k, v, do, **kw)
        errs = {g: grad_errors(a, b) for g, a, b in zip(("dq", "dk", "dv"), got, want)}
        ok = all(torch.isfinite(g).all() for g in got) and \
            all(within_bwd_limits(e) for e in errs.values())
        worst = max([worst] + [e["max_abs"] for e in errs.values()])
        line = {"phase": "flash_bwd", "shape": name,
                "B_Sq_Sk_H_KVH_D": [B, Sq, Sk, H, KVH, D], "options": opts,
                "errors": errs, "limits": {"elem": BWD_ELEM_TOL,
                                           "row": BWD_ROW_RTOL,
                                           "norm": BWD_NORM_RTOL}}
        if name in {s[0] for s in FLASH_TRAIN_SHAPES}:
            # the limits must have the power to see a one-tile fault and a
            # missing Delta: each must pass one of them
            dk_dropped = want[1].clone()
            dk_dropped[:, -BWD_KV_TILE:] = 0
            no_delta = attention_grads_naive(q, k, v, do, zero_delta=True,
                                             **{o: kw[o] for o in
                                                ("causal", "window", "softcap",
                                                 "scale")})
            faults = {"last_tile_dk_dropped": {"dk": grad_errors(dk_dropped, want[1])},
                      "delta_zero": {g: grad_errors(a, b) for g, a, b in
                                     zip(("dq", "dk"), no_delta[:2], want[:2])}}
            line["faults"] = faults
            for fault, by_grad in faults.items():
                if all(within_bwd_limits(e) for e in by_grad.values()):
                    failures.append(f"{name}: limits miss {fault}")
            del dk_dropped, no_delta
            # the library's backward against the same plain version (it
            # takes no softcap: there it is timed only)
            sdpa_kw = {"is_causal": True, "scale": kw["scale"],
                       "enable_gqa": H != KVH}
            if not kw["softcap"]:
                qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_()
                              for t in (q, k, v))
                lib = torch.autograd.grad(F.scaled_dot_product_attention(
                    qs, ks, vs, **sdpa_kw), (qs, ks, vs), do.transpose(1, 2))
                line["library_errors"] = {g: grad_errors(a.transpose(1, 2), b)
                                          for g, a, b in zip(("dq", "dk", "dv"),
                                                             lib, want)}
                del qs, ks, vs, lib
            again = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
            line["bitwise_repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
            if not line["bitwise_repeat"]:
                failures.append(f"{name}: the backward is not bitwise repeatable")
            del again
            if ok:
                qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_()
                              for t in (q, k, v))
                sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)
                do_t = do.transpose(1, 2)
                bound_ms, bound_by = attention_bwd_bound_ms(B, Sq, Sk, H, KVH, D, opts)
                timings[name] = {
                    "ms": cuda_ms(lambda: fa.flash_attention_bwd_cuda(
                        q, k, v, out, do, lse, **kw)),
                    "plain_ms": cuda_ms(lambda: fa.flash_attention_bwd_plain(
                        q, k, v, do, **kw), warmup=1, iters=3),
                    "library_ms": cuda_ms(lambda: torch.autograd.grad(
                        sdpa_out, (qs, ks, vs), do_t, retain_graph=True)),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_note": "the backward of F.scaled_dot_product_attention"
                                    + (" (no softcap)" if kw["softcap"] else ""),
                    "fwd_with_lse_ms": cuda_ms(lambda: fa._forward(
                        q, k, v, q_offset=0, with_lse=True, **kw)),
                    "library_fwd_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                        qs.detach(), ks.detach(), vs.detach(), **sdpa_kw)),
                    "device_split": device_split(lambda: fa.flash_attention_bwd_cuda(
                        q, k, v, out, do, lse, **kw)),
                }
                emit({"phase": "flash_bwd_timing", "shape": name, **timings[name]})
                del sdpa_out, qs, ks, vs
        emit({**line, "ok": bool(ok)})
        if not ok:
            failures.append(name)
        del q, k, v, do, out, lse, got, want
    if failures:
        raise AssertionError(f"flash backward checks failed: {failures}")
    return worst, timings


def gmm_bwd_bound_ms(E, C, d, f) -> tuple[float, str]:
    """The bound of dx and dw of one bf16 grouped matmul:
    ``moe_gmm.gmm_bwd_cost`` at the bf16 peak or HBM rate."""
    from repro_torch.kernels import moe_gmm as mg
    return bound_ms(mg.gmm_bwd_cost(E, C, d, f))


def train_capacity(arch="deepseek-moe-16b") -> int:
    """The MoE capacity of a training batch of TRAIN_BATCH x TRAIN_SEQ."""
    from repro_torch.models.moe import _capacity
    return _capacity(TRAIN_BATCH * TRAIN_SEQ, path_config(arch))


def phase_gmm_bwd():
    """The grouped GEMM's backward (two kernel launches: dx = dy w^T, dw =
    x^T dy) against the two einsums in fp32: the kernel-test grid in fp32
    and bf16 within TOL * sqrt(contraction), and deepseek-moe-16b's expert
    products at the training capacity in bf16 within KERNEL_TOL of the
    largest |plain| value elementwise and GMM_NORM_RTOL in relative norm,
    which the forward's two faults on each product must exceed; every launch
    at the model shapes on the ``wgmma_bwd`` variant, with no device memory
    beyond dx and dw allocated over the call (no transposed copy); timings
    beside the bound, the plain version and the backward of ``torch.bmm`` (a
    yardstick the port never calls), with the call's kernels split by
    torch.profiler."""
    import torch
    from repro_torch.kernels.moe_gmm import gmm_bwd_cuda, gmm_bwd_plain

    def norm_rel(got, want):
        return ((got.float() - want.float()).norm() / want.float().norm()).item()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    C = train_capacity()
    shapes = [(name, E, Cg, d, f, dt) for name, E, Cg, d, f, dt in GMM_GRID] + \
        [("train_gate_up", 64, C, 2048, 1408, "bfloat16"),
         ("train_down", 64, C, 1408, 2048, "bfloat16")]
    worst, failures, timings = 0.0, [], {}
    for name, E, Cg, d, f, dtype in shapes:
        model = name.startswith("train")
        dt_ = getattr(torch, dtype)
        x = torch.randn(E, Cg, d, generator=gen, device="cuda").to(dt_)
        w = (torch.randn(E, d, f, generator=gen, device="cuda")
             * (d ** -0.5 if model else 1.0)).to(dt_)
        dy = (torch.randn(E, Cg, f, generator=gen, device="cuda")
              * (Cg ** -0.5 if model else 1.0)).to(dt_)
        before = dict(gmm_bwd_cuda.variant_launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        got = gmm_bwd_cuda(x, w, dy)
        torch.cuda.synchronize()
        # device memory the call allocated beyond its outputs: a transposed
        # copy of x or w would show here
        extra = torch.cuda.max_memory_allocated() - held - \
            sum(g.untyped_storage().nbytes() for g in got)
        variants = {k: gmm_bwd_cuda.variant_launches[k] - before[k] for k in before}
        want = gmm_bwd_plain(x, w, dy)
        line = {"phase": "gmm_bwd", "shape": name, "dtype": dtype,
                "E_C_d_f": [E, Cg, d, f], "variants": variants,
                "bytes_beyond_outputs": extra}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        errs = {}
        for g, a, b, depth in (("dx", got[0], want[0], f), ("dw", got[1], want[1], Cg)):
            e = (a.float() - b.float()).abs().max().item()
            errs[g] = {"max_abs": e, "norm_rel": norm_rel(a, b)}
            worst = max(worst, e)
            if model:
                errs[g]["elem"] = e / b.float().abs().max().item()
                errs[g]["ok"] = errs[g]["elem"] <= KERNEL_TOL and \
                    errs[g]["norm_rel"] <= GMM_NORM_RTOL
            else:
                tol = GMM_TOL[dtype]
                errs[g]["ok"] = torch.allclose(a.float(), b.float(),
                                               atol=tol * depth ** 0.5, rtol=tol)
        ok = finite and all(e["ok"] for e in errs.values())
        line["errors"] = errs
        if model:
            # a transposed copy of x or w is 128 MB or more; 1 MiB allows for
            # the allocator's rounding
            ok = ok and variants["wgmma_bwd"] == 2 and extra < 2 ** 20
            # the norm limit must see a one-step and a one-tile fault of
            # each product: dx = gmm(dy, w^T), dw = gmm(x^T, dy)
            wt, xt = w.transpose(1, 2).contiguous(), x.transpose(1, 2).contiguous()
            line["faults"] = {}
            for g, (a, b), plain in (("dx", (dy, wt), want[0]),
                                     ("dw", (xt, dy), want[1])):
                for fault, out in gmm_faults(a, b).items():
                    f_norm = norm_rel(out, plain)
                    line["faults"][f"{g}_{fault}"] = f_norm
                    if f_norm <= GMM_NORM_RTOL:
                        failures.append(f"{name}: norm limit misses {g} {fault}")
            del wt, xt
        emit({**line, "ok": bool(ok)})
        if not ok:
            failures.append(name)
        if model and ok:
            xs, ws = (t.detach().requires_grad_() for t in (x, w))
            y = torch.bmm(xs, ws)
            bound_ms, bound_by = gmm_bwd_bound_ms(E, Cg, d, f)
            timings[name] = {
                "ms": cuda_ms(lambda: gmm_bwd_cuda(x, w, dy)),
                "plain_ms": cuda_ms(lambda: gmm_bwd_plain(x, w, dy), warmup=1,
                                    iters=5),
                "library_ms": cuda_ms(lambda: torch.autograd.grad(
                    y, (xs, ws), dy, retain_graph=True)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_note": "the backward of torch.bmm (dx and dw)",
                "capacity": Cg,
                "device_split": device_split(lambda: gmm_bwd_cuda(x, w, dy)),
            }
            emit({"phase": "gmm_bwd_timing", "shape": name, **timings[name]})
            del xs, ws, y
        del x, w, dy, got, want
    if failures:
        raise AssertionError(f"gmm backward checks failed: {failures}")
    return worst, timings


def ssd_bwd_bound_ms(B, L, H, P, N, G, chunk, dtype) -> tuple[float, str]:
    """One SSD backward's bound: ``ssd_scan.ssd_bwd_cost`` at the peak for
    the inputs' type or the HBM rate."""
    from repro_torch.kernels import ssd_scan as ss
    bf16 = dtype == "bfloat16"
    return bound_ms(ss.ssd_bwd_cost(B, L, H, P, N, G, chunk, 2 if bf16 else 4),
                    PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)


def ssd_grads_plain(args, dy, dstate, chunk):
    """The six gradients of the plain SSD by autograd in fp32 (every input
    an fp32 leaf), each rounded to its input's dtype."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    with torch.enable_grad():
        leaves = [a.detach().float().requires_grad_() for a in args]
        y, state = ssd_scan_plain(*leaves, chunk=chunk)
        outs, cots = (y, state), (dy.float(), dstate)
        if dstate is None:
            outs, cots = (y,), (dy.float(),)
        grads = torch.autograd.grad(outs, leaves, cots)
    return tuple(g.to(a.dtype) for g, a in zip(grads, args))


def ssd_bwd_faults(args, dy, dstate, chunk) -> dict:
    """The six gradients under three faults an SSD backward can have, from
    the plain backward's stages:

    - ``state_grad_not_carried``: the reverse state pass carries nothing
      into the previous chunk (every chunk but the last sees a zero
      gradient of its leaving state);
    - ``dcum_no_reverse_scan``: d cum taken for d la, without the reverse
      cumulative sum within the chunk (ddt and da_log);
    - ``db_one_head``: db of each group from its first head only.
    """
    import torch
    from repro_torch.kernels import ssd_scan as ss
    x, dt, a_log, b, c, d_skip = args
    G = b.shape[2]
    s_in, g = ss.bwd_states_plain(x, dt, a_log, b, c, dy, dstate, chunk=chunk)

    def finish(g_, scan=True, one_head=False):
        dx, xdu, dcum, db_h, dc_h, dd_p = ss.bwd_chunks_plain(
            x, dt, a_log, b, c, d_skip, dy, s_in, g_, chunk=chunk)
        if scan:
            ddt, da_p = ss.bwd_log_decay_plain(dt, a_log, xdu, dcum, chunk=chunk)
        else:
            A = -torch.exp(a_log.float())
            ddt = xdu + A * dcum
            da_p = A * dt.float() * dcum          # summed over (B, L)
        db, dc, da, dd = ss.bwd_reduce_plain(db_h, dc_h, da_p, dd_p, G)
        if one_head:
            Bb, L, H, N = db_h.shape
            db = db_h.reshape(Bb, L, G, H // G, N)[:, :, :, 0]
        return tuple(t.to(a.dtype) for t, a in
                     zip((dx, ddt, da, db, dc, dd), (x, dt, a_log, b, c, d_skip)))

    g_dropped = g.clone()
    g_dropped[:, :-1] = 0
    return {"state_grad_not_carried": finish(g_dropped),
            "dcum_no_reverse_scan": finish(g, scan=False),
            "db_one_head": finish(g, one_head=True)}


def ssd_bwd_errors(got, want) -> dict:
    """Per gradient: the largest difference as a share of the largest
    |want| value, the relative norm, the largest difference, and whether
    both are within the limits of the gradient's dtype."""
    out = {}
    for name, g, w in zip(SSD_GRADS, got, want):
        dtype = str(w.dtype).split(".")[1]
        d = (g.float() - w.float())
        e = {"elem": d.abs().max().item() / max(w.float().abs().max().item(), 1e-30),
             "norm": (d.norm() / w.float().norm().clamp_min(1e-30)).item(),
             "max_abs": d.abs().max().item()}
        e["ok"] = bool(e["elem"] <= SSD_BWD_ELEM[dtype] and
                       e["norm"] <= SSD_BWD_RTOL[dtype])
        out[name] = e
    return out


def ssd_rank_entries(timings, shapes, what) -> dict:
    """The kernels line's ``at_<shape>`` entries of the per-rank SSD
    shapes: each one's timings and its shape."""
    return {f"at_{name.replace('-', '_')}": {
        **timings[name],
        "shape": f"B={B} L={L} H={H} P={P} N={N} G={G} chunk={chunk} bf16 "
                 f"({name.split('_')[0]} {what}, one rank of "
                 f"{'(1, 4)' if name.endswith('tp4') else '(2, 2)'})"}
        for name, B, L, H, P, N, G, chunk, _ in shapes}


def phase_ssd_bwd():
    """The SSD backward kernels against autograd through the plain version
    in fp32 (see the module docstring): the variant ``ssd_bwd_variant``
    picks on every shape, which must be wgmma at the training shapes, and
    there the fma variant too, held to the same limits and timed beside
    it."""
    import torch
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    worst, failures, timings = 0.0, [], {}
    train_shapes = {s[0] for s in SSD_TRAIN_SHAPES + SSD_RANK_TRAIN_SHAPES}
    for name, B, L, H, P, N, G, chunk, dtype in \
            SSD_GRID + SSD_TRAIN_SHAPES + SSD_RANK_TRAIN_SHAPES:
        args = ssd_inputs(gen, B, L, H, P, N, G, dtype)
        dy = torch.randn(B, L, H, P, generator=gen, device="cuda").to(args[0].dtype)
        dstate = None if name in train_shapes else \
            torch.randn(B, H, P, N, generator=gen, device="cuda")
        variant = ss.ssd_bwd_variant(args[0], args[3], chunk)
        if name in train_shapes and variant != "wgmma":
            failures.append(f"{name}: the backward takes {variant}, not wgmma")
        want = ssd_grads_plain(args, dy, dstate, chunk)

        def call(v, dstate=dstate):
            """One backward of variant ``v``: the wrapper's own pick through
            the wrapper (counted), the other through its launch function."""
            if v == variant:
                return ss.ssd_scan_bwd_cuda(*args, dy, dstate, chunk=chunk)
            return ss._launch_bwd(v, *args, dy, dstate, chunk)

        held = {}
        for v in dict.fromkeys([variant, "fma" if name in train_shapes else variant]):
            got, again = call(v), call(v)
            torch.cuda.synchronize()
            errs = ssd_bwd_errors(got, want)
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            held[v] = {"errors": errs, "bitwise_repeat": repeat,
                       "ok": all(bool(torch.isfinite(g).all()) for g in got) and
                       all(e["ok"] for e in errs.values()) and repeat}
            if v == variant:
                worst = max([worst] + [e["max_abs"] for e in errs.values()])
            if not held[v]["ok"]:
                failures.append(f"{name}: {v}")
            del got, again
        line = {"phase": "ssd_bwd", "shape": name, "dtype": dtype,
                "B_L_H_P_N_G_chunk": [B, L, H, P, N, G, chunk],
                "state_cotangent": dstate is not None, "variant": variant,
                **held[variant],
                "limits": {"elem": SSD_BWD_ELEM, "norm": SSD_BWD_RTOL}}
        if "fma" in held and variant != "fma":
            line["fma"] = held["fma"]
        if name in train_shapes:
            # the limits must have the power to see each fault: some
            # gradient outside its limits
            line["faults"] = {}
            for fault, grads in ssd_bwd_faults(args, dy, dstate, chunk).items():
                f_errs = ssd_bwd_errors(grads, want)
                seen = [g for g, e in f_errs.items() if not e["ok"]]
                line["faults"][fault] = {"seen_by": seen, **{
                    g: {"elem": e["elem"], "norm": e["norm"]}
                    for g, e in f_errs.items()}}
                if not seen:
                    failures.append(f"{name}: limits miss {fault}")
                del grads
        ok = all(h["ok"] for h in held.values())
        emit({**line, "ok": ok})
        if name in train_shapes and ok:
            bound_ms, bound_by = ssd_bwd_bound_ms(B, L, H, P, N, G, chunk, dtype)
            timings[name] = {
                "ms": cuda_ms(lambda: call(variant, None)),
                "fma_ms": cuda_ms(lambda: call("fma", None)),
                "plain_ms": cuda_ms(lambda: ss.ssd_scan_bwd_plain(
                    *args, dy, chunk=chunk), warmup=1, iters=3),
                "autograd_plain_ms": cuda_ms(lambda: ssd_grads_plain(
                    args, dy, None, chunk), warmup=1, iters=3),
                "library_ms": None,     # no one PyTorch call computes it
                "bound_ms": bound_ms, "bound_by": bound_by,
                "variant": variant,
                "stage_ms": device_ms_by_kernel(lambda: call(variant, None),
                                                SSD_BWD_STAGES[variant]),
                "fma_stage_ms": device_ms_by_kernel(lambda: call("fma", None),
                                                    SSD_BWD_STAGES["fma"]),
                "fwd_ms": cuda_ms(lambda: ss.ssd_scan_cuda(*args, chunk=chunk)),
            }
            emit({"phase": "ssd_bwd_timing", "shape": name, **timings[name]})
        del args, dy, dstate, want
    if failures:
        raise AssertionError(f"ssd backward checks failed: {failures}")
    return worst, timings


def _sync_s(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def expected_launches(cfg, mode: str = "prefill") -> dict:
    """Launches of each kernel that one prefill (or one decode step) of
    ``cfg`` must make. Prefill: one flash launch per attention block, the
    encoder's and the cross-attention blocks' too, one SSD launch per SSM
    layer, three grouped-GEMM launches (gate, up, down) per MoE layer. A
    decode step: one flash launch per cross-attention block (self-attention
    decodes by the plain GEMV, the SSM by its recurrence) and the same
    grouped-GEMM launches."""
    from repro_torch.models.transformer import encoder_plan, layer_plan
    prefill = mode == "prefill"
    plan = layer_plan(cfg)
    if prefill and cfg.family == "encdec":
        plan += encoder_plan(cfg)
    count = {"flash_attention": 0, "gmm": 0, "ssd_scan": 0}
    for gd in plan:
        for b in gd.blocks:
            if b.kind == "cross_attn" or (
                    prefill and b.kind in ("attn", "parallel", "shared_attn")):
                count["flash_attention"] += gd.repeat
            elif b.kind == "ssm" and prefill:
                count["ssd_scan"] += gd.repeat
            elif b.kind == "moe":
                count["gmm"] += 3 * gd.repeat
    return count


def path_config(arch):
    """The configuration a serve path runs: full width, its depth cut to
    DEPTH_CUTS where it has one."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    return cfg.replace(n_layers=DEPTH_CUTS[arch]) if arch in DEPTH_CUTS else cfg


def path_extras(cfg, batch: int, gen) -> dict:
    """A path's modality inputs on the card, random bf16 from ``gen``: the
    encoder-decoder's ENC_LEN frames, the VLM's NUM_PATCHES patches (the
    reference's zero stub patches would make the cross-attention K/V zero
    and its check empty)."""
    import torch
    if cfg.family == "encdec":
        shape = (batch, ENC_LEN, cfg.d_model)
    elif cfg.family == "vlm":
        assert cfg.vision.num_patches == NUM_PATCHES
        shape = (batch, NUM_PATCHES, cfg.vision.d_vision)
    else:
        return {}
    name = "frames" if cfg.family == "encdec" else "patches"
    return {name: torch.randn(shape, generator=gen, device="cuda").bfloat16()}


def generate_launches(cfg, new_tokens: int) -> dict:
    """Launches of one ``generate``: a prefill and new_tokens - 1 decode steps."""
    pre, dec = expected_launches(cfg), expected_launches(cfg, "decode")
    return {k: pre[k] + (new_tokens - 1) * dec[k] for k in pre}


def plan_video_workflow(plan_name: str):
    """(dag, plan, library) of the video workflow as the port's planner makes
    it on its paper cluster: ``"min_cost"`` plans the MIN_COST declarative
    job, ``"baseline"`` lowers the baseline workflow for the first paper
    video."""
    from repro_torch.configs.workflow_video import (PAPER_VIDEOS,
                                                    make_baseline_workflow,
                                                    make_declarative_job)
    from repro_torch.core import MIN_COST, Murakkab
    system = Murakkab.paper_cluster()
    if plan_name == "min_cost":
        dag, plan = system.plan(make_declarative_job(MIN_COST))
    elif plan_name == "baseline":
        dag, plan = system.lower_imperative(make_baseline_workflow(),
                                            PAPER_VIDEOS[:1])
    else:
        raise ValueError(f"no video plan {plan_name!r}")
    return dag, plan, system.library


def plan_rows(dag, plan) -> list:
    """One row per task in topological order: task, agent, impl, pool,
    devices x instances, batch."""
    return [{"task": tid, "agent": dag.nodes[tid].agent, "impl": plan[tid].impl,
             "pool": plan[tid].pool,
             "devices_x_instances": f"{plan[tid].n_devices}x{plan[tid].n_instances}",
             "batch": plan[tid].batch} for tid in dag.topo_order]


def launch_counters():
    """Each kernel wrapper by name: the forward kernels count launches, the
    backward wrappers count calls (three kernels each for the flash and SSD
    backwards, two launches of the gmm kernel for its backward)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.moe_gmm import gmm_bwd_cuda, gmm_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    return {"flash_attention": flash_attention_cuda, "gmm": gmm_cuda,
            "ssd_scan": ssd_scan_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "gmm_bwd": gmm_bwd_cuda, "ssd_scan_bwd": ssd_scan_bwd_cuda}


def reset_launches():
    """Every kernel's launch counts, by variant too, set to 0."""
    for fn in launch_counters().values():
        fn.launches = 0
        if hasattr(fn, "variant_launches"):
            fn.variant_launches = dict.fromkeys(fn.variant_launches, 0)


def read_launches() -> dict:
    counters = launch_counters()
    return {**{name: fn.launches for name, fn in counters.items()},
            "gmm_by_variant": dict(counters["gmm"].variant_launches),
            "gmm_bwd_by_variant": dict(counters["gmm_bwd"].variant_launches),
            "ssd_by_variant": dict(counters["ssd_scan"].variant_launches),
            "ssd_bwd_by_variant": dict(counters["ssd_scan_bwd"].variant_launches)}


def phase_serve(arch):
    """One main path: returns the model pieces phases 4 and 5 reuse and the
    launches of each kernel in this path's run. The encoder-decoder serves
    1-token prompts over ENC_LEN frames of random bf16 embeddings (the stub
    frontend's input), the VLM 2048-token prompts over NUM_PATCHES random
    patches; DEPTH_CUTS cut a path's depth, never its width."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime.serve import ServeOptions, ServeSession, \
        build_prefill_step, cross_len

    cfg = path_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, init_s = _sync_s(lambda: model.init(gen))
    scale_routed_experts(model, params)
    sess = ServeSession(model, params, ServeOptions(), device="cuda")
    encdec = cfg.family == "encdec"
    prompt_len = 1 if encdec else PROMPT_LEN
    prompts = [torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt_len),
                             generator=gen, device="cuda")
               for _ in range(SERVE_BATCHES)]
    extras = [path_extras(cfg, SERVE_BATCH, gen) for _ in range(SERVE_BATCHES)]
    enc_len = cross_len(extras[0])
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    outs, gen_s = [], []
    for p, ex in zip(prompts, extras):
        out, s = _sync_s(lambda: sess.generate(p, max_new_tokens=MAX_NEW,
                                               extras=ex))
        outs.append(out)
        gen_s.append(s)
    launches = read_launches()
    gmm_variants, ssd_variants = launches["gmm_by_variant"], launches["ssd_by_variant"]

    peak = torch.cuda.max_memory_allocated()
    for out in outs:
        if out.shape != (SERVE_BATCH, MAX_NEW) or bool(
                ((out < 0) | (out >= cfg.vocab_size)).any()):
            raise AssertionError(f"bad generate output {tuple(out.shape)}")
    for name, per_batch in generate_launches(cfg, MAX_NEW).items():
        if launches[name] != per_batch * SERVE_BATCHES:
            raise AssertionError(f"{name} kernel launched {launches[name]} "
                                 f"times on {arch}; expected {per_batch} per "
                                 f"batch")
    # every expert product of the model shapes (prefill and decode) must
    # take the TMA + wgmma kernel
    if gmm_variants["wgmma"] != launches["gmm"]:
        raise AssertionError(f"{arch}: gmm launches by variant {gmm_variants}; "
                             f"all {launches['gmm']} must be wgmma")
    # and every SSD scan of the model shapes the chunk-state decomposition
    if ssd_variants["wgmma"] != launches["ssd_scan"]:
        raise AssertionError(f"{arch}: SSD launches by variant {ssd_variants}; "
                             f"all {launches['ssd_scan']} must be wgmma")

    # prefill alone, same entry point the session uses, for the split
    prefill = build_prefill_step(model, ServeOptions())
    pre_s = []
    for p, ex in zip(prompts, extras):
        cache = model.init_cache(SERVE_BATCH, prompt_len + MAX_NEW,
                                 enc_len=enc_len, device="cuda")
        with torch.inference_mode():
            s = _sync_s(lambda: prefill(params, {"tokens": p, **ex}, cache))[1]
        pre_s.append(s)
        del cache
    if f"serve:{arch}" in DRYRUN_PATHS:
        # one prefill over a cache of the prompt's length, as the dry-run
        # traces it, under the profiler
        from torch.profiler import ProfilerActivity, profile
        cache = model.init_cache(SERVE_BATCH, prompt_len, enc_len=enc_len,
                                 device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill(params, {"tokens": prompts[0], **extras[0]}, cache)
            torch.cuda.synchronize()
        check_dryrun(f"serve:{arch}", prof, torch.cuda.max_memory_allocated())
        del cache
    prefill_ms = 1e3 * statistics.median(pre_s)
    decode_ms = (1e3 * statistics.median(gen_s) - prefill_ms) / (MAX_NEW - 1)
    cut = {"reduced": {"n_layers": [get_config(arch).n_layers, cfg.n_layers]}} \
        if arch in DEPTH_CUTS else {}
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers, **cut,
          "d_model": cfg.d_model, "params": model.param_count(),
          "batches": SERVE_BATCHES, "batch": SERVE_BATCH,
          "prompt_len": prompt_len, "enc_len": enc_len or None,
          "max_new": MAX_NEW,
          "init_s": init_s, "generate_s": gen_s, "prefill_ms": prefill_ms,
          "decode_ms_per_token": decode_ms,
          "tok_per_s": SERVE_BATCHES * SERVE_BATCH * MAX_NEW / sum(gen_s),
          "max_memory_allocated": peak,
          **{f"{name}_launches": launches[name] for name in launch_counters()},
          "expected_launches_per_batch": generate_launches(cfg, MAX_NEW),
          "gmm_launches_by_variant": gmm_variants,
          "ssd_scan_launches_by_variant": ssd_variants})
    return model, params, prompts[0], extras[0], launches


def phase_executor():
    """The port's planner and its ``RealExecutor.run`` on the card over the
    video workflow. First ``repro_torch.core`` plans both video plans
    (``plan_video_workflow``) and simulates the MIN_COST job on the paper
    cluster; each plan's rows and the simulated makespan and energy (the
    planner's model of that cluster, not a card measurement) are printed
    with the host seconds they took, and a failure to plan fails the
    phase. Then the executor runs on full-width seamless-m4t-large-v2 and
    deepseek-7b from a seeded torch init, media of VIDEO_SCENES scenes x
    VIDEO_FPS frames from a seeded generator. Three runs: MIN_COST, MIN_COST again, baseline; each
    with the launch counts reset before it and read after it. Checks the
    outputs' shapes and ranges, bitwise-equal outputs across the two MIN_COST
    runs, equal summaries across the two plans, the flash launches of each
    run, and one qa call. Then a MIN_COST run and a qa call through the
    plain attention, whose every attention call ``call_check`` replays
    through the kernel. Returns the first run's launches."""
    import functools
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.workflow_video import make_declarative_job
    from repro_torch.core import (MIN_COST, Media, Murakkab, RealExecutor,
                                  seeded_sessions)
    from repro_torch.kernels import ops

    plans = {}
    for plan_name in ("min_cost", "baseline"):
        t0 = time.perf_counter()
        plans[plan_name] = plan_video_workflow(plan_name)
        plan_s = time.perf_counter() - t0
        dag, plan, _ = plans[plan_name]
        emit({"phase": "executor_plan", "plan": plan_name, "planner": "repro_torch.core",
              "plan_s": plan_s, "rows": plan_rows(dag, plan)})
    t0 = time.perf_counter()
    result = Murakkab.paper_cluster().execute(make_declarative_job(MIN_COST))
    simulate_s = time.perf_counter() - t0
    emit({"phase": "executor_plan_model", "plan": "min_cost",
          "what": "the planner's simulated run on its model of the paper "
                  "cluster, not a card measurement",
          "makespan_s": result.makespan_s, "energy_wh": result.energy_wh,
          "usd": result.usd, "quality": result.quality, "plan_and_simulate_s": simulate_s})
    archs = ("seamless-m4t-large-v2", "deepseek-7b")
    sessions = functools.cache(seeded_sessions(0, reduced=False, device="cuda"))
    init_s = {arch: _sync_s(lambda: sessions(arch))[1] for arch in archs}
    media = [Media.synthesize("cats.mov", scenes=VIDEO_SCENES, fps=VIDEO_FPS,
                              seed=0, device="cuda")]
    per_run = {k: sum(generate_launches(get_config(a), 8).get(k, 0) for a in archs)
               for k in launch_counters()}
    torch.cuda.reset_peak_memory_stats()
    runs, failures = {}, []
    for label, plan_name in (("min_cost", "min_cost"),
                             ("min_cost_again", "min_cost"),
                             ("baseline", "baseline")):
        dag, plan, library = plans[plan_name]
        ex = RealExecutor(library, sessions, seed=0, device="cuda")
        reset_launches()
        out, wall_s = _sync_s(lambda: ex.run(dag, plan, media))
        launches = read_launches()
        by_agent = {dag.nodes[t].agent: out[t] for t in dag.topo_order}
        runs[label] = (by_agent, launches)
        shapes = {a: list(v.shape) for a, v in by_agent.items()}
        scenes = VIDEO_SCENES * len(media)
        if not (shapes["frame_extract"][0] == scenes
                and shapes["speech_to_text"] == [scenes, 8]
                and shapes["object_detect"][0] == scenes
                and shapes["summarize"] == [scenes, 8]
                and shapes["embed"][0] == scenes):
            failures.append(f"{label}: output shapes {shapes}")
        vocab = {a: get_config(a).vocab_size for a in archs}
        for agent, arch in (("speech_to_text", archs[0]), ("summarize", archs[1])):
            ids = by_agent[agent]
            if bool(((ids < 0) | (ids >= vocab[arch])).any()):
                failures.append(f"{label}: {agent} ids out of range")
        if not bool(torch.isfinite(by_agent["embed"].float()).all()):
            failures.append(f"{label}: embed vectors not finite")
        if any(launches[k] != per_run[k] for k in per_run):
            failures.append(f"{label}: launches {launches}, expected {per_run}")
        emit({"phase": "executor", "run": label, "plan": plan_name,
              "wall_s": wall_s, "task_s": out["_timings"], "shapes": shapes,
              **{f"{k}_launches": launches[k] for k in per_run},
              "expected_launches": per_run})
    answer = ex.qa(None, VIDEO_QUESTION, None)
    torch.cuda.synchronize()
    # the kernel at this path's shapes: every call of a plain run, replayed
    calls = []
    dag, plan, library = plans["min_cost"]
    ex = RealExecutor(library, sessions, seed=0, device="cuda")
    reset_launches()
    with mock.patch.object(ops, "flash_attention", recording_attention(calls)):
        ex.run(dag, plan, media)
        ex.qa(None, VIDEO_QUESTION, None)
    if read_launches()["flash_attention"]:
        raise AssertionError("the plain executor run launched a kernel")
    calls_line, calls_ok, calls_power = call_check(calls)
    del calls
    if not calls_power:
        failures.append("the limits on the replayed calls miss the fault")
    first, again = runs["min_cost"][0], runs["min_cost_again"][0]
    bitwise = {a: torch.equal(first[a], again[a]) for a in first}
    same_summary = torch.equal(first["summarize"], runs["baseline"][0]["summarize"])
    emit({"phase": "executor_checks", "session_init_s": init_s,
          "bitwise_equal_across_runs": bitwise,
          "summaries_equal_across_plans": same_summary,
          "qa_shape": list(answer.shape), "calls": calls_line,
          "transcript": first["speech_to_text"].tolist(),
          "summary": first["summarize"].tolist(),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "ok": not failures and all(bitwise.values()) and same_summary
          and tuple(answer.shape) == (1, 8) and calls_ok})
    if failures or not all(bitwise.values()) or not same_summary \
            or tuple(answer.shape) != (1, 8) or not calls_ok:
        raise AssertionError(f"executor checks failed: {failures}, bitwise "
                             f"{bitwise}, summaries equal {same_summary}, "
                             f"qa {tuple(answer.shape)}, kernel within the "
                             f"replayed calls' limits {calls_ok}")
    return runs["min_cost"][1]


def scale_routed_experts(model, params) -> None:
    """Draw the routed experts at one expert's fan-in, in place.

    The reference's init (kept by the port) counts the experts axis in the
    fan-in, so each routed expert matrix is drawn sqrt(E) times narrower than
    a dense one: with E = 64 a routed expert's output is 1/512 of a shared
    expert's, and no check of the logits could see the routed experts at
    all. Multiplying by sqrt(E) (8, exact in bf16) draws each at the fan-in
    of a dense FFN of its width. Other architectures are left as drawn."""
    import torch
    if model.cfg.family != "moe":
        return
    scale = math.sqrt(model.cfg.moe.num_experts)
    with torch.no_grad():
        for group in params["groups"].values():
            for block in group.values():
                if "moe" in block:
                    for name in ("w_gate", "w_up", "w_down"):
                        block["moe"][name].mul_(scale)


def plain_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                    scale=None, q_offset=0, kv_len=None):
    from repro_torch.kernels.flash_attention import flash_attention_plain
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=logit_softcap, scale=scale,
                                 q_offset=q_offset, kv_valid=kv_len)


def naive_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                    scale=None, q_offset=0, kv_len=None):
    """The naive oracle, one batch row at a time (which bounds the scores:
    4 x 64 heads x 2048 x 4096 in fp32 would be 8.6 GB)."""
    import torch
    from repro_torch.kernels import ref
    return torch.cat([ref.mha_naive(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                    causal=causal, window=window,
                                    logit_softcap=logit_softcap, scale=scale,
                                    q_offset=q_offset, kv_len=kv_len)
                      for b in range(q.shape[0])])


def p_bf16_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                     scale=None, q_offset=0, kv_len=None):
    """Full scores in fp32 (tanh-softcapped after the scale), the row sum of
    fp32 P, PV from bf16 P; causal (query i sees keys <= i) or not, and a
    sliding window, with no offset or length mask."""
    import torch
    from repro_torch.kernels import ref
    if q_offset or kv_len:
        raise NotImplementedError("no offset or length mask")
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril()
    if window:
        keep = keep.triu(1 - window)
    out = torch.empty_like(q)
    for b in range(B):      # one batch row at a time bounds the scores
        qb = q[b].float().reshape(Sq, KVH, H // KVH, D)
        s = torch.einsum("qhgd,khd->hgqk", qb, k[b].float()) * scale
        if logit_softcap:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        s = s.masked_fill(~keep, ref.NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("hgqk,khd->qhgd", p.to(v.dtype).float(), v[b].float())
        out[b] = (o / p.sum(-1).permute(2, 0, 1)[..., None]).reshape(Sq, H, D)
    return out


def dropped_tile_attention(q, k, v, **kw):
    """The plain attention with the last K/V tile dropped: KV_TILE keys, or
    the later half of the keys of a call shorter than two such tiles."""
    drop = min(KV_TILE, k.shape[1] // 2)
    return plain_attention(q, k, v, **{**kw, "kv_len": k.shape[1] - drop})


def recording_attention(calls):
    """The plain attention, keeping every call (q, k, v, options, output)
    in ``calls``."""
    def attention(q, k, v, **kw):
        out = plain_attention(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out
    return attention


def call_shape(q, k, kw) -> str:
    B, Sq, H, D = q.shape
    mask = "causal" if kw.get("causal", True) else "non-causal"
    if kw.get("window"):
        mask += f" window={kw['window']}"
    return f"B={B} Sq={Sq} Sk={k.shape[1]} H={H} KVH={k.shape[2]} D={D} {mask}"


def call_check(calls):
    """Every recorded attention call (q, k, v, options, the plain output) of
    a model run, replayed on its own inputs: the kernel, the two
    rounding-only variants of phase 4's floor (the naive oracle, P rounded
    to bf16) and the last-K/V-tile fault, each against the plain output.
    The calls are held by shape: per shape the limits are FLOOR_MULT x the
    largest rounding-only difference, max-abs and worst row (relative
    2-norm over D), over its calls. A shape fails when the kernel exceeds
    either limit, so the fault must exceed one of them at every shape with
    two keys or more to show the check would catch it: over a long causal
    sequence the max-abs limit is set by the early rows' large outputs,
    and a dropped last tile moves only the late rows' small ones, which the
    worst-row limit sees. Over one key the output is that key's value, the
    floor is 0 and the kernel is held to it exactly. Returns (line, the
    kernel within the limits at every shape, the fault beyond them at every
    shape it applies to)."""
    import torch
    from repro_torch.kernels import ops
    shapes = {}
    with torch.inference_mode():
        for q, k, v, kw, want in calls:
            outs = {"kernel": [ops.flash_attention(q, k, v, **kw)],
                    "floor": [naive_attention(q, k, v, **kw),
                              p_bf16_attention(q, k, v, **kw)]}
            if k.shape[1] >= 2:
                outs["fault"] = [dropped_tile_attention(q, k, v, **kw)]
            worst = shapes.setdefault(call_shape(q, k, kw), {"calls": 0})
            worst["calls"] += 1
            for name, got in outs.items():
                for g in got:
                    err = (g.float() - want.float()).abs().max().item()
                    row = rel_errors(g, want)[0]
                    a, r = worst.get(name, (0.0, 0.0))
                    worst[name] = (max(a, err), max(r, row))
    line, ok, power = {}, True, True
    for shape, worst in shapes.items():
        tol = [FLOOR_MULT * f for f in worst["floor"]]
        shape_ok = all(a <= t for a, t in zip(worst["kernel"], tol))
        shape_power = any(a > t for a, t in zip(worst["fault"], tol)) \
            if "fault" in worst else None
        ok = ok and shape_ok
        power = power and shape_power is not False
        line[shape] = {
            "calls": worst["calls"],
            **{f"{name}_max_abs": worst[name][0]
               for name in ("kernel", "floor", "fault") if name in worst},
            **{f"{name}_row_rel": worst[name][1]
               for name in ("kernel", "floor", "fault") if name in worst},
            "tol_max_abs": tol[0], "tol_row_rel": tol[1],
            "ok": shape_ok, "fault_exceeds": shape_power}
    return {"floor_mult": FLOOR_MULT, "calls": len(calls), "shapes": line}, \
        ok, power


def plain_ssd(x, dt, a_log, b, c, d_skip, *, chunk=128):
    """The plain SSD on x, b and c cast to fp32 once: the same y (rounded
    once to x's dtype) and state as the plain version on the bf16 inputs,
    and under autograd each input's gradient rounded once, as the backward
    kernel rounds it. (The plain version casts x per use and b and c after
    repeating them per head, so autograd rounds each use's gradient to bf16
    and sums a group's heads, 56 at zamba2-7b, in bf16.)"""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    y, state = ssd_scan_plain(x.float(), dt, a_log, b.float(), c.float(),
                              d_skip, chunk=chunk)
    return y.to(x.dtype), state


def half_chunk_ssd(x, dt, a_log, b, c, d_skip, *, chunk=128):
    """The plain SSD in chunks of half the size: the same sums, in another
    order."""
    return plain_ssd(x, dt, a_log, b, c, d_skip, chunk=chunk // 2)


def split_ssd(x, dt, a_log, b, c, d_skip, *, chunk=128):
    """The plain SSD whose y and state are those of the wgmma variant's
    decomposition at its precision (fp32 operands as bf16 hi + lo), with the
    plain SSD's gradient: the forward's rounding alone."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_decomposed_plain
    y, state = plain_ssd(x, dt, a_log, b, c, d_skip, chunk=chunk)
    with torch.no_grad():
        y_s, state_s = ssd_decomposed_plain(x, dt, a_log, b, c, d_skip,
                                            chunk=chunk, split=True)
    return y + (y_s - y).detach(), state + (state_s - state).detach()


def checking_ssd(records):
    """The plain SSD, whose backward also replays the call's backward
    through the kernel on the call's own inputs and output gradient: per
    call, into ``records``, the kernel's errors against autograd through the
    plain version in fp32 (``ssd_bwd_errors``) and each ``ssd_bwd_faults``
    fault's. Under remat the hook fires on the recomputed forward's output,
    once per layer."""
    import torch
    from repro_torch.kernels import ssd_scan as ss

    def ssd(x, dt, a_log, b, c, d_skip, *, chunk=128):
        y, state = plain_ssd(x, dt, a_log, b, c, d_skip, chunk=chunk)
        if y.requires_grad:
            args = tuple(t.detach() for t in (x, dt, a_log, b, c, d_skip))

            def check(dy):
                dy = dy.contiguous()
                want = ssd_grads_plain(args, dy, None, chunk)
                with torch.no_grad():
                    got = ss.ssd_scan_bwd_cuda(*args, dy, chunk=chunk)
                    rec = {"kernel": ssd_bwd_errors(got, want)}
                    for fault, grads in ssd_bwd_faults(args, dy, None, chunk).items():
                        rec[fault] = ssd_bwd_errors(grads, want)
                records.append(rec)

            y.register_hook(check)
        return y, state

    return ssd


def dropped_tile_ssd(x, dt, a_log, b, c, d_skip, *, chunk=128):
    """The plain SSD with one 64-step tile of the last chunk dropped."""
    b = b.clone()
    start = b.shape[1] - chunk
    b[:, start:start + SSD_TILE] = 0
    return plain_ssd(x, dt, a_log, b, c, d_skip, chunk=chunk)


def plain_gmm(x, w):
    from repro_torch.kernels.moe_gmm import gmm_plain
    return gmm_plain(x, w)


def split_d_gmm(x, w):
    """The plain grouped matmul as two fp32 half-depth products summed: the
    same sums, in another order."""
    import torch
    h = x.shape[2] // 2
    xf, wf = x.float(), w.float()
    return (torch.bmm(xf[..., :h], wf[:, :h])
            + torch.bmm(xf[..., h:], wf[:, h:])).to(x.dtype)


def dropped_step_gmm(x, w):
    """The plain grouped matmul with the last GMM_STEP-deep step of d dropped."""
    d = x.shape[2]
    return plain_gmm(x[..., :d - GMM_STEP].contiguous(),
                     w[:, :d - GMM_STEP].contiguous())


class RoutingReplay:
    """Each MoE layer's top-k expert ids, recorded in one run and given back
    in the same order in later runs.

    Recording, ``route`` is ``moe._route``. Replaying, it returns the
    recorded ids with each token's weights taken from this run's router
    probabilities at those ids and normalised as ``_route`` does, and the
    aux loss of those ids and probabilities as ``_route`` computes it
    (serving discards it; training differentiates it). Under remat a
    layer routes twice a step (its forward and its recompute), in the same
    order in every run."""

    def __init__(self):
        from repro_torch.models import moe
        self._moe, self._route = moe, moe._route
        self.ids, self.next = [], None

    @contextlib.contextmanager
    def patch(self):
        if self.ids:
            self.next = 0
        with mock.patch.object(self._moe, "_route", self.route):
            yield
        if self.next is not None and self.next != len(self.ids):
            raise AssertionError(f"replayed {self.next} of {len(self.ids)} "
                                 "routings")

    def route(self, x2d, router_w, cfg):
        import torch
        if self.next is None:
            idx, w, aux = self._route(x2d, router_w, cfg)
            self.ids.append(idx)
            return idx, w, aux
        idx = self.ids[self.next]
        self.next += 1
        probs = torch.softmax(x2d.float() @ router_w, dim=-1)
        p = probs.gather(1, idx)
        w = p / p.sum(-1, keepdim=True).clamp_min(1e-9)
        E, n = cfg.moe.num_experts, idx.numel()
        f_e = torch.zeros(E, device=x2d.device).scatter_add_(
            0, idx.reshape(-1), torch.full((n,), 1.0 / n, device=x2d.device))
        aux = E * torch.sum(f_e * probs.mean(0)) * cfg.moe.router_aux_coef
        return idx, w.to(x2d.dtype), aux

    def count(self) -> int:
        """(layer, token) routings recorded."""
        return sum(idx.shape[0] for idx in self.ids)

    def differing(self, other) -> int:
        """(layer, token) routings whose expert sets differ from ``other``'s."""
        return sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                   for a, b in zip(self.ids, other.ids))


def phase_agree(model, params, prompts, extras, *, decode_steps=0,
                replay_calls=False):
    """Full-width prefill logits, at every prompt position, through the
    kernels vs their plain versions; with ``decode_steps``, also the decode
    logits of that many steps from each prefill's cache; for the
    encoder-decoder, also the encoder's final states at every frame.

    Each layer rounds activations to bf16, and random weights pass any
    rounding difference on from layer to layer, so no fixed tolerance fits.
    The limit is FLOOR_MULT times a noise floor measured in this run against
    the same plain prefill: the largest difference among runs that differ
    from it only in rounding: the naive attention oracle (fp32 summation
    order), a plain attention that rounds P to bf16 before the PV product as
    the flash kernel does, with SSM layers the plain SSD in half-size
    chunks, and with MoE layers the plain grouped matmul summed in two halves
    of d. A prefill whose kernel drops a tile in every layer (the last K/V
    tile of attention; with SSM layers instead one 64-step tile of the SSD's
    last chunk; with MoE layers instead the last 32-deep step of every expert
    product) must exceed the max-abs limit, or the check could not see such
    a fault. The whole-tensor norm bounds faults that move every
    position; a fault in 64 of 2048 positions stays below the network's own
    noise in it. Decode steps are held to limits from the same floor runs,
    and a decode from a cache whose prefill state (SSM states,
    cross-attention K/V) was dropped after the prefill (no handoff) must
    exceed the decode max-abs limit.

    The encoder-decoder is held in two stages. The encoder's final states
    (every frame) are held to their own floor. The decoder (logits, decode
    steps) is held with every run attending to the plain run's encoder
    states, so that the encoder's rounding noise does not enter the
    decoder's floor. At random weights neither stage can see a one-tile
    fault: attention over 1 500 near-uniformly weighted frames changes
    little when 64 are dropped, and 24 bf16 layers carry any difference, a
    rounding one too, to about the same size. So the check that must catch
    a fault in the kernel there is ``call_check``: every attention call of
    the plain run (the encoder's self-attention, the decoder's, and the
    cross-attention of the prefill and the decode steps), replayed on its
    own inputs and held per shape. With ``replay_calls`` the same holds for
    any path: its calls are replayed, and they, not the logits, must show the
    power to see a one-tile fault (the logits' fault is reported beside).

    The dropped handoff zeroes the SSM states (SSM and hybrid families),
    the encoder's K/V (the encoder-decoder), and elsewhere the whole cache:
    the VLM's cross K/V over near-uniformly weighted random patches alone
    moves its decode logits less than the rounding floor does.

    With MoE layers the routers' top-k choices of the plain run are replayed
    in every other run (``RoutingReplay``): a rounding difference that flips
    a near-tie sends a token to another expert, and over 27 layers such
    flips move the logits by about a fifth in norm, in the rounding-only
    runs as in the kernel run, more than a fault within a kernel does. The
    kernel run with free routing is reported beside it, with the number of
    (layer, token) routings that differ.
    """
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.runtime.serve import cross_len

    cfg = model.cfg
    has_ssm = expected_launches(cfg)["ssd_scan"] > 0
    has_moe = expected_launches(cfg)["gmm"] > 0
    encdec = cfg.family == "encdec"
    enc_len = cross_len(extras)
    # the cache leaves a dropped handoff zeroes: the SSM states, the
    # encoder's K/V; for the other families the whole cache
    handoff = {"encdec": ("ck", "cv"), "hybrid": ("ssm", "conv"),
               "ssm": ("ssm", "conv")}.get(cfg.family)
    counters = launch_counters()
    B, S = prompts.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    dec_tokens = torch.randint(0, cfg.vocab_size, (B, decode_steps),
                               generator=gen, device="cuda")
    enc_states = {}
    encode_fn = transformer.encode

    def run(attention=None, ssd=None, gmm=None, drop_handoff=False,
            routing=None, states=None):
        """fp32 logits of one prefill (B, S, vocab) and of the decode steps
        after it (B, decode_steps, vocab), through the session's path; with
        ``routing``, the MoE layers route through it. The encoder's states
        of the prefill are left in ``enc_states["last"]``; with ``states``,
        the decoder attends to those instead."""
        def encode(*args, **kw):
            enc_states["last"] = out = encode_fn(*args, **kw)
            return out if states is None else states

        cache = model.init_cache(B, S + decode_steps, enc_len=enc_len,
                                 device="cuda")
        with torch.inference_mode(), \
                mock.patch.object(ops, "flash_attention",
                                  attention or ops.flash_attention), \
                mock.patch.object(ops, "ssd_scan", ssd or ops.ssd_scan), \
                mock.patch.object(ops, "gmm", gmm or ops.gmm), \
                mock.patch.object(transformer, "encode", encode), \
                (routing.patch() if routing else contextlib.nullcontext()):
            logits = model.apply(params, {"tokens": prompts, **extras},
                                 mode="prefill", cache=cache, cache_index=0)[0]
            if drop_handoff:      # what the prefill hands to decode, zeroed
                for blocks in cache["groups"].values():
                    for bc in blocks.values():
                        for name in bc:
                            if handoff is None or name in handoff:
                                bc[name].zero_()
            dec = [model.apply(params, {"tokens": dec_tokens[:, i:i + 1]},
                               mode="decode", cache=cache,
                               cache_index=S + i)[0][:, -1]
                   for i in range(decode_steps)]
        return logits, torch.stack(dec, 1) if dec else None

    def diffs(got, want):
        if got is None:
            return 0.0, 0.0
        d = got.float() - want.float()
        return d.abs().max().item(), (d.norm() / want.float().norm()).item()

    replay = RoutingReplay() if has_moe else None
    calls = []      # the plain run's attention calls, for call_check
    with_plain, dec_plain = run(
        recording_attention(calls) if replay_calls else plain_attention,
        plain_ssd,
        plain_gmm, routing=replay)    # records the routing
    enc_plain = enc_states.pop("last", None)
    with_kernel, dec_kernel = run(routing=replay, states=enc_plain)
    enc_kernel = enc_states.pop("last", None)
    line = {"phase": "agree", "arch": cfg.name, "positions": B * S}
    if has_moe:
        free = RoutingReplay()
        got, _ = run(routing=free)
        f_abs, f_rel = diffs(got, with_plain)
        line["routing"] = "replayed from the plain run"
        line["free_routing"] = {"max_abs": f_abs, "norm_rel": f_rel,
                                "rerouted": free.differing(replay),
                                "routings": free.count()}
        del got
    before = {name: fn.launches for name, fn in counters.items()}
    floors = {"floor_fp32_order": (naive_attention, plain_ssd, plain_gmm),
              "floor_p_bf16": (p_bf16_attention, plain_ssd, plain_gmm)}
    if has_ssm:
        floors["floor_ssd_half_chunk"] = (plain_attention, half_chunk_ssd,
                                          plain_gmm)
    if has_moe:
        floors["floor_gmm_split_d"] = (plain_attention, plain_ssd, split_d_gmm)
    # prefill abs, rel; decode abs, rel; encoder states abs, rel
    floor = [0.0] * 6
    for name, (attention, ssd, gmm) in floors.items():
        got, dec = run(attention, ssd, gmm, routing=replay, states=enc_plain)
        p_abs, p_rel = diffs(got, with_plain)
        d_abs, d_rel = diffs(dec, dec_plain)
        e_abs, e_rel = diffs(enc_states.pop("last", None), enc_plain)
        floor = [max(a, b) for a, b in zip(
            floor, (p_abs, p_rel, d_abs, d_rel, e_abs, e_rel))]
        line[name] = {"max_abs": p_abs, "norm_rel": p_rel}
        if decode_steps:
            line[name].update(decode_max_abs=d_abs, decode_norm_rel=d_rel)
        if encdec:
            line[name].update(encoder_max_abs=e_abs, encoder_norm_rel=e_rel)
        del got, dec
    fault = got = None      # the encoder-decoder's: in call_check
    if has_ssm:
        fault = "fault_ssd_tile_dropped"
        got, _ = run(plain_attention, dropped_tile_ssd, plain_gmm)
    elif has_moe:
        fault = "fault_gmm_d_step_dropped"
        got, _ = run(plain_attention, plain_ssd, dropped_step_gmm,
                     routing=replay)
    elif not encdec:
        fault = "fault_last_tile_dropped"
        got, _ = run(dropped_tile_attention, plain_ssd, plain_gmm)
    fault_abs, fault_rel = diffs(got, with_plain)
    del got
    handoff_abs = handoff_rel = 0.0
    if decode_steps:
        _, dec = run(plain_attention, plain_ssd, plain_gmm, drop_handoff=True,
                     states=enc_plain)
        handoff_abs, handoff_rel = diffs(dec, dec_plain)
        del dec
    if any(fn.launches != before[name] for name, fn in counters.items()):
        raise AssertionError("a plain run launched a kernel")
    calls_ok = calls_power = True
    if replay_calls:
        line["calls"], calls_ok, calls_power = call_check(calls)
    del calls

    diff_abs, diff_rel = diffs(with_kernel, with_plain)
    tol_abs, tol_rel = FLOOR_MULT * floor[0], FLOOR_MULT * floor[1]
    top2 = with_plain.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > tol_abs
    same = with_kernel.argmax(-1) == with_plain.argmax(-1)
    n_decided, n_same = int(decided.sum()), int(same[decided].sum())
    ok = bool(torch.isfinite(with_kernel).all()) and diff_abs <= tol_abs \
        and diff_rel <= tol_rel and n_same == n_decided
    # the encoder-decoder's logits cannot see a one-tile fault (see above):
    # there, and wherever calls are replayed, the replayed calls must
    power = calls_power if replay_calls else fault_abs > tol_abs
    ok = ok and calls_ok
    if fault:
        line[fault] = {"max_abs": fault_abs, "norm_rel": fault_rel,
                       "exceeds_limit": fault_abs > tol_abs}
    line.update({
        "max_abs_logit_diff": diff_abs, "norm_rel_logit_diff": diff_rel,
        "floor_mult": FLOOR_MULT, "tol_abs": tol_abs, "tol_rel": tol_rel,
        "logit_absmax": with_plain.abs().max().item(),
        "argmax_decided": n_decided, "argmax_equal_where_decided": n_same,
        "argmax_equal_all": int(same.sum())})
    if encdec:
        etol_abs, etol_rel = FLOOR_MULT * floor[4], FLOOR_MULT * floor[5]
        enc_abs, enc_rel = diffs(enc_kernel, enc_plain)
        ok = ok and bool(torch.isfinite(enc_kernel).all()) \
            and enc_abs <= etol_abs and enc_rel <= etol_rel
        line.update({
            "encoder_positions": enc_plain.shape[0] * enc_plain.shape[1],
            "encoder_max_abs_diff": enc_abs, "encoder_norm_rel_diff": enc_rel,
            "encoder_tol_abs": etol_abs, "encoder_tol_rel": etol_rel})
    if decode_steps:
        dtol_abs, dtol_rel = FLOOR_MULT * floor[2], FLOOR_MULT * floor[3]
        dec_abs, dec_rel = diffs(dec_kernel, dec_plain)
        ok = ok and bool(torch.isfinite(dec_kernel).all()) \
            and dec_abs <= dtol_abs and dec_rel <= dtol_rel
        power = power and handoff_abs > dtol_abs
        line.update({
            "decode_steps": decode_steps, "decode_max_abs_diff": dec_abs,
            "decode_norm_rel_diff": dec_rel, "decode_tol_abs": dtol_abs,
            "decode_tol_rel": dtol_rel,
            "fault_handoff_dropped": {"decode_max_abs": handoff_abs,
                                      "decode_norm_rel": handoff_rel}})
    emit({**line, "ok": ok, "power": power})
    if not ok:
        raise AssertionError(f"{cfg.name}: full-width logits disagree "
                             "between the kernels and their plain versions")
    if not power:
        raise AssertionError(f"{cfg.name}: the logit limits do not catch "
                             "an injected fault")


TRACE_DECODE_STEPS = 8


def _self_device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def agree_inputs(arch, prompts, extras):
    """The agreement phase's (prompts, extras): the serve phase's, or
    AGREE_PROMPTS' seeded random tokens (with the serve phase's extras cut
    to their batch)."""
    import torch
    if arch not in AGREE_PROMPTS:
        return prompts, extras
    B, S = AGREE_PROMPTS[arch]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    vocab = path_config(arch).vocab_size
    return (torch.randint(0, vocab, (B, S), generator=gen, device="cuda"),
            {name: t[:B] for name, t in extras.items()})


def phase_trace(model, params, prompts, extras):
    # one full-width prefill and TRACE_DECODE_STEPS decode steps of one arch
    """Where the time goes: torch.profiler over one full-width prefill and
    TRACE_DECODE_STEPS decode steps after it, off the main path's count.

    Per window: host wall time per step (profiler on, so it overstates the
    host side), device busy time per step (kernel time summed; one stream),
    the idle share, and the kernels that take the most device time.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve import (ServeOptions, build_decode_step,
                                           build_prefill_step, cross_len)

    prefill = build_prefill_step(model, ServeOptions())
    decode = build_decode_step(model, ServeOptions())
    B, S = prompts.shape
    cache = model.init_cache(B, S + TRACE_DECODE_STEPS + 1,
                             enc_len=cross_len(extras), device="cuda")
    state = {}

    def run_prefill():
        state["tok"] = prefill(params, {"tokens": prompts, **extras},
                               cache)[0].argmax(-1)[:, None]

    def run_decode():
        tok = state["tok"]
        for i in range(TRACE_DECODE_STEPS):
            tok, _, _ = decode(params, cache, tok, S + i)

    with torch.inference_mode():
        run_prefill()
        run_decode()                    # warm-up of both windows
        for name, fn, steps in (("prefill", run_prefill, 1),
                                ("decode", run_decode, TRACE_DECODE_STEPS)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / steps
            kernels = [(e.key, _self_device_us(e) / 1e3 / steps, e.count // steps)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            busy_ms = sum(ms for _, ms, _ in kernels)
            top = sorted(kernels, key=lambda k: -k[1])[:10]
            emit({"phase": "trace", "arch": model.cfg.name,
                  "window": name, "steps": steps,
                  "wall_ms_per_step": wall_ms,
                  "device_busy_ms_per_step": busy_ms if busy_ms else "not measured",
                  "idle_share": 1 - busy_ms / wall_ms if busy_ms else "not measured",
                  "kernel_launches_per_step": sum(n for _, _, n in kernels),
                  "top_kernels": [{"name": k[:80], "ms_per_step": ms, "calls": n}
                                  for k, ms, n in top]})


def train_config(arch):
    """A training path's configuration: full width, its depth cut to
    TRAIN_DEPTH_CUTS where it has one."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    return cfg.replace(n_layers=TRAIN_DEPTH_CUTS[arch]) \
        if arch in TRAIN_DEPTH_CUTS else cfg


def expected_train_launches(cfg, steps: int) -> dict:
    """Kernel launches (backward calls) of ``steps`` train steps with remat
    "full": every forward launch twice (the forward and its recompute in the
    backward), one backward call per forward call."""
    fwd = expected_launches(cfg)
    return {"flash_attention": 2 * steps * fwd["flash_attention"],
            "flash_attention_bwd": steps * fwd["flash_attention"],
            "gmm": 2 * steps * fwd["gmm"], "gmm_bwd": steps * fwd["gmm"],
            "ssd_scan": 2 * steps * fwd["ssd_scan"],
            "ssd_scan_bwd": steps * fwd["ssd_scan"]}


def train_model_flops(model, B, S) -> float:
    """Model FLOPs of one train step (forward and backward, no recompute):
    6 x the parameters a token multiplies (``active_param_count``: routed
    experts at top_k / E; the embedding lookup excluded) x tokens, plus 3 x
    the forward's attention products (``attention_cost``, a layer) and 3 x
    the forward's SSD products (``ssd_cost``, an SSM layer)."""
    from repro_torch.kernels.flash_attention import attention_cost
    from repro_torch.kernels.ssd_scan import ssd_cost
    from repro_torch.models.ssm import ssm_dims
    cfg = model.cfg
    n = model.active_param_count() - math.prod(model.specs["embed"].shape)
    layers = expected_launches(cfg)
    attn = 3 * layers["flash_attention"] * attention_cost(
        B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)[0]
    ssd = 0
    if layers["ssd_scan"]:
        s = cfg.ssm
        ssd = 3 * layers["ssd_scan"] * ssd_cost(
            B, S, ssm_dims(cfg)[2], s.head_dim, s.d_state, s.n_groups,
            min(s.chunk_size, S))[0]
    return 6 * n * B * S + attn + ssd


def train_options() -> dict:
    """The training paths' ``TrainOptions`` (remat full, bf16 moments)."""
    from repro_torch.optim import adamw
    return dict(remat_policy="full", warmup_steps=TRAIN_WARMUP,
                total_steps=TRAIN_STEPS,
                opt=adamw.AdamWConfig(lr=TRAIN_LR, moment_dtype="bfloat16"))


def dryrun_child(out: str) -> int:
    """The dry-run of DRYRUN_PATHS on meta tensors (the local path, this
    script's shapes and depths), its records written to ``out``. Runs in a
    child process on the host: it touches no card."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    records = {}
    for name, (arch, kind) in DRYRUN_PATHS.items():
        if kind == "train":
            trace = dryrun.lower_cell(
                train_config(arch), ShapeCell(name, TRAIN_SEQ, TRAIN_BATCH, kind),
                opts_over=train_options())
        else:
            trace = dryrun.lower_cell(
                path_config(arch), ShapeCell(name, PROMPT_LEN, SERVE_BATCH, kind))
        records[name] = dryrun.record(trace)
    Path(out).write_text(json.dumps(records))
    return 0


def start_dryrun() -> None:
    """Start ``dryrun_child`` in a child process (the card hidden from it,
    one thread, at the lowest CPU priority: the phases on the card come
    first), writing into a temporary directory; ``dryrun_record`` collects
    it and ``stop_dryrun`` ends it."""
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log = open(tmp / "dryrun.log", "w")
    DRYRUN.update(tmp=tmp, out=tmp / "dryrun.json", log=log,
                  t0=time.perf_counter(),
                  proc=subprocess.Popen(
                      [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun",
                       str(tmp / "dryrun.json")],
                      cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                      preexec_fn=lambda: os.nice(19)))


def stop_dryrun() -> None:
    import shutil
    proc = DRYRUN.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    if "log" in DRYRUN:
        DRYRUN["log"].close()
        shutil.rmtree(DRYRUN["tmp"], ignore_errors=True)


def dryrun_record(name: str) -> dict:
    """The dry-run's record of path ``name``, waiting for the child."""
    if "records" not in DRYRUN:
        proc = DRYRUN["proc"]
        code = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        DRYRUN["log"].flush()
        if code:
            tail = Path(DRYRUN["log"].name).read_text()[-3000:]
            raise AssertionError(f"the dry-run child exited {code}: {tail}")
        DRYRUN["records"] = json.loads(DRYRUN["out"].read_text())
        emit({"phase": "dryrun", "child_s": time.perf_counter() - DRYRUN["t0"],
              "trace_s": {n: r["lower_s"] for n, r in DRYRUN["records"].items()}})
    return DRYRUN["records"][name]


def profiled_launches(prof) -> dict:
    """Calls of each kernel wrapper in a torch.profiler run, from the
    launches of the one kernel each call runs once (PROFILED_KERNELS)."""
    from torch.autograd import DeviceType
    out = dict.fromkeys(PROFILED_KERNELS, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name, kernel in PROFILED_KERNELS.items():
                if kernel in e.key:
                    out[name] += e.count
    return {k: n for k, n in out.items() if n}


def check_dryrun(path: str, prof, peak: int, model_flops=None) -> None:
    """Hold the dry-run's record of ``path`` against one traced run on the
    card: (a) its kernel calls equal to the profiler's launches and the
    wrappers' counts, (b) its peak live bytes within DRYRUN_PEAK_RTOL of
    ``max_memory_allocated`` (``peak``), (c) its FLOPs over ``model_flops``
    (printed only)."""
    rec = dryrun_record(path)
    predicted = rec["kernel_calls"]
    counted = {k: v for k, v in read_launches().items()
               if k in launch_counters() and v}
    missing = set(predicted) - set(PROFILED_KERNELS)
    profiled = profiled_launches(prof)
    calls_ok = not missing and predicted == profiled == counted
    ratio = rec["peak_bytes_per_device"] / peak
    peak_ok = abs(ratio - 1) <= DRYRUN_PEAK_RTOL
    emit({"phase": "dryrun_check", "path": path, "card": card_line(),
          "kernel_calls_predicted": predicted, "launches_profiled": profiled,
          "launches_counted": counted, "calls_equal": calls_ok,
          "peak_predicted": rec["peak_bytes_per_device"],
          "max_memory_allocated": peak, "peak_ratio": ratio,
          "peak_rtol": DRYRUN_PEAK_RTOL, "memory_predicted": rec["memory"],
          "flops_predicted": rec["flops_per_device"],
          "model_flops": model_flops,
          "flops_ratio": rec["flops_per_device"] / model_flops
          if model_flops else None,
          "hbm_bytes_predicted": rec["hbm_bytes_per_device"],
          "trace_s": rec["lower_s"], "ok": calls_ok and peak_ok})
    if not (calls_ok and peak_ok):
        raise AssertionError(
            f"dry-run of {path} against the card: calls {predicted} vs "
            f"profiled {profiled}, counted {counted} (no profiler name for "
            f"{sorted(missing)}); peak {rec['peak_bytes_per_device']} vs "
            f"{peak} (ratio {ratio:.4f}, limit {DRYRUN_PEAK_RTOL})")


def planted_flash_bwd(fault):
    """``flash_attention_bwd_cuda`` with a fault of TRAIN_FAULTS planted in
    what the training path's backward gets: the first or the last K/V
    tile's dK dropped (BWD_KV_TILE keys of every sequence), or Delta left
    at zero (the naive formulas, as phase flash_bwd plants it)."""
    from repro_torch.kernels import flash_attention as fa
    real = fa.flash_attention_bwd_cuda

    def bwd(q, k, v, out, dout, lse, **kw):
        if fault == "delta_zero":
            return attention_grads_naive(
                q, k, v, dout, zero_delta=True,
                **{o: kw[o] for o in ("causal", "window", "softcap", "scale")})
        dq, dk, dv = real(q, k, v, out, dout, lse, **kw)
        keys = slice(0, BWD_KV_TILE) if fault == "first_tile_dk_dropped" \
            else slice(-BWD_KV_TILE, None)
        dk[:, keys] = 0
        return dq, dk, dv

    bwd.launches = 0    # the kernel's wrapper counts on its module's name
    return mock.patch.object(fa, "flash_attention_bwd_cuda", bwd)


def planted_ssd_bwd(fault):
    """``ssd_scan_bwd_cuda`` with a fault of SSD_TRAIN_FAULTS planted: the
    gradients ``ssd_bwd_faults`` gives for it, from the plain backward's
    stages on the same inputs."""
    from repro_torch.kernels import ssd_scan as ss

    def bwd(x, dt, a_log, b, c, d_skip, dy, dstate=None, *, chunk=128):
        return ssd_bwd_faults((x, dt, a_log, b, c, d_skip), dy, dstate, chunk)[fault]

    bwd.launches = 0    # the kernel's wrapper counts on its module's name
    return mock.patch.object(ss, "ssd_scan_bwd_cuda", bwd)


def phase_train(arch):
    """A training path (TRAIN_PATHS) at full width on the card, through
    ``runtime.train``: step 1's loss, the worst leaf's gradient norm and
    each leaf's whole gradient (relative norm of its difference), kernels
    against the plain versions from the same weights and batch, within
    FLOOR_MULT x a noise floor measured in this run (the largest difference
    of runs that differ from the plain one only in rounding: the naive
    attention oracle with the grouped matmul summed in two halves of d, and
    the attention with P in bf16; with SSM layers the plain SSD in half-size
    chunks, and the plain SSD with the wgmma variant's forward rounding
    (``split_ssd``); each leaf's gradient against its own floor), MoE
    routing replayed from the plain run; the faults of TRAIN_FAULTS planted
    in the flash backward (paths with attention) and of SSD_TRAIN_FAULTS in
    the SSD backward (paths with SSM layers), each of those marked required
    on the path shown to fail that gate; with SSM layers, every SSD call of
    the plain run replayed through the backward kernel (``checking_ssd``),
    within the ssd_bwd limits, with each fault of ``ssd_bwd_faults`` past
    them in some call; then TRAIN_STEPS steps of ``build_train_step`` from
    a fresh AdamW state: losses finite, the kernels' launches as
    ``expected_train_launches`` predicts (every gmm and SSD forward launch
    on its wgmma variant, every gmm backward launch on ``wgmma_bwd``, every
    SSD backward launch on ``wgmma``), step
    times, tokens/s, peak memory (below TRAIN_PEAK_BYTES) and model
    TFLOP/s; then one more step under torch.profiler for the idle share.
    Training must make progress: the loss lower at the last step than at
    the first; with SSM layers, whose chaotic step-1 gradient at the
    reference's initialisation gains nothing on fresh batches in so few
    steps (the plain SSD's losses rise alike), TRAIN_STEPS steps on the
    first batch from the same init must lower its loss."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.kernels import ops
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as train_rt

    cfg = train_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(gen)
    scale_routed_experts(model, params)
    opts = train_rt.TrainOptions(**train_options())
    data = DataIterator(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH),
                        model_cfg=cfg, device="cuda")
    first_batch = next(data)
    data.restore({"step": 0})
    fwd_launches = expected_launches(cfg)
    has_moe = fwd_launches["gmm"] > 0
    has_ssm = fwd_launches["ssd_scan"] > 0
    faults_here = {}
    if fwd_launches["flash_attention"]:
        faults_here = TRAIN_FAULTS if not has_ssm else dict.fromkeys(TRAIN_FAULTS, False)
    if has_ssm:
        faults_here = {**faults_here, **SSD_TRAIN_FAULTS}
    grad_fn = train_rt.build_grad_fn(model, opts)

    def run(attention=None, gmm=None, routing=None, ssd=None):
        """Step 1's loss and gradients through the given attention, grouped
        matmul and SSD (the kernels by default)."""
        with mock.patch.object(ops, "flash_attention",
                               attention or ops.flash_attention), \
                mock.patch.object(ops, "gmm", gmm or ops.gmm), \
                mock.patch.object(ops, "ssd_scan", ssd or ops.ssd_scan), \
                (routing.patch() if routing else contextlib.nullcontext()):
            grads, metrics = grad_fn(params, first_batch)
        return float(metrics["loss"]), grads

    replay = RoutingReplay() if has_moe else None
    ssd_calls = []
    plain_loss, plain = run(plain_attention, plain_gmm, replay,
                            checking_ssd(ssd_calls) if has_ssm else plain_ssd)
    plain_norms = {k: g.float().norm().item() for k, g in _flat(plain)}

    def compare(grads):
        """Per leaf: the gradient norm's relative difference from the plain
        run's, and the gradient's own (relative norm of the difference)."""
        out = {}
        for (k, g), (_, p) in zip(_flat(grads), _flat(plain)):
            gn = g.float().norm().item()
            out[k] = (abs(gn - plain_norms[k]) / max(plain_norms[k], 1e-30),
                      ((g.float() - p.float()).norm() /
                       max(plain_norms[k], 1e-30)).item())
        return out

    floor_runs = [("naive_split_d", naive_attention, split_d_gmm, plain_ssd),
                  ("p_bf16", p_bf16_attention, plain_gmm, plain_ssd)]
    if has_ssm:
        floor_runs += [("ssd_half_chunk", plain_attention, plain_gmm, half_chunk_ssd),
                       ("ssd_split", plain_attention, plain_gmm, split_ssd)]
    floors = {}
    for name, attention, gmm, ssd in floor_runs:
        loss, grads = run(attention, gmm, replay, ssd)
        floors[name] = (abs(loss - plain_loss), compare(grads))
        del grads
    loss, grads = run(routing=replay)
    kernel = (abs(loss - plain_loss), compare(grads))
    kernel_loss = loss
    del grads
    planted = {}
    for fault in faults_here:
        with (planted_flash_bwd(fault) if fault in TRAIN_FAULTS
              else planted_ssd_bwd(fault)):
            loss, grads = run(routing=replay)
        planted[fault] = (abs(loss - plain_loss), compare(grads))
        del grads
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    loss_floor = max(f[0] for f in floors.values())
    norm_floor = max(v[0] for f in floors.values() for v in f[1].values())
    leaf_floor = {k: max(f[1][k][1] for f in floors.values()) for k in plain_norms}

    def gate(result):
        """(passes, the worst leaf's whole-gradient difference over
        FLOOR_MULT x its floor, that leaf)."""
        loss_diff, by_leaf = result
        leaf, ratio = max(((k, v[1] / max(FLOOR_MULT * leaf_floor[k], 1e-30))
                           for k, v in by_leaf.items()), key=lambda kv: kv[1])
        ok = loss_diff <= FLOOR_MULT * loss_floor and \
            max(v[0] for v in by_leaf.values()) <= FLOOR_MULT * norm_floor and \
            all(v[1] <= FLOOR_MULT * leaf_floor[k] for k, v in by_leaf.items())
        return ok, ratio, leaf

    worst_norm = max(kernel[1].items(), key=lambda kv: kv[1][0])
    worst_vec = max(kernel[1].items(), key=lambda kv: kv[1][1])
    agree_ok, kernel_ratio, kernel_leaf = gate(kernel)
    faults = {}
    for fault, result in planted.items():
        passes, ratio, leaf = gate(result)
        faults[fault] = {"required": faults_here[fault], "fails_the_gate": not passes,
                         "grad_rel_diff_over_limit": ratio, "leaf": leaf,
                         "grad_rel_diff": result[1][leaf][1],
                         "grad_norm_rel_diff_worst": max(
                             v[0] for v in result[1].values())}
    faults_ok = all(f["fails_the_gate"] for f in faults.values() if f["required"])
    calls_ok = True
    if has_ssm:
        # every SSD call of the plain run, its backward replayed through the
        # kernel: within the ssd_bwd limits, and each fault past them in
        # some call
        kinds = ["kernel", *ssd_calls[0]] if ssd_calls else ["kernel"]
        summary = {k: {g: {m: max(rec[k][g][m] for rec in ssd_calls)
                           for m in ("elem", "norm")} for g in SSD_GRADS}
                   for k in dict.fromkeys(kinds)}
        ok_calls = sum(all(e["ok"] for e in rec["kernel"].values())
                       for rec in ssd_calls)
        seen = {k: sum(any(not e["ok"] for e in rec[k].values()) for rec in ssd_calls)
                for k in summary if k != "kernel"}
        calls_ok = len(ssd_calls) == fwd_launches["ssd_scan"] and \
            ok_calls == len(ssd_calls) and all(seen.values())
        emit({"phase": "train_ssd_calls", "arch": cfg.name, "calls": len(ssd_calls),
              "kernel_within_limits": ok_calls, "faults_seen_in_calls": seen,
              "worst_over_calls": summary, "ok": calls_ok})
    emit({"phase": "train_agree", "arch": cfg.name, "n_layers": cfg.n_layers,
          "routing": "replayed from the plain run" if has_moe else None,
          "plain_loss": plain_loss, "kernel_loss": kernel_loss,
          "loss_diff": kernel[0], "loss_floor": loss_floor,
          "grad_norm_rel_diff_worst": {"leaf": worst_norm[0], "value": worst_norm[1][0]},
          "grad_norm_floor": norm_floor,
          "grad_rel_diff_worst": {"leaf": worst_vec[0], "value": worst_vec[1][1],
                                  "floor": leaf_floor[worst_vec[0]]},
          "grad_rel_diff_over_limit_worst": {"leaf": kernel_leaf,
                                             "value": kernel_ratio},
          "floor_runs": {n: {"loss_diff": f[0],
                             "grad_norm_rel_diff": max(v[0] for v in f[1].values()),
                             "grad_rel_diff": max(v[1] for v in f[1].values())}
                         for n, f in floors.items()},
          "planted_faults": faults,
          "floor_mult": FLOOR_MULT, "ok": agree_ok and faults_ok})

    # the main path: TRAIN_STEPS steps of build_train_step from step 0
    state = {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step_fn = train_rt.build_train_step(model, opts)
    losses, step_s, lrs = [], [], []
    reset_launches()
    for _ in range(TRAIN_STEPS):
        batch = next(data)
        (state, metrics), s = _sync_s(lambda: step_fn(state, batch))
        losses.append(float(metrics["loss"]))
        lrs.append(float(metrics["lr"]))
        step_s.append(s)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    expected = expected_train_launches(cfg, TRAIN_STEPS)
    launches_ok = all(launches[k] == v for k, v in expected.items()) and \
        launches["gmm_by_variant"]["wgmma"] == launches["gmm"] and \
        launches["gmm_bwd_by_variant"]["wgmma_bwd"] == 2 * launches["gmm_bwd"] and \
        launches["ssd_by_variant"]["wgmma"] == launches["ssd_scan"] and \
        launches["ssd_bwd_by_variant"]["wgmma"] == launches["ssd_scan_bwd"]
    finite = all(math.isfinite(x) for x in losses)
    falls = losses[-1] < losses[0]
    # the first step of the main path repeats step 1 of the agreement runs
    repeat = losses[0] == kernel_loss

    # one more step under the profiler, off the main path's count; its
    # launches and peak memory are what the dry-run predicts
    batch = next(data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    if f"train:{arch}" in DRYRUN_PATHS:
        check_dryrun(f"train:{arch}", prof, torch.cuda.max_memory_allocated(),
                     train_model_flops(model, TRAIN_BATCH, TRAIN_SEQ))
    kernels = [(e.key, _self_device_us(e) / 1e3, e.count)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:10]

    # with SSM layers a fresh batch carries no signal those layers' chaotic
    # step-1 gradient can use in TRAIN_STEPS steps (the plain SSD's losses
    # rise alike): training must instead fit one batch, from the same init
    fit = []
    if has_ssm:
        del state, params
        gc.collect()
        torch.cuda.empty_cache()
        gen.manual_seed(0)
        params = model.init(gen)
        state = {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        for _ in range(TRAIN_STEPS):
            state, metrics = step_fn(state, first_batch)
            fit.append(float(metrics["loss"]))
    trained = fit[-1] < fit[0] and all(math.isfinite(x) for x in fit) if fit \
        else falls

    step_med = statistics.median(step_s[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_model_flops(model, TRAIN_BATCH, TRAIN_SEQ)
    cut = {"reduced": {"n_layers": [path_config(arch).n_layers, cfg.n_layers]}} \
        if arch in TRAIN_DEPTH_CUTS else {}
    fits = peak < TRAIN_PEAK_BYTES
    ok = agree_ok and faults_ok and calls_ok and launches_ok and finite and \
        trained and fits
    emit({"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers, **cut,
          "d_model": cfg.d_model, "params": model.param_count(),
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "remat": opts.remat_policy, "moment_dtype": opts.opt.moment_dtype,
          "lr": lrs, "losses": losses, "loss_falls": falls,
          "one_batch_losses": fit or None, "trained": trained,
          "step1_repeats_agree_run_bitwise": repeat,
          "step_s": step_s, "step_s_median_after_first": step_med,
          "tokens_per_s": tokens / step_med,
          "model_tflops_per_step": flops / 1e12,
          "model_tflop_per_s": flops / step_med / 1e12,
          "model_flops_share_of_989": flops / step_med / PEAK_BF16_FLOPS,
          "max_memory_allocated": peak,
          "launches": {k: launches[k] for k in expected},
          "expected_launches": expected,
          "gmm_launches_by_variant": launches["gmm_by_variant"],
          "gmm_bwd_launches_by_variant": launches["gmm_bwd_by_variant"],
          "ssd_launches_by_variant": launches["ssd_by_variant"],
          "ssd_bwd_launches_by_variant": launches["ssd_bwd_by_variant"],
          "traced_step_ms": traced_ms,
          "traced_device_busy_ms": busy_ms if busy_ms else "not measured",
          "traced_idle_share": 1 - busy_ms / traced_ms if busy_ms else "not measured",
          "traced_kernel_launches": sum(n for _, _, n in kernels),
          "top_kernels": [{"name": k[:80], "ms": ms, "calls": n}
                          for k, ms, n in top],
          "ok": ok})
    if not ok:
        raise AssertionError(
            f"{arch} training failed: agree {agree_ok}, planted faults seen "
            f"{faults_ok} ({faults}), SSD calls {calls_ok}, launches "
            f"{launches_ok} ({ {k: launches[k] for k in expected} } vs "
            f"{expected}), finite {finite}, trained {trained} ({losses}; one "
            f"batch {fit}), peak memory {peak} below {TRAIN_PEAK_BYTES:.0f}: {fits}")
    del state, params
    return launches


def _flat(tree):
    """("a/b", leaf) of a tree of tensors in sorted-key order."""
    from repro_torch.tree import leaves_with_path
    for path, leaf in leaves_with_path(tree):
        yield "/".join(path), leaf


def phase_train_restart():
    """The restart loop on the card at a REDUCED size (a checkpoint's
    bytes measure the disk, not the port): deepseek-7b REDUCED with one
    head of 64 (the kernels' smallest head dim), 15 steps with failures
    injected at steps 6 and 11 against 15 clean steps, checkpoints every 5:
    the two end states bitwise equal, through the kernels' backward."""
    import tempfile
    import torch
    from repro_torch.checkpointing.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import train as train_rt
    from repro_torch.runtime.fault_tolerance import RestartPolicy, run_with_restarts

    cfg = get_config("deepseek-7b", reduced=True).replace(n_heads=1, n_kv_heads=1)
    model = build_model(cfg)
    opts = train_rt.TrainOptions(remat_policy="full", warmup_steps=1,
                                 total_steps=30)
    step = train_rt.build_train_step(model, opts)
    before = read_launches()

    def run(inject, tmp):
        mgr = CheckpointManager(str(Path(tmp) / f"ck{inject}"), async_save=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        state = train_rt.init_train_state(model, gen, opts)
        data = DataIterator(DataConfig(cfg.vocab_size, 64, 4), model_cfg=cfg,
                            device="cuda")
        injected = {6, 11} if inject else set()

        def hook(s):
            if s in injected:
                injected.discard(s)
                raise RuntimeError("injected failure")

        return run_with_restarts(num_steps=15, state=state, data_iter=data,
                                 step_fn=step, ckpt_manager=mgr, save_every=5,
                                 policy=RestartPolicy(max_failures=4),
                                 fail_hook=hook)

    with tempfile.TemporaryDirectory() as tmp:
        clean, hist, f0 = run(False, tmp)
        faulty, _, f1 = run(True, tmp)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(clean), _flat(faulty)))
    bwd = read_launches()["flash_attention_bwd"] - before["flash_attention_bwd"]
    ok = same and f0 == 0 and f1 == 2 and bwd > 0
    emit({"phase": "train_restart", "arch": cfg.name, "n_heads": cfg.n_heads,
          "steps": 15, "failures_survived": f1, "end_states_bitwise_equal": same,
          "flash_bwd_calls": bwd, "loss_first": hist[0]["loss"],
          "loss_last": hist[-1]["loss"], "ok": ok})
    if not ok:
        raise AssertionError("the restart check failed on the card")


# the mesh phase: deepseek-moe-16b's serve and train paths and
# command-r-plus-104b's serve path through the mesh entry points (their
# tensor-parallel code) on a one-rank NCCL group, against the local path
MESH_ARCH = "deepseek-moe-16b"
MESH_SERVE_ARCHS = (MESH_ARCH, "command-r-plus-104b")
# the flash kernel at the per-rank shapes of tensor parallelism over a
# model axis of 4: command-r-plus-104b's prefill (96 / 4 q heads over 8 / 4
# kv heads) and stablelm-12b's training step (32 / 4 over 8 / 4, head_dim
# 160), as phases 2 and flash_bwd hold and time them
TP_FLASH_FWD = ("tp4_command_r_prefill", 4, 2048, 2048, 24, 2, 128, {})
TP_FLASH_BWD = ("tp4_stablelm_train", 2, 2048, 2048, 8, 2, 160, {})
MESH_DECODE_STEPS = 8
MESH_TRAIN_STEPS = 3
# the (data, model) meshes whose expert-parallel gmm shapes the phase times:
# deepseek-moe-16b's prefill of SERVE_BATCH x PROMPT_LEN tokens split over
# data, its experts over model
EP_MESHES = ((2, 2), (1, 8))
PSUM_ELEMENTS = 1 << 20


def ep_gmm_shapes() -> list:
    """(name, E_local, C * ep, d, f) of the gate/up and down products each
    rank runs after the EP all-to-all, on each of EP_MESHES."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.moe import _capacity
    cfg = get_config(MESH_ARCH)
    m = cfg.moe
    out = []
    for dp, ep in EP_MESHES:
        c = _capacity(SERVE_BATCH * PROMPT_LEN // dp, cfg) * ep
        e = m.num_experts // ep
        out += [(f"ep_{dp}x{ep}_gate_up", e, c, cfg.d_model, m.d_ff_expert),
                (f"ep_{dp}x{ep}_down", e, c, m.d_ff_expert, cfg.d_model)]
    return out


def one_rank_mesh():
    """A one-rank NCCL group (an in-memory store: no network) and a (1, 1)
    DeviceMesh named (data, model) on it; any failure raises."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    return make_mesh((1, 1), ("data", "model"), device_type="cuda")


def phase_mesh_psum():
    """``compressed_psum`` on the one-rank group, bitwise against compress
    then decompress (the mean over one rank is its own dequantized
    payload), the residual too."""
    import torch
    from repro_torch.optim import compression
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    g = torch.randn(PSUM_ELEMENTS, generator=gen, device="cuda")
    err = torch.randn(PSUM_ELEMENTS, generator=gen, device="cuda") * 1e-3
    total, new_err = compression.compressed_psum(g, err)
    q, scale, want_err = compression.compress(g, err)
    ok = torch.equal(total, compression.decompress(q, scale)) and \
        torch.equal(new_err, want_err)
    emit({"phase": "mesh_psum", "elements": PSUM_ELEMENTS,
          "bitwise_equal": ok, "ok": ok})
    if not ok:
        raise AssertionError("compressed_psum on one rank is not compress + decompress")


def phase_mesh_serve(mesh, model, params, prompts):
    """A serve path (deepseek-moe-16b at full width and depth, command-r-plus-
    104b at its DEPTH_CUTS depth) through ``jit_prefill_step`` /
    ``jit_decode_step`` (params DTensors on SERVING_RULES, the dense layers
    through the tensor-parallel code, the MoE layers on the EP body, the
    cache on ``mesh_cache``) against the local steps on the same weights
    and prompts: the prefill's last logits, each greedy decode step's
    logits and tokens, bitwise. Returns the mesh run's launches."""
    import torch
    from repro_torch.runtime import serve

    cfg = model.cfg
    opts = serve.ServeOptions()
    B, S = prompts.shape
    max_len = S + MESH_DECODE_STEPS

    def run(prefill, decode, p, cache):
        with torch.inference_mode():
            last, cache = prefill(p, {"tokens": prompts}, cache)
            logits = [last.clone()]
            tok = torch.argmax(last, -1)[:, None]
            toks = [tok]
            for idx in range(S, S + MESH_DECODE_STEPS):
                tok, last, cache = decode(p, cache, tok, idx)
                logits.append(last.clone())
                toks.append(tok)
        torch.cuda.synchronize()
        return torch.stack(logits), torch.cat(toks, 1)

    want = run(serve.build_prefill_step(model, opts),
               serve.build_decode_step(model, opts), params,
               model.init_cache(B, max_len, device="cuda"))
    prefill, _ = serve.jit_prefill_step(model, opts, mesh, B, S)
    decode, _ = serve.jit_decode_step(model, opts, mesh, B, max_len)
    sharded = serve.shard_params(params, model, mesh)
    cache = serve.mesh_cache(model, opts, mesh, B, max_len, device="cuda")
    reset_launches()
    (got, s) = _sync_s(lambda: run(prefill, decode, sharded, cache))
    launches = read_launches()
    pre, dec = expected_launches(cfg), expected_launches(cfg, "decode")
    expected = {k: pre[k] + MESH_DECODE_STEPS * dec[k] for k in pre}
    launches_ok = all(launches[k] == v for k, v in expected.items()) and \
        launches["flash_attention"] > 0 and \
        launches["gmm_by_variant"]["wgmma"] == launches["gmm"]
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    emit({"phase": "mesh_serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "mesh": {"data": 1, "model": 1}, "batch": B, "prompt_len": S,
          "decode_steps": MESH_DECODE_STEPS, "logits_bitwise_equal": same,
          "max_abs_logit_diff": (got[0] - want[0]).abs().max().item(),
          "tokens_equal": torch.equal(got[1], want[1]), "mesh_run_s": s,
          "launches": {k: launches[k] for k in expected},
          "expected_launches": expected,
          "gmm_launches_by_variant": launches["gmm_by_variant"],
          "ok": same and launches_ok})
    if not (same and launches_ok):
        raise AssertionError(f"mesh serve path: bitwise {same}, launches "
                             f"{launches_ok} ({launches})")
    del sharded, cache
    return launches


def phase_mesh_train(mesh):
    """deepseek-moe-16b's train path (TRAIN_DEPTH_CUTS' 8 layers, as phase
    train) through ``jit_train_step`` on the (1, 1) mesh, MESH_TRAIN_STEPS
    steps from the same seeded init and batches as the local
    ``build_train_step``: each step's loss and grad norm and the updated
    params, bitwise; the local path first run twice, to show it repeats
    itself bitwise. Returns the mesh run's launches."""
    import torch
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as train_rt
    from repro_torch.tree import leaves

    cfg = train_config(MESH_ARCH)
    model = build_model(cfg)
    opts = train_rt.TrainOptions(
        remat_policy="full", warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
        opt=adamw.AdamWConfig(lr=TRAIN_LR, moment_dtype="bfloat16"))
    dc = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batches = [batch_for_step(dc, i, cfg, device="cuda")
               for i in range(MESH_TRAIN_STEPS)]

    def fresh():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = model.init(gen)
        scale_routed_experts(model, params)
        return {"params": params, "opt": adamw.init_opt_state(params, opts.opt),
                "step": torch.zeros((), dtype=torch.int32, device="cuda")}

    def run(step, state):
        metrics = []
        for b in batches:
            state, met = step(state, b)
            metrics.append((met["loss"].clone(), met["grad_norm"].clone()))
        torch.cuda.synchronize()
        return [p.to_local() if hasattr(p, "to_local") else p
                for p in leaves(state["params"])], metrics

    local_step = train_rt.build_train_step(model, opts)
    want_p, want_m = run(local_step, fresh())
    again_p, again_m = run(local_step, fresh())
    repeats = all(torch.equal(a, b) for a, b in zip(want_p, again_p)) and \
        all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(want_m, again_m))
    del again_p, again_m
    gc.collect()
    torch.cuda.empty_cache()
    b_abs = {k: torch.empty(v.shape, device="meta") for k, v in batches[0].items()}
    mesh_step = train_rt.jit_train_step(model, opts, mesh, b_abs)
    state = train_rt.distribute_train_state(fresh(), model, mesh, opts)
    placed = train_rt.shd.spec_tree_of(state) == \
        train_rt.state_shardings(model, mesh, opts)
    reset_launches()
    (got_p, got_m), s = _sync_s(lambda: run(mesh_step, state))
    launches = read_launches()
    del state
    same_p = all(torch.equal(a, b) for a, b in zip(got_p, want_p))
    same_m = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                 for a, b in zip(got_m, want_m))
    expected = expected_train_launches(cfg, MESH_TRAIN_STEPS)
    launches_ok = all(launches[k] == v for k, v in expected.items()) and \
        launches["gmm_by_variant"]["wgmma"] == launches["gmm"] > 0 and \
        launches["gmm_bwd_by_variant"]["wgmma_bwd"] == 2 * launches["gmm_bwd"]
    ok = repeats and placed and same_p and same_m and launches_ok
    emit({"phase": "mesh_train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "mesh": {"data": 1, "model": 1}, "steps": MESH_TRAIN_STEPS,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "local_repeats_bitwise": repeats, "placed_as_state_shardings": placed,
          "losses": [m[0].item() for m in got_m],
          "grad_norms": [m[1].item() for m in got_m],
          "metrics_bitwise_equal": same_m, "params_bitwise_equal": same_p,
          "mesh_run_s": s, "launches": {k: launches[k] for k in expected},
          "expected_launches": expected,
          "gmm_launches_by_variant": launches["gmm_by_variant"],
          "gmm_bwd_launches_by_variant": launches["gmm_bwd_by_variant"],
          "ok": ok})
    if not ok:
        raise AssertionError(f"mesh train path: local repeats {repeats}, placed "
                             f"{placed}, params {same_p}, metrics {same_m}, "
                             f"launches {launches_ok} ({launches})")
    del got_p, want_p
    return launches


def phase_mesh_gmm():
    """The gmm kernel at the per-rank shapes of expert parallelism
    (``ep_gmm_shapes``): the ``wgmma`` variant required, the model-shape
    limits of phase gmm against the plain version, and CUDA-event times of
    the kernel, the plain version and ``torch.bmm`` beside the bound."""
    import torch
    from repro_torch.kernels.moe_gmm import gmm_cuda, gmm_plain, gmm_variant

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    worst, timings, failures = 0.0, {}, []
    for name, E, C, d, f in ep_gmm_shapes():
        x = torch.randn(E, C, d, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(E, d, f, generator=gen, device="cuda") * d ** -0.5).bfloat16()
        variant = gmm_variant(x, w)
        got = gmm_cuda(x, w)
        torch.cuda.synchronize()
        want = gmm_plain(x, w)
        err = (got.float() - want.float()).abs().max().item()
        norm = ((got.float() - want.float()).norm() / want.float().norm()).item()
        ok = variant == "wgmma" and bool(torch.isfinite(got).all()) and \
            torch.allclose(got.float(), want.float(), atol=KERNEL_TOL,
                           rtol=KERNEL_TOL) and norm <= GMM_NORM_RTOL
        line = {"phase": "mesh_gmm", "shape": name, "E_C_d_f": [E, C, d, f],
                "variant": variant, "max_abs_err": err, "norm_rel_err": norm,
                "tol": KERNEL_TOL, "norm_rtol": GMM_NORM_RTOL}
        if ok:
            bound_ms, bound_by = gmm_bound_ms(E, C, d, f, "bfloat16")
            timings[name] = {
                "ms": cuda_ms(lambda: gmm_cuda(x, w)),
                "plain_ms": cuda_ms(lambda: gmm_plain(x, w), warmup=1, iters=5),
                "library_ms": cuda_ms(lambda: torch.bmm(x, w)),
                "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                "shape": f"E={E} C={C} d={d} f={f} bf16 (deepseek-moe-16b "
                         f"prefill, one rank of a (data, model) = "
                         f"{name.split('_')[1].replace('x', ', ')} mesh)"}
            line.update(timings[name])
        else:
            failures.append(name)
        worst = max(worst, err)
        emit({**line, "ok": ok})
        del x, w, got, want
    if failures:
        raise AssertionError(f"gmm at the EP shapes failed: {failures}")
    return worst, timings


def phase_mesh_flash():
    """The flash kernel at the per-rank shapes of tensor parallelism
    (TP_FLASH_FWD forward, TP_FLASH_BWD backward): phase 2's and phase
    flash_bwd's limits against the plain version, and CUDA-event times of
    the kernel, the plain version and ``F.scaled_dot_product_attention``
    (forward; the backward of it) beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    failures, timings = [], {}
    name, B, Sq, Sk, H, KVH, D, opts = TP_FLASH_FWD
    q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, KVH, D), rnd(B, Sk, KVH, D)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, causal=True)
    err = (got.float() - want.float()).abs().max().item()
    row_rel, norm_rel = rel_errors(got, want)
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), atol=KERNEL_TOL, rtol=KERNEL_TOL) and \
        row_rel <= ROW_RTOL and norm_rel <= NORM_RTOL
    line = {"phase": "mesh_flash", "shape": name,
            "B_Sq_Sk_H_KVH_D": [B, Sq, Sk, H, KVH, D], "max_abs_err": err,
            "tol": KERNEL_TOL, "row_rel_err": row_rel, "row_rtol": ROW_RTOL,
            "norm_rel_err": norm_rel, "norm_rtol": NORM_RTOL}
    if ok:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound_ms, bound_by = attention_bound_ms(B, Sq, Sk, H, KVH, D, opts)
        timings[name] = {
            "ms": cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True)),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=True), warmup=1, iters=5),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "shape": f"B={B} S={Sq} H={H} KVH={KVH} D={D} causal bf16 "
                     "(command-r-plus-104b prefill, one rank of model 4)"}
        line.update(timings[name])
    else:
        failures.append(name)
    emit({**line, "ok": ok})
    del q, k, v, got, want

    name, B, Sq, Sk, H, KVH, D, opts = TP_FLASH_BWD
    q, k, v, do = rnd(B, Sq, H, D), rnd(B, Sk, KVH, D), rnd(B, Sk, KVH, D), \
        rnd(B, Sq, H, D)
    kw = dict(causal=True, window=0, softcap=0.0, scale=None, kv_valid=None)
    out, lse = fa._forward(q, k, v, q_offset=0, with_lse=True, **kw)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, do, **kw)
    errs = {g: grad_errors(a, b) for g, a, b in zip(("dq", "dk", "dv"), got, want)}
    ok = all(bool(torch.isfinite(g).all()) for g in got) and \
        all(within_bwd_limits(e) for e in errs.values())
    err = max(e["max_abs"] for e in errs.values())
    line = {"phase": "mesh_flash_bwd", "shape": name,
            "B_Sq_Sk_H_KVH_D": [B, Sq, Sk, H, KVH, D], "errors": errs,
            "limits": {"elem": BWD_ELEM_TOL, "row": BWD_ROW_RTOL,
                       "norm": BWD_NORM_RTOL}}
    if ok:
        qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                  enable_gqa=True)
        do_t = do.transpose(1, 2)
        bound_ms, bound_by = attention_bwd_bound_ms(B, Sq, Sk, H, KVH, D, opts)
        timings[name] = {
            "ms": cuda_ms(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, out, do, lse, **kw)),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, do, **kw), warmup=1, iters=3),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), do_t, retain_graph=True)),
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "library_note": "the backward of F.scaled_dot_product_attention",
            "shape": f"B={B} S={Sq} H={H} KVH={KVH} D={D} causal bf16 "
                     "(stablelm-12b training, one rank of model 4)"}
        line.update(timings[name])
        del sdpa_out, qs, ks, vs
    else:
        failures.append(name)
    emit({**line, "ok": ok})
    del q, k, v, do, out, lse, got, want
    if failures:
        raise AssertionError(f"flash at the TP shapes failed: {failures}")
    return timings


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start_dryrun()
    try:
        return run_phases()
    finally:
        stop_dryrun()


def run_phases() -> int:
    import torch
    import torch.distributed as dist

    census = phase_card()
    flash_err, flash_t = phase_kernel()
    flash_bwd_err, flash_bwd_t = phase_flash_bwd()
    ssd_err, ssd_t = phase_ssd()
    gmm_err, gmm_t = phase_gmm()
    gmm_bwd_err, gmm_bwd_t = phase_gmm_bwd()
    ssd_bwd_err, ssd_bwd_t = phase_ssd_bwd()
    launches = {}
    for arch in TRAIN_PATHS:
        launches[f"train:{arch}"] = phase_train(arch)
        gc.collect()
        torch.cuda.empty_cache()
    phase_train_restart()
    mesh = one_rank_mesh()
    phase_mesh_psum()
    launches["mesh:train"] = phase_mesh_train(mesh)
    gc.collect()
    torch.cuda.empty_cache()
    ep_gmm_err, ep_gmm_t = phase_mesh_gmm()
    tp_flash_t = phase_mesh_flash()
    for arch, decode_steps in SERVE_PATHS:
        model, params, prompts, extras, launches[arch] = phase_serve(arch)
        if arch in MESH_SERVE_ARCHS:
            launches[f"mesh:serve:{arch}"] = phase_mesh_serve(
                mesh, model, params, prompts)
        if decode_steps is not None:
            phase_agree(model, params, *agree_inputs(arch, prompts, extras),
                        decode_steps=decode_steps,
                        replay_calls=arch in REPLAY_CALLS)
            phase_trace(model, params, prompts, extras)
        del model, params, prompts, extras
        gc.collect()
        torch.cuda.empty_cache()
    launches["video_executor"] = phase_executor()
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    def entry(name, source, replaces, err, timing, shape, variant, **more):
        by_path = {arch: n[name] for arch, n in launches.items() if n[name]}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "max_abs_err": err, **timing, "shape": shape,
                "variant": variant, "launches_by_path": by_path,
                "sass": census[Path(source).stem], **more}

    def by_variant(key):
        return {v: sum(n[key][v] for n in launches.values())
                for v in launches[SERVE_PATHS[0][0]][key]}

    emit({"kernels": [
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:82", flash_err,
              flash_t[SERVE_SHAPE[0]], "B=4 S=2048 H=KVH=32 D=128 causal bf16",
              "TMA + wgmma: 128-row q tiles over 96-row K/V tiles, a producer "
              "warpgroup and two consumer warpgroups; at head_dim 160 and 256 "
              "64-row q tiles, one consumer warpgroup and a producer warp",
              at_d112={**flash_t[ZAMBA_SHAPE[0]],
                       "shape": "B=4 S=2048 H=KVH=32 D=112 causal bf16"},
              at_d256={**flash_t[GEMMA2_GLOBAL[0]],
                       "shape": "B=4 S=2048 H=16 KVH=8 D=256 causal, softcap "
                                "50, scale 224^-0.5, bf16 (gemma2-9b global)"},
              at_gemma2_local={
                  **flash_t[GEMMA2_LOCAL[0]],
                  "shape": "B=1 S=6144 H=16 KVH=8 D=256 causal, window 4096, "
                           "softcap 50, scale 224^-0.5, bf16 (gemma2-9b local)"},
              at_d160={**flash_t[STABLELM_SHAPE[0]],
                       "shape": "B=4 S=2048 H=32 KVH=8 D=160 causal bf16 "
                                "(stablelm-12b)"},
              at_vlm_cross={
                  **flash_t[VLM_CROSS[0]],
                  "shape": f"B=4 Sq=2048 Sk={NUM_PATCHES} H=64 KVH=8 D=128 "
                           "non-causal bf16 (llama-3.2-vision-90b cross)"},
              at_seamless_encoder={
                  **flash_t[SEAMLESS_ENCODER[0]],
                  "shape": f"B=4 S={ENC_LEN} H=KVH=16 D=64 non-causal bf16"},
              at_seamless_cross={
                  **flash_t[SEAMLESS_CROSS[0]],
                  "shape": f"B=4 Sq=1 Sk={ENC_LEN} H=KVH=16 D=64 non-causal "
                           "bf16 (prefill and every decode step)"},
              at_tp4_command_r=tp_flash_t[TP_FLASH_FWD[0]]),
        entry("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:70", ssd_err,
              ssd_t["zamba2-7b"],
              "B=4 L=2048 H=112 P=64 N=64 G=2 chunk=256 bf16 (zamba2-7b)",
              "wgmma (chunk-state decomposition: chunk_state and chunk_scan on "
              "TMA + wgmma with fp32 operands split into bf16 hi + lo, "
              "state_pass on the CUDA cores) for the model shapes; fma (fp32 "
              "FMA, one block per P-slice) for fp32 and other bf16 shapes",
              launches_by_variant=by_variant("ssd_by_variant"),
              at_mamba2={**ssd_t["mamba2-370m"],
                         "shape": "B=4 L=2048 H=32 P=64 N=128 G=1 chunk=256 "
                                  "bf16 (mamba2-370m)"},
              **ssd_rank_entries(ssd_t, SSD_RANK_SHAPES, "serve")),
        entry("gmm", "src/repro_torch/csrc/moe_gmm.cu",
              "src/repro/kernels/moe_gmm.py:47", gmm_err,
              gmm_t["prefill_gate_up"],
              "E=64 C=968 d=2048 f=1408 bf16 (deepseek-moe-16b prefill "
              "gate/up)",
              "wgmma (TMA + wgmma: 128 x 256 tiles in clusters of 2 sharing w "
              "by multicast where C > 64, 64 x 64 tiles where C <= 64); mma "
              "(mma.sync) for bf16 shapes TMA cannot address; fma for fp32",
              launches_by_variant=by_variant("gmm_by_variant"),
              at_prefill_down={**gmm_t["prefill_down"],
                               "shape": "E=64 C=968 d=1408 f=2048 bf16"},
              at_decode={**gmm_t["decode_gate_up"],
                         "shape": "E=64 C=8 d=2048 f=1408 bf16"},
              max_abs_err_at_ep_shapes=ep_gmm_err,
              **{f"at_{name}": t for name, t in ep_gmm_t.items()}),
        entry("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
              "src/repro/kernels/flash_attention.py:82", flash_bwd_err,
              flash_bwd_t[FLASH_TRAIN_SHAPES[0][0]],
              "B=2 S=2048 H=KVH=32 D=128 causal bf16 (deepseek-7b training)",
              "TMA + wgmma, three kernels: Delta; dK and dV per 64-key tile "
              "(and column part of at most 128 at head_dim 160 and 256) over "
              "the group's heads, two consumer warpgroups (P^T and dV; dS^T "
              "and dK, P^T dy crossing through shared memory) and a producer "
              "warp; dQ per 64-row q tile, one consumer warpgroup and a "
              "producer warp, two blocks an SM up to head_dim 128; no atomics "
              "(bitwise repeatable); launches count calls",
              at_moe16b={**flash_bwd_t[FLASH_TRAIN_SHAPES[1][0]],
                         "shape": "B=2 S=2048 H=KVH=16 D=128 causal bf16 "
                                  "(deepseek-moe-16b training)"},
              at_d112_train={**flash_bwd_t[FLASH_TRAIN_SHAPES[2][0]],
                             "shape": "B=2 S=2048 H=KVH=32 D=112 causal bf16 "
                                      "(zamba2-7b training)"},
              at_gemma2_train={**flash_bwd_t[FLASH_TRAIN_SHAPES[3][0]],
                               "shape": "B=2 S=2048 H=16 KVH=8 D=256 causal, "
                                        "softcap 50, scale 224^-0.5, bf16 "
                                        "(gemma2-9b training)"},
              at_d160_train={**flash_bwd_t[FLASH_TRAIN_SHAPES[4][0]],
                             "shape": "B=2 S=2048 H=32 KVH=8 D=160 causal bf16 "
                                      "(stablelm-12b training)"},
              at_tp4_stablelm_train=tp_flash_t[TP_FLASH_BWD[0]]),
        entry("gmm_bwd", "src/repro_torch/csrc/moe_gmm.cu",
              "src/repro/kernels/moe_gmm.py:47", gmm_bwd_err,
              gmm_bwd_t["train_gate_up"],
              f"E=64 C={train_capacity()} d=2048 f=1408 bf16 "
              "(deepseek-moe-16b training gate/up: dx and dw)",
              "wgmma_bwd: two launches of the grouped-GEMM wgmma kernel "
              "instantiated for the operands' majorness, no transposed copy "
              "(dx = dy w^T with w a K-major B; dw = x^T dy with x an MN-major "
              "A through the transpose bit); mma / fma on transposes for "
              "shapes TMA cannot address and fp32; launches count calls",
              launches_by_variant=by_variant("gmm_bwd_by_variant"),
              at_train_down={**gmm_bwd_t["train_down"],
                             "shape": f"E=64 C={train_capacity()} d=1408 "
                                      "f=2048 bf16"}),
        entry("ssd_scan_bwd", "src/repro_torch/csrc/ssd_scan_bwd.cu",
              "src/repro/kernels/ssd_scan.py:70", ssd_bwd_err,
              ssd_bwd_t["zamba2-7b"],
              "B=2 L=2048 H=112 P=64 N=64 G=2 chunk=256 bf16 (zamba2-7b "
              "training)",
              "wgmma (TMA + wgmma, five kernels: each chunk's local state and "
              "state gradient; a sequential pass over the chunks on the CUDA "
              "cores writing the states and their gradients as bf16 hi + lo; "
              "a row pass per 64-row t tile (C B^T, dY X^T, V B) and a column "
              "pass per 64-row s tile (B C^T, X dY^T, W^T dY, V^T C), fp32 "
              "operands split into hi + lo; the reverse scan of d cum and the "
              "sums over heads) for the model shapes; fma (fp32 FMA on the "
              "CUDA cores: states, chunks, reduce) for fp32 and other shapes; "
              "no atomics (bitwise repeatable); launches count calls",
              launches_by_variant=by_variant("ssd_bwd_by_variant"),
              at_mamba2={**ssd_bwd_t["mamba2-370m"],
                         "shape": "B=2 L=2048 H=32 P=64 N=128 G=1 chunk=256 "
                                  "bf16 (mamba2-370m training)"},
              **ssd_rank_entries(ssd_bwd_t, SSD_RANK_TRAIN_SHAPES, "training")),
    ]})
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun"]:
        sys.exit(dryrun_child(sys.argv[2]))
    sys.exit(main())
