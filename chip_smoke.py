#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main paths on one card and check them.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):

  1. print the card (``nvidia-smi``), build the kernels from
     ``src/repro_torch/csrc`` with nvcc for sm_90a (one nvcc per source,
     all at once), log ptxas's registers and spills (and, for each
     instantiation of both K5 kernels, its shared memory; none may spill)
     and, where ``cuobjdump`` exists, check that the tensor-core K5
     kernel's SASS has HGMMA in its 3 instantiations and count the SASS
     instructions of K1's, K2's and K4's per-cell loops (written to
     ``build/congruence.sass``);
  2. hold each sweep kernel (K1 congruence, K2 step time, K3 default beta,
     K4 sweep statistics) against its plain PyTorch version on the card,
     at A in {1, 3, 64} x V in {1, 127, 128, 129, 513, 100003} and at the
     edges of K1's and K4's tiles (``EDGE_SHAPES``: A up to 1025, V up to
     62501, and K2's: 16 apps x 256 variants a block, each +-1), both
     timing models, clamp on and off, with degenerate cells; K1, K2 and K3
     must equal their plain float32 versions in every cell, NaN included;
     K4's argmins and minima must equal the reduction of K1's own
     aggregate exactly; then K4 on a 64 x 62501 shard with NaN aggregates
     (NaN columns, and NaN rows) and with every variant alike, where the
     argmin must be the first NaN, or index 0, across all blocks;
  3. main path, ``run_sweep``: gen:64 x (100000 + 3 named) variants on the
     card (plus ``batched_step_time`` and ``evaluate`` on the same suite),
     checked against the plain float32 and float64 versions;
  4. main path, streamed ``shard_sweep``: gen:64 x 1000003 variants in 16
     shards through K4, checked against the plain float32 version, and a
     checkpoint kill/resume round trip;
  5. timings by CUDA events at the phase-3/4 shapes, beside each kernel's
     bound, with each device kernel's own time (``torch.profiler``), the
     wrapper's host time a call, K1's and K4's instruction bound (SASS
     instructions a cell x cells over the card's issue rate) and a
     ``fill_`` of K1's output as the ceiling of its stores; K2 warm and
     cold (a 256 MB fill between launches) and ``fill_`` ceilings of K2's
     output; the launch floor (one block of 32 threads writing one float)
     beside K3; ``CudaBackend.default_beta`` a call; and the end-to-end
     split;
  6. hold both K5 (flash attention) kernels against the plain version on
     the card: B in {1, 2} x (H, K) in {(4, 4), (8, 2), (32, 2)} x D in
     {64, 128} (and, in bf16, {32, 80, 256}) x S = T in {1, 63, 64, 65,
     79, 80, 81, 127, 128, 129, 159, 160, 161, 255, 256, 257, 2048} x causal window
     {None, 64}, plus non-causal S=127, T=300, in f32 (2e-4) and bf16
     (2e-2), and at the model's strided layouts (chatglm3-6b's D 128 and
     recurrentgemma-9b's D 256) with 16-byte-aligned bases and one element
     off; bf16 at D 64 / 128 / 256 with aligned bases must take the
     tensor-core kernel (wgmma + TMA), the rest the FMA kernel; then time
     at the model's shape the tensor-core kernel, the FMA kernel on the
     same bf16 tensors (for the record), the plain version, SDPA and the
     bound, and the FMA kernel in f32 beside its own; paligemma-3b's
     attention shape (D 256) in f32 (FMA) and bf16 (tensor cores, with the
     FMA kernel on the same tensors); and, held then timed in bf16, phases
     13-15's shapes (``FAMILY_FA``): qwen2-moe-a2.7b's (H 16, K 16, S 2048,
     D 128), recurrentgemma-9b's (H 16, K 1, S 2048, D 256, window 2048,
     with the FMA kernel on the same tensors), whisper-medium's decoder
     (H 16, K 16, S 448, D 64) and phase 23's qwen3-32b (H 64, K 8, S 2048,
     D 128) and qwen1.5-4b (H 20, K 20, S 2048, D 128), B 4;
  7. main path, the model stack: chatglm3-6b at full width and depth
     (28 layers, weights drawn on the card, bf16 compute), ``forward`` and
     ``loss_fn`` on 4 x 2048 seeded tokens with ``attn_impl="pallas"`` (28
     K5 launches per forward, all on the tensor-core kernel), held against
     the plain attention (``attn_impl="xla"``) on the same weights; the f32
     forward's 28 launches take the FMA kernel;
  8. main path, serving: ``prefill`` + ``decode_step`` against the forward's
     last-token logits in f32 compute, and ``BatchedEngine`` (4 slots) on 8
     requests of 8 new tokens with staggered admissions, each stream
     against the same request served alone; timings of the forward, the
     decode step and the engine;
  9. hold K6 (RMSNorm) and K7 (fused residual RMSNorm) against their plain
     versions at rows {1, 37, 256, 8192} x d {64, 128, 4096} x {f32, bf16}
     x and f32 / bf16 scale (1e-5 f32, 2e-2 bf16), and K8 (selective scan)
     at (B, S, Din, N) in {(1,1,64,4), (1,32,64,4), (2,64,128,8),
     (1,48,96,16), (2,37,100,5), (1,70,130,1), (1,33,64,13),
     (4,2048,8192,16)} x {f32, bf16} inputs, with and without h0, with
     contiguous and with the model's strided B / C (2e-4 f32, 2e-2 bf16),
     plus the model's mixed call (bf16 xi / B / C, f32 dt_raw, f32 y, hT
     written over h0) and a split sequence with the carried state against
     the whole one; then time each at the model's shape beside its plain
     version, its bound and its library call, and K8 at the decode step's
     shape (B 4, S 1);
 10. main path, the SSM stack: falcon-mamba-7b at full width and depth (64
     layers, weights drawn on the card, bf16 compute; chatglm3's weights
     freed first), ``forward`` and ``loss_fn`` on 4 x 2048 seeded tokens
     with ``attn_impl="pallas"`` (1 K6, 64 K7 and 64 K8 launches per
     forward), held against the plain blocks (``"xla"``) on the same
     weights;
 11. main path, SSM serving: ``prefill`` + ``decode_step`` through K6-K8
     against the forward's last-token logits in f32 compute; the decode
     step at B 4 after a 2048-token prefill; ``BatchedEngine`` (4 slots) on
     8 requests of 8 new tokens, staggered, timed, and a one-slot engine's
     streams against a greedy ``prefill`` / ``decode_step`` loop (f32);
 12. main path, co-design on phase 3's suite (gen:64): ``grad_codesign``
     from the three named variants and from every survivor of phase 3's
     sweep (``seed_codesign()``), 100 steps; ``constrained_codesign`` from
     the survivors: projected (shift) under an area budget, Lagrangian,
     ``optimize_links``, an HBM ``area_envelope`` (100 steps each) and the
     Euclidean projection under area and power budgets (5 steps);
     ``joint_codesign`` (alternate, softmax) on 3 sharding variants of each
     app; all float64 on the card, each timed, its trajectory, NumPy
     re-score (1e-6), budgets and host twin (``device="cpu"``, 1e-6) held;
     the optimized designs re-scored through K3 and K1, equal to plain
     float32 and within 5e-4 of the descents' float64 fit; then
     ``grad_codesign``'s launches a step and idle share, and one Euclidean
     projection's time, launches and ATen operations;
 13-16. main path, the MoE, hybrid, audio and VLM families at full width
     and depth, one at a time (the previous model freed), weights drawn on
     the card from seed 0, bf16 compute, NumPy-seeded tokens (next tokens
     as labels), frames and patches: qwen2-moe-a2.7b (24 layers, 60
     experts top-4 + 4 shared; 4 x 2048 tokens), recurrentgemma-9b (12
     groups of two RG-LRU blocks and a local-attention block + 2 RG-LRU
     blocks; 4 x 2048), whisper-medium (24 encoder layers over 1500
     frames, 24 decoder layers; 4 x 448 tokens) and paligemma-3b (18
     layers, 256 patches + 4 x 2048 tokens).  ``forward`` and ``loss_fn``
     with ``attn_impl="pallas"`` launch K5 24 (tensor cores), 12 (tensor
     cores, D 256), 24 (tensor cores, D 64) and 0 (the VLM prefix) times a
     forward,
     held against the plain attention on the same weights (the MoE's
     tokens whose top-k experts differ between the runs counted and left
     out of the hidden-state holds); the f32 forward through the FMA
     kernel against the plain f32 one (1e-4 of max); ``prefill`` +
     ``decode_step`` against the forward in f32 (the hybrid: a 2048-token
     prefill and 8 decode steps past the window, so the ring wraps);
     ``BatchedEngine`` (4 slots, 8 requests x 8 new tokens, staggered),
     its streams each equal to the request served alone (the MoE's in
     f32), or for the hybrid a one-slot engine equal to greedy decode;
     timings of the forward (with a ``torch.profiler`` split), the decode
     step and the engine, and the RG-LRU step loop alone;
 17. main path after a sweep, on phase 3's suite and phase 12's survivors,
     float64 on the card: ``frontier_codesign`` over budgets (0.25, 0.5,
     0.75, 1.0, 1.5) x phase 12's area budget, 100 steps (J* non-increasing,
     feasible rows within budget to 1e-9, NumPy re-score 1e-6, dJ*/db <= 0
     where feasible and NaN elsewhere, ``SweepResult.frontier`` equal);
     ``sensitivities_of`` phase 12's projected result against the host's;
     the ``implicit_jstar_fn`` area-budget gradient against central
     differences (1e-3) on the JAX package's pin; ``bilevel_codesign`` cut
     to 2 outer and 10 inner steps, never worse than the uniform split;
     ``pack_codesign`` 32 gen apps x 4 machines beating the uniform fleet,
     budget and envelope met to 1e-9, assignment equal to the host's; the
     frontier's designs re-scored through K3 / K1; then the co-design
     service with no threads: two gen suites on one 100 003-variant
     population in one K1 pass (each slice equal to its request alone), a
     memo hit, a 200 003-variant mega-sweep in 4 shards through K4 (events
     in order), a frontier and a tighter one from its cache (a warm hit),
     constrained, joint, pack and bilevel requests, each equal to the
     direct call; and the sweeps and frontier again through 2 worker
     threads, equal;
 18. the measurement loop: (a) the six zoo-smoke cells extracted on the
     card (``core.model_zoo.extract_profile``: the step under the op
     counter), their model_flops, tokens, params, params_active and
     num_devices equal to the JAX-made goldens and their dot_flops, flops,
     transcendentals, bytes_accessed and hbm_bytes equal to the same cells
     counted on ``meta``, with each field's ratio to the JAX golden and to
     the port's golden printed, and qwen2-moe's smoke MoE (train and
     prefill) on the card equal to ``meta``, whose experts split evenly; (b) chatglm3-6b's 12 full-grid zoo cells at
     published width and depth on ``meta`` (model_flops equal to
     ``model_flops_for``), timed; (c) its ``zoo_decode_s4096_b32`` cell run
     on the card with phase 7's weights (before they are freed), its counts
     equal to (b)'s, the allocator's peak beside the tracker's; (d)
     ``calibration_report`` of (a)'s profiles, K2 against the float64
     roofline, every ratio within 5e-4 of 1; (e) ``run_sweep`` of (a)'s
     suite x 100 003 variants through K3 -> K1, best fits and the 2-D front
     equal to plain float32, printed beside the JAX-made suite's;
 19. training: whisper-medium at published width and depth (attn_impl
     "xla"), ``Trainer`` for 4 steps of 4 x 448 decoder tokens over 1500
     frames from ``SyntheticLM``, checkpointed (``AsyncCheckpointer``) at
     step 2 and 4: finite losses, the learning rate equal to a float64
     schedule (1e-5), one more AdamW update equal to a NumPy float64 twin
     (global norm, lr, and sampled parameter / m / v slices, 1e-5); a run
     killed after step 2 and resumed from its checkpoint ends with the
     uninterrupted run's state bit for bit; a smoke checkpoint written on
     the CPU loads on the card bit for bit and trains on there; the train
     cell's profile on the card equal to its ``meta`` count; the step's
     time and tokens/s;
 20. the hillclimb launcher (``python -m repro_torch.launch.hillclimb``,
     called as ``main([...])``): ``--mode flash`` at chatglm3-6b's
     train_4k (baseline and depth-2 probes on ``meta`` at published width),
     its removed bytes equal to the score traffic counted by hand
     (``attention_score_bytes``) and its hbm_bytes to max(h - removed +
     added, added); one command a co-design mode on the card: ``--sweep
     100000`` (K3, K1) with ``--grad 20 --area-budget 2.0
     --sensitivities``, ``--budget-sweep`` inside the best seed's binding
     window (a row binds, J* rises as the budget tightens), ``--pack 4``,
     each result equal to the same call on the host (``--device cpu``,
     float64, 1e-9) and the sweep's best fit and front to the plain
     float32 path on the card (phase 17 holds the bilevel split);
     ``--mode scan`` at falcon-mamba-7b's zoo_decode_s32768_b256 with
     ``--sweep 100000``, its probes linear in N at N, N/2, N/4 and its
     removed bytes equal to the count by hand
     (``scan_state_bytes_by_hand``);
 21. the sharded layer: (a) the dry run (``python -m
     repro_torch.launch.dryrun``) of chatglm3-6b's train_4k on the pod
     mesh (16 x 16, its default variant zero1) and deepseek-67b's on the
     multi-pod mesh (2 x 16 x 16, fsdp), at published width and depth on
     ``meta``, each in a child process that owns its fake process group
     (started before phase 20, on the host's cores), and chatglm3-6b's
     zoo cell ``zoo_train_s2048_b64`` through ``core.model_zoo``'s pod
     path (per device on ``pod16x16`` under zero1, as the JAX package
     extracts its full cells): per device, dot FLOPs
     equal to a count by hand (``train_dot_by_hand``), collective bytes
     by kind, pod-crossing bytes on the multi-pod mesh only, parameter
     bytes equal to the specs' shards; (b) ``hillclimb --mode flash
     --mesh pod --joint --grad 10 --sweep 100000`` at chatglm3-6b's
     train_4k in a child (its profiles on ``meta``, its co-design on the
     card, the sweep through K3 then K1, held as phase 20 holds it):
     the three variants' collective bytes differ, fsdp's parameter
     all-gathers the largest, the joint trajectory never rises, the
     NumPy re-score within 1e-6; (c) a real NCCL world of the card in this
     process: ``shard_sweep`` over the ``variants`` mesh (K4 on each
     rank's slice) equal to the meshless run bit for bit, and a train step
     of chatglm3-6b's width at 2 layers sharded on a 1 x 1 mesh against the
     unsharded step (loss 1e-6 relative, every gradient 1e-5 of the
     largest);
 22. the model kernels on a mesh, in phase 21 (c)'s NCCL world: chatglm3-6b
     (2 layers), falcon-mamba-7b (2 layers) and recurrentgemma-9b (3
     layers: one group) at published width, bf16, ``attn_impl="pallas"``,
     4 x 2048 tokens, on a 1 x 1 ``("data", "model")`` mesh under ``tp``:
     a forward, a prefill and one decode step, K5-K8 on each device's local
     tensors, against the same unsharded kernel runs -- bit for bit, or
     else within max(2e-2, 1.5 x the plain path's distance from f32) -- with
     the launches of each held exactly (K5 a layer that takes it, K6 once
     and K7 and K8 once a layer of each SSM call); the sharded and unsharded
     forwards timed;
 23. qwen3-32b (64 layers, d_model 5120, GQA 64 / 8, bf16 weights, 65.5
     GB) and qwen1.5-4b (40 layers, MHA 20 / 20, QKV bias, f32 weights) at
     published width and depth, one at a time, 4 x 2048 tokens, bf16
     compute: the K5 forward (64 and 40 launches) against the plain
     attention, prefill + decode_step against the forward in f32, the
     forward timed with its ``torch.profiler`` split;
 24. the cached prefill's attention on K5 (``attn_apply``'s route over the
     cache rows just written): one qwen1.5-4b attention layer at published
     width, bf16, at the benchmark cells' 1 x 32 768 and chat's 32 x 128,
     16 x 256 and 8 x 512, and at 8 x 512 in a longer two-layer cache,
     against the plain q-chunked path: one K5 launch on the tensor cores,
     the caches bit for bit, the output within 0.1 of the row std;
 25. the kernels line, the card, and the result line.

It needs one CUDA card, the CUDA toolkit's nvcc and the repository's
``src/`` tree; without them it exits with an error and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth,
#: float32 rate outside the tensor cores, dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

TOL = 5e-4           # kernels vs plain versions (the JAX package's f32 pin)
MEAN_RTOL = 1e-5     # K4 per-variant means
#: Eq. 1 cells whose condition number (|gamma| + |beta| + max|alpha|) /
#: |gamma - beta| exceeds this are left out of the float64 comparisons:
#: float32 rounding of the inputs alone (~1e-7 relative) moves such a score
#: by more than TOL.  The float32 comparisons keep every cell.
COND_LIMIT = 1e3
SHAPES_A = (1, 3, 64)
SHAPES_V = (1, 127, 128, 129, 513, 100_003)
#: Phase 2's (A, V) pairs beside that grid: the ragged edges of the sweep
#: kernels' tiles (K1: 4 apps x 224 variants a block, 256 computed; K4: 64
#: variants x 4 app groups a block, apps staged 64 at a time), many apps,
#: and one full shard
EDGE_SHAPES = ((3, 223), (4, 224), (5, 225), (9, 449), (4, 63), (5, 65),
               (7, 255), (8, 256), (63, 64), (65, 62_501), (257, 4099),
               (1025, 62_501))
#: ... and of K2's: 16 apps x 256 variants a block
EDGE_SHAPES += ((15, 255), (16, 256), (17, 257))
#: phase 4's shard: K4's A x V on the main path
STATS_A, STATS_V = 64, 62_501
#: an issue slot a cycle on each of the 4 schedulers of each of the 132
#: SMs, at the 1.98 GHz boost clock: the rate of the instruction bound
ISSUE_PER_S = 132 * 4 * 1.98e9
#: the kernels whose per-cell SASS loop phase 1 counts: the instantiation
#: phase 5 times (serial timing, clamp on), the instruction that marks a
#: cell and how many of it a cell has (see ``cell_loop``)
SASS_LOOPS = {"congruence_k": ("ILb0ELb1E", "MUFU.RSQ", 1),
              "sweep_stats_k": ("ILb0ELb1E", "MUFU.RSQ", 1),
              "step_time_k": ("ILb0E", "MUFU.RCP", 4)}
SOURCE = "src/repro_torch/csrc/congruence.cu"
REPLACES = {
    "congruence": "src/repro/core/kernels_pallas.py:90",
    "step_time": "src/repro/core/kernels_pallas.py:104",
    "default_beta": "src/repro/core/kernels_pallas.py:109",
    "sweep_stats": "src/repro/core/kernels_pallas.py:332",
}
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_WGMMA_SOURCE = "src/repro_torch/csrc/flash_attention_sm90.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:30"
FA_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py
#: Phase 6's grid: the model path's shapes and its neighbours, with ragged
#: edges around both kernels' 128-row query tiles, the FMA kernel's 64-row
#: ones (head dims above 128) and 64-key tiles, and the tensor-core
#: kernel's 80-key tiles at head dim 256.
FA_BATCH = (1, 2)
FA_HEADS = ((4, 4), (8, 2), (32, 2))
FA_HEAD_DIM = (64, 128)
#: further bf16 head dims held on the same grid: 256 (paligemma-3b and
#: recurrentgemma-9b) on the tensor cores, 32 and 80 on the FMA kernel
FA_BF16_HEAD_DIM = (32, 80, 256)
#: bf16 head dims the route gives the tensor-core kernel
FA_WGMMA_HEAD_DIM = (64, 128, 256)
FA_SEQ = (1, 63, 64, 65, 79, 80, 81, 127, 128, 129, 159, 160, 161, 255, 256, 257, 2048)
#: paligemma-3b's attention (B 4, H 8, K 1, S = T 2048, D 256, causal),
#: timed in f32 (the FMA kernel) and bf16 (the tensor cores)
PALIGEMMA_FA = (4, 8, 1, 2048, 256)
#: the K5 shapes of phases 13-15's and 23's forwards, held and timed in
#: phase 6: (arch, B, H, K, S, D, window), bf16, causal
FAMILY_FA = (("qwen2-moe-a2.7b", 4, 16, 16, 2048, 128, None),
             ("recurrentgemma-9b", 4, 16, 1, 2048, 256, 2048),
             ("whisper-medium", 4, 16, 16, 448, 64, None),
             ("qwen3-32b", 4, 64, 8, 2048, 128, None),
             ("qwen1.5-4b", 4, 20, 20, 2048, 128, None))
#: The model path: chatglm3-6b, B x S tokens in bf16 compute; the decode
#: step is timed over a cache of DECODE_CACHE positions.
MODEL_ARCH, MODEL_B, MODEL_S, DECODE_CACHE = "chatglm3-6b", 4, 2048, 2048
HIDDEN_RTOL = 2e-2   # K5 vs plain attention, bf16, relative to max |hidden|
#: ... or this many times the plain bf16 path's own distance from the f32
#: forward, where bf16 rounding over 28 layers exceeds HIDDEN_RTOL
BF16_NOISE_FACTOR = 1.5
LOSS_ATOL = 1e-2
DECODE_RTOL = 1e-4   # f32 compute, tests/test_models.py
RMS_SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
RMS_REPLACES = {"rmsnorm": "src/repro/kernels/rmsnorm.py:18",
                "rmsnorm_residual": "src/repro/kernels/rmsnorm.py:25"}
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
RMS_ROWS = (1, 37, 256, 8192)
RMS_D = (64, 128, 4096)
SCAN_SOURCE = "src/repro_torch/csrc/selective_scan.cu"
SCAN_REPLACES = "src/repro/kernels/selective_scan.py:27"
SCAN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # tol_for, tests/test_kernels.py
CONV_SOURCE = "src/repro_torch/csrc/causal_conv.cu"
CONV_REPLACES = ("none: the JAX package's Mamba mixer runs its conv, bias and SiLU "
                 "as XLA operations")
#: the mixer's fused conv at the falcon-mamba-7b cells' (B, S): prefill_8k's
#: and prefill_batch's
CONV_SHAPES = ((1, 8192), (32, 2048))
#: ... with N not a multiple of the kernel's 4 lanes a channel and Din not
#: one of its 64 channels a CTA
SCAN_SHAPES = ((1, 1, 64, 4), (1, 32, 64, 4), (2, 64, 128, 8), (1, 48, 96, 16),
               (2, 37, 100, 5), (1, 70, 130, 1), (1, 33, 64, 13),
               (4, 2048, 8192, 16))
#: The SSM path: falcon-mamba-7b, B x S tokens in bf16 compute; the decode
#: step is timed after a prefill of SSM_DECODE_AFTER tokens.
SSM_ARCH, SSM_B, SSM_S, SSM_DECODE_AFTER = "falcon-mamba-7b", 4, 2048, 2048
#: exp / log on the special-function units: 16 per SM per clock on sm_90
#: (CUDA C++ Programming Guide, arithmetic instruction throughput), 132 SMs,
#: 1.98 GHz boost clock.  An assumption for the scan's bound, stated beside
#: the data sheet's f32 and HBM peaks above.
SFU_OPS_PER_S = 132 * 16 * 1.98e9


def attention_score_bytes(cfg, shape) -> float:
    """Bytes one layer of the plain attention (``models.layers._sdpa`` and
    its causal mask, ``attn_impl="xla"``, bf16 compute, T = S) moves in
    its (S x T) tensors, under the op counter's rule
    (``core.costs.OpCounter``: an operation reads each input and writes
    each output once; a matmul's q / k / v / context operands are linear
    in S and left out): what ``--mode flash`` removes a layer, counted by
    hand rather than fitted."""
    check(cfg.compute_dtype == "bfloat16" and not cfg.attn_logit_softcap
          and shape.kind in ("train", "prefill"),
          f"attention_score_bytes counts bf16 train / prefill scores, not "
          f"{cfg.name} {shape.kind}")
    B, S = shape.global_batch, shape.seq_len
    n = B * cfg.n_heads * S * S     # score elements: bf16 (c) or f32 (4)
    m = B * S * S                   # mask elements: bool, one byte
    c = 2
    forward = (m                    # ones
               + m                  # k_pos <= q_pos (the positions are linear)
               + 3 * m              # ones & causal
               + c * n              # Q K^T written
               + 2 * c * n          # * scale
               + (c + 4) * n        # .float()
               + 2 * m              # ~mask
               + 8 * n + m          # masked_fill
               + 8 * n              # softmax
               + (4 + c) * n        # .to(bf16)
               + 2 * c * n          # einsum's copy of P into (b, k, s, g, t)
               + c * n)             # P read by P V
    if shape.kind == "prefill":
        return float(forward)
    backward = (c * n               # P read by dV = P^T dO
                + c * n             # dP = dO V^T written
                + (c + 4) * n       # dP.float()
                + 12 * n            # softmax backward: dP, P, dS
                + 8 * n + m         # masked_fill backward
                + (4 + c) * n       # dS.to(bf16)
                + 2 * c * n         # * scale
                + c * n             # dS read by dK
                + c * n)            # dS read by dQ
    return float(forward + backward)


def scan_state_bytes_by_hand(cfg, shape) -> float:
    """Bytes proportional to the state dim N that one Mamba layer's decode
    step (``models.layers.mamba_apply`` with the plain ``_ssm_scan``, f32
    parameters, bf16 compute, one new token) moves under the op counter's
    rule, the step's arguments read once: what ``--mode scan`` removes a
    layer, counted by hand rather than measured from two probes."""
    check(cfg.param_dtype == "float32" and cfg.compute_dtype == "bfloat16"
          and shape.kind == "decode",
          f"scan_state_bytes_by_hand counts f32-parameter bf16 decode steps, not "
          f"{cfg.name} {shape.kind}")
    B, N = shape.global_batch, cfg.ssm.state_dim
    Din = cfg.ssm.expand * cfg.d_model
    w = Din * N                     # the N-wide columns of w_xdbc (B and C) and of A
    s = B * Din * N                 # the state and the discretised dA / dBx: f32
    v = B * N                       # the B and C projections of the new token
    arguments = (4 * 2 * w          # w_xdbc's B and C columns, f32
                 + 4 * w            # A_log
                 + 4 * s)           # the state cache
    ops = (6 * 2 * w                # w_xdbc.to(bf16)
           + 2 * 2 * w + 2 * 2 * v  # dbc = xi @ w_xdbc: the weight read, B and C written
           + 2 * 6 * v              # B and C .float()
           + 8 * w + 8 * w          # A = -exp(A_log)
           + 4 * w + 4 * s          # dt * A
           + 8 * s                  # dA = exp(.)
           + 4 * v + 4 * s          # dBx = (dt x) * B
           + 20 * s                 # h = addcmul(dBx, dA, h, out=hs): five f32 (B, Din, N)
           + 4 * s + 4 * v          # y = einsum(hs, C)
           + 12 * s)                # state["ssm"].copy_(hT)
    return float(arguments + ops)


class Failure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# Operation and byte counts for the bounds (per the card's published peaks)
# --------------------------------------------------------------------------- #

# float32 operations per (app, variant) cell, counting each add, multiply,
# division, square root, comparison and max as one (a division or square
# root costs the card several instructions, so the operation bound is a
# floor): raw terms 7, scaling 3, gamma 2, three alphas 9, three Eq. 1
# scores 15, clamp 6, aggregate 6.
def _cell_ops(clamp: bool) -> int:
    return 42 + (6 if clamp else 0)


def bound(kind: str, a: int, v: int, clamp: bool = True):
    """(bound_ms, bound_by) for one call at (A, V)."""
    f32 = 4
    if kind == "congruence":
        nbytes = (7 * a + 8 * v + 8 * a * v) * f32
        ops = _cell_ops(clamp) * a * v
    elif kind == "step_time":
        nbytes = (6 * a + 8 * v + a * v) * f32
        ops = 12 * a * v
    elif kind == "default_beta":
        nbytes = (6 * a + 8 + a) * f32
        ops = 18 * a
    else:  # sweep_stats: + the running sum and the min comparison per cell
        nbytes = (7 * a + 8 * v + v + a) * f32 + 8 * a
        ops = (_cell_ops(clamp) + 2) * a * v
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(log: str):
    """ptxas's ``-v`` report as {entry function: {registers, stack,
    spill_stores, spill_loads}} (bytes, registers a thread)."""
    import re

    out, entry, fn = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = fn = m.group(1)
            out.setdefault(entry, {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn in out:
            out[fn].update(stack=int(m[1]), spill_stores=int(m[2]),
                           spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry]["registers"] = int(m[1])
    return out


def fma_instantiations(report):
    """The FMA K5 kernel's instantiations in a ``ptxas_report``, by
    (dtype, padded head dim)."""
    import re

    found = {}
    for fn, props in report.items():
        m = re.search(r"17flash_attention_kI(f|13__nv_bfloat16)Li(\d+)E", fn)
        if m:
            found[("float32" if m[1] == "f" else "bfloat16", int(m[2]))] = props
    return found


def sm90_instantiations(report):
    """The tensor-core K5 kernel's instantiations in a ``ptxas_report``, by
    head dim."""
    import re

    found = {}
    for fn, props in report.items():
        m = re.search(r"22flash_attention_sm90_kILi(\d+)E", fn)
        if m:
            found[int(m[1])] = props
    return found


def sass_functions(sass: str):
    """``cuobjdump -sass`` text as {function: [(address, instruction)]}."""
    import re

    fns, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fns[fn] = []
        elif fn is not None:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                fns[fn].append((int(m.group(1), 16), m.group(2)))
    return fns


def cell_loop(instrs, marker="MUFU.RSQ", per_cell=1):
    """(instructions a cell, loop length, cells an iteration) of the
    innermost loop that computes cells: the backward branch with no loop
    inside it whose body holds the most ``marker`` instructions, of which a
    cell has ``per_cell`` (K1 and K4: one ``MUFU.RSQ``, the aggregate's
    square root; K2: four ``MUFU.RCP``, its IEEE divisions); None when no
    such loop is found.  The count
    is the fast path's: instructions that a predicated forward branch skips
    on its way past a ``CALL`` with no ``MUFU`` between (a division's or
    square root's slow path, for denormals and range edges) are left out."""
    import re

    loops, slow = [], []
    for addr, text in instrs:
        m = re.search(r"\bBRA\s+\S*?(0x[0-9a-f]+)", text)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target <= addr:
            loops.append((target, addr))
        else:
            skipped = [t for a, t in instrs if addr < a < target]
            if (text.startswith("@") and any("CALL" in t for t in skipped)
                    and not any("MUFU" in t for t in skipped)):
                slow.append((addr, target))
    best = None
    for lo, hi in loops:
        if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi) for l2, h2 in loops):
            continue
        body = [t for a, t in instrs if lo <= a <= hi
                and not any(s0 < a < s1 for s0, s1 in slow)]
        cells = sum(marker in t for t in body) / per_cell
        if cells and (best is None or cells > best[2]):
            best = (len(body) / cells, len(body), cells)
    return best


def issue_bound_ms(instr_per_cell: float, cells: int) -> float:
    """The instruction bound: a cell's SASS instructions, each issued for
    32 lanes at a time by one of the card's schedulers a cycle."""
    return instr_per_cell * cells / (ISSUE_PER_S * 32) * 1e3


# --------------------------------------------------------------------------- #
# Inputs
# --------------------------------------------------------------------------- #


def stacks(torch, core, a: int, v: int, seed: int, dtype, dev):
    """(7, A) profile+beta and (8, V) machine stacks from the port's own
    generators, with degenerate cells: app 0 moves no bytes and does no
    work (gamma == beta == 0), app 1 has no pod traffic, app 2 has no
    model FLOPs (the invalid-beta branch)."""
    import numpy as np
    from repro_torch.core import kernels_xp as K

    pb = core.AppSpace.default().sample(a, seed=seed)
    if a >= 3:
        pb.flops[0] = pb.mem_bytes[0] = 0.0
        pb.collective_bytes[0] = pb.pod_collective_bytes[0] = 0.0
        pb.pod_collective_bytes[1] = 0.0
        pb.model_flops[2] = 0.0
    mb = core.ParamSpace.scale_space().sample(v, seed=seed)
    beta = K.default_beta_kernel(
        np, pb.arrays(), core.MachineBatch.from_models([core.TPU_V5E]).arrays())
    p = np.stack(list(pb.arrays()) + [beta])
    m = np.stack(list(mb.arrays()))
    as_t = lambda x: torch.as_tensor(x.astype(np.float32)).to(dev, dtype)
    return as_t(p), as_t(m)


# --------------------------------------------------------------------------- #
# Phase 2: each kernel against its plain version on the card
# --------------------------------------------------------------------------- #


def conditioned(xp, gamma, beta, alphas):
    """Cells where Eq. 1 is well conditioned (see ``COND_LIMIT``)."""
    scale = abs(gamma) + abs(beta[:, None]) + xp.maximum(
        xp.maximum(abs(alphas[0]), abs(alphas[1])), abs(alphas[2]))
    return ~(scale > COND_LIMIT * abs(gamma - beta[:, None]))


def _close(torch, got, want, what, mask=None):
    want = want.to(torch.float32)
    err = (got - want).abs()
    lim = TOL + TOL * want.abs()
    bad = ~((err <= lim) | (torch.isnan(got) & torch.isnan(want)))
    if mask is not None:
        bad &= mask
    if bool(bad.any()):
        raise Failure(f"{what}: {int(bad.sum())} cells off by more than "
                      f"{TOL} (max abs err {float(err[bad].max()):.3e})")
    finite = torch.isfinite(err)
    return float(err[finite].max()) if bool(finite.any()) else 0.0


def _exact(torch, got, want, what):
    """``got`` equal to ``want`` in every cell, NaN where it is NaN: the
    kernels round every operation as their plain float32 versions do.
    Returns the max abs error, 0.0."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not bool(same.all()):
        err = (got - want).abs()[~same]
        raise Failure(f"{what}: {int((~same).sum())} cells differ from the "
                      f"plain float32 version (max abs err {float(err.max()):.3e})")
    return 0.0


def check_stats(torch, got, want, what):
    """K4 against the plain statistics of the same float32 aggregate."""
    (mean, mins, idx), (pmean, pmins, pidx), agg = got, want[:3], want[3]
    merr = (mean - pmean).abs()
    both_nan = torch.isnan(mean) & torch.isnan(pmean)
    finite = merr[~both_nan]
    merr_max = float(finite.max()) if finite.numel() else 0.0
    check(bool(((merr <= MEAN_RTOL * pmean.abs() + 1e-7) | both_nan).all()),
          f"{what}: means off by {merr_max:.3e}")
    err = _close(torch, mins, pmins, f"{what} minima")
    for a in range(agg.shape[0]):
        row = agg[a]
        if int(idx[a]) == int(pidx[a]):
            continue
        top2 = torch.topk(row, min(2, row.numel()), largest=False).values
        gap = float(top2[1] - top2[0]) if top2.numel() > 1 else float("inf")
        check(gap <= TOL, f"{what}: app {a} argmin {int(idx[a])} != "
                          f"{int(pidx[a])} with a clear minimum (gap {gap:.3e})")
        check(float(row[int(idx[a])]) <= float(top2[0]) + TOL,
              f"{what}: app {a} argmin column is not within {TOL} of the min")
    return max(err, merr_max)


def check_reduction(torch, K, got, agg, what):
    """K4's reduction against the plain reduction of K1's aggregate on the
    same stacks (the kernels share the per-cell arithmetic): argmin and
    minimum exact, means to ``MEAN_RTOL`` (a different summation order)."""
    mean, mins, idx = got
    pmean, pmins, pidx = K.sweep_stats_plain(agg)
    bad = int((idx != pidx).sum())
    check(bad == 0, f"{what}: {bad} argmins differ from the reduction of K1's "
                    f"aggregate (first: app {int((idx != pidx).nonzero()[0, 0]) if bad else -1})")
    same = (mins == pmins) | (torch.isnan(mins) & torch.isnan(pmins))
    check(bool(same.all()), f"{what}: minima differ from K1's aggregate")
    both_nan = torch.isnan(mean) & torch.isnan(pmean)
    check(bool((((mean - pmean).abs() <= MEAN_RTOL * pmean.abs() + 1e-7)
                | both_nan).all()), f"{what}: means off K1's aggregate")


def phase_kernels(torch, core, KC, dev):
    from repro_torch.core import kernels_xp as K

    errs = {k: 0.0 for k in REPLACES}
    n = masked = 0
    shapes = [(a, v) for a in SHAPES_A for v in SHAPES_V] + list(EDGE_SHAPES)
    for a, v in shapes:
        p32, m32 = stacks(torch, core, a, v, seed=a + v, dtype=torch.float32, dev=dev)
        p64, m64 = p32.double(), m32.double()
        for tm in ("serial", "overlap"):
            tag = f"A={a} V={v} {tm}"
            got = KC.step_time(p32[:6].contiguous(), m32, tm)
            errs["step_time"] = max(errs["step_time"], _exact(
                torch, got, KC.plain_step_time(p32, m32, tm), f"K2 {tag} f32"))
            _close(torch, got, KC.plain_step_time(p64, m64, tm), f"K2 {tag} f64")
            for clamp in (False, True):
                tag2 = f"{tag} clamp={clamp}"
                got = KC.congruence(p32, m32, tm, clamp=clamp)
                plain = KC.plain_congruence(p32, m32, tm, clamp=clamp)
                errs["congruence"] = max(errs["congruence"], _exact(
                    torch, got, plain, f"K1 {tag2} f32"))
                want = KC.plain_congruence(p64, m64, tm, clamp=clamp)
                ok = conditioned(torch, want[0], p64[6], want[1:4])
                masked += int((~ok).sum())
                _close(torch, got, want, f"K1 {tag2} f64",
                       torch.cat([torch.ones_like(want[:4], dtype=torch.bool),
                                  ok.expand(4, *ok.shape)]))
                del want, ok
                stats = KC.sweep_stats(p32, m32, tm, clamp)
                check_reduction(torch, K, stats, got[7], f"K4 {tag2}")
                errs["sweep_stats"] = max(errs["sweep_stats"], check_stats(
                    torch, stats, (*K.sweep_stats_plain(plain[7]), plain[7]),
                    f"K4 {tag2}"))
                n += 1
        got = KC.default_beta(p32[:6].contiguous(), m32)
        errs["default_beta"] = max(errs["default_beta"], _exact(
            torch, got, KC.plain_default_beta(p32, m32), f"K3 A={a} V={v} f32"))
        _close(torch, got, KC.plain_default_beta(p64, m64), f"K3 A={a} V={v} f64")
    torch.cuda.synchronize()
    log(f"phase 2: K1-K4 match their plain versions (f32 and f64) on {n} "
        f"configurations ({len(shapes)} (A, V) shapes x 2 timing models x clamp "
        f"off / on; max abs err vs f32: {json.dumps(errs)}; K1-K3 equal to "
        f"it in every cell, NaN included); {masked} "
        "ill-conditioned Eq. 1 cells left out of the f64 check; K4's argmins "
        "and minima equal the reduction of K1's own aggregate on every one")

    # K4 on phase 4's shard with NaN aggregates (a NaN peak rate in three
    # variant columns; then also a NaN beta in two apps, whose rows are all
    # NaN) and with every variant alike
    p32, m32 = stacks(torch, core, STATS_A, STATS_V, seed=11, dtype=torch.float32, dev=dev)
    nan_cols = [2 * STATS_V // 3, 2 * STATS_V // 3 + 1, STATS_V - 1]
    nan_apps = [3, 17]
    m_nan = m32.clone()
    m_nan[0, nan_cols] = float("nan")
    p_nan = p32.clone()
    p_nan[6, nan_apps] = float("nan")
    m_same = m32[:, :1].expand(-1, STATS_V).contiguous()
    first_nan = torch.full((STATS_A,), nan_cols[0], dtype=torch.long, device=dev)
    nan_rows = first_nan.clone()
    nan_rows[nan_apps] = 0
    zeros = torch.zeros(STATS_A, dtype=torch.long, device=dev)
    for name, p, m, expect in (("NaN columns", p32, m_nan, first_nan),
                               ("NaN columns and rows", p_nan, m_nan, nan_rows),
                               ("identical variants", p32, m_same, zeros)):
        for tm in ("serial", "overlap"):
            for clamp in (False, True):
                tag = f"K4 {name} A={STATS_A} V={STATS_V} {tm} clamp={clamp}"
                agg = KC.congruence(p, m, tm, clamp=clamp)[7]
                stats = KC.sweep_stats(p, m, tm, clamp)
                check_reduction(torch, K, stats, agg, tag)
                check_stats(torch, stats, (*KC.plain_sweep_stats(p, m, tm, clamp),
                                           KC.plain_congruence(p, m, tm, clamp=clamp)[7]),
                            tag)
                check(bool((stats[2] == expect).all()),
                      f"{tag}: argmins {stats[2].tolist()} != {expect.tolist()}")
    log(f"phase 2: K4 on a {STATS_A} x {STATS_V} shard with NaN aggregates takes "
        f"the first NaN (variant {nan_cols[0]}; variant 0 in all-NaN rows "
        f"{nan_apps}), and with {STATS_V} identical variants index 0 in every "
        "app, across all blocks")
    return errs


# --------------------------------------------------------------------------- #
# Phases 3 and 4: the main path
# --------------------------------------------------------------------------- #


def fronts_agree(names_a, names_b, area, agg, tol=TOL):
    """Two 2-D fronts name the same variants, up to near-ties: a variant
    on one front only must be within ``tol`` (in ``agg``) of a point of the
    other front at no larger area."""
    if names_a == names_b:
        return True
    for mine, other in ((names_a, names_b), (names_b, names_a)):
        for name in set(mine) - set(other):
            if not any(area[o] <= area[name] and agg[o] <= agg[name] + tol
                       for o in other):
                return False
    return True


def best_fits_agree(kernel_res, plain_res, tol=TOL):
    """Per-app best fits equal, or within ``tol`` under the plain scores."""
    kb, pb = kernel_res.best_fit_indices(), plain_res.best_fit_indices()
    for a in range(len(kb)):
        if kb[a] != pb[a]:
            row = plain_res.aggregate[a]
            if row[kb[a]] > row[pb[a]] + tol:
                return False
    return True


def _front_maps(res):
    area = dict(zip(res.machines.names, res.area()))
    agg = dict(zip(res.machines.names, res.aggregate_mean()))
    return [res.machines.names[i] for i in res.pareto_front()], area, agg


def phase_run_sweep(torch, core, KC, dev):
    import numpy as np

    profiles = core.resolve_suite("gen:64")
    KC.reset_launch_counts()
    t0 = time.perf_counter()
    res = core.run_sweep(profiles, n=100_000, include_named=core.VARIANTS,
                         device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    front, front3 = res.pareto_front(), res.pareto_front_3d()
    best = res.best_fit_indices()
    pareto_ms = (time.perf_counter() - t0) * 1e3
    steps = core.batched_step_time(profiles, res.machines, device=dev)
    table = core.evaluate(profiles, variants=core.VARIANTS, device=dev)
    cell = table.cell(profiles[0].name, "baseline")
    counts = KC.launch_counts()
    log(f"phase 3: run_sweep gen:64 x {len(res.machines)} on {dev}: "
        f"{sweep_s:.3f} s, {64 * len(res.machines) / sweep_s:.4g} cells/s; "
        f"host Pareto + best fits {pareto_ms:.1f} ms; launches {counts}")
    check(counts["congruence"] > 0 and counts["default_beta"] > 0
          and counts["step_time"] > 0, f"main path missed a kernel: {counts}")
    check(res.backend == "cuda", f"run_sweep ran on {res.backend}")
    check(res.aggregate.shape == (64, 100_003), f"shape {res.aggregate.shape}")
    check(bool(np.isfinite(res.aggregate).all() and np.isfinite(steps).all()
               and steps.shape == res.aggregate.shape), "bad sweep outputs")
    check(len(front) > 0 and len(front3) > 0 and len(best) == 64,
          "empty Pareto front")
    check(math.isfinite(cell.aggregate) and len(table.variants) == 3,
          "bad evaluate table")

    plain32 = core.run_sweep(profiles, n=100_000, include_named=core.VARIANTS,
                             backend=core.TorchBackend(dev, torch.float32))
    plain64 = core.run_sweep(profiles, n=100_000, include_named=core.VARIANTS,
                             backend=core.TorchBackend(dev, torch.float64))
    ok = conditioned(np, plain64.gamma, plain64.beta,
                     list(plain64.alphas.values()))
    diff = abs(res.aggregate - plain64.aggregate)[ok]
    err = float(diff.max())
    check(bool((diff <= TOL + TOL * abs(plain64.aggregate[ok])).all()),
          f"run_sweep aggregate off the float64 plain sweep by {err:.3e}")
    check(best_fits_agree(res, plain32), "best fits differ from plain f32")
    names_k, area, agg = _front_maps(res)
    names_p, _, agg_p = _front_maps(plain32)
    check(fronts_agree(names_k, names_p, area, agg_p),
          f"2-D fronts differ: {names_k} vs {names_p}")
    log(f"phase 3: best fits and 2-D front ({len(names_k)} variants) match "
        f"the plain f32 sweep; aggregate within {err:.3e} of plain f64 "
        f"({int((~ok).sum())} ill-conditioned cells left out)")
    return dict(profiles=profiles, result=res, counts=counts,
                seconds=sweep_s, pareto_ms=pareto_ms)


def phase_shard_sweep(torch, core, KC, dev, profiles):
    KC.reset_launch_counts()
    t0 = time.perf_counter()
    sh = core.shard_sweep(profiles, n=1_000_000, include_named=core.VARIANTS,
                          stream=True, device=dev)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    counts = KC.launch_counts()
    cells = 64 * sh.num_variants
    log(f"phase 4: streamed shard_sweep gen:64 x {sh.num_variants} in "
        f"{sh.num_shards} shards on {sh.mesh_axis}: {shard_s:.3f} s, "
        f"{cells / shard_s:.4g} cells/s; {len(sh.result.machines)} "
        f"candidates; launches {counts}")
    check(sh.num_shards == 16, f"expected 16 shards, got {sh.num_shards}")
    check(counts["sweep_stats"] == sh.num_shards,
          f"K4 launches {counts['sweep_stats']} != shards {sh.num_shards}")
    check(counts["congruence"] > 0 and counts["default_beta"] > 0,
          f"shard_sweep missed a kernel: {counts}")
    plain = core.shard_sweep(profiles, n=1_000_000,
                             include_named=core.VARIANTS, stream=True,
                             backend=core.TorchBackend(dev, torch.float32))
    names_k, area, agg = _front_maps(sh.result)
    area_p, agg_p = _front_maps(plain.result)[1:]
    area.update(area_p)
    check(fronts_agree(sh.pareto_names(), plain.pareto_names(), area,
                       {**agg, **agg_p}),
          f"2-D fronts differ: {sh.pareto_names()} vs {plain.pareto_names()}")
    for app in sh.apps:
        k, p = sh.best_fit(app), plain.best_fit(app)
        if k != p:
            row = dict(zip(plain.result.machines.names,
                           plain.result.aggregate[plain.apps.index(app)]))
            check(k in row and row[k] <= row[p] + TOL,
                  f"best fit of {app}: {k} vs {p}")
    log(f"phase 4: best fits and 2-D front ({len(names_k)} variants) match "
        f"the plain f32 shard_sweep")

    # checkpoint kill/resume round trip at a small population
    ck = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(n=4096, include_named=core.VARIANTS, stream=True, num_shards=8,
              device=dev, checkpoint_dir=ck)

    class Kill(Exception):
        pass

    def die_after_2(s, *_):
        if s >= 2:
            raise Kill

    try:
        core.shard_sweep(profiles, progress=die_after_2, **kw)
        raise Failure("the kill hook did not fire")
    except Kill:
        pass
    resumed = core.shard_sweep(profiles, resume=True, **kw)
    straight = core.shard_sweep(profiles, n=4096, include_named=core.VARIANTS,
                                stream=True, num_shards=8, device=dev)
    shutil.rmtree(ck, ignore_errors=True)
    check(resumed.resumed_shards == 3, f"resumed {resumed.resumed_shards}")
    check((resumed.candidate_indices == straight.candidate_indices).all()
          and (resumed.result.aggregate == straight.result.aggregate).all()
          and resumed.pareto_names() == straight.pareto_names()
          and resumed.best_fit_map == straight.best_fit_map,
          "resumed shard_sweep differs from an uninterrupted one")
    log("phase 4: kill after shard 3/8 + resume == uninterrupted run")
    return dict(result=sh, counts=counts, seconds=shard_s, cells=cells)


# --------------------------------------------------------------------------- #
# Phase 5: timings
# --------------------------------------------------------------------------- #


def cuda_ms(torch, fn, reps=10, rounds=5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(torch, fn, n=200) -> float:
    """Host microseconds a call of ``fn`` takes to return (launches are
    asynchronous), over ``n`` calls after a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def cold_ms(torch, fn, flush, n=20) -> float:
    """Median time by CUDA events of one call of ``fn`` enqueued right
    after ``flush`` (which evicts the L2), the events around that call
    alone; the flush runs long enough on the device for the host to
    enqueue the call before it ends."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms_median(torch, fn, n=200) -> float:
    """Median host milliseconds of one call of ``fn`` over ``n`` calls, each
    ending where ``fn`` returns (a call that copies its result to the host
    waits for the device)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def in_turns(measures):
    """Each named measurement run twice, in the order A, B, ..., B, A, and
    the mean of its two readings: a drift of the card or the host over the
    window weighs on all of them alike."""
    names = list(measures)
    got = {k: [] for k in names}
    for k in names + names[::-1]:
        got[k].append(measures[k]())
    return {k: sum(v) / len(v) for k, v in got.items()}


#: the L2 flush of the cold timings: 256 MB, five times the 50 MB L2
FLUSH_BYTES = 256 << 20
#: K1's device time before this kernel set (PERF.md's K1 row, the
#: whole-line design's own figure), which phase 5 prints beside its own
K1_EARLIER_DEVICE_MS = 0.0772

#: the device kernels of each sweep wrapper, by the name the profiler gives
DEVICE_KERNELS = {"congruence": ("congruence_k",),
                  "step_time": ("step_time_k",),
                  "default_beta": ("default_beta_k",),
                  "sweep_stats": ("sweep_stats_k", "stats_merge_k")}


def phase_timings(torch, core, KC, dev, p3, sass_loops):
    import numpy as np

    res = p3["result"]
    pb = core.ProfileBatch.from_profiles(p3["profiles"])
    p_stack = torch.as_tensor(np.stack(
        [np.asarray(r, np.float32) for r in list(pb.arrays()) + [res.beta]])).to(dev)
    m_stack = torch.as_tensor(np.stack(
        [np.asarray(r, np.float32) for r in res.machines.arrays()])).to(dev)
    from repro_torch.core.sweep import _shard_bounds

    # the first shard of phase 4's streamed population
    stream = core.PopulationStream(core.ParamSpace.default(), 1_000_000,
                                   include_named=core.VARIANTS)
    lo, hi = _shard_bounds(len(stream), 16)[0]
    m_shard = torch.as_tensor(np.stack(
        [np.asarray(r, np.float32)
         for r in stream.batch(lo, hi).arrays()])).to(dev)
    a, v, vs = p_stack.shape[1], m_stack.shape[1], m_shard.shape[1]
    p6 = p_stack[:6].contiguous()
    # the (8, 1) reference column, made once: K3's call as the main path
    # makes it launches K3 alone
    m_ref = m_stack[:, :1].contiguous()
    runs = {
        "congruence": ((a, v), lambda: KC.congruence(p_stack, m_stack, clamp=True),
                       lambda: KC.plain_congruence(p_stack, m_stack, clamp=True)),
        "step_time": ((a, v), lambda: KC.step_time(p6, m_stack),
                      lambda: KC.plain_step_time(p6, m_stack)),
        "default_beta": ((a, 1), lambda: KC.default_beta(p6, m_ref),
                         lambda: KC.plain_default_beta(p6, m_ref)),
        "sweep_stats": ((a, vs), lambda: KC.sweep_stats(p_stack, m_shard, clamp=True),
                        lambda: KC.plain_sweep_stats(p_stack, m_shard, clamp=True)),
    }
    rows = {}
    for name, ((ra, rv), kern, plain) in runs.items():
        ms = cuda_ms(torch, kern)
        plain_ms = cuda_ms(torch, plain)
        bound_ms, bound_by = bound(name, ra, rv)
        device = {k: device_us(torch, kern, k) for k in DEVICE_KERNELS[name]}
        device_ms = sum(device.values()) / 1e3
        host = host_us(torch, kern)
        rows[name] = dict(shape=[ra, rv], ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          device_ms=device_ms, host_us=host)
        extra = {}
        if name == "congruence":
            extra["earlier_device_ms"] = K1_EARLIER_DEVICE_MS
            extra["device_ms_over_earlier"] = device_ms / K1_EARLIER_DEVICE_MS
        kernel = DEVICE_KERNELS[name][0]
        if sass_loops.get(kernel):
            instr = sass_loops[kernel][0]
            extra["instruction_bound_ms"] = issue_bound_ms(instr, ra * rv)
            extra["sass_instructions_a_cell"] = instr
            extra["device_share_of_instruction_bound"] = (
                extra["instruction_bound_ms"] / device_ms)
            rows[name]["instruction_bound_ms"] = extra["instruction_bound_ms"]
        log(json.dumps({"timing": name, "A": ra, "V": rv, "ms": ms,
                        "device_us": device, "device_ms": device_ms,
                        "host_us_a_call": host,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "device_share_of_bound": bound_ms / device_ms,
                        **extra, "library_ms": None,
                        "library": "none: no single PyTorch call computes "
                                   "this function"}))
    # K1's output written by the card's own fill: a ceiling for its stores
    # (no PyTorch call computes K1's function, so no library time)
    out = torch.empty((8, a, v), dtype=torch.float32, device=dev)
    fill_ms = cuda_ms(torch, lambda: out.fill_(0.0))
    log(json.dumps({"ceiling": "fill_ of K1's output", "shape": list(out.shape),
                    "bytes": out.numel() * 4, "ms": fill_ms,
                    "tb_per_s": out.numel() * 4 / fill_ms / 1e9,
                    "k1_share_of_fill_rate": fill_ms / rows["congruence"]["ms"]}))
    del out
    phase_k2_k3(torch, core, KC, dev, p3, rows, p6, m_stack, m_ref, sass_loops)
    out = KC.congruence(p_stack, m_stack, clamp=True)
    torch.cuda.synchronize()
    d2h = []
    for _ in range(5):
        t0 = time.perf_counter()
        out.cpu()
        d2h.append((time.perf_counter() - t0) * 1e3)
    log(json.dumps({"end_to_end": "run_sweep", "A": a, "V": v,
                    "seconds": p3["seconds"],
                    "cells_per_s": a * v / p3["seconds"],
                    "d2h_ms_8xAxV": statistics.median(d2h),
                    "host_pareto_ms": p3["pareto_ms"]}))
    return rows


def phase_k2_k3(torch, core, KC, dev, p3, rows, p6, m_stack, m_ref, sass_loops):
    """Phase 5's K2 and K3 lines: K2 warm and cold beside its bounds and
    the fill_ ceilings of its output; K3 beside the launch floor; the
    backend's beta call."""
    a, v = p6.shape[1], m_stack.shape[1]
    # an int32 flush: its fill kernel's name differs from a float fill's
    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    flush = lambda: flush_buf.fill_(1)
    # K2 back to back (its 25.6 MB output stays in the 50 MB L2) and cold
    # (a 256 MB fill_ between launches, as after K1's 205 MB on the main
    # path); the flush kernel has another name, so device_us isolates K2
    k2 = lambda: KC.step_time(p6, m_stack)
    name = DEVICE_KERNELS["step_time"][0]
    k2_row = rows["step_time"]
    warm = device_us(torch, k2, name)
    cold = device_us(torch, k2, name, between=flush)
    log(json.dumps({
        "k2": "warm and cold", "kernel": name, "A": a, "V": v,
        "device_us_warm": warm, "device_us_cold": cold,
        "event_ms_warm": k2_row["ms"], "event_ms_cold": cold_ms(torch, k2, flush),
        "host_us_a_call": k2_row["host_us"], "bytes_bound_ms": k2_row["bound_ms"],
        "instruction_bound_ms": k2_row.get("instruction_bound_ms"),
        "cold_device_share_of_bytes_bound": k2_row["bound_ms"] / (cold / 1e3)}))
    # the card's own fill_ of K2's exact output: a ceiling for its stores,
    # not a library time (no PyTorch call computes K2's function)
    out2 = torch.empty((a, v), dtype=torch.float32, device=dev)
    fill2 = lambda: out2.fill_(0.0)
    fill_warm, fill_cold = cuda_ms(torch, fill2), cold_ms(torch, fill2, flush)
    try:
        fill_dev = {"device_us_warm": device_us(torch, fill2, "FillFunctor<float>"),
                    "device_us_cold": device_us(torch, fill2, "FillFunctor<float>",
                                                between=flush)}
    except Failure as exc:   # the profiler names the fill otherwise
        fill_dev = {"device_us": f"not measured: {exc}"}
    log(json.dumps({
        "ceiling": "fill_ of K2's output", "shape": [a, v],
        "bytes": out2.numel() * 4, "ms_warm": fill_warm, "ms_cold": fill_cold,
        **fill_dev, "tb_per_s_cold": out2.numel() * 4 / fill_cold / 1e9,
        "k2_cold_device_share_of_fill_cold": fill_cold / (cold / 1e3)}))
    del out2, flush_buf

    # K3 beside the least launch, each through its wrapper, in turns
    floor = lambda: KC.launch_floor(p6, m_ref)
    k3 = lambda: KC.default_beta(p6, m_ref)
    got = {}
    for what, measure in (("device_us", lambda f, n: device_us(torch, f, n)),
                          ("cuda_ms", lambda f, n: cuda_ms(torch, f)),
                          ("host_us", lambda f, n: host_us(torch, f))):
        got[what] = in_turns({
            "launch_floor": lambda: measure(floor, "launch_floor_k"),
            "default_beta": lambda: measure(k3, DEVICE_KERNELS["default_beta"][0])})
    log(json.dumps({"launch_floor": "one block of 32 threads writing one "
                    "float, through a wrapper shaped like K3's", "A": a,
                    **{f"{k}_{w}": got[w][k] for w in got for k in got[w]},
                    "k3_over_floor": {w: got[w]["default_beta"] / got[w]["launch_floor"]
                                      for w in got}}))

    # K3 as the main path calls it: the backend's beta on the phase-3
    # suite and reference column, by a host clock ending in the D2H
    be = KC.CudaBackend(dev)
    pb = core.ProfileBatch.from_profiles(p3["profiles"])
    p_rows, ref = pb.arrays(), p3["result"].machines.select(0).arrays()
    call_ms = host_ms_median(torch, lambda: be.default_beta(p_rows, ref))
    log(json.dumps({"backend_beta": "CudaBackend.default_beta", "A": a,
                    "host_ms_median_of_200": call_ms}))


# --------------------------------------------------------------------------- #
# Phase 6: K5 (flash attention) against its plain version, and its timing
# --------------------------------------------------------------------------- #


def attention_work(B, H, K, S, T, D, causal, window, itemsize):
    """(bytes, operations) one attention call needs: q, k, v read once and
    the output written once; 4 D operations (two multiply-adds) for each
    live (query, key) pair of this mask."""
    import numpy as np

    i = np.arange(S)
    hi = np.minimum(T, i + 1) if causal else np.full(S, T)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(S, int)
    pairs = int(np.maximum(hi - lo, 0).sum())
    nbytes = (2 * B * H * S * D + 2 * B * K * T * D) * itemsize
    return nbytes, 4 * D * pairs * B * H


def attention_bound(B, H, K, S, T, D, causal, window, dtype_name):
    nbytes, ops = attention_work(B, H, K, S, T, D, causal, window,
                                 2 if dtype_name == "bfloat16" else 4)
    peak = BF16_OPS_PER_S if dtype_name == "bfloat16" else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fa_check(torch, FA, q, k, v, causal, window, what):
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    want = FA.plain_flash_attention(q, k, v, causal=causal, window=window)
    tol = FA_TOL[str(q.dtype).split(".")[-1]]
    err = (got.float() - want.float()).abs()
    lim = tol + tol * want.float().abs()
    bad = ~(err <= lim)
    if bool(bad.any()):
        raise Failure(f"K5 {what}: {int(bad.sum())} values off by more than "
                      f"{tol} (max abs err {float(err.max()):.3e})")
    check(got.shape == q.shape and got.dtype == q.dtype, f"K5 {what}: output")
    return float(err.max()) if err.numel() else 0.0


def _wants_wgmma(q, k, v) -> bool:
    """What the wrapper's route gives phase 6's tensors: bf16 at head dim 64,
    128 or 256 with 16-byte-aligned bases (their strides are multiples of 8
    elements and the scale is positive)."""
    return (str(q.dtype) == "torch.bfloat16" and q.shape[-1] in FA_WGMMA_HEAD_DIM
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _fma_kernel_causal(torch, q, k, v):
    """The FMA K5 kernel (register-tiled, cp.async-staged), called through
    the library itself, on tensors the route gives the tensor cores: timed
    on the same bf16 inputs, for the record (causal, no window, the default
    scale)."""
    from repro_torch.core import _build

    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _build.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, K, S, T, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        1, 0, 0, 1.0 / math.sqrt(D), 1 if q.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"the FMA K5 kernel's launch failed: cudaError {err}")
    return out


def phase_flash_attention(torch, FA, dev):
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # max abs err and configurations, by (kernel, dtype)
    errs, n = {}, {}

    def held(q, k, v, causal, window, what):
        before = FA.flash_attention.launches_wgmma
        err = _fa_check(torch, FA, q, k, v, causal, window, what)
        kernel = "wgmma" if FA.flash_attention.launches_wgmma > before else "fma"
        want = "wgmma" if _wants_wgmma(q, k, v) else "fma"
        check(kernel == want, f"K5 {what}: took the {kernel} kernel, not {want}")
        key = (kernel, str(q.dtype).split(".")[-1])
        errs[key] = max(errs.get(key, 0.0), err)
        n[key] = n.get(key, 0) + 1

    grid = [(dtype, D) for dtype in (torch.float32, torch.bfloat16) for D in FA_HEAD_DIM]
    grid += [(torch.bfloat16, D) for D in FA_BF16_HEAD_DIM]
    for dtype, D in grid:
        for B in FA_BATCH:
            for H, K in FA_HEADS:
                cases = [(S, S, True, w) for S in FA_SEQ
                         for w in (None, 64)] + [(127, 300, False, None)]
                for S, T, causal, window in cases:
                    q = rand(B, H, S, D, dtype=dtype)
                    k, v = rand(B, K, T, D, dtype=dtype), rand(B, K, T, D, dtype=dtype)
                    held(q, k, v, causal, window,
                         f"{dtype} B={B} H={H} K={K} D={D} S={S} T={T} "
                         f"causal={causal} window={window}")
    # the models' layouts: (B, S, H, D) projections as transposed views, at
    # recurrentgemma-9b's D 256 (H 16, K 1) and chatglm3-6b's D 128 (H 32,
    # K 2); each one element past a 16-byte boundary, which TMA cannot take,
    # then aligned (chatglm3-6b's last: phase 6 times its tensors)
    def model_layout(heads, D, offset):
        flat = rand(MODEL_B * MODEL_S * heads * D + offset, dtype=torch.bfloat16)
        return flat[offset:].view(MODEL_B, MODEL_S, heads, D).transpose(1, 2)

    for H, K, D in ((16, 1, 256), (32, 2, 128)):
        for offset in (1, 0):
            q = model_layout(H, D, offset)
            k, v = model_layout(K, D, offset), model_layout(K, D, offset)
            held(q, k, v, True, None,
                 f"model layout D={D} (strided views, base offset {offset})")
    B, S, H, K, D = MODEL_B, MODEL_S, 32, 2, 128
    torch.cuda.synchronize()
    check(n.get(("wgmma", "float32"), 0) == 0, "the tensor-core kernel took float32")
    log(f"phase 6: K5 matches its plain version on {sum(n.values())} "
        f"configurations: the tensor-core kernel took {n[('wgmma', 'bfloat16')]} "
        f"(bf16, D {' / '.join(map(str, FA_WGMMA_HEAD_DIM))}, at 2e-2; max abs err "
        f"{errs[('wgmma', 'bfloat16')]:.3e}), the FMA kernel {n[('fma', 'float32')]} in "
        f"f32 (D {' / '.join(map(str, FA_HEAD_DIM))}, at 2e-4; max abs err "
        f"{errs[('fma', 'float32')]:.3e}) and {n[('fma', 'bfloat16')]} in bf16 (D "
        f"{' / '.join(str(d) for d in FA_BF16_HEAD_DIM if d not in FA_WGMMA_HEAD_DIM)} "
        f"and the model layouts at D 256 and 128 one element off, at 2e-2; max abs err "
        f"{errs[('fma', 'bfloat16')]:.3e})")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for kernel, dtype in (("wgmma", torch.bfloat16), ("fma", torch.float32)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))   # keeps the strided layout
        check(_wants_wgmma(qd, kd, vd) == (kernel == "wgmma"),
              f"the timed {dtype} tensors do not route to the {kernel} kernel")
        dname = str(dtype).split(".")[-1]
        ms = cuda_ms(torch, lambda: FA.flash_attention(qd, kd, vd, causal=True))
        plain_ms = cuda_ms(torch, lambda: FA.plain_flash_attention(qd, kd, vd, causal=True),
                           reps=3, rounds=3)
        library_ms = cuda_ms(torch, lambda: sdpa(qd, kd, vd, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = attention_bound(B, H, K, S, S, D, True, None, dname)
        nbytes, ops = attention_work(B, H, K, S, S, D, True, None, qd.element_size())
        rows[kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms,
                            max_abs_err=max(e for (kn, _), e in errs.items() if kn == kernel))
        extra = {}
        if kernel == "wgmma":   # the FMA kernel on the same tensors, for the record
            extra["fma_register_tiled_kernel_ms"] = cuda_ms(
                torch, lambda: _fma_kernel_causal(torch, qd, kd, vd))
        log(json.dumps({"timing": f"flash_attention_{kernel}", "B": B, "H": H, "K": K,
                        "S": S, "T": S, "D": D, "dtype": dname, "causal": True,
                        "layout": "(B,S,H,D) strided views", "ms": ms, **extra,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": nbytes, "operations": ops,
                        "tflops": ops / ms / 1e9, "library_ms": library_ms,
                        "library": "torch.nn.functional.scaled_dot_product_attention"
                                   "(is_causal=True, enable_gqa=True)"}))

    # paligemma-3b's attention at head dim 256: f32 on the FMA kernel, bf16
    # on the tensor cores, with the FMA kernel on the same bf16 tensors
    B, H, K, S, D = PALIGEMMA_FA
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q, k, v = (rand(B, S, n, D, dtype=dtype).transpose(1, 2) for n in (H, K, K))
        held(q, k, v, True, None, f"paligemma-3b shape, {dname}, strided views")
        route = "wgmma" if _wants_wgmma(q, k, v) else "fma"
        ms = cuda_ms(torch, lambda: FA.flash_attention(q, k, v, causal=True))
        plain_ms = cuda_ms(torch, lambda: FA.plain_flash_attention(q, k, v, causal=True),
                           reps=3, rounds=3)
        library_ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        nbytes, ops = attention_work(B, H, K, S, S, D, True, None, q.element_size())
        # the card's bound takes bf16 inputs at the tensor-core peak; the
        # FMA kernel's own ceiling (f32 FMAs whatever the input) beside it
        bound_ms, bound_by = attention_bound(B, H, K, S, S, D, True, None, dname)
        extra = {}
        if route == "wgmma":
            extra["fma_register_tiled_kernel_ms"] = cuda_ms(
                torch, lambda: _fma_kernel_causal(torch, q, k, v))
        log(json.dumps({"timing": f"flash_attention_{route}", "shape": "paligemma-3b",
                        "B": B, "H": H, "K": K, "S": S, "T": S, "D": D,
                        "dtype": dname, "causal": True,
                        "layout": "(B,S,H,D) strided views", "ms": ms, **extra,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                        "fma_peak_bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                                 ops / F32_OPS_PER_S) * 1e3,
                        "bytes": nbytes,
                        "operations": ops, "tflops": ops / ms / 1e9,
                        "library_ms": library_ms,
                        "library": "torch.nn.functional.scaled_dot_product_attention"
                                   "(is_causal=True, enable_gqa=True)"}))

    # the MoE, hybrid and audio families' attention shapes, in bf16 as their
    # forwards call K5 (phases 13-15): each held, then timed
    for arch, B, H, K, S, D, window in FAMILY_FA:
        q, k, v = (rand(B, S, n, D, dtype=torch.bfloat16).transpose(1, 2) for n in (H, K, K))
        held(q, k, v, True, window, f"{arch} shape, bf16, strided views")
        route = "wgmma" if _wants_wgmma(q, k, v) else "fma"
        call = lambda: FA.flash_attention(q, k, v, causal=True, window=window)
        ms = cuda_ms(torch, call)
        # whisper's launch is short enough for the wrapper's host path to
        # set the events' pace: the kernel's own time beside it
        device_ms = device_us(torch, call, "flash_attention") / 1e3
        plain_ms = cuda_ms(torch, lambda: FA.plain_flash_attention(
            q, k, v, causal=True, window=window), reps=3, rounds=3)
        # SDPA takes no window; these windows reach past S, so the mask is causal
        check(window is None or window >= S, f"{arch}: a window SDPA cannot take")
        library_ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = attention_bound(B, H, K, S, S, D, True, window, "bfloat16")
        nbytes, ops = attention_work(B, H, K, S, S, D, True, window, q.element_size())
        rows[arch] = dict(route=route, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        extra = {}
        if route == "wgmma" and D > 128:   # the FMA kernel took this shape before
            # causal, as the window reaches past S (checked above)
            extra["fma_register_tiled_kernel_ms"] = fma_ms = cuda_ms(
                torch, lambda: _fma_kernel_causal(torch, q, k, v))
            check(ms < fma_ms, f"{arch}: the tensor-core kernel ({ms:.4f} ms) is not "
                  f"faster than the FMA kernel ({fma_ms:.4f} ms) on the same tensors")
        log(json.dumps({"timing": f"flash_attention_{route}", "shape": arch,
                        "B": B, "H": H, "K": K, "S": S, "T": S, "D": D,
                        "window": window, "dtype": "bfloat16", "causal": True,
                        "layout": "(B,S,H,D) strided views", "ms": ms,
                        "kernel_device_ms": device_ms, **extra,
                        "share_of_bound": bound_ms / ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": nbytes, "operations": ops,
                        "tflops": ops / ms / 1e9, "library_ms": library_ms,
                        "library": "torch.nn.functional.scaled_dot_product_attention"
                                   "(is_causal=True, enable_gqa=True)"}))
    return rows


# --------------------------------------------------------------------------- #
# Phases 7 and 8: the model stack and serving at chatglm3-6b width
# --------------------------------------------------------------------------- #


def device_split(torch, fn, extra_groups=None):
    """One call of ``fn`` under ``torch.profiler``: the window's wall ms
    (profiler overhead included), the device-busy ms summed over its CUDA
    kernels (one stream, so they do not overlap) and that time by group.
    ``extra_groups`` maps a group's name to parts of kernel names it takes,
    tried after the port's own kernels and before the matmuls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, n = {}, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.name.lower()
        if "flash_attention" in name:   # both K5 kernels
            group = "K5"
        elif "rmsnorm_k" in name:
            group = "K6/K7"
        elif "selective_scan_k" in name:
            group = "K8"
        elif any(k in name for keys in (extra_groups or {}).values() for k in keys):
            group = next(g for g, keys in extra_groups.items()
                         if any(k in name for k in keys))
        elif any(k in name for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            group = "matmul"
        elif "memcpy" in name or "memset" in name:
            group = "copy"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + evt.time_range.elapsed_us() / 1e3
        n += 1
    busy = sum(groups.values())
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_events=n,
                idle_share=(1 - busy / wall_ms) if n else None, busy_ms_by_group=groups)


def device_us(torch, fn, name, n=50, between=None):
    """Median device time, in microseconds, of the kernels whose name holds
    ``name`` over ``n`` calls of ``fn`` under ``torch.profiler``: for a
    launch too short for CUDA events around the host's calls.  ``between``,
    when given, runs before each call (an L2 flush, for a cold launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    # the profiler may drop an event at the edge of its window
    check(len(times) >= n // 2, f"the profiler saw {len(times)} of {n} {name} "
          "launches; it saw " + repr(sorted({e.name[:120] for e in prof.events()
                                             if e.device_type == DeviceType.CUDA})))
    return statistics.median(times)


def _tokens(torch, dev, B, S, vocab, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, vocab, (B, S), generator=gen, device=dev)
    return {"tokens": toks, "labels": toks}


def rel(a, b):
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def phase_model(torch, FA, T, C, dev):
    cfg = C.get_config(MODEL_ARCH)
    check(cfg.compute_dtype == "bfloat16" and cfg.n_layers == 28, f"config {cfg}")
    t0 = time.perf_counter()
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 7: {cfg.name} ({n_params:.4g} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = _tokens(torch, dev, MODEL_B, MODEL_S, cfg.vocab_size, seed=1)
    k5 = cfg.replace(attn_impl="pallas")

    FA.reset_launch_counts()
    t0 = time.perf_counter()
    hidden, _ = T.forward(model, k5, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fwd_launches = FA.flash_attention.launches_wgmma
    loss, metrics = T.loss_fn(model, k5, batch)
    torch.cuda.synchronize()
    loss_launches = FA.flash_attention.launches_wgmma - fwd_launches
    fma_launches = FA.flash_attention.launches_fma
    log(f"phase 7: forward {tuple(hidden.shape)} {hidden.dtype} in {first_s:.3f} s "
        f"(first call), loss {float(loss):.5f}, accuracy "
        f"{float(metrics['accuracy']):.5f}; K5 tensor-core launches {fwd_launches} "
        f"(forward), {loss_launches} (loss_fn), FMA launches {fma_launches}")
    check(fwd_launches == cfg.n_layers and loss_launches == cfg.n_layers
          and fma_launches == 0,
          f"K5's tensor-core kernel launched {fwd_launches} / {loss_launches} times "
          f"and the FMA kernel {fma_launches}, not {cfg.n_layers} / {cfg.n_layers} "
          "and 0")
    check(hidden.shape == (MODEL_B, MODEL_S, cfg.d_model)
          and hidden.dtype == torch.bfloat16, f"hidden {hidden.shape} {hidden.dtype}")
    check(bool(torch.isfinite(hidden).all()) and math.isfinite(float(loss)),
          "non-finite forward")

    FA.reset_launch_counts()
    h_plain, _ = T.forward(model, cfg, batch)
    loss_plain, _ = T.loss_fn(model, cfg, batch)
    torch.cuda.synchronize()
    check(FA.flash_attention.launches == 0, "the plain attention launched K5")
    l_err = abs(float(loss) - float(loss_plain))

    # bf16 rounds differently on the two paths, and 28 layers carry that
    # forward: the float32-compute forward with the plain attention is the
    # yardstick of how far any bf16 path lies from the exact one.
    ref32, _ = T.forward(model, cfg.replace(compute_dtype="float32"), batch)
    FA.reset_launch_counts()
    k5_32, _ = T.forward(model, cfg.replace(compute_dtype="float32",
                                            attn_impl="pallas"), batch)
    torch.cuda.synchronize()
    f32_launches = FA.flash_attention.launches_fma
    check(f32_launches == cfg.n_layers and FA.flash_attention.launches_wgmma == 0,
          "the f32 forward did not run all its K5 launches on the FMA kernel")

    # the loss over the first logits chunk alone, on each path
    lc = cfg.logits_chunk
    chunk = [float(T._xent(model, cfg, h[:, :lc], batch["labels"][:, :lc])[0])
             for h in (h_plain, hidden)]

    h_err, k5_f32_err = rel(hidden, h_plain), rel(k5_32, ref32)
    noise = rel(h_plain, ref32)
    h_limit = max(HIDDEN_RTOL, BF16_NOISE_FACTOR * noise)
    log(f"phase 7: against the plain attention on the same weights: loss "
        f"{float(loss_plain)!r} vs {float(loss)!r} (diff {l_err:.3e}, limit "
        f"{LOSS_ATOL}; first {lc} positions: {chunk[0]!r} vs {chunk[1]!r}); "
        f"mean |hidden diff| "
        f"{float((hidden.float() - h_plain.float()).abs().mean()):.3e}; bf16 "
        f"hidden max err {h_err:.3e} of max |hidden| (limit {h_limit:.3e}: "
        f"{HIDDEN_RTOL}, or {BF16_NOISE_FACTOR} x the plain bf16 path's own "
        f"distance {noise:.3e} from the f32 forward; K5 bf16 path's distance "
        f"{rel(hidden, ref32):.3e}); f32 compute, K5 vs plain: {k5_f32_err:.3e} "
        f"(limit {DECODE_RTOL})")
    check(l_err <= LOSS_ATOL, f"loss differs from the plain attention by {l_err:.3e}")
    check(k5_f32_err <= DECODE_RTOL,
          f"f32 hidden differs from the plain attention by {k5_f32_err:.3e}")
    check(h_err <= h_limit, f"bf16 hidden differs from the plain attention by {h_err:.3e}")
    del hidden, h_plain, ref32, k5_32

    fwd_ms = cuda_ms(torch, lambda: T.forward(model, k5, batch), reps=2, rounds=3)
    fwd_plain_ms = cuda_ms(torch, lambda: T.forward(model, cfg, batch), reps=2, rounds=3)
    tokens = MODEL_B * MODEL_S
    log(json.dumps({"end_to_end": "forward", "arch": cfg.name, "B": MODEL_B,
                    "S": MODEL_S, "compute_dtype": cfg.compute_dtype,
                    "attn_impl": "pallas", "ms": fwd_ms,
                    "tokens_per_s": tokens / fwd_ms * 1e3,
                    "plain_attention_ms": fwd_plain_ms,
                    "plain_attention_tokens_per_s": tokens / fwd_plain_ms * 1e3}))
    log(json.dumps({"profile": "forward", "attn_impl": "pallas",
                    **device_split(torch, lambda: T.forward(model, k5, batch))}))
    return model, cfg, {"wgmma": fwd_launches + loss_launches, "fma": f32_launches}


def _staggered(eng, reqs):
    """Serve ``reqs`` on ``eng``: the first alone for a step, then the rest."""
    eng.submit(reqs[0])
    eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.run_to_completion()


def phase_serving(torch, FA, T, E, model, cfg, dev):
    from repro_torch.models import layers as L

    # prefill + one decode step == the forward's last token, in f32 compute
    cfg32 = cfg.replace(compute_dtype="float32", attn_impl="pallas")
    B, S = 2, 64
    batch = _tokens(torch, dev, B, S, cfg.vocab_size, seed=2)
    hidden, _ = T.forward(model, cfg32, batch)
    full = L.unembed_apply(model.embed, cfg32, hidden[:, -1:])
    cache = T.init_cache(cfg32, B, S, device=dev)
    cache, _ = T.prefill(model, cfg32, {"tokens": batch["tokens"][:, :S - 1]}, cache)
    cache, logits = T.decode_step(model, cfg32, cache, batch["tokens"][:, S - 1:], S - 1)
    err = float((logits - full).abs().max() / (full.abs().max() + 1e-6))
    log(f"phase 8: prefill({S - 1}) + decode_step == forward's last logits in "
        f"f32: {err:.3e} of max |logit| (limit {DECODE_RTOL})")
    check(logits.shape == (B, 1, cfg.vocab_size) and err <= DECODE_RTOL,
          f"decode differs from the forward by {err:.3e}")
    del hidden, full, cache, logits

    # the engine: 8 requests x 8 new tokens on 4 slots, staggered
    def requests():
        return [E.Request(rid=i, prompt=[(13 * i + j) % cfg.vocab_size for j in range(4)],
                          max_new_tokens=8) for i in range(8)]

    FA.reset_launch_counts()
    eng = E.BatchedEngine(model, cfg, slots=4, max_len=64, device=dev)
    reqs = requests()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _staggered(eng, reqs)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    engine_launches = FA.flash_attention.launches
    new_tokens = sum(len(r.generated) for r in reqs)
    check(all(len(r.generated) == 8 and all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in reqs), "engine streams")
    check(engine_launches == 0, f"the engine launched K5 {engine_launches} times")
    for want_req in requests():   # each request alone on a 4-slot engine
        solo = E.BatchedEngine(model, cfg, slots=4, max_len=64, device=dev)
        solo.submit(want_req)
        solo.run_to_completion()
        got = reqs[want_req.rid].generated
        check(got == want_req.generated,
              f"request {want_req.rid}: staggered {got} != alone {want_req.generated}")
    log(f"phase 8: BatchedEngine (4 slots) served 8 requests x 8 new tokens, "
        f"staggered, in {engine_s:.3f} s; every stream equals the request "
        f"served alone; K5 launches 0")

    cache = T.init_cache(cfg, 4, DECODE_CACHE, device=dev)
    tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
    decode_ms = cuda_ms(
        torch, lambda: T.decode_step(model, cfg, cache, tok, DECODE_CACHE - 1),
        reps=5, rounds=3)
    log(json.dumps({"end_to_end": "decode_step", "arch": cfg.name, "B": 4,
                    "cache_len": DECODE_CACHE, "compute_dtype": cfg.compute_dtype,
                    "ms": decode_ms}))
    log(json.dumps({"profile": "decode_step", **device_split(
        torch, lambda: T.decode_step(model, cfg, cache, tok, DECODE_CACHE - 1))}))
    log(json.dumps({"end_to_end": "engine", "arch": cfg.name, "slots": 4,
                    "requests": 8, "new_tokens": new_tokens, "seconds": engine_s,
                    "tokens_per_s": new_tokens / engine_s}))


# --------------------------------------------------------------------------- #
# Phase 9: K6, K7 (RMSNorm) and K8 (selective scan) against their plain
# versions, and their timings
# --------------------------------------------------------------------------- #


def _err_within(torch, got, want, tol, what):
    """Max abs error of ``got`` against ``want``; fails beyond tol + tol|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = ~(err <= tol + tol * want.abs())
    if bool(bad.any()):
        raise Failure(f"{what}: {int(bad.sum())} values off by more than {tol} "
                      f"(max abs err {float(err.max()):.3e})")
    return float(err.max()) if err.numel() else 0.0


def scan_work(B, S, Din, N, in_bytes, dt_bytes, y_bytes, with_h0):
    """(bytes, f32 operations, special-function operations) of one scan:
    xi, dt_raw, B, C, A (and h0) read once, y and hT written once; per
    (b, t, d, n) 7 f32 operations (dt*A, exp, the two multiply-adds of the
    update, dt*x*B, h*C and its sum) and one exp; per (b, t, d) softplus
    (6 operations, an exp and a log1p) and dt*x."""
    nbytes = (B * S * Din * (in_bytes + dt_bytes + y_bytes)
              + 2 * B * S * N * in_bytes + Din * N * 4
              + B * Din * N * 4 * (2 if with_h0 else 1))
    ops = B * S * Din * (7 * N + 7)
    sfu = B * S * Din * (N + 2)
    return nbytes, ops, sfu


def scan_bound(B, S, Din, N, in_bytes, dt_bytes, y_bytes, with_h0):
    nbytes, ops, sfu = scan_work(B, S, Din, N, in_bytes, dt_bytes, y_bytes, with_h0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, sfu / SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rms_bound(rows, d, x_bytes, scale_bytes, residual):
    """K6: x read, out written; K7: x and r read, out and h written.  About
    5 f32 operations an element (K7 one more, the add)."""
    n = rows * d
    nbytes = n * x_bytes * (4 if residual else 2) + d * scale_bytes
    ops = n * (6 if residual else 5)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), nbytes


def phase_ssm_kernels(torch, RN, SS, dev):
    gen = torch.Generator(device=dev).manual_seed(9)

    def rand(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    errs = {"rmsnorm": 0.0, "rmsnorm_residual": 0.0, "selective_scan": 0.0}
    n_rms = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = RMS_TOL[str(dtype).split(".")[-1]]
        for rows in RMS_ROWS:
            for d in RMS_D:
                x, r = rand(rows, d).to(dtype), rand(rows, d).to(dtype)
                for scale in (rand(d, shift=1.0), rand(d, shift=1.0).bfloat16()):
                    what = f"{dtype} rows={rows} d={d} scale {scale.dtype}"
                    errs["rmsnorm"] = max(errs["rmsnorm"], _err_within(
                        torch, RN.rmsnorm(x, scale), RN.plain_rmsnorm(x, scale),
                        tol, f"K6 {what}"))
                    normed, h = RN.rmsnorm_residual(x, r, scale)
                    w_normed, w_h = RN.plain_rmsnorm_residual(x, r, scale)
                    errs["rmsnorm_residual"] = max(
                        errs["rmsnorm_residual"],
                        _err_within(torch, normed, w_normed, tol, f"K7 {what} normed"),
                        _err_within(torch, h, w_h, 0.0, f"K7 {what} h"))
                    check(normed.dtype == h.dtype == dtype, f"K7 {what}: dtype")
                    n_rms += 1
    torch.cuda.synchronize()

    n_scan = 0
    for B, S, Din, N in SCAN_SHAPES:
        xi, dt = rand(B, S, Din, scale=0.5), rand(B, S, Din, scale=0.5, shift=-1.0)
        dbc = rand(B, S, 8 + 2 * N, scale=0.3)
        A = -torch.exp(rand(Din, N, scale=0.3))
        h0 = rand(B, Din, N, scale=0.5)
        for dtype in (torch.float32, torch.bfloat16):
            tol = SCAN_TOL[str(dtype).split(".")[-1]]
            views = [t.to(dtype) for t in torch.split(dbc, [8, N, N], dim=-1)[1:]]
            for strided in (False, True):
                bm, cm = views if strided else [v.contiguous() for v in views]
                for state in (None, h0):
                    what = (f"{dtype} B={B} S={S} Din={Din} N={N} "
                            f"h0={state is not None} strided={strided}")
                    ins = (xi.to(dtype), dt.to(dtype), bm, cm)
                    y, hT = SS.selective_scan(*ins, A, state)
                    wy, wh = SS.plain_selective_scan(*ins, A, state)
                    check(y.dtype == dtype and hT.dtype == torch.float32, f"K8 {what}: dtype")
                    errs["selective_scan"] = max(
                        errs["selective_scan"],
                        _err_within(torch, y, wy, tol, f"K8 {what} y"),
                        _err_within(torch, hT, wh, tol, f"K8 {what} hT"))
                    n_scan += 1
        # the model's call: bf16 xi / B / C views, f32 dt_raw, f32 y, hT
        # written over h0
        bm, cm = torch.split(dbc.bfloat16(), [8, N, N], dim=-1)[1:]
        state = h0.clone()
        wy, wh = SS.plain_selective_scan(xi.bfloat16(), dt, bm, cm, A, h0,
                                         y_dtype=torch.float32)
        y, _ = SS.selective_scan(xi.bfloat16(), dt, bm, cm, A, state,
                                 y_dtype=torch.float32, out_state=state)
        what = f"model call B={B} S={S} Din={Din} N={N}"
        errs["selective_scan"] = max(
            errs["selective_scan"],
            _err_within(torch, y, wy, SCAN_TOL["float32"], f"K8 {what} y"),
            _err_within(torch, state, wh, SCAN_TOL["float32"], f"K8 {what} hT in place"))
        # a split sequence with the carried state == the whole sequence
        if S > 1:
            half = S // 2
            bm, cm = torch.split(dbc, [8, N, N], dim=-1)[1:]
            y_full, h_full = SS.selective_scan(xi, dt, bm, cm, A)
            _, h1 = SS.selective_scan(xi[:, :half], dt[:, :half], bm[:, :half],
                                      cm[:, :half], A)
            y2, h2 = SS.selective_scan(xi[:, half:], dt[:, half:], bm[:, half:],
                                       cm[:, half:], A, h1)
            _err_within(torch, y2, y_full[:, half:], 1e-5, f"K8 split {what} y")
            _err_within(torch, h2, h_full, 1e-5, f"K8 split {what} hT")
        n_scan += 1
    torch.cuda.synchronize()
    log(f"phase 9: K6/K7 match their plain versions on {n_rms} configurations "
        f"(f32 at 1e-5, bf16 at 2e-2; max abs err K6 {errs['rmsnorm']:.3e}, K7 "
        f"{errs['rmsnorm_residual']:.3e}); K8 on {n_scan} (f32 at 2e-4, bf16 at "
        f"2e-2, split == whole at 1e-5; max abs err {errs['selective_scan']:.3e})")

    # timings at the model's shapes
    rows = {}
    R, D = SSM_B * SSM_S, 4096
    x, r = rand(R, D).bfloat16(), rand(R, D).bfloat16()
    scale = rand(D, shift=1.0)
    scale_bf16 = scale.bfloat16()
    rms_norm = torch.nn.functional.rms_norm
    for name, kern, plain, library, residual in (
            ("rmsnorm", lambda: RN.rmsnorm(x, scale),
             lambda: RN.plain_rmsnorm(x, scale),
             lambda: rms_norm(x, (D,), weight=scale_bf16, eps=1e-6), False),
            ("rmsnorm_residual", lambda: RN.rmsnorm_residual(x, r, scale),
             lambda: RN.plain_rmsnorm_residual(x, r, scale), None, True)):
        (bound_ms, bound_by), nbytes = rms_bound(R, D, 2, 4, residual)
        ms = cuda_ms(torch, kern)
        row = dict(ms=ms, plain_ms=cuda_ms(torch, plain), bound_ms=bound_ms,
                   bound_by=bound_by,
                   library_ms=cuda_ms(torch, library) if library else None,
                   max_abs_err=errs[name])
        rows[name] = row
        log(json.dumps({"timing": name, "rows": R, "d": D, "x": "bfloat16",
                        "scale": "float32", **row, "bytes": nbytes,
                        "gb_per_s": nbytes / ms / 1e6,
                        "library": ("torch.nn.functional.rms_norm (bf16 weight)"
                                    if library else "none: two PyTorch calls")}))
    B, S, Din, N, Rk = SSM_B, SSM_S, 8192, 16, 256
    xi = rand(B, S, Din, scale=0.5).bfloat16()
    dt = rand(B, S, Din, scale=0.5, shift=-1.0)
    dbc = rand(B, S, Rk + 2 * N, scale=0.3).bfloat16()
    bm, cm = torch.split(dbc, [Rk, N, N], dim=-1)[1:]
    A = -torch.exp(rand(Din, N, scale=0.3))
    kern = lambda: SS.selective_scan(xi, dt, bm, cm, A, y_dtype=torch.float32)
    plain = lambda: SS.plain_selective_scan(xi, dt, bm, cm, A, y_dtype=torch.float32)
    ms = cuda_ms(torch, kern)
    plain_ms = cuda_ms(torch, plain, reps=1, rounds=3)
    bound_ms, bound_by = scan_bound(B, S, Din, N, 2, 4, 4, False)
    nbytes, ops, sfu = scan_work(B, S, Din, N, 2, 4, 4, False)
    rows["selective_scan"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=None,
                                  max_abs_err=errs["selective_scan"])
    log(json.dumps({"timing": "selective_scan", "B": B, "S": S, "Din": Din, "N": N,
                    "inputs": "bf16 xi, B, C (strided views), f32 dt_raw, f32 y",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": nbytes, "f32_operations": ops,
                    "sfu_operations": sfu,
                    "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "f32_ms": ops / F32_OPS_PER_S * 1e3,
                    "sfu_ms": sfu / SFU_OPS_PER_S * 1e3,
                    "library_ms": None, "library": "none: no PyTorch call scans"}))

    # the decode step's call: S 1, the state written in place
    xi1 = rand(B, 1, Din, scale=0.5).bfloat16()
    dt1 = rand(B, 1, Din, scale=0.5, shift=-1.0)
    bm1, cm1 = torch.split(rand(B, 1, Rk + 2 * N, scale=0.3).bfloat16(), [Rk, N, N], dim=-1)[1:]
    state = rand(B, Din, N, scale=0.5)
    step = lambda: SS.selective_scan(xi1, dt1, bm1, cm1, A, state, y_dtype=torch.float32,
                                     out_state=state)
    ms = cuda_ms(torch, step)
    kernel_us = device_us(torch, step, "selective_scan_k")
    plain_ms = cuda_ms(torch, lambda: SS.plain_selective_scan(
        xi1, dt1, bm1, cm1, A, state, y_dtype=torch.float32))
    bound_ms, bound_by = scan_bound(B, 1, Din, N, 2, 4, 4, True)
    rows["selective_scan_decode"] = dict(ms=ms, kernel_us=kernel_us, plain_ms=plain_ms,
                                         bound_ms=bound_ms, bound_by=bound_by)
    log(json.dumps({"timing": "selective_scan_decode", "B": B, "S": 1, "Din": Din, "N": N,
                    "inputs": "as above, h0 given and hT written over it",
                    "ms": ms, "kernel_device_us": kernel_us,
                    "note": "ms is CUDA events around back-to-back calls, which the "
                            "host's per-call cost sets at this size; kernel_device_us "
                            "is the launch's own time from torch.profiler",
                    "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None}))

    rows.update(conv_kernel_rows(torch, rand, Din))
    return rows


def conv_kernel_rows(torch, rand, Din, shapes=CONV_SHAPES):
    """Phase 9's part for the mixer's fused conv, bias and SiLU, at the
    benchmark cells' (B, S): the strided xi half of a bf16 (B, S, 2 Din)
    xz, bf16 weights and bias, a zero state; bit for bit against
    causal_conv1d and F.silu, then timed by CUDA events around back-to-back
    calls (at this point of a chip_smoke run the profiler has recorded none
    of its launches; PERF.md §7).  A timing row a shape, and the last shape's also
    as "causal_conv"."""
    from repro_torch.kernels import causal_conv as CC

    rows = {}
    for B, S in shapes:
        xi = rand(B, S, 2 * Din).bfloat16().chunk(2, dim=-1)[0]
        w, b = rand(4, Din, scale=0.5).bfloat16(), rand(Din, scale=0.1).bfloat16()
        before = CC.causal_conv_silu.launches
        got, got_state = CC.causal_conv_silu(xi, w, b)
        want, want_state = CC.plain_causal_conv_silu(xi, w, b)
        check(CC.causal_conv_silu.launches == before + 1, "causal_conv: no launch")
        n_diff = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        check(n_diff == 0 and torch.equal(got_state, want_state),
              f"causal_conv B={B} S={S}: {n_diff} elements differ from the plain "
              "composition")
        del got, want, got_state, want_state
        kern = lambda: CC.causal_conv_silu(xi, w, b)           # noqa: E731
        ms = cuda_ms(torch, kern)
        plain_ms = cuda_ms(torch, lambda: CC.plain_causal_conv_silu(xi, w, b),
                           reps=2, rounds=3)
        nbytes = 2 * B * S * Din * 2            # xi read once, y written once
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[f"causal_conv_{B}x{S}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes", library_ms=None, max_abs_err=0.0)
        log(json.dumps({"timing": "causal_conv", "B": B, "S": S, "C": Din,
                        "inputs": "bf16 xi (the strided half of xz), bf16 w, b; no state",
                        "bit_equal": True, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                        "bytes": nbytes, "share_of_bound": bound_ms / ms,
                        "library_ms": None, "library": "none: no PyTorch call fuses it"}))
        del xi
    rows["causal_conv"] = rows[f"causal_conv_{shapes[-1][0]}x{shapes[-1][1]}"]
    torch.cuda.synchronize()
    log(f"phase 9: the fused conv equals causal_conv1d + F.silu bit for bit at "
        f"(B, S) {shapes}")
    return rows


# --------------------------------------------------------------------------- #
# Phases 10 and 11: the SSM stack and serving at falcon-mamba-7b width
# --------------------------------------------------------------------------- #


def ssm_counts(RN, SS):
    """Launches of K6, K7, K8 and the mixer's fused conv."""
    from repro_torch.kernels import causal_conv as CC

    return {"rmsnorm": RN.rmsnorm.launches,
            "rmsnorm_residual": RN.rmsnorm_residual.launches,
            "selective_scan": SS.selective_scan.launches,
            "causal_conv": CC.causal_conv_silu.launches}


def reset_ssm_counts(RN, SS):
    from repro_torch.kernels import causal_conv as CC

    RN.rmsnorm.launches = RN.rmsnorm_residual.launches = 0
    SS.selective_scan.launches = CC.causal_conv_silu.launches = 0


def phase_ssm_model(torch, RN, SS, T, C, dev):
    cfg = C.get_config(SSM_ARCH)
    check(cfg.compute_dtype == "bfloat16" and cfg.n_layers == 64
          and cfg.d_model == 4096 and cfg.ssm.state_dim == 16, f"config {cfg}")
    t0 = time.perf_counter()
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 10: {cfg.name} ({n_params:.4g} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = _tokens(torch, dev, SSM_B, SSM_S, cfg.vocab_size, seed=1)
    kc = cfg.replace(attn_impl="pallas")
    L_ = cfg.n_layers
    per_forward = {"rmsnorm": 1, "rmsnorm_residual": L_, "selective_scan": L_,
                   "causal_conv": L_}

    reset_ssm_counts(RN, SS)
    t0 = time.perf_counter()
    hidden, _ = T.forward(model, kc, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fwd_counts = ssm_counts(RN, SS)
    loss, metrics = T.loss_fn(model, kc, batch)
    torch.cuda.synchronize()
    counts = ssm_counts(RN, SS)
    loss_counts = {k: counts[k] - fwd_counts[k] for k in counts}
    log(f"phase 10: forward {tuple(hidden.shape)} {hidden.dtype} in {first_s:.3f} s "
        f"(first call), loss {float(loss):.5f}, accuracy "
        f"{float(metrics['accuracy']):.5f}; launches {fwd_counts} (forward), "
        f"{loss_counts} (loss_fn)")
    check(fwd_counts == per_forward and loss_counts == per_forward,
          f"K6/K7/K8/conv launched {fwd_counts} / {loss_counts}, not {per_forward} "
          "per forward")
    check(hidden.shape == (SSM_B, SSM_S, cfg.d_model)
          and hidden.dtype == torch.bfloat16, f"hidden {hidden.shape} {hidden.dtype}")
    check(bool(torch.isfinite(hidden).all()) and math.isfinite(float(loss)),
          "non-finite forward")

    reset_ssm_counts(RN, SS)
    t0 = time.perf_counter()
    h_plain, _ = T.forward(model, cfg, batch)
    torch.cuda.synchronize()
    plain_first_s = time.perf_counter() - t0
    loss_plain, _ = T.loss_fn(model, cfg, batch)
    ref32, _ = T.forward(model, cfg.replace(compute_dtype="float32"), batch)
    torch.cuda.synchronize()
    check(sum(ssm_counts(RN, SS).values()) == 0,
          "the plain blocks launched K6-K8 or the fused conv")
    k32, _ = T.forward(model, kc.replace(compute_dtype="float32"), batch)
    torch.cuda.synchronize()
    check(ssm_counts(RN, SS) == per_forward,
          f"the f32 forward launched {ssm_counts(RN, SS)}, not {per_forward}")
    l_err = abs(float(loss) - float(loss_plain))

    h_err, k_f32_err, noise = rel(hidden, h_plain), rel(k32, ref32), rel(h_plain, ref32)
    h_limit = max(HIDDEN_RTOL, BF16_NOISE_FACTOR * noise)
    log(f"phase 10: against the plain blocks on the same weights: loss "
        f"{float(loss_plain)!r} vs {float(loss)!r} (diff {l_err:.3e}, limit "
        f"{LOSS_ATOL}); bf16 hidden max err {h_err:.3e} of max |hidden| (limit "
        f"{h_limit:.3e}: {HIDDEN_RTOL}, or {BF16_NOISE_FACTOR} x the plain bf16 "
        f"path's own distance {noise:.3e} from the f32 forward; the kernel bf16 "
        f"path's distance {rel(hidden, ref32):.3e}); f32 compute, kernels vs "
        f"plain: {k_f32_err:.3e} (limit {DECODE_RTOL}); plain forward first "
        f"call {plain_first_s:.3f} s")
    check(l_err <= LOSS_ATOL, f"loss differs from the plain blocks by {l_err:.3e}")
    check(k_f32_err <= DECODE_RTOL,
          f"f32 hidden differs from the plain blocks by {k_f32_err:.3e}")
    check(h_err <= h_limit, f"bf16 hidden differs from the plain blocks by {h_err:.3e}")
    del hidden, h_plain, ref32, k32

    fwd_ms = cuda_ms(torch, lambda: T.forward(model, kc, batch), reps=2, rounds=3)
    fwd_plain_ms = cuda_ms(torch, lambda: T.forward(model, cfg, batch), reps=1, rounds=2)
    tokens = SSM_B * SSM_S
    log(json.dumps({"end_to_end": "forward", "arch": cfg.name, "B": SSM_B,
                    "S": SSM_S, "compute_dtype": cfg.compute_dtype,
                    "attn_impl": "pallas", "ms": fwd_ms,
                    "tokens_per_s": tokens / fwd_ms * 1e3,
                    "plain_blocks_ms": fwd_plain_ms,
                    "plain_blocks_tokens_per_s": tokens / fwd_plain_ms * 1e3}))
    log(json.dumps({"profile": "forward", "arch": cfg.name, "attn_impl": "pallas",
                    **device_split(torch, lambda: T.forward(model, kc, batch))}))
    return model, cfg, {k: fwd_counts[k] + loss_counts[k] for k in fwd_counts}


def _greedy(torch, T, model, cfg, prompt, n, dev):
    """Greedy tokens: ``prefill`` of the prompt, then ``decode_step``s."""
    cache = T.init_cache(cfg, 1, len(prompt) + n, device=dev)
    toks = torch.tensor([prompt], dtype=torch.long, device=dev)
    cache, logits = T.prefill(model, cfg, {"tokens": toks}, cache)
    out = [int(logits[0, -1].argmax())]
    for i in range(n - 1):
        tok = torch.tensor([[out[-1]]], dtype=torch.long, device=dev)
        cache, logits = T.decode_step(model, cfg, cache, tok, len(prompt) + i)
        out.append(int(logits[0, -1].argmax()))
    return out


def phase_ssm_serving(torch, RN, SS, T, E, model, cfg, dev):
    from repro_torch.models import layers as L

    kc = cfg.replace(attn_impl="pallas")
    cfg32 = kc.replace(compute_dtype="float32")
    B, S = 2, 64
    batch = _tokens(torch, dev, B, S, cfg.vocab_size, seed=2)
    hidden, _ = T.forward(model, cfg32, batch)
    full = L.unembed_apply(model.embed, cfg32, hidden[:, -1:])
    cache = T.init_cache(cfg32, B, S, device=dev)
    cache, _ = T.prefill(model, cfg32, {"tokens": batch["tokens"][:, :S - 1]}, cache)
    cache, logits = T.decode_step(model, cfg32, cache, batch["tokens"][:, S - 1:], S - 1)
    err = float((logits - full).abs().max() / (full.abs().max() + 1e-6))
    log(f"phase 11: prefill({S - 1}) + decode_step through K6-K8 == forward's "
        f"last logits in f32: {err:.3e} of max |logit| (limit {DECODE_RTOL})")
    check(logits.shape == (B, 1, cfg.vocab_size) and err <= DECODE_RTOL,
          f"decode differs from the forward by {err:.3e}")
    del hidden, full, cache, logits

    # the decode step at B 4 after a 2048-token prefill
    batch = _tokens(torch, dev, 4, SSM_DECODE_AFTER, cfg.vocab_size, seed=3)
    cache = T.init_cache(kc, 4, SSM_DECODE_AFTER + 64, device=dev)
    cache, logits = T.prefill(model, kc, {"tokens": batch["tokens"]}, cache)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    reset_ssm_counts(RN, SS)
    T.decode_step(model, kc, cache, tok, SSM_DECODE_AFTER)
    step_counts = ssm_counts(RN, SS)
    want = {"rmsnorm": 1, "rmsnorm_residual": cfg.n_layers, "selective_scan": cfg.n_layers,
            "causal_conv": cfg.n_layers}
    check(step_counts == want, f"decode step launched {step_counts}, not {want}")
    decode_ms = cuda_ms(
        torch, lambda: T.decode_step(model, kc, cache, tok, SSM_DECODE_AFTER),
        reps=5, rounds=3)
    log(json.dumps({"end_to_end": "decode_step", "arch": cfg.name, "B": 4,
                    "after_prefill": SSM_DECODE_AFTER, "compute_dtype": cfg.compute_dtype,
                    "attn_impl": "pallas", "ms": decode_ms, "launches": step_counts}))
    log(json.dumps({"profile": "decode_step", "arch": cfg.name, **device_split(
        torch, lambda: T.decode_step(model, kc, cache, tok, SSM_DECODE_AFTER))}))
    del cache

    # the engine: 8 requests x 8 new tokens on 4 slots, staggered
    def requests():
        return [E.Request(rid=i, prompt=[(13 * i + j) % cfg.vocab_size for j in range(4)],
                          max_new_tokens=8) for i in range(8)]

    reset_ssm_counts(RN, SS)
    eng = E.BatchedEngine(model, kc, slots=4, max_len=64, device=dev)
    reqs = requests()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _staggered(eng, reqs)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    engine_counts = ssm_counts(RN, SS)
    new_tokens = sum(len(r.generated) for r in reqs)
    check(all(len(r.generated) == 8 and all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in reqs), "engine streams")
    check(min(engine_counts.values()) > 0, f"the engine missed a kernel: {engine_counts}")
    # A one-slot engine against greedy prefill + decode (f32 compute).  The
    # staggered streams are not held to solo ones: the engine, as the JAX
    # package's, decodes a dummy token in idle slots and never resets a
    # slot's recurrent state (ROADMAP.md R7).
    for req in requests()[:2]:
        solo = E.BatchedEngine(model, cfg32, slots=1, max_len=64, device=dev)
        solo.submit(req)
        solo.run_to_completion()
        want_toks = _greedy(torch, T, model, cfg32, req.prompt, 8, dev)
        check(req.generated == want_toks,
              f"request {req.rid}: one-slot engine {req.generated} != greedy {want_toks}")
    log(f"phase 11: BatchedEngine (4 slots) served 8 requests x 8 new tokens, "
        f"staggered, in {engine_s:.3f} s, launches {engine_counts}; a one-slot "
        f"engine equals greedy prefill + decode_step on 2 requests (f32); "
        f"staggered streams are not held to solo ones (ROADMAP.md R7)")
    log(json.dumps({"end_to_end": "engine", "arch": cfg.name, "slots": 4,
                    "requests": 8, "new_tokens": new_tokens, "seconds": engine_s,
                    "tokens_per_s": new_tokens / engine_s}))


# --------------------------------------------------------------------------- #
# Phase 12: gradient, budgeted and joint co-design on the card
# --------------------------------------------------------------------------- #

#: descent steps of every mode but the Euclidean one (the JAX package's
#: default) and of the Euclidean one, whose retraction runs ~13 eager
#: projections a step with both scalar budgets (six alternation cycles of
#: two, then the shift fallback)
CD_STEPS = 100
CD_EUCLIDEAN_STEPS = 5
#: phase 12's budgets: area and power (relative to the reference chip) and
#: an HBM envelope
CD_AREA, CD_POWER, CD_ENVELOPE = 1.0, 1.2, {"hbm_bw": 0.8}
#: the final objective against the NumPy re-score, and the card's descent
#: against the host's (tests/test_codesign.py's tolerance)
CD_RTOL = 1e-6
#: how many of an Euclidean projection's rounds phase 12 times and counts
CD_PROJECTIONS = 3


def sharding_groups(core, profiles, members=3):
    """Sharding-variant groups over ``profiles``, by the rule of
    ``tests/test_constrained.py``'s ``_sharding_groups``: member 0 is the
    app, member k moves its collective traffic (halved k times) into memory
    traffic (30 % more a step), as tp / zero1 / fsdp layouts trade them."""
    groups = []
    for p in profiles:
        group = [p]
        for k in range(1, members):
            group.append(core.WorkloadProfile(
                name=f"{p.name}/v{k}", flops=p.flops,
                hbm_bytes=max(p.hbm_bytes, p.bytes_accessed) * (1 + 0.3 * k),
                bytes_accessed=p.bytes_accessed * (1 + 0.3 * k),
                collective_bytes={"all-reduce":
                                  p.total_collective_bytes / (2.0 ** k)},
                num_devices=p.num_devices, model_flops=p.model_flops))
        groups.append(group)
    return groups


def aten_ops(torch, fn) -> int:
    """The ATen operations one call of ``fn`` dispatches (each a launch
    when its tensors lie on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _rescore(core, CD, profiles, res, beta, app_weights_of=None):
    """The NumPy float64 objective of ``res``'s final designs under the
    descent's frozen ``beta`` (for a joint result, with the hard selection
    at those designs)."""
    import numpy as np
    from repro_torch.core import kernels_xp as KX

    final = core.MachineBatch.from_models(res.models())
    if app_weights_of is None:
        return CD.scalarized_objective(profiles, final, beta=beta,
                                       w_area=res.w_area, w_power=res.w_power)
    pb = core.ProfileBatch.from_profiles(profiles)
    with np.errstate(divide="ignore", invalid="ignore"):
        agg = KX.congruence_kernel(np, pb.arrays(), final.arrays(), beta,
                                   "serial", core.IDEAL_EPS).aggregate
        return CD._objective_terms(
            np, pb.arrays(), final.arrays(), beta, "serial", core.IDEAL_EPS,
            core.DEFAULT_COST_MODEL, res.w_area, res.w_power,
            app_weights=app_weights_of(agg))


def _check_codesign(core, CD, CN, label, res, seeds, kw, rescored):
    """The holds every phase-12 result must meet."""
    import numpy as np

    check(res.names == list(seeds.names), f"{label}: names differ from the seeds")
    traj = res.trajectory
    check(bool(np.isfinite(traj).all()), f"{label}: non-finite objective")
    if res.mode in ("unconstrained", "projected"):
        # accepted steps never raise J; the links relaxation's rounding
        # repair appends one step that may
        rising = np.diff(traj[:-1] if kw.get("optimize_links") else traj, axis=0)
        check(bool((rising <= 1e-12).all()),
              f"{label}: the trajectory rises by {float(rising.max()):.3e}")
    elif res.mode == "lagrangian":
        damped = np.diff(res.violation_trace.max(axis=1))
        check(bool((damped <= 1e-12).all()),
              f"{label}: the violation trace rises by {float(damped.max()):.3e}")
    check(bool((res.objective_final <= res.objective_seed + 1e-12).all()),
          f"{label}: a design ends above its seed")
    err = np.abs(rescored - res.objective_final) / np.abs(rescored)
    check(bool((err <= CD_RTOL).all()),
          f"{label}: the NumPy re-score is {float(err.max()):.3e} off")
    cm = core.DEFAULT_COST_MODEL
    tol = 1.0 + CN.FEASIBLE_RTOL
    for m in res.models():
        check(isinstance(m.ici_links, int) and m.ici_links >= 1,
              f"{label}: ici_links {m.ici_links!r}")
        if kw.get("area_budget") is not None:
            check(cm.area(m) <= kw["area_budget"] * tol, f"{label}: area over budget")
        if kw.get("power_budget") is not None:
            check(cm.power(m) <= kw["power_budget"] * tol, f"{label}: power over budget")
        for field, b in (kw.get("area_envelope") or {}).items():
            check(cm.subsystem_area(m, field) <= b * tol,
                  f"{label}: {field} over its envelope")
    if kw.get("optimize_links"):
        # exp(log(n)) of the rounded links column: n to an ulp or two
        links = np.array([p["ici_links"] for p in res.final_params])
        check(bool((np.abs(links - np.round(links)) <= 1e-9 * links).all()
                   and (np.round(links) >= 1).all()),
              f"{label}: ici_links not an integer >= 1: {links}")
    if res.feasible is not None:
        check(bool(res.feasible.all()), f"{label}: infeasible designs")
    return float(err.max())


def phase_codesign(torch, core, KC, dev, p3):
    import numpy as np
    from repro_torch.core import codesign as CD
    from repro_torch.core import constrained as CN
    from repro_torch.core import kernels_xp as KX

    profiles, sweep = p3["profiles"], p3["result"]
    pb = core.ProfileBatch.from_profiles(profiles)
    named = core.MachineBatch.from_models(core.VARIANTS)
    survivors = sweep.seed_codesign()
    groups = sharding_groups(core, profiles)
    flat, gids, _ = CN._flatten_groups(groups)
    log(f"phase 12: seeds (a) the {len(named)} named variants, (b) "
        f"{len(survivors)} survivors of the {len(sweep.machines)}-variant sweep "
        f"(both Pareto fronts and every best fit); joint groups: "
        f"{len(groups)} apps x 3 sharding variants")
    # joint_codesign's target: each group's member 0's default beta
    first = [int(np.nonzero(gids == g)[0][0]) for g in range(len(groups))]
    flat_pb = core.ProfileBatch.from_profiles(flat)
    runs = [  # (label, entry, inputs, seeds, keywords)
        ("grad_codesign_named", core.grad_codesign, profiles, named,
         dict(steps=CD_STEPS)),
        ("grad_codesign_survivors", core.grad_codesign, profiles, survivors,
         dict(steps=CD_STEPS)),
        ("constrained_projected", core.constrained_codesign, profiles,
         survivors, dict(area_budget=CD_AREA, steps=CD_STEPS)),
        ("constrained_lagrangian", core.constrained_codesign, profiles,
         survivors, dict(area_budget=CD_AREA, mode="lagrangian",
                         steps=CD_STEPS)),
        ("constrained_optimize_links", core.constrained_codesign, profiles,
         survivors, dict(area_budget=CD_AREA, optimize_links=True,
                         steps=CD_STEPS)),
        ("constrained_area_envelope", core.constrained_codesign, profiles,
         survivors, dict(area_envelope=CD_ENVELOPE, steps=CD_STEPS)),
        ("constrained_euclidean", core.constrained_codesign, profiles,
         survivors, dict(area_budget=CD_AREA, power_budget=CD_POWER,
                         projection="euclidean", steps=CD_EUCLIDEAN_STEPS)),
        ("joint_alternate", core.joint_codesign, groups, survivors,
         dict(mode="alternate")),
        ("joint_softmax", core.joint_codesign, groups, survivors,
         dict(mode="softmax")),
    ]

    KC.reset_launch_counts()
    t_phase = time.perf_counter()
    results, rows = {}, {}
    for label, entry, inputs, seeds, kw in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = entry(inputs, seeds, device=dev, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(peak > before, f"{label}: the card allocated nothing during the call")
        joint = entry is core.joint_codesign
        beta = (CD.resolve_beta(flat_pb, seeds, None, 0)[first][gids] if joint
                else CD.resolve_beta(pb, seeds, None, 0))
        rescored = _rescore(core, CD, flat if joint else profiles, res, beta,
                            (lambda agg: CN._hard_weights(agg, gids))
                            if joint else None)
        rescore_err = _check_codesign(core, CD, CN, label, res, seeds, kw,
                                      rescored)
        results[label] = res
        rows[label] = dict(seconds=seconds, rescore_err=rescore_err,
                           peak_bytes=peak - before)
        line = {"end_to_end": label, "A": len(groups) if joint else len(profiles),
                "V": len(seeds), "steps": res.steps, "seconds": seconds}
        if joint:
            line["profiles"] = len(flat)
        log(json.dumps(line))

    # (a) re-scored the sweep's way: K3's beta against the seed baseline,
    # then K1 on the optimized designs
    ga = results["grad_codesign_named"]
    final_a = core.MachineBatch.from_models(ga.models())
    beta_a = CD.resolve_beta(pb, named, None, 0)
    sw = core.run_sweep(profiles, population=final_a, beta_machine=core.VARIANTS[0],
                        clamp=False, backend="cuda", device=dev)
    plain32 = core.TorchBackend(dev, torch.float32)
    beta_plain = plain32.default_beta(pb.arrays(), named.select(0).arrays())
    _exact(torch, torch.as_tensor(sw.beta, dtype=torch.float32),
           torch.as_tensor(beta_plain), "phase 12: K3's beta")
    beta_err = float(np.max(np.abs(sw.beta - beta_a) / np.abs(beta_a)))
    check(beta_err <= TOL, f"phase 12: K3's beta {beta_err:.3e} off the descent's")
    # (b) re-scored through K1 with the descent's frozen beta
    gs = results["grad_codesign_survivors"]
    final_b = core.MachineBatch.from_models(gs.models())
    beta_b = CD.resolve_beta(pb, survivors, None, 0)
    k1 = core.get_backend("cuda", dev).congruence(
        pb.arrays(), final_b.arrays(), beta_b, clamp=False)
    counts = KC.launch_counts()
    p32 = plain32.congruence(pb.arrays(), final_b.arrays(), beta_b, clamp=False)
    for f in ("gamma", "alpha_compute", "alpha_memory", "alpha_interconnect",
              "lbcs", "hrcs", "ics", "aggregate"):
        _exact(torch, torch.as_tensor(getattr(k1, f)),
               torch.as_tensor(getattr(p32, f)), f"phase 12: K1's {f}")
    fit_errs = {}
    for what, mb, beta, res, k_agg in (
            ("a", final_a, beta_a, ga, sw.aggregate),
            ("b", final_b, beta_b, gs, k1.aggregate)):
        with np.errstate(divide="ignore", invalid="ignore"):
            f64 = KX.congruence_kernel(np, pb.arrays(), mb.arrays(), beta,
                                       "serial", core.IDEAL_EPS)
        fit = (res.objective_final - res.w_area * res.area_final
               - res.w_power * res.power_final)
        err = np.abs(f64.aggregate.mean(axis=0) - fit) / np.abs(fit)
        check(bool((err <= CD_RTOL).all()),
              f"phase 12 ({what}): the descent's fit term is {float(err.max()):.3e} "
              "off its NumPy mean aggregate")
        ok = conditioned(np, f64.gamma, beta, [f64.alpha_compute, f64.alpha_memory,
                                                f64.alpha_interconnect])
        diff = np.abs(k_agg - f64.aggregate)
        check(bool((diff[ok] <= TOL + TOL * np.abs(f64.aggregate[ok])).all()),
              f"phase 12 ({what}): the kernels' aggregate is "
              f"{float(diff[ok].max()):.3e} off the descent's float64 one")
        cols = ok.all(axis=0)
        mean_err = np.abs(k_agg.mean(axis=0) - fit)[cols]
        check(bool((mean_err <= TOL + TOL * np.abs(fit[cols])).all()),
              f"phase 12 ({what}): the kernels' suite mean is "
              f"{float(mean_err.max()):.3e} off the descent's fit term")
        fit_errs[what] = dict(cells=float(diff[ok].max()),
                              ill_conditioned=int((~ok).sum()),
                              mean=float(mean_err.max()) if cols.any() else None,
                              variants=int(cols.sum()))
    check(counts["congruence"] >= 2 and counts["default_beta"] >= 1,
          f"phase 12 missed a kernel: {counts}")
    drive_s = time.perf_counter() - t_phase
    log(f"phase 12: every mode held (trajectories, NumPy re-score within "
        f"{max(r['rescore_err'] for r in rows.values()):.3e}, budgets); the "
        f"optimized designs re-scored through K3 + K1 equal plain float32 and "
        f"lie within {fit_errs} of the descents' float64 fit; launches {counts}; "
        f"{drive_s:.1f} s")

    # the same calls on the host: the same names, final objectives at 1e-6
    for label, entry, inputs, seeds, kw in runs:
        t0 = time.perf_counter()
        host = entry(inputs, seeds, device="cpu", **kw)
        rows[label]["host_seconds"] = time.perf_counter() - t0
        res = results[label]
        check(host.names == res.names and host.selection_names == res.selection_names,
              f"{label}: the host's names or picks differ from the card's")
        err = np.abs(host.objective_final - res.objective_final) / np.abs(
            host.objective_final)
        check(bool((err <= CD_RTOL).all()),
              f"{label}: the card's final objective is {float(err.max()):.3e} "
              "off the host's")
        rows[label]["host_err"] = float(err.max())
    log("phase 12: the host (device='cpu') gives the same names and picks, final "
        "objectives within " + ", ".join(
            f"{k} {r['host_err']:.2e}" for k, r in rows.items()))
    log(json.dumps({"codesign_host_seconds": {
        k: r["host_seconds"] for k, r in rows.items()}}))

    # grad_codesign on (b): launches a step and the device's idle share
    few = 10
    split0 = device_split(torch, lambda: core.grad_codesign(
        profiles, survivors, steps=0, device=dev))
    split = device_split(torch, lambda: core.grad_codesign(
        profiles, survivors, steps=few, device=dev))
    per_step = (split["device_events"] - split0["device_events"]) / few
    steps_per_s = CD_STEPS / rows["grad_codesign_survivors"]["seconds"]
    log(json.dumps({"codesign_profile": "grad_codesign_survivors", "V": len(survivors),
                    "steps_per_s": steps_per_s, "launches_a_step": per_step,
                    "steps_profiled": few, "wall_ms": split["wall_ms"],
                    "device_busy_ms": split["device_busy_ms"],
                    "idle_share": split["idle_share"]}))

    # one Euclidean projection (every survivor's rates doubled, so the
    # budgets bind): time, launches and ATen operations
    theta0, lo, hi = CD.theta_box(survivors, 16.0)
    be = core.get_backend("torch", dev)
    fixed = be.machine_arrays(survivors.arrays())
    th, lo_t, hi_t = (be.asarray(theta0 + np.log(2.0)), be.asarray(lo),
                      be.asarray(hi))
    # (the profiler's launch count only for the area budget alone: with both
    # budgets a projection makes ~12 times as many)
    for budgets, rounds in ((dict(area_budget=CD_AREA), CD_PROJECTIONS),
                            (dict(area_budget=CD_AREA, power_budget=CD_POWER), 1)):
        project = lambda: CN.project_to_budgets(
            torch, th, lo_t, hi_t, fixed, core.DEFAULT_COST_MODEL,
            method="euclidean", **budgets)
        ops = aten_ops(torch, project)
        times = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, ok = project()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        check(bool(ok.all()), "phase 12: an Euclidean projection left a design "
              "infeasible")
        line = {"euclidean_projection": sorted(budgets), "V": len(survivors),
                "seconds": statistics.median(times), "aten_ops": ops}
        if "power_budget" not in budgets:
            proj = device_split(torch, project)
            line.update(launches=proj["device_events"],
                        idle_share=proj["idle_share"])
        log(json.dumps(line))
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s in all")
    return dict(counts=counts, rows=rows, results=results, survivors=survivors)


# --------------------------------------------------------------------------- #
# Phases 13-16: the MoE, hybrid, audio and VLM families at full width
# --------------------------------------------------------------------------- #

#: Each family's phase: its config at full published width and depth
#: (``widths`` checks it), B x S tokens in bf16 compute (whisper's S is its
#: published decoder context, 448), the K5 kernel its forward takes and
#: its launches a forward, the cache of the timed decode step, and how
#: the engine's streams are held: against each request served alone
#: ("solo"), or a one-slot engine against greedy decode ("greedy", the
#: hybrid: idle slots advance recurrent state, ROADMAP.md R7).
FAMILY_PHASES = (
    dict(phase=13, arch="qwen2-moe-a2.7b", S=2048, k5=("wgmma", 24), decode_cache=2048,
         engine="solo", widths=lambda c: (c.n_layers, c.d_model, c.moe.n_experts,
                                          c.moe.top_k, c.moe.n_shared_experts)
         == (24, 2048, 60, 4, 4)),
    dict(phase=14, arch="recurrentgemma-9b", S=2048, k5=("wgmma", 12), decode_cache=2048,
         engine="greedy", widths=lambda c: (c.n_layers, c.d_model, c.hybrid.lru_width,
                                            c.attn_window, c.head_dim_)
         == (38, 4096, 4096, 2048, 256)),
    dict(phase=15, arch="whisper-medium", S=448, k5=("wgmma", 24), decode_cache=448,
         engine="solo", widths=lambda c: (c.n_encoder_layers, c.n_layers, c.d_model,
                                          c.encoder_seq_len, c.head_dim_)
         == (24, 24, 1024, 1500, 64)),
    dict(phase=16, arch="paligemma-3b", S=2048, k5=(None, 0), decode_cache=2048,
         engine="solo", widths=lambda c: (c.n_layers, c.d_model, c.n_vision_tokens,
                                          c.head_dim_) == (18, 2048, 256, 256)),
)
FAMILY_B = 4
#: phase 14's ring check: a prefill of the window's 2048 tokens, then this
#: many decode steps past it
HYBRID_PAST = 8
#: kernel-name parts of the MoE forward's expert dispatch (the sort, the
#: gathers and the indexed writes) and of the RG-LRU's step loop (one
#: addcmul a step), for the device split
DISPATCH_KERNELS = ("sort", "index", "scatter", "gather", "bincount", "topk", "cub",
                    "radix")
LRU_KERNELS = ("addcmul",)


def family_batch(torch, cfg, dev, B, S, seed):
    """NumPy-seeded tokens, their next tokens as labels and, for the stub
    frontends, frame or patch embeddings: on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model),
                                              dtype=np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model),
                                               dtype=np.float32)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def prompt_of(batch, S):
    """The batch's first S tokens, with its frames or patches."""
    out = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    out["tokens"] = batch["tokens"][:, :S]
    return out


def record_routes(torch, L, fn, replay=None):
    """``fn()`` and, for each MoE layer it ran, each token's top-k experts
    (T, k), recomputed from the layer's input as ``moe_apply`` picks them.
    With ``replay`` (an earlier run's record) every layer takes the recorded
    experts instead, gated by its own router probabilities: the earlier
    run's routing on another path, so that the two differ by rounding
    alone."""
    routes, real = [], L.moe_apply

    def traced(p, cfg, x):
        if replay is not None:
            forced = replay[len(routes)]
            routes.append(forced)
            topk = torch.topk
            torch.topk = lambda probs, k, dim=-1: (probs.gather(-1, forced), forced)
            try:
                return real(p, cfg, x)
            finally:
                torch.topk = topk
        cd = L.dtype_of(cfg.compute_dtype)
        xt = x.reshape(-1, x.shape[-1]).to(cd)
        probs = torch.softmax(torch.matmul(xt, p["router"].to(cd)).float(), dim=-1)
        routes.append(torch.topk(probs, cfg.moe.top_k, dim=-1).indices)
        return real(p, cfg, x)

    L.moe_apply = traced
    try:
        return fn(), routes
    finally:
        L.moe_apply = real


def flipped_rows(torch, shape, dev, ra, rb):
    """(B, S) bool: the tokens whose top-k expert set differs, in some MoE
    layer, between two runs' route records."""
    out = torch.zeros(shape, dtype=torch.bool, device=dev)
    for a, b in zip(ra, rb):
        out |= (a.sort(-1).values != b.sort(-1).values).any(-1).reshape(shape)
    return out


def phase_family(torch, FA, T, E, C, dev, spec):
    from repro_torch.models import layers as L

    n, arch, S, B = spec["phase"], spec["arch"], spec["S"], FAMILY_B
    cfg = C.get_config(arch)
    check(cfg.compute_dtype == "bfloat16" and spec["widths"](cfg), f"config {cfg}")
    t0 = time.perf_counter()
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase {n}: {arch} ({n_params:.4g} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = family_batch(torch, cfg, dev, B, S, seed=1)
    kc = cfg.replace(attn_impl="pallas")
    route, per_forward = spec["k5"]
    want = {"wgmma": 0, "fma": 0}
    if route:
        want[route] = per_forward

    def launches():
        return {"wgmma": FA.flash_attention.launches_wgmma,
                "fma": FA.flash_attention.launches_fma}

    FA.reset_launch_counts()
    t0 = time.perf_counter()
    (hidden, aux), routes_k = record_routes(torch, L, lambda: T.forward(model, kc, batch))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fwd = launches()
    (loss, metrics), routes_kl = record_routes(torch, L, lambda: T.loss_fn(model, kc, batch))
    torch.cuda.synchronize()
    loss_l = {k: v - fwd[k] for k, v in launches().items()}
    log(f"phase {n}: forward {tuple(hidden.shape)} {hidden.dtype} in {first_s:.3f} s "
        f"(first call), loss {float(loss):.5f} (aux {float(metrics['aux_loss']):.5f}), "
        f"accuracy {float(metrics['accuracy']):.5f}; K5 launches {fwd} (forward), "
        f"{loss_l} (loss_fn)")
    check(fwd == want and loss_l == want,
          f"K5 launched {fwd} / {loss_l} times, not {want} per forward")
    check(hidden.shape == (B, S, cfg.d_model) and hidden.dtype == torch.bfloat16,
          f"hidden {hidden.shape} {hidden.dtype}")
    check(bool(torch.isfinite(hidden).all()) and math.isfinite(float(loss))
          and math.isfinite(float(aux)), "non-finite forward")
    check((float(aux) > 0) == (cfg.family == "moe"), f"aux loss {float(aux)}")

    # The plain attention on the same weights.  A token whose router
    # probabilities nearly tie picks other experts when the two paths round
    # differently, after which its row -- and, through attention, the later
    # rows of its sequence -- differ by more than rounding.  So the free
    # runs' flips and loss are reported, and the holds are made on runs
    # that replay the K5 run's routing.
    cfg32, kc32 = cfg.replace(compute_dtype="float32"), kc.replace(compute_dtype="float32")
    FA.reset_launch_counts()
    (loss_plain, _), _ = record_routes(torch, L, lambda: T.loss_fn(model, cfg, batch),
                                       routes_kl)
    (h_plain, _), _ = record_routes(torch, L, lambda: T.forward(model, cfg, batch), routes_k)
    (ref32, _), _ = record_routes(torch, L, lambda: T.forward(model, cfg32, batch), routes_k)
    torch.cuda.synchronize()
    check(FA.flash_attention.launches == 0, "the plain attention launched K5")
    FA.reset_launch_counts()
    (k32, _), routes_k32 = record_routes(torch, L, lambda: T.forward(model, kc32, batch))
    torch.cuda.synchronize()
    f32_launches = launches()
    want32 = {"wgmma": 0, "fma": per_forward}
    check(f32_launches == want32, f"the f32 forward launched K5 {f32_launches}, not {want32}")
    (p32, _), _ = record_routes(torch, L, lambda: T.forward(model, cfg32, batch), routes_k32)
    if cfg.moe:   # the free plain runs' routing and loss
        _, routes_p = record_routes(torch, L, lambda: T.forward(model, cfg, batch))
        _, routes_p32 = record_routes(torch, L, lambda: T.forward(model, cfg32, batch))
        flips = {"bf16": int(flipped_rows(torch, (B, S), dev, routes_k, routes_p).sum()),
                 "f32": int(flipped_rows(torch, (B, S), dev, routes_k32, routes_p32).sum()),
                 "rerun": int(flipped_rows(torch, (B, S), dev, routes_k, routes_kl).sum())}
        free_loss = float(T.loss_fn(model, cfg, batch)[0])
        del routes_p, routes_p32
    h_err, noise, f32_err = rel(hidden, h_plain), rel(h_plain, ref32), rel(k32, p32)
    h_limit = max(HIDDEN_RTOL, BF16_NOISE_FACTOR * noise)
    l_err = abs(float(loss) - float(loss_plain))
    log(f"phase {n}: against the plain attention on the same weights: loss "
        f"{float(loss_plain)!r} vs {float(loss)!r} (diff {l_err:.3e}, limit {LOSS_ATOL}); "
        f"bf16 hidden max err {h_err:.3e} of max |hidden| (limit {h_limit:.3e}: "
        f"{HIDDEN_RTOL}, or {BF16_NOISE_FACTOR} x the plain bf16 path's own distance "
        f"{noise:.3e} from the f32 forward); f32 compute, K5 vs plain: {f32_err:.3e} "
        f"(limit {DECODE_RTOL})" + (
            f"; the plain runs replay the K5 runs' routing; between free runs "
            f"{flips['bf16']} of {B * S} tokens pick other top-{cfg.moe.top_k} experts "
            f"in some layer in bf16, {flips['f32']} in f32, and the plain bf16 loss is "
            f"{free_loss!r} (diff {abs(free_loss - float(loss)):.3e}); the K5 forward "
            f"and loss_fn's K5 forward route {flips['rerun']} tokens apart" if cfg.moe else ""))
    check(l_err <= LOSS_ATOL, f"loss differs from the plain attention by {l_err:.3e}")
    check(f32_err <= DECODE_RTOL, f"f32 hidden differs from the plain attention by {f32_err:.3e}")
    check(h_err <= h_limit, f"bf16 hidden differs from the plain attention by {h_err:.3e}")
    del hidden, h_plain, ref32, k32, p32, routes_k, routes_kl, routes_k32

    fwd_ms = cuda_ms(torch, lambda: T.forward(model, kc, batch), reps=2, rounds=3)
    fwd_plain_ms = cuda_ms(torch, lambda: T.forward(model, cfg, batch), reps=1, rounds=2)
    log(json.dumps({"end_to_end": "forward", "arch": arch, "B": B, "S": S,
                    "compute_dtype": cfg.compute_dtype, "attn_impl": "pallas",
                    "ms": fwd_ms, "tokens_per_s": B * S / fwd_ms * 1e3,
                    "plain_attention_ms": fwd_plain_ms,
                    "plain_attention_tokens_per_s": B * S / fwd_plain_ms * 1e3}))
    extra = ({"expert dispatch": DISPATCH_KERNELS} if cfg.family == "moe" else
             {"lru": LRU_KERNELS} if cfg.family == "hybrid" else None)
    log(json.dumps({"profile": "forward", "arch": arch, "attn_impl": "pallas",
                    **device_split(torch, lambda: T.forward(model, kc, batch), extra)}))
    if cfg.family == "hybrid":   # the RG-LRU's step loop alone, at the forward's shape
        w = cfg.hybrid.lru_width
        gen = torch.Generator(device=dev).manual_seed(3)
        a = torch.rand((B, S, w), generator=gen, device=dev)
        bx = torch.randn((B, S, w), generator=gen, device=dev)
        h0 = torch.zeros((B, w), device=dev)
        lru_ms = cuda_ms(torch, lambda: L._lru_scan(a, bx, h0), reps=1, rounds=3)
        n_rec = cfg.n_layers - T.hybrid_layout(cfg)[0]
        log(json.dumps({"timing": "lru_scan", "B": B, "S": S, "W": w, "ms": lru_ms,
                        "recurrent_layers": n_rec, "ms_a_forward": lru_ms * n_rec,
                        "share_of_forward": lru_ms * n_rec / fwd_ms}))
        del a, bx

    phase_family_serving(torch, FA, T, E, L, model, cfg, dev, spec)
    del model
    return {"wgmma": fwd["wgmma"] + loss_l["wgmma"],
            "fma": fwd["fma"] + loss_l["fma"] + f32_launches["fma"]}


def _greedy_decode(torch, T, model, cfg, prompt, n, max_len, dev):
    """Greedy tokens through ``decode_step`` alone, the prompt token by token
    from an empty cache of ``max_len``: what a one-slot engine computes."""
    cache = T.init_cache(cfg, 1, max_len, device=dev)
    toks = list(prompt) or [0]
    for i, t in enumerate(toks):
        cache, logits = T.decode_step(model, cfg, cache,
                                      torch.tensor([[t]], device=dev), i)
    out = [int(logits[0, -1].argmax())]
    for i in range(n - 1):
        cache, logits = T.decode_step(model, cfg, cache,
                                      torch.tensor([[out[-1]]], device=dev), len(toks) + i)
        out.append(int(logits[0, -1].argmax()))
    return out


def prefill_decode_hold(torch, T, L, model, cfg32, dev, n):
    """``prefill`` of 63 tokens + one ``decode_step`` against the forward's
    last two logits, B 2, in ``cfg32`` (f32 compute): 1e-4 of max |logit|."""
    B, S = 2, 64
    batch = family_batch(torch, cfg32, dev, B, S, seed=2)
    hidden, _ = T.forward(model, cfg32, batch)
    full = L.unembed_apply(model.embed, cfg32, hidden[:, -2:])
    cache = T.init_cache(cfg32, B, S, device=dev)
    cache, last = T.prefill(model, cfg32, prompt_of(batch, S - 1), cache)
    cache, logits = T.decode_step(model, cfg32, cache, batch["tokens"][:, S - 1:], S - 1)
    err = max(float((got - want).abs().max() / (want.abs().max() + 1e-6))
              for got, want in ((logits[:, 0], full[:, 1]), (last[:, 0], full[:, 0])))
    log(f"phase {n}: prefill({S - 1}) + decode_step == forward's last logits in "
        f"f32: {err:.3e} of max |logit| (limit {DECODE_RTOL})")
    check(logits.shape == (B, 1, cfg32.vocab_size) and err <= DECODE_RTOL,
          f"decode differs from the forward by {err:.3e}")


def phase_family_serving(torch, FA, T, E, L, model, cfg, dev, spec):
    n, arch = spec["phase"], spec["arch"]
    kc = cfg.replace(attn_impl="pallas")
    cfg32 = kc.replace(compute_dtype="float32")

    def rel(got, want):
        return float((got - want).abs().max() / (want.abs().max() + 1e-6))

    if cfg.family == "hybrid":
        # a prefill of the window's tokens, then decode steps past it: the
        # ring wraps; against one forward over all of them, f32
        W, B = cfg.attn_window, 2
        batch = family_batch(torch, cfg, dev, B, W + HYBRID_PAST, seed=2)
        hidden, _ = T.forward(model, cfg32, batch)
        full = L.unembed_apply(model.embed, cfg32, hidden[:, W - 1:])
        del hidden
        cache = T.init_cache(cfg32, B, W + HYBRID_PAST, device=dev)
        check(cache["groups"]["att"]["k"].shape[2] == W, "the ring is not the window")
        cache, logits = T.prefill(model, cfg32, prompt_of(batch, W), cache)
        errs = [rel(logits[:, 0], full[:, 0])]
        for i in range(HYBRID_PAST):
            cache, logits = T.decode_step(model, cfg32, cache,
                                          batch["tokens"][:, W + i:W + i + 1], W + i)
            errs.append(rel(logits[:, 0], full[:, 1 + i]))
        log(f"phase {n}: prefill({W}) + {HYBRID_PAST} decode steps past the window "
            f"(the ring wraps) == one forward of {W + HYBRID_PAST} tokens in f32: max "
            f"{max(errs):.3e} of max |logit| (limit {DECODE_RTOL}; by step "
            f"{[f'{e:.2e}' for e in errs]})")
        check(max(errs) <= DECODE_RTOL, f"decode differs from the forward by {max(errs):.3e}")
        del batch, full, cache, logits
    else:
        prefill_decode_hold(torch, T, L, model, cfg32, dev, n)

    # the decode step at B 4 over a cache of spec["decode_cache"] positions
    D = spec["decode_cache"]
    cache = T.init_cache(kc, 4, D, device=dev)
    tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
    step = lambda: T.decode_step(model, kc, cache, tok, D - 1)
    decode_ms = cuda_ms(torch, step, reps=5, rounds=3)
    log(json.dumps({"end_to_end": "decode_step", "arch": arch, "B": 4, "cache_len": D,
                    "compute_dtype": cfg.compute_dtype, "ms": decode_ms}))
    log(json.dumps({"profile": "decode_step", "arch": arch, **device_split(torch, step)}))
    del cache

    # the engine: 8 requests x 8 new tokens on 4 slots, staggered, timed
    def requests():
        return [E.Request(rid=i, prompt=[(13 * i + j) % cfg.vocab_size for j in range(4)],
                          max_new_tokens=8) for i in range(8)]

    FA.reset_launch_counts()
    eng = E.BatchedEngine(model, kc, slots=4, max_len=64, device=dev)
    reqs = requests()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _staggered(eng, reqs)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    new_tokens = sum(len(r.generated) for r in reqs)
    check(all(len(r.generated) == 8 and all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in reqs), "engine streams")
    check(FA.flash_attention.launches == 0,
          f"the engine launched K5 {FA.flash_attention.launches} times")
    if spec["engine"] == "solo":
        # MoE: in f32, since an expert's product sees other rows alone than
        # beside other requests, and bf16 rounds a near-tie either way
        hold_cfg = cfg32 if cfg.family == "moe" else kc
        if hold_cfg is not kc:
            reqs = requests()
            _staggered(E.BatchedEngine(model, hold_cfg, slots=4, max_len=64,
                                          device=dev), reqs)
        for want_req in requests():   # each request alone on a 4-slot engine
            solo = E.BatchedEngine(model, hold_cfg, slots=4, max_len=64, device=dev)
            solo.submit(want_req)
            solo.run_to_completion()
            got = reqs[want_req.rid].generated
            check(got == want_req.generated,
                  f"request {want_req.rid}: staggered {got} != alone {want_req.generated}")
        held = (f"every stream equals the request served alone "
                f"({hold_cfg.compute_dtype})")
    else:
        for req in requests()[:2]:
            solo = E.BatchedEngine(model, cfg32, slots=1, max_len=64, device=dev)
            solo.submit(req)
            solo.run_to_completion()
            want_toks = _greedy_decode(torch, T, model, cfg32, req.prompt, 8, 64, dev)
            check(req.generated == want_toks,
                  f"request {req.rid}: one-slot engine {req.generated} != greedy {want_toks}")
        held = ("a one-slot engine equals greedy decode_step on 2 requests (f32); "
                "staggered streams are not held to solo ones (ROADMAP.md R7)")
    log(f"phase {n}: BatchedEngine (4 slots) served 8 requests x 8 new tokens, "
        f"staggered, in {engine_s:.3f} s; {held}; K5 launches 0")
    log(json.dumps({"end_to_end": "engine", "arch": arch, "slots": 4, "requests": 8,
                    "new_tokens": new_tokens, "seconds": engine_s,
                    "tokens_per_s": new_tokens / engine_s}))


# --------------------------------------------------------------------------- #
# Phase 17: the feasibility frontier, implicit sensitivities and the bilevel
# split, fleet packing, and the co-design service
# --------------------------------------------------------------------------- #

#: The budgeted modes run on the survivors of a sweep of the model zoo's
#: smoke profiles (the chatglm3 and falcon-mamba smoke models' train,
#: prefill and decode steps, measured profiles of real models), whose best
#: design has room to shrink under a budget: on gen:64 the best of phase
#: 3's survivors descends to the corner of its span box (every rate a
#: sixteenth of its seed's), where no area or power budget can bind.
FR_SUITE, FR_N = "zoo-smoke", 100_000
#: the frontier's area budgets, as points between the least area that the
#: best of those survivors (its unconstrained descent's winner) can reach in
#: its span box (0) and its optimum's area (1), so that the rows bind; the
#: service's warm request asks for two tighter ones
FR_SCHEDULE = (0.2, 0.4, 0.6, 0.8, 1.0)
FR_TIGHT = (0.05, 0.1)
FR_STEPS = 100
#: the sensitivities are read at a projected descent from the survivors
#: with the budget at this point of the same span (binding)
SENS_AREA = 0.5
#: the J* map's finite-difference hold: the JAX package's own pin
#: (tests/test_implicit.py: the synthetic trio on the named seeds, area 0.18
#: binding, power 0.30 slack) at its rtol; the initial step 30 (default 0.1)
#: reaches the optimum in 8 solver steps instead of ~60, each step a
#: retraction onto both budgets
JSTAR_BUDGETS = (0.18, 0.30)
JSTAR_STEPS, JSTAR_LR, JSTAR_RTOL = 8, 30.0, 1e-3
#: the bilevel split, cut: outer steps and inner steps (its default
#: Euclidean projection onto both budgets) from the J* hold's initial step
#: 30 (default 0.1), so that the cut inner solve converges, as the implicit
#: gradient needs; at the uniform split both budgets are half the total,
#: which is put at this point between the least value and the optimum's of
#: whichever of that survivor's area and power has the larger least value,
#: so that it binds and the other can be met
BL_OUTER_STEPS, BL_STEPS, BL_LR, BL_POINT = 2, 10, JSTAR_LR, 0.5
#: fleet packing: generated apps, machines, the fleet-total area budget and
#: one explicit beta for both fleets compared (tests/test_packing.py's)
PACK_APPS, PACK_MACHINES, PACK_BUDGET, PACK_BETA = 32, 4, 2.0, 1.5
#: the service's sweep population (+ the 3 named variants: 100 003) and its
#: mega-sweep, cut from phase 4's 1 000 003 variants to keep the phase short
SVC_N = 100_000
MEGA_N, MEGA_SHARDS = 200_000, 4


def _same_sweep(np, a, b, what):
    """Two sweep results equal in every cell (NaN where NaN) and by name."""
    check(a.apps == b.apps and a.machines.names == b.machines.names,
          f"{what}: names differ")
    fields = [("beta", a.beta, b.beta), ("gamma", a.gamma, b.gamma),
              ("aggregate", a.aggregate, b.aggregate)]
    fields += [(k, a.scores[k], b.scores[k]) for k in b.scores]
    fields += [(k, a.alphas[k], b.alphas[k]) for k in b.alphas]
    for name, x, y in fields:
        check(np.array_equal(x, y, equal_nan=True),
              f"{what}: {name} differs in "
              f"{int((~((x == y) | (np.isnan(x) & np.isnan(y)))).sum())} cells")


def _same_frontier(np, a, b, what):
    from repro_torch.core.codesign import OPT_FIELDS

    params = lambda r: np.array([[p[f] for f in OPT_FIELDS]
                                 for p in r.best_params])
    check(a.best_names == b.best_names and a.seed_names == b.seed_names,
          f"{what}: names differ")
    check(np.array_equal(a.budgets, b.budgets)
          and np.array_equal(a.feasible, b.feasible)
          and np.array_equal(a.objective, b.objective)
          and np.array_equal(params(a), params(b)), f"{what}: values differ")


def _rescore_k1(torch, core, KC, dev, pb, designs, beta, fit, what):
    """Re-score ``designs`` through K1 with the descent's frozen ``beta``:
    equal to plain float32 in every cell, within ``TOL`` of the float64
    aggregate where Eq. 1 is conditioned, and each design's suite mean
    within ``TOL`` of the descent's fit term."""
    import numpy as np
    from repro_torch.core import kernels_xp as KX

    k1 = core.get_backend("cuda", dev).congruence(
        pb.arrays(), designs.arrays(), beta, clamp=False)
    p32 = core.TorchBackend(dev, torch.float32).congruence(
        pb.arrays(), designs.arrays(), beta, clamp=False)
    for f in ("gamma", "alpha_compute", "alpha_memory", "alpha_interconnect",
              "lbcs", "hrcs", "ics", "aggregate"):
        _exact(torch, torch.as_tensor(getattr(k1, f)),
               torch.as_tensor(getattr(p32, f)), f"phase 17 ({what}): K1's {f}")
    with np.errstate(divide="ignore", invalid="ignore"):
        f64 = KX.congruence_kernel(np, pb.arrays(), designs.arrays(), beta,
                                   "serial", core.IDEAL_EPS)
    ok = conditioned(np, f64.gamma, beta, [f64.alpha_compute, f64.alpha_memory,
                                           f64.alpha_interconnect])
    diff = np.abs(k1.aggregate - f64.aggregate)
    check(bool((diff[ok] <= TOL + TOL * np.abs(f64.aggregate[ok])).all()),
          f"phase 17 ({what}): K1's aggregate is {float(diff[ok].max()):.3e} "
          "off the float64 one")
    cols = ok.all(axis=0)
    mean_err = np.abs(k1.aggregate.mean(axis=0) - fit)[cols]
    check(bool((mean_err <= TOL + TOL * np.abs(fit[cols])).all()),
          f"phase 17 ({what}): K1's suite mean is {float(mean_err.max()):.3e} "
          "off the descent's fit term")
    return dict(cells=float(diff[ok].max()) if ok.any() else None,
                ill_conditioned=int((~ok).sum()),
                mean=float(mean_err.max()) if cols.any() else None)


def _timed_jstar(torch, IM, evals, run):
    """``run()`` with each evaluation of the J* maps that
    ``implicit_jstar_fn`` builds meanwhile timed from its forward to the end
    of its backward (when the budgets' gradient arrives), appending
    ``{"seconds", "dJ_db"}`` to ``evals``."""
    import numpy as np

    build = IM.implicit_jstar_fn

    def timed_build(*args, **kw):
        jstar = build(*args, **kw)

        def fn(budgets):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = jstar(budgets)

            def done(grad):
                torch.cuda.synchronize()
                evals.append(dict(seconds=time.perf_counter() - t0,
                                  dJ_db=np.asarray(grad.detach().cpu())))
            if torch.is_tensor(budgets) and budgets.requires_grad:
                budgets.register_hook(done)
            return out
        return fn

    IM.implicit_jstar_fn = timed_build
    try:
        return run()
    finally:
        IM.implicit_jstar_fn = build


def phase_frontier_service(torch, core, KC, dev, p3, p12):
    import numpy as np
    from repro_torch.core import codesign as CD
    from repro_torch.core import constrained as CN
    from repro_torch.core import implicit as IM
    from repro_torch.launch.sweep import synthetic_profiles
    from repro_torch.serving import codesign_service as SV

    profiles = p3["profiles"]
    pb = core.ProfileBatch.from_profiles(profiles)
    survivors = p12["survivors"]
    named = core.MachineBatch.from_models(core.VARIANTS)
    beta = CD.resolve_beta(pb, survivors, None, 0)
    cm, feas_tol = core.DEFAULT_COST_MODEL, 1.0 + CN.FEASIBLE_RTOL
    rows = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rows[label] = time.perf_counter() - t0
        return out

    KC.reset_launch_counts()
    t_phase = time.perf_counter()

    def corners(seeds):
        _, lo, _ = CD.theta_box(seeds, 16.0)
        m = CD.machine_arrays_from_theta(np, lo, seeds.arrays())
        return np.asarray(cm.area(m)), np.asarray(cm.power(m))

    paper = p12["results"]["constrained_projected"]
    k_paper = int(np.argmin(paper.objective_final))
    log(f"phase 17: gen:64's best survivor ({paper.names[k_paper]}, phase 12): "
        f"area {float(paper.area_final[k_paper]):.6g}, the least its span box "
        f"allows {float(corners(survivors)[0][k_paper]):.6g}")

    # the sweep whose survivors the budgeted modes start from; their budgets
    # lie below the best survivor's unconstrained optimum, so that they
    # bind, and above the least area its span box allows, so that they can
    # be met
    z_prof = core.resolve_suite(FR_SUITE)
    zoo = timed("zoo_sweep", lambda: core.run_sweep(
        z_prof, n=FR_N, include_named=core.VARIANTS, device=dev))
    check(zoo.backend == "cuda", f"the {FR_SUITE} sweep ran off the kernels")
    z_surv = zoo.seed_codesign()
    z_pb = core.ProfileBatch.from_profiles(z_prof)
    z_beta = CD.resolve_beta(z_pb, z_surv, None, 0)
    free = timed("grad_codesign", lambda: core.grad_codesign(
        z_prof, z_surv, steps=FR_STEPS, device=dev))
    k_free = int(np.argmin(free.objective_final))
    a_free = float(free.area_final[k_free])
    p_free = float(free.power_final[k_free])
    a_corner, p_corner = corners(z_surv)
    a_least, p_least = float(a_corner[k_free]), float(p_corner[k_free])
    span = lambda f: a_least + f * (a_free - a_least)
    log(f"phase 17: {FR_SUITE} ({len(z_prof)} apps) x {FR_N + len(core.VARIANTS)}"
        f" variants: {len(z_surv)} survivors, {rows['zoo_sweep']:.2f} s; the "
        f"best one's unconstrained optimum ({free.names[k_free]}, J "
        f"{free.objective_final[k_free]:.8g}, {FR_STEPS} steps, "
        f"{rows['grad_codesign']:.2f} s): area {a_free:.6g} (least "
        f"{a_least:.6g}), power {p_free:.6g} (least {p_least:.6g})")
    check(a_least < a_free, f"the best survivor's optimum has area {a_free:.6g},"
          f" the least its box allows ({a_least:.6g}): no budget could bind")

    # (a) the frontier from those survivors, through the sweep
    # (``SweepResult.frontier``; the service's frontier request below is
    # the direct ``frontier_codesign`` call it is held to)
    schedule = [span(f) for f in FR_SCHEDULE]
    fr = timed("frontier_codesign", lambda: zoo.frontier(
        schedule, steps=FR_STEPS, device=dev))
    feas = fr.feasible
    check(fr.budgets.tolist() == sorted(schedule) and bool(feas.any()),
          f"frontier: budgets {fr.budgets.tolist()}, feasible {feas.tolist()}")
    check(bool((np.diff(fr.objective[feas]) <= 1e-12).all()),
          f"frontier: J* rises with the budget: {fr.objective.tolist()}")
    check(bool((fr.area[feas] <= fr.budgets[feas] * feas_tol).all()),
          f"frontier: a feasible row over its budget: {fr.area.tolist()}")
    designs = core.MachineBatch.from_models([fr.best_model(i)
                                             for i in range(len(fr))])
    rescored = CD.scalarized_objective(z_prof, designs, beta=z_beta)
    fr_err = float(np.max(np.abs(rescored - fr.objective) / np.abs(rescored)))
    check(fr_err <= CD_RTOL, f"frontier: the NumPy re-score is {fr_err:.3e} off")
    dj = fr.dJ_dbudget
    check(bool((dj[feas] <= 0.0).all() and np.isnan(dj[~feas]).all()),
          f"frontier: dJ*/db {dj.tolist()} (<= 0 where feasible, NaN elsewhere)")
    binding = feas & (np.nan_to_num(dj) < 0.0)
    check(bool(binding.any()) and fr.objective[feas][0] > fr.objective[feas][-1],
          f"frontier: no budget binds (dJ*/db {dj.tolist()}, J* "
          f"{fr.objective.tolist()})")
    fit = fr.objective - 0.1 * fr.area - 0.05 * fr.power
    fr_k1 = _rescore_k1(torch, core, KC, dev, z_pb, designs, z_beta, fit,
                        "frontier")
    log(f"phase 17: SweepResult.frontier over {len(z_surv)} survivors, budgets "
        f"{[round(b, 6) for b in fr.budgets.tolist()]} (points {list(FR_SCHEDULE)} "
        f"from the least area to the optimum's): J* {[round(j, 6) for j in fr.objective.tolist()]}, "
        f"feasible {feas.tolist()}, binding {binding.tolist()}, dJ*/db "
        f"{[round(x, 6) for x in dj.tolist()]}, best {fr.best_names}, knee "
        f"{fr.knee():g}; NumPy re-score within {fr_err:.2e}; K1 re-score {fr_k1}")
    log(json.dumps({"end_to_end": "frontier_codesign", "A": len(z_prof),
                    "V": len(z_surv), "budgets": len(schedule),
                    "binding": int(binding.sum()), "steps": FR_STEPS,
                    "refine_steps": fr.refine_steps,
                    "seconds": rows["frontier_codesign"]}))

    # K3 on the survivors' reference variant: the descents' beta
    k3 = core.get_backend("cuda", dev).default_beta(
        pb.arrays(), survivors.select(0).arrays())
    p32 = core.TorchBackend(dev, torch.float32).default_beta(
        pb.arrays(), survivors.select(0).arrays())
    _exact(torch, torch.as_tensor(k3), torch.as_tensor(p32), "phase 17: K3's beta")
    beta_err = float(np.max(np.abs(k3 - beta) / np.abs(beta)))
    check(beta_err <= TOL, f"phase 17: K3's beta {beta_err:.3e} off the descents'")

    # (b) implicit sensitivities at a projected descent whose area budget
    # binds, on the card and on the host
    sens_budget = span(SENS_AREA)
    res_proj = timed("constrained_projected", lambda: core.constrained_codesign(
        z_prof, z_surv, area_budget=sens_budget, steps=CD_STEPS, device=dev))
    rep = timed("sensitivities_of", lambda: core.sensitivities_of(
        res_proj, z_prof, device=dev))
    rep_host = core.sensitivities_of(res_proj, z_prof, device="cpu")
    check(bool((rep.multipliers >= 0).all()
               and (rep.multipliers[~rep.active] == 0).all()
               and np.array_equal(rep.dJ_dbudget, -rep.multipliers)),
          "sensitivities: multipliers negative or priced on a slack constraint")
    check(bool(rep.active.any()) and float(rep.multipliers.max()) > 0.0,
          f"sensitivities: no constraint active or priced at area "
          f"{sens_budget:.6g} ({int(rep.active.sum())} active)")
    check(np.array_equal(rep.active, rep_host.active)
          and np.array_equal(rep.free, rep_host.free),
          "sensitivities: the card's active sets differ from the host's")
    lam_err = float(np.max(np.abs(rep.multipliers - rep_host.multipliers)
                           - 1e-6 * np.abs(rep_host.multipliers)))
    check(lam_err <= 1e-12, f"sensitivities: multipliers {lam_err:.3e} off the host's")
    log(f"phase 17: sensitivities_of a projected descent ({len(z_surv)} "
        f"survivors, {CD_STEPS} steps, area budget {sens_budget:.6g}, point "
        f"{SENS_AREA} from the least area to the optimum's): {int(rep.active.sum())} active "
        f"of {rep.active.size}, {int((rep.multipliers > 0).sum())} priced, max "
        f"price {float(rep.multipliers.max()):.6g}, stationarity residual <= "
        f"{float(rep.residual.max()):.3e}; equal to the host's (active sets "
        f"exactly, prices to 1e-6); descent {rows['constrained_projected']:.2f} "
        f"s, report {rows['sensitivities_of']:.2f} s")

    # (c) the J* map's budget gradient against central finite differences,
    # on the JAX package's pin (a hold, not a timing: the bilevel run below
    # times J* at this phase's size)
    trio = synthetic_profiles()
    jstar = IM.implicit_jstar_fn(trio, named, steps=JSTAR_STEPS, lr=JSTAR_LR,
                                 device=dev)
    b = torch.tensor(JSTAR_BUDGETS, dtype=torch.float64, device=dev,
                     requires_grad=True)
    (grad,) = torch.autograd.grad(jstar(b).sum(), b)
    grad = grad.cpu().numpy()
    area, power = JSTAR_BUDGETS
    h = 1e-3 * area

    def jsum(a):
        with torch.no_grad():
            return float(jstar([a, power]).sum())

    fd = (jsum(area + h) - jsum(area - h)) / (2 * h)
    fd_err = abs(fd - grad[0])
    check(grad[0] < 0 and grad[1] == 0, f"J*: gradient {grad.tolist()} (the area "
          "budget binds, the power budget is slack)")
    check(fd_err <= 1e-8 + JSTAR_RTOL * max(abs(fd), abs(grad[0])),
          f"J*: dJ*/d(area budget) {grad[0]:.8g} against central differences "
          f"{fd:.8g}")
    log(f"phase 17: implicit_jstar_fn (the FD hold: synthetic trio x {len(named)} "
        f"named seeds, {JSTAR_STEPS} solver steps, lr {JSTAR_LR}): sum of "
        f"dJ*/d(budgets) {grad.tolist()}, central differences {fd:.8g} on the "
        f"area budget (rel err {fd_err / abs(fd):.2e})")

    # (d) the bilevel split through the inner optimum, cut; each J*
    # evaluation of its outer loop timed, forward and backward
    least, best = max((a_least, a_free), (p_least, p_free))
    check(least < best, f"bilevel: no budget can bind at the uniform split "
          f"(least {least:.6g}, optimum {best:.6g})")
    total = 2.0 * (least + BL_POINT * (best - least))
    evals = []
    bl = timed("bilevel_codesign", lambda: _timed_jstar(
        torch, IM, evals, lambda: core.bilevel_codesign(
            z_prof, z_surv, total_budget=total, outer_steps=BL_OUTER_STEPS,
            steps=BL_STEPS, lr=BL_LR, device=dev)))
    check(bl.objective_final <= bl.objective_uniform + 1e-12
          and bool((np.diff(bl.objective_trajectory) <= 1e-12).all()),
          f"bilevel: {bl.objective_trajectory.tolist()} against the uniform "
          f"split's {bl.objective_uniform}")
    check(abs(bl.area_budget + bl.power_budget - total) < 1e-12
          and bool(bl.inner.feasible[bl.inner.best]), "bilevel: budgets")
    check(len(evals) == BL_OUTER_STEPS + 1,
          f"bilevel: {len(evals)} timed J* evaluations, not {BL_OUTER_STEPS + 1}")
    check(bool((evals[0]["dJ_db"] < 0.0).any()),
          f"bilevel: no budget binds at the uniform split (dJ*/db "
          f"{evals[0]['dJ_db'].tolist()})")
    check(bl.split_final != 0.5 and bl.objective_final < bl.objective_uniform,
          f"bilevel: the split did not move ({bl.split_trajectory.tolist()})")
    secs = [e["seconds"] for e in evals]
    log(f"phase 17: bilevel_codesign (cut: outer_steps {BL_OUTER_STEPS}, inner "
        f"steps {BL_STEPS} at lr {BL_LR}, Euclidean projection onto both budgets) over "
        f"{len(z_surv)} survivors, total budget {total:.6g} (half of it at "
        f"point {BL_POINT} from the least to the optimum's "
        f"{'area' if least == a_least else 'power'}): split "
        f"{bl.split_trajectory.tolist()}, J* {bl.objective_trajectory.tolist()} "
        f"(uniform {bl.objective_uniform:.8g}); dJ*/d(area, power) at each "
        f"evaluation {[e['dJ_db'].tolist() for e in evals]}; "
        f"{rows['bilevel_codesign']:.1f} s, of which its {len(evals)} J* "
        f"evaluations {[round(x, 2) for x in secs]} s")
    log(json.dumps({"end_to_end": "bilevel_codesign", "A": len(z_prof),
                    "V": len(z_surv), "outer_steps": BL_OUTER_STEPS,
                    "steps": BL_STEPS, "lr": BL_LR,
                    "seconds": rows["bilevel_codesign"],
                    "jstar_evaluations": len(evals),
                    "jstar_eval_seconds": secs}))

    # (e) fleet packing against the uniform fleet
    apps = core.resolve_suite(f"gen:{PACK_APPS}")
    uni = core.constrained_codesign(
        apps, named, steps=30, beta=PACK_BETA, device=dev,
        area_budget=PACK_BUDGET / PACK_MACHINES, area_envelope=CD_ENVELOPE)
    uniform = core.MachineBatch.from_models([uni.best_model()] * PACK_MACHINES)
    pk = timed("pack_codesign", lambda: core.pack_codesign(
        apps, named, num_machines=PACK_MACHINES, mode="alternate",
        beta=PACK_BETA, area_budget=PACK_BUDGET, area_envelope=CD_ENVELOPE,
        device=dev))
    j_pack = core.fleet_objective(apps, pk.machines, beta=PACK_BETA)
    j_uni = core.fleet_objective(apps, uniform, beta=PACK_BETA)
    check(j_pack < j_uni, f"packing: fleet J {j_pack} does not beat the uniform "
          f"fleet's {j_uni}")
    check(abs(pk.objective_final - j_pack) <= 1e-9 * abs(j_pack),
          "packing: the reported objective is not the fleet objective")
    check(pk.feasible is True and pk.area_total <= PACK_BUDGET * feas_tol,
          f"packing: fleet area {pk.area_total} over {PACK_BUDGET}")
    for m in pk.machines.models():
        for field, cap in CD_ENVELOPE.items():
            check(cm.subsystem_area(m, field) <= cap * feas_tol,
                  f"packing: {m.name} over its {field} envelope")
    pk_host = core.pack_codesign(
        apps, named, num_machines=PACK_MACHINES, mode="alternate",
        beta=PACK_BETA, area_budget=PACK_BUDGET, area_envelope=CD_ENVELOPE,
        device="cpu")
    check(np.array_equal(pk.assignment, pk_host.assignment)
          and abs(pk.objective_final - pk_host.objective_final)
          <= CD_RTOL * abs(pk_host.objective_final),
          "packing: the card's assignment or objective differs from the host's")
    apb = core.ProfileBatch.from_profiles(apps)
    pack_beta = np.full(len(apps), PACK_BETA)
    k1_agg = core.get_backend("cuda", dev).congruence(
        apb.arrays(), pk.machines.arrays(), pack_beta, clamp=False).aggregate
    flips = int((np.argmin(k1_agg, axis=1) != pk.assignment).sum())
    log(f"phase 17: pack_codesign {PACK_APPS} apps x {PACK_MACHINES} machines "
        f"(alternate, fleet area {PACK_BUDGET}, envelope {CD_ENVELOPE}): fleet J "
        f"{j_pack:.8g} against the uniform fleet's {j_uni:.8g}; apps a machine "
        f"{np.bincount(pk.assignment, minlength=PACK_MACHINES).tolist()}; area "
        f"{pk.area_total:.6f}; host twin equal; K1's float32 argmin moves "
        f"{flips} of {PACK_APPS} apps (the assignment is float64); "
        f"{rows['pack_codesign']:.2f} s")
    log(json.dumps({"end_to_end": "pack_codesign", "A": PACK_APPS,
                    "machines": PACK_MACHINES, "steps": pk.steps,
                    "seconds": rows["pack_codesign"]}))

    # (f) the co-design service, driven synchronously (workers=0)
    svc = SV.CodesignService(workers=0, device=dev)
    suites = [core.resolve_suite("gen:16"), core.resolve_suite("gen:48")[16:]]
    spec = core.CodesignSpec(n=SVC_N, seed=0)
    named_t = tuple(core.VARIANTS)

    def sweep_req(suite):
        return SV.CodesignRequest(kind="sweep", profiles=suite, spec=spec,
                                  include_named=named_t)

    before = KC.launch_counts()
    jids = [svc.submit(sweep_req(s)) for s in suites]
    timed("service_sweep_group", svc.drain)
    after = KC.launch_counts()
    check(svc.stats["batched_groups"] == 1 and svc.stats["batched_requests"] == 2
          and after["congruence"] - before["congruence"] == 1,
          f"service: the two sweeps did not ride one K1 pass: {dict(svc.stats)}, "
          f"launches {before} -> {after}")
    sweeps = [svc.result(j, timeout=0) for j in jids]
    for i, (suite, got) in enumerate(zip(suites, sweeps)):
        alone = core.run_sweep(suite, n=SVC_N, seed=0, include_named=core.VARIANTS,
                               device=dev)
        check(got.backend == "cuda" and alone.backend == "cuda",
              "service: a sweep ran off the kernels")
        _same_sweep(np, got, alone, f"service slice {i}")
    again = svc.submit(sweep_req(suites[0]))
    svc.drain()
    check(svc.poll(again)["cache"] == "memo"
          and svc.result(again, timeout=0) is sweeps[0], "service: no memo hit")

    mega = svc.submit(SV.CodesignRequest(
        kind="mega_sweep", profiles=suites[0], include_named=named_t,
        spec=core.CodesignSpec(n=MEGA_N, seed=0), num_shards=MEGA_SHARDS,
        stream=True))
    timed("service_mega_sweep", svc.drain)
    events = [e for e in svc.stream(mega) if e["event"] == "shard"]
    check([e["shard"] for e in events] == list(range(MEGA_SHARDS))
          and events[-1]["hi"] == MEGA_N + len(core.VARIANTS),
          f"service: mega-sweep shard events {events}")
    sh = svc.result(mega, timeout=0)
    sh_direct = core.shard_sweep(suites[0], n=MEGA_N, include_named=core.VARIANTS,
                                 num_shards=MEGA_SHARDS, stream=True, device=dev)
    check(sh.pareto_names() == sh_direct.pareto_names()
          and sh.best_fit_map == sh_direct.best_fit_map,
          "service: the mega-sweep differs from shard_sweep")

    fspec = core.CodesignSpec(budgets=schedule, steps=FR_STEPS)
    freq = lambda s, **kw: SV.CodesignRequest(kind="frontier", profiles=z_prof,
                                              machines=z_surv, spec=s, **kw)
    jf = svc.submit(freq(fspec))
    timed("service_frontier_cold", svc.drain)
    cold = svc.result(jf, timeout=0)
    _same_frontier(np, fr, cold,
                   "SweepResult.frontier against the service's frontier_codesign")
    tight = core.CodesignSpec(budgets=[span(f) for f in FR_TIGHT],
                              steps=FR_STEPS)
    jw = svc.submit(freq(tight))
    timed("service_frontier_warm", svc.drain)
    check(svc.poll(jw)["cache"] == "warm" and svc.stats["frontier_warm_hits"] == 1,
          "service: the tighter frontier was not a warm hit")
    loosest = max(tight.budgets)
    ge = [b for b in sorted(cold.continuation) if b >= loosest]
    pick = min(ge) if ge else max(cold.continuation)
    warm_direct = core.frontier_codesign(
        z_prof, z_surv, spec=tight, warm_theta=cold.continuation[pick],
        warm_lr=cold.final_lr, keep_state=True, device=dev)
    _same_frontier(np, svc.result(jw, timeout=0), warm_direct,
                   "service warm frontier")

    kinds = {
        "constrained": (profiles, survivors,
                        core.CodesignSpec(area_budget=CD_AREA, steps=20),
                        core.constrained_codesign),
        "joint": (sharding_groups(core, profiles), survivors,
                  core.CodesignSpec(mode="alternate", steps=16),
                  core.joint_codesign),
        "pack": (apps, named,
                 core.CodesignSpec(num_machines=PACK_MACHINES, mode="alternate",
                                   beta=PACK_BETA, area_budget=PACK_BUDGET,
                                   area_envelope=CD_ENVELOPE), None),
        "bilevel": (profiles, survivors,
                    core.CodesignSpec(total_budget=total, outer_steps=1,
                                      steps=2, projection="shift"),
                    core.bilevel_codesign),
    }
    for kind, (inputs, seeds, kspec, entry) in kinds.items():
        jk = svc.submit(SV.CodesignRequest(kind=kind, profiles=inputs,
                                           machines=seeds, spec=kspec))
        timed(f"service_{kind}", svc.drain)
        got = svc.result(jk, timeout=0)
        want = pk if entry is None else entry(inputs, seeds, spec=kspec,
                                             device=dev)
        check(json.dumps(got.to_json(), sort_keys=True, default=str)
              == json.dumps(want.to_json(), sort_keys=True, default=str),
              f"service: the {kind} request differs from the direct call")
    counts = KC.launch_counts()

    # (g) the same sweep and frontier requests through two worker threads
    threaded = SV.CodesignService(workers=2, device=dev)
    try:
        t0 = time.perf_counter()
        tj = [threaded.submit(sweep_req(s)) for s in suites]
        tf = threaded.submit(freq(fspec))
        t_sweeps = [threaded.result(j, timeout=600) for j in tj]
        t_front = threaded.result(tf, timeout=600)
        torch.cuda.synchronize()
        rows["service_threaded"] = time.perf_counter() - t0
    finally:
        threaded.shutdown()
    for i, (a, b2) in enumerate(zip(t_sweeps, sweeps)):
        _same_sweep(np, a, b2, f"workers=2 sweep {i}")
    _same_frontier(np, t_front, cold, "workers=2 frontier")

    for name in ("congruence", "default_beta", "sweep_stats"):
        check(counts[name] > 0, f"phase 17 never launched {name}: {counts}")
    log(f"phase 17: the service (workers=0): two gen suites ({len(suites[0])} + "
        f"{len(suites[1])} apps) on one {SVC_N + len(core.VARIANTS)}-variant "
        f"population in one K1 pass, each slice equal to its request alone; "
        f"a repeat a memo hit; a {MEGA_N + len(core.VARIANTS)}-variant "
        f"mega-sweep (cut from phase 4's 1000003) in {MEGA_SHARDS} shards, events "
        f"in order, equal to shard_sweep; the frontier cold (equal to "
        f"SweepResult.frontier) then warm (equal to the direct call); constrained, joint, pack and bilevel equal to the "
        f"direct calls; workers=2 equal to workers=0; stats {dict(svc.stats)}")
    log(json.dumps({"service_seconds": {k: v for k, v in rows.items()
                                        if k.startswith("service")}}))
    log(f"phase 17: launches {counts}; {time.perf_counter() - t_phase:.1f} s in all")
    return dict(counts=counts, rows=rows)


# --------------------------------------------------------------------------- #


# --------------------------------------------------------------------------- #
# Phases 18-19: the measurement loop and training
# --------------------------------------------------------------------------- #

#: phase 18's full-grid architecture and the cell (c) runs on the card
#: with phase 7's weights
ZOO_ARCH = "chatglm3-6b"
ZOO_CARD_CELL = "zoo_decode_s4096_b32"
#: the profile fields that are not counts (identity of the cell)
ZOO_IDENTITY = ("model_flops", "tokens", "params", "params_active", "num_devices")
#: the counts a card run must equal its meta run's in
ZOO_COUNTS = ("dot_flops", "dot_count", "flops", "transcendentals",
              "bytes_accessed", "hbm_bytes")
ZOO_RATIOS = ("dot_flops", "flops", "bytes_accessed", "hbm_bytes",
              "peak_memory_bytes")
#: phase 18 (a)'s MoE hold: qwen2-moe-a2.7b's smoke config (8 experts,
#: top 4), whose experts' rows split by the routing on the card and
#: evenly on meta
ZOO_MOE_ARCH = "qwen2-moe-a2.7b"
ZOO_MOE_SHAPES = (("moe_train_s128_b4", 128, 4, "train"),
                  ("moe_prefill_s128_b4", 128, 4, "prefill"))
#: phase 18 (e)'s sweep
ZOO_SWEEP_N = 100_000
#: phase 19: whisper-medium at published width and depth, phase 15's shape
TRAIN_ARCH = "whisper-medium"
TRAIN_B = 4
TRAIN_S = 448
TRAIN_STEPS = 4
TRAIN_SAVE = 2
TRAIN_RTOL = 1e-5
#: parameters whose first slices phase 19's AdamW twin holds
TRAIN_SLICES = 8
TRAIN_SLICE_LEN = 4096


def _same_counts(a, b, fields=ZOO_COUNTS):
    return [f for f in fields if getattr(a, f) != getattr(b, f)]


def phase_zoo_card_cell(torch, model, dev):
    """Phase 18 (c): chatglm3-6b's ``ZOO_CARD_CELL`` on the card with phase
    7's weights (before they are freed); held against (b)'s meta count."""
    from repro_torch.core import model_zoo as PZ

    cell = next(c for c in PZ.zoo_cells(archs=(ZOO_ARCH,))
                if c.shape.name == ZOO_CARD_CELL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = PZ.extract_profile(cell, device=dev, model=model, mesh="1x1")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"phase 18 (c): {cell.name} on the card with phase 7's weights in "
        f"{secs:.2f} s: dot_flops {prof.dot_flops:.6e}, hbm_bytes "
        f"{prof.hbm_bytes:.6e}, allocator peak {prof.peak_memory_bytes / 1e9:.3f} "
        f"GB (the weights {prof.argument_bytes / 1e9:.3f} GB of it)")
    torch.cuda.empty_cache()
    return dict(cell=cell, profile=prof, seconds=secs)


def phase_measurement(torch, core, KC, dev, p18c):
    """Phase 18 (a), (b), (d), (e); (c) ran beside phase 7's model."""
    import numpy as np

    from repro_torch.core import model_zoo as PZ
    from repro_torch.core import roofline as R

    t_phase = time.perf_counter()
    # (a) the six smoke cells on the card and on meta
    cells = PZ.zoo_cells(smoke=True)
    jax_gold = core.resolve_suite("zoo-smoke")
    port_gold = PZ.profiles_from_configs(smoke=True, extract_missing=False)
    card, rows = [], []
    for cell, jg, pg in zip(cells, jax_gold, port_gold):
        check(jg.meta.get("fingerprint") == PZ.cell_fingerprint(cell),
              f"phase 18: {cell.name}'s JAX-made golden has another fingerprint")
        t0 = time.perf_counter()
        pc = PZ.extract_profile(cell, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pm = PZ.extract_profile(cell, device="meta")
        meta_s = time.perf_counter() - t0
        card.append(pc)
        bad = [f for f in ZOO_IDENTITY if getattr(pc, f) != getattr(jg, f)]
        check(not bad, f"phase 18 (a): {cell.name}: {bad} differ from the JAX goldens")
        bad = _same_counts(pc, pm)
        check(not bad, f"phase 18 (a): {cell.name}: {bad} on the card differ from meta")
        ratios = {f: (getattr(pc, f) / getattr(jg, f), getattr(pc, f) / getattr(pg, f))
                  for f in ZOO_RATIOS}
        rows.append(dict(cell=cell.name, card_s=card_s, meta_s=meta_s, ratios=ratios))
        log(f"phase 18 (a): {cell.name}: card {card_s:.3f} s, meta {meta_s:.3f} s; "
            "card / JAX golden, card / port golden: " + ", ".join(
                f"{f} {a:.6f} / {b:.6f}" for f, (a, b) in ratios.items()))

    # (a) the MoE: its experts' split on the card against meta's even one
    from repro_torch import configs as C
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.extract import run_cell

    moe = C.get_config(ZOO_MOE_ARCH, smoke=True)
    for name, seq, batch, kind in ZOO_MOE_SHAPES:
        shape = ShapeSpec(name, seq, batch, kind)
        pc = run_cell(moe, shape, device=dev)
        pm = run_cell(moe, shape, device="meta")
        bad = _same_counts(pc, pm)
        check(not bad, f"phase 18 (a): the MoE's {name}: {bad} on the card differ from meta")
        log(f"phase 18 (a): {moe.name} {name} (gmm, {moe.moe.n_experts} experts, top "
            f"{moe.moe.top_k}): the card's counts equal meta's (dot_flops "
            f"{pc.dot_flops:.6e}, {pc.dot_count} matmuls, hbm_bytes {pc.hbm_bytes:.6e})")

    # (b) chatglm3-6b's full grid on meta
    full = {}
    for cell in PZ.zoo_cells(archs=(ZOO_ARCH,)):
        t0 = time.perf_counter()
        p = PZ.extract_profile(cell, device="meta", mesh="1x1")
        secs = time.perf_counter() - t0
        full[cell.shape.name] = p
        want = R.model_flops_for(params_active=p.params_active, tokens=p.tokens,
                                 step_kind="train" if p.step_kind == "train" else "infer")
        check(p.model_flops == want, f"phase 18 (b): {cell.name} model_flops")
        log(f"phase 18 (b): {cell.name} on meta in {secs:.2f} s: dot_flops "
            f"{p.dot_flops:.6e}, hbm_bytes {p.hbm_bytes:.6e}, tracker peak "
            f"{p.peak_memory_bytes / 1e9:.3f} GB, {p.meta['aten_ops']} ATen operations")
    check(len(full) == 12, f"phase 18 (b): {len(full)} cells, not 12")

    # (c)'s hold, against (b)
    pc, pm = p18c["profile"], full[ZOO_CARD_CELL]
    bad = _same_counts(pc, pm)
    check(not bad, f"phase 18 (c): {bad} on the card differ from meta")
    log(f"phase 18 (c): the card's counts equal meta's; allocator peak "
        f"{pc.peak_memory_bytes / 1e9:.3f} GB against the tracker's "
        f"{pm.peak_memory_bytes / 1e9:.3f} GB")

    # (d) calibration of (a)'s profiles: K2 against the float64 roofline
    KC.reset_launch_counts()
    t0 = time.perf_counter()
    rep = PZ.calibration_report(card, device=dev)
    cal_s = time.perf_counter() - t0
    check(rep.backend == "cuda", f"phase 18 (d): backend {rep.backend}")
    worst = max(abs(c.ratio - 1.0) for c in rep.cells)
    check(worst <= TOL, f"phase 18 (d): a calibration ratio is {worst:.3e} off 1")
    log(f"phase 18 (d): calibration of the card's profiles on {rep.backend} in "
        f"{cal_s:.3f} s: ratios within {worst:.3e} of 1, dominant-term agreement "
        f"{100.0 * rep.dominant_agreement:.1f}% ("
        + ", ".join(f"{c.dominant_eq1}/{c.dominant_roofline}" for c in rep.cells) + ")")

    # (e) the extracted suite swept through K3 -> K1
    t0 = time.perf_counter()
    res = core.run_sweep(card, n=ZOO_SWEEP_N, include_named=core.VARIANTS, device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    counts = KC.launch_counts()
    check(counts["congruence"] > 0 and counts["default_beta"] > 0
          and counts["step_time"] > 0, f"phase 18 missed a kernel: {counts}")
    plain32 = core.run_sweep(card, n=ZOO_SWEEP_N, include_named=core.VARIANTS,
                             backend=core.TorchBackend(dev, torch.float32))
    check(bool(np.isfinite(res.aggregate).all()), "phase 18 (e): non-finite aggregate")
    check(best_fits_agree(res, plain32), "phase 18 (e): best fits differ from plain f32")
    names_k, area, agg = _front_maps(res)
    names_p, _, agg_p = _front_maps(plain32)
    check(fronts_agree(names_k, names_p, area, agg_p),
          f"phase 18 (e): 2-D fronts differ: {names_k} vs {names_p}")
    jres = core.run_sweep(jax_gold, n=ZOO_SWEEP_N, include_named=core.VARIANTS,
                          device=dev)
    best = [res.machines.names[i] for i in res.best_fit_indices()]
    jbest = [jres.machines.names[i] for i in jres.best_fit_indices()]
    jfront = [jres.machines.names[i] for i in jres.pareto_front()]
    log(f"phase 18 (e): run_sweep of the card's profiles x {len(res.machines)} in "
        f"{sweep_s:.3f} s; best fits and 2-D front equal plain f32. Best fits "
        f"(port suite / JAX-made suite): "
        + ", ".join(f"{a} / {b}" for a, b in zip(best, jbest))
        + f"; 2-D front {len(names_k)} variants {names_k[:6]}... / {len(jfront)} "
        f"variants {jfront[:6]}...; launches {counts}")
    seconds = time.perf_counter() - t_phase
    log(f"phase 18: {seconds:.1f} s")
    return dict(counts=counts, rows=rows, full=full, seconds=seconds)


def _schedule64(step, oc):
    """The learning rate at ``step`` in float64 (``adamw.schedule``)."""
    warm = min(step / max(oc.warmup_steps, 1), 1.0)
    t = min(max((step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1),
                0.0), 1.0)
    decay = oc.min_lr_ratio + (1.0 - oc.min_lr_ratio) * 0.5 * (1.0 + math.cos(math.pi * t))
    return oc.peak_lr * warm * decay


def _adamw_twin(torch, A, S, state, cfg, batch, oc):
    """One AdamW update on the card against a NumPy float64 twin: the global
    norm of all the gradients, the learning rate, and the first
    ``TRAIN_SLICE_LEN`` elements of ``TRAIN_SLICES`` parameters (and their
    m, v)."""
    import numpy as np

    model = state["params"]
    params = A.params_of(model)
    _, _, grads = S.loss_and_grads(model, cfg, batch)
    names = sorted(params)[::max(len(params) // TRAIN_SLICES, 1)][:TRAIN_SLICES]
    host = lambda t: t.detach().reshape(-1)[:TRAIN_SLICE_LEN].double().cpu().numpy()
    before = {n: (host(params[n]), host(state["opt"]["m"][n]), host(state["opt"]["v"][n]),
                  host(grads[n])) for n in names}
    gnorm64 = math.sqrt(sum(float((g.detach().double() ** 2).sum().cpu())
                            for g in grads.values()))
    step = int(state["opt"]["step"]) + 1
    _, _, stats = A.update(grads, state["opt"], params, oc)
    torch.cuda.synchronize()
    lr64 = _schedule64(step, oc)
    errs = {"grad_norm": abs(float(stats["grad_norm"]) - gnorm64) / gnorm64,
            "lr": abs(float(stats["lr"]) - lr64) / lr64}
    clip = min(1.0, oc.clip_norm / max(gnorm64, 1e-12))
    bc1, bc2 = 1.0 - oc.b1 ** step, 1.0 - oc.b2 ** step
    worst = {"p": 0.0, "m": 0.0, "v": 0.0}
    for n, (p0, m0, v0, g) in before.items():
        gf = g * clip
        m = oc.b1 * m0 + (1.0 - oc.b1) * gf
        v = oc.b2 * v0 + (1.0 - oc.b2) * gf * gf
        p = p0 - lr64 * ((m / bc1) / (np.sqrt(v / bc2) + oc.eps) + oc.weight_decay * p0)
        for key, want, got in (("p", p, host(params[n])), ("m", m, host(state["opt"]["m"][n])),
                               ("v", v, host(state["opt"]["v"][n]))):
            scale = max(float(np.abs(want).max()), 1e-30)
            worst[key] = max(worst[key], float(np.abs(got - want).max()) / scale)
    return errs, worst, names


def phase_training(torch, T, C, dev):
    """Phase 19: whisper-medium trained on the card (module docstring)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import store
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.extract import run_cell
    from repro_torch.optim import adamw as A
    from repro_torch.training import step as S
    from repro_torch.training import trainer as TR

    t_phase = time.perf_counter()
    cfg = C.get_config(TRAIN_ARCH)
    check(cfg.attn_impl == "xla", f"phase 19 trains with attn_impl {cfg.attn_impl}")
    n_params = cfg.param_counts()[0]
    oc = A.OptimizerConfig(peak_lr=1e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    dc = DataConfig(seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(ROOT, "build"))
    try:
        def trainer(name, fail_at=None, every=TRAIN_SAVE):
            tc = TR.TrainerConfig(total_steps=TRAIN_STEPS, checkpoint_every=every,
                                  checkpoint_dir=os.path.join(root, name),
                                  keep_checkpoints=1, log_every=TRAIN_STEPS + 1)
            return TR.Trainer(cfg, tc, dc, oc, seed=0, device=dev,
                              failure_injector=TR.FailureInjector(fail_at) if fail_at else None)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = trainer("clean", every=TRAIN_STEPS)   # the last step's save alone
        out = tr.run()
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        metrics = out["metrics"]
        check(len(metrics) == TRAIN_STEPS and out["restarts"] == 0,
              f"phase 19: {len(metrics)} steps, {out['restarts']} restarts")
        losses = [m["loss"] for m in metrics]
        check(all(math.isfinite(x) for x in losses), f"phase 19: losses {losses}")
        lr_err = max(abs(m["lr"] - _schedule64(m["step"] + 1, oc)) / _schedule64(m["step"] + 1, oc)
                     for m in metrics)
        check(lr_err <= TRAIN_RTOL, f"phase 19: lr {lr_err:.3e} off the float64 schedule")
        n_real = sum(p.numel() for p in out["final_state"]["params"].parameters())
        step_times = [m["step_time_s"] for m in metrics]
        step_s = statistics.median(step_times[1:])
        log(f"phase 19: {TRAIN_ARCH} ({n_real:.4g} parameters; the analytic count "
            f"{n_params:.4g} leaves out the position tables) trained {TRAIN_STEPS} "
            f"steps of {TRAIN_B} x {TRAIN_S} decoder tokens over {cfg.encoder_seq_len} "
            f"frames in {clean_s:.2f} s (the checkpoint of step {TRAIN_STEPS} "
            f"included): losses {[round(x, 5) for x in losses]}, "
            f"grad norms {[round(m['grad_norm'], 5) for m in metrics]}, step times "
            f"{[round(x, 4) for x in step_times]} s; step {step_s:.4f} s "
            f"(median of steps 2-{TRAIN_STEPS}), {TRAIN_B * TRAIN_S / step_s:.1f} "
            f"decoder tokens/s; allocator peak {peak / 1e9:.2f} GB; lr within "
            f"{lr_err:.2e} of float64")
        clean = {k: v.detach().to("cpu", copy=True)
                 for k, v in S.state_arrays(out["final_state"]).items()}

        # one more AdamW update against the float64 twin
        state = out["final_state"]
        del out, tr
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in SyntheticLM(cfg, dc).batch(TRAIN_STEPS).items()}
        errs, worst, names = _adamw_twin(torch, A, S, state, cfg, batch, oc)
        del batch
        check(max(errs.values()) <= TRAIN_RTOL and max(worst.values()) <= TRAIN_RTOL,
              f"phase 19: AdamW off its float64 twin: {errs}, {worst}")
        log(f"phase 19: one AdamW update against its float64 twin: grad_norm "
            f"{errs['grad_norm']:.2e}, lr {errs['lr']:.2e}, and on {len(names)} "
            f"parameters' first {TRAIN_SLICE_LEN} elements p {worst['p']:.2e}, m "
            f"{worst['m']:.2e}, v {worst['v']:.2e} (relative to each slice's max)")
        del state
        torch.cuda.empty_cache()

        # killed after step TRAIN_SAVE, resumed from its checkpoint
        t0 = time.perf_counter()
        tr = trainer("resumed", fail_at=[TRAIN_SAVE])
        out = tr.run()
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        check(out["restarts"] == 1 and [m["step"] for m in out["metrics"]] ==
              [0, 1, 2, 3], f"phase 19: resume ran steps {[m['step'] for m in out['metrics']]}")
        got = {k: v.detach().to("cpu", copy=True)
                 for k, v in S.state_arrays(out["final_state"]).items()}
        del out, tr
        torch.cuda.empty_cache()
        diffs = {k: float((got[k].double() - clean[k].double()).abs().max()) for k in clean}
        n_equal = sum(torch.equal(got[k], clean[k]) for k in clean)
        log(f"phase 19: killed after step {TRAIN_SAVE} and resumed from its checkpoint "
            f"in {resumed_s:.2f} s: {n_equal} of {len(clean)} leaves (params, m, v, "
            f"step) bit for bit equal to the uninterrupted run's, largest difference "
            f"{max(diffs.values()):.3e}")
        check(n_equal == len(clean), "phase 19: the resumed run's step-4 state differs "
              f"from the uninterrupted run's: {sorted(diffs.items(), key=lambda kv: -kv[1])[:4]}")
        del got, clean

        # elastic: a checkpoint written on the CPU resumes on the card
        small = C.get_config(TRAIN_ARCH, smoke=True)
        sdc = DataConfig(seq_len=16, global_batch=2, seed=0)
        stc = lambda n: TR.TrainerConfig(total_steps=n, checkpoint_every=2,
                                         checkpoint_dir=os.path.join(root, "elastic"),
                                         log_every=n + 1)
        TR.Trainer(small, stc(2), sdc, oc, seed=0, device="cpu").run()
        written, _ = store.restore_tensors(os.path.join(root, "elastic"))
        back = S.state_arrays(S.state_from_arrays(small, written, oc, dev))
        check(all(torch.equal(back[k].cpu(), written[k]) for k in written),
              "phase 19: the CPU's checkpoint did not load on the card bit for bit")
        out = TR.Trainer(small, stc(4), sdc, oc, seed=0, device=dev).run()
        check([m["step"] for m in out["metrics"]] == [2, 3]
              and all(math.isfinite(m["loss"]) for m in out["metrics"]),
              f"phase 19: the elastic resume ran {out['metrics']}")
        log(f"phase 19: a {small.name} checkpoint written on the CPU at step 2 "
            f"loaded on the card bit for bit ({len(written)} leaves) and trained "
            f"on to step 4 there (losses {[round(m['loss'], 5) for m in out['metrics']]})")
        del out

        # the same cell's train profile on the card against meta
        shape = ShapeSpec(f"train_s{TRAIN_S}_b{TRAIN_B}", TRAIN_S, TRAIN_B, "train")
        t0 = time.perf_counter()
        pc = run_cell(cfg, shape, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pm = run_cell(cfg, shape, device="meta")
        meta_s = time.perf_counter() - t0
        bad = _same_counts(pc, pm)
        check(not bad, f"phase 19: the train profile's {bad} on the card differ from meta")
        log(f"phase 19: its train profile on the card ({card_s:.2f} s) equals meta's "
            f"({meta_s:.2f} s): dot_flops {pm.dot_flops:.6e} (model_flops "
            f"{pm.model_flops:.6e}), hbm_bytes {pm.hbm_bytes:.6e}; allocator peak "
            f"{pc.peak_memory_bytes / 1e9:.2f} GB against the tracker's "
            f"{pm.peak_memory_bytes / 1e9:.2f} GB")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"phase 19: {seconds:.1f} s")
    return dict(step_s=step_s, tokens_per_s=TRAIN_B * TRAIN_S / step_s, seconds=seconds)


#: phase 20: the hillclimb launcher's flash substitution at chatglm3-6b's
#: train_4k (extracted on meta, full width and depth), then its co-design
#: modes on the card; the scan substitution at falcon-mamba-7b's largest
#: zoo shape whose meta extraction stays within a minute (its prefill s4096
#: b16 cell is 282 318 ATen operations, 94.7 s on meta: every zoo prefill
#: and train shape is longer)
HC_ARCH, HC_SHAPE = "chatglm3-6b", "train_4k"
HC_SCAN_ARCH, HC_SCAN_SHAPE = "falcon-mamba-7b", "zoo_decode_s32768_b256"
HC_SWEEP_N = 100_000
HC_GRAD = 20
#: binds on the densest seed, whose descent grows its area (the others
#: shrink toward their span box's corner, where no budget binds)
HC_AREA = 2.0
#: the frontier's budgets lie inside the binding window of the baseline
#: seed, each row's best on this profile: from just above the least area
#: its span box allows (0.0625) to above its optimum's (0.0715 at
#: HC_GRAD steps), so that the tighter rows bind and J* rises as the budget
#: tightens (the whole window lies below the other seeds' areas)
HC_BUDGET_SWEEP = "0.064:0.076:4"
HC_PACK, HC_PACK_AREA = 4, 2.0
#: the card's float64 co-design against the host's
HC_RTOL, HC_ATOL = 1e-9, 1e-12
HC_CODESIGN_KEYS = ("codesign_sweep", "grad_codesign", "frontier_codesign",
                    "pack_codesign", "bilevel_codesign")


def blob_diffs(got, want, rtol=HC_RTOL, atol=HC_ATOL, path=""):
    """Where two JSON results differ: keys, lengths, names and flags
    exactly; floats within ``atol + rtol * max(|a|, |b|)`` (NaN where NaN)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [f"{path}: keys {sorted(got) if isinstance(got, dict) else got}"]
        return [d for k in want for d in blob_diffs(got[k], want[k], rtol, atol,
                                                    f"{path}.{k}")]
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [f"{path}: length"]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in blob_diffs(g, w, rtol, atol, f"{path}[{i}]")]
    if isinstance(want, float) and isinstance(got, (int, float)):
        if math.isnan(want) and math.isnan(got):
            return []
        ok = abs(got - want) <= atol + rtol * max(abs(got), abs(want))
        return [] if ok else [f"{path}: {got!r} against {want!r}"]
    return [] if got == want else [f"{path}: {got!r} against {want!r}"]


def _hold_sweep(torch, core, HC, dev, prof, cd, what):
    """Phase 20's sweep (K3, K1 on the card) against the plain float32 path
    on the card by name, and the host's float64 best fit within TOL."""
    machines = HC.machine_candidates(HC_SWEEP_N)
    plain = core.batched_congruence([prof], machines, clamp=True,
                                    backend=core.TorchBackend(dev, torch.float32))
    names_p, area, agg = _front_maps(plain)
    names_k = [row["variant"] for row in cd["pareto"]]
    best_p = machines.names[int(plain.best_fit_indices()[0])]
    check(cd["backend"] == "cuda" and cd["num_variants"] == len(machines),
          f"{what}: the sweep ran on {cd['backend']}")
    check(cd["best_variant"] == best_p or agg[cd["best_variant"]] <= agg[best_p] + TOL,
          f"{what}: best fit {cd['best_variant']} against plain f32's {best_p}")
    check(fronts_agree(names_k, names_p, area, agg),
          f"{what}: 2-D fronts differ: {names_k} vs {names_p}")
    host = HC.codesign_sweep(prof, HC_SWEEP_N, device="cpu")
    check(abs(cd["best_aggregate"] - host["best_aggregate"]) <= TOL,
          f"{what}: best aggregate {cd['best_aggregate']} against the "
          f"host's float64 {host['best_aggregate']}")
    return (f"best {cd['best_variant']} ({cd['best_aggregate']:.6g}; plain f32 "
            f"{best_p}, host f64 {host['best_variant']} {host['best_aggregate']:.6g}), "
            f"front {len(names_k)} variants equal to plain f32's")


def phase_hillclimb(torch, core, KC, dev):
    """Phase 20: ``python -m repro_torch.launch.hillclimb`` on the card."""
    from repro_torch import configs as C
    from repro_torch.configs.shapes import resolve_shape
    from repro_torch.launch import hillclimb as HC
    from repro_torch.launch.extract import run_cell

    t_phase = time.perf_counter()
    rows = {}

    def launch(label, arch, shape, mode, argv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = HC.main(["--arch", arch, "--shape", shape, "--mode", mode,
                      "--mesh", "1x1", "--tag", label] + argv)
        torch.cuda.synchronize()
        rows[label] = time.perf_counter() - t0
        check(rc == 0, f"phase 20: hillclimb {label} returned {rc}")
        name = C.get_config(arch).name
        path = os.path.join(HC.DEFAULT_OUT, f"{name}__{shape}__1x1__{label}.json")
        with open(path) as f:
            blob = json.load(f)
        prof = core.WorkloadProfile.from_json(blob)
        prof.meta = {k: v for k, v in prof.meta.items() if k not in HC_CODESIGN_KEYS}
        return blob, prof

    def hold(label, card, host_fn):
        t0 = time.perf_counter()
        bad = blob_diffs(card, json.loads(json.dumps(host_fn())))
        rows[f"{label}_host"] = time.perf_counter() - t0
        check(not bad, f"phase 20 ({label}): the card's result differs from "
              f"--device cpu's: {bad[:4]}")

    KC.reset_launch_counts()
    cfg, shape = C.get_config(HC_ARCH), resolve_shape(HC_SHAPE)
    # (a) flash: the sweep (K3, K1) and the budgeted descent with its prices
    blob, prof = launch("flash-grad", HC_ARCH, HC_SHAPE, "flash", [
        "--sweep", str(HC_SWEEP_N), "--grad", str(HC_GRAD),
        "--area-budget", str(HC_AREA), "--sensitivities"])
    counts = KC.launch_counts()
    check(counts["congruence"] > 0 and counts["default_beta"] > 0,
          f"phase 20 missed a kernel: {counts}")
    sub = blob["meta"]["flash_substitution"]
    L = HC.attention_layers(cfg)
    by_hand = L * attention_score_bytes(cfg, shape)
    check(sub["layers"] == L and abs(sub["removed_bytes"] - by_hand) <= 1e-6 * by_hand,
          f"phase 20: removed {sub['removed_bytes']:.9e} B against "
          f"{by_hand:.9e} counted by hand")
    check(sub["added_bytes"] == L * HC.flash_kernel_bytes_per_layer(cfg, shape),
          "phase 20: the flash kernel's bytes")
    t0 = time.perf_counter()
    base = run_cell(cfg, shape, device="meta")
    rows["flash_baseline"] = time.perf_counter() - t0
    want = max(base.hbm_bytes - sub["removed_bytes"] + sub["added_bytes"],
               sub["added_bytes"])
    check(blob["hbm_bytes"] == want, f"phase 20: hbm_bytes {blob['hbm_bytes']} "
          f"against {want}")
    log(f"phase 20: hillclimb --mode flash {HC_ARCH} {HC_SHAPE} (extracted on meta): "
        f"hbm_bytes {base.hbm_bytes:.6e} -> {blob['hbm_bytes']:.6e}: removed "
        f"{sub['removed_bytes']:.9e} B over {L} layers (the count by hand "
        f"{by_hand:.9e}), added {sub['added_bytes']:.6e}")
    sweep_line = _hold_sweep(torch, core, HC, dev, prof,
                             blob["meta"]["codesign_sweep"], "phase 20 (flash)")
    gd = blob["meta"]["grad_codesign"]
    hold("flash-grad", gd, lambda: HC.codesign_grad(
        prof, HC_GRAD, area_budget=HC_AREA, sensitivities=True, device="cpu"))
    prices = {v["name"]: v["shadow_prices"]["area"]
              for v in gd["sensitivities"]["variants"]}
    log(f"phase 20: --sweep {HC_SWEEP_N}: {sweep_line}; --grad {HC_GRAD} "
        f"--area-budget {HC_AREA} --sensitivities: best {gd['best_variant']}, "
        f"area prices {prices}; equal to --device cpu")

    # (b) the frontier and (c) packing, one command each (phase 17 holds
    # the bilevel split on the card, at a total where a budget binds)
    blob, _ = launch("flash-frontier", HC_ARCH, HC_SHAPE, "flash", [
        "--grad", str(HC_GRAD), "--budget-sweep", HC_BUDGET_SWEEP, "--sensitivities"])
    fr = blob["meta"]["frontier_codesign"]
    hold("flash-frontier", fr, lambda: HC.codesign_frontier(
        prof, HC.parse_budget_sweep(None, HC_BUDGET_SWEEP), HC_GRAD,
        device="cpu").to_json())
    pts = fr["points"]
    feas = [p for p in pts if p["feasible"]]
    binding = [p["budget"] for p in feas if p["dJ_dbudget"] < 0.0]
    check(len(feas) == len(pts) and all(p["area"] <= p["budget"] * (1 + 1e-9)
                                        for p in pts),
          f"phase 20: frontier rows infeasible or over budget: {pts}")
    check(bool(binding) and all(a >= b - 1e-12 for a, b in
                                zip(fr["objective"], fr["objective"][1:]))
          and fr["objective"][0] > fr["objective"][-1],
          f"phase 20: no frontier budget binds (dJ*/db "
          f"{[p['dJ_dbudget'] for p in pts]}, J* {fr['objective']})")
    blob, _ = launch("flash-pack", HC_ARCH, HC_SHAPE, "flash", [
        "--pack", str(HC_PACK), "--area-budget", str(HC_PACK_AREA)])
    pk = blob["meta"]["pack_codesign"]
    hold("flash-pack", pk, lambda: HC.codesign_pack(
        prof, HC_PACK, lr=0.1, area_budget=HC_PACK_AREA,
        device="cpu").to_json(top_k=8))
    check(pk["feasible"] is True and pk["objective_final"] <= pk["objective_seed"],
          f"phase 20: packing {pk['objective_seed']} -> {pk['objective_final']}, "
          f"feasible {pk['feasible']}")
    log(f"phase 20: --budget-sweep {HC_BUDGET_SWEEP}: J* {fr['objective']}, "
        f"binding {binding}, dJ*/db {[p['dJ_dbudget'] for p in pts]}, best seeds "
        f"{[p['best_seed'] for p in pts]}; --pack {HC_PACK} (fleet area "
        f"{HC_PACK_AREA}): {pk['num_apps']} apps, objective "
        f"{pk['objective_seed']:.6g} -> {pk['objective_final']:.6g}; each equal to "
        "the host's")

    # (e) scan at falcon-mamba-7b's full width
    cfg, shape = C.get_config(HC_SCAN_ARCH), resolve_shape(HC_SCAN_SHAPE)
    blob, prof = launch("scan-sweep", HC_SCAN_ARCH, HC_SCAN_SHAPE, "scan",
                        ["--sweep", str(HC_SWEEP_N)])
    sub = blob["meta"]["scan_substitution"]
    N, S, B = cfg.ssm.state_dim, shape.seq_len, shape.global_batch
    t0 = time.perf_counter()
    h = [HC._probe_hbm(cfg, shape, S, B, state_dim=n) for n in (N, N // 2, N // 4)]
    base = run_cell(cfg, shape, device="meta")
    rows["scan_holds"] = time.perf_counter() - t0
    check(abs((h[0] - h[1]) - 2.0 * (h[1] - h[2])) <= 1e-6 * (h[0] - h[1]),
          f"phase 20: the scan probes are not linear in N: {h}")
    by_hand = cfg.n_layers * scan_state_bytes_by_hand(cfg, shape)
    check(abs(sub["removed_bytes"] - by_hand) <= 1e-6 * by_hand,
          f"phase 20: the scan's removed {sub['removed_bytes']:.9e} B against "
          f"{by_hand:.9e} counted by hand")
    check(sub["added_bytes"] == cfg.n_layers * HC.scan_kernel_bytes_per_layer(cfg, shape),
          "phase 20: the scan kernel's bytes")
    want = max(base.hbm_bytes - sub["removed_bytes"] + sub["added_bytes"],
               sub["added_bytes"])
    check(blob["hbm_bytes"] == want, f"phase 20: scan hbm_bytes {blob['hbm_bytes']} "
          f"against {want}")
    sweep_line = _hold_sweep(torch, core, HC, dev, prof,
                             blob["meta"]["codesign_sweep"], "phase 20 (scan)")
    counts = KC.launch_counts()
    log(f"phase 20: hillclimb --mode scan {HC_SCAN_ARCH} {HC_SCAN_SHAPE}: hbm_bytes "
        f"{base.hbm_bytes:.6e} -> {blob['hbm_bytes']:.6e} (removed "
        f"{sub['removed_bytes']:.9e}, the count by hand {by_hand:.9e}, the probes "
        f"at N {N}, {N // 2}, {N // 4} linear; "
        f"added {sub['added_bytes']:.6e}: the kernel term counts B x S tokens on a "
        f"decode cell too, R15); --sweep {HC_SWEEP_N}: {sweep_line}; launches {counts}")
    seconds = time.perf_counter() - t_phase
    log(json.dumps({"end_to_end": "hillclimb", "seconds": rows}))
    log(f"phase 20: {seconds:.1f} s")
    return dict(counts=counts, seconds=seconds, rows=rows)



# --------------------------------------------------------------------------- #
# Phase 21: the sharded layer -- per-device profiles with collectives on the
# production meshes (a fake process group, in child processes), the
# hillclimb launcher's --joint on the pod mesh, and a real NCCL world on the
# card (shard_sweep over the variants mesh, a sharded train step)
# --------------------------------------------------------------------------- #

#: (arch, shape, --mesh, --variant or None for default_variant); the dry run
#: of each runs on meta in a child process of its own, started before phase
#: 20 (it needs no card; phases 1-19's timings run without it) and read here
P21_CELLS = (("chatglm3-6b", "train_4k", "pod", None),
             ("deepseek-67b", "train_4k", "multipod", "fsdp"))
P21_MESHES = {"pod": ("pod16x16", {"data": 16, "model": 16}, False),
              "multipod": ("pods2x16x16", {"pod": 2, "data": 16, "model": 16}, True)}
P21_DRYRUN_TIMEOUT = 900
#: phase 21 (a): a full zoo cell through ``core.model_zoo.extract_profile``,
#: which profiles it on the pod mesh under default_variant (zero1) in a
#: child process of its own
P21_ZOO_CELL = ("chatglm3-6b", "zoo_train_s2048_b64")
#: phase 21 (b): the launcher's --mesh (its profile label and device count),
#: the joint descent's steps (its sweep is phase 20's HC_SWEEP_N), and the
#: NumPy re-score's bound
P21_JOINT_MESH = ("pod", "pod16x16", 256)
P21_GRAD = 10
P21_RESCORE = 1e-6
#: phase 21 (c): the real process group's backend
P21_BACKEND = "nccl"
#: phase 21 (c): shard_sweep over the variants mesh, and the train step on a
#: 1 x 1 mesh (chatglm3-6b's width at P21_TRAIN_LAYERS layers, float32)
P21_SWEEP_N = 100_000
P21_TRAIN_LAYERS, P21_TRAIN_B, P21_TRAIN_S = 2, 2, 256
#: every gradient of that step against the unsharded one, on the largest's
#: scale: float32 sums in another order (the log-sum-exp over the
#: vocabulary from a max and a sum, where the unsharded path calls
#: ``torch.logsumexp``) move them by ~1e-6 of it on the card
P21_GRAD_TOL = 1e-5


def _p21_dir():
    return os.path.join(ROOT, "build", "chip_smoke_p21")


def start_dryrun_children():
    """Phase 21 (a)'s dry runs, each in a child process that owns its fake
    process group; they run on the host's cores while the card works.  The
    fake group is PyTorch's internal API: probed here, loudly."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401 (probe)

    root = _p21_dir()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    env = dict(os.environ, PYTHONPATH=SRC)
    children = []
    zoo_code = ("import sys\n"
                "from repro_torch.core import model_zoo as PZ\n"
                "cell = next(c for c in PZ.zoo_cells(archs=(sys.argv[1],))\n"
                "            if c.shape.name == sys.argv[2])\n"
                "PZ.extract_profile(cell, device='meta', verbose=True).save(sys.argv[3])\n")
    out = open(os.path.join(root, "zoo.log"), "w")
    children.append((*P21_ZOO_CELL, "zoo", None, out, time.perf_counter(),
                     subprocess.Popen([sys.executable, "-c", zoo_code, *P21_ZOO_CELL,
                                       os.path.join(root, "zoo.json")],
                                      env=env, cwd=ROOT, stdout=out,
                                      stderr=subprocess.STDOUT)))
    for arch, shape, mesh, variant in P21_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--mesh", mesh, "--out", root]
        if variant:
            cmd += ["--variant", variant]
        out = open(os.path.join(root, f"{arch}.log"), "w")
        children.append((arch, shape, mesh, variant, out, time.perf_counter(),
                         subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=out,
                                          stderr=subprocess.STDOUT)))
    return children


def stop_children(children):
    for *_, out, _, proc in children or ():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()


def train_dot_by_hand(cfg, shape, dp, tp):
    """Per-device dot FLOPs of one train step of a dense model on a (dp, tp)
    grid under the sharding rules: per layer, the q / k / v / out
    projections and the MLP over the device's batch rows with the
    "model" slice of their heads or ffn (the k / v heads split over
    "model" on head_dim when they do not divide, then gathered), the
    attention over the device's query heads, forward plus a backward of
    twice the forward; and the unembedding over its vocabulary slice."""
    B, S, D = shape.global_batch // dp, shape.seq_len, cfg.d_model
    hd, H, K = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    T = B * S
    q = H * hd // tp
    kv = K * hd // tp
    h_loc = H // tp
    per_layer = (2 * T * D * q + 2 * (2 * T * D * kv) + 2 * (2 * B * h_loc * S * S * hd)
                 + 2 * T * q * D + 3 * (2 * T * D * (cfg.d_ff // tp)))
    unembed = 2 * T * D * (cfg.vocab_size // tp)
    return 3 * per_layer, 3 * unembed


def param_bytes_by_specs(cfg, sizes, variant, multi_pod):
    """One device's parameter bytes: each tensor's shard under the rules."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import transformer as T

    model = T.init_model(cfg, device="meta")
    sc = SH.ShardingConfig(variant=variant, multi_pod=multi_pod)
    specs = SH.param_specs(T.param_shapes(model), T.param_axes(cfg), sizes, sc)
    total = 0
    for name, p in model.named_parameters():
        spec = specs
        for part in name.split("."):
            if not part.isdigit():
                spec = spec[part]
        n = 1
        for d in SH.local_shape(tuple(p.shape), spec, sizes):
            n *= d
        total += n * p.element_size()
    return total


def _p21_dryruns(core, children):
    """(a): wait for the children, read their profiles, hold them."""
    from repro_torch import configs as C
    from repro_torch.configs.shapes import resolve_shape
    from repro_torch.core import model_zoo as PZ
    from repro_torch.launch.extract import default_variant

    out = {}
    for arch, shape_name, mesh, variant, log_f, t0, proc in children:
        try:
            rc = proc.wait(timeout=max(1.0, P21_DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log_f.flush()
        check(rc == 0, f"phase 21 (a): the {arch} dry run on {mesh} ended with {rc}: "
              + open(log_f.name).read()[-2000:])
        cfg, shape = C.get_config(arch), resolve_shape(shape_name)
        zoo = mesh == "zoo"
        label, sizes, multi = P21_MESHES["pod" if zoo else mesh]
        variant = variant or default_variant(cfg)
        prof = core.WorkloadProfile.load(os.path.join(
            _p21_dir(), "zoo.json" if zoo
            else f"{cfg.name}__{shape_name}__{label}__{variant}.json"))
        if zoo:
            cell = next(c for c in PZ.zoo_cells(archs=(arch,))
                        if c.shape.name == shape_name)
            check(prof.meta.get("fingerprint") == PZ.cell_fingerprint(cell)
                  and prof.meta.get("variant") == variant,
                  f"phase 21 (a): the zoo cell {cell.name}'s meta {prof.meta}")
        n = 1
        for s in sizes.values():
            n *= s
        tp = sizes["model"]
        dp = n // tp
        per_layer, unembed = train_dot_by_hand(cfg, shape, dp, tp)
        want_param = param_bytes_by_specs(cfg, sizes, variant, multi)
        coll = {k: v for k, v in prof.collective_bytes.items() if v}
        log(f"phase 21 (a): {'the zoo cell ' if zoo else ''}{cfg.name}/{shape_name} "
            f"@ {label} [{variant}] per device: "
            f"num_devices {prof.num_devices}, dot_flops {prof.dot_flops:.6e}, flops "
            f"{prof.flops:.6e}, hbm_bytes {prof.hbm_bytes:.6e}, collective bytes {coll}, "
            f"pod_collective_bytes {prof.pod_collective_bytes:.6e}, parameter bytes "
            f"{prof.meta['param_bytes_per_device']:.6e} (the specs' shards {want_param}), "
            f"peak {prof.peak_memory_bytes:.6e} B, {prof.meta['aten_ops']} ATen operations, "
            f"{prof.compile_seconds:.1f} s on meta ({time.perf_counter() - t0:.1f} s "
            "since its child started)")
        check(prof.num_devices == n and prof.mesh == label,
              f"phase 21 (a): {arch} profiled on {prof.mesh} x {prof.num_devices}")
        check(prof.dot_flops == cfg.n_layers * per_layer + unembed,
              f"phase 21 (a): {arch} dot FLOPs {prof.dot_flops:.6e}, by hand "
              f"{cfg.n_layers} x {per_layer:.6e} + {unembed:.6e}")
        check(prof.total_collective_bytes > 0, f"phase 21 (a): {arch} has no collectives")
        check((prof.pod_collective_bytes > 0) == multi,
              f"phase 21 (a): {arch} pod-crossing bytes {prof.pod_collective_bytes} "
              f"on {label}")
        check(prof.meta["param_bytes_per_device"] == want_param,
              f"phase 21 (a): {arch} parameter bytes {prof.meta['param_bytes_per_device']} "
              f"against the specs' shards {want_param}")
        out[(arch, shape_name)] = prof
    return out


def _p21_joint(torch, core, KC, dev):
    """(b): the hillclimb launcher with --mesh pod --joint in a child (the
    fake world owns it; its co-design runs on the card), then holds."""
    import numpy as np
    from repro_torch import configs as C
    from repro_torch.core import codesign as CD
    from repro_torch.core import constrained as CN

    out_dir = os.path.join(_p21_dir(), "hillclimb")
    code = ("import json, sys\n"
            f"sys.path.insert(0, {SRC!r})\n"
            "from repro_torch.core import kernels_cuda as KC\n"
            "from repro_torch.launch import hillclimb as HC\n"
            "KC.reset_launch_counts()\n"
            f"rc = HC.main(['--arch', {HC_ARCH!r}, '--shape', {HC_SHAPE!r}, "
            f"'--mode', 'flash', '--mesh', {P21_JOINT_MESH[0]!r}, '--joint', "
            f"'--grad', '{P21_GRAD}', '--sweep', '{HC_SWEEP_N}', '--device', {dev!r}, "
            f"'--out', {out_dir!r}])\n"
            "print(json.dumps({'rc': rc, 'counts': KC.launch_counts()}))\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=900, env=dict(os.environ, PYTHONPATH=SRC))
    seconds = time.perf_counter() - t0
    check(res.returncode == 0, f"phase 21 (b): hillclimb --joint failed: "
          f"{res.stdout[-2000:]}{res.stderr[-3000:]}")
    tail = json.loads(res.stdout.strip().splitlines()[-1])
    check(tail["rc"] == 0, f"phase 21 (b): hillclimb returned {tail['rc']}")
    counts = tail["counts"]
    check(counts["congruence"] > 0 and counts["default_beta"] > 0,
          f"phase 21 (b): the joint co-design missed a kernel: {counts}")
    name = C.get_config(HC_ARCH).name
    with open(os.path.join(out_dir, f"{name}__{HC_SHAPE}__{P21_JOINT_MESH[1]}__"
                           "zero1__flash.json")) as f:
        blob = json.load(f)
    jd = blob["meta"]["joint_codesign"]
    prof = core.WorkloadProfile.from_json(blob)
    prof.meta = {}
    from repro_torch.launch import hillclimb as HC
    sweep_line = _hold_sweep(torch, core, HC, dev, prof, blob["meta"]["codesign_sweep"],
                             "phase 21 (b)")
    group = [prof] + [core.WorkloadProfile.from_json(p)
                      for p in blob["meta"]["joint_profiles"]]
    coll = {p.name: p.collective_bytes for p in group}
    check(len(group) == 3 and all(p.num_devices == P21_JOINT_MESH[2] for p in group),
          f"phase 21 (b): the joint group {[(p.name, p.num_devices) for p in group]}")
    totals = [p.total_collective_bytes for p in group]
    check(len(set(totals)) == 3, f"phase 21 (b): the variants' collective bytes {coll}")
    fsdp = next(p for p in group if p.name.endswith("@fsdp"))
    check(all(fsdp.collective_bytes["all-gather"] > p.collective_bytes["all-gather"]
              for p in group if p is not fsdp),
          f"phase 21 (b): fsdp does not add parameter all-gathers: {coll}")
    seeds = core.MachineBatch.from_models(core.VARIANTS)
    card = core.joint_codesign([group], seeds, steps=P21_GRAD, device=dev)
    traj = np.asarray(card.trajectory)
    check(bool((np.diff(traj, axis=0) <= 1e-12 * np.abs(traj[:-1]) + 1e-15).all()),
          "phase 21 (b): the joint trajectory rises")
    bad = blob_diffs(jd, card.to_json())
    check(not bad, f"phase 21 (b): the launcher's joint result against the same "
          f"call here: {bad[:5]}")
    flat = list(group)
    flat_pb = core.ProfileBatch.from_profiles(flat)
    gids = np.zeros(len(flat), dtype=np.int64)
    beta = CD.resolve_beta(flat_pb, seeds, None, 0)[[0]][gids]
    rescored = _rescore(core, CD, flat, card, beta, lambda agg: CN._hard_weights(agg, gids))
    err = float(np.max(np.abs(np.asarray(rescored) - np.asarray(card.objective_final))))
    check(err <= P21_RESCORE, f"phase 21 (b): the NumPy re-score is {err:.3e} off")
    log(f"phase 21 (b): hillclimb {HC_ARCH} {HC_SHAPE} --mode flash --mesh "
        f"{P21_JOINT_MESH[0]} --joint "
        f"--grad {P21_GRAD} in {seconds:.1f} s (child process): collective bytes per "
        f"device {dict(zip([p.name for p in group], totals))}; best "
        f"{jd['best_variant']} picks {jd['selection'][jd['best_variant']]}; trajectory "
        f"{traj[0].min():.6g} -> {traj[-1].min():.6g} never rises; NumPy re-score "
        f"within {err:.3e}; --sweep {HC_SWEEP_N}: {sweep_line}; launches {counts}")
    return dict(counts=counts, seconds=seconds)


def _p21_nccl(torch, core, KC, dev, profiles):
    """(c), in the NCCL world of the card that ``_main`` runs phases 21-22
    in: shard_sweep over the variants mesh against the meshless run, and a
    train step sharded on a 1 x 1 mesh against the unsharded step."""
    import numpy as np
    from repro_torch import configs as C
    from repro_torch.distributed import ctx as CTX
    from repro_torch.distributed import place as PL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as MESH
    from repro_torch.optim import adamw
    from repro_torch.training.step import init_state, loss_and_grads, make_train_step

    n = MESH.world_size()
    vmesh = MESH.make_variant_mesh()
    kw = dict(n=P21_SWEEP_N, include_named=core.VARIANTS, num_shards=4,
              device=dev)
    plain = core.shard_sweep(profiles, **kw)
    KC.reset_launch_counts()
    split = core.shard_sweep(profiles, mesh=vmesh, **kw)
    torch.cuda.synchronize()
    counts = KC.launch_counts()
    check(split.mesh_axis == f"variants={n} mesh",
          f"phase 21 (c): mesh_axis {split.mesh_axis!r}")
    check(counts["sweep_stats"] == split.num_shards,
          f"phase 21 (c): K4 launches {counts['sweep_stats']} for {split.num_shards} shards")
    check(split.candidate_indices.tolist() == plain.candidate_indices.tolist(),
          "phase 21 (c): the survivors differ from the meshless run")
    check(split.best_fit_map == plain.best_fit_map,
          "phase 21 (c): best fits differ from the meshless run")
    check(split.pareto_names() == plain.pareto_names(),
          "phase 21 (c): the fronts differ from the meshless run")
    check(bool(np.array_equal(split.result.aggregate, plain.result.aggregate,
                              equal_nan=True)),
          "phase 21 (c): the re-scored survivors differ from the meshless run")

    cfg = C.get_config(HC_ARCH).replace(n_layers=P21_TRAIN_LAYERS,
                                        compute_dtype="float32")
    oc = adamw.OptimizerConfig(warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, oc)
    gen = torch.Generator(dev).manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (P21_TRAIN_B, P21_TRAIN_S),
                              generator=gen, device=dev) for k in ("tokens", "labels")}
    state = init_state(cfg, oc, device=dev)
    g_plain = loss_and_grads(state["params"], cfg, batch)[2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m_plain = step(state, batch)
    loss_plain = float(m_plain["loss"])
    plain_s = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    mesh = MESH.make_mesh((1, 1), ("data", "model"))
    sc = SH.ShardingConfig(variant="zero1")
    state = init_state(cfg, oc, device=dev)
    PL.shard_state(cfg, state["params"], mesh, sc, state)
    sb = PL.shard_batch(batch, mesh, sc)
    with PL.sharded_step(), CTX.use_rules(SH.activation_rules(mesh, sc, "train")):
        g = loss_and_grads(state["params"], cfg, sb)[2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, sb)
        loss = float(PL.full(m["loss"]))
        torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    scale = max(float(t.abs().max()) for t in g_plain.values())
    grad_err = max(float((PL.full(g[k]) - g_plain[k]).abs().max())
                   for k in g_plain) / scale
    rel_loss = abs(loss - loss_plain) / abs(loss_plain)
    check(rel_loss <= 1e-6, f"phase 21 (c): sharded loss {loss!r} against "
          f"unsharded {loss_plain!r} ({rel_loss:.3e} relative)")
    check(grad_err <= P21_GRAD_TOL, f"phase 21 (c): the sharded gradients are {grad_err:.3e} "
          "off the unsharded ones (on the largest's scale)")
    del state, g, g_plain
    torch.cuda.empty_cache()
    log(f"phase 21 (c): {P21_BACKEND} world of {n}: shard_sweep gen:64 x {split.num_variants} "
        f"in {split.num_shards} shards on {split.mesh_axis} equal to the meshless run "
        f"(survivors, best fits, front, re-scored aggregate bit for bit); "
        f"{cfg.name} at {P21_TRAIN_LAYERS} layers, B {P21_TRAIN_B} S {P21_TRAIN_S}, "
        f"f32: sharded step on 1x1 loss {loss!r} against {loss_plain!r} "
        f"({rel_loss:.3e}), gradients {grad_err:.3e} off; step {sharded_s:.3f} s sharded, "
        f"{plain_s:.3f} s plain; launches {counts}")
    return dict(counts=counts)


def phase_sharded(torch, core, KC, dev, children, profiles):
    """Phase 21: (a) the dry runs' per-device profiles, (b) --joint on the
    pod mesh, (c) the NCCL world."""
    t_phase = time.perf_counter()
    _p21_dryruns(core, children)
    t_a = time.perf_counter() - t_phase
    b = _p21_joint(torch, core, KC, dev)
    c = _p21_nccl(torch, core, KC, dev, profiles)
    counts = {k: b["counts"][k] + c["counts"][k] for k in b["counts"]}
    seconds = time.perf_counter() - t_phase
    log(f"phase 21: {seconds:.1f} s ((a) waited {t_a:.1f} s for the dry runs, "
        f"(b) {b['seconds']:.1f} s); launches {counts}")
    return dict(counts=counts, seconds=seconds)


@contextlib.contextmanager
def nccl_world(torch):
    """A real NCCL world of the card in this process, for phase 21 (c) and
    phase 22."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as MESH

    n = torch.cuda.device_count()
    check(n == 1, f"phases 21 (c) and 22 run one process, so one card; {n} are visible")
    os.makedirs(_p21_dir(), exist_ok=True)
    store = os.path.join(_p21_dir(), "nccl.store")
    MESH.init_world(P21_BACKEND, init_method=f"file://{store}", rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# Phase 22: the model kernels K5-K8 in their local regions on a mesh
# --------------------------------------------------------------------------- #

#: (arch, layers): published width at cut depth; recurrentgemma-9b's 3
#: layers are one group (two RG-LRU blocks and a local-attention block)
P22_MODELS = (("chatglm3-6b", 2), ("falcon-mamba-7b", 2), ("recurrentgemma-9b", 3))
P22_B, P22_S = 4, 2048
P22_STAGES = ("forward", "prefill", "decode")
MODEL_KERNELS = ("wgmma", "fma", "rmsnorm", "rmsnorm_residual", "selective_scan",
                 "causal_conv")


def model_kernel_counts(FA, RN, SS):
    return {"wgmma": FA.flash_attention.launches_wgmma,
            "fma": FA.flash_attention.launches_fma, **ssm_counts(RN, SS)}


def reset_model_kernel_counts(FA, RN, SS):
    FA.reset_launch_counts()
    reset_ssm_counts(RN, SS)


def p22_launches_by_hand(T, cfg, stage, sharded=False):
    """The model kernels' launches in one bf16 forward, prefill or decode
    step under ``attn_impl="pallas"``: K5 (on the tensor cores) in each
    causal self-attention but a decode step's -- each dense layer of a
    forward or prefill, the hybrid's local-attention blocks in a forward or
    prefill -- and K6 once, K7 and K8 once a layer, in each SSM call, with
    the fused conv once a layer unless ``sharded`` (a DTensor's conv is the
    plain one)."""
    out = dict.fromkeys(MODEL_KERNELS, 0)
    if cfg.family == "ssm":
        out.update(rmsnorm=1, rmsnorm_residual=cfg.n_layers, selective_scan=cfg.n_layers,
                   causal_conv=0 if sharded else cfg.n_layers)
    elif cfg.family == "dense" and stage != "decode":
        out["wgmma"] = cfg.n_layers
    elif cfg.family == "hybrid" and stage != "decode":
        out["wgmma"] = T.hybrid_layout(cfg)[0]
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def phase_mesh_kernels(torch, FA, RN, SS, T, C, dev, card):
    """Phase 22, in the NCCL world of ``nccl_world``."""
    import numpy as np
    from repro_torch.distributed import ctx as CTX
    from repro_torch.distributed import place as PL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch.specs import _shapes

    mesh = MESH.make_mesh((1, 1), ("data", "model"))
    sc = SH.ShardingConfig(variant="tp")
    B, S = P22_B, P22_S
    totals = dict.fromkeys(MODEL_KERNELS, 0)
    t_phase = time.perf_counter()

    def rules(stage, sharded):
        if not sharded:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(PL.sharded_step())
        stack.enter_context(CTX.use_rules(SH.activation_rules(
            mesh, sc, "decode" if stage == "decode" else "prefill")))
        return stack

    def steps(model, cfg, batch, tok, cache, sharded=False):
        """A forward, a prefill into ``cache`` and one decode step: -> (their
        hidden states / logits and the cache, each stage's launches)."""
        out, launches = {}, {}
        for stage in P22_STAGES:
            reset_model_kernel_counts(FA, RN, SS)
            with rules(stage, sharded):
                if stage == "forward":
                    out[stage] = T.forward(model, cfg, batch)[0]
                elif stage == "prefill":
                    cache, out[stage] = T.prefill(model, cfg, batch, cache)
                else:
                    cache, out[stage] = T.decode_step(model, cfg, cache, tok, S)
            torch.cuda.synchronize()
            launches[stage] = model_kernel_counts(FA, RN, SS)
        out.update(("cache/" + k, v) for k, v in _leaves(cache))
        return out, launches

    for arch, layers in P22_MODELS:
        cfg = C.get_config(arch).replace(n_layers=layers, attn_impl="pallas")
        check(cfg.compute_dtype == "bfloat16" and (cfg.family != "hybrid"
                                                   or T.hybrid_layout(cfg) == (1, 0)),
              f"phase 22: config {cfg}")
        model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        batch = prompt_of(family_batch(torch, cfg, dev, B, S, seed=1), S)
        tok = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 1)),
                              device=dev)
        want = {stage: p22_launches_by_hand(T, cfg, stage) for stage in P22_STAGES}
        want_split = {stage: p22_launches_by_hand(T, cfg, stage, sharded=True)
                      for stage in P22_STAGES}
        check(sum(sum(w.values()) for w in want.values()) > 0,
              f"phase 22: {arch} launches no model kernel")
        # the plain path's distance from f32, for the bf16 hold
        xla, xla32 = cfg.replace(attn_impl="xla"), cfg.replace(attn_impl="xla",
                                                               compute_dtype="float32")
        plain, _ = steps(model, xla, batch, tok, T.init_cache(xla, B, S + 1, device=dev))
        ref32, _ = steps(model, xla32, batch, tok, T.init_cache(xla32, B, S + 1, device=dev))
        noise = {k: rel(plain[k], ref32[k]) for k in plain}
        del plain, ref32
        whole, whole_launches = steps(model, cfg, batch, tok,
                                      T.init_cache(cfg, B, S + 1, device=dev))
        check(whole_launches == want, f"phase 22: {arch} unsharded launches "
              f"{whole_launches}, not {want}")
        fwd_ms = cuda_ms(torch, lambda: T.forward(model, cfg, batch), reps=1, rounds=3)

        PL.shard_state(cfg, model, mesh, sc)
        sb = PL.shard_batch(batch, mesh, sc)
        tok_s = PL.shard_batch({"t": tok}, mesh, sc)["t"]
        cache = T.init_cache(cfg, B, S + 1, device=dev)
        cache = PL.shard_tree(cache, SH.param_specs(_shapes(cache), T.cache_axes(cfg), mesh,
                                                    sc, fsdp=False), mesh)
        split, split_launches = steps(model, cfg, sb, tok_s, cache, sharded=True)
        check(split_launches == want_split, f"phase 22: {arch} sharded launches "
              f"{split_launches}, not {want_split}")

        def sharded_forward():
            with rules("forward", True):
                return T.forward(model, cfg, sb)

        split_ms = cuda_ms(torch, sharded_forward, reps=1, rounds=3)
        got = {k: PL.full(v) for k, v in split.items()}
        check(all(bool(torch.isfinite(v.float()).all()) and v.shape == whole[k].shape
                  and v.dtype == whole[k].dtype for k, v in got.items()),
              f"phase 22: {arch}: a sharded output is not finite or not shaped as "
              "the unsharded one")
        if all(torch.equal(v, whole[k]) for k, v in got.items()):
            held = "bit for bit"
        else:
            errs = {k: rel(v, whole[k]) for k, v in got.items()}
            limits = {k: max(HIDDEN_RTOL, BF16_NOISE_FACTOR * noise[k]) for k in errs}
            held = (f"within max({HIDDEN_RTOL}, {BF16_NOISE_FACTOR} x the plain path's "
                    f"distance from f32): " + ", ".join(
                        f"{k} {errs[k]:.3e} (limit {limits[k]:.3e})" for k in errs))
            bad = [k for k in errs if not errs[k] <= limits[k]]
            check(not bad, f"phase 22: {arch}: sharded {bad} differ from the unsharded "
                  f"kernel run: {held}")
        for launches in (whole_launches, split_launches):
            for stage in P22_STAGES:
                for k in MODEL_KERNELS:
                    totals[k] += launches[stage][k]
        log(f"phase 22: {arch} at {layers} layers (published width), B {B} S {S}, bf16, "
            f"pallas, on a 1x1 (data, model) mesh under tp: forward, prefill and decode "
            f"step (logits, cache) equal to the unsharded kernel run {held}; launches "
            f"by stage, sharded {split_launches} (held exactly, as unsharded but the "
            f"conv, plain on a DTensor)")
        log(json.dumps({"timing": "mesh_forward", "arch": arch, "layers": layers, "B": B,
                        "S": S, "compute_dtype": "bfloat16", "attn_impl": "pallas",
                        "mesh": "1x1", "unsharded_ms": fwd_ms, "sharded_ms": split_ms,
                        "card": card}))
        del model, batch, sb, cache, split, got, whole
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"phase 22: {seconds:.1f} s; launches {totals}")
    return dict(counts=totals, seconds=seconds)


# --------------------------------------------------------------------------- #
# Phase 23: qwen3-32b and qwen1.5-4b at published size through K5
# --------------------------------------------------------------------------- #

#: (arch, B, its published (n_layers, d_model, n_heads, n_kv_heads,
#: head_dim, param_dtype)).  qwen3-32b at B 4, reckoned before its first
#: run: 65.5 GB of bf16 weights; the K5 forward's activations near 2 GB a
#: layer (the MLP's 8192 x 25600 products, 0.42 GB each in bf16); the plain
#: f32 forward's near 8 GB (a 1024-row chunk of f32 scores, 2.1 GB, a few
#: times over, and a layer's weights cast to f32): under the card's 80 GB.
P23_MODELS = (("qwen3-32b", 4, (64, 5120, 64, 8, 128, "bfloat16")),
              ("qwen1.5-4b", 4, (40, 2560, 20, 20, 128, "float32")))
P23_S = 2048


# --------------------------------------------------------------------------- #
# Phase 24: the cached prefill's attention on K5 at the qwen1.5-4b cells' shapes
# --------------------------------------------------------------------------- #

#: (B, S, cache rows, layers of the stacked cache): the 32k request and the
#: chat mix's three shapes with a cache of S rows, as the benchmark's cells
#: allocate it; then chat's 8 x 512 in the second layer of a two-layer cache
#: of 2 048 rows, so that k and v are views at an offset base with batch
#: stride 2 048 x K x hd, as a longer cache gives them in ``forward``
P24_SHAPES = ((1, 32768, 32768, 1), (32, 128, 128, 1), (16, 256, 256, 1),
              (8, 512, 512, 1), (8, 512, 2048, 2))
#: max over rows of max |K5 route - plain path| / the plain row's std
#: (``perfbench/check.py``'s measure) of one layer's attention output; the
#: same bound as ``tests/test_torch_kernels.py``'s card test of the route
P24_BOUND = 0.1


def cached_prefill_layer(torch, FA, L, T, cfg, dev, B, S, rows, layers):
    """One attention layer of ``cfg`` in a cached prefill (``cache_index``
    0, q_pos 0..S-1, k_pos 0..rows-1, as ``forward`` calls it), under
    ``attn_impl="pallas"`` and then ``"xla"``, each over a zeroed bf16 cache
    of ``layers`` x B x ``rows`` positions of which it writes the last
    layer.  Returns the outputs, the written caches and K5's launches of
    each call (counted from a reset just before it)."""
    gen = torch.Generator(dev).manual_seed(B * S + rows)
    params = L.attn_init(cfg, gen, dev)
    params.update({n: torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
                   for n, p in params.items() if n.startswith("b")})
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).bfloat16()
    q_pos = torch.arange(S, device=dev).expand(B, S)
    k_pos = torch.arange(rows, device=dev).expand(B, rows)
    rope = T._rope_for(cfg, q_pos)
    out, caches, launches = {}, {}, {}
    for impl in ("pallas", "xla"):
        stacked = {n: torch.zeros((layers, B, rows, cfg.n_kv_heads, cfg.head_dim_),
                                  dtype=torch.bfloat16, device=dev) for n in ("k", "v")}
        FA.reset_launch_counts()
        with torch.inference_mode():
            out[impl], caches[impl] = L.attn_apply(
                params, cfg.replace(attn_impl=impl), x, rope=rope,
                mask=L.MaskSpec(causal=True), q_pos=q_pos, k_pos=k_pos,
                cache=T._at(stacked, layers - 1), cache_index=0)
        launches[impl] = {"wgmma": FA.flash_attention.launches_wgmma,
                          "fma": FA.flash_attention.launches_fma}
    FA.reset_launch_counts()
    return out, caches, launches


def phase_dense_published(torch, FA, T, C, dev, card):
    """Phase 23: each model alone on the card (the one before freed)."""
    from repro_torch.models import layers as L

    totals = {"wgmma": 0, "fma": 0}
    t_phase = time.perf_counter()
    for arch, B, widths in P23_MODELS:
        S = P23_S
        cfg = C.get_config(arch)
        check(cfg.compute_dtype == "bfloat16" and (
            cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            cfg.param_dtype) == widths, f"phase 23: config {cfg}")
        t0 = time.perf_counter()
        model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"phase 23: {arch} ({n_params:.4g} parameters, {cfg.param_dtype}, "
            f"{torch.cuda.memory_allocated() / 1e9:.1f} GB) drawn on the card in "
            f"{time.perf_counter() - t0:.2f} s; B {B} S {S}")
        batch = prompt_of(family_batch(torch, cfg, dev, B, S, seed=1), S)
        kc = cfg.replace(attn_impl="pallas")
        cfg32 = cfg.replace(compute_dtype="float32")
        FA.reset_launch_counts()
        t0 = time.perf_counter()
        hidden, _ = T.forward(model, kc, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        fwd = {"wgmma": FA.flash_attention.launches_wgmma,
               "fma": FA.flash_attention.launches_fma}
        want = {"wgmma": cfg.n_layers, "fma": 0}
        check(fwd == want, f"phase 23: {arch}: K5 launched {fwd}, not {want} a forward")
        check(hidden.shape == (B, S, cfg.d_model) and hidden.dtype == torch.bfloat16
              and bool(torch.isfinite(hidden).all()),
              f"phase 23: {arch}: hidden {hidden.shape} {hidden.dtype}, or not finite")
        h_plain, _ = T.forward(model, cfg, batch)
        ref32, _ = T.forward(model, cfg32, batch)
        torch.cuda.synchronize()
        check(FA.flash_attention.launches == cfg.n_layers,
              f"phase 23: {arch}: the plain attention launched K5")
        peak = torch.cuda.max_memory_allocated() / 1e9
        h_err, noise = rel(hidden, h_plain), rel(h_plain, ref32)
        h_limit = max(HIDDEN_RTOL, BF16_NOISE_FACTOR * noise)
        log(f"phase 23: {arch}: K5 forward {tuple(hidden.shape)} in {first_s:.3f} s "
            f"(first call), {fwd['wgmma']} K5 launches on the tensor cores; against the "
            f"plain attention on the same weights: bf16 hidden max err {h_err:.3e} of "
            f"max |hidden| (limit {h_limit:.3e}: {HIDDEN_RTOL}, or {BF16_NOISE_FACTOR} x "
            f"the plain bf16 path's own distance {noise:.3e} from the f32 forward); "
            f"allocator peak so far {peak:.1f} GB")
        check(h_err <= h_limit, f"phase 23: {arch}: bf16 hidden differs from the plain "
              f"attention by {h_err:.3e}")
        del hidden, h_plain, ref32
        torch.cuda.empty_cache()
        prefill_decode_hold(torch, T, L, model, kc.replace(compute_dtype="float32"),
                            dev, f"23 ({arch})")
        fwd_ms = cuda_ms(torch, lambda: T.forward(model, kc, batch), reps=2, rounds=3)
        fwd_plain_ms = cuda_ms(torch, lambda: T.forward(model, cfg, batch), reps=1,
                               rounds=2)
        log(json.dumps({"end_to_end": "forward", "arch": arch, "B": B, "S": S,
                        "compute_dtype": cfg.compute_dtype, "attn_impl": "pallas",
                        "ms": fwd_ms, "tokens_per_s": B * S / fwd_ms * 1e3,
                        "plain_attention_ms": fwd_plain_ms,
                        "plain_attention_tokens_per_s": B * S / fwd_plain_ms * 1e3,
                        "card": card}))
        log(json.dumps({"profile": "forward", "arch": arch, "attn_impl": "pallas",
                        **device_split(torch, lambda: T.forward(model, kc, batch))}))
        totals["wgmma"] += fwd["wgmma"]
        del model, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    seconds = time.perf_counter() - t_phase
    log(f"phase 23: {seconds:.1f} s; K5 launches {totals}")
    return dict(counts=totals, seconds=seconds)


def phase_cached_prefill(torch, FA, T, C, dev):
    """Phase 24: the route ``attn_apply`` gives a cached prefill -- K5 over
    the cache rows just written -- held to the plain q-chunked path at the
    shapes the qwen1.5-4b cells run it at, one layer at published width
    (MHA 20 x 128, QKV bias, rope theta 5e6, bf16)."""
    from repro_torch.models import layers as L

    cfg = C.get_config("qwen1.5-4b").replace(param_dtype="bfloat16", rope_theta=5e6)
    totals = {"wgmma": 0, "fma": 0}
    t_phase = time.perf_counter()
    for B, S, rows, layers in P24_SHAPES:
        out, caches, launches = cached_prefill_layer(torch, FA, L, T, cfg, dev,
                                                     B, S, rows, layers)
        torch.cuda.synchronize()
        want = {"pallas": {"wgmma": 1, "fma": 0}, "xla": {"wgmma": 0, "fma": 0}}
        check(launches == want, f"phase 24: B {B} S {S} cache {rows}: K5 launched "
              f"{launches}, not {want}")
        for n in ("k", "v"):
            check(torch.equal(caches["pallas"][n], caches["xla"][n]),
                  f"phase 24: B {B} S {S} cache {rows}: the caches' {n} differ")
        got, plain = out["pallas"].float(), out["xla"].float()
        err = float(((got - plain).abs().amax(dim=-1) / plain.std(dim=-1)).max())
        log(f"phase 24: cached prefill B {B} S {S}, cache {layers} x {rows} rows: K5 "
            f"over the rows just written against the plain path {err:.4f} of the row "
            f"std (bound {P24_BOUND}); K5 launches {launches['pallas']}")
        check(err <= P24_BOUND, f"phase 24: B {B} S {S} cache {rows}: K5 differs from "
              f"the plain path by {err:.4f} of the row std")
        totals["wgmma"] += launches["pallas"]["wgmma"]
        del out, caches
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"phase 24: {seconds:.1f} s; K5 launches {totals}")
    return dict(counts=totals, seconds=seconds)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch.core as core
    from repro_torch.core import _build
    from repro_torch.core import kernels_cuda as KC

    t_script = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = nvidia_smi()
    log(f"card: {card}")
    children = []
    try:
        return _main(torch, core, _build, KC, dev, card, t_script, children)
    finally:
        stop_children(children)


def _main(torch, core, _build, KC, dev, card, t_script, children) -> int:
    def mark(phases):
        log(f"chip_smoke: phase {phases} done at {time.perf_counter() - t_script:.1f} s")

    t0 = time.perf_counter()
    _build.lib()
    log(f"phase 1: built {_build.build_info['path']} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    fma = fma_instantiations(ptxas_report(_build.build_info.get("log", "")))
    for (dname, dp), props in sorted(fma.items()):
        log(f"phase 1: FMA K5 kernel, {dname}, head dims up to {dp}: "
            f"{props.get('registers')} registers, "
            f"{_build.lib().repro_flash_attention_smem_bytes(dp)} B of dynamic "
            f"shared memory, {props.get('spill_stores')} / {props.get('spill_loads')} "
            f"B spill stores / loads, {props.get('stack')} B stack frame")
    check(len(fma) == 8, f"ptxas reported {len(fma)} of the FMA K5 kernel's 8 "
          "instantiations")
    spills = [key for key, props in fma.items()
              if props.get("spill_stores") != 0 or props.get("spill_loads") != 0]
    check(not spills, f"the FMA K5 kernel spills at {spills}")
    sm90 = sm90_instantiations(ptxas_report(_build.build_info.get("log", "")))
    for d, props in sorted(sm90.items()):
        log(f"phase 1: tensor-core K5 kernel, head dim {d}: "
            f"{props.get('registers')} registers a thread ("
            + ("384 threads; setmaxnreg gives the consumers 240 at run time"
               if d <= 128 else "256 threads, no producer warpgroup") + "), "
            f"{_build.lib().repro_flash_attention_sm90_smem_bytes(d)} B of dynamic "
            f"shared memory, {props.get('spill_stores')} / {props.get('spill_loads')} "
            f"B spill stores / loads, {props.get('stack')} B stack frame")
    check(sorted(sm90) == [64, 128, 256], f"ptxas reported the tensor-core K5 kernel "
          f"at head dims {sorted(sm90)}, not 64, 128 and 256")
    spills = [d for d, props in sm90.items()
              if props.get("spill_stores") != 0 or props.get("spill_loads") != 0]
    check(not spills, f"the tensor-core K5 kernel spills at head dims {spills}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass_loops = {}
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", _build.build_info["path"]],
                              capture_output=True, text=True, timeout=300).stdout
        hgmma, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif fn and "flash_attention_sm90_k" in fn and "HGMMA" in line:
                hgmma[fn] = hgmma.get(fn, 0) + 1
        log(f"phase 1: HGMMA instructions in the SASS of the tensor-core K5 kernel: "
            f"{sorted(hgmma.values())} in its {len(hgmma)} instantiations (D 64, 128, 256)")
        check(len(hgmma) == 3, "the tensor-core K5 kernel's SASS lacks HGMMA in "
              f"{3 - len(hgmma)} of its 3 instantiations")
        fns = sass_functions(sass)
        with open(os.path.join(ROOT, "build", "congruence.sass"), "w") as f:
            for fn, instrs in fns.items():
                if "congruence_cu" in fn:
                    f.write(f"Function : {fn}\n")
                    f.writelines(f"  /*{a:04x}*/ {t} ;\n" for a, t in instrs)
        for kernel, (inst, marker, per_cell) in SASS_LOOPS.items():
            found = ([fn for fn in fns if f"{kernel}{inst}" in fn]
                     or [fn for fn in fns if kernel in fn])
            sass_loops[kernel] = (cell_loop(fns[found[0]], marker, per_cell)
                                  if found else None)
            log(f"phase 1: SASS cell loop of {kernel}: " + (
                "not found" if not sass_loops[kernel] else
                "{:.1f} instructions a cell ({} in the loop, {} cells an "
                "iteration)".format(*sass_loops[kernel])))
    else:
        log("phase 1: cuobjdump not found; the HGMMA check and the SASS "
            "instruction bounds are left out")

    errs = phase_kernels(torch, core, KC, dev)
    p3 = phase_run_sweep(torch, core, KC, dev)
    p4 = phase_shard_sweep(torch, core, KC, dev, p3["profiles"])
    rows = phase_timings(torch, core, KC, dev, p3, sass_loops)
    mark("1-5")
    log(json.dumps({"end_to_end": "shard_sweep_streamed", "A": 64,
                    "V": p4["result"].num_variants,
                    "shards": p4["result"].num_shards,
                    "seconds": p4["seconds"],
                    "cells_per_s": p4["cells"] / p4["seconds"]}))

    from repro_torch import configs as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E

    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import selective_scan as SS

    fa = phase_flash_attention(torch, FA, dev)
    torch.cuda.empty_cache()
    mark(6)
    model, cfg, fa_launches = phase_model(torch, FA, T, C, dev)
    phase_serving(torch, FA, T, E, model, cfg, dev)
    p18c = phase_zoo_card_cell(torch, model, dev)
    del model
    torch.cuda.empty_cache()
    mark("7-8")

    ssm_rows = phase_ssm_kernels(torch, RN, SS, dev)
    torch.cuda.empty_cache()
    model, cfg, ssm_launches = phase_ssm_model(torch, RN, SS, T, C, dev)
    phase_ssm_serving(torch, RN, SS, T, E, model, cfg, dev)
    del model
    torch.cuda.empty_cache()
    mark("9-11")

    p12 = phase_codesign(torch, core, KC, dev, p3)
    mark(12)

    for spec in FAMILY_PHASES:
        torch.cuda.empty_cache()
        family_launches = phase_family(torch, FA, T, E, C, dev, spec)
        for kernel, count in family_launches.items():
            fa_launches[kernel] += count
        mark(spec["phase"])
    torch.cuda.empty_cache()

    p17 = phase_frontier_service(torch, core, KC, dev, p3, p12)
    torch.cuda.empty_cache()
    mark(17)
    p18 = phase_measurement(torch, core, KC, dev, p18c)
    torch.cuda.empty_cache()
    mark(18)
    FA.reset_launch_counts()
    reset_ssm_counts(RN, SS)
    p19 = phase_training(torch, T, C, dev)
    check(FA.flash_attention.launches == 0 and not any(ssm_counts(RN, SS).values()),
          "phase 19 launched a model kernel (training takes attn_impl='xla')")
    log(json.dumps({"end_to_end": "train_step", "arch": TRAIN_ARCH, "B": TRAIN_B,
                    "S": TRAIN_S, "step_s": p19["step_s"],
                    "decoder_tokens_per_s": p19["tokens_per_s"]}))
    torch.cuda.empty_cache()
    # phase 21 (a)'s dry runs on the host's cores from here on: phase 20's
    # extraction is on meta, and the timings of phases 1-19 come first
    children.extend(start_dryrun_children())
    p20 = phase_hillclimb(torch, core, KC, dev)
    torch.cuda.empty_cache()
    mark("19-20")
    with nccl_world(torch):
        p21 = phase_sharded(torch, core, KC, dev, children, p3["profiles"])
        torch.cuda.empty_cache()
        mark(21)
        p22 = phase_mesh_kernels(torch, FA, RN, SS, T, C, dev, card)
    torch.cuda.empty_cache()
    mark("22")
    p23 = phase_dense_published(torch, FA, T, C, dev, card)
    mark(23)
    torch.cuda.empty_cache()
    p24 = phase_cached_prefill(torch, FA, T, C, dev)
    mark(24)
    for p in (p22, p23, p24):
        fa_launches["wgmma"] += p["counts"]["wgmma"]
        fa_launches["fma"] += p["counts"]["fma"]
    for name in ("rmsnorm", "rmsnorm_residual", "selective_scan", "causal_conv"):
        ssm_launches[name] += p22["counts"][name]

    kernels = []
    for name in REPLACES:
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=(p3["counts"][name] + p4["counts"][name]
                      + p12["counts"][name] + p17["counts"][name]
                      + p18["counts"][name] + p20["counts"][name]
                      + p21["counts"][name]),
            max_abs_err=errs[name], ms=rows[name]["ms"],
            plain_ms=rows[name]["plain_ms"], bound_ms=rows[name]["bound_ms"],
            bound_by=rows[name]["bound_by"], library_ms=None))
        check(kernels[-1]["launches"] > 0, f"{name} never launched")
    for kernel, source in (("wgmma", FA_WGMMA_SOURCE), ("fma", FA_SOURCE)):
        row = fa[kernel]
        kernels.append(dict(
            name=f"flash_attention_{kernel}", route="cuda", source=source,
            replaces=FA_REPLACES, launches=fa_launches[kernel],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
        check(kernels[-1]["launches"] > 0, f"flash_attention_{kernel} never launched")
    for name in ("rmsnorm", "rmsnorm_residual", "selective_scan", "causal_conv"):
        row = ssm_rows[name]
        source, replaces = {"selective_scan": (SCAN_SOURCE, SCAN_REPLACES),
                            "causal_conv": (CONV_SOURCE, CONV_REPLACES)}.get(
                                name, (RMS_SOURCE, RMS_REPLACES.get(name)))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=ssm_launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
        check(kernels[-1]["launches"] > 0, f"{name} never launched")
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all, the build "
        "included")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
