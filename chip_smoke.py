#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name, count and power limit (no card -> exit 1);
  2. build: both CUDA sources (the NATSA kernel and the flash-attention
     kernels), one nvcc each, started together, for sm_90a, with ptxas'
     register / spill lines; the registers, spills and static shared
     memory of each instance of the NATSA sweep kernel with the dynamic
     shared memory of its launch, and the same for each instance of the
     tensor-core flash kernel (no NATSA instance may spill);
  3. the NATSA kernel against its plain PyTorch version on the same CUDA
     tensors, on small cases (self-join, AB with and without an exclusion
     split, NaN gaps, bf16 streams) and on the edge cases of
     `natsa_edge_cases` (geometries cut around the kernel's tiles): within
     1e-4 in correlation, indices differing only at near-ties;
  4. the main path at full size, self-join: `matrix_profile` on a seeded
     random walk of n=262144, m=512 (the ecg-256k workload) with a planted
     motif pair, checked against an f64 exact profile of 64 sampled rows;
     the kernel's four launches at this size (one warm-up, three timed)
     must give bitwise equal outputs (`bitwise_repeat`); the roofline
     model's terms (`ops.kernel_roofline`, the rates of
     `repro_torch.launch.roofline`) beside the bound, whose compute terms
     must agree;
  5. the main path at full size, AB join: `ab_join(a, b, 128,
     return_b=True)` with |a| = 131072 (epilepsy-128k), |b| = 32768, with
     the same checks, and the NATSA kernel timed at 1, 2 and 4 warps per
     SM on full-length diagonals (`warps_per_sm_probe`);
  5b. `main_paper`: every workload of `repro_torch.configs.natsa`'s
     PAPER_WORKLOADS in order (seismology-64k, epilepsy-128k, ecg-256k,
     power-512k), each a self-join through `matrix_profile` on the card
     with a planted motif pair and the default exclusion: one NATSA
     launch, the pair both ways, 64 sampled rows against their f64 exact
     profile within 1e-3, the kernel's ms (three launches after a warm-up)
     beside its bound and `kernel_roofline`, the kernel against its plain
     version at full size (phase 4's rule), the host prep, device and
     host peaks; ecg-256k is phase 4's record;
  6. the flash-attention kernels against their plain version on the card:
     the reference's shape table and shapes off the kernels' 128-row tile
     in f32 (2e-4, the CUDA-core "fma" route; also train_lm_torch's
     attention, (4, 6, 96, 64) causal over 3 KV heads), the same shapes plus a
     non-causal one at D=128, D=64 at S=4096 and whisper-large-v3's
     encoder shape (1, 20, 1500, 64, non-causal) in bf16 (the tensor-core
     "wgmma" route; 3e-2 and each element within one bf16 rounding), and
     block-size invariance (1e-5); each launch is counted on its route;
  7. the flash path at full width: `flash_attention` at llama3-8b's
     prefill_32k shape (B=1, H=32, S=32768, D=128, bf16, causal; K/V made
     with 8 heads and repeated to 32), through the wgmma route (checked by
     its route count), each output element within
     2^-7 |plain| + 1e-5 of the plain version's (and the whole within
     1e-2 x max|plain|), timed beside its bound and beside PyTorch's
     `scaled_dot_product_attention` (a yardstick only); a planted fault
     (head 0's keys < 64 dropped for rows past 4096) must fail that
     element check;
  8. the band engine (`plan_sweep(backend="engine")`) against the kernel
     path on the card, self-join n=65536 m=512 and AB 32768x8192 m=128,
     under the full-size near-tie rule at 1e-3;
  9. `main_topk`: `matrix_profile(ts, 512, k=4)` at ecg-256k with a
     planted motif pair, on the band engine by the planner's fallback (no
     NATSA launch): slot 0 against the k = 1 kernel path under the
     full-size rule, all four slots of 64 sampled rows against their f64
     exact top-4, the pair in slot 0 both ways;
 10. `main_rowstream`: `ab_join(q, b, 128, backend="rowstream",
     return_b=True)`, 4096 query subsequences against epilepsy-128k's
     131072 samples, at k = 1 (against the NATSA kernel path under the
     full-size rule) and k = 4 (slot 0 bit for bit the k = 1 result; 64
     sampled rows of each side against their f64 exact top-4);
 11. `main_batch`: `batch_profile` of 4 series at bench-16k, and
     `batch_ab_join` of 8 queries (l = 4096) against 8 series of 32768 on
     rowstream and with k = 4 on the engine, each stacked result bit for
     bit the per-series sequential calls;
 12. `main_nonnorm`: `matrix_profile(ts, 256, normalize=False)` at
     seismology-64k on a telemetry-like series with a planted level shift
     (`analytics.discords` must name its window), and `ab_join(a, b, 128,
     normalize=False, return_b=True)` at 131072 x 32768; 64 sampled rows
     of each side against their f64 exact raw profile within 2e-3 + 2e-3 d;
     reported, not gated: the same self-join on a random walk and on the
     walk at level 1000, against the oracle;
 13. `main_tile`: `matrix_profile(ts, 512, backend="engine",
     precision="bf16")` at ecg-256k, the tile sweep, within
     `corr_tolerance(bf16, 512)` of 64 f64-oracle rows and of the k = 1
     kernel path (near-tie rule), the same bits with TF32 on globally; its
     FP32 and bf16 floors; reported beside the bound, the error of the
     sampled rows with the products rounded to bf16;
 14. `main_streaming`: `StreamingProfile(128)` over a bench-16k series in
     blocks of 256, z-normalized and raw: the snapshot against the batch
     profile (3e-3) and 64 f64-oracle rows (1e-6), a 4096-point `query`
     bit for bit `ab_join`, the last 64 points re-appended one at a time
     (bitwise equality reported), ms per append;
 15. `main_fleet`: `StreamingFleet` at fleet-10k (10,000 tenants, m=32,
     exclusion 8, capacity 1024: `TelemetryMonitor`'s 8192-sample history
     cut 8x), z-normalized and raw: 512 rounds in one `ingest`, then 16
     one-round ingests timed each (median, max, arrivals/s, peak device
     memory); 8 sampled tenants bit for bit their `StreamingProfile`
     replay; a small wraparound fleet (8 tenants, capacity 96, 400 mixed
     arrivals with NaNs) bit for bit its epoch replay, and its grouped
     ingest bit for bit the same arrivals one at a time; a bf16 `wk` fleet
     within `profile_tolerance`; save, restore and rescale of a 256-tenant
     fleet, each bit for bit;
 16. `main_monitor`: `TelemetryMonitor` at its 8192-sample history on a
     loss-like trace (the raw `scan` alarms within 24 of a planted spike;
     `motif` names a planted pair through one NATSA launch), and
     `FleetMonitor` over 256 tenants of the raw fleet-10k fleet filled to
     capacity: exactly the 4 planted tenants alarm, near their anomalies;
     the whole fleet is scanned when that fits in ~10 s, and an ungated
     pass prints the clean tenants' highest z beside the planted lowest;
 17. `main_serve`: `ProfileService` over a resident `ShardedCorpus` of 64
     series of 65536 samples (m=128, 2 logical shards), 16 concurrent
     queries of 4096 samples at k = 1: one NATSA launch per (query, series)
     pair (1024), the planted window named by series and position, 4
     answers bit for bit the per-pair `ab_join` loop, 64 sampled rows of 2
     answers against the f64 exact union; load, serve, query prep,
     assembly and kernel times apart; the kernel at the serve shape against
     its plain version. k = 4 (4 series of 16384, 2 queries of 512) on the
     per-pair rowstream plan bit for bit the per-pair top-k union, no
     NATSA launch; a seeded `FaultInjector` run (a crashed shard degrades to
     coverage 0.5 bit for bit the survivors' union, a transient failure
     retries to ok, a lapsed deadline answers expired);
 17b. `serve_example`: `examples/serve_profiles_torch.py`'s `main()` on
     the card: the planted series 2 near position 300, the expired answer,
     the rejected ninth query, 72 NATSA launches;
 17c. `examples`: the other four twins' `main()` on the card at the
     reference's sizes, each passing its own assertions:
     `examples/quickstart_torch.py` (1 NATSA launch),
     `ab_query_torch.py` (3), `anomaly_monitor_torch.py` (1) and
     `train_lm_torch.py` (150 steps to a loss under 6.5, a restart for 10
     more: 960 flash launches on the `fma` route), the launches of
     EXAMPLE_LAUNCHES exactly;
 18. `main_anytime`: `AnytimeScheduler` with 8 workers x 8 chunks on the
     one card: the ecg-256k self-join (exclusion 128, a planted pair) and
     epilepsy-128k against 32768 (AB, unswapped), one NATSA launch per
     non-empty chunk (64 each), `round_ms` per round and `fraction_done`
     rising strictly to 1.0; the chunked profiles bit for bit one launch's
     correlations (indices differ only at exact ties, counted), every chunk
     against the plain version under the full-size rule with its kernel
     ms; 64 sampled rows against the f64 oracle, the pair found, the AB
     sides against `ab_join(return_b=True)`; a checkpoint after round 4
     resumed on 4 workers and a seeded supervised run (crashes, retries, a
     killed and flipped checkpoints), each bit for bit the clean run; k = 4
     at bench-16k on the band engine's top-k chunks (no NATSA launch)
     against its f64 exact top-4, its supervised run bit for bit; each
     cell again through a one-rank NCCL group (`make_worker_mesh()`, 1
     worker x 64 chunks, the same 64 chunks; the k = 4 merge through
     NCCL's all-gather): every round bit for bit the one-process
     scheduler's at that plan, `round_ms` of both, 64 NATSA launches at
     ecg-256k and on the AB cell, the correlations bit for bit one
     launch's, the group's checkpoint resumed by the one-process 8-worker
     scheduler to the clean run's bits;
 19. `lm_vs_plain`: llama3-8b at full width, 2 layers, S = 4096 (bf16,
     weights drawn on the card from the seed): the train-mode logits and
     the prefill step's last logits with the flash kernel (wgmma) against
     the same model with the kernel call swapped for its plain version,
     prefill against train, and decode against teacher forcing (a prefill
     of 4032 tokens copied into 4096 slots, 64 decode steps) in bf16, all
     within 2^-5 max|logits| with greedy picks differing only at near-ties;
     a planted GQA head-mapping fault must exceed that bound; decode
     against teacher forcing in f32 (the fma route) within 5e-3, the
     reference's own bound;
 20. `main_lm_prefill`: llama3-8b at its published width and depth
     (7.50 B parameters, 15.0 GB bf16, drawn on the card), 6 requests of
     32,768 tokens as one batch through `make_prefill_step` (prefill_32k
     cut from batch 32 to 6 by memory): exactly 32 flash launches, all
     wgmma, the kernel's output at layers 0, 16 and 31 held against the
     plain version on the model's own q/k/v (every element within one
     bf16 rounding), warm `prefill_s`, tokens/s, peak memory, the flash
     kernel's ms inside the model (CUDA events around each call) and the
     bound from the port's `model_flops` at 989 TFLOP/s;
 21. `main_lm_decode`: 128 requests of 3,072 tokens prefilled 4 at a time
     (1024 flash launches; one chunk's layers 0, 16, 31 held against the
     plain version as above) into one cache of 3,072 + 64 slots (decode_32k
     cut in context by memory), 64 greedy steps (`greedy_next`, no kernel
     launch), per-step ms (median, max) and tokens/s beside the per-step
     bound from `hbm_bytes_floor`;
 22. `lm_train_vs_plain`: llama3-8b at full width, 2 layers, 2 sequences
     of 4096 as 2 microbatches, remat on: one `make_train_step` through
     the flash kernel against the same step with the kernel call swapped
     for its plain version (autograd through it), in bf16 (wgmma) and f32
     (fma): loss, grad norm, each leaf's m and parameter move within
     `TOL_TRAIN`; a planted fault (the kernel's output cut off from
     autograd) must fail them;
 23. `main_lm_train`: train_4k at llama3-8b's published width, cut to
     LM_TRAIN_LAYERS layers and 16 sequences of 4096 as 8 microbatches
     (AdamW's 16 bytes a parameter), remat on: the warm step launches
     flash exactly twice per layer per microbatch (forward and
     recompute, all wgmma), every sampled leaf moves, and the flash
     Function's dq, dk, dv at layers 0 and last are held against autograd
     through the plain version on the model's own q/k/v (a planted fault
     must fail); then `train_step_s` (median, max of LM_TRAIN_STEPS),
     tokens/s, the bound from `model_flops` at 989 TFLOP/s, peak memory,
     flash's and the plain backward's ms inside the step (CUDA events),
     and a traced step; `main_lm_train_cli`: `launch.train.main` at
     `--smoke` on the card, 4 steps straight and 4 killed after the
     checkpoint of step 2 and resumed (final loss within 1e-4);
 24. `lm_moe_vs_plain`: olmoe-1b-7b and deepseek-v2-lite-16b at full
     width, 2 layers (deepseek's dense first layer and one MLA + MoE
     layer): olmoe's bf16 train-mode logits over S = 4096 with the flash
     kernel against the plain attention, within 2^-5 max|logits| over the
     tokens whose routing (expert set or kept mask at any layer) is the
     same on both sides, at most FLIP_SHARE_MAX of them flipping, the
     kernel held per element at both layers; both models in f32 at 1024
     tokens (dropless): prefill against train and decode against teacher
     forcing within 5e-3; planted faults (expert e's down projection
     read from expert e + 1, at every MoE layer and at the last only,
     which reroutes no token) must fail each bound, the last-layer one
     through the logit bound itself;
 25. `main_lm_moe`: olmoe-1b-7b at its published width and depth (6.82 B
     parameters), prefill_32k at LM_MOE_PREFILL_B requests (16 wgmma
     flash launches, layers 0, 8, 15 held against the plain version, the
     traced run bit for bit the timed one) and decode_32k (128 requests
     of 3,072 + 64 greedy steps), with the fields of phases 20 and 21;
 26. `main_lm_mla`: deepseek-v2-lite-16b at its published width and depth
     (15.50 B parameters): one request of 32,768 tokens, then 128 of
     LM_MLA_DECODE_PROMPT + 64 greedy steps (by time); MLA is torch ops,
     so no kernel launches;
 27. `lm_ssm_vs_plain`: rwkv6-3b (2 layers) and jamba-v0.1-52b (5
     layers: four Mamba, two of them MoE, the attention layer at index
     4) at full width: jamba's bf16 train-mode logits over S = 4096 with
     the flash kernel against the plain attention, within 2^-5
     max|logits| over the tokens whose routing did not flip, the kernel
     held per element, a planted GQA head-mapping fault outside; both in
     f32 at 1024 tokens (dropless): prefill against train and decode
     against teacher forcing within 5e-3, rwkv chunk 32 against 64 and
     mamba chunk 128 against 256 within 2e-3; planted faults, decode with
     RWKV6's token shift (`xp_tm`) or Mamba's conv window (`conv`) zeroed
     before every step (and at the last Mamba layer only, which must fail
     the logit bound itself), outside the decode bound;
 28. `main_lm_rwkv`: rwkv6-3b at its published width and depth (2.93 B
     parameters): prefill_32k at LM_RWKV_PREFILL_B requests (by time) and
     decode_32k (128 requests of LM_RWKV_DECODE_PROMPT + 64 greedy steps,
     by time: the step's state does not grow with context), the fields of
     phases 20 and 21 plus `state_bytes` (the f32 WKV states and token
     shifts the batch carries), no kernel launch;
 29. `main_lm_jamba`: jamba-v0.1-52b at its published width cut to
     LM_JAMBA_LAYERS = 16 layers (25.79 B parameters): prefill_32k at
     LM_JAMBA_PREFILL_B requests (by memory; 2 wgmma flash launches, both
     held against the plain version, the logits finite before the timed
     run) and decode_32k at 128 requests of LM_JAMBA_DECODE_PROMPT + 64
     slots (by time; 64 flash launches on the prompts), the same fields;
 30. `lm_encdec_vs_plain`: whisper-large-v3 (2 encoder and 2 decoder
     layers, with frames) and qwen2-vl-2b (2 layers, over (3, B, S)
     M-RoPE positions) at full width: bf16 train-mode logits at 4096
     tokens with the flash kernel against the plain attention within
     2^-5 max|logits|, every flash call held per element (whisper's
     encoder calls bidirectional over 1500 frames), qwen2-vl's GQA fault
     outside; f32 prefill against train and decode against teacher
     forcing at 1024 tokens within 5e-3; planted faults that must fail
     that bound: whisper decoding with its last layer's cross K/V zeroed,
     qwen2-vl with its M-RoPE sections permuted;
 31. `main_lm_whisper`: whisper-large-v3 at its published width and
     depth (1.58 B parameters): prefill_32k at LM_WHISPER_PREFILL_B
     requests with their frames (64 wgmma flash launches a call: the
     encoder's 32 bidirectional, then the decoder's 32 causal; three held
     against the plain version) and decode at 128 requests of
     LM_WHISPER_PROMPT + 64 slots (by memory), the encoder's passes
     inside the prompt chunks timed apart (`encode_s`, 128 requests'
     frames in all); both bounds from `encdec_model_flops` and
     `encdec_hbm_bytes_floor` (each term at the length it runs over);
 32. `main_lm_qwen2vl`: qwen2-vl-2b at its published width and depth
     (1.54 B parameters) over video-like (3, B, S) positions: prefill_32k
     at LM_QWEN_VL_PREFILL_B requests (28 wgmma flash launches) and
     decode_32k, the fields of phases 20 and 21;
 25b. `main_lm_mesh` (inside phase 25, on its model): olmoe-1b-7b's
     weights through a one-rank NCCL group and `compat_mesh((1, 1),
     ("data", "model"))`, distributed by `param_shardings`, under the
     LM_MESH_LAYOUTS tp and ep: a prefill of LM_MESH_B x 32,768 through
     `make_prefill_step(cfg, ctx)` and LM_MESH_DECODE greedy steps
     through `make_decode_step(cfg, ctx)`, last-position logits and
     tokens bit for bit the ctx=None path's on the same weights, 16
     wgmma flash launches a prefill on the rank's heads; `prefill_s`,
     `step_ms` with and without the ctx, CommDebugMode's counts;
 28b, 29b, 31b. `main_lm_sp` (inside phases 28, 29 and 31, on their
     models): Megatron-SP (`layout="sp"`) through a one-rank NCCL group
     and `compat_mesh((1, 1))`: one request of LM_SP_S tokens (whisper's
     with its frames) through `make_prefill_step(cfg, ctx)` against the
     ctx=None prefill on the same weights, the last-position logits, the
     greedy token and every cache leaf bit for bit, LM_SP_FLASH flash
     launches (0 rwkv6-3b, 2 jamba, 64 whisper), `prefill_s` of both;
 29c. `main_lm_long` (inside phase 29, after its `main_lm_sp`):
     jamba-v0.1-52b's long_500k decode (batch 1, 524,288 slots) at 16
     layers under the SP decode flip's rule table (`batch` None,
     `kv_seq` "data"; set by the phase: one rank cannot reach the flip by
     the rule) against ctx=None, each over its own cache TILED from
     `main_lm_sp`'s ctx=None prefill (16 x 32,768 K/V; not a
     524,288-token prefill), LM_LONG_STEPS greedy steps, logits within
     2^-5 max|logits| (the flip fed ctx=None's picks), the merge at both
     attention layers every step, `step_ms` of both beside the bound from
     `hbm_bytes_floor`, peak memory, no kernel launch;
 32b. `dryrun_host` (after phase 32's training ones): `python -m
     repro_torch.launch.dryrun` for DRYRUN_HOST_CELLS (llama3-8b's
     prefill_32k and decode_32k, jamba-v0.1-52b's long_500k under the
     flip) on the single-pod mesh in a subprocess on the CPU (a fake
     256-rank group): each record's memory, collectives, roofline terms
     and seconds;
 33. `{"phase": "wall"}`: the script's wall seconds so far; then
     `{"kernels": [...]}`: each ported kernel with its launches on every
     path (0 on phases 9-15 but the z-normalized streaming query, which
     plans the NATSA kernel as `ab_join` does, 1 per monitor `motif`, 1
     per k = 1 serve pair, 1 per non-empty anytime chunk at k = 1, in one
     process or through the group; 72 for the serve example; 1 per paper
     workload; 5 for the other twins; flash 960 for the training twin;
     flash
     one per GQA layer per LM prefill batch (32 for llama3-8b, 16 for
     olmoe-1b-7b, through the mesh too, 2 for jamba at 16 layers, 28 for
     qwen2-vl-2b, 64 for whisper-large-v3 with its encoder, the same under
     `sp`, 0 for MLA and RWKV6 and for every decode step), 2 per layer per
     microbatch of a train step), its error
     against the plain version and its times beside its bound.
Every kernel launch counter is set to 0 just before each path and read just
after it. The last line is `{"ok": true, "device": {...}}`. Any failed check
raises and the script exits non-zero without it. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
sys.path.insert(0, os.path.join(ROOT, "src"))

# the H100 SXM's rates, one definition: FP32 outside the tensor cores,
# dense bf16 on them, HBM3 bytes/s
from repro_torch.launch.roofline import (  # noqa: E402
    FP32_PEAK, HBM_BW as HBM_RATE, PEAK_FLOPS as BF16_PEAK,
)
# the paper's workloads, by name (src/repro_torch/configs/natsa.py)
from repro_torch.configs.natsa import (  # noqa: E402
    BENCH_WORKLOADS, PAPER_WORKLOADS,
)

WORKLOADS = {w.name: w for w in PAPER_WORKLOADS + BENCH_WORKLOADS}
ECG = WORKLOADS["ecg-256k"]
EPILEPSY = WORKLOADS["epilepsy-128k"]
SEISMOLOGY = WORKLOADS["seismology-64k"]
BENCH_16K = WORKLOADS["bench-16k"]

SEED = 20240611
TOL_KERNEL = 1e-4     # kernel vs plain version, correlation (the reference's own kernel standard)
TOL_ORACLE = 1e-3     # full size vs f64 oracle: un-reseeded f32 drift measured ~1.6e-4 at n=262144
SELF_N, SELF_M = ECG.n, ECG.window
# epilepsy-128k against B of 32768 samples: its series cut to a quarter
AB_NA, AB_M = EPILEPSY.n, EPILEPSY.window
AB_NB = 32768
SAMPLED_ROWS = 64
DEVICE = "cuda"

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/natsa_mp.cu"
KERNEL_REPLACES = "src/repro/kernels/natsa_mp.py:113"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attn.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attn.py:27"
SOURCES = {"natsa_mp": KERNEL_SOURCE, "flash_attn": FLASH_SOURCE}

# llama3-8b (src/repro/configs/llama3_8b.py: 32 heads, 8 KV heads, head_dim
# 128) at the prefill_32k shape (configs/base.py:162) with one sequence
FLASH_B, FLASH_H, FLASH_KV_H, FLASH_S, FLASH_D = 1, 32, 8, 32768, 128
TOL_FLASH_F32 = 2e-4  # the reference's own (tests/test_flash_and_streaming.py)
TOL_FLASH_BF16 = 3e-2
TOL_FLASH_BLOCKS = 1e-5
# full size, per element: within one bf16 rounding of the plain version,
# |o - plain| <= 2^-7 |plain| + 1e-5 (flash_attn.element_ratio <= 1)
TOL_FLASH_FULL = 1e-2  # x max|plain|, over the whole output
FAULT_ROW0 = 4096      # the planted fault's first row
FAULT_LATE_ROW0 = 16384  # its late rows, read on their own
# the band engine against the kernel: ecg-256k's window over its series
# cut to a quarter; epilepsy-128k's window, A cut to a quarter (main_ab's
# B) and B to a sixteenth
ENGINE_SELF_N, ENGINE_SELF_M = 65536, ECG.window
ENGINE_AB_NA, ENGINE_AB_NB, ENGINE_AB_M = AB_NB, 8192, EPILEPSY.window
TOPK_K = 4
TOPK_N, TOPK_M = ECG.n, ECG.window
# 4096 query subsequences (the reference's rowstream ceiling, cut from
# epilepsy-128k's 130945) against epilepsy-128k's series
ROWSTREAM_LQ = 4096
ROWSTREAM_NB, ROWSTREAM_M = EPILEPSY.n, EPILEPSY.window
BATCH_SELF_B = 4
BATCH_SELF_N, BATCH_M = BENCH_16K.n, BENCH_16K.window
# 8 queries of ROWSTREAM_LQ subsequences against 8 series of AB_NB
# samples (main_ab's B), at bench-16k's window
BATCH_AB_B, BATCH_AB_LQ, BATCH_AB_NB = 8, ROWSTREAM_LQ, AB_NB
NONNORM_N, NONNORM_M = SEISMOLOGY.n, SEISMOLOGY.window
# raw distances: |d - d64| <= 2e-3 + 2e-3 d64, the reference's own
# nonnorm-vs-brute-force tolerance (tests/test_ab_join.py:148,
# tests/test_fused_twoside.py:144); indices may differ where the picked
# pair's exact distance is within it of the oracle's
NONNORM_ATOL = NONNORM_RTOL = 2e-3
TILE_N, TILE_M = ECG.n, ECG.window
STREAM_N, STREAM_M, STREAM_BLOCK = BENCH_16K.n, BENCH_16K.window, 256
STREAM_QUERY_N, STREAM_REAPPEND = 4096, 64
# snapshot vs the batch profile: the reference's own streaming tolerance
# (tests/test_flash_and_streaming.py:85); vs the f64 oracle: both f64
STREAM_TOL, STREAM_ORACLE_TOL = 3e-3, 1e-6
# fleet-10k: the reference's fleet size (benchmarks/run.py:501), the
# telemetry monitor's window (core/monitor.py:39) and exclusion m // 4;
# capacity 1024 where the monitor keeps 8192 samples (:41), cut 8x so the
# prefill fits the script's time
FLEET_N, FLEET_M, FLEET_EXCL, FLEET_CAP = 10000, 32, 8, 1024
FLEET_PREFILL, FLEET_TIMED, FLEET_REPLAYS = 512, 16, 8
FLEET_SMALL_N, FLEET_SMALL_CAP, FLEET_SMALL_ARRIVALS = 8, 96, 400
FLEET_CKPT_N, FLEET_BF16_N = 256, 1024
# tenant -> first sample of its planted ramp (0 -> 6 over 32 samples)
FLEET_PLANTED = {17: 300, 60: 350, 133: 400, 250: 450}
FLEET_SCAN = 256                        # tenants 0..255, the planted among them
# the fleet monitor's z-score gate: a 32-sample ramp reads z 6.09-6.39
# among the 993 windows of a full tenant, the clean tenants' top discords
# at most 4.35 over tenants 0..255 and 5.149 over all 10,000 (this data,
# f64 and deterministic; an NVIDIA H100 80GB HBM3 reads what the CPU
# reads); main_monitor prints both extremes as `gate_margin`
FLEET_ALARM = 5.3
MONITOR_HISTORY, MONITOR_M = 8192, 32   # TelemetryMonitor's defaults
# the profile service (src/repro/serve): 64 resident series and 16
# concurrent queries are the reference's serve benchmark
# (benchmarks/run.py:724-740, bench_serve), 2 logical shards; m is
# epilepsy-128k's. The series length (65536, epilepsy-128k's series cut to
# half) and the query length (4096 samples, 3969 subsequences) have no
# source in the repo: bench_serve's 384 and 192 at m = 64 are sized for a
# CPU run, and these are chosen so the card sweeps a corpus of real size
# (4.3 GB of resident f64 windows), with queries as long as the AB
# rowstream's row ceiling (ROWSTREAM_LQ), which a k > 1 query of this
# length would run on
SERVE_SERIES, SERVE_N, SERVE_M, SERVE_SHARDS = 64, 65536, EPILEPSY.window, 2
SERVE_QUERIES, SERVE_QUERY_N = 16, 4096
SERVE_BITWISE, SERVE_ORACLE = 4, 2      # answers held to the loop / oracle
# query 0's window SERVE_PLANT[2] copies series SERVE_PLANT[0]'s window at
# SERVE_PLANT[1]
SERVE_PLANT = (37, 40000, 1000)
# k = 4 on the per-pair rowstream plan: 4 series of bench-16k's 16384,
# 2 queries of 512
SERVE_K, SERVE_K_SERIES, SERVE_K_N, SERVE_K_QUERIES, SERVE_K_QUERY_N = (
    4, 4, BENCH_16K.n, 2, 512)
# FaultInjector.seeded(36, n_rounds=4, n_workers=2, p_worker_crash=0.3,
# p_round_failure=0.3, max_round_failures=2): shard 0 crashes at tick 0,
# tick 2 (shard 0 again) fails once and retries
SERVE_FAULT_SEED = 36
# the anytime scheduler (core/scheduler.py) on the one card: 8 workers x 8
# equal-work chunks, so 64 NATSA launches at k = 1 over 8 rounds, on the
# ecg-256k self-join (exclusion 128 = default_exclusion(512)) and on
# epilepsy-128k against 32768 (AB, unswapped, exclusion 0); a checkpoint
# after round 4 resumed on 4 workers; k = 4 at bench-16k on the band
# engine's top-k chunks
ANYTIME_WORKERS, ANYTIME_CPW, ANYTIME_EXCL = 8, 8, 128
ANYTIME_CKPT_ROUND, ANYTIME_RESUME_WORKERS = 4, 4
ANYTIME_K, ANYTIME_K_N, ANYTIME_K_M = 4, BENCH_16K.n, BENCH_16K.window
# FaultInjector.seeded(2, **ANYTIME_FAULTS) over a 64-chunk, 8-worker plan:
# 10 rounds, 4 retries, worker 3 excluded after 3 crashes, 3 replans, 1
# killed and 3 flipped checkpoints of 10 (the same schedule on both cells)
# the same cells through a one-rank NCCL group (launch.mesh.make_worker_mesh,
# one worker x 64 chunks: interleaved_chunks cuts by the total count, so the
# 64 chunks of the 8 x 8 plan), against the one-process scheduler at that plan
ANYTIME_GROUP_CPW = ANYTIME_WORKERS * ANYTIME_CPW
ANYTIME_FAULT_SEED = 2
ANYTIME_FAULTS = dict(n_rounds=64, n_workers=8, p_worker_crash=0.15,
                      p_round_failure=0.3, max_round_failures=2,
                      p_checkpoint_kill=0.2, p_checkpoint_flip=0.2)
# the LM substrate's serving path: llama3-8b (src/repro_torch/configs/
# llama3_8b.py) at its published width and depth, bf16, weights drawn on
# the card from a seed (15.0 GB). Each cut below is one of memory on an
# 80 GB card:
# - prefill_32k (configs/base.py:162) cut from batch 32 to 6. A 32,768-
#   token request holds 4.3 GB of KV cache and ~5.1 GB of per-layer
#   activations (9.43 GB above the weights at batch 1 on an H100 80GB,
#   mostly the SwiGLU's (S, 2, 14336) product): batch 6 peaks near 72 GB,
#   7 would need ~81 GB, 32 needs 137 GB of KV cache alone.
# - decode_32k (configs/base.py:163) keeps its batch of 128 and cuts the
#   context from 32,768 to 3,072 prompt tokens + 64 greedy steps: its KV
#   cache at 32,768 is 550 GB; at 3,136 slots it is 52.6 GB, with the
#   weights ~68 GB. The prompts are prefilled 4 requests at a time into
#   the decode cache (the prefill cache has exactly S slots).
# - lm_vs_plain: full width, 2 layers, S = 4096, the last 64 positions
#   decoded teacher-forced after a prefill of the rest.
LM_ARCH, LM_PREFILL_B, LM_PREFILL_S = "llama3-8b", 6, 32768
LM_DECODE_B, LM_DECODE_PROMPT, LM_DECODE_STEPS = 128, 3072, 64
LM_DECODE_CHUNK = 4
LM_PLAIN_LAYERS, LM_PLAIN_S, LM_PLAIN_DECODE = 2, 4096, 64
# decode vs teacher forcing in f32: max|d| <= 5e-3 max|logits|, the
# reference's own bound (tests/test_consistency.py:48)
TOL_LM_DECODE = 5e-3
# bf16 logits, kernel vs plain, prefill vs train, decode vs teacher forcing:
# max|d| <= 2^-5 max|logits|, four bf16 rounding steps of the largest
# logit. The two sides differ in attention outputs by about one bf16
# rounding (flash's element check); that reaches the logits through ~10
# further bf16 roundings (each rounding's error ~2^-9 of its value, summed
# over d_model into a logit: ~2^-9 sqrt(10) of the logits' spread, ~6
# spreads at the max over 5e8 logits) plus the logits' own rounding, up to
# 2^-7 of the largest (5e-3 lies below one step for maxima low in their
# binade). A CPU reading at full width, 2 layers, S = 256 put the same
# computation run twice 1.07e-2 apart. A wrong GQA head mapping must read
# above the bound (`planted_fault`). Greedy picks may differ only where
# the reference side's top two logits lie within the bound.
TOL_LM_BF16 = 2.0 ** -5

# The MoE and MLA families (ROADMAP.md §A9 (iii)) at their published
# widths (src/repro_torch/configs/olmoe_1b_7b.py, deepseek_v2_lite.py),
# bf16, weights drawn on the card from a seed; the cuts, of memory or time:
# - olmoe-1b-7b (16 layers, d 2048, 16 heads of 128, 64 experts top-8 of
#   d_ff 1024; 6.82 B parameters, 13.6 GB) prefill_32k cut from batch 32
#   to LM_MOE_PREFILL_B by memory. A request of 32,768 tokens holds 4.29 GB
#   of KV cache and, inside each MoE layer (all B·S tokens dispatched at
#   once, capacity 1.25·n·8/64 + 1), the (64, capacity, 2048) bf16
#   buckets, their (·, 2, 1024) products and the (8n, 2048) combine. On
#   an H100 80GB HBM3 batch 8 peaked at 73.94 GB: 7.54 GB a request above
#   13.64 GB of weights, so 9 would peak near 81.5 GB of the card's 85.0
#   (within 4 GB of it, which llama3-8b's cut declines too);
# - deepseek-v2-lite-16b (27 layers, MLA r = 512, dr = 64, dn = dv = 128,
#   64 experts top-6 + 2 shared of d_ff 1408, layer 0 dense of d_ff
#   10,944; 15.50 B parameters, 31.0 GB) prefill_32k cut to batch
#   LM_MLA_PREFILL_B by time: MLA's f32 logits are ~1e13 FLOP a layer per
#   request with the masked key blocks skipped; one request took 11.4 s
#   (peak 35.4 GB), and the phase runs it twice;
# - decode_32k: olmoe as llama3-8b's, 128 requests of 3,072 + 64 slots
#   (its KV cache 52.6 GB); deepseek 128 requests of LM_MLA_DECODE_PROMPT
#   + 64, by time: its 3,072-token prompts took 22.0 s of the script on an
#   H100 80GB HBM3 host at 700 W (a 12.5 GB latent cache), which the
#   paper's workloads needed;
# - lm_moe_vs_plain: full width, 2 layers (deepseek's dense first layer and
#   one MLA + MoE layer); olmoe in bf16 at S = 4096 (the capacity regime),
#   both in f32 at B·S = 1024 so that every dispatch is dropless (beyond
#   1024 tokens the teacher-forced pass drops entries past capacity and
#   decode never does: the two differ by design).
LM_MOE_ARCH, LM_MLA_ARCH = "olmoe-1b-7b", "deepseek-v2-lite-16b"
LM_MOE_PREFILL_B, LM_MLA_PREFILL_B = 8, 1
LM_MLA_DECODE_PROMPT = 1024
LM_MOE_LAYERS, LM_MOE_PLAIN_S, LM_MOE_F32_S, LM_MOE_DECODE = 2, 4096, 1024, 64
# Routing flips: a router logit that moves by one bf16 rounding (kernel
# vs plain attention) can change a token's top-8 or, through the slots, a
# later token's kept mask. Such tokens are counted and left out of the
# logit bound; at most this share of them may flip. By the code ~1-2% a
# layer: the 8th and 9th of 64 router logits (std ~1) lie ~0.08 apart,
# bf16 noise moves them ~1e-3, plus one kept mask at capacity per flip. A
# planted fault flips most tokens of the layer after it.
FLIP_SHARE_MAX = 0.1

# The RWKV6 and Mamba families (ROADMAP.md §A9 (iii) items 1-2) at their
# published widths (src/repro_torch/configs/rwkv6_3b.py, jamba_v01_52b.py),
# bf16, weights drawn on the card from a seed; the cuts, of memory or time:
# - rwkv6-3b (32 layers, d 2560, 40 heads of 64, d_ff 8960, vocab 65,536;
#   2.93 B parameters, 5.86 GB) at full depth; prefill_32k cut from batch
#   32 to LM_RWKV_PREFILL_B by time. A request of 32,768 tokens runs 512
#   chunks of 64 through each of 32 layers, a Python loop of 16,384 chunk
#   steps (ROADMAP.md §C (22)), each forming the masked (40, 64, 64, 64)
#   f32 exponent tensor and its products (~10 passes of 42 MB), ~2 s of
#   device time a request by its bytes; the phase runs the whole batch
#   twice (~5 s a request on an H100 80GB HBM3 host at 700 W, 20.7 s at
#   batch 4), which the paper's workloads needed. Memory would allow ~24 requests (~3 GB a request above the
#   weights: the f32 r/k/v/decay and WKV output, the five bf16 mixes and
#   the channel mix's (S, 8960)).
# - jamba-v0.1-52b (d 4096, 32 heads / 8 KV heads of 128 without RoPE,
#   d_ff 14336, 16 experts top-2 on odd layers, Mamba d_state 16, conv 4,
#   expand 2, vocab 65,536) cut in depth from 32 to LM_JAMBA_LAYERS by
#   memory: two whole periods of 8 (2 attention, 14 Mamba and 8 MoE
#   layers), 25.79 B parameters, 51.6 GB; the whole model (51.30 B, 102.6
#   GB) exceeds the card. prefill_32k cut to LM_JAMBA_PREFILL_B by memory:
#   a request's MoE layer (65,536 entries, capacity 1.25 · 2/16 of the
#   tokens per expert) holds the experts' (16, 5121 b, 2, 14336) bf16 gate
#   and up products (4.7 GB a request), the SiLU's temporary and their
#   product (2.35 GB each), ~9.4 GB a request above the weights, beside
#   ~5 GB of a Mamba layer's (S, 8192) activations: 2 requests peak near
#   73 GB of the card's 85.0, 3 near 83 GB.
# - decode_32k: jamba 128 requests of LM_JAMBA_DECODE_PROMPT + 64 slots,
#   by time (its 3,072-token prompts took ~51 s of the script, which
#   main_lm_mesh and dryrun_host needed, and its 1,024-token ones 17.1 s,
#   which the paper's workloads needed; its Mamba layers' 1.03 GB of
#   state are the same at any context); rwkv6-3b 128 requests of
#   LM_RWKV_DECODE_PROMPT + 64 tokens, by time: its step reads and writes
#   the same 2.73 GB of state at any context, and its 3,072-token prompts
#   took 63.7 s of the script (a Python loop of 48 chunk steps a layer a
#   prompt chunk), its 1,024-token ones 23.8 s.
# - lm_ssm_vs_plain: full width; rwkv6-3b 2 layers, jamba 5 layers (four
#   Mamba layers, two of them MoE, and the first attention layer at index
#   4); f32 at one request of 1024 tokens (dropless, as lm_moe_vs_plain),
#   jamba also in bf16 at 4096 (the capacity regime).
LM_RWKV_ARCH, LM_JAMBA_ARCH = "rwkv6-3b", "jamba-v0.1-52b"
LM_RWKV_PREFILL_B, LM_JAMBA_PREFILL_B, LM_JAMBA_LAYERS = 2, 2, 16
LM_RWKV_DECODE_PROMPT = LM_JAMBA_DECODE_PROMPT = 512
LM_SSM_LAYERS = {LM_RWKV_ARCH: 2, LM_JAMBA_ARCH: 5}
LM_SSM_F32_S, LM_SSM_DECODE, LM_SSM_PLAIN_S = 1024, 64, 4096
# chunk-size invariance, f32: max|d| <= 2e-3 max|logits|, the reference's
# own bound (tests/test_consistency.py:82-83), at rwkv chunk 64 vs 32 and
# mamba chunk 256 vs 128
TOL_LM_CHUNK = 2e-3
LM_SSM_CHUNKS = {"rwkv_chunk": 32, "mamba_chunk": 128}
# a recurrent model's traced prefill: the first 2048 tokens of each
# request (32 rwkv chunks, 8 mamba chunks a layer). The full 32,768 took
# the profiler ~410 s (rwkv6-3b, ~1.5e6 events) and ~100 s (jamba) to
# parse on an H100 80GB HBM3 host at 700 W; the chunk steps, the
# GEMMs and the elementwise passes all scale with S alike
LM_TRACE_PREFIX = 2048

# The encoder-decoder and M-RoPE families (ROADMAP.md §A9 (iii) items 3-4)
# at their published widths and depths (src/repro_torch/configs/
# whisper_large_v3.py, qwen2_vl_2b.py), bf16, weights drawn on the card
# from a seed; the cuts, of memory or time, reckoned before the first
# call (PERF.md):
# - whisper-large-v3 (32 encoder + 32 decoder layers, d 1280, 20 heads of
#   64 without GQA, d_ff 5120, vocab 51,866; 1.58 B parameters, 3.16 GB):
#   its K/V take 163,840 bytes a token over the 32 layers, and each
#   request's cross K/V 0.25 GB. prefill_32k cut from batch 32 to
#   LM_WHISPER_PREFILL_B by time: a request of 32,768 tokens holds 5.37 GB
#   of K/V (memory would allow ~12), and its cross attention runs in 64
#   query chunks a layer in torch ops (f32 logits of (20, 512, 1500) a
#   chunk, 3.93 GB a layer in all; ROADMAP.md §C (24)), ~1 s a request by
#   its passes. decode_32k keeps its batch of 128 and cuts the context
#   further than llama3-8b's, to LM_WHISPER_PROMPT + 64 slots, by memory:
#   the cross K/V of 128 requests are 31.5 GB, the self K/V 33.6 GB at
#   1,600 slots (65.8 GB at 3,136, 97 GB with the cross K/V, beyond the
#   card); 68 GB with the weights.
# - qwen2-vl-2b (28 layers, d 1536, 12 heads over 2 KV heads of 128,
#   d_ff 8960, vocab 151,936, M-RoPE sections (16, 24, 24); 1.54 B
#   parameters, 3.09 GB): prefill_32k cut to LM_QWEN_VL_PREFILL_B by
#   time (0.94 GB of K/V a request, ~2 GB of SwiGLU and M-RoPE
#   temporaries inside a layer: memory would allow ~20), ~0.6 s a request
#   by llama3-8b's rates; decode_32k as llama3-8b's (11.5 GB of K/V).
# - lm_encdec_vs_plain: full width, 2 layers (whisper's encoder 2 too);
#   bf16 at 4096 tokens, f32 at 1024 with 64 decoded.
LM_WHISPER_ARCH, LM_QWEN_VL_ARCH = "whisper-large-v3", "qwen2-vl-2b"
LM_WHISPER_PREFILL_B, LM_QWEN_VL_PREFILL_B = 4, 8
LM_WHISPER_PROMPT = 1536
LM_ENCDEC_LAYERS, LM_ENCDEC_F32_S, LM_ENCDEC_DECODE = 2, 1024, 64
LM_ENCDEC_PLAIN_S = 4096

# main_lm_mesh (ROADMAP.md §A9 (iv)): olmoe-1b-7b's full-width weights of
# main_lm_moe (16 layers) through a one-rank NCCL group and a (1, 1)
# ("data", "model") mesh, under the tp and ep layouts: a prefill of
# LM_MESH_B x 32,768 tokens, then LM_MESH_DECODE greedy steps from its
# cache, each bit for bit the ctx=None path on the same weights (on one
# rank every collective is an identity). dryrun_host traces llama3-8b's
# prefill_32k and decode_32k on the fake 256-rank single-pod mesh.
LM_MESH_B, LM_MESH_DECODE = 2, 16
LM_MESH_LAYOUTS = ("tp", "ep")
DRYRUN_HOST_CELLS = (("llama3-8b", "prefill_32k"), ("llama3-8b", "decode_32k"),
                     ("jamba-v0.1-52b", "long_500k"))

# main_lm_sp (ROADMAP.md §A9 (iv)): Megatron-SP (`layout="sp"`: the
# residual split on the sequence over the model axis) through a one-rank
# NCCL mesh against ctx=None on the same weights, one request of LM_SP_S
# tokens: jamba-v0.1-52b (main_lm_jamba's 16 layers: Mamba, attention and
# MoE), rwkv6-3b (main_lm_rwkv's: time and channel mixing) and
# whisper-large-v3 (main_lm_whisper's, with 1,500 frames: its encoder's
# frames split too, and cross attention), each prefill_32k cut from batch
# 32 to 1 by time (rwkv6-3b's chunk loop is host bound, ~12 s a run by
# its 16,384 chunk steps). On one rank every collective is an identity,
# so the logits, the greedy token and the cache must equal ctx=None's bit
# for bit; each prefill launches LM_SP_FLASH[arch] flash kernels.
# main_lm_long: jamba-v0.1-52b's long_500k cell (configs/base.py:166:
# batch 1, 524,288 slots; configs/jamba_v01_52b.py keeps it, "seq-sharded
# KV, O(1) SSM") at 16 layers, LM_LONG_STEPS greedy steps under the SP
# decode flip's rule table (batch replicated, `kv_seq` over "data"). One
# rank cannot reach the flip by `make_rules` (batch 1 is not below 1 data
# rank), so the phase sets the flip table's two entries itself. The cache
# is TILED, not prefilled: the K/V of main_lm_sp's 32,768-token ctx=None
# prefill repeated 16 times along the sequence (jamba has no RoPE, so a
# tile carries no position), its Mamba states as they are, and
# `cache_len` set so that the steps write the last LM_LONG_STEPS slots. A
# prefill of 524,288 tokens would need a sequence-chunked prefill the port
# lacks (its MoE buckets alone ~30 GB). The flip path and the ctx=None
# path each get their own cache (decode writes it in place), one after
# the other; their logits within TOL_LM_BF16 of max|logits|.
LM_SP_S, LM_SP_WARM = 32768, 2048
LM_SP_FLASH = {LM_JAMBA_ARCH: 2, LM_RWKV_ARCH: 0, LM_WHISPER_ARCH: 64}
LM_LONG_STEPS = 16
FRAMES_SCALE = 0.02       # the reference trainer's frames (launch/train.py:78)

# The training path (ROADMAP.md §A9 (ii)): train_4k (configs/base.py:166)
# at llama3-8b's published width, remat on, one AdamW step per call of
# `make_train_step`. Each cut is one of memory or time on an 80 GB card:
# - depth: AdamW keeps bf16 params and grads, f32 m and v and an f32
#   gradient accumulator (microbatches > 1), 16 bytes a parameter: 120 GB
#   at 32 layers (7.50 B). A layer holds 218.1 M parameters (3.49 GB of
#   state), the tied embedding 525.3 M (8.41 GB). At 12 layers the step
#   peaked at 66.74 GB on an H100 80GB HBM3 (state 50.3 GB, the rest one
#   microbatch's f32 logits and their gradient, one layer's recompute);
#   15 layers (3.58 B parameters) peaked at 76.1 GB, 16 would leave ~4 GB
#   of the card's 85.0 free. Cut to 12 by time: a step takes ~0.77 s a
#   layer (11.5 s at 15), the phase runs six, and the paper's workloads
#   needed the time;
# - batch: global batch 256 cut to 16, as 8 microbatches of 2 sequences of
#   4096 (the sequence stays), so that a step stays in seconds;
# - steps: one warm step (with the in-model gradient checks), then
#   LM_TRAIN_STEPS timed.
LM_TRAIN_LAYERS, LM_TRAIN_S, LM_TRAIN_B, LM_TRAIN_MB = 12, 4096, 16, 8
LM_TRAIN_STEPS = 4
LM_TRAIN_LR = 3e-4          # AdamWConfig's default, warmup of one step
# lm_train_vs_plain: 2 layers, 2 sequences of 4096 as 2 microbatches.
LM_TRAIN_PLAIN_B, LM_TRAIN_PLAIN_MB = 2, 2
# the kernel's train step against the same step with the kernel call
# swapped for the plain version. The first bounds were fixed before any
# run by reasoning (bf16: loss 2^-7, grad norm 2^-6, m 2^-4, move 0.5; f32:
# 1e-4, 1e-3, 2^-7, 0.1); the sound runs then read, the same in each run
# on an H100 80GB HBM3 at 700 W, bf16: loss 6.9e-6, grad norm 4.4e-5, m
# 1.17e-2, move 0.112; f32: 0, 7.1e-8, 2.6e-4, 3.1e-3. The bounds are now
# a few times those (about 2-25x), so that a backward wrong in magnitude
# but right in sign fails grad norm and moves too, not only m. bf16: the
# two forwards differ by one bf16 rounding of the attention output; AdamW's
# first step moves each parameter by ~lr * sign(g), so where the two
# gradients differ in sign (a share f of a leaf) the moves differ by 2 lr,
# a relative L2 of ~2 sqrt(f): 0.112 is f ~ 0.3%, 0.25 holds to f ~ 1.6%.
# f32 (the fma route, f32 compute over bf16 weights): the gradients round
# to bf16 leaf by leaf. The planted fault, the kernel's output cut off
# from autograd (the state before the flash Function: q, k and v get no
# gradient through attention), read grad norm 0.193, m 1.0, move 1.0.
TOL_TRAIN = {"bfloat16": {"loss": 1e-4, "grad_norm": 1e-3,
                          "m_rel_l2": 2.0 ** -4, "update_rel_l2": 0.25},
             "float32": {"loss": 1e-5, "grad_norm": 1e-6,
                         "m_rel_l2": 1e-3, "update_rel_l2": 1e-2}}
# the flash Function's dq, dk, dv on the model's own q/k/v (layers 0 and
# last) against autograd through the plain version: the same f32 products
# summed in other orders, each rounded once to bf16, so every element
# within one bf16 rounding (2^-7 |plain|) plus the f32 sums' noise, ~4e-6
# of the summed terms over S = 4096 rows (2^-14 max|plain| leaves ~15x).
# A planted fault, head 0's causal mask dropped from the backward, must
# read > 1.
GRAD_REL, GRAD_ABS_OF_MAX = 2.0 ** -7, 2.0 ** -14


def emit(obj) -> None:
    """Print `obj` as one JSON line; a phase's record also gets `at_s`,
    the script's seconds from its start to the record."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def walk(rng, n):
    return np.cumsum(rng.standard_normal(n))


def plant(ts, src, dst, m, other=None):
    """Copy the window at `src` (of `other`, default `ts`) to `dst` in `ts`,
    shifted to continue the series: a z-normalized exact match."""
    o = ts if other is None else other
    ts[dst:dst + m] = o[src:src + m] - o[src] + ts[dst - 1]
    return ts


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kern, plain, tol: float = TOL_KERNEL) -> dict:
    """Max |corr| error of both sides and index mismatches; indices may
    differ only where the two correlations are within `tol`."""
    out = {"max_abs_err": 0.0, "idx_mismatch": 0, "tie_violations": 0}
    for (ck, ik), (cp, ip) in (((kern[0], kern[1]), (plain[0], plain[1])),
                               ((kern[2], kern[3]), (plain[2], plain[3]))):
        check(ck.shape == cp.shape, f"shapes {ck.shape} vs {cp.shape}")
        err = (ck - cp).abs()
        mism = ik != ip
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        out["idx_mismatch"] += int(mism.sum())
        out["tie_violations"] += int((mism & (err >= tol)).sum())
    return out


def _exact_corr(ts_rows, ts_cols, m, i, j):
    """f64 z-normalized correlation of row window i with column window j
    (index tensors on the card), computed directly from the series."""
    import torch

    def unit_windows(ts, at):
        w = torch.from_numpy(ts).to(DEVICE).unfold(0, m, 1)[at.long()]
        w = w - w.mean(dim=1, keepdim=True)
        return w / w.norm(dim=1, keepdim=True)

    return (unit_windows(ts_rows, i) * unit_windows(ts_cols, j)).sum(dim=1)


def compare_full_size(kern, plain, ts_rows, ts_cols, m, jpad,
                      tol: float = TOL_ORACLE) -> dict:
    """`compare` at `tol` (default TOL_ORACLE), plus the near-tie rule on
    the exact pairs: where the two sides pick different valid indices, the
    f64 correlations of the two picked pairs must be within `tol` of each
    other."""
    out = compare(kern, plain, tol)
    out["exact_pair_violations"] = 0
    for side in (0, 1):
        ik, ip = kern[2 * side + 1], plain[2 * side + 1]
        at = ((ik != ip) & (ik >= 0) & (ip >= 0)).nonzero().flatten()
        if side == 0:      # row r -> column idx
            ek = _exact_corr(ts_rows, ts_cols, m, at, ik[at])
            ep = _exact_corr(ts_rows, ts_cols, m, at, ip[at])
        else:              # column entry c = j + jpad -> row idx
            ek = _exact_corr(ts_rows, ts_cols, m, ik[at], at - jpad)
            ep = _exact_corr(ts_rows, ts_cols, m, ip[at], at - jpad)
        out["exact_pair_violations"] += int(((ek - ep).abs() >= tol).sum())
    return out


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_device() -> tuple[str, str]:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(1)
    smi = _smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def reset_counts() -> None:
    """Every kernel's launch counter to 0 (just before a path is driven)."""
    from repro_torch.kernels import flash_attn, natsa_mp

    natsa_mp.LAUNCHES = 0
    for route in flash_attn.LAUNCHES_BY_ROUTE:
        flash_attn.LAUNCHES_BY_ROUTE[route] = 0


def read_counts() -> dict:
    from repro_torch.kernels import flash_attn, natsa_mp

    return {"natsa_mp": natsa_mp.LAUNCHES, "flash_attn": flash_attn.LAUNCHES,
            "flash_attn_routes": dict(flash_attn.LAUNCHES_BY_ROUTE)}


def _ptxas_entries(log: str, pattern: str) -> list[dict]:
    """ptxas' registers, spills and static shared memory of each entry
    function whose mangled name matches `pattern` (its first group names
    the instance), from a build log."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            inst = re.search(pattern, m.group(1))
            cur = {"instance": inst.group(1)} if inst else None
            if cur:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_store_bytes"], cur["spill_load_bytes"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            cur["static_smem_bytes"] = int(m.group(1))
    return out


def _wgmma_instances(log: str) -> list[dict]:
    """ptxas' registers and spills for each instance of the tensor-core
    flash kernel (`flash_tc_kernel<DP>`), from the build log, with the
    dynamic shared memory its launch asks for."""
    from repro_torch.kernels import flash_attn

    out = _ptxas_entries(log, r"flash_tc_kernelILi(\d+)E")
    lib = flash_attn._lib()
    for inst in out:
        inst["head_dim_padded"] = int(inst.pop("instance"))
        inst["dynamic_smem_bytes"] = lib.flash_attn_wgmma_smem_bytes(
            inst["head_dim_padded"])
    return out


_NATSA_STREAM_TYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16",
                       "6__half": "float16"}


def _natsa_instances(log: str) -> list[dict]:
    """ptxas' registers, spills and static shared memory of each instance
    of the NATSA sweep kernel (one per stream dtype), with its launch
    shape (threads, diagonals per block, steps per stage, dynamic shared
    memory)."""
    from repro_torch.kernels import natsa_mp

    shape = natsa_mp.launch_shape()
    out = _ptxas_entries(log, r"natsa_sweepI(f|13__nv_bfloat16|6__half)E")
    for inst in out:
        inst["stream_dtype"] = _NATSA_STREAM_TYPES[inst.pop("instance")]
        inst.update(shape)
    return out


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc per source
        list(pool.map(_build.load, SOURCES))
    wall = time.perf_counter() - t0
    for name, source in SOURCES.items():
        info = _build.BUILD_LOGS[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if any(k in ln for k in ("registers", "spill",
                                          "Compiling entry"))]
        line = {"phase": "build", "source": source,
                "seconds": info["seconds"], "all_builds_wall_s": wall,
                "cached": info["cached"], "ptxas": ptxas}
        if name == "flash_attn":
            line["wgmma_instances"] = _wgmma_instances(info["log"])
            check(len(line["wgmma_instances"]) == 2
                  and all("registers" in i
                          for i in line["wgmma_instances"]),
                  f"ptxas lines of the wgmma instances: {line}")
        if name == "natsa_mp":
            from repro_torch.kernels import natsa_mp

            insts = line["natsa_instances"] = _natsa_instances(info["log"])
            fields = ("registers", "spill_store_bytes", "spill_load_bytes",
                      "static_smem_bytes", "dynamic_smem_bytes")
            check(sorted(i["stream_dtype"] for i in insts)
                  == sorted(_NATSA_STREAM_TYPES.values())
                  and all(f in i for i in insts for f in fields),
                  f"ptxas lines of the NATSA instances: {line}")
            check(all(i["spill_store_bytes"] == i["spill_load_bytes"] == 0
                      for i in insts), f"a NATSA instance spills: {insts}")
            check(all(i["diagonals_per_block"] ==
                      natsa_mp.DIAGONALS_PER_BLOCK and i["steps_per_stage"]
                      == natsa_mp.STEPS_PER_STAGE for i in insts),
                  f"natsa_mp's tiling constants differ from the kernel's: "
                  f"{insts}")
        emit(line)


def _self_case(ts, m, dtype=None, it=None, excl=None, device=DEVICE):
    from repro_torch.core.matrix_profile import default_exclusion
    from repro_torch.core.zstats import compute_stats_host
    from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, ops

    it = DEFAULT_IT if it is None else it
    excl = default_exclusion(m) if excl is None else excl
    stats = compute_stats_host(ts, m, out_dtype=dtype, device=device)
    df, dg, invn, cov0p, n_rows, _, l = ops._pad_streams(
        stats, it, DEFAULT_DT, excl)
    rows = n_rows * it
    return ((df[:rows], dg[:rows], invn[:rows], df, dg, invn, cov0p),
            dict(k_start=excl, k_end=l, l_i=l, l_j=l, jpad=0))


def _ab_cases(ts_rows, ts_cols, m, exclusion, it=None, device=DEVICE):
    """Kernel inputs of every span of an AB sweep (rows = the first side)."""
    from repro_torch.core.zstats import compute_cross_stats_host
    from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, ops

    it = DEFAULT_IT if it is None else it
    cross = compute_cross_stats_host(ts_rows, ts_cols, m, device=device)
    cases = []
    for s0, s1 in ops.ab_spans(cross.l_a, cross.l_b, exclusion):
        *args, _, _, jpad = ops._pad_streams_ab(cross, it, DEFAULT_DT, s0, s1)
        cases.append((tuple(args), dict(k_start=s0, k_end=s1, l_i=cross.l_a,
                                        l_j=cross.l_b, jpad=jpad)))
    return cases


def natsa_edge_cases() -> list[dict]:
    """Geometries cut around the NATSA kernel's tiles (DB diagonals per
    block, TS rows per stage). The CPU tests hold the plain version to the
    reference's kernel on the same list, and the card tests and phase 3
    the CUDA kernel to the plain version. `n` / `na`, `nb` are series
    lengths (rows on the `na` side), `it` the row padding, `excl` the
    self-join exclusion or the AB exclusion split, `gaps` (start, length)
    runs of NaN."""
    from repro_torch.kernels.natsa_mp import DIAGONALS_PER_BLOCK as DB
    from repro_torch.kernels.natsa_mp import STEPS_PER_STAGE as TS

    return [
        # l = 4 TS + 1: the last stage holds one row
        {"name": "l_one_past_stage", "kind": "self", "n": 4 * TS + 1 + 15,
         "m": 16, "excl": 4, "it": 64, "seed": 21},
        # 100 diagonals, fewer than one block
        {"name": "diagonals_under_one_block", "kind": "self",
         "n": DB - 28 + 3 + 11, "m": 12, "excl": 3, "it": 32, "seed": 22},
        # the negative span ends half way into its second block (jpad > 0)
        {"name": "k_end_inside_block", "kind": "ab", "na": DB + DB // 2 + 8
         + 15, "nb": 150, "m": 16, "excl": 8, "it": 64, "seed": 23},
        # 40 rows, fewer than one stage
        {"name": "rows_under_one_stage", "kind": "ab", "na": 40 + 11,
         "nb": 300, "m": 12, "excl": 0, "it": 8, "seed": 24},
        # the long side on rows: most diagonals negative (jpad = la - 1)
        {"name": "ab_negative_diagonals", "kind": "ab", "na": 300, "nb": 100,
         "m": 16, "excl": 0, "it": 64, "seed": 25},
        # windows 45..69 missing: across the first stage boundary (row 64)
        {"name": "nan_gap_across_stage", "kind": "self", "n": 400, "m": 16,
         "excl": 4, "it": 64, "gaps": [(TS - 4, 10)], "seed": 26},
    ]


def edge_case_series(case: dict) -> tuple:
    """The case's seeded random walks: (ts,) or (rows side, column side)."""
    rng = np.random.default_rng(case["seed"])
    series = tuple(walk(rng, case[k]) for k in (
        ("n",) if case["kind"] == "self" else ("na", "nb")))
    for start, length in case.get("gaps", ()):
        series[0][start:start + length] = np.nan
    return series


def edge_case_inputs(case: dict, device=DEVICE) -> list[tuple]:
    """Kernel (args, kwargs) of every launch of the case on `device`."""
    series = edge_case_series(case)
    if case["kind"] == "self":
        return [_self_case(series[0], case["m"], it=case["it"],
                           excl=case["excl"], device=device)]
    return _ab_cases(*series, case["m"], case["excl"], it=case["it"],
                     device=device)


def phase_kernel_cases() -> float:
    import torch

    from repro_torch.kernels import natsa_mp

    rng = np.random.default_rng(SEED)
    n, m = BENCH_16K.n, BENCH_16K.window
    nb = n // 4                     # B: bench-16k's series cut to a quarter
    gaps = walk(rng, n)
    for s in (1000, 5000, 5003, 12000):
        gaps[s:s + 7] = np.nan
    cases = [(f"self_n{n}_m{m}", _self_case(walk(rng, n), m))]
    a, b = walk(rng, n), walk(rng, nb)
    # the planner sweeps the short side on rows
    for excl in (0, 32):
        for k, case in enumerate(_ab_cases(b, a, m, excl)):
            cases.append((f"ab_{n}x{nb}_m{m}_excl{excl}_span{k}", case))
    cases.append(("self_nan_gaps", _self_case(gaps, m)))
    cases.append(("self_bf16", _self_case(walk(rng, n), m,
                                          torch.bfloat16)))
    for case in natsa_edge_cases():
        for k, inputs in enumerate(edge_case_inputs(case)):
            cases.append((f"edge_{case['name']}_span{k}", inputs))
    worst = 0.0
    for name, (args, kw) in cases:
        kern = natsa_mp.rowmax_profile_ab(*args, **kw)
        torch.cuda.synchronize()
        plain = natsa_mp.rowmax_profile_ab_plain(*args, **kw)
        res = compare(kern, plain)
        emit({"phase": "kernel_vs_plain", "case": name,
              "dtype": str(args[0].dtype), "rows": args[0].shape[0],
              "diagonals": args[6].shape[0], **res})
        check(res["max_abs_err"] <= TOL_KERNEL,
              f"{name}: kernel vs plain {res['max_abs_err']} > {TOL_KERNEL}")
        check(res["tie_violations"] == 0,
              f"{name}: {res['tie_violations']} index mismatches off ties")
        worst = max(worst, res["max_abs_err"])
    return worst


def _bound(args, kw, cells: float) -> dict:
    """Least time for the call: max(FLOPs / FP32 peak, bytes / HBM rate),
    each input read once and each output written once."""
    from repro_torch.kernels.ops import FLOPS_PER_CELL

    rows, jp, n_diag = args[0].shape[0], args[3].shape[0], args[6].shape[0]
    col_len = max(rows + kw["k_start"] + n_diag + kw["jpad"],
                  kw["l_j"] + kw["jpad"])
    sb = args[0].element_size()
    nbytes = 3 * rows * sb + 3 * jp * sb + 4 * n_diag + (rows + col_len) * 8
    t_ops = cells * FLOPS_PER_CELL / FP32_PEAK
    t_bytes = nbytes / HBM_RATE
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "flops": cells * FLOPS_PER_CELL}


def _roofline_terms(l: int, excl: int, kt: dict) -> dict:
    """`ops.kernel_roofline`'s terms for the self-join (the reference's
    byte model at its tile geometry, over the card's rates) beside
    `_bound`'s, whose compute terms must agree: the same cells and FLOPs
    per cell at the same f32 peak."""
    from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, ops

    kr = ops.kernel_roofline(l, excl, DEFAULT_IT, DEFAULT_DT)
    bound_ops_ms = 1e3 * kt["flops"] / FP32_PEAK
    check(abs(1e3 * kr["t_compute_s"] - bound_ops_ms) <= 1e-9 * bound_ops_ms,
          f"kernel_roofline's compute term {kr} against _bound's "
          f"{bound_ops_ms} ms")
    return {"kernel_roofline": kr, "bound_ops_ms": bound_ops_ms,
            "bound_bytes_ms": 1e3 * kt["bytes"] / HBM_RATE,
            "kernel_roofline_ms": 1e3 * max(kr["t_compute_s"],
                                            kr["t_memory_s"])}


def _time_kernel(args, kw, cells: float, ts_rows, ts_cols, m) -> dict:
    """Kernel ms (CUDA events, after a warm-up), plain ms (one run), the
    kernel-vs-plain comparison at the main path's shapes, and whether the
    first and the last of the four launches gave bitwise equal outputs."""
    import torch

    from repro_torch.kernels import natsa_mp

    kern = natsa_mp.rowmax_profile_ab(*args, **kw)        # warm-up
    torch.cuda.synchronize()
    last = []
    ms = cuda_ms(lambda: last.append(natsa_mp.rowmax_profile_ab(*args, **kw)),
                 3)
    repeat = all(torch.equal(a, b) for a, b in zip(kern, last[-1]))
    check(repeat, "the kernel's outputs differ from launch to launch")
    del last
    b = _bound(args, kw, cells)
    plain_box = []
    plain_ms = cuda_ms(lambda: plain_box.append(
        natsa_mp.rowmax_profile_ab_plain(*args, **kw)), 1)
    res = compare_full_size(kern, plain_box[0], ts_rows, ts_cols, m,
                            kw["jpad"])
    check(res["max_abs_err"] <= TOL_ORACLE and res["tie_violations"] == 0
          and res["exact_pair_violations"] == 0,
          f"full size kernel vs plain {res}")
    return {"ms": ms, "plain_ms": plain_ms, **b, "cells": cells,
            "cells_per_s": cells / (ms * 1e-3),
            "share_of_bound": b["bound_ms"] / ms, "bitwise_repeat": repeat,
            "full_size_vs_plain": res}


def _warps_probe(args, kw) -> dict:
    """The NATSA kernel on w blocks (warps) per SM, each on full-length
    diagonals of the AB sweep (k >= 0), timed: `ns_per_step` is one row
    step of one warp. Flat in w means each warp waits on its own
    dependency chain; proportional to w means the SM's pipes are full."""
    import torch

    from repro_torch.kernels import natsa_mp

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    db, ts = natsa_mp.DIAGONALS_PER_BLOCK, natsa_mp.STEPS_PER_STAGE
    d_off = -kw["k_start"]            # the diagonal k = 0
    steps = -(-(kw["l_i"] + db - 1) // ts) * ts
    out = {"sms": sms, "steps_per_warp": steps, "ns_per_step": {}}
    for w in (1, 2, 4):
        nd = db * sms * w
        check(nd <= kw["l_j"] - kw["l_i"] + 1,
              f"{w} warps per SM leave the full-length diagonals")
        sub = (*args[:6], args[6][d_off:d_off + nd].contiguous())
        sub_kw = dict(kw, k_start=0, k_end=nd)
        natsa_mp.rowmax_profile_ab(*sub, **sub_kw)       # warm-up
        ms = cuda_ms(lambda: natsa_mp.rowmax_profile_ab(*sub, **sub_kw), 5)
        out["ns_per_step"][w] = ms * 1e6 / steps
    return out


def _oracle_rows(prof_p, ts_rows, ts_cols, m, rows, exclusion) -> float:
    """Max correlation error of the profile at `rows` against the f64 exact
    profile of those rows, computed on the card."""
    import torch

    from repro_torch.core import ref
    from repro_torch.core.zstats import dist_to_corr

    dev = torch.device(DEVICE)
    d_ref, _ = ref.profile_rows(torch.from_numpy(ts_rows).to(dev),
                                torch.from_numpy(ts_cols).to(dev), m, rows,
                                exclusion=exclusion)
    got = prof_p[torch.as_tensor(rows, device=dev)].double()
    check(bool(torch.isfinite(got).all()), "sampled profile has non-finite")
    return float((dist_to_corr(got, m) - dist_to_corr(d_ref, m)).abs().max())


def _host_peak_rss() -> int:
    """The process's peak resident set so far, in bytes."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _self_join(n: int, m: int, seed: int) -> dict:
    """A random walk of `n` with a planted motif pair through
    `matrix_profile(ts, m, device="cuda")` at the default exclusion: the
    launches, the motif found both ways, 64 sampled rows against their f64
    exact profile, the host prep and its upload apart, the peaks; then the
    kernel timed on the same streams and held against its plain version
    (`_time_kernel`) beside its bound and `kernel_roofline`."""
    import torch

    from repro_torch.core import matrix_profile
    from repro_torch.core.matrix_profile import default_exclusion
    from repro_torch.core.zstats import compute_stats_host, dist_to_corr

    rng = np.random.default_rng(seed)
    pa, pb = n // 5, (3 * n) // 5 + 17
    ts = plant(walk(rng, n), pa, pb, m)
    excl = default_exclusion(m)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = matrix_profile(ts, m, device=DEVICE)
    p, i = res.p, res.i
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["natsa_mp"]
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, "self-join main path launched no kernel")
    check(p.shape == (n - m + 1,) and p.dtype == torch.float32
          and i.dtype == torch.int32 and p.device.type == DEVICE,
          "self-join result shape")
    check(bool(torch.isfinite(p).all()), "self-join profile has non-finite")

    ia, ib = int(i[pa]), int(i[pb])
    motif_corr = float(dist_to_corr(p[[pa, pb]].double(), m).min())
    check(ia == pb and ib == pa, f"motif pair ({pa},{pb}) -> ({ia},{ib})")
    check(motif_corr >= 1 - TOL_ORACLE, f"motif corr {motif_corr}")
    rows = np.sort(np.random.default_rng(seed + 1).choice(
        n - m + 1, SAMPLED_ROWS, replace=False))
    oracle_err = _oracle_rows(p, ts, ts, m, rows, excl)
    check(oracle_err <= TOL_ORACLE,
          f"self oracle error {oracle_err} at n={n} m={m}")
    del res, p, i

    t0 = time.perf_counter()
    stats = compute_stats_host(ts, m, device="cpu")
    prep = time.perf_counter() - t0
    rss = _host_peak_rss()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats.to(DEVICE)
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0
    del stats

    args, kw = _self_case(ts, m)
    l = n - m + 1
    cells = (l - excl) * (l - excl + 1) / 2
    kt = _time_kernel(args, kw, cells, ts, ts, m)
    roof = _roofline_terms(l, excl, kt)
    return {"n": n, "m": m, "launches": launches,
            "counts": counts, "roofline": roof,
            "motif": [pa, pb], "motif_corr": motif_corr,
            "oracle_rows": SAMPLED_ROWS, "oracle_max_corr_err": oracle_err,
            "host_prep_s": prep, "h2d_s": h2d, "e2e_s": e2e,
            "peak_device_bytes": peak, "host_peak_rss_bytes": rss, **kt}


def phase_self() -> dict:
    out = {"phase": "main_self",
           **_self_join(SELF_N, SELF_M, SEED + 1)}
    emit(out)
    return out


# main_paper: every paper workload (PAPER_WORKLOADS, in order) as a
# self-join at full size, seeds PAPER_SEED + 2k; ecg-256k is main_self
PAPER_SEED = SEED + 200
PAPER_FIELDS = ("n", "m", "launches", "counts", "roofline", "motif",
                "motif_corr", "oracle_rows", "oracle_max_corr_err",
                "host_prep_s", "h2d_s", "e2e_s", "peak_device_bytes",
                "host_peak_rss_bytes", "ms", "plain_ms", "bound_ms",
                "bound_by", "share_of_bound", "cells", "cells_per_s",
                "bitwise_repeat", "full_size_vs_plain")


def phase_paper(self_rec: dict) -> dict:
    """The paper's four workloads through the normal entry point on the
    card, each a self-join with a planted motif and the default exclusion
    (`_self_join`): one NATSA launch each, the motif both ways, 64 oracle
    rows within TOL_ORACLE, the kernel's ms beside its bound and against
    its plain version at full size, the host prep and the peaks. ecg-256k
    is `main_self`, whose record is taken."""
    records, counts = {}, {"natsa_mp": 0, "flash_attn": 0}
    for k, w in enumerate(PAPER_WORKLOADS):
        if w == ECG:
            rec = {"from": "main_self",
                   **{f: self_rec[f] for f in PAPER_FIELDS}}
        else:
            rec = _self_join(w.n, w.window, PAPER_SEED + 2 * k)
            for key in counts:
                counts[key] += rec["counts"][key]
        check(rec["launches"] == 1 and rec["counts"]["flash_attn"] == 0,
              f"{w.name}: {rec['counts']}, want 1 NATSA launch")
        rec = {"phase": "main_paper", "workload": w.name, **rec}
        emit(rec)
        records[w.name] = rec
    return {"records": records, "counts": counts}


def phase_ab() -> dict:
    import torch

    from repro_torch.core import ab_join
    from repro_torch.core.zstats import compute_cross_stats_host, dist_to_corr

    rng = np.random.default_rng(SEED + 3)
    m = AB_M
    a, b = walk(rng, AB_NA), walk(rng, AB_NB)
    pa, pb = (2 * AB_NA) // 3, AB_NB // 4
    b = plant(b, pa, pb, m, other=a)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ab_join(a, b, m, return_b=True, device=DEVICE)
    p, i, bp, bi = res.p, res.i, res.b_p, res.b_i
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["natsa_mp"]
    peak = torch.cuda.max_memory_allocated()
    la, lb = AB_NA - m + 1, AB_NB - m + 1
    check(launches > 0, "AB main path launched no kernel")
    check(p.shape == (la,) and bp.shape == (lb,) and p.device.type == DEVICE,
          "AB result shapes")
    check(bool(torch.isfinite(p).all() and torch.isfinite(bp).all()),
          "AB profile has non-finite")
    ia, ib = int(i[pa]), int(bi[pb])
    motif_corr = float(min(dist_to_corr(p[pa].double(), m),
                           dist_to_corr(bp[pb].double(), m)))
    check(ia == pb and ib == pa, f"AB pair ({pa},{pb}) -> ({ia},{ib})")
    check(motif_corr >= 1 - TOL_ORACLE, f"AB motif corr {motif_corr}")
    srng = np.random.default_rng(SEED + 4)
    err_a = _oracle_rows(p, a, b, m, np.sort(srng.choice(
        la, SAMPLED_ROWS, replace=False)), 0)
    err_b = _oracle_rows(bp, b, a, m, np.sort(srng.choice(
        lb, SAMPLED_ROWS, replace=False)), 0)
    check(max(err_a, err_b) <= TOL_ORACLE, f"AB oracle {err_a}, {err_b}")

    t0 = time.perf_counter()
    cross = compute_cross_stats_host(b, a, m, device="cpu")  # swept: b on rows
    prep = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cross.to(DEVICE)
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0

    (args, kw), = _ab_cases(b, a, m, 0)
    kt = _time_kernel(args, kw, float(la) * lb, b, a, m)
    kt["warps_per_sm_probe"] = _warps_probe(args, kw)
    out = {"phase": "main_ab", "n_a": AB_NA, "n_b": AB_NB, "m": m,
           "launches": launches, "counts": counts, "motif": [pa, pb],
           "motif_corr": motif_corr,
           "oracle_rows": SAMPLED_ROWS, "oracle_max_corr_err_a": err_a,
           "oracle_max_corr_err_b": err_b, "host_prep_s": prep, "h2d_s": h2d,
           "e2e_s": e2e, "peak_device_bytes": peak, **kt}
    emit(out)
    return out


def _flash_inputs(rng, shape, dtype, kv_heads=None):
    """Seeded q, k, v on the card; K/V made with `kv_heads` heads and
    repeated to the query heads, as grouped-query attention shares them."""
    import torch

    b, h, s, d = shape
    kvh = h if kv_heads is None else kv_heads
    q = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, kvh, s, d),
                                                 dtype=np.float32))
            for _ in range(2))
    q, k, v = (x.to(DEVICE).to(dtype) for x in (q, k, v))
    if kvh != h:
        k, v = (x.repeat_interleave(h // kvh, dim=1).contiguous()
                for x in (k, v))
    return q, k, v


def _on_route(route: str, fn):
    """fn()'s output, checking that it launched one flash kernel, on
    `route`."""
    import torch

    from repro_torch.kernels import flash_attn

    before = dict(flash_attn.LAUNCHES_BY_ROUTE)
    out = fn()
    torch.cuda.synchronize()
    grew = {r: flash_attn.LAUNCHES_BY_ROUTE[r] - before[r] for r in before}
    check(grew == {r: int(r == route) for r in before},
          f"flash launches by route {grew}, expected one on {route}")
    return out


def phase_flash_cases() -> tuple[float, float, float]:
    """The flash kernels against their plain version on the card: the
    reference's table (tests/test_flash_and_streaming.py:12-50), in f32
    on the fma route and in bf16 on the wgmma route. Returns the worst f32
    error, the worst bf16 error and the worst bf16 element ratio."""
    import torch

    from repro_torch.kernels import flash_attn

    rng = np.random.default_rng(SEED + 5)
    worst = 0.0
    table = [(2, 2, 128, 32, 64, 64, True), (1, 4, 256, 16, 128, 64, True),
             (2, 1, 128, 64, 32, 128, True), (1, 2, 128, 32, 64, 64, False),
             (1, 1, 64, 8, 64, 64, True),
             # S % 128 != 0: the kernels' masked partial tile
             (1, 2, 96, 40, 32, 48, True), (1, 1, 96, 24, 16, 96, False),
             (2, 1, 80, 128, 16, 40, True)]
    # f32 also at train_lm_torch's attention: 4 x 96 tokens, 6 query heads
    # of 64 over 3 KV heads, blocks gcd(96, 128) = 32 (models/attention.py)
    f32_cases = [(*c, None) for c in table] + [(4, 6, 96, 64, 32, 32, True,
                                                3)]
    for b, h, s, d, bq, bk, causal, kvh in f32_cases:
        q, k, v = _flash_inputs(rng, (b, h, s, d), torch.float32, kvh)
        out = _on_route("fma", lambda: flash_attn.flash_attention(
            q, k, v, bq=bq, bk=bk, causal=causal))
        plain = flash_attn.flash_attention_plain(q, k, v, causal=causal)
        err = float((out - plain).abs().max())
        emit({"phase": "flash_vs_plain", "case": [b, h, s, d, bq, bk, causal],
              "kv_heads": kvh or h, "dtype": "float32", "max_abs_err": err,
              "tol": TOL_FLASH_F32})
        check(err <= TOL_FLASH_F32, f"flash f32 case {b, h, s, d}: {err}")
        worst = max(worst, err)
    worst_bf16 = worst_ratio = 0.0
    bf16_cases = [(1, 2, 128, 32, 64, 64, True)] + table + [
        (1, 4, 1024, 128, 128, 128, False),  # non-causal at full head width
        (1, 4, 4096, 64, 128, 128, True),    # D = 64 at S = 4096
        # whisper-large-v3's encoder: 20 heads of 64 over 1500 frames,
        # bidirectional (1500 = 11 · 128 + 92, a masked partial tile)
        (1, 20, 1500, 64, 4, 4, False)]
    for b, h, s, d, bq, bk, causal in bf16_cases:
        q, k, v = _flash_inputs(rng, (b, h, s, d), torch.bfloat16)
        out = _on_route("wgmma", lambda: flash_attn.flash_attention(
            q, k, v, bq=bq, bk=bk, causal=causal))
        plain = flash_attn.flash_attention_plain(q, k, v, causal=causal)
        err = float((out.float() - plain.float()).abs().max())
        ratio = flash_attn.element_ratio(out, plain)
        emit({"phase": "flash_vs_plain", "case": [b, h, s, d, bq, bk, causal],
              "dtype": "bfloat16", "route": "wgmma",
              "out_dtype": str(out.dtype), "max_abs_err": err,
              "tol": TOL_FLASH_BF16, "element_ratio": ratio})
        check(out.dtype == torch.bfloat16 and err <= TOL_FLASH_BF16
              and ratio <= 1.0,
              f"flash bf16 case {b, h, s, d, causal}: {out.dtype}, {err}, "
              f"element ratio {ratio}")
        worst_bf16, worst_ratio = max(worst_bf16, err), max(worst_ratio,
                                                            ratio)
    q, k, v = _flash_inputs(rng, (1, 2, 128, 16), torch.float32)
    a = _on_route("fma", lambda: flash_attn.flash_attention(q, k, v, bq=32,
                                                            bk=32))
    b = _on_route("fma", lambda: flash_attn.flash_attention(q, k, v, bq=128,
                                                            bk=64))
    plain = flash_attn.flash_attention_plain(q, k, v)
    inv = float((a - b).abs().max())
    err = max(float((a - plain).abs().max()), float((b - plain).abs().max()))
    emit({"phase": "flash_vs_plain", "case": "block_invariance_32x32_128x64",
          "dtype": "float32", "blocks_max_abs_diff": inv,
          "max_abs_err": err, "tol": TOL_FLASH_BLOCKS})
    check(inv <= TOL_FLASH_BLOCKS and err <= TOL_FLASH_F32,
          f"flash block invariance {inv}, vs plain {err}")
    return max(worst, err), worst_bf16, worst_ratio


def _planted_fault(q, k, v, plain_tail, tile: int = 64) -> dict:
    """What the full-size checks read for a kernel that drops head 0's
    first KV tile (keys < `tile`) on rows >= FAULT_ROW0: that output is
    computed here in plain PyTorch and held against the plain version's
    rows `plain_tail` under both checks."""
    import torch

    from repro_torch.kernels.flash_attn import (ELEMENT_ABS, ELEMENT_REL,
                                                NEG_INF, element_ratio)

    s, d = q.shape[2], q.shape[3]
    qh, kh, vh = (x[0, 0].float() for x in (q, k, v))
    parts = []
    for r0 in range(FAULT_ROW0, s, 4096):
        r1 = min(s, r0 + 4096)
        logits = (qh[r0:r1] @ kh[tile:r1].T) / d ** 0.5
        pos = torch.arange(r0, r1, device=q.device)[:, None]
        key = torch.arange(tile, r1, device=q.device)[None, :]
        logits.masked_fill_(key > pos, NEG_INF)
        parts.append((torch.softmax(logits, dim=-1) @ vh[tile:r1])
                     .to(q.dtype))
    faulty = torch.cat(parts)

    def reading(rows):
        f, p = faulty[rows].float(), plain_tail[rows]
        bad = (f - p).abs() > ELEMENT_REL * p.abs() + ELEMENT_ABS
        return {"element_ratio": element_ratio(f, p),
                "elements_over": int(bad.sum()), "elements": bad.numel(),
                "max_abs_err": float((f - p).abs().max())}

    late = FAULT_LATE_ROW0 - FAULT_ROW0
    return {"fault": f"head 0, keys < {tile} dropped for rows >= "
                     f"{FAULT_ROW0}", **reading(slice(None)),
            f"rows_from_{FAULT_LATE_ROW0}": reading(slice(late, None))}


def phase_flash() -> dict:
    """`flash_attention` at llama3-8b width, prefill_32k, one sequence."""
    import torch

    from repro_torch.kernels import flash_attn

    b, h, s, d = FLASH_B, FLASH_H, FLASH_S, FLASH_D
    q, k, v = _flash_inputs(np.random.default_rng(SEED + 6), (b, h, s, d),
                            torch.bfloat16, kv_heads=FLASH_KV_H)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = flash_attn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attn"] > 0, "flash path launched no kernel")
    check(counts["flash_attn_routes"] == {"wgmma": counts["flash_attn"],
                                          "fma": 0},
          f"flash path did not run the wgmma route: {counts}")
    check(out.shape == (b, h, s, d) and out.dtype == torch.bfloat16
          and out.device.type == DEVICE, "flash output shape/dtype")
    check(bool(torch.isfinite(out).all()), "flash output has non-finite")

    ms = cuda_ms(lambda: flash_attn.flash_attention(q, k, v), 3)
    plain_box = []
    plain_ms = cuda_ms(lambda: plain_box.append(
        flash_attn.flash_attention_plain(q, k, v)), 1)
    plain = plain_box[0].float()
    err = float((out.float() - plain).abs().max())
    scale = float(plain.abs().max())
    ratio = flash_attn.element_ratio(out, plain)
    check(ratio <= 1.0 and err <= TOL_FLASH_FULL * scale,
          f"flash full size vs plain: element ratio {ratio}, {err} vs "
          f"{TOL_FLASH_FULL} x {scale}")
    fault = _planted_fault(q, k, v, plain[0, 0, FAULT_ROW0:])
    for part in (fault, fault[f"rows_from_{FAULT_LATE_ROW0}"]):
        part["within_whole_output_limit"] = (
            part["max_abs_err"] <= TOL_FLASH_FULL * scale)
    check(fault["element_ratio"] > 1.0,
          f"the full-size check passes a planted fault: {fault}")
    del plain, plain_box
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa(q, k, v, is_causal=True)                       # warm-up
    library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True), 3)
    flops = 4.0 * b * h * d * s * s / 2
    nbytes = 4.0 * b * h * s * d * q.element_size()
    t_ops, t_bytes = flops / BF16_PEAK, nbytes / HBM_RATE
    # the wgmma kernel's own tensor work: QK once, PV twice (P_hi, P_lo)
    kernel_floor_ms = 1e3 * 1.5 * flops / BF16_PEAK
    out = {"phase": "main_flash", "shape": [b, h, s, d], "dtype": "bfloat16",
           "causal": True, "kv_heads": FLASH_KV_H, "launches":
           counts["flash_attn"], "counts": counts,
           "launches_by_route": counts["flash_attn_routes"], "e2e_s": e2e,
           "peak_device_bytes": peak, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes,
           "share_of_bound": 1e3 * max(t_ops, t_bytes) / ms,
           "kernel_floor_ms": kernel_floor_ms,
           "library_ratio": ms / library_ms,
           "max_abs_err": err, "max_abs_plain": scale,
           "tol": TOL_FLASH_FULL * scale, "element_ratio": ratio,
           "planted_fault": fault}
    emit(out)
    return out


def _sides(res, kind: str, m: int):
    """A ProfileResult in correlation space, in `compare`'s layout: (row
    side corr, idx, column side corr, idx) — right/left for a self-join,
    A/B for an AB join."""
    import torch

    from repro_torch.core.zstats import dist_to_corr

    def c(dist):      # no neighbour (inf) -> the kernel's NEG
        return torch.where(torch.isfinite(dist),
                           dist_to_corr(dist.double(), m), -2.0).float()

    if kind == "self":
        return c(res.right_p), res.right_i, c(res.left_p), res.left_i
    return c(res.p), res.i, c(res.b_p), res.b_i


def phase_engine() -> list[dict]:
    """The band engine against the kernel path on the card, at a depth cut
    to fit the script's time: both sides of each sweep under the full-size
    near-tie rule, in reported and in exact f64 correlation."""
    import torch

    from repro_torch.core import plan as plan_mod
    from repro_torch.core.result import build_result
    from repro_torch.core.zstats import compute_stats_host

    rng = np.random.default_rng(SEED + 7)
    outs = []
    ts = walk(rng, ENGINE_SELF_N)
    a, b = walk(rng, ENGINE_AB_NA), walk(rng, ENGINE_AB_NB)
    cases = [("self", ENGINE_SELF_M, (ts,)), ("ab", ENGINE_AB_M, (a, b))]
    for kind, m, series in cases:
        ls = [len(x) - m + 1 for x in series]
        got = {}
        for backend in ("engine", None):
            plan = plan_mod.plan_sweep(m, *ls, backend=backend,
                                       harvest="both", device=DEVICE)
            stats = (compute_stats_host(series[0], m, device=DEVICE)
                     if kind == "self"
                     else plan_mod.cross_stats_for(plan, *series))
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = plan_mod.execute(plan, stats)
            torch.cuda.synchronize()
            got[plan.backend] = (build_result(plan, res),
                                 time.perf_counter() - t0, read_counts())
        (eng, eng_s, eng_counts), (ker, ker_s, ker_counts) = \
            got["engine"], got["kernel"]
        check(eng_counts["natsa_mp"] == 0 and ker_counts["natsa_mp"] > 0,
              f"{kind}: engine/kernel launch counts {eng_counts} "
              f"{ker_counts}")
        ts_rows, ts_cols = (series[0], series[0]) if kind == "self" \
            else series
        res = compare_full_size(_sides(ker, kind, m), _sides(eng, kind, m),
                                ts_rows, ts_cols, m, 0)
        check(res["max_abs_err"] <= TOL_ORACLE and res["tie_violations"] == 0
              and res["exact_pair_violations"] == 0,
              f"{kind}: engine vs kernel {res}")
        out = {"phase": "engine_vs_kernel", "kind": kind,
               "n": [len(x) for x in series], "m": m,
               "engine_ms": 1e3 * eng_s, "kernel_path_ms": 1e3 * ker_s,
               "engine_counts": eng_counts, "kernel_counts": ker_counts,
               "vs_kernel": res}
        emit(out)
        outs.append(out)
    return outs


def _topk_vs_oracle(tk_p, tk_i, ts_rows, ts_cols, m, rows,
                    exclusion) -> dict:
    """All k slots of the sampled `rows` against their f64 exact top-k on
    the card: each slot's correlation within TOL_ORACLE of the oracle's
    slot, and each pick's own exact correlation within TOL_ORACLE of the
    oracle's slot (an index differs only at a near-tie)."""
    import torch

    from repro_torch.core import ref
    from repro_torch.core.zstats import dist_to_corr

    dev = torch.device(DEVICE)
    k = tk_p.shape[1]
    d_ref, i_ref = ref.profile_rows_topk(torch.from_numpy(ts_rows).to(dev),
                                         torch.from_numpy(ts_cols).to(dev),
                                         m, rows, k, exclusion=exclusion)
    at = torch.as_tensor(rows, device=dev)
    got_p, got_i = tk_p[at].double(), tk_i[at]
    check(bool(torch.isfinite(got_p).all() and (got_i >= 0).all()),
          "sampled top-k rows have unfilled slots")
    c_ref = dist_to_corr(d_ref, m)
    err = float((dist_to_corr(got_p, m) - c_ref).abs().max())
    r = at[:, None].expand(-1, k).reshape(-1)
    own = _exact_corr(ts_rows, ts_cols, m, r, got_i.reshape(-1)).reshape(
        -1, k)
    picks = int(((own - c_ref).abs() >= TOL_ORACLE).sum())
    distinct = all(len(set(row.tolist())) == k for row in got_i.cpu())
    return {"rows": len(rows), "k": k, "max_corr_err": err,
            "pick_violations": picks, "index_mismatch":
            int((got_i != i_ref).sum()), "distinct": distinct}


def _timed(fn):
    """(fn(), host seconds to the card's end of it)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_topk() -> dict:
    """`matrix_profile(ts, 512, k=4)` at ecg-256k with a planted motif
    pair: the band engine's top-k by the planner's fallback, no NATSA
    launch. Slot 0 against the k = 1 kernel path under the full-size rule,
    all four slots of 64 sampled rows against their f64 exact top-4."""
    import torch

    from repro_torch.core import matrix_profile
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.matrix_profile import default_exclusion

    rng = np.random.default_rng(SEED + 8)
    n, m, k = TOPK_N, TOPK_M, TOPK_K
    pa, pb = n // 5, (3 * n) // 5 + 17
    ts = plant(walk(rng, n), pa, pb, m)
    excl = default_exclusion(m)
    l = n - m + 1

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res, e2e = _timed(lambda: matrix_profile(ts, m, k=k, device=DEVICE))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["natsa_mp"] == 0 and counts["flash_attn"] == 0,
          f"top-k path launched a kernel: {counts}")
    check(res.backend == "engine", f"top-k backend {res.backend}")
    tk_p, tk_i = res.topk_p, res.topk_i
    check(tk_p.shape == (l, k) and tk_i.dtype == torch.int32
          and tk_p.device.type == DEVICE, "top-k result shape")
    check(bool(torch.isfinite(tk_p[:, 0]).all()), "top-k slot 0 non-finite")
    check(int(tk_i[pa, 0]) == pb and int(tk_i[pb, 0]) == pa,
          f"top-k motif pair ({pa},{pb}) -> ({int(tk_i[pa, 0])},"
          f"{int(tk_i[pb, 0])})")
    rows = np.sort(np.random.default_rng(SEED + 10).choice(
        l, SAMPLED_ROWS, replace=False))
    oracle = _topk_vs_oracle(tk_p, tk_i, ts, ts, m, rows, excl)
    check(oracle["max_corr_err"] <= TOL_ORACLE
          and oracle["pick_violations"] == 0 and oracle["distinct"],
          f"top-k vs f64 exact top-{k}: {oracle}")

    # the engine alone, on the same plan and streams
    lazy = object.__getattribute__(res, "_lazy")
    _, engine_s = _timed(lambda: plan_mod.execute(lazy.plan, lazy.stats))
    # slot 0 (its right/left split) against the k = 1 kernel path
    k1 = matrix_profile(ts, m, harvest="both", device=DEVICE)
    check(k1.backend == "kernel", "the k = 1 path left the kernel")
    vs_k1 = compare_full_size(_sides(k1, "self", m), _sides(res, "self", m),
                              ts, ts, m, 0)
    check(vs_k1["max_abs_err"] <= TOL_ORACLE and vs_k1["tie_violations"] == 0
          and vs_k1["exact_pair_violations"] == 0,
          f"top-k slot 0 vs the k = 1 kernel path {vs_k1}")
    out = {"phase": "main_topk", "n": n, "m": m, "k": k, "exclusion": excl,
           "backend": res.backend, "counts": counts, "e2e_s": e2e,
           "engine_ms": 1e3 * engine_s, "peak_device_bytes": peak,
           "motif": [pa, pb], "slot0_vs_k1_kernel": vs_k1,
           "oracle": oracle}
    emit(out)
    return out


def phase_rowstream() -> dict:
    """`ab_join(q, b, 128, backend="rowstream", return_b=True)`, l_q = 4096
    against epilepsy-128k's 131072 samples, at k = 1 and k = 4: k = 1
    against the NATSA kernel path under the full-size rule, k = 4's slot 0
    bit for bit against k = 1, 64 sampled rows of each side against their
    f64 exact top-4."""
    import torch

    from repro_torch.core import ab_join

    rng = np.random.default_rng(SEED + 11)
    m = ROWSTREAM_M
    q = walk(rng, ROWSTREAM_LQ + m - 1)
    b = walk(rng, ROWSTREAM_NB)
    pq, pb = ROWSTREAM_LQ // 3, (2 * ROWSTREAM_NB) // 3
    b = plant(b, pq, pb, m, other=q)
    lq, lb = ROWSTREAM_LQ, ROWSTREAM_NB - m + 1

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    r1, s1 = _timed(lambda: ab_join(q, b, m, backend="rowstream",
                                    return_b=True, device=DEVICE))
    r4, s4 = _timed(lambda: ab_join(q, b, m, backend="rowstream",
                                    return_b=True, k=TOPK_K, device=DEVICE))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["natsa_mp"] == 0 and counts["flash_attn"] == 0,
          f"rowstream path launched a kernel: {counts}")
    check(r1.backend == r4.backend == "rowstream", "rowstream backend")
    check(r1.p.shape == (lq,) and r1.b_p.shape == (lb,)
          and r4.topk_p.shape == (lq, TOPK_K)
          and r4.b_topk_p.shape == (lb, TOPK_K), "rowstream shapes")
    check(bool(torch.isfinite(r1.p).all() and torch.isfinite(r1.b_p).all()),
          "rowstream profile non-finite")
    check(int(r1.i[pq]) == pb and int(r1.b_i[pb]) == pq,
          f"rowstream pair ({pq},{pb}) -> ({int(r1.i[pq])},"
          f"{int(r1.b_i[pb])})")
    slot0 = {"a": bool(torch.equal(r4.topk_p[:, 0], r1.p)),
             "b": bool(torch.equal(r4.b_topk_p[:, 0], r1.b_p))}
    check(all(slot0.values()), f"k=4 slot 0 != k=1 rowstream: {slot0}")

    reset_counts()
    kern = ab_join(q, b, m, return_b=True, device=DEVICE)
    torch.cuda.synchronize()
    check(kern.backend == "kernel" and read_counts()["natsa_mp"] > 0,
          "the comparison path left the NATSA kernel")
    vs_kernel = compare_full_size(_sides(kern, "ab", m), _sides(r1, "ab", m),
                                  q, b, m, 0)
    check(vs_kernel["max_abs_err"] <= TOL_ORACLE
          and vs_kernel["tie_violations"] == 0
          and vs_kernel["exact_pair_violations"] == 0,
          f"rowstream vs the NATSA kernel path {vs_kernel}")
    srng = np.random.default_rng(SEED + 12)
    oracle_a = _topk_vs_oracle(r4.topk_p, r4.topk_i, q, b, m, np.sort(
        srng.choice(lq, SAMPLED_ROWS, replace=False)), 0)
    oracle_b = _topk_vs_oracle(r4.b_topk_p, r4.b_topk_i, b, q, m, np.sort(
        srng.choice(lb, SAMPLED_ROWS, replace=False)), 0)
    for o in (oracle_a, oracle_b):
        check(o["max_corr_err"] <= TOL_ORACLE and o["pick_violations"] == 0
              and o["distinct"], f"rowstream vs f64 exact top-4: {o}")
    out = {"phase": "main_rowstream", "l_q": lq, "n_b": ROWSTREAM_NB,
           "m": m, "counts": counts, "ms": 1e3 * s1,
           "ms_k4": 1e3 * s4, "peak_device_bytes": peak,
           "slot0_bitwise": slot0, "k1_vs_kernel": vs_kernel,
           "oracle_a": oracle_a, "oracle_b": oracle_b}
    emit(out)
    return out


def _equal_fields(batched, seq, fields) -> dict:
    """Each stacked field against the per-series results, bit for bit."""
    import torch

    out = {}
    for f in fields:
        want = torch.stack([getattr(r, f) for r in seq])
        out[f] = bool(torch.equal(getattr(batched, f), want))
    return out


def phase_batch() -> dict:
    """Batched plans equal the per-series sequential calls bit for bit, on
    the card: `batch_profile` of 4 series at bench-16k; `batch_ab_join` of
    8 queries (l = 4096) against 8 series of 32768 on rowstream, and with
    k = 4 on the batched default (the engine)."""
    import torch

    from repro_torch.core import ab_join, batch_ab_join, batch_profile
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.result import build_result
    from repro_torch.core.zstats import compute_stats_host

    rng = np.random.default_rng(SEED + 13)
    m = BATCH_M
    selfs = np.stack([walk(rng, BATCH_SELF_N) for _ in range(BATCH_SELF_B)])
    qs = np.stack([walk(rng, BATCH_AB_LQ + m - 1) for _ in range(BATCH_AB_B)])
    bs = np.stack([walk(rng, BATCH_AB_NB) for _ in range(BATCH_AB_B)])

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rp, sp = _timed(lambda: batch_profile(selfs, m, harvest="both",
                                          device=DEVICE))
    rr, sr = _timed(lambda: batch_ab_join(qs, bs, m, return_b=True,
                                          backend="rowstream",
                                          device=DEVICE))
    rk, sk = _timed(lambda: batch_ab_join(qs, bs, m, return_b=True,
                                          k=TOPK_K, device=DEVICE))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["natsa_mp"] == 0 and counts["flash_attn"] == 0,
          f"batched paths launched a kernel: {counts}")
    check((rp.backend, rr.backend, rk.backend)
          == ("engine", "rowstream", "engine"),
          f"batched backends {rp.backend} {rr.backend} {rk.backend}")
    check(rp.p.shape == (BATCH_SELF_B, BATCH_SELF_N - m + 1)
          and rr.b_p.shape == (BATCH_AB_B, BATCH_AB_NB - m + 1)
          and rk.topk_p.shape == (BATCH_AB_B, BATCH_AB_LQ, TOPK_K),
          "batched shapes")

    def seq_self():
        plan = plan_mod.plan_sweep(m, BATCH_SELF_N - m + 1, backend="engine",
                                   harvest="both", device=DEVICE)
        return [build_result(plan, plan_mod.execute(
            plan, compute_stats_host(s, m, device=DEVICE))) for s in selfs]

    def seq_ab(k, backend):
        if backend == "rowstream":
            return [ab_join(a, b, m, return_b=True, backend=backend,
                            device=DEVICE) for a, b in zip(qs, bs)]
        plan = plan_mod.plan_sweep(m, BATCH_AB_LQ, BATCH_AB_NB - m + 1, k=k,
                                   backend=backend, harvest="both",
                                   device=DEVICE)
        return [build_result(plan, plan_mod.execute(
            plan, plan_mod.cross_stats_for(plan, a, b)))
            for a, b in zip(qs, bs)]

    eq = {"batch_profile": _equal_fields(rp, seq_self(), (
              "p", "i", "left_p", "left_i", "right_p", "right_i")),
          "batch_ab_join_rowstream": _equal_fields(rr, seq_ab(1, "rowstream"),
                                                   ("p", "i", "b_p", "b_i")),
          "batch_ab_join_k4": _equal_fields(rk, seq_ab(TOPK_K, "engine"), (
              "p", "i", "topk_p", "topk_i", "b_p", "b_i", "b_topk_p",
              "b_topk_i"))}
    check(all(v for d in eq.values() for v in d.values()),
          f"batched != sequential: {eq}")
    for res in (rp, rr, rk):
        check(bool(torch.isfinite(res.p).all()), "batched profile non-finite")
    out = {"phase": "main_batch", "counts": counts,
           "batch_profile": {"B": BATCH_SELF_B, "n": BATCH_SELF_N, "m": m,
                             "ms": 1e3 * sp},
           "batch_ab_join_rowstream": {"B": BATCH_AB_B, "l_q": BATCH_AB_LQ,
                                       "n_b": BATCH_AB_NB, "ms": 1e3 * sr},
           "batch_ab_join_k4": {"B": BATCH_AB_B, "k": TOPK_K,
                                "backend": rk.backend, "ms": 1e3 * sk},
           "peak_device_bytes": peak, "bitwise_equal_sequential": eq}
    emit(out)
    return out


def telemetry(rng, n, level=0.0):
    """A stationary series, as telemetry is: smoothed noise (an AR(1)-like
    exponential filter, std ~3) around `level`. Raw distances round with
    the series' level squared; `main_nonnorm` reports a random walk and an
    offset walk beside it."""
    kern = 0.95 ** np.arange(128)
    return level + np.convolve(rng.standard_normal(n + 127), kern)[127:n + 127]


def _nonnorm_vs_oracle(p, i, ts_rows, ts_cols, m, rows, exclusion) -> dict:
    """Raw distances of the sampled `rows` against their f64 exact profile
    on the card, within NONNORM_ATOL + NONNORM_RTOL d64; where an index
    differs, the picked pair's exact distance must be within the same
    tolerance of the oracle's."""
    import torch

    from repro_torch.core import ref

    dev = torch.device(DEVICE)
    a = torch.from_numpy(ts_rows).to(dev)
    b = torch.from_numpy(ts_cols).to(dev)
    d64, i64 = ref.profile_rows(a, b, m, rows, exclusion=exclusion,
                                normalize=False)
    at = torch.as_tensor(rows, device=dev)
    got_p, got_i = p[at].double(), i[at].long()
    check(bool(torch.isfinite(got_p).all() and (got_i >= 0).all()),
          "sampled nonnorm rows have no neighbour")
    limit = NONNORM_ATOL + NONNORM_RTOL * d64
    err = (got_p - d64).abs()
    own = (a.unfold(0, m, 1)[at] - b.unfold(0, m, 1)[got_i]).norm(dim=1)
    mism = got_i != i64
    return {"rows": len(rows), "max_abs_err": float(err.max()),
            "max_rel_err": float((err / d64.clamp(min=1e-12)).max()),
            "violations": int((err > limit).sum()),
            "idx_mismatch": int(mism.sum()),
            "pick_violations": int(((own - d64).abs() > limit)[mism].sum())}


def phase_nonnorm() -> dict:
    """`matrix_profile(ts, 256, normalize=False)` at seismology-64k with a
    planted level shift (`analytics.discords` must name its window), and
    `ab_join(a, b, 128, normalize=False, return_b=True)` at the main AB
    shape, each against the f64 exact raw profile of 64 sampled rows."""
    import torch

    from repro_torch.core import ab_join, analytics, matrix_profile
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.matrix_profile import default_exclusion

    def sweep_s(res):
        """Host seconds of the sweep alone: the same plan re-executed on the
        retained payload."""
        lazy = object.__getattribute__(res, "_lazy")
        return _timed(lambda: plan_mod.execute(lazy.plan, lazy.stats))[1]

    rng = np.random.default_rng(SEED + 14)
    n, m = NONNORM_N, NONNORM_M
    ts = telemetry(rng, n)
    shift_at, shift_len = n // 3, m
    ts[shift_at:shift_at + shift_len] += 3.0 * ts.std()
    excl = default_exclusion(m)
    l = n - m + 1

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res, e2e = _timed(lambda: matrix_profile(ts, m, normalize=False,
                                             device=DEVICE))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(res.backend == "engine" and not res.normalize,
          f"nonnorm self-join backend {res.backend}")
    check(res.p.shape == (l,) and res.p.device.type == DEVICE
          and bool(torch.isfinite(res.p).all()), "nonnorm self-join result")
    top = analytics.discords(res, n=1)
    check(len(top) == 1 and shift_at - m < top[0].position
          < shift_at + shift_len, f"discord {top} misses the level shift "
          f"at [{shift_at}, {shift_at + shift_len})")
    rows = np.sort(np.random.default_rng(SEED + 15).choice(
        l, SAMPLED_ROWS, replace=False))
    self_oracle = _nonnorm_vs_oracle(res.p, res.i, ts, ts, m, rows, excl)
    check(self_oracle["violations"] == 0
          and self_oracle["pick_violations"] == 0,
          f"nonnorm self-join vs f64 oracle {self_oracle}")

    m_ab = AB_M
    a = telemetry(rng, AB_NA, level=5.0)
    b = telemetry(rng, AB_NB, level=5.0)
    la, lb = AB_NA - m_ab + 1, AB_NB - m_ab + 1
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rab, e2e_ab = _timed(lambda: ab_join(a, b, m_ab, normalize=False,
                                         return_b=True, device=DEVICE))
    counts_ab = read_counts()
    peak_ab = torch.cuda.max_memory_allocated()
    check(rab.backend == "engine" and rab.p.shape == (la,)
          and rab.b_p.shape == (lb,)
          and bool(torch.isfinite(rab.p).all()
                   and torch.isfinite(rab.b_p).all()), "nonnorm AB result")
    srng = np.random.default_rng(SEED + 16)
    oracle_a = _nonnorm_vs_oracle(rab.p, rab.i, a, b, m_ab, np.sort(
        srng.choice(la, SAMPLED_ROWS, replace=False)), 0)
    oracle_b = _nonnorm_vs_oracle(rab.b_p, rab.b_i, b, a, m_ab, np.sort(
        srng.choice(lb, SAMPLED_ROWS, replace=False)), 0)
    for o in (oracle_a, oracle_b):
        check(o["violations"] == 0 and o["pick_violations"] == 0,
              f"nonnorm AB vs f64 oracle {o}")
    for c in (counts, counts_ab):
        check(c["natsa_mp"] == 0 and c["flash_attn"] == 0,
              f"nonnorm path launched a kernel: {c}")

    # reported, not gated: the raw self-join on a drifting series (a random
    # walk) and on the walk at level 1000, where the f32 recurrence rounds
    # with the level squared, and the same with f64 accumulation (the
    # reference's CPU reading at n=16384 is `python tests/test_torch_nonnorm.py`)
    wts = walk(np.random.default_rng(SEED + 21), n)
    level_readings = {}
    for kind, series in (("walk", wts), ("offset_walk", wts + 1000.0)):
        for prec in ("f32", "f64"):
            rw, e2e_w = _timed(lambda: matrix_profile(
                series, m, normalize=False, precision=prec, device=DEVICE))
            level_readings[f"{kind}_{prec}"] = {
                "level_span": float(series.max() - series.min()),
                "level_max_abs": float(np.abs(series).max()), "e2e_s": e2e_w,
                **_nonnorm_vs_oracle(rw.p, rw.i, series, series, m, rows,
                                     excl)}
            del rw
    out = {"phase": "main_nonnorm", "card": torch.cuda.get_device_name(0),
           "tolerance": f"|d - d64| <= {NONNORM_ATOL} + {NONNORM_RTOL} d64",
           "counts": {"self": counts, "ab": counts_ab},
           "self": {"n": n, "m": m, "exclusion": excl, "e2e_s": e2e,
                    "ms": 1e3 * sweep_s(res), "peak_device_bytes": peak,
                    "level_shift": [shift_at, shift_at + shift_len],
                    "discord": [top[0].position, top[0].score],
                    "oracle": self_oracle,
                    "level_readings_not_gated": level_readings},
           "ab": {"n_a": AB_NA, "n_b": AB_NB, "m": m_ab, "e2e_s": e2e_ab,
                  "ms": 1e3 * sweep_s(rab), "peak_device_bytes": peak_ab,
                  "oracle_a": oracle_a, "oracle_b": oracle_b}}
    emit(out)
    return out


def _tile_bf16_product_reading(stats, ts, m, rows, exclusion) -> float:
    """Reported, not gated: the max correlation error against the f64
    oracle of the sampled rows' profile when the tile sweep's products are
    rounded to bf16 (the sweep's own windows, invn and exclusion, the
    product's f32 result rounded once more): what a sweep that lost its f32
    accumulation would read, between the sweep's error and the bound."""
    import torch

    from repro_torch.core import ref
    from repro_torch.core.matrix_profile import (_ieee_f32_matmul,
                                                 centered_windows)
    from repro_torch.core.zstats import dist_to_corr

    dev = torch.device(DEVICE)
    wc = centered_windows(stats).to(torch.bfloat16).float()
    at = torch.as_tensor(rows, device=dev)
    with _ieee_f32_matmul():
        dot = (wc[at] @ wc.T).to(torch.bfloat16).float()
    del wc
    invn = stats.invn.float()
    corr = dot * invn[at][:, None] * invn[None, :]
    j = torch.arange(corr.shape[1], device=dev)
    corr.masked_fill_((j[None, :] - at[:, None]).abs() < exclusion,
                      float("-inf"))
    d_ref, _ = ref.profile_rows(torch.from_numpy(ts).to(dev),
                                torch.from_numpy(ts).to(dev), m, rows,
                                exclusion=exclusion)
    return float((corr.amax(dim=1).double()
                  - dist_to_corr(d_ref, m)).abs().max())


def phase_tile() -> dict:
    """`matrix_profile(ts, 512, backend="engine", precision="bf16")` at
    ecg-256k: the tile sweep, within `corr_tolerance(bf16, 512)` in
    correlation of 64 f64-oracle rows and of the k = 1 NATSA kernel path
    (near-tie rule); the same bits with TF32 switched on globally."""
    import torch

    from repro_torch.core import matrix_profile
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.matrix_profile import default_exclusion
    from repro_torch.core.precision import as_precision, corr_tolerance
    from repro_torch.core.zstats import dist_to_corr

    rng = np.random.default_rng(SEED + 17)
    n, m = TILE_N, TILE_M
    pa, pb = n // 5, (3 * n) // 5 + 17
    ts = plant(walk(rng, n), pa, pb, m)
    excl = default_exclusion(m)
    l = n - m + 1
    tol = corr_tolerance(as_precision("bf16"), m)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res, e2e = _timed(lambda: matrix_profile(
        ts, m, backend="engine", precision="bf16", harvest="both",
        device=DEVICE))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["natsa_mp"] == 0 and counts["flash_attn"] == 0,
          f"tile path launched a kernel: {counts}")
    check(res.backend == "engine" and res.p.shape == (l,)
          and bool(torch.isfinite(res.p).all()), "tile sweep result")
    check(int(res.i[pa]) == pb and int(res.i[pb]) == pa,
          f"tile motif pair ({pa},{pb}) -> ({int(res.i[pa])},"
          f"{int(res.i[pb])})")

    # the same plan and streams with TF32 on globally: the same bits
    lazy = object.__getattribute__(res, "_lazy")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        again, sweep_s = _timed(lambda: plan_mod.execute(lazy.plan,
                                                         lazy.stats))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    tf32_same = all(torch.equal(x, y) for x, y in (
        (again.dist, res.p), (again.index, res.i),
        (again.left_dist, res.left_p), (again.left_index, res.left_i),
        (again.right_dist, res.right_p), (again.right_index, res.right_i)))
    check(tf32_same, "the tile sweep's bits change with TF32 on")
    del again

    rows = np.sort(np.random.default_rng(SEED + 18).choice(
        l, SAMPLED_ROWS, replace=False))
    oracle_err = _oracle_rows(res.p, ts, ts, m, rows, excl)
    check(oracle_err <= tol, f"tile vs f64 oracle {oracle_err} > {tol}")
    k1 = matrix_profile(ts, m, harvest="both", device=DEVICE)
    check(k1.backend == "kernel", "the k = 1 path left the kernel")
    vs_k1 = compare_full_size(_sides(k1, "self", m), _sides(res, "self", m),
                              ts, ts, m, 0, tol=tol)
    check(vs_k1["max_abs_err"] <= tol and vs_k1["tie_violations"] == 0
          and vs_k1["exact_pair_violations"] == 0,
          f"tile vs the k = 1 kernel path {vs_k1}")
    bf16_products = _tile_bf16_product_reading(lazy.stats, ts, m, rows,
                                               excl)
    motif_corr = float(dist_to_corr(res.p[[pa, pb]].double(), m).min())
    flops = float(l) * l * m      # 2 FLOP x m per pair of the triangle
    out = {"phase": "main_tile", "card": torch.cuda.get_device_name(0),
           "n": n, "m": m, "exclusion": excl,
           "precision": "bf16", "tolerance_corr": tol, "counts": counts,
           "e2e_s": e2e, "ms": 1e3 * sweep_s, "peak_device_bytes": peak,
           "flops": flops,
           "bound_ms_fp32": 1e3 * flops / FP32_PEAK,
           "bound_ms_bf16": 1e3 * flops / BF16_PEAK,
           "bound_by": "operations",
           "tf32_on_bitwise_equal": tf32_same,
           "motif": [pa, pb], "motif_corr": motif_corr,
           "oracle_rows": SAMPLED_ROWS, "oracle_max_corr_err": oracle_err,
           "vs_k1_kernel": vs_k1,
           "corr_err_readings": {
               "bound": tol, "vs_oracle": oracle_err,
               "vs_k1_kernel": vs_k1["max_abs_err"],
               "bf16_products_vs_oracle_not_gated": bf16_products}}
    emit(out)
    return out


def _stream(normalize: bool, ts, reappend: bool):
    """A `StreamingProfile(STREAM_M)` fed `ts` in blocks of STREAM_BLOCK
    (with `reappend`, the last STREAM_REAPPEND points one at a time); the
    host ms of each append, synchronized."""
    import torch

    from repro_torch.core.streaming import StreamingProfile

    sp = StreamingProfile(STREAM_M, normalize=normalize, device=DEVICE)
    cut = len(ts) - STREAM_REAPPEND if reappend else len(ts)
    blocks = [ts[s:min(s + STREAM_BLOCK, cut)]
              for s in range(0, cut, STREAM_BLOCK)]
    if reappend:
        blocks += [ts[s:s + 1] for s in range(cut, len(ts))]
    times = []
    for blk in blocks:
        _, s = _timed(lambda: sp.append(blk))
        times.append(1e3 * s)
    torch.cuda.synchronize()
    return sp, times


def phase_streaming() -> dict:
    """`StreamingProfile(128)` over a bench-16k telemetry series, appended
    in blocks of 256, z-normalized and raw: the snapshot against the batch
    `matrix_profile` (3e-3) and 64 f64-oracle rows; a 4096-point `query`
    bit for bit `ab_join`; the last 64 points re-appended one at a time
    (bitwise equality reported, not gated); ms per append."""
    import torch

    from repro_torch.core import ab_join, matrix_profile, ref

    rng = np.random.default_rng(SEED + 19)
    n, m = STREAM_N, STREAM_M
    ts = telemetry(rng, n, level=2.0)
    q = telemetry(rng, STREAM_QUERY_N, level=2.0)
    l = n - m + 1
    dev = torch.device(DEVICE)
    out = {"phase": "main_streaming", "card": torch.cuda.get_device_name(0),
           "n": n, "m": m, "block": STREAM_BLOCK,
           "tolerance": {"vs_batch": STREAM_TOL,
                         "vs_oracle": STREAM_ORACLE_TOL}}
    for normalize in (True, False):
        key = "znorm" if normalize else "raw"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sp, times = _stream(normalize, ts, reappend=False)
        snap = sp.snapshot()
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        check(counts["natsa_mp"] == 0 and counts["flash_attn"] == 0,
              f"streaming appends launched a kernel: {counts}")
        check(snap.p.shape == (l,) and snap.p.dtype == torch.float64
              and snap.p.device.type == DEVICE
              and bool(torch.isfinite(snap.p).all()), "streaming snapshot")

        batch = matrix_profile(ts, m, exclusion=sp.excl,
                               normalize=normalize, device=DEVICE)
        bp = batch.p.double()
        vs_batch = float(((snap.p - bp).abs()
                          - STREAM_TOL * bp.abs()).max())
        check(vs_batch <= STREAM_TOL, f"{key}: snapshot vs batch {vs_batch}")
        rows = np.sort(np.random.default_rng(SEED + 20).choice(
            l, SAMPLED_ROWS, replace=False))
        d64, _ = ref.profile_rows(torch.from_numpy(ts).to(dev),
                                  torch.from_numpy(ts).to(dev), m, rows,
                                  exclusion=sp.excl, normalize=normalize)
        at = torch.as_tensor(rows, device=dev)
        oracle_err = float((snap.p[at] - d64).abs().max())
        check(oracle_err <= STREAM_ORACLE_TOL,
              f"{key}: snapshot vs f64 oracle {oracle_err}")

        reset_counts()
        rq, q_s = _timed(lambda: sp.query(q))
        q_counts = read_counts()
        ra = ab_join(q, ts, m, normalize=normalize, device=DEVICE)
        query_equal = (torch.equal(rq.p, ra.p.double())
                       and torch.equal(rq.i, ra.i.long()))
        check(query_equal and rq.backend == ra.backend,
              f"{key}: query != ab_join ({rq.backend}, {ra.backend})")

        sp2, times2 = _stream(normalize, ts, reappend=True)
        snap2 = sp2.snapshot()
        reappend_equal = all(torch.equal(getattr(snap, f), getattr(snap2, f))
                             for f in ("p", "i", "left_p", "left_i",
                                       "right_p", "right_i"))
        out[key] = {"counts": counts, "query_counts": q_counts,
                    "query_backend": rq.backend, "e2e_s": e2e,
                    "ms": float(sum(times)), "peak_device_bytes": peak,
                    "append_ms": {"blocks": len(times),
                                  "median": float(np.median(times)),
                                  "max": float(max(times)),
                                  "first": times[0], "last": times[-1]},
                    "single_append_ms_median": float(np.median(
                        times2[-STREAM_REAPPEND:])),
                    "vs_batch_excess": vs_batch,
                    "oracle_rows": SAMPLED_ROWS,
                    "oracle_max_abs_err": oracle_err,
                    "query_ms": 1e3 * q_s, "query_bitwise_ab_join":
                    query_equal, "reappend_bitwise_equal": reappend_equal}
    emit(out)
    return out


_RESULT_FIELDS = ("p", "i", "left_p", "left_i", "right_p", "right_i")


def _results_equal(a, b) -> bool:
    """Two `ProfileResult`s bit for bit: the merged profile and the split."""
    import torch

    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in _RESULT_FIELDS)


def fleet_series() -> np.ndarray:
    """(FLEET_CAP, FLEET_N) arrivals, row r = round r: per tenant a
    period-16 cycle at a random phase plus noise (std 0.3) — periodic
    telemetry — and for the planted tenants a ramp of 0 -> 6 over 32
    samples (a loss-spike-like excursion). Callers take leading rows and
    columns, so a tenant's series is the same in every fleet."""
    rng = np.random.default_rng(SEED + 21)
    t = np.arange(FLEET_CAP)[:, None]
    x = (np.sin(2 * np.pi * t / 16 + rng.uniform(0, 2 * np.pi, FLEET_N))
         + 0.3 * rng.standard_normal((FLEET_CAP, FLEET_N)))
    for tenant, at in FLEET_PLANTED.items():
        x[at:at + FLEET_M, tenant] += np.linspace(0.0, 6.0, FLEET_M)
    return x


def _ingest_rounds(fleet, rows: np.ndarray) -> None:
    """One grouped `ingest` of `rows` (R, n): round r gives tenant t
    rows[r, t]."""
    fleet.ingest(np.tile(np.arange(rows.shape[1]), rows.shape[0]),
                 rows.reshape(-1))


def _fleet_wraparound() -> dict:
    """FLEET_SMALL_N tenants, capacity FLEET_SMALL_CAP, FLEET_SMALL_ARRIVALS
    skewed arrivals (5% NaN) in 8 mixed batches, both modes: every tenant
    bit for bit its epoch replay; z-normalized, the same arrivals in one
    grouped ingest and one at a time give the same bits."""
    from repro_torch.core.fleet import StreamingFleet
    from repro_torch.core.replay import EpochReplay

    rng = np.random.default_rng(SEED + 23)
    n, m, cap = FLEET_SMALL_N, FLEET_M, FLEET_SMALL_CAP
    share = 1.0 / np.arange(1, n + 1)
    tids = rng.choice(n, FLEET_SMALL_ARRIVALS, p=share / share.sum())
    vals = rng.standard_normal(FLEET_SMALL_ARRIVALS)
    vals[rng.random(FLEET_SMALL_ARRIVALS) < 0.05] = np.nan
    out = {"n": n, "capacity": cap, "arrivals": FLEET_SMALL_ARRIVALS,
           "nan_arrivals": int(np.isnan(vals).sum())}

    def fleet(normalize):
        return StreamingFleet(n, m, cap, exclusion=FLEET_EXCL,
                              normalize=normalize, device=DEVICE)

    for normalize in (True, False):
        key = "znorm" if normalize else "raw"
        f = fleet(normalize)
        replays = [EpochReplay(m, cap, FLEET_EXCL, normalize, device=DEVICE)
                   for _ in range(n)]
        for b in range(0, FLEET_SMALL_ARRIVALS, 50):
            f.ingest(tids[b:b + 50], vals[b:b + 50])
        for t, v in zip(tids, vals):
            replays[t].push(v)
        epochs = f.epochs
        check(epochs.max() >= 1, f"{key}: the wraparound case restarted no "
              "tenant")
        check(epochs.tolist() == [r.epochs for r in replays],
              f"{key}: epochs {epochs.tolist()}")
        equal = all(_results_equal(f.snapshot(t), replays[t].sp.snapshot())
                    for t in range(n))
        check(equal, f"{key}: wraparound fleet != its epoch replay")
        out[key] = {"epochs": epochs.tolist(), "replay_bitwise": equal}
        if normalize:
            grouped, single = fleet(True), fleet(True)
            grouped.ingest(tids, vals)
            for t, v in zip(tids, vals):
                single.ingest(t, v)
            same = all(_results_equal(grouped.snapshot(t), single.snapshot(t))
                       and _results_equal(grouped.snapshot(t), f.snapshot(t))
                       for t in range(n))
            check(same, "grouped ingest != one arrival at a time")
            out["grouped_vs_single_bitwise"] = same
    return out


def _fleet_checkpoint(x, big) -> dict:
    """A FLEET_CKPT_N-tenant fleet on the same arrivals as the first
    tenants of `big` (the same bits: a chunk's size changes none), saved,
    restored and rescaled on the card, bit for bit."""
    import shutil

    import torch

    from repro_torch.core.fleet import StreamingFleet

    n, rounds = FLEET_CKPT_N, FLEET_PREFILL + FLEET_TIMED
    fleet = StreamingFleet(n, FLEET_M, FLEET_CAP, exclusion=FLEET_EXCL,
                           device=DEVICE)
    _ingest_rounds(fleet, x[:rounds, :n])
    want = [fleet.snapshot(t) for t in range(n)]
    chunk_equal = all(_results_equal(w, big.snapshot(t))
                      for t, w in enumerate(want))
    check(chunk_equal, "a tenant's bits depend on the fleet's size")
    d = os.path.join(ROOT, "build", "fleet_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    try:
        path, save_s = _timed(lambda: fleet.save(d))
        npz_bytes = os.path.getsize(os.path.join(path, "arrays.npz"))
        (restored, step), restore_s = _timed(
            lambda: StreamingFleet.restore(d, device=DEVICE))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(step == fleet._ingests and restored.device == fleet.device,
          "restore")
    restored_equal = all(_results_equal(restored.snapshot(t), w)
                         for t, w in enumerate(want))
    check(restored_equal, "restored snapshots differ")
    restored.rescale(n + 64)
    grown_equal = all(_results_equal(restored.snapshot(t), w)
                      for t, w in enumerate(want))
    check(grown_equal, "growing changed a surviving tenant")
    restored.ingest(np.full(2 * FLEET_M, n + 1),
                    np.random.default_rng(SEED + 25).standard_normal(
                        2 * FLEET_M))
    check(restored.snapshot(n + 1).p.shape == (FLEET_M + 1,), "new tenant")
    restored.rescale(n // 2)
    shrunk_equal = all(_results_equal(restored.snapshot(t), want[t])
                       for t in range(n // 2))
    check(shrunk_equal and restored.n == n // 2,
          "shrinking changed a surviving tenant")
    torch.cuda.synchronize()
    return {"n": n, "npz_bytes": npz_bytes, "save_s": save_s,
            "restore_s": restore_s, "same_bits_as_fleet_10k": chunk_equal,
            "restored_bitwise": restored_equal,
            "grow_survivors_bitwise": grown_equal,
            "shrink_survivors_bitwise": shrunk_equal}


def _fleet_bf16(x, ref) -> dict:
    """FLEET_BF16_N tenants with a bf16 `wk`, against the same tenants of
    the f64 fleet `ref`, within the reference's analytic budget."""
    import torch

    from repro_torch.core.fleet import StreamingFleet
    from repro_torch.core.precision import PrecisionSpec, profile_tolerance

    n, rounds = FLEET_BF16_N, FLEET_PREFILL + FLEET_TIMED
    fleet = StreamingFleet(n, FLEET_M, FLEET_CAP, exclusion=FLEET_EXCL,
                           precision=PrecisionSpec(stream="bfloat16"),
                           device=DEVICE)
    _, s = _timed(lambda: _ingest_rounds(fleet, x[:rounds, :n]))
    check(fleet._state["wk"].dtype == torch.bfloat16, "bf16 wk")
    got = torch.stack([r.p for r in fleet.snapshot()])
    want = torch.stack([ref.snapshot(t).p for t in range(n)])
    fin = torch.isfinite(got) & torch.isfinite(want)
    check(bool(fin.any()), "no finite entries")
    err = float((got[fin] - want[fin]).abs().max())
    tol = profile_tolerance(PrecisionSpec(stream="bfloat16",
                                          accum="float64"), FLEET_M)
    check(err <= tol, f"bf16 wk fleet vs f64 {err} > {tol}")
    return {"n": n, "max_abs_err": err, "tolerance": tol, "ingest_s": s,
            "wk_bytes": fleet._state["wk"].numel() * 2}


def _round_bytes(fleet) -> int:
    """Bytes one full round must move: every tenant's cached windows,
    norms and masks read once, and the merged and right profiles (the
    fields any column may improve) read once and written once."""
    s = fleet._state

    def nbytes(*fields):
        return sum(s[f].numel() * s[f].element_size() for f in fields)

    return (nbytes("wk", "aux", "ok")
            + 2 * nbytes("prof", "pidx", "rprof", "ridx"))


def phase_fleet():
    """`StreamingFleet` at fleet-10k in both modes (see FLEET_*): the
    prefill in one grouped ingest, 16 timed one-round ingests, sampled
    tenants bit for bit their `StreamingProfile` replay; then the
    wraparound, bf16 and checkpoint cases. Returns (the phase's JSON, the
    raw fleet for `main_monitor`)."""
    import torch

    from repro_torch.core.fleet import StreamingFleet
    from repro_torch.core.streaming import StreamingProfile

    x = fleet_series()
    rounds = FLEET_PREFILL + FLEET_TIMED
    tids = np.arange(FLEET_N)
    sampled = np.sort(np.random.default_rng(SEED + 22).choice(
        FLEET_N, FLEET_REPLAYS, replace=False)).tolist()
    out = {"phase": "main_fleet", "card": torch.cuda.get_device_name(0),
           "n": FLEET_N, "m": FLEET_M, "exclusion": FLEET_EXCL,
           "capacity": FLEET_CAP, "prefill_rounds": FLEET_PREFILL,
           "timed_rounds": FLEET_TIMED,
           "reduced": ("capacity 1024 where TelemetryMonitor keeps "
                       "max_history 8192 (core/monitor.py:41): cut 8x so "
                       "the prefill fits the script's time")}
    fleets = {}
    for normalize in (True, False):
        key = "znorm" if normalize else "raw"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        fleet = StreamingFleet(FLEET_N, FLEET_M, FLEET_CAP,
                               exclusion=FLEET_EXCL, normalize=normalize,
                               device=DEVICE)
        _, prefill_s = _timed(
            lambda: _ingest_rounds(fleet, x[:FLEET_PREFILL]))
        lat = [1e3 * _timed(lambda r=r: fleet.ingest(tids, x[r]))[1]
               for r in range(FLEET_PREFILL, rounds)]
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        check(counts["natsa_mp"] == 0 and counts["flash_attn"] == 0,
              f"fleet ingest launched a kernel: {counts}")
        check(bool((fleet.counts == rounds).all()
                   and (fleet.totals == rounds).all()
                   and (fleet.epochs == 0).all()), f"{key}: counts")
        replay_equal = True
        for t in sampled:
            sp = StreamingProfile(FLEET_M, FLEET_EXCL, normalize=normalize,
                                  device=DEVICE)
            sp.append(x[:rounds, t])
            snap = fleet.snapshot(t)
            check(snap.p.shape == (rounds - FLEET_M + 1,)
                  and snap.p.device.type == DEVICE
                  and bool(torch.isfinite(snap.p).all()),
                  f"{key}: snapshot of tenant {t}")
            replay_equal &= _results_equal(snap, sp.snapshot())
        check(replay_equal, f"{key}: a sampled tenant != its replay")
        med = float(np.median(lat))
        bound_ms = 1e3 * _round_bytes(fleet) / HBM_RATE
        out[key] = {"counts": counts, "prefill_s": prefill_s,
                    "prefill_arrivals_per_s": FLEET_N * FLEET_PREFILL
                    / prefill_s,
                    "round_ms": {"median": med, "max": float(max(lat)),
                                 "all": lat},
                    "arrivals_per_s": FLEET_N / (med / 1e3),
                    "round_bound_ms": bound_ms,
                    "round_share_of_bound": bound_ms / med,
                    "peak_device_bytes": peak,
                    "state_bytes": sum(t.numel() * t.element_size()
                                       for t in fleet._state.values()),
                    "replay_tenants": sampled,
                    "replay_bitwise": replay_equal}
        fleets[key] = fleet
    out["wraparound"] = _fleet_wraparound()
    out["bf16_wk"] = _fleet_bf16(x, fleets["znorm"])
    out["checkpoint"] = _fleet_checkpoint(x, fleets["znorm"])
    emit(out)
    return out, fleets["raw"], x


def _gate_margin(fleet, tenants) -> dict:
    """Each tenant's top-discord z with no gate (untimed): the highest
    among clean tenants must sit below FLEET_ALARM and the lowest planted
    one above it."""
    from repro_torch.core.monitor import FleetMonitor

    top = {a.tenant: a.zscore for a in FleetMonitor(
        fleet, zscore_alarm=-np.inf, top_k=1).scan(tenants=tenants)}
    clean = max(z for t, z in top.items() if t not in FLEET_PLANTED)
    planted = min(top[t] for t in FLEET_PLANTED)
    check(clean < FLEET_ALARM <= planted,
          f"gate {FLEET_ALARM}: clean max z {clean}, planted min z {planted}")
    return {"tenants": len(tenants), "clean_max_zscore": clean,
            "planted_min_zscore": planted}


def phase_monitor(raw_fleet, x) -> dict:
    """`TelemetryMonitor` at its 8192-sample history (raw `scan`, then the
    z-normalized `motif` on the NATSA kernel), and `FleetMonitor` over
    FLEET_SCAN tenants of the raw fleet-10k fleet once filled to capacity:
    exactly the planted tenants alarm, within m of their ramps."""
    import torch

    from repro_torch.core.monitor import FleetMonitor, TelemetryMonitor

    rng = np.random.default_rng(SEED + 24)
    n, m = MONITOR_HISTORY, MONITOR_M
    spike, src, dst = 6000, 2000, 4000
    trace = 2.0 + 0.9 ** np.arange(n) + 0.01 * rng.standard_normal(n)
    trace[spike:spike + m] += np.linspace(0, 2.0, m)     # loss spike
    plant(trace, src, dst, m)
    mon = TelemetryMonitor(window=m, max_history=n, device=DEVICE)
    mon.extend(trace)
    reset_counts()
    hits, scan_s = _timed(lambda: mon.scan(top_k=3))
    scan_counts = read_counts()
    check(bool(hits) and min(abs(h.position - spike) for h in hits) < 24,
          f"telemetry scan missed the spike: {hits}")
    reset_counts()
    pair, motif_s = _timed(mon.motif)
    motif_counts = read_counts()
    check(set(pair) == {src, dst}, f"motif {pair} != ({src}, {dst})")
    check(scan_counts["natsa_mp"] == 0 and motif_counts["natsa_mp"] == 1,
          f"NATSA launches: scan {scan_counts}, motif {motif_counts}")
    out = {"phase": "main_monitor", "card": torch.cuda.get_device_name(0),
           "telemetry": {
               "history": n, "m": m, "spike": spike,
               "hits": [{"position": h.position, "score": h.score,
                         "zscore": h.zscore} for h in hits],
               "motif": list(pair), "planted_pair": [src, dst],
               "scan_ms": 1e3 * scan_s, "motif_ms": 1e3 * motif_s,
               "scan_counts": scan_counts, "motif_counts": motif_counts}}

    rounds = FLEET_PREFILL + FLEET_TIMED
    _, fill_s = _timed(lambda: _ingest_rounds(raw_fleet, x[rounds:]))
    check(bool((raw_fleet.counts == FLEET_CAP).all()
               and (raw_fleet.epochs == 0).all()), "fill to capacity")
    fmon = FleetMonitor(raw_fleet, zscore_alarm=FLEET_ALARM)
    reset_counts()
    alerts, fscan_s = _timed(lambda: fmon.scan(tenants=range(FLEET_SCAN)))
    fcounts = read_counts()
    alarmed = sorted({a.tenant for a in alerts})
    check(alarmed == sorted(FLEET_PLANTED),
          f"alarmed tenants {alarmed} != planted {sorted(FLEET_PLANTED)}")
    offset = {t: min(abs(a.position - at) for a in alerts if a.tenant == t)
              for t, at in FLEET_PLANTED.items()}
    check(max(offset.values()) <= FLEET_M, f"alerts far off: {offset}")
    ms_per_tenant = 1e3 * fscan_s / FLEET_SCAN
    fleet_out = {"tenants_scanned": FLEET_SCAN, "zscore_alarm": FLEET_ALARM,
                 "samples_per_tenant": FLEET_CAP,
                 "fill_rounds": FLEET_CAP - rounds, "fill_s": fill_s,
                 "alerts": [{"tenant": a.tenant, "position": a.position,
                             "zscore": a.zscore} for a in alerts],
                 "offset_from_ramp": offset, "scan_s": fscan_s,
                 "ms_per_tenant": ms_per_tenant, "counts": fcounts}
    whole = ms_per_tenant * FLEET_N / 1e3
    margin_over = range(FLEET_SCAN)
    if whole <= 10.0:
        all_alerts, whole_s = _timed(fmon.scan)
        fleet_out["whole_fleet_s"] = whole_s
        fleet_out["whole_fleet_alarmed_tenants"] = len(
            {a.tenant for a in all_alerts})
        margin_over = range(FLEET_N)
    else:
        fleet_out["whole_fleet_s_extrapolated"] = whole
    fleet_out["gate_margin"] = _gate_margin(raw_fleet, margin_over)
    out["fleet"] = fleet_out
    emit(out)
    return out


def _pair_union(q, series, m, sids=None) -> tuple:
    """The per-pair loop the service must equal bit for bit: `ab_join` of
    q against each series (ascending sid) on the card, reduced on the host
    by an elementwise min -> (dist, series, position)."""
    from repro_torch.core import ab_join

    lq = q.shape[0] - m + 1
    best_d = np.full(lq, np.inf, np.float32)
    best_s = np.full(lq, -1, np.int64)
    best_i = np.full(lq, -1, np.int64)
    for sid in (range(len(series)) if sids is None else sids):
        r = ab_join(q, series[sid], m, device=DEVICE)
        d, i = r.p.cpu().numpy(), r.i.cpu().numpy()
        take = d < best_d
        best_d = np.where(take, d, best_d)
        best_s = np.where(take, sid, best_s)
        best_i = np.where(take, i, best_i)
    return best_d, best_s, best_i


def _answer_equals(a, union) -> bool:
    d, s, i = union
    return bool(np.array_equal(a.result.p.numpy(), d)
                and np.array_equal(a.series, s)
                and np.array_equal(a.result.i.numpy(), i))


def _topk_pair_union(q, series, m, k) -> tuple:
    """k > 1: a stable sort over every series' per-pair `ab_join` top-k
    (ascending sid) -> (dist, position, series), each (l_q, k)."""
    from repro_torch.core import ab_join

    cands = []
    for sid, s in enumerate(series):
        r = ab_join(q, s, m, k=k, device=DEVICE)
        check(r.backend == "rowstream", f"per-pair top-k on {r.backend}")
        cands.append((r.topk_p.cpu().numpy(), r.topk_i.cpu().numpy(),
                      np.full(tuple(r.topk_i.shape), sid)))
    d, i, s = (np.concatenate(c, axis=1) for c in zip(*cands))
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return tuple(np.take_along_axis(x, order, 1) for x in (d, i, s))


def _union_oracle(answer, q, series, m, rows) -> dict:
    """The served profile at `rows` against the f64 exact union over every
    corpus series, on the card: correlations within TOL_ORACLE; where the
    winning (series, position) differs, the reported correlations must be
    within TOL_ORACLE (ties) and the served pick's own exact correlation
    within TOL_ORACLE of the oracle's (exact pairs)."""
    import torch

    from repro_torch.core import ref
    from repro_torch.core.zstats import dist_to_corr

    dev = torch.device(DEVICE)
    qt = torch.from_numpy(q).to(dev)
    best = None
    for sid, s in enumerate(series):
        d, j = ref.profile_rows(qt, torch.from_numpy(s).to(dev), m, rows)
        if best is None:
            best = [d, torch.zeros_like(j), j]
        else:
            take = d < best[0]
            best = [torch.where(take, d, best[0]),
                    torch.where(take, sid, best[1]),
                    torch.where(take, j, best[2])]
    at = torch.as_tensor(rows)
    got_c = dist_to_corr(answer.result.p[at].double().to(dev), m)
    got_s = torch.from_numpy(answer.series)[at].to(dev).long()
    got_j = answer.result.i[at].to(dev).long()
    want_c = dist_to_corr(best[0], m)
    check(bool(torch.isfinite(got_c).all()), "served rows non-finite")
    err = (got_c - want_c).abs()
    differ = (got_s != best[1]) | (got_j != best[2])
    exact_viol = 0
    for r in differ.nonzero().flatten().tolist():
        own = _exact_corr(q, series[int(got_s[r])], m,
                          torch.as_tensor([int(rows[r])], device=dev),
                          got_j[r:r + 1])
        exact_viol += int(float((own - want_c[r]).abs()) >= TOL_ORACLE)
    return {"rows": len(rows), "max_corr_err": float(err.max()),
            "pick_mismatch": int(differ.sum()),
            "tie_violations": int((differ & (err >= TOL_ORACLE)).sum()),
            "exact_pair_violations": exact_viol}


def _serve_parts(corpus, queries, m) -> dict:
    """The k = 1 serve path's parts timed apart, on the same corpus and
    queries: the queries' host stream prep, the host assembly of every
    pair (f64 seed dots, f32 emission, upload), and the NATSA kernel alone
    over every pair (CUDA events, on inputs padded beforehand)."""
    from repro_torch.core.zstats import compute_stats_host
    from repro_torch.kernels import DEFAULT_DT, DEFAULT_IT, natsa_mp, ops

    parts, prep_s = _timed(lambda: [
        compute_stats_host(q, m, min_subsequences=1,
                           return_centered_windows=True, device=DEVICE)
        for q in queries])
    lq = queries[0].shape[0] - m + 1
    plans = [(g, corpus.plan_for(g, lq)) for g in corpus.groups()]
    pairs, assembly_s = _timed(lambda: [
        p for g, plan in plans for p in corpus.assemble_pairs(g, parts,
                                                              plan)])
    launches = []
    for cross in pairs:
        (s0, s1), = ops.ab_spans(cross.l_a, cross.l_b, 0)
        *args, _, _, jpad = ops._pad_streams_ab(cross, DEFAULT_IT,
                                                DEFAULT_DT, s0, s1)
        launches.append((args, dict(k_start=s0, k_end=s1, l_i=cross.l_a,
                                    l_j=cross.l_b, jpad=jpad)))
    del pairs

    def every_pair():
        for args, kw in launches:
            natsa_mp.rowmax_profile_ab(*args, **kw)

    every_pair()                                       # warm-up
    kernel_ms = cuda_ms(every_pair, 1)
    return {"query_prep_s": prep_s, "assembly_s": assembly_s,
            "kernel_ms": kernel_ms,
            "kernel_ms_per_pair": kernel_ms / len(launches),
            "timed_pairs": len(launches)}


def _serve_faults(series, queries, m) -> dict:
    """A seeded `FaultInjector` over the k = 4 cell's corpus at k = 1:
    shard 0 crashes at tick 0 (query 0: degraded, coverage 0.5, bit for bit
    the union over shard 1's series), tick 2 fails once and retries (query
    1: ok); a lapsed deadline answers expired."""
    from repro_torch.core.faults import FaultInjector, FaultPolicy
    from repro_torch.serve import ProfileService, ShardedCorpus

    inj = FaultInjector.seeded(SERVE_FAULT_SEED, n_rounds=4, n_workers=2,
                               p_worker_crash=0.3, p_round_failure=0.3,
                               max_round_failures=2)
    check(inj.crashed_workers(0) == {0} and inj.round_failures == {2: 1}
          and not any(inj.crashed_workers(t) for t in (1, 2, 3)),
          f"fault schedule of seed {SERVE_FAULT_SEED}: {inj}")
    corpus = ShardedCorpus(series, m, devices=[DEVICE],
                           n_shards=SERVE_SHARDS)
    sleeps = []
    svc = ProfileService(corpus, injector=inj,
                         policy=FaultPolicy(sleep=sleeps.append))
    [crashed] = svc.serve(queries[:1])
    survivors = [sid for sid in range(len(series))
                 if corpus.shard_of(sid) != 0]
    crashed_equal = _answer_equals(crashed, _pair_union(
        queries[0], series, m, sids=survivors))
    check(crashed.status == "degraded" and crashed.coverage == 0.5
          and crashed.failed_shards == (0,) and crashed_equal,
          f"crashed shard: {crashed.status} {crashed.coverage} "
          f"{crashed.failed_shards} bitwise {crashed_equal}")
    [retried] = svc.serve(queries[1:2])
    retried_equal = _answer_equals(retried, _pair_union(queries[1], series,
                                                        m))
    check(retried.status == "ok" and retried.coverage == 1.0
          and len(sleeps) == 1 and retried_equal,
          f"transient failure: {retried.status} sleeps {sleeps} "
          f"bitwise {retried_equal}")
    qid = svc.submit(queries[0], deadline=0.0)
    time.sleep(0.005)
    expired = {a.qid: a for a in svc.step() + svc.drain()}[qid]
    check(expired.status == "expired" and expired.coverage == 0.0
          and bool(expired.result.p.isinf().all()),
          f"lapsed deadline: {expired.status}")
    return {"seed": SERVE_FAULT_SEED, "crashed": {
        "status": crashed.status, "coverage": crashed.coverage,
        "failed_shards": list(crashed.failed_shards),
        "bitwise_survivor_union": crashed_equal},
        "retried": {"status": retried.status, "backoff_s": sleeps,
                    "bitwise_pair_union": retried_equal},
        "expired": expired.status, "stats": dataclasses.asdict(svc.stats)}


def phase_serve() -> dict:
    """`ProfileService` over a resident `ShardedCorpus` on the card. k = 1
    at full size (64 series of 65536, m = 128, 2 logical shards, 16
    queries of 4096 samples): one NATSA launch per (query, series) pair,
    the planted window found, 4 answers bit for bit the per-pair `ab_join`
    loop, 64 sampled rows of 2 answers against the f64 exact union; the
    parts timed apart; the kernel at the serve shape against its plain
    version. k = 4 on the per-pair rowstream plan bit for bit the per-pair
    top-k union. A seeded fault run."""
    import torch

    from repro_torch.core.zstats import dist_to_corr
    from repro_torch.serve import ProfileService, ShardedCorpus

    rng = np.random.default_rng(SEED + 26)
    m = SERVE_M
    series = [walk(rng, SERVE_N) for _ in range(SERVE_SERIES)]
    queries = [walk(rng, SERVE_QUERY_N) for _ in range(SERVE_QUERIES)]
    p_sid, p_at, q_at = SERVE_PLANT
    plant(queries[0], p_at, q_at, m, other=series[p_sid])
    lq, l_ref = SERVE_QUERY_N - m + 1, SERVE_N - m + 1

    torch.cuda.reset_peak_memory_stats()
    corpus, load_s = _timed(lambda: ShardedCorpus(
        series, m, devices=[DEVICE], n_shards=SERVE_SHARDS))
    svc = ProfileService(corpus, max_pending=SERVE_QUERIES,
                         max_batch=SERVE_QUERIES)
    reset_counts()
    answers, serve_s = _timed(lambda: svc.serve(queries))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    pairs = SERVE_QUERIES * SERVE_SERIES
    check(counts["natsa_mp"] == pairs and counts["flash_attn"] == 0,
          f"serve launches {counts}, want {pairs} NATSA")
    for a in answers:
        check(a.status == "ok" and a.coverage == 1.0
              and tuple(a.result.p.shape) == (lq,)
              and a.result.p.dtype == torch.float32
              and bool(torch.isfinite(a.result.p).all())
              and a.series.shape == (lq,), f"answer {a.qid}: {a.status}")
    a0 = answers[0]
    found = (int(a0.series[q_at]), int(a0.result.i[q_at]))
    planted_corr = float(dist_to_corr(a0.result.p[q_at].double(), m))
    check(found == (p_sid, p_at) and planted_corr >= 1 - TOL_ORACLE,
          f"planted window: series/position {found} != {(p_sid, p_at)}, "
          f"corr {planted_corr}")
    bitwise = [_answer_equals(a, _pair_union(q, series, m))
               for q, a in zip(queries[:SERVE_BITWISE],
                               answers[:SERVE_BITWISE])]
    check(all(bitwise), f"answers vs the per-pair ab_join loop: {bitwise}")
    orng = np.random.default_rng(SEED + 27)
    oracle = [_union_oracle(a, q, series, m, np.sort(orng.choice(
        lq, SAMPLED_ROWS, replace=False)))
        for q, a in zip(queries[:SERVE_ORACLE], answers[:SERVE_ORACLE])]
    for o in oracle:
        check(o["max_corr_err"] <= TOL_ORACLE and o["tie_violations"] == 0
              and o["exact_pair_violations"] == 0,
              f"served rows vs the f64 exact union: {o}")

    parts = _serve_parts(corpus, queries, m)
    (args, kw), = _ab_cases(queries[0], series[p_sid], m, 0, device=DEVICE)
    kt = _time_kernel(args, kw, float(lq) * l_ref, queries[0], series[p_sid],
                      m)
    out = {"phase": "main_serve", "card": torch.cuda.get_device_name(0),
           "series": SERVE_SERIES, "n": SERVE_N, "m": m,
           "shards": corpus.n_shards, "queries": SERVE_QUERIES,
           "query_n": SERVE_QUERY_N, "pairs": pairs, "reduced": [],
           "shape_source": "series and queries: benchmarks/run.py:724-740; "
                           "n and query_n: chosen here, unsourced",
           "launches": counts["natsa_mp"], "counts": counts,
           "load_s": load_s, "serve_s": serve_s, "qps": SERVE_QUERIES
           / serve_s, **parts, "peak_device_bytes": peak,
           "planted": {"series": p_sid, "position": p_at, "row": q_at,
                       "corr": planted_corr},
           "bitwise_pair_loop": bitwise, "union_oracle": oracle,
           "bound_ms_all_pairs": kt["bound_ms"] * pairs,
           "kernel": {f: kt[f] for f in (
               "ms", "plain_ms", "bound_ms", "bound_by", "cells",
               "share_of_bound", "bitwise_repeat", "full_size_vs_plain")}}
    del corpus, svc, answers

    krng = np.random.default_rng(SEED + 28)
    series4 = [walk(krng, SERVE_K_N) for _ in range(SERVE_K_SERIES)]
    queries4 = [walk(krng, SERVE_K_QUERY_N) for _ in range(SERVE_K_QUERIES)]
    svc4 = ProfileService(ShardedCorpus(series4, m, devices=[DEVICE],
                                        n_shards=SERVE_SHARDS))
    reset_counts()
    answers4, k4_s = _timed(lambda: svc4.serve(queries4, k=SERVE_K))
    counts4 = read_counts()
    check(counts4["natsa_mp"] == 0 and counts4["flash_attn"] == 0,
          f"k = {SERVE_K} serve launched a kernel: {counts4}")
    k4_equal = []
    for q, a in zip(queries4, answers4):
        d, i, s = _topk_pair_union(q, series4, m, SERVE_K)
        k4_equal.append(bool(
            a.status == "ok"
            and np.array_equal(a.result.topk_p.numpy(), d)
            and np.array_equal(a.result.topk_i.numpy(), i)
            and np.array_equal(a.series, s)))
    check(all(k4_equal), f"k = {SERVE_K} answers vs the per-pair union: "
          f"{k4_equal}")
    group = svc4.corpus.groups()[0]
    backend4 = svc4.corpus.plan_for(group, SERVE_K_QUERY_N - m + 1,
                                    k=SERVE_K).backend
    check(backend4 == "rowstream", f"k = {SERVE_K} plan on {backend4}")
    out["k4"] = {"series": SERVE_K_SERIES, "n": SERVE_K_N,
                 "queries": SERVE_K_QUERIES, "query_n": SERVE_K_QUERY_N,
                 "k": SERVE_K, "backend": backend4, "serve_s": k4_s,
                 "counts": counts4, "bitwise_pair_union": k4_equal}
    out["faults"] = _serve_faults(series4, queries4, m)
    emit(out)
    return out


def _load_example(name: str):
    """`examples/<name>.py` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def phase_serve_example() -> dict:
    """`examples/serve_profiles_torch.py`'s `main()` on the card: the probe
    names the planted series 2 near position 300, a lapsed query answers
    expired, the ninth pending query is rejected; one NATSA launch per
    (query, series) pair of the 12 answered queries against 6 series."""
    example = _load_example("serve_profiles_torch")
    reset_counts()
    found, secs = _timed(example.main)
    counts = read_counts()
    series, pos = found["probe"]
    check(series == 2 and abs(pos - 300) < 16
          and found["expired"] == ["expired", 0.0, True]
          and found["rejected"] == 1, f"serve example: {found}")
    check(counts["natsa_mp"] == 12 * 6 and counts["flash_attn"] == 0,
          f"serve example launches {counts}, want 72 NATSA")
    out = {"phase": "serve_example", "s": secs, "counts": counts, **found}
    emit(out)
    return out


# the launches each example twin makes, read off the code before its first
# run on the card: quickstart's k = 4 call plans the band engine and its
# k = 1 `natsa_matrix_profile` launches once; ab_query's k = 3 `ab_join`
# and `batch_profile` run the engine, `natsa_ab_join` (no exclusion, one
# span) and each of the two z-normalized streaming queries launch once
# (appends run the f64 block kernels); anomaly_monitor's raw profile and
# `scan` run the raw engine, `motif` a z-normalized self-join; train_lm's
# model (f32, head dim 64: the `fma` route) calls flash once per layer in
# the forward of each step (one microbatch, no remat): 6 layers x (150
# steps + 10 after the restart)
EXAMPLE_LAUNCHES = {
    "quickstart_torch": {"natsa_mp": 1, "flash_attn": 0},
    "ab_query_torch": {"natsa_mp": 3, "flash_attn": 0},
    "anomaly_monitor_torch": {"natsa_mp": 1, "flash_attn": 0},
    "train_lm_torch": {"natsa_mp": 0, "flash_attn": 6 * (150 + 10)},
}


def phase_examples() -> dict:
    """The four example twins' `main()` on the card at the reference's
    sizes: each passes its own assertions (planted motif, discord, query
    match, flagged series, alarms; train_lm's 150 steps to a loss under
    6.5, then its restart from the written checkpoint for 10 more), with
    exactly the launches of EXAMPLE_LAUNCHES, every flash launch on `fma`
    (the twins run in f32). The checkpoints a twin reports are removed."""
    import shutil

    out, counts = {"phase": "examples"}, {"natsa_mp": 0, "flash_attn": 0}
    for name, want in EXAMPLE_LAUNCHES.items():
        example = _load_example(name)
        reset_counts()
        found, secs = _timed(example.main)
        shutil.rmtree(found.get("ckpt_dir", ""), ignore_errors=True)
        got = read_counts()
        check({k: got[k] for k in want} == want
              and got["flash_attn_routes"] == {"wgmma": 0,
                                               "fma": want["flash_attn"]},
              f"{name} launches {got}, want {want}, all flash on fma")
        for k in counts:
            counts[k] += got[k]
        out[name] = {"s": secs, "counts": got,
                     **{k: v for k, v in found.items()
                        if isinstance(v, (int, float, str, list, tuple))}}
    out["counts"] = counts
    emit(out)
    return out


def _anytime_rounds(sch, ckpt_path=None) -> dict:
    """Step every round of `sch`, each on the host clock to the card's end
    of it; checkpoint after round ANYTIME_CKPT_ROUND when a path is given.
    `fraction_done` must rise strictly to 1.0."""
    round_ms, fracs, save_s = [], [], None
    for r in range(sch.plan.n_rounds):
        st, secs = _timed(sch.step_round)
        round_ms.append(1e3 * secs)
        fracs.append(st.fraction_done)
        if ckpt_path is not None and r + 1 == ANYTIME_CKPT_ROUND:
            t0 = time.perf_counter()
            sch.checkpoint(ckpt_path)
            save_s = time.perf_counter() - t0
    check(all(b > a for a, b in zip(fracs, fracs[1:])) and fracs[-1] == 1.0,
          f"fraction_done must rise strictly to 1.0: {fracs}")
    return {"round_ms": round_ms, "fraction_done": fracs, "save_s": save_s}


def _chunk_case(sch, k0: int, k1: int):
    """The kernel inputs of one chunk, padded as `ops.rowmax_chunk` /
    `ops.ab_rowmax_chunk` pad them, and its swept cells."""
    from repro_torch.core import partition
    from repro_torch.kernels import ops

    it, dt = sch.sweep_plan.it, sch.sweep_plan.dt
    if not sch.ab:
        l = sch.l
        df, dg, invn, cov0p, n_rows, _, _ = ops._pad_streams(
            sch.stats, it, dt, k0, k1)
        rows = n_rows * it
        return ((df[:rows], dg[:rows], invn[:rows], df, dg, invn, cov0p),
                dict(k_start=k0, k_end=k1, l_i=l, l_j=l, jpad=0),
                partition.range_work(l, (k0, k1)))
    *args, _, _, jpad = ops._pad_streams_ab(sch.cross, it, dt, k0, k1)
    return (tuple(args), dict(k_start=k0, k_end=k1, l_i=sch.l, l_j=sch.l_b,
                              jpad=jpad),
            partition.range_work_ab(sch.l, sch.l_b, (k0, k1)))


def _anytime_chunks(sch, ts_rows, ts_cols, m) -> dict:
    """Each non-empty chunk through the kernel against the plain version
    on the same inputs (the full-size rule: TOL_ORACLE, 0 tie and 0
    exact-pair violations), its kernel ms (CUDA events, after the compared
    launch) and its bound."""
    from repro_torch.kernels import natsa_mp

    ms, bound, worst = [], [], {"max_abs_err": 0.0, "idx_mismatch": 0,
                                "tie_violations": 0,
                                "exact_pair_violations": 0}
    plain_ms = 0.0
    for k0, k1 in sch.plan.chunks:
        if k1 <= k0:
            continue
        args, kw, cells = _chunk_case(sch, k0, k1)
        kern = natsa_mp.rowmax_profile_ab(*args, **kw)
        ms.append(cuda_ms(lambda: natsa_mp.rowmax_profile_ab(*args, **kw), 1))
        box = []
        plain_ms += cuda_ms(lambda: box.append(
            natsa_mp.rowmax_profile_ab_plain(*args, **kw)), 1)
        res = compare_full_size(kern, box[0], ts_rows, ts_cols, m, kw["jpad"])
        check(res["max_abs_err"] <= TOL_ORACLE and res["tie_violations"] == 0
              and res["exact_pair_violations"] == 0,
              f"chunk [{k0}, {k1}) kernel vs plain {res}")
        worst = {f: max(worst[f], res[f]) if f == "max_abs_err"
                 else worst[f] + res[f] for f in worst}
        bound.append(_bound(args, kw, cells)["bound_ms"])
        del kern, box
    return {"chunks": len(ms), "chunk_ms": ms, "chunk_ms_sum": sum(ms),
            "chunk_ms_max": max(ms), "plain_ms_sum": plain_ms,
            "bound_ms_sum": sum(bound), "vs_plain": worst}


def _vs_one_launch(got, one, ts_rows, ts_cols, m) -> dict:
    """A chunked (corr, idx) side against one launch's: the correlations
    must be equal bit for bit; indices may differ only at an exact tie
    (equal f32 values), counted, and both picks' f64 correlations must lie
    within TOL_ORACLE."""
    import torch

    gc, gi = got
    oc, oi = one
    check(torch.equal(gc, oc), "chunked correlations differ from one "
          f"launch's: max |d| {float((gc - oc).abs().max())}")
    at = ((gi != oi) & (gi >= 0) & (oi >= 0)).nonzero().flatten()
    e_got = _exact_corr(ts_rows, ts_cols, m, at, gi[at])
    e_one = _exact_corr(ts_rows, ts_cols, m, at, oi[at])
    bad = int(((e_got - e_one).abs() >= TOL_ORACLE).sum())
    check(bad == 0 and int((gi != oi).sum()) == len(at),
          f"{bad} index mismatches off ties")
    return {"corr_bitwise": True, "index_ties": len(at)}


def _supervised(mk, clean, fields, path) -> dict:
    """A fresh scheduler under the seeded fault schedule, supervised with a
    checkpoint every round: bit for bit the clean run's `fields`."""
    import torch

    from repro_torch.core.faults import FaultInjector, FaultPolicy

    sch = mk()
    inj = FaultInjector.seeded(ANYTIME_FAULT_SEED, **ANYTIME_FAULTS)
    res, secs = _timed(lambda: sch.run_supervised(
        FaultPolicy(checkpoint_every=1, worker_failure_threshold=3,
                    sleep=lambda _s: None),
        checkpoint_path=path, injector=inj))
    rep = dataclasses.asdict(sch.supervised_report)
    rep["worker_failures"] = sorted(rep["worker_failures"].items())
    equal = all(torch.equal(getattr(res, f), getattr(clean, f))
                for f in fields)
    check(equal and not rep["degraded"] and rep["fraction_done"] == 1.0,
          f"supervised run vs the clean run: equal={equal}, report {rep}")
    check(rep["retries"] > 0 and rep["checkpoint_failures"] > 0
          and rep["checkpoints_corrupted"] > 0 and rep["worker_failures"]
          and rep["excluded_workers"], f"schedule without its faults: {rep}")
    return {"bitwise_clean": equal, "s": secs, "report": rep}


def _state_tensors(st) -> list:
    sides = [st.profile] + ([st.profile_b] if st.profile_b is not None
                            else [])
    return [t for side in sides for t in (side.corr, side.index)]


def _group_rounds(mk_group, mk_plain, ckpt_path=None) -> tuple:
    """The anytime scheduler through a one-rank NCCL group: its counts over
    every round (a checkpoint after ANYTIME_CKPT_ROUND when a path is
    given), then the one-process [DEVICE] scheduler at the same plan, each
    round's states, done bitmap and `fraction_done` bit for bit the
    group's; `round_ms` of both (host clock + synchronize). Returns (the
    group's scheduler, the record)."""
    import torch

    grp, setup_s = _timed(mk_group)
    plain = mk_plain()
    check(dataclasses.astuple(grp.plan) == dataclasses.astuple(plain.plan),
          "group and one-process plans differ")
    states, g_ms, save_s = [], [], None
    reset_counts()
    for r in range(grp.plan.n_rounds):
        st, secs = _timed(grp.step_round)
        states.append(st)
        g_ms.append(1e3 * secs)
        if ckpt_path is not None and r + 1 == ANYTIME_CKPT_ROUND:
            save_s = _timed(lambda: grp.checkpoint(ckpt_path))[1]
    counts = read_counts()
    p_ms, same = [], True
    for g in states:
        st, secs = _timed(plain.step_round)
        p_ms.append(1e3 * secs)
        same = (same and np.array_equal(st.done, g.done)
                and st.fraction_done == g.fraction_done
                and all(torch.equal(a, b) for a, b in
                        zip(_state_tensors(st), _state_tensors(g))))
    check(same, "group rounds differ from the one-process rounds")
    check(counts["flash_attn"] == 0, f"group rounds launched flash {counts}")
    del states
    return grp, {"backend": torch.distributed.get_backend(),
                 "ranks": grp.slots, "chunks": len(grp.plan.chunks),
                 "rounds": grp.plan.n_rounds, "setup_s": setup_s,
                 "launches": counts["natsa_mp"], "counts": counts,
                 "bitwise_one_process": same, "save_s": save_s,
                 "round_ms": g_ms, "plain_round_ms": p_ms,
                 "round_ms_median": float(np.median(g_ms)),
                 "plain_round_ms_median": float(np.median(p_ms)),
                 "rounds_s": sum(g_ms) / 1e3, "plain_rounds_s": sum(p_ms) / 1e3}


def phase_anytime() -> dict:
    """The anytime scheduler on the card, 8 workers x 8 chunks: the
    ecg-256k self-join (a planted pair, checkpoint after round 4 resumed on
    4 workers, a seeded supervised run) and the epilepsy-128k AB join, each
    non-empty k = 1 chunk one NATSA launch; every chunk against the plain
    version, the chunked profiles bit for bit one launch's correlations;
    k = 4 at bench-16k on the band engine's top-k chunks, no NATSA launch,
    against its f64 exact top-k and bit for bit under supervision. Each
    cell also runs through a one-rank NCCL group, 1 worker x 64 chunks
    (`group`, `_group_rounds`): every round bit for bit the one-process
    scheduler's at that plan, the chunked correlations bit for bit one
    launch's, and the self-join group's checkpoint after round 4 resumed
    by the one-process 8-worker scheduler to the clean run's bits."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core.matrix_profile import (ProfileState,
                                                 default_exclusion)
    from repro_torch.core.scheduler import AnytimeScheduler
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_worker_mesh

    tmp = tempfile.mkdtemp(prefix="anytime_")
    out = {"phase": "main_anytime", "card": torch.cuda.get_device_name(0),
           "workers": ANYTIME_WORKERS, "chunks_per_worker": ANYTIME_CPW}
    try:
        # -- ecg-256k self-join ----------------------------------------
        rng = np.random.default_rng(SEED + 30)
        n, m = SELF_N, SELF_M
        pa, pb = n // 5, (3 * n) // 5 + 17
        ts = plant(walk(rng, n), pa, pb, m)
        check(ANYTIME_EXCL == default_exclusion(m), "ecg-256k exclusion")

        def mk(workers=ANYTIME_WORKERS):
            return AnytimeScheduler(ts, m, [DEVICE] * workers,
                                    chunks_per_worker=ANYTIME_CPW,
                                    exclusion=ANYTIME_EXCL)

        sch, setup_s = _timed(mk)
        live = sum(k1 > k0 for k0, k1 in sch.plan.chunks)
        ckpt = os.path.join(tmp, "self.npz")
        reset_counts()
        rounds = _anytime_rounds(sch, ckpt)
        counts = read_counts()
        check(counts["natsa_mp"] == live == ANYTIME_WORKERS * ANYTIME_CPW
              and counts["flash_attn"] == 0,
              f"anytime self-join launches {counts}, want {live} NATSA")
        res = sch.result()
        l = sch.l
        check(res.p.shape == (l,) and res.p.device.type == DEVICE
              and bool(torch.isfinite(res.p).all()), "anytime result")
        found = (int(res.i[pa]), int(res.i[pb]))
        check(found == (pb, pa), f"planted pair ({pa},{pb}) -> {found}")
        rows = np.sort(np.random.default_rng(SEED + 31).choice(
            l, SAMPLED_ROWS, replace=False))
        oracle = _oracle_rows(res.p, ts, ts, m, rows, ANYTIME_EXCL)
        check(oracle <= TOL_ORACLE, f"anytime oracle {oracle}")
        cr, ir, cc, ic = ops.rowmax_from_stats(sch.stats, excl=ANYTIME_EXCL)
        one = ProfileState(cr, ir).merge(ProfileState(cc, ic))
        vs_one = _vs_one_launch((sch.state.profile.corr,
                                 sch.state.profile.index),
                                (one.corr, one.index), ts, ts, m)
        chunks = _anytime_chunks(sch, ts, ts, m)
        fresh = mk(ANYTIME_RESUME_WORKERS)
        t0 = time.perf_counter()
        fresh.resume(ckpt)
        restore_s = time.perf_counter() - t0
        before = read_counts()["natsa_mp"]
        fresh.run()
        resumed = {
            "workers": ANYTIME_RESUME_WORKERS, "save_s": rounds.pop("save_s"),
            "restore_s": restore_s, "npz_bytes": os.path.getsize(ckpt),
            "launches": read_counts()["natsa_mp"] - before,
            "bitwise_clean": all(torch.equal(getattr(fresh.result(), f),
                                             getattr(res, f))
                                 for f in ("p", "i"))}
        check(resumed["bitwise_clean"], "resumed run differs from the clean")
        sup = _supervised(mk, res, ("p", "i"), os.path.join(tmp, "sup.npz"))

        # -- the same self-join through a one-rank NCCL group ---------
        mesh = make_worker_mesh()

        def mk_on(devices):
            return lambda: AnytimeScheduler(
                ts, m, devices, chunks_per_worker=ANYTIME_GROUP_CPW,
                exclusion=ANYTIME_EXCL)

        gck = os.path.join(tmp, "group.npz")
        grp, group = _group_rounds(mk_on(mesh), mk_on([DEVICE]), gck)
        check(group["launches"] == live and group["rounds"] == live
              and sorted(grp.plan.chunks) == sorted(sch.plan.chunks),
              f"group self-join: {group['launches']} launches over "
              f"{group['rounds']} rounds, want {live} of the 8 x 8 chunks")
        group["vs_one_launch"] = _vs_one_launch(
            (grp.state.profile.corr, grp.state.profile.index),
            (one.corr, one.index), ts, ts, m)
        gres = grp.result()
        resumed8 = mk()
        resumed8.resume(gck)
        resumed8.run()
        group["resumed_8_workers_bitwise_clean"] = all(
            torch.equal(getattr(resumed8.result(), f), getattr(gres, f))
            and torch.equal(getattr(gres, f), getattr(res, f))
            for f in ("p", "i"))
        check(group["resumed_8_workers_bitwise_clean"],
              "the group's checkpoint resumed on 8 workers, or the group's "
              "run, differs from the clean run")
        del grp, gres, resumed8
        out["self"] = {"n": n, "m": m, "exclusion": ANYTIME_EXCL, "l": l,
                       "setup_s": setup_s, "launches": counts["natsa_mp"],
                       "counts": counts, **rounds,
                       "rounds_s": sum(rounds["round_ms"]) / 1e3,
                       "motif": [pa, pb], "oracle_rows": SAMPLED_ROWS,
                       "oracle_max_corr_err": oracle,
                       "vs_one_launch": vs_one, **chunks,
                       "resume": resumed, "supervised": sup,
                       "group": group}
        del sch, fresh, one, res

        # -- epilepsy-128k AB join, unswapped -------------------------
        from repro_torch.core import ab_join

        rng = np.random.default_rng(SEED + 32)
        a, b = walk(rng, AB_NA), walk(rng, AB_NB)
        m = AB_M
        sch = AnytimeScheduler(a, m, [DEVICE] * ANYTIME_WORKERS, ts_b=b,
                               chunks_per_worker=ANYTIME_CPW)
        live = sum(k1 > k0 for k0, k1 in sch.plan.chunks)
        reset_counts()
        rounds = _anytime_rounds(sch)
        counts = read_counts()
        check(counts["natsa_mp"] == live and counts["flash_attn"] == 0,
              f"anytime AB launches {counts}, want {live} NATSA")
        ca, ia, cb, ib = ops.ab_rowmax_from_stats(sch.cross)
        vs_one = {"a": _vs_one_launch((sch.state.profile.corr,
                                       sch.state.profile.index), (ca, ia),
                                      a, b, m),
                  "b": _vs_one_launch((sch.state.profile_b.corr,
                                       sch.state.profile_b.index), (cb, ib),
                                      b, a, m)}
        res = sch.result()
        ref = ab_join(a, b, m, return_b=True, device=DEVICE)
        vs_ab_join = compare_full_size(_sides(res, "ab", m),
                                       _sides(ref, "ab", m), a, b, m, 0)
        check(vs_ab_join["max_abs_err"] <= TOL_ORACLE
              and vs_ab_join["tie_violations"] == 0
              and vs_ab_join["exact_pair_violations"] == 0,
              f"anytime AB vs ab_join {vs_ab_join}")
        chunks = _anytime_chunks(sch, a, b, m)

        def mk_ab(devices):
            return lambda: AnytimeScheduler(
                a, m, devices, ts_b=b, chunks_per_worker=ANYTIME_GROUP_CPW)

        grp, group = _group_rounds(mk_ab(mesh), mk_ab([DEVICE]))
        check(group["launches"] == live,
              f"group AB: {group['launches']} launches, want {live}")
        group["vs_one_launch"] = {
            "a": _vs_one_launch((grp.state.profile.corr,
                                 grp.state.profile.index), (ca, ia), a, b, m),
            "b": _vs_one_launch((grp.state.profile_b.corr,
                                 grp.state.profile_b.index), (cb, ib), b, a,
                                m)}
        del grp
        out["ab"] = {"n_a": AB_NA, "n_b": AB_NB, "m": m, "exclusion": 0,
                     "launches": counts["natsa_mp"], "counts": counts,
                     **{f: v for f, v in rounds.items() if f != "save_s"},
                     "rounds_s": sum(rounds["round_ms"]) / 1e3,
                     "vs_one_launch": vs_one, "vs_ab_join": vs_ab_join,
                     **chunks, "group": group}
        del sch, ref, res

        # -- k = 4 at bench-16k on the engine's top-k chunks ----------
        rng = np.random.default_rng(SEED + 33)
        n, m, k = ANYTIME_K_N, ANYTIME_K_M, ANYTIME_K
        ts = walk(rng, n)

        def mk4():
            return AnytimeScheduler(ts, m, [DEVICE] * ANYTIME_WORKERS, k=k,
                                    chunks_per_worker=ANYTIME_CPW)

        sch = mk4()
        reset_counts()
        rounds = _anytime_rounds(sch)
        counts = read_counts()
        check(counts["natsa_mp"] == 0 and counts["flash_attn"] == 0,
              f"anytime top-k launched a kernel: {counts}")
        res = sch.result()
        rows = np.sort(np.random.default_rng(SEED + 34).choice(
            sch.l, SAMPLED_ROWS, replace=False))
        oracle = _topk_vs_oracle(res.topk_p, res.topk_i, ts, ts, m, rows,
                                 sch.exclusion)
        check(oracle["max_corr_err"] <= TOL_ORACLE
              and oracle["pick_violations"] == 0 and oracle["distinct"],
              f"anytime top-{k} vs f64 exact top-{k}: {oracle}")
        before = read_counts()["natsa_mp"]
        sup = _supervised(mk4, res, ("topk_p", "topk_i"),
                          os.path.join(tmp, "sup4.npz"))
        check(read_counts()["natsa_mp"] == before, "top-k supervised launch")

        def mk4_on(devices):
            return lambda: AnytimeScheduler(
                ts, m, devices, k=k, chunks_per_worker=ANYTIME_GROUP_CPW)

        grp, group = _group_rounds(mk4_on(mesh), mk4_on([DEVICE]))
        gres = grp.result()
        group["bitwise_8x8"] = all(torch.equal(getattr(gres, f),
                                               getattr(res, f))
                                   for f in ("topk_p", "topk_i"))
        check(group["launches"] == 0 and group["bitwise_8x8"],
              f"group top-{k}: {group['launches']} launches, bitwise the "
              f"8 x 8 run {group['bitwise_8x8']}")
        del grp, gres
        out["topk"] = {"n": n, "m": m, "k": k, "exclusion": sch.exclusion,
                       "launches": counts["natsa_mp"], "counts": counts,
                       **{f: v for f, v in rounds.items() if f != "save_s"},
                       "rounds_s": sum(rounds["round_ms"]) / 1e3,
                       "oracle": oracle, "supervised": sup,
                       "group": group}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)
    return out


def _lm_model(cfg, seed: int):
    """The port's model on the card, its weights drawn there from `seed`."""
    import torch

    from repro_torch.models import transformer

    gen = torch.Generator(DEVICE).manual_seed(seed)
    return transformer.Transformer(cfg, device=DEVICE, generator=gen)


def _lm_tokens(rng, cfg, b: int, s: int):
    import torch

    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                            .astype(np.int32)).to(DEVICE)


def _lm_setup() -> dict:
    """The global settings the LM phases run under, as they print them."""
    import torch

    return {"allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32}


class _CallTimer:
    """Wraps `mod.<name>` in CUDA events while active: its time inside a
    model run, call by call (the flash kernel launch by launch; whisper's
    encoder pass by pass)."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.real, self.events = mod, name, None, []

    def __enter__(self):
        import torch

        self.real = getattr(self.mod, self.name)

        def timed(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self.real(*a, **kw)
            ev[1].record()
            self.events.append(ev)
            return out

        setattr(self.mod, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)

    def ms(self) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.events]


class _FlashCheck:
    """Wraps `flash_attn.flash_attention` while active: the calls numbered
    in `calls` (0 is the first) are held against the plain version on the
    very same q/k/v, each element within one bf16 rounding
    (`flash_attn.element_ratio` <= 1, as `main_flash`). The plain version
    launches no kernel, so the launch counts see the model's calls only."""

    def __init__(self, calls):
        from repro_torch.kernels import flash_attn

        self.mod, self.real, self.calls = flash_attn, None, set(calls)
        self.n, self.results = 0, []

    def __enter__(self):
        self.real = self.mod.flash_attention

        def checked(q, k, v, **kw):
            out = self.real(q, k, v, **kw)
            if self.n in self.calls:
                plain = self.mod.flash_attention_plain(
                    q, k, v, causal=kw.get("causal", True))
                self.results.append({
                    "call": self.n, "shape": list(q.shape),
                    "max_abs_err": float((out.float() - plain.float())
                                         .abs().max()),
                    "element_ratio": self.mod.element_ratio(out, plain)})
                del plain
            self.n += 1
            return out

        self.mod.flash_attention = checked
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.real

    def ok(self) -> bool:
        return (len(self.results) == len(self.calls) and all(
            r["element_ratio"] <= 1.0 for r in self.results))


class _PlainFlash:
    """Replaces `flash_attn.flash_attention` by its plain version while
    active (the same model, the kernel call swapped; no package switch).
    With `kv_heads`, a planted fault: the repeated K/V heads are re-read as
    if tiled (`repeat`) where GQA interleaves them (`repeat_interleave`)."""

    def __init__(self, kv_heads: int | None = None):
        self.kv_heads = kv_heads

    def __enter__(self):
        import torch

        from repro_torch.kernels import flash_attn

        self.mod, self.real = flash_attn, flash_attn.flash_attention
        kvh = self.kv_heads

        def plain(q, k, v, *, bq, bk, causal):
            if kvh is not None:
                h = q.shape[1]
                wrong = (torch.arange(h, device=q.device) % kvh) * (h // kvh)
                k, v = k[:, wrong].contiguous(), v[:, wrong].contiguous()
            return flash_attn.flash_attention_plain(q, k, v, causal=causal)

        flash_attn.flash_attention = plain
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.real


def _device_time(fn, reps: int) -> dict:
    """`reps` calls of fn under `torch.profiler`: the device's kernel time
    per call (the profiler's kernel rows, `DeviceType.CUDA`, summed: the
    kernels run on one stream, so they do not overlap), the five kernels
    that take most of it, and the five operators whose kernels do.
    Profiling slows the host, so the idle share is read against the
    unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def top(rows):
        rows = sorted(rows, key=lambda e: -e.self_device_time_total)[:5]
        return [[e.key[:80], e.self_device_time_total / 1e3 / reps,
                 e.count / reps] for e in rows]

    stats = prof.key_averages()
    kernels = [e for e in stats if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    ops = [e for e in stats if e.device_type == DeviceType.CPU
           and e.device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return {"reps": reps, "device_ms_per_call": dev_ms if kernels else None,
            "top_kernels_ms_per_call": top(kernels),
            "top_ops_ms_per_call": [
                [e.key[:80], e.device_time_total / 1e3 / reps, e.count / reps]
                for e in sorted(ops, key=lambda e: -e.device_time_total)[:5]]}


def _top2_gap(logits):
    """Per position, the largest logit minus the second (f32)."""
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _logits_vs(got, want, tol: float) -> dict:
    """max|got - want| against tol x max|want|; greedy picks may differ
    only where `want`'s top two logits lie within that bound."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    err = float((g - w).abs().max())
    differ = g.argmax(-1) != w.argmax(-1)
    near = _top2_gap(w) <= tol * scale
    return {"max_abs_err": err, "max_abs_ref": scale, "rel_err": err / scale,
            "tol_rel": tol, "greedy_differ": int(differ.sum()),
            "greedy_differ_not_near_tie": int((differ & ~near).sum()),
            "ok": err <= tol * scale and not bool((differ & ~near).any())}


def _leaf_kind(sp) -> str:
    """A cache leaf's kind: "seq" (a sequence axis: {k, v}, {ckv, kr}),
    "cross" (whisper's cross K/V over the encoder's frames) or "state"
    (RWKV6's state and token shifts, Mamba's SSM state and conv window)."""
    if "kv_seq" in sp.axes:
        return "seq"
    return "cross" if "kv_heads" in sp.axes else "state"


def _copy_cache(cfg, cache, pre, rows: slice, n: int) -> None:
    """Copy a prefill cache `pre` (n slots) into rows `rows` of the decode
    cache `cache`: slots 0..n-1 of a leaf with a sequence axis, a state or
    cross K/V leaf whole."""
    from repro_torch.models import transformer

    for i, (layer, pc) in enumerate(zip(cache, pre)):
        spec = transformer.layer_cache_spec(cfg, cfg.layer_kind(i), 1, n)
        for key, t in pc.items():
            if _leaf_kind(spec[key]) == "seq":
                layer[key][rows, :n] = t
            else:
                layer[key][rows] = t


def _cache_bytes(cfg, b: int, s: int, kind: str | None = None) -> int:
    """Bytes of the decode cache of b requests and s slots, in each leaf's
    dtype (the states are f32); only the leaves of one `_leaf_kind` with
    `kind`."""
    from repro_torch.models import transformer

    return sum(int(np.prod(sp.shape)) * sp.dtype.itemsize
               for layer in transformer.cache_spec(cfg, b, s)
               for sp in layer.values()
               if kind is None or _leaf_kind(sp) == kind)


def _mrope_positions(b: int, s: int, text_tail: int = 0):
    """(3, b, s) M-RoPE positions on the card, as a video's patches give
    them, frames of 16 x 16 patches: w rises strictly (0..s-1), t is the
    frame (w // 256) and h the row ((w // 16) % 16) of each position; the
    last `text_tail` positions are text, t = h = w (the positions decode
    gives a new token)."""
    import torch

    w = torch.arange(s, dtype=torch.int32, device=DEVICE)
    t, h = w // 256, (w // 16) % 16
    if text_tail:
        t[s - text_tail:] = w[s - text_tail:]
        h[s - text_tail:] = w[s - text_tail:]
    return torch.stack([t, h, w])[:, None].expand(3, b, s).contiguous()


def _lm_extras(cfg, b: int, s: int, rng, text_tail: int = 0) -> dict:
    """What a model takes beside its tokens, on the card: whisper's frames
    (b, 1500, d), standard normal at FRAMES_SCALE (the reference trainer's
    scale) drawn in f32 with numpy from `rng`, then cast to the model's
    dtype; M-RoPE's (3, b, s) positions (`_mrope_positions`)."""
    import torch

    out = {}
    if cfg.is_encdec:
        frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model),
                                     dtype=np.float32) * FRAMES_SCALE
        out["frames"] = torch.from_numpy(frames).to(DEVICE, cfg.dtype)
    if cfg.mrope_sections:
        out["positions"] = _mrope_positions(b, s, text_tail)
    return out


def _rows(extras: dict, rows: slice, cols: slice = slice(None)) -> dict:
    """The extras of requests `rows` (and of positions `cols`)."""
    return {k: v[:, rows, cols] if k == "positions" else v[rows]
            for k, v in extras.items()}


def _lm_decode_run(cfg, model, tokens, n_prefill: int, before_step=None,
                   extras=None):
    """Prefill tokens[:, :n_prefill] (with `extras`' frames and the
    positions of those tokens) through the prefill step, copy the cache
    into one of tokens.shape[1] slots (the prefill cache has exactly
    n_prefill), then decode the rest teacher-forced, calling
    `before_step(cache)` before each step where given (a planted fault).
    Returns the decode logits (B, T, V) for positions n_prefill..S-1."""
    import torch

    from repro_torch.models import steps, transformer

    b, s = tokens.shape
    head = _rows(extras or {}, slice(None), slice(0, n_prefill))
    _, pre = steps.make_prefill_step(cfg)(
        model, {"tokens": tokens[:, :n_prefill], **head})
    cache = transformer.init_cache(cfg, model, b, s)
    _copy_cache(cfg, cache, pre, slice(None), n_prefill)
    del pre
    dec = steps.make_decode_step(cfg)
    out = []
    for t in range(n_prefill, s):
        if before_step is not None:
            before_step(cache)
        lg, cache = dec(model, cache, {"tokens": tokens[:, t:t + 1],
                                       "cache_len": t})
        out.append(lg)
    return torch.cat(out, dim=1)


def _attn_layers(cfg) -> int:
    """Decoder layers whose attention runs the flash kernel (GQA; MLA runs
    none)."""
    return sum(cfg.layer_kind(i).mixer == "attn" for i in range(cfg.n_layers))


def _flash_calls(cfg) -> int:
    """Flash calls of one prefill or train-mode forward: whisper's encoder
    layers first (bidirectional), then the decoder's GQA layers."""
    return cfg.encoder_layers + _attn_layers(cfg)


def _check_layers(cfg) -> tuple[int, ...]:
    """The flash calls of a prefill that `_FlashCheck` holds: the first,
    middle and last (call i is the i-th GQA layer's: all of llama3-8b's,
    olmoe-1b-7b's and qwen2-vl-2b's layers, jamba's at in-period index 4;
    whisper's 32 encoder layers, then its 32 decoder layers, so its middle
    call is decoder layer 0); none for MLA and RWKV6."""
    n = _flash_calls(cfg)
    return tuple(sorted({0, n // 2, n - 1})) if n else ()


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def _cache_ok(cfg, cache, b: int, s: int) -> bool:
    """Every layer's cache has its spec's shape and finite values."""
    from repro_torch.models import transformer

    return len(cache) == cfg.n_layers and all(
        tuple(c[k].shape) == sp.shape and _finite(c[k])
        for i, c in enumerate(cache)
        for k, sp in transformer.layer_cache_spec(
            cfg, cfg.layer_kind(i), b, s).items())


def _lm_work(cfg, shape) -> tuple[dict, float]:
    """(model FLOPs, HBM byte floor on one card) of a step: the
    reference's `model_flops` and `hbm_bytes_floor`, or for an
    encoder-decoder the port's `encdec_model_flops` and
    `encdec_hbm_bytes_floor`, which count the encoder's and the cross
    K/V's work over the frames, cross attention, and in decode only the
    weights a step reads and the cross K/V it reads."""
    from repro_torch.utils import flops

    if cfg.is_encdec:
        return (flops.encdec_model_flops(cfg, shape),
                flops.encdec_hbm_bytes_floor(cfg, shape))
    return flops.model_flops(cfg, shape), flops.hbm_bytes_floor(cfg, shape, 1)


def phase_lm_prefill(model, cfg, *, phase: str = "main_lm_prefill",
                     batch: int = LM_PREFILL_B,
                     seed: int = SEED + 41) -> dict:
    """A model at its published width (and depth, or `cfg`'s cut):
    `batch` requests of 32,768 tokens as one batch through
    `make_prefill_step`, each GQA layer's causal attention through the
    flash kernel (one wgmma launch a layer; MLA and RWKV6 launch none).
    With flash calls or recurrent states, a first run holds the kernel at
    three layers against the plain version on the model's own q/k/v and
    its logits finite (the reference's init rule gives jamba's Mamba
    inputs a scale near 45); then a run counted and timed (the kernel
    wrapped in CUDA events, the peak memory read from it), and one traced;
    beside the bound from `model_flops` (whisper's from
    `encdec_model_flops`, each term at the length it runs over) and the
    bytes of the recurrent state the batch carries out (`state_bytes`,
    which `hbm_bytes_floor` does not count). The logits and the cache are finite, and the traced
    run's logits equal the timed run's bit for bit (no atomics on the
    path: flash, cuBLAS, the MoE dispatch and combine, the chunked
    scans). whisper's requests carry frames (its encoder's 32 flash
    launches precede the decoder's 32), qwen2-vl's M-RoPE positions."""
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import flash_attn
    from repro_torch.models import steps
    from repro_torch.utils import flops

    b, s = batch, LM_PREFILL_S
    n_attn = _flash_calls(cfg)
    state_bytes = _cache_bytes(cfg, b, s, kind="state")
    rng = np.random.default_rng(seed)
    tokens = _lm_tokens(rng, cfg, b, s)
    full_batch = {"tokens": tokens, **_lm_extras(cfg, b, s, rng)}
    step = steps.make_prefill_step(cfg)
    lg1 = None
    with _FlashCheck(_check_layers(cfg)) as chk:
        if n_attn or state_bytes:
            lg1 = step(model, full_batch)[0]
            torch.cuda.synchronize()
            check(_finite(lg1), f"{cfg.name} prefill logits not finite")
    check(chk.ok(), f"in-model flash vs plain: {chk.results}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _CallTimer(flash_attn, "flash_attention") as timer:
        t0 = time.perf_counter()
        lg2, cache = step(model, full_batch)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attn"] == n_attn
          and counts["flash_attn_routes"] == {"wgmma": n_attn, "fma": 0}
          and counts["natsa_mp"] == 0,
          f"{cfg.name} prefill launches {counts}, want {n_attn} wgmma")
    check(lg2.shape == (b, 1, cfg.padded_vocab)
          and lg2.dtype == torch.bfloat16 and _finite(lg2),
          "prefill logits")
    check(_cache_ok(cfg, cache, b, s), "prefill cache")
    del cache
    if state_bytes:
        # a recurrent model's prefill repeats the same chunk steps along
        # the sequence (~1e5-1e6 kernels at 32,768 tokens, which the
        # profiler takes minutes to parse): trace a prefix of each request
        # beside its own unprofiled wall time; its first run repeats
        repeat = torch.equal(lg1, lg2)
        head = {"tokens": tokens[:, :LM_TRACE_PREFIX]}     # no M-RoPE here
        t0 = time.perf_counter()
        step(model, head)
        torch.cuda.synchronize()
        trace_wall_s = time.perf_counter() - t0
        trace = _device_time(lambda: step(model, head), 1)
        trace["tokens_per_request"] = LM_TRACE_PREFIX
    else:
        again = []
        trace = _device_time(
            lambda: again.append(step(model, full_batch)[0]), 1)
        repeat, trace_wall_s = torch.equal(again[0], lg2), warm_s
    del lg1
    check(repeat, "the prefill did not repeat bit for bit")
    if trace["device_ms_per_call"] is not None:
        trace["idle_share"] = (1 - trace["device_ms_per_call"]
                               / (1e3 * trace_wall_s))
    flash_ms = timer.ms()
    check(len(flash_ms) == n_attn, "the timed prefill's flash calls")
    shape = ShapeSpec(f"prefill_32k_b{b}", s, b, "prefill")
    mf, floor_bytes = _lm_work(cfg, shape)
    t_ops = mf["total"] / BF16_PEAK
    t_bytes = floor_bytes / HBM_RATE
    bound_s = max(t_ops, t_bytes)
    out = {"phase": phase, "cell": "prefill_32k",
           "card": torch.cuda.get_device_name(0), "nvidia_smi": _smi(),
           "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": "bfloat16",
           "batch": b, "seq_len": s, **_lm_setup(),
           "params": flops.param_counts(cfg),
           "counts": counts, "flash_launches": counts["flash_attn"],
           "launches_by_route": counts["flash_attn_routes"],
           "in_model_vs_plain": chk.results,
           "prefill_s": warm_s, "tokens_per_s": b * s / warm_s,
           "peak_device_bytes": peak,
           "model_flops": mf, "bound_s": bound_s,
           "state_bytes": state_bytes,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "share_of_bound": bound_s / warm_s,
           "flash_ms_in_model": sum(flash_ms),
           "flash_ms_encoder": sum(flash_ms[:cfg.encoder_layers]),
           "flash_ms_per_layer": ([min(flash_ms), float(np.median(flash_ms)),
                                   max(flash_ms)] if flash_ms else None),
           "flash_share": sum(flash_ms) / (1e3 * warm_s),
           "repeat_bitwise": repeat, "trace": trace}
    emit(out)
    return out


def phase_lm_decode(model, cfg, *, phase: str = "main_lm_decode",
                    seed: int = SEED + 42,
                    prompt: int = LM_DECODE_PROMPT) -> dict:
    """LM_DECODE_B requests of `prompt` tokens, prefilled LM_DECODE_CHUNK
    at a time (one flash launch per GQA layer each) into one decode cache
    of prompt + LM_DECODE_STEPS slots, then LM_DECODE_STEPS greedy steps
    (`greedy_next`) over the whole batch, each timed to its synchronize,
    beside the per-step bound from `hbm_bytes_floor` and the recurrent
    state's bytes (`state_bytes`: each step reads and writes them; the
    floor does not count them). A prompt chunk's cache goes into the
    decode cache by `_copy_cache`. Before the timed run, one chunk's
    prefill holds the kernel at three layers against the plain version on
    the model's own q/k/v (GQA). whisper's prompt chunks carry their
    requests' frames: each chunk's prefill encodes them (timed by CUDA
    events, `encode_s` over all the chunks) and its cross K/V go into the
    decode cache with the self K/V; each step reads those cross K/V
    (`cross_bytes`), which its floor (`encdec_hbm_bytes_floor`) counts
    beside the decoder's weights alone."""
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.models import steps, transformer

    b, p, n, c = LM_DECODE_B, prompt, LM_DECODE_STEPS, LM_DECODE_CHUNK
    rng = np.random.default_rng(seed)
    tokens = _lm_tokens(rng, cfg, b, p)
    extras = _lm_extras(cfg, b, p, rng)
    prefill = steps.make_prefill_step(cfg)
    with _FlashCheck(_check_layers(cfg)) as chk:
        if chk.calls:
            _, first = prefill(model, {"tokens": tokens[:c],
                                       **_rows(extras, slice(0, c))})
            torch.cuda.synchronize()
    check(chk.ok(), f"in-model flash vs plain (decode prompts): "
                    f"{chk.results}")
    torch.cuda.synchronize()
    free_bytes, total_bytes = torch.cuda.mem_get_info()
    cache_bytes = _cache_bytes(cfg, b, p + n)
    state_bytes = _cache_bytes(cfg, b, p + n, kind="state")
    cross_bytes = _cache_bytes(cfg, b, p + n, kind="cross")
    if chk.calls:
        del first
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cache = transformer.init_cache(cfg, model, b, p + n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = []
    with _CallTimer(transformer, "encode") as enc:
        for r0 in range(0, b, c):
            lg, pre = prefill(model, {"tokens": tokens[r0:r0 + c],
                                      **_rows(extras, slice(r0, r0 + c))})
            _copy_cache(cfg, cache, pre, slice(r0, r0 + c), p)
            last.append(lg)
            del pre
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    encode_s = 1e-3 * sum(enc.ms()) if cfg.is_encdec else None
    check(len(enc.ms()) == (b // c if cfg.is_encdec else 0),
          "an encoder pass per prompt chunk")
    prefill_counts = read_counts()
    want = _flash_calls(cfg) * (b // c)
    check(prefill_counts["flash_attn_routes"] == {"wgmma": want, "fma": 0}
          and prefill_counts["natsa_mp"] == 0,
          f"chunked prefill launches {prefill_counts}, want {want} wgmma")
    dec = steps.make_decode_step(cfg)
    nxt = steps.greedy_next(torch.cat(last, dim=0))
    del last
    generated, step_ms = [nxt], []
    torch.cuda.synchronize()
    for i in range(n):
        t0 = time.perf_counter()
        lg, cache = dec(model, cache, {"tokens": nxt, "cache_len": p + i})
        nxt = steps.greedy_next(lg)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        generated.append(nxt)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    pos = [p + n]

    def one_more():       # past the last slot: the ring overwrites slot 0..
        dec(model, cache, {"tokens": nxt, "cache_len": pos[0]})
        pos[0] += 1

    trace = _device_time(one_more, 4)
    toks = torch.cat(generated, dim=1)
    check(counts == prefill_counts,
          f"decode steps launched a kernel: {counts} after {prefill_counts}")
    check(toks.shape == (b, n + 1) and toks.dtype == torch.int32
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
          and _finite(lg), "decoded tokens / logits")
    shape = ShapeSpec(f"decode_{p + n}_b{b}", p + n, b, "decode")
    mf, floor_bytes = _lm_work(cfg, shape)
    t_bytes = floor_bytes / HBM_RATE
    t_ops = mf["total"] / BF16_PEAK
    bound_ms = 1e3 * max(t_bytes, t_ops)
    med = float(np.median(step_ms))
    if trace["device_ms_per_call"] is not None:
        trace["idle_share"] = 1 - trace["device_ms_per_call"] / med
    out = {"phase": phase, "cell": "decode_32k",
           "card": torch.cuda.get_device_name(0), "nvidia_smi": _smi(),
           "arch": cfg.name, "batch": b, "prompt": p, "steps": n,
           "cache_slots": p + n, "prefill_chunk": c, **_lm_setup(),
           "cache_bytes": cache_bytes, "free_bytes_before": free_bytes,
           "encode_s": encode_s, "cross_bytes": cross_bytes,
           "total_bytes": total_bytes,
           "in_model_vs_plain": chk.results,
           "prefill_s": prefill_s, "prefill_tokens_per_s": b * p / prefill_s,
           "counts": {"natsa_mp": counts["natsa_mp"],
                      "flash_attn": counts["flash_attn"]},
           "launches_by_route": counts["flash_attn_routes"],
           "step_ms": step_ms, "step_ms_median": med,
           "step_ms_max": max(step_ms), "step_ms_first": step_ms[0],
           "tokens_per_s": b * n / (1e-3 * sum(step_ms)),
           "bound_ms": bound_ms,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "floor_bytes": floor_bytes, "state_bytes": state_bytes,
           "share_of_bound": bound_ms / med,
           "peak_device_bytes": peak, "trace": trace,
           "tokens_request0": toks[0, :8].tolist()}
    emit(out)
    return out


def phase_lm_vs_plain() -> dict:
    """llama3-8b at full width, 2 layers, S = 4096: logits with the kernel
    against the same model with the kernel call replaced by the plain
    version (bf16, wgmma), prefill against train, and decode against
    teacher forcing in bf16 and in f32 (the fma route)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import steps, transformer

    cfg = dataclasses.replace(configs.get_config(LM_ARCH),
                              n_layers=LM_PLAIN_LAYERS)
    model = _lm_model(cfg, SEED + 43)
    s, t = LM_PLAIN_S, LM_PLAIN_DECODE
    tokens = _lm_tokens(np.random.default_rng(SEED + 44), cfg, 1, s)
    out = {"phase": "lm_vs_plain", "card": torch.cuda.get_device_name(0),
           "arch": cfg.name, "layers": cfg.n_layers, "seq_len": s,
           "decode_steps": t, **_lm_setup()}
    with torch.no_grad():
        reset_counts()
        full, _, _ = transformer.forward(cfg, model, tokens, mode="train")
        last, _ = steps.make_prefill_step(cfg)(model, {"tokens": tokens})
        counts = read_counts()
        check(counts["flash_attn_routes"] == {"wgmma": 2 * cfg.n_layers,
                                              "fma": 0},
              f"lm_vs_plain kernel launches {counts}")
        with _PlainFlash():
            plain_full, _, _ = transformer.forward(cfg, model, tokens,
                                                   mode="train")
            plain_last, _ = steps.make_prefill_step(cfg)(model,
                                                         {"tokens": tokens})
        check(read_counts() == counts, "the plain run launched a kernel")
        with _PlainFlash(kv_heads=cfg.n_kv_heads):
            fault_full, _, _ = transformer.forward(cfg, model, tokens,
                                                   mode="train")
        # the steps -inf the padded vocab columns; compare the real ones
        v = cfg.vocab_size
        out["train_vs_plain"] = _logits_vs(full[..., :v],
                                           plain_full[..., :v], TOL_LM_BF16)
        out["prefill_vs_plain"] = _logits_vs(last[..., :v],
                                             plain_last[..., :v], TOL_LM_BF16)
        out["prefill_vs_train"] = _logits_vs(last[..., :v],
                                             full[:, -1:, :v], TOL_LM_BF16)
        fault = _logits_vs(fault_full[..., :v], plain_full[..., :v],
                           TOL_LM_BF16)
        out["planted_fault"] = {"fault": "K/V heads tiled, not interleaved "
                                         "(query head j reads KV head "
                                         "j % n_kv_heads)", **fault}
        check(not fault["ok"], f"the bound passes a planted fault: {fault}")
        del plain_full, fault_full
        dec = _lm_decode_run(cfg, model, tokens, s - t)
        out["decode_vs_teacher_bf16"] = _logits_vs(dec[..., :v],
                                                   full[:, s - t:, :v],
                                                   TOL_LM_BF16)
        del full, dec
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        reset_counts()
        full32, _, _ = transformer.forward(cfg32, model, tokens, mode="train")
        dec32 = _lm_decode_run(cfg32, model, tokens, s - t)
        counts32 = read_counts()
        check(counts32["flash_attn_routes"] == {"wgmma": 0,
                                                "fma": 2 * cfg.n_layers},
              f"f32 launches {counts32}")
        out["decode_vs_teacher_f32"] = _logits_vs(dec32[..., :v],
                                                  full32[:, s - t:, :v],
                                                  TOL_LM_DECODE)
        del full32, dec32
    out["counts"] = {"bf16": counts, "f32": counts32}
    for key in ("train_vs_plain", "prefill_vs_plain", "prefill_vs_train",
                "decode_vs_teacher_bf16", "decode_vs_teacher_f32"):
        check(out[key]["ok"], f"lm_vs_plain {key}: {out[key]}")
    emit(out)
    return out


def _lm_serving(arch: str, prefill_phase: str, decode_phase: str,
                prefill_b: int, seed: int, layers: int | None = None,
                prompt: int = LM_DECODE_PROMPT, then=None) -> dict:
    """One model at its published width and depth (or `layers` deep),
    built once on the card from `seed` for its prefill and decode phases
    (decode over prompts of `prompt` tokens), and `then(model, cfg)`
    where given, then freed."""
    import torch

    from repro_torch import configs

    cfg = configs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _lm_model(cfg, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    pre = phase_lm_prefill(model, cfg, phase=prefill_phase, batch=prefill_b,
                           seed=seed + 1)
    torch.cuda.empty_cache()
    dec = phase_lm_decode(model, cfg, phase=decode_phase, seed=seed + 2,
                          prompt=prompt)
    torch.cuda.empty_cache()
    after = then(model, cfg) if then is not None else None
    del model
    torch.cuda.empty_cache()
    emit({"phase": "lm_model", "arch": cfg.name, "layers": cfg.n_layers,
          "build_s": build_s, "weight_bytes": weights})
    return {"prefill": pre, "decode": dec, "build_s": build_s,
            "weight_bytes": weights, "then": after}


def phase_lm() -> dict:
    """The llama3-8b phases: the 2-layer comparison first, then the full
    model for prefill and decode."""
    import torch

    vs_plain = phase_lm_vs_plain()
    torch.cuda.empty_cache()
    out = _lm_serving(LM_ARCH, "main_lm_prefill", "main_lm_decode",
                      LM_PREFILL_B, SEED + 40)
    return {**out, "vs_plain": vs_plain}


class _RoutingLog:
    """Records, while active, each MoE layer's routing (`moe._route`):
    per token the expert set (sorted ids) and which of those entries
    were kept under capacity, in call order."""

    def __enter__(self):
        from repro_torch.models import moe

        self.mod, self.real, self.calls = moe, moe._route, []

        def logged(cfg, p, xt):
            out = self.real(cfg, p, xt)
            n = xt.shape[0]
            ids, order = out[2].view(n, -1).sort(dim=1)
            self.calls.append((ids, out[4].view(n, -1).gather(1, order)))
            return out

        moe._route = logged
        return self

    def __exit__(self, *exc):
        self.mod._route = self.real

    def stacked(self, first: int = 0):
        """(ids, keep) of the calls from `first` on: (calls, n, k)."""
        calls = self.calls[first:]
        return (np.stack([c[0].cpu().numpy() for c in calls]),
                np.stack([c[1].cpu().numpy() for c in calls]))


def _flipped(a, b):
    """Tokens whose expert set or kept mask differs at any layer between
    two routings (ids, keep) of shape (layers, n, k): (n,) bool."""
    return ((a[0] != b[0]) | (a[1] != b[1])).any(axis=(0, 2))


def _decode_routing(log: _RoutingLog, moe_layers: int, b: int, t: int):
    """A teacher-forced decode run's routing (its prefill's calls first,
    then moe_layers calls of b tokens per step) as (layers, b·t, k), tokens
    request-major as a (b, t) forward's."""
    ids, keep = log.stacked(moe_layers)
    k = ids.shape[-1]

    def arrange(x):
        return x.reshape(t, moe_layers, b, k).transpose(1, 2, 0, 3).reshape(
            moe_layers, b * t, k)
    return arrange(ids), arrange(keep)


def _routed_vs(got, want, flipped, tol: float) -> dict:
    """`_logits_vs` over the tokens whose routing did not flip (flipped:
    (B·T,) bool over got's (B, T) positions), beside the flip count; at
    most FLIP_SHARE_MAX of the tokens may flip."""
    import torch

    keep = ~torch.from_numpy(flipped).to(got.device).reshape(got.shape[:2])
    share = float(flipped.mean())
    out = {"flipped_tokens": int(flipped.sum()), "tokens": int(flipped.size),
           "flipped_share": share, "flip_share_max": FLIP_SHARE_MAX}
    if not bool(keep.any()):
        return {**out, "logits_ok": False, "ok": False}
    vs = _logits_vs(got[keep], want[keep], tol)
    return {**vs, **out, "logits_ok": vs["ok"],
            "ok": vs["ok"] and share <= FLIP_SHARE_MAX}


class _PermutedExperts:
    """A planted fault: while active, expert e's down projection in each
    of `layers` holds expert e + 1's weights (`ffn.wo` rolled over the
    expert axis; the weights are put back on exit)."""

    def __init__(self, model, layers):
        self.params = [model.get_parameter(f"layers.{i}.ffn.wo")
                       for i in layers]

    def __enter__(self):
        self.saved = [p.data for p in self.params]
        for p in self.params:
            p.data = p.data.roll(-1, 0)
        return self

    def __exit__(self, *exc):
        for p, t in zip(self.params, self.saved):
            p.data = t


def _moe_layer_ids(cfg) -> list[int]:
    return [i for i in range(cfg.n_layers) if cfg.layer_kind(i).ffn == "moe"]


def _moe_layers(cfg) -> int:
    return len(_moe_layer_ids(cfg))


def _last_layer_fault(got, want, flipped, tol: float) -> dict:
    """`_routed_vs` of a run with the last MoE layer's experts permuted:
    no routing comes after that layer, so the fault flips no token the
    sound run does not, and must fail the logit bound itself."""
    out = {"fault": "expert e's down projection reads expert e + 1's, at "
                    "the last MoE layer only (routing unchanged)",
           **_routed_vs(got, want, flipped, tol)}
    check(not out["logits_ok"],
          f"the logit bound passes a planted fault: {out}")
    return out


def _consistency_f32(arch: str, seed: int, model=None) -> dict:
    """One model at full width, LM_MOE_LAYERS layers, f32 compute over its
    bf16 weights, B·S = LM_MOE_F32_S tokens (dispatch dropless on both
    sides): prefill against train, and decode against teacher forcing
    (LM_MOE_DECODE steps after a prefill of the rest), within
    TOL_LM_DECODE over the tokens whose routing did not flip; a planted
    fault (`_PermutedExperts` at the last MoE layer in the decode run,
    which changes no routing) must fail the logit bound."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_config(arch),
                              n_layers=LM_MOE_LAYERS, dtype=torch.float32)
    if model is None:
        model = _lm_model(cfg, seed)
    s, t, v = LM_MOE_F32_S, LM_MOE_DECODE, cfg.vocab_size
    tokens = _lm_tokens(np.random.default_rng(seed + 1), cfg, 1, s)
    nm = _moe_layers(cfg)
    reset_counts()
    with _RoutingLog() as rt:
        full, _, _ = transformer.forward(cfg, model, tokens, mode="train")
    with _RoutingLog() as rp:
        pre, _, _ = transformer.forward(cfg, model, tokens, mode="prefill")
    with _RoutingLog() as rd:
        dec = _lm_decode_run(cfg, model, tokens, s - t)
    counts = read_counts()
    n_attn = _attn_layers(cfg)
    check(counts["flash_attn_routes"] == {"wgmma": 0, "fma": 3 * n_attn}
          and counts["natsa_mp"] == 0, f"{arch} f32 launches {counts}")
    with _PermutedExperts(model, _moe_layer_ids(cfg)[-1:]), \
            _RoutingLog() as rf:
        fault = _lm_decode_run(cfg, model, tokens, s - t)
    teacher = tuple(x[:, s - t:] for x in rt.stacked())      # B = 1
    out = {"arch": arch, "layers": cfg.n_layers, "seq_len": s,
           "decode_steps": t, "counts": counts,
           "prefill_vs_train": _routed_vs(
               pre[..., :v], full[..., :v],
               _flipped(rp.stacked(), rt.stacked()), TOL_LM_DECODE),
           "decode_vs_teacher": _routed_vs(
               dec[..., :v], full[:, s - t:, :v],
               _flipped(_decode_routing(rd, nm, 1, t), teacher),
               TOL_LM_DECODE)}
    out["planted_fault"] = _last_layer_fault(
        fault[..., :v], full[:, s - t:, :v],
        _flipped(_decode_routing(rf, nm, 1, t), teacher), TOL_LM_DECODE)
    for key in ("prefill_vs_train", "decode_vs_teacher"):
        check(out[key]["ok"], f"lm_moe_vs_plain {arch} {key}: {out[key]}")
    return out


def phase_lm_moe_vs_plain() -> dict:
    """olmoe-1b-7b and deepseek-v2-lite-16b at full width, LM_MOE_LAYERS
    layers (deepseek's: its dense first layer and one MLA + MoE layer).
    olmoe in bf16 over S = LM_MOE_PLAIN_S tokens: the train-mode logits
    with the flash kernel (wgmma) against the same model with the kernel
    call swapped for its plain version, within TOL_LM_BF16 over the tokens
    whose routing (expert set or kept mask at any layer) is the same on
    both sides, at most FLIP_SHARE_MAX of the tokens flipping; the kernel
    held per element at both layers on the model's own q/k/v; two planted
    faults must fail: `_PermutedExperts` at every MoE layer (which reroutes
    the tokens of the layers after the first) and at the last one only
    (which reroutes none, so the logit bound alone must catch it). Then
    `_consistency_f32` on both models."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_config(LM_MOE_ARCH),
                              n_layers=LM_MOE_LAYERS)
    model = _lm_model(cfg, SEED + 50)
    s = LM_MOE_PLAIN_S
    tokens = _lm_tokens(np.random.default_rng(SEED + 51), cfg, 1, s)
    v = cfg.vocab_size
    out = {"phase": "lm_moe_vs_plain", "card": torch.cuda.get_device_name(0),
           "arch": cfg.name, "layers": cfg.n_layers, "seq_len": s,
           **_lm_setup()}
    with torch.no_grad():
        reset_counts()
        with _RoutingLog() as rk, _FlashCheck(range(cfg.n_layers)) as chk:
            full, aux, _ = transformer.forward(cfg, model, tokens,
                                               mode="train")
        counts = read_counts()
        check(counts["flash_attn_routes"] == {"wgmma": cfg.n_layers,
                                              "fma": 0}
              and counts["natsa_mp"] == 0,
              f"lm_moe_vs_plain kernel launches {counts}")
        check(chk.ok(), f"in-model flash vs plain: {chk.results}")
        with _PlainFlash(), _RoutingLog() as rp:
            plain, _, _ = transformer.forward(cfg, model, tokens,
                                              mode="train")
        check(read_counts() == counts, "the plain run launched a kernel")
        moe_ids = _moe_layer_ids(cfg)
        with _PlainFlash(), _PermutedExperts(model, moe_ids), \
                _RoutingLog() as rf:
            fault, _, _ = transformer.forward(cfg, model, tokens,
                                              mode="train")
        with _PlainFlash(), _PermutedExperts(model, moe_ids[-1:]), \
                _RoutingLog() as rl:
            last, _, _ = transformer.forward(cfg, model, tokens,
                                             mode="train")
        out["counts"] = counts
        out["in_model_vs_plain"] = chk.results
        out["aux"] = float(aux)
        out["dropped_entries"] = int((~rk.stacked()[1]).sum())
        out["train_vs_plain"] = _routed_vs(
            full[..., :v], plain[..., :v],
            _flipped(rk.stacked(), rp.stacked()), TOL_LM_BF16)
        out["planted_fault"] = {
            "fault": "expert e's down projection reads expert e + 1's, at "
                     "every MoE layer",
            **_routed_vs(fault[..., :v], plain[..., :v],
                         _flipped(rf.stacked(), rp.stacked()), TOL_LM_BF16)}
        check(not out["planted_fault"]["ok"],
              f"the bound passes a planted fault: {out['planted_fault']}")
        out["planted_fault_last_layer"] = _last_layer_fault(
            last[..., :v], plain[..., :v],
            _flipped(rl.stacked(), rp.stacked()), TOL_LM_BF16)
        del full, plain, fault, last
        out["f32"] = [_consistency_f32(LM_MOE_ARCH, SEED + 52, model),
                      _consistency_f32(LM_MLA_ARCH, SEED + 54)]
    check(out["train_vs_plain"]["ok"],
          f"lm_moe_vs_plain train_vs_plain: {out['train_vs_plain']}")
    emit(out)
    return out


def _zero_leaf(key: str, layers=None):
    """A planted fault for `_lm_decode_run`: before each step, the cache
    leaf `key` set to 0 in every layer that has one (or in `layers` only)
    (`xp_tm`: RWKV6's token shift dropped; `conv`: Mamba's conv window
    dropped)."""
    def fault(cache):
        for i, layer in enumerate(cache):
            if key in layer and (layers is None or i in layers):
                layer[key].zero_()
    return fault


def _ssm_f32(arch: str, seed: int, model=None) -> dict:
    """One model of the RWKV6 or Mamba family at full width,
    LM_SSM_LAYERS[arch] layers, f32 compute over its bf16 weights, one
    request of LM_SSM_F32_S tokens (jamba's MoE dispatch dropless on every
    side): prefill against train and decode against teacher forcing
    (LM_SSM_DECODE steps after a prefill of the rest) within
    TOL_LM_DECODE, train at the chunks of LM_SSM_CHUNKS against train at
    the config's within TOL_LM_CHUNK, each over the tokens whose routing
    did not flip (`_routed_vs`; RWKV6 routes nothing); a planted fault,
    the decode run with the token shift (`xp_tm`, RWKV6) or the conv window
    (`conv`, Mamba) zeroed before every step, must fail the decode bound.
    A Mamba fault reroutes the tokens of every MoE layer after it, which
    the bound counts as flips; jamba's every Mamba layer precedes a
    router, so the fault also runs at the last Mamba layer alone, where it
    reroutes only that layer's MoE, and the logits of the tokens that keep
    their routing must then fail the bound themselves (`logits_ok`)."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_config(arch),
                              n_layers=LM_SSM_LAYERS[arch],
                              dtype=torch.float32)
    if model is None:
        model = _lm_model(cfg, seed)
    s, t, v = LM_SSM_F32_S, LM_SSM_DECODE, cfg.vocab_size
    tokens = _lm_tokens(np.random.default_rng(seed + 1), cfg, 1, s)
    nm, n_attn = _moe_layers(cfg), _attn_layers(cfg)
    chunked_cfg = dataclasses.replace(cfg, **LM_SSM_CHUNKS)
    fault_key = "xp_tm" if cfg.rwkv_mode else "conv"
    reset_counts()
    with _RoutingLog() as rt:
        full, _, _ = transformer.forward(cfg, model, tokens, mode="train")
    with _RoutingLog() as rp:
        pre, _, _ = transformer.forward(cfg, model, tokens, mode="prefill")
    with _RoutingLog() as rc:
        chunked, _, _ = transformer.forward(chunked_cfg, model, tokens,
                                            mode="train")
    with _RoutingLog() as rd:
        dec = _lm_decode_run(cfg, model, tokens, s - t)
    counts = read_counts()
    check(counts["flash_attn_routes"] == {"wgmma": 0, "fma": 4 * n_attn}
          and counts["natsa_mp"] == 0, f"{arch} f32 launches {counts}")
    faults = {"planted_fault": None}
    if nm:
        faults["planted_fault_last_layer"] = {max(
            i for i in range(cfg.n_layers)
            if cfg.layer_kind(i).mixer == "mamba")}
    runs = {}
    for name, layers in faults.items():
        with _RoutingLog() as rf:
            runs[name] = (_lm_decode_run(cfg, model, tokens, s - t,
                                         before_step=_zero_leaf(fault_key,
                                                                layers)),
                          rf)

    def flips(log, n):
        return (_flipped(log.stacked(), rt.stacked()) if nm
                else np.zeros(n, dtype=bool))

    def decode_flips(log):
        if not nm:
            return np.zeros(t, dtype=bool)
        teacher = tuple(x[:, s - t:] for x in rt.stacked())      # B = 1
        return _flipped(_decode_routing(log, nm, 1, t), teacher)

    want = full[:, s - t:, :v]
    out = {"arch": arch, "layers": cfg.n_layers, "seq_len": s,
           "decode_steps": t, "counts": counts,
           "state_bytes": _cache_bytes(cfg, 1, s, kind="state"),
           "prefill_vs_train": _routed_vs(pre[..., :v], full[..., :v],
                                          flips(rp, s), TOL_LM_DECODE),
           "decode_vs_teacher": _routed_vs(dec[..., :v], want,
                                           decode_flips(rd), TOL_LM_DECODE),
           "chunks": {k: [getattr(cfg, k), c]
                      for k, c in LM_SSM_CHUNKS.items()},
           "chunk_invariance": _routed_vs(chunked[..., :v], full[..., :v],
                                          flips(rc, s), TOL_LM_CHUNK)}
    for name, layers in faults.items():
        fault, rf = runs[name]
        where = "every layer" if layers is None else f"layer {min(layers)}"
        out[name] = {
            "fault": f"decode with `{fault_key}` zeroed at {where} before "
                     "each step",
            **_routed_vs(fault[..., :v], want, decode_flips(rf),
                         TOL_LM_DECODE)}
        check(not out[name]["ok"],
              f"the decode bound passes a planted fault: {out[name]}")
    if nm:
        check(not out["planted_fault_last_layer"]["logits_ok"],
              "the logit bound passes the last-layer fault: "
              f"{out['planted_fault_last_layer']}")
    for key in ("prefill_vs_train", "decode_vs_teacher", "chunk_invariance"):
        check(out[key]["ok"], f"lm_ssm_vs_plain {arch} {key}: {out[key]}")
    return out


def _jamba_bf16(model, cfg, seed: int) -> dict:
    """jamba's LM_SSM_LAYERS layers in bf16 over one request of
    LM_SSM_PLAIN_S tokens: the train-mode logits with the flash kernel
    (wgmma) against the same model with the kernel call swapped for its
    plain version, within TOL_LM_BF16 over the tokens whose routing did
    not flip (at most FLIP_SHARE_MAX), the kernel held per element on the
    model's own q/k/v. A GQA head-mapping fault (`_PlainFlash` with K/V
    heads tiled) is read and reported, not gated: jamba's random weights
    under the reference's init rule give its Mamba layers outputs that
    dwarf the attention layer's in the residual stream (its inputs ~45 in
    scale), so the logits hardly see attention (the fault read 2.0e-3 of
    max|logits| against 2^-5 on an H100 80GB HBM3 at 700 W); the
    kernel is held per element inside the model instead."""
    from repro_torch.models import transformer

    tokens = _lm_tokens(np.random.default_rng(seed), cfg, 1, LM_SSM_PLAIN_S)
    n_attn, v = _attn_layers(cfg), cfg.vocab_size
    reset_counts()
    with _RoutingLog() as rk, _FlashCheck(range(n_attn)) as chk:
        full, aux, _ = transformer.forward(cfg, model, tokens, mode="train")
    counts = read_counts()
    check(counts["flash_attn_routes"] == {"wgmma": n_attn, "fma": 0}
          and counts["natsa_mp"] == 0,
          f"lm_ssm_vs_plain kernel launches {counts}")
    check(chk.ok(), f"in-model flash vs plain: {chk.results}")
    with _PlainFlash(), _RoutingLog() as rp:
        plain, _, _ = transformer.forward(cfg, model, tokens, mode="train")
    with _PlainFlash(kv_heads=cfg.n_kv_heads), _RoutingLog() as rf:
        fault, _, _ = transformer.forward(cfg, model, tokens, mode="train")
    check(read_counts() == counts, "the plain run launched a kernel")
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "seq_len": LM_SSM_PLAIN_S, "counts": counts,
           "in_model_vs_plain": chk.results, "aux": float(aux),
           "logits_finite": _finite(full),
           "train_vs_plain": _routed_vs(
               full[..., :v], plain[..., :v],
               _flipped(rk.stacked(), rp.stacked()), TOL_LM_BF16)}
    out["gqa_fault_reading"] = {
        "fault": "K/V heads tiled, not interleaved (query head j reads KV "
                 "head j % n_kv_heads); reported, not gated",
        **_routed_vs(fault[..., :v], plain[..., :v],
                     _flipped(rf.stacked(), rp.stacked()), TOL_LM_BF16)}
    check(out["logits_finite"], "jamba bf16 logits not finite")
    check(out["train_vs_plain"]["ok"],
          f"lm_ssm_vs_plain jamba train_vs_plain: {out['train_vs_plain']}")
    return out


def phase_lm_ssm_vs_plain() -> dict:
    """rwkv6-3b and jamba-v0.1-52b at full width, LM_SSM_LAYERS layers
    each (jamba's: four Mamba layers, two of them MoE, and the attention
    layer at index 4): jamba in bf16 through the flash kernel against its
    plain version (`_jamba_bf16`), then `_ssm_f32` on both, jamba's on the
    same weights."""
    import torch

    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(LM_JAMBA_ARCH),
                              n_layers=LM_SSM_LAYERS[LM_JAMBA_ARCH])
    out = {"phase": "lm_ssm_vs_plain", "card": torch.cuda.get_device_name(0),
           **_lm_setup()}
    with torch.no_grad():
        model = _lm_model(cfg, SEED + 80)
        out["jamba_bf16"] = _jamba_bf16(model, cfg, SEED + 81)
        out["f32"] = [_ssm_f32(LM_RWKV_ARCH, SEED + 82),
                      _ssm_f32(LM_JAMBA_ARCH, SEED + 84, model)]
        del model
    out["counts"] = {"jamba_bf16": out["jamba_bf16"]["counts"],
                     **{f"{r['arch']}_f32": r["counts"] for r in out["f32"]}}
    emit(out)
    return out


def _zero_cross(layer: int):
    """A planted fault for `_lm_decode_run`: before each step, the cross
    K/V (`ck`, `cv`) of decoder layer `layer` set to 0, so its cross
    sublayer adds nothing (softmax weights times zero values, and `wo`
    has no bias)."""
    def fault(cache):
        cache[layer]["ck"].zero_()
        cache[layer]["cv"].zero_()
    return fault


def _encdec_f32(cfg, model, seed: int) -> dict:
    """One of whisper-large-v3 and qwen2-vl-2b at full width,
    LM_ENCDEC_LAYERS layers (whisper's encoder too), f32 compute over its
    bf16 weights, one request of LM_ENCDEC_F32_S tokens (whisper with its
    frames; qwen2-vl over `_mrope_positions` whose last LM_ENCDEC_DECODE
    positions are text, t = h = w, as decode rotates a new token):
    prefill against train and decode against teacher forcing (the last
    LM_ENCDEC_DECODE tokens after a prefill of the rest) within
    TOL_LM_DECODE. A planted fault must fail that logit bound itself:
    whisper decoding with the last decoder layer's cross K/V zeroed before
    each step; qwen2-vl's train logits with its M-RoPE sections permuted
    (t, h, w's bands (16, 24, 24) read as (24, 24, 16))."""
    import torch

    from repro_torch.models import transformer

    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    s, t, v = LM_ENCDEC_F32_S, LM_ENCDEC_DECODE, cfg.vocab_size
    rng = np.random.default_rng(seed)
    tokens = _lm_tokens(rng, cfg, 1, s)
    ex = _lm_extras(cfg, 1, s, rng, text_tail=t)
    reset_counts()
    full, _, _ = transformer.forward(cfg, model, tokens, mode="train", **ex)
    pre, _, _ = transformer.forward(cfg, model, tokens, mode="prefill", **ex)
    dec = _lm_decode_run(cfg, model, tokens, s - t, extras=ex)
    counts = read_counts()
    check(counts["flash_attn_routes"] == {"wgmma": 0,
                                          "fma": 3 * _flash_calls(cfg)}
          and counts["natsa_mp"] == 0, f"{cfg.name} f32 launches {counts}")
    want = full[:, s - t:, :v]
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers, "seq_len": s,
           "decode_steps": t, "counts": counts,
           "prefill_vs_train": _logits_vs(pre[..., :v], full[..., :v],
                                          TOL_LM_DECODE),
           "decode_vs_teacher": _logits_vs(dec[..., :v], want,
                                           TOL_LM_DECODE)}
    if cfg.is_encdec:
        last = cfg.n_layers - 1
        fault = _lm_decode_run(cfg, model, tokens, s - t, extras=ex,
                               before_step=_zero_cross(last))
        out["planted_fault"] = {
            "fault": f"decode with the cross K/V of layer {last} zeroed "
                     "before each step",
            **_logits_vs(fault[..., :v], want, TOL_LM_DECODE)}
    else:
        sec = cfg.mrope_sections
        bad = dataclasses.replace(cfg, mrope_sections=(*sec[1:], sec[0]))
        fault, _, _ = transformer.forward(bad, model, tokens, mode="train",
                                          **ex)
        out["planted_fault"] = {
            "fault": f"M-RoPE sections {bad.mrope_sections} for {sec}",
            **_logits_vs(fault[..., :v], full[..., :v], TOL_LM_DECODE)}
    check(not out["planted_fault"]["ok"],
          f"the logit bound passes a planted fault: {out['planted_fault']}")
    for key in ("prefill_vs_train", "decode_vs_teacher"):
        check(out[key]["ok"], f"lm_encdec_vs_plain {cfg.name} {key}: "
                              f"{out[key]}")
    return out


def _encdec_bf16(cfg, model, seed: int) -> dict:
    """The same model in bf16 over one request of LM_ENCDEC_PLAIN_S
    tokens: the train-mode logits with the flash kernel (wgmma: whisper's
    encoder bidirectional over 1500 frames at head dim 64, its decoder
    causal; qwen2-vl causal at 12 query heads over 2 KV heads) against the
    same model with the kernel call swapped for its plain version, within
    TOL_LM_BF16, every flash call held per element on the model's own
    q/k/v. qwen2-vl's GQA head-mapping fault (`_PlainFlash` with K/V heads
    tiled) must exceed the bound; whisper has as many K/V heads as query
    heads, so no such fault exists for it."""
    from repro_torch.models import transformer

    s, v = LM_ENCDEC_PLAIN_S, cfg.vocab_size
    rng = np.random.default_rng(seed)
    tokens = _lm_tokens(rng, cfg, 1, s)
    ex = _lm_extras(cfg, 1, s, rng)
    n = _flash_calls(cfg)
    reset_counts()
    with _FlashCheck(range(n)) as chk:
        full, _, _ = transformer.forward(cfg, model, tokens, mode="train",
                                         **ex)
    counts = read_counts()
    check(counts["flash_attn_routes"] == {"wgmma": n, "fma": 0}
          and counts["natsa_mp"] == 0,
          f"lm_encdec_vs_plain {cfg.name} kernel launches {counts}")
    check(chk.ok(), f"in-model flash vs plain: {chk.results}")
    with _PlainFlash():
        plain, _, _ = transformer.forward(cfg, model, tokens, mode="train",
                                          **ex)
    check(read_counts() == counts, "the plain run launched a kernel")
    out = {"arch": cfg.name, "seq_len": s, "counts": counts,
           "in_model_vs_plain": chk.results,
           "train_vs_plain": _logits_vs(full[..., :v], plain[..., :v],
                                        TOL_LM_BF16)}
    if cfg.n_kv_heads != cfg.n_heads:
        with _PlainFlash(kv_heads=cfg.n_kv_heads):
            fault, _, _ = transformer.forward(cfg, model, tokens,
                                              mode="train", **ex)
        out["planted_fault"] = {"fault": "K/V heads tiled, not interleaved "
                                         "(query head j reads KV head "
                                         "j % n_kv_heads)",
                                **_logits_vs(fault[..., :v], plain[..., :v],
                                             TOL_LM_BF16)}
        check(not out["planted_fault"]["ok"],
              f"the bound passes a planted fault: {out['planted_fault']}")
    check(out["train_vs_plain"]["ok"],
          f"lm_encdec_vs_plain {cfg.name} bf16: {out['train_vs_plain']}")
    return out


def phase_lm_encdec_vs_plain() -> dict:
    """whisper-large-v3 and qwen2-vl-2b at full width, LM_ENCDEC_LAYERS
    layers (whisper's encoder too), weights drawn on the card from the
    seed: `_encdec_bf16`, then `_encdec_f32` on the same weights."""
    import torch

    from repro_torch import configs

    out = {"phase": "lm_encdec_vs_plain",
           "card": torch.cuda.get_device_name(0), **_lm_setup()}
    with torch.no_grad():
        for arch, seed in ((LM_WHISPER_ARCH, SEED + 110),
                           (LM_QWEN_VL_ARCH, SEED + 114)):
            cfg = dataclasses.replace(
                configs.get_config(arch), n_layers=LM_ENCDEC_LAYERS,
                encoder_layers=LM_ENCDEC_LAYERS if arch == LM_WHISPER_ARCH
                else 0)
            model = _lm_model(cfg, seed)
            out[arch] = {"bf16": _encdec_bf16(cfg, model, seed + 1),
                         "f32": _encdec_f32(cfg, model, seed + 2)}
            del model
            torch.cuda.empty_cache()
    emit(out)
    return out


def _grad_ratio(got, plain) -> float:
    """max over elements of |got - plain| / (2^-7 |plain| + 2^-14
    max|plain|): at most 1 when the gradients agree within the bound."""
    g, p = got.float(), plain.float()
    return float(((g - p).abs() / (GRAD_REL * p.abs() + GRAD_ABS_OF_MAX
                                   * float(p.abs().max()))).max())


class _FlashGradCheck:
    """Wraps `flash_attn.flash_attention` while active and keeps the q, k,
    v of the calls numbered in `calls` (0 is the first). `results()` then
    holds the flash Function's dq, dk, dv for a seeded bf16 dout against
    autograd through `flash_attention_plain` on the same tensors, and the
    same for a planted fault (head 0's causal mask dropped from the
    backward), which must fail. Call it after the path's launches are read:
    its own forward launches the kernel again."""

    def __init__(self, calls):
        from repro_torch.kernels import flash_attn

        self.mod, self.real, self.calls = flash_attn, None, set(calls)
        self.n, self.kept = 0, []

    def __enter__(self):
        self.real = self.mod.flash_attention

        def keep(q, k, v, **kw):
            if self.n in self.calls:
                self.kept.append((self.n, q.detach(), k.detach(), v.detach(),
                                  kw))
            self.n += 1
            return self.real(q, k, v, **kw)

        self.mod.flash_attention = keep
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.real

    def results(self) -> list[dict]:
        import torch

        fa, out = self.mod, []
        for n, q, k, v, kw in self.kept:
            causal = kw.get("causal", True)
            gen = torch.Generator(q.device).manual_seed(SEED + 50 + n)
            dout = torch.randn(q.shape, generator=gen, device=q.device,
                               dtype=torch.float32).to(q.dtype)
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            o = fa.flash_attention(*leaves, **kw)
            fn = type(o.grad_fn).__name__
            got = torch.autograd.grad(o, leaves, dout)
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            plain = torch.autograd.grad(
                fa.flash_attention_plain(*leaves, causal=causal), leaves,
                dout)
            bad = [g.clone() for g in got]
            one = fa.flash_attention_backward_plain(
                *(x[:1, :1].contiguous() for x in (q, k, v, dout)), False)
            for b, g in zip(bad, one):
                b[:1, :1] = g
            out.append({"call": n, "shape": list(q.shape), "grad_fn": fn,
                        **{f"d{x}_ratio": _grad_ratio(g, pl)
                           for x, g, pl in zip("qkv", got, plain)},
                        **{f"d{x}_max_abs_err": float(
                            (g.float() - pl.float()).abs().max())
                           for x, g, pl in zip("qkv", got, plain)},
                        "planted_fault": {
                            "fault": "head 0's causal mask dropped from "
                                     "the backward",
                            **{f"d{x}_ratio": _grad_ratio(b, pl)
                               for x, b, pl in zip("qkv", bad, plain)}}})
            del got, plain, bad, leaves
        return out

    @staticmethod
    def ok(results) -> bool:
        return all(r["grad_fn"] == "_FlashFunctionBackward"
                   and max(r[f"d{x}_ratio"] for x in "qkv") <= 1.0
                   and max(r["planted_fault"][f"d{x}_ratio"]
                           for x in "qkv") > 1.0 for r in results)


class _BackwardTimer:
    """Wraps `flash_attn.flash_attention_backward_plain` (what the flash
    Function's backward calls) in CUDA events while active."""

    def __init__(self):
        from repro_torch.kernels import flash_attn

        self.mod, self.real, self.events = flash_attn, None, []

    def __enter__(self):
        import torch

        self.real = self.mod.flash_attention_backward_plain

        def timed(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self.real(*a, **kw)
            ev[1].record()
            self.events.append(ev)
            return out

        self.mod.flash_attention_backward_plain = timed
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention_backward_plain = self.real

    def ms(self) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.events]


class _DetachedFlash:
    """A planted fault: the kernel's output cut off from autograd, as
    `flash_attention` was before its Function (q, k and v get no gradient
    through attention)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attn

        self.mod, self.real = flash_attn, flash_attn.flash_attention
        real = self.real

        def detached(q, k, v, **kw):
            return real(q.detach(), k.detach(), v.detach(), **kw)

        flash_attn.flash_attention = detached
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.real


def _train_batch(cfg, b: int, s: int, step: int, seed: int):
    """`TokenStream`'s batch `step` on the card."""
    import torch

    from repro_torch.data.pipeline import TokenStream, TokenStreamConfig

    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=seed))
    return {k: torch.from_numpy(v).to(DEVICE)
            for k, v in stream.batch(step).items()}


def _train_opt():
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=1,
                             total_steps=100)


def _one_train_step(cfg, batch, mb: int, seed: int, swap=None) -> dict:
    """A fresh model from `seed` and one train step, under `swap` (a
    context replacing the flash call) if given: the metrics, each leaf's
    m (the step's gradient) and move (new - old, f32) on the card."""
    import contextlib

    import torch

    from repro_torch.models import steps
    from repro_torch.optim import adamw

    model = _lm_model(cfg, seed)
    old = {k: p.detach().float() for k, p in adamw.leaves(model).items()}
    state = adamw.init_state(model)
    with swap if swap is not None else contextlib.nullcontext():
        _, state, met = steps.make_train_step(cfg, None, _train_opt(),
                                              microbatches=mb)(
            model, state, batch)
    torch.cuda.synchronize()
    out = {"metrics": {k: float(v) for k, v in met.items()},
           "m": adamw.leaves(state["m"]),
           "move": {k: p.detach().float() - old[k]
                    for k, p in adamw.leaves(model).items()}}
    del model, state
    torch.cuda.empty_cache()
    return out


def _rel_l2(a, b) -> float:
    den = float(b.double().norm())
    return float((a.double() - b.double()).norm()) / max(den, 1e-30)


def _train_vs(got: dict, want: dict, tol: dict) -> dict:
    """Loss and grad norm relative, each leaf's m and move in relative
    L2 (their maxima over the leaves, and which leaf), against `tol`."""
    out = {}
    for key in ("loss", "grad_norm"):
        g, w = got["metrics"][key], want["metrics"][key]
        out[key] = {"got": g, "want": w, "rel": abs(g - w) / abs(w)}
    for key, name in (("m", "m_rel_l2"), ("move", "update_rel_l2")):
        rel = {p: _rel_l2(got[key][p], want[key][p]) for p in want[key]}
        worst = max(rel, key=rel.get)
        out[name] = {"max": rel[worst], "leaf": worst,
                     "median": float(np.median(list(rel.values())))}
    out["tol"] = tol
    out["ok"] = (out["loss"]["rel"] <= tol["loss"]
                 and out["grad_norm"]["rel"] <= tol["grad_norm"]
                 and out["m_rel_l2"]["max"] <= tol["m_rel_l2"]
                 and out["update_rel_l2"]["max"] <= tol["update_rel_l2"])
    return out


def phase_lm_train_vs_plain() -> dict:
    """llama3-8b at full width, 2 layers, 2 sequences of 4096 as 2
    microbatches: one train step through the flash kernel against the same
    step with the kernel call swapped for its plain version (autograd
    through it), in bf16 (wgmma) and f32 (fma); a planted fault (the
    kernel's output cut off from autograd) must fail the same bounds."""
    import dataclasses

    import torch

    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(LM_ARCH),
                              n_layers=LM_PLAIN_LAYERS)
    b, s, mb = LM_TRAIN_PLAIN_B, LM_TRAIN_S, LM_TRAIN_PLAIN_MB
    batch = _train_batch(cfg, b, s, 0, SEED + 46)
    out = {"phase": "lm_train_vs_plain",
           "card": torch.cuda.get_device_name(0), "arch": cfg.name,
           "layers": cfg.n_layers, "batch": b, "seq_len": s,
           "microbatches": mb, "remat": cfg.remat, **_lm_setup()}
    want_launches = 2 * cfg.n_layers * mb        # forward and recompute
    for dt, route in ((torch.bfloat16, "wgmma"), (torch.float32, "fma")):
        c = dataclasses.replace(cfg, dtype=dt)
        name = str(dt).removeprefix("torch.")
        reset_counts()
        kern = _one_train_step(c, batch, mb, SEED + 47)
        counts = read_counts()
        check(counts["flash_attn_routes"] == {
            "wgmma": want_launches if route == "wgmma" else 0,
            "fma": want_launches if route == "fma" else 0}
            and counts["natsa_mp"] == 0,
            f"lm_train_vs_plain {name} launches {counts}")
        plain = _one_train_step(c, batch, mb, SEED + 47, _PlainFlash())
        check(read_counts() == counts, "the plain run launched a kernel")
        res = _train_vs(kern, plain, TOL_TRAIN[name])
        res["counts"] = counts
        res["loss"]["finite"] = bool(np.isfinite(kern["metrics"]["loss"]))
        if dt == torch.bfloat16:
            fault = _one_train_step(c, batch, mb, SEED + 47,
                                    _DetachedFlash())
            res["planted_fault"] = {
                "fault": "the kernel's output cut off from autograd",
                **_train_vs(fault, plain, TOL_TRAIN[name])}
            check(not res["planted_fault"]["ok"],
                  f"the train bounds pass a planted fault: "
                  f"{res['planted_fault']}")
            del fault
        out[name] = res
        check(res["ok"] and res["loss"]["finite"],
              f"lm_train_vs_plain {name}: {res}")
        del kern, plain
    emit(out)
    return out


def _moved(before: dict, model) -> dict:
    """For each sampled leaf, whether any of its sampled elements moved."""
    from repro_torch.optim import adamw

    now = adamw.leaves(model)
    return {k: bool((now[k].detach()[tuple(slice(0, 64) for _ in v.shape)]
                     != v).any()) for k, v in before.items()}


def phase_lm_train() -> dict:
    """llama3-8b at its published width, LM_TRAIN_LAYERS layers, remat on:
    train_4k cut to 16 sequences of 4096 as 8 microbatches of 2, through
    `make_train_step` and AdamW on the card. The warm step holds the flash
    Function's gradients at layers 0 and last against autograd through the
    plain version on the model's own q/k/v (with a planted fault) and
    checks the exact flash launches (2 per layer per microbatch: the
    forward and the recompute, all wgmma) and that every sampled leaf
    moved; LM_TRAIN_STEPS timed steps follow (the flash calls and the plain
    backward by CUDA events), then a traced one."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import flash_attn
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    from repro_torch.utils import flops

    cfg = dataclasses.replace(configs.get_config(LM_ARCH),
                              n_layers=LM_TRAIN_LAYERS)
    check(cfg.remat, "full configs train with remat")
    b, s, mb = LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_MB
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_bytes, total_bytes = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    model = _lm_model(cfg, SEED + 48)
    state = adamw.init_state(model)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    step = steps.make_train_step(cfg, None, _train_opt(), microbatches=mb)
    batches = [_train_batch(cfg, b, s, i, SEED + 49)
               for i in range(LM_TRAIN_STEPS + 2)]
    sample = {k: p.detach()[tuple(slice(0, 64) for _ in p.shape)].clone()
              for k, p in adamw.leaves(model).items()
              if k.startswith(("emb", "ln_f", "layers.0.",
                               f"layers.{cfg.n_layers - 1}."))}
    reset_counts()
    with _FlashGradCheck((0, cfg.n_layers - 1)) as chk:
        t0 = time.perf_counter()
        _, _, met = step(model, state, batches[0])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    counts = read_counts()
    want = 2 * cfg.n_layers * mb
    check(counts["flash_attn_routes"] == {"wgmma": want, "fma": 0}
          and counts["natsa_mp"] == 0,
          f"train step launches {counts}, want {want} wgmma")
    moved = _moved(sample, model)
    losses = [float(met["loss"])]
    gnorms = [float(met["grad_norm"])]
    check(np.isfinite(losses[0]) and gnorms[0] > 0 and all(moved.values()),
          f"first step: loss {losses[0]}, grad norm {gnorms[0]}, "
          f"unmoved {[k for k, v in moved.items() if not v]}")
    grads = chk.results()
    check(len(grads) == 2 and _FlashGradCheck.ok(grads),
          f"in-model flash gradients vs plain: {grads}")
    step_s, flash_ms, bwd_ms = [], [], []
    for i in range(LM_TRAIN_STEPS):
        with _CallTimer(flash_attn, "flash_attention") as ft, \
                _BackwardTimer() as bt:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, met = step(model, state, batches[1 + i])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        flash_ms.append(sum(ft.ms()))
        bwd_ms.append(sum(bt.ms()))
        check(len(ft.ms()) == want and len(bt.ms()) == cfg.n_layers * mb,
              "the timed step's flash calls")
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    med = float(np.median(step_s))
    trace = _device_time(lambda: step(model, state, batches[-1]), 1)
    if trace["device_ms_per_call"] is not None:
        trace["idle_share"] = 1 - trace["device_ms_per_call"] / (1e3 * med)
    check(all(np.isfinite(losses)) and min(gnorms) > 0
          and int(state["step"]) == LM_TRAIN_STEPS + 2,
          f"losses {losses}, grad norms {gnorms}")
    shape = ShapeSpec(f"train_4k_b{b}", s, b, "train")
    mf = flops.model_flops(cfg, shape)
    bound_s = mf["total"] / BF16_PEAK
    out = {"phase": "main_lm_train", "card": torch.cuda.get_device_name(0),
           "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": "bfloat16",
           "remat": cfg.remat, "global_batch": b, "seq_len": s,
           "microbatches": mb, **_lm_setup(),
           "params": flops.param_counts(cfg)["total"],
           "state_bytes": state_bytes, "counts": counts,
           "flash_launches": counts["flash_attn"],
           "launches_by_route": counts["flash_attn_routes"],
           "in_model_grads_vs_plain": grads, "moved": moved,
           "first_step_s": first_s, "train_step_s": step_s,
           "train_step_s_median": med, "train_step_s_max": max(step_s),
           "tokens_per_s": b * s / med, "losses": losses,
           "grad_norms": gnorms, "peak_device_bytes": peak,
           "peak_reserved_bytes": peak_reserved,
           "free_bytes_before": free_bytes, "total_bytes": total_bytes,
           "model_flops": mf, "bound_s": bound_s, "bound_by": "operations",
           "share_of_bound": bound_s / med,
           "flash_ms_in_step": flash_ms,
           "flash_ms_per_launch": float(np.median(flash_ms)) / want,
           "plain_backward_ms_in_step": bwd_ms,
           "plain_backward_ms_per_call": float(np.median(bwd_ms))
           / (cfg.n_layers * mb),
           "flash_share": float(np.median(flash_ms)) / (1e3 * med),
           "plain_backward_share": float(np.median(bwd_ms)) / (1e3 * med),
           "trace": trace}
    emit(out)
    del model, state, batches
    torch.cuda.empty_cache()
    return out


class _PlantedCrash(Exception):
    pass


class _CrashAt:
    """`launch.train`'s TokenStream raises at `step` while active: a run
    killed after its checkpoint of that step."""

    def __init__(self, step: int):
        self.step = step

    def __enter__(self):
        from repro_torch.launch import train

        self.cls = train.TokenStream
        self.real, at = self.cls.batch, self.step

        def batch(this, s, **kw):
            if s == at:
                raise _PlantedCrash(f"planted crash at step {s}")
            return self.real(this, s, **kw)

        self.cls.batch = batch
        return self

    def __exit__(self, *exc):
        self.cls.batch = self.real


def phase_lm_train_cli() -> dict:
    """`launch.train.main` at `--smoke` on the card: 4 steps straight, and
    4 steps killed after the checkpoint of step 2 then resumed; the
    resumed run's final loss within 1e-4 of the straight one (bit for bit
    reported: the embedding's backward accumulates with atomics)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import train

    tmp = tempfile.mkdtemp(prefix="train_")
    argv = ["--arch", LM_ARCH, "--smoke", "--steps", "4", "--batch", "8",
            "--seq", "128", "--ckpt-every", "2", "--log-every", "1",
            "--device", DEVICE]
    log = io.StringIO()
    try:
        reset_counts()
        with contextlib.redirect_stdout(log):
            t0 = time.perf_counter()
            straight = train.main(argv + ["--ckpt-dir", f"{tmp}/a"])
            straight_s = time.perf_counter() - t0
            try:
                with _CrashAt(2):
                    train.main(argv + ["--ckpt-dir", f"{tmp}/b"])
                crashed = False
            except _PlantedCrash:
                crashed = True
            resumed = train.main(argv + ["--ckpt-dir", f"{tmp}/b"])
        counts = read_counts()

        def arrays(d):
            with np.load(f"{d}/step_{4:010d}/arrays.npz") as z:
                return {k: z[k].tobytes() for k in z.files}

        bitwise = arrays(f"{tmp}/a") == arrays(f"{tmp}/b")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    text = log.getvalue()
    from repro_torch import configs

    cfg = configs.get_smoke(LM_ARCH)
    want = cfg.n_layers * (4 + 2 + 2)     # remat off at smoke size: 1 a layer
    out = {"phase": "main_lm_train_cli",
           "card": torch.cuda.get_device_name(0), "argv": argv,
           "straight_loss": straight, "resumed_loss": resumed,
           "crashed_at_2": crashed,
           "resumed_from_2": "[train] resumed from step 2" in text,
           "bitwise_final_checkpoint": bitwise, "straight_s": straight_s,
           "counts": counts, "log_tail": text.splitlines()[-3:]}
    check(crashed and out["resumed_from_2"]
          and abs(straight - resumed) <= 1e-4 and np.isfinite(straight),
          f"trainer resume: {out}")
    check(counts["flash_attn_routes"] == {"wgmma": 0, "fma": want}
          and counts["natsa_mp"] == 0,
          f"trainer launches {counts}, want {want} fma")
    emit(out)
    return out


def _mesh_path(cfg, model, tokens, n: int, ctx) -> dict:
    """One prefill of `tokens` through `make_prefill_step(cfg, ctx)`, its
    cache copied into one of S + n slots, then n greedy decode steps
    through `make_decode_step(cfg, ctx)`: the last-position logits, the
    tokens, the launch counts of the prefill and of the decode, and their
    times. With a ctx the logits are gathered whole (one rank: a copy)."""
    import torch

    from repro_torch.models import steps, transformer

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    b, s = tokens.shape
    pre = steps.make_prefill_step(cfg, ctx)
    dec = steps.make_decode_step(cfg, ctx)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lg, cache = pre(model, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre_counts = read_counts()
    big = transformer.init_cache(cfg, model, b, s + n, ctx=ctx)
    for layer, pc in zip(big, cache):
        for key, t in pc.items():
            local(layer[key])[:, :s] = local(t)
    del cache
    logits = [_whole(lg)[:, -1].float()]
    toks = [steps.greedy_next(_whole(lg))]
    reset_counts()
    ms = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, big = dec(model, big, {"tokens": toks[-1], "cache_len": s + i})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(_whole(lg)[:, -1].float())
        toks.append(steps.greedy_next(_whole(lg)))
    dec_counts = read_counts()
    del big
    return {"logits": torch.stack(logits), "tokens": torch.cat(toks, 1),
            "prefill_s": prefill_s, "step_ms": float(np.median(ms)),
            "step_ms_max": max(ms), "prefill_counts": pre_counts,
            "decode_counts": dec_counts}


def phase_lm_mesh(model, cfg, seed: int = SEED + 150) -> dict:
    """main_lm_mesh: olmoe-1b-7b's full-width model (main_lm_moe's
    weights, 16 layers) served through the mesh tooling on one card: a
    one-rank NCCL group, `compat_mesh((1, 1), ("data", "model"))`, the
    weights distributed by `param_shardings`, then under the tp and ep
    layouts a prefill of LM_MESH_B x 32,768 tokens through
    `make_prefill_step(cfg, ctx)` and LM_MESH_DECODE greedy decode steps
    from its cache through `make_decode_step(cfg, ctx)`. Each holds its
    last-position logits and greedy tokens against the ctx=None path on
    the same weights BIT FOR BIT (one rank: every collective is an
    identity, so a difference is a fault), and its prefill launches the
    flash kernel once a layer on the rank's heads. `prefill_s` and
    `step_ms` with and without the ctx give the DTensor dispatch cost
    (each path warmed first); CommDebugMode counts the collectives of a
    2 x 4,096 prefill. Under each layout one train step of the smoke
    config also runs through the mesh (`_mesh_train`)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import sharding as sh
    from repro_torch.models import steps

    b, s, n = LM_MESH_B, LM_PREFILL_S, LM_MESH_DECODE
    rng = np.random.default_rng(seed)
    tokens = _lm_tokens(rng, cfg, b, s)
    steps.make_prefill_step(cfg)(model, {"tokens": tokens})   # warm-up
    torch.cuda.empty_cache()
    plain = _mesh_path(cfg, model, tokens, n, None)
    torch.cuda.empty_cache()
    mesh = lmesh.compat_mesh((1, 1), ("data", "model"))
    out = {"phase": "main_lm_mesh", "arch": cfg.name,
           "card": torch.cuda.get_device_name(0), "nvidia_smi": _smi(),
           "layers": cfg.n_layers, "batch": b, "seq_len": s,
           "decode_steps": n, "backend": dist.get_backend(),
           "mesh": {"shape": list(mesh.mesh.shape),
                    "axes": list(mesh.mesh_dim_names)},
           "plain": {k: plain[k] for k in ("prefill_s", "step_ms",
                                           "step_ms_max")}}
    saved = {k: p for k, p in model.named_parameters()}
    try:
        for layout in LM_MESH_LAYOUTS:
            ctx = sh.make_ctx(mesh, cfg, None, layout=layout)
            sh.distribute_params(model, mesh, cfg, ctx.rules)
            # a short prefill first, counted by CommDebugMode, warms the
            # path (NCCL builds its communicator at the first collective)
            with CommDebugMode() as comm:
                steps.make_prefill_step(cfg, ctx)(
                    model, {"tokens": tokens[:, :4096]})
            pre_comm = {str(k): v for k, v in
                        comm.get_comm_counts().items()}
            got = _mesh_path(cfg, model, tokens, n, ctx)
            torch.cuda.empty_cache()
            same_logits = torch.equal(got["logits"], plain["logits"])
            same_tokens = torch.equal(got["tokens"], plain["tokens"])
            check(same_logits and same_tokens,
                  f"{layout}: logits or tokens differ from ctx=None "
                  f"({(got['logits'] - plain['logits']).abs().max()})")
            check(got["prefill_counts"]["flash_attn"] == cfg.n_layers
                  and got["prefill_counts"]["flash_attn_routes"]
                  == {"wgmma": cfg.n_layers, "fma": 0},
                  f"{layout} prefill launches {got['prefill_counts']}")
            out[layout] = {
                "logits_bitwise": same_logits, "tokens_bitwise": same_tokens,
                "prefill_s": got["prefill_s"], "step_ms": got["step_ms"],
                "step_ms_max": got["step_ms_max"],
                "prefill_s_ratio": got["prefill_s"] / plain["prefill_s"],
                "step_ms_ratio": got["step_ms"] / plain["step_ms"],
                "counts": got["prefill_counts"],
                "flash_launches": got["prefill_counts"]["flash_attn"],
                "decode_counts": got["decode_counts"],
                "comm_counts_prefill_4096": pre_comm,
                "rules_experts": ctx.rules.get("experts"),
                "rules_mlp": ctx.rules.get("mlp")}
            _undistribute(model, saved)    # plain again for the next one
            out[layout]["train"] = _mesh_train(mesh, layout, seed)
    finally:
        _undistribute(model, saved)
        dist.destroy_process_group()
    emit(out)
    return out


def _mesh_train(mesh, layout: str, seed: int) -> dict:
    """One train step of LM_MOE_ARCH's smoke config (f32 weights drawn on
    the card) through `make_train_step(cfg, ctx, opt)` on the one-rank
    mesh against ctx=None on the same weights and tokens, at one warmup
    step (the full lr): loss and grad norm within 1e-5 relative, and the
    update applied to the sharded leaves: every weight's step within 1%
    of ctx=None's largest step where AdamW's first step is well
    conditioned (ctx=None's gradient at least 10 eps), and within 10%
    everywhere."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import sharding as sh
    from repro_torch.models import steps
    from repro_torch.optim import adamw

    cfg = configs.get_smoke(LM_MOE_ARCH)
    opt = adamw.AdamWConfig(warmup_steps=1)
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": _lm_tokens(rng, cfg, 4, 16),
             "labels": _lm_tokens(rng, cfg, 4, 16)}

    def model():
        m = _lm_model(cfg, seed)
        for q in m.parameters():
            q.data = q.data.float()
        return m

    m0, m1 = model(), model()
    init = {k: q.detach().clone() for k, q in m0.named_parameters()}
    st0 = adamw.init_state(m0)
    _, _, met0 = steps.make_train_step(cfg, None, opt)(m0, st0, batch)
    ctx = sh.make_ctx(mesh, cfg, None, layout=layout)
    sh.distribute_params(m1, mesh, cfg, ctx.rules)
    st1 = adamw.init_state(m1)
    _, _, met1 = steps.make_train_step(cfg, ctx, opt)(m1, st1, batch)
    p0 = dict(m0.named_parameters())
    m_flat = {}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}.")
            else:
                m_flat[f"{prefix}{k}"] = v

    flat(st0["m"])
    step = max(float((q.detach() - init[k]).abs().max())
               for k, q in p0.items())
    err = worst = 0.0
    for k, q in m1.named_parameters():
        d = (q.detach().full_tensor() - p0[k].detach()).abs()
        worst = max(worst, float(d.max()))
        keep = (m_flat[k] / (1 - opt.beta1)).abs() >= 10 * opt.eps
        if keep.any():
            err = max(err, float(d[keep].max()))
    l0, l1 = float(met0["loss"]), float(met1["loss"].full_tensor())
    g0 = float(met0["grad_norm"])
    g1 = float(met1["grad_norm"].full_tensor())
    check(abs(l1 - l0) <= 1e-5 * (1 + abs(l0))
          and abs(g1 - g0) <= 1e-5 * (1 + abs(g0)),
          f"{layout} train: loss {l1} vs {l0}, grad norm {g1} vs {g0}")
    check(step > 1e-4 and err <= 1e-2 * step and worst <= 0.1 * step,
          f"{layout} train: update {err} / {worst} against a step of "
          f"{step}")
    return {"arch": cfg.name, "loss": [l0, l1], "grad_norm": [g0, g1],
            "max_step": step, "update_err": err, "param_err": worst}


def _undistribute(model, saved: dict) -> None:
    """Put the model's plain parameters back (the DTensors share their
    storage, so nothing is copied)."""
    for path, p in saved.items():
        *mods, name = path.split(".")
        mod = model
        for m in mods:
            mod = mod[int(m)] if m.isdigit() else getattr(mod, m)
        mod._parameters[name] = p


def _one_rank_mesh():
    """A (1, 1) ("data", "model") mesh over the one-rank NCCL group (which
    `compat_mesh` starts where none is up)."""
    from repro_torch.launch import mesh as lmesh

    return lmesh.compat_mesh((1, 1), ("data", "model"))


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _sp_prefill(cfg, model, batch, ctx) -> dict:
    """One prefill through `make_prefill_step(cfg, ctx)`, counted and
    timed: its last-position logits and its cache, whole."""
    import torch

    from repro_torch.models import steps

    step = steps.make_prefill_step(cfg, ctx)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lg, cache = step(model, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = read_counts()
    return {"logits": _whole(lg), "prefill_s": prefill_s, "counts": counts,
            "cache": [{k: _whole(t) for k, t in layer.items()}
                      for layer in cache]}


def phase_lm_sp(model, cfg, seed: int, *, keep: bool = False) -> dict:
    """main_lm_sp: one request of LM_SP_S tokens (with whisper's frames)
    through `make_prefill_step(cfg)` and then through the one-rank mesh
    under `layout="sp"` (the weights distributed by `param_shardings`, a
    short prefill first to warm the path), bit for bit: the last-position
    logits, the greedy token and every cache leaf; LM_SP_FLASH[arch] wgmma
    flash launches a prefill; `prefill_s` of both. With `keep`, the
    ctx=None prefill's logits and cache come back too (main_lm_long tiles
    them)."""
    import torch

    from repro_torch.launch import sharding as sh
    from repro_torch.models import steps

    s = LM_SP_S
    rng = np.random.default_rng(seed)
    tokens, extras = _lm_tokens(rng, cfg, 1, s), _lm_extras(cfg, 1, s, rng)
    batch = {"tokens": tokens, **extras}
    plain = _sp_prefill(cfg, model, batch, None)
    mesh = _one_rank_mesh()
    ctx = sh.make_ctx(mesh, cfg, None, layout="sp")
    saved = dict(model.named_parameters())
    sh.distribute_params(model, mesh, cfg, ctx.rules)
    try:
        warm = {"tokens": tokens[:, :LM_SP_WARM],
                **_rows(extras, slice(None), slice(0, LM_SP_WARM))}
        steps.make_prefill_step(cfg, ctx)(model, warm)
        got = _sp_prefill(cfg, model, batch, ctx)
    finally:
        _undistribute(model, saved)
    torch.cuda.empty_cache()
    same_logits = torch.equal(got["logits"], plain["logits"])
    same_token = torch.equal(steps.greedy_next(got["logits"]),
                             steps.greedy_next(plain["logits"]))
    leaves = [(i, k) for i, layer in enumerate(plain["cache"])
              for k in layer]
    differ = [f"{i}.{k}" for i, k in leaves
              if not torch.equal(got["cache"][i][k], plain["cache"][i][k])]
    want = LM_SP_FLASH[cfg.name]
    out = {"phase": "main_lm_sp", "arch": cfg.name, "layers": cfg.n_layers,
           "card": torch.cuda.get_device_name(0), "nvidia_smi": _smi(),
           "batch": 1, "seq_len": s, "layout": "sp",
           "logits_bitwise": same_logits, "token_bitwise": same_token,
           "cache_leaves": len(leaves), "cache_leaves_differ": differ,
           "max_abs_logit_diff": float((got["logits"].float()
                                        - plain["logits"].float())
                                       .abs().max()),
           "plain_prefill_s": plain["prefill_s"],
           "prefill_s": got["prefill_s"],
           "prefill_s_ratio": got["prefill_s"] / plain["prefill_s"],
           "counts": got["counts"], "plain_counts": plain["counts"],
           "flash_launches": got["counts"]["flash_attn"]}
    emit(out)
    check(same_logits and same_token and not differ,
          f"{cfg.name} sp prefill differs from ctx=None: logits "
          f"{out['max_abs_logit_diff']}, cache leaves {differ[:8]}")
    check(got["counts"]["flash_attn_routes"] == {"wgmma": want, "fma": 0}
          and got["counts"]["natsa_mp"] == 0
          and plain["counts"] == got["counts"],
          f"{cfg.name} sp prefill launches {got['counts']}, want {want}")
    if keep:
        out["kept"] = plain
    return out


def _tile_cache(cfg, cache, pre) -> None:
    """The prefill cache `pre` (p slots) into `cache` (S = r · p slots,
    local tensors): each sequence leaf's K/V repeated r times along the
    sequence, a state leaf whole."""
    from repro_torch.models import transformer

    for i, (layer, pc) in enumerate(zip(cache, pre)):
        spec = transformer.layer_cache_spec(cfg, cfg.layer_kind(i), 1, 1)
        for key, t in pc.items():
            dst = layer[key].to_local() if hasattr(layer[key], "to_local") \
                else layer[key]
            if _leaf_kind(spec[key]) == "seq":
                p = t.shape[1]
                dst.unflatten(1, (dst.shape[1] // p, p)).copy_(
                    t.unsqueeze(1))
            else:
                dst.copy_(t)


def _long_decode(cfg, model, pre, first, ctx, tokens=None) -> dict:
    """LM_LONG_STEPS greedy decode steps over a cache of the long_500k
    slots tiled from `pre` (`_tile_cache`), from token `first`, the last
    LM_LONG_STEPS slots written; with `tokens` the steps take those
    tokens (teacher-forced) instead of their own picks. A step over a
    small cache first warms the path. Per step: the logits (f32) and ms;
    the launch counts of the steps."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.models import steps, transformer

    slots, n = SHAPES["long_500k"].seq_len, LM_LONG_STEPS
    dec = steps.make_decode_step(cfg, ctx)
    small = transformer.init_cache(cfg, model, 1, 4096, ctx=ctx)
    dec(model, small, {"tokens": first, "cache_len": 0})
    del small
    cache = transformer.init_cache(cfg, model, 1, slots, ctx=ctx)
    _tile_cache(cfg, cache, pre)
    torch.cuda.synchronize()
    reset_counts()
    nxt, logits, picks, ms = first, [], [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = dec(model, cache, {"tokens": nxt,
                                       "cache_len": slots - n + i})
        lg = _whole(lg)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(lg[:, -1].float())
        picks.append(steps.greedy_next(lg))
        nxt = picks[-1] if tokens is None else tokens[:, i:i + 1]
    counts = read_counts()
    placements = (str(tuple(cache[_first_attn(cfg)]["k"].placements))
                  if ctx is not None else None)
    del cache
    return {"logits": torch.cat(logits), "picks": torch.cat(picks, 1),
            "step_ms": ms, "counts": counts, "k_placements": placements}


def _first_attn(cfg) -> int:
    return next(i for i in range(cfg.n_layers)
                if cfg.layer_kind(i).mixer == "attn")


class _MergeCount:
    """Counts `parallel.softmax_merge` calls while active (the flip's
    log-sum-exp merge, one per attention layer per decode step)."""

    def __init__(self):
        self.n, self.real = 0, None

    def __enter__(self):
        from repro_torch.models import parallel

        self.real = parallel.softmax_merge

        def counted(lg, group):
            self.n += 1
            return self.real(lg, group)

        parallel.softmax_merge = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import parallel

        parallel.softmax_merge = self.real


def phase_lm_long(model, cfg, kept: dict) -> dict:
    """main_lm_long: jamba-v0.1-52b's long_500k decode (batch 1, 524,288
    slots) at 16 layers on main_lm_jamba's weights, under the SP decode
    flip's rule table on the one-rank NCCL mesh (`make_ctx`'s table with
    `batch` None and `kv_seq` "data", which one rank cannot reach by the
    rule: global batch 1 is not below 1 data rank), against ctx=None: the
    cache tiled from main_lm_sp's ctx=None prefill (`kept`; not a
    524,288-token prefill), LM_LONG_STEPS greedy steps on ctx=None, the
    flip path fed the same tokens; every step's logits within TOL_LM_BF16
    of max|logits|, greedy picks differing only at near-ties; the flip's
    merge ran at both attention layers every step (its cache's K/V split
    on the sequence over "data", `Shard(1)`); `step_ms` (median, max) of
    both beside the bound from `hbm_bytes_floor` at long_500k (3.35 TB/s);
    `peak_device_bytes` over both runs; no kernel launch."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.launch import sharding as sh
    from repro_torch.models import steps
    from repro_torch.utils import flops

    shape = SHAPES["long_500k"]
    pre, first = kept["cache"], steps.greedy_next(kept["logits"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain = _long_decode(cfg, model, pre, first, None)
    torch.cuda.empty_cache()
    mesh = _one_rank_mesh()
    ctx = sh.make_ctx(mesh, cfg, None)
    ctx = dataclasses.replace(ctx, rules=dict(ctx.rules, batch=None,
                                              kv_seq="data"))
    saved = dict(model.named_parameters())
    sh.distribute_params(model, mesh, cfg, ctx.rules)
    try:
        with _MergeCount() as merges:
            got = _long_decode(cfg, model, pre, first, ctx,
                               tokens=plain["picks"])
    finally:
        _undistribute(model, saved)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    vs = _logits_vs(got["logits"], plain["logits"], TOL_LM_BF16)
    n, attn = LM_LONG_STEPS, _attn_layers(cfg)
    floor = flops.hbm_bytes_floor(cfg, shape, 1)
    bound_ms = 1e3 * floor / HBM_RATE
    med, med0 = float(np.median(got["step_ms"])), float(np.median(
        plain["step_ms"]))
    out = {"phase": "main_lm_long", "cell": "long_500k", "arch": cfg.name,
           "layers": cfg.n_layers, "attn_layers": attn,
           "card": torch.cuda.get_device_name(0), "nvidia_smi": _smi(),
           "batch": shape.global_batch, "cache_slots": shape.seq_len,
           "steps": n, "cache": f"tiled {shape.seq_len // LM_SP_S} x "
           f"{LM_SP_S}-token prefill (not a {shape.seq_len}-token prefill)",
           "rules": {k: ctx.rules[k] for k in ("batch", "kv_seq")},
           "k_placements": got["k_placements"], "merges": merges.n,
           "vs_plain": vs, "step_ms": got["step_ms"], "step_ms_median": med,
           "step_ms_max": max(got["step_ms"]),
           "plain_step_ms": plain["step_ms"], "plain_step_ms_median": med0,
           "plain_step_ms_max": max(plain["step_ms"]),
           "step_ms_ratio": med / med0, "bound_ms": bound_ms,
           "bound_by": "bytes", "floor_bytes": floor,
           "share_of_bound": bound_ms / med,
           "kv_bytes": _cache_bytes(cfg, 1, shape.seq_len, kind="seq"),
           "peak_device_bytes": peak, "counts": got["counts"],
           "plain_counts": plain["counts"],
           "tokens": plain["picks"][0].tolist()}
    emit(out)
    check(vs["ok"], f"long_500k flip decode vs ctx=None: {vs}")
    # the merge runs at every attention layer of every step, the warm-up
    # step's too
    check(merges.n == (n + 1) * attn
          and "Shard(dim=1)" in str(got["k_placements"]),
          f"the flip's merge ran {merges.n} times (want {(n + 1) * attn}), "
          f"K placed {got['k_placements']}")
    check(got["counts"]["natsa_mp"] == 0 and got["counts"]["flash_attn"] == 0
          and bool(torch.isfinite(got["logits"]).all()),
          f"long_500k decode launches {got['counts']} / logits not finite")
    return out


def _jamba_then(model, cfg) -> dict:
    """main_lm_jamba's model, then: main_lm_sp, then main_lm_long over a
    cache tiled from main_lm_sp's ctx=None prefill."""
    sp = phase_lm_sp(model, cfg, SEED + 160, keep=True)
    kept = sp.pop("kept")
    return {"sp": sp, "long": phase_lm_long(model, cfg, kept)}


def phase_dryrun_host() -> dict:
    """dryrun_host: `repro_torch.launch.dryrun.run_cell` in one subprocess
    (the CPU, a fake 256-rank group) for DRYRUN_HOST_CELLS (llama3-8b's
    prefill_32k and decode_32k, and jamba-v0.1-52b's long_500k under the
    SP decode flip: its K/V split on the sequence over the 16 data ranks)
    on the single-pod mesh; each record's memory per rank, collectives,
    roofline terms (the H100's rates) and its seconds to build and
    trace."""
    out_dir = os.path.join(ROOT, "build", "dryrun_torch")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    code = ("import sys; from repro_torch.launch import dryrun; "
            "[dryrun.run_cell(*c.split(':'), False, sys.argv[1], "
            "force=True) for c in sys.argv[2:]]")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", code, out_dir,
         *[f"{a}:{s}" for a, s in DRYRUN_HOST_CELLS]],
        env=env, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"dryrun: {proc.stdout[-2000:]}"
          f"{proc.stderr[-2000:]}")
    recs = {}
    for arch, shape in DRYRUN_HOST_CELLS:
        with open(os.path.join(out_dir,
                               f"{arch}__{shape}__single.json")) as f:
            r = json.load(f)
        check(r.get("ok"), f"dryrun {arch} {shape}: {r.get('error')}")
        recs[f"{arch}|{shape}"] = {k: r[k] for k in (
            "ok", "memory", "collectives_raw", "roofline", "timings")}
    out = {"phase": "dryrun_host", "mesh": "single",
           "cells": recs, "wall_s": time.perf_counter() - t0}
    emit(out)
    return out


def main() -> None:
    import torch
    import torch.distributed as dist

    # the plain versions' f32 products run in full f32 (no TF32); bf16
    # products reduce in f32 (the LM phases print both settings)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    small_err = phase_kernel_cases()
    s = phase_self()
    ab = phase_ab()
    paper = phase_paper(s)
    flash_err, flash_bf16_err, flash_bf16_ratio = phase_flash_cases()
    fl = phase_flash()
    phase_engine()
    tk = phase_topk()
    rs = phase_rowstream()
    bt = phase_batch()
    nn = phase_nonnorm()
    tl = phase_tile()
    st = phase_streaming()
    ft, raw_fleet, fleet_x = phase_fleet()
    mn = phase_monitor(raw_fleet, fleet_x)
    del raw_fleet
    sv = phase_serve()
    ex = phase_serve_example()
    exs = phase_examples()
    an = phase_anytime()
    torch.cuda.empty_cache()
    lm = phase_lm()
    torch.cuda.empty_cache()
    moe_plain = phase_lm_moe_vs_plain()
    torch.cuda.empty_cache()
    lm_moe = _lm_serving(LM_MOE_ARCH, "main_lm_moe", "main_lm_moe",
                         LM_MOE_PREFILL_B, SEED + 60, then=phase_lm_mesh)
    lm_mesh = lm_moe["then"]
    torch.cuda.empty_cache()
    lm_mla = _lm_serving(LM_MLA_ARCH, "main_lm_mla", "main_lm_mla",
                         LM_MLA_PREFILL_B, SEED + 70,
                         prompt=LM_MLA_DECODE_PROMPT)
    ssm_plain = phase_lm_ssm_vs_plain()
    torch.cuda.empty_cache()
    lm_rwkv = _lm_serving(LM_RWKV_ARCH, "main_lm_rwkv", "main_lm_rwkv",
                          LM_RWKV_PREFILL_B, SEED + 90,
                          prompt=LM_RWKV_DECODE_PROMPT,
                          then=lambda m, c: phase_lm_sp(m, c, SEED + 170))
    lm_jamba = _lm_serving(LM_JAMBA_ARCH, "main_lm_jamba", "main_lm_jamba",
                           LM_JAMBA_PREFILL_B, SEED + 100,
                           layers=LM_JAMBA_LAYERS,
                           prompt=LM_JAMBA_DECODE_PROMPT, then=_jamba_then)
    encdec_plain = phase_lm_encdec_vs_plain()
    torch.cuda.empty_cache()
    lm_whisper = _lm_serving(LM_WHISPER_ARCH, "main_lm_whisper",
                             "main_lm_whisper", LM_WHISPER_PREFILL_B,
                             SEED + 130, prompt=LM_WHISPER_PROMPT,
                             then=lambda m, c: phase_lm_sp(m, c, SEED + 180))
    dist.destroy_process_group()      # the one-rank group of main_lm_sp
    lm_sp = {LM_RWKV_ARCH: lm_rwkv["then"],
             LM_JAMBA_ARCH: lm_jamba["then"]["sp"],
             LM_WHISPER_ARCH: lm_whisper["then"]}
    lm_long = lm_jamba["then"]["long"]
    lm_qwen_vl = _lm_serving(LM_QWEN_VL_ARCH, "main_lm_qwen2vl",
                             "main_lm_qwen2vl", LM_QWEN_VL_PREFILL_B,
                             SEED + 140)
    phase_lm_train_vs_plain()
    tr = phase_lm_train()
    cli = phase_lm_train_cli()
    phase_dryrun_host()
    new_paths = {"matrix_profile_topk": tk, "ab_join_rowstream": rs,
                 "batch": bt,
                 "matrix_profile_nonnorm": {"counts": nn["counts"]["self"]},
                 "ab_join_nonnorm": {"counts": nn["counts"]["ab"]},
                 "matrix_profile_tile": tl,
                 "streaming_append": {"counts": st["znorm"]["counts"]},
                 "streaming_append_raw": {"counts": st["raw"]["counts"]},
                 "streaming_query": {"counts": st["znorm"]["query_counts"]},
                 "streaming_query_raw": {"counts": st["raw"]["query_counts"]},
                 "fleet_ingest": {"counts": ft["znorm"]["counts"]},
                 "fleet_ingest_raw": {"counts": ft["raw"]["counts"]},
                 "monitor_scan": {"counts": mn["telemetry"]["scan_counts"]},
                 "monitor_motif": {"counts": mn["telemetry"]["motif_counts"]},
                 "fleet_monitor_scan": {"counts": mn["fleet"]["counts"]},
                 "serve": sv, "serve_topk": sv["k4"],
                 "anytime": an["self"], "anytime_ab": an["ab"],
                 "anytime_topk": an["topk"],
                 "anytime_group": an["self"]["group"],
                 "anytime_group_ab": an["ab"]["group"],
                 "anytime_group_topk": an["topk"]["group"],
                 "serve_example": ex, "main_paper": paper,
                 "examples": exs,
                 "lm_prefill": lm["prefill"], "lm_decode": lm["decode"],
                 "lm_moe_prefill": lm_moe["prefill"],
                 "lm_moe_decode": lm_moe["decode"],
                 "lm_mla_prefill": lm_mla["prefill"],
                 "lm_mla_decode": lm_mla["decode"],
                 "lm_rwkv_prefill": lm_rwkv["prefill"],
                 "lm_rwkv_decode": lm_rwkv["decode"],
                 "lm_jamba_prefill": lm_jamba["prefill"],
                 "lm_jamba_decode": lm_jamba["decode"],
                 "lm_whisper_prefill": lm_whisper["prefill"],
                 "lm_whisper_decode": lm_whisper["decode"],
                 "lm_qwen2vl_prefill": lm_qwen_vl["prefill"],
                 "lm_qwen2vl_decode": lm_qwen_vl["decode"],
                 "lm_train": tr, "lm_train_cli": cli,
                 **{f"lm_mesh_{lay}_{ph}": {"counts": lm_mesh[lay][key]}
                    for lay in LM_MESH_LAYOUTS
                    for ph, key in (("prefill", "counts"),
                                    ("decode", "decode_counts"))},
                 **{f"lm_sp_{arch}": {"counts": o["counts"]}
                    for arch, o in lm_sp.items()},
                 "lm_long": {"counts": lm_long["counts"]}}
    emit({"phase": "wall", "wall_s": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "natsa_mp", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": (s["launches"] + ab["launches"]
                     + mn["telemetry"]["motif_counts"]["natsa_mp"]
                     + sv["counts"]["natsa_mp"]
                     + an["self"]["launches"] + an["ab"]["launches"]
                     + an["self"]["group"]["launches"]
                     + an["ab"]["group"]["launches"]
                     + ex["counts"]["natsa_mp"]
                     + paper["counts"]["natsa_mp"]
                     + exs["counts"]["natsa_mp"]),
        "launches_by_path": {"matrix_profile": s["launches"],
                             "ab_join": ab["launches"],
                             "flash_attention": fl["counts"]["natsa_mp"],
                             **{p: o["counts"]["natsa_mp"]
                                for p, o in new_paths.items()}},
        "max_abs_err": small_err,
        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": s["bound_by"], "library_ms": None,
        "shape": f"self-join n={SELF_N} m={SELF_M}",
        "ab": {"ms": ab["ms"], "plain_ms": ab["plain_ms"],
               "bound_ms": ab["bound_ms"], "bound_by": ab["bound_by"],
               "shape": f"ab n_a={AB_NA} n_b={AB_NB} m={AB_M}"},
        "serve": {**{f: sv["kernel"][f] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
            "launches": sv["counts"]["natsa_mp"],
            "ms_all_pairs": sv["kernel_ms"],
            "bound_ms_all_pairs": sv["bound_ms_all_pairs"],
            "shape": (f"ab n_a={SERVE_QUERY_N} n_b={SERVE_N} m={SERVE_M}, "
                      f"{sv['pairs']} pairs")},
        "main_paper": {w: {f: r[f] for f in (
            "n", "m", "launches", "ms", "plain_ms", "bound_ms",
            "share_of_bound", "e2e_s", "host_prep_s")}
            for w, r in paper["records"].items()},
        "examples": {name: exs[name]["counts"]["natsa_mp"]
                     for name in EXAMPLE_LAUNCHES},
        "anytime": {side: {f: an[side][f] for f in (
            "launches", "chunk_ms_sum", "chunk_ms_max", "plain_ms_sum",
            "bound_ms_sum", "rounds_s")} for side in ("self", "ab")},
        "anytime_group": {side: {f: an[side]["group"][f] for f in (
            "launches", "rounds", "round_ms_median", "plain_round_ms_median",
            "rounds_s", "plain_rounds_s")} for side in ("self", "ab")},
    }, {
        "name": "flash_attn", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": (fl["launches"]
                     + sum(m[ph]["counts"]["flash_attn"]
                           for m in (lm, lm_moe, lm_mla, lm_rwkv, lm_jamba,
                                     lm_whisper, lm_qwen_vl)
                           for ph in ("prefill", "decode"))
                     + tr["counts"]["flash_attn"]
                     + cli["counts"]["flash_attn"]
                     + sum(lm_mesh[lay][key]["flash_attn"]
                           for lay in LM_MESH_LAYOUTS
                           for key in ("counts", "decode_counts"))
                     + sum(o["counts"]["flash_attn"] for o in lm_sp.values())
                     + lm_long["counts"]["flash_attn"]
                     + exs["counts"]["flash_attn"]),
        "launches_by_path": {"matrix_profile": s["counts"]["flash_attn"],
                             "ab_join": ab["counts"]["flash_attn"],
                             "flash_attention": fl["launches"],
                             **{p: o["counts"]["flash_attn"]
                                for p, o in new_paths.items()}},
        "max_abs_err": flash_err,
        "bf16_max_abs_err": flash_bf16_err,
        "bf16_max_element_ratio": flash_bf16_ratio,
        "launches_by_route": fl["launches_by_route"],
        "ms": fl["ms"], "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
        "library_ms": fl["library_ms"],
        "shape": (f"B={FLASH_B} H={FLASH_H} S={FLASH_S} D={FLASH_D} bf16 "
                  "causal"),
        "lm_prefill": {f: lm["prefill"][f] for f in (
            "flash_launches", "flash_ms_in_model", "flash_ms_per_layer",
            "flash_share", "prefill_s", "bound_s")},
        "lm_moe_prefill": {f: lm_moe["prefill"][f] for f in (
            "batch", "flash_launches", "flash_ms_in_model",
            "flash_ms_per_layer", "flash_share", "prefill_s", "bound_s")},
        "lm_jamba_prefill": {f: lm_jamba["prefill"][f] for f in (
            "batch", "layers", "flash_launches", "flash_ms_in_model",
            "flash_ms_per_layer", "flash_share", "prefill_s", "bound_s")},
        "lm_whisper_prefill": {f: lm_whisper["prefill"][f] for f in (
            "batch", "flash_launches", "flash_ms_in_model",
            "flash_ms_encoder", "flash_ms_per_layer", "flash_share",
            "prefill_s", "bound_s")},
        "lm_mesh": {lay: {f: lm_mesh[lay][f] for f in (
            "flash_launches", "prefill_s", "step_ms", "prefill_s_ratio",
            "step_ms_ratio", "logits_bitwise", "tokens_bitwise")}
            for lay in LM_MESH_LAYOUTS},
        "lm_sp": {arch: {f: o[f] for f in (
            "flash_launches", "prefill_s", "plain_prefill_s",
            "prefill_s_ratio", "logits_bitwise")}
            for arch, o in lm_sp.items()},
        "lm_long": {f: lm_long[f] for f in (
            "step_ms_median", "plain_step_ms_median", "bound_ms", "merges")},
        "lm_whisper_decode": {f: lm_whisper["decode"][f] for f in (
            "encode_s", "counts", "launches_by_route")},
        "lm_qwen2vl_prefill": {f: lm_qwen_vl["prefill"][f] for f in (
            "batch", "flash_launches", "flash_ms_in_model",
            "flash_ms_per_layer", "flash_share", "prefill_s", "bound_s")},
        "lm_in_model_max_element_ratio": max(
            r["element_ratio"]
            for m in (lm, lm_moe, lm_jamba, lm_whisper, lm_qwen_vl)
            for ph in ("prefill", "decode")
            for r in m[ph]["in_model_vs_plain"]),
        "lm_encdec_vs_plain_max_element_ratio": max(
            r["element_ratio"] for arch in (LM_WHISPER_ARCH, LM_QWEN_VL_ARCH)
            for r in encdec_plain[arch]["bf16"]["in_model_vs_plain"]),
        "lm_moe_vs_plain_max_element_ratio": max(
            r["element_ratio"] for r in moe_plain["in_model_vs_plain"]),
        "lm_ssm_vs_plain_max_element_ratio": max(
            r["element_ratio"]
            for r in ssm_plain["jamba_bf16"]["in_model_vs_plain"]),
        "lm_mla": "no kernel: MLA attention is torch ops (QK width "
                  "r + dr = 576 and V width r = 512 exceed the kernel's "
                  "head dims, its scale is not 1/sqrt(D))",
        "lm_rwkv": "no kernel: RWKV6 has no attention layer; its chunked "
                   "WKV recurrence is torch ops, as the reference's is jnp",
        "examples": {name: exs[name]["counts"]["flash_attn"]
                     for name in EXAMPLE_LAUNCHES},
        "lm_train": {f: tr[f] for f in (
            "flash_launches", "flash_ms_per_launch",
            "plain_backward_ms_per_call", "train_step_s_median",
            "tokens_per_s", "bound_s", "share_of_bound",
            "peak_device_bytes")},
        "lm_train_in_model_max_grad_ratio": max(
            r[f"d{x}_ratio"] for r in tr["in_model_grads_vs_plain"]
            for x in "qkv"),
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
