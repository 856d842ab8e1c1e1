#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. **build** — compile every CUDA source in ``src/repro_torch/csrc`` with
   nvcc for sm_90a (all at once) and print the build seconds and the
   compiler's register / shared-memory report;
2. **kernels** — each kernel's wrapper against its plain PyTorch version on
   the same inputs, at the serving path's shapes (qwen3-1.7b at full
   width) and the training paths' (xlstm-1.3b at full width, the
   AutoEncoder at batch 16 and 4096), with the tolerance printed beside
   the error: the bf16 / fp16 GEMM (kernels 1 and 2), its fp32 route in nn
   / nt / tn, kernel 1's faithful fp16 accumulator and fused backward
   (deriv, dW + db) on every route, FP8 storage upcast on load in kernels
   1 and 2 (each FP8 launch also bitwise against the same launch on
   pre-widened fp16 operands), flash attention (kernel 3: the prefill and
   a continuation, fp16 / D 64 / non-causal, S = T = 1024, a q tile count
   that does not divide S, MHA, fp16 at D 128) and the chunked
   linear-attention sweep (kernel 4: the training shape, a ragged dk != dv
   shape, fp32 input, chunk 128 at dk = dv = 1024, dv = 1000), every
   kernel 3 / 4 launch of the new shapes run twice and bitwise equal; then
   the split of the reduction inside one GEMM launch (a ragged last slice,
   the faithful accumulator over 3 rounding blocks, an FP8 pair bitwise
   against its pre-widened launch, a broadcast batched operand, the fp32
   route), every split launch repeated and
   bitwise equal run to run, and rows at qwen3-1.7b's decode / prefill and
   the xLSTM's fp32 gate and sLSTM shapes; then the LM training path's
   shapes: the tied head's backward ("nn" dX, "tn" dW over the 151936 x
   2048 table), the attention composition's six kernel-2 launches and
   flash at the training shape (bf16, fp16 and the fp32 route) and at
   musicgen-medium's D 64, each launch twice and bitwise equal; then the
   DeepSeek paths' shapes (deepseek-v2-lite-16b at full width): the
   grouped expert GEMM at prefill, decode and training, its dX and dW, MLA's
   q-chunked scores (qk dim 192) and PV, the absorbed decode's five
   contractions, each launch twice and bitwise equal, and the engine's
   grouped GEMM with one expert's rows masked, forward and gradients; then
   the recurrent slice's shapes: kernel 4 with hymba-1.5b's mixed operand
   dtypes (fp32 q / k, bf16 or fp16 v, dk 16) at its prefill and training
   shapes and at xlstm-1.3b's prefill, kernel 1 at hymba's unaligned
   widths (the head, N = 32001, forward and backward; the fp32 ``w_bcdt``,
   N = 57), kernel 2's fp32 decode readouts, each launch twice and bitwise
   equal.
   Each kernel, its plain version
   and — where one exists — one PyTorch library call for the same function
   are timed with CUDA events (decode / prefill rows over weight copies
   that exceed the L2), the kernel alone with torch.profiler, and each
   GEMM row prints the slices S its launch split into;
3. **serve** — every kernel's launch count is set to 0, then
   ``repro_torch.launch.serve`` serves qwen3-1.7b at full width (random
   weights from a seed): 4 requests, prompt 128, 16 new tokens; the counts
   are read right after and every kernel of the path must have run; tokens
   must be in range.  Then one prefill and one decode step are timed with
   CUDA events (logits must be finite) and profiled, and a two-layer cut
   of the same model is held against the plain path on the CPU;
4. **train** — the counts are set to 0 again, then
   ``repro_torch.launch.train`` trains xlstm-1.3b at full width (d 2048,
   random weights from a seed) with its depth cut to 8 blocks (one
   super-block since the dryrun phase came; 16 before it, 48 blocks and
   3 steps before the ft phase came) for 2 steps at batch 4 x seq 256;
   loss and gradient norm must be finite on every step and the sweep
   kernel's launch count must equal the structural one (7 mLSTM blocks
   per forward, once more in the remat recompute).  The warm-up
   step's fp32-route launches are tallied by shape, each shape then timed
   alone; then one step is profiled (device busy / idle share) with its
   peak memory, and one
   full-width super-block (7 mLSTM + 1 sLSTM, batch 1, seq 128) is held
   against the plain path on the CPU: loss and the gradients of w_up,
   w_qkv and r_gates, to 8x the CPU's own spread (1 vs all threads) —
   under fp32 both with the sweep composed on kernels 1 / 2 and on kernel
   4 (fp32 operands in three TF32 pieces), each kernel-4 launch also held
   to its plain version, beside a control that must fail (one w_qkv row
   scaled by 1 + 2^-10 on the card only); then step 0 of
   the whole model (48 blocks, full
   width, batch 1 x seq 128): its loss and the gradients of w_up, w_qkv and
   r_gates of the first and the last super-block, card vs CPU, under fp32
   and tpu_bf16, each held to 8x the CPU's own spread (half vs all
   threads), except a row where that bound reaches max |x| (tpu_bf16's
   deep rows), which is printed as unbounded and held only to be finite;
5. **lmtrain** — the counts are set to 0 again, then
   ``repro_torch.launch.train`` trains qwen3-1.7b at full width (28
   layers, d 2048, vocab 151936, random weights from a seed) for 2 steps
   (3 before the dryrun phase came) at batch 4 x seq 256: loss and gradient norm finite, and each kernel's
   launches equal to the structural count (kernel 1 451, kernel 2 168,
   kernel 3 56 a step).  Then one step is profiled (busy / idle share;
   GEMM, composition, flash and other device time; peak memory), two
   ``--fp16-scale`` steps run (finite, or a counted skip), a two-layer cut
   at full width (batch 1 x seq 128) is held against the CPU plain path
   under fp32 and tpu_bf16 (loss, the gradients of wqkv, w_in and the
   embedding) to 8x the CPU's own 1-vs-all-threads spread, kernel 3
   launched in both (its fp32 route under fp32), and a
   two-layer full-width serve cut of each dense config of the slice
   (mistral-nemo-12b, pixtral-12b, command-r-35b, musicgen-medium) is held
   against the CPU plain path;
6. **ft** — checkpoints, the fault-tolerant loop, the compressed gradient
   wire and elastic data parallelism: qwen3-1.7b at full width with its
   depth cut to 2 (411,838,976 parameters; every checkpoint, 8.24 GB, goes
   to a temporary directory removed after).  One data-parallel step (rank
   0's 2 x 256 rows, the FP8 E4M3 wire) run twice from one state must give
   bitwise equal parameters, moments and error feedback, with the
   structural launches (35 / 12 / 4) and no aten GEMM or SDPA in its
   profile.  Then ``repro_torch.launch.train --compress fp8_e4m3
   --dp-procs 2`` (two rank processes on the card over gloo, started by
   ``runtime.procs.spawn`` in this process, as the CLI's launcher starts
   them) for 4 steps of 4 x 256 three times: with ``--ckpt-dir`` and a
   death injected at step 3, which must exit 13 after the step-2
   checkpoint; a run without checkpoints (beside the death where the card
   has the memory); then alone with the first
   run's directory again, which must resume from step 2 and end with the
   second run's params / error-feedback / optimizer digests and loss, the
   goodput line counting 1 restart and 1 recomputed step; rank 0's
   launches are the structural count on every step (they are the path's
   row in the report), and the wire bytes, checkpoint bytes, the resume's
   save and restore seconds, step and all-reduce times and the free disk
   are printed.  Beside the death, the elastic worker
   (``repro_torch.runtime.elastic``, the toy MLP, every rank on the card):
   a torn checkpoint write at dp 2 resumes from the previous checkpoint to
   the uninterrupted digest, and a dp-4 FP8 checkpoint continues at dp 2
   with its residuals regrouped to the sums and its scale windows to the
   maxima;
7. **shard** — the sharding runtime (``runtime/sharding.py``,
   ``runtime/collectives.py``, ``launch/mesh.py``): two rank processes
   (gloo, both on the card, every collective a host round trip) run
   ``launch/mesh.py``'s cells on a ``{data: 1, model: 2}`` mesh:
   qwen3-1.7b at full width and depth under the serving rules (KV cache
   cut over its sequence; prefill 4 x 128, 16 greedy steps, tpu_bf16),
   two layers of it trained 2 steps at 4 x 256 under ``Rules()`` (fp32 and
   tpu_bf16), and deepseek-moe-16b at full width, 3 layers, served (4 x
   128 + 8, fp32) under both MoE routes.  Each against the unsharded run
   in this process from the same seed, beside a control that must fail
   (one rank's wo block negated; two experts' w_out swapped): logits
   (greedy tokens equal off near ties), fp32 gradients (bf16 printed);
   per rank the peak memory, KV bytes (half the cache), launches, the
   collectives (count, bytes, host seconds) and times; no aten GEMM /
   SDPA in a decode step or a train step; kernel 2 with an empty group.
   A second two-rank spawn beside it runs the reference dry run's
   layouts at full width (``SH_LAYOUTS``: FSDP with grad_accum, sequence
   parallelism, a KV cache under ``Rules()``, MLA, hymba and xLSTM served
   and trained), and four ranks on the host CPU FSDP x TP on a ``(2,
   2)`` mesh (``SH_CPU4``); each cell against the unsharded run on the
   card beside a control that must fail (one rank's block of a cut
   weight negated), every rank's resident bytes equal to the spec's
   blocks, the recurrent states bitwise equal across ranks;
7b. **dryrun** — the dry run (``launch/dryrun.py``): each ``SH_LAYOUTS``
   cell's rank 0 traced on meta tensors (the card's contract) in
   ``DR_WORKERS`` host processes started before the ft phase (the traces
   need no card and no run; the ft ranks leave most host cores idle), its collectives per kind (count,
   payload bytes), resident parameter / moment / KV bytes and engine bill
   equal to every rank's, its traced peak within ``DR_MEM_BOUND`` of the
   rank's ``max_memory_allocated`` over the same steps, beside the cell
   with its batch doubled, which must miss the bound wherever the batch
   moves the traced peak; the reference's production cells
   (``DR_PROD``) at full width with the reference's printed line; the
   lmtrain step's measured time over the dry run's one-card bound
   (printed).  Every term is an estimate from H100 data-sheet constants;
8. **ae** — the counts are set to 0 again, then ``repro_torch.launch.train
   --arch ae`` trains the paper's TinyMLPerf AutoEncoder (640 -> [128 x4]
   -> 8 -> [128 x4] -> 640, random weights from a seed) for 200 steps at
   batch 16 under ``paper_fp16``, then 3 steps under ``fp32``: the mse must
   be finite and falling, and kernel 1 must launch exactly 30 times a step
   (every one faithful, 10 of them the fused dW + db).  Then one step is
   profiled, the loss-scaled example runs 200 steps, and one step is held
   against the CPU plain path: its loss at batch 16 and 4096, its gradients
   at batch 4096 (where the dW reductions span 2 to 4 rounding blocks),
   beside a control that must fail (one weight row scaled by 1.25).  The
   paper's RedMulE cycle model (``core/perf_model.py``) prices one step's
   events captured on the card, which must equal the CPU's, beside its
   Fig 4c/4d ``autoencoder_report`` at batch 1 and 16;
9. **ae8** — the same entry point under FP8 storage: 200
   ``mixed_fp8_e4m3`` steps at batch 16 (the mse must fall to the
   reference's level), 3 at batch 4096 and 3 ``mixed_fp8_e5m2`` steps,
   each with its own counts (30 kernel-1 launches a step, all FP8, none
   fused-backward); one profiled step; one step at batch 16 and 4096 held
   against the CPU plain path, with BatchNorm in float64 on both sides and
   as the path runs it, each bound beside two controls that must fail it;
10. **serve8** — qwen3-1.7b at full width under ``mixed_fp8_e4m3``:
   ``launch.serve.generate`` of 4 x (128 + 16) with the counts set to 0
   (the structural 2260 / 896 / 112 launches, every GEMM launch FP8);
   one prefill and one decode step timed and profiled; a two-layer cut
   (prefill, and a decode step from one cache) against the CPU plain path
   on two prompts, each held to a bound measured in the run (the CPU's own
   rounding floor: its largest change when kernel 3's outputs move by one
   ulp as often as the card's flash launches differ from their plain
   version), beside two controls that must fail it (row 0 of the first
   layer's wqkv zeroed, the attention scale off by a factor 1 + 2^-6);
11. **moeserve** — the counts are set to 0 again, then
   ``repro_torch.launch.serve`` serves deepseek-v2-lite-16b at full width
   and depth (27 layers, 64 routed experts top-6 + 2 shared, MLA, random
   weights from a seed): 4 requests, prompt 128, 16 new tokens; the kernel-1
   / kernel-2 launches must equal the structural counts printed before the
   run (3456 / 3936, no flash).  One prefill and one decode step timed and
   profiled (kernel 1 / kernel 2 / other, no aten GEMM or SDPA op), peak
   memory;
12. **moecut** — a two-layer full-width cut (dense layer 0 + one MoE
   layer) of deepseek-v2-lite-16b and of deepseek-moe-16b: every logit of
   a 2 x 16 prompt and one decode step from its cache, card vs the CPU
   plain path; every routing flip must lie on a router tie (within twice
   the run's measured router-logit error), the tokens that route alike are
   held to the larger of 8x the CPU's 1-vs-all-thread spread and 2^-4 of
   max, and a control (two experts' w_out swapped) must fail that bound;
13. **moetrain** — ``repro_torch.launch.train`` trains deepseek-v2-lite-16b
   at full width with its depth cut to 3 (``--layers 3``: dense layer 0 +
   two MoE layers), 4 x 256, 3 steps: losses and router metrics finite,
   launches structural (88 / 46 a step: forward, the MoE layers' remat
   recompute, dX and dW), one profiled step (no aten GEMM or SDPA op),
   peak memory;
14. **ssmserve** — the counts are set to 0 again, then xlstm-1.3b at full
   width and depth (48 blocks, random weights from a seed) runs
   ``transformer.prefill`` on 4 x 128 and a greedy loop of 16
   ``serve_step``s from its decode state (the scheduler refuses recurrent
   kinds, as the reference's does); launches structural (kernel 4: 42 a
   prefill, 0 a decode step), one prefill and one decode step timed and
   profiled (kernel 1 / 2 / 4 / other, no aten GEMM or SDPA op), peak
   memory;
15. **hymbaserve** — the same for hymba-1.5b at full width and depth (32
   layers) on 4 x (1152 + 16): the 1024 window masks on the 29 sliding
   layers and the prefill crosses q_chunk 1024; kernel 4 32 a prefill, 0
   a decode step, no flash;
16. **hymbatrain** — ``repro_torch.launch.train`` trains hymba-1.5b at full
   width and depth, 4 x 256, 2 steps (3 before the dryrun phase came):
   losses finite, 64 sweeps a step
   (forward and remat recompute), no flash, one profiled step, peak memory;
17. **ssmcut** — a two-layer full-width cut of hymba-1.5b (full layer 0,
   sliding layer 1) on 2 x 1088 and one xlstm-1.3b super-block on 2 x 128
   (under tpu_bf16 and under fp32), each with 2 decode steps from its
   cache: logits and every cache leaf, card vs the CPU plain path, within
   the larger of 8x the CPU's 1-vs-all-thread spread and 2^-4 of max
   (fp32: 1e-5), beside two controls that must fail (hymba layer 1's ``a_log`` raised by
   ``HC_CONTROL``; the fp32 xLSTM cut's first mLSTM state zeroed after the
   prefill);
18. **sched** — serving under load: the counts are set to 0 again, then
   ``repro_torch.launch.serve --sched`` runs yi-9b at full width and depth
   (48 layers, d 4096, random weights from a seed) with the reference's
   defaults: 4 slots, 8 requests at each of the rates 0.25 and 1.0,
   prompt 128, 16 new tokens, the FP8 E4M3 KV cache, ``mixed_fp8_e4m3``;
   every request must finish, the launches equal the structural count of
   the traces, every kernel-1 launch FP8, and the rate-1.0 point run
   again the same trace and tokens.  Then ``benchmarks/baselines/
   serve_slo.json``'s scenario at full width under yi-9b's own policy
   (tpu_bf16) as the file states it (FP8 cache: no fault, nan_logits@2,
   kv_corrupt@2, prefill_crash@1; the 16-bit cache: no fault,
   kv_corrupt@2), each against its floors, with a recovery where a fault
   fired, the goodput and event log of its reduced CPU twin, the victim's
   tokens equal to the uninjected run's and structural launches;
   the recovery contract under tpu_bf16 (on the 16-bit cache the
   co-resident slot bitwise unmoved, the victim's rebuilt rows bitwise
   equal to the decode-built ones and, both runs drained, its tokens and
   final logits bitwise equal to an uninjected run's; on the FP8 cache the
   co-resident codes bitwise where the pool's scale did not move, else
   within one E4M3 step, and the victim's rebuilt rows within one E4M3
   step plus the 16-bit prefill-versus-decode gap of a full prefill,
   beside a control that must fail); a 16-bit recovery's time early and
   late in a 128 + 16 request at 4 slots (rebuilt rows and co-resident
   slots bitwise), whose difference gives the cost of a replayed decode
   step; two-layer FP8 cuts
   of yi-9b and deepseek-v2-lite-16b (MLA) against the CPU plain path
   (cache rows within one E4M3 step plus the 16-bit cut's gap, decode
   logits against the 16-bit cache within the reference's band, each
   beside a control that must fail); the KV bytes of a decode step and
   the resident cache, one profiled FP8 and bf16 decode step (no aten
   GEMM or SDPA op) and the checksum audit's time;
19. **tune** — the autotuner (``repro_torch.core.autotune``) on the card:
   kernel 1 at qwen3-1.7b's serving shapes (the tied head, decode w_out
   and wqkv, prefill w_in: PERF.md rows 1, 1i, 1j, 1k) over every compiled
   tile and split S, and kernel 4's chunk at the xLSTM training shape (row
   4; each chunk held to the plain version at that chunk, bf16 and fp32),
   every candidate's device time printed beside the heuristic's and the
   pick, into ``chiprun_out/autotune_cache.json``; then, with the LRU
   reloaded from that file, a two-layer full-width qwen3-1.7b cut (prefill
   1 x 128, a decode step at batch 4): every launch of a tuned shape ran
   the cached tile and split, and the logits sit within ``TUNE_TOL`` of the
   uncached run's, and again from a file of each shape's fastest
   non-heuristic candidate, beside a control (an entry naming an uncompiled
   tile) that must raise; and a paper_fp16 AE step with every launch on a cached
   tile other than the heuristic's, bitwise equal to the uncached step;
20. **report** — the GEMM wrappers' split launches (``.launches_split``)
   per path, the card (``nvidia-smi``), a ``{"kernels": [...]}`` line, and
   last ``{"ok": true, "device": {...}}``.

Everything is also written to ``chiprun_out/chip_smoke.json``.  It needs
one card and exits non-zero without one, or without the rest of the repo.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
FP8_FLOPS = 1979e12         # H100 SXM dense fp8 tensor-core peak
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 tensor-core peak
ARCH, BATCH, PROMPT, GEN, SEED = "qwen3-1.7b", 4, 128, 16, 0
# the training path: xlstm-1.3b at full width
T_ARCH, T_BATCH, T_SEQ, T_STEPS = "xlstm-1.3b", 4, 256, 2
# its main path and profiled step run the first T_LAYERS blocks (one
# super-block since the dryrun phase needed the time; two until then, all
# 48 and 3 steps until the ft phase did); the step-0 parity below keeps
# the whole depth
T_LAYERS = 8
# the full-depth step-0 parity: batch 1 x seq 128 (two 64-row chunks, so
# the sweep carries its state once), all 48 blocks at full width under the
# training policy; under fp32 the first FD_FP32_LAYERS (two super-blocks
# since the dryrun phase needed the time; three until then, 48 until the
# shard phase did)
FD_SEQ, FD_FP32_LAYERS = 128, 16
# the AutoEncoder path: the paper's use case at its published width
AE_BATCH, AE_STEPS, AE_BIG = 16, 200, 4096
# the paper_fp16 AE step parity's control at batch AE_BIG: one row of fc1's
# weight scaled by this (on the CPU it moves the gradients by 9.1e-2 of max,
# against a bound of 6.1e-2)
AE_CONTROL = 1.25
# kernel 4 on fp32 inputs against its plain version, out and state, of max:
# 4x the largest distance of the three-piece CPU emulation from the plain
# version at this script's fp32 shapes (5e-7; tests/test_torch_kernel4_fp32.py)
K4_FP32_TOL = 2e-6
# the xLSTM super-block parity under fp32: each kernel-4 launch against its
# plain version on the same operands; the control scales one w_qkv row by
# 1 + SB_CONTROL on the card only
SB_K4_TOL, SB_CONTROL = K4_FP32_TOL, 2.0 ** -10
# the FP8 AE step with BatchNorm in float64 on both sides, card vs CPU:
# two fp16 ulps of the largest gradient
AE8_STATS_TOL = 2.0 ** -9
# the serve8 two-layer cut, card vs CPU plain: S8_FACTOR times the cut's
# rounding floor, the CPU's largest change under one-ulp moves of kernel
# 3's output over S8_TRIALS draws on each of its two prompts.  A move that
# crosses an E4M3 boundary grows to 0.03-0.06 of max; a zeroed wqkv row or
# a 2^-6 scale error moves the logits by 0.087-0.13: 1.25 splits the gap
S8_TRIALS, S8_FACTOR = 4, 1.25
# the LM training path: qwen3-1.7b at full width; its two-layer parity cut
L_BATCH, L_SEQ, L_STEPS, L_CUT_SEQ = 4, 256, 2, 128
# the dense configs of the LM slice, each served as a two-layer cut
DENSE_ARCHS = ("mistral-nemo-12b", "pixtral-12b", "command-r-35b", "musicgen-medium")
# the MoE slice: deepseek-v2-lite-16b served at full width and depth (4
# requests, prompt 128, 16 new tokens) and trained at full width with its
# depth cut to 3 (4 x 256, 3 steps); two-layer cuts of both DeepSeek
# configs on 2 x 16 prompts, card vs CPU
M_ARCH, M_BATCH, M_PROMPT, M_GEN = "deepseek-v2-lite-16b", 4, 128, 16
MT_LAYERS, MT_BATCH, MT_SEQ, MT_STEPS = 3, 4, 256, 3
MOE_ARCHS, MC_BATCH, MC_PROMPT = ("deepseek-v2-lite-16b", "deepseek-moe-16b"), 2, 16
# the recurrent slice: xlstm-1.3b served from its decode state at full width
# and depth (4 requests, prompt 128, 16 new tokens); hymba-1.5b served at
# full width and depth (prompt 1152: the 1024 window masks on its 29 sliding
# layers and the prompt crosses q_chunk 1024) and trained (4 x 256, 3
# steps); a two-layer hymba cut on 2 x 1088 and one xLSTM super-block on
# 2 x 128, each with 2 decode steps, card vs CPU
X_BATCH, X_PROMPT, X_GEN = 4, 128, 16
H_ARCH, H_BATCH, H_PROMPT, H_GEN = "hymba-1.5b", 4, 1152, 16
HT_BATCH, HT_SEQ, HT_STEPS = 4, 256, 2
HC_BATCH, HC_PROMPT, XC_BATCH, XC_PROMPT, C_GEN = 2, 1088, 2, 128, 2
# the hymba cut's control: layer 1's a_log raised by this much.  2^-3 moves
# the logits by ~3.3e-2 and layer 1's SSD state by ~4.7e-2 of max, inside
# the cut's 2^-4 bound (the CPU plain path against itself); 2^-1 moves
# them by ~0.14 / 0.18
HC_CONTROL = 2.0 ** -1
# the sched phase: yi-9b at full width and depth through launch/serve.py's
# --sched path with the reference's defaults (4 slots, 8 requests at each
# rate, prompt 128, 16 new tokens, the FP8 E4M3 cache, mixed_fp8_e4m3)
S_ARCH, S_SLOTS, S_REQUESTS, S_RATES, S_PROMPT, S_GEN = "yi-9b", 4, 8, (0.25, 1.0), 128, 16
FP8_STORAGE = "float8_e4m3fn"
# one E4M3 step of a dequantized cache value x at scale s: E4M3_EPS |x| +
# s E4M3_SUB (relative precision 2^-3, the subnormal grid below s 2^-6;
# tests/test_serving.py:47-69)
E4M3_EPS, E4M3_SUB = 2.0 ** -3, 2.0 ** -9
# the reference's band for FP8 decode logits against the 16-bit cache's
# (tests/test_serving.py:71-97): max and mean over the decode steps
FP8_BAND_MAX, FP8_BAND_MEAN = 0.5, 0.3
# the aten ops a profiled window of the port must not call on the card
ATEN_GEMM = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
             "aten::addbmm", "aten::matmul", "aten::linear")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_profile(fn, iters: int = 5, attempts: int = 3, ranges=(),
                    cpu: bool = True) -> dict:
    """Device time of ``iters`` calls of ``fn`` from torch.profiler, by
    kernel group, beside the host wall time of the same calls, and the
    device time of the kernels launched inside each ``record_function``
    range named in ``ranges``.  ``cpu=False`` records the device alone (no
    ranges, no aten ops: a step of ~200k kernels makes ~1M host events to
    post-process).  A profile that recorded no CUDA activity (CUPTI now and
    then drops a whole window right after a step of ~200k kernels) is
    taken again, with the host recorded too, up to ``attempts`` windows in
    all; then it raises."""
    for attempt in range(attempts):
        out = _profile_once(fn, iters, ranges, cpu or attempt > 0)
        if out is not None:
            return out
        print(f"[profile] no device time recorded (window {attempt + 1} of "
              f"{attempts})", flush=True)
        time.sleep(2.0)
    raise RuntimeError("torch.profiler recorded no device time")


def _profile_once(fn, iters: int, ranges=(), cpu: bool = True):
    """One profiled window of ``_device_profile``; None if it recorded no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict = {}
    spans = {r: {"ms": 0.0, "count": 0} for r in ranges}
    aten = {}
    for ev in prof.key_averages():
        if ev.key in ATEN_GEMM or "scaled_dot_product" in ev.key:
            aten[ev.key] = ev.count / iters
        # a range's count from its host-side record (one per call), its
        # device time from its device-side annotation, of which the
        # profiler can drop one a window (seen: 45 of 46 and 1619 of 1620,
        # the same in each of three windows)
        if ev.key in spans and ev.device_type == torch.autograd.DeviceType.CPU:
            spans[ev.key]["count"] = ev.count / iters
        elif ev.key in spans:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            spans[ev.key]["ms"] = us / 1e3 / iters
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        name = ("redmule_gemm" if "redmule_gemm_kernel" in ev.key else
                "redmule_gemm_f32" if "redmule_gemm_f32_kernel" in ev.key else
                "flash_fwd" if "flash_fwd" in ev.key else  # either route
                "chunked_linear_attention"     # its scores kernel and the sweep
                if "chunked_linear_attention" in ev.key else "other")
        g = groups.setdefault(name, {"ms": 0.0, "count": 0})
        g["ms"] += us / 1e3 / iters
        g["count"] += ev.count / iters
    busy = sum(g["ms"] for g in groups.values())
    if busy <= 0:
        return None
    wall_ms = wall * 1e3 / iters
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms), "by_kernel": groups,
            "ranges": spans, "aten_gemm": aten}


def _bound_ms(n_bytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _check(name, got, want, tol_rel, log):
    """max |got - want| against tol_rel * max |want|; raises on failure."""
    err = (got.float() - want.float()).abs().max().item()
    tol = tol_rel * max(want.float().abs().max().item(), 1e-30)
    ok = math.isfinite(err) and err <= tol
    log.append({"check": name, "max_abs_err": err, "tol": tol, "ok": ok})
    print(f"[check] {name}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def _repeat(name, first, second, log):
    """A launch run twice on the same inputs must give the same bits."""
    import torch

    torch.cuda.synchronize()
    ok = bool(torch.equal(first, second))
    log.append({"check": f"{name} run twice, bitwise equal", "ok": ok})
    print(f"[check] {name} run twice: {'bitwise equal' if ok else 'FAIL: differs'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: two runs of one launch differ")


def kernel1_mode_checks(log, g):
    """Kernel 1's faithful fp16 accumulator and fused backward epilogue
    (the AutoEncoder path) on the card against the plain version on the
    card: faithful GEMMs at the AE shapes and at multi-block shapes, the dW
    "tn" with db (faithful, fp16 -> fp32 and the fp32 route), deriv on
    "nt" / "tn" (relu, gelu).  Returns the runs to time.

    Tolerances: the faithful accumulator one fp16 ulp (2^-10 relative) per
    rounding step (each reduction block, and the bias add) — both sides
    sum each block in fp32 in another order, so a rounding may flip; a
    transcendental derivative under fp16 2e-2 (the reference's); fp32
    accumulation 1e-5 of max."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.core.engine import _grad_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    paper, f32 = prec.PAPER_FP16, prec.FP32
    g16, g32 = _grad_policy(prec.TPU_FP16), _grad_policy(prec.TPU_BF16)
    ulp = 2.0 ** -10

    def rnd(*shape, dtype=torch.float16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def both(name, x, w, policy, tol, **kw):
        got = ops.redmule_matmul(x, w, policy=policy, **kw)
        want = rm.redmule_matmul_plain(x, w, policy=policy, **kw)
        if kw.get("bias_grad"):
            err = _check(name, got[0], want[0], tol, log)
            _check(name + " db", got[1], want[1], tol, log)
            return err
        return _check(name, got, want, tol, log)

    # forward: the AE's layers at batch 16 (one block: the reduction fits
    # the reference's bn) and multi-block shapes
    B, d_in, d_h = 16, 640, 128
    x16, w0 = rnd(B, d_in), rnd(d_in, d_h, scale=(2 / d_in) ** 0.5)
    b0 = torch.randn(d_h, generator=g, device=dev).half()
    err_fwd = both("faithful nn AE fc0 M=16 N=640 K=128 +bias (1 block of 640)",
                   x16, w0, paper, 2 * ulp, bias=b0)
    both("faithful nn AE fc9 M=16 N=128 K=640 +bias", rnd(B, d_h),
         rnd(d_h, d_in, scale=(2 / d_h) ** 0.5), paper, 2 * ulp,
         bias=torch.randn(d_in, generator=g, device=dev).half())
    xm, wm = rnd(256, 640), rnd(640, 128, scale=640 ** -0.5)
    both("faithful nn M=256 N=640 K=128 block 128 (5 blocks)", xm, wm, paper,
         6 * ulp, bias=b0, accum_block=128)
    both("faithful nn M=64 N=4096 K=256 block 2048 (2 blocks)", rnd(64, 4096),
         rnd(4096, 256, scale=4096 ** -0.5), paper, 2 * ulp, accum_block=2048)
    both("faithful nt dX M=16 N=128 K=640", rnd(B, d_h), w0, paper, ulp,
         layout="nt")
    # the 8-wide bottleneck: fc4 (128 -> 8) and fc5 (8 -> 128) forward, dX
    # and dW + db; fc5's forward and fc4's dX reduce over 8 rows, fewer
    # than the kernel's 32-deep step (the rest is masked)
    w4, w5 = rnd(d_h, 8, scale=(2 / d_h) ** 0.5), rnd(8, d_h, scale=0.5)
    both("faithful nn AE fc4 M=16 N=128 K=8 +bias", rnd(B, d_h), w4, paper,
         2 * ulp, bias=rnd(8))
    both("faithful nn AE fc5 M=16 N=8 K=128 +bias", rnd(B, 8), w5, paper,
         2 * ulp, bias=rnd(d_h))
    both("faithful nt dX AE fc4 M=16 N=8 K=128", rnd(B, 8, scale=1e-2), w4,
         paper, ulp, layout="nt")
    both("faithful nt dX AE fc5 M=16 N=128 K=8", rnd(B, d_h, scale=1e-2), w5,
         paper, ulp, layout="nt")
    both("faithful tn dW+db AE fc4 M=128 N=16 K=8", rnd(B, d_h),
         rnd(B, 8, scale=1e-2), paper, ulp, layout="tn", bias_grad=True)
    both("faithful tn dW+db AE fc5 M=8 N=16 K=128", rnd(B, 8),
         rnd(B, d_h, scale=1e-2), paper, ulp, layout="tn", bias_grad=True)
    # db over an empty M or N: the kernel still launches (one M-tile row of
    # blocks sums db, no z is stored)
    for what, xe, dze in (("M=0 N=16 K=128", rnd(B, 0), rnd(B, d_h, scale=1e-2)),
                          ("M=640 N=0 K=128", rnd(0, d_in), rnd(0, d_h))):
        before = ops.redmule_matmul.launches
        z_e, db_e = ops.redmule_matmul(xe, dze, policy=paper, layout="tn",
                                       bias_grad=True)
        z_w, db_w = rm.redmule_matmul_plain(xe, dze, policy=paper, layout="tn",
                                            bias_grad=True)
        if ops.redmule_matmul.launches != before + 1 or z_e.shape != z_w.shape:
            raise AssertionError(f"empty-{what} dW + db did not launch the kernel")
        _check(f"faithful tn dW+db {what}: db", db_e, db_w, ulp, log)
    # the dW "tn" with db: AE fc0 at batch 16 (1 block) and 4096 (4 x 1024)
    xb, dzb = rnd(4096, d_in), rnd(4096, d_h, scale=1e-2)
    err_dw16 = both("faithful tn dW+db AE fc0 M=640 N=16 K=128", x16,
                    rnd(B, d_h, scale=1e-2), paper, ulp, layout="tn",
                    bias_grad=True)
    err_dw4k = both("faithful tn dW+db AE fc0 M=640 N=4096 K=128 (4 blocks)",
                    xb, dzb, paper, 4 * ulp, layout="tn", bias_grad=True)
    err_mb = both("faithful tn dW AE fc0 M=640 N=4096 K=128, no db",
                  xb, dzb, paper, 4 * ulp, layout="tn")
    both("tn dW+db fp16 -> fp32 M=640 N=4096 K=128", xb, dzb, g16, 1e-5,
         layout="tn", bias_grad=True)
    xb32, dzb32 = xb.float(), dzb.float()
    both("fp32 route tn dW+db M=640 N=4096 K=128", xb32, dzb32, f32, 1e-5,
         layout="tn", bias_grad=True)
    x16f, dz16f = x16.float(), dzb[:B].float()
    err_dw32 = both("fp32 route tn dW+db AE fc0 M=640 N=16 K=128", x16f, dz16f,
                    f32, 1e-5, layout="tn", bias_grad=True)
    # deriv on load: relu (output form) and gelu (pre-activation), nt / tn
    for act, from_out in (("relu", True), ("gelu", False)):
        dx_d = rnd(B, d_h)
        dw_d = rnd(4096, d_h)
        tol = 2e-2 if act == "gelu" else ulp
        both(f"faithful nt dX deriv {act} M=16 N=128 K=640", rnd(B, d_h), w0,
             paper, tol, layout="nt", deriv=dx_d, grad_epilogue=act,
             grad_from_output=from_out)
        both(f"faithful tn dW+db deriv {act} M=640 N=4096 K=128", xb, dzb,
             paper, max(tol, 4 * ulp), layout="tn", deriv=dw_d,
             grad_epilogue=act, grad_from_output=from_out, bias_grad=True)
        both(f"bf16 -> fp32 tn dW+db deriv {act} M=640 N=4096 K=128",
             xb.bfloat16(), dzb.bfloat16(), g32, 2e-2 if act == "gelu" else 1e-5,
             layout="tn", deriv=dw_d.bfloat16(), grad_epilogue=act,
             grad_from_output=from_out, bias_grad=True)
        both(f"fp32 route nt dX deriv {act} M=16 N=128 K=640", rnd(B, d_h).float(),
             w0.float(), f32, 1e-5, layout="nt", deriv=dx_d.float(),
             grad_epilogue=act, grad_from_output=from_out)
        both(f"fp32 route tn dW+db deriv {act} M=640 N=4096 K=128", xb32, dzb32,
             f32, 1e-5, layout="tn", deriv=dw_d.float(), grad_epilogue=act,
             grad_from_output=from_out, bias_grad=True)
    # kernel 2 (batched) under the faithful accumulator
    xq, wq = rnd(3, 64, 640), rnd(3, 640, 96, scale=640 ** -0.5)
    got = ops.redmule_matmul_batched(xq, wq, policy=paper, accum_block=128)
    _check("faithful batched B=3 M=64 N=640 K=96 block 128", got,
           rm.redmule_matmul_plain(xq, wq, policy=paper, accum_block=128),
           5 * ulp, log)
    torch.cuda.synchronize()
    # the faithful accumulator's cost: the same dW with fp32 accumulation
    t_faithful = _time_ms(lambda: ops.redmule_matmul(xb, dzb, policy=paper,
                                                     layout="tn"))
    t_fp32acc = _time_ms(lambda: ops.redmule_matmul(xb, dzb, policy=g16,
                                                    layout="tn"))
    print(f"[time] AE fc0 dW tn M=640 N=4096 K=128 fp16: faithful (4 blocks) "
          f"{t_faithful:.4f} ms, fp32 accumulation {t_fp32acc:.4f} ms", flush=True)

    fp16_b = lambda M, N, K, extra=0: _bound_ms(
        (M * N + N * K + M * K) * 2 + extra, 2 * M * N * K)
    src = "src/repro_torch/csrc/redmule_matmul.cu"
    rep = "src/repro/kernels/redmule_matmul.py:289"
    lib_tn = lambda a, b_: (lambda: torch.matmul(a.t(), b_))
    # ``paths``: the main-path runs whose launches a row reports (default:
    # every run); the batch-16 and batch-4096 dW + db rows share a counter
    # and each reads only the run at its batch
    return [
        dict(name="redmule_matmul (faithful fp16)", group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches_faithful"), source=src,
             replaces=rep, err=err_fwd, bound=fp16_b(B, d_in, d_h, d_h * 2),
             shape="AE fc0 forward nn M=16 N=640 K=128 +bias, 1 block",
             kernel=lambda: ops.redmule_matmul(x16, w0, policy=paper, bias=b0),
             plain=lambda: rm.redmule_matmul_plain(x16, w0, policy=paper, bias=b0),
             library=lambda: torch.matmul(x16, w0)),
        dict(name="redmule_matmul (faithful fp16, multi-block)",
             group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches_multiblock"), source=src,
             replaces=rep, err=err_mb, bound=fp16_b(d_in, 4096, d_h),
             shape="AE fc0 dW tn M=640 N=4096 K=128, 4 blocks of 1024, no db "
                   "(the path's multi-block launches are its dW + db at batch 4096)",
             kernel=lambda: ops.redmule_matmul(xb, dzb, policy=paper, layout="tn",
                                               accum_block=1024),
             plain=lambda: rm.redmule_matmul_plain(xb, dzb, policy=paper,
                                                   layout="tn", accum_block=1024),
             library=lib_tn(xb, dzb)),
        dict(name="redmule_matmul (fused backward dW + db)", group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches_fused_bwd"), paths=("ae",),
             source=src,
             replaces=rep, err=err_dw16, bound=fp16_b(d_in, B, d_h, d_h * 2),
             shape="AE fc0 dW tn M=640 N=16 K=128 +db, faithful, 1 block",
             kernel=lambda: ops.redmule_matmul(x16, dzb[:B], policy=paper,
                                               layout="tn", bias_grad=True),
             plain=lambda: rm.redmule_matmul_plain(x16, dzb[:B], policy=paper,
                                                   layout="tn", bias_grad=True),
             library=lib_tn(x16, dzb[:B])),
        dict(name="redmule_matmul (fused backward dW + db, batch 4096)",
             group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches_fused_bwd"),
             paths=("ae_b4096",), source=src, replaces=rep, err=err_dw4k, bound=fp16_b(d_in, 4096, d_h, d_h * 2),
             shape="AE fc0 dW tn M=640 N=4096 K=128 +db, faithful, 4 blocks",
             kernel=lambda: ops.redmule_matmul(xb, dzb, policy=paper, layout="tn",
                                               bias_grad=True),
             plain=lambda: rm.redmule_matmul_plain(xb, dzb, policy=paper,
                                                   layout="tn", bias_grad=True),
             library=lib_tn(xb, dzb)),
        dict(name="redmule_matmul (fp32 route, fused backward dW + db)",
             group="redmule_gemm_f32",
             counter=(ops.redmule_matmul, "launches_fused_bwd_fp32"), source=src,
             replaces=rep, err=err_dw32,
             bound=_bound_ms((d_in * B + B * d_h + d_in * d_h + d_h) * 4,
                             2 * d_in * B * d_h, FP32_FLOPS),
             shape="AE fc0 dW tn M=640 N=16 K=128 +db, fp32",
             kernel=lambda: ops.redmule_matmul(x16f, dz16f, policy=f32,
                                               layout="tn", bias_grad=True),
             plain=lambda: rm.redmule_matmul_plain(x16f, dz16f, policy=f32,
                                                   layout="tn", bias_grad=True),
             library=lib_tn(x16f, dz16f)),
    ]


def fp8_kernel_checks(log, g):
    """FP8 storage, upcast on load, in kernels 1 and 2 (the mixed_fp8_*
    policies) at the ae8 and serve8 paths' shapes.  Each launch is held
    two ways: **bitwise** against the same kernel on the operands widened
    to fp16 first (the reference's ``operand_dtypes`` contract: the bytes
    change, the values do not; both launches get the same rounding block),
    and against the plain version on the card.  Returns the runs to time.

    Tolerances against the plain version: the faithful fp16 accumulator
    one fp16 ulp (2^-10 of max) per rounding step — each reduction block,
    plus the fused derivative's rounding — as in the paper_fp16 checks; an
    fp16 store after fp32 accumulation two ulps (2^-9); fp32 stores after
    fp32 accumulation 1e-5 (summation order only); a transcendental
    derivative 2e-2 (the reference's)."""
    import dataclasses

    import torch

    from repro_torch.core import precision as prec
    from repro_torch.core import tiling
    from repro_torch.core.engine import _grad_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    E4, E5 = torch.float8_e4m3fn, torch.float8_e5m2
    e4, e5 = prec.MIXED_FP8_E4M3, prec.MIXED_FP8_E5M2
    g4, g5 = _grad_policy(e4), _grad_policy(e5)
    s4 = dataclasses.replace(e4, name=e4.name + "_scores",
                             output_dtype=torch.float32, faithful_accum=False)
    ulp = 2.0 ** -10

    def q(*shape, dtype=E4):
        """A random operand quantized per tensor, as the engine does."""
        return prec.quantize_fp8(torch.randn(shape, generator=g, device=dev),
                                 dtype)[0]

    launched = set()

    def both(name, x, w, policy, tol, *, batched=False, **kw):
        fn = ops.redmule_matmul_batched if batched else ops.redmule_matmul
        if policy.blockwise_accum and "accum_block" not in kw:
            M, N, K = rm.logical_dims(x.shape, w.shape, kw.get("layout", "nn"))
            kw["accum_block"] = tiling.accum_block(
                M, N, K, compute_dtype=torch.float16, accum_dtype=torch.float16,
                fused_bwd=bool(kw.get("grad_epilogue") or kw.get("bias_grad")),
                x_dtype=x.dtype, w_dtype=w.dtype)
        got = fn(x, w, policy=policy, **kw)
        launched.add((x.dtype, w.dtype, policy.out_dtype, bool(
            kw.get("accum_block") or kw.get("grad_epilogue") or kw.get("bias_grad"))))
        wide = fn(x.half(), w.half(), policy=policy, **kw)
        want = rm.redmule_matmul_plain(x, w, policy=policy, **kw)
        pairs = zip(got, wide) if kw.get("bias_grad") else ((got, wide),)
        same = all(torch.equal(a, b) for a, b in pairs)
        log.append({"check": name + ": FP8 == pre-widened fp16 launch",
                    "bitwise": same, "ok": same})
        print(f"[check] {name}: FP8 vs pre-widened fp16 launch "
              f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        if not same:
            raise AssertionError(f"{name}: the FP8 launch differs from the "
                                 "pre-widened fp16 launch")
        if kw.get("bias_grad"):
            _check(name + " db", got[1], want[1], tol, log)
            return _check(name, got[0], want[0], tol, log)
        return _check(name, got, want, tol, log)

    # the AutoEncoder under mixed_fp8_e4m3 (faithful): forward E4M3 x E4M3,
    # dX E5M2 dZ x E4M3 W ("nt"), dW E4M3 X x E5M2 dZ ("tn"), batch 16 and
    # 4096 (the dW reduction over 4096 rows spans 2 blocks of 2048)
    B, d_in, d_h = 16, 640, 128
    x16, w0 = q(B, d_in), q(d_in, d_h)
    both("fp8 e4m3 nn AE fc0 M=16 N=640 K=128", x16, w0, e4, 2 * ulp)
    both("fp8 e5m2 x e4m3 nt dX AE fc0 M=16 N=128 K=640", q(B, d_h, dtype=E5),
         w0, g4, 2 * ulp, layout="nt")
    both("fp8 e4m3 x e5m2 tn dW AE fc0 M=640 N=16 K=128", x16,
         q(B, d_h, dtype=E5), g4, 2 * ulp, layout="tn")
    xb, dzb = q(4096, d_in), q(4096, d_h, dtype=E5)
    both("fp8 e4m3 x e5m2 tn dW AE fc0 M=640 N=4096 K=128 (2 blocks)", xb, dzb,
         g4, 3 * ulp, layout="tn")
    # the 8-wide bottleneck: extents of 8 take the scalar (unvectorised) load
    w4, w5 = q(d_h, 8), q(8, d_h)
    both("fp8 e4m3 nn AE fc4 M=16 N=128 K=8 (scalar w)", q(B, d_h), w4, e4,
         2 * ulp)
    both("fp8 e4m3 nn AE fc5 M=16 N=8 K=128 (scalar x)", q(B, 8), w5, e4,
         2 * ulp)
    both("fp8 e5m2 x e4m3 nt dX AE fc4 M=16 N=8 K=128", q(B, 8, dtype=E5), w4,
         g4, 2 * ulp, layout="nt")
    both("fp8 e4m3 x e5m2 tn dW AE fc5 M=8 N=16 K=128", q(B, 8),
         q(B, d_h, dtype=E5), g4, 2 * ulp, layout="tn")
    # unaligned: a view one byte into its storage, odd strides
    xu = q(B + 1, d_in + 3)[1:, 3:]
    both("fp8 e4m3 nn unaligned view M=16 N=640 K=128", xu, w0, e4, 2 * ulp)
    # the fused backward on FP8 dZ: act' on load (nt, tn) and db
    dzx, dzw = q(B, d_h, dtype=E5), q(4096, d_h, dtype=E5)
    dder = (torch.randn(B, d_h, generator=g, device=dev)).half()
    wder = (torch.randn(4096, d_h, generator=g, device=dev)).half()
    both("fp8 e5m2 x e4m3 nt dX deriv relu M=16 N=128 K=640", dzx, w0, g4,
         2 * ulp, layout="nt", deriv=dder.relu(), grad_epilogue="relu",
         grad_from_output=True)
    both("fp8 e4m3 x e5m2 tn dW+db deriv gelu M=640 N=4096 K=128", xb, dzw, g4,
         2e-2, layout="tn", deriv=wder, grad_epilogue="gelu", bias_grad=True)
    # mixed_fp8_e5m2 (fp32 accumulator): E5M2 x E5M2, fp16 forward, fp32 grads
    x5, w5b = q(B, d_in, dtype=E5), q(d_in, d_h, dtype=E5)
    err_e5 = both("fp8 e5m2 nn AE fc0 M=16 N=640 K=128 (fp32 acc)", x5, w5b, e5,
                  2 * ulp)
    both("fp8 e5m2 nt dX AE fc0 M=16 N=128 K=640 (fp32 out)",
         q(B, d_h, dtype=E5), w5b, g5, 1e-5, layout="nt")
    both("fp8 e5m2 tn dW AE fc0 M=640 N=4096 K=128 (fp32 out)",
         q(4096, d_in, dtype=E5), q(4096, d_h, dtype=E5), g5, 1e-5, layout="tn")

    # qwen3-1.7b serving under mixed_fp8_e4m3: the tied head ("nt"), the
    # prefill projections, and kernel 2's decode scores (fp32 out) and PV
    d, V, ff, hq, hkv, hd = 2048, 151936, 6144, 16, 8, 128
    T = PROMPT + GEN
    x_dec, emb = q(BATCH, d), q(V, d)
    err_head = both("fp8 e4m3 nt tied head M=4 N=2048 K=151936", x_dec, emb, e4,
                    2 * ulp, layout="nt")
    both("fp8 e4m3 nn wqkv prefill M=128 N=2048 K=4096", q(PROMPT, d),
         q(d, (hq + 2 * hkv) * hd), e4, 2 * ulp)
    both("fp8 e4m3 nn w_out prefill M=128 N=6144 K=2048 (3 blocks)",
         q(PROMPT, ff), q(ff, d), e4, 4 * ulp)
    kc, qt = q(BATCH * hkv, T, hd), q(BATCH * hkv, hd, hq // hkv)
    err_sc = both("fp8 e4m3 batched decode scores B=32 M=144 N=128 K=2 "
                  "(fp32 out)", kc, qt, s4, 2 * ulp, batched=True)
    p8, v8 = q(BATCH, hkv, hq // hkv, 1, T), q(BATCH, hkv, 1, T, hd)
    both("fp8 e4m3 batched decode PV B=4x8x2 M=1 N=144 K=128 (V broadcast)",
         p8, v8, e4, 2 * ulp, batched=True)
    # the kernel's compiled pairs are what the Python side declares: each
    # declared pair launched above, and an undeclared one fails in the
    # kernel's own dispatch (it is never widened)
    same = launched == rm.FP8_KERNELS
    log.append({"check": "FP8 pairs launched == FP8_KERNELS", "ok": same})
    if not same:
        raise AssertionError(f"FP8 pairs launched {sorted(map(str, launched))} "
                             f"differ from FP8_KERNELS")
    try:
        ops.redmule_matmul(x5, w5b, policy=e4)
    except RuntimeError as e:
        log.append({"check": "undeclared FP8 pair fails", "ok": True})
        print(f"[check] undeclared FP8 pair fails: {e}"[:200], flush=True)
    else:
        raise AssertionError("an undeclared FP8 pair (e5m2 x e5m2 -> fp16 "
                             "faithful forward) did not fail")
    torch.cuda.synchronize()

    src = "src/repro_torch/csrc/redmule_matmul.cu"

    def bound(M, N, K, out_bytes, batch=1, w_batch=None):
        # FP8 operands at one byte per element; FP8 tensor-core peak
        wb = batch if w_batch is None else w_batch
        return _bound_ms(batch * M * N + wb * N * K + batch * M * K * out_bytes,
                         2 * batch * M * N * K, FP8_FLOPS)

    head_blk = tiling.accum_block(BATCH, d, V, compute_dtype=torch.float16,
                                  accum_dtype=torch.float16, x_dtype=E4,
                                  w_dtype=E4)
    return [
        dict(name="redmule_matmul (FP8 e4m3, faithful)", group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches_fp8"),
             paths=("serve8", "ae8", "ae8_b4096"), source=src,
             replaces="src/repro/kernels/redmule_matmul.py:289", err=err_head,
             bound=bound(BATCH, d, V, 2),
             shape="nt tied head M=4 N=2048 K=151936, e4m3 x e4m3 -> fp16, "
                   "faithful (1 block)",
             kernel=lambda: ops.redmule_matmul(x_dec, emb, policy=e4, layout="nt",
                                               accum_block=head_blk),
             plain=lambda: rm.redmule_matmul_plain(x_dec, emb, policy=e4,
                                                   layout="nt",
                                                   accum_block=head_blk),
             library=lambda: torch.matmul(x_dec.half(), emb.half().t())),
        dict(name="redmule_matmul (FP8 e5m2, fp32 accumulator)",
             group="redmule_gemm", counter=(ops.redmule_matmul, "launches_fp8"),
             paths=("ae8_e5m2",), source=src,
             replaces="src/repro/kernels/redmule_matmul.py:289", err=err_e5,
             bound=bound(B, d_in, d_h, 2),
             shape="AE fc0 forward nn M=16 N=640 K=128, e5m2 x e5m2 -> fp16",
             kernel=lambda: ops.redmule_matmul(x5, w5b, policy=e5),
             plain=lambda: rm.redmule_matmul_plain(x5, w5b, policy=e5),
             library=lambda: torch.matmul(x5.half(), w5b.half())),
        dict(name="redmule_matmul_batched (FP8 e4m3, decode scores)",
             group="redmule_gemm",
             counter=(ops.redmule_matmul_batched, "launches_fp8"),
             paths=("serve8",), source=src,
             replaces="src/repro/kernels/redmule_matmul.py:478", err=err_sc,
             bound=bound(T, hd, hq // hkv, 4, batch=BATCH * hkv),
             shape="decode scores B=32 M=144 N=128 K=2, e4m3 x e4m3 -> fp32, "
                   "fp16 accumulator",
             kernel=lambda: ops.redmule_matmul_batched(kc, qt, policy=s4),
             plain=lambda: rm.redmule_matmul_plain(kc, qt, policy=s4),
             library=lambda: torch.matmul(kc.half(), qt.half()).float()),
    ]


@contextlib.contextmanager
def _launch_log():
    """Record every GEMM kernel launch while open: its logical (M, N, K),
    layout, the tile it ran and the split plan it took (as
    ``kernels/redmule_matmul.py::launch`` receives them)."""
    from repro_torch.kernels import redmule_matmul as rm

    seen = []
    real = rm.launch

    def spy(x, w, *, tile, plan, layout, **kw):
        seen.append({"mnk": rm.logical_dims(x.shape, w.shape, layout),
                     "layout": layout, "tile": (tile.bm, tile.bn, tile.bk),
                     "splits": plan.splits, "depth": plan.depth})
        return real(x, w, tile=tile, plan=plan, layout=layout, **kw)

    rm.launch = spy
    try:
        yield seen
    finally:
        rm.launch = real


def _with_splits(fn):
    """``(fn(), S)``: what one call returns, and the number of slices its
    GEMM launch split the reduction into (the plan the launch ran); S is
    None where ``fn`` launches no GEMM."""
    with _launch_log() as seen:
        out = fn()
    return out, (max(r["splits"] for r in seen) if seen else None)


def split_checks(log, g):
    """The split of the reduction (kernels 1 and 2, both routes) on the
    card: the serving and training shapes it exists for, each against its
    plain version, and cases of the split itself — a last slice shorter
    than the others (N not a multiple of S x 32), the faithful accumulator
    over 3 rounding blocks of 4 slices each, an FP8 pair (still bitwise
    equal to the launch on pre-widened fp16 operands), a batched launch
    with a broadcast (stride-0) operand, the fp32 route with a ragged last
    slice.  Every launch is repeated and must be bitwise equal run to run:
    the last block of a tile sums the slices in split order, whichever
    block arrives last.  Returns the rows to time; the decode and prefill
    rows read, call after call, the next of several weight copies (more
    than the 50 MB L2 holds), as the serving step finds its weights cold.

    Tolerances: a bf16 output two ulps (2^-7 of max); fp32 1e-5 of max
    (summation order); the faithful accumulator one fp16 ulp (2^-10) per
    rounding block plus one, since each block's slices are summed in fp32
    in another order than the plain version's one dot, then rounded."""
    import itertools

    import torch

    from repro_torch.core import precision as prec
    from repro_torch.core import tiling
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    bf, f32, paper = prec.TPU_BF16, prec.FP32, prec.PAPER_FP16
    E4 = torch.float8_e4m3fn
    ulp, tol_bf16, tol_fp32 = 2.0 ** -10, 2.0 ** -7, 1e-5

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def both(name, x, w, policy, tol, *, batched=False, split=True, **kw):
        """The launch against its plain version, and against itself run to
        run; ``split``: S must be above 1.  Returns (max_abs_err, S)."""
        fn = ops.redmule_matmul_batched if batched else ops.redmule_matmul
        got, S = _with_splits(lambda: fn(x, w, policy=policy, **kw))
        if split and S <= 1:
            raise AssertionError(f"{name}: the launch did not split (S = {S})")
        same = torch.equal(got, fn(x, w, policy=policy, **kw))
        log.append({"check": name + ": run to run", "splits": S, "bitwise": same,
                    "ok": same})
        print(f"[check] {name}: S={S}, run to run "
              f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        if not same:
            raise AssertionError(f"{name}: two launches differ")
        want = rm.redmule_matmul_plain(x, w, policy=policy, **kw)
        return _check(f"{name} (S={S})", got, want, tol, log), S

    # the last slice shorter than the others (N = 2000 in slices of 128),
    # and ragged K
    both("split gemm nn M=4 N=2000 K=1000 bf16 (ragged last slice)", rnd(4, 2000),
         rnd(2000, 1000, scale=2000 ** -0.5), bf, tol_bf16)
    # the faithful accumulator: 3 rounding blocks of 512, 4 slices each
    both("split faithful nn M=16 N=1536 K=256 +bias, 3 blocks of 512",
         rnd(16, 1536, dtype=torch.float16),
         rnd(1536, 256, dtype=torch.float16, scale=1536 ** -0.5), paper, 4 * ulp,
         bias=rnd(256, dtype=torch.float16), accum_block=512)
    # an FP8 pair on the decode wqkv: bitwise equal to the pre-widened launch
    x8 = prec.quantize_fp8(torch.randn(BATCH, 2048, generator=g, device=dev), E4)[0]
    w8 = prec.quantize_fp8(torch.randn(2048, 4096, generator=g, device=dev), E4)[0]
    blk8 = tiling.accum_block(BATCH, 2048, 4096, compute_dtype=torch.float16,
                              accum_dtype=torch.float16, x_dtype=E4, w_dtype=E4)
    e4 = prec.MIXED_FP8_E4M3
    both("split fp8 e4m3 nn decode wqkv M=4 N=2048 K=4096, faithful", x8, w8, e4,
         2 * ulp, accum_block=blk8)
    same = torch.equal(ops.redmule_matmul(x8, w8, policy=e4, accum_block=blk8),
                       ops.redmule_matmul(x8.half(), w8.half(), policy=e4,
                                          accum_block=blk8))
    log.append({"check": "split fp8 decode wqkv: FP8 == pre-widened fp16 launch",
                "bitwise": same, "ok": same})
    print(f"[check] split fp8 decode wqkv: FP8 vs pre-widened fp16 launch "
          f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
    if not same:
        raise AssertionError("split FP8 launch differs from the pre-widened one")
    # batched, w broadcast over both batch levels (stride 0)
    both("split batched nn B=2x4 M=4 N=2048 K=256 bf16, w broadcast",
         rnd(2, 4, BATCH, 2048), rnd(2048, 256, scale=2048 ** -0.5), bf, tol_bf16,
         batched=True)
    # the fp32 route: "nt", 16 slices of 64, the last holding 40 rows
    both("split fp32 nt M=30 N=1000 K=50 (ragged last slice)", rnd(30, 1000,
         dtype=torch.float32), rnd(50, 1000, dtype=torch.float32), f32, tol_fp32,
         layout="nt")

    # the rows: qwen3-1.7b's decode and prefill GEMMs (bf16), the xLSTM's
    # fp32 gates dW and sLSTM recurrence (4 heads of 512)
    d, ff, qkv = 2048, 6144, (16 + 2 * 8) * 128

    def copies(t):
        n = max(1, math.ceil(100 * 2 ** 20 / (t.numel() * t.element_size())))
        return [t] + [t.clone() for _ in range(n - 1)]

    def cycling(f, ws):
        it = itertools.cycle(ws)
        return lambda: f(next(it))

    def bf_bound(M, N, K):
        return _bound_ms((M * N + N * K + M * K) * 2, 2 * M * N * K)

    def f32_bound(M, N, K, batch=1):
        return _bound_ms(batch * (M * N + N * K + M * K) * 4, 2 * batch * M * N * K,
                         FP32_FLOPS)

    src = "src/repro_torch/csrc/redmule_matmul.cu"
    rep1 = "src/repro/kernels/redmule_matmul.py:289"
    rep2 = "src/repro/kernels/redmule_matmul.py:478"
    rows = []

    def cold_row(name, shape, M, N, K, counter, paths, split):
        x = rnd(M, N)
        ws = copies(rnd(N, K, scale=N ** -0.5))
        err, _ = both(f"gemm nn {shape}", x, ws[0], bf, tol_bf16, split=split)
        rows.append(dict(
            name=name, group="redmule_gemm", counter=counter, paths=paths,
            source=src, replaces=rep1, err=err, bound=bf_bound(M, N, K),
            shape=f"{shape} bf16, L2 cold ({len(ws)} weight copies)",
            kernel=cycling(lambda w: ops.redmule_matmul(x, w, policy=bf), ws),
            plain=cycling(lambda w: rm.redmule_matmul_plain(x, w, policy=bf), ws),
            library=cycling(lambda w: torch.matmul(x, w), ws)))

    split1 = (ops.redmule_matmul, "launches_split")
    split2 = (ops.redmule_matmul_batched, "launches_split")
    cold_row("redmule_matmul (split, decode w_out)", "decode w_out M=4 N=6144 K=2048",
             BATCH, ff, d, split1, ("serve", "serve8"), True)
    cold_row("redmule_matmul (split, decode wqkv)", "decode wqkv M=4 N=2048 K=4096",
             BATCH, d, qkv, split1, ("serve", "serve8"), True)
    cold_row("redmule_matmul (ring, prefill w_in)", "prefill w_in M=128 N=2048 K=12288",
             PROMPT, d, 2 * ff, (ops.redmule_matmul, "launches"), ("serve",), False)
    xg, dzg = rnd(T_BATCH * T_SEQ, 4096, dtype=torch.float32), rnd(
        T_BATCH * T_SEQ, 8, dtype=torch.float32)
    err, _ = both("split fp32 tn gates dW M=4096 N=1024 K=8", xg, dzg, f32, tol_fp32,
                  layout="tn")
    rows.append(dict(
        name="redmule_matmul (fp32 route, split, gates dW)", group="redmule_gemm_f32",
        counter=split1, paths=("train",), source=src, replaces=rep1, err=err,
        bound=f32_bound(4096, T_BATCH * T_SEQ, 8),
        shape="mLSTM gates dW tn M=4096 N=1024 K=8 fp32",
        kernel=lambda: ops.redmule_matmul(xg, dzg, policy=f32, layout="tn"),
        plain=lambda: rm.redmule_matmul_plain(xg, dzg, policy=f32, layout="tn"),
        library=lambda: torch.matmul(xg.t(), dzg)))
    h, r = rnd(4, T_BATCH, 512, dtype=torch.float32), rnd(4, 512, 2048,
                                                          dtype=torch.float32,
                                                          scale=512 ** -0.5)
    dzr = rnd(4, T_BATCH, 2048, dtype=torch.float32)
    err_h, _ = both("split batched fp32 nn sLSTM recurrence B=4 M=4 N=512 K=2048",
                    h, r, f32, tol_fp32, batched=True)
    err_i, _ = both("split batched fp32 nt sLSTM dX B=4 M=4 N=2048 K=512",
                    dzr, r, f32, tol_fp32, batched=True, layout="nt")
    rows += [
        dict(name="redmule_matmul_batched (fp32 route, split, sLSTM recurrence)",
             group="redmule_gemm_f32", counter=split2, paths=("train",), source=src,
             replaces=rep2, err=err_h, bound=f32_bound(T_BATCH, 512, 2048, 4),
             shape="sLSTM recurrence nn B=4 M=4 N=512 K=2048 fp32",
             kernel=lambda: ops.redmule_matmul_batched(h, r, policy=f32),
             plain=lambda: rm.redmule_matmul_plain(h, r, policy=f32),
             library=lambda: torch.matmul(h, r)),
        dict(name="redmule_matmul_batched (fp32 route, split, sLSTM dX)",
             group="redmule_gemm_f32", counter=split2, paths=("train",), source=src,
             replaces=rep2, err=err_i, bound=f32_bound(T_BATCH, 2048, 512, 4),
             shape="sLSTM recurrence dX nt B=4 M=4 N=2048 K=512 fp32",
             kernel=lambda: ops.redmule_matmul_batched(dzr, r, policy=f32, layout="nt"),
             plain=lambda: rm.redmule_matmul_plain(dzr, r, policy=f32, layout="nt"),
             library=lambda: torch.matmul(dzr, r.transpose(-1, -2)))]
    torch.cuda.synchronize()
    return rows


def kernel_phase(log):
    """Each kernel vs its plain version at the main path's shapes; times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import precision as prec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16, pol = torch.bfloat16, prec.TPU_BF16
    torch.backends.cuda.matmul.allow_tf32 = False    # the fp32 plain versions
    scores = prec.Policy("tpu_bf16_scores", bf16, torch.float32, torch.float32)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf16)

    # bf16 outputs: both sides sum the same bf16 products in fp32 and differ
    # only in order, but the final bf16 rounding may then differ by one ulp
    # (2^-8 relative): allow two ulps at the top of the range.  fp32 outputs
    # (decode scores): summation order only, N = 128 terms.
    tol_bf16, tol_f32 = 2.0 ** -7, 1e-4

    def gemm(name, x, w, layout, policy=pol, bias=None, epilogue=None,
             tol=tol_bf16):
        got = ops.redmule_matmul(x, w, policy=policy, layout=layout,
                                 bias=bias, epilogue=epilogue)
        want = rm.redmule_matmul_plain(x, w, policy=policy, layout=layout,
                                       bias=bias, epilogue=epilogue)
        return _check(name, got, want, tol, log)

    d, V, ff, hq, hkv, hd = 2048, 151936, 6144, 16, 8, 128
    T = PROMPT + GEN
    # kernel 1: the tied head ("nt"), the decode and prefill projections
    x_dec, emb = rnd(BATCH, d), rnd(V, d, scale=0.02)
    err_head = gemm("gemm nt tied head M=4 N=2048 K=151936", x_dec, emb, "nt")
    gemm("gemm nn wqkv decode M=4 N=2048 K=4096", x_dec,
         rnd(d, (hq + 2 * hkv) * hd, scale=d ** -0.5), "nn")
    gemm("gemm nn w_in prefill M=128 N=2048 K=12288", rnd(PROMPT, d),
         rnd(d, 2 * ff, scale=d ** -0.5), "nn")
    gemm("gemm nn w_out prefill M=128 N=6144 K=2048", rnd(PROMPT, ff),
         rnd(ff, d, scale=ff ** -0.5), "nn")
    gemm("gemm tn M=100 N=300 K=72", rnd(300, 100), rnd(300, 72), "tn")
    gemm("gemm nn bias+gelu M=77 N=200 K=130", rnd(77, 200), rnd(200, 130),
         "nn", bias=torch.randn(130, generator=g, device=dev),
         epilogue="gelu")
    # fp16 operands and output (tpu_fp16): one fp16 ulp is 2^-10 relative
    gemm("gemm nt fp16 bias+silu M=33 N=96 K=40", rnd(33, 96).half(),
         rnd(40, 96).half(), "nt", policy=prec.TPU_FP16,
         bias=torch.randn(40, generator=g, device=dev), epilogue="silu",
         tol=2.0 ** -9)

    # kernel 2: the ragged decode scores (fp32 out) and the decode PV with V
    # broadcast over the two q heads of each KV head (batch stride 0)
    kc = rnd(BATCH * hkv, T, hd)
    qt = rnd(BATCH * hkv, hd, hq // hkv)
    got = ops.redmule_matmul_batched(kc, qt, policy=scores)
    _check("batched scores B=32 M=144 N=128 K=2 (fp32 out)", got,
           rm.redmule_matmul_plain(kc, qt, policy=scores), tol_f32, log)
    p = torch.softmax(torch.randn(BATCH, hkv, hq // hkv, 1, T, generator=g,
                                  device=dev), -1).to(bf16)
    v = rnd(BATCH, hkv, 1, T, hd)
    err_pv = _check("batched PV B=4x8x2 M=1 N=144 K=128 (V broadcast)",
                    ops.redmule_matmul_batched(p, v, policy=pol),
                    rm.redmule_matmul_plain(p, v, policy=pol), tol_bf16, log)

    # kernel 3: prefill flash (16 / 8 heads, D = 128, S = 128 in a T = 144
    # cache), and a continuation at q_offset > 0
    q, k, vv = rnd(hq, PROMPT, hd), rnd(hkv, T, hd), rnd(hkv, T, hd)
    fl = dict(group=hq // hkv, t_valid=PROMPT, q_offset=0)
    err_fl = _check("flash Hq=16 Hkv=8 D=128 S=128 T=144 q_offset=0",
                    fa.flash_attention(q, k, vv, **fl),
                    fa.flash_attention_plain(q, k, vv, **fl), tol_bf16, log)
    q2 = rnd(hq, GEN, hd)
    fl2 = dict(group=hq // hkv, t_valid=T, q_offset=PROMPT)
    _check("flash Hq=16 Hkv=8 D=128 S=16 T=144 q_offset=128",
           fa.flash_attention(q2, k, vv, **fl2),
           fa.flash_attention_plain(q2, k, vv, **fl2), tol_bf16, log)
    # the other compiled variants: fp16, D = 64, non-causal, ragged S / T
    q3, k3, v3 = (rnd(8, 100, 64).half(), rnd(4, 130, 64).half(),
                  rnd(4, 130, 64).half())
    for causal in (True, False):
        fl3 = dict(group=2, causal=causal, t_valid=120, q_offset=10)
        _check(f"flash fp16 Hq=8 Hkv=4 D=64 S=100 T=130 causal={causal}",
               fa.flash_attention(q3, k3, v3, **fl3),
               fa.flash_attention_plain(q3, k3, v3, **fl3), 2.0 ** -9, log)
    # the shapes the tensor-core design makes tricky: a prompt whose T spans
    # 16 rounds of the copy ring, a q tile count that does not divide S
    # (200 = 12.5 x 16), one q head per KV head, fp16 at D = 128; every
    # launch twice, bitwise equal (no atomics: each output is written once,
    # after a fixed-order merge)
    for name, (hq_, hkv_, S_, T_, tv_, qo_, dt) in {
            "S=T=1024": (hq, hkv, 1024, 1024, 1024, 0, bf16),
            "S=200 T=232 q_offset=32": (hq, hkv, 200, 232, 232, 32, bf16),
            "MHA Hq=Hkv=6 S=77 T=90": (6, 6, 77, 90, 85, 5, bf16),
            "fp16 S=16 T=24 (serve8's cut)": (hq, hkv, 16, 24, 16, 0,
                                               torch.float16)}.items():
        ql, kl, vl = (rnd(h_, n_, hd).to(dt) for h_, n_ in
                      ((hq_, S_), (hkv_, T_), (hkv_, T_)))
        fll = dict(group=hq_ // hkv_, t_valid=tv_, q_offset=qo_)
        got = fa.flash_attention(ql, kl, vl, **fll)
        _check(f"flash Hq={hq_} Hkv={hkv_} D=128 {name}", got,
               fa.flash_attention_plain(ql, kl, vl, **fll),
               tol_bf16 if dt == bf16 else 2.0 ** -9, log)
        _repeat(f"flash {name}", got, fa.flash_attention(ql, kl, vl, **fll), log)
    _repeat("flash Hq=16 Hkv=8 D=128 S=128 T=144 q_offset=0",
            fa.flash_attention(q, k, vv, **fl), fa.flash_attention(q, k, vv, **fl), log)

    # the fp32 route of kernels 1 and 2 (SIMT fp32 FMAs, no TF32): fp32 sums
    # in another order, N <= 1024 terms
    from repro_torch.kernels import chunked_linear_attention as cla

    f32, tol_fp32 = prec.FP32, 1e-5

    def rnd32(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    x_gate, w_gate = rnd32(T_BATCH * T_SEQ, 4096), rnd32(4096, 8, scale=4096 ** -0.5)
    err_g32 = _check("gemm fp32 nn mLSTM gates M=1024 N=4096 K=8",
                     ops.redmule_matmul(x_gate, w_gate, policy=f32),
                     rm.redmule_matmul_plain(x_gate, w_gate, policy=f32),
                     tol_fp32, log)
    dz_gate = rnd32(T_BATCH * T_SEQ, 8)
    _check("gemm fp32 nt gates dX M=1024 N=8 K=4096",
           ops.redmule_matmul(dz_gate, w_gate, policy=f32, layout="nt"),
           rm.redmule_matmul_plain(dz_gate, w_gate, policy=f32, layout="nt"),
           tol_fp32, log)
    _check("gemm fp32 tn gates dW M=4096 N=1024 K=8",
           ops.redmule_matmul(x_gate, dz_gate, policy=f32, layout="tn"),
           rm.redmule_matmul_plain(x_gate, dz_gate, policy=f32, layout="tn"),
           tol_fp32, log)
    xr, wr = rnd32(77, 200), rnd32(200, 130)
    _check("gemm fp32 nn ragged M=77 N=200 K=130",
           ops.redmule_matmul(xr, wr, policy=f32),
           rm.redmule_matmul_plain(xr, wr, policy=f32), tol_fp32, log)
    # batched: the sweep backward's inter-chunk read (16 heads, 64 x 1024 x
    # 1024), its dX / dW layouts, and the sLSTM recurrence (4 heads)
    BH, C, DK = T_BATCH * 4, 64, 1024
    qe, st = rnd32(BH, C, DK), rnd32(BH, DK, DK, scale=DK ** -0.5)
    err_b32 = _check("batched fp32 nn inter B=16 M=64 N=1024 K=1024",
                     ops.redmule_matmul_batched(qe, st, policy=f32),
                     rm.redmule_matmul_plain(qe, st, policy=f32), tol_fp32, log)
    do = rnd32(BH, C, DK)
    _check("batched fp32 nt inter dX B=16 M=64 N=1024 K=1024",
           ops.redmule_matmul_batched(do, st, policy=f32, layout="nt"),
           rm.redmule_matmul_plain(do, st, policy=f32, layout="nt"), tol_fp32, log)
    _check("batched fp32 tn inter dW B=16 M=1024 N=64 K=1024",
           ops.redmule_matmul_batched(qe, do, policy=f32, layout="tn"),
           rm.redmule_matmul_plain(qe, do, policy=f32, layout="tn"), tol_fp32, log)
    h_s, r_s = rnd32(4, T_BATCH, 512), rnd32(4, 512, 2048, scale=512 ** -0.5)
    _check("batched fp32 nn sLSTM recurrence B=4 M=4 N=512 K=2048",
           ops.redmule_matmul_batched(h_s, r_s, policy=f32),
           rm.redmule_matmul_plain(h_s, r_s, policy=f32), tol_fp32, log)

    # kernel 4: the training shape (16 (batch, head) pairs, S 256, dk = dv =
    # 1024, chunk 64, bf16), a ragged dk != dv shape at chunk 16, fp32 input.
    # fp32 inside; for 16-bit inputs the state (fp32) differs in summation
    # order over up to 4 x 64 x 1024 terms and L's fp32 scan (1e-4), the
    # output is stored in the input dtype (bf16: one-ulp flips, 2^-7); fp32
    # inputs (three TF32 pieces, L in fp64): K4_FP32_TOL for both.
    def sweep(BH_, S_, dk_, dv_, dtype):
        q = (torch.randn(BH_, S_, dk_, generator=g, device=dev) * dk_ ** -0.5).to(dtype)
        k = (torch.randn(BH_, S_, dk_, generator=g, device=dev) * 0.5).to(dtype)
        v = torch.randn(BH_, S_, dv_, generator=g, device=dev).to(dtype)
        lg = -torch.rand(BH_, S_, generator=g, device=dev) * 0.1
        return q, k, v, lg

    # chunk 128 at dk = dv = 1024 (the largest shared-memory plan), and a dv
    # that is not a multiple of the sweep's 32-column tile.  Every launch
    # twice, bitwise equal (no atomics: each output and state element is
    # written once by one thread, after a fixed-order sum).
    cla_cases = [("train BH=16 S=256 dk=dv=1024 chunk=64 bf16",
                  (BH, T_SEQ, DK, DK, torch.bfloat16), 64),
                 ("ragged BH=6 S=48 dk=16 dv=64 chunk=16 bf16",
                  (6, 48, 16, 64, torch.bfloat16), 16),
                 ("fp32 BH=4 S=256 dk=96 dv=40 chunk=128",
                  (4, 256, 96, 40, torch.float32), 128),
                 ("fp16 BH=3 S=64 dk=64 dv=64 chunk=32",
                  (3, 64, 64, 64, torch.float16), 32),
                 ("BH=4 S=256 dk=dv=1024 chunk=128 bf16",
                  (4, 256, DK, DK, torch.bfloat16), 128),
                 ("BH=2 S=128 dk=1024 dv=1000 chunk=64 bf16",
                  (2, 128, DK, 1000, torch.bfloat16), 64),
                 ("fp32 BH=2 S=256 dk=dv=1024 chunk=128",
                  (2, 256, DK, DK, torch.float32), 128)]
    cla_in = None
    for name, shape, chunk in cla_cases:
        ins = sweep(*shape)
        out, state = cla.chunked_linear_attention(*ins, chunk=chunk)
        want_o, want_s = cla.chunked_linear_attention_plain(*ins, chunk=chunk)
        tol_o = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -9,
                 torch.float32: K4_FP32_TOL}[shape[-1]]
        tol_s = K4_FP32_TOL if shape[-1] == torch.float32 else 1e-4
        err = _check(f"sweep {name} out", out, want_o, tol_o, log)
        _check(f"sweep {name} state", state, want_s, tol_s, log)
        out2, state2 = cla.chunked_linear_attention(*ins, chunk=chunk)
        _repeat(f"sweep {name} out", out, out2, log)
        _repeat(f"sweep {name} state", state, state2, log)
        if cla_in is None:
            cla_in, err_cla = ins, err
    torch.cuda.synchronize()

    # times at one main-path shape per kernel
    head_b, head_f = _bound_ms((BATCH * d + V * d + BATCH * V) * 2, 2 * BATCH * d * V)
    pv_b, pv_f = _bound_ms(p.numel() * 2 + BATCH * hkv * T * hd * 2
                           + BATCH * hq * hd * 2, 2 * BATCH * hq * T * hd)
    rows = torch.arange(PROMPT)
    pairs = int(torch.clamp(rows + 1, max=PROMPT).sum())
    fl_b, fl_f = _bound_ms((2 * hq * PROMPT * hd + 2 * hkv * PROMPT * hd) * 2,
                           4 * hq * pairs * hd)
    q4, k4, v4 = q[None], k[None, :, :PROMPT], vv[None, :, :PROMPT]
    # kernel 4's bound at the training shape: q, k, v, g read once, out and
    # the fp32 state written once; the causal score / PV pairs plus the
    # inter-chunk read and state update, all fp32 FMAs.  Beside it, the
    # bound of the products as the kernel runs them on TF32 tensor cores:
    # qk^T once (its operands are exact), the three products with an fp32
    # operand twice (big and small piece)
    BHc, Sc, dkc, dvc = cla_in[0].shape[0], T_SEQ, DK, DK
    n_ch, pairs_c = Sc // 64, 64 * 65 // 2
    cla_bytes = (2 * BHc * Sc * dkc * 2 + 2 * BHc * Sc * dvc * 2 + BHc * Sc * 4
                 + BHc * dkc * dvc * 4)
    cla_b, cla_f = _bound_ms(
        cla_bytes,
        BHc * n_ch * (2 * pairs_c * (dkc + dvc) + 4 * 64 * dkc * dvc), FP32_FLOPS)
    cla_tc = _bound_ms(
        cla_bytes,
        BHc * n_ch * (2 * pairs_c * dkc + 2 * (2 * pairs_c * dvc
                                                + 4 * 64 * dkc * dvc)), TF32_FLOPS)
    g32_b, g32_f = _bound_ms((x_gate.numel() + w_gate.numel()
                              + T_BATCH * T_SEQ * 8) * 4,
                             2 * T_BATCH * T_SEQ * 4096 * 8, FP32_FLOPS)
    b32_b, b32_f = _bound_ms((qe.numel() + st.numel() + qe.numel()) * 4,
                             2 * BH * C * DK * DK, FP32_FLOPS)
    torch.backends.cuda.matmul.allow_tf32 = False    # full-fp32 yardsticks
    # fp16 yardsticks accumulate in fp32 and round once (the faithful
    # accumulator's function where the reduction is one block)
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    runs = [
        dict(name="redmule_matmul", group="redmule_gemm",
             counter=(ops.redmule_matmul, "launches"),
             source="src/repro_torch/csrc/redmule_matmul.cu",
             replaces="src/repro/kernels/redmule_matmul.py:289",
             shape="nt tied head M=4 N=2048 K=151936 bf16", err=err_head,
             bound=(head_b, head_f),
             kernel=lambda: ops.redmule_matmul(x_dec, emb, policy=pol, layout="nt"),
             plain=lambda: rm.redmule_matmul_plain(x_dec, emb, policy=pol, layout="nt"),
             library=lambda: torch.matmul(x_dec, emb.t())),
        dict(name="redmule_matmul_batched", group="redmule_gemm",
             counter=(ops.redmule_matmul_batched, "launches"),
             source="src/repro_torch/csrc/redmule_matmul.cu",
             replaces="src/repro/kernels/redmule_matmul.py:478",
             shape="decode PV B=4x8x2 M=1 N=144 K=128 bf16, V broadcast",
             err=err_pv, bound=(pv_b, pv_f),
             kernel=lambda: ops.redmule_matmul_batched(p, v, policy=pol),
             plain=lambda: rm.redmule_matmul_plain(p, v, policy=pol),
             library=lambda: torch.matmul(p, v)),
        dict(name="flash_attention", group="flash_fwd",
             counter=(fa.flash_attention, "launches"),
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:102",
             shape="prefill Hq=16 Hkv=8 D=128 S=128 T=144 t_valid=128 bf16",
             err=err_fl, bound=(fl_b, fl_f),
             kernel=lambda: fa.flash_attention(q, k, vv, **fl),
             plain=lambda: fa.flash_attention_plain(q, k, vv, **fl),
             library=lambda: F.scaled_dot_product_attention(
                 q4, k4, v4, is_causal=True, enable_gqa=True)),
        dict(name="chunked_linear_attention", group="chunked_linear_attention",
             counter=(cla.chunked_linear_attention, "launches"),
             source="src/repro_torch/csrc/chunked_linear_attention.cu",
             replaces="src/repro/kernels/chunked_linear_attention.py:79",
             shape="train BH=16 S=256 dk=dv=1024 chunk=64 bf16", err=err_cla,
             bound=(cla_b, cla_f), bound_tc=cla_tc,
             kernel=lambda: cla.chunked_linear_attention(*cla_in, chunk=64),
             plain=lambda: cla.chunked_linear_attention_plain(*cla_in, chunk=64),
             library=None),            # no single PyTorch call computes it
        dict(name="redmule_matmul (fp32 route)", group="redmule_gemm_f32",
             counter=(ops.redmule_matmul, "launches_fp32"),
             source="src/repro_torch/csrc/redmule_matmul.cu",
             replaces="src/repro/kernels/redmule_matmul.py:289",
             shape="nn mLSTM gates M=1024 N=4096 K=8 fp32", err=err_g32,
             bound=(g32_b, g32_f),
             kernel=lambda: ops.redmule_matmul(x_gate, w_gate, policy=f32),
             plain=lambda: rm.redmule_matmul_plain(x_gate, w_gate, policy=f32),
             library=lambda: torch.matmul(x_gate, w_gate)),
        dict(name="redmule_matmul_batched (fp32 route)", group="redmule_gemm_f32",
             counter=(ops.redmule_matmul_batched, "launches_fp32"),
             source="src/repro_torch/csrc/redmule_matmul.cu",
             replaces="src/repro/kernels/redmule_matmul.py:478",
             shape="nn sweep inter read B=16 M=64 N=1024 K=1024 fp32",
             err=err_b32, bound=(b32_b, b32_f),
             kernel=lambda: ops.redmule_matmul_batched(qe, st, policy=f32),
             plain=lambda: rm.redmule_matmul_plain(qe, st, policy=f32),
             library=lambda: torch.matmul(qe, st)),
    ]
    runs += kernel1_mode_checks(log, g)
    runs += fp8_kernel_checks(log, g)
    runs += split_checks(log, g)
    runs += lmtrain_kernel_checks(log, g)
    runs += moe_kernel_checks(log, g)
    runs += recurrent_kernel_checks(log, g)
    kernels = _time_rows(runs)
    counters = {r["name"]: r["counter"] for r in runs}
    counters.update(_split_counters(ops))
    return kernels, counters, \
        {r["name"]: r["paths"] for r in runs if "paths" in r}


def _time_rows(runs) -> list:
    """Each row's kernel, plain version and library call timed (see
    ``kernel_phase``); returns the ``{"kernels": [...]}`` entries."""
    import torch

    kernels = []
    for r in runs:
        # ms: CUDA events around back-to-back calls (host launch cost
        # included where it exceeds the kernel); device_ms: the kernel
        # alone, from the profiler; splits: the slices S of the call
        _, splits = _with_splits(r["kernel"])
        prof = _device_profile(r["kernel"], 5)["by_kernel"]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "shape": r["shape"],
            "max_abs_err": r["err"], "ms": _time_ms(r["kernel"]),
            "plain_ms": _time_ms(r["plain"]), "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": None if r["library"] is None else _time_ms(r["library"]),
            "device_ms": prof[r["group"]]["ms"], "splits": splits})
        if r["library"] is not None:   # the library call's kernels alone
            kernels[-1]["library_device_ms"] = _device_profile(r["library"], 5)["device_ms"]
        if "bound_tc" in r:   # the tensor-core bound of the split products
            kernels[-1]["bound_tc_ms"], kernels[-1]["bound_tc_by"] = r["bound_tc"]
        print(f"[time] {r['name']} ({r['shape']}): {kernels[-1]['ms']:.4f} ms, "
              f"device {kernels[-1]['device_ms']:.4f} ms, plain "
              f"{kernels[-1]['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}), library {kernels[-1]['library_ms']} "
              f"(device {kernels[-1].get('library_device_ms')}), "
              f"S={splits}", flush=True)
    return kernels


def lmtrain_kernel_checks(log, g):
    """Kernels 1-3 at the LM training path's shapes (qwen3-1.7b at full
    width, batch 4 x seq 256, tpu_bf16), each against its plain version
    and run twice, bitwise equal: the tied head's backward — dX = dZ·E
    ("nn", reading the (V, d) embedding as stored) and dE = dZᵀ·h ("tn") —
    with the "+grad" policy's fp32 output; the attention composition of
    the backward (kernel 2): scores (fp32 out, K read through a transposed
    view), PV, and the four backward launches ("nt" dX, "tn" dW); flash
    (kernel 3) at the training shape in bf16 and fp16 (``--fp16-scale``),
    and musicgen-medium's MHA at D 64.  Returns the rows to time.

    Tolerances: fp32 outputs summation order, 1e-4 of max — except the
    head's dX, whose 151936-deep reduction runs unsplit through 4748
    sequential 32-deep tensor-core accumulations, each of which may lose
    up to one fp32 ulp (the tensor cores' fp32 adder is not
    round-to-nearest; 4748 x 2^-23 = 5.7e-4 in all): 2^-10;
    bf16 outputs two ulps (2^-7), fp16 two ulps (2^-9)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import precision as prec
    from repro_torch.core.engine import _grad_policy, scores_policy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    bf = prec.TPU_BF16
    gbf, scores = _grad_policy(bf), scores_policy(bf)
    tol_bf16, tol_f32 = 2.0 ** -7, 1e-4
    d, V, hq, hkv, hd = 2048, 151936, 16, 8, 128
    rows_t = L_BATCH * L_SEQ

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def both(name, fn, plain, tol):
        got = fn()
        _repeat(name, got, fn(), log)
        return _check(name, got, plain(), tol, log)

    src = "src/repro_torch/csrc/redmule_matmul.cu"
    rep1 = "src/repro/kernels/redmule_matmul.py:289"
    rep2 = "src/repro/kernels/redmule_matmul.py:478"
    k1 = (ops.redmule_matmul, "launches")
    k2 = (ops.redmule_matmul_batched, "launches")
    out = []

    # kernel 1: the tied head's backward at 1024 rows
    dz, emb, h = rnd(rows_t, V, scale=1e-3), rnd(V, d, scale=0.02), rnd(rows_t, d)
    for name, x, w, layout, (M, N, K), tol, lib in (
            ("redmule_matmul (tied head dX)", dz, emb, "nn", (rows_t, V, d),
             2.0 ** -10, lambda: torch.matmul(dz, emb)),
            ("redmule_matmul (tied head dW)", dz, h, "tn", (V, rows_t, d),
             tol_f32, lambda: torch.matmul(dz.t(), h))):
        kern = (lambda x=x, w=w, layout=layout:
                ops.redmule_matmul(x, w, policy=gbf, layout=layout))
        plain = (lambda x=x, w=w, layout=layout:
                 rm.redmule_matmul_plain(x, w, policy=gbf, layout=layout))
        shape = f"{layout} M={M} N={N} K={K} bf16 -> fp32"
        err = both(f"gemm {name} {shape}", kern, plain, tol)
        out.append(dict(
            name=name, group="redmule_gemm", counter=k1, paths=("lmtrain",),
            source=src, replaces=rep1, shape=shape, err=err,
            bound=_bound_ms((M * N + N * K) * 2 + M * K * 4, 2 * M * N * K),
            kernel=kern, plain=plain, library=lib))

    # kernel 2: the composition, B·Hkv = 32 batches of (G·S = 512) query
    # rows against T = 256 keys; K^T is a transposed view of k (in place)
    BH, GS, T = L_BATCH * hkv, (hq // hkv) * L_SEQ, L_SEQ
    q, k, v = rnd(BH, GS, hd), rnd(BH, T, hd), rnd(BH, T, hd)
    kt = k.transpose(-1, -2)
    ds = rnd(BH, GS, T, scale=1e-2)
    p = torch.softmax(torch.randn(BH, GS, T, generator=g, device=dev), -1).to(
        torch.bfloat16)
    do = rnd(BH, GS, hd)
    comp = {
        "scores": (q, kt, "nn", scores, (GS, hd, T)),
        "scores dX": (ds, kt, "nt", gbf, (GS, T, hd)),
        "scores dW": (q, ds, "tn", gbf, (hd, GS, T)),
        "PV": (p, v, "nn", bf, (GS, T, hd)),
        "PV dX": (do, v, "nt", gbf, (GS, hd, T)),
        "PV dW": (p, do, "tn", gbf, (T, GS, hd)),
    }
    libs = {"scores": lambda: torch.matmul(q, kt),
            "scores dX": lambda: torch.matmul(ds, k),
            "scores dW": lambda: torch.matmul(q.transpose(-1, -2), ds)}
    for name, (x, w, layout, pol, (M, N, K)) in comp.items():
        kern = (lambda x=x, w=w, layout=layout, pol=pol:
                ops.redmule_matmul_batched(x, w, policy=pol, layout=layout))
        plain = (lambda x=x, w=w, layout=layout, pol=pol:
                 rm.redmule_matmul_plain(x, w, policy=pol, layout=layout))
        shape = (f"{layout} B={BH} M={M} N={N} K={K} bf16 -> "
                 f"{prec.dtype_name(pol.out_dtype)}")
        err = both(f"batched composition {name} {shape}", kern, plain,
                   tol_f32 if pol.out_dtype == torch.float32 else tol_bf16)
        if name in libs:
            ob = pol.out_dtype.itemsize
            out.append(dict(
                name=f"redmule_matmul_batched (composition {name})",
                group="redmule_gemm", counter=k2, paths=("lmtrain",), source=src,
                replaces=rep2, shape=shape, err=err,
                bound=_bound_ms(BH * ((M * N + N * K) * 2 + M * K * ob),
                                2 * BH * M * N * K),
                kernel=kern, plain=plain, library=libs[name]))

    # kernel 3 at the training shape (bf16; fp16 under --fp16-scale) and
    # musicgen-medium's MHA at D 64
    B, S = L_BATCH, L_SEQ
    for dt, tol in ((torch.bfloat16, tol_bf16), (torch.float16, 2.0 ** -9)):
        qf, kf, vf = (rnd(B * h_, S, hd, dtype=dt) for h_ in (hq, hkv, hkv))
        kern = lambda qf=qf, kf=kf, vf=vf: fa.flash_attention(
            qf, kf, vf, group=hq // hkv, causal=True)
        plain = lambda qf=qf, kf=kf, vf=vf: fa.flash_attention_plain(
            qf, kf, vf, group=hq // hkv, causal=True)
        shape = (f"train B={B} Hq={hq} Hkv={hkv} D={hd} S=T={S} causal "
                 f"{prec.dtype_name(dt)}")
        err = both(f"flash {shape}", kern, plain, tol)
        if dt == torch.bfloat16:
            pairs = S * (S + 1) // 2
            q4, k4, v4 = (t.reshape(B, -1, S, hd) for t in (qf, kf, vf))
            out.append(dict(
                name="flash_attention (training shape)", group="flash_fwd",
                counter=(fa.flash_attention, "launches"), paths=("lmtrain",),
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:102", shape=shape,
                err=err, bound=_bound_ms((2 * B * hq + 2 * B * hkv) * S * hd * 2,
                                         4 * B * hq * pairs * hd),
                kernel=kern, plain=plain,
                library=lambda q4=q4, k4=k4, v4=v4: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, enable_gqa=True)))
    qm, km, vm = (rnd(2 * 24, 128, 64) for _ in range(3))
    both("flash musicgen MHA Hq=Hkv=24 D=64 S=T=128 causal bf16",
         lambda: fa.flash_attention(qm, km, vm, group=1, causal=True),
         lambda: fa.flash_attention_plain(qm, km, vm, group=1, causal=True),
         tol_bf16)
    # kernel 3's fp32 route (the fp32 policy's attention, as the two-layer
    # cut runs it): the training shape, and D 64 with a ragged S, t_valid <
    # T, q_offset > 0 and rows with no visible column (exact zeros)
    q3, k3, v3 = (rnd(B * h_, S, hd, dtype=torch.float32) for h_ in (hq, hkv, hkv))
    f32 = lambda: fa.flash_attention(q3, k3, v3, group=hq // hkv, causal=True)
    both(f"flash fp32 train B={B} Hq={hq} Hkv={hkv} D={hd} S=T={S} causal", f32,
         lambda: fa.flash_attention_plain(q3, k3, v3, group=hq // hkv, causal=True),
         tol_f32)
    pairs = S * (S + 1) // 2
    bound = _bound_ms((2 * B * hq + 2 * B * hkv) * S * hd * 4,
                      4 * B * hq * pairs * hd, FP32_FLOPS)
    q4, k4, v4 = (t.reshape(B, -1, S, hd) for t in (q3, k3, v3))
    times = {
        "ms": _time_ms(f32),
        "device_ms": _device_profile(f32, iters=20)["by_kernel"]["flash_fwd"]["ms"],
        "plain_ms": _time_ms(lambda: fa.flash_attention_plain(
            q3, k3, v3, group=hq // hkv, causal=True)),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True))}
    log.append({"check": "flash fp32 route, training shape: time", **times,
                "bound_ms": bound[0], "bound_by": bound[1], "ok": True})
    print(f"[time] flash_attention fp32 route (train B={B} Hq={hq} Hkv={hkv} "
          f"D={hd} S=T={S} causal): {times['ms']:.4f} ms, device "
          f"{times['device_ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}, fp32 peak), library (SDPA, fp32) "
          f"{times['library_ms']:.4f} ms", flush=True)
    q6, k6, v6 = (rnd(2 * h_, n, 64, dtype=torch.float32)
                  for h_, n in ((4, 200), (2, 240), (2, 240)))
    for kw in (dict(t_valid=210, q_offset=40), dict(t_valid=240, q_offset=-20)):
        both(f"flash fp32 GQA 4/2 D=64 S=200 T=240 {kw} causal",
             lambda kw=kw: fa.flash_attention(q6, k6, v6, group=2, **kw),
             lambda kw=kw: fa.flash_attention_plain(q6, k6, v6, group=2, **kw),
             tol_f32)
    got = fa.flash_attention(q6, k6, v6, group=2, q_offset=-20)
    zero = bool((got[:, :20] == 0).all())
    log.append({"check": "flash fp32: rows with no visible column are exact "
                         "zeros", "ok": zero})
    print(f"[check] flash fp32 rows with no visible column: "
          f"{'exact zeros' if zero else 'FAIL: not zero'}", flush=True)
    if not zero:
        raise AssertionError("flash fp32: a row with no visible column is not 0")
    torch.cuda.synchronize()
    return out


def recurrent_kernel_checks(log, g):
    """The recurrent slice's kernel shapes, each launch against its plain
    version: kernel 4 with hymba's mixed operand dtypes (fp32 q / k, bf16 v,
    fp32 out, dk = 16, dv = 64) at its prefill (BH 4 x 25, S 1152) and
    training (BH 100, S 256) shapes, an fp16 v, and at xlstm-1.3b's prefill
    (BH 16, S 128, dk = dv = 1024, bf16), every launch twice and bitwise
    equal; kernel 1 at hymba's two unaligned widths, the untied head (N =
    32001, bf16, decode M = 4 and the training shape's forward, dX "nt"
    and dW "tn") and the fp32 route's ``w_bcdt`` (N = 2·16 + 25 = 57,
    prefill M = 4 x 1152, and its dX / dW); kernel 2's fp32 route at the
    M = 1 decode readouts ``bhk,bhkv->bhv`` (xlstm 16 x (1 x 1024 x 1024),
    hymba 100 x (1 x 16 x 64)).  Returns the rows to time.

    Tolerances: kernel 4's output and state on fp32 q / k are fp32 on three
    TF32 pieces (``K4_FP32_TOL`` of max, as the fp32 sweep above), its
    state on bf16 inputs 1e-4; bf16 outputs two ulps (2^-7); the fp32
    route summation order (1e-5)."""
    import torch

    from repro_torch import configs
    from repro_torch.core import precision as prec
    from repro_torch.core.engine import _grad_policy
    from repro_torch.kernels import chunked_linear_attention as cla
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    bf, f32 = prec.TPU_BF16, prec.FP32
    out = []

    def sweep_inputs(BH, S, dk, dv, qk_dtype, v_dtype):
        q = (torch.randn(BH, S, dk, generator=g, device=dev) * dk ** -0.5).to(qk_dtype)
        k = (torch.randn(BH, S, dk, generator=g, device=dev) * 0.5).to(qk_dtype)
        v = torch.randn(BH, S, dv, generator=g, device=dev).to(v_dtype)
        lg = -torch.rand(BH, S, generator=g, device=dev) * 0.7
        return q, k, v, lg

    def sweep_bound(ins, chunk):
        # q, k, v, g read once, out and the fp32 state written once; the
        # causal score / PV pairs plus the inter-chunk read and the state
        # update, fp32 FMAs.  bound_tc: the products as the kernel runs them
        # on TF32 tensor cores, an MMA per piece product: fp32 q / k in three
        # pieces, the fp32 state, A and kdec in three beside fp32 inputs (two
        # beside 16-bit ones), a 16-bit operand in one; i + j < max pieces
        q, k, v, _ = ins
        BH, S, dk = q.shape
        dv = v.shape[-1]
        n_ch, pairs = S // chunk, chunk * (chunk + 1) // 2
        nbytes = (q.numel() * q.element_size() + k.numel() * k.element_size()
                  + v.numel() * v.element_size() + BH * S * 4
                  + BH * S * dv * q.element_size() + BH * dk * dv * 4)
        n_in = 3 if q.dtype == torch.float32 else 1
        n_f32 = 3 if q.dtype == torch.float32 else 2
        n_v = 3 if v.dtype == torch.float32 else 1
        mmas = lambda a, b: sum(1 for i in range(a) for j in range(b)
                                if i + j < max(a, b))
        flops = BH * n_ch * (2 * pairs * (dk + dv) + 4 * chunk * dk * dv)
        tc = BH * n_ch * (mmas(n_in, n_in) * 2 * pairs * dk        # q k^T
                          + mmas(n_f32, n_in) * 2 * chunk * dk * dv  # q S
                          + mmas(n_v, n_f32) * 2 * pairs * dv        # A v
                          + mmas(n_v, n_f32) * 2 * chunk * dk * dv)  # kdec^T v
        return _bound_ms(nbytes, flops, FP32_FLOPS), _bound_ms(nbytes, tc, TF32_FLOPS)

    hc = configs.get(H_ARCH)
    Hh, N, P = hc.n_heads, hc.ssm.state_dim, hc.d_model // hc.n_heads
    for tag, BH, S, dk, dv, qk_dt, v_dt, chunk, paths in (
            ("hymba prefill", H_BATCH * Hh, H_PROMPT, N, P, torch.float32,
             torch.bfloat16, 64, ("hymbaserve",)),
            ("hymba train", HT_BATCH * Hh, HT_SEQ, N, P, torch.float32,
             torch.bfloat16, 64, ("hymbatrain",)),
            ("fp16 v", 6, 128, N, P, torch.float32, torch.float16, 64, None),
            ("xlstm prefill", X_BATCH * 4, X_PROMPT, 1024, 1024, torch.bfloat16,
             torch.bfloat16, 64, ("ssmserve",))):
        ins = sweep_inputs(BH, S, dk, dv, qk_dt, v_dt)
        shape = (f"BH={BH} S={S} dk={dk} dv={dv} chunk={chunk} "
                 f"{str(qk_dt)[6:]} q/k, {str(v_dt)[6:]} v")
        o, st = cla.chunked_linear_attention(*ins, chunk=chunk)
        want_o, want_s = cla.chunked_linear_attention_plain(*ins, chunk=chunk)
        if o.dtype != qk_dt:
            raise AssertionError(f"sweep {tag}: out is {o.dtype}, not q's {qk_dt}")
        tol_o = K4_FP32_TOL if qk_dt == torch.float32 else 2.0 ** -7
        tol_s = K4_FP32_TOL if qk_dt == torch.float32 else 1e-4
        err = _check(f"sweep {tag} {shape} out", o, want_o, tol_o, log)
        _check(f"sweep {tag} {shape} state", st, want_s, tol_s, log)
        o2, st2 = cla.chunked_linear_attention(*ins, chunk=chunk)
        _repeat(f"sweep {tag} out", o, o2, log)
        _repeat(f"sweep {tag} state", st, st2, log)
        if paths is None:
            continue
        bound, bound_tc = sweep_bound(ins, chunk)
        out.append(dict(
            name=f"chunked_linear_attention ({tag})", group="chunked_linear_attention",
            counter=(cla.chunked_linear_attention, "launches"), paths=paths,
            source="src/repro_torch/csrc/chunked_linear_attention.cu",
            replaces="src/repro/kernels/chunked_linear_attention.py:79",
            shape=shape, err=err, bound=bound, bound_tc=bound_tc,
            kernel=lambda ins=ins, c=chunk: cla.chunked_linear_attention(*ins, chunk=c),
            plain=lambda ins=ins, c=chunk: cla.chunked_linear_attention_plain(*ins, chunk=c),
            library=None))                # no single PyTorch call computes it

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def gemm_check(name, x, w, layout, pol, tol):
        got = ops.redmule_matmul(x, w, policy=pol, layout=layout)
        _repeat(name, got, ops.redmule_matmul(x, w, policy=pol, layout=layout), log)
        return _check(name, got, rm.redmule_matmul_plain(x, w, policy=pol, layout=layout),
                      tol, log)

    # kernel 1: hymba's untied head, N = 32001 (odd: the scalar copy path)
    d, V = hc.d_model, hc.vocab_size
    head = rnd(d, V, scale=d ** -0.5)
    x_dec = rnd(H_BATCH, d)
    err_head = gemm_check(f"gemm nn hymba head M={H_BATCH} N={d} K={V} bf16",
                          x_dec, head, "nn", bf, 2.0 ** -7)
    Mt = HT_BATCH * HT_SEQ
    gbf = _grad_policy(bf)
    gemm_check(f"gemm nn hymba head train M={Mt} N={d} K={V} bf16", rnd(Mt, d),
               head, "nn", bf, 2.0 ** -7)
    dz = rnd(Mt, V, scale=1e-2)
    gemm_check(f"gemm nt hymba head dX M={Mt} N={V} K={d} bf16 -> fp32", dz, head,
               "nt", gbf, 1e-4)
    gemm_check(f"gemm tn hymba head dW M={d} N={Mt} K={V} bf16 -> fp32", rnd(Mt, d),
               dz, "tn", gbf, 1e-4)
    # the fp32 route: w_bcdt, N = 2 N + H = 57
    nb = 2 * N + Hh
    x_b, w_b = rnd(H_BATCH * H_PROMPT, d, dtype=torch.float32), \
        rnd(d, nb, scale=d ** -0.5, dtype=torch.float32)
    err_bcdt = gemm_check(f"gemm fp32 nn hymba w_bcdt M={H_BATCH * H_PROMPT} N={d} "
                          f"K={nb}", x_b, w_b, "nn", f32, 1e-5)
    dzb = rnd(Mt, nb, dtype=torch.float32)
    gemm_check(f"gemm fp32 nt w_bcdt dX M={Mt} N={nb} K={d}", dzb, w_b, "nt", f32, 1e-5)
    gemm_check(f"gemm fp32 tn w_bcdt dW M={d} N={Mt} K={nb}", x_b[:Mt], dzb, "tn",
               f32, 1e-5)
    out.append(dict(
        name="redmule_matmul (hymba head, N=32001)", group="redmule_gemm",
        counter=(ops.redmule_matmul, "launches"), paths=("hymbaserve",),
        source="src/repro_torch/csrc/redmule_matmul.cu",
        replaces="src/repro/kernels/redmule_matmul.py:289",
        shape=f"nn M={H_BATCH} N={d} K={V} bf16 (N odd)", err=err_head,
        bound=_bound_ms((H_BATCH * d + d * V + H_BATCH * V) * 2, 2 * H_BATCH * d * V),
        kernel=lambda: ops.redmule_matmul(x_dec, head, policy=bf),
        plain=lambda: rm.redmule_matmul_plain(x_dec, head, policy=bf),
        library=lambda: torch.matmul(x_dec, head)))
    out.append(dict(
        name="redmule_matmul (fp32 route, hymba w_bcdt N=57)", group="redmule_gemm_f32",
        counter=(ops.redmule_matmul, "launches_fp32"), paths=("hymbaserve",),
        source="src/repro_torch/csrc/redmule_matmul.cu",
        replaces="src/repro/kernels/redmule_matmul.py:289",
        shape=f"nn M={H_BATCH * H_PROMPT} N={d} K={nb} fp32", err=err_bcdt,
        bound=_bound_ms((x_b.numel() + w_b.numel() + H_BATCH * H_PROMPT * nb) * 4,
                        2 * H_BATCH * H_PROMPT * d * nb, FP32_FLOPS),
        kernel=lambda: ops.redmule_matmul(x_b, w_b, policy=f32),
        plain=lambda: rm.redmule_matmul_plain(x_b, w_b, policy=f32),
        library=lambda: torch.matmul(x_b, w_b)))

    # kernel 2, fp32 route: the M = 1 decode readouts q @ S, as einsum2d
    # lays out "bhk,bhkv->bhv" (batch B·H, one row)
    for tag, bh, dk, dv, path in (("xlstm", X_BATCH * 4, 1024, 1024, "ssmserve"),
                                  ("hymba", H_BATCH * Hh, N, P, "hymbaserve")):
        qr = rnd(bh, 1, dk, dtype=torch.float32)
        sr = rnd(bh, dk, dv, scale=dk ** -0.5, dtype=torch.float32)
        name = f"batched fp32 decode readout {tag} B={bh} M=1 N={dk} K={dv}"
        got = ops.redmule_matmul_batched(qr, sr, policy=f32)
        _repeat(name, got, ops.redmule_matmul_batched(qr, sr, policy=f32), log)
        err = _check(name, got, rm.redmule_matmul_plain(qr, sr, policy=f32), 1e-5, log)
        out.append(dict(
            name=f"redmule_matmul_batched (fp32 route, {tag} decode readout)",
            group="redmule_gemm_f32",
            counter=(ops.redmule_matmul_batched, "launches_fp32"), paths=(path,),
            source="src/repro_torch/csrc/redmule_matmul.cu",
            replaces="src/repro/kernels/redmule_matmul.py:478",
            shape=f"bhk,bhkv->bhv nn B={bh} M=1 N={dk} K={dv} fp32", err=err,
            bound=_bound_ms((bh * dk + bh * dk * dv + bh * dv) * 4, 2 * bh * dk * dv,
                            FP32_FLOPS),
            kernel=lambda qr=qr, sr=sr: ops.redmule_matmul_batched(qr, sr, policy=f32),
            plain=lambda qr=qr, sr=sr: rm.redmule_matmul_plain(qr, sr, policy=f32),
            library=lambda qr=qr, sr=sr: torch.matmul(qr, sr)))
    torch.cuda.synchronize()
    return out


def _split_counters(ops):
    """The GEMM wrappers' counts of launches that split their reduction,
    reported per path beside the kernels' rows."""
    return {"split launches: redmule_matmul": (ops.redmule_matmul, "launches_split"),
            "split launches: redmule_matmul_batched":
                (ops.redmule_matmul_batched, "launches_split")}


def _zero(counters) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def _read(counters) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def _require(launches: dict, names, path: str) -> None:
    missing = [n for n in names if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")


def serve_phase(log, counters):
    """The serving path through its entry point, with launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    _zero(counters)
    t0 = time.perf_counter()
    seqs = serve.main(["--arch", ARCH, "--full", "--batch", str(BATCH),
                       "--prompt-len", str(PROMPT), "--gen", str(GEN),
                       "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _read(counters)
    print(f"[serve] launches on the main path: {launches}", flush=True)
    cfg = configs.get(ARCH)
    if seqs.shape != (BATCH, PROMPT + GEN):
        raise AssertionError(f"generate returned shape {seqs.shape}")
    if not ((seqs >= 0) & (seqs < cfg.vocab_size)).all():
        raise AssertionError("generated tokens out of range")
    _require(launches, ("redmule_matmul", "redmule_matmul_batched",
                        "flash_attention"), "serve")

    # one prefill and one decode step at the same shapes, CUDA-event timed
    params = transformer.init_params(cfg, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen,
                           device="cuda")
    logits, _ = transformer.prefill(params, cfg, {"inputs": prompt}, PROMPT + GEN)
    prefill_ms = _time_ms(lambda: transformer.prefill(
        params, cfg, {"inputs": prompt}, PROMPT + GEN), iters=10, warmup=2)
    cache = transformer.init_cache(cfg, BATCH, PROMPT + GEN, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen, device="cuda")
    pos = torch.full((BATCH,), PROMPT, device="cuda")
    sizes = np.full((BATCH,), PROMPT + 1, np.int32)

    def decode():
        return transformer.serve_step(params, cfg, toks, cache, pos,
                                      kv_group_sizes=sizes)

    dec_logits, _ = decode()
    decode_ms = _time_ms(decode, iters=10, warmup=2)
    for name, t in (("prefill", logits), ("decode", dec_logits)):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"{name} logits are not finite")
    print(f"[serve] generate {BATCH}x({PROMPT}+{GEN}) {serve_s:.3f}s wall; "
          f"prefill(1x{PROMPT}) {prefill_ms:.3f} ms; decode step (B={BATCH}) "
          f"{decode_ms:.3f} ms", flush=True)
    profiles = {
        "prefill": _device_profile(lambda: transformer.prefill(
            params, cfg, {"inputs": prompt}, PROMPT + GEN), iters=1),
        "decode_step": _device_profile(decode, iters=2)}
    for name, prof in profiles.items():
        parts = ", ".join(f"{k} {g['ms']:.3f} ms x{g['count']}"
                          for k, g in sorted(prof["by_kernel"].items()))
        print(f"[profile] {name}: wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['device_ms']:.3f} ms (idle {prof['idle_share']:.3f}): "
              f"{parts}", flush=True)
    del params

    # small input: a two-layer cut at full width, card vs the CPU plain path
    small = dataclasses.replace(cfg, n_layers=2)
    pc = transformer.init_params(small, seed=SEED + 1, device="cuda")
    pcpu = _to_cpu(pc)
    sp = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen, device="cuda")
    got, _ = transformer.prefill(pc, small, {"inputs": sp}, 24)
    want, _ = transformer.prefill(pcpu, small, {"inputs": sp.cpu()}, 24)
    # two bf16 layers: per-GEMM one-ulp rounding flips (2^-8) compound over
    # ~10 rounded stages; a broken kernel is off by O(1)
    _check("two-layer prefill logits, card vs CPU plain", got.cpu(), want,
           2.0 ** -4, log)
    return {"serve_wall_s": serve_s, "prefill_ms": prefill_ms,
            "decode_step_ms": decode_ms, "launches": launches,
            "profiles": profiles}


def train_phase(log, counters):
    """The training path through its entry point, with launch counts; one
    profiled step; one full-width super-block against the CPU plain path."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.optim import AdamW

    full = configs.get(T_ARCH)
    cfg = dataclasses.replace(full, n_layers=T_LAYERS)
    n_mlstm = cfg.n_layers // cfg.ssm.slstm_period * (cfg.ssm.slstm_period - 1)
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.main(["--arch", T_ARCH, "--full", "--layers", str(T_LAYERS),
                      "--batch", str(T_BATCH),
                      "--seq", str(T_SEQ), "--steps", str(T_STEPS),
                      "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _read(counters)
    peak_main = torch.cuda.max_memory_allocated()
    print(f"[train] launches on the main path: {launches}", flush=True)
    hist = out["history"]
    if len(hist) != T_STEPS or not all(math.isfinite(h["loss"])
                                       and math.isfinite(h["grad_norm"])
                                       for h in hist):
        raise AssertionError(f"non-finite or missing steps: {hist}")
    # one sweep per mLSTM block per forward, and again when the remat
    # region of each super-block recomputes in the backward
    structural = T_STEPS * n_mlstm * (2 if cfg.remat == "full" else 1)
    print(f"[train] sweep launches {launches['chunked_linear_attention']}, "
          f"structural {structural} ({T_STEPS} steps x {n_mlstm} mLSTM blocks "
          f"x 2 for remat)", flush=True)
    if launches["chunked_linear_attention"] != structural:
        raise AssertionError("sweep kernel launches differ from the structural count")
    _require(launches, ("redmule_matmul", "redmule_matmul_batched",
                        "chunked_linear_attention", "redmule_matmul (fp32 route)",
                        "redmule_matmul_batched (fp32 route)"), "train")
    for h in hist:
        print(f"[train] step {h['step']}: loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f} step {h['step_ms']:.1f} ms", flush=True)

    # one profiled step after a warm-up step, with its peak memory
    opt = AdamW(lr=3e-3, warmup_steps=10)
    step = train.build_train_step(cfg, opt)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=T_SEQ,
                     global_batch=T_BATCH, seed=SEED)
    holder = [train.init_state(cfg, opt, seed=SEED, device="cuda")]
    # the warm-up step also tallies the fp32 route's dispatches by shape,
    # each timed alone before the step's profile (after a profile of ~200k
    # kernels the profiler records no device time for a while)
    fp32_shapes = _fp32_shapes(lambda: step(holder[0], ds.batch(0)))
    holder[0], _ = fp32_shapes.pop("result")
    by_shape = _fp32_by_shape(fp32_shapes["tally"])

    def one_step():
        holder[0], m = step(holder[0], ds.batch(1))
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = _device_profile(one_step, iters=1, cpu=False)
    peak_step = torch.cuda.max_memory_allocated()
    del holder, step
    torch.cuda.empty_cache()
    parts = ", ".join(f"{k} {g['ms']:.3f} ms x{g['count']}"
                      for k, g in sorted(prof["by_kernel"].items()))
    print(f"[profile] train step: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_ms']:.1f} ms (idle {prof['idle_share']:.3f}), peak "
          f"{peak_step / 2**30:.2f} GiB: {parts}", flush=True)

    super_block = super_block_parity(log, full)
    full_depth = full_depth_parity(log, full)
    step_ms = [h["step_ms"] for h in hist]
    return {"train_wall_s": train_s, "history": hist, "step_ms": step_ms,
            "super_block_parity": super_block, "full_depth_parity": full_depth,
            "launches": launches, "structural_sweeps": structural,
            "fp32_route_by_shape": by_shape,
            "peak_mem_main_gib": peak_main / 2**30,
            "peak_mem_step_gib": peak_step / 2**30, "profile": prof,
            "params": out["params"]}


def super_block_parity(log, cfg) -> dict:
    """One full-width super-block of ``cfg`` (7 mLSTM + 1 sLSTM), batch 1 x
    seq 128: loss and the gradients of w_up, w_qkv and r_gates, card vs the
    CPU plain path, under the fp32 policy (every GEMM on the fp32 route,
    the sweep on fp32 inputs) and under the training policy (bf16).

    The gradients are ill-conditioned: the sLSTM stabilizer's max(log f +
    m, i) and max(|n|, 1) switch branch under rounding noise, so two
    correct summation orders disagree far above one rounding.  The run
    measures that spread itself — the CPU plain path with one thread
    against all threads (another BLAS blocking, another summation order) —
    and holds the card to 8x it, above a floor of one rounding's worth
    (fp32 1e-5, bf16 2^-8); a broken kernel is off by O(1).

    Under fp32 the card runs the block twice: with the sweep as the
    reference composition of kernel-1 / 2 dispatches, and as the path runs
    it, the sweep on kernel 4 (fp32 operands in three TF32 pieces, L summed
    in fp64); both are held to that bound, and every kernel-4 launch of the
    path to its plain version on the same operands (out and state within
    ``SB_K4_TOL`` of max).  Beside them a control must fail the bound: the
    kernel-4 route with row 0 of the first mLSTM block's ``w_qkv`` scaled
    by 1 + 2^-10 on the card only.  Under the training policy the path as
    it runs is held to the bound."""
    import dataclasses

    import torch

    from repro_torch.kernels import chunked_linear_attention as cla
    from repro_torch.models import layers, transformer
    from repro_torch.optim import tree_map

    names = ("loss", "grad w_up", "grad w_qkv", "grad r_gates")
    n_threads = torch.get_num_threads()
    result = {}
    for policy, floor in (("fp32", 1e-5), (cfg.policy_name, 2.0 ** -8)):
        small = dataclasses.replace(cfg, n_layers=cfg.ssm.slstm_period,
                                    policy_name=policy)
        p_cpu = layers.init_tree(transformer._xlstm_super_schema(small),
                                 seed=SEED + 2, device=torch.device("cpu"),
                                 dtype=torch.float32)
        p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
        gen = torch.Generator().manual_seed(SEED + 3)
        h0 = torch.randn(1, 128, cfg.d_model, generator=gen).to(
            small.policy.compute_dtype)
        proj = torch.randn(1, 128, cfg.d_model, generator=gen)

        def block_grads(p, h, r):
            wrt = [p["mlstm"]["cell"]["w_up"], p["mlstm"]["cell"]["w_qkv"],
                   p["slstm"]["cell"]["r_gates"]]
            wrt = [t.detach().requires_grad_(True) for t in wrt]
            q = {"mlstm": {**p["mlstm"], "cell": {**p["mlstm"]["cell"],
                                                  "w_up": wrt[0], "w_qkv": wrt[1]}},
                 "slstm": {**p["slstm"], "cell": {**p["slstm"]["cell"],
                                                  "r_gates": wrt[2]}}}
            y = transformer._xlstm_super_block(q, h, small, policy=small.policy)
            loss = (y.float() * r).mean()
            return [loss.detach()] + [g.detach() for g in
                                      torch.autograd.grad(loss, wrt)]

        k4 = {"launches": 0, "out": 0.0, "state": 0.0}

        def watch(fn, kind, operands, **kw):
            out = fn(kind, operands, **kw)
            if kind == "linear_attention":
                want = cla.chunked_linear_attention_plain(*operands, **kw)
                k4["launches"] += 1
                for key, o, w in zip(("out", "state"), out, want):
                    k4[key] = max(k4[key], ((o.float() - w.float()).abs().max()
                                            / w.float().abs().max()).item())
            return out

        with _hopper_wrapped(attention=watch):
            got = block_grads(p_gpu, h0.cuda(), proj.cuda())
        composed = control = None
        if policy == "fp32":
            with _hopper_wrapped(without=("attention",)):
                composed = block_grads(p_gpu, h0.cuda(), proj.cuda())
            p_ctl = tree_map(lambda t: t.clone(), p_gpu)
            p_ctl["mlstm"]["cell"]["w_qkv"][0, 0, 0].mul_(1 + SB_CONTROL)
            control = block_grads(p_ctl, h0.cuda(), proj.cuda())
            del p_ctl
        want = block_grads(p_cpu, h0, proj)
        torch.set_num_threads(1)
        try:
            want_1t = block_grads(p_cpu, h0, proj)
        finally:
            torch.set_num_threads(n_threads)
        print(f"[train] super-block {policy}: {k4['launches']} kernel-4 launches, "
              f"vs plain on the same operands: out {k4['out']:.3e}, state "
              f"{k4['state']:.3e} of max", flush=True)
        failed, rows = [], {}
        if k4["launches"] != small.ssm.slstm_period - 1:
            failed.append(f"super-block {policy}: {k4['launches']} kernel-4 launches")
        if policy == "fp32" and not max(k4["out"], k4["state"]) <= SB_K4_TOL:
            failed.append(f"super-block fp32: a kernel-4 launch off its plain "
                          f"version beyond {SB_K4_TOL}: {k4}")
        control_worst = 0.0
        for i, name in enumerate(names):
            b_ = want[i]
            scale = max(b_.abs().max().item(), 1e-30)
            spread = (want_1t[i] - b_).abs().max().item() / scale
            tol = max(8 * spread, floor)
            rows[name] = {"spread": spread, "tol_rel": tol}
            print(f"[train] super-block {policy} {name}: CPU spread (1 vs "
                  f"{n_threads} threads) {spread:.3e} of max", flush=True)
            held = [("", got)]
            if composed is not None:
                held = [(" (sweep composed on kernels 1 / 2)", composed),
                        (" (sweep on kernel 4)", got)]
            for route, out in held:
                try:
                    err = _check(f"super-block (7 mLSTM + 1 sLSTM, 1x128, {policy}){route} "
                                 f"{name}, card vs CPU plain", out[i].cpu(), b_, tol, log)
                except AssertionError as e:
                    failed.append(str(e))
                    err = (out[i].cpu() - b_).abs().max().item()
                rows[name]["err_rel" + ("_composed" if "composed" in route else "")] = \
                    err / scale
            if control is not None:
                c_err = (control[i].cpu() - b_).abs().max().item() / scale
                rows[name]["control_err_rel"] = c_err
                control_worst = max(control_worst, c_err / tol)
                print(f"[train] super-block fp32 {name}, control (w_qkv row 0 x "
                      f"(1 + 2^-10), sweep on kernel 4): {c_err:.3e} of max, bound "
                      f"{tol:.3e} ({c_err / tol:.2f}x)", flush=True)
        if control is not None:
            ok = control_worst > 1
            log.append({"check": "super-block fp32 control fails the bound",
                        "ok": ok, "worst_over_bound": control_worst})
            print(f"[check] super-block fp32 control: {control_worst:.2f}x the bound "
                  f"at its worst item: {'fails, as it must' if ok else 'FAIL: holds'}",
                  flush=True)
            if not ok:
                failed.append("super-block fp32: the control holds the bound")
        result[policy] = {"rows": rows, "kernel4": dict(k4)}
        if failed:
            raise AssertionError("; ".join(failed))
        del p_gpu, p_cpu
    return result


def _k2_ranged():
    """A context in which every GEMM dispatch with a batched operand — the
    ones the "hopper" backend sends to kernel 2 (its batched launch), by
    their shapes: a weight of more than two dims, or a "tn" dW of batched
    rows — runs inside a ``record_function`` range named ``kernel2``, so a
    profile attributes the attention composition's device time (kernels 1
    and 2 are one CUDA kernel: their names do not tell them apart).  The
    caller checks the ranges' count against kernel 2's launches."""
    import torch

    def ranged(fn, x, w, **kw):
        if w.ndim == 2 and (x.ndim == 2 or kw["spec"].layout != "tn"):
            return fn(x, w, **kw)
        with torch.profiler.record_function("kernel2"):
            return fn(x, w, **kw)

    return _hopper_wrapped(gemm=ranged)


def lmtrain_phase(log, counters):
    """LM training through its entry point: qwen3-1.7b at full width,
    batch 4 x seq 256, 2 steps, with the launch counts held to the
    structural ones; one profiled step (busy / idle share, the GEMM /
    flash / composition / other split, peak memory); two ``--fp16-scale``
    steps; a two-layer full-width cut's loss and gradients against the CPU
    plain path under fp32 and tpu_bf16; and a two-layer full-width serve
    cut of each dense config the slice added."""
    import torch

    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.optim import AdamW

    cfg = configs.get(ARCH)
    L = cfg.n_layers
    argv = ["--arch", ARCH, "--full", "--batch", str(L_BATCH), "--seq", str(L_SEQ),
            "--seed", str(SEED), "--device", "cuda"]
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.main(argv + ["--steps", str(L_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    peak_main = torch.cuda.max_memory_allocated()
    print(f"[lmtrain] launches on the main path: {launches}", flush=True)
    hist = out["history"]
    if len(hist) != L_STEPS or not all(math.isfinite(h["loss"])
                                       and math.isfinite(h["grad_norm"])
                                       for h in hist):
        raise AssertionError(f"lmtrain: non-finite or missing steps: {hist}")
    # a step: 4 projections a layer and the tied head forward, the layers'
    # projections again in the remat recompute, dX and dW of each forward
    # GEMM (kernel 1); the composition's scores and PV and their four
    # backward launches a layer (kernel 2); flash a layer forward and again
    # in the recompute (kernel 3)
    want = {"redmule_matmul": L_STEPS * ((4 * L + 1) + 4 * L + 2 * (4 * L + 1)),
            "redmule_matmul_batched": L_STEPS * 6 * L,
            "flash_attention": L_STEPS * 2 * L}
    got = {k: launches[k] for k in want}
    print(f"[lmtrain] launches {got}, structural {want} ({L_STEPS} steps x "
          f"({16 * L + 3}, {6 * L}, {2 * L}))", flush=True)
    if got != want:
        raise AssertionError("lmtrain: launches differ from the structural count")
    for h in hist:
        print(f"[lmtrain] step {h['step']}: loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f} step {h['step_ms']:.1f} ms", flush=True)

    # one profiled step after a warm-up step, with its peak memory
    opt = AdamW(lr=3e-3, warmup_steps=10)
    step = train.build_train_step(cfg, opt)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=L_SEQ,
                     global_batch=L_BATCH, seed=SEED)
    holder = [train.init_state(cfg, opt, seed=SEED, device="cuda")]
    holder[0], _ = step(holder[0], ds.batch(0))

    def one_step():
        holder[0], m = step(holder[0], ds.batch(1))
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _k2_ranged():
        prof = _device_profile(one_step, iters=1, ranges=("kernel2",))
    peak_step = torch.cuda.max_memory_allocated()
    del holder, step
    torch.cuda.empty_cache()
    if prof["ranges"]["kernel2"]["count"] != 6 * L:
        raise AssertionError(f"lmtrain profile: {prof['ranges']['kernel2']} "
                             f"kernel-2 ranges, not {6 * L}")
    k2_ms = prof["ranges"]["kernel2"]["ms"]
    split = {"gemm (kernel 1)": prof["by_kernel"]["redmule_gemm"]["ms"] - k2_ms,
             "composition (kernel 2)": k2_ms,
             "flash (kernel 3)": prof["by_kernel"].get("flash_fwd", {"ms": 0.0})["ms"],
             "other": sum(g["ms"] for k, g in prof["by_kernel"].items()
                          if k not in ("redmule_gemm", "flash_fwd"))}
    prof["split"] = split
    print(f"[profile] lmtrain step: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_ms']:.1f} ms (idle {prof['idle_share']:.3f}), peak "
          f"{peak_step / 2**30:.2f} GiB: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f"; kernels {', '.join(f'{k} x{g['count']}' for k, g in sorted(prof['by_kernel'].items()))}",
          flush=True)

    # two loss-scaled fp16 steps: finite, or a counted skip
    t0 = time.perf_counter()
    out16 = train.main(argv + ["--steps", "2", "--fp16-scale"])
    fp16_s = time.perf_counter() - t0
    for h in out16["history"]:
        print(f"[lmtrain] fp16-scale step {h['step']}: loss {h['loss']:.4f} "
              f"grad_norm {h['grad_norm']:.4f} loss_scale {h['loss_scale']:g} "
              f"finite {h['finite']} step {h['step_ms']:.1f} ms", flush=True)
        if not math.isfinite(h["loss"]) or not (
                h["finite"] or h["loss_scale"] < 2.0 ** 15):
            raise AssertionError(f"lmtrain fp16-scale: {h}")
    torch.cuda.empty_cache()

    cut = two_layer_train_parity(log, cfg)
    serve_cuts = dense_serve_cuts(log)
    return {"train_wall_s": wall, "history": hist, "launches": launches,
            "structural": want, "peak_mem_main_gib": peak_main / 2**30,
            "peak_mem_step_gib": peak_step / 2**30, "profile": prof,
            "fp16_scale": {"history": out16["history"], "wall_s": fp16_s},
            "two_layer_parity": cut, "dense_serve_cuts": serve_cuts,
            "params": out["params"]}


# the ft phase: launch/train.py's compressed data-parallel path, qwen3-1.7b
# at full width with its depth cut to 2 (every step's state goes to disk:
# 8.24 GB a checkpoint), FT_DP ranks on the card over gloo, the FP8 E4M3
# wire, FT_STEPS steps of FT_BATCH x FT_SEQ, a checkpoint every FT_SAVE
# steps, a death injected at step FT_FAIL
FT_LAYERS, FT_BATCH, FT_SEQ, FT_STEPS, FT_SAVE, FT_FAIL, FT_DP = 2, 4, 256, 4, 2, 3, 2
# its wire bytes a step (10 leaves, one fp32 scale each) and the fp32 wire's
FT_WIRE_FP8, FT_WIRE_FP32 = 411_839_016, 1_647_355_904
# a launch of the phase (its ranks) gets this long
FT_TIMEOUT_S = 600
# the uninterrupted run goes beside the death when the card has this much
# free: four ranks of ~13 GiB each, the elastic worker's contexts, margin
FT_SIDE_BY_SIDE_FREE = 70 * 2**30


def _ft_launch(module: str, n: int, args, run_dir: str, what: str):
    """The ``--dp-procs`` / ``--dp`` launcher of ``module``, in this process
    (``runtime.procs.spawn``, as ``module``'s own ``main`` runs it): ``n``
    ranks of ``python -m module args``, rank 0's output into a file of
    ``run_dir``; returns ``(returncode, rank 0's output, seconds)``."""
    from repro_torch.runtime import procs

    log_path = Path(run_dir) / f"{what.replace(' ', '_')}.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        rc = procs.spawn(n, ["-m", module, *args], run_dir=run_dir, stdout=f,
                         timeout=FT_TIMEOUT_S)
    dt = time.perf_counter() - t0
    out = log_path.read_text()
    print(f"[ft] {what}: exit {rc} after {dt:.1f} s", flush=True)
    return rc, out, dt


def _bitwise_trees(a, b) -> list:
    """The leaves (by index) where two trees differ in any bit."""
    import torch

    from repro_torch.checkpoint import tree_flatten

    bits = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    return [i for i, (x, y) in enumerate(zip(tree_flatten(a), tree_flatten(b), strict=True))
            if not (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(bits(x), bits(y))
                    if isinstance(x, torch.Tensor) else x == y)]


def ft_phase(log, counters):
    """Checkpoints, the fault-tolerant loop, the compressed wire and
    elastic data parallelism on the card (see the module docstring).  The
    injected death and the elastic worker's two scenarios run side by
    side, the uninterrupted run beside them where the card has the memory
    (else after them, alone); the resume runs alone, and its times (a save,
    a restore, a steady step and its all-reduce) are the ones reported."""
    import concurrent.futures
    import dataclasses
    import gc
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager, tree_flatten, tree_map_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.optim import AdamW, Compressor

    card = _card()
    L = FT_LAYERS
    cfg = dataclasses.replace(configs.get(ARCH), n_layers=L)
    main3 = ("redmule_matmul", "redmule_matmul_batched", "flash_attention")
    # a step with remat: the projections and the tied head forward, the
    # layers' projections again in the recompute, dX and dW of each forward
    # GEMM (kernel 1); the composition's six launches a layer (kernel 2);
    # flash forward and in the recompute (kernel 3)
    per_step = dict(zip(main3, (16 * L + 3, 6 * L, 2 * L)))
    parts, res = {}, {"card": card}

    # 1. determinism: rank 0's step (its FT_BATCH / FT_DP rows) at world 1,
    # twice from one state, compared on the card
    t1 = time.perf_counter()
    opt = AdamW(lr=3e-3, warmup_steps=10)
    step, init_fn = train.build_compressed_dp_train_step(cfg, opt, Compressor("fp8_e4m3"))
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=FT_SEQ, global_batch=FT_BATCH,
                        seed=SEED).batch(0)
    local = {k: v[:FT_BATCH // FT_DP] for k, v in batch.items()}
    state = init_fn(seed=SEED, device="cuda")
    copy = lambda tree: tree_map_leaves(
        lambda x: x.detach().clone().requires_grad_(x.requires_grad)
        if isinstance(x, torch.Tensor) else x, tree)
    twin = copy(state)
    outs = []
    for s_i in (state, twin):
        _zero(counters)
        s_i, _ = step(s_i, local)
        torch.cuda.synchronize()
        got = _read(counters)
        if {k: got[k] for k in main3} != per_step or got["chunked_linear_attention"]:
            raise AssertionError(f"ft step launches {got}, structural {per_step}")
        outs.append(s_i)
    diff = _bitwise_trees(*outs)
    print(f"[ft] one full-width DP step (1 rank, {FT_BATCH // FT_DP} x {FT_SEQ}) twice "
          f"from one state: launches {per_step} each; leaves that differ: {diff} of "
          f"{len(tree_flatten(outs[0]))}", flush=True)
    log.append({"check": "ft full-width step run twice: params, moments and error "
                         "feedback bitwise equal", "ok": not diff, "differing_leaves": diff})
    if diff:
        raise AssertionError(f"ft: a full-width step run twice differs in leaves {diff}")
    prof = _device_profile(lambda: step(outs[1], local), iters=1)
    _print_profile("ft DP step (1 rank, the wire's reduce a no-op)", prof)
    _no_library_gemm(prof, "ft DP step")
    res["determinism"] = {"launches_per_step": per_step, "differing_leaves": diff,
                          "profile": prof}
    del state, twin, outs, s_i, step
    gc.collect()
    torch.cuda.empty_cache()
    parts["determinism"] = time.perf_counter() - t1

    tmp = tempfile.mkdtemp(prefix="ft_")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"[ft] free disk under {tmp}: {free / 1e9:.1f} GB", flush=True)
        res["free_disk_bytes"] = free
        lm = "repro_torch.launch.train"
        base = ["--arch", ARCH, "--full", "--layers", str(L), "--batch", str(FT_BATCH),
                "--seq", str(FT_SEQ), "--compress", "fp8_e4m3", "--dp-procs", str(FT_DP),
                "--steps", str(FT_STEPS), "--seed", str(SEED), "--device", "cuda",
                "--instrument"]
        ckpt = os.path.join(tmp, "ckpt")
        ftargs = ["--ckpt-dir", ckpt, "--save-every", str(FT_SAVE)]
        js = {k: os.path.join(tmp, f"{k}.json") for k in ("ref", "res")}

        # 2a. the injected death and the elastic worker's two scenarios side
        # by side, and the uninterrupted run too where the card has room
        free = torch.cuda.mem_get_info()[0]
        side = free >= FT_SIDE_BY_SIDE_FREE
        print(f"[ft] card memory free {free / 2**30:.1f} GiB (this process holds "
              f"{torch.cuda.memory_reserved() / 2**30:.1f}): the uninterrupted run "
              f"{'beside the death' if side else 'after it, alone'}", flush=True)
        uninterrupted = lambda: _ft_launch(lm, FT_DP, base + ["--result", js["ref"]], tmp,
                                           "uninterrupted run")
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            die = pool.submit(_ft_launch, lm, FT_DP, base + ftargs + [
                "--fail-step", str(FT_FAIL), "--fail-mode", "die"], tmp, "injected death")
            ref_run = pool.submit(uninterrupted) if side else None
            torn = pool.submit(_ft_elastic_torn, tmp)
            attach = pool.submit(_ft_elastic_attach, tmp)
            rc, out_die, t_die = die.result()
            rc_ref, out_ref, t_ref = ref_run.result() if side else uninterrupted()
            res["elastic"] = {"torn_write": torn.result(), "attach": attach.result()}
        parts["side_by_side"] = time.perf_counter() - t1
        mgr = CheckpointManager(ckpt)
        if rc != 13 or mgr.latest() != FT_SAVE:
            raise AssertionError(f"ft: the injected death exited {rc} with checkpoints "
                                 f"{mgr.all_steps()}, not 13 after step {FT_SAVE}")
        ckpt_bytes = sum(f.stat().st_size for f in Path(mgr._dir(FT_SAVE)).iterdir())
        for name, row in res["elastic"].items():
            log.append({"check": f"ft elastic {name} on the card", "ok": row["ok"],
                        **{k: v for k, v in row.items() if k != "ok"}})
            if not row["ok"]:
                raise AssertionError(f"ft elastic {name}: {row}")

        # 2b. the resume, alone: its times are the ones reported
        t1 = time.perf_counter()
        if rc_ref != 0:
            raise AssertionError(f"ft: the uninterrupted run exited {rc_ref}")
        wire = [ln for ln in out_ref.splitlines() if "gradient wire" in ln]
        if not wire or f"bytes/step={FT_WIRE_FP8} fp32_bytes/step={FT_WIRE_FP32}" not in wire[0]:
            raise AssertionError(f"ft: wire bytes {wire}, not {FT_WIRE_FP8} / {FT_WIRE_FP32}")
        rc, out_res, t_res = _ft_launch(lm, FT_DP, base + ftargs + ["--result", js["res"]],
                                        tmp, "resume")
        if rc != 0 or f"resumed from checkpoint step {FT_SAVE}" not in out_res:
            raise AssertionError(f"ft: the resume exited {rc}: {out_res[-800:]}")
        parts["resume"] = time.perf_counter() - t1
        ref, got = (json.loads(Path(js[k]).read_text()) for k in ("ref", "res"))
        same = {k: got[k] == ref[k] for k in ("digest", "ef_digest", "opt_digest", "loss")}
        goodput = [ln for ln in out_res.splitlines() if ln.startswith("[ft] goodput=")]
        g = got["goodput"]
        print(f"[ft] kill and resume ({card}): uninterrupted {t_ref:.1f} s, died (exit 13) "
              f"after {t_die:.1f} s, resumed {t_res:.1f} s; equal to the uninterrupted "
              f"run: {same}; loss {got['loss']!r}; {goodput[0] if goodput else g}", flush=True)
        log.append({"check": "ft kill at step 3 and resume: digests and loss equal to the "
                             "uninterrupted run's", "ok": all(same.values()), **same})
        if not all(same.values()) or g["restarts"] != 1 or g["recomputed_steps"] != 1:
            raise AssertionError(f"ft: resumed run differs: {same}, goodput {g}")
        # rank 0's launches: the structural count a step, on every step
        lau = {}
        for name, run in (("uninterrupted", ref), ("resumed", got)):
            n_steps = len(run["step_s"])
            lau[name] = {k: run["launches"][f"{k}.launches"] for k in main3}
            want = {k: n_steps * v for k, v in per_step.items()}
            if lau[name] != want or run["launches"]["chunked_linear_attention.launches"]:
                raise AssertionError(f"ft {name}: rank 0 launches {run['launches']}, "
                                     f"structural {want}")
        # the resume ran alone: its second step is the steady one
        step_ms = [t * 1e3 for t in got["step_s"]]
        ar_ms = [t * 1e3 for t in got["allreduce_s"]]
        share = ar_ms[-1] / step_ms[-1]
        res["kill_resume"] = {
            "same": same, "loss": got["loss"], "goodput": g, "ckpt_bytes": ckpt_bytes,
            "save_s": got["save_s"], "restore_s": got["restore_s"],
            "step_ms": step_ms, "allreduce_ms": ar_ms, "allreduce_share": share,
            "side_by_side_step_ms": [t * 1e3 for t in ref["step_s"]],
            "setup_s": {"uninterrupted": ref["setup_s"], "resumed": got["setup_s"]},
            "digest_s": {"uninterrupted": ref["digest_s"], "resumed": got["digest_s"]},
            "launches_rank0": lau, "seconds": {"uninterrupted": t_ref, "died": t_die,
                                               "resumed": t_res}}
        print(f"[ft] ({card}) checkpoint {ckpt_bytes} bytes; save (gather + write) "
              f"{got['save_s']} s, restore {got['restore_s']} s; the resume's steps "
              f"{[round(x, 1) for x in step_ms]} ms (all-reduce "
              f"{[round(x, 1) for x in ar_ms]}, the steady step's share {share:.3f}); the "
              f"uninterrupted run's, beside the death: "
              f"{[round(x, 1) for x in res['kill_resume']['side_by_side_step_ms']]} ms; "
              f"rank-0 setup {res['kill_resume']['setup_s']} s, digests "
              f"{res['kill_resume']['digest_s']} s; launches {lau}", flush=True)
        launches = {name: ref["launches"].get(f"{fn.__name__}.{attr}", 0)
                    for name, (fn, attr) in counters.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[ft] seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()),
          flush=True)
    res.update(launches=launches, seconds=parts)
    return res


def _ft_elastic(ckpt: str, dp: int, *extra, what: str, steps: int = 8):
    return _ft_launch("repro_torch.runtime.elastic", dp, [
        "--device", "cuda", "--ckpt", ckpt, "--dp", str(dp), "--steps", str(steps),
        "--save-every", "2", "--compress", "fp8_e4m3", "--log-every", "100", *extra],
        str(Path(ckpt).parent), what)


def _ft_elastic_torn(tmp: str) -> dict:
    """The elastic worker on the card at dp 2: a torn checkpoint write at
    step 4, then the resume, which must land on step 2 and reach the
    uninterrupted run's digest."""
    import os

    d = os.path.join(tmp, "el_torn")
    os.makedirs(d)
    js = lambda k: os.path.join(d, f"{k}.json")
    rc, _, t_ref = _ft_elastic(os.path.join(d, "ref"), 2, "--result", js("ref"),
                               what="elastic uninterrupted")
    rc2, _, t_crash = _ft_elastic(os.path.join(d, "ckpt"), 2, "--fail-step", "4",
                                  "--fail-mode", "ckpt_crash", what="elastic torn write")
    names = sorted(os.listdir(os.path.join(d, "ckpt")))
    rc3, out3, t_res = _ft_elastic(os.path.join(d, "ckpt"), 2, "--result", js("res"),
                                   what="elastic resume")
    ok = (rc == 0 and rc2 == 13 and "step_000000004.tmp" in names
          and "step_000000004" not in names and rc3 == 0
          and "resumed from checkpoint step 2" in out3
          and json.loads(Path(js("res")).read_text())["digest"]
          == json.loads(Path(js("ref")).read_text())["digest"])
    print(f"[ft] elastic torn write at dp 2: exits {rc} / {rc2} / {rc3}, files {names}, "
          f"resumed from step 2 to the uninterrupted digest: {ok} ({t_ref:.1f} / "
          f"{t_crash:.1f} / {t_res:.1f} s)", flush=True)
    return {"ok": ok, "seconds": [t_ref, t_crash, t_res]}


def _ft_elastic_attach(tmp: str) -> dict:
    """The elastic worker on the card: a dp-4 FP8 checkpoint continued at
    dp 2, its residuals the regroup's sums and its windows the maxima, to
    the last step with a finite loss."""
    import os

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager

    d = os.path.join(tmp, "el_attach")
    os.makedirs(d)
    e = os.path.join(d, "ckpt")
    rc, _, t4 = _ft_elastic(e, 4, steps=4, what="elastic dp 4")
    a4 = {k: v.copy() for k, v in CheckpointManager(e)._load_verified(4)[0].items()}
    rc2, out2, t2 = _ft_elastic(e, 2, "--result", os.path.join(d, "2.json"),
                                what="elastic dp 2")
    a2, m2 = CheckpointManager(e)._load_verified(4)
    r2 = json.loads(Path(d, "2.json").read_text()) if rc2 == 0 else {}
    # "ef" flattens first: per parameter the residual, then the window's
    # scale, history and overflow count
    grouped = lambda a, how: getattr(a.reshape(2, 2, *a.shape[1:]), how)(1)
    sums = max(float(np.max(np.abs(a2[f"leaf_{i}"] - grouped(a4[f"leaf_{i}"], "sum")))
                     / max(np.max(np.abs(a4[f"leaf_{i}"])), 1e-30)) for i in range(0, 16, 4))
    maxima = all(np.array_equal(a2[f"leaf_{i}"], grouped(a4[f"leaf_{i}"], "max"))
                 for i in range(16) if i % 4)
    ok = bool(rc == 0 and rc2 == 0 and "elastic attach: regrouping step-4 checkpoint "
              "from dp=4 to dp=2" in out2 and "resumed from checkpoint step 4" in out2
              and m2["metadata"].get("elastic_migrated_from_dp") == 4 and sums <= 1e-6
              and maxima and r2.get("last_step") == 7
              and np.isfinite(r2.get("loss", np.nan)))
    print(f"[ft] elastic 4 -> 2: exits {rc} / {rc2}; residuals vs the regroup's sums "
          f"{sums:.3e} of max, windows the maxima {maxima}; last step "
          f"{r2.get('last_step')}, loss {r2.get('loss')} ({t4:.1f} / {t2:.1f} s)", flush=True)
    return {"ok": ok, "sums_err": sums, "maxima": maxima, "seconds": [t4, t2],
            "loss": r2.get("loss")}


def two_layer_train_parity(log, cfg):
    """Loss and gradients of a two-layer cut of the LM at full width
    (d 2048, vocab 151936, batch 1 x seq 128), card vs the CPU plain path,
    under fp32 (the card's attention forward on kernel 3's fp32 route, its
    backward through the composition on kernel 2's fp32 route) and
    tpu_bf16: the loss and the gradients of ``wqkv`` and ``w_in`` (both
    layers) and of the embedding (the gather and the tied head's "tn"
    launch together).  Each is held to 8x the CPU's own spread (one thread
    against all: another summation order), above a floor of one rounding
    (fp32 1e-5, bf16 2^-8).  Under both policies the card's run must
    launch kernel 3 once a layer forward and once in the remat recompute."""
    import dataclasses

    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.optim import tree_map

    batch_np = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=L_CUT_SEQ,
                           global_batch=1, seed=SEED).batch(0)
    n_threads = torch.get_num_threads()
    names = ("loss", "grad wqkv", "grad w_in", "grad embed")

    def run(params, c, dev):
        wrt = [params["layers"]["attn"]["wqkv"], params["layers"]["mlp"]["w_in"],
               params["embed"]]
        wrt = [t.detach().requires_grad_(True) for t in wrt]
        lay = params["layers"]
        p = {**params, "embed": wrt[2],
             "layers": {**lay, "attn": {**lay["attn"], "wqkv": wrt[0]},
                        "mlp": {**lay["mlp"], "w_in": wrt[1]}}}
        loss, _ = transformer.loss_fn(p, c, train._to_device(batch_np, dev))
        return [loss.detach().cpu()] + [t.detach().cpu() for t in
                                        torch.autograd.grad(loss, wrt)]

    result = {}
    for policy, floor in (("fp32", 1e-5), (cfg.policy_name, 2.0 ** -8)):
        c = dataclasses.replace(cfg, n_layers=2, policy_name=policy)
        p_gpu = transformer.init_params(c, seed=SEED + 4, device="cuda",
                                        dtype=torch.float32)
        p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
        flash0 = fa.flash_attention.launches
        got = run(p_gpu, c, torch.device("cuda"))
        flash = fa.flash_attention.launches - flash0
        print(f"[lmtrain] two-layer cut ({policy}): kernel 3 launched {flash} "
              f"times (structural {2 * c.n_layers})", flush=True)
        if flash != 2 * c.n_layers:
            raise AssertionError(f"lmtrain two-layer cut ({policy}): kernel 3 "
                                 f"launched {flash} times, not {2 * c.n_layers}")
        del p_gpu
        torch.cuda.empty_cache()
        want = run(p_cpu, c, torch.device("cpu"))
        torch.set_num_threads(1)
        try:
            want_1t = run(p_cpu, c, torch.device("cpu"))
        finally:
            torch.set_num_threads(n_threads)
        rows, failed = {}, []
        for name, a_, b_, c_ in zip(names, got, want, want_1t):
            scale = max(b_.abs().max().item(), 1e-30)
            spread = (c_ - b_).abs().max().item() / scale
            tol = max(8 * spread, floor)
            try:
                err = _check(f"lmtrain two-layer (d 2048, 1x{L_CUT_SEQ}, {policy}) "
                             f"{name}, card vs CPU plain (CPU spread {spread:.2e})",
                             a_, b_, tol, log)
            except AssertionError as e:
                err = float("nan")
                failed.append(str(e))
            rows[name] = {"err_rel": err / scale, "spread": spread, "tol_rel": tol}
        result[policy] = rows
        if failed:
            raise AssertionError("; ".join(failed))
    return result


def dense_serve_cuts(log):
    """A two-layer cut of each dense config this slice added, at full
    width under tpu_bf16 (random weights from a seed, made on the card and
    copied to the CPU): prefill logits of a 16-token prompt and one decode
    step from one cache (the CPU's), card vs the CPU plain path.  Covers
    command-r-35b's 8192 / 22528 / 256000-vocab shapes, mistral-nemo's
    q-projection narrower than d_model, musicgen-medium's MHA at D 64 with
    layernorm and the fused GELU MLP.  Bound: the serve phase's two-layer
    bf16 bound (2^-4 of max)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer

    errs = {}
    gen = torch.Generator().manual_seed(SEED + 5)
    for arch in DENSE_ARCHS:
        c = dataclasses.replace(configs.get(arch), n_layers=2)
        pc = transformer.init_params(c, seed=SEED + 6, device="cuda")
        pcpu = _to_cpu(pc)
        sp = torch.randint(0, c.vocab_size, (1, 16), generator=gen)
        got_l, _ = transformer.prefill(pc, c, {"inputs": sp.cuda()}, 24)
        want_l, want_c = transformer.prefill(pcpu, c, {"inputs": sp}, 24)
        e_pre = _check(f"{arch} two-layer prefill logits, card vs CPU plain",
                       got_l.cpu(), want_l, 2.0 ** -4, log)
        tok = torch.randint(0, c.vocab_size, (1, 1), generator=gen)
        p16, s16 = torch.tensor([16]), np.array([17], np.int32)
        got_d, _ = transformer.serve_step(
            pc, c, tok.cuda(), {"layers": {k: v.cuda() for k, v in
                                           want_c["layers"].items()}},
            p16.cuda(), kv_group_sizes=s16)
        want_d, _ = transformer.serve_step(pcpu, c, tok, want_c, p16,
                                           kv_group_sizes=s16)
        e_dec = _check(f"{arch} two-layer decode step from one cache, card vs "
                       "CPU plain", got_d.cpu(), want_d, 2.0 ** -4, log)
        errs[arch] = {"prefill": e_pre, "decode": e_dec}
        del pc, pcpu
        torch.cuda.empty_cache()
    return errs


def full_depth_parity(log, cfg):
    """Step 0 of the training path at full depth and width, card vs the CPU
    plain path: the loss of ``transformer.loss_fn`` on one batch of 1 x
    FD_SEQ tokens at the path's seed and the gradients of w_up, w_qkv
    (every mLSTM block) and r_gates (the sLSTM block) of the first and the
    last super-block, under ``fp32`` and the training policy.  The bound is
    the spread measured in this run between the CPU plain path on half its
    threads and on all of them (another BLAS blocking, another summation
    order) times 8, above a floor of one rounding (fp32 1e-5, bf16 2^-8).
    A row whose bound reaches max |x| (the bf16 policy's deep rows: the
    rounding's perturbation grows through 48 recurrent blocks) has no
    reference: it is printed and logged as unbounded (no pass / fail) and
    held only to be finite.  Half, not one: the one-thread runs took 49-54 s a policy, and the run
    must stay within its time.  Returns the errors, spreads and seconds per
    policy."""
    import dataclasses

    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.optim import tree_map

    batch_np = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=FD_SEQ,
                           global_batch=1, seed=SEED).batch(0)
    n_threads = torch.get_num_threads()
    names = [(f"grad {w} super-block {b}", w, i) for w in ("w_up", "w_qkv", "r_gates")
             for b, i in (("0", 0), ("last", -1))]

    def run(params, c, dev):
        cells = params["layers"]
        wrt = [cells["mlstm"]["cell"]["w_up"], cells["mlstm"]["cell"]["w_qkv"],
               cells["slstm"]["cell"]["r_gates"]]
        wrt = [t.detach().requires_grad_(True) for t in wrt]
        p = {**params, "layers": {
            "mlstm": {**cells["mlstm"], "cell": {**cells["mlstm"]["cell"],
                                                 "w_up": wrt[0], "w_qkv": wrt[1]}},
            "slstm": {**cells["slstm"], "cell": {**cells["slstm"]["cell"],
                                                 "r_gates": wrt[2]}}}}
        loss, _ = transformer.loss_fn(p, c, train._to_device(batch_np, dev))
        grads = dict(zip(("w_up", "w_qkv", "r_gates"), torch.autograd.grad(loss, wrt)))
        return [loss.detach().cpu()] + [grads[w][i].detach().cpu() for _, w, i in names]

    result = {}
    # fp32 parameters, drawn once for both policies (each casts on use)
    p_cpu = transformer.init_params(cfg, seed=SEED, device="cpu", dtype=torch.float32)
    for policy, floor, depth in (("fp32", 1e-5, FD_FP32_LAYERS),
                                 (cfg.policy_name, 2.0 ** -8, cfg.n_layers)):
        c = dataclasses.replace(cfg, policy_name=policy, n_layers=depth)
        n_super = depth // cfg.ssm.slstm_period
        p_run = {**p_cpu, "layers": tree_map(lambda t: t[:n_super], p_cpu["layers"])}
        t0 = time.perf_counter()
        got = run(tree_map(lambda t: t.cuda(), p_run), c, torch.device("cuda"))
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        want = run(p_run, c, torch.device("cpu"))
        t_cpu = time.perf_counter() - t0
        half = max(1, n_threads // 2)
        torch.set_num_threads(half)
        t0 = time.perf_counter()
        try:
            want_half = run(p_run, c, torch.device("cpu"))
        finally:
            torch.set_num_threads(n_threads)
        t_half = time.perf_counter() - t0
        print(f"[train] full depth {policy}: card {t_card:.1f} s, CPU {t_cpu:.1f} s "
              f"({n_threads} threads), {t_half:.1f} s ({half} threads)", flush=True)
        rows, failed = {}, []
        for name, a_, b_, c_ in zip(["loss"] + [n for n, _, _ in names], got, want,
                                    want_half):
            scale = max(b_.abs().max().item(), 1e-30)
            spread = (c_ - b_).abs().max().item() / scale
            tol = max(8 * spread, floor)
            print(f"[train] full depth {policy} {name}: CPU spread ({half} vs "
                  f"{n_threads} threads) {spread:.3e} of max", flush=True)
            label = (f"full depth ({depth} blocks, 1x{FD_SEQ}, {policy}) step 0 "
                     f"{name}, card vs CPU plain")
            if tol >= 1.0:
                # two correct summation orders already differ by max |x| / 8:
                # there is no reference to hold the card to, so the row is
                # reported, not logged as a passing check (ROADMAP Queue C)
                err = (a_.float() - b_.float()).abs().max().item()
                log.append({"unbounded": label, "max_abs_err": err,
                            "bound_rel": tol, "finite": math.isfinite(err)})
                print(f"[unbounded] {label}: max_abs_err={err:.3e} "
                      f"({err / scale:.3e} of max); 8x the CPU spread is "
                      f"{tol:.3e} of max, no reference", flush=True)
                if not math.isfinite(err):
                    failed.append(f"{label}: not finite")
            else:
                try:
                    err = _check(label, a_, b_, tol, log)
                except AssertionError as e:
                    err = float("nan")
                    failed.append(str(e))
            rows[name] = {"err_rel": err / scale, "spread": spread, "tol_rel": tol,
                          "max_abs": scale, "bounded": tol < 1.0}
        result[policy] = {"rows": rows, "card_s": t_card, "cpu_s": t_cpu,
                          "cpu_half_threads_s": t_half}
        if failed:
            raise AssertionError("; ".join(failed))
    return result


def _fp32_shapes(run):
    """``{"result": run(), "tally": {...}}``: the fp32 GEMM launches that one
    ``run()`` makes, counted by (wrapper, layout, batch, M, N, K, fused
    backward) where the wrappers hand them to the kernel
    (``kernels/redmule_matmul.py::launch``)."""
    import torch

    from repro_torch.kernels import redmule_matmul as rm

    tally: dict = {}
    launch = rm.launch

    def counted(x, w, **kw):
        if x.dtype == torch.float32:
            layout = kw["layout"]
            M, N, K = rm.logical_dims(x.shape, w.shape, layout)
            batch = math.prod(torch.broadcast_shapes(x.shape[:-2], w.shape[:-2]))
            name = ("redmule_matmul" if x.ndim == w.ndim == 2
                    else "redmule_matmul_batched")
            key = (name, layout, batch, M, N, K,
                   bool(kw.get("bias_grad") or kw.get("grad_epilogue")))
            tally[key] = tally.get(key, 0) + 1
        return launch(x, w, **kw)

    rm.launch = counted
    try:
        result = run()
    finally:
        rm.launch = launch
    return {"result": result, "tally": tally}


def _fp32_by_shape(tally):
    """Each tallied fp32 GEMM shape timed alone on the card (device time of
    the kernel on contiguous random operands of that shape; a fused
    backward as db on "tn", act' on "nt"), times its count: where the fp32
    route's time in a training step goes.  Printed largest first; returns
    the rows."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.core import tiling
    from repro_torch.kernels import ops

    rows = []
    for (name, layout, batch, M, N, K, fused), n in tally.items():
        x_shape = (N, M) if layout == "tn" else (M, N)
        w_shape = (K, N) if layout == "nt" else (N, K)
        lead = (batch,) if name == "redmule_matmul_batched" else ()
        x = torch.randn(*lead, *x_shape, device="cuda")
        w = torch.randn(*lead, *w_shape, device="cuda")
        fn = getattr(ops, name)
        kw = {}
        if fused:  # "tn": dW + db; "nt": dX with act' on dZ
            kw = ({"bias_grad": True} if layout == "tn" else
                  {"deriv": torch.randn_like(x), "grad_epilogue": "relu"})
        ms = _device_profile(lambda: fn(x, w, policy=prec.FP32, layout=layout, **kw),
                             5)["by_kernel"]["redmule_gemm_f32"]["ms"]
        tile = tiling.choose_tiles(M, N, K)
        S = tiling.split_plan(M, N, K, tile=tile, batch=batch, route="simt",
                              fused_bwd=fused).splits
        rows.append({"wrapper": name, "layout": layout, "batch": batch, "M": M,
                     "N": N, "K": K, "fused_bwd": fused, "splits": S,
                     "launches": n, "ms": ms, "total_ms": n * ms})
    rows.sort(key=lambda r: -r["total_ms"])
    total = sum(r["total_ms"] for r in rows)
    print(f"[train] fp32 route by shape (each shape timed alone x its launches "
          f"in one step): {total:.1f} ms in {sum(r['launches'] for r in rows)} "
          f"launches", flush=True)
    for r in rows[:12]:
        print(f"[train]   {r['wrapper']} {r['layout']} {r['batch']} x ({r['M']} x "
              f"{r['N']} x {r['K']}){' +db' if r['fused_bwd'] else ''} S={r['splits']}: "
              f"{r['launches']} x {r['ms']:.4f} ms = {r['total_ms']:.1f} ms", flush=True)
    return rows


def _ae_relabeled(params, seed: int):
    """The same AutoEncoder with its hidden units renumbered: the same
    function, another summation order in every GEMM after the first.
    Returns the tree and a map of its gradients back to the original
    labels."""
    import torch

    from repro_torch.models import autoencoder

    dims = autoencoder.AE_DIMS
    gen = torch.Generator().manual_seed(seed)
    perms = ([torch.arange(dims[0])]
             + [torch.randperm(d, generator=gen) for d in dims[1:-1]]
             + [torch.arange(dims[-1])])

    def relabel(tree, inverse=False):
        out = {}
        for i in range(len(dims) - 1):
            pi, po = perms[i], perms[i + 1]
            if inverse:
                pi, po = torch.argsort(pi), torch.argsort(po)
            out[f"fc{i}"] = {k: (v[pi][:, po] if k == "w" else v[po])
                             for k, v in tree[f"fc{i}"].items()}
        return out

    return relabel(params), lambda g: relabel(g, inverse=True)


def _ae_step_parity(log, batch: int):
    """One paper_fp16 step (loss and gradients) at ``batch``, the card
    against the CPU plain path, from the same parameters and data.

    The held bounds are the CPU parity's (loss 1e-3 relative, gradients
    2e-2 of the largest |g|) or 8x the spread that two correct summation
    orders show on this step, measured here: the CPU plain path on the same
    network with its hidden units renumbered.  The gradients are held at
    batch ``AE_BIG``, beside a control that must fail their bound: the card
    run again with one row of fc1's weight scaled by ``AE_CONTROL``.  At
    batch 16 only the loss is held and the gradients' distance is printed:
    there they jump with the ReLU masks.  A pre-activation within rounding
    of zero changes sign under another summation order; on the CPU the
    renumberings that move the gradients by 0.07-0.12 of max flip ReLU
    masks in the decoder, and those that flip none move them by less than
    2e-3.  No bound that admits two correct summation orders there can fail
    a wrong path."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.data import SyntheticAE
    from repro_torch.launch import train
    from repro_torch.models import autoencoder
    from repro_torch.optim import tree_leaves, tree_map

    params = autoencoder.init_ae(seed=SEED + 4, device="cpu")
    x = torch.from_numpy(SyntheticAE(batch=batch, seed=SEED).sample(1))

    def run(tree, dev):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True), tree)
        loss, g = train.ae_grads(p, x.to(dev), prec.PAPER_FP16)
        return loss.cpu(), tree_map(lambda t: t.detach().cpu(), g)

    flat = lambda g: torch.cat([t.float().flatten() for t in tree_leaves(g)])
    rel = lambda g: float((flat(g) - flat(g_cpu)).abs().max() / flat(g_cpu).abs().max())
    loss_gpu, g_gpu = run(params, "cuda")
    loss_cpu, g_cpu = run(params, "cpu")
    alt, back = _ae_relabeled(params, SEED + 5)
    loss_alt, g_alt = run(alt, "cpu")
    spread_loss = abs(float(loss_alt - loss_cpu)) / abs(float(loss_cpu))
    spread_g = rel(back(g_alt))
    print(f"[ae] step parity B={batch}: CPU spread (hidden units renumbered) "
          f"loss {spread_loss:.3e}, grads {spread_g:.3e} of max", flush=True)
    err_l = _check(f"AE step B={batch} loss, card vs CPU plain", loss_gpu,
                   loss_cpu, max(1e-3, 8 * spread_loss), log)
    out = {"batch": batch, "loss_err": err_l, "spread_loss": spread_loss,
           "spread_grad": spread_g, "grad_err_of_max": rel(g_gpu)}
    if batch != AE_BIG:
        print(f"[ae] step parity B={batch}: grads card vs CPU {rel(g_gpu):.3e} of "
              "max, not held (ReLU masks flip under rounding)", flush=True)
        return out
    tol_g = max(2e-2, 8 * spread_g)
    bad = tree_map(lambda t: t.clone(), params)
    bad["fc1"]["w"][0] *= AE_CONTROL
    ctl = rel(run(bad, "cuda")[1])
    print(f"[ae] step parity B={batch}: control (fc1 weight row 0 x {AE_CONTROL}) "
          f"{ctl:.3e} of max, bound {tol_g:.3e}", flush=True)
    if not ctl > tol_g:
        raise AssertionError(f"AE step B={batch}: the control passes the bound")
    out["grad_err"] = _check(f"AE step B={batch} grads, card vs CPU plain",
                             flat(g_gpu), flat(g_cpu), tol_g, log)
    out["control_err_of_max"] = ctl
    return out


def _ae8_step_parity(log, batch: int):
    """One mixed_fp8_e4m3 step (loss and gradients) at ``batch``, the card
    against the CPU plain path, from the same parameters and data.

    Renumbering hidden units (the paper_fp16 spread) moves nothing here:
    the FP8 products sum exactly.  What moves the step is BatchNorm's fp32
    reductions over the batch (its statistics, and their sums in the
    backward): another summation order there moves an activation or a
    cotangent across an E4M3 / E5M2 rounding boundary, and at large batch
    that moves the gradients by percents of their max.  So the step is held
    twice, each time beside two controls that must fail the same bound
    (on the CPU: the batch with its last row dropped, and E5M2 operands in
    place of E4M3):

    * with BatchNorm in float64 on both sides (``stats_dtype``), which
      makes those reductions order-independent: the gradients within
      ``AE8_STATS_TOL`` of max;
    * as the path runs it (fp32 statistics): within max(2e-2, 1.25x) the
      spread that the same batch with its rows shuffled inside each dW
      rounding block shows, measured here on the card and on the CPU (the
      same function: BatchNorm, the loss and each rounding block see the
      same rows).

    The loss is held to 1e-3 relative throughout."""
    import dataclasses

    import torch

    from repro_torch.core import precision as prec
    from repro_torch.core import tiling
    from repro_torch.data import SyntheticAE
    from repro_torch.models import autoencoder
    from repro_torch.optim import tree_leaves, tree_map

    pol = prec.MIXED_FP8_E4M3
    wrong = dataclasses.replace(pol, x_dtype=torch.float8_e5m2,
                                w_dtype=torch.float8_e5m2)
    params = autoencoder.init_ae(seed=SEED + 4, device="cpu")
    names = [f"{layer}.{k}" for layer, leaves in params.items() for k in leaves]
    x = torch.from_numpy(SyntheticAE(batch=batch, seed=SEED).sample(1))
    dims = autoencoder.AE_DIMS
    blk = min(tiling.accum_block(dims[i], batch, dims[i + 1],
                                 compute_dtype=torch.float16,
                                 accum_dtype=torch.float16, x_dtype=pol.x_dtype,
                                 w_dtype=pol.grad_dtype)
              for i in range(len(dims) - 1))
    gen = torch.Generator().manual_seed(SEED + 6)
    shuffled = torch.cat([s + torch.randperm(min(blk, batch - s), generator=gen)
                          for s in range(0, batch, blk)])

    def run(dev, xx=x, stats=torch.float32, policy=pol):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True), params)
        loss, _ = autoencoder.ae_loss(p, xx.to(dev), policy=policy,
                                      stats_dtype=stats)
        g = torch.autograd.grad(loss, tree_leaves(p))
        return loss.detach().cpu(), [t.detach().cpu().float() for t in g]

    flat = lambda g: torch.cat([t.flatten() for t in g])
    rel = lambda a, b: float((flat(a) - flat(b)).abs().max() / flat(b).abs().max())

    def worst_leaf(a, b):
        scale = flat(b).abs().max()
        errs = [float((u - v).abs().max() / scale) for u, v in zip(a, b)]
        i = max(range(len(errs)), key=errs.__getitem__)
        return names[i], errs[i]

    out = {"policy": pol.name, "batch": batch, "shuffle_block": blk}
    for stats, label in ((torch.float64, "float64 BatchNorm"),
                         (torch.float32, "fp32 BatchNorm, as the path runs")):
        loss_gpu, g_gpu = run("cuda", stats=stats)
        loss_cpu, g_cpu = run("cpu", stats=stats)
        controls = {"last row dropped": run("cpu", x[:-1], stats)[1],
                    "e5m2 operands": run("cpu", stats=stats, policy=wrong)[1]}
        controls = {k: rel(v, g_cpu) for k, v in controls.items()}
        if stats == torch.float64:
            spread, tol_g = None, AE8_STATS_TOL
        else:
            spread = {"card": rel(run("cuda", x[shuffled], stats)[1], g_gpu),
                      "cpu": rel(run("cpu", x[shuffled], stats)[1], g_cpu)}
            tol_g = max(2e-2, 1.25 * max(spread.values()))
        leaf = worst_leaf(g_gpu, g_cpu)
        print(f"[ae8] step parity B={batch}, {label}: card vs CPU grads "
              f"{rel(g_gpu, g_cpu):.3e} of max (largest in {leaf[0]}); rows "
              f"shuffled in blocks of {blk}: {spread}; controls {controls}; "
              f"bound {tol_g:.3e}", flush=True)
        if not min(controls.values()) > tol_g:
            raise AssertionError(f"ae8 B={batch} {label}: a control passes the "
                                 f"bound {tol_g:.3e}: {controls}")
        tag = "float64" if stats == torch.float64 else "fp32"
        err_l = _check(f"AE step mixed_fp8_e4m3 B={batch} ({tag} BatchNorm) loss, "
                       "card vs CPU plain", loss_gpu, loss_cpu, 1e-3, log)
        err_g = _check(f"AE step mixed_fp8_e4m3 B={batch} ({tag} BatchNorm) grads, "
                       "card vs CPU plain", flat(g_gpu), flat(g_cpu), tol_g, log)
        out[tag] = {"loss_err": err_l, "grad_err": err_g,
                    "grad_err_of_max": rel(g_gpu, g_cpu), "worst_leaf": leaf,
                    "shuffle_spread": spread, "controls": controls,
                    "grad_tol_of_max": tol_g}
    return out


def _ae_run(counters, args, steps: int, want_per_step: dict, path: str):
    """``train.main`` for the AutoEncoder, with the counts set to 0 just
    before and read just after; checks finite losses and the kernel-1
    launches a step.  Returns (result, launches, wall seconds)."""
    import torch

    from repro_torch.launch import train

    _zero(counters)
    t0 = time.perf_counter()
    out = train.main(["--arch", "ae", "--steps", str(steps), "--seed", str(SEED),
                      "--device", "cuda", *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    print(f"[{path}] launches on the main path: {launches}", flush=True)
    if len(out["history"]) != steps or not all(
            math.isfinite(h["loss"]) for h in out["history"]):
        raise AssertionError(f"{path}: non-finite or missing AE steps")
    per_step = {k: launches[k] / steps for k in want_per_step}
    if per_step != want_per_step:
        raise AssertionError(f"{path}: kernel-1 launches a step {per_step}, "
                             f"expected {want_per_step}")
    return out, launches, wall


def ae_phase(log, counters):
    """The AutoEncoder path through its entry point: 200 paper_fp16 steps
    at batch 16 (the main path), 3 steps under fp32 (the fp32 route) and 3
    paper_fp16 steps at batch 4096 (the dW reductions span 2-4 rounding
    blocks), each with its own launch counts; one profiled step; the
    loss-scaled example; one step held against the CPU plain path at batch
    16 and 4096."""
    import torch

    from repro_torch.core import engine, perf_model
    from repro_torch.core import precision as prec
    from repro_torch.data import SyntheticAE
    from repro_torch.examples import train_autoencoder as example
    from repro_torch.launch import train
    from repro_torch.models import autoencoder
    from repro_torch.optim import AdamW, tree_leaves, tree_map

    k1, faithful, multi = ("redmule_matmul", "redmule_matmul (faithful fp16)",
                           "redmule_matmul (faithful fp16, multi-block)")
    fused, fused32 = ("redmule_matmul (fused backward dW + db)",
                      "redmule_matmul (fp32 route, fused backward dW + db)")
    # every AE layer is one kernel-1 launch forward, one dX, one dW + db
    torch.cuda.reset_peak_memory_stats()
    out, launches, ae_s = _ae_run(
        counters, ["--batch", str(AE_BATCH)], AE_STEPS,
        {k1: 30, faithful: 30, fused: 10, multi: 0}, "ae")
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if not sum(losses[-10:]) < sum(losses[:10]):
        raise AssertionError(f"AE mse is not falling: {losses[:10]} ... {losses[-10:]}")
    _require(launches, (k1, faithful, fused), "ae")
    per_step = {k: launches[k] / AE_STEPS for k in (k1, faithful, fused)}
    # the fp32 policy: the fp32 route's fused backward
    _, launches_fp32, _ = _ae_run(
        counters, ["--batch", str(AE_BATCH), "--policy", "fp32"], 3,
        {k1: 30, "redmule_matmul (fp32 route)": 30, fused32: 10, faithful: 0},
        "ae_fp32")
    # batch 4096: ten multi-block faithful dW + db launches a step
    _, launches_b4096, _ = _ae_run(
        counters, ["--batch", str(AE_BIG)], 3,
        {k1: 30, faithful: 30, multi: 10, fused: 10}, "ae_b4096")
    step_ms = sorted(h["step_ms"] for h in hist[10:])
    print(f"[ae] {AE_STEPS} steps in {ae_s:.2f}s wall; step (CUDA events, steps "
          f"10..{AE_STEPS - 1}) median {step_ms[len(step_ms) // 2]:.3f} ms, mean "
          f"{sum(step_ms) / len(step_ms):.3f} ms; mse {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; peak {peak / 2**20:.1f} MiB", flush=True)

    # one profiled step (device busy / idle share)
    params = autoencoder.init_ae(seed=SEED, device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    opt = AdamW(lr=3e-3, warmup_steps=0)
    state = [opt.init(params)]
    step = train.build_ae_step(opt, prec.PAPER_FP16)
    xb = torch.from_numpy(SyntheticAE(batch=AE_BATCH, seed=SEED).sample(0)).cuda()

    def one_step():
        state[0], loss, _ = step(params, state[0], xb)
        return float(loss)

    one_step()
    prof = _device_profile(one_step, iters=5)
    parts = ", ".join(f"{k} {g['ms']:.4f} ms x{g['count']}"
                      for k, g in sorted(prof["by_kernel"].items()))
    print(f"[profile] AE step B={AE_BATCH}: wall {prof['wall_ms']:.3f} ms, device "
          f"busy {prof['device_ms']:.3f} ms (idle {prof['idle_share']:.3f}): "
          f"{parts}", flush=True)

    # the loss-scaled example (paper_fp16, dynamic loss scaling)
    ex = example.main(["--steps", str(AE_STEPS), "--batch", str(AE_BATCH),
                       "--seed", str(SEED), "--device", "cuda"])
    if not all(math.isfinite(v) for v in ex["losses"]):
        raise AssertionError("the loss-scaled example lost finiteness")
    print(f"[ae] loss-scaled example: {AE_STEPS} steps, overflows "
          f"{ex['overflows']}, final scale {ex['loss_scale']}, mse "
          f"{ex['losses'][0]:.4f} -> {ex['losses'][-1]:.4f}", flush=True)

    # the paper's cycle model from the events of one step on the card,
    # equal to the CPU's (counts), beside its Fig 4c/4d report
    cycles = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True), params)
        with engine.instrument() as events:
            train.ae_grads(p, xb.to(dev), prec.PAPER_FP16)
        cycles[dev] = perf_model.workload_cycles_by_direction(
            perf_model.DEFAULT_MODEL, events)
    report = {b: perf_model.autoencoder_report(perf_model.DEFAULT_MODEL, b)
              for b in (1, AE_BATCH)}
    print(f"[ae] RedMulE cycle model (the paper's cluster) from the card's events, "
          f"B={AE_BATCH}: {cycles['cuda']}; CPU events "
          f"{'equal' if cycles['cuda'] == cycles['cpu'] else 'DIFFER'}", flush=True)
    for b, r in report.items():
        print(f"[ae] autoencoder_report B={b}: speedup {r['speedup']:.2f}x (fwd "
              f"{r['speedup_fwd']:.2f}x / bwd {r['speedup_bwd']:.2f}x), "
              f"{r['hw_macs_per_cycle']:.2f} MAC/cycle", flush=True)
    log.append({"check": "ae cycle model, card events == CPU events",
                "ok": cycles["cuda"] == cycles["cpu"]})
    if cycles["cuda"] != cycles["cpu"]:
        raise AssertionError(f"cycle model: card {cycles['cuda']} vs CPU {cycles['cpu']}")

    parity = [_ae_step_parity(log, b) for b in (AE_BATCH, AE_BIG)]
    return {"ae_wall_s": ae_s, "cycles_by_direction": cycles["cuda"],
            "autoencoder_report": report, "history": hist, "launches": launches,
            "launches_fp32": launches_fp32, "launches_b4096": launches_b4096,
            "launches_per_step": per_step,
            "step_ms_median": step_ms[len(step_ms) // 2],
            "step_ms_mean": sum(step_ms) / len(step_ms), "peak_mem_mib": peak / 2**20,
            "profile": prof, "example": {k: ex[k] for k in ("overflows", "loss_scale")}
            | {"mse_first": ex["losses"][0], "mse_last": ex["losses"][-1]},
            "parity": parity}


def ae8_phase(log, counters):
    """The AutoEncoder under FP8 storage through its entry point: 200
    mixed_fp8_e4m3 steps at batch 16, 3 at batch 4096 (the dW reductions
    over 4096 rows span two rounding blocks) and 3 mixed_fp8_e5m2 steps at
    batch 16, each with its own launch counts — 30 kernel-1 launches a
    step, all FP8 (10 forward, 10 dX, 10 dW), none fused-backward; one
    profiled step; one step at batch 16 and one at 4096 held against the
    CPU plain path."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.data import SyntheticAE
    from repro_torch.launch import train
    from repro_torch.models import autoencoder
    from repro_torch.optim import AdamW, tree_leaves

    k1, fp8, fp8_e5 = ("redmule_matmul", "redmule_matmul (FP8 e4m3, faithful)",
                       "redmule_matmul (FP8 e5m2, fp32 accumulator)")
    faithful, multi = ("redmule_matmul (faithful fp16)",
                       "redmule_matmul (faithful fp16, multi-block)")
    fused = "redmule_matmul (fused backward dW + db)"
    torch.cuda.reset_peak_memory_stats()
    out, launches, wall = _ae_run(
        counters, ["--batch", str(AE_BATCH), "--policy", "mixed_fp8_e4m3"],
        AE_STEPS, {k1: 30, fp8: 30, faithful: 30, fused: 0, multi: 0}, "ae8")
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in out["history"]]
    # the reference reaches 0.1197 by step 40 on the CPU (xla backend)
    if not (sum(losses[-10:]) / 10 <= 0.1197 < losses[0]):
        raise AssertionError(f"ae8 mse did not fall to the reference's level: "
                             f"{losses[:3]} ... {losses[-10:]}")
    _, launches_4k, _ = _ae_run(
        counters, ["--batch", str(AE_BIG), "--policy", "mixed_fp8_e4m3"], 3,
        {k1: 30, fp8: 30, faithful: 30, fused: 0, multi: 10}, "ae8_b4096")
    out5, launches_e5, _ = _ae_run(
        counters, ["--batch", str(AE_BATCH), "--policy", "mixed_fp8_e5m2"], 3,
        {k1: 30, fp8_e5: 30, faithful: 0, fused: 0}, "ae8_e5m2")
    step_ms = sorted(h["step_ms"] for h in out["history"][10:])
    print(f"[ae8] {AE_STEPS} steps in {wall:.2f}s wall; step (CUDA events, "
          f"steps 10..{AE_STEPS - 1}) median {step_ms[len(step_ms) // 2]:.3f} "
          f"ms, mean {sum(step_ms) / len(step_ms):.3f} ms; mse {losses[0]:.4f} "
          f"-> {losses[-1]:.4f} (mean of the last 10: "
          f"{sum(losses[-10:]) / 10:.4f}); peak {peak / 2**20:.1f} MiB; "
          f"mixed_fp8_e5m2 mse {[round(h['loss'], 4) for h in out5['history']]}",
          flush=True)

    params = autoencoder.init_ae(seed=SEED, device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    opt = AdamW(lr=3e-3, warmup_steps=0)
    state = [opt.init(params)]
    step = train.build_ae_step(opt, prec.MIXED_FP8_E4M3)
    xb = torch.from_numpy(SyntheticAE(batch=AE_BATCH, seed=SEED).sample(0)).cuda()

    def one_step():
        state[0], loss, _ = step(params, state[0], xb)
        return float(loss)

    one_step()
    torch.cuda.reset_peak_memory_stats()
    prof = _device_profile(one_step, iters=5)
    peak_step = torch.cuda.max_memory_allocated()
    parts = ", ".join(f"{k} {g['ms']:.4f} ms x{g['count']}"
                      for k, g in sorted(prof["by_kernel"].items()))
    print(f"[profile] AE step mixed_fp8_e4m3 B={AE_BATCH}: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['device_ms']:.3f} ms "
          f"(idle {prof['idle_share']:.3f}), peak {peak_step / 2**20:.1f} MiB: "
          f"{parts}", flush=True)
    parity = [_ae8_step_parity(log, b) for b in (AE_BATCH, AE_BIG)]
    return {"ae8_wall_s": wall, "history": out["history"],
            "history_e5m2": out5["history"], "launches": launches,
            "launches_b4096": launches_4k, "launches_e5m2": launches_e5,
            "step_ms_median": step_ms[len(step_ms) // 2],
            "step_ms_mean": sum(step_ms) / len(step_ms),
            "peak_mem_mib": peak / 2**20, "peak_mem_step_mib": peak_step / 2**20,
            "profile": prof, "parity": parity}


def serve8_phase(log, counters):
    """qwen3-1.7b at full width under mixed_fp8_e4m3 (random fp16 weights
    from the seed, the dense fp16 KV cache): ``generate`` for 4 requests
    x (prompt 128 + 16 new tokens) with the counts set to 0 just before;
    every kernel-1 and kernel-2 launch must be FP8 and the counts
    structural; tokens in range, logits finite.  Then one prefill and one
    decode step timed and profiled, and a two-layer cut held against the
    CPU plain path: prefill logits, and one decode step from the same
    cache."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get(ARCH), policy_name="mixed_fp8_e4m3")
    L = cfg.n_layers
    params = transformer.init_params(cfg, seed=SEED, device="cuda")
    gen = torch.Generator().manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    _zero(counters)
    t0 = time.perf_counter()
    seqs, _, final = serve.generate(params, cfg, prompts, GEN, return_state=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    print(f"[serve8] launches on the main path: {launches}", flush=True)
    if seqs.shape != (BATCH, PROMPT + GEN) or not (
            (seqs >= 0) & (seqs < cfg.vocab_size)).all():
        raise AssertionError(f"serve8: generate returned {seqs.shape} / tokens "
                             "out of range")
    if not np.isfinite(final).all():
        raise AssertionError("serve8: final logits are not finite")
    # B prefills and GEN decode steps: 4 projections a layer and the head
    # each (kernel 1), scores and PV a layer per decode step (kernel 2),
    # flash a layer per prefill
    want = {"redmule_matmul": (BATCH + GEN) * (4 * L + 1),
            "redmule_matmul (FP8 e4m3, faithful)": (BATCH + GEN) * (4 * L + 1),
            "redmule_matmul_batched": GEN * 2 * L,
            "redmule_matmul_batched (FP8 e4m3, decode scores)": GEN * 2 * L,
            "flash_attention": BATCH * L}
    got = {k: launches[k] for k in want}
    print(f"[serve8] launches {got}, structural {want}", flush=True)
    if got != want:
        raise AssertionError("serve8: launches differ from the structural "
                             "count, or not every GEMM launch is FP8")

    gen_c = torch.Generator(device="cuda").manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen_c,
                           device="cuda")
    logits, _ = transformer.prefill(params, cfg, {"inputs": prompt}, PROMPT + GEN)
    prefill_ms = _time_ms(lambda: transformer.prefill(
        params, cfg, {"inputs": prompt}, PROMPT + GEN), iters=10, warmup=2)
    cache = transformer.init_cache(cfg, BATCH, PROMPT + GEN, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen_c,
                         device="cuda")
    pos = torch.full((BATCH,), PROMPT, device="cuda")
    sizes = np.full((BATCH,), PROMPT + 1, np.int32)

    def decode():
        return transformer.serve_step(params, cfg, toks, cache, pos,
                                      kv_group_sizes=sizes)

    dec_logits, _ = decode()
    decode_ms = _time_ms(decode, iters=10, warmup=2)
    for name, t in (("prefill", logits), ("decode", dec_logits)):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"serve8: {name} logits are not finite")
    # the tied head's per-tensor quantization of the (V, d) embedding, alone
    from repro_torch.core import precision as prec
    quant_ms = _time_ms(lambda: prec.quantize_fp8(params["embed"],
                                                  torch.float8_e4m3fn), iters=10)
    print(f"[serve8] generate {BATCH}x({PROMPT}+{GEN}) {wall:.3f}s wall; "
          f"prefill(1x{PROMPT}) {prefill_ms:.3f} ms; decode step (B={BATCH}) "
          f"{decode_ms:.3f} ms; quantizing the embedding {quant_ms:.3f} ms",
          flush=True)
    profiles = {
        "prefill": _device_profile(lambda: transformer.prefill(
            params, cfg, {"inputs": prompt}, PROMPT + GEN), iters=1),
        "decode_step": _device_profile(decode, iters=2)}
    for name, prof in profiles.items():
        parts = ", ".join(f"{k} {g['ms']:.3f} ms x{g['count']}"
                          for k, g in sorted(prof["by_kernel"].items()))
        print(f"[profile] serve8 {name}: wall {prof['wall_ms']:.3f} ms, device "
              f"busy {prof['device_ms']:.3f} ms (idle {prof['idle_share']:.3f}): "
              f"{parts}", flush=True)
    del params, cache

    # a two-layer cut at full width, card vs the CPU plain path, on this
    # script's prompt and on a second one drawn after it
    small = dataclasses.replace(cfg, n_layers=2)
    pc = transformer.init_params(small, seed=SEED + 1, device="cuda")
    pcpu = _to_cpu(pc)
    prompts = [torch.randint(0, cfg.vocab_size, (1, 16), generator=gen_c,
                             device="cuda").cpu() for _ in range(2)]
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen)
    cuts = serve8_cuts(log, small, pc, pcpu,
                       dict(zip(("prompt 1", "prompt 2"), prompts)), tok)
    del pc, pcpu
    return {"serve_wall_s": wall, "prefill_ms": prefill_ms,
            "decode_step_ms": decode_ms, "quantize_embed_ms": quant_ms,
            "launches": launches, "structural": want, "profiles": profiles,
            "two_layer_cuts": cuts}


@contextlib.contextmanager
def _hopper_wrapped(gemm=None, attention=None, without=()):
    """The engine's "hopper" backend with its GEMM and / or attention
    dispatch wrapped, registered under another name through the engine's
    public registry and pinned as the default backend within the context
    (a remat recompute and a backward keep it: the engine carries the
    forward's backend).  ``gemm(fn, x, w, **kw)`` and ``attention(fn, kind,
    operands, **params)`` receive the "hopper" dispatch ``fn`` and call it,
    so the kernels, their wrappers and their launch counts are the ones the
    path runs."""
    from repro_torch.core import engine

    hop = engine.get_backend("hopper")
    name = "hopper (wrapped by chip_smoke.py)"
    engine.register_backend(
        name, hop.fn if gemm is None else (lambda x, w, **kw: gemm(hop.fn, x, w, **kw)),
        capabilities=hop.capabilities - set(without), description=hop.description,
        attention_fn=hop.attention_fn if attention is None else (
            lambda kind, operands, **kw: attention(hop.attention_fn, kind, operands, **kw)))
    try:
        with engine.use_backend(name):
            yield
    finally:
        engine.unregister_backend(name)


def _flash_mismatch(run):
    """``(run(), f)``: ``f`` the largest fraction of output elements in
    which one flash (kernel 3) launch of ``run()`` differs from its plain
    version on the same operands."""
    from repro_torch.kernels import flash_attention as fa

    worst = [0.0]

    def watch(fn, kind, operands, **kw):
        out = fn(kind, operands, **kw)
        if kind == "attention":
            ref = fa.flash_attention_plain(
                *operands, **{k: v for k, v in kw.items() if k not in ("bq", "bkv")})
            worst[0] = max(worst[0], (out != ref).float().mean().item())
        return out

    with _hopper_wrapped(attention=watch):
        got = run()
    return got, worst[0]


def _flash_ulp_flips(frac: float, seed: int):
    """A context in which every flash output (kernel 3's plain version on
    the CPU) moves by one ulp of its dtype, up or down, in ``frac`` of its
    elements (at least one), at positions drawn from ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    ints = {2: torch.int16, 4: torch.int32}

    def flip(fn, kind, operands, **kw):
        z = fn(kind, operands, **kw)
        if kind != "attention":
            return z
        z = z.clone()
        flat = z.reshape(-1)
        n = max(1, round(frac * flat.numel()))
        idx = torch.randint(0, flat.numel(), (n,), generator=gen)
        step = torch.randint(0, 2, (n,), generator=gen) * 2 - 1
        bits = flat.view(ints[z.element_size()])
        bits[idx] += step.to(bits.dtype)
        return z

    return _hopper_wrapped(attention=flip)


def serve8_cuts(log, small, pc, pcpu, prompts, tok) -> dict:
    """The serve8 two-layer cut: prefill logits, and one decode step from
    one cache (the CPU's, copied to the card), card vs the CPU plain path,
    on each prompt, held to a bound measured in the run.

    Under ``mixed_fp8_e4m3`` a one-ulp difference in kernel 3's fp16
    output can cross an E4M3 rounding boundary and grow through the later
    layers to the size of the FP8 rounding itself, so no fixed tolerance
    holds on every prompt.  The run measures the largest fraction f of
    output elements in which one flash launch of the card's cut differs
    from its plain version on the same operands, then, on each prompt, the
    CPU plain path's change when f of every flash output (at least one
    element) moves by one ulp at seeded positions (S8_TRIALS draws).  The
    largest change over both outputs, prompts and draws is the cut's
    rounding floor; the card is held to S8_FACTOR times it (at least
    2^-10).  Two controls must fail that bound on each prompt: row 0 of
    the first layer's ``wqkv`` zeroed, and the attention scale off by a
    factor (1 + 2^-6)."""
    import numpy as np
    import torch

    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer

    def rel(a, b):
        return (a.float() - b.float()).abs().max().item() / max(
            b.float().abs().max().item(), 1e-30)

    def scaled(run, e):
        chunked = attn_mod.chunked_attention
        off = small.head_dim ** -0.5 * (1 + 2.0 ** -e)
        attn_mod.chunked_attention = lambda *a, **k: chunked(*a, **{**k, "scale": off})
        try:
            return run(pc)
        finally:
            attn_mod.chunked_attention = chunked

    what = ("prefill logits", "decode step from one cache")
    runs = {}
    for label, prompt in prompts.items():
        S = prompt.shape[1]
        T, pos, sizes = S + 8, torch.tensor([S]), np.array([S + 1], np.int32)
        _, shared = transformer.prefill(pcpu, small, {"inputs": prompt}, T)

        def cache(dev):
            return {"layers": {k: v.clone().to(dev) for k, v in shared["layers"].items()}}

        def card(params):
            logits, _ = transformer.prefill(params, small, {"inputs": prompt.cuda()}, T)
            dec, _ = transformer.serve_step(params, small, tok.cuda(), cache("cuda"),
                                            pos.cuda(), kv_group_sizes=sizes)
            return logits.cpu(), dec.cpu()

        def cpu():
            logits, _ = transformer.prefill(pcpu, small, {"inputs": prompt}, T)
            dec, _ = transformer.serve_step(pcpu, small, tok, cache("cpu"), pos,
                                            kv_group_sizes=sizes)
            return logits, dec

        got, frac = _flash_mismatch(lambda: card(pc))
        want = cpu()
        moves = []
        for trial in range(S8_TRIALS):
            with _flash_ulp_flips(frac, seed=SEED + trial):
                moves += [rel(a, b) for a, b in zip(cpu(), want)]
        lay = pc["layers"]
        wqkv = lay["attn"]["wqkv"].clone()
        wqkv[0, 0] = 0
        runs[label] = dict(
            got=got, want=want, frac=frac, moves=moves,
            controls={"wqkv row 0 of layer 0 zeroed": card(
                          {**pc, "layers": {**lay, "attn": {**lay["attn"], "wqkv": wqkv}}}),
                      "attention scale x (1 + 2^-6)": scaled(card, 6)})
        del wqkv
    floor = max(m for r in runs.values() for m in r["moves"])
    tol = max(S8_FACTOR * floor, 2.0 ** -10)
    print(f"[serve8] rounding floor of the cut {floor:.3e} of max (flash launches "
          f"differ from their plain versions in up to "
          f"{max(r['frac'] for r in runs.values()):.2e} of outputs; "
          f"{S8_TRIALS} draws x {len(runs)} prompts x 2 outputs); bound "
          f"{tol:.3e}", flush=True)
    out = {"floor": floor, "tol_rel": tol}
    for label, r in runs.items():
        errs = [_check(f"serve8 two-layer {w} ({label}), card vs CPU plain", g, c,
                       tol, log) for w, g, c in zip(what, r["got"], r["want"])]
        controls = {}
        for name, outs in r["controls"].items():
            for w, g, c in zip(what, outs, r["want"]):
                err = rel(g, c)
                ok = err > tol
                controls[f"{name}: {w}"] = err
                log.append({"check": f"serve8 control ({label}): {name}, {w} "
                                     "must fail the bound", "err_rel": err,
                            "tol_rel": tol, "ok": ok})
                print(f"[check] serve8 control ({label}): {name}, {w}: err "
                      f"{err:.3e} of max, bound {tol:.3e}: "
                      f"{'fails, as it must' if ok else 'PASSES: FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"serve8 control {name} ({w}) passes the bound")
        out[label] = {"mismatch_fraction": r["frac"], "moves": r["moves"],
                      "err_abs": dict(zip(what, errs)), "controls": controls}
    return out


def moe_kernel_checks(log, g):
    """Kernel 2 at the DeepSeek paths' shapes (deepseek-v2-lite-16b at full
    width, tpu_bf16), each launch against its plain version and run twice,
    bitwise equal: the grouped expert GEMM ``(B, 64, C, 2048) x (64, 2048,
    2816)`` at prefill (B 1, C 16), decode (B 4, C 8) and training (B 4, C
    32), the training shape's ``w_out`` and its backward — dX ("nt", the
    expert weights broadcast over B) and dW ("tn", one launch per expert
    over all B·C rows) with the "+grad" policy's fp32 output; MLA's
    q-chunked scores (qk dim 192, K through a transposed view, fp32 out)
    and PV (v dim 128) at the training shape; and the absorbed decode's
    five contractions (fp32 out) at B 4 against a 144-row cache, on the
    strided views ``einsum2d`` hands the kernel.  Then the engine's grouped
    GEMM with ``group_sizes`` masking one expert's rows, forward and
    gradients, against the same product in fp32 on the card.  Returns the
    rows to time.

    Tolerances: bf16 outputs two ulps (2^-7), fp32 outputs summation order
    (1e-4 of max)."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core import precision as prec
    from repro_torch.core.engine import _grad_policy, scores_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_matmul as rm

    dev = torch.device("cuda")
    bf = prec.TPU_BF16
    gbf, scores = _grad_policy(bf), scores_policy(bf)
    absorbed = prec.Policy("tpu_bf16_absorbed", torch.bfloat16, torch.float32,
                           torch.float32)
    tol_bf16, tol_f32 = 2.0 ** -7, 1e-4
    d, E, f, H, r, dn, dr, dv = 2048, 64, 1408, 16, 512, 128, 64, 128
    T = M_PROMPT + M_GEN

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    src = "src/repro_torch/csrc/redmule_matmul.cu"
    rep2 = "src/repro/kernels/redmule_matmul.py:478"
    k2 = (ops.redmule_matmul_batched, "launches")
    out = []

    def row(name, x, w, layout, pol, paths, bound_dims, shape):
        kern = (lambda: ops.redmule_matmul_batched(x, w, policy=pol, layout=layout))
        plain = (lambda: rm.redmule_matmul_plain(x, w, policy=pol, layout=layout))
        got = kern()
        _repeat(name, got, kern(), log)
        tol = tol_f32 if pol.out_dtype == torch.float32 else tol_bf16
        err = _check(f"{name} {shape}", got, plain(), tol, log)
        bsz, M, N, K, w_reads = bound_dims
        ob = pol.out_dtype.itemsize
        xl = x.transpose(-1, -2) if layout == "tn" else x
        wl = w.transpose(-1, -2) if layout == "nt" else w
        out.append(dict(
            name=name, group="redmule_gemm", counter=k2, paths=paths, source=src,
            replaces=rep2, shape=shape, err=err,
            bound=_bound_ms((bsz * M * N + w_reads * N * K) * 2 + bsz * M * K * ob,
                            2 * bsz * M * N * K),
            kernel=kern, plain=plain, library=lambda: torch.matmul(xl, wl)))

    w_in, w_out = rnd(E, d, 2 * f, scale=d ** -0.5), rnd(E, f, d, scale=f ** -0.5)
    for tag, B, C, paths in (("prefill", 1, 16, ("moeserve",)),
                             ("decode", M_BATCH, 8, ("moeserve",)),
                             ("train", MT_BATCH, 32, ("moetrain",))):
        row(f"redmule_matmul_batched (experts w_in, {tag})", rnd(B, E, C, d), w_in,
            "nn", bf, paths, (B * E, C, d, 2 * f, E),
            f"nn B={B}x{E} M={C} N={d} K={2 * f} bf16, W per expert")
    B, C = MT_BATCH, 32
    row("redmule_matmul_batched (experts w_out, train)", rnd(B, E, C, f), w_out,
        "nn", bf, ("moetrain",), (B * E, C, f, d, E),
        f"nn B={B}x{E} M={C} N={f} K={d} bf16, W per expert")
    dz = rnd(B, E, C, 2 * f, scale=1e-2)
    row("redmule_matmul_batched (experts w_in dX, train)", dz, w_in, "nt", gbf,
        ("moetrain",), (B * E, C, 2 * f, d, E),
        f"nt B={B}x{E} M={C} N={2 * f} K={d} bf16 -> fp32, W broadcast")
    xg, dzg = rnd(E, B * C, d), rnd(E, B * C, 2 * f, scale=1e-2)
    row("redmule_matmul_batched (experts w_in dW, train)", xg, dzg, "tn", gbf,
        ("moetrain",), (E, d, B * C, 2 * f, E),
        f"tn B={E} M={d} N={B * C} K={2 * f} bf16 -> fp32")
    # MLA at the training shape: B 4, 16 heads, S = T = 256
    S = MT_SEQ
    q, k = rnd(B, H, 1, S, dn + dr), rnd(B, H, S, dn + dr)
    kt = k.transpose(-1, -2)[:, :, None]
    row("redmule_matmul_batched (MLA q-chunked scores, train)", q, kt, "nn", scores,
        ("moetrain",), (B * H, S, dn + dr, S, B * H),
        f"nn B={B}x{H} M={S} N={dn + dr} K={S} bf16 -> fp32, K^T a view")
    p = torch.softmax(torch.randn(B, H, 1, S, S, generator=g, device=dev), -1).to(
        torch.bfloat16)
    row("redmule_matmul_batched (MLA q-chunked PV, train)", p, rnd(B, H, 1, S, dv),
        "nn", bf, ("moetrain",), (B * H, S, S, dv, B * H),
        f"nn B={B}x{H} M={S} N={S} K={dv} bf16")
    # the absorbed decode, B 4 against a T = 144 cache, as einsum2d lays
    # the operands out (the weights and the cache read through views)
    Bd = M_BATCH
    wuk = rnd(r, H * dn, scale=r ** -0.5).reshape(r, H, dn).permute(1, 2, 0)
    wuv = rnd(r, H * dv, scale=r ** -0.5).reshape(r, H, dv).permute(1, 0, 2)
    ckv, kr = rnd(Bd, T, r), rnd(Bd, T, dr)
    p_dec = torch.softmax(torch.randn(Bd, H, T, generator=g, device=dev), -1)
    for name, x, w, dims in (
            ("q_abs bhsd,rhd->bhsr", rnd(H, Bd, dn), wuk, (H, Bd, dn, r, H)),
            ("scores bhsr,btr->bhst", rnd(Bd, H, r), ckv.transpose(1, 2),
             (Bd, H, r, T, Bd)),
            ("rope scores bhsd,btd->bhst", rnd(Bd, H, dr), kr.transpose(1, 2),
             (Bd, H, dr, T, Bd)),
            ("ctx bhst,btr->bhsr", p_dec.to(torch.bfloat16), ckv, (Bd, H, T, r, Bd)),
            ("out bhsr,rhd->bhsd", rnd(H, Bd, r), wuv, (H, Bd, r, dv, H))):
        row(f"redmule_matmul_batched (MLA absorbed decode {name.split()[0]})", x, w,
            "nn", absorbed, ("moeserve",), dims,
            f"{name.split()[1]} nn B={dims[0]} M={dims[1]} N={dims[2]} K={dims[3]} "
            "bf16 -> fp32")

    # the engine's grouped GEMM with expert 0 holding 5 of its 32 rows:
    # rows past a group's size are zero and take no gradient
    x = rnd(B, E, C, f).requires_grad_(True)
    w = rnd(E, f, d, scale=f ** -0.5).requires_grad_(True)
    sizes = torch.full((E,), C, dtype=torch.int32)
    sizes[0] = 5
    dzo = rnd(B, E, C, d, scale=1e-2)
    z = engine.grouped_matmul(x, w, group_sizes=sizes, policy=bf)
    gx, gw = torch.autograd.grad(z, (x, w), dzo)
    valid = (torch.arange(C, device=dev)[None, :] < sizes.to(dev)[:, None])[..., None]
    want_z = torch.where(valid, x.detach().float() @ w.detach().float(), 0.0)
    dzm = torch.where(valid, dzo.float(), 0.0)
    want_gx = dzm @ w.detach().float().transpose(-1, -2)
    want_gw = (x.detach().float().transpose(-1, -2) @ dzm).sum(0)
    for name, a_, b_ in (("forward", z, want_z), ("dX", gx, want_gx),
                         ("dW", gw, want_gw)):
        _check(f"engine grouped_matmul with group_sizes (expert 0: 5 of {C} rows) "
               f"{name}, B={B}x{E} M={C} N={f} K={d}", a_, b_, tol_bf16, log)
    masked_zero = bool((gx[:, 0, 5:] == 0).all() and (z[:, 0, 5:] == 0).all())
    log.append({"check": "grouped_matmul: masked rows and their dX are zero",
                "ok": masked_zero})
    print(f"[check] grouped_matmul masked rows: "
          f"{'zero' if masked_zero else 'FAIL: not zero'}", flush=True)
    if not masked_zero:
        raise AssertionError("grouped_matmul: a masked row is not zero")
    torch.cuda.synchronize()
    return out


def _moe_structural(n_moe: int, *, prefills: int, decodes: int) -> dict:
    """deepseek-v2-lite-16b's kernel-1 / kernel-2 launches for ``prefills``
    batch-1 prefills and ``decodes`` decode steps with ``n_moe`` MoE layers
    after the dense layer 0.  A prefill: wq, wdkv, wuk, wuv, wo a layer,
    the dense GLU's two, the router and the shared experts' two a MoE
    layer, the LM head (kernel 1); the q-chunked scores and PV a layer,
    the two grouped expert GEMMs and the combine a MoE layer (kernel 2).
    A decode step: wq, wdkv, wo a layer (kernel 1, with the same FFN
    launches and the head) and the five absorbed contractions (kernel 2)."""
    pre1, pre2 = (5 + 2) + 8 * n_moe + 1, 2 + 5 * n_moe
    dec1, dec2 = (3 + 2) + 6 * n_moe + 1, 5 + 8 * n_moe
    return {"redmule_matmul": prefills * pre1 + decodes * dec1,
            "redmule_matmul_batched": prefills * pre2 + decodes * dec2,
            "flash_attention": 0}


def _no_library_gemm(prof: dict, what: str) -> None:
    """A profiled window of the port must call no aten GEMM or SDPA op."""
    if prof["aten_gemm"]:
        raise AssertionError(f"{what}: library GEMM / attention ops in the "
                             f"profile: {prof['aten_gemm']}")


def _print_profile(what: str, prof: dict) -> None:
    parts = ", ".join(f"{k} {g['ms']:.3f} ms x{g['count']}"
                      for k, g in sorted(prof["by_kernel"].items()))
    split = "".join(f"; {k} {v:.3f} ms" for k, v in prof.get("split", {}).items())
    print(f"[profile] {what}: wall {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['device_ms']:.3f} ms (idle {prof['idle_share']:.3f}){split}: "
          f"{parts}; aten GEMM / SDPA ops {prof['aten_gemm'] or 'none'}", flush=True)


def _k2_profile(fn, iters: int, k2_launches: int, attempts: int = 3) -> dict:
    """``_device_profile`` of ``fn`` inside :func:`_k2_ranged`, with the
    GEMM time split: kernels 1 and 2 are one CUDA kernel (on either
    route), so the ``kernel2`` ranges attribute kernel 2's share; the
    sweep's kernels are kernel 4.  The ranges (their host-side records)
    must number kernel 2's structural launches a call — every kernel-2
    dispatch ran inside one; a window that counts otherwise is taken
    again, up to ``attempts`` windows in all; then it raises."""
    for attempt in range(attempts):
        with _k2_ranged():
            prof = _device_profile(fn, iters=iters, ranges=("kernel2",))
        rng = prof["ranges"]["kernel2"]
        if round(rng["count"] * iters) == k2_launches * iters:
            by = prof["by_kernel"]
            gemm_groups = ("redmule_gemm", "redmule_gemm_f32")
            gemm = sum(by[k]["ms"] for k in gemm_groups if k in by)
            prof["split"] = {"gemm (kernel 1)": gemm - rng["ms"],
                             "batched (kernel 2)": rng["ms"]}
            if "chunked_linear_attention" in by:
                prof["split"]["sweep (kernel 4)"] = by["chunked_linear_attention"]["ms"]
            prof["split"]["other"] = sum(
                g["ms"] for k, g in by.items()
                if k not in gemm_groups + ("chunked_linear_attention",))
            return prof
        print(f"[profile] {rng['count']} kernel-2 ranges a call, not {k2_launches} "
              f"(window {attempt + 1} of {attempts})", flush=True)
    raise AssertionError(f"profile: kernel-2 ranges never matched {k2_launches}")


def moeserve_phase(log, counters):
    """deepseek-v2-lite-16b at full width and depth (27 layers, 64 routed
    experts, MLA) through ``repro_torch.launch.serve``: 4 requests, prompt
    128, 16 new tokens, with the counts set to 0 just before and held to
    the structural ones after; tokens in range.  Then one prefill and one
    decode step timed with CUDA events and profiled (busy / idle share,
    kernel 1 / kernel 2 / other split, no aten GEMM or SDPA op), with the
    peak memory."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = configs.get(M_ARCH)
    n_moe = cfg.n_layers - 1
    want = _moe_structural(n_moe, prefills=M_BATCH, decodes=M_GEN)
    print(f"[moeserve] predicted launches {want}", flush=True)
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seqs = serve.main(["--arch", M_ARCH, "--full", "--batch", str(M_BATCH),
                       "--prompt-len", str(M_PROMPT), "--gen", str(M_GEN),
                       "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    peak_main = torch.cuda.max_memory_allocated()
    print(f"[moeserve] launches on the main path: {launches}", flush=True)
    if seqs.shape != (M_BATCH, M_PROMPT + M_GEN) or not (
            (seqs >= 0) & (seqs < cfg.vocab_size)).all():
        raise AssertionError(f"moeserve: generate returned {seqs.shape} / tokens "
                             "out of range")
    got = {k: launches[k] for k in want}
    print(f"[moeserve] launches {got}, structural {want}", flush=True)
    if got != want:
        raise AssertionError("moeserve: launches differ from the structural count")

    params = transformer.init_params(cfg, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    T = M_PROMPT + M_GEN
    prompt = torch.randint(0, cfg.vocab_size, (1, M_PROMPT), generator=gen,
                           device="cuda")
    logits, _ = transformer.prefill(params, cfg, {"inputs": prompt}, T)
    prefill_ms = _time_ms(lambda: transformer.prefill(
        params, cfg, {"inputs": prompt}, T), iters=5, warmup=1)
    cache = transformer.init_cache(cfg, M_BATCH, T, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (M_BATCH, 1), generator=gen,
                         device="cuda")
    pos = torch.full((M_BATCH,), M_PROMPT, device="cuda")
    sizes = np.full((M_BATCH,), M_PROMPT + 1, np.int32)

    def decode():
        return transformer.serve_step(params, cfg, toks, cache, pos,
                                      kv_group_sizes=sizes)

    dec_logits, _ = decode()
    decode_ms = _time_ms(decode, iters=10, warmup=2)
    for name, t in (("prefill", logits), ("decode", dec_logits)):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"moeserve: {name} logits are not finite")
    print(f"[moeserve] generate {M_BATCH}x({M_PROMPT}+{M_GEN}) {wall:.3f}s wall; "
          f"prefill(1x{M_PROMPT}) {prefill_ms:.3f} ms; decode step (B={M_BATCH}) "
          f"{decode_ms:.3f} ms; peak {peak_main / 2**30:.2f} GiB", flush=True)
    one_pre = _moe_structural(n_moe, prefills=1, decodes=0)
    one_dec = _moe_structural(n_moe, prefills=0, decodes=1)
    profiles = {
        "prefill": _k2_profile(lambda: transformer.prefill(
            params, cfg, {"inputs": prompt}, T), 1, one_pre["redmule_matmul_batched"]),
        "decode_step": _k2_profile(decode, 2, one_dec["redmule_matmul_batched"])}
    for name, prof in profiles.items():
        _print_profile(f"moeserve {name}", prof)
        _no_library_gemm(prof, f"moeserve {name}")
    del params, cache
    torch.cuda.empty_cache()
    return {"serve_wall_s": wall, "prefill_ms": prefill_ms,
            "decode_step_ms": decode_ms, "launches": launches, "structural": want,
            "peak_mem_gib": peak_main / 2**30, "profiles": profiles}


def _router_capture():
    """``(context, logits)``: within the context every router GEMM's output
    (the fp32 logits, by its policy's name) is appended to ``logits`` — the
    "hopper" backend wrapped through the engine's registry, so card and CPU
    runs route exactly as the path does."""
    got = []

    def capture(fn, x, w, **kw):
        z = fn(x, w, **kw)
        if kw["spec"].policy.name == "router":
            got.append(z.float().cpu())
        return z

    return _hopper_wrapped(gemm=capture), got


def _moe_cut_run(params, c, toks, tok, dev):
    """Logits of every prompt token, then of one decode step (per-slot
    positions, as the scheduler runs it) from the prefill's cache, with the
    router logits of both; on ``dev``."""
    import numpy as np
    import torch

    from repro_torch.models import transformer

    B, S = toks.shape
    ctx, routers = _router_capture()
    with ctx, torch.inference_mode():
        cache = transformer.init_cache(c, B, S + 8, device=dev)
        pre, cache, _ = transformer.forward(params, c, {"inputs": toks.to(dev)},
                                            cache=cache, pos=0)
        dec, _ = transformer.serve_step(
            params, c, tok.to(dev), cache, torch.full((B,), S, device=dev),
            kv_group_sizes=np.full((B,), S + 1, np.int32))
    logits = torch.cat([pre.float().cpu(), dec.float().cpu()[:, None]], dim=1)
    return logits, torch.cat(routers, dim=1)        # (B, S + 1, V), (B, S + 1, E)


def _moe_kept(ids, c):
    """``(B, S + 1, k)``: whether each routed slot of the tokens (their
    sorted top-k ids) keeps a place within its expert's capacity — the
    prompt dispatched as one prefill, the last token as its own decode
    step, as ``_moe_cut_run`` runs them (``moe._dispatch``'s rule)."""
    import torch

    from repro_torch.models import moe

    E, k = c.moe.n_routed, c.moe.top_k
    out = []
    for part in (ids[:, :-1], ids[:, -1:]):
        B, S, _ = part.shape
        C = moe.capacity(S, k, E, c.moe.capacity_factor)
        _, dest = moe._dispatch(torch.zeros(B, S, 1), part, E=E, k=k, C=C,
                                dtype=torch.float32)
        out.append((dest < E * C).reshape(B, S, k))
    return torch.cat(out, 1)


def moe_cuts(log):
    """A two-layer full-width cut (dense layer 0 + one MoE layer, random
    weights from a seed made on the card and copied to the CPU) of each
    DeepSeek config: every logit of a 2 x 16 prompt and of one decode step
    from the prefill's cache, card vs the CPU plain path.

    Routing is discrete: where a token's k-th and (k+1)-th router logits
    nearly tie, the card's and the CPU's rounding may pick different
    experts and move the token by O(1).  So: (1) the flipped tokens are
    counted; (2) each must lie on a tie — a gap between its k-th and
    (k+1)-th router logit (on the CPU) of at most twice the run's measured
    router-logit error (the largest |card - CPU| of any router logit);
    (3) capacity: a flip moves one slot between two experts of its batch
    row, and where one of them holds more than its C slots that drops (or
    keeps) another token's slot there on one side only — such a token is
    counted too, and each must lose or gain only slots of experts a flip
    of its row moved; (4) the tokens whose routing and slots agree are
    held to the larger of 8x the CPU's own spread (1 thread vs all: another
    summation order), measured in this run, and the repo's two-layer bf16
    bound 2^-4 of max; (5) a control must fail that bound: the card run
    again with the w_out of two experts swapped (the one most used by the
    held tokens and one they do not use)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import moe, transformer

    out = {}
    gen = torch.Generator().manual_seed(SEED + 8)
    n_threads = torch.get_num_threads()
    for arch in MOE_ARCHS:
        c = dataclasses.replace(configs.get(arch), n_layers=2)
        k = c.moe.top_k
        pc = transformer.init_params(c, seed=SEED + 9, device="cuda")
        pcpu = _to_cpu(pc)
        toks = torch.randint(0, c.vocab_size, (MC_BATCH, MC_PROMPT), generator=gen)
        tok = torch.randint(0, c.vocab_size, (MC_BATCH, 1), generator=gen)
        got, r_card = _moe_cut_run(pc, c, toks, tok, "cuda")
        want, r_cpu = _moe_cut_run(pcpu, c, toks, tok, "cpu")
        torch.set_num_threads(1)
        try:
            want_1t, _ = _moe_cut_run(pcpu, c, toks, tok, "cpu")
        finally:
            torch.set_num_threads(n_threads)
        ids_card = torch.sort(moe.top_k(r_card, k)[1], -1).values
        top_cpu = torch.sort(r_cpu, dim=-1, descending=True, stable=True)
        ids_cpu = torch.sort(top_cpu.indices[..., :k], -1).values
        flipped = (ids_card != ids_cpu).any(-1)                  # (B, S + 1)
        delta = (r_card - r_cpu).abs().max().item()
        gap = top_cpu.values[..., k - 1] - top_cpu.values[..., k]
        unexplained = flipped & (gap > 2 * delta)
        kept_card, kept_cpu = _moe_kept(ids_card, c), _moe_kept(ids_cpu, c)
        cascaded = ~flipped & (kept_card != kept_cpu).any(-1)
        for b, t in cascaded.nonzero().tolist():
            moved = set()
            for tf in flipped[b].nonzero().flatten().tolist():
                moved |= set(ids_card[b, tf].tolist()) ^ set(ids_cpu[b, tf].tolist())
            lost = set(ids_cpu[b, t][kept_card[b, t] != kept_cpu[b, t]].tolist())
            unexplained[b, t] = not lost <= moved
        scale = want.abs().max().item()
        agree = ~flipped & ~cascaded
        err = ((got - want).abs().amax(-1) / scale)[agree].max().item()
        spread = ((want_1t - want).abs().amax(-1) / scale)[agree].max().item()
        tol = max(8 * spread, 2.0 ** -4)
        # the control: swap the held tokens' most used expert with one they
        # do not use, in the card's MoE layer
        used = torch.bincount(ids_cpu[agree].reshape(-1), minlength=c.moe.n_routed)
        e1, e2 = int(used.argmax()), int(used.argmin())
        w_out = pc["layers"]["moe"]["w_out"][0]
        w_out[[e1, e2]] = w_out[[e2, e1]].clone()
        ctl, _ = _moe_cut_run(pc, c, toks, tok, "cuda")
        ctl_err = ((ctl - want).abs().amax(-1) / scale)[agree].max().item()
        row = {"tokens": int(flipped.numel()), "flipped": int(flipped.sum()),
               "capacity_moved": int(cascaded.sum()),
               "unexplained_flips": int(unexplained.sum()), "router_err": delta,
               "flip_gaps": gap[flipped].tolist(), "err_rel": err,
               "cpu_spread": spread, "tol_rel": tol, "control_err_rel": ctl_err,
               "control_experts": [e1, e2]}
        out[arch] = row
        log.append({"check": f"moecut {arch}", **row,
                    "ok": not unexplained.any() and err <= tol and ctl_err > tol})
        print(f"[moecut] {arch} two-layer (d 2048, {MC_BATCH}x{MC_PROMPT} + 1 "
              f"decode step): {row['flipped']} of {row['tokens']} tokens routed "
              f"differently (gaps {[f'{x:.2e}' for x in row['flip_gaps']]}, "
              f"router-logit error {delta:.3e}), {row['capacity_moved']} more "
              f"with a slot kept on one side only (capacity), "
              f"{row['unexplained_flips']} unexplained (off a tie, or a slot no "
              f"flip moved); agreeing tokens err {err:.3e} of max, tol {tol:.3e} "
              f"(CPU spread {spread:.3e}); control (experts {e1}<->{e2} "
              f"swapped) {ctl_err:.3e}", flush=True)
        if unexplained.any():
            raise AssertionError(f"moecut {arch}: a routing flip off a tie, or a "
                                 "capacity drop no flip explains")
        if not err <= tol:
            raise AssertionError(f"moecut {arch}: card vs CPU plain {err} > {tol}")
        if not ctl_err > tol:
            raise AssertionError(f"moecut {arch}: the control passed the bound")
        del pc, pcpu, w_out
        torch.cuda.empty_cache()
    return out


def moetrain_phase(log, counters):
    """deepseek-v2-lite-16b trained through ``repro_torch.launch.train`` at
    full width, depth cut to 3 (dense layer 0 + two MoE layers), batch 4 x
    seq 256, 3 steps: losses and router metrics finite, kernel-1 / kernel-2
    launches equal to the structural counts (forward, the MoE layers' remat
    recompute, dX and dW of every forward GEMM); one profiled step (busy /
    idle share, the kernel 1 / kernel 2 / other split, no aten GEMM or SDPA
    op, peak memory)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(configs.get(M_ARCH), n_layers=MT_LAYERS)
    n_moe = MT_LAYERS - 1
    # a step's forward: the layer-0 block 7 (kernel 1) + 2 (kernel 2), each
    # MoE layer 8 + 5, the head 1; the MoE layers again in the recompute;
    # each forward GEMM's dX and dW
    fwd1, fwd2 = 7 + 8 * n_moe + 1, 2 + 5 * n_moe
    per_step = {"redmule_matmul": 3 * fwd1 + 8 * n_moe,
                "redmule_matmul_batched": 3 * fwd2 + 5 * n_moe, "flash_attention": 0}
    want = {k: MT_STEPS * v for k, v in per_step.items()}
    print(f"[moetrain] predicted launches {want} ({MT_STEPS} steps x {per_step})",
          flush=True)
    argv = ["--arch", M_ARCH, "--full", "--layers", str(MT_LAYERS), "--batch",
            str(MT_BATCH), "--seq", str(MT_SEQ), "--seed", str(SEED),
            "--device", "cuda"]
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.main(argv + ["--steps", str(MT_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    peak_main = torch.cuda.max_memory_allocated()
    print(f"[moetrain] launches on the main path: {launches}", flush=True)
    hist = out["history"]
    keys = ("loss", "grad_norm", "moe_aux_loss", "moe_z_loss", "moe_drop_frac")
    if len(hist) != MT_STEPS or not all(math.isfinite(h[k]) for h in hist for k in keys):
        raise AssertionError(f"moetrain: non-finite or missing steps: {hist}")
    for h in hist:
        print(f"[moetrain] step {h['step']}: " + " ".join(
            f"{k} {h[k]:.4f}" for k in keys) + f" step {h['step_ms']:.1f} ms",
            flush=True)
    got = {k: launches[k] for k in want}
    print(f"[moetrain] launches {got}, structural {want}", flush=True)
    if got != want:
        raise AssertionError("moetrain: launches differ from the structural count")

    opt = AdamW(lr=3e-3, warmup_steps=10)
    step = train.build_train_step(cfg, opt)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=MT_SEQ,
                     global_batch=MT_BATCH, seed=SEED)
    holder = [train.init_state(cfg, opt, seed=SEED, device="cuda")]
    holder[0], _ = step(holder[0], ds.batch(0))

    def one_step():
        holder[0], m = step(holder[0], ds.batch(1))
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = _k2_profile(one_step, 1, per_step["redmule_matmul_batched"])
    peak_step = torch.cuda.max_memory_allocated()
    del holder, step
    torch.cuda.empty_cache()
    _print_profile("moetrain step", prof)
    print(f"[moetrain] peak {peak_step / 2**30:.2f} GiB (profiled step), "
          f"{peak_main / 2**30:.2f} GiB (the entry point's run)", flush=True)
    _no_library_gemm(prof, "moetrain step")
    return {"train_wall_s": wall, "history": hist, "launches": launches,
            "structural": want, "peak_mem_main_gib": peak_main / 2**30,
            "peak_mem_step_gib": peak_step / 2**30, "profile": prof,
            "params": out["params"]}


def _xlstm_structural(cfg, prompt: int) -> tuple:
    """xlstm-1.3b's launches a prefill of ``prompt`` tokens and a decode
    step.  An mLSTM block: w_up, the fp32 gates w_if and w_down (kernel 1),
    the per-head w_qkv (kernel 2), and the sweep (kernel 4) in a prefill or
    the state readout ``bhk,bhkv->bhv`` (kernel 2) in a decode step; an
    sLSTM block: w_gates and the FFN's two (kernel 1) and one recurrent
    ``bhd,hde->bhe`` a token (kernel 2); the LM head (kernel 1)."""
    n_super = cfg.n_layers // cfg.ssm.slstm_period
    n_m = cfg.ssm.slstm_period - 1
    k1 = n_super * (3 * n_m + 3) + 1
    pre = {"redmule_matmul": k1, "redmule_matmul_batched": n_super * (n_m + prompt),
           "flash_attention": 0, "chunked_linear_attention": n_super * n_m}
    dec = {"redmule_matmul": k1, "redmule_matmul_batched": n_super * (2 * n_m + 1),
           "flash_attention": 0, "chunked_linear_attention": 0}
    return pre, dec


def _hymba_structural(cfg, prompt: int) -> tuple:
    """hymba-1.5b's launches a prefill of ``prompt`` tokens and a decode
    step.  A layer: wqkv, wo, w_xz, the fp32 w_bcdt, w_out and the GLU's two
    (kernel 1); the windowed q-chunked attention's scores and PV a chunk of
    ``q_chunk`` query rows (kernel 2, no flash: every layer has a window);
    the sweep (kernel 4) in a prefill, the state readout (kernel 2) in a
    decode step; the LM head (kernel 1)."""
    L = cfg.n_layers
    k1 = 7 * L + 1
    pre = {"redmule_matmul": k1,
           "redmule_matmul_batched": 2 * -(-prompt // cfg.q_chunk) * L,
           "flash_attention": 0, "chunked_linear_attention": L}
    dec = {"redmule_matmul": k1, "redmule_matmul_batched": 3 * L,
           "flash_attention": 0, "chunked_linear_attention": 0}
    return pre, dec


def _recurrent_serve(log, counters, arch: str, tag: str, batch: int, prompt: int,
                     gen: int, structural) -> dict:
    """``arch`` at full width and depth through ``transformer.prefill`` and a
    greedy loop of ``gen`` ``serve_step``s (the scheduler refuses recurrent
    kinds, as the reference's does), with the counts set to 0 just before
    and held to the structural ones after; tokens in range, logits finite.
    Then one prefill and one decode step timed with CUDA events and
    profiled (kernel 1 / 2 / 4 / other, no aten GEMM or SDPA op), with the
    peak memory of the run."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get(arch)
    pre, dec = structural(cfg, prompt)
    want = {k: pre[k] + gen * dec[k] for k in pre}
    print(f"[{tag}] predicted launches {want} (prefill {pre}, decode step {dec})",
          flush=True)
    params = transformer.init_params(cfg, seed=SEED, device="cuda")
    rng = torch.Generator(device="cuda").manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=rng,
                         device="cuda")
    T = prompt + gen
    torch.cuda.synchronize()
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(params, cfg, {"inputs": toks}, T)
    out = [logits.argmax(-1)]
    for i in range(gen):
        logits, cache = transformer.serve_step(params, cfg, out[-1][:, None], cache,
                                               prompt + i)
        out.append(logits.argmax(-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated()
    seqs = torch.stack(out, 1)
    print(f"[{tag}] launches on the main path: {launches}", flush=True)
    if not torch.isfinite(logits.float()).all() or not (
            (seqs >= 0) & (seqs < cfg.vocab_size)).all():
        raise AssertionError(f"{tag}: non-finite logits or tokens out of range")
    got = {k: launches[k] for k in want}
    print(f"[{tag}] launches {got}, structural {want}", flush=True)
    if got != want:
        raise AssertionError(f"{tag}: launches differ from the structural count")

    prefill_ms = _time_ms(lambda: transformer.prefill(params, cfg, {"inputs": toks}, T),
                          iters=3, warmup=1)
    tok = seqs[:, -1:]

    def decode():
        return transformer.serve_step(params, cfg, tok, cache, prompt)

    decode_ms = _time_ms(decode, iters=10, warmup=2)
    cache_gib = sum(t.numel() * t.element_size() for t in _tensors(cache)) / 2**30
    print(f"[{tag}] prefill {batch}x{prompt} + {gen} decode steps {wall:.3f} s wall; "
          f"prefill {prefill_ms:.3f} ms; decode step (B={batch}) {decode_ms:.3f} ms; "
          f"peak {peak / 2**30:.2f} GiB (cache {cache_gib:.2f} GiB)", flush=True)
    # one prefill a window: xlstm's is ~22k kernels (the sLSTM time loop),
    # and a window of two lost one kernel-2 record in each of three tries
    profiles = {
        "prefill": _k2_profile(lambda: transformer.prefill(
            params, cfg, {"inputs": toks}, T), 1, pre["redmule_matmul_batched"]),
        "decode_step": _k2_profile(decode, 2, dec["redmule_matmul_batched"])}
    for name, prof in profiles.items():
        _print_profile(f"{tag} {name}", prof)
        _no_library_gemm(prof, f"{tag} {name}")
    del params, cache
    torch.cuda.empty_cache()
    return {"wall_s": wall, "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
            "launches": launches, "structural": want, "peak_mem_gib": peak / 2**30,
            "cache_gib": cache_gib, "profiles": profiles}


def _tensors(tree):
    if hasattr(tree, "numel"):
        return [tree]
    return [t for v in tree.values() for t in _tensors(v)]


def ssmserve_phase(log, counters):
    """xlstm-1.3b served from its decode state at full width and depth (48
    blocks): prefill 4 x 128 (42 sweeps, kernel 4), 16 greedy decode steps
    (no sweep: the state readout on kernel 2's fp32 route)."""
    return _recurrent_serve(log, counters, T_ARCH, "ssmserve", X_BATCH, X_PROMPT,
                            X_GEN, _xlstm_structural)


def hymbaserve_phase(log, counters):
    """hymba-1.5b served at full width and depth (32 layers): prefill 4 x
    1152 (the 1024 window masks on the 29 sliding layers, the prompt crosses
    q_chunk 1024; 32 sweeps on kernel 4 with fp32 q / k and bf16 v), 16
    greedy decode steps (the windowed attention on kernel 2, no flash)."""
    return _recurrent_serve(log, counters, H_ARCH, "hymbaserve", H_BATCH, H_PROMPT,
                            H_GEN, _hymba_structural)


def hymbatrain_phase(log, counters):
    """hymba-1.5b trained through ``repro_torch.launch.train`` at full width
    and depth, 4 x 256, 3 steps: losses finite, kernel 4 launched once a
    layer in the forward and once more in its remat recompute (64 a step),
    no flash; one profiled step (busy / idle share, kernel 1 / 2 / 4 /
    other, no aten GEMM or SDPA op) and its peak memory."""
    import torch

    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.optim import AdamW

    cfg = configs.get(H_ARCH)
    per_step_k4 = cfg.n_layers * (2 if cfg.remat == "full" else 1)
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.main(["--arch", H_ARCH, "--full", "--batch", str(HT_BATCH), "--seq",
                      str(HT_SEQ), "--steps", str(HT_STEPS), "--seed", str(SEED),
                      "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    peak_main = torch.cuda.max_memory_allocated()
    print(f"[hymbatrain] launches on the main path: {launches}", flush=True)
    hist = out["history"]
    if len(hist) != HT_STEPS or not all(math.isfinite(h["loss"])
                                        and math.isfinite(h["grad_norm"]) for h in hist):
        raise AssertionError(f"hymbatrain: non-finite or missing steps: {hist}")
    for h in hist:
        print(f"[hymbatrain] step {h['step']}: loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f} step {h['step_ms']:.1f} ms", flush=True)
    want_k4 = HT_STEPS * per_step_k4
    print(f"[hymbatrain] sweep launches {launches['chunked_linear_attention']}, "
          f"structural {want_k4} ({HT_STEPS} steps x {cfg.n_layers} layers x 2 for "
          f"remat); flash launches {launches['flash_attention']}", flush=True)
    if launches["chunked_linear_attention"] != want_k4 or launches["flash_attention"]:
        raise AssertionError("hymbatrain: sweep / flash launches differ from the "
                             "structural count")
    _require(launches, ("redmule_matmul", "redmule_matmul_batched",
                        "redmule_matmul (fp32 route)",
                        "redmule_matmul_batched (fp32 route)"), "hymbatrain")
    k2_step, rem = divmod(launches["redmule_matmul_batched"], HT_STEPS)
    if rem:
        raise AssertionError("hymbatrain: kernel-2 launches differ between steps")

    opt = AdamW(lr=3e-3, warmup_steps=10)
    step = train.build_train_step(cfg, opt)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=HT_SEQ,
                     global_batch=HT_BATCH, seed=SEED)
    holder = [train.init_state(cfg, opt, seed=SEED, device="cuda")]
    holder[0], _ = step(holder[0], ds.batch(0))

    def one_step():
        holder[0], m = step(holder[0], ds.batch(1))
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = _k2_profile(one_step, 1, k2_step)
    peak_step = torch.cuda.max_memory_allocated()
    del holder, step
    torch.cuda.empty_cache()
    _print_profile("hymbatrain step", prof)
    print(f"[hymbatrain] peak {peak_step / 2**30:.2f} GiB (profiled step), "
          f"{peak_main / 2**30:.2f} GiB (the entry point's run)", flush=True)
    _no_library_gemm(prof, "hymbatrain step")
    return {"train_wall_s": wall, "history": hist, "launches": launches,
            "k2_per_step": k2_step, "peak_mem_main_gib": peak_main / 2**30,
            "peak_mem_step_gib": peak_step / 2**30, "profile": prof,
            "params": out["params"]}


def _cut_run(params, c, toks, nxt, dev, fault=None) -> dict:
    """A fresh prefill's last-token logits and ``nxt.shape[1]`` decode
    steps' logits from its cache, then every cache leaf (per layer for the
    stacked leaves), as fp32 CPU tensors; on ``dev``.  ``fault(cache)``, if
    given, edits the cache between the prefill and the decode steps."""
    import torch

    from repro_torch.models import transformer

    B, S = toks.shape
    with torch.inference_mode():
        cache = transformer.init_cache(c, B, S + nxt.shape[1], device=dev)
        pre, cache, _ = transformer.forward(params, c, {"inputs": toks.to(dev)},
                                            cache=cache, pos=0, last_only=True)
        if fault is not None:
            fault(cache)
        logits = [pre[:, -1].float().cpu()]
        for i in range(nxt.shape[1]):
            lg, cache = transformer.serve_step(params, c, nxt[:, i:i + 1].to(dev),
                                               cache, S + i)
            logits.append(lg.float().cpu())
    out = {"logits": torch.stack(logits, 1)}

    def walk(tree, path):
        if hasattr(tree, "numel"):
            for i, t in enumerate(tree.unbind(0)):      # the stacked layer dim
                out[f"{path} [{i}]"] = t.float().cpu()
            return
        for k, v in tree.items():
            walk(v, f"{path}/{k}" if path else k)

    walk(cache["layers"], "cache")
    return out


def _cut_compare(got, want, want_1t, floor) -> dict:
    """Each item's largest |card - CPU| over its max, against the larger of
    8x the CPU's own spread (1 thread vs all) and ``floor``."""
    rows = {}
    for key, w in want.items():
        scale = max(w.abs().max().item(), 1e-30)
        err = (got[key] - w).abs().max().item() / scale
        spread = (want_1t[key] - w).abs().max().item() / scale
        rows[key] = {"err_rel": err, "spread": spread,
                     "tol_rel": max(8 * spread, floor)}
    return rows


def _zero_mlstm_slot(cache) -> None:
    """The xLSTM cut's control: the first mLSTM block's state in the cache
    set to zero after the prefill, as a lost state write-back would leave
    it."""
    cache["layers"]["mlstm"][0, 0].zero_()


def ssm_cuts(log):
    """Card vs the CPU plain path at full width: a two-layer cut of
    hymba-1.5b (full-attention layer 0, sliding layer 1) on a 2 x 1088
    prompt (the 1024 window masks in layer 1; the prompt crosses q_chunk)
    with 2 decode steps from its cache, and one super-block of xlstm-1.3b
    (7 mLSTM + 1 sLSTM) on 2 x 128 with 2 decode steps, under its serving
    policy (tpu_bf16) and under fp32.  The last prompt token's logits, each
    decode step's and every cache leaf of every layer are held to the
    larger of 8x the CPU's own spread (1 thread vs all, measured in this
    run) and a floor: 2^-4 of max under tpu_bf16, as the MoE cuts are, and
    one fp32 rounding's worth (1e-5) under fp32.  Two controls must fail
    that bound: the hymba cut run again on the card with layer 1's a_log
    raised by ``HC_CONTROL`` (its SSD decay off by a factor exp(HC_CONTROL)
    in the exponent), and the fp32 xLSTM cut with the first mLSTM block's
    cached state zeroed between the prefill and the decode steps (under
    tpu_bf16 the CPU's spread reaches 0.03-0.07 of max, so that cut's
    bound is 0.23-0.55 of max and the fp32 cut is the one that can see a
    cache fault)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import transformer

    out = {}
    gen = torch.Generator().manual_seed(SEED + 10)
    n_threads = torch.get_num_threads()
    x_cfg = configs.get(T_ARCH)
    cuts = ((H_ARCH, None, 2, HC_BATCH, HC_PROMPT),
            (T_ARCH, None, x_cfg.ssm.slstm_period, XC_BATCH, XC_PROMPT),
            (T_ARCH, "fp32", x_cfg.ssm.slstm_period, XC_BATCH, XC_PROMPT))
    xlstm_toks = None
    for arch, policy, n_layers, B, S in cuts:
        c = dataclasses.replace(configs.get(arch), n_layers=n_layers)
        if policy is not None:
            c = dataclasses.replace(c, policy_name=policy)
        tag = f"{arch} {c.policy_name}"
        pc = transformer.init_params(c, seed=SEED + 10, device="cuda")
        pcpu = _to_cpu(pc)
        if arch == T_ARCH and xlstm_toks is not None:
            toks, nxt = xlstm_toks          # both policies on the same tokens
        else:
            toks = torch.randint(0, c.vocab_size, (B, S), generator=gen)
            nxt = torch.randint(0, c.vocab_size, (B, C_GEN), generator=gen)
            if arch == T_ARCH:
                xlstm_toks = toks, nxt
        t0 = time.perf_counter()
        got = _cut_run(pc, c, toks, nxt, "cuda")
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = _cut_run(pcpu, c, toks, nxt, "cpu")
        t_cpu = time.perf_counter() - t0
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        try:
            want_1t = _cut_run(pcpu, c, toks, nxt, "cpu")
        finally:
            torch.set_num_threads(n_threads)
        t_cpu1 = time.perf_counter() - t0
        floor = 1e-5 if c.policy_name == "fp32" else 2.0 ** -4
        rows = _cut_compare(got, want, want_1t, floor)
        bad = [k for k, r in rows.items() if not r["err_rel"] <= r["tol_rel"]]
        row = {"items": rows, "card_s": t_card, "cpu_s": t_cpu, "cpu_1thread_s": t_cpu1}
        worst = max(rows, key=lambda k: rows[k]["err_rel"] / rows[k]["tol_rel"])
        print(f"[ssmcut] {tag} {n_layers} layers at full width, {B}x{S} + {C_GEN} "
              f"decode steps: card {t_card:.1f} s, CPU {t_cpu:.1f} s ({n_threads} "
              f"threads), {t_cpu1:.1f} s (1 thread); worst {worst}: err "
              f"{rows[worst]['err_rel']:.3e} of max, tol {rows[worst]['tol_rel']:.3e} "
              f"(CPU spread {rows[worst]['spread']:.3e})", flush=True)
        for k, r in rows.items():
            print(f"[ssmcut] {tag} {k}: err {r['err_rel']:.3e} spread "
                  f"{r['spread']:.3e} tol {r['tol_rel']:.3e}", flush=True)
        control = None
        if arch == H_ARCH:
            control = f"layer 1 a_log + {HC_CONTROL}"
            pc["layers"]["mamba"]["a_log"][1] += HC_CONTROL
            ctl = _cut_run(pc, c, toks, nxt, "cuda")
        elif policy == "fp32":
            control = "first mLSTM state zeroed after the prefill"
            ctl = _cut_run(pc, c, toks, nxt, "cuda", fault=_zero_mlstm_slot)
        if control is not None:
            ctl_rows = _cut_compare(ctl, want, want_1t, floor)
            failing = [k for k, r in ctl_rows.items() if r["err_rel"] > rows[k]["tol_rel"]]
            row["control"] = control
            row["control_failing"] = {k: ctl_rows[k]["err_rel"] for k in failing}
            print(f"[ssmcut] {tag} control ({control}): fails the bound on "
                  f"{len(failing)} items: "
                  + ", ".join(f"{k} {ctl_rows[k]['err_rel']:.3e}" for k in failing),
                  flush=True)
        out[tag] = row
        ok = not bad and (control is None or bool(row["control_failing"]))
        log.append({"check": f"ssmcut {tag}", "ok": ok, "failed_items": bad,
                    "control_failing": row.get("control_failing")})
        if bad:
            raise AssertionError(f"ssmcut {tag}: card vs CPU plain beyond the bound "
                                 f"on {bad}")
        if control is not None and not row["control_failing"]:
            raise AssertionError(f"ssmcut {tag}: the control passed the bound")
        del pc, pcpu
        torch.cuda.empty_cache()
    return out


def _sched_structural(sched) -> dict:
    """yi-9b's kernel launches for one drained scheduler, from its trace:
    a batch-1 prefill (an admission, or a recovery's re-prefill) runs the
    4 projections of each layer and the head on kernel 1 and flash once a
    layer; a decode step (batched, or one a recovery replays:
    ``recovery_decode_steps``) the same kernel-1 launches and the ragged
    scores and PV a layer on kernel 2."""
    L = sched.cfg.n_layers
    ev = [e[0] for e in sched.trace]
    pre = ev.count("prefill") + ev.count("recover")
    dec = len(sched.health) + sched.recovery_decode_steps
    return {"redmule_matmul": (pre + dec) * (4 * L + 1),
            "redmule_matmul_batched": dec * 2 * L, "flash_attention": pre * L}


def _dequant_leaf(sub, name):
    """A cache leaf as fp32 values: FP8 codes times their scales, or the
    16-bit values as stored."""
    leaf = sub[name]
    sc = sub.get(f"{name}_scale")
    if sc is None:
        return leaf.float()
    s = sc["scale"]
    tail = (1, -1, 1, 1) if name in ("k", "v") else (1, 1, 1)
    return leaf.float() * s.reshape(*leaf.shape[:leaf.ndim - len(tail)], *tail)


def _scale_grid(sub, name, like):
    """``scale 2^-9`` (the E4M3 subnormal grid) broadcast like ``like``."""
    s = sub[f"{name}_scale"]["scale"]
    tail = (1, -1, 1, 1) if name in ("k", "v") else (1, 1, 1)
    return (s.reshape(*like.shape[:like.ndim - len(tail)], *tail) * E4M3_SUB
            ).expand_as(like)


def _e4m3_excess(got, want, grid, extra=0.0) -> float:
    """The largest |got - want| over its bound ``E4M3_EPS |want| + grid +
    extra`` (<= 1 holds)."""
    bound = E4M3_EPS * want.abs() + grid + extra
    return ((got - want).abs() / bound).max().item()


def _slo_runs(log, counters, params, cfg, pcpu, cfg_cpu, storage, modes) -> dict:
    """``serve_slo.json``'s scenario on the card and on its reduced CPU
    twin (the same arrivals on the virtual clock), for each fault mode:
    goodput and deadline hit rate at the floors, a recovery where a fault
    fired, the card's goodput and event log equal the CPU port's, all
    requests finished, the victim's tokens equal the uninjected run's, and
    the launches equal the structural count of the trace.  (The other
    requests' tokens are printed: the reference pins them only on its
    bitwise 16-bit recovery, and on the card a rebuilt FP8 slot may move
    the pool's scale.)"""
    from repro_torch.runtime import FailureInjector
    from repro_torch.serving import loadgen
    from repro_torch.serving import scheduler as sl

    slo = json.loads((ROOT / "benchmarks" / "baselines" / "serve_slo.json").read_text())
    sc = slo["scenario"]
    scfg = sl.SchedulerConfig(n_slots=sc["n_slots"], max_len=sc["max_len"],
                              storage_dtype=storage, max_queue=sc["max_queue"],
                              audit_every=sc["audit_every"])
    lc = loadgen.LoadConfig(rate=sc["rate"], n_requests=sc["n_requests"],
                            prompt_len=sc["prompt_len"], gen_len=sc["gen_len"],
                            seed=sc["seed"], deadline_ticks=sc["deadline_ticks"],
                            max_retries=sc["max_retries"])
    tag = storage or "16-bit"
    out, base = {}, None
    for mode in modes:
        at = 1 if mode == "prefill_crash" else sc["inject_step"]
        inj = lambda: mode and FailureInjector(fail_at_step=at, mode=mode)
        card, twin = [], []
        _zero(counters)
        _, m = loadgen.slo_rows(params, cfg, scfg, cfg.name, lc, injector=inj(),
                                scheduler=card)
        launches = _read(counters)
        ref = loadgen.run_load(pcpu, cfg_cpu, scfg, lc, injector=inj(), scheduler=twin)
        s, t = card[0], twin[0]
        want = _sched_structural(s)
        floor = slo["goodput_floor_uninjected"] if mode is None \
            else slo["goodput_floor_injected"]
        events = [e for e in s.trace if e[0] in ("nan_detect", "kv_quarantine",
                                                   "prefill_retry", "recover")]
        victim = events[0][2] if events else None
        tokens = {rid: r.tokens for rid, r in s.results.items()}
        if mode is None:
            base = tokens
        row = {"goodput": m["slo_goodput"], "cpu_goodput": ref["slo_goodput"],
               "hit": m["deadline_hit_rate"], "recoveries": m["slo_recoveries"],
               "finished": m["n_finished"], "events": events,
               "victim_tokens_equal": victim is None or tokens[victim] == base[victim],
               "all_tokens_equal": tokens == base, "s_per_tick": m["s_per_tick"],
               "launches": {k: launches[k] for k in want}, "structural": want}
        out[f"{mode} {tag}"] = row
        print(f"[slo] {mode or 'none'}@{at if mode else '-'} {tag}: goodput "
              f"{row['goodput']!r} (CPU port {row['cpu_goodput']!r}), hit {row['hit']}, "
              f"recoveries {row['recoveries']:.0f}, finished {row['finished']}/"
              f"{sc['n_requests']}, events {events}, victim tokens equal "
              f"{row['victim_tokens_equal']}, all tokens equal {row['all_tokens_equal']}, "
              f"{row['s_per_tick']:.4f} s/tick, launches {row['launches']} (structural "
              f"{want})", flush=True)
        ok = (row["goodput"] >= floor and row["hit"] >= slo["deadline_hit_rate_floor"]
              and row["goodput"] == row["cpu_goodput"] and s.trace == t.trace
              and row["finished"] == sc["n_requests"] and row["launches"] == want
              and (mode is None or row["recoveries"] >= slo["recoveries_min"]))
        ok = ok and row["victim_tokens_equal"]
        log.append({"check": f"slo {mode} {tag}", "ok": ok, **{
            k: row[k] for k in ("goodput", "cpu_goodput", "hit", "recoveries")}})
        if not ok:
            raise AssertionError(f"sched: the SLO scenario {mode} {tag} fails: {row}")
    return out


def _recovery_contract(log, params, cfg, storage, gap=None):
    """The reference's recovery scenario (``tests/test_serve_resilience.py:
    333-380``) at full width: two slots, two requests, four scheduler
    steps, then slot 0's rows 0 and pos - 1 bit-flipped and the audit run.
    Holds: the audit quarantines exactly that request; on the 16-bit
    cache the co-resident slot's stored bytes unmoved, bitwise, the
    victim's rebuilt rows bitwise equal to the decode-built ones (the
    scheduler replays the absorbed tokens through decode steps at the
    pool's batch), and, both runs drained, the victim's tokens and final
    logits bitwise equal to an uninjected run's; on the FP8 cache (rebuilt
    by a batch-1 re-prefill) the co-resident codes bitwise where the pool's
    applied scale did not move, else its values within one E4M3 step of
    theirs before, and the victim's rebuilt rows within one E4M3 step plus
    ``gap`` of a 16-bit full prefill of its absorbed tokens, beside a
    control (the prefill of the absorbed tokens with the last one changed)
    that must fail.  Returns the 16-bit cache's prefill-versus-decode gap
    (the decode-built rows against the same prefill) for the FP8 run's
    bound, beside the row."""
    import numpy as np
    import torch

    from repro_torch.models import transformer
    from repro_torch.serving import kv_cache
    from repro_torch.serving import scheduler as sl

    tag = storage or "16-bit"
    rng = np.random.default_rng(11)
    reqs = [sl.Request(rid=i, arrival=0.0, max_new_tokens=6, prompt=rng.integers(
        0, cfg.vocab_size, size=4 + i).astype(np.int32)) for i in range(2)]
    scfg = sl.SchedulerConfig(n_slots=2, max_len=16, storage_dtype=storage,
                              audit_every=1)
    sched = sl.Scheduler(params, cfg, scfg)
    sched.submit(reqs)
    for _ in range(4):
        sched.step()
    s0 = sched.slots[0]
    names = [(k, n, b) for k, n, _, b in kv_cache.iter_kv_leaves(sched.cache)]
    wide = lambda c, k, n, b, slot: _dequant_leaf(c[k], n).select(b, slot)
    decode_built = {(k, n): wide(sched.cache, k, n, b, 0) for k, n, b in names}
    co_codes = {(k, n): sched.cache[k][n].select(b, 1).clone() for k, n, b in names}
    co_wide = {(k, n): wide(sched.cache, k, n, b, 1) for k, n, b in names}
    scales = {(k, n): sched.cache[k][f"{n}_scale"]["scale"].clone()
              for k, n, b in names if storage}
    sched.cache = kv_cache.corrupt_slot_rows(sched.cache, 0, [0, s0.pos - 1])
    t0 = time.perf_counter()
    sched._audit_slots()
    torch.cuda.synchronize()
    audit_ms = (time.perf_counter() - t0) * 1e3   # checksums, re-prefill, insert
    if [e[2] for e in sched.trace if e[0] == "kv_quarantine"] != [s0.rid]:
        raise AssertionError(f"sched recovery {tag}: the audit did not quarantine "
                             f"exactly request {s0.rid}: {sched.trace}")
    absorbed = np.concatenate([s0.prompt, np.asarray(
        sched.results[s0.rid].tokens[:s0.fed], np.int32)])
    nrow = len(absorbed)

    def oracle(seq):
        _, c = transformer.prefill(params, cfg, {"inputs": torch.as_tensor(
            seq, dtype=torch.long, device=params["embed"].device)[None]}, 16)
        return c

    good = oracle(absorbed)
    bad_seq = absorbed.copy()
    bad_seq[-1] = (bad_seq[-1] + 1) % cfg.vocab_size
    bad = oracle(bad_seq)
    moved = {(k, n): bool(storage) and not torch.equal(
        sched.cache[k][f"{n}_scale"]["scale"], scales[(k, n)]) for k, n, b in names}
    row = {"scale_moved": any(moved.values()), "audit_ms_incl_rebuild": audit_ms,
           "leaves": {}}
    gaps = {}
    for k, n, b in names:
        w = good[k][n].float().select(b, 0)[..., :nrow, :]
        rebuilt = wide(sched.cache, k, n, b, 0)[..., :nrow, :]
        db = decode_built[(k, n)][..., :nrow, :]
        gaps[(k, n)] = (db - w).abs().max().item()
        co_bitwise = torch.equal(sched.cache[k][n].select(b, 1).view(torch.uint8),
                                 co_codes[(k, n)].view(torch.uint8))
        leaf = {"co_resident_bitwise": co_bitwise, "scale_moved": moved[(k, n)],
                "prefill_vs_decode_gap": gaps[(k, n)],
                "rebuilt_vs_prefill": (rebuilt - w).abs().max().item()}
        if storage:
            sub = sched.cache[k]
            grid = _scale_grid(sub, n, _dequant_leaf(sub, n)).select(b, 0)[..., :nrow, :]
            g = gap[(k, n)]
            leaf["victim_excess"] = _e4m3_excess(rebuilt, w, grid, g)
            leaf["control_excess"] = _e4m3_excess(
                rebuilt, bad[k][n].float().select(b, 0)[..., :nrow, :], grid, g)
            if not co_bitwise:
                cgrid = _scale_grid(sub, n, _dequant_leaf(sub, n)).select(b, 1)
                leaf["co_resident_excess"] = _e4m3_excess(
                    wide(sched.cache, k, n, b, 1), co_wide[(k, n)], cgrid)
        if not storage:
            leaf["rebuilt_bitwise"] = torch.equal(rebuilt, db)
        row["leaves"][f"{k}/{n}"] = leaf
    if not storage:
        # both runs drained: the victim's tokens and final logits against
        # an uninjected run's
        base = sl.Scheduler(params, cfg, scfg)
        base.submit(reqs)
        want = {r.rid: r for r in base.run()}
        got = {r.rid: r for r in sched.run()}
        row["victim_tokens_equal"] = got[s0.rid].tokens == want[s0.rid].tokens
        row["victim_logits_bitwise"] = bool(np.array_equal(
            got[s0.rid].final_logits.view(np.uint32),
            want[s0.rid].final_logits.view(np.uint32)))
        row["victim_logits_max_abs_diff"] = float(np.max(np.abs(
            got[s0.rid].final_logits - want[s0.rid].final_logits)))
    print(f"[sched] recovery {tag} ({cfg.policy_name}): applied scale moved "
          f"{row['scale_moved']}; audit + rebuild {audit_ms:.1f} ms; "
          + ("" if storage else f"victim tokens equal {row['victim_tokens_equal']}, "
             f"final logits bitwise {row['victim_logits_bitwise']} (max abs diff "
             f"{row['victim_logits_max_abs_diff']:.3e}); ")
          + f"{row['leaves']}", flush=True)
    fails = []
    if not storage and not (row["victim_tokens_equal"] and row["victim_logits_bitwise"]):
        fails.append("the victim's tokens or final logits differ from the uninjected run's")
    for name, leaf in row["leaves"].items():
        # codes bitwise, or (under FP8, where the leaf's applied scale
        # moved) values within one E4M3 step of theirs before
        if not leaf["co_resident_bitwise"] and not (
                leaf["scale_moved"] and leaf["co_resident_excess"] <= 1):
            fails.append(f"{name}: co-resident slot moved")
        if not storage and not leaf["rebuilt_bitwise"]:
            fails.append(f"{name}: rebuilt rows differ from the decode-built ones")
        if storage:
            if not leaf["victim_excess"] <= 1:
                fails.append(f"{name}: rebuilt rows beyond the bound")
            if not leaf["control_excess"] > 1:
                fails.append(f"{name}: the control (last token changed) holds")
    log.append({"check": f"sched recovery contract {tag}", "ok": not fails, **row})
    if fails:
        raise AssertionError(f"sched recovery {tag}: {fails}")
    row["gaps"] = {f"{k}/{n}": g for (k, n), g in gaps.items()}
    return row, gaps


def _recovery_cost(log, params, cfg) -> dict:
    """What a 16-bit rebuild costs at the sweep's lengths: ``S_SLOTS``
    slots of ``S_PROMPT`` + ``S_GEN`` requests under tpu_bf16, one slot's
    rows 0 and pos - 1 bit-flipped and the audit run early (after 2
    absorbed tokens) and late (after ``S_GEN - 2``, another slot).  The
    rebuild replays one decode step per absorbed token in the pool itself,
    so its time grows by about one decode step per token; the slope is
    (late - early) / (the replayed steps' difference).  Holds, each time:
    the audit quarantines exactly that slot, its rebuilt rows are bitwise
    the decode-built ones, and every other slot's stored bytes (the rows
    the replay parks on included) are unmoved."""
    import numpy as np
    import torch

    from repro_torch.serving import kv_cache
    from repro_torch.serving import scheduler as sl

    rng = np.random.default_rng(12)
    reqs = [sl.Request(rid=i, arrival=0.0, max_new_tokens=S_GEN, prompt=rng.integers(
        0, cfg.vocab_size, size=S_PROMPT).astype(np.int32)) for i in range(S_SLOTS)]
    scfg = sl.SchedulerConfig(n_slots=S_SLOTS, max_len=S_PROMPT + S_GEN + 4,
                              audit_every=1)
    sched = sl.Scheduler(params, cfg, scfg)
    sched.submit(reqs)
    out, fails = {}, []
    for tag, victim, fed in (("early", 0, 2), ("late", 1, S_GEN - 2)):
        while sched.slots[victim] is None or sched.slots[victim].fed < fed:
            if not sched.step():
                raise AssertionError(f"sched recovery cost: drained before {tag}")
        s = sched.slots[victim]
        leaves = [(k, n, b) for k, n, _, b in kv_cache.iter_kv_leaves(sched.cache)]
        before = {(k, n): sched.cache[k][n].clone() for k, n, b in leaves}
        sched.cache = kv_cache.corrupt_slot_rows(sched.cache, victim, [0, s.pos - 1])
        steps0 = sched.recovery_decode_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched._audit_slots()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        quarantined = [e[2] for e in sched.trace if e[0] == "kv_quarantine"]
        rebuilt = all(torch.equal(
            sched.cache[k][n].select(b, victim)[..., :s.pos, :].view(torch.uint8),
            before[(k, n)].select(b, victim)[..., :s.pos, :].view(torch.uint8))
            for k, n, b in leaves)
        others = all(torch.equal(
            sched.cache[k][n].select(b, i).view(torch.uint8),
            before[(k, n)].select(b, i).view(torch.uint8))
            for k, n, b in leaves for i in range(S_SLOTS) if i != victim)
        out[tag] = {"fed": s.fed, "pos": s.pos, "audit_ms_incl_rebuild": ms,
                    "replayed_decode_steps": sched.recovery_decode_steps - steps0,
                    "rebuilt_bitwise": rebuilt, "co_resident_bitwise": others}
        print(f"[sched] recovery cost ({tag}, {S_SLOTS} slots, {S_PROMPT} + {S_GEN}, "
              f"tpu_bf16, 16-bit cache): slot {victim} at fed {s.fed}: audit + "
              f"rebuild {ms:.1f} ms, {out[tag]['replayed_decode_steps']} decode steps "
              f"replayed; rebuilt rows bitwise {rebuilt}, co-resident slots bitwise "
              f"{others}", flush=True)
        if quarantined[-1:] != [s.rid] or len(quarantined) != len(out):
            fails.append(f"{tag}: the audit did not quarantine exactly request {s.rid}")
        if not (rebuilt and others):
            fails.append(f"{tag}: rebuilt rows {rebuilt}, co-resident {others}")
        del before
    d = out["late"]["replayed_decode_steps"] - out["early"]["replayed_decode_steps"]
    out["ms_per_replayed_step"] = (out["late"]["audit_ms_incl_rebuild"]
                                   - out["early"]["audit_ms_incl_rebuild"]) / d
    print(f"[sched] recovery cost: {out['ms_per_replayed_step']:.1f} ms a replayed "
          f"decode step", flush=True)
    log.append({"check": "sched recovery at the sweep's lengths: rebuilt rows "
                "and co-resident slots bitwise", "ok": not fails, **out})
    if fails:
        raise AssertionError(f"sched recovery cost: {fails}")
    return out


def _fp8_cut(log, arch) -> dict:
    """A two-layer full-width cut of ``arch`` under its serving policy, a
    1 x 16 prompt and 2 decode steps, with and without the FP8 cache, on
    the card and on the CPU plain path.  Holds every FP8 cache row of the
    card within one E4M3 step of the CPU's plus the 16-bit cut's own
    card-vs-CPU gap of that leaf; the card's FP8 decode logits against its
    16-bit cache's within the reference's band; beside each, a control
    that must fail (layer 0's first cache scale doubled; for the logits
    every layer-0 key scale doubled)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get(arch), n_layers=2)
    pc = transformer.init_params(cfg, seed=SEED + 5, device="cuda")
    pcpu = _to_cpu(pc)
    gen = torch.Generator().manual_seed(SEED + 5)
    toks = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (1, 2), generator=gen)

    def run(params, dev, storage, fault=None):
        with torch.inference_mode():
            lg, cache = transformer.prefill(params, cfg, {"inputs": toks.to(dev)}, 18,
                                            storage_dtype=storage)
            logits = [lg.float().cpu()]
            for i in range(2):
                if fault is not None and i == 0:
                    fault(cache)
                lg, cache = transformer.serve_step(params, cfg, nxt[:, i:i + 1].to(dev),
                                                   cache, 16 + i)
                logits.append(lg.float().cpu())
        return logits, _to_cpu(cache)

    names = ("ckv", "kr") if cfg.mla else ("k", "v")
    dev = pc["embed"].device
    card16, cpu16 = run(pc, dev, None), run(pcpu, "cpu", None)
    card8, cpu8 = run(pc, dev, FP8_STORAGE), run(pcpu, "cpu", FP8_STORAGE)
    key0 = "layer0" if "layer0" in card8[1] else "layers"

    def double_keys(cache):           # every layer-0 key scale doubled
        s = cache[key0][f"{names[0]}_scale"]["scale"]
        (s if key0 == "layer0" else s[0]).mul_(2)

    row = {"leaves": {}}
    fails = []
    for key in card8[1]:
        for n in names:
            gap = (card16[1][key][n].float() - cpu16[1][key][n].float()).abs().max().item()
            got, want = _dequant_leaf(card8[1][key], n), _dequant_leaf(cpu8[1][key], n)
            grid = _scale_grid(cpu8[1][key], n, want)
            excess = _e4m3_excess(got, want, grid, gap)
            ctl = {key: {**card8[1][key]}}
            ctl[key][f"{n}_scale"] = {**card8[1][key][f"{n}_scale"]}
            ctl[key][f"{n}_scale"]["scale"] = card8[1][key][f"{n}_scale"]["scale"].clone()
            s = ctl[key][f"{n}_scale"]["scale"]
            s.view(-1)[0] *= 2
            c_excess = _e4m3_excess(_dequant_leaf(ctl[key], n), want, grid, gap)
            codes = (card8[1][key][n].view(torch.uint8) != cpu8[1][key][n].view(
                torch.uint8)).float().mean().item()
            row["leaves"][f"{key}/{n}"] = {"excess": excess, "control_excess": c_excess,
                                           "gap16": gap, "codes_differing": codes}
            if not excess <= 1:
                fails.append(f"{key}/{n}: FP8 rows card vs CPU beyond the bound")
            if not c_excess > 1:
                fails.append(f"{key}/{n}: the control (one scale doubled) holds")
    diffs = [(a - b).abs().max().item() for a, b in zip(card8[0][1:], card16[0][1:])]
    ctl_logits = run(pc, dev, FP8_STORAGE, fault=double_keys)[0]
    c_diffs = [(a - b).abs().max().item() for a, b in zip(ctl_logits[1:], card16[0][1:])]
    band = lambda d: max(d) < FP8_BAND_MAX and sum(d) / len(d) < FP8_BAND_MEAN
    row.update({"decode_diffs": diffs, "control_decode_diffs": c_diffs,
                "logit_max": max(x.abs().max().item() for x in card16[0]),
                "prefill_diff": (card8[0][0] - card16[0][0]).abs().max().item()})
    if not band(diffs):
        fails.append(f"FP8 decode logits outside the band: {diffs}")
    if band(c_diffs):
        fails.append(f"the logits control (layer-0 key scales doubled) holds: {c_diffs}")
    print(f"[fp8cut] {arch} two layers: {row}", flush=True)
    log.append({"check": f"fp8 cut {arch}", "ok": not fails, **row})
    if fails:
        raise AssertionError(f"fp8 cut {arch}: {fails}")
    del pc, pcpu
    return row


def sched_phase(log, counters):
    """Serving under load: ``repro_torch.launch.serve --sched`` on yi-9b at
    full width and depth (48 layers, d 4096, 8.8 B parameters) with the
    reference's defaults — 4 slots, 8 requests at each of the rates 0.25
    and 1.0, prompt 128, 16 new tokens, the FP8 E4M3 KV cache and
    ``mixed_fp8_e4m3`` — with the counts set to 0 just before.  Holds:
    every request finishes, the launches equal the structural count of the
    traces and every kernel-1 launch is FP8; the rate-1.0 point run again
    gives the same trace and tokens.  Then ``serve_slo.json``'s scenario
    on the card and on its CPU twin under yi-9b's own policy (tpu_bf16),
    as the file states it (FP8 cache: no fault, ``nan_logits@2``,
    ``kv_corrupt@2``, ``prefill_crash@1``; the 16-bit cache: no fault,
    ``kv_corrupt@2``), the recovery contract under
    tpu_bf16 on both caches, a 16-bit recovery's cost early and late in a
    request at the sweep's lengths, the FP8 cuts of yi-9b and deepseek-v2-lite-16b
    against the CPU, and the accounting: KV bytes, one profiled FP8 and
    bf16 decode step, the audit's time."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.optim import tree_map
    from repro_torch.serving import kv_cache, loadgen

    card = _card()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    argv = ["--sched", "--arch", S_ARCH, "--full", "--slots", str(S_SLOTS),
            "--requests", str(S_REQUESTS), "--rates", ",".join(f"{r:g}" for r in S_RATES),
            "--prompt-len", str(S_PROMPT), "--gen", str(S_GEN), "--seed", str(SEED),
            "--device", "cuda", "--json", str(ROOT / "chiprun_out" / "BENCH_sched.json")]
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.main(argv)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated()
    print(f"[sched] launches on the main path: {launches}", flush=True)
    scheds = res["schedulers"]
    want = {k: sum(_sched_structural(s)[k] for s in scheds)
            for k in ("redmule_matmul", "redmule_matmul_batched", "flash_attention")}
    got = {k: launches[k] for k in want}
    fp8 = launches["redmule_matmul (FP8 e4m3, faithful)"]
    print(f"[sched] launches {got}, structural {want} (from the traces: "
          f"{sum(len(s.health) for s in scheds)} decode steps); FP8 kernel-1 "
          f"launches {fp8}", flush=True)
    if got != want or fp8 != got["redmule_matmul"]:
        raise AssertionError("sched: launches differ from the structural count, "
                             "or not every kernel-1 launch is FP8")
    for rate, m in zip(S_RATES, res["points"]):
        print(f"[sched] rate {rate:g} ({card}): TTFT p50 {m['p50_ttft_ticks']:.3f} / "
              f"p99 {m['p99_ttft_ticks']:.3f} ticks, tokens/s p50 "
              f"{m['p50_tokens_per_s']:.3f} / p99 {m['p99_tokens_per_s']:.3f}, batch "
              f"fill {m['mean_batch_fill']:.3f}, {m['s_per_tick']:.4f} s/tick, "
              f"{m['decode_steps']} decode steps in {m['wall_s']:.2f} s", flush=True)
        if m["n_finished"] != S_REQUESTS:
            raise AssertionError(f"sched: rate {rate}: {m['n_finished']} of "
                                 f"{S_REQUESTS} requests finished")
    params, cfg, scfg = scheds[0].params, scheds[0].cfg, scheds[0].scfg
    again = []
    loadgen.run_load(params, cfg, scfg, loadgen.LoadConfig(
        rate=S_RATES[-1], n_requests=S_REQUESTS, prompt_len=S_PROMPT, gen_len=S_GEN,
        seed=SEED, max_retries=2), scheduler=again)
    first, second = scheds[-1], again[0]
    same = (first.trace == second.trace and
            {k: r.tokens for k, r in first.results.items()}
            == {k: r.tokens for k, r in second.results.items()})
    points = res["points"]
    print(f"[sched] rate {S_RATES[-1]:g} run again: the same trace "
          f"({len(first.trace)} events) and tokens: {same}", flush=True)
    log.append({"check": "sched rate point run twice: same trace and tokens", "ok": same})
    if not same:
        raise AssertionError("sched: the same seed gave another trace or other tokens")
    del scheds, first, second, again, res

    parts = {"sweep": sweep_s, "rerun": time.perf_counter() - t0 - sweep_s}

    # the SLO scenario, card and reduced CPU twin, as serve_slo.json states
    # it: yi-9b's own policy (tpu_bf16; the sweep's weights cast) with the
    # FP8 cache, and with the 16-bit cache
    t1 = time.perf_counter()
    bf_cfg = configs.get(S_ARCH)
    p_bf = tree_map(lambda t: t.to(bf_cfg.policy.compute_dtype), params)
    red = configs.get_reduced(S_ARCH)
    p_red = transformer.init_params(red, seed=SEED, device="cpu")
    slo = _slo_runs(log, counters, p_bf, bf_cfg, p_red, red, FP8_STORAGE,
                    (None, "nan_logits", "kv_corrupt", "prefill_crash"))
    slo.update(_slo_runs(log, counters, p_bf, bf_cfg, p_red, red, None,
                         (None, "kv_corrupt")))
    parts["slo"] = time.perf_counter() - t1

    # the recovery contract under tpu_bf16: the 16-bit cache first (its
    # prefill-versus-decode gap bounds the FP8 run's)
    t1 = time.perf_counter()
    rec16, gaps = _recovery_contract(log, p_bf, bf_cfg, None)
    rec8, _ = _recovery_contract(log, p_bf, bf_cfg, FP8_STORAGE, gap=gaps)
    rec_cost = _recovery_cost(log, p_bf, bf_cfg)
    parts["recovery"] = time.perf_counter() - t1
    t1 = time.perf_counter()

    # accounting, and one profiled decode step on each cache: 4 slots with
    # 128 rows cached
    L, T = cfg.n_layers, S_PROMPT + S_GEN + 4
    lengths = [S_PROMPT] * S_SLOTS
    acct = {"token_elems": kv_cache.token_elems(cfg)}
    for tag, sd in (("fp8", FP8_STORAGE), ("bf16", None)):
        acct[f"decode_step_kv_bytes_{tag}"] = kv_cache.decode_step_kv_bytes(cfg, lengths, sd)
        acct[f"cache_size_bytes_{tag}"] = kv_cache.cache_size_bytes(cfg, S_SLOTS, T, sd)
    dev = params["embed"].device
    toks = torch.zeros((S_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((S_SLOTS,), S_PROMPT, device=dev)
    sizes = np.full((S_SLOTS,), S_PROMPT + 1, np.int32)
    profiles = {}
    for tag, pp, cc, sd in (("fp8", params, cfg, FP8_STORAGE), ("bf16", p_bf, bf_cfg, None)):
        cache = transformer.init_cache(cc, S_SLOTS, T, storage_dtype=sd, device=dev)
        step = lambda pp=pp, cc=cc, cache=cache: transformer.serve_step(
            pp, cc, toks, cache, pos, kv_group_sizes=sizes)
        step()
        acct[f"decode_step_ms_{tag}"] = _time_ms(step, iters=2, warmup=1)
        # one call a window: an FP8 step launches ~18,700 kernels, and the
        # profiler's post-processing of three took ~30 s
        profiles[tag] = _k2_profile(step, 1, 2 * L)
        _print_profile(f"sched decode_step, {tag} cache", profiles[tag])
        _no_library_gemm(profiles[tag], f"sched decode step ({tag} cache)")
        if tag == "fp8":
            t0 = time.perf_counter()
            for i in range(S_SLOTS):
                kv_cache.slot_checksum(cache, i, S_PROMPT)
            acct["audit_ms_4_slots"] = (time.perf_counter() - t0) * 1e3
        del cache
    print(f"[sched] accounting ({card}): {acct}; sweep peak {peak / 2**30:.2f} GiB",
          flush=True)
    del params, p_bf
    torch.cuda.empty_cache()
    parts["accounting"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    cuts = {arch: _fp8_cut(log, arch) for arch in (S_ARCH, "deepseek-v2-lite-16b")}
    parts["fp8_cuts"] = time.perf_counter() - t1
    print(f"[sched] seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()),
          flush=True)
    return {"sweep_s": sweep_s, "launches": launches, "structural": want,
            "points": points,
            "slo": slo, "recovery": {"16-bit": rec16, "fp8": rec8, "cost": rec_cost},
            "accounting": acct, "profiles": profiles, "fp8_cuts": cuts,
            "peak_mem_gib": peak / 2**30, "seconds": parts}


# the tune phase: kernel 1 at qwen3-1.7b's serving shapes (PERF.md rows 1,
# 1i, 1j, 1k: the tied head "nt", decode w_out and wqkv, prefill w_in) and
# kernel 4's chunk at the xLSTM training shape (row 4), each candidate timed
# on the card; the cache file it writes then serves a two-layer full-width
# qwen3 cut and a paper_fp16 AE step
TUNE_GEMMS = (("1", BATCH, 2048, 151936, "nt"), ("1i", BATCH, 6144, 2048, "nn"),
              ("1j", BATCH, 2048, 4096, "nn"), ("1k", PROMPT, 2048, 12288, "nn"))
# the cut's logits, cached vs uncached: the split checks' bf16 tolerance
TUNE_TOL = 2.0 ** -7


@contextlib.contextmanager
def _autotune_file(path):
    """``REPRO_AUTOTUNE_CACHE`` set to ``path`` (None: unset) with a fresh
    in-process LRU, restored after."""
    import os

    from repro_torch.core import autotune

    old = os.environ.pop(autotune.ENV_VAR, None)
    if path is not None:
        os.environ[autotune.ENV_VAR] = str(path)
    autotune.clear_cache()
    try:
        yield
    finally:
        os.environ.pop(autotune.ENV_VAR, None)
        if old is not None:
            os.environ[autotune.ENV_VAR] = old
        autotune.clear_cache()


def _print_tuning(what: str, res, card: str) -> dict:
    """Every candidate's time, the heuristic's and the pick, one line each."""
    scores = dict(res.scores)
    h = res.heuristic
    heur = (h.bm, h.bn, h.bk, h.splits)
    geom = lambda t: f"{t[0]}x{t[1]}x{t[2]} S={t[3]}"
    print(f"[tune] {what} ({card}): {len(scores)} candidates, "
          f"{res.source} us: " + ", ".join(f"{geom(t)} {us:.2f}"
                                           for t, us in res.scores), flush=True)
    pick = (res.tile.bm, res.tile.bn, res.tile.bk, res.tile.splits)
    print(f"[tune] {what}: heuristic {geom(heur)} {scores[heur]:.2f} us, pick "
          f"{geom(pick)} {res.us:.2f} us ({scores[heur] / res.us:.3f}x)", flush=True)
    return {"key": res.key.to_str(), "scores_us": [[list(t), us] for t, us in res.scores],
            "heuristic": list(heur), "heuristic_us": scores[heur],
            "pick": list(pick), "pick_us": res.us}


def tune_phase(log):
    """The autotuner on the card: each tuned shape's candidates timed with
    CUDA events (weights cycled past the L2) and the pick recorded in
    ``chiprun_out/autotune_cache.json``; kernel 4 held to its plain version
    at every candidate chunk; then the cache, reloaded from disk, serves a
    two-layer full-width qwen3-1.7b cut (prefill 1 x PROMPT, a decode step
    at batch BATCH): every launch of a tuned shape ran the cached tile and
    split, and the logits sit within TUNE_TOL of the uncached run's; the
    same from a second file holding each shape's fastest candidate other
    than the heuristic's (a geometry the heuristic never runs), beside a
    control (an entry naming an uncompiled tile) that must raise; a
    paper_fp16 AE step whose every launch runs a cached tile other than the
    heuristic's is bitwise equal to the uncached step."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import autotune, tiling
    from repro_torch.core import precision as prec
    from repro_torch.data import SyntheticAE
    from repro_torch.kernels import chunked_linear_attention as cla
    from repro_torch.launch import train
    from repro_torch.models import autoencoder, transformer
    from repro_torch.optim import tree_leaves

    card = _card()
    path = ROOT / "chiprun_out" / "autotune_cache.json"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    out = {"card": card, "gemm": {}}
    with _autotune_file(path):
        for row, M, N, K, layout in TUNE_GEMMS:
            res = autotune.autotune_gemm(M, N, K, policy=prec.TPU_BF16,
                                         layout=layout, mode="measured")
            out["gemm"][row] = _print_tuning(
                f"row {row} {layout} {M}x{N}x{K} bf16", res, card)
        # kernel 4's chunk at the training shape (16 heads, S 256, dk = dv
        # = 1024, bf16), each chunk held to the plain version at that chunk
        # (bf16: out 2^-7, state 1e-4), and fp32 inputs at K4_FP32_TOL
        BH4, DK4 = T_BATCH * 4, 1024
        res4 = autotune.autotune_attention(T_SEQ, DK4, DK4, kind="linear_attention",
                                           policy=prec.TPU_BF16, batch=BH4,
                                           mode="measured")
        out["k4"] = _print_tuning(f"row 4 chunk BH={BH4} S={T_SEQ} dk=dv={DK4} bf16",
                                  res4, card)
        g = torch.Generator(device="cuda").manual_seed(SEED + 11)
        for c in cla.CHUNKS:
            for BH_, dt, tol_o, tol_s in ((BH4, torch.bfloat16, 2.0 ** -7, 1e-4),
                                          (2, torch.float32, K4_FP32_TOL, K4_FP32_TOL)):
                q = (torch.randn(BH_, T_SEQ, DK4, generator=g, device="cuda")
                     * DK4 ** -0.5).to(dt)
                k = (torch.randn(BH_, T_SEQ, DK4, generator=g, device="cuda")
                     * 0.5).to(dt)
                v = torch.randn(BH_, T_SEQ, DK4, generator=g, device="cuda").to(dt)
                lg = -torch.rand(BH_, T_SEQ, generator=g, device="cuda") * 0.1
                o, st = cla.chunked_linear_attention(q, k, v, lg, chunk=c)
                po, ps = cla.chunked_linear_attention_plain(q, k, v, lg, chunk=c)
                name = f"tune sweep chunk {c} BH={BH_} dk=dv={DK4} {prec.dtype_name(dt)}"
                _check(f"{name} out", o, po, tol_o, log)
                _check(f"{name} state", st, ps, tol_s, log)
        # flash: one compiled block pair, so one candidate
        resf = autotune.autotune_attention(PROMPT, PROMPT, 128, kind="attention",
                                           policy=prec.TPU_BF16, batch=BATCH * 16,
                                           mode="measured")
        out["flash"] = _print_tuning(f"flash S=T={PROMPT} D=128 bf16", resf, card)

    cfg = dataclasses.replace(configs.get(ARCH), n_layers=2)
    pc = transformer.init_params(cfg, seed=SEED + 9, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen, device="cuda")

    def cut():
        pre, _ = transformer.prefill(pc, cfg, {"inputs": prompt}, PROMPT + GEN)
        cache = transformer.init_cache(cfg, BATCH, PROMPT + GEN, device="cuda")
        dec, _ = transformer.serve_step(
            pc, cfg, toks, cache, torch.full((BATCH,), PROMPT, device="cuda"),
            kv_group_sizes=np.full((BATCH,), PROMPT + 1, np.int32))
        return pre, dec

    with _autotune_file(None), _launch_log() as plain_log:
        want = cut()

    def from_file(what, file, picks):
        """The cut with the LRU reloaded from ``file``: every launch of a
        tuned shape must run its entry's tile and split, the logits within
        TUNE_TOL of the uncached run's."""
        with _autotune_file(file), _launch_log() as tuned_log:
            got = cut()
            stats = autotune.cache_stats()
        ran = {row: 0 for row in picks}
        rows = {(M, N, K, layout): row for row, M, N, K, layout in TUNE_GEMMS}
        for r in tuned_log:
            row = rows.get((*r["mnk"], r["layout"]))
            if row is None:
                continue
            t = picks[row]
            plan = tiling.plan_for_splits(r["mnk"][1], t.splits) if t.splits else None
            if r["tile"] != (t.bm, t.bn, t.bk) or (
                    plan is not None and (r["splits"], r["depth"]) != tuple(plan)):
                raise AssertionError(f"tune cut ({what}): a row-{row} launch ran "
                                     f"{r}, not the cached {t} / {plan}")
            ran[row] += 1
        print(f"[tune] cut ({what}): launches of a tuned shape on the cached tile "
              f"and split: {ran}; LRU from disk {stats}", flush=True)
        if min(ran.values()) < 1 or len(tuned_log) != len(plain_log):
            raise AssertionError(f"tune cut ({what}): tuned shapes not all run from "
                                 f"the cache ({ran}), or launches differ "
                                 f"({len(tuned_log)} vs {len(plain_log)})")
        return ran, [_check(f"tune cut ({what}) {name} logits, cached vs uncached",
                            a.cpu(), b.cpu(), TUNE_TOL, log)
                     for name, a, b in zip(("prefill", "decode"), got, want)]

    picks = {row: tiling.TileConfig(*out["gemm"][row]["pick"]) for row, *_ in TUNE_GEMMS}
    ran, errs = from_file("the picks", path, picks)
    # each shape's fastest candidate other than the heuristic's: a tile or
    # split the heuristic never runs, through the same file and checks
    runner = ROOT / "chiprun_out" / "autotune_runner_up.json"
    runner.unlink(missing_ok=True)
    seconds = {}
    with _autotune_file(runner):
        for row, M, N, K, layout in TUNE_GEMMS:
            g_ = out["gemm"][row]
            geom, _ = min(((t, us) for t, us in g_["scores_us"] if t != g_["heuristic"]),
                          key=lambda c: c[1])
            seconds[row] = tiling.TileConfig(*geom)
            autotune.record_tile(autotune.canonical_key(
                M, N, K, policy=prec.TPU_BF16, backend="hopper", layout=layout),
                seconds[row], source="runner-up")
    ran2, errs2 = from_file("the runners-up", runner, seconds)
    bad = ROOT / "chiprun_out" / "autotune_bad.json"
    key = autotune.canonical_key(BATCH, 2048, 4096, policy=prec.TPU_BF16,
                                 backend="hopper")
    bad.write_text(json.dumps({key.to_str(): {"bm": 32, "bn": 32, "bk": 64,
                                              "source": "manual"}}))
    with _autotune_file(bad):
        try:
            cut()
        except ValueError as e:
            print(f"[tune] control (an entry naming an uncompiled tile) raised: {e}",
                  flush=True)
        else:
            raise AssertionError("tune control: an uncompiled tile ran")
    log.append({"check": "tune control: uncompiled cached tile raises", "ok": True})
    del pc

    # the faithful accumulator: every launch of a paper_fp16 AE step from a
    # cached tile other than the heuristic's, bitwise equal to the uncached
    params = autoencoder.init_ae(seed=SEED, device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    xb = torch.from_numpy(SyntheticAE(batch=AE_BATCH, seed=SEED).sample(0)).cuda()
    asked = []
    lookup = autotune.cached_tile

    def spy(*a, **kw):
        asked.append((a, kw))
        return lookup(*a, **kw)

    autotune.cached_tile = spy
    try:
        with _autotune_file(None), _launch_log() as plain_ae:
            loss0, grads0 = train.ae_grads(params, xb, prec.PAPER_FP16)
    finally:
        autotune.cached_tile = lookup
    ae_path = ROOT / "chiprun_out" / "autotune_ae.json"
    ae_path.unlink(missing_ok=True)
    with _autotune_file(ae_path), _launch_log() as cached_ae:
        for (m, n, k), kw in asked:
            h = tiling.choose_tiles(m, n, k)
            other = next(t for t in tiling.GEMM_TILES if t != h)
            autotune.record_tile(autotune.canonical_key(m, n, k, **kw), other)
        autotune.clear_cache()             # served from the file
        loss1, grads1 = train.ae_grads(params, xb, prec.PAPER_FP16)
    moved = sum(a["tile"] != b["tile"] for a, b in zip(plain_ae, cached_ae))
    same = bool(torch.equal(loss0, loss1)) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(grads0), tree_leaves(grads1)))
    plans = all((a["splits"], a["depth"]) == (b["splits"], b["depth"])
                for a, b in zip(plain_ae, cached_ae))
    print(f"[tune] paper_fp16 AE step: {moved} of {len(cached_ae)} launches on a "
          f"cached non-heuristic tile (split plans {'equal' if plans else 'DIFFER'}); "
          f"loss and every gradient {'bitwise equal' if same else 'DIFFER'}",
          flush=True)
    log.append({"check": "tune faithful AE step cached vs uncached, bitwise",
                "moved": moved, "ok": same})
    if not (same and plans) or moved != len(cached_ae) or len(cached_ae) != 30:
        raise AssertionError("tune: a cached tile changed the faithful AE step")
    out.update(cut_errs=errs, cut_ran=ran, runner_up_errs=errs2,
               runner_up_ran=ran2, ae_moved=moved, ae_bitwise=same,
               runner_up={r: list(dataclasses.astuple(t)) for r, t in seconds.items()})
    return out


# the shard phase: two gloo ranks on cuda:0 (launch/mesh.py's worker),
# model axis 2.  qwen3-1.7b at full width and depth served under the
# serving rules (prefill 4 x 128, 16 greedy steps, tpu_bf16); its depth cut
# to 2 for 2 train steps at 4 x 256 under Rules() (fp32: the checks;
# tpu_bf16: printed); deepseek-moe-16b at full width with depth cut to 3
# served (4 x 128 + 8 steps) under both MoE routes in fp32
SH_MESH = [1, 2]
SH_SERVE = dict(batch=4, prompt=128, gen=16)
SH_TRAIN = dict(batch=4, seq=256, steps=2, n_layers=2)
SH_MOE = dict(batch=4, prompt=128, gen=8, n_layers=3)
# bounds, relative to the largest magnitude of the unsharded run: the bf16
# serve logits (the layout rounds each rank's partial sums to bf16 before
# adding them, and its attention is the q-chunked path, not flash); the
# fp32 rows (summation order only)
SH_BF16_TOL, SH_FP32_TOL = 2.0 ** -3, 1e-4
SH_DEVICE, SH_FULL = "cuda", True
# the reference dry run's layouts, each cell at full width in a second
# spawn beside the first (fp32 unless named): qwen3-1.7b's two layers trained under
# Rules(fsdp=True) on {data: 2, model: 1} with grad_accum 2 and under
# Rules(sequence_parallel=True), and served 4 x (128 + 8) under Rules()
# (the KV cache cut over its heads); deepseek-v2-lite-16b (MLA) at depth 3
# served 4 x (128 + 8) under the serving rules and trained under Rules();
# hymba-1.5b at depth 4 (layer 0 full, 1-3 windowed) served 4 x (1152 +
# 8) under tpu_bf16 (the window crosses the cache's cut at 580) and two
# layers trained; xlstm-1.3b's first super-block (8 blocks) served 4 x
# (128 + 8) and trained.  Each cell names the leaf whose last-rank block
# its control negates (layer 0) and the step-0 gradients it holds; the
# training cells run one step (FSDP's of two microbatches), the served
# ones 8 decode steps: trimmed to keep the script's time.  The
# recurrent training cells hold their gradients to 3x the unsharded step's
# own spread where that exceeds SH_FP32_TOL (``spread``: the same network
# with its GLU hidden units and mLSTM heads renumbered; xlstm-1.3b's fp32
# step-0 gradients moved by up to 3.2e-4 of max through its recurrences).
# The MLA cells, the largest on the card, run first: this process starts
# its unsharded references once they are done.
SH_MLA, SH_HYMBA, SH_XLSTM = "deepseek-v2-lite-16b", "hymba-1.5b", "xlstm-1.3b"
SH_LAYOUTS = [
    (dict(name="mla_train", kind="train", arch=SH_MLA, mesh=[1, 2], batch=4, seq=256,
          steps=1, n_layers=3), "layers/attn/wo",
     ("layer0/attn/wq", "layers/attn/wuk", "layers/attn/wo",
      "layers/moe/router", "layers/moe/shared/w_in", "layers/ln1")),
    (dict(name="mla_serve", kind="serve", arch=SH_MLA, mesh=[1, 2], n_layers=3,
          batch=4, prompt=128, gen=8), "layers/attn/wo", ()),
    (dict(name="qwen_fsdp", kind="train", arch=ARCH, mesh=[2, 1], fsdp=True,
          grad_accum=2, **dict(SH_TRAIN, steps=1)), "layers/attn/wo",
     ("embed", "layers/attn/wqkv", "layers/attn/wo", "layers/mlp/w_in",
      "layers/mlp/w_out", "layers/ln1")),
    (dict(name="qwen_sp", kind="train", arch=ARCH, mesh=[1, 2],
          sequence_parallel=True, **dict(SH_TRAIN, steps=1)), "layers/attn/wo",
     ("embed", "layers/attn/wqkv", "layers/attn/wo", "layers/mlp/w_in", "layers/ln1")),
    (dict(name="qwen_rules_serve", kind="serve", arch=ARCH, mesh=[1, 2],
          serve_rules=False, n_layers=2, batch=4, prompt=128, gen=8),
     "layers/attn/wo", ()),
    (dict(name="hymba_serve", kind="serve", arch=SH_HYMBA, mesh=[1, 2], n_layers=4,
          batch=4, prompt=1152, gen=8, policy_name="tpu_bf16"), "layers/mamba/w_out", ()),
    (dict(name="hymba_train", kind="train", arch=SH_HYMBA, mesh=[1, 2],
          **dict(SH_TRAIN, steps=1)),
     "layers/mamba/w_out",
     ("layers/attn/wqkv", "layers/attn/wo", "layers/mamba/w_xz",
      "layers/mamba/w_out", "layers/mlp/w_in")),
    (dict(name="xlstm_serve", kind="serve", arch=SH_XLSTM, mesh=[1, 2], n_layers=8,
          batch=4, prompt=128, gen=8), "layers/mlstm/cell/w_down", ()),
    (dict(name="xlstm_train", kind="train", arch=SH_XLSTM, mesh=[1, 2], n_layers=8,
          batch=4, seq=256, steps=1, spread=True), "layers/mlstm/cell/w_down",
     ("layers/mlstm/cell/w_up", "layers/mlstm/cell/w_down",
      "layers/mlstm/cell/w_qkv", "layers/slstm/cell/w_gates",
      "layers/slstm/cell/ffn/w_in")),
]
# FSDP x TP on {data: 2, model: 2}: four rank processes on the host's CPU
# (one card cannot hold four gloo ranks' work in this phase's time), two
# layers of qwen3-1.7b at full width, one step at 4 x 32, against the
# unsharded step on the card
SH_CPU4 = (dict(name="qwen_fsdp_2x2", kind="train", arch=ARCH, mesh=[2, 2], fsdp=True,
                batch=4, seq=32, steps=1, n_layers=2), "layers/attn/wo",
           ("layers/attn/wqkv", "layers/attn/wo", "layers/mlp/w_in", "layers/ln1"))


def _shard_rows(prompts, fed, params, cfg, gen, dev, states=False):
    """The unsharded run's logits, teacher-forced on the tokens the
    sharded run fed: prefill, then ``gen`` decode steps (fp32, host); with
    ``states`` also the final recurrent states (fp32, host)."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tt

    S = prompts.shape[1]
    lg, cache = tt.prefill(params, cfg, {"inputs": prompts.to(dev)}, S + gen)
    rows = [lg.float().cpu()]
    for i in range(gen):
        lg, cache = tt.serve_step(params, cfg, fed[:, i:i + 1].to(dev), cache, S + i)
        rows.append(lg.float().cpu())
    final = {k: v.float().cpu() for k, v in mesh_lib.recurrent_states(cache).items()}
    del cache
    return (torch.stack(rows), final) if states else torch.stack(rows)


def _layout_cell(cell, leaves) -> dict:
    """A layout cell of the mesh worker's plan: full width, the phase's
    seed, fp32 unless the cell names a policy, the held gradient leaves."""
    return dict(cell, full=SH_FULL, seed=SEED, grads=list(leaves),
                policy_name=cell.get("policy_name", "fp32"))


def _layout_cfg(cell):
    import dataclasses

    from repro_torch import configs

    get = configs.get if cell["full"] else configs.get_reduced
    return dataclasses.replace(get(cell["arch"]), policy_name=cell["policy_name"],
                               **({"n_layers": cell["n_layers"]} if "n_layers" in cell
                                  else {}))


def _layout_rules(cell):
    from repro_torch.launch import serve as serve_lib
    from repro_torch.runtime import sharding

    base = sharding.Rules(fsdp=cell.get("fsdp", False),
                          sequence_parallel=cell.get("sequence_parallel", False))
    serve = cell.get("serve_rules", cell["kind"] == "serve")
    return serve_lib.serve_rules(base) if serve else base


def _local_bytes(specs, shapes, mesh) -> int:
    """The bytes of the local blocks of a sanitized spec tree."""
    from repro_torch.runtime import sharding

    if isinstance(specs, tuple):
        return (math.prod(sharding.local_shape(tuple(shapes.shape), specs, mesh))
                * shapes.element_size())
    return sum(_local_bytes(specs[k], shapes[k], mesh) for k in specs)


def _flip_block(params, cfg, cell, path: str) -> None:
    """Negate, in place, the last rank's block of layer 0 of the leaf at
    ``path`` (a cut leaf): the control of a layout cell."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tt
    from repro_torch.runtime import sharding

    shape = tuple(cell["mesh"])
    mesh = mesh_lib.Mesh(shape, ("data", "model"), rank=math.prod(shape) - 1)
    spec = sharding.sanitize_tree(tt.param_specs(cfg, _layout_rules(cell)),
                                  tt.abstract_params(cfg), mesh)
    leaf = params
    for k in path.split("/"):
        spec, leaf = spec[k], leaf[k]
    block = sharding.shard_block(leaf, spec, mesh)
    if block.shape == leaf.shape:
        raise AssertionError(f"shard control: {path} is not cut on {shape}")
    with torch.no_grad():
        block[0].neg_()


def _renumber_glus(params, inverse=False) -> None:
    """Permute, in place, every gated MLP's hidden units alike in
    ``w_in``'s gate and up columns and ``w_out``'s rows (the same
    function, its sums in another order); ``inverse`` undoes it."""
    import torch

    for k, v in list(params.items()):
        if isinstance(v, dict):
            _renumber_glus(v, inverse)
    w_in, w_out = params.get("w_in"), params.get("w_out")
    if isinstance(w_in, torch.Tensor) and w_in.shape[-1] == 2 * w_out.shape[-2]:
        ff = w_out.shape[-2]
        p = torch.randperm(ff, generator=torch.Generator().manual_seed(0))
        p = (torch.argsort(p) if inverse else p).to(w_in.device)
        with torch.no_grad():
            params["w_in"].copy_(torch.cat([w_in[..., :ff][..., p],
                                            w_in[..., ff:][..., p]], -1))
            params["w_out"].copy_(w_out[..., p, :])


def _renumber_mlstm_heads(params, H: int, inverse=False) -> None:
    """Permute, in place, the heads of every mLSTM cell (``w_up``'s x and
    z head blocks, ``w_qkv``, ``w_if``'s head rows and i / f columns,
    ``b_if``, ``norm``, ``w_down``'s head rows): the same function, its
    sums over the channels in another order; ``inverse`` undoes it."""
    import torch

    cell = params["layers"]["mlstm"]["cell"]
    p = torch.randperm(H, generator=torch.Generator().manual_seed(1))
    p = (torch.argsort(p) if inverse else p).to(cell["w_qkv"].device)
    di = cell["norm"].shape[-1]
    ch = (p[:, None] * (di // H) + torch.arange(di // H, device=p.device)).reshape(-1)
    gates = torch.cat([p, p + H])
    with torch.no_grad():
        cell["w_up"].copy_(torch.cat([cell["w_up"][..., :di][..., ch],
                                      cell["w_up"][..., di:][..., ch]], -1))
        cell["w_qkv"].copy_(cell["w_qkv"][..., p, :, :])
        cell["w_if"].copy_(cell["w_if"][..., ch, :][..., gates])
        cell["b_if"].copy_(cell["b_if"][..., gates])
        cell["norm"].copy_(cell["norm"][..., ch])
        cell["w_down"].copy_(cell["w_down"][..., ch, :])


def _layout_train_refs(cell, control_leaf, leaves, dev, draw=None) -> dict:
    """The unsharded step 0 of a training layout cell on the card, from
    the phase's seed and the worker's batch: loss, global norm and the
    held gradients; the same with the control's block negated; and, for
    the recurrent kinds (``spread``), with the GLU hidden units (and the
    mLSTM heads) renumbered
    (the rounding spread of the unsharded step, measured: the same
    function, its sums in another order).  ``draw``: the device the ranks
    drew the weights on, when not the card (the CPU's generator draws
    other numbers from a seed)."""
    import gc

    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_lib
    from repro_torch.models import transformer as tt
    from repro_torch.optim import tree_map

    cfg = _layout_cfg(cell)
    ds = SyntheticLM(cfg.vocab_size, cell["seq"], cell["batch"], seed=0)
    batch = {k: torch.from_numpy(v) for k, v in ds.batch(0).items()}
    ga = cell.get("grad_accum", 1)
    # the unsharded step's gradients (its microbatches averaged in fp32,
    # as build_train_step does) without its optimizer state
    mbs = [{k: v.reshape(ga, -1, *v.shape[1:])[i].to(dev) for k, v in batch.items()}
           for i in range(ga)]

    def unsharded(change=None):
        params = tree_map(lambda t: t.to(dev).requires_grad_(True), tt.init_params(
            cfg, seed=SEED, device=draw or dev, dtype=getattr(torch, cfg.param_dtype)))
        if change == "flip":
            _flip_block(params, cfg, cell, control_leaf)
        elif change == "renumber":
            _renumber_glus(params)
            if cfg.block_kind == "xlstm":
                _renumber_mlstm_heads(params, cfg.n_heads)
        loss, grads = 0.0, None
        for mb in mbs:
            m, g = train_lib._value_and_grad(cfg, params, mb)
            g = {k: v.float() / ga for k, v in _flat_named(g).items()}
            grads = g if grads is None else {k: grads[k] + g[k] for k in g}
            loss += float(m["loss"]) / ga
        norm = math.sqrt(sum(float(v.square().sum()) for v in grads.values()))
        if change == "renumber":
            back = _unflat(grads)
            _renumber_glus(back, inverse=True)
            if cfg.block_kind == "xlstm":
                _renumber_mlstm_heads(back, cfg.n_heads, inverse=True)
            grads = _flat_named(back)
        got = (loss, norm, {k: grads[k].cpu() for k in leaves})
        del params, grads
        gc.collect()
        torch.cuda.empty_cache()
        return got

    return {"batch": batch, "want": unsharded(), "control": unsharded("flip"),
            "spread": [unsharded("renumber")[2]] if cell.get("spread") else None}


def _layout_train(cell, refs, leaves, out, infos, card, log, res) -> None:
    """A training layout cell against the unsharded step on the card
    (:func:`_layout_train_refs`): the step-0 loss, global norm and
    gradients, each beside the control (the bound: ``SH_FP32_TOL``, or 3x
    the measured spread where it is larger); the resident parameter and
    moment bytes against the spec's blocks."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tt
    from repro_torch.runtime import sharding

    cfg = _layout_cfg(cell)
    name = cell["name"]
    what = (f"{cfg.name} {cell['kind']} ({cfg.n_layers} layers, {cell['batch']} x "
            f"{cell['seq']}, {cfg.policy_name}, mesh {tuple(cell['mesh'])}, "
            f"fsdp={cell.get('fsdp', False)}, sp={cell.get('sequence_parallel', False)}"
            f", grad_accum={cell.get('grad_accum', 1)})")
    if not all(torch.equal(out["batch0"][k], refs["batch"][k]) for k in refs["batch"]):
        raise AssertionError(f"shard {name}: the ranks trained on another batch")
    (loss, norm, grads), (closs, cnorm, cgrads) = refs["want"], refs["control"]
    got = _flat_named(out["grads0"])
    i0 = infos[0]
    print(f"[shard] {name}: step-0 loss sharded {i0['losses'][0]!r}, unsharded {loss!r}, "
          f"control {closs!r}; global norm sharded {i0['grad_norms'][0]!r}, unsharded "
          f"{norm!r}", flush=True)
    _shard_compare(f"{what} step-0 loss", torch.tensor([i0["losses"][0]]),
                   torch.tensor([loss]), torch.tensor([closs]), SH_FP32_TOL, log)
    _shard_compare(f"{what} step-0 global norm", torch.tensor([i0["grad_norms"][0]]),
                   torch.tensor([norm]), torch.tensor([cnorm]), SH_FP32_TOL, log)
    for k in leaves:
        tol = SH_FP32_TOL
        if refs["spread"] is not None:
            spread = max(((g[k] - grads[k]).abs().max() / grads[k].abs().max()).item()
                         for g in refs["spread"])
            tol = max(tol, 3 * spread)
            print(f"[shard] {name} grad {k}: the unsharded step's spread (units "
                  f"renumbered) {spread:.3e} of max", flush=True)
        _shard_compare(f"{what} step-0 grad {k}", got[k], grads[k], cgrads[k], tol, log)
    whole = sum(t.numel() * t.element_size() for t in
                _flat_named(tt.abstract_params(cfg)).values())
    for r, info in enumerate(infos):
        mesh = mesh_lib.Mesh(tuple(cell["mesh"]), ("data", "model"), rank=r)
        want = _local_bytes(sharding.sanitize_tree(
            tt.param_specs(cfg, _layout_rules(cell)), tt.abstract_params(cfg), mesh),
            tt.abstract_params(cfg), mesh)
        held = info["param_bytes"] + info["moment_bytes"]
        print(f"[shard] ({card}) {name} rank {r}: params + AdamW moments {held / 1e9:.3f}"
              f" GB of {3 * whole / 1e9:.3f} GB whole (the spec's blocks: "
              f"{3 * want / 1e9:.3f} GB); peak {info.get('peak_bytes', 0) / 2**30:.2f} GiB; "
              f"steps {[round(t * 1e3, 1) for t in info['step_s']]} ms; collectives a "
              f"step: {_shard_collectives(info['collectives'][-1])}; launches a step "
              f"{_main_launches(info['launches'][-1])}; aten GEMM / SDPA ops "
              f"{info.get('aten_library_step', 'not profiled') or 'none'}", flush=True)
        if info["param_bytes"] != want or info["moment_bytes"] != 2 * want:
            raise AssertionError(f"shard {name} rank {r}: resident {info['param_bytes']}"
                                 f" / {info['moment_bytes']} B, the spec's blocks {want} B")
        if info.get("aten_library_step"):
            raise AssertionError(f"shard {name}: library ops {info['aten_library_step']}")
    res[name] = infos


def _layout_serve(cell, control_leaf, out, infos, dev, card, log, res) -> None:
    """A serving layout cell against the unsharded run on the card: the
    logits of the prefill and every decode step (teacher-forced on the fed
    tokens) beside the control, the greedy tokens off near ties, the
    resident parameter and cache bytes against the spec's blocks, and the
    recurrent states: bitwise equal on every rank, and the unsharded
    run's."""
    import gc

    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import transformer as tt
    from repro_torch.runtime import sharding

    cfg = _layout_cfg(cell)
    name, gen = cell["name"], cell["gen"]
    bf16 = cfg.policy_name != "fp32"
    params = tt.init_params(cfg, seed=SEED, device=dev)
    want, states = _shard_rows(out["prompts"], out["fed"], params, cfg, gen, dev, True)
    _flip_block(params, cfg, cell, control_leaf)
    control = _shard_rows(out["prompts"], out["fed"], params, cfg, gen, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    what = (f"{cfg.name} serve ({cfg.n_layers} layers, {cell['batch']} x "
            f"({cell['prompt']} + {gen}), {cfg.policy_name}, "
            f"{'serve_rules' if cell.get('serve_rules', True) else 'Rules()'}"
            f"{', sp' if cell.get('sequence_parallel') else ''}) logits")
    err = _shard_compare(what, out["logits"], want, control,
                         SH_BF16_TOL if bf16 else SH_FP32_TOL, log)
    agree, n = _greedy_agree(out["fed"], want, 2 * err)
    print(f"[shard] {name}: greedy tokens equal to the unsharded argmax: {agree} of the "
          f"{n} of {out['fed'].numel()} off a near tie", flush=True)
    if agree != n:
        raise AssertionError(f"shard {name}: {n - agree} greedy tokens differ off a tie")
    if states:
        same = len({i["state_digest"] for i in infos}) == 1
        worst = max((out["states"][k] - v).abs().max().item() / max(v.abs().max().item(),
                                                                        1e-30)
                    for k, v in states.items())
        ok = same and (bf16 or worst <= SH_FP32_TOL)
        log.append({"check": f"shard {name} recurrent states", "ranks_bitwise": same,
                    "rel_err": worst, "ok": ok})
        print(f"[check] shard {name} recurrent states ({len(states)} leaves): every rank "
              f"{'bitwise equal' if same else 'DIFFERS'}; vs the unsharded run "
              f"{worst:.3e} of max ({'printed' if bf16 else f'tol {SH_FP32_TOL:g}'}): "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"shard {name}: recurrent states")
    rules = _layout_rules(cell)
    T = -(-(cell["prompt"] + gen) // cell["mesh"][1]) * cell["mesh"][1]
    with sharding.use_mesh(None):
        whole_cache = tt.init_cache(cfg, cell["batch"], T, device="meta")
    for r, info in enumerate(infos):
        mesh = mesh_lib.Mesh(tuple(cell["mesh"]), ("data", "model"), rank=r)
        kv = _local_bytes(serve_lib.cache_spec_tree(cfg, rules, mesh, cell["batch"], T),
                          whole_cache, mesh)
        pb = _local_bytes(sharding.sanitize_tree(tt.param_specs(cfg, rules),
                                                 tt.abstract_params(cfg), mesh),
                          tt.abstract_params(cfg), mesh) // 4 * (2 if bf16 else 4)
        steps = info["decode_steps"]
        print(f"[shard] ({card}) {name} rank {r}: params {info['param_bytes']} B, cache "
              f"{info['kv_bytes']} B (the spec's blocks: {pb} / {kv} B); peak "
              f"{info.get('peak_bytes', 0) / 2**30:.2f} GiB; prefill "
              f"{info['prefill_s'] * 1e3:.1f} ms, decode {info['decode_s'] / steps * 1e3:.1f}"
              f" ms a step; collectives a prefill: "
              f"{_shard_collectives(info['collectives_prefill'])}; a decode step: "
              f"{_shard_collectives(info['collectives_decode'], steps)}; launches prefill "
              f"{_main_launches(info['launches_prefill'])}, decode "
              f"{_main_launches(info['launches_decode'])}; aten GEMM / SDPA ops "
              f"{info.get('aten_library_decode', 'not profiled') or 'none'}", flush=True)
        if info["kv_bytes"] != kv or info["param_bytes"] != pb:
            raise AssertionError(f"shard {name} rank {r}: resident {info['param_bytes']} /"
                                 f" {info['kv_bytes']} B, the spec's blocks {pb} / {kv} B")
        if info.get("aten_library_decode"):
            raise AssertionError(f"shard {name}: library ops {info['aten_library_decode']}")
    res[name] = infos


def _shard_compare(what, got, want, control, tol, log) -> float:
    """``got`` against ``want`` within ``tol`` of max |want|; ``control``
    (the unsharded run with one rank's shard corrupted) must fail it."""
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    cerr = (control - want).abs().max().item()
    ok = math.isfinite(err) and err <= tol * scale and cerr > tol * scale
    log.append({"check": f"shard {what}", "max_abs_err": err, "tol": tol * scale,
                "control_err": cerr, "ok": ok})
    print(f"[check] shard {what}, sharded vs unsharded: max_abs_err={err:.3e} "
          f"({err / scale:.3e} of max) tol={tol * scale:.3e}; control "
          f"{cerr / scale:.3e} of max: {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"shard {what}: sharded {err:.3e}, control {cerr:.3e}, "
                             f"bound {tol * scale:.3e}")
    return err / scale


def _greedy_agree(fed, want, tol) -> tuple:
    """``(greedy tokens of the sharded run equal to the unsharded argmax,
    tokens compared)`` over every (step, row) whose unsharded top-2 margin
    is at least ``tol`` of max |logit| (twice the measured gap; a nearer
    tie either layout may break).  Both runs were fed the same tokens."""
    top2 = want[:-1].topk(2, dim=-1).values
    off_tie = (top2[..., 0] - top2[..., 1]) / want.abs().max() >= tol   # (steps, B)
    same = want[:-1].argmax(-1) == fed.T
    return int((same & off_tie).sum()), int(off_tie.sum())


def _shard_collectives(stats: dict, steps: int = 1) -> str:
    return ", ".join(f"{k} {v['count'] / steps:.0f} x / {v['bytes'] / steps / 1e6:.3f} MB / "
                     f"{v['seconds'] / steps * 1e3:.2f} ms" for k, v in sorted(stats.items()))


def shard_phase(log, counters):
    """The sharding runtime on two ranks of one card (see the module
    docstring): each cell held against the unsharded run in this process,
    from the same seed, beside a control that must fail."""
    import concurrent.futures
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.core import engine
    from repro_torch.models import transformer as tt
    from repro_torch.runtime import procs

    card = _card()
    dev = torch.device(SH_DEVICE)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="shard_", dir=str(ROOT / "chiprun_out"))
    qwen = dict(arch=ARCH, full=SH_FULL, mesh=SH_MESH, seed=SEED)
    moe = dict(arch="deepseek-moe-16b", full=SH_FULL, mesh=SH_MESH, seed=SEED,
               policy_name="fp32", **SH_MOE)
    plan = [dict(name="qwen_serve", kind="serve", profile=True, **qwen, **SH_SERVE),
            dict(name="qwen_train_fp32", kind="train", policy_name="fp32", **qwen,
                 **SH_TRAIN),
            dict(name="qwen_train_bf16", kind="train", profile=True, **qwen, **SH_TRAIN),
            dict(name="moe_gspmd", kind="serve", moe_impl="gspmd", **moe),
            dict(name="moe_shard_map", kind="serve", moe_impl="shard_map", **moe)]
    layouts = [dict(_layout_cell(cell, leaves), profile=cell["kind"] == "serve")
               for cell, _, leaves in SH_LAYOUTS]
    res: dict = {"card": card}
    pool = concurrent.futures.ThreadPoolExecutor(3)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        # two spawns of two ranks side by side on the card (the slice-13
        # cells; the dry run's layouts), and this process's unsharded
        # training references once the layout ranks are past their MLA
        # cells (the largest on the card: with them, the card has no room
        # for the references)
        runs = {}
        for tag, cells in (("shard ranks", plan), ("layout ranks", layouts)):
            d = Path(tmp, tag.split()[0])
            d.mkdir()
            Path(d, "plan.json").write_text(json.dumps(cells))
            runs[tag] = pool.submit(_ft_launch, "repro_torch.launch.mesh", 2,
                                    ["--device", SH_DEVICE, "--plan",
                                     str(Path(d, "plan.json")), "--out", str(d)],
                                    str(d), tag)
        parts = {}

        def ranks(tag):
            rc, out, dt = runs[tag].result()
            if rc != 0:
                raise AssertionError(f"shard: a rank exited {rc}: {out[-1500:]}")
            parts[tag.replace(" ", "_")] = dt

        def ready(name, d="layout"):
            """Wait for a cell's results (each file appears whole) while its
            spawn runs on; a failed spawn raises."""
            files = [Path(tmp, d, f"{name}.pt")] + [
                Path(tmp, d, f"{name}.rank{r}.json") for r in (0, 1)]
            tag = f"{d} ranks"
            while not all(f.exists() for f in files):
                if runs[tag].done():
                    ranks(tag)
                    if not all(f.exists() for f in files):
                        raise AssertionError(f"shard: no results for {name}")
                time.sleep(0.2)

        # the four-rank (2, 2) cell on the host's CPU, beside the spawns
        cpu4 = _layout_cell(SH_CPU4[0], SH_CPU4[2])
        cpu_dir = Path(tmp, "cpu4")
        cpu_dir.mkdir()
        Path(cpu_dir, "plan.json").write_text(json.dumps([cpu4]))
        cpu_run = pool.submit(_ft_launch, "repro_torch.launch.mesh", 4,
                              ["--device", "cpu", "--plan", str(Path(cpu_dir, "plan.json")),
                               "--out", str(cpu_dir)], str(cpu_dir), "shard cpu ranks")
        ready(layouts[1]["name"])
        t1 = time.perf_counter()
        refs = {c["name"]: _layout_train_refs(c, ctl, leaves, dev)
                for c, (_, ctl, leaves) in zip(layouts, SH_LAYOUTS) if c["kind"] == "train"}
        refs[cpu4["name"]] = _layout_train_refs(cpu4, SH_CPU4[1], SH_CPU4[2], dev, "cpu")
        parts["train_refs"] = time.perf_counter() - t1

        def load(name, d="shard"):
            infos = [json.loads(Path(tmp, d, f"{name}.rank{r}.json").read_text())
                     for r in (0, 1)]
            return torch.load(Path(tmp, d, f"{name}.pt"), weights_only=False), infos

        launches = {}
        checked = set()

        def check_layouts(wait: bool) -> None:
            """The dry run's layout cells, each against its unsharded run
            as its results appear (``wait``: all of them; else those
            already there while the slice-13 spawn runs)."""
            t1 = time.perf_counter()
            for cell, (_, control_leaf, leaves) in zip(layouts, SH_LAYOUTS):
                name = cell["name"]
                if name in checked:
                    continue
                if not wait and (runs["shard ranks"].done()
                                 or not Path(tmp, "layout", f"{name}.pt").exists()):
                    return
                ready(name)
                out, infos = load(name, "layout")
                if cell["kind"] == "train":
                    _layout_train(cell, refs[name], leaves, out, infos, card, log, res)
                    launches[name] = {k: sum(s[k] for s in infos[0]["launches"])
                                      for k in infos[0]["launches"][0]}
                else:
                    _layout_serve(cell, control_leaf, out, infos, dev, card, log, res)
                    launches[name] = {k: infos[0]["launches_prefill"][k]
                                      + infos[0]["launches_decode"][k]
                                      for k in infos[0]["launches_prefill"]}
                checked.add(name)
                parts[name] = time.perf_counter() - t1
                t1 = time.perf_counter()

        check_layouts(wait=False)
        ranks("shard ranks")
        t1 = time.perf_counter()
        # ---- qwen3-1.7b served at full width and depth ----
        cfg = (configs.get if SH_FULL else configs.get_reduced)(ARCH)
        out, infos = load("qwen_serve")
        params = tt.init_params(cfg, seed=SEED, device=dev)
        want = _shard_rows(out["prompts"], out["fed"], params, cfg, SH_SERVE["gen"], dev)
        # the control: rank 1's block of layer 0's wo rows, sign flipped
        wo = params["layers"]["attn"]["wo"]
        half = wo.shape[1] // 2
        wo[0, half:].neg_()
        control = _shard_rows(out["prompts"], out["fed"], params, cfg, SH_SERVE["gen"], dev)
        wo[0, half:].neg_()
        res["qwen_serve_err"] = _shard_compare(
            "qwen3-1.7b serve (28 layers, 4 x (128 + 16), tpu_bf16) logits",
            out["logits"], want, control, SH_BF16_TOL, log)
        agree, n = _greedy_agree(out["fed"], want, 2 * res["qwen_serve_err"])
        print(f"[shard] qwen3-1.7b greedy tokens equal to the unsharded argmax: {agree} "
              f"of the {n} of {out['fed'].numel()} off a near tie", flush=True)
        if agree != n:
            raise AssertionError(f"shard: {n - agree} greedy tokens differ off a tie")
        del params, want, control
        for r, info in enumerate(infos):
            steps = info["decode_steps"]
            print(f"[shard] ({card}) qwen3-1.7b serve rank {r}: peak "
                  f"{info.get('peak_bytes', 0) / 2**30:.2f} GiB, KV cache {info['kv_bytes']} B; "
                  f"prefill {info['prefill_s'] * 1e3:.1f} ms, decode "
                  f"{info['decode_s'] / steps * 1e3:.1f} ms a step; collectives a "
                  f"prefill: {_shard_collectives(info['collectives_prefill'])}; a decode "
                  f"step: {_shard_collectives(info['collectives_decode'], steps)}; "
                  f"launches prefill {_main_launches(info['launches_prefill'])}, "
                  f"decode {_main_launches(info['launches_decode'])}", flush=True)
        T = -(-(SH_SERVE["prompt"] + SH_SERVE["gen"]) // SH_MESH[1]) * SH_MESH[1]
        whole = sum(t.numel() * t.element_size() for sub in tt.init_cache(
            cfg, SH_SERVE["batch"], T, device="meta").values() for t in sub.values())
        if any(i["kv_bytes"] * 2 != whole for i in infos):
            raise AssertionError(f"shard: KV bytes per rank {[i['kv_bytes'] for i in infos]}"
                                 f", the whole cache {whole}")
        lib = infos[0].get("aten_library_decode", {})
        print(f"[shard] decode step profile (rank 0): aten GEMM / SDPA ops "
              f"{lib or 'none'}", flush=True)
        if lib:
            raise AssertionError(f"shard decode: library ops {lib}")
        i0 = infos[0]
        launches["serve"] = {k: i0["launches_prefill"][k] + i0["launches_decode"][k]
                             for k in i0["launches_prefill"]}
        res["qwen_serve"] = infos
        gc.collect()
        torch.cuda.empty_cache()
        parts["serve_unsharded"] = time.perf_counter() - t1
        t1 = time.perf_counter()

        # ---- qwen3-1.7b, two layers at full width, trained ----
        from repro_torch.data import SyntheticLM
        from repro_torch.launch import train as train_lib
        from repro_torch.optim import AdamW
        for tag, pol in (("fp32", "fp32"), ("bf16", "tpu_bf16")):
            out, infos = load(f"qwen_train_{tag}")
            c = dataclasses.replace(cfg, n_layers=SH_TRAIN["n_layers"], policy_name=pol)
            ds = SyntheticLM(c.vocab_size, SH_TRAIN["seq"], SH_TRAIN["batch"], seed=0)
            batch = {k: torch.from_numpy(v) for k, v in ds.batch(0).items()}

            def unsharded(flip):
                st = train_lib.init_state(c, AdamW(), seed=SEED, device=dev)
                if flip:
                    with torch.no_grad():
                        st.params["layers"]["attn"]["wo"][0, half:].neg_()
                _, m = train_lib.build_train_step(c, AdamW(), return_grads=True)(st, batch)
                return float(m["loss"]), {k: v.float().cpu() for k, v in
                                          _flat_named(m["grads"]).items()}

            loss, grads = unsharded(False)
            closs, cgrads = unsharded(True)
            got = _flat_named(out["grads0"])
            print(f"[shard] train {tag}: step-0 loss sharded {infos[0]['losses'][0]!r}, "
                  f"unsharded {loss!r}, control {closs!r}", flush=True)
            for name in ("embed", "layers/attn/wqkv", "layers/attn/wo", "layers/mlp/w_in",
                         "layers/mlp/w_out", "layers/ln1"):
                if tag == "fp32":
                    _shard_compare(f"qwen3-1.7b train (2 layers, 4 x 256, fp32) step-0 "
                                   f"grad {name}", got[name], grads[name], cgrads[name],
                                   SH_FP32_TOL, log)
                else:
                    e = (got[name] - grads[name]).abs().max() / grads[name].abs().max()
                    print(f"[shard] train bf16 step-0 grad {name}: {e.item():.3e} of max "
                          f"(printed, not a check)", flush=True)
            if tag == "fp32":
                lt = torch.tensor([infos[0]["losses"][0]])
                _shard_compare("qwen3-1.7b train (2 layers, fp32) step-0 loss", lt,
                               torch.tensor([loss]), torch.tensor([closs]), SH_FP32_TOL, log)
            for r, info in enumerate(infos):
                print(f"[shard] ({card}) train {tag} rank {r}: peak "
                      f"{info.get('peak_bytes', 0) / 2**30:.2f} GiB; steps "
                      f"{[round(t * 1e3, 1) for t in info['step_s']]} ms; losses "
                      f"{info['losses']}; collectives a step: "
                      f"{_shard_collectives(info['collectives'][-1])}; launches a step "
                      f"{_main_launches(info['launches'][-1])}", flush=True)
            if tag == "bf16":
                lib = infos[0].get("aten_library_step", {})
                print(f"[shard] train step profile (rank 0): aten GEMM / SDPA ops "
                      f"{lib or 'none'}", flush=True)
                if lib:
                    raise AssertionError(f"shard train: library ops {lib}")
            launches[f"train_{tag}"] = {k: sum(s[k] for s in infos[0]["launches"])
                                        for k in infos[0]["launches"][0]}
            res[f"qwen_train_{tag}"] = infos
            del grads, cgrads
        gc.collect()
        torch.cuda.empty_cache()
        parts["train_unsharded"] = time.perf_counter() - t1
        t1 = time.perf_counter()

        # ---- deepseek-moe-16b, three layers at full width, both routes ----
        get = configs.get if SH_FULL else configs.get_reduced
        mcfg = dataclasses.replace(get("deepseek-moe-16b"),
                                   n_layers=SH_MOE["n_layers"], policy_name="fp32")
        # unsharded, both routes are the one dispatch: one run (and one
        # control, the w_out of experts 0 and E / 2 of the first MoE layer
        # swapped: one on each rank) on the tokens both routes fed
        mparams = tt.init_params(mcfg, seed=SEED, device=dev)
        first, _ = load("moe_gspmd")
        want = _shard_rows(first["prompts"], first["fed"], mparams, mcfg, SH_MOE["gen"], dev)
        w = mparams["layers"]["moe"]["w_out"]
        pair = [0, w.shape[1] // 2]
        w[0, pair] = w[0, pair[::-1]]
        control = _shard_rows(first["prompts"], first["fed"], mparams, mcfg,
                              SH_MOE["gen"], dev)
        del mparams
        parts["moe_unsharded"] = time.perf_counter() - t1
        for impl in ("gspmd", "shard_map"):
            out, infos = load(f"moe_{impl}")
            if not torch.equal(out["fed"], first["fed"]):
                raise AssertionError("shard moe: the two routes fed other tokens")
            e = _shard_compare(f"deepseek-moe-16b serve (3 layers, 4 x (128 + 8), "
                               f"fp32, {impl}) logits", out["logits"], want, control,
                               SH_FP32_TOL, log)
            agree, n = _greedy_agree(out["fed"], want, 2 * e)
            print(f"[shard] deepseek-moe-16b {impl}: greedy tokens equal to the unsharded "
                  f"argmax: {agree} of the {n} off a near tie; routes taken on rank 0 "
                  f"{infos[0]['route']}", flush=True)
            if agree != n or not infos[0]["route"].get(impl):
                raise AssertionError(f"shard moe {impl}: tokens {agree}/{n}, routes "
                                     f"{infos[0]['route']}")
            for r, info in enumerate(infos):
                steps = info["decode_steps"]
                print(f"[shard] ({card}) deepseek-moe-16b {impl} rank {r}: peak "
                      f"{info.get('peak_bytes', 0) / 2**30:.2f} GiB, KV cache {info['kv_bytes']} B;"
                      f" prefill {info['prefill_s'] * 1e3:.1f} ms, decode "
                      f"{info['decode_s'] / steps * 1e3:.1f} ms a step; collectives a "
                      f"decode step: {_shard_collectives(info['collectives_decode'], steps)}",
                      flush=True)
            launches[f"moe_{impl}"] = {k: infos[0]["launches_prefill"][k]
                                       + infos[0]["launches_decode"][k]
                                       for k in infos[0]["launches_prefill"]}
            res[f"moe_{impl}"] = infos
        del want, control
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the rest of the dry run's layouts ----
        check_layouts(wait=True)
        ranks("layout ranks")
        rc, cout, dt = cpu_run.result()
        if rc != 0:
            raise AssertionError(f"shard: a CPU rank exited {rc}: {cout[-1500:]}")
        parts["cpu4_ranks"] = dt
        infos = [json.loads(Path(cpu_dir, f"{cpu4['name']}.rank{r}.json").read_text())
                 for r in range(4)]
        out = torch.load(Path(cpu_dir, f"{cpu4['name']}.pt"), weights_only=False)
        _layout_train(cpu4, refs[cpu4["name"]], SH_CPU4[2], out, infos, "host CPU", log,
                      res)
        parts["cpu4_check"] = time.perf_counter() - t1

        # kernel 2 takes an empty group (a slot whose KV lies on the other
        # rank): its rows come back zero, as the plain version's do
        x = torch.randn(3, 8, 64, device=dev, dtype=torch.bfloat16)
        wg = torch.randn(3, 64, 16, device=dev, dtype=torch.bfloat16)
        sizes = [5, 0, 8]
        z = engine.grouped_matmul(x, wg, group_sizes=sizes, policy="tpu_bf16")
        zc = engine.grouped_matmul(x.cpu(), wg.cpu(), group_sizes=sizes, policy="tpu_bf16")
        _check("kernel 2 grouped GEMM with an empty group", z.cpu(), zc, 2.0 ** -7, log)
        if z[1].abs().max().item() != 0:
            raise AssertionError("shard: the empty group's rows are not zero")

        total = {}
        for run in launches.values():
            for k, v in run.items():
                total[k] = total.get(k, 0) + v
        path = {name: total.get(f"{fn.__name__}.{attr}", 0)
                for name, (fn, attr) in counters.items()}
        _require(path, ["redmule_matmul", "redmule_matmul_batched", "flash_attention",
                        "chunked_linear_attention"], "shard")
        res.update(launches=path, launches_by_cell=launches, seconds=parts)
    finally:
        print(f"[shard] seconds by part: " + ", ".join(
            f"{k} {v:.1f}" for k, v in locals().get("parts", {}).items()), flush=True)
        pool.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# the dry run (launch/dryrun.py) against the layout cells that ran on the
# card: every prediction equal to the rank (collectives per kind, resident
# bytes, engine bill) and its peak within DR_MEM_BOUND of the rank's
# max_memory_allocated over the same steps (relative), beside the same
# cell with its batch doubled, which must miss it where the batch moves
# the peak.  Then the reference's production cells at full width,
# and the lmtrain step against its one-card bound.
# the largest gap measured on an H100 80GB HBM3 (700 W) was 2.8e-3
# (hymba_train; PERF.md section 5)
DR_MEM_BOUND = 0.005
DR_WORKERS = 4
DR_PROD = (("qwen3-1.7b", "train_4k", False), ("qwen3-1.7b", "decode_32k", False),
           ("deepseek-v2-lite-16b", "train_4k", True), ("xlstm-1.3b", "long_500k", False))


def _dry_predict(cell, batch_scale: int = 1) -> dict:
    """Rank 0 of a layout cell traced on meta tensors (the card's contract):
    its collectives per kind, resident bytes, engine bill and peak bytes."""
    import dataclasses

    from repro_torch.core import precision as prec
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib

    cell = _layout_cell(cell, ())
    cfg = _layout_cfg(cell)
    mesh = mesh_lib.Mesh(tuple(cell["mesh"]), ("data", "model"))
    rules = _layout_rules(cell)
    B = cell["batch"] * batch_scale
    if cell["kind"] == "train":
        # the rank worker's step keeps a copy of its gradients
        got = dryrun.trace_train(cfg, mesh, rules, batch=B, seq=cell["seq"],
                                 grad_accum=cell.get("grad_accum", 1),
                                 return_grads=True)
        return {"collectives": got.collective_stats(), "bill": got.bill(),
                "resident": got.resident, "peak": got.peak_bytes,
                "seconds": got.seconds}
    cfg = dataclasses.replace(cfg, param_dtype=prec.dtype_name(cfg.compute_dtype))
    S, G, m = cell["prompt"], cell["gen"], cell["mesh"][1]
    T = -(-(S + G) // m) * m
    pre = dryrun.trace_prefill(cfg, mesh, rules, batch=B, seq=S, max_len=T)
    steps = [dryrun.trace_decode(cfg, mesh, rules, batch=B, max_len=T, pos=S + i)
             for i in range(G)]
    stats: dict = {}
    for st in steps:
        for k, v in st.collective_stats().items():
            d = stats.setdefault(k, {"count": 0, "bytes": 0})
            d["count"] += v["count"]
            d["bytes"] += v["bytes"]
    bill = {q: {d: sum(st.bill()[q][d] for st in steps) for d in ("fwd", "bwd")}
            for q in ("flops", "bytes")}
    return {"collectives_prefill": pre.collective_stats(), "collectives_decode": stats,
            "bill_prefill": pre.bill(), "bill_decode": bill,
            "resident": dict(pre.resident, kv_bytes=steps[0].resident["kv_bytes"]),
            "peak": max([pre.peak_bytes] + [st.peak_bytes for st in steps]),
            "seconds": pre.seconds + sum(st.seconds for st in steps)}


def _dry_task(task):
    """One dry-run trace of the dryrun phase, in a worker process."""
    kind, args = task
    if kind == "cell":
        return _dry_predict(*args)
    from repro_torch.launch import dryrun

    if kind == "prod":
        arch, shape, multi = args
        return dryrun.dryrun_cell(arch, shape, multi_pod=multi, verbose=False)
    # the lmtrain step (qwen3-1.7b, L_BATCH x L_SEQ) on one card
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.roofline import analysis
    from repro_torch.runtime import sharding

    cfg = configs.get(ARCH)
    got = dryrun.trace_train(cfg, mesh_lib.Mesh((1, 1), ("data", "model")),
                             sharding.Rules(), batch=L_BATCH, seq=L_SEQ)
    rep = analysis.roofline(got.trace, arch=ARCH, shape=f"{L_BATCH}x{L_SEQ}",
                            mesh_name="1x1", n_devices=1,
                            model_flops_val=analysis.model_flops(
                                cfg, configs.ShapeSpec("lm", "train", L_SEQ, L_BATCH)))
    return {"bound_s": rep.bound_s, "dominant": rep.dominant, "peak": got.peak_bytes,
            "compute_s": rep.compute_s, "memory_s": rep.memory_s}


def start_dry_traces():
    """Start the dryrun phase's traces (host CPU only, no card) in
    DR_WORKERS processes; they need the cells' descriptions, not their
    runs, so they run beside the ft phase, whose ranks leave most host
    cores idle.  Returns what :func:`dryrun_phase` waits on."""
    import concurrent.futures
    import multiprocessing

    tasks = [("cell", (cell, scale)) for cell, _, _ in SH_LAYOUTS for scale in (1, 2)]
    tasks += [("prod", p) for p in DR_PROD] + [("one", ())]
    # the longest traces first
    tasks.sort(key=lambda t: t[0] != "cell" or t[1][0]["name"] not in
               ("xlstm_train", "mla_train", "mla_serve", "qwen_fsdp"))
    pool = concurrent.futures.ProcessPoolExecutor(
        DR_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    t0 = time.perf_counter()
    futures = {repr(t): pool.submit(_dry_task, t) for t in tasks}
    ends: dict = {}
    for k, f in futures.items():
        f.add_done_callback(lambda _f, k=k: ends.setdefault(k, time.perf_counter()))
    return pool, futures, t0, ends


def dryrun_phase(log, shard, lmtrain, traces):
    """The dry run: each layout cell's prediction against its ranks; the
    reference's production cells at full width; the lmtrain step against
    the dry run's one-card bound.  The traces were started before the ft
    phase (:func:`start_dry_traces`); this phase waits for them.  Every
    term is an estimate from H100 data-sheet constants
    (roofline/analysis.py), not a measurement."""
    from repro_torch.launch import dryrun

    card = _card()
    strip = lambda st: {k: {"count": v["count"], "bytes": v["bytes"]}
                        for k, v in st.items()}
    pool, futures, t0, ends = traces
    t_wait = time.perf_counter()
    try:
        done = {k: f.result() for k, f in futures.items()}
    finally:
        pool.shutdown()
    print(f"[dryrun] {len(done)} traces in {max(ends.values()) - t0:.1f} s on "
          f"{DR_WORKERS} host processes beside the ft and shard phases; this "
          f"phase waited {time.perf_counter() - t_wait:.1f} s for them", flush=True)
    res: dict = {"card": card, "cells": {}, "traces_s": max(ends.values()) - t0}
    for cell, _, _ in SH_LAYOUTS:
        infos = shard[cell["name"]]
        want, twice = (done[repr(("cell", (cell, k)))] for k in (1, 2))
        for r, info in enumerate(infos):
            if cell["kind"] == "train":
                pairs = [("collectives", strip(info["collectives"][0]), want["collectives"]),
                         ("bill", info["bill"][0], want["bill"]),
                         ("param_bytes", info["param_bytes"], want["resident"]["param_bytes"]),
                         ("moment_bytes", info["moment_bytes"],
                          want["resident"]["moment_bytes"])]
            else:
                pairs = [(k, strip(info[k]) if k.startswith("coll") else info[k], want[k])
                         for k in ("collectives_prefill", "collectives_decode",
                                   "bill_prefill", "bill_decode")]
                pairs += [(k, info[k], want["resident"][k])
                          for k in ("param_bytes", "kv_bytes")]
            bad = [k for k, got, w in pairs if got != w]
            log.append({"check": f"dryrun {cell['name']} rank {r}: collectives, "
                        "resident bytes and engine bill equal the rank's",
                        "ok": not bad, "differ": bad})
            if bad:
                raise AssertionError(f"dryrun {cell['name']} rank {r}: {bad} differ: "
                                     + "; ".join(f"{k} run {g} predicted {w}"
                                                 for k, g, w in pairs if k in bad))
        # the rank's peak over the steps the trace predicts (not its
        # weights' init, which draws whole leaves)
        peak = infos[0]["peak_steps_bytes"]
        peak = peak[0] if isinstance(peak, list) else peak
        gap, gap2 = want["peak"] / peak - 1, twice["peak"] / peak - 1
        print(f"[dryrun] ({card}) {cell['name']}: predicted == rank on collectives, "
              f"resident bytes, bill; peak predicted {want['peak'] / 2**30:.3f} GiB, "
              f"max_memory_allocated {peak / 2**30:.3f} GiB (gap {gap:+.4f}), batch x2 "
              f"predicted {twice['peak'] / 2**30:.3f} GiB (gap {gap2:+.4f}); traced in "
              f"{want['seconds']:.1f} s", flush=True)
        res["cells"][cell["name"]] = {"peak_pred": want["peak"], "peak_run": peak,
                                      "peak_pred_x2": twice["peak"], "gap": gap,
                                      "gap_x2": gap2, "trace_s": want["seconds"]}
        # the control: the batch doubled must miss the bound wherever it
        # moves the traced peak by more than twice the bound (activations
        # set the peak); where AdamW over the whole state sets it, no
        # batch can move it and the control is printed as such
        moves = abs(twice["peak"] / want["peak"] - 1) > 2 * DR_MEM_BOUND
        ok = abs(gap) <= DR_MEM_BOUND and (abs(gap2) > DR_MEM_BOUND or not moves)
        log.append({"check": f"dryrun {cell['name']} peak within {DR_MEM_BOUND} of the "
                    "rank's steps, batch x2 outside where it moves the peak",
                    "ok": ok, "gap": gap, "gap_x2": gap2, "control_applies": moves})
        if not moves:
            print(f"[dryrun] {cell['name']}: batch x2 moves the traced peak by "
                  f"{twice['peak'] / want['peak'] - 1:+.5f} (the optimizer over the "
                  "whole state sets it): no batch control can miss the bound here",
                  flush=True)
        if not ok:
            raise AssertionError(f"dryrun {cell['name']}: peak gap {gap:+.4f}, "
                                 f"batch x2 {gap2:+.4f}, bound {DR_MEM_BOUND}")
    print("[dryrun] the production cells (estimates from H100 data-sheet constants, "
          f"not measurements; card here: {card}):", flush=True)
    for p in DR_PROD:
        rec = done[repr(("prod", p))]
        print(dryrun.cell_line(rec), flush=True)
        res[f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"] = rec
    one = done[repr(("one", ()))]
    step_s = lmtrain["history"][-1]["step_ms"] / 1e3
    print(f"[dryrun] ({card}) lmtrain step qwen3-1.7b {L_BATCH} x {L_SEQ} on one card: "
          f"measured {step_s * 1e3:.1f} ms, dry-run bound {one['bound_s'] * 1e3:.2f} ms "
          f"({one['dominant']}-bound estimate: compute {one['compute_s'] * 1e3:.2f} ms, "
          f"memory {one['memory_s'] * 1e3:.2f} ms), measured / bound "
          f"{step_s / one['bound_s']:.2f}; peak predicted {one['peak'] / 2**30:.2f} GiB, "
          f"measured {lmtrain['peak_mem_step_gib']:.2f} GiB (printed, not a check)",
          flush=True)
    res["lmtrain"] = dict(one, step_s=step_s, ratio=step_s / one["bound_s"],
                          peak_run_gib=lmtrain["peak_mem_step_gib"])
    return res


def _main_launches(counts: dict) -> dict:
    """A rank's launches of each kernel (its wrappers' ``.launches``)."""
    return {k.split(".")[0]: v for k, v in counts.items() if k.endswith(".launches")}


def _unflat(named: dict) -> dict:
    """:func:`_flat_named`'s inverse: "a/b" paths back to nested dicts."""
    out: dict = {}
    for path, v in named.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _flat_named(tree, pre=""):
    if hasattr(tree, "shape"):
        return {pre: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat_named(v, f"{pre}/{k}" if pre else k))
    return out


def _to_cpu(tree):
    if hasattr(tree, "cpu"):
        return tree.cpu()
    return {k: _to_cpu(v) for k, v in tree.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = _card()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    report = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.1f}s", flush=True)
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"[ptxas] {name}: {line.strip()}")
    log: list = []
    phase_s = {}

    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    progress = ROOT / "chiprun_out" / "chip_smoke_phases.json"

    def timed(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        phase_s[name] = time.perf_counter() - t
        print(f"[phase] {name} {phase_s[name]:.1f}s", flush=True)
        # each phase's seconds as it ends (a failing run keeps them)
        progress.write_text(json.dumps({"card": card, "build_s": build_s,
                                        "phase_s": phase_s}, indent=1))
        return result

    kernels, counters, row_paths = timed("kernels", kernel_phase, log)
    serve = timed("serve", serve_phase, log, counters)
    train = timed("train", train_phase, log, counters)
    lmtrain = timed("lmtrain", lmtrain_phase, log, counters)
    traces = start_dry_traces()
    ft = timed("ft", ft_phase, log, counters)
    shard = timed("shard", shard_phase, log, counters)
    dry = timed("dryrun", dryrun_phase, log, shard, lmtrain, traces)
    ae = timed("ae", ae_phase, log, counters)
    ae8 = timed("ae8", ae8_phase, log, counters)
    serve8 = timed("serve8", serve8_phase, log, counters)
    moeserve = timed("moeserve", moeserve_phase, log, counters)
    moecut = timed("moecut", moe_cuts, log)
    moetrain = timed("moetrain", moetrain_phase, log, counters)
    ssmserve = timed("ssmserve", ssmserve_phase, log, counters)
    hymbaserve = timed("hymbaserve", hymbaserve_phase, log, counters)
    hymbatrain = timed("hymbatrain", hymbatrain_phase, log, counters)
    ssmcut = timed("ssmcut", ssm_cuts, log)
    sched = timed("sched", sched_phase, log, counters)
    tune = timed("tune", tune_phase, log)
    runs = {"serve": serve["launches"], "train": train["launches"],
            "lmtrain": lmtrain["launches"], "ft": ft["launches"],
            "shard": shard["launches"],
            "ae": ae["launches"], "ae_fp32": ae["launches_fp32"],
            "ae_b4096": ae["launches_b4096"], "ae8": ae8["launches"],
            "ae8_b4096": ae8["launches_b4096"], "ae8_e5m2": ae8["launches_e5m2"],
            "serve8": serve8["launches"], "moeserve": moeserve["launches"],
            "moetrain": moetrain["launches"], "ssmserve": ssmserve["launches"],
            "hymbaserve": hymbaserve["launches"], "hymbatrain": hymbatrain["launches"],
            "sched": sched["launches"]}
    for kern in kernels:
        # a path outside the row's ``paths`` does not run its shape: null
        paths = row_paths.get(kern["name"], tuple(runs))
        by_path = {p: (runs[p][kern["name"]] if p in paths else None)
                   for p in runs}
        kern["launches"] = sum(v for v in by_path.values() if v is not None)
        kern["launches_by_path"] = by_path
    split_by_path = {p: {k.split(": ")[1]: v for k, v in runs[p].items()
                         if k.startswith("split launches: ")} for p in runs}
    print(f"[report] split launches per path: {json.dumps(split_by_path)}", flush=True)
    out = {"card": card, "build_s": build_s, "phase_s": phase_s, "checks": log,
           "serve": serve,
           "train": train, "lmtrain": lmtrain, "ft": ft, "shard": shard,
           "dryrun": dry, "ae": ae,
           "ae8": ae8,
           "serve8": serve8, "moeserve": moeserve, "moecut": moecut,
           "moetrain": moetrain, "ssmserve": ssmserve, "hymbaserve": hymbaserve,
           "hymbatrain": hymbatrain, "ssmcut": ssmcut, "sched": sched,
           "tune": tune, "kernels": kernels, "split_launches_by_path": split_by_path}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(json.dumps(out, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
