#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before the last
line):

1. card: name and power limit (``nvidia-smi``), then ``nvcc`` builds every
   kernel of the serving path from ``src/repro_torch/csrc/`` for sm_90a,
   one compiler per source, all started together; ptxas's report of each
   kernel (registers, shared memory, spills) is printed.
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at granite-3-8b's full-width shapes, each row of the output within a
   stated tolerance of that row's own scale.  Bitwise: the fused rmsnorm
   output against the standalone rmsnorm of the stored value, split-K
   decode (K5, one launch with its fold) across split counts 1, 2, 4, the
   default and one per tile, K3 (rowwise quantize), every fp32-out int8
   product of K2 (on the s8 wgmma, fed the K-major [N, K] weight; also at
   a 64 x 32 tile, M = 64 and ragged M), K6's decode body against K5 over
   the same history in a dense cache, and K7.  K5's and K6's decode
   partials within 1e-5 of each row's scale.  K6's prefill-chunk body (S
   = 64, the flash-prefill body) within 2 bf16 ulps of each row's scale
   at granite's and gemma2's shapes (local and global with softcap), at G
   = 16 and at every head dim, and ``chunk_contracts``: two launches
   bitwise equal, idle rows and padded tails exactly 0.0, a lane bitwise
   the same when its neighbours' pages and positions move.  K1 is checked
   and timed at both models'
   five projections and at the rows of every driven path (granite 4, 8,
   512 and 1024; gemma2 2, 8, 512 and 8320), and is deterministic: the
   same call twice is bitwise equal, and row 0 is bitwise the same when
   the other rows change.  K2 timed at the scheduler's rows (8, 512),
   beside ``torch._int_mm`` in its faster operand form.  The row passes
   (``check_row_passes``, ``check_row_tails``): the standalone rmsnorm
   bitwise its ordered mirror ``ref.rmsnorm_rows_ref``; K3 bitwise its
   plain version, also on quotients beside the half-integers; at M = 2, 4,
   5 and 8, K1's and K2's normed output in the store phase bitwise the
   standalone rmsnorm of the stored value, and K2's (q, scale) bitwise K3
   of the stored fp32 value, each in one launch; each timed at 8 and 512
   rows (the tails at 2 to 63) beside an empty kernel, the launch floor,
   and in CUPTI kernel time (``kernel_ms``, taken in a last phase after
   phase 5: ``cupti_pass``).
   The sampler (``check_sampler``, plain torch, no kernel): at granite's
   and gemma3's vocab over 8 lanes, fp32 and bf16 logits, the keys, words
   and uniforms bitwise card against CPU, sampled tokens equal (a flip
   only at a near tie), the pick's device ms greedy and sampled.
   Each kernel's device time (CUDA events behind a spin kernel that hides
   the host's launch), its wrapper's time (CUDA events, host work inside
   included),
   its plain version's and one PyTorch library call's device time where
   one computes the same function (a yardstick only; the port never calls
   it) and the least time the card could take (the bound) are recorded.
3. smoke: the whole path on granite-3-8b-smoke (bf16 parameters, as the
   full model has) on the CPU (plain versions) and on the card (kernels):
   greedy tokens through the scheduler must match over 8 steps, bf16 and
   int8, and the card's teacher-forced logits must sit within twice the
   CPU pipeline's own bf16 rounding noise (its distance from an
   fp32-compute run on the same tokens).
4. serve: granite-3-8b at full width and all 40 layers, random weights
   from a seed.  At the init scales two witnesses: three decode steps'
   logits against prefills over the same tokens (``WITNESS_TOL``), and
   the int8 copy's first logits against the bf16 model's
   (``INT8_WITNESS_TOL``).  Then, on weights varied as in phase 3, three
   driven paths, each with the launch counts set to 0 just before it and
   read just after, every kernel of the path launched: the fixed loop
   (``generate_with_status_fixed``, 4 requests of 256 prompt tokens, 16
   greedy tokens each; K1, K4, K5), and continuous batching through
   ``ServeEngine.submit/step`` with 16 requests of 32-448 prompt tokens
   and 16-32 new tokens on 8 lanes (page size 16, chunk 64), once bf16
   (K1, K6) and once int8 (K2, K3, K6).  On each decode path one
   iteration's launches are counted exactly (``decode_launches``: the
   row-norm kernel only for the entry norm and each ``ln2``, no row
   quantize launch under int8).  Every status ok, no request
   repeating one token, and request 0 served alone emitting bitwise the
   tokens it emits amid the churn.  Then the mixed run (``serve_mixed``):
   the same 16 requests, the even ones sampled (temperatures 0.7-1.0, own
   seeds): statuses ok, request 0 alone bitwise amid churn, the greedy
   ones bitwise the greedy run's tokens; and the fault drills through
   ``generate_with_status`` (``fault_drills``): a NaN at step 3 on one
   lane quarantines it alone, an int8 'scale' fault degrades it
   (``fp32_fallback``), a stall past ``request_timeout_s`` times every
   lane out, ``generate_with_retry`` gets through two transient failures,
   the other lanes' tokens bitwise the undrilled run's.  Then K7's one
   entry point, ``ops.addertree``, as the row-parallel reduction of a
   K-split o-projection (``addertree_path``).
5. gemma2: after the granite models are freed, full-width 46-layer
   gemma2-27b (bf16, local and global layers alternating, window 4096,
   softcaps 50 and 30) from seed 0, built once: a decode-vs-prefill
   witness at init scales past the window, then, on varied weights, the
   fixed loop (batch 2, prompt 4160, 16 tokens; K1, K4 local and global
   with softcap, the ring, K5 softcap) and the scheduler (8 requests, one
   with a 4160-token prompt that decodes past position 4096, the others
   32-448; K1, K6 local and global with softcap), every status ok.  Then
   int8 on the one card: the model drawn again from the seed and
   quantized in place, each block's bf16 projections released as its int8
   copy is made (``quantize_params_for_serving(release=True)``), its first
   logits held to the bf16 model's kept from the init scales, and the
   same 8 requests through the scheduler on it (K2 with K3 and its tails,
   K6 local and global with softcap): statuses ok, one decode iteration's
   launches exact, the peak GB of the build and the run printed and held
   under 80 (``serve_released_int8``).
   Phases 2 and 3 hold gemma2's kernel variants at its full shapes (K4
   local and global with softcap at the fixed loop's prefill, timed beside
   SDPA) and its smoke config card against CPU (``check_gemma2_kernels``,
   ``check_local_smoke``).
6. gemma3: after gemma2's model is freed, full-width 48-layer gemma3-12b
   (bf16, 5 local layers to 1 global, window 1024, head dim 256, RoPE
   theta 1e4 and 1e6) from seed 0, built once (``serve_long``, phase 5's
   code): the decode-vs-prefill witness past the window and the int8
   copy's first logits against the bf16 model's at init scales; then, on
   varied weights, the fixed loop (batch 2, prompt 4160, the ring wrapped
   four times, 16 tokens; K1, K4 local and global at hd 256, the ring, K5
   at hd 256) and the scheduler bf16 and int8 (8 requests, one with the
   4160-token prompt; K1 or K2 with K3 and the int8 tails, K6 decode and
   chunk, local and global, at hd 256), every status ok and one decode
   iteration's launches exact.  Phases 2 and 3 hold its kernels at hd 256
   at its full shapes (``check_gemma3_kernels``: K4 beside SDPA, K5
   bitwise across split counts, K6 decode bitwise K5 on global lanes, the
   chunk body with ``chunk_contracts``, also on 128-slot pages; K1 at its
   five projections at rows 2, 8, 512 and 8320 and K2 at 8 and 512) and
   its smoke config at ``head_dim=256`` card against CPU.
7. whisper: after gemma3's model is freed, full-width whisper-small (12
   encoder and 12 decoder layers, d_model 768, 12 heads of 64, the plain
   GELU MLP of 3072, fp32 masters served from their bf16 copy, the
   encoder's and the cross-attention's among them) from seed 0
   (``serve_whisper``): at init scales a decode-vs-prefill witness
   (``long_witness`` with the frames) and the int8 copy's first logits
   against the bf16 model's; then, on varied weights, ``generate_with_status`` (the
   engine falls through to the fixed loop: the model is not pageable) on
   8 clips of 1500 frame embeddings drawn from the seed, a 64-token prompt
   and 64 greedy tokens, bf16 and int8 (K1 with gelu, K4 'full' over the
   encoder and the cross-attention prefill, K4 causal, K5 global and
   'full', K2 with gelu and its quantize tail or row kernel): every
   status ok, every variant launched, one decode iteration's launches
   exact (``decode_launches``: 2 layers + 1 row-norm launches, the entry
   norm, each ``lnx`` and ``ln2``).  Then the checkpoint round trip
   (``checkpoint_round_trip``: save, ``ServeEngine.from_checkpoint``,
   tokens bitwise; a bit flipped in a newer step, the older one served
   and the skip printed) and the sampled fixed loop replayed bitwise from
   its seed.  Phase 2 holds the four variants
   against their plain versions at these shapes, timed beside bound and
   yardstick (``check_whisper_kernels``: K1 gelu at M = 12000 and 8, K2
   gelu with the quantize at M = 8 and 512, K4 'full' over the encoder
   and at Sq 64 against Skv 1500, K5 'full' over the 1500 frames), and
   phase 3 its smoke config card against CPU through the same
   fall-through, bf16 and int8 (``check_fixed_smoke``).
8. llama4: after whisper's model is freed, llama4-scout at full width
   (d_model 5120, 40 q heads over 8 of 128, 16 experts of 8192 top-1 with
   a shared expert, vocab 202048) cut to 8 of its 48 layers (two periods
   of its 3:1 chunked:global pattern, 37.3 GB of bf16 weights) from seed
   0 (``serve_llama4``): at init scales the MoE witness past position
   8192 (``moe_witness``: held on the lanes none of whose tokens the MoE
   dropped); then, on varied weights, the fixed loop (batch 2, prompt
   8448, 16 tokens; K4 chunked across the boundary and global, the ring,
   K5, K1) and the scheduler (8 requests, request 0 an 8180-token prompt
   decoding past 8192; K6 chunked and global, decode and chunk, K1): every
   status ok, every variant launched, one decode iteration's launches
   exact (2 layers + 1 row-norm launches: the MoE has no down GEMM to
   fold the next norm into), request 0 alone bitwise the same amid churn.
   Then the scheduler again on the attention-only int8 copy (``wqkv`` and
   ``wo`` K2 with K3, the MoE shared): the same requests, statuses ok, one
   decode iteration's launches exact; its int8 witness at init scales
   (8 lanes of 512 tokens) is held on the lanes where no token was dropped
   and whose last token the router sent to the same expert in every
   layer in both runs.
   Phase 2 holds K4 chunked at the fixed prefill and K4 'prefix' at
   paligemma's would-be shape (no model calls it) beside SDPA, K6 chunked
   decode (bitwise across split counts) and chunk at G = 5, and K1 at its
   qkv and o projections (``check_llama4_kernels``); phase 3 its smoke
   config card against CPU (``check_local_smoke``).
9. paligemma: after llama4's model is freed, full-width paligemma-3b (18
   layers, d_model 2048, 8 q heads over 1 kv head of 256, d_ff 16384,
   vocab 257216; fp32 masters, the projections served from their bf16
   copy) from seed 0
   (``serve_paligemma``): 8 images' 256 patch embeddings drawn from the
   seed in front of 256 text tokens.  At init scales the decode-vs-prefill
   witness over the prefix and the int8 copy's first logits against the
   bf16 model's; then, on varied weights, ``generate_with_status`` (the
   fall-through to the fixed loop) with 32 greedy tokens, bf16 and int8
   (K1 or K2 with K3 and its tails, K4 'global' over the patches and the
   text and K5, both at hd 256 and G = 8): statuses ok, every variant
   launched, one decode iteration's launches exact.  Phase 2 holds K4 and
   K5 at these shapes beside SDPA (``check_paligemma_kernels``), K1 at its
   five projections at M = 8 and 4096 and K2 at M = 8; phase 3 its smoke
   config card against CPU, bf16 and int8 (``check_fixed_smoke``).
10. serve: full-width recurrentgemma-9b, all 38 layers (26 RG-LRU blocks,
   12 local-attention blocks at hd 256 with G = 16, window 2048), random
   weights from SEED (``serve_recurrentgemma``).  At the init scales the
   decode-vs-prefill witness past the window (2 x 4160, 16 steps), the
   mixers' state carried (8 x 512, one step against a prefill of 513) and
   the int8 witness; then, on varied weights, ``generate_with_status``
   (the fall-through to the fixed loop) bf16 and int8 on 2 x 4160 (16
   tokens) and 8 x 512 (32 tokens): statuses ok, every variant launched,
   one decode iteration's launches exact.  Phase 2 holds K4 'local' at
   this shape beside SDPA (``check_recurrentgemma_kernels``), K1 at its
   widths at M = 8 and 8320 and K2 at M = 8, and times the mixer's plain
   parts (``rglru_rows``: the scan, the fp32 gates, a mixer call); phase
   3 its smoke config card against CPU, bf16 and int8.
11. serve: full-width xlstm-350m, all 24 layers (21 mLSTM blocks of head
   dim 512 and 3 sLSTM blocks, no FFN; 1.87 GB of fp32 masters since PR
   29, served from a 0.80 GB bf16 copy of the projections), random
   weights from SEED
   (``serve_xlstm``).  At the init scales the decode-vs-prefill witness:
   a prefill of 8 x 2048, 64 decode steps, against a prefill of the same
   2112 tokens (a multiple of 64, as the chunkwise prefill requires,
   ROADMAP F10): on one 8-layer period at bf16 and at fp32 compute (the
   fp32 runs' norms their plain version); on all 24 layers the fp32
   distance XL_PRECISION_GAIN below the bf16 one, and the bf16 decode
   within 4x the bf16 prefill's own distance from the fp32 prefill.
   Then, on varied weights, ``generate_with_status`` (the fall-through to the fixed loop: a recurrent state has no pages) bf16
   on 8 x 2048 (32 tokens) and 2 x 8192 (16), and the int8 copy (which
   quantizes nothing) on 8 x 2048, its tokens bitwise the bf16 run's:
   statuses ok, the row-norm kernel launched, one decode iteration's
   launches exact (49: the entry norm, each mixer's inner norm and each
   next norm, and no other kernel of the port).  Phase 2 holds the
   row-norm kernel at the stream's N = 1024 and the mLSTM's N = 2048
   bitwise its ordered mirror at 8 and 16384 rows beside ``F.rms_norm`` (``check_xlstm_kernels``) and
   times the mixers' plain parts (``xlstm_rows``: an mLSTM call and an
   sLSTM call at 8 x 2048 and at decode, the chunk loop alone); phase 3
   its smoke config card against CPU, bf16 and int8.
12. serve: grok-1-314b at full width (d_model 6144, 48 q heads over 8 of
   128, 8 experts of 32768 routed top-2, vocab 131072) cut to 6 of its 64
   layers (60.65 GB of bf16 weights), random weights from SEED
   (``serve_grok``).  First its routing, dispatch and combine card against
   CPU on the same routed inputs at its width (``moe_card_vs_cpu``:
   identical, the combine bitwise although CUDA's ``index_add_`` sums with
   atomics).  At the init scales the MoE witness on 2 x 4160 tokens and
   the int8 witness on 8 x 512, each held on the lanes no entry of which
   was dropped; then, on varied weights, the fixed loop (batch 2, prompt
   4160, 16 tokens; K4 and K5 at G = 6, K1) and the scheduler (8
   requests, request 0 a 4160-token prompt; K6 decode and chunk at G = 6,
   K1), each bf16 and on the attention-only int8 copy (K2 and K3 for
   ``wqkv`` and ``wo``, the MoE shared): statuses ok, every variant
   launched, one decode iteration's launches exact, request 0 alone
   bitwise amid churn, the peak under 80 GB, and a fixed decode step's
   CUPTI device time and idle share beside the bytes bound of its weights
   read once.  Phase 2 holds K4, K5 and K6 at G = 6, K1 at its qkv and o
   at M = 8, 512 and 8320, the row norm at N = 6144 and K2 and K3 on the
   int8 copy's projections at M = 8 (``check_grok_kernels``); phase 3 its
   smoke config card against CPU (``check_local_smoke``).
13. serve: internlm2-1.8b at full width and all 24 layers from its float32
   masters, no ``param_dtype`` override (``serve_internlm2``): the
   entry points serve the projections' bf16 copy (K1 takes bf16 x bf16),
   the int8 copy quantized from the fp32 values.  At the init scales the
   decode and int8 witnesses, then on varied weights the fixed loop and
   the scheduler, bf16 and int8, each path's kernels launched, one decode
   iteration's launches exact, the fixed decode step beside its bytes
   bound.
14. train: internlm2-1.8b at full width and depth, fp32 masters and fp32
   AdamW moments, per-block remat, 8 x 4096 tokens a step in the config's
   2 microbatches (``train_model``): ``Trainer.run`` for 4 steps of
   the synthetic stream with its checkpoint, every kernel of the training
   path launched (K1 and its fp32 store, the row norm, K4 with its
   log-sum-exp, K4's backward once a layer and microbatch), loss and grad
   norm finite; a step more
   from the state in memory and again from the restored checkpoint,
   bitwise equal; 5 steps on one repeated batch, the loss falling at each;
   step ms, tokens/s, the model-FLOP share of 989 TFLOP/s and the peak
   (under 80 GB) printed.  Phase 2 holds K4's log-sum-exp output (its
   first output bitwise K4's), K4's backward at this microbatch and at
   the smoke config's shape against the plain backward at fp32, and K1's
   fp32 store at the weight gradients' shapes (``check_train_kernels``);
   phase 3 the smoke config's 3 train steps card against CPU
   (``check_train_smoke``) and the full-width 2-layer model's loss and
   every gradient card against CPU (``check_train_width``).
15. train: gemma3-12b at full width, one period of its pattern (6
   layers: 5 'local' at window 1024, 1 'global'; hd 256, 16 q heads over
   8), bf16 parameters and fp32 moments, per-block remat, 8 x 4096 tokens
   a step in the config's 4 microbatches (``train_model``, no
   checkpoint): ``Trainer.run`` for 2 steps of the synthetic stream, every
   kernel of the path launched (K4 and its backward in their 'local' and
   global hd-256 variants), K4's backward exactly layers x microbatches x
   steps times, loss and grad norm finite; 2 steps on one repeated batch
   at lr 1e-4, the loss falling at each; step ms, tokens/s, the model-FLOP share and
   the peak (under 80 GB) printed.
16. train: gemma2-27b at full width, one period (2 layers: 'local' at
   window 4096 and 'global', attention softcap 50, final softcap 30; hd
   128, 32 q heads over 16), the same steps in the config's 8
   microbatches of 1 x 4096: K4 and its backward in their softcapped
   variants.  For phases 15 and 16, phase 2 holds K4's backward and its
   log-sum-exp output at their layers' shapes, and the backward at the
   next training slices' (paligemma, llama4's chunks, whisper's encoder,
   the prefix kind; ``check_train_kind_rows``), and phase 3 their smoke
   configs' train steps and their first two layers' gradients at full
   width, card against CPU.
17. train: recurrentgemma-9b at full width, one period of its pattern (3
   layers: two RG-LRU blocks and one 'local' block at window 2048, 16 q
   heads over 1 kv head of 256; 1.71 B parameters, bf16 leaves, the
   gates ``w_a``/``w_i`` among them, widened at use), the same steps in
   the config's 4 microbatches of 2 x 4096 (``train_model``): the RG-LRU's projections, conv, fp32 gates
   and scan under autograd (library products and plain torch, as the
   reference's are outside Pallas), K1 and its gradient GEMMs in the
   local layer and every MLP, the row norm, K4 'local' at hd 256 with its
   lse and its backward, once a microbatch and step (the local layer
   only).  10.31 GFLOP a token (``model_flops_per_token``).
18. train: xlstm-350m at full width, one period (8 layers: 7 mLSTM
   blocks, 1 sLSTM block; 0.19 B parameters, fp32 masters), the same
   steps in the config's 2 microbatches of 4 x 4096: the mLSTM's
   chunkwise form and the sLSTM's token loop under autograd, the row
   norm (and its backward) the one kernel, no K4 launch; 1.245 GFLOP a
   token.  For them phase 2 holds K4's backward and its lse
   output at recurrentgemma's local layer (2 x 4096, G = 16, hd 256, W
   2048; ``check_train_kind_rows``) and the row norm at xlstm's widths
   (``check_xlstm_kernels``), and phase 3 both smoke configs' train
   steps (recurrentgemma at bf16 ``param_dtype``, xlstm at 128 tokens:
   two mLSTM chunks, and at lr 1e-4, ``TR_SMOKE_LR``), their gradients
   at full width, every leaf, card against CPU (recurrentgemma's first
   period, one mLSTM block and the sLSTM block of xlstm), and the
   training row norm's gradients at xlstm's widths against f64
   (``check_train_norm``).
19. train: whisper-small at full width and depth (12 encoder and 12
   decoder layers, 0.24 B fp32 masters), 8 clips a step of 4096 decoder
   tokens over 1500 frames each, in the config's 2 microbatches: the
   encoder (each block rematerialized), the decoder's causal
   self-attention and its cross-attention, 'full' over the 1500 frames
   from 4096 tokens (K4 and its backward at Skv != Sq), K1 with gelu and
   its gradient GEMMs, the row norm; K4's backward exactly (12 + 2 x 12)
   x microbatches x steps times, 'full' (12 + 12) x microbatches x steps;
   1.505 GFLOP a decoder token (the encoder's frames and the cross
   products counted, ``model_flops_per_token``).
20. train: paligemma-3b at full width, ``PG_TRAIN_LAYERS`` of its 18
   layers (the reckoning beside the constant), 256 patches and 3840 tokens
   a sequence, 8 a step in the config's 2 microbatches: K4 'global' at hd
   256 and G = 8 with its lse and its backward, K1, the row norm.  For
   phases 19 and 20 phase 2 holds K4's backward 'full' at Skv != Sq
   (4 x 4096 over 1500, 8 x 64 over 1500, 2 x 1000 over 37) and its lse
   output at the first, and the backward and lse at paligemma's
   microbatch (``check_train_kind_rows``); phase 3 both smoke configs'
   train steps, and full-width gradients through one encoder block and
   one decoder block of whisper (512 tokens over 1500 frames) and
   paligemma's first two layers, card against CPU.  Phases 15-18 and 20
   take 2 steps on the repeated batch, phase 19 4.

Then one JSON line listing every ported kernel and variant, the card line
again, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense): HBM rate and peak operation rates
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12     # outside the tensor cores
L2_FLUSH_BYTES = 64 << 20   # more than the 50 MB L2
BATCH, PROMPT, NEW = 4, 256, 16
SEED = 0
# the paged kernel's shapes follow the scheduler's geometry
# (repro_torch.launch.serve.GEOMETRY): 8 lanes, 16-slot pages, 64-token
# chunks; N_REQ requests are served through it
LANES, PAGE, CHUNK, N_REQ = 8, 16, 64, 16
# gemma2-27b's attention (src/repro_torch/configs/gemma2_27b.py)
G2_H, G2_KV, G2_HD, G2_WINDOW, G2_SOFTCAP = 32, 16, 128, 4096, 50.0
# phase 5: the fixed loop's batch, prompt (past the 4096 window, so K4's
# window and the local ring's wrap both run) and new tokens; the
# scheduler's requests, the first of them with the long prompt
G2_BATCH, G2_PROMPT, G2_NEW, G2_REQ = 2, 4160, 16, 8
# gemma3-12b's attention (src/repro_torch/configs/gemma3_12b.py): head dim
# 256, window 1024, no softcap; phase 6 serves it as phase 5 serves gemma2
# (the prompt wraps the local layers' 1024-slot ring four times)
G3_H, G3_KV, G3_HD, G3_WINDOW = 16, 8, 256, 1024
G3_BATCH, G3_PROMPT, G3_NEW, G3_REQ = 2, 4160, 16, 8
# llama4-scout-17b-a16e (src/repro_torch/configs/llama4_scout_17b_a16e.py):
# 40 q heads over 8 kv heads (G = 5), hd 128, chunks of 8192 positions,
# d_model 5120, 16 experts of d_ff 8192; phase 8 serves 8 of its 48 layers
# (two periods of its 3:1 chunked:global pattern) at full width
L4_ARCH = "llama4-scout-17b-a16e"
L4_H, L4_KV, L4_HD, L4_WINDOW, L4_D = 40, 8, 128, 8192, 5120
L4_LAYERS = 8
# the fixed loop's batch, prompt (past the 8192 chunk) and new tokens; the
# scheduler's requests, request 0's prompt and budget (its decode crosses
# position 8192), and the pages of a lane (launch.serve.LLAMA4_GEOMETRY's
# 8224 positions over 16-slot pages)
L4_BATCH, L4_PROMPT, L4_NEW = 2, 8448, 16
L4_REQ, L4_LONG, L4_LONG_NEW, L4_PAGES = 8, 8180, 32, 514
# the witness: a prompt just short of the chunk boundary, decoded past it;
# the int8 witness: 8 lanes of 512 tokens (a lane is held where its last
# token was routed alike in both runs and no token of it was dropped)
L4_WIT_PROMPT, L4_WIT_NEW = 8190, 8
L4_WIT8_LANES, L4_WIT8_PROMPT = 8, 512
# K4's 'prefix' kind at paligemma's would-be shape (256 patches before 256
# text tokens, 8 q heads over 1 kv head of 256): no model calls it
PG_B, PG_PREFIX, PG_S, PG_H, PG_KV, PG_HD = 4, 256, 512, 8, 1, 256
# paligemma-3b (src/repro_torch/configs/paligemma_3b.py): phase 9 serves 8
# images' 256 patches and 256 text tokens each (a prompt of 512
# positions) and 32 greedy tokens through generate_with_status; its
# attention is 'global' over the patches too (ROADMAP F5), 8 q heads over
# 1 kv head of 256 (G = 8)
PG_ARCH, PG_D, PG_FF = "paligemma-3b", 2048, 16384
PG_BATCH, PG_TEXT, PG_NEW = 8, PG_S - PG_PREFIX, 32
# recurrentgemma-9b (src/repro_torch/configs/recurrentgemma_9b.py): 26
# RG-LRU blocks and 12 local-attention blocks (16 q heads over 1 kv head
# of 256, G = 16, window 2048), d_model 4096, d_ff 12288, vocab 256000;
# phase 10 serves all 38 layers through generate_with_status (the fixed
# loop): 2 prompts of 4160 tokens (past the window: K4's local mask beyond
# it, the ring wrapped) with 16 new tokens, then 8 prompts of 512 with 32
RG_ARCH = "recurrentgemma-9b"
RG_H, RG_KV, RG_HD, RG_WINDOW, RG_D, RG_FF = 16, 1, 256, 2048, 4096, 12288
RG_LONG_BATCH, RG_LONG_PROMPT, RG_LONG_NEW = 2, 4160, 16
RG_BATCH, RG_PROMPT, RG_NEW = 8, 512, 32
# xlstm-350m (src/repro_torch/configs/xlstm_350m.py): 21 mLSTM blocks
# (width 2048, 4 heads of 512) and 3 sLSTM blocks (4 heads of 256),
# d_model 1024, vocab 50304, no FFN; phase 11 serves all 24 layers
# through generate_with_status (the fixed loop): 8 prompts of 2048 tokens
# with 32 new tokens, then 2 of 8192 (the long prompt a constant-size
# state is for) with 16; the witness decodes 64 steps past 2048 (a
# prefill of 2112, a multiple of the chunk of 64)
XL_ARCH = "xlstm-350m"
XL_D, XL_W, XL_H = 1024, 2048, 4
XL_BATCH, XL_PROMPT, XL_NEW = 8, 2048, 32
XL_LONG_BATCH, XL_LONG_PROMPT, XL_LONG_NEW = 2, 8192, 16
XL_WIT_STEPS = 64
# the decode-vs-prefill witness of the xLSTM: each rounding is carried
# through every layer's recurrent state, and the decode step's distance
# from the prefill grows with depth (on the card, PERF.md: at bf16 0.034
# of the logit scale on one period of the pattern, 8 layers of 7 mLSTM
# blocks and 1 sLSTM block, 0.28 at 24 layers; a changed last token moves
# the logits by 1.2).  On one period at full width the witness is held to
# WITNESS_TOL at bf16 and to XL_WITNESS_TOL32 at fp32 compute (the
# reference's own fp32 distance at this width and depth is 3.6e-6 on the
# CPU, tests/_xlstm_depth_probe.py).  At all 24 layers even fp32 rounding
# grows large (the reference's own there 1.6e-4), so the fp32 witness
# must lie XL_PRECISION_GAIN below the bf16 one: rounding noise shrinks
# with the stream's precision, while a fault in the step or the chunkwise
# form moves the logits by about as much as a changed token at either
# precision.  And the bf16 decode's distance from the fp32 prefill is
# held to 4x the bf16 prefill's own.
XL_WIT_LAYERS, XL_WITNESS_TOL32, XL_PRECISION_GAIN = 8, 1e-4, 20
# grok-1-314b (src/repro_torch/configs/grok_1_314b.py): 48 q heads over 8
# kv heads of 128 (G = 6), d_model 6144, 8 experts of d_ff 32768 routed
# top-2, vocab 131072; phase 12 serves 6 of its 64 layers at full width
# (60.65 GB of bf16 weights; 7 leave no room for a prefill's expert
# transients): the fixed loop's batch, prompt (2 x 4160 tokens give each
# expert 2600 slots) and new tokens; the scheduler's requests, request 0's
# prompt and budget, and the pages of a lane (launch.serve.GROK_GEOMETRY's
# 4192 positions over 16-slot pages); the witness decodes 8 steps past a
# 4160-token prompt, the int8 witness prefills 8 lanes of 512 tokens
GK_ARCH = "grok-1-314b"
GK_H, GK_KV, GK_HD, GK_D, GK_FF = 48, 8, 128, 6144, 32768
GK_LAYERS = 6
GK_BATCH, GK_PROMPT, GK_NEW = 2, 4160, 16
GK_REQ, GK_LONG, GK_LONG_NEW, GK_PAGES = 8, 4160, 32, 262
GK_WIT_NEW, GK_WIT8_LANES, GK_WIT8_PROMPT = 8, 8, 512
# kernels each driven path must launch (the counts are read per path)
# (a variant's launches are counted under "<kernel>:<variant>"; a row pass
# in a GEMM's store phase is its variant "norm" or "quantize")
PATH_KERNELS = {
    "fixed": ("matmul", "matmul:norm", "rmsnorm", "flash_attention",
              "flash_decode"),
    "scheduler_bf16": ("matmul", "matmul:norm", "rmsnorm", "paged_decode",
                       "paged_decode:chunk"),
    "scheduler_int8": ("int8_matmul", "int8_matmul:norm",
                       "int8_matmul:quantize", "int8_quantize", "quantize",
                       "rmsnorm", "paged_decode", "paged_decode:chunk"),
    "addertree": ("matmul", "addertree"),
    "gemma2_fixed": ("matmul", "matmul:norm", "rmsnorm",
                     "flash_attention:local+softcap",
                     "flash_attention:softcap", "flash_decode:softcap"),
    "gemma2_scheduler": ("matmul", "matmul:norm", "rmsnorm",
                         "paged_decode:local+softcap",
                         "paged_decode:softcap",
                         "paged_decode:local+softcap+chunk",
                         "paged_decode:softcap+chunk"),
    # gemma3: every attention launch at hd 256 (its own variant key)
    "gemma3_fixed": ("matmul", "matmul:norm", "rmsnorm",
                     "flash_attention:local+hd256", "flash_attention:hd256",
                     "flash_decode:hd256"),
    "gemma3_scheduler_bf16": ("matmul", "matmul:norm", "rmsnorm",
                              "paged_decode:local+hd256",
                              "paged_decode:hd256",
                              "paged_decode:local+chunk+hd256",
                              "paged_decode:chunk+hd256"),
    "gemma3_scheduler_int8": ("int8_matmul", "int8_matmul:norm",
                              "int8_matmul:quantize", "int8_quantize",
                              "quantize", "rmsnorm",
                              "paged_decode:local+hd256",
                              "paged_decode:hd256",
                              "paged_decode:local+chunk+hd256",
                              "paged_decode:chunk+hd256"),
    # whisper: the encoder (K4 'full', K1 gelu), the decoder's prefill (K4
    # causal and 'full') and decode (K5 global and 'full'); under int8 the
    # decoder's up GEMM is K2 with gelu (its quantize the store phase's
    # tail at decode), while the encoder and cross-attention stay on K1
    "whisper_fixed": ("matmul", "matmul:gelu", "matmul:norm", "rmsnorm",
                      "flash_attention", "flash_attention:full",
                      "flash_decode", "flash_decode:full"),
    "whisper_fixed_int8": ("matmul", "matmul:gelu", "int8_matmul",
                           "int8_matmul:gelu", "int8_matmul:gelu+quantize",
                           "int8_matmul:norm", "int8_quantize", "quantize",
                           "rmsnorm", "flash_attention",
                           "flash_attention:full", "flash_decode",
                           "flash_decode:full"),
    # llama4: K4 chunked and global, K5 global (the chunked layers decode
    # their ring in plain torch), K6 chunked and global in both bodies, K1
    # (no norm tail: after the MoE the residual add and the next norm run
    # standalone, the row-norm kernel); a bare kernel name here means its
    # launches with no variant on (``variant_launches``)
    "llama4_fixed": ("matmul", "rmsnorm", "flash_attention:chunked",
                     "flash_attention", "flash_decode"),
    "llama4_scheduler": ("matmul", "rmsnorm", "paged_decode:chunked",
                         "paged_decode", "paged_decode:chunked+chunk",
                         "paged_decode:chunk"),
    # llama4 int8: K2 (fed by K3) for wqkv and wo only, the MoE unchanged
    "llama4_scheduler_int8": ("int8_matmul", "quantize", "rmsnorm",
                              "paged_decode:chunked", "paged_decode",
                              "paged_decode:chunked+chunk",
                              "paged_decode:chunk"),
    # gemma2 int8: the releasing build's copy through the scheduler; its up
    # GEMM (N 36864) is wider than the store phase's row pass takes, so
    # its row quantize is K3's row kernel at decode too
    "gemma2_scheduler_int8": ("int8_matmul", "int8_matmul:norm",
                              "int8_quantize", "quantize", "rmsnorm",
                              "paged_decode:local+softcap",
                              "paged_decode:softcap",
                              "paged_decode:local+softcap+chunk",
                              "paged_decode:softcap+chunk"),
    # paligemma: K4 global and K5 at hd 256, G = 8, over the patches and
    # the text (generate_with_status's fall-through to the fixed loop)
    "paligemma_fixed": ("matmul", "matmul:norm", "rmsnorm",
                        "flash_attention:hd256", "flash_decode:hd256"),
    "paligemma_fixed_int8": ("int8_matmul", "int8_matmul:norm",
                             "int8_matmul:quantize", "int8_quantize",
                             "quantize", "rmsnorm", "flash_attention:hd256",
                             "flash_decode:hd256"),
    # recurrentgemma: K4 'local' at hd 256 and G = 16 in its 12 local
    # layers' prefill (their decode is the plain ring, no K5), K1 (or K2
    # with K3) for those layers' qkv and o and every MLP; the RG-LRU
    # mixers are library products and plain torch (no kernel)
    "recurrentgemma_fixed": ("matmul", "matmul:norm", "rmsnorm",
                             "flash_attention:local+hd256"),
    "recurrentgemma_fixed_int8": ("int8_matmul", "int8_matmul:norm",
                                  "int8_matmul:quantize", "int8_quantize",
                                  "quantize", "rmsnorm",
                                  "flash_attention:local+hd256"),
    # xlstm: the row-norm kernel alone (the entry norm, each mixer's inner
    # norm and each next norm); the mixers are library products and plain
    # torch, and its int8 copy quantizes nothing
    "xlstm_fixed": ("rmsnorm",),
    "xlstm_fixed_int8": ("rmsnorm",),
    # grok: K4 and K5 (or K6) global at G = 6, K1 (or K2 fed by K3) for
    # wqkv and wo only, the row norm standalone (the MoE's batched
    # products are library calls, as the reference's einsums)
    "grok_fixed": ("matmul", "rmsnorm", "flash_attention", "flash_decode"),
    "grok_fixed_int8": ("int8_matmul", "quantize", "rmsnorm",
                        "flash_attention", "flash_decode"),
    "grok_scheduler": ("matmul", "rmsnorm", "paged_decode",
                       "paged_decode:chunk"),
    "grok_scheduler_int8": ("int8_matmul", "quantize", "rmsnorm",
                            "paged_decode", "paged_decode:chunk"),
    # internlm2 (C3): granite's kernels, from the fp32 masters' bf16 copy
    # (and the int8 copy quantized from the fp32 values)
    "internlm2_fixed": ("matmul", "matmul:norm", "rmsnorm",
                        "flash_attention", "flash_decode"),
    "internlm2_fixed_int8": ("int8_matmul", "int8_matmul:norm",
                             "int8_matmul:quantize", "int8_quantize",
                             "quantize", "rmsnorm", "flash_attention",
                             "flash_decode"),
    "internlm2_scheduler_bf16": ("matmul", "matmul:norm", "rmsnorm",
                                 "paged_decode", "paged_decode:chunk"),
    "internlm2_scheduler_int8": ("int8_matmul", "int8_matmul:norm",
                                 "int8_matmul:quantize", "int8_quantize",
                                 "quantize", "rmsnorm", "paged_decode",
                                 "paged_decode:chunk"),
    # training internlm2 (phase 14): K1 forward and its gradient GEMMs
    # (dA at bf16, dB in the fp32 store, the gate's input recomputed in
    # it), the row norm (the entry norm and each ln2: the down GEMM's norm
    # is its row kernel at M >= 64), K4 with its log-sum-exp, K4's
    # backward
    "internlm2_train": ("matmul", "matmul:f32", "rmsnorm",
                        "flash_attention:lse", "flash_attention_bwd"),
    # training gemma3-12b (phase 15) and gemma2-27b (phase 16): the same
    # kernels, K4 and its backward in each layer kind's variant (gemma3's
    # local and global layers at hd 256; gemma2's local and global layers
    # softcapped)
    "gemma3_train": ("matmul", "matmul:f32", "rmsnorm",
                     "flash_attention:local+hd256+lse",
                     "flash_attention:hd256+lse",
                     "flash_attention_bwd:local+hd256",
                     "flash_attention_bwd:hd256"),
    "gemma2_train": ("matmul", "matmul:f32", "rmsnorm",
                     "flash_attention:local+softcap+lse",
                     "flash_attention:softcap+lse",
                     "flash_attention_bwd:local+softcap",
                     "flash_attention_bwd:softcap"),
    # training recurrentgemma-9b (phase 17): K1 and its gradient GEMMs in
    # the local layer and every MLP, the row norm, K4 'local' at hd 256
    # with its lse and its backward in the local layer (G = 16); the
    # RG-LRU mixers are library products and plain torch under autograd
    "recurrentgemma_train": ("matmul", "matmul:f32", "rmsnorm",
                             "flash_attention:local+hd256+lse",
                             "flash_attention_bwd:local+hd256"),
    # training xlstm-350m (phase 18): the row norm alone (the entry norm,
    # each mixer's inner norm, each next norm, with their backward in
    # plain torch); the mixers are library products and plain torch
    "xlstm_train": ("rmsnorm",),
    # training whisper-small (phase 19): K1 and its gradient GEMMs (the
    # gelu up GEMMs of the encoder and the decoder), the row norm, K4 with
    # its lse and its backward, causal in the decoder's self-attention and
    # 'full' in the encoder and the cross-attention (Skv != Sq); the cross
    # q and K/V products are library products, as the reference's einsums
    "whisper_train": ("matmul", "matmul:gelu", "matmul:f32", "rmsnorm",
                      "flash_attention:lse", "flash_attention:full+lse",
                      "flash_attention_bwd", "flash_attention_bwd:full"),
    # training paligemma-3b (phase 20): K1 and its gradient GEMMs, the row
    # norm, K4 'global' at hd 256 and G = 8 with its lse and its backward
    "paligemma_train": ("matmul", "matmul:f32", "rmsnorm",
                        "flash_attention:hd256+lse",
                        "flash_attention_bwd:hd256"),
}


def decode_launches(name, counts, cfg, int8: bool = False) -> dict:
    """One decode iteration's launch counts on a driven path: the entry
    norm and each block's ``ln2`` are the only row-norm launches (the down
    GEMM's norm is its tail, one per layer), and under int8 no row
    quantize launches (the up GEMM's quantize is its tail); ``cfg`` is
    the served model's config.  An encoder-decoder (whisper) adds each block's ``lnx`` (2 layers + 1
    row-norm launches), a K5 'full' launch a layer beside the global one,
    and its up GEMM is the gelu variant (``matmul:gelu``, or under int8
    ``int8_matmul:gelu+quantize``).  An MoE model (llama4, grok) has no down
    GEMM to fold into: each layer's ``ln2`` and its next norm after the
    MoE are row-norm launches (2 layers + 1), and no norm tail runs;
    under int8 only its ``wqkv`` and ``wo`` are K2 launches, each fed by
    K3 (2 layers of each, no K1, no tail).  An int8 up GEMM wider than
    the store phase's row pass takes (d_ff above ``matmul.NORM_MAX_N``,
    gemma2's 36864) quantizes in K3's row kernel, one launch a layer, and
    has no tail; an MoE's experts (grok's d_ff 32768) are no int8 GEMM.
    A model of recurrent mixers and no FFN (d_ff 0, xlstm) launches the
    row-norm kernel alone: each layer's inner norm and next
    norm and the entry norm (2 layers + 1).  Raises on a miss; returns
    the counts."""
    from repro_torch.kernels.matmul import NORM_MAX_N

    layers, encdec, moe = cfg.n_layers, cfg.encdec, cfg.moe
    wide_ff = int8 and not moe and cfg.d_ff > NORM_MAX_N
    if cfg.d_ff == 0:
        want = {"rmsnorm": 2 * layers + 1}
        others = {k: n for k, n in counts.items() if n and k != "rmsnorm"}
        require(counts.get("rmsnorm", 0) == want["rmsnorm"] and not others,
                f"{name}: launches in one decode iteration {counts}, want "
                f"{want} and nothing else")
        return counts
    gemm = "int8_matmul" if int8 else "matmul"
    want = {"rmsnorm": (2 if encdec or moe else 1) * layers + 1,
            f"{gemm}:norm": 0 if moe else layers}
    if encdec:
        want.update({"flash_decode": 2 * layers,
                     "flash_decode:full": layers,
                     ("int8_matmul:gelu+quantize" if int8
                      else "matmul:gelu"): layers})
    if int8:
        tail = not (encdec or moe or wide_ff)
        want.update({"int8_matmul:quantize": layers if tail else 0,
                     "int8_quantize": layers if wide_ff else 0})
    if int8 and moe:
        want.update({"int8_matmul": 2 * layers, "quantize": 2 * layers,
                     "matmul": 0})
    got = {k: counts.get(k, 0) for k in want}
    require(got == want, f"{name}: launches in one decode iteration {got}, "
                         f"want {want}")
    return counts


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flops_per_s: float = None):
    """The least time in ms: bytes over the memory rate or operations over
    the peak rate of their type (bf16 tensor cores unless stated)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (flops_per_s or BF16_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Time of one call, averaged over ``reps`` calls, each after an L2
    flush (the serving path meets its weights and caches cold).

    Calling it gives the device time: CUDA events recorded just before
    and after the call, behind a spin kernel (``torch.cuda._sleep``) that
    keeps the card busy while the host enqueues the flush, the events and
    the call's kernels, so the time runs from the start of the call's
    first kernel to the end of its last, with no wait for the host in it.
    (``torch.profiler`` traces of the same calls have been seen to lose a
    device event per trace, in every try, once a process had taken a few
    hundred traces.)  ``wall`` gives CUDA events around each call without
    the spin, so it also holds the host's time inside the wrapper
    (argument checks, allocation, the ctypes call)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")
        # the spin's cycles per ms, from one timed spin
        cycles = 10_000_000
        start, end = self._event(), self._event()
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        self.cycles_per_ms = cycles / start.elapsed_time(end)

    def _event(self):
        return self.torch.cuda.Event(enable_timing=True)

    def _flush(self):
        self.torch.bitwise_not(self.flush, out=self.flush)

    def __call__(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        # the spin outlasts the host's enqueue of one call 4x (at least
        # 2 ms)
        t = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        spin = int(self.cycles_per_ms * max(2.0, 4 * host_ms))
        total = 0.0
        for _ in range(reps):
            start, end = self._event(), self._event()
            torch.cuda._sleep(spin)
            self._flush()
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps

    def wall(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self._flush()
            start, end = self._event(), self._event()
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def row_err(got, want, floor: float = 1e-3) -> float:
    """Worst row's error against that row's own scale: max over rows (all
    axes but the last) of max|got - want| / max(floor, max|want|).  A
    row's tolerance follows its own size, so large rows elsewhere in the
    output cannot hide an error in small ones."""
    g, w = got.float(), want.float()
    diff = (g - w).abs().amax(dim=-1)
    scale = w.abs().amax(dim=-1).clamp(min=floor)
    return float((diff / scale).max())


# K1's widths per model: d_model, the packed qkv N, the o-projection's K
# (heads x head_dim), d_ff, and the rows of the driven paths
K1_WIDTHS = {
    "granite": (4096, 6144, 4096, 12800, (BATCH, LANES, 1024, LANES * CHUNK)),
    "gemma2": (4608, 8192, 4096, 36864,
               (G2_BATCH, LANES, LANES * CHUNK, G2_BATCH * G2_PROMPT)),
    "gemma3": (3840, 8192, 4096, 15360,
               (G3_BATCH, LANES, LANES * CHUNK, G3_BATCH * G3_PROMPT)),
    # paligemma: its fixed loop's decode (8 rows) and prefill (8 x 512)
    "paligemma": (PG_D, (PG_H + 2 * PG_KV) * PG_HD, PG_H * PG_HD, PG_FF,
                  (PG_BATCH, PG_BATCH * PG_S)),
    # recurrentgemma: the local layers' qkv (N 4608) and o, every layer's
    # MLP, at the fixed loop's decode (8 rows) and long prefill (2 x 4160)
    "recurrentgemma": (RG_D, (RG_H + 2 * RG_KV) * RG_HD, RG_H * RG_HD, RG_FF,
                       (RG_BATCH, RG_LONG_BATCH * RG_LONG_PROMPT)),
}


def k1_rows(torch, timer, rand, model, m, d, qkv_n, o_k, ff, tol,
            names=("qkv", "o", "gate", "up", "down")):
    """K1 at one model's projections (``names``, by default all five) for
    M rows: each against its plain version (``tol`` of each row's scale;
    the fused rmsnorm bitwise store-then-rmsnorm), timed beside its bound,
    its plain version and one ``torch.matmul``; returns one row per
    projection."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.epilogue import Epilogue
    from repro_torch.kernels.matmul import k1_plan, sm_count
    bf = torch.bfloat16
    x, h, res = rand(m, d), rand(m, ff), rand(m, d)
    nscale = rand(d, dtype=torch.float32, scale=0.1)
    w = {"qkv": rand(d, qkv_n, scale=d ** -0.5),
         "o": rand(o_k, d, scale=o_k ** -0.5),
         "gate": rand(d, ff, scale=d ** -0.5),
         "up": rand(d, ff, scale=d ** -0.5),
         "down": rand(ff, d, scale=ff ** -0.5)}
    g = ops.matmul(x, w["gate"], out_dtype=bf)
    # the o-projection's input: the first o_k columns of x where d holds
    # them (granite, gemma2), its own draw where it does not (gemma3)
    xo = x[:, :o_k].contiguous() if o_k <= d else rand(m, o_k)
    cases = {
        "qkv": (x, w["qkv"], Epilogue(out_dtype=bf), {}),
        "o": (xo, w["o"], Epilogue(out_dtype=bf), {}),
        "gate": (x, w["gate"], Epilogue(out_dtype=bf), {}),
        "up": (x, w["up"], Epilogue(gate="silu", out_dtype=bf),
               {"operand2": g}),
        "down": (h, w["down"], Epilogue(residual=True, norm="rmsnorm",
                                       out_dtype=bf),
                 {"residual": res, "norm_scale": nscale}),
    }
    out = []
    for name, (a, b, ep, kw) in cases.items():
        if name not in names:
            continue
        got = ops.matmul(a, b, epilogue=ep, **kw)
        want = ref.matmul_fused_ref(a, b, ep, **kw)
        if ep.norm != "none":
            require(torch.equal(got[1], ops.rmsnorm(got[0], nscale,
                                                    ep.norm_eps)),
                    "fused rmsnorm is not bitwise store-then-rmsnorm")
            err = max(row_err(got[0], want[0]), row_err(got[1], want[1]))
            abs_err = max(max_err(got[0], want[0]),
                          max_err(got[1], want[1]))
        else:
            err = row_err(got, want)
            abs_err = max_err(got, want)
        del got, want
        require(err <= tol, f"K1 {model} {name} M={m}: a row is off by "
                            f"{err:.3e} of its scale")
        mm, kk = a.shape
        nn = b.shape[1]
        nbytes = 2 * (mm * kk + kk * nn + mm * nn)
        nbytes += 2 * mm * nn * (("operand2" in kw) + ("residual" in kw))
        if ep.norm != "none":   # the normed output and its scale
            nbytes += 2 * mm * nn + 4 * nn
        plan = k1_plan(mm, nn, kk, sm_count(a.device.index))
        row = {
            "model": model, "shape": f"{name} M={mm} K={kk} N={nn}",
            "regime": plan.regime, "splits": plan.splits,
            "max_abs_err": abs_err, "max_row_err": err,
            "ms": timer(lambda: ops.matmul(a, b, epilogue=ep, **kw)),
            "wrapper_ms": timer.wall(
                lambda: ops.matmul(a, b, epilogue=ep, **kw)),
            "plain_ms": timer(lambda: ref.matmul_fused_ref(a, b, ep, **kw),
                              reps=3 if mm * kk * nn > 1e11 else 10),
            "library_ms": timer(lambda: torch.matmul(a, b)),
        }
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * mm * kk * nn)
        row["tflops"] = 2 * mm * kk * nn / row["ms"] / 1e9
        row["tb_per_s"] = nbytes / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        out.append(row)
        print("  k1", json.dumps(row), flush=True)
    return out


def k1_sum(shapes, model, m, work, tol):
    """One kernels-line row from ``k1_rows``' rows of ``model`` at M = m:
    the projections' times, bounds and yardsticks summed, the worst
    error."""
    sel = [r for r in shapes
           if r["model"] == model and r["shape"].split()[1] == f"M={m}"]
    return dict(
        work=work,
        max_abs_err=max(r["max_abs_err"] for r in sel),
        max_row_err=max(r["max_row_err"] for r in sel), tol=tol,
        ms=sum(r["ms"] for r in sel),
        wrapper_ms=sum(r["wrapper_ms"] for r in sel),
        plain_ms=sum(r["plain_ms"] for r in sel),
        bound_ms=sum(r["bound_ms"] for r in sel),
        bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in sel)
                  else "operations"),
        library_ms=sum(r["library_ms"] for r in sel),
        regime=sel[0]["regime"], deterministic=True)


def k1_determinism(torch, rand):
    """K1 is deterministic: at gemma2's five decode projections (M = 8,
    every one split over K) and one chunk projection (M = 512), the same
    call twice is bitwise equal, and row 0 is bitwise the same when the
    other rows change (no row reads another's values, and the summation
    order depends on the shape alone)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.epilogue import Epilogue
    bf = torch.bfloat16
    d, qkv_n, o_k, ff, _ = K1_WIDTHS["gemma2"]
    for m, (k, n) in [(LANES, kn) for kn in ((d, qkv_n), (o_k, d), (d, ff),
                                             (ff, d))] \
            + [(LANES * CHUNK, (o_k, d))]:
        a, b, res = rand(m, k), rand(k, n, scale=k ** -0.5), rand(m, n)
        ep = Epilogue(residual=True, out_dtype=bf)
        first = ops.matmul(a, b, epilogue=ep, residual=res)
        require(torch.equal(first, ops.matmul(a, b, epilogue=ep,
                                              residual=res)),
                f"K1 M={m} K={k} N={n}: two calls differ")
        a2, res2 = a.clone(), res.clone()
        a2[1:], res2[1:] = rand(m - 1, k), rand(m - 1, n)
        require(torch.equal(first[0], ops.matmul(a2, b, epilogue=ep,
                                                 residual=res2)[0]),
                f"K1 M={m} K={k} N={n}: row 0 depends on the other rows")


def plain_partials(plain, rows, n_tiles, g, hd):
    """The plain version's partials, stacked on tile [T, R.., G, 1(, hd)],
    in the kernel's layout: m_t, l_t [rows, T, G] and acc_t [rows, T, G,
    hd]."""
    return (plain[0][..., 0].permute(1, 2, 0, 3).reshape(rows, n_tiles, g),
            plain[1][..., 0].permute(1, 2, 0, 3).reshape(rows, n_tiles, g),
            plain[2][..., 0, :].permute(1, 2, 0, 3, 4).reshape(
                rows, n_tiles, g, hd))


def record_err(torch, ws, plain, rows, n_tiles, g, hd):
    """The serving launch's workspace records of the live tiles against the
    plain version's partials (``plain``, stacked on tile): the worst row's
    error against its own scale.  A dead tile (the plain l_t is exactly 0;
    a live tile's is >= 1) is never written by the kernel and not
    compared."""
    from repro_torch.kernels.flash_attention import record_views
    want = plain_partials(plain, rows, n_tiles, g, hd)
    live = want[1] > 0
    require(bool(live.any()), "no live tile to compare")
    return max(row_err(torch.where(sel, x, y), y) for sel, x, y in
               zip((live, live, live[..., None]), record_views(ws, g, hd),
                   want))


def sdpa_ms(torch, timer, q, k, v, **kw):
    """The library yardstick (the port never calls it): one SDPA call on
    the same q [B, Sq, H, hd] and k/v [B, Skv, KV, hd], the fastest of
    three forms of its operands made outside the timing: the heads-first
    views of these tensors and contiguous copies, both with the kv heads
    grouped by ``enable_gqa`` (read once, as the kernel reads them), and
    the kv heads repeated to H (G times the K/V bytes, but some backends
    take a mask only without ``enable_gqa``)."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
    kr, vr = (x.repeat_interleave(g, dim=1) for x in (kc, vc))
    return min(
        timer(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     enable_gqa=True, **kw)),
        timer(lambda: F.scaled_dot_product_attention(qc, kc, vc,
                                                     enable_gqa=True, **kw)),
        timer(lambda: F.scaled_dot_product_attention(qc, kr, vr, **kw)))


def k5_row(torch, timer, rand, b, length, pos, kv, g, hd, softcap, scale,
           where, kind="global"):
    """K5 at one shape (caches of ``length`` slots, position ``pos``, or
    every slot for ``kind='full'``; q and K at ``scale``): the output
    bitwise the same at split counts 1, 2, 4,
    the default and n_tiles, each (b, kv, g) row within 2 bf16 ulps of its
    scale of ``flash_decode_tiled``; the live tiles' partials, as the
    serving launch leaves them in its workspace (fp32, the same math in
    another summation order), within 1e-5 of each row's scale of
    ``decode_tile_partials``.  Timed beside its bound (q, the live K/V rows
    and the output), its plain version and, without a softcap, one SDPA
    call on the live slots (``sdpa_ms``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (dense_decode_launch,
                                                     decode_tile_partials,
                                                     decode_splits,
                                                     flash_decode_tiled)
    from repro_torch.kernels.matmul import sm_count
    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    q = rand(b, 1, kv, g, hd, scale=scale)
    kc, vc = rand(b, length, kv, hd, scale=scale), rand(b, length, kv, hd)
    rows, n_tiles = b * kv, -(-length // 32)
    splits = (None, 1, 2, 4, n_tiles)
    outs = [ops.flash_decode(q, kc, vc, pos, softcap=softcap, n_splits=n,
                             kind=kind) for n in splits]
    require(all(torch.equal(outs[0], o) for o in outs[1:]),
            f"K5 ({where}) output changes with n_splits")
    want = flash_decode_tiled(q, kc, vc, pos, softcap, kind)
    err = row_err(outs[0], want)
    require(err <= 2 * eps_bf16,
            f"K5 ({where}): a row is off by {err:.3e} of its scale")
    out, ws = dense_decode_launch(q, kc, vc, pos, softcap=softcap, kind=kind)
    require(torch.equal(out, outs[0]), f"K5 ({where}): two launches differ")
    p_err = record_err(torch, ws, decode_tile_partials(q, kc, vc, pos,
                                                       softcap, kind),
                       rows, n_tiles, g, hd)
    del out, ws
    require(p_err <= 1e-5, f"K5 ({where}) partials: a row is off by "
                           f"{p_err:.3e}")
    live = length if kind == "full" else pos + 1
    t_b, by = bound(2 * 2 * q.numel() + 2 * 2 * b * live * kv * hd,
                    4 * b * kv * g * hd * live)
    row = dict(
        work=f"{where}: {kind} decode B={b} cache={length} "
             f"{'every slot' if kind == 'full' else f'pos={pos}'} KV={kv} "
             f"G={g} hd={hd} softcap={softcap}, {n_tiles} tiles, "
             f"{decode_splits(rows, n_tiles, sm_count(q.device.index), hd)} "
             f"splits by default; bitwise at n_splits {list(splits)}",
        max_abs_err=max_err(outs[0], want), max_row_err=err,
        tol=2 * eps_bf16, partials_row_err=p_err, partials_tol=1e-5,
        ms=timer(lambda: ops.flash_decode(q, kc, vc, pos, softcap=softcap,
                                          kind=kind)),
        wrapper_ms=timer.wall(
            lambda: ops.flash_decode(q, kc, vc, pos, softcap=softcap,
                                     kind=kind)),
        plain_ms=timer(lambda: flash_decode_tiled(q, kc, vc, pos, softcap,
                                                  kind), reps=3),
        bound_ms=t_b, bound_by=by, library_ms=None,
        library_note="no one PyTorch call has a softcap")
    if softcap is None:
        row["library_ms"] = sdpa_ms(torch, timer, q.reshape(b, 1, kv * g, hd),
                                    kc[:, :live], vc[:, :live])
        row["library_note"] = "SDPA on the live slots (sdpa_ms)"
    print("  k5", json.dumps(row), flush=True)
    return row


def check_kernels(torch, timer):
    """Phase 2: every kernel against its plain version at full width.
    Tolerances are per row (``row_err``): a bf16 output may differ from
    the plain version by one rounding flip, one ulp of the element, which
    is at most eps * the row's largest magnitude."""
    from repro_torch.kernels import ops, ref

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    results = {}
    # K1 GEMM at both models' widths and the rows of every driven path
    # (granite: the fixed loop's decode and prefill, 4 and 1024, the
    # scheduler's 8 and 512; gemma2: 2 and 8320, 8 and 512): each output
    # row within 2 bf16 ulps of its scale (fp32 sums in another order may
    # flip a rounding, and the normed output inherits one flip of the
    # value); the rmsnorm output is bitwise the standalone norm of the
    # stored value.
    k1_tol = 2 * eps_bf16
    shapes = []
    for model, (dm, qkv_n, o_k, ff, rows) in K1_WIDTHS.items():
        for m in rows:
            shapes += k1_rows(torch, timer, rand, model, m, dm, qkv_n, o_k,
                              ff, k1_tol)
    k1_determinism(torch, rand)

    def k1_entry(model, m, work):
        return k1_sum(shapes, model, m, work, k1_tol)

    five = ("five projections: qkv, o, gate, up+silu gate, "
            "down+residual+rmsnorm (its tail at decode, the row kernel at "
            "M >= 64)")
    # the decode regime at the scheduler's rows, the path generate runs
    results["k1_matmul"] = dict(
        k1_entry("granite", LANES,
                 f"granite-3-8b's {five} at decode (M={LANES}); every "
                 f"shape of both models is in 'shapes'; bitwise the same "
                 f"twice, and row 0 unchanged when the other rows change"),
        shapes=shapes)
    results["k1_matmul_gemma2_m8"] = k1_entry(
        "gemma2", LANES, f"gemma2-27b's {five} at decode (M={LANES})")
    results["k1_matmul_m512"] = k1_entry(
        "gemma2", LANES * CHUNK,
        f"gemma2-27b's {five} at a scheduler chunk (M={LANES * CHUNK}), "
        f"the operations regime")
    results["k1_matmul_m8320"] = k1_entry(
        "gemma2", G2_BATCH * G2_PROMPT,
        f"gemma2-27b's {five} at the fixed loop's prefill "
        f"(M={G2_BATCH * G2_PROMPT})")
    for m, where in ((LANES, "decode"), (LANES * CHUNK, "a scheduler chunk"),
                     (G3_BATCH * G3_PROMPT, "the fixed loop's prefill")):
        results[f"k1_matmul_gemma3_m{m}"] = k1_entry(
            "gemma3", m, f"gemma3-12b's {five} at {where} (M={m}; also at "
                         f"the fixed loop's decode, M={G3_BATCH}, in "
                         f"k1_matmul's 'shapes')")
    for m, where in ((PG_BATCH, "the fixed loop's decode"),
                     (PG_BATCH * PG_S, "the fixed loop's prefill of 256 "
                                       "patches and 256 text tokens")):
        results[f"k1_matmul_paligemma_m{m}"] = k1_entry(
            "paligemma", m, f"paligemma-3b's {five} at {where} (M={m})")
    for m, where in ((RG_BATCH, "the fixed loop's decode"),
                     (RG_LONG_BATCH * RG_LONG_PROMPT,
                      "the fixed loop's prefill of 2 x 4160")):
        results[f"k1_matmul_recurrentgemma_m{m}"] = k1_entry(
            "recurrentgemma", m,
            f"recurrentgemma-9b's {five} at {where} (M={m}; qkv and o in "
            f"its 12 local layers, the MLP in all 38)")

    # K4 flash prefill: each (b, s, h) row within 4 bf16 ulps of its own
    # scale (P is rounded to bf16 for the P.V product, then the output is
    # cast)
    b, s, nh, nkv, hd = BATCH, PROMPT, 32, 8, 128
    q, k, v = rand(b, s, nh, hd), rand(b, s, nkv, hd), rand(b, s, nkv, hd)
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    err = row_err(got, want)
    require(err <= 4 * eps_bf16, f"K4: a row is off by {err:.3e} of its "
                                 f"scale")
    t_b, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                    4 * b * nh * hd * s * (s + 1) / 2)
    results["k4_flash_prefill"] = dict(
        work=f"causal prefill B={b} S={s} H={nh} KV={nkv} hd={hd}",
        max_abs_err=max_err(got, want), max_row_err=err, tol=4 * eps_bf16,
        ms=timer(lambda: ops.flash_attention(q, k, v)),
        wrapper_ms=timer.wall(lambda: ops.flash_attention(q, k, v)),
        plain_ms=timer(lambda: ref.flash_attention_ref(q, k, v)),
        bound_ms=t_b, bound_by=by,
        library_ms=sdpa_ms(torch, timer, q, k, v, is_causal=True),
        library_note="SDPA causal (sdpa_ms)")

    # K5 split-K flash decode, one launch with its fold, at granite's
    # fixed loop's last step
    length, pos = PROMPT + NEW, PROMPT + NEW - 1
    results["k5_flash_decode"] = k5_row(
        torch, timer, rand, b, length, pos, nkv, nh // nkv, hd, None, 1.0,
        "granite-3-8b's fixed loop")
    return results


def _int_mm_ms(torch, timer, qa, qb):
    """One cuBLASLt int8 product (no scales, no epilogue), the yardstick
    of K2, in the fastest of two operand forms: ``qb`` [K, N] as K2 gets
    it (the transposed view of the [N, K] weight, column-major) and its
    row-major copy.  Returns (ms, form), (None, None) where
    ``torch._int_mm`` refuses the shape (it refuses M <= 16)."""
    forms = {"[N, K] weight's .t() view": qb,
             "[K, N] row-major": qb.contiguous()}
    best = (None, None)
    for form, b in forms.items():
        try:
            torch._int_mm(qa, b)
        except RuntimeError:
            continue
        ms = timer(lambda: torch._int_mm(qa, b))
        if best[0] is None or ms < best[0]:
            best = (ms, form)
    return best


def check_int8_kernels(torch, timer):
    """K2 (int8 GEMM) against its plain version at granite-3-8b's and
    gemma3-12b's widths, at decode (M = 8 lanes) and at a prefill chunk
    (M = 8 x 64), and at paligemma-3b's at decode (M = 8), the weights in
    ``QuantizedWeight``'s K-major [N, K] storage.  Every
    fp32-out product is bitwise (also at a 64 x 32 tile, K and N below one
    128-value box, M = 64 and ragged M in both regimes).  bf16 outputs:
    every row within one bf16 ulp of its scale (the same fp32 values, so
    in practice bitwise).  The up GEMM's (q, scale): q within +-1 and the
    scale within 2 fp32 ulps (the silu may differ by an ulp).  The normed
    output is bitwise the standalone rmsnorm of the stored value.  The row
    passes themselves are ``check_row_passes``."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.epilogue import Epilogue

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    eps_f32 = float(torch.finfo(torch.float32).eps)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    d, ff, qkv_n = 4096, 12800, 6144
    results, shapes = {}, []
    # K2 on the s8 wgmma: the fp32-out product bitwise its plain version at
    # a 64 x 32 tile, at M = 8, 64 and 512 and at ragged M in both regimes,
    # fed the [N, K] weight's [K, N] view (QuantizedWeight's layout); K and
    # N shorter than one 128-value box (the smoke configs') are zero-filled
    def kmajor(q):
        return q.t().contiguous().t()

    for m, k, n in ((64, 32, 64), (8, 64, 192), (LANES, d, qkv_n),
                    (64, d, qkv_n), (LANES * CHUNK, d, qkv_n), (37, ff, d),
                    (200, d, 272)):
        qa, sa = ref.quantize_rowwise_ref(rand(m, k))
        qb, sb = ref.quantize_colwise_ref(rand(k, n, scale=k ** -0.5))
        qb = kmajor(qb)
        require(torch.equal(ops.int8_matmul(qa, sa, qb, sb),
                            ref.int8_matmul_ref(qa, sa, qb, sb)),
                f"K2 M={m} K={k} N={n}: fp32 out is not bitwise")

    # K2: the five projections of one block with their epilogues, at
    # granite-3-8b's, gemma3-12b's and paligemma-3b's widths
    for model, m in (("granite", LANES), ("granite", LANES * CHUNK),
                     ("gemma3", LANES), ("gemma3", LANES * CHUNK),
                     ("paligemma", PG_BATCH), ("recurrentgemma", RG_BATCH)):
        d, qkv_n, o_k, ff = K1_WIDTHS[model][:4]
        qx, sx = ref.quantize_rowwise_ref(rand(m, d))
        qo, so = ref.quantize_rowwise_ref(rand(m, o_k))
        qh, sh = ref.quantize_rowwise_ref(rand(m, ff))
        w = {}
        for name, (k, n) in (("qkv", (d, qkv_n)), ("o", (o_k, d)),
                             ("gate", (d, ff)), ("up", (d, ff)),
                             ("down", (ff, d))):
            qb, sb = ref.quantize_colwise_ref(rand(k, n, scale=k ** -0.5))
            w[name] = (kmajor(qb), sb)
        g = rand(m, ff).to(bf)
        res = rand(m, d).to(bf)
        nscale = rand(d, scale=0.1)
        cases = {
            "qkv": ((qx, sx), Epilogue(out_dtype=bf), {}),
            "o": ((qo, so), Epilogue(out_dtype=bf), {}),
            "gate": ((qx, sx), Epilogue(out_dtype=bf), {}),
            "up": ((qx, sx), Epilogue(gate="silu", quantize=True),
                   {"operand2": g}),
            "down": ((qh, sh), Epilogue(residual=True, norm="rmsnorm",
                                        out_dtype=bf),
                     {"residual": res, "norm_scale": nscale}),
        }
        for name, ((qa, sa), ep, kw) in cases.items():
            qb, sb = w[name]
            f32 = ops.int8_matmul(qa, sa, qb, sb)
            require(torch.equal(f32, ref.int8_matmul_ref(qa, sa, qb, sb)),
                    f"K2 {name} M={m}: fp32 out is not bitwise")
            got = ops.int8_matmul(qa, sa, qb, sb, epilogue=ep, **kw)
            want = ref.int8_matmul_ref(qa, sa, qb, sb, ep, **kw)
            if ep.quantize:
                q_err = int((got[0].int() - want[0].int()).abs().max())
                s_err = float(((got[1] - want[1]).abs() / want[1]).max())
                require(q_err <= 1 and s_err <= 2 * eps_f32,
                        f"K2 up M={m}: q off by {q_err}, scale by {s_err}")
                err, abs_err = s_err, float(q_err)
            elif ep.norm != "none":
                require(torch.equal(got[1], ops.rmsnorm(got[0], nscale,
                                                        ep.norm_eps)),
                        "K2 normed output is not store-then-rmsnorm")
                err = max(row_err(got[0], want[0]), row_err(got[1], want[1]))
                abs_err = max(max_err(got[0], want[0]),
                              max_err(got[1], want[1]))
            else:
                err, abs_err = row_err(got, want), max_err(got, want)
            require(err <= eps_bf16,
                    f"K2 {name} M={m}: a row is off by {err:.3e}")
            mm, kk = qa.shape
            nn = qb.shape[1]
            nbytes = mm * kk + kk * nn + 4 * (mm + nn)
            if ep.quantize:        # operand2 in; q and its row scales out
                nbytes += 2 * mm * nn + mm * nn + 4 * mm
            elif ep.norm != "none":  # residual and norm scale in, two out
                nbytes += 3 * 2 * mm * nn + 4 * nn
            else:
                nbytes += 2 * mm * nn
            lib, form = _int_mm_ms(torch, timer, qa, qb)
            row = {"model": model, "shape": f"{name} M={mm} K={kk} N={nn}",
                   "max_abs_err": abs_err, "max_row_err": err,
                   "ms": timer(lambda: ops.int8_matmul(qa, sa, qb, sb,
                                                       epilogue=ep, **kw)),
                   "wrapper_ms": timer.wall(lambda: ops.int8_matmul(
                       qa, sa, qb, sb, epilogue=ep, **kw)),
                   "plain_ms": timer(lambda: ref.int8_matmul_ref(
                       qa, sa, qb, sb, ep, **kw)),
                   "library_ms": lib, "library_form": form}
            if lib is None:
                # _int_mm refuses M <= 16: its time on the rows zero-padded
                # to 32 (another shape, recorded as such)
                pad = torch.zeros((32, kk), dtype=torch.int8, device="cuda")
                pad[:mm] = qa
                row["library_ms"], row["library_form"] = _int_mm_ms(
                    torch, timer, pad, qb)
                row["library_padded_rows"] = 32
            row["bound_ms"], row["bound_by"] = bound(
                nbytes, 2 * mm * kk * nn, INT8_OPS_PER_S)
            shapes.append(row)
            print("  k2", json.dumps(row), flush=True)
    for key, model, m in (
            ("k2_int8_matmul", "granite", LANES),
            ("k2_int8_matmul_m512", "granite", LANES * CHUNK),
            ("k2_int8_matmul_gemma3", "gemma3", LANES),
            ("k2_int8_matmul_gemma3_m512", "gemma3", LANES * CHUNK),
            ("k2_int8_matmul_paligemma", "paligemma", PG_BATCH),
            ("k2_int8_matmul_recurrentgemma", "recurrentgemma", RG_BATCH)):
        rows = [r for r in shapes
                if r["model"] == model and f" M={m} " in r["shape"]]
        lib = [r["library_ms"] for r in rows]
        padded = any("library_padded_rows" in r for r in rows)
        results[key] = dict(
            work=f"one {model} decoder block's five int8 projections at "
                 f"M={m}: "
                 f"qkv, o, gate, up+silu gate+quantize, down+residual+"
                 f"rmsnorm (the row passes as tails at decode, row kernels "
                 f"at M >= 64); fp32 out also bitwise at a 64 x 32 tile, "
                 f"M = 8, 37, 64, 200 and 512",
            max_abs_err=max(r["max_abs_err"] for r in rows),
            max_row_err=max(r["max_row_err"] for r in rows), tol=eps_bf16,
            ms=sum(r["ms"] for r in rows),
            wrapper_ms=sum(r["wrapper_ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                      else "operations"),
            library_ms=None if None in lib else sum(lib),
            library_forms=[r["library_form"] for r in rows],
            library_note=(
                "torch._int_mm (cuBLASLt int8, no epilogue), the fastest of "
                "the [N, K] weight's .t() view and a [K, N] row-major copy"
                + ("; it refuses M <= 16, so it ran on the rows zero-padded "
                   "to 32, another shape" if padded else "")),
            shapes=rows)
    return results


def kernel_ms(torch, flush, fn, reps: int = 10, skip: str = "elementwise"):
    """The call's kernels' own time on the card: the sum of their CUPTI
    durations in a ``torch.profiler`` trace of ``reps`` calls, each after
    an L2 flush (``flush``'s bits inverted; its kernel is left out, with
    every kernel whose name holds ``skip``: a plain-torch call's own
    elementwise kernels count under ``skip="bitwise_not"``), per call.
    No launch, no event and no gap between kernels is in it, which a
    row pass of a few microseconds needs: the event timer's floor
    (``launch_floor``) is of their size.  A trace that holds none of the
    call's kernels gives None (not measured), never 0."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.bitwise_not(flush, out=flush)
            fn()
        torch.cuda.synchronize()
    times = [getattr(ev, "device_time_total", None) or ev.cuda_time_total
             for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and skip not in ev.name]
    return sum(times) / reps / 1e3 if times else None


def launch_floor(timer, cupti) -> dict:
    """The launch floor: one empty kernel (``k0_empty``) through
    ``_cuda.launch``, by the same timers as the row passes (device time:
    the events around an empty launch; wrapper time: with the host's
    launch inside; its CUPTI duration, ``kernel_ms``, comes from the
    ``cupti`` pass)."""
    from repro_torch.kernels import _cuda

    def empty():
        _cuda.launch("matmul", "k0_empty")
    floor = dict(ms=timer(empty), wrapper_ms=timer.wall(empty))
    cupti.append(([floor], "kernel_ms", empty))
    return floor


def row_timing(timer, cupti, fn, plain, nbytes, library=None) -> dict:
    """A row pass's device and wrapper ms beside its plain version's, one
    PyTorch call's (where one computes the same function) and its bytes
    bound (each input read once, each output written once); its
    ``kernel_ms`` comes from the ``cupti`` pass."""
    t_b, by = bound(nbytes, 0)
    row = dict(ms=timer(fn), wrapper_ms=timer.wall(fn), plain_ms=timer(plain),
               bound_ms=t_b, bound_by=by,
               library_ms=timer(library) if library else None)
    cupti.append(([row], "kernel_ms", fn))
    return row


def also_into(cupti, src: dict, dst: dict) -> None:
    """``dst`` gets the CUPTI times recorded for ``src`` too (a row's
    summary and its primary row count: the same calls)."""
    for targets, *_ in cupti:
        if any(t is src for t in targets):
            targets.append(dst)


def cupti_pass(torch, cupti) -> None:
    """The last phase: the rows of each recorded ``(rows, key, call)`` (or
    ``(rows, key, call, kw)``, ``kw`` ``kernel_ms``' ``skip`` and
    ``reps``) get the call's CUPTI kernel time (``kernel_ms``) under
    ``key``, and each
    tail row its ``tail_ms``.  It runs last, after the served paths, so
    that no ``torch.profiler`` session precedes their host-bound timing
    (see ``Timer`` for what many traces in one process did)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for rows, key, fn, *kw in cupti:
        ms = kernel_ms(torch, flush, fn, **(kw[0] if kw else {}))
        for row in rows:
            row[key] = ms
    for rows, *_ in cupti:
        for row in rows:
            if "gemm_kernel_ms" in row:
                row["tail_ms"] = (row["kernel_ms"] - row["gemm_kernel_ms"]
                                  if None not in (row["kernel_ms"],
                                                  row["gemm_kernel_ms"])
                                  else None)


def quantize_ties(torch, x):
    """Rows of fp32 values (k + 1/2) * scale for random k in [-127, 126],
    nudged by -1, 0 or +1 ulp, with each row's absmax, and so its scale,
    kept from ``x``: the quotients x / scale sit on or a rounding away
    from the half-integers."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp(min=1e-12) * (1.0 / 127.0)
    gen = torch.Generator(device=x.device).manual_seed(SEED + 9)
    k = torch.randint(-127, 127, x.shape, generator=gen, device=x.device)
    ties = (k.to(torch.float32) + 0.5) * scale
    step = torch.randint(-1, 2, x.shape, generator=gen, device=x.device)
    ties = torch.where(step == 0, ties, torch.nextafter(
        ties, ties + step.to(torch.float32) * float("inf")))
    ties[:, :1] = absmax
    return ties


def check_row_passes(torch, timer, floor, cupti):
    """Phase 2, the row kernels (one warp a row, ``rmsnorm_row`` and
    ``quantize_row`` in ``csrc/matmul.cu``): the standalone rmsnorm bitwise
    its ordered mirror (``ref.rmsnorm_rows_ref``) and within one bf16 ulp
    of each row's scale of ``rms_normalize``, at granite's and gemma2's
    widths and the rows of every driven path (and 5); K3 bitwise its plain
    version, bf16 and fp32, at decode, ragged and chunk rows, and on
    quotients at and beside the half-integers (``quantize_ties``).  The
    rmsnorm and K3 timed at [8, 4096] and [512, 4096] bf16, K2's row pass
    (K3 on the up GEMM's fp32 value, which runs at M >= 64 only) at
    [512, 12800] and [8, 12800] fp32, each beside the launch floor; the
    CUPTI kernel times are recorded in ``cupti`` for the last phase."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.epilogue import rms_normalize
    from repro_torch.kernels.quantize import quantize_rowwise_cuda

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bf, f32 = torch.bfloat16, torch.float32

    def rand(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    d, ff = 4096, 12800
    floor_keys = dict(floor_ms=floor["ms"],
                      floor_wrapper_ms=floor["wrapper_ms"])
    results = {}
    errs, abs_errs = [], []
    for dm, rows in ((d, (BATCH, 5, LANES, LANES * CHUNK, 1024)),
                     (4608, (G2_BATCH, LANES, LANES * CHUNK))):
        nscale = rand(dm, dtype=f32, scale=0.1)
        for m in rows:
            x = rand(m, dm)
            got = ops.rmsnorm(x, nscale)
            require(torch.equal(got, ref.rmsnorm_rows_ref(x, nscale, 1e-6)),
                    f"rmsnorm [{m}, {dm}] is not bitwise its ordered mirror")
            want = rms_normalize(x, nscale, 1e-6)
            errs.append(row_err(got, want))
            abs_errs.append(max_err(got, want))
    err = max(errs)
    require(err <= eps_bf16, f"rmsnorm: a row is off by {err:.3e}")
    nscale = rand(d, dtype=f32, scale=0.1)
    w1 = (1.0 + nscale).to(bf)
    at = {}
    for m in (LANES, LANES * CHUNK):
        x = rand(m, d)
        # (each call binds its own x: the cupti pass calls them later)
        at[m] = row_timing(
            timer, cupti, lambda x=x: ops.rmsnorm(x, nscale),
            lambda: rms_normalize(x, nscale, 1e-6), 2 * 2 * x.numel() + 4 * d,
            (lambda: F.rms_norm(x, (d,), w1, 1e-6))
            if hasattr(F, "rms_norm") else None)
    results["k1_rmsnorm"] = dict(
        work=f"rmsnorm rows [{LANES}, {d}] bf16, one warp a row (bitwise its "
             f"ordered mirror; also at {BATCH}, 5, 512 and 1024 rows, and at "
             f"[2 | 8 | 512, 4608]); 'rows' also times [512, {d}]",
        max_abs_err=max(abs_errs), max_row_err=err, tol=eps_bf16,
        **at[LANES], rows={str(m): v for m, v in at.items()}, **floor_keys)
    also_into(cupti, at[LANES], results["k1_rmsnorm"])

    # K3: bitwise its plain version, both instantiations, and on values a
    # few ulps from the half-integers of x / scale, where the kernel's
    # reciprocal multiply defers to the division
    for shape, dt in (((LANES, d), bf), ((5, d), bf), ((LANES * CHUNK, d), bf),
                      ((LANES, ff), f32), ((37, ff), f32),
                      ((LANES * CHUNK, ff), f32), ((LANES, ff), "ties")):
        x = (quantize_ties(torch, rand(*shape, dtype=f32)) if dt == "ties"
             else rand(*shape, dtype=dt, scale=3.0))
        got, want = ops.quantize_rowwise(x), ref.quantize_rowwise_ref(x)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"K3 {shape} {dt} is not bitwise its plain version")
    at = {}
    for m in (LANES, LANES * CHUNK):
        x = rand(m, d, scale=3.0)
        at[m] = row_timing(timer, cupti, lambda x=x: ops.quantize_rowwise(x),
                           lambda: ref.quantize_rowwise_ref(x),
                           2 * x.numel() + x.numel() + 4 * m)
    results["k3_quantize"] = dict(
        work=f"rowwise quantize of the normed stream [{LANES}, {d}] bf16, one "
             f"warp a row (bitwise; also at 5 and 512 rows, and fp32 at "
             f"[8 | 37 | 512, {ff}]); 'rows' also times [512, {d}]",
        max_abs_err=0.0, max_row_err=0.0, tol=0.0, **at[LANES],
        rows={str(m): v for m, v in at.items()}, **floor_keys)
    also_into(cupti, at[LANES], results["k3_quantize"])

    # K2's row pass where it still launches (M >= 64): the up GEMM's fp32
    # value at a chunk's rows -> (q, scale)
    at = {}
    for m in (LANES * CHUNK, LANES):
        w32 = rand(m, ff, dtype=f32)
        got = quantize_rowwise_cuda(w32, count="int8_quantize")
        want = ref.quantize_rowwise_ref(w32)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"the K2 row pass [{m}, {ff}] is not bitwise its plain "
                f"version")
        at[m] = row_timing(
            timer, cupti,
            lambda w32=w32: quantize_rowwise_cuda(w32, count="int8_quantize"),
            lambda: ref.quantize_rowwise_ref(w32),
            4 * w32.numel() + w32.numel() + 4 * m)
    results["k2_quantize_rows"] = dict(
        work=f"the up GEMM's (q, scale) row kernel over [{LANES * CHUNK}, "
             f"{ff}] fp32, a chunk's rows, where it still launches (at "
             f"decode the GEMM's tail does it); 'rows' also times "
             f"[{LANES}, {ff}]",
        max_abs_err=0.0, max_row_err=0.0, tol=0.0, **at[LANES * CHUNK],
        rows={str(m): v for m, v in at.items()}, **floor_keys)
    also_into(cupti, at[LANES * CHUNK], results["k2_quantize_rows"])
    return results


# the fused row passes are checked at these rows (the driven paths' decode
# rows and a ragged one); the tail and the two launches it replaces are
# timed at TAIL_SWEEP rows, across the bytes regime, where the plan takes
# the tail
TAIL_ROWS = (2, 4, 5, 8)
TAIL_SWEEP = (2, 4, 8, 16, 32, 63)


def check_row_tails(torch, timer, cupti):
    """Phase 2, the row passes in K1's and K2's store phase at decode: at
    M = 2, 4, 5 and 8, granite's down GEMM through K1 and K2 and gemma2's
    through K1 give the value bitwise the same GEMM's without the norm and
    the normed output bitwise the standalone rmsnorm of that value and its
    ordered mirror, in one launch (``matmul:norm``, ``int8_matmul:norm``);
    granite's int8 up GEMM gives (q, scale) bitwise K3 (kernel and plain
    version) of the fp32 value the same GEMM stores without the quantize,
    in one launch (``int8_matmul:quantize``).  Each timed at M = 8 beside
    the GEMM alone and the two launches it replaces (the GEMM, then the
    row kernel), and at every M of ``TAIL_SWEEP``; the CUPTI kernel times
    of the tail, the GEMM alone and the two launches are recorded in
    ``cupti`` for the last phase."""
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels.epilogue import Epilogue
    from repro_torch.kernels.quantize import quantize_rowwise_cuda

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    bf, f32 = torch.bfloat16, torch.float32
    top = max(TAIL_SWEEP)

    def rand(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    def launched(fn, key):
        before = dict(_cuda.LAUNCHES)
        out = fn()
        diff = {k: n - before.get(k, 0) for k, n in _cuda.LAUNCHES.items()
                if n != before.get(k, 0)}
        require(diff.get(key) == 1 and not any(
            diff.get(k) for k in ("rmsnorm", "quantize", "int8_quantize")),
            f"{key}: the fused row pass launched {diff}")
        return out

    def kmajor(q):
        return q.t().contiguous().t()

    norm = Epilogue(residual=True, norm="rmsnorm", out_dtype=bf)
    plain_ep = Epilogue(residual=True, out_dtype=bf)
    results = {}
    cases = {}
    for model, (k, n) in (("granite", (12800, 4096)),
                          ("gemma2", (36864, 4608))):
        h, res = rand(top, k), rand(top, n)
        cases[("k1", model)] = (h, rand(k, n, scale=k ** -0.5), res,
                                rand(n, dtype=f32, scale=0.1))
    qh, sh = ref.quantize_rowwise_ref(rand(top, 12800, dtype=f32))
    qd, sd = ref.quantize_colwise_ref(rand(12800, 4096, dtype=f32,
                                           scale=12800 ** -0.5))
    k2_down = (qh, sh, kmajor(qd), sd, rand(top, 4096),
               rand(4096, dtype=f32, scale=0.1))
    qx, sx = ref.quantize_rowwise_ref(rand(top, 4096, dtype=f32))
    qu, su = ref.quantize_colwise_ref(rand(4096, 12800, dtype=f32,
                                           scale=4096 ** -0.5))
    k2_up = (qx, sx, kmajor(qu), su, rand(top, 12800))
    gate_f32 = Epilogue(gate="silu", out_dtype=f32)
    gate_q = Epilogue(gate="silu", quantize=True)

    def k1_calls(model, m):
        h, w, res, ns = cases[("k1", model)]
        h, res = h[:m], res[:m]
        return (lambda: ops.matmul(h, w, epilogue=norm, residual=res,
                                   norm_scale=ns),
                lambda: ops.matmul(h, w, epilogue=plain_ep, residual=res),
                ns, (h, w, res))

    def k2_norm_calls(m):
        qa, sa, qb, sb, res, ns = k2_down
        qa, sa, res = qa[:m], sa[:m], res[:m]
        return (lambda: ops.int8_matmul(qa, sa, qb, sb, epilogue=norm,
                                        residual=res, norm_scale=ns),
                lambda: ops.int8_matmul(qa, sa, qb, sb, epilogue=plain_ep,
                                        residual=res),
                ns, (qa, sa, qb, sb, res))

    def k2_quant_calls(m):
        qa, sa, qb, sb, g = k2_up
        qa, sa, g = qa[:m], sa[:m], g[:m]
        return (lambda: ops.int8_matmul(qa, sa, qb, sb, epilogue=gate_q,
                                        operand2=g),
                lambda: ops.int8_matmul(qa, sa, qb, sb, epilogue=gate_f32,
                                        operand2=g),
                (qa, sa, qb, sb, g))

    for m in TAIL_ROWS:
        for key, calls in (("matmul:norm", k1_calls("granite", m)),
                           ("matmul:norm", k1_calls("gemma2", m)),
                           ("int8_matmul:norm", k2_norm_calls(m))):
            fused, alone, ns, _ = calls
            value, normed = launched(fused, key)
            require(torch.equal(value, alone()),
                    f"{key} M={m}: the value differs from the GEMM's own")
            require(torch.equal(normed, ops.rmsnorm(value, ns)),
                    f"{key} M={m}: the fused normed output is not bitwise "
                    f"the standalone rmsnorm of the stored value")
            require(torch.equal(normed, ref.rmsnorm_rows_ref(value, ns,
                                                             1e-6)),
                    f"{key} M={m}: the fused normed output is not bitwise "
                    f"the ordered mirror")
        fused, alone, _ = k2_quant_calls(m)
        q, scale = launched(fused, "int8_matmul:quantize")
        value = alone()
        for name, (wq, ws) in (("K3", ops.quantize_rowwise(value)),
                               ("K3's plain version",
                                ref.quantize_rowwise_ref(value))):
            require(torch.equal(q, wq) and torch.equal(scale, ws),
                    f"int8_matmul:quantize M={m}: (q, scale) is not bitwise "
                    f"{name} of the stored value")

    def tail_row(work, fused, alone, second, plain, nbytes, m=LANES):
        sweep = {}
        for mm in TAIL_SWEEP:
            f, a = fused(mm), alone(mm)
            sweep[str(mm)] = dict(fused_ms=timer(f),
                                  two_launches_ms=timer(lambda: second(a())))
        f, a = fused(m), alone(m)
        t_b, by = bound(nbytes, 0)
        row = dict(work=work, max_abs_err=0.0, max_row_err=0.0, tol=0.0,
                   ms=timer(f), wrapper_ms=timer.wall(f), gemm_ms=timer(a),
                   two_launches_ms=timer(lambda: second(a())),
                   two_launches_wrapper_ms=timer.wall(lambda: second(a())),
                   plain_ms=timer(plain(m)), bound_ms=t_b, bound_by=by,
                   library_ms=None,
                   library_note="no one PyTorch call computes a GEMM with a "
                                "row norm or a row quantize",
                   sweep=sweep)
        cupti.extend([([row], "kernel_ms", f), ([row], "gemm_kernel_ms", a),
                      ([row], "two_launches_kernel_ms",
                       lambda: second(a()))])
        print("  tail", json.dumps(row), flush=True)
        return row

    def k1_plain(m):
        h, w, res = k1_calls("granite", m)[3]
        ns = cases[("k1", "granite")][3]
        return lambda: ref.matmul_fused_ref(h, w, norm, residual=res,
                                            norm_scale=ns)

    def k2_norm_plain(m):
        qa, sa, qb, sb, res = k2_norm_calls(m)[3]
        return lambda: ref.int8_matmul_ref(qa, sa, qb, sb, norm, residual=res,
                                           norm_scale=k2_down[5])

    def k2_quant_plain(m):
        qa, sa, qb, sb, g = k2_quant_calls(m)[2]
        return lambda: ref.int8_matmul_ref(qa, sa, qb, sb, gate_q,
                                           operand2=g)

    ns_k1 = cases[("k1", "granite")][3]
    m, k, n = LANES, 12800, 4096
    results["k1_matmul_norm_tail"] = tail_row(
        f"K1's down GEMM at decode, M={m} K={k} N={n}: residual and the "
        f"rmsnorm in its store phase, one launch (bitwise store-then-rmsnorm "
        f"and the ordered mirror at M = {TAIL_ROWS}, also at gemma2's "
        f"[36864, 4608]); 'two_launches_ms' is the GEMM and the row kernel",
        lambda mm: k1_calls("granite", mm)[0],
        lambda mm: k1_calls("granite", mm)[1],
        lambda v: ops.rmsnorm(v, ns_k1), k1_plain,
        2 * (m * k + k * n + 3 * m * n) + 4 * n)
    ns_k2 = k2_down[5]
    results["k2_int8_matmul_norm_tail"] = tail_row(
        f"K2's down GEMM at decode, M={m} K={k} N={n}: the scales, the "
        f"residual and the rmsnorm in its store phase, one launch (bitwise "
        f"store-then-rmsnorm and the ordered mirror at M = {TAIL_ROWS})",
        lambda mm: k2_norm_calls(mm)[0], lambda mm: k2_norm_calls(mm)[1],
        lambda v: ops.rmsnorm(v, ns_k2), k2_norm_plain,
        m * k + k * n + 4 * (m + n) + 3 * 2 * m * n + 4 * n)
    k, n = 4096, 12800
    results["k2_int8_matmul_quantize_tail"] = tail_row(
        f"K2's up GEMM at decode, M={m} K={k} N={n}: the scales, the silu "
        f"gate and the row quantize in its store phase, one launch ((q, "
        f"scale) bitwise K3 of the stored fp32 value at M = {TAIL_ROWS}); "
        f"'two_launches_ms' is the GEMM storing fp32 and K3's row kernel",
        lambda mm: k2_quant_calls(mm)[0], lambda mm: k2_quant_calls(mm)[1],
        lambda v: quantize_rowwise_cuda(v, count="int8_quantize"),
        k2_quant_plain,
        m * k + k * n + 4 * (m + n) + 2 * m * n + m * n + 4 * m)
    return results


def chunk_contracts(torch, q, kp, vp, table, positions, lane, **var):
    """K6's prefill-chunk body (S > 1): no records, two launches bitwise
    equal, every row at position -1 (idle lanes, a padded tail) exactly
    0.0, and ``lane``'s output bitwise the same after every other lane's
    pages are remapped and its positions changed.  Raises on a miss;
    returns the body's output."""
    from repro_torch.kernels.flash_attention import paged_decode_launch
    out, ws = paged_decode_launch(q, kp, vp, table, positions, **var)
    require(ws is None, "K6 chunk: the chunk body returned records")
    again, _ = paged_decode_launch(q, kp, vp, table, positions, **var)
    require(torch.equal(out, again), "K6 chunk: two launches differ")
    require(bool((out[positions < 0] == 0).all()),
            "K6 chunk: an idle row or a padded tail is not 0.0")
    others = torch.arange(table.shape[0], device=table.device) != lane
    table2, pos2 = table.clone(), positions.clone()
    table2[others] = torch.roll(table[others], 1, dims=1)
    pos2[others] = torch.where(positions[others] >= 0,
                               positions[others] // 2, -1)
    moved, _ = paged_decode_launch(q, kp, vp, table2, pos2, **var)
    require(torch.equal(moved[lane], out[lane]),
            f"K6 chunk: lane {lane} changed when its neighbours moved")
    return out


def check_chunk_head_dims(torch):
    """K6's chunk body once at each head dim it takes, at a small size (4
    lanes, 2 kv heads, G = 2, 16-slot pages, S = 32, one lane idle, a
    padded tail, an unmapped page inside a lane's range), local window 16
    with softcap: each row within 2 bf16 ulps of its scale of the plain
    version, and ``chunk_contracts``."""
    from repro_torch.kernels.flash_attention import (_HEAD_DIMS,
                                                     paged_flash_decode_tiled)
    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    L, KV, G, ps, P, s_q = 4, 2, 2, PAGE, 8, 32
    var = dict(kind="local", window=16, softcap=G2_SOFTCAP)
    lane_pos = torch.tensor([5, 40, 127, -1], dtype=torch.int32)
    table = torch.randperm(L * P, generator=torch.Generator().manual_seed(
        SEED)).reshape(L, P).to(torch.int32)
    for lane in range(L):
        table[lane, max(int(lane_pos[lane]), 0) // ps + 1:] = -1
    table[2, 6] = -1     # a hole inside lane 2's window
    pc = lane_pos.clamp(min=0)[:, None] - s_q + 1 + torch.arange(s_q)[None]
    pc = torch.where((pc >= 0) & (lane_pos[:, None] >= 0), pc, -1)
    pc[1, -3:] = -1      # a final chunk's padded tail
    table, pc = table.cuda(), pc.to(torch.int32).cuda().contiguous()
    errs = {}
    for hd in _HEAD_DIMS:
        def rand(*shape):
            return (torch.randn(shape, generator=gen, device="cuda") * 3.0
                    ).to(torch.bfloat16)
        kp, vp = rand(L * P + 1, ps, KV, hd), rand(L * P + 1, ps, KV, hd)
        q = rand(L, s_q, KV, G, hd)
        out = chunk_contracts(torch, q, kp, vp, table, pc, 2, **var)
        errs[hd] = row_err(out, paged_flash_decode_tiled(q, kp, vp, table,
                                                         pc, **var))
    require(max(errs.values()) <= 2 * eps_bf16,
            f"K6 chunk by head dim: rows off by {errs}")
    return dict(work=f"K6 chunk body L={L} KV={KV} G={G} S={s_q} "
                     f"page_size={ps}, window 16 + softcap, positions "
                     f"{lane_pos.tolist()}, a padded tail and a hole",
                row_err_by_head_dim=errs, tol=2 * eps_bf16)


def check_paged_kernel(torch, timer):
    """K6 at L = 8 lanes, KV = 8, G = 4, hd = 128, page_size 16, P = 32
    pages (16 tiles of 32 slots), shuffled pages, mixed positions and one
    idle lane.  Decode: bitwise K5 over each lane's history in a dense
    cache, and the idle lane exactly 0.0; partials within 1e-5 of each
    row's scale of the plain version (fp32, another summation order); the
    S = 64 prefill chunk within 2 bf16 ulps of each row's scale."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (paged_decode_launch,
                                                     paged_flash_decode_tiled,
                                                     paged_tile_partials)

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bf = torch.bfloat16
    L, KV, G, hd, ps, P = LANES, 8, 4, 128, PAGE, 32
    n_pages = L * P

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    kp, vp = rand(n_pages + 1, ps, KV, hd), rand(n_pages + 1, ps, KV, hd)
    pos = torch.tensor([0, 31, 32, 100, 255, 300, 511, -1],
                       dtype=torch.int32)
    table = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        SEED)).reshape(L, P).to(torch.int32)
    for lane in range(L):
        table[lane, max(int(pos[lane]), 0) // ps + 1:] = -1
    table = table.cuda()
    posd = pos.cuda()[:, None].contiguous()
    q = rand(L, 1, KV, G, hd)
    got = ops.paged_flash_decode(q, kp, vp, table, posd)
    require(bool((got[L - 1] == 0).all()), "K6: the idle lane is not 0.0")
    for lane in range(L - 1):
        kd = torch.zeros((1, P * ps, KV, hd), dtype=bf, device="cuda")
        vd = torch.zeros_like(kd)
        for page, phys in enumerate(table[lane].tolist()):
            if phys >= 0:
                kd[0, page * ps:(page + 1) * ps] = kp[phys]
                vd[0, page * ps:(page + 1) * ps] = vp[phys]
        require(torch.equal(got[lane:lane + 1], ops.flash_decode(
            q[lane:lane + 1], kd, vd, int(pos[lane]))),
            f"K6 lane {lane} is not bitwise K5 over the same history")
    pair_err = row_err(got, paged_flash_decode_tiled(q, kp, vp, table, posd))
    require(pair_err <= 2 * eps_bf16, f"K6 decode: a row is off by "
                                      f"{pair_err:.3e}")
    rows, n_tiles = L * KV, P * ps // 32
    out, ws = paged_decode_launch(q, kp, vp, table, posd)
    require(torch.equal(out, got), "K6: two launches differ")
    p_err = record_err(torch, ws, paged_tile_partials(q, kp, vp, table, posd),
                       rows, n_tiles, G, hd)
    require(p_err <= 1e-5, f"K6 partials: a row is off by {p_err:.3e}")
    # the S = 64 prefill chunk ending at each lane's position
    # (the flash-prefill body), lane 3's with a padded tail as a prompt's
    # last chunk has; then with an unmapped page inside lane 5's range
    s_q = CHUNK
    qc = rand(L, s_q, KV, G, hd)
    pc = (pos.clamp(min=0)[:, None] - s_q + 1 + torch.arange(s_q)[None])
    pc = torch.where((pc >= 0) & (pos[:, None] >= 0), pc, -1)
    pc[3, -5:] = -1
    pc = pc.to(torch.int32).cuda().contiguous()
    chunk = chunk_contracts(torch, qc, kp, vp, table, pc, 4)
    chunk_want = paged_flash_decode_tiled(qc, kp, vp, table, pc)
    chunk_err = row_err(chunk, chunk_want)
    holed = table.clone()
    holed[5, 10] = -1
    hole_err = row_err(ops.paged_flash_decode(qc, kp, vp, holed, pc),
                       paged_flash_decode_tiled(qc, kp, vp, holed, pc))
    require(max(chunk_err, hole_err) <= 2 * eps_bf16,
            f"K6 chunk: a row is off by {chunk_err:.3e} ({hole_err:.3e} "
            f"with a hole)")
    where = (f"L={L} KV={KV} G={G} hd={hd} page_size={ps} P={P} "
             f"({n_tiles} tiles)")
    dec = dict(
        work=f"paged decode {where}, positions {pos.tolist()}; each lane "
             f"bitwise K5 over its dense history, the idle lane 0.0",
        max_abs_err=max_err(got, paged_flash_decode_tiled(q, kp, vp, table,
                                                          posd)),
        max_row_err=pair_err, tol=2 * eps_bf16, partials_row_err=p_err,
        partials_tol=1e-5,
        ms=timer(lambda: ops.paged_flash_decode(q, kp, vp, table, posd)),
        wrapper_ms=timer.wall(
            lambda: ops.paged_flash_decode(q, kp, vp, table, posd)),
        plain_ms=timer(lambda: paged_flash_decode_tiled(q, kp, vp, table,
                                                        posd)),
        library_ms=None,
        library_note="no one PyTorch call attends through a page table")
    dec["bound_ms"], dec["bound_by"] = k6_bound(q, table, posd, KV, 0)
    chk = dict(
        work=f"paged prefill chunk S={s_q} {where}, each lane's chunk "
             f"ending at its position (a padded tail; a hole checked), on "
             f"the flash-prefill body: deterministic, idle rows 0.0, a "
             f"lane unmoved by its neighbours",
        max_abs_err=max_err(chunk, chunk_want),
        max_row_err=max(chunk_err, hole_err), tol=2 * eps_bf16,
        ms=timer(lambda: ops.paged_flash_decode(qc, kp, vp, table, pc)),
        wrapper_ms=timer.wall(
            lambda: ops.paged_flash_decode(qc, kp, vp, table, pc)),
        plain_ms=timer(lambda: paged_flash_decode_tiled(qc, kp, vp, table,
                                                        pc), reps=3),
        library_ms=None,
        library_note="no one PyTorch call attends through a page table")
    chk["bound_ms"], chk["bound_by"] = k6_bound(qc, table, pc, KV, 0)
    return {"k6_paged_decode": dec, "k6_paged_decode_chunk": chk}


def check_wide_groups(torch):
    """K5 and K6 at G = 16 query heads per kv head (recurrentgemma-9b's 16
    heads over one kv head; at hd 128, the widest head dim the kernels
    take), which the kernel serves as two rows of 8 heads per kv head
    (``head_groups``): K5 bitwise the same at split counts 1, 2, the
    default and n_tiles and within 2 bf16 ulps of each row's scale of
    ``flash_decode_tiled``, its live records within 1e-5; K6 with 4 lanes
    (one idle) bitwise K5 over each lane's history in a dense cache, the
    idle lane exactly 0.0, within 2 bf16 ulps of
    ``paged_flash_decode_tiled``, its records within 1e-5; an S = 64
    chunk on K6's chunk body (8 q tiles of 8 positions x 16 heads) within
    2 bf16 ulps, with ``chunk_contracts``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (decode_tile_partials,
                                                     dense_decode_launch,
                                                     flash_decode_tiled,
                                                     head_groups,
                                                     paged_decode_launch,
                                                     paged_flash_decode_tiled,
                                                     paged_tile_partials)
    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    b, length, pos, kv, g, hd = 2, 300, 290, 2, 16, 128
    rows, n_tiles = b * kv, -(-length // 32)
    q, kc, vc = rand(b, 1, kv, g, hd), rand(b, length, kv, hd), \
        rand(b, length, kv, hd)
    out, ws = dense_decode_launch(q, kc, vc, pos)
    require(all(torch.equal(out, ops.flash_decode(q, kc, vc, pos, n_splits=n))
                for n in (1, 2, n_tiles)),
            "K5 at G = 16: the output changes with n_splits")
    dense_err = row_err(out, flash_decode_tiled(q, kc, vc, pos))
    dense_rec = record_err(torch, ws, decode_tile_partials(q, kc, vc, pos),
                           rows, n_tiles, g, hd)
    L, ps, P = 4, PAGE, 16
    kp, vp = rand(L * P + 1, ps, kv, hd), rand(L * P + 1, ps, kv, hd)
    lane_pos = torch.tensor([0, 77, 255, -1], dtype=torch.int32)
    table = torch.randperm(L * P, generator=torch.Generator().manual_seed(
        SEED)).reshape(L, P).to(torch.int32)
    for lane in range(L):
        table[lane, max(int(lane_pos[lane]), 0) // ps + 1:] = -1
    table, posd = table.cuda(), lane_pos.cuda()[:, None].contiguous()
    qp = rand(L, 1, kv, g, hd)
    got, pws = paged_decode_launch(qp, kp, vp, table, posd)
    require(bool((got[L - 1] == 0).all()),
            "K6 at G = 16: the idle lane is not 0.0")
    for lane in range(L - 1):
        ph = table[lane].clamp(min=0).long()
        kd = kp[ph].reshape(1, P * ps, kv, hd)
        vd = vp[ph].reshape(1, P * ps, kv, hd)
        require(torch.equal(got[lane:lane + 1], ops.flash_decode(
            qp[lane:lane + 1], kd, vd, int(lane_pos[lane]))),
            f"K6 lane {lane} at G = 16 is not bitwise K5 over its history")
    paged_err = row_err(got, paged_flash_decode_tiled(qp, kp, vp, table,
                                                      posd))
    paged_rec = record_err(torch, pws, paged_tile_partials(
        qp, kp, vp, table, posd), L * kv, P * ps // 32, g, hd)
    # K6's chunk body at G = 16: a q tile holds 8 chunk positions x 16
    # heads, so the S = 64 chunk is 8 q tiles
    s_q = CHUNK
    qc = rand(L, s_q, kv, g, hd)
    pc = lane_pos.clamp(min=0)[:, None] - s_q + 1 + torch.arange(s_q)[None]
    pc = torch.where((pc >= 0) & (lane_pos[:, None] >= 0), pc, -1)
    pc = pc.to(torch.int32).cuda().contiguous()
    chunk_err = row_err(chunk_contracts(torch, qc, kp, vp, table, pc, 1),
                        paged_flash_decode_tiled(qc, kp, vp, table, pc))
    require(max(dense_err, paged_err, chunk_err) <= 2 * eps_bf16
            and max(dense_rec, paged_rec) <= 1e-5,
            f"K5/K6 at G = 16: rows off by {dense_err:.3e}/{paged_err:.3e}/"
            f"{chunk_err:.3e} (chunk), records by "
            f"{dense_rec:.3e}/{paged_rec:.3e}")
    return dict(work=f"G={g} KV={kv} hd={hd}: {head_groups(g)[0]} kernel "
                     f"rows per kv head; K5 B={b} cache={length} pos={pos}, "
                     f"K6 lanes at {lane_pos.tolist()}, also an S={s_q} "
                     f"chunk on the chunk body",
                k5_row_err=dense_err, k6_row_err=paged_err,
                k6_chunk_row_err=chunk_err, tol=2 * eps_bf16,
                k5_records_err=dense_rec, k6_records_err=paged_rec,
                records_tol=1e-5)


def k6_bound(q, table, positions, kv, window, chunked=False):
    """K6's bound for q [L, S, KV, G, hd] at ``positions`` [L, S]: the
    bytes of q, the output, the table, the positions and each lane's
    attended K/V rows (read once), and the operations of the rows' scores
    and P.V (bf16 inputs).  ``window`` is a local window, or with
    ``chunked`` the chunk: a row at p attends from its chunk's start."""
    hd, g = q.shape[-1], q.shape[-2]
    keys, slots = 0, 0
    for lane in positions.cpu().tolist():
        live = [p for p in lane if p >= 0]
        if not live:
            continue
        if chunked:
            span = [p % window + 1 for p in live]
            first = min(live) // window * window
        else:
            span = [min(p + 1, window) if window else p + 1 for p in live]
            first = max(0, min(live) - window + 1) if window else 0
        keys += sum(span)
        slots += max(live) + 1 - first
    nbytes = (2 * 2 * q.numel() + 2 * 2 * slots * kv * hd
              + 4 * (table.numel() + positions.numel()))
    return bound(nbytes, 4 * keys * kv * g * hd)


def vary(torch, model, seed):
    """Random norm scales and tripled block weights, so greedy decoding of
    the small model changes token from step to step.  An RG-LRU mixer
    keeps its init (tripled, its recurrence gate saturates: a -> 1, and
    ``1 - a^2`` cancels to nothing; ``tests/test_torch_recurrentgemma.py``
    keeps it so too).  An xLSTM mixer (every block of xlstm) gets a random
    inner norm scale and its output projection (``down``, ``out``)
    tripled, its input and gate maps kept (tripled, they make the model
    chaotic; ``tests/test_torch_xlstm.py`` varies it so too).  An int8
    model (the releasing build's) triples its ``QuantizedWeight``s'
    column scales."""
    from repro_torch.kernels.quantize import QuantizedWeight
    gen = torch.Generator(device=model.device).manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            if ".mix." in name and (
                    model.cfg.kind(int(parts[1])) == "rglru"
                    or parts[-1] not in ("norm", "down", "out")):
                continue
            if p.dim() == 1:
                p.copy_(0.5 * torch.randn(p.shape, generator=gen,
                                          device=model.device))
            elif name != "embed":
                p.mul_(3)
        for m in model.modules():
            if isinstance(m, QuantizedWeight):
                m.scale.mul_(3)


def check_smoke_path(torch):
    """Phase 3: the whole path, card against CPU, on the smoke config."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True),
                              param_dtype="bfloat16")
    cpu = Model(cfg, device="cpu").init_weights(SEED)
    vary(torch, cpu, SEED)
    card = Model(cfg)
    card.load_state_dict(cpu.state_dict())
    ref32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                  device="cpu")
    ref32.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (BATCH, 16),
                         generator=torch.Generator().manual_seed(SEED))
    steps = 8
    want = ServeEngine(cpu, ServeConfig(max_new_tokens=steps)).generate(
        {"tokens": toks})
    got = ServeEngine(card, ServeConfig(max_new_tokens=steps)).generate(
        {"tokens": toks})
    require(got.shape == (BATCH, steps) and (got == want).all(),
            f"greedy tokens differ: card {got.tolist()} cpu {want.tolist()}")
    # the int8 copies: K2 and K3 on the card, their plain versions here
    want8 = ServeEngine(cpu, ServeConfig(max_new_tokens=steps, int8=True)
                        ).generate({"tokens": toks})
    got8 = ServeEngine(card, ServeConfig(max_new_tokens=steps, int8=True)
                       ).generate({"tokens": toks})
    require(got8.shape == (BATCH, steps) and (got8 == want8).all(),
            f"int8 greedy tokens differ: card {got8.tolist()} cpu "
            f"{want8.tolist()}")

    def rel(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max()
                     / max(1.0, float(b.abs().max())))

    lc, cc = cpu.prefill(toks, 16 + steps)
    lg, cg = card.prefill(toks, 16 + steps)
    l3, c3 = ref32.prefill(toks, 16 + steps)
    err, noise = [rel(lg, lc)], [rel(lc, l3)]
    for i in range(steps - 1):
        tok = torch.from_numpy(want[:, i:i + 1])
        lc, cc = cpu.decode_step(cc, tok, 16 + i)
        lg, cg = card.decode_step(cg, tok, 16 + i)
        l3, c3 = ref32.decode_step(c3, tok, 16 + i)
        err.append(rel(lg, lc))
        noise.append(rel(lc, l3))
    require(max(err) <= 2 * max(noise),
            f"card logits off by {max(err):.3e} of scale, budget "
            f"{2 * max(noise):.3e}")
    return dict(tokens=got.tolist(), int8_tokens=got8.tolist(),
                logit_err=max(err), budget=2 * max(noise),
                distinct_tokens=len(set(got.reshape(-1).tolist())))


def rel_rows(got, want) -> float:
    """Worst lane's max|got - want| over that lane's logit scale."""
    g, w = got.double().cpu(), want.double().cpu()
    return float(((g - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp(min=1.0)).max())


# Phase 4 witness: a decode step's logits against the last-position logits
# of a prefill over the same tokens (K5 against K4 on the new rows; every
# other op is row-local and the same code).  It runs at the reference's
# init scales (zero norm scales, 1/sqrt(fan_in) weights): the served run's
# varied weights triple wq and wk, so attention scores are about 9x
# sharper, and the rounding-level difference between K4 (P rounded to
# bf16) and K5 (P in fp32) flips near-tied softmax winners, which grows
# over 40 layers.  The tolerance is 5% of each lane's logit scale (the CPU
# test test_decode_matches_prefill_at_init_scales holds the plain versions
# to the same bound at 40 layers), and the same step against a prefill
# whose last token was changed must differ by more than 4x that, so the
# check tells a fault apart.
WITNESS_TOL = 0.05
WITNESS_STEPS = (0, 7, NEW - 2)


def decode_witness(torch, model, toks):
    cfg = model.cfg
    logits, cache = model.prefill(toks, PROMPT + NEW)
    seq = toks.to(logits.device)
    witness = []
    for i in range(NEW - 1):
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        seq = torch.cat([seq, tok], dim=1)
        logits, cache = model.decode_step(cache, tok, PROMPT + i)
        if i in WITNESS_STEPS:
            want, _ = model.prefill(seq)
            other = seq.clone()
            other[:, -1] = (other[:, -1] + 1) % cfg.vocab
            off, _ = model.prefill(other)
            witness.append(dict(step=i, err=rel_rows(logits, want),
                                other_token=rel_rows(logits, off)))
    for w in witness:
        require(w["err"] <= WITNESS_TOL,
                f"decode step {w['step']} is off its prefill by "
                f"{w['err']:.3e} of the logit scale")
        require(w["other_token"] > 4 * WITNESS_TOL,
                f"the witness cannot tell a changed token apart: {w}")
    return witness


# Phase 4's int8 witness: the int8 copy's first logits (a prefill through
# K3 and K2) against the bf16 model's on the same tokens, at the
# reference's init scales.  Quantizing every projection's weights and
# inputs to int8 moves the logits by a few percent of their scale (the CPU
# test test_int8_witness_at_init_scales holds the plain versions to the
# same bound at 2 and 40 layers); a changed last token must move the bf16
# logits by more than 4x the tolerance, so the check tells a fault apart.
INT8_WITNESS_TOL = 0.10


def first_logits(torch, model, toks, **inputs):
    """The bf16 model's first logits on ``toks`` and on ``toks`` with its
    last token changed (what ``int8_witness`` holds the int8 copy to), and
    for an MoE model each lane's tokens dropped in each prefill
    ([lanes, layers], ``Model.moe_kept``)."""
    def dropped():
        return (torch.stack([(~k).sum(dim=1) for k in model.moe_kept],
                            dim=1).cpu() if model.cfg.moe else None)
    want, _ = model.prefill(toks, **inputs)
    drop = dropped()
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % model.cfg.vocab
    off, _ = model.prefill(other, **inputs)
    return dict(want=want, off=off, dropped=drop)


def int8_witness(torch, model, toks, q8=None, first=None, **inputs):
    """``q8`` (default: ``model``'s int8 copy) against ``first``
    (default: ``first_logits`` of ``model``, taken before a releasing
    build).  An MoE model's int8 copy is held on the lanes where neither
    prefill dropped a token's entry (ROADMAP F6) and whose last token the
    router sent to the same experts, in the same order, in every layer in
    both (at init scales the router's logits lie close, and int8 noise may
    flip a token to another expert, which moves that token's logits by the
    whole expert output); one such lane is needed."""
    from repro_torch.models import moe
    q8 = q8 or model.quantize_params_for_serving()
    routes = []
    route = moe.router_probs
    k = model.cfg.top_k

    def recorded(x, router):   # each MoE call's last token's experts
        probs = route(x, router)
        routes.append(moe.top_k(probs, k)[1].reshape(toks.shape[0], -1, k)[
            :, -1].cpu())
        return probs
    if model.cfg.moe:
        moe.router_probs = recorded
    try:
        first = first or first_logits(torch, model, toks, **inputs)
        bf16_routes = routes[:model.cfg.n_layers]
        routes.clear()
        got, _ = q8.prefill(toks, **inputs)
    finally:
        moe.router_probs = route
    held = list(range(toks.shape[0]))
    w = dict(tol=INT8_WITNESS_TOL)
    if model.cfg.moe:
        drop = torch.stack([(~k).sum(dim=1) for k in q8.moe_kept],
                           dim=1).cpu()
        same = torch.stack([(a == b).all(dim=-1)
                            for a, b in zip(bf16_routes, routes)],
                           dim=1).all(dim=1)
        held = [b for b in held if int(first["dropped"][b].sum()) == 0
                and int(drop[b].sum()) == 0 and bool(same[b])]
        w.update(held_lanes=held, last_token_routed_alike=same.tolist(),
                 dropped_bf16=first["dropped"].tolist(),
                 dropped_int8=drop.tolist())
        require(held, f"{model.cfg.name}: no lane held for the int8 "
                      f"witness: {w}")
    want, off = first["want"][held], first["off"][held]
    w.update(err=rel_rows(got[held], want), other_token=rel_rows(off, want))
    require(w["err"] <= INT8_WITNESS_TOL,
            f"int8 first logits are off the bf16 ones by {w['err']:.3e} of "
            f"the logit scale: {w}")
    require(w["other_token"] > 4 * INT8_WITNESS_TOL,
            f"the int8 witness cannot tell a changed token apart: {w}")
    return w


def serve_scheduler(torch, model, int8: bool, name: str = None):
    """Continuous batching on the full model: N_REQ requests submitted at
    once to ServeEngine.submit/step, prompt lengths and budgets drawn from
    SEED, lanes admitting and retiring during the run.  Request 0 first
    runs alone on the same scheduler (also the warm-up); amid the churn it
    must emit bitwise the same tokens.  ``name``: the path's key in
    ``PATH_KERNELS`` (default granite's)."""
    import numpy as np
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import (GEOMETRY, NEW_RANGE, PROMPT_RANGE,
                                          make_requests, serve_requests)
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    require((GEOMETRY["n_lanes"], GEOMETRY["page_size"],
             GEOMETRY["prefill_chunk"]) == (LANES, PAGE, CHUNK),
            f"the kernel phase's shapes {LANES, PAGE, CHUNK} are not the "
            f"scheduler's {GEOMETRY}")
    name = name or ("scheduler_int8" if int8 else "scheduler_bf16")
    eng = ServeEngine(model, ServeConfig(int8=int8, **GEOMETRY))
    reqs = make_requests(model.cfg.vocab, N_REQ, SEED, PROMPT_RANGE,
                         NEW_RANGE)
    alone = serve_requests(eng, reqs[:1])["outputs"][0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    run = serve_requests(eng, reqs)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    outs = run["outputs"]
    require(sorted(outs) == list(range(N_REQ)), f"{name}: outputs "
                                                f"{sorted(outs)}")
    require(all(o.status == "ok" for o in outs.values()),
            f"{name}: statuses {[o.status for o in outs.values()]}")
    require(all(o.tokens.size == r.sampling.max_new_tokens
                and len(set(o.tokens.tolist())) > 1
                for r, o in zip(reqs, (outs[r.id] for r in reqs))),
            f"{name}: a request ran short or repeats one token")
    require(np.array_equal(alone.tokens, outs[0].tokens),
            f"{name}: request 0 alone {alone.tokens.tolist()} != amid "
            f"churn {outs[0].tokens.tolist()}")
    require(all(launches.get(k, 0) > 0 for k in PATH_KERNELS[name]),
            f"{name}: a kernel never launched: {launches}")
    decode_launches(name, run["decode_launches"] or {}, model.cfg, int8)
    ttft = np.array([run["ttft_s"][r.id] for r in reqs])
    del eng
    torch.cuda.empty_cache()
    return dict(
        requests=N_REQ, **GEOMETRY, prompt_lens=[len(r.tokens) for r in reqs],
        max_new=[r.sampling.max_new_tokens for r in reqs],
        iterations=run["iterations"],
        chunk_iterations=run["chunk_iterations"],
        ttft_ms_median=float(np.median(ttft)) * 1e3,
        ttft_ms_max=float(ttft.max()) * 1e3,
        decode_ms_per_iter=run["decode_ms_per_iter"],
        generated=run["generated"], wall_s=run["wall_s"],
        tokens_per_s=run["tokens_per_s"], peak_bytes=peak,
        launches=launches, launches_per_decode_iter=run["decode_launches"],
        alone_equals_churn=True, tokens0=outs[0].tokens.tolist(),
        tokens_all={i: o.tokens.tolist() for i, o in outs.items()})


def serve_full(torch):
    """Phase 4: full-width, 40-layer granite-3-8b through the engine."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config("granite-3-8b")
    t0 = time.perf_counter()
    model = Model(cfg).init_weights(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(SEED))
    witness = decode_witness(torch, model, toks)
    witness8 = int8_witness(torch, model, toks)
    vary(torch, model, SEED)
    engine = ServeEngine(model, ServeConfig(max_new_tokens=NEW))
    engine.generate_with_status_fixed({"tokens": toks})      # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = engine.generate_with_status_fixed({"tokens": toks})
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(res.tokens.shape == (BATCH, NEW), f"tokens {res.tokens.shape}")
    require(all(st == "ok" for st in res.status), f"statuses {res.status}")
    require(all(launches.get(k, 0) > 0 for k in PATH_KERNELS["fixed"]),
            f"a kernel never launched on the fixed path: {launches}")
    require(all(len(set(lane.tolist())) > 1 for lane in res.tokens),
            f"a lane repeats one token: {res.tokens.tolist()}")

    # prefill and per-step decode times, host clock around synchronized work
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = model.prefill(toks, PROMPT + NEW)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t)
    require(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    require(logits.shape == (BATCH, cfg.padded_vocab()), "logit shape")
    tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(NEW - 1):
        logits, cache = model.decode_step(cache, tok, PROMPT + i)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t) / (NEW - 1) * 1e3
    require(bool(torch.isfinite(logits).all()), "non-finite decode logits")
    _cuda.reset_launches()
    model.decode_step(cache, tok, PROMPT + NEW - 1)
    step_launches = decode_launches("fixed", dict(_cuda.LAUNCHES), cfg)

    fixed = dict(
        params=cfg.param_count(), init_s=init_s,
        prefill_ms=sorted(pre)[1] * 1e3, decode_ms_per_step=dec_ms,
        generate_s=gen_s, tokens_per_s=BATCH * NEW / gen_s,
        decode_tokens_per_s=BATCH / dec_ms * 1e3,
        statuses=list(res.status), launches=launches,
        launches_per_decode_step=step_launches, peak_bytes=peak,
        tokens=res.tokens.tolist(), witness=witness,
        witness_tol=WITNESS_TOL, int8_witness=witness8)
    del engine, cache, logits
    torch.cuda.empty_cache()
    print("serve fixed: " + json.dumps(fixed), flush=True)
    out = {"fixed": fixed}
    for int8 in (False, True):
        r = serve_scheduler(torch, model, int8)
        name = "scheduler_int8" if int8 else "scheduler_bf16"
        print(f"serve {name}: " + json.dumps(
            {k: v for k, v in r.items() if k != "tokens_all"}), flush=True)
        out[name] = r
    out["mixed"] = serve_mixed(torch, model,
                               out["scheduler_bf16"]["tokens_all"])
    print("serve mixed sampled/greedy: " + json.dumps(out["mixed"]),
          flush=True)
    t0 = time.perf_counter()
    out["drills"] = fault_drills(torch, model, toks)
    out["drills"]["part_s"] = time.perf_counter() - t0
    print("fault drills: " + json.dumps(out["drills"]), flush=True)
    return out


# ---------------------------------------------------------------------------
# gemma2-27b: the local and softcap variants of K4, K5 and K6, and K7
# ---------------------------------------------------------------------------



def check_gemma2_kernels(torch, timer):
    """Phase 2, gemma2: each variant against its plain version on the
    card at gemma2-27b's shapes (H 32, KV 16, hd 128, window 4096, softcap
    50).  K4 (local + softcap, 4 bf16 ulps of each row's scale as for the
    global K4) over the fixed loop's prefill, B = 2 x S = 4160, and at a
    window of 16 (smaller than one 64-slot block) and global + softcap;
    K5 with softcap, and without it beside SDPA (``k5_row``); K6 local +
    softcap at decode and at an S = 64 chunk (2 bf16 ulps; partials within
    1e-5 of each row's scale) with lanes past position 4096, the idle lane
    exactly 0.0, and K6 == K5 bitwise on global lanes with softcap; K7
    bitwise at S = 4 over [1024, 4096] for every pair of dtypes it takes
    (fp32 and bf16 into fp32 and bf16, int8 into int32 and int8), and at
    shapes and bases its vector kernel does not take."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (paged_decode_launch,
                                                     paged_flash_decode_tiled,
                                                     paged_tile_partials)

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bf = torch.bfloat16
    H, KV, hd, W, sc = G2_H, G2_KV, G2_HD, G2_WINDOW, G2_SOFTCAP
    G = H // KV

    def rand(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    results = {}
    # K4: local + softcap at the fixed loop's prefill; q and k at 3x scale
    # so that scores reach the softcap's curve
    b, s = G2_BATCH, G2_PROMPT
    q, k, v = rand(b, s, H, hd, scale=3.0), rand(b, s, KV, hd, scale=3.0), \
        rand(b, s, KV, hd)
    var = dict(kind="local", window=W, softcap=sc)
    got = ops.flash_attention(q, k, v, **var)
    want = ref.flash_attention_ref(q, k, v, **var)
    err, abs_err = row_err(got, want), max_err(got, want)
    extra = {}
    for name, shape, kw in (
            ("small_window", (1, 320), dict(kind="local", window=16,
                                            softcap=sc)),
            ("global_softcap", (1, 512), dict(kind="global", softcap=sc))):
        qs = rand(*shape, H, hd, scale=3.0)
        ks, vs = rand(*shape, KV, hd, scale=3.0), rand(*shape, KV, hd)
        extra[name] = row_err(ops.flash_attention(qs, ks, vs, **kw),
                              ref.flash_attention_ref(qs, ks, vs, **kw))
    worst = max(err, *extra.values())
    require(worst <= 4 * eps_bf16, f"K4 local/softcap: a row is off by "
                                   f"{err:.3e} ({extra}) of its scale")
    live = sum(min(i + 1, W) for i in range(s))      # keys per head
    t_b, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                    4 * b * H * hd * live)
    pos_q = torch.arange(s, device="cuda")
    lmask = ((pos_q[None, :] <= pos_q[:, None])
             & (pos_q[:, None] - pos_q[None, :] < W))
    results["k4_flash_prefill_local_softcap"] = dict(
        work=f"local prefill window={W} softcap={sc} B={b} S={s} H={H} "
             f"KV={KV} hd={hd}; also window 16 at S=320 and global + "
             f"softcap at S=512",
        max_abs_err=abs_err, max_row_err=worst, tol=4 * eps_bf16,
        small_window_row_err=extra["small_window"],
        global_softcap_row_err=extra["global_softcap"],
        ms=timer(lambda: ops.flash_attention(q, k, v, **var), reps=3),
        wrapper_ms=timer.wall(lambda: ops.flash_attention(q, k, v, **var),
                              reps=3),
        plain_ms=timer(lambda: ref.flash_attention_ref(q, k, v, **var),
                       reps=3),
        bound_ms=t_b, bound_by=by,
        library_ms=sdpa_ms(torch, timer, q, k, v, attn_mask=lmask),
        library_note="SDPA with the local window as a bool mask, no "
                     "softcap (sdpa_ms)")
    # K4 global + softcap: gemma2's global layers at the same prefill
    gvar = dict(kind="global", softcap=sc)
    got = ops.flash_attention(q, k, v, **gvar)
    want = ref.flash_attention_ref(q, k, v, **gvar)
    err, abs_err = row_err(got, want), max_err(got, want)
    del got, want
    require(err <= 4 * eps_bf16, f"K4 global/softcap at S={s}: a row is "
                                 f"off by {err:.3e} of its scale")
    t_b, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                    4 * b * H * hd * s * (s + 1) / 2)
    results["k4_flash_prefill_global_softcap"] = dict(
        work=f"causal prefill softcap={sc} B={b} S={s} H={H} KV={KV} "
             f"hd={hd}",
        max_abs_err=abs_err, max_row_err=err, tol=4 * eps_bf16,
        ms=timer(lambda: ops.flash_attention(q, k, v, **gvar), reps=3),
        wrapper_ms=timer.wall(lambda: ops.flash_attention(q, k, v, **gvar),
                              reps=3),
        plain_ms=timer(lambda: ref.flash_attention_ref(q, k, v, **gvar),
                       reps=3),
        bound_ms=t_b, bound_by=by,
        library_ms=sdpa_ms(torch, timer, q, k, v, is_causal=True),
        library_note="SDPA causal, no softcap (sdpa_ms)")
    del q, k, v, lmask
    torch.cuda.empty_cache()

    # K5 at the global layers' decode at the fixed loop's last step, with
    # the softcap, and without it beside one SDPA call (the long-history
    # regime's library yardstick)
    length = G2_PROMPT + G2_NEW
    for name, softcap in (("k5_flash_decode_softcap", sc),
                          ("k5_flash_decode_gemma2", None)):
        results[name] = k5_row(torch, timer, rand, b, length, length - 1,
                               KV, G, hd, softcap, 3.0,
                               "gemma2-27b's global layers, fixed loop")
    torch.cuda.empty_cache()

    # K6 local + softcap: the scheduler's geometry for gemma2 (8 lanes,
    # 16-slot pages, 262 pages per lane), lanes on both sides of 4096
    L, ps, P = LANES, PAGE, 262
    n_pages = L * P
    kp, vp = rand(n_pages + 1, ps, KV, hd, scale=3.0), \
        rand(n_pages + 1, ps, KV, hd)
    lane_pos = torch.tensor([0, 31, 100, 4095, 4096, 4170, 4191, -1],
                            dtype=torch.int32)
    table = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        SEED)).reshape(L, P).to(torch.int32)
    for lane in range(L):
        table[lane, max(int(lane_pos[lane]), 0) // ps + 1:] = -1
    table = table.cuda()
    posd = lane_pos.cuda()[:, None].contiguous()
    q = rand(L, 1, KV, G, hd, scale=3.0)
    lvar = dict(kind="local", window=W, softcap=sc)
    got = ops.paged_flash_decode(q, kp, vp, table, posd, **lvar)
    require(bool((got[L - 1] == 0).all()), "K6 local: the idle lane is not "
                                           "0.0")
    dec_err = row_err(got, paged_flash_decode_tiled(q, kp, vp, table, posd,
                                                    **lvar))
    rows, n_tiles = L * KV, P * ps // 32
    out, ws = paged_decode_launch(q, kp, vp, table, posd, **lvar)
    require(torch.equal(out, got), "K6 local: two launches differ")
    p_err = record_err(torch, ws, paged_tile_partials(q, kp, vp, table, posd,
                                                      **lvar),
                       rows, n_tiles, G, hd)
    del out, ws
    # the S = 64 prefill chunk ending at each lane's position
    s_q = CHUNK
    qc = rand(L, s_q, KV, G, hd, scale=3.0)
    pc = (lane_pos.clamp(min=0)[:, None] - s_q + 1 + torch.arange(s_q)[None])
    pc = torch.where((pc >= 0) & (lane_pos[:, None] >= 0), pc, -1)
    pc[2, -7:] = -1      # a final chunk's padded tail
    pc = pc.to(torch.int32).cuda().contiguous()
    chunk = chunk_contracts(torch, qc, kp, vp, table, pc, 5, **lvar)
    chunk_want = paged_flash_decode_tiled(qc, kp, vp, table, pc, **lvar)
    chunk_err = row_err(chunk, chunk_want)
    gchunk_err = row_err(
        chunk_contracts(torch, qc, kp, vp, table, pc, 5, softcap=sc),
        paged_flash_decode_tiled(qc, kp, vp, table, pc, softcap=sc))
    # a window of 16, smaller than one 32-slot tile
    svar = dict(kind="local", window=16, softcap=sc)
    small_err = max(
        row_err(ops.paged_flash_decode(qc, kp, vp, table, pc, **svar),
                paged_flash_decode_tiled(qc, kp, vp, table, pc, **svar)),
        row_err(ops.paged_flash_decode(q, kp, vp, table, posd, **svar),
                paged_flash_decode_tiled(q, kp, vp, table, posd, **svar)))
    worst = max(dec_err, chunk_err, gchunk_err, small_err)
    require(p_err <= 1e-5 and worst <= 2 * eps_bf16,
            f"K6 local/softcap: partials {p_err:.3e}, decode {dec_err:.3e}, "
            f"chunk {chunk_err:.3e}, global chunk {gchunk_err:.3e}, window "
            f"16 {small_err:.3e}")
    # global + softcap: each lane bitwise K5 over the same history
    lanes_equal_k5(torch, ops.paged_flash_decode(q, kp, vp, table, posd,
                                                 softcap=sc),
                   q, kp, vp, table, lane_pos, "K6 global softcap",
                   softcap=sc)
    where = (f"local window={W} softcap={sc} L={L} KV={KV} G={G} hd={hd} "
             f"page_size={ps} P={P} ({n_tiles} tiles)")
    dec = dict(
        work=f"paged decode {where}, positions {lane_pos.tolist()}; the "
             f"idle lane 0.0, window 16 checked, global lanes bitwise K5",
        max_abs_err=max_err(got, paged_flash_decode_tiled(
            q, kp, vp, table, posd, **lvar)),
        max_row_err=dec_err, tol=2 * eps_bf16, partials_row_err=p_err,
        partials_tol=1e-5, small_window_row_err=small_err,
        ms=timer(lambda: ops.paged_flash_decode(q, kp, vp, table, posd,
                                                **lvar)),
        wrapper_ms=timer.wall(lambda: ops.paged_flash_decode(
            q, kp, vp, table, posd, **lvar)),
        plain_ms=timer(lambda: paged_flash_decode_tiled(
            q, kp, vp, table, posd, **lvar), reps=3),
        library_ms=None,
        library_note="no one PyTorch call attends through a page table")
    dec["bound_ms"], dec["bound_by"] = k6_bound(q, table, posd, KV, W)
    chk = dict(
        work=f"paged prefill chunk S={s_q} {where}, each lane's chunk "
             f"ending at its position (a padded tail), on the "
             f"flash-prefill body: deterministic, idle rows 0.0, a lane "
             f"unmoved by its neighbours; global + softcap chunk checked "
             f"alike",
        max_abs_err=max_err(chunk, chunk_want), max_row_err=chunk_err,
        tol=2 * eps_bf16, global_chunk_row_err=gchunk_err,
        ms=timer(lambda: ops.paged_flash_decode(qc, kp, vp, table, pc,
                                                **lvar), reps=3),
        wrapper_ms=timer.wall(lambda: ops.paged_flash_decode(
            qc, kp, vp, table, pc, **lvar), reps=3),
        plain_ms=timer(lambda: paged_flash_decode_tiled(
            qc, kp, vp, table, pc, **lvar), reps=1),
        library_ms=None,
        library_note="no one PyTorch call attends through a page table")
    chk["bound_ms"], chk["bound_by"] = k6_bound(qc, table, pc, KV, W)
    results["k6_paged_decode_local_softcap"] = dec
    results["k6_paged_decode_chunk_local_softcap"] = chk
    del kp, vp, q, qc, chunk, chunk_want
    torch.cuda.empty_cache()

    # K7: bitwise, fp32, bf16 and int8 -> int32
    s, m, n = 4, 1024, 4096
    k7 = {}
    for dt, out in ((torch.float32, torch.float32), (torch.float32, bf),
                    (bf, bf), (bf, torch.float32), (torch.int8, torch.int32),
                    (torch.int8, torch.int8)):
        p = (rand(s, m, n, dtype=torch.float32) if dt != torch.int8 else
             torch.randint(-128, 128, (s, m, n), generator=gen,
                           device="cuda", dtype=torch.int8)).to(dt)
        got = ops.addertree(p, out_dtype=out)
        require(torch.equal(got, ref.addertree_ref(p, out)),
                f"K7 {dt} -> {out} is not bitwise its plain version")
        k7[dt, out] = p
        # the scalar kernel: n not a multiple of 16 (nor of the vector
        # width), and a base 1 element past 16-byte alignment; S = 11 runs
        # past one round of 8 loads
        for ss, mm, nn, off in ((s, 33, 17, 0), (s, 64, 96, 1),
                                (11, 8, 200, 0)):
            flat = (rand(ss * mm * nn + off, dtype=torch.float32)
                    if dt != torch.int8 else
                    torch.randint(-128, 128, (ss * mm * nn + off,),
                                  generator=gen, device="cuda",
                                  dtype=torch.int8)).to(dt)
            po = flat[off:].view(ss, mm, nn)
            require(torch.equal(ops.addertree(po, out_dtype=out),
                                ref.addertree_ref(po, out)),
                    f"K7 {dt} -> {out} S={ss} [{mm}, {nn}] offset {off} is "
                    f"not bitwise its plain version")
    p = k7[torch.float32, torch.float32]
    t_b, by = bound(4 * p.numel() + 4 * m * n, (s - 1) * m * n,
                    FP32_FLOPS_PER_S)
    results["k7_addertree"] = dict(
        work=f"adder tree S={s} [{m}, {n}] fp32 -> fp32 (bitwise; also "
             f"fp32 -> bf16, bf16 -> bf16 and fp32, int8 -> int32 and "
             f"int8, each also at n = 17, at a base off 16-byte alignment "
             f"and at S = 11)",
        max_abs_err=0.0, max_row_err=0.0, tol=0.0,
        ms=timer(lambda: ops.addertree(p, out_dtype=torch.float32)),
        wrapper_ms=timer.wall(lambda: ops.addertree(p,
                                                    out_dtype=torch.float32)),
        plain_ms=timer(lambda: ref.addertree_ref(p, torch.float32)),
        bound_ms=t_b, bound_by=by,
        library_ms=timer(lambda: p.sum(0)),
        library_note="partials.sum(0)")
    del k7, p
    torch.cuda.empty_cache()
    return results


def lanes_equal_k5(torch, got, q, kp, vp, table, lane_pos, what, **var):
    """Each lane of a K6 decode ``got`` [L, 1, KV, G, hd] at positions
    ``lane_pos`` (the last lane idle) is bitwise K5 over the same history
    gathered into a dense cache; raises on a miss."""
    from repro_torch.kernels import ops
    n_lanes, p_max, ps = table.shape[0], table.shape[1], kp.shape[1]
    for lane in range(n_lanes - 1):
        kd = torch.zeros((1, p_max * ps, *kp.shape[2:]), dtype=kp.dtype,
                         device="cuda")
        vd = torch.zeros_like(kd)
        for page, phys in enumerate(table[lane].tolist()):
            if phys >= 0:
                kd[0, page * ps:(page + 1) * ps] = kp[phys]
                vd[0, page * ps:(page + 1) * ps] = vp[phys]
        require(torch.equal(got[lane:lane + 1], ops.flash_decode(
            q[lane:lane + 1], kd, vd, int(lane_pos[lane]), **var)),
            f"{what} lane {lane} is not bitwise K5 over the same history")


def check_gemma3_kernels(torch, timer):
    """Phase 2, gemma3: head dim 256 in K4, K5 and K6 against their plain
    versions at gemma3-12b's shapes (H 16, KV 8, hd 256, window 1024, no
    softcap).  K4 local and global over the fixed loop's prefill, B = 2 x
    S = 4160, each row within 2 bf16 ulps of its scale, each beside SDPA
    (the window as a bool mask); K5 at the fixed loop's decode, cache 4192
    at position 4175 (``k5_row``: bitwise at split counts 1, 2, 4, the
    default and one per tile, 2 ulps, partials within 1e-5) beside SDPA;
    K6 at the scheduler's geometry (8 lanes, 16-slot pages, 262 pages a
    lane; lanes on both sides of the window and one idle), local and
    global: decode within 2 ulps with its partials within 1e-5, every
    global lane bitwise K5 over the same history, the idle lane exactly
    0.0; the S = 64 chunk body within 2 ulps with ``chunk_contracts`` on
    both kinds, and once more with 128-slot pages, each 64-slot K/V tile
    half a page."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (paged_decode_launch,
                                                     paged_flash_decode_tiled,
                                                     paged_tile_partials)

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    tol = 2 * eps_bf16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    bf = torch.bfloat16
    H, KV, hd, W = G3_H, G3_KV, G3_HD, G3_WINDOW
    G = H // KV

    def rand(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    results = {}
    # K4 at the fixed loop's prefill, local and global
    b, s = G3_BATCH, G3_PROMPT
    q, k, v = rand(b, s, H, hd), rand(b, s, KV, hd), rand(b, s, KV, hd)
    pos_q = torch.arange(s, device="cuda")
    causal = pos_q[None, :] <= pos_q[:, None]
    for name, var, live, lib_kw, note in (
            ("k4_flash_prefill_hd256_local", dict(kind="local", window=W),
             sum(min(i + 1, W) for i in range(s)),
             dict(attn_mask=causal & (pos_q[:, None] - pos_q[None, :] < W)),
             "SDPA with the local window as a bool mask (sdpa_ms)"),
            ("k4_flash_prefill_hd256", dict(kind="global"), s * (s + 1) / 2,
             dict(is_causal=True), "SDPA causal (sdpa_ms)")):
        got = ops.flash_attention(q, k, v, **var)
        want = ref.flash_attention_ref(q, k, v, **var)
        err, abs_err = row_err(got, want), max_err(got, want)
        del got, want
        require(err <= tol, f"{name}: a row is off by {err:.3e} of its "
                            f"scale")
        t_b, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                        4 * b * H * hd * live)
        results[name] = dict(
            work=f"{var['kind']} prefill"
                 f"{' window=%d' % W if 'window' in var else ''} B={b} "
                 f"S={s} H={H} KV={KV} hd={hd} (64-slot K/V tiles, 2 "
                 f"stages)",
            max_abs_err=abs_err, max_row_err=err, tol=tol,
            ms=timer(lambda var=var: ops.flash_attention(q, k, v, **var),
                     reps=3),
            wrapper_ms=timer.wall(
                lambda var=var: ops.flash_attention(q, k, v, **var), reps=3),
            plain_ms=timer(
                lambda var=var: ref.flash_attention_ref(q, k, v, **var),
                reps=3),
            bound_ms=t_b, bound_by=by,
            library_ms=sdpa_ms(torch, timer, q, k, v, **lib_kw),
            library_note=note)
        print("  k4 " + json.dumps({name: results[name]}), flush=True)
    del q, k, v, causal
    torch.cuda.empty_cache()

    # K5 at the global layers' decode, the fixed loop's cache at a step
    # past the prompt
    results["k5_flash_decode_hd256"] = k5_row(
        torch, timer, rand, b, G3_PROMPT + 32, G3_PROMPT + G3_NEW - 1, KV, G,
        hd, None, 1.0, "gemma3-12b's global layers, fixed loop")
    torch.cuda.empty_cache()

    # K6 at the scheduler's geometry, lanes on both sides of the window
    L, ps, P = LANES, PAGE, 262
    n_pages = L * P
    kp, vp = rand(n_pages + 1, ps, KV, hd), rand(n_pages + 1, ps, KV, hd)
    lane_pos = torch.tensor([0, 31, 100, 1023, 1024, 2100, 4191, -1],
                            dtype=torch.int32)
    table = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        SEED)).reshape(L, P).to(torch.int32)
    for lane in range(L):
        table[lane, max(int(lane_pos[lane]), 0) // ps + 1:] = -1
    table = table.cuda()
    posd = lane_pos.cuda()[:, None].contiguous()
    q = rand(L, 1, KV, G, hd)
    s_q = CHUNK
    qc = rand(L, s_q, KV, G, hd)
    pc = (lane_pos.clamp(min=0)[:, None] - s_q + 1 + torch.arange(s_q)[None])
    pc = torch.where((pc >= 0) & (lane_pos[:, None] >= 0), pc, -1)
    pc[2, -7:] = -1      # a final chunk's padded tail
    pc = pc.to(torch.int32).cuda().contiguous()
    rows, n_tiles = L * KV, P * ps // 32
    where = (f"L={L} KV={KV} G={G} hd={hd} page_size={ps} P={P} "
             f"({n_tiles} tiles)")
    lib_note = "no one PyTorch call attends through a page table"
    for kind, var in (("local", dict(kind="local", window=W)),
                      ("global", dict())):
        suffix = "_local" if kind == "local" else ""
        win = W if kind == "local" else 0
        got = ops.paged_flash_decode(q, kp, vp, table, posd, **var)
        require(bool((got[L - 1] == 0).all()),
                f"K6 hd 256 {kind}: the idle lane is not 0.0")
        want = paged_flash_decode_tiled(q, kp, vp, table, posd, **var)
        dec_err, dec_abs = row_err(got, want), max_err(got, want)
        out, ws = paged_decode_launch(q, kp, vp, table, posd, **var)
        require(torch.equal(out, got), f"K6 hd 256 {kind}: two launches "
                                       f"differ")
        p_err = record_err(torch, ws, paged_tile_partials(
            q, kp, vp, table, posd, **var), rows, n_tiles, G, hd)
        del out, ws
        if kind == "global":
            lanes_equal_k5(torch, got, q, kp, vp, table, lane_pos,
                           "K6 hd 256 global")
        chunk = chunk_contracts(torch, qc, kp, vp, table, pc, 5, **var)
        chunk_want = paged_flash_decode_tiled(qc, kp, vp, table, pc, **var)
        chunk_err, chunk_abs = row_err(chunk, chunk_want), max_err(
            chunk, chunk_want)
        del chunk, chunk_want
        require(p_err <= 1e-5 and max(dec_err, chunk_err) <= tol,
                f"K6 hd 256 {kind}: decode {dec_err:.3e} (partials "
                f"{p_err:.3e}), chunk {chunk_err:.3e}")
        dec = dict(
            work=f"paged decode {kind}"
                 f"{' window=%d' % W if win else ''} {where}, positions "
                 f"{lane_pos.tolist()}; the idle lane 0.0"
                 f"{', each lane bitwise K5' if not win else ''}",
            max_abs_err=dec_abs, max_row_err=dec_err, tol=tol,
            partials_row_err=p_err, partials_tol=1e-5,
            ms=timer(lambda var=var: ops.paged_flash_decode(
                q, kp, vp, table, posd, **var)),
            wrapper_ms=timer.wall(lambda var=var: ops.paged_flash_decode(
                q, kp, vp, table, posd, **var)),
            plain_ms=timer(lambda var=var: paged_flash_decode_tiled(
                q, kp, vp, table, posd, **var), reps=3),
            library_ms=None, library_note=lib_note)
        dec["bound_ms"], dec["bound_by"] = k6_bound(q, table, posd, KV, win)
        chk = dict(
            work=f"paged prefill chunk S={s_q} {kind}"
                 f"{' window=%d' % W if win else ''} {where}, each lane's "
                 f"chunk ending at its position (a padded tail), on the "
                 f"flash-prefill body: deterministic, idle rows 0.0, a "
                 f"lane unmoved by its neighbours",
            max_abs_err=chunk_abs, max_row_err=chunk_err, tol=tol,
            ms=timer(lambda var=var: ops.paged_flash_decode(
                qc, kp, vp, table, pc, **var), reps=3),
            wrapper_ms=timer.wall(lambda var=var: ops.paged_flash_decode(
                qc, kp, vp, table, pc, **var), reps=3),
            plain_ms=timer(lambda var=var: paged_flash_decode_tiled(
                qc, kp, vp, table, pc, **var), reps=1),
            library_ms=None, library_note=lib_note)
        chk["bound_ms"], chk["bound_by"] = k6_bound(qc, table, pc, KV, win)
        results[f"k6_paged_decode_hd256{suffix}"] = dec
        results[f"k6_paged_decode_chunk_hd256{suffix}"] = chk
        print("  k6 hd256 " + json.dumps({kind: [dec, chk]}), flush=True)
    del kp, vp, q, qc
    torch.cuda.empty_cache()

    # the chunk body with 128-slot pages: each 64-slot K/V tile is half a
    # page (4 lanes, KV 2, G 2, 3 pages a lane, one lane idle, a hole)
    L, KV2, ps, P = 4, 2, 128, 3
    kp, vp = rand(L * P + 1, ps, KV2, hd), rand(L * P + 1, ps, KV2, hd)
    lane_pos = torch.tensor([5, 200, 383, -1], dtype=torch.int32)
    table = torch.randperm(L * P, generator=torch.Generator().manual_seed(
        SEED)).reshape(L, P).to(torch.int32)
    for lane in range(L):
        table[lane, max(int(lane_pos[lane]), 0) // ps + 1:] = -1
    table[2, 1] = -1     # a hole inside lane 2's range
    qc = rand(L, s_q, KV2, G, hd)
    pc = lane_pos.clamp(min=0)[:, None] - s_q + 1 + torch.arange(s_q)[None]
    pc = torch.where((pc >= 0) & (lane_pos[:, None] >= 0), pc, -1)
    table, pc = table.cuda(), pc.to(torch.int32).cuda().contiguous()
    big = max(row_err(chunk_contracts(torch, qc, kp, vp, table, pc, 1,
                                      **var),
                      paged_flash_decode_tiled(qc, kp, vp, table, pc, **var))
              for var in (dict(kind="local", window=100), dict()))
    require(big <= tol, f"K6 chunk at hd 256 with 128-slot pages: a row is "
                        f"off by {big:.3e}")
    results["k6_paged_decode_chunk_hd256"]["page_128_row_err"] = big
    return results


def addertree_path(torch):
    """K7's one entry point, ``ops.addertree``, driven as the row-parallel
    reduction of a K-split product (the reference's adder tree over the
    model axis, here on one card): gemma2's o-projection at the scheduler's
    chunk rows (512 x 4096 -> 4608) in Y = 4 K-slices, each partial a K1
    GEMM stored in bf16, summed by K7 at fp32.  The sum is bitwise the
    plain adder tree of the same partials and within 4 bf16 ulps of each
    row's scale of the unsplit product (each partial rounded once)."""
    from repro_torch.kernels import _cuda, ops, ref

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    bf = torch.bfloat16
    m, k, n, y = LANES * CHUNK, G2_H * G2_HD, 4608, 4
    x = torch.randn((m, k), generator=gen, device="cuda").to(bf)
    w = (torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
         ).to(bf)
    whole = ops.matmul(x, w, out_dtype=bf)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    ks = k // y
    partials = torch.stack([ops.matmul(x[:, i * ks:(i + 1) * ks].contiguous(),
                                       w[i * ks:(i + 1) * ks], out_dtype=bf)
                            for i in range(y)])
    got = ops.addertree(partials, out_dtype=torch.float32)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    require(launches["addertree"] > 0, f"K7 never launched: {launches}")
    require(torch.equal(got, ref.addertree_ref(partials, torch.float32)),
            "K7 on the path is not bitwise its plain version")
    err = row_err(got, whole)
    require(err <= 4 * eps_bf16, f"the K-split o-projection is off the "
                                 f"unsplit one by {err:.3e} of a row")
    return dict(rows=m, k=k, n=n, y=y, row_err=err, tol=4 * eps_bf16,
                launches=launches)


def paged_forced(torch, model, toks, picks, chunk):
    """The scheduler's math teacher-forced: every row of ``toks [B, S]``
    prefilled on its own lane in chunks of ``chunk`` (``prefill_chunk``),
    then ``decode_step_paged`` fed ``picks [B, n]``.  Returns the n steps'
    logits [B, V] (the first from the last chunk), on the CPU."""
    b, s = toks.shape
    ps, steps = PAGE, picks.shape[1]
    p_max = -(-(s + steps) // ps)
    cache = model.new_paged_cache(b * p_max, ps)
    table = torch.arange(b * p_max, dtype=torch.int32).reshape(b, p_max)
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        tk = torch.zeros((b, chunk), dtype=torch.int32)
        tk[:, :n] = toks[:, c0:c0 + n]
        pos = torch.full((b, chunk), -1, dtype=torch.int32)
        pos[:, :n] = torch.arange(c0, c0 + n, dtype=torch.int32)
        logits, _ = model.prefill_chunk(cache, tk, pos, table, torch.full(
            (b,), n - 1, dtype=torch.int32))
    out = [logits.float().cpu()]
    for i in range(steps - 1):
        logits, _ = model.decode_step_paged(
            cache, torch.as_tensor(picks[:, i:i + 1]),
            torch.full((b,), s + i, dtype=torch.int32), table)
        out.append(logits.float().cpu())
    return [o[:, :model.cfg.vocab] for o in out]


def check_local_smoke(torch, arch: str, **over):
    """Phase 3, the models with local layers and the MoE models: the whole
    path on a smoke config (``arch``'s, fields replaced by ``over``, bf16
    parameters: gemma2-27b-smoke's 4 layers alternating local and global,
    window 16, softcaps; gemma3-12b-smoke's 6 layers, 5 local to 1 global,
    window 16, dual theta, at ``head_dim=256``; llama4's chunked layers;
    grok-1-smoke's 2 global layers, 4 experts top-2) with prompts of 40
    tokens, longer than the window; card against CPU.

    The scheduler (K6 local and global): greedy tokens
    through ``ServeEngine.generate`` on both, and the same math
    teacher-forced on the CPU's tokens (``paged_forced``).  Each forced
    step's logits are within twice the CPU pipeline's own bf16 rounding
    noise (its distance from an fp32-compute run on the same tokens), and
    the card's pick is the CPU's, or, at a near tie, a token whose CPU
    logit is within twice the step's largest card-CPU logit difference of
    the CPU's maximum: a flip that difference explains.  The free-running
    tokens are equal up to the first such flip.  The fixed loop (K4 local
    and global, the ring, K5, the final softcap where set):
    teacher-forced logits within the same budget."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="bfloat16", **over)
    name = cfg.name
    cpu = Model(cfg, device="cpu").init_weights(SEED)
    vary(torch, cpu, SEED)
    card = Model(cfg)
    card.load_state_dict(cpu.state_dict())
    ref32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                  device="cpu")
    ref32.load_state_dict(cpu.state_dict())
    plen, steps = 40, 8
    require(plen > cfg.window or set(cfg.block_pattern) == {"global"},
            "the smoke prompts must pass the window")
    toks = torch.randint(0, cfg.vocab, (BATCH, plen),
                         generator=torch.Generator().manual_seed(SEED + 1))
    scfg = ServeConfig(max_new_tokens=steps)
    want = ServeEngine(cpu, scfg).generate({"tokens": toks})
    got = ServeEngine(card, scfg).generate({"tokens": toks})
    require(got.shape == want.shape == (BATCH, steps), f"{name} token shape")

    def rel(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max()
                     / max(1.0, float(b.abs().max())))

    lc = paged_forced(torch, cpu, toks, want, scfg.prefill_chunk)
    lg = paged_forced(torch, card, toks, want, scfg.prefill_chunk)
    l3 = paged_forced(torch, ref32, toks, want, scfg.prefill_chunk)
    err = [rel(g, c) for g, c in zip(lg, lc)]
    noise = [rel(c, r) for c, r in zip(lc, l3)]
    require(max(err) <= 2 * max(noise),
            f"{name} scheduler logits off by {max(err):.3e} of scale, "
            f"budget {2 * max(noise):.3e}")
    flips, first_flip = [], steps
    for i, (g, c) in enumerate(zip(lg, lc)):
        require(bool((c.argmax(-1).numpy() == want[:, i]).all()),
                "the forced CPU run does not reproduce the CPU's picks")
        diff = float((g - c).abs().max())
        for lane in range(BATCH):
            pick = int(g[lane].argmax())
            if pick == int(want[lane, i]):
                continue
            gap = float(c[lane].max() - c[lane, pick])
            require(gap <= 2 * diff,
                    f"{name} lane {lane} step {i}: the card picks {pick}, "
                    f"{gap:.3e} under the CPU's maximum, more than twice "
                    f"the logit difference {diff:.3e}")
            flips.append(dict(lane=lane, step=i, gap=gap, diff=diff))
            first_flip = min(first_flip, i)
    require(np.array_equal(got[:, :first_flip], want[:, :first_flip]),
            f"{name} greedy tokens differ before any near tie: card "
            f"{got.tolist()} cpu {want.tolist()}")
    # the fixed loop, teacher-forced on the same picks
    fc = cpu.prefill(toks, plen + steps)
    fg = card.prefill(toks, plen + steps)
    f3 = ref32.prefill(toks, plen + steps)
    ferr, fnoise = [rel(fg[0], fc[0])], [rel(fc[0], f3[0])]
    for i in range(steps - 1):
        tok = torch.from_numpy(want[:, i:i + 1])
        fc = cpu.decode_step(fc[1], tok, plen + i)
        fg = card.decode_step(fg[1], tok, plen + i)
        f3 = ref32.decode_step(f3[1], tok, plen + i)
        ferr.append(rel(fg[0], fc[0]))
        fnoise.append(rel(fc[0], f3[0]))
        require(not cfg.final_softcap
                or float(fg[0].abs().max()) <= cfg.final_softcap,
                "a logit is outside the final softcap")
    require(max(ferr) <= 2 * max(fnoise),
            f"{name} fixed-loop logits off by {max(ferr):.3e} of scale, "
            f"budget {2 * max(fnoise):.3e}")
    return dict(tokens=got.tolist(), cpu_tokens=want.tolist(),
                equal_steps=first_flip, near_tie_flips=flips,
                logit_err=max(err), budget=2 * max(noise),
                fixed_logit_err=max(ferr), fixed_budget=2 * max(fnoise),
                distinct_tokens=len(set(got.reshape(-1).tolist())))


def long_witness(torch, model, toks, new: int, **inputs):
    """The long-context phases' witness at the reference's init scales: the
    fixed loop's decode step at position prompt + new - 2 (the local
    layers' ring has wrapped, K5 over the global caches; whisper's K5
    'full' over its ``frames``; paligemma's prompt starts with its
    ``patches``) against the last logits of a prefill over the same tokens
    (K4 local and global; whisper's causal and 'full'), each lane within
    WITNESS_TOL of its logit scale; the same step against a prefill whose
    last token was changed must differ by more than 4x that."""
    cfg = model.cfg
    prompt = toks.shape[1] + cfg.prefix_tokens
    logits, cache = model.prefill(toks, prompt + new, **inputs)
    seq = toks.to(logits.device)
    for i in range(new - 1):
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        seq = torch.cat([seq, tok], dim=1)
        logits, cache = model.decode_step(cache, tok, prompt + i)
    del cache
    want, _ = model.prefill(seq, **inputs)
    other = seq.clone()
    other[:, -1] = (other[:, -1] + 1) % cfg.vocab
    off, _ = model.prefill(other, **inputs)
    w = dict(position=prompt + new - 2, err=rel_rows(logits, want),
             other_token=rel_rows(logits, off), tol=WITNESS_TOL)
    require(w["err"] <= WITNESS_TOL,
            f"{cfg.name} decode is off its prefill by {w['err']:.3e} of the "
            f"logit scale")
    require(w["other_token"] > 4 * WITNESS_TOL,
            f"the {cfg.name} witness cannot tell a changed token apart: {w}")
    return w


def scheduler_run(torch, eng, reqs, name: str, reset_peak: bool = True,
                  **extra):
    """One driven scheduler path: ``reqs`` submitted at once to ``eng``
    (``serve_requests``), the launch counts set to 0 just before (and the
    peak memory, unless ``reset_peak`` is False: the caller reset it).
    Every output, every status ok, every request its whole budget,
    request 0 past the window, every kernel of ``PATH_KERNELS[name]``
    launched (``variant_launches``: a bare kernel name counts its
    launches with no variant on), one decode iteration's launches exact
    (``decode_launches``: int8, an MoE, an up GEMM wider than the store
    phase's row pass), the peak under the card's 80 GB.  Prints and
    returns the report, ``extra`` in it."""
    import numpy as np
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import serve_requests

    model = eng.model
    cfg = model.cfg
    if reset_peak:
        torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    run = serve_requests(eng, reqs)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    outs = run["outputs"]
    require(sorted(outs) == sorted(r.id for r in reqs),
            f"{name} outputs {sorted(outs)}")
    require(all(o.status == "ok" for o in outs.values()),
            f"{name} statuses {[o.status for o in outs.values()]}")
    require(all(outs[r.id].tokens.size == r.sampling.max_new_tokens
                for r in reqs), f"a {name} request ran short")
    last_pos = len(reqs[0].tokens) + outs[reqs[0].id].tokens.size - 1
    require(last_pos > cfg.window, f"{name}: request 0 stopped at "
                                   f"{last_pos}")
    missing = [key for key in PATH_KERNELS[name]
               if variant_launches(launches, key) <= 0]
    require(not missing, f"{name}: never launched {missing}: {launches}")
    decode_launches(name, run["decode_launches"] or {}, cfg, model.int8)
    require(peak < 80e9, f"{name}: peak {peak / 1e9:.2f} GB")
    ttft = np.array([run["ttft_s"][r.id] for r in reqs])
    report = dict(
        requests=len(reqs), **extra,
        prompt_lens=[len(r.tokens) for r in reqs],
        max_new=[r.sampling.max_new_tokens for r in reqs],
        last_position_of_request_0=last_pos,
        iterations=run["iterations"],
        chunk_iterations=run["chunk_iterations"],
        ttft_ms_median=float(np.median(ttft)) * 1e3,
        ttft_ms_max=float(ttft.max()) * 1e3,
        ttft_ms_request_0=float(ttft[0]) * 1e3,
        decode_ms_per_iter=run["decode_ms_per_iter"],
        generated=run["generated"], wall_s=run["wall_s"],
        tokens_per_s=run["tokens_per_s"], peak_gb=peak / 1e9,
        launches=launches, launches_per_decode_iter=run["decode_launches"],
        tokens0=outs[reqs[0].id].tokens.tolist(),
        distinct_tokens=[len(set(outs[r.id].tokens.tolist()))
                         for r in reqs])
    print(f"serve {name}: " + json.dumps(report), flush=True)
    return report


def serve_long(torch, arch: str, prefix: str, batch: int, prompt: int,
               new: int, n_req: int, int8s=(False,), release_int8=False):
    """Phases 5 and 6: full-width ``arch`` (bf16, random weights from
    SEED, every layer) built once, after the models of the phases before
    it are gone (the caches are emptied and the peak reset here).  At the
    init scales the decode-vs-prefill witness past the window
    (``long_witness``) and, with int8, the int8 copy's first logits
    against the bf16 model's (``int8_witness``).  Then, on weights varied
    as in phase 3, the fixed loop (``batch`` x ``prompt`` tokens, ``new``
    greedy tokens) and the scheduler at ``geometry(arch)`` with ``n_req``
    requests, request 0 with the ``prompt``-token prompt (it decodes past
    the window), the others 32-448 tokens; the scheduler once per entry
    of ``int8s``.  Each path counts its launches from 0, every kernel of
    ``PATH_KERNELS[<its name>]`` launched, every status ok, one decode
    iteration's launches exact (``decode_launches``).  With
    ``release_int8`` (gemma2, whose int8 copy does not fit beside the bf16
    model) the bf16 model's first logits at init scales are kept, and
    after the bf16 runs the model is drawn again from SEED and quantized
    in place, each block's bf16 projections released as its int8 copy is
    made (``quantize_params_for_serving(release=True)``, the launcher's
    ``--int8`` path): the int8 witness against the kept logits, then the
    scheduler on the int8 model varied as in phase 3 (its column scales
    tripled), the peak memory of the build and the run printed and held
    under the card's.  Returns the paths' reports under ``prefix``."""
    import gc
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import (NEW_RANGE, PROMPT_RANGE,
                                          geometry, make_requests)
    from repro_torch.models.lm import Model
    from repro_torch.models.loss import vocab_parallel_logits
    from repro_torch.serve.api import Request
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = Model(cfg).init_weights(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    toks = torch.randint(0, cfg.vocab, (batch, prompt),
                         generator=torch.Generator().manual_seed(SEED))
    out = {f"{prefix}_witness": long_witness(torch, model, toks, new)}
    if True in int8s:
        out[f"{prefix}_int8_witness"] = int8_witness(torch, model, toks)
        torch.cuda.empty_cache()
    if release_int8:
        first = first_logits(torch, model, toks)
    print(f"{prefix} witness: " + json.dumps(out), flush=True)
    vary(torch, model, SEED)
    capped = cfg.final_softcap or float("inf")

    # the fixed loop: generate_with_status_fixed, launches counted from 0
    name = f"{prefix}_fixed"
    engine = ServeEngine(model, ServeConfig(max_new_tokens=new))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = engine.generate_with_status_fixed({"tokens": toks})
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(res.tokens.shape == (batch, new),
            f"{name} tokens {res.tokens.shape}")
    require(all(st == "ok" for st in res.status),
            f"{name} statuses {res.status}")
    require(all(launches.get(key, 0) > 0 for key in PATH_KERNELS[name]),
            f"a kernel never launched on {name}: {launches}")
    # its prefill (the time to first token) and decode step times
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = model.prefill(toks, prompt + new)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    require(bool(torch.isfinite(logits).all())
            and logits.shape == (batch, cfg.padded_vocab()),
            f"{name} prefill logits")
    tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(new - 1):
        logits, cache = model.decode_step(cache, tok, prompt + i)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t) / (new - 1) * 1e3
    require(bool(torch.isfinite(logits).all())
            and float(logits.abs().max()) <= capped, f"{name} decode logits")
    _cuda.reset_launches()
    model.decode_step(cache, tok, prompt + new - 1)
    step_launches = decode_launches(name, dict(_cuda.LAUNCHES), cfg)
    # the logits' cost per iteration: the sliced fp32 product against the
    # embedding, at the scheduler's 8 lanes
    h = torch.randn((LANES, 1, cfg.d_model), device="cuda").to(torch.bfloat16)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    vocab_parallel_logits(h, model.embed, cfg.final_softcap)
    start.record()
    for _ in range(5):
        vocab_parallel_logits(h, model.embed, cfg.final_softcap)
    end.record()
    end.synchronize()
    fixed = dict(
        params=cfg.param_count(), init_s=init_s, weights_gb=weights_gb,
        batch=batch, prompt=prompt, new=new,
        ttft_ms=prefill_s * 1e3, decode_ms_per_step=dec_ms,
        generate_s=gen_s, tokens_per_s=batch * new / gen_s,
        statuses=list(res.status), launches=launches,
        launches_per_decode_step=step_launches, peak_gb=peak / 1e9,
        logits_ms_8_rows=start.elapsed_time(end) / 5,
        distinct_tokens=[len(set(lane.tolist())) for lane in res.tokens],
        tokens=res.tokens.tolist())
    del engine, cache, logits, h
    torch.cuda.empty_cache()
    print(f"serve {name}: " + json.dumps(fixed), flush=True)
    out[name] = fixed

    # the scheduler: n_req requests on 8 lanes, request 0 with the long
    # prompt
    geom = geometry(arch)
    require((geom["n_lanes"], geom["page_size"], geom["prefill_chunk"])
            == (LANES, PAGE, CHUNK), f"{arch} geometry {geom}")
    reqs = make_requests(cfg.vocab, n_req, SEED, PROMPT_RANGE, NEW_RANGE)
    long_toks = np.random.default_rng(SEED).integers(0, cfg.vocab, prompt)
    reqs[0] = Request(id=0, tokens=long_toks, sampling=reqs[0].sampling)
    for int8 in int8s:
        name = (f"{prefix}_scheduler" if int8s == (False,) else
                f"{prefix}_scheduler_{'int8' if int8 else 'bf16'}")
        t0 = time.perf_counter()
        eng = ServeEngine(model, ServeConfig(int8=int8, **geom))
        torch.cuda.synchronize()
        out[name] = scheduler_run(torch, eng, reqs, name, int8=int8,
                                  setup_s=time.perf_counter() - t0)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    if release_int8:
        out.update(serve_released_int8(torch, model, prefix, toks, first,
                                       reqs))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_released_int8(torch, model, prefix, toks, first, reqs):
    """``serve_long``'s releasing int8 run: ``model`` drawn again from
    SEED (bit for bit its init), quantized in place block by block, held
    to ``first`` (the bf16 model's first logits at init scales), varied,
    and served through the scheduler (``scheduler_run``); the peak covers
    the build, the witness and the run, and is held under 80 GB."""
    from repro_torch.launch.serve import geometry, int8_peak_bytes
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = model.cfg
    name = f"{prefix}_scheduler_int8"
    model.init_weights(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bf16_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    q8 = model.quantize_params_for_serving(release=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(q8 is model and model.int8, f"{name}: the build is not in place")
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    int8_gb = torch.cuda.memory_allocated() / 1e9
    out = {f"{prefix}_int8_witness": int8_witness(torch, model, toks,
                                                  q8=model, first=first)}
    print(f"{prefix} int8 witness: " + json.dumps(out), flush=True)
    vary(torch, model, SEED)
    geom = geometry(cfg.name)
    eng = ServeEngine(model, ServeConfig(int8=True, **geom))
    out[name] = scheduler_run(
        torch, eng, reqs, name, reset_peak=False, int8=True, release=True,
        **geom, bf16_weights_gb=bf16_gb, int8_weights_gb=int8_gb,
        build_s=build_s, build_peak_gb=build_peak,
        reckoned_peak_gb=int8_peak_bytes(cfg) / 1e9)
    peak = out[name]["peak_gb"]
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"{name}: peak {peak:.2f} GB of the card's {total:.2f} GB (the "
          f"build's {build_peak:.2f} GB)", flush=True)
    require(peak < 80, f"{name}: peak {peak:.1f} GB")
    del eng
    return out

# whisper-small (src/repro_torch/configs/whisper_small.py): 12 heads of 64
# (G = 1), d_model 768, d_ff 3072; phase 7 serves 8 clips of 1500 frames
# with a 64-token prompt and 64 greedy tokens (position 128 of its 448)
WH_ARCH = "whisper-small"
WH_H, WH_HD, WH_D, WH_FF, WH_FRAMES = 12, 64, 768, 3072, 1500
WH_BATCH, WH_PROMPT, WH_NEW = 8, 64, 64


def check_whisper_kernels(torch, timer):
    """Phase 2, whisper: the four kernel variants it runs, each against its
    plain version on the card at the main path's shapes and timed beside
    its bound and yardstick.  K1 with ``activation='gelu'`` (the up GEMM
    [M, 768] x [768, 3072]) over the encoder's 8 x 1500 frames and at
    decode (M = 8), each row within 2 bf16 ulps of its scale, beside one
    ``torch.matmul`` of the same operands (the gelu not included).  K2
    with gelu and the row quantize (the int8 decoder's up GEMM) at decode
    (M = 8, the store-phase tail) and at the 8 x 64 prefill (M = 512, the
    row kernel after it): q within one step, the scales within 2 fp32
    ulps, beside ``torch._int_mm``.  K4 'full' over the encoder (8 x 1500
    x 1500, 12 heads of 64) and the cross-attention prefill (Sq 64
    against Skv 1500, a ragged tile), each row within 2 bf16 ulps; K5
    'full' over the 1500 frames at decode (``k5_row``: bitwise across
    split counts, partials within 1e-5); each beside SDPA with no mask."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.epilogue import Epilogue
    from repro_torch.kernels.matmul import k1_plan, sm_count

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    eps_f32 = float(torch.finfo(torch.float32).eps)
    tol = 2 * eps_bf16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    bf = torch.bfloat16

    def rand(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    results = {}
    k, n = WH_D, WH_FF
    w = rand(k, n, scale=3 * k ** -0.5)
    ep = Epilogue(activation="gelu", out_dtype=bf)
    for m, where in ((WH_BATCH * WH_FRAMES, "the encoder's 8 x 1500 frames"),
                     (WH_BATCH, "decode")):
        x = rand(m, k)
        got = ops.matmul(x, w, epilogue=ep)
        want = ref.matmul_fused_ref(x, w, ep)
        err, abs_err = row_err(got, want), max_err(got, want)
        del got, want
        require(err <= tol, f"K1 gelu M={m}: a row is off by {err:.3e}")
        t_b, by = bound(2 * (m * k + k * n + m * n), 2 * m * k * n)
        plan = k1_plan(m, n, k, sm_count(0))
        results[f"k1_matmul_gelu_m{m}"] = dict(
            work=f"whisper's up GEMM with the gelu epilogue at {where}: "
                 f"M={m} K={k} N={n}, {plan.regime} regime, "
                 f"{plan.splits} split(s)",
            max_abs_err=abs_err, max_row_err=err, tol=tol,
            ms=timer(lambda x=x: ops.matmul(x, w, epilogue=ep)),
            wrapper_ms=timer.wall(lambda x=x: ops.matmul(x, w, epilogue=ep)),
            plain_ms=timer(lambda x=x: ref.matmul_fused_ref(x, w, ep),
                           reps=3),
            bound_ms=t_b, bound_by=by,
            library_ms=timer(lambda x=x: torch.matmul(x, w)),
            library_note="torch.matmul of the same operands, the gelu not "
                         "included",
            # K1 on the same operands with no gelu: the activation's cost
            no_gelu_ms=timer(lambda x=x: ops.matmul(x, w, out_dtype=bf)))
        print("  whisper k1 " + json.dumps(
            {f"M={m}": results[f"k1_matmul_gelu_m{m}"]}), flush=True)

    # K2: the int8 up GEMM, the weight in QuantizedWeight's [N, K] storage
    qb, sb = ref.quantize_colwise_ref(rand(k, n, scale=3 * k ** -0.5,
                                           dtype=torch.float32))
    qb = qb.t().contiguous().t()
    ep8 = Epilogue(activation="gelu", quantize=True)
    for m, where in ((WH_BATCH, "decode: the quantize in the store phase"),
                     (WH_BATCH * WH_PROMPT,
                      "the prefill: the row kernel after the GEMM")):
        qa, sa = ref.quantize_rowwise_ref(rand(m, k, dtype=torch.float32))
        require(torch.equal(ops.int8_matmul(qa, sa, qb, sb),
                            ref.int8_matmul_ref(qa, sa, qb, sb)),
                f"K2 M={m} K={k} N={n}: fp32 out is not bitwise")
        got = ops.int8_matmul(qa, sa, qb, sb, epilogue=ep8)
        want = ref.int8_matmul_ref(qa, sa, qb, sb, ep8)
        q_err = int((got[0].int() - want[0].int()).abs().max())
        s_err = float(((got[1] - want[1]).abs() / want[1]).max())
        require(q_err <= 1 and s_err <= 2 * eps_f32,
                f"K2 gelu M={m}: q off by {q_err}, scale by {s_err}")
        nbytes = m * k + k * n + 4 * (m + n) + m * n + 4 * m
        t_b, by = bound(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
        lib, form = _int_mm_ms(torch, timer, qa, qb)
        row = dict(
            work=f"whisper's int8 up GEMM with gelu and the row quantize at "
                 f"{where}: M={m} K={k} N={n}",
            max_abs_err=float(q_err), max_row_err=s_err,
            tol=2 * eps_f32, q_tol=1,
            ms=timer(lambda qa=qa, sa=sa: ops.int8_matmul(
                qa, sa, qb, sb, epilogue=ep8)),
            wrapper_ms=timer.wall(lambda qa=qa, sa=sa: ops.int8_matmul(
                qa, sa, qb, sb, epilogue=ep8)),
            plain_ms=timer(lambda qa=qa, sa=sa: ref.int8_matmul_ref(
                qa, sa, qb, sb, ep8)),
            bound_ms=t_b, bound_by=by, library_ms=lib, library_form=form,
            library_note="torch._int_mm (cuBLASLt int8, no epilogue), the "
                         "faster operand form")
        if lib is None:
            # _int_mm refuses M <= 16: its time on the rows zero-padded to
            # 32 (another shape, recorded as such)
            pad = torch.zeros((32, k), dtype=torch.int8, device="cuda")
            pad[:m] = qa
            row["library_ms"], row["library_form"] = _int_mm_ms(
                torch, timer, pad, qb)
            row["library_note"] += "; on the rows zero-padded to 32"
        results[f"k2_int8_matmul_gelu_m{m}"] = row
        print("  whisper k2 " + json.dumps({f"M={m}": row}), flush=True)

    # K4 'full': the encoder's self-attention, the cross-attention prefill
    for name, sq in (("k4_flash_prefill_full_encoder", WH_FRAMES),
                     ("k4_flash_prefill_full_cross", WH_PROMPT)):
        b, skv = WH_BATCH, WH_FRAMES
        q = rand(b, sq, WH_H, WH_HD, scale=2.0)
        kk, vv = rand(b, skv, WH_H, WH_HD, scale=2.0), rand(b, skv, WH_H,
                                                             WH_HD)
        got = ops.flash_attention(q, kk, vv, kind="full")
        want = ref.flash_attention_ref(q, kk, vv, kind="full")
        err, abs_err = row_err(got, want), max_err(got, want)
        del got, want
        require(err <= tol, f"{name}: a row is off by {err:.3e}")
        t_b, by = bound(2 * (2 * q.numel() + 2 * kk.numel()),
                        4 * b * WH_H * WH_HD * sq * skv)
        results[name] = dict(
            work=f"full (bidirectional) prefill B={b} Sq={sq} Skv={skv} "
                 f"H={WH_H} KV={WH_H} hd={WH_HD} (Skv ragged: 1500 = 11 x "
                 f"128 + 92)",
            max_abs_err=abs_err, max_row_err=err, tol=tol,
            ms=timer(lambda q=q, kk=kk, vv=vv: ops.flash_attention(
                q, kk, vv, kind="full")),
            wrapper_ms=timer.wall(lambda q=q, kk=kk, vv=vv:
                                  ops.flash_attention(q, kk, vv,
                                                      kind="full")),
            plain_ms=timer(lambda q=q, kk=kk, vv=vv: ref.flash_attention_ref(
                q, kk, vv, kind="full"), reps=3),
            bound_ms=t_b, bound_by=by,
            library_ms=sdpa_ms(torch, timer, q, kk, vv),
            library_note="SDPA with no mask (sdpa_ms)")
        print("  whisper k4 " + json.dumps({name: results[name]}),
              flush=True)
        del q, kk, vv
    results["k5_flash_decode_full"] = k5_row(
        torch, timer, rand, WH_BATCH, WH_FRAMES, 0, WH_H, 1, WH_HD, None,
        2.0, "whisper-small's cross-attention decode", kind="full")
    torch.cuda.empty_cache()
    return results


def check_fixed_smoke(torch, arch: str, **over):
    """Phase 3, the models served through the fixed loop only: whisper
    (2 encoder and 2 decoder layers, 24 frames a clip), paligemma (2
    layers, 8 patches an image), recurrentgemma (5 layers: one group of
    (rglru, rglru, local) and the (rglru, rglru) tail, window 16; ``over``
    its bf16 ``param_dtype``) and xlstm (7 mLSTM blocks and 1 sLSTM
    block; a 16-token prompt, one chunk), each smoke config at bf16 compute
    and at its full config's weights (fp32 masters, served from their
    bf16 copy; recurrentgemma's bf16 leaves), card against
    CPU, weights varied as in phase 3, through ``generate_with_status``
    (its fall-through to the fixed loop), bf16 and int8: the card's
    teacher-forced logits (prefill with the frames or the patches, then
    decode steps fed the CPU's picks) within twice the CPU pipeline's own
    bf16 rounding noise (its distance from an fp32-compute run on the same
    weights), and each lane's greedy tokens equal up to its first step
    where the CPU's two best logits lie within twice the lane's card-CPU
    logit difference (a near tie that difference explains)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_frames, make_patches
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    cpu = Model(cfg, device="cpu").init_weights(SEED)
    vary(torch, cpu, SEED)
    card = Model(cfg)
    card.load_state_dict(cpu.state_dict())
    ref32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                  device="cpu")
    ref32.load_state_dict(cpu.state_dict())
    plen, steps = 16, 8
    toks = torch.randint(0, cfg.vocab, (BATCH, plen),
                         generator=torch.Generator().manual_seed(SEED + 3))
    inputs = ({"frames": make_frames(cfg, BATCH, SEED + 3)} if cfg.encdec
              else {"patches": make_patches(cfg, BATCH, SEED + 3)}
              if cfg.prefix_tokens else {})
    batch = {"tokens": toks, **inputs}
    prompt = plen + cfg.prefix_tokens

    def rel(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max()
                     / max(1.0, float(b.abs().max())))

    out = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        scfg = ServeConfig(max_new_tokens=steps, int8=int8)
        ecpu, ecard = ServeEngine(cpu, scfg), ServeEngine(card, scfg)
        want = ecpu.generate_with_status(batch)
        got = ecard.generate_with_status(batch)
        require(list(got.status) == list(want.status) == ["ok"] * BATCH,
                f"{cfg.name} {tag} statuses {got.status} {want.status}")
        served = (ecpu.model, ecard.model,
                  ref32.quantize_params_for_serving() if int8 else ref32)
        runs = [m.prefill(toks, prompt + steps, **inputs) for m in served]
        logits = [[r[0].float().cpu()] for r in runs]
        caches = [r[1] for r in runs]
        for i in range(steps - 1):
            tok = torch.from_numpy(want.tokens[:, i:i + 1])
            for j, m in enumerate(served):
                lg, caches[j] = m.decode_step(caches[j], tok, prompt + i)
                logits[j].append(lg.float().cpu())
        lc, lg, l3 = logits
        err = [rel(g, c) for g, c in zip(lg, lc)]
        noise = [rel(c, r) for c, r in zip(lc, l3)]
        require(max(err) <= 2 * max(noise),
                f"{cfg.name} {tag}: card logits off by {max(err):.3e} "
                f"of scale, budget {2 * max(noise):.3e}")
        # each lane up to its first near tie: a step where the CPU's two
        # best logits of the lane lie within twice the lane's card-CPU
        # logit difference
        first = [steps] * BATCH
        for i, (g, c) in enumerate(zip(lg, lc)):
            top2 = c[:, :cfg.vocab].topk(2, dim=-1).values
            diff = (g - c).abs().amax(-1)
            for lane in range(BATCH):
                if (first[lane] == steps
                        and top2[lane, 0] - top2[lane, 1] <= 2 * diff[lane]):
                    first[lane] = i
        for lane in range(BATCH):
            require(np.array_equal(got.tokens[lane, :first[lane]],
                                   want.tokens[lane, :first[lane]]),
                    f"{cfg.name} {tag} lane {lane}: greedy tokens differ "
                    f"before a near tie: card {got.tokens.tolist()} cpu "
                    f"{want.tokens.tolist()}")
        out[tag] = dict(tokens=got.tokens.tolist(),
                        cpu_tokens=want.tokens.tolist(), equal_steps=first,
                        logit_err=max(err), budget=2 * max(noise))
    return out


def serve_whisper(torch):
    """Phase 7: full-width whisper-small (12 encoder and 12 decoder layers,
    fp32 masters served from their bf16 copy, random weights from SEED),
    built after the
    models of the phases before it are gone.  At the init scales the
    decode-vs-prefill witness (``long_witness`` with the frames) and the
    int8 copy's first logits against the bf16 model's (``int8_witness``).
    Then, on weights varied as in phase 3, ``generate_with_status`` (the
    engine falls through to the fixed loop: the model is not pageable) on
    8 clips of 1500 frames, a 64-token prompt and 64 greedy tokens, bf16
    and int8, each with the launch counts set to 0 just before it: every
    status ok, every kernel of ``PATH_KERNELS[<its name>]`` launched, and
    one decode iteration's launches exact (``decode_launches``)."""
    import gc
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import make_frames
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(WH_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg).init_weights(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    toks = torch.randint(0, cfg.vocab, (WH_BATCH, WH_PROMPT),
                         generator=torch.Generator().manual_seed(SEED))
    frames = make_frames(cfg, WH_BATCH, SEED)
    out = {"whisper_witness": long_witness(torch, model, toks, 16,
                                           frames=frames),
           "whisper_int8_witness": int8_witness(torch, model, toks,
                                                frames=frames)}
    print("whisper witness: " + json.dumps(out), flush=True)
    vary(torch, model, SEED)
    batch = {"tokens": toks, "frames": frames}
    for int8 in (False, True):
        name = "whisper_fixed_int8" if int8 else "whisper_fixed"
        engine = ServeEngine(model, ServeConfig(max_new_tokens=WH_NEW,
                                                int8=int8))
        served = engine.model
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        res = engine.generate_with_status(batch)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        require(engine._sched is None and not engine._shim_cache,
                f"{name}: generate_with_status built a scheduler")
        require(res.tokens.shape == (WH_BATCH, WH_NEW),
                f"{name} tokens {res.tokens.shape}")
        require(all(st == "ok" for st in res.status),
                f"{name} statuses {res.status}")
        require(all(launches.get(key, 0) > 0 for key in PATH_KERNELS[name]),
                f"a kernel never launched on {name}: {launches}")
        # the prefill (the encoder included: the time to first token) and
        # the decode step
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = served.prefill(toks, WH_PROMPT + WH_NEW,
                                       frames=frames)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        require(bool(torch.isfinite(logits).all())
                and logits.shape == (WH_BATCH, cfg.padded_vocab()),
                f"{name} prefill logits")
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(WH_NEW - 2):
            logits, cache = served.decode_step(cache, tok, WH_PROMPT + i)
            tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t) / (WH_NEW - 2) * 1e3
        require(bool(torch.isfinite(logits).all()), f"{name} decode logits")
        _cuda.reset_launches()
        served.decode_step(cache, tok, WH_PROMPT + WH_NEW - 2)
        step_launches = decode_launches(name, dict(_cuda.LAUNCHES), cfg,
                                        int8)
        report = dict(
            params=sum(p.numel() for p in model.parameters()),
            init_s=init_s, weights_gb=weights_gb, batch=WH_BATCH,
            frames=WH_FRAMES, prompt=WH_PROMPT, new=WH_NEW, int8=int8,
            ttft_ms=prefill_s * 1e3, decode_ms_per_step=dec_ms,
            generate_s=gen_s, tokens_per_s=WH_BATCH * WH_NEW / gen_s,
            statuses=list(res.status), launches=launches,
            launches_per_decode_step=step_launches, peak_gb=peak / 1e9,
            distinct_tokens=[len(set(lane.tolist())) for lane in res.tokens],
            tokens=res.tokens[:, :16].tolist())
        print(f"serve {name}: " + json.dumps(report), flush=True)
        out[name] = report
        if not int8:
            greedy_tokens = res.tokens
        del engine, served, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ck = checkpoint_round_trip(torch, model, batch, greedy_tokens, WH_NEW)
    ck["part_s"] = time.perf_counter() - t0
    print("whisper checkpoint: " + json.dumps(ck), flush=True)
    out["whisper_checkpoint"] = ck
    # the sampled fixed loop (generate_with_status falls through to it):
    # one key over the [8, v] draw, split after each step; the same seed
    # replays bitwise
    t0 = time.perf_counter()
    engine = ServeEngine(model, ServeConfig(max_new_tokens=WH_NEW,
                                            greedy=False,
                                            temperature=SAMPLE_TEMP))
    runs = [engine.generate_with_status(batch, seed=5) for _ in range(2)]
    require(all(r.ok for r in runs)
            and np.array_equal(runs[0].tokens, runs[1].tokens),
            "whisper sampled: the same seed did not replay bitwise")
    require(not np.array_equal(runs[0].tokens, greedy_tokens),
            "whisper sampled: the sampled run emitted the greedy tokens")
    out["whisper_sampled"] = dict(
        temperature=SAMPLE_TEMP, seed=5, replay_bitwise=True,
        tokens=runs[0].tokens[:, :16].tolist(),
        part_s=time.perf_counter() - t0)
    print("whisper sampled: " + json.dumps(out["whisper_sampled"]),
          flush=True)
    del engine, runs
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# llama4-scout: the 'chunked' kind in K4 and K6, K4's 'prefix' kind, the
# MoE FFN, G = 5
# ---------------------------------------------------------------------------

def by_kv_head(torch, q, k, v, **var):
    """The plain K4 one kv head (and its G q heads) at a time: the whole
    score tensor of a long prefill with many heads would take tens of
    GB."""
    from repro_torch.kernels import ref
    g = q.shape[2] // k.shape[2]
    return torch.cat([ref.flash_attention_ref(
        q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1], v[:, :, j:j + 1],
        **var) for j in range(k.shape[2])], dim=2)


def check_llama4_kernels(torch, timer):
    """Phase 2, llama4: the new variants against their plain versions at
    the shapes the driven paths give them, each row within 2 bf16 ulps of
    its scale.  K4 'chunked' at the fixed loop's prefill (B 2 x S 8448, 40
    q heads over 8, hd 128, chunks of 8192: the boundary inside the
    prefill), its plain version taken a kv head at a time (the whole
    score tensor would be 23 GB), beside SDPA with the chunks as a bool
    mask; K4 'prefix' at paligemma's would-be shape (B 4, 256 patches and
    256 text tokens, 8 heads over 1 of 256, ``prefix_len`` 256) beside
    SDPA with the bool mask; K6 'chunked' at the scheduler's geometry (8
    lanes, KV 8, G 5, 16-slot pages, 514 pages a lane) with lanes on both
    sides of the 8192 boundary and one idle: decode (partials within
    1e-5, bitwise the same at split counts 1, 2, 4, the default and one
    per tile, the idle lane 0.0) and the S = 64 chunk body
    (``chunk_contracts``; q tiles of 25, 25 and 14 positions at G = 5); K1
    at llama4's two projections, the packed qkv [5120, 7168] and wo [5120,
    5120], at M = 8 and 512, beside ``torch.matmul``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        chunk_tiles, head_groups, paged_decode_launch,
        paged_flash_decode_tiled, paged_tile_partials)

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    tol = 2 * eps_bf16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    bf = torch.bfloat16
    H, KV, hd, W = L4_H, L4_KV, L4_HD, L4_WINDOW
    G = H // KV
    require(head_groups(G) == (1, G) and chunk_tiles(CHUNK, G) == (25, 3),
            f"G = {G}: head_groups {head_groups(G)}, chunk_tiles "
            f"{chunk_tiles(CHUNK, G)}")

    def rand(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    results = {}
    # K4 'chunked' at the fixed loop's prefill, and 'prefix'
    b, s = L4_BATCH, L4_PROMPT
    pos = torch.arange(s, device="cuda")
    chunked_mask = (pos[None, :] <= pos[:, None]) & (
        pos[None, :] // W == pos[:, None] // W)
    pp = torch.arange(PG_S, device="cuda")
    prefix_mask = (pp[None, :] <= pp[:, None]) | (pp[None, :] < PG_PREFIX)
    for name, shape, var, live, mask, what in (
            ("k4_flash_prefill_chunked", (b, s, H, KV, hd),
             dict(kind="chunked", window=W),
             sum(p % W + 1 for p in range(s)), chunked_mask,
             f"chunked prefill window={W} B={b} S={s} H={H} KV={KV} "
             f"hd={hd} (G = {G}; the plain version a kv head at a time)"),
            ("k4_flash_prefill_prefix", (PG_B, PG_S, PG_H, PG_KV, PG_HD),
             dict(kind="prefix", prefix_len=PG_PREFIX),
             PG_PREFIX * PG_PREFIX + sum(p + 1 for p in
                                         range(PG_PREFIX, PG_S)),
             prefix_mask,
             f"prefix-LM prefill prefix_len={PG_PREFIX} B={PG_B} S={PG_S} "
             f"H={PG_H} KV={PG_KV} hd={PG_HD} (paligemma's would-be shape; "
             f"reached through ops.flash_attention only)")):
        bb, ss, hh, kvh, dd = shape
        q, k, v = rand(bb, ss, hh, dd), rand(bb, ss, kvh, dd), rand(
            bb, ss, kvh, dd)
        got = ops.flash_attention(q, k, v, **var)
        want = by_kv_head(torch, q, k, v, **var)
        err, abs_err = row_err(got, want), max_err(got, want)
        del got, want
        require(err <= tol, f"{name}: a row is off by {err:.3e} of its "
                            f"scale")
        t_b, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                        4 * bb * hh * dd * live)
        results[name] = dict(
            work=what, max_abs_err=abs_err, max_row_err=err, tol=tol,
            ms=timer(lambda var=var: ops.flash_attention(q, k, v, **var),
                     reps=3),
            wrapper_ms=timer.wall(
                lambda var=var: ops.flash_attention(q, k, v, **var), reps=3),
            plain_ms=timer(lambda var=var: by_kv_head(torch, q, k, v, **var),
                           reps=1),
            bound_ms=t_b, bound_by=by,
            library_ms=sdpa_ms(torch, timer, q, k, v, attn_mask=mask),
            library_note="SDPA with the mask as a bool tensor (sdpa_ms)")
        print("  k4 " + json.dumps({name: results[name]}), flush=True)
        del q, k, v
    del chunked_mask, prefix_mask
    torch.cuda.empty_cache()

    # K6 'chunked' at the scheduler's geometry
    L, ps, P = LANES, PAGE, L4_PAGES
    n_pages = L * P
    kp, vp = rand(n_pages + 1, ps, KV, hd), rand(n_pages + 1, ps, KV, hd)
    lane_pos = torch.tensor([0, 31, 8191, 8192, 8200, 8223, 5000, -1],
                            dtype=torch.int32)
    table = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        SEED)).reshape(L, P).to(torch.int32)
    for lane in range(L):
        table[lane, max(int(lane_pos[lane]), 0) // ps + 1:] = -1
    table = table.cuda()
    posd = lane_pos.cuda()[:, None].contiguous()
    var = dict(kind="chunked", window=W)
    q = rand(L, 1, KV, G, hd)
    rows, n_tiles = L * KV, P * ps // 32
    got = ops.paged_flash_decode(q, kp, vp, table, posd, **var)
    require(bool((got[L - 1] == 0).all()), "K6 chunked: the idle lane is "
                                           "not 0.0")
    splits = sorted({1, 2, 4, n_tiles})
    for n in splits:
        out, _ = paged_decode_launch(q, kp, vp, table, posd, n_splits=n,
                                     **var)
        require(torch.equal(out, got), f"K6 chunked decode differs at "
                                       f"{n} splits")
    want = paged_flash_decode_tiled(q, kp, vp, table, posd, **var)
    dec_err, dec_abs = row_err(got, want), max_err(got, want)
    out, ws = paged_decode_launch(q, kp, vp, table, posd, **var)
    p_err = record_err(torch, ws, paged_tile_partials(
        q, kp, vp, table, posd, **var), rows, n_tiles, G, hd)
    del out, ws, got, want
    qc = rand(L, CHUNK, KV, G, hd)
    pc = lane_pos.clamp(min=0)[:, None] - CHUNK + 1 + torch.arange(CHUNK)[
        None]
    pc = torch.where((pc >= 0) & (lane_pos[:, None] >= 0), pc, -1)
    pc[2, -7:] = -1      # a final chunk's padded tail
    pc = pc.to(torch.int32).cuda().contiguous()
    chunk = chunk_contracts(torch, qc, kp, vp, table, pc, 4, **var)
    chunk_want = paged_flash_decode_tiled(qc, kp, vp, table, pc, **var)
    chunk_err, chunk_abs = row_err(chunk, chunk_want), max_err(chunk,
                                                               chunk_want)
    del chunk, chunk_want
    require(p_err <= 1e-5 and max(dec_err, chunk_err) <= tol,
            f"K6 chunked: decode {dec_err:.3e} (partials {p_err:.3e}), "
            f"chunk {chunk_err:.3e}")
    where = (f"L={L} KV={KV} G={G} hd={hd} page_size={ps} P={P} "
             f"({n_tiles} tiles), positions {lane_pos.tolist()}")
    lib_note = "no one PyTorch call attends through a page table"
    dec = dict(
        work=f"paged decode chunked window={W} {where}; the idle lane 0.0, "
             f"bitwise at split counts {splits} and the default",
        max_abs_err=dec_abs, max_row_err=dec_err, tol=tol,
        partials_row_err=p_err, partials_tol=1e-5,
        ms=timer(lambda: ops.paged_flash_decode(q, kp, vp, table, posd,
                                                **var)),
        wrapper_ms=timer.wall(lambda: ops.paged_flash_decode(
            q, kp, vp, table, posd, **var)),
        plain_ms=timer(lambda: paged_flash_decode_tiled(
            q, kp, vp, table, posd, **var), reps=1),
        library_ms=None, library_note=lib_note)
    dec["bound_ms"], dec["bound_by"] = k6_bound(q, table, posd, KV, W, True)
    chk = dict(
        work=f"paged prefill chunk S={CHUNK} chunked window={W} {where}, "
             f"each lane's chunk ending at its position (a padded tail), "
             f"q tiles of 25, 25 and 14 positions x 5 heads; "
             f"deterministic, idle rows 0.0, a lane unmoved by its "
             f"neighbours",
        max_abs_err=chunk_abs, max_row_err=chunk_err, tol=tol,
        ms=timer(lambda: ops.paged_flash_decode(qc, kp, vp, table, pc,
                                                **var), reps=3),
        wrapper_ms=timer.wall(lambda: ops.paged_flash_decode(
            qc, kp, vp, table, pc, **var), reps=3),
        plain_ms=timer(lambda: paged_flash_decode_tiled(
            qc, kp, vp, table, pc, **var), reps=1),
        library_ms=None, library_note=lib_note)
    chk["bound_ms"], chk["bound_by"] = k6_bound(qc, table, pc, KV, W, True)
    results["k6_paged_decode_chunked"] = dec
    results["k6_paged_decode_chunk_chunked"] = chk
    print("  k6 chunked " + json.dumps([dec, chk]), flush=True)
    del kp, vp, q, qc
    torch.cuda.empty_cache()

    # K1 at llama4's two projections (its FFN is the MoE's batched
    # products, not K1)
    shapes = []
    for m in (LANES, LANES * CHUNK):
        shapes += k1_rows(torch, timer, rand, "llama4",
                          m, L4_D, (H + 2 * KV) * hd, H * hd, 8192, tol,
                          names=("qkv", "o"))
    for m, where in ((LANES, "decode"), (LANES * CHUNK, "a scheduler chunk")):
        results[f"k1_matmul_llama4_m{m}"] = dict(
            k1_sum(shapes, "llama4", m,
                   f"llama4-scout's qkv [{L4_D}, {(H + 2 * KV) * hd}] and "
                   f"o [{H * hd}, {L4_D}] at {where} (M={m})", tol),
            shapes=[r for r in shapes
                    if r["shape"].split()[1] == f"M={m}"])
    return results


def check_paligemma_kernels(torch, timer):
    """Phase 2, paligemma: head dim 256 at G = 8 (8 q heads over 1 kv
    head), the shapes its fixed loop gives K4 and K5.  K4 'global' over
    the prefill of 8 images' 256 patches and 256 text tokens (the patches
    attended causally, as the reference does: ROADMAP F5), each row within
    2 bf16 ulps of its scale, beside SDPA causal; K5 at the last decode
    step, position 543 of a 544-slot cache (``k5_row``: bitwise at split
    counts 1, 2, 4, the default and one per tile, partials within 1e-5),
    beside SDPA."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import head_groups

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    tol = 2 * eps_bf16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    bf = torch.bfloat16
    b, s, H, KV, hd = PG_BATCH, PG_S, PG_H, PG_KV, PG_HD
    G = H // KV
    require(head_groups(G) == (1, G), f"G = {G}: {head_groups(G)}")

    def rand(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    q, k, v = rand(b, s, H, hd), rand(b, s, KV, hd), rand(b, s, KV, hd)
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    err, abs_err = row_err(got, want), max_err(got, want)
    del got, want
    require(err <= tol, f"K4 paligemma: a row is off by {err:.3e} of its "
                        f"scale")
    t_b, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                    4 * b * H * hd * s * (s + 1) / 2)
    results = {"k4_flash_prefill_paligemma": dict(
        work=f"global (causal) prefill over {PG_PREFIX} patches and "
             f"{PG_TEXT} text tokens B={b} S={s} H={H} KV={KV} hd={hd} "
             f"(G = {G}; 64-slot K/V tiles)",
        max_abs_err=abs_err, max_row_err=err, tol=tol,
        ms=timer(lambda: ops.flash_attention(q, k, v)),
        wrapper_ms=timer.wall(lambda: ops.flash_attention(q, k, v)),
        plain_ms=timer(lambda: ref.flash_attention_ref(q, k, v), reps=3),
        bound_ms=t_b, bound_by=by,
        library_ms=sdpa_ms(torch, timer, q, k, v, is_causal=True),
        library_note="SDPA causal (sdpa_ms)")}
    print("  k4 " + json.dumps(results), flush=True)
    del q, k, v
    results["k5_flash_decode_paligemma"] = k5_row(
        torch, timer, rand, b, s + PG_NEW, s + PG_NEW - 1, KV, G, hd, None,
        1.0, "paligemma-3b's fixed loop")
    torch.cuda.empty_cache()
    return results


def moe_witness(torch, model, toks, new: int):
    """The MoE models' witness at the reference's init scales (phases 8
    and 12): the fixed loop's decode step at position prompt + new - 2
    (llama4's past the 8192 chunk: the chunked layers' ring has wrapped
    and attends chunk 1 only) against the last logits of a prefill over
    the same tokens (K4; llama4's chunked across the boundary).  The MoE
    drops an entry past its expert's capacity, which depends on the call's
    token count, so the two prefills (the decode's and the comparison's)
    may drop different entries, and a dropped entry changes the lane from
    there on.  Per lane and layer it reports the tokens with a dropped
    entry in each prefill (``Model.moe_kept``: all k of a token's entries
    kept); it holds a lane to WITNESS_TOL only where no token of it lost
    an entry in either (the lanes are then independent), and needs one
    such lane.  The same step against a prefill whose last token was
    changed must differ by more than 4x the tolerance there."""
    cfg = model.cfg
    prompt = toks.shape[1]

    def dropped():   # [lanes, layers]: tokens of each lane dropped
        return torch.stack([(~k).sum(dim=1) for k in model.moe_kept],
                           dim=1).cpu()
    logits, cache = model.prefill(toks, prompt + new)
    drop_cache = dropped()
    seq = toks.to(logits.device)
    for i in range(new - 1):
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        seq = torch.cat([seq, tok], dim=1)
        logits, cache = model.decode_step(cache, tok, prompt + i)
    del cache
    want, _ = model.prefill(seq)
    drop_want = dropped()
    other = seq.clone()
    other[:, -1] = (other[:, -1] + 1) % cfg.vocab
    off, _ = model.prefill(other)
    held = [b for b in range(toks.shape[0])
            if int(drop_cache[b].sum()) == 0 and int(drop_want[b].sum()) == 0]
    w = dict(position=prompt + new - 2, held_lanes=held,
             dropped_decode_prefill=drop_cache.tolist(),
             dropped_witness_prefill=drop_want.tolist(), tol=WITNESS_TOL)
    require(held, f"{cfg.name}: every lane dropped a token in a prefill, "
                  f"no witness held: {w}")
    w["err"] = rel_rows(logits[held], want[held])
    w["other_token"] = rel_rows(logits[held], off[held])
    require(w["err"] <= WITNESS_TOL,
            f"{cfg.name} decode is off its prefill by {w['err']:.3e} of the "
            f"logit scale: {w}")
    require(w["other_token"] > 4 * WITNESS_TOL,
            f"the {cfg.name} witness cannot tell a changed token apart: {w}")
    return w


def serve_llama4(torch):
    """Phase 8: llama4-scout at full width (d_model 5120, 40 q heads over
    8, 16 experts of 8192, vocab 202048), 8 of its 48 layers (two periods
    of the 3:1 chunked:global pattern; 37.3 GB of bf16 weights), random
    weights from SEED, built after the models of the phases before it are
    gone.  At the init scales the MoE witness (``moe_witness``) and the
    int8 copy's first logits against the bf16 model's on 8 lanes of 512
    tokens (``int8_witness``).  Then, on weights varied as in phase 3,
    each path with the launch counts set to 0 just before it: the fixed
    loop (``generate_with_status_fixed``, batch 2, prompt 8448: K4
    chunked across the 8192 boundary and global, the ring wrapped, K5
    global, K1) and the scheduler (8 requests on 8 lanes, request 0 an
    8180-token prompt with 32 new tokens, decoding past 8192; K6 chunked
    and global in both bodies, K1), once bf16 and once on the int8 copy
    of the attention (K2 and K3 for ``wqkv`` and ``wo``; the MoE shared,
    ``scheduler_run``).  Every status ok,
    every variant of ``PATH_KERNELS`` launched, one decode iteration's
    launches exact (``decode_launches`` with the MoE's standalone norms),
    and request 0 served alone first emits bitwise the tokens it emits
    amid churn (lane 0's tokens sort first within every expert, so no
    neighbour takes its capacity: ROADMAP F6)."""
    import gc
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (NEW_RANGE, PROMPT_RANGE, geometry,
                                          make_requests, with_layers)
    from repro_torch.models.lm import Model
    from repro_torch.serve.api import Request, SamplingParams
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = with_layers(get_config(L4_ARCH), L4_LAYERS)
    t0 = time.perf_counter()
    model = Model(cfg).init_weights(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    wit = torch.randint(0, cfg.vocab, (L4_BATCH, L4_WIT_PROMPT),
                        generator=torch.Generator().manual_seed(SEED))
    out = {"llama4_witness": moe_witness(torch, model, wit, L4_WIT_NEW)}
    wit8 = torch.randint(0, cfg.vocab, (L4_WIT8_LANES, L4_WIT8_PROMPT),
                         generator=torch.Generator().manual_seed(SEED + 2))
    out["llama4_int8_witness"] = int8_witness(torch, model, wit8)
    print("llama4 witness: " + json.dumps(out), flush=True)
    vary(torch, model, SEED)
    toks = torch.randint(0, cfg.vocab, (L4_BATCH, L4_PROMPT),
                         generator=torch.Generator().manual_seed(SEED + 1))
    out["llama4_fixed"] = moe_fixed_run(
        torch, ServeEngine(model, ServeConfig(max_new_tokens=L4_NEW)), toks,
        L4_NEW, "llama4_fixed", layers=cfg.n_layers,
        params=cfg.param_count(), init_s=init_s, weights_gb=weights_gb)
    torch.cuda.empty_cache()
    geom = geometry(L4_ARCH)
    require((geom["n_lanes"], geom["page_size"], geom["prefill_chunk"],
             geom["max_seq_len"] // geom["page_size"])
            == (LANES, PAGE, CHUNK, L4_PAGES), f"{L4_ARCH} geometry {geom}")
    reqs = make_requests(cfg.vocab, L4_REQ, SEED, PROMPT_RANGE, NEW_RANGE)
    reqs[0] = Request(id=0, tokens=np.random.default_rng(SEED).integers(
        0, cfg.vocab, L4_LONG), sampling=SamplingParams(
        max_new_tokens=L4_LONG_NEW))
    out.update(moe_scheduler_runs(torch, model, reqs, geom, "llama4"))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_fixed_run(torch, engine, toks, new, name, **extra):
    """One driven fixed-loop path of an MoE model (phases 8 and 12) on
    ``engine``'s model (bf16, or its int8 copy): the launch counts and the
    peak set to 0 just before ``generate_with_status_fixed`` of ``toks``,
    ``new`` tokens a lane; every status ok, every kernel of
    ``PATH_KERNELS[name]`` launched, the peak under the card's 80 GB.
    Then, timed on their own, one prefill (the TTFT; each layer's count of
    tokens with a dropped entry) and ``new - 1`` decode steps, and one
    more step's launches counted exactly (``decode_launches``, the MoE's
    standalone norms).  Prints and returns the report, ``extra`` in it."""
    from repro_torch.kernels import _cuda

    served = engine.model
    cfg = served.cfg
    batch, prompt = toks.shape
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = engine.generate_with_status_fixed({"tokens": toks})
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(res.tokens.shape == (batch, new), f"{name} tokens "
                                              f"{res.tokens.shape}")
    require(all(st == "ok" for st in res.status),
            f"{name} statuses {res.status}")
    missing = [key for key in PATH_KERNELS[name]
               if variant_launches(launches, key) <= 0]
    require(not missing, f"{name}: never launched {missing}: {launches}")
    require(peak < 80e9, f"{name}: peak {peak / 1e9:.2f} GB")
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = served.prefill(toks, prompt + new)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_dropped = [int((~k).sum()) for k in served.moe_kept]
    require(bool(torch.isfinite(logits).all())
            and logits.shape == (batch, cfg.padded_vocab()),
            f"{name} prefill logits")
    tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(new - 1):
        logits, cache = served.decode_step(cache, tok, prompt + i)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t) / (new - 1) * 1e3
    require(bool(torch.isfinite(logits).all()), f"{name} decode logits")
    _cuda.reset_launches()
    served.decode_step(cache, tok, prompt + new - 1)
    step_launches = decode_launches(name, dict(_cuda.LAUNCHES), cfg,
                                    served.int8)
    report = dict(
        **extra, batch=batch, prompt=prompt, new=new,
        ttft_ms=prefill_s * 1e3, decode_ms_per_step=dec_ms,
        generate_s=gen_s, tokens_per_s=batch * new / gen_s,
        statuses=list(res.status), launches=launches,
        launches_per_decode_step=step_launches, peak_gb=peak / 1e9,
        prefill_tokens_dropped_per_layer=prefill_dropped,
        distinct_tokens=[len(set(lane.tolist())) for lane in res.tokens],
        tokens=res.tokens.tolist())
    print(f"serve {name}: " + json.dumps(report), flush=True)
    return report


def moe_scheduler_runs(torch, model, reqs, geom, prefix, **extra):
    """The scheduler paths of an MoE model (phases 8 and 12), bf16 and then
    on the attention-only int8 copy (``wqkv`` and ``wo`` K2 with K3, the
    MoE shared): request 0 alone (also the warm-up), then ``reqs`` amid
    churn (``scheduler_run``, ``extra`` in its report), request 0's tokens
    bitwise the same (its entries sort first within every expert at any
    k, so no neighbour takes its capacity: ROADMAP F6)."""
    import gc
    from repro_torch.launch.serve import serve_requests
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    out = {}
    for int8 in (False, True):
        name = f"{prefix}_scheduler" + ("_int8" if int8 else "")
        t0 = time.perf_counter()
        eng = ServeEngine(model, ServeConfig(int8=int8, **geom))
        alone = serve_requests(eng, reqs[:1])["outputs"][0]
        torch.cuda.synchronize()
        out[name] = scheduler_run(
            torch, eng, reqs, name, int8=int8, **geom, **extra,
            alone_s=time.perf_counter() - t0,
            int8_copy_gb=sum(b.nbytes for blk in eng.model.blocks
                             for b in blk.attn.buffers()) / 1e9)
        require(alone.tokens.tolist() == out[name]["tokens0"],
                f"{name}: request 0 alone {alone.tokens.tolist()} != amid "
                f"churn {out[name]['tokens0']}")
        out[name]["alone_equals_churn"] = True
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_paligemma(torch):
    """Phase 9: full-width paligemma-3b (18 layers, d_model 2048, 8 q heads
    over 1 kv head of 256, d_ff 16384, vocab 257216; fp32 masters, the
    projections served from their bf16 copy), random weights from SEED,
    built after
    the models of the phases before it are gone.  Its input is 8 images'
    256 patch embeddings drawn N(0, 1) from SEED (the stubbed SigLIP
    tower, ``launch.serve.make_patches``) in front of 256 text tokens.  At
    the init scales the decode-vs-prefill witness over the prefix
    (``long_witness`` with the patches) and the int8 copy's first logits
    against the bf16 model's (``int8_witness``).  Then, on weights varied
    as in phase 3, ``generate_with_status`` (the engine falls through to
    the fixed loop: a prefix-LM is not pageable) with 32 greedy tokens,
    bf16 and int8, each with the launch counts set to 0 just before it:
    every status ok, no scheduler built, every kernel of
    ``PATH_KERNELS[<its name>]`` launched (K1 or K2 with K3 and its
    tails, K4 'global' and K5 at hd 256 and G = 8), one decode
    iteration's launches exact (``decode_launches``)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch.serve import make_patches
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(PG_ARCH)
    require((cfg.prefix_tokens, cfg.hd, cfg.n_heads, cfg.n_kv_heads,
             cfg.d_model, cfg.d_ff) == (PG_PREFIX, PG_HD, PG_H, PG_KV,
                                        PG_D, PG_FF), f"{cfg}")
    t0 = time.perf_counter()
    model = Model(cfg).init_weights(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    toks = torch.randint(0, cfg.vocab, (PG_BATCH, PG_TEXT),
                         generator=torch.Generator().manual_seed(SEED))
    patches = make_patches(cfg, PG_BATCH, SEED)
    out = {"paligemma_witness": long_witness(torch, model, toks, 16,
                                             patches=patches),
           "paligemma_int8_witness": int8_witness(torch, model, toks,
                                                  patches=patches)}
    print("paligemma witness: " + json.dumps(out), flush=True)
    vary(torch, model, SEED)
    batch = {"tokens": toks, "patches": patches}
    for int8 in (False, True):
        name = "paligemma_fixed_int8" if int8 else "paligemma_fixed"
        engine = ServeEngine(model, ServeConfig(max_new_tokens=PG_NEW,
                                                int8=int8))
        served = engine.model
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        res = engine.generate_with_status(batch)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        require(engine._sched is None and not engine._shim_cache,
                f"{name}: generate_with_status built a scheduler")
        require(res.tokens.shape == (PG_BATCH, PG_NEW),
                f"{name} tokens {res.tokens.shape}")
        require(all(st == "ok" for st in res.status),
                f"{name} statuses {res.status}")
        require(all(launches.get(key, 0) > 0 for key in PATH_KERNELS[name]),
                f"a kernel never launched on {name}: {launches}")
        # the prefill (the time to first token) and the decode step
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = served.prefill(toks, PG_S + PG_NEW, patches=patches)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        require(bool(torch.isfinite(logits).all())
                and logits.shape == (PG_BATCH, cfg.padded_vocab()),
                f"{name} prefill logits")
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(PG_NEW - 2):
            logits, cache = served.decode_step(cache, tok, PG_S + i)
            tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t) / (PG_NEW - 2) * 1e3
        require(bool(torch.isfinite(logits).all()), f"{name} decode logits")
        _cuda.reset_launches()
        served.decode_step(cache, tok, PG_S + PG_NEW - 2)
        step_launches = decode_launches(name, dict(_cuda.LAUNCHES), cfg,
                                        int8)
        require(step_launches.get("flash_decode:hd256") == cfg.n_layers,
                f"{name}: K5 hd 256 launches {step_launches}")
        report = dict(
            params=cfg.param_count(), init_s=init_s, weights_gb=weights_gb,
            batch=PG_BATCH, patches=PG_PREFIX, text=PG_TEXT, prompt=PG_S,
            new=PG_NEW, int8=int8, ttft_ms=prefill_s * 1e3,
            decode_ms_per_step=dec_ms, generate_s=gen_s,
            tokens_per_s=PG_BATCH * PG_NEW / gen_s,
            statuses=list(res.status), launches=launches,
            launches_per_decode_step=step_launches, peak_gb=peak / 1e9,
            distinct_tokens=[len(set(lane.tolist())) for lane in res.tokens],
            tokens=res.tokens[:, :16].tolist())
        print(f"serve {name}: " + json.dumps(report), flush=True)
        out[name] = report
        del engine, served, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_recurrentgemma_kernels(torch, timer):
    """Phase 2, recurrentgemma: K4 'local' at hd 256 with G = 16 (16 q
    heads over 1 kv head, window 2048) over the fixed loop's prefill, 2 x
    4160 (past the window), each row within 2 bf16 ulps of its scale,
    beside SDPA with the window as a bool mask.  K1 and K2 at its widths
    are ``check_kernels``' and ``check_int8_kernels``' rows."""
    from repro_torch.kernels import ops, ref

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    tol = 2 * eps_bf16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    bf = torch.bfloat16
    b, s, H, KV, hd, W = (RG_LONG_BATCH, RG_LONG_PROMPT, RG_H, RG_KV, RG_HD,
                          RG_WINDOW)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    q, k, v = rand(b, s, H, hd), rand(b, s, KV, hd), rand(b, s, KV, hd)
    var = dict(kind="local", window=W)
    got = ops.flash_attention(q, k, v, **var)
    want = ref.flash_attention_ref(q, k, v, **var)
    err, abs_err = row_err(got, want), max_err(got, want)
    del got, want
    require(err <= tol, f"K4 recurrentgemma: a row is off by {err:.3e} of "
                        f"its scale")
    pos = torch.arange(s, device="cuda")
    local = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    live = sum(min(i + 1, W) for i in range(s))
    t_b, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                    4 * b * H * hd * live)
    results = {"k4_flash_prefill_recurrentgemma": dict(
        work=f"local prefill window={W} B={b} S={s} H={H} KV={KV} hd={hd} "
             f"(G = {H // KV}; 64-slot K/V tiles)",
        max_abs_err=abs_err, max_row_err=err, tol=tol,
        ms=timer(lambda: ops.flash_attention(q, k, v, **var), reps=3),
        wrapper_ms=timer.wall(lambda: ops.flash_attention(q, k, v, **var),
                              reps=3),
        plain_ms=timer(lambda: ref.flash_attention_ref(q, k, v, **var),
                       reps=3),
        bound_ms=t_b, bound_by=by,
        library_ms=sdpa_ms(torch, timer, q, k, v, attn_mask=local),
        library_note="SDPA with the local window as a bool mask (sdpa_ms)")}
    print("  k4 " + json.dumps(results), flush=True)
    del q, k, v, local
    torch.cuda.empty_cache()
    return results


def rglru_rows(torch, timer):
    """The RG-LRU mixer's plain-torch parts at full width (no kernel of the
    reference's: library products and elementwise launches), device ms
    beside the least time their bytes or operations take: the scan over
    the long prefill's [2, 4160, 4096] (reads a and b, writes h), the fp32
    gate products (``w_a``, ``w_i``: 4096 x 4096 each, TF32 off) at the
    prefill's 8320 rows and the decode's 8, and one mixer call
    (``rglru_apply``: projections, conv, gates, scan or step, output gate)
    at each shape."""
    from repro_torch.configs import get_config
    from repro_torch.models import rglru

    cfg = get_config(RG_ARCH)
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    w = cfg.lru_width
    mix = rglru.RGLRU(cfg, bf, torch.device("cuda"))
    with torch.no_grad():
        for name, p in mix.named_parameters():
            if name == "lam":
                p.copy_(rglru.lru_log_init(p.shape, gen, p.device))
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * p.shape[-2] ** -0.5)
    b, s = RG_LONG_BATCH, RG_LONG_PROMPT
    a = torch.rand((b, s, w), generator=gen, device="cuda")
    bb = torch.randn((b, s, w), generator=gen, device="cuda")
    t_b, by = bound(3 * a.numel() * 4, 0)
    out = {}
    out["scan"] = dict(shape=f"[{b}, {s}, {w}] fp32",
                       ms=timer(lambda: rglru.linear_scan(a, bb), reps=3),
                       bound_ms=t_b, bound_by=by)
    del a, bb
    for m in (b * s, RG_BATCH):
        xc = torch.randn((1, m, w), generator=gen, device="cuda")
        nbytes = 2 * w * w * 4 + m * w * 4 * 3
        t_b, by = bound(nbytes, 2 * 2 * m * w * w, FP32_FLOPS_PER_S)
        out[f"gates_m{m}"] = dict(
            shape=f"2 x [{m}, {w}] @ [{w}, {w}] fp32",
            ms=timer(lambda xc=xc: rglru.gates(mix, xc), reps=3),
            bound_ms=t_b, bound_by=by)
    for name, rows, m, decode in (("mixer_prefill", b, s, False),
                                  ("mixer_decode", RG_BATCH, 1, True)):
        x = torch.randn((rows, m, cfg.d_model), generator=gen,
                        device="cuda").to(bf)
        cache = rglru.rglru_cache(cfg, rows, bf, torch.device("cuda"))
        # the weights once and x in, y out; the bf16 projections' and the
        # fp32 gates' operations each at their type's peak
        nbytes = (3 * cfg.d_model * w * 2 + 2 * w * w * 4
                  + 2 * rows * m * cfg.d_model * 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (2 * rows * m * 3 * cfg.d_model * w / BF16_FLOPS_PER_S
                 + 2 * rows * m * 2 * w * w / FP32_FLOPS_PER_S) * 1e3
        out[name] = dict(
            shape=f"x [{rows}, {m}, {cfg.d_model}] bf16",
            ms=timer(lambda x=x, cache=cache, decode=decode:
                     rglru.rglru_apply(mix, x, cfg, bf, cache, decode),
                     reps=3),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
    print("  rglru plain " + json.dumps(out), flush=True)
    del mix
    torch.cuda.empty_cache()
    return out


def serve_recurrentgemma(torch, rglru_plain):
    """Phase 10: recurrentgemma-9b at full width and all 38 layers (26
    RG-LRU blocks, 12 local-attention blocks of 16 q heads over 1 kv head
    of 256, window 2048; d_model 4096, d_ff 12288, vocab 256000; bf16
    weights, the mixers' decays at fp32: 18.8 GB, and the served copy's
    gates widened to fp32 once, 3.5 GB), random
    weights from SEED, built after the models of the phases before it are
    gone.  At the init scales three witnesses: the fixed loop's decode
    step at position 4174 after a prefill of 2 x 4160 (the ring wrapped,
    each mixer's state advanced 15 times) against a prefill of the same
    4175 tokens, the mixers' state carried (a prefill of 8 x 512, one
    decode step, against a prefill of 513: ``long_witness`` with 2), and
    the int8 copy's first logits against the bf16 model's on 8 x 512
    (``int8_witness``).  Then, on weights varied as in phase 3 (the
    mixers kept at their init), ``generate_with_status`` (the engine
    falls through to the fixed loop: an RG-LRU state has no pages) bf16
    and int8, each on 2 x 4160
    with 16 new tokens and on 8 x 512 with 32, the launch counts set to 0
    just before the two: every status ok, no scheduler built, every
    kernel of ``PATH_KERNELS[<its name>]`` launched (K1 or K2 with K3 and
    its tails, K4 'local' at hd 256 and G = 16), one decode iteration's
    launches exact (``decode_launches``; its GEMMs three a layer and two
    a local layer, no K5).  The prefill (time to first token) and the
    decode step are timed at both shapes."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(RG_ARCH)
    n_local = sum(cfg.kind(i) == "local" for i in range(cfg.n_layers))
    require((cfg.n_layers, n_local, cfg.hd, cfg.n_heads, cfg.n_kv_heads,
             cfg.window, cfg.d_model, cfg.d_ff)
            == (38, 12, RG_HD, RG_H, RG_KV, RG_WINDOW, RG_D, RG_FF), f"{cfg}")
    t0 = time.perf_counter()
    model = Model(cfg).init_weights(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    shapes = {"long": (RG_LONG_BATCH, RG_LONG_PROMPT, RG_LONG_NEW),
              "batch8": (RG_BATCH, RG_PROMPT, RG_NEW)}
    toks = {key: torch.randint(0, cfg.vocab, (b, s), generator=(
        torch.Generator().manual_seed(SEED + i)))
        for i, (key, (b, s, _)) in enumerate(shapes.items())}
    out = {"recurrentgemma_witness": long_witness(
        torch, model, toks["long"], RG_LONG_NEW),
        "recurrentgemma_state_witness": long_witness(
            torch, model, toks["batch8"], 2),
        "recurrentgemma_int8_witness": int8_witness(torch, model,
                                                    toks["batch8"])}
    print("recurrentgemma witness: " + json.dumps(out), flush=True)
    vary(torch, model, SEED)
    for int8 in (False, True):
        name = ("recurrentgemma_fixed_int8" if int8
                else "recurrentgemma_fixed")
        t0 = time.perf_counter()
        served = model.quantize_params_for_serving() if int8 else model
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        runs = {}
        for key, (b, s, new) in shapes.items():
            # the int8 copy is served as it is (the quantize is idempotent)
            engine = ServeEngine(served, ServeConfig(max_new_tokens=new,
                                                     int8=int8))
            t = time.perf_counter()
            res = engine.generate_with_status({"tokens": toks[key]})
            torch.cuda.synchronize()
            runs[key] = (res, time.perf_counter() - t)
            require(engine._sched is None and not engine._shim_cache,
                    f"{name}: generate_with_status built a scheduler")
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        missing = [key for key in PATH_KERNELS[name]
                   if variant_launches(launches, key) <= 0]
        require(not missing, f"{name}: never launched {missing}: "
                             f"{launches}")
        report = dict(params=cfg.param_count(), init_s=init_s,
                      weights_gb=weights_gb, int8=int8, build_s=build_s,
                      launches=launches, peak_gb=peak / 1e9)
        for key, (b, s, new) in shapes.items():
            res, gen_s = runs[key]
            require(res.tokens.shape == (b, new),
                    f"{name} {key} tokens {res.tokens.shape}")
            require(all(st == "ok" for st in res.status),
                    f"{name} {key} statuses {res.status}")
            # the prefill (the time to first token) and the decode step
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = served.prefill(toks[key], s + new)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
            require(bool(torch.isfinite(logits).all())
                    and logits.shape == (b, cfg.padded_vocab()),
                    f"{name} {key} prefill logits")
            tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(new - 2):
                logits, cache = served.decode_step(cache, tok, s + i)
                tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t) / (new - 2) * 1e3
            require(bool(torch.isfinite(logits).all()),
                    f"{name} {key} decode logits")
            _cuda.reset_launches()
            served.decode_step(cache, tok, s + new - 2)
            step = decode_launches(name, dict(_cuda.LAUNCHES), cfg, int8)
            gemm = "int8_matmul" if int8 else "matmul"
            want = {gemm: 3 * cfg.n_layers + 2 * n_local, "flash_decode": 0}
            got = {k_: step.get(k_, 0) for k_ in want}
            require(got == want, f"{name}: a decode iteration's GEMMs and "
                                 f"K5 {got}, want {want}")
            report[key] = dict(
                batch=b, prompt=s, new=new, ttft_ms=prefill_s * 1e3,
                decode_ms_per_step=dec_ms, generate_s=gen_s,
                tokens_per_s=b * new / gen_s, statuses=list(res.status),
                launches_per_decode_step=step,
                distinct_tokens=[len(set(lane.tolist()))
                                 for lane in res.tokens],
                tokens=res.tokens[:, :16].tolist())
            del cache, logits
        print(f"serve {name}: " + json.dumps(report), flush=True)
        out[name] = report
        del engine, served
        gc.collect()
        torch.cuda.empty_cache()
    out["recurrentgemma_plain"] = rglru_plain
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_xlstm_kernels(torch, timer, cupti):
    """Phase 2, xlstm: the row-norm kernel at both widths the xlstm path
    gives it: N = 1024 (the entry norm, each next norm and the sLSTM's
    inner norm: 28 of a decode step's 49 launches, and every stream norm
    of the prefill) and N = 2048 (the mLSTM's inner norm, a width no
    earlier model gives it).  At each width, bitwise its ordered mirror
    (``ref.rmsnorm_rows_ref``) and within one bf16 ulp of each row's scale
    of ``rms_normalize``, at decode's 8 rows and the 8 x 2048 prefill's
    16384; timed at both beside its plain version and ``F.rms_norm`` (one
    PyTorch call of the same function, its weight the rounded ``1 +
    scale``).  The CUPTI times go to ``cupti``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.epilogue import rms_normalize

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    bf = torch.bfloat16
    out = {}
    for n, what in ((XL_D, "the stream's norms and the sLSTM's inner norm"),
                    (XL_W, "the mLSTM's inner norm")):
        nscale = torch.randn(n, generator=gen, device="cuda") * 0.1
        w1 = (1.0 + nscale).to(bf)
        errs, abs_errs, at = [], [], {}
        for m in (XL_BATCH, XL_BATCH * XL_PROMPT):
            x = torch.randn((m, n), generator=gen, device="cuda").to(bf)
            got = ops.rmsnorm(x, nscale)
            require(torch.equal(got, ref.rmsnorm_rows_ref(x, nscale, 1e-6)),
                    f"rmsnorm [{m}, {n}] is not bitwise its ordered mirror")
            want = rms_normalize(x, nscale, 1e-6)
            errs.append(row_err(got, want))
            abs_errs.append(max_err(got, want))
            # the CUPTI pass calls these after the loop: bind this width's
            at[m] = row_timing(
                timer, cupti, lambda x=x, s=nscale: ops.rmsnorm(x, s),
                lambda x=x, s=nscale: rms_normalize(x, s, 1e-6),
                2 * 2 * x.numel() + 4 * n,
                (lambda x=x, w=w1: F.rms_norm(x, (x.shape[-1],), w, 1e-6))
                if hasattr(F, "rms_norm") else None)
        err = max(errs)
        require(err <= eps_bf16,
                f"rmsnorm N={n}: a row is off by {err:.3e}")
        row = dict(
            work=f"rmsnorm rows [{XL_BATCH}, {n}] bf16, {what} at decode, "
                 f"one warp a row (bitwise its ordered mirror, also at "
                 f"[{XL_BATCH * XL_PROMPT}, {n}], the 8 x 2048 prefill, "
                 f"which 'rows' also times)",
            max_abs_err=max(abs_errs), max_row_err=err, tol=eps_bf16,
            **at[XL_BATCH], rows={str(m): v for m, v in at.items()})
        also_into(cupti, at[XL_BATCH], row)
        print(f"  xlstm rmsnorm N={n} " + json.dumps(row), flush=True)
        out[f"k1_rmsnorm_xlstm_n{n}"] = row
    return out


def xlstm_rows(torch, timer, cupti):
    """The xLSTM mixers' plain-torch parts at full width (no kernel of the
    reference's: library products and elementwise launches), their time
    beside the least time their bytes or operations take: ``kernel_ms``
    (CUPTI, from the ``cupti`` pass) is the device time, ``wall_ms`` the
    host's (which sets the time of these loops), ``ms`` the event timer's
    (behind its spin, which covers the host only up to CUDA's queue of
    about a thousand launches: an sLSTM prefill's 40 thousand run at the
    host's rate, so there ``ms`` is not a device time); the mLSTM's chunk loop
    alone over [8, 2048] (32 chunks of 64, 4 heads of 512: its fp32
    products at the fp32 peak), one mLSTM call (``mlstm_apply``) and one
    sLSTM call (``slstm_apply``: the fp32 input map, the token loop over
    2048 positions, the output) at the 8 x 2048 prefill and at a decode
    step of 8 rows.  A call's bound: its weights and activations in and
    out once (the state too at decode), or its bf16 products at the bf16
    peak plus its fp32 products at the fp32 peak, the larger."""
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    from repro_torch.models.layers import full_fp32

    cfg = get_config(XL_ARCH)
    bf, f32, dev = torch.bfloat16, torch.float32, torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    d, w, nh = cfg.d_model, XL_W, cfg.n_heads
    hd, L = w // nh, xlstm.CHUNK
    b, s = XL_BATCH, XL_PROMPT
    mixers = {"mlstm": xlstm.MLSTM(cfg, bf, dev),
              "slstm": xlstm.SLSTM(cfg, bf, dev)}
    with torch.no_grad():
        for mix in mixers.values():
            for name, p in mix.named_parameters():
                if name == "b_f":
                    p.copy_(torch.linspace(3.0, 6.0, p.shape[0]))
                elif p.dim() == 1:
                    p.zero_()
                else:
                    scale = 0.05 if name == "r" else p.shape[-2] ** -0.5
                    p.copy_(torch.randn(p.shape, generator=gen,
                                        device="cuda") * scale)

    def rand(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = {}
    # a loop's device time is stable over a few calls, and each traced call
    # of the sLSTM's prefill holds 40 thousand kernels
    traced = dict(skip="bitwise_not", reps=2)
    # the chunk loop alone
    q, k, v = (rand(b, s, nh, hd, dtype=bf) for _ in range(3))
    logi = rand(b, s, nh)
    logf = xlstm.log_sigmoid(3.0 + rand(b, s, nh))

    def chunks():
        with full_fp32():
            carry = (torch.zeros((b, nh, hd, hd), device=dev),
                     torch.zeros((b, nh, hd), device=dev),
                     torch.zeros((b, nh), device=dev))
            for t in range(0, s, L):
                sl = slice(t, t + L)
                carry, _ = xlstm.mlstm_chunk(carry, q[:, sl], k[:, sl],
                                             v[:, sl], logf[:, sl],
                                             logi[:, sl])
    # per chunk and (lane, head): q k^T, the scores' and the weights'
    # products with v and k (L x L x hd each), q C and the C update
    # (L x hd x hd each)
    chunk_flops = b * nh * (s // L) * (3 * 2 * L * L * hd + 2 * 2 * L * hd * hd)
    t_b, by = bound(3 * q.numel() * 2 + b * s * w * 4 + 2 * logi.numel() * 4,
                    chunk_flops, FP32_FLOPS_PER_S)
    out["mlstm_chunk_loop"] = dict(
        shape=f"q/k/v [{b}, {s}, {nh}, {hd}] bf16, chunks of {L}",
        ms=timer(chunks, reps=2), wall_ms=timer.wall(chunks, reps=2),
        bound_ms=t_b, bound_by=by, fp32_gflop=chunk_flops / 1e9)
    cupti.append(([out["mlstm_chunk_loop"]], "kernel_ms", chunks, traced))

    def state_bytes(kind, rows):
        cache = (xlstm.mlstm_cache(cfg, rows, bf, dev) if kind == "mlstm"
                 else xlstm.slstm_cache(cfg, rows, dev))
        return cache, sum(t.nbytes for t in cache.values())

    for kind, rows, m, decode in (("mlstm", b, s, False),
                                  ("mlstm", b, 1, True),
                                  ("slstm", b, s, False),
                                  ("slstm", b, 1, True)):
        mix = mixers[kind]
        apply = xlstm.mlstm_apply if kind == "mlstm" else xlstm.slstm_apply
        x = rand(rows, m, d, dtype=bf)
        cache, st_bytes = state_bytes(kind, rows)
        tokens = rows * m
        weights = sum(p.nbytes for p in mix.parameters())
        # weights and x in, y out, the state out (and in at decode)
        nbytes = weights + 2 * tokens * d * 2 + st_bytes * (2 if decode else 1)
        if kind == "mlstm":
            bf16_flops = 2 * tokens * (2 * d * w + 3 * w * w + w * d)
            fp32_flops = 2 * tokens * w * 2 * nh + (
                2 * 2 * rows * nh * hd * hd if decode
                else chunk_flops * rows // b)
        else:
            bf16_flops = 2 * tokens * d * d
            fp32_flops = 2 * tokens * d * 4 * d + 2 * tokens * 4 * d * d // nh
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (bf16_flops / BF16_FLOPS_PER_S
                 + fp32_flops / FP32_FLOPS_PER_S) * 1e3

        def call(x=x, cache=cache, apply=apply, mix=mix, decode=decode):
            apply(mix, x, cfg, bf, cache, decode)
        reps = 3 if decode else 1
        row = out[f"{kind}_{'decode' if decode else 'prefill'}"] = dict(
            shape=f"x [{rows}, {m}, {d}] bf16",
            ms=timer(call, reps=reps), wall_ms=timer.wall(call, reps=reps),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        cupti.append(([row], "kernel_ms", call, traced))
    print("  xlstm plain " + json.dumps(out), flush=True)
    return out


def xlstm_witness(torch, model, toks):
    """Teacher-forced decode against prefill: a prefill of all but the
    last XL_WIT_STEPS tokens of ``toks``, then a decode step fed each of
    them, against the last logits of a prefill of ``toks`` (its length a
    multiple of 64, ROADMAP F10) and of ``toks`` with its last token
    changed.  Returns each lane's worst distance over its logit scale, and
    the decode's and the prefill's last logits."""
    cfg = model.cfg
    s = toks.shape[1] - XL_WIT_STEPS
    logits, cache = model.prefill(toks[:, :s], toks.shape[1])
    for i in range(XL_WIT_STEPS):
        logits, cache = model.decode_step(cache, toks[:, s + i:s + i + 1],
                                          s + i)
    del cache
    want, _ = model.prefill(toks)
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % cfg.vocab
    off, _ = model.prefill(other)
    return (dict(layers=cfg.n_layers, position=toks.shape[1] - 1,
                 err=rel_rows(logits, want),
                 other_token=rel_rows(logits, off)), logits, want)


def plain_norms_at_fp32(torch):
    """A context in which the row norms of an fp32-compute model on the
    card run their plain version (``rms_normalize``): the row-norm kernel
    takes bf16 rows only, and an fp32 row would make it raise.  Only the
    fp32 witness runs in it; a bf16 row there fails the script."""
    import contextlib
    from repro_torch.kernels import ops
    from repro_torch.kernels.epilogue import rms_normalize

    def plain(x, scale, eps):
        require(x.dtype == torch.float32,
                f"a {x.dtype} row norm in the fp32 witness")
        return rms_normalize(x, scale, eps)

    @contextlib.contextmanager
    def swapped():
        kernel, ops.rmsnorm_cuda = ops.rmsnorm_cuda, plain
        try:
            yield
        finally:
            ops.rmsnorm_cuda = kernel
    return swapped()


def serve_xlstm(torch, xlstm_plain):
    """Phase 11: xlstm-350m at full width and all 24 layers (21 mLSTM
    blocks, width 2048 in 4 heads of 512, and 3 sLSTM blocks of 4 heads of
    256; d_model 1024, vocab 50304, no FFN; every weight an fp32 master,
    1.87 GB, the projections and convs served from their 0.80 GB bf16
    copy),
    random weights from SEED, built after the models of the phases before
    it are gone.  At the init scales the decode-vs-prefill witness
    (``xlstm_witness``): a prefill of 8 x 2048, 64 decode steps fed the
    next tokens (each mixer's state advanced from the chunkwise form's by
    the step), against a prefill of the 2112 tokens; on one period of the
    pattern (the first 8 layers) within WITNESS_TOL, and the same
    witness at fp32 compute on the same weights (its row norms their
    plain version, which ``plain_norms_at_fp32`` lets stand in: the
    kernel takes bf16 only) within XL_WITNESS_TOL32, a changed last token
    farther than 4x WITNESS_TOL.  At all 24 layers the fp32 witness
    XL_PRECISION_GAIN below the bf16 one, and the bf16 decode's distance
    from the fp32 prefill within 4x the bf16 prefill's own (ROADMAP's
    consistency-budget rule), a changed token farther than 4x each
    decode's distance from its prefill.  Then, on weights varied as in
    phase 3,
    ``generate_with_status`` (the engine falls through to the fixed loop:
    a recurrent state has no pages) bf16 on 8 x 2048 with 32 new tokens
    and on 2 x 8192 with 16, and the int8 copy (it quantizes nothing:
    every weight is a mixer's) on 8 x 2048, its tokens bitwise the bf16
    run's; the launch counts set to 0 just before each path: every status
    ok, no scheduler built, the row-norm kernel launched, one decode
    iteration's launches exact (``decode_launches``: 49 row norms and
    nothing else).  The prefill (the time to first token) and the decode
    step are timed at each shape, and the peak printed (above what the
    phases before left allocated, ``base_gb``)."""
    import dataclasses
    import gc
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # what the phases before left allocated (phase 2's plain rows keep
    # their inputs for the CUPTI pass): the peaks below are above it
    base = torch.cuda.memory_allocated()
    cfg = get_config(XL_ARCH)
    kinds = [cfg.kind(i) for i in range(cfg.n_layers)]
    require((cfg.n_layers, kinds.count("mlstm"), kinds.count("slstm"),
             cfg.d_model, cfg.n_heads, cfg.d_ff)
            == (24, 21, 3, XL_D, XL_H, 0), f"{cfg}")
    shapes = {"batch8": (XL_BATCH, XL_PROMPT, XL_NEW),
              "long": (XL_LONG_BATCH, XL_LONG_PROMPT, XL_LONG_NEW)}
    toks = {key: torch.randint(0, cfg.vocab, (b, s), generator=(
        torch.Generator().manual_seed(SEED + i)))
        for i, (key, (b, s, _)) in enumerate(shapes.items())}
    wit_toks = torch.randint(0, cfg.vocab,
                             (XL_BATCH, XL_PROMPT + XL_WIT_STEPS),
                             generator=torch.Generator().manual_seed(SEED + 2))
    t0 = time.perf_counter()
    def at_fp32(model):
        """The witness of ``model``'s weights at fp32 compute, and its
        prefill's last logits."""
        m32 = Model(dataclasses.replace(model.cfg, compute_dtype="float32"))
        m32.load_state_dict(model.state_dict())
        with plain_norms_at_fp32(torch):
            w, _, pre = xlstm_witness(torch, m32, wit_toks)
        del m32
        torch.cuda.empty_cache()
        return w, pre

    period = Model(dataclasses.replace(cfg, n_layers=XL_WIT_LAYERS)
                   ).init_weights(SEED)
    w8, _, _ = xlstm_witness(torch, period, wit_toks)
    w8_32, _ = at_fp32(period)
    del period
    torch.cuda.empty_cache()
    model = Model(cfg).init_weights(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.nbytes for p in model.parameters()) / 1e9
    w24, dec16, pre16 = xlstm_witness(torch, model, wit_toks)
    w32, pre32 = at_fp32(model)
    w24.update(decode_from_fp32=rel_rows(dec16, pre32),
               prefill_from_fp32=rel_rows(pre16, pre32))
    out = {"xlstm_witness": dict(
        period=dict(w8, tol=WITNESS_TOL),
        period_fp32=dict(w8_32, tol=XL_WITNESS_TOL32),
        full=w24, full_fp32=dict(w32, precision_gain=XL_PRECISION_GAIN),
        seconds=time.perf_counter() - t0)}
    print("xlstm witness: " + json.dumps(out), flush=True)
    for w, tol, what in ((w8, WITNESS_TOL, "bf16"),
                         (w8_32, XL_WITNESS_TOL32, "fp32")):
        require(w["err"] <= tol,
                f"xlstm ({XL_WIT_LAYERS} layers, {what}) decode is off its "
                f"prefill by {w['err']:.3e} of the logit scale")
        require(w["other_token"] > 4 * WITNESS_TOL,
                f"the xlstm witness cannot tell a changed token apart: {w}")
    # all 24 layers: rounding noise shrinks with the stream's precision, a
    # fault in the decode step or the chunkwise form does not
    require(w32["err"] * XL_PRECISION_GAIN <= w24["err"],
            f"xlstm's decode at fp32 is off its prefill by {w32['err']:.3e} "
            f"of the logit scale, not {XL_PRECISION_GAIN}x below bf16's "
            f"{w24['err']:.3e}")
    # the bf16 decode's distance from the fp32 prefill within 4x the bf16
    # prefill's own (ROADMAP's consistency-budget rule)
    require(w24["decode_from_fp32"] <= 4 * w24["prefill_from_fp32"],
            f"xlstm's bf16 decode is off the fp32 prefill by more than 4x "
            f"the bf16 prefill's own distance: {w24}")
    for w in (w24, w32):
        require(w["other_token"] > 4 * w["err"],
                f"the xlstm witness cannot tell a changed token apart: {w}")
    print("xlstm witness: " + json.dumps(out), flush=True)
    vary(torch, model, SEED)
    bf16_tokens = None
    for int8 in (False, True):
        name = "xlstm_fixed_int8" if int8 else "xlstm_fixed"
        served = model.quantize_params_for_serving() if int8 else model
        runs_at = {"batch8": shapes["batch8"]} if int8 else shapes
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        runs = {}
        for key, (b, s, new) in runs_at.items():
            # the int8 copy is served as it is (the quantize is idempotent)
            engine = ServeEngine(served, ServeConfig(max_new_tokens=new,
                                                     int8=int8))
            t = time.perf_counter()
            res = engine.generate_with_status({"tokens": toks[key]})
            torch.cuda.synchronize()
            runs[key] = (res, time.perf_counter() - t)
            require(engine._sched is None and not engine._shim_cache,
                    f"{name}: generate_with_status built a scheduler")
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        missing = [key for key in PATH_KERNELS[name]
                   if variant_launches(launches, key) <= 0]
        require(not missing, f"{name}: never launched {missing}: "
                             f"{launches}")
        report = dict(params=cfg.param_count(),
                      params_held=sum(p.numel() for p in model.parameters()),
                      init_s=init_s, weights_gb=weights_gb, int8=int8,
                      launches=launches, peak_gb=(peak - base) / 1e9,
                      base_gb=base / 1e9)
        for key, (b, s, new) in runs_at.items():
            res, gen_s = runs[key]
            require(res.tokens.shape == (b, new),
                    f"{name} {key} tokens {res.tokens.shape}")
            require(all(st == "ok" for st in res.status),
                    f"{name} {key} statuses {res.status}")
            if key == "batch8":
                if int8:
                    require(np.array_equal(res.tokens, bf16_tokens),
                            f"{name}: the int8 copy's tokens "
                            f"{res.tokens.tolist()} are not the bf16 "
                            f"run's {bf16_tokens.tolist()}")
                else:
                    bf16_tokens = res.tokens
            # the prefill (the time to first token) and the decode step
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = served.prefill(toks[key], s + new)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
            require(bool(torch.isfinite(logits).all())
                    and logits.shape == (b, cfg.padded_vocab()),
                    f"{name} {key} prefill logits")
            tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(new - 2):
                logits, cache = served.decode_step(cache, tok, s + i)
                tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t) / (new - 2) * 1e3
            require(bool(torch.isfinite(logits).all()),
                    f"{name} {key} decode logits")
            _cuda.reset_launches()
            served.decode_step(cache, tok, s + new - 2)
            step = decode_launches(name, dict(_cuda.LAUNCHES), cfg)
            report[key] = dict(
                batch=b, prompt=s, new=new, ttft_ms=prefill_s * 1e3,
                decode_ms_per_step=dec_ms, generate_s=gen_s,
                tokens_per_s=b * new / gen_s, statuses=list(res.status),
                launches_per_decode_step=step,
                distinct_tokens=[len(set(lane.tolist()))
                                 for lane in res.tokens],
                tokens=res.tokens[:, :16].tolist())
            del cache, logits
        print(f"serve {name}: " + json.dumps(report), flush=True)
        out[name] = report
        del engine, served
        gc.collect()
        torch.cuda.empty_cache()
    out["xlstm_plain"] = xlstm_plain
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# sampled picks and the robustness layer (fault plans, retry, checkpoints)
# ---------------------------------------------------------------------------

# the sampler row's shapes: the scheduler's lanes at granite's vocab and
# at gemma3's
def check_grok_kernels(torch, timer, cupti):
    """Phase 2, grok-1: the kernels at the shapes its driven paths give
    them, G = 6 (48 q heads over 8 of 128) new to K4-K6's tiling.  K4
    global over the fixed loop's 2 x 4160 prefill (its plain version a kv
    head at a time) beside SDPA causal; K5 at the fixed loop's decode (a
    4176-slot cache, ``k5_row``: bitwise across split counts, partials
    within 1e-5) beside SDPA; K6 at the scheduler's geometry (8 lanes, 262
    pages of 16 a lane, one lane idle): decode within 2 bf16 ulps with its
    partials within 1e-5, every lane bitwise K5 over its history, and the
    S = 64 chunk body (q tiles of 21, 21, 21 and 1 positions x 6 heads)
    with ``chunk_contracts``; K1 at its two projections, the packed qkv
    [6144, 8192] and wo [6144, 6144], at M = 8, 512 and 8320 beside
    ``torch.matmul``; the row norm at N = 6144 (``ln2`` and the norm after
    the MoE, standalone) bitwise its ordered mirror at 8 and 8320 rows
    beside ``F.rms_norm``; on the int8 copy's ``wqkv`` and ``wo`` at M =
    8, K3 bitwise its plain version and K2 (fp32 out bitwise, bf16 within
    one ulp) beside ``torch._int_mm``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.epilogue import Epilogue, rms_normalize
    from repro_torch.kernels.flash_attention import (
        chunk_tiles, head_groups, paged_decode_launch,
        paged_flash_decode_tiled, paged_tile_partials)
    from repro_torch.kernels.quantize import quantize_weight_colwise

    eps_bf16 = float(torch.finfo(torch.bfloat16).eps)
    tol = 2 * eps_bf16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    bf = torch.bfloat16
    H, KV, hd, D = GK_H, GK_KV, GK_HD, GK_D
    G = H // KV
    require(head_groups(G) == (1, G) and chunk_tiles(CHUNK, G) == (21, 4),
            f"G = {G}: head_groups {head_groups(G)}, chunk_tiles "
            f"{chunk_tiles(CHUNK, G)}")

    def rand(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    results = {}
    # K4 global at the fixed loop's prefill
    b, s = GK_BATCH, GK_PROMPT
    q, k, v = rand(b, s, H, hd), rand(b, s, KV, hd), rand(b, s, KV, hd)
    got = ops.flash_attention(q, k, v)
    want = by_kv_head(torch, q, k, v)
    err, abs_err = row_err(got, want), max_err(got, want)
    del got, want
    require(err <= tol, f"K4 grok: a row is off by {err:.3e} of its scale")
    t_b, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                    4 * b * H * hd * s * (s + 1) / 2)
    results["k4_flash_prefill_grok"] = dict(
        work=f"global prefill B={b} S={s} H={H} KV={KV} hd={hd} (G = {G}; "
             f"the plain version a kv head at a time)",
        max_abs_err=abs_err, max_row_err=err, tol=tol,
        ms=timer(lambda: ops.flash_attention(q, k, v), reps=3),
        wrapper_ms=timer.wall(lambda: ops.flash_attention(q, k, v), reps=3),
        plain_ms=timer(lambda: by_kv_head(torch, q, k, v), reps=1),
        bound_ms=t_b, bound_by=by,
        library_ms=sdpa_ms(torch, timer, q, k, v, is_causal=True),
        library_note="SDPA causal (sdpa_ms)")
    print("  k4 grok " + json.dumps(results["k4_flash_prefill_grok"]),
          flush=True)
    del q, k, v
    torch.cuda.empty_cache()

    # K5 at the fixed loop's decode, its cache at the last step
    results["k5_flash_decode_grok"] = k5_row(
        torch, timer, rand, b, GK_PROMPT + GK_NEW, GK_PROMPT + GK_NEW - 2,
        KV, G, hd, None, 1.0, "grok-1's fixed loop (G = 6)")

    # K6 at the scheduler's geometry, decode and chunk
    L, ps, P = LANES, PAGE, GK_PAGES
    n_pages = L * P
    kp, vp = rand(n_pages + 1, ps, KV, hd), rand(n_pages + 1, ps, KV, hd)
    lane_pos = torch.tensor([0, 31, 100, 1023, 2100, 4160, 4191, -1],
                            dtype=torch.int32)
    table = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        SEED)).reshape(L, P).to(torch.int32)
    for lane in range(L):
        table[lane, max(int(lane_pos[lane]), 0) // ps + 1:] = -1
    table = table.cuda()
    posd = lane_pos.cuda()[:, None].contiguous()
    q = rand(L, 1, KV, G, hd)
    rows, n_tiles = L * KV, P * ps // 32
    got = ops.paged_flash_decode(q, kp, vp, table, posd)
    require(bool((got[L - 1] == 0).all()), "K6 grok: the idle lane is not "
                                           "0.0")
    want = paged_flash_decode_tiled(q, kp, vp, table, posd)
    dec_err, dec_abs = row_err(got, want), max_err(got, want)
    out, ws = paged_decode_launch(q, kp, vp, table, posd)
    require(torch.equal(out, got), "K6 grok: two launches differ")
    p_err = record_err(torch, ws, paged_tile_partials(q, kp, vp, table,
                                                      posd),
                       rows, n_tiles, G, hd)
    del out, ws, want
    lanes_equal_k5(torch, got, q, kp, vp, table, lane_pos, "K6 grok")
    qc = rand(L, CHUNK, KV, G, hd)
    pc = lane_pos.clamp(min=0)[:, None] - CHUNK + 1 + torch.arange(CHUNK)[
        None]
    pc = torch.where((pc >= 0) & (lane_pos[:, None] >= 0), pc, -1)
    pc[2, -7:] = -1      # a final chunk's padded tail
    pc = pc.to(torch.int32).cuda().contiguous()
    chunk = chunk_contracts(torch, qc, kp, vp, table, pc, 5)
    chunk_want = paged_flash_decode_tiled(qc, kp, vp, table, pc)
    chunk_err, chunk_abs = row_err(chunk, chunk_want), max_err(chunk,
                                                               chunk_want)
    del chunk, chunk_want
    require(p_err <= 1e-5 and max(dec_err, chunk_err) <= tol,
            f"K6 grok: decode {dec_err:.3e} (partials {p_err:.3e}), chunk "
            f"{chunk_err:.3e}")
    where = (f"L={L} KV={KV} G={G} hd={hd} page_size={ps} P={P} "
             f"({n_tiles} tiles), positions {lane_pos.tolist()}")
    lib_note = "no one PyTorch call attends through a page table"
    dec = dict(
        work=f"paged decode global {where}; the idle lane 0.0, each lane "
             f"bitwise K5",
        max_abs_err=dec_abs, max_row_err=dec_err, tol=tol,
        partials_row_err=p_err, partials_tol=1e-5,
        ms=timer(lambda: ops.paged_flash_decode(q, kp, vp, table, posd)),
        wrapper_ms=timer.wall(lambda: ops.paged_flash_decode(
            q, kp, vp, table, posd)),
        plain_ms=timer(lambda: paged_flash_decode_tiled(
            q, kp, vp, table, posd), reps=3),
        library_ms=None, library_note=lib_note)
    dec["bound_ms"], dec["bound_by"] = k6_bound(q, table, posd, KV, 0)
    chk = dict(
        work=f"paged prefill chunk S={CHUNK} global {where}, each lane's "
             f"chunk ending at its position (a padded tail), q tiles of "
             f"21, 21, 21 and 1 positions x 6 heads; deterministic, idle "
             f"rows 0.0, a lane unmoved by its neighbours",
        max_abs_err=chunk_abs, max_row_err=chunk_err, tol=tol,
        ms=timer(lambda: ops.paged_flash_decode(qc, kp, vp, table, pc),
                 reps=3),
        wrapper_ms=timer.wall(lambda: ops.paged_flash_decode(
            qc, kp, vp, table, pc), reps=3),
        plain_ms=timer(lambda: paged_flash_decode_tiled(
            qc, kp, vp, table, pc), reps=1),
        library_ms=None, library_note=lib_note)
    chk["bound_ms"], chk["bound_by"] = k6_bound(qc, table, pc, KV, 0)
    results["k6_paged_decode_grok"] = dec
    results["k6_paged_decode_chunk_grok"] = chk
    print("  k6 grok " + json.dumps([dec, chk]), flush=True)
    del kp, vp, q, qc
    torch.cuda.empty_cache()

    # K1 at grok's two projections (its FFN is the MoE's batched products)
    shapes = []
    for m in (LANES, LANES * CHUNK, GK_BATCH * GK_PROMPT):
        shapes += k1_rows(torch, timer, rand, "grok", m, D,
                          (H + 2 * KV) * hd, H * hd, GK_FF, tol,
                          names=("qkv", "o"))
    for m, where in ((LANES, "decode"), (LANES * CHUNK, "a scheduler chunk"),
                     (GK_BATCH * GK_PROMPT, "the fixed loop's prefill")):
        results[f"k1_matmul_grok_m{m}"] = dict(
            k1_sum(shapes, "grok", m,
                   f"grok-1's qkv [{D}, {(H + 2 * KV) * hd}] and o "
                   f"[{H * hd}, {D}] at {where} (M={m})", tol),
            shapes=[r for r in shapes
                    if r["shape"].split()[1] == f"M={m}"])
    torch.cuda.empty_cache()

    # the row norm at N = 6144: ln2 and the norm after the MoE
    nscale = rand(D, scale=0.1, dtype=torch.float32)
    w1 = (1.0 + nscale).to(bf)
    errs, abs_errs, at = [], [], {}
    for m in (LANES, GK_BATCH * GK_PROMPT):
        x = rand(m, D)
        got = ops.rmsnorm(x, nscale)
        require(torch.equal(got, ref.rmsnorm_rows_ref(x, nscale, 1e-6)),
                f"rmsnorm [{m}, {D}] is not bitwise its ordered mirror")
        want = rms_normalize(x, nscale, 1e-6)
        errs.append(row_err(got, want))
        abs_errs.append(max_err(got, want))
        at[m] = row_timing(
            timer, cupti, lambda x=x: ops.rmsnorm(x, nscale),
            lambda x=x: rms_normalize(x, nscale, 1e-6),
            2 * 2 * x.numel() + 4 * D,
            (lambda x=x: F.rms_norm(x, (D,), w1, 1e-6))
            if hasattr(F, "rms_norm") else None)
    require(max(errs) <= eps_bf16,
            f"rmsnorm N={D}: a row is off by {max(errs):.3e}")
    row = dict(
        work=f"rmsnorm rows [{LANES}, {D}] bf16, ln2 and the norm after the "
             f"MoE at decode, one warp a row (bitwise its ordered mirror, "
             f"also at [{GK_BATCH * GK_PROMPT}, {D}], the fixed prefill, "
             f"which 'rows' also times)",
        max_abs_err=max(abs_errs), max_row_err=max(errs), tol=eps_bf16,
        **at[LANES], rows={str(m): v for m, v in at.items()})
    also_into(cupti, at[LANES], row)
    results["k1_rmsnorm_grok_n6144"] = row
    print("  grok rmsnorm " + json.dumps(row), flush=True)

    # K3 and K2 on the int8 copy's wqkv and wo at decode
    x = rand(LANES, D)
    qx, sx = ops.quantize_rowwise(x)
    wq, wsx = ref.quantize_rowwise_ref(x)
    require(torch.equal(qx, wq) and torch.equal(sx, wsx),
            f"K3 [{LANES}, {D}] is not bitwise its plain version")
    k3 = row_timing(timer, cupti, lambda: ops.quantize_rowwise(x),
                    lambda: ref.quantize_rowwise_ref(x),
                    2 * x.numel() + x.numel() + 4 * LANES)
    results["k3_quantize_grok"] = dict(
        work=f"rowwise quantize of the normed stream [{LANES}, {D}] bf16 "
             f"(the int8 copy's wqkv and wo inputs at decode), bitwise its "
             f"plain version",
        max_abs_err=0.0, max_row_err=0.0, tol=0.0, **k3)
    also_into(cupti, k3, results["k3_quantize_grok"])
    k2 = []
    for name, (kk, nn) in (("qkv", (D, (H + 2 * KV) * hd)),
                           ("o", (H * hd, D))):
        qw = quantize_weight_colwise(rand(kk, nn, scale=kk ** -0.5))
        qb, sb = qw.as_matrix()
        qa, sa = ops.quantize_rowwise(rand(LANES, kk))
        require(torch.equal(ops.int8_matmul(qa, sa, qb, sb),
                            ref.int8_matmul_ref(qa, sa, qb, sb)),
                f"K2 grok {name}: fp32 out is not bitwise")
        ep = Epilogue(out_dtype=bf)
        got = ops.int8_matmul(qa, sa, qb, sb, epilogue=ep)
        want = ref.int8_matmul_ref(qa, sa, qb, sb, ep)
        err, abs_err = row_err(got, want), max_err(got, want)
        require(err <= eps_bf16, f"K2 grok {name}: a row is off by "
                                 f"{err:.3e}")
        lib, form = _int_mm_ms(torch, timer, qa, qb)
        if lib is None:      # _int_mm refuses M <= 16: rows padded to 32
            pad = torch.zeros((32, kk), dtype=torch.int8, device="cuda")
            pad[:LANES] = qa
            lib, form = _int_mm_ms(torch, timer, pad, qb)
        nbytes = LANES * kk + kk * nn + 4 * (LANES + nn) + 2 * LANES * nn
        t_b, by = bound(nbytes, 2 * LANES * kk * nn, INT8_OPS_PER_S)
        k2.append(dict(
            shape=f"{name} M={LANES} K={kk} N={nn}", max_abs_err=abs_err,
            max_row_err=err,
            ms=timer(lambda: ops.int8_matmul(qa, sa, qb, sb, epilogue=ep)),
            wrapper_ms=timer.wall(lambda: ops.int8_matmul(
                qa, sa, qb, sb, epilogue=ep)),
            plain_ms=timer(lambda: ref.int8_matmul_ref(qa, sa, qb, sb, ep)),
            bound_ms=t_b, bound_by=by, library_ms=lib, library_form=form))
        print("  k2 grok " + json.dumps(k2[-1]), flush=True)
    results["k2_int8_matmul_grok"] = dict(
        work=f"the int8 copy's wqkv [{D}, {(H + 2 * KV) * hd}] and wo "
             f"[{H * hd}, {D}] at decode (M={LANES}), bf16 out; fp32 out "
             f"bitwise",
        max_abs_err=max(r["max_abs_err"] for r in k2),
        max_row_err=max(r["max_row_err"] for r in k2), tol=eps_bf16,
        ms=sum(r["ms"] for r in k2),
        wrapper_ms=sum(r["wrapper_ms"] for r in k2),
        plain_ms=sum(r["plain_ms"] for r in k2),
        bound_ms=sum(r["bound_ms"] for r in k2),
        bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in k2)
                  else "operations"),
        library_ms=sum(r["library_ms"] for r in k2),
        library_note="torch._int_mm (cuBLASLt int8, no epilogue) on the "
                     "rows zero-padded to 32 (it refuses M <= 16), the "
                     "faster operand form",
        shapes=k2)
    return results


def moe_card_vs_cpu(torch):
    """Phase 12: grok-1's routing, dispatch and combine (plain torch, no
    kernel of the reference's) on the card against the same functions on
    the CPU, on the same routed inputs at its width: the fixed prefill's
    8320 tokens over 8 experts of 2600 slots, the router's probabilities
    drawn with a bias that overflows some experts and with exact ties in
    some rows.  ``top_k`` (ties included), the gates, ``dispatch``'s
    sorted tokens, slots, kept flags and gates are identical, and the
    combine of the same bf16 expert outputs is bitwise: CUDA's
    ``index_add_`` sums with atomics, and at k = 2 a token's row is 0.0
    plus at most two contributions, which no order changes."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(GK_ARCH)
    n, e, k, d = GK_BATCH * GK_PROMPT, cfg.n_experts, cfg.top_k, cfg.d_model
    gen = torch.Generator().manual_seed(SEED + 12)
    logits = (2.0 * torch.randn((n, e), generator=gen)
              + torch.linspace(-0.6, 0.6, e))
    probs = torch.softmax(logits, dim=-1)
    probs[:64, 3] = probs[:64, 5]            # exact ties
    probs[64:96, 1] = probs[64:96].amax(dim=-1)
    cap = moe.capacity(n, cfg)
    ye = torch.randn((e * cap, d), generator=gen).to(torch.bfloat16)
    out = {}
    for dev in ("cpu", "cuda"):
        p, y = probs.to(dev), ye.to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        gates, expert = moe.top_k(p, k)
        gates = gates / gates.sum(dim=-1, keepdim=True)
        st, dest, keep, sg = moe.dispatch(expert, e, cap, gates)
        comb = moe.combine(y, st, dest, sg, keep, n)
        torch.cuda.synchronize()
        out[dev] = dict(ms=(time.perf_counter() - t) * 1e3,
                        t=[x.cpu() for x in (expert, gates, st, dest, keep,
                                             sg, comb)])
    names = ("experts", "gates", "st", "dest", "keep", "sorted gates",
             "combine")
    for name, a, b in zip(names, out["cpu"]["t"], out["cuda"]["t"]):
        require(a.dtype == b.dtype and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b),
            f"grok MoE {name}: the card's differ from the CPU's")
    keep = out["cpu"]["t"][4]
    per_token = torch.zeros(n, dtype=torch.int64).index_add_(
        0, out["cpu"]["t"][2], keep.long())
    w = dict(tokens=n, experts=e, top_k=k, capacity=cap,
             entries_dropped=int((~keep).sum()),
             tokens_one_entry_kept=int((per_token == 1).sum()),
             tokens_none_kept=int((per_token == 0).sum()),
             tied_rows=96, identical=list(names),
             card_ms=out["cuda"]["ms"], cpu_ms=out["cpu"]["ms"])
    require(w["tokens_one_entry_kept"] > 0,
            f"the grok MoE check drops no single entry: {w}")
    print("grok moe card vs cpu: " + json.dumps(w), flush=True)
    return w


def serve_grok(torch):
    """Phase 12: grok-1 at full width (d_model 6144, 48 q heads over 8 of
    128, 8 experts of 32768 top-2, vocab 131072), 6 of its 64 layers
    (60.65 GB of bf16 weights), random weights from SEED, built after the
    models of the phases before it are gone.  First the MoE's routing,
    dispatch and combine card against CPU (``moe_card_vs_cpu``).  At the
    init scales the MoE witness (``moe_witness``: 2 x 4160 tokens and 8
    decode steps, held on the lanes no entry of which either prefill
    dropped) and the int8 copy's first logits against the bf16 model's on
    8 lanes of 512 tokens (``int8_witness``: held where no entry dropped
    and the last token's two experts are the same in every layer).  Then,
    on weights varied as in phase 3, each path with the launch counts set
    to 0 just before it, bf16 and on the attention-only int8 copy (K2 and
    K3 for ``wqkv`` and ``wo``, the MoE shared): the fixed loop
    (``generate_with_status_fixed``, batch 2, prompt 4160, 16 tokens; K4
    and K5 at G = 6, K1; its decode step's device time in a CUPTI trace,
    beside the bytes bound of the weights read once) and the scheduler (8
    requests on 8 lanes, request 0 a 4160-token prompt with 32 new tokens;
    K6 decode and chunk at G = 6, K1).  Every status ok, every variant of
    ``PATH_KERNELS`` launched, one decode iteration's launches exact
    (``decode_launches``, the MoE's standalone norms), request 0 served
    alone first emits bitwise the tokens it emits amid churn (its entries
    sort first within every expert at k = 2 too: ROADMAP F6), and the peak
    under the card's 80 GB."""
    import gc
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (NEW_RANGE, PROMPT_RANGE, geometry,
                                          make_requests, with_layers)
    from repro_torch.models.lm import Model
    from repro_torch.serve.api import Request, SamplingParams
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"grok_moe_card_vs_cpu": moe_card_vs_cpu(torch)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    cfg = with_layers(get_config(GK_ARCH), GK_LAYERS)
    t0 = time.perf_counter()
    model = Model(cfg).init_weights(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.nbytes for t in model.state_dict().values())
    # a decode step reads every weight once: each expert computes its
    # capacity's slots (8 at least) whatever the tokens routed to it
    step_bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    print(f"grok: {cfg.n_layers} of 64 layers, {weight_bytes / 1e9:.3f} GB "
          f"of weights on the card ({base_gb:.3f} GB left by the phases "
          f"before), built in {init_s:.2f} s; a decode step's bytes bound "
          f"{step_bound_ms:.2f} ms", flush=True)
    wit = torch.randint(0, cfg.vocab, (GK_BATCH, GK_PROMPT),
                        generator=torch.Generator().manual_seed(SEED))
    out["grok_witness"] = moe_witness(torch, model, wit, GK_WIT_NEW)
    wit8 = torch.randint(0, cfg.vocab, (GK_WIT8_LANES, GK_WIT8_PROMPT),
                         generator=torch.Generator().manual_seed(SEED + 2))
    out["grok_int8_witness"] = int8_witness(torch, model, wit8)
    print("grok witness: " + json.dumps(out), flush=True)
    vary(torch, model, SEED)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    # the fixed loop, bf16 then on the attention-only int8 copy
    toks = torch.randint(0, cfg.vocab, (GK_BATCH, GK_PROMPT),
                         generator=torch.Generator().manual_seed(SEED + 1))
    for int8 in (False, True):
        name = "grok_fixed_int8" if int8 else "grok_fixed"
        out[name] = moe_fixed_run(
            torch, ServeEngine(model, ServeConfig(max_new_tokens=GK_NEW,
                                                  int8=int8)),
            toks, GK_NEW, name, layers=cfg.n_layers,
            params=cfg.param_count(), init_s=init_s,
            weights_gb=weight_bytes / 1e9, decode_bound_ms=step_bound_ms)
        gc.collect()
        torch.cuda.empty_cache()

    geom = geometry(GK_ARCH)
    require((geom["n_lanes"], geom["page_size"], geom["prefill_chunk"],
             geom["max_seq_len"] // geom["page_size"])
            == (LANES, PAGE, CHUNK, GK_PAGES), f"{GK_ARCH} geometry {geom}")
    reqs = make_requests(cfg.vocab, GK_REQ, SEED, PROMPT_RANGE, NEW_RANGE)
    reqs[0] = Request(id=0, tokens=np.random.default_rng(SEED).integers(
        0, cfg.vocab, GK_LONG), sampling=SamplingParams(
        max_new_tokens=GK_LONG_NEW))
    out.update(moe_scheduler_runs(torch, model, reqs, geom, "grok",
                                  decode_bound_ms=step_bound_ms))

    # one fixed decode step's device time (its kernels' CUPTI durations in
    # a trace) against its wall time above: the idle share; traced after
    # every timed path, as the last phase's traces are
    for name in ("grok_fixed", "grok_fixed_int8"):
        served = (model.quantize_params_for_serving()
                  if name.endswith("int8") else model)
        logits, cache = served.prefill(toks, GK_PROMPT + GK_NEW)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        busy = kernel_ms(torch, flush, lambda: served.decode_step(
            cache, tok, GK_PROMPT), reps=4, skip="bitwise_not")
        r = out[name]
        r["decode_device_ms"] = busy
        r["decode_idle_share"] = (None if busy is None
                                  else 1.0 - busy / r["decode_ms_per_step"])
        del served, cache, logits
    del model, flush
    gc.collect()
    torch.cuda.empty_cache()
    summary = {name: {key: out[name].get(key) for key in (
        "ttft_ms", "ttft_ms_request_0", "decode_ms_per_step",
        "decode_device_ms", "decode_idle_share", "decode_ms_per_iter",
        "tokens_per_s", "peak_gb", "decode_bound_ms")}
        for name in ("grok_fixed", "grok_fixed_int8", "grok_scheduler",
                     "grok_scheduler_int8")}
    print("grok summary (6 of 64 layers): " + json.dumps(summary),
          flush=True)
    return out


SAMPLER_VOCABS = (49155, 262144)
SAMPLE_TEMP = 0.8


def check_sampler(torch, timer):
    """Phase 2, the sampler (``serve/sampling.py``, plain torch on the
    logits' device, no kernel of its own) at granite's and gemma3's vocab,
    fp32 and bf16 logits.  Card against CPU, bitwise: the scheduler's 8
    lane keys ``fold_in(PRNGKey(1000 + l), step)``, their 32-bit words and
    fp32 uniforms over ``[v]`` (the scheduler draws in fp32 whatever the
    logits' dtype), and the fixed loop's one-key ``[8, v]`` uniforms in
    the logits' dtype (bf16: 8-bit words).  The card's sampled tokens
    (``engine.pick_lanes``, every lane at ``SAMPLE_TEMP``) equal the
    CPU's on the same logits, a flip allowed only at a near tie of the
    CPU's scores (within 4 fp32 ulps of their scale).  Timed: the pick's
    device ms with every lane greedy (no draw) and every lane sampled."""
    from repro_torch.serve import sampling
    from repro_torch.serve.engine import pick_lanes

    import numpy as np
    rows = []
    seeds = np.stack([sampling.prng_key(1000 + l) for l in range(LANES)])
    steps_np = np.array([0, 1, 3, 7, 15, 31, 2, 5], np.int64)
    greedy = {dev: torch.zeros(LANES, dtype=torch.bool, device=dev)
              for dev in ("cpu", "cuda")}
    temp = {dev: torch.full((LANES,), SAMPLE_TEMP, device=dev)
            for dev in ("cpu", "cuda")}
    kb = {dev: sampling.key_tensor(seeds, dev) for dev in ("cpu", "cuda")}
    steps = {dev: torch.from_numpy(steps_np).to(dev)
             for dev in ("cpu", "cuda")}
    for v in SAMPLER_VOCABS:
        t0 = time.perf_counter()
        gen = torch.Generator().manual_seed(SEED + v)
        logits = {"cpu": 3.0 * torch.randn((LANES, v), generator=gen)}
        logits["cuda"] = logits["cpu"].to("cuda")
        per = {}
        for dev in ("cpu", "cuda"):
            keys = sampling.fold_in(kb[dev], steps[dev])
            per[dev] = dict(
                keys=keys, lane_words=sampling.random_bits(keys, (v,), 32),
                lane_uniforms=sampling.uniform(
                    keys, (v,), torch.float32,
                    minval=torch.finfo(torch.float32).tiny))
        for dtype in (torch.float32, torch.bfloat16):
            for dev in ("cpu", "cuda"):
                per[dev]["fixed_uniforms"] = sampling.uniform(
                    kb[dev][0], (LANES, v), dtype,
                    minval=torch.finfo(dtype).tiny)
                per[dev]["tokens"] = pick_lanes(
                    logits[dev], dtype, kb[dev], steps[dev], greedy[dev],
                    temp[dev])
            torch.cuda.synchronize()
            for name in ("keys", "lane_words", "lane_uniforms",
                         "fixed_uniforms"):
                require(torch.equal(per["cuda"][name].cpu(), per["cpu"][name]),
                        f"sampler {name} at vocab {v}, {dtype}: card and CPU "
                        f"differ")
            got, want = per["cuda"]["tokens"].cpu(), per["cpu"]["tokens"]
            flips = []
            for l in torch.nonzero(got != want).flatten().tolist():
                # the CPU's scores of its own draw: the near-tie rule
                scores = (sampling.gumbel(per["cpu"]["keys"][l], (v,),
                                          torch.float32)
                          + logits["cpu"][l].to(dtype).float()
                          / SAMPLE_TEMP).double()
                gap = float(scores[want[l]] - scores[got[l]])
                tol = 4 * float(torch.finfo(torch.float32).eps
                                * scores.abs().max())
                require(gap <= tol, f"sampled token of lane {l} at vocab {v} "
                                    f"differs card vs CPU by a score gap "
                                    f"{gap:.3e} > {tol:.3e}")
                flips.append(dict(lane=l, gap=gap))
            check_s = time.perf_counter() - t0
            real = logits["cuda"]
            greedy_ms = timer(lambda: pick_lanes(real, dtype))
            sampled_ms = timer(lambda: pick_lanes(
                real, dtype, kb["cuda"], steps["cuda"], greedy["cuda"],
                temp["cuda"]))
            rows.append(dict(
                vocab=v, lanes=LANES, logits_dtype=str(dtype).split(".")[-1],
                bitwise=["keys", "lane_words", "lane_uniforms",
                         "fixed_uniforms"],
                tokens_equal=int((got == want).sum()), near_tie_flips=flips,
                greedy_pick_ms=greedy_ms, sampled_pick_ms=sampled_ms,
                check_s=check_s))
            t0 = time.perf_counter()
    return rows


def serve_mixed(torch, model, greedy_tokens):
    """Phase 4's mixed run: the greedy run's 16 requests on the bf16
    scheduler, the even ones now sampled (temperatures 0.7-1.0, each its
    own seed), the odd ones greedy as before.  Every status ok; request 0
    (sampled) served alone emits bitwise the tokens it emits amid the
    churn; each greedy request's tokens are bitwise those of the greedy
    run; a sampled request's tokens are not all its greedy ones."""
    import dataclasses
    import numpy as np
    from repro_torch.launch.serve import (GEOMETRY, NEW_RANGE, PROMPT_RANGE,
                                          make_requests, serve_requests)
    from repro_torch.serve.api import SamplingParams
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    reqs = make_requests(model.cfg.vocab, N_REQ, SEED, PROMPT_RANGE,
                         NEW_RANGE)
    temps = np.linspace(0.7, 1.0, N_REQ // 2)
    mixed = [r if r.id % 2 else dataclasses.replace(
        r, seed=1000 + r.id, sampling=SamplingParams(
            greedy=False, temperature=float(temps[r.id // 2]),
            max_new_tokens=r.sampling.max_new_tokens)) for r in reqs]
    eng = ServeEngine(model, ServeConfig(**GEOMETRY))
    alone = serve_requests(eng, mixed[:1])["outputs"][0]
    run = serve_requests(eng, mixed)
    outs = run["outputs"]
    require(all(o.status == "ok" for o in outs.values()),
            f"mixed: statuses {[o.status for o in outs.values()]}")
    require(np.array_equal(alone.tokens, outs[0].tokens),
            f"mixed: sampled request 0 alone {alone.tokens.tolist()} != "
            f"amid churn {outs[0].tokens.tolist()}")
    greedy_ids = [r.id for r in mixed if r.sampling.greedy]
    require(all(outs[i].tokens.tolist() == greedy_tokens[i]
                for i in greedy_ids),
            "mixed: a greedy request's tokens moved beside sampled lanes")
    sampled_ids = [r.id for r in mixed if not r.sampling.greedy]
    differ = sum(outs[i].tokens.tolist() != greedy_tokens[i]
                 for i in sampled_ids)
    require(differ > 0, "mixed: every sampled request emitted its greedy "
                        "tokens")
    del eng
    torch.cuda.empty_cache()
    return dict(requests=N_REQ, sampled=sampled_ids,
                temperatures=temps.tolist(), statuses_ok=True,
                alone_equals_churn=True, greedy_unchanged=len(greedy_ids),
                sampled_not_greedy=differ,
                decode_ms_per_iter=run["decode_ms_per_iter"],
                tokens_per_s=run["tokens_per_s"], wall_s=run["wall_s"],
                tokens0=outs[0].tokens.tolist(),
                part_s=time.perf_counter() - t0)


# phase 4's drills: the fault step and lane, the stall past the budget
DRILL_STEP, DRILL_LANE = 3, 1
DRILL_TIMEOUT_S, DRILL_STALL_S = 2.0, 2.5


def fault_drills(torch, model, toks):
    """Phase 4's fault drills through ``generate_with_status`` (the
    scheduler's shim) on the full model, each against the undrilled run of
    the same engine: a NaN fault on one lane at step 3 quarantines that
    request alone (``quarantined_nonfinite`` at step 3) and every other
    keeps bitwise its tokens; on the int8 engine (with ``fp32_fallback``)
    a 'scale' fault degrades its lane (``degraded_fp32`` at step 3), the
    others bitwise unchanged; a stall past ``request_timeout_s`` times
    every lane out at its step; ``generate_with_retry`` with
    ``fail_first_generates=2`` succeeds on the third attempt, tokens
    bitwise the undrilled run."""
    import numpy as np
    from repro_torch.robust import (FaultPlan, LogitFault, StallFault,
                                    generate_with_retry)
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    batch = {"tokens": toks}
    b = toks.shape[0]
    others = [l for l in range(b) if l != DRILL_LANE]
    out = {}

    def timed(fn):
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    eng = ServeEngine(model, ServeConfig(max_new_tokens=NEW))
    base, base_s = timed(lambda: eng.generate_with_status(batch))
    require(base.ok and base.tokens.shape == (b, NEW),
            f"drills: undrilled run {base.status}")
    res, s = timed(lambda: eng.generate_with_status(batch, fault_plan=(
        FaultPlan(logit_faults=(LogitFault(step=DRILL_STEP,
                                           lanes=(DRILL_LANE,)),)))))
    require(res.status[DRILL_LANE] == "quarantined_nonfinite"
            and res.fault_step[DRILL_LANE] == DRILL_STEP
            and all(res.status[l] == "ok" for l in others),
            f"nan drill: statuses {res.status}, steps {res.fault_step}")
    require(np.array_equal(res.tokens[others], base.tokens[others])
            and np.array_equal(res.tokens[DRILL_LANE, :DRILL_STEP],
                               base.tokens[DRILL_LANE, :DRILL_STEP]),
            "nan drill: a healthy lane's tokens moved")
    out["nan"] = dict(statuses=list(res.status),
                      fault_step=res.fault_step.tolist(),
                      others_bitwise=True, s=s)

    slept = []
    res, s = timed(lambda: generate_with_retry(
        eng, batch, fault_plan=FaultPlan(fail_first_generates=2),
        sleep=slept.append))
    require(res.ok and np.array_equal(res.tokens, base.tokens)
            and slept == [0.05, 0.1],
            f"retry drill: {res.status}, backoff {slept}")
    out["retry"] = dict(attempts=3, backoff_s=slept, tokens_bitwise=True,
                        s=s)
    del eng

    eng = ServeEngine(model, ServeConfig(max_new_tokens=NEW,
                                         request_timeout_s=DRILL_TIMEOUT_S))
    res, s = timed(lambda: eng.generate_with_status(batch, fault_plan=(
        FaultPlan(stalls=(StallFault(step=2, seconds=DRILL_STALL_S),)))))
    require(res.timed_out and res.status == ["timeout"] * b
            and res.fault_step.tolist() == [2] * b and res.n_steps == 2
            and np.array_equal(res.tokens, base.tokens[:, :2]),
            f"stall drill: {res.status}, steps {res.fault_step}, "
            f"n_steps {res.n_steps}")
    out["stall"] = dict(statuses=list(res.status), timeout_s=DRILL_TIMEOUT_S,
                        stall_s=DRILL_STALL_S, n_steps=res.n_steps, s=s)
    del eng

    eng = ServeEngine(model, ServeConfig(max_new_tokens=NEW, int8=True,
                                         fp32_fallback=True))
    base8, _ = timed(lambda: eng.generate_with_status(batch))
    require(base8.ok, f"int8 drill: undrilled run {base8.status}")
    res, s = timed(lambda: eng.generate_with_status(batch, fault_plan=(
        FaultPlan(logit_faults=(LogitFault(step=DRILL_STEP,
                                           lanes=(DRILL_LANE,),
                                           kind="scale", scale=100.0),)))))
    require(res.status[DRILL_LANE] == "degraded_fp32"
            and res.fault_step[DRILL_LANE] == DRILL_STEP
            and all(res.status[l] == "ok" for l in others)
            and np.array_equal(res.tokens[others], base8.tokens[others]),
            f"int8 scale drill: statuses {res.status}, steps "
            f"{res.fault_step}")
    out["int8_scale"] = dict(statuses=list(res.status),
                             fault_step=res.fault_step.tolist(),
                             others_bitwise=True, s=s)
    out["undrilled_s"] = base_s
    del eng
    torch.cuda.empty_cache()
    return out


def checkpoint_round_trip(torch, model, batch, want_tokens, new):
    """Phase 7's checkpoint drill on the full model: the weights saved
    (``CheckpointManager.save(..., blocking=True)`` of
    ``convert.to_jax_params``), restored into a fresh model by
    ``ServeEngine.from_checkpoint``, whose greedy tokens must be bitwise
    ``want_tokens`` (the in-memory engine's).  Then a second step (the
    final norm moved) with a bit flipped in its first leaf: the engine
    must serve the first step and print the skip.  Each step's seconds
    are returned."""
    import contextlib
    import io
    import shutil
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.convert import to_jax_params
    from repro_torch.models.lm import Model
    from repro_torch.robust import bitflip_leaf
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = model.cfg
    d = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(d, ignore_errors=True)
    mgr = CheckpointManager(str(d))
    secs = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        return out

    tree = timed("host_copy_s", lambda: to_jax_params(cfg, model.state_dict()))
    timed("save_s", lambda: mgr.save(1, tree, blocking=True))
    gb = sum(f.stat().st_size for f in (d / "step_00000001").iterdir()) / 1e9
    scfg = ServeConfig(max_new_tokens=new)

    def restore():
        return ServeEngine.from_checkpoint(Model(cfg), str(d), scfg=scfg)

    eng = timed("restore_s", restore)
    got = timed("generate_s", lambda: eng.generate_with_status(batch))
    require(got.ok and np.array_equal(got.tokens, want_tokens),
            "checkpoint: the restored engine's tokens differ from the "
            "in-memory engine's")
    del eng
    tree["final_norm"] = tree["final_norm"] + np.float32(1.0)
    timed("save2_s", lambda: mgr.save(2, tree, blocking=True))
    name = timed("bitflip_s", lambda: bitflip_leaf(str(d), 2, leaf=0))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        eng = timed("fallback_restore_s", restore)
    skip = log.getvalue().strip()
    print(f"  {skip}")
    require("falling back" in skip and name in skip,
            f"checkpoint: the fallback printed {skip!r}")
    got = timed("generate2_s", lambda: eng.generate_with_status(batch))
    require(got.ok and np.array_equal(got.tokens, want_tokens),
            "checkpoint: the fallback engine does not serve step 1")
    del eng
    timed("cleanup_s", lambda: shutil.rmtree(d, ignore_errors=True))
    torch.cuda.empty_cache()
    return dict(leaves=len(flatten(tree)), gb=gb, tokens_bitwise=True,
                skipped=name, **secs)

# ---------------------------------------------------------------------------
# internlm2-1.8b: served at bf16 from its fp32 masters (C3), and trained
# ---------------------------------------------------------------------------

# internlm2-1.8b (src/repro_torch/configs/internlm2_1_8b.py): 16 q heads
# over 8 kv heads of 128 (G = 2), d_model 2048, d_ff 8192, vocab 92544,
# 24 layers, float32 parameters (the master copy) served and trained at
# bf16 compute
IL_ARCH = "internlm2-1.8b"
IL_H, IL_KV, IL_HD, IL_D, IL_FF = 16, 8, 128, 2048, 8192
# training at full width and depth: 8 x 4096 tokens a step in the config's
# 2 microbatches of 4 x 4096; the Trainer's run and its checkpoint, the
# resumed steps and the repeated batch's steps; AdamW at a constant lr
# (cut to 12 of its 24 layers, the loss on the repeated batch rose at its
# third step, 9.514, 8.753, 9.356: at lr 1e-3 the smaller model is still
# in its first steps' transient; NVIDIA H100 80GB HBM3, 700.00 W)
TR_BATCH, TR_SEQ = 8, 4096
TR_STEPS, TR_RESUMED, TR_REPEAT, TR_LR = 4, 1, 5, 1e-3
# the loss on one repeated batch of random tokens must fall at every one
# of TR_REPEAT steps, and by this much in all (nats; it falls 0.10-0.11
# over the 4 updates between the first and the last step's loss on an
# NVIDIA H100 80GB HBM3 at 700.00 W)
TR_REPEAT_DROP = 0.05
# the smoke config's card-vs-CPU steps, and the full-width 2-layer
# gradients on one sequence of 512
TR_SMOKE_BATCH, TR_SMOKE_SEQ, TR_SMOKE_STEPS = 4, 64, 3
TR_WIDE_LAYERS, TR_WIDE_SEQ = 2, 512

# the recurrent families' phase 3 checks: xlstm's smoke steps at 128
# positions (two mLSTM chunks carry state); the full-width gradients on
# recurrentgemma's first period (rglru, rglru, local), so that K4's
# backward runs at G = 16 and hd 256, and on one mLSTM block and the
# sLSTM block of xlstm.  Through xlstm's whole period of 8 blocks the
# CPU's own bf16 gradients lay 0.70-1.01 of each leaf's scale from the
# fp32 anchor (the embedding, the mLSTMs' wq, up_x and inner norm), so
# 4x that bounded nothing; through the two blocks the worst leaf's is
# 0.34 of its scale (the embedding; the mLSTM's w_i 0.32) and the inner
# norms' 0.015 and 0.0057 (on an NVIDIA H100 80GB HBM3's host; the
# check prints each leaf's); whisper's through one encoder block and one
# decoder block, its 512 tokens over the config's 1500 frames (K4's
# backward 'full' at Skv != Sq and hd 64 at full width); paligemma's
# first two layers at 512 positions (256 patches, 256 tokens)
TR_SMOKE_SEQS = {XL_ARCH: 128}
TR_WIDE_CUTS = {RG_ARCH: {"n_layers": 3},
                XL_ARCH: {"n_layers": 2, "block_pattern": ("mlstm", "slstm")},
                WH_ARCH: {"n_layers": 1, "n_enc_layers": 1}}
# whatever the CPU's own noise, no leaf's error in the full-width check
# may reach this share of its scale (the worst leaf's error read about
# 0.01 for the attention families, 0.34 for xlstm's two blocks and at
# least 1.36 through its 8-block period, whose noise let 4x pass; NVIDIA
# H100 80GB HBM3, 700.00 W)
TR_WIDE_CAP = 0.5
# the smoke configs' weights in phase 3: recurrentgemma's bf16 leaves, as
# its serving smoke and its full config have them (the gates the port
# holds at bf16, as the reference does, and widens at use)
TR_SMOKE_OVER = {RG_ARCH: {"param_dtype": "bfloat16"}}
# xlstm's smoke steps at the gemma phases' lr: at TR_LR its grad norm
# spikes from step to step (the fp32 CPU anchor's own rose at step 2 and
# fell back at step 3, the card's and the CPU bf16 run's spiked at other
# steps), so the 4x rule there compared the dynamics' spikes, not
# rounding; at 1e-4 the three runs move together
TR_SMOKE_LR = {XL_ARCH: 1e-4}
# a leaf of fewer entries than this (xlstm's gate biases, one entry a
# head) is one draw of the rounding noise, not a distribution: the
# full-width check pools such leaves into one vector before its 4x rule
# (tests/test_torch_train_mixers.py's bf16 test says why on the CPU)
TR_POOL_BELOW = 64
# K4's backward against its plain version at fp32 (from the same bf16
# inputs, output and lse): the kernel rounds P and dS to bf16 for their
# products, as the forward rounds P, and stores bf16; each row of dQ, dK
# and dV within this share of its own scale (6.8e-3 measured at 4 x 4096)
K4_BWD_TOL = 2e-2
# K4's backward at the shapes the training rows miss: head dims 32 and 64,
# S a multiple of no tile (2 x 1000), G = 1 (4 q heads over 4) and G = 4 (8
# over 2); each a few ms of phase 2
K4_BWD_ROWS = (
    ("k4_flash_backward_hd32", (2, 1024, 8, 4, 32)),
    ("k4_flash_backward_hd64", (2, 1024, 8, 4, 64)),
    ("k4_flash_backward_ragged", (2, 1000, 16, 8, 128)),
    ("k4_flash_backward_g1", (2, 1024, 4, 4, 128)),
    ("k4_flash_backward_g4", (2, 1024, 8, 2, 128)),
)
# K4's backward at the attention kinds the models train and the next
# training slices will: gemma3's microbatch (2 x 4096, 16 q heads over 8,
# hd 256) at its local (W 1024) and global layers, gemma2's (1 x 4096, 32
# over 16, hd 128, softcap 50) at its local (W 4096) and global layers,
# recurrentgemma's local layers (16 over 1, hd 256, W 2048), paligemma's
# (8 x 512, 8 over 1, hd 256), llama4's chunks (40 over 8, hd 128, chunks
# of 1000, so that they cut inside tiles), whisper's encoder ('full', 8 x
# 1500, 12 over 12, hd 64), the prefix kind at hd 256, and gemma2's global
# layer again with its scores at the cap (K4_BWD_Q_SCALE), then the
# shapes phases 19 and 20 train: paligemma's microbatch (4 x 4096, 8 over
# 1, hd 256) and whisper's cross-attention, 'full' over Skv != Sq keys (a
# training microbatch's 4 x 4096 decoder tokens over 1500 frames; the
# serving prefill's 64 over 1500; a ragged 1000 over 37), 12 over 12 at
# hd 64: (name, (B, S, H, KV, hd[, Skv]), mask), each held and timed as
# K4_BWD_ROWS, beside SDPA's backward where one call computes the same
# function (no SDPA call caps its scores)
K4_BWD_KIND_ROWS = (
    ("k4_flash_backward_gemma3_local", (2, 4096, 16, 8, 256),
     dict(kind="local", window=1024)),
    ("k4_flash_backward_gemma3_global", (2, 4096, 16, 8, 256),
     dict(kind="global")),
    ("k4_flash_backward_gemma2_local", (1, 4096, 32, 16, 128),
     dict(kind="local", window=4096, softcap=50.0)),
    ("k4_flash_backward_gemma2_global", (1, 4096, 32, 16, 128),
     dict(kind="global", softcap=50.0)),
    ("k4_flash_backward_recurrentgemma", (2, 4096, 16, 1, 256),
     dict(kind="local", window=2048)),
    ("k4_flash_backward_paligemma", (8, 512, 8, 1, 256), dict(kind="global")),
    ("k4_flash_backward_llama4_chunked", (1, 4096, 40, 8, 128),
     dict(kind="chunked", window=1000)),
    ("k4_flash_backward_whisper_full", (8, 1500, 12, 12, 64),
     dict(kind="full")),
    ("k4_flash_backward_prefix_hd256", (2, 1024, 8, 1, 256),
     dict(kind="prefix", prefix_len=300)),
    ("k4_flash_backward_gemma2_capped", (1, 4096, 32, 16, 128),
     dict(kind="global", softcap=50.0)),
    ("k4_flash_backward_paligemma_train", (4, 4096, 8, 1, 256),
     dict(kind="global")),
    ("k4_flash_backward_whisper_cross_train", (4, 4096, 12, 12, 64, 1500),
     dict(kind="full")),
    ("k4_flash_backward_whisper_cross_prefill", (8, 64, 12, 12, 64, 1500),
     dict(kind="full")),
    ("k4_flash_backward_whisper_cross_ragged", (2, 1000, 12, 12, 64, 37),
     dict(kind="full")),
)
# q's factor at these rows (1 elsewhere): with q, k and v standard normal
# the scaled scores are about N(0, 1), where a softcap of 50 changes P by
# under 1%, and a backward that skips the cap's derivative reads 1.7e-2
# of a row's scale, inside K4_BWD_TOL; q times 10 puts the scores at the
# cap (|score| up to about 50), where that fault reads 1.9 and P taken
# from the uncapped score 9.9e7, the kernel 7.7e-3 (``launch/bwd_ab.py
# --plant`` at this shape on an NVIDIA H100 80GB HBM3 at 700.00 W)
K4_BWD_Q_SCALE = {"k4_flash_backward_gemma2_capped": 10.0}
# the training forward's K4 with its log-sum-exp at these of them (the
# kinds phases 15-17, 19 and 20 train), held to the plain lse as
# internlm2's is
K4_LSE_KIND_ROWS = ("gemma3_local", "gemma3_global", "gemma2_local",
                    "gemma2_global", "recurrentgemma", "paligemma_train",
                    "whisper_cross_train")


# K1's fp32 store against the fp32 product (TF32 off): two fp32 sums of
# 16384 products in different orders; each row within this share of its
# scale (2.8e-5 measured)
K1_F32_TOL = 1e-4


def train_kernel_row(torch, timer, fn, plain, got, want, tol, nbytes,
                     flops, library, work, note=None):
    """One kernels-line row: ``got`` against ``want`` (tuples of outputs,
    each row within ``tol`` of its scale), the kernel's and the plain
    version's device ms, the bound and the library call's ms."""
    errs = [row_err(g, w) for g, w in zip(got, want)]
    worst = max(errs, key=lambda e: math.inf if math.isnan(e) else e)
    require(worst <= tol, f"{work}: a row is off by {worst:.3e} of its "
                          f"scale (tolerance {tol})")
    t_b, by = bound(nbytes, flops)
    row = dict(work=work, max_abs_err=max(max_err(g, w)
                                          for g, w in zip(got, want)),
               max_row_err=worst, tol=tol, ms=timer(fn),
               wrapper_ms=timer.wall(fn), plain_ms=timer(plain, reps=3),
               bound_ms=t_b, bound_by=by,
               library_ms=library() if library else None)
    if note:
        row["library_note"] = note
    return row


def plain_lse(torch, q, k, v, **mask):
    from repro_torch.kernels import ref
    g = q.shape[2] // k.shape[2]
    return torch.cat([ref.flash_attention_lse_ref(
        q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1], v[:, :, j:j + 1],
        **mask)[1]
        for j in range(k.shape[2])], dim=1)


def check_train_kind_rows(torch, timer):
    """Phase 2, training at every kind: K4's backward at
    ``K4_BWD_KIND_ROWS`` (gemma3's and gemma2's layers, the next slices'
    shapes), each of dQ, dK and dV within ``K4_BWD_TOL`` of each row's
    scale of the plain backward at fp32 and bitwise the same twice, and
    K4's log-sum-exp output at ``K4_LSE_KIND_ROWS`` within 1e-5 of each
    row's scale of the plain one.  A row of 'full' may take Skv != Sq
    keys (whisper's cross-attention).  The bound counts the backward's
    five products (the forward's two) over the pairs the mask keeps
    (``ref.live_keys``; every one of the Skv keys under 'full'); SDPA's
    backward (forward) with the kind's mask is the yardstick, none under a
    softcap."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_lse_cuda)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref_by_kv_head,
                                         live_keys)
    from repro_torch.launch.bwd_ab import sdpa_bwd_ms, sdpa_mask_kw
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(bf)

    results = {}
    for name, (b, s, h, kv, hd, *keys), mask in K4_BWD_KIND_ROWS:
        tag = name[len("k4_flash_backward_"):]
        skv = keys[0] if keys else s
        what = (f"B={b} S={s} H={h} KV={kv} hd={hd} "
                + (f"Skv={skv} " if skv != s else "")
                + " ".join(f"{key}={val}" for key, val in mask.items())
                + (f" q x {K4_BWD_Q_SCALE[name]} (scores at the cap)"
                   if name in K4_BWD_Q_SCALE else ""))
        q = rand(b, s, h, hd, scale=K4_BWD_Q_SCALE.get(name, 1.0))
        k, v = rand(b, skv, kv, hd), rand(b, skv, kv, hd)
        out, lse = flash_attention_lse_cuda(q, k, v, **mask)
        dout = rand(b, s, h, hd)
        sdpa_kw = sdpa_mask_kw(s, "cuda", **mask)
        pairs = b * h * s * (skv if mask["kind"] == "full" else live_keys(
            mask["kind"], s, mask.get("window", 0),
            mask.get("prefix_len", 0)))
        io = 2 * (2 * q.numel() + 2 * k.numel())
        if tag in K4_LSE_KIND_ROWS:
            want_lse = plain_lse(torch, q, k, v, **mask)
            results["k4_flash_prefill_lse_" + tag] = train_kernel_row(
                torch, timer,
                lambda q=q, k=k, v=v, mask=mask:
                    flash_attention_lse_cuda(q, k, v, **mask),
                lambda q=q, k=k, v=v, mask=mask:
                    plain_lse(torch, q, k, v, **mask),
                (lse,), (want_lse,), 1e-5, io + 4 * lse.numel(),
                4 * hd * pairs,
                None if sdpa_kw is None else
                (lambda q=q, k=k, v=v, kw=sdpa_kw:
                    sdpa_ms(torch, timer, q, k, v, **kw)),
                f"prefill with its row log-sum-exp, the training forward's "
                f"K4 at {what}; the lse within 1e-5 of each row's scale of "
                f"the plain one",
                "SDPA forward with the kind's mask (sdpa_ms)"
                if sdpa_kw is not None else
                "none: no SDPA call caps its scores")
            del want_lse
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **mask)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **mask)
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"{name}: two calls differ")
        want = flash_attention_bwd_ref_by_kv_head(q, k, v, out, lse, dout,
                                                  **mask)
        results[name] = train_kernel_row(
            torch, timer,
            lambda q=q, k=k, v=v, out=out, lse=lse, dout=dout, mask=mask:
                flash_attention_bwd_cuda(q, k, v, out, lse, dout, **mask),
            lambda q=q, k=k, v=v, out=out, lse=lse, dout=dout, mask=mask:
                flash_attention_bwd_ref_by_kv_head(q, k, v, out, lse, dout,
                                                   **mask),
            got, want, K4_BWD_TOL,
            2 * (3 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
            + 2 * (q.numel() + 2 * k.numel()), 10 * hd * pairs,
            None if sdpa_kw is None else
            (lambda q=q, k=k, v=v, dout=dout, kw=sdpa_kw:
                sdpa_bwd_ms(q, k, v, dout, lambda f: timer(f, reps=3), kw)),
            f"attention backward (three launches) {what}; dQ, dK, dV each "
            f"within {K4_BWD_TOL} of each row's scale of the plain backward "
            f"at fp32; bitwise the same twice; the bound counts the "
            f"backward's five products over the {pairs:.0f} (query, key) "
            f"pairs the mask keeps",
            "SDPA's backward with the kind's mask (sdpa_bwd_ms)"
            if sdpa_kw is not None else "none: no SDPA call caps its scores")
        del got, again, want, q, k, v, out, lse, dout
        torch.cuda.empty_cache()
    return results


def check_train_kernels(torch, timer):
    """Phase 2, training: K4's log-sum-exp output (its first output
    bitwise K4's), K4's backward at internlm2's microbatch (4 x 4096, 16 q
    heads over 8, hd 128), at the smoke config's training shape (4 x 64,
    4 over 2, hd 16) and at ``K4_BWD_ROWS`` (hd 32 and 64, a ragged S, G =
    1 and 4), each of dQ, dK and dV within ``K4_BWD_TOL`` of each row's
    scale of the plain backward at fp32, and bitwise the same twice (no
    atomics); K1's fp32 store at the weight gradients' shapes of the
    up/gate and down GEMMs ([2048, 16384] x [16384, 8192] and [8192, 16384]
    x [16384, 2048]) against the fp32 product (TF32 off)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda,
                                                     flash_attention_lse_cuda)
    from repro_torch.kernels.matmul import matmul_cuda
    from repro_torch.kernels.epilogue import Epilogue
    from repro_torch.launch.bwd_ab import sdpa_bwd_ms

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(bf)

    results = {}
    b, s, h, kv, hd = TR_BATCH // 2, TR_SEQ, IL_H, IL_KV, IL_HD
    q, k, v = rand(b, s, h, hd), rand(b, s, kv, hd), rand(b, s, kv, hd)
    out0 = flash_attention_cuda(q, k, v)
    out, lse = flash_attention_lse_cuda(q, k, v)
    require(torch.equal(out, out0), "K4 with its lse output: the output is "
                                    "not bitwise K4's")
    want_lse = plain_lse(torch, q, k, v)
    causal = 4 * b * h * hd * s * (s + 1) / 2
    io = 2 * (2 * q.numel() + 2 * k.numel())
    results["k4_flash_prefill_lse"] = train_kernel_row(
        torch, timer, lambda: flash_attention_lse_cuda(q, k, v),
        lambda: plain_lse(torch, q, k, v), (lse,), (want_lse,), 1e-5,
        io + 4 * lse.numel(), causal,
        lambda: sdpa_ms(torch, timer, q, k, v, is_causal=True),
        f"causal prefill with its row log-sum-exp, internlm2-1.8b's "
        f"training microbatch B={b} S={s} H={h} KV={kv} hd={hd}; the output "
        f"bitwise K4's", "SDPA causal forward (sdpa_ms)")
    del want_lse
    for name, (b, s, h, kv, hd) in (
            ("k4_flash_backward", (b, s, h, kv, hd)),
            ("k4_flash_backward_smoke", (TR_SMOKE_BATCH, TR_SMOKE_SEQ, 4, 2,
                                         16)), *K4_BWD_ROWS):
        q, k, v = rand(b, s, h, hd), rand(b, s, kv, hd), rand(b, s, kv, hd)
        out, lse = flash_attention_lse_cuda(q, k, v)
        dout = rand(b, s, h, hd)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"{name}: two calls differ")
        want = ref.flash_attention_bwd_ref_by_kv_head(q, k, v, out, lse,
                                                      dout)
        causal = 4 * b * h * hd * s * (s + 1) / 2
        results[name] = train_kernel_row(
            torch, timer,
            lambda q=q, k=k, v=v, out=out, lse=lse, dout=dout:
                flash_attention_bwd_cuda(q, k, v, out, lse, dout),
            lambda q=q, k=k, v=v, out=out, lse=lse, dout=dout:
                ref.flash_attention_bwd_ref_by_kv_head(q, k, v, out, lse,
                                                       dout),
            got, want, K4_BWD_TOL,
            2 * (3 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
            + 2 * (q.numel() + 2 * k.numel()), 2.5 * causal,
            lambda q=q, k=k, v=v, dout=dout: sdpa_bwd_ms(
                q, k, v, dout, lambda f: timer(f, reps=3),
                {"is_causal": True}),
            f"causal attention backward (D and lse log2(e) rows, then the "
            f"dK/dV and dQ passes on wgmma fed by a TMA ring: three "
            f"launches) "
            f"B={b} S={s} H={h} KV={kv} hd={hd}; dQ, dK, dV each within "
            f"{K4_BWD_TOL} of each row's scale of the plain backward at "
            f"fp32; bitwise the same twice; the bound counts the backward's "
            f"five products (2.5x the causal forward's)",
            "SDPA's causal backward (sdpa_bwd_ms)")
        del got, again, want
    f32 = Epilogue(out_dtype=torch.float32)
    tokens = TR_BATCH // 2 * TR_SEQ   # a microbatch's rows
    try:    # an fp32-out bf16 product in one call, where torch offers it
        torch.mm(rand(8, 8), rand(8, 8), out_dtype=torch.float32)
        mm_kw, mm_note = {"out_dtype": torch.float32}, \
            "torch.mm to fp32 (out_dtype)"
    except TypeError:
        mm_kw, mm_note = {}, "torch.mm to bf16 (this torch has no out_dtype)"
    for name, (m, kk, n) in (("k1_matmul_f32_up", (IL_D, tokens, IL_FF)),
                             ("k1_matmul_f32_down", (IL_FF, tokens, IL_D))):
        a, bb = rand(m, kk), rand(kk, n)
        got = matmul_cuda(a, bb, f32)
        want = ref.matmul_ref(a, bb)

        results[name] = train_kernel_row(
            torch, timer, lambda a=a, bb=bb: matmul_cuda(a, bb, f32),
            lambda a=a, bb=bb: ref.matmul_ref(a, bb), (got,), (want,),
            K1_F32_TOL,
            2 * (a.numel() + bb.numel()) + 4 * m * n, 2 * m * n * kk,
            lambda a=a, bb=bb: timer(lambda: torch.mm(a, bb, **mm_kw)),
            f"K1's fp32 store, a weight gradient's A^T dC: [{m}, {kk}] x "
            f"[{kk}, {n}] -> fp32 (internlm2-1.8b's "
            f"{'up/gate' if n == IL_FF else 'down'} GEMM at a 4 x 4096 "
            f"microbatch); each row within {K1_F32_TOL} of its scale of the "
            f"fp32 product (TF32 off)", mm_note)
        del a, bb, got, want
    torch.cuda.empty_cache()
    return results


def train_steps(torch, model, batches, opt_cfg):
    """``len(batches)`` train steps from ``model``'s weights: the losses
    and grad norms, and each parameter's update (p - p0) on the CPU."""
    from repro_torch.optim import init_opt_state
    from repro_torch.train.step import make_train_step
    params = model.train_params()
    p0 = {k: p.detach().clone() for k, p in params.items()}
    state = init_opt_state(params, opt_cfg)
    step = make_train_step(model, opt_cfg)
    hist = []
    for b in batches:
        params, state, m = step(params, state, {k: v.to(model.device)
                                                for k, v in b.items()})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return hist, {k: (params[k].detach() - p0[k]).cpu().double()
                  for k in params}


def synthetic_batches(torch, cfg, batch, seq, steps, seed):
    """The first ``steps`` batches of the synthetic stream (the
    pipeline's, on the CPU), with ``cfg``'s patches or frames."""
    from repro_torch.data import (DataConfig, SyntheticTokenSource,
                                  TokenPipeline)
    pipe = TokenPipeline(SyntheticTokenSource(cfg.vocab, seed),
                         DataConfig(batch, seq, seed), "cpu", cfg)
    out = [next(pipe)[1] for _ in range(steps)]
    pipe.close()
    return out


# phase 3's other smoke configs and the launch keys each must show: gemma2
# (local and global layers, both softcapped) and gemma3 (5 local to 1
# global, at the smoke config's hd 16)
TRAIN_SMOKE_KEYS = {
    IL_ARCH: ("matmul", "matmul:f32", "rmsnorm", "flash_attention:lse",
              "flash_attention_bwd"),
    "gemma2-27b": ("matmul", "matmul:f32", "rmsnorm",
                   "flash_attention:local+softcap+lse",
                   "flash_attention:softcap+lse",
                   "flash_attention_bwd:local+softcap",
                   "flash_attention_bwd:softcap"),
    "gemma3-12b": ("matmul", "matmul:f32", "rmsnorm",
                   "flash_attention:local+lse", "flash_attention:lse",
                   "flash_attention_bwd:local", "flash_attention_bwd"),
    # recurrentgemma's one local layer (hd 16 in the smoke config) and its
    # MLPs; xlstm's row norms alone; paligemma's global layers over the
    # patches and the text (hd 16 in the smoke config)
    PG_ARCH: ("matmul", "matmul:f32", "rmsnorm", "flash_attention:lse",
              "flash_attention_bwd"),
    RG_ARCH: ("matmul", "matmul:f32", "rmsnorm", "flash_attention:local+lse",
              "flash_attention_bwd:local"),
    XL_ARCH: ("rmsnorm",),
    # whisper: the encoder's 'full' layers (24 frames), the decoder's
    # causal ones and its cross-attention, 'full' over 24 frames from 64
    # tokens (K4's backward at Skv != Sq, hd 16), the gelu MLPs
    WH_ARCH: ("matmul", "matmul:gelu", "matmul:f32", "rmsnorm",
              "flash_attention:lse", "flash_attention:full+lse",
              "flash_attention_bwd", "flash_attention_bwd:full"),
}


def check_train_smoke(torch, arch: str = IL_ARCH):
    """Phase 3, training: ``arch``'s smoke config (fp32 masters, or
    recurrentgemma's bf16 leaves, ``TR_SMOKE_OVER``; bf16 compute,
    per-block remat) takes TR_SMOKE_STEPS AdamW steps at TR_LR (xlstm's
    ``TR_SMOKE_LR``) of TR_SMOKE_BATCH x TR_SMOKE_SEQ tokens (xlstm's
    ``TR_SMOKE_SEQS``) on the card (K1, its
    fp32 store, the row norm, K4 and its backward: every launch key of
    ``TRAIN_SMOKE_KEYS[arch]``) and on the CPU (their plain versions) from
    the same weights and batches; an fp32-compute CPU run on the same
    weights is the anchor.  The card's losses
    and grad norms lie within 4x the CPU bf16 run's own distance from the
    anchor, and the mean of |card update - CPU update| / lr within 4x the
    CPU bf16 run's own mean distance from the anchor's updates (ROADMAP's
    consistency budget)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models.lm import Model
    from repro_torch.optim import AdamWConfig

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              **TR_SMOKE_OVER.get(arch, {}))
    cpu = Model(cfg, device="cpu").init_weights(SEED)
    sd = cpu.state_dict()
    card = Model(cfg)
    card.load_state_dict(sd)
    ref32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                  device="cpu")
    ref32.load_state_dict(sd)
    batches = synthetic_batches(torch, cfg, TR_SMOKE_BATCH,
                                TR_SMOKE_SEQS.get(arch, TR_SMOKE_SEQ),
                                TR_SMOKE_STEPS, SEED)
    lr = TR_SMOKE_LR.get(arch, TR_LR)
    opt = AdamWConfig(lr=lr)
    _cuda.reset_launches()
    runs = {name: train_steps(torch, m, batches, opt)
            for name, m in (("card", card), ("cpu", cpu), ("cpu32", ref32))}
    launches = dict(_cuda.LAUNCHES)
    for key in TRAIN_SMOKE_KEYS[arch]:
        require(launches.get(key, 0) > 0,
                f"{arch} smoke training never launched {key}: {launches}")

    def dist(a, b, i):
        return max(abs(x[i] - y[i]) / abs(y[i]) for x, y in zip(a, b))

    def upd(a, b):
        return float(sum((a[k] - b[k]).abs().sum() for k in a)
                     / sum(v.numel() for v in a.values())) / lr
    (hc, dc), (hp, dp), (h3, d3) = runs["card"], runs["cpu"], runs["cpu32"]
    out = dict(losses={n: [x[0] for x in r[0]] for n, r in runs.items()},
               grad_norms={n: [x[1] for x in r[0]] for n, r in runs.items()},
               loss_err=dist(hc, h3, 0), loss_noise=dist(hp, h3, 0),
               gnorm_err=dist(hc, h3, 1), gnorm_noise=dist(hp, h3, 1),
               update_err=upd(dc, d3), update_noise=upd(dp, d3),
               update_card_cpu=upd(dc, dp), launches=launches)
    for key in ("loss", "gnorm", "update"):
        require(out[f"{key}_err"] <= 4 * out[f"{key}_noise"],
                f"{arch} smoke training: the card's {key} is "
                f"{out[key + '_err']:.3e} "
                f"from the fp32 anchor, over 4x the CPU's "
                f"{out[key + '_noise']:.3e}")
    return out


def check_train_width(torch, arch: str = IL_ARCH):
    """Phase 3, training at full width: ``arch`` cut to TR_WIDE_LAYERS
    layers (``TR_WIDE_CUTS``: a recurrent family's cut of its pattern),
    one sequence of TR_WIDE_SEQ tokens, the loss and every leaf's
    gradient on the card against the same model's CPU run at bf16 and an
    fp32-compute CPU anchor: for each leaf, max|card - anchor| over the
    anchor's scale within 4x the CPU bf16 run's own and under
    TR_WIDE_CAP, the leaves of fewer
    than TR_POOL_BELOW entries pooled into one (the backward kernels
    at real widths: internlm2's K4 backward at hd 128, G = 2, and K1's
    gradient GEMMs at d 2048 and d_ff 8192; gemma2's first two layers,
    local and global, softcapped, at hd 128 and d 4608; gemma3's first
    two, both local, at hd 256 and d 3840; recurrentgemma's (rglru,
    rglru, local) at d 4096, hd 256 and G = 16, the RG-LRU's leaves
    included; one mLSTM block and the sLSTM block of xlstm at d 1024;
    one encoder block and one decoder block of whisper, its tokens over
    the config's 1500 frames (K4's backward 'full' at Skv != Sq, hd 64);
    paligemma's first two layers, 256 patches and 256 tokens (hd 256, G =
    8); at this length no window cuts).  Each leaf's error and noise are
    returned.
    The weights are drawn on the card and copied to the CPU models, and
    the gradients compared leaf by leaf on the card at fp32: drawing 2.3
    B weights on the host and comparing them there at f64 were a large
    share of the check at gemma2's width."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.layers import full_fp32
    from repro_torch.models.lm import Model
    from repro_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(get_config(arch), **TR_WIDE_CUTS.get(
        arch, {"n_layers": TR_WIDE_LAYERS}))
    card = Model(cfg).init_weights(SEED)
    sd = {k: v.cpu() for k, v in card.state_dict().items()}
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(sd)
    ref32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                  device="cpu")
    ref32.load_state_dict(sd)
    del sd
    (batch,) = synthetic_batches(torch, cfg, 1, TR_WIDE_SEQ, 1, SEED)
    res = {}
    for name, m in (("card", card), ("cpu", cpu), ("cpu32", ref32)):
        with full_fp32():
            loss, grads = loss_and_grads(m, m.train_params(), {
                k: v.to(m.device) for k, v in batch.items()})
        res[name] = (float(loss), {k: g.detach() for k, g in grads.items()})
    def pooled(grads):     # the leaves of TR_POOL_BELOW entries or more,
        few = [k for k, g in grads.items() if g.numel() < TR_POOL_BELOW]
        out = {k: g for k, g in grads.items() if k not in few}
        if few:            # and the smaller ones as one vector
            out["+".join(few)] = torch.cat([grads[k].reshape(-1).to(
                "cuda", torch.float32) for k in few])
        return out
    card_g, cpu_g = pooled(res["card"][1]), pooled(res["cpu"][1])
    worst = []
    for key, w in pooled(res["cpu32"][1]).items():
        w = w.to("cuda", torch.float32)
        scale = max(float(w.abs().max()), 1e-30)
        err = float((card_g[key].float() - w).abs().max()) / scale
        noise = float((cpu_g[key].to("cuda", torch.float32) - w)
                      .abs().max()) / scale
        worst.append((err / max(noise, 1e-30), key, err, noise))
    worst.sort(reverse=True)
    l3 = res["cpu32"][0]
    out = dict(loss={n: r[0] for n, r in res.items()},
               loss_err=abs(res["card"][0] - l3) / abs(l3),
               loss_noise=abs(res["cpu"][0] - l3) / abs(l3),
               leaves=len(worst),
               worst_leaves=[dict(leaf=k, err=e, noise=n, ratio=r)
                             for r, k, e, n in worst[:4]],
               err_noise={k: [e, n] for _, k, e, n in worst})
    require(out["loss_err"] <= 4 * out["loss_noise"],
            f"{arch} full-width training loss: {out}")
    require(worst[0][0] <= 4, f"{arch} full-width gradients: a leaf is over "
                              f"4x the CPU's distance from the anchor: {out}")
    require(max(e for _, _, e, _ in worst) < TR_WIDE_CAP,
            f"{arch} full-width gradients: a leaf's error reaches "
            f"{TR_WIDE_CAP} of its scale: {out}")
    return out


def check_train_norm(torch):
    """Phase 3, the training row norm (``kernels.autograd.rmsnorm``: the
    row-norm kernel's forward, its backward at fp32) at the widths of
    xlstm's inner norms, N = XL_W (the mLSTM's) and XL_D (the sLSTM's and
    the stream's), on one phase-18 microbatch's rows (4 x 4096) of bf16
    values and gradients: the output bitwise the kernel's ordered mirror,
    the value's bf16 gradient within one bf16 ulp of its scale, and the
    scale's fp32 gradient (a sum over the rows) within K1_F32_TOL of its
    scale, of autograd's through the plain norm at f64 on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import autograd as ag, ref
    from repro_torch.kernels.epilogue import rms_normalize

    bf, f64 = torch.bfloat16, torch.float64
    eps_bf16 = float(torch.finfo(bf).eps)
    rows = TR_BATCH // get_config(XL_ARCH).microbatches * TR_SEQ
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    out = {}
    for n in (XL_W, XL_D):
        x = torch.randn((rows, n), generator=gen, device="cuda").to(bf)
        scale = torch.randn(n, generator=gen, device="cuda") * 0.1
        dy = torch.randn((rows, n), generator=gen, device="cuda").to(bf)
        xg, sg = x.clone().requires_grad_(), scale.clone().requires_grad_()
        y = ag.rmsnorm(xg, sg, 1e-6)
        dx, ds = torch.autograd.grad(y, (xg, sg), dy)
        require(torch.equal(y.detach(), ref.rmsnorm_rows_ref(x, scale, 1e-6)),
                f"training rmsnorm [{rows}, {n}]: the output is not bitwise "
                f"the ordered mirror")
        x64 = x.cpu().to(f64).requires_grad_()
        s64 = scale.cpu().to(f64).requires_grad_()
        wx, ws = torch.autograd.grad(rms_normalize(x64, s64, 1e-6, f64),
                                     (x64, s64), dy.cpu().to(f64))
        errs = {}
        for key, got, want in (("dx", dx, wx), ("dscale", ds, ws)):
            require(got.dtype == (bf if key == "dx" else torch.float32),
                    f"training rmsnorm [{rows}, {n}]: {key} is {got.dtype}")
            errs[key] = float((got.cpu().to(f64) - want).abs().max()
                              / want.abs().max())
        out[f"N={n}"] = errs
        require(errs["dx"] <= eps_bf16 and errs["dscale"] <= K1_F32_TOL,
                f"training rmsnorm [{rows}, {n}]: gradients {errs} over "
                f"{eps_bf16} (dx) or {K1_F32_TOL} (dscale) of their scale")
        del x, dy, xg, sg, y, dx, ds, x64, s64, wx, ws
    torch.cuda.empty_cache()
    return out


def serve_internlm2(torch):
    """Phase 13, the fault C3 repaired: internlm2-1.8b at full width and
    depth from its float32 masters, no ``param_dtype`` override: the
    entry points serve a bf16 copy of the projections (``served_blocks``;
    K1 takes bf16 x bf16), the int8 copy is quantized from the fp32
    values.  At init scales the decode witness and the int8 witness, then
    on varied weights the fixed loop bf16 and int8 (``BATCH`` x
    ``PROMPT``, ``NEW`` tokens) and the scheduler bf16 and int8 (phase 4's
    requests), each path's kernels launched and one decode iteration's
    launches counted exactly; the fixed decode step's ms beside its bytes
    bound (the bf16 projections, the fp32 embedding the logits read, the
    K/V)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models.lm import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config(IL_ARCH)
    require(cfg.param_dtype == "float32", "internlm2's masters are fp32")
    model = Model(cfg).init_weights(SEED)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(SEED + 13))
    witness = decode_witness(torch, model, toks)
    witness8 = int8_witness(torch, model, toks)
    vary(torch, model, SEED)
    out = {}
    for int8 in (False, True):
        name = "internlm2_fixed_int8" if int8 else "internlm2_fixed"
        engine = ServeEngine(model, ServeConfig(max_new_tokens=NEW,
                                                int8=int8))
        engine.generate_with_status_fixed({"tokens": toks})    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        res = engine.generate_with_status_fixed({"tokens": toks})
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        require(all(st == "ok" for st in res.status), f"{name}: statuses "
                                                      f"{res.status}")
        require(all(launches.get(k, 0) > 0 for k in PATH_KERNELS[name]),
                f"{name}: a kernel never launched: {launches}")
        require(all(len(set(lane.tolist())) > 1 for lane in res.tokens),
                f"{name}: a lane repeats one token: {res.tokens.tolist()}")
        served = engine.model
        logits, cache = served.prefill(toks, PROMPT + NEW)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(NEW - 1):
            logits, cache = served.decode_step(cache, tok, PROMPT + i)
            tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t) / (NEW - 1) * 1e3
        _cuda.reset_launches()
        served.decode_step(cache, tok, PROMPT + NEW - 1)
        step_launches = decode_launches(name, dict(_cuda.LAUNCHES), cfg,
                                        int8)
        proj = sum(w.numel() for w in model._projections())
        kv_bytes = 2 * cfg.n_layers * BATCH * (PROMPT + NEW) * cfg.kv_dim * 2
        wbytes = proj * (1 if int8 else 2) + 4 * cfg.padded_vocab() * cfg.d_model
        out[name] = dict(generate_s=gen_s, tokens_per_s=BATCH * NEW / gen_s,
                         decode_ms_per_step=dec_ms,
                         decode_bound_ms=(wbytes + kv_bytes)
                         / HBM_BYTES_PER_S * 1e3,
                         peak_bytes=torch.cuda.max_memory_allocated(),
                         launches=launches,
                         launches_per_decode_step=step_launches,
                         tokens=res.tokens.tolist())
        del engine, cache, logits, served
        torch.cuda.empty_cache()
        print(f"serve {name}: " + json.dumps(out[name]), flush=True)
    out["internlm2_fixed"].update(witness=witness, int8_witness=witness8)
    print("internlm2 witnesses: " + json.dumps(
        dict(witness=witness, tol=WITNESS_TOL, int8_witness=witness8)),
        flush=True)
    for int8 in (False, True):
        name = ("internlm2_scheduler_int8" if int8
                else "internlm2_scheduler_bf16")
        r = serve_scheduler(torch, model, int8, name=name)
        print(f"serve {name}: " + json.dumps(
            {k: v for k, v in r.items() if k != "tokens_all"}), flush=True)
        out[name] = r
    del model
    torch.cuda.empty_cache()
    return out


def model_flops_per_token(cfg, seq: int) -> float:
    """The model's FLOPs a trained token (forward and backward, 3x the
    forward; remat's recomputation not counted): twice the multiply-adds
    of every product and of the logits against the padded vocabulary.
    An attention layer: its projections, and its attention's two products
    over the keys its kind lets a query attend on average at ``seq``
    (``live_keys``: (seq + 1) / 2 for a causal layer, about the window for
    a 'local' one).  An RG-LRU: ``in_x``, ``in_g`` and ``out`` (3 d w) and
    its two fp32 gates (2 w^2).  An mLSTM (w = 2 d, H heads of hd = w / H,
    chunks of L = min(64, seq)): ``up_x``, ``up_g``, ``down`` (3 d w),
    ``wq``, ``wk``, ``wv`` (3 w^2), the gate maps (2 w H), the chunk's
    intra-chunk scores, numerator and normalizer (3 L w: every (t, s) pair
    of the chunk, as the einsums form them) and its inter-chunk products,
    q against the carried C and the carry's update (2 w hd).  An sLSTM:
    ``w_in`` (4 d^2), its block-diagonal ``r`` (4 d^2 / H) and ``out``
    (d^2).  Each block's MLP where ``d_ff`` > 0.  An encoder-decoder
    (whisper) adds each decoder layer's cross-attention, its q and out
    projections (2 d q_dim) and its two products over the F frames, and,
    spread over a clip's ``seq`` decoder tokens, the encoder's F frames
    (each layer's projections, MLP and 'full' attention over F) and each
    decoder layer's K/V products of the F frames (2 d kv_dim).  At TR_SEQ:
    internlm2 11.41 GFLOP a token, gemma3's 6 layers 14.43, gemma2's 2
    14.07, recurrentgemma's 3 (rglru, rglru, local) 10.31 (6.29 of them the
    logits), xlstm's 8 (7 mLSTM, 1 sLSTM) 1.245, whisper's 12 + 12 1.505
    (0.278 of them the encoder's frames), paligemma's 18 15.96 a position
    (its patches are positions of the sequence)."""
    from repro_torch.kernels.ref import live_keys
    from repro_torch.models.xlstm import prefill_chunk
    d = cfg.d_model
    mlp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    macs = d * cfg.padded_vocab()
    attn_flops = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.kind(i)
        if kind == "rglru":
            w = cfg.lru_width or d
            macs += 3 * d * w + 2 * w * w
        elif kind == "mlstm":
            w, nh = 2 * d, cfg.n_heads
            macs += (3 * d * w + 3 * w * w + 2 * w * nh
                     + 3 * prefill_chunk(seq) * w + 2 * w * (w // nh))
        elif kind == "slstm":
            macs += 4 * d * d + 4 * d * d // cfg.n_heads + d * d
        else:
            macs += d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
            attn_flops += 4 * cfg.q_dim * live_keys(kind, seq, cfg.window)
        if cfg.encdec:      # the cross-attention's q and out, over F keys
            macs += 2 * d * cfg.q_dim
            attn_flops += 4 * cfg.q_dim * cfg.enc_frames
        macs += mlp
    if cfg.encdec:          # a clip's encoder and cross K/V, per token
        f = cfg.enc_frames
        enc = cfg.n_enc_layers * (d * (cfg.q_dim + 2 * cfg.kv_dim)
                                  + cfg.q_dim * d + mlp)
        frame = (2 * (enc + cfg.n_layers * 2 * d * cfg.kv_dim)
                 + cfg.n_enc_layers * 4 * cfg.q_dim * f)
        attn_flops += f * frame / seq
    return 3 * (2 * macs + attn_flops)


# gemma3-12b (phase 15) and gemma2-27b (phase 16) trained at full width,
# cut to one period of their layer pattern (6 and 2 layers): the config's
# step of 8 x 4096 tokens in its microbatches (4 and 8), bf16 parameters
# and fp32 moments, per-block remat; TR_GEMMA_STEPS steps of the synthetic
# stream through ``Trainer.run`` (no checkpoint: phase 14 holds the round
# trip), then a few steps (the tuple's last entry) on one repeated batch at
# TR_GEMMA_REPEAT_LR: two steps from their init both models are still in
# the transient of their first steps (26-35 nats down to 10-12), where
# AdamW's lr-sized steps at 1e-3 or 3e-4 made gemma2's loss on the
# repeated batch rise at its second step (1e-3: 10.396, 10.924, 10.380,
# 10.462), and the plain backward in K4's place rises alike (10.395,
# 10.924, 10.380, 10.462: ``launch/repeat_lr.py``), so the optimizer, not
# the kernel, makes it; at 1e-4 it falls at every step (10.40, 10.17,
# 9.71, 8.80; gemma3 11.42, 10.45, 9.95, 9.67 on an NVIDIA H100 80GB HBM3
# at 700.00 W).  Each training phase's tuple ends with its repeated-batch
# steps: 2 (lowered from 4 for the script's time, phases 19 and 20 added;
# the loss falls by more than TR_REPEAT_DROP at the first step: gemma3
# 0.97, gemma2 0.23), and whisper's 4 (its loss fell 0.037 at the first
# step and 0.118 over four, NVIDIA H100 80GB HBM3, 700.00 W)
GEMMA_TRAIN = (("gemma3-12b", "gemma3_train", 6, 2),
               ("gemma2-27b", "gemma2_train", 2, 2))
TR_GEMMA_STEPS, TR_GEMMA_REPEAT_LR = 2, 1e-4
# recurrentgemma-9b (phase 17) and xlstm-350m (phase 18) trained at full
# width, cut to one period of their pattern: recurrentgemma's (rglru,
# rglru, local), 3 of 38 layers (1.71 B parameters, the 1.05 B embedding
# among them; bf16 leaves, its gates among them), and
# xlstm's 7 mLSTM blocks and 1 sLSTM block, 8 of 24 (0.19 B, fp32
# masters; the cut bounds the sLSTM token loop's host time, not memory);
# the gemma phases' steps and repeated-batch lr, the config's
# microbatches (4 and 2); both losses fall at every repeated step (by
# 0.30 and 0.066 at the first)
RECURRENT_TRAIN = ((RG_ARCH, "recurrentgemma_train", 3, 2),
                   (XL_ARCH, "xlstm_train", 8, 2))
# whisper-small (phase 19) trained at full width and depth (12 encoder and
# 12 decoder layers, 0.24 B fp32 masters), 8 x 4096 decoder tokens a step
# over 1500 frames a clip in the config's 2 microbatches, and paligemma-3b
# (phase 20) at full width, PG_TRAIN_LAYERS of its 18 layers (256 patches
# and 3840 tokens a sequence, 2 microbatches of 4 x 4096): the deepest
# cut whose reckoning, plus the 10-15 GB gemma's phases ran over theirs,
# stays under 72 GB.  The reckoning: 20 bytes a parameter (the fp32
# master, its two moments, the gradient accumulator and one microbatch's
# gradients, all live at the end of each backward; 50.2 GB at 2.51 B)
# and a logits chunk's fp32 logits and their gradient (4 x 512 positions
# x 257280, 4.2 GB): 54.4 GB at all 18 layers, so no layer is cut.  The
# gemma phases' steps and repeated-batch lr
PG_TRAIN_LAYERS = 18
ENCDEC_TRAIN = ((WH_ARCH, "whisper_train", None, 4),
                (PG_ARCH, "paligemma_train", PG_TRAIN_LAYERS, 2))


def train_model(torch, arch: str, name: str, layers=None, steps=TR_STEPS,
                resumed=TR_RESUMED, repeat=TR_REPEAT, repeat_lr=TR_LR):
    """One training phase at full width: ``arch``'s config (cut to
    ``layers`` layers where given), a step of TR_BATCH x TR_SEQ tokens in
    the config's microbatches, AdamW at a constant lr.  ``Trainer.run``
    takes ``steps`` steps of the synthetic stream with the launch counts
    set to 0 just before and read just after: every kernel of
    ``PATH_KERNELS[name]`` launched, K4's backward exactly once an
    attention layer and microbatch of each step (never for a model of
    recurrent mixers only; whisper's: each encoder layer, and each decoder
    layer twice, its self- and its cross-attention, the 'full' ones under
    their variant); loss and grad norm finite every step.
    With ``resumed`` steps (phase 14) it writes its checkpoint at the end,
    the uninterrupted run goes on ``resumed`` steps from its state in
    memory, the checkpoint is restored (``Trainer.restore``) and the same
    steps run again: the losses, grad norms and parameters bitwise the
    uninterrupted run's (every kernel of the step is deterministic, and
    the embedding's gradient sums its rows in a fixed order).  Then
    ``repeat`` steps on one repeated batch at lr ``repeat_lr`` (the same
    moments): the loss must fall at every step, by TR_REPEAT_DROP in all.
    Step ms, tokens/s, the model-FLOP share of 989 TFLOP/s, the peak bytes
    (under 80 GB) and the phase's seconds are returned."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenSource, TokenPipeline
    from repro_torch.kernels import _cuda
    from repro_torch.models.lm import MIXERS, Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    require((cfg.remat, cfg.opt_state_mode) == ("full", "fp32")
            and TR_BATCH % cfg.microbatches == 0,
            f"{name}: training settings {cfg}")
    model = Model(cfg)
    ckdir = tempfile.mkdtemp(prefix=f"{name}_ckpt_")
    dcfg = DataConfig(TR_BATCH, TR_SEQ, SEED)
    src = SyntheticTokenSource(cfg.vocab, SEED)

    def pipes(start):
        return TokenPipeline(src, dcfg, "cuda", cfg, start_step=start)

    opt_cfg = AdamWConfig(lr=TR_LR, state_mode=cfg.opt_state_mode)
    trainer = Trainer(model, opt_cfg, TrainerConfig(
        steps=steps, ckpt_every=steps if resumed else 0, ckpt_dir=ckdir,
        keep=1, log_every=1), pipes)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        params, opt = trainer.run(SEED)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        mets = trainer.metrics
        require([m["step"] for m in mets] == list(range(steps)),
                f"{name}: trainer steps {[m['step'] for m in mets]}")
        require(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                    for m in mets), f"{name}: non-finite metrics {mets}")
        require(all(launches.get(k, 0) > 0 for k in PATH_KERNELS[name]),
                f"{name}: a kernel never launched: {launches}")
        attn = sum(cfg.kind(i) not in MIXERS for i in range(cfg.n_layers))
        full = cfg.n_enc_layers + cfg.n_layers if cfg.encdec else 0
        bwd = (attn + full) * cfg.microbatches * steps
        require(launches.get("flash_attention_bwd", 0) == bwd
                and launches.get("flash_attention_bwd:full", 0)
                == full * cfg.microbatches * steps,
                f"{name}: {launches.get('flash_attention_bwd')} launches of "
                f"K4's backward ({launches.get('flash_attention_bwd:full')} "
                f"'full'), not {bwd} (attention layers, whisper's encoder "
                f"and cross-attention layers among them, x microbatches x "
                f"steps)")
        step_s = sorted(m["dt"] for m in mets[1:])[len(mets[1:]) // 2]
        tokens = TR_BATCH * TR_SEQ
        flops = model_flops_per_token(cfg, TR_SEQ) * tokens
        print(f"  {name} trainer: {steps} steps in {run_s:.1f} s, step ms "
              f"{step_s * 1e3:.1f}, peak {peak / 1e9:.2f} GB, metrics "
              f"{json.dumps(mets)}", flush=True)
        out = dict(params=sum(p.numel() for p in params.values()),
                   layers=cfg.n_layers, microbatches=cfg.microbatches,
                   steps=[{k: m[k] for k in ("step", "loss", "grad_norm",
                                             "dt")} for m in mets],
                   run_s=run_s, step_ms=step_s * 1e3,
                   tokens_per_s=tokens / step_s,
                   model_tflops_per_step=flops / 1e12,
                   model_flop_share=flops / step_s / BF16_FLOPS_PER_S,
                   launches=launches)

        if resumed:     # resume equal to uninterrupted
            require(trainer.ckpt.latest_step() == steps, "no checkpoint")

            def go_on(params, opt):
                it = pipes(steps)
                hist = []
                for _ in range(resumed):
                    _, batch = next(it)
                    params, opt, m = trainer.step_fn(params, opt, batch)
                    hist.append((float(m["loss"]), float(m["grad_norm"])))
                it.close()
                return params, opt, hist
            params, opt, hist_a = go_on(params, opt)
            want = {k: p.detach().clone() for k, p in params.items()}
            del params, opt
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            start, params, opt = trainer.restore()
            restore_s = time.perf_counter() - t0
            require(start == steps, f"restored step {start}")
            params, opt, hist_b = go_on(params, opt)
            diff = max(float((params[k].detach() - want[k]).abs().max())
                       for k in want)
            print(f"  resumed: restore {restore_s:.1f} s, steps {hist_b} "
                  f"against {hist_a}, params off by {diff}", flush=True)
            require(hist_a == hist_b and diff == 0.0,
                    f"resumed steps {hist_b} (params off by {diff}) != "
                    f"uninterrupted {hist_a}")
            del want
            out["resumed"] = dict(steps=hist_b, bitwise=True,
                                  restore_s=restore_s)

        # one repeated batch: the loss falls
        it = pipes(steps + resumed)
        _, batch = next(it)
        it.close()
        step_fn = make_train_step(model, AdamWConfig(
            lr=repeat_lr, state_mode=cfg.opt_state_mode))
        rep = []
        for _ in range(repeat):
            params, opt, m = step_fn(params, opt, batch)
            rep.append(float(m["loss"]))
        require(all(b < a for a, b in zip(rep, rep[1:]))
                and rep[-1] < rep[0] - TR_REPEAT_DROP,
                f"{name}: the loss on one repeated batch {rep} did not fall "
                f"at every step, by {TR_REPEAT_DROP} in all")
        peak = max(peak, torch.cuda.max_memory_allocated())
        require(peak < 80e9, f"{name}: training peak {peak / 1e9:.2f} GB")
        out.update(peak_gb=peak / 1e9, repeated_batch_losses=rep,
                   phase_s=time.perf_counter() - t_phase)
        return out
    finally:
        trainer.ckpt.wait()
        shutil.rmtree(ckdir, ignore_errors=True)
        del trainer, model
        torch.cuda.empty_cache()


SOURCES = {
    "k1_matmul": ("matmul", "src/repro_torch/csrc/matmul.cu",
                  "src/repro/kernels/matmul.py:293"),
    "k1_matmul_gemma2_m8": ("matmul", "src/repro_torch/csrc/matmul.cu",
                            "src/repro/kernels/matmul.py:293"),
    "k1_matmul_m512": ("matmul", "src/repro_torch/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:293"),
    "k1_matmul_m8320": ("matmul", "src/repro_torch/csrc/matmul.cu",
                        "src/repro/kernels/matmul.py:293"),
    "k1_rmsnorm": ("rmsnorm", "src/repro_torch/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:180"),
    "k2_int8_matmul": ("int8_matmul", "src/repro_torch/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:293"),
    "k2_int8_matmul_m512": ("int8_matmul", "src/repro_torch/csrc/matmul.cu",
                            "src/repro/kernels/matmul.py:293"),
    "k2_quantize_rows": ("int8_quantize", "src/repro_torch/csrc/matmul.cu",
                         "src/repro/kernels/matmul.py:108"),
    # the row passes in the GEMMs' store phase at decode (variants of K1's
    # and K2's launches, not launches of their own)
    "k1_matmul_norm_tail": ("matmul:norm", "src/repro_torch/csrc/matmul.cu",
                            "src/repro/kernels/matmul.py:180"),
    "k2_int8_matmul_norm_tail": ("int8_matmul:norm",
                                 "src/repro_torch/csrc/matmul.cu",
                                 "src/repro/kernels/matmul.py:180"),
    "k2_int8_matmul_quantize_tail": ("int8_matmul:quantize",
                                     "src/repro_torch/csrc/matmul.cu",
                                     "src/repro/kernels/matmul.py:108"),
    "k3_quantize": ("quantize", "src/repro_torch/csrc/matmul.cu",
                    "src/repro/kernels/quantize.py:131"),
    "k4_flash_prefill": ("flash_attention",
                         "src/repro_torch/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:331"),
    "k5_flash_decode": ("flash_decode",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:447"),
    "k6_paged_decode": ("paged_decode",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:563"),
    "k6_paged_decode_chunk": ("paged_decode:chunk",
                              "src/repro_torch/csrc/flash_attention.cu",
                              "src/repro/kernels/flash_attention.py:563"),
    "k4_flash_prefill_local_softcap": (
        "flash_attention:local+softcap",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:331"),
    "k4_flash_prefill_global_softcap": (
        "flash_attention:softcap",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:331"),
    "k5_flash_decode_softcap": (
        "flash_decode:softcap", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:447"),
    "k5_flash_decode_gemma2": (
        "flash_decode", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:447"),
    "k6_paged_decode_local_softcap": (
        "paged_decode:local+softcap",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:563"),
    "k6_paged_decode_chunk_local_softcap": (
        "paged_decode:local+softcap+chunk",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:563"),
    "k7_addertree": ("addertree", "src/repro_torch/csrc/addertree.cu",
                     "src/repro/kernels/addertree.py:59"),
    # gemma3-12b: its widths in K1 and K2, and head dim 256 in K4-K6
    "k1_matmul_gemma3_m8": ("matmul", "src/repro_torch/csrc/matmul.cu",
                            "src/repro/kernels/matmul.py:293"),
    "k1_matmul_gemma3_m512": ("matmul", "src/repro_torch/csrc/matmul.cu",
                              "src/repro/kernels/matmul.py:293"),
    "k1_matmul_gemma3_m8320": ("matmul", "src/repro_torch/csrc/matmul.cu",
                               "src/repro/kernels/matmul.py:293"),
    "k2_int8_matmul_gemma3": ("int8_matmul", "src/repro_torch/csrc/matmul.cu",
                              "src/repro/kernels/matmul.py:293"),
    "k2_int8_matmul_gemma3_m512": ("int8_matmul",
                                   "src/repro_torch/csrc/matmul.cu",
                                   "src/repro/kernels/matmul.py:293"),
    "k4_flash_prefill_hd256_local": (
        "flash_attention:local+hd256",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:331"),
    "k4_flash_prefill_hd256": (
        "flash_attention:hd256", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:331"),
    "k5_flash_decode_hd256": (
        "flash_decode:hd256", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:447"),
    "k6_paged_decode_hd256_local": (
        "paged_decode:local+hd256",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:563"),
    "k6_paged_decode_hd256": (
        "paged_decode:hd256", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:563"),
    "k6_paged_decode_chunk_hd256_local": (
        "paged_decode:local+chunk+hd256",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:563"),
    "k6_paged_decode_chunk_hd256": (
        "paged_decode:chunk+hd256",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:563"),
    # whisper-small: gelu in K1 and K2, the 'full' kind in K4 and K5
    "k1_matmul_gelu_m12000": ("matmul:gelu", "src/repro_torch/csrc/matmul.cu",
                              "src/repro/kernels/matmul.py:293"),
    "k1_matmul_gelu_m8": ("matmul:gelu", "src/repro_torch/csrc/matmul.cu",
                          "src/repro/kernels/matmul.py:293"),
    "k2_int8_matmul_gelu_m8": ("int8_matmul:gelu+quantize",
                               "src/repro_torch/csrc/matmul.cu",
                               "src/repro/kernels/matmul.py:293"),
    "k2_int8_matmul_gelu_m512": ("int8_matmul:gelu",
                                 "src/repro_torch/csrc/matmul.cu",
                                 "src/repro/kernels/matmul.py:293"),
    "k4_flash_prefill_full_encoder": (
        "flash_attention:full", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:331"),
    "k4_flash_prefill_full_cross": (
        "flash_attention:full", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:331"),
    "k5_flash_decode_full": (
        "flash_decode:full", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:447"),
    # llama4-scout: its widths in K1, the 'chunked' kind in K4 and K6, and
    # K4's 'prefix' kind
    "k1_matmul_llama4_m8": ("matmul", "src/repro_torch/csrc/matmul.cu",
                            "src/repro/kernels/matmul.py:293"),
    "k1_matmul_llama4_m512": ("matmul", "src/repro_torch/csrc/matmul.cu",
                              "src/repro/kernels/matmul.py:293"),
    "k4_flash_prefill_chunked": (
        "flash_attention:chunked", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:331"),
    "k4_flash_prefill_prefix": (
        "flash_attention:prefix+hd256",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:331"),
    "k6_paged_decode_chunked": (
        "paged_decode:chunked", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:563"),
    "k6_paged_decode_chunk_chunked": (
        "paged_decode:chunked+chunk",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:563"),
    # paligemma-3b: its widths in K1 and K2, and K4 'global' and K5 at hd
    # 256 with G = 8
    "k1_matmul_paligemma_m8": ("matmul", "src/repro_torch/csrc/matmul.cu",
                               "src/repro/kernels/matmul.py:293"),
    "k1_matmul_paligemma_m4096": ("matmul", "src/repro_torch/csrc/matmul.cu",
                                  "src/repro/kernels/matmul.py:293"),
    "k2_int8_matmul_paligemma": ("int8_matmul",
                                 "src/repro_torch/csrc/matmul.cu",
                                 "src/repro/kernels/matmul.py:293"),
    "k4_flash_prefill_paligemma": (
        "flash_attention:hd256", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:331"),
    "k5_flash_decode_paligemma": (
        "flash_decode:hd256", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:447"),
    # recurrentgemma-9b: its widths in K1 and K2, and K4 'local' at hd 256
    # with G = 16
    "k1_matmul_recurrentgemma_m8": ("matmul", "src/repro_torch/csrc/matmul.cu",
                                    "src/repro/kernels/matmul.py:293"),
    "k1_matmul_recurrentgemma_m8320": ("matmul",
                                       "src/repro_torch/csrc/matmul.cu",
                                       "src/repro/kernels/matmul.py:293"),
    "k2_int8_matmul_recurrentgemma": ("int8_matmul",
                                      "src/repro_torch/csrc/matmul.cu",
                                      "src/repro/kernels/matmul.py:293"),
    "k4_flash_prefill_recurrentgemma": (
        "flash_attention:local+hd256",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:331"),
    # xlstm-350m: the row-norm kernel at the stream's N = 1024 and the
    # mLSTM's N = 2048
    "k1_rmsnorm_xlstm_n1024": ("rmsnorm", "src/repro_torch/csrc/matmul.cu",
                               "src/repro/kernels/matmul.py:180"),
    "k1_rmsnorm_xlstm_n2048": ("rmsnorm", "src/repro_torch/csrc/matmul.cu",
                               "src/repro/kernels/matmul.py:180"),
    # grok-1: its widths in K1, K2 and K3, the row norm at N = 6144, and
    # G = 6 in K4, K5 and K6
    "k1_matmul_grok_m8": ("matmul", "src/repro_torch/csrc/matmul.cu",
                          "src/repro/kernels/matmul.py:293"),
    "k1_matmul_grok_m512": ("matmul", "src/repro_torch/csrc/matmul.cu",
                            "src/repro/kernels/matmul.py:293"),
    "k1_matmul_grok_m8320": ("matmul", "src/repro_torch/csrc/matmul.cu",
                             "src/repro/kernels/matmul.py:293"),
    "k1_rmsnorm_grok_n6144": ("rmsnorm", "src/repro_torch/csrc/matmul.cu",
                              "src/repro/kernels/matmul.py:180"),
    "k2_int8_matmul_grok": ("int8_matmul", "src/repro_torch/csrc/matmul.cu",
                            "src/repro/kernels/matmul.py:293"),
    "k3_quantize_grok": ("quantize", "src/repro_torch/csrc/matmul.cu",
                         "src/repro/kernels/quantize.py:131"),
    "k4_flash_prefill_grok": ("flash_attention",
                              "src/repro_torch/csrc/flash_attention.cu",
                              "src/repro/kernels/flash_attention.py:331"),
    "k5_flash_decode_grok": ("flash_decode",
                             "src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:447"),
    "k6_paged_decode_grok": ("paged_decode",
                             "src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:563"),
    "k6_paged_decode_chunk_grok": ("paged_decode:chunk",
                                   "src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:563"),
    # training: K4's log-sum-exp output, K4's backward (the port's own:
    # the reference differentiates its attention by XLA), K1's fp32 store
    "k4_flash_prefill_lse": ("flash_attention:lse",
                             "src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:331"),
    "k4_flash_backward": ("flash_attention_bwd",
                          "src/repro_torch/csrc/flash_backward.cu",
                          "src/repro/kernels/flash_attention.py:331"),
    "k4_flash_backward_smoke": ("flash_attention_bwd",
                                "src/repro_torch/csrc/flash_backward.cu",
                                "src/repro/kernels/flash_attention.py:331"),
    **{name: ("flash_attention_bwd", "src/repro_torch/csrc/flash_backward.cu",
              "src/repro/kernels/flash_attention.py:331")
       for name, _ in K4_BWD_ROWS},
    "k1_matmul_f32_up": ("matmul:f32", "src/repro_torch/csrc/matmul.cu",
                         "src/repro/kernels/matmul.py:293"),
    "k1_matmul_f32_down": ("matmul:f32", "src/repro_torch/csrc/matmul.cu",
                           "src/repro/kernels/matmul.py:293"),
}


def kind_row_sources():
    """The ``SOURCES`` entries of training at every kind: K4's backward
    at each row of ``K4_BWD_KIND_ROWS`` and the training forward's K4 with
    its lse at gemma's kinds, each counted under the variant key its
    wrapper counts (``k4_variants``, ``_cuda.variant_key``)."""
    from repro_torch.kernels._cuda import variant_key
    from repro_torch.kernels.flash_attention import k4_variants
    out = {}
    for name, shape, mask in K4_BWD_KIND_ROWS:
        on = k4_variants(mask["kind"], mask.get("softcap"), shape[4])
        out[name] = (variant_key("flash_attention_bwd", **on),
                     "src/repro_torch/csrc/flash_backward.cu",
                     "src/repro/kernels/flash_attention.py:331")
        tag = name[len("k4_flash_backward_"):]
        if tag in K4_LSE_KIND_ROWS:
            out["k4_flash_prefill_lse_" + tag] = (
                variant_key("flash_attention", **on, lse=True),
                "src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:331")
    return out


# numbers of some rows, carried into the kernels line: the row passes'
# CUPTI kernel times, their times at 8 and 512 rows, the launch floor, and
# a tail's cost beside the GEMM alone and the two launches it replaces;
# K1's time without the gelu beside its gelu rows
EXTRA_KEYS = ("kernel_ms", "rows", "floor_ms", "floor_wrapper_ms",
              "floor_kernel_ms", "gemm_ms", "gemm_kernel_ms", "tail_ms",
              "two_launches_ms", "two_launches_wrapper_ms",
              "two_launches_kernel_ms", "no_gelu_ms")


# rows whose launches on the driven paths are not at the row's own shape
LAUNCH_NOTES = {
    "k5_flash_decode_gemma2": "the no-softcap variant's launches, all at "
                              "granite's shapes: gemma2 runs K5 with its "
                              "softcap only",
    "k1_matmul_gelu_m12000": "every matmul:gelu launch: the encoder's at "
                             "M=12000, the decoder's prefill at M=512 and "
                             "its decode at M=8",
    "k1_matmul_gelu_m8": "every matmul:gelu launch: the encoder's at "
                         "M=12000, the decoder's prefill at M=512 and its "
                         "decode at M=8",
    "k4_flash_prefill_full_encoder": "every flash_attention:full launch: the "
                                     "encoder's and the cross-attention "
                                     "prefill's",
    "k4_flash_prefill_full_cross": "every flash_attention:full launch: the "
                                   "encoder's and the cross-attention "
                                   "prefill's",
    "k4_flash_prefill_prefix": "no model reaches the 'prefix' kind (the "
                               "reference's neither): ops.flash_attention "
                               "only, held in phase 2",
    "k4_flash_prefill_hd256": "every flash_attention:hd256 launch: gemma3's "
                              "global layers' and paligemma's",
    "k4_flash_prefill_paligemma": "every flash_attention:hd256 launch: "
                                  "gemma3's global layers' and paligemma's",
    "k5_flash_decode_hd256": "every flash_decode:hd256 launch: gemma3's "
                             "global layers' and paligemma's",
    "k5_flash_decode_paligemma": "every flash_decode:hd256 launch: gemma3's "
                                 "global layers' and paligemma's",
    "k4_flash_prefill_hd256_local": "every flash_attention:local+hd256 "
                                    "launch: gemma3's local layers' and "
                                    "recurrentgemma's",
    "k4_flash_prefill_recurrentgemma": "every flash_attention:local+hd256 "
                                       "launch: gemma3's local layers' and "
                                       "recurrentgemma's",
    "k1_rmsnorm": "every rmsnorm launch, at every width (xlstm's at N = "
                  "1024 and 2048 among them)",
    "k1_rmsnorm_xlstm_n1024": "every rmsnorm launch, at every width: "
                              "xlstm's at N = 1024 (the stream's norms and "
                              "the sLSTM's inner norm) and 2048 and the "
                              "other paths'",
    "k1_rmsnorm_xlstm_n2048": "every rmsnorm launch, at every width: "
                              "xlstm's at N = 1024 and 2048 (the mLSTM's "
                              "inner norm) and the other paths'",
    "k1_rmsnorm_grok_n6144": "every rmsnorm launch, at every width: grok's "
                             "at N = 6144 and the other paths'",
    "k4_flash_prefill_grok": "every flash_attention launch with no "
                             "variant: grok's and the other paths'",
    "k5_flash_decode_grok": "every flash_decode launch with no variant: "
                            "grok's and the other paths'",
    "k6_paged_decode_grok": "every paged_decode launch with no variant: "
                            "grok's and the other paths'",
    "k6_paged_decode_chunk_grok": "every paged_decode:chunk launch: grok's "
                                  "and the other paths'",
    "k3_quantize_grok": "every quantize launch: grok's int8 paths' and the "
                        "other paths'",
    "k4_flash_backward": "every flash_attention_bwd launch of the training "
                         "path (phase 14, internlm2 at 4 x 4096)",
    "k4_flash_backward_smoke": "every flash_attention_bwd launch of phase "
                               "3's smoke training on the card, at this "
                               "row's shape (its counts set to 0 just "
                               "before it)",
    **{name: "every flash_attention_bwd launch of the training path "
             "(phase 14, internlm2 at 4 x 4096); this row's shape is held "
             "in phase 2 only" for name, _ in K4_BWD_ROWS},
    "k1_matmul_f32_up": "every matmul:f32 launch of the training paths "
                        "(internlm2, gemma3, gemma2, recurrentgemma): the "
                        "weight gradients of all seven GEMMs (recurrentgemma"
                        "'s local layer and MLPs) and the up GEMM's "
                        "recomputed gate input",
    "k1_matmul_f32_down": "every matmul:f32 launch of the training paths "
                          "(internlm2, gemma3, gemma2, recurrentgemma): the "
                          "weight gradients of all seven GEMMs "
                          "(recurrentgemma's local layer and MLPs) and the "
                          "up GEMM's recomputed gate input",
    "k4_flash_backward_gemma3_local": "the flash_attention_bwd:local+hd256 "
                                      "launches of gemma3's training path "
                                      "(phase 15) alone; recurrentgemma's "
                                      "are its own row's",
    "k4_flash_prefill_lse_gemma3_local": "the flash_attention:local+hd256"
                                         "+lse launches of gemma3's "
                                         "training path (phase 15) alone",
    "k4_flash_backward_recurrentgemma": "the flash_attention_bwd:local+hd256 "
                                        "launches of recurrentgemma's "
                                        "training path (phase 17), at this "
                                        "row's shape: its local layer, 2 x "
                                        "4096 a microbatch, G = 16",
    "k4_flash_prefill_lse_recurrentgemma": "the flash_attention:local+hd256"
                                           "+lse launches of recurrentgemma"
                                           "'s training path (phase 17), at "
                                           "this row's shape",
    "k4_flash_backward_paligemma": "every flash_attention_bwd:hd256 launch: "
                                   "gemma3's global layers' (phase 15) and "
                                   "paligemma's (phase 20, at the "
                                   "paligemma_train row's shape); this "
                                   "row's shape (8 x 512) is held in phase "
                                   "2 only",
    "k4_flash_backward_paligemma_train": "the flash_attention_bwd:hd256 "
                                         "launches of paligemma's training "
                                         "path (phase 20) alone, at this "
                                         "row's shape",
    "k4_flash_prefill_lse_paligemma_train": "the flash_attention:hd256+lse "
                                            "launches of paligemma's "
                                            "training path (phase 20) alone, "
                                            "at this row's shape (remat's "
                                            "recompute among them)",
    "k4_flash_backward_gemma3_global": "the flash_attention_bwd:hd256 "
                                       "launches of gemma3's training path "
                                       "(phase 15) alone; paligemma's are "
                                       "its own row's",
    "k4_flash_prefill_lse_gemma3_global": "the flash_attention:hd256+lse "
                                          "launches of gemma3's training "
                                          "path (phase 15) alone",
    "k4_flash_backward_llama4_chunked": "no path trains a chunked layer yet "
                                        "(llama4's training slice): held in "
                                        "phase 2 only",
    **{name: "every flash_attention_bwd:full launch of whisper's training "
             "path (phase 19): its 12 encoder layers' (Sq = Skv = 1500, 4 "
             "clips a microbatch) and its 12 cross-attention layers' (4 x "
             "4096 decoder tokens over 1500 frames)"
       for name in ("k4_flash_backward_whisper_full",
                    "k4_flash_backward_whisper_cross_train",
                    "k4_flash_backward_whisper_cross_prefill",
                    "k4_flash_backward_whisper_cross_ragged")},
    "k4_flash_prefill_lse_whisper_cross_train": "every flash_attention:full"
                                                "+lse launch of whisper's "
                                                "training path (phase 19): "
                                                "its encoder's and its "
                                                "cross-attention's, remat's "
                                                "recompute among them",
    "k4_flash_backward_prefix_hd256": "no model trains the 'prefix' kind "
                                      "(the reference's neither): held in "
                                      "phase 2 only",
}


# rows whose launches are one path's alone: a shape that runs on a path
# outside PATH_KERNELS (phase 3's smoke training), and the variants two
# training paths share at their own shapes (K4 and its backward 'local'
# at hd 256: gemma3's local layers, recurrentgemma's; global at hd 256:
# gemma3's global layers, paligemma's)
OWN_PATH = {"k4_flash_backward_smoke": "train_smoke",
            "k4_flash_backward_gemma3_local": "gemma3_train",
            "k4_flash_prefill_lse_gemma3_local": "gemma3_train",
            "k4_flash_backward_recurrentgemma": "recurrentgemma_train",
            "k4_flash_prefill_lse_recurrentgemma": "recurrentgemma_train",
            "k4_flash_backward_gemma3_global": "gemma3_train",
            "k4_flash_prefill_lse_gemma3_global": "gemma3_train",
            "k4_flash_backward_paligemma_train": "paligemma_train",
            "k4_flash_prefill_lse_paligemma_train": "paligemma_train"}


def variant_launches(counts, counter):
    """Launches of one variant: a ``"<kernel>:<variant>"`` key as counted;
    a bare kernel name counts the launches with no variant on (every
    launch adds to its kernel's key and to at most one variant key)."""
    if ":" in counter:
        return counts.get(counter, 0)
    return counts.get(counter, 0) - sum(
        n for key, n in counts.items() if key.startswith(counter + ":"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = t0 = time.perf_counter()
    libs = _cuda.build_all()
    print(f"card: {card}; built {sorted(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, so in libs.items():   # registers, shared memory, spills
        for line in _cuda.ptxas_report(so):
            print(f"  ptxas {name}: {line}")

    marks = [("build", time.perf_counter())]
    timer = Timer(torch)
    cupti = []     # (row, key, call): CUPTI kernel times, the last phase
    floor = launch_floor(timer, cupti)
    print("  launch floor " + json.dumps(floor), flush=True)
    kernels = check_kernels(torch, timer)
    kernels.update(check_row_passes(torch, timer, floor, cupti))
    kernels.update(check_row_tails(torch, timer, cupti))
    kernels.update(check_int8_kernels(torch, timer))
    kernels.update(check_paged_kernel(torch, timer))
    wide = check_wide_groups(torch)
    print("  wide groups " + json.dumps(wide), flush=True)
    print("  chunk head dims " + json.dumps(check_chunk_head_dims(torch)),
          flush=True)
    kernels.update(check_gemma2_kernels(torch, timer))
    kernels.update(check_gemma3_kernels(torch, timer))
    kernels.update(check_whisper_kernels(torch, timer))
    kernels.update(check_llama4_kernels(torch, timer))
    kernels.update(check_paligemma_kernels(torch, timer))
    kernels.update(check_recurrentgemma_kernels(torch, timer))
    rglru_plain = rglru_rows(torch, timer)
    kernels.update(check_xlstm_kernels(torch, timer, cupti))
    xlstm_plain = xlstm_rows(torch, timer, cupti)
    kernels.update(check_grok_kernels(torch, timer, cupti))
    t0 = time.perf_counter()
    kernels.update(check_train_kernels(torch, timer))
    print(f"training kernels ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    kernels.update(check_train_kind_rows(torch, timer))
    print(f"training kernels at every kind ({time.perf_counter() - t0:.1f} "
          f"s)", flush=True)
    t0 = time.perf_counter()
    sampler = check_sampler(torch, timer)
    print(f"sampler ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(sampler), flush=True)
    del timer
    torch.cuda.empty_cache()
    marks.append(("kernels", time.perf_counter()))
    print("kernels: " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != "shapes"}
         for k, v in kernels.items()}), flush=True)
    smoke = check_smoke_path(torch)
    print("smoke: " + json.dumps(smoke), flush=True)
    for arch, over in (("gemma2-27b", {}), ("gemma3-12b", {"head_dim": 256}),
                       (L4_ARCH, {}), (GK_ARCH, {})):
        smoke_local = check_local_smoke(torch, arch, **over)
        print(f"smoke {arch}: " + json.dumps(smoke_local), flush=True)
    for arch, over in ((WH_ARCH, {}), (PG_ARCH, {}),
                       (RG_ARCH, {"param_dtype": "bfloat16"}),
                       (XL_ARCH, {})):
        print(f"smoke {arch}: "
              + json.dumps(check_fixed_smoke(torch, arch, **over)),
              flush=True)
    t0 = time.perf_counter()
    smoke_train = check_train_smoke(torch)
    print("smoke training: " + json.dumps(smoke_train), flush=True)
    print("full-width 2-layer gradients: "
          + json.dumps(check_train_width(torch)), flush=True)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    for arch, *_ in GEMMA_TRAIN + RECURRENT_TRAIN + ENCDEC_TRAIN:
        t0 = time.perf_counter()
        print(f"smoke training {arch}: "
              + json.dumps(check_train_smoke(torch, arch)), flush=True)
        print(f"full-width gradients {arch}: "
              + json.dumps(check_train_width(torch, arch)), flush=True)
        if arch == XL_ARCH:
            print("training row norm at xlstm's widths: "
                  + json.dumps(check_train_norm(torch)), flush=True)
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    marks.append(("smoke", time.perf_counter()))
    serve = serve_full(torch)
    serve["addertree"] = addertree_path(torch)
    print("addertree path: " + json.dumps(serve["addertree"]), flush=True)
    marks.append(("granite", time.perf_counter()))
    serve.update(serve_long(torch, "gemma2-27b", "gemma2", G2_BATCH,
                            G2_PROMPT, G2_NEW, G2_REQ, release_int8=True))
    marks.append(("gemma2", time.perf_counter()))
    serve.update(serve_long(torch, "gemma3-12b", "gemma3", G3_BATCH,
                            G3_PROMPT, G3_NEW, G3_REQ, int8s=(False, True)))
    marks.append(("gemma3", time.perf_counter()))
    serve.update(serve_whisper(torch))
    marks.append(("whisper", time.perf_counter()))
    serve.update(serve_llama4(torch))
    marks.append(("llama4", time.perf_counter()))
    serve.update(serve_paligemma(torch))
    marks.append(("paligemma", time.perf_counter()))
    serve.update(serve_recurrentgemma(torch, rglru_plain))
    marks.append(("recurrentgemma", time.perf_counter()))
    serve.update(serve_xlstm(torch, xlstm_plain))
    marks.append(("xlstm", time.perf_counter()))
    serve.update(serve_grok(torch))
    marks.append(("grok", time.perf_counter()))
    serve.update(serve_internlm2(torch))
    marks.append(("internlm2", time.perf_counter()))
    train = train_model(torch, IL_ARCH, "internlm2_train")
    serve["internlm2_train"] = {"launches": train["launches"]}
    print("train internlm2: " + json.dumps(train), flush=True)
    marks.append(("train", time.perf_counter()))
    # phases 15-20
    for arch, name, layers, repeat in (GEMMA_TRAIN + RECURRENT_TRAIN
                                       + ENCDEC_TRAIN):
        train = train_model(torch, arch, name, layers=layers,
                            steps=TR_GEMMA_STEPS, resumed=0, repeat=repeat,
                            repeat_lr=TR_GEMMA_REPEAT_LR)
        serve[name] = {"launches": train["launches"]}
        print(f"train {arch} ({train['phase_s']:.1f} s): "
              + json.dumps(train), flush=True)
        marks.append((name, time.perf_counter()))
    cupti_pass(torch, cupti)
    marks.append(("cupti", time.perf_counter()))
    print("xlstm plain, with CUPTI kernel times: " + json.dumps(xlstm_plain),
          flush=True)
    print("phase times: " + ", ".join(
        f"{name} {t - t_prev:.1f} s" for (name, t), (_, t_prev)
        in zip(marks, [(None, t_start)] + marks[:-1])), flush=True)
    for k in kernels.values():
        if "floor_ms" in k:
            k["floor_kernel_ms"] = floor["kernel_ms"]

    runs = {"train_smoke": smoke_train, **serve}
    own = {path: runs[path]["launches"] for path in set(OWN_PATH.values())}
    SOURCES.update(kind_row_sources())
    line = []
    for name, (counter, source, replaces) in SOURCES.items():
        k = kernels[name]
        # launches on the driven paths (each path's counts were set to 0
        # just before it) of this row's variant only
        paths = ({OWN_PATH[name]: own[OWN_PATH[name]]} if name in OWN_PATH
                 else {path: serve[path]["launches"] for path in PATH_KERNELS})
        launches = {path: variant_launches(counts, counter)
                    for path, counts in paths.items()}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(launches.values()),
                     "launches_by_path": launches,
                     **({"launches_note": LAUNCH_NOTES[name]}
                        if name in LAUNCH_NOTES else {}),
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "wrapper_ms": k["wrapper_ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"],
                     **({"library_note": k["library_note"]}
                        if "library_note" in k else {}),
                     "max_row_err": k["max_row_err"], "tol": k["tol"],
                     **{key: k[key] for key in EXTRA_KEYS if key in k},
                     "work": k["work"]})
    print(f"total {time.perf_counter() - t_start:.1f} s, the build included",
          flush=True)
    print(json.dumps({"kernels": line, "launch_floor": floor}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # report the failing phase, exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
