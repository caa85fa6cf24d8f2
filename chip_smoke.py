#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card (nvidia-smi name and power limit) and the kernel build:
     every ``csrc/*.cu`` of ``repro_torch`` compiled with nvcc into
     ``build/repro_torch/``, one nvcc per source, all at once;
  2. each kernel against its plain version on the card, bit for bit:
     ragged shapes (K=3 and M<=16 included) at every listed ``levels``,
     then every distinct GEMM shape of a VGG-16 forward at batch 8, each
     timed (CUDA events) beside its plain version, its bound and
     ``torch._int_mm`` on the unstacked operands (B1-B3 also as
     ``kernel_ms``, over back-to-back launches; B2 and B3 as
     ``device_ms``, the profiler's device time of the kernel alone).  2a/2b kernel B1 (the
     level-stacked GEMM) on both of its routes: prefix tables (the
     collapsed products) at every ``levels`` and the one-level slabs of
     the early-exit loop (plane pairs) at every ``first_level``, with B
     K-major (the weight cache's layout) and row-major, ragged M, N, K
     and the split-K FC shapes included; 2c/2d kernel B2 (the per-level
     snapshot stream; also ``level_count`` and ``out=``; B K-major, the
     weight cache's layout that the model passes, and row-major), 2e/2f
     kernel B3 (the pair loop); 2g the host time of one wrapper call of
     B1, B2 and B3 at fc8's shape.  The ragged checks (2a, 2c, 2e) run the
     int8 configs and the wide ones (WIDE_CONFIGS: (6, 2) and (7, 1), D =
     3 and 7 on B2's tensor cores; (12, 4), (16, 4), (16, 2) and (16, 1),
     int16 planes with D 3-16 on the int16 entries of B1-B3: B1's and
     B3's on the tensor cores through the byte split, B2's on the CUDA
     cores); 2h times
     each wide config at fc8 (M 8, K 4096, N 1000) for B1, B2 and B3 bit
     for bit beside its plain version, its bound (an int16 product as four
     int8 products) and torch._int_mm (int8 configs; none for int16);
  3. VGG-16 at its published width (224x224, 1000 classes, seeded
     He-normal weights) serving 3 batches of 8 images through
     ``vgg16_apply(..., l2r=QuantConfig())``: 120 B1 launches per
     forward, finite logits equal bit for bit to the same forward with
     the plain GEMM, and top-1 agreement with the float forward (TF32 off);
  4. the same 3 batches through ``vgg16_classify_progressive`` with
     ``early_exit`` False (119 B1 + 1 B2 launches per forward) and True
     (119 B1 + at most 7 B1 level launches): classes equal
     ``argmax(vgg16_apply)``, scan logits bit-identical to it, classes
     and exit levels identical between the two control flows, and the
     early-exit logits bit-identical to the scan's prefix after the
     levels the loop ran;
  5. the pair-loop path: the FC head (fc6-fc8) through
     ``l2r_matmul_f(..., schedule="pairs")``, 3 B3 launches per forward,
     bit-identical to the stacked schedule;
  6. a decisive-margin prototype head (k=4096, 1000 classes, 256 rows)
     through ``streaming_argmax``, scan against while;
  7. ``l2r_conv2d_progressive`` on full-width conv1_2 and conv4_2 at
     batch 8: plane l equals the conv at ``levels=l+1``, and each plane
     lies within its tail bound of the last;
  8. kernel B6 (the PE-array CIPU simulator): ragged cases bit for bit
     against its plain version and the integer SOP, then one VGG-16
     layer's SOP windows as the paper's 8x8 array runs them (conv4_2:
     25,690,112 SOPs of k=72, n=8) through ``simulate_pe_array``, every
     SOP equal to the plain cycle simulation and to the integer SOP,
     timed beside the paper's cycle count for the layer (its 45 nm
     accelerator model, not a card number);
  9. the golden model (examples/quickstart.py acts 1 and 5): one SOP of
     k=72 through ``simulate_cipu`` on the card equals the exact SOP; the
     paper's Table II figures from ``hw_model``;
 10. kernel B5 (float flash attention) through ``ops.flash_attention``
     and 11. kernel B4 (level-walk scores) through
     ``flash_attention_l2r``: ragged cases (causal, window, GQA, Sq !=
     Skv; B4 at levels 1, 3 and full) in f32 and bf16 against the plain
     versions (f32 within 3e-5; bf16 within one ulp, 2^-7 |ref|, plus
     ``BF16_ABS``), then SmolLM-135M's attention (H=9, Kv=3, dh=64) at a
     2048-token prefill, batch 8 (causal f32, causal bf16, window 512
     f32), timed beside the plain version, the bound and
     ``scaled_dot_product_attention``; both also as ``kernel_ms``, 10
     back-to-back launches between two CUDA events (B4's on operands
     quantized beforehand, the launch alone), beside the wrapper's
     ``ms``.  Once, at the causal bf16 shape,
     a plain version without the rounding of p to bf16 must fail the
     bf16 limit: the limit sees that rounding.  10c / 11c the wide
     routes at full width (B 8, S 2048, causal): B5 f32 and bf16 at
     recurrentgemma-2b's local attention (H 10, Kv 1, dh 256, window
     2048: the wide layout, each score once), B4 bf16 there on int8 q, k
     and at SmolLM-135M's
     shape on int16 q, k (n_bits 12 and 16, radix 16), each one launch
     within ATTN_TOL of its plain version, timed beside it, the bound and
     SDPA;
 12. the FC head's 7x7 resize (models/resize.py, the reference's
     ``jax.image.resize`` bits): on the card equal to the CPU bit for
     bit at every final map size 2-14, C = 512, batches 1 and 8, and
     fc6's quantized input equal at the 8x8 map (a 256x256 image);
 13. SmolLM-135M at its published width (30 layers, d 576, vocab 49152,
     seeded random weights), L2R at full depth, bf16 compute, served
     through ``prepare_params``, ``make_prefill_step`` and
     ``make_decode_step``: 13a a prefill of 8 x 2048 tokens (181 B1 and
     30 B5 launches, nothing else) and 32 greedy decode steps (181 B1
     launches each, nothing else), finite logits, tokens in range;
     prefill ms, decode ms/token and tokens/s beside the card, and a
     ``torch.profiler`` breakdown of a decode step and of the prefill;
     13b with B5 swapped for its plain version, the model on B1 equal bit
     for bit to the model on the plain GEMM (8 x 256 prefill + 4 decode
     steps at full depth, prefill + 1 step at levels=5); 13c the
     prefill's last-position hidden states with B5 against its plain
     version, required within what B5's bf16 limit (one output ulp)
     spent at every element of every layer moves them, with the logits'
     max |d| and the share of equal greedy tokens; 13d B1 at the LM's
     shapes (decode M = 8, the head, prefill M = 16384), bit for bit,
     timed beside its bound, its plain version and ``torch._int_mm``;
 14. the same model with digit-serial attention as well
     (``attn_l2r=QuantConfig()``, full depth; f32 cache): 14a a prefill
     of 8 x 2048 tokens (181 B1 and 30 B4 launches, no B5, nothing else)
     filling the plane-stacked key cache, and 32 greedy decode steps
     walking it (181 B1 launches each, nothing else), timed and profiled
     as 13a, with peak memory; 14b every layer's plane cache after the
     prefill and the decode steps equal bit for bit to re-extraction from
     the float key cache; 14c the prefill's last-position hidden states
     with B4 against its plain version, within what B4's bf16 limit spent
     at every element of every layer moves them; 14d 8 decode steps with
     ``attn_early_exit`` at tolerances 1e-4 and 10.0: per-layer
     exit-level histograms (``attn_exit_tap``), the loose walk never
     later than the tight one on the same inputs, and the tokens equal to
     the full-depth run's (printed, not required: random weights).
 15. the same model as 13, served progressively (``progressive=True``,
     the head streamed most significant level first): 15a a prefill of
     8 x 2048 tokens (180 B1, 30 B5 and 1 B2 launches, nothing else) and
     32 decode steps (180 B1 and 1 B2 each), tokens and logits bit for bit
     phase 13's, the streamed head equal to ``logits_from_hidden`` on the
     same hidden states with no copy of the head's plane stack (peak
     memory of one head call), ms/token, the exit-level histograms and a
     profile of one step; 15b the same with early exit: tokens and exit
     levels equal 15a's, 180 B1 launches plus one per level walked (the
     largest exit level + 1) a call; 15c kernel B2 at the LM head's shapes
     (K 576, N 49152, M 1 / 4 / 8, full depth and 5 levels) on the head
     cache's K-major view, bit for bit against its plain version, timed
     beside its bound and ``torch._int_mm``; 15d bucketed == unbucketed
     prefill bit for bit (k, v, positions of every layer; prompts of 300
     and 1500 tokens in buckets 512 and 2048); 15e 16 requests (numpy seed
     150: prompts of 16-2048 tokens, 16-32 new tokens, classes exact /
     budget(3) / bounded in turn) through ``ContinuousBatcher`` and
     ``ServingGateway`` (8 slots, max_len 2080, early exit, prefill group
     4): the gateway's tokens, exit levels and prefill exit levels equal
     the batcher's; tokens/s, TTFT and TPOT, warmup per bucket; each
     request's solo run (batch 1, first 8 tokens) compared and printed;
     15f ``launch/serve.py --wq``, ``--wq --gateway`` and ``--l2r
     --gateway`` at full width for 4 steps, and the prepared tree saved
     and loaded (``checkpoint/quantized.py``) equal bit for bit, serving
     the same tokens.
 16. the other mixers at their published widths, batch 8, L2R at full
     depth, bf16 compute, f32 caches and states, seeded random weights,
     served greedily through ``make_prefill_step`` and
     ``make_decode_step``: mamba2-130m (24 SSD layers, raw params: 49 B1
     a prefill of 8 x 2048 tokens and a step), recurrentgemma-2b (26
     RG-LRU / local layers, raw: 139 B1 a prefill and a step, 8 B5 a
     prefill at head_dim 256; its prefill also profiled on the plain
     chunk loop, B5's dispatch switched off), deepseek-moe-16b cut to 4
     layers (one dense, 3 MoE of 64 experts top-6 + 2 shared; prepared:
     412 B1 a prefill and a step, 4 B5 a prefill) and whisper-base (6 +
     6 layers, 1500 seeded frames, 128-token prompts, raw: 97 B1 + 18 B5
     a prefill, 49 B1 + 6 B5 a step); 16a each serving run's launches
     exact on every call, 32 steps, prefill ms, decode ms/token,
     tokens/s, peak memory and a profile of a prefill and a step; 16b
     the logits on B1 equal bit for bit to the plain GEMM's (256-token
     prompts, whisper 128, 2 steps; B5 swapped for its plain version in
     both runs; mamba2 also at levels=5); 16c two decode steps against
     the train forward (f32, the float path, the reference specs' limits
     5e-2 and 1e-4; whisper's steps without frames); 16d the RG-LRU scan
     and the MoE routing on the card equal to the CPU's bits, and a MoE
     layer's two runs on the card identical; 16e B5 at whisper's shapes
     (S 1500; cross Sq 128 and 1 over 1500 keys) within its limits,
     timed; 16f B1 at mamba2's in_proj and deepseek's expert shapes,
     bit for bit, timed.
 17. training: 17a SmolLM-135M at its published widths (30 layers, d
     576, 9 / 3 heads of 64, vocab 49152; f32 compute, seeded random
     weights) trained 8 steps of ``make_train_step`` (remat, cross-entropy
     chunks of 512, AdamW) at batch 8 x 2048 on the data pipeline's
     structured stream: 60 B5 launches a step exactly (the forward and
     remat's recompute; the backward is the plain loop's gradient),
     finite losses, every leaf moved; warm step ms, tokens/s, peak memory
     and a profile of a step; 17b one step from there with B5 against the
     same step with B5's plain version: loss, grad norm, each leaf's
     gradient and update within TRAIN_B5_TOL on the weights rescaled to
     their width (``fan_in_scaled``; the reading on 17a's own weights
     printed beside it), every leaf's gradient finite and non-zero; 17c one step of each of the ten smoke configs on the
     card against the CPU (gradients, params, loss; the params moved);
     17d B5 and B4 with their gradients at fault C2's input (1, 8, 1, 64)
     and SmolLM-135M's shape, f32 and bf16: the gradient equal to the
     plain route's on the card (C2's input also to the CPU's), forward +
     backward timed beside the plain route's, the backward's device time,
     and SDPA's forward + backward (printed, not held).
 18. the consensus level walk on a 2 x 2 (data x model) mesh: four ranks
     of one gloo process group (``launch/mesh.py:spawn_local``), all on
     the one card (four processes sharing it, not a multi-GPU figure),
     each loading the libraries phase 1 built; the backbones replicated,
     the heads split by class.  18a VGG-16 as phase 3 (224x224, batch 8,
     1000 classes, the same weights and 3 batches), fc8's cache 500
     classes a rank, classified with the scan (119 B1 + 1 B2 a forward a
     rank, B2 at N 500 on the rank's 4 rows) and with early exit (119 B1
     + one per level run); 18b SmolLM-135M as phase 15 with the head
     cache 24,576 columns a rank (half of phase 15's bytes): a 8 x 2048
     progressive prefill and 8 decode steps with the scan and with early
     exit (launches as 15a/15b a rank), then the gateway over 15e's
     requests; 18c on every rank: each walk's collectives equal to the
     count the code derives (``sharded_walk_collectives``), each walk's
     head input identical on every rank (a MAX and a MIN all-reduce of a
     checksum), B2 and B1's level slabs at the rank's shard shapes bit
     for bit against their plain versions (each slab timed beside its
     bound).  Classes, levels and logits
     equal phase 4's, tokens, levels and logits 15a/15b's, the gateway's
     tokens, levels and stats 15e's, bit for bit on every rank; prefill
     ms, decode ms a token, the walk's ms a step and the collectives'
     share of it, peak memory, per rank.
 19. the data-parallel half of the mesh on phase 18's 2 x 2 mesh (four
     gloo ranks sharing the card).  19d first, on the card alone: B1 at
     the ranks' decode rows (M 4) and dp-local expert buffers (M 480),
     B2 at a rank's head walk (M 4, N 24,576), B5 at batch 4 (19a's f32
     forward, 19c's bf16 prefill), against their plain versions, timed
     beside their bounds and torch._int_mm / SDPA.  19a SmolLM-135M as
     17a (seed 170, f32, remat) trained 2 steps of ``make_train_step(
     mesh=)`` on the pipeline's global batches 8 x 2048 (4 a data rank),
     the params split per param_specs over "model" (the attention
     gathered: 2 does not divide the 3 kv heads) and the residual's
     sequence too, the optimizer state ZeRO-1: 60 B5 launches a step a
     rank, the loss, the grad norm and the leaves held whole identical on
     every rank and the split leaves on every rank of a data group (MAX /
     MIN all-reduce of a checksum),
     each rank's m / v bytes its zero1_specs share; the losses and grad
     norms beside 17a's (printed), and one step from the width-rescaled
     weights within TRAIN_B5_TOL of the one-process step (rank 0 runs
     both); step ms, the collectives' ms, peak memory and param bytes.
     19b 15e's requests through ``ContinuousBatcher(state_sharding=
     "batch")``, 8 slots, 4 a data rank: tokens, exit levels, prefill
     exit levels, stats and launches equal 15e's batcher, each rank's
     slot state half of 15e's bytes.  19c deepseek-moe-16b as phase 16
     (4 layers, prepared) with ``moe_dp_local``, the head split by
     vocabulary and the routed experts by model rank (half the expert
     bytes a rank): an 8 x 2048 prefill of the rank's 4 rows and 2 greedy
     steps, launches as phase 16's, 6 all-to-alls, 5 gathers and 3 sums a
     call, the same tokens on every rank, and the first MoE layer's
     group output equal bit for bit to ``moe_apply`` without a mesh on
     that group's tokens with the whole expert stacks.
 20. the tensor-parallel half of the mesh.  20d first, on the card
     alone: B1 at the column and row products of SmolLM-135M split 3
     ways and deepseek-moe-16b split 2 ways (bit for bit its plain
     version; a row product's K-split partials summed through int64
     equal to the whole K's), B2 and B1's level slabs at 20a's head walk
     (M 8, N 16,384), B5 on a rank's heads (SmolLM 3 / 1 of 64 bf16 and
     f32 at 8 x 2048, deepseek 8 / 8 of 128 at 4 x 2048) bit for bit
     those heads of the whole call and within ATTN_TOL of its plain
     version, decode attention on a rank's heads equal to them in the
     whole batch; each timed beside its bound and torch._int_mm / SDPA.
     Then three gloo ranks on a 1 x 3 (data x model) mesh sharing the
     card: 20a phase 13's model prepared and cut by ``shard_params`` (3 of
     9 q heads, 1 of 3 kv heads, 512 of 1536 ffn columns, 16,384 of the
     vocabulary), 15e's requests through ``ContinuousBatcher(
     state_sharding="specs")``: tokens, exit levels, prefill exit levels
     and stats equal 15e's batcher bit for bit on every rank, a third of
     its KV bytes, its backbone bytes its param_specs share, launches as
     15e's, the collectives as ``split_collectives`` derives beside the
     walks'; 20b 17a's model (f32, remat, seed 170) trained 1 step of
     the split ``make_train_step(mesh=)`` at 8 x 2048 (the sequence stays
     whole: 3 does not divide 2048): 60 B5 a step a rank, the loss, the
     grad norm and the leaves held whole (the norms) the same on every
     rank, one step from the width-rescaled
     weights within TRAIN_B5_TOL of one process; step ms, the
     collectives' share, peak memory.  Then four ranks on the 2 x 2 mesh:
     20c deepseek-moe-16b as phase 16 (4 layers, prepared) cut by
     ``shard_params`` (8 of 16 heads, 32 of 64 experts, layer 0's d_ff
     5,472, half the vocabulary a model rank), its 8 x 2048 prefill (4
     rows a rank) and 2 greedy steps with "specs"-layout state: phase
     16's tokens and the prefill's last-position logits (a checksum) bit
     for bit, launches and collectives as derived, expert and backbone
     bytes a rank.
 22. the exactness, compiled and collective audits (analysis/lint.py's
     passes, in this process; nothing caught): 22a every registered entry
     but the split ones under the taint walk, the ``cuda`` entries on the
     card with B1 (stacked) and B2 (streaming) each one kernel node and
     the result equal to the CPU run bit for bit, and the ``pairs``
     schedule on the card as one B3 node (the reference registers pairs
     on ``jnp`` only), launches exact; 22b every certificate and
     ``audit_registry``'s 20 rows sound; 22c 15e's gateway (every bucket
     and the decode step warmed, no prefill past the buckets) and the
     batchers of 15e, 19b and 20a, whose second step is the in-place
     state audit; 22d the collectives recorded inside the ranks of phases
     18, 20 and 21: every full-width consensus walk against the port's
     contract, 20a's and 21d's whole runs and 20c's and 21a-c's calls
     against the counts the code derives (no undeclared gather, no float
     SUM but 20c's router means), and the registered split entries on
     phase 18's 2 x 2 mesh at the registry's shapes.
 23. the dry run and the examples: 23a launch/dryrun.py's meta steps
     (no launch: the meta device) against this run's card: 13a's
     prepared params and f32 state bytes equal the live tensors' exactly,
     the predicted peaks of 13a's prefill and 17a's training step printed
     beside ``torch.cuda.max_memory_allocated`` with their ratio (not
     gated), the roofline bound of 13a's prefill beside its measured
     time; for each rank of phase 21's mamba2-130m, recurrentgemma-2b
     and whisper-base the params and state bytes (held_layouts,
     engine.local_state) equal phase 21's and the meta prefill's
     collectives equal the rank's records one for one.  23b the nine
     examples of examples/torch/ in parallel processes (started before
     23a), each with ``--device cuda`` (train_smollm ``--steps 100``):
     exit 0 within EXAMPLE_TIMEOUT_S and the kernels each reaches
     launched (EXAMPLE_KERNELS); each one's seconds and the phase's.
     23a also captures 17a's step and rank 0's split prefills for 24.
 24. the compiled-graph layer (launch/graph_analysis.py): 24a 13a's
     prefill and one decode step captured on the card's tensors (the
     state from a copy), each kernel one node, the kernel nodes equal to
     the eager launches (181 B1 and 30 B5 in the prefill, 181 B1 a
     step), each graph replayed on fresh inputs bit for bit the eager
     step's outputs with the same launches; 24b the graph roofline of
     both and of 17a's f32 step (captured on meta with the card's paths
     in 23a): FLOPs at each class's peak and bytes, the bound at most the
     device time measured in this run (a floor), beside 23a's meta-run
     bound; 24c the split prefills of phase 21 (mamba2-130m,
     recurrentgemma-2b, whisper-base; rank 0 of 2 x 2, captured on meta
     in 23a): their collective nodes equal the recorder's and phase 21's
     records one for one, and analysis/sharding.py:audit_partitioned_graph
     finds no violation.
 25. a W12A12 VGG-16: phase 3's model and batches at ``QuantConfig(
     n_bits=12, log2_radix=4)`` (int16 planes, D = 3, 5 levels):
     ``vgg16_apply`` (120 B1 launches a forward on its int16 entry) bit
     for bit the plain-GEMM forward, top-1 agreement with the float
     forward at least phase 3's; ``vgg16_classify_progressive`` scan (119
     B1 + 1 B2 at D = 3) and early exit, classes ``argmax(vgg16_apply)``;
     the pair-schedule FC head (3 B3 a head, int16) bit for bit its plain
     version and the stacked schedule; the reference's default
     ``L2R_CERTIFY=warn`` warnings (fc6's K overflows int32) counted as
     shown, not silenced; timed and profiled; 25b B1's int16 entry at
     each of the forward's GEMM shapes and B3's at fc6-fc8, bit for bit
     their plain versions, kernel_ms beside the bound (B1 and B3 run an
     int16 product on the int8 tensor cores as its byte split).
Then one JSON line per kernel (B1-B6; each with its ``routes``: the C
entries, the domain each takes and this run's rows on it; B1, B4 and B5 also with the
launches and times of phases 13-14, B2 with the head's of phase 15, B1
and B5 with phase 16's per model, B5 with phase 17's training run,
B4 and B5 with their 17d rows, B1 and B2 with phase 18's per rank, B1,
B2 and B5 with phase 19's per rank and its 19d rows, and with phase 20's
per rank and its 20d rows), the card again,
and the result line.
Each path's launch counts are reset to 0 just before it and read just
after; launches made to compare a kernel with its plain version are not
counted.

Imports neither jax nor the JAX package; exits non-zero without CUDA.

    python3 chip_smoke.py --decode-profile

builds the kernels and prints only the device profiles of one decode step
of 13a, 14a and 15a (set up as those phases set it up), one JSON line;

    python3 chip_smoke.py --mixer-profile ARCH

those of one prefill and one decode step of phase 16's ARCH (mamba2-130m,
recurrentgemma-2b, deepseek-moe-16b or whisper-base) in one process.

    python3 chip_smoke.py --hot-path

13a's decode step profiled (device ms, device events) and 15e's batcher
tokens/s (a warm run, then three timed), no audit active.

    python3 chip_smoke.py --int16

2h's rows and phase 25 (with 25b) alone, one JSON line (phase 25's top-1
floor is 0 here; the full run holds it to phase 3's).
The script takes its package from ``src/`` beside it, so a copy of it in
another checkout profiles that checkout's code: an older commit and this
one can be compared in one call on one card.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the card's data-sheet rates (H100 SXM, dense), from their one home (the
# bounds reach the compute peaks through compute_seconds)
from repro_torch.launch.roofline import (  # noqa: E402, F401
    HBM_BYTES_PER_S as PEAK_BYTES, PEAK_BF16_FLOPS, PEAK_INT8_OPS,
    PEAK_TF32_FLOPS, compute_seconds)

BATCH = 8
RAGGED = [(5, 3, 7), (130, 19, 67), (16, 64, 1000), (17, 48, 33),
          (300, 128, 96)]
# (n_bits, log2_radix): the int8 configs, then the wide ones: D = 3 and 7
# on B2's tensor cores, int16 planes (n_bits 12 and 16, D 3-16) on the int16
# entries of B1-B3
WIDE_CONFIGS = [(6, 2), (7, 1), (12, 4), (16, 4), (16, 2), (16, 1)]
RAGGED_CONFIGS = [(8, 2), (8, 1), (8, 4), (4, 2)] + WIDE_CONFIGS
SPLIT_K = [(8, 4096, 1000), (16, 300, 130), (3, 1000, 77)]  # M <= 16
LEVELS = [None, 0, 1, 3, 7]
PORT = "src/repro_torch/kernels"
PALLAS = "src/repro/kernels"
KERNELS = {  # library -> (id, source, Pallas body it replaces)
    "l2r_stacked_gemm": ("B1", f"{PORT}/l2r_gemm/csrc/l2r_stacked_gemm.cu",
                         f"{PALLAS}/l2r_gemm/kernel.py:180"),
    "l2r_streaming_gemm": ("B2",
                           f"{PORT}/l2r_gemm/csrc/l2r_streaming_gemm.cu",
                           f"{PALLAS}/l2r_gemm/kernel.py:317"),
    "l2r_pairs_gemm": ("B3", f"{PORT}/l2r_gemm/csrc/l2r_pairs_gemm.cu",
                       f"{PALLAS}/l2r_gemm/kernel.py:79"),
    "flash_attention_l2r": (
        "B4", f"{PORT}/flash_attention/csrc/flash_attention_l2r.cu",
        f"{PALLAS}/flash_attention/kernel.py:163"),
    "flash_attention": ("B5", f"{PORT}/flash_attention/csrc/flash_attention.cu",
                        f"{PALLAS}/flash_attention/kernel.py:39"),
    "cipu_array": ("B6", f"{PORT}/msdf_ipu/csrc/cipu_array.cu",
                   f"{PALLAS}/msdf_ipu/kernel.py:26"),
}
N_LEVELS = 7  # 2D-1 for the main path's config (n=8, radix 4)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def launch_counts() -> list[dict[str, int]]:
    """The kernel wrappers' launch counts, one dict per kernel module."""
    from repro_torch.kernels import flash_attention, msdf_ipu
    from repro_torch.kernels.l2r_gemm import kernel

    return [kernel.LAUNCHES, msdf_ipu.LAUNCHES, flash_attention.LAUNCHES]


def reset_counts() -> None:
    for launches in launch_counts():
        for name in launches:
            launches[name] = 0


def counts() -> dict[str, int]:
    return {name: n for launches in launch_counts()
            for name, n in launches.items()}


def only(**want: int) -> dict[str, int]:
    """The counts of a run that launched ``want`` and no other kernel."""
    return {name: want.get(name, 0) for name in KERNELS}


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
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


def stream_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Time of one call in a run of ``iters`` back-to-back calls, CUDA
    events around the run: the card's time when each call's host work
    is shorter than its kernel."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kid: str, iters: int = 5) -> float | str:
    """Device time of kernel ``kid``'s launches per call of ``fn``
    (torch.profiler over ``iters`` calls): the kernel alone, with no
    host work and no other kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler run now and then records no device time
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for ev in prof.key_averages():
            if kernel_id(ev.key) == kid:
                us += getattr(ev, "self_device_time_total", None) or \
                    getattr(ev, "self_cuda_time_total", 0)
        if us:
            return us / 1e3 / iters
    return "not measured"


def host_ms(fn) -> float:
    """Host clock around one call that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time on this card: int8 operations over the peak rate or
    bytes over the memory rate, whichever is larger."""
    return cost_bound({"int8": ops}, nbytes)


def cost_bound(ops: dict, nbytes: float) -> tuple[float, str]:
    """The least time on this card of a kernel's work as its module counts
    it (``*_cost``: operations by the peak they run at, bytes moved once):
    the operations' time (launch/roofline.py:compute_seconds) or the bytes
    over the memory rate, whichever is larger."""
    t_ops = compute_seconds(ops) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def main_path_shapes() -> list[dict]:
    """Every distinct GEMM of a VGG-16 forward at BATCH, with the number
    of launches it takes per forward (9 taps per conv layer)."""
    from repro_torch.core.cycle_model import VGG16_CONV_LAYERS

    shapes: dict[tuple, dict] = {}
    for layer in VGG16_CONV_LAYERS:
        key = (BATCH * layer.R * layer.C, layer.N, layer.M)
        row = shapes.setdefault(key, {"name": layer.name, "count": 0,
                                      "accumulate": True})
        row["count"] += layer.k * layer.k
    for name, (k, n) in {"fc6": (25088, 4096), "fc7": (4096, 4096),
                         "fc8": (4096, 1000)}.items():
        shapes[(BATCH, k, n)] = {"name": name, "count": 1,
                                 "accumulate": False}
    return [{"m": m, "k": k, "n": n, **row} for (m, k, n), row in
            shapes.items()]


def operands(g, dev, m, k, n, n_bits):
    """Random n_bits operands (M, K) and (K, N), int8 up to 8 bits, int16
    above (the planes' type)."""
    hi = 1 << (n_bits - 1)
    dt = torch.int8 if n_bits <= 8 else torch.int16
    a = torch.randint(-hi, hi, (m, k), generator=g, device=dev, dtype=dt)
    b = torch.randint(-hi, hi, (k, n), generator=g, device=dev, dtype=dt)
    return a, b


def int_mm(a, b):
    """The yardstick: one int8 GEMM on the unstacked operands, zero-
    padded to torch._int_mm's shape limits (M > 16, K and N multiples
    of 8; zero padding is exact).  Returns (result (M, N), timed fn,
    padded?)."""
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = max(m, 32), -(-k // 8) * 8, -(-n // 8) * 8
    ap = torch.zeros((mp, kp), dtype=torch.int8, device=a.device)
    bp = torch.zeros((kp, np_), dtype=torch.int8, device=a.device)
    ap[:m, :k], bp[:k, :n] = a, b
    return (torch._int_mm(ap, bp)[:m, :n], lambda: torch._int_mm(ap, bp),
            (mp, kp, np_) != (m, k, n))


def max_err(got, ref) -> int:
    return int((got.to(torch.int64) - ref.to(torch.int64)).abs().max().item()
               ) if got.numel() else 0


def k_major(b_rev: torch.Tensor) -> torch.Tensor:
    """The (D*K, N) stack with its contraction innermost in memory: the
    layout of the weight caches (``quantize_weights(..., k_major=True)``),
    which kernel B1 reads in place."""
    return b_rev.t().contiguous().t()


def phase_kernel(dev) -> list[dict]:
    from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs
    from repro_torch.kernels.l2r_gemm import kernel

    g = torch.Generator(device=dev).manual_seed(0)
    checked = 0
    for (m, k, n) in RAGGED + SPLIT_K:
        for n_bits, log2_radix in RAGGED_CONFIGS:
            d = n_bits // log2_radix
            a, b = operands(g, dev, m, k, n, n_bits)
            sa = stack_planes_lhs(a, n_bits, log2_radix)
            sb = stack_planes_rhs(b, n_bits, log2_radix)
            sbk = k_major(sb)
            # the prefix route: every truncation, B in both layouts
            for lv in [None] + list(range(2 * d)):
                ref = kernel.l2r_gemm_stacked_planes_plain(sa, sb, n_bits,
                                                           log2_radix, lv)
                for rhs in (sbk, sb):
                    got = kernel.l2r_gemm_stacked_planes(sa, rhs, n_bits,
                                                         log2_radix, lv)
                    require(torch.equal(got, ref),
                            f"B1 != plain at M={m} K={k} N={n} n_bits="
                            f"{n_bits} log2_radix={log2_radix} levels={lv} "
                            f"({'K-major' if rhs is sbk else 'row-major'})")
                    checked += 1
            # the plane-pair route: each one-level slab of the early-exit
            # loop, added into a running sum as the loop does
            acc = torch.zeros((m, n), dtype=torch.int32, device=dev)
            for t in range(2 * d - 1):
                kernel.l2r_gemm_stacked_planes(sa, sbk, n_bits, log2_radix,
                                               levels=t + 1, first_level=t,
                                               out=acc)
                slab = kernel.l2r_gemm_stacked_planes(
                    sa, sbk, n_bits, log2_radix, levels=t + 1, first_level=t)
                require(torch.equal(slab, kernel.l2r_gemm_stacked_planes_plain(
                    sa, sb, n_bits, log2_radix, t + 1, first_level=t)),
                    f"B1 level slab {t} != plain at M={m} K={k} N={n} "
                    f"n_bits={n_bits} log2_radix={log2_radix}")
                require(torch.equal(acc, kernel.l2r_gemm_stacked_planes_plain(
                    sa, sb, n_bits, log2_radix, t + 1)),
                    f"B1 slabs 0..{t} != prefix at M={m} K={k} N={n} "
                    f"n_bits={n_bits} log2_radix={log2_radix}")
                checked += 2
            acc = torch.full((m, n), 7, dtype=torch.int32, device=dev)
            kernel.l2r_gemm_stacked_planes(sa, sbk, n_bits, log2_radix,
                                           out=acc)
            require(torch.equal(acc, kernel.l2r_gemm_stacked_planes_plain(
                sa, sb, n_bits, log2_radix) + 7),
                f"B1 out= accumulation wrong at M={m} K={k} N={n}")
    print(f"phase 2a: B1 == plain (bit for bit) on {checked} ragged "
          f"cases: prefix tables at every levels (B K-major and row-major), "
          f"one-level slabs at every first_level, out=; shapes "
          f"{RAGGED + SPLIT_K}, configs {RAGGED_CONFIGS}", flush=True)

    rows = []
    for sh in main_path_shapes():
        m, k, n, acc_mode = sh["m"], sh["k"], sh["n"], sh["accumulate"]
        a, b = operands(g, dev, m, k, n, 8)
        sa, sb = stack_planes_lhs(a), stack_planes_rhs(b)
        sbk = k_major(sb)  # as the weight cache holds it
        for lv in (None, 3):
            got = kernel.l2r_gemm_stacked_planes(sa, sbk, levels=lv)
            ref = kernel.l2r_gemm_stacked_planes_plain(sa, sb, levels=lv)
            require(torch.equal(got, ref),
                    f"B1 != plain at {sh['name']} M={m} K={k} N={n} "
                    f"levels={lv}")
        err = max_err(got, ref)
        del got, ref
        for t in range(1, N_LEVELS):  # the plane-pair route, level slabs
            require(torch.equal(
                kernel.l2r_gemm_stacked_planes(sa, sbk, levels=t + 1,
                                               first_level=t),
                kernel.l2r_gemm_stacked_planes_plain(sa, sb, levels=t + 1,
                                                     first_level=t)),
                f"B1 level slab {t} != plain at {sh['name']}")
        out = torch.zeros((m, n), dtype=torch.int32, device=dev) \
            if acc_mode else None
        ms = time_ms(lambda: kernel.l2r_gemm_stacked_planes(sa, sbk, out=out))
        kernel_ms = stream_ms(
            lambda: kernel.l2r_gemm_stacked_planes(sa, sbk, out=out))
        plain_ms = time_ms(
            lambda: kernel.l2r_gemm_stacked_planes_plain(sa, sb, out=out),
            iters=3, warmup=1)
        lib, lib_fn, padded = int_mm(a, b)
        require(torch.equal(lib, kernel.l2r_gemm_stacked_planes(sa, sbk)),
                f"torch._int_mm disagrees with B1 at {sh['name']}")
        d = 4  # planes of the main path's config (n=8, radix 4)
        # at full depth the function is aq @ bq (mod 2^32): 2*M*N*K int8
        # operations, however many plane products the kernel runs
        bound_ms, by = cost_bound(*kernel.stacked_cost(
            m, k, n, d, accumulate=bool(acc_mode)))
        row = {**sh, "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": time_ms(lib_fn), "bound_ms": bound_ms,
               "bound_by": by, "max_abs_err": err, "int_mm_padded": padded}
        rows.append(row)
        print("phase 2b: " + json.dumps(row), flush=True)
    print(f"phase 2b: B1 == plain (bit for bit) at all {len(rows)} VGG-16 "
          f"shapes, B K-major: levels None and 3 (prefix route), level "
          f"slabs 1..{N_LEVELS - 1} (plane-pair route)", flush=True)
    return rows


def phase_streaming(dev) -> list[dict]:
    """Kernel B2 against its plain version: every plane, the dynamic
    level count (planes below it equal the full run), out= accumulation;
    then every VGG-16 GEMM shape, timed."""
    from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs
    from repro_torch.kernels.l2r_gemm import kernel

    g = torch.Generator(device=dev).manual_seed(2)
    checked = 0
    for (m, k, n) in RAGGED + [(8, 4096, 1000)]:
        for n_bits, log2_radix in RAGGED_CONFIGS:
            n_lv = 2 * (n_bits // log2_radix) - 1
            a, b = operands(g, dev, m, k, n, n_bits)
            sa = stack_planes_lhs(a, n_bits, log2_radix)
            sb = stack_planes_rhs(b, n_bits, log2_radix)
            sbk = k_major(sb)
            for lv in LEVELS:
                ref = kernel.l2r_gemm_streaming_planes_plain(
                    sa, sb, n_bits, log2_radix, lv)
                for b_in, layout in ((sb, "row-major"), (sbk, "K-major")):
                    got = kernel.l2r_gemm_streaming_planes(
                        sa, b_in, n_bits, log2_radix, lv)
                    require(torch.equal(got, ref),
                            f"B2 != plain at M={m} K={k} N={n} n_bits="
                            f"{n_bits} log2_radix={log2_radix} levels={lv} "
                            f"B {layout}")
                    checked += 1
            full = kernel.l2r_gemm_streaming_planes_plain(sa, sb, n_bits,
                                                          log2_radix)
            for cnt in (1, 3, n_lv):
                got = kernel.l2r_gemm_streaming_planes(
                    sa, sbk, n_bits, log2_radix, level_count=torch.full(
                        (1,), cnt, dtype=torch.int32, device=dev))
                require(torch.equal(got[:cnt], full[:cnt]),
                        f"B2 level_count={cnt} wrong at M={m} K={k} N={n}")
                checked += 1
            acc = torch.full(full.shape, -5, dtype=torch.int32, device=dev)
            kernel.l2r_gemm_streaming_planes(sa, sbk, n_bits, log2_radix,
                                             out=acc)
            require(torch.equal(acc, full - 5),
                    f"B2 out= accumulation wrong at M={m} K={k} N={n}")
    print(f"phase 2c: B2 == plain (bit for bit) on {checked} ragged cases, "
          f"levels {LEVELS} (B row-major and K-major), level_count 1/3/L, "
          f"out=, configs {RAGGED_CONFIGS}", flush=True)

    rows = []
    for sh in main_path_shapes():
        m, k, n, acc_mode = sh["m"], sh["k"], sh["n"], sh["accumulate"]
        a, b = operands(g, dev, m, k, n, 8)
        sa, sb = stack_planes_lhs(a), stack_planes_rhs(b)
        sbk = k_major(sb)  # the weight cache's layout, as the model passes
        ref = kernel.l2r_gemm_streaming_planes_plain(sa, sb)
        got = kernel.l2r_gemm_streaming_planes(sa, sbk)
        require(torch.equal(got, ref),
                f"B2 != plain at {sh['name']} M={m} K={k} N={n} (K-major)")
        require(torch.equal(kernel.l2r_gemm_streaming_planes(sa, sb), ref),
                f"B2 != plain at {sh['name']} M={m} K={k} N={n} (row-major)")
        err = max_err(got, ref)
        del got, ref
        out = torch.zeros((N_LEVELS, m, n), dtype=torch.int32, device=dev) \
            if acc_mode else None
        ms = time_ms(lambda: kernel.l2r_gemm_streaming_planes(sa, sbk,
                                                              out=out))
        kernel_ms = stream_ms(lambda: kernel.l2r_gemm_streaming_planes(
            sa, sbk, out=out))
        dev_ms = device_ms(lambda: kernel.l2r_gemm_streaming_planes(
            sa, sbk, out=out), "B2")
        plain_ms = time_ms(
            lambda: kernel.l2r_gemm_streaming_planes_plain(sa, sb, out=out),
            iters=3, warmup=1)
        lib, lib_fn, padded = int_mm(a, b)
        require(torch.equal(lib, kernel.l2r_gemm_stacked_planes(sa, sb)),
                f"torch._int_mm disagrees with the final plane at "
                f"{sh['name']}")
        d = 4
        # each plane is a different sum of pair products: the D^2 of
        # them, 2*M*N*K int8 operations each
        bound_ms, by = cost_bound(*kernel.streaming_cost(
            m, k, n, d, N_LEVELS, bool(acc_mode)))
        row = {**sh, "ms": ms, "kernel_ms": kernel_ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "library_ms": time_ms(lib_fn),
               "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
               "int_mm_padded": padded, "b_layout": "K-major"}
        rows.append(row)
        print("phase 2d: " + json.dumps(row), flush=True)
        del out
    print(f"phase 2d: B2 == plain (bit for bit, all {N_LEVELS} planes, B "
          f"K-major and row-major) at all {len(rows)} VGG-16 shapes, timed "
          f"on the K-major B; library_ms is torch._int_mm on the unstacked "
          f"operands, the yardstick of the final plane only", flush=True)
    return rows


def phase_pairs(dev) -> list[dict]:
    """Kernel B3 against its plain version: ragged shapes and levels, then
    every VGG-16 GEMM shape, timed."""
    from repro_torch.kernels.l2r_gemm import kernel

    g = torch.Generator(device=dev).manual_seed(3)
    checked = 0
    for (m, k, n) in RAGGED:
        for n_bits, log2_radix in RAGGED_CONFIGS:
            a, b = operands(g, dev, m, k, n, n_bits)
            for lv in LEVELS:
                got = kernel.l2r_gemm_pairs(a, b, n_bits, log2_radix, lv)
                ref = kernel.l2r_gemm_pairs_plain(a, b, n_bits, log2_radix,
                                                  lv)
                require(torch.equal(got, ref),
                        f"B3 != plain at M={m} K={k} N={n} n_bits={n_bits} "
                        f"log2_radix={log2_radix} levels={lv}")
                checked += 1
    print(f"phase 2e: B3 == plain (bit for bit) on {checked} ragged cases, "
          f"levels {LEVELS}, configs {RAGGED_CONFIGS}", flush=True)

    rows = []
    for sh in main_path_shapes():
        m, k, n = sh["m"], sh["k"], sh["n"]
        a, b = operands(g, dev, m, k, n, 8)
        for lv in (None, 3):
            got = kernel.l2r_gemm_pairs(a, b, levels=lv)
            ref = kernel.l2r_gemm_pairs_plain(a, b, levels=lv)
            require(torch.equal(got, ref),
                    f"B3 != plain at {sh['name']} M={m} K={k} N={n} "
                    f"levels={lv}")
        err = max_err(got, ref)
        ms = time_ms(lambda: kernel.l2r_gemm_pairs(a, b))
        kernel_ms = stream_ms(lambda: kernel.l2r_gemm_pairs(a, b))
        dev_ms = device_ms(lambda: kernel.l2r_gemm_pairs(a, b), "B3")
        plain_ms = time_ms(lambda: kernel.l2r_gemm_pairs_plain(a, b),
                           iters=3, warmup=1)
        lib, lib_fn, padded = int_mm(a, b)
        require(torch.equal(lib, kernel.l2r_gemm_pairs(a, b)),
                f"torch._int_mm disagrees with B3 at {sh['name']}")
        # the timed call runs every pair: the function is aq @ bq (mod
        # 2^32), so it needs 2*M*N*K int8 operations, not the D^2 pair
        # products the kernel runs
        bound_ms, by = cost_bound(*kernel.pairs_cost(m, k, n))
        row = {**sh, "accumulate": False, "ms": ms, "kernel_ms": kernel_ms,
               "device_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": time_ms(lib_fn), "bound_ms": bound_ms,
               "bound_by": by, "max_abs_err": err, "int_mm_padded": padded}
        rows.append(row)
        print("phase 2f: " + json.dumps(row), flush=True)
    print(f"phase 2f: B3 == plain (bit for bit) at all {len(rows)} VGG-16 "
          f"shapes, levels None and 3", flush=True)
    return rows


def phase_wrapper_host(dev) -> dict:
    """Host time of one wrapper call of B1, B2 and B3 at fc8's shape
    (batch 8): the Python dispatch, allocation and launch, on the host
    clock over many calls, with the card's queue kept ahead."""
    from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs
    from repro_torch.kernels.l2r_gemm import kernel

    g = torch.Generator(device=dev).manual_seed(6)
    a, b = operands(g, dev, BATCH, 4096, 1000, 8)
    sa, sbk = stack_planes_lhs(a), k_major(stack_planes_rhs(b))
    calls = {"B1": lambda: kernel.l2r_gemm_stacked_planes(sa, sbk),
             "B2": lambda: kernel.l2r_gemm_streaming_planes(sa, sbk),
             "B3": lambda: kernel.l2r_gemm_pairs(a, b)}
    out = {}
    for kid, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        out[f"{kid}_host_us_per_call"] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    print("phase 2g: " + json.dumps(out), flush=True)
    return out


WIDE_SHAPE = (BATCH, 4096, 1000)  # fc8 at batch 8: 2h's one VGG-16 shape


def phase_wide_rows(dev) -> dict:
    """2h: each of WIDE_CONFIGS at one VGG-16 shape (fc8 at batch 8): B1
    (the prefix at full depth, B K-major), B2 (every level, B K-major) and
    B3 (the pair loop) bit for bit against their plain versions, timed
    beside the plain version and the bound (an int16 product as four int8
    products or its bytes, kernel.stacked_cost); the library yardstick is
    torch._int_mm on the unstacked operands for the int8 configs and none
    for the int16 ones: no PyTorch call computes an int16 GEMM modulo 2^32
    on CUDA."""
    from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs
    from repro_torch.kernels.l2r_gemm import kernel

    g = torch.Generator(device=dev).manual_seed(7)
    m, k, n = WIDE_SHAPE
    rows: dict[str, list] = {"B1": [], "B2": [], "B3": []}
    for nb, r in WIDE_CONFIGS:
        d = nb // r
        a, b = operands(g, dev, m, k, n, nb)
        sa, sb = stack_planes_lhs(a, nb, r), stack_planes_rhs(b, nb, r)
        sbk = k_major(sb)
        calls = {
            "B1": (lambda: kernel.l2r_gemm_stacked_planes(sa, sbk, nb, r),
                   lambda: kernel.l2r_gemm_stacked_planes_plain(sa, sb, nb,
                                                                r),
                   kernel.stacked_cost(m, k, n, d, n_bits=nb)),
            "B2": (lambda: kernel.l2r_gemm_streaming_planes(sa, sbk, nb, r),
                   lambda: kernel.l2r_gemm_streaming_planes_plain(sa, sb, nb,
                                                                  r),
                   kernel.streaming_cost(m, k, n, d, 2 * d - 1, n_bits=nb)),
            "B3": (lambda: kernel.l2r_gemm_pairs(a, b, nb, r),
                   lambda: kernel.l2r_gemm_pairs_plain(a, b, nb, r),
                   kernel.pairs_cost(m, k, n, d, n_bits=nb)),
        }
        lib_ms = None
        if nb <= 8:
            lib, lib_fn, _ = int_mm(a, b)
            lib_ms = time_ms(lib_fn)
        for kid, (fn, plain, cost) in calls.items():
            got, ref = fn(), plain()
            require(torch.equal(got, ref),
                    f"{kid} != plain at fc8 n_bits={nb} log2_radix={r}")
            if nb <= 8:
                require(torch.equal(got[-1] if kid == "B2" else got, lib),
                        f"torch._int_mm disagrees with {kid} at n_bits={nb}")
            bound_ms, by = cost_bound(*cost)
            row = {"name": "fc8", "m": m, "k": k, "n": n, "count": 1,
                   "n_bits": nb, "log2_radix": r, "planes": d,
                   "route": ("int16, CUDA cores" if kid == "B2" else
                             "int16, tensor cores (byte split)") if nb > 8
                   else "int8, tensor cores",
                   "ms": time_ms(fn), "kernel_ms": stream_ms(fn),
                   "plain_ms": time_ms(plain, iters=3, warmup=1),
                   "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": by, "max_abs_err": max_err(got, ref)}
            rows[kid].append(row)
            print("phase 2h: " + json.dumps({"kernel": kid, **row}),
                  flush=True)
        del a, b, sa, sb, sbk
    print(f"phase 2h: B1, B2 and B3 == plain (bit for bit) at fc8 for "
          f"{WIDE_CONFIGS}; library_ms torch._int_mm for the int8 configs, "
          f"none for int16", flush=True)
    return rows


_IDS = ((re.compile(r"stacked_kernel|stacked16_kernel"), "B1"),
        (re.compile(r"stream_kernel|stream16_kernel"), "B2"),
        (re.compile(r"pairs_kernel|pairs16_kernel"), "B3"),
        (re.compile(r"flash_kernel|flash_wide_kernel"), "B5"),
        (re.compile(r"flash_l2r_kernel|flash_l2r_wide_kernel"), "B4"))


def kernel_id(name: str) -> str | None:
    """B1, B2, B3, B4 or B5 for a profiler kernel name of that kernel,
    None for any other kernel."""
    for pat, kid in _IDS:
        if pat.search(name):
            return kid
    return None


def profile_forward(fn) -> dict:
    """Device time of one forward by kernel (torch.profiler, CUDA
    activity): each hand-written kernel's share, the other kernels, the
    idle share of the forward's wall time and the number of device
    events (kernels, copies, fills) the forward ran.  Zero device time
    is reported as not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    events = 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
            events += ev.count
    busy = sum(by_name.values())
    if not busy:
        return {"device_ms": "not measured", "wall_ms": wall_ms}
    ours: dict[str, float] = {}
    for k, v in by_name.items():
        kid = kernel_id(k)
        if kid:
            ours[f"{kid}_ms"] = ours.get(f"{kid}_ms", 0.0) + v
    top = sorted(((v, k) for k, v in by_name.items() if not kernel_id(k)),
                 reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_ms": busy, **ours,
            "other_ms": busy - sum(ours.values()),
            "idle_share": max(0.0, 1 - busy / wall_ms),
            "device_events": events,
            "top_other": [[k[:80], v] for v, k in top]}


def phase_vgg(dev) -> dict:
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.cnn import (vgg16_apply, vgg16_build,
                                        vgg16_quantize_weights)

    cfg = QuantConfig()
    params = vgg16_build(1000, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    t0 = time.perf_counter()
    weights_q = vgg16_quantize_weights(params, cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    gi = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.randn((BATCH, 224, 224, 3), generator=gi, device=dev)
               for _ in range(3)]

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = [vgg16_apply(params, x, l2r=cfg, weights_q=weights_q, device=dev)
              for x in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    require(launches == only(l2r_stacked_gemm=120 * len(batches)),
            f"launches {launches} for {len(batches)} forwards, expected "
            f"{120 * len(batches)} of B1 and no other")
    for lg in logits:
        require(lg.shape == (BATCH, 1000) and bool(torch.isfinite(lg).all()),
                "non-finite or misshapen logits")

    timed = [host_ms(lambda: vgg16_apply(params, x, l2r=cfg,
                                         weights_q=weights_q, device=dev))
             / 1e3 for x in batches]
    prof = profile_forward(lambda: vgg16_apply(
        params, batches[0], l2r=cfg, weights_q=weights_q, device=dev))

    plain = plain_b1(lambda: vgg16_apply(params, batches[0], l2r=cfg,
                                         weights_q=weights_q, device=dev))
    require(torch.equal(plain, logits[0]),
            "L2R logits differ from the plain-GEMM forward on the card")
    flt = torch.cat([vgg16_apply(params, x, device=dev) for x in batches])
    top1 = (flt.argmax(-1) == torch.cat(logits).argmax(-1)).float().mean()
    out = {"launches": launches["l2r_stacked_gemm"],
           "first_3_forwards_s": wall, "forward_s": timed,
           "images_per_s": BATCH / statistics.median(timed),
           "quantize_weights_s": quant_s, "top1_agreement_vs_float":
           top1.item(), "plain_gemm_forward_bit_identical": True,
           "profile": prof}
    print("phase 3: " + json.dumps(out), flush=True)
    return {**out, "params": params, "weights_q": weights_q,
            "batches": batches, "logits": logits, "cfg": cfg}


def idle_sync_ms(dev, iters: int = 50) -> float:
    """Median host time of ``bool()`` of a 0-d bool tensor just written
    by a kernel, with nothing else queued: the floor of one done-flag
    read.  In the forward a read also waits for all the work queued
    before it."""
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        flag = ~flag
        t0 = time.perf_counter()
        bool(flag)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def head_scan_logits(params, x, cfg, weights_q, levels: int):
    """The fc8 head's logits after ``levels`` levels of the scan, on the
    same trunk as ``vgg16_classify_progressive``."""
    from repro_torch.core.progressive import streaming_argmax
    from repro_torch.core.quant import quantize
    from repro_torch.device import no_tf32
    from repro_torch.kernels.l2r_gemm.ops import CUDA_WALK
    from repro_torch.models.cnn import _vgg16_trunk

    with torch.no_grad(), no_tf32():
        f, _ = _vgg16_trunk(params, x, cfg, None, weights_q)
        xq, xs = quantize(f, cfg, axis=0 if cfg.per_channel else None)
        w_q = weights_q["fc8"]
        logits, _, _ = streaming_argmax(
            xq, w_q.q, xs, w_q.scale, cfg.n_bits, cfg.log2_radix, levels,
            bias=params["fc8"]["b"], out_dtype=f.dtype, cuda_walk=CUDA_WALK)
    return logits


def phase_progressive(dev, vgg: dict) -> dict:
    """vgg16_classify_progressive at full width, scan and early exit."""
    from repro_torch.models.cnn import vgg16_classify_progressive

    params, weights_q, cfg = vgg["params"], vgg["weights_q"], vgg["cfg"]
    batches, ref_logits = vgg["batches"], vgg["logits"]
    run = {}
    for early_exit in (False, True):
        reset_counts()
        outs = [vgg16_classify_progressive(params, x, cfg, weights_q,
                                           early_exit=early_exit, device=dev)
                for x in batches]
        torch.cuda.synchronize()
        run[early_exit] = (outs, counts())
    (scan, n_scan), (early, n_early) = run[False], run[True]
    b = len(batches)
    require(n_scan == only(l2r_stacked_gemm=119 * b, l2r_streaming_gemm=b),
            f"scan launches {n_scan}, expected 119 B1 + 1 B2 per forward")
    levels_run = [int(lv.max()) + 1 for _, lv, _ in scan]
    require(n_early == only(l2r_stacked_gemm=119 * b + sum(levels_run)),
            f"early-exit launches {n_early}, expected 119 B1 per forward "
            f"plus one per level run {levels_run}")
    for (p_s, lv_s, lg_s), (p_e, lv_e, lg_e), ref in zip(scan, early,
                                                         ref_logits):
        require(torch.equal(p_s, ref.argmax(-1).to(torch.int32)),
                "progressive class != argmax(vgg16_apply)")
        require(torch.equal(lg_s, ref),
                "scan logits differ from vgg16_apply's")
        require(torch.equal(p_s, p_e) and torch.equal(lv_s, lv_e),
                "classes or exit levels differ between scan and while")
        require(bool(torch.isfinite(lg_e).all()), "non-finite logits")
    for x, (_, lv_e, lg_e), (_, _, lg_s) in zip(batches, early, scan):
        # the while loop's logits are the dequantized prefix after the
        # levels it ran: the scan's at full depth, else a scan truncated
        # there
        lr = int(lv_e.max()) + 1
        want = lg_s if lr == N_LEVELS else head_scan_logits(
            params, x, cfg, weights_q, lr)
        require(torch.equal(lg_e, want),
                f"early-exit logits differ from the scan's prefix after "
                f"{lr} levels")
    lv_all = torch.cat([lv for _, lv, _ in scan]).cpu()
    hist = torch.bincount(lv_all.to(torch.int64), minlength=N_LEVELS).tolist()
    out = {"launches_scan": n_scan, "launches_early_exit": n_early,
           "levels_run_early_exit": levels_run, "exit_level_hist": hist,
           "mean_exit_level": lv_all.double().mean().item(),
           "pred_equals_argmax_vgg16_apply": True,
           "scan_logits_bit_identical_to_vgg16_apply": True,
           "early_exit_logits_bit_identical_to_scan_prefix": True}
    for early_exit, key in ((False, "scan"), (True, "early_exit")):
        timed = [host_ms(lambda: vgg16_classify_progressive(
            params, x, cfg, weights_q, early_exit=early_exit, device=dev))
            for x in batches]
        out[f"{key}_forward_ms"] = timed
        out[f"{key}_images_per_s"] = BATCH / statistics.median(timed) * 1e3
        out[f"{key}_profile"] = profile_forward(
            lambda: vgg16_classify_progressive(
                params, batches[0], cfg, weights_q, early_exit=early_exit,
                device=dev))
    # the loop reads the flag before each level and stops on the first
    # True read: derived from the levels run, not counted
    out["done_polls_per_forward_derived"] = [
        lr + 1 if lr < N_LEVELS else N_LEVELS for lr in levels_run]
    out["idle_queue_sync_ms"] = idle_sync_ms(dev)
    print("phase 4: " + json.dumps(out), flush=True)
    # phase 18 holds the mesh's classes, levels and logits to these
    results = {ee: [tuple(t.cpu() for t in r) for r in run_[0]]
               for ee, run_ in run.items()}
    return {**out, "results": results}


def phase_pairs_path(dev, vgg: dict) -> dict:
    """The FC head (fc6-fc8) through l2r_matmul_f(schedule="pairs"): 3 B3
    launches per forward, bit-identical to the stacked schedule."""
    from repro_torch.kernels.l2r_gemm.ops import l2r_matmul_f

    params, weights_q, cfg = vgg["params"], vgg["weights_q"], vgg["cfg"]
    gi = torch.Generator(device=dev).manual_seed(4)
    feats = [torch.relu(torch.randn((BATCH, 25088), generator=gi,
                                    device=dev)) for _ in range(3)]

    def head(x, schedule):
        for name in ("fc6", "fc7", "fc8"):
            x = l2r_matmul_f(x, None, cfg, w_q=weights_q[name],
                             schedule=schedule) + params[name]["b"]
            x = torch.relu(x) if name != "fc8" else x
        return x

    reset_counts()
    got = [head(x, "pairs") for x in feats]
    torch.cuda.synchronize()
    n = counts()
    require(n == only(l2r_pairs_gemm=3 * len(feats)),
            f"pairs-path launches {n}, expected 3 B3 per forward")
    for x, lg in zip(feats, got):
        require(torch.equal(lg, head(x, "stacked")),
                "pairs-schedule head != stacked-schedule head")
        require(bool(torch.isfinite(lg).all()), "non-finite head logits")
    out = {"launches": n, "head_ms_pairs": statistics.median(
               host_ms(lambda: head(x, "pairs")) for x in feats),
           "head_ms_stacked": statistics.median(
               host_ms(lambda: head(x, "stacked")) for x in feats),
           "bit_identical_to_stacked": True}
    print("phase 5: " + json.dumps(out), flush=True)
    return out


def phase_protohead(dev) -> dict:
    from repro_torch.core.progressive import streaming_argmax
    from repro_torch.kernels.l2r_gemm.ops import CUDA_WALK
    from repro_torch.models.protohead import prototype_head

    xq, xs, w_q, labels = prototype_head(np.random.default_rng(44), k=4096,
                                         classes=1000, rows=256, device=dev)
    res = {}
    for early_exit in (False, True):
        reset_counts()
        res[early_exit] = (streaming_argmax(xq, w_q.q, xs, w_q.scale,
                                            early_exit=early_exit,
                                            cuda_walk=CUDA_WALK), counts())
    (lg_s, tok_s, lv_s), n_s = res[False]
    (_, tok_e, lv_e), n_e = res[True]
    require(torch.equal(tok_s, tok_e) and torch.equal(lv_s, lv_e),
            "prototype head: scan and while disagree")
    require(torch.equal(tok_s, lg_s.argmax(-1).to(torch.int32)),
            "prototype head: committed class != argmax of the logits")
    out = {"launches_scan": n_s, "launches_early_exit": n_e,
           "levels_run": int(lv_e.max()) + 1,
           "mean_exit_level": lv_s.double().mean().item(),
           "exit_level_hist": torch.bincount(
               lv_s.cpu().to(torch.int64), minlength=N_LEVELS).tolist(),
           "accuracy_vs_labels": (tok_s.cpu().numpy() == labels).mean()
           .item(),
           "scan_ms": time_ms(lambda: streaming_argmax(
               xq, w_q.q, xs, w_q.scale, cuda_walk=CUDA_WALK), iters=5),
           "early_exit_ms": time_ms(lambda: streaming_argmax(
               xq, w_q.q, xs, w_q.scale, early_exit=True,
               cuda_walk=CUDA_WALK), iters=5)}
    print("phase 6: " + json.dumps(out), flush=True)
    return out


def phase_conv_progressive(dev, vgg: dict) -> dict:
    from repro_torch.core.progressive import level_bounds
    from repro_torch.core.quant import quantize
    from repro_torch.kernels.l2r_gemm import ops

    cfg, weights_q = vgg["cfg"], vgg["weights_q"]
    gi = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name, hw, cin in (("conv1_2", 224, 64), ("conv4_2", 28, 512)):
        x = torch.relu(torch.randn((BATCH, hw, hw, cin), generator=gi,
                                   device=dev))
        w_q = weights_q[name]
        reset_counts()
        res, scale = ops.l2r_conv2d_progressive(x, w_q=w_q, cfg=cfg)
        torch.cuda.synchronize()
        n = counts()
        require(n == only(l2r_streaming_gemm=9),
                f"{name}: progressive conv launches {n}, expected 9 B2")
        xq, _ = quantize(x, cfg, axis=0)
        w_in = ops._conv_w_in(w_q, cfg)
        last = res.partial[-1].to(torch.int64)
        exact = level_bounds(cfg.planes, cfg.log2_radix, 9 * cin).exact
        for lv in range(N_LEVELS):
            ref = ops._l2r_conv2d_int(xq, w_in, cfg.n_bits, cfg.log2_radix,
                                      lv + 1)
            require(torch.equal(res.partial[lv], ref),
                    f"{name}: plane {lv} != conv at levels={lv + 1}")
            gap = (res.partial[lv].to(torch.int64) - last).abs().max().item()
            require(gap <= exact[lv],
                    f"{name}: plane {lv} is {gap} from the last, tail "
                    f"bound {exact[lv]}")
        del last, ref
        ms = host_ms(lambda: ops.l2r_conv2d_progressive(x, w_q=w_q, cfg=cfg))
        out[name] = {"launches": n, "planes_match_levels": True,
                     "tail_bounds_hold": True, "ms": ms,
                     "shape": list(res.partial.shape)}
        del res, scale
        torch.cuda.empty_cache()
    print("phase 7: " + json.dumps(out), flush=True)
    return out


def phase_resize(dev) -> dict:
    """The FC head's 7x7 resize on the card against the same call on the
    CPU (ROADMAP C1): equal bits at every final map size 2-14, C = 512,
    batches 1 and 8; fc6's quantized input equal at the 8x8 map where the
    old resize quantized one value to 39 against the reference's 40."""
    from repro_torch.core.quant import QuantConfig, quantize
    from repro_torch.models.resize import resize_7x7

    rng = np.random.default_rng(12)
    checked = 0
    for size in range(2, 15):
        for batch in (1, BATCH):
            x = torch.from_numpy(np.maximum(rng.standard_normal(
                (batch, size, size, 512)), 0).astype(np.float32))
            cpu, got = resize_7x7(x), resize_7x7(x.to(dev)).cpu()
            require(torch.equal(got.view(torch.int32), cpu.view(torch.int32)),
                    f"resize on the card != CPU at {size}x{size}, batch "
                    f"{batch}")
            checked += 1
    x = torch.from_numpy(np.maximum(np.random.default_rng(2).standard_normal(
        (2, 8, 8, 512)), 0).astype(np.float32))
    cfg = QuantConfig()
    q_cpu, s_cpu = quantize(resize_7x7(x).reshape(2, -1), cfg, axis=0)
    xd = x.to(dev)
    q_dev, s_dev = quantize(resize_7x7(xd).reshape(2, -1), cfg, axis=0)
    require(torch.equal(q_dev.cpu(), q_cpu) and torch.equal(s_dev.cpu(), s_cpu),
            "fc6's quantized input differs between the card and the CPU at "
            "the 8x8 map")
    require(int(q_cpu[1, 3791]) == 40, "fc6 input (1, 3791) at the 8x8 map "
            f"quantizes to {int(q_cpu[1, 3791])}, the reference to 40")
    x8 = torch.from_numpy(np.maximum(rng.standard_normal(
        (BATCH, 8, 8, 512)), 0).astype(np.float32)).to(dev)
    out = {"sizes_checked": checked, "fc6_input_equal_at_8x8": True,
           "ms_8x8_batch8": time_ms(lambda: resize_7x7(x8), iters=5)}
    print("phase 12: " + json.dumps(out), flush=True)
    return out


# ------------------------------------------------------------------ slice 3
# CUDA C++ Programming Guide, throughput of native arithmetic instructions,
# compute capability 9.0: results per clock per SM
INT32_PER_CLK_SM, POPC_PER_CLK_SM = 64, 16
SMOLLM = dict(h=9, kvh=3, dh=64)  # src/repro/configs/smollm_135m.py
ATTN_BATCH, ATTN_SEQ, ATTN_WINDOW = 8, 2048, 512
ATTN_CASES = [  # (sq, skv, h, kvh, dh, causal, window): the JAX suite's
    (256, 256, 4, 2, 64, True, None),  # CASES, then ragged Sq != Skv
    (256, 256, 4, 1, 64, True, 64),
    (200, 200, 2, 2, 32, True, None),
    (128, 128, 8, 4, 64, False, None),
    (64, 64, 2, 2, 128, True, 16),
    (70, 130, 3, 1, 24, False, 40),
]
# |got - ref| <= rel * |ref| + abs, elementwise, against the plain version
# (which walks the kernels' KV tiles).  f32: the JAX suite's 3e-5.  bf16:
# one ulp (at most 2^-7 |x|) for the rounding of the output, plus BF16_ABS
# for f32 reassociation and the rare p that rounds the other way.  On an
# H100 at SmolLM-135M widths the kernels read at most 5e-9 beyond the ulp,
# a plain version without p's rounding to bf16 2.0e-3.
BF16_ABS = 1e-4
ATTN_TOL = {torch.float32: (0.0, 3e-5), torch.bfloat16: (2.0 ** -7, BF16_ABS)}


def sm_clock_max_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def cipu_bound(m: int, k: int, n_bits: int) -> tuple:
    """Least time of m SOPs through the CIPU datapath on this card: the
    int32 operands read once and the outputs written once, against the integer
    work of the simulated cycles.  Each of the n^2 cycles needs its
    counter (ceil(k/32) AND, popc and add) and the 6:2 compressor (four
    3:2 CSAs of 2 XOR, 3 AND, 2 OR, 1 shift) plus the two PPR shifts:
    2*ceil(k/32) + 34 int32 operations and ceil(k/32) popc, at the
    issue rates per SM times the SMs times the card's max SM clock."""
    from repro_torch.kernels.msdf_ipu.kernel import cipu_cost

    ops, nbytes = cipu_cost(m, k, n_bits)
    props = torch.cuda.get_device_properties(0)
    clk = sm_clock_max_hz()
    t_int = ops["int32"] / (
        props.multi_processor_count * INT32_PER_CLK_SM * clk) * 1e3
    t_popc = ops["popc"] / (
        props.multi_processor_count * POPC_PER_CLK_SM * clk) * 1e3
    t_ops = max(t_int, t_popc)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_cipu(dev) -> dict:
    """Kernel B6 against its plain version and the integer SOP: ragged
    cases, then one VGG-16 layer's SOP windows as the paper's 8x8 array
    runs them (conv4_2, n=8, k = 3*3*T_n = 72) through simulate_pe_array."""
    from repro_torch.core.cycle_model import (VGG16_CONV_LAYERS,
                                              AcceleratorConfig, layer_cycles)
    from repro_torch.kernels import msdf_ipu

    g = torch.Generator(device=dev).manual_seed(8)
    checked = 0
    for k in (1, 9, 27, 72, 100):
        for n_bits in (4, 6, 8, 10):  # every width fits: 2n + 7 <= 31
            for m in (1, 255, 1000):
                a = torch.randint(0, 1 << n_bits, (m, k), generator=g,
                                  device=dev, dtype=torch.int32)
                b = torch.randint(0, 1 << n_bits, (m, k), generator=g,
                                  device=dev, dtype=torch.int32)
                got = msdf_ipu.cipu_array(a, b, n_bits)
                require(torch.equal(got, msdf_ipu.cipu_array_plain(a, b,
                                                                   n_bits))
                        and torch.equal(got, msdf_ipu.int_sop_ref(a, b)),
                        f"B6 != plain / int SOP at M={m} k={k} n={n_bits}")
                checked += 1
    print(f"phase 8a: B6 == plain == int SOP (bit for bit) on {checked} "
          f"ragged cases", flush=True)

    cfg = AcceleratorConfig()
    layer = next(l for l in VGG16_CONV_LAYERS if l.name == "conv4_2")
    k = cfg.macs_per_pe  # 72 = 3*3*T_n products per SOP window
    m = layer.R * layer.C * layer.M * -(-layer.N // cfg.T_n)
    a = torch.randint(0, 1 << cfg.n_bits, (m, k), generator=g, device=dev,
                      dtype=torch.int32)
    b = torch.randint(0, 1 << cfg.n_bits, (m, k), generator=g, device=dev,
                      dtype=torch.int32)
    reset_counts()
    out = msdf_ipu.simulate_pe_array(a, b, cfg.n_bits)
    torch.cuda.synchronize()
    n = counts()
    require(n == only(cipu_array=1), f"conv4_2 launches {n}, expected 1 B6")
    chunk = 1 << 21
    t0 = time.perf_counter()
    for lo in range(0, m, chunk):
        sl = slice(lo, min(lo + chunk, m))
        require(torch.equal(out[sl], msdf_ipu.cipu_array_plain(
            a[sl], b[sl], cfg.n_bits)),
            f"B6 != plain cycle simulation in SOPs [{lo}, {sl.stop})")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for lo in range(0, m, chunk):
        sl = slice(lo, min(lo + chunk, m))
        require(torch.equal(out[sl], msdf_ipu.int_sop_ref(a[sl], b[sl])),
                f"B6 != int SOP in SOPs [{lo}, {sl.stop})")
    ms = time_ms(lambda: msdf_ipu.simulate_pe_array(a, b, cfg.n_bits),
                 iters=5, warmup=1)
    lib_ms = time_ms(lambda: (a * b).sum(-1, dtype=torch.int32), iters=3,
                     warmup=1)
    bound_ms, by = cipu_bound(m, k, cfg.n_bits)
    del a, b, out
    torch.cuda.empty_cache()
    row = {"name": "conv4_2", "count": 1, "m": m, "k": k,
           "n_bits": cfg.n_bits, "operands": "int32", "ms": ms,
           "sops_per_s": m / ms * 1e3, "plain_ms": plain_ms,
           "plain_checked_sops": m, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": by, "max_abs_err": 0,
           "sm_clock_max_mhz": sm_clock_max_hz() / 1e6}
    print("phase 8b: " + json.dumps(row), flush=True)
    cycles = layer_cycles(layer, cfg, l2r=True)
    print(f"phase 8b: B6 == plain cycle simulation == int SOP on all {m} "
          f"conv4_2 SOPs (k={k}, n={cfg.n_bits}); library_ms is "
          f"(a*b).sum(-1)", flush=True)
    print(f"phase 8b: the paper's 45 nm accelerator model, not a card "
          f"number: conv4_2 takes {cycles} cycles "
          f"(cycle_model.layer_cycles), {cycles / cfg.freq_hz * 1e3} ms at "
          f"{cfg.freq_hz / 1e6:.0f} MHz", flush=True)
    return {"rows": [row], "launches": n["cipu_array"]}


def phase_golden(dev) -> dict:
    """examples/quickstart.py acts 1 and 5 on the card: one SOP of k=72
    products of 8-bit operands (seed 0) through the golden model, and the
    paper's accelerator model (45 nm, not this card)."""
    from repro_torch.core import hw_model
    from repro_torch.core.cycle_model import network_cycles, peak_gops
    from repro_torch.core.ipu import simulate_cipu

    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (1, 72))
    b = rng.integers(0, 256, (1, 72))
    ta, tb = (torch.from_numpy(x.astype(np.int32)) for x in (a, b))
    reset_counts()
    trace = simulate_cipu(ta.to(dev), tb.to(dev), 8)
    torch.cuda.synchronize()
    require(counts() == only(), "the golden model launched a kernel")
    exact = int((a * b).sum())
    require(int(trace.final[0]) == exact,
            f"golden model SOP {int(trace.final[0])} != exact {exact}")
    cpu = simulate_cipu(ta, tb, 8)
    sb = trace.stable_bits[0].cpu()
    # the card's log may round a count differently (tests/test_torch_cuda.py)
    sb_gap = int((sb - cpu.stable_bits[0]).abs().max())
    require(sb_gap <= 1, f"golden model: stable-bit counts on the card are "
            f"{sb_gap} from the CPU's (at most 1 allowed)")
    t2 = hw_model.table2()
    out = {"exact_sop": exact, "cipu_final": int(trace.final[0]),
           "stable_msbs_at_cycles_1_8_16_32_64":
               [int(sb[i - 1]) for i in (1, 8, 16, 32, 64)],
           "stable_bits_max_gap_to_cpu": sb_gap,
           "paper_45nm_model": {
               "peak_gops_l2r": peak_gops(), "peak_gops_baseline":
               peak_gops(l2r=False), "vgg16_speedup":
               network_cycles(l2r=False) / network_cycles(),
               "tops_w_l2r": t2["l2r_cipu"]["tops_w"],
               "gops_mm2_l2r": t2["l2r_cipu"]["gops_mm2"],
               "paper": {"peak_gops_l2r": 48.97, "peak_gops_baseline": 14.40,
                         "vgg16_speedup": 3.40, "tops_w_l2r": 1.20,
                         "gops_mm2_l2r": 200.45}}}
    print("phase 9: " + json.dumps(out), flush=True)
    return out


def attn_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |got - ref|, max of |got - ref| - rel * |ref|): the second is
    what ATTN_TOL's abs term must cover."""
    rel, _ = ATTN_TOL[ref.dtype]
    d = (got.float() - ref.float()).abs()
    return d.max().item(), (d - rel * ref.float().abs()).max().item()


def visible_pairs(sq: int, skv: int, causal: bool, window) -> int:
    from repro_torch.kernels.flash_attention.kernel import visible_pairs

    return visible_pairs(sq, skv, causal, window)


def attn_qkv(g, dev, b, sq, skv, h, kvh, dh, dtype):
    q = torch.randn((b, sq, h, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((b, skv, kvh, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((b, skv, kvh, dh), generator=g, device=dev).to(dtype)
    return q, k, v


def sdpa(q, k, v, causal, window):
    """The library yardstick: one scaled_dot_product_attention call on
    (B, H, S, dh) copies, the kv heads repeated for GQA beforehand (with
    ``enable_gqa`` an f32 call falls back to the full-matrix route)."""
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.repeat_interleave(r, dim=2).transpose(1, 2).contiguous()
                  for x, r in ((q, 1), (k, g), (v, g)))
    mask = None
    if window is not None:  # a boolean mask: True where a key is seen
        pos_q = torch.arange(q.shape[1], device=q.device)[:, None]
        pos_k = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = pos_k > pos_q - window
        if causal:
            mask &= pos_k <= pos_q
    fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None)
    return fn().transpose(1, 2), fn


def attn_bound(b, h, dh, pairs, dtype, nbytes, qk_int8=False) -> tuple:
    """QK^T and PV at 2*dh operations per visible pair each, at the least
    time the card takes for a product of their type to the kernels'
    accuracy (bf16 on the bf16 tensor cores; f32 as three TF32 products,
    the 3xTF32 split of B5, at 495 / 3 = 165 TFLOP/s; B4's QK^T on the
    int8 tensor cores), against the bytes moved once."""
    from repro_torch.kernels.flash_attention.kernel import attention_ops

    return cost_bound(attention_ops(b, h, dh, pairs, dtype, qk_int8), nbytes)


def phase_attention(dev, l2r: bool) -> dict:
    """Kernel B5 (``l2r=False``, through ops.flash_attention) or B4
    (through flash_attention_l2r) against its plain version: the ragged
    cases in f32 and bf16 (B4 at levels 1, 3 and full depth), then
    SmolLM-135M's attention (H=9, Kv=3, dh=64) at a 2048-token prefill,
    batch 8: causal f32, causal bf16 and window 512 f32, timed beside the
    plain version, the bound and scaled_dot_product_attention."""
    from repro_torch.core.l2r_attention import quantize_per_vector
    from repro_torch.core.quant import QuantConfig
    from repro_torch.device import no_tf32
    from repro_torch.kernels import flash_attention as fa

    name = "flash_attention_l2r" if l2r else "flash_attention"
    tag = "11" if l2r else "10"
    kernel_fn = fa.flash_attention_l2r if l2r else fa.flash_attention
    plain_fn = fa.flash_attention_l2r_plain if l2r \
        else fa.flash_attention_kernel_plain
    g = torch.Generator(device=dev).manual_seed(11 if l2r else 10)
    checked = 0
    worst = {dt: [0.0, -1.0] for dt in ATTN_TOL}  # max |d|, max excess
    for (sq, skv, h, kvh, dh, causal, window) in ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_qkv(g, dev, 2, sq, skv, h, kvh, dh, dtype)
            for lv in ((1, 3, None) if l2r else (None,)):
                kw = {"levels": lv} if l2r else {}
                got = kernel_fn(q, k, v, causal=causal, window=window, **kw)
                ref = plain_fn(q, k, v, causal=causal, window=window, **kw)
                err, excess = attn_err(got, ref)
                require(got.dtype == ref.dtype
                        and excess <= ATTN_TOL[dtype][1],
                        f"{name} != plain by {err} (beyond the relative "
                        f"term: {excess}) at Sq={sq} Skv={skv} H={h} "
                        f"Kv={kvh} dh={dh} causal={causal} window={window} "
                        f"{dtype} levels={lv}")
                worst[dtype] = [max(worst[dtype][0], err),
                                max(worst[dtype][1], excess)]
                checked += 1
    print(f"phase {tag}a: {name} == plain on {checked} ragged cases within "
          f"3e-5 (f32) and 2^-7 |ref| + {BF16_ABS} (bf16); f32 max |d| "
          f"{worst[torch.float32][0]}; bf16 max |d| "
          f"{worst[torch.bfloat16][0]}, max |d| - 2^-7 |ref| "
          f"{worst[torch.bfloat16][1]}", flush=True)

    b, s = ATTN_BATCH, ATTN_SEQ
    h, kvh, dh = SMOLLM["h"], SMOLLM["kvh"], SMOLLM["dh"]
    runs = [("causal_f32", torch.float32, None),
            ("causal_bf16", torch.bfloat16, None),
            (f"window{ATTN_WINDOW}_f32", torch.float32, ATTN_WINDOW)]
    inputs = {r[0]: attn_qkv(g, dev, b, s, s, h, kvh, dh, r[1]) for r in runs}
    reset_counts()
    outs = {key: kernel_fn(*inputs[key], causal=True, window=window)
            for key, _, window in runs}
    torch.cuda.synchronize()
    n = counts()
    require(n == only(**{name: len(runs)}),
            f"SmolLM-135M attention launches {n}, expected {len(runs)} of "
            f"{name}")
    rows = []
    for key, dtype, window in runs:
        q, k, v = inputs[key]
        got = outs[key]
        ref = plain_fn(q, k, v, causal=True, window=window)
        err, excess = attn_err(got, ref)
        print(f"phase {tag}b: {key}: max |d| {err}, max |d| - "
              f"{ATTN_TOL[dtype][0]} |ref| {excess} (limit "
              f"{ATTN_TOL[dtype][1]})", flush=True)
        require(got.shape == q.shape and bool(torch.isfinite(got).all())
                and excess <= ATTN_TOL[dtype][1],
                f"{name} at SmolLM-135M {key}: max |d| {err} from plain, "
                f"{excess} beyond the relative term")
        if dtype == torch.bfloat16 and not l2r:
            # the same function with p kept in f32 for PV, rounded once at
            # the end: the bf16 limit must tell it from the kernel
            unrounded = plain_fn(q, k, v.float(), causal=True,
                                 window=window).to(dtype)
            _, mut_excess = attn_err(unrounded, ref)
            print(f"phase {tag}b: {key}: plain without p's rounding to "
                  f"bf16: max |d| - 2^-7 |ref| {mut_excess} (must exceed "
                  f"{BF16_ABS})", flush=True)
            require(mut_excess > BF16_ABS,
                    f"the bf16 limit does not see p's rounding to bf16 "
                    f"({mut_excess} <= {BF16_ABS})")
            del unrounded
        del ref
        ms = time_ms(lambda: kernel_fn(q, k, v, causal=True, window=window),
                     iters=5, warmup=1)
        if l2r:  # the launch alone, on operands quantized beforehand
            ops = fa.l2r_kernel_operands(q, k, v)
            require(torch.equal(fa.flash_attention_l2r_launch(
                ops, dh, causal=True, window=window), got),
                f"{name} launch on prepared operands differs at {key}")
            kernel_ms = stream_ms(
                lambda: fa.flash_attention_l2r_launch(ops, dh, causal=True,
                                                      window=window))
            del ops
        else:  # B5's wrapper is the launch: back-to-back calls
            kernel_ms = stream_ms(lambda: kernel_fn(q, k, v, causal=True,
                                                    window=window))
        plain_ms = time_ms(lambda: plain_fn(q, k, v, causal=True,
                                            window=window), iters=3, warmup=1)
        if l2r:  # the full-depth function: attention of the dequantized q, k
            (qq, qs), (kq, ks) = (quantize_per_vector(x, QuantConfig())
                                  for x in (q, k))
            lq, lk = (qq.float() * qs).to(dtype), (kq.float() * ks).to(dtype)
        else:
            lq, lk = q, k
        with no_tf32():
            _, lib_fn = sdpa(lq, lk, v, True, window)
            lib_ms = time_ms(lib_fn, iters=5, warmup=1)
        pairs = visible_pairs(s, s, True, window)
        elem = q.element_size()
        nbytes = (2 * q.numel() + 2 * k.numel()) * elem
        bound_ms, by = attn_bound(b, h, dh, pairs, dtype, nbytes,
                                  qk_int8=l2r)
        row = {"name": key, "count": 1, "B": b, "S": s, "H": h, "Kv": kvh,
               "dh": dh, "dtype": str(dtype).split(".")[-1],
               "window": window, "visible_pairs": pairs, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
               "kernel_ms": kernel_ms}
        rows.append(row)
        print(f"phase {tag}b: " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(f"phase {tag}b: {name} at SmolLM-135M widths within tolerance of "
          f"plain; library_ms is scaled_dot_product_attention"
          f"{' on the dequantized q, k' if l2r else ''}", flush=True)
    return {"rows": rows, "launches": n[name]}


# recurrentgemma-2b's local attention (src/repro/configs/recurrentgemma_2b.py):
# 10 q heads of 256, one kv head, window 2048
RGEMMA = dict(h=10, kvh=1, dh=256, window=2048)


def phase_attention_wide(dev, l2r: bool) -> list[dict]:
    """10c (B5) / 11c (B4): the kernels' wide routes at full width, B =
    8, S = 2048, causal: B5 f32 and bf16 at recurrentgemma-2b's local
    attention (dh 256, the wide layout), B4 bf16 there on int8 q, k (its
    wide route at dh 256) and at SmolLM-135M's shape on int16 q, k
    (n_bits 12 and 16, radix 16), full depth; each within ATTN_TOL of its
    plain version, one launch, timed beside the plain version, the bound
    and scaled_dot_product_attention (on the dequantized q, k for B4)."""
    from repro_torch.core.l2r_attention import quantize_per_vector
    from repro_torch.core.quant import QuantConfig
    from repro_torch.device import no_tf32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention.kernel import attention_ops

    name = "flash_attention_l2r" if l2r else "flash_attention"
    tag = "11c" if l2r else "10c"
    g = torch.Generator(device=dev).manual_seed(111 if l2r else 110)
    b, s = ATTN_BATCH, ATTN_SEQ
    smol = {**SMOLLM, "window": None}
    runs = ([("rgemma_causal_bf16_w8", torch.bfloat16, RGEMMA, (8, 2)),
             ("smollm_causal_bf16_w12", torch.bfloat16, smol, (12, 4)),
             ("smollm_causal_bf16_w16", torch.bfloat16, smol, (16, 4))]
            if l2r else
            [("rgemma_causal_f32", torch.float32, RGEMMA, None),
             ("rgemma_causal_bf16", torch.bfloat16, RGEMMA, None)])
    rows = []
    for key, dtype, shape, qc in runs:
        h, kvh, dh, window = (shape[x] for x in ("h", "kvh", "dh", "window"))
        q, k, v = attn_qkv(g, dev, b, s, s, h, kvh, dh, dtype)
        kw = {"n_bits": qc[0], "log2_radix": qc[1]} if l2r else {}
        if l2r:
            fn = lambda: fa.flash_attention_l2r(  # noqa: E731
                q, k, v, causal=True, window=window, **kw)
            plain = lambda: fa.flash_attention_l2r_plain(  # noqa: E731
                q, k, v, causal=True, window=window, **kw)
        else:
            fn = lambda: fa.flash_attention(  # noqa: E731
                q, k, v, causal=True, window=window)
            plain = lambda: fa.flash_attention_kernel_plain(  # noqa: E731
                q, k, v, causal=True, window=window)
        reset_counts()
        got = fn()
        torch.cuda.synchronize()
        n = counts()
        require(n == only(**{name: 1}), f"{tag} {key}: launches {n}")
        ref = plain()
        err, excess = attn_err(got, ref)
        require(got.shape == q.shape and bool(torch.isfinite(got).all())
                and excess <= ATTN_TOL[dtype][1],
                f"{name} at {key}: max |d| {err} from plain, {excess} "
                f"beyond the relative term")
        del ref
        ms = time_ms(fn, iters=5, warmup=1)
        if l2r:  # the launch alone, on operands quantized beforehand
            ops = fa.l2r_kernel_operands(q, k, v, *qc)
            require(torch.equal(fa.flash_attention_l2r_launch(
                ops, dh, *qc, causal=True, window=window), got),
                f"{name} launch on prepared operands differs at {key}")
            kernel_ms = stream_ms(lambda: fa.flash_attention_l2r_launch(
                ops, dh, *qc, causal=True, window=window), iters=5)
            del ops
            (qq, qs), (kq, ks) = (quantize_per_vector(x, QuantConfig(*qc))
                                  for x in (q, k))
            lq, lk = (qq.float() * qs).to(dtype), (kq.float() * ks).to(dtype)
        else:
            kernel_ms = stream_ms(fn, iters=5)
            lq, lk = q, k
        plain_ms = time_ms(plain, iters=3, warmup=1)
        with no_tf32():
            _, lib_fn = sdpa(lq, lk, v, True, window)
            lib_ms = time_ms(lib_fn, iters=5, warmup=1)
        pairs = visible_pairs(s, s, True, window)
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        bound_ms, by = cost_bound(attention_ops(
            b, h, dh, pairs, dtype, qk_int8=l2r and qc[0] <= 8,
            qk_int16=l2r and qc[0] > 8), nbytes)
        row = {"name": key, "count": 1, "B": b, "S": s, "H": h, "Kv": kvh,
               "dh": dh, "dtype": str(dtype).split(".")[-1],
               "window": window, "n_bits": qc[0] if l2r else None,
               "route": ("wide layout, each score once"
                         + (", int16 byte split on mma.sync s8"
                            if l2r and qc[0] > 8 else
                            ", QK^T mma.sync s8" if l2r else
                            ", QK^T 3xTF32 mma.sync" if dtype == torch.float32
                            else ", QK^T d-order FMAs")),
               "visible_pairs": pairs, "ms": ms, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
               "excess_over_ulp": excess}
        rows.append(row)
        print(f"phase {tag}: " + json.dumps(row), flush=True)
        del q, k, v, got, lq, lk
        torch.cuda.empty_cache()
    print(f"phase {tag}: {name}'s wide routes within tolerance of plain at "
          f"full width", flush=True)
    return rows


# ------------------------------------------------------------------ slice 7
# SmolLM-135M (src/repro/configs/smollm_135m.py) served through the port's
# make_prefill_step / make_decode_step, L2R at full depth, bf16 compute
LM_ARCH = "smollm-135m"
LM_BATCH, LM_PROMPT, LM_STEPS = 8, 2048, 32
LM_CHECK_PROMPT, LM_CHECK_STEPS = 256, 4  # the plain-GEMM comparisons
B1_PER_STEP = 30 * 6 + 1  # every dense of 30 layers, the head on 1 position
B5_PER_PREFILL = 30
LM_GEMMS = [  # (K, N, launches per layer): wq and wo, wk and wv, wi, mlp wo
    (576, 576, 2), (576, 192, 2), (576, 3072, 1), (1536, 576, 1)]
LM_HEAD = (576, 49152)  # the tied head, one launch a step on M = 8 rows


def lm_model(dev, mesh=None):
    """The full SmolLM-135M config with l2r (n=8, radix 4) at full depth,
    seeded random weights, and its load-time weight cache (the head's
    vocab-sharded over ``mesh``'s model axis): (cfg, prepared params,
    prepare_params seconds)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.common import materialize
    from repro_torch.models.transformer import lm_build
    from repro_torch.serve.engine import prepare_params

    cfg = dataclasses.replace(get_config(LM_ARCH), l2r=QuantConfig())
    params = materialize(lm_build(cfg),
                         torch.Generator(device=dev).manual_seed(13),
                         device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepared = prepare_params(cfg, params, mesh=mesh)
    torch.cuda.synchronize()
    return cfg, prepared, time.perf_counter() - t0


def lm_prompt(dev, batch, length, vocab, seed):
    return torch.randint(0, vocab, (batch, length), dtype=torch.int32,
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed))


def lm_greedy(cfg, params, batch: dict, steps):
    """Prefill ``batch``, then ``steps`` greedy decode steps: the logits
    (B, V) of every step."""
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    with torch.no_grad():
        state, logits = make_prefill_step(
            cfg, batch["tokens"].shape[1] + steps, torch.float32)(
            params, batch)
        decode = make_decode_step(cfg)
        out = [logits[:, 0]]
        tok = torch.argmax(logits, -1).to(torch.int32)
        for _ in range(steps):
            state, tok, logits = decode(params, state, tok)
            out.append(logits[:, 0])
    return out


def plain_b1(fn):
    """``fn()`` with kernel B1 swapped for its plain version."""
    from repro_torch.kernels.l2r_gemm import kernel

    fast = kernel.l2r_gemm_stacked_planes
    kernel.l2r_gemm_stacked_planes = kernel.l2r_gemm_stacked_planes_plain
    try:
        return fn()
    finally:
        kernel.l2r_gemm_stacked_planes = fast


def swapped_b5(fn, replacement):
    """``fn()`` with kernel B5 swapped for ``replacement`` at the name the
    model calls (ops.py binds flash_attention_kernel at import)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    fast = fa_ops.flash_attention_kernel
    fa_ops.flash_attention_kernel = replacement
    try:
        return fn()
    finally:
        fa_ops.flash_attention_kernel = fast


def bf16_limit_everywhere(seed: int, plain):
    """A kernel's ``plain`` version with every output element moved by one
    bf16 ulp (2^-7 of its binade) in a seeded random direction: the
    kernel's bf16 limit spent in full, at every element of every call."""
    g = None

    def attn(*args, **kw):
        nonlocal g
        o = plain(*args, **kw)
        if g is None:
            g = torch.Generator(device=o.device).manual_seed(seed)
        of = o.float()
        step = torch.exp2(torch.floor(torch.log2(of.abs())) - 7)
        sign = torch.randint(0, 2, of.shape, generator=g,
                             device=o.device) * 2 - 1
        return torch.where(of == 0, of, of + sign * step).to(o.dtype)

    return attn



def b1_shape_row(g, dev, m: int, k: int, n: int, count: int, where: str,
                 tag: str) -> dict:
    """B1 at one GEMM shape of a model, B K-major as the weight cache
    holds it (window-padded for a head): bit for bit against its plain
    version and ``torch._int_mm``, timed beside them and its bound."""
    from repro_torch.core.quant import PlaneOperands, stack_planes_lhs, \
        stack_planes_rhs
    from repro_torch.kernels.l2r_gemm import kernel

    a, b = operands(g, dev, m, k, n, 8)
    sa = stack_planes_lhs(a)
    sbk = PlaneOperands.prepare_rhs(
        b, shifted=True, window_pad=where == "head",
        k_major=True).core_stack(True)
    got = kernel.l2r_gemm_stacked_planes(sa, sbk)
    ref = kernel.l2r_gemm_stacked_planes_plain(sa, stack_planes_rhs(b))
    require(torch.equal(got, ref), f"B1 != plain at {where} M={m} K={k} "
                                   f"N={n}")
    err = max_err(got, ref)
    lib, lib_fn, padded = int_mm(a, b)
    require(torch.equal(lib, got), f"torch._int_mm disagrees with B1 at "
                                   f"M={m} K={k} N={n}")
    del got, ref, lib
    d = 4
    bound_ms, by = cost_bound(*kernel.stacked_cost(m, k, n, d))
    row = {"name": f"{where} K={k} N={n}", "m": m, "k": k, "n": n,
           "count": count, "where": where,
           "ms": time_ms(lambda: kernel.l2r_gemm_stacked_planes(sa, sbk)),
           "kernel_ms": stream_ms(
               lambda: kernel.l2r_gemm_stacked_planes(sa, sbk)),
           "plain_ms": time_ms(lambda: kernel.l2r_gemm_stacked_planes_plain(
               sa, sbk), iters=3, warmup=1),
           "library_ms": time_ms(lib_fn), "bound_ms": bound_ms,
           "bound_by": by, "max_abs_err": err, "int_mm_padded": padded}
    print(f"phase {tag}: " + json.dumps(row), flush=True)
    del a, b, sa, sbk, lib_fn
    torch.cuda.empty_cache()
    return row


def phase_lm(dev) -> dict:
    """SmolLM-135M served on the L2R path (phase 13): launch counts,
    timings and the device breakdown of a prefill of 8 x 2048 tokens and
    32 greedy decode steps; B1 bit-exact under the transformer and at
    levels=5; B5's effect on the model against its bf16 limit; B1 per
    shape at the LM's shapes."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.transformer import (init_lm_state, lm_forward,
                                                logits_from_hidden)
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    smi = card()
    cfg, params, prep_s = lm_model(dev)
    prompt = lm_prompt(dev, LM_BATCH, LM_PROMPT, cfg.vocab, 130)
    batch = {"tokens": prompt}
    prefill = make_prefill_step(cfg, LM_PROMPT + LM_STEPS, torch.float32)
    decode = make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        # 13a: the serving run, every launch counted
        reset_counts()
        state, logits = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_peak = torch.cuda.max_memory_allocated(dev)
        live = {"param_bytes": tree_bytes(params),
                "state_bytes": tree_bytes(state)}
        n = counts()
        require(n == only(l2r_stacked_gemm=B1_PER_STEP,
                          flash_attention=B5_PER_PREFILL),
                f"prefill launches {n}, expected {B1_PER_STEP} of B1 and "
                f"{B5_PER_PREFILL} of B5 and no other")
        launched = dict(n)
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks, step_logits = [tok], [logits[:, 0]]
        for i in range(LM_STEPS):
            reset_counts()
            state, tok, lg = decode(params, state, tok)
            n = counts()
            require(n == only(l2r_stacked_gemm=B1_PER_STEP),
                    f"decode step {i} launches {n}, expected {B1_PER_STEP} "
                    f"of B1 and no other")
            launched = {k: launched[k] + n[k] for k in n}
            toks.append(tok)
            step_logits.append(lg[:, 0])
        torch.cuda.synchronize()
        seqs = torch.cat(toks, 1)
        require(logits.shape == (LM_BATCH, 1, cfg.vocab)
                and bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(lg).all()),
                "non-finite or misshapen logits")
        require(seqs.shape == (LM_BATCH, LM_STEPS + 1)
                and bool(((seqs >= 0) & (seqs < cfg.vocab)).all()),
                "tokens out of range")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        # the same run timed: host clock around work ending in a sync
        out = []
        prefill_ms = host_ms(lambda: out.append(prefill(params, batch)))
        state, logits = out.pop()
        tok = torch.argmax(logits, -1).to(torch.int32)
        prof_decode = profile_forward(lambda: decode(params, state, tok))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_STEPS):
            state, tok, _ = decode(params, state, tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / LM_STEPS
        del state
        prof_prefill = profile_forward(lambda: prefill(params, batch))
    run = {"card": smi, "prepare_params_s": prep_s,
           "prefill_ms": prefill_ms, "decode_ms_per_token": step_ms,
           "decode_tokens_per_s": LM_BATCH / step_ms * 1e3,
           "tokens_per_s": LM_BATCH * LM_STEPS
           / (prefill_ms + LM_STEPS * step_ms) * 1e3,
           "peak_memory_gb": peak_gb, "prefill_peak_bytes": prefill_peak,
           **live,
           "launches_per_prefill": {"B1": B1_PER_STEP, "B5": B5_PER_PREFILL},
           "launches_per_decode_step": {"B1": B1_PER_STEP},
           "launches": launched}
    print(f"phase 13a: SmolLM-135M l2r, batch {LM_BATCH}, {LM_PROMPT}-token "
          f"prompts, {LM_STEPS} decode steps on {smi}: prefill "
          f"{prefill_ms} ms", flush=True)
    print(f"phase 13a: decode {step_ms} ms/token on {smi}", flush=True)
    print(f"phase 13a: {run['decode_tokens_per_s']} tokens/s decoding, "
          f"{run['tokens_per_s']} tokens/s with the prefill, on {smi}",
          flush=True)
    print("phase 13a: " + json.dumps(run), flush=True)
    print("phase 13a: decode step profile: " + json.dumps(prof_decode),
          flush=True)
    print("phase 13a: prefill profile: " + json.dumps(prof_prefill),
          flush=True)
    del out, logits

    # 13b: B1 under the transformer equals the plain GEMM bit for bit,
    # at full depth and at levels=5 (B1's prefix tables), B5 swapped for
    # its plain version in every run
    small = lm_prompt(dev, LM_BATCH, LM_CHECK_PROMPT, cfg.vocab, 131)
    exact = {}
    for levels, steps in ((None, LM_CHECK_STEPS), (5, 1)):
        c = dataclasses.replace(cfg, l2r_levels=levels)

        def run_small(c=c, steps=steps):
            return swapped_b5(lambda: lm_greedy(c, params, {"tokens": small},
                                                steps),
                              fa.flash_attention_kernel_plain)

        reset_counts()
        got = run_small()
        torch.cuda.synchronize()
        n = counts()
        require(n == only(l2r_stacked_gemm=B1_PER_STEP * (steps + 1)),
                f"levels={levels}: launches {n}, expected "
                f"{B1_PER_STEP * (steps + 1)} of B1 and no other")
        ref = plain_b1(run_small)
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"levels={levels}: logits on B1 differ from the plain-GEMM "
                f"run")
        exact[str(levels)] = {"steps": steps + 1, "bit_identical": True}
    print(f"phase 13b: B1 under the transformer == plain GEMM bit for bit: "
          f"{LM_BATCH} x {LM_CHECK_PROMPT}-token prefill + {LM_CHECK_STEPS} decode "
          f"steps at full depth, prefill + 1 step at levels=5; "
          + json.dumps(exact), flush=True)

    # 13c: B5 in the model against its plain version, B1 in every run
    def last_hidden():
        with torch.no_grad():
            st = init_lm_state(cfg, LM_BATCH, LM_PROMPT, torch.float32,
                               device=dev)
            h, _, _ = lm_forward(cfg, params, tokens=prompt, mode="prefill",
                                 state=st)
        return h[:, -1:].float()

    h_b5 = last_hidden()
    h_plain = swapped_b5(last_hidden, fa.flash_attention_kernel_plain)
    h_lim = swapped_b5(last_hidden, bf16_limit_everywhere(
        132, fa.flash_attention_kernel_plain))
    rel = lambda h: ((h - h_plain).norm() / h_plain.norm()).item()  # noqa
    with torch.no_grad():
        lg_b5, lg_plain = (logits_from_hidden(cfg, params, h.to(torch.bfloat16))
                           for h in (h_b5, h_plain))
    b5 = {"hidden_rel_b5": rel(h_b5), "hidden_rel_bound": rel(h_lim),
          "hidden_max_abs_b5": (h_b5 - h_plain).abs().max().item(),
          "logits_max_abs_b5": (lg_b5.float() - lg_plain.float()).abs()
          .max().item(),
          "equal_greedy_tokens": (lg_b5.argmax(-1) == lg_plain.argmax(-1))
          .float().mean().item()}
    print("phase 13c: " + json.dumps(b5), flush=True)
    require(b5["hidden_rel_b5"] <= b5["hidden_rel_bound"],
            f"B5 moves the last-position hidden states by "
            f"{b5['hidden_rel_b5']} (relative) from the plain attention's, "
            f"beyond the {b5['hidden_rel_bound']} its bf16 limit spent at "
            f"every element gives")
    del params, h_b5, h_plain, h_lim
    torch.cuda.empty_cache()

    # 13d: B1 per shape at the LM's shapes, B as the weight cache holds it
    g = torch.Generator(device=dev).manual_seed(133)
    shapes = [(LM_BATCH, k, n, 30 * c, "decode") for k, n, c in LM_GEMMS]
    shapes.append((LM_BATCH, *LM_HEAD, 1, "head"))
    shapes += [(LM_BATCH * LM_PROMPT, k, n, 30 * c, "prefill")
               for k, n, c in LM_GEMMS]
    rows = [b1_shape_row(g, dev, *shape, "13d") for shape in shapes]
    print(f"phase 13d: B1 == plain (bit for bit) at the {len(rows)} LM "
          f"shapes; count = launches per decode step (decode, head) or per "
          f"prefill (prefill; the prefill's head is the head row)", flush=True)
    return {"run": run, "exact": exact, "b5": b5, "rows": rows,
            "prof_decode": prof_decode, "prof_prefill": prof_prefill,
            "seqs": seqs, "step_logits": step_logits}


# ------------------------------------------------------------------ slice 8
# the phase 13 model with digit-serial attention: B4 under every prefill
# attention, the decode walk on the plane-stacked key cache
B4_PER_PREFILL = 30
LM_EXIT_STEPS = 8  # 14d: decode steps at each early-exit tolerance
EXIT_TOLS = (1e-4, 10.0)  # tight, loose


def swapped_b4(fn, replacement):
    """``fn()`` with kernel B4 swapped for ``replacement`` at the name
    chunked_attention calls (the kernel module's attribute)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    fast = fa_kernel.flash_attention_l2r
    fa_kernel.flash_attention_l2r = replacement
    try:
        return fn()
    finally:
        fa_kernel.flash_attention_l2r = fast


def plane_cache_exact(state, quant) -> int:
    """Require every layer's plane cache to equal re-extraction from its
    float key cache (all slots, used or not); returns the slots held."""
    import torch.nn.functional as F

    from repro_torch.core.l2r_attention import quantize_per_vector
    from repro_torch.core.quant import stack_planes_rhs

    slots = 0
    for c in [*state.prefix, *(state.stack or []), *state.suffix]:
        kq, ks = quantize_per_vector(c.k, quant)
        re_stack = F.pad(stack_planes_rhs(kq, quant.n_bits, quant.log2_radix,
                                          axis=-1, shifted=False),
                         (0, (quant.planes - 1) * c.k.shape[-1]))
        require(torch.equal(c.k_planes, re_stack)
                and torch.equal(c.k_scale, ks[..., 0]),
                "the plane-stacked key cache differs from re-extraction "
                "from the float key cache")
        slots += c.k_scale.numel()
        del kq, ks, re_stack
    return slots


def exit_histograms(records: list[dict], layers: int) -> dict:
    """Per-layer exit-level counts (levels 0..N_LEVELS-1) over the rows
    (batch, kv head, group) of every decode step, from attn_exit_tap
    records in layer order."""
    per_layer = np.zeros((layers, N_LEVELS), np.int64)
    for i, r in enumerate(records):
        per_layer[i % layers] += np.bincount(r["exit_levels"].ravel(),
                                             minlength=N_LEVELS)
    total = per_layer.sum()
    return {"per_layer": per_layer.tolist(),
            "all_layers": per_layer.sum(0).tolist(),
            "mean_exit_level": float((per_layer.sum(0)
                                      * np.arange(N_LEVELS)).sum() / total),
            "mean_levels_run": float(np.mean([r["levels_run"]
                                              for r in records]))}


def phase_lm_attn(dev, b4_rows: list[dict]) -> dict:
    """SmolLM-135M served with digit-serial attention (phase 14): launch
    counts, timings and the device breakdown of a prefill (B4 under every
    attention) and 32 decode steps (the walk on the plane cache); the
    plane cache against re-extraction; B4's effect on the model against
    its bf16 limit; the early-exit decode walk at two tolerances."""
    import dataclasses

    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tt
    from repro_torch.models.attention import attn_exit_tap
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    smi = card()
    cfg, params, prep_s = lm_model(dev)
    cfg = dataclasses.replace(cfg, attn_l2r=QuantConfig())
    prompt = lm_prompt(dev, LM_BATCH, LM_PROMPT, cfg.vocab, 140)
    batch = {"tokens": prompt}
    max_len = LM_PROMPT + LM_STEPS
    prefill = make_prefill_step(cfg, max_len, torch.float32)
    decode = make_decode_step(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        # 14a: the serving run, every launch counted
        reset_counts()
        state, logits = prefill(params, batch)
        torch.cuda.synchronize()
        n = counts()
        require(n == only(l2r_stacked_gemm=B1_PER_STEP,
                          flash_attention_l2r=B4_PER_PREFILL),
                f"prefill launches {n}, expected {B1_PER_STEP} of B1 and "
                f"{B4_PER_PREFILL} of B4 and no other")
        launched = dict(n)
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks = [tok]
        for i in range(LM_STEPS):
            reset_counts()
            state, tok, lg = decode(params, state, tok)
            n = counts()
            require(n == only(l2r_stacked_gemm=B1_PER_STEP),
                    f"decode step {i} launches {n}, expected {B1_PER_STEP} "
                    f"of B1 and no other")
            launched = {k: launched[k] + n[k] for k in n}
            toks.append(tok)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        seqs = torch.cat(toks, 1)
        require(logits.shape == (LM_BATCH, 1, cfg.vocab)
                and bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(lg).all()),
                "non-finite or misshapen logits")
        require(seqs.shape == (LM_BATCH, LM_STEPS + 1)
                and bool(((seqs >= 0) & (seqs < cfg.vocab)).all()),
                "tokens out of range")
        positions = state.stack[0].positions
        require(int(positions.max()) == max_len - 1
                and bool((positions >= 0).all()),
                "the cache does not hold every position of the run")
        slots = plane_cache_exact(state, cfg.attn_l2r)  # 14b, after decode
        cache_gb = sum(c.k_planes.numel() + 4 * c.k_scale.numel()
                       for c in state.stack) / 1e9
        del state

        # the same run timed: host clock around work ending in a sync
        out = []
        prefill_ms = host_ms(lambda: out.append(prefill(params, batch)))
        state, logits = out.pop()
        plane_cache_exact(state, cfg.attn_l2r)  # 14b, after the prefill
        tok = torch.argmax(logits, -1).to(torch.int32)
        prof_decode = profile_forward(lambda: decode(params, state, tok))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_STEPS):
            state, tok, _ = decode(params, state, tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / LM_STEPS
        del state
        prof_prefill = profile_forward(lambda: prefill(params, batch))
    run = {"card": smi, "prepare_params_s": prep_s,
           "prefill_ms": prefill_ms, "decode_ms_per_token": step_ms,
           "decode_tokens_per_s": LM_BATCH / step_ms * 1e3,
           "tokens_per_s": LM_BATCH * LM_STEPS
           / (prefill_ms + LM_STEPS * step_ms) * 1e3,
           "peak_memory_gb": peak_gb, "plane_cache_gb": cache_gb,
           "launches_per_prefill": {"B1": B1_PER_STEP, "B4": B4_PER_PREFILL},
           "launches_per_decode_step": {"B1": B1_PER_STEP},
           "launches": launched}
    print(f"phase 14a: SmolLM-135M l2r + attn_l2r, batch {LM_BATCH}, "
          f"{LM_PROMPT}-token prompts, {LM_STEPS} decode steps on {smi}: "
          f"prefill {prefill_ms} ms, decode {step_ms} ms/token", flush=True)
    print("phase 14a: " + json.dumps(run), flush=True)
    print("phase 14a: decode step profile: " + json.dumps(prof_decode),
          flush=True)
    print("phase 14a: prefill profile: " + json.dumps(prof_prefill),
          flush=True)
    print(f"phase 14b: the plane-stacked key cache == re-extraction from the "
          f"float key cache, bit for bit, after the prefill and after "
          f"{LM_STEPS} decode steps ({slots} slots of {cfg.n_layers} "
          f"layers)",
          flush=True)
    del out, logits

    # 14c: B4 in the model against its plain version, B1 in every run
    def last_hidden():
        with torch.no_grad():
            st = tt.init_lm_state(cfg, LM_BATCH, LM_PROMPT, torch.float32,
                                  device=dev)
            h, _, _ = tt.lm_forward(cfg, params, tokens=prompt,
                                    mode="prefill", state=st)
        return h[:, -1:].float()

    h_b4 = last_hidden()
    h_plain = swapped_b4(last_hidden, fa.flash_attention_l2r_plain)
    h_lim = swapped_b4(last_hidden, bf16_limit_everywhere(
        142, fa.flash_attention_l2r_plain))
    rel = lambda h: ((h - h_plain).norm() / h_plain.norm()).item()  # noqa
    with torch.no_grad():
        lg_b4, lg_plain = (tt.logits_from_hidden(cfg, params,
                                                 h.to(torch.bfloat16))
                           for h in (h_b4, h_plain))
    b4 = {"hidden_rel_b4": rel(h_b4), "hidden_rel_bound": rel(h_lim),
          "hidden_max_abs_b4": (h_b4 - h_plain).abs().max().item(),
          "logits_max_abs_b4": (lg_b4.float() - lg_plain.float()).abs()
          .max().item(),
          "equal_greedy_tokens": (lg_b4.argmax(-1) == lg_plain.argmax(-1))
          .float().mean().item()}
    print("phase 14c: " + json.dumps(b4), flush=True)
    require(b4["hidden_rel_b4"] <= b4["hidden_rel_bound"],
            f"B4 moves the last-position hidden states by "
            f"{b4['hidden_rel_b4']} (relative) from the plain attention's, "
            f"beyond the {b4['hidden_rel_bound']} its bf16 limit spent at "
            f"every element gives")
    del h_b4, h_plain, h_lim

    # 14d: the early-exit decode walk at a tight and a loose tolerance;
    # the tight run also walks every layer's call at the loose tolerance
    # on the same inputs
    full_toks = seqs[:, :LM_EXIT_STEPS + 1]
    exits, exit_runs = {}, {}
    real_decode_attention = tt.decode_attention
    for tol in EXIT_TOLS:
        c = dataclasses.replace(cfg, attn_early_exit=True, attn_exit_tol=tol)
        paired = []

        def with_loose(*a, **kw):
            with attn_exit_tap() as loose:
                real_decode_attention(*a, **{**kw, "exit_tol": EXIT_TOLS[1]})
            paired.append(loose[0]["exit_levels"])
            return real_decode_attention(*a, **kw)

        if tol == EXIT_TOLS[0]:
            tt.decode_attention = with_loose
        try:
            reset_counts()
            with torch.no_grad(), attn_exit_tap() as rec:
                st, lg = make_prefill_step(c, max_len, torch.float32)(
                    params, batch)
                tk = torch.argmax(lg, -1).to(torch.int32)
                got = [tk]
                dec = make_decode_step(c)
                t0 = time.perf_counter()
                for _ in range(LM_EXIT_STEPS):
                    st, tk, _ = dec(params, st, tk)
                    got.append(tk)
                torch.cuda.synchronize()
                exit_ms = (time.perf_counter() - t0) * 1e3 / LM_EXIT_STEPS
            n = counts()
        finally:
            tt.decode_attention = real_decode_attention
        want = only(l2r_stacked_gemm=B1_PER_STEP * (LM_EXIT_STEPS + 1),
                    flash_attention_l2r=B4_PER_PREFILL)
        require(n == want, f"early exit at {tol}: launches {n}, expected "
                           f"{want}")
        require(len(rec) == cfg.n_layers * LM_EXIT_STEPS,
                f"attn_exit_tap recorded {len(rec)} calls, expected "
                f"{cfg.n_layers * LM_EXIT_STEPS}")
        got = torch.cat(got, 1)
        exits[str(tol)] = {
            **exit_histograms(rec, cfg.n_layers),
            ("decode_ms_per_token_with_loose_pair" if paired
             else "decode_ms_per_token"): exit_ms,
            "equal_tokens_to_full_depth": int((got[:, 1:]
                                               == full_toks[:, 1:]).sum()),
            "tokens": LM_BATCH * LM_EXIT_STEPS}
        exit_runs[tol] = rec
        if paired:
            later = sum(int((lo > r["exit_levels"]).sum())
                        for lo, r in zip(paired, rec))
            require(len(paired) == len(rec) and later == 0,
                    f"the loose walk exits later than the tight one on the "
                    f"same inputs at {later} rows")
            exits[str(tol)]["loose_on_same_inputs"] = exit_histograms(
                [{"exit_levels": lo, "levels_run": 0} for lo in paired],
                cfg.n_layers)
        print(f"phase 14d: tol {tol}: " + json.dumps(exits[str(tol)]),
              flush=True)
    print(f"phase 14d: the loose walk ({EXIT_TOLS[1]}) never exits later than "
          f"the tight one ({EXIT_TOLS[0]}) on the same inputs "
          f"({cfg.n_layers} layers x {LM_EXIT_STEPS} steps); tokens equal to full depth are printed, "
          f"not required (random weights)", flush=True)
    del params
    torch.cuda.empty_cache()
    bf16_row = next(r for r in b4_rows if r["name"] == "causal_bf16")
    lm_b4 = {key: bf16_row[key] * B4_PER_PREFILL
             for key in ("ms", "kernel_ms", "plain_ms", "library_ms",
                         "bound_ms")}
    return {"run": run, "b4": b4, "exits": exits, "lm_b4": lm_b4,
            "prof_decode": prof_decode, "prof_prefill": prof_prefill}


# ------------------------------------------------------------------ slice 9
# the phase 13 model served progressively: the streamed head (B2 scan, B1
# level slabs with early exit), bucketed prefill, the batcher, the gateway,
# the launcher's --wq and --gateway, prepared checkpoints
B1_DENSE = 30 * 6  # every dense of 30 layers; the head moves to B2
B2_HEAD_MS = (1, 4, 8)  # the head's rows: batcher prefill, gateway group,
#                         decode and prefill at batch 8
BUCKET_CASES = ((300, 512), (1500, 2048))
SERVE_REQUESTS, SERVE_SLOTS, SERVE_SEED, SERVE_GROUP = 16, 8, 150, 4
SERVE_MAX_LEN = 2080
SOLO_TOKENS = 8  # tokens of each request's solo run (batch 1)


def level_hist(levels: torch.Tensor) -> list[int]:
    return torch.bincount(levels.reshape(-1).long().cpu(),
                          minlength=N_LEVELS).tolist()


def progressive_run(cfg, params, prompt, early_exit: bool,
                    steps: int = LM_STEPS, mesh=None) -> dict:
    """A progressive prefill and ``steps`` decode steps, each call's
    launches counted and required: 180 B1 (+ 30 B5 in the prefill) and one
    B2 scan, or with early exit one B1 level slab per level the walk
    reports (the largest exit level + 1) in place of B2.  With ``mesh``
    the backbone runs replicated (hints off) and the head as the
    consensus walk; the counts are this rank's.  The cache holds
    LM_PROMPT + LM_STEPS positions either way."""
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    step_kw = dict(progressive=True, early_exit=early_exit, mesh=mesh)
    prefill = make_prefill_step(cfg, LM_PROMPT + LM_STEPS, torch.float32,
                                **step_kw)
    decode = make_decode_step(cfg, **step_kw)

    def want(lv, extra):
        walked = int(lv.max()) + 1
        if early_exit:
            return only(l2r_stacked_gemm=B1_DENSE + walked, **extra)
        return only(l2r_stacked_gemm=B1_DENSE, l2r_streaming_gemm=1,
                    **extra)

    launched = {k: 0 for k in KERNELS}
    walked = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_counts()
        state, logits, tok, lv = prefill(params, {"tokens": prompt})
        n = counts()
        require(n == want(lv, {"flash_attention": B5_PER_PREFILL}),
                f"progressive prefill (early_exit={early_exit}) launches "
                f"{n}")
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launched = {k: launched[k] + n[k] for k in n}
        walked.append(int(lv.max()) + 1)
        toks, lvs, lgs = [tok], [lv], [logits[:, 0]]
        t0 = time.perf_counter()
        for i in range(steps):
            reset_counts()
            state, tok, logits, lv = decode(params, state, tok)
            n = counts()
            require(n == want(lv, {}), f"progressive decode step {i} "
                                       f"(early_exit={early_exit}) launches "
                                       f"{n}")
            launched = {k: launched[k] + n[k] for k in n}
            walked.append(int(lv.max()) + 1)
            toks.append(tok)
            lvs.append(lv)
            lgs.append(logits[:, 0])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"tokens": torch.cat(toks, 1), "levels": torch.cat(lvs, 1),
            "logits": lgs, "prefill_ms": prefill_ms, "step_ms": step_ms,
            "launches": launched, "levels_walked": walked}


def b2_head_rows(dev) -> list[dict]:
    """15c: kernel B2 at the LM head's shapes on the head cache's layout
    (the D-plane view of the window-padded K-major stack, read in place):
    bit for bit against its plain version, timed beside its bound and
    torch._int_mm on the final plane."""
    from repro_torch.core.quant import (PlaneOperands, stack_planes_lhs,
                                        stack_planes_rhs)
    from repro_torch.kernels.l2r_gemm import kernel

    k, n = LM_HEAD
    g = torch.Generator(device=dev).manual_seed(153)
    rows = []
    for m in B2_HEAD_MS:
        a, b = operands(g, dev, m, k, n, 8)
        sa = stack_planes_lhs(a)
        po = PlaneOperands.prepare_rhs(b, shifted=True, window_pad=True,
                                       k_major=True)
        view = po.core_stack(True)
        require(kernel._k_major(view)[0].data_ptr() == view.data_ptr(),
                "the head cache's view is not read in place")
        sb = stack_planes_rhs(b)  # row-major, for the plain version
        for levels in (None, 5):
            n_lv = N_LEVELS if levels is None else levels
            got = kernel.l2r_gemm_streaming_planes(sa, view, levels=levels)
            ref = kernel.l2r_gemm_streaming_planes_plain(sa, sb,
                                                         levels=levels)
            require(torch.equal(got, ref),
                    f"B2 != plain at the LM head M={m} levels={levels}")
            err = max_err(got, ref)
            del got, ref
            fn = lambda: kernel.l2r_gemm_streaming_planes(  # noqa: E731
                sa, view, levels=levels)
            lib, lib_fn, padded = int_mm(a, b)
            if levels is None:
                require(torch.equal(lib, kernel.l2r_gemm_stacked_planes(
                    sa, view)), f"torch._int_mm disagrees with the final "
                                f"plane at M={m}")
            d = 4
            bound_ms, by = cost_bound(*kernel.streaming_cost(m, k, n, d,
                                                             n_lv))
            row = {"name": f"head M={m} levels={levels}", "m": m, "k": k,
                   "n": n, "levels": levels, "where": "head",
                   "count": 1 if (m == LM_BATCH and levels is None) else 0,
                   "ms": time_ms(fn), "kernel_ms": stream_ms(fn),
                   "device_ms": device_ms(fn, "B2"),
                   "plain_ms": time_ms(lambda: kernel
                                       .l2r_gemm_streaming_planes_plain(
                                           sa, sb, levels=levels),
                                       iters=3, warmup=1),
                   "library_ms": time_ms(lib_fn), "bound_ms": bound_ms,
                   "bound_by": by, "max_abs_err": err,
                   "int_mm_padded": padded, "b_layout": "K-major view"}
            rows.append(row)
            print("phase 15c: " + json.dumps(row), flush=True)
        del a, b, sa, sb, po, view
        torch.cuda.empty_cache()
    print(f"phase 15c: B2 == plain (bit for bit, every plane) at the LM "
          f"head's shapes (K={k}, N={n}, M in {B2_HEAD_MS}, levels None and "
          f"5) on the head cache's K-major view; library_ms is "
          f"torch._int_mm on the unstacked operands (the final plane only)",
          flush=True)
    return rows


def bucket_check(cfg, params, dev) -> dict:
    """15d: a prompt right-padded in its bucket gives the unpadded
    prefill's k, v and positions at every real slot of every layer, its
    logits, first token and exit level, bit for bit."""
    from repro_torch.serve.engine import (make_bucket_prefill_step,
                                          make_prefill_step)

    out = {}
    max_len = SERVE_MAX_LEN
    bucket = make_bucket_prefill_step(cfg, max_len, torch.float32,
                                      progressive=True)
    plain = make_prefill_step(cfg, max_len, torch.float32, progressive=True)
    with torch.no_grad():
        for n, lb in BUCKET_CASES:
            p = lm_prompt(dev, 1, n, cfg.vocab, 154 + n)
            padded = torch.zeros((1, lb), dtype=torch.int32, device=dev)
            padded[:, :n] = p
            st_b, lg_b, tok_b, lv_b = bucket(
                params, padded, torch.full((1,), n, dtype=torch.int32,
                                           device=dev))
            st_u, lg_u, tok_u, lv_u = plain(params, {"tokens": p})
            cb, cu = st_b.stack[0], st_u.stack[0]
            for name in ("k", "v", "positions"):
                a, b = getattr(cb, name), getattr(cu, name)
                require(torch.equal(a, b) if name == "positions"
                        else torch.equal(a[:, :, :n], b[:, :, :n]),
                        f"bucketed prefill ({n} in {lb}): {name} differs")
            require(torch.equal(st_b.pos, st_u.pos)
                    and torch.equal(lg_b, lg_u) and torch.equal(tok_b, tok_u)
                    and torch.equal(lv_b, lv_u),
                    f"bucketed prefill ({n} in {lb}): pos, logits, token or "
                    f"exit level differ")
            out[f"{n}_in_{lb}"] = {"layers": cfg.n_layers,
                                   "real_slots_equal": True,
                                   "exit_level": int(lv_b[0, 0])}
            del st_b, st_u
    print("phase 15d: bucketed == unbucketed prefill, bit for bit (k, v and "
          "positions of every layer at the real slots, pos, logits, token, "
          "exit level): " + json.dumps(out), flush=True)
    return out


def serve_requests(cfg, max_new_cap: int | None = None):
    from repro_torch.core.policy import PrecisionClass
    from repro_torch.serve import Request

    rng = np.random.default_rng(SERVE_SEED)
    lengths = rng.integers(16, 2049, SERVE_REQUESTS)
    max_new = rng.integers(16, 33, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32)
               for n in lengths]
    classes = [PrecisionClass.exact(), PrecisionClass.budget(3),
               PrecisionClass.bounded()]
    return [Request(uid=i, prompt=p, max_new_tokens=int(
        mn if max_new_cap is None else min(mn, max_new_cap)),
        precision=classes[i % 3])
        for i, (p, mn) in enumerate(zip(prompts, max_new))]


def served(reqs) -> list:
    """Each request's tokens, exit levels and prefill exit level."""
    return [(r.output, r.exit_levels, r.prefill_exit_level) for r in reqs]


def served_stats(engine) -> dict:
    """An engine's stats without what the host clock measures."""
    st = engine.stats(latency=False)
    st.pop("tokens_per_s", None)
    return st


def engine_stats(st: dict, launched: dict, seconds: float) -> dict:
    keep = ("steps", "prefills", "tokens", "completed", "buckets",
            "mean_exit_level", "mean_prefill_exit_level",
            "exit_level_hist_by_class", "prefill_exit_level_hist_by_class",
            "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s")
    return {**{k: st[k] for k in keep if k in st}, "seconds": seconds,
            "launches": {k: v for k, v in launched.items() if v}}


def solo_margin(cfg, params, req, at: int, dev) -> float:
    """The top-1/top-2 margin of the full-depth logits at token ``at`` of
    a request's solo run, replayed at batch 1 on its own tokens."""
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    with torch.no_grad():
        state, logits = make_prefill_step(cfg, SERVE_MAX_LEN, torch.float32)(
            params, {"tokens": torch.from_numpy(req.prompt)[None].to(dev)})
        decode = make_decode_step(cfg)
        for t in req.output[:at]:
            tok = torch.full((1, 1), t, dtype=torch.int32, device=dev)
            state, _, logits = decode(params, state, tok)
        top2 = torch.topk(logits.float().reshape(-1), 2).values
    return float(top2[0] - top2[1])


def batcher_vs_gateway(cfg, params, dev) -> dict:
    """15e: 16 requests of mixed lengths and classes through the
    continuous batcher and the gateway (8 slots, progressive, early
    exit): the gateway must serve the batcher's tokens, exit levels and
    prefill exit levels.  Each request's solo run (batch 1, its first
    SOLO_TOKENS tokens) is compared and printed with the top-2 margin at
    its first divergence, not required."""
    from repro_torch.serve import ContinuousBatcher, ServingGateway
    from repro_torch.serve.batching import _tensors

    out = {}
    with torch.no_grad():
        breqs = serve_requests(cfg)
        eng = ContinuousBatcher(cfg, params, n_slots=SERVE_SLOTS,
                                max_len=SERVE_MAX_LEN, progressive=True,
                                early_exit=True, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        for r in breqs:
            eng.submit(r)
        out["audit22_batcher"] = run_audited(eng, "15e batcher")
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
        st = eng.stats(latency=True)
        out["batcher"] = engine_stats(st, counts(), b_s)
        out["batcher"]["tokens"] = sum(len(r.output) for r in breqs)
        out["batcher"]["tokens_per_s"] = out["batcher"]["tokens"] / b_s
        # phase 19b holds the "batch" layout to these
        out["batcher_reqs"] = served(breqs)
        out["batcher_stats"] = served_stats(eng)
        out["batcher_state_bytes"] = sum(
            t.numel() * t.element_size() for t in _tensors(eng.state))
        print("phase 15e: batcher: " + json.dumps(out["batcher"]),
              flush=True)
        del eng
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        gw = ServingGateway(cfg, params, n_slots=SERVE_SLOTS,
                            max_len=SERVE_MAX_LEN, progressive=True,
                            early_exit=True, prefill_group=SERVE_GROUP,
                            device=dev)
        warm_s = time.perf_counter() - t0
        greqs = serve_requests(cfg)
        reset_counts()
        t0 = time.perf_counter()
        gw.run(greqs)
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        n = counts()
        gw.close()
        from repro_torch.analysis.compiled import audit_gateway

        out["audit22_gateway"] = audit_gateway(gw, "15e gateway")
        require(out["audit22_gateway"]["ok"],
                f"22c 15e gateway: {out['audit22_gateway']['violations']}")
        gst = gw.stats()
        out["gateway_reqs"] = served(greqs)
        out["gateway_stats"] = served_stats(gw)
        out["gateway"] = {**engine_stats(gst, n, g_s),
                          "tokens_per_s": gst["tokens_per_s"],
                          "warmup_s": warm_s,
                          "warmup_s_by_bucket": {str(k): v for k, v in
                                                 gw.warmup_s.items()}}
        print("phase 15e: gateway: " + json.dumps(out["gateway"]),
              flush=True)
        for b, g in zip(breqs, greqs):
            require(b.output == g.output, f"gateway tokens != batcher's for "
                                          f"request {b.uid}")
            require(b.exit_levels == g.exit_levels
                    and b.prefill_exit_level == g.prefill_exit_level,
                    f"gateway exit levels != batcher's for request {b.uid}")
        del gw
        torch.cuda.empty_cache()

        solo = ContinuousBatcher(cfg, params, n_slots=1,
                                 max_len=SERVE_MAX_LEN, progressive=True,
                                 early_exit=True, device=dev)
        sreqs = serve_requests(cfg, SOLO_TOKENS)
        t0 = time.perf_counter()
        for r in sreqs:
            solo.submit(r)
        solo.run()
        torch.cuda.synchronize()
        solo_s = time.perf_counter() - t0
    equal, total, first = 0, 0, []
    for b, s_ in zip(breqs, sreqs):
        m = len(s_.output)
        same = [x == y for x, y in zip(b.output[:m], s_.output)]
        equal += sum(same)
        total += m
        if not all(same):
            at = same.index(False)
            first.append({"uid": b.uid, "at": at,
                          "class": b.precision.label(),
                          "top2_margin": solo_margin(cfg, params, s_, at,
                                                     dev)})
    out["solo"] = {"equal_tokens": equal, "tokens": total,
                   "share": equal / total, "first_divergence": first,
                   "seconds": solo_s}
    print(f"phase 15e: gateway == batcher (tokens, exit levels, prefill exit "
          f"levels) for {SERVE_REQUESTS} requests; solo runs (batch 1, the "
          f"first {SOLO_TOKENS} tokens, printed, not required): "
          + json.dumps(out["solo"]), flush=True)
    return out


def launcher_and_checkpoint(cfg, params, dev) -> dict:
    """15f: the launcher's --wq and --gateway at full width for 4 steps on
    the card, and a prepared tree saved and loaded: equal to the live tree
    bit for bit, serving the same tokens."""
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stdout

    from repro_torch.checkpoint import load_prepared, save_prepared
    from repro_torch.checkpoint.manager import _leaves
    from repro_torch.core.quant import PlaneOperands
    from repro_torch.launch import serve as launch
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import lm_build
    from repro_torch.serve import ContinuousBatcher, Request

    out = {}
    for flags in (["--wq"], ["--wq", "--gateway"], ["--l2r", "--gateway"]):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            seqs = launch.main(["--arch", LM_ARCH, "--batch", str(LM_BATCH),
                                "--prompt-len", "64", "--steps", "4",
                                *flags])
        key = " ".join(flags)
        require(seqs.shape == (LM_BATCH, 4)
                and bool(((seqs >= 0) & (seqs < cfg.vocab)).all()),
                f"launch.serve {key}: tokens out of range")
        out[key] = {"seconds": time.perf_counter() - t0,
                    "summary": buf.getvalue().splitlines()[0]}
        print(f"phase 15f: launch.serve {key}: " + json.dumps(out[key]),
              flush=True)
    torch.cuda.empty_cache()

    (ROOT / "build").mkdir(exist_ok=True)  # ignored by git, as the kernels
    ckpt = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        path = str(ckpt / "prepared.npz")
        t0 = time.perf_counter()
        save_prepared(params, path)
        save_s = time.perf_counter() - t0
        template = tree_map(lambda p: torch.empty(
            p.shape, dtype=p.dtype, device="meta"), lm_build(cfg))
        t0 = time.perf_counter()
        loaded = load_prepared(cfg, template, path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size_gb = Path(path).stat().st_size / 1e9
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for (k, a), (_, b) in zip(_leaves(params), _leaves(loaded)):
        if isinstance(a, PlaneOperands):
            require(a.stack.stride() == b.stack.stride(),
                    f"checkpoint: {k} lost its layout")
            a, b = a.stack, b.stack
        require(torch.equal(a, b), f"checkpoint: {k} differs")
    prompt = np.random.default_rng(155).integers(0, cfg.vocab, (LM_BATCH, 64))

    def serve(tree):
        eng = ContinuousBatcher(cfg, tree, n_slots=LM_BATCH, max_len=96,
                                progressive=True, early_exit=True,
                                device=dev)
        reqs = [Request(uid=i, prompt=p.astype(np.int32), max_new_tokens=4)
                for i, p in enumerate(prompt)]
        for r in reqs:
            eng.submit(r)
        with torch.no_grad():
            eng.run()
        return [(r.output, r.exit_levels) for r in reqs]

    require(serve(params) == serve(loaded),
            "the loaded prepared tree serves other tokens")
    del loaded
    torch.cuda.empty_cache()
    out["checkpoint"] = {"file_gb": size_gb, "save_s": save_s,
                         "load_s": load_s, "bit_identical": True,
                         "same_tokens": True}
    print("phase 15f: prepared checkpoint: " + json.dumps(out["checkpoint"]),
          flush=True)
    return out


def phase_serve(dev, lm: dict) -> dict:
    """SmolLM-135M served progressively (phase 15): the scan and the
    early-exit walk against phase 13's tokens and logits, B2 at the head's
    shapes, bucketed prefill, the batcher against the gateway, the
    launcher's new modes and a prepared checkpoint."""
    from repro_torch.models.transformer import init_lm_state, lm_forward, \
        logits_from_hidden
    from repro_torch.serve.engine import (make_decode_step,
                                          progressive_logits_from_hidden)

    t_phase = time.perf_counter()
    smi = card()
    cfg, params, _ = lm_model(dev)
    prompt = lm_prompt(dev, LM_BATCH, LM_PROMPT, cfg.vocab, 130)

    # 15a: the scan, one B2 launch a step
    scan = progressive_run(cfg, params, prompt, early_exit=False)
    require(torch.equal(scan["tokens"], lm["seqs"]),
            "progressive tokens differ from phase 13's")
    require(all(torch.equal(a, b) for a, b in zip(scan["logits"],
                                                   lm["step_logits"])),
            "the scan's logits differ from phase 13's logits_from_hidden")
    with torch.no_grad():
        st = init_lm_state(cfg, LM_BATCH, LM_PROMPT, torch.float32,
                           device=dev)
        h, _, _ = lm_forward(cfg, params, tokens=prompt, mode="prefill",
                             state=st)
        h = h[:, -1:]
        del st
        lg_p, tok_p, _ = progressive_logits_from_hidden(cfg, params, h)
        require(torch.equal(lg_p, logits_from_hidden(cfg, params, h))
                and torch.equal(tok_p, lg_p.argmax(-1).int()),
                "the streamed head != logits_from_hidden on the same hidden "
                "states")
        # the head alone: B2 on the cache's view, no copy of the stack
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        progressive_logits_from_hidden(cfg, params, h)
        torch.cuda.synchronize()
        head_peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
        stack_mb = params["head_q"].planes.stack.numel() * 4 / 7 / 1e6
        require(head_peak_mb < stack_mb / 2,
                f"the streamed head allocated {head_peak_mb} MB: a copy of "
                f"the {stack_mb} MB plane stack")
        prof_head = profile_forward(
            lambda: progressive_logits_from_hidden(cfg, params, h))
        del h
    run = {"card": smi, "prefill_ms": scan["prefill_ms"],
           "decode_ms_per_token": scan["step_ms"],
           "decode_tokens_per_s": LM_BATCH / scan["step_ms"] * 1e3,
           "launches": scan["launches"],
           "launches_per_prefill": {"B1": B1_DENSE, "B5": B5_PER_PREFILL,
                                    "B2": 1},
           "launches_per_decode_step": {"B1": B1_DENSE, "B2": 1},
           "prefill_exit_hist": level_hist(scan["levels"][:, 0]),
           "decode_exit_hist": level_hist(scan["levels"][:, 1:]),
           "head_peak_mb": head_peak_mb, "head_stack_mb": stack_mb}
    print(f"phase 15a: progressive scan, batch {LM_BATCH}, {LM_PROMPT}-token "
          f"prompts, {LM_STEPS} steps on {smi}: decode "
          f"{scan['step_ms']} ms/token, {run['decode_tokens_per_s']} "
          f"tokens/s; tokens and logits == phase 13's, bit for bit",
          flush=True)
    print("phase 15a: " + json.dumps(run), flush=True)
    print("phase 15a: the streamed head alone (8 rows): "
          + json.dumps(prof_head), flush=True)

    # 15b: early exit on the same inputs
    early = progressive_run(cfg, params, prompt, early_exit=True)
    require(torch.equal(early["tokens"], scan["tokens"])
            and torch.equal(early["levels"], scan["levels"]),
            "early exit commits other tokens or levels than the scan")
    exit_run = {"decode_ms_per_token": early["step_ms"],
                "scan_decode_ms_per_token": scan["step_ms"],
                "prefill_ms": early["prefill_ms"],
                "launches": early["launches"],
                "levels_walked_hist": torch.bincount(torch.tensor(
                    early["levels_walked"]), minlength=N_LEVELS + 1)
                .tolist()[1:]}
    print(f"phase 15b: early exit: {early['step_ms']} ms/token against the "
          f"scan's {scan['step_ms']} on {smi}; tokens and exit levels == "
          f"15a's; " + json.dumps(exit_run), flush=True)

    # one progressive decode step profiled on a fresh prefill's state
    from repro_torch.serve.engine import make_prefill_step

    with torch.no_grad():
        state, _, tok, _ = make_prefill_step(
            cfg, LM_PROMPT + LM_STEPS, torch.float32, progressive=True)(
            params, {"tokens": prompt})
        decode = make_decode_step(cfg, progressive=True)
        prof_decode = profile_forward(lambda: decode(params, state, tok))
        del state
    print("phase 15a: progressive decode step profile: "
          + json.dumps(prof_decode), flush=True)
    # phase 18 holds the mesh's prefill and first MESH_STEPS steps to these
    n = MESH_STEPS + 1
    mesh_ref = {ee: (r["tokens"][:, :n].cpu(), r["levels"][:, :n].cpu(),
                     [lg.cpu() for lg in r["logits"][:n]])
                for ee, r in ((False, scan), (True, early))}
    hq = params["head_q"]
    head_bytes = hq.q.numel() + hq.planes.stack.numel() + \
        hq.scale.numel() * hq.scale.element_size()
    del scan["logits"], early["logits"]

    rows = b2_head_rows(dev)
    buckets = bucket_check(cfg, params, dev)
    engines = batcher_vs_gateway(cfg, params, dev)
    launcher = launcher_and_checkpoint(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"phase 15: {seconds:.1f} s", flush=True)
    return {"run": run, "early": exit_run, "rows": rows,
            "buckets": buckets, "engines": engines, "launcher": launcher,
            "prof_decode": prof_decode, "prof_head": prof_head,
            "seconds": seconds, "mesh_ref": mesh_ref,
            "head_bytes": head_bytes}


# ------------------------------------------------------------------ slice 10
# the other mixers at their published widths (src/repro/configs/*.py),
# served greedily through make_prefill_step / make_decode_step on the L2R
# path at full depth: bf16 compute, f32 caches and states, batch 8,
# seeded random weights
MIX_BATCH, MIX_STEPS = 8, 32
MIX_CHECK_PROMPT, MIX_CHECK_STEPS = 256, 2  # the plain-GEMM comparisons
MIXERS = {  # arch: prompt tokens, layers kept (None: all), prepared
    # params, (B1, B5) launches per prefill and per decode step
    "mamba2-130m": dict(
        prompt=2048, layers=None, prepared=False,
        # in_proj and out_proj of 24 layers, and the head
        prefill=(24 * 2 + 1, 0), step=(24 * 2 + 1, 0)),
    "recurrentgemma-2b": dict(
        prompt=2048, layers=None, prepared=False,
        # 18 rec layers x (gate_proj, rec_proj, out_proj, mlp wi, wo), 8
        # local layers x (q, k, v, o, wi, wo), the head (w_a, w_x are float
        # denses); B5 the prefill's 8 local attentions at head_dim 256
        # (the wide layout); decode attends on its cache, not through B5
        prefill=(18 * 5 + 8 * 6 + 1, 8), step=(18 * 5 + 8 * 6 + 1, 0)),
    "deepseek-moe-16b": dict(
        prompt=2048, layers=4, prepared=True,
        # layer 0 (q, k, v, o, wi, wo), 3 MoE layers x (q, k, v, o, the
        # router, 64 experts x (wi, wo), shared wi, wo), the head; B5 the
        # prefill's causal attention
        prefill=(6 + 3 * (4 + 1 + 128 + 2) + 1, 4),
        step=(6 + 3 * (4 + 1 + 128 + 2) + 1, 0)),
    "whisper-base": dict(
        prompt=128, layers=None, prepared=False,
        # encoder 6 x (q, k, v, o, wi, wo), decoder 6 x (self q, k, v, o,
        # cross q, k, v, o, wi, wo), the head; B5 6 encoder, 6 causal self,
        # 6 cross.  A step: 6 x (self q, k, v, o, cross q, o, wi, wo) and
        # the head; B5 the 6 cross-attentions at Sq = 1
        prefill=(6 * 6 + 6 * 10 + 1, 18), step=(6 * 8 + 1, 6)),
}
# the model whose prefill 16a also profiles on the plain chunk loop (B5
# kept off by its dispatch test): the device time B5 at dh 256 replaced
PLAIN_LOOP_ARCH = "recurrentgemma-2b"
DECODE_LIMIT = {  # tests/test_serve.py, tests/test_encdec_serve.py
    "mamba2-130m": 5e-2, "recurrentgemma-2b": 5e-2, "whisper-base": 1e-4}
MIX_PREFILL_M = MIX_BATCH * 2048  # the served prefill's rows (16b: 256)
MIX_GEMMS = [  # (M, K, N, launches per prefill or step, where): every
    # (K, N) of a 2048-token prefill at its M; decode's M = 8 and whisper's
    # served shapes are all under 16b's bit-for-bit runs
    (MIX_PREFILL_M, 768, 3352, 24, "mamba2 in_proj prefill"),
    (MIX_PREFILL_M, 1536, 768, 24, "mamba2 out_proj prefill"),
    (MIX_BATCH, 768, 3352, 24, "mamba2 in_proj decode"),
    (MIX_PREFILL_M, 2560, 2560, 18 * 3 + 8 * 2,
     "recurrentgemma gate_proj rec_proj out_proj wq wo prefill"),
    (MIX_PREFILL_M, 2560, 256, 8 * 2, "recurrentgemma wk wv prefill"),
    (MIX_PREFILL_M, 2560, 2 * 7680, 26, "recurrentgemma mlp wi prefill"),
    (MIX_PREFILL_M, 7680, 2560, 26, "recurrentgemma mlp wo prefill"),
    (MIX_PREFILL_M, 2048, 2048, 4 * 4, "deepseek wq wk wv wo prefill"),
    (MIX_PREFILL_M, 2048, 2 * 10944, 1, "deepseek layer-0 wi prefill"),
    (MIX_PREFILL_M, 10944, 2048, 1, "deepseek layer-0 wo prefill"),
    (MIX_PREFILL_M, 2048, 2 * 2816, 3, "deepseek shared wi prefill"),
    (MIX_PREFILL_M, 2816, 2048, 3, "deepseek shared wo prefill"),
    (MIX_PREFILL_M, 2048, 64, 3, "deepseek router prefill"),
    (1920, 2048, 2 * 1408, 3 * 64, "deepseek expert wi prefill"),
    (1920, 1408, 2048, 3 * 64, "deepseek expert wo prefill"),
    (MIX_BATCH, 2048, 2 * 1408, 3 * 64, "deepseek expert wi decode"),
    (MIX_BATCH, 1408, 2048, 3 * 64, "deepseek expert wo decode"),
]
MIX_B5 = [  # (model, name, Sq, Skv, H, dh, causal, launches per prefill or
    # step): B = 8, no GQA; 16b runs B5's plain version in its place
    ("whisper-base", "encoder_self", 1500, 1500, 8, 64, False, 6),
    ("whisper-base", "prefill_self", 128, 128, 8, 64, True, 6),
    ("whisper-base", "prefill_cross", 128, 1500, 8, 64, False, 6),
    ("whisper-base", "decode_cross", 1, 1500, 8, 64, False, 6),
    ("deepseek-moe-16b", "prefill_self", 2048, 2048, 16, 128, True, 4),
]


def mixer_model(dev, arch: str):
    """The full config with l2r (n=8, radix 4) at full depth, depth cut
    where MIXERS says, seeded random weights; prepared where it says."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.common import materialize
    from repro_torch.models.encdec import encdec_build
    from repro_torch.models.transformer import lm_build
    from repro_torch.serve.engine import prepare_params

    spec = MIXERS[arch]
    cfg = dataclasses.replace(get_config(arch), l2r=QuantConfig())
    if spec["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    build = encdec_build if cfg.family == "encdec" else lm_build
    params = materialize(build(cfg), torch.Generator(device=dev)
                         .manual_seed(160), device=dev)
    if spec["prepared"]:
        params = prepare_params(cfg, params)
    torch.cuda.synchronize()
    return cfg, params


def mixer_batch(cfg, dev, length: int, seed: int) -> dict:
    """Seeded prompts; for whisper also frame embeddings, seeded normal
    values (the reference's stub front end, configs/whisper_base.py)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (MIX_BATCH, length),
                                     dtype=torch.int32, device=dev,
                                     generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (MIX_BATCH, cfg.encoder_seq, cfg.d_model), generator=g,
            device=dev)
    return batch


def mixer_serve(arch: str, cfg, params, batch: dict) -> dict:
    """The serving run: a prefill and MIX_STEPS greedy decode steps, every
    call's launches exactly MIXERS', the steps timed (host clock,
    synchronized); then a profile of one decode step, a second prefill
    timed warm and a profile of one prefill."""
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    (b1p, b5p), (b1s, b5s) = MIXERS[arch]["prefill"], MIXERS[arch]["step"]
    length = batch["tokens"].shape[1]
    prefill = make_prefill_step(cfg, length + MIX_STEPS + 4, torch.float32)
    decode = make_decode_step(cfg)
    dev = batch["tokens"].device
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logits = prefill(params, batch)
        torch.cuda.synchronize()
        first_prefill_ms = (time.perf_counter() - t0) * 1e3
        n = counts()
        require(n == only(l2r_stacked_gemm=b1p, flash_attention=b5p),
                f"{arch} prefill launches {n}, expected {b1p} of B1, {b5p} "
                f"of B5 and no other")
        launched = dict(n)
        # phase 20c holds the split model to these
        logits_checksum = float(tree_checksum([logits.float()]).item())
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks = [tok]
        t0 = time.perf_counter()
        for i in range(MIX_STEPS):
            reset_counts()
            state, tok, lg = decode(params, state, tok)
            n = counts()
            require(n == only(l2r_stacked_gemm=b1s, flash_attention=b5s),
                    f"{arch} decode step {i} launches {n}, expected {b1s} "
                    f"of B1, {b5s} of B5 and no other")
            launched = {k: launched[k] + n[k] for k in n}
            toks.append(tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / MIX_STEPS
        seqs = torch.cat(toks, 1)
        require(logits.shape == (MIX_BATCH, 1, cfg.vocab)
                and bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(lg).all()),
                f"{arch}: non-finite or misshapen logits")
        require(bool(((seqs >= 0) & (seqs < cfg.vocab)).all()),
                f"{arch}: tokens out of range")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        prof_decode = profile_forward(lambda: decode(params, state, tok))
        del state
        # a second, warm prefill timed as phase 13 times its own
        prefill_ms = host_ms(lambda: prefill(params, batch))
        prof_prefill = profile_forward(lambda: prefill(params, batch))
        loop = {}
        if arch == PLAIN_LOOP_ARCH:  # the same prefill on the plain loop
            from repro_torch.models import attention as ta

            fits = ta.b5_fits
            ta.b5_fits = lambda *a: False
            try:
                reset_counts()
                loop = {"prof_prefill_plain_loop": profile_forward(
                    lambda: prefill(params, batch))}
                n = counts()
            finally:
                ta.b5_fits = fits
            require(n["flash_attention"] == 0,
                    f"{arch}: B5 launched with its dispatch switched off")
    return {"prefill_ms": prefill_ms, "first_prefill_ms": first_prefill_ms,
            **loop, "decode_ms_per_token": step_ms,
            "decode_tokens_per_s": MIX_BATCH / step_ms * 1e3,
            "tokens_per_s": MIX_BATCH * MIX_STEPS
            / (prefill_ms + MIX_STEPS * step_ms) * 1e3,
            "peak_memory_gb": peak_gb,
            "launches_per_prefill": {"B1": b1p, "B5": b5p},
            "launches_per_decode_step": {"B1": b1s, "B5": b5s},
            "launches": launched, "prof_decode": prof_decode,
            "prof_prefill": prof_prefill, "tokens": seqs.tolist(),
            "prefill_logits_checksum": logits_checksum}


def mixer_exact(arch: str, cfg, params, batch: dict, steps: int,
                levels=None) -> dict:
    """The model on B1 equals the model on B1's plain GEMM bit for bit:
    logits of the prefill and ``steps`` decode steps, B5 swapped for its
    plain version in both runs (as 13b)."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa

    c = dataclasses.replace(cfg, l2r_levels=levels)
    (b1p, _), (b1s, _) = MIXERS[arch]["prefill"], MIXERS[arch]["step"]

    def run():
        return swapped_b5(lambda: lm_greedy(c, params, batch, steps),
                          fa.flash_attention_kernel_plain)

    reset_counts()
    got = run()
    torch.cuda.synchronize()
    n = counts()
    require(n == only(l2r_stacked_gemm=b1p + steps * b1s),
            f"{arch} levels={levels}: launches {n}, expected "
            f"{b1p + steps * b1s} of B1 and no other")
    ref = plain_b1(run)
    require(all(torch.equal(a, b) for a, b in zip(got, ref)),
            f"{arch} levels={levels}: logits on B1 differ from the "
            f"plain-GEMM run")
    return {"levels": levels, "prompt": batch["tokens"].shape[1],
            "steps": steps + 1, "bit_identical": True}


def decode_errs(c, params, toks: torch.Tensor, frames) -> list[float]:
    """max |decode - train| at the last two positions: a prefill of all
    but the last two tokens, then two decode steps (whisper's without
    frames), against the train forward over all of them."""
    from repro_torch.models.encdec import encdec_forward, init_encdec_state
    from repro_torch.models.transformer import init_lm_state, lm_forward

    b, s = toks.shape[0], toks.shape[1] - 2
    dev = toks.device
    with torch.no_grad():
        if c.family == "encdec":
            h, _, _ = encdec_forward(c, params, tokens=toks, frames=frames)
            st = init_encdec_state(c, b, s + 2, torch.float32, device=dev)
            _, st, _ = encdec_forward(c, params, tokens=toks[:, :s],
                                      frames=frames, mode="prefill", state=st)
            step = lambda t, st: encdec_forward(  # noqa: E731
                c, params, tokens=t, mode="decode", state=st)
        else:
            h, _, _ = lm_forward(c, params, tokens=toks)
            st = init_lm_state(c, b, s + 2, torch.float32, device=dev)
            _, st, _ = lm_forward(c, params, tokens=toks[:, :s],
                                  mode="prefill", state=st)
            step = lambda t, st: lm_forward(  # noqa: E731
                c, params, tokens=t, mode="decode", state=st)
        errs = []
        for i in range(2):
            hd, st, _ = step(toks[:, s + i:s + i + 1], st)
            errs.append((hd[:, 0] - h[:, s + i]).abs().max().item())
    return errs


def decode_vs_train(arch: str, cfg, params, batch: dict) -> dict:
    """tests/test_serve.py's and test_encdec_serve.py's spec at full
    width, in their setting (f32 compute, the float path, their limits):
    decode against the train forward at the last two positions
    (``decode_errs``).  mamba2 and recurrentgemma are held on the served
    weights.  whisper is held on its weights with the stacked matrices at
    the scale of their width (``fan_in_scaled``); its reading on the
    served weights is printed beside it and not held (on the CPU such a
    decoder, its residual stream |x| ~ 2000, magnifies a last-bit
    difference about 1e5-fold: one row's train forward alone and in a
    batch of two differ by 2.4e-2; rescaled, by 1.9e-6)."""
    import dataclasses

    from repro_torch.models.common import fan_in_scaled

    c = dataclasses.replace(cfg, l2r=None, compute_dtype="float32")
    toks, frames = batch["tokens"], batch.get("frames")
    s = toks.shape[1] - 2
    out = {"positions": [s, s + 1], "limit": DECODE_LIMIT[arch]}
    if c.family == "encdec":
        out["served_weights_max_abs"] = decode_errs(c, params, toks, frames)
        params, out["weights"] = fan_in_scaled(c, params), "fan_in_scaled"
    else:
        out["weights"] = "served"
    errs = out["max_abs"] = decode_errs(c, params, toks, frames)
    require(max(errs) <= DECODE_LIMIT[arch],
            f"{arch}: decode differs from the train forward by {errs} on "
            f"the {out['weights']} weights (limit {DECODE_LIMIT[arch]})")
    return out


def moe_card_vs_cpu(cfg, params, dev) -> dict:
    """The RG-LRU scan on the card equal to the CPU's bit for bit on the
    same (a, b); the MoE routing integers on the card equal the CPU's on
    the same bf16-rounded logits at the prefill's T (ties included, four
    experts favoured so that assignments are dropped); two
    runs of deepseek's first MoE layer on the card identical bit for
    bit."""
    from repro_torch.models.moe import moe_apply, moe_capacity, moe_route
    from repro_torch.models.rglru import lru_scan
    from repro_torch.models.transformer import layer_slice

    g = torch.Generator().manual_seed(161)
    a = torch.rand((MIX_BATCH, 2048, 256), generator=g) * 0.999 + 0.001
    b = torch.randn((MIX_BATCH, 2048, 256), generator=g)
    (ra, rb), (ga, gb) = lru_scan(a, b), lru_scan(a.to(dev), b.to(dev))
    require(torch.equal(ga.cpu(), ra) and torch.equal(gb.cpu(), rb),
            "the RG-LRU scan on the card differs from the CPU's bits")
    t = MIX_BATCH * 2048
    lg = torch.randn((t, cfg.n_experts), generator=g) * 0.5
    lg[:, :4] += 1.0  # four favoured experts: past the capacity
    lg = lg.to(torch.bfloat16).float()
    cap = moe_capacity(cfg, t)
    got, ref = moe_route(cfg, lg.to(dev), cap), moe_route(cfg, lg, cap)
    require(all(torch.equal(x.cpu(), y) for x, y in zip(got[2:], ref[2:])),
            "MoE routing (expert_idx, slot, keep) on the card differs from "
            "the CPU's")
    require(not bool(ref[4].all()), "the routing check dropped nothing")
    lp = layer_slice(params["stack"][0], 0)["ffn"]
    x = torch.randn((MIX_BATCH, 256, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(164)) \
        .to(torch.bfloat16)
    with torch.no_grad():
        y1, aux1 = moe_apply(cfg, lp, x)
        y2, aux2 = moe_apply(cfg, lp, x)
    require(torch.equal(y1, y2) and torch.equal(aux1, aux2),
            "two runs of a MoE layer on the card differ")
    return {"rglru_scan_bits_equal": [MIX_BATCH, 2048, 256],
            "routing_equal": {"T": t, "cap": cap,
                              "dropped": int((~ref[4]).sum())},
            "moe_layer_runs_identical": True}


def b5_mixer_rows(dev) -> list[dict]:
    """Kernel B5 at the served attention shapes of phase 16 (MIX_B5):
    f32 and bf16 against the plain version within ATTN_TOL, the bf16 call
    (the models') timed beside the plain version, the bound and
    scaled_dot_product_attention."""
    from repro_torch.device import no_tf32
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(165)
    b = MIX_BATCH
    rows = []
    for model, name, sq, skv, h, dh, causal, count in MIX_B5:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_qkv(g, dev, b, sq, skv, h, h, dh, dtype)
            got = fa.flash_attention(q, k, v, causal=causal)
            ref = fa.flash_attention_kernel_plain(q, k, v, causal)
            err, excess = attn_err(got, ref)
            require(got.shape == q.shape and excess <= ATTN_TOL[dtype][1],
                    f"B5 at {model}'s {name} ({dtype}): max |d| {err} from "
                    f"plain, {excess} beyond the relative term")
        del got, ref
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                     iters=5, warmup=1)
        kernel_ms = stream_ms(lambda: fa.flash_attention(q, k, v,
                                                         causal=causal))
        plain_ms = time_ms(lambda: fa.flash_attention_kernel_plain(
            q, k, v, causal), iters=3, warmup=1)
        with no_tf32():
            _, lib_fn = sdpa(q, k, v, causal, None)
            lib_ms = time_ms(lib_fn, iters=5, warmup=1)
        pairs = visible_pairs(sq, skv, causal, None)
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        bound_ms, by = attn_bound(b, h, dh, pairs, dtype, nbytes)
        row = {"name": f"{model} {name}", "count": count, "B": b, "Sq": sq,
               "Skv": skv, "H": h, "dh": dh, "causal": causal,
               "dtype": "bfloat16",
               "visible_pairs": pairs, "ms": ms, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err}
        rows.append(row)
        print("phase 16e: " + json.dumps(row), flush=True)
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def phase_mixers(dev) -> dict:
    """The other mixers served at full width (phase 16): per model the
    serving run with exact launch counts, timed and profiled (16a); the
    model on B1 equal to the model on the plain GEMM, at full depth for
    every model and at levels=5 for mamba2 (16b); decode against the
    train forward (16c); the card against the CPU (16d); B5 at the served
    attention shapes (16e) and B1 at every served GEMM shape the 16b runs
    do not reach (16f)."""
    t_phase = time.perf_counter()
    smi = card()
    runs = {}
    for arch, spec in MIXERS.items():
        t0 = time.perf_counter()
        cfg, params = mixer_model(dev, arch)
        run = mixer_serve(arch, cfg, params,
                          mixer_batch(cfg, dev, spec["prompt"], 162))
        small = mixer_batch(cfg, dev, min(spec["prompt"], MIX_CHECK_PROMPT),
                            163)
        exact = [mixer_exact(arch, cfg, params, small, MIX_CHECK_STEPS)]
        if arch == "mamba2-130m":
            exact.append(mixer_exact(arch, cfg, params, small, 1, levels=5))
        run["exact"] = exact
        print(f"phase 16b: {arch}: B1 under the model == plain GEMM bit for "
              f"bit: " + json.dumps(exact), flush=True)
        if arch in DECODE_LIMIT:
            run["decode_vs_train"] = decode_vs_train(
                arch, cfg, params,
                mixer_batch(cfg, dev, min(spec["prompt"], MIX_CHECK_PROMPT)
                            + 2, 166))
            print(f"phase 16c: {arch}: decode == train forward: "
                  + json.dumps(run["decode_vs_train"]), flush=True)
        if cfg.family == "moe":
            run["card_vs_cpu"] = moe_card_vs_cpu(cfg, params, dev)
            print("phase 16d: " + json.dumps(run["card_vs_cpu"]), flush=True)
        del params
        torch.cuda.empty_cache()
        run["seconds"] = time.perf_counter() - t0
        pd, pp = run["prof_decode"], run["prof_prefill"]
        print(f"phase 16a: {arch} l2r, batch {MIX_BATCH}, {spec['prompt']}-"
              f"token prompts, {MIX_STEPS} steps on {smi}: prefill "
              f"{run['prefill_ms']} ms, decode {run['decode_ms_per_token']} "
              f"ms/token, {run['tokens_per_s']} tokens/s, peak "
              f"{run['peak_memory_gb']} GB; decode step device "
              f"{pd.get('device_ms')} ms (B1 {pd.get('B1_ms')}, B5 "
              f"{pd.get('B5_ms')}, other {pd.get('other_ms')}), idle "
              f"{pd.get('idle_share')}; prefill device {pp.get('device_ms')} "
              f"ms (B1 {pp.get('B1_ms')}, B5 {pp.get('B5_ms')}, other "
              f"{pp.get('other_ms')}), idle {pp.get('idle_share')}; "
              f"{run['seconds']:.1f} s", flush=True)
        if "prof_prefill_plain_loop" in run:
            pl = run["prof_prefill_plain_loop"]
            print(f"phase 16a: {arch}: the prefill on the plain chunk loop "
                  f"(no B5): device {pl.get('device_ms')} ms (B1 "
                  f"{pl.get('B1_ms')}, other {pl.get('other_ms')}); with B5 "
                  f"{pp.get('device_ms')} ms (B5 {pp.get('B5_ms')})",
                  flush=True)
        print(f"phase 16a: {arch}: " + json.dumps(run), flush=True)
        runs[arch] = run
    b5_rows = b5_mixer_rows(dev)
    g = torch.Generator(device=dev).manual_seed(167)
    b1_rows = [b1_shape_row(g, dev, *shape, "16f") for shape in MIX_GEMMS]
    seconds = time.perf_counter() - t_phase
    print(f"phase 16: {seconds:.1f} s", flush=True)
    return {"runs": runs, "b5_rows": b5_rows, "b1_rows": b1_rows,
            "seconds": seconds}


# ------------------------------------------------------------------ slice 11
# training: SmolLM-135M at its published widths through make_train_step
# (f32 compute, remat, the pipeline's structured stream), B5 under every
# attention forward; the step on B5 against the step on its plain
# version; the ten smoke architectures on the card against the CPU; the
# kernels' backward (the plain loop's gradient, fault C2) against the
# plain route's
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_XENT = 8, 2048, 8, 512
B5_PER_TRAIN_STEP = 2 * 30  # forward and remat's recompute, 30 layers
# 17b (B5 against its plain version, one card): the loss within 1e-5 of
# itself, the grad norm 1e-4, each leaf's gradient within 1e-3 of its
# norm plus 1e-6 of the whole gradient's (the form of 17c and the CPU
# parity tests: a leaf whose gradient nearly cancels, like the key
# projection's under softmax's shift invariance, carries more rounding
# than its own norm), each leaf's update (p' - p) within 1e-2 of the
# update's norm (a gradient element near 0 can flip the sign of its
# first Adam update)
TRAIN_B5_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grad": 1e-3,
                "grad_abs": 1e-6, "update": 1e-2}
# 17c (the card against the CPU, smoke configs, a conditioned optimizer
# state at lr 1e-3): the loss within 1e-5 of itself, each leaf's gradient
# within rtol of its norm plus 1e-6 of the whole gradient's, each param
# within 1e-5 (1 % of lr); whisper-base's smoke decoder magnifies last
# bits (its stacked weights draw their std from the layers axis)
SMOKE_GRAD_RTOL = {"whisper-base": 3e-3}
SMOKE_GRAD_RTOL_DEFAULT = 1e-3
BWD_SHAPES = [  # (name, B, S, H, Kv, dh): fault C2's input, SmolLM's
    ("c2", 1, 8, 1, 1, 64), ("smollm", TRAIN_BATCH, TRAIN_SEQ, 9, 3, 64)]


def tree_close(got: list, want: list, rtol: float, atol: float = 0.0):
    """max over leaves of |got - want| / (rtol |want| + atol), norm-wise
    per leaf (<= 1 passes); NaN where the NaN patterns differ."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.float().cpu(), b.float().cpu()
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return float("nan")
        ok = ~torch.isnan(b)
        err = (a[ok] - b[ok]).norm().item()
        lim = rtol * b[ok].norm().item() + atol
        worst = max(worst, err / lim if lim else (0.0 if err == 0 else
                                                  float("inf")))
    return worst


def train_smollm(dev) -> dict:
    """17a: SmolLM-135M trained TRAIN_STEPS steps at batch 8 x 2048 with
    exact B5 launches a step, finite losses and every leaf moved; the
    warm step timed and profiled."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, ShardedPipeline
    from repro_torch.models.common import materialize, tree_leaves
    from repro_torch.models.transformer import lm_build
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import TrainConfig, make_train_step

    cfg = dataclasses.replace(get_config(LM_ARCH), compute_dtype="float32")
    params = materialize(lm_build(cfg), torch.Generator(device=dev)
                         .manual_seed(170), device=dev)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    tcfg = TrainConfig(remat=True, seq_shard=False, xent_chunk=TRAIN_XENT)
    step = make_train_step(cfg, ocfg, tcfg)
    pipe = ShardedPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses, gnorms, launched = [], [], [], 0
    for i in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 next(pipe).items()}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        new_p, new_o, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        n = counts()
        require(n == only(flash_attention=B5_PER_TRAIN_STEP),
                f"train step {i} launches {n}, expected "
                f"{B5_PER_TRAIN_STEP} of B5 and no other")
        launched += n["flash_attention"]
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        require(np.isfinite(losses[-1]), f"train step {i}: loss "
                f"{losses[-1]}")
        still = [j for j, (a, b) in enumerate(zip(tree_leaves(params),
                                                  tree_leaves(new_p)))
                 if torch.equal(a, b)]
        require(not still, f"train step {i}: leaves {still} did not move")
        params, opt = new_p, new_o
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    peak_gb = peak_bytes / 1e9
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
    prof = profile_forward(lambda: step(params, opt, batch))
    warm = statistics.median(times[2:])
    run = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "compute_dtype": "float32", "remat": True,
           "xent_chunk": TRAIN_XENT, "step_ms": times,
           "warm_step_ms": warm,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / warm * 1e3,
           "peak_memory_gb": peak_gb, "peak_memory_bytes": peak_bytes,
           "losses": losses,
           "grad_norms": gnorms,
           "launches": launched, "launches_per_step": B5_PER_TRAIN_STEP,
           "profile": prof}
    return {"cfg": cfg, "ocfg": ocfg, "tcfg": tcfg, "params": params,
            "opt": opt, "batch": batch, "run": run}


def b5_vs_plain_step(tr: dict, params) -> dict:
    """One step of 17a's model from ``params`` and 17a's optimizer state,
    on B5 and on B5's plain version: the loss, the grad norm, each leaf's
    gradient and update; every leaf's gradient on B5 finite and
    non-zero."""
    from repro_torch.checkpoint.manager import _leaves
    from repro_torch.device import no_tf32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.train.step import make_loss_fn, value_and_grad

    opt, batch = tr["opt"], tr["batch"]
    loss_fn = make_loss_fn(tr["cfg"], tr["tcfg"])

    def one():
        with no_tf32():
            loss, _, grads = value_and_grad(loss_fn, params, batch)
            new_p, _, om = adamw_update(tr["ocfg"], grads, params, opt)
        return loss, tree_leaves(grads), tree_leaves(new_p), om

    reset_counts()
    loss, grads, new_p, om = one()
    n_kernel = counts()
    reset_counts()
    p_loss, p_grads, p_new, p_om = swapped_b5(
        one, fa.flash_attention_kernel_plain)
    n_plain = counts()
    require(n_kernel == only(flash_attention=B5_PER_TRAIN_STEP)
            and n_plain == only(), f"17b launches {n_kernel} / {n_plain}")
    zero = [i for i, g in enumerate(grads)
            if not (torch.isfinite(g).all() and torch.count_nonzero(g))]
    require(not zero, f"17b: leaves {zero} got a zero or non-finite "
            f"gradient on B5")
    old = tree_leaves(params)
    upd = [a - o for a, o in zip(new_p, old)]
    p_upd = [a - o for a, o in zip(p_new, old)]
    return {"loss": loss.item(), "plain_loss": p_loss.item(),
            "loss_rel": abs(loss.item() - p_loss.item()) / abs(p_loss.item()),
            "grad_norm": om["grad_norm"].item(),
            "grad_norm_rel": abs(om["grad_norm"].item()
                                 - p_om["grad_norm"].item())
            / p_om["grad_norm"].item(),
            "grad_worst": tree_close(
                grads, p_grads, TRAIN_B5_TOL["grad"],
                TRAIN_B5_TOL["grad_abs"] * p_om["grad_norm"].item()),
            "update_worst": tree_close(upd, p_upd, TRAIN_B5_TOL["update"]),
            "per_leaf": {key: {"grad_norm": b.norm().item(),
                               "grad_rel_err": (a - b).norm().item()
                               / b.norm().item(),
                               "update_rel_err": (u - pu).norm().item()
                               / pu.norm().item()}
                         for (key, _), a, b, u, pu in zip(
                             _leaves(params), grads, p_grads, upd, p_upd)}}


def train_b5_vs_plain(tr: dict) -> dict:
    """17b: B5 against its plain version in one step from 17a's state,
    held to TRAIN_B5_TOL on 17a's weights rescaled to their width
    (``fan_in_scaled``); the reading on 17a's own weights is printed
    beside it.  ``materialize`` draws the stacked matrices with std
    1/sqrt(30), the layers axis, not 1/sqrt(their width): the 30-layer
    stack then magnifies any last-bit difference in its activations
    (B5's included) in every gradient element, as whisper's decoder does
    in 16c."""
    from repro_torch.models.common import fan_in_scaled

    out = {"scaled": b5_vs_plain_step(tr, fan_in_scaled(tr["cfg"],
                                                        tr["params"])),
           "served": b5_vs_plain_step(tr, tr["params"]),
           "limits": TRAIN_B5_TOL}
    held = out["scaled"]
    require(held["loss_rel"] <= TRAIN_B5_TOL["loss"]
            and held["grad_norm_rel"] <= TRAIN_B5_TOL["grad_norm"]
            and held["grad_worst"] <= 1 and held["update_worst"] <= 1,
            f"17b: the step on B5 and on its plain version differ: {out}")
    return out


def smoke_batch(cfg, seed: int) -> dict:
    """numpy inputs as tests/test_models_smoke.py:_batch builds them."""
    rng = np.random.default_rng(seed)
    b, s = 2, 16
    batch = {}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    elif cfg.embeds_input:
        batch["embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
        if cfg.rope_mode == "mrope":
            pos = np.tile(np.arange(s), (b, 1))
            batch["rope_positions"] = np.stack([pos, pos * 0, pos * 0]) \
                .astype(np.int32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return batch


def train_smoke_card_vs_cpu(dev) -> dict:
    """17c: one train step of each of the ten smoke configs on the card
    against the CPU, from the same params and a reached optimizer state
    (step 3, m ~ 1e-3, v = m^2 + 1e-6); the params moved.  mamba2-130m's
    gradient is NaN on both (the reference's SSD backward, ROADMAP
    Caveats): held to the same NaN elements."""
    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.device import no_tf32
    from repro_torch.models.common import (materialize, tree_leaves, tree_map,
                                           tree_unflatten)
    from repro_torch.models.encdec import encdec_build
    from repro_torch.models.transformer import lm_build
    from repro_torch.optim.adamw import AdamWConfig, OptState
    from repro_torch.train.step import (TrainConfig, make_loss_fn,
                                        make_train_step, value_and_grad)

    tcfg = TrainConfig(remat=True, seq_shard=False, xent_chunk=8)
    rows = {}
    for arch in ARCHS:
        cfg = get_smoke(arch)
        build = encdec_build if cfg.family == "encdec" else lm_build
        params = materialize(build(cfg), torch.Generator().manual_seed(171),
                             device="cpu")
        g = torch.Generator().manual_seed(172)
        ms = [torch.randn(p.shape, generator=g) * 1e-3
              for p in tree_leaves(params)]
        batch = smoke_batch(cfg, 173)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2),
                               tcfg)
        res = {}
        for d in ("cpu", dev):
            p = tree_map(lambda x: x.to(d), params)
            m = [x.to(d) for x in ms]
            opt = OptState(torch.tensor(3, dtype=torch.int32, device=d),
                           tree_unflatten(params, m),
                           tree_unflatten(params, [x * x + 1e-6 for x in m]))
            b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            with no_tf32():
                _, _, grads = value_and_grad(make_loss_fn(cfg, tcfg), p, b)
            reset_counts()
            p2, _, met = step(p, opt, b)
            res[str(d)] = (tree_leaves(grads), tree_leaves(p2),
                           {k: v.item() for k, v in met.items()}, counts(),
                           tree_leaves(p))
        g_c, p_c, m_c, _, _ = res["cpu"]
        g_d, p_d, m_d, n_d, p_in = res[str(dev)]
        nan = arch == "mamba2-130m"
        gn = 0.0 if nan else m_c["grad_norm"]
        rtol = SMOKE_GRAD_RTOL.get(arch, SMOKE_GRAD_RTOL_DEFAULT)
        row = {"loss": m_d["loss"], "cpu_loss": m_c["loss"],
               "loss_rel": abs(m_d["loss"] - m_c["loss"]) / abs(m_c["loss"]),
               "grad_worst": tree_close(g_d, g_c, rtol, 1e-6 * gn),
               "param_max_abs": max(
                   float(np.nan_to_num((a.cpu() - b).abs().max().item()))
                   for a, b in zip(p_d, p_c)),
               "moved": all(not torch.equal(a, b) for a, b in zip(p_d, p_in)),
               "B5_launches": n_d["flash_attention"], "grad_rtol": rtol,
               "nan_gradient": nan}
        require(np.isfinite(row["loss"]) and row["loss_rel"] <= 1e-5
                and row["grad_worst"] <= 1 and row["param_max_abs"] <= 1e-5
                and row["moved"],
                f"17c: {arch} on the card against the CPU: {row}")
        print(f"phase 17c: {arch}: " + json.dumps(row), flush=True)
        rows[arch] = row
    return rows


def sdpa_fwd_bwd(q, k, v, w):
    """The yardstick: scaled_dot_product_attention forward and backward
    (causal) on (B, H, S, dh) copies, kv heads repeated beforehand."""
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.detach().repeat_interleave(r, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True)
                  for x, r in ((q, 1), (k, g), (v, g)))
    wt = w.transpose(1, 2).contiguous()

    def fn():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return torch.autograd.grad((out.float() * wt).sum(), (qt, kt, vt))
    return fn


def backward_rows(dev) -> list[dict]:
    """17d: kernels B5 and B4 forward with the plain loop's gradient at
    fault C2's input and at SmolLM-135M's training shape, f32 and bf16:
    the gradient against the plain route's on the card (C2's input also
    against the CPU's), the forward + backward timed beside the plain
    route's, the backward alone (device time) and SDPA's forward +
    backward (printed, not held)."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.device import no_tf32
    from repro_torch.models import attention as ta

    rows = []
    for name, b, s, h, kvh, dh in BWD_SHAPES:
        for l2r in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.Generator(device=dev).manual_seed(174)
                q, k, v = (x.requires_grad_(True) for x in attn_qkv(
                    g, dev, b, s, s, h, kvh, dh, dtype))
                w = torch.randn((b, s, h, dh), generator=g, device=dev)
                quant = QuantConfig() if l2r else None
                lib = "flash_attention_l2r" if l2r else "flash_attention"

                def kernel_route():
                    out = ta.chunked_attention(q, k, v, l2r=quant)
                    return out, torch.autograd.grad(
                        (out.float() * w).sum(), (q, k, v))

                def plain_route(q=q, k=k, v=v):
                    with no_tf32():
                        out = ta._chunked_plain(q, k, v, True, None, None,
                                                None, None, None, 0,
                                                torch.float32, quant, None)
                        return out, torch.autograd.grad(
                            (out.float() * w).sum(), (q, k, v))

                reset_counts()
                out, grads = kernel_route()
                n = counts()
                require(n == only(**{lib: 1}), f"17d {name}: launches {n}")
                p_out, p_grads = plain_route()
                err = max(((a.float() - r.float()).abs().max()
                           / r.float().abs().max().clamp_min(1e-30)).item()
                          for a, r in zip(grads, p_grads))
                fwd_err, _ = attn_err(out, p_out)
                row = {"name": f"{name} {'B4' if l2r else 'B5'}",
                       "B": b, "S": s, "H": h, "Kv": kvh, "dh": dh,
                       "dtype": str(dtype).split(".")[-1],
                       "grad_max_rel_err": err, "fwd_max_abs_err": fwd_err}
                if name == "c2":  # the pin: against the CPU's plain route
                    cq, ck, cv = (x.detach().cpu().requires_grad_(True)
                                  for x in (q, k, v))
                    c_out = ta.chunked_attention(cq, ck, cv, l2r=quant)
                    c_grads = torch.autograd.grad(
                        (c_out.float() * w.cpu()).sum(), (cq, ck, cv))
                    row["cpu_grad_max_rel_err"] = max(
                        ((a.cpu().float() - r.float()).abs().max()
                         / r.float().abs().max()).item()
                        for a, r in zip(grads, c_grads))
                    require(row["cpu_grad_max_rel_err"] <=
                            (1e-5 if dtype == torch.float32 else 2.0 ** -6),
                            f"17d: C2's input on the card: {row}")
                require(err <= 1e-6, f"17d: the kernel route's gradient is "
                        f"not the plain route's: {row}")
                if name == "smollm":
                    row["fwd_bwd_ms"] = time_ms(kernel_route, iters=3,
                                                warmup=1)
                    row["plain_fwd_bwd_ms"] = time_ms(plain_route, iters=3,
                                                      warmup=1)
                    out = ta.chunked_attention(q, k, v, l2r=quant)
                    bwd = lambda: torch.autograd.grad(  # noqa: E731
                        out, (q, k, v), w.to(out.dtype), retain_graph=True)
                    row["bwd_ms"] = time_ms(bwd, iters=3, warmup=1)
                    row["bwd_device_ms"] = profile_forward(bwd)["device_ms"]
                    with no_tf32():  # B4's: on the float q, k, v
                        row["sdpa_fwd_bwd_ms"] = time_ms(
                            sdpa_fwd_bwd(q, k, v, w), iters=5, warmup=1)
                    pairs = visible_pairs(s, s, True, None)
                    nbytes = (2 * q.numel() + 2 * k.numel()) \
                        * q.element_size() * 2  # fwd + bwd, read + written
                    row["fwd_bound_ms"], row["fwd_bound_by"] = attn_bound(
                        b, h, dh, pairs, dtype,
                        (2 * q.numel() + 2 * k.numel()) * q.element_size())
                    fwd_ops, _ = attn_bound(b, h, dh, pairs, dtype, 0)
                    row["fwd_bwd_bound_ms"] = max(  # 7 products: 2 + 5
                        fwd_ops * 3.5, nbytes / PEAK_BYTES * 1e3)
                    row["bwd_bound_ms"] = max(  # the backward's 5 products
                        fwd_ops * 2.5, nbytes / 2 / PEAK_BYTES * 1e3)
                    del out
                rows.append(row)
                print("phase 17d: " + json.dumps(row), flush=True)
                del q, k, v, grads, p_grads
    torch.cuda.empty_cache()
    return rows


def phase_train(dev) -> dict:
    """Training (phase 17): SmolLM-135M at full width (17a), the step on
    B5 against its plain version (17b), the ten smoke configs on the
    card against the CPU (17c), the kernels' backward (17d)."""
    t_phase = time.perf_counter()
    smi = card()
    tr = train_smollm(dev)
    run = tr["run"]
    prof = run["profile"]
    print(f"phase 17a: SmolLM-135M trained {TRAIN_STEPS} steps at batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} (f32, remat) on {smi}: warm step "
          f"{run['warm_step_ms']} ms, {run['tokens_per_s']} tokens/s, peak "
          f"{run['peak_memory_gb']} GB; step device {prof.get('device_ms')} "
          f"ms (B5 {prof.get('B5_ms')}, other {prof.get('other_ms')}), idle "
          f"{prof.get('idle_share')}; {B5_PER_TRAIN_STEP} B5 launches a "
          f"step; losses {run['losses']}", flush=True)
    print("phase 17a: " + json.dumps(run), flush=True)
    b5 = train_b5_vs_plain(tr)
    print("phase 17b: the step on B5 == the step on its plain version "
          "within limits (rescaled weights; 17a's own printed): "
          + json.dumps(b5), flush=True)
    del tr
    torch.cuda.empty_cache()
    smoke = train_smoke_card_vs_cpu(dev)
    rows = backward_rows(dev)
    f32 = next(r for r in rows if r["name"] == "smollm B5"
               and r["dtype"] == "float32")
    layers = B5_PER_TRAIN_STEP // 2
    train = {"per": f"phase 17a: SmolLM-135M, batch {TRAIN_BATCH} x "
                    f"{TRAIN_SEQ}, f32, remat: {layers} attention layers, "
                    f"B5 launched in the forward and again in the "
                    f"recompute; the backward is the plain loop's "
                    f"gradient (17d's f32 row x {layers})",
             "launches": run["launches"],
             "launches_per_step": B5_PER_TRAIN_STEP,
             "device_ms_per_step": prof.get("B5_ms"),
             "bound_ms_per_step": f32["fwd_bound_ms"] * B5_PER_TRAIN_STEP,
             "bound_by": f32["fwd_bound_by"],
             "plain_backward_device_ms_per_step":
             f32["bwd_device_ms"] * layers
             if isinstance(f32["bwd_device_ms"], float) else "not measured",
             "sdpa_fwd_bwd_ms_per_step": f32["sdpa_fwd_bwd_ms"] * layers,
             "step_ms": run["warm_step_ms"],
             "tokens_per_s": run["tokens_per_s"],
             "step_device_ms": prof.get("device_ms"),
             "idle_share": prof.get("idle_share")}
    print(f"phase 17a: B5 {train['device_ms_per_step']} ms of device time "
          f"a step beside the plain backward's "
          f"{train['plain_backward_device_ms_per_step']} ms (17d) and "
          f"SDPA's forward + backward {train['sdpa_fwd_bwd_ms_per_step']} "
          f"ms, on {smi}", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 17: {seconds:.1f} s", flush=True)
    return {"run": run, "b5_vs_plain": b5, "smoke": smoke, "rows": rows,
            "train": train, "seconds": seconds}


def lm_totals(rows: list[dict], where: tuple[str, ...]) -> dict:
    """Σ count × per-shape median over the rows of one LM step."""
    pick = [r for r in rows if r["where"] in where]
    return {key: sum(r[key] * r["count"] for r in pick)
            for key in ("ms", "kernel_ms", "plain_ms", "library_ms",
                        "bound_ms")}


# ------------------------------------------------------------------ slice 12
# the consensus level walk on a 2x2 mesh: four ranks of one process group
# over gloo, every rank on the machine's one card (NCCL refuses two ranks
# on one device), the backbone replicated and the head split by class
MESH_SHAPE = (2, 2)  # (data, model)
MESH_WORLD = MESH_SHAPE[0] * MESH_SHAPE[1]
MESH_STEPS = 8  # decode steps after the 8 x 2048 prefill (18b)
MESH_DEADLINE_S = 900


class CollectiveClock:
    """While active, the collectives of ``sharding/collectives.py`` (and
    the names modules bound from it) are timed on the host clock between
    synchronizes, host staging included; ``seconds`` accumulates."""

    NAMES = ("all_reduce", "all_gather", "_all_to_all")

    def __init__(self, *modules):
        from repro_torch.sharding import collectives

        self.modules = (collectives, *modules)
        self.seconds = 0.0

    def _timed(self, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        return call

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m in self.modules
                      for n in self.NAMES if hasattr(m, n)]
        for m, n, f in self.saved:
            setattr(m, n, self._timed(f))
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def audit_run(records: list, want: dict, mesh, what: str,
              allow_float_psum: bool) -> dict:
    """22d: the collectives one split run recorded
    (sharding/collectives.py:recording), audited against its contract
    (analysis/sharding.py:audit_records): each kind as many times as the
    code derives (``want``), no data mover beyond those, no float SUM
    unless ``allow_float_psum`` (a float model or float router sums; the
    L2R serving runs sum only integers), within the budget.  Raises on a
    violation."""
    from repro_torch.analysis.sharding import ShardingContract, audit_records

    contract = ShardingContract(mesh_axes=tuple(mesh.shape.items()),
                                kinds=tuple(sorted(want.items())),
                                allow_float_psum=allow_float_psum)
    rep = audit_records(records, contract, what, with_cost=False)
    require(rep.ok, f"22d {what}: " + "; ".join(
        f"{v.primitive}: {v.reason}" for v in rep.violations))
    return {"entry": what, "records": len(records),
            "census": rep.collectives["census"],
            "float_sums": sum(r.op == "all_reduce" and r.reduce_op == "sum"
                              and "float" in r.dtype for r in records),
            "allow_float_psum": allow_float_psum}


def run_audited(eng, what: str) -> dict:
    """``eng.run()`` of a ContinuousBatcher, its second step taken by the
    22c audit (analysis/compiled.py:audit_batcher runs exactly that one
    step and checks that the slot state kept its storage; then the
    prefill shapes against the buckets).  Raises on a violation."""
    from repro_torch.analysis.compiled import audit_batcher

    rep = None
    while eng.queue or any(r is not None for r in eng.slot_req):
        if rep is None and eng.steps == 1 \
                and any(r is not None for r in eng.slot_req):
            rep = audit_batcher(eng, entry=what)
        else:
            eng.step()
    require(rep is not None, f"22c {what}: the run ended before its second "
                             f"step")
    require(rep["ok"], f"22c {what}: {rep['violations']}")
    return rep


class WalkProbe:
    """While active, ``module.streaming_argmax`` is wrapped: each walk of
    this rank (its caller passes the mesh) is timed (host clock between
    synchronizes), its collectives are counted and required equal to
    ``sharded_walk_collectives`` for the levels it ran, and its head
    input (int8 codes and scales) is required identical on every rank (a
    MAX and a MIN all-reduce of a checksum, outside the walk's count).
    The walk's collectives (policy.all_reduce, progressive.all_gather)
    are timed by a :class:`CollectiveClock`.  22d: the walk's recorded
    collectives (sharding/collectives.py's recorder, the probe's own
    unless a run's is active) are audited against the port's consensus
    contract (analysis/registry.py:consensus_contract): per level two MAX
    and one MIN tagged, the consensus SUM with early exit on split rows,
    the finalize and the tagged gathers."""

    def __init__(self, module, mesh, rows_sharded: bool | None = True,
                 same_inputs: bool = True):
        self.module, self.mesh = module, mesh
        self.rows_sharded = rows_sharded
        self.same_inputs = same_inputs  # every rank walks the same rows
        self.walks: list[dict] = []
        self.inputs: list = []
        self.audited = {"walks": 0, "records": 0, "levels": []}

    def __enter__(self):
        from repro_torch.core import policy, progressive
        from repro_torch.sharding import collectives

        self.clock = CollectiveClock(policy, progressive).__enter__()
        self.rec = None
        if collectives.active_records() is None:
            self.rec = collectives.recording()
            self.rec.__enter__()
        self.real = self.module.streaming_argmax
        self.module.streaming_argmax = self._walk
        return self

    def __exit__(self, *exc):
        self.module.streaming_argmax = self.real
        if self.rec is not None:
            self.rec.__exit__(*exc)
        self.clock.__exit__(*exc)

    def _audit(self, records: list, run: int, rows: bool, early: bool):
        from repro_torch.analysis.registry import consensus_contract
        from repro_torch.analysis.sharding import audit_records

        contract = consensus_contract(self.mesh.shape.get("data", 1),
                                      self.mesh.shape["model"], early,
                                      rows_sharded=rows)
        rep = audit_records(records, contract, f"walk {len(self.walks)}",
                            with_cost=False)
        require(rep.ok and rep.schedule["levels_run"] == run,
                f"22d: a walk of {run} levels: " + "; ".join(
                    v.reason for v in rep.violations))
        self.audited["walks"] += 1
        self.audited["records"] += len(records)
        self.audited["levels"].append(run)

    def _walk(self, xq, wq, xs, ws, *args, **kw):
        from repro_torch.core.progressive import sharded_walk_collectives
        from repro_torch.sharding import collectives, ctx

        torch.cuda.synchronize()
        before = dict(collectives.COUNTS)
        records = collectives.active_records()
        i0 = len(records)
        coll_s = self.clock.seconds
        t0 = time.perf_counter()
        out = self.real(xq, wq, xs, ws, *args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        made = {k: collectives.COUNTS[k] - before[k] for k in before}
        early = kw.get("early_exit", False)
        run = int(out[2].max()) + 1 if early else N_LEVELS
        rows = bool(ctx.row_axes()) if self.rows_sharded is None \
            else self.rows_sharded  # None: as the walk's caller split them
        want = sharded_walk_collectives(run, True, rows, early)
        require(made == want, f"a walk of {run} levels made collectives "
                              f"{made}, the code derives {want}")
        self._audit(records[i0:], run, rows, early)
        self.walks.append({"ms": ms, "levels": run, "collectives": made,
                           "collective_ms":
                           (self.clock.seconds - coll_s) * 1e3})
        self.inputs.append((xq, xs))
        if self.same_inputs:
            same_on_every_rank(self.mesh, xq, xs)
        return out


def same_on_every_rank(mesh, xq, xs) -> None:
    """Require this rank's head input equal to every other rank's: a
    position-weighted checksum of the int8 codes and of the scales' bits,
    MAX- and MIN-reduced over the whole mesh."""
    from repro_torch.sharding.collectives import all_reduce

    q = xq.reshape(-1).to(torch.int64)
    w = torch.arange(q.numel(), device=q.device) % 65521 + 1
    c = torch.stack([(q * w).sum(), xs.to(torch.float32).contiguous()
                     .view(torch.int32).to(torch.int64).sum()])
    group = mesh.group(("data", "model"))
    require(torch.equal(all_reduce(c, "max", group),
                        all_reduce(c, "min", group)),
            "the head input differs between ranks: the replicated backbone "
            "is not replicated")


def slab_bound(m: int, k: int, n: int, t: int, d: int = 4) -> tuple:
    """Level ``t``'s slab of the stacked walk: its plane pairs (i + j = t)
    at 2 m n k operations each, the planes they read and the (M, N) int32
    it writes."""
    from repro_torch.kernels.l2r_gemm import kernel

    return cost_bound(*kernel.slab_cost(m, k, n, t, d))


def shard_shape_check(xq_rows, cache, where: str) -> dict:
    """Kernel B2 and B1's level slabs at this rank's shard shape (its rows
    of the head input against its slice of the head cache, the cache's
    K-major D-plane view read in place), bit for bit against their plain
    versions; B2 and each slab timed beside its plain version, its bound
    and torch._int_mm on the unstacked slice (checked against the final
    plane)."""
    from repro_torch.core.quant import stack_planes_lhs
    from repro_torch.kernels.l2r_gemm import kernel

    a = stack_planes_lhs(xq_rows)
    b = cache.planes.core_stack(shifted=True)
    got = kernel.l2r_gemm_streaming_planes(a, b)
    require(torch.equal(got, kernel.l2r_gemm_streaming_planes_plain(a, b)),
            f"B2 != plain at the shard shape of {where}")
    (m, k), n = xq_rows.shape, b.shape[1]
    slabs = []
    for t in range(N_LEVELS):
        slab = lambda: kernel.l2r_gemm_stacked_planes(  # noqa: E731
            a, b, levels=t + 1, first_level=t)
        plain = lambda: kernel.l2r_gemm_stacked_planes_plain(  # noqa: E731
            a, b, levels=t + 1, first_level=t)
        require(torch.equal(slab(), plain()),
                f"B1 level slab {t} != plain at the shard shape of {where}")
        bound_ms, by = slab_bound(m, k, n, t)
        slabs.append({"level": t, "ms": time_ms(slab),
                      "kernel_ms": stream_ms(slab),
                      "plain_ms": time_ms(plain, iters=3, warmup=1),
                      "bound_ms": bound_ms, "bound_by": by})
    lib, lib_fn, padded = int_mm(xq_rows, cache.q)
    require(torch.equal(lib, got[-1]), f"torch._int_mm disagrees with B2's "
                                       f"final plane at {where}")
    d = 4
    bound_ms, by = cost_bound(*kernel.streaming_cost(m, k, n, d,
                                                     N_LEVELS))
    fn = lambda: kernel.l2r_gemm_streaming_planes(a, b)  # noqa: E731
    return {"where": where, "m": m, "k": k, "n": n, "b1_slabs": slabs,
            "ms": time_ms(fn),
            "kernel_ms": stream_ms(fn),
            "plain_ms": time_ms(
                lambda: kernel.l2r_gemm_streaming_planes_plain(a, b),
                iters=3, warmup=1),
            "library_ms": time_ms(lib_fn), "int_mm_padded": padded,
            "bound_ms": bound_ms, "bound_by": by}


def mesh_rows(mesh, xq):
    m_l = xq.shape[0] // MESH_SHAPE[0]
    r0 = mesh.index("data") * m_l
    return xq[r0:r0 + m_l]


def mesh_vgg(dev, mesh) -> dict:
    """18a on this rank: phase 3's weights and batches, fc8's cache split
    over the model axis (500 classes a rank), each batch classified with
    the scan (119 B1 + 1 B2 launches) and with early exit (119 B1 + one
    per level run)."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import cnn

    cfg = QuantConfig()
    params = cnn.vgg16_build(1000, generator=torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
    weights_q = cnn.vgg16_quantize_weights(params, cfg, mesh=mesh)
    require(weights_q["fc8"].q.shape[-1] == 1000 // MESH_SHAPE[1],
            "fc8's cache is not split by class")
    gi = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.randn((BATCH, 224, 224, 3), generator=gi, device=dev)
               for _ in range(3)]
    out = {"results": {}, "launches": {}}
    with WalkProbe(cnn, mesh) as probe:
        for early_exit in (False, True):
            res, launched = [], {k: 0 for k in KERNELS}
            for x in batches:
                reset_counts()
                pred, lv, logits = cnn.vgg16_classify_progressive(
                    params, x, cfg, weights_q, early_exit=early_exit,
                    device=dev, mesh=mesh)
                torch.cuda.synchronize()
                n = counts()
                want = only(l2r_stacked_gemm=119 + int(lv.max()) + 1) \
                    if early_exit else only(l2r_stacked_gemm=119,
                                            l2r_streaming_gemm=1)
                require(n == want, f"18a launches {n} (early_exit="
                                   f"{early_exit}), expected {want}")
                launched = {k: launched[k] + n[k] for k in n}
                res.append((pred.cpu(), lv.cpu(), logits.cpu()))
            out["results"][early_exit] = res
            out["launches"][early_exit] = launched
    out["walks"] = probe.walks
    out["audit22"] = probe.audited
    out["shard_shape"] = shard_shape_check(
        mesh_rows(mesh, probe.inputs[0][0]), weights_q["fc8"], "fc8")
    return out


def mesh_lm(dev, mesh, head_bytes_whole: int) -> dict:
    """18b on this rank: phase 13's model with the head cache split by
    vocabulary (24,576 columns a rank), a progressive prefill of 8 x 2048
    tokens and MESH_STEPS decode steps with the scan and with early exit
    (launches per call as phase 15's), then the gateway over phase 15e's
    requests."""
    import hashlib

    from repro_torch.serve import ServingGateway, engine

    cfg, params, prep_s = lm_model(dev, mesh=mesh)
    hq = params["head_q"]
    head_bytes = hq.q.numel() + hq.planes.stack.numel() + \
        hq.scale.numel() * hq.scale.element_size()
    require(2 * head_bytes == head_bytes_whole,
            f"this rank's head cache is {head_bytes} bytes; phase 15's "
            f"whole cache {head_bytes_whole}")
    prompt = lm_prompt(dev, LM_BATCH, LM_PROMPT, cfg.vocab, 130)
    out = {"head_cache_bytes": head_bytes, "prepare_params_s": prep_s}
    with WalkProbe(engine, mesh) as probe:
        for early_exit in (False, True):
            r = progressive_run(cfg, params, prompt, early_exit,
                                steps=MESH_STEPS, mesh=mesh)
            logits = torch.stack(r["logits"]).cpu()
            out[early_exit] = {
                "tokens": r["tokens"].cpu(), "levels": r["levels"].cpu(),
                "logits": logits,
                "logits_sha256": hashlib.sha256(
                    logits.view(torch.int16).numpy().tobytes()).hexdigest(),
                "prefill_ms": r["prefill_ms"], "step_ms": r["step_ms"],
                "launches": r["launches"]}
        walks = probe.walks
        out["shard_shape"] = shard_shape_check(
            mesh_rows(mesh, probe.inputs[-1][0]), hq, "the LM head")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gw = ServingGateway(cfg, params, n_slots=SERVE_SLOTS,
                            max_len=SERVE_MAX_LEN, progressive=True,
                            early_exit=True, prefill_group=SERVE_GROUP,
                            device=dev, mesh=mesh)
        warm_s = time.perf_counter() - t0
        reqs = serve_requests(cfg)
        reset_counts()
        t0 = time.perf_counter()
        gw.run(reqs)
        torch.cuda.synchronize()
        out["gateway"] = {"reqs": served(reqs), "stats": served_stats(gw),
                          "seconds": time.perf_counter() - t0,
                          "warmup_s": warm_s, "launches": counts()}
        gw.close()
    out["audit22"] = probe.audited
    # walks: the scan's prefill and steps, early exit's, the gateway's
    out["walk_ms_per_step"] = {
        ee: statistics.median(w["ms"] for w in walks[i + 1:i + 1 + MESH_STEPS])
        for ee, i in ((False, 0), (True, MESH_STEPS + 1))}
    out["collective_share_of_walk"] = sum(
        w["collective_ms"] for w in walks) / sum(w["ms"] for w in walks)
    out["walks"] = len(walks)
    return out


def mesh_rank(head_bytes_whole: int) -> dict:
    """One rank of phase 18 (run by spawn_local): the card, the mesh, 18a
    and 18b.  The kernels were built in phase 1: a rank only loads them."""
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for name, src in _build.sources().items():
        require(_build._target(src).exists(),
                f"{name} is not built: phase 18's ranks only load kernels")
    mesh = make_local_mesh(*MESH_SHAPE)
    t0 = time.perf_counter()
    out = {"rank": dist.get_rank(), "coords": mesh.coords(),
           "backend": dist.get_backend()}
    out["vgg"] = mesh_vgg(dev, mesh)
    out["vgg_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out["lm"] = mesh_lm(dev, mesh, head_bytes_whole)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["seconds"] = time.perf_counter() - t0
    # 22d: the registered split entries at the registry's shapes, on this
    # 2 x 2 mesh (analysis/lint.py:rank_pass): exactness and schedule
    from repro_torch.analysis import lint

    t1 = time.perf_counter()
    entries = lint.rank_pass("cuda", False, mesh)
    bad = [r["entry"] for rows in entries.values() for r in rows
           if r["status"] != "ok"]
    require(not bad, f"22d rank {out['rank']}: split entries {bad} fail "
                     f"their audit: {entries}")
    out["audit22"] = {"walks_18a": out["vgg"]["audit22"],
                      "walks_18b": out["lm"]["audit22"],
                      "split_entries": {k: [{f: r.get(f) for f in (
                          "entry", "status", "kernel_nodes", "schedule",
                          "collectives")} for r in rows]
                          for k, rows in entries.items()},
                      "split_entries_s": time.perf_counter() - t1}
    if out["rank"]:  # the logits travel once, from rank 0
        for ee in (False, True):
            del out["lm"][ee]["logits"]
    return out


def phase_mesh(dev, prog: dict, serve: dict) -> dict:
    """Phase 18: four ranks (2 x 2 mesh) on the one card over gloo, each
    holding the backbone whole and its slice of the head; their results
    against phases 4, 15a/15b and 15e bit for bit."""
    import gc

    from repro_torch.launch.mesh import spawn_local

    gc.collect()
    torch.cuda.empty_cache()
    smi = card()
    print(f"phase 18: {MESH_WORLD} ranks on a {MESH_SHAPE[0]} x "
          f"{MESH_SHAPE[1]} (data x model) mesh over gloo, all on the one "
          f"card ({smi}): four processes sharing one card, not a multi-GPU "
          f"figure", flush=True)
    t0 = time.perf_counter()
    ranks = spawn_local(MESH_WORLD, mesh_rank, serve["head_bytes"],
                        deadline_s=MESH_DEADLINE_S)
    seconds = time.perf_counter() - t0
    for r in ranks:
        rk = r["rank"]
        require(r["backend"] == "gloo", f"rank {rk}: backend {r['backend']}")
        for ee in (False, True):
            for got, ref in zip(r["vgg"]["results"][ee],
                                prog["results"][ee]):
                require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                        f"rank {rk}: 18a classes, levels or logits "
                        f"(early_exit={ee}) differ from phase 4's")
            tok, lv, lgs = serve["mesh_ref"][ee]
            lm = r["lm"][ee]
            require(torch.equal(lm["tokens"], tok)
                    and torch.equal(lm["levels"], lv),
                    f"rank {rk}: 18b tokens or exit levels (early_exit="
                    f"{ee}) differ from phase 15's")
            require(lm["logits_sha256"] == ranks[0]["lm"][ee]
                    ["logits_sha256"], f"rank {rk}: 18b logits differ from "
                                       f"rank 0's")
        require(r["lm"]["gateway"]["reqs"] == serve["engines"]["gateway_reqs"],
                f"rank {rk}: the gateway's tokens or exit levels differ from "
                f"phase 15e's")
        require(r["lm"]["gateway"]["stats"]
                == serve["engines"]["gateway_stats"],
                f"rank {rk}: the gateway's stats differ from phase 15e's")
    for ee in (False, True):
        require(torch.equal(ranks[0]["lm"][ee]["logits"],
                            torch.stack(serve["mesh_ref"][ee][2])),
                f"18b logits (early_exit={ee}) differ from phase 15's")
    lm0, vgg0 = ranks[0]["lm"], ranks[0]["vgg"]
    out = {
        "card": smi, "backend": "gloo", "ranks": MESH_WORLD,
        "mesh": {"data": MESH_SHAPE[0], "model": MESH_SHAPE[1]},
        "seconds": seconds,
        "per_rank": [{
            "rank": r["rank"], "coords": r["coords"], "peak_gb": r["peak_gb"],
            "seconds": r["seconds"], "vgg_s": r["vgg_s"],
            "vgg_launches": r["vgg"]["launches"],
            "vgg_walk_ms": [w["ms"] for w in r["vgg"]["walks"]],
            "lm_prefill_ms": {ee: r["lm"][ee]["prefill_ms"]
                              for ee in (False, True)},
            "lm_decode_ms_per_token": {ee: r["lm"][ee]["step_ms"]
                                       for ee in (False, True)},
            "lm_launches": {ee: r["lm"][ee]["launches"]
                            for ee in (False, True)},
            "walk_ms_per_decode_step": r["lm"]["walk_ms_per_step"],
            "collective_share_of_walk": r["lm"]["collective_share_of_walk"],
            "head_cache_bytes": r["lm"]["head_cache_bytes"],
            "gateway_s": r["lm"]["gateway"]["seconds"],
            "gateway_launches": r["lm"]["gateway"]["launches"],
            "shard_shapes": [r["vgg"]["shard_shape"],
                             r["lm"]["shard_shape"]]}
            for r in ranks],
        "collectives_per_walk": {
            "vgg_scan": vgg0["walks"][0]["collectives"],
            "vgg_early_exit": vgg0["walks"][3]["collectives"],
            "vgg_early_exit_levels": vgg0["walks"][3]["levels"]},
        "head_cache_bytes_whole": serve["head_bytes"],
        "lm_walks_per_rank": lm0["walks"]}
    print("phase 18: " + json.dumps(out, default=str), flush=True)
    out["audit22"] = [r["audit22"] for r in ranks]
    print(f"phase 18: 18a VGG-16 (224x224, batch 8, 1000 classes; fc8 500 "
          f"a rank, 4 rows a rank in the walk) == phase 4 and 18b "
          f"SmolLM-135M (8 x 2048 prefill + {MESH_STEPS} steps, scan and "
          f"early exit; the gateway over 15e's {SERVE_REQUESTS} requests) "
          f"== phases 15a/15b/15e, bit for bit on every rank; launches and "
          f"collectives exact; head cache half of phase 15's on each rank; "
          f"{seconds:.1f} s", flush=True)
    return out


def mesh_summary(mesh: dict, lib: str) -> dict:
    """Kernel ``lib``'s launches on each rank of phase 18 (18a's three
    batches, 18b's prefill and steps, the gateway run), by control flow,
    and B2's times at each rank's shard shapes."""
    out = {"per": f"phase 18: {MESH_WORLD} ranks on a {MESH_SHAPE[0]} x "
                  f"{MESH_SHAPE[1]} mesh over gloo on one card; launches "
                  f"per rank: 18a over 3 VGG-16 forwards, 18b over the "
                  f"prefill and {MESH_STEPS} steps, and the gateway run",
           "card": mesh["card"], "per_rank": []}
    for r in mesh["per_rank"]:
        row = {"rank": r["rank"], "gateway": r["gateway_launches"][lib]}
        for ee, key in ((False, "scan"), (True, "early_exit")):
            row[f"vgg_{key}"] = r["vgg_launches"][ee][lib]
            row[f"lm_{key}"] = r["lm_launches"][ee][lib]
        if lib == "l2r_streaming_gemm":
            row["shard_shapes"] = r["shard_shapes"]
        out["per_rank"].append(row)
    return out


# ------------------------------------------------------------------ slice 13
# the data-parallel half of the mesh on phase 18's 2 x 2 mesh (four gloo
# ranks sharing the one card): ZeRO-1 training, the "batch" slot-state
# layout, dp-local MoE dispatch
DP_STEPS = 3  # 19a's steps of the global batch 8 x 2048
DP_DEEPSEEK_LAYERS = 4  # phase 16's cut: the dense layer and 3 MoE layers
DP_DECODE_STEPS = 2
DP_DEADLINE_S = 900
DP_B1 = [  # (M, K, N, launches per rank per call, where): decode rows a
    # rank (19b SmolLM-135M, 19c deepseek-moe-16b) and 19c's dp-local
    # expert buffers (64 experts, top-6, capacity of 4096 group tokens)
    (4, 576, 576, 60, "19b q o decode"), (4, 576, 192, 60, "19b k v decode"),
    (4, 576, 3072, 30, "19b wi decode"), (4, 1536, 576, 30, "19b wo decode"),
    (4, 2048, 2048, 16, "19c q k v o decode"),
    (4, 2048, 2 * 10944, 1, "19c layer-0 wi decode"),
    (4, 10944, 2048, 1, "19c layer-0 wo decode"),
    (4, 2048, 2 * 2816, 3, "19c shared wi decode"),
    (4, 2816, 2048, 3, "19c shared wo decode"),
    (4, 2048, 64, 3, "19c router decode"),
    (4, 2048, 51200, 1, "19c head decode"),
    (480, 2048, 2 * 1408, 3 * 64, "19c expert wi prefill"),
    (480, 1408, 2048, 3 * 64, "19c expert wo prefill"),
]
DP_B5 = [  # (where, B, S, H, Kv, dh, dtype, launches per rank per call)
    ("19a train forward", 4, 2048, 9, 3, 64, torch.float32, 60),
    ("19c prefill", 4, 2048, 16, 16, 128, torch.bfloat16, 4),
]


def dp_kernel_rows(dev) -> dict:
    """Kernels B1, B2 and B5 at the shapes phase 19 gives them on a rank,
    on the card before the ranks start: bit for bit (B1, B2) or within
    ATTN_TOL (B5) against their plain versions, timed beside their bounds
    and torch._int_mm / scaled_dot_product_attention."""
    from repro_torch.core.quant import PlaneOperands, stack_planes_lhs
    from repro_torch.device import no_tf32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.l2r_gemm import kernel

    g = torch.Generator(device=dev).manual_seed(190)
    b1 = [b1_shape_row(g, dev, m, k, n, c, where, "19d")
          for m, k, n, c, where in DP_B1]
    # B2: the head walk at a rank's rows (4 of 8) and vocab slice
    m, (k, n) = 4, (LM_HEAD[0], LM_HEAD[1] // MESH_SHAPE[1])
    a, bw = operands(g, dev, m, k, n, 8)
    sa = stack_planes_lhs(a)
    sb = PlaneOperands.prepare_rhs(bw, shifted=True, window_pad=True,
                                   k_major=True).core_stack(True)
    got = kernel.l2r_gemm_streaming_planes(sa, sb)
    ref = kernel.l2r_gemm_streaming_planes_plain(sa, sb)
    require(torch.equal(got, ref), "B2 != plain at 19b's rank shape")
    lib, lib_fn, padded = int_mm(a, bw)
    require(torch.equal(lib, got[-1]), "torch._int_mm disagrees with B2's "
                                       "final plane at 19b's rank shape")
    d = 4
    bound_ms, by = cost_bound(*kernel.streaming_cost(m, k, n, d,
                                                     N_LEVELS))
    fn = lambda: kernel.l2r_gemm_streaming_planes(sa, sb)  # noqa: E731
    b2 = {"name": f"19b head walk K={k} N={n}", "m": m, "k": k, "n": n,
          "count": 1, "ms": time_ms(fn), "kernel_ms": stream_ms(fn),
          "plain_ms": time_ms(lambda: kernel.l2r_gemm_streaming_planes_plain(
              sa, sb), iters=3, warmup=1),
          "library_ms": time_ms(lib_fn), "int_mm_padded": padded,
          "bound_ms": bound_ms, "bound_by": by, "max_abs_err": 0}
    print("phase 19d: " + json.dumps(b2), flush=True)
    del a, bw, sa, sb, got, ref, lib
    b5 = []
    for where, b, s, h, kvh, dh, dtype, count in DP_B5:
        q, k_, v = attn_qkv(g, dev, b, s, s, h, kvh, dh, dtype)
        with no_tf32():
            got = fa.flash_attention(q, k_, v, causal=True)
            ref = fa.flash_attention_kernel_plain(q, k_, v, True)
        err, excess = attn_err(got, ref)
        require(excess <= ATTN_TOL[dtype][1], f"B5 at {where}: max |d| "
                f"{err} from plain, {excess} beyond the relative term")
        del got, ref
        with no_tf32():
            call = lambda: fa.flash_attention(  # noqa: E731
                q, k_, v, causal=True)
            _, lib_fn = sdpa(q, k_, v, True, None)
            row = {"name": where, "count": count, "B": b, "S": s, "H": h,
                   "Kv": kvh, "dh": dh, "dtype": str(dtype).split(".")[-1],
                   "ms": time_ms(call, iters=5, warmup=1),
                   "kernel_ms": stream_ms(call),
                   "plain_ms": time_ms(lambda: fa.flash_attention_kernel_plain(
                       q, k_, v, True), iters=3, warmup=1),
                   "library_ms": time_ms(lib_fn, iters=5, warmup=1)}
        pairs = visible_pairs(s, s, True, None)
        row["bound_ms"], row["bound_by"] = attn_bound(
            b, h, dh, pairs, dtype,
            (2 * q.numel() + 2 * k_.numel()) * q.element_size())
        row["max_abs_err"] = err
        b5.append(row)
        print("phase 19d: " + json.dumps(row), flush=True)
        del q, k_, v
    torch.cuda.empty_cache()
    return {"b1": b1, "b2": [b2], "b5": b5}


def same_value_on_every_rank(mesh, values: torch.Tensor, what: str):
    """Require ``values`` (f64 on the card) equal on every rank: a MAX and
    a MIN all-reduce over the whole mesh."""
    from repro_torch.sharding.collectives import all_reduce

    group = mesh.group(("data", "model"))
    require(torch.equal(all_reduce(values, "max", group),
                        all_reduce(values, "min", group)),
            f"{what} differs between ranks")


def tree_checksum(leaves) -> torch.Tensor:
    """A position-weighted f64 checksum of each leaf's bits."""
    out = []
    for x in leaves:
        q = x.detach().contiguous().view(torch.int32).reshape(-1) \
            .to(torch.float64)
        w = torch.arange(q.numel(), device=q.device) % 65521 + 1
        out.append((q * w).sum())
    return torch.stack(out)


def zero1_share_bytes(zero) -> int:
    """m and v bytes a rank holds under ``zero``'s specs (f32)."""
    import math

    from repro_torch.sharding.ctx import mesh_axis_size

    total = 0
    for shape, spec in zip(zero.shapes, zero.specs):
        n = math.prod(shape)
        for ax in spec:
            n //= mesh_axis_size(zero.mesh, ax)
        total += 2 * 4 * n
    return total


def dp_train(dev, mesh, ref17: dict) -> dict:
    """19a on this rank: SmolLM-135M as phase 17 trained DP_STEPS steps of
    the pipeline's global batches 8 x 2048 on the 2 x 2 mesh, 4 x 2048 a
    data rank, the params split per param_specs over "model" (the
    attention gathered: 2 does not divide the 3 kv heads), the sequence
    over "model" between blocks, the optimizer state ZeRO-1
    (:func:`train_split_run`)."""
    return train_split_run(dev, mesh, DP_STEPS, True, ref17, "19a")


def dp_batcher(dev, mesh, ref15: dict) -> dict:
    """19b on this rank: phase 13's model (head 24,576 columns a rank),
    15e's requests through ``ContinuousBatcher(state_sharding="batch")``
    with 8 slots, 4 a data rank."""
    from repro_torch.core import policy, progressive
    from repro_torch.serve import ContinuousBatcher
    from repro_torch.serve.batching import _tensors
    from repro_torch.sharding import collectives

    cfg, params, _ = lm_model(dev, mesh=mesh)
    with torch.no_grad():
        eng = ContinuousBatcher(cfg, params, n_slots=SERVE_SLOTS,
                                max_len=SERVE_MAX_LEN, progressive=True,
                                early_exit=True, device=dev, mesh=mesh,
                                state_sharding="batch")
        state_bytes = sum(t.numel() * t.element_size()
                          for t in _tensors(eng.state))
        reqs = serve_requests(cfg)
        for r in reqs:
            eng.submit(r)
        reset_counts()
        collectives.reset()
        t0 = time.perf_counter()
        with CollectiveClock(policy, progressive) as clock:
            audit = run_audited(eng, "19b batcher")
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    out = {"audit22": audit, "reqs": served(reqs),
           "stats": served_stats(eng),
           "launches": counts(), "seconds": seconds,
           "collective_s": clock.seconds,
           "collectives": dict(collectives.COUNTS),
           "state_bytes": state_bytes, "rows": int(eng.state.pos.shape[0])}
    require(out["rows"] == SERVE_SLOTS // MESH_SHAPE[0],
            f"19b: this rank holds {out['rows']} slot rows")
    require(2 * state_bytes == ref15["batcher_state_bytes"],
            f"19b: this rank's slot state is {state_bytes} bytes; 15e's "
            f"{ref15['batcher_state_bytes']}")
    require(out["reqs"] == ref15["batcher_reqs"],
            "19b: tokens or exit levels differ from 15e's batcher")
    require(out["stats"] == ref15["batcher_stats"],
            "19b: stats differ from 15e's batcher")
    launched = {k: v for k, v in out["launches"].items() if v}
    require(launched == ref15["batcher"]["launches"],
            f"19b: launches {launched}, 15e's batcher "
            f"{ref15['batcher']['launches']}")
    del eng, params
    torch.cuda.empty_cache()
    return out


class MoeProbe:
    """While active, ``moe_apply_dp_local`` records the first call's
    params and input and the group output it gathers (armed per call)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe = moe
        self.armed = False
        self.seen = None

    def __enter__(self):
        self.real = (self.moe.moe_apply_dp_local, self.moe.gather_rows)

        def dp_local(cfg, params, x):
            if self.armed and self.seen is None:
                self.seen = {"params": params, "x": x}
            return self.real[0](cfg, params, x)

        def gather(y, *args, **kw):
            if self.armed and self.seen is not None \
                    and "y" not in self.seen:
                self.seen["y"] = y
                self.armed = False
            return self.real[1](y, *args, **kw)

        self.moe.moe_apply_dp_local, self.moe.gather_rows = dp_local, gather
        return self

    def take(self, fn):
        self.armed, self.seen = True, None
        out = fn()
        return out, self.seen

    def __exit__(self, *exc):
        self.moe.moe_apply_dp_local, self.moe.gather_rows = self.real


def dp_moe(dev, mesh) -> dict:
    """19c on this rank: deepseek-moe-16b at its published widths, cut to
    DP_DEEPSEEK_LAYERS layers as phase 16, ``moe_dp_local`` on, prepared
    with the head split by vocabulary and the routed experts by model
    rank (32 of 64); an 8 x 2048 prefill of this rank's 4 rows and
    DP_DECODE_STEPS greedy steps, each rank's group output of the first
    MoE layer against ``moe_apply`` without a mesh on its group's tokens
    and the whole expert stacks, bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.common import materialize
    from repro_torch.models.moe import moe_apply, shard_experts
    from repro_torch.models.transformer import lm_build
    from repro_torch.serve import engine
    from repro_torch.sharding import collectives, ctx
    from repro_torch.sharding.axes import batch_rows

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              l2r=QuantConfig(), n_layers=DP_DEEPSEEK_LAYERS,
                              moe_dp_local=True)
    params = materialize(lm_build(cfg), torch.Generator(device=dev)
                         .manual_seed(160), device=dev)
    params = engine.prepare_params(cfg, params, mesh=mesh)
    ffn = params["stack"][0]["ffn"]
    whole_bytes = sum(ffn[k].numel() * ffn[k].element_size()
                      for k in ("wi", "wo"))
    oracle_w = {k: ffn[k][0].clone() for k in ("wi", "wo")}
    params = shard_experts(cfg, params, mesh)
    ffn = params["stack"][0]["ffn"]
    expert_bytes = sum(ffn[k].numel() * ffn[k].element_size()
                       for k in ("wi", "wo"))
    require(2 * expert_bytes == whole_bytes,
            f"19c: this rank's expert stacks are {expert_bytes} bytes, the "
            f"whole model's {whole_bytes}")
    torch.cuda.empty_cache()
    prompt = lm_prompt(dev, LM_BATCH, LM_PROMPT, cfg.vocab, 191)
    axes, r0, n_rows = batch_rows(mesh, LM_BATCH)
    require(n_rows == LM_BATCH // MESH_SHAPE[0], f"19c: {n_rows} rows")
    prefill = engine.make_prefill_step(cfg, LM_PROMPT + DP_DECODE_STEPS,
                                       torch.float32, mesh=mesh)
    decode = engine.make_decode_step(cfg, mesh=mesh)
    b1, b5 = MIXERS["deepseek-moe-16b"]["prefill"]
    moe_layers = DP_DEEPSEEK_LAYERS - 1
    # a MoE layer: the exchange there and back, the gather of its rows,
    # one sum for the aux loss; the head: its columns and its rows
    per_call = {"all_to_all": 2 * moe_layers, "all_gather": moe_layers + 2,
                "all_reduce": moe_layers}
    out = {"calls": [], "expert_bytes": expert_bytes,
           "expert_bytes_whole": whole_bytes, "oracle": []}
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad(), MoeProbe() as probe, \
            CollectiveClock(engine) as clock:
        tok = None
        state = None
        for i in range(1 + DP_DECODE_STEPS):
            torch.cuda.synchronize()
            reset_counts()
            collectives.reset()
            c0, t0 = clock.seconds, time.perf_counter()
            with ctx.row_shard(mesh, axes):  # this rank's rows
                if i == 0:
                    (state, logits), seen = probe.take(lambda: prefill(
                        params, {"tokens": prompt[r0:r0 + n_rows]}))
                else:
                    (state, tok, logits), seen = probe.take(lambda: decode(
                        params, state, tok[r0:r0 + n_rows]))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if i == 0:
                tok = torch.argmax(logits, -1).to(torch.int32)
            n = counts()
            want = only(l2r_stacked_gemm=b1,
                        flash_attention=b5 if i == 0 else 0)
            require(n == want, f"19c call {i}: launches {n}, expected "
                               f"{want}")
            made = dict(collectives.COUNTS)
            require(made == per_call, f"19c call {i}: collectives {made}, "
                                      f"expected {per_call}")
            require(tuple(logits.shape[:2]) == (LM_BATCH, 1)
                    and bool(torch.isfinite(logits).all()),
                    f"19c call {i}: logits {tuple(logits.shape)}")
            # the oracle: the unmeshed moe_apply on this rank's group
            x = seen["x"].reshape(-1, cfg.d_model)
            t_g = x.shape[0] // MESH_SHAPE[1]
            j = mesh.index("model")
            x_g = x[j * t_g:(j + 1) * t_g][None]
            want_y, _ = moe_apply(cfg, {**seen["params"], **oracle_w}, x_g)
            same = torch.equal(want_y.reshape(t_g, -1), seen["y"])
            require(same, f"19c call {i}: the group output differs from "
                          f"moe_apply on the group's tokens")
            out["oracle"].append({"tokens": t_g, "equal": same})
            out["calls"].append({"ms": ms, "launches": n, "collectives": made,
                                 "collective_ms": (clock.seconds - c0) * 1e3,
                                 "tokens": tok[:, 0].tolist()})
            same_value_on_every_rank(mesh, tok.double().reshape(-1),
                                     f"19c call {i}: the tokens")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, state, oracle_w
    torch.cuda.empty_cache()
    return out


def dp_rank(ref17: dict, ref15: dict) -> dict:
    """One rank of phase 19 (run by spawn_local): the card, the mesh, 19a,
    19b, 19c.  The kernels were built in phase 1: a rank only loads
    them."""
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for name, src in _build.sources().items():
        require(_build._target(src).exists(),
                f"{name} is not built: phase 19's ranks only load kernels")
    mesh = make_local_mesh(*MESH_SHAPE)
    out = {"rank": dist.get_rank(), "coords": mesh.coords(),
           "backend": dist.get_backend()}
    for key, fn, args in (("train", dp_train, (ref17,)),
                          ("batcher", dp_batcher, (ref15,)),
                          ("moe", dp_moe, ())):
        t0 = time.perf_counter()
        out[key] = fn(dev, mesh, *args)
        out[key]["seconds_total"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def phase_dp(dev, train: dict, serve: dict) -> dict:
    """Phase 19: four ranks (2 x 2 mesh) on the one card over gloo: 19a
    ZeRO-1 training against phase 17, 19b the "batch" slot layout against
    15e's batcher, 19c dp-local MoE against its per-group oracle; 19d the
    kernels at the ranks' shapes (first, on the card alone)."""
    import gc

    from repro_torch.launch.mesh import spawn_local

    gc.collect()
    torch.cuda.empty_cache()
    smi = card()
    t0 = time.perf_counter()
    rows = dp_kernel_rows(dev)
    print(f"phase 19: {MESH_WORLD} ranks on a {MESH_SHAPE[0]} x "
          f"{MESH_SHAPE[1]} (data x model) mesh over gloo, all on the one "
          f"card ({smi}): four processes sharing one card, not a "
          f"multi-GPU figure", flush=True)
    ref17 = {k: train["run"][k] for k in ("losses", "grad_norms")}
    ref15 = serve["engines"]
    t1 = time.perf_counter()
    ranks = spawn_local(MESH_WORLD, dp_rank, ref17,
                        {k: ref15[k] for k in (
                            "batcher", "batcher_reqs", "batcher_stats",
                            "batcher_state_bytes")},
                        deadline_s=DP_DEADLINE_S)
    ranks_s = time.perf_counter() - t1
    for r in ranks:
        require(r["backend"] == "gloo", f"rank {r['rank']}: backend "
                                        f"{r['backend']}")
        require(r["moe"]["calls"][-1]["tokens"]
                == ranks[0]["moe"]["calls"][-1]["tokens"],
                f"rank {r['rank']}: 19c tokens differ from rank 0's")
    held = ranks[0]["train"]["scaled_vs_one_process"]
    out = {"card": smi, "backend": "gloo", "ranks": MESH_WORLD,
           "mesh": {"data": MESH_SHAPE[0], "model": MESH_SHAPE[1]},
           "seconds": time.perf_counter() - t0, "ranks_s": ranks_s,
           "rows": rows, "train_scaled_vs_one_process": held,
           "per_rank": [{
               "rank": r["rank"], "coords": r["coords"],
               "train": {k: r["train"][k] for k in (
                   "step_ms", "coll_ms", "losses", "grad_norms",
                   "launches", "peak_gb", "mv_bytes",
                   "mv_bytes_one_process", "param_bytes",
                   "param_bytes_one_process", "seq_sharded", "served_vs_17",
                   "seconds_total")},
               "batcher": {k: r["batcher"][k] for k in (
                   "seconds", "collective_s", "collectives", "launches",
                   "state_bytes", "rows", "seconds_total")},
               "moe": {k: r["moe"][k] for k in (
                   "calls", "oracle", "expert_bytes", "expert_bytes_whole",
                   "peak_gb", "seconds_total")}}
               for r in ranks]}
    print("phase 19: " + json.dumps(out, default=str), flush=True)
    out["audit22"] = [r["batcher"]["audit22"] for r in ranks]
    tr0 = ranks[0]["train"]
    print(f"phase 19: 19a SmolLM-135M {DP_STEPS} ZeRO-1 steps of 8 x "
          f"{TRAIN_SEQ} (4 a data rank), the params split over 'model' and "
          f"the sequence too: {B5_PER_TRAIN_STEP} B5 a step a rank, the "
          f"same loss and grad norm on every rank and params on each data "
          f"group; the rescaled step within TRAIN_B5_TOL of one process "
          f"({held}); m/v {tr0['mv_bytes']} bytes a rank (one process "
          f"{tr0['mv_bytes_one_process']}), params {tr0['param_bytes']} "
          f"(one process {tr0['param_bytes_one_process']}); 19b 15e's requests in the "
          f"'batch' layout == 15e's batcher bit for bit, half its slot "
          f"state a rank; 19c deepseek-moe-16b ({DP_DEEPSEEK_LAYERS} "
          f"layers) dp-local: every rank's group output == moe_apply on "
          f"its tokens bit for bit, half the expert bytes a rank; "
          f"launches and collectives exact; {out['seconds']:.1f} s",
          flush=True)
    return out


# ------------------------------------------------------------------ slice 14
# the tensor-parallel half of the mesh: the attention families' backbone
# split over "model" (sharding/axes.py:shard_params), the "specs" slot
# layout and tensor-parallel training; the ranks share the one card over
# gloo as in phases 18-19
TP_SHAPE = (1, 3)  # (data, model): 3 divides SmolLM-135M's 3 kv heads,
#                    9 q heads, d_ff 1536 and vocab 49,152
TP_WORLD = TP_SHAPE[0] * TP_SHAPE[1]
TP_STEPS = 1  # 20b's steps of the global batch 8 x 2048 (cut for time)
TP_DECODE_STEPS = 2  # 20c's greedy steps after its prefill
TP_DEADLINE_S = 900
TP_DEEPSEEK_B1 = 6 + 3 * (4 + 1 + 2 * 32 + 2) + 1  # 20c a call: 32 experts
TP_B1 = [  # (M, K, N, launches per rank per call, where, split ranks;
    # split over K: the row-parallel products, their partials summed)
    (8, 576, 192, 30, "20a wq decode (col)", 1),
    (8, 576, 64, 60, "20a wk wv decode (col)", 1),
    (8, 576, 2 * 512, 30, "20a mlp wi decode (col)", 1),
    (8, 192, 576, 30, "20a attn wo decode (row)", 3),
    (8, 512, 576, 30, "20a mlp wo decode (row)", 3),
    (2048, 576, 192, 30, "20a wq prefill (col)", 1),
    (2048, 576, 2 * 512, 30, "20a mlp wi prefill (col)", 1),
    (2048, 192, 576, 30, "20a attn wo prefill (row)", 3),
    (2048, 512, 576, 30, "20a mlp wo prefill (row)", 3),
    (4 * 2048, 2048, 1024, 12, "20c wq wk wv prefill (col)", 1),
    (4 * 2048, 1024, 2048, 4, "20c attn wo prefill (row)", 2),
    (4 * 2048, 2048, 2 * 5472, 1, "20c layer-0 wi prefill (col)", 1),
    (4 * 2048, 5472, 2048, 1, "20c layer-0 wo prefill (row)", 2),
    (4 * 2048, 2048, 2 * 1408, 3, "20c shared wi prefill (col)", 1),
    (4 * 2048, 1408, 2048, 3, "20c shared wo prefill (row)", 2),
    (4, 2048, 1024, 12, "20c wq wk wv decode (col)", 1),
    (4, 1024, 2048, 4, "20c attn wo decode (row)", 2),
]
TP_B5 = [  # (where, B, S, (H, Kv) whole, (H, Kv) a rank's, dh, dtype,
    # launches per rank per call)
    ("20a prefill", 8, 2048, (9, 3), (3, 1), 64, torch.bfloat16, 30),
    ("20b train forward", 8, 2048, (9, 3), (3, 1), 64, torch.float32, 60),
    ("20c prefill", 4, 2048, (16, 16), (8, 8), 128, torch.bfloat16, 4),
]
TP_DECODE = [  # (where, B, L, (H, Kv) whole, (H, Kv) a rank's, dh)
    ("20a decode", 8, 2080, (9, 3), (3, 1), 64),
    ("20c decode", 4, 2048 + 16 + 4, (16, 16), (8, 8), 128),
]


def b1_row_split_check(g, dev, m: int, k: int, n: int, ranks: int,
                       where: str) -> None:
    """The ranks' K-slices on kernel B1, their int32 partials summed in
    int64 and narrowed (sharding/collectives.py:sum_int's arithmetic):
    the whole product, at every level prefix."""
    from repro_torch.core.l2r_gemm import wrap_int32
    from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs
    from repro_torch.kernels.l2r_gemm import kernel

    a, b = operands(g, dev, m, k, n, 8)
    kl = k // ranks
    for lv in (None, 0, 3):
        whole = kernel.l2r_gemm_stacked_planes(
            stack_planes_lhs(a), stack_planes_rhs(b), levels=lv)
        total = sum(kernel.l2r_gemm_stacked_planes(
            stack_planes_lhs(a[:, j * kl:(j + 1) * kl].contiguous()),
            stack_planes_rhs(b[j * kl:(j + 1) * kl].contiguous()),
            levels=lv).to(torch.int64) for j in range(ranks))
        require(torch.equal(wrap_int32(total), whole),
                f"B1's K-split partials summed != the whole product at "
                f"{where} (levels {lv})")
    del a, b, whole, total


def head_subset(x: torch.Tensor, heads: int, j: int) -> torch.Tensor:
    return x[:, :, j * heads:(j + 1) * heads].contiguous()


def tp_kernel_rows(dev) -> dict:
    """20d: kernels B1, B2 and B5 at the shapes phase 20 gives a rank, on
    the card before the ranks start: B1 column and row products bit for
    bit against its plain version (the row products' K-split partials
    summed equal to the whole K's), B2 and B1's level slabs at 20a's head
    slice, B5 on a rank's heads equal bit for bit to those heads of the
    whole call (and within ATTN_TOL of its plain version), decode
    attention on a rank's heads equal to them in the whole batch; each
    timed beside its bound and torch._int_mm / SDPA."""
    from repro_torch.core.quant import QuantConfig, quantize_weights
    from repro_torch.device import no_tf32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import decode_attention

    g = torch.Generator(device=dev).manual_seed(200)
    b1 = []
    for m, k, n, count, where, ranks in TP_B1:
        b1.append(b1_shape_row(g, dev, m, k, n, count, where, "20d"))
        if ranks > 1:
            b1_row_split_check(g, dev, m, k * ranks, n, ranks, where)
    # the head walk of 20a: a rank's 16,384 columns, its 8 slots' rows
    w = torch.randn((LM_HEAD[0], LM_HEAD[1] // TP_SHAPE[1]), generator=g,
                    device=dev)
    cache = quantize_weights(w, QuantConfig(), prestack=True,
                             window_pad=True, plane_shifted=True,
                             k_major=True)
    xq = torch.randint(-127, 128, (SERVE_SLOTS, LM_HEAD[0]), generator=g,
                       device=dev, dtype=torch.int8)
    b2 = shard_shape_check(xq, cache, "20a head walk")
    print("phase 20d: " + json.dumps(b2), flush=True)
    del w, cache, xq
    b5 = []
    for where, b, s, (h, kv), (hp, kvp), dh, dtype, count in TP_B5:
        q, k_, v = attn_qkv(g, dev, b, s, s, h, kv, dh, dtype)
        with no_tf32():
            whole = fa.flash_attention(q, k_, v, causal=True)
            for j in range(h // hp):
                got = fa.flash_attention(head_subset(q, hp, j),
                                         head_subset(k_, kvp, j),
                                         head_subset(v, kvp, j), causal=True)
                require(torch.equal(got, whole[:, :, j * hp:(j + 1) * hp]),
                        f"B5 on rank {j}'s heads at {where} != those heads "
                        f"of the whole call")
            qs, ks, vs = (head_subset(t, c, 0)
                          for t, c in ((q, hp), (k_, kvp), (v, kvp)))
            got = fa.flash_attention(qs, ks, vs, causal=True)
            ref = fa.flash_attention_kernel_plain(qs, ks, vs, True)
        err, excess = attn_err(got, ref)
        require(excess <= ATTN_TOL[dtype][1], f"B5 at {where}: max |d| "
                f"{err} from plain, {excess} beyond the relative term")
        del whole, got, ref
        with no_tf32():
            call = lambda: fa.flash_attention(  # noqa: E731
                qs, ks, vs, causal=True)
            _, lib_fn = sdpa(qs, ks, vs, True, None)
            row = {"name": where, "count": count, "B": b, "S": s, "H": hp,
                   "Kv": kvp, "H_whole": h, "Kv_whole": kv, "dh": dh,
                   "dtype": str(dtype).split(".")[-1],
                   "ms": time_ms(call, iters=5, warmup=1),
                   "kernel_ms": stream_ms(call),
                   "plain_ms": time_ms(lambda: fa.flash_attention_kernel_plain(
                       qs, ks, vs, True), iters=3, warmup=1),
                   "library_ms": time_ms(lib_fn, iters=5, warmup=1)}
        pairs = visible_pairs(s, s, True, None)
        row["bound_ms"], row["bound_by"] = attn_bound(
            b, hp, dh, pairs, dtype,
            (2 * qs.numel() + 2 * ks.numel()) * qs.element_size())
        row["max_abs_err"] = err
        row["heads_equal_whole_call"] = True
        b5.append(row)
        print("phase 20d: " + json.dumps(row), flush=True)
        del q, k_, v, qs, ks, vs
        torch.cuda.empty_cache()
    decode = []
    for where, b, L, (h, kv), (hp, kvp), dh in TP_DECODE:
        q = torch.randn((b, 1, h, dh), generator=g, device=dev)
        k_ = torch.randn((b, L, kv, dh), generator=g, device=dev)
        v = torch.randn((b, L, kv, dh), generator=g, device=dev)
        pos = torch.arange(L, device=dev, dtype=torch.int32).expand(
            b, L).contiguous()
        qpos = torch.full((b,), L - 3, device=dev, dtype=torch.int32)
        whole = decode_attention(q, k_, v, pos, qpos)
        parts = [(head_subset(q, hp, j), head_subset(k_, kvp, j),
                  head_subset(v, kvp, j)) for j in range(h // hp)]
        for j, (qj, kj, vj) in enumerate(parts):
            got = decode_attention(qj, kj, vj, pos, qpos, kv_whole=kv)
            require(torch.equal(got, whole[:, :, j * hp:(j + 1) * hp]),
                    f"decode attention on rank {j}'s heads at {where} != "
                    f"those heads of the whole batch")
        qj, kj, vj = parts[0]
        ms = time_ms(lambda: decode_attention(qj, kj, vj, pos, qpos,
                                              kv_whole=kv))
        row = {"name": where, "B": b, "L": L, "H": hp, "Kv": kvp, "dh": dh,
               "heads_equal_whole_call": True, "ms": ms,
               "ms_whole": time_ms(lambda: decode_attention(q, k_, v, pos,
                                                            qpos))}
        decode.append(row)
        print("phase 20d: " + json.dumps(row), flush=True)
        del q, k_, v, parts, whole
    torch.cuda.empty_cache()
    return {"b1": b1, "b2": [b2], "b5": b5, "decode": decode}


def spec_share_bytes(cfg, params, mesh) -> int:
    """The bytes of a prepared backbone's ``param_specs`` slices (the head
    cache ``head_q`` aside): a cache split on any dim keeps 1/m of its
    codes and plane stack, and 1/m of its scales when split by output
    channels (a row split keeps the whole columns' scales)."""
    from repro_torch.core.quant import QuantizedWeights
    from repro_torch.models.transformer import lm_build
    from repro_torch.sharding.axes import param_specs

    m = mesh.shape["model"]
    specs = param_specs(lm_build(cfg), mesh)
    pairs = []

    def walk(x, s):
        if isinstance(s, dict):
            for key in sorted(s):
                walk(x[key], s[key])
        elif isinstance(s, list):
            for a, b in zip(x, s):
                walk(a, b)
        else:
            pairs.append((x, s))

    walk({k: params[k] for k in specs}, specs)
    total = 0
    for x, s in pairs:
        split = any(a == "model" for a in s) and m > 1
        f = m if split else 1
        if isinstance(x, QuantizedWeights):
            col = split and s[-1] == "model"
            total += (x.q.numel() * x.q.element_size()
                      + x.planes.stack.numel() * x.planes.stack.element_size()
                      ) // f
            total += x.scale.numel() * x.scale.element_size() // (
                m if col else 1)
        else:
            total += x.numel() * x.element_size() // f
    return total


def backbone_bytes(params) -> int:
    from repro_torch.serve.batching import _tensors

    return sum(t.numel() * t.element_size() for t in _tensors(
        {k: v for k, v in params.items() if k != "head_q"}))


def kv_bytes(state) -> int:
    from repro_torch.models.attention import KVCache

    return sum(t.numel() * t.element_size()
               for c in (*state.prefix, *(state.stack or []), *state.suffix)
               if isinstance(c, KVCache) for t in (c.k, c.v))


def tp_serve(dev, mesh, ref15) -> dict:
    """20a on this rank: phase 13's model prepared (the head 16,384
    columns a rank), cut by ``shard_params`` (3 of 9 q heads, 1 of 3 kv
    heads, 512 of 1536 ffn columns), 15e's requests through
    ``ContinuousBatcher(state_sharding="specs")``."""
    from repro_torch.kernels.l2r_gemm import ops
    from repro_torch.models.transformer import init_lm_state
    from repro_torch.serve import ContinuousBatcher, engine
    from repro_torch.sharding import collectives
    from repro_torch.sharding.axes import shard_params

    cfg, whole, _ = lm_model(dev, mesh=mesh)
    out = {"backbone_bytes_whole": backbone_bytes(whole),
           "backbone_bytes_want": spec_share_bytes(cfg, whole, mesh)}
    params = shard_params(cfg, whole, mesh)
    del whole
    torch.cuda.empty_cache()
    out["backbone_bytes"] = backbone_bytes(params)
    require(out["backbone_bytes"] == out["backbone_bytes_want"],
            f"20a: this rank's backbone is {out['backbone_bytes']} bytes; "
            f"its param_specs share {out['backbone_bytes_want']}")
    with torch.no_grad():
        eng = ContinuousBatcher(cfg, params, n_slots=SERVE_SLOTS,
                                max_len=SERVE_MAX_LEN, progressive=True,
                                early_exit=True, device=dev, mesh=mesh,
                                state_sharding="specs")
        out["kv_bytes"] = kv_bytes(eng.state)
        out["kv_bytes_whole"] = kv_bytes(init_lm_state(
            cfg, SERVE_SLOTS, SERVE_MAX_LEN, torch.float32, device="meta"))
        require(TP_SHAPE[1] * out["kv_bytes"] == out["kv_bytes_whole"],
                f"20a: this rank's KV caches are {out['kv_bytes']} bytes; "
                f"15e's {out['kv_bytes_whole']}")
        reqs = serve_requests(cfg)
        for r in reqs:
            eng.submit(r)
        reset_counts()
        collectives.reset()
        t0 = time.perf_counter()
        with collectives.recording() as records, \
                CollectiveClock(ops) as clock, \
                WalkProbe(engine, mesh, rows_sharded=False) as probe:
            batcher_audit = run_audited(eng, "20a batcher")
            torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
    out.update(reqs=served(reqs), stats=served_stats(eng),
               launches=counts(), collective_s=clock.seconds,
               walk_collective_s=sum(w["collective_ms"]
                                     for w in probe.walks) / 1e3,
               collectives=dict(collectives.COUNTS), walks=len(probe.walks))
    forwards = out["stats"]["steps"] + out["stats"]["prefills"]
    per = engine.split_collectives(cfg, params)
    want = {k: forwards * per[k] + 2 * len(probe.walks) * (k == "all_reduce")
            + sum(w["collectives"][k] for w in probe.walks) for k in per}
    out["collectives_want"] = want
    out["split_collectives_per_forward"] = per
    require(out["collectives"] == want,
            f"20a: collectives {out['collectives']}, the code derives "
            f"{want} ({forwards} forwards of {per}, {len(probe.walks)} "
            f"walks and their same-input checks)")
    out["audit22"] = {"batcher": batcher_audit, "walks": probe.audited,
                      "run": audit_run(records, want, mesh, "20a", False)}
    require(out["reqs"] == ref15["batcher_reqs"],
            "20a: tokens or exit levels differ from 15e's batcher")
    require(out["stats"] == ref15["batcher_stats"],
            "20a: stats differ from 15e's batcher")
    launched = {k: v for k, v in out["launches"].items() if v}
    require(launched == ref15["batcher"]["launches"],
            f"20a: launches {launched}, 15e's batcher "
            f"{ref15['batcher']['launches']}")
    del eng, params
    torch.cuda.empty_cache()
    return out


def local_checksum_same(mesh, axes, leaves, what: str) -> None:
    """Require the checksum of ``leaves`` equal on every rank of the group
    over ``axes`` (a MAX and a MIN all-reduce)."""
    from repro_torch.sharding.collectives import all_reduce

    c = tree_checksum(leaves)
    group = mesh.group(axes)
    require(torch.equal(all_reduce(c, "max", group),
                        all_reduce(c, "min", group)),
            f"{what} differs between the ranks over {axes}")


def train_split_run(dev, mesh, steps: int, seq_shard: bool,
                    ref17: dict, tag: str) -> dict:
    """``steps`` steps of ``make_train_step(mesh=)`` on SmolLM-135M as
    17a (seed 170, f32, remat, xent chunks of 512, AdamW) with the params
    split per param_specs and ZeRO-1 state: 60 B5 a step a rank, the loss,
    grad norm and the leaves held whole the same on every rank, the split
    leaves the same on the ranks that hold the same slices (the data
    group), each rank's m / v bytes its zero1_specs share; then one step from the width-rescaled
    weights within TRAIN_B5_TOL of the one-process step (rank 0 runs
    both)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, ShardedPipeline
    from repro_torch.device import no_tf32
    from repro_torch.kernels.l2r_gemm import ops
    from repro_torch.models import transformer
    from repro_torch.models.common import (fan_in_scaled, materialize,
                                           tree_leaves)
    from repro_torch.models.transformer import lm_build
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.sharding.axes import gather_params, shard_params
    from repro_torch.train import step as ts

    cfg = dataclasses.replace(get_config(LM_ARCH), compute_dtype="float32")
    params0 = materialize(lm_build(cfg), torch.Generator(device=dev)
                          .manual_seed(170), device=dev)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    tcfg = ts.TrainConfig(remat=True, seq_shard=seq_shard,
                          xent_chunk=TRAIN_XENT)
    zero = ts.zero1_layout(cfg, mesh)
    step = ts.make_train_step(cfg, ocfg, tcfg, mesh)
    pipe = ShardedPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
               for _ in range(steps)]
    params = shard_params(cfg, params0, mesh)
    whole_shapes = [tuple(x.shape) for x in tree_leaves(params0)]
    run = {"param_bytes": sum(x.numel() * x.element_size()
                              for x in tree_leaves(params)),
           "param_bytes_one_process": sum(x.numel() * x.element_size()
                                          for x in tree_leaves(params0)),
           "seq_sharded": ts._resid_shard_fn(mesh, tcfg, TRAIN_BATCH,
                                             TRAIN_SEQ)[1]}
    opt = adamw_init(params, zero)
    mv_bytes = sum(x.numel() * x.element_size()
                   for x in tree_leaves((opt.m, opt.v)))
    want_bytes = zero1_share_bytes(zero)
    require(mv_bytes == want_bytes, f"{tag}: this rank's m and v hold "
                                    f"{mv_bytes} bytes; zero1_specs give "
                                    f"{want_bytes}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    run.update(losses=[], grad_norms=[], step_ms=[], coll_ms=[], launches=[])
    with CollectiveClock(ts, adamw, ops, transformer) as clock:
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            reset_counts()
            c0, t0 = clock.seconds, time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            run["coll_ms"].append((clock.seconds - c0) * 1e3)
            n = counts()
            require(n == only(flash_attention=B5_PER_TRAIN_STEP),
                    f"{tag} step {i}: launches {n}, expected "
                    f"{B5_PER_TRAIN_STEP} of B5 and no other")
            run["launches"].append(n["flash_attention"])
            run["losses"].append(m["loss"].item())
            run["grad_norms"].append(m["grad_norm"].item())
            same_value_on_every_rank(mesh, torch.stack(
                [m["loss"], m["grad_norm"]]).double(),
                f"{tag} step {i}: the loss or grad norm")
            # the leaves every rank holds whole (the norms) are the same
            # on every rank; a split leaf on every rank holding its slice
            leaves = tree_leaves(params)
            local_checksum_same(mesh, ("data", "model"), [
                x for x, d in zip(leaves, whole_shapes)
                if tuple(x.shape) == d], f"{tag} step {i}: the whole params")
            if mesh.shape["data"] > 1:
                local_checksum_same(mesh, "data", leaves,
                                    f"{tag} step {i}: a rank's params")
    run["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    run["mv_bytes"] = mv_bytes
    run["mv_bytes_one_process"] = sum(8 * x.numel()
                                      for x in tree_leaves(params0))
    run["served_vs_17"] = {
        "loss_rel": [abs(a - b) / abs(b) for a, b in
                     zip(run["losses"], ref17["losses"])],
        "grad_norm_rel": [abs(a - b) / abs(b) for a, b in
                          zip(run["grad_norms"], ref17["grad_norms"])]}
    del params, opt
    torch.cuda.empty_cache()
    # the held check: one step from the width-rescaled weights
    scaled = fan_in_scaled(cfg, params0)
    del params0
    split = shard_params(cfg, scaled, mesh)
    loss, _, grads = ts.make_grad_fn(cfg, tcfg, mesh)(split, batches[0])
    with no_tf32():
        new_p, _, om = adamw_update(ocfg, grads, split,
                                    adamw_init(split, zero), zero)
    grads = gather_params(cfg, grads, mesh)
    new_p = gather_params(cfg, new_p, mesh)
    held = None
    if mesh.rank == 0:
        one_loss, _, one_grads = ts.make_grad_fn(cfg, tcfg)(scaled,
                                                           batches[0])
        with no_tf32():
            one_p, _, one_om = adamw_update(ocfg, one_grads, scaled,
                                            adamw_init(scaled))
        old = tree_leaves(scaled)
        upd = [a - o for a, o in zip(tree_leaves(new_p), old)]
        one_upd = [a - o for a, o in zip(tree_leaves(one_p), old)]
        gn = one_om["grad_norm"].item()
        held = {"loss_rel": abs(loss.item() - one_loss.item())
                / abs(one_loss.item()),
                "grad_norm_rel": abs(om["grad_norm"].item() - gn) / gn,
                "grad_worst": tree_close(
                    tree_leaves(grads), tree_leaves(one_grads),
                    TRAIN_B5_TOL["grad"], TRAIN_B5_TOL["grad_abs"] * gn),
                "update_worst": tree_close(upd, one_upd,
                                           TRAIN_B5_TOL["update"])}
        require(held["loss_rel"] <= TRAIN_B5_TOL["loss"]
                and held["grad_norm_rel"] <= TRAIN_B5_TOL["grad_norm"]
                and held["grad_worst"] <= 1 and held["update_worst"] <= 1,
                f"{tag}: the split step and the one-process step differ on "
                f"the rescaled weights: {held}")
    run["scaled_vs_one_process"] = held
    del scaled, split, grads, new_p
    torch.cuda.empty_cache()
    return run


def tp_rank(ref15: dict, ref17: dict) -> dict:
    """One rank of phase 20's 1 x 3 mesh (run by spawn_local): 20a, 20b."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_local_mesh(*TP_SHAPE)
    out = {"rank": dist.get_rank(), "coords": mesh.coords(),
           "backend": dist.get_backend()}
    for key, fn in (("serve", lambda: tp_serve(dev, mesh, ref15)),
                    ("train", lambda: train_split_run(
                        dev, mesh, TP_STEPS, True, ref17, "20b"))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["seconds_total"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def tp_moe(dev, mesh, ref16: dict) -> dict:
    """20c on this rank of the 2 x 2 mesh: deepseek-moe-16b as phase 16 (4
    layers, prepared, seed 160) cut by ``shard_params`` (8 of 16 heads, 32
    of 64 experts, layer 0's d_ff 5,472, half the vocabulary), its rows
    of phase 16's 8 x 2048 prompt (over "data") prefilled and stepped
    TP_DECODE_STEPS times greedily with "specs"-layout state."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.l2r_gemm import ops
    from repro_torch.models.common import materialize
    from repro_torch.models.transformer import lm_build
    from repro_torch.serve import engine
    from repro_torch.sharding import collectives, ctx
    from repro_torch.sharding.axes import batch_rows, shard_params

    spec = MIXERS["deepseek-moe-16b"]
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              l2r=QuantConfig(), n_layers=spec["layers"])
    params = materialize(lm_build(cfg), torch.Generator(device=dev)
                         .manual_seed(160), device=dev)
    params = engine.prepare_params(cfg, params, mesh=mesh)
    ffn = params["stack"][0]["ffn"]
    out = {"expert_bytes_whole": sum(ffn[k].numel() * ffn[k].element_size()
                                     for k in ("wi", "wo")),
           "backbone_bytes_whole": backbone_bytes(params),
           "backbone_bytes_want": spec_share_bytes(cfg, params, mesh)}
    params = shard_params(cfg, params, mesh)
    torch.cuda.empty_cache()
    ffn = params["stack"][0]["ffn"]
    out["expert_bytes"] = sum(ffn[k].numel() * ffn[k].element_size()
                              for k in ("wi", "wo"))
    out["backbone_bytes"] = backbone_bytes(params)
    require(2 * out["expert_bytes"] == out["expert_bytes_whole"]
            and out["backbone_bytes"] == out["backbone_bytes_want"],
            f"20c: this rank holds {out['expert_bytes']} expert bytes (the "
            f"whole stacks {out['expert_bytes_whole']}) and "
            f"{out['backbone_bytes']} backbone bytes (its param_specs "
            f"share {out['backbone_bytes_want']})")
    tokens = mixer_batch(cfg, dev, spec["prompt"], 162)["tokens"]
    axes, r0, n_rows = batch_rows(mesh, MIX_BATCH)
    prefill = engine.make_prefill_step(cfg, spec["prompt"] + MIX_STEPS + 4,
                                       torch.float32, mesh=mesh)
    decode = engine.make_decode_step(cfg, mesh=mesh)
    moe_layers = spec["layers"] - 1
    split = engine.split_collectives(cfg, params)
    # beyond the split: a MoE layer's slot offsets (a gather) and aux
    # means (a sum) over the rows' split, the head's columns and rows
    per_call = {"all_reduce": split["all_reduce"] + moe_layers,
                "all_gather": split["all_gather"] + moe_layers + 2,
                "all_to_all": 0}
    out.update(calls=[], per_call_collectives=per_call)
    torch.cuda.reset_peak_memory_stats(dev)
    toks = []
    out["audit22"] = []
    with torch.no_grad(), collectives.recording() as records, \
            CollectiveClock(engine, ops) as clock:
        state = tok = None
        for i in range(1 + TP_DECODE_STEPS):
            i0 = len(records)
            torch.cuda.synchronize()
            reset_counts()
            collectives.reset()
            c0, t0 = clock.seconds, time.perf_counter()
            with ctx.row_shard(mesh, axes):
                if i == 0:
                    state, logits = prefill(
                        params, {"tokens": tokens[r0:r0 + n_rows]})
                else:
                    state, tok, logits = decode(params, state,
                                                tok[r0:r0 + n_rows])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if i == 0:
                tok = torch.argmax(logits, -1).to(torch.int32)
                out["prefill_logits_checksum"] = float(tree_checksum(
                    [logits.float()]).item())
                out["prefill_records"] = [r.to_json() for r in records]
                out["kv_heads"] = int(state.stack[0].k.shape[-2])
            toks.append(tok)
            n = counts()
            want = only(l2r_stacked_gemm=TP_DEEPSEEK_B1,
                        flash_attention=spec["prefill"][1] if i == 0 else 0)
            require(n == want, f"20c call {i}: launches {n}, expected {want}")
            made = dict(collectives.COUNTS)
            require(made == per_call, f"20c call {i}: collectives {made}, "
                                      f"expected {per_call}")
            # the MoE layers' aux means are float router sums
            out["audit22"].append(audit_run(records[i0:], per_call, mesh,
                                            f"20c call {i}", True))
            out["calls"].append({"ms": ms, "launches": n, "collectives": made,
                                 "collective_ms": (clock.seconds - c0) * 1e3})
    seqs = torch.cat(toks, 1).tolist()
    out["tokens"] = seqs
    require(out["kv_heads"] == cfg.n_kv // mesh.shape["model"],
            f"20c: the KV caches hold {out['kv_heads']} heads")
    require(seqs == [r[:1 + TP_DECODE_STEPS] for r in ref16["tokens"]],
            "20c: tokens differ from phase 16's one-process run")
    require(out["prefill_logits_checksum"] == ref16["prefill_logits_checksum"],
            "20c: the prefill's last-position logits differ from phase 16's")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, state
    torch.cuda.empty_cache()
    return out


def tp_moe_rank(ref16: dict) -> dict:
    """One rank of 20c's 2 x 2 mesh (run by spawn_local)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_local_mesh(*MESH_SHAPE)
    t0 = time.perf_counter()
    out = {"rank": dist.get_rank(), "coords": mesh.coords(),
           "backend": dist.get_backend(), "moe": tp_moe(dev, mesh, ref16)}
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_tp(dev, train: dict, serve: dict, mix: dict) -> dict:
    """Phase 20: 20d the kernels at the ranks' shapes (first, on the card
    alone), then three gloo ranks on a 1 x 3 mesh sharing the card (20a
    the "specs" batcher against 15e's, 20b the split train step against
    one process), then four on the 2 x 2 mesh (20c deepseek-moe-16b split
    against phase 16)."""
    import gc

    from repro_torch.launch.mesh import spawn_local

    gc.collect()
    torch.cuda.empty_cache()
    smi = card()
    t0 = time.perf_counter()
    rows = tp_kernel_rows(dev)
    ref15 = {k: serve["engines"][k] for k in (
        "batcher", "batcher_reqs", "batcher_stats")}
    ref17 = {k: train["run"][k] for k in ("losses", "grad_norms")}
    ds = mix["runs"]["deepseek-moe-16b"]
    ref16 = {"tokens": ds["tokens"],
             "prefill_logits_checksum": ds["prefill_logits_checksum"]}
    print(f"phase 20: {TP_WORLD} ranks on a {TP_SHAPE[0]} x {TP_SHAPE[1]} "
          f"and {MESH_WORLD} on a {MESH_SHAPE[0]} x {MESH_SHAPE[1]} (data x "
          f"model) mesh over gloo, all on the one card ({smi}): processes "
          f"sharing one card, not a multi-GPU figure", flush=True)
    t1 = time.perf_counter()
    ranks = spawn_local(TP_WORLD, tp_rank, ref15, ref17,
                        deadline_s=TP_DEADLINE_S)
    t2 = time.perf_counter()
    moe = spawn_local(MESH_WORLD, tp_moe_rank, ref16,
                      deadline_s=TP_DEADLINE_S)
    t3 = time.perf_counter()
    for r in ranks + moe:
        require(r["backend"] == "gloo", f"rank {r['rank']}: backend "
                                        f"{r['backend']}")
    held = ranks[0]["train"]["scaled_vs_one_process"]
    out = {"card": smi, "backend": "gloo", "seconds": t3 - t0,
           "ranks_s": {"20a_20b": t2 - t1, "20c": t3 - t2},
           "mesh": {"20a_20b": {"data": TP_SHAPE[0], "model": TP_SHAPE[1]},
                    "20c": {"data": MESH_SHAPE[0], "model": MESH_SHAPE[1]}},
           "rows": rows, "train_scaled_vs_one_process": held,
           "per_rank": [{
               "rank": r["rank"], "coords": r["coords"],
               "serve": {k: r["serve"][k] for k in (
                   "seconds", "collective_s", "walk_collective_s",
                   "collectives", "split_collectives_per_forward", "walks",
                   "launches", "kv_bytes", "kv_bytes_whole",
                   "backbone_bytes", "backbone_bytes_whole",
                   "seconds_total")},
               "train": {k: r["train"][k] for k in (
                   "step_ms", "coll_ms", "losses", "grad_norms", "launches",
                   "peak_gb", "mv_bytes", "mv_bytes_one_process",
                   "param_bytes", "param_bytes_one_process", "seq_sharded",
                   "served_vs_17", "seconds_total")}} for r in ranks],
           "moe_per_rank": [{
               "rank": r["rank"], "coords": r["coords"],
               "seconds": r["seconds"], **{k: r["moe"][k] for k in (
                   "calls", "per_call_collectives", "expert_bytes",
                   "expert_bytes_whole", "backbone_bytes",
                   "backbone_bytes_whole", "kv_heads", "peak_gb")}}
               for r in moe]}
    print("phase 20: " + json.dumps(out, default=str), flush=True)
    out["audit22"] = {"20a": [r["serve"]["audit22"] for r in ranks],
                      "20c": [r["moe"]["audit22"] for r in moe]}
    tr0 = ranks[0]["train"]
    print(f"phase 20: 20a SmolLM-135M on {TP_SHAPE[0]} x {TP_SHAPE[1]}: "
          f"15e's requests in the 'specs' layout == 15e's batcher bit for "
          f"bit on every rank, a third of its KV bytes and of its backbone "
          f"a rank, launches and collectives as derived; 20b "
          f"{TP_STEPS} split step(s) of 8 x {TRAIN_SEQ} (the sequence whole: "
          f"{TP_SHAPE[1]} does not divide {TRAIN_SEQ}), {B5_PER_TRAIN_STEP} "
          f"B5 a step a rank, the rescaled step within TRAIN_B5_TOL of one "
          f"process ({held}), params {tr0['param_bytes']} bytes a rank "
          f"(one process {tr0['param_bytes_one_process']}); 20c "
          f"deepseek-moe-16b ({MIXERS['deepseek-moe-16b']['layers']} "
          f"layers) on {MESH_SHAPE[0]} x {MESH_SHAPE[1]}, heads, experts, "
          f"d_ff and vocabulary split: phase 16's tokens and prefill logits "
          f"bit for bit; {out['seconds']:.1f} s", flush=True)
    return out


def tp_summary(tp: dict, lib: str) -> dict:
    """Kernel ``lib``'s launches on each rank of phase 20 and its rows at
    the ranks' shapes."""
    key = {"l2r_stacked_gemm": "b1", "l2r_streaming_gemm": "b2",
           "flash_attention": "b5"}[lib]
    return {"per": f"phase 20: {TP_WORLD} ranks on a {TP_SHAPE[0]} x "
                   f"{TP_SHAPE[1]} mesh (20a over the batcher run, 20b over "
                   f"{TP_STEPS} train step(s)) and {MESH_WORLD} on a "
                   f"{MESH_SHAPE[0]} x {MESH_SHAPE[1]} mesh (20c over the "
                   f"prefill and {TP_DECODE_STEPS} steps), over gloo on one "
                   f"card; launches per rank",
            "card": tp["card"], "shapes": tp["rows"][key],
            "per_rank": [{"rank": r["rank"],
                          "serve": r["serve"]["launches"][lib],
                          "train": sum(r["train"]["launches"])
                          if lib == "flash_attention" else 0}
                         for r in tp["per_rank"]],
            "moe_per_rank": [{"rank": r["rank"], "moe": sum(
                c["launches"][lib] for c in r["calls"])}
                for r in tp["moe_per_rank"]]}


# ------------------------------------------------------------------ slice 15
# the rest of the tensor-parallel mesh: the SSD, RG-LRU and whisper mixers
# split over "model" and the head_dim KV-cache layout, on the 2 x 2 mesh
# of four gloo ranks sharing the one card (phases 18-20)
TPM_ARCHS = ("mamba2-130m", "recurrentgemma-2b", "whisper-base")
TPM_STEPS = 8  # 21a-21c: greedy steps after phase 16's prompts (16: 32)
TPM_REQUESTS, TPM_MAX_NEW = 8, 4  # 21d: 15e's first 8 requests, <= 4 new
TPM_TRAIN_STEPS, TPM_TRAIN_SEQ = 2, 128  # 21e: whisper-base, 8 rows
TPM_DEADLINE_S = 900
TPM_M = MESH_SHAPE[1]
TPM_B1 = [  # (M, K, N, launches per rank per call, where, split ranks;
    # split over K: the row-parallel products, their partials summed)
    (4 * 2048, 768, 768 + 768 + 256 + 12, 24,
     "21a in_proj prefill (col, head-aligned)", 1),
    (4 * 2048, 768, 768, 24, "21a out_proj prefill (row)", TPM_M),
    (4, 768, 768 + 768 + 256 + 12, 24, "21a in_proj decode (col)", 1),
    (4 * 2048, 2560, 1280, 18 * 2 + 8, "21b gate rec_proj wq prefill (col)",
     1),
    (4 * 2048, 1280, 2560, 18 + 8, "21b out_proj wo prefill (row)", TPM_M),
    (4 * 2048, 2560, 2 * 3840, 26, "21b mlp wi prefill (col)", 1),
    (4 * 2048, 3840, 2560, 26, "21b mlp wo prefill (row)", TPM_M),
    (4 * 1500, 512, 256, 6 * 3, "21c encoder q k v (col)", 1),
    (4 * 1500, 1024, 512, 6, "21c encoder mlp wo (row)", TPM_M),
    (4, 576, 288, 30, "21d wq decode (col)", 1),
    (4, 576, 96, 60, "21d wk wv decode (col)", 1),
    (4, 288, 576, 30, "21d wo decode (row)", TPM_M),
    (4, 576, 2 * 768, 30, "21d mlp wi decode (col)", 1),
    (4, 768, 576, 30, "21d mlp wo decode (row)", TPM_M),
]
TPM_B5 = [  # (where, B, Sq, Skv, causal, launches per rank per call):
    # whisper-base's 8 heads of 64, 4 a rank, bf16
    ("21c encoder", 4, 1500, 1500, False, 6),
    ("21c prefill self", 4, 128, 128, True, 6),
    ("21c prefill cross", 4, 128, 1500, False, 6),
    ("21c decode cross", 4, 1, 1500, False, 6),
]
TPM_DECODE = [  # (where, B, L, H, Kv, dh): the head_dim layout at model 2
    ("21d SmolLM-135M", 4, 2080, 9, 3, 64),
    ("21b recurrentgemma-2b local", 4, 2048, 10, 1, 256),
]


def tpm_kernel_rows(dev) -> dict:
    """21f: at the shapes phase 21 gives a rank, on the card before the
    ranks start: B1 column and row products bit for bit against its plain
    version (the row products' K-split partials summed equal the whole
    K's); B5 on a rank's heads of whisper-base equal to those heads of
    the whole call (and within ATTN_TOL of its plain version); the SSD's
    chunk products and decode readout on a rank's heads (and rows) equal
    to the whole call's; the split gated norm's mean equal to the whole
    row's; decode attention on the head_dim layout's value slices equal
    to the whole heads' (with and without attn_l2r).  B1 and B5 timed
    beside their bounds and torch._int_mm / SDPA."""
    import torch.nn.functional as F

    from repro_torch.core.quant import QuantConfig
    from repro_torch.device import no_tf32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import ssm
    from repro_torch.models.attention import (decode_attention,
                                              init_kv_cache,
                                              update_kv_cache)
    from repro_torch.models.common import (_row_mean, row_mean_of_parts,
                                           row_mean_parts)

    g = torch.Generator(device=dev).manual_seed(210)
    b1 = []
    for m, k, n, count, where, ranks in TPM_B1:
        b1.append(b1_shape_row(g, dev, m, k, n, count, where, "21f"))
        if ranks > 1:
            b1_row_split_check(g, dev, m, k * ranks, n, ranks, where)
    b5 = []
    for where, b, sq, skv, causal, count in TPM_B5:
        q, k_, v = attn_qkv(g, dev, b, sq, skv, 8, 8, 64, torch.bfloat16)
        hp = 8 // TPM_M
        with no_tf32():
            whole = fa.flash_attention(q, k_, v, causal=causal)
            for j in range(TPM_M):
                got = fa.flash_attention(head_subset(q, hp, j),
                                         head_subset(k_, hp, j),
                                         head_subset(v, hp, j), causal=causal)
                require(torch.equal(got, whole[:, :, j * hp:(j + 1) * hp]),
                        f"B5 on rank {j}'s heads at {where} != those heads "
                        f"of the whole call")
            qs, ks, vs = (head_subset(t, hp, 0) for t in (q, k_, v))
            got = fa.flash_attention(qs, ks, vs, causal=causal)
            ref = fa.flash_attention_kernel_plain(qs, ks, vs, causal)
            err, excess = attn_err(got, ref)
            require(excess <= ATTN_TOL[torch.bfloat16][1],
                    f"B5 at {where}: max |d| {err} from plain, {excess} "
                    f"beyond the relative term")
            call = lambda: fa.flash_attention(  # noqa: E731
                qs, ks, vs, causal=causal)
            _, lib_fn = sdpa(qs, ks, vs, causal, None)
            row = {"name": where, "count": count, "B": b, "Sq": sq,
                   "Skv": skv, "H": hp, "H_whole": 8, "dh": 64,
                   "dtype": "bfloat16", "ms": time_ms(call, iters=5,
                                                      warmup=1),
                   "kernel_ms": stream_ms(call),
                   "plain_ms": time_ms(lambda: fa.flash_attention_kernel_plain(
                       qs, ks, vs, causal), iters=3, warmup=1),
                   "library_ms": time_ms(lib_fn, iters=5, warmup=1)}
        row["bound_ms"], row["bound_by"] = attn_bound(
            b, hp, 64, visible_pairs(sq, skv, causal, None), torch.bfloat16,
            (2 * qs.numel() + 2 * ks.numel()) * qs.element_size())
        row["max_abs_err"] = err
        row["heads_equal_whole_call"] = True
        b5.append(row)
        print("phase 21f: " + json.dumps(row), flush=True)
        del q, k_, v, qs, ks, vs, whole, got, ref
        torch.cuda.empty_cache()
    # the SSD's products: mamba2-130m's 24 heads, a rank's 12 of its 4 of
    # 8 rows; a one-row 256-token prefill; the decode readout
    checks = {}
    for bsz, s, rows in ((8, 2048, 4), (1, 256, 1)):
        h, p, n = 24, 64, 128
        x = torch.randn((bsz, s, h, p), generator=g, device=dev)
        dt = F.softplus(torch.randn((bsz, s, h), generator=g, device=dev))
        a = -dt * 0.5
        bb = torch.randn((bsz, s, n), generator=g, device=dev)
        cc = torch.randn((bsz, s, n), generator=g, device=dev)
        y, st = ssm.ssd_chunked(x, dt, a, bb, cc, 256, h)
        hl = h // TPM_M
        for r0 in range(0, bsz, rows):
            r = slice(r0, r0 + rows)
            for j in range(TPM_M):
                hs = slice(j * hl, (j + 1) * hl)
                yj, sj = ssm.ssd_chunked(
                    x[r, :, hs].contiguous(), dt[r, :, hs].contiguous(),
                    a[r, :, hs].contiguous(), bb[r], cc[r], 256, h, j * hl)
                require(torch.equal(yj, y[r, :, hs])
                        and torch.equal(sj, st[r, hs]),
                        f"the SSD products of rows {r0}+{rows}, heads {j} "
                        f"of {bsz} x {s} != the whole call's")
        checks[f"ssd_chunk_{bsz}x{s}_rows{rows}"] = True
        del x, dt, a, bb, cc, y, st
    st_in = torch.randn((8, 24, 128, 64), generator=g, device=dev)
    c1 = torch.randn((8, 128), generator=g, device=dev)
    read = ssm.ssd_readout(c1, st_in, 24)
    for r0 in (0, 4):
        for j in range(TPM_M):
            hs = slice(j * 12, (j + 1) * 12)
            require(torch.equal(ssm.ssd_readout(
                c1[r0:r0 + 4], st_in[r0:r0 + 4, hs].contiguous(), 24),
                read[r0:r0 + 4, hs]), "the SSD decode readout of a rank "
                "!= the whole call's")
    checks["ssd_readout_4of8_rows"] = True
    # the split gated norm: mamba2's d_inner 1536 over the model axis
    for rows in (4 * 2048, 4):
        x = torch.randn((rows, 1, 1536), generator=g, device=dev) ** 2
        dl = 1536 // TPM_M
        parts = torch.cat([row_mean_parts(x[..., j * dl:(j + 1) * dl]
                                          .contiguous(), TPM_M)
                           for j in range(TPM_M)], -1)
        require(torch.equal(row_mean_of_parts(parts, 1536), _row_mean(x)),
                f"the split gated norm's mean of {rows} rows != the whole")
        checks[f"gated_norm_{rows}_rows"] = True
    # decode attention on the head_dim layout's value slices
    decode = []
    for where, b, L, h, kv, dh in TPM_DECODE:
        for quant in (None, QuantConfig()):
            q = torch.randn((b, 1, h, dh), generator=g, device=dev)
            k_ = torch.randn((b, L, kv, dh), generator=g, device=dev)
            v = torch.randn((b, L, kv, dh), generator=g, device=dev)
            pos = torch.arange(L, device=dev, dtype=torch.int32).expand(
                b, L).contiguous()
            cache = update_kv_cache(init_kv_cache(
                b, L, kv, dh, torch.float32, quant=quant, device=dev),
                k_, v, pos, quant=quant)
            qpos = torch.full((b,), L - 3, device=dev, dtype=torch.int32)
            kw = dict(l2r=quant, k_planes=cache.k_planes,
                      k_scale=cache.k_scale, kv_whole=kv)
            whole = decode_attention(q, cache.k, cache.v, cache.positions,
                                     qpos, **kw)
            vd = dh // TPM_M
            parts = [cache.v[..., j * vd:(j + 1) * vd].contiguous()
                     for j in range(TPM_M)]
            for j, vj in enumerate(parts):
                got = decode_attention(q, cache.k, vj, cache.positions, qpos,
                                       v_cols=(j * vd, dh), **kw)
                require(torch.equal(got, whole[..., j * vd:(j + 1) * vd]),
                        f"decode attention on value slice {j} at {where} "
                        f"(attn_l2r {quant is not None}) != the whole heads'")
            row = {"name": where, "attn_l2r": quant is not None, "B": b,
                   "L": L, "H": h, "Kv": kv, "dh": dh, "dh_rank": vd,
                   "slices_equal_whole_heads": True,
                   "ms": time_ms(lambda: decode_attention(
                       q, cache.k, parts[0], cache.positions, qpos,
                       v_cols=(0, dh), **kw)),
                   "ms_whole": time_ms(lambda: decode_attention(
                       q, cache.k, cache.v, cache.positions, qpos, **kw))}
            decode.append(row)
            print("phase 21f: " + json.dumps(row), flush=True)
            del q, k_, v, cache, whole, parts
    torch.cuda.empty_cache()
    print("phase 21f: " + json.dumps(checks), flush=True)
    return {"b1": b1, "b5": b5, "decode": decode, "checks": checks}


def tpm_params(dev, cfg, mesh, seed: int):
    """``materialize``'s draw of ``cfg``'s params from a card generator
    seeded ``seed``, a leaf at a time (the whole tree's draws in order),
    each leaf cut to this rank's block at once (sharding/axes.py:
    held_layouts): phase 16's params without the whole tree on the card.
    Returns (params, this rank's bytes, the whole tree's bytes)."""
    from repro_torch.models.common import (materialize, tree_leaves,
                                           tree_unflatten)
    from repro_torch.sharding.axes import _desc, cut_leaf, held_layouts

    desc = _desc(cfg, None)
    g = torch.Generator(device=dev).manual_seed(seed)
    leaves, whole = [], 0
    for p, lay in zip(tree_leaves(desc), held_layouts(cfg, mesh, desc)):
        x = materialize(p, g, device=dev)
        whole += x.numel() * x.element_size()
        leaves.append(cut_leaf(x, lay, mesh))
        del x
    mine = sum(x.numel() * x.element_size() for x in leaves)
    return tree_unflatten(desc, leaves), mine, whole


def tpm_state_bytes(state) -> int:
    from repro_torch.serve.batching import _tensors

    return sum(t.numel() * t.element_size() for t in _tensors(state))


def tpm_mixer(dev, mesh, arch: str, ref16: dict) -> dict:
    """21a-21c on this rank: ``arch`` at full width with phase 16's params
    (seed 160, raw: these families serve raw params) cut to this rank's
    blocks, its rows of phase 16's prompts prefilled and stepped
    TPM_STEPS times greedily: tokens and the prefill's logits bit for bit
    phase 16's, launches per call phase 16's, collectives a call
    split_collectives' plus the head's and the rows' gathers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.l2r_gemm import ops
    from repro_torch.models.encdec import init_encdec_state
    from repro_torch.models.transformer import init_lm_state
    from repro_torch.serve import engine
    from repro_torch.sharding import collectives, ctx
    from repro_torch.sharding.axes import batch_rows, whole_leaves

    spec = MIXERS[arch]
    cfg = dataclasses.replace(get_config(arch), l2r=QuantConfig())
    t0 = time.perf_counter()
    params, mine, whole = tpm_params(dev, cfg, mesh, 160)
    out = {"param_bytes": mine, "param_bytes_one_process": whole,
           "build_s": time.perf_counter() - t0,
           "whole_leaves": whole_leaves(cfg, mesh)}
    torch.cuda.empty_cache()
    batch = mixer_batch(cfg, dev, spec["prompt"], 162)
    axes, r0, n_rows = batch_rows(mesh, MIX_BATCH)
    max_len = spec["prompt"] + MIX_STEPS + 4
    prefill = engine.make_prefill_step(cfg, max_len, torch.float32,
                                       mesh=mesh)
    decode = engine.make_decode_step(cfg, mesh=mesh)
    (b1p, b5p), (b1s, b5s) = spec["prefill"], spec["step"]
    extra = int(cfg.vocab % TPM_M == 0) + int(MESH_SHAPE[0] > 1)
    out.update(calls=[])
    torch.cuda.reset_peak_memory_stats(dev)
    toks = []
    out["audit22"] = []
    with torch.no_grad(), collectives.recording() as records, \
            CollectiveClock(engine, ops) as clock:
        state = tok = None
        for i in range(1 + TPM_STEPS):
            i0 = len(records)
            torch.cuda.synchronize()
            reset_counts()
            collectives.reset()
            c0, t1 = clock.seconds, time.perf_counter()
            with ctx.row_shard(mesh, axes):
                if i == 0:
                    state, logits = prefill(
                        params, {k: v[r0:r0 + n_rows]
                                 for k, v in batch.items()})
                else:
                    state, tok, logits = decode(params, state,
                                                tok[r0:r0 + n_rows])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            if i == 0:
                tok = torch.argmax(logits, -1).to(torch.int32)
                out["prefill_logits_checksum"] = float(tree_checksum(
                    [logits.float()]).item())
                out["prefill_records"] = [r.to_json() for r in records]
            toks.append(tok)
            n = counts()
            want = only(l2r_stacked_gemm=b1p if i == 0 else b1s,
                        flash_attention=b5p if i == 0 else b5s)
            require(n == want, f"21 {arch} call {i}: launches {n}, "
                               f"expected {want}")
            per = dict(engine.split_collectives(
                cfg, params, "prefill" if i == 0 else "decode"))
            per["all_gather"] += extra
            made = dict(collectives.COUNTS)
            require(made == per, f"21 {arch} call {i}: collectives {made}, "
                                 f"derived {per}")
            # every row-parallel product is L2R: integer sums only
            out["audit22"].append(audit_run(records[i0:], per, mesh,
                                            f"21 {arch} call {i}", False))
            out["calls"].append({"ms": ms, "launches": n,
                                 "collectives": made,
                                 "collective_ms": (clock.seconds - c0) * 1e3})
    seqs = torch.cat(toks, 1).tolist()
    out["tokens"] = seqs
    require(seqs == [r[:1 + TPM_STEPS] for r in ref16["tokens"]],
            f"21 {arch}: tokens differ from phase 16's one-process run")
    require(out["prefill_logits_checksum"] == ref16[
        "prefill_logits_checksum"],
        f"21 {arch}: the prefill's last-position logits differ from phase "
        f"16's")
    init = init_encdec_state if cfg.family == "encdec" else init_lm_state
    out["state_bytes"] = tpm_state_bytes(state)
    out["state_bytes_one_process"] = tpm_state_bytes(init(
        cfg, MIX_BATCH, max_len, torch.float32, device="meta"))
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, state
    torch.cuda.empty_cache()
    return out


def tpm_smollm(dev, mesh, ref: dict) -> dict:
    """21d on this rank: phase 13's SmolLM-135M prepared (the head split
    by vocabulary) and cut by ``shard_params`` (model 2 does not divide 3
    kv heads: q, k, v gathered, the head_dim cache layout), the cut of
    15e's requests through ``ContinuousBatcher(state_sharding="specs")``
    against the one-process batcher on the same requests."""
    from repro_torch.kernels.l2r_gemm import ops
    from repro_torch.models.transformer import init_lm_state
    from repro_torch.serve import ContinuousBatcher, engine
    from repro_torch.sharding import collectives
    from repro_torch.sharding.axes import shard_params

    cfg, whole, _ = lm_model(dev, mesh=mesh)
    out = {"backbone_bytes_whole": backbone_bytes(whole)}
    params = shard_params(cfg, whole, mesh)
    del whole
    torch.cuda.empty_cache()
    out["backbone_bytes"] = backbone_bytes(params)
    with torch.no_grad():
        eng = ContinuousBatcher(cfg, params, n_slots=SERVE_SLOTS,
                                max_len=SERVE_MAX_LEN, progressive=True,
                                early_exit=True, device=dev, mesh=mesh,
                                state_sharding="specs")
        out["kv_bytes"] = kv_bytes(eng.state)
        out["kv_bytes_whole"] = kv_bytes(init_lm_state(
            cfg, SERVE_SLOTS, SERVE_MAX_LEN, torch.float32, device="meta"))
        out["kv_heads"] = int(eng.state.stack[0].k.shape[-2])
        out["v_head_dim"] = int(eng.state.stack[0].v.shape[-1])
        reqs = serve_requests(cfg, TPM_MAX_NEW)[:TPM_REQUESTS]
        for r in reqs:
            eng.submit(r)
        reset_counts()
        collectives.reset()
        t0 = time.perf_counter()
        # a data rank walks its own slots' rows: no same-input check
        with collectives.recording() as records, \
                CollectiveClock(ops) as clock, WalkProbe(
                engine, mesh, rows_sharded=None, same_inputs=False) as probe:
            eng.run()
            torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
    out.update(reqs=served(reqs), stats=served_stats(eng),
               launches=counts(), collective_s=clock.seconds,
               collectives=dict(collectives.COUNTS), walks=len(probe.walks))
    st = out["stats"]
    per = {m: engine.split_collectives(cfg, params, m)
           for m in ("prefill", "decode")}
    want = {k: st["prefills"] * per["prefill"][k]
            + st["steps"] * per["decode"][k]
            + sum(w["collectives"][k] for w in probe.walks) for k in per[
                "decode"]}
    out["collectives_want"] = want
    out["split_collectives_per_forward"] = per
    require(out["collectives"] == want,
            f"21d: collectives {out['collectives']}, the code derives {want} "
            f"({st['prefills']} prefills, {st['steps']} steps of {per}, "
            f"{len(probe.walks)} walks)")
    out["audit22"] = {"walks": probe.audited,
                      "run": audit_run(records, want, mesh, "21d", False)}
    require(out["reqs"] == ref["reqs"],
            "21d: tokens or exit levels differ from the one-process batcher")
    require(out["stats"] == ref["stats"],
            "21d: stats differ from the one-process batcher")
    launched = {k: v for k, v in out["launches"].items() if v}
    require(launched == ref["launches"],
            f"21d: launches {launched}, one process {ref['launches']}")
    require(out["kv_heads"] == cfg.n_kv
            and out["v_head_dim"] == cfg.head_dim // TPM_M,
            "21d: the caches are not in the head_dim layout")
    del eng, params
    torch.cuda.empty_cache()
    return out


def tpm_smollm_reference(dev) -> dict:
    """21d's one-process run: the batcher on the same requests."""
    from repro_torch.serve import ContinuousBatcher

    cfg, params, _ = lm_model(dev)
    with torch.no_grad():
        eng = ContinuousBatcher(cfg, params, n_slots=SERVE_SLOTS,
                                max_len=SERVE_MAX_LEN, progressive=True,
                                early_exit=True, device=dev)
        reqs = serve_requests(cfg, TPM_MAX_NEW)[:TPM_REQUESTS]
        for r in reqs:
            eng.submit(r)
        reset_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    out = {"reqs": served(reqs), "stats": served_stats(eng),
           "launches": {k: v for k, v in counts().items() if v},
           "seconds": seconds}
    del eng, params
    torch.cuda.empty_cache()
    return out


def tpm_train(dev, mesh) -> dict:
    """21e on this rank: whisper-base in f32 (seed 210, the stacked
    weights rescaled to their width: models/common.py:fan_in_scaled) split
    over the 2 x 2 mesh (heads over "model", the decoder's sequence
    split between blocks, rows over "data", ZeRO-1), TPM_TRAIN_STEPS
    steps on 8 rows of 128 tokens and 1500 frames; rank 0 then runs the
    same steps in one process: every step's loss and grad norm, and the
    first step's gradients and update (gathered; the update of a leaf
    whose gradient is zero to rounding in both runs aside), within
    TRAIN_B5_TOL."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.device import no_tf32
    from repro_torch.kernels.l2r_gemm import ops
    from repro_torch.models.common import (fan_in_scaled, materialize,
                                           tree_leaves)
    from repro_torch.models.encdec import encdec_build
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.axes import _paths, gather_params, shard_params
    from repro_torch.train import step as ts

    cfg = dataclasses.replace(get_config("whisper-base"),
                              compute_dtype="float32")
    scaled = fan_in_scaled(cfg, materialize(
        encdec_build(cfg), torch.Generator(device=dev).manual_seed(210),
        device=dev))
    g = torch.Generator(device=dev).manual_seed(211)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (8, TPM_TRAIN_SEQ),
                                        generator=g, device=dev,
                                        dtype=torch.int32),
                "labels": torch.randint(0, cfg.vocab, (8, TPM_TRAIN_SEQ),
                                        generator=g, device=dev,
                                        dtype=torch.int32),
                "frames": torch.randn((8, cfg.encoder_seq, cfg.d_model),
                                      generator=g, device=dev)}
               for _ in range(TPM_TRAIN_STEPS)]
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    tcfg = ts.TrainConfig(remat=True, seq_shard=True,
                          xent_chunk=TPM_TRAIN_SEQ)
    zero = ts.zero1_layout(cfg, mesh)
    step = ts.make_train_step(cfg, ocfg, tcfg, mesh)
    params = shard_params(cfg, scaled, mesh)
    run = {"param_bytes": sum(x.numel() * x.element_size()
                              for x in tree_leaves(params)),
           "param_bytes_one_process": sum(x.numel() * x.element_size()
                                          for x in tree_leaves(scaled)),
           "seq_sharded": ts._resid_shard_fn(mesh, tcfg, 8,
                                             TPM_TRAIN_SEQ)[1],
           "losses": [], "grad_norms": [], "step_ms": [], "coll_ms": [],
           "launches": []}
    opt = adamw_init(params, zero)
    run["mv_bytes"] = sum(x.numel() * x.element_size()
                          for x in tree_leaves((opt.m, opt.v)))
    _, _, grads0 = ts.make_grad_fn(cfg, tcfg, mesh)(params, batches[0])
    grads0 = gather_params(cfg, grads0, mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    with CollectiveClock(ts, adamw, ops) as clock:
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            reset_counts()
            c0, t0 = clock.seconds, time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            run["coll_ms"].append((clock.seconds - c0) * 1e3)
            n = counts()
            require(n["flash_attention"] > 0 and n == only(
                flash_attention=n["flash_attention"]),
                f"21e step {i}: launches {n}: B5 and no other expected")
            run["launches"].append(n["flash_attention"])
            run["losses"].append(m["loss"].item())
            run["grad_norms"].append(m["grad_norm"].item())
            same_value_on_every_rank(mesh, torch.stack(
                [m["loss"], m["grad_norm"]]).double(),
                f"21e step {i}: the loss or grad norm")
            if i == 0:
                first = gather_params(cfg, params, mesh)
    run["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, opt
    torch.cuda.empty_cache()
    held = None
    if mesh.rank == 0:
        one = {"losses": [], "grad_norms": [], "launches": []}
        _, _, one_g = ts.make_grad_fn(cfg, tcfg)(scaled, batches[0])
        gn0 = None
        p1, o1 = scaled, adamw_init(scaled)
        one_step = ts.make_train_step(cfg, ocfg, tcfg)
        for i, batch in enumerate(batches):
            reset_counts()
            p1, o1, m1 = one_step(p1, o1, batch)
            one["launches"].append(counts()["flash_attention"])
            one["losses"].append(m1["loss"].item())
            one["grad_norms"].append(m1["grad_norm"].item())
            gn0 = one["grad_norms"][0]
            if i == 0:
                # a leaf whose gradient is zero to rounding in both runs
                # (within the gradient check's atol: whisper's key biases,
                # which softmax does not see) gets +-lr from Adam's first
                # step whatever its noise's sign: its update is not
                # compared, every other leaf's is
                lim = TRAIN_B5_TOL["grad_abs"] * gn0
                zero = [max(a.norm().item(), b.norm().item()) <= lim
                        for a, b in zip(tree_leaves(grads0),
                                        tree_leaves(one_g))]
                paths = [path for path, _ in _paths(encdec_build(cfg))]
                per_leaf = [(tree_close([a - o], [b - o],
                                        TRAIN_B5_TOL["update"]), path)
                            for a, b, o, z, path in zip(
                                tree_leaves(first), tree_leaves(p1),
                                tree_leaves(scaled), zero, paths) if not z]
                update_worst, update_worst_leaf = max(per_leaf)
                zero_grad = [path for path, z in zip(paths, zero) if z]
        held = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(
                    run["losses"], one["losses"])),
                "grad_norm_rel": max(abs(a - b) / abs(b) for a, b in zip(
                    run["grad_norms"], one["grad_norms"])),
                "grad_worst": tree_close(
                    tree_leaves(grads0), tree_leaves(one_g),
                    TRAIN_B5_TOL["grad"], TRAIN_B5_TOL["grad_abs"] * gn0),
                "update_worst": update_worst,
                "update_worst_leaf": update_worst_leaf,
                "zero_grad_leaves": zero_grad,
                "launches_one_process": one["launches"]}
        require(held["loss_rel"] <= TRAIN_B5_TOL["loss"]
                and held["grad_norm_rel"] <= TRAIN_B5_TOL["grad_norm"]
                and held["grad_worst"] <= 1 and held["update_worst"] <= 1
                and one["launches"] == run["launches"],
                f"21e: the split steps and the one-process steps differ on "
                f"the rescaled weights: {held}, launches {run['launches']}")
        del p1, o1, one_g
    run["scaled_vs_one_process"] = held
    del scaled, grads0, first
    torch.cuda.empty_cache()
    return run


def tpm_rank(refs: dict) -> dict:
    """One rank of phase 21's 2 x 2 mesh (run by spawn_local): 21a-21e."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_local_mesh(*MESH_SHAPE)
    out = {"rank": dist.get_rank(), "coords": mesh.coords(),
           "backend": dist.get_backend()}
    jobs = [(arch, lambda a=arch: tpm_mixer(dev, mesh, a, refs[a]))
            for arch in TPM_ARCHS if arch in refs]
    jobs += [("smollm", lambda: tpm_smollm(dev, mesh, refs["smollm"])),
             ("train", lambda: tpm_train(dev, mesh))]
    for key, fn in jobs:
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["seconds_total"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def phase_tp_mixers(dev, mix: dict) -> dict:
    """Phase 21: 21f the kernels and products at the ranks' shapes (first,
    on the card alone), 21d's one-process batcher, then four gloo ranks
    on the 2 x 2 mesh sharing the card: 21a-21c mamba2-130m,
    recurrentgemma-2b and whisper-base split against phase 16, 21d
    SmolLM-135M in the head_dim layout against the one-process batcher,
    21e whisper-base training split against one process."""
    import gc

    from repro_torch.launch.mesh import spawn_local

    gc.collect()
    torch.cuda.empty_cache()
    smi = card()
    t0 = time.perf_counter()
    rows = tpm_kernel_rows(dev)
    archs = [a for a in TPM_ARCHS if a in mix["runs"]]
    refs = {arch: {k: mix["runs"][arch][k] for k in (
        "tokens", "prefill_logits_checksum")} for arch in archs}
    refs["smollm"] = tpm_smollm_reference(dev)
    print(f"phase 21: {MESH_WORLD} ranks on a {MESH_SHAPE[0]} x "
          f"{MESH_SHAPE[1]} (data x model) mesh over gloo, all on the one "
          f"card ({smi}): processes sharing one card, not a multi-GPU "
          f"figure; 21d's one-process batcher "
          f"{refs['smollm']['seconds']:.1f} s", flush=True)
    t1 = time.perf_counter()
    ranks = spawn_local(MESH_WORLD, tpm_rank, refs,
                        deadline_s=TPM_DEADLINE_S)
    t2 = time.perf_counter()
    for r in ranks:
        require(r["backend"] == "gloo", f"rank {r['rank']}: backend "
                                        f"{r['backend']}")
    keep = {arch: ("param_bytes", "param_bytes_one_process", "build_s",
                   "whole_leaves", "calls", "state_bytes",
                   "state_bytes_one_process", "peak_gb", "seconds_total")
            for arch in archs}
    keep["smollm"] = ("seconds", "collective_s", "collectives",
                      "collectives_want", "split_collectives_per_forward",
                      "walks", "launches", "kv_bytes", "kv_bytes_whole",
                      "kv_heads", "v_head_dim", "backbone_bytes",
                      "backbone_bytes_whole", "seconds_total")
    keep["train"] = ("param_bytes", "param_bytes_one_process", "mv_bytes",
                     "seq_sharded", "losses", "grad_norms", "step_ms",
                     "coll_ms", "launches", "peak_gb",
                     "scaled_vs_one_process", "seconds_total")
    out = {"card": smi, "backend": "gloo", "seconds": t2 - t0,
           "ranks_s": t2 - t1,
           "mesh": {"data": MESH_SHAPE[0], "model": MESH_SHAPE[1]},
           "rows": rows, "smollm_one_process": refs["smollm"],
           "per_rank": [{"rank": r["rank"], "coords": r["coords"],
                         **{k: {f: r[k][f] for f in fields}
                            for k, fields in keep.items()}}
                        for r in ranks]}
    print("phase 21: " + json.dumps(out, default=str), flush=True)
    out["audit22"] = {key: [r[key]["audit22"] for r in ranks]
                      for key in [*archs, "smollm"]}
    out["records21"] = {arch: [r[arch]["prefill_records"] for r in ranks]
                        for arch in archs}
    r0 = ranks[0]
    for arch in archs:
        a = r0[arch]
        pre, steps = a["calls"][0], a["calls"][1:]
        print(f"phase 21: {arch} on {MESH_SHAPE[0]} x {MESH_SHAPE[1]}: "
              f"tokens of the {MIXERS[arch]['prompt']}-token prefill and "
              f"{TPM_STEPS} steps and the prefill's logits == phase 16's "
              f"bit for bit on every rank; params {a['param_bytes']} of "
              f"{a['param_bytes_one_process']} bytes a rank, states "
              f"{a['state_bytes']} of {a['state_bytes_one_process']}; "
              f"prefill {pre['ms']:.1f} ms ({pre['collective_ms']:.1f} in "
              f"{sum(pre['collectives'].values())} collectives), a step "
              f"{np.mean([c['ms'] for c in steps]):.1f} ms "
              f"({np.mean([c['collective_ms'] for c in steps]):.1f} in "
              f"collectives); kept whole on every rank: "
              f"{a['whole_leaves'] or 'nothing'}", flush=True)
    d, t = r0["smollm"], r0["train"]
    print(f"phase 21: 21d SmolLM-135M, {TPM_REQUESTS} of 15e's requests "
          f"(<= {TPM_MAX_NEW} new tokens) in the 'specs' layout with the "
          f"head_dim cache ({d['kv_heads']} kv heads, {d['v_head_dim']} of "
          f"64 value dims a rank) == the one-process batcher bit for bit on "
          f"every rank; KV {d['kv_bytes']} of {d['kv_bytes_whole']} bytes, "
          f"backbone {d['backbone_bytes']} of {d['backbone_bytes_whole']}; "
          f"{d['seconds']:.1f} s ({d['collective_s']:.1f} s in "
          f"collectives); 21e whisper-base {TPM_TRAIN_STEPS} split steps "
          f"(sequence split {t['seq_sharded']}) within TRAIN_B5_TOL of one "
          f"process on rescaled weights ({t['scaled_vs_one_process']}), "
          f"{t['launches']} B5 a step a rank; {out['seconds']:.1f} s",
          flush=True)
    return out


AUDIT_NODES = {  # the kernel each cuda entry of the registry launches
    "gemm/stacked/cuda": "l2r_stacked_gemm",
    "gemm/streaming/cuda": "l2r_streaming_gemm",
    "gemm/pairs/cuda": "l2r_pairs_gemm",
}


def audit_exactness_rows(dev) -> tuple[list[dict], dict]:
    """22a: every registered entry but the split ones through the lint's
    exactness pass on the card (the ``cpu`` entries on CPU tensors, the
    ``cuda`` ones on the card with their result against the CPU run), and
    the ``pairs`` schedule on the card as ``gemm/pairs/cuda`` (the
    reference registers pairs on ``jnp`` only; B3 is audited here, not
    registered).  Each cuda run launches its kernel once, seen as one
    node; nothing else launches.  Returns the rows and the launches."""
    import dataclasses

    from repro_torch.analysis import lint, registry
    from repro_torch.analysis.exactness import audit_exactness
    from repro_torch.kernels import _build

    entries = {e.name: e for e in registry.iter_entries()
               if e.sharding is None}
    rows, launched = [], {}
    for name, e in entries.items():
        reset_counts()
        row = lint.pass_exactness([e], "cuda", allow_skips=False)[0]
        rows.append(row)
        n = {k: v for k, v in counts().items() if v}
        want = {AUDIT_NODES[name]: 1} if e.device == "cuda" else {}
        require(row["status"] == "ok", f"22a {name}: {row}")
        require(row["kernel_nodes"] == want == n,
                f"22a {name}: kernel nodes {row['kernel_nodes']}, launches "
                f"{n}, expected {want}")
        require(e.device != "cuda" or row["matches_cpu"],
                f"22a {name}: the card's result differs from the CPU's")
        for k, v in n.items():
            launched[k] = launched.get(k, 0) + v
    pairs = entries["gemm/pairs/cpu"]
    contract = dataclasses.replace(pairs.contract, mode="kernel-int")
    fn, args = pairs.build(device="cuda")
    reset_counts()
    rep = audit_exactness(fn, args, contract, entry="gemm/pairs/cuda")
    n = {k: v for k, v in counts().items() if v}
    cpu_fn, cpu_args = pairs.build(device="cpu")
    same = torch.equal(rep.output.cpu(), cpu_fn(*cpu_args))
    require(rep.ok and same and rep.kernel_nodes == n
            == {"l2r_pairs_gemm": 1},
            f"22a gemm/pairs/cuda: {rep.to_json()}, launches {n}, equal to "
            f"the CPU's: {same}")
    rows.append({"entry": "gemm/pairs/cuda", "device": "cuda",
                 "status": "ok", "matches_cpu": same, **rep.to_json()})
    launched["l2r_pairs_gemm"] = launched.get("l2r_pairs_gemm", 0) + 1
    require(_build.AUDIT is None, "22a: the kernel hook is set after the "
                                  "audits")
    return rows, launched


def phase_audit(dev, serve: dict, mesh: dict, dp: dict, tp: dict,
                tpm: dict) -> dict:
    """Phase 22: the lint's passes (analysis/lint.py) on the card, in this
    process, and the audits the split phases made inside their ranks.
    22a exactness (:func:`audit_exactness_rows`); 22b overflow: every
    entry's digit config and ``audit_registry``'s 20 rows sound; 22c
    15e's gateway (warmup coverage, prefill shapes) and the batchers of
    15e, 19b and 20a (each run's second step taken by the in-place state
    audit); 22d phase 18's walks and the registered split entries on its
    2 x 2 mesh, 20a's and 21d's runs and walks, 20c's and 21a-c's calls,
    each audited against its contract inside its rank.  Nothing is
    caught: each audit raised where it ran."""
    from repro_torch.analysis import lint, registry

    t0 = time.perf_counter()
    smi = card()
    rows, launched = audit_exactness_rows(dev)
    cuda_rows = [r for r in rows if r["device"] == "cuda"]
    print(f"phase 22: 22a exactness ({smi}): {len(rows)} entries, 0 "
          f"violations; on the card " + ", ".join(
              f"{r['entry']} {r['kernel_nodes']} (= the CPU's bits: "
              f"{r['matches_cpu']}, {r['eqns_checked']} ops recorded)"
              for r in cuda_rows) + f"; launches {launched}", flush=True)
    over = lint.pass_overflow(registry.iter_entries())
    bad = [r["entry"] for r in over if r["status"] != "ok"]
    require(not bad, f"22b: unsound {bad}")
    n_cfg = sum(r["entry"].startswith("configs/") for r in over)
    require(n_cfg == 20, f"22b: {n_cfg} audit_registry rows")
    print(f"phase 22: 22b overflow: {len(over)} certificates sound "
          f"({n_cfg} audit_registry rows: 10 archs x (head, attention))",
          flush=True)
    eng = serve["engines"]
    batchers = [eng["audit22_batcher"], *dp["audit22"],
                *(r["batcher"] for r in tp["audit22"]["20a"])]
    require(all(b["ok"] for b in batchers) and eng["audit22_gateway"]["ok"],
            "22c: an engine audit failed")
    gw = eng["audit22_gateway"]
    print(f"phase 22: 22c compiled: 15e gateway warmed {gw['warmed_buckets']}"
          f" + decode, prefill shapes {gw['prefill_shapes']}; batchers (15e, "
          f"19b x {len(dp['audit22'])} ranks, 20a x {len(tp['audit22']['20a'])}"
          f" ranks) kept every state tensor's storage: " + ", ".join(
              f"{b['entry']} {b['in_place']['n_kept']}/"
              f"{b['in_place']['n_leaves']}" for b in batchers), flush=True)
    walks = sum(r["walks_18a"]["walks"] + r["walks_18b"]["walks"]
                for r in mesh["audit22"])
    split = mesh["audit22"][0]["split_entries"]["sharding"]
    runs = [a["run"] for key in ("20a",) for a in tp["audit22"][key]] \
        + [a["run"] for a in tpm["audit22"]["smollm"]]
    calls = [c for a in tp["audit22"]["20c"] for c in a] + [
        c for key, per in tpm["audit22"].items() if key != "smollm"
        for a in per for c in a]
    walks += sum(a["walks"]["walks"] for a in tp["audit22"]["20a"]) + sum(
        a["walks"]["walks"] for a in tpm["audit22"]["smollm"])
    print(f"phase 22: 22d sharding: registered split entries on phase 18's "
          f"2 x 2 mesh " + ", ".join(
              f"{r['entry']} {r['collectives']}" for r in split)
          + f"; {walks} full-width walks (18a, 18b, 20a, 21d on every rank) "
          f"to the consensus contract; {len(runs)} whole runs (20a, 21d) "
          f"and {len(calls)} calls (20c, 21a-c) to their derived counts, "
          f"{sum(c['float_sums'] for c in runs + calls)} float sums (20c's "
          f"router means only); 0 violations", flush=True)
    seconds = time.perf_counter() - t0
    print(f"phase 22: {seconds:.1f} s in this process (22c and 22d ran in "
          f"their phases: phase 18's split entries "
          f"{max(r['split_entries_s'] for r in mesh['audit22']):.1f} s a "
          f"rank)", flush=True)
    return {"launches": launched, "seconds": seconds, "rows": rows}


# ------------------------------------------------------------------ slice 17
# the dry run (src/repro_torch/launch/dryrun.py) held against what the
# card measured in this run (23a), and the nine examples of
# examples/torch/ on the card (23b)
EXAMPLES_DIR = ROOT / "examples" / "torch"
EXAMPLE_KERNELS = {  # example: the kernels it must launch on the card
    "quickstart": ("B1", "B6"),  # act 4's GEMM, act 1's PE array
    "vgg16_inference": ("B1",),
    "progressive_precision": ("B1", "B2", "B5"),  # early exit, scan, prefill
    "progressive_attention": ("B4",),  # the attn_l2r prefills
    "serve_decode": ("B1", "B5"),
    "serve_gateway": ("B1", "B5"),
    "train_smollm": ("B5",),
    "precision_policies": ("B1", "B2", "B5"),
    "exactness_audit": ("B1",),  # the kernel-int entry gemm/stacked/cuda
}
EXAMPLE_ARGS = {"train_smollm": ["--steps", "100"]}  # 300 by default
EXAMPLE_TIMEOUT_S = 600
# an example's main(["--device", "cuda", *its EXAMPLE_ARGS]), imported
# from its directory (so the ranks serve_decode spawns import it by name),
# then the launch counts of this process
EXAMPLE_RUNNER = (
    "import json, sys\n"
    "sys.path[:0] = ['src', sys.argv[1]]\n"
    "__import__(sys.argv[2]).main(['--device', 'cuda', *sys.argv[3:]])\n"
    "from repro_torch.kernels import flash_attention, msdf_ipu\n"
    "from repro_torch.kernels.l2r_gemm import kernel\n"
    "print('launches: ' + json.dumps({**kernel.LAUNCHES, **msdf_ipu.LAUNCHES,"
    " **flash_attention.LAUNCHES}))\n")


def start_examples() -> dict:
    """23b: every example of examples/torch/ started at once, each in a
    process of its own on the card, its output to a temporary file."""
    import tempfile

    procs = {}
    for path in sorted(EXAMPLES_DIR.glob("*.py")):
        log = tempfile.TemporaryFile(mode="w+")
        procs[path.stem] = (time.perf_counter(), log, subprocess.Popen(
            [sys.executable, "-c", EXAMPLE_RUNNER, str(EXAMPLES_DIR),
             path.stem, *EXAMPLE_ARGS.get(path.stem, [])], cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT, text=True))
    require(sorted(procs) == sorted(EXAMPLE_KERNELS),
            f"examples {sorted(procs)}, expected {sorted(EXAMPLE_KERNELS)}")
    return procs


def stop_examples(procs: dict) -> None:
    for _, log, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def finish_examples(procs: dict) -> dict:
    """23b: each example exited 0 within EXAMPLE_TIMEOUT_S and launched
    the kernels it reaches (its seconds: from its start to its exit, or
    to this call where it exited before: 23a runs first); every process
    is stopped before this returns."""
    ids = {name: kid for name, (kid, _, _) in KERNELS.items()}
    ends: dict = {}
    t_end = min(t0 for t0, _, _ in procs.values()) + EXAMPLE_TIMEOUT_S
    try:
        while len(ends) < len(procs) and time.perf_counter() < t_end:
            for name, (t0, _, proc) in procs.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter() - t0
            time.sleep(0.1)
        out, failed = {}, []
        for name, (_, log, proc) in procs.items():
            log.seek(0)
            text = log.read()
            line = [x for x in text.splitlines()
                    if x.startswith("launches: ")]
            launched = {ids[k]: v for k, v in json.loads(
                line[-1][len("launches: "):]).items()} if line else {}
            missing = [k for k in EXAMPLE_KERNELS[name]
                       if not launched.get(k)]
            out[name] = {"exit_code": proc.poll(),
                         "seconds": ends.get(name),
                         "args": EXAMPLE_ARGS.get(name, []),
                         "launches": launched, "missing": missing}
            if proc.poll() != 0 or missing:
                failed.append(name)
                print(f"phase 23b: {name} failed (exit {proc.poll()}, "
                      f"missing {missing}):\n{text[-3000:]}", flush=True)
    finally:
        stop_examples(procs)
    require(not failed, f"23b: examples {failed} failed, ran past "
                        f"{EXAMPLE_TIMEOUT_S} s or did not launch their "
                        f"kernels")
    return out


def dry_lm(lm: dict, train: dict) -> dict:
    """23a, one process: the dry run's meta steps of SmolLM-135M at 13a's
    shapes (the prefill on the prepared params) and 17a's (the training
    step), against the bytes and peaks this run measured."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch import dryrun, graph_analysis
    from repro_torch.launch.roofline import roofline_terms
    from repro_torch.models.common import abstract
    from repro_torch.serve.engine import prepare_params
    from repro_torch.sharding.axes import _desc
    from repro_torch.train.step import TrainConfig

    meta = torch.device("meta")
    cfg = dataclasses.replace(get_config(LM_ARCH), l2r=QuantConfig())
    params = prepare_params(cfg, abstract(_desc(cfg, None)))
    batch = {"tokens": torch.empty((LM_BATCH, LM_PROMPT), dtype=torch.int32,
                                   device=meta)}
    res = dryrun.meta_step(cfg, None, "prefill", params, batch,
                           LM_PROMPT + LM_STEPS, cache_dtype=torch.float32)
    run = lm["run"]
    pred = {"param_bytes": dryrun.tree_bytes(params),
            "state_bytes": dryrun.tree_bytes(res["out"][0])}
    for k, v in pred.items():
        require(v == run[k], f"23a 13a: the dry run's {k} {v}, the card's "
                             f"live tensors {run[k]}")
    peak = pred["param_bytes"] + dryrun.tree_bytes(batch) + \
        res["temp_peak_bytes"]
    rl = roofline_terms(res["flops"], res["bytes_moved"], 0.0, 1, "int8")
    out13 = {**pred, "predicted_peak_bytes": peak,
             "measured_peak_bytes": run["prefill_peak_bytes"],
             "peak_ratio": peak / run["prefill_peak_bytes"],
             "flops": res["flops"], "bytes_moved": res["bytes_moved"],
             "roofline": rl.asdict(), "bound_ms": rl.bound_s * 1e3,
             "prefill_ms": run["prefill_ms"]}

    tcfg = TrainConfig(remat=True, seq_shard=False, xent_chunk=TRAIN_XENT)
    tcfg_cfg = dataclasses.replace(get_config(LM_ARCH),
                                   compute_dtype="float32")
    tparams = abstract(_desc(tcfg_cfg, None))
    tbatch = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                             device=meta) for k in ("tokens", "labels")}
    # metered as eager torch runs it, then captured (24b reads the graph)
    tres = dryrun.meta_step(tcfg_cfg, None, "train", tparams, tbatch,
                            TRAIN_SEQ, tcfg, graph=True)
    # the step's inputs: the params, AdamW's two f32 moments of them and
    # its int32 step count, the batch
    base = dryrun.tree_bytes(tparams) * 3 + 4 + dryrun.tree_bytes(tbatch)
    tpeak = base + tres["temp_peak_bytes"]
    measured = train["run"]["peak_memory_bytes"]
    trl = roofline_terms(tres["flops"], tres["bytes_moved"], 0.0, 1, "f32")
    out17 = {"predicted_peak_bytes": tpeak, "measured_peak_bytes": measured,
             "peak_ratio": tpeak / measured, "flops": tres["flops"],
             "bytes_moved": tres["bytes_moved"], "roofline": trl.asdict(),
             "bound_ms": trl.bound_s * 1e3,
             "warm_step_ms": train["run"]["warm_step_ms"]}
    graph17 = {"records": graph_analysis.to_records(tres["graph"].gm),
               "capture_s": tres["graph"].seconds}
    return {"13a": out13, "17a": out17, "graph17": graph17}


def dry_mesh(tpm: dict) -> dict:
    """23a, phase 21's 2 x 2 mesh: for each rank of mamba2-130m,
    recurrentgemma-2b and whisper-base the dry run's bytes (held_layouts,
    engine.local_state) equal the rank's live params and state, and its
    meta prefill records the rank's collectives one for one."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch import dryrun, graph_analysis
    from repro_torch.launch.mesh import make_shape_mesh
    from repro_torch.models.common import abstract
    from repro_torch.serve.engine import split_collectives
    from repro_torch.sharding.axes import _desc, shard_params

    shape = {"data": MESH_SHAPE[0], "model": MESH_SHAPE[1]}
    out, graphs = {}, {}
    for arch, recs in tpm["records21"].items():
        cfg = dataclasses.replace(get_config(arch), l2r=QuantConfig())
        desc = _desc(cfg, None)
        prompt = MIXERS[arch]["prompt"]
        max_len = prompt + MIX_STEPS + 4
        batch = {"tokens": torch.empty((MIX_BATCH, prompt),
                                       dtype=torch.int32, device="meta")}
        if cfg.family == "encdec":
            batch["frames"] = torch.empty(
                (MIX_BATCH, cfg.encoder_seq, cfg.d_model), device="meta")
        rows = []
        for r in range(MESH_WORLD):
            mesh = make_shape_mesh(shape, r)
            lay = dryrun.layout_bytes(cfg, mesh, desc, "prefill", MIX_BATCH,
                                      max_len, "heads", batch,
                                      param_dtype=torch.float32,
                                      cache_dtype=torch.float32)
            live = next(x[arch] for x in tpm["per_rank"] if x["rank"] == r)
            got = {"param_bytes": lay["params"]["rank"],
                   "state_bytes": lay["state"]["held_rank"]}
            for k, v in got.items():
                require(v == live[k], f"23a {arch} rank {r}: the dry run's "
                                      f"{k} {v}, phase 21's {live[k]}")
            params = shard_params(cfg, abstract(desc), mesh, desc)
            # rank 0's prefill is captured (24c reads its graph): the
            # recorder records the captured run
            res = dryrun.meta_step(cfg, mesh, "prefill", params, batch,
                                   max_len, cache_dtype=torch.float32,
                                   measure=False, graph=r == 0)
            meta_recs = [x.to_json() for x in res["records"]]
            if r == 0:
                want = dict(split_collectives(cfg, params, "prefill"))
                want["all_gather"] += int(cfg.vocab % MESH_SHAPE[1] == 0) \
                    + int(MESH_SHAPE[0] > 1)
                graphs[arch] = {
                    "records": graph_analysis.to_records(res["graph"].gm),
                    "capture_s": res["graph"].seconds,
                    "recorder": meta_recs, "phase21": recs[r],
                    "want": want}
            diff = next(((i, a, b) for i, (a, b) in enumerate(zip(
                meta_recs, recs[r])) if a != b), None)
            require(meta_recs == recs[r],
                    f"23a {arch} rank {r}: the meta prefill's "
                    f"{len(meta_recs)} collectives differ from the "
                    f"{len(recs[r])} phase 21 recorded (first: {diff})")
            rows.append({**got, "collectives": len(meta_recs),
                         "collective_bytes": sum(x["nbytes"]
                                                 for x in meta_recs)})
        out[arch] = rows
    return out, graphs


#: what 23a printed while a meta tensor took each kernel's plain version
#: (an earlier run of this script, NVIDIA H100 80GB HBM3, 700.00 W)
PLAIN_META = {"13a": "predicted peak 3553 MB, bound 638 ms",
              "17a": "predicted peak 7047 MB, bound 615 ms"}


def phase_dryrun(dev, lm: dict, train: dict, tpm: dict) -> dict:
    """Phase 23: 23b's nine examples started on the card, meanwhile 23a
    (the dry run against 13a, 17a and phase 21 of this run), then 23b's
    exits and launch counts."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    smi = card()
    t0 = time.perf_counter()
    procs = start_examples()
    try:
        one = dry_lm(lm, train)
        mesh, graphs = dry_mesh(tpm)
    except BaseException:
        stop_examples(procs)
        raise
    t_a = time.perf_counter() - t0
    a13, a17 = one["13a"], one["17a"]
    print(f"phase 23a: dry run of 13a (SmolLM-135M l2r, batch {LM_BATCH} x "
          f"{LM_PROMPT}): params {a13['param_bytes']} and state "
          f"{a13['state_bytes']} bytes == the live tensors' on {smi}; peak "
          f"predicted {a13['predicted_peak_bytes']} bytes beside the "
          f"prefill's max_memory_allocated {a13['measured_peak_bytes']} "
          f"(ratio {a13['peak_ratio']}); the meta run's bound (eager "
          f"bytes) {a13['bound_ms']} ms ({a13['roofline']['dominant']}) "
          f"beside the measured prefill {a13['prefill_ms']} ms; before the "
          f"kernels were one node each (kernel plain versions on meta): "
          f"{PLAIN_META['13a']}", flush=True)
    print(f"phase 23a: dry run of 17a (SmolLM-135M f32 train step, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}): peak predicted "
          f"{a17['predicted_peak_bytes']} bytes beside "
          f"{a17['measured_peak_bytes']} measured (ratio "
          f"{a17['peak_ratio']}); the meta run's bound (eager bytes) "
          f"{a17['bound_ms']} ms ({a17['roofline']['dominant']}) beside "
          f"the warm step {a17['warm_step_ms']} ms; before: "
          f"{PLAIN_META['17a']}", flush=True)
    for arch, rows in mesh.items():
        print(f"phase 23a: {arch} on the {MESH_SHAPE[0]} x {MESH_SHAPE[1]} "
              f"mesh: every rank's params and state bytes == phase 21's "
              f"({[(x['param_bytes'], x['state_bytes']) for x in rows]}); "
              f"the meta prefill's {rows[0]['collectives']} collectives "
              f"({[x['collective_bytes'] for x in rows]} operand bytes a "
              f"rank) == phase 21's records", flush=True)
    ex = finish_examples(procs)
    seconds = time.perf_counter() - t0
    print("phase 23b: " + json.dumps(ex), flush=True)
    print(f"phase 23b: the nine examples of examples/torch/ exited 0 on "
          f"{smi} and launched the kernels they reach; phase 23: "
          f"{seconds:.1f} s (23a {t_a:.1f} s while 23b ran)", flush=True)
    return {"card": smi, "13a": a13, "17a": a17, "mesh": mesh,
            "examples": ex, "seconds": seconds, "graph17": one["graph17"],
            "graphs21": graphs}


# ------------------------------------------------------------------ slice 18
# the compiled-graph layer: 13a's prefill and decode step captured on the
# card, each kernel one node, replayed bit for bit (24a); the graph
# roofline of both and of 17a's step against this run's device times
# (24b); phase 21's split prefills' collectives as graph nodes (24c)
def clone_tree(tree):
    """``tree`` (a state, a batch) with each tensor cloned."""
    from repro_torch.serve.batching import _map

    return _map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                tree)


def graph_replay(fn, fresh, what: str) -> dict:
    """24a for one step: ``fn(*fresh())`` run eagerly with its launches
    counted, then captured (launch/graph_analysis.py:capture) on another
    ``fresh()`` copy, its kernel nodes equal to the eager launches, then
    the graph replayed on a third copy: every output tensor bit for bit
    the eager run's, with the same launches.  Returns the records and the
    counts."""
    from repro_torch.analysis.exactness import tensors_of
    from repro_torch.launch import graph_analysis as ga

    reset_counts()
    ref = fn(*fresh())
    torch.cuda.synchronize()
    eager = {k: v for k, v in counts().items() if v}
    reset_counts()
    cap = ga.capture(fn, fresh())
    torch.cuda.synchronize()
    traced = {k: v for k, v in counts().items() if v}
    cap.output = None
    records = ga.to_records(cap.gm)
    nodes = ga.kernel_nodes(records)
    require(nodes == eager == traced,
            f"24a {what}: kernel nodes {nodes}, eager launches {eager}, "
            f"launches while captured {traced}")
    reset_counts()
    got = cap(*fresh())
    torch.cuda.synchronize()
    replayed = {k: v for k, v in counts().items() if v}
    require(replayed == eager, f"24a {what}: the replay launched "
                               f"{replayed}, the eager run {eager}")
    a, b = tensors_of(ref), tensors_of(got)
    same = len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))
    require(same, f"24a {what}: the replayed graph's outputs differ from "
                  f"the eager step's")
    del ref, got, cap
    return {"records": records, "kernel_nodes": nodes, "launches": eager,
            "nodes": ga.node_count(records), "outputs": len(a)}


def graph_bound(records: list, measured, host_ms: float, meta_bound,
                what: str) -> dict:
    """24b for one step: its graph's FLOPs (each class at its peak) and
    bytes, the roofline bound, gated to be at most the step's device time
    measured in this run (``measured``; its host time where the profiler
    gave none), beside the meta run's bound of 23a (eager bytes)."""
    from repro_torch.launch import graph_analysis as ga
    from repro_torch.launch.roofline import roofline_terms

    ana = ga.analyze(records)
    rl = roofline_terms(ana["flops"], ana["bytes"], 0.0, 1,
                        flops_by_peak=ana["flops_by_peak"])
    gate = measured if isinstance(measured, float) else host_ms
    row = {"what": what, "flops": ana["flops"],
           "flops_by_peak": ana["flops_by_peak"], "bytes": ana["bytes"],
           "weight_bytes": ana["weight_bytes"], "compute_ms":
           rl.compute_s * 1e3, "memory_ms": rl.memory_s * 1e3,
           "bound_ms": rl.bound_s * 1e3, "dominant": rl.dominant,
           "measured_device_ms": measured, "host_ms": host_ms,
           "gated_against": "device" if isinstance(measured, float)
           else "host", "meta_run_bound_ms": meta_bound,
           "kernel_nodes": ga.kernel_nodes(records),
           "nodes": ga.node_count(records)}
    require(row["bound_ms"] <= gate,
            f"24b {what}: the graph bound {row['bound_ms']} ms exceeds the "
            f"measured {gate} ms: it is no floor")
    return row


def phase_graph(dev, lm: dict, train: dict, dry: dict) -> dict:
    """Phase 24: 24a 13a's prefill and one decode step captured on the
    card and replayed; 24b their graph roofline and 17a's (captured on
    meta in 23a) against this run's device times; 24c phase 21's split
    prefills (rank 0, captured on a mesh of shapes only in 23a): graph
    collectives equal to the recorder's and to phase 21's one for one,
    no violation of analysis/sharding.py:audit_partitioned_graph."""
    import gc

    from repro_torch.analysis.sharding import (ShardingContract,
                                               audit_partitioned_graph)
    from repro_torch.launch import graph_analysis as ga
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    gc.collect()
    torch.cuda.empty_cache()
    smi = card()
    t0 = time.perf_counter()
    cfg, params, _ = lm_model(dev)
    batch = {"tokens": lm_prompt(dev, LM_BATCH, LM_PROMPT, cfg.vocab, 130)}
    prefill = make_prefill_step(cfg, LM_PROMPT + LM_STEPS, torch.float32)
    decode = make_decode_step(cfg)
    with torch.no_grad():
        state, logits = prefill(params, batch)
        tok = torch.argmax(logits, -1).to(torch.int32)
        del logits
        t1 = time.perf_counter()
        pre = graph_replay(prefill, lambda: (params, batch), "13a prefill")
        t2 = time.perf_counter()
        dec = graph_replay(decode, lambda: (params, clone_tree(state), tok),
                           "13a decode step")
        t3 = time.perf_counter()
    del state, params
    torch.cuda.empty_cache()
    for name, g, secs in (("prefill", pre, t2 - t1),
                          ("decode step", dec, t3 - t2)):
        print(f"phase 24a: 13a's {name} (SmolLM-135M l2r, batch "
              f"{LM_BATCH}) captured on {smi}: {g['nodes']} nodes, kernel "
              f"nodes {g['kernel_nodes']} == the eager launches; replayed "
              f"bit for bit ({g['outputs']} output tensors) with the same "
              f"launches; capture, eager run and replay {secs:.1f} s",
              flush=True)

    run = lm["run"]
    rows = [graph_bound(pre["records"], lm["prof_prefill"].get("device_ms"),
                        run["prefill_ms"], dry["13a"]["bound_ms"],
                        "13a prefill"),
            graph_bound(dec["records"], lm["prof_decode"].get("device_ms"),
                        run["decode_ms_per_token"], None, "13a decode step"),
            graph_bound(dry["graph17"]["records"],
                        train["run"]["profile"].get("device_ms"),
                        train["run"]["warm_step_ms"], dry["17a"]["bound_ms"],
                        "17a train step (f32, captured on meta)")]
    for row in rows:
        print(f"phase 24b: {row['what']} on {smi}: graph FLOPs "
              f"{row['flops']} ({row['flops_by_peak']}), bytes "
              f"{row['bytes']}, bound {row['bound_ms']} ms "
              f"({row['dominant']}) <= {row['measured_device_ms']} ms "
              f"measured ({row['gated_against']}); the meta run's bound "
              f"{row['meta_run_bound_ms']} ms", flush=True)

    coll = {}
    for arch, g in dry["graphs21"].items():
        crecs = ga.collective_records(g["records"])
        graph = [ga.recorded(c) for c in crecs]
        require(graph == g["recorder"] == g["phase21"],
                f"24c {arch}: the graph's {len(graph)} collectives, the "
                f"recorder's {len(g['recorder'])}, phase 21's "
                f"{len(g['phase21'])} are not one for one")
        contract = ShardingContract(
            mesh_axes=(("data", MESH_SHAPE[0]), ("model", MESH_SHAPE[1])),
            kinds=tuple(sorted(g["want"].items())))
        violations, _ = audit_partitioned_graph(g["records"], contract,
                                                f"24c {arch}")
        require(not violations, f"24c {arch}: " + "; ".join(
            f"{v.primitive}: {v.reason}" for v in violations))
        coll[arch] = {"collectives": len(graph),
                      "nodes": ga.node_count(g["records"]),
                      "capture_s": g["capture_s"],
                      "wire_bytes": sum(c["wire_bytes"] for c in crecs),
                      "violations": 0}
        print(f"phase 24c: {arch} rank 0 of {MESH_SHAPE[0]} x "
              f"{MESH_SHAPE[1]}: {len(graph)} collective nodes == the "
              f"recorder's == phase 21's one for one, zero violations; "
              f"{coll[arch]['nodes']} nodes captured on meta in "
              f"{g['capture_s']:.1f} s (during 23a)", flush=True)
    seconds = time.perf_counter() - t0
    print(f"phase 24: {seconds:.1f} s (17a's and 24c's captures ran in "
          f"23a: {dry['graph17']['capture_s']:.1f} s and "
          f"{sum(c['capture_s'] for c in coll.values()):.1f} s)",
          flush=True)
    return {"card": smi, "24a": {k: {kk: v for kk, v in g.items()
                                     if kk != "records"}
                                 for k, g in (("prefill", pre),
                                              ("decode", dec))},
            "24b": rows, "24c": coll, "seconds": seconds}


# ------------------------------------------------------------------ slice 19
# a W12A12 VGG-16: phase 3's model with int16 planes (n_bits 12, radix 16:
# D = 3, 5 levels), the int16 entries of B1, B2 and B3 on a model path
W12 = (12, 4)


def w12_kernel_rows(dev) -> dict:
    """25b: B1's int16 entry at each of VGG-16's main-path GEMMs and B3's
    at fc6-fc8, at W12A12 (n_bits 12, radix 16, D = 3, full depth, B as
    the weight cache holds it): bit for bit their plain versions, then
    kernel_ms (back-to-back launches; the conv taps add into out=) and
    device_ms (the profiler's time of the kernel alone) beside the bound
    of the work (kernel.stacked_cost / pairs_cost at n_bits 12:
    four int8 products an int16 product, two bytes an element)."""
    from repro_torch.core.quant import stack_planes_lhs, stack_planes_rhs
    from repro_torch.kernels.l2r_gemm import kernel

    nb, r = W12
    d = nb // r
    g = torch.Generator(device=dev).manual_seed(8)
    rows: dict[str, list] = {"B1": [], "B3": []}
    for sh in main_path_shapes():
        m, k, n, acc = sh["m"], sh["k"], sh["n"], sh["accumulate"]
        a, b = operands(g, dev, m, k, n, nb)
        sa, sb = stack_planes_lhs(a, nb, r), stack_planes_rhs(b, nb, r)
        sbk = k_major(sb)
        got = kernel.l2r_gemm_stacked_planes(sa, sbk, nb, r)
        ref = kernel.l2r_gemm_stacked_planes_plain(sa, sb, nb, r)
        require(torch.equal(got, ref),
                f"25b: B1 int16 != plain at {sh['name']} M={m} K={k} N={n}")
        out = torch.zeros((m, n), dtype=torch.int32, device=dev) \
            if acc else None
        bound_ms, by = cost_bound(*kernel.stacked_cost(
            m, k, n, d, accumulate=bool(acc), n_bits=nb))
        b1 = lambda: kernel.l2r_gemm_stacked_planes(  # noqa: E731
            sa, sbk, nb, r, out=out)
        rows["B1"].append({
            **sh, "kernel_ms": stream_ms(b1), "device_ms": device_ms(b1, "B1"),
            "bound_ms": bound_ms, "bound_by": by,
            "max_abs_err": max_err(got, ref)})
        if sh["name"] in ("fc6", "fc7", "fc8"):
            got = kernel.l2r_gemm_pairs(a, b, nb, r)
            ref = kernel.l2r_gemm_pairs_plain(a, b, nb, r)
            require(torch.equal(got, ref),
                    f"25b: B3 int16 != plain at {sh['name']}")
            bound_ms, by = cost_bound(*kernel.pairs_cost(m, k, n, d,
                                                         n_bits=nb))
            b3 = lambda: kernel.l2r_gemm_pairs(a, b, nb, r)  # noqa: E731
            rows["B3"].append({
                **sh, "accumulate": False, "kernel_ms": stream_ms(b3),
                "device_ms": device_ms(b3, "B3"), "bound_ms": bound_ms,
                "bound_by": by, "max_abs_err": max_err(got, ref)})
        del a, b, sa, sb, sbk, got, ref, out
    torch.cuda.empty_cache()
    out = {}
    for kid, per in (("B1", "forward"), ("B3", "head")):
        for key in ("kernel_ms", "device_ms", "bound_ms"):
            if all(isinstance(x[key], float) for x in rows[kid]):
                out[f"{kid}_{key}_{per}"] = sum(x[key] * x["count"]
                                                for x in rows[kid])
        out[f"{kid}_shapes"] = rows[kid]
    print("phase 25b: " + json.dumps(out), flush=True)
    return out


def phase_w12_vgg(dev, top1_w8: float) -> dict:
    """Phase 25: phase 3's VGG-16 (224x224, batch 8, 1000 classes, the
    same seeded weights and 3 batches) at ``QuantConfig(n_bits=12,
    log2_radix=4)``: ``vgg16_apply`` with 120 B1 launches a forward (the
    int16 entry), bit for bit the same forward on the plain GEMM, top-1
    agreement with the float forward (TF32 off) at least phase 3's W8A8
    one; ``vgg16_classify_progressive`` with the scan (119 B1 + 1 B2 at D =
    3 on fc8) and early exit (119 B1 + one level slab a level run), the
    classes ``argmax(vgg16_apply)``, the scan's logits its bits; the
    pair-schedule FC head (3 B3 launches a head, int16) bit for bit its
    plain version and the stacked schedule.  The reference's guard
    (``L2R_CERTIFY``, default warn) warns that fc6's K overflows int32: the
    warnings are counted as they are shown, not silenced.  Then 25b
    (:func:`w12_kernel_rows`): B1 and B3 at the forward's and the head's
    shapes, each beside its bound."""
    import warnings

    from repro_torch.analysis.overflow import AccumulatorOverflowWarning
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.l2r_gemm import kernel
    from repro_torch.kernels.l2r_gemm.ops import l2r_matmul_f
    from repro_torch.models.cnn import (vgg16_apply, vgg16_build,
                                        vgg16_classify_progressive,
                                        vgg16_quantize_weights)

    t_phase = time.perf_counter()
    cfg = QuantConfig(*W12)
    n_lv = 2 * (W12[0] // W12[1]) - 1
    seen: list[str] = []
    show = warnings.showwarning

    def counted(message, category, *args, **kw):
        if issubclass(category, AccumulatorOverflowWarning):
            seen.append(str(message))
        show(message, category, *args, **kw)

    warnings.showwarning = counted
    try:
        params = vgg16_build(1000, generator=torch.Generator(device=dev)
                             .manual_seed(0), device=dev)
        weights_q = vgg16_quantize_weights(params, cfg)
        require(weights_q["fc6"].q.dtype == torch.int16,
                "W12 weights are not int16 planes")
        gi = torch.Generator(device=dev).manual_seed(1)
        batches = [torch.randn((BATCH, 224, 224, 3), generator=gi,
                               device=dev) for _ in range(3)]

        def fwd(x):
            return vgg16_apply(params, x, l2r=cfg, weights_q=weights_q,
                               device=dev)

        reset_counts()
        logits = [fwd(x) for x in batches]
        torch.cuda.synchronize()
        n = counts()
        require(n == only(l2r_stacked_gemm=120 * len(batches)),
                f"25: launches {n}, expected 120 B1 a forward")
        for lg in logits:
            require(lg.shape == (BATCH, 1000)
                    and bool(torch.isfinite(lg).all()),
                    "25: non-finite or misshapen logits")
        timed = [host_ms(lambda: fwd(x)) / 1e3 for x in batches]
        prof = profile_forward(lambda: fwd(batches[0]))
        require(torch.equal(plain_b1(lambda: fwd(batches[0])), logits[0]),
                "25: W12 logits differ from the plain-GEMM forward")
        flt = torch.cat([vgg16_apply(params, x, device=dev)
                         for x in batches])
        top1 = (flt.argmax(-1) == torch.cat(logits).argmax(-1)).float() \
            .mean().item()
        require(top1 >= top1_w8, f"25: top-1 agreement with the float "
                f"forward {top1} below W8A8's {top1_w8}")

        run = {}
        for early_exit in (False, True):
            reset_counts()
            outs = [vgg16_classify_progressive(params, x, cfg, weights_q,
                                               early_exit=early_exit,
                                               device=dev)
                    for x in batches]
            torch.cuda.synchronize()
            run[early_exit] = (outs, counts())
        (scan, n_scan), (early, n_early) = run[False], run[True]
        b = len(batches)
        require(n_scan == only(l2r_stacked_gemm=119 * b,
                               l2r_streaming_gemm=b),
                f"25: scan launches {n_scan}, expected 119 B1 + 1 B2")
        levels_run = [int(lv.max()) + 1 for _, lv, _ in scan]
        require(n_early == only(l2r_stacked_gemm=119 * b + sum(levels_run)),
                f"25: early-exit launches {n_early}, levels run "
                f"{levels_run}")
        for (p_s, lv_s, lg_s), (p_e, lv_e, _), ref in zip(scan, early,
                                                          logits):
            require(torch.equal(p_s, ref.argmax(-1).to(torch.int32)),
                    "25: progressive class != argmax(vgg16_apply)")
            require(torch.equal(lg_s, ref),
                    "25: scan logits differ from vgg16_apply's")
            require(torch.equal(p_s, p_e) and torch.equal(lv_s, lv_e),
                    "25: classes or exit levels differ between scan and "
                    "early exit")
        lv_all = torch.cat([lv for _, lv, _ in scan]).cpu()

        gf = torch.Generator(device=dev).manual_seed(4)
        feats = [torch.relu(torch.randn((BATCH, 25088), generator=gf,
                                        device=dev)) for _ in range(3)]

        def head(x, schedule):
            for name in ("fc6", "fc7", "fc8"):
                x = l2r_matmul_f(x, None, cfg, w_q=weights_q[name],
                                 schedule=schedule) + params[name]["b"]
                x = torch.relu(x) if name != "fc8" else x
            return x

        reset_counts()
        heads = [head(x, "pairs") for x in feats]
        torch.cuda.synchronize()
        n_pairs = counts()
        require(n_pairs == only(l2r_pairs_gemm=3 * len(feats)),
                f"25: pairs-head launches {n_pairs}, expected 3 B3 a head")
        fast = kernel.l2r_gemm_pairs
        kernel.l2r_gemm_pairs = kernel.l2r_gemm_pairs_plain
        try:
            plain_heads = [head(x, "pairs") for x in feats]
        finally:
            kernel.l2r_gemm_pairs = fast
        for x, lg, pl in zip(feats, heads, plain_heads):
            require(torch.equal(lg, pl), "25: B3 head != its plain version")
            require(torch.equal(lg, head(x, "stacked")),
                    "25: pairs-schedule head != stacked-schedule head")
        head_ms = statistics.median(host_ms(lambda: head(x, "pairs"))
                                    for x in feats)
    finally:
        warnings.showwarning = show
    require(any(re.search(r" k=25088\b", m) for m in seen),
            f"25: no int32 overflow warning at fc6's K ({len(seen)} shown)")
    rows = w12_kernel_rows(dev)
    out = {"config": {"n_bits": W12[0], "log2_radix": W12[1],
                      "levels": n_lv},
           "launches": n["l2r_stacked_gemm"], "forward_s": timed,
           "images_per_s": BATCH / statistics.median(timed),
           "top1_agreement_vs_float": top1, "top1_w8a8_phase3": top1_w8,
           "plain_gemm_forward_bit_identical": True, "profile": prof,
           "launches_scan": n_scan, "launches_early_exit": n_early,
           "levels_run_early_exit": levels_run,
           "exit_level_hist": torch.bincount(
               lv_all.to(torch.int64), minlength=n_lv).tolist(),
           "pred_equals_argmax_vgg16_apply": True,
           "scan_logits_bit_identical_to_vgg16_apply": True,
           "pairs_launches": n_pairs, "pairs_head_ms": head_ms,
           "pairs_head_bit_identical_to_plain_and_stacked": True,
           "overflow_warnings": len(seen),
           "overflow_warning_ks": sorted({int(k.group(1)) for k in (
               re.search(r" k=(\d+)", m) for m in seen) if k}),
           **rows, "seconds": time.perf_counter() - t_phase}
    print("phase 25: " + json.dumps(out), flush=True)
    return out


def tpm_summary(tpm: dict, lib: str) -> dict:
    """Kernel ``lib``'s launches on each rank of phase 21 and its rows at
    the ranks' shapes."""
    key = {"l2r_stacked_gemm": "b1", "flash_attention": "b5"}.get(lib)
    return {"per": f"phase 21: {MESH_WORLD} ranks on a {MESH_SHAPE[0]} x "
                   f"{MESH_SHAPE[1]} mesh over gloo on one card: 21a-21c "
                   f"over the prefill and {TPM_STEPS} steps, 21d over the "
                   f"batcher run, 21e over {TPM_TRAIN_STEPS} train steps; "
                   f"launches per rank",
            "card": tpm["card"],
            "shapes": tpm["rows"][key] if key else [],
            "per_rank": [{"rank": r["rank"], **{
                arch: sum(c["launches"][lib] for c in r[arch]["calls"])
                for arch in TPM_ARCHS if arch in r},
                "smollm": r["smollm"]["launches"][lib],
                "train": sum(r["train"]["launches"])
                if lib == "flash_attention" else 0}
                for r in tpm["per_rank"]]}


def dp_summary(dp: dict, lib: str) -> dict:
    """Kernel ``lib``'s launches on each rank of phase 19 and its rows at
    the ranks' shapes."""
    key = {"l2r_stacked_gemm": "b1", "l2r_streaming_gemm": "b2",
           "flash_attention": "b5"}[lib]
    out = {"per": f"phase 19: {MESH_WORLD} ranks on a {MESH_SHAPE[0]} x "
                  f"{MESH_SHAPE[1]} mesh over gloo on one card; launches per "
                  f"rank: 19a over {DP_STEPS} train steps, 19b over the "
                  f"batcher run, 19c over the prefill and "
                  f"{DP_DECODE_STEPS} steps",
           "card": dp["card"], "shapes": dp["rows"][key], "per_rank": []}
    for r in dp["per_rank"]:
        out["per_rank"].append({
            "rank": r["rank"],
            "train": sum(r["train"]["launches"])
            if lib == "flash_attention" else 0,
            "batcher": r["batcher"]["launches"][lib],
            "moe": sum(c["launches"][lib] for c in r["moe"]["calls"])})
    return out


def kernel_routes(wide: dict, b5_wide: list, b4_wide: list, w12: dict,
                  mix: dict) -> dict:
    """Each kernel's routes for the kernels line: the C entry, the domain
    it takes, and the rows and launches this run measured on it (the
    int8 / dh <= 128 routes are the kernel record's own rows)."""
    fc8 = [r for r in wide["B1"] if r["n_bits"] > 8]
    rg = mix["runs"][PLAIN_LOOP_ARCH]
    return {
        "B1": [{"entry": "l2r_stacked_gemm", "takes": "int8 planes, D <= 8",
                "on": "mma.sync s8"},
               {"entry": "l2r_stacked_gemm16",
                "takes": "int16 planes (n_bits 9-16), D <= 16",
                "on": "mma.sync s8 / u8, the byte split (l2r_gemm16.cuh)",
                "launches_phase25": w12["launches"],
                "images_per_s_phase25": w12["images_per_s"],
                "device_ms_phase25_forward": w12["profile"].get("B1_ms"),
                "kernel_ms_phase25_forward": w12["B1_kernel_ms_forward"],
                "device_ms_phase25_shapes": w12.get("B1_device_ms_forward"),
                "bound_ms_phase25_forward": w12["B1_bound_ms_forward"],
                "shapes": fc8, "shapes_phase25": w12["B1_shapes"]}],
        "B2": [{"entry": "l2r_streaming_gemm", "takes": "int8 planes, D 1-8",
                "on": "mma.sync s8",
                "shapes": [r for r in wide["B2"] if r["n_bits"] <= 8]},
               {"entry": "l2r_streaming_gemm16",
                "takes": "int16 planes (n_bits 9-16), D <= 16",
                "on": "CUDA cores (l2r_int16.cuh)",
                "launches_phase25": w12["launches_scan"]["l2r_streaming_gemm"],
                "shapes": [r for r in wide["B2"] if r["n_bits"] > 8]}],
        "B3": [{"entry": "l2r_pairs_gemm", "takes": "int8 operands",
                "on": "mma.sync s8"},
               {"entry": "l2r_pairs_gemm16",
                "takes": "int16 operands (n_bits 9-16)",
                "on": "mma.sync s8 / u8, the byte split (l2r_gemm16.cuh)",
                "launches_phase25": w12["pairs_launches"]["l2r_pairs_gemm"],
                "head_ms_phase25": w12["pairs_head_ms"],
                "kernel_ms_phase25_head": w12["B3_kernel_ms_head"],
                "device_ms_phase25_shapes": w12.get("B3_device_ms_head"),
                "bound_ms_phase25_head": w12["B3_bound_ms_head"],
                "shapes": [r for r in wide["B3"] if r["n_bits"] > 8],
                "shapes_phase25": w12["B3_shapes"]}],
        "B4": [{"entry": "flash_attention_l2r",
                "takes": "int8 q, k, dh <= 128", "on": "mma.sync s8"},
               {"entry": "flash_attention_l2r_wide",
                "takes": "int16 q, k at any dh; int8 q, k at dh > 128",
                "on": "wide layout (8 warps, each score once), QK^T on "
                      "mma.sync s8 (int16: byte split), f32 PV 3xTF32",
                "shapes": b4_wide}],
        "B5": [{"entry": "flash_attention", "takes": "dh <= 128",
                "on": "head tiles 16-128"},
               {"entry": "flash_attention (dh > 128)", "takes": "dh > 128",
                "on": "wide layout (flash_wide_kernel, each score once): "
                      "bf16 QK^T d-order FMAs, f32 both products 3xTF32",
                "launches_phase16_prefill": MIXERS[PLAIN_LOOP_ARCH][
                    "prefill"][1],
                "device_ms_phase16_prefill": rg["prof_prefill"].get(
                    "B5_ms"),
                "prefill_device_ms": rg["prof_prefill"].get("device_ms"),
                "prefill_device_ms_plain_loop": rg[
                    "prof_prefill_plain_loop"].get("device_ms"),
                "shapes": b5_wide}],
    }


def kernel_entry(lib: str, rows: list[dict], launches: int, per: str,
                 weight=lambda r: r["count"], **extra) -> dict:
    """The JSON record of one kernel: times per run of its main path (the
    per-shape medians weighted by the launches per run)."""
    kid, source, replaces = KERNELS[lib]
    tot = lambda key: sum(r[key] * weight(r) for r in rows)  # noqa: E731
    if all("kernel_ms" in r for r in rows):  # back-to-back launches
        extra = {"kernel_ms": tot("kernel_ms"), **extra}
    if all(isinstance(r.get("device_ms"), float) for r in rows):
        extra = {"device_ms": tot("device_ms"), **extra}  # the profiler's
    ops_ms = sum(r["bound_ms"] * weight(r) for r in rows
                 if r["bound_by"] == "operations")
    return {"name": lib, "id": kid, "route": "cuda",
            "source": source, "replaces": replaces,
            "checked": True, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "operations" if ops_ms >= tot("bound_ms") / 2
            else "bytes",
            "library_ms": tot("library_ms"), "per": per, **extra,
            "shapes": rows}



def mixer_summary(mix: dict, kid: str, lib: str) -> dict:
    """Per phase 16 model: kernel ``kid``'s launches over the serving run
    (the prefill and MIX_STEPS decode steps), per prefill and step, and
    its device ms in the profiled prefill and decode step."""
    out = {"per": f"phase 16a: each model served at batch {MIX_BATCH}, a "
                  f"prefill and {MIX_STEPS} decode steps"}
    for arch, run in mix["runs"].items():
        i = 0 if kid == "B1" else 1
        out[arch] = {"launches": run["launches"][lib],
                     "per_prefill": MIXERS[arch]["prefill"][i],
                     "per_decode_step": MIXERS[arch]["step"][i],
                     "device_ms_prefill": run["prof_prefill"].get(
                         f"{kid}_ms"),
                     "device_ms_decode_step": run["prof_decode"].get(
                         f"{kid}_ms"),
                     "prefill_ms": run["prefill_ms"],
                     "decode_ms_per_token": run["decode_ms_per_token"]}
    return out


def ptxas_kernel(line: str) -> str | None:
    """The kernel a ptxas -v "Compiling entry function" line names, with
    its template arguments: '_ZN<ns>12flash_kernelI13__nv_bfloat16Li64EE
    Ev...' -> 'flash_kernel<bf16 64>' (int8_t / int16_t as s8 / s16)."""
    m = re.search(r"entry function '_ZN(\w+)'", line)
    if not m:
        return None
    rest, name = m.group(1), "?"
    while rest[:1].isdigit():  # the nested names, each length-prefixed
        digits = re.match(r"\d+", rest).group()
        n = int(digits)
        name, rest = rest[len(digits):len(digits) + n], rest[len(digits) + n:]
    args = rest[1:rest.find("EEv")] if rest.startswith("I") else ""
    args = re.sub(r"\d+__nv_bfloat16", "bf16 ", args)
    args = re.sub(r"L[ib](\d+)E?", r"\1 ", args)
    args = re.sub(r"^f", "f32 ", args).strip()
    args = " ".join({"a": "s8", "s": "s16"}.get(x, x) for x in args.split())
    return f"{name}<{args}>" if args else name


def decode_profiles(dev) -> dict:
    """The device profile of one decode step of 13a (SmolLM-135M l2r),
    14a (with attn_l2r) and 15a (the progressive scan), each on a fresh
    prefill of its phase's prompts, profiled as its phase does."""
    import dataclasses

    from repro_torch.core.quant import QuantConfig
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg, params, _ = lm_model(dev)
    out = {}
    for name, seed, c, progressive in (
            ("13a", 130, cfg, False),
            ("14a", 140, dataclasses.replace(cfg, attn_l2r=QuantConfig()),
             False),
            ("15a", 130, cfg, True)):
        batch = {"tokens": lm_prompt(dev, LM_BATCH, LM_PROMPT, c.vocab,
                                     seed)}
        with torch.no_grad():
            res = make_prefill_step(c, LM_PROMPT + LM_STEPS, torch.float32,
                                    progressive=progressive)(params, batch)
            state, tok = res[0], res[2] if progressive else \
                torch.argmax(res[1], -1).to(torch.int32)
            decode = make_decode_step(c, progressive=progressive)
            out[name] = profile_forward(lambda: decode(params, state, tok))
            del state, res
        torch.cuda.empty_cache()
    return out


def hot_path(dev) -> dict:
    """The serving hot path with no audit active, as phases 13a and 15e
    run it: one decode step of 13a profiled (:func:`profile_forward`:
    device ms and device events), and 15e's batcher over its requests,
    served four times (the first run warms, the others are timed:
    tokens/s).
    Copied into an older checkout it measures that one."""
    from repro_torch.serve import ContinuousBatcher
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg, params, _ = lm_model(dev)
    batch = {"tokens": lm_prompt(dev, LM_BATCH, LM_PROMPT, cfg.vocab, 130)}
    with torch.no_grad():
        state, logits = make_prefill_step(cfg, LM_PROMPT + LM_STEPS,
                                          torch.float32)(params, batch)
        tok = torch.argmax(logits, -1).to(torch.int32)
        decode = make_decode_step(cfg)
        out = {"13a_decode_step": profile_forward(
            lambda: decode(params, state, tok))}
        del state, logits
        torch.cuda.empty_cache()
        runs = []
        for _ in range(4):
            eng = ContinuousBatcher(cfg, params, n_slots=SERVE_SLOTS,
                                    max_len=SERVE_MAX_LEN, progressive=True,
                                    early_exit=True, device=dev)
            reqs = serve_requests(cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            tokens = sum(len(r.output) for r in reqs)
            runs.append({"tokens": tokens, "seconds": seconds,
                         "tokens_per_s": tokens / seconds})
            del eng
            torch.cuda.empty_cache()
    out["15e_batcher"] = runs
    return out


def mixer_profile(dev, arch: str) -> dict:
    """The device profiles of phase 16's ``arch`` in one process: its
    prefill of seed 162's prompts and one decode step after it, set up as
    phase 16 sets them up."""
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg, params = mixer_model(dev, arch)
    prompt = MIXERS[arch]["prompt"]
    batch = mixer_batch(cfg, dev, prompt, 162)
    prefill = make_prefill_step(cfg, prompt + 8, torch.float32)
    decode = make_decode_step(cfg)
    keep = ("device_ms", "B1_ms", "B5_ms", "other_ms", "idle_share",
            "device_events")
    with torch.no_grad():
        state, logits = prefill(params, batch)
        tok = torch.argmax(logits, -1).to(torch.int32)
        state, tok, _ = decode(params, state, tok)
        prof_d = profile_forward(lambda: decode(params, state, tok))
        prof_p = profile_forward(lambda: prefill(params, batch))
    return {"arch": arch, "decode": {k: prof_d.get(k) for k in keep},
            "prefill": {k: prof_p.get(k) for k in keep}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = card()
    if sys.argv[1:] == ["--decode-profile"]:
        _build.build_all()
        print("decode profiles: " + json.dumps(
            {"card": smi, "src": str(ROOT / "src"),
             **decode_profiles(dev)}), flush=True)
        return 0
    if sys.argv[1:] == ["--hot-path"]:
        _build.build_all()
        print("hot path: " + json.dumps(
            {"card": smi, "src": str(ROOT / "src"), **hot_path(dev)}),
            flush=True)
        return 0
    if sys.argv[1:] == ["--int16"]:
        _build.build_all()
        print("int16: " + json.dumps(
            {"card": smi, "src": str(ROOT / "src"),
             "wide": phase_wide_rows(dev),
             "w12": phase_w12_vgg(dev, top1_w8=0.0)}), flush=True)
        return 0
    if sys.argv[1:2] == ["--mixer-profile"] and len(sys.argv) == 3:
        _build.build_all()
        print("mixer profile: " + json.dumps(
            {"card": smi, "src": str(ROOT / "src"),
             **mixer_profile(dev, sys.argv[2])}), flush=True)
        return 0
    print(f"phase 1: card: {smi}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            kernel = "?"
            for line in log.read_text().splitlines():
                kernel = ptxas_kernel(line) or kernel
                if "registers" in line or "spill" in line:
                    print(f"phase 1: ptxas {lib.stem} {kernel}: "
                          f"{line.strip()}", flush=True)

    b1_rows = phase_kernel(dev)
    b2_rows = phase_streaming(dev)
    b3_rows = phase_pairs(dev)
    phase_wrapper_host(dev)
    wide = phase_wide_rows(dev)
    vgg = phase_vgg(dev)
    prog = phase_progressive(dev, vgg)
    pairs = phase_pairs_path(dev, vgg)
    phase_protohead(dev)
    phase_conv_progressive(dev, vgg)
    b1_launches, b1_images_per_s = vgg["launches"], vgg["images_per_s"]
    top1_w8 = vgg["top1_agreement_vs_float"]
    del vgg  # the VGG-16 weights and batches: room for phase 8's operands
    torch.cuda.empty_cache()
    b6 = phase_cipu(dev)
    phase_golden(dev)
    b5 = phase_attention(dev, l2r=False)
    b5_wide = phase_attention_wide(dev, l2r=False)
    b4 = phase_attention(dev, l2r=True)
    b4_wide = phase_attention_wide(dev, l2r=True)
    phase_resize(dev)
    lm = phase_lm(dev)
    lm_attn = phase_lm_attn(dev, b4["rows"])
    serve = phase_serve(dev, lm)
    mix = phase_mixers(dev)
    train = phase_train(dev)
    mesh = phase_mesh(dev, prog, serve)
    dp = phase_dp(dev, train, serve)
    tp = phase_tp(dev, train, serve, mix)
    tpm = phase_tp_mixers(dev, mix)
    audit = phase_audit(dev, serve, mesh, dp, tp, tpm)
    dry = phase_dryrun(dev, lm, train, tpm)
    phase_graph(dev, lm, train, dry)
    del dry
    w12 = phase_w12_vgg(dev, top1_w8)
    routes = kernel_routes(wide, b5_wide, b4_wide, w12, mix)
    bwd = lambda kid: [r for r in train["rows"]  # noqa: E731
                       if r["name"].endswith(kid)]
    del lm["step_logits"]
    head = next(r for r in serve["rows"] if r["count"])
    lm_dec = lm_totals(lm["rows"], ("decode", "head"))
    lm_pre = lm_totals(lm["rows"], ("prefill", "head"))
    bf16_row = next(r for r in b5["rows"] if r["name"] == "causal_bf16")
    lm_b5 = {key: bf16_row[key] * B5_PER_PREFILL
             for key in ("ms", "kernel_ms", "plain_ms", "library_ms",
                         "bound_ms")}

    fc8 = lambda r: 1 if r["name"] == "fc8" else 0  # noqa: E731
    fc = lambda r: 1 if r["name"] in ("fc6", "fc7", "fc8") else 0  # noqa
    print(json.dumps({"kernels": [
        kernel_entry("l2r_stacked_gemm", b1_rows, b1_launches,
                     f"one vgg16_apply forward at batch {BATCH} (sum over "
                     f"its 120 launches of the per-shape medians; kernel_ms "
                     f"from back-to-back launches); launches over the 3 "
                     f"forwards of phase 3",
                     images_per_s=b1_images_per_s,
                     lm_launches=lm["run"]["launches"]["l2r_stacked_gemm"],
                     lm_per=f"phase 13: SmolLM-135M l2r served at batch "
                     f"{LM_BATCH}: one {LM_PROMPT}-token prefill and one "
                     f"decode step, {B1_PER_STEP} launches each (sums over "
                     f"them of the per-shape medians of 13d); lm_launches "
                     f"over the prefill and {LM_STEPS} decode steps of 13a",
                     lm={"decode_step": lm_dec, "prefill": lm_pre,
                         "prefill_ms": lm["run"]["prefill_ms"],
                         "decode_ms_per_token":
                         lm["run"]["decode_ms_per_token"],
                         "device_ms_decode_step":
                         lm["prof_decode"].get("B1_ms"),
                         "device_ms_prefill": lm["prof_prefill"].get("B1_ms"),
                         "shapes": lm["rows"]},
                     lm_progressive={
                         "per": f"phase 15a/15b: the same model served "
                         f"progressively, {B1_DENSE} launches a prefill or "
                         f"decode step with the scan (the head on B2), plus "
                         f"one per level walked with early exit",
                         "launches_scan": serve["run"]["launches"][
                             "l2r_stacked_gemm"],
                         "launches_early_exit": serve["early"]["launches"][
                             "l2r_stacked_gemm"],
                         "decode_ms_per_token": serve["run"][
                             "decode_ms_per_token"],
                         "device_ms_decode_step":
                         serve["prof_decode"].get("B1_ms")},
                     mixers=mixer_summary(mix, "B1", "l2r_stacked_gemm"),
                     mixer_shapes=mix["b1_rows"],
                     mesh=mesh_summary(mesh, "l2r_stacked_gemm"),
                     dp=dp_summary(dp, "l2r_stacked_gemm"),
                     tp=tp_summary(tp, "l2r_stacked_gemm"),
                     tp_mixers=tpm_summary(tpm, "l2r_stacked_gemm"),
                     audit_launches=audit["launches"].get(
                         "l2r_stacked_gemm", 0),
                     routes=routes["B1"]),
        kernel_entry("l2r_streaming_gemm", b2_rows,
                     prog["launches_scan"]["l2r_streaming_gemm"],
                     f"one vgg16_classify_progressive scan forward at batch "
                     f"{BATCH} (its one launch, the fc8 head); launches over "
                     f"the 3 forwards of phase 4", weight=fc8,
                     images_per_s=prog["scan_images_per_s"],
                     lm_launches=serve["run"]["launches"][
                         "l2r_streaming_gemm"],
                     lm_per=f"phase 15: the SmolLM-135M head streamed at "
                     f"batch {LM_BATCH} (M={LM_BATCH}, K={LM_HEAD[0]}, "
                     f"N={LM_HEAD[1]}, full depth), one launch a progressive "
                     f"prefill and decode step; lm_launches over the prefill "
                     f"and {LM_STEPS} decode steps of 15a",
                     lm={"head_step": {key: head[key] for key in (
                         "ms", "kernel_ms", "device_ms", "plain_ms",
                         "library_ms", "bound_ms", "bound_by")},
                         "device_ms_decode_step":
                         serve["prof_decode"].get("B2_ms"),
                         "decode_ms_per_token":
                         serve["run"]["decode_ms_per_token"],
                         "shapes": serve["rows"]},
                     mesh=mesh_summary(mesh, "l2r_streaming_gemm"),
                     dp=dp_summary(dp, "l2r_streaming_gemm"),
                     tp=tp_summary(tp, "l2r_streaming_gemm"),
                     tp_mixers=tpm_summary(tpm, "l2r_streaming_gemm"),
                     audit_launches=audit["launches"].get(
                         "l2r_streaming_gemm", 0),
                     routes=routes["B2"]),
        kernel_entry("l2r_pairs_gemm", b3_rows,
                     pairs["launches"]["l2r_pairs_gemm"],
                     f"one pair-schedule FC head (fc6-fc8) at batch {BATCH} "
                     f"(its 3 launches); launches over the 3 heads of "
                     f"phase 5", weight=fc,
                     audit_launches=audit["launches"].get(
                         "l2r_pairs_gemm", 0),
                     routes=routes["B3"]),
        kernel_entry("flash_attention_l2r", b4["rows"], b4["launches"],
                     "the three SmolLM-135M attention calls of phase 11b "
                     "(B=8, S=2048: causal f32, causal bf16, window 512 "
                     "f32), full depth; ms is the wrapper (quantization "
                     "included), kernel_ms the launch alone; library_ms is "
                     "scaled_dot_product_attention on the dequantized q, k",
                     lm_launches=lm_attn["run"]["launches"][
                         "flash_attention_l2r"],
                     lm_per=f"phase 14: the {B4_PER_PREFILL} attention "
                     f"calls of one SmolLM-135M prefill with attn_l2r "
                     f"(batch {LM_BATCH}, {LM_PROMPT} tokens, causal bf16, "
                     f"full depth): {B4_PER_PREFILL} x the causal_bf16 row "
                     f"of 11b, the same shape",
                     lm={"prefill": lm_attn["lm_b4"],
                         "device_ms_prefill":
                         lm_attn["prof_prefill"].get("B4_ms"),
                         "prefill_ms": lm_attn["run"]["prefill_ms"],
                         "decode_ms_per_token":
                         lm_attn["run"]["decode_ms_per_token"],
                         **lm_attn["b4"]},
                     train_backward=bwd("B4"), routes=routes["B4"]),
        kernel_entry("flash_attention", b5["rows"], b5["launches"],
                     "the three SmolLM-135M attention calls of phase 10b "
                     "(B=8, S=2048: causal f32, causal bf16, window 512 "
                     "f32) through ops.flash_attention; kernel_ms from "
                     "back-to-back calls; library_ms is "
                     "scaled_dot_product_attention",
                     lm_launches=lm["run"]["launches"]["flash_attention"],
                     lm_per=f"phase 13: the {B5_PER_PREFILL} attention "
                     f"calls of one SmolLM-135M prefill (batch {LM_BATCH}, "
                     f"{LM_PROMPT} tokens, causal bf16): {B5_PER_PREFILL} x "
                     f"the causal_bf16 row of 10b, the same shape",
                     lm={"prefill": lm_b5,
                         "device_ms_prefill": lm["prof_prefill"].get("B5_ms"),
                         "launches_progressive": serve["run"]["launches"][
                             "flash_attention"],
                         **lm["b5"]},
                     mixers=mixer_summary(mix, "B5", "flash_attention"),
                     mixer_shapes=mix["b5_rows"],
                     train=train["train"], train_backward=bwd("B5"),
                     dp=dp_summary(dp, "flash_attention"),
                     tp=tp_summary(tp, "flash_attention"),
                     tp_mixers=tpm_summary(tpm, "flash_attention"),
                     routes=routes["B5"]),
        kernel_entry("cipu_array", b6["rows"], b6["launches"],
                     "one simulate_pe_array call over conv4_2's 25,690,112 "
                     "SOP windows (k=72, n=8, int32 operands); library_ms "
                     "is (a*b).sum(-1)",
                     routes=[{"route": "the whole domain (n within int32)",
                              "entry": "cipu_array"}]),
    ]}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
