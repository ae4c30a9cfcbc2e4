#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--generations N] [--seed S] [--phases P,...]

Phases, one JSON object per line on standard output:

1. ``device``  — the card (``nvidia-smi`` name and power limit, torch's
   device name and count).
2. ``build``   — first-use build of every CUDA kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, run together), with
   ptxas' register and shared-memory report.
3. ``kernel``  — one line per kernel and shape: each kernel's wrapper on
   card tensors against its plain PyTorch version on the same inputs
   (population_lut and lut_matmul byte-equal; rank_k, all nine slot
   groups of a variant in one launch and one group at 1024^3, within
   rtol 1e-5, atol 0.5, with TF32 off; flash attention in float32 on the
   CUDA-core kernel within rtol 1e-4, atol 1e-5 and in bf16 on the
   tensor-core kernel (head dim 64, 128 and 256, ragged and
   shifted-causal rows included) within one bf16 rounding of the output,
   at the prefill shape of every served arch, in the non-causal forms of
   an encoder-decoder (its encoder at 16 and 1024 frames, cross attention
   over 16 frames in prefill and in one-query decode; each row's bound
   and SDPA call on its own mask), and the log-sum-exp that
   kernel writes for the backward against a plain ``logsumexp`` of the
   scaled, masked scores; the attention backward (dQ, dK, dV: bf16 on
   ``flash_attention_bwd_sm90``, fed the forward kernel's log-sum-exp,
   and launched twice at gemma-2b's shape for the same bits; float32 on
   ``flash_attention_bwd``) against autograd through the plain forward
   in float32, at the train phase's shapes and each head dim, SDPA's
   backward as its library call; selective_scan
   within rtol/atol 1e-5 at the JAX tests' shapes, 1e-4 at b * di > 4096,
   ragged edges of both kernels' tiling included, and with its chunk
   states at falcon's prefill, timed beside the forward without them;
   the scan backward ``selective_scan_bwd`` against the plain reverse
   recurrence (``selective_scan_bwd_ref``) on every output (dx, ddt, dA,
   dB, dC, dh0) at the same gates, at the JAX tests' shapes, falcon's
   training micro-batch (launched twice there for the same bits) and
   ragged shapes, all with h0 and dhT), all timed with CUDA
   events, and where one PyTorch call computes the same function (the
   population gather's indexing, ``scaled_dot_product_attention``) that
   call too.  population_lut and rank_k also run at the shapes the
   DCT's labels give them (the signed mul8s gather at 1024 and 784 rows,
   shared and per-genome cols; one (256,4)@(4,1) per-column deploy
   product of 4 signed groups; the per-circuit deployment
   (256,256)@(256,128) of pipelines B/E, one group, unsigned and signed,
   at the largest deploy rank of each kind).  Each row's bound is the largest of bytes over the HBM rate,
   operations over the rate of the units that run them, the LUT
   matmul's table lookups over the shared-memory lookup rate and, for
   the scan's and the softmax's exponentials, their least time split
   between the SFUs and the float32 lanes (each term in
   ``bound_terms_ms``, with the exponentials' time on the SFUs alone for
   the record).  The LUT matmul has rows on both of its routes
   (``LUT_CASES``: ragged edges, k = 33000 at the int32 edge, n = 1, a
   table wider than 16 bits, conflict-free operands, both sides of the
   route crossover), and a ``kernel_lut_crossover`` line times both
   routes on the cubes of ``LUT_SWEEP``.  A ``kernel_rank_k_fresh_process``
   line runs rank_k as the first launch of a new process at a shared-
   memory size that needs the launch to raise the block's limit itself.
4. ``labels``  — one line per accelerator: ``default_labeler(acc, lib,
   n_qor_samples=4, device="cuda")`` on 1000 numpy-seeded genomes of
   ``gaussian3x3`` (then a second batch of 1000), ``mcm1``…``mcm4``,
   ``hevc_dct4x4``, ``smoothed_dct`` (one batch each since their
   lines' ``reduced``, ``LABELS_REDUCED``), ``smoothed_dct/stage0`` and
   ``/stage1``, each through a fresh
   ``SynthCache`` (structural tier on, its ``stats()`` printed), then
   one ``gaussian3x3`` batch with the structural tier off.  ``qor`` and
   ``energy`` must be bit-identical to ``device="cpu"`` on a 64-genome
   subset (labeled through a cache of its own), ``qor`` to the
   per-genome numpy ``Accelerator.qor`` on 8 genomes; the deployment
   runs paid must be those ``predicted_runs`` counts on the host from
   the batches' ``deploy_signature`` values, and rank_k must launch
   exactly its deployment's launches (``DEPLOY_LAUNCHES``: 1, 8 for the
   DCT's two passes, 9 for the chain) once per run paid.
5. ``dse``     — ``run_dse`` on ``GaussianFilter``, then on ``HEVCDct``, at
   the paper's widths (n_train=1000, pop_size=1000, n_parents=200, 4 QoR
   images), with ``n_generations`` cut as the ``reduced`` field says; the
   front must hold designs below its best QoR (approximate ones), and
   its labels are checked against ``device="cpu"`` (a cache of its own).
6. ``cache``   — the persistent synthesis cache, for ``gaussian3x3`` and
   ``hevc_dct4x4``, on a ``.jsonl`` file and a ``.segd`` root in a
   temporary directory: a cold 1000-genome batch, then a new cache
   object on the same path and the same batch, which must launch no
   rank_k, pay no run, answer each unique variant from the identity
   tier and give labels equal to the cold ones.
7. ``figs``    — the paper's figure families.  Fig. 1 on
   ``gaussian3x3`` (``benchmarks/fig1_motivation.py``): 1000 variants'
   QoR through ``qor_batch`` and their deployment energy on the H100 cost
   model through ``synthesize_batch`` (rank_k once a run paid), and the
   share of the (QoR, ASIC area proxy) front that is off the (QoR,
   energy) front.  Fig. 6 (``benchmarks/fig6_models.py``) on
   ``mcm1``…``mcm4``: random forest, Bayesian ridge and SVR fitted on
   pipeline D's features of 1000 training genomes, their PCC on 1000
   test genomes for QoR and energy (mcm1 on Fig. 5's labels, the other
   rows labeled on the card); a model that is singular or predicts
   non-finite values is printed with its reason.  Fig. 5 on ``mcm1``: 1000
   training and 1000 test genomes labeled on the card, every
   multiplier's per-circuit deployment (pipelines B/E's features) on
   the card against the CPU's, then the six pipelines' PCC, time per
   variant and hours for 10^6 variants, with the claims ``D_fast`` and
   ``D_accurate``.  Figs. 8/9 on ``FIGS_ROWS``, one spawned process a
   row on the card, all at once: ``run_dse`` against
   ``approxfpgas_search`` and ``random_search`` at the synthesis budget
   n_train + n_parents, their hypervolume ratios, and each front held
   against a CPU re-label through a fresh cache.  Fig. 7 from the
   ``hevc_dct4x4`` run of the dse phase: the hypervolume by generation,
   the first generation at 95% of the final and the front size.  The
   claims are printed, not gated.
8. ``hier``    — the paper's hierarchical multi-stage search (§V) on
   ``smoothed_dct`` (45 slots), each run on a fresh in-process campaign
   service on the card (``CampaignManager(device="cuda")``: two eval and
   two campaign threads, ``max_batch=1000``, a fresh ``SynthCache``):
   a flat campaign over the joint genome at the paper's widths
   (n_train=1000, pop_size=1000, n_parents=200, 4 QoR images), then
   ``run_hierarchical``: one campaign a stage, run together, at the same
   widths and n_train=500, fronts composed (``k_per_stage=50``) into at
   most 200 candidates, which are re-labeled end to end.  Both run
   ``FIGS_GENERATIONS`` generations with ``FIGS_HW_MODEL``.  Gates: two
   stage campaigns in flight at once; the front's best QoR that of the
   exact anchor (100); every front design equal to a CPU re-label;
   rank_k launched ``DEPLOY_LAUNCHES`` times per run paid in each
   context (the genomes whose label carries synthesis seconds), and the
   runs the synthesis cache counted.  A line per run (walls, labels,
   store and in-flight hits, batches and their sizes, runs paid,
   launches, composition), then the label and hypervolume ratios on a
   shared reference point, printed, not gated.
9. ``lm_dse``    — the paper's DSE applied to the LM (``accel/lm.py``):
   ``run_dse`` on ``LMAccelerator(granite-8b, use_reduced=False)`` (36
   layers, d 4096, GQA 32/8, d_ff 14336, vocab 49152, batch 2 x seq 32,
   weights drawn from the seed on the card) at ``launch/dse_lm.py``'s
   defaults (pipeline D, NSGA-II, pop 32, 12 parents, 12 generations,
   2 QoR inputs; ``LM_DSE``) but n_train 24 of its 48 (the line's
   ``reduced``), through a fresh
   ``SynthCache``.  Gates: flash_attention_sm90 launched 36 times per
   forward the accelerator counted; the deployment forwards equal the
   runs paid; every label's energy equal to the host's
   ``adjusted_compute`` bit for bit; the exact genome's QoR at the cap;
   the front's QoR re-simulated with the plain attention within
   max(``LM_QOR_TOL_DB``, 2 x the spread the JAX model code's own form
   of attention shows on the same designs).  The front is written as a
   ``FrontCatalog``; ``policy_from_front`` must decode its budget and
   balanced tiers to the genomes ``select`` names; the accelerator is
   freed and the budget tier served by ``serve_batch`` at full width
   (batch 8, 1024-token prompts, 32 generated), its prefill logits on
   the DSE's first input held against the accelerator's for that genome
   within one bf16 rounding.  Then 8 random genomes of falcon-mamba-7b
   at full width (64 layers) are labeled: selective_scan launched 64
   times per forward; and 8 of seamless-m4t-medium at full size (12 + 12
   layers, 16 encoder frames drawn as the JAX package's LM accelerator
   draws them): flash_attention_sm90 launched 36 times per forward (12
   encoder, 12 self, 12 cross attention).  Then ``run_dse`` on granite-moe-3b-a800m at full
   width and depth (32 MoE layers, 40 experts padded to 48, top-8) with
   the same settings and gates (flash_attention_sm90 32 times a
   forward), and two genomes that differ only in their
   ``expert_in``/``expert_out`` genes: equal QoR, flops and bytes,
   different energy (no policy reaches the experts).
10. ``serve_<arch>`` for each of ``SERVE_ARCHS`` (granite-8b, also
   ``serve_granite-8b_approx``; falcon-mamba-7b, gemma-2b, chatglm3-6b,
   deepseek-67b, granite-moe-3b-a800m, phi3.5-moe-42b-a6.6b,
   seamless-m4t-medium, qwen2-vl-72b) — the LM serving path at full
   width and depth (deepseek-67b, phi3.5-moe and qwen2-vl-72b at the
   depth of ``SERVE_DEPTH``, in the line's ``reduced``), one model at a
   time (freed before the next): weights drawn from the seed on the
   card, then ``serve_batch(cfg, batch=8, prompt_len=1024, gen=32)``
   (seamless-m4t-medium against 16 encoder frames, qwen2-vl-72b after
   256 patch embeddings, both drawn from the seed), the tensor-core
   attention kernel launched once an attention layer (and once an
   encoder layer, and once a cross-attention layer in prefill and in
   each decode step: 408 launches a seamless request).
   The checks run on the first ``SERVE_CHECK_LAYERS`` layers of the same
   model (an MoE arch's routing every token to every real expert, so
   that a rounding cannot swap a token's experts; the timed request
   keeps the published top-k and capacity): in one more prefill every layer's kernel call is held against
   the plain version on that layer's own inputs (the kernel rows'
   tolerance); the prefill's last-position logits with the kernels are
   held against the plain attention / scan, within max(0.12, 2 x the
   spread that the JAX model code's own chunked form of the function
   shows against the plain one in the same run; see ``LOGITS_TOL``), and
   the greedy tokens of both are compared.  A profiled prefill and 4
   decode steps of the whole model give device time, the kernel's share
   and the decode's launches and idle share.  The ``_approx`` phase
   serves granite-8b with ``ffn_in``/``ffn_out`` on ``mul8s_mitchell``
   at rank 3, at ``SERVE_APPROX_DEPTH`` (9) of its 36 layers.
11. ``train`` — training through ``launch/train.py``: ``train_gemma-2b``
   runs ``train_loop`` on gemma-2b at full size (18 layers, d 2048, MQA,
   head dim 256, tied 256k vocab; float32 master weights, AdamW, weights
   from the seed) for 12 steps of 8 x 1024 tokens in 2 micro-batches at
   lr 1e-3, warmup 1 (``TRAIN``): tokens/s, seconds a step, peak memory,
   the losses and gradient norms, the step's model FLOPs over the bf16
   peak; gates: the last loss below the first, nothing NaN, the forward
   kernel launched twice (remat) and ``flash_attention_bwd_sm90`` once
   an attention layer a micro-batch pass.  ``train_check``: one step's loss,
   every gradient and the global gradient norm on gemma-2b's first 2
   layers at full width, kernels against the plain attention, within
   max(floor, 2 x the spread the JAX model code's own form of attention
   shows against the plain one in the same run).
   ``train_falcon-mamba-7b``: the same ``train_loop`` run on
   falcon-mamba-7b at full width (d 4096, d_inner 8192, 16 states, 65k
   vocab, untied) and ``TRAIN_FALCON_LAYERS`` of its 64 layers, float32
   masters, 6 steps (``TRAIN_FALCON``); gates: the loss falls, nothing
   NaN, the scan forward (with chunk states) launched twice and
   ``selective_scan_bwd`` once a Mamba layer a micro-batch pass.  ``train_check_mamba``: ``train_check`` on
   falcon's first 2 layers, the scan kernels against the plain scan,
   the spread from the JAX model code's chunked scan, and each layer's
   backward held to the plain one on that layer's own inputs and output
   gradient.  ``train_moe``:
   granite-moe-3b at full width on 4 of its 32 layers, 3 steps of 2 x
   1024; the load-balance loss finite and in the loss, the d=64
   tensor-core forward and the backward launched.  ``train_hybrid``:
   jamba-1.5-large's 8-layer block pattern (Mamba, attention at
   position 4, MoE 16 experts top-2 every other layer) as one
   super-block at a quarter of its width (``TRAIN_HYBRID_CFG``), bf16
   masters and moments, 3 steps of 2 x 1024; the loss finite with the
   load-balance loss in it, the scan and attention kernels launched
   each way per layer.  ``train_resilient``:
   ``run_resilient`` on a small gemma with a checkpoint every 2 steps
   and a failure injected at step 3: one restart, losses and final
   parameters bit-equal to a clean run's.  ``train_seamless-m4t-medium``:
   ``train_loop`` on seamless at full size (12 + 12 layers, d 1024, 256k
   vocab), each batch with 1024 encoder frames (``step_embeds``), at
   ``TRAIN`` but lr 3e-4 (``TRAIN_SEAMLESS``); the encoder's
   self-attention and cross attention (sq 1024 over sk 1024) train
   through both kernels non-causally: 36 flash calls a pass.
   ``train_check_encdec``: ``train_check`` on its first 2 encoder and 2
   decoder layers.  ``train_qwen2-vl-72b``: qwen at full width (d 8192,
   GQA 64/8, 152k vocab, untied) on ``TRAIN_QWEN_LAYERS`` of its 80
   layers, 256 patch embeddings before 1024 tokens, the loss on the
   text, 6 steps (``TRAIN_QWEN``).  ``train_compress``: ``--compress`` (``ef_quantize``) on
   gemma-2b's first 2 layers, 3 steps.  ``cluster``: ``python -m
   repro_torch.launch.cluster`` as a subprocess, one NCCL process on
   gemma-2b at full size, 6 steps (``CLUSTER``) with ``--compress``
   (error-feedback gradients through ``compressed_psum``, the
   micro-batch count ``n_microbatches``'s); the loss falls and the
   child's launch counts per layer and pass; then ``compressed_psum`` on
   a one-rank NCCL group of this process equals its plain formula bit
   for bit.
12. ``service`` — the campaign service's HTTP front end
   (``service/api.py``) on a free local port, its process pool, fleet
   and serving tier on the card.  (a) ``process``: a ``gaussian3x3``
   campaign posted through ``Client`` at the paper's widths and the dse
   phase's generations to ``CampaignManager(device="cuda",
   eval_backend="process", process_workers=2)``; gates: no batch
   labeled in the parent (no fallback, no launch), the children's summed
   launches show population_lut in every QoR chunk and rank_k =
   ``DEPLOY_LAUNCHES`` x the children's runs paid, ``qor``/``energy`` of
   64 stored genomes byte-equal to a CPU label; its wall beside the dse
   phase's.  (b) ``serve_images``: 64 concurrent ``POST /serve`` for
   gaussian3x3 over the exact/balanced/budget tiers and an energy budget
   against (a)'s front, each output and measured QoR equal to the CPU
   ``simulate_batch`` of its genome and inputs, population_lut
   launched; ``hot_swap``: a second campaign (the paper's widths, seed
   + 1) completes under 8 threads of paced traffic, the merged front it
   changes swaps in, no request fails and every response's genome is
   its catalog version's choice.  (c)
   ``serve_lm``: the lm_dse phase's granite-8b accelerator and front
   registered with the hub (no second model: peak within 1 GiB of that
   phase's), its budget tier served to 8 concurrent 1024-token prompts,
   32 tokens each, equal to the ``lm_dse_serve`` line's, with
   flash_attention_sm90 launched 36 times for the one prefill.  (d)
   ``fleet``: an ``hevc_dct4x4`` campaign on the thread backend, then on
   ``eval_backend="fleet"`` with two ``python -m
   repro_torch.fleet.worker --device cuda`` processes on the card, one
   killed (SIGKILL) while it holds a lease after its first result; gates:
   front and every stored label byte-identical to the thread run, a
   requeue, no fallback, both workers' reported launches carrying
   population_lut and rank_k, the parent's launches no more than the
   orchestrator's reclaimed chunks need.

Every kernel's launch count is set to 0 just before each run of phases 4
to 12 (each accelerator's labels, each dse, each cache batch, each figure
run, each hier run, the LM's dse, its served tier and falcon's labels,
each serve, each training run, each service campaign and request set)
and read just after (``train_check``'s launches are a comparison and do
not count);
the process pool's children and the fleet's workers count their own
launches and report them with each chunk's labels, and those reports
are what the service phase reads; so does each Figs. 8/9 row's process,
with its line.  A kernel of the
phase's main path (``MAIN_PATH``) that the phase did not launch, or did
not launch once per attention (or Mamba) layer for the serve phases
(twice forward and once backward a layer and a micro-batch pass for
the training runs), fails the run.  ``lut_matmul`` and
``lut_matmul_sm90`` are the behavioural route of the deployment module,
which the labels do not run; their rows in phase 3 hold them against
their plain version.
``--phases`` runs a subset (the first check of a new kernel on the card)
and then prints no summary and exits 3.
Then one line ``{"kernels": [...]}`` sums it up, and the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failed build,
launch or comparison exits non-zero before that line, as does a machine
without a CUDA device or a directory without the port's sources.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): HBM3 rate, the
# float32 rate of the CUDA cores (outside the tensor cores) and the bf16
# dense rate of the tensor cores (where the bf16 flash kernel and
# scaled_dot_product_attention run their products).
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
TENSOR_CORE_BF16_OPS_PER_S = 989e12
# float32 instruction rate: 128 lanes an SM x 132 SMs x 1.98 GHz, the
# clock at which they give the data sheet's 67 TFLOP/s (an FMA counts 2)
FP32_INSTR_PER_S = 132 * 128 * 1.98e9
# exponentials on the special-function units (MUFU.EX2): 16 results a
# clock on each SM (CUDA C++ Programming Guide, throughput of arithmetic
# instructions, base-2 exponential at compute capability 9.0)
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# an exp2 can run on the float32 lanes instead: round off the integer
# part, a short polynomial of the fraction, an integer add into the
# exponent bits, about 7 instructions
EXP2_FP32_INSTRS = 7
# data-dependent table lookups: a lookup is a load, and an SM's shared
# memory returns one 128-byte wavefront a clock, at most 32 lookups (one
# a bank), 132 SMs at 1.98 GHz (the L2, which serves a lookup as a
# 32-byte sector, is slower still)
LOOKUPS_PER_S = 132 * 32 * 1.98e9

RANK_RTOL, RANK_ATOL = 1e-5, 0.5     # as the JAX package's kernel tests
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-5  # tests/test_kernels.py
# bf16 output: both versions do float32 math and round once to bf16, so
# they may differ by one bf16 rounding (2^-8 relative, up to 2^-7)
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2 ** -7, 1e-3
# the library call (bf16 P.V on the tensor cores) is only a yardstick
SDPA_RTOL, SDPA_ATOL = 2e-2, 5e-2
# the attention backward (dQ, dK, dV) against autograd through the plain
# forward in float32: float32 rows at the forward's tolerance; bf16 rows
# within two bf16 roundings relative and 2^-7 of the largest gradient
# absolute (the kernel takes D = rowsum(dO * O) from the bf16 forward
# output, as FlashAttention-2 does, where the plain version's float32
# autograd has no rounded O; then each output rounds once to bf16)
FLASH_BWD_BF16_RTOL, FLASH_BWD_BF16_FRAC = 2 ** -6, 2 ** -7
# SDPA's backward (bf16 products on the tensor cores) is only a yardstick:
# finite, within 5% of the largest gradient
SDPA_BWD_FRAC = 5e-2
SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-5    # tests/test_kernels_scan.py
SCAN_WIDE_TOL = 1e-4                 # 1024 sequential steps
# bf16 logits: the JAX package's own tolerance (tests/test_models.py) at
# its 2-layer test size.  At full depth one bf16 rounding that differs in
# one layer moves the logits further: the JAX model code's own form of
# the function (chunked) against the plain one moves them by ``spread``,
# measured in the same run, and kernel vs plain is another draw of the
# same rounding noise, so the serve phases hold it to
# max(LOGITS_TOL, LOGITS_SPREAD_FACTOR * spread).  A fault of the kernel
# itself shows in the per-layer check, at the kernel rows' tolerance.
LOGITS_TOL = 0.12
LOGITS_SPREAD_FACTOR = 2.0

SERVE = dict(batch=8, prompt_len=1024, gen=32)
# the archs the serve phases run, in order; the timed request runs at
# full width and at the depth of SERVE_DEPTH where one is given (the
# published depth does not fit one 80 GB card in bf16: deepseek-67b's
# 95 layers are 1.38 GB each, phi3.5-moe's 32 are 2.6 GB each,
# qwen2-vl-72b's 80 are 1.76 GB each beside 5.0 GB of embedding and
# head).  seamless-m4t-medium serves against 16 encoder frames,
# qwen2-vl-72b after 256 patch embeddings (``train.serve.frontend_inputs``,
# drawn from the seed), so its prefill attends over 1280 positions
SERVE_ARCHS = ("granite-8b", "falcon-mamba-7b", "gemma-2b", "chatglm3-6b",
               "deepseek-67b", "granite-moe-3b-a800m",
               "phi3.5-moe-42b-a6.6b", "seamless-m4t-medium",
               "qwen2-vl-72b")
SERVE_DEPTH = {"deepseek-67b": 44, "phi3.5-moe-42b-a6.6b": 26,
               "qwen2-vl-72b": 36}
# the depth of granite-8b served under the approximate FFN policy (the
# approximate linear route is the slowest path of the serve phases; full
# depth, 36, until the two encoder-decoder and vision phases joined, 18
# until the training lines of the encoder-decoder and vision families,
# compression and the cluster CLI did)
SERVE_APPROX_DEPTH = 9
# the serve phases' checks (kernel against plain prefill, each layer's
# kernel call, the JAX form's spread, the plain route's greedy tokens) run
# on the first SERVE_CHECK_LAYERS layers of the same model
SERVE_CHECK_LAYERS = 4

# flash-attention rows: (b, h, kvh, sq, sk, d, q_offset, causal, dtype,
# label); float32 runs the CUDA-core kernel, bf16 the tensor-core one
# (ops.KERNEL_ROUTES); one row at least for every route of that table,
# and for every form the main paths run: causal prefill, the encoder's
# non-causal self-attention, cross attention over fewer keys than one
# 64-key tile (only the kernel's key mask keeps TMA's zero-filled rows,
# which score 0, out of the softmax) and its one-query decode
FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, 0, True, "float32", "JAX test shape"),
    (1, 4, 4, 256, 256, 64, 0, True, "float32", "JAX test shape"),
    (1, 8, 2, 1000, 1000, 128, 0, True, "float32", "ragged, GQA 8/2"),
    (2, 8, 2, 1, 1056, 128, 1000, True, "float32",
     "decode offset, one query at position 1000"),
    (8, 32, 8, 1024, 1024, 128, 0, True, "bfloat16",
     "granite-8b prefill (serving shape), GQA 32/8"),
    (1, 8, 2, 1000, 1000, 128, 0, True, "bfloat16",
     "ragged, GQA 8/2: keys past 1000 zero-filled by TMA"),
    (2, 8, 2, 200, 264, 128, 64, True, "bfloat16",
     "ragged, causal mask shifted by q_offset 64"),
    (2, 32, 8, 32, 32, 128, 0, True, "bfloat16",
     "granite-8b LM DSE forward (b 2, s 32): one partial query tile"),
    (1, 4, 4, 256, 256, 64, 0, True, "bfloat16", "head dim 64"),
    (1, 8, 8, 512, 512, 256, 0, True, "bfloat16", "head dim 256"),
    # the prefills of the serve phases' other archs (phi3.5-moe's is
    # granite-8b's shape)
    (8, 8, 1, 1024, 1024, 256, 0, True, "bfloat16",
     "gemma-2b prefill, MQA, head dim 256"),
    (8, 32, 2, 1024, 1024, 128, 0, True, "bfloat16",
     "chatglm3-6b prefill, GQA 32/2"),
    (8, 64, 8, 1024, 1024, 128, 0, True, "bfloat16",
     "deepseek-67b prefill, GQA 64/8"),
    (8, 24, 8, 1024, 1024, 64, 0, True, "bfloat16",
     "granite-moe-3b prefill, GQA 24/8, head dim 64"),
    (2, 24, 8, 32, 32, 64, 0, True, "bfloat16",
     "granite-moe-3b LM DSE forward (b 2, s 32)"),
    # seamless-m4t-medium (16 heads of 64) and qwen2-vl-72b
    (8, 16, 16, 1024, 16, 64, 0, False, "bfloat16",
     "seamless-m4t-medium cross attention in prefill: 1024 queries over "
     "16 encoder frames, fewer keys than one tile"),
    (8, 16, 16, 1, 16, 64, 0, False, "bfloat16",
     "seamless-m4t-medium cross attention in decode: one query over 16 "
     "encoder frames"),
    (8, 16, 16, 16, 16, 64, 0, False, "bfloat16",
     "seamless-m4t-medium encoder at the served 16 frames"),
    (8, 16, 16, 1024, 1024, 64, 0, False, "bfloat16",
     "encoder self-attention at 1024 frames: full non-causal tiles"),
    (8, 64, 8, 1280, 1280, 128, 0, True, "bfloat16",
     "qwen2-vl-72b prefill: 256 patch embeddings + 1024 tokens, GQA 64/8"),
]
# flash-attention backward rows: (b, h, kvh, s, d, causal, dtype, label);
# the training shapes of the train phase (gemma-2b's micro-batch, d=256
# MQA; granite-moe-3b's, d=64 GQA 24/8), every head dim in both dtypes,
# GQA, a ragged length and a non-causal row; bf16 runs the tensor-core
# kernel, float32 the CUDA-core one (ops.BWD_ROUTES)
FLASH_BWD_CASES = [
    (1, 4, 4, 128, 64, True, "float32", "JAX test shape"),
    (1, 8, 2, 1000, 128, True, "float32", "ragged, GQA 8/2"),
    (1, 4, 2, 200, 128, False, "float32", "ragged, non-causal, GQA 4/2"),
    (1, 4, 4, 256, 256, True, "float32", "head dim 256"),
    (1, 4, 4, 256, 64, True, "bfloat16", "head dim 64"),
    (1, 8, 2, 1000, 128, True, "bfloat16", "ragged, GQA 8/2, head dim 128"),
    (1, 4, 2, 200, 128, False, "bfloat16", "ragged, non-causal, GQA 4/2"),
    (4, 8, 1, 1024, 256, True, "bfloat16",
     "gemma-2b training micro-batch (4 x 1024), MQA, head dim 256"),
    (2, 24, 8, 1024, 64, True, "bfloat16",
     "granite-moe-3b training micro-batch (2 x 1024), GQA 24/8"),
    # cross attention trains non-causally at sq != sk (s = (sq, sk))
    (4, 16, 16, (1024, 1024), 64, False, "bfloat16",
     "seamless-m4t-medium training cross attention, 1024 frames"),
    (4, 16, 16, (1024, 16), 64, False, "bfloat16",
     "cross attention over serving's 16 encoder frames"),
    (4, 16, 16, (1024, 4096), 64, False, "bfloat16",
     "cross attention over ENC_CONTEXT = 4096 encoder frames"),
]
# the backward row launched twice for the same bits (no atomics:
# train_resilient's bit-equal resume rests on it)
FLASH_BWD_SAME_BITS = (4, 8, 1, 1024, 256)
# log-sum-exp rows (b, h, kvh, s, d, label): what the tensor-core forward
# writes for the backward against a plain logsumexp; both float32, the
# kernel's scores scaled after the bf16 product and the plain ones before
FLASH_LSE_CASES = [
    (4, 8, 1, 1024, 256, "gemma-2b training micro-batch, MQA"),
    (1, 8, 2, 1000, 128, "ragged, GQA 8/2"),
]
FLASH_LSE_RTOL, FLASH_LSE_ATOL = 1e-5, 1e-5
# selective-scan rows: (b, s, di, n); the JAX tests' shapes, then
# falcon-mamba-7b's prefill at the serving batch, then ragged edges of the
# kernel's tiling (tiles of 16 steps in groups of 4, blocks of 64
# channels): s no multiple of the tile or of the step group, di no
# multiple of the block (2050 and 13 no multiple of 4 either: 4-byte
# copies and stores), n = 5 and n = 16 at b * di > 4096, and n = 3 at a
# JAX-test size
SCAN_CASES = [(1, 16, 8, 4, "JAX test shape"),
              (2, 64, 32, 8, "JAX test shape"),
              (1, 128, 16, 16, "JAX test shape"),
              (8, 1024, 8192, 16, "falcon-mamba-7b prefill width"),
              (2, 32, 8192, 16, "falcon-mamba-7b LM DSE forward (b 2, s 32)"),
              (2, 1001, 4100, 16, "ragged"), (2, 999, 2050, 5, "ragged"),
              (1, 37, 13, 3, "ragged")]
# selective-scan backward rows (5b): (b, s, di, n); the JAX tests'
# shapes, falcon-mamba-7b's training micro-batch (the train phase's), and
# ragged edges (s no multiple of the 64-step chunk or the 16-step tile, di
# no multiple of the 64-channel block, n = 5 and 3, 4-byte copies); every
# row with a nonzero h0 and dhT.  Gates: the forward's (``SCAN_RTOL`` /
# ``SCAN_ATOL`` at the JAX tests' shapes, ``SCAN_WIDE_TOL`` at b * di >
# 4096) on every output
SCAN_BWD_CASES = [(1, 16, 8, 4, "JAX test shape"),
                  (2, 64, 32, 8, "JAX test shape"),
                  (1, 128, 16, 16, "JAX test shape"),
                  (4, 1024, 8192, 16, "falcon-mamba-7b training micro-batch"),
                  (2, 999, 2050, 5, "ragged"), (1, 37, 13, 3, "ragged")]
SCAN_BWD_OUTPUTS = ("dx", "ddt", "dA", "dB", "dC", "dh0")
# the backward row launched twice for the same bits (no atomics: the
# training runs' bit-equal resume rests on it)
SCAN_BWD_SAME_BITS = (4, 1024, 8192, 16)
# the forward with chunk states, at falcon-mamba-7b's prefill, timed
# beside the forward without them
SCAN_STATES_CASE = (8, 1024, 8192, 16)

# kernels each main-path phase must launch: the population gather of every
# QoR label and the rank-k deployment graph that synthesis runs; the
# prefill attention of every attention layer; the prefill scan of every
# Mamba layer
MAIN_PATH = {
    "labels": ("population_lut", "rank_k"),
    "dse": ("population_lut", "rank_k"),
    "cache": ("population_lut", "rank_k"),
    "figs": ("population_lut", "rank_k"),
    "hier": ("population_lut", "rank_k"),
    "lm_dse": ("flash_attention_sm90", "selective_scan"),
    "serve_granite-8b": ("flash_attention_sm90",),
    "serve_granite-8b_approx": ("flash_attention_sm90",),
    "serve_falcon-mamba-7b": ("selective_scan",),
    "serve_gemma-2b": ("flash_attention_sm90",),
    "serve_chatglm3-6b": ("flash_attention_sm90",),
    "serve_deepseek-67b": ("flash_attention_sm90",),
    "serve_granite-moe-3b-a800m": ("flash_attention_sm90",),
    "serve_phi3.5-moe-42b-a6.6b": ("flash_attention_sm90",),
    # the encoder's, the decoder's and cross attention's (prefill and
    # each decode step)
    "serve_seamless-m4t-medium": ("flash_attention_sm90",),
    "serve_qwen2-vl-72b": ("flash_attention_sm90",),
    # training: the forward kernel, twice a layer with remat, and the
    # backward kernel (bf16: ops.KERNEL_ROUTES, ops.BWD_ROUTES)
    "train_gemma-2b": ("flash_attention_sm90", "flash_attention_bwd_sm90"),
    # the scan forward with chunk states, twice a layer with remat, and the
    # scan backward
    "train_falcon-mamba-7b": ("selective_scan", "selective_scan_bwd"),
    "train_moe": ("flash_attention_sm90", "flash_attention_bwd_sm90"),
    "train_hybrid": ("flash_attention_sm90", "flash_attention_bwd_sm90",
                     "selective_scan", "selective_scan_bwd"),
    "train_resilient": ("flash_attention_sm90", "flash_attention_bwd_sm90"),
    # the encoder's self-attention and cross attention non-causal, at
    # sq = 1024 decoder positions over sk = 1024 frames
    "train_seamless-m4t-medium": ("flash_attention_sm90",
                                  "flash_attention_bwd_sm90"),
    "train_qwen2-vl-72b": ("flash_attention_sm90",
                           "flash_attention_bwd_sm90"),
    "train_compress": ("flash_attention_sm90", "flash_attention_bwd_sm90"),
    # the cluster CLI's child process, its own counts
    "cluster": ("flash_attention_sm90", "flash_attention_bwd_sm90"),
    "service": ("population_lut", "rank_k", "flash_attention_sm90"),
}
# rank_k launches of one variant's deployment graph (``build_deploy``):
# one grouped product for gaussian3x3 and an MCM row, four products (one
# per output column) in each of the DCT's two passes, the chain's sum
# for the pipeline, a stage view's own stage's
DEPLOY_LAUNCHES = {
    "gaussian3x3": 1, "mcm1": 1, "mcm2": 1, "mcm3": 1, "mcm4": 1,
    "hevc_dct4x4": 8, "smoothed_dct": 9,
    "smoothed_dct/stage0": 1, "smoothed_dct/stage1": 8,
}
PHASES = ("device", "build", "kernel", "labels", "dse", "cache", "figs",
          "hier", "lm_dse", "serve", "train", "service")
# the figs phase: Fig. 5's 1000 training and 1000 test genomes; Figs.
# 8/9's MCM rows and NSGA-II generations; the power surrogate of both
# (the JAX package's default, bayesian_ridge, is singular on pipeline E's
# features of mcm1's 1000 training labels; see the figs line's
# ``reduced``)
FIG5_TRAIN = FIG5_TEST = 1000
# Fig. 1's gaussian3x3 variants (the JAX package's benchmark: 120)
FIG1_VARIANTS = 1000
FIGS_ROWS = (0, 1, 2, 3)
# 25 until the service phase joined the script; cut to keep the whole
# run near 950 s (each generation at pop 1000 costs 0.15-0.4 s of host
# time, the campaign service's tick included)
FIGS_GENERATIONS = 10
FIGS_HW_MODEL = "ridge"
# the hier phase on smoothed_dct: the flat campaign at the paper's widths;
# each stage campaign at the same widths and half the training labels, so
# that the stages' training labels sum to the flat run's; a front of
# k_per_stage points a stage; the flat run's stage-3 budget (n_parents)
# of composed candidates; FIGS_GENERATIONS and FIGS_HW_MODEL for both
HIER_WIDTHS = dict(pop_size=1000, n_parents=200, n_qor_samples=4)
HIER_FLAT_TRAIN = 1000
HIER_STAGE_TRAIN = 500
HIER_K_PER_STAGE = 50
HIER_MAX_CANDIDATES = 200


class SmokeFailure(RuntimeError):
    pass


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started, so consecutive lines give each step's
    share of the whole run."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, *, repeats: int = 20, warmup: int = 3, runs: int = 3) -> float:
    """Card time of one ``fn()``: CUDA events around a run of ``repeats``
    back-to-back calls, over the count; the median of ``runs`` such runs,
    after ``warmup`` calls.  Nothing in a call waits for the card, so the
    host queues ahead and a kernel longer than its launch is timed alone;
    a shorter one is timed at the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / repeats)
    return statistics.median(times)


def bound_terms(*, nbytes: float, ops: float, exps: float = 0.0,
                lookups: float = 0.0,
                ops_per_s: float = CUDA_CORE_OPS_PER_S) -> dict:
    """Least card time in ms of each resource: bytes over the HBM rate;
    operations over the rate of the units that run them (the CUDA cores'
    float32 rate unless the kernel's products run on the tensor cores);
    table lookups over the shared-memory lookup rate; the exponentials on
    the SFUs alone (for the record, not a bound); and the exponentials
    split between the SFUs and the float32 lanes, which also run the
    row's CUDA-core operations.  The split's least time is
    max(F / R_f, (F + k E) / (R_f + k R_s)) in float32-lane time F, E
    exponentials, k lane instructions an exp2, lane and SFU rates R_f,
    R_s: the first where the SFUs take every exponential within F."""
    t_ops = ops / ops_per_s
    t_lanes = t_ops if ops_per_s == CUDA_CORE_OPS_PER_S else 0.0
    k = EXP2_FP32_INSTRS
    t_split = ((t_lanes + k * exps / FP32_INSTR_PER_S)
               / (1 + k * SFU_EXP_PER_S / FP32_INSTR_PER_S))
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": t_ops * 1e3,
            "lookups": lookups / LOOKUPS_PER_S * 1e3,
            "exps_sfu_only": exps / SFU_EXP_PER_S * 1e3,
            "exps_sfu_and_lanes": max(t_lanes, t_split) * 1e3}


def bound(**terms) -> tuple:
    """(bound_ms, bound_by): the largest of bytes, operations, lookups
    and the exponentials split between the SFUs and the float32 lanes
    (lookups and exponentials count as operations)."""
    t = bound_terms(**terms)
    t_ops = max(t["operations"], t["lookups"], t["exps_sfu_and_lanes"])
    return ((t["bytes"], "bytes") if t["bytes"] >= t_ops
            else (t_ops, "operations"))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {
        "phase": "device", "nvidia_smi": line,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch import _build

    t0 = time.perf_counter()
    walls = _build.build()
    wall = time.perf_counter() - t0
    # per kernel: the entry functions (mangled names carry the template
    # arguments) with their registers, shared memory and spills
    ptxas = {
        name: [ln.split(":", 1)[-1].strip()
               for ln in _build.build_log(name).splitlines()
               if "Used" in ln or "spill" in ln or "entry function" in ln]
        for name in _build.KERNELS
    }
    emit({"phase": "build", "wall_s": wall, "nvcc_s": walls, "ptxas": ptxas})


def _max_err(got, want) -> float:
    import torch

    if isinstance(got, tuple):
        return max(_max_err(g, w) for g, w in zip(got, want))
    if not got.numel():
        return 0.0
    return float(torch.max(torch.abs(got.double() - want.double())))


def _kernel_row(name, case, route_src, replaces, kernel_fn, plain_fn,
                compare, nbytes, ops, repeats=20, library_fn=None,
                library_compare=None, plain_repeats=None, extra=None,
                ops_per_s=CUDA_CORE_OPS_PER_S, exps=0.0, lookups=0.0):
    import torch

    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}[{case}]: kernel {tuple(g.shape)} {g.dtype} vs plain "
              f"{tuple(w.shape)} {w.dtype}")
    err = _max_err(got, want)
    compare(got, want, f"{name}[{case}]")
    library_err = None
    if library_fn is not None:
        lib_out = library_fn()
        library_err = _max_err(lib_out, want)
        (library_compare or compare)(lib_out, want,
                                     f"{name}[{case}] library call")
    ms = time_ms(kernel_fn, repeats=repeats)
    plain_ms = time_ms(plain_fn, repeats=plain_repeats or repeats)
    library_ms = (time_ms(library_fn, repeats=repeats)
                  if library_fn is not None else None)
    terms = dict(nbytes=nbytes, ops=ops, exps=exps, lookups=lookups,
                 ops_per_s=ops_per_s)
    b_ms, b_by = bound(**terms)
    row = {"name": name, "case": case, "route": "cuda", "source": route_src,
           "replaces": replaces, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms, "bound_terms_ms": bound_terms(**terms),
           **(extra or {})}
    if library_err is not None:
        row["library_max_abs_err"] = library_err
    emit({"phase": "kernel", **row})
    return row


def _byte_equal(got, want, what):
    import torch

    check(torch.equal(got, want), f"{what}: kernel differs from plain version")


def _close(rtol, atol):
    def compare(got, want, what):
        import torch

        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            check(bool(torch.isfinite(g).all()), f"{what}: not finite")
            check(torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol),
                  f"{what}: outside rtol {rtol}, atol {atol} (max |diff| "
                  f"{_max_err(g, w):.3g})")
    return compare


def _close_named(rtol, atol, names):
    """``_close`` over a tuple of outputs, naming the one outside."""
    def compare(got, want, what):
        for name, g, w in zip(names, got, want):
            _close(rtol, atol)(g, w, f"{what} {name}")
    return compare


_rank_close = _close(RANK_RTOL, RANK_ATOL)


def phase_kernels(seed: int) -> list:
    import numpy as np
    import torch

    from repro_torch.accel import GaussianFilter
    from repro_torch.accel import fused
    from repro_torch.accel.gaussian import GAUSS_COEFFS, _im2col
    from repro_torch.core.acl.library import default_library
    from repro_torch.kernels.approx_matmul import (
        from_circuit, grouped_rank_k_matmul, grouped_rank_k_matmul_kernel,
        pack_groups, rank_k_matmul, rank_k_matmul_kernel,
    )
    from repro_torch.kernels.population_lut import (
        population_lut_gather, population_lut_gather_ref,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    lib = default_library()
    acc = GaussianFilter()
    rows = []

    # population_lut at gaussian3x3's label widths
    src = "src/repro_torch/csrc/population_lut.cu"
    rep = "src/repro/kernels/population_lut/kernel.py:43"
    lut = fused.build_engine(lib, dev).lut("mul8u", GAUSS_COEFFS,
                                           tag=acc.name)
    C, S, _ = lut.shape
    cols_all = torch.from_numpy(np.ascontiguousarray(
        _im2col(acc.sample_inputs(4, seed=1234)), dtype=np.int32)).to(dev)
    s_l = torch.arange(S, device=dev)
    # the label batch, then a ragged one: G no multiple of the kernel's 4
    # genomes a block, the plane M * S = 32391 no multiple of 4 (4-byte
    # loads and stores)
    for G, M, what in ((1000, cols_all.shape[0], ""),
                       (999, cols_all.shape[0] - 1, ", ragged")):
        genes = torch.from_numpy(
            rng.integers(0, C, size=(G, S)).astype(np.int32)).to(dev)
        cols = cols_all[:M].contiguous()
        # the library call: one advanced-indexing gather, its int64 index
        # tensors built outside the timed region
        g_l = genes.long()[:, None, :]
        for per_genome in (False, True):
            c = cols if not per_genome else torch.from_numpy(
                rng.integers(0, 256, size=(G, M, S)).astype(np.int32)).to(dev)
            c_l = c.long() if per_genome else c.long()[None]
            rows.append(_kernel_row(
                "population_lut",
                f"G={G} M={M} S={S} C={C} "
                + ("per-genome cols" if per_genome else "shared cols") + what,
                src, rep,
                lambda g=genes, c=c, p=per_genome: population_lut_gather(
                    lut, g, c, per_genome=p),
                lambda g=genes, c=c, p=per_genome: population_lut_gather_ref(
                    lut, g, c, per_genome=p),
                _byte_equal,
                nbytes=4.0 * (lut.numel() + genes.numel() + c.numel()
                              + G * M * S),
                ops=0.0,
                library_fn=lambda g_l=g_l, c_l=c_l: lut[g_l, s_l, c_l],
            ))

    # rank_k and lut_matmul at the nine gaussian slot groups of a variant
    # covering ranks 0..4, then at larger square shapes
    names = ["mul8u_exact", "mul8u_trunc3", "mul8u_perf2", "mul8u_bam2",
             "mul8u_bam4", "mul8u_bam6", "mul8u_mitchell", "mul8u_drum4",
             "mul8u_kulkarni"]
    specs = [from_circuit(lib[n]) for n in names]
    x9 = torch.from_numpy(np.ascontiguousarray(
        _im2col(acc.sample_inputs(1, seed=1)), dtype=np.int32)).to(dev)
    w9 = torch.from_numpy(GAUSS_COEFFS.reshape(9, 1).astype(np.int32)).to(dev)
    m9 = x9.shape[0]
    ranks = sum(sp.rank for sp in specs)
    src = "src/repro_torch/csrc/rank_k.cu"
    rep = "src/repro/kernels/approx_matmul/kernel.py:72"
    # the synthesis call of one variant: its nine groups packed on the
    # host, uploaded with one copy and run in one launch (timed with the
    # upload, as the main path runs it)
    packed = pack_groups(specs, acc.slot_groups())
    packed_dev = torch.from_numpy(packed).to(dev)
    rows.append(_kernel_row(
        "rank_k", f"9 slot groups ({m9},9)@(9,1), ranks "
        + ",".join(str(sp.rank) for sp in specs)
        + ", trunc " + ",".join(str(sp.trunc_bits) for sp in specs)
        + " (1 launch)",
        src, rep,
        lambda: grouped_rank_k_matmul_kernel(x9, w9, packed),
        lambda: grouped_rank_k_matmul(x9, w9, packed_dev),
        _rank_close,
        nbytes=4.0 * (x9.numel() + w9.numel() + m9 + packed.size),
        ops=2.0 * m9 * (9 + ranks),
    ))
    for signed, cname in ((False, "mul8u_bam6"), (True, "mul8s_drum4")):
        n = 1024
        r = 4
        f = lib[cname].factors(r)
        lo, hi = (-128, 128) if signed else (0, 256)
        x = torch.from_numpy(rng.integers(lo, hi, (n, n)).astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.integers(lo, hi, (n, n)).astype(np.int32)).to(dev)
        # the wrapper packs its tables on the host: hand it host copies, so
        # the timed call makes no device-to-host read
        u_h = torch.from_numpy(np.ascontiguousarray(f.u, np.float32))
        v_h = torch.from_numpy(np.ascontiguousarray(f.v, np.float32))
        u, v = u_h.to(dev), v_h.to(dev)
        rows.append(_kernel_row(
            "rank_k", f"({n},{n})@({n},{n}) r={r} "
            + ("signed" if signed else "unsigned") + f" {cname}",
            src, rep,
            lambda x=x, w=w, u=u_h, v=v_h, s=signed: rank_k_matmul_kernel(
                x, w, u, v, signed=s),
            lambda x=x, w=w, u=u, v=v, s=signed: rank_k_matmul(
                x, w, u, v, signed=s),
            _rank_close,
            nbytes=4.0 * 3 * n * n + 2 * 256 * 4.0 * r,
            ops=2.0 * n ** 3 * (1 + r), repeats=10,
        ))

    rows += _hevc_rows(rng, dev, lib)
    rows += _circuit_rows(dev, lib)
    rows += _lut_rows(rng, dev, lib, x9, w9, specs)
    rows += _flash_rows(rng, dev)
    rows += _flash_lse_rows(rng, dev)
    rows += _flash_bwd_rows(rng, dev)
    rows += _scan_rows(rng, dev)
    rows += _scan_bwd_rows(rng, dev)
    return rows


def _hevc_rows(rng, dev, lib) -> list:
    """population_lut and rank_k at the shapes the DCT's labels give them:
    the signed mul8s gather (index x + 128) of stage 1 (shared cols) and
    stage 2 (per-genome cols) at the 4 QoR images' 1024 residual rows,
    the smoothed-DCT chain's stage 2 at 784 rows, and one per-column
    deploy product (256, 4) @ (4, 1) of 4 signed width-1 groups."""
    import numpy as np
    import torch

    from repro_torch.accel import HEVCDct, fused
    from repro_torch.accel.hevc_dct import HEVC_C, _blocks
    from repro_torch.kernels.approx_matmul import (
        from_circuit, grouped_rank_k_matmul, grouped_rank_k_matmul_kernel,
        pack_groups,
    )
    from repro_torch.kernels.population_lut import (
        population_lut_gather, population_lut_gather_ref,
    )

    rows = []
    acc = HEVCDct()
    lut = fused.build_engine(lib, dev).lut("mul8s", HEVC_C[1], tag="mcm1")
    C, S, _ = lut.shape
    G = 1000
    s_l = torch.arange(S, device=dev)
    # stage 1's columns: the transposed blocks of the 4 QoR images + 128
    blocks = _blocks(acc.sample_inputs(4, seed=1234))
    shared = torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(blocks, -1, -2).reshape(-1, 4) + 128,
        dtype=np.int32)).to(dev)
    src = "src/repro_torch/csrc/population_lut.cu"
    rep = "src/repro/kernels/population_lut/kernel.py:43"
    for M, per_genome, what in (
            (shared.shape[0], False, "hevc_dct4x4 stage 1, shared cols"),
            (shared.shape[0], True, "hevc_dct4x4 stage 2, per-genome cols"),
            (4 * 49 * 4, True, "smoothed_dct stage 2, per-genome cols")):
        genes = torch.from_numpy(
            rng.integers(0, C, size=(G, S)).astype(np.int32)).to(dev)
        c = shared if not per_genome else torch.from_numpy(
            rng.integers(0, 256, size=(G, M, S)).astype(np.int32)).to(dev)
        g_l = genes.long()[:, None, :]
        c_l = c.long() if per_genome else c.long()[None]
        rows.append(_kernel_row(
            "population_lut", f"G={G} M={M} S={S} C={C} signed ({what})",
            src, rep,
            lambda g=genes, c=c, p=per_genome: population_lut_gather(
                lut, g, c, per_genome=p),
            lambda g=genes, c=c, p=per_genome: population_lut_gather_ref(
                lut, g, c, per_genome=p),
            _byte_equal,
            nbytes=4.0 * (lut.numel() + genes.numel() + c.numel()
                          + G * M * S),
            ops=0.0,
            library_fn=lambda g_l=g_l, c_l=c_l: lut[g_l, s_l, c_l],
        ))

    # one output column of a DCT pass: the residual rows of the deploy
    # image against C^T[:, r], one signed circuit a contraction column
    names = ["mul8s_exact", "mul8s_trunc3", "mul8s_mitchell", "mul8s_drum4"]
    specs = [from_circuit(lib[n]) for n in names]
    x = torch.from_numpy(np.ascontiguousarray(
        _blocks(acc.sample_inputs(1, seed=1)).reshape(-1, 4),
        dtype=np.int32)).to(dev)
    w = torch.from_numpy(np.ascontiguousarray(
        HEVC_C.T[:, 1:2], dtype=np.int32)).to(dev)
    m = x.shape[0]
    packed = pack_groups(specs, [(j, j + 1) for j in range(4)])
    packed_dev = torch.from_numpy(packed).to(dev)
    rows.append(_kernel_row(
        "rank_k", f"4 signed slot groups ({m},4)@(4,1), "
        + ", ".join(f"{n} r={sp.rank} trunc={sp.trunc_bits}"
                    for n, sp in zip(names, specs))
        + " (hevc_dct4x4 per-column deploy product, 1 launch)",
        "src/repro_torch/csrc/rank_k.cu",
        "src/repro/kernels/approx_matmul/kernel.py:72",
        lambda: grouped_rank_k_matmul_kernel(x, w, packed),
        lambda: grouped_rank_k_matmul(x, w, packed_dev),
        _rank_close,
        nbytes=4.0 * (x.numel() + w.numel() + m + packed.size),
        ops=2.0 * m * (4 + sum(sp.rank for sp in specs)),
    ))
    return rows


def _circuit_rows(dev, lib) -> list:
    """rank_k at the per-circuit deployment that pipelines B and E run
    (``circuit_features_synth``): (256,256)@(256,128), one group, on the
    operands it draws (numpy seed 0), unsigned and signed, each with the
    circuit of the largest deploy rank of its kind."""
    import numpy as np
    import torch

    from repro_torch.kernels.approx_matmul import (
        from_circuit, grouped_rank_k_matmul, grouped_rank_k_matmul_kernel,
        pack_groups,
    )

    rows = []
    m, k, n = 256, 256, 128
    for kind, signed in (("mul8u", False), ("mul8s", True)):
        c = max(lib.kind(kind), key=lambda c: c.deploy_rank)
        spec = from_circuit(c)
        rng = np.random.default_rng(0)
        lo, hi = (-128, 128) if signed else (0, 256)
        x = torch.from_numpy(rng.integers(lo, hi, (m, k)).astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.integers(lo, hi, (k, n)).astype(np.int32)).to(dev)
        packed = pack_groups([spec], [(0, k)])
        packed_dev = torch.from_numpy(packed).to(dev)
        rows.append(_kernel_row(
            "rank_k", f"({m},{k})@({k},{n}) r={spec.rank} "
            + ("signed" if signed else "unsigned")
            + f" {c.name}, one group (per-circuit deploy of pipelines B/E, "
            "1 launch)",
            "src/repro_torch/csrc/rank_k.cu",
            "src/repro/kernels/approx_matmul/kernel.py:72",
            lambda x=x, w=w, p=packed: grouped_rank_k_matmul_kernel(x, w, p),
            lambda x=x, w=w, p=packed_dev: grouped_rank_k_matmul(x, w, p),
            _rank_close,
            nbytes=4.0 * (x.numel() + w.numel() + m * n + packed.size),
            ops=2.0 * m * k * n * (1 + spec.rank),
        ))
    return rows


# lut_matmul rows past the slot groups: (m, k, n, circuit or "wide",
# operands, label).  Operands "uniform" are drawn over the 8-bit domain;
# "extreme" put every term at the table's largest entry in the first half
# of the rows and columns (the int32 sum at k = 33000 then reaches
# 33000 * 65025, 0.1% under 2^31); "column" is n = 1, every row against
# one weight column (lanes of a warp share b, the case the swizzle
# spreads); "conflict-free" gives all rows one x and each column its own
# word of the table row, so a warp's lookups take one wavefront (the
# shared-memory floor, beside the uniform rows' bank conflicts).  The
# route is the one lut_route picks unless the label names one.
LUT_CASES = [
    (512, 512, 512, "mul8u_bam6", "uniform", "unsigned"),
    (512, 512, 512, "mul8s_drum4", "uniform", "signed"),
    (512, 512, 512, "mul8u_bam6", "uniform", "unsigned, L2 route"),
    (512, 512, 512, "mul8s_drum4", "uniform", "signed, L2 route"),
    (512, 512, 512, "mul8u_bam6", "conflict-free", "unsigned"),
    (509, 516, 252, "mul8u_drum4", "uniform", "ragged, 16-byte loads"),
    (509, 515, 251, "mul8s_perf3", "uniform",
     "ragged, 4-byte loads, k % 4 = 3"),
    (64, 33000, 64, "mul8u_exact", "extreme", "long k at the int32 edge"),
    (131072, 64, 1, "mul8u_kulkarni", "column", "n = 1"),
    (131072, 64, 1, "mul8u_kulkarni", "column", "n = 1, L2 route"),
    (256, 256, 256, "wide", "uniform", "table wider than 16 bits"),
]
# cubes timed on both routes for the crossover (m * n * k), and the k of
# the shared-memory kernel's (512, k) @ (k, 512) line
LUT_SWEEP = (32, 48, 64, 80, 96, 112, 128, 160, 192, 256)
LUT_K_SWEEP = (128, 256, 512, 1024, 2048)


def _lut_operands(rng, m, k, n, signed, kind, table):
    import numpy as np

    lo, hi = (-128, 128) if signed else (0, 256)
    off = 128 if signed else 0
    x = rng.integers(lo, hi, (m, k))
    w = rng.integers(lo, hi, (k, n))
    if kind == "extreme":
        a, b = np.unravel_index(int(np.argmax(table)), table.shape)
        x[: m // 2] = a - off
        w[:, : n // 2] = b - off
    elif kind == "column":
        w = rng.integers(lo, hi, (k, 1))
    elif kind == "conflict-free":
        x[:] = rng.integers(lo, hi)
        w = ((2 * np.arange(n)[None, :] + 64 * (np.arange(k)[:, None] % 4))
             % 256) - off
    return (np.ascontiguousarray(x, np.int32),
            np.ascontiguousarray(w, np.int32))


def _lut_rows(rng, dev, lib, x9, w9, specs) -> list:
    import numpy as np
    import torch

    from repro_torch.kernels.approx_matmul import (
        LUT_SHARED_MIN_WORK, PackedLut, launch_lut, lut_matmul,
        lut_matmul_kernel, lut_route,
    )

    rep = "src/repro/kernels/approx_matmul/kernel.py:132"
    rows = []

    def row(route, case, kernel_fn, plain_fn, m, k, n, repeats=10, calls=1):
        return _kernel_row(
            route, case, f"src/repro_torch/csrc/{route}.cu", rep, kernel_fn,
            plain_fn, _byte_equal,
            nbytes=calls * 4.0 * (65536 + m * k + k * n + m * n), ops=0.0,
            lookups=calls * float(m) * n * k, repeats=repeats)

    # the nine gaussian slot groups of a variant, one launch each, each
    # with its table packed (and uploaded on the first call) beforehand
    m9 = x9.shape[0]
    groups = [(x9[:, g:g + 1].contiguous(), w9[g:g + 1].contiguous(),
               PackedLut(sp.table), torch.from_numpy(sp.table).to(dev))
              for g, sp in enumerate(specs)]
    rows.append(row(
        lut_route(m9, 1, 1, True), f"9 slot groups ({m9},1)@(1,1) (9 launches)",
        lambda: torch.stack([lut_matmul_kernel(x, w, p)
                             for x, w, p, _ in groups]),
        lambda: torch.stack([lut_matmul(x, w, t) for x, w, _, t in groups]),
        m9, 1, 1, repeats=20, calls=len(groups)))

    s0 = round(LUT_SHARED_MIN_WORK ** (1 / 3))
    cases = LUT_CASES + [
        (s, s, s, "mul8u_bam6", "uniform",
         f"{'under' if s ** 3 < LUT_SHARED_MIN_WORK else 'over'} the "
         f"crossover m*n*k = {LUT_SHARED_MIN_WORK}")
        for s in (s0 * 3 // 4, s0 * 5 // 4)]
    for m, k, n, cname, kind, label in cases:
        if cname == "wide":
            table = rng.integers(-40000, 70000, (256, 256)).astype(np.int32)
            signed = False
        else:
            table = lib[cname].table.astype(np.int32)
            signed = lib[cname].signed
        x, w = (torch.from_numpy(a).to(dev) for a in _lut_operands(
            rng, m, k, n, signed, kind, table))
        packed = PackedLut(table)
        t_dev = torch.from_numpy(table).to(dev)
        if "L2 route" in label:
            route = "lut_matmul"
            fn = lambda x=x, w=w, p=packed, s=signed: launch_lut(
                "lut_matmul", x, w, p, signed=s)
        else:
            route = lut_route(m, n, k, packed.fits16)
            fn = lambda x=x, w=w, p=packed, s=signed: lut_matmul_kernel(
                x, w, p, signed=s)
        rows.append(row(
            route, f"({m},{k})@({k},{n}) {cname} {kind} ({label})", fn,
            lambda x=x, w=w, t=t_dev, s=signed: lut_matmul(x, w, t, signed=s),
            m, k, n, repeats=5 if k > 4096 else 10))
    return rows


# rank_k as the first launch of a fresh process, at 9 groups whose ranks
# sum to 23: 47320 bytes of dynamic shared memory, which with the
# kernel's 2176 bytes of static tiles passes the 48 KB a block has until
# the launch raises the attribute.  A process-pool child met exactly
# this (the parent had always raised it on an earlier, larger variant).
_RANK_K_FRESH = """
import sys
sys.path.insert(0, {src!r})
import numpy as np, torch
from repro_torch import _build
from repro_torch.kernels.approx_matmul import (
    grouped_rank_k_matmul, grouped_rank_k_matmul_kernel)
from repro_torch.kernels.approx_matmul.ops import _pack
rng = np.random.default_rng(0)
packed = _pack([(i, i + 1, rng.standard_normal((256, r)).astype(np.float32),
                 rng.standard_normal((256, r)).astype(np.float32), False, 0)
                for i, r in enumerate([3, 3, 3, 3, 3, 2, 2, 2, 2])])
x = torch.from_numpy(rng.integers(0, 256, (900, 9)).astype(np.int32)).cuda()
w = torch.from_numpy(rng.integers(0, 256, (9, 1)).astype(np.int32)).cuda()
got = grouped_rank_k_matmul_kernel(x, w, packed)
want = grouped_rank_k_matmul(x, w, torch.from_numpy(packed).cuda())
torch.testing.assert_close(got, want, rtol={rtol}, atol={atol})
print(float((got - want).abs().max()), _build.LAUNCHES["rank_k"])
"""


def phase_rank_k_fresh() -> dict:
    """``_RANK_K_FRESH`` in a new process: builds nothing (the build phase
    did), launches once, agrees with the plain version."""
    proc = subprocess.run(
        [sys.executable, "-c", _RANK_K_FRESH.format(
            src=str(ROOT / "src"), rtol=RANK_RTOL, atol=RANK_ATOL)],
        capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"rank_k as a fresh process's first launch: {proc.stderr[-2000:]}")
    err, launches = proc.stdout.split()
    out = {"phase": "kernel_rank_k_fresh_process", "n_uv": 11776,
           "dynamic_smem_bytes": 47320, "static_smem_bytes": 2176,
           "max_abs_err": float(err), "launches": int(launches)}
    emit(out)
    return out


# profiler windows that came back with no device time (CUPTI delivered
# no kernel record; seen once on the H100 machine): each is
# profiled again, up to DEVICE_MS_WINDOWS in all
DEVICE_MS_WINDOWS = 3
EMPTY_PROFILER_WINDOWS = []


def device_ms(fn, *, calls: int = 20) -> float:
    """Card time of one ``fn()`` without the host's launch rate: the
    device time of every kernel and memset in a ``torch.profiler`` window
    of ``calls`` back-to-back calls, over the count (after a warm-up
    call).  A window that holds no device time is profiled again (and
    counted in ``EMPTY_PROFILER_WINDOWS``); none in ``DEVICE_MS_WINDOWS``
    fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_MS_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev_s, _ = _device_time(prof)
        if dev_s is not None:
            break
        EMPTY_PROFILER_WINDOWS.append(time.perf_counter() - _T0)
    check(dev_s is not None, f"{DEVICE_MS_WINDOWS} profiler windows hold no "
                             "device time")
    return dev_s * 1e3 / calls


def phase_lut_crossover(seed: int) -> dict:
    """Both lut_matmul kernels at the cubes of ``LUT_SWEEP``, each against
    its plain version first, timed as the kernel rows are (``ms``, which
    a call shorter than the host's launch interval does not resolve) and
    on the card alone (``device_ms``): where the shared-memory route
    overtakes the L2 one, against ``LUT_SHARED_MIN_WORK``.  Then the
    shared-memory kernel at (512, k) @ (k, 512) for the k of
    ``LUT_K_SWEEP`` on uniform and on conflict-free operands, with the
    least-squares line of its device time in k: the intercept is what a
    call costs besides its lookups."""
    import numpy as np
    import torch

    from repro_torch.core.acl.library import default_library
    from repro_torch.kernels.approx_matmul import (
        LUT_SHARED_MIN_WORK, PackedLut, launch_lut, lut_matmul,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    table = default_library()["mul8u_bam6"].table.astype(np.int32)
    packed = PackedLut(table)
    t_dev = torch.from_numpy(table).to(dev)
    routes = ("lut_matmul", "lut_matmul_sm90")
    sweep = []
    for s in LUT_SWEEP:
        x, w = (torch.from_numpy(a).to(dev) for a in _lut_operands(
            rng, s, s, s, False, "uniform", table))
        want = lut_matmul(x, w, t_dev)
        point = {"m": s, "n": s, "k": s, "work": s ** 3}
        for route in routes:
            fn = lambda x=x, w=w, r=route: launch_lut(r, x, w, packed)
            _byte_equal(fn(), want, f"crossover {route} at {s}^3")
            point[route + "_ms"] = time_ms(fn)
            point[route + "_device_ms"] = device_ms(fn)
        sweep.append(point)
    # the least work from which the shared route's card time wins at
    # every larger cube
    first = None
    for p in reversed(sweep):
        if p["lut_matmul_sm90_device_ms"] >= p["lut_matmul_device_ms"]:
            break
        first = p["work"]
    k_sweep = {}
    for kind in ("uniform", "conflict-free"):
        pts = []
        for k in LUT_K_SWEEP:
            x, w = (torch.from_numpy(a).to(dev) for a in _lut_operands(
                rng, 512, k, 512, False, kind, table))
            fn = lambda x=x, w=w: launch_lut("lut_matmul_sm90", x, w, packed)
            _byte_equal(fn(), lut_matmul(x, w, t_dev),
                        f"k sweep {kind} at k={k}")
            pts.append({"k": k, "device_ms": device_ms(fn)})
        slope, icept = np.polyfit([p["k"] for p in pts],
                                  [p["device_ms"] for p in pts], 1)
        k_sweep[kind] = {"points": pts, "ms_per_k": float(slope),
                         "intercept_ms": float(icept)}
    out = {"phase": "kernel_lut_crossover", "sweep": sweep,
           "empty_profiler_windows": len(EMPTY_PROFILER_WINDOWS),
           "shared_route_faster_from": first,
           "LUT_SHARED_MIN_WORK": LUT_SHARED_MIN_WORK,
           "k_sweep_512x512": k_sweep}
    emit(out)
    return out


def _causal_pairs(sq: int, sk: int, q_offset: int, causal: bool) -> int:
    """(query, key) pairs the mask leaves visible: the work this run's
    inputs need."""
    if not causal:
        return sq * sk
    return sum(min(sk, i + q_offset + 1) for i in range(sq))


def _flash_rows(rng, dev) -> list:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention, flash_attention_kernel, kernel_route,
    )

    rep = "src/repro/kernels/flash_attention/kernel.py:77"
    rows = []
    for b, h, kvh, sq, sk, d, off, causal, dtype, label in FLASH_CASES:
        dt = getattr(torch, dtype)
        route = kernel_route(dt, d)
        tensor_cores = route == "flash_attention_sm90"
        def draw(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev, dt)
        q, k, v = draw(b, h, sq, d), draw(b, kvh, sk, d), draw(b, kvh, sk, d)
        bf16 = dt == torch.bfloat16
        esz = q.element_size()
        # the pairs this row's mask leaves visible, causal or not
        pairs = _causal_pairs(sq, sk, off, causal) * b * h
        ops = 4.0 * d * pairs              # q.k and p.v, 2 flops per FMA
        nbytes = esz * (2 * q.numel() + k.numel() + v.numel())
        if not causal or (sq == sk and off == 0):
            library_fn = (
                lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(
                    q, k, v, is_causal=c, enable_gqa=True))
        else:
            # SDPA's is_causal aligns the mask to the top-left corner; a
            # shifted mask (j <= i + q_offset) goes in as a boolean mask,
            # built outside the timed region
            mask = (torch.arange(sk, device=dev)[None, :]
                    <= torch.arange(sq, device=dev)[:, None] + off)
            library_fn = (
                lambda q=q, k=k, v=v, mask=mask: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True))
        rows.append(_kernel_row(
            route,
            f"b={b} h={h} kvh={kvh} sq={sq} sk={sk} d={d} q_offset={off} "
            f"{'bf16' if bf16 else 'f32'} "
            f"{'causal' if causal else 'non-causal'} ({label})",
            f"src/repro_torch/csrc/{route}.cu", rep,
            lambda q=q, k=k, v=v, off=off, c=causal: flash_attention_kernel(
                q, k, v, causal=c, q_offset=off),
            lambda q=q, k=k, v=v, off=off, c=causal: attention(
                q, k, v, causal=c, q_offset=off, impl="plain"),
            _close(FLASH_BF16_RTOL, FLASH_BF16_ATOL) if bf16
            else _close(FLASH_RTOL, FLASH_ATOL),
            nbytes=nbytes, ops=ops, repeats=10 if bf16 else 20,
            library_fn=library_fn, library_compare=_close(SDPA_RTOL, SDPA_ATOL),
            extra={"causal": causal, "tensor_core_bound_ms": max(
                nbytes / HBM_BYTES_PER_S, ops / TENSOR_CORE_BF16_OPS_PER_S)
                * 1e3},
            ops_per_s=(TENSOR_CORE_BF16_OPS_PER_S if tensor_cores
                       else CUDA_CORE_OPS_PER_S),
            exps=float(pairs),   # one softmax exponential per visible pair
        ))
    return rows


def _close_to_max(rtol, frac):
    """allclose with an absolute tolerance of ``frac`` of the largest
    element of the plain version's output."""
    def compare(got, want, what):
        import torch

        for g, w in zip(got, want):
            check(bool(torch.isfinite(g).all()), f"{what}: not finite")
            atol = frac * float(w.float().abs().max())
            check(torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol),
                  f"{what}: outside rtol {rtol}, atol {atol:.3g} (max |diff| "
                  f"{_max_err(g, w):.3g})")
    return compare


def _flash_lse_rows(rng, dev) -> list:
    """The log-sum-exp the tensor-core forward writes for the backward,
    against ``attention_lse_ref``: the same natural-log, scaled units
    the backward's P = exp(scale q.k - lse) assumes, which no CPU test
    can show."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import (
        attention_lse_ref, flash_attention_kernel,
    )

    rows = []
    for b, h, kvh, s, d, label in FLASH_LSE_CASES:
        def draw(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(
                    dev, torch.bfloat16)
        q, k, v = draw(b, h, s, d), draw(b, kvh, s, d), draw(b, kvh, s, d)
        # the library's flash attention with its log-sum-exp, on K/V
        # expanded to the query heads (outside the timing)
        ke, ve = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))
        pairs = _causal_pairs(s, s, 0, True) * b * h
        ops = 4.0 * d * pairs
        # q, k, v read; the output and the log-sum-exp written
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4.0 * b * h * s
        rows.append(_kernel_row(
            "flash_attention_sm90",
            f"b={b} h={h} kvh={kvh} s={s} d={d} bf16 causal, log-sum-exp "
            f"output ({label})",
            "src/repro_torch/csrc/flash_attention_sm90.cu",
            "src/repro/kernels/flash_attention/kernel.py:77",
            lambda q=q, k=k, v=v: flash_attention_kernel(
                q, k, v, causal=True, with_lse=True)[1],
            lambda q=q, k=k: attention_lse_ref(q, k, causal=True),
            _close(FLASH_LSE_RTOL, FLASH_LSE_ATOL),
            nbytes=nbytes, ops=ops, repeats=10,
            library_fn=lambda q=q, ke=ke, ve=ve: (
                torch.ops.aten._scaled_dot_product_flash_attention(
                    q, ke, ve, 0.0, True)[1]),
            extra={"library_call": "torch.ops.aten."
                                   "_scaled_dot_product_flash_attention "
                                   "(K/V expanded to the query heads), its "
                                   "log-sum-exp"},
            ops_per_s=TENSOR_CORE_BF16_OPS_PER_S, exps=float(pairs)))
    return rows


# the tensor-core backward's launches, by kernel name in a trace
BWD_SM90_LAUNCHES = ("bwd_delta_kernel", "bwd_dq_kernel", "bwd_dkdv_kernel",
                     "bwd_reduce_kernel")


def _bwd_split(kernel, calls: int = 5) -> dict:
    """Device ms of each of the tensor-core backward's launches, a call's
    mean over ``calls`` profiled calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kernel()
        torch.cuda.synchronize()
    split = {}
    for name in BWD_SM90_LAUNCHES:
        sec, _ = _device_time(prof, name)
        split[name] = sec * 1e3 / calls if sec else None
    return split


def _flash_bwd_rows(rng, dev) -> list:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, bwd_route, flash_attention_bwd_kernel,
        flash_attention_kernel,
    )

    rows = []
    for b, h, kvh, s, d, causal, dtype, label in FLASH_BWD_CASES:
        dt = getattr(torch, dtype)
        bf16 = dt == torch.bfloat16
        route = bwd_route(dt, d)
        sq, sk = s if isinstance(s, tuple) else (s, s)

        def draw(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev, dt)
        q, k, v, do = (draw(b, h, sq, d), draw(b, kvh, sk, d),
                       draw(b, kvh, sk, d), draw(b, h, sq, d))
        # the tensor-core backward takes the log-sum-exp the forward
        # kernel wrote, never one computed in plain torch
        lse = None
        if route == "flash_attention_bwd_sm90":
            out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                              with_lse=True)
        else:
            out = flash_attention_kernel(q, k, v, causal=causal)

        def kernel(q=q, k=k, v=v, out=out, do=do, c=causal, lse=lse):
            return flash_attention_bwd_kernel(q, k, v, out, do, causal=c,
                                              lse=lse)
        extra = {}
        if (b, h, kvh, s, d) == FLASH_BWD_SAME_BITS and bf16:
            first, second = kernel(), kernel()
            same = all(bool(torch.equal(x, y))
                       for x, y in zip(first, second))
            check(same, f"{route}[{label}]: two launches on the same inputs "
                        "differ")
            extra["same_bits_twice"] = same
            extra["device_ms_by_launch"] = _bwd_split(kernel)
            del first, second
        # SDPA's backward alone: its forward runs once, outside the timing
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lout = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                              enable_gqa=True)
        pairs = _causal_pairs(sq, sk, 0, causal) * b * h
        esz = q.element_size()
        if bf16:
            # bf16 operands: the bound is the card's bf16 tensor-core
            # rate; the float32 CUDA-core figure is kept beside it
            extra["cuda_core_bound_ms"] = max(
                esz * 4.0 * (q.numel() + k.numel()) / HBM_BYTES_PER_S,
                10.0 * d * pairs / CUDA_CORE_OPS_PER_S) * 1e3
        rows.append(_kernel_row(
            route,
            (f"b={b} h={h} kvh={kvh} s={sq} d={d} " if sq == sk else
             f"b={b} h={h} kvh={kvh} sq={sq} sk={sk} d={d} ") +
            f"{'bf16' if bf16 else 'f32'} "
            f"{'causal' if causal else 'non-causal'} ({label})",
            f"src/repro_torch/csrc/{route}.cu",
            "none (the gradient of src/repro/kernels/flash_attention/"
            "kernel.py:77, which has no backward; the JAX package "
            "differentiates its chunked XLA form)",
            kernel,
            lambda q=q, k=k, v=v, do=do, c=causal: attention_bwd_ref(
                q, k, v, do, causal=c),
            (_close_to_max(FLASH_BWD_BF16_RTOL, FLASH_BWD_BF16_FRAC) if bf16
             else _close(FLASH_RTOL, FLASH_ATOL)),
            # q, k, v, the output and its gradient read; dq, dk, dv written
            nbytes=esz * 4.0 * (q.numel() + k.numel()),
            # five products of 2 d flops a visible pair: the scores again,
            # dP, dV, dK, dQ
            ops=10.0 * d * pairs, repeats=5, plain_repeats=2,
            library_fn=lambda lout=lout, ql=ql, kl=kl, vl=vl, do=do: tuple(
                torch.autograd.grad(lout, (ql, kl, vl), do,
                                    retain_graph=True)),
            library_compare=_close_to_max(0.0, SDPA_BWD_FRAC),
            extra=extra or None,
            ops_per_s=(TENSOR_CORE_BF16_OPS_PER_S if bf16
                       else CUDA_CORE_OPS_PER_S),
            exps=float(pairs),   # one exponential a visible pair at least
        ))
        del out, lout, ql, kl, vl, lse
    return rows


def _scan_rows(rng, dev) -> list:
    import numpy as np
    import torch

    from repro_torch.kernels.selective_scan import (
        selective_scan, selective_scan_kernel,
    )

    src = "src/repro_torch/csrc/selective_scan.cu"
    rep = "src/repro/kernels/selective_scan/kernel.py:66"
    rows = []
    for b, s, di, n, label in SCAN_CASES:
        # drawn as _inputs in tests/test_kernels_scan.py
        arrs = (rng.standard_normal((b, s, di)),
                rng.uniform(0.01, 0.2, (b, s, di)),
                -rng.uniform(0.5, 2.0, (di, n)),
                rng.standard_normal((b, s, n)),
                rng.standard_normal((b, s, n)),
                rng.standard_normal((b, di, n)) * 0.1)
        x, dt, A, B, C, h0 = (torch.from_numpy(a.astype(np.float32)).to(dev)
                              for a in arrs)
        wide = b * di > 4096
        tol = SCAN_WIDE_TOL if wide else SCAN_RTOL
        rows.append(_kernel_row(
            "selective_scan", f"b={b} s={s} di={di} n={n} f32 ({label})",
            src, rep,
            lambda x=x, dt=dt, A=A, B=B, C=C, h0=h0: selective_scan_kernel(
                x, dt, A, B, C, h0),
            lambda x=x, dt=dt, A=A, B=B, C=C, h0=h0: selective_scan(
                x, dt, A, B, C, h0, impl="plain"),
            _close(tol, tol if wide else SCAN_ATOL),
            nbytes=4.0 * (3 * b * s * di + 2 * b * s * n + di * n
                          + 2 * b * di * n),
            ops=float(b) * s * di * (7 * n + 1),
            exps=float(b) * s * di * n,
            repeats=10 if wide else 20, plain_repeats=2 if wide else 5,
        ))
    return rows


def _scan_draw(rng, dev, b, s, di, n):
    """x, dt, A, B, C, h0, drawn as ``_inputs`` in
    tests/test_kernels_scan.py, then dy and dhT, on the card."""
    import numpy as np
    import torch

    arrs = (rng.standard_normal((b, s, di)),
            rng.uniform(0.01, 0.2, (b, s, di)),
            -rng.uniform(0.5, 2.0, (di, n)),
            rng.standard_normal((b, s, n)),
            rng.standard_normal((b, s, n)),
            rng.standard_normal((b, di, n)) * 0.1,
            rng.standard_normal((b, s, di)),
            rng.standard_normal((b, di, n)) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


def _plain_with_states(x, dt, A, B, C, h0):
    """The plain scan run a chunk at a time: (y, hT, the state entering
    each chunk), the forward kernel's outputs with ``with_states``."""
    import torch

    from repro_torch.kernels.selective_scan import (
        SCAN_CHUNK, selective_scan_ref,
    )

    ys, hs, h = [], [], h0
    for t0 in range(0, x.shape[1], SCAN_CHUNK):
        hs.append(h)
        y, h = selective_scan_ref(*(t[:, t0:t0 + SCAN_CHUNK]
                                    for t in (x, dt)), A,
                                  *(t[:, t0:t0 + SCAN_CHUNK] for t in (B, C)),
                                  h)
        ys.append(y)
    return torch.cat(ys, 1), h, torch.stack(hs, 1)


def _scan_bwd_rows(rng, dev) -> list:
    """Row 5b: the backward kernel against ``selective_scan_bwd_ref``;
    then the forward with chunk states beside the forward without."""
    import torch

    from repro_torch.kernels.selective_scan import (
        BWD_CHANNELS, SCAN_CHUNK, selective_scan_bwd_kernel,
        selective_scan_bwd_ref, selective_scan_kernel,
    )

    rows = []
    for b, s, di, n, label in SCAN_BWD_CASES:
        x, dt, A, B, C, h0, dy, dhT = _scan_draw(rng, dev, b, s, di, n)
        _, _, hc = selective_scan_kernel(x, dt, A, B, C, h0,
                                         with_states=True)
        wide = b * di > 4096
        tol = SCAN_WIDE_TOL if wide else SCAN_RTOL

        def kernel(x=x, dt=dt, A=A, B=B, C=C, hc=hc, dy=dy, dhT=dhT):
            return selective_scan_bwd_kernel(x, dt, A, B, C, hc, dy, dhT)

        def plain(x=x, dt=dt, A=A, B=B, C=C, dy=dy, h0=h0, dhT=dhT):
            return selective_scan_bwd_ref(x, dt, A, B, C, dy, h0, dhT)
        # the partials the launch writes and its second launch reads back
        # (bytes written plus bytes read): dB, dC one a block, dA one a
        # batch row
        nblk = -(-di // BWD_CHANNELS)
        extra = {"dbdc_partials": nblk,
                 "dbdc_partial_bytes_moved": 2 * 2 * nblk * b * s * n * 4,
                 "da_partial_bytes_moved": 2 * b * di * n * 4}
        if (b, s, di, n) == SCAN_BWD_SAME_BITS:
            first, second = kernel(), kernel()
            same = all(bool(torch.equal(p, r))
                       for p, r in zip(first, second))
            check(same, f"selective_scan_bwd[{label}]: two launches on the "
                        "same inputs differ")
            extra["same_bits_twice"] = same
            del first, second
        close = _close_named(tol, tol if wide else SCAN_ATOL,
                             SCAN_BWD_OUTPUTS)

        def compare(got, want, what, extra=extra, close=close):
            # the largest difference and element of each output, for the
            # record
            extra["max_abs_err_by_output"] = {
                k: _max_err(g, w)
                for k, g, w in zip(SCAN_BWD_OUTPUTS, got, want)}
            extra["max_abs_by_output"] = {
                k: float(w.abs().max())
                for k, w in zip(SCAN_BWD_OUTPUTS, want)}
            close(got, want, what)
        nc = hc.shape[1]
        rows.append(_kernel_row(
            "selective_scan_bwd",
            f"b={b} s={s} di={di} n={n} f32, h0 and dhT ({label})",
            "src/repro_torch/csrc/selective_scan_bwd.cu",
            "none (the gradient of src/repro/kernels/selective_scan/"
            "kernel.py:66, which has no backward; the JAX package "
            "differentiates its chunked XLA scan, src/repro/models/ssm.py:"
            "75-126)",
            kernel, plain, compare,
            # x, dt, dy read, dx, ddt written; B, C read, dB, dC written;
            # the chunk states read; A, dhT read, dA, dh0 written
            nbytes=4.0 * (5 * b * s * di + 4 * b * s * n + b * nc * di * n
                          + 2 * di * n + 2 * b * di * n),
            # per (step, channel, state): the state again (3), G, dB, dC,
            # the two sums over states, the carry, G a h, dA (15 flops);
            # per (step, channel): dt x, dx, ddt (4)
            ops=float(b) * s * di * (18 * n + 5),
            exps=float(b) * s * di * n,   # a_t, once at least
            repeats=10 if wide else 20, plain_repeats=1 if wide else 3,
            extra=extra,
        ))
        del x, dt, A, B, C, h0, dy, dhT, hc

    b, s, di, n = SCAN_STATES_CASE
    x, dt, A, B, C, h0, _, _ = _scan_draw(rng, dev, b, s, di, n)
    no_states_ms = time_ms(lambda: selective_scan_kernel(x, dt, A, B, C, h0),
                           repeats=10)
    rows.append(_kernel_row(
        "selective_scan",
        f"b={b} s={s} di={di} n={n} f32 (falcon-mamba-7b prefill width), "
        "with chunk states (a training forward)",
        "src/repro_torch/csrc/selective_scan.cu",
        "src/repro/kernels/selective_scan/kernel.py:66",
        lambda: selective_scan_kernel(x, dt, A, B, C, h0, with_states=True),
        lambda: _plain_with_states(x, dt, A, B, C, h0),
        _close(SCAN_WIDE_TOL, SCAN_WIDE_TOL),
        nbytes=4.0 * (3 * b * s * di + 2 * b * s * n + di * n
                      + 2 * b * di * n + b * -(-s // SCAN_CHUNK) * di * n),
        ops=float(b) * s * di * (7 * n + 1),
        exps=float(b) * s * di * n,
        repeats=10, plain_repeats=2,
        extra={"no_states_ms": no_states_ms},
    ))
    del x, dt, A, B, C, h0
    return rows


def _random_genomes(acc, lib, n: int, rng):
    import numpy as np

    sizes = acc.gene_sizes(lib)
    g = rng.integers(0, sizes[None, :], size=(n, len(sizes)))
    g[0] = acc.exact_genome(lib)
    return np.asarray(g, dtype=np.int64)


def _check_labels(labels: dict, n: int, what: str) -> None:
    import numpy as np

    from repro_torch.core.features.synth import LABEL_KEYS

    for k in LABEL_KEYS:
        v = np.asarray(labels[k])
        check(v.shape == (n,) and np.all(np.isfinite(v)),
              f"{what}: label {k} not finite of shape ({n},)")


# the 2-D DCT and the smoothed-DCT pipeline label one batch of 1000, not
# two: the warm second batch is measured on gaussian3x3
LABELS_REDUCED = {
    "batches": {"earlier": 2, "run": 1},
    "why": "the script's wall (the training lines of seamless, qwen, "
           "compression and the cluster CLI joined it): the second, warm "
           "batch took 6.0 and 11.2 s on an H100 80GB HBM3 at 700 W and is "
           "measured on gaussian3x3"}


def _label_accels():
    """(accelerator, label batches of 1000, the line's ``reduced``) of the
    labels phase, in the order the main path takes them: gaussian3x3, the
    MCM rows, the 2-D DCT, the smoothed-DCT pipeline and its two stage
    views."""
    from repro_torch.accel import (
        GaussianFilter, HEVCDct, MCMAccelerator, SmoothedDct,
    )

    smoothed = SmoothedDct()
    return ([(GaussianFilter(), 2, None)]
            + [(MCMAccelerator(r), 1, None) for r in range(4)]
            + [(HEVCDct(), 1, LABELS_REDUCED),
               (smoothed, 1, LABELS_REDUCED)]
            + [(view, 1, None) for view in smoothed.stage_views()])


def predicted_runs(acc, lib, genomes, *, structural: bool = True) -> dict:
    """Deployment runs a fresh ``SynthCache`` pays for ``genomes``,
    counted on the host from the accelerator's ``deploy_signature``: one
    a distinct structure plus, per graph family, min(K, identities that
    collide with a structure already run) verification runs (K is
    ``_STRUCT_VERIFY_SAMPLES``); with the structural tier off, one a
    unique identity."""
    from repro_torch.core.features import synth
    from repro_torch.kernels.approx_matmul import from_circuit

    mul_idx = acc.mul_slot_indices()
    fams: dict = {}
    for g in genomes:
        circuits, ranks = acc.decode(g, lib)
        specs = [from_circuit(circuits[i], r) for i, r in zip(mul_idx, ranks)]
        family, classes = acc.deploy_signature(specs)
        ids, structs = fams.setdefault(repr(family), (set(), set()))
        ids.add(synth._identity_signature(acc, specs))
        structs.add(repr(classes))
    identities = sum(len(i) for i, _ in fams.values())
    structures = sum(len(st) for _, st in fams.values())
    verify = sum(min(synth._STRUCT_VERIFY_SAMPLES, len(i) - len(st))
                 for i, st in fams.values())
    return {"identities": identities, "families": len(fams),
            "structures": structures, "verify_runs": verify,
            "runs": structures + verify if structural else identities}


def phase_labels(acc, batches: int, seed: int, *,
                 structural: bool = True, reduced=None) -> dict:
    """``default_labeler(acc, lib, n_qor_samples=4, device="cuda")`` on
    ``batches`` batches of 1000 numpy-seeded genomes (the second warm),
    through a fresh ``SynthCache`` (``structural=False``: with the
    structural tier off, as ``REPRO_SYNTH_STRUCTURAL=0`` sets it).
    ``qor`` and ``energy`` must be bit-identical to ``device="cpu"`` on a
    64-genome subset (labeled through a cache of its own), ``qor`` to the
    per-genome numpy ``Accelerator.qor`` on 8 genomes; the runs paid must
    be ``predicted_runs`` and rank_k must launch exactly its deployment's
    launches (``DEPLOY_LAUNCHES``) once per run paid."""
    import numpy as np
    import torch

    from repro_torch import _build
    from repro_torch.core.acl.library import default_library
    from repro_torch.core.dse import default_labeler
    from repro_torch.core.features import synth

    lib = default_library()
    rng = np.random.default_rng(seed)
    gs = [_random_genomes(acc, lib, 1000, rng) for _ in range(batches)]
    pred = predicted_runs(acc, lib, np.concatenate(gs), structural=structural)

    scache = synth.SynthCache()
    ctx_cache: dict = {}   # one entry per unique variant labeled
    keep = synth.STRUCTURAL_KEYS
    synth.STRUCTURAL_KEYS = structural
    try:
        _build.reset_launches()
        labeler = default_labeler(acc, lib, n_qor_samples=4, cache=ctx_cache,
                                  synth_cache=scache, device="cuda")
        labs, walls = [], []
        for g in gs:
            t0 = time.perf_counter()
            labs.append(labeler(g))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = dict(_build.LAUNCHES)
    finally:
        synth.STRUCTURAL_KEYS = keep
    stats = scache.stats()

    what = f"labels {acc.name}" + ("" if structural else " (identity only)")
    for i, (g, lab) in enumerate(zip(gs, labs)):
        _check_labels(lab, len(g), f"{what} batch {i + 1}")
    check(labs[0]["qor"][0] == 100.0, f"{what}: exact genome's QoR is not "
                                      "100.0")
    for k in MAIN_PATH["labels"]:
        check(launches[k] > 0, f"{what}: launched no {k} kernel")
    per_variant = DEPLOY_LAUNCHES[acc.name]
    runs_paid = stats["compiles"]
    check(launches["rank_k"] == per_variant * runs_paid,
          f"{what}: launched rank_k {launches['rank_k']} times for "
          f"{runs_paid} deployment runs paid, {per_variant} launches each")
    check(runs_paid == pred["runs"] and stats["pinned_families"] == 0,
          f"{what}: paid {runs_paid} runs ({stats}), predicted {pred}")
    check(len(ctx_cache) == pred["identities"],
          f"{what}: {len(ctx_cache)} unique variants, predicted "
          f"{pred['identities']}")
    sub = 64
    cpu = default_labeler(acc, lib, n_qor_samples=4,
                          synth_cache=synth.SynthCache(),
                          device="cpu")(gs[0][:sub])
    for k in ("qor", "energy"):
        check(np.array_equal(cpu[k], labs[0][k][:sub]),
              f"{what}: cuda {k} differs from cpu on the {sub}-genome subset")
    inputs = acc.sample_inputs(4, seed=1234)
    for t in range(8):
        circuits, _ = acc.decode(gs[0][t], lib)
        check(acc.qor(circuits, inputs) == labs[0]["qor"][t],
              f"{what}: cuda qor of genome {t} differs from the per-genome "
              "numpy qor")
    out = {
        "phase": "labels", "accel": acc.name, "structural": structural,
        "genomes": [len(g) for g in gs],
        "batch_s": walls,
        "labels_per_s": [len(g) / w for g, w in zip(gs, walls)],
        "sim_s": [float(lab["sim_time"].sum()) for lab in labs],
        "synth_s": [float(lab["synth_time"].sum()) for lab in labs],
        "cpu_subset_bit_identical": {"genomes": sub, "keys": ["qor", "energy"]},
        "unique_variants_synthesized": len(ctx_cache),
        "runs_paid": runs_paid, "predicted": pred, "synth_cache": stats,
        "rank_k_launches_per_variant": per_variant,
        "reduced": reduced,
        "launches": launches,
    }
    emit(out)
    return out


def phase_dse(acc, generations: int) -> tuple:
    """``run_dse`` at the paper's widths; returns (its line, the result)."""
    import numpy as np
    import torch

    from repro_torch import _build
    from repro_torch.core.acl.library import default_library
    from repro_torch.core.dse import DSEConfig, default_labeler, run_dse
    from repro_torch.core.features import synth
    from repro_torch.core.nsga2 import NSGA2Config

    lib = default_library()
    # the JAX package's default power surrogate (bayesian_ridge) hits a
    # singular system on 1000 labels of gaussian3x3: its energy is an
    # exact linear function of the features.  Ridge regularizes.
    cfg = DSEConfig(
        n_train=1000, n_qor_samples=4, hw_model="ridge",
        nsga=NSGA2Config(pop_size=1000, n_parents=200,
                         n_generations=generations),
    )
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run_dse(acc, lib, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    for k in MAIN_PATH["dse"]:
        check(launches[k] > 0, f"dse {acc.name}: launched no {k} kernel")
    front_g = res.front_genomes
    front_o = res.front_objectives
    check(len(front_g) > 0 and np.all(np.isfinite(front_o)),
          f"dse {acc.name}: front empty or not finite")
    # the search must trade QoR for energy: designs below the front's best
    # QoR (the exact design's) are what the cpu re-label then checks
    front_qor = -front_o[:, 0]
    n_approx = int(np.sum(front_qor < front_qor.max()))
    check(n_approx > 0,
          f"dse {acc.name}: the front holds no approximate design")
    cpu = default_labeler(acc, lib, n_qor_samples=4,
                          synth_cache=synth.SynthCache(),
                          device="cpu")(front_g)
    check(np.array_equal(-cpu["qor"], front_o[:, 0])
          and np.array_equal(cpu["energy"], front_o[:, 1]),
          f"dse {acc.name}: front objectives differ from a cpu re-label")
    out = {
        "phase": "dse", "accel": acc.name, "wall_s": wall,
        "n_train": cfg.n_train, "pop_size": cfg.nsga.pop_size,
        "n_parents": cfg.nsga.n_parents, "n_qor_samples": cfg.n_qor_samples,
        "reduced": {"n_generations": {"paper": 1000, "repo_default": 100,
                                      "run": generations},
                    "hw_model": {"repo_default": "bayesian_ridge",
                                 "run": "ridge"}},
        "front_size": int(len(front_g)),
        "front_approximate": n_approx,
        "front_qor_range": [float(-front_o[:, 0].max()),
                            float(-front_o[:, 0].min())],
        "val_pcc": res.val_pcc, "timings_s": res.timings,
        "launches": launches,
    }
    emit(out)
    return out, res


def _label_once(labeler, genomes):
    """(labels, wall seconds, launches) of one labeler call, the launch
    counts set to 0 just before it."""
    import torch

    from repro_torch import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    labels = labeler(genomes)
    torch.cuda.synchronize()
    return labels, time.perf_counter() - t0, dict(_build.LAUNCHES)


def _add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase_cache(acc, seed: int) -> dict:
    """The persistent synthesis cache on the card, in a temporary
    directory, for a ``.jsonl`` file and a ``.segd`` root
    (``open_synth_cache``): a cold 1000-genome batch, then a new cache
    object on the same path and the same batch again, which must launch
    no rank_k, pay no run, answer every unique variant from the identity
    tier and give labels equal to the cold ones."""
    import tempfile

    import numpy as np

    from repro_torch.core.acl.library import default_library
    from repro_torch.core.dse import default_labeler
    from repro_torch.core.features import synth

    lib = default_library()
    g = _random_genomes(acc, lib, 1000, np.random.default_rng(seed))
    what = f"cache {acc.name}"
    per_variant = DEPLOY_LAUNCHES[acc.name]
    out = {"phase": "cache", "accel": acc.name, "genomes": len(g)}
    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("jsonl", "segd"):
            path = str(Path(tmp) / f"{acc.name}.{backend}")
            runs = {}
            for run in ("cold", "warm"):
                cache = synth.open_synth_cache(path)
                ctx: dict = {}
                labeler = default_labeler(acc, lib, n_qor_samples=4,
                                          cache=ctx, synth_cache=cache,
                                          device="cuda")
                labels, wall, launches = _label_once(labeler, g)
                stats = cache.stats()
                cache.close()
                _add_launches(total, launches)
                _check_labels(labels, len(g), f"{what} {backend} {run}")
                runs[run] = {"labels": labels, "wall_s": wall,
                             "unique_variants": len(ctx),
                             "launches": launches, "stats": stats}
            cold, warm = runs["cold"], runs["warm"]
            check(cold["launches"]["rank_k"]
                  == per_variant * cold["stats"]["compiles"] > 0,
                  f"{what} {backend}: cold launched rank_k "
                  f"{cold['launches']['rank_k']} times for "
                  f"{cold['stats']['compiles']} runs paid")
            check(warm["launches"]["rank_k"] == 0
                  and warm["stats"]["compiles"] == 0,
                  f"{what} {backend}: the warm batch launched rank_k "
                  f"{warm['launches']['rank_k']} times, "
                  f"{warm['stats']['compiles']} runs paid")
            check(warm["launches"]["population_lut"] > 0,
                  f"{what} {backend}: the warm batch ran no QoR gather")
            check(warm["stats"]["identity_hits"] == cold["unique_variants"],
                  f"{what} {backend}: {warm['stats']['identity_hits']} "
                  f"identity hits for {cold['unique_variants']} unique "
                  "variants")
            for k in ("qor", "latency", "energy", "flops", "hbm_bytes"):
                check(cold["labels"][k].tobytes()
                      == warm["labels"][k].tobytes(),
                      f"{what} {backend}: warm {k} differs from cold")
            out[backend] = {
                run: {"wall_s": r["wall_s"],
                      "labels_per_s": len(g) / r["wall_s"],
                      "synth_s": float(r["labels"]["synth_time"].sum()),
                      "unique_variants": r["unique_variants"],
                      "launches": r["launches"], "synth_cache": r["stats"]}
                for run, r in runs.items()}
    for k in MAIN_PATH["cache"]:
        check(total.get(k, 0) > 0, f"{what}: launched no {k} kernel")
    out["launches"] = total
    emit(out)
    return out


def _fig5(lib, seed: int, total: dict) -> dict:
    """Fig. 5 on mcm1: six pipelines on 1000 training and 1000 test
    genomes labeled on the card through a fresh ``SynthCache``; every
    multiplier's per-circuit deployment (pipelines B/E's features) run
    on the card and held against the CPU's."""
    import numpy as np

    from repro_torch.accel import MCMAccelerator
    from repro_torch.core.dse import default_labeler
    from repro_torch.core.features import synth
    from repro_torch.core.features.pipelines import (
        PIPELINES, evaluate_pipeline,
    )

    acc = MCMAccelerator(0)
    rng = np.random.default_rng(seed)
    g = _random_genomes(acc, lib, FIG5_TRAIN + FIG5_TEST, rng)
    scache = synth.SynthCache()
    labels, wall, launches = _label_once(default_labeler(
        acc, lib, n_qor_samples=4, synth_cache=scache, device="cuda"), g)
    _add_launches(total, launches)
    _check_labels(labels, len(g), "figs fig5 labels")
    runs_paid = scache.stats()["compiles"]
    check(launches["rank_k"] == DEPLOY_LAUNCHES[acc.name] * runs_paid,
          f"figs fig5: {launches['rank_k']} rank_k launches for {runs_paid} "
          "runs paid")

    from repro_torch import _build

    muls = lib.kind("mul8u") + lib.kind("mul8s")
    n_slot_muls = sum(len(lib.kind(k)) for k in {s.kind for s in acc.slots}
                      if k != "add16")
    _build.reset_launches()
    card = np.stack([synth.circuit_features_synth(c, device="cuda")
                     for c in muls])
    cpu = np.stack([synth.circuit_features_synth(c, device="cpu")
                    for c in muls])
    check(card[:, :5].tobytes() == cpu[:, :5].tobytes(),
          "figs fig5: per-circuit features on the card differ from the CPU's")
    tr = {k: v[:FIG5_TRAIN] for k, v in labels.items()}
    te = {k: v[FIG5_TRAIN:] for k, v in labels.items()}
    reports = {p: evaluate_pipeline(p, acc, lib, g[:FIG5_TRAIN], tr,
                                    g[FIG5_TRAIN:], te,
                                    hw_model=FIGS_HW_MODEL, device="cuda")
               for p in PIPELINES}
    launches = dict(_build.LAUNCHES)
    _add_launches(total, launches)
    # one launch a multiplier above, then B's and E's tables of the
    # row's own kind
    check(launches["rank_k"] == len(muls) + 2 * n_slot_muls,
          f"figs fig5: {launches['rank_k']} per-circuit rank_k launches, "
          f"expected {len(muls)} + 2 x {n_slot_muls}")
    for p, r in reports.items():
        check(np.isfinite(r.pcc_hw) and np.isfinite(r.pcc_qor),
              f"figs fig5: pipeline {p} PCC not finite")
    rep_a, rep_d = reports["A"], reports["D"]
    claim_fast = bool(rep_d.explore_time_1m < rep_a.explore_time_1m / 20
                      and rep_d.per_variant_time
                      < rep_a.per_variant_time / 10)
    claim_accurate = bool(rep_d.pcc_hw > 0.85 * max(reports["B"].pcc_hw,
                                                    reports["F"].pcc_hw))
    out = {"phase": "figs", "fig": 5, "accel": acc.name,
           "n_train": FIG5_TRAIN, "n_test": FIG5_TEST,
           "hw_model": FIGS_HW_MODEL,
           "label_s": wall, "runs_paid": runs_paid,
           "unique_genomes": int(len(np.unique(g, axis=0))),
           "per_circuit_deploys": len(muls),
           "per_circuit_wall_s": float(card[:, 5].sum()),
           "pipelines": {p: {"pcc_hw": r.pcc_hw, "pcc_qor": r.pcc_qor,
                             "per_variant_s": r.per_variant_time,
                             "setup_s": r.setup_time,
                             "train_s": r.train_time,
                             "explore_1m_hours": r.explore_time_1m / 3600}
                         for p, r in reports.items()},
           "claim_D_fast": claim_fast, "claim_D_accurate": claim_accurate}
    emit(out)
    return out, (g, labels)


def _relabel_front(acc, lib, genomes, obj, what: str) -> None:
    """Hold a front's (-qor, energy) against a CPU re-label through a
    fresh ``SynthCache``."""
    import numpy as np

    from repro_torch.core.dse import default_labeler
    from repro_torch.core.features import synth

    cpu = default_labeler(acc, lib, n_qor_samples=4,
                          synth_cache=synth.SynthCache(),
                          device="cpu")(genomes)
    check(np.array_equal(-cpu["qor"], obj[:, 0])
          and np.array_equal(cpu["energy"], obj[:, 1]),
          f"{what}: front objectives differ from a cpu re-label")


def _fig89(row: int, seed: int) -> dict:
    """Figs. 8/9 on one MCM row: ``run_dse`` against ``approxfpgas_search``
    and ``random_search`` at its synthesis budget, n_train + n_parents;
    hypervolume ratios over a common reference point.  Run in a spawned
    process of its own (``_fig89_rows``): the line, with the launches
    this process made, is returned, not printed."""
    import numpy as np

    from repro_torch import _build
    from repro_torch.accel import MCMAccelerator
    from repro_torch.accel.approxfpgas import approxfpgas_search
    from repro_torch.core.acl.library import default_library
    from repro_torch.core.dse import DSEConfig, random_search, run_dse
    from repro_torch.core.nsga2 import NSGA2Config
    from repro_torch.core.pareto import hypervolume_2d

    lib = default_library()
    acc = MCMAccelerator(row)
    cfg = DSEConfig(
        n_train=1000, n_qor_samples=4, hw_model=FIGS_HW_MODEL,
        nsga=NSGA2Config(pop_size=1000, n_parents=200,
                         n_generations=FIGS_GENERATIONS, seed=seed),
        seed=seed,
    )
    budget = cfg.n_train + cfg.nsga.n_parents
    _build.reset_launches()
    t0 = time.perf_counter()
    ours = run_dse(acc, lib, cfg, device="cuda")
    t1 = time.perf_counter()
    soa_g, soa_obj, soa_mask, rlib = approxfpgas_search(
        acc, lib, n_budget=budget, seed=seed,
        qor_inputs=acc.sample_inputs(4, seed=1234), device="cuda")
    t2 = time.perf_counter()
    rnd_g, rnd_obj, rnd_mask = random_search(acc, lib, n=budget,
                                             seed=seed + 1, device="cuda")
    t3 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    what = f"figs fig89 {acc.name}"
    fronts = {"ours": (ours.front_genomes, ours.front_objectives, lib),
              "approxfpgas": (soa_g[soa_mask], soa_obj[soa_mask], rlib),
              "random": (rnd_g[rnd_mask], rnd_obj[rnd_mask], lib)}
    for name, (fg, fo, flib) in fronts.items():
        check(len(fg) > 0 and np.all(np.isfinite(fo)),
              f"{what}: {name} front empty or not finite")
        _relabel_front(acc, flib, fg, fo, f"{what} {name}")
    obj_ours = ours.true_objectives
    allobj = np.concatenate([obj_ours, soa_obj, rnd_obj])
    ref = allobj.max(axis=0) + 1e-9
    hv = {"ours": hypervolume_2d(obj_ours, ref),
          "approxfpgas": hypervolume_2d(soa_obj, ref),
          "random": hypervolume_2d(rnd_obj, ref)}
    out = {"phase": "figs", "fig": "8/9", "accel": acc.name,
           "budget": budget, "n_train": cfg.n_train,
           "pop_size": cfg.nsga.pop_size, "n_parents": cfg.nsga.n_parents,
           "n_generations": FIGS_GENERATIONS, "hw_model": FIGS_HW_MODEL,
           "hypervolume": hv,
           "hv_ratio_vs_approxfpgas": hv["ours"] / max(hv["approxfpgas"],
                                                       1e-12),
           "hv_ratio_vs_random": hv["ours"] / max(hv["random"], 1e-12),
           "front_sizes": {k: int(len(v[0])) for k, v in fronts.items()},
           "restricted_library": len(rlib),
           "wall_s": {"run_dse": t1 - t0, "approxfpgas": t2 - t1,
                      "random": t3 - t2},
           "val_pcc": ours.val_pcc, "timings_s": ours.timings,
           "launches": launches}
    return out


def _fig89_init(threads: int) -> None:
    import torch

    torch.set_num_threads(threads)


def _fig89_rows(seed: int, total: dict) -> list:
    """Figs. 8/9 on each row of ``FIGS_ROWS``, one spawned process a row
    on the card, all at once: each row's time is mostly its surrogate
    fits on the host, and the rows are independent and deterministic.
    Each process gets its share of the host's cores for torch's and the
    BLAS's CPU threads, as the service's process pool does.  Each line
    is printed here, its launches added to ``total``."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.service.workers import _child_env

    threads = max(1, (os.cpu_count() or 1) // len(FIGS_ROWS))
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with _child_env(OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1",
                    MKL_NUM_THREADS="1"), \
            ProcessPoolExecutor(len(FIGS_ROWS), mp_context=ctx,
                                initializer=_fig89_init,
                                initargs=(threads,)) as pool:
        lines = list(pool.map(_fig89, FIGS_ROWS,
                              [seed] * len(FIGS_ROWS)))
    wall = time.perf_counter() - t0
    for out in lines:
        _add_launches(total, out["launches"])
        emit({**out, "rows_wall_s": wall})
    return lines


def _fig7(res) -> dict:
    """Fig. 7 from the ``hevc_dct4x4`` result of the dse phase: the
    per-generation hypervolume of the surrogate-estimated population
    (running best, over the final), the first generation at 95%, and the
    final front size."""
    import numpy as np

    from repro_torch.core.pareto import hypervolume_2d

    hist = res.search.history
    all_obj = np.concatenate([lg.objectives for lg in hist])
    ref = all_obj.max(axis=0) + 1e-9
    hvs = np.maximum.accumulate(np.asarray(
        [hypervolume_2d(lg.objectives[:, :2], ref[:2]) for lg in hist]))
    final = hvs[-1] if hvs[-1] > 0 else 1.0
    first95 = int(np.argmax(hvs >= 0.95 * final))
    out = {"phase": "figs", "fig": 7, "accel": res.accel_name,
           "generations": len(hist), "first_gen_at_95pct_hv": first95,
           "hv_by_generation": [float(h / final) for h in hvs],
           "final_front_size": int(res.front_mask.sum())}
    emit(out)
    return out


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _asic_cost_proxy(circuits) -> float:
    """Fig. 1's ASIC-style area proxy: partial-product rows times 8 for a
    multiplier, the carry window for an adder (smaller logic, cheaper)."""
    return float(sum(c.carry_window if c.kind == "add16" else c.pp_rows * 8
                     for c in circuits))


def _fig1(lib, seed: int, total: dict, *, n_variants: int = FIG1_VARIANTS,
          qor_samples: int = 2, device="cuda", hw=None) -> dict:
    """Fig. 1 (``benchmarks/fig1_motivation.py``) on gaussian3x3: the
    share of the variants on the Pareto front of (QoR, ASIC area proxy)
    that are off the front of (QoR, deployment energy on ``hw``).  QoR
    through ``qor_batch`` (the population gather), energy through one
    ``synthesize_batch`` of the variants (rank_k once a run paid)."""
    import numpy as np

    from repro_torch import _build
    from repro_torch.accel import GaussianFilter
    from repro_torch.core.features import synth
    from repro_torch.core.hw import H100_SXM, hw_name
    from repro_torch.core.pareto import non_dominated_mask

    hw = H100_SXM if hw is None else hw
    acc = GaussianFilter()
    rng = np.random.default_rng(seed)
    sizes = acc.gene_sizes(lib)
    genomes = rng.integers(0, sizes[None, :], size=(n_variants, len(sizes)))
    inputs = acc.sample_inputs(qor_samples, seed=123)
    scache = synth.SynthCache()
    _build.reset_launches()
    t0 = time.perf_counter()
    qor = acc.qor_batch(genomes, lib, inputs, device=device)
    variants = [acc.decode(g, lib) for g in genomes]
    recs = synth.synthesize_batch(acc, variants, cache={}, synth_cache=scache,
                                  device=device, hw=hw)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    _add_launches(total, launches)
    energy = np.array([r["energy"] for r in recs])
    asic = np.array([_asic_cost_proxy(c) for c, _ in variants])
    runs_paid = scache.stats()["compiles"]
    check(np.all(np.isfinite(qor)) and np.all(np.isfinite(energy)),
          "figs fig1: labels not finite")
    # on the CPU the plain versions run and no launch is counted
    on_card = str(device).startswith("cuda")
    want = DEPLOY_LAUNCHES[acc.name] * runs_paid if on_card else 0
    check(launches["rank_k"] == want,
          f"figs fig1: {launches['rank_k']} rank_k launches for {runs_paid} "
          f"runs paid on {device}")
    asic_idx = set(np.flatnonzero(non_dominated_mask(
        np.stack([-qor, asic], axis=1))).tolist())
    hw_idx = set(np.flatnonzero(non_dominated_mask(
        np.stack([-qor, energy], axis=1))).tolist())
    mismatch = len(asic_idx - hw_idx) / max(len(asic_idx), 1)
    out = {"phase": "figs", "fig": 1, "accel": acc.name, "hw": hw_name(hw),
           "n_variants": int(n_variants), "qor_samples": qor_samples,
           "asic_front_size": len(asic_idx), "hw_front_size": len(hw_idx),
           "pareto_mismatch_fraction": mismatch, "runs_paid": runs_paid,
           "wall_s": wall, "launches": launches}
    emit(out)
    return out


FIG6_MODELS = ("random_forest", "bayesian_ridge", "svr")
# Fig. 6's 24 surrogate fits: spawned processes, one a core of the
# one-card machine (8)
FIG6_FIT_WORKERS = 8


def _fig6_score(name, seed, X, y, n_train):
    """(PCC on the test genomes, None) of one surrogate, or (None, the
    reason) where the model is singular or predicts non-finite values."""
    import numpy as np

    from repro_torch.core.surrogates import make, pcc

    try:
        m = make(name, seed=seed).fit(X[:n_train], y[:n_train])
        pred = m.predict(X[n_train:])
    except np.linalg.LinAlgError as exc:
        return None, f"singular: {exc}"
    if not np.all(np.isfinite(pred)):
        return None, (f"predicts non-finite values "
                      f"({int((~np.isfinite(pred)).sum())} of {len(pred)})")
    return pcc(y[n_train:], pred), None


def _fig6(lib, seed: int, total: dict, *, n_train: int = FIG5_TRAIN,
          n_test: int = FIG5_TEST, device="cuda", hw=None,
          given=None) -> dict:
    """Fig. 6 (``benchmarks/fig6_models.py``): the test PCC of random
    forest, Bayesian ridge and SVR on pipeline D's features, for QoR and
    energy, on mcm1-mcm4; each row's genomes drawn in turn from one
    generator seeded with ``seed`` and labeled on ``device``.  ``given``,
    ``(genomes, labels)`` of mcm1 labeled already at this size (Fig. 5's
    on the card), takes the place of mcm1's draw and labels.  The 24 fits
    are independent and deterministic, and run in ``FIG6_FIT_WORKERS``
    spawned processes (the host's random-forest fits are most of the
    figure's time)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from repro_torch import _build
    from repro_torch.accel import MCMAccelerator
    from repro_torch.core.features import synth
    from repro_torch.core.features.pipelines import build_extractor
    from repro_torch.core.hw import H100_SXM, hw_name
    from repro_torch.service.workers import _child_env

    hw = H100_SXM if hw is None else hw
    rng = np.random.default_rng(seed)
    launches_all: dict = {}
    tasks = []            # (row key, target, model, X, y)
    t0 = time.perf_counter()
    for row in range(4):
        acc = MCMAccelerator(row)
        sizes = acc.gene_sizes(lib)
        genomes = rng.integers(0, sizes[None, :],
                               size=(n_train + n_test, len(sizes)))
        if row == 0 and given is not None:
            genomes, labels = given
        else:
            _build.reset_launches()
            labels = synth.label_variants(acc, genomes, lib, cache={},
                                          synth_cache=synth.SynthCache(),
                                          device=device, hw=hw)
            _sync(device)
            _add_launches(launches_all, dict(_build.LAUNCHES))
        check(len(genomes) == n_train + n_test,
              f"figs fig6 {acc.name}: {len(genomes)} genomes")
        X = build_extractor("D", acc, lib, device=device, hw=hw)(genomes)
        for target in ("qor", "energy"):
            y = np.asarray(labels[target])
            tasks += [(f"mcm{row + 1}", target, name, X, y)
                      for name in FIG6_MODELS]
    label_s = time.perf_counter() - t0
    args = [(name, seed, X, y, n_train) for _, _, name, X, y in tasks]
    ctx = multiprocessing.get_context("spawn")
    # one BLAS thread a fit process: FIG6_FIT_WORKERS of them share the
    # host's cores
    with _child_env(OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1",
                    MKL_NUM_THREADS="1"), \
            ProcessPoolExecutor(FIG6_FIT_WORKERS, mp_context=ctx) as pool:
        results = list(pool.map(_fig6_score, *zip(*args)))
    scores, errors, best = {}, {}, {"qor": {}, "energy": {}}
    for (key, target, name, _, _), (v, why) in zip(tasks, results):
        scores.setdefault(key, {}).setdefault(target, {})[name] = v
        if why is not None:
            errors[f"{key}.{target}.{name}"] = why
    for key, per_target in scores.items():
        for target, got in per_target.items():
            ok = {k: v for k, v in got.items() if v is not None}
            best[target][key] = max(ok, key=ok.get) if ok else None
    _add_launches(total, launches_all)
    out = {"phase": "figs", "fig": 6, "hw": hw_name(hw), "pipeline": "D",
           "n_train": n_train, "n_test": n_test,
           "mcm1_from_fig5": given is not None, "pcc": scores,
           "not_scored": errors, "best": best,
           "rf_wins_qor_of4": sum(v == "random_forest"
                                  for v in best["qor"].values()),
           "bayes_wins_energy_of4": sum(v == "bayesian_ridge"
                                        for v in best["energy"].values()),
           "label_s": label_s, "fit_workers": FIG6_FIT_WORKERS,
           "wall_s": time.perf_counter() - t0, "launches": launches_all}
    emit(out)
    return out


def phase_figs(seed: int, hevc_result=None) -> dict:
    """The paper's figure families on the card (module docstring, phase
    7).  Launch counts are set to 0 at the start and summed over the
    phase's runs; the CPU re-labels launch nothing."""
    from repro_torch.core.acl.library import default_library

    lib = default_library()
    total: dict = {}
    fig5, mcm1 = _fig5(lib, seed, total)
    lines = {"fig1": _fig1(lib, seed, total),
             "fig5": fig5,
             "fig6": _fig6(lib, seed, total, given=mcm1),
             "fig89": _fig89_rows(seed, total)}
    if hevc_result is not None:
        lines["fig7"] = _fig7(hevc_result)
    for k in MAIN_PATH["figs"]:
        check(total.get(k, 0) > 0, f"figs: launched no {k} kernel")
    out = {"phase": "figs", "launches": total,
           "reduced": {
               "fig89_rows": {"paper": ["mcm1", "mcm2", "mcm3", "mcm4"],
                              "run": [f"mcm{r + 1}" for r in FIGS_ROWS]},
               "fig89_n_generations": {"paper": 1000, "repo_default": 100,
                                       "run": FIGS_GENERATIONS},
               "fig1_variants": {"repo_default": 120, "run": FIG1_VARIANTS},
               "fig6_genomes": {"repo_default": [60, 30],
                                "run": [FIG5_TRAIN, FIG5_TEST]},
               "hw_model": {"repo_default": "bayesian_ridge",
                            "run": FIGS_HW_MODEL}},
           "claims": {
               "fig1_asic_pareto_off_the_hw_front": lines["fig1"][
                   "pareto_mismatch_fraction"],
               "fig6_rf_best_for_qor_of4": lines["fig6"]["rf_wins_qor_of4"],
               "fig6_bayes_best_for_energy_of4": lines["fig6"][
                   "bayes_wins_energy_of4"],
               "D_fast": lines["fig5"]["claim_D_fast"],
               "D_accurate": lines["fig5"]["claim_D_accurate"],
               "hv_ratio_vs_approxfpgas_ge_1": {
                   ln["accel"]: ln["hv_ratio_vs_approxfpgas"] >= 1.0
                   for ln in lines["fig89"]}}}
    emit(out)
    return out


def _hier_manager():
    """A fresh in-process campaign service on the card: two eval threads,
    two campaign threads, a fresh ``SynthCache``, and ``max_batch=1000``
    so a campaign's 1000-genome request reaches the gather whole."""
    from repro_torch.core.features import synth
    from repro_torch.service import CampaignManager

    return CampaignManager(device="cuda", eval_workers=2, campaign_workers=2,
                           max_batch=1000, synth_cache=synth.SynthCache())


def _runs_paid(genomes, labels) -> int:
    """Deployment runs paid among one context's ground-truth labels: the
    genome that paid a run carries its wall time, riders and cache hits
    0.0 (``synthesize_batch``)."""
    import numpy as np

    _, first = np.unique(genomes, axis=0, return_index=True)
    return int(np.count_nonzero(np.asarray(labels["synth_time"])[first] > 0))


def _hier_line(run: str, mgr, wall: float, launches: dict, paid: dict,
               front_genomes, front_obj, exact_qor: float, lib) -> dict:
    """Gates and line shared by both runs of the hier phase: kernels of
    the main path launched, rank_k once per run paid per context
    (``DEPLOY_LAUNCHES``) and the runs the synthesis cache counted, the
    front finite with a design at the exact anchor's QoR, and the front
    equal to a CPU re-label."""
    import numpy as np

    from repro_torch.accel import SmoothedDct

    what = f"hier {run}"
    for k in MAIN_PATH["hier"]:
        check(launches[k] > 0, f"{what}: launched no {k} kernel")
    stats = mgr.synth_cache.stats()
    want = sum(DEPLOY_LAUNCHES[name] * n for name, n in paid.items())
    check(launches["rank_k"] == want,
          f"{what}: {launches['rank_k']} rank_k launches for runs paid "
          f"{paid} (expected {want})")
    check(sum(paid.values()) == stats["compiles"],
          f"{what}: runs paid {paid} against {stats['compiles']} the "
          "synthesis cache counted")
    check(len(front_genomes) > 0 and np.all(np.isfinite(front_obj)),
          f"{what}: front empty or not finite")
    check(exact_qor == 100.0 and -front_obj[:, 0].min() == exact_qor,
          f"{what}: the front's best QoR {-front_obj[:, 0].min()} is not "
          f"the exact anchor's {exact_qor}")
    _relabel_front(SmoothedDct(), lib, front_genomes, front_obj, what)
    sched = mgr.scheduler.stats()
    # the batch-size histogram, its cumulative buckets made per bucket
    hist = mgr.scheduler.batch_size
    cum = [int(c) for _, c in hist.samples()[:-2]]
    sizes = {f"<={b:g}": c - p for b, c, p in
             zip(hist.buckets + (float("inf"),), cum, [0] + cum[:-1])
             if c > p}
    return {"phase": "hier", "run": run, "wall_s": wall,
            "labeled": sched["labeled"], "requests": sched["requests"],
            "store_hits": sched["store_hits"],
            "inflight_dedup_hits": sched["inflight_dedup_hits"],
            "batches": sched["batches"],
            "mean_batch_size": sched["mean_batch_size"],
            "batch_sizes": sizes,
            "coalesced_batches": sched["coalesced_batches"],
            "runs_paid": paid, "synth_cache": stats,
            "front_size": int(len(front_genomes)),
            "front_qor_range": [float(-front_obj[:, 0].max()),
                                float(-front_obj[:, 0].min())],
            "launches": launches}


def phase_hier(seed: int) -> dict:
    """The paper's hierarchical search against a flat campaign on
    ``smoothed_dct`` (module docstring, phase 8), each on a fresh
    in-process campaign service on the card."""
    import numpy as np
    import torch

    from repro_torch import _build
    from repro_torch.accel import SmoothedDct
    from repro_torch.core.acl.library import default_library
    from repro_torch.core.pareto import hypervolume_2d
    from repro_torch.hierarchy import HierarchicalConfig, run_hierarchical
    from repro_torch.service import CampaignSpec

    lib = default_library()
    pipe = SmoothedDct()
    exact = pipe.exact_genome(lib)
    total: dict = {}
    common = dict(HIER_WIDTHS, n_generations=FIGS_GENERATIONS,
                  hw_model=FIGS_HW_MODEL, seed=seed)

    # flat: one campaign over the 45-slot joint genome
    mgr = _hier_manager()
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        cid = mgr.submit(CampaignSpec(accel="smoothed_dct",
                                      n_train=HIER_FLAT_TRAIN, **common))
        state = mgr.wait(cid, timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        check(state == "done",
              f"hier flat: campaign {state}: {mgr.status(cid).get('error')}")
        res = mgr.result(cid)
        g_all, l_all = res.search.genomes, res.final_labels
        hit = np.flatnonzero((g_all == exact).all(axis=1))
        flat = _hier_line("flat", mgr, wall, launches,
                          {pipe.name: _runs_paid(g_all, l_all)},
                          res.front_genomes, res.front_objectives,
                          float(l_all["qor"][hit[0]]), lib)
        flat.update(n_train=HIER_FLAT_TRAIN, timings_s=res.timings,
                    val_pcc=res.val_pcc)
        flat_front = res.front_objectives
    finally:
        mgr.shutdown()
    _add_launches(total, flat["launches"])
    emit(flat)

    # hierarchical: one concurrent campaign a stage, composition, then
    # the composed candidates re-labeled end to end
    mgr = _hier_manager()
    try:
        cfg = HierarchicalConfig(n_train=HIER_STAGE_TRAIN,
                                 k_per_stage=HIER_K_PER_STAGE,
                                 max_candidates=HIER_MAX_CANDIDATES,
                                 **common)
        _build.reset_launches()
        t0 = time.perf_counter()
        hres = run_hierarchical(pipe, lib, cfg, manager=mgr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        check(hres.max_concurrent_stages >= 2,
              f"hier: {hres.max_concurrent_stages} stage campaign(s) in "
              "flight at once, expected 2")
        paid, stage_timings = {}, []
        for i, sc in enumerate(hres.stage_campaign_ids):
            r = mgr.result(sc)
            paid[f"{pipe.name}/stage{i}"] = _runs_paid(r.search.genomes,
                                                       r.final_labels)
            stage_timings.append(r.timings)
        paid[pipe.name] = _runs_paid(hres.candidate_genomes,
                                     hres.final_labels)
        hit = np.flatnonzero((hres.candidate_genomes == exact).all(axis=1))
        check(len(hit) == 1, "hier: the exact anchor is not a candidate")
        hier = _hier_line("hierarchical", mgr, wall, launches, paid,
                          hres.front_genomes, hres.front_objectives,
                          float(hres.final_labels["qor"][hit[0]]), lib)
        cs = hres.compose_stats
        hier.update(
            n_train_per_stage=HIER_STAGE_TRAIN,
            k_per_stage=HIER_K_PER_STAGE,
            max_candidates=HIER_MAX_CANDIDATES,
            timings_s=hres.timings, stage_timings_s=stage_timings,
            val_pcc=hres.val_pcc,
            ground_truth_calls=hres.ground_truth_calls,
            max_concurrent_stages=int(hres.max_concurrent_stages),
            compose={"stage_front_sizes": cs.stage_sizes,
                     "truncated_sizes": cs.truncated_sizes,
                     "cross_product_size": cs.cross_product_size,
                     "pairs_evaluated": cs.pairs_evaluated,
                     "survivors": cs.survivors},
            candidates=int(len(hres.candidate_genomes)),
            exact_genome_on_front=bool(hres.front_mask[hit[0]]),
            flat_space_size=hres.flat_space_size)
        hier_front = hres.front_objectives
    finally:
        mgr.shutdown()
    _add_launches(total, hier["launches"])
    emit(hier)

    # hypervolume of both verified fronts on one reference point (the
    # JAX package's benchmarks/hierarchy.py)
    both = np.concatenate([flat_front, hier_front])
    ref = (both.max(axis=0) + 0.05 * np.abs(both.max(axis=0)
                                            - both.min(axis=0)) + 1e-12)
    hv_flat = hypervolume_2d(flat_front, ref)
    hv_hier = hypervolume_2d(hier_front, ref)
    out = {"phase": "hier", "launches": total,
           "label_ratio": hier["ground_truth_calls"]["total"]
           / max(flat["labeled"], 1),
           "hv_ratio": hv_hier / max(hv_flat, 1e-300),
           "hypervolume": {"flat": hv_flat, "hierarchical": hv_hier,
                           "ref_point": ref.tolist()},
           "wall_ratio": hier["wall_s"] / flat["wall_s"],
           "reduced": {
               "n_generations": {"paper": 1000,
                                 "campaign_spec_default": 10,
                                 "hierarchical_config_default": 6,
                                 "run": FIGS_GENERATIONS},
               "hw_model": {"repo_default": "bayesian_ridge",
                            "run": FIGS_HW_MODEL}}}
    emit(out)
    return out


def _device_time(prof, name: str = "") -> tuple:
    """(seconds, launches) of the CUDA kernels in a profiler window whose
    name contains ``name``; (None, None) if the trace holds no device
    time."""
    from torch.autograd import DeviceType

    us, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or name not in e.key:
            continue
        us += getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        n += e.count
    return (us * 1e-6, n) if us > 0 else (None, None)


def _chunked_form_attention(q, k, v, *, causal=True, impl=None):
    """The function the JAX package's model code runs in prefill
    (``chunked_attention``), as one masked softmax: like the plain
    version but with q scaled in its own dtype before the float32 cast;
    the top-left causal mask where ``causal``, none otherwise (the
    encoder, cross attention).  Used only to measure how far the
    reference's own two forms of the function move the full-depth
    logits."""
    import torch

    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qg = (q * d ** -0.5).float().reshape(b, kvh, h // kvh, sq, d)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float())
    if causal:
        mask = torch.arange(sk, device=q.device)[None, :] <= torch.arange(
            sq, device=q.device)[:, None]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def _assoc_scan(a, b):
    """Inclusive scan along dim 1 of (a, b) pairs under
    (a1, b1), (a2, b2) -> (a1 a2, b2 + a2 b1), by doubling steps."""
    import torch

    step, L = 1, a.shape[1]
    while step < L:
        b = torch.cat([b[:, :step], b[:, step:] + a[:, step:] * b[:, :-step]],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return a, b


def _chunked_form_scan(x, dt, A, B, C, h0=None, *, impl=None, chunk=128):
    """The function the JAX package's model code runs in Mamba prefill
    (``_selective_scan_chunked``): an associative scan inside 128-step
    chunks, the state carried across chunks.  Used only to measure how
    far the reference's own two forms of the scan move the full-depth
    logits."""
    import torch
    from torch.utils.checkpoint import checkpoint

    def body(xc, dtc, Bc, Cc, h):
        a = torch.exp(dtc[..., None] * A)
        bx = (dtc * xc)[..., None] * Bc[:, :, None, :]
        a, bx = _assoc_scan(a, bx)
        hh = bx + a * h[:, None]
        return torch.einsum("blin,bln->bli", hh, Cc), hh[:, -1]

    b, s, di = x.shape
    h = (torch.zeros((b, di, A.shape[1]), device=x.device)
         if h0 is None else h0)
    ys = []
    for c0 in range(0, s, chunk):
        args = [t[:, c0:c0 + chunk] for t in (x, dt, B, C)] + [h]
        # under grad each chunk is rematerialised in the backward, as the
        # JAX code's jax.checkpoint of its chunk body does
        y, h = (checkpoint(body, *args, use_reentrant=False)
                if torch.is_grad_enabled() else body(*args))
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _request_caches(model, b: int, n: int, extra: dict):
    """Caches of a request of ``n`` text positions: after the front
    end's ``embeds``, against the encoder's ``enc_embeds`` (``extra``,
    None where the config takes none)."""
    vis = 0 if extra.get("embeds") is None else extra["embeds"].shape[1]
    enc = (0 if extra.get("enc_embeds") is None
           else extra["enc_embeds"].shape[1])
    return model.init_caches(b, n + vis, enc)


def _kernel_calls(cfg, steps: int = 0) -> dict:
    """Launches of each serve kernel in one prefill and ``steps`` decode
    steps of ``cfg``: the attention kernel once an encoder layer, a
    self-attention layer and a cross-attention layer in prefill, and once
    a cross-attention layer in each decode step (self-attention decodes
    in plain PyTorch, as the JAX package does); the scan once a Mamba
    layer in prefill (decode runs the step's own update)."""
    kinds = [k for _ in range(cfg.n_superblocks) for k in cfg.block_pattern]
    n_cross = sum(k.cross_attn for k in kinds)
    n_enc = cfg.n_enc_layers if cfg.is_encoder_decoder else 0
    return {"flash_attention_sm90": (sum(k.mixer == "attn" for k in kinds)
                                     + n_enc + n_cross * (1 + steps)),
            "selective_scan": sum(k.mixer == "mamba" for k in kinds)}


def _per_layer_check(model, prompts, kernel: str, extra: dict) -> dict:
    """One more prefill in which every layer's attention (or scan) call
    runs the kernel and the plain version on that layer's own inputs
    (an encoder-decoder's encoder, self and cross attention calls all
    held); the kernel's output goes on.  Fails if any layer's kernel
    output is outside the kernel rows' tolerance, or if the calls are
    not one a layer that runs the kernel; returns the calls, the worst
    difference and the share of outputs that differ at all."""
    import torch

    import repro_torch.models.attention as attn_mod
    import repro_torch.models.ssm as ssm_mod
    from repro_torch.train.serve import make_prefill_step

    worst, differ, total, calls = 0.0, 0, 0, 0
    if kernel.startswith("flash_attention"):
        mod, attr = attn_mod, "attn_op"
        compare = _close(FLASH_BF16_RTOL, FLASH_BF16_ATOL)
    else:
        mod, attr = ssm_mod, "selective_scan"
        compare = _close(SCAN_WIDE_TOL, SCAN_WIDE_TOL)
    orig = getattr(mod, attr)

    def both(*args, impl=None, **kw):
        nonlocal worst, differ, total, calls
        got = orig(*args, impl="kernel", **kw)
        want = orig(*args, impl="plain", **kw)
        compare(got, want, f"{kernel} on layer inputs")
        worst = max(worst, _max_err(got, want))
        g0 = got[0] if isinstance(got, tuple) else got
        w0 = want[0] if isinstance(want, tuple) else want
        differ += int((g0 != w0).sum())
        total += g0.numel()
        calls += 1
        return got

    setattr(mod, attr, both)
    try:
        b, L = prompts.shape
        make_prefill_step(model)(prompts, _request_caches(model, b, L, extra),
                                 **extra)
        torch.cuda.synchronize()
    finally:
        setattr(mod, attr, orig)
    want_calls = _kernel_calls(model.cfg)[kernel]
    check(calls == want_calls,
          f"per-layer check: {calls} {kernel} calls, not {want_calls}")
    return {"calls": calls, "max_abs_err": worst,
            "share_of_outputs_differing": differ / max(total, 1)}


def _profile_request(model, prompts, kernel: str, extra: dict,
                     steps: int = 4) -> dict:
    """One prefill and ``steps`` decode steps under ``torch.profiler``:
    device (kernel) time against host wall time, the ported kernel's
    share of the prefill, and the decode's launches and idle share per
    step.  Only the device is traced: tracing every host op as well cost
    5-24 s a request, most of a serve phase.  Profiling still adds host
    time, so the walls here are above the unprofiled run's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.serve import make_decode_step, make_prefill_step

    kname = {"flash_attention_sm90": "flash_fwd_sm90_kernel",
             "selective_scan": "selective_scan_kernel"}[kernel]
    b, L = prompts.shape
    caches = _request_caches(model, b, L + steps + 1, extra)
    pos0 = L + (0 if extra.get("embeds") is None else extra["embeds"].shape[1])
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    acts = [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof_p:
        t0 = time.perf_counter()
        logits, caches = prefill(prompts, caches, **extra)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        pre_wall = time.perf_counter() - t0
    with profile(activities=acts) as prof_d:
        t0 = time.perf_counter()
        for i in range(steps):
            nxt, _, caches = decode(caches, nxt, pos0 + i)
        torch.cuda.synchronize()
        dec_wall = time.perf_counter() - t0
    pre_dev, _ = _device_time(prof_p)
    ker_dev, ker_n = _device_time(prof_p, kname)
    dec_dev, dec_n = _device_time(prof_d)
    return {
        "prefill_wall_s": pre_wall, "prefill_device_s": pre_dev,
        "prefill_kernel_s": ker_dev, "prefill_kernel_launches": ker_n,
        "kernel_share_of_prefill_device": (ker_dev / pre_dev
                                           if ker_dev and pre_dev else None),
        "decode_steps": steps, "decode_wall_s_per_step": dec_wall / steps,
        "decode_device_s_per_step": (dec_dev / steps if dec_dev else None),
        "decode_launches_per_step": (dec_n / steps if dec_n else None),
        "decode_idle_share": (1.0 - dec_dev / dec_wall if dec_dev else None),
    }


def _prefix_model(model, n_layers: int):
    """The first ``n_layers`` layers of ``model`` as a model of their own:
    the same parameters (no copy), a config of that depth.  Its MoE
    layers route every token to every real expert, with a slot for each
    in every expert: the layer's output is then continuous in its input.
    With top-k routing, one rounding can swap a token's k-th expert for
    another (and, under a binding capacity, the slots of every later
    token of that expert): the logits jump, by up to 6.4 on phi3.5-moe,
    and the kernel-vs-plain logits would say more of the router than of
    the kernel.  An encoder-decoder's encoder is kept whole (its 16
    frames cost little), beside the first decoder layers."""
    import copy
    from dataclasses import replace

    from torch import nn

    cfg = model.cfg
    if cfg.n_experts:
        # cap = int(s * (padded + 1) / padded) >= s
        cfg = replace(cfg, n_experts_active=cfg.n_experts,
                      capacity_factor=(cfg.padded_experts + 1)
                      / cfg.n_experts)
    if n_layers >= cfg.n_layers and cfg is model.cfg:
        return model
    pattern = len(cfg.block_pattern)
    n_layers = min(cfg.n_layers, max(pattern, n_layers - n_layers % pattern))
    layers = []
    for layer in list(model.layers)[:n_layers]:
        if hasattr(layer, "moe"):
            moe = copy.copy(layer.moe)
            moe.cfg = cfg
            layer = copy.copy(layer)
            layer._modules = dict(layer._modules, moe=moe)
        layers.append(layer)
    part = copy.copy(model)
    part._modules = dict(model._modules)
    part.layers = nn.ModuleList(layers)
    part.cfg = replace(cfg, n_layers=n_layers)
    return part


def _serve_widths(cfg) -> dict:
    if cfg.family == "ssm":
        return {"d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
                "dt_rank": cfg.resolved_dt_rank}
    out = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "mlp_act": cfg.mlp_act, "rope_style": cfg.rope_style,
           "tie_embeddings": cfg.tie_embeddings}
    if cfg.n_experts:
        out.update(n_experts=cfg.n_experts,
                   padded_experts=cfg.padded_experts,
                   top_k=cfg.n_experts_active,
                   capacity_factor=cfg.capacity_factor)
    if cfg.is_encoder_decoder:
        out.update(n_enc_layers=cfg.n_enc_layers)
    if cfg.frontend != "none":
        out.update(frontend=cfg.frontend, frontend_len=cfg.frontend_len)
    return out


def phase_serve(arch: str, seed: int, *, approx: bool = False) -> dict:
    """Serve ``arch`` at full width (and full depth unless ``SERVE_DEPTH``
    cuts it) on the card; the checks on its first ``SERVE_CHECK_LAYERS``
    layers; free it after."""
    from dataclasses import replace

    import torch

    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_model, serve_batch
    from repro_torch.models import ApproxPolicy
    from repro_torch.train.serve import frontend_inputs, make_prefill_step

    name = f"serve_{arch}" + ("_approx" if approx else "")
    published = get_config(arch)
    cfg = published
    cut = None
    if arch in SERVE_DEPTH:
        cfg = replace(published, n_layers=SERVE_DEPTH[arch])
        cut = {"n_layers": {"published": published.n_layers,
                            "run": cfg.n_layers},
               "why": "the published depth's bf16 weights "
                      f"({published.param_count() * 2 / 1e9:.1f} GB) do not "
                      "fit one 80 GB card"}
    policy = None
    if approx:
        policy = ApproxPolicy({"ffn_in": ("mul8s_mitchell", 3),
                               "ffn_out": ("mul8s_mitchell", 3)})
        cfg = replace(cfg, n_layers=SERVE_APPROX_DEPTH)
        cut = {"n_layers": {"published": published.n_layers,
                            "run": cfg.n_layers},
               "why": "the script's 1200 s limit: the approximate FFN "
                      "route prefills all 36 layers in 8.9 s and decodes "
                      "at 20 tokens/s (18 layers until the training lines "
                      "of seamless, qwen, compression and the cluster CLI "
                      "joined the script)"}
    b, L, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    g = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (b, L), generator=g)
    # the stub front ends' inputs (encoder frames, patch embeddings), the
    # same for the timed request and the checks
    extra = {k: None if v is None else v.cuda()
             for k, v in frontend_inputs(cfg, b, seed=seed).items()}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, policy=policy, seed=seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    timings: dict = {}
    _build.reset_launches()
    t0 = time.perf_counter()
    tokens, tps = serve_batch(cfg, batch=b, prompt_len=L, gen=gen,
                              policy=policy, prompts=prompts, model=model,
                              timings=timings, **extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    check(tuple(tokens.shape) == (b, L + gen),
          f"{name}: tokens {tuple(tokens.shape)}")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.padded_vocab,
          f"{name}: token ids outside the vocabulary")
    check(torch.equal(tokens[:, :L].cpu(), prompts.to(torch.int32)),
          f"{name}: prompt not carried into the tokens")
    # once a layer that runs the kernel, and once a cross-attention layer
    # a decode step (``_kernel_calls``)
    n_layers = _kernel_calls(cfg)
    want_launches = _kernel_calls(cfg, steps=gen - 1)
    for k in MAIN_PATH[name]:
        check(launches[k] == want_launches[k],
              f"{name}: {k} launched {launches[k]} times in one request, "
              f"not the {want_launches[k]} of its {n_layers[k]} prefill "
              f"calls and {gen - 1} decode steps")
    aux = (float(model.last_aux) if cfg.n_experts else None)
    if cfg.n_experts:
        check(0 < aux < float("inf"),
              f"{name}: the MoE load-balance loss is {aux}")

    # the checks, on the first layers of the same model: kernel route
    # against the plain route, same prompts
    part = _prefix_model(model, SERVE_CHECK_LAYERS)
    t_check = time.perf_counter()
    logits = {}
    for impl in ("kernel", "plain"):
        caches = _request_caches(part, b, L, extra)
        lg, _ = make_prefill_step(part, impl=impl)(prompts.cuda(), caches,
                                                   **extra)
        del caches
        logits[impl] = lg.float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits["kernel"]).all()),
          f"{name}: prefill logits not finite")
    err = float((logits["kernel"] - logits["plain"]).abs().max())
    kernel = MAIN_PATH[name][0]
    layers = _per_layer_check(part, prompts.cuda(), kernel, extra)
    # the same prefill with the JAX model code's own form of the function
    # (plain route otherwise): how far the reference's two forms of it
    # move these logits, measured on this model and these prompts
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.ssm as ssm_mod

    mod, attr, form = ((ssm_mod, "selective_scan", _chunked_form_scan)
                       if kernel == "selective_scan" else
                       (attn_mod, "attn_op", _chunked_form_attention))
    orig = getattr(mod, attr)
    setattr(mod, attr, form)
    try:
        lg, _ = make_prefill_step(part, impl="plain")(
            prompts.cuda(), _request_caches(part, b, L, extra), **extra)
    finally:
        setattr(mod, attr, orig)
    spread = float((lg.float() - logits["plain"]).abs().max())
    del lg
    tol = max(LOGITS_TOL, LOGITS_SPREAD_FACTOR * spread)
    emit({"phase": name + "_diagnostics", "check_layers": part.cfg.n_layers,
          "check_moe_top_k": part.cfg.n_experts_active,
          "logits_kernel_vs_plain": err, "per_layer": layers,
          "logits_chunked_form_vs_plain": spread, "logits_tolerance": tol})
    check(err <= tol, f"{name}: kernel vs plain prefill logits differ "
                      f"by {err:.4g} (tolerance {tol:.4g})")
    k_tokens, _ = serve_batch(part.cfg, batch=b, prompt_len=L, gen=gen,
                              policy=policy, prompts=prompts, model=part,
                              **extra)
    plain_tokens, _ = serve_batch(part.cfg, batch=b, prompt_len=L, gen=gen,
                                  policy=policy, prompts=prompts, model=part,
                                  impl="plain", **extra)
    agree = float((k_tokens[:, L:] == plain_tokens[:, L:]).float().mean())
    check_s = time.perf_counter() - t_check
    t_prof = time.perf_counter()
    prof = _profile_request(model, prompts.cuda(), MAIN_PATH[name][0], extra)
    profile_s = time.perf_counter() - t_prof
    out = {
        "phase": name, "arch": arch, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "widths": _serve_widths(cfg),
        "vocab": cfg.padded_vocab, **SERVE,
        "frontend_len": (0 if extra["embeds"] is None
                         else extra["embeds"].shape[1]),
        "enc_frames": (0 if extra["enc_embeds"] is None
                       else extra["enc_embeds"].shape[1]),
        "policy": ({"ffn_in": ["mul8s_mitchell", 3],
                    "ffn_out": ["mul8s_mitchell", 3]} if approx else None),
        "reduced": cut,
        "param_bytes": model.param_bytes(), "init_s": init_s,
        "prefill_s": timings["prefill_s"], "decode_s": timings["decode_s"],
        "decode_tokens_per_s": tps, "wall_s": wall,
        "max_memory_allocated": peak,
        "moe_aux_loss": aux,
        "launches": launches,
        "launches_expected": {k: want_launches[k] for k in MAIN_PATH[name]},
        "launches_per_layer": {k: launches[k] / n_layers[k]
                               for k in MAIN_PATH[name]},
        "check_layers": part.cfg.n_layers, "check_s": check_s,
        "profile_s": profile_s,
        "check_moe_top_k": part.cfg.n_experts_active or None,
        "logits_kernel_vs_plain_max_abs": err,
        "per_layer_kernel_vs_plain": layers,
        "logits_chunked_form_vs_plain_max_abs": spread,
        "logits_tolerance": tol,
        "greedy_tokens_agree": agree,
        "profile": prof,
    }
    del model, part, logits
    torch.cuda.empty_cache()
    emit(out)
    return out


# the train phase: ``launch/train.py``'s ``train_loop`` on gemma-2b at
# full size (``TRAIN``), the kernel step against the plain one on its
# first ``TRAIN_CHECK_LAYERS`` layers, the same two for falcon-mamba-7b
# at full width and ``TRAIN_FALCON_LAYERS`` layers, granite-moe-3b at
# full width on ``TRAIN_MOE_LAYERS`` layers, jamba's super-block
# (``TRAIN_HYBRID_CFG``), and ``run_resilient`` on a reduced gemma with
# one injected failure
TRAIN = dict(steps=12, batch=8, seq=1024, n_micro=2, lr=1e-3)
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_BATCH = 4
# falcon-mamba-7b's 64 layers in float32 masters, AdamW moments and
# gradients take 16 bytes a parameter, 7.27 B x 16 = 117 GB; one layer
# is 105 M parameters, 1.68 GB of that state: the layers that fit one
# 80 GB card beside the 65k embedding and head and a layer's
# activations
TRAIN_FALCON_LAYERS = 32
TRAIN_FALCON = dict(TRAIN, steps=6)
# jamba-1.5-large's 8-layer block pattern (Mamba layers, attention at
# position 4, MoE of 16 experts top-2 on every other layer) as one
# super-block, bf16 masters and moments as its config asks, at a quarter
# of its width: at d 8192 one super-block is ~88 GB of bf16 weights
# (its four MoE layers 4 x 16 x 3 x 8192 x 24576 x 2 B = 77 GB), more
# than a card; d 2048 keeps head dim 128 (the kernels' route), the 8:1
# query to kv heads, d_ff = 3 d and the 65k vocab
TRAIN_HYBRID_CFG = dict(n_layers=8, d_model=2048, n_heads=16, n_kv_heads=2,
                        head_dim=128, d_ff=6144)
TRAIN_HYBRID = dict(steps=3, batch=2, seq=1024, n_micro=1, lr=1e-3)
TRAIN_MOE = dict(steps=3, batch=2, seq=1024, n_micro=1, lr=1e-3)
TRAIN_MOE_LAYERS = 4
# a small gemma whose head dim the kernels take (the reduced config's 16
# is the CPU tests')
TRAIN_RESILIENT_CFG = dict(n_layers=2, d_model=256, n_heads=4, head_dim=64,
                           d_ff=512, vocab_size=2048)
TRAIN_RESILIENT = dict(steps=6, batch=4, seq=256, ckpt_every=2, fail_at=3)
# seamless-m4t-medium at TRAIN but lr 3e-4: at 1e-3 its loss rose over
# the 12 steps through the kernels and through the plain attention alike
# (12.658 -> 12.740 and -> 12.760), at 3e-4 it fell on both routes
# (tests/train_step_profile.py lr; PERF.md §6)
TRAIN_SEAMLESS = dict(TRAIN, lr=3e-4)
# qwen2-vl-72b's depth on one card (_train_qwen's reduced.why), 6 steps
TRAIN_QWEN_LAYERS = 1
TRAIN_QWEN = dict(TRAIN, steps=6)
# launch/train.py --compress on gemma-2b's first layers
TRAIN_COMPRESS_LAYERS = 2
TRAIN_COMPRESS = dict(steps=3, batch=8, seq=1024, n_micro=2, lr=1e-3,
                      compress=True)
# the cluster CLI as one NCCL process on gemma-2b at full size (its
# micro-batch count is launch/shapes.py's n_microbatches at batch 8).  6
# steps, not 3: with error feedback its loss still rose over 3 steps
# (12.8728 -> 12.8931), as launch/train.py --compress's does at this
# size, while the uncompressed step's fell: int8 with one scale a leaf
# rounds most of the tied 256k embedding's gradient to 0, which AdamW's
# first updates then leave in place (tests/compress_probe.py; PERF.md
# §6)
CLUSTER = dict(batch=8, seq=1024, steps=6)
CLUSTER_TIMEOUT_S = 300
# the kernel step's loss and gradients against the plain step's: bf16
# rounding moves them, by as much as the JAX model code's own form of
# attention (q scaled in bf16 before the float32 cast) moves them from
# the plain one, measured in the same run; the kernel is held to
# max(floor, TRAIN_SPREAD_FACTOR x that spread), each gradient by its
# norm's relative difference and its largest elementwise difference over
# its largest element.  The floors are 2 to 3 x the larger of the
# kernel's and the spread's readings on the H100 (PERF.md §6; the step is
# deterministic): loss 1.15e-5 / 1.65e-5, total gradient norm 3.5e-6 /
# 4.5e-6 (floored at 1e-4), worst tensor's norm 1.5e-4 / 2.3e-4, worst
# elementwise 8.6e-3 / 8.0e-3
TRAIN_SPREAD_FACTOR = 2.0
TRAIN_LOSS_FLOOR = 5e-5
TRAIN_GRAD_NORM_TOTAL_FLOOR = 1e-4
TRAIN_GRAD_NORM_FLOOR = 7e-4
TRAIN_GRAD_MAX_FLOOR = 2e-2
# falcon-mamba-7b's first 2 layers: the worst tensor's norm moves with
# the bf16 rounding noise of the layers above (layer 0's x_proj, whose
# gradient sums dB and dC over the channels of each token: the scan's
# output gradient differs per token, coherently across channels, by the
# other layer's bf16 roundings).  Readings on the H100 (PERF.md §6; the
# step is deterministic): kernel 1.10e-3, the chunked form
# 1.18e-4, both on layer 0's x_proj; on that layer's own inputs and
# output gradient the backward kernel is within 1.7e-6 of each output's
# largest element of the plain backward.  That per-layer comparison
# (``_scan_layer_check``), at the kernel rows' gate, is where a fault of
# the kernel would show
TRAIN_MAMBA_GRAD_NORM_FLOOR = 3e-3


def _attn_layers(cfg) -> int:
    """Flash attention calls of one forward: every self-attention layer,
    an encoder's layers and each cross attention."""
    return sum((k.mixer == "attn") + bool(k.cross_attn)
               for _ in range(cfg.n_superblocks)
               for k in cfg.block_pattern) + cfg.n_enc_layers


def _train_positions(cfg, run: dict) -> int:
    """Decoder positions a sequence: a front end's embeddings first."""
    return run["seq"] + (cfg.frontend_len if cfg.frontend == "vision" else 0)


def _train_flops(cfg, params: dict, run: dict) -> dict:
    """A step's model FLOPs: 6 x the matrix parameters a position meets
    (the layers' projections, an encoder's over its ``seq`` frames, and
    the head's, tied or not; a Mamba layer's depthwise conv and A are not
    products) x positions, plus the attention's two products at 2 d
    flops a visible pair in the forward and twice that in the backward
    (causal self-attention, and an encoder's and cross attention's full
    pairs); and the FLOPs with remat's second forward of every layer."""
    b, s = run["batch"], _train_positions(cfg, run)
    tokens = b * s
    layer = sum(p.numel() for n, p in params.items()
                if n.startswith(("layers.", "encoder.layers."))
                and p.dim() >= 2 and not n.endswith((".conv_w", ".A_log")))
    head = cfg.d_model * cfg.padded_vocab
    self_layers = sum(k.mixer == "attn" for _ in range(cfg.n_superblocks)
                      for k in cfg.block_pattern)
    pairs = self_layers * _causal_pairs(s, s, 0, True)
    if cfg.is_encoder_decoder:   # the encoder sees run["seq"] frames
        pairs += (cfg.n_enc_layers * run["seq"] ** 2
                  + (_attn_layers(cfg) - self_layers - cfg.n_enc_layers)
                  * s * run["seq"])
    attn_fwd = 4.0 * cfg.resolved_head_dim * cfg.n_heads * b * pairs
    model_flops = 6.0 * (layer + head) * tokens + 3 * attn_fwd
    return {"model_flops": model_flops,
            "flops_with_remat": model_flops + 2.0 * layer * tokens
            + attn_fwd}


def _mamba_layers(cfg) -> int:
    return sum(k.mixer == "mamba"
               for _ in range(cfg.n_superblocks) for k in cfg.block_pattern)


def _train_launch_check(name, cfg, launches, micro_passes: int) -> dict:
    """Each attention layer launches its forward kernel twice in each
    micro-batch's pass (remat runs it again in the backward) and the
    backward kernel once; each Mamba layer the scan forward (with chunk
    states) twice and the scan backward once."""
    import torch

    from repro_torch.kernels.flash_attention import bwd_route, kernel_route

    want = {}
    if _attn_layers(cfg):
        fwd = kernel_route(torch.bfloat16, cfg.resolved_head_dim)
        bwd = bwd_route(torch.bfloat16, cfg.resolved_head_dim)
        want.update({fwd: 2 * _attn_layers(cfg) * micro_passes,
                     bwd: _attn_layers(cfg) * micro_passes})
    if _mamba_layers(cfg):
        want.update({"selective_scan": 2 * _mamba_layers(cfg) * micro_passes,
                     "selective_scan_bwd": _mamba_layers(cfg) * micro_passes})
    check(set(want) == set(MAIN_PATH[name]),
          f"{name}: routes {sorted(want)}, main path {MAIN_PATH[name]}")
    for k, n in want.items():
        check(launches[k] == n,
              f"{name}: {k} launched {launches[k]} times, not {n} (its "
              "layers x micro-batch passes, x 2 for a forward under remat)")
    return want


def _train_gemma(seed: int) -> dict:
    from repro_torch.configs import get_config

    return _train_full("train_gemma-2b", get_config("gemma-2b"), seed,
                       {"steps": TRAIN["steps"],
                        "why": "a smoke run: the loss must fall, not "
                               "converge"})


def _train_falcon(seed: int) -> dict:
    from dataclasses import replace

    from repro_torch.configs import get_config

    published = get_config("falcon-mamba-7b")
    cfg = replace(published, n_layers=TRAIN_FALCON_LAYERS)
    return _train_full(
        "train_falcon-mamba-7b", cfg, seed,
        {"n_layers": {"published": published.n_layers,
                      "run": cfg.n_layers},
         "steps": {"train": TRAIN["steps"], "run": TRAIN_FALCON["steps"],
                   "why": "the script's wall: 12 steps until the "
                          "training lines of seamless, qwen, compression "
                          "and the cluster CLI joined the script; the "
                          "step's time is steady from the second step"},
         "why": "64 layers of float32 masters, moments and gradients "
                "(7.27 B x 16 B = 117 GB) exceed one 80 GB card; "
                f"{cfg.n_layers} layers (105 M parameters, 1.68 GB of "
                "state each) fit with the embedding, the head and a "
                "layer's activations (see max_memory_allocated); a smoke "
                "run: the loss must fall, not converge"},
        run=TRAIN_FALCON)


def _train_full(name: str, cfg, seed: int, reduced_info: dict,
                run: dict = TRAIN) -> dict:
    """``train_loop`` at ``run`` (``TRAIN``): the loss falls, nothing is
    NaN, the kernels launched per layer and micro-batch pass.  An
    encoder-decoder's batches carry ``seq`` encoder frames and a vision
    front end's ``frontend_len`` patch embeddings (``step_embeds``)."""
    import contextlib
    import math

    import torch

    from repro_torch import _build
    from repro_torch.launch.train import train_loop

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hist: list = []
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        state, losses = train_loop(cfg, device="cuda", seed=seed,
                                   history=hist, log_every=run["steps"],
                                   **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    model_params = sum(p.numel() for p in state["params"].values())

    tokens = run["batch"] * _train_positions(cfg, run)
    steady = statistics.median(h["step_s"] for h in hist[1:])
    flops = _train_flops(cfg, state["params"], run)
    del state
    torch.cuda.empty_cache()
    out = {
        "phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "widths": _serve_widths(cfg),
        "vocab": cfg.padded_vocab, "params": model_params, **run,
        "positions": _train_positions(cfg, run),
        "master_dtype": cfg.param_dtype, "reduced": reduced_info,
        "wall_s": wall,
        "first_step_s": hist[0]["step_s"], "step_s_median": steady,
        "step_s": [h["step_s"] for h in hist],
        "tokens_per_s": tokens / steady,
        "max_memory_allocated": peak,
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": losses, "grad_norm": [h["grad_norm"] for h in hist],
        **flops,
        "model_flops_over_bf16_peak": flops["model_flops"] / steady
        / TENSOR_CORE_BF16_OPS_PER_S,
        "launches": launches,
    }
    emit(out)
    check(len(losses) == run["steps"], f"{name}: {len(losses)} steps")
    for h in hist:
        check(all(math.isfinite(h[k]) for k in ("loss", "ce", "grad_norm")),
              f"{name}: step {h['step']} not finite: {h}")
    check(losses[-1] < losses[0],
          f"{name}: the loss did not fall ({losses[0]} -> {losses[-1]})")
    out["launches_expected"] = _train_launch_check(
        name, cfg, launches, run["n_micro"] * run["steps"])
    return out


def _grad_diffs(got: dict, want: dict) -> dict:
    """The worst over tensors of each gradient's relative norm difference
    and of its largest elementwise difference over its largest element."""
    import torch

    return {k: v for k, (v, _) in _grad_worst(got, want).items()}


def _grad_worst(got: dict, want: dict) -> dict:
    """``_grad_diffs``'s two figures, each with the tensor it comes
    from."""
    import torch

    worst = {"grad_norm_rel": (0.0, None), "grad_max_rel": (0.0, None)}
    for k, w in want.items():
        g = got[k].float()
        w = w.float()
        wn = float(torch.linalg.vector_norm(w))
        top = float(w.abs().max())
        if top == 0.0:
            check(not bool(g.any()), f"train_check: {k} gradient not 0")
            continue
        for what, v in (("grad_norm_rel",
                         abs(float(torch.linalg.vector_norm(g)) - wn) / wn),
                        ("grad_max_rel",
                         float((g - w).abs().max()) / top)):
            if v > worst[what][0]:
                worst[what] = (v, k)
    return worst


def _train_check(seed: int) -> dict:
    """One training step's loss, gradients and global gradient norm with
    the kernels against the same with the plain attention, on the first
    ``TRAIN_CHECK_LAYERS`` layers of gemma-2b at full width."""
    import repro_torch.models.attention as attn_mod

    return _train_check_run("train_check", "gemma-2b", seed, attn_mod,
                            "attn_op", _chunked_form_attention,
                            "train_gemma-2b", "the plain attention's (b, "
                            "h, s, s) float32 scores")


def _train_check_mamba(seed: int) -> dict:
    """The same on falcon-mamba-7b's first ``TRAIN_CHECK_LAYERS`` layers
    at full width: the scan kernels against the plain scan, the spread
    measured with the JAX model code's chunked scan."""
    import repro_torch.models.ssm as ssm_mod

    return _train_check_run("train_check_mamba", "falcon-mamba-7b", seed,
                            ssm_mod, "selective_scan", _chunked_form_scan,
                            "train_falcon-mamba-7b", "the plain scan's "
                            "1024 sequential steps, each state kept for "
                            "autograd",
                            floors={"grad_norm_rel":
                                    TRAIN_MAMBA_GRAD_NORM_FLOOR},
                            layer_check=_scan_layer_check)


def _scan_layer_check(kernel_fn, n_layers: int):
    """(wrapper, check): ``wrapper`` stands in for the model's scan
    during the kernel step and keeps each layer's first (not the
    remat) call's inputs and, from the backward, its output gradient;
    ``check()`` then holds the backward kernel against
    ``selective_scan_bwd_ref`` on each layer's own inputs, within
    ``SCAN_WIDE_TOL`` of each output's largest element (a fault of the
    kernel shows there, apart from the rounding noise the whole step
    carries), and returns the largest differences."""
    import torch

    from repro_torch.kernels.selective_scan import (
        selective_scan_bwd_kernel, selective_scan_bwd_ref,
        selective_scan_kernel,
    )

    store: list = []

    def wrapper(x, dt, A, B, C, h0=None, *, impl="kernel"):
        y, hT = kernel_fn(x, dt, A, B, C, h0, impl=impl)
        if y.requires_grad and len(store) < n_layers:
            rec = {"in": [t.detach() for t in (x, dt, A, B, C)]}
            y.register_hook(lambda g, rec=rec: rec.__setitem__(
                "dy", g.detach().clone()))
            store.append(rec)
        return y, hT

    def check_layers() -> list:
        close = _close_to_max(SCAN_WIDE_TOL, SCAN_WIDE_TOL)
        out = []
        for j, rec in enumerate(store):
            x, dt, A, B, C = rec["in"]
            _, _, hc = selective_scan_kernel(x, dt, A, B, C,
                                             with_states=True)
            got = selective_scan_bwd_kernel(x, dt, A, B, C, hc, rec["dy"])
            want = selective_scan_bwd_ref(x, dt, A, B, C, rec["dy"])
            out.append({k: _max_err(g, w) / max(float(w.abs().max()), 1e-30)
                        for k, g, w in zip(SCAN_BWD_OUTPUTS, got, want)})
            for k, g, w in zip(SCAN_BWD_OUTPUTS, got, want):
                close((g,), (w,), f"train_check_mamba layer {j} {k}")
            del got, want, hc
        check(len(store) == n_layers,
              f"train_check_mamba: {len(store)} layers captured")
        store.clear()
        torch.cuda.empty_cache()
        return out

    return wrapper, check_layers


def _train_check_run(name, arch, seed, mod, attr, form, main, plain_cost,
                     floors=None, layer_check=None):
    """One training step of ``arch``'s first ``TRAIN_CHECK_LAYERS``
    layers with the kernels, with the plain version, and with the JAX
    model code's own form of the function (``form`` patched in as
    ``mod.attr``): the kernel step against the plain one within
    max(floor, ``TRAIN_SPREAD_FACTOR`` x the form's spread)."""
    from dataclasses import replace

    import torch

    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import step_embeds
    from repro_torch.models import Transformer
    from repro_torch.train import make_loss_fn

    published = get_config(arch)
    cfg = replace(published, n_layers=TRAIN_CHECK_LAYERS,
                  n_enc_layers=min(published.n_enc_layers,
                                   TRAIN_CHECK_LAYERS))
    model = Transformer(cfg, device="cuda", trainable=True)
    model.init_weights(seed)
    b = TokenPipeline(cfg.vocab_size, TRAIN_CHECK_BATCH, TRAIN["seq"],
                      seed=seed).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    batch.update(step_embeds(cfg, 0, TRAIN_CHECK_BATCH, TRAIN["seq"],
                             "cuda"))

    def step(impl, form=None):
        orig = getattr(mod, attr)
        if form is not None:
            setattr(mod, attr, form)
        try:
            model.zero_grad(set_to_none=True)
            loss, _ = make_loss_fn(model, impl=impl)(batch)
            loss.backward()
        finally:
            setattr(mod, attr, orig)
        grads = {k: p.grad.detach().clone()
                 for k, p in model.named_parameters()}
        gn = float(torch.sqrt(sum(torch.sum(g.float() ** 2)
                                  for g in grads.values())))
        return float(loss.detach()), grads, gn

    t0 = time.perf_counter()
    wrapper, check_layers = (layer_check(getattr(mod, attr),
                                         TRAIN_CHECK_LAYERS)
                             if layer_check else (None, None))
    _build.reset_launches()
    k_loss, k_g, k_gn = step("kernel", form=wrapper)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    per_layer = check_layers() if check_layers else None
    p_loss, p_g, p_gn = step("plain")
    c_loss, c_g, c_gn = step("plain", form=form)
    model.zero_grad(set_to_none=True)
    worst = {"kernel": _grad_worst(k_g, p_g),
             "chunked_form": _grad_worst(c_g, p_g)}
    err = {"loss_rel": abs(k_loss - p_loss) / abs(p_loss),
           "grad_norm_total_rel": abs(k_gn - p_gn) / p_gn,
           **_grad_diffs(k_g, p_g)}
    spread = {"loss_rel": abs(c_loss - p_loss) / abs(p_loss),
              "grad_norm_total_rel": abs(c_gn - p_gn) / p_gn,
              **_grad_diffs(c_g, p_g)}
    floors = {"loss_rel": TRAIN_LOSS_FLOOR,
              "grad_norm_total_rel": TRAIN_GRAD_NORM_TOTAL_FLOOR,
              "grad_norm_rel": TRAIN_GRAD_NORM_FLOOR,
              "grad_max_rel": TRAIN_GRAD_MAX_FLOOR, **(floors or {})}
    tol = {k: max(floors[k], TRAIN_SPREAD_FACTOR * spread[k]) for k in err}
    fwd, bwd = MAIN_PATH[main]
    units = (_attn_layers(cfg) if fwd.startswith("flash")
             else _mamba_layers(cfg))
    check(launches[fwd] == units * 2 and launches[bwd] == units,
          f"{name}: launches {launches}")
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers,
           "batch": TRAIN_CHECK_BATCH, "seq": TRAIN["seq"],
           "reduced": {"n_layers": {"published": published.n_layers,
                                    "run": cfg.n_layers},
                       **({"n_enc_layers": {
                           "published": published.n_enc_layers,
                           "run": cfg.n_enc_layers}}
                          if cfg.n_enc_layers else {}),
                       "batch": {"train": TRAIN["batch"],
                                 "run": TRAIN_CHECK_BATCH},
                       "why": "three full backward passes, one with "
                              f"{plain_cost}; the kernels' share of the "
                              "gradient is the same in every layer"},
           "loss": {"kernel": k_loss, "plain": p_loss, "chunked_form": c_loss},
           "grad_norm": {"kernel": k_gn, "plain": p_gn, "chunked_form": c_gn},
           "kernel_vs_plain": err, "chunked_form_vs_plain": spread,
           "worst_tensors": worst,
           **({"layer_bwd_max_err_over_max": per_layer}
              if per_layer is not None else {}),
           "tolerance": tol, "comparison_launches": launches,
           "wall_s": time.perf_counter() - t0}
    del model, k_g, p_g, c_g
    torch.cuda.empty_cache()
    emit(out)
    for k in err:
        check(err[k] <= tol[k], f"{name}: kernel vs plain {k} {err[k]:.4g} "
                                f"(tolerance {tol[k]:.4g})")
    return out


def _train_moe(seed: int) -> dict:
    import contextlib
    import math
    from dataclasses import replace

    import torch

    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.train import AUX_COEF

    name = "train_moe"
    published = get_config("granite-moe-3b-a800m")
    cfg = replace(published, n_layers=TRAIN_MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    hist: list = []
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        state, losses = train_loop(cfg, device="cuda", seed=seed,
                                   history=hist, **TRAIN_MOE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    del state
    torch.cuda.empty_cache()
    for h in hist:
        check(math.isfinite(h["aux"]) and h["aux"] > 0,
              f"{name}: step {h['step']} load-balance loss {h['aux']}")
        check(abs(h["loss"] - (h["ce"] + AUX_COEF * h["aux"]))
              <= 1e-5 * abs(h["loss"]),
              f"{name}: step {h['step']} loss {h['loss']} is not ce + "
              f"{AUX_COEF} x aux")
    want = _train_launch_check(name, cfg, launches,
                               TRAIN_MOE["n_micro"] * TRAIN_MOE["steps"])
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "widths": _serve_widths(cfg), **TRAIN_MOE,
           "reduced": {"n_layers": {"published": published.n_layers,
                                    "run": cfg.n_layers},
                       "steps": TRAIN_MOE["steps"],
                       "why": "the MoE layer's gradient and the load-balance "
                              "loss are the same in every layer; time"},
           "wall_s": wall, "step_s": [h["step_s"] for h in hist],
           "losses": losses, "ce": [h["ce"] for h in hist],
           "aux": [h["aux"] for h in hist],
           "grad_norm": [h["grad_norm"] for h in hist],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "launches_expected": want}
    emit(out)
    return out


def _train_resilient(seed: int) -> dict:
    import tempfile

    import torch

    from repro_torch import _build
    from repro_torch.checkpoint import FailureInjector, run_resilient
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Transformer, reduced
    from repro_torch.optim import AdamW
    from repro_torch.train import init_state, make_train_step

    name = "train_resilient"
    r = TRAIN_RESILIENT
    cfg = reduced(get_config("gemma-2b"), **TRAIN_RESILIENT_CFG)
    opt = AdamW(lr=1e-3, warmup_steps=1)
    pipe = TokenPipeline(cfg.vocab_size, r["batch"], r["seq"], seed=seed)
    # one model: each start re-seeds its weights and makes a fresh state,
    # into which run_resilient restores the latest checkpoint
    model = Transformer(cfg, device="cuda", trainable=True)
    step = make_train_step(model, opt)

    def init():
        model.init_weights(seed)
        return init_state(dict(model.named_parameters()), opt)

    def step_fn(state, i):
        b = pipe.batch_at(i)
        state, m = step(state, {k: torch.from_numpy(v).cuda()
                                for k, v in b.items()})
        return state, float(m["loss"])

    _build.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        clean, clean_rep = run_resilient(
            init, step_fn, n_steps=r["steps"], ckpt_dir=f"{d}/clean",
            ckpt_every=r["ckpt_every"])
        clean_params = {k: p.detach().clone()
                        for k, p in clean["params"].items()}
        faulty, rep = run_resilient(
            init, step_fn, n_steps=r["steps"], ckpt_dir=f"{d}/faulty",
            ckpt_every=r["ckpt_every"],
            injector=FailureInjector(fail_at=[r["fail_at"]]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    clean_loss = dict(clean_rep.history)
    loss_diff = max(abs(loss - clean_loss[i]) for i, loss in rep.history)
    param_diff = max(float((p.detach() - clean_params[k]).abs().max())
                     for k, p in faulty["params"].items())
    check(rep.restarts == 1, f"{name}: {rep.restarts} restarts, not 1")
    check(loss_diff == 0.0 and param_diff == 0.0,
          f"{name}: the resumed run differs from the clean one (losses by "
          f"{loss_diff}, parameters by {param_diff}); the step is "
          "deterministic")
    for k in MAIN_PATH[name]:
        check(launches[k] > 0, f"{name}: launched no {k}")
    del model, clean, faulty, clean_params
    torch.cuda.empty_cache()
    out = {"phase": name, "arch": cfg.name, "config": TRAIN_RESILIENT_CFG,
           **r, "reduced": {**TRAIN_RESILIENT_CFG,
                            "why": "the drill checks restart and resume, "
                                   "not scale"},
           "restarts": rep.restarts, "steps_run": rep.steps_run,
           "checkpoints": rep.checkpoints,
           "clean_steps_run": clean_rep.steps_run,
           "losses": [loss for _, loss in rep.history],
           "max_loss_diff_vs_clean": loss_diff,
           "max_param_diff_vs_clean": param_diff, "wall_s": wall,
           "launches": launches}
    emit(out)
    return out


def _train_hybrid(seed: int) -> dict:
    """jamba-1.5-large's block pattern as one super-block
    (``TRAIN_HYBRID_CFG``), bf16 masters and moments, through
    ``train_loop``: the loss finite, the load-balance loss in it, the
    scan and attention kernels each way launched per layer."""
    import contextlib
    import math
    from dataclasses import replace

    import torch

    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.train import AUX_COEF

    name = "train_hybrid"
    published = get_config("jamba-1.5-large-398b")
    cfg = replace(published, **TRAIN_HYBRID_CFG)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hist: list = []
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        state, losses = train_loop(cfg, device="cuda", seed=seed,
                                   history=hist, **TRAIN_HYBRID)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    dtypes = sorted({str(p.dtype) for p in state["params"].values()}
                    | {str(m.dtype) for m in state["opt"]["m"].values()})
    params = sum(p.numel() for p in state["params"].values())
    del state
    torch.cuda.empty_cache()
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "pattern": [f"{k.mixer}+{k.mlp}" for k in cfg.block_pattern],
           "d_model": cfg.d_model, "widths": _serve_widths(cfg),
           "d_inner": cfg.d_inner, "vocab": cfg.padded_vocab,
           "params": params, **TRAIN_HYBRID,
           "master_and_moment_dtypes": dtypes,
           "reduced": {"n_layers": {"published": published.n_layers,
                                    "run": cfg.n_layers},
                       "d_model": {"published": published.d_model,
                                   "run": cfg.d_model},
                       "n_heads": {"published": published.n_heads,
                                   "run": cfg.n_heads},
                       "n_kv_heads": {"published": published.n_kv_heads,
                                      "run": cfg.n_kv_heads},
                       "d_ff": {"published": published.d_ff,
                                "run": cfg.d_ff},
                       "steps": TRAIN_HYBRID["steps"],
                       "why": "one super-block at full width is ~88 GB of "
                              "bf16 weights (its four MoE layers 77 GB), "
                              "more than one 80 GB card; its pattern, "
                              "experts, top-2, head dim 128, kv ratio and "
                              "vocab kept at a quarter of the width"},
           "wall_s": wall, "step_s": [h["step_s"] for h in hist],
           "losses": losses, "ce": [h["ce"] for h in hist],
           "aux": [h["aux"] for h in hist],
           "grad_norm": [h["grad_norm"] for h in hist],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches}
    emit(out)
    check(dtypes == ["torch.bfloat16"],
          f"{name}: masters and moments {dtypes}, not bf16")
    for h in hist:
        check(all(math.isfinite(h[k]) for k in ("loss", "ce", "grad_norm")),
              f"{name}: step {h['step']} not finite: {h}")
        check(math.isfinite(h["aux"]) and h["aux"] > 0,
              f"{name}: step {h['step']} load-balance loss {h['aux']}")
        check(abs(h["loss"] - (h["ce"] + AUX_COEF * h["aux"]))
              <= 1e-5 * abs(h["loss"]),
              f"{name}: step {h['step']} loss {h['loss']} is not ce + "
              f"{AUX_COEF} x aux")
    out["launches_expected"] = _train_launch_check(
        name, cfg, launches, TRAIN_HYBRID["n_micro"] * TRAIN_HYBRID["steps"])
    return out


def _train_seamless(seed: int) -> dict:
    from repro_torch.configs import get_config

    return _train_full(
        "train_seamless-m4t-medium", get_config("seamless-m4t-medium"), seed,
        {"steps": TRAIN["steps"],
         "lr": {"train": TRAIN["lr"], "run": TRAIN_SEAMLESS["lr"]},
         "why": "full size; a smoke run: the loss must fall, not converge; "
                "at lr 1e-3 it rose over 12 steps, through the plain "
                "attention too (tests/train_step_profile.py lr)"},
        run=TRAIN_SEAMLESS)


def _train_qwen(seed: int) -> dict:
    from dataclasses import replace

    from repro_torch.configs import get_config

    published = get_config("qwen2-vl-72b")
    cfg = replace(published, n_layers=TRAIN_QWEN_LAYERS)
    return _train_full(
        "train_qwen2-vl-72b", cfg, seed,
        {"n_layers": {"published": published.n_layers, "run": cfg.n_layers},
         "steps": {"train": TRAIN["steps"], "run": TRAIN_QWEN["steps"],
                   "why": "the script's wall; the step's time is steady "
                          "from the second step"},
         "why": "float32 masters, gradients and two moments are 16 B a "
                "parameter: the embedding and the head (2.49 B) take 40 GB "
                "and each layer (0.88 B) 14 GB, so with AdamW's "
                "temporaries of the 5 GB embedding and the activations "
                f"{cfg.n_layers} of 80 layers fit an 80 GB card "
                "(max_memory_allocated); full width, 256 patch embeddings "
                "before 1024 tokens"},
        run=TRAIN_QWEN)


def _train_check_encdec(seed: int) -> dict:
    """``_train_check`` on seamless-m4t-medium's first
    ``TRAIN_CHECK_LAYERS`` encoder and decoder layers at full width: the
    encoder's self-attention and cross attention train non-causally
    through the kernels, at 1024 frames."""
    import repro_torch.models.attention as attn_mod

    return _train_check_run("train_check_encdec", "seamless-m4t-medium",
                            seed, attn_mod, "attn_op",
                            _chunked_form_attention,
                            "train_seamless-m4t-medium", "the plain "
                            "attention's (b, h, s, s) float32 scores")


def _train_compress(seed: int) -> dict:
    """``launch/train.py --compress`` (int8 error-feedback gradients) on
    gemma-2b's first ``TRAIN_COMPRESS_LAYERS`` layers at full width."""
    from dataclasses import replace

    from repro_torch.configs import get_config

    published = get_config("gemma-2b")
    cfg = replace(published, n_layers=TRAIN_COMPRESS_LAYERS)
    return _train_full(
        "train_compress", cfg, seed,
        {"n_layers": {"published": published.n_layers, "run": cfg.n_layers},
         "steps": TRAIN_COMPRESS["steps"],
         "why": "the quantization is per tensor and the same in every "
                "layer; time"},
        run=TRAIN_COMPRESS)


def _cluster(seed: int) -> dict:
    """``python -m repro_torch.launch.cluster`` as one NCCL process on the
    card (gemma-2b at full size, gradients averaged by
    ``compressed_psum``): the loss falls and the child's kernels launch
    per layer and micro-batch pass; then ``compressed_psum`` on a
    one-rank NCCL group of this process is its plain formula, bit for
    bit."""
    import json as _json
    import socket
    import subprocess

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.optim.compress import compressed_psum

    run = CLUSTER
    cmd = [sys.executable, "-m", "repro_torch.launch.cluster", "--arch",
           "gemma-2b", "--device", "cuda", "--compress", "--seed",
           str(seed)] + [f"--{k.replace('_', '-')}={v}"
                         for k, v in run.items()]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "MASTER_ADDR",
              "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=CLUSTER_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"cluster: exit {proc.returncode}: {proc.stderr[-2000:]}")
    out_text = proc.stdout
    first, last = (float(x) for x in re.search(
        r"first loss ([\d.]+) -> last ([\d.]+)", out_text).groups())
    launches = _json.loads(re.search(r"\[cluster\] launches (\{.*\})",
                                     out_text).group(1))
    n_micro = int(re.search(r"n_micro (\d+)", out_text).group(1))
    step_s = [float(x) for x in re.findall(r"step_s=([\d.]+)", out_text)]

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        g = torch.randn((4096, 1024), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
        got = compressed_psum(g)
        scale = torch.clamp(g.abs().max() / 127.0, min=1e-12)
        plain = torch.clamp(torch.round(g / scale), -127, 127) * scale
        same = bool(torch.equal(got, plain))
    finally:
        dist.destroy_process_group()
    cfg = get_config("gemma-2b")
    out = {"phase": "cluster", "arch": cfg.name, "command": " ".join(
               ["python"] + cmd[1:]),
           **run, "n_micro": n_micro, "world": 1, "backend": "nccl",
           "reduced": {"steps": {"run": run["steps"],
                                 "why": "compressed, the loss rose over "
                                        "3 steps, as launch/train.py "
                                        "--compress's does at this size "
                                        "(tests/compress_probe.py)"},
                       "world": 1,
                       "why": "one card: a group of one process; the "
                              "2-process step runs on the CPU (gloo) in "
                              "tests/test_torch_dist.py"},
           "wall_s": wall, "step_s": step_s, "loss_first": first,
           "loss_last": last, "compressed_psum_equals_plain": same,
           "launches": launches}
    emit(out)
    check(last < first, f"cluster: the loss did not fall ({first} -> "
                        f"{last})")
    check(same, "cluster: compressed_psum on one rank differs from "
                "round(x / scale) * scale")
    out["launches_expected"] = _train_launch_check(
        "cluster", cfg, launches, n_micro * run["steps"])
    return out


def phase_train(seed: int) -> list:
    """The train phase (module docstring, phase 11): the lines whose
    launches count toward the kernels' main-path totals."""
    runs = [_train_gemma(seed)]
    _train_check(seed)
    runs.append(_train_falcon(seed))
    _train_check_mamba(seed)
    runs.append(_train_moe(seed))
    runs.append(_train_hybrid(seed))
    runs.append(_train_resilient(seed))
    runs.append(_train_seamless(seed))
    _train_check_encdec(seed)
    runs.append(_train_qwen(seed))
    runs.append(_train_compress(seed))
    runs.append(_cluster(seed))
    return runs


# the lm_dse phase: ``launch/dse_lm.py``'s defaults on granite-8b at full
# width and depth but half its 48 training genomes (``LM_DSE_REDUCED``),
# then 8 random genomes of falcon-mamba-7b
LM_DSE = dict(n_train=24, pop_size=32, n_parents=12, n_generations=12,
              n_qor_samples=2)
LM_DSE_REDUCED = {
    "n_train": {"dse_lm_default": 48, "run": LM_DSE["n_train"]},
    "why": "the script's 1200 s limit: labeling is most of the phase, "
           "two QoR forwards and one deployment forward a training "
           "genome at 0.3-0.4 s each"}
# random genomes labeled at full size on falcon-mamba-7b and
# seamless-m4t-medium
LM_LABEL_GENOMES = 8
# QoR of the LM's designs, in dB: the JAX package's and the port's QoR on
# the same weights differ by up to 0.22 dB on the CPU at the reduced
# configs (tests/test_torch_lm_dse.py holds them to 0.5).  At full depth
# the front's QoR with the kernels is held against the plain attention's
# within max(LM_QOR_TOL_DB, LOGITS_SPREAD_FACTOR x the spread that the
# JAX model code's own form of attention shows against the plain one on
# the same designs in the same run), as the serve phases' logits.
LM_QOR_TOL_DB = 0.5


def _lm_energy(acc, lib, genome, hw) -> float:
    """A label's energy recomputed on the host from the genome:
    ``adjusted_compute`` at the cost model's energy factors plus the
    correction tables' bytes, as ``synth._finish_record`` makes it."""
    from repro_torch.kernels.approx_matmul import from_circuit

    circuits, ranks = acc.decode(genome, lib)
    specs = [from_circuit(c, r) for c, r in zip(circuits, ranks)]
    adj = acc.adjusted_compute(circuits, ranks, hw.energy_factor)
    lut_bytes = sum(256.0 * 4 * 2 * sp.rank for sp in specs)
    return adj * hw.e_flop + lut_bytes * hw.e_hbm_byte


def _lm_front_qor(acc, lib, genomes, inputs, form: str):
    """QoR of ``genomes`` with the attention run as ``form``: "plain"
    (the plain version) or "chunked" (the JAX model code's form,
    ``_chunked_form_attention``, under its own cache key)."""
    import repro_torch.models.attention as attn_mod

    if form == "plain":
        return acc.qor_batch(genomes, lib, inputs, impl="plain")
    orig = attn_mod.attn_op
    attn_mod.attn_op = _chunked_form_attention
    try:
        return acc.qor_batch(genomes, lib, inputs, impl="chunked_form")
    finally:
        attn_mod.attn_op = orig


def _lm_dse_run(acc, lib, seed: int, what: str) -> dict:
    """``run_dse`` on the LM accelerator ``acc`` at ``LM_DSE`` through a
    fresh ``SynthCache``, and its gates: the attention kernel launched
    once a layer a forward, one deployment forward a run paid, every
    label's energy the host's ``adjusted_compute``, the exact genome at
    the cap, the front's QoR with the kernels against the plain
    attention's.  Returns what the phase line reports."""
    import numpy as np
    import torch

    from repro_torch import _build
    from repro_torch.core.dse import DSEConfig, run_dse
    from repro_torch.core.features import synth
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.nsga2 import NSGA2Config
    from repro_torch.core.qor import PSNR_CAP
    from repro_torch.kernels.flash_attention import kernel_route

    cfg = acc.cfg
    w = LM_DSE
    dcfg = DSEConfig(pipeline="D", strategy="nsga2", n_train=w["n_train"],
                     n_qor_samples=w["n_qor_samples"], seed=seed,
                     nsga=NSGA2Config(pop_size=w["pop_size"],
                                      n_parents=w["n_parents"],
                                      n_generations=w["n_generations"],
                                      seed=seed))
    scache = synth.SynthCache()
    keep = synth.set_shared_synth_cache(scache)
    try:
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = run_dse(acc, lib, dcfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        synth.set_shared_synth_cache(keep)
    forwards = dict(acc.forwards)
    n_fwd = sum(forwards.values())
    stats = scache.stats()

    layers = sum(k.mixer == "attn" for k in cfg.block_pattern) * (
        cfg.n_superblocks)
    route = kernel_route(torch.bfloat16, cfg.resolved_head_dim)
    check(launches[route] == layers * n_fwd,
          f"{what}: {route} launched {launches[route]} times for {n_fwd} "
          f"forwards of {layers} attention layers")
    check(launches["selective_scan"] == 0 and launches["rank_k"] == 0,
          f"{what}: launched {launches}")
    check(forwards["deploy"] == stats["compiles"],
          f"{what}: {forwards['deploy']} deploy forwards, "
          f"{stats['compiles']} synthesis runs paid")
    g_all, l_all = res.search.genomes, res.final_labels
    front_g, front_o = res.front_genomes, res.front_objectives
    check(len(front_g) > 0 and np.all(np.isfinite(front_o)),
          f"{what}: front empty or not finite")
    for k in ("qor", "energy", "latency", "flops", "hbm_bytes"):
        check(np.all(np.isfinite(l_all[k])), f"{what}: label {k} not finite")
    # energy: bit for bit the host's adjusted_compute of each genome
    for g, e in zip(g_all, l_all["energy"]):
        check(_lm_energy(acc, lib, g, H100_SXM) == e,
              f"{what}: energy of {g.tolist()} differs from the host's "
              "adjusted_compute")
    inputs = acc.sample_inputs(w["n_qor_samples"], seed=synth.DEFAULT_QOR_SEED)
    exact = acc.exact_genome(lib)
    exact_qor = float(acc.qor_batch(exact[None], lib, inputs)[0])
    check(exact_qor == PSNR_CAP,
          f"{what}: the exact genome's QoR is {exact_qor}, not {PSNR_CAP}")
    # the front's QoR against the plain attention, and the spread of the
    # JAX model code's form against the plain one on the same designs
    t1 = time.perf_counter()
    q_plain = _lm_front_qor(acc, lib, front_g, inputs, "plain")
    q_chunk = _lm_front_qor(acc, lib, front_g, inputs, "chunked")
    resim_s = time.perf_counter() - t1
    q_kernel = -front_o[:, 0]
    err = float(np.max(np.abs(q_kernel - q_plain)))
    spread = float(np.max(np.abs(q_chunk - q_plain)))
    tol = max(LM_QOR_TOL_DB, LOGITS_SPREAD_FACTOR * spread)
    check(err <= tol, f"{what}: front QoR with the kernels differs from the "
                      f"plain attention's by {err:.4g} dB (tolerance "
                      f"{tol:.4g})")
    line = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "batch": acc.batch, "seq": acc.seq,
        **w, "pipeline": "D", "strategy": "nsga2",
        "reduced": LM_DSE_REDUCED,
        "wall_s": wall, "timings_s": res.timings, "val_pcc": res.val_pcc,
        "labels": int(len(np.unique(g_all, axis=0))),
        "forwards": forwards, "synth_cache": stats,
        "qor_s_per_forward": (float(l_all["sim_time"].sum())
                              / max(forwards["qor"] + forwards["exact"], 1)),
        "synth_s_per_run": (float(l_all["synth_time"].sum())
                            / max(stats["compiles"], 1)),
        "front_size": int(len(front_g)),
        "front_qor_range": [float(q_kernel.min()), float(q_kernel.max())],
        "front_qor_kernel_vs_plain_max_abs_db": err,
        "front_qor_chunked_form_vs_plain_max_abs_db": spread,
        "front_qor_tolerance_db": tol, "resim_s": resim_s,
        "exact_qor": exact_qor,
        "max_memory_allocated": peak, "param_bytes": acc.model.param_bytes(),
        "launches": launches,
    }
    return {"res": res, "line": line, "inputs": inputs}


def _lm_expert_pair(acc, lib, genome, what: str) -> dict:
    """Two genomes that differ only in their expert genes (a circuit
    deployed with a correction rank against the exact one), labeled on
    the card: no policy reaches the experts, so QoR, flops and bytes are
    equal and energy differs, as in the JAX package."""
    import numpy as np

    from repro_torch.core.dse import default_labeler
    from repro_torch.core.features import synth

    ex = [i for i, s in enumerate(acc.slots)
          if s.name in ("expert_in", "expert_out")]
    check(len(ex) == 2, f"{what}: {len(ex)} expert slots")
    muls = lib.kind("mul8s")
    ranked = next(i for i, c in enumerate(muls) if c.deploy_rank > 0)
    pair = np.stack([np.asarray(genome, dtype=np.int64)] * 2)
    pair[0, ex] = ranked
    pair[1, ex] = lib.exact_index("mul8s")
    labels, wall, launches = _label_once(default_labeler(
        acc, lib, n_qor_samples=LM_DSE["n_qor_samples"],
        synth_cache=synth.SynthCache(), device="cuda"), pair)
    for k in ("qor", "flops", "hbm_bytes"):
        check(labels[k][0] == labels[k][1],
              f"{what}: expert genes moved {k}: {labels[k].tolist()}")
    check(labels["energy"][0] != labels["energy"][1],
          f"{what}: expert genes did not move energy")
    return {"genomes": pair.tolist(),
            "circuits": [muls[ranked].name, muls[lib.exact_index('mul8s')].name],
            "qor": labels["qor"].tolist(),
            "energy": labels["energy"].tolist(), "wall_s": wall,
            "launches": launches}


def _lm_labels(arch: str, kernel: str, phase: str, lib, seed: int,
               n_qor_samples: int) -> dict:
    """``LM_LABEL_GENOMES`` random genomes of ``arch`` at full width and
    depth labeled through ``LMAccelerator`` (a fresh ``SynthCache``), and
    their gates: the exact genome at the cap, every energy the host's
    ``adjusted_compute``, and ``kernel`` launched ``_kernel_calls`` times
    a forward (seamless-m4t-medium: 12 encoder, 12 self and 12 cross
    attention launches).  Emits the line ``phase``; returns its
    launches."""
    import numpy as np
    import torch

    from repro_torch.accel import LMAccelerator
    from repro_torch.configs import get_config
    from repro_torch.core.dse import default_labeler
    from repro_torch.core.features import synth
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.qor import PSNR_CAP

    cfg = get_config(arch)
    acc = LMAccelerator(cfg, use_reduced=False, seed=seed, device="cuda")
    genomes = _random_genomes(acc, lib, LM_LABEL_GENOMES,
                              np.random.default_rng(seed))
    labeler = default_labeler(acc, lib, n_qor_samples=n_qor_samples,
                              synth_cache=synth.SynthCache(), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    labels, wall, launches = _label_once(labeler, genomes)
    peak = torch.cuda.max_memory_allocated()
    fwd = dict(acc.forwards)
    what = f"{phase} {arch}"
    _check_labels(labels, len(genomes), what)
    check(labels["qor"][0] == PSNR_CAP,
          f"{what}: the exact genome's QoR is not the cap")
    per_forward = _kernel_calls(cfg)[kernel]
    check(launches[kernel] == per_forward * sum(fwd.values()),
          f"{what}: {kernel} launched {launches[kernel]} times for "
          f"{sum(fwd.values())} forwards of {per_forward} calls each")
    for g, e in zip(genomes, labels["energy"]):
        check(_lm_energy(acc, lib, g, H100_SXM) == e,
              f"{what}: energy differs from the host's adjusted_compute")
    emit({
        "phase": phase, "arch": cfg.name,
        "n_layers": cfg.n_layers, "genomes": len(genomes), "wall_s": wall,
        "forwards": fwd, f"{kernel}_per_forward": per_forward,
        "qor": labels["qor"].tolist(),
        "energy": labels["energy"].tolist(),
        "flops": labels["flops"].tolist(),
        "hbm_bytes": labels["hbm_bytes"].tolist(),
        "sim_s": float(labels["sim_time"].sum()),
        "synth_s": float(labels["synth_time"].sum()),
        "max_memory_allocated": peak,
        "param_bytes": acc.model.param_bytes(), "launches": launches,
    })
    acc.release()
    del acc
    torch.cuda.empty_cache()
    return launches


def phase_lm_dse(seed: int) -> dict:
    """The paper's DSE on granite-8b at full width and depth, the budget
    tier of its front served, falcon-mamba-7b's and seamless-m4t-medium's
    labels, then the DSE on granite-moe-3b (module docstring, phase 9);
    each model freed before the next."""
    import os
    import tempfile

    import torch

    from repro_torch import _build
    from repro_torch.accel import LMAccelerator
    from repro_torch.configs import get_config
    from repro_torch.core.acl.library import default_library
    from repro_torch.launch.serve import (
        build_model, policy_from_front, serve_batch,
    )
    from repro_torch.serving import FrontCatalog
    from repro_torch.train.serve import make_prefill_step

    lib = default_library()
    total: dict = {}
    cfg = get_config("granite-8b")
    acc = LMAccelerator(cfg, use_reduced=False, seed=seed, device="cuda")
    w = LM_DSE
    run = _lm_dse_run(acc, lib, seed, "lm_dse")
    res, inputs = run["res"], run["inputs"]
    _add_launches(total, run["line"]["launches"])
    layers = cfg.n_layers
    peak = run["line"]["max_memory_allocated"]
    front_g, front_o = res.front_genomes, res.front_objectives

    # the front as a catalog; its tiers decoded by the serving CLI's path
    cat = FrontCatalog.from_front(acc.name, front_g, front_o)
    tiers, decoded = {}, {}
    with tempfile.TemporaryDirectory(prefix="lm_front_") as tmp:
        path = os.path.join(tmp, "front.json")
        with open(path, "w") as f:
            json.dump(cat.to_json(), f)
        for tier in ("budget", "balanced"):
            policy, sel = policy_from_front(cfg, path, tier)
            want = cat.select(tier=tier)
            check(sel.point.genome == want.point.genome
                  and dict(policy.assignments) == dict(acc.policy_for_genome(
                      want.point.genome_array()).assignments),
                  f"lm_dse: tier {tier} decodes to another genome than "
                  "FrontCatalog.select names")
            decoded[tier] = (policy, sel)
            tiers[tier] = {"genome": list(sel.point.genome),
                           "labels": sel.point.labels,
                           "policy": {k: list(v) for k, v in
                                      policy.assignments.items()}}
    budget_policy, budget_sel = decoded["budget"]
    circuits, _ = acc.decode(budget_sel.point.genome_array(), lib)
    acc_logits = torch.from_numpy(acc.simulate(circuits, inputs[:1])[0])
    dse_out = {"phase": "lm_dse", **run["line"], "tiers": tiers}
    emit(dse_out)
    # the accelerator stays (its model freed, rebuilt from the seed on
    # next use) for the service phase, which serves its front's tiers
    acc.release()
    torch.cuda.empty_cache()

    # the budget tier served at full width from the same seed
    b, L, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    g = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (b, L), generator=g)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, policy=budget_policy, seed=seed, device="cuda")
    timings: dict = {}
    _build.reset_launches()
    t0 = time.perf_counter()
    tokens, tps = serve_batch(cfg, batch=b, prompt_len=L, gen=gen,
                              policy=budget_policy, prompts=prompts,
                              model=model, timings=timings)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    serve_peak = torch.cuda.max_memory_allocated()
    _add_launches(total, launches)
    check(tuple(tokens.shape) == (b, L + gen)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.padded_vocab,
          f"lm_dse: served tokens {tuple(tokens.shape)} out of range")
    check(launches["flash_attention_sm90"] == layers,
          f"lm_dse: the served request launched flash_attention_sm90 "
          f"{launches['flash_attention_sm90']} times, not once a layer")
    tok = torch.from_numpy(inputs[0]).cuda()
    pre, _ = make_prefill_step(model)(tok, model.init_caches(*tok.shape))
    full = model(tok).float().cpu()
    pre = pre.float().cpu()
    want = acc_logits[:, -1:]
    serve_err = _max_err(pre, want)
    _close(FLASH_BF16_RTOL, FLASH_BF16_ATOL)(
        pre, want, "lm_dse: served prefill logits against the accelerator's")
    serve_out = {
        "phase": "lm_dse_serve", "arch": cfg.name, "tier": "budget",
        "genome": list(budget_sel.point.genome),
        "policy": {k: list(v) for k, v in budget_policy.assignments.items()},
        **SERVE, "prefill_s": timings["prefill_s"],
        "decode_s": timings["decode_s"], "decode_tokens_per_s": tps,
        "wall_s": serve_wall, "max_memory_allocated": serve_peak,
        "param_bytes": model.param_bytes(),
        "prefill_logits_vs_accelerator_max_abs": serve_err,
        "full_forward_bit_equal_to_accelerator": bool(torch.equal(
            full, acc_logits)),
        "launches": launches,
    }
    emit(serve_out)
    del model
    torch.cuda.empty_cache()
    lm_state = {"acc": acc, "catalog": cat, "prompts": prompts,
                "tokens": tokens[:, L:].cpu().tolist(),
                "genome": list(budget_sel.point.genome),
                "peak": max(peak, serve_peak)}

    # falcon-mamba-7b and seamless-m4t-medium: labels of random genomes
    # at full width and depth
    for arch, kernel, phase in (
            ("falcon-mamba-7b", "selective_scan", "lm_dse_falcon"),
            ("seamless-m4t-medium", "flash_attention_sm90",
             "lm_dse_seamless")):
        _add_launches(total, _lm_labels(arch, kernel, phase, lib, seed,
                                        w["n_qor_samples"]))

    # granite-moe-3b: the DSE at full width and depth, then two genomes
    # that differ only in their expert genes
    mcfg = get_config("granite-moe-3b-a800m")
    macc = LMAccelerator(mcfg, use_reduced=False, seed=seed, device="cuda")
    mrun = _lm_dse_run(macc, lib, seed, "lm_dse_moe")
    _add_launches(total, mrun["line"]["launches"])
    pair = _lm_expert_pair(macc, lib, mrun["res"].front_genomes[0],
                           "lm_dse_moe")
    _add_launches(total, pair["launches"])
    emit({"phase": "lm_dse_moe", **mrun["line"],
          "widths": _serve_widths(mcfg), "expert_pair": pair})
    macc.release()
    del macc
    torch.cuda.empty_cache()
    out = {"phase": "lm_dse_total", "launches": total}
    emit(out)
    return out, lm_state


# ---------------------------------------------------------------------------
# the campaign service: HTTP front end, process pool, fleet, serving tier
# ---------------------------------------------------------------------------

# every campaign of the service phase at the paper's widths (n_train
# 1000, pop 1000, 200 parents, 4 QoR images) and FIGS_HW_MODEL; the
# process-pool campaign at the dse phase's generations, the fleet's at
# FIGS_GENERATIONS with SERVICE_FLEET_QOR_MODEL
SERVICE_WIDTHS = dict(n_train=1000, pop_size=1000, n_parents=200,
                      n_qor_samples=4, hw_model=FIGS_HW_MODEL)
SERVICE_WORKERS = 2          # process-pool children, and fleet workers
SERVICE_CPU_SUBSET = 64      # stored genomes re-labeled on the CPU
SERVICE_FLEET_ACCEL = "hevc_dct4x4"
# the QoR surrogate of the fleet's campaign and its thread-backend twin:
# ridge in place of the paper's random forest, whose pure-Python fit
# (~30 s, PERF.md §7) is most of a campaign's wall; the pair checks the
# lease protocol and byte-identity, which hold with either surrogate,
# and the random forest runs in every other campaign
SERVICE_FLEET_QOR_MODEL = "ridge"
SERVICE_FLEET_CHUNK = 100    # genomes a lease: 10 leases a training batch
SERVICE_HEARTBEAT_TTL_S = 6.0
SERVICE_LEASE_TTL_S = 120.0
SERVICE_IMAGE_REQUESTS = 64
SERVICE_HTTP_THREADS = 16
SERVICE_SWAP_AFTER = 16      # drill requests served past the hot swap
# the drill's second campaign runs at SERVICE_WIDTHS from the next seed:
# the hub swaps when its front adds a point to the merged front
# (``global_front``), which the drill's gate checks
SERVICE_DRILL_THREADS = 8
SERVICE_DRILL_PAUSE_S = 0.02
LABEL_DET_KEYS = ("qor", "latency", "energy", "flops", "hbm_bytes")


def _service(mgr):
    """(HTTP server on a free local port over ``mgr``, its Client)."""
    import threading

    from repro_torch.service.api import Client, make_server

    srv = make_server(mgr, port=0)
    threading.Thread(target=srv.serve_forever, name="service-http",
                     daemon=True).start()
    return srv, Client(f"http://127.0.0.1:{srv.server_address[1]}",
                       timeout=1200.0)


def _zero_launches() -> dict:
    from repro_torch import _build

    return {k: 0 for k in _build.KERNELS}


def _stored(mgr, ctx, genomes) -> dict:
    """The store's records of ``genomes`` under ``ctx``, as label arrays."""
    import numpy as np

    recs = [mgr.store.get(ctx.key(g)) for g in genomes]
    check(all(r is not None for r in recs), "a labeled genome is not stored")
    return {k: np.array([float(r[k]) for r in recs]) for k in LABEL_DET_KEYS}


def _service_process(seed: int, generations: int, thread_wall) -> tuple:
    """Step 1: a gaussian3x3 campaign posted over HTTP to a service whose
    ground truth runs in two spawned children on the card."""
    import numpy as np

    from repro_torch import _build
    from repro_torch.core.acl.library import default_library
    from repro_torch.core.features import synth
    from repro_torch.service import CampaignManager, EvalContext

    lib = default_library()
    t0 = time.perf_counter()
    mgr = CampaignManager(device="cuda", eval_backend="process",
                          process_workers=SERVICE_WORKERS, eval_workers=2,
                          campaign_workers=2, max_batch=1000,
                          synth_cache=synth.SynthCache())
    pool_s = time.perf_counter() - t0
    srv, cli = _service(mgr)
    spec = dict(SERVICE_WIDTHS, accel="gaussian3x3",
                n_generations=generations, seed=seed)
    _build.reset_launches()
    t0 = time.perf_counter()
    cid = cli.submit(**spec)
    st = cli.wait(cid, timeout=900)
    wall = time.perf_counter() - t0
    parent = dict(_build.LAUNCHES)
    what = "service process"
    check(st["state"] == "done", f"{what}: campaign {st['state']}: "
                                 f"{st.get('error')}")
    sched = mgr.scheduler.stats()
    lab = sched["labeler"]
    check(sched["process_batches"] > 0 and sched["process_fallbacks"] == 0
          and lab["labeled"] == sched["labeled"],
          f"{what}: {sched['process_fallbacks']} batches fell back "
          f"in-process, {lab['labeled']} of {sched['labeled']} labels "
          "from the children")
    check(parent["population_lut"] == 0 and parent["rank_k"] == 0,
          f"{what}: the parent launched {parent} while children labeled")
    check(lab["chunks"] > 0 and lab["chunks_launching"].get(
              "population_lut", 0) == lab["chunks"],
          f"{what}: population_lut ran in "
          f"{lab['chunks_launching'].get('population_lut', 0)} of "
          f"{lab['chunks']} QoR chunks")
    runs_paid = lab["synth"]["compiles"]
    per_variant = DEPLOY_LAUNCHES["gaussian3x3"]
    check(runs_paid > 0 and lab["launches"]["rank_k"]
          == per_variant * runs_paid,
          f"{what}: the children launched rank_k {lab['launches']['rank_k']}"
          f" times for {runs_paid} runs paid, {per_variant} each")
    res = mgr.result(cid)
    front_o = res.front_objectives
    front_qor = -front_o[:, 0]
    check(len(front_o) > 0 and np.all(np.isfinite(front_o))
          and np.any(front_qor < front_qor.max()),
          f"{what}: front empty, not finite or without approximate designs")
    ctx = mgr._get(cid).ctx
    uniq = np.unique(res.search.genomes, axis=0)
    sub = uniq[np.random.default_rng(seed).choice(
        len(uniq), SERVICE_CPU_SUBSET, replace=False)]
    stored = _stored(mgr, ctx, sub)
    cpu = EvalContext(ctx.accel, lib, rank_genes=ctx.rank_genes,
                      n_qor_samples=ctx.n_qor_samples,
                      qor_seed=ctx.qor_seed, device="cpu",
                      hw=ctx.hw).ground_truth(sub)
    check(ctx.device == "cuda", f"{what}: the campaign's context is on "
                                f"{ctx.device}")
    for k in ("qor", "energy"):
        check(stored[k].tobytes() == np.asarray(cpu[k]).tobytes(),
              f"{what}: stored {k} differs from a CPU label on the "
              f"{SERVICE_CPU_SUBSET}-genome subset")
    out = {"phase": "service", "part": "process", "accel": "gaussian3x3",
           **spec, "workers": SERVICE_WORKERS, "pool_start_s": pool_s,
           "wall_s": wall, "thread_wall_s": thread_wall,
           "wall_ratio_process_over_thread": (
               wall / thread_wall if thread_wall else None),
           "timings_s": res.timings, "labeled": sched["labeled"],
           "batches": sched["batches"],
           "process_batches": sched["process_batches"],
           "process_fallbacks": sched["process_fallbacks"],
           "chunks": lab["chunks"],
           "chunks_launching": lab["chunks_launching"],
           "runs_paid": runs_paid, "synth": lab["synth"],
           "front_size": int(len(front_o)),
           "cpu_subset_bit_identical": {"genomes": SERVICE_CPU_SUBSET,
                                        "keys": ["qor", "energy"]},
           "parent_launches": parent, "launches": lab["launches"],
           "reduced": {"n_generations": {"paper": 1000, "run": generations},
                       "hw_model": {"repo_default": "bayesian_ridge",
                                    "run": FIGS_HW_MODEL}}}
    emit(out)
    return out, mgr, srv, cli


def _timed_serve(cli, accel, inputs, **kw):
    t0 = time.perf_counter()
    r = cli.serve(accel, inputs, **kw)
    return r, time.perf_counter() - t0


def _check_served(acc, lib, pairs, what) -> None:
    """Each (inputs, response): outputs and measured QoR equal to the
    CPU ``simulate_batch`` of the response's genome on those inputs."""
    import numpy as np

    from repro_torch.core import qor as qor_mod

    X = np.stack([x for x, _ in pairs])
    G = np.array([r["genome"] for _, r in pairs], dtype=np.int64)
    outs = acc.simulate_batch(G, lib, X, per_genome_inputs=True,
                              device="cpu")
    refs = acc.exact_output_batch(X, per_genome_inputs=True)
    for i, (_, r) in enumerate(pairs):
        check(np.array_equal(np.asarray(r["outputs"]), outs[i])
              and r["qor"] == qor_mod.psnr(refs[i], outs[i]),
              f"{what}: request {i} (genome {r['genome']}) differs from "
              "the CPU simulate_batch")


def _pct(values, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values), q))


def _service_images(mgr, cli, seed: int, generations: int) -> tuple:
    """Step 3, image requests: 64 concurrent POST /serve against step 1's
    front over the three tiers and an energy budget, then a hot-swap
    drill: a second campaign's front swapped in under traffic."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch import _build
    from repro_torch.core.acl.library import default_library
    from repro_torch.service import make_accelerator

    lib = default_library()
    acc = make_accelerator("gaussian3x3")
    name = acc.name
    gf = mgr.global_front(name, ("qor", "energy"))
    energy = float(np.median(np.asarray(gf["front"])[:, 1]))
    selects = [{"tier": "exact"}, {"tier": "balanced"}, {"tier": "budget"},
               {"budget": {"energy": energy}}]
    inputs = [acc.sample_inputs(2, seed=10_000 + i)
              for i in range(SERVICE_IMAGE_REQUESTS)]
    _build.reset_launches()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVICE_HTTP_THREADS) as ex:
        futs = [ex.submit(_timed_serve, cli, name, inputs[i],
                          return_outputs=True, **selects[i % len(selects)])
                for i in range(SERVICE_IMAGE_REQUESTS)]
        served = [f.result() for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    what = "service serve_images"
    check(launches["population_lut"] > 0,
          f"{what}: the requests launched no population_lut")
    results = [r for r, _ in served]
    check(all(r["catalog_version"] == 1 for r in results),
          f"{what}: not every request served at catalog version 1")
    _check_served(acc, lib, list(zip(inputs, results)), what)
    eng = mgr.serving.engine_for(name)
    st = eng.stats()
    check(st["errors"] == 0 and st["responses"] == SERVICE_IMAGE_REQUESTS,
          f"{what}: engine stats {st}")
    out_images = {
        "phase": "service", "part": "serve_images", "accel": name,
        "requests": SERVICE_IMAGE_REQUESTS, "http_threads":
        SERVICE_HTTP_THREADS, "images_per_request": 2,
        "selects": selects, "wall_s": wall,
        "requests_per_s": SERVICE_IMAGE_REQUESTS / wall,
        "client_latency_s": {"p50": _pct([t for _, t in served], 50),
                             "p99": _pct([t for _, t in served], 99)},
        "engine_latency_s": {"p50": _pct([r["latency_s"] for r in results],
                                         50),
                             "p99": _pct([r["latency_s"] for r in results],
                                         99)},
        "batches": st["batches"], "groups": st["groups"],
        "tier_selections": st["tier_selections"],
        "front_points": st["catalog"]["points"],
        "cpu_bit_identical": SERVICE_IMAGE_REQUESTS,
        "launches": launches}
    emit(out_images)

    # hot-swap drill: traffic runs while a second campaign completes
    v0 = eng.catalog.version
    spec = dict(SERVICE_WIDTHS, accel=name,
                n_generations=FIGS_GENERATIONS, seed=seed + 1)
    _build.reset_launches()
    pool_before = mgr.scheduler.stats()["labeler"]["launches"]
    cid = cli.submit(**spec)
    stop = threading.Event()
    drill: list = []
    errors: list = []
    lock = threading.Lock()

    def traffic(worker: int) -> None:
        i = 0
        while not stop.is_set():
            x = acc.sample_inputs(2, seed=20_000 + 1000 * worker + i)
            sel = selects[(worker + i) % len(selects)]
            try:
                r = cli.serve(name, x, return_outputs=True, **sel)
            except Exception as exc:  # noqa: BLE001 - counted, then gated
                with lock:
                    errors.append(repr(exc))
                return
            with lock:
                drill.append((x, sel, r))
            i += 1
            time.sleep(SERVICE_DRILL_PAUSE_S)

    threads = [threading.Thread(target=traffic, args=(w,), daemon=True)
               for w in range(SERVICE_DRILL_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    # until SERVICE_SWAP_AFTER requests ran on the swapped front, or the
    # campaign failed, or a minute passed after it ended with no swap
    deadline = time.monotonic() + 900
    ended = None
    while time.monotonic() < deadline and not errors:
        state = mgr.status(cid)["state"]
        if state == "failed":
            break
        if state == "done":
            with lock:
                after = sum(r["catalog_version"] > v0 for _, _, r in drill)
            if after >= SERVICE_SWAP_AFTER:
                break
            ended = ended or time.monotonic()
            if time.monotonic() - ended > 60:
                break
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    drill_wall = time.perf_counter() - t0
    launches2 = dict(_build.LAUNCHES)
    what = "service hot_swap"
    check(not errors, f"{what}: dropped requests: {errors[:3]}")
    check(mgr.status(cid)["state"] == "done",
          f"{what}: second campaign {mgr.status(cid)}")
    versions = sorted({r["catalog_version"] for _, _, r in drill})
    check(eng.catalog.version > v0 and versions[0] == v0
          and versions[-1] > v0,
          f"{what}: no hot swap under traffic (versions served {versions}, "
          f"catalog v{eng.catalog.version})")
    for x, sel, r in drill:
        cat = eng._catalogs.get(r["catalog_version"])
        check(cat is not None and list(cat.select(**sel).point.genome)
              == r["genome"],
              f"{what}: a response's genome is not its catalog's choice")
    check(eng.stats()["errors"] == 0, f"{what}: engine errors")
    sample = drill[:: max(1, len(drill) // 32)]
    _check_served(acc, lib, [(x, r) for x, _, r in sample], what)
    pool_after = mgr.scheduler.stats()["labeler"]["launches"]
    children = {k: pool_after[k] - pool_before.get(k, 0)
                for k in pool_after}
    total = {k: launches2.get(k, 0) + children.get(k, 0)
             for k in set(launches2) | set(children)}
    out_swap = {
        "phase": "service", "part": "hot_swap", "accel": name,
        "second_campaign": spec, "wall_s": drill_wall,
        "requests": len(drill), "versions_served": versions,
        "served_after_swap": sum(r["catalog_version"] > v0
                                 for _, _, r in drill),
        "client_threads": SERVICE_DRILL_THREADS,
        "pause_s": SERVICE_DRILL_PAUSE_S, "dropped": 0,
        "cpu_checked": len(sample), "hot_swaps": eng.stats()["hot_swaps"],
        "parent_launches": launches2, "children_launches": children,
        "launches": total,
        "reduced": {"n_generations": {"paper": 1000,
                                      "run": FIGS_GENERATIONS},
                    "hw_model": {"repo_default": "bayesian_ridge",
                                 "run": FIGS_HW_MODEL}}}
    emit(out_swap)
    return out_images, out_swap


def _service_lm(mgr, cli, lm_state) -> dict:
    """Step 3, LM requests: the lm_dse phase's granite-8b accelerator and
    its front registered with the manager's hub (no second model), the
    budget tier served through POST /serve to 8 concurrent 1024-token
    prompts, 32 tokens each, against the lm_dse_serve line's tokens."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch import _build

    acc, cat = lm_state["acc"], lm_state["catalog"]
    b, gen = SERVE["batch"], SERVE["gen"]
    eng = mgr.serving.register(acc, cat, max_batch=b, max_wait_s=60.0)
    prompts = lm_state["prompts"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(b) as ex:
        futs = [ex.submit(_timed_serve, cli, acc.name, prompts[i].tolist(),
                          tier="budget", gen=gen) for i in range(b)]
        served = [f.result() for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    what = "service serve_lm"
    results = [r for r, _ in served]
    st = eng.stats()
    check(st["groups"] == 1 and all(r["group_size"] == b for r in results),
          f"{what}: the {b} prompts ran in {st['groups']} groups")
    check(all(r["genome"] == lm_state["genome"] for r in results),
          f"{what}: the budget tier is not the lm_dse_serve genome")
    for i, r in enumerate(results):
        check(r["tokens"] == lm_state["tokens"][i],
              f"{what}: prompt {i}'s tokens differ from lm_dse_serve's")
    layers = acc.cfg.n_layers
    check(launches["flash_attention_sm90"] == layers * st["groups"],
          f"{what}: flash_attention_sm90 launched "
          f"{launches['flash_attention_sm90']} times for {st['groups']} "
          f"prefill of {layers} layers")
    check(peak <= lm_state["peak"] + 2 ** 30,
          f"{what}: peak {peak} bytes, more than 1 GiB over the lm_dse "
          f"phase's {lm_state['peak']}: a second model?")
    out = {"phase": "service", "part": "serve_lm", "accel": acc.name,
           "tier": "budget", "genome": lm_state["genome"], **SERVE,
           "requests": b, "wall_s": wall,
           "prefill_s": results[0]["prefill_s"],
           "decode_s": results[0]["decode_s"],
           "decode_tokens_per_s": results[0]["tokens_per_s"],
           "client_latency_s": {"p50": _pct([t for _, t in served], 50),
                                "max": max(t for _, t in served)},
           "tokens_equal_lm_dse_serve": True,
           "max_memory_allocated": peak,
           "lm_dse_peak": lm_state["peak"],
           "param_bytes": acc.model.param_bytes(), "launches": launches}
    emit(out)
    acc.release()
    torch.cuda.empty_cache()
    return out


def _spawn_fleet_worker(base: str, wid: str, log_dir: str):
    import os

    log = open(os.path.join(log_dir, f"{wid}.log"), "w")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.fleet.worker",
         "--orchestrator", base, "--id", wid, "--device", "cuda",
         "--max-idle-s", "900"],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
    return proc, log


def _wait_until(pred, timeout: float, what: str, procs=()) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        for p, log in procs:
            if p.poll() is not None:
                log.flush()
                tail = Path(log.name).read_text()[-2000:]
                check(False, f"{what}: worker exited {p.returncode}:\n{tail}")
        check(time.monotonic() < deadline, f"{what}: timed out")
        time.sleep(0.002)


def _service_fleet(seed: int) -> dict:
    """Step 2: an hevc_dct4x4 campaign on the thread backend, then the
    same spec on the fleet backend with two worker processes on the card,
    one killed (SIGKILL) while it holds a lease."""
    import signal
    import tempfile

    import numpy as np

    from repro_torch import _build
    from repro_torch.core.features import synth
    from repro_torch.service import CampaignManager, CampaignSpec

    spec = dict(SERVICE_WIDTHS, accel=SERVICE_FLEET_ACCEL,
                qor_model=SERVICE_FLEET_QOR_MODEL,
                n_generations=FIGS_GENERATIONS, seed=seed)
    what = "service fleet"
    ref_mgr = CampaignManager(device="cuda", eval_workers=2,
                              campaign_workers=2, max_batch=1000,
                              synth_cache=synth.SynthCache())
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        rcid = ref_mgr.submit(CampaignSpec(**spec))
        state = ref_mgr.wait(rcid, timeout=900)
        thread_wall = time.perf_counter() - t0
        thread_launches = dict(_build.LAUNCHES)
        check(state == "done", f"{what}: thread campaign {state}")
        ref = ref_mgr.result(rcid)
        ref_stored = _stored(ref_mgr, ref_mgr._get(rcid).ctx,
                             np.unique(ref.search.genomes, axis=0))
    finally:
        ref_mgr.shutdown()

    mgr = CampaignManager(device="cuda", eval_backend="fleet",
                          eval_workers=2, campaign_workers=2, max_batch=1000,
                          lease_ttl_s=SERVICE_LEASE_TTL_S,
                          heartbeat_ttl_s=SERVICE_HEARTBEAT_TTL_S,
                          fleet_chunk=SERVICE_FLEET_CHUNK,
                          synth_cache=synth.SynthCache())
    srv, cli = _service(mgr)
    fleet = mgr.scheduler.fleet
    procs = []
    with tempfile.TemporaryDirectory(prefix="fleet_") as logs:
        try:
            t0 = time.perf_counter()
            procs = [_spawn_fleet_worker(cli.base, f"w{i}", logs)
                     for i in range(SERVICE_WORKERS)]
            _wait_until(lambda: fleet.stats()["live"] == SERVICE_WORKERS,
                        300, f"{what}: workers to register", procs)
            join_s = time.perf_counter() - t0
            _build.reset_launches()
            t0 = time.perf_counter()
            cid = cli.submit(**spec)

            def victim_holds_second_lease():
                with fleet._cv:
                    w = fleet._workers["w0"]
                    return w.chunks >= 1 and any(
                        lease.worker == "w0"
                        for lease in fleet._leases.values())

            _wait_until(victim_holds_second_lease, 600,
                        f"{what}: w0 to hold a lease after a result", procs)
            procs[0][0].send_signal(signal.SIGKILL)
            killed_at = time.perf_counter() - t0
            st = cli.wait(cid, timeout=900)
            wall = time.perf_counter() - t0
            parent = dict(_build.LAUNCHES)
            check(st["state"] == "done",
                  f"{what}: fleet campaign {st['state']}: {st.get('error')}")
            res = mgr.result(cid)
            fs = fleet.stats()
            sched = mgr.scheduler.stats()
            stored = _stored(mgr, mgr._get(cid).ctx,
                             np.unique(res.search.genomes, axis=0))
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=60)
                log.close()
            srv.shutdown()
            mgr.shutdown()
    check(np.array_equal(res.front_genomes, ref.front_genomes)
          and res.front_objectives.tobytes()
          == ref.front_objectives.tobytes(),
          f"{what}: the front differs from the thread backend's")
    check(np.array_equal(np.unique(res.search.genomes, axis=0),
                         np.unique(ref.search.genomes, axis=0)),
          f"{what}: labeled another genome set than the thread backend")
    for k in LABEL_DET_KEYS:
        check(stored[k].tobytes() == ref_stored[k].tobytes(),
              f"{what}: a stored {k} differs from the thread backend's")
    check(fs["requeues"] >= 1 and fs["expired_leases"] >= 1,
          f"{what}: the killed lease never requeued ({fs['requeues']})")
    check(sched["fleet_batches"] > 0 and sched["fleet_fallbacks"] == 0,
          f"{what}: {sched['fleet_fallbacks']} batches fell back "
          "in-process")
    workers = fs["workers"]
    # in-process labels only as the orchestrator's reclaims: rank_k at
    # most once a synthesis run for each reclaimed genome, population_lut
    # at most a worker's most launches a chunk for each reclaimed chunk
    lut_per_chunk = max(-(-w["launches"].get("population_lut", 0)
                          // max(1, w["chunks"])) for w in workers.values())
    check(parent["rank_k"] <= fs["local_labels"]
          * DEPLOY_LAUNCHES[SERVICE_FLEET_ACCEL]
          and parent["population_lut"] <= fs["local_fallback_chunks"]
          * lut_per_chunk,
          f"{what}: the parent launched {parent} for "
          f"{fs['local_fallback_chunks']} reclaimed chunks "
          f"({fs['local_labels']} labels)")
    for wid, w in workers.items():
        check(w["launches"].get("population_lut", 0) > 0
              and w["launches"].get("rank_k", 0) > 0
              and w["device"].startswith("cuda"),
              f"{what}: worker {wid} reported {w['device']} launches "
              f"{w['launches']}")
    worker_launches = _zero_launches()
    for w in workers.values():
        _add_launches(worker_launches, w["launches"])
    total = dict(worker_launches)
    _add_launches(total, thread_launches)
    _add_launches(total, parent)
    out = {"phase": "service", "part": "fleet", "accel": SERVICE_FLEET_ACCEL,
           **spec, "workers": SERVICE_WORKERS, "lease_chunk":
           SERVICE_FLEET_CHUNK, "heartbeat_ttl_s": SERVICE_HEARTBEAT_TTL_S,
           "workers_join_s": join_s, "thread_wall_s": thread_wall,
           "fleet_wall_s": wall, "killed_w0_at_s": killed_at,
           "front_size": int(len(res.front_genomes)),
           "front_and_labels_identical_to_thread": True,
           "fleet": {k: fs[k] for k in (
               "batches", "chunks", "requeues", "expired_leases",
               "dead_workers", "duplicate_results", "local_fallback_chunks",
               "remote_labels", "local_labels")},
           "per_worker": {wid: {k: w[k] for k in (
               "alive", "labels", "chunks", "labels_per_sec", "device",
               "launches")} for wid, w in workers.items()},
           "thread_launches": thread_launches, "parent_launches": parent,
           "launches": total,
           "reduced": {"n_generations": {"paper": 1000,
                                         "run": FIGS_GENERATIONS},
                       "hw_model": {"repo_default": "bayesian_ridge",
                                    "run": FIGS_HW_MODEL},
                       "qor_model": {"repo_default": "random_forest",
                                     "run": SERVICE_FLEET_QOR_MODEL,
                                     "why": "time: the forest's fit is "
                                            "most of a campaign's wall; "
                                            "the pair checks the leases "
                                            "and byte-identity"}}}
    emit(out)
    return out


def phase_service(seed: int, generations: int, dse_walls: dict,
                  lm_state) -> dict:
    """The campaign service's HTTP front end, process pool, fleet and
    serving tier on the card (module docstring, phase 11)."""
    import torch

    total = _zero_launches()
    out, mgr, srv, cli = _service_process(seed, generations,
                                          dse_walls.get("gaussian3x3"))
    _add_launches(total, out["launches"])
    try:
        images, swap = _service_images(mgr, cli, seed, generations)
        _add_launches(total, images["launches"])
        _add_launches(total, swap["launches"])
        if lm_state is not None:
            lm = _service_lm(mgr, cli, lm_state)
            _add_launches(total, lm["launches"])
    finally:
        srv.shutdown()
        mgr.shutdown()
    torch.cuda.empty_cache()
    fleet = _service_fleet(seed)
    _add_launches(total, fleet["launches"])
    for k in MAIN_PATH["service"]:
        check(total[k] > 0 or (k == "flash_attention_sm90"
                               and lm_state is None),
              f"service: launched no {k} kernel")
    line = {"phase": "service_total", "launches": total}
    emit(line)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # 100 until the service phase joined the script, 50 until its
    # hot-swap campaign ran at the paper's widths (see FIGS_GENERATIONS)
    ap.add_argument("--generations", type=int, default=25,
                    help="NSGA-II generations of the dse phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (device and build always run); the summary and the "
                    "last line are printed only when all run")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    try:
        info = phase_device()
        phase_build()
        rows = phase_kernels(args.seed) if "kernel" in phases else []
        if "kernel" in phases:
            phase_lut_crossover(args.seed)
            phase_rank_k_fresh()
        runs = []
        if "labels" in phases:
            runs += [phase_labels(acc, batches, args.seed, reduced=reduced)
                     for acc, batches, reduced in _label_accels()]
            from repro_torch.accel import GaussianFilter

            runs.append(phase_labels(GaussianFilter(), 1, args.seed,
                                     structural=False))
        hevc_result = None
        if "dse" in phases:
            from repro_torch.accel import GaussianFilter, HEVCDct

            runs.append(phase_dse(GaussianFilter(), args.generations)[0])
            line, hevc_result = phase_dse(HEVCDct(), args.generations)
            runs.append(line)
        if "cache" in phases:
            from repro_torch.accel import GaussianFilter, HEVCDct

            runs += [phase_cache(acc, args.seed)
                     for acc in (GaussianFilter(), HEVCDct())]
        if "figs" in phases:
            runs.append(phase_figs(args.seed, hevc_result))
        if "hier" in phases:
            runs.append(phase_hier(args.seed))
        lm_state = None
        if "lm_dse" in phases:
            line, lm_state = phase_lm_dse(args.seed)
            runs.append(line)
        if "serve" in phases:
            for arch in SERVE_ARCHS:
                runs.append(phase_serve(arch, args.seed))
                if arch == "granite-8b":
                    runs.append(phase_serve(arch, args.seed, approx=True))
        if "train" in phases:
            runs += phase_train(args.seed)
        if "service" in phases:
            dse_walls = {r["accel"]: r["wall_s"] for r in runs
                         if r.get("phase") == "dse"}
            runs.append(phase_service(args.seed, args.generations,
                                      dse_walls, lm_state))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "repro")
                    or m.startswith(("jax.", "repro.")))
    if leaked:
        print(f"chip_smoke: FAIL: imported {leaked[:5]}", file=sys.stderr)
        return 1
    if phases != set(PHASES):
        print("chip_smoke: not every phase ran; no summary", file=sys.stderr)
        return 3
    for row in rows:
        row["launches"] = sum(r["launches"][row["name"]] for r in runs)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
