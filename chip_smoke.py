#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which stops the run on failure and prints its seconds
when it ends:
  1. print the card's name and power limit; turn TF32 off;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (the
     build keeps ptxas's report, which phase 8 reads for the Dh 192 bf16
     kernels' registers and spills);
  3. hold K1 (the EM E-step) against its plain version on the card, at the
     pFedWN round's shape, the reference's test sweep, both sides of each
     of the kernel's team-size and token-tile switches (V up to
     smollm-135m's vocabulary of 49,152, M 1 to 32), M past 32 (33 to
     1000, on both sides of its output-staged path at 256), labels at a
     row's ends, a view 4 bytes off an 8-byte boundary and logits 100x the
     sweep's, fp32 and bf16;
  4. hold K2 (the Eq-1 mix) against its plain version at the cifar10-cnn
     shape (P = 188,810, M = 10), then at row strides of 188,810, 188,811
     and 188,812 with M = 1, 10, 32 and 33 to 1000 (chunks of 32 rows);
     fp32 and bf16, links up and all erased;
  5. run a small simulation of each of the six methods (and pFedWN with
     uniform π and no erasures) on the card and on the CPU (plain kernels)
     with the same draws and compare params, accuracies, π and the
     train-loss tap; then run the pFedWN main path at full width
     (cifar10-cnn, 11 clients, quickstart's wireless scenario) and check
     that each kernel carried it; then one round of it at cifar100-cnn's
     width (P 200,420, 100 classes: K1 at V 100, held in phase 3);
  5b. run ``local`` and the four baselines (FedAvg, FedProx, Per-FedAvg,
     FedAMP) on the same full-width scenario, check their taps and
     accuracies and that neither K1 nor K2 launched, and print each one's
     ms per round; then hold FedAvg's aggregate and FedAMP's attention
     and clouds on the last run's full-width stack against the same calls
     on the CPU;
  5c. pFedWN past 32 neighbours (M = 39, every one of 40 clients taking
     part): a small run on the card against the CPU, then the main path at
     full width (cifar10-cnn, 16,000 images in even shards, P_err ~ U(0,
     0.1)), checking that K1 launched ``em_iters`` times a round and K2
     once a round, and printing ms per round;
  5d. every method on the legacy host-driven engine (``fused=False``)
     against the fused engine on the card (a small run), then each
     engine's ms per round at the full-width scenario of phase 5;
  5e. RunRecord: phase 5's small pFedWN run recorded on the card and on
     the CPU into a temporary directory; both files pass the port's
     validator and ``python -m repro_torch.obs.report``, their round and
     eval events agree (train loss, entropy, effective neighbours and π
     within 1e-4, link success rate exactly, accuracies within 5e-3), a
     compile event carries FLOPs; a recorded run syncs no more often than
     an unrecorded one (``torch.cuda.set_sync_debug_mode("warn")``); then
     the full-width pFedWN ms per round with the taps on and off
     (interleaved runs, medians; printed, not asserted);
  5f. the client-sharded engine (``FedSimConfig(sharded=True)``, one
     process a rank through ``repro_torch.sharding.spawn``; the card is
     one, so D = 1 runs nccl and D > 1 runs gloo, all ranks on this card):
     every method of phase 5's small run at D = 2 against the fused engine
     on the card (accuracies 5e-3, π and params 1e-4, K1 and K2 launches a
     rank); then pFedWN on phase 5c's full-width scenario at D = 1, 2 and
     4 against phase 5c's fused run (D = 1: params and π within 1e-4; D >
     1: params and π, final and at the first eval point, within 10× of
     the fused run's own move under a rounding-sized change of its
     initial params and closer than a fused run on other draws; K1 20 and
     K2 4
     launches a rank, collectives a round, host syncs a block: one at
     D = 1; gloo's are printed), with ms per round; then one ``pod_mix``
     at C = 2 (a cifar10-cnn-sized tree) against the Eq-1 arithmetic in
     numpy;
  6. hold K3 (GQA flash attention) against its plain version, fp32 and
     bf16, over the reference's sweep, two ragged shapes, the prefill
     attention shapes of smollm-135m, starcoder2-15b (window 4096) and
     chatglm3-6b, and shapes at the kernel's tile edges; at MLA's head dims
     48 and 96 over the sweep's shapes, ragged shapes, the tile edges of
     those dims and minicpm3-4b's prefill (B 8, S 1024, H 40, KH 40, Dh
     96), with the fp32 training instantiation there (output bitwise the
     serving one's, row LSE against the plain one); at zamba2's head dim
     112 over the sweep's shapes, ragged shapes, the tile edges and
     zamba2-7b's prefill (B 8, S 1024, H 32, KH 32, causal, and with a
     window of 256), with the training instantiation too; at deepseek-v3's
     MLA head dim 192 (``ATTN_DS_SHAPES``: its full-width prefill, B 8 x
     S 1024, 128 heads, the sweep's shapes, ragged, windowed, fully
     masked rows, the tile edges (keys at and off the bf16 kernel's
     112-key tile) and B x KH below and above the card's 132 SMs) in fp32
     and bf16, with the fp32 training instantiation; then K3's
     backward (``csrc/flash_attention_bwd.cu``: split-TF32 ``wgmma``, dK/dV
     split over blocks where one a key tile leaves SMs idle, through the
     autograd path) against ``flash_attention_bwd_ref`` in float64 on the
     card over the reference's sweep, ragged shapes and tile edges, causal
     and window, G 1 to 16, Dh 48, 64, 96, 112, 128 and 192 (192 at
     ``BWD_DS_SHAPES``, below, by its own dK/dV and dQ kernels; at 48, 96
     and 112: queries off each query step, keys off the 64-key tile and the dQ
     kernel's key steps, G > 1, windows), minicpm3-4b's (B 8, S 256, H 40,
     Dh 96), zamba2-7b's (H 32, Dh 112) and granite-moe's (H 24 over KH
     8) training shapes and Dh 48 at B 2 x S 64, smollm-135m's training
     (B 8, S 256), federated (B 4, S 128) and serving (B 8, S 1024) shapes and
     fully masked rows (whose grads must be 0): two runs bitwise equal,
     the training forward's output bitwise the serving forward's, its row
     LSE against the plain one; also at qwen2-vl's and musicgen's
     prefill (B 8, S 1280, H 12, KH 2, Dh 128; B 8, S 1088, H 32, KH 32,
     Dh 64) and training (B 8 x S 512 and 320) shapes; then K3 with
     explicit positions (its position instantiations, forward, LSE and
     backward, fp32, the forward and (PR 29) the backward also bf16, under
     the bf16 backward's gate below) at qwen2-vl's and musicgen's
     heads over S 320: the arange (output, LSE and gradients bitwise the
     index path's), M-RoPE's temporal component (256 patches tied at 0,
     then text from 16), a tail of -1s, a window of 256, keys past the
     first 50 queries (fully masked rows, which must give 0) and the
     M-RoPE positions permuted under a window of 100, and the same checks
     at Dh 48, 96, 112 and 192 (the backward by positions in fp32 and
     bf16 there), and the fp32 kernels at Dh 192 by positions at every
     shape of ``ATTN_DS_SHAPES`` and ``BWD_DS_SHAPES``; then the forward at
     qwen2-vl's prefill under its M-RoPE prompt's positions and the bf16
     backward at its training shape under them; K3's fp32
     backward also at chatglm3-6b's training shape (B 8, S 256, 32 heads
     over 2: G 16, Dh 128), and K3's bf16 training forward and backward
     (``csrc/flash_attention_bf16.cu`` and
     ``csrc/flash_attention_bwd_bf16.cu``: one bf16 ``wgmma`` a product;
     ``BWD_BF16_SHAPES``: that shape, train_4k's at B 2, the sweep's Dh
     64 and 128 shapes, ragged, windowed, G 1 to 16, fully masked rows, a
     split plan, and (PR 29) Dh 48, 96 and 112 at minicpm3-4b's, zamba2-7b's
     and reduced MLA's training shapes, ragged, windowed, split; and Dh
     192's ``BWD_DS_SHAPES``, which the fp32 check above takes too:
     deepseek-v3's training shape at full width, B 8 x S 256, 128 heads,
     a split plan, ragged, windowed, G > 1, fully masked rows, keys off
     the 64-key tile, B x KH below and above 132) against the
     float64 plain backward of the same
     bf16 values within 2e-2 and within twice the error of the plain version
     of the kernels' bf16 arithmetic (``flash_attention_bwd_bf16_ref``:
     P and dS rounded to bf16 before their products) + 1e-4, the LSE
     within 1e-5, two runs bitwise equal, only the bf16 kernels launched;
  7. serve a reduced smollm-135m on the card and on the CPU (plain
     kernels) with the same weights and prompts, without and with a window
     that wraps, and compare logits and tokens; then serve the main path at
     full width (smollm-135m, 8 prompts of 1024 tokens, 32 generated) and
     check that K3 carried every layer of the prefill; then MLA: a reduced
     minicpm3-4b (K3 at Dh 48) on the card against the CPU (logits within
     1e-4, tokens equal) and its first weight-absorbed decode step against
     a prefill of the P + 1 tokens on the card (1e-4); then minicpm3-4b at
     full width and depth (62 layers, 4.3 B params, fp32, random weights,
     8 prompts of 1024 tokens, 32 generated: K3 at Dh 96 launches 62
     times a prefill, logits finite, tokens in range; prefill ms, decode ms
     a step, tok/s, peak memory and the decode-vs-prefill gap printed);
  7c. MoE serving: reduced granite-moe-3b-a800m (K3 at Dh 64) and reduced
     deepseek-v3-671b (MLA, K3 at Dh 48; a dense layer, a shared expert)
     on the card against the CPU with the same weights and ragged prompts,
     free of drops and at a capacity factor that drops (logits within
     1e-4, tokens equal; the dropped pairs and the smallest gap between a
     token's k-th and (k+1)-th router probability printed); the dispatch
     run under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
     then granite-moe-3b-a800m at full width and depth (32 layers of 40
     experts, 3.37 B params, fp32, random weights, 8 prompts of 1024
     tokens, 32 generated: K3 launches 32 times a prefill, logits finite,
     tokens in range; prefill ms, decode ms a step, tok/s, peak memory and
     the share of pairs the prefill drops printed); its weights are freed
     before 7d;
  7d. SSM serving: reduced falcon-mamba-7b (Mamba1, no attention) and
     reduced zamba2-7b (Mamba2 and its shared attention block, K3 at Dh
     64), also with a window of 8 that the prompt wraps, on the card
     against the CPU with the same weights and ragged prompts (logits
     within 1e-4, tokens equal) and the first decode step against a
     prefill of the P + 1 tokens on the card (1e-4); then each at full
     width and depth (falcon-mamba-7b: 64 layers, 7.27 B params;
     zamba2-7b: 81 layers and 13 applications of the shared block, 6.75 B
     params; fp32, random weights, 8 prompts of 1024 tokens, 32
     generated: K3 at Dh 112 launches 13 times a zamba2 prefill and 0
     times a falcon-mamba one, logits finite, tokens in range; prefill ms,
     decode ms a step, tok/s, peak memory and the decode-vs-prefill gap
     printed), each model's weights freed before the next and before 7e;
  7e. stub-prefix families: reduced qwen2-vl-2b (M-RoPE, qkv biases) and
     musicgen-large (no rope, G 1) served after their zero stub prefix on
     the card against the CPU (logits within 1e-4, tokens equal, K3 once a
     layer by index) and the first decode step against a prefill of the P
     + 1 tokens on the card; then under custom M-RoPE positions and random
     stub embeddings a prefill (logits and caches) and ``loss_fn`` with its
     gradients card vs CPU (1e-4; K3's position path once a layer each
     way); then each at full width and depth (qwen2-vl-2b: 28 layers,
     1.78 B params; musicgen-large: 48 layers, 3.23 B; fp32, random
     weights): a serve of 8 prompts of 1024 tokens after the 256- or
     64-token stub prefix, 32 generated (K3 once a layer; prefill ms,
     decode ms a step, tok/s, peak memory), for qwen2-vl one prefill under
     its M-RoPE positions (the prefix a 16 x 16 image: K3's position path
     once a layer), and 4 single-client SGD steps at B 8 x S 256 after a
     prefix of N(0, 0.02²) embeddings (the reference trainer's zero prefix
     overflows the backward at depth: ROADMAP C6; K3 forward and each
     backward kernel once a layer a step, the loss finite and falling; ms
     a step, peak memory); each model's weights freed before the next and
     before 7f;
  7f. family training: reduced granite-moe-3b-a800m, deepseek-v3-671b
     (MLA at Dh 48, a dense layer, a shared expert, the MTP head),
     minicpm3-4b (Dh 48), falcon-mamba-7b and zamba2-7b, 3 single-client
     SGD steps on the card against the CPU with the same weights and
     batches (losses and params within 1e-4; K3's forward and each
     backward kernel once an attention layer a step), and one federated
     round at C = 3 of granite-moe and zamba2 likewise; then
     granite-moe-3b-a800m, minicpm3-4b, falcon-mamba-7b and zamba2-7b at
     full width and depth, 4 SGD steps each at B 8 x S 256, lr 3e-3, fp32,
     from seed-0 weights (the two 7 B models recomputing each layer in the
     backward, without which they do not fit: ``FAMILY_REMAT``): each K3
     backward kernel 32, 62 (Dh 96), 0 and 13 (Dh 112) times a step, the
     forward as often (twice that under remat, whose recompute runs it
     again), the losses finite and falling (the last below the first, and
     the trained weights' loss on the first batch below the first step's);
     ms a step, tokens/s and peak memory printed; each model freed before
     the next and before 7g;
  7g. the dense configs and the step builders: reduced
     chatglm3-6b and starcoder2-15b in bf16 on the card against the CPU
     (serving without and with a window of 8 that the prompts wrap, the
     CPU fed the card's tokens: logits within max(2e-2, the CPU's own
     bf16-vs-fp32 gap), greedy tokens equal wherever the top-2 gap is
     clear; one bf16 ``make_train_step``, loss and params within the same
     gate, its gradients and its update against the CPU's in relative
     norm); then chatglm3-6b at full width and depth (28 layers, 6.24 B
     params, seed-0 weights): fp32 serving of 8 prompts of 1024 tokens, 32
     generated (K3 28 launches a prefill), 4 fp32 SGD steps at B 8 x S 256
     (K3's backward at G 16, Dh 128) and 2 bf16 ones, the loss falling in
     both; the four step
     builders of ``launch/steps.py`` in bf16 at its width, each shape's
     global_batch cut to one card (train_4k 256 -> 2 for 2 steps,
     prefill_32k 32 -> 1, decode_32k 128 -> 8, a 7.0 GiB cache; long_500k
     one step at position 524,287 in a 4096-slot ring); starcoder2-15b at
     full width in bf16 (40 layers, 22.0 B params, 41 GiB): 4 prompts of
     4600 tokens, 32 generated, its 4096-slot ring wrapping in the prefill
     and in decode (K3 40 launches a prefill); ms, tokens/s and peaks
     printed, each model freed before the next;
  7b. LM training: reduced smollm-135m on the card and on the CPU (plain
     kernels) with the same weights, batches and link masks, 3 SGD steps
     and one federated round at C = 3; then the main path at full width,
     single-client smollm-135m (B 8 x S 256, 20 SGD steps at lr 3e-3:
     the loss falls, K3's forward and each backward kernel that
     ``backward_plan`` picks at this shape launch 30 times a step, nothing
     is NaN; ms per step, tokens/s, peak memory),
     then federated pFedWN (C 4, B 4 x S 128, 10 local steps, 2 rounds,
     the example's 5 cut to 2: K2 12 launches a round, π* on the
     simplex; links and ms per round printed);
  7h. the multi-pod pFedWN round step (``launch/steps.py::
     make_pfedwn_round_step``: local step, model exchange by all-gather,
     EM on a probe slice, the Eq-1 mix through K2), one client a gloo
     rank on this card: reduced smollm-135m on C = 4 card ranks against
     as many CPU ranks (plain kernels) on the same arrays (C = 2 is
     ``tests/test_torch_gpu.py``'s), at exchange 16 and 8, fp32 (params,
     π, metrics within 1e-4) and bf16 (within max(2e-2, the CPU's own
     bf16-vs-fp32 gap)), and the local step's update Δ in relative norm
     (fp32 within 1e-4, bf16 within max(2e-2, 2g)); π has a zero column
     and links are erased at random, one rank's all, and that rank's
     params must equal its post-step params bit for bit; then
     smollm-135m at full width in bf16 over C = 4 ranks (seed-0 weights,
     B 2 x S 4096 a client, probe 4 x 512, 3 rounds at exchange 16 and 1
     at 8: each round on each rank K2 once in bf16, K3's bf16 forward 30
     x 5 times and its bf16 backward kernels 30 times each, no fp32 K3
     launch, 3 collectives (4 at int8), finite losses, π* on the simplex
     and equal on every rank; ms a round a rank, its split by stage, the
     peaks and their sum printed); phase 8 adds K2's row at its mix (bf16,
     P 162,826,560, M 4) and K3's bf16 forward and backward rows at the
     local step's shape;
  7i. the MoE, MLA, SSM, hybrid and stub-prefix families in bf16: reduced
     granite-moe-3b-a800m, deepseek-v3-671b, minicpm3-4b, falcon-mamba-7b,
     zamba2-7b and qwen2-vl-2b on the card against the CPU (plain
     kernels) with the same bf16 weights: a prefill after the stub prefix
     and 4 teacher-forced decode steps within max(2e-2, the CPU's own
     bf16-vs-fp32 gap), one make_train_step (qwen2-vl under its M-RoPE
     positions) within the gates of phase 7g; then granite-moe,
     minicpm3-4b, falcon-mamba, zamba2 and qwen2-vl at full width in bf16:
     a serve of 8 x 1024 + 32 and 2 make_train_step steps at B 8 x S 256
     (remat for the 7 B models), every K3 launch bf16, its backward's
     kernels once an attention layer a step (qwen2-vl's with positions);
     prefill, decode and step ms and peaks printed;
  7j. the dry run (``launch/dryrun.py``): its sweep of every registered
     arch x the four shapes on the meta device (``run_combo`` in 4
     processes that see no card): 40 records ``status: ok``, deepseek-v3
     meta only; then ``--run`` at
     smollm-135m's train_4k on the card (global_batch 2: ms, peak), K3's
     and K2's FLOPs counted on the card equal to the meta count;
  7k. deepseek-v3-671b (arXiv:2412.19437) at its published widths:
     reduced() with the published MLA head dims (qk_nope 128, qk_rope 64,
     v 128: K3 at Dh 192) on the card against the CPU with the same
     weights, prompts and batches: fp32 serving within 1e-4 and bf16
     within max(2e-2, the CPU's own bf16-vs-fp32 gap) (a 37-token prefill,
     4 teacher-forced decode steps, K3 once a layer), one bf16
     make_train_step without and with explicit positions within phase
     7g's gates; the explicit-position training of ``POS_TRAIN_ARCHS``
     (reduced deepseek-v3 at Dh 48 and 192, minicpm3-4b at its published
     MLA dims 96, zamba2-7b at its published head dim 112: fp32
     ``value_and_grad`` within 1e-4 and one bf16 step; every K3 launch by
     positions) and fp32 ``value_and_grad`` of reduced deepseek-v3 at Dh
     192 by index within 1e-4; then
     deepseek-v3 with n_layers cut from 61 to 4 (the 3 dense layers, one
     MoE layer of 256 experts top-8 with the shared expert, the MTP block;
     15.70 B params, seed-0 weights): a bf16 serve of 8 x 1024 + 32 (K3 4
     launches a prefill), 2 bf16 make_train_step steps at B 8 x S 256
     without remat (K3's forward 5 a step, each bf16 backward kernel as
     often), then, the bf16 weights freed, an fp32 serve of 8 x 1024 +
     32 on the seed-0 fp32 draws; then deepseek-v3 with n_layers cut to 3
     (the dense layers and the MTP block, no MoE layer: 4.19 B params,
     15.60 GiB in fp32) trained in fp32, 2 make_train_step steps at B 8 x
     S 256 (K3's fp32 forward 4 a step and its fp32 backward at Dh 192 as
     often, no bf16 kernel); prefill, decode and step ms, peaks,
     K3's launches and the MoE layer's dropped share printed;
  8. time each kernel, its plain version and the one-call PyTorch yardstick
     at the main paths' shapes (K1 also in bf16, at smollm-135m's
     vocabulary and at the M = 39 round's shape, K2 also from a
     16-byte-aligned stride, at M = 39 and at the federated LM mix, K3
     also in bf16, SDPA under each backend, K3 also at minicpm3-4b's
     prefill (Dh 96), reduced minicpm3-4b's (Dh 48) and granite-moe's (H
     24 over KH 8, Dh 64), zamba2-7b's (Dh 112), qwen2-vl-2b's (Dh 128, G
     6) and musicgen-large's (Dh 64, G 1), and with explicit positions at
     qwen2-vl's prefill under its M-RoPE positions (SDPA given the
     equivalent boolean mask as the library call); K3's backward at
     smollm-135m's training and federated shapes and at qwen2-vl's and
     musicgen's training shapes, at minicpm3-4b's (Dh 96) and zamba2-7b's
     (Dh 112) and at Dh 48 (reduced minicpm3-4b), each kernel's ms, the
     split-TF32, CUDA-core and bytes bounds, SDPA's backward under each
     backend that takes fp32; K3's bf16 forward at
     starcoder2-15b's prefill, its fp32 backward at chatglm3-6b's training
     shape and its bf16 backward there and at train_4k's, and (PR 29) at
     minicpm3-4b's (Dh 96) and zamba2-7b's (Dh 112) training shapes and
     by explicit positions at qwen2-vl-2b's (M-RoPE), the bf16 rows
     bounded at bf16's 989 TFLOP/s against SDPA in bf16, their launches
     the bf16 kernels' own counts; deepseek-v3's Dh 192: the bf16
     forward at its prefill, the bf16 backward at its training shape (both
     with their kernels' registers and spills from phase 2), the
     fp32 forward at its fp32 serve, the fp32 backward at its fp32
     training shape; the backward by explicit positions
     at Dh 48, 96 and 112 in fp32 and bf16, timed at reduced MLA's,
     minicpm3-4b's and zamba2-7b's training shapes)
     beside the card's floor (a 1-element ``zero_()`` in the same bracket)
     and print them as one JSON line;
  9. with ``--profile`` only: profile two pFedWN rounds, one serving run
     of smollm-135m and one full-width training step with
     ``torch.profiler``; the serving runs of minicpm3-4b,
     granite-moe-3b-a800m, falcon-mamba-7b, zamba2-7b, qwen2-vl-2b and
     musicgen-large are profiled in their own phases, before their weights
     are freed.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the repo's ``src/`` beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROUNDS, EVAL_EVERY, EM_ITERS = 8, 2, 5
WIDE_CLIENTS, WIDE_ROUNDS = 40, 4     # phase 5c: M = 39 neighbours
CIFAR100_ROUNDS = 1                   # phase 5: the cifar100-cnn round
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}      # K1 (test_kernels.py)
AGG_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}  # K2 (test_kernels.py)
ATTN_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}  # K3 (test_kernels.py)
SERVE_TOL = 1e-4             # card vs CPU logits, fp32 with TF32 off
# K1 shapes (M, T, V): the round's (cifar10-cnn, em_subset 512, M 10) and
# the cifar100-cnn round's (V 100), the reference's sweep, then both sides
# of each team-size switch (V 1, 2,
# 16, 17, 31, 32, 33, 512, 520, 1024, 1025, 49,152), M 1, 16, 17 and 32,
# and T off the token tile (515, 700 and 4099 tokens leave 3, 4 and 3 in
# the last tile)
EM_MAIN = (10, 512, 10)
EM_CIFAR100 = (10, 512, 100)
EM_VOCAB = (8, 512, 49_152)   # smollm-135m's vocabulary, 8 components
EM_SHAPES = [EM_MAIN, EM_CIFAR100, (2, 128, 512), (4, 128, 1024), (8, 256, 512),
             (3, 384, 1536), (3, 37, 10), (1, 16, 1), (16, 37, 2),
             (4, 33, 16), (4, 33, 17), (17, 53, 31), (32, 9, 32),
             (1, 100, 33), (5, 20, 512), (3, 24, 520), (16, 33, 1024),
             (17, 20, 1025), (32, 16, 1025), (8, 16, 49_152), (10, 515, 10),
             (2, 700, 33), (1, 4099, 10)]
# past 32 components (a target with more than 32 selected neighbours): M on
# both sides of 32, 64 and 256 (where a tile of one token outgrows the
# kernel's shared-memory stage) and 1000, at the round's V = 10 (T 512,
# the em_subset), at V = 1025 (T 37) and at the vocabulary (T 2); the first
# is the M = 39 round's shape
WIDE_M = (33, 39, 63, 64, 65, 256, 257, 1000)
EM_WIDE = (39, 512, 10)
EM_SHAPES += [(M, T, V) for V, T in ((10, 512), (1025, 37), (49_152, 2))
              for M in WIDE_M]
# further K1 cases: (shape, logit scale, view offset in elements, labels at
# the row's ends); an offset of 1 fp32 / 2 bf16 elements is 4 bytes past an
# 8-byte boundary
EM_CASES = [(EM_MAIN, 100, 0, False), ((3, 64, 1024), 100, 0, False),
            ((4, 16, 49_152), 100, 0, False), (EM_MAIN, 3, 1, False),
            ((3, 37, 1024), 3, 1, False), (EM_MAIN, 3, 0, True),
            ((3, 40, 33), 3, 0, True), ((2, 16, 1025), 3, 0, True),
            ((8, 16, 49_152), 3, 0, True)]
# K3 shapes: (B, Sq, Skv, H, KH, Dh, causal, window); the first is the main
# path's (smollm-135m's prefill of 8 x 1024 tokens)
ATTN_MAIN = (8, 1024, 1024, 9, 3, 64, True, 0)
ATTN_GRANITE = (8, 1024, 1024, 24, 8, 64, True, 0)   # granite-moe's prefill
# qwen2-vl-2b's and musicgen-large's prefills: 8 prompts of 1024 tokens
# after 256 image patches or 64 conditioning frames
ATTN_QWEN2VL = (8, 1280, 1280, 12, 2, 128, True, 0)
ATTN_MUSICGEN = (8, 1088, 1088, 32, 32, 64, True, 0)
# starcoder2-15b's bf16 prefill in phase 7g: 4 prompts of 4600 tokens,
# past its 4096 window
STAR_B, STAR_PROMPT = 4, 4600
ATTN_STARCODER = (STAR_B, STAR_PROMPT, STAR_PROMPT, 48, 4, 128, True, 4096)
# phase 7h: the multi-pod round step (launch/steps.py::make_pfedwn_round_
# step), one client a gloo rank on this card (NCCL refuses two ranks on
# one device). Card vs CPU at reduced(): seq 64, batch 4, probe 2 x 32; at
# full width smollm-135m in bf16, C 4 clients of B 2 x S 4096 (train_4k's
# seq_len, its global_batch 256 cut to 2 as in phase 7g), probe 4 x 512,
# 3 EM iterations, links drawn at P_err 0.05, 3 rounds at exchange 16 and
# 1 at exchange 8
ROUND_SMALL_SEQ, ROUND_SMALL_BATCH, ROUND_SMALL_PROBE = 64, 4, (2, 32)
ROUND_C, ROUND_B, ROUND_S = 4, 2, 4096
ROUND_PROBE, ROUND_EM_ITERS, ROUND_ALPHA = (4, 512), 3, 0.5
ROUND_P_ERR, ROUND_BITS, ROUND_LR = 0.05, (16, 16, 16, 8), 3e-3
ROUND_REMAT = False           # the four ranks' peaks fit 80 GB without it
ROUND_BF16_TOL = 2e-2         # bf16 card vs CPU: max(this, the CPU's own
#                               bf16-vs-fp32 gap)
# K2 at the round's mix against its plain version: |d| <= ulp·|ref| + abs,
# one bf16 ulp (2^-7 of |ref| bounds it), as each rounds an fp32 sum once
# and the two sums differ only by fp32 rounding
ROUND_MIX_TOL = (2.0 ** -7, 1e-6)
# K3's shapes on the round: the local step's training forward and
# backward (B 2 x S 4096, 9 heads over 3, Dh 64) and the probe's forward
# (n 2 x 512 under no_grad)
ATTN_ROUND_TRAIN = (ROUND_B, ROUND_S, ROUND_S, 9, 3, 64, True, 0)
ATTN_ROUND_PROBE = (ROUND_B, ROUND_PROBE[1], ROUND_PROBE[1], 9, 3, 64, True,
                    0)
ATTN_SHAPES = [
    ATTN_MAIN,
    (2, 256, 256, 4, 2, 64, True, 0),        # tests/test_kernels.py sweep
    (1, 256, 256, 8, 8, 64, True, 0),
    (2, 128, 128, 4, 1, 64, False, 0),
    (1, 384, 384, 6, 2, 128, True, 96),
    (1, 128, 128, 2, 2, 128, True, 0),
    (2, 200, 200, 9, 3, 64, True, 0),        # ragged
    (3, 1, 77, 12, 4, 128, True, 0),
    (1, 5000, 5000, 48, 4, 128, True, 4096),  # starcoder2-15b, its window
    (1, 2048, 2048, 32, 2, 128, True, 0),    # chatglm3-6b
    ATTN_STARCODER,
    ATTN_GRANITE,
    ATTN_QWEN2VL,
    ATTN_MUSICGEN,
    ATTN_ROUND_TRAIN,
    ATTN_ROUND_PROBE,
    # tile edges: folded rows just below, at and above 64 and 128, keys
    # just off the key tile (64 at Dh 64, 32 at Dh 128)
    (2, 42, 43, 3, 1, 64, True, 0),
    (1, 64, 127, 2, 1, 64, False, 0),
    (1, 43, 65, 3, 1, 64, True, 0),
    (1, 32, 33, 2, 1, 128, True, 0),
    (1, 127, 95, 1, 1, 128, False, 0),
    (1, 43, 33, 3, 1, 128, True, 16),
]
# K3 at MLA's head dims (qk_nope + qk_rope): minicpm3-4b's prefill (B 8 x
# S 1024, 40 heads over 40 "KV heads", Dh 96, causal) first; the sweep's
# shapes at Dh 48 (minicpm3-4b at reduced()) and 96; ragged shapes; tile
# edges: folded rows just below, at and above 64 and 128 (a block's 128
# rows at both dims), keys just off the key tile (64 at Dh 48, 32 at 96)
ATTN_MLA = (8, 1024, 1024, 40, 40, 96, True, 0)
ATTN_MLA_SMALL = (2, 37, 37, 4, 4, 48, True, 0)   # reduced minicpm3-4b's
ATTN_MLA_SHAPES = [
    ATTN_MLA,
    (2, 256, 256, 4, 2, 48, True, 0),        # tests/test_kernels.py sweep
    (1, 256, 256, 8, 8, 96, True, 0),
    (2, 128, 128, 4, 1, 48, False, 0),
    (1, 384, 384, 6, 2, 96, True, 96),
    (1, 128, 128, 2, 2, 48, True, 0),
    (1, 128, 128, 2, 2, 96, True, 0),
    ATTN_MLA_SMALL,
    (2, 200, 200, 4, 4, 96, True, 0),        # ragged
    (3, 1, 77, 12, 4, 96, True, 0),
    (1, 77, 50, 16, 1, 48, False, 20),       # rows 69.. fully masked
    (1, 63, 65, 1, 1, 48, False, 0),         # tile edges
    (1, 64, 127, 2, 1, 48, False, 0),
    (1, 43, 65, 3, 1, 48, True, 0),
    (1, 65, 129, 1, 1, 48, True, 16),
    (1, 63, 31, 1, 1, 96, False, 0),
    (1, 32, 33, 2, 1, 96, True, 0),
    (1, 43, 33, 3, 1, 96, True, 16),
    (1, 129, 97, 1, 1, 96, False, 0),
    (2, 42, 43, 3, 1, 96, True, 0),
]
# K3 at zamba2-7b's head dim 112 (d_model 3584 / 32 heads): its prefill (B
# 8 x S 1024, 32 heads over 32 KV heads, causal) first, then with a window;
# the sweep's shapes; ragged shapes; tile edges: folded rows just below, at
# and above 64 and 128 (a block's rows), keys just off the 32-key tile
ATTN_SSM = (8, 1024, 1024, 32, 32, 112, True, 0)
ATTN_SSM_SHAPES = [
    ATTN_SSM,
    (8, 1024, 1024, 32, 32, 112, True, 256),
    (2, 256, 256, 4, 2, 112, True, 0),       # tests/test_kernels.py sweep
    (1, 256, 256, 8, 8, 112, True, 0),
    (2, 128, 128, 4, 1, 112, False, 0),
    (1, 384, 384, 6, 2, 112, True, 96),
    (1, 128, 128, 2, 2, 112, True, 0),
    (2, 200, 200, 4, 4, 112, True, 0),       # ragged
    (3, 1, 77, 12, 4, 112, True, 0),
    (1, 77, 50, 16, 1, 112, False, 20),      # rows 69.. fully masked
    (1, 63, 31, 1, 1, 112, False, 0),        # tile edges
    (1, 32, 33, 2, 1, 112, True, 0),
    (2, 42, 43, 3, 1, 112, True, 0),
    (1, 64, 127, 2, 1, 112, False, 0),
    (1, 43, 33, 3, 1, 112, True, 16),
    (1, 65, 129, 1, 1, 112, True, 16),
    (1, 129, 97, 1, 1, 112, False, 0),
]
# K3 at deepseek-v3's MLA head dim 192 (qk_nope 128 + qk_rope 64, v padded
# to 192; G 1): its full-width prefill (B 8 x S 1024, 128 heads over 128)
# first; the sweep's shapes; ragged shapes; windows; fully masked rows;
# tile edges: folded rows just below, at and above 64 and 128, keys just
# off the fp32 forward's 16-key tile and at and off the bf16 one's 112
# (Skv 111, 112, 113, 225); B x KH below and above the card's 132 SMs (the
# bf16 kernel's blocks are head-major, the fp32 one's row tile slowest)
ATTN_DS = (8, 1024, 1024, 128, 128, 192, True, 0)
ATTN_DS_SHAPES = [
    ATTN_DS,
    (2, 256, 256, 4, 2, 192, True, 0),       # tests/test_kernels.py sweep
    (1, 256, 256, 8, 8, 192, True, 0),
    (2, 128, 128, 4, 1, 192, False, 0),
    (1, 384, 384, 6, 2, 192, True, 96),
    (2, 200, 200, 4, 4, 192, True, 0),       # ragged
    (3, 1, 77, 12, 4, 192, True, 0),
    (1, 77, 50, 16, 1, 192, False, 20),      # rows 69.. fully masked
    (1, 63, 65, 1, 1, 192, False, 0),        # tile edges
    (1, 64, 127, 2, 1, 192, False, 0),
    (1, 65, 129, 1, 1, 192, True, 16),
    (1, 17, 15, 3, 1, 192, True, 0),
    (2, 42, 43, 3, 1, 192, True, 0),
    (1, 129, 97, 1, 1, 192, False, 0),
    (1, 111, 111, 2, 2, 192, True, 0),
    (1, 112, 112, 3, 1, 192, False, 0),
    (2, 113, 113, 2, 2, 192, True, 0),
    (1, 130, 225, 2, 1, 192, False, 0),
    (1, 512, 512, 128, 128, 192, True, 0),   # B x KH 128
    (2, 384, 384, 68, 68, 192, True, 0),     # B x KH 136
]
# phase 7d: the SSM configs, and the window zamba2's card-vs-CPU run wraps
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-7b")
SSM_WINDOW = 8
# phase 7e: the stub-prefix configs and their training steps
STUB_ARCHS = ("qwen2-vl-2b", "musicgen-large")
STUB_TRAIN_STEPS = 4
# phase 6: K3 with explicit positions, (B, Sq, Skv, H, KH, Dh, causal,
# window) at qwen2-vl's heads (12 over 2, Dh 128) and musicgen's (G 1, Dh
# 64) over a 256-patch image and 64 text tokens, each under the patterns
# of ``_position_pattern``
POS_SHAPES = [(2, 320, 320, 12, 2, 128, True, 0),
              (2, 320, 320, 8, 8, 64, True, 0)]
# the forward's other head dims (MLA's 48, 96 and 192, zamba2's 112), whose
# position instantiations serve and train: the backward takes
# positions at each of them in each dtype
POS_FWD_SHAPES = [(2, 320, 320, 4, 4, 48, True, 0),
                  (2, 320, 320, 8, 8, 96, True, 0),
                  (2, 320, 320, 8, 8, 112, True, 0),
                  (2, 320, 320, 8, 8, 192, True, 0)]
POS_PATTERNS = ("arange", "mrope", "pad", "window", "masked_rows",
                "unsorted")
# K2: the cifar10-cnn round's P, and row strides that give the kernel 8-,
# 4- and 16-byte vectors in fp32 (the round's stack has the first)
AGG_P = 188_810
AGG_STRIDES = (188_810, 188_811, 188_812)
SERVE_B, SERVE_PROMPT, SERVE_GEN = 8, 1024, 32
# phase 7c: the MoE configs served card vs CPU, and a capacity factor that
# drops pairs in their prefill (reduced() sets 4.0, which never drops)
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b")
MOE_DROP_FACTOR = 0.25
# K3's backward: (B, Sq, Skv, H, KH, Dh, causal, window); the first is the
# training main path's (smollm-135m, B 8 x S 256)
BWD_MAIN = (8, 256, 256, 9, 3, 64, True, 0)
BWD_FED = (4, 128, 128, 9, 3, 64, True, 0)    # the federated run's
# qwen2-vl-2b's and musicgen-large's training steps: B 8 x S 256 after the
# stub prefix
BWD_QWEN2VL = (8, 512, 512, 12, 2, 128, True, 0)
BWD_MUSICGEN = (8, 320, 320, 32, 32, 64, True, 0)
BWD_SHAPES = [
    BWD_MAIN,
    BWD_FED,
    BWD_QWEN2VL,
    BWD_MUSICGEN,
    (8, 1024, 1024, 9, 3, 64, True, 0),      # smollm-135m's serving shape
    (2, 256, 256, 4, 2, 64, True, 0),        # tests/test_kernels.py sweep
    (1, 256, 256, 8, 8, 64, True, 0),
    (2, 128, 128, 4, 1, 64, False, 0),
    (1, 384, 384, 6, 2, 128, True, 96),
    (1, 128, 128, 2, 2, 128, True, 0),
    (2, 200, 200, 9, 3, 64, True, 0),        # ragged
    (3, 1, 77, 12, 4, 128, True, 0),
    (1, 77, 50, 16, 1, 64, False, 20),       # rows 69.. fully masked
    (1, 100, 100, 8, 2, 128, True, 0),       # G 4
    (2, 70, 200, 4, 1, 64, True, 0),         # keys no query sees
    (1, 200, 130, 6, 2, 64, True, 70),       # a window across tiles
    # tile edges: queries and keys just off the 64-row tiles
    (2, 42, 43, 3, 1, 64, True, 0),
    (1, 63, 65, 1, 1, 64, False, 0),
    (1, 64, 127, 2, 1, 64, False, 0),
    (1, 65, 129, 1, 1, 64, False, 0),
    (1, 43, 65, 3, 1, 64, True, 0),
    (1, 32, 33, 2, 1, 128, True, 0),
    (1, 127, 95, 1, 1, 128, False, 0),
    (1, 43, 33, 3, 1, 128, True, 16),
]
# the MoE, MLA, SSM and hybrid families' training steps (phase 7f): B 8 x
# S 256 at minicpm3-4b's heads (40 over 40, Dh 96: qk_nope + qk_rope, v
# padded to 96), zamba2-7b's shared block (32 over 32, Dh 112) and
# granite-moe-3b-a800m's (24 over 8, Dh 64); B 2 x S 64 at MLA's Dh 48
# (minicpm3-4b and deepseek-v3 at reduced())
BWD_MINICPM = (8, 256, 256, 40, 40, 96, True, 0)
BWD_ZAMBA2 = (8, 256, 256, 32, 32, 112, True, 0)
BWD_GRANITE = (8, 256, 256, 24, 8, 64, True, 0)
BWD_MLA_SMALL = (2, 64, 64, 4, 4, 48, True, 0)
# chatglm3-6b's training step (B 8 x S 256, 32 heads over 2: G 16, Dh 128),
# fp32 and bf16, and train_4k at its heads with global_batch cut to 2 (the
# bf16 make_train_step of phase 7g)
BWD_CHATGLM = (8, 256, 256, 32, 2, 128, True, 0)
BWD_TRAIN_4K = (2, 4096, 4096, 32, 2, 128, True, 0)
BWD_SHAPES += [
    BWD_MINICPM,
    BWD_ZAMBA2,
    BWD_GRANITE,
    BWD_MLA_SMALL,
    (2, 200, 200, 4, 4, 96, True, 0),        # ragged
    (3, 1, 77, 12, 4, 112, True, 0),
    (2, 70, 200, 4, 1, 48, True, 0),         # keys no query sees
    (1, 77, 50, 16, 1, 48, False, 20),       # rows 69.. fully masked
    (1, 100, 100, 8, 2, 48, True, 0),        # G 4
    (2, 96, 96, 6, 2, 96, True, 0),          # G 3
    (1, 100, 100, 8, 2, 112, True, 0),       # G 4
    (1, 200, 130, 6, 2, 112, True, 70),      # windows across tiles
    (1, 384, 384, 6, 2, 96, True, 96),
    (1, 129, 65, 9, 3, 48, False, 64),
    # tile edges: keys just off the 64-key tile, queries just off each
    # query step (32 at Dh 48, 16 at 96 and 112) and keys off the dQ
    # kernel's key steps (32 at 48 and 112, 16 at 96)
    (1, 63, 65, 1, 1, 48, False, 0),
    (1, 65, 129, 1, 1, 96, False, 0),
    (1, 64, 127, 2, 1, 112, False, 0),
    (1, 33, 47, 4, 4, 48, True, 17),
    (1, 31, 33, 2, 1, 48, True, 0),
    (1, 17, 33, 2, 1, 96, True, 0),
    (1, 15, 17, 3, 3, 96, False, 0),
    (1, 17, 300, 4, 1, 112, True, 0),
    (1, 47, 33, 3, 1, 112, True, 0),
    (2, 42, 43, 3, 1, 112, True, 0),
    BWD_CHATGLM,
]
# K3's bf16 training forward and backward (the head dims of
# BWD_BF16_HEAD_DIMS): chatglm3-6b's training shape and train_4k's (whose
# plans differ: 3 dK/dV splits and a reduce, 1 split), the sweep's Dh 64
# and 128 shapes, ragged shapes, causal and windowed, G 1 to 16, fully
# masked rows, and a split plan at Dh 64 (the federated shape)
BWD_BF16_SHAPES = [
    BWD_CHATGLM,
    BWD_TRAIN_4K,
    (2, 256, 256, 4, 2, 64, True, 0),        # tests/test_kernels.py sweep
    (1, 256, 256, 8, 8, 64, True, 0),
    (2, 128, 128, 4, 1, 64, False, 0),
    (1, 384, 384, 6, 2, 128, True, 96),
    (1, 128, 128, 2, 2, 128, True, 0),
    (2, 200, 200, 9, 3, 64, True, 0),        # ragged
    (3, 1, 77, 12, 4, 128, True, 0),
    (1, 200, 130, 6, 2, 64, True, 70),       # a window across tiles
    (1, 43, 33, 3, 1, 128, True, 16),
    (1, 77, 50, 16, 1, 64, False, 20),       # rows 69.. fully masked; G 16
    (1, 100, 100, 8, 2, 128, True, 0),       # G 4
    (1, 64, 64, 16, 1, 128, True, 0),        # G 16
    BWD_FED,                                 # 6 splits and the reduce
    ATTN_ROUND_TRAIN,                        # the round step's local step
    # Dh 48, 96 and 112 (PR 29): minicpm3-4b's and zamba2-7b's training
    # shapes, reduced MLA's, a split plan, ragged, windowed, G > 1, fully
    # masked rows
    BWD_MINICPM, BWD_ZAMBA2, BWD_MLA_SMALL,
    (4, 128, 128, 4, 4, 48, True, 0),        # 2 splits and the reduce
    (2, 200, 200, 9, 3, 96, True, 0),
    (1, 130, 130, 6, 2, 112, True, 70),
    (1, 77, 50, 16, 1, 96, False, 20),
    (2, 42, 43, 3, 1, 112, True, 0),
    (1, 100, 100, 8, 2, 48, True, 0),
]
# the backward at Dh 192 in fp32 (checked as BWD_SHAPES are) and bf16 (as
# BWD_BF16_SHAPES are): deepseek-v3's training shape at full width (B 8 x
# S 256, 128 heads; the dK/dV kernels split each step over their
# warpgroups), a split plan, ragged, windowed, G > 1, fully masked rows,
# tile edges (keys at and off the 64-key tiles), B x KH below and above
# the card's 132 SMs (the bf16 kernels' blocks and the fp32 dK/dV
# kernel's are head-major)
BWD_DS = (8, 256, 256, 128, 128, 192, True, 0)
BWD_DS_SHAPES = [
    BWD_DS,
    (1, 256, 256, 2, 1, 192, True, 0),       # 8 (bf16) or 32 splits
    (2, 200, 200, 9, 3, 192, True, 0),
    (1, 130, 130, 6, 2, 192, True, 70),
    (1, 77, 50, 16, 1, 192, False, 20),
    (2, 42, 43, 3, 1, 192, True, 0),
    (1, 65, 129, 1, 1, 192, False, 0),
    (1, 64, 63, 2, 2, 192, True, 0),
    (1, 256, 256, 128, 128, 192, True, 0),   # B x KH 128
    (2, 192, 192, 68, 68, 192, True, 0),     # B x KH 136
]
# |d| <= tol + tol·|ref| for the fp32 kernel against the float64 plain
# backward (tests/test_torch_gpu.py's tolerance); the row LSE likewise
BWD_TOL = 1e-5
# the bf16 kernel against the float64 plain backward of the same bf16
# values: the reference's bf16 kernel tolerance (tests/test_kernels.py),
# atol and rtol
BWD_BF16_TOL = 2e-2
# and, per gradient, max |kernel - float64| <= factor x max |plain -
# float64| + atol, the plain version being the kernels' own bf16 arithmetic
# (ref.flash_attention_bwd_bf16_ref: P and dS rounded to bf16 before their
# products, as the forward and the reference's chunked_attention round P
# before P.V) on the same inputs; tests/test_torch_bf16.py holds that
# version within twice the reference's own bf16 error against float64
BWD_BF16_PLAIN_FACTOR, BWD_BF16_PLAIN_ATOL = 2.0, 1e-4
TRAIN_TOL = 1e-4             # card vs CPU losses and params, TF32 off
# phase 7b: full-width training (tokens of examples/torch_federated_lm.py)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 256, 20, 3e-3
# phase 7f: the families trained card vs CPU at reduced() (the first two
# also one federated round), then at full width for FAMILY_STEPS steps;
# the full-width runs in FAMILY_REMAT recompute each layer in the
# backward, without which they do not fit 80 GB
FAMILY_ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b", "minicpm3-4b",
                "falcon-mamba-7b", "zamba2-7b")
FAMILY_FED_ARCHS = ("granite-moe-3b-a800m", "zamba2-7b")
FAMILY_FULL = {"granite-moe-3b-a800m": BWD_GRANITE,
               "minicpm3-4b": BWD_MINICPM, "falcon-mamba-7b": None,
               "zamba2-7b": BWD_ZAMBA2}
FAMILY_REMAT = ("falcon-mamba-7b", "zamba2-7b")
# phase 7i: the MoE, MLA, SSM, hybrid and stub-prefix families in bf16,
# card vs CPU at reduced() (deepseek-v3 too), then at full width: a serve
# of SERVE_B x SERVE_PROMPT + SERVE_GEN and BF16_FAMILY_STEPS steps of
# make_train_step at TRAIN_B x TRAIN_S (the 7 B models with remat, as 7f;
# qwen2-vl-2b after its 256 stub patches, under their M-RoPE positions, so
# that K3's bf16 backward takes positions)
BF16_FAMILY_ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b",
                     "minicpm3-4b", "falcon-mamba-7b", "zamba2-7b",
                     "qwen2-vl-2b")
BF16_FAMILY_FULL = ("granite-moe-3b-a800m", "minicpm3-4b",
                    "falcon-mamba-7b", "zamba2-7b", "qwen2-vl-2b")
BF16_FAMILY_STEPS = 2
# phase 7k: deepseek-v3-671b (arXiv:2412.19437) at its published widths:
# card vs CPU at reduced() with the published MLA head dims (qk_nope 128,
# qk_rope 64, v 128: K3 at Dh 192), then at full width with n_layers cut
# from 61 to DS_LAYERS (the 3 dense layers, one MoE layer of 256 experts
# top-8 with the shared expert, the MTP block; 15.70 B params, 29.2 GiB in
# bf16 and 58.5 GiB in fp32): a bf16 serve of SERVE_B x SERVE_PROMPT +
# SERVE_GEN, DS_TRAIN_STEPS bf16 make_train_step steps at TRAIN_B x
# TRAIN_S (no remat: K3's forward once an attention layer, 5 a step), an
# fp32 serve of the same size from init_params in fp32 (its peak about 70
# GiB on an H100); then fp32 training with n_layers cut to DS_FP32_LAYERS,
# the dense prefix alone (first_k_dense 3, so the MoE group is empty) and
# the MTP block: 4.19 B params, 15.60 GiB in fp32, ~31 GiB with gradients
# (DS_LAYERS' MoE layer would take fp32 weights and gradients past 80 GB:
# 117 GiB), DS_TRAIN_STEPS make_train_step steps at TRAIN_B x TRAIN_S
DS_LAYERS = 4
DS_FP32_LAYERS = 3
DS_TRAIN_STEPS = 2
DS_MLA_DIMS = ("qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim")
# and the explicit-position training K3's backward takes (the
# reference's loss_fn takes batch["positions"] for every arch), card vs CPU
# in fp32 and bf16 at reduced(): deepseek-v3 (Dh 48), minicpm3-4b with its
# published MLA dims (64 + 32: Dh 96), zamba2-7b's shared block at its
# published head dim 112, deepseek-v3 at Dh 192; positions 3..S+2,
# what a caller continuing a sequence passes. Phase 8 times the position
# backward at the full-width training shapes of these dims
POS_TRAIN_ARCHS = (("deepseek-v3-671b", 48), ("minicpm3-4b", 96),
                   ("zamba2-7b", 112), ("deepseek-v3-671b", 192))
POS_TRAIN_OFFSET = 3
# phase 7j: where the dry run's sweep writes, and its processes (it needs
# no card; the SSM configs' per-step Mamba1 scans take ~20 s each on the
# meta device, the others ~1 s)
DRYRUN_OUT = os.path.join("experiments", "torch_dryrun")
DRYRUN_WORKERS = 4
FAMILY_STEPS = 4
FED_C, FED_B, FED_S, FED_LOCAL, FED_ROUNDS = 4, 4, 128, 10, 2
# phase 7g: the dense configs never run at full width before; their
# reduced card-vs-CPU runs in bf16 serve without and with a window the
# prompts wrap; chatglm3-6b trains GLM_STEPS fp32 steps and GLM_BF16_STEPS
# bf16 ones at B 8 x S 256; the step builders' shapes are cut to one card
# in batch and steps only (BUILDER_CUTS)
DENSE_ARCHS = ("chatglm3-6b", "starcoder2-15b")
DENSE_WINDOW = 8
GLM_STEPS, GLM_BF16_STEPS = 4, 2
BUILDER_CUTS = {"train_4k": 2, "prefill_32k": 1, "decode_32k": 8,
                "long_500k": 1}           # global_batch on one card
BUILDER_TRAIN_STEPS = 2
# H100 SXM peaks (NVIDIA data sheet): device memory B/s, fp32 FLOP/s
# outside the tensor cores and TF32 FLOP/s on them (dense); the bounds
# below are taken against them
HBM_BYTES_PER_S, FP32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
BF16_FLOPS = 989e12                   # dense, on the tensor cores
# K3's fp32 route runs three TF32 products for each (split TF32)
SPLIT_TF32_TERMS = 3


_PHASE = {"name": None, "start": 0.0, "first": None}


def _phase(name) -> None:
    """End the running phase, printing its seconds, and start ``name``
    (None: only end it, and print the seconds since the first phase)."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"-- phase {_PHASE['name'].split(' ')[0].rstrip('.')} took "
              f"{now - _PHASE['start']:.1f} s", flush=True)
    if _PHASE["first"] is None:
        _PHASE["first"] = now
    if name is None:
        print(f"-- all phases took {now - _PHASE['first']:.1f} s")
    else:
        print(f"== {name}", flush=True)
    _PHASE.update(name=name, start=now)


def _em_inputs(M, T, V, dtype, dev, seed=0, scale=3, offset=0,
               ends=False):
    """π, logits (M, T, V) and labels from ``seed``: normal logits times
    ``scale``, held in a contiguous view ``offset`` elements into its
    buffer; with ``ends`` the labels alternate between 0 and V − 1. From
    numpy below a few million logits, else from a generator on the card."""
    rng = np.random.default_rng(seed)
    pi = torch.softmax(torch.from_numpy(rng.normal(size=M)).float(), 0)
    labels = torch.from_numpy(rng.integers(0, V, T).astype(np.int64))
    if ends:
        labels = torch.where(torch.arange(T) % 2 == 0, 0, V - 1)
    flat = torch.empty(M * T * V + offset, dtype=dtype, device=dev)
    logits = flat[offset:].view(M, T, V)
    if M * T * V <= 1 << 22:
        logits.copy_(torch.from_numpy(
            (rng.normal(size=(M, T, V)) * scale).astype(np.float32)))
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        logits.copy_(torch.randn((M, T, V), generator=g, device=dev)
                     .mul_(scale))
    return pi.to(dev), logits, labels.to(dev)


def _agg_inputs(M, P, dtype, dev, seed=0):
    """A stack of M + 1 normal rows of P (row 0 is own), softmax weights
    and the row numbers 1..M; from numpy below a few million values, else
    from a generator on the card."""
    rng = np.random.default_rng(seed)
    if (M + 1) * P <= 1 << 23:
        stack = torch.from_numpy(rng.normal(size=(M + 1, P))
                                 .astype(np.float32)).to(dev)
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        stack = torch.randn((M + 1, P), generator=g, device=dev)
    w = torch.softmax(torch.from_numpy(rng.normal(size=M)).float(), 0)
    rows = torch.arange(1, M + 1)
    return stack.to(dtype=dtype), w.to(dev), rows.to(dev)


def _em_error(args):
    """One K1 launch on ``args`` against the plain version: (max |dλ|,
    max |dℓ|, max |dℓ|/(1+|ℓ|))."""
    from repro_torch.kernels import em_posterior as k1
    from repro_torch.kernels.ref import em_posterior_ref
    lam, ell = k1.em_posterior_forward(*args)
    torch.cuda.synchronize()
    plam, pell = em_posterior_ref(*args)
    d_ell = (ell - pell).abs()
    return (float((lam - plam).abs().max()), float(d_ell.max()),
            float((d_ell / (1 + pell.abs())).max()))


def check_em_posterior(dev) -> None:
    """K1 against its plain version at every checked shape and case, fp32
    and bf16; raises past tolerance."""
    cases = [(shape, 3, 0, False) for shape in EM_SHAPES] + EM_CASES
    for (M, T, V), scale, offset, ends in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = _em_inputs(M, T, V, dtype, dev, scale=scale,
                              offset=offset * (2 if dtype == torch.bfloat16
                                               else 1), ends=ends)
            err_l, _, err_c = _em_error(args)
            err = max(err_l, err_c)
            print(f"K1 M={M} T={T} V={V} {str(dtype)[6:]} scale={scale} "
                  f"offset={args[1].data_ptr() % 16}B ends={ends}: "
                  f"max|dλ|={err_l:.3g} max|dℓ|/(1+|ℓ|)={err_c:.3g} "
                  f"tol={TOL[dtype]:g}")
            if not err <= TOL[dtype]:
                raise AssertionError(
                    f"K1 disagrees with its plain version at "
                    f"{(M, T, V, dtype, scale, offset, ends)}: {err}")


def check_weighted_agg(dev) -> float:
    """K2 against its plain version at the cifar10-cnn shape (M 10, P
    188,810), then over row strides of 188,810, 188,811 and 188,812
    elements (8-, 4- and 16-byte vectors in fp32) with M 1, 10, 32 and
    every M of ``WIDE_M``, and M 3 (the federated LM mix's C − 1); fp32
    and bf16, links up and all erased. Returns the max |d| at the main
    shape in fp32."""
    from repro_torch.kernels import weighted_agg as k2
    from repro_torch.kernels.ref import weighted_agg_ref
    main_err = None
    cases = [(10, AGG_P)] + [(M, stride) for stride in AGG_STRIDES
                             for M in (1, 3, 10, 32) + WIDE_M]
    for M, stride in cases:
        for dtype in (torch.float32, torch.bfloat16):
            buf, w, rows = _agg_inputs(M, stride, dtype, dev)
            stack = buf[:, :AGG_P]               # rows of P, `stride` apart
            for any_ok in (True, False):
                ok = torch.tensor(any_ok, device=dev)
                out = k2.weighted_agg(stack[0], stack, w, 0.7, index=rows,
                                      any_ok=ok)
                torch.cuda.synchronize()
                expect = weighted_agg_ref(stack[0], stack, w, 0.7,
                                          index=rows, any_ok=ok)
                diff = (out.float() - expect.float()).abs()
                err = float(diff.max())
                rel = float((diff / (1 + expect.float().abs())).max())
                tol = AGG_TOL[dtype]
                print(f"K2 M={M} P={AGG_P} stride={stride} "
                      f"{str(dtype)[6:]} any_ok={any_ok}: max|d|={err:.3g} "
                      f"max|d|/(1+|ref|)={rel:.3g} tol={tol:g} "
                      f"grid={k2.last_grid}")
                if not rel <= tol:
                    raise AssertionError(
                        f"K2 disagrees with its plain version ({M}, "
                        f"{stride}, {dtype}, any_ok={any_ok}): {rel}")
                if not any_ok and not torch.equal(out, stack[0]):
                    raise AssertionError("K2 with every link erased must "
                                         "return own unchanged")
                if main_err is None:
                    main_err = err
    return main_err


def _tiny_sim(device, params0=None, **switches):
    from repro_torch.configs import CNNConfig
    from repro_torch.core.fedsim import FederatedSimulation, FedSimConfig
    from repro_torch.data import (dirichlet_partition, make_client_datasets,
                                  synthetic_image_dataset, train_test_split)
    base = synthetic_image_dataset(0, 600, image_size=8, n_classes=4)
    parts = dirichlet_partition(base.y, 4, alpha=0.3, seed=0)
    train = make_client_datasets(base, [train_test_split(p, seed=1)[0]
                                        for p in parts])
    test = make_client_datasets(base, [train_test_split(p, seed=1)[1]
                                       for p in parts])
    return FederatedSimulation(
        CNNConfig(image_size=8, widths=(4,), hidden=16, n_classes=4), train,
        test, np.array([True, True, True, False]),
        np.linspace(0.0, 0.2, 4).astype(np.float32),
        FedSimConfig(rounds=3, batch_size=16, em_iters=2, em_subset=64,
                     eval_every=2, **switches), params0=params0,
        device=device)


def check_small_run_against_cpu(dev) -> None:
    """Each method's rounds on the card (kernels) against the CPU (plain
    versions) on a small input with the same params and draws, and pFedWN
    once more with uniform π and every link up."""
    from repro_torch.core.fedsim import METHODS
    runs = [(m, {}) for m in METHODS] + [
        ("pfedwn", dict(em_uniform=True, erasures=False))]
    for method, switches in runs:
        gpu = _tiny_sim(dev, **switches)
        cpu = _tiny_sim("cpu", params0=gpu.params0.cpu(), **switches)
        rng = np.random.default_rng(1)
        idx = np.stack([rng.integers(0, n, (3, gpu.steps_per_round, 16))
                        for n in gpu._train_len], axis=1)
        masks = rng.random((3, gpu.m)) > 0.3
        hg = gpu.run(method, idx_stream=idx, link_masks=masks)
        hc = cpu.run(method, idx_stream=idx, link_masks=masks)
        _compare(f"small {method} {switches or ''} card vs CPU", hg, hc, gpu,
                 cpu, method == "pfedwn")


def _main_sim(dev, model=None, rounds=ROUNDS, eval_every=EVAL_EVERY):
    """Quickstart's scenario at cifar10-cnn width (or ``model``'s, its
    data with as many classes) through the port's entry points: the
    simulation the main paths run."""
    from repro_torch.configs import WirelessConfig, cifar10_cnn
    from repro_torch.core import selection
    from repro_torch.core.fedsim import FederatedSimulation, FedSimConfig
    from repro_torch.data import (dirichlet_partition, make_client_datasets,
                                  synthetic_image_dataset, train_test_split)

    rng = np.random.default_rng(0)
    target = rng.uniform(10, 40, 2)
    neighbors = rng.uniform(0, 50, (10, 2))
    res = selection.select_neighbors(WirelessConfig(), target, neighbors,
                                     eps=0.1, sinr_threshold=10.0,
                                     device=dev)
    p_err_nb, selected = res.p_err.cpu().numpy(), res.selected.cpu().numpy()
    print(f"P_err per neighbor: {[round(float(p), 4) for p in p_err_nb]}")
    print(f"selected neighbors: {np.where(selected)[0].tolist()}")

    model = model or cifar10_cnn()
    base = synthetic_image_dataset(0, 8000, image_size=model.image_size,
                                   n_classes=model.n_classes)
    parts = dirichlet_partition(base.y, 11, alpha=0.1, seed=0)
    train = make_client_datasets(base, [train_test_split(p, seed=1)[0]
                                        for p in parts])
    test = make_client_datasets(base, [train_test_split(p, seed=1)[1]
                                       for p in parts])
    pm = np.concatenate([[True], selected])
    p_err = np.concatenate([[0.0], p_err_nb]).astype(np.float32)
    sim = FederatedSimulation(
        model, train, test, pm, p_err,
        FedSimConfig(rounds=rounds, batch_size=32, lr=0.05, alpha=0.7,
                     em_iters=EM_ITERS, em_subset=512,
                     eval_every=eval_every, seed=0), device=dev)
    print(f"clients={sim.n} M={sim.m} P={sim.layout.size} "
          f"steps/round={sim.steps_per_round}")
    return sim


def run_main_path(dev):
    """pFedWN on :func:`_main_sim`; returns (history, K1 launches, K2
    launches, the simulation)."""
    from repro_torch.kernels import em_posterior as k1
    from repro_torch.kernels import weighted_agg as k2
    sim = _main_sim(dev)
    k1.launches = 0
    k2.launches = 0
    hist = sim.run("pfedwn")
    n1, n2 = k1.launches, k2.launches

    pis = np.stack(hist["pi"])
    if not (np.all(pis >= 0) and np.allclose(pis.sum(1), 1.0, atol=1e-4)):
        raise AssertionError(f"π left the simplex: {pis}")
    accs = hist["target_acc"] + hist["mean_participant_acc"]
    if not np.all(np.isfinite(accs)):
        raise AssertionError(f"non-finite accuracy: {accs}")
    for k, v in hist["taps"].items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"non-finite tap {k}")
    if n1 != ROUNDS * EM_ITERS or n2 != ROUNDS:
        raise AssertionError(f"kernel launches K1={n1} K2={n2}, expected "
                             f"{ROUNDS * EM_ITERS} and {ROUNDS}")
    steady = hist["round_ms"][1:]
    print(f"pfedwn target acc per eval: {hist['target_acc']}")
    print(f"pi*: {np.round(pis[-1], 3).tolist()}")
    print(f"ms per round by block (host clock, eval included): "
          f"{hist['round_ms']}")
    print(f"ms per round after the first block: {float(np.mean(steady))}")
    return hist, n1, n2, sim


def run_cifar100_main_path(dev) -> tuple:
    """pFedWN on :func:`_main_sim` at cifar100-cnn's width (P 200,420, 100
    classes, so K1 runs at V 100) for ``CIFAR100_ROUNDS`` rounds: π on the
    simplex, accuracies finite, K1 ``EM_ITERS`` and K2 once a round, K1's
    shape ``EM_CIFAR100`` (held to its plain version in phase 3). Returns
    (K1 launches, K2 launches, P)."""
    from repro_torch.configs import cifar100_cnn
    from repro_torch.kernels import em_posterior as k1
    from repro_torch.kernels import weighted_agg as k2
    sim = _main_sim(dev, cifar100_cnn(), rounds=CIFAR100_ROUNDS,
                    eval_every=1)
    k1.launches = k2.launches = 0
    hist = sim.run("pfedwn")
    n1, n2 = k1.launches, k2.launches
    pis = np.stack(hist["pi"])
    accs = hist["target_acc"] + hist["mean_participant_acc"]
    print(f"cifar100-cnn pfedwn: P={sim.layout.size}, target acc "
          f"{hist['target_acc']}, pi* {np.round(pis[-1], 3).tolist()}, ms "
          f"per round {hist['round_ms']}, launches K1={n1} K2={n2}")
    if not (np.all(pis >= 0) and np.allclose(pis.sum(1), 1.0, atol=1e-4)
            and np.all(np.isfinite(accs))
            and (sim.m, sim.sim.em_subset, sim.model_cfg.n_classes)
            == EM_CIFAR100 and n1 == CIFAR100_ROUNDS * EM_ITERS
            and n2 == CIFAR100_ROUNDS):
        raise AssertionError(f"cifar100-cnn's pfedwn round: K1={n1} K2={n2}, "
                             f"pi {pis}, accuracies {accs}")
    return n1, n2, sim.layout.size


def run_baselines_main_path(dev):
    """``local`` and the four baselines on :func:`_main_sim`, each driven
    with the kernel counts set to 0 just before it and read just after:
    finite taps, accuracies in [0, 1], and no K1 or K2 launch (the
    reference runs no Pallas kernel on these paths). Returns (each method's
    ms per round after the first block, the simulation)."""
    from repro_torch.kernels import em_posterior as k1
    from repro_torch.kernels import weighted_agg as k2
    sim = _main_sim(dev)
    out = {}
    for method in ("local", "fedavg", "fedprox", "perfedavg", "fedamp"):
        k1.launches = 0
        k2.launches = 0
        hist = sim.run(method)
        n1, n2 = k1.launches, k2.launches
        accs = np.array(hist["target_acc"] + hist["mean_participant_acc"])
        if not (np.all(np.isfinite(accs)) and np.all(accs >= 0)
                and np.all(accs <= 1)):
            raise AssertionError(f"{method}: accuracy outside [0, 1]: {accs}")
        for k, v in hist["taps"].items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"{method}: non-finite tap {k}")
        if n1 or n2:
            raise AssertionError(f"{method} launched K1 {n1} and K2 {n2} "
                                 f"times, expected none")
        out[method] = float(np.mean(hist["round_ms"][1:]))
        print(f"{method}: target acc per eval {hist['target_acc']}, ms per "
              f"round by block {hist['round_ms']}, after the first block "
              f"{out[method]} (launches K1={n1} K2={n2})")
    return out, sim


def check_baselines_full_width(sim) -> None:
    """FedAvg's aggregate and FedAMP's attention and clouds on a full-width
    (N, P) stack on the card against the same calls on the CPU, at the
    configured σ and at σ = the median off-diagonal d². The tolerance of ξ
    follows the Gram form's rounding: d² = sq_i + sq_j − 2·w_i·w_j loses
    about e = 2⁻²⁴·√P·4·max sq to a reordered fp32 sum on either side, a
    logit moves by e/σ, and a softmax entry by at most twice that."""
    from repro_torch.core import baselines
    stack = sim.last_state["params"]
    pm, sizes = sim.participants, sim.sizes
    cpu = [t.cpu() for t in (stack, sizes, pm)]
    n, p = stack.shape
    w_max = float(cpu[0].abs().max())
    g = baselines.fedavg_aggregate(stack, sizes, pm)
    err = float((g.cpu() - baselines.fedavg_aggregate(*cpu)).abs().max())
    tol = 1e-6 * max(1.0, w_max)
    print(f"fedavg_aggregate ({n}, {p}) card vs CPU: max|d|={err:.3g} "
          f"(tol {tol:.3g})")
    if not err <= tol:
        raise AssertionError("fedavg_aggregate: the card disagrees with "
                             "the CPU at full width")
    w64 = cpu[0].double()
    sq = torch.sum(w64 * w64, dim=1)
    d2 = torch.cdist(w64, w64) ** 2
    median = float(d2[~torch.eye(n, dtype=torch.bool)].median())
    e = 2.0 ** -24 * p ** 0.5 * 4 * float(sq.max())
    sw = sim.sim.fedamp_self_weight
    for sigma in (sim.sim.fedamp_sigma, median):
        xi = baselines.fedamp_weights(stack, sigma, pm, sw)
        xi_cpu = baselines.fedamp_weights(cpu[0], sigma, cpu[2], sw)
        cloud = baselines.fedamp_cloud_models(stack, xi)
        cloud_cpu = baselines.fedamp_cloud_models(cpu[0], xi_cpu)
        xi_err = float((xi.cpu() - xi_cpu).abs().max())
        cloud_err = float((cloud.cpu() - cloud_cpu).abs().max())
        xi_tol = 1e-6 + 2 * (1 - sw) * e / sigma
        cloud_tol = 1e-6 * max(1.0, w_max) + n * xi_tol * w_max
        print(f"fedamp σ={sigma:.6g} ({n}, {p}) card vs CPU: "
              f"max|dξ|={xi_err:.3g} (tol {xi_tol:.3g}) "
              f"max|dcloud|={cloud_err:.3g} (tol {cloud_tol:.3g})")
        if not (xi_err <= xi_tol and cloud_err <= cloud_tol):
            raise AssertionError(f"fedamp at σ={sigma}: the card disagrees "
                                 f"with the CPU at full width")


def _wide_sim(device, full, params0=None, **switches):
    """40 clients, all of them taking part, so the target mixes M = 39
    neighbours. Small: the 8×8 CNN on 4000 images in a Dirichlet(1.0)
    split, P_err from 0 to 0.2, 2 rounds of batch 16, one EM iteration on
    64 samples. Full: cifar10-cnn on 16,000 32×32 images in even random
    shards, P_err ~ U(0, 0.1), batch 32, ``EM_ITERS`` EM iterations on 512
    samples, ``WIDE_ROUNDS`` rounds."""
    from repro_torch.configs import CNNConfig, cifar10_cnn
    from repro_torch.core.fedsim import FederatedSimulation, FedSimConfig
    from repro_torch.data import (dirichlet_partition, make_client_datasets,
                                  synthetic_image_dataset, train_test_split)
    n = WIDE_CLIENTS
    if full:
        base = synthetic_image_dataset(0, 16_000, image_size=32,
                                       n_classes=10)
        parts = np.array_split(np.random.default_rng(0).permutation(16_000),
                               n)
        p_err = np.concatenate([[0.0], np.random.default_rng(2).uniform(
            0.0, 0.1, n - 1)]).astype(np.float32)
        model = cifar10_cnn()
        cfg = dict(rounds=WIDE_ROUNDS, batch_size=32, alpha=0.7,
                   em_iters=EM_ITERS, em_subset=512, eval_every=EVAL_EVERY)
    else:
        base = synthetic_image_dataset(0, 4000, image_size=8, n_classes=4)
        parts = dirichlet_partition(base.y, n, alpha=1.0, seed=0)
        p_err = np.linspace(0.0, 0.2, n).astype(np.float32)
        model = CNNConfig(image_size=8, widths=(4,), hidden=16, n_classes=4)
        cfg = dict(rounds=2, batch_size=16, em_iters=1, em_subset=64,
                   eval_every=2)
    train = make_client_datasets(base, [train_test_split(p, seed=1)[0]
                                        for p in parts])
    test = make_client_datasets(base, [train_test_split(p, seed=1)[1]
                                       for p in parts])
    return FederatedSimulation(
        model, train, test, np.ones(n, bool), p_err,
        FedSimConfig(**{"lr": 0.05, "seed": 0, **cfg, **switches}),
        params0=params0, device=device)


def _compare(name, hg, hc, sim_g, sim_c, pfedwn) -> None:
    """Two runs' accuracies (5e-3), final params and train-loss tap (1e-4)
    and, for pFedWN, π (1e-4), as the engine's parity tests hold them."""
    pi_err = (float(np.abs(np.stack(hg["pi"]) - np.stack(hc["pi"])).max())
              if pfedwn else 0.0)
    p_err = float((sim_g.last_state["params"].cpu()
                   - sim_c.last_state["params"].cpu()).abs().max())
    acc_err = float(np.abs(
        np.array(hg["target_acc"] + hg["mean_participant_acc"])
        - np.array(hc["target_acc"] + hc["mean_participant_acc"])).max())
    loss_err = float(np.abs(hg["taps"]["train_loss"]
                            - hc["taps"]["train_loss"]).max())
    print(f"{name}: max|dπ|={pi_err:.3g} (tol 1e-4) max|dparams|="
          f"{p_err:.3g} (tol 1e-4) max|dacc|={acc_err:.3g} (tol 5e-3) "
          f"max|dloss|={loss_err:.3g} (tol 1e-4)")
    if not (pi_err <= 1e-4 and p_err <= 1e-4 and acc_err <= 5e-3
            and loss_err <= 1e-4):
        raise AssertionError(f"{name}: the two runs disagree")


def check_wide_small_against_cpu(dev) -> None:
    """pFedWN with M = 39 on the small :func:`_wide_sim`, card (kernels)
    against CPU (plain versions), from the same params and draws; the
    card's run launches K1 once an EM iteration and K2 once a round."""
    from repro_torch.kernels import em_posterior as k1
    from repro_torch.kernels import weighted_agg as k2
    gpu = _wide_sim(dev, full=False)
    cpu = _wide_sim("cpu", full=False, params0=gpu.params0.cpu())
    if gpu.m != WIDE_CLIENTS - 1:
        raise AssertionError(f"M = {gpu.m}, expected {WIDE_CLIENTS - 1}")
    rng = np.random.default_rng(1)
    rounds, batch = gpu.sim.rounds, gpu.sim.batch_size
    idx = np.stack([rng.integers(0, n, (rounds, gpu.steps_per_round, batch))
                    for n in gpu._train_len], axis=1)
    masks = rng.random((rounds, gpu.m)) > 0.1
    k1.launches = 0
    k2.launches = 0
    hg = gpu.run("pfedwn", idx_stream=idx, link_masks=masks)
    n1, n2 = k1.launches, k2.launches
    hc = cpu.run("pfedwn", idx_stream=idx, link_masks=masks)
    _compare(f"small pfedwn M={gpu.m} card vs CPU", hg, hc, gpu, cpu, True)
    if (n1, n2) != (gpu.sim.em_iters * rounds, rounds):
        raise AssertionError(f"small M={gpu.m} run launched K1 {n1} and K2 "
                             f"{n2} times")


def run_wide_main_path(dev):
    """pFedWN on the full :func:`_wide_sim` (M = 39); returns (history, K1
    launches, K2 launches, the simulation)."""
    from repro_torch.kernels import em_posterior as k1
    from repro_torch.kernels import weighted_agg as k2
    sim = _wide_sim(dev, full=True)
    print(f"clients={sim.n} M={sim.m} P={sim.layout.size} "
          f"steps/round={sim.steps_per_round}")
    if (sim.m, sim.sim.em_subset, sim.model_cfg.n_classes) != EM_WIDE:
        raise AssertionError("EM_WIDE is not the M = 39 round's K1 shape")
    k1.launches = 0
    k2.launches = 0
    hist = sim.run("pfedwn")
    n1, n2 = k1.launches, k2.launches
    pis = np.stack(hist["pi"])
    if not (pis.shape[1] == sim.m and np.all(pis >= 0)
            and np.allclose(pis.sum(1), 1.0, atol=1e-4)):
        raise AssertionError(f"π left the simplex: {pis}")
    accs = np.array(hist["target_acc"] + hist["mean_participant_acc"])
    if not (np.all(np.isfinite(accs)) and np.all(accs >= 0)
            and np.all(accs <= 1)):
        raise AssertionError(f"accuracy outside [0, 1]: {accs}")
    for k, v in hist["taps"].items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"non-finite tap {k}")
    if n1 != WIDE_ROUNDS * EM_ITERS or n2 != WIDE_ROUNDS:
        raise AssertionError(f"kernel launches K1={n1} K2={n2}, expected "
                             f"{WIDE_ROUNDS * EM_ITERS} and {WIDE_ROUNDS}")
    print(f"pfedwn M={sim.m} target acc per eval: {hist['target_acc']}")
    print(f"ms per round by block (host clock, eval included): "
          f"{hist['round_ms']}")
    print(f"ms per round after the first block: "
          f"{float(np.mean(hist['round_ms'][1:]))}")
    return hist, n1, n2, sim


def check_legacy_against_fused(dev) -> None:
    """Each method on the legacy engine against the fused engine on the
    card, small run, same seed (so the same on-device draws); the legacy
    pFedWN launches K1 once an EM iteration and K2 once a round too."""
    from repro_torch.core.fedsim import METHODS
    from repro_torch.kernels import em_posterior as k1
    from repro_torch.kernels import weighted_agg as k2
    fused = _tiny_sim(dev)
    legacy = _tiny_sim(dev, params0=fused.params0, fused=False)
    for method in METHODS:
        hf = fused.run(method)
        k1.launches = 0
        k2.launches = 0
        hl = legacy.run(method)
        n1, n2 = k1.launches, k2.launches
        _compare(f"small {method} legacy vs fused on the card", hl, hf,
                 legacy, fused, method == "pfedwn")
        if (fused.last_run_stats["engine"], legacy.last_run_stats["engine"]
                ) != ("fused", "legacy"):
            raise AssertionError(f"engines {fused.last_run_stats} and "
                                 f"{legacy.last_run_stats}")
        want = ((legacy.sim.em_iters * legacy.sim.rounds, legacy.sim.rounds)
                if method == "pfedwn" else (0, 0))
        if (n1, n2) != want:
            raise AssertionError(f"legacy {method} launched K1 {n1} and K2 "
                                 f"{n2} times, expected {want}")


def time_legacy_and_fused(dev) -> dict:
    """Each method on both engines at the full-width scenario of phase 5:
    ms per round, the wall of one whole run (evals included, ending in a
    host sync) over its rounds, and legacy ÷ fused."""
    import dataclasses
    from repro_torch.core.fedsim import METHODS
    sim = _main_sim(dev)
    out = {}
    for method in METHODS:
        row = {}
        for engine in ("fused", "legacy"):
            sim.sim = dataclasses.replace(sim.sim,
                                          fused=(engine == "fused"))
            t0 = time.perf_counter()
            sim.run(method)
            row[engine] = (time.perf_counter() - t0) / sim.sim.rounds * 1e3
        row["legacy_over_fused"] = row["legacy"] / row["fused"]
        out[method] = row
        print(f"{method}: ms per round fused {row['fused']}, legacy "
              f"{row['legacy']}, legacy/fused {row['legacy_over_fused']}")
    return out


def _record_events(path):
    from repro_torch.obs import validate_jsonl_lines
    with open(path) as f:
        lines = f.readlines()
    errors = validate_jsonl_lines(lines)
    if errors:
        raise AssertionError(f"{path}: schema violations {errors[:5]}")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(path)],
        env={**os.environ,
             "PYTHONPATH": str(Path(__file__).resolve().parent / "src")},
        capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise AssertionError(f"the report rejected {path}: {out.stderr}")
    return [json.loads(line) for line in lines]


def check_run_record(dev, tmp: str) -> None:
    """The small pFedWN run of phase 5 recorded on the card and on the CPU
    (same params and draws) into ``tmp``: both files pass the validator and
    ``python -m repro_torch.obs.report``, their round and eval events
    agree (train loss, entropy, effective neighbours and π within 1e-4,
    link success rate exactly, accuracies within 5e-3), a compile event
    carries FLOPs, and the card's run launched K1 ``em_iters`` times a
    round and K2 once a round."""
    from repro_torch.kernels import em_posterior as k1
    from repro_torch.kernels import weighted_agg as k2
    gpu = _tiny_sim(dev, record_dir=tmp, run_name="card")
    cpu = _tiny_sim("cpu", params0=gpu.params0.cpu(), record_dir=tmp,
                    run_name="cpu")
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, n, (3, gpu.steps_per_round, 16))
                    for n in gpu._train_len], axis=1)
    masks = rng.random((3, gpu.m)) > 0.3
    k1.launches = 0
    k2.launches = 0
    gpu.run("pfedwn", idx_stream=idx, link_masks=masks)
    n1, n2 = k1.launches, k2.launches
    cpu.run("pfedwn", idx_stream=idx, link_masks=masks)
    if (n1, n2) != (gpu.sim.em_iters * gpu.sim.rounds, gpu.sim.rounds):
        raise AssertionError(f"recorded run launched K1 {n1} and K2 {n2} "
                             "times")
    events = {}
    for name in ("card", "cpu"):
        events[name] = _record_events(Path(tmp) / f"{name}.jsonl")
    compiles = [e for e in events["card"] if e["type"] == "compile"]
    if not compiles or min(e["flops"] for e in compiles) <= 0:
        raise AssertionError(f"compile events without FLOPs: {compiles}")
    print("compile events on the card: " + "; ".join(
        f"{e['name']} {e['seconds']} s, {e['flops']:.6g} FLOP, "
        f"{e['bytes_accessed']:.6g} B" for e in compiles))

    def kept(evs):
        return [e for e in evs if e["type"] in ("round", "eval")]

    g, c = kept(events["card"]), kept(events["cpu"])
    if [e["type"] for e in g] != [e["type"] for e in c] or len(g) != 5:
        raise AssertionError("card and CPU records differ in their events")
    worst = {"loss": 0.0, "scalars": 0.0, "acc": 0.0, "pi": 0.0}
    for a, b in zip(g, c):
        if a["type"] == "round":
            worst["loss"] = max(worst["loss"], float(np.abs(
                np.subtract(a["train_loss"], b["train_loss"])).max()))
            for k in ("em_entropy", "effective_neighbors"):
                worst["scalars"] = max(worst["scalars"], abs(a[k] - b[k]))
            if a["link_success_rate"] != b["link_success_rate"]:
                raise AssertionError("link success rates differ")
        else:
            for k in ("target_acc", "mean_participant_acc"):
                worst["acc"] = max(worst["acc"], abs(a[k] - b[k]))
            worst["pi"] = max(worst["pi"], float(np.abs(
                np.subtract(a["pi"], b["pi"])).max()))
    print(f"RunRecord card vs CPU: max|dloss|={worst['loss']:.3g} "
          f"max|dentropy,eff|={worst['scalars']:.3g} (tol 1e-4) "
          f"max|dacc|={worst['acc']:.3g} (tol 5e-3) max|dπ|="
          f"{worst['pi']:.3g} (tol 1e-4); launches K1={n1} K2={n2}")
    if not (worst["loss"] <= 1e-4 and worst["scalars"] <= 1e-4
            and worst["acc"] <= 5e-3 and worst["pi"] <= 1e-4):
        raise AssertionError("card and CPU records disagree")


def _syncs(sim) -> int:
    """Host syncs of one run of pFedWN, counted by
    ``torch.cuda.set_sync_debug_mode("warn")``'s warnings."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.run("pfedwn")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def check_record_syncs(dev, tmp: str) -> None:
    """A recorded run (taps on, files written) syncs no more often than an
    unrecorded one (taps off, in memory): each syncs once a block."""
    recorded = _tiny_sim(dev, record_dir=tmp, run_name="syncs")
    plain = _tiny_sim(dev, params0=recorded.params0, taps=False)
    for sim in (recorded, plain):
        sim.run("pfedwn")                              # warm-up
    n_rec, n_plain = _syncs(recorded), _syncs(plain)
    blocks = len(recorded.last_run_stats["blocks"])
    print(f"host syncs a run ({blocks} blocks): recorded {n_rec}, "
          f"unrecorded {n_plain}")
    if n_rec > n_plain:
        raise AssertionError("recording added host syncs")


def time_taps(dev, repeats: int = 5) -> dict:
    """pFedWN at the full width of phase 5 with the taps on and off, runs
    interleaved: the medians of the wall of a run over its rounds and of
    the mean ms per round after the first block, and the K1 and K2
    launches of each (they must not differ)."""
    import dataclasses
    from repro_torch.kernels import em_posterior as k1
    from repro_torch.kernels import weighted_agg as k2
    sim = _main_sim(dev)
    walls = {True: [], False: []}
    steady = {True: [], False: []}
    launches = {}
    for rep in range(repeats + 1):
        for taps in (False, True):
            sim.sim = dataclasses.replace(sim.sim, taps=taps)
            k1.launches = 0
            k2.launches = 0
            t0 = time.perf_counter()
            hist = sim.run("pfedwn")
            wall = (time.perf_counter() - t0) / sim.sim.rounds * 1e3
            launches[taps] = (k1.launches, k2.launches)
            if rep:                                  # the first is warm-up
                walls[taps].append(wall)
                steady[taps].append(float(np.mean(hist["round_ms"][1:])))
    if launches[True] != launches[False]:
        raise AssertionError(f"taps changed the launches: {launches}")
    out = {}
    for taps in (True, False):
        key = "taps_on" if taps else "taps_off"
        out[key] = {"wall_ms_per_round": float(np.median(walls[taps])),
                    "steady_ms_per_round": float(np.median(steady[taps])),
                    "runs_wall": walls[taps], "runs_steady": steady[taps]}
    out["on_over_off"] = (out["taps_on"]["wall_ms_per_round"]
                          / out["taps_off"]["wall_ms_per_round"])
    out["launches_k1_k2"] = list(launches[True])
    return out


def _sharded(devices, backend, dev, build, build_kw, methods, repeat=1,
             syncs=False):
    """Each rank's results of ``methods`` on ``build(**build_kw)``, one
    process a rank (:func:`repro_torch.sharding.worker.run_methods`). The
    ranks share this card with this process, so its cached blocks are
    given back first (four full-width ranks need ~40 GB at once)."""
    from repro_torch.sharding import spawn
    from repro_torch.sharding.worker import run_methods
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return spawn(run_methods, devices, backend, dev.type, build,
                 dict(build_kw, device=dev.type), list(methods), None,
                 repeat, syncs)


def _run_errors(h, params, hist, ref_params) -> dict:
    """max |Δ| of one run's final params, π history and accuracies against
    another's, and of π and the accuracies at the first eval point."""
    def accs(x, k=None):
        return np.array(x["target_acc"][:k] + x["mean_participant_acc"][:k])

    pi = first_pi = 0.0
    if hist["pi"]:
        d = np.abs(np.stack(h["pi"]) - np.stack(hist["pi"]))
        pi, first_pi = float(d.max()), float(d[0].max())
    return {"params": float((params.cpu() - ref_params.cpu()).abs().max()),
            "pi": pi, "acc": float(np.abs(accs(h) - accs(hist)).max()),
            "first_pi": first_pi,
            "first_acc": float(np.abs(accs(h, 1) - accs(hist, 1)).max())}


def _sharded_errors(ranks, i, hist, params) -> dict:
    """:func:`_run_errors` of the ranks' i-th run (their slabs joined)
    against a fused run's."""
    from repro_torch.sharding import join_slabs
    return _run_errors(ranks[0][i]["history"],
                       join_slabs([r[i]["params"] for r in ranks]), hist,
                       params)


def check_sharded_small(dev) -> None:
    """Every method of phase 5's small run on the sharded engine at D = 2
    (gloo, both ranks on this card) against the fused engine on the card,
    same params and seed: accuracies 5e-3, π and params 1e-4; pFedWN
    launches K1 once an EM iteration and K2 once a round on each rank, the
    others neither."""
    from repro_torch.core.fedsim import METHODS
    fused = _tiny_sim(dev)
    ranks = _sharded(2, "gloo", dev, _tiny_sim, dict(
        params0=fused.params0.cpu(), sharded=True, shard_devices=2),
        METHODS)
    for i, method in enumerate(METHODS):
        hist = fused.run(method)
        err = _sharded_errors(ranks, i, hist, fused.last_state["params"])
        want = ((fused.sim.em_iters * fused.sim.rounds, fused.sim.rounds)
                if method == "pfedwn" else (0, 0))
        launches = [(r[i]["k1"], r[i]["k2"]) for r in ranks]
        print(f"small {method} sharded D=2 vs fused on the card: "
              f"max|dparams|={err['params']:.3g} max|dπ|={err['pi']:.3g} "
              f"(tol 1e-4) max|dacc|={err['acc']:.3g} (tol 5e-3); "
              f"K1, K2 a rank {launches}")
        if not (err["params"] <= 1e-4 and err["pi"] <= 1e-4
                and err["acc"] <= 5e-3):
            raise AssertionError(f"sharded {method} disagrees with fused")
        if any(n != want for n in launches):
            raise AssertionError(f"sharded {method} launched {launches}, "
                                 f"expected {want} a rank")


def fused_spread(dev, wide_hist, wide_sim) -> dict:
    """How far phase 5c's full-width pFedWN run moves, on the fused engine,
    when its initial params move by rounding (noise of 1e-7 of their
    largest magnitude) and when it draws other minibatches and link masks
    (seed 1), each against phase 5c's run."""
    gen = torch.Generator(dev).manual_seed(5)
    p0 = wide_sim.params0
    noise = 1e-7 * p0.abs().max() * torch.randn(p0.shape, generator=gen,
                                               device=dev)
    out = {}
    for name, kw in (("rounding", dict(params0=p0 + noise)),
                     ("draws", dict(params0=p0, seed=1))):
        moved = _wide_sim(dev, full=True, **kw)
        h = moved.run("pfedwn")
        out[name] = _run_errors(h, moved.last_state["params"], wide_hist,
                                wide_sim.last_state["params"])
    out["noise"] = float(noise.abs().max())
    print(f"fused pfedwn M={wide_sim.m} moved, params0 by "
          f"{out['noise']:.3g} and to seed 1: {json.dumps(out)}")
    return out


def run_sharded_wide(dev, wide_hist, wide_sim, spread) -> dict:
    """pFedWN on phase 5c's full-width scenario on the sharded engine at D
    = 1 (nccl), 2 and 4 (gloo), each a warm-up run and a watched one,
    against phase 5c's fused run (same seed, so the same draws). Returns,
    by D, rank 0's ms per round after the first block, the launches, the
    collectives a round and the host syncs a block of every rank, and the
    max |Δ| against fused.

    D = 1 trains all 40 clients in one batch, as the fused engine does,
    and must match it within the parity tolerances. With D > 1 a rank
    trains S < 40 models at once, cuBLAS picks another algorithm for the
    batched products (their gradients differ by ~1e-8), and this scenario
    amplifies rounding ~3e4-fold in four rounds, π from the first EM on
    (``fused_spread``). So at D > 1 the params and π, final and at the
    first eval point, must stay within 10× of how far the fused run itself
    moves under rounding, and closer than a fused run on other draws."""
    from repro_torch.lint.blocks import PER_ROUND
    rounds, iters = wide_sim.sim.rounds, wide_sim.sim.em_iters
    out = {}
    one = "nccl" if dev.type == "cuda" else "gloo"
    for d, backend in ((1, one), (2, "gloo"), (4, "gloo")):
        t0 = time.perf_counter()
        ranks = _sharded(d, backend, dev, _wide_sim, dict(
            full=True, sharded=True, shard_devices=d), ["pfedwn"], repeat=2,
            syncs=True)
        wall = time.perf_counter() - t0
        res = [r[0] for r in ranks]
        blocks = len(res[0]["stats"]["blocks"])
        err = _sharded_errors(ranks, 0, wide_hist,
                              wide_sim.last_state["params"])
        row = {"backend": backend,
               "ms_per_round": float(np.mean(
                   res[0]["history"]["round_ms"][1:])),
               "round_ms": res[0]["history"]["round_ms"],
               "k1_k2_per_rank": [(r["k1"], r["k2"]) for r in res],
               "collectives_a_round": [
                   (r["calls"]["client_weighted_mean"]
                    + r["calls"]["gather_clients"]) / rounds for r in res],
               "exchanges_a_block": [r["calls"]["exchange_block"] / blocks
                                     for r in res],
               "syncs_a_block": [None if r["syncs"] is None
                                 else r["syncs"] / blocks for r in res],
               "max_abs_err": err, "wall_s": wall}
        print(f"sharded pfedwn M={wide_sim.m} D={d} ({backend}): "
              f"{json.dumps(row)}")
        if any(k != (iters * rounds, rounds)
               for k in row["k1_k2_per_rank"]):
            raise AssertionError(f"D={d}: launches {row['k1_k2_per_rank']}, "
                                 f"expected {(iters * rounds, rounds)}")
        if any(c != PER_ROUND["pfedwn"] for c in row["collectives_a_round"]) \
                or any(e != 1 for e in row["exchanges_a_block"]):
            raise AssertionError(f"D={d}: collectives a round "
                                 f"{row['collectives_a_round']}, exchanges "
                                 f"a block {row['exchanges_a_block']}")
        if d == 1:
            ok = (err["params"] <= 1e-4 and err["pi"] <= 1e-4
                  and err["acc"] <= 5e-3)
        else:
            ok = all(err[k] <= 10 * spread["rounding"][k]
                     and err[k] < spread["draws"][k]
                     for k in ("params", "pi", "first_pi"))
        if not ok:
            raise AssertionError(f"D={d}: sharded disagrees with fused "
                                 f"{err}")
        if backend == "nccl" and row["syncs_a_block"] != [1.0] * d:
            raise AssertionError(f"D={d}: host syncs a block "
                                 f"{row['syncs_a_block']}, expected 1")
        out[f"D={d}"] = row
    return out


def check_pod_mix(dev) -> list:
    """One ``pod_mix`` at C = 2 on the card (gloo, both ranks on this card)
    on a cifar10-cnn-sized tree, against Eq 1 in numpy: rank 0's weights
    go all to rank 1; rank 1's row keeps rank 0 only. One all-gather and
    one K2 launch a rank. Returns the ranks' K2 launches."""
    from repro_torch.sharding import spawn
    from repro_torch.sharding.worker import run_pod_mix
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((2, AGG_P - 10)).astype(np.float32),
            "b": rng.standard_normal((2, 10)).astype(np.float32)}
    pi = np.array([[0.0, 1.0], [0.6, 0.4]], np.float32)
    alpha = 0.7
    ranks = spawn(run_pod_mix, 2, "gloo", dev.type,
                  [(tree, pi, alpha, np.ones((2, 2), bool))], dev.type)
    err = 0.0
    for rank, res in enumerate(ranks):
        got = res[0]
        for k, v in tree.items():
            want = alpha * v[rank] + (1 - alpha) * v[1 - rank]
            err = max(err, float(np.abs(got["mixed"][k][0] - want).max()))
        if (got["collectives"], got["k2"]) != (1, int(dev.type == "cuda")):
            raise AssertionError(f"pod_mix rank {rank}: {got['collectives']} "
                                 f"collectives, {got['k2']} K2 launches")
    print(f"pod_mix C=2 on the card vs numpy Eq 1: max|d|={err:.3g} (tol "
          f"{AGG_TOL[torch.float32]}); one all-gather and one K2 launch a "
          f"rank")
    if err > AGG_TOL[torch.float32]:
        raise AssertionError("pod_mix disagrees with Eq 1")
    return [r[0]["k2"] for r in ranks]


def _attn_inputs(shape, dtype, dev, seed=0):
    B, Sq, Skv, H, KH, Dh = shape[:6]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, H, Dh), generator=g, device=dev)
    k = torch.randn((B, Skv, KH, Dh), generator=g, device=dev)
    v = torch.randn((B, Skv, KH, Dh), generator=g, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def check_flash_attention(dev) -> dict:
    """K3 against its plain version at every checked shape, |d| <= tol +
    tol·|plain|; raises past it. At MLA's head dims 48, 96 and 192 and
    zamba2's 112 also the fp32 training instantiation: its output bitwise
    the serving one's, its row LSE within ``BWD_TOL`` of the plain one;
    and a call that needs a gradient at a head dim no kernel takes (80)
    must raise before it launches anything, in either dtype, with
    positions or without. Returns the max |d| in fp32 by shape, and in
    bf16 under (shape, "bf16")."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import flash_attention_ref
    errs = {}
    for shape in (ATTN_SHAPES + ATTN_MLA_SHAPES + ATTN_SSM_SHAPES
                  + ATTN_DS_SHAPES):
        causal, window = shape[6], shape[7]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _attn_inputs(shape, dtype, dev)
            out = k3.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            expect = flash_attention_ref(q, k, v, causal=causal,
                                         window=window).float()
            diff = (out.float() - expect).abs()
            err = float(diff.max())
            tol = ATTN_TOL[dtype]
            excess = float((diff - tol * expect.abs()).max())
            print(f"K3 {shape} {str(dtype)[6:]}: max|d|={err:.3g} "
                  f"tol={tol:g} (atol and rtol)")
            del expect, diff
            if not (out.dtype == dtype and excess <= tol):
                raise AssertionError(f"K3 disagrees with its plain version "
                                     f"at {shape} {dtype}: {err}")
            errs[shape if dtype == torch.float32 else (shape, "bf16")] = err
            if dtype == torch.float32 and shape[5] in (48, 96, 112, 192):
                _check_lse_instantiation(q, k, v, out, causal, window, shape)
    # where no kernel takes the head dim: either dtype, with and without
    # positions (both backwards take every forward head dim, 192 included)
    for dh, dtype, with_pos in ((80, torch.float32, False),
                                (80, torch.float32, True),
                                (80, torch.bfloat16, False),
                                (80, torch.bfloat16, True)):
        q, k, v = (t.requires_grad_() for t in _attn_inputs(
            (1, 64, 64, 2, 2, dh), dtype, dev))
        pos = torch.arange(64, device=dev)
        n, bwd = k3.launches, dict(k3.backward_launches)
        try:
            k3.flash_attention(q, k, v, **(dict(q_positions=pos,
                                                kv_positions=pos)
                                           if with_pos else {}))
        except ValueError as e:
            print(f"K3 at Dh {dh} {str(dtype)[6:]} with a gradient"
                  f"{' and positions' if with_pos else ''}: raises before "
                  f"launching ({e})")
        else:
            raise AssertionError(f"K3 at Dh {dh} {dtype} took a call that "
                                 "needs a gradient")
        torch.cuda.synchronize()
        if (k3.launches, k3.backward_launches) != (n, bwd):
            raise AssertionError(f"K3 launched before refusing a gradient "
                                 f"at Dh {dh} {dtype}")
    return errs


def _check_lse_instantiation(q, k, v, served, causal, window, shape):
    """K3's fp32 training instantiation at ``shape``: output bitwise the
    serving instantiation's, fully masked rows' LSE +inf, the rest within
    ``BWD_TOL`` (atol and rtol) of the plain LSE."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import attention_lse_ref
    out, lse = k3._launch(q, k, v, causal, window, with_lse=True)
    want = attention_lse_ref(q, k, causal=causal, window=window)
    masked = torch.isinf(want)
    d = (lse - want)[~masked].abs()
    excess = (float((d - BWD_TOL * want[~masked].abs()).max())
              if d.numel() else 0.0)
    ok = (torch.equal(out, served) and excess <= BWD_TOL
          and bool((torch.isinf(lse) == masked).all()))
    print(f"K3 LSE instantiation {shape}: max|dlse|="
          f"{float(d.max()) if d.numel() else 0.0:.3g}, out == serving "
          f"{torch.equal(out, served)}")
    if not ok:
        raise AssertionError(f"K3's training instantiation disagrees at "
                             f"{shape}")


def check_serve_against_cpu(dev) -> None:
    """The serving path on the card (K3) against the CPU (plain version):
    reduced smollm-135m, the same weights and ragged prompts, 4 greedy
    decode steps, with no window and with a window of 8 that the ring
    crosses."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import init_params
    cfg = get_config("smollm-135m").reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    card_params = _tree_to(cpu_params, dev)
    prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
    for window in (0, 8):
        ref = serve(cfg, cpu_params, prompts, 5, window=window, device="cpu")
        got = serve(cfg, card_params, prompts.to(dev), 5, window=window,
                    device=dev)
        diff = (got.logits.cpu() - ref.logits).abs()
        excess = float((diff - SERVE_TOL * ref.logits.abs()).max())
        same = torch.equal(got.tokens.cpu(), ref.tokens)
        print(f"serve reduced smollm-135m window={window}: max|dlogits|="
              f"{float(diff.max()):.3g} (tol {SERVE_TOL:g}), tokens equal: "
              f"{same}")
        if not (excess <= SERVE_TOL and same):
            raise AssertionError(f"the card's serving run disagrees with "
                                 f"the CPU's (window {window})")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def run_serve_main_path(dev):
    """smollm-135m at full width through ``serve``: 8 prompts of 1024
    tokens, 32 generated (1 from the prefill, 31 decode steps), fp32.
    Returns (result, K3 launches, (cfg, params, prompts))."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import init_params
    cfg = get_config("smollm-135m")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompts = make_prompts(cfg, SERVE_B, SERVE_PROMPT, seed=1, device=dev)
    serve(cfg, params, prompts, SERVE_GEN, device=dev)     # warm
    k3.launches = 0
    res = serve(cfg, params, prompts, SERVE_GEN, device=dev)
    n3 = k3.launches
    if n3 != cfg.n_layers:
        raise AssertionError(f"K3 launched {n3} times in one prefill, "
                             f"expected {cfg.n_layers}")
    if not bool(torch.isfinite(res.logits).all()):
        raise AssertionError("non-finite logits on the serving path")
    if res.tokens.shape != (SERVE_B, SERVE_GEN) or not bool(
            ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad tokens {tuple(res.tokens.shape)}")
    t = res.timings
    print(f"smollm-135m B={SERVE_B} prompt={SERVE_PROMPT} gen={SERVE_GEN} "
          f"fp32: prefill {t['prefill_ms']} ms, decode "
          f"{t['decode_ms_per_step']} ms per step, "
          f"{t['decode_tok_per_s']} generated tok/s")
    print(f"first 16 tokens of prompt 0: {res.tokens[0, :16].tolist()}")
    return res, n3, (cfg, params, prompts)


def _first_decode_gap(cfg, params, prompts, window=0) -> float:
    """max |d| between the first decode step's logits (MLA: weight-absorbed,
    latent-space attention; SSM: the recurrent step) and the last logits of
    a prefill of all P + 1 tokens (MLA: K3 over the expanded heads; SSM:
    the chunked scan or SSD), both after ``serve``'s stub prefix
    where the config has one."""
    from repro_torch.launch.serve import prefill_to_cache, stub_prefix
    from repro_torch.models.model import decode, prefill
    stub = stub_prefix(cfg, prompts.shape[0], prompts.device)
    with torch.no_grad():
        full, _ = prefill(params, cfg, prompts, stub_embeds=stub,
                          window=window)
        P = prompts.shape[1] - 1
        start = cfg.n_stub_tokens + P
        _, cache = prefill_to_cache(params, cfg, prompts[:, :P], start + 1,
                                    window=window, stub_embeds=stub)
        step, _ = decode(params, cfg, prompts[:, P:], cache, start,
                         window=window)
    return float((step - full).abs().max())


def check_mla_serve_against_cpu(dev) -> int:
    """MLA serving on the card (K3 at Dh 48) against the CPU (plain
    version): reduced minicpm3-4b, the same weights and ragged prompts, 4
    greedy decode steps; then, on the card, the first absorbed decode step
    against a prefill of the P + 1 tokens, both within ``SERVE_TOL``.
    Returns K3's launches in the card's serving run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import init_params
    cfg = get_config("minicpm3-4b").reduced()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    card_params = _tree_to(cpu_params, dev)
    prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
    ref = serve(cfg, cpu_params, prompts, 5, device="cpu")
    k3.launches = 0
    got = serve(cfg, card_params, prompts.to(dev), 5, device=dev)
    n = k3.launches
    diff = (got.logits.cpu() - ref.logits).abs()
    excess = float((diff - SERVE_TOL * ref.logits.abs()).max())
    same = torch.equal(got.tokens.cpu(), ref.tokens)
    gap = _first_decode_gap(cfg, card_params, prompts.to(dev))
    print(f"serve reduced minicpm3-4b (MLA, K3 at Dh 48): max|dlogits|="
          f"{float(diff.max()):.3g} (tol {SERVE_TOL:g}), tokens equal: "
          f"{same}, K3 launches {n}; first absorbed decode vs prefill of "
          f"P + 1 on the card: max|d|={gap:.3g}")
    if not (excess <= SERVE_TOL and same and n == cfg.n_layers
            and gap <= SERVE_TOL):
        raise AssertionError("reduced minicpm3-4b serving on the card "
                             "disagrees with the CPU or with its prefill")
    return n


def run_mla_main_path(dev):
    """minicpm3-4b at full width and depth through ``serve``: fp32, random
    weights (seed 0), 8 prompts of 1024 tokens, 32 generated; one warm run,
    then one timed run whose prefill must launch K3 once a layer (62).
    Prints the timings, peak memory and the first-decode-vs-prefill gap.
    Returns (result, K3 launches, (cfg, params, prompts))."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import init_params
    cfg = get_config("minicpm3-4b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompts = make_prompts(cfg, SERVE_B, SERVE_PROMPT, seed=1, device=dev)
    serve(cfg, params, prompts, SERVE_GEN, device=dev)     # warm
    torch.cuda.reset_peak_memory_stats(dev)
    k3.launches = 0
    res = serve(cfg, params, prompts, SERVE_GEN, device=dev)
    n3 = k3.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if n3 != cfg.n_layers:
        raise AssertionError(f"K3 launched {n3} times in one minicpm3-4b "
                             f"prefill, expected {cfg.n_layers}")
    if not bool(torch.isfinite(res.logits).all()):
        raise AssertionError("non-finite logits on the MLA serving path")
    if res.tokens.shape != (SERVE_B, SERVE_GEN) or not bool(
            ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad tokens {tuple(res.tokens.shape)}")
    t = res.timings
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"minicpm3-4b ({n_params} params) B={SERVE_B} "
          f"prompt={SERVE_PROMPT} gen={SERVE_GEN} fp32: prefill "
          f"{t['prefill_ms']} ms, decode {t['decode_ms_per_step']} ms per "
          f"step, {t['decode_tok_per_s']} generated tok/s, peak memory "
          f"{peak:.3f} GiB, K3 launches {n3}")
    print(f"first 16 tokens of prompt 0: {res.tokens[0, :16].tolist()}")
    gap = _first_decode_gap(cfg, params, torch.cat(
        [prompts, res.tokens[:, :1]], dim=1))
    print(f"minicpm3-4b first absorbed decode step vs prefill of P + 1: "
          f"max|dlogits|={gap:.3g} (printed, not gated)")
    return res, n3, (cfg, params, prompts)


class _Routing:
    """Records ``routing_stats`` of every ``moe_apply`` call made inside
    the ``with`` (dropped pairs, pairs, smallest top-k gap, kept on the
    device until read), by wrapping the function the model calls."""

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._apply = [], moe.moe_apply

        def recording(params, cfg, x):
            self.calls.append(moe.routing_stats(params["router"], x,
                                                cfg.moe))
            return self._apply(params, cfg, x)

        moe.moe_apply = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_apply = self._apply

    def summary(self, n=None) -> tuple:
        """(dropped pairs, pairs, smallest gap) over the first ``n``
        calls (all when None)."""
        calls = self.calls[:n]
        return (int(sum(int(c[0]) for c in calls)),
                sum(c[1] for c in calls),
                min(float(c[2]) for c in calls))


def _moe_cfg(arch, factor=None):
    """``arch`` reduced, at capacity ``factor`` (reduced()'s when None)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    if factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=factor))
    return cfg


def check_moe_serve_against_cpu(dev) -> dict:
    """MoE serving on the card (K3 at Dh 64 for granite-moe, 48 for
    deepseek-v3's MLA) against the CPU (plain version): each of
    ``MOE_ARCHS`` reduced, the same weights and ragged prompts, 4 greedy
    decode steps, free of drops and at ``MOE_DROP_FACTOR``, where the
    prefill must drop pairs; logits within ``SERVE_TOL``, tokens equal, K3
    once a layer. Then one ``moe_apply`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")``. Returns K3's launches in
    each card serving run, by (arch, capacity)."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models import moe
    from repro_torch.models.model import init_params, unstack
    launches = {}
    for arch in MOE_ARCHS:
        cpu_params = init_params(_moe_cfg(arch), torch.Generator().manual_seed(
            0), device="cpu")
        card_params = _tree_to(cpu_params, dev)
        prompts = make_prompts(_moe_cfg(arch), 2, 37, seed=1, device="cpu")
        for label, factor in (("free", None), ("drops", MOE_DROP_FACTOR)):
            cfg = _moe_cfg(arch, factor)
            n_moe = cfg.n_layers - cfg.moe.first_k_dense
            with _Routing() as cpu_routes:
                ref = serve(cfg, cpu_params, prompts, 5, device="cpu")
            k3.launches = 0
            with _Routing() as card_routes:
                got = serve(cfg, card_params, prompts.to(dev), 5, device=dev)
            n = launches[arch, label] = k3.launches
            dropped, pairs, gap = card_routes.summary(n_moe)
            gap = min(gap, cpu_routes.summary()[2], card_routes.summary()[2])
            diff = (got.logits.cpu() - ref.logits).abs()
            excess = float((diff - SERVE_TOL * ref.logits.abs()).max())
            same = torch.equal(got.tokens.cpu(), ref.tokens)
            print(f"serve reduced {arch} ({label}, capacity factor "
                  f"{cfg.moe.capacity_factor:g}): max|dlogits|="
                  f"{float(diff.max()):.3g} (tol {SERVE_TOL:g}), tokens "
                  f"equal: {same}, K3 launches {n}; prefill dropped "
                  f"{dropped} of {pairs} pairs; smallest top-k gap {gap:.3g}")
            if not (excess <= SERVE_TOL and same and n == cfg.n_layers
                    and (dropped > 0) == (label == "drops")):
                raise AssertionError(f"reduced {arch} ({label}) serving on "
                                     "the card disagrees with the CPU")
    cfg = _moe_cfg(MOE_ARCHS[0], MOE_DROP_FACTOR)
    layer = unstack(_tree_to(init_params(cfg, torch.Generator().manual_seed(
        0), device="cpu"), dev)["layers"])[0]["moe"]
    x = torch.randn((2, 64, cfg.d_model), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe.moe_apply(layer, cfg, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("moe_apply on the card under set_sync_debug_mode('error'): no "
          "host sync")
    return launches


def run_moe_main_path(dev):
    """granite-moe-3b-a800m at full width and depth through ``serve``:
    fp32, random weights (seed 0), 8 prompts of 1024 tokens, 32 generated;
    one warm run, then one timed run whose prefill must launch K3 once a
    layer (32). Prints the timings, peak memory and, from one more prefill
    with the routing recorded (untimed), the share of pairs dropped past
    capacity. Returns (result, K3 launches, (cfg, params, prompts))."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models import moe
    from repro_torch.models.model import init_params, prefill
    cfg = get_config("granite-moe-3b-a800m")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompts = make_prompts(cfg, SERVE_B, SERVE_PROMPT, seed=1, device=dev)
    serve(cfg, params, prompts, SERVE_GEN, device=dev)     # warm
    torch.cuda.reset_peak_memory_stats(dev)
    k3.launches = 0
    res = serve(cfg, params, prompts, SERVE_GEN, device=dev)
    n3 = k3.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if n3 != cfg.n_layers:
        raise AssertionError(f"K3 launched {n3} times in one granite-moe "
                             f"prefill, expected {cfg.n_layers}")
    if not bool(torch.isfinite(res.logits).all()):
        raise AssertionError("non-finite logits on the MoE serving path")
    if res.tokens.shape != (SERVE_B, SERVE_GEN) or not bool(
            ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad tokens {tuple(res.tokens.shape)}")
    with torch.no_grad(), _Routing() as routes:
        prefill(params, cfg, prompts)
    dropped, pairs, gap = routes.summary()
    t = res.timings
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"granite-moe-3b-a800m ({n_params} params) B={SERVE_B} "
          f"prompt={SERVE_PROMPT} gen={SERVE_GEN} fp32: prefill "
          f"{t['prefill_ms']} ms, decode {t['decode_ms_per_step']} ms per "
          f"step, {t['decode_tok_per_s']} generated tok/s, peak memory "
          f"{peak:.3f} GiB, K3 launches {n3}")
    cap = moe.capacity(cfg.moe, SERVE_B * SERVE_PROMPT)
    print(f"granite-moe prefill: capacity {cap} slots an expert, dropped "
          f"{dropped} of {pairs} pairs ({100 * dropped / pairs:.3f} %) "
          f"over {cfg.n_layers} layers; smallest top-k gap {gap:.3g}")
    print(f"first 16 tokens of prompt 0: {res.tokens[0, :16].tolist()}")
    return res, n3, (cfg, params, prompts)


def check_ssm_serve_against_cpu(dev) -> dict:
    """SSM serving on the card against the CPU (plain K3): each of
    ``SSM_ARCHS`` reduced, the same weights and ragged prompts, 4 greedy
    decode steps, without a window and, for zamba2, with ``SSM_WINDOW``,
    which the prompt wraps; logits within ``SERVE_TOL``, tokens equal, K3
    once an application of the shared block (never for falcon-mamba); then,
    on the card, the first decode step against a prefill of the P + 1
    tokens (``SERVE_TOL``). Returns K3's launches in each card serving run,
    by (arch, window)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import _n_shared_apps, init_params
    launches = {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch).reduced()
        cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        card_params = _tree_to(cpu_params, dev)
        prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
        for window in (0, SSM_WINDOW) if cfg.hybrid_attn_every else (0,):
            ref = serve(cfg, cpu_params, prompts, 5, window=window,
                        device="cpu")
            k3.launches = 0
            got = serve(cfg, card_params, prompts.to(dev), 5, window=window,
                        device=dev)
            n = launches[arch, window] = k3.launches
            diff = (got.logits.cpu() - ref.logits).abs()
            excess = float((diff - SERVE_TOL * ref.logits.abs()).max())
            same = torch.equal(got.tokens.cpu(), ref.tokens)
            gap = _first_decode_gap(cfg, card_params, prompts.to(dev),
                                    window)
            print(f"serve reduced {arch} window={window}: max|dlogits|="
                  f"{float(diff.max()):.3g} (tol {SERVE_TOL:g}), tokens "
                  f"equal: {same}, K3 launches {n}; first decode vs prefill "
                  f"of P + 1 on the card: max|d|={gap:.3g}")
            if not (excess <= SERVE_TOL and same and gap <= SERVE_TOL
                    and n == _n_shared_apps(cfg)):
                raise AssertionError(f"reduced {arch} serving on the card "
                                     f"(window {window}) disagrees with the "
                                     "CPU or with its prefill")
    return launches


def run_ssm_main_path(dev, arch, profile=False):
    """``arch`` (falcon-mamba-7b or zamba2-7b) at full width and depth
    through ``serve``: fp32, random weights (seed 0), 8 prompts of 1024
    tokens, 32 generated; one warm run, then one timed run whose prefill
    must launch K3 once an application of the shared block (zamba2: 13, at
    Dh 112; falcon-mamba: none). Prints the timings, peak memory and the
    first-decode-vs-prefill gap; with ``profile`` profiles one serve. The
    weights are freed on return. Returns (timings, K3 launches)."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import _n_shared_apps, init_params
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompts = make_prompts(cfg, SERVE_B, SERVE_PROMPT, seed=1, device=dev)
    serve(cfg, params, prompts, SERVE_GEN, device=dev)     # warm
    torch.cuda.reset_peak_memory_stats(dev)
    k3.launches = 0
    res = serve(cfg, params, prompts, SERVE_GEN, device=dev)
    n3 = k3.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if n3 != _n_shared_apps(cfg):
        raise AssertionError(f"K3 launched {n3} times in one {arch} "
                             f"prefill, expected {_n_shared_apps(cfg)}")
    if not bool(torch.isfinite(res.logits).all()):
        raise AssertionError(f"non-finite logits on {arch}'s serving path")
    if res.tokens.shape != (SERVE_B, SERVE_GEN) or not bool(
            ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad tokens {tuple(res.tokens.shape)}")
    t = res.timings
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"{arch} ({n_params} params) B={SERVE_B} prompt={SERVE_PROMPT} "
          f"gen={SERVE_GEN} fp32: prefill {t['prefill_ms']} ms, decode "
          f"{t['decode_ms_per_step']} ms per step, {t['decode_tok_per_s']} "
          f"generated tok/s, peak memory {peak:.3f} GiB, K3 launches {n3}")
    print(f"first 16 tokens of prompt 0: {res.tokens[0, :16].tolist()}")
    gap = _first_decode_gap(cfg, params, torch.cat(
        [prompts, res.tokens[:, :1]], dim=1))
    print(f"{arch} first decode step vs prefill of P + 1: max|dlogits|="
          f"{gap:.3g} (printed, not gated)")
    if profile:
        profile_serve(dev, cfg, params, prompts)
    return t, n3


def check_stub_families_against_cpu(dev) -> dict:
    """The stub-prefix configs (``STUB_ARCHS``) at ``reduced()`` on the
    card against the CPU (plain K3), the same weights: ``serve`` with the
    zero stub prefix on ragged prompts (logits within ``SERVE_TOL``,
    tokens equal, K3 once a layer by index), the first decode step against
    a prefill of the P + 1 tokens on the card (``SERVE_TOL``); then, under
    custom M-RoPE positions (``_mrope_layout``; musicgen takes its
    temporal component) and random stub embeddings, a prefill (logits and
    caches) and ``loss_fn`` with its gradients (``TRAIN_TOL``), K3's
    position path launching once a layer forward and each backward kernel
    of the plan once a layer. Returns the launches by (arch, run)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import train
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import init_params, prefill
    launches = {}
    for arch in STUB_ARCHS:
        cfg = get_config(arch).reduced()
        L = cfg.n_layers
        cpu_params = init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        card_params = _tree_to(cpu_params, dev)
        prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
        ref = serve(cfg, cpu_params, prompts, 5, device="cpu")
        k3.reset_counts()
        got = serve(cfg, card_params, prompts.to(dev), 5, device=dev)
        launches[arch, "serve"] = n = (k3.launches, k3.position_launches)
        diff = (got.logits.cpu() - ref.logits).abs()
        excess = float((diff - SERVE_TOL * ref.logits.abs()).max())
        same = torch.equal(got.tokens.cpu(), ref.tokens)
        gap = _first_decode_gap(cfg, card_params, prompts.to(dev))
        print(f"serve reduced {arch} (stub prefix {cfg.n_stub_tokens}): "
              f"max|dlogits|={float(diff.max()):.3g} (tol {SERVE_TOL:g}), "
              f"tokens equal: {same}, K3 launches {n[0]} (positions "
              f"{n[1]}); first decode vs prefill of P + 1 on the card: "
              f"max|d|={gap:.3g}")
        if not (excess <= SERVE_TOL and same and gap <= SERVE_TOL
                and n == (L, 0)):
            raise AssertionError(f"reduced {arch} serving on the card "
                                 "disagrees with the CPU or its prefill")
        g = torch.Generator().manual_seed(2)
        stub = torch.randn((2, cfg.n_stub_tokens, cfg.d_model), generator=g)
        positions = _mrope_layout(cfg.n_stub_tokens, 37, "cpu")
        if cfg.rope != "mrope":
            positions = positions[:, 0].contiguous()
        labels = torch.roll(prompts, -1, 1)
        labels[:, -1] = -1
        batch = {"tokens": prompts, "labels": labels, "stub_embeds": stub,
                 "positions": positions}
        card_batch = {name: t.to(dev) for name, t in batch.items()}
        with torch.no_grad():
            lc, cc = prefill(cpu_params, cfg, prompts, stub_embeds=stub,
                             positions=positions)
            k3.reset_counts()
            lg, cg = prefill(card_params, cfg, prompts.to(dev),
                             stub_embeds=stub.to(dev),
                             positions=card_batch["positions"])
        n_prefill = k3.position_launches
        errs = [float((lg.cpu() - lc).abs().max()),
                max(float((cg["layers"][name].cpu() - c).abs().max())
                    for name, c in cc["layers"].items())]
        loss_c, _, grads_c = train.value_and_grad(cpu_params, cfg, batch)
        k3.reset_counts()
        loss_g, _, grads_g = train.value_and_grad(card_params, cfg,
                                                  card_batch)
        torch.cuda.synchronize()
        n_fwd, n_bwd = k3.position_launches, dict(k3.backward_launches)
        launches[arch, "positions"] = (n_prefill, n_fwd, n_bwd)
        errs += [abs(float(loss_g) - float(loss_c)),
                 _tree_err(grads_g, grads_c)]
        S_eff = cfg.n_stub_tokens + 37
        kernels = _bwd_kernels((2, S_eff, S_eff, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, True, 0), dev)
        print(f"reduced {arch} under M-RoPE positions, card vs CPU: prefill "
              f"max|dlogits|={errs[0]:.3g} max|dcache|={errs[1]:.3g}; "
              f"loss_fn |dloss|={errs[2]:.3g} max|dgrads|={errs[3]:.3g} "
              f"(tol {TRAIN_TOL:g}); K3 position launches: prefill "
              f"{n_prefill}, training forward {n_fwd}, backward {n_bwd}")
        if not (max(errs) <= TRAIN_TOL and n_prefill == L and n_fwd == L
                and _bwd_counts_ok(n_bwd, kernels, L)):
            raise AssertionError(f"reduced {arch} under custom positions "
                                 "disagrees with the CPU")
    return launches


def run_stub_main_path(dev, arch, profile=False) -> dict:
    """``arch`` (qwen2-vl-2b or musicgen-large) at full width and depth:
    ``serve`` (fp32, random weights, seed 0, the zero stub prefix before 8
    prompts of 1024 tokens, 32 generated; one warm run, then one timed run
    whose prefill must launch K3 once a layer by index); for qwen2-vl also
    one prefill of the same prompts under their M-RoPE positions (the
    prefix as a 16 x 16 image, ``_mrope_layout``), which must launch K3's
    position path once a layer; then ``STUB_TRAIN_STEPS`` single-client SGD
    steps (B 8 x S 256 after a prefix of N(0, 0.02²) embeddings, the
    token embeddings' scale: the reference trainer's zero prefix
    overflows the backward at depth, ROADMAP C6; lr 3e-3) from the same
    weights: K3's forward and each backward kernel of the plan once a
    layer a step, the losses finite and falling. Prints timings and peaks; with ``profile``
    profiles one serve. The weights are freed on return. Returns the
    timings, peaks and launches."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import train
    from repro_torch.launch.serve import make_prompts, serve, stub_prefix
    from repro_torch.models.model import init_params, prefill
    cfg = get_config(arch)
    L = cfg.n_layers
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    prompts = make_prompts(cfg, SERVE_B, SERVE_PROMPT, seed=1, device=dev)
    serve(cfg, params, prompts, SERVE_GEN, device=dev)     # warm
    torch.cuda.reset_peak_memory_stats(dev)
    k3.reset_counts()
    res = serve(cfg, params, prompts, SERVE_GEN, device=dev)
    n3, n_pos = k3.launches, k3.position_launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if (n3, n_pos) != (L, 0):
        raise AssertionError(f"K3 launched {n3} times ({n_pos} with "
                             f"positions) in one {arch} prefill, expected "
                             f"{L} by index")
    if not bool(torch.isfinite(res.logits).all()):
        raise AssertionError(f"non-finite logits on {arch}'s serving path")
    if res.tokens.shape != (SERVE_B, SERVE_GEN) or not bool(
            ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise AssertionError(f"bad tokens {tuple(res.tokens.shape)}")
    t = res.timings
    print(f"{arch} ({n_params} params) B={SERVE_B} stub={cfg.n_stub_tokens} "
          f"prompt={SERVE_PROMPT} gen={SERVE_GEN} fp32: prefill "
          f"{t['prefill_ms']} ms, decode {t['decode_ms_per_step']} ms per "
          f"step, {t['decode_tok_per_s']} generated tok/s, peak memory "
          f"{peak:.3f} GiB, K3 launches {n3}")
    print(f"first 16 tokens of prompt 0: {res.tokens[0, :16].tolist()}")
    gap = _first_decode_gap(cfg, params, torch.cat(
        [prompts, res.tokens[:, :1]], dim=1))
    print(f"{arch} first decode step vs prefill of P + 1: max|dlogits|="
          f"{gap:.3g} (printed, not gated)")
    if profile:
        profile_serve(dev, cfg, params, prompts)
    out = {"serve": t, "serve_peak_gib": peak, "k3": n3, "params": n_params}
    if cfg.rope == "mrope":
        positions = _mrope_layout(cfg.n_stub_tokens, SERVE_PROMPT, dev)
        stub = stub_prefix(cfg, SERVE_B, dev)
        with torch.no_grad():
            prefill(params, cfg, prompts, stub_embeds=stub,
                    positions=positions)                     # warm
            torch.cuda.synchronize()
            k3.reset_counts()
            t0 = time.perf_counter()
            logits, _ = prefill(params, cfg, prompts, stub_embeds=stub,
                                positions=positions)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out["k3_positions"] = n_pos = k3.position_launches
        out["mrope_prefill_ms"] = ms
        print(f"{arch} M-RoPE prefill (the prefix as a 16 x 16 image, text "
              f"from 16): {ms} ms, K3 position launches {n_pos}")
        if not (n_pos == k3.launches == L
                and bool(torch.isfinite(logits).all())):
            raise AssertionError(f"{arch}'s M-RoPE prefill: K3 position "
                                 f"launches {n_pos}")
        del logits
    box = [params]
    del params, res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    k3.reset_counts()
    g = torch.Generator(device=dev).manual_seed(3)
    stub = 0.02 * torch.randn((TRAIN_B, cfg.n_stub_tokens, cfg.d_model),
                              generator=g, device=dev)
    tr = train.single_client(cfg, steps=STUB_TRAIN_STEPS, batch=TRAIN_B,
                             seq=TRAIN_S, lr=TRAIN_LR, params=box.pop(),
                             stub_embeds=stub, device=dev)
    torch.cuda.synchronize()
    n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
    train_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del tr["params"]
    shape = BWD_QWEN2VL if arch == "qwen2-vl-2b" else BWD_MUSICGEN
    want = L * STUB_TRAIN_STEPS
    tt = tr["timings"]
    print(f"{arch} training B={TRAIN_B} S={TRAIN_S} after the stub prefix, "
          f"{STUB_TRAIN_STEPS} SGD steps fp32: {tt['ms_per_step']} ms per "
          f"step after the first ({tt['first_step_ms']} ms), "
          f"{tt['tokens_per_s']} tokens/s, peak memory {train_peak:.3f} GiB;"
          f" losses {tr['losses']}; launches K3 forward {n_fwd}, backward "
          f"{n_bwd}")
    if not (n_fwd == want and k3.position_launches == 0
            and _bwd_counts_ok(n_bwd, _bwd_kernels(shape, dev), want)
            and all(np.isfinite(tr["losses"]))
            and tr["losses"][-1] < tr["losses"][0]):
        raise AssertionError(f"{arch} training: K3 {n_fwd}/{n_bwd}, losses "
                             f"{tr['losses']}")
    torch.cuda.empty_cache()
    out.update(train=tt, train_peak_gib=train_peak, losses=tr["losses"],
               k3_forward=n_fwd, k3_backward=n_bwd)
    return out


def _bwd_inputs(shape, dev, seed=0, dtype=torch.float32):
    """K3's inputs at ``shape`` and an output cotangent dO, in ``dtype``
    (drawn in fp32)."""
    q, k, v = _attn_inputs(shape, dtype, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    return q, k, v, torch.randn(q.shape, generator=g, device=dev).to(dtype)


def _autograd_grads(q, k, v, dout, causal, window, **positions):
    """(out, dq, dk, dv) through ``flash_attention``'s autograd path, with
    explicit ``q_positions`` and ``kv_positions`` when given."""
    from repro_torch.kernels import flash_attention as k3
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = k3.flash_attention(q, k, v, causal=causal, window=window,
                             **positions)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    return (out.detach(),) + grads


def check_flash_attention_backward(dev) -> float:
    """K3's backward against the float64 plain backward at every shape of
    ``BWD_SHAPES`` and Dh 192's ``BWD_DS_SHAPES`` (its own dK/dV and dQ
    kernels), |d| <= tol + tol·|plain| for dq, dk, dv and the row
    LSE; a second run bitwise equal; the training forward's output bitwise
    the serving forward's; fully masked rows' dq and output exactly 0.
    Raises past any. Returns, for the training main paths' shapes
    (``BWD_MAIN``, ``BWD_QWEN2VL``, ``BWD_MUSICGEN``, ``BWD_MINICPM``,
    ``BWD_ZAMBA2``, ``BWD_MLA_SMALL``, ``BWD_DS``) and the federated
    one's (``BWD_FED``), the max |d| and
    the worst excess max(|d| − tol·|plain|), which the check holds to <=
    tol."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ref
    errs_at = {}
    for shape in BWD_SHAPES + BWD_DS_SHAPES:
        causal, window = shape[6], shape[7]
        q, k, v, dout = _bwd_inputs(shape, dev)
        first = _autograd_grads(q, k, v, dout, causal, window)
        second = _autograd_grads(q, k, v, dout, causal, window)
        bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
        with torch.no_grad():
            served = k3.flash_attention(q, k, v, causal=causal,
                                        window=window)
            _, lse = k3._launch(q, k, v, causal, window, with_lse=True)
        torch.cuda.synchronize()
        same_out = torch.equal(first[0], served)
        q64, k64, v64 = q.double(), k.double(), v.double()
        out64 = ref.flash_attention_ref(q64, k64, v64, causal=causal,
                                        window=window)
        lse64 = ref.attention_lse_ref(q64, k64, causal=causal, window=window)
        expect = ref.flash_attention_bwd_ref(q64, k64, v64, out64, lse64,
                                             dout.double(), causal=causal,
                                             window=window)
        errs, excess = [], []
        for got, want in zip(first[1:], expect):
            diff = (got.double() - want).abs()
            errs.append(float(diff.max()))
            excess.append(float((diff - BWD_TOL * want.abs()).max()))
        masked = torch.isinf(lse64)                       # (B, H, Sq)
        if not bool((torch.isinf(lse) == masked).all()):
            raise AssertionError(f"K3 LSE: fully masked rows differ at "
                                 f"{shape}")
        ldiff = (lse.double() - lse64)[~masked].abs()
        lse_err = float(ldiff.max()) if ldiff.numel() else 0.0
        lse_excess = (float((ldiff - BWD_TOL * lse64[~masked].abs()).max())
                      if ldiff.numel() else 0.0)
        rows = masked.transpose(1, 2)                     # (B, Sq, H)
        zero_rows = bool((first[1][rows] == 0).all()
                         and (first[0][rows] == 0).all())
        finite = all(bool(torch.isfinite(t).all()) for t in first)
        print(f"K3 backward {shape}: max|d| dq={errs[0]:.3g} dk={errs[1]:.3g}"
              f" dv={errs[2]:.3g} lse={lse_err:.3g} (tol {BWD_TOL:g}, atol "
              f"and rtol), bitwise repeat {bitwise}, out == serving "
              f"{same_out}, masked rows {int(rows.sum())} zero {zero_rows}")
        del expect, out64, q64, k64, v64
        if not (max(excess) <= BWD_TOL and lse_excess <= BWD_TOL and bitwise
                and same_out and zero_rows and finite):
            raise AssertionError(f"K3 backward disagrees with its plain "
                                 f"version at {shape}")
        if shape in (BWD_MAIN, BWD_FED, BWD_QWEN2VL, BWD_MUSICGEN,
                     BWD_MINICPM, BWD_ZAMBA2, BWD_MLA_SMALL, BWD_CHATGLM,
                     BWD_DS):
            errs_at[shape] = (max(errs), max(excess))
        torch.cuda.empty_cache()
    return errs_at


def check_dh192_fp32_positions(dev) -> None:
    """K3's fp32 kernels at Dh 192 (``flash_attention_wide_kernel``,
    ``attn_bwd_dkdv_wide_kernel``, ``attn_bwd_dq_wide_kernel``) by explicit
    positions at every shape of ``ATTN_DS_SHAPES`` (the forward) and
    ``BWD_DS_SHAPES`` (the backward), the indices + ``POS_TRAIN_OFFSET``
    on both sides (the index path's masks): the serving forward within
    ``ATTN_TOL`` of the plain version, the backward through the autograd
    path within ``BWD_TOL`` of the float64 plain backward and a second run
    bitwise the first, each call counting its position launches. Raises
    past any."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ref

    def positions(Sq, Skv):
        return dict(q_positions=torch.arange(POS_TRAIN_OFFSET,
                                             POS_TRAIN_OFFSET + Sq,
                                             device=dev),
                    kv_positions=torch.arange(POS_TRAIN_OFFSET,
                                              POS_TRAIN_OFFSET + Skv,
                                              device=dev))
    tol = ATTN_TOL[torch.float32]
    for shape in ATTN_DS_SHAPES:
        causal, window = shape[6], shape[7]
        pos = positions(shape[1], shape[2])
        q, k, v = _attn_inputs(shape, torch.float32, dev)
        n = k3.position_launches
        out = k3.flash_attention(q, k, v, causal=causal, window=window,
                                 **pos)
        torch.cuda.synchronize()
        expect = ref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window, **pos)
        diff = (out - expect).abs()
        excess = float((diff - tol * expect.abs()).max())
        print(f"K3 fp32 {shape} by positions {POS_TRAIN_OFFSET}..: max|d|="
              f"{float(diff.max()):.3g} (tol {tol:g}, atol and rtol)")
        if k3.position_launches != n + 1 or excess > tol:
            raise AssertionError(f"K3 by positions disagrees with its "
                                 f"plain version at {shape}")
        del q, k, v, out, expect, diff
    for shape in BWD_DS_SHAPES:
        causal, window = shape[6], shape[7]
        pos = positions(shape[1], shape[2])
        q, k, v, dout = _bwd_inputs(shape, dev)
        n = k3.position_launches
        first = _autograd_grads(q, k, v, dout, causal, window, **pos)
        second = _autograd_grads(q, k, v, dout, causal, window, **pos)
        bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
        q64, k64, v64 = q.double(), k.double(), v.double()
        expect = ref.flash_attention_bwd_ref(
            q64, k64, v64, ref.flash_attention_ref(
                q64, k64, v64, causal=causal, window=window, **pos),
            ref.attention_lse_ref(q64, k64, causal=causal, window=window,
                                  **pos),
            dout.double(), causal=causal, window=window, **pos)
        errs, excess = [], []
        for got, want in zip(first[1:], expect):
            d = (got.double() - want).abs()
            errs.append(float(d.max()))
            excess.append(float((d - BWD_TOL * want.abs()).max()))
        print(f"K3 fp32 backward {shape} by positions {POS_TRAIN_OFFSET}..: "
              f"max|d| dq={errs[0]:.3g} dk={errs[1]:.3g} dv={errs[2]:.3g} "
              f"(tol {BWD_TOL:g}, atol and rtol), bitwise repeat {bitwise}")
        if not (bitwise and max(excess) <= BWD_TOL
                and k3.position_launches == n + 2):
            raise AssertionError(f"K3's backward by positions disagrees "
                                 f"with its plain version at {shape}")
        del first, second, expect, q64, k64, v64
        torch.cuda.empty_cache()


def check_flash_attention_backward_bf16(dev) -> dict:
    """K3's bf16 training forward and backward
    (``csrc/flash_attention_bf16.cu``, ``csrc/flash_attention_bwd_bf16.cu``)
    at every shape of ``BWD_BF16_SHAPES`` and Dh 192's ``BWD_DS_SHAPES``:
    dq, dk, dv (bf16) against the
    float64 plain backward of the same bf16 values within ``BWD_BF16_TOL``
    (|d| <= tol + tol·|plain|) and, per gradient, max |d| within
    ``BWD_BF16_PLAIN_FACTOR`` times that of the plain version of the
    kernels' bf16 arithmetic (``flash_attention_bwd_bf16_ref``, on the
    card from the same inputs and the training forward's fp32 output and
    LSE) + ``BWD_BF16_PLAIN_ATOL``; the bf16 training forward's row LSE
    within ``BWD_TOL`` of the float64 one (+inf exactly on fully masked
    rows), its output bitwise the bf16 serving forward's; a second run
    bitwise equal; fully masked rows' dq and output exactly 0; every
    launch the bf16 kernels' (``k3.bf16_launches``,
    ``k3.bf16_backward_launches``). Raises past any. Returns (max |d|,
    worst excess) at ``BWD_CHATGLM``, ``BWD_TRAIN_4K`` and
    ``ATTN_ROUND_TRAIN``."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ref
    errs_at = {}
    for shape in BWD_BF16_SHAPES + BWD_DS_SHAPES:
        causal, window = shape[6], shape[7]
        q, k, v, dout = _bwd_inputs(shape, dev, dtype=torch.bfloat16)
        k3.reset_counts()
        first = _autograd_grads(q, k, v, dout, causal, window)
        second = _autograd_grads(q, k, v, dout, causal, window)
        bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
        dtypes_ok = all(t.dtype == torch.bfloat16 for t in first)
        with torch.no_grad():
            served = k3.flash_attention(q, k, v, causal=causal,
                                        window=window)
            out32, lse = k3._launch(q, k, v, causal, window, with_lse=True)
        torch.cuda.synchronize()
        routed = (k3.bf16_launches == k3.launches == 4
                  and k3.bf16_backward_launches == k3.backward_launches)
        same_out = torch.equal(first[0], served)
        plain = ref.flash_attention_bwd_bf16_ref(q, k, v, out32, lse, dout,
                                                 causal=causal,
                                                 window=window)
        del out32
        q64, k64, v64 = q.double(), k.double(), v.double()
        out64 = ref.flash_attention_ref(q64, k64, v64, causal=causal,
                                        window=window)
        lse64 = ref.attention_lse_ref(q64, k64, causal=causal, window=window)
        expect = ref.flash_attention_bwd_ref(q64, k64, v64, out64, lse64,
                                             dout.double(), causal=causal,
                                             window=window)
        del out64
        errs, excess, plain_errs = [], [], []
        for got, want, mine in zip(first[1:], expect, plain):
            diff = (got.double() - want).abs()
            errs.append(float(diff.max()))
            excess.append(float((diff - BWD_BF16_TOL * want.abs()).max()))
            plain_errs.append(float((mine.double() - want).abs().max()))
            del diff
        del expect, plain
        over_plain = max(e - BWD_BF16_PLAIN_FACTOR * p
                         for e, p in zip(errs, plain_errs))
        masked = torch.isinf(lse64)
        ldiff = (lse.double() - lse64)[~masked].abs()
        lse_err = float(ldiff.max()) if ldiff.numel() else 0.0
        lse_excess = (float((ldiff - BWD_TOL * lse64[~masked].abs()).max())
                      if ldiff.numel() else 0.0)
        inf_ok = bool((torch.isinf(lse) == masked).all())
        rows = masked.transpose(1, 2)
        zero_rows = bool((first[1][rows] == 0).all()
                         and (first[0][rows] == 0).all())
        finite = all(bool(torch.isfinite(t).all()) for t in first)
        plan = k3.backward_plan(*shape, k3._sm_count(dev), torch.bfloat16)
        print(f"K3 bf16 backward {shape}: max|d| dq={errs[0]:.3g} "
              f"dk={errs[1]:.3g} dv={errs[2]:.3g} (tol {BWD_BF16_TOL:g}, "
              f"atol and rtol; worst excess {max(excess):.3g}); the plain "
              f"bf16 version's dq={plain_errs[0]:.3g} dk={plain_errs[1]:.3g}"
              f" dv={plain_errs[2]:.3g} (kernel - {BWD_BF16_PLAIN_FACTOR:g}"
              f" x plain at most {over_plain:.3g}, tol "
              f"{BWD_BF16_PLAIN_ATOL:g}), lse="
              f"{lse_err:.3g} (tol {BWD_TOL:g}), bitwise repeat {bitwise}, "
              f"out == serving {same_out}, masked rows {int(rows.sum())} "
              f"zero {zero_rows}, bf16 kernels only {routed}, plan "
              f"{plan['kernels']} splits {plan['splits']}")
        del q64, k64, v64, lse64
        if not (max(excess) <= BWD_BF16_TOL and lse_excess <= BWD_TOL
                and over_plain <= BWD_BF16_PLAIN_ATOL and inf_ok
                and bitwise and same_out and zero_rows and finite
                and dtypes_ok and routed):
            raise AssertionError(f"K3's bf16 backward disagrees with its "
                                 f"plain version at {shape}")
        if shape in (BWD_CHATGLM, BWD_TRAIN_4K, ATTN_ROUND_TRAIN,
                     BWD_MINICPM, BWD_ZAMBA2, BWD_DS):
            errs_at[shape] = (max(errs), max(excess))
        torch.cuda.empty_cache()
    return errs_at


def _mrope_layout(n_stub, text, device):
    """qwen2-vl's positions for a prompt of ``n_stub`` image patches (a
    grid of isqrt(n_stub) rows: t 0, h the row, w the column) and then
    ``text`` tokens from the grid's largest side on, every component
    counting: (n_stub + text, 3) int32."""
    import math
    rows = math.isqrt(n_stub)
    cols = n_stub // rows
    i = torch.arange(n_stub)
    image = torch.stack([torch.zeros_like(i), i // cols, i % cols], dim=-1)
    t = torch.arange(text)[:, None].expand(text, 3) + max(rows, cols)
    return torch.cat([image, t]).to(device=device, dtype=torch.int32)


def _position_pattern(name, n, device):
    """(q_positions, kv_positions, window) int32 for self attention over
    ``n`` tokens: ``arange`` (the indices), ``mrope`` (the temporal
    component of ``_mrope_layout(256, n - 256)``: 256 tied at 0, then text
    from 16), ``pad`` (the indices with a tail of forty -1s), ``window``
    (``mrope`` under a window of 256), ``masked_rows`` (keys at the
    indices + 50: causal rows 0..49 see none), ``unsorted`` (``mrope``
    permuted, under a window of 100)."""
    ar = torch.arange(n, dtype=torch.int32)
    mrope = _mrope_layout(256, n - 256, "cpu")[:, 0]
    window = 0
    if name == "arange":
        qp = kp = ar
    elif name in ("mrope", "window"):
        qp = kp = mrope
        window = 256 if name == "window" else 0
    elif name == "pad":
        qp = kp = torch.where(ar < n - 40, ar, -1).to(torch.int32)
    elif name == "masked_rows":
        qp, kp = ar, ar + 50
    elif name == "unsorted":
        g = torch.Generator().manual_seed(n)
        qp = kp = mrope[torch.randperm(n, generator=g)]
        window = 100
    else:
        raise ValueError(name)
    return qp.to(device), kp.to(device), window


def _bf16_position_errors(b16, grads, causal, window, pos) -> tuple:
    """The bf16 backward with explicit positions (``grads``: the output
    and dq, dk, dv of ``b16`` = q, k, v, dO in bf16) against the float64
    plain backward of the same values (``BWD_BF16_TOL``, atol and rtol)
    and, per gradient, within ``BWD_BF16_PLAIN_FACTOR`` x the plain bf16
    version's error + ``BWD_BF16_PLAIN_ATOL`` (phase 6's gate). Returns
    ({name: max |d|}, ok)."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ref
    q, k, v, dout = b16
    out32, lse = k3._launch(q, k, v, causal, window, with_lse=True, **pos)
    plain = ref.flash_attention_bwd_bf16_ref(q, k, v, out32, lse, dout,
                                             causal=causal, window=window,
                                             **pos)
    q64, k64, v64 = q.double(), k.double(), v.double()
    expect = ref.flash_attention_bwd_ref(
        q64, k64, v64, ref.flash_attention_ref(
            q64, k64, v64, causal=causal, window=window, **pos),
        ref.attention_lse_ref(q64, k64, causal=causal, window=window,
                              **pos), dout.double(), causal=causal,
        window=window, **pos)
    errs, ok = {}, all(t.dtype == torch.bfloat16 for t in grads[1:])
    for got, want, mine, key in zip(grads[1:], expect, plain,
                                    ("dq16", "dk16", "dv16")):
        diff = (got.double() - want).abs()
        errs[key] = float(diff.max())
        plain_err = float((mine.double() - want).abs().max())
        ok &= (bool(torch.isfinite(got).all())
               and float((diff - BWD_BF16_TOL * want.abs()).max())
               <= BWD_BF16_TOL
               and errs[key] <= BWD_BF16_PLAIN_FACTOR * plain_err
               + BWD_BF16_PLAIN_ATOL)
    return errs, ok


def check_flash_attention_positions(dev) -> tuple:
    """K3 with explicit positions (``POS_SHAPES`` and ``POS_FWD_SHAPES``
    x ``POS_PATTERNS``) against its plain versions on the card: the
    serving forward in fp32 and bf16 (``ATTN_TOL``; fully masked rows
    exactly 0), the fp32 training instantiation (output bitwise the
    serving one's, row LSE within ``BWD_TOL``, +inf exactly on the fully
    masked rows) and, at the backward's head dims, the backward through
    the autograd path against the float64 plain backward (``BWD_TOL``;
    fully masked rows' dq exactly 0), and in bf16 under phase 6's bf16
    gate (:func:`_bf16_position_errors`); for the arange, the output, LSE
    and gradients (both dtypes) bitwise the index path's. Every call with
    positions must count one position launch. Then the forward at qwen2-vl's full prefill
    (``ATTN_QWEN2VL``) under its M-RoPE prompt's temporal positions.
    Then the bf16 backward with positions at qwen2-vl's training shape
    under its M-RoPE prompt's temporal positions (``BWD_QWEN2VL``). Raises
    past any; returns the max |d| of the fp32 prefill and of that bf16
    backward (phase 8's positions rows), and by head dim of
    ``POS_FWD_SHAPES`` the errors under the M-RoPE pattern."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ref
    errs_at = {}
    for shape in POS_SHAPES + POS_FWD_SHAPES:
        B, Sq, Skv, H, KH, Dh, causal, _ = shape
        bwd = Dh in k3.BWD_HEAD_DIMS             # fp32
        bwd16 = Dh in k3.BWD_BF16_HEAD_DIMS
        for name in POS_PATTERNS:
            qp, kp, window = _position_pattern(name, Sq, dev)
            pos = dict(q_positions=qp, kv_positions=kp)
            q, k, v, dout = _bwd_inputs(shape, dev)
            n_pos = k3.position_launches
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd = (t.to(dtype) for t in (q, k, v))
                out = k3.flash_attention(qd, kd, vd, causal=causal,
                                         window=window, **pos)
                expect = ref.flash_attention_ref(
                    qd, kd, vd, causal=causal, window=window, **pos).float()
                diff = (out.float() - expect).abs()
                errs[str(dtype)[6:]] = float(diff.max())
                tol = ATTN_TOL[dtype]
                if not (out.dtype == dtype and float(
                        (diff - tol * expect.abs()).max()) <= tol):
                    raise AssertionError(f"K3 with positions {name} at "
                                         f"{shape} {dtype}: {errs}")
                if dtype == torch.float32:
                    served = out
            trained, lse = k3._launch(q, k, v, causal, window,
                                      with_lse=True, **pos)
            want = ref.attention_lse_ref(q.double(), k.double(),
                                         causal=causal, window=window, **pos)
            masked = torch.isinf(want)
            d = (lse.double() - want)[~masked].abs()
            lse_ok = (torch.equal(trained, served)
                      and bool((torch.isinf(lse) == masked).all())
                      and (not d.numel() or float(
                          (d - BWD_TOL * want[~masked].abs()).max())
                          <= BWD_TOL))
            rows = masked.transpose(1, 2)                    # (B, Sq, H)
            zero = bool((served[rows] == 0).all())
            bwd_ok, grads, grads16 = True, (), ()
            if bwd:
                grads = _autograd_grads(q, k, v, dout, causal, window,
                                        **pos)
                q64, k64, v64 = q.double(), k.double(), v.double()
                expect = ref.flash_attention_bwd_ref(
                    q64, k64, v64, ref.flash_attention_ref(
                        q64, k64, v64, causal=causal, window=window, **pos),
                    want, dout.double(), causal=causal, window=window,
                    **pos)
                for got, w, key in zip(grads[1:], expect,
                                       ("dq", "dk", "dv")):
                    diff = (got.double() - w).abs()
                    errs[key] = float(diff.max())
                    bwd_ok &= (bool(torch.isfinite(got).all()) and float(
                        (diff - BWD_TOL * w.abs()).max()) <= BWD_TOL)
                zero &= bool((grads[1][rows] == 0).all())
                del expect, q64, k64, v64
            if bwd16:
                # bf16 (PR 29): the kernels against the float64 backward
                # of the same bf16 values and the plain bf16 version
                b16 = [t.bfloat16() for t in (q, k, v, dout)]
                grads16 = _autograd_grads(*b16, causal, window, **pos)
                errs16, ok16 = _bf16_position_errors(b16, grads16, causal,
                                                     window, pos)
                errs.update(errs16)
                bwd_ok &= ok16
                zero &= bool((grads16[1][rows] == 0).all())
            same = True
            if name == "arange":             # bitwise the index path
                idx_out, idx_lse = k3._launch(q, k, v, causal, window,
                                              with_lse=True)
                idx = (_autograd_grads(q, k, v, dout, causal, window)
                       if bwd else ())
                idx16 = (_autograd_grads(*b16, causal, window)
                         if bwd16 else ())
                same = (torch.equal(idx_out, trained)
                        and torch.equal(idx_lse, lse)
                        and all(torch.equal(a, b)
                                for a, b in zip(idx, grads))
                        and all(torch.equal(a, b)
                                for a, b in zip(idx16, grads16)))
            launched = k3.position_launches - n_pos
            print(f"K3 positions {name} {shape} window={window}: max|d| "
                  + " ".join(f"{key}={e:.3g}" for key, e in errs.items())
                  + f", LSE ok {lse_ok}, masked rows {int(rows.sum())} "
                  f"zero {zero}, bitwise the index path {same}, position "
                  f"launches {launched}")
            if not (lse_ok and bwd_ok and zero and same
                    and launched == 3 + bwd + 2 * bwd16):
                raise AssertionError(f"K3 with positions {name} disagrees "
                                     f"at {shape}")
            if name == "mrope" and shape in POS_FWD_SHAPES:
                errs_at[Dh] = errs
    B, Sq, Skv, H, KH, Dh, causal, window = ATTN_QWEN2VL
    qp = _mrope_layout(256, Sq - 256, dev)[:, 0].contiguous()
    q, k, v = _attn_inputs(ATTN_QWEN2VL, torch.float32, dev)
    out = k3.flash_attention(q, k, v, causal=causal, window=window,
                             q_positions=qp, kv_positions=qp)
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_positions=qp, kv_positions=qp)
    diff = (out - expect).abs()
    err = float(diff.max())
    excess = float((diff - ATTN_TOL[torch.float32] * expect.abs()).max())
    print(f"K3 positions, qwen2-vl's M-RoPE prefill {ATTN_QWEN2VL}: max|d|="
          f"{err:.3g} (tol {ATTN_TOL[torch.float32]:g})")
    if excess > ATTN_TOL[torch.float32]:
        raise AssertionError("K3 with positions disagrees at qwen2-vl's "
                             "prefill")
    del expect, diff
    # the bf16 backward with positions at qwen2-vl's training shape, under
    # its M-RoPE prompt's temporal positions (phase 7i's, phase 8's row)
    causal, window = BWD_QWEN2VL[6], BWD_QWEN2VL[7]
    qp = _mrope_layout(256, BWD_QWEN2VL[1] - 256, dev)[:, 0].contiguous()
    pos = dict(q_positions=qp, kv_positions=qp)
    b16 = _bwd_inputs(BWD_QWEN2VL, dev, dtype=torch.bfloat16)
    grads16 = _autograd_grads(*b16, causal, window, **pos)
    errs16, ok16 = _bf16_position_errors(b16, grads16, causal, window, pos)
    print(f"K3 bf16 backward with positions, qwen2-vl's M-RoPE training "
          f"shape {BWD_QWEN2VL}: max|d| "
          + " ".join(f"{k}={e:.3g}" for k, e in errs16.items())
          + f" (tol {BWD_BF16_TOL:g}, and within {BWD_BF16_PLAIN_FACTOR:g} x"
          f" the plain bf16 version's + {BWD_BF16_PLAIN_ATOL:g}): {ok16}")
    if not ok16:
        raise AssertionError("K3's bf16 backward with positions disagrees "
                             "at qwen2-vl's training shape")
    del b16, grads16
    torch.cuda.empty_cache()
    return err, max(errs16.values()), errs_at


def check_train_against_cpu(dev, arch="smollm-135m", fed=True) -> dict:
    """LM training on the card (K3 forward and backward, K2) against the
    CPU (plain versions): ``arch`` at reduced(), the same weights, batches
    and link masks; 3 SGD steps, then, with ``fed``, one federated round
    at C = 3 with 2 local steps and one link erased. Losses, π* and params
    within ``TRAIN_TOL``; K3's forward and each backward kernel of the plan
    once an attention layer a step of the card's single-client run.
    Returns that run's backward launches."""
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    quiet = dict(log=lambda line: None)
    cfg = get_config(arch).reduced()
    p0 = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(steps=3, batch=2, seq=64, lr=TRAIN_LR, **quiet)
    ref = train.single_client(cfg, params=p0, device="cpu", **kw)
    k3.reset_counts()
    got = train.single_client(cfg, params=_tree_to(p0, dev), device=dev,
                              **kw)
    torch.cuda.synchronize()
    n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
    want = _attention_layers(cfg) * kw["steps"]
    shape = (2, 64, 64, cfg.n_heads, cfg.n_kv_heads, _attn_head_dim(cfg),
             True, cfg.sliding_window)
    errs = [max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])),
            _tree_err(got["params"], ref["params"])]
    line = (f"train reduced {arch}, card vs CPU: 3 SGD steps max|dloss|="
            f"{errs[0]:.3g} max|dparams|={errs[1]:.3g}, K3 forward {n_fwd} "
            f"backward {n_bwd}")
    links_ok = True
    if fed:
        inits = [init_params(cfg, torch.Generator().manual_seed(c), "cpu")
                 for c in range(3)]
        stacked = tree_map(lambda *xs: torch.stack(xs), *inits)
        masks = np.array([[True, False]])
        kw = dict(clients=3, rounds=1, local_steps=2, batch=2, seq=64,
                  lr=TRAIN_LR, link_masks=masks, **quiet)
        fref = train.federated(cfg, params=tree_map(torch.clone, stacked),
                               device="cpu", **kw)
        fgot = train.federated(cfg, params=_tree_to(stacked, dev),
                               device=dev, **kw)
        errs += [abs(fgot["target_loss"][0] - fref["target_loss"][0]),
                 float(np.abs(fgot["pi"][0] - fref["pi"][0]).max()),
                 _tree_err(fgot["params"], fref["params"])]
        links_ok = np.array_equal(fgot["links"][0], masks[0])
        line += (f"; one federated round at C = 3: |dloss|={errs[2]:.3g} "
                 f"max|dpi|={errs[3]:.3g} max|dparams|={errs[4]:.3g}")
    print(f"{line} (tol {TRAIN_TOL:g})")
    if not (max(errs) <= TRAIN_TOL and links_ok and n_fwd == want
            and _bwd_counts_ok(n_bwd, _bwd_kernels(shape, dev)
                               if want else (), want)):
        raise AssertionError(f"the card's training run of reduced {arch} "
                             f"disagrees with the CPU's")
    return n_bwd


def _attention_layers(cfg) -> int:
    """K3 launches in one training forward of ``cfg``: one an attention
    layer (and one for an MTP head's block), or one an application of a
    hybrid's shared block; 0 for a pure SSM."""
    if cfg.ssm:
        return (cfg.n_layers // cfg.hybrid_attn_every
                if cfg.hybrid_attn_every else 0)
    return cfg.n_layers + (1 if cfg.mtp_depth else 0)


def _attn_head_dim(cfg) -> int:
    """The head dim ``cfg``'s attention gives K3: qk_nope + qk_rope under
    MLA (v padded to it), else the head dim."""
    if cfg.mla:
        return cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    return cfg.resolved_head_dim


def run_family_train_main_path(dev, arch) -> dict:
    """``arch`` at full width and depth through ``single_client``: B 8 x S
    256, ``FAMILY_STEPS`` SGD steps at lr 3e-3, fp32, from seed-0 weights,
    recomputing each layer in the backward for ``FAMILY_REMAT``. Each
    backward kernel of the plan at the family's training shape
    (``FAMILY_FULL``) launches once an attention layer a step (none for
    falcon-mamba), K3's forward once, or twice under remat (the recompute
    runs it again); the losses are finite and falling: the last step's
    below the first's, as phase 7e gates, and the trained weights' loss on
    the first step's batch below that step's (the same batch, so no
    batch-to-batch spread in it). The weights are freed on return.
    Returns the timings, losses, peak and launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import token_batch_stream
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import train
    from repro_torch.models.model import loss_fn
    cfg = get_config(arch)
    shape = FAMILY_FULL[arch]
    remat = arch in FAMILY_REMAT
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    k3.reset_counts()
    tr = train.single_client(cfg, steps=FAMILY_STEPS, batch=TRAIN_B,
                             seq=TRAIN_S, lr=TRAIN_LR, remat=remat,
                             device=dev)
    torch.cuda.synchronize()
    n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    first = next(token_batch_stream(0, batch=TRAIN_B, seq_len=TRAIN_S,
                                    vocab=cfg.vocab))
    with torch.no_grad():
        held = float(loss_fn(tr.pop("params"), cfg, {
            k: torch.from_numpy(v).to(dev) for k, v in first.items()})[0])
    torch.cuda.empty_cache()
    want = _attention_layers(cfg) * FAMILY_STEPS
    if shape is not None and shape != (TRAIN_B, TRAIN_S, TRAIN_S,
                                       cfg.n_heads, cfg.n_kv_heads,
                                       _attn_head_dim(cfg), True, 0):
        raise AssertionError(f"FAMILY_FULL's shape for {arch} is not its "
                             f"training shape")
    tt = tr["timings"]
    print(f"{arch} training B={TRAIN_B} S={TRAIN_S} {FAMILY_STEPS} SGD "
          f"steps fp32, remat {remat}: {tt['ms_per_step']} ms per step after"
          f" the first ({tt['first_step_ms']} ms), {tt['tokens_per_s']} "
          f"tokens/s, peak memory {peak:.3f} GiB; losses {tr['losses']}, "
          f"the first batch's after training {held}; launches K3 forward "
          f"{n_fwd}, backward {n_bwd}")
    losses = tr["losses"]
    if not (n_fwd == want * (2 if remat else 1)
            and k3.position_launches == 0
            and _bwd_counts_ok(n_bwd, _bwd_kernels(shape, dev) if shape
                               else (), want)
            and all(np.isfinite(losses + [held])) and losses[-1] < losses[0]
            and held < losses[0]):
        raise AssertionError(f"{arch} training: K3 {n_fwd}/{n_bwd} "
                             f"(expected {want} a kernel, the forward twice "
                             f"under remat), losses {losses}, "
                             f"the first batch's after training {held}")
    return {"timings": tt, "peak_gib": peak, "losses": losses,
            "first_batch_after": held, "remat": remat, "k3_forward": n_fwd,
            "k3_backward": n_bwd}


def _tree_err(a, b) -> float:
    """Max |a − b| over two trees of one structure."""
    from torch.utils._pytree import tree_flatten
    return max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))


def _bwd_kernels(shape, dev, dtype=torch.float32) -> tuple:
    """The backward kernels that ``backward_plan`` launches at ``shape`` in
    ``dtype`` on this card, in order."""
    from repro_torch.kernels import flash_attention as k3
    return k3.backward_plan(*shape, k3._sm_count(dev), dtype)["kernels"]


def _bwd_counts_ok(n_bwd, kernels, want) -> bool:
    """Each kernel of ``kernels`` launched ``want`` times, the others not."""
    return all(n == (want if name in kernels else 0)
               for name, n in n_bwd.items())


def run_train_main_path(dev) -> dict:
    """smollm-135m at full width through ``single_client``: B 8 x S 256,
    ``TRAIN_STEPS`` SGD steps at lr 3e-3, fp32. K3's forward and each of
    its backward kernels at this shape must launch once per layer per
    step, the loss must fall and stay finite. Returns the timings, losses,
    peak memory and launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import train
    cfg = get_config("smollm-135m")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k3.reset_counts()
    res = train.single_client(cfg, steps=TRAIN_STEPS, batch=TRAIN_B,
                              seq=TRAIN_S, lr=TRAIN_LR, device=dev)
    torch.cuda.synchronize()
    n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * TRAIN_STEPS
    losses = res["losses"]
    t = res["timings"]
    print(f"smollm-135m training B={TRAIN_B} S={TRAIN_S} {TRAIN_STEPS} SGD "
          f"steps fp32: {t['ms_per_step']} ms per step after the first "
          f"({t['first_step_ms']} ms), {t['tokens_per_s']} tokens/s, peak "
          f"memory {peak / 2**30:.3f} GiB; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches K3 forward {n_fwd}, backward "
          f"{n_bwd}")
    if n_fwd != want or not _bwd_counts_ok(n_bwd, _bwd_kernels(BWD_MAIN, dev),
                                           want):
        raise AssertionError(f"K3 launched {n_fwd} forward and {n_bwd} "
                             f"backward in {TRAIN_STEPS} steps, expected "
                             f"{want} each")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise AssertionError(f"the training loss did not fall: {losses}")
    return {"timings": t, "losses": losses, "peak_bytes": peak,
            "k3_forward": n_fwd, "k3_backward": n_bwd}


def run_fed_main_path(dev) -> dict:
    """Federated pFedWN over ``FED_C`` full-width smollm-135m clients
    (``examples/torch_federated_lm.py``'s shape, its 5 rounds cut to
    ``FED_ROUNDS``). K2 must launch once per param leaf a round (12), π*
    must lie on the simplex. Returns the round times, history and
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import weighted_agg as k2
    from repro_torch.launch import train
    from torch.utils._pytree import tree_flatten
    cfg = get_config("smollm-135m")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k3.reset_counts()
    k2.launches = 0
    hist = train.federated(cfg, clients=FED_C, rounds=FED_ROUNDS,
                           local_steps=FED_LOCAL, batch=FED_B, seq=FED_S,
                           lr=TRAIN_LR, device=dev)
    torch.cuda.synchronize()
    n2, n_fwd, n_bwd = k2.launches, k3.launches, dict(k3.backward_launches)
    peak = torch.cuda.max_memory_allocated()
    leaves = len(tree_flatten(hist["params"])[0])
    steps = FED_ROUNDS * FED_C * FED_LOCAL
    print(f"smollm-135m federated C={FED_C} B={FED_B} S={FED_S} "
          f"{FED_LOCAL} local steps, {FED_ROUNDS} rounds: ms per round "
          f"{hist['round_ms']}, peak memory {peak / 2**30:.3f} GiB; target "
          f"loss {hist['target_loss']}; pi* {[p.tolist() for p in hist['pi']]}"
          f"; links {[l.astype(int).tolist() for l in hist['links']]}; "
          f"launches K2 {n2} ({leaves} leaves), K3 forward {n_fwd}, "
          f"backward {n_bwd}")
    simplex = all(abs(float(p.sum()) - 1) < 1e-5 and (p >= 0).all()
                  for p in hist["pi"])
    want_fwd = FED_ROUNDS * cfg.n_layers * (FED_C * FED_LOCAL + FED_C)
    if not (n2 == leaves * FED_ROUNDS == 12 * FED_ROUNDS and simplex
            and n_fwd == want_fwd
            and _bwd_counts_ok(n_bwd, _bwd_kernels(BWD_FED, dev),
                               cfg.n_layers * steps)
            and all(np.isfinite(hist["target_loss"]))):
        raise AssertionError(f"federated LM: K2 {n2}, K3 {n_fwd}/{n_bwd}, "
                             f"pi {hist['pi']}")
    return {"round_ms": hist["round_ms"], "target_loss": hist["target_loss"],
            "peak_bytes": peak, "k2": n2, "k3_forward": n_fwd,
            "k3_backward": n_bwd}


def _teacher_forced(cfg, params, prompts, tokens, window, stub=None):
    """``serve``'s logits (gen, B, V) for ``prompts`` (after ``stub``,
    when given) when its decode is fed ``tokens`` (B, gen) instead of its
    own argmax: the same prefill into the same cache (n_stub + P + gen
    positions), then a decode step a token."""
    from repro_torch.launch.serve import prefill_to_cache
    from repro_torch.models.model import decode
    gen = tokens.shape[1]
    start = prompts.shape[1] + (stub.shape[1] if stub is not None else 0)
    with torch.no_grad():
        logits, cache = prefill_to_cache(params, cfg, prompts, start + gen,
                                         window=window, stub_embeds=stub)
        out = [logits]
        for i in range(gen - 1):
            logits, cache = decode(params, cfg, tokens[:, i:i + 1], cache,
                                   start + i, window=window)
            out.append(logits)
    return torch.stack(out)


# what bf16_step_against_cpu compares, each (gap, gate)
BF16_STEP_GAPS = ("|dloss|", "max|dparams|", "grads", "update")


def _rel_err(got, want) -> float:
    """||got − want|| / ||want|| over two lists of tensors, in float64."""
    num = sum(float(((a.cpu().double() - b.cpu().double()) ** 2).sum())
              for a, b in zip(got, want))
    den = sum(float((b.cpu().double() ** 2).sum()) for b in want)
    return (num / max(den, 1e-300)) ** 0.5


def bf16_step_against_cpu(cfg, p32, batch, dev) -> dict:
    """One bf16 ``make_train_step`` (lr ``TRAIN_LR``, remat) of ``cfg`` on
    the card (K3's bf16 forward and backward) against the CPU's (plain
    versions), from ``p32`` rounded to bf16 and ``batch`` (CPU tensors).
    Returns, under each name of ``BF16_STEP_GAPS``, (gap, gate): the loss
    and the params, |d| within max(2e-2, g), g the CPU's own gap between
    its bf16 step and its step from ``p32`` (the card-vs-CPU gate of
    ``tests/test_torch_bf16.py``); as a step moves most bf16 params by
    less than half an ulp, these cannot see a wrong gradient, and two
    more gaps can: "grads", ``value_and_grad``'s bf16 gradients, the
    largest leaf's relative-norm gap, within max(2e-2, 2g), g the CPU's
    largest leaf gap between its bf16 and fp32 gradients (two bf16
    computations of one gradient, each about g from its fp32 value); and
    "update", Δ = new − old in relative norm, within max(2e-2, 2g), g the
    gap between the CPU's Δ and the Δ its rule gives from the fp32
    gradients rounded to bf16 (a sign-flipped gradient puts Δ 2 away).
    Also the card step's K3 launches, "k3_forward" and "k3_backward"."""
    from torch.utils._pytree import tree_flatten, tree_map
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.steps import effective_window, make_train_step
    from repro_torch.launch.train import _sgd_in_param_dtype_, value_and_grad
    p16 = tree_map(lambda t: t.bfloat16(), p32)
    old = [t.float() for t in tree_flatten(p16)[0]]
    B, S = batch["tokens"].shape
    shape = ShapeConfig("card_vs_cpu", seq_len=S, global_batch=B,
                        mode="train")
    train = TrainConfig(lr=TRAIN_LR)
    step = make_train_step(cfg, train, shape)
    window = effective_window(cfg, shape)

    def grads(params, b):
        return tree_flatten(value_and_grad(params, cfg, b, window=window,
                                           remat=train.remat)[2])[0]

    on_card = {k: v.to(dev) for k, v in batch.items()}
    card = _tree_to(p16, dev)
    g16, g32, gcard = grads(p16, batch), grads(p32, batch), grads(card,
                                                                  on_card)
    ref, rm = step(tree_map(torch.clone, p16), batch)
    ref32, rm32 = step(tree_map(torch.clone, p32), batch)
    alt = [t.clone() for t in tree_flatten(p16)[0]]
    _sgd_in_param_dtype_(alt, g32, train.lr)
    k3.reset_counts()
    got, gm = step(card, on_card)
    torch.cuda.synchronize()
    n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
    if (k3.bf16_launches, k3.bf16_backward_launches) != (n_fwd, n_bwd):
        raise AssertionError(f"a bf16 step launched fp32 kernels: "
                             f"{k3.bf16_launches}/{n_fwd}, "
                             f"{k3.bf16_backward_launches}/{n_bwd}")

    def delta(leaves):
        return [t.cpu().float() - o for t, o in zip(leaves, old)]

    def leaf_gap(xs, ys):
        return max(_rel_err([a], [b]) for a, b in zip(xs, ys))

    cpu_delta = delta(tree_flatten(ref)[0])
    return {
        "|dloss|": (abs(float(gm["loss"]) - float(rm["loss"])),
                    max(BWD_BF16_TOL, abs(float(rm["loss"])
                                          - float(rm32["loss"])))),
        "max|dparams|": (_tree_err(got, ref),
                         max(BWD_BF16_TOL, _tree_err(ref, ref32))),
        "grads": (leaf_gap(gcard, g16),
                  max(BWD_BF16_TOL, 2 * leaf_gap(g16, g32))),
        "update": (_rel_err(delta(tree_flatten(got)[0]), cpu_delta),
                   max(BWD_BF16_TOL, 2 * _rel_err(delta(alt), cpu_delta))),
        "k3_forward": n_fwd, "k3_backward": n_bwd}


def check_dense_bf16_against_cpu(dev) -> dict:
    """Reduced chatglm3-6b and starcoder2-15b in bf16 on the card (K3's
    bf16 forward, and its bf16 backward in the step) against the CPU
    (plain versions), the same bf16 weights (the seed-0 fp32 draws rounded,
    which ``init_params(dtype=bf16)`` gives), prompts and batch. The gate
    is ``tests/test_torch_bf16.py``'s, max(2e-2, g), with g the port's own
    gap on the CPU between this bf16 run and its fp32 run on the same
    draws (the tests take the reference's; this machine has no JAX).
    Serving, without a window and with ``DENSE_WINDOW``, which the
    37-token prompts wrap: the card's ``serve``, and the CPU fed the
    card's tokens; logits within the gate, and the card's greedy tokens
    equal to the CPU's argmax wherever the CPU's top-2 logit gap exceeds
    twice it (the count printed). Then one ``make_train_step`` (lr 3e-3,
    remat, B 2 × S 64): loss, params, gradients and update within the
    gates of :func:`bf16_step_against_cpu`; K3's forward twice a layer
    (remat) and each backward kernel of the plan once. Returns the card's
    K3 launches by (arch, run)."""
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.data import token_batch_stream
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import init_params
    launches = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch).reduced()
        p32 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        p16 = tree_map(lambda t: t.bfloat16(), p32)
        card = _tree_to(p16, dev)
        prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
        for window in (0, DENSE_WINDOW):
            k3.reset_counts()
            got = serve(cfg, card, prompts.to(dev), 5, window=window,
                        device=dev)
            n3 = launches[(arch, f"serve window {window}")] = k3.launches
            if k3.bf16_launches != n3:
                raise AssertionError(f"reduced {arch}'s bf16 serve launched "
                                     f"the fp32 forward")
            tokens = got.tokens.cpu()
            ref = _teacher_forced(cfg, p16, prompts, tokens, window)
            ref32 = _teacher_forced(cfg, p32, prompts, tokens, window)
            gate = max(BWD_BF16_TOL, float((ref - ref32).abs().max()))
            d = float((got.logits.cpu() - ref).abs().max())
            top2 = torch.topk(ref, 2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > 2 * gate   # (gen, B)
            same = torch.equal(tokens.T[clear], ref.argmax(-1)[clear])
            print(f"serve reduced {arch} bf16 window={window}, card vs CPU: "
                  f"max|dlogits|={d:.4g} (gate {gate:.4g}: max(2e-2, the "
                  f"CPU's bf16 vs fp32 {float((ref - ref32).abs().max()):.4g}"
                  f")), greedy tokens equal at {int(clear.sum())} of "
                  f"{clear.numel()} with a clear top-2 gap: {same}; K3 "
                  f"{n3}")
            if not (d <= gate and same and n3 == cfg.n_layers):
                raise AssertionError(f"reduced {arch}'s bf16 serve on the "
                                     f"card disagrees with the CPU's "
                                     f"(window {window})")
        raw = next(token_batch_stream(0, batch=2, seq_len=64,
                                      vocab=cfg.vocab))
        r = bf16_step_against_cpu(
            cfg, p32, {k: torch.from_numpy(v) for k, v in raw.items()}, dev)
        n_fwd, n_bwd = r["k3_forward"], r["k3_backward"]
        launches[(arch, "make_train_step")] = (n_fwd, n_bwd)
        kernels = _bwd_kernels((2, 64, 64, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, True,
                                cfg.sliding_window), dev, torch.bfloat16)
        print(f"make_train_step reduced {arch} bf16, card vs CPU: "
              + ", ".join(f"{name} {r[name][0]:.4g} (gate {r[name][1]:.4g})"
                          for name in BF16_STEP_GAPS)
              + f"; K3 forward {n_fwd}, backward {n_bwd}")
        if not (all(r[name][0] <= r[name][1] for name in BF16_STEP_GAPS)
                and n_fwd == 2 * cfg.n_layers
                and _bwd_counts_ok(n_bwd, kernels, cfg.n_layers)):
            raise AssertionError(f"reduced {arch}'s bf16 train step on the "
                                 f"card disagrees with the CPU's")
    return launches


def _family_batch(cfg, B, S, dev, seed=0) -> dict:
    """A training batch of ``cfg`` on ``dev``: ``token_batch_stream``'s
    tokens and labels (B, S); with a stub frontend, N(0, 0.02²) stub
    embeddings in bf16 (phase 7e's, not C6's zeros) and, under M-RoPE, the
    prompt's positions (``_mrope_layout``), explicit."""
    from repro_torch.data import token_batch_stream
    raw = next(token_batch_stream(seed, batch=B, seq_len=S,
                                  vocab=cfg.vocab))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    if cfg.n_stub_tokens:
        g = torch.Generator().manual_seed(seed + 1)
        batch["stub_embeds"] = (0.02 * torch.randn(
            (B, cfg.n_stub_tokens, cfg.d_model), generator=g)).to(
            dev, torch.bfloat16)
    if cfg.rope == "mrope":
        batch["positions"] = _mrope_layout(cfg.n_stub_tokens, S, dev)
    return batch


def check_families_bf16_against_cpu(dev) -> dict:
    """``BF16_FAMILY_ARCHS`` at reduced() in bf16 on the card (K3's bf16
    forward, and its bf16 backward in the step, at MLA's Dh 48, zamba2's
    and the dense layers' 64, qwen2-vl's 128 with M-RoPE positions)
    against the CPU (plain versions), the same bf16 weights (the seed-0
    fp32 draws rounded), prompts, stub prefix and batch. Serving: a
    37-token prefill after the stub prefix and 4 teacher-forced decode
    steps (``_teacher_forced``), logits within max(2e-2, g), g the CPU's
    own gap between this
    bf16 run and its fp32 run on the same draws (``tests/
    test_torch_bf16_families.py`` takes the reference's); every forward
    launch bf16. Then one ``make_train_step`` (lr 3e-3, remat, B 2 x S 64;
    qwen2-vl with its stub and M-RoPE positions): loss, params, gradients
    and update within :func:`bf16_step_against_cpu`'s gates, every launch
    bf16, K3's forward twice an attention layer (remat) and each backward
    kernel once. Returns the card's K3 launches by (arch, run)."""
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import init_params
    launches = {}
    for arch in BF16_FAMILY_ARCHS:
        cfg = get_config(arch).reduced()
        p32 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        p16 = tree_map(lambda t: t.bfloat16(), p32)
        card = _tree_to(p16, dev)
        prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
        feed = make_prompts(cfg, 2, 5, seed=2, device="cpu")
        stub = (_family_batch(cfg, 2, 8, "cpu")["stub_embeds"]
                if cfg.n_stub_tokens else None)
        k3.reset_counts()
        got = _teacher_forced(cfg, card, prompts.to(dev), feed.to(dev), 0,
                              None if stub is None else stub.to(dev)).cpu()
        n3 = launches[(arch, "serve")] = k3.launches
        ref = _teacher_forced(cfg, p16, prompts, feed, 0, stub)
        ref32 = _teacher_forced(cfg, p32, prompts, feed, 0,
                                None if stub is None else stub.float())
        gate = max(BWD_BF16_TOL, float((ref - ref32).abs().max()))
        d = float((got - ref).abs().max())
        print(f"serve reduced {arch} bf16, card vs CPU: max|dlogits|="
              f"{d:.4g} (gate {gate:.4g}: max(2e-2, the CPU's bf16 vs fp32 "
              f"{float((ref - ref32).abs().max()):.4g})); K3 {n3}")
        if not (d <= gate and k3.bf16_launches == n3
                and n3 == _attention_layers(cfg) - (1 if cfg.mtp_depth
                                                    else 0)):
            raise AssertionError(f"reduced {arch}'s bf16 serving on the card "
                                 f"disagrees with the CPU's")
        batch = _family_batch(cfg, 2, 64, "cpu")
        r = bf16_step_against_cpu(cfg, p32, batch, dev)
        n_fwd, n_bwd = r["k3_forward"], r["k3_backward"]
        launches[(arch, "make_train_step")] = (n_fwd, n_bwd)
        n_attn = _attention_layers(cfg)
        s_eff = 64 + cfg.n_stub_tokens
        kernels = (_bwd_kernels((2, s_eff, s_eff, cfg.n_heads,
                                 cfg.n_heads if cfg.mla else cfg.n_kv_heads,
                                 _attn_head_dim(cfg), True,
                                 cfg.sliding_window), dev, torch.bfloat16)
                   if n_attn else ())
        print(f"make_train_step reduced {arch} bf16, card vs CPU: "
              + ", ".join(f"{name} {r[name][0]:.4g} (gate {r[name][1]:.4g})"
                          for name in BF16_STEP_GAPS)
              + f"; K3 forward {n_fwd}, backward {n_bwd}")
        if not (all(r[name][0] <= r[name][1] for name in BF16_STEP_GAPS)
                and n_fwd == 2 * n_attn
                and _bwd_counts_ok(n_bwd, kernels, n_attn)):
            raise AssertionError(f"reduced {arch}'s bf16 train step on the "
                                 f"card disagrees with the CPU's")
    return launches


def run_family_bf16_main_path(dev, arch) -> dict:
    """``arch`` in bf16 at full width and depth (seed-0 weights): ``serve``
    of SERVE_B x SERVE_PROMPT tokens (after the zero stub prefix) and
    SERVE_GEN greedy steps, logits finite, K3's bf16 forward once an
    attention layer in the prefill; then ``BF16_FAMILY_STEPS`` steps of
    ``make_train_step`` at TRAIN_B x TRAIN_S (remat for ``FAMILY_REMAT``;
    qwen2-vl under its M-RoPE positions), losses finite and params
    changed, every K3 launch bf16, its forward once an attention layer a
    step (twice under remat), each backward kernel of the plan once
    (``bf16_backward_launches``; with positions for qwen2-vl, counted in
    ``position_launches``). The weights are freed on return. Returns the
    timings, losses, peaks and launches."""
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_params
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    gib = _tree_gib(params)
    prompts = make_prompts(cfg, SERVE_B, SERVE_PROMPT, seed=0, device=dev)
    n_attn = _attention_layers(cfg) - (1 if cfg.mtp_depth else 0)
    k3.reset_counts()
    res = serve(cfg, params, prompts, SERVE_GEN, device=dev)
    torch.cuda.synchronize()
    n_serve = k3.launches
    serve_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    finite = bool(torch.isfinite(res.logits).all())
    timings = res.timings
    del res
    remat = arch in FAMILY_REMAT
    shape = ShapeConfig("bf16_family", seq_len=TRAIN_S, global_batch=TRAIN_B,
                        mode="train")
    step = make_train_step(cfg, TrainConfig(lr=TRAIN_LR, remat=remat),
                           shape)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    from torch.utils._pytree import tree_leaves
    big = max(tree_leaves(params["layers"]), key=lambda t: t.numel())
    stride = max(1, big.numel() // 4096)
    before = big.reshape(-1)[::stride].clone()
    k3.reset_counts()
    losses, ms = [], []
    for i in range(BF16_FAMILY_STEPS):
        batch = _family_batch(cfg, TRAIN_B, TRAIN_S, dev, seed=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, metrics = step(params, batch)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
    n_bf16_bwd = dict(k3.bf16_backward_launches)
    n_pos = k3.position_launches
    routed = k3.bf16_launches == n_fwd and n_bf16_bwd == n_bwd
    train_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    changed = not torch.equal(before, big.reshape(-1)[::stride])
    del params, metrics, batch, step, big
    torch.cuda.empty_cache()
    want = n_attn * BF16_FAMILY_STEPS
    s_eff = TRAIN_S + cfg.n_stub_tokens
    kernels = (_bwd_kernels((TRAIN_B, s_eff, s_eff, cfg.n_heads,
                             cfg.n_heads if cfg.mla else cfg.n_kv_heads,
                             _attn_head_dim(cfg), True, cfg.sliding_window),
                            dev, torch.bfloat16) if n_attn else ())
    mrope = cfg.rope == "mrope"
    print(f"{arch} bf16 ({gib:.2f} GiB of weights): serve {SERVE_B} x "
          f"{SERVE_PROMPT} + {SERVE_GEN}: prefill "
          f"{timings['prefill_ms']:.2f} ms, decode "
          f"{timings['decode_ms_per_step']:.2f} ms a step, finite {finite}, "
          f"K3 {n_serve}, peak {serve_peak:.3f} GiB; {BF16_FAMILY_STEPS} "
          f"make_train_step "
          f"B={TRAIN_B} S={TRAIN_S} remat {remat}: ms {ms}, losses {losses}, "
          f"params changed {changed}, peak {train_peak:.3f} GiB; K3 forward "
          f"{n_fwd} (with positions {n_pos}), backward {n_bwd}, bf16 "
          f"backward {n_bf16_bwd}")
    if not (finite and n_serve == n_attn and all(np.isfinite(losses))
            and changed and routed
            and n_fwd == want * (2 if remat else 1)
            and n_pos == (n_fwd if mrope else 0)
            and _bwd_counts_ok(n_bwd, kernels, want)):
        raise AssertionError(f"{arch}'s bf16 main paths: finite {finite}, "
                             f"K3 {n_serve}, {n_fwd}, {n_bwd}, positions "
                             f"{n_pos}, losses {losses}")
    return {"weights_gib": gib, "serve": timings, "train_ms": ms,
            "losses": losses, "serve_peak_gib": serve_peak,
            "train_peak_gib": train_peak, "k3_serve": n_serve,
            "k3_forward": n_fwd, "k3_backward": n_bwd,
            "k3_bf16_backward": n_bf16_bwd, "k3_positions": n_pos}


def _ds_cfg(full=False):
    """deepseek-v3-671b at its published widths: with ``full`` its
    n_layers cut to ``DS_LAYERS``, else reduced() with the published MLA
    head dims restored (K3 at Dh 192)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b")
    if full:
        return dataclasses.replace(cfg, n_layers=DS_LAYERS)
    small = cfg.reduced()
    return dataclasses.replace(small, mla=dataclasses.replace(
        small.mla, **{k: getattr(cfg.mla, k) for k in DS_MLA_DIMS}))


def _position_train_cfg(arch, dh):
    """``arch`` at reduced() with K3 at head dim ``dh``: minicpm3-4b's and
    deepseek-v3's published MLA dims (96, 192), zamba2-7b's published head
    dim (112), or reduced()'s own (48)."""
    import dataclasses
    from repro_torch.configs import get_config
    if arch == "deepseek-v3-671b" and dh == 192:
        return _ds_cfg()
    full, cfg = get_config(arch), get_config(arch).reduced()
    if cfg.mla and dh != _attn_head_dim(cfg):
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, **{k: getattr(full.mla, k) for k in DS_MLA_DIMS}))
    elif not cfg.mla and dh != cfg.resolved_head_dim:
        cfg = dataclasses.replace(cfg, head_dim=full.resolved_head_dim)
    if _attn_head_dim(cfg) != dh:
        raise AssertionError(f"reduced {arch} does not attend at Dh {dh}")
    return cfg


def _grad_excess(got, want, tol) -> float:
    """max(|got − want| − tol·|want|) over two trees (CPU floats)."""
    from torch.utils._pytree import tree_flatten
    return max(float(((a.cpu().float() - b.float()).abs()
                      - tol * b.float().abs()).max())
               for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]))


def check_deepseek_full_heads_against_cpu(dev) -> dict:
    """Phase 7k's card-vs-CPU half. Reduced deepseek-v3 with the published
    MLA head dims (``_ds_cfg``: K3 at Dh 192), the same seed-0 weights,
    prompts and batches on the card (the kernels) and the CPU (plain
    versions): fp32 and bf16 serving (a 37-token prefill, 4 teacher-forced
    decode steps; fp32 logits within ``SERVE_TOL``, bf16 within max(2e-2,
    g), g the CPU's own bf16-vs-fp32 gap), K3 once a layer a prefill in
    the prompt's dtype; one bf16 ``make_train_step`` without and with
    explicit positions under :func:`bf16_step_against_cpu`'s gates; fp32
    ``value_and_grad`` by index, the loss and every gradient within
    ``TRAIN_TOL`` (atol and rtol), K3's fp32 forward and each fp32
    backward kernel of the plan once an attention layer. Then
    the explicit-position training of ``POS_TRAIN_ARCHS`` (positions
    ``POS_TRAIN_OFFSET``.., B 2 x S 64): in fp32 (where the fp32 backward
    takes the head dim) the loss and every gradient of ``value_and_grad``
    within ``TRAIN_TOL`` (atol and rtol), and in bf16 one step under the
    bf16 gates; every K3 launch a position launch, the backward kernels of
    the plan once an attention layer. Returns the card's launches: K3
    forward by (run, dtype), and the position backward's by (Dh, dtype)
    with the steps that made them."""
    from torch.utils._pytree import tree_map
    from repro_torch.data import token_batch_stream
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models.model import init_params
    out = {}
    cfg = _ds_cfg()
    p32 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p16 = tree_map(lambda t: t.bfloat16(), p32)
    prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
    feed = make_prompts(cfg, 2, 5, seed=2, device="cpu")
    ref32 = _teacher_forced(cfg, p32, prompts, feed, 0)
    for dtype, params in ((torch.float32, p32), (torch.bfloat16, p16)):
        k3.reset_counts()
        got = _teacher_forced(cfg, _tree_to(params, dev), prompts.to(dev),
                              feed.to(dev), 0).cpu()
        n3, n16 = k3.launches, k3.bf16_launches
        ref = (ref32 if dtype == torch.float32 else
               _teacher_forced(cfg, params, prompts, feed, 0))
        d = float((got - ref).abs().max())
        if dtype == torch.float32:
            gate = SERVE_TOL
            ok = float(((got - ref).abs() - SERVE_TOL * ref.abs()).max()) \
                <= SERVE_TOL
        else:
            gate = max(BWD_BF16_TOL, float((ref - ref32).abs().max()))
            ok = d <= gate
        routed = n16 == (n3 if dtype == torch.bfloat16 else 0)
        out[("serve", str(dtype)[6:])] = n3
        print(f"serve reduced deepseek-v3 at Dh 192 {str(dtype)[6:]}, card "
              f"vs CPU: max|dlogits|={d:.4g} (gate {gate:.4g}); K3 {n3} "
              f"(bf16 {n16})")
        if not (ok and routed and n3 == cfg.n_layers):
            raise AssertionError(f"reduced deepseek-v3 at Dh 192 "
                                 f"({dtype}) serving on the card disagrees "
                                 f"with the CPU's")
    n_attn = _attention_layers(cfg)
    raw = next(token_batch_stream(0, batch=2, seq_len=64, vocab=cfg.vocab))
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    positions = torch.arange(POS_TRAIN_OFFSET, POS_TRAIN_OFFSET + 64,
                             dtype=torch.int32)
    for with_pos in (False, True):
        b = dict(batch, positions=positions) if with_pos else batch
        r = bf16_step_against_cpu(cfg, p32, b, dev)      # counts the step
        n_fwd, n_bwd = r["k3_forward"], r["k3_backward"]
        kernels = _bwd_kernels((2, 64, 64, cfg.n_heads, cfg.n_heads, 192,
                                True, 0), dev, torch.bfloat16)
        out[("make_train_step", "bfloat16", with_pos)] = (n_fwd, n_bwd)
        print(f"make_train_step reduced deepseek-v3 at Dh 192 bf16"
              f"{' with positions' if with_pos else ''}, card vs CPU: "
              + ", ".join(f"{name} {r[name][0]:.4g} (gate {r[name][1]:.4g})"
                          for name in BF16_STEP_GAPS)
              + f"; K3 forward {n_fwd}, backward {n_bwd}")
        if not (all(r[name][0] <= r[name][1] for name in BF16_STEP_GAPS)
                and n_fwd == 2 * n_attn
                and k3.position_launches == (n_fwd if with_pos else 0)
                and _bwd_counts_ok(n_bwd, kernels, n_attn)):
            raise AssertionError("reduced deepseek-v3's bf16 train step at "
                                 "Dh 192 on the card disagrees with the "
                                 "CPU's")
    # fp32 value_and_grad by index at Dh 192: K3's fp32 forward and the
    # fp32 backward's own Dh-192 kernels, once an attention layer
    loss, _, grads = value_and_grad(p32, cfg, batch)
    k3.reset_counts()
    gloss, _, ggrads = value_and_grad(
        _tree_to(p32, dev), cfg, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
    n16 = k3.bf16_launches + sum(k3.bf16_backward_launches.values())
    excess = max(_grad_excess([gloss], [loss], TRAIN_TOL),
                 _grad_excess(ggrads, grads, TRAIN_TOL))
    out[("value_and_grad", "float32")] = (n_fwd, n_bwd)
    print(f"value_and_grad reduced deepseek-v3 at Dh 192 fp32, card vs "
          f"CPU: loss {float(gloss):.6g} vs {float(loss):.6g}, worst excess "
          f"over {TRAIN_TOL:g}·|CPU| {excess:.3g} (tol {TRAIN_TOL:g}); K3 "
          f"forward {n_fwd}, backward {n_bwd}, bf16 launches {n16}")
    if not (excess <= TRAIN_TOL and n_fwd == n_attn and n16 == 0
            and k3.position_launches == 0
            and _bwd_counts_ok(n_bwd, _bwd_kernels(
                (2, 64, 64, cfg.n_heads, cfg.n_heads, 192, True, 0), dev),
                n_attn)):
        raise AssertionError("reduced deepseek-v3's fp32 gradients at Dh "
                             "192 on the card disagree with the CPU's")
    del grads, ggrads
    for arch, dh in POS_TRAIN_ARCHS:
        cfg = _position_train_cfg(arch, dh)
        n_attn = _attention_layers(cfg)
        p32 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        raw = next(token_batch_stream(1, batch=2, seq_len=64,
                                      vocab=cfg.vocab))
        b = {k: torch.from_numpy(v) for k, v in raw.items()}
        b["positions"] = positions
        shape = (2, 64, 64, cfg.n_heads,
                 cfg.n_heads if cfg.mla else cfg.n_kv_heads, dh, True, 0)
        if dh in k3.BWD_HEAD_DIMS:
            loss, _, grads = value_and_grad(p32, cfg, b)
            k3.reset_counts()
            gloss, _, ggrads = value_and_grad(
                _tree_to(p32, dev), cfg, {k: v.to(dev) for k, v in
                                          b.items()})
            torch.cuda.synchronize()
            n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
            excess = max(_grad_excess([gloss], [loss], TRAIN_TOL),
                         _grad_excess(ggrads, grads, TRAIN_TOL))
            out[("positions", dh, "float32")] = (n_bwd, 1)
            print(f"value_and_grad reduced {arch} at Dh {dh} fp32 with "
                  f"positions {POS_TRAIN_OFFSET}.., card vs CPU: loss "
                  f"{float(gloss):.6g} vs {float(loss):.6g}, worst excess "
                  f"over {TRAIN_TOL:g}·|CPU| {excess:.3g} (tol "
                  f"{TRAIN_TOL:g}); K3 forward {n_fwd} (positions "
                  f"{k3.position_launches}), backward {n_bwd}")
            if not (excess <= TRAIN_TOL and n_fwd == n_attn
                    and k3.position_launches == n_fwd
                    and _bwd_counts_ok(n_bwd, _bwd_kernels(shape, dev),
                                       n_attn)):
                raise AssertionError(f"reduced {arch}'s fp32 gradients "
                                     f"with positions at Dh {dh} on the "
                                     f"card disagree with the CPU's")
        if arch == "deepseek-v3-671b" and dh == 192:
            out[("positions", dh, "bfloat16")] = (
                out[("make_train_step", "bfloat16", True)][1], 1)
            continue
        r = bf16_step_against_cpu(cfg, p32, b, dev)      # counts the step
        n_fwd, n_bwd = r["k3_forward"], r["k3_backward"]
        out[("positions", dh, "bfloat16")] = (n_bwd, 1)
        print(f"make_train_step reduced {arch} at Dh {dh} bf16 with "
              f"positions, card vs CPU: "
              + ", ".join(f"{name} {r[name][0]:.4g} (gate {r[name][1]:.4g})"
                          for name in BF16_STEP_GAPS)
              + f"; K3 forward {n_fwd}, backward {n_bwd}")
        if not (all(r[name][0] <= r[name][1] for name in BF16_STEP_GAPS)
                and n_fwd == 2 * n_attn
                and k3.position_launches == n_fwd
                and _bwd_counts_ok(n_bwd, _bwd_kernels(
                    shape, dev, torch.bfloat16), n_attn)):
            raise AssertionError(f"reduced {arch}'s bf16 train step with "
                                 f"positions at Dh {dh} on the card "
                                 f"disagrees with the CPU's")
    return out


def _ds_serve(dev, cfg, params, B, label) -> dict:
    """``serve`` of ``B`` x SERVE_PROMPT + SERVE_GEN on the full-width
    deepseek-v3 ``cfg`` (params in their dtype): logits finite, K3 once a
    layer in the prefill, every launch of the params' dtype; then one more
    prefill (untimed) with the routing recorded for the MoE layer's
    dropped share. Returns ms, peak, launches and drops."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models import moe
    from repro_torch.models.model import prefill
    prompts = make_prompts(cfg, B, SERVE_PROMPT, seed=0, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    k3.reset_counts()
    res = serve(cfg, params, prompts, SERVE_GEN, device=dev)
    torch.cuda.synchronize()
    n3, n16 = k3.launches, k3.bf16_launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    finite = bool(torch.isfinite(res.logits).all())
    t = res.timings
    del res
    with torch.no_grad(), _Routing() as routes:
        prefill(params, cfg, prompts)
    dropped, pairs, gap = routes.summary()
    bf16 = tree_leaves(params)[0].dtype == torch.bfloat16
    cap = moe.capacity(cfg.moe, B * SERVE_PROMPT)
    print(f"deepseek-v3 n_layers {cfg.n_layers} {label}: serve {B} x "
          f"{SERVE_PROMPT} + {SERVE_GEN}: prefill {t['prefill_ms']:.2f} ms, "
          f"decode {t['decode_ms_per_step']:.2f} ms a step, peak "
          f"{peak:.3f} GiB, finite {finite}; K3 {n3} (bf16 {n16}); MoE "
          f"capacity {cap} slots an expert, dropped {dropped} of {pairs} "
          f"pairs ({100 * dropped / pairs:.3f} %), smallest top-k gap "
          f"{gap:.3g}")
    if not (finite and n3 == cfg.n_layers and n16 == (n3 if bf16 else 0)):
        raise AssertionError(f"deepseek-v3's {label} serve: finite "
                             f"{finite}, K3 {n3} (bf16 {n16})")
    return {"serve": t, "peak_gib": peak, "k3": n3, "batch": B,
            "dropped": dropped, "pairs": pairs, "capacity": cap}


def _ds_train_steps(dev, cfg, params, group) -> tuple:
    """``DS_TRAIN_STEPS`` steps of ``make_train_step`` at TRAIN_B x TRAIN_S
    (no remat) on the full-width deepseek-v3 ``cfg``, K3's counts and the
    peak reset before them. Returns (params, the last batch, ms, losses,
    whether a sample of ``group``'s largest leaf changed)."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.steps import make_train_step
    shape = ShapeConfig("deepseek_full", seq_len=TRAIN_S,
                        global_batch=TRAIN_B, mode="train")
    step = make_train_step(cfg, TrainConfig(lr=TRAIN_LR, remat=False),
                           shape)
    big = max(tree_leaves(params[group]), key=lambda t: t.numel())
    stride = max(1, big.numel() // 4096)
    before = big.reshape(-1)[::stride].clone()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    k3.reset_counts()
    losses, ms = [], []
    for i in range(DS_TRAIN_STEPS):
        batch = _family_batch(cfg, TRAIN_B, TRAIN_S, dev, seed=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, metrics = step(params, batch)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return params, batch, ms, losses, not torch.equal(
        before, big.reshape(-1)[::stride])


def run_deepseek_full_main_path(dev) -> dict:
    """Phase 7k's main paths: deepseek-v3-671b at its published widths,
    n_layers cut to ``DS_LAYERS`` (``_ds_cfg(full=True)``), seed-0
    weights. bf16: ``_ds_serve``, then ``DS_TRAIN_STEPS`` steps of
    ``make_train_step`` at TRAIN_B x TRAIN_S (no remat), losses finite and
    params changed, K3's bf16 forward once an attention layer a step (the
    four layers and the MTP block), each bf16 backward kernel of the plan
    as often, and the dropped share of one more forward (no grad) on the
    last batch. The bf16 weights are freed; then fp32 (``init_params`` in
    fp32: the MoE group's one layer is stacked as a view, no second copy):
    ``_ds_serve`` again. Then :func:`run_deepseek_fp32_train`. Returns
    each run's numbers."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.models.model import init_params, loss_fn
    cfg = _ds_cfg(full=True)
    out = {}
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    out["weights_gib_bf16"] = _tree_gib(params)
    out["params"] = sum(t.numel() for t in tree_leaves(params))
    out["bf16"] = _ds_serve(dev, cfg, params, SERVE_B, "bf16")
    params, batch, ms, losses, changed = _ds_train_steps(dev, cfg, params,
                                                         "layers")
    n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
    n_bf16_bwd = dict(k3.bf16_backward_launches)
    routed = k3.bf16_launches == n_fwd and n_bf16_bwd == n_bwd
    train_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    with torch.no_grad(), _Routing() as routes:
        loss_fn(params, cfg, batch)
    dropped, pairs, _ = routes.summary()
    del params, batch
    torch.cuda.empty_cache()
    want = _attention_layers(cfg) * DS_TRAIN_STEPS
    kernels = _bwd_kernels(BWD_DS, dev, torch.bfloat16)
    print(f"deepseek-v3 n_layers {cfg.n_layers} bf16 ({out['params']} "
          f"params, {out['weights_gib_bf16']:.2f} GiB): {DS_TRAIN_STEPS} "
          f"make_train_step B={TRAIN_B} S={TRAIN_S} no remat: ms {ms}, "
          f"losses {losses}, params changed {changed}, peak "
          f"{train_peak:.3f} GiB; K3 forward {n_fwd}, backward {n_bwd}, "
          f"bf16 backward {n_bf16_bwd}; MoE dropped {dropped} of {pairs} "
          f"pairs ({100 * dropped / pairs:.3f} %) in a forward of the last "
          f"batch")
    if not (all(np.isfinite(losses)) and changed and routed
            and n_fwd == want and _bwd_counts_ok(n_bwd, kernels, want)
            and BWD_DS == (TRAIN_B, TRAIN_S, TRAIN_S, cfg.n_heads,
                           cfg.n_heads, _attn_head_dim(cfg), True, 0)):
        raise AssertionError(f"deepseek-v3's bf16 training: K3 {n_fwd}, "
                             f"{n_bwd}, routed {routed}, losses {losses}, "
                             f"changed {changed}")
    out["train"] = {"ms": ms, "losses": losses, "peak_gib": train_peak,
                    "k3_forward": n_fwd, "k3_backward": n_bwd,
                    "k3_bf16_backward": n_bf16_bwd, "dropped": dropped,
                    "pairs": pairs}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.float32)
    out["weights_gib_fp32"] = _tree_gib(params)
    out["init_peak_gib_fp32"] = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"deepseek-v3 n_layers {cfg.n_layers} fp32 init_params: "
          f"{out['weights_gib_fp32']:.2f} GiB of weights, peak "
          f"{out['init_peak_gib_fp32']:.2f} GiB")
    out["fp32"] = _ds_serve(dev, cfg, params, SERVE_B, "fp32")
    del params
    torch.cuda.empty_cache()
    out["train32"] = run_deepseek_fp32_train(dev)
    return out


def run_deepseek_fp32_train(dev) -> dict:
    """deepseek-v3-671b at its published widths in fp32, n_layers cut to
    ``DS_FP32_LAYERS`` (the dense prefix, so the MoE group is the empty
    ``(0, ...)`` stack, and the MTP block): ``DS_TRAIN_STEPS`` steps of
    ``make_train_step`` at TRAIN_B x TRAIN_S from seed-0 ``init_params`` in
    fp32, losses finite and params changed, K3's fp32 forward once an
    attention application a step (the 3 layers and the MTP block) and each
    fp32 backward kernel of the plan (its Dh-192 dK/dV and dQ) as often, no
    bf16 kernel. Returns ms, losses, peak and launches."""
    import dataclasses
    from torch.utils._pytree import tree_leaves
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(_ds_cfg(full=True), n_layers=DS_FP32_LAYERS)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.float32)
    n_params = sum(t.numel() for t in tree_leaves(params))
    gib = _tree_gib(params)
    empty = tree_leaves(params["layers"])[0].shape[0] == 0
    params, batch, ms, losses, changed = _ds_train_steps(dev, cfg, params,
                                                         "dense_layers")
    n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
    n16 = k3.bf16_launches + sum(k3.bf16_backward_launches.values())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del params, batch
    torch.cuda.empty_cache()
    want = _attention_layers(cfg) * DS_TRAIN_STEPS
    kernels = _bwd_kernels(BWD_DS, dev)
    print(f"deepseek-v3 n_layers {cfg.n_layers} fp32 ({n_params} params, "
          f"{gib:.2f} GiB, MoE group empty {empty}): {DS_TRAIN_STEPS} "
          f"make_train_step B={TRAIN_B} S={TRAIN_S} no remat: ms {ms}, "
          f"losses {losses}, params changed {changed}, peak {peak:.3f} GiB; "
          f"K3 forward {n_fwd}, backward {n_bwd}, bf16 launches {n16}")
    if not (all(np.isfinite(losses)) and changed and empty and n16 == 0
            and n_fwd == want and _bwd_counts_ok(n_bwd, kernels, want)
            and _attention_layers(cfg) == DS_FP32_LAYERS + 1):
        raise AssertionError(f"deepseek-v3's fp32 training: K3 {n_fwd}, "
                             f"{n_bwd}, bf16 {n16}, losses {losses}, "
                             f"changed {changed}, MoE group empty {empty}")
    return {"ms": ms, "losses": losses, "peak_gib": peak,
            "weights_gib": gib, "params": n_params, "k3_forward": n_fwd,
            "k3_backward": n_bwd}


def run_dryrun_sweep(dev, out_dir) -> dict:
    """Phase 7j: ``launch/dryrun.py``'s sweep of every registered arch x
    the four shapes on the meta device (``run_combo``, each combination
    once, in ``DRYRUN_WORKERS`` processes that see no card, the SSM
    configs' per-step scans first; records under ``out_dir``): 40 records
    ``status: ok``, deepseek-v3 meta only; then smollm-135m's train_4k
    with ``--run``: the step on the card (global_batch cut to 2, as phase
    7g), its ms and peak, and K3's and K2's FLOPs counted on the card
    equal to the meta device's count of the same cut, kernel by kernel.
    Returns the smollm-135m record's run and the sweep's seconds."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import SHAPES, get_config, list_archs
    from repro_torch.launch import dryrun
    combos = sorted(((a, n) for a in list_archs() for n in SHAPES),
                    key=lambda c: get_config(c[0]).ssm is None)
    t0 = time.perf_counter()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""       # the workers' view
    try:
        with ProcessPoolExecutor(
                DRYRUN_WORKERS,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            recs = list(pool.map(dryrun.run_combo, *zip(*combos),
                                 [out_dir] * len(combos)))
    finally:
        if visible is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES")
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = visible
    sweep_s = time.perf_counter() - t0
    bad = [(r["arch"], r["shape"], r.get("error")) for r in recs
           if r["status"] != "ok"]
    meta_only = [f"{r['arch']} x {r['shape']}" for r in recs
                 if r.get("meta_only")]
    print(f"dry run: {len(recs) - len(bad)} of {len(recs)} records ok in "
          f"{sweep_s:.1f} s ({DRYRUN_WORKERS} processes); meta only (past "
          f"80 GB at the cut batch): {meta_only}")
    if bad or not all(f"deepseek-v3-671b x {n}" in meta_only
                      for n in SHAPES):
        raise AssertionError(f"the dry run failed: {bad}")
    t0 = time.perf_counter()
    rec = dryrun.run_combo("smollm-135m", "train_4k", out_dir, run=True)
    run = rec.get("run")
    if rec["status"] != "ok" or run is None:
        raise AssertionError(f"the dry run's --run failed: "
                             f"{rec.get('error')}")
    same = (run["kernel_flops_card"] == run["kernel_flops_meta"] > 0
            and {k: v["flops"] for k, v in run["kernels_card"].items()}
            == {k: v["flops"] for k, v in run["kernels_meta"].items()})
    print(f"dry run --run smollm-135m x train_4k ({run['cut']}): "
          f"{run['ms']:.2f} ms a step, peak {run['peak_bytes'] / 2**30:.3f} "
          f"GiB; kernel FLOPs on the card {run['kernel_flops_card']:.6e}, "
          f"on the meta device {run['kernel_flops_meta']:.6e}, equal "
          f"{same}; the full shape's extrapolated FLOPs "
          f"{rec['flops']:.4e}, bytes {rec['bytes_accessed']:.4e} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("K3's and K2's FLOPs counted on the card differ "
                             "from the meta count")
    return {"run": run, "sweep_s": sweep_s, "meta_only": meta_only}


def _tree_gib(tree) -> float:
    """GiB held by the tensors of ``tree``."""
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(tree)) / 2**30


def _check_served(arch, cfg, res, n3) -> None:
    """A full-width serve's gates: K3 once a layer of the prefill, logits
    finite, tokens in range."""
    if n3 != cfg.n_layers:
        raise AssertionError(f"K3 launched {n3} times in one {arch} "
                             f"prefill, expected {cfg.n_layers}")
    if not bool(torch.isfinite(res.logits).all()):
        raise AssertionError(f"non-finite logits serving {arch}")
    if not bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise AssertionError(f"{arch}: tokens out of range")


def run_glm_main_path(dev) -> dict:
    """chatglm3-6b at full width and depth (28 layers, rope2d at half of
    Dh 128, 32 heads over 2: G 16), random seed-0 weights: fp32 serving of
    ``SERVE_B`` prompts of ``SERVE_PROMPT`` tokens, ``SERVE_GEN``
    generated (a warm serve of 2 first; K3 28 launches a prefill); then
    ``GLM_STEPS`` fp32 SGD steps at B 8 × S 256 through ``single_client``
    (each backward kernel of the plan once a layer a step; the losses
    finite and the trained weights' loss on the first batch below the
    first step's), and ``GLM_BF16_STEPS`` bf16 steps (``--dtype
    bfloat16``: K3's bf16 backward, SGD in the params' dtype as
    ``make_train_step``'s; the same gates). Prints ms, tokens/s and
    peaks; the weights are freed on return."""
    from repro_torch.configs import get_config
    from repro_torch.data import token_batch_stream
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import train
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import init_params, loss_fn
    cfg = get_config("chatglm3-6b")
    out = {}
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompts = make_prompts(cfg, SERVE_B, SERVE_PROMPT, seed=1, device=dev)
    serve(cfg, params, prompts, 2, device=dev)                 # warm
    torch.cuda.reset_peak_memory_stats(dev)
    k3.reset_counts()
    res = serve(cfg, params, prompts, SERVE_GEN, device=dev)
    n3 = k3.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _check_served("chatglm3-6b", cfg, res, n3)
    t = res.timings
    print(f"chatglm3-6b ({_tree_gib(params):.3f} GiB fp32) B={SERVE_B} "
          f"prompt={SERVE_PROMPT} gen={SERVE_GEN}: prefill "
          f"{t['prefill_ms']} ms, decode {t['decode_ms_per_step']} ms per "
          f"step, {t['decode_tok_per_s']} generated tok/s, peak memory "
          f"{peak:.3f} GiB, K3 launches {n3}")
    out["serve"] = {"timings": t, "peak_gib": peak, "k3": n3}
    del params, res
    torch.cuda.empty_cache()
    first = next(token_batch_stream(0, batch=TRAIN_B, seq_len=TRAIN_S,
                                    vocab=cfg.vocab))
    for dtype, steps in ((torch.float32, GLM_STEPS),
                         (torch.bfloat16, GLM_BF16_STEPS)):
        kernels = _bwd_kernels(BWD_CHATGLM, dev, dtype)
        torch.cuda.reset_peak_memory_stats(dev)
        k3.reset_counts()
        tr = train.single_client(cfg, steps=steps, batch=TRAIN_B,
                                 seq=TRAIN_S, lr=TRAIN_LR, dtype=dtype,
                                 device=dev)
        torch.cuda.synchronize()
        n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
        # bf16 steps launch the bf16 kernels only, fp32 steps none of them
        bf16 = dtype == torch.bfloat16
        routed = (k3.bf16_launches == n_fwd * bf16
                  and all(k3.bf16_backward_launches[name] == n * bf16
                          for name, n in n_bwd.items()))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        with torch.no_grad():
            held = float(loss_fn(tr.pop("params"), cfg, {
                k: torch.from_numpy(v).to(dev) for k, v in first.items()})[0])
        torch.cuda.empty_cache()
        tt, losses = tr["timings"], tr["losses"]
        name = str(dtype)[6:]
        print(f"chatglm3-6b training B={TRAIN_B} S={TRAIN_S} {steps} SGD "
              f"steps {name}: {tt['ms_per_step']} ms per step after the "
              f"first ({tt['first_step_ms']} ms), {tt['tokens_per_s']} "
              f"tokens/s, peak memory {peak:.3f} GiB; losses {losses}, the "
              f"first batch's after training {held}; launches K3 forward "
              f"{n_fwd}, backward {n_bwd}")
        want = cfg.n_layers * steps
        if not (n_fwd == want and _bwd_counts_ok(n_bwd, kernels, want)
                and routed
                and all(np.isfinite(losses + [held])) and held < losses[0]):
            raise AssertionError(f"chatglm3-6b {name} training: K3 "
                                 f"{n_fwd}/{n_bwd} (expected {want} a "
                                 f"kernel), losses {losses}, the first "
                                 f"batch's after training {held}")
        out[name] = {"timings": tt, "peak_gib": peak, "losses": losses,
                     "first_batch_after": held, "k3_forward": n_fwd,
                     "k3_backward": n_bwd,
                     "k3_bf16_forward": k3.bf16_launches,
                     "k3_bf16_backward": dict(k3.bf16_backward_launches)}
    return out


def run_step_builders(dev) -> dict:
    """The four step builders (``launch/steps.py``) in bf16 at chatglm3-6b's
    full width and depth (11.6 GiB of seed-0 weights), each shape's
    global_batch cut to one card (``BUILDER_CUTS``), widths and depth the
    config's: ``make_train_step`` at train_4k (S 4096) for
    ``BUILDER_TRAIN_STEPS`` steps (remat, lr 3e-3: losses finite, params
    changed; K3's forward twice a layer a step, each backward kernel once);
    ``make_prefill_step`` at prefill_32k (S 32,768: K3 once a layer,
    logits finite); ``make_decode_step`` at decode_32k (a zero bf16 cache
    of 32,768 positions, one step at the last) and at long_500k under its
    forced 4096 window (a ring of 4096, one step at position 524,287).
    Prints each cut, ms, peak and cache size; the weights are freed on
    return."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config, get_shape
    from repro_torch.data import token_batch_stream
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import steps
    from repro_torch.models.model import init_cache, init_params
    cfg = get_config("chatglm3-6b")
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    out = {}
    shapes = {}
    for name, batch in BUILDER_CUTS.items():
        full = get_shape(name)
        shapes[name] = dataclasses.replace(full, global_batch=batch)
        print(f"{name}: global_batch {full.global_batch} -> {batch} (one "
              f"card), seq_len {full.seq_len}, effective window "
              f"{steps.effective_window(cfg, shapes[name])}"
              + (f", {BUILDER_TRAIN_STEPS} steps" if full.mode == "train"
                 else ", one step" if full.mode == "decode" else ""))
    # make_train_step at train_4k
    shape = shapes["train_4k"]
    specs = steps.input_specs(cfg, shape)
    stream = token_batch_stream(0, batch=shape.global_batch,
                                seq_len=shape.seq_len, vocab=cfg.vocab)
    step = steps.make_train_step(cfg, TrainConfig(lr=TRAIN_LR), shape)
    before = params["layers"]["mlp"]["w_down"][0, :64].clone()
    torch.cuda.reset_peak_memory_stats(dev)
    k3.reset_counts()
    losses, ms = [], []
    for _ in range(BUILDER_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(dev, specs[k].dtype)
                 for k, v in next(stream).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, metrics = step(params, batch)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    n_fwd, n_bwd = k3.launches, dict(k3.backward_launches)
    routed = (k3.bf16_launches == n_fwd
              and k3.bf16_backward_launches == n_bwd)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    changed = not torch.equal(before, params["layers"]["mlp"]["w_down"][0,
                                                                       :64])
    want = cfg.n_layers * BUILDER_TRAIN_STEPS
    print(f"make_train_step train_4k bf16 B={shape.global_batch} "
          f"S={shape.seq_len}: ms per step {ms}, losses {losses}, params "
          f"changed {changed}, peak memory {peak:.3f} GiB; launches K3 "
          f"forward {n_fwd}, backward {n_bwd}")
    if not (all(np.isfinite(losses)) and changed and n_fwd == 2 * want
            and routed
            and _bwd_counts_ok(n_bwd, _bwd_kernels(BWD_TRAIN_4K, dev,
                                                   torch.bfloat16), want)):
        raise AssertionError(f"make_train_step at train_4k: losses {losses},"
                             f" changed {changed}, K3 {n_fwd}/{n_bwd}")
    out["train_4k"] = {"ms": ms, "losses": losses, "peak_gib": peak,
                       "k3_forward": n_fwd, "k3_backward": n_bwd,
                       "k3_bf16_backward": dict(k3.bf16_backward_launches)}
    del batch, metrics
    torch.cuda.empty_cache()
    # make_prefill_step at prefill_32k
    shape = shapes["prefill_32k"]
    tokens = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len),
                           generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32).to(dev)
    prefill = steps.make_prefill_step(cfg, shape)
    torch.cuda.reset_peak_memory_stats(dev)
    k3.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n3 = k3.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"make_prefill_step prefill_32k bf16 B={shape.global_batch} "
          f"S={shape.seq_len}: {ms} ms (first call), logits "
          f"{tuple(logits.shape)}, cache k {tuple(cache['layers']['k'].shape)}"
          f" {cache['layers']['k'].dtype}, peak memory {peak:.3f} GiB, K3 "
          f"launches {n3}")
    if not (n3 == k3.bf16_launches == cfg.n_layers
            and bool(torch.isfinite(logits).all())
            and cache["layers"]["k"].dtype == torch.bfloat16):
        raise AssertionError(f"make_prefill_step at prefill_32k: K3 {n3}")
    out["prefill_32k"] = {"ms": ms, "peak_gib": peak, "k3": n3}
    del logits, cache, tokens
    torch.cuda.empty_cache()
    # make_decode_step at decode_32k and long_500k
    for name in ("decode_32k", "long_500k"):
        shape = shapes[name]
        window = steps.effective_window(cfg, shape)
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           window=window, device=dev, dtype=torch.bfloat16)
        abstract = steps.abstract_cache(cfg, shape)
        same = all(cache["layers"][n].shape == abstract["layers"][n].shape
                   and cache["layers"][n].dtype == abstract["layers"][n].dtype
                   for n in ("k", "v"))
        gib = _tree_gib(cache)
        token = torch.randint(0, cfg.vocab, (shape.global_batch, 1),
                              generator=torch.Generator().manual_seed(3),
                              dtype=torch.int32).to(dev)
        pos = shape.seq_len - 1
        decode = steps.make_decode_step(cfg, shape)
        decode(params, cache, {"token": token, "pos": pos})      # warm
        torch.cuda.reset_peak_memory_stats(dev)
        k3.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, {"token": token, "pos": pos})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"make_decode_step {name} bf16 B={shape.global_batch}: cache "
              f"{tuple(cache['layers']['k'].shape)} k and v, {gib:.3f} GiB "
              f"(abstract_cache's shapes: {same}), window {window}, one step "
              f"at position {pos}: {ms} ms, logits finite "
              f"{bool(torch.isfinite(logits).all())}, peak memory "
              f"{peak:.3f} GiB, K3 launches {k3.launches}")
        if not (same and bool(torch.isfinite(logits).all())
                and k3.launches == 0):
            raise AssertionError(f"make_decode_step at {name}")
        out[name] = {"ms": ms, "cache_gib": gib, "peak_gib": peak,
                     "window": window}
        del cache, logits
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def run_starcoder2_main_path(dev) -> dict:
    """starcoder2-15b at full width and depth in bf16 (40 layers, 48 heads
    over 4 at Dh 128, its 4096 window; 22.0 B params, 41 GiB; fp32 fits no
    card): ``STAR_B`` prompts of ``STAR_PROMPT`` tokens, ``SERVE_GEN``
    generated, so the 4096-slot ring wraps in the prefill and in decode (a
    warm serve of 2 first; K3 40 launches a prefill, logits finite). Prints
    prefill ms, decode ms a step and the peak; the weights are freed on
    return."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import init_params
    cfg = get_config("starcoder2-15b")
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    prompts = make_prompts(cfg, STAR_B, STAR_PROMPT, seed=1, device=dev)
    serve(cfg, params, prompts, 2, device=dev)                 # warm
    torch.cuda.reset_peak_memory_stats(dev)
    k3.reset_counts()
    res = serve(cfg, params, prompts, SERVE_GEN, device=dev)
    n3 = k3.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _check_served("starcoder2-15b", cfg, res, n3)
    if k3.bf16_launches != n3:
        raise AssertionError("starcoder2-15b's bf16 prefill launched the "
                             "fp32 forward")
    t = res.timings
    print(f"starcoder2-15b ({_tree_gib(params):.3f} GiB bf16) B={STAR_B} "
          f"prompt={STAR_PROMPT} gen={SERVE_GEN} window "
          f"{cfg.sliding_window}: prefill {t['prefill_ms']} ms, decode "
          f"{t['decode_ms_per_step']} ms per step, {t['decode_tok_per_s']} "
          f"generated tok/s, peak memory {peak:.3f} GiB, K3 launches {n3}")
    print(f"first 16 tokens of prompt 0: {res.tokens[0, :16].tolist()}")
    del params, res
    torch.cuda.empty_cache()
    return {"timings": t, "peak_gib": peak, "k3": n3}


def _round_gaps(a, b) -> dict:
    """Max |d| of the params (every leaf of every rank), π and the metrics
    between two runs' ranks of one case (each rank's result, one round)."""
    from repro_torch.utils.bridge import tree_leaves
    gaps = {"params": 0.0, "pi": 0.0, "metrics": 0.0}
    for x, y in zip(a, b):
        for p, q in zip(tree_leaves(x["params"]), tree_leaves(y["params"])):
            gaps["params"] = max(gaps["params"],
                                 float((p.float() - q.float()).abs().max()))
        rx, ry = x["rounds"][0], y["rounds"][0]
        gaps["pi"] = max(gaps["pi"],
                         float(np.abs(rx["new_pi"] - ry["new_pi"]).max()))
        gaps["metrics"] = max(gaps["metrics"], max(
            abs(rx["metrics"][k] - ry["metrics"][k]) for k in rx["metrics"]))
    return gaps


def _flat_cpu(tree) -> torch.Tensor:
    from repro_torch.utils.bridge import tree_leaves
    return torch.cat([x.reshape(-1) for x in tree_leaves(tree)])


def _int8_stages(got, want, ok, alpha) -> dict:
    """The int8 round's stages on the card against the CPU, each on the
    card's own inputs: int8 rounding is discontinuous, so a quantizer
    input a rounding error from a tie (the card's and the CPU's local
    steps round differently) flips one element by a whole quantum, and
    the end-to-end params cannot be held to 1e-4 there. ``post_step``:
    the local step's params, card vs CPU; ``stack_exact``: each card
    rank's exchanged stack bitwise the quantizer (``exchange_models``)
    run on the CPU over the card ranks' post-step params; ``mix``: the
    card's params against the Eq-1 mix in float64 of its post-step params
    and its stack by its π* row and links; ``ties``: the stack elements
    where the card's and the CPU's quantizers rounded apart."""
    from repro_torch.launch.steps import exchange_models
    from repro_torch.utils.bridge import ParamLayout
    layout = ParamLayout.of(got[0]["params"])
    posts = [_flat_cpu(r["rounds"][0]["post_step"]) for r in got]
    rows = torch.cat([exchange_models(p, layout, 8) for p in posts])
    out = {"post_step": max(
        float((p - _flat_cpu(r["rounds"][0]["post_step"])).abs().max())
        for p, r in zip(posts, want)), "stack_exact": True, "mix": 0.0,
        "ties": 0}
    for rank, r in enumerate(got):
        stack = r["rounds"][0]["stack"]
        out["stack_exact"] &= torch.equal(stack, rows)
        out["ties"] += int((stack != want[rank]["rounds"][0]["stack"]).sum())
        w = torch.from_numpy(r["rounds"][0]["new_pi"][rank]).double() * \
            torch.from_numpy(ok[rank]).double()
        mixed = posts[rank].double()
        if float(w.sum()) > 0:
            mixed = alpha * mixed + (1 - alpha) * (w / w.sum()) @ \
                stack.double()
        out["mix"] = max(out["mix"], float(
            (_flat_cpu(r["params"]).double() - mixed).abs().max()))
    return out


def _round_update_gaps(params, got, want, want32, lr) -> tuple:
    """The local step inside the round, as its update Δ = post-step −
    initial params over every leaf of every rank (``params``: the case's
    stacked fp32 numpy tree, cast to the run's dtype on the ranks): (the
    card's Δ against the CPU's in relative norm, g). A bf16 step moves most
    params by less than half an ulp, so the round's params cannot see a
    wrong gradient; Δ can. g (with ``want32``, the CPU's fp32 twin): the
    CPU's Δ against the Δ its SGD rule gives in bf16 from the fp32 twin's
    gradient, recovered as (p32 − post32)/lr (``bf16_step_against_cpu``'s
    "update" gate)."""
    from repro_torch.launch.train import _sgd_in_param_dtype_
    from repro_torch.utils.bridge import tree_leaves
    d_got, d_want, d_alt = [], [], []
    for rank in range(len(got)):
        p32 = [torch.from_numpy(np.asarray(x[rank]))
               for x in tree_leaves(params)]
        post = [tree_leaves(r[rank]["rounds"][0]["post_step"])
                for r in (got, want)]
        start = [x.to(post[0][0].dtype) for x in p32]
        d_got += [a.float() - b.float() for a, b in zip(post[0], start)]
        d_want += [a.float() - b.float() for a, b in zip(post[1], start)]
        if want32 is not None:
            post32 = tree_leaves(want32[rank]["rounds"][0]["post_step"])
            alt = [x.clone() for x in start]
            _sgd_in_param_dtype_(alt, [(a - b) / lr
                                       for a, b in zip(p32, post32)], lr)
            d_alt += [a.float() - b.float() for a, b in zip(alt, start)]
    return (_rel_err(d_got, d_want),
            _rel_err(d_alt, d_want) if want32 is not None else None)


def check_round_step_against_cpu(dev, clients=(4,)) -> dict:
    """The round step at reduced smollm-135m on C gloo ranks on the card
    against C gloo ranks on the CPU (plain kernels), on the same arrays,
    for each C of ``clients``: C = 2 at exchange 16 and 8 with every link
    up; C = 4 at exchange 16 and 8 with a zero column in π and links
    erased at random, the last row all erased; each in fp32 (TF32 off)
    and bf16. Gates: fp32 params (every leaf), π and metrics within
    ``TRAIN_TOL`` (at exchange 8 the params stage by stage,
    ``_int8_stages``: the post-step params and the card's mix of its own
    stack within it, its stack bitwise the quantizer's on the CPU over
    the card's post-step params, as int8 rounding flips ties); bf16 within
    max(``ROUND_BF16_TOL``, g), g the CPU's own bf16-vs-fp32 gap on the
    same inputs; the local step's update Δ = post-step − initial params
    (``_round_update_gaps``) in relative norm, fp32 within ``TRAIN_TOL``,
    bf16 within max(``ROUND_BF16_TOL``, 2g); the erased rank's params
    bitwise its post-step params on the card; 3 collectives a round (4 at int8); on the card K2 once a
    rank (in bf16 on bf16 runs) and K3's forward L·(1 + C) times, its
    bf16 kernels in bf16 runs only; no K2 launch on the CPU. Returns the
    worst gaps by dtype."""
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch.mesh import MeshSpec, make_debug_mesh
    from repro_torch.models.model import init_params
    from repro_torch.sharding import spawn
    from repro_torch.sharding.worker import run_round_step
    from repro_torch.utils.bridge import tree_leaves
    from torch.utils._pytree import tree_map
    cfg = get_config("smollm-135m").reduced()
    shape = ShapeConfig("t", ROUND_SMALL_SEQ, ROUND_SMALL_BATCH, "train")
    train = TrainConfig(lr=ROUND_LR, remat=False)
    dtypes = (torch.float32, torch.bfloat16)
    worst = {d: {"params": 0.0, "pi": 0.0, "metrics": 0.0} for d in dtypes}
    failed = []
    torch.cuda.empty_cache()
    for C in clients:
        gen = torch.Generator().manual_seed(C)
        params = tree_map(lambda *xs: torch.stack(xs).numpy(),
                          *[init_params(cfg, gen, "cpu") for _ in range(C)])
        rng = np.random.default_rng(C)
        batch = {k: rng.integers(0, cfg.vocab, (C, ROUND_SMALL_BATCH,
                                                ROUND_SMALL_SEQ)
                                 ).astype(np.int32)
                 for k in ("tokens", "labels")}
        pi = rng.uniform(0.1, 1.0, (C, C)).astype(np.float32)
        if C == 2:
            ok = np.ones((C, C), bool)
        else:
            pi[:, 1] = 0.0
            ok = rng.uniform(size=(C, C)) > 0.3
            np.fill_diagonal(ok, True)
            ok[-1] = False
        mesh = (make_debug_mesh(multi_pod=True) if C == 2 else
                MeshSpec(("pod", "data", "model"), (4, 2, 1)))
        # each exchange's fp32 case, then its bf16 twin (the same fp32
        # params, cast on the rank)
        cases = [dict(cfg=cfg, train=train, shape=shape, mesh=mesh,
                      kw=dict(n_clients=C,
                              probe_sequences=ROUND_SMALL_PROBE[0],
                              probe_tokens=ROUND_SMALL_PROBE[1]),
                      params=params, dtype=dtype, batch=batch, pi_matrix=pi,
                      link_ok=ok, rounds=[bits], keep=True, check=True)
                 for bits in (16, 8) for dtype in dtypes]
        cpu = spawn(run_round_step, C, "gloo", "cpu", cases, "cpu")
        card = spawn(run_round_step, C, "gloo", "cuda", cases, "cuda")
        for i, case in enumerate(cases):
            dtype, bits = case["dtype"], case["rounds"][0]
            got, want = [r[i] for r in card], [r[i] for r in cpu]
            gaps = _round_gaps(got, want)
            stages, stack_ok = "", True
            if dtype == torch.float32 and bits == 8:
                staged = _int8_stages(got, want, ok, 0.5)
                stages = f"; int8 stages {staged}"
                stack_ok = staged["stack_exact"]
                gaps = {"post_step": staged["post_step"],
                        "mix": staged["mix"], "pi": gaps["pi"],
                        "metrics": gaps["metrics"]}
            fp32 = dtype == torch.float32
            gaps["update"], g = _round_update_gaps(
                params, got, want, None if fp32 else [r[i - 1] for r in cpu],
                ROUND_LR)
            if fp32:
                gates = dict.fromkeys(gaps, TRAIN_TOL)
            else:
                own = _round_gaps(want, [r[i - 1] for r in cpu])
                gates = {k: max(ROUND_BF16_TOL, own[k]) for k in own}
                gates["update"] = max(ROUND_BF16_TOL, 2 * g)
            erased_ok = C == 2 or all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(got[-1]["params"]),
                    tree_leaves(got[-1]["rounds"][0]["post_step"])))
            want_fwd = cfg.n_layers * (1 + C)
            counts_ok = all(
                r["rounds"][0]["collectives"] == (4 if bits == 8 else 3)
                and r["rounds"][0]["k2"] == 1
                and r["rounds"][0]["k2_bf16"] == int(dtype == torch.bfloat16)
                and r["rounds"][0]["k3"]["forward"] == want_fwd
                and r["rounds"][0]["k3"]["bf16_forward"]
                == want_fwd * (dtype == torch.bfloat16) for r in got) and \
                all(r["rounds"][0]["k2"] == 0 for r in want)
            same_pi = all(np.array_equal(r["rounds"][0]["new_pi"],
                                         got[0]["rounds"][0]["new_pi"])
                          for r in got)
            print(f"round step reduced smollm-135m C={C} exchange {bits} "
                  f"{str(dtype)[6:]}, card vs CPU: {gaps} (gates {gates})"
                  f"{stages}; "
                  f"erased rank bitwise its post-step params {erased_ok}; "
                  f"collectives, K2 and K3 launches as planned {counts_ok}; "
                  f"new_pi equal on every rank {same_pi}")
            for k in gaps:
                worst[dtype][k] = max(worst[dtype].get(k, 0.0), gaps[k])
            if not (all(gaps[k] <= gates[k] for k in gaps) and stack_ok
                    and erased_ok and counts_ok and same_pi):
                failed.append((C, bits, str(dtype)[6:]))
    if failed:
        raise AssertionError(f"the round step on the card disagrees with "
                             f"the CPU at (C, exchange, dtype) {failed}")
    return worst


def run_round_main_path(dev) -> dict:
    """The round step at full width: smollm-135m in bf16, ``ROUND_C``
    ranks on this card, seed-0 weights drawn for every client from one
    generator, B 2 x S 4096 a client, rounds at ``ROUND_BITS``. Each round
    on each rank: K2 once in bf16; K3's bf16 forward L·(1 + C) times (and
    L more under remat), its bf16 backward kernels L times each as
    ``backward_plan`` picks them, no fp32 K3 launch; 3 collectives (4 at
    int8); finite losses; π* rows on the simplex and ``new_pi`` equal on
    every rank. Prints each rank's ms a round (host clock ending in a
    sync, rounds after the first), its split by stage (CUDA events) and
    peak memory, and the sum of the peaks. Returns the launches (summed
    over ranks and rounds) and the timings."""
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.sharding import spawn
    from repro_torch.sharding.worker import run_round_step
    cfg = get_config("smollm-135m")
    C, L = ROUND_C, cfg.n_layers
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (C, ROUND_B, ROUND_S + 1))
    batch = {"tokens": tokens[..., :-1].astype(np.int32),
             "labels": tokens[..., 1:].astype(np.int32)}
    pi = np.full((C, C), 1.0 / (C - 1), np.float32)
    np.fill_diagonal(pi, 0.0)
    ok = np.random.default_rng(7).uniform(size=(C, C)) >= ROUND_P_ERR
    case = dict(cfg=cfg, train=TrainConfig(lr=ROUND_LR, remat=ROUND_REMAT),
                shape=ShapeConfig("train_4k", ROUND_S, ROUND_B, "train"),
                mesh=MeshSpec(("pod", "data", "model"), (C, 16, 16)),
                kw=dict(n_clients=C, alpha=ROUND_ALPHA,
                        em_iters=ROUND_EM_ITERS,
                        probe_sequences=ROUND_PROBE[0],
                        probe_tokens=ROUND_PROBE[1]),
                seed=0, dtype=torch.bfloat16, batch=batch, pi_matrix=pi,
                link_ok=ok, rounds=list(ROUND_BITS))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = [r[0] for r in spawn(run_round_step, C, "gloo", "cuda", [case],
                                 "cuda")]
    wall = time.perf_counter() - t0
    kernels = _bwd_kernels(ATTN_ROUND_TRAIN, dev, torch.bfloat16)
    want_fwd = L * (1 + C + ROUND_REMAT)
    n2 = n_fwd = 0
    n_bwd = {}
    ok_all = True
    for i, bits in enumerate(ROUND_BITS):
        pis = [r["rounds"][i]["new_pi"] for r in ranks]
        for rank, res in enumerate(ranks):
            r = res["rounds"][i]
            k3c, stages = r["k3"], r["stage_ms"]
            good = (r["k2"] == r["k2_bf16"] == 1
                    and k3c["forward"] == k3c["bf16_forward"] == want_fwd
                    and k3c["backward"] == k3c["bf16_backward"]
                    and _bwd_counts_ok(k3c["bf16_backward"], kernels, L)
                    and r["collectives"] == (4 if bits == 8 else 3)
                    and all(np.isfinite(v) for v in r["metrics"].values())
                    and np.allclose(r["new_pi"].sum(1), 1.0, atol=1e-5)
                    and (r["new_pi"] >= 0).all()
                    and all(np.array_equal(p, pis[0]) for p in pis))
            ok_all &= good
            n2 += r["k2"]
            n_fwd += k3c["bf16_forward"]
            for k, v in k3c["bf16_backward"].items():
                n_bwd[k] = n_bwd.get(k, 0) + v
            print(f"round {i} (exchange {bits}) rank {rank}: "
                  f"{r['ms']:.2f} ms, stages (device ms) "
                  f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}"
                  f", metrics {json.dumps(r['metrics'])}, collectives "
                  f"{r['collectives']}, K2 {r['k2']} (bf16 {r['k2_bf16']}), "
                  f"K3 forward {k3c['forward']} (bf16 {k3c['bf16_forward']}),"
                  f" backward {k3c['bf16_backward']}; as planned {good}")
        print(f"round {i} new_pi {pis[0].tolist()}")
    later = {rank: [r["ms"] for r in res["rounds"][1:]]
             for rank, res in enumerate(ranks)}
    stages = {rank: {k: [r["stage_ms"][k] for r in res["rounds"][1:]]
                     for k in res["rounds"][0]["stage_ms"]}
              for rank, res in enumerate(ranks)}
    peaks = [res["peak_gib"] for res in ranks]
    print(f"round step smollm-135m bf16 C={C} B={ROUND_B} S={ROUND_S} "
          f"probe {ROUND_PROBE} remat {ROUND_REMAT}: wall {wall:.1f} s "
          f"(the ranks' start, weights and 4 rounds); ms a round a rank "
          f"after the first {json.dumps(later)}; peaks (GiB) "
          f"{[round(p, 3) for p in peaks]}, sum {sum(peaks):.3f}")
    if not ok_all:
        raise AssertionError("the full-width round step missed its launch, "
                             "collective or π checks")
    return {"k2": n2, "k2_per_rank": [sum(r["k2"] for r in res["rounds"])
                                      for res in ranks],
            "k3_forward": n_fwd, "k3_bf16_backward": n_bwd,
            "ms_per_round": later, "stage_ms": stages, "peak_gib": peaks,
            "steps": C * len(ROUND_BITS)}


def k2_round_report(dev, n2, per_rank, floor) -> dict:
    """K2's row at the round step's mix (phase 7h): bf16, P = smollm-135m's
    162,826,560 params, the exact own row and a (4, P) stack of the
    gathered models, links up and all erased against the plain version on
    the card (|d| within one bf16 ulp of the plain version,
    ``ROUND_MIX_TOL``; erased: own bitwise), its steady and cold ms, the
    plain version's and
    ``torch.addmv``'s in bf16, and the bytes bound (5 rows read, 1
    written)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import weighted_agg as k2
    from repro_torch.kernels.ref import weighted_agg_ref
    from repro_torch.launch.steps import abstract_params
    from repro_torch.utils.bridge import ParamLayout
    P = ParamLayout.of(abstract_params(get_config("smollm-135m"))).size
    M, bf16 = ROUND_C, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(5)
    stack = (torch.randn((M, P), generator=g, device=dev) * 0.02).to(bf16)
    own = (torch.randn(P, generator=g, device=dev) * 0.02).to(bf16)
    w = torch.softmax(torch.randn(M, generator=g, device=dev), 0)
    ulps, floor_abs = ROUND_MIX_TOL
    errs = {}
    for any_ok in (True, False):
        ok = torch.tensor(any_ok, device=dev)
        out = k2.weighted_agg(own, stack, w, ROUND_ALPHA, any_ok=ok)
        expect = weighted_agg_ref(own, stack, w, ROUND_ALPHA, any_ok=ok)
        diff = (out.float() - expect.float()).abs()
        errs[any_ok] = float(diff.max())
        excess = float((diff - ulps * expect.float().abs()).max())
        print(f"K2 round step mix bf16 M={M} P={P} any_ok={any_ok}: "
              f"max|d|={errs[any_ok]:.3g} max(|d| - 2^-7|ref|)={excess:.3g}"
              f" tol: |d| <= 2^-7|ref| + {floor_abs:g}")
        if not excess <= floor_abs or (not any_ok
                                       and not torch.equal(out, own)):
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"the round step's mix (any_ok={any_ok})")
        del out, expect, diff
    ok = torch.tensor(True, device=dev)
    wb = w.to(bf16)
    bytes_ms = (M + 2) * P * 2 / HBM_BYTES_PER_S * 1e3
    ops_ms = (2 * M + 3) * P / FP32_FLOPS * 1e3

    def kernel():
        return k2._launch(own, stack, w, ROUND_ALPHA, None, ok, M)

    row = {
        "name": "weighted_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/weighted_agg.cu",
        "replaces": "src/repro/kernels/weighted_agg.py:31",
        "main_path": "pfedwn round step (launch/steps.py::make_pfedwn_"
                     "round_step), smollm-135m bf16, C 4 gloo ranks on one "
                     "card: one launch a round a rank",
        "launches": n2, "launches_per_rank": per_rank,
        "max_abs_err": errs[True], "max_abs_err_all_erased": errs[False],
        "tolerance": {"per_ref": ulps, "abs": floor_abs},
        "shape": {"M": M, "P": P, "dtype": "bfloat16"},
        "ms": time_ms(kernel),
        "cold_ms": cold_ms(kernel, dev, iters=20),
        "plain_ms": time_ms(lambda: weighted_agg_ref(
            own, stack, w, ROUND_ALPHA, any_ok=ok), iters=3, reps=5),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": time_ms(lambda: torch.addmv(
            own, stack.T, wb, beta=ROUND_ALPHA, alpha=1 - ROUND_ALPHA)),
        "library_note": "torch.addmv in bf16 (w rounded to bf16)",
        "vector_bytes": k2.vector_bytes(
            (own.data_ptr(), stack.data_ptr()), stack.stride(0) * 2, bf16),
        "grid": k2.last_grid, "floor_ms": floor}
    del stack, own
    torch.cuda.empty_cache()
    return row


def time_ms(fn, iters=20, reps=10) -> float:
    """Steady-state device ms per call of ``fn``: ``iters`` calls enqueued
    back to back between two CUDA events while ``torch.cuda._sleep`` holds
    the stream, so the host's launch overhead is hidden and each call finds
    the previous call's inputs in L2. The median over ``reps`` brackets."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)         # ~10 ms at 1.98 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events])) / iters


def cold_ms(fn, dev, iters=50, warmup=5) -> float:
    """Mean device ms of one call of ``fn`` alone, as the round meets it:
    each call is bracketed by CUDA events, with the 50 MB L2 evicted before
    it by reading a 64 MB buffer (a read leaves no dirty lines for the
    timed call to write back) and the stream held busy by
    ``torch.cuda._sleep`` while the host enqueues the call. Includes the
    bracket's own cost (printed as the empty bracket)."""
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        torch.amax(flush)
        torch.cuda._sleep(1_000_000)          # ~0.5 ms at 1.98 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in events]))


def back_to_back_ms(fn, iters=200) -> float:
    """ms per call over ``iters`` calls issued back to back and bracketed by
    two CUDA events: for kernels this small it is the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_times(dev, shape, dtype) -> dict:
    """K1 at one shape and dtype: its steady and cold ms, the plain
    version's ms, its bound and its share of it, and its max |dλ|, |dℓ|
    against the plain version on the same inputs."""
    from repro_torch.kernels import em_posterior as k1
    from repro_torch.kernels.ref import em_posterior_ref
    M, T, V = shape
    pi, logits, labels = _em_inputs(M, T, V, dtype, dev)
    err_l, err_abs, _ = _em_error((pi, logits, labels))
    nbytes = M * T * V * logits.element_size() + T * 8 + M * 4 + 2 * T * M * 4
    ops = 6 * M * T * V + 12 * M * T
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS * 1e3
    wide = M * T * V > 1 << 22
    row = {
        "shape": {"M": M, "T": T, "V": V, "dtype": str(dtype)[6:]},
        "max_abs_err": max(err_l, err_abs),
        "ms": time_ms(lambda: k1._launch(pi, logits, labels)),
        "cold_ms": cold_ms(lambda: k1._launch(pi, logits, labels), dev),
        "plain_ms": time_ms(lambda: em_posterior_ref(pi, logits, labels),
                            iters=5 if wide else 20, reps=5 if wide else 10),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


def k1_report(dev, n1, n1_wide, floor, n1_c100) -> dict:
    """K1's row: the main path's shape in fp32 at the top level, and in
    ``shapes`` that shape, smollm-135m's vocabulary, the M = 39 round's
    shape and the cifar100-cnn round's, fp32 and bf16, each with the
    kernel's plan (the M = 39 and cifar100 entries also with their rounds'
    launches)."""
    from repro_torch.kernels import em_posterior as k1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for shape in (EM_MAIN, EM_VOCAB, EM_WIDE, EM_CIFAR100):
        for dtype in (torch.float32, torch.bfloat16):
            row = k1_times(dev, shape, dtype)
            # a fresh allocation is aligned as an address of 0 is
            row["plan"] = k1.plan(*shape, dtype, 0, sms,
                                  *k1.kernel_limits())._asdict()
            if shape in (EM_WIDE, EM_CIFAR100):
                row["launches"] = n1_wide if shape == EM_WIDE else n1_c100
            shapes.append(row)
    main = shapes[0]
    pi, logits, labels = _em_inputs(*EM_MAIN, torch.float32, dev)
    return {
        "name": "em_posterior", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/em_posterior.cu",
        "replaces": "src/repro/kernels/em_posterior.py:72",
        "launches": n1, "max_abs_err": main["max_abs_err"],
        "tolerance": TOL[torch.float32], "shape": main["shape"],
        "ms": main["ms"], "cold_ms": main["cold_ms"],
        "plain_ms": main["plain_ms"],
        "back_to_back_ms": back_to_back_ms(
            lambda: k1.em_posterior_forward(pi, logits, labels)),
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "floor_ms": floor, "library_ms": None, "shapes": shapes}


def _kernel_resources(rows, names) -> list:
    """The rows of ``_build.resources`` (ptxas's report of the build) whose
    kernel names start with one of ``names`` (after the anonymous
    namespace), each instantiation's registers and spill bytes."""
    keep = ("kernel", "registers", "stack_bytes", "spill_store_bytes",
            "spill_load_bytes")
    return [{k: r.get(k) for k in keep} for r in rows
            if any(f"::{n}" in r["kernel"] for n in names)]


def floor_ms(dev) -> float:
    """A 1-element ``zero_()`` in the ``time_ms`` bracket: how close a
    launch of a tiny kernel gets on this card."""
    z = torch.empty(1, device=dev)
    return time_ms(lambda: z.zero_())


def k2_times(dev, stack, pi, alpha) -> dict:
    """K2 mixing row 0 of the (N, P) fp32 ``stack`` with rows 1..M (M =
    N − 1) by weights ``pi`` with every link up, as the round calls it: its
    steady and cold ms, the plain version's ms, its bound, ``torch.addmv``'s
    ms on the same mix (the library yardstick), its vector width and grid,
    and its max |d| against the plain version."""
    from repro_torch.kernels import weighted_agg as k2
    from repro_torch.kernels.ref import weighted_agg_ref
    M, P = stack.shape[0] - 1, stack.shape[1]
    rows = torch.arange(1, M + 1, device=dev)
    w = pi.float()
    ok = torch.tensor(True, device=dev)
    own, nb = stack[0], stack[1:]
    out = k2._launch(own, stack, w, alpha, rows, ok, M)
    torch.cuda.synchronize()
    grid = k2.last_grid
    err = float((out - weighted_agg_ref(own, stack, w, alpha, index=rows,
                                        any_ok=ok)).abs().max())
    nbytes = (M + 2) * P * 4 + M * 12 + 1
    ops = (2 * M + 3) * P
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS * 1e3
    return {
        "shape": {"M": M, "P": P, "dtype": "float32"},
        "max_abs_err": err,
        "ms": time_ms(lambda: k2._launch(own, stack, w, alpha, rows, ok, M)),
        "cold_ms": cold_ms(
            lambda: k2._launch(own, stack, w, alpha, rows, ok, M), dev),
        "plain_ms": time_ms(lambda: weighted_agg_ref(
            own, stack, w, alpha, index=rows, any_ok=ok)),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": time_ms(lambda: torch.addmv(
            own, nb.T, w, beta=alpha, alpha=1 - alpha)),
        "library_cold_ms": cold_ms(lambda: torch.addmv(
            own, nb.T, w, beta=alpha, alpha=1 - alpha), dev),
        "vector_bytes": k2.vector_bytes(
            (own.data_ptr(), out.data_ptr(), stack.data_ptr()),
            stack.stride(0) * 4, torch.float32),
        "grid": grid}


def _mix_args(sim):
    """The last run's stack, π with every link up and α: the main path's
    K2 inputs (all N clients take part, so rows 1..M are the
    neighbours)."""
    from repro_torch.core.aggregation import masked_pi
    pi = sim.last_state["pi"]
    w = masked_pi(pi, torch.ones(sim.m, dtype=torch.bool, device=pi.device))
    if not torch.equal(sim._nbr.cpu(), torch.arange(1, sim.m + 1)):
        raise AssertionError("the neighbours are not rows 1..M")
    return sim.last_state["params"], w, sim.sim.alpha


def agg_report(dev, sim, n2, err2, wide_sim, n2_wide, floor):
    """K2's row at the main path's shape (the cifar10-cnn round's mix, M
    10), with the M = 39 round's mix under ``shapes``."""
    from repro_torch.kernels import weighted_agg as k2
    stack, w, alpha = _mix_args(sim)
    main = k2_times(dev, stack, w, alpha)
    wide = {**k2_times(dev, *_mix_args(wide_sim)), "launches": n2_wide}
    M, P = sim.m, stack.shape[1]
    rows, ok = sim._nbr, torch.tensor(True, device=dev)
    own = stack[0]
    # the same mix from a stack whose rows are 16-byte aligned (P padded by
    # 2), for what padding the engine's stack would buy
    padded = torch.zeros((stack.shape[0], P + 2), device=dev)
    padded[:, :P] = stack
    pstack = padded[:, :P]
    pvec = k2.vector_bytes((pstack.data_ptr(), pstack.data_ptr()),
                           pstack.stride(0) * 4, torch.float32)
    return {
        "name": "weighted_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/weighted_agg.cu",
        "replaces": "src/repro/kernels/weighted_agg.py:31",
        "launches": n2, "max_abs_err": err2,
        "tolerance": AGG_TOL[torch.float32],
        **{k: main[k] for k in ("shape", "ms", "cold_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "library_cold_ms", "vector_bytes", "grid")},
        "back_to_back_ms": back_to_back_ms(lambda: k2.weighted_agg(
            own, stack, w, alpha, index=rows, any_ok=ok)),
        "floor_ms": floor,
        "padded_stride": {
            "stride": P + 2, "vector_bytes": pvec,
            "ms": time_ms(lambda: k2._launch(pstack[0], pstack, w, alpha,
                                             rows, ok, M)),
            "cold_ms": cold_ms(lambda: k2._launch(pstack[0], pstack, w,
                                                  alpha, rows, ok, M), dev)},
        "shapes": [wide]}


def _unmasked_pairs(Sq, Skv, causal, window) -> int:
    """The (query, key) pairs of one head that the masks leave."""
    from repro_torch.kernels.ref import _attention_mask
    return int(_attention_mask(Sq, Skv, causal, window, "cpu").sum())


def attention_report(dev, shape, n3, err3, floor, main_path):
    """K3's row at a main path's ``shape`` in fp32 (smollm-135m's and
    granite-moe's prefill at Dh 64, minicpm3-4b's at 96, reduced
    minicpm3-4b's at 48, zamba2-7b's at 112), with the
    launches ``n3`` that path made and the error ``err3`` phase 6 found
    there."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import flash_attention_ref
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    q, k, v = _attn_inputs(shape, torch.float32, dev)
    pairs = _unmasked_pairs(Sq, Skv, causal, window)
    ops = 4 * Dh * pairs * B * H             # score and P.V multiply-adds
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    split_ms = SPLIT_TF32_TERMS * ops / TF32_FLOPS * 1e3
    fp32_ms = ops / FP32_FLOPS * 1e3
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    return {
        "name": "flash_attention", "route": "cuda",
        "design": "split-TF32 wgmma (3 products a product), TMA-fed K/V "
                  "ring; ms_bf16 is the bf16 kernel "
                  "(csrc/flash_attention_bf16.cu) at the same shape",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "main_path": main_path, "launches": n3, "max_abs_err": err3,
        "tolerance": ATTN_TOL[torch.float32],
        "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "KH": KH, "Dh": Dh,
                  "causal": causal, "window": window, "dtype": "float32"},
        "ms": time_ms(lambda: k3._launch(q, k, v, causal, window)),
        "cold_ms": cold_ms(lambda: k3._launch(q, k, v, causal, window), dev),
        "plain_ms": time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), iters=5, reps=5),
        "back_to_back_ms": back_to_back_ms(lambda: k3.flash_attention(
            q, k, v, causal=causal, window=window), iters=50),
        "bound_ms": max(bytes_ms, split_ms),
        "bound_by": "bytes" if bytes_ms >= split_ms else "operations",
        "bound_route": "split TF32: 3 x the FLOPs at 495 TFLOP/s",
        "bound_fp32_cuda_core_ms": max(bytes_ms, fp32_ms),
        "bound_bytes_ms": bytes_ms,
        "ms_bf16": time_ms(lambda: k3._launch(qb, kb, vb, causal, window)),
        "floor_ms": floor, "library_ms": time_ms(sdpa),
        "library_backend": sdpa_backends(sdpa)}


def attention_positions_report(dev, shape, n_pos, err, floor, main_path):
    """K3's row with explicit positions at ``shape`` (qwen2-vl's prefill)
    under the temporal positions of its M-RoPE prompt
    (``_mrope_layout``), fp32, beside the index path at the same shape and
    SDPA given the equivalent boolean ``attn_mask``; the bound counts the
    pairs this mask leaves and the positions read."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import _attention_mask, flash_attention_ref
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    q, k, v = _attn_inputs(shape, torch.float32, dev)
    qp = _mrope_layout(256, Sq - 256, dev)[:, 0].contiguous()
    pos = dict(q_positions=qp, kv_positions=qp)
    mask = _attention_mask(Sq, Skv, causal, window, dev, qp, qp)
    pairs = int(mask.sum())
    ops = 4 * Dh * pairs * B * H
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + Sq + Skv)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    split_ms = SPLIT_TF32_TERMS * ops / TF32_FLOPS * 1e3
    return {
        "name": "flash_attention (explicit positions)", "route": "cuda",
        "design": "the forward's position instantiation: the block's tile "
                  "range from its rows' least and greatest position and "
                  "every key's, each tile's key positions in shared memory, "
                  "an element mask from them",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "replaces_note": "the reference's model path masks chunked_"
                         "attention by positions (src/repro/models/"
                         "attention.py:72-80); its Pallas K3 masks by index",
        "main_path": main_path, "launches": n_pos, "max_abs_err": err,
        "tolerance": ATTN_TOL[torch.float32],
        "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "KH": KH, "Dh": Dh,
                  "causal": causal, "window": window, "dtype": "float32",
                  "positions": "256 tied at 0, then 16.."},
        "unmasked_pairs_per_head": pairs,
        "ms": time_ms(lambda: k3._launch(q, k, v, causal, window, **pos)),
        "cold_ms": cold_ms(lambda: k3._launch(q, k, v, causal, window,
                                              **pos), dev),
        "index_path_ms": time_ms(lambda: k3._launch(q, k, v, causal,
                                                    window)),
        "plain_ms": time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window, **pos), iters=5, reps=5),
        "bound_ms": max(bytes_ms, split_ms),
        "bound_by": "bytes" if bytes_ms >= split_ms else "operations",
        "bound_route": "split TF32: 3 x the FLOPs at 495 TFLOP/s",
        "bound_bytes_ms": bytes_ms,
        "floor_ms": floor, "library_ms": time_ms(sdpa, iters=5, reps=5),
        "library_note": "SDPA with the boolean attn_mask of these positions",
        "library_backend": sdpa_backends(sdpa)}


def k3_bwd_times(dev, shape, k3=None, calls=None, dtype=torch.float32,
                 iters=20, positions=None) -> dict:
    """K3's backward at ``shape`` in ``dtype``: the kernels' steady and
    cold ms together and each one's steady ms (its launches at ``shape``;
    ``iters`` calls a bracket), the bounds (five products of 2·Dh FLOPs for
    each unmasked (query, key) pair of each head: in fp32 split TF32 at 495
    TFLOP/s, three TF32 products for each, and fp32 at 67 TFLOP/s on the
    CUDA cores; in bf16 the FLOPs at bf16's 989 TFLOP/s; the bytes of q,
    k, v, o, dO and the LSE read and dq, dk, dv and D written), and SDPA's
    backward on the same inputs. ``k3`` is the module whose forward gives
    o and the LSE (the port on the path by default); ``calls(q, k, v, out,
    lse, dout, causal, window)`` returns the backward's launches as (name,
    launch) pairs (by default ``k3._backward_launches``'s), so another
    version of the kernels can be timed the same way. ``positions``:
    explicit (Sq,) positions of both sides (int32 on the card), whose mask
    sets the pairs and SDPA's boolean mask."""
    from repro_torch.kernels.ref import _attention_mask
    if k3 is None:
        from repro_torch.kernels import flash_attention as k3
    pos = ({} if positions is None else
           dict(q_positions=positions, kv_positions=positions))
    if calls is None:
        def calls(*args):
            return k3._backward_launches(*args, **pos)[1]
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    q, k, v, dout = _bwd_inputs(shape, dev, dtype=dtype)
    out, lse = k3._launch(q, k, v, causal, window, with_lse=True, **pos)
    launches = calls(q, k, v, out, lse, dout, causal, window)

    def bwd():
        for _, launch in launches:
            launch()

    mask = (None if positions is None else
            _attention_mask(Sq, Skv, causal, window, dev, positions,
                            positions))
    pairs = (_unmasked_pairs(Sq, Skv, causal, window) if mask is None
             else int(mask.sum()))
    ops = 5 * 2 * Dh * pairs * B * H
    nbytes = (q.element_size() * (4 * q.numel() + 2 * k.numel()
                                  + 2 * v.numel())
              + 4 * 2 * lse.numel())      # q, o, dO, dq; k, dk; v, dv; LSE, D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fp32_ms = ops / FP32_FLOPS * 1e3
    if dtype == torch.bfloat16:
        ops_ms, route = ops / BF16_FLOPS * 1e3, "the FLOPs at bf16's 989 " \
            "TFLOP/s (dense)"
    else:
        ops_ms = SPLIT_TF32_TERMS * ops / TF32_FLOPS * 1e3
        route = "split TF32: 3 x the FLOPs at 495 TFLOP/s"
    ms = time_ms(bwd, iters=iters)
    row = {
        "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "KH": KH, "Dh": Dh,
                  "causal": causal, "window": window,
                  "dtype": str(dtype)[6:]},
        "ms": ms, "cold_ms": cold_ms(bwd, dev, iters=min(50, 5 * iters)),
        "kernel_ms": {name: time_ms(launch, iters=iters)
                      for name, launch in launches},
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_route": route,
        "bound_ops_ms": ops_ms, "bound_fp32_cuda_core_ms": fp32_ms,
        "bound_bytes_ms": bytes_ms, "bound_flops": ops,
        "bound_share": max(bytes_ms, ops_ms) / ms,
        "unmasked_pairs_per_head": pairs,
        **sdpa_backward(q, k, v, dout, causal, mask)}
    del q, k, v, dout, out, lse, launches
    torch.cuda.empty_cache()
    return row


def attention_bwd_report(dev, shape, n_bwd, err, floor, main_path, steps,
                         dtype=torch.float32, positions=None):
    """K3's backward row at one main path's shape (smollm-135m's training
    path's, B 8 x S 256, or its federated one's, B 4 x S 128; qwen2-vl's
    or musicgen's training path's, B 8 x S 256 after the stub prefix;
    chatglm3-6b's and train_4k's; fp32 or bf16): ``k3_bwd_times`` with the
    launches that path made in its ``steps`` steps, the error phase 6
    found at that shape and the plain backward's ms (in bf16 the plain
    version of the bf16 kernels' arithmetic, ``flash_attention_bwd_bf16_ref``;
    it and the kernels at train_4k's size are timed over fewer calls).
    ``positions``: explicit (Sq,) positions of both sides (the position
    instantiations)."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ref
    causal, window = shape[6], shape[7]
    pos = ({} if positions is None else
           dict(q_positions=positions, kv_positions=positions))
    big = shape[0] * shape[1] * shape[2] * shape[3] >= 2**28
    q, k, v, dout = _bwd_inputs(shape, dev, dtype=dtype)
    out, lse = k3._launch(q, k, v, causal, window, with_lse=True, **pos)
    plain = (ref.flash_attention_bwd_bf16_ref if dtype == torch.bfloat16
             else ref.flash_attention_bwd_ref)
    plain_ms = time_ms(lambda: plain(
        q, k, v, out, lse, dout, causal=causal, window=window, **pos),
        iters=1 if big else 5, reps=3 if big else 5)
    plan = k3.backward_plan(*shape, k3._sm_count(dev), dtype)
    bf16 = dtype == torch.bfloat16
    tol = BWD_BF16_TOL if bf16 else BWD_TOL
    design = (
        "one bf16 wgmma a product (S^T, dP^T, dV, dK in the dK/dV kernel; "
        "S, dP, dQ in the dQ kernel) on TMA-landed swizzled tiles, P and dS "
        "rounded to bf16 as register A operands, Q/dO/K read MN-major by "
        "the descriptor's transpose; a producer warpgroup (24 registers "
        "by setmaxnreg) and two consumer warpgroups (240): dK/dV's share a "
        "block's 64 keys and take alternate 64-query steps, dQ's own 64 "
        "folded rows each; dK/dV split over the steps when one block a "
        "key tile would leave SMs idle, the partials summed in split order; "
        "D = rowsum(dO*O); no atomics" if bf16 else
        "split-TF32 wgmma for every product (S^T, dP^T, dV, dK "
        "in the dK/dV kernel; S, dP, dQ in the dQ kernel), two "
        "warpgroups a block sharing its K/V (dK/dV) or Q/dO (dQ) "
        "and streaming their own half of the tiles by cp.async; "
        "dK/dV split over the (head, query tile) steps when one "
        "block a key tile would leave SMs idle, the partials "
        "summed in split order; D = rowsum(dO*O); no atomics")
    return {
        "name": "flash_attention_bwd (bf16)" if bf16 else
                "flash_attention_bwd",
        "route": "cuda", "main_path": main_path,
        "design": design,
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd"
                  + ("_bf16.cu" if bf16 else ".cu"),
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "replaces_note": "K3 has no backward on the TPU: the reference "
                         "differentiates chunked_attention "
                         "(src/repro/models/attention.py:33) under "
                         "jax.checkpoint",
        "launches": sum(n_bwd.values()), "launches_by_kernel": n_bwd,
        "launches_per_step": sum(n_bwd.values()) // steps,
        "splits": plan["splits"], "dkdv_blocks": plan["dkdv_blocks"],
        "dq_blocks": plan["dq_blocks"],
        "max_abs_err": err[0], "atol": tol, "rtol": tol,
        "max_excess_over_rtol": err[1],
        "tolerance_note": "|d| <= atol + rtol·|plain|, i.e. max_excess_"
                          "over_rtol = max(|d| − rtol·|plain|) <= atol; "
                          "against the float64 plain backward"
                          + ("; and max|d| <= 2 x the plain bf16 version's "
                             "+ 1e-4" if bf16 else ""),
        **k3_bwd_times(dev, shape, dtype=dtype, iters=3 if big else 20,
                       positions=positions),
        "plain_ms": plain_ms,
        "back_to_back_ms": back_to_back_ms(lambda: k3._launch_backward(
            q, k, v, out, lse, dout, causal, window, **pos),
            iters=5 if big else 50),
        "forward_lse_ms": time_ms(lambda: k3._launch(q, k, v, causal, window,
                                                     with_lse=True, **pos)),
        "forward_serving_ms": time_ms(lambda: k3._launch(q, k, v, causal,
                                                         window, **pos)),
        "positions": None if positions is None else "explicit",
        "floor_ms": floor}


def attention_bf16_report(dev, shape, n3, err, floor, main_path):
    """K3's bf16 serving forward's row at a main path's ``shape``
    (starcoder2-15b's prefill under its window), with the launches ``n3``
    that path made and the error ``err`` phase 6 found there: its ms
    beside the plain bf16 version's, the bound (the unmasked pairs' 4·Dh
    FLOPs at bf16's 989 TFLOP/s, or the bf16 bytes of q, k, v read and o
    written at 3.35 TB/s) and SDPA in bf16 on the same inputs (K and V
    repeated to H heads and, under a window, the window's boolean mask,
    which the memory-efficient backend takes; without one ``is_causal``,
    which the flash and cuDNN backends take too)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import _attention_mask, flash_attention_ref
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    q, k, v = _attn_inputs(shape, torch.bfloat16, dev)
    mask = _attention_mask(Sq, Skv, causal, window, dev)
    pairs = int(mask.sum())
    ops = 4 * Dh * pairs * B * H
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    G = H // KH
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2)
              for t in (k, v))

    def sdpa():
        if not window:
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_FLOPS * 1e3
    return {
        "name": "flash_attention (bf16)", "route": "cuda",
        "design": "one bf16 wgmma a product: S = Q.K^T from TMA-landed "
                  "swizzled tiles (m64n128), P rounded to bf16 as the "
                  "register A operand of O += P.V, V read MN-major; two "
                  "consumer warpgroups of 64 folded rows, a producer warp, "
                  "128-key tiles",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "main_path": main_path, "launches": n3, "max_abs_err": err,
        "tolerance": ATTN_TOL[torch.bfloat16],
        "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "KH": KH, "Dh": Dh,
                  "causal": causal, "window": window, "dtype": "bfloat16"},
        "unmasked_pairs_per_head": pairs,
        "ms": time_ms(lambda: k3._launch(q, k, v, causal, window), iters=5),
        "cold_ms": cold_ms(lambda: k3._launch(q, k, v, causal, window), dev,
                           iters=10),
        "training_forward_ms": time_ms(lambda: k3._launch(
            q, k, v, causal, window, with_lse=True), iters=5),
        "plain_ms": time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), iters=1, reps=3),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_route": "the FLOPs at bf16's 989 TFLOP/s (dense)",
        "bound_bytes_ms": bytes_ms, "bound_flops": ops,
        "floor_ms": floor, "library_ms": time_ms(sdpa, iters=3, reps=5),
        "library_note": "SDPA in bf16, K/V repeated to H heads, "
                        + ("the window's boolean attn_mask" if window else
                           "is_causal"),
        "library_backend": sdpa_backends(sdpa)}


def sdpa_backward(q, k, v, dout, causal, mask=None) -> dict:
    """SDPA's backward on the same inputs, timed only: forward and
    backward less the forward, with K and V repeated to H heads (so every
    backend that takes fp32 applies), under each backend in turn and
    unrestricted (``library_ms``); with ``mask`` (Sq, Skv) bool, that mask
    instead of ``is_causal`` (explicit positions)."""
    import warnings
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
              .requires_grad_() for t in (k, v))
    dt = dout.transpose(1, 2).contiguous()

    def fwd():
        if mask is not None:
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    def both():
        return torch.autograd.grad(fwd(), (qt, kt, vt), dt)

    def backward_ms():
        return (time_ms(both, iters=5, reps=5)
                - time_ms(fwd, iters=5, reps=5))

    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # why each one refuses
                times[backend.name] = backward_ms()
        except RuntimeError:
            times[backend.name] = None
    return {"library_ms": backward_ms(), "library_backward_ms": times,
            "library_note": "SDPA forward + backward less its forward, K/V "
                            "repeated to H heads"}


def lm_mix_times(dev, n2) -> dict:
    """K2 at the federated LM mix's widest leaf: smollm-135m's (49,152,
    576) embedding, M = 3 neighbours, as ``mix_params_with_erasures``
    calls it (neighbour rows read in place from the (C, ...) stack). Held
    to its plain version within ``AGG_TOL`` (max|d|/(1+|ref|)), links up
    and all erased; raises past it."""
    from repro_torch.kernels import weighted_agg as k2
    from repro_torch.kernels.ref import weighted_agg_ref
    P = 49_152 * 576
    g = torch.Generator(device=dev).manual_seed(3)
    stack = torch.randn((FED_C, P), generator=g, device=dev)
    w = torch.full((FED_C - 1,), 1.0 / (FED_C - 1), device=dev)
    own, nb = stack[0], stack[1:]
    tol = AGG_TOL[torch.float32]
    errs = {}
    for any_ok in (True, False):
        ok = torch.tensor(any_ok, device=dev)
        out = k2.weighted_agg(own, nb, w, 0.5, any_ok=ok)
        expect = weighted_agg_ref(own, nb, w, 0.5, any_ok=ok)
        diff = (out - expect).abs()
        errs[any_ok] = float(diff.max())
        rel = float((diff / (1 + expect.abs())).max())
        print(f"K2 LM mix M={FED_C - 1} P={P} any_ok={any_ok}: max|d|="
              f"{errs[any_ok]:.3g} max|d|/(1+|ref|)={rel:.3g} tol={tol:g}")
        if not rel <= tol:
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"the LM mix (any_ok={any_ok}): {rel}")
        if not any_ok and not torch.equal(out, own):
            raise AssertionError("K2 with every link erased must return "
                                 "own unchanged")
    ok = torch.tensor(True, device=dev)
    M = FED_C - 1
    bytes_ms = ((M + 2) * P * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = (2 * M + 3) * P / FP32_FLOPS * 1e3
    return {"shape": {"M": M, "P": P, "dtype": "float32"},
            "launches": n2, "max_abs_err": errs[True],
            "max_abs_err_all_erased": errs[False], "tolerance": tol,
            "ms": time_ms(lambda: k2._launch(own, nb, w, 0.5, None, ok, M)),
            "plain_ms": time_ms(lambda: weighted_agg_ref(own, nb, w, 0.5,
                                                         any_ok=ok)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(lambda: torch.addmv(
                own, nb.T, w, beta=0.5, alpha=0.5))}


def sdpa_backends(fn) -> dict:
    """Which SDPA backends run ``fn`` when restricted to each in turn, with
    each one's steady ms; ``default`` names the one whose time the
    unrestricted call matches (the backend the library time measured)."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # why each one refuses
                times[backend.name] = time_ms(fn, iters=5, reps=5)
        except RuntimeError:
            times[backend.name] = None
    ran = {k: v for k, v in times.items() if v is not None}
    default = time_ms(fn, iters=5, reps=5)
    pick = min(ran, key=lambda k: abs(ran[k] - default)) if ran else None
    return {"default": pick, "default_ms": default, "restricted_ms": times}


def profile_rounds(sim) -> None:
    """One block of two pFedWN rounds under ``torch.profiler``: device time
    by round phase (the engine's ``fedsim.*`` ranges) and by kernel, and the
    device's busy share of the wall time."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sim.sim = dataclasses.replace(sim.sim, rounds=2, eval_every=2)
    sim.run("pfedwn")                         # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run("pfedwn")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # kernels only: operator rows repeat their kernels' time, and the
    # fedsim.* device rows are spans that include idle gaps
    busy_ms = sum(e.self_device_time_total for e in avgs
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("fedsim.")) / 1e3
    print(f"profile: 2 rounds + evals, wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for e in sorted(avgs, key=lambda e: e.key):
        if not e.key.startswith("fedsim."):
            continue
        if e.device_type == DeviceType.CUDA:   # first to last kernel
            print(f"  {e.key}: device span {e.device_time_total / 1e3:.1f}"
                  f" ms over {e.count} calls (idle gaps included)")
        else:   # backward kernels run on autograd's thread, not counted
            print(f"  {e.key}: host {e.cpu_time_total / 1e3:.1f} ms over "
                  f"{e.count} calls")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20,
                     max_name_column_width=60))


def profile_serve(dev, cfg, params, prompts) -> None:
    """The serving main path under ``torch.profiler``: one whole serve (the
    device's busy share, the ``serve.prefill`` and ``serve.decode`` ranges,
    kernels by device time), then one decode step alone (its kernels and
    the device's share of its wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import prefill_to_cache, serve, stub_prefix
    from repro_torch.models.model import decode

    def kernels(avgs):
        rows = [e for e in avgs if e.device_type == DeviceType.CUDA
                and not e.key.startswith("serve.")]
        return (sum(e.count for e in rows),
                sum(e.self_device_time_total for e in rows) / 1e3)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = serve(cfg, params, prompts, SERVE_GEN, device=dev)
    avgs = prof.key_averages()
    n_kernels, busy_ms = kernels(avgs)
    t = res.timings
    wall_ms = t["prefill_ms"] + t["decode_ms_per_step"] * (SERVE_GEN - 1)
    print(f"profile: one serve, wall {wall_ms:.1f} ms (prefill "
          f"{t['prefill_ms']:.1f}, decode {t['decode_ms_per_step']:.3f} per "
          f"step, under the profiler), {n_kernels} kernels, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for e in sorted(avgs, key=lambda e: e.key):
        if e.key.startswith("serve.") and e.device_type == DeviceType.CUDA:
            print(f"  {e.key}: device span {e.device_time_total / 1e3:.1f}"
                  f" ms (idle gaps included)")
        elif e.key.startswith("serve."):
            print(f"  {e.key}: host {e.cpu_time_total / 1e3:.1f} ms")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20,
                     max_name_column_width=60))

    P = prompts.shape[1] + cfg.n_stub_tokens
    with torch.no_grad():
        logits, cache = prefill_to_cache(
            params, cfg, prompts, P + SERVE_GEN,
            stub_embeds=stub_prefix(cfg, prompts.shape[0], dev))
        token = torch.argmax(logits, dim=-1)[:, None]
        decode(params, cfg, token, cache, P)                 # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode(params, cfg, token, cache, P + 1)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
    n_kernels, busy_ms = kernels(prof.key_averages())
    print(f"profile: one decode step, wall {step_ms:.2f} ms under the "
          f"profiler, {n_kernels} kernels, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / step_ms:.1f} %)")


def profile_train(dev) -> None:
    """One full-width smollm-135m training step (B 8 x S 256, SGD) under
    ``torch.profiler``, after a warm step: its wall time, kernels and the
    device's busy share, and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import token_batch_stream
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models.model import init_params
    from repro_torch.optim import sgd_update
    cfg = get_config("smollm-135m")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    stream = token_batch_stream(0, batch=TRAIN_B, seq_len=TRAIN_S,
                                vocab=cfg.vocab)

    def step(p):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(stream).items()}
        _, _, grads = value_and_grad(p, cfg, batch)
        return sgd_update(p, grads, TRAIN_LR)

    params = step(params)                                 # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params = step(params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    rows = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"profile: one training step, wall {wall_ms:.1f} ms under the "
          f"profiler, {sum(e.count for e in rows)} kernels, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20,
                     max_name_column_width=60))


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile two pFedWN rounds, a serving "
                        "run of smollm-135m, minicpm3-4b, granite-moe-"
                        "3b-a800m, falcon-mamba-7b, zamba2-7b, qwen2-vl-2b "
                        "and musicgen-large and one training step and print "
                        "where the device time goes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch import disable_tf32
    from repro_torch.kernels import _build

    _phase("1. card")
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card_line)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    disable_tf32()
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)

    _phase("2. build")
    secs = _build.build()             # every kernel, one nvcc each, together
    print(f"built {', '.join(_build.KERNELS)} in {secs:.1f} s")

    _phase("3. K1 em_posterior vs plain")
    check_em_posterior(dev)
    _phase("4. K2 weighted_agg vs plain")
    err2 = check_weighted_agg(dev)

    _phase("5. pfedwn round: small run vs CPU, then the main path, then "
           "a cifar100-cnn round")
    check_small_run_against_cpu(dev)
    t0 = time.perf_counter()
    _, n1, n2, sim = run_main_path(dev)
    print(f"main path wall {time.perf_counter() - t0:.1f} s, launches "
          f"K1={n1} K2={n2}")
    if (sim.m, sim.sim.em_subset, sim.model_cfg.n_classes) != EM_MAIN:
        raise AssertionError("EM_MAIN is not the main path's K1 shape")
    t0 = time.perf_counter()
    n1_c100, n2_c100, p_c100 = run_cifar100_main_path(dev)
    print(f"cifar100-cnn main path wall {time.perf_counter() - t0:.1f} s")

    _phase("5b. local and the four baselines at full width")
    t0 = time.perf_counter()
    ms, base_sim = run_baselines_main_path(dev)
    print(f"baselines wall {time.perf_counter() - t0:.1f} s; ms per round "
          f"after the first block: {json.dumps(ms)}")
    check_baselines_full_width(base_sim)

    _phase("5c. pfedwn past 32 neighbours: small run vs CPU, then M = 39 "
           "at full width")
    check_wide_small_against_cpu(dev)
    t0 = time.perf_counter()
    wide_hist, n1_wide, n2_wide, wide_sim = run_wide_main_path(dev)
    print(f"M = {wide_sim.m} main path wall {time.perf_counter() - t0:.1f} "
          f"s, launches K1={n1_wide} K2={n2_wide}")

    _phase("5d. legacy engine: small run vs fused, then ms per round")
    check_legacy_against_fused(dev)
    t0 = time.perf_counter()
    engines = time_legacy_and_fused(dev)
    print(f"engines wall {time.perf_counter() - t0:.1f} s; ms per round: "
          f"{json.dumps(engines)}")

    _phase("5e. RunRecord: small run card vs CPU, syncs, taps on/off at "
           "full width")
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        check_run_record(dev, tmp)
        check_record_syncs(dev, tmp)
    t0 = time.perf_counter()
    taps = time_taps(dev)
    print(f"taps wall {time.perf_counter() - t0:.1f} s; pfedwn ms per "
          f"round, taps on and off (medians of 5 interleaved runs): "
          f"{json.dumps(taps)}")

    _phase("5f. sharded engine: small run vs fused, pfedwn at full width "
           "over D = 1, 2, 4, pod_mix")
    t0 = time.perf_counter()
    check_sharded_small(dev)
    spread = fused_spread(dev, wide_hist, wide_sim)
    sharded = run_sharded_wide(dev, wide_hist, wide_sim, spread)
    pod_k2 = check_pod_mix(dev)
    print(f"sharded wall {time.perf_counter() - t0:.1f} s")

    _phase("6. K3 flash_attention vs plain, forward and backward")
    err3 = check_flash_attention(dev)
    err3_bwd = check_flash_attention_backward(dev)
    err3_bf16 = check_flash_attention_backward_bf16(dev)
    err3_pos, err3_pos_bf16, err3_pos_dims = \
        check_flash_attention_positions(dev)
    check_dh192_fp32_positions(dev)

    _phase("7. serving: small runs vs CPU, then the main paths (smollm-135m, "
           "then minicpm3-4b's MLA at full width)")
    check_serve_against_cpu(dev)
    t0 = time.perf_counter()
    _, n3, serve_args = run_serve_main_path(dev)
    print(f"serving main path wall {time.perf_counter() - t0:.1f} s (warm-up "
          f"run included), launches K3={n3}")
    n3_small_mla = check_mla_serve_against_cpu(dev)
    t0 = time.perf_counter()
    _, n3_mla, mla_args = run_mla_main_path(dev)
    print(f"MLA serving main path wall {time.perf_counter() - t0:.1f} s "
          f"(warm-up run and the P + 1 prefill included), launches "
          f"K3={n3_mla}")
    if args.profile:
        profile_serve(dev, *mla_args)
    del mla_args                      # 17 GB of weights
    torch.cuda.empty_cache()

    _phase("7c. MoE serving: reduced granite-moe and deepseek-v3 vs CPU, "
           "free of drops and dropping, then granite-moe at full width")
    n3_small_moe = check_moe_serve_against_cpu(dev)
    t0 = time.perf_counter()
    _, n3_moe, moe_args = run_moe_main_path(dev)
    small = ", ".join(f"{a} {c} {n}" for (a, c), n in n3_small_moe.items())
    print(f"MoE serving main path wall {time.perf_counter() - t0:.1f} s "
          f"(warm-up run and the routing-recorded prefill included), "
          f"launches K3={n3_moe}; reduced runs' K3 launches: {small}")
    if args.profile:
        profile_serve(dev, *moe_args)
    del moe_args                      # 13.5 GB of weights
    torch.cuda.empty_cache()

    _phase("7d. SSM serving: reduced falcon-mamba and zamba2 vs CPU, then "
           "each at full width")
    n3_small_ssm = check_ssm_serve_against_cpu(dev)
    ssm_main = {}
    for arch in SSM_ARCHS:            # ~29 and ~27 GB of weights, in turn
        t0 = time.perf_counter()
        ssm_main[arch] = run_ssm_main_path(dev, arch, args.profile)
        torch.cuda.empty_cache()
        print(f"{arch} serving main path wall {time.perf_counter() - t0:.1f}"
              f" s (warm-up run and the P + 1 prefill included), launches "
              f"K3={ssm_main[arch][1]}")
    small = ", ".join(f"{a} window {w} {n}"
                      for (a, w), n in n3_small_ssm.items())
    print(f"reduced SSM runs' K3 launches: {small}")

    _phase("7e. stub-prefix families: reduced qwen2-vl and musicgen vs CPU "
           "(serving, M-RoPE positions, gradients), then each at full width "
           "(serving, training steps)")
    stub_small = check_stub_families_against_cpu(dev)
    stub_main = {}
    for arch in STUB_ARCHS:           # ~7 and ~13 GB of weights, in turn
        t0 = time.perf_counter()
        stub_main[arch] = run_stub_main_path(dev, arch, args.profile)
        print(f"{arch} main paths wall {time.perf_counter() - t0:.1f} s "
              f"(warm-up serve, the P + 1 prefill and the training steps "
              f"included)")
    small = ", ".join(f"{a} {r} {n}" for (a, r), n in stub_small.items())
    print(f"reduced stub-prefix runs' K3 launches: {small}")

    _phase("7f. family training: reduced granite-moe, deepseek-v3, "
           "minicpm3-4b, falcon-mamba and zamba2 vs CPU (federated rounds "
           "of granite-moe and zamba2), then granite-moe, minicpm3-4b, "
           "falcon-mamba and zamba2 at full width")
    family_small = {arch: check_train_against_cpu(
        dev, arch, fed=arch in FAMILY_FED_ARCHS) for arch in FAMILY_ARCHS}
    family_main = {}
    for arch in FAMILY_FULL:          # 13.5 to 29 GB of weights, in turn
        t0 = time.perf_counter()
        family_main[arch] = run_family_train_main_path(dev, arch)
        print(f"{arch} training main path wall "
              f"{time.perf_counter() - t0:.1f} s")

    _phase("7g. dense configs at full width and the step builders: reduced "
           "chatglm3-6b and starcoder2-15b in bf16 vs CPU, chatglm3-6b fp32 "
           "serving and training (and bf16 training), the four step "
           "builders in bf16 at its width, starcoder2-15b bf16 serving")
    t0 = time.perf_counter()
    dense_small = check_dense_bf16_against_cpu(dev)
    print(f"7g card vs CPU wall {time.perf_counter() - t0:.1f} s; K3 "
          f"launches {dense_small}")
    t0 = time.perf_counter()
    glm = run_glm_main_path(dev)
    print(f"chatglm3-6b main paths wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    builders = run_step_builders(dev)
    print(f"step builders wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    star = run_starcoder2_main_path(dev)
    print(f"starcoder2-15b main path wall {time.perf_counter() - t0:.1f} s")

    _phase("7b. LM training: small run vs CPU, then single-client and "
           "federated at full width")
    check_train_against_cpu(dev)
    t0 = time.perf_counter()
    trained = run_train_main_path(dev)
    print(f"training main path wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fed = run_fed_main_path(dev)
    print(f"federated main path wall {time.perf_counter() - t0:.1f} s")

    _phase("7h. pfedwn round step: reduced smollm-135m card vs CPU at C = 4 "
           "(C = 2 is tests/test_torch_gpu.py's), then smollm-135m bf16 at "
           "full width over C = 4 ranks, and K2 at its mix")
    t0 = time.perf_counter()
    round_small = {str(k)[6:]: v for k, v in
                   check_round_step_against_cpu(dev).items()}
    print(f"7h card vs CPU wall {time.perf_counter() - t0:.1f} s; worst "
          f"gaps {json.dumps(round_small)}")
    t0 = time.perf_counter()
    rounds = run_round_main_path(dev)
    print(f"round step main path wall {time.perf_counter() - t0:.1f} s")

    _phase("7i. the MoE, MLA, SSM, hybrid and stub-prefix families in bf16: "
           "reduced vs CPU (deepseek-v3 too), then granite-moe, minicpm3-4b, "
           "falcon-mamba, zamba2 and qwen2-vl (M-RoPE) at full width")
    t0 = time.perf_counter()
    bf16_small = check_families_bf16_against_cpu(dev)
    print(f"7i card vs CPU wall {time.perf_counter() - t0:.1f} s; K3 "
          f"launches {bf16_small}")
    bf16_main = {}
    for arch in BF16_FAMILY_FULL:
        t0 = time.perf_counter()
        bf16_main[arch] = run_family_bf16_main_path(dev, arch)
        print(f"{arch} bf16 main paths wall {time.perf_counter() - t0:.1f} s")

    _phase("7j. the dry run: every arch x shape on the meta device, then "
           "smollm-135m train_4k on the card (--run), kernel FLOPs card vs "
           "meta")
    dry = run_dryrun_sweep(dev, DRYRUN_OUT)

    _phase("7k. deepseek-v3-671b at its published widths: reduced with the "
           "MLA head dims 128/64/128 (K3 at Dh 192) vs CPU, fp32 and bf16, "
           "and explicit-position training at Dh 48, 96, 112 and 192; then "
           f"n_layers {DS_LAYERS} at full width: bf16 serve, "
           f"{DS_TRAIN_STEPS} bf16 steps, fp32 serve; then n_layers "
           f"{DS_FP32_LAYERS}: {DS_TRAIN_STEPS} fp32 steps")
    t0 = time.perf_counter()
    ds_small = check_deepseek_full_heads_against_cpu(dev)
    print(f"7k card vs CPU wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ds_main = run_deepseek_full_main_path(dev)
    print(f"deepseek-v3 main paths wall {time.perf_counter() - t0:.1f} s")

    _phase("8. kernel times")
    print(f"empty event bracket: {cold_ms(lambda: None, dev):.6f} ms")
    floor = floor_ms(dev)
    print(f"floor (1-element zero_, steady bracket): {floor:.6f} ms")
    rows = [k1_report(dev, n1, n1_wide, floor, n1_c100),
            agg_report(dev, sim, n2, err2, wide_sim, n2_wide, floor),
            attention_report(dev, ATTN_MAIN, n3, err3[ATTN_MAIN], floor,
                             "serve smollm-135m"),
            attention_bwd_report(dev, BWD_MAIN, trained["k3_backward"],
                                 err3_bwd[BWD_MAIN], floor, "train",
                                 TRAIN_STEPS),
            attention_bwd_report(dev, BWD_FED, fed["k3_backward"],
                                 err3_bwd[BWD_FED], floor, "federated",
                                 FED_ROUNDS * FED_C * FED_LOCAL),
            attention_report(dev, ATTN_MLA, n3_mla, err3[ATTN_MLA], floor,
                             "serve minicpm3-4b (MLA)"),
            attention_report(dev, ATTN_MLA_SMALL, n3_small_mla,
                             err3[ATTN_MLA_SMALL], floor,
                             "serve reduced minicpm3-4b (MLA), card vs "
                             "CPU"),
            attention_report(dev, ATTN_GRANITE, n3_moe, err3[ATTN_GRANITE],
                             floor, "serve granite-moe-3b-a800m (MoE)"),
            attention_report(dev, ATTN_SSM, ssm_main["zamba2-7b"][1],
                             err3[ATTN_SSM], floor,
                             "serve zamba2-7b (hybrid: the shared attention "
                             "block, 13 applications)")]
    rows[-1]["launches_falcon_mamba"] = ssm_main["falcon-mamba-7b"][1]
    qwen, musicgen = stub_main["qwen2-vl-2b"], stub_main["musicgen-large"]
    rows += [
        attention_report(dev, ATTN_QWEN2VL, qwen["k3"], err3[ATTN_QWEN2VL],
                         floor, "serve qwen2-vl-2b (256 stub patches, G 6, "
                         "Dh 128)"),
        attention_report(dev, ATTN_MUSICGEN, musicgen["k3"],
                         err3[ATTN_MUSICGEN], floor, "serve musicgen-large "
                         "(64 stub frames, G 1, Dh 64)"),
        attention_positions_report(dev, ATTN_QWEN2VL, qwen["k3_positions"],
                                   err3_pos, floor, "prefill qwen2-vl-2b "
                                   "under M-RoPE positions"),
        attention_bwd_report(dev, BWD_QWEN2VL, qwen["k3_backward"],
                             err3_bwd[BWD_QWEN2VL], floor,
                             "train qwen2-vl-2b", STUB_TRAIN_STEPS),
        attention_bwd_report(dev, BWD_MUSICGEN, musicgen["k3_backward"],
                             err3_bwd[BWD_MUSICGEN], floor,
                             "train musicgen-large", STUB_TRAIN_STEPS),
        attention_bwd_report(dev, BWD_MINICPM,
                             family_main["minicpm3-4b"]["k3_backward"],
                             err3_bwd[BWD_MINICPM], floor,
                             "train minicpm3-4b (MLA, Dh 96)", FAMILY_STEPS),
        attention_bwd_report(dev, BWD_ZAMBA2,
                             family_main["zamba2-7b"]["k3_backward"],
                             err3_bwd[BWD_ZAMBA2], floor,
                             "train zamba2-7b (the shared attention block, "
                             "Dh 112)", FAMILY_STEPS),
        attention_bwd_report(dev, BWD_MLA_SMALL, family_small["minicpm3-4b"],
                             err3_bwd[BWD_MLA_SMALL], floor,
                             "train reduced minicpm3-4b (MLA, Dh 48), card "
                             "vs CPU", 3),
        attention_bf16_report(dev, ATTN_STARCODER, star["k3"],
                              err3[(ATTN_STARCODER, "bf16")], floor,
                              "serve starcoder2-15b (bf16, window 4096)"),
        attention_bwd_report(dev, BWD_CHATGLM, glm["float32"]["k3_backward"],
                             err3_bwd[BWD_CHATGLM], floor,
                             "train chatglm3-6b (fp32, G 16)", GLM_STEPS),
        attention_bwd_report(dev, BWD_CHATGLM,
                             glm["bfloat16"]["k3_bf16_backward"],
                             err3_bf16[BWD_CHATGLM], floor,
                             "train chatglm3-6b (bf16, G 16)",
                             GLM_BF16_STEPS, dtype=torch.bfloat16),
        attention_bwd_report(dev, BWD_TRAIN_4K,
                             builders["train_4k"]["k3_bf16_backward"],
                             err3_bf16[BWD_TRAIN_4K], floor,
                             "make_train_step chatglm3-6b at train_4k (bf16, "
                             "global_batch cut to 2)", BUILDER_TRAIN_STEPS,
                             dtype=torch.bfloat16)]
    rows += [
        k2_round_report(dev, rounds["k2"], rounds["k2_per_rank"], floor),
        attention_bf16_report(dev, ATTN_ROUND_TRAIN, rounds["k3_forward"],
                              err3[(ATTN_ROUND_TRAIN, "bf16")], floor,
                              "pfedwn round step smollm-135m (bf16, C 4 "
                              "ranks): the local step's forward at this "
                              "shape and the probe's C a round at (2, 512); "
                              "launches over ranks and rounds"),
        attention_bwd_report(dev, ATTN_ROUND_TRAIN,
                             rounds["k3_bf16_backward"],
                             err3_bf16[ATTN_ROUND_TRAIN], floor,
                             "pfedwn round step smollm-135m (bf16, C 4 "
                             "ranks): the local step; launches over ranks "
                             "and rounds", rounds["steps"],
                             dtype=torch.bfloat16)]
    qwen_pos = _mrope_layout(256, BWD_QWEN2VL[1] - 256, dev)[:, 0]
    rows += [
        attention_bwd_report(dev, BWD_MINICPM,
                             bf16_main["minicpm3-4b"]["k3_bf16_backward"],
                             err3_bf16[BWD_MINICPM], floor,
                             "train minicpm3-4b (bf16, MLA, Dh 96)",
                             BF16_FAMILY_STEPS, dtype=torch.bfloat16),
        attention_bwd_report(dev, BWD_ZAMBA2,
                             bf16_main["zamba2-7b"]["k3_bf16_backward"],
                             err3_bf16[BWD_ZAMBA2], floor,
                             "train zamba2-7b (bf16, the shared attention "
                             "block, Dh 112)", BF16_FAMILY_STEPS,
                             dtype=torch.bfloat16),
        attention_bwd_report(dev, BWD_QWEN2VL,
                             bf16_main["qwen2-vl-2b"]["k3_bf16_backward"],
                             (err3_pos_bf16, None), floor,
                             "train qwen2-vl-2b (bf16, M-RoPE positions, "
                             "Dh 128)", BF16_FAMILY_STEPS,
                             dtype=torch.bfloat16,
                             positions=qwen_pos.contiguous())]
    rows[-1]["name"] = "flash_attention_bwd (bf16, positions)"
    # deepseek-v3's MLA at Dh 192 (phase 7k): K3's bf16 forward, bf16
    # backward, fp32 forward and fp32 backward at its full-width shapes
    rows += [
        attention_bf16_report(dev, ATTN_DS, ds_main["bf16"]["k3"],
                              err3[(ATTN_DS, "bf16")], floor,
                              f"serve deepseek-v3-671b (bf16, n_layers "
                              f"{DS_LAYERS} of 61, MLA at Dh 192)"),
        attention_bwd_report(dev, BWD_DS,
                             ds_main["train"]["k3_bf16_backward"],
                             err3_bf16[BWD_DS], floor,
                             f"make_train_step deepseek-v3-671b (bf16, "
                             f"n_layers {DS_LAYERS} of 61, MLA at Dh 192)",
                             DS_TRAIN_STEPS, dtype=torch.bfloat16),
        attention_report(dev, ATTN_DS, ds_main["fp32"]["k3"],
                         err3[ATTN_DS], floor,
                         f"serve deepseek-v3-671b (fp32, n_layers "
                         f"{DS_LAYERS} of 61, MLA at Dh 192)"),
        attention_bwd_report(dev, BWD_DS,
                             ds_main["train32"]["k3_backward"],
                             err3_bwd[BWD_DS], floor,
                             f"make_train_step deepseek-v3-671b (fp32, "
                             f"n_layers {DS_FP32_LAYERS} of 61: the dense "
                             f"prefix and the MTP block, MLA at Dh 192)",
                             DS_TRAIN_STEPS)]
    rows[-1]["design"] = (
        "Dh 192: split-TF32 wgmma; D as at the other dims; dK/dV "
        "(attn_bwd_dkdv_wide_kernel) and dQ (attn_bwd_dq_wide_kernel) split "
        "each 16-query (16-key) step by product between their two "
        "warpgroups: one computes S^T (S) from K (Q) and hands P to the "
        "other through shared memory, the other computes dP^T (dP) from V "
        "(dO), forms dS and hands it back, so each product runs once; the "
        "block's own operands stay raw in shared memory (rows padded by 4 "
        "floats) and are split in registers as the A operand, 32 head-dim "
        "columns a part, two parts in flight; dK/dV: warpgroup 0 sums all "
        "192 columns of dK, warpgroup 1 of dV (m64n64k8, two products in "
        "flight); dQ: each half the columns; dK/dV blocks head-major, dQ's "
        "query tile slowest; 222 KB and 198 KB of shared memory, one "
        "block a SM; no atomics")
    rows[-1]["resources"] = _kernel_resources(
        _build.resources("flash_attention_bwd"),
        ("attn_bwd_dot_kernel<(int)192>", "attn_bwd_dkdv_wide_kernel",
         "attn_bwd_dq_wide_kernel"))
    rows[-4]["design"] = (
        "Dh 192: a kernel of its own; a producer warpgroup (24 registers by "
        "setmaxnreg, the consumers 240) keeps two K and two V slots of "
        "112-key tiles in flight by TMA (the 128-byte swizzle, three "
        "64-column boxes a 384-byte row; Q by TMA too when G = 1); two "
        "consumer warpgroups of 64 folded rows issue tile i+1's S = Q.K^T "
        "(m64n112k16) and tile i's O += P.V (P the register A operand, "
        "m64n192k16) behind one fence and run tile i+1's softmax under "
        "P.V; blocks head-major, a head's last rows first")
    rows[-3]["design"] = (
        "Dh 192: D as at the other dims; dK/dV a kernel of its own: each "
        "consumer warpgroup computes S^T and dP^T for half of a 64-query "
        "step (m64n32k16), rounds P^T and dS^T to bf16 into shared memory, "
        "and after a barrier sums dV and dK for half the 192 columns over "
        "all 64 queries (m64n96k16, A from shared memory): S^T and dP^T "
        "once a step; dQ the other dims' kernel (m64n192k16, 2 stages) "
        "with its grid's axes swapped and Q and dO by TMA when G = 1; both "
        "head-major, key tile 0 and the last rows first; no atomics")
    rows[-4]["resources"] = _kernel_resources(
        _build.resources("flash_attention_bf16"),
        ("flash_attention_bf16_wide_kernel",))
    rows[-3]["resources"] = _kernel_resources(
        _build.resources("flash_attention_bwd_bf16"),
        ("attn_bwd_bf16_dot_kernel<(int)192>",
         "attn_bwd_bf16_dkdv_wide_kernel",
         "attn_bwd_bf16_dq_kernel<(int)192,"))
    rows[-2]["design"] = (
        "Dh 192: flash_attention_wide_kernel, split-TF32 wgmma; a producer "
        "warpgroup (40 registers by setmaxnreg, the consumers 232) lands "
        "raw 16-key K and V tiles by TMA (128-byte swizzle, two stages) and "
        "splits them into one K tile and one V^T tile, each freed on its "
        "own; two consumer warpgroups of 64 folded rows share them; Q stays "
        "raw in shared memory (rows padded by 16 floats) and is split in "
        "registers as the A operand of S (its columns permuted within each "
        "16 so that a thread's fragments of two k-steps are one 16-byte "
        "load), S in parts of 32 head-dim columns and P.V in 64-column "
        "products, each summed in fresh registers, two in flight; the row "
        "tile the grid's slowest axis, the last rows first")
    rows[-2]["resources"] = _kernel_resources(
        _build.resources("flash_attention"), ("flash_attention_wide_kernel",))
    # K3's backward with explicit positions at MLA's and zamba2's dims,
    # timed at the full-width training shapes of those dims under
    # positions POS_TRAIN_OFFSET.. (the launches: phase 7k's position
    # training at reduced(), B 2 x S 64; the errors: phase 6's M-RoPE
    # pattern at Dh 48, 96 and 112)
    for dh, shape, arch in ((48, BWD_MLA_SMALL, "deepseek-v3-671b"),
                            (96, BWD_MINICPM, "minicpm3-4b"),
                            (112, BWD_ZAMBA2, "zamba2-7b")):
        at = torch.arange(POS_TRAIN_OFFSET, POS_TRAIN_OFFSET + shape[1],
                          dtype=torch.int32, device=dev)
        for dtype, keys in ((torch.float32, ("dq", "dk", "dv")),
                            (torch.bfloat16, ("dq16", "dk16", "dv16"))):
            n_bwd, steps = ds_small[("positions", dh, str(dtype)[6:])]
            rows.append(attention_bwd_report(
                dev, shape, n_bwd,
                (max(err3_pos_dims[dh][k] for k in keys), None), floor,
                f"value_and_grad (fp32) or make_train_step (bf16) of reduced "
                f"{arch} at Dh {dh} with positions {POS_TRAIN_OFFSET}.., "
                f"card vs CPU", steps, dtype=dtype, positions=at))
            rows[-1]["name"] = ("flash_attention_bwd (positions)"
                                if dtype == torch.float32 else
                                "flash_attention_bwd (bf16, positions)")
    rows[1]["lm_mix"] = lm_mix_times(dev, fed["k2"])
    rows[1]["cifar100_round"] = {"launches": n2_c100, "P": p_c100}
    rows[2]["training_launches"] = {"single_client": trained["k3_forward"],
                                    "federated": fed["k3_forward"]}
    for row, j in ((rows[0], 0), (rows[1], 1)):   # phase 5f's main paths
        row["sharded_launches_per_rank"] = {
            d: [k[j] for k in r["k1_k2_per_rank"]]
            for d, r in sharded.items()}
    rows[1]["pod_mix_launches_per_rank"] = pod_k2
    if args.profile:
        _phase("9. profile")
        profile_rounds(sim)
        profile_serve(dev, *serve_args)
        profile_train(dev)
    torch.cuda.synchronize()
    _phase(None)
    print(card_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
