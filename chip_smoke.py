#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which stops the run on failure:
  1. print the card's name and power limit; turn TF32 off;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
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
     that each kernel carried it;
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
     chatglm3-6b, and shapes at the kernel's tile edges; then K3's
     backward (``csrc/flash_attention_bwd.cu``: split-TF32 ``wgmma``, dK/dV
     split over blocks where one a key tile leaves SMs idle, through the
     autograd path) against ``flash_attention_bwd_ref`` in float64 on the
     card over the reference's sweep, ragged shapes and tile edges, causal
     and window, G 1 to 16, Dh 64 and 128, smollm-135m's training (B 8, S
     256), federated (B 4, S 128) and serving (B 8, S 1024) shapes and
     fully masked rows (whose grads must be 0): two runs bitwise equal,
     the training forward's output bitwise the serving forward's, its row
     LSE against the plain one;
  7. serve a reduced smollm-135m on the card and on the CPU (plain
     kernels) with the same weights and prompts, without and with a window
     that wraps, and compare logits and tokens; then serve the main path at
     full width (smollm-135m, 8 prompts of 1024 tokens, 32 generated) and
     check that K3 carried every layer of the prefill;
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
  8. time each kernel, its plain version and the one-call PyTorch yardstick
     at the main paths' shapes (K1 also in bf16, at smollm-135m's
     vocabulary and at the M = 39 round's shape, K2 also from a
     16-byte-aligned stride, at M = 39 and at the federated LM mix, K3
     also in bf16, SDPA under each backend; K3's backward at the training
     and the federated shapes, each kernel's ms, the split-TF32, CUDA-core
     and bytes bounds, SDPA's backward under each backend that takes fp32)
     beside the card's floor (a 1-element ``zero_()`` in the same bracket)
     and print them as one JSON line;
  9. with ``--profile`` only: profile two pFedWN rounds, one serving run
     and one full-width training step with ``torch.profiler``.
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
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}      # K1 (test_kernels.py)
AGG_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}  # K2 (test_kernels.py)
ATTN_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}  # K3 (test_kernels.py)
SERVE_TOL = 1e-4             # card vs CPU logits, fp32 with TF32 off
# K1 shapes (M, T, V): the round's (cifar10-cnn, em_subset 512, M 10),
# the reference's sweep, then both sides of each team-size switch (V 1, 2,
# 16, 17, 31, 32, 33, 512, 520, 1024, 1025, 49,152), M 1, 16, 17 and 32,
# and T off the token tile (515, 700 and 4099 tokens leave 3, 4 and 3 in
# the last tile)
EM_MAIN = (10, 512, 10)
EM_VOCAB = (8, 512, 49_152)   # smollm-135m's vocabulary, 8 components
EM_SHAPES = [EM_MAIN, (2, 128, 512), (4, 128, 1024), (8, 256, 512),
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
    # tile edges: folded rows just below, at and above 64 and 128, keys
    # just off the key tile (64 at Dh 64, 32 at Dh 128)
    (2, 42, 43, 3, 1, 64, True, 0),
    (1, 64, 127, 2, 1, 64, False, 0),
    (1, 43, 65, 3, 1, 64, True, 0),
    (1, 32, 33, 2, 1, 128, True, 0),
    (1, 127, 95, 1, 1, 128, False, 0),
    (1, 43, 33, 3, 1, 128, True, 16),
]
# K2: the cifar10-cnn round's P, and row strides that give the kernel 8-,
# 4- and 16-byte vectors in fp32 (the round's stack has the first)
AGG_P = 188_810
AGG_STRIDES = (188_810, 188_811, 188_812)
SERVE_B, SERVE_PROMPT, SERVE_GEN = 8, 1024, 32
# K3's backward: (B, Sq, Skv, H, KH, Dh, causal, window); the first is the
# training main path's (smollm-135m, B 8 x S 256)
BWD_MAIN = (8, 256, 256, 9, 3, 64, True, 0)
BWD_FED = (4, 128, 128, 9, 3, 64, True, 0)    # the federated run's
BWD_SHAPES = [
    BWD_MAIN,
    BWD_FED,
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
# |d| <= tol + tol·|ref| for the fp32 kernel against the float64 plain
# backward (tests/test_torch_gpu.py's tolerance); the row LSE likewise
BWD_TOL = 1e-5
TRAIN_TOL = 1e-4             # card vs CPU losses and params, TF32 off
# phase 7b: full-width training (tokens of examples/torch_federated_lm.py)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 256, 20, 3e-3
FED_C, FED_B, FED_S, FED_LOCAL, FED_ROUNDS = 4, 4, 128, 10, 2
# H100 SXM peaks (NVIDIA data sheet): device memory B/s, fp32 FLOP/s
# outside the tensor cores and TF32 FLOP/s on them (dense); the bounds
# below are taken against them
HBM_BYTES_PER_S, FP32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
# K3's fp32 route runs three TF32 products for each (split TF32)
SPLIT_TF32_TERMS = 3


def _phase(name: str) -> None:
    print(f"== {name}", flush=True)


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


def _main_sim(dev):
    """Quickstart's scenario at cifar10-cnn width through the port's entry
    points: the simulation the main paths run."""
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

    base = synthetic_image_dataset(0, 8000, image_size=32, n_classes=10)
    parts = dirichlet_partition(base.y, 11, alpha=0.1, seed=0)
    train = make_client_datasets(base, [train_test_split(p, seed=1)[0]
                                        for p in parts])
    test = make_client_datasets(base, [train_test_split(p, seed=1)[1]
                                       for p in parts])
    pm = np.concatenate([[True], selected])
    p_err = np.concatenate([[0.0], p_err_nb]).astype(np.float32)
    sim = FederatedSimulation(
        cifar10_cnn(), train, test, pm, p_err,
        FedSimConfig(rounds=ROUNDS, batch_size=32, lr=0.05, alpha=0.7,
                     em_iters=EM_ITERS, em_subset=512,
                     eval_every=EVAL_EVERY, seed=0), device=dev)
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


def check_flash_attention(dev) -> float:
    """K3 against its plain version at every checked shape, |d| <= tol +
    tol·|plain|; raises past it. Returns the max |d| at the main-path shape
    in fp32."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import flash_attention_ref
    main_err = None
    for shape in ATTN_SHAPES:
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
            if main_err is None:
                main_err = err
    return main_err


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


def _bwd_inputs(shape, dev, seed=0):
    """K3's inputs at ``shape`` (fp32) and an output cotangent dO."""
    q, k, v = _attn_inputs(shape, torch.float32, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    return q, k, v, torch.randn(q.shape, generator=g, device=dev)


def _autograd_grads(q, k, v, dout, causal, window):
    """(out, dq, dk, dv) through ``flash_attention``'s autograd path."""
    from repro_torch.kernels import flash_attention as k3
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = k3.flash_attention(q, k, v, causal=causal, window=window)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    return (out.detach(),) + grads


def check_flash_attention_backward(dev) -> float:
    """K3's backward against the float64 plain backward at every shape of
    ``BWD_SHAPES``, |d| <= tol + tol·|plain| for dq, dk, dv and the row
    LSE; a second run bitwise equal; the training forward's output bitwise
    the serving forward's; fully masked rows' dq and output exactly 0.
    Raises past any. Returns, for the training main path's shape
    (``BWD_MAIN``) and the federated one's (``BWD_FED``), the max |d| and
    the worst excess max(|d| − tol·|plain|), which the check holds to <=
    tol."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ref
    errs_at = {}
    for shape in BWD_SHAPES:
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
        if shape in (BWD_MAIN, BWD_FED):
            errs_at[shape] = (max(errs), max(excess))
    torch.cuda.empty_cache()
    return errs_at


def check_train_against_cpu(dev) -> None:
    """LM training on the card (K3 forward and backward, K2) against the
    CPU (plain versions): reduced smollm-135m, the same weights, batches
    and link masks; 3 SGD steps, then one federated round at C = 3 with 2
    local steps and one link erased. Losses, π* and params within
    ``TRAIN_TOL``."""
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    quiet = dict(log=lambda line: None)
    cfg = get_config("smollm-135m").reduced()
    p0 = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(steps=3, batch=2, seq=64, lr=TRAIN_LR, **quiet)
    ref = train.single_client(cfg, params=p0, device="cpu", **kw)
    got = train.single_client(cfg, params=_tree_to(p0, dev), device=dev,
                              **kw)
    errs = [max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])),
            _tree_err(got["params"], ref["params"])]
    inits = [init_params(cfg, torch.Generator().manual_seed(c), "cpu")
             for c in range(3)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *inits)
    masks = np.array([[True, False]])
    kw = dict(clients=3, rounds=1, local_steps=2, batch=2, seq=64,
              lr=TRAIN_LR, link_masks=masks, **quiet)
    fref = train.federated(cfg, params=tree_map(torch.clone, stacked),
                           device="cpu", **kw)
    fgot = train.federated(cfg, params=_tree_to(stacked, dev), device=dev,
                           **kw)
    errs += [abs(fgot["target_loss"][0] - fref["target_loss"][0]),
             float(np.abs(fgot["pi"][0] - fref["pi"][0]).max()),
             _tree_err(fgot["params"], fref["params"])]
    print(f"train reduced smollm-135m, card vs CPU: 3 SGD steps max|dloss|="
          f"{errs[0]:.3g} max|dparams|={errs[1]:.3g}; one federated round "
          f"at C = 3: |dloss|={errs[2]:.3g} max|dpi|={errs[3]:.3g} "
          f"max|dparams|={errs[4]:.3g} (tol {TRAIN_TOL:g})")
    if not (max(errs) <= TRAIN_TOL and np.array_equal(
            fgot["links"][0], masks[0])):
        raise AssertionError("the card's training run disagrees with the "
                             "CPU's")


def _tree_err(a, b) -> float:
    """Max |a − b| over two trees of one structure."""
    from torch.utils._pytree import tree_flatten
    return max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))


def _bwd_kernels(shape, dev) -> tuple:
    """The backward kernels that ``backward_plan`` launches at ``shape`` on
    this card, in order."""
    from repro_torch.kernels import flash_attention as k3
    return k3.backward_plan(*shape, k3._sm_count(dev))["kernels"]


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


def k1_report(dev, n1, n1_wide, floor) -> dict:
    """K1's row: the main path's shape in fp32 at the top level, and in
    ``shapes`` that shape, smollm-135m's vocabulary and the M = 39 round's
    shape, fp32 and bf16, each with the kernel's plan (the M = 39 entries
    also with that round's launches)."""
    from repro_torch.kernels import em_posterior as k1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for shape in (EM_MAIN, EM_VOCAB, EM_WIDE):
        for dtype in (torch.float32, torch.bfloat16):
            row = k1_times(dev, shape, dtype)
            # a fresh allocation is aligned as an address of 0 is
            row["plan"] = k1.plan(*shape, dtype, 0, sms,
                                  *k1.kernel_limits())._asdict()
            if shape == EM_WIDE:
                row["launches"] = n1_wide
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


def attention_report(dev, n3, err3, floor):
    """K3's row at the main path's shape (smollm-135m prefill, fp32)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import flash_attention_ref
    B, Sq, Skv, H, KH, Dh, causal, window = ATTN_MAIN
    q, k, v = _attn_inputs(ATTN_MAIN, torch.float32, dev)
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
        "design": "split-TF32 wgmma (3 products in fp32, 1 for Q.K^T and 2 "
                  "for P.V in bf16), TMA-fed K/V ring",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": n3, "max_abs_err": err3,
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


def k3_bwd_times(dev, shape, k3=None, calls=None) -> dict:
    """K3's backward at ``shape`` (fp32): the kernels' steady and cold ms
    together and each one's steady ms (its launches at ``shape``), the
    bounds (five products of 2·Dh FLOPs for each unmasked (query, key)
    pair of each head: split TF32 at 495 TFLOP/s, three TF32 products for
    each; fp32 at 67 TFLOP/s on the CUDA cores; the bytes of q, k, v, o, dO
    and the LSE read and dq, dk, dv and D written), and SDPA's backward on
    the same inputs. ``k3`` is the module whose forward gives o and the
    LSE (the port on the path by default); ``calls(q, k, v, out, lse, dout,
    causal, window)`` returns the backward's launches as (name, launch)
    pairs (by default ``k3._backward_launches``'s), so another version of
    the kernels can be timed the same way."""
    if k3 is None:
        from repro_torch.kernels import flash_attention as k3
    if calls is None:
        def calls(*args):
            return k3._backward_launches(*args)[1]
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    q, k, v, dout = _bwd_inputs(shape, dev)
    out, lse = k3._launch(q, k, v, causal, window, with_lse=True)
    launches = calls(q, k, v, out, lse, dout, causal, window)

    def bwd():
        for _, launch in launches:
            launch()

    pairs = _unmasked_pairs(Sq, Skv, causal, window)
    ops = 5 * 2 * Dh * pairs * B * H
    nbytes = 4 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + 2 * lse.numel())      # q, o, dO, dq; k, dk; v, dv; LSE, D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    split_ms = SPLIT_TF32_TERMS * ops / TF32_FLOPS * 1e3
    fp32_ms = ops / FP32_FLOPS * 1e3
    ms = time_ms(bwd)
    row = {
        "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "KH": KH, "Dh": Dh,
                  "causal": causal, "window": window, "dtype": "float32"},
        "ms": ms, "cold_ms": cold_ms(bwd, dev),
        "kernel_ms": {name: time_ms(launch) for name, launch in launches},
        "bound_ms": max(bytes_ms, split_ms),
        "bound_by": "bytes" if bytes_ms >= split_ms else "operations",
        "bound_route": "split TF32: 3 x the FLOPs at 495 TFLOP/s",
        "bound_tf32_ms": split_ms, "bound_fp32_cuda_core_ms": fp32_ms,
        "bound_bytes_ms": bytes_ms, "bound_flops": ops,
        "bound_share": max(bytes_ms, split_ms) / ms,
        **sdpa_backward(q, k, v, dout, causal)}
    del q, k, v, dout, out, lse, launches
    torch.cuda.empty_cache()
    return row


def attention_bwd_report(dev, shape, n_bwd, err, floor, main_path):
    """K3's backward row at one main path's shape (the training path's, B 8
    x S 256, or the federated one's, B 4 x S 128; fp32): ``k3_bwd_times``
    with the launches that path made, the error phase 6 found at that
    shape and the plain backward's ms."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    causal, window = shape[6], shape[7]
    q, k, v, dout = _bwd_inputs(shape, dev)
    out, lse = k3._launch(q, k, v, causal, window, with_lse=True)
    plain_ms = time_ms(lambda: flash_attention_bwd_ref(
        q, k, v, out, lse, dout, causal=causal, window=window),
        iters=5, reps=5)
    plan = k3.backward_plan(*shape, k3._sm_count(dev))
    return {
        "name": "flash_attention_bwd", "route": "cuda", "main_path": main_path,
        "design": "split-TF32 wgmma for every product (S^T, dP^T, dV, dK "
                  "in the dK/dV kernel; S, dP, dQ in the dQ kernel), two "
                  "warpgroups a block sharing its K/V (dK/dV) or Q/dO (dQ) "
                  "and streaming their own half of the tiles by cp.async; "
                  "dK/dV split over the (head, query tile) steps when one "
                  "block a key tile would leave SMs idle, the partials "
                  "summed in split order; D = rowsum(dO*O); no atomics",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "replaces_note": "K3 has no backward on the TPU: the reference "
                         "differentiates chunked_attention "
                         "(src/repro/models/attention.py:33) under "
                         "jax.checkpoint",
        "launches": sum(n_bwd.values()), "launches_by_kernel": n_bwd,
        "launches_per_step": sum(n_bwd.values()) // (
            TRAIN_STEPS if main_path == "train"
            else FED_ROUNDS * FED_C * FED_LOCAL),
        "splits": plan["splits"], "dkdv_blocks": plan["dkdv_blocks"],
        "dq_blocks": plan["dq_blocks"],
        "max_abs_err": err[0], "atol": BWD_TOL, "rtol": BWD_TOL,
        "max_excess_over_rtol": err[1],
        "tolerance_note": "|d| <= atol + rtol·|plain|, i.e. max_excess_"
                          "over_rtol = max(|d| − rtol·|plain|) <= atol",
        **k3_bwd_times(dev, shape),
        "plain_ms": plain_ms,
        "back_to_back_ms": back_to_back_ms(lambda: k3._launch_backward(
            q, k, v, out, lse, dout, causal, window), iters=50),
        "forward_lse_ms": time_ms(lambda: k3._launch(q, k, v, causal, window,
                                                     with_lse=True)),
        "forward_serving_ms": time_ms(lambda: k3._launch(q, k, v, causal,
                                                         window)),
        "floor_ms": floor}


def sdpa_backward(q, k, v, dout, causal) -> dict:
    """SDPA's backward on the same inputs, timed only: forward and
    backward less the forward, with K and V repeated to H heads (so every
    backend that takes fp32 applies), under each backend in turn and
    unrestricted (``library_ms``)."""
    import warnings
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
              .requires_grad_() for t in (k, v))
    dt = dout.transpose(1, 2).contiguous()

    def fwd():
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
    from repro_torch.launch.serve import prefill_to_cache, serve
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

    P = prompts.shape[1]
    with torch.no_grad():
        logits, cache = prefill_to_cache(params, cfg, prompts, P + SERVE_GEN)
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
                        help="also profile two pFedWN rounds, one serving "
                        "run and one training step and print where the "
                        "device time goes")
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

    _phase("5. pfedwn round: small run vs CPU, then the main path")
    check_small_run_against_cpu(dev)
    t0 = time.perf_counter()
    _, n1, n2, sim = run_main_path(dev)
    print(f"main path wall {time.perf_counter() - t0:.1f} s, launches "
          f"K1={n1} K2={n2}")
    if (sim.m, sim.sim.em_subset, sim.model_cfg.n_classes) != EM_MAIN:
        raise AssertionError("EM_MAIN is not the main path's K1 shape")

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

    _phase("7. serving: small run vs CPU, then the main path")
    check_serve_against_cpu(dev)
    t0 = time.perf_counter()
    _, n3, serve_args = run_serve_main_path(dev)
    print(f"serving main path wall {time.perf_counter() - t0:.1f} s (warm-up "
          f"run included), launches K3={n3}")

    _phase("7b. LM training: small run vs CPU, then single-client and "
           "federated at full width")
    check_train_against_cpu(dev)
    t0 = time.perf_counter()
    trained = run_train_main_path(dev)
    print(f"training main path wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fed = run_fed_main_path(dev)
    print(f"federated main path wall {time.perf_counter() - t0:.1f} s")

    _phase("8. kernel times")
    print(f"empty event bracket: {cold_ms(lambda: None, dev):.6f} ms")
    floor = floor_ms(dev)
    print(f"floor (1-element zero_, steady bracket): {floor:.6f} ms")
    rows = [k1_report(dev, n1, n1_wide, floor),
            agg_report(dev, sim, n2, err2, wide_sim, n2_wide, floor),
            attention_report(dev, n3, err3, floor),
            attention_bwd_report(dev, BWD_MAIN, trained["k3_backward"],
                                 err3_bwd[BWD_MAIN], floor, "train"),
            attention_bwd_report(dev, BWD_FED, fed["k3_backward"],
                                 err3_bwd[BWD_FED], floor, "federated")]
    rows[1]["lm_mix"] = lm_mix_times(dev, fed["k2"])
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
    print(card_line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
