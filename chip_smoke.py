#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--seed 0] [--steps 10]

Phases (each prints its own lines; any failure exits non-zero):
  1. device  -- the card's name, and its name and power limit from nvidia-smi;
  2. build   -- nvcc builds every kernel library from src/repro_torch/csrc/,
                in parallel, and prints what ptxas reports;
  3. parity  -- each kernel against its plain PyTorch version on the card,
                at the main paths' shapes and at edge shapes (ragged N, a
                masked L = 3, every packing width), every route of every
                kernel in f32 and bf16 (kmeans_assign d8 and generic,
                bitwise each other where both apply and bitwise the f32
                upcast, its codes those of pq_quantize and lloyd_update
                near-ties included; scalar_quantize vec and scalar, a
                zero range, half-levels; for flash attention
                both routes (tensor_core for bf16 at hd a multiple of 16,
                cuda_core otherwise), ragged S, MHA, hd = 16 / 64, S below
                a tile, a window, a causality probe per route, and the
                strided entry bitwise the contiguous one); and the three
                clustering kernels at large L: lloyd_update's tiled route
                (L above its generic route's threshold, which the card
                reports) with pq_quantize's and kmeans_assign's generic
                routes at the SO runs' two tiled shapes, at L =
                threshold + 1 and at L = 2048, in f32 and bf16, with a
                mask, near-ties, exact cover and empty clusters; and all
                three on their generic routes at the SO runs' five other
                shapes and at L = threshold, D = 64;
  3b. anyd   -- the three clustering kernels above one chunk of 64 dims,
                where they refused D before: the FEMNIST example's --q 96
                cut (D = 96), D = 96 at L = threshold + 1 (tiled), D = 65,
                D = 128 and D = 9216, in f32 and bf16, held as the parity
                phase holds them; then kmeans() as Fig. 3's vanilla k-means
                runs it (20 rows of the 9216-wide cut, L = 2 to 64)
                through the kernels and the plain versions, with exact
                launch counts;
  4. slice   -- the FEMNIST FedLite train step at full width (d = 9216,
                q = 1152, L = 2, R = 1, 5 Lloyd iterations, 10 clients of
                20 examples, λ = 1e-4, sgd(10**-1.5)) for --steps steps,
                with the launch counts of the kernels read around the run,
                and step 1 held against the same step on the plain versions;
  5. kmeans  -- batched_kmeans at the FEMNIST grouping (10 problems of
                23040 x 8, L = 2, 5 iterations) on "auto" (the kernels) and
                "torch" (plain), launch counts read around the "auto" run;
                then on a bf16 x the size of the serve cut (4 x 1048576 x
                8, L = 16, 4 iterations): launch counts, no f32 copy (peak
                allocation), bitwise the call on the f32 upcast, times;
  6. slice 2 -- the same step with the compressed downlink
                "chain:topk(k=0.1)+scalarq(bits=8)" and a CutState carried
                from step to step (step 1 cold, 5 Lloyd iterations; later
                steps warm, 2), for --steps steps, with launch counts, and
                steps 1 and 2 held against the plain versions;
  7. payload -- the slice's downlink payload codes packed into 8-bit words
                and unpacked on the card, against the plain versions and
                the wire format's LSB-first byte stream;
  7b. trainer -- the paper's training run as its users drive it
                (examples/femnist_federated_training.py): FederatedTrainer
                over 64 clients, cohort 10, the same model and optimizer,
                through the scheduler, the stacked executor and the wire.
                The main path (ideal fleet, FullSync, --steps rounds):
                exact lloyd_update / pq_quantize launch counts over the
                run, the measured uplink bytes per client equal to the
                port's pq frame for this geometry, the trace's rounds,
                participants and bytes, finite losses, round 1 held
                against the same round run on CPU copies (the plain
                versions), the round times, the device busy share of a
                profiled run and the uplink reduction against SplitFed.
                The weighted path (mobile fleet, AsyncBuffer(4), the chain
                downlink, warm start, --steps flushes): make_weighted_step,
                the per-client cut state and scalar_quantize, with exact
                launch counts and the same trace from both scheduler
                backends;
  7b'. mesh  -- the cohort-parallel executor (executor="mesh", one
                process per shard, one all-reduce per update) on the same
                FEMNIST run from the same weights as the stacked executor:
                a world of one (NCCL) for --steps FullSync rounds (exact
                lloyd_update / pq_quantize launch counts: the stacked
                path's 5 + 1 a round) and --steps AsyncBuffer(4) flushes
                with the chain downlink (the 'client' scope); then two
                gloo ranks spawned on the one card (NCCL refuses two ranks
                on one device) for the FullSync run and a DropSlowestK(1)
                round (9 clients in 10 slots); each held to the stacked
                run (losses rtol 5e-4, params rtol 5e-3 / atol 5e-5, the
                reference's stacked-vs-mesh bounds; participants and
                bytes equal), the ranks bitwise equal; round medians of
                the stacked path, the mesh at one rank and at two;
  7c. so     -- the paper's two text tasks (benchmarks/bench_so_tasks.py)
                through FederatedTrainer at full width, 3 rounds a run:
                SO Tag (SOTagMLP, bag of words 5000 -> cut 2000 -> 1000
                tags, AdaGrad at 10^-0.5, cohort 10 of 100) and SO NWP
                (SONwpLSTM, vocab 10000, LSTM 670, cut 96 at each of 30
                positions, Adam at 0.01, cohort 50 of 16), each as
                SplitFed and as FedLite at the paper's (q, L) grids: exact
                launch counts and the route of every launch, the uplink
                bytes against a CPU copy's measurement, finite losses,
                Recall@5 or accuracy, round times; round 1 of the two runs
                on lloyd_update's tiled route and of one run per task on
                its generic route held against CPU copies; the FPS
                seeding's time at L = 960; batched_kmeans at the NWP
                grouping;
  7d. determinism -- a step on the same inputs 5 times: the SO NWP
                embedding's backward by indexing and by F.embedding at the
                NWP cohort's tokens, the full-width FEMNIST and SO NWP
                (48, 60) steps with the repair (bitwise, or the script
                fails) and without it; the FEMNIST step and round times
                with and without the repair, in turns;
  7e. recovery -- kill-and-resume: the femnist example's --chaos
                --warm-start run at full width (DEFAULT_CHAOS, error
                feedback, run_with_recovery over 9 rounds, a snapshot every
                3, killed at round 7) and SO NWP at (48, 60) (4 rounds, a
                snapshot every 2, killed at round 3), each bitwise the
                unkilled run (params, optimizer state, history, trace
                records, flights) with exact launch counts, snapshot bytes
                and write and restore times; a snapshot with a flipped
                payload byte refused; an SO Tag TrainState at full width
                saved and restored bitwise;
  7f. health -- the --chaos --emit-trace run: HealthMonitor on the
                trainer, the JSONL log read back by the port's inspector
                (the report, --faults, --health with a failing --slo rule);
                slo_violation events, every event name registered;
  7g. autoscale -- the --autoscale --fleet mobile run at full width (24
                rounds, re-planned every 8), then with a bytes budget of
                half its first segment's bytes per round, which moves the
                downlink to scalarq(bits=8) (scalar_quantize's launches
                counted exactly); each segment's trace recommends its
                recorded plan again;
  7h. examples -- the four examples' twins (repro_torch.examples) through
                their main on the card, each run's launch counts read
                around it: quickstart; the FEMNIST example's ideal loop
                (10 rounds at full width, d8 routes), at --q 96 (the
                lifted generic routes, its round 1 first held against CPU
                copies) and with --fleet mobile --policy deadline; the
                LLM fine-tune (200 steps) and split serving (flash
                attention in prefill) at their reduced defaults;
  7i. adafactor -- a FEMNIST step under Adafactor (the conv weights
                factored over I and O, as the reference) against the CPU's;
  8. serve   -- split serving of Llama-3 8B at full width (32 layers,
                d = 4096, 32/8 heads, vocab 128256, bf16, random weights
                from --seed): the prefill of 4 prompts of 2048 tokens with
                the PQ uplink at the cut (q = 512, L = 16, 4 Lloyd
                iterations, one client per prompt), then 32 greedy decode
                steps; launch counts, the flash kernel on two real layers'
                q/k/v, lloyd_update and pq_quantize on the prefill's own
                cut (4 problems of 1048576 x 8), the full-depth logits
                against the plain route stage by stage, an f32 path check
                at 4 layers, and the prefill and decode times;
  8b. lm     -- LM training through launch/train.py, the twin of the
                reference's training entry point, on one fixed batch of 8
                sequences of 2048 tokens (one client each), 8 steps
                (Llama) or 3 a run: Llama-3 8B at full width (d = 4096, 32/8 heads,
                vocab 128256, bf16, Adam) cut to 6 layers (the main
                path); Mamba2-1.3B as published, through the CLI's
                main; Mixtral-8x22B at full width cut to 2 layers
                (Adafactor, 8 experts top-2, capacity 5120). Each run's
                step 1 held stage by stage against the plain route on
                the card (client forward bitwise, lloyd_update and
                pq_quantize against their plain versions on the cut,
                codes, z̃, loss), exact launch counts (4 + 1 a step) and
                routes, falling losses, the step time, tokens/s, peak
                memory and busy share; then launch/serve.py on
                Mamba2-1.3B (4 x 2048 prompt, 16 decode steps) and its
                SSM cache handoff against the forward;
  8c. sharded -- the production ("data", "model") meshes over DTensor:
                the lm phase's Llama-3 8B run (6 layers, 8 steps) and the
                Llama-3 8B serve (4 x 2048, 32 steps) through train(...,
                mesh=) / serve(..., mesh=) on a (data=1, model=1) NCCL
                mesh, each held to its --mesh none run (the training
                to the lm phase's main run; bitwise expected), with the launches of the kernels on the local
                blocks (32 / 8; 32 / 4 / 1), tokens/s of both and
                DTensor's dispatch between them; and the llama3_8b x
                train_4k dry runs on the fake 256- and 512-rank meshes
                (per-device bytes against the card's HBM, the roofline's
                bound, host seconds), which trace in a subprocess on the
                host's CPU from the start of the serve phase on;
  9. times   -- each kernel's device time next to its plain version's, its
                bound and, where one PyTorch call computes the same
                function, that call's time (flash attention through both
                entries); lloyd_update and pq_quantize also at the serve
                cut's shape; kmeans_assign and scalar_quantize at their
                users' shapes (up to the serve cut and a Llama-3 8B cut's
                gradient, f32 and bf16) with the floor of a one-element
                call and the time of the call as it was before the
                redesign (the kept route on an f32 copy); the step times;
                the three clustering kernels at large L: lloyd_update's
                tiled and pq_quantize's and kmeans_assign's generic route
                at the SO runs' tiled shapes, lloyd_update's generic route
                at the largest of its SO shapes; lloyd_update and
                pq_quantize at the three LM runs' cuts; the three
                clustering kernels above 64 dims (--q 96, D = 128 and Fig.
                3's (20, 9216) at L = 64); lloyd_update and pq_quantize
                at a mesh shard's fused clients (5, 23040, 8); the
                sharded runs' launches of the three kernels beside the
                times of the lm_train cut's and the serve prefill's
                entries (the same shapes: at the 1 x 1 mesh a block is
                the whole tensor).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA card, or away
from a checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate, the f32 (non-tensor-core) peak and
# the dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
L2_BYTES = 50e6     # a call that moves less may stay in the L2 cache

# the FEMNIST run (examples/femnist_federated_training.py, executor.py)
CLIENTS, CLIENT_BATCH, Q, L, R, ITERS, LAM, LR = 10, 20, 1152, 2, 1, 5, \
    1e-4, 10 ** -1.5
CUT_D = 9216
DSUB = CUT_D // Q
M = Q // R * CLIENT_BATCH              # rows of one k-means problem: 23040
M_PAD = -(-M // 4096) * 4096           # padded to the 4096-row chunk: 24576
# the downlink of slice 2: top-k keeps 10 % of each client's 20 x 9216
# cotangent, then scalarq codes the kept values at 8 bits
DOWNLINK = "chain:topk(k=0.1)+scalarq(bits=8)"
DOWNLINK_PLAIN = "chain:topk(k=0.1)+scalarq(bits=8,backend=torch)"
DL_BITS = 8
DL_TOTAL = CLIENT_BATCH * CUT_D        # one client's cotangent: 184320
DL_KEPT = round(0.1 * DL_TOTAL)        # the chain's carrier: 18432
WARM_ITERS = ITERS // 2                # Lloyd iterations of a warm step
PACK_BITS = (1, 2, 4, 8, 16)
# the examples phase: quickstart's PQConfig(1152, 2) at its default 8 Lloyd
# iterations (3 quantize calls), split_llm_finetune's default --steps. The
# clustering kernels above 64 dims: the FEMNIST example at --q 96, and
# Fig. 3's vanilla k-means (benchmarks/bench_quantizer_tradeoff.py:66) on
# 20 rows of the cut at L in {2, 8, 32, 64}, 6 iterations (its fast run's)
QS_ITERS, LLM_STEPS = 8, 200
ANYD_Q = 96
FIG3_ROWS, FIG3_L, FIG3_ITERS = 20, (2, 8, 32, 64), 6

# split serving of Llama-3 8B (src/repro_torch/configs/llama3_8b.py): 4
# prompts of 2048 tokens, one client each, then 32 greedy decode steps
SERVE_B, SERVE_P, SERVE_GEN = 4, 2048, 32
# its PQ uplink (q = 512 subvectors of 8 of d = 4096, L = 16): one problem
# per prompt of 2048 x 512 rows
SERVE_PQ_ROWS, SERVE_PQ_D, SERVE_PQ_L = SERVE_P * 512, 8, 16
# flash attention against its plain version: f32 (the cuda_core route)
# within the reference's own flash tolerance (tests/test_flash.py); a bf16
# output against the plain version cast to bf16 within 1e-2·(1 + |value|):
# the output rounds to bf16, and the tensor_core route rounds P to bf16
# before P·V as the reference's model path does. Measured on an H100:
# max |err| 1.56e-2 on the synthetic bf16 cases (one bf16 ulp in [2, 4))
# and 3.13e-2 on a real layer of the serve prefill, all inside the bound
FLASH_F32_RTOL, FLASH_F32_ATOL = 2e-4, 2e-5
FLASH_BF16_TOL = 1e-2
# the f32 path check (4 layers): last-token logits of the kernel route
# within 1e-3·(1 + |plain|) of the plain route's; with the PQ uplink, codes
# equal on 99.9 % of subvectors (a near-tie may flip, since the two routes'
# cut activations differ at f32 rounding) and distortion within 1e-4
# relative
PATH_LOGIT_RTOL = 1e-3
PATH_CODES_EQUAL = 0.999
PATH_DIST_RTOL = 1e-4
# full depth in bf16: relative L2 gap of the two routes' last logits,
# without the PQ uplink and from the same quantized cut
SERVE_LOGIT_GAP = 5e-2

# the paper's text tasks (benchmarks/bench_so_tasks.py) at the paper's
# widths, 3 rounds a run (the paper runs 100-500), 5 Lloyd iterations,
# λ = 1e-3. SO Tag: bag of words 5000 -> cut 2000 -> 1000 tags, AdaGrad at
# 10^-0.5, 32 clients, cohort 10 of 100 examples. SO NWP: vocab 10000,
# embedding 96, LSTM 670, cut 96, Adam at 0.01, cohort 50 of 16 x 30
# tokens, from 64 clients (a cohort is drawn without replacement, so 32
# clients would cap it at 32). The grids are the paper's (q, L).
TAG_CLIENTS, TAG_BOW, TAG_D, TAG_TAGS, TAG_COHORT, TAG_B = \
    32, 5000, 2000, 1000, 10, 100
TAG_LR = 10 ** -0.5
TAG_GRID = ((125, 100), (250, 20), (500, 20), (1000, 10))
NWP_CLIENTS, NWP_VOCAB, NWP_HIDDEN, NWP_D, NWP_COHORT, NWP_B, NWP_SEQ = \
    64, 10_000, 670, 96, 50, 16, 30
NWP_LR = 0.01
NWP_GRID = ((48, 60), (12, 30), (3, 960))
SO_LAM, SO_ROUNDS = 1e-3, 3
# the runs whose round 1 is held to CPU copies and to the plain versions on
# the card: the two on lloyd_update's tiled route, and one a task on its
# generic route
SO_HOLD = (("tag", 125, 100), ("tag", 250, 20), ("nwp", 48, 60),
           ("nwp", 3, 960))

TIE_RTOL = 1e-5       # top-two scores this close may pick either code
# lloyd_update's dsums: bitwise those of the plain version summed in the
# launch's order (0/1 weights make every term exact), within γ·Σ|terms| of
# the f64 sum (check_lloyd), and, for an f32 x, within
# DSUM_RTOL·(1 + |plain|) of the plain version's own order. Sums of ~1e4
# f32 terms near 2e4 differ by ~0.1 between two orders, so only the same
# order can be held bitwise. On bf16-valued rows the plain (matmul) order
# itself strays from the exact sum by more than DSUM_RTOL (its roundings
# no longer cancel), so a bf16 x is held to f64 within γ and, bitwise, to
# its f32 upcast instead.
DSUM_ATOL = 0.0
DSUM_RTOL = 2e-5
# kmeans_assign's squared distances: ‖x‖² − best in f32, each rounded once
SQDIST_RTOL = 1e-5    # of (1 + ‖x‖²)
# step-1 losses of a kernel step and a plain step from the same inputs
LOSS_ATOL = 1e-4
# the trainer's first round or flush on the card against the same one on CPU
# copies (the plain versions): the update (state after − before) within
# UPDATE_RTOL in L2, on the client's and the server's parameters each. A
# code flip at a near-tie, a downlink value rounded to the other level, or
# the SO NWP embedding's gradient summed in another order than the CPU's,
# moves a few entries; a client missing from a flush of 4, or its weight off
# by 10 %, moves the update by more than 2 %. On the SO runs the card's
# round also differs from the CPU's outside the kernels (the LSTM's cuBLAS
# sums, the embedding's backward), and Adam's first step, lr·g/(|g| + eps),
# makes every gradient entry near 0 a ±lr: SO NWP (48, 60) on the plain
# versions is 2.07e-2 from the CPU copies on an H100. So an SO run's update
# is held to its run on the plain versions on the card within UPDATE_RTOL
# (the kernels' share), and to the CPU copies' within UPDATE_RTOL beyond
# that run's own gap
UPDATE_RTOL = 1e-2
# and the mean PQ distortion within this of the CPU copies' (relative)
TRAIN_DIST_RTOL = 1e-4
# the warm step 2 of slice 2, from the same inputs: its 2 Lloyd iterations
# sum in another order on the two paths, so the codebooks differ by ~1e-4
# and a subvector near the boundary of two centroids may take the other
# code; one such flip moves one example's loss, the batch mean by up to
# ~1e-4 (7.7e-5 seen on an H100), so the bound is 10x that
WARM_LOSS_ATOL = 1e-3

# the mesh phase: the reference's stacked-vs-mesh bounds
# (tests/test_executor.py:154-158) and how long two spawned ranks may take
MESH_LOSS_RTOL = 5e-4
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 5e-3, 5e-5
MESH_JOIN_S = 600
# the mesh's ranks on one card, and the clients one of them fuses. Two
# ranks sum the weight gradients in another order than the stacked step;
# on an H100 that stayed at 1e-7 for 3 rounds, then a near-tie PQ code
# flipped (round 4) and the params parted by 9.1e-5 by round 10, past
# MESH_PARAM_ATOL (on server.dense1_b, entries below 2e-3). So the ranks'
# params are held after MESH_PARAM_ROUNDS, the horizon of the reference's
# own stacked-vs-mesh test, and their losses over the whole run
MESH_PARAM_ROUNDS = 2
MESH_RANKS = 2
MESH_SHARD = CLIENTS // MESH_RANKS

# crash recovery: the femnist example's --chaos --warm-start run (9
# rounds, a snapshot every 3, killed at round 7 as tests/test_faults.py
# kills it) and SO NWP at (q, L) = (48, 60) (4 rounds, a snapshot every 2,
# killed at round 3); a step run DET_REPEATS times on the same inputs
REC_ROUNDS, REC_EVERY, REC_KILL = 9, 3, 7
NWP_REC = (48, 60)
NWP_REC_ROUNDS, NWP_REC_EVERY, NWP_REC_KILL = 4, 2, 3
DET_REPEATS = 5
# the --emit-trace health run, and --autoscale (re-planned every 8 rounds)
HEALTH_ROUNDS = 6
AUTO_ROUNDS, AUTO_INTERVAL = 24, 8

# LM training through launch/train.py (lm_runs): 8 sequences of 2048
# tokens, one client each, on one fixed batch; Llama-3 8B cut to 6 layers
# (its 32 need ~96 GB of bf16 params and grads and f32 Adam moments),
# Mixtral-8x22B to 2. The Llama run takes LM_MAIN_STEPS: under the
# launcher's warm-up (lr·(s+1)/10) its first Adam steps move the bf16
# weights by about one ulp, rounding noise that lifted the loss at step 2
# on an H100, so its fall shows only once the rate has grown
LM_B, LM_S, LM_STEPS, LM_MAIN_STEPS = 8, 2048, 3, 8
LM_MAIN_LAYERS, LM_MOE_LAYERS = 6, 2
# step 1, kernel route vs plain route on the same cut: both Lloyd runs sum
# in other orders, so a near-tie subvector may take the other code (the
# floor); where the codes agree z̃ differs by at most a bf16 rounding of a
# centroid; a few flipped codes move the loss by far less than
# LM_LOSS_RTOL; a random init's CE is near ln(vocab) (the logits' spread
# adds about half their variance)
LM_CODES_EQUAL = 0.99
LM_ZT_TOL = 1e-2
LM_LOSS_RTOL = 1e-3
LM_CE_SLACK = 1.5
# launch/serve.py on Mamba2-1.3B as published: 4 prompts of 2048, 16 steps;
# its cache handoff is held in bf16 at SERVE_LOGIT_GAP and, in f32 at 4
# layers, at SSM_HANDOFF_F32 (relative L2 of the logits)
SSM_SERVE_B, SSM_SERVE_P, SSM_SERVE_GEN = 4, 2048, 16
SSM_HANDOFF_F32 = 1e-3


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def device_ms(fn, calls: int = 50, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times between two CUDA events. The graph
    takes the host out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def eager_ms(fn, calls: int = 200) -> float:
    """Time per call of back-to-back eager calls between two CUDA events:
    the host's launch cost where it exceeds the device's work."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def bound(nbytes: float, flops: float, peak: float = F32_FLOP_PER_S):
    """Least time (ms) for the work, and what bounds it: the bytes over the
    memory rate, or the operations over ``peak``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); device 0: {name}")
    print(smi[0], flush=True)
    return name


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = ["lloyd_update", "pq_quantize", "kmeans_assign", "scalar_quant",
            "flash_attention"]
    infos = _build.build(libs)
    for name, info in infos.items():
        say("build", f"{name}: {info.path.name} in {info.seconds:.1f} s")
        for line in info.ptxas.strip().splitlines():
            say("build", f"  {line.strip()}")
    say("build", f"{len(libs)} libraries built in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc)")


def lloyd_f64(x, w, cp, lmask):
    """The plain version's dsums summed in f64 from the same f32 terms
    w·(x − c), and the sums of the terms' magnitudes (both (P, L, D))."""
    from repro_torch.kernels import ref

    codes, _ = ref.kmeans_assign_ref(x, cp, lmask)
    delta = (x.float() - ref._gather_rows(cp.float(), codes)).double()
    onehot = torch.nn.functional.one_hot(codes, cp.shape[-2]).double() \
        * w.double().unsqueeze(-1)
    oh_t = onehot.transpose(-1, -2)
    return oh_t @ delta, oh_t @ delta.abs()


def chain_depth(lay, n):
    """The longest chain of f32 additions behind one of a launch's dsums:
    d8: a thread's rows (rows / threads in each of its tiles), the 5
    levels of the xor tree, the warps, the blocks; generic: a block's
    rows, then the blocks."""
    if lay.route == "d8":
        return -(-n // (lay.rows * lay.blocks)) * (lay.rows // lay.threads) \
            + 5 + lay.threads // 32 + lay.blocks
    return lay.rows + lay.blocks


def check_lloyd(tag, x, cp, lmask, w, order_rtol=DSUM_RTOL):
    """lloyd_update_kernel on the codebook cp (masked by lmask, or None) vs
    its plain versions; returns (max |dsums − plain in the kernel's order|,
    dsums, counts, route).

    Three sums of the same f32 terms: the plain version in the launch's
    order (the kernel's bit for bit), the plain version's own order
    (within ``order_rtol``·(1 + |plain|); None skips it), and f64, which
    the kernel must meet within γ·Σ|terms|, the f32 rounding bound of its
    chains of at most n additions (``chain_depth``): γ = n·2⁻²⁴ /
    (1 − n·2⁻²⁴). A bf16 x must give bitwise its f32 upcast's sums."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lloyd_update import (
        lloyd_layout, lloyd_update_in_kernel_order, lloyd_update_kernel)

    ties = ref.near_ties(x, cp, lmask, TIE_RTOL)
    # a near-tie row may take either code; weight 0 keeps it out of both
    w = torch.where(ties, 0.0, w).contiguous()
    lay = lloyd_layout(x, cp.shape[1])
    ds, cnt = lloyd_update_kernel(x, w, cp, lmask)
    ds_o, cnt_o = lloyd_update_in_kernel_order(x, w, cp, lmask, lay)
    ds_r, cnt_r = ref.lloyd_update_ref(x, w, cp, lmask)
    ds_64, mag = lloyd_f64(x, w, cp, lmask)
    torch.cuda.synchronize()
    if not (torch.equal(cnt, cnt_r) and torch.equal(cnt, cnt_o)):
        fail(f"lloyd_update {tag}: counts differ from the plain version")
    err = float((ds - ds_o).abs().max())
    err_r = float((ds - ds_r).abs().max())
    rel_r = float(((ds - ds_r).abs() / (1 + ds_r.abs())).max())
    depth = chain_depth(lay, x.shape[1])
    gamma = depth * 2.0 ** -24 / (1 - depth * 2.0 ** -24)
    over = (ds.double() - ds_64).abs() - gamma * mag
    rel_64 = float(((ds.double() - ds_64).abs()
                    / mag.clamp_min(1e-300)).max())
    if not err <= DSUM_ATOL:
        fail(f"lloyd_update {tag}: dsums off by {err} from the plain "
             f"version in the kernel's order")
    if order_rtol is not None and not rel_r <= order_rtol:
        fail(f"lloyd_update {tag}: dsums off by {err_r} (scaled {rel_r}) "
             f"from the plain version")
    if bool((over > 0).any()):
        fail(f"lloyd_update {tag}: dsums off from the f64 sum by "
             f"{rel_64} of Σ|terms|, above γ = {gamma}")
    upcast = ""
    if x.dtype != torch.float32:
        ds_f, cnt_f = lloyd_update_kernel(x.float(), w, cp, lmask)
        if not (torch.equal(ds, ds_f) and torch.equal(cnt, cnt_f)):
            fail(f"lloyd_update {tag}: {x.dtype} x differs from its f32 "
                 f"upcast")
        upcast = f"; bitwise the f32 upcast's"
    say("parity", f"lloyd_update {tag} (route {lay.route}, {lay.blocks} "
        f"blocks per problem): x {tuple(x.shape)} {x.dtype} "
        f"L={cp.shape[1]}{' masked' if lmask is not None else ''}: counts "
        f"equal; max |dsums err| {err:.3e} against the kernel's order, "
        f"{err_r:.3e} (scaled {rel_r:.3e}) against the plain order, "
        f"{rel_64:.3e} of Σ|terms| against f64 (γ {gamma:.3e}, chains of "
        f"{depth}){upcast}; {int(ties.sum())} near-tie rows weighted 0")
    return err, ds, cnt, lay.route


def check_pq(tag, x, cp, lmask=None):
    """pq_quantize_kernel on the codebook cp (masked by lmask, or None) vs
    its plain version; returns (max |err| where codes agree (0 when z̃ and
    the residual are bitwise equal), z̃, residual, codes). A bf16 x must
    give its f32 upcast's codes and residual, and z̃ rounded to bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pq_quantize import pq_quantize_kernel, pq_route

    zt, resid, codes = pq_quantize_kernel(x, cp, lmask)
    zt_r, resid_r, codes_r = ref.pq_quantize_ref(x, cp, lmask)
    torch.cuda.synchronize()
    differ = codes != codes_r
    ties = ref.near_ties(x, cp, lmask, TIE_RTOL)
    if bool((differ & ~ties).any()):
        fail(f"pq_quantize {tag}: {int((differ & ~ties).sum())} codes "
             f"differ away from near-ties")
    agree = ~differ
    if not (torch.equal(zt[agree], zt_r[agree])
            and torch.equal(resid[agree], resid_r[agree])):
        fail(f"pq_quantize {tag}: z̃ or residual not bitwise equal where "
             f"codes agree")
    keep = agree.unsqueeze(-1)
    err = max(float(torch.where(keep, (zt.float() - zt_r.float()).abs(),
                                0.0).max()),
              float(torch.where(keep, (resid - resid_r).abs(), 0.0).max()))
    upcast = ""
    if x.dtype != torch.float32:
        zt_f, resid_f, codes_f = pq_quantize_kernel(x.float(), cp, lmask)
        if not (torch.equal(codes, codes_f) and torch.equal(resid, resid_f)
                and torch.equal(zt, zt_f.to(x.dtype))):
            fail(f"pq_quantize {tag}: {x.dtype} x differs from its f32 "
                 f"upcast")
        upcast = "; codes and residual bitwise the f32 upcast's, z̃ its RNE"
    say("parity", f"pq_quantize {tag} (route {pq_route(x, cp.shape[1])}): "
        f"x {tuple(x.shape)} {x.dtype} L={cp.shape[1]}"
        f"{' masked' if lmask is not None else ''}: {int(differ.sum())} "
        f"codes differ (all near-ties), z̃ and residual bitwise equal where "
        f"codes agree{upcast}")
    return err, zt, resid, codes


def wire_stream(codes: np.ndarray, bits: int) -> bytes:
    """The wire format's code stream: each code's ``bits`` low bits,
    least significant first, packed into bytes LSB-first (as
    ``federated/wire.py``'s ``_pack_codes`` writes it)."""
    flat = codes.reshape(-1).astype(np.uint32)
    bitmat = (flat[:, None] >> np.arange(bits, dtype=np.uint32)) & 1
    return np.packbits(bitmat.astype(np.uint8).reshape(-1),
                       bitorder="little").tobytes()


def misaligned(x):
    """A contiguous copy of x one element off a 16-byte boundary: the same
    values, on the kernels' fallback routes (generic, scalar)."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def check_kmeans_assign(tag, x, c, lmask=None, by_depth=False):
    """kmeans_assign vs its plain version (codes equal but for near-ties,
    distances within SQDIST_RTOL·(1 + ‖x‖²), or with ``by_depth`` within
    2·γ_D·Σ(|x_k| + |c_k|)², the f32 bound of two orders of chains of D
    terms, which a large D needs); on d8 also bitwise the generic route
    (through an all-valid mask and through a misaligned copy); a bf16 x
    bitwise its f32 upcast. Returns max |sqdist err| where the codes
    agree."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_assign import (assign_route,
                                                   kmeans_assign_kernel)

    route = assign_route(x, c.shape[1], lmask)
    codes, sq = kmeans_assign_kernel(x, c, lmask)
    codes_r, sq_r = ref.kmeans_assign_ref(x, c, lmask)
    torch.cuda.synchronize()
    differ = codes.long() != codes_r
    ties = ref.near_ties(x, c, lmask, TIE_RTOL)
    if bool((differ & ~ties).any()):
        fail(f"kmeans_assign {tag}: {int((differ & ~ties).sum())} codes "
             f"differ away from near-ties")
    agree = ~differ
    scale = 1 + x.float().square().sum(-1)
    err = (sq - sq_r).abs()
    rel = float((err / scale)[agree].max())
    if by_depth:
        d = x.shape[-1]
        gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
        mag = (x.float().abs() + ref._gather_rows(c, codes.long()).abs()) \
            .square().sum(-1)
        over = float((err - 2 * gamma * mag)[agree].max())
        if over > 0:
            fail(f"kmeans_assign {tag}: sqdist off by more than "
                 f"2·γ_D·Σ(|x| + |c|)² (by {over})")
    elif not rel <= SQDIST_RTOL:
        fail(f"kmeans_assign {tag}: sqdist off by {rel} of (1 + ‖x‖²)")
    extra = ""
    if route == "d8":
        ones = torch.ones(c.shape[1], device=x.device)
        for how, (cg, sg) in (("mask", kmeans_assign_kernel(x, c, ones)),
                              ("misaligned",
                               kmeans_assign_kernel(misaligned(x), c))):
            if not (torch.equal(codes, cg) and torch.equal(sq, sg)):
                fail(f"kmeans_assign {tag}: d8 and generic ({how}) differ")
        extra += "; bitwise the generic route (all-valid mask, misaligned)"
    if x.dtype != torch.float32:
        cf, sf = kmeans_assign_kernel(x.float(), c, lmask)
        if not (torch.equal(codes, cf) and torch.equal(sq, sf)):
            fail(f"kmeans_assign {tag}: {x.dtype} x differs from its f32 "
                 f"upcast")
        extra += "; bitwise the f32 upcast's"
    err_max = float(err[agree].max())
    say("parity", f"kmeans_assign {tag} (route {route}): x {tuple(x.shape)} "
        f"{str(x.dtype)[6:]} L={c.shape[1]}"
        f"{' masked' if lmask is not None else ''}: {int(differ.sum())} "
        f"codes differ (all near-ties); max |sqdist err| {err_max:.3e} "
        f"({rel:.3e} of 1 + ‖x‖²){extra}")
    return err_max


def check_assign_codes(tag, x, c):
    """kmeans_assign, pq_quantize and lloyd_update give every row the same
    code, near-ties included: lloyd_update's code of a row is read from the
    counts of a one-row problem (the first 4096 rows of problem 0)."""
    from repro_torch.kernels import ops

    codes_a, _ = ops.kmeans_assign(x, c)
    _, _, codes_q = ops.pq_quantize(x, c)
    m = min(4096, x.shape[1])
    rows = x[0, :m].reshape(m, 1, x.shape[2]).contiguous()
    _, cnt = ops.lloyd_update(rows, c[:1].expand(m, -1, -1).contiguous())
    torch.cuda.synchronize()
    codes_l = cnt.argmax(-1).to(torch.int32)
    if not (torch.equal(codes_a, codes_q) and torch.equal(codes_a[0, :m],
                                                          codes_l)):
        fail(f"kmeans_assign {tag}: codes differ from pq_quantize's or "
             f"lloyd_update's")
    say("parity", f"kmeans_assign {tag}: x {tuple(x.shape)} "
        f"{str(x.dtype)[6:]} L={c.shape[1]}: codes equal to pq_quantize's "
        f"on every row and to lloyd_update's on {m} one-row problems "
        f"(half the rows midway between two centroids)")


def scalar_range(x, bits):
    """The scalarq compressor's per-problem range (lo, scale), f32."""
    lo = x.amin(-1).float()
    scale = (x.amax(-1).float() - lo) / ((1 << bits) - 1)
    return lo, torch.where(scale > 0, scale, 1.0)


def check_scalar(tag, x, bits, lo=None, scale=None):
    """scalar_quantize vs its plain version: codes and recon bitwise; on
    vec also bitwise the scalar route (forced on the same x, and on a
    misaligned copy); a bf16 x bitwise its f32 upcast."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.scalar_quant import (scalar_quantize_kernel,
                                                  scalar_route)

    if lo is None:
        lo, scale = scalar_range(x, bits)
    route = scalar_route(x)
    codes, recon = ops.scalar_quantize(x, lo, scale, bits)
    codes_r, recon_r = ref.scalar_quantize_ref(x, lo, scale, bits)
    torch.cuda.synchronize()
    if not (torch.equal(codes, codes_r) and torch.equal(recon, recon_r)):
        fail(f"scalar_quantize {tag}: codes or recon not bitwise equal to "
             f"the plain version ({int((codes != codes_r).sum())} codes, "
             f"{int((recon != recon_r).sum())} recon values differ)")
    others = []
    if route == "vec":
        others += [("the scalar route", x, "scalar"),
                   ("the scalar route (misaligned)", misaligned(x), None)]
    if x.dtype != torch.float32:
        others.append(("the f32 upcast", x.float(), None))
    for what, xo, forced in others:
        co, ro = scalar_quantize_kernel(xo, lo, scale, bits, forced)
        if not (torch.equal(codes, co) and torch.equal(recon, ro)):
            fail(f"scalar_quantize {tag}: differs from {what}")
    say("parity", f"scalar_quantize {tag} (route {route}): x "
        f"{tuple(x.shape)} {str(x.dtype)[6:]} b={bits}: codes and recon "
        f"bitwise equal"
        + "".join(f"; bitwise {what}'s" for what, _, _ in others))


def check_pack(tag, codes, bits):
    """pack_codes / unpack_codes vs their plain versions and the wire
    stream: words bitwise, bytes equal, the round trip exact."""
    from repro_torch.kernels import ops, ref

    p, n = codes.shape
    words = ops.pack_codes(codes, bits)
    back = ops.unpack_codes(words, n, bits)
    words_r = ref.pack_codes_ref(codes, bits)
    torch.cuda.synchronize()
    if not torch.equal(words, words_r):
        fail(f"pack_codes {tag}: words differ from the plain version")
    if not torch.equal(back, codes):
        fail(f"unpack_codes {tag}: the round trip is not exact")
    if not torch.equal(back, ref.unpack_codes_ref(words_r, n, bits)):
        fail(f"unpack_codes {tag}: codes differ from the plain version")
    host = words.cpu().numpy().view(np.uint32).astype("<u4")
    src = codes.cpu().numpy()
    for i in range(p):
        stream = wire_stream(src[i], bits)
        if host[i].tobytes()[:len(stream)] != stream:
            fail(f"pack_codes {tag}: problem {i}'s bytes are not the wire "
                 f"stream")
    say("parity", f"pack_codes/unpack_codes {tag}: codes {tuple(codes.shape)}"
        f" b={bits} -> words {tuple(words.shape)}: bitwise the plain "
        f"version and the wire stream; round trip exact")
    return 0.0


def flash_inputs(gen, dtype, b, h, kv, s, hd):
    """q (B·H, S, hd), k and v (B·Kv, S, hd) on the card, from ``gen``."""
    return tuple(torch.randn(shape, generator=gen).to("cuda", dtype)
                 for shape in ((b * h, s, hd), (b * kv, s, hd),
                               (b * kv, s, hd)))


def check_flash(tag, q, k, v, h, kv, window=None, scale=None):
    """flash_attention vs its plain version on the same inputs (scale
    1/√hd unless given); returns the max |err| (in the output's units)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_route

    kw = dict(num_q_heads=h, num_kv_heads=kv, window=window,
              scale=q.shape[-1] ** -0.5 if scale is None else scale)
    out = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    if out.dtype != q.dtype or out.shape != q.shape:
        fail(f"flash_attention {tag}: output {out.dtype} "
             f"{tuple(out.shape)}")
    if q.dtype == torch.float32:
        rtol, atol = FLASH_F32_RTOL, FLASH_F32_ATOL
    else:
        rtol = atol = FLASH_BF16_TOL
    err = (out.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        fail(f"flash_attention {tag}: {int(bad.sum())} values off by up to "
             f"{float(err.max())} (rtol {rtol}, atol {atol})")
    say("parity", f"flash_attention {tag}: route "
        f"{flash_route(q.dtype, q.shape[-1])}, q {tuple(q.shape)} "
        f"{str(q.dtype)[6:]} H={h} Kv={kv} window={window}: max |err| "
        f"{float(err.max()):.3e} (rtol {rtol}, atol {atol})")
    return float(err.max())


def check_flash_causal(gen, dtype, s, window):
    """Future KV perturbations never change earlier outputs of the kernel:
    bitwise, since a masked score adds an exact 0."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_route

    q, k, v = flash_inputs(gen, dtype, 1, 4, 2, s, 64)
    kw = dict(num_q_heads=4, num_kv_heads=2, scale=0.125, window=window)
    o1 = ops.flash_attention(q, k, v, **kw)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 50.0
    v2[:, -1] += 50.0
    o2 = ops.flash_attention(q, k2, v2, **kw)
    torch.cuda.synchronize()
    route = flash_route(dtype, 64)
    if not torch.equal(o1[:, :-1], o2[:, :-1]):
        fail(f"flash_attention ({route}): a future key changed an earlier "
             f"output")
    if torch.equal(o1[:, -1], o2[:, -1]):
        fail(f"flash_attention ({route}): the last key did not reach its "
             f"own row")
    say("parity", f"flash_attention causality: route {route}, "
        f"{str(dtype)[6:]} S={s} window={window}: earlier outputs bitwise "
        f"unchanged by a perturbed last key")


def strided_views(q, k, v, b):
    """(B·n, S, hd) tensors as (B, S, n, hd) views of one fused
    (B, S, H + 2·Kv, hd) tensor, as a fused qkv projection gives them."""
    s, hd = q.shape[1:]
    fused = torch.cat([t.view(b, -1, s, hd).transpose(1, 2)
                       for t in (q, k, v)], dim=2)
    h, kv = q.shape[0] // b, k.shape[0] // b
    return fused[:, :, :h], fused[:, :, h:h + kv], fused[:, :, h + kv:]


def check_flash_strided(tag, q, k, v, b, h, kv, window=None):
    """The strided entry on (B, S, H, hd) views against the contiguous
    (B·H, S, hd) call: the same kernel on the same values, bitwise."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_route

    s, hd = q.shape[1:]
    kw = dict(scale=hd ** -0.5, window=window)
    out = ops.flash_attention(q, k, v, num_q_heads=h, num_kv_heads=kv, **kw)
    views = strided_views(q, k, v, b)
    got = ops.flash_attention_strided(*views, **kw)
    torch.cuda.synchronize()
    if got.shape != (b, s, h, hd) or not torch.equal(
            got.transpose(1, 2).reshape(q.shape), out):
        fail(f"flash_attention strided {tag}: not bitwise the contiguous "
             f"call")
    say("parity", f"flash_attention strided entry {tag}: route "
        f"{flash_route(q.dtype, hd)}, views {tuple(views[0].shape)} strides "
        f"{views[0].stride()}: bitwise the contiguous call")


def phase_flash_parity(gen):
    """flash_attention at the serve prefill's shape (B=4, H=32, Kv=8,
    S=2048, hd=128) in bf16 and f32, and at edge shapes."""
    h, kv, hd = 32, 8, 128
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(gen, dtype, SERVE_B, h, kv, SERVE_P, hd)
        err = max(err, check_flash("serve shape", q, k, v, h, kv))
        check_flash_strided("serve shape", q, k, v, SERVE_B, h, kv)
        del q, k, v
    cases = {"ragged S=1000": (torch.bfloat16, 1, 32, 8, 1000, 128, None),
             "ragged S=2047": (torch.float32, 1, 8, 2, 2047, 128, None),
             "MHA G=1": (torch.float32, 2, 4, 4, 300, 128, None),
             "G=4 bf16": (torch.bfloat16, 2, 8, 2, 300, 128, None),
             "hd=64": (torch.float32, 2, 4, 2, 500, 64, None),
             "hd=64 bf16": (torch.bfloat16, 2, 4, 2, 500, 64, None),
             "hd=16 bf16": (torch.bfloat16, 2, 4, 2, 333, 16, None),
             "hd=40 bf16": (torch.bfloat16, 2, 4, 2, 333, 40, None),
             "S < tile": (torch.float32, 3, 4, 2, 37, 128, None),
             "S < tile bf16": (torch.bfloat16, 3, 4, 2, 37, 128, None),
             "window 256": (torch.bfloat16, 1, 8, 2, 1500, 128, 256),
             "window 256 f32": (torch.float32, 1, 8, 2, 1029, 128, 256)}
    for tag, (dtype, b, h_, kv_, s_, hd_, window) in cases.items():
        q, k, v = flash_inputs(gen, dtype, b, h_, kv_, s_, hd_)
        err = max(err, check_flash(tag, q, k, v, h_, kv_, window))
        if tag in ("hd=16 bf16", "window 256", "window 256 f32"):
            check_flash_strided(tag, q, k, v, b, h_, kv_, window)
    check_flash_causal(gen, torch.float32, 300, None)
    check_flash_causal(gen, torch.bfloat16, 1000, 200)
    return err


def phase_parity(gen):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lloyd_update import lloyd_update_kernel

    dev = torch.device("cuda")

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    # the main path's call: 10 problems of 23040 x 8, L = 2, no padding,
    # no mask, no weights (near-tie rows weigh 0 in the checks)
    x = normal(CLIENTS * R, M, DSUB)
    c = normal(CLIENTS * R, L, DSUB)
    ones = torch.ones((CLIENTS * R, M), device=dev)
    lloyd_err, ds, cnt, _ = check_lloyd("main", x, c, None, ones)
    w = torch.where(ref.near_ties(x, c, None, TIE_RTOL), 0.0, ones)
    ds2, cnt2 = lloyd_update_kernel(x, w, c)
    if not (torch.equal(ds, ds2) and torch.equal(cnt, cnt2)):
        fail("lloyd_update: two runs are not bitwise identical")
    dsn, cntn = lloyd_update_kernel(x, None, c)
    ds1, cnt1 = lloyd_update_kernel(x, ones, c)
    if not (torch.equal(dsn, ds1) and torch.equal(cntn, cnt1)):
        fail("lloyd_update: no weights differ from all-ones weights")
    say("parity", "lloyd_update main: two runs bitwise identical; no "
        "weights bitwise all-ones weights")
    pq_err, *_ = check_pq("main", x, c)
    # the weighted path's call: one client's problem (P = 1, where d8 gives
    # a problem the most blocks and partials) from a warm codebook, one
    # Lloyd step past c as a client's codebook of the previous round is
    x1, w1 = x[:1], ones[:1]
    ds1, cnt1 = ref.lloyd_update_ref(x1, w1, c[:1])
    warm = c[:1] + ds1 / cnt1.clamp_min(1).unsqueeze(-1)
    lloyd_err = max(lloyd_err, check_lloyd("one client, warm", x1, warm,
                                           None, w1)[0])
    pq_err = max(pq_err, check_pq("one client, warm", x1, warm)[0])
    # PR 14's call of the same step: rows padded to the 4096-row chunk with
    # weight 0, L = 2 padded to 8 and masked
    xp_ = torch.nn.functional.pad(x, (0, 0, 0, M_PAD - M))
    wp_ = torch.nn.functional.pad(ones, (0, M_PAD - M))
    lloyd_err = max(lloyd_err, check_lloyd("main, padded and masked", xp_,
                                           *ops._pad_centroids(c), wp_)[0])
    # bf16, the routes at the edges: a ragged N, L = 16, a codebook masked
    # (L = 3 in 8) on d8 and L = 3 unmasked, D = 16 and a misaligned x on
    # generic
    xb = x.to(torch.bfloat16)
    lloyd_err = max(lloyd_err, check_lloyd("main bf16", xb, c, None, ones,
                                           None)[0])
    pq_err = max(pq_err, check_pq("main bf16", xb, c)[0])
    for tag, (p, n, d, l, masked, dtype) in {
            "ragged N": (3, 1037, DSUB, 2, False, torch.float32),
            "L=16": (4, 5000, DSUB, 16, False, torch.float32),
            "L=16 bf16": (4, 5000, DSUB, 16, False, torch.bfloat16),
            "L=3 masked": (4, 5000, DSUB, 3, True, torch.float32),
            "L=3": (4, 5000, DSUB, 3, False, torch.float32),
            "L=3 bf16": (4, 5000, DSUB, 3, False, torch.bfloat16),
            "D=16 L=5 masked": (3, 2001, 16, 5, True,
                                torch.float32)}.items():
        xe = normal(p, n, d).to(dtype)
        ce = normal(p, l, d)
        cp, lmask = ops._pad_centroids(ce) if masked else (ce, None)
        we = torch.ones((p, n), device=dev)
        lloyd_err = max(lloyd_err, check_lloyd(
            tag, xe, cp, lmask, we,
            DSUM_RTOL if dtype == torch.float32 else None)[0])
        pq_err = max(pq_err, check_pq(tag, xe, cp, lmask)[0])
    buf = torch.empty(3 * 1037 * DSUB + 1, device=dev)
    xm = buf[1:].view(3, 1037, DSUB)
    xm.copy_(normal(3, 1037, DSUB))
    cm = normal(3, 4, DSUB)
    lloyd_err = max(lloyd_err, check_lloyd(
        "misaligned", xm, cm, None, torch.ones((3, 1037), device=dev))[0])
    pq_err = max(pq_err, check_pq("misaligned", xm, cm)[0])

    # exact cover: every row is a centroid, so deviations and residuals are
    # exactly 0; a centroid far away is an empty cluster (count 0, sums 0);
    # on d8 (L = 4) and generic (L = 3)
    for l in (4, 3):
        ce = normal(4, l, DSUB)
        ce[:, -1] = 1e3
        pick = torch.randint(0, l - 1, (4, 2000), generator=gen).to(dev)
        xe = torch.gather(ce, 1, pick.unsqueeze(-1).expand(-1, -1, DSUB))
        ds, cnt = ops.lloyd_update(xe, ce)
        zt, resid, codes = ops.pq_quantize(xe, ce)
        torch.cuda.synchronize()
        if float(ds.abs().max()) != 0.0 or float(resid.abs().max()) != 0.0 \
                or not torch.equal(zt, xe) \
                or not torch.equal(codes.long(), pick):
            fail(f"exact cover is not an exact fixed point (L={l})")
        if float(cnt[:, -1].abs().max()) != 0.0:
            fail(f"the empty cluster has a nonzero count (L={l})")
    say("parity", "exact cover (L = 4 on d8, L = 3 on generic): dsums and "
        "residual exactly 0; empty cluster: count 0, dsums 0")

    errs = {"lloyd_update": lloyd_err, "pq_quantize": pq_err}
    errs["kmeans_assign"] = phase_assign_parity(gen, x, c)
    errs["scalar_quantize"] = phase_scalar_parity(gen)
    # pack_codes / unpack_codes: the standalone payload's codes, every
    # width at a ragged count
    codes = torch.randint(0, 1 << DL_BITS, (CLIENTS, DL_TOTAL),
                          generator=gen, dtype=torch.int32).to(dev)
    errs["pack_codes"] = errs["unpack_codes"] = check_pack("main", codes,
                                                           DL_BITS)
    for bits in PACK_BITS:
        ce = torch.randint(0, 1 << bits, (3, 999), generator=gen,
                           dtype=torch.int32).to(dev)
        check_pack("count 999", ce, bits)
    errs["flash_attention"] = phase_flash_parity(gen)
    for name, e in (*phase_tiled_parity(gen).items(),
                    *phase_generic_parity(gen).items()):
        errs[name] = max(errs.get(name, 0.0), e)
    return errs


def gmax() -> int:
    """lloyd_update's generic route's largest L on this card."""
    from repro_torch.kernels.lloyd_update import generic_max_l

    return generic_max_l(torch.device("cuda"))


def so_shapes(tiled: bool):
    """(tag, (P, N, D, L)) of the SO runs' k-means problems on
    lloyd_update's tiled route (tiled) or on its generic one."""
    out = {}
    for task, grid, cohort, rows, d in (
            ("Tag", TAG_GRID, TAG_COHORT, TAG_B, TAG_D),
            ("NWP", NWP_GRID, NWP_COHORT, NWP_B * NWP_SEQ, NWP_D)):
        for q, l in grid:
            if (l > gmax()) == tiled:
                out[f"SO {task} ({q}, {l})"] = (cohort, q * rows, d // q, l)
    return out


def tiled_shapes():
    """(tag, (P, N, D, L)) of the large-L checks on lloyd_update's tiled
    route: the SO runs' two tiled shapes, an L just above its generic
    route's threshold and an L of 2048 above N (most clusters empty)."""
    return {**so_shapes(True),
            f"L={gmax() + 1}": (4, 3001, 16, gmax() + 1),
            "L=2048": (2, 1500, 8, 2048)}


def generic_shapes():
    """(tag, (P, N, D, L)) of the checks on lloyd_update's generic route at
    large L: the SO runs' other five shapes and its largest L at D = 64."""
    return {**so_shapes(False), f"L={gmax()} D=64": (3, 2501, 64, gmax())}


def phase_tiled_parity(gen):
    """lloyd_update's tiled route, with pq_quantize's and kmeans_assign's
    generic routes, at the shapes of ``tiled_shapes``, in f32 and bf16,
    against their plain versions (lloyd_update bitwise its in-kernel-order
    version, pq_quantize and kmeans_assign codes equal but for near-ties;
    see check_lloyd, check_pq, check_kmeans_assign); lloyd_update bitwise
    run to run; a masked codebook; the three kernels' codes equal on rows
    midway between two centroids; exact cover and empty clusters. Returns
    the max errors under "<kernel>/<route>"."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.lloyd_update import (lloyd_update_kernel,
                                                  row_route)

    dev = torch.device("cuda")

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    errs = dict.fromkeys(("lloyd_update/tiled", "pq_quantize/generic",
                          "kmeans_assign/generic"), 0.0)

    def keep(name, e):
        errs[name] = max(errs[name], e)

    for tag, (p, n, d, l) in tiled_shapes().items():
        x, c = normal(p, n, d), normal(p, l, d)
        if row_route(x, l) != "tiled":
            fail(f"tiled parity {tag}: route {row_route(x, l)}")
        ones = torch.ones((p, n), device=dev)
        for xt, rtol in ((x, DSUM_RTOL), (x.to(torch.bfloat16), None)):
            dt = str(xt.dtype)[6:]
            keep("lloyd_update/tiled", check_lloyd(
                f"{tag} {dt}", xt, c, None, ones, rtol)[0])
            keep("pq_quantize/generic", check_pq(f"{tag} {dt}", xt, c)[0])
            keep("kmeans_assign/generic", check_kmeans_assign(
                f"{tag} {dt}", xt, c))
        ds, cnt = lloyd_update_kernel(x, None, c)
        ds2, cnt2 = lloyd_update_kernel(x, None, c)
        torch.cuda.synchronize()
        if not (torch.equal(ds, ds2) and torch.equal(cnt, cnt2)):
            fail(f"lloyd_update {tag}: two runs are not bitwise identical")
        empty = cnt == 0
        if bool((ds[empty] != 0).any()):
            fail(f"lloyd_update {tag}: an empty cluster has nonzero sums")
        say("parity", f"lloyd_update {tag}: two runs bitwise identical; "
            f"{int(empty.sum())} of {p * l} clusters empty (count 0, sums "
            f"0)")
    # a masked codebook (L = threshold + 1 padded to a multiple of 8)
    l = gmax() + 1
    xm = normal(3, 2001, 16)
    cp, lmask = ops._pad_centroids(normal(3, l, 16))
    wm = torch.ones((3, 2001), device=dev)
    keep("lloyd_update/tiled", check_lloyd("masked", xm, cp, lmask, wm)[0])
    keep("pq_quantize/generic", check_pq("masked", xm, cp, lmask)[0])
    keep("kmeans_assign/generic", check_kmeans_assign("masked", xm, cp,
                                                      lmask))
    # near-ties: rows midway between two centroids, at D = 16 and 32
    for l, d in ((gmax() + 1, 16), (960, 32)):
        ce = normal(1, l, d)
        a = torch.randint(0, l, (2, 4096), generator=gen).to(dev)
        xe = (ce[0, a[0]] + ce[0, a[1]]) / 2 \
            + 1e-7 * normal(4096, d)
        check_assign_codes(f"tiled L={l} near-ties", xe[None].contiguous(),
                           ce)
    # exact cover on the tiled route: every row a centroid, the last
    # centroid far away (an empty cluster)
    ce = normal(2, 100, 16)
    ce[:, -1] = 1e3
    pick = torch.randint(0, 99, (2, 3000), generator=gen).to(dev)
    xe = torch.gather(ce, 1, pick.unsqueeze(-1).expand(-1, -1, 16))
    ds, cnt = ops.lloyd_update(xe, ce)
    zt, resid, codes = ops.pq_quantize(xe, ce)
    torch.cuda.synchronize()
    if float(ds.abs().max()) != 0.0 or float(resid.abs().max()) != 0.0 \
            or not torch.equal(zt, xe) \
            or not torch.equal(codes.long(), pick) \
            or float(cnt[:, -1].abs().max()) != 0.0:
        fail("tiled: exact cover is not an exact fixed point")
    say("parity", "tiled exact cover (L = 100): dsums and residual exactly "
        "0, codes the picks; the empty cluster: count 0, dsums 0")
    return errs


def phase_generic_parity(gen):
    """The three clustering kernels on their generic routes at the shapes
    of ``generic_shapes`` (lloyd_update's largest L there, at D = 64, also
    in bf16), held as phase_tiled_parity holds them; lloyd_update bitwise
    run to run. Returns the max errors under "<kernel>/generic"."""
    from repro_torch.kernels.kmeans_assign import assign_route
    from repro_torch.kernels.lloyd_update import (lloyd_update_kernel,
                                                  row_route)
    from repro_torch.kernels.pq_quantize import pq_route

    dev = torch.device("cuda")
    errs = dict.fromkeys(("lloyd_update/generic", "pq_quantize/generic",
                          "kmeans_assign/generic"), 0.0)
    for tag, (p, n, d, l) in generic_shapes().items():
        x = torch.randn((p, n, d), generator=gen).to(dev)
        c = torch.randn((p, l, d), generator=gen).to(dev)
        routes = (row_route(x, l), pq_route(x, l), assign_route(x, l, None))
        if routes != ("generic",) * 3:
            fail(f"generic parity {tag}: routes {routes}")
        ones = torch.ones((p, n), device=dev)
        # a generic owner adds a block's 1024 rows in one chain, so at the
        # SO shapes its sums stray from the plain (matmul) order by more
        # than DSUM_RTOL (2.6e-5 of 1 + |plain| at SO Tag (250, 20) on an
        # H100); check_lloyd holds them bitwise to that order written out
        # and within γ·Σ|terms| of the f64 sum instead
        xs = (x,) if d != 64 else (x, x.to(torch.bfloat16))
        for xt in xs:
            dt = str(xt.dtype)[6:]
            for name, e in (
                    ("lloyd_update/generic", check_lloyd(
                        f"{tag} {dt}", xt, c, None, ones, None)[0]),
                    ("pq_quantize/generic",
                     check_pq(f"{tag} {dt}", xt, c)[0]),
                    ("kmeans_assign/generic",
                     check_kmeans_assign(f"{tag} {dt}", xt, c))):
                errs[name] = max(errs[name], e)
        ds, cnt = lloyd_update_kernel(x, None, c)
        ds2, cnt2 = lloyd_update_kernel(x, None, c)
        torch.cuda.synchronize()
        if not (torch.equal(ds, ds2) and torch.equal(cnt, cnt2)):
            fail(f"lloyd_update {tag}: two runs are not bitwise identical")
        say("parity", f"lloyd_update {tag}: two runs bitwise identical")
    return errs


def phase_assign_parity(gen, x, c):
    """kmeans_assign on both routes: the kmeans phase's grouping (d8, f32,
    L = 2), d8 in f32 and bf16 at L = 2 and 16 with a ragged N, generic
    masked (L = 3 in 8), unmasked L = 3, D = 16 and a misaligned view; its
    codes against pq_quantize's and lloyd_update's on d8, near-ties
    included. Returns the max |sqdist err|."""
    dev = x.device

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    from repro_torch.kernels import ops

    err = check_kmeans_assign("main", x, c)
    for tag, (p, n, d, l, masked, dtype) in {
            "ragged N": (3, 1037, DSUB, 2, False, torch.float32),
            "ragged N bf16": (3, 1037, DSUB, 2, False, torch.bfloat16),
            "L=16": (4, 5001, DSUB, 16, False, torch.float32),
            "L=16 bf16": (4, 5001, DSUB, 16, False, torch.bfloat16),
            "L=3 masked": (4, 5000, DSUB, 3, True, torch.float32),
            "L=3 masked bf16": (4, 5000, DSUB, 3, True, torch.bfloat16),
            "L=3": (4, 5000, DSUB, 3, False, torch.float32),
            "D=16 L=5": (3, 2001, 16, 5, False, torch.float32)}.items():
        cp, lmask = ops._pad_centroids(normal(p, l, d)) if masked \
            else (normal(p, l, d), None)
        err = max(err, check_kmeans_assign(tag, normal(p, n, d).to(dtype),
                                           cp, lmask))
    err = max(err, check_kmeans_assign(
        "misaligned", misaligned(normal(3, 1037, DSUB)), normal(3, 4, DSUB)))
    for l in (2, 16):
        ce = normal(2, l, DSUB)
        xe = normal(2, 6001, DSUB)
        pick = torch.randint(0, l, (2, 2, 3000), generator=gen).to(dev)
        mid = (torch.gather(ce, 1, pick[0].unsqueeze(-1).expand(-1, -1, 8))
               + torch.gather(ce, 1, pick[1].unsqueeze(-1).expand(-1, -1, 8)))
        xe[:, :3000] = mid / 2 + 1e-7 * xe[:, :3000]
        for dtype in (torch.float32, torch.bfloat16):
            check_assign_codes(f"L={l} near-ties", xe.to(dtype), ce)
    return err


def phase_scalar_parity(gen):
    """scalar_quantize on both routes, in f32 and bf16: the chain's carrier,
    the standalone scalarq shape, every width at N = 1036 (vec) and 1037
    (scalar) with a constant problem (scale 1), a misaligned view, and
    values exactly on half-levels and past both ends. Every check is
    bitwise: returns the max |err|, 0."""
    dev = torch.device("cuda")

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    # the weighted path's call: one client's carrier (P = 1)
    check_scalar("chain carrier, one client float32",
                 normal(1, DL_KEPT) * 1e-3, DL_BITS)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        check_scalar(f"chain carrier {name}",
                     (normal(CLIENTS, DL_KEPT) * 1e-3).to(dtype), DL_BITS)
        check_scalar(f"standalone {name}",
                     (normal(CLIENTS, DL_TOTAL) * 1e-4).to(dtype), DL_BITS)
        for n in (1036, 1037):
            for bits in (*PACK_BITS, 3):
                xe = normal(3, n)
                xe[2] = 0.5
                check_scalar(f"N={n} {name}", xe.to(dtype), bits)
        check_scalar(f"misaligned {name}",
                     misaligned(normal(3, 1036).to(dtype)), DL_BITS)
        # half-levels k + 1/2 (exact in bf16 below 128), rounded half to
        # even, below 0 clamped; past the top level clamped
        for n in (1036, 1037):
            half = torch.arange(n, device=dev) % 140 - 11.5
            xe = torch.stack([half, torch.arange(n, device=dev) * 0.5])
            check_scalar(f"half-levels N={n} {name}", xe.to(dtype), DL_BITS,
                         torch.zeros(2, device=dev),
                         torch.ones(2, device=dev))
    return 0.0


def make_batches(make_data, seed, steps):
    """``steps`` cohort batches: 10 clients drawn by weight, 20 examples
    each, concatenated client-major (the stacked executor's layout)."""
    data = make_data(num_clients=64, seed=0, device="cuda")
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        cohort = rng.choice(data.num_clients, size=CLIENTS, replace=False,
                            p=data.client_weights)
        parts = [data.sample_batch(int(k), rng, CLIENT_BATCH)
                 for k in cohort]
        batches.append({k: torch.cat([p[k] for p in parts])
                        for k in parts[0]})
    return batches


def phase_slice(seed, steps):
    from repro_torch.kernels import _build
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import sgd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    models = {}
    for backend in ("auto", "torch"):
        pq = PQConfig(num_subvectors=Q, num_clusters=L, num_groups=R,
                      kmeans_iters=ITERS, backend=backend)
        models[backend] = FemnistCNN(pq=pq, lam=LAM,
                                     client_batch=CLIENT_BATCH,
                                     device="cuda", generator=gen)
    model = models["auto"]
    state0 = TrainState.create(dict(model.named_parameters()), sgd(LR))
    batches = make_batches(make_federated_image_data, seed, steps)
    say("slice", f"FemnistCNN cut d={CUT_D}, PQ q={Q} L={L} R={R} "
        f"iters={ITERS}, {CLIENTS} clients x {CLIENT_BATCH}, λ={LAM}, "
        f"sgd({LR:.5f}), {steps} steps")

    step = make_train_step(model, sgd(LR))
    state, losses, times = state0, [], []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for b in batches:
        t0 = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        if len(losses) == 1:
            state1, met1 = state, met
    counts = _build.launch_counts()
    want = {"lloyd_update": ITERS * steps, "pq_quantize": steps}
    say("slice", f"launches in {steps} steps: {counts} (want {want})")
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite loss: {losses}")
    say("slice", "losses: " + " ".join(f"{v:.5f}" for v in losses))

    # step 1 again, from the same weights and batch, on the plain versions
    plain_step = make_train_step(models["torch"], sgd(LR))
    pstate, pmet = plain_step(state0, batches[0])
    torch.cuda.synchronize()
    if _build.launch_counts() != want:
        fail("the plain step launched a kernel")
    dloss = abs(float(pmet["loss"]) - losses[0])
    dpar = max(float((state1.params[k] - pstate.params[k]).detach().abs()
                     .max()) for k in pstate.params)
    say("slice", f"step 1 vs plain versions: loss {losses[0]:.6f} vs "
        f"{float(pmet['loss']):.6f} (|Δ| {dloss:.3e}), distortion "
        f"{float(met1['pq_distortion']):.4f} vs "
        f"{float(pmet['pq_distortion']):.4f}, max |Δparam| {dpar:.3e}")
    if not dloss <= LOSS_ATOL:
        fail(f"step-1 loss differs from the plain step by {dloss}")

    steady = times[2:] if len(times) > 3 else times
    step_ms = statistics.median(steady) * 1e3
    say("times", f"step: median {step_ms:.3f} ms (min "
        f"{min(steady) * 1e3:.3f}, max {max(steady) * 1e3:.3f}) over "
        f"{len(steady)} steps, {len(times) - len(steady) + 1}.."
        f"{len(times)} (host clock + synchronize); first step "
        f"{times[0] * 1e3:.1f} ms")

    def run3():
        st = state
        for b in batches[:3]:
            st, _ = step(st, b)
    return counts, run3


def phase_kmeans(gen):
    """batched_kmeans at the FEMNIST grouping on "auto" (the kernels: 5
    lloyd_update launches and 1 kmeans_assign) and on "torch" (none)."""
    from repro_torch.core import kmeans as km
    from repro_torch.kernels import _build, ref

    x = torch.randn((CLIENTS * R, M, DSUB), generator=gen).to("cuda")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = km.batched_kmeans(x, L, ITERS, backend="auto")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _build.launch_counts()
    want = {"lloyd_update": ITERS, "kmeans_assign": 1}
    say("kmeans", f"batched_kmeans x {tuple(x.shape)} L={L} iters={ITERS} "
        f"on 'auto': {ms:.3f} ms (host clock); launches {counts} (want "
        f"{want})")
    if counts != want:
        fail(f"kmeans launch counts {counts} != {want}")
    plain = km.batched_kmeans(x, L, ITERS, backend="torch")
    torch.cuda.synchronize()
    if _build.launch_counts() != want:
        fail("the plain kmeans launched a kernel")
    ties = ref.near_ties(x, plain.centroids, None, TIE_RTOL) \
        | ref.near_ties(x, res.centroids, None, TIE_RTOL)
    differ = res.codes.long() != plain.codes.long()
    if bool((differ & ~ties).any()):
        fail(f"kmeans: {int((differ & ~ties).sum())} codes differ from "
             f"'torch' away from near-ties")
    cerr = float((res.centroids - plain.centroids).abs().max())
    rel = float(((res.distortion - plain.distortion).abs()
                 / plain.distortion).max())
    if not rel <= 1e-5:
        fail(f"kmeans: distortion off by {rel} (relative) from 'torch'")
    say("kmeans", f"vs 'torch': {int(differ.sum())} codes differ (all "
        f"near-ties), max |Δcentroid| {cerr:.3e}, distortion "
        f"{float(res.distortion.mean()):.6f} vs "
        f"{float(plain.distortion.mean()):.6f} (max relative "
        f"{rel:.3e})")
    del x, res, plain
    return (counts, *kmeans_serve_cut(gen))


def kmeans_serve_cut(gen):
    """batched_kmeans on "auto" at the serve cut's size (4 problems of
    1048576 x 8, L = 16, 4 iterations) on a bf16 x: 4 lloyd_update launches
    and 1 kmeans_assign, all reading bf16 (no f32 copy: the peak allocation
    grows by less than 4 bytes per element of x), bitwise the same call on
    the f32 upcast; both calls timed on the host clock. Then kmeans_assign
    on this x and the call's own f32 centroids is held against its plain
    version (``check_kmeans_assign``), and its codes and distances give the
    call's codes and distortion bit for bit. Returns the launch counts and
    kmeans_assign's max |sqdist err| there."""
    from repro_torch.core import kmeans as km
    from repro_torch.kernels import _build
    from repro_torch.kernels.kmeans_assign import kmeans_assign_kernel

    p, n, d, l, iters = SERVE_B, SERVE_PQ_ROWS, SERVE_PQ_D, SERVE_PQ_L, 4
    seed = int(torch.randint(0, 1 << 30, (1,), generator=gen))
    xb = torch.randn((p, n, d), device="cuda", dtype=torch.bfloat16,
                     generator=torch.Generator("cuda").manual_seed(seed))
    km.batched_kmeans(xb[:, :4096], l, 1, backend="auto")   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = km.batched_kmeans(xb, l, iters, backend="auto")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _build.launch_counts()
    grew = torch.cuda.max_memory_allocated() - base
    want = {"lloyd_update": iters, "kmeans_assign": 1}
    say("kmeans", f"batched_kmeans x {tuple(xb.shape)} bfloat16 L={l} "
        f"iters={iters} on 'auto': {ms:.3f} ms (host clock); launches "
        f"{counts} (want {want}); peak allocation grew by {grew / 1e6:.1f} "
        f"MB ({grew / xb.numel():.2f} bytes per element of x; an f32 copy "
        f"would be {4 * xb.numel() / 1e6:.1f} MB)")
    if counts != want:
        fail(f"kmeans (serve cut) launch counts {counts} != {want}")
    if not grew < 4 * xb.numel():
        fail(f"kmeans (serve cut): the peak allocation grew by {grew} "
             f"bytes, an f32 copy of x or more")
    xf = xb.float()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    up = km.batched_kmeans(xf, l, iters, backend="auto")
    torch.cuda.synchronize()
    ms_f = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(res.centroids, up.centroids.to(torch.bfloat16))
            and torch.equal(res.codes, up.codes)
            and torch.equal(res.distortion, up.distortion)):
        fail("kmeans (serve cut): bf16 x differs from its f32 upcast")
    if not bool(torch.isfinite(res.distortion).all()):
        fail("kmeans (serve cut): non-finite distortion")
    say("kmeans", f"the same call on the f32 upcast: {ms_f:.3f} ms (host "
        f"clock); centroids (rounded to bf16), codes and distortion "
        f"{float(res.distortion.mean()):.6f} bitwise equal")
    del xf
    cents = km.batched_lloyd(xb, l, iters, backend="auto")
    if not torch.equal(cents, up.centroids):
        fail("kmeans (serve cut): the bf16 x's f32 centroids differ from "
             "its upcast's")
    err = check_kmeans_assign("serve cut", xb, cents)
    codes, sq = kmeans_assign_kernel(xb, cents)
    if not (torch.equal(res.codes, codes)
            and torch.equal(res.distortion, sq.sum(-1) / n)):
        fail("kmeans (serve cut): batched_kmeans's codes or distortion "
             "differ from kmeans_assign's on its own centroids")
    say("kmeans", "batched_kmeans's codes and distortion bitwise "
        "kmeans_assign's on its f32 centroids (bitwise the upcast's)")
    return counts, err


def phase_slice2(seed, steps):
    """The FEMNIST step with the chain downlink and a carried CutState."""
    from repro_torch.kernels import _build
    from repro_torch.core.compressors import CutState
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import sgd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    models = {}
    for backend, downlink in (("auto", DOWNLINK),
                              ("torch", DOWNLINK_PLAIN)):
        pq = PQConfig(num_subvectors=Q, num_clusters=L, num_groups=R,
                      kmeans_iters=ITERS, backend=backend)
        models[backend] = FemnistCNN(pq=pq, lam=LAM,
                                     client_batch=CLIENT_BATCH,
                                     downlink_compressor=downlink,
                                     device="cuda", generator=gen)
    model = models["auto"]
    say("slice2", f"FemnistCNN as the slice, downlink "
        f"{model.downlink_compressor.spec} (plain: "
        f"{models['torch'].downlink_compressor.stages[1].backend}), "
        f"CutState carried: step 1 cold ({ITERS} Lloyd iterations), later "
        f"steps warm ({WARM_ITERS}); {steps} steps")
    state0 = TrainState.create(dict(model.named_parameters()), sgd(LR))
    batches = make_batches(make_federated_image_data, seed + 1, steps)

    step = make_train_step(model, sgd(LR))
    state, cut, losses, times, kept = state0, CutState(), [], [], []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for b in batches:
        t0 = time.perf_counter()
        state, met = step(state, b, cut)
        cut_in, cut = cut, met.pop("cut_state")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        if len(kept) < 2:
            kept.append((state, cut_in, cut))
    counts = _build.launch_counts()
    want = {"lloyd_update": ITERS + WARM_ITERS * (steps - 1),
            "pq_quantize": steps, "scalar_quantize": steps}
    say("slice2", f"launches in {steps} steps: {counts} (want {want})")
    if counts != want:
        fail(f"slice-2 launch counts {counts} != {want}")
    if not all(np.isfinite(losses)):
        fail(f"slice 2: non-finite loss: {losses}")
    rounds = cut.quantizer.rounds.tolist()
    if rounds != [steps] * CLIENTS:
        fail(f"slice 2: the carried state counts rounds {rounds}")
    say("slice2", "losses: " + " ".join(f"{v:.5f}" for v in losses))

    # steps 1 and 2 again on the plain versions, from the same weights,
    # batch and carried state; the plain steps launch no kernel
    plain_step = make_train_step(models["torch"], sgd(LR))
    for i, (s_in, c_in) in enumerate(((state0, CutState()),
                                      (kept[0][0], kept[1][1]))):
        pstate, pmet = plain_step(s_in, batches[i], c_in)
        torch.cuda.synchronize()
        if _build.launch_counts() != want:
            fail("a plain slice-2 step launched a kernel")
        dloss = abs(float(pmet["loss"]) - losses[i])
        dpar = {part: max(float((kept[i][0].params[k] - pstate.params[k])
                                .detach().abs().max())
                          for k in pstate.params if k.startswith(part))
                for part in ("client.", "server.")}
        dcb = float((kept[i][2].quantizer.codebooks
                     - pmet["cut_state"].quantizer.codebooks).abs().max())
        say("slice2", f"step {i + 1} vs plain versions: loss {losses[i]:.6f}"
            f" vs {float(pmet['loss']):.6f} (|Δ| {dloss:.3e}); max "
            f"|Δparam| client {dpar['client.']:.3e}, server "
            f"{dpar['server.']:.3e}; max |Δcodebook| {dcb:.3e}")
        if not dloss <= (LOSS_ATOL if i == 0 else WARM_LOSS_ATOL):
            fail(f"slice-2 step {i + 1} loss differs from the plain step by "
                 f"{dloss}")

    steady = times[2:] if len(times) > 3 else times
    step_ms = statistics.median(steady) * 1e3
    say("times", f"slice-2 step: median {step_ms:.3f} ms (min "
        f"{min(steady) * 1e3:.3f}, max {max(steady) * 1e3:.3f}) over "
        f"{len(steady)} steps, {len(times) - len(steady) + 1}.."
        f"{len(times)} (host clock + synchronize); first step "
        f"{times[0] * 1e3:.1f} ms")

    def run3():
        st, c = state, cut
        for b in batches[:3]:
            st, m = step(st, b, c)
            c = m.pop("cut_state")
    return counts, run3, model, batches[0]


def trainer_counts_want(trace, cold_flushes=1):
    """The kernel launches a weighted-path run makes: the wire measurement
    (one cold PQ compress, one chain compress), then per participant of
    each flush one PQ compress (cold in the first flush, when no client
    has a codebook yet; warm, seeded, after) and one downlink chain."""
    clients = [len(r.participants) for r in trace]
    cold = sum(clients[:cold_flushes])
    warm = sum(clients[cold_flushes:])
    return {"lloyd_update": ITERS + ITERS * cold + WARM_ITERS * warm,
            "pq_quantize": 1 + cold + warm,
            "scalar_quantize": 1 + cold + warm}


def make_trainer(dev, gen, state=None, backend="auto", **kw):
    """The example's trainer (examples/femnist_federated_training.py:
    64 clients, cohort 10, client_batch 20, FemnistCNN(pq=PQConfig(1152, 2,
    kmeans_iters=5), lam=1e-4), sgd(10**-1.5)) on ``dev``; ``state`` (a
    state dict) replaces the model's random weights, ``backend`` is the
    PQ backend ("torch": the plain versions)."""
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.federated import FederatedTrainer
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import sgd

    data = make_federated_image_data(num_clients=64, seed=0, device=dev)
    pq = PQConfig(num_subvectors=Q, num_clusters=L, kmeans_iters=ITERS,
                  backend=backend)
    model = FemnistCNN(pq=pq, lam=LAM, client_batch=CLIENT_BATCH,
                       device=dev, generator=gen)
    if state is not None:
        model.load_state_dict(state)
    return FederatedTrainer(model, sgd(LR), data, cohort=CLIENTS,
                            client_batch=CLIENT_BATCH, device=dev, **kw)


def same_records(a, b) -> bool:
    """Two traces' records equal in every field but the metrics (times,
    participants, dropped, bytes, ledger), and their flight frames equal."""
    def fields(trace):
        return [{**r.__dict__, "metrics": None} for r in trace]
    return fields(a) == fields(b) and a.flights == b.flights


def update_gaps(before, card, cpu):
    """The card's update (card − before) against the CPU copies' (cpu −
    before): relative L2 gap over the client's and the server's parameters
    each, and the max |card − cpu|."""
    gaps, worst = {}, 0.0
    for part in ("client", "server"):
        keys = [k for k in before if k.startswith(part + ".")]
        d_cpu = torch.cat([(cpu[k].detach().float() - before[k]).reshape(-1)
                           for k in keys])
        d_card = torch.cat([(card[k].detach().float().cpu() - before[k])
                            .reshape(-1) for k in keys])
        gaps[part] = float((d_card - d_cpu).norm() / d_cpu.norm())
        worst = max(worst, float((d_card - d_cpu).abs().max()))
    return gaps, worst


def hold_to_cpu(tag, weights, card, cpu, seed, plain=None):
    """Run round (flush) 1 of the trainers ``card`` and ``cpu``, both built
    from ``weights``, and hold the card's loss, distortion, update and
    trace record to the CPU copies'. Where ``plain`` (the card's trainer
    on the plain versions) is given, also hold the card's update to its
    within UPDATE_RTOL, and to the CPU copies' within UPDATE_RTOL beyond
    the plain run's own gap from them (what the card's arithmetic outside
    the kernels makes). Returns the two traces."""
    from repro_torch.kernels import _build

    s_card, h_card = card.run(1, seed)
    torch.cuda.synchronize()
    seen = _build.launch_counts()
    s_cpu, h_cpu = cpu.run(1, seed)
    if plain is not None:
        s_plain, _ = plain.run(1, seed)
        torch.cuda.synchronize()
    if _build.launch_counts() != seen:
        fail(f"{tag}: a comparison on the plain versions launched a kernel")
    dloss = abs(h_cpu[0]["loss"] - h_card[0]["loss"])
    dist, dist_cpu = h_card[0]["pq_distortion"], h_cpu[0]["pq_distortion"]
    ddist = abs(dist - dist_cpu) / abs(dist_cpu)
    gaps, worst = update_gaps(weights, s_card.params, s_cpu.params)
    same = same_records(card.last_trace, cpu.last_trace)
    allow = dict.fromkeys(gaps, UPDATE_RTOL)
    extra = ""
    if plain is not None:
        on_host = {k: v.cpu() for k, v in s_plain.params.items()}
        to_plain, _ = update_gaps(weights, s_card.params, on_host)
        base, _ = update_gaps(weights, on_host, s_cpu.params)
        allow = {k: UPDATE_RTOL + v for k, v in base.items()}
        extra = (f"; against the plain versions on the card: update gap "
                 f"client {to_plain['client']:.3e}, server "
                 f"{to_plain['server']:.3e} (theirs from the CPU copies: "
                 f"client {base['client']:.3e}, server "
                 f"{base['server']:.3e})")
        if not max(to_plain.values()) <= UPDATE_RTOL:
            fail(f"{tag}: the update differs from the plain versions' on "
                 f"the card by {to_plain} (relative L2)")
    say("trainer", f"{tag} vs CPU copies (plain versions): loss "
        f"{h_card[0]['loss']:.6f} vs {h_cpu[0]['loss']:.6f} (|Δ| "
        f"{dloss:.3e}); distortion {dist:.4f} vs {dist_cpu:.4f} (relative "
        f"{ddist:.3e}); update gap in L2: client {gaps['client']:.3e}, "
        f"server {gaps['server']:.3e}; max |Δparam| {worst:.3e}; trace "
        f"record equal: {same}{extra}")
    if not dloss <= LOSS_ATOL:
        fail(f"{tag}: loss differs from the CPU copies' by {dloss}")
    if not ddist <= TRAIN_DIST_RTOL:
        fail(f"{tag}: distortion differs from the CPU copies' by {ddist} "
             f"(relative)")
    if any(not gaps[k] <= allow[k] for k in gaps):
        fail(f"{tag}: the update differs from the CPU copies' by {gaps} "
             f"(relative L2), above {allow}")
    if not same:
        fail(f"{tag}: the trace record differs from the CPU copies'")
    return card.last_trace, cpu.last_trace


def phase_trainer(seed, rounds, dev="cuda"):
    """The FEMNIST training run through FederatedTrainer: the main path
    (FullSync) and the weighted path (AsyncBuffer). Returns each path's
    launch counts and a function that runs 3 main-path rounds."""
    from repro_torch.federated import AsyncBuffer, mobile_fleet, wire
    from repro_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    trainer = make_trainer(dev, gen)
    weights = {k: v.detach().cpu().clone()       # the CPU check's copy
               for k, v in trainer.model.state_dict().items()}
    say("trainer", f"FederatedTrainer: 64 clients, cohort {CLIENTS} x "
        f"{CLIENT_BATCH}, FemnistCNN d={CUT_D}, PQ q={Q} L={L} "
        f"iters={ITERS}, λ={LAM}, sgd({LR:.5f}); main path: ideal fleet, "
        f"FullSync, executor {trainer.executor.name}, {rounds} rounds")

    marks = []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()

    def on_round(rd, cursor):
        torch.cuda.synchronize()     # a round's end, on the host clock
        marks.append(time.perf_counter())
    state, hist = trainer.run(rounds, seed, on_round=on_round)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    want = {"lloyd_update": ITERS * (rounds + 1), "pq_quantize": rounds + 1}
    say("trainer", f"launches in run({rounds}): {counts} (want {want}: "
        f"{rounds} rounds and the wire measurement's compress)")
    if counts != want:
        fail(f"trainer launch counts {counts} != {want}")
    trace = trainer.last_trace
    cfg = trainer.uplink.cfg
    frame = wire.wire_bits(cfg, CLIENT_BATCH, CUT_D) // 8
    up = trace.meta["uplink_bytes_per_client"]
    down = trace.meta["downlink_bytes_per_client"]
    dense = CLIENT_BATCH * CUT_D * 4
    say("trainer", f"uplink {up} B per client ({trace.meta['uplink_wire_kind']}"
        f" frame; the port's pq frame for n={CLIENT_BATCH} d={CUT_D} is "
        f"{frame} B), downlink {down} B ({trace.meta['downlink_wire_kind']})")
    if up != frame or trace.meta["uplink_wire_kind"] != "pq":
        fail(f"uplink bytes {up} != the pq frame's {frame}")
    if down != dense:
        fail(f"downlink bytes {down} != the dense cut's {dense}")
    losses = [h["loss"] for h in hist]
    if len(hist) != rounds or not all(np.isfinite(losses)):
        fail(f"history: {len(hist)} rounds, losses {losses}")
    if len(trace) != rounds or any(
            len(r.participants) != CLIENTS or r.dropped
            or r.uplink_bytes != CLIENTS * frame
            or r.downlink_bytes != CLIENTS * dense
            or r.ledger != {"uplink/pq": CLIENTS * frame,
                            "downlink/dense": CLIENTS * dense}
            for r in trace):
        fail("trace: " + str([(len(r.participants), r.dropped,
                                r.uplink_bytes, r.downlink_bytes)
                               for r in trace]))
    if not all(bool(torch.isfinite(p).all()) for p in state.params.values()):
        fail("non-finite parameters after the run")
    say("trainer", f"{len(trace)} rounds of {CLIENTS} participants, 0 "
        f"dropped, {trace.total_uplink_bytes} B up, "
        f"{trace.total_downlink_bytes} B down, simulated "
        f"{trace.simulated_seconds:.1f} s; losses: "
        + " ".join(f"{v:.5f}" for v in losses))

    # round 1 again from the same weights, on the card (a run of its own,
    # whose state is the state after round 1) and on CPU copies of the
    # weights and the data (the plain versions): the same batches (numpy
    # draws), the same cohort
    card1, cpu1 = hold_to_cpu(
        "round 1", weights,
        make_trainer(dev, torch.Generator().manual_seed(seed),
                     state=weights),
        make_trainer("cpu", torch.Generator().manual_seed(seed),
                     state=weights, backend="torch"), seed)
    if not same_records(card1, type(trace)(records=trace.records[:1],
                                           flights=trace.flights[:1])):
        fail("round 1 of run(1) differs from round 1 of the run")
    if cpu1.meta != trace.meta:
        fail("the CPU copies' measured bytes differ")

    per_round = np.diff([t0] + marks) * 1e3
    steady = per_round[1:]
    say("times", f"trainer round (FullSync, cohort {CLIENTS}): median "
        f"{statistics.median(steady):.3f} ms (min {steady.min():.3f}, max "
        f"{steady.max():.3f}) over rounds 2..{rounds}; round 1 (with the "
        f"wire measurement) {per_round[0]:.3f} ms; run({rounds}) "
        f"{run_s * 1e3:.1f} ms (host clock + synchronize)")
    dense_acts = trainer.measure_dense_bytes(state)
    client_bytes = sum(p.numel() * p.element_size()
                       for k, p in state.params.items()
                       if k.startswith("client."))
    say("trainer", f"uplink per client and round: activations {dense_acts} B "
        f"dense (SplitFed) vs {up} B pq frame (FedLite): "
        f"{dense_acts / up:.1f}x measured on the wire; with the client "
        f"model's {client_bytes} B: {(dense_acts + client_bytes) / (up + client_bytes):.1f}x; "
        f"analytic at φ=32: {cfg.compression_ratio(CLIENT_BATCH, CUT_D, 32):.1f}x")

    # the weighted path: AsyncBuffer flushes through make_weighted_step
    traces = {}
    for backend in ("heapq", "vector"):
        wt = make_trainer(dev, torch.Generator().manual_seed(seed),
                          fleet=mobile_fleet(64, flaky_fraction=0.3, seed=0),
                          policy=AsyncBuffer(4), downlink_compressor=DOWNLINK,
                          warm_start=True, scheduler_backend=backend)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t1 = time.perf_counter()
        _, whist = wt.run(rounds, seed)
        torch.cuda.synchronize()
        w_s = time.perf_counter() - t1
        wcounts = _build.launch_counts()
        traces[backend] = wt.last_trace
        wwant = trainer_counts_want(wt.last_trace)
        wl = [h["loss"] for h in whist]
        say("trainer", f"weighted path ({backend}): mobile fleet, "
            f"AsyncBuffer(4), downlink {wt.downlink.spec}, warm start: "
            f"{len(whist)} flushes of "
            f"{[len(r.participants) for r in wt.last_trace]} clients, "
            f"launches {wcounts} (want {wwant}), run {w_s * 1e3:.1f} ms; "
            f"losses " + " ".join(f"{v:.4f}" for v in wl))
        if wcounts != wwant:
            fail(f"weighted-path launch counts {wcounts} != {wwant}")
        if len(whist) != rounds or not all(np.isfinite(wl)) or not all(
                np.isfinite(h["mean_staleness_weight"]) for h in whist):
            fail(f"weighted path: {len(whist)} flushes, losses {wl}")
        if wt.last_trace.meta["downlink_wire_kind"] != "sparse" or \
                len(wt._client_q) == 0:
            fail("weighted path: no chain downlink or per-client state")
        weighted_counts = wcounts
    if not same_records(traces["heapq"], traces["vector"]):
        fail("the heapq and vector backends' traces differ")
    say("trainer", f"weighted path: the heapq and vector traces are equal "
        f"({len(traces['vector'])} records, "
        f"{traces['vector'].simulated_seconds:.3f} simulated s, "
        f"{traces['vector'].total_dropped} dropped)")
    # flush 1 (make_weighted_step at P = 1 per client, the chain downlink's
    # scalar_quantize) held to CPU copies, the downlink's plain version too
    weighted = dict(fleet=mobile_fleet(64, flaky_fraction=0.3, seed=0),
                    policy=AsyncBuffer(4), warm_start=True)
    card1, _ = hold_to_cpu(
        "weighted flush 1", weights,
        make_trainer(dev, torch.Generator().manual_seed(seed), state=weights,
                     downlink_compressor=DOWNLINK, **weighted),
        make_trainer("cpu", torch.Generator().manual_seed(seed),
                     state=weights, backend="torch",
                     downlink_compressor=DOWNLINK_PLAIN, **weighted), seed)
    if not same_records(card1, type(card1)(
            records=traces["vector"].records[:1],
            flights=traces["vector"].flights[:1])):
        fail("flush 1 of run(1) differs from flush 1 of the run")

    def steady_rounds(begin):
        # rounds 2-4 of run(4): the window opens after round 1, so the wire
        # measurement before round 1 stays out of it; the end of the run
        # (its one metrics transfer) is in it
        def on_round(rd, cursor):
            if rd == 0:
                begin()
        trainer.run(4, seed, on_round=on_round)
    return counts, weighted_counts, steady_rounds


def synced(dev):
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def timed_run(trainer, rounds, seed, dev, sync=True):
    """``trainer.run(rounds, seed)`` with each round's end on the host
    clock (synchronous policies: ``on_round``); returns (state, history,
    round times in ms)."""
    marks = []

    def on_round(rd, cursor):
        synced(dev)
        marks.append(time.perf_counter())
    synced(dev)
    t0 = time.perf_counter()
    state, hist = trainer.run(rounds, seed, on_round=on_round if sync
                              else None)
    synced(dev)
    return state, hist, np.diff([t0] + marks) * 1e3


def mesh_result(trainer, state, hist, ms):
    """What a mesh run is held on, as host values."""
    trace = trainer.last_trace
    return {"loss": [h["loss"] for h in hist],
            "params": {k: v.detach().cpu() for k, v in state.params.items()},
            "participants": [r.participants for r in trace],
            "bytes": [(r.uplink_bytes, r.downlink_bytes) for r in trace],
            "shards": [r.shards for r in trace],
            "round_ms": list(ms)}


def mesh_hold(tag, mesh, stacked, params=True):
    """A mesh run against the stacked run from the same weights: per-round
    losses within MESH_LOSS_RTOL, final params (unless ``params`` is
    False: then printed only) within MESH_PARAM_RTOL / MESH_PARAM_ATOL
    (the reference's stacked-vs-mesh bounds), the trace's participants and
    bytes equal. Returns the largest relative loss gap."""
    la, lb = np.asarray(mesh["loss"]), np.asarray(stacked["loss"])
    gap = float(np.max(np.abs(la - lb) / np.abs(lb))) if len(lb) else 0.0
    worst = max(float((a - stacked["params"][k]).abs().max())
                for k, a in mesh["params"].items())
    close = all(torch.allclose(a, stacked["params"][k], rtol=MESH_PARAM_RTOL,
                               atol=MESH_PARAM_ATOL)
                for k, a in mesh["params"].items())
    say("mesh", f"{tag} vs stacked: {len(la)} rounds, max relative loss gap "
        f"{gap:.3e} (bound {MESH_LOSS_RTOL}); max |Δparam| {worst:.3e} "
        f"({'held' if params else 'not held'}, within the bounds: "
        f"{close}); participants and bytes equal: "
        f"{mesh['participants'] == stacked['participants'] and mesh['bytes'] == stacked['bytes']}")
    if len(la) != len(lb) or not gap <= MESH_LOSS_RTOL \
            or not np.all(np.isfinite(la)):
        fail(f"{tag}: losses {la.tolist()} vs stacked {lb.tolist()}")
    if params and not close:
        fail(f"{tag}: params off from the stacked run's by {worst}")
    if mesh["participants"] != stacked["participants"] \
            or mesh["bytes"] != stacked["bytes"]:
        fail(f"{tag}: the trace's participants or bytes differ")
    return gap


def mesh_rank(rank, world, store, weights, seed, rounds, dev, out):
    """One of phase_mesh's gloo ranks (a spawned process): the FullSync
    run, its first MESH_PARAM_ROUNDS rounds and one DropSlowestK(1) round
    on a ``world``-shard mesh, each on ``dev`` from ``weights``; the
    results saved to ``out``."""
    import torch.distributed as dist

    from repro_torch.federated import DropSlowestK
    from repro_torch.federated.executor import MeshExecutor

    if torch.device(dev).type == "cuda":
        torch.cuda.set_device(0)
    # full f32, as the parent's phases run (a fresh process allows TF32
    # convolutions)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = {}
        for name, kw, n in (("sync", {}, rounds),
                            ("held", {}, MESH_PARAM_ROUNDS),
                            ("drop", {"policy": DropSlowestK(1)}, 1)):
            tr = make_trainer(dev, torch.Generator().manual_seed(seed),
                              state=weights, executor=MeshExecutor(
                                  shards=world, backend="gloo"), **kw)
            res[name] = mesh_result(tr, *timed_run(tr, n, seed, dev))
            res[name]["rank"] = tr.executor.rank
    finally:
        dist.destroy_process_group()
    torch.save(res, out)


def phase_mesh(seed, rounds, dev="cuda"):
    """The cohort-parallel executor (``executor="mesh"``) on the FEMNIST
    run at full width, against the stacked executor from the same
    weights: a world of one (NCCL) under FullSync with exact launch
    counts, and under AsyncBuffer(4) with the chain downlink; then two
    gloo ranks spawned on the one card (FullSync, and a DropSlowestK(1)
    round whose 9 clients pad one slot), rank 0 held to the stacked runs
    and the ranks bitwise equal; the round medians of the three. Returns
    the world of one's FullSync launches under "<kernel>/mesh" and the
    kernels' errors at a shard's shape (MESH_SHARD clients fused)."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.federated import AsyncBuffer, DropSlowestK, mobile_fleet
    from repro_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((MESH_SHARD, M, DSUB), generator=gen).to(dev)
    c = torch.randn((MESH_SHARD, L, DSUB), generator=gen).to(dev)
    errs = {"lloyd_update/mesh": check_lloyd(
                "mesh shard", x, c, None,
                torch.ones((MESH_SHARD, M), device=dev))[0],
            "pq_quantize/mesh": check_pq("mesh shard", x, c)[0]}
    weights = {k: v.detach().cpu().clone() for k, v in make_trainer(
        dev, torch.Generator().manual_seed(seed)).model.state_dict().items()}

    def build(**kw):
        return make_trainer(dev, torch.Generator().manual_seed(seed),
                            state=weights, **kw)

    st = build()
    stacked = mesh_result(st, *timed_run(st, rounds, seed, dev))
    mesh1 = build(executor="mesh")
    synced(dev)
    _build.reset_launch_counts()
    one = mesh_result(mesh1, *timed_run(mesh1, rounds, seed, dev))
    counts = _build.launch_counts()
    want = {"lloyd_update": ITERS * (rounds + 1), "pq_quantize": rounds + 1}
    backend = dist.get_backend()
    say("mesh", f"world of one ({backend}, "
        f"{mesh1.executor.num_shards} shard): launches in run({rounds}) "
        f"{counts} (want {want}: the stacked path's, the shard's clients "
        f"fused into one batch, and the wire measurement's compress)")
    if counts != want:
        fail(f"mesh launch counts {counts} != {want}")
    mesh_hold("mesh (world of one, FullSync)", one, stacked)

    weighted = dict(fleet=mobile_fleet(64, flaky_fraction=0.3, seed=0),
                    policy=AsyncBuffer(4), downlink_compressor=DOWNLINK,
                    warm_start=True)
    w_st = build(**weighted)
    w_stacked = mesh_result(w_st, *timed_run(w_st, rounds, seed, dev,
                                             sync=False))
    w_me = build(executor="mesh", **weighted)
    synced(dev)
    _build.reset_launch_counts()
    w_mesh = mesh_result(w_me, *timed_run(w_me, rounds, seed, dev,
                                          sync=False))
    w_counts, w_want = _build.launch_counts(), \
        trainer_counts_want(w_me.last_trace)
    say("mesh", f"world of one, AsyncBuffer(4) ('client' scope), downlink "
        f"{w_me.downlink.spec}, warm start: launches {w_counts} (want "
        f"{w_want})")
    if w_counts != w_want:
        fail(f"mesh weighted launch counts {w_counts} != {w_want}")
    mesh_hold("mesh (world of one, AsyncBuffer(4))", w_mesh, w_stacked)
    dist.destroy_process_group()

    drop = build(policy=DropSlowestK(1))
    drop_stacked = mesh_result(drop, *timed_run(drop, 1, seed, dev))
    st2 = build()
    held_stacked = mesh_result(st2, *timed_run(st2, MESH_PARAM_ROUNDS, seed,
                                               dev))
    world = MESH_RANKS
    say("mesh", f"{world} ranks on one card: gloo, asked for explicitly "
        f"(NCCL refuses two ranks on one device); the kernels were built "
        f"before the spawn")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=mesh_rank, args=(
            r, world, os.path.join(tmp, "store"), weights, seed, rounds, dev,
            os.path.join(tmp, f"rank{r}.pt"))) for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=MESH_JOIN_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            fail(f"mesh ranks exited {codes} (a rank failed or hung past "
                 f"{MESH_JOIN_S} s)")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
    say("mesh", f"{world} ranks spawned, ran and joined in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, ref, what in (
            ("sync", stacked, "FullSync"),
            ("held", held_stacked, f"FullSync, run({MESH_PARAM_ROUNDS})"),
            ("drop", drop_stacked, "DropSlowestK(1)")):
        first = ranks[0][name]
        # past a few rounds a near-tie PQ code flips between the two runs
        # (their weight gradients sum in other orders), and the runs then
        # part by more than the params' bounds: the long run's losses are
        # held, its params printed
        mesh_hold(f"mesh ({world} gloo ranks, {what})", first, ref,
                  params=name != "sync")
        for r, res in enumerate(rank[name] for rank in ranks):
            same = res["rank"] == r and res["loss"] == first["loss"] and all(
                torch.equal(v, first["params"][k])
                for k, v in res["params"].items())
            if not same:
                fail(f"mesh {name}: rank {r} differs from rank 0")
        spans = {s for rec in first["shards"] for s in rec}
        if spans != set(range(world)):
            fail(f"mesh {name}: shards {first['shards']}")
    drop_n = len(ranks[0]["drop"]["participants"][0])
    say("mesh", f"ranks bitwise equal (params, losses); shards "
        f"{sorted(spans)}; DropSlowestK(1) ran {drop_n} of {CLIENTS} "
        f"clients in {-(-drop_n // world) * world} slots")

    def med(ms):
        return statistics.median(ms[1:])
    say("times", f"mesh round medians over rounds 2..{rounds} (host clock + "
        f"synchronize): stacked {med(stacked['round_ms']):.3f} ms, mesh at "
        f"a world of one ({backend}) {med(one['round_ms']):.3f} ms, mesh at "
        f"{world} gloo ranks on one card (rank 0) "
        f"{med(ranks[0]['sync']['round_ms']):.3f} ms: the last measures "
        f"gloo's staging through the host, not scaling")
    return {f"{k}/mesh": v for k, v in counts.items()}, errs


@contextlib.contextmanager
def route_spy():
    """The routes lloyd_update and pq_quantize take while open: a list of
    (kernel, route), one entry per launch (each wrapper asks ``row_route``
    or ``pq_route`` once per call)."""
    from repro_torch.kernels import lloyd_update as lu
    from repro_torch.kernels import pq_quantize as pqk

    seen, orig = [], (lu.row_route, pqk.pq_route)

    def spy(kernel, fn):
        def route(x, l):
            r = fn(x, l)
            seen.append((kernel, r))
            return r
        return route
    lu.row_route = spy("lloyd_update", orig[0])
    pqk.pq_route = spy("pq_quantize", orig[1])
    try:
        yield seen
    finally:
        lu.row_route, pqk.pq_route = orig


def so_trainer(task, dev, data, q_l, seed, backend="auto", state=None):
    """The SO Tag or SO NWP trainer of bench_so_tasks.py on ``dev``:
    SplitFed where ``q_l`` is None, else FedLite with PQ (q, L). Weights
    are drawn from ``seed`` (``state``, a state dict, replaces them);
    ``backend`` is the PQ backend ("torch": the plain versions)."""
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.federated import FederatedTrainer
    from repro_torch.models.paper_models import SONwpLSTM, SOTagMLP
    from repro_torch.optim import adagrad, adam

    pq = None if q_l is None else PQConfig(
        num_subvectors=q_l[0], num_clusters=q_l[1], kmeans_iters=ITERS,
        backend=backend)
    lam = 0.0 if pq is None else SO_LAM
    gen = torch.Generator().manual_seed(seed)
    if task == "tag":
        model = SOTagMLP(TAG_BOW, TAG_D, TAG_TAGS, pq=pq, lam=lam,
                         client_batch=TAG_B, device=dev, generator=gen)
        opt, kw = adagrad(TAG_LR), dict(cohort=TAG_COHORT,
                                        client_batch=TAG_B)
    else:
        model = SONwpLSTM(NWP_VOCAB, NWP_D, NWP_HIDDEN, NWP_D, pq=pq,
                          lam=lam, client_batch=NWP_B, device=dev,
                          generator=gen)
        opt, kw = adam(NWP_LR), dict(cohort=NWP_COHORT, client_batch=NWP_B,
                                     batch_kwargs={"seq": NWP_SEQ})
    if state is not None:
        model.load_state_dict(state)
    return FederatedTrainer(model, opt, data, quantize=pq is not None,
                            device=dev, **kw), model


def predrawn_lm_data(data, seed, rounds):
    """The LM dataset with every batch a run(rounds, seed) can ask for
    (each client in rounds 1..rounds, and the wire measurement's) drawn
    ahead in 8 threads. The generator is numpy on the host, as the
    reference's is (and bitwise its draws): about 0.1 s of numpy a client
    batch, 5 s a round of 50 drawn one after another. A batch is found by
    the state of the fresh Generator the trainer hands ``sample_batch``
    (``runtime._batch_rng``), and drawn on the spot where it is not there.
    Returns (the dataset, seconds spent drawing, batches drawn)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.federated.runtime import _batch_rng

    def key_of(rng):
        return rng.bit_generator.state["state"]["state"]

    def draw(entropy):
        rng = _batch_rng(seed, *entropy)
        key = key_of(rng)
        return key, data.sample_batch(entropy[1], rng, NWP_B, seq=NWP_SEQ)

    wanted = [(r, c) for r in range(1, rounds + 1)
              for c in range(data.num_clients)] + [(0, 0)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        cache = dict(ex.map(draw, wanted))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    def sample(cid, rng, batch, seq=NWP_SEQ):
        hit = cache.get(key_of(rng)) if batch == NWP_B and seq == NWP_SEQ \
            else None
        return hit if hit is not None else data.sample_batch(cid, rng, batch,
                                                             seq=seq)
    return dataclasses.replace(data, sample_batch=sample), seconds, \
        len(wanted)


def on_cpu(data):
    """The dataset whose batches are ``data``'s, copied to the CPU (the
    tag batches are drawn on the card: a CPU generator would draw
    others)."""
    import dataclasses

    def sample(*a, **kw):
        return {k: v.cpu() for k, v in data.sample_batch(*a, **kw).items()}
    return dataclasses.replace(data, sample_batch=sample)


def phase_so_tasks(seed, dev="cuda"):
    """The paper's SO Tag and SO NWP runs through FederatedTrainer at full
    width (bench_so_tasks.py's runs, 3 rounds each): SplitFed and FedLite
    at each (q, L) of the paper's grids. Each run: exact launch counts
    (5 Lloyd iterations a round and the wire measurement's compress; none
    for SplitFed), the route of every launch (lloyd_update: tiled at L
    above its generic route's threshold, generic below; pq_quantize:
    generic), the uplink bytes per client equal to a CPU copy's
    measurement, finite losses, Recall@5 or accuracy on an eval batch,
    round times. Round 1 of the runs in SO_HOLD is held to CPU copies (the
    plain versions); the FPS seeding of the two tiled cuts is timed.
    Returns the launches per "<kernel>/<route>" over the SO runs, and
    kmeans_assign's in kmeans() at the NWP grouping, and the LM dataset
    with the batches of NWP_REC_ROUNDS rounds drawn ahead (the recovery
    phase runs on it)."""
    from repro_torch.core import kmeans as km
    from repro_torch.data.synthetic import (make_federated_lm_data,
                                            make_federated_tag_data)
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    tag_data = make_federated_tag_data(TAG_CLIENTS, TAG_BOW, TAG_TAGS,
                                       seed=0, device=dev)
    lm_data = make_federated_lm_data(NWP_CLIENTS, NWP_VOCAB, seed=0,
                                     device=dev)
    t0 = time.perf_counter()
    one = lm_data.sample_batch(0, np.random.default_rng(1), NWP_B,
                               seq=NWP_SEQ)
    one_s = time.perf_counter() - t0
    lm_data, draw_s, drawn = predrawn_lm_data(
        lm_data, seed, max(SO_ROUNDS, NWP_REC_ROUNDS))
    say("so", f"SO NWP batches: {one_s * 1e3:.1f} ms of numpy for one "
        f"client's {NWP_B} x {NWP_SEQ} tokens ({NWP_COHORT * one_s:.2f} s "
        f"a round of {NWP_COHORT} drawn one after another); {drawn} drawn "
        f"ahead in 8 threads in {draw_s:.2f} s (the round times below "
        f"leave them out)")
    evals = {"tag": tag_data.eval_batch(np.random.default_rng(99), 256),
             "nwp": lm_data.eval_batch(np.random.default_rng(98), 128,
                                       seq=NWP_SEQ)}
    route_counts = {}
    medians = {}
    for task, grid, data in (("tag", TAG_GRID, tag_data),
                             ("nwp", NWP_GRID, lm_data)):
        n_rows = TAG_B if task == "tag" else NWP_B * NWP_SEQ
        d = TAG_D if task == "tag" else NWP_D
        cohort = TAG_COHORT if task == "tag" else NWP_COHORT
        for q_l in (None,) + grid:
            name = f"SO {task.upper()} " + (
                "SplitFed" if q_l is None else f"FedLite q={q_l[0]} "
                f"L={q_l[1]}")
            trainer, model = so_trainer(task, dev, data, q_l, seed)
            weights = {k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()}
            marks = []

            def on_round(rd, cursor):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            with route_spy() as routes:
                t0 = time.perf_counter()
                state, hist = trainer.run(SO_ROUNDS, seed, on_round=on_round)
                torch.cuda.synchronize()
            counts = _build.launch_counts()
            want = {} if q_l is None else {
                "lloyd_update": ITERS * (SO_ROUNDS + 1),
                "pq_quantize": SO_ROUNDS + 1}
            if counts != want:
                fail(f"{name}: launch counts {counts} != {want}")
            route = None if q_l is None else \
                "tiled" if q_l[1] > gmax() else "generic"
            taken = {}
            for kernel, r in routes:
                key = f"{kernel}/{r}"
                taken[key] = taken.get(key, 0) + 1
            want_routes = {} if q_l is None else {
                f"lloyd_update/{route}": want["lloyd_update"],
                "pq_quantize/generic": want["pq_quantize"]}
            if taken != want_routes:
                fail(f"{name}: launches by route {taken}, want "
                     f"{want_routes}")
            for k, v in taken.items():
                route_counts[k] = route_counts.get(k, 0) + v
            losses = [h["loss"] for h in hist]
            if len(hist) != SO_ROUNDS or not all(np.isfinite(losses)) \
                    or not all(bool(torch.isfinite(v).all())
                               for v in state.params.values()):
                fail(f"{name}: losses {losses}")
            up = trainer.last_trace.meta["uplink_bytes_per_client"]
            cpu_tr, _ = so_trainer(task, "cpu", on_cpu(data), q_l, seed,
                                   backend="torch", state=weights)
            cpu_up = cpu_tr.measure_uplink_bytes(cpu_tr.init_state())
            if up != cpu_up:
                fail(f"{name}: uplink {up} B per client, the CPU copy's "
                     f"{cpu_up} B")
            model.load_state_dict({k: v.detach()
                                   for k, v in state.params.items()})
            metric = model.recall_at_5(evals[task]) if task == "tag" \
                else model.accuracy(evals[task])
            per_round = np.diff([t0] + marks) * 1e3
            medians[name] = statistics.median(per_round[1:])
            shape = "" if q_l is None else \
                f"; P={cohort} N={q_l[0] * n_rows} D={d // q_l[0]}"
            say("so", f"{name}: launches {counts}, lloyd_update's route "
                f"{route or '-'}{shape}; uplink {up} B per client (the CPU "
                f"copy's {cpu_up} B; dense {n_rows * d * 4} B); losses "
                + " ".join(f"{v:.5f}" for v in losses)
                + f"; {'Recall@5' if task == 'tag' else 'accuracy'} "
                f"{float(metric):.4f} on an eval batch")
            say("times", f"{name}: round median {medians[name]:.3f} ms "
                f"over rounds 2..{SO_ROUNDS} (rounds "
                + ", ".join(f"{v:.3f}" for v in per_round)
                + " ms; round 1 with the wire measurement)")
            if q_l is not None and (task, *q_l) in SO_HOLD:
                hold_to_cpu(
                    f"{name} round 1", weights,
                    so_trainer(task, dev, data, q_l, seed,
                               state=weights)[0],
                    so_trainer(task, "cpu", on_cpu(data), q_l, seed,
                               backend="torch", state=weights)[0], seed,
                    plain=so_trainer(task, dev, data, q_l, seed,
                                     backend="torch", state=weights)[0])
            del trainer, model, state, cpu_tr
        torch.cuda.empty_cache()
    # the FPS seeding of the two tiled cuts: L − 1 steps of a Python loop
    for run, (p, n, d, l) in (("SO TAG FedLite q=125 L=100",
                               (TAG_COHORT, 125 * TAG_B, TAG_D // 125, 100)),
                              ("SO NWP FedLite q=3 L=960",
                               (NWP_COHORT, 3 * NWP_B * NWP_SEQ, NWP_D // 3,
                                960))):
        x = torch.randn((p, n, d), device=dev)
        fps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            km._init_centroids(x, l)
            torch.cuda.synchronize()
            fps.append((time.perf_counter() - t0) * 1e3)
        fps_ms = statistics.median(fps)
        say("times", f"FPS seeding at L = {l} on {tuple(x.shape)}: "
            f"{fps_ms:.3f} ms (median of 3, host clock + synchronize), "
            f"{fps_ms / medians[run]:.1%} of the {run} round median; a "
            f"round seeds once")
    # kmeans() at the NWP grouping: batched_kmeans's kmeans_assign on its
    # generic route
    _build.reset_launch_counts()
    km.batched_kmeans(x, 960, ITERS)
    torch.cuda.synchronize()
    kc = _build.launch_counts()
    if kc != {"lloyd_update": ITERS, "kmeans_assign": 1}:
        fail(f"batched_kmeans at L = 960: launches {kc}")
    route_counts["kmeans_assign/generic"] = kc["kmeans_assign"]
    say("so", f"batched_kmeans {tuple(x.shape)} L=960: launches {kc}")
    return route_counts, lm_data


# ---------------------------------------------------------------------------
# runs that survive a crash, report their health and autoscale
# ---------------------------------------------------------------------------

def same_each_time(fn, repeats=DET_REPEATS):
    """``fn()`` (a list of tensors) ``repeats`` times: (every run bitwise
    the first, the largest |difference| seen)."""
    first, same, worst = fn(), True, 0.0
    for _ in range(repeats - 1):
        for a, b in zip(first, fn()):
            if not torch.equal(a, b):
                same = False
                worst = max(worst, float((a - b).detach().abs()
                                         .max()))
    return same, worst


def host_ms(fn, n=10):
    """Median host-clock time of ``fn()`` ending in a synchronize, ms."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def round_ms(trainer, seed, rounds=4):
    """Median host time of rounds 2..rounds of ``trainer.run(rounds)``."""
    marks = []

    def on_round(rd, cursor):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    torch.cuda.synchronize()
    trainer.run(rounds, seed, on_round=on_round)
    return statistics.median(np.diff(marks) * 1e3)


@contextlib.contextmanager
def unrepaired():
    """The step as it was before the determinism repair: the cuDNN scope
    open as a no-op, the NWP lookup by indexing."""
    from repro_torch.core import fedlite
    from repro_torch.models import paper_models
    saved = fedlite._deterministic_cudnn, paper_models._embed
    fedlite._deterministic_cudnn = contextlib.nullcontext
    paper_models._embed = lambda table, tokens: table[tokens]
    try:
        yield
    finally:
        fedlite._deterministic_cudnn, paper_models._embed = saved


def phase_determinism(seed):
    """A resumed run recomputes rounds and must be the run never killed,
    so a training step on the card must be a function of its inputs, bit
    for bit. Each of these runs DET_REPEATS times on the same inputs: the
    SO NWP embedding's backward at the NWP cohort's tokens (Zipf ids) by
    indexing and by F.embedding; the full-width FEMNIST FedLite step
    (cuDNN convolutions) and the SO NWP (48, 60) step, each with the
    repair (the port as it is) and without it. With the repair every run
    must be bitwise the first. Then the FEMNIST step and round times with
    and without the repair, in turns."""
    import torch.nn.functional as F

    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.models.paper_models import FemnistCNN, SONwpLSTM
    from repro_torch.optim import adam, sgd

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    n = NWP_COHORT * NWP_B
    ranks = torch.arange(1, NWP_VOCAB + 1, dtype=torch.float64)
    tokens = torch.multinomial(1 / ranks, n * NWP_SEQ, replacement=True,
                               generator=gen).reshape(n, NWP_SEQ).cuda()
    table = (torch.randn(NWP_VOCAB, NWP_D, generator=gen) * 0.02).cuda() \
        .requires_grad_()
    cot = torch.randn(n, NWP_SEQ, NWP_D, generator=gen).cuda()

    def lookup_grad(lookup):
        return lambda: list(torch.autograd.grad(
            (lookup(table, tokens) * cot).sum(), table))
    by_index = same_each_time(lookup_grad(lambda t, i: t[i]))
    by_embedding = same_each_time(lookup_grad(
        lambda t, i: F.embedding(i, t)))
    say("determinism", f"embedding backward at {n} x {NWP_SEQ} tokens "
        f"(vocab {NWP_VOCAB}, d {NWP_D}), {DET_REPEATS} runs: indexing "
        f"bitwise {by_index[0]} (max |Δ| {by_index[1]:.3e}), F.embedding "
        f"bitwise {by_embedding[0]} (max |Δ| {by_embedding[1]:.3e}); "
        f"times {host_ms(lookup_grad(lambda t, i: t[i])):.3f} vs "
        f"{host_ms(lookup_grad(lambda t, i: F.embedding(i, t))):.3f} ms")

    pq = PQConfig(num_subvectors=Q, num_clusters=L, num_groups=R,
                  kmeans_iters=ITERS)
    model = FemnistCNN(pq=pq, lam=LAM, client_batch=CLIENT_BATCH,
                       device="cuda", generator=gen)
    state0 = TrainState.create(dict(model.named_parameters()), sgd(LR))
    batch = make_batches(make_federated_image_data, seed, 1)[0]
    step = make_train_step(model, sgd(LR))

    def femnist():
        return list(step(state0, batch)[0].params.values())
    nwp = SONwpLSTM(NWP_VOCAB, NWP_D, NWP_HIDDEN, NWP_D,
                    pq=PQConfig(*NWP_REC, kmeans_iters=ITERS), lam=SO_LAM,
                    client_batch=NWP_B, device="cuda", generator=gen)
    nstate = TrainState.create(dict(nwp.named_parameters()), adam(NWP_LR))
    labels = torch.cat([tokens[:, 1:], torch.full((n, 1), -1,
                                                  device="cuda")], 1)
    nbatch = {"tokens": tokens, "labels": labels}
    nstep = make_train_step(nwp, adam(NWP_LR))

    def nwp_step():
        return list(nstep(nstate, nbatch)[0].params.values())
    repaired = {"FEMNIST": same_each_time(femnist),
                "SO NWP": same_each_time(nwp_step)}
    with unrepaired():
        before = {"FEMNIST": same_each_time(femnist),
                  "SO NWP": same_each_time(nwp_step)}
    for task in repaired:
        say("determinism", f"{task} step, {DET_REPEATS} runs from one "
            f"state and batch: bitwise {repaired[task][0]} with the repair"
            f" (max |Δparam| {repaired[task][1]:.3e}), {before[task][0]} "
            f"without it (max |Δparam| {before[task][1]:.3e})")
        if not repaired[task][0]:
            fail(f"two identical {task} steps differ on the card")

    turns = ("on", "off", "off", "on") * 2
    ms, rounds = [], []
    trainer = make_trainer("cuda", torch.Generator().manual_seed(seed))
    for tag in turns:
        with unrepaired() if tag == "off" else contextlib.nullcontext():
            ms.append(host_ms(femnist, n=20))
            rounds.append(round_ms(trainer, seed, rounds=6))

    def medians(xs):
        return " / ".join(
            f"{statistics.median([x for t, x in zip(turns, xs) if t == tag]):.3f}"
            for tag in ("on", "off"))
    say("times", f"FEMNIST step (cohort 10 x 20) and trainer round, the "
        f"repair on / off, in {len(turns)} turns ({'/'.join(turns)}): "
        f"step medians of 20 per turn "
        + ", ".join(f"{x:.3f}" for x in ms) + f" ms (median of turns "
        f"{medians(ms)} ms); round medians of rounds 2-6 of a run(6) "
        + ", ".join(f"{x:.3f}" for x in rounds) + f" ms (median of turns "
        f"{medians(rounds)} ms)")
    say("determinism", f"phase {time.perf_counter() - t_phase:.1f} s")


def counts_want(trace, runs, iters, warm_iters, warm, replayed=()):
    """The launches of ``runs`` ``FederatedTrainer.run`` calls that made
    ``trace``: each run's wire measurement (one cold PQ compress), then
    one compress per executed round (a voided round has no metrics), cold
    (``iters`` Lloyd iterations) in the first, and in every one without
    warm start, warm after; ``replayed`` rounds ran twice (executed in a
    segment the kill cut short, then again after the restore)."""
    executed = [r.round for r in trace if r.metrics]
    lloyd = {rd: iters if (not warm or i == 0) else warm_iters
             for i, rd in enumerate(executed)}
    again = [rd for rd in replayed if rd in lloyd]
    return {"lloyd_update": iters * runs + sum(lloyd.values())
            + sum(lloyd[rd] for rd in again),
            "pq_quantize": runs + len(executed) + len(again)}


def span_seconds(events, name):
    return [ev["t1"] - ev["t0"] for ev in events
            if ev.get("type") == "span" and ev.get("name") == name]


def step_bytes(ckpt_dir, step):
    """Bytes on disk of one checkpoint step: its npz, meta and manifest."""
    return sum(f.stat().st_size
               for f in Path(ckpt_dir).glob(f"*_{step:08d}.*"))


def recovery_pair(tag, make, rounds, seed, every, kill, work, warm):
    """``run_with_recovery`` of the trainer ``make(plan)`` twice, under
    its base plan and killed at round ``kill``; every result of the two
    held bitwise, launch counts exact; snapshot bytes, write and restore
    times, and the reference's deflated write of the newest snapshot's
    members. Returns the killed run's snapshot directory and its newest
    step."""
    from repro_torch import obs
    from repro_torch.federated import run_with_recovery
    from repro_torch.kernels import _build

    out = {}
    for name in ("unkilled", "killed"):
        trainer = make(name == "killed")
        iters = trainer.model.pq.kmeans_iters
        warm_iters = trainer.model.pq.effective_warm_iters
        rec = obs.configure(run=f"chip_smoke {tag} {name}")
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            state, hist = run_with_recovery(trainer, rounds, seed,
                                            str(work / name),
                                            checkpoint_every=every)
            torch.cuda.synchronize()
        finally:
            obs.shutdown()
        out[name] = (trainer, state, hist, _build.launch_counts(),
                     rec.events, time.perf_counter() - t0)
    (ta, sa, ha, ca, _, sec_a), (tb, sb, hb, cb, eb, sec_b) = \
        out["unkilled"], out["killed"]
    snaps = sorted(int(p.name[5:13]) for p in (work / "killed").glob(
        "ckpt_*.npz"))
    restored = max(s for s in snaps if s < kill)
    runs_a = -(-rounds // every)
    want_a = counts_want(ta.last_trace, runs_a, iters, warm_iters, warm)
    want_b = counts_want(tb.last_trace, runs_a + 1, iters, warm_iters, warm,
                         replayed=range(restored, kill))
    restarts = [ev for ev in eb if ev.get("name") == "fault.server_restart"]
    say("recovery", f"{tag}: {rounds} rounds, a snapshot every {every}; "
        f"unkilled {sec_a:.2f} s, launches {ca} (want {want_a}); killed at "
        f"round {kill} ({len(restarts)} restart, restored from the "
        f"round-{restored} snapshot) {sec_b:.2f} s, launches {cb} (want "
        f"{want_b})")
    if ca != want_a or cb != want_b:
        fail(f"{tag}: launch counts {ca} / {cb} != {want_a} / {want_b}")
    if len(restarts) != 1 or tb.fault_plan.server_kill_rounds != (kill,):
        fail(f"{tag}: {len(restarts)} restarts, plan after the run "
             f"{tb.fault_plan.server_kill_rounds}")
    same = {
        "params": all(torch.equal(sa.params[k], sb.params[k])
                      for k in sa.params),
        "optimizer state": sa.step == sb.step and all(
            torch.equal(x, y) if torch.is_tensor(x) else x == y
            for x, y in zip(flat_leaves(sa.opt_state),
                            flat_leaves(sb.opt_state))),
        "history": ha == hb,
        "trace records": ta.last_trace.records == tb.last_trace.records
        and len(tb.last_trace.records) == rounds,
        "flights": ta.last_trace.flights == tb.last_trace.flights,
    }
    say("recovery", f"{tag}: killed run bitwise the unkilled one: " + ", "
        .join(f"{k} {v}" for k, v in same.items()) + "; losses "
        + " ".join(f"{h['loss']:.5f}" for h in ha if "loss" in h))
    if not all(same.values()):
        fail(f"{tag}: the killed run differs from the unkilled one: {same}")
    saves = span_seconds(eb, "checkpoint.save")
    restores = span_seconds(eb, "checkpoint.restore")
    sizes = [step_bytes(work / "killed", s) for s in snaps]
    t0 = time.perf_counter()
    with np.load(work / "killed" / f"ckpt_{snaps[-1]:08d}.npz") as z:
        members = {k: z[k] for k in z.files}
    deflated = work / "deflated.npz"
    np.savez_compressed(deflated, **members)
    deflate_s = time.perf_counter() - t0
    say("recovery", f"{tag}: the round-{snaps[-1]} snapshot's members "
        f"deflated, as the reference's savez_compressed writes them: "
        f"{deflated.stat().st_size} B in {deflate_s * 1e3:.1f} ms (read "
        f"back included)")
    say("recovery", f"{tag}: snapshots at rounds {snaps}: "
        + ", ".join(f"{b} B in {t * 1e3:.1f} ms" for b, t in
                    zip(sizes, saves[-len(snaps):]))
        + f" (written {len(saves)} times in the killed run, save "
        f"{statistics.median(saves) * 1e3:.1f} ms median); restore "
        + ", ".join(f"{t * 1e3:.1f} ms" for t in restores))
    return work / "killed", snaps[-1]


def flat_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_leaves(tree[k])]
    return [tree]


def phase_recovery(seed, lm):
    """Kill-and-resume on the card: the femnist example's --chaos
    --warm-start run at full width (DEFAULT_CHAOS, warm start, error
    feedback, 9 rounds, a snapshot every 3, the server killed at round 7)
    and SO NWP at (48, 60) (4 rounds, a snapshot every 2, killed at round
    3): the killed run bitwise the unkilled one, launch counts exact; a
    snapshot with one payload byte flipped refuses to restore; an SO Tag
    TrainState at full width (5000 -> 2000 -> 1000, AdaGrad) saved and
    restored bitwise. ``lm`` is the SO NWP dataset with its batches drawn
    ahead."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.checkpointing import (CheckpointError,
                                           restore_checkpoint,
                                           save_checkpoint)
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.federated import DEFAULT_CHAOS, FaultPlan
    from repro_torch.federated.recovery import (state_from_leaves,
                                                state_leaves)
    from repro_torch.models.paper_models import SOTagMLP
    from repro_torch.optim import adagrad

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)

        def femnist(killed):
            plan = dataclasses.replace(DEFAULT_CHAOS, server_kill_rounds=(
                REC_KILL,)) if killed else DEFAULT_CHAOS
            return make_trainer("cuda", torch.Generator().manual_seed(seed),
                                fault_plan=plan, warm_start=True,
                                error_feedback=True)
        newest, step = recovery_pair("FEMNIST", femnist, REC_ROUNDS, seed,
                                     REC_EVERY, REC_KILL, work / "femnist",
                                     warm=True)
        flipped = work / "flipped"
        flipped.mkdir()
        for f in newest.glob(f"*_{step:08d}.*"):
            shutil.copy(f, flipped / f.name)
        npz = flipped / f"ckpt_{step:08d}.npz"
        data = bytearray(npz.read_bytes())
        data[len(data) // 2] ^= 0x01
        npz.write_bytes(bytes(data))
        try:
            restore_checkpoint(str(flipped), device="cuda")
        except CheckpointError as e:
            say("recovery", f"one payload byte of the round-{step} snapshot "
                f"flipped: CheckpointError ({str(e)[:60]}...)")
        else:
            fail("a snapshot with a flipped byte restored")

        def nwp(killed):
            trainer, _ = so_trainer("nwp", "cuda", lm, NWP_REC, seed)
            trainer.fault_plan = FaultPlan(
                server_kill_rounds=(NWP_REC_KILL,) if killed else ())
            return trainer
        recovery_pair(f"SO NWP {NWP_REC}", nwp, NWP_REC_ROUNDS, seed,
                      NWP_REC_EVERY, NWP_REC_KILL, work / "nwp", warm=False)

        gen = torch.Generator().manual_seed(seed)
        tag = SOTagMLP(TAG_BOW, TAG_D, TAG_TAGS, device="cuda", generator=gen)
        state = TrainState.create(dict(tag.named_parameters()),
                                  adagrad(TAG_LR))
        batch = {"bow": (torch.rand(TAG_B, TAG_BOW, generator=gen) < 0.01)
                 .float().cuda(),
                 "tags": (torch.rand(TAG_B, TAG_TAGS, generator=gen) < 0.005)
                 .long().cuda()}
        state, _ = make_train_step(tag, adagrad(TAG_LR), quantize=False)(
            state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(str(work / "tag"), 1, {"train": {
            f"{i:04d}": leaf for i, leaf in enumerate(state_leaves(state))}})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = restore_checkpoint(str(work / "tag"), device="cuda")
        back = state_from_leaves([tree["train"][k] for k in
                                  sorted(tree["train"])], state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(state.params[k], back.params[k])
                   for k in state.params) and all(
            torch.equal(state.opt_state["acc"][k], back.opt_state["acc"][k])
            for k in state.params) and back.step == state.step == 1 \
            and back.opt_state["step"] == 1 \
            and all(p.device.type == "cuda" and p.requires_grad
                    for p in back.params.values())
        say("recovery", f"SO Tag TrainState ({TAG_BOW} -> {TAG_D} -> "
            f"{TAG_TAGS}, AdaGrad, after one step): "
            f"{step_bytes(work / 'tag', 1)} B saved in {save_s * 1e3:.1f} "
            f"ms, restored in {restore_s * 1e3:.1f} ms, bitwise: {same}")
        if not same:
            fail("the SO Tag TrainState did not come back bitwise")
    say("recovery", f"phase {time.perf_counter() - t_phase:.1f} s")


def phase_health(seed, rounds=HEALTH_ROUNDS):
    """The femnist example's --chaos --emit-trace run: FederatedTrainer
    under DEFAULT_CHAOS with obs recording and slo_monitor=HealthMonitor
    (the default rules and one that must fail, so that the log holds an
    slo_violation event), the JSONL log written, then the port's inspector
    in this process on it: the report, --faults and --health (with a
    --slo rule that must fail) exit 0, the report counts the rounds run,
    --health grades the failing rule, every event name in the log is
    registered."""
    import io
    import tempfile

    from repro_torch import obs
    from repro_torch.federated import DEFAULT_CHAOS
    from repro_torch.kernels import _build
    from repro_torch.obs import inspect as inspector

    t_phase = time.perf_counter()
    rules = list(obs.DEFAULT_SLOS) + [obs.SloRule("impossible", "rounds",
                                                  ">=", 1000)]
    trainer = make_trainer("cuda", torch.Generator().manual_seed(seed),
                           fault_plan=DEFAULT_CHAOS,
                           slo_monitor=obs.HealthMonitor(rules))
    rec = obs.configure(run="chip_smoke health", meta={"rounds": rounds})
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    try:
        trainer.run(rounds, seed)
        torch.cuda.synchronize()
    finally:
        obs.shutdown()
    counts = _build.launch_counts()
    want = counts_want(trainer.last_trace, 1, ITERS, WARM_ITERS, warm=False)
    if counts != want:
        fail(f"health: launch counts {counts} != {want}")
    names = {ev["name"] for ev in rec.events if ev.get("type") == "event"}
    unregistered = sorted(n for n in names if not obs.is_registered_event(n))
    violations = [ev["args"]["rule"] for ev in rec.events
                  if ev.get("name") == "slo_violation"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "health.jsonl")
        rec.write_jsonl(path)
        outs = {}
        for flags in ((), ("--faults",), ("--health", "--slo",
                                          "rounds>=1000")):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = inspector.main([path, *flags])
            if code != 0:
                fail(f"health: the inspector {list(flags)} exited {code}")
            outs[flags] = buf.getvalue()
    header = outs[()].splitlines()[0]
    faults = outs[("--faults",)].splitlines()
    health = outs[("--health", "--slo", "rounds>=1000")].splitlines()
    say("health", f"{rounds} rounds under DEFAULT_CHAOS, launches {counts} "
        f"(want {want}); {len(rec.events)} events, event names "
        f"{sorted(names)}; slo_violation for {violations}; report: "
        f"'{header}'; faults: '{faults[-1]}'; " + "; ".join(
            line.strip() for line in health))
    if f"rounds: {rounds}" not in header:
        fail(f"health: the report counts other rounds: {header}")
    if violations != ["impossible"] or unregistered:
        fail(f"health: slo_violation for {violations}, unregistered event "
             f"names {unregistered}")
    if not any(line.strip().startswith("FAIL  rounds>=1000")
               for line in health):
        fail("health: --health --slo did not grade the failing rule")
    say("health", f"phase {time.perf_counter() - t_phase:.1f} s")


def phase_autoscale(seed):
    """The femnist example's --autoscale --fleet mobile at full width:
    autoscale_run over AUTO_ROUNDS rounds, re-planned every AUTO_INTERVAL
    by TraceAutoscaler(window=8, max_cohort=64); then again with a bytes
    budget of half the first segment's measured bytes per round, which
    must move the downlink to scalarq(bits=8) and so launch
    scalar_quantize (counted exactly). Every recorded segment trace gives
    its recorded plan again (the rules are pure)."""
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.federated import (AutoscalePlan, FederatedTrainer,
                                       TraceAutoscaler, autoscale_run,
                                       make_policy, mobile_fleet)
    from repro_torch.kernels import _build
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import sgd

    t_phase = time.perf_counter()
    data = make_federated_image_data(num_clients=64, seed=0, device="cuda")
    pq = PQConfig(num_subvectors=Q, num_clusters=L, kmeans_iters=ITERS)
    model = FemnistCNN(pq=pq, lam=LAM, client_batch=CLIENT_BATCH,
                       device="cuda",
                       generator=torch.Generator().manual_seed(seed))

    def make(plan, seg):
        return FederatedTrainer(
            model, sgd(LR), data, cohort=plan.cohort,
            client_batch=CLIENT_BATCH,
            fleet=mobile_fleet(64, flaky_fraction=0.3, seed=0),
            policy=make_policy(plan.policy),
            downlink_compressor=plan.downlink, seed=seg, device="cuda")

    budget = None
    for tag in ("unbudgeted", "budgeted"):
        controller = TraceAutoscaler(window=AUTO_INTERVAL, max_cohort=64,
                                     bytes_budget_per_round=budget)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = autoscale_run(make, AutoscalePlan(cohort=CLIENTS), AUTO_ROUNDS,
                            seed, controller=controller,
                            interval=AUTO_INTERVAL)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = _build.launch_counts()
        seg_plans = [out["plans"][out["history"][i]["plan"]]
                     for i in range(0, AUTO_ROUNDS, AUTO_INTERVAL)]
        for i, trace in enumerate(out["traces"][:-1]):
            again = controller.recommend(trace, seg_plans[i])
            nxt = seg_plans[i + 1]
            if (again.cohort, again.policy, again.downlink) != \
                    (nxt.cohort, nxt.policy, nxt.downlink) or (
                    again.moved_from(seg_plans[i])
                    and again.reason != nxt.reason):
                fail(f"autoscale: segment {i}'s trace recommends {again}, "
                     f"the run moved to {nxt}")
        scalar_runs = [i for i, p in enumerate(seg_plans)
                       if p.downlink == "scalarq(bits=8)"]
        want = len(scalar_runs) + sum(
            1 for t_i in scalar_runs for r in out["traces"][t_i]
            if r.metrics)
        say("autoscale", f"{tag} (budget {budget} B/round): {AUTO_ROUNDS} "
            f"rounds in {sec:.2f} s, launches {counts}; plans: " + "; ".join(
                f"cohort {p.cohort} {p.policy} downlink "
                f"{p.downlink or 'dense'} [{p.reason}]" for p in out["plans"])
            + "; bytes/round per segment "
            + ", ".join(f"{t.bytes_per_round(AUTO_INTERVAL):.0f}"
                        for t in out["traces"])
            + f"; uplink {out['uplink_bytes']} B, downlink "
            f"{out['downlink_bytes']} B, simulated "
            f"{out['simulated_seconds']:.1f} s")
        if not counts.get("lloyd_update") or not counts.get("pq_quantize"):
            fail(f"autoscale: the PQ kernels did not run: {counts}")
        if counts.get("scalar_quantize", 0) != want:
            fail(f"autoscale: scalar_quantize launched "
                 f"{counts.get('scalar_quantize', 0)} times, want {want}")
        losses = [h["loss"] for h in out["history"] if "loss" in h]
        if not np.isfinite(losses).all():
            fail(f"autoscale: losses {losses}")
        if budget is None:
            budget = out["traces"][0].bytes_per_round(AUTO_INTERVAL) / 2
    if seg_plans[1].downlink != "scalarq(bits=8)" or not want:
        fail(f"autoscale: the budgeted run's plans {out['plans']} did not "
             f"move the downlink to scalarq(bits=8)")
    say("autoscale", f"budgeted run: scalar_quantize launched {want} times "
        f"(1 per run and per executed round of the scalarq segments "
        f"{scalar_runs})")
    say("autoscale", f"phase {time.perf_counter() - t_phase:.1f} s")


def phase_payload(model, batch):
    """The slice's downlink payloads packed on the card: a cut cotangent of
    the slice's batch, through the chain (its 8-bit codes of the kept
    values, (10, 18432)) and through a standalone scalarq(bits=8) (codes
    of the whole cotangent, (10, 184320)); each packed into 8-bit words and
    unpacked."""
    import torch.nn.functional as F
    from repro_torch.core.compressors import (ScalarQuantCompressor,
                                              make_compressor)
    from repro_torch.kernels import _build, ops

    cut = model.client_forward(batch["image"]).detach().requires_grad_()
    loss = F.cross_entropy(model.server_logits(cut), batch["label"])
    (g,) = torch.autograd.grad(loss, cut)
    g = g.reshape(CLIENTS, CLIENT_BATCH, CUT_D)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    chain = make_compressor(DOWNLINK).compress(g).payload[1].codes
    full = ScalarQuantCompressor(bits=DL_BITS).compress(g).payload.codes
    full = full.reshape(CLIENTS, DL_TOTAL)
    packed = {}
    for tag, codes in (("chain", chain), ("scalarq", full)):
        words = ops.pack_codes(codes, DL_BITS)
        packed[tag] = (codes, words, ops.unpack_codes(words, codes.shape[1],
                                                      DL_BITS))
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    want = {"scalar_quantize": 2, "pack_codes": 2, "unpack_codes": 2}
    say("payload", f"launches: {counts} (want {want})")
    if counts != want:
        fail(f"payload launch counts {counts} != {want}")
    for tag, (codes, words, back) in packed.items():
        check_pack(f"{tag} payload", codes, DL_BITS)
        say("payload", f"{tag}: codes {tuple(codes.shape)} in "
            f"[{int(codes.min())}, {int(codes.max())}] -> "
            f"{words.numel() * 4} bytes ({codes.numel() * 4} as int32)")
    return counts, full.contiguous(), packed["scalarq"][1]


@contextlib.contextmanager
def plain_attention(q_chunk):
    """The plain route of the prefill's attention: row_block_attention over
    positions 0..S−1 in place of the flash kernel, for the comparisons of
    the serve phase (chip_smoke's own switch, not an option of the port)."""
    from repro_torch.models import attention

    real = attention.flash_prefill_attention

    def plain(q, k, v, *, window, scale):
        pos = torch.arange(q.shape[1], device=q.device)
        return attention.row_block_attention(q, k, v, pos, pos, window=window,
                                             q_chunk=q_chunk, scale=scale)
    attention.flash_prefill_attention = plain
    try:
        yield
    finally:
        attention.flash_prefill_attention = real


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()))


def phase_serve(seed):
    """Split serving of Llama-3 8B at full width, bf16: prefill with the PQ
    uplink, then greedy decode; launch counts, the flash kernel on real
    layers, the logits against the plain route, and the times."""
    import dataclasses
    from repro_torch.configs.llama3_8b import CONFIG as cfg
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.specs import make_model
    from repro_torch.models.transformer import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    B, P, G = SERVE_B, SERVE_P, SERVE_GEN
    model = make_model(cfg)
    plain_model = make_model(dataclasses.replace(cfg, pq_backend="torch"))
    pq = model.pq
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = model.init(torch.Generator(dev).manual_seed(seed), dev)
        prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                               generator=torch.Generator(dev)
                               .manual_seed(seed + 1))
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(params))
        say("serve", f"{cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
            f"d_ff={cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, cut "
            f"after {cfg.cut_periods} layers; {n_params / 1e9:.3f} B "
            f"parameters drawn in {time.perf_counter() - t0:.1f} s; {B} "
            f"prompts of {P} tokens, one client each, PQ q={pq.q} "
            f"L={pq.l} R={pq.r} iters={pq.kmeans_iters}; {G} greedy decode "
            f"steps")

        def prefill(m=model, quantize=True):
            caches = m.init_caches(B, P + G, dev)
            return m.prefill(params, {"tokens": prompt}, caches,
                             quantize=quantize)

        def decode(lg, caches):
            toks = []
            for i in range(G):
                nxt = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
                toks.append(nxt)
                lg, caches = model.decode_step(params, caches, nxt, P + i)
            return lg, torch.cat(toks, 1)

        t0 = time.perf_counter()
        prefill()                               # warm-up
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        _build.reset_launch_counts()
        lg0, caches = prefill()
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        want = {"flash_attention": cfg.num_layers,
                "lloyd_update": pq.kmeans_iters, "pq_quantize": 1}
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        lg_end, toks = decode(lg0, caches)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec_counts = _build.launch_counts()
        say("serve", f"launches in one prefill: {counts} (want {want}); in "
            f"{G} decode steps: {dec_counts} (want none)")
        if counts != want or dec_counts:
            fail(f"serve launch counts: prefill {counts} != {want} or "
                 f"decode {dec_counts} != {{}}")
        del caches
        if not (bool(torch.isfinite(lg0).all())
                and bool(torch.isfinite(lg_end).all())):
            fail("serve: non-finite logits")
        if not (int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size):
            fail("serve: a greedy token outside the vocabulary")
        say("serve", f"logits finite; first greedy tokens "
            f"{toks[:, 0].tolist()}, all {B}x{G} inside the vocabulary")

        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        pre_ms = statistics.median(times) * 1e3
        say("times", f"serve prefill {B}x{P}: median {pre_ms:.3f} ms (min "
            f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; 3 runs, "
            f"host clock + synchronize), {B * P / pre_ms * 1e3:.0f} tok/s; "
            f"first prefill {first_s * 1e3:.1f} ms")
        say("times", f"serve decode: {G} steps x{B} in {decode_s * 1e3:.3f} "
            f"ms, {decode_s / G * 1e3:.3f} ms per step, "
            f"{B * G / decode_s:.1f} tok/s")

        per_kernel = phase_profile("serve prefill", prefill, 1, "prefill")
        if per_kernel:
            flash_ms = sum(v for key, v in per_kernel.items()
                           if "flash_tc_kernel" in key
                           or "flash_cc_kernel" in key)
            say("times", f"serve prefill: flash_attention {flash_ms:.3f} ms, "
                f"{flash_ms / sum(per_kernel.values()):.1%} of device time")
            pq_ms = {name: sum(v for key, v in per_kernel.items()
                               if any(k in key for k in keys))
                     for name, keys in (
                         ("lloyd_update", ("lloyd_d8", "lloyd_generic",
                                           "lloyd_reduce")),
                         ("pq_quantize", ("pq_d8", "pq_generic")))}
            say("times", f"serve prefill: lloyd_update "
                f"{pq_ms['lloyd_update'] * 1e3:.2f} us and pq_quantize "
                f"{pq_ms['pq_quantize'] * 1e3:.2f} us of device time "
                f"(together {sum(pq_ms.values()) * 1e3:.2f} us)")
        lg, caches = prefill()
        phase_profile("serve decode", lambda: decode(lg, caches), G,
                      "decode step")
        del caches

        # the kernel against its plain version on two real layers' q, k, v
        # (the prefill passes the projections' (B, S, H, hd) views to the
        # strided entry; the check takes their (B·H, S, hd) copies)
        captured, calls = {}, [0]
        real_flash = ops.flash_attention_strided

        def record(q, k, v, **kw):
            if calls[0] in (0, cfg.num_layers - 1):
                captured[calls[0]] = (
                    *(t.transpose(1, 2).reshape(-1, *t.shape[1:2],
                                                t.shape[3])
                      for t in (q, k, v)), q.shape[2], k.shape[2], kw)
            calls[0] += 1
            return real_flash(q, k, v, **kw)
        ops.flash_attention_strided = record
        try:
            prefill()
        finally:
            ops.flash_attention_strided = real_flash
        err = 0.0
        for layer, (q, k, v, h, kv, kw) in sorted(captured.items()):
            err = max(err, check_flash(f"serve layer {layer}", q, k, v, h,
                                       kv, kw["window"], kw["scale"]))
        del captured

        pq_errs = phase_serve_routes(model, plain_model, params, prompt,
                                     lg0, seed)
        del params
    torch.cuda.empty_cache()
    phase_serve_path(seed, prompt)
    return counts, err, pq_errs


def client_cut(m, params, prompt):
    """The client's cut activation (B, S, d) of a prefill of ``prompt``."""
    caches = m.init_caches(*prompt.shape, prompt.device)
    return m.client_forward(params["client"], {"tokens": prompt},
                            mode="prefill", caches=caches["client"])[0]


def server_logits(m, params, prompt, z):
    """The server's last-token logits (B, Vp) f32 of a prefill from the
    cut ``z`` (z̃ where the uplink quantized it), as ``prefill`` takes
    them."""
    caches = m.init_caches(*prompt.shape, prompt.device)
    x = m.server_forward(params["server"], z, {"tokens": prompt},
                         mode="prefill", caches=caches["server"])[0]
    return m.logits(params, x[:, -1:])[:, 0]


def route_cuts(model, plain_model, params, prompt):
    """Each route's cut activation and its PQ (each route quantizing its
    own cut): ((acts, QuantizedBatch) of the kernel route, the same of the
    plain route)."""
    from repro_torch.core.quantizer import quantize
    from repro_torch.kernels import _build

    acts = client_cut(model, params, prompt)
    kernel = acts, quantize(acts, model.pq)
    launched = dict(_build.launch_counts())
    with plain_attention(model.cfg.attn_q_chunk):
        acts = client_cut(plain_model, params, prompt)
        plain = acts, quantize(acts, plain_model.pq)
    torch.cuda.synchronize()
    if _build.launch_counts() != launched:
        fail("the plain route launched a kernel")
    return kernel, plain


def nudge_ulp(x, share, gen):
    """x (bf16) with a random ``share`` of its nonzero elements moved one
    bf16 ulp up or down in magnitude (±1 on the bit pattern)."""
    pick = (torch.rand(x.shape, generator=gen, device=x.device) < share) \
        & (x != 0)
    step = torch.where(torch.rand(x.shape, generator=gen, device=x.device)
                       < 0.5, 1, -1).to(torch.int16)
    bits = x.view(torch.int16)
    return torch.where(pick, bits + step, bits).view(torch.bfloat16)


def phase_serve_routes(model, plain_model, params, prompt, lg0, seed):
    """Full depth, bf16: the kernel route against the plain route
    (row-block attention, PQ backend "torch"), stage by stage.

    The two routes' cuts differ at bf16 rounding, and a subvector near the
    boundary of two centroids then takes the other code, a step of a
    centroid distance (the farthest-point seeds may move too), so the
    end-to-end gap with the PQ uplink is no test of a kernel. What is held
    at SERVE_LOGIT_GAP is each stage on the same inputs: both PQ
    kernels against their plain versions on the kernel route's own cut at
    the serve shape (4 problems of 1048576 x 8, L = 16), and the two
    servers' logits from the same z̃ (and, without the uplink, from each
    route's own cut). A witness sizes the code flips without any kernel:
    the plain route against itself with its cut nudged by one bf16 ulp on
    as many elements as the two routes' cuts differ on; the end-to-end gap
    with the uplink is held under the larger of SERVE_LOGIT_GAP and the
    witness's gap. Returns the PQ kernels' max |err| on the serve cut."""
    from repro_torch.core import kmeans as km
    from repro_torch.core.quantizer import _to_groups, quantize
    from repro_torch.kernels import _build

    pq, dev = model.pq, prompt.device
    (acts_k, qb_k), (acts_p, qb_p) = route_cuts(model, plain_model, params,
                                                prompt)
    lg_k = server_logits(model, params, prompt, qb_k.dequantized)
    if not torch.equal(lg_k, lg0[:, -1]):
        fail("serve: the staged kernel route differs from prefill()")
    lg_k0 = server_logits(model, params, prompt, acts_k)

    # both PQ kernels on the kernel route's cut, grouped as the quantizer
    # groups it (in bf16, the cut's dtype), from the centroids the path
    # seeds (farthest-point) and the centroids it encodes with after its
    # Lloyd iterations; the f32 upcast of the groups must give the same
    # codebooks bitwise
    groups = _to_groups(acts_k, pq)
    seeds = km._init_centroids(groups, pq.num_clusters)
    cents = km.batched_lloyd(groups, pq.num_clusters, pq.kmeans_iters,
                             chunk=pq.kmeans_chunk, backend="cuda")
    if not torch.equal(cents.to(qb_k.codebooks.dtype),
                       qb_k.codebooks.reshape(cents.shape)):
        fail("serve cut: the re-run Lloyd iterations differ from the path's")
    cents_f = km.batched_lloyd(groups.float(), pq.num_clusters,
                               pq.kmeans_iters, chunk=pq.kmeans_chunk,
                               backend="cuda")
    if not torch.equal(cents, cents_f):
        fail("serve cut: Lloyd on the f32 upcast differs from bf16")
    say("serve", f"serve cut: Lloyd on the {groups.dtype} groups "
        f"{tuple(groups.shape)} gives the path's codebooks, and bitwise "
        f"those of its f32 upcast")
    # about 65536 rows a code: the plain order and the kernel's differ by
    # f32 rounding of Σ|terms|, not of |dsums| (the sums cancel near the
    # members' mean), so the plain-order check is the f64 one
    w = torch.ones(groups.shape[:2], device=dev)
    lloyd_err = max(
        check_lloyd("serve cut, seeds", groups, seeds, None, w, None)[0],
        check_lloyd("serve cut, final", groups, cents, None, w, None)[0])
    pq_err = check_pq("serve cut", groups, cents)[0]
    del groups, w

    share = float((acts_k != acts_p).float().mean())
    nudged = nudge_ulp(acts_p, share,
                       torch.Generator(dev).manual_seed(seed + 3))
    _build.reset_launch_counts()
    with plain_attention(model.cfg.attn_q_chunk):
        qb_n = quantize(nudged, plain_model.pq)
        lg_p = server_logits(plain_model, params, prompt, qb_p.dequantized)
        lg_p0 = server_logits(plain_model, params, prompt, acts_p)
        lg_pk = server_logits(plain_model, params, prompt, qb_k.dequantized)
        lg_n = server_logits(plain_model, params, prompt, qb_n.dequantized)
    torch.cuda.synchronize()
    if _build.launch_counts():
        fail(f"the plain route launched {_build.launch_counts()}")
    gap_raw, gap_same = rel_l2(lg_k0, lg_p0), rel_l2(lg_k, lg_pk)
    gap_pq, gap_nudge = rel_l2(lg_k, lg_p), rel_l2(lg_n, lg_p)
    same = float((qb_k.codes == qb_p.codes).float().mean())
    same_n = float((qb_n.codes == qb_p.codes).float().mean())
    say("serve", f"full depth bf16, kernel route vs plain route (no kernel "
        f"launched): cuts differ on {share:.3%} of elements (relative L2 "
        f"{rel_l2(acts_k, acts_p):.3e}); last-token logits relative L2 gap "
        f"{gap_raw:.3e} without the PQ uplink, {gap_same:.3e} from the same "
        f"z̃ (bound {SERVE_LOGIT_GAP} each)")
    say("serve", f"with the PQ uplink end to end: gap {gap_pq:.3e}, the "
        f"two routes' codes equal on {same:.4%} of subvectors; witness, "
        f"plain route vs itself with its cut nudged one bf16 ulp on "
        f"{share:.3%} of elements: gap {gap_nudge:.3e}, codes equal on "
        f"{same_n:.4%}")
    if not gap_raw <= SERVE_LOGIT_GAP:
        fail(f"serve: logits gap {gap_raw} to the plain route without PQ")
    if not gap_same <= SERVE_LOGIT_GAP:
        fail(f"serve: logits gap {gap_same} to the plain route from the "
             f"same z̃")
    if not gap_pq <= max(SERVE_LOGIT_GAP, gap_nudge):
        fail(f"serve: logits gap {gap_pq} with the PQ uplink, above both "
             f"{SERVE_LOGIT_GAP} and the one-ulp witness's {gap_nudge}")
    return {"lloyd_update": lloyd_err, "pq_quantize": pq_err}


def phase_serve_path(seed, prompt):
    """The f32 path check: llama3_8b at full width, 4 layers (cut after 2),
    f32, the same prompt; the kernel route against the plain route."""
    import dataclasses
    from repro_torch.configs.llama3_8b import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.launch.specs import make_model

    cfg = dataclasses.replace(CONFIG, dtype="float32",
                              param_dtype="float32", num_layers=4,
                              cut_periods=2)
    dev = torch.device("cuda")
    B, P = prompt.shape
    model = make_model(cfg)
    plain_model = make_model(dataclasses.replace(cfg, pq_backend="torch"))
    batch = {"tokens": prompt}
    with torch.inference_mode():
        params = model.init(torch.Generator(dev).manual_seed(seed + 2), dev)

        def last_logits(m, quantize):
            caches = m.init_caches(B, P, dev)
            return m.prefill(params, batch, caches,
                             quantize=quantize)[0][:, -1]

        lg_k, lg_kq = last_logits(model, False), last_logits(model, True)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with plain_attention(cfg.attn_q_chunk):
            lg_p = last_logits(plain_model, False)
            lg_pq = last_logits(plain_model, True)
        torch.cuda.synchronize()
        if _build.launch_counts():
            fail(f"the plain route launched {_build.launch_counts()}")
        (_, qb_k), (_, qb_p) = route_cuts(model, plain_model, params, prompt)
        rel = float(((lg_k - lg_p).abs() / (1 + lg_p.abs())).max())
        same = float((qb_k.codes == qb_p.codes).float().mean())
        drel = float(((qb_k.distortion - qb_p.distortion).abs()
                      / qb_p.distortion).max())
        say("serve", f"f32 path check ({cfg.num_layers} layers, cut after "
            f"{cfg.cut_periods}, B={B}, S={P}), kernel route vs plain route: "
            f"no PQ: last-token logits within {rel:.3e} of (1 + |plain|) "
            f"(bound {PATH_LOGIT_RTOL}); PQ: codes equal on {same:.6%} of "
            f"{qb_k.codes.numel()} subvectors (bound "
            f"{PATH_CODES_EQUAL:.1%}), distortion "
            f"{float(qb_k.distortion.mean()):.6f} vs "
            f"{float(qb_p.distortion.mean()):.6f} (max relative {drel:.3e}, "
            f"bound {PATH_DIST_RTOL}), last-token logits max |Δ| "
            f"{float((lg_kq - lg_pq).abs().max()):.3e}, relative L2 "
            f"{rel_l2(lg_kq, lg_pq):.3e}")
        if not rel <= PATH_LOGIT_RTOL:
            fail(f"f32 path check: logits off by {rel}")
        if not same >= PATH_CODES_EQUAL:
            fail(f"f32 path check: codes equal on only {same:.4%}")
        if not drel <= PATH_DIST_RTOL:
            fail(f"f32 path check: distortion off by {drel} (relative)")
        del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# LM training through launch/train.py (the main path of slice 7)
# ---------------------------------------------------------------------------

def lm_runs():
    """The three LM-training runs: (tag, config, driven through the CLI,
    steps).
    main: Llama-3 8B at full width, depth cut to LM_MAIN_LAYERS (the cut
    after 4 kept, so the server holds 2); SSM: Mamba2-1.3B as published,
    through ``python -m repro_torch.launch.train``'s ``main``; MoE:
    Mixtral-8x22B at full width, LM_MOE_LAYERS layers, the cut after 1."""
    import dataclasses
    from repro_torch.configs import llama3_8b, mamba2_1p3b, mixtral_8x22b
    return (("main", dataclasses.replace(llama3_8b.CONFIG,
                                         num_layers=LM_MAIN_LAYERS), False,
             LM_MAIN_STEPS),
            ("SSM", mamba2_1p3b.CONFIG, True, LM_STEPS),
            ("MoE", dataclasses.replace(mixtral_8x22b.CONFIG,
                                        num_layers=LM_MOE_LAYERS,
                                        cut_periods=1), False, LM_STEPS))


def lm_hold(tag, cfg, seed, dev="cuda"):
    """Step 1 of an LM run, stage by stage: the kernel route (PQ backend
    "auto": lloyd_update and pq_quantize) against the plain route (PQ
    backend "torch") on the card, from the run's own params and batch.
    The client forward bitwise; both kernels against their plain versions
    on the cut's groups (the path's seeds and final centroids); the two
    routes' codes equal on at least LM_CODES_EQUAL of the subvectors, z̃
    within LM_ZT_TOL·(1 + |z̃|) where they agree; the loss within
    LM_LOSS_RTOL; the step-1 CE within LM_CE_SLACK of ln(vocab); a finite,
    nonzero gradient norm. Returns (the step-1 loss, the kernels' max
    |err|)."""
    import dataclasses
    import math
    from repro_torch.core import fedlite
    from repro_torch.core import kmeans as km
    from repro_torch.core.quantizer import _to_groups, quantize
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.launch.specs import make_model

    model = make_model(cfg)
    plain = make_model(dataclasses.replace(cfg, pq_backend="torch"))
    pq = model.pq
    params = model.init(torch.Generator(dev).manual_seed(seed), dev)
    params = fedlite.nest_like(params, {
        k: v.requires_grad_() for k, v in fedlite.flat_params(params).items()})
    batch = train.make_batch(cfg, train.step_rng(seed, 0), LM_B, LM_S, dev)
    with torch.no_grad():
        acts = model.client_forward(params["client"], batch)[0]
        acts_p = plain.client_forward(params["client"], batch)[0]
        if not torch.equal(acts, acts_p):
            fail(f"lm {tag}: the client forward differs between the routes")
        del acts_p
        torch.cuda.synchronize()
        launched = dict(_build.launch_counts())
        qb_p = quantize(acts, plain.pq)
        torch.cuda.synchronize()
        if _build.launch_counts() != launched:
            fail(f"lm {tag}: the plain route launched a kernel")
        qb = quantize(acts, pq)
        groups = _to_groups(acts, pq)
        seeds = km._init_centroids(groups, pq.num_clusters)
        cents = km.batched_lloyd(groups, pq.num_clusters, pq.kmeans_iters,
                                 chunk=pq.kmeans_chunk, backend="cuda")
        if not torch.equal(cents.to(qb.codebooks.dtype),
                           qb.codebooks.reshape(cents.shape)):
            fail(f"lm {tag}: the re-run Lloyd iterations differ from the "
                 f"path's")
        w = torch.ones(groups.shape[:2], device=groups.device)
        lloyd_err = max(
            check_lloyd(f"lm {tag} cut, seeds", groups, seeds, None, w,
                        None)[0],
            check_lloyd(f"lm {tag} cut, final", groups, cents, None, w,
                        None)[0])
        pq_err = check_pq(f"lm {tag} cut", groups, cents)[0]
        del groups, w, seeds, cents
        same = (qb.codes == qb_p.codes).reshape(acts.shape[0], -1)
        share, n_sub = float(same.float().mean()), same.numel()
        zk = _to_groups(qb.dequantized, pq).float()
        zp = _to_groups(qb_p.dequantized, pq).float()
        zt_gap = float(torch.where(same.unsqueeze(-1),
                                   (zk - zp).abs() / (1 + zp.abs()),
                                   0.0).max())
        del zk, zp, same, qb, qb_p, acts
        loss_p, m_p = plain.loss(params, batch)
    loss, m, grads = fedlite._grads(model, params, batch, {})
    gnorm = math.sqrt(sum(float(g.float().square().sum())
                          for g in grads.values()))
    del grads, params, batch
    torch.cuda.empty_cache()
    ce, ln_v = float(m["ce"]), math.log(cfg.vocab_size)
    rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    say("lm", f"{tag} step 1, kernel route vs plain route: client forward "
        f"bitwise; codes equal on {share:.4%} of {n_sub} subvectors (floor "
        f"{LM_CODES_EQUAL:.0%}); z̃ within {zt_gap:.3e}·(1 + |z̃|) where "
        f"they agree (bound {LM_ZT_TOL}); loss {float(loss):.6f} vs "
        f"{float(loss_p):.6f} (relative {rel:.3e}, bound {LM_LOSS_RTOL}); "
        f"pq distortion {float(m['pq_distortion']):.6f} vs "
        f"{float(m_p['pq_distortion']):.6f}; ce {ce:.4f}, ln(vocab) "
        f"{ln_v:.4f}; aux {float(m['aux']):.6f}; grad norm {gnorm:.4e}")
    if not share >= LM_CODES_EQUAL:
        fail(f"lm {tag}: codes equal on only {share:.4%}")
    if not zt_gap <= LM_ZT_TOL:
        fail(f"lm {tag}: z̃ off by {zt_gap} on shared codes")
    if not rel <= LM_LOSS_RTOL:
        fail(f"lm {tag}: step-1 loss off by {rel} (relative)")
    if not abs(ce - ln_v) <= LM_CE_SLACK:
        fail(f"lm {tag}: step-1 ce {ce} far from ln(vocab) {ln_v}")
    if not (math.isfinite(gnorm) and gnorm > 0):
        fail(f"lm {tag}: grad norm {gnorm}")
    return float(loss), {"lloyd_update": lloyd_err, "pq_quantize": pq_err}


def fixed_batch(seed_, step):
    """lm_run's ``step_rng``: step 0's batch at every step."""
    return np.random.default_rng([seed_ + 1, 0])


def lm_run(tag, cfg, via_cli, seed, steps, dev="cuda", keep=False):
    """One LM-training run of ``steps`` steps, every step on step 0's
    batch (chip_smoke swaps the launcher's ``step_rng`` for the run), the
    last one profiled: through the CLI's ``main`` where ``via_cli``, else
    ``train(cfg, args)``. The launch counts are read around the run.
    Returns (counts, routes, the run's history, peak bytes, the profiled
    step's kernel times, the final params on the host where ``keep``)."""
    from repro_torch.core.fedlite import flat_params
    from repro_torch.kernels import _build
    from repro_torch.launch import train

    real_train, real_rng = train.train, train.step_rng
    out, lines = {}, []

    def run(begin):
        def fixed_rng(seed_, step):
            if step == steps - 1:
                begin()
            return fixed_batch(seed_, step)

        def recorded(*a, **kw):
            out["result"] = real_train(*a, **kw)
            return out["result"]
        argv = ["--arch", cfg.name, "--steps", str(steps), "--batch",
                str(LM_B), "--seq", str(LM_S), "--device", str(dev),
                "--seed", str(seed), "--log-every", "1"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        train.train, train.step_rng = recorded, fixed_rng
        try:
            with route_spy() as seen:
                if via_cli:
                    with contextlib.redirect_stdout(io.StringIO()) as buf:
                        train.main(argv)
                    lines.extend(buf.getvalue().splitlines())
                else:
                    train.train(cfg, train.parse_args(argv),
                                log=lines.append)
            torch.cuda.synchronize()
        finally:
            train.train, train.step_rng = real_train, real_rng
        out["counts"] = _build.launch_counts()
        out["routes"] = sorted(set(seen))
        out["peak"] = torch.cuda.max_memory_allocated()

    per_kernel = phase_profile(f"lm {tag}", run, 1, "step", opens=True)
    for line in lines:
        say("lm", f"{tag}: {line}")
    state, hist = out.pop("result")
    params = {k: v.detach().cpu() for k, v in
              flat_params(state.params).items()} if keep else None
    del state
    return (out["counts"], out["routes"], hist, out["peak"], per_kernel,
            params)


def phase_lm_train(seed, dev="cuda"):
    """The three LM-training runs of lm_runs(): each one's step 1 held
    stage by stage (lm_hold), then the run (lm_run) with exact launch
    counts and routes, finite losses that fall on the fixed batch, the
    step-1 loss of the run equal to the hold's within LM_LOSS_RTOL, the
    step time (median of steps 2..N−1, host clock with a synchronize),
    tokens/s, peak memory and the busy share of the profiled last step.
    Then the serve of Mamba2-1.3B (phase_ssm_serve). Returns (the main
    run's launch counts, the kernels' max |err| at the three cuts, the
    main run's losses, final params on the host and step time)."""
    import math
    torch.backends.cuda.matmul.allow_tf32 = False
    main_counts, errs = {}, {}
    for tag, cfg, via_cli, steps in lm_runs():
        t0 = time.perf_counter()
        loss1, e = lm_hold(tag, cfg, seed, dev)
        hold_s = time.perf_counter() - t0
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        t0 = time.perf_counter()
        counts, routes, hist, peak, _, params = lm_run(
            tag, cfg, via_cli, seed, steps, dev, keep=tag == "main")
        run_s = time.perf_counter() - t0
        iters = 4   # launch.specs.default_pq's Lloyd iterations
        want = {"lloyd_update": iters * steps, "pq_quantize": steps}
        losses = [float(h["loss"]) for h in hist]
        secs = [h["seconds"] for h in hist]
        step_s = statistics.median(secs[1:-1])
        say("lm", f"{tag}: {cfg.name}, {cfg.num_layers} layers (cut after "
            f"{cfg.cut_periods * cfg.period}), d={cfg.d_model}, vocab "
            f"{cfg.vocab_size}, {cfg.dtype}, {cfg.optimizer}; {LM_B} x "
            f"{LM_S} tokens, one client a sequence; launches {counts} "
            f"(want {want}), routes {routes}; losses "
            f"{[round(x, 4) for x in losses]}; step times "
            f"{[round(s * 1e3, 1) for s in secs]} ms (step 1 first, the "
            f"last profiled)")
        say("times", f"lm {tag}: step {step_s * 1e3:.3f} ms (median of "
            f"steps 2..{steps - 1}, host clock + synchronize), "
            f"{LM_B * LM_S / step_s:.0f} tokens/s; peak memory "
            f"{peak / 2**30:.2f} GiB; step-1 hold {hold_s:.1f} s, run "
            f"{run_s:.1f} s")
        if counts != want:
            fail(f"lm {tag}: launch counts {counts} != {want}")
        if routes != [("lloyd_update", "d8"), ("pq_quantize", "d8")]:
            fail(f"lm {tag}: routes {routes}")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            fail(f"lm {tag}: losses {losses} not finite and falling")
        if not abs(losses[0] - loss1) <= LM_LOSS_RTOL * abs(loss1):
            fail(f"lm {tag}: the run's step-1 loss {losses[0]} differs "
                 f"from the hold's {loss1}")
        say("lm", f"{tag}: the run's step-1 loss "
            f"{'equals' if losses[0] == loss1 else 'is within bound of'} "
            f"the hold's kernel-route loss")
        if tag == "main":
            main_counts = counts
            main_run = {"loss": losses, "params": params, "step_s": step_s}
        del hist
        torch.cuda.empty_cache()
    phase_ssm_serve(seed, dev)
    return main_counts, errs, main_run


# the production meshes' machinery (phase_sharded): the lm phase's Llama-3
# 8B run (LM_MAIN_LAYERS layers, LM_B x LM_S, SHARDED_STEPS steps on its
# fixed batch) and the Llama-3 8B serve (SERVE_B x SERVE_P, SHARDED_GEN
# steps) through the launchers under a (data=1, model=1) NCCL mesh, held
# to the same runs with --mesh none (the lm phase's main run, a serve):
# bitwise expected (every DTensor op runs its plain op on the whole
# tensor), else within the bounds; the dry runs of
# llama3_8b x train_4k on the fake 256- and 512-rank meshes. Ranks of a
# wider mesh are not run on the one card: DTensor's functional
# all-gather over gloo on CUDA tensors crashed the ranks (SIGSEGV in
# wait_tensor, torch 2.11.0+cu128), and NCCL refuses two ranks on one
# device; tests/test_torch_sharded_step.py holds 4 ranks on the CPU
SHARDED_STEPS, SHARDED_GEN = LM_MAIN_STEPS, 32
SHARDED_LOSS_RTOL = 1e-5
SHARDED_PARAM_TOL = 1e-5          # of (1 + |p|)
SHARDED_DRYRUN_S = 900


def param_gap(a, b):
    """(max |a − b| / (1 + |a|) over every param, the first param in key
    order that differs, or None)."""
    gap, first = 0.0, None
    for k in a:
        x, y = a[k].float(), b[k].float()
        if not torch.equal(a[k], b[k]) and first is None:
            first = k
        gap = max(gap, float(((x - y).abs() / (1 + x.abs())).max()))
    return gap, first


def dryrun_start(tmp):
    """``python -m repro_torch.launch.dryrun`` for llama3_8b x train_4k on
    both production meshes, started in a subprocess (it runs on the host's
    CPU while the card works)."""
    # one thread at the lowest priority: the phases it runs beside are
    # host-bound
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    with open(os.path.join(tmp, "dryrun.log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "llama3_8b", "--shape", "train_4k", "--mesh", "both", "--out",
             tmp, "--force"], env=env, cwd=str(ROOT), stdout=log,
            stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))


def dryrun_finish(proc, tmp):
    """Wait for dryrun_start's subprocess; print each record's per-device
    bytes against the card's HBM, its roofline bound and its host time."""
    from repro_torch.launch.mesh import HBM_BYTES, HBM_KEY
    try:
        proc.wait(timeout=SHARDED_DRYRUN_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"sharded: the dry run took more than {SHARDED_DRYRUN_S} s")
    with open(os.path.join(tmp, "dryrun.log")) as f:
        out = f.read()
    if proc.returncode != 0:
        fail(f"sharded: the dry run failed:\n{out[-3000:]}")
    recs = {}
    for mesh, world in (("single", 256), ("multi", 512)):
        with open(os.path.join(tmp, f"llama3_8b__train_4k__{mesh}.json")) \
                as f:
            rec = json.load(f)
        r = rec["roofline"]
        say("sharded", f"dry run llama3_8b x train_4k on {mesh} "
            f"({rec['mesh']}, a fake group of {rec['world']} ranks): per "
            f"device {rec['device_bytes'] / 2**30:.2f} GiB of "
            f"{HBM_BYTES / 2**30:.2f} GiB ({HBM_KEY}={rec[HBM_KEY]}); "
            f"{rec['cost']['flops'] / 1e12:.2f} TFLOP, "
            f"{rec['cost']['bytes_accessed'] / 1e12:.2f} TB accessed, "
            f"{rec['wire_bytes_per_device'] / 1e9:.2f} GB on the wire a "
            f"device; roofline bound {r['bound']} "
            f"{r['step_time_lower_bound_s'] * 1e3:.1f} ms (compute "
            f"{r['compute_s'] * 1e3:.1f}, memory {r['memory_s'] * 1e3:.1f},"
            f" collective {r['collective_s'] * 1e3:.1f} ms at the H100 "
            f"SXM5 datasheet's rates); traced in {rec['host_trace_s']:.1f} "
            f"s of host time, host peak RSS "
            f"{rec['host_peak_rss_bytes'] / 2**30:.2f} GiB")
        if rec["world"] != world or not rec["cost"]["flops"] > 0 \
                or not rec["collectives"]:
            fail(f"sharded: dry-run record {mesh} malformed: world "
                 f"{rec['world']}, flops {rec['cost']['flops']}, "
                 f"collectives {rec['collectives']}")
        recs[mesh] = rec
    return recs


def phase_sharded(seed, base, dry, tmp_dry, dev="cuda"):
    """The production meshes' machinery on the card: launch/
    train.py and launch/serve.py under a (data=1, model=1) NCCL mesh --
    the params DTensors, the cut's kernels and the prefill's flash kernel
    run on local blocks -- each held to the same run with --mesh none
    (the training to the lm phase's main run ``base``: losses and params;
    the serve's logits; bitwise expected), with the launch counts of the
    mesh runs, tokens/s of both and the DTensor dispatch overhead between
    them; then the dry runs' records (``dry``, started by dryrun_start,
    has run on the host's CPU meanwhile). Returns the mesh runs' launches
    under "<kernel>/sharded"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = sharded_runs(seed, base, dev)
    dryrun_finish(dry, tmp_dry)
    return counts


def sharded_runs(seed, base, dev):
    """phase_sharded's runs on the card (see there)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import llama3_8b
    from repro_torch.core.fedlite import flat_params
    from repro_torch.kernels import _build
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(1, 1, device=dev)
    say("sharded", f"mesh {mesh} over a {dist.get_backend()} world of "
        f"{dist.get_world_size()}")
    # the lm phase's main run (lm_run: the same config, seed and fixed
    # batch, SHARDED_STEPS = LM_MAIN_STEPS) with the mesh
    cfg = dataclasses.replace(llama3_8b.CONFIG, num_layers=LM_MAIN_LAYERS)
    argv = ["--arch", "llama3_8b", "--steps", str(SHARDED_STEPS),
            "--batch", str(LM_B), "--seq", str(LM_S), "--device", dev,
            "--seed", str(seed), "--log-every", "100"]
    counts = {}
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    real_rng, train.step_rng = train.step_rng, fixed_batch
    try:
        state, hist = train.train(cfg, train.parse_args(argv), mesh=mesh,
                                  log=lambda line: None)
    finally:
        train.step_rng = real_rng
    torch.cuda.synchronize()
    c = _build.launch_counts()
    params = {k: train.full(v).detach() for k, v in
              flat_params(state.params).items()}
    del state
    secs = [h["seconds"] for h in hist]
    loss = [float(h["loss"]) for h in hist]
    step_s = statistics.median(secs[1:-1])
    want = {"lloyd_update": 4 * SHARDED_STEPS, "pq_quantize": SHARDED_STEPS}
    gap, first = param_gap({k: v.to(dev) for k, v in
                            base["params"].items()}, params)
    del params
    loss_gap = max(abs(x - y) / abs(x) for x, y in zip(base["loss"], loss))
    same = base["loss"] == loss and first is None
    say("sharded", f"train: llama3_8b, {cfg.num_layers} layers, {LM_B} x "
        f"{LM_S}, {SHARDED_STEPS} steps on the lm phase's fixed batch; "
        f"launches under the mesh {c} (want {want}); losses "
        f"{[round(x, 6) for x in loss]}; "
        f"{'bitwise' if same else 'not bitwise'} the lm phase's main run "
        f"(--mesh none; largest loss gap {loss_gap:.3e} relative, "
        f"params {gap:.3e}·(1 + |p|), first param that differs {first})")
    say("times", f"sharded train: step {step_s * 1e3:.1f} ms under the "
        f"1 x 1 mesh vs {base['step_s'] * 1e3:.1f} ms without (median of "
        f"steps 2..{SHARDED_STEPS - 1}, host clock + synchronize): "
        f"{LM_B * LM_S / step_s:.0f} vs {LM_B * LM_S / base['step_s']:.0f}"
        f" tokens/s, DTensor dispatch overhead "
        f"{(step_s - base['step_s']) * 1e3:.1f} ms a step")
    if c != want:
        fail(f"sharded train: launch counts {c} != {want}")
    if not len(loss) == len(base["loss"]) or \
            not loss_gap <= SHARDED_LOSS_RTOL or not gap <= SHARDED_PARAM_TOL:
        fail(f"sharded train: the mesh run parts from --mesh none (loss "
             f"{loss_gap}, params {gap}, first param {first})")
    counts.update({f"{k}/sharded": v for k, v in c.items()})
    torch.cuda.empty_cache()

    sargv = ["--arch", "llama3_8b", "--batch", str(SERVE_B), "--prompt-len",
             str(SERVE_P), "--gen", str(SHARDED_GEN), "--device", dev,
             "--seed", str(seed)]
    outs, times = {}, {}
    for tag, m in (("none", None), ("mesh", mesh)):
        lines = []
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        logits = []
        tokens = serve.serve(llama3_8b.CONFIG, serve.parse_args(sargv),
                             mesh=m, log=lines.append,
                             on_logits=logits.append)
        torch.cuda.synchronize()
        times[tag] = time.perf_counter() - t0
        outs[tag] = {"logits": logits, "tokens": tokens,
                     "counts": _build.launch_counts()}
        say("sharded", f"serve ({tag}): " + "; ".join(lines))
        torch.cuda.empty_cache()
    a, b = outs["none"], outs["mesh"]
    lg_a, lg_b = a["logits"], b["logits"]
    same = all(torch.equal(x, y) for x, y in zip(lg_a, lg_b))
    lgap = max(float(((x - y).abs() / (1 + x.abs())).max())
               for x, y in zip(lg_a, lg_b))
    swant = {"flash_attention": llama3_8b.CONFIG.num_layers,
             "lloyd_update": 4, "pq_quantize": 1}
    say("sharded", f"serve: llama3_8b as published, {SERVE_B} x {SERVE_P} "
        f"prompts, PQ at the cut, {SHARDED_GEN} greedy steps; launches "
        f"under the mesh {b['counts']} (want {swant}); logits "
        f"{'bitwise' if same else 'not bitwise'} the --mesh none serve "
        f"(largest gap {lgap:.3e}·(1 + |v|)); {times['mesh']:.1f} s vs "
        f"{times['none']:.1f} s wall")
    if b["counts"] != swant or a["counts"] != swant:
        fail(f"sharded serve: launch counts {a['counts']} / {b['counts']} "
             f"!= {swant}")
    if not lgap <= SHARDED_PARAM_TOL:
        fail(f"sharded serve: logits part by {lgap}")
    if not all(torch.equal(x, y) for x, y in zip(a["tokens"], b["tokens"])):
        fail("sharded serve: the greedy tokens differ")
    counts["flash_attention/sharded"] = b["counts"]["flash_attention"]
    del outs, a, b, lg_a, lg_b
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return counts


def sharded_entries(kernels, counts):
    """The kernels line's "<kernel>/sharded" entries: the launches of the
    sharded runs (``counts``) beside the times, errors and bounds of the
    entries measured in this run at the same shapes -- at the 1 x 1 mesh
    a rank's block is the whole tensor, so lloyd_update's and
    pq_quantize's local rows are the lm_train cut's (LM_B, d/8·LM_S, 8)
    bf16 and flash's local heads the serve prefill's."""
    same = {"lloyd_update/sharded": "lloyd_update/lm_train",
            "pq_quantize/sharded": "pq_quantize/lm_train",
            "flash_attention/sharded": "flash_attention"}
    by_name = {e["name"]: e for e in kernels}
    return [dict(by_name[src], name=name, launches=counts.get(name, 0))
            for name, src in same.items()]


def phase_ssm_serve(seed, dev="cuda"):
    """``launch/serve.py`` on Mamba2-1.3B as published (SSM_SERVE_B
    prompts of SSM_SERVE_P tokens with the PQ uplink, SSM_SERVE_GEN decode
    steps): the launch counts (4 lloyd_update + 1 pq_quantize, in the
    prefill); then the SSM cache handoff (``handoff_gap``) at the
    published config in bf16 within SERVE_LOGIT_GAP, and in f32 at 4
    layers within SSM_HANDOFF_F32. The prefill's length is a multiple of
    the chunk: at any other length the scan runs one chunk of the whole
    prompt (the reference's rule), whose decay sums in bf16 lose their
    precision (a gap of 1.356 at P − 1 on an H100)."""
    import dataclasses
    from repro_torch.configs import mamba2_1p3b
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    cfg = mamba2_1p3b.CONFIG
    B, P = SSM_SERVE_B, SSM_SERVE_P
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        serve.main(["--arch", cfg.name, "--batch", str(B), "--prompt-len",
                    str(P), "--gen", str(SSM_SERVE_GEN), "--seed", str(seed),
                    "--device", str(dev)])
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    for line in buf.getvalue().splitlines():
        say("lm", f"serve {cfg.name}: {line}")
    want = {"lloyd_update": 4, "pq_quantize": 1}
    say("lm", f"serve {cfg.name}: launches {counts} (want {want}); "
        f"{wall:.1f} s in all")
    if counts != want:
        fail(f"ssm serve: launch counts {counts} != {want}")
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                num_layers=4, cut_periods=2)
    for c, bound_ in ((cfg, SERVE_LOGIT_GAP), (cfg32, SSM_HANDOFF_F32)):
        n, gap, finite = handoff_gap(c, seed, B, P, dev)
        say("lm", f"serve {cfg.name}: SSM cache handoff, {c.num_layers} "
            f"layers {c.dtype}: prefill({n}) + one decode step vs the "
            f"forward of {P} tokens at position {n}: logits relative L2 "
            f"gap {gap:.3e} (bound {bound_}), finite {finite}")
        if not (finite and gap <= bound_):
            fail(f"ssm serve: handoff gap {gap} ({c.dtype})")


def handoff_gap(cfg, seed, B, P, dev):
    """(n, relative L2 gap, finite): the logits of a prefill of n = P −
    ssm_chunk tokens and one decode step at n against the train-mode
    forward of P tokens at position n, random weights from ``seed``, no
    uplink."""
    from repro_torch.launch.specs import make_model

    model = make_model(cfg)
    n = P - cfg.ssm_chunk
    with torch.inference_mode():
        params = model.init(torch.Generator(dev).manual_seed(seed), dev)
        toks = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                             generator=torch.Generator(dev)
                             .manual_seed(seed + 1))
        batch = {"tokens": toks}
        acts = model.client_forward(params["client"], batch)[0]
        x = model.server_forward(params["server"], acts, batch)[0]
        lg_full = model.logits(params, x[:, n:n + 1])[:, 0]
        del acts, x
        caches = model.init_caches(B, P, dev)
        _, caches = model.prefill(params, {"tokens": toks[:, :n]}, caches)
        lg_dec = model.decode_step(params, caches, toks[:, n:n + 1],
                                   n)[0][:, 0]
        gap = rel_l2(lg_dec, lg_full)
        finite = bool(torch.isfinite(lg_dec).all())
        del params, caches
    torch.cuda.empty_cache()
    return n, gap, finite


def time_lm_pq(gen, counts, errs):
    """lloyd_update and pq_quantize at the LM runs' cuts (bf16, L = 16,
    grouped as the quantizer groups them: 8 problems of (d/8)·2048 rows
    of 8); the main run's cut gives the kernels line's two entries
    ("<kernel>/lm_train", with the main run's launches)."""
    dev = torch.device("cuda")
    entries = []
    # every run launches the same per step (phase_lm_train checks it)
    per_step = {k: v // LM_MAIN_STEPS for k, v in counts.items()}
    for tag, cfg, _, _ in lm_runs():
        n = cfg.d_model // 8 * LM_S
        x = torch.randn((LM_B, n, 8), generator=gen).to(dev, torch.bfloat16)
        c = torch.randn((LM_B, 16, 8), generator=gen).to(dev)
        got = time_pq_pair(f"the lm {tag} cut", x, c, per_step, "step")
        if tag == "main":
            for name, src, replaces in (
                    ("lloyd_update", "lloyd_update.cu",
                     "src/repro/kernels/lloyd_update.py:87"),
                    ("pq_quantize", "pq_quantize.cu",
                     "src/repro/kernels/pq_quantize.py:55")):
                k_ms, p_ms, b_ms, b_by = got[name]
                entries.append({
                    "name": f"{name}/lm_train", "route": "cuda",
                    "source": f"src/repro_torch/csrc/{src}",
                    "replaces": replaces, "launches": counts.get(name, 0),
                    "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del x, c
    return entries

def phase_profile(tag, run, n=3, unit="step", opens=False):
    """Device busy share: CUDA kernel time over wall time in a profiled
    window of ``n`` units. The window is all of ``run()``, or, with
    ``opens``, ``run(begin)`` from where it calls ``begin()`` to its end.
    Returns the device time of each kernel in ms per unit (empty where the
    profiler saw no device)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    opened = []

    def begin():
        torch.cuda.synchronize()
        prof.start()
        opened.append(time.perf_counter())
    if opens:
        run(begin)
    else:
        begin()
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - opened[0]) * 1e3
    prof.stop()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        say("times", f"{tag}: profiled {unit}: device time not measured (the "
            f"profiler reported none)")
        return {}
    say("times", f"{tag}: profiled {n} {unit}s: wall {wall_ms:.3f} ms, "
        f"device kernels {dev_ms:.3f} ms in "
        f"{sum(e.count for e in events) / n:.0f} launches per {unit}: busy "
        f"{dev_ms / wall_ms:.1%}, idle {1 - dev_ms / wall_ms:.1%}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        say("times", f"  {e.self_device_time_total / n / 1e3:9.4f} ms/{unit}"
            f"  {e.count / n:6.1f} launches/{unit}  {e.key[:70]}")
    return {e.key: e.self_device_time_total / n / 1e3 for e in events}


def lloyd_work(x, l, weights=None):
    """(bytes, operations) of one lloyd_update call: x and the codebook
    (and the weights, where given) read once, dsums and counts written
    once; per row 2·L·D for the scores, then D subtractions, D adds and a
    count (a multiply more per value where weighted)."""
    p, n, d = x.shape
    nb = x.numel() * x.element_size() + p * l * d * 4 + p * l * (d + 1) * 4
    if weights is not None:
        nb += weights.numel() * 4 + l * 4
    return nb, p * n * (2 * l * d + (3 if weights is not None else 2) * d
                        + 1)


def pq_work(x, l):
    """(bytes, operations) of one pq_quantize call: x and the codebook read
    once; z̃ (in x's dtype), the f32 residual and the int32 codes written
    once; per row 2·L·D for the scores and D subtractions."""
    p, n, d = x.shape
    nb = 2 * x.numel() * x.element_size() + x.numel() * 4 + p * n * 4 \
        + p * l * d * 4
    return nb, p * n * (2 * l * d + d)


def phase_times(gen, counts, errs, payload_codes, payload_words,
                serve_counts, assign_counts):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lloyd_update import lloyd_update_kernel
    from repro_torch.kernels.pq_quantize import pq_quantize_kernel
    from repro_torch.kernels.scalar_quant import (pack_codes_kernel,
                                                  unpack_codes_kernel)

    dev = torch.device("cuda")
    p = CLIENTS * R
    x = torch.randn((p, M, DSUB), generator=gen).to(dev)
    c = torch.randn((p, L, DSUB), generator=gen).to(dev)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = []
    # the main path's calls (no padding, no weights, L = 2 unmasked)
    rows.append(("lloyd_update", "src/repro_torch/csrc/lloyd_update.cu",
                 "src/repro/kernels/lloyd_update.py:87",
                 lambda: lloyd_update_kernel(x, None, c),
                 lambda: ref.lloyd_update_ref(x, None, c),
                 *lloyd_work(x, L)))
    rows.append(("pq_quantize", "src/repro_torch/csrc/pq_quantize.cu",
                 "src/repro/kernels/pq_quantize.py:55",
                 lambda: pq_quantize_kernel(x, c),
                 lambda: ref.pq_quantize_ref(x, c),
                 *pq_work(x, L)))
    # pack / unpack at the standalone scalarq payload: 4 bytes per code in
    # or out, b/8 bytes per code the other way; a mask, shift and OR per code
    rows.append(("pack_codes", "src/repro_torch/csrc/scalar_quant.cu",
                 "src/repro/kernels/scalar_quant.py:86",
                 lambda: pack_codes_kernel(payload_codes, DL_BITS),
                 lambda: ref.pack_codes_ref(payload_codes, DL_BITS),
                 nbytes(payload_codes, payload_words),
                 3 * payload_codes.numel()))
    rows.append(("unpack_codes", "src/repro_torch/csrc/scalar_quant.cu",
                 "src/repro/kernels/scalar_quant.py:111",
                 lambda: unpack_codes_kernel(payload_words, DL_TOTAL,
                                             DL_BITS),
                 lambda: ref.unpack_codes_ref(payload_words, DL_TOTAL,
                                              DL_BITS),
                 nbytes(payload_codes, payload_words),
                 2 * payload_codes.numel()))
    kernels = []
    for name, source, replaces, kern, plain, nb, flops in rows:
        k_ms = device_ms(kern)
        p_ms = device_ms(plain)
        k_eager = eager_ms(kern)
        b_ms, b_by = bound(nb, flops)
        say("times", f"{name}: kernel {k_ms * 1e3:.2f} us (device, CUDA "
            f"graph), {k_eager * 1e3:.2f} us per eager call; plain "
            f"{p_ms * 1e3:.2f} us; bound {b_ms * 1e3:.2f} us by {b_by} "
            f"({nb / 1e6:.2f} MB, {flops / 1e6:.1f} MOP)")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": counts.get(name, 0),
                        "max_abs_err": errs[name], "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    # like for like with PR 14's call of the same step: rows padded to the
    # 4096-row chunk with 0/1 weights, L = 2 padded to 8 and masked
    xp_ = torch.nn.functional.pad(x, (0, 0, 0, M_PAD - M))
    wp_ = (torch.arange(M_PAD, device=dev) < M).float() \
        .expand(p, -1).contiguous()
    cp, lmask = ops._pad_centroids(c)
    k_ms = device_ms(lambda: lloyd_update_kernel(xp_, wp_, cp, lmask))
    nb, flops = lloyd_work(xp_, cp.shape[1], wp_)
    b_ms, b_by = bound(nb, flops)
    say("times", f"lloyd_update as PR 14 called it (x {tuple(xp_.shape)} "
        f"padded, weights, L = {L} padded to {cp.shape[1]} and masked): "
        f"kernel {k_ms * 1e3:.2f} us (device, CUDA graph); bound "
        f"{b_ms * 1e3:.2f} us by {b_by} ({nb / 1e6:.2f} MB)")
    kernels.append(time_flash(gen, counts, errs))
    time_serve_pq(gen, serve_counts)
    kernels += time_assign_scalar(gen, counts, errs, assign_counts)
    return kernels


def time_flash(gen, counts, errs):
    """flash_attention at the serve prefill's shape (B=4, H=32, Kv=8,
    S=2048, hd=128, bf16, the tensor_core route): the contiguous entry on
    (B·H, S, hd) and the strided entry on the (B, S, H, hd) views of a
    fused tensor (the path's entry), the plain version, and one PyTorch
    call that computes the same function (scaled_dot_product_attention,
    causal, GQA), each timed between CUDA events over back-to-back calls
    (a fraction of a millisecond or more each, so the host's launch cost
    hides behind the device's work)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bshd,
                                                     flash_attention_kernel,
                                                     flash_route)

    B, H, KV, S, HD = SERVE_B, 32, 8, SERVE_P, 128
    q, k, v = flash_inputs(gen, torch.bfloat16, B, H, KV, S, HD)
    kw = dict(num_q_heads=H, num_kv_heads=KV, scale=HD ** -0.5)
    views = strided_views(q, k, v, B)
    q4, k4, v4 = (t.view(B, -1, S, HD) for t in (q, k, v))
    c_ms = eager_ms(lambda: flash_attention_kernel(q, k, v, **kw), calls=50)
    s_ms = eager_ms(lambda: flash_attention_bshd(*views, scale=kw["scale"]),
                    calls=50)
    p_ms = eager_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), calls=5)
    lib_ms = eager_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=kw["scale"], enable_gqa=True),
        calls=50)
    lib = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                         scale=kw["scale"], enable_gqa=True)
    ours = flash_attention_kernel(q, k, v, **kw).view(B, H, S, HD)
    lib_gap = float((lib.float() - ours.float()).abs().max())
    # each input read once, the output written once; 4·hd operations per
    # causal (query, key) pair: q·k and p·v, a multiply and an add each
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    flops = 4 * HD * (S * (S + 1) // 2) * B * H
    b_ms, b_by = bound(nbytes, flops, BF16_TC_FLOP_PER_S)
    f32_ms = flops / F32_FLOP_PER_S * 1e3
    say("times", f"flash_attention (route {flash_route(q.dtype, HD)}): "
        f"strided entry {s_ms:.4f} ms ({flops / s_ms / 1e9:.1f} TFLOP/s), "
        f"contiguous entry {c_ms:.4f} ms ({flops / c_ms / 1e9:.1f} "
        f"TFLOP/s); plain {p_ms:.4f} ms; scaled_dot_product_attention "
        f"{lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s; max |Δ| to "
        f"ours {lib_gap:.3e}); bound {b_ms:.4f} ms by {b_by} on the bf16 "
        f"tensor cores ({nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP; "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms of bytes, {f32_ms:.4f} ms "
        f"at the f32 CUDA-core peak)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:104",
            "launches": counts.get("flash_attention", 0),
            "max_abs_err": errs["flash_attention"], "ms": s_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def time_pq_pair(where, x, c, launches, unit):
    """lloyd_update and pq_quantize on x (P, N, D) with the codebook c,
    no weights, no mask: each one's device time (CUDA graph) beside its
    plain version's (eager), its bound and ``launches[name]`` launches a
    ``unit``, printed; returns {name: (ms, plain ms, bound ms, bound by)}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lloyd_update import (lloyd_update_kernel,
                                                  row_route)
    from repro_torch.kernels.pq_quantize import pq_quantize_kernel

    l = c.shape[1]
    rows = [("lloyd_update", lambda: lloyd_update_kernel(x, None, c),
             lambda: ref.lloyd_update_ref(x, None, c), lloyd_work(x, l)),
            ("pq_quantize", lambda: pq_quantize_kernel(x, c),
             lambda: ref.pq_quantize_ref(x, c), pq_work(x, l))]
    out = {}
    for name, kern, plain, (nb, flops) in rows:
        k_ms = device_ms(kern, calls=20, reps=10)
        p_ms = eager_ms(plain, calls=5)
        b_ms, b_by = bound(nb, flops)
        n = launches.get(name, 0)
        say("times", f"{name} at {where} ({tuple(x.shape)} {x.dtype}, L = "
            f"{l}, route {row_route(x, l)}): kernel {k_ms * 1e3:.2f} us "
            f"(device, CUDA graph), plain {p_ms * 1e3:.2f} us; bound "
            f"{b_ms * 1e3:.2f} us by {b_by} ({nb / 1e6:.1f} MB, "
            f"{flops / 1e6:.1f} MOP), {b_ms / k_ms:.1%} of it reached; {n} "
            f"launches per {unit}, {n * k_ms * 1e3:.2f} us per {unit} "
            f"({n * (k_ms - b_ms) * 1e3:.2f} us above the bound)")
        out[name] = (k_ms, p_ms, b_ms, b_by)
    return out


def time_serve_pq(gen, serve_counts):
    """lloyd_update and pq_quantize at the serve prefill's cut, grouped as
    the quantizer groups it (4 problems of 1048576 x 8, L = 16, no
    weights, no mask), with x in f32 and in bf16 (the serve path's)."""
    dev = torch.device("cuda")
    p, n, d = SERVE_B, SERVE_PQ_ROWS, SERVE_PQ_D
    x32 = torch.randn((p, n, d), generator=gen).to(dev)
    c = torch.randn((p, SERVE_PQ_L, d), generator=gen).to(dev)
    for x in (x32, x32.to(torch.bfloat16)):
        time_pq_pair("the serve cut", x, c, serve_counts, "prefill")


def assign_work(x, l):
    """(bytes, operations) of one kmeans_assign call: x and the codebook
    read once, a code and a distance written per row; per row 2·L·D for the
    scores and 2·D for ‖x‖²."""
    p, n, d = x.shape
    return (x.numel() * x.element_size() + p * l * d * 4 + 2 * p * n * 4,
            p * n * (2 * l * d + 2 * d))


def scalar_work(x):
    """(bytes, operations) of one scalar_quantize call: x, lo and scale read
    once, codes and recon written once; a subtract, divide, round, two
    clamps, a multiply and an add per value."""
    p, n = x.shape
    return (x.numel() * x.element_size() + 2 * p * 4 + 2 * p * n * 4,
            7 * p * n)


def time_assign_scalar(gen, counts, errs, assign_counts):
    """kmeans_assign and scalar_quantize at the shapes their users reach,
    each with its floor (a one-element call on each route), the time of
    the call as it was before the redesign (the kept route on an f32 copy:
    generic for kmeans_assign, forced by an all-valid mask; scalar for
    scalar_quantize, forced on the aligned tensor), the plain version's
    time, the
    bound, the share of it reached (not for shapes that fit in the 50 MB L2:
    those are L2-resident) and the launches per path. Returns their two
    entries of the kernels line (at the FEMNIST grouping and one client's
    chain carrier, the calls of the paths their launches are counted on)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_assign import (assign_route,
                                                   kmeans_assign_kernel)
    from repro_torch.kernels.scalar_quant import (scalar_quantize_kernel,
                                                  scalar_route)

    dev = torch.device("cuda")
    cuda_gen = torch.Generator("cuda").manual_seed(
        int(torch.randint(0, 1 << 30, (1,), generator=gen)))

    def normal(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=cuda_gen).to(dtype)

    x1, c1, valid = normal(1, 1, DSUB), normal(1, L, DSUB), \
        torch.ones(L, device=dev)
    v1, v4 = normal(1, 1), normal(1, 4)
    zero, one = torch.zeros(1, device=dev), torch.ones(1, device=dev)
    floor = {
        "kmeans_assign": (device_ms(lambda: kmeans_assign_kernel(x1, c1)),
                          device_ms(lambda: kmeans_assign_kernel(x1, c1,
                                                                 valid))),
        "scalar_quantize": (device_ms(lambda: scalar_quantize_kernel(
                                v4, zero, one, DL_BITS)),
                            device_ms(lambda: scalar_quantize_kernel(
                                v1, zero, one, DL_BITS)))}
    say("times", f"floors (one-element calls, device, CUDA graph): "
        f"kmeans_assign 1 row {floor['kmeans_assign'][0] * 1e3:.2f} us on "
        f"d8, {floor['kmeans_assign'][1] * 1e3:.2f} us on generic; "
        f"scalar_quantize {floor['scalar_quantize'][0] * 1e3:.2f} us on vec "
        f"(4 values), {floor['scalar_quantize'][1] * 1e3:.2f} us on scalar "
        f"(1 value)")

    def report(name, shape, kern, before, plain, nb, flops, launches,
               big):
        calls = dict(calls=20, reps=10) if big else {}
        k_ms = device_ms(kern, **calls)
        bf_ms = device_ms(before, **calls)
        p_ms = eager_ms(plain, calls=10) if big else device_ms(plain)
        b_ms, b_by = bound(nb, flops)
        share = "L2-resident, not held to the HBM bound" \
            if nb < L2_BYTES else f"{b_ms / k_ms:.1%} of it reached"
        say("times", f"{name} {shape}: kernel {k_ms * 1e3:.2f} us (device, "
            f"CUDA graph; floor {floor[name][0] * 1e3:.2f} us), as called "
            f"before the redesign {bf_ms * 1e3:.2f} us; plain "
            f"{p_ms * 1e3:.2f} us; "
            f"bound {b_ms * 1e3:.2f} us by {b_by} ({nb / 1e6:.1f} MB, "
            f"{flops / 1e6:.1f} MOP), {share}; launches: {launches}")
        return k_ms, p_ms, b_ms, b_by

    entries = []
    # kmeans_assign: the FEMNIST grouping (f32), the serve cut (bf16, f32)
    for shape, (p, n, l, dtype) in (
            ("FEMNIST grouping", (CLIENTS * R, M, L, torch.float32)),
            ("serve cut", (SERVE_B, SERVE_PQ_ROWS, SERVE_PQ_L,
                           torch.bfloat16)),
            ("serve cut", (SERVE_B, SERVE_PQ_ROWS, SERVE_PQ_L,
                           torch.float32))):
        x, c = normal(p, n, DSUB, dtype=dtype), normal(p, l, DSUB)
        xf = torch.empty(x.shape, device=dev)
        ones = torch.ones(l, device=dev)

        def before(x=x, xf=xf, c=c, ones=ones):
            if x.dtype != torch.float32:
                xf.copy_(x)             # the f32 copy the callers made
                return kmeans_assign_kernel(xf, c, ones)
            return kmeans_assign_kernel(x, c, ones)
        kc = assign_counts if shape == "serve cut" else counts
        line = report(
            "kmeans_assign", f"{shape} {tuple(x.shape)} {str(dtype)[6:]} "
            f"L={l} (route {assign_route(x, l, None)})",
            lambda x=x, c=c: kmeans_assign_kernel(x, c),
            before, lambda x=x, c=c: ref.kmeans_assign_ref(x, c),
            *assign_work(x, l),
            f"{kc.get('kmeans_assign', 0)} per batched_kmeans call",
            shape == "serve cut")
        if not entries:
            entries.append(line)
        del x, xf
    # scalar_quantize at b = 8: the chain's carrier and the standalone
    # downlink (f32), a Llama-3 8B cut's gradient (bf16, f32)
    for shape, (p, n, dtype, launches) in (
            ("chain carrier, one client", (
                1, DL_KEPT, torch.float32,
                f"{counts.get('scalar_quantize', 0)} in the trainer's "
                f"weighted run (1 per contribution and 1 in the wire "
                f"measurement, each on one client's carrier)")),
            ("chain carrier, stacked cohort", (
                CLIENTS, DL_KEPT, torch.float32, "1 per slice-2 step")),
            ("standalone downlink", (CLIENTS, DL_TOTAL, torch.float32,
                                     "1 per payload")),
            ("Llama-3 8B cut gradient", (SERVE_B, 4096 * SERVE_P,
                                         torch.bfloat16,
                                         "none on a path yet")),
            ("Llama-3 8B cut gradient", (SERVE_B, 4096 * SERVE_P,
                                         torch.float32,
                                         "none on a path yet"))):
        x = normal(p, n, dtype=dtype) * 1e-3
        lo, scale = scalar_range(x, DL_BITS)
        xf = x if dtype == torch.float32 else torch.empty(x.shape,
                                                          device=dev)

        def before(x=x, xf=xf, lo=lo, scale=scale):
            if x.dtype != torch.float32:
                xf.copy_(x)             # the f32 copy the callers made
            return scalar_quantize_kernel(xf, lo, scale, DL_BITS, "scalar")
        line = report(
            "scalar_quantize", f"{shape} {tuple(x.shape)} "
            f"{str(dtype)[6:]} b={DL_BITS} (route {scalar_route(x)})",
            lambda x=x, lo=lo, scale=scale: scalar_quantize_kernel(
                x, lo, scale, DL_BITS),
            before, lambda x=x, lo=lo, scale=scale: ref.scalar_quantize_ref(
                x, lo, scale, DL_BITS), *scalar_work(x), launches,
            n > 1e6)
        if len(entries) == 1:
            entries.append(line)
        if n > 1e6:     # the card's write rate, for the write-heavy gap
            codes = torch.empty((p, n), device=dev, dtype=torch.int32)
            recon = torch.empty((p, n), device=dev)
            f_ms = device_ms(lambda: (codes.fill_(0), recon.fill_(0)),
                             calls=20, reps=10)
            say("times", f"scalar_quantize {shape} {str(dtype)[6:]}: writing "
                f"its two outputs alone (fill_) takes {f_ms * 1e3:.2f} us, "
                f"{8 * p * n / f_ms / 1e9:.2f} TB/s")
            del codes, recon
        del x, xf
    return [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
             "launches": counts.get(name, 0), "max_abs_err": errs[name],
             "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None}
            for (name, src, replaces), (k_ms, p_ms, b_ms, b_by) in zip(
                (("kmeans_assign", "kmeans_assign.cu",
                  "src/repro/kernels/kmeans_assign.py:58"),
                 ("scalar_quantize", "scalar_quant.cu",
                  "src/repro/kernels/scalar_quant.py:49")), entries)]


def time_large_l(gen, counts, errs):
    """The three clustering kernels at the SO runs' large L (f32, as the
    trainer's cut): lloyd_update's tiled route with pq_quantize's and
    kmeans_assign's generic ones at the two tiled shapes, lloyd_update's
    generic route at the largest of its SO shapes (NWP q = 48, L = 60);
    each kernel's device time beside its plain version's and its bound,
    and its launches on the route over the SO runs (``counts``, keyed
    "<kernel>/<route>"; kmeans_assign: kmeans() at the NWP grouping).
    Returns their four entries of the kernels line, each at the SO NWP
    shape it was last timed at."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_assign import kmeans_assign_kernel
    from repro_torch.kernels.lloyd_update import lloyd_update_kernel
    from repro_torch.kernels.pq_quantize import pq_quantize_kernel

    dev = torch.device("cuda")
    entries = {}
    tiled, generic = so_shapes(True), so_shapes(False)
    for tag, (p, n, d, l), names in (
            ("SO Tag (125, 100)", tiled["SO Tag (125, 100)"],
             ("lloyd_update/tiled", "pq_quantize/generic",
              "kmeans_assign/generic")),
            ("SO NWP (3, 960)", tiled["SO NWP (3, 960)"],
             ("lloyd_update/tiled", "pq_quantize/generic",
              "kmeans_assign/generic")),
            ("SO NWP (48, 60)", generic["SO NWP (48, 60)"],
             ("lloyd_update/generic",))):
        x = torch.randn((p, n, d), generator=gen).to(dev)
        c = torch.randn((p, l, d), generator=gen).to(dev)
        for name, src, replaces, kern, plain, work in (
                ("lloyd_update", "lloyd_update.cu",
                 "src/repro/kernels/lloyd_update.py:87",
                 lambda: lloyd_update_kernel(x, None, c),
                 lambda: ref.lloyd_update_ref(x, None, c),
                 lloyd_work(x, l)),
                ("pq_quantize", "pq_quantize.cu",
                 "src/repro/kernels/pq_quantize.py:55",
                 lambda: pq_quantize_kernel(x, c),
                 lambda: ref.pq_quantize_ref(x, c), pq_work(x, l)),
                ("kmeans_assign", "kmeans_assign.cu",
                 "src/repro/kernels/kmeans_assign.py:58",
                 lambda: kmeans_assign_kernel(x, c),
                 lambda: ref.kmeans_assign_ref(x, c), assign_work(x, l))):
            key = next((k for k in names if k.startswith(name + "/")), None)
            if key is None:
                continue
            k_ms = device_ms(kern, calls=20, reps=10)
            p_ms = device_ms(plain, calls=5, reps=4)
            b_ms, b_by = bound(*work)
            say("times", f"{key} {tag} x {tuple(x.shape)} L={l}: kernel "
                f"{k_ms * 1e3:.2f} us (device, CUDA graph); plain "
                f"{p_ms * 1e3:.2f} us; bound {b_ms * 1e3:.2f} us by {b_by} "
                f"({work[0] / 1e6:.2f} MB, {work[1] / 1e6:.1f} MOP), "
                f"{b_ms / k_ms:.1%} of it reached; launches on the SO "
                f"path: {counts.get(key, 0)}")
            entries[key] = {"name": key, "route": "cuda",
                            "source": f"src/repro_torch/csrc/{src}",
                            "replaces": replaces,
                            "launches": counts.get(key, 0),
                            "max_abs_err": errs[key], "ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": None}
        del x, c
    return list(entries.values())


# ---------------------------------------------------------------------------
# the clustering kernels at any D, the examples' twins, Adafactor
# ---------------------------------------------------------------------------

def anyd_shapes():
    """(tag, (P, N, D, L)) of the clustering kernels above one chunk of dims
    (``kernels.lloyd_update.D_TILE`` = 64), where they refused D before:
    the FEMNIST example at --q 96 (a problem per client of 20 x 96 rows of
    96), lloyd_update's tiled route at D = 96, D = 65 and 128 with small L,
    and one codebook over 20 rows of the whole FEMNIST cut."""
    return {f"D=96 (--q {ANYD_Q})": (CLIENTS, CLIENT_BATCH * ANYD_Q,
                                     CUT_D // ANYD_Q, 2),
            f"D=96 L={gmax() + 1}": (2, 1500, 96, gmax() + 1),
            "D=65": (2, 3001, 65, 3),
            "D=128": (3, 1001, 128, 20),
            f"D={CUT_D}": (1, FIG3_ROWS, CUT_D, 2)}


def phase_anyd(gen):
    """The three clustering kernels at ``anyd_shapes``, f32 and bf16, held
    as phase_tiled_parity holds them (lloyd_update bitwise the plain
    version in its route's order and within γ·Σ|terms| of f64, a bf16 x
    bitwise its f32 upcast; codes equal but for near-ties, z̃ and the
    residual bitwise where they agree); then kmeans() as Fig. 3's vanilla
    k-means runs it (benchmarks/bench_quantizer_tradeoff.py:66): 20 rows
    of the 9216-wide cut at each L of its grid, through the kernels and
    through the plain versions on the card. Returns (max errors under
    "<kernel>/anyd", kmeans_assign's launches in those kmeans() runs)."""
    from repro_torch.core.kmeans import kmeans
    from repro_torch.kernels import _build
    from repro_torch.kernels.kmeans_assign import assign_route
    from repro_torch.kernels.lloyd_update import row_route
    from repro_torch.kernels.pq_quantize import pq_route

    dev = torch.device("cuda")
    errs = dict.fromkeys(("lloyd_update/anyd", "pq_quantize/anyd",
                          "kmeans_assign/anyd"), 0.0)
    for tag, (p, n, d, l) in anyd_shapes().items():
        x = torch.randn((p, n, d), generator=gen).to(dev)
        c = torch.randn((p, l, d), generator=gen).to(dev)
        want = ("tiled" if l > gmax() else "generic", "generic", "generic")
        routes = (row_route(x, l), pq_route(x, l), assign_route(x, l, None))
        if routes != want:
            fail(f"any-D parity {tag}: routes {routes}, want {want}")
        ones = torch.ones((p, n), device=dev)
        for xt in (x, x.to(torch.bfloat16)):
            dt = str(xt.dtype)[6:]
            for name, e in (
                    ("lloyd_update/anyd", check_lloyd(
                        f"{tag} {dt}", xt, c, None, ones, None)[0]),
                    ("pq_quantize/anyd", check_pq(f"{tag} {dt}", xt, c)[0]),
                    ("kmeans_assign/anyd",
                     check_kmeans_assign(f"{tag} {dt}", xt, c,
                                         by_depth=True))):
                errs[name] = max(errs[name], e)
    x = torch.randn((FIG3_ROWS, CUT_D), generator=gen).to(dev)
    launches = 0
    for l in FIG3_L:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = kmeans(x, l, FIG3_ITERS, backend="auto")
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        plain = kmeans(x, l, FIG3_ITERS, backend="torch")
        torch.cuda.synchronize()
        want = {"lloyd_update": FIG3_ITERS, "kmeans_assign": 1}
        if counts != want:
            fail(f"Fig. 3 kmeans L={l}: launches {counts} != {want}")
        gap = float((got.centroids - plain.centroids).abs().max())
        if not (torch.equal(got.codes, plain.codes)
                and gap <= 1e-4 * (1 + float(plain.centroids.abs().max()))):
            fail(f"Fig. 3 kmeans L={l}: codes equal "
                 f"{torch.equal(got.codes, plain.codes)}, centroids off by "
                 f"{gap}")
        launches += counts["kmeans_assign"]
        say("parity", f"Fig. 3 vanilla k-means ({FIG3_ROWS}, {CUT_D}) L={l} "
            f"{FIG3_ITERS} iterations: launches {counts}; codes equal to "
            f"the plain versions', centroids within {gap:.3e}, distortion "
            f"{float(got.distortion):.4f} vs {float(plain.distortion):.4f}")
    return errs, launches


def time_anyd(gen, counts, errs):
    """The lifted routes L2-warm, each beside its plain version and its
    bound: the three kernels at the FEMNIST example's --q 96 shape, at
    D = 128 and at Fig. 3's (20, 9216), L = 64. Returns the kernels line's
    "<kernel>/anyd" entries: lloyd_update and pq_quantize at --q 96 with
    their launches in the example's --q 96 run, kmeans_assign at Fig. 3's
    shape with its launches in the kmeans() runs (``counts``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kmeans_assign import kmeans_assign_kernel
    from repro_torch.kernels.lloyd_update import (lloyd_update_kernel,
                                                  row_route)
    from repro_torch.kernels.pq_quantize import pq_quantize_kernel

    dev = torch.device("cuda")
    q96 = anyd_shapes()[f"D=96 (--q {ANYD_Q})"]
    entries = {}
    for tag, (p, n, d, l), entry in (
            (f"--q {ANYD_Q}", q96, ("lloyd_update", "pq_quantize")),
            ("D=128", anyd_shapes()["D=128"], ()),
            (f"Fig. 3 D={CUT_D}", (1, FIG3_ROWS, CUT_D, FIG3_L[-1]),
             ("kmeans_assign",))):
        x = torch.randn((p, n, d), generator=gen).to(dev)
        c = torch.randn((p, l, d), generator=gen).to(dev)
        for name, src, replaces, kern, plain, work in (
                ("lloyd_update", "lloyd_update.cu",
                 "src/repro/kernels/lloyd_update.py:87",
                 lambda: lloyd_update_kernel(x, None, c),
                 lambda: ref.lloyd_update_ref(x, None, c),
                 lloyd_work(x, l)),
                ("pq_quantize", "pq_quantize.cu",
                 "src/repro/kernels/pq_quantize.py:55",
                 lambda: pq_quantize_kernel(x, c),
                 lambda: ref.pq_quantize_ref(x, c), pq_work(x, l)),
                ("kmeans_assign", "kmeans_assign.cu",
                 "src/repro/kernels/kmeans_assign.py:58",
                 lambda: kmeans_assign_kernel(x, c),
                 lambda: ref.kmeans_assign_ref(x, c), assign_work(x, l))):
            key = f"{name}/anyd"
            k_ms = device_ms(kern, calls=20, reps=10)
            p_ms = device_ms(plain, calls=5, reps=4)
            b_ms, b_by = bound(*work)
            say("times", f"{name} at any D, {tag}: x {tuple(x.shape)} L={l} "
                f"(lloyd_update route {row_route(x, l)}): kernel "
                f"{k_ms * 1e3:.2f} us (device, CUDA graph, L2-warm); plain "
                f"{p_ms * 1e3:.2f} us; bound {b_ms * 1e3:.2f} us by {b_by} "
                f"({work[0] / 1e6:.2f} MB, {work[1] / 1e6:.1f} MOP), "
                f"{b_ms / k_ms:.1%} of it reached")
            if name in entry:
                entries[key] = {"name": key, "route": "cuda",
                                "source": f"src/repro_torch/csrc/{src}",
                                "replaces": replaces,
                                "launches": counts.get(key, 0),
                                "max_abs_err": errs[key], "ms": k_ms,
                                "plain_ms": p_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "library_ms": None}
        del x, c
    return [entries[f"{k}/anyd"] for k in ("lloyd_update", "pq_quantize",
                                            "kmeans_assign")]


def time_mesh(gen, counts, errs, dev="cuda"):
    """lloyd_update and pq_quantize at a shard's shape (MESH_SHARD, M,
    DSUB): one rank's fused clients at two ranks, L2-warm, beside their
    plain versions and bounds: the kernels line's "<kernel>/mesh" entries,
    with the launches of the mesh's FullSync run at a world of one."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lloyd_update import lloyd_update_kernel
    from repro_torch.kernels.pq_quantize import pq_quantize_kernel

    x = torch.randn((MESH_SHARD, M, DSUB), generator=gen).to(dev)
    c = torch.randn((MESH_SHARD, L, DSUB), generator=gen).to(dev)
    entries = []
    for name, src, replaces, kern, plain, work in (
            ("lloyd_update", "lloyd_update.cu",
             "src/repro/kernels/lloyd_update.py:87",
             lambda: lloyd_update_kernel(x, None, c),
             lambda: ref.lloyd_update_ref(x, None, c), lloyd_work(x, L)),
            ("pq_quantize", "pq_quantize.cu",
             "src/repro/kernels/pq_quantize.py:55",
             lambda: pq_quantize_kernel(x, c),
             lambda: ref.pq_quantize_ref(x, c), pq_work(x, L))):
        key = f"{name}/mesh"
        k_ms = device_ms(kern)
        p_ms = device_ms(plain)
        b_ms, b_by = bound(*work)
        say("times", f"{name} at a mesh shard's shape x "
            f"{tuple(x.shape)} L={L}: kernel {k_ms * 1e3:.2f} us (device, "
            f"CUDA graph, L2-warm); plain {p_ms * 1e3:.2f} us; bound "
            f"{b_ms * 1e3:.2f} us by {b_by}; {counts.get(key, 0)} launches "
            f"in the mesh's run")
        entries.append({"name": key, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{src}",
                        "replaces": replaces,
                        "launches": counts.get(key, 0),
                        "max_abs_err": errs[key], "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
    return entries


def run_example(module, argv):
    """``module.main(argv)`` on the card: its lines printed under
    [examples] and returned, with the launch counts read around it."""
    from repro_torch.kernels import _build

    name = module.__name__.rsplit(".", 1)[-1]
    out = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _build.launch_counts()
    lines = out.getvalue().splitlines()
    for line in lines:
        say("examples", f"  {line}")
    say("examples", f"{name} {' '.join(argv)}: exit {rc} in {seconds:.1f} s; "
        f"launches {counts}")
    if rc != 0:
        fail(f"{name} {argv}: exit {rc}")
    return lines, counts


@contextlib.contextmanager
def trainers_built(module):
    """The FederatedTrainers ``module`` builds while open, in order."""
    built, orig = [], module.FederatedTrainer

    def build(*args, **kw):
        built.append(orig(*args, **kw))
        return built[-1]
    module.FederatedTrainer = build
    try:
        yield built
    finally:
        module.FederatedTrainer = orig


def want_counts(tag, counts, want):
    if counts != want:
        fail(f"{tag}: launches {counts} != {want}")


def phase_examples(seed, dev="cuda"):
    """The four examples' twins (``repro_torch.examples``) through their
    ``main`` on the card, each run's launch counts read around it:
    quickstart in full; the FEMNIST example's ideal loop, 10 rounds at full
    width (d8 routes); at --q 96 (D = 96: lloyd_update's and pq_quantize's
    lifted generic routes), its round 1 first held to the same round on
    CPU copies; with the mobile fleet and the 6 s deadline; the LLM twins
    at their reduced defaults (serve: flash attention in prefill). Returns
    the --q 96 run's launches under "<kernel>/anyd"."""
    from repro_torch.examples import (femnist_federated_training, quickstart,
                                      serve_split, split_llm_finetune)
    from repro_torch.federated import FullSync
    from repro_torch.launch.specs import default_pq
    from repro_torch.configs.base import get_arch

    on = ["--device", dev]
    lines, counts = run_example(quickstart, on)
    want_counts("quickstart", counts, {"lloyd_update": 3 * QS_ITERS,
                                       "pq_quantize": 3})
    if not any(line.endswith("True") for line in lines):
        fail("quickstart: the eq.-5 cotangent check failed")

    fx = femnist_federated_training
    with route_spy() as seen:
        lines, counts = run_example(fx, ["--rounds", "10", *on])
    want_counts("femnist ideal", counts, {"lloyd_update": 10 * ITERS,
                                          "pq_quantize": 10})
    if set(r for _, r in seen) != {"d8"}:
        fail(f"femnist ideal: routes {set(seen)}")
    losses = [float(v) for v in re.findall(r"loss=(\S+)", "\n".join(lines))]
    if len(losses) != 2 or not all(np.isfinite(losses)):
        fail(f"femnist ideal: losses {losses}")

    argv = ["--q", str(ANYD_Q), "--clusters", "2", "--rounds", "3"]
    card = fx.build(fx.parse_args([*argv, *on]))
    cpu = fx.build(fx.parse_args([*argv, "--device", "cpu"]))
    # the CPU copy on the plain versions, as "auto" resolves there
    cpu[0].pq = dataclasses.replace(cpu[0].pq, backend="torch")
    weights = {k: v.detach().cpu().clone()
               for k, v in cpu[0].state_dict().items()}
    hold_to_cpu(f"femnist --q {ANYD_Q} round 1", weights,
                card[3](CLIENTS, FullSync(), None),
                cpu[3](CLIENTS, FullSync(), None), seed)
    with route_spy() as seen:
        _, counts = run_example(fx, [*argv, *on])
    want_counts(f"femnist --q {ANYD_Q}", counts,
                {"lloyd_update": 3 * ITERS, "pq_quantize": 3})
    if set(r for _, r in seen) != {"generic"}:
        fail(f"femnist --q {ANYD_Q}: routes {set(seen)}")
    anyd = {f"{k}/anyd": v for k, v in counts.items()}

    with trainers_built(fx) as built:
        _, counts = run_example(fx, ["--fleet", "mobile", "--policy",
                                     "deadline", "--rounds", "5", *on])
    trace = built[0].last_trace
    want_counts("femnist mobile deadline", counts,
                counts_want(trace, 1, ITERS, WARM_ITERS, False))

    cfg = get_arch("llama3_8b", smoke=True)
    lines, counts = run_example(split_llm_finetune,
                                ["--steps", str(LLM_STEPS), *on])
    it = default_pq(cfg).kmeans_iters
    want_counts("split_llm_finetune", counts,
                {"lloyd_update": LLM_STEPS * it, "pq_quantize": LLM_STEPS})
    lines, counts = run_example(serve_split, on)
    it = default_pq(get_arch("starcoder2_3b", smoke=True)).kmeans_iters
    if counts.get("flash_attention", 0) < 1 or \
            (counts.get("lloyd_update"), counts.get("pq_quantize")) \
            != (it, 1):
        fail(f"serve_split: launches {counts}")
    if not any(torch.cuda.get_device_name(0) in line for line in lines):
        fail("serve_split: the decode line names no device")
    return anyd


def phase_adafactor(seed, dev="cuda"):
    """One FEMNIST FedLite step (q = 1152, L = 2, 10 clients of 20) under
    Adafactor on the card, against the same step on the CPU (the plain
    versions) from the same weights and batch: the update within
    UPDATE_RTOL (relative L2) on the client's and the server's params (the
    conv weights' factors over I and O, as the reference's)."""
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.kernels import _build
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import adafactor

    out = {}
    for where in (dev, "cpu"):
        model = FemnistCNN(pq=PQConfig(Q, L, kmeans_iters=ITERS), lam=LAM,
                           client_batch=CLIENT_BATCH, device=where,
                           generator=torch.Generator().manual_seed(seed))
        data = make_federated_image_data(num_clients=64, seed=0,
                                         device=where)
        parts = [data.sample_batch(c, np.random.default_rng([seed, c]),
                                   CLIENT_BATCH) for c in range(CLIENTS)]
        batch = {k: torch.cat([b[k] for b in parts]) for k in parts[0]}
        opt = adafactor(1e-2)
        state = TrainState.create(dict(model.named_parameters()), opt)
        if where == dev:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
        new, met = make_train_step(model, opt)(state, batch)
        if where == dev:
            torch.cuda.synchronize()
            want_counts("adafactor step", _build.launch_counts(),
                        {"lloyd_update": ITERS, "pq_quantize": 1})
        out[where] = (state, new, float(met["loss"]))
    before = {k: v.detach().float() for k, v in out["cpu"][0].params.items()}
    gaps, worst = update_gaps(before, out[dev][1].params, out["cpu"][1].params)
    row = out[dev][1].opt_state["v"]["client.conv2_w"]["row"]
    say("adafactor", f"FEMNIST step under Adafactor: loss {out[dev][2]:.6f} "
        f"vs the CPU's {out['cpu'][2]:.6f}; update gap in L2: client "
        f"{gaps['client']:.3e}, server {gaps['server']:.3e}; max |Δparam| "
        f"{worst:.3e}; conv2's row factor {tuple(row.shape)} (kH, kW, I)")
    if not max(gaps.values()) <= UPDATE_RTOL \
            or abs(out[dev][2] - out["cpu"][2]) > LOSS_ATOL:
        fail(f"adafactor step: update gaps {gaps}, losses "
             f"{out[dev][2]} / {out['cpu'][2]}")
    if tuple(row.shape) != (3, 3, 32):
        fail(f"adafactor: conv2's row factor {tuple(row.shape)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if args.steps < 3:
        ap.error("--steps must be at least 3")

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))

    t_start = time.perf_counter()

    def mark(phase):
        say("times", f"{phase}: done {time.perf_counter() - t_start:.1f} s "
            f"into the run")

    name = phase_device()
    phase_build()
    gen = torch.Generator().manual_seed(args.seed)
    errs = phase_parity(gen)
    anyd_errs, fig3_launches = phase_anyd(gen)
    errs.update(anyd_errs)
    _, run3 = phase_slice(args.seed, args.steps)
    phase_profile("slice", run3)
    counts, assign_counts, assign_err = phase_kmeans(gen)
    errs["kmeans_assign"] = max(errs["kmeans_assign"], assign_err)
    slice2, run3, model, batch = phase_slice2(args.seed, args.steps)
    phase_profile("slice 2", run3)
    # each kernel's launches on the path this slice runs it on: the
    # slice-2 step, the kmeans entry point, the payload packing
    counts.update(slice2)
    payload, codes, words = phase_payload(model, batch)
    counts.update(pack_codes=payload["pack_codes"],
                  unpack_codes=payload["unpack_codes"])
    del model, batch
    mark("build, parity and slices")
    # the trainer: lloyd_update's and pq_quantize's launches on the main
    # path (FullSync), scalar_quantize's on the weighted path
    main_counts, weighted_counts, rounds = phase_trainer(args.seed,
                                                        args.steps)
    phase_profile("trainer", rounds, unit="round", opens=True)
    counts.update(main_counts)
    counts["scalar_quantize"] = weighted_counts["scalar_quantize"]
    torch.cuda.empty_cache()
    # the cohort-parallel executor: its FullSync launches at a world of one
    # are the "<kernel>/mesh" entries
    mesh_counts, mesh_errs = phase_mesh(args.seed, args.steps)
    errs.update(mesh_errs)
    torch.cuda.empty_cache()
    mark("trainer and mesh")
    # the text tasks: the clustering kernels' launches on the SO runs, by
    # route
    so_counts, lm_data = phase_so_tasks(args.seed)
    torch.cuda.empty_cache()
    # runs that survive a crash, report their health and autoscale: each
    # phase reads its own launch counts
    phase_determinism(args.seed)
    phase_recovery(args.seed, lm_data)
    del lm_data
    phase_health(args.seed)
    phase_autoscale(args.seed)
    torch.cuda.empty_cache()
    mark("so, determinism, recovery, health and autoscale")
    # the four examples' twins as their users run them, and Adafactor
    anyd_counts = phase_examples(args.seed)
    anyd_counts["kmeans_assign/anyd"] = fig3_launches
    phase_adafactor(args.seed)
    torch.cuda.empty_cache()
    mark("examples and adafactor")
    # the sharded phase's dry runs trace on the host's CPU from here on,
    # while the serve and LM phases keep the card busy
    tmp_dry = tempfile.mkdtemp()
    dry = dryrun_start(tmp_dry)
    try:
        # the serve prefill: flash_attention's launches, and the PQ kernels
        # at their largest shape (4 problems of 1048576 x 8, L = 16), held
        # on the serve cut
        serve, layer_err, pq_errs = phase_serve(args.seed)
        counts["flash_attention"] = serve["flash_attention"]
        errs["flash_attention"] = max(errs["flash_attention"], layer_err)
        for kernel, e in pq_errs.items():
            errs[kernel] = max(errs[kernel], e)
        torch.cuda.empty_cache()
        mark("serve")
        # LM training through launch/train.py: the main path of this slice
        # (lloyd_update's and pq_quantize's launches in the Llama run), the
        # SSM and MoE runs, and the Mamba2 serve
        lm_counts, lm_errs, lm_main = phase_lm_train(args.seed)
        torch.cuda.empty_cache()
        mark("lm")
        # the production meshes: the Llama run and serve under a 1 x 1 NCCL
        # mesh (the cut's kernels and flash on local blocks), the dry runs
        sharded_counts = phase_sharded(args.seed, lm_main, dry, tmp_dry)
        del lm_main
        mark("sharded")
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    kernels = phase_times(gen, counts, errs, codes, words, serve,
                          assign_counts)
    kernels += time_large_l(gen, so_counts, errs)
    kernels += time_lm_pq(gen, lm_counts, lm_errs)
    kernels += time_anyd(gen, anyd_counts, errs)
    kernels += time_mesh(gen, mesh_counts, errs)
    kernels += sharded_entries(kernels, sharded_counts)
    say("times", f"whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
