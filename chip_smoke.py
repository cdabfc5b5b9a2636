#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100.  It
builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (six
kernels; flash_attention's forward and its backward each have a bf16
tensor-core source and an f32 CUDA-core one),
holds each against its plain PyTorch version on the card, drives the port's
main paths -- the RDF engine on a LUBM-style graph (``query`` with
``adaptive=False``, ``query_batch``, and the adaptive engine through both),
directory placement with hot-key rebalancing on a Zipf hub graph and on
LUBM, the online serving front end (``repro_torch.serving``) over the
adaptive engine, master recovery from a checkpoint, the multi-device
substrate (W split over ``torch.distributed`` ranks: NCCL at world size 1,
two gloo ranks on the card), a 16 M-triple Zipf stream, the dense LM's
serving path (prefill and decode of llama3-8b, the decode also in the
int8 and bf16 cache modes) and its training path (qwen1.5-4b train
steps), the moe family (qwen2-moe-a2.7b served at full size, also under
the mesh options on a world-size-1 NCCL mesh, trained at full width), the
partitioning baselines of the startup
claim, the ssm, hybrid and vlm families (mamba2-130m, recurrentgemma-2b
and internvl2-2b served at full size; mamba2-130m and recurrentgemma-2b
trained at full size, internvl2-2b's train step held to the CPU port) and
the audio family (whisper-tiny served and trained at full size) -- checks
the answers, and prints one JSON line per phase.  Any
mismatch or exception exits non-zero; without a card it exits 1 before
doing anything.

Phases:
  0 setup   card name and power limit, kernel build seconds, the tuned
            table the build used (``kernels/tuning.py``: its -D flags and
            the tiles the wrappers size scratch with)
  1 kernels each kernel vs its plain version at main-path shapes: the four
            DSJ kernels (W = 8) bit-exact (valid lanes only for expand;
            unique_compact in int32 and int64); range_search and expand at
            the shapes and mixes phase 2's census gives them (the reply
            probe: int64 keys N = 594,575, M = 2^23, 0.57% live; the
            finalize probe: int32 keys N = 2^23, M = 2^20, 8.6% live;
            span_search at M = 1; expand at n = 2^23, 2^20 and 1 into 2^20
            lanes), then their earlier random rows; bucket_by_dest at the
            shapes and mixes of its two callers (n = 2^20 rows into 8 x 2^20
            slots, a valid prefix of 4.57%: the reply routing, k = 3, with
            senders in order; the hash exchange, k = 1, with hashed
            destinations), then its earlier rows (n = 2^18 overflowing
            cap_peer = 2^15, k = 1 and 3; random destinations, 10% valid);
            the bound counts the bytes the function must move;
            flash_attention (which kernel served each row is printed)
            within 1e-4 (f32) / 2e-2 (bf16) absolute and 1e-4 / 1e-2 of
            each output row's largest magnitude, at the
            shape phase 4's prefill gives it (B=4, T=S=4096), the moe
            prefill's (B=4, T=S=4096, H=KV=16), variants,
            and 32k rows in bf16 and f32, two launches bit-identical; each
            DSJ kernel's main row again
            folded as query_batch folds a bucket of 16 queries (128 rows,
            or 16x the probes a row, phase 2b's census); bucket_by_dest at
            the two shapes directory placement adds: phase 2f's rebalance
            (k = 3, the hash store's 4,713,095-row shards routed by
            triple_dest into cap_peer = 2^21, built on the host before
            phase 1 from the same triples; ``skew-bucket-mix`` prints its
            mix) and the LUBM hash exchange fanned out 8 ways (k = 1,
            n = 8 x 2^20, only replica 0 valid); the flash_attention
            backward at the train phase's shape (B=1, T=S=4096, H=KV=20,
            hd=128, bf16, causal), moe-train's (H=KV=16) and variants
            (llama3-8b's GQA heads,
            f32, T=1024 S=4096 q_offset=3072, hd=64, non-causal, odd
            T=S=1001), each against its plain version, both fed the
            plain forward's o and log-sum-exp, within 1e-4 (f32) / 2e-2
            (bf16) of max(1, the gradient's largest magnitude) and 1e-4 /
            1e-2 of each gradient row's largest (floored at 1% of max(1,
            the gradient's largest)); the forward kernel's o within the
            same limits of the plain forward's and its log-sum-exp within
            1e-5 + 1e-5 of the plain one's; two launches bit-identical;
            then the audio train step's rows (whisper-tiny: cross B=16
            T=448 S=1500 H=KV=6 hd=64, the encoder's T=S=1500, both
            non-causal, the decoder's causal T=S=448) and the hybrid
            train step's (B=1, T=S=4096, H=10, KV=1, hd=256, bf16, causal,
            window 2048), f32 at hd 256 with and without that window,
            window 1, window 4096 >= T (which must give the unwindowed
            launch's bits), T=1024 S=4096 q_offset=3072 and odd T=S=1001
            with a window;
            the kernel pipeline (forward kernel, then the backward on its
            o and log-sum-exp) and the plain one printed against the
            float32 gradient, and SDPA's backward against it too
            (``sdpa_vs_f32``: the yardstick of a bf16 kernel's error,
            printed, not gated); SDPA's backward timed beside the kernel
            (a boolean mask for q_offset > 0); kernel, plain and
            library-call medians over CUDA events, the roofline bound, and
            for bf16 the share of the tensor-core peak (``tc_share``); the
            forward with a window and at hd 256 (``FLASH_WINDOW_SHAPES``):
            the hybrid prefill's shape (B=4, T=S=4096, H=10, KV=1, hd=256,
            bf16, causal, window 2048), then f32 at hd 256, window 1,
            window 4096 >= T (which must give the unwindowed launch's
            bits), T=1024 S=4096 q_offset=3072, odd T=S=1001 and hd 256
            with no window, each within the limits above and bit-identical
            on relaunch; the bound counts the visible pairs; SDPA with the
            window as a boolean mask (KV heads repeated) is the library
            call, and the row names the backend it took; then the same at
            the audio path's shapes (``FLASH_AUDIO_SHAPES``, bf16 and f32:
            the encoder B=16 T=S=1500 H=KV=6 hd=64 non-causal, cross B=16
            T=448 S=1500, decode cross B=8 T=1 S=1500; the decoder's
            causal T=S=448 in bf16), SDPA with no mask where every key is
            visible
  2 lubm    lubm_like(100, 20, 30, 12, 2) (~4.74 M triples) on 8 workers:
            startup, store bytes, peak memory, 60 workload queries (all six
            templates), each kernel's launch count on that run and, by
            shape, each DSJ kernel's (the census), warm qps and
            per-template p50/p99, a warm chain query's host syncs, a
            profiled warm pass per template (device busy time, idle share,
            top kernels, each DSJ kernel's device time), in a pass of its
            own the mix each bucket_by_dest shape gets (valid share, valid
            prefix, destinations in order), and two queries per template
            held against a device="cpu" engine (``lubm-parity``, printed
            after ``scale``: the CPU engine runs in the side process)
  2b lubm-batch  the same 60 queries through ``query_batch`` on that
            engine, cold and warm: answers, comm_cells and mode equal to
            the cold pass; buckets, batched dispatches, warm queries/s,
            launches against the warm sequential pass, peak memory, the
            census of folded shapes, a profiled bucket per template
  2c lubm-adaptive  two adaptive engines (frequency threshold 3), one
            through ``query``, one through ``query_batch``, two passes
            each: every answer equal to phase 2's, the two engines equal in
            comm_cells, modes, vars, report, history and pattern-index
            fingerprint; per pass queries/s, comm_cells, modes, IRD
            seconds, replication ratio, load balance, replica bytes; a
            profiled adapted pass; then an engine whose replication budget
            is half the largest per-worker replica count must evict
  2d adaptive-parity  lubm_like(2, 2, 2, 2), W = 4, 40 queries: the
            adaptive engine on the card against the CPU port through
            ``query`` and ``query_batch`` -- answers, stats, report
            counters, placement and pattern-index fingerprints, heat map,
            main and replica stores bit-exact
  2e skew-parity  the same checks on a directory engine at the reference
            tests' skew shape: zipf_skew(64 subjects, 4000 triples, 64
            objects, 8 predicates, exponent 1.8), W = 4, 40 Zipf queries,
            skew threshold 1.2 (rebalances and moved cells included)
  2f skew   the repo's skew configuration (benchmarks/bench_balance.py
            _skew_engines) at 8,000,000 drawn triples (6,957,341 distinct),
            W = 8: a hash and a directory engine, two ``query`` passes of
            48 Zipf stars (the first rebalances) and one ``query_batch``
            each; answers equal across engines and entry points, 4 checked
            against a numpy scan, the directory store's counts equal to its
            placement's census, max/mean load at most half of hash's, no
            rebalance after the first pass, phase 1's rebalance row equal
            to this run's (splits, shape, moved cells); warm queries/s,
            rebalance seconds and cells, time to online, peak memory, a
            profiled warm pass and a launch census per engine
  2g lubm-directory  phase 2's 60 queries on a directory engine (skew
            detector on, IRD off), cold and warm: answers equal to phase
            2's, no split, comm_cells and modes per template beside phase
            2's, warm queries/s, launch census
  2h serve-parity  the serving front end at W = 8 on lubm_like(2, 2, 2,
            2), modelled service (0.01 s a dispatch): a 24-request stream
            at 150 requests/s equal to ``query_batch`` of its query log on
            a twin engine (answers, mode, comm_cells, PI fingerprint) and
            to the same stream on a CPU engine (report fields, latencies,
            completions in order), two more identical streams, the last
            with no kernel build and no new launch shape, then 120
            requests at 400/s (2x) on a fresh engine: admitted p99 at most
            the 0.2 s SLO, some shed, answers equal to a CPU engine's
  2i serve  the reference bench's serving legs
            (benchmarks/bench_serving.py) on phase 2's LUBM-100 triples,
            W = 8, its Zipf template mix, an adaptive engine at threshold
            2: two warm closed-burst streams of 200 requests, the measured
            saturation stream (charged wall seconds, the card synchronized;
            one more under the profiler), 120 requests at half the
            measured saturation rate (p50, p99), and 150 requests at a
            modelled 2x overload on a fresh engine (shed fraction,
            admitted p99 within the 0.2 s SLO); per leg the flushes,
            modes, redistributions, peak memory, launches per DSJ kernel
            and launch shapes new since the earlier legs; every answer
            held to a non-adaptive engine that did not serve, and after
            the warm streams no kernel build and no new launch shape
  2j recovery  the skew directory engine's state and adaptivity snapshot
            saved (bytes, seconds), ``recover_master`` at W = 8 bit for bit
            (placement, pattern index, heat map, replicas, next id, next
            query's route and answer), a crash before publishing a second
            snapshot leaves the first restorable, and recovery seconds
            beside a cold bootstrap plus a replay of the whole log
  2k mesh   the multi-device substrate on the card: a world-size-1 NCCL
            group, a DistributedSubstrate, phase 2's LUBM-100 triples
            ingested host-sharded at W = 8; the 60 queries cold and warm and
            through ``query_batch`` cold and warm, answers, comm_cells and
            mode equal to phase 2's; per template the collectives its stage
            bodies issued (two all_to_all at each hash exchange and reply
            route, two all_gather at each broadcast, none on the
            local-main route); NCCL milliseconds per collective kind over a
            warm pass (CUDA events); launches per DSJ kernel; warm
            queries/s beside phase 2's; a warm chain query's one host sync
            (its one collective the all_reduce there); no build and no new
            launch shape after warm-up; peak memory; an adaptive twin at
            threshold 3, two passes, equal to lubm-adaptive's query engine
            (stats, report, history, fingerprint)
  2l mesh2  two processes x 4 workers (W = 8) through
            ``launch_localhost``, the two ranks on the one card over gloo
            (NCCL takes one rank a GPU), lubm_like(2, 2, 2, 2): each rank
            held to a single-substrate engine -- ingested store, adaptive
            lifecycle and fingerprint, a ``query_batch`` pass, a checkpoint
            round trip with replicas over both ranks, a placement snapshot
            restored at W' = 16; the line states device and backend
  3 scale   generate_stream(16_000_000, 2^20) streamed in: time to online,
            time to first answer, live/padded store bytes, 32 zipf queries,
            4 of them checked against a numpy scan of the same stream
  4 lm      llama3-8b at full width and depth, bf16 weights from seed 0:
            prefill (``model.loss`` on B=4, T=4096) cold and 3x warm, with
            32 flash_attention launches per call; a 2-layer full-width
            prefill (B=1, T=520) held against the CPU port; decode
            (``serve_loop``: batch 8, max_len 128, 16 steps, 4 batches)
            with the adaptive controller; prefill runs under
            ``torch.inference_mode()``
    lm-int8  phase 4's weights decoding (``serve_loop``: batch 8, max_len
            4096, 16 steps, 4 batches) in the reference's three cache
            modes (``CACHE_MODES``: float32 cache math, bf16 cache math,
            the int8 cache with bf16 math as ``--int8-kv`` sets them):
            tokens/s, cache bytes (int8 at most 0.52 of bf16), peak
            memory, a profiled batch's idle share; then the reference
            test's property at full size (5 steps of int8 against the
            default: logits within 5% of the largest, greedy tokens
            agreeing on half the rows)
    lm-int8-parity  2 layers at full width in float32, 8 int8-cache
            decode steps on the card against the CPU port: logits 1e-4 of
            the largest, payloads within one step (the entries differing
            counted), scales 1e-6 relative; bf16 cache math's card route
            (``torch.bmm(out_dtype=float32)``) against the CPU's at
            decode's full shape, 1e-2 of the largest
  5 train   qwen1.5-4b at full width and depth (float32 parameters, bf16
            compute, remat): ``make_train_step`` on ``make_batch(cfg, 1,
            4096, step)``, one warm-up and three timed steps, each with
            finite loss and grad_norm and 80 forward / 40 backward flash
            launches; step seconds, tokens/s, peak memory, one profiled
            step; then 2 layers at full width in float32 (B=1, T=256) on
            the card against a CPU port, two steps, the parts of a step
            apart: loss (1e-5 relative) and every gradient leaf (1e-4
            relative L2) of each device at the same weights, grad_norm
            (1e-5 relative); then ``adamw_update`` on the card and on the
            CPU from the card's gradients, on every element: parameters
            within 1e-5 absolute, v 1e-5 relative, m 1e-5 of sqrt(v) +
            eps (the units of the step it drives); ``compress_tree`` of the same
            gradients equal on both, and a checkpoint round trip bit for
            bit (the 2 layers at CKPT_VOCAB rows, after two card steps)
  6 moe     qwen2-moe-a2.7b at full width and depth (24 layers, 60 routed
            top-4 experts + 4 shared, 14.32 B parameters), bf16 weights
            from seed 0: prefill as phase 4 (B=4, T=4096, cold and 3x warm,
            24 flash_attention launches a call), a profiled prefill and
            4-step decode batch, decode (``serve_loop``: batch 8, 16 steps,
            4 batches); layer 0's ``moe_ffn`` on the prefill's hidden states:
            dropped and max/mean slot load with no plan and with the 8
            hottest experts replicated (``slot_map_for_plan``), its ms,
            and two calls bit-identical
    lm-mesh  the same weights on ``make_local_mesh()`` (a world-size-1
            NCCL group), params placed by ``param_specs``: the prefill on
            Zipf tokens under the config's options (the controller's hot
            rows, the cold capacity from its coverage, the sharded moe
            with that 8-replica plan) beside the same prefill without
            them: tokens/s, loss difference, overflow 0, 24 flash
            launches a call, collectives a prefill, peak memory
    moe-parity  2 layers at full width in float32 (B=1, T=256), the card
            against the CPU port: hidden states and layer 0's ``moe_ffn``
            within 1e-4, its diagnostics bit-exact, the loss 1e-5
            relative (a token the two devices route differently must be a
            near-tie and is left out with the tokens it reached), then
            ``lm-mesh-parity`` (the card's forward under all options on a
            world-size-1 NCCL mesh against the CPU port's plain forward
            with the same plan, 1e-4) and one train step with phase 5's
            limits
    moe-train  full width, 4 layers (all 24 need 229 GB of float32
            state), B=1, T=4096: one warm-up and two timed steps, 8
            forward / 4 backward flash launches a step, finite loss and
            grad_norm, tokens/s, peak memory, one profiled step
  6c train-mesh  moe-train's model through the train CLI's path on a
            world-size-1 NCCL mesh (``make_local_mesh``, ``place``,
            ``make_train_step(..., mesh)``): the first step's loss and
            updated parameters bit-identical to the unmeshed step's from
            the same weights and batch, a warm-up and two timed steps
            (tokens/s beside moe-train's, 8 / 4 flash launches a step,
            peak memory), then a checkpoint saved and restored through the
            mesh into fresh state, bit for bit (the config at 0 layers and
            CKPT_VOCAB rows -- its embedding, LM head and final norm --
            after one mesh step: the four layers' 34.85 GB take ~150 s)
    train-mesh2  two gloo ranks on the card, mesh (1, 2), one launch, in
            float32: qwen2-moe-a2.7b at 2 layers, full width, B=2, T=512
            (attention, FFN and expert leaves cut over ``model``);
            recurrentgemma-2b at one group (3 layers) at full width, B=2,
            T=2,304 (the RG-LRU cut per channel, 5 query heads a rank over
            the whole KV head, the window cutting in); whisper-tiny at
            full size, B=2, 1,500 frames + 448 tokens (3 heads a rank,
            the GeLU MLPs cut); every LM head vocab-parallel.  Each leg's
            loss and every gradient (gathered whole) against the card's
            world-size-1 step: 1e-5 relative, 1e-5 of each leaf's largest
            (``bk``, zero in exact arithmetic, of the largest gradient's);
            the hybrid's and audio's 4 teacher-forced decode steps against
            the whole model's, 1e-5 of the largest logit; each rank's
            parameter bytes against the whole model's, the collectives of
            a step by kind
  6b ssm    mamba2-130m at full size, bf16 weights from seed 0: prefill
            (``model.loss``, B=4, T=4096) cold and 3x warm, no attention;
            decode (``serve_loop``: batch 8, 16 steps, 4 batches); profiled
            prefill and decode batch (busy share); then ``ssm-train``: the
            train CLI with no ``--arch`` (its default, the reference's) for
            two steps, and ``make_train_step`` at B=1, T=4096 (float32
            parameters, bf16 compute, remat), a warm-up and 3 timed steps,
            finite loss and grad_norm, tokens/s, peak memory
    ssm-parity  2 layers at full width in float32, B=1, T=520 (not a
            multiple of the chunk, 256), card against the CPU port: hidden
            states within 1e-4 and the loss within 1e-5 relative; 24
            decode steps, each step's state within 1e-4 and its logits
            within 1e-4 of their largest magnitude; one train step at
            phase 5's limits
    hybrid  recurrentgemma-2b at full size (26 layers: 8 groups and a tail
            of 2), bf16: as ``ssm``, with 8 flash_attention launches a
            prefill, each windowed (2048) at hd 256, counted
    hybrid-parity  one group (3 layers) at full width in float32, B=1,
            T=4096 (the window cuts in): hidden states within 1e-4, the
            loss within 1e-5 relative; 16 decode steps at positions 2040
            to 2055 on caches filled from a seed, crossing the ring's wrap
            (2048 slots), logits and every cache leaf as in ssm-parity;
            one train step at phase 5's limits on 2,304 tokens (the
            windowed hd-256 backward kernel on the card; the window cuts
            in past 2,048)
    hybrid-train  recurrentgemma-2b at full width and depth, float32
            parameters, bf16 compute, remat (per group), B=1, T=4096: a
            warm-up and 3 timed steps, 16 forward / 8 backward flash
            launches a step, all windowed (2048) at hd 256, finite loss
            and grad_norm, step seconds, tokens/s, peak memory
    vlm     internvl2-2b at full size, bf16: as ``ssm``, the prefill 256
            patches and 3,840 text tokens a row, 24 flash_attention
            launches a call
    vlm-parity  2 layers at full width in float32, 256 patches and 264
            tokens: hidden states and loss as above, one train step at
            phase 5's limits
    audio   whisper-tiny at full size (4 encoder and 4 decoder layers, d
            384, 6 heads of 64, vocab 51,865, 1,500 frames), bf16 weights
            from seed 0: prefill (``model.loss`` on B=16 rows of 1,500
            frames and 448 text tokens, Whisper's n_text_ctx) cold and 3x
            warm, each with 12 flash_attention launches (4 encoder
            non-causal, 4 decoder causal, 4 cross, by ``attention_spy``);
            ``whisper_encode`` of 8 rows timed alone; decode through
            ``make_serve_step`` over those encoder states (batch 8,
            max_len 128, 16 steps, 4 batches, 4 cross launches a step: the
            reference's serve loop has no encoder input); a profiled
            prefill and decode batch, peak memory
    audio-parity  2 encoder and 2 decoder layers at full width in
            float32, 1,500 frames, 448 tokens: encoder and decoder states
            within 1e-4, the loss within 1e-5 relative, 16 decode steps as
            in ssm-parity, one train step at phase 5's limits
    audio-train  whisper-tiny at full size, float32 parameters, bf16
            compute, remat, B=16 x (1,500 frames + 448 tokens): a warm-up
            and 3 timed steps, 24 forward / 12 backward flash launches a
            step, tokens/s, peak memory
  7 startup ``benchmarks/bench_startup.py``'s rows at W = 16 on phase
            2's LUBM-100 triples (run right after phase 2b, while they are
            held): hash on subject, random and ``mincut_lite`` seconds
            (``mincut_lite`` must take 5x hash on subject), its edge cut,
            and ``AdHashEngine`` bootstrap on the card (its answers to the
            60 queries equal to phase 2's)
The CPU side of ``lubm-parity`` (phase 2's CPU engine and its answers),
``moe-parity`` and ``hybrid-parity`` (the CPU port's forwards and first
train step's gradients), ``SIDE_JOBS``, runs in a side process spawned at
the top of the run with half of the host's threads, beside the card
phases; it makes the same seed-0 weights on the card and
moves them to the CPU before phase 1 starts (phase 1 waits for it).
``card_vs_cpu_steps`` holds the CPU's tensors against the card's on the
card.  The ``walls`` line names what moved, the side process's seconds
for each job, how long the card phases waited, and the host's memory
after each phase; a thread stops the run (exit 3, a ``memory-watch``
line) before the host's available memory falls below 6 GiB.
Each path's kernels must launch on that path's run (the DSJ kernels on
LUBM, on the directory engines and on the mesh; on a served stream probe and
``expand`` always, all four once a staged answer was served;
flash_attention on the LM, the moe, the hybrid (windowed, hd 256), the vlm
and the audio prefills, the audio decode and the mesh train steps; its
backward on the train steps, dense, moe, the mesh's, hybrid (windowed, hd
256) and audio).  Each phase
prints its wall seconds.  The line before the last holds every kernel's
numbers; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import textwrap
import time
import warnings
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import numpy as np

W = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (data sheet, FP32)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense BF16 tensor rate (data sheet)
FLOPS_PER_S = {"bfloat16": BF16_FLOPS_PER_S, "float32": INT_OPS_PER_S}
RDF_KERNELS = ("range_search", "expand", "bucket_by_dest", "unique_compact")
PREFILL = (4, 4096)  # prefill B and T of phases 4 (llama3-8b) and 6 (moe)
I32MAX = 2**31 - 1
I64MAX = 2**63 - 1


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn()`` over CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(bytes_moved: int, ops: int,
          ops_per_s: float = INT_OPS_PER_S) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate, in ms, and which one binds."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def assert_equal(name: str, got, want) -> float:
    """Bit-exact comparison; returns the max absolute difference (0)."""
    g = got.cpu().numpy()
    w = want.cpu().numpy()
    if g.shape != w.shape or not np.array_equal(g, w):
        diff = (np.abs(g.astype(np.float64) - w.astype(np.float64)).max()
                if g.shape == w.shape else math.inf)
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"(max abs diff {diff})")
    return 0.0


# ------------------------------------------------- phase 1's DSJ inputs
# The shapes and mixes LUBM-100 gives range_search and expand (phase 2's
# census): per worker (W = 8), a store row of 594,575 int64 keys; the
# reply probe's 8 senders x 2^20 lanes, each sender's live probes first
# and ascending, then the clamped key p*NID in every padding lane;
# finalize_join's 2^23 sorted int32 candidate keys (invalid ones =
# INT32_MAX last) probed by 2^20 unsorted relation values.  Each row has a
# seed of its own, so chip_ab.py rebuilds the same inputs.
STORE_ROW = 594_575  # keys per worker row of LUBM-100's store at W = 8
NID = 1 << 21  # composite keys p * NID + id
SENDERS, CAP_PEER = 8, 1 << 20  # the reply: W senders x cap_peer lanes
# query_batch folds a bucket of B queries into each kernel's launch: B*W
# rows for expand, bucket_by_dest and unique_compact, B*M probes a worker
# row for range_search.  Buckets of the 60-query LUBM-100 workload hold
# 8-13 queries, padded to B = 16 (``quantize_batch``).
FOLD_B = 16


def range_search_cases():
    """(variant, keys, probes, probes_hi or None, main) of each range_search
    row of phase 1 (probes_hi: the span form)."""
    rng = np.random.default_rng(101)
    # store keys over 18 predicates, the last eighth padded with INT64_MAX
    live = STORE_ROW - STORE_ROW // 8
    keys = np.full((W, STORE_ROW), I64MAX, np.int64)
    keys[:, :live] = np.sort(rng.integers(0, 18 * NID, (W, live)), axis=1)
    p = 5  # the probed predicate: padding lanes hold p * NID
    probes = np.full((W, SENDERS, CAP_PEER), p * NID, np.int64)
    n_live = round(CAP_PEER * 0.0057)
    for w in range(W):
        in_p = keys[w][(keys[w] >= p * NID) & (keys[w] < (p + 1) * NID)]
        for s in range(SENDERS):
            hits = rng.choice(in_p, n_live // 2)
            misses = rng.integers(p * NID, (p + 1) * NID, n_live - n_live // 2)
            probes[w, s, :n_live] = np.sort(np.concatenate([hits, misses]))
    yield ("int64 reply N=594575 M=2^23 live 0.57%", keys,
           probes.reshape(W, -1), None, True)
    del probes
    lo_k = np.full((W, 1), p * NID, np.int64)
    yield ("span_search int64 match_ranges N=594575 M=1", keys, lo_k,
           lo_k + NID, False)

    rng = np.random.default_rng(102)
    n, m = 1 << 23, 1 << 20
    n_keys = n // 10
    keys = np.full((W, n), I32MAX, np.int32)
    keys[:, :n_keys] = np.sort(rng.integers(0, 1 << 22, (W, n_keys)), axis=1)
    hits = keys[np.arange(W)[:, None], rng.integers(0, n_keys, (W, m))]
    vals = np.where(rng.random((W, m)) < 0.5, hits,
                    rng.integers(0, 1 << 22, (W, m)))
    probes = np.where(rng.random((W, m)) < 0.086, vals, I32MAX)
    yield ("int32 finalize N=2^23 M=2^20 live 8.6%", keys,
           probes.astype(np.int32), None, False)

    # the earlier rows: N = 2^20 random keys, M = 2^16 probes, half hits
    rng = np.random.default_rng(103)
    n, m = 1 << 20, 1 << 16
    for dtype, pad, hi_val in ((np.int64, I64MAX, 1 << 40),
                               (np.int32, I32MAX, 1 << 30)):
        live = n - n // 8  # padded tail, as in a store row
        keys = np.full((W, n), pad, dtype)
        keys[:, :live] = np.sort(rng.integers(0, hi_val, (W, live)), axis=1)
        hit = keys[np.arange(W)[:, None], rng.integers(0, live, (W, m))]
        miss = rng.integers(0, hi_val, (W, m))
        probes = np.where(rng.random((W, m)) < 0.5, hit, miss).astype(dtype)
        probes[:, :16] = pad  # probes equal to the pad: searchsorted result
        yield (f"{np.dtype(dtype).name} N=2^20 M=2^16 random", keys, probes,
               None, False)


def expand_cases():
    """(variant, lo, hi, out_cap, main) of each expand row of phase 1."""
    rng = np.random.default_rng(201)
    # the reply's gather_rows: 8 senders x 2^20 probe ranges, the first
    # 1.14% of each sender's lanes live and half of those matched (1-3 rows)
    k = round(CAP_PEER * 0.0114)
    lo = np.zeros((W, SENDERS, CAP_PEER), np.int32)
    lo[..., :k] = np.sort(rng.integers(0, STORE_ROW, (W, SENDERS, k)), axis=2)
    hi = lo.copy()
    hi[..., :k] += np.where(rng.random((W, SENDERS, k)) < 0.5,
                            rng.integers(1, 4, (W, SENDERS, k)), 0
                            ).astype(np.int32)
    yield ("n=2^23 out_cap=2^20 reply 0.57% non-empty",
           lo.reshape(W, -1), hi.reshape(W, -1), 1 << 20, True)
    del lo, hi
    # finalize_join: 2^20 relation rows, 8.6% matched (1-4 candidates)
    n = 1 << 20
    lo = rng.integers(0, 1 << 23, (W, n)).astype(np.int32)
    hi = lo + np.where(rng.random((W, n)) < 0.086,
                       rng.integers(1, 5, (W, n)), 0).astype(np.int32)
    yield "n=2^20 out_cap=2^20 finalize 8.6% non-empty", lo, hi, 1 << 20, False
    # match_rows: one range a worker
    lo = rng.integers(0, 1 << 20, (W, 1)).astype(np.int32)
    yield "n=1 out_cap=2^20 match_rows", lo, lo + 135_000, 1 << 20, False
    # the earlier rows: dense short ranges, and a 12% reply-like row
    n = 1 << 16
    lo = rng.integers(0, 1 << 20, (W, n)).astype(np.int32)
    hi = lo + rng.integers(0, 31, (W, n)).astype(np.int32)
    yield "n=2^16 out_cap=2^20 dense", lo, hi, 1 << 20, False
    n = 1 << 20
    lo = rng.integers(0, 1 << 20, (W, n)).astype(np.int32)
    hi = lo + np.where(rng.random((W, n)) < 0.12, 1, 0).astype(np.int32)
    yield "n=2^20 out_cap=2^18 12% non-empty", lo, hi, 1 << 18, False


# The mixes LUBM-100 gives bucket_by_dest (phase 2's ``lubm-bucket-mix``
# census, on an NVIDIA H100 80GB HBM3 at 700.00 W).  Both callers pass
# n = 2^20 rows into 8 destinations of cap_peer = 2^20 slots, and in every
# call the valid rows formed a prefix.
# The reply routing (k = 3, 50 calls) gets expand's lanes: a median of
# 4.57% of the rows valid, senders that never decrease (all 50 calls), and
# lanes past the prefix are left = n - 1, the last sender; the census saw
# no holes, and the row keeps a few (0.1% of the prefix) where the
# residual mask can drop a row.  The hash exchange (k = 1, 41 calls) gets
# project_unique's sorted uniques: the same median share, the rest -1,
# destinations splitmix64(v) % 8.
REPLY_SHARE, REPLY_DENSITY = 0.0457, 0.999
HASH_SHARE = 0.0457


def bucket_cases():
    """(variant, values, dest, valid, n_dest, cap_peer, main) of each
    bucket_by_dest row of phase 1; each row has a seed of its own."""
    from repro_torch.core.placement import splitmix64_np

    n = cap = 1 << 20
    rng = np.random.default_rng(301)
    live = round(n * REPLY_SHARE / REPLY_DENSITY)
    valid = np.zeros((W, n), bool)
    valid[:, :live] = rng.random((W, live)) < REPLY_DENSITY
    # senders in order, each taking a random share of the prefix
    cuts = np.sort(rng.integers(0, live, (W, SENDERS - 1)), axis=1)
    dest = np.full((W, n), SENDERS - 1, np.int32)
    for w in range(W):
        dest[w, :live] = np.searchsorted(cuts[w], np.arange(live),
                                         side="right")
    vals = np.where(valid[..., None],
                    rng.integers(0, 1 << 30, (W, n, 3)), -1).astype(np.int32)
    yield (f"reply n=2^20 k=3 n_dest=8 cap_peer=2^20 prefix "
           f"{REPLY_SHARE:.2%} sorted", vals, dest, valid, SENDERS, cap, True)
    del vals, valid, dest

    rng = np.random.default_rng(302)
    n_u = round(n * HASH_SHARE)
    vals = np.full((W, n), -1, np.int64)
    for w in range(W):
        vals[w, :n_u] = np.sort(rng.choice(1 << 22, n_u, replace=False))
    valid = vals >= 0
    dest = (splitmix64_np(vals) % SENDERS).astype(np.int32)
    yield (f"hash n=2^20 k=1 n_dest=8 cap_peer=2^20 prefix "
           f"{HASH_SHARE:.2%} hashed", vals.astype(np.int32)[..., None],
           dest, valid, SENDERS, cap, False)
    del vals, valid, dest

    # the earlier rows: n = 2^18 into cap_peer = 2^15, destination 0 taking
    # ~30% of the rows (~63K valid > cap_peer), and the LUBM shape with
    # random destinations and a random tenth of the rows valid
    rng = np.random.default_rng(303)
    n, cap = 1 << 18, 1 << 15
    dest = np.where(rng.random((W, n)) < 0.3, 0,
                    rng.integers(0, SENDERS, (W, n))).astype(np.int32)
    valid = rng.random((W, n)) < 0.8
    for k in (1, 3):
        vals = rng.integers(0, 1 << 30, (W, n, k)).astype(np.int32)
        yield (f"overflow n=2^18 k={k} n_dest=8 cap_peer=2^15", vals, dest,
               valid, SENDERS, cap, False)
    rng = np.random.default_rng(304)
    n = cap = 1 << 20
    yield ("random n=2^20 k=3 n_dest=8 cap_peer=2^20 10% valid",
           rng.integers(0, 1 << 30, (W, n, 3)).astype(np.int32),
           rng.integers(0, SENDERS, (W, n)).astype(np.int32),
           rng.random((W, n)) < 0.1, SENDERS, cap, False)


# The repo's skew configuration (benchmarks/bench_balance.py:_skew_engines)
# at ten times its scale: 8,000,000 drawn triples instead of 800,000, the
# bench's shapes otherwise (1024 Zipf subjects at exponent 1.8, 2^21
# objects, 4 predicates, W = 8, IRD off, no count oracle, skew threshold
# 1.2, 48 Zipf star queries).
SKEW_DATA = dict(n_subjects=1024, n_triples=8_000_000, n_objects=1 << 21,
                 n_predicates=4, exponent=1.8, seed=0)
SKEW_ENGINE = dict(adaptive=True, frequency_threshold=10**9, capacity=256,
                   use_count_oracle=False, skew_threshold=1.2)
SKEW_WORKLOAD = dict(n_subjects=1024, n_predicates=4, exponent=1.8, seed=1)


def skew_rebalance_input() -> dict:
    """The rows the skew phase's rebalance gives bucket_by_dest, built on
    the host from the same triples: the hash store's ``spo_ps`` (each shard
    sorted by (p, s, o) as ingest sorts it, padded to the largest shard),
    its live prefix, and the splits the skew detector is expected to pick
    (unsplit subjects on the hot shard whose star is at least half the
    mean shard, from the top-64 pool, by degree; up to 4); phase 1 routes
    the rows by ``triple_dest`` on the card.  Also the expected census:
    rows each destination receives and rows that leave their shard."""
    from repro_torch.core.backend import quantize_capacity
    from repro_torch.core.placement import DirectoryPlacement, HashPlacement
    from repro_torch.data.synthetic_rdf import zipf_skew

    t0 = time.perf_counter()
    triples = zipf_skew(**SKEW_DATA)
    plc = HashPlacement(W)
    assign = plc.place_triples_np(triples)
    counts = np.bincount(assign, minlength=W)
    cap_t = int(counts.max())
    spo = np.zeros((W, cap_t, 3), np.int32)
    for w in range(W):
        rows = triples[assign == w]
        spo[w, :len(rows)] = rows[np.lexsort((rows[:, 2], rows[:, 0],
                                              rows[:, 1]))]
    valid = np.arange(cap_t)[None, :] < counts[:, None]
    deg = np.bincount(triples[:, 0])
    pool = np.argpartition(deg, -64)[-64:]
    hot = int(counts.argmax())
    picked = [int(s) for s in pool[np.argsort(-deg[pool], kind="stable")]
              if plc.owner_np(np.array([s]))[0] == hot
              and deg[s] >= 0.5 * counts.mean()][:4]
    dplc = DirectoryPlacement(W)
    dplc.add_splits(picked)
    sent = np.bincount(assign * W + dplc.place_triples_np(triples),
                       minlength=W * W).reshape(W, W)
    return {"triples": triples, "vals": spo, "valid": valid,
            "cap_peer": quantize_capacity(cap_t // max(W // 2, 1)),
            "splits": picked, "counts_before": counts,
            "counts_after": sent.sum(axis=0),
            "moved_rows": int(sent.sum() - np.trace(sent)),
            "build_s": time.perf_counter() - t0}


def bucket_bytes(vals, valid, n_dest: int, cap: int) -> int:
    """Bytes bucket_by_dest must move: ``valid`` of every row, ``dest`` and
    ``values`` of the valid rows, all of send and send_valid, max_wanted."""
    w, _, k = vals.shape
    return (valid.numel() + int(valid.sum()) * (4 + 4 * k) +
            w * n_dest * cap * (4 * k + 1) + 8 * w)


# ------------------------------------------------------------------ phase 1
def phase_kernels(torch, skew_in: dict) -> dict[str, dict]:
    from repro_torch.core import backend, relalg
    from repro_torch.core.placement import DirectoryPlacement
    from repro_torch.kernels.relalg_ops.bucket import bucket_by_dest_cuda
    from repro_torch.kernels.relalg_ops.compact import unique_compact_cuda
    from repro_torch.kernels.relalg_ops.expand import expand_cuda
    from repro_torch.kernels.semijoin.probe import (range_search_cuda,
                                                    span_search_cuda)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows: dict[str, dict] = {}

    def record(name, variant, err, kernel_fn, plain_fn, library_fn,
               bytes_moved, ops, main):
        ms = time_ms(torch, kernel_fn)
        plain_ms = time_ms(torch, plain_fn)
        library_ms = time_ms(torch, library_fn) if library_fn else None
        b_ms, b_by = bound(bytes_moved, ops)
        row = {"phase": "kernels", "kernel": name, "variant": variant,
               "bit_exact": True, "max_abs_err": err, "kernel_ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "bytes": bytes_moved, "ops": ops}
        emit(row)
        if main:
            rows[name] = row

    def fold_range_search(k_t, p_t, q_t, variant):
        if q_t is None:
            kernel_fn = lambda: range_search_cuda(k_t, p_t)
            plain_fn = lambda: backend.range_search_plain(k_t, p_t)
        else:
            kernel_fn = lambda: span_search_cuda(k_t, p_t, q_t)
            plain_fn = lambda: backend.span_search_plain(k_t, p_t, q_t)
        got, want = kernel_fn(), plain_fn()
        err = max(assert_equal(f"range_search lo {variant}", got[0], want[0]),
                  assert_equal(f"range_search hi {variant}", got[1], want[1]))
        del got, want
        library_fn = lambda: [torch.searchsorted(
            k_t, x, side=side, out_int32=True) for x, side in (
                (p_t, "left"), (p_t if q_t is None else q_t,
                                "right" if q_t is None else "left"))]
        (w, n), m, isz = k_t.shape, p_t.shape[1], k_t.element_size()
        record("range_search", variant, err, kernel_fn, plain_fn, library_fn,
               w * n * isz + (1 if q_t is None else 2) * w * m * isz +
               2 * w * m * 4, 2 * w * m * math.ceil(math.log2(max(n, 2))),
               False)

    # ---- range_search / span_search: the main path's rows (LUBM-100's
    # census, phase 2), then the earlier random rows as variants, and the
    # main rows folded as query_batch folds a bucket of FOLD_B queries
    for variant, keys, probes, probes_hi, main in range_search_cases():
        k_t, p_t = cuda(keys), cuda(probes)
        q_t = None if probes_hi is None else cuda(probes_hi)
        if q_t is None:
            kernel_fn = lambda: range_search_cuda(k_t, p_t)
            plain_fn = lambda: backend.range_search_plain(k_t, p_t)
            library_fn = lambda: (
                torch.searchsorted(k_t, p_t, side="left", out_int32=True),
                torch.searchsorted(k_t, p_t, side="right", out_int32=True))
        else:
            kernel_fn = lambda: span_search_cuda(k_t, p_t, q_t)
            plain_fn = lambda: backend.span_search_plain(k_t, p_t, q_t)
            library_fn = lambda: (
                torch.searchsorted(k_t, p_t, side="left", out_int32=True),
                torch.searchsorted(k_t, q_t, side="left", out_int32=True))
        got, want = kernel_fn(), plain_fn()
        err = max(assert_equal(f"range_search lo {variant}", got[0], want[0]),
                  assert_equal(f"range_search hi {variant}", got[1], want[1]))
        if q_t is None and variant.startswith("int64 N=2^20"):
            # span form (two left searches, q < p in a few) on the same keys
            pad = torch.iinfo(k_t.dtype).max
            p2 = torch.where(p_t == pad, p_t, p_t + 1)
            p2[:, :64] = p_t[:, :64] - 7
            got = span_search_cuda(k_t, p_t, p2)
            want = backend.span_search_plain(k_t, p_t, p2)
            assert_equal("span_search lo", got[0], want[0])
            assert_equal("span_search hi", got[1], want[1])
        isz = keys.itemsize
        w, n = keys.shape
        m = probes.shape[1]
        n_probe_arrays = 1 if q_t is None else 2
        record("range_search", variant, err, kernel_fn, plain_fn, library_fn,
               w * n * isz + n_probe_arrays * w * m * isz + 2 * w * m * 4,
               2 * w * m * math.ceil(math.log2(max(n, 2))), main)
        del got, want
        if main:  # the reply probe of a bucket: B*M probes a worker row
            fold_range_search(k_t, p_t.repeat(1, FOLD_B), None,
                              f"folded B={FOLD_B}: {variant} -> M=16x2^23")
        elif q_t is not None:  # match_ranges of a bucket: the span form
            p = torch.arange(FOLD_B, device=dev, dtype=torch.int64) * NID
            fold_range_search(k_t, p.expand(W, -1).contiguous(),
                              (p + NID).expand(W, -1).contiguous(),
                              f"folded B={FOLD_B}: {variant} -> M=16")
        del k_t, p_t, q_t

    # ---- expand: the main path's rows, then the earlier rows as variants
    def check_expand(lo_t, hi_t, cap, tag):
        got = expand_cuda(lo_t, hi_t, cap)
        want = relalg.expand_plain(lo_t, hi_t, cap)
        assert_equal(f"expand valid {tag}", got[2], want[2])
        assert_equal(f"expand total {tag}", got[3], want[3])
        v = want[2]
        assert_equal(f"expand left {tag}", got[0][v], want[0][v])
        return assert_equal(f"expand right_pos {tag}", got[1][v], want[1][v])

    def record_expand(lo_t, hi_t, cap, variant, main):
        err = check_expand(lo_t, hi_t, cap, variant)
        w, n = lo_t.shape
        record("expand", variant, err,
               lambda: expand_cuda(lo_t, hi_t, cap),
               lambda: relalg.expand_plain(lo_t, hi_t, cap), None,
               2 * w * n * 4 + w * cap * 9 + w * 8,
               w * n + w * cap * math.ceil(math.log2(max(n, 2))), main)

    for variant, lo, hi, cap, main in expand_cases():
        lo_t, hi_t = cuda(lo), cuda(hi)
        record_expand(lo_t, hi_t, cap, variant, main)
        if main:  # the reply's gather_rows of a bucket: B*W rows
            record_expand(lo_t.repeat(FOLD_B, 1), hi_t.repeat(FOLD_B, 1),
                          cap, f"folded B={FOLD_B}: {variant} -> "
                          f"{FOLD_B * W} rows", False)
        del lo_t, hi_t
        torch.cuda.empty_cache()
    # the int64-total case: 8 ranges of 2^30 rows -> total 2^33
    big_lo = cuda(np.zeros((W, 8), np.int32))
    big_hi = cuda(np.full((W, 8), 1 << 30, np.int32))
    check_expand(big_lo, big_hi, 32, "int64 total")
    tot = expand_cuda(big_lo, big_hi, 32)[3]
    if int(tot.min()) != 8 << 30:
        raise AssertionError(f"expand total wrapped: {tot.tolist()}")
    torch.cuda.empty_cache()

    # ---- bucket_by_dest: the main path's rows (reply routing, hash
    # exchange), then the earlier rows (overflow, random destinations)
    def record_bucket(v_t, d_t, m_t, nd, cap, variant, main):
        got = bucket_by_dest_cuda(v_t, d_t, m_t, nd, cap)
        want = relalg.bucket_by_dest_plain(v_t, d_t, m_t, nd, cap)
        err = 0.0
        for part, g, w_ in zip(("send", "send_valid", "max"), got, want):
            err = max(err, assert_equal(f"bucket_by_dest {part} {variant}",
                                        g, w_))
        if "overflow" in variant and int(got[2].min()) <= cap:
            raise AssertionError("bucket_by_dest: no destination overflowed")
        del got, want
        torch.cuda.empty_cache()
        record("bucket_by_dest", variant, err,
               lambda: bucket_by_dest_cuda(v_t, d_t, m_t, nd, cap),
               lambda: relalg.bucket_by_dest_plain(v_t, d_t, m_t, nd, cap),
               None, bucket_bytes(v_t, m_t, nd, cap),
               4 * v_t.shape[0] * v_t.shape[1], main)

    for variant, vals, dest, valid, nd, cap, main in bucket_cases():
        v_t, d_t, m_t = cuda(vals), cuda(dest), cuda(valid)
        record_bucket(v_t, d_t, m_t, nd, cap, variant, main)
        if main:  # the reply routing of a bucket: B*W rows, n_dest = W
            record_bucket(v_t.repeat(FOLD_B, 1, 1), d_t.repeat(FOLD_B, 1),
                          m_t.repeat(FOLD_B, 1), nd, cap,
                          f"folded B={FOLD_B}: {variant} -> "
                          f"{FOLD_B * W} rows", False)
        del v_t, d_t, m_t
        torch.cuda.empty_cache()

    # the two shapes directory placement adds: the skew phase's rebalance
    # (k = 3, the hash store's rows routed by triple_dest), and the LUBM
    # hash exchange fanned out over max_split = 8 replicas a value (k = 1,
    # n = 8 x 2^20, only the first replica of each value valid)
    v_t, m_t = cuda(skew_in["vals"]), cuda(skew_in["valid"])
    plc = DirectoryPlacement(W)
    plc.add_splits(skew_in["splits"])
    d_t = plc.stage_spec.triple_dest(v_t[..., 0], v_t[..., 2], m_t,
                                     plc.device_table(dev))
    per_dest = torch.bincount(d_t[m_t], minlength=W).cpu().numpy()
    if not np.array_equal(per_dest, skew_in["counts_after"]):
        raise AssertionError(f"triple_dest on the card {per_dest} != the "
                             f"host's place_triples_np "
                             f"{skew_in['counts_after']}")
    n_rows = v_t.shape[1]
    record_bucket(v_t, d_t, m_t, W, skew_in["cap_peer"],
                  f"rebalance n={n_rows} k=3 n_dest=8 cap_peer="
                  f"2^{skew_in['cap_peer'].bit_length() - 1} split "
                  f"{skew_in['splits']}", False)
    emit({"phase": "skew-bucket-mix", "what": "the skew phase's rebalance "
          "rows, built on the host before phase 1",
          "shape": {"rows": W, "n": n_rows, "k": 3, "n_dest": W,
                    "cap_peer": skew_in["cap_peer"]},
          "valid_share": float(skew_in["valid"].mean()),
          "valid_prefix": True, "splits": skew_in["splits"],
          "rows_per_dest": per_dest.tolist(),
          "rows_leaving_their_shard": skew_in["moved_rows"],
          "host_build_s": skew_in["build_s"]})
    del v_t, d_t, m_t
    torch.cuda.empty_cache()
    rng = np.random.default_rng(302)  # the hash row's values
    n = 1 << 20
    n_u = round(n * HASH_SHARE)
    vals = np.full((W, n), -1, np.int64)
    for w in range(W):
        vals[w, :n_u] = np.sort(rng.choice(1 << 22, n_u, replace=False))
    p_t = cuda(vals.astype(np.int32))
    unsplit = DirectoryPlacement(W)  # LUBM is balanced: an empty table
    dests, dvalid = unsplit.stage_spec.value_dests(
        p_t, p_t >= 0, unsplit.device_table(dev))
    f = dests.shape[1]
    v_t = p_t[:, None, :].expand(W, f, n).reshape(W, f * n, 1)
    record_bucket(v_t, dests.reshape(W, f * n).contiguous(),
                  dvalid.reshape(W, f * n).contiguous(), W, n,
                  f"directory-exchange n=8x2^20 k=1 n_dest=8 cap_peer=2^20 "
                  f"replica 0 prefix {HASH_SHARE:.2%}", False)
    del p_t, dests, dvalid, v_t
    torch.cuda.empty_cache()

    def record_unique(v_t, m_t, cap, tag, main, overflow):
        pad = torch.iinfo(v_t.dtype).max
        got = unique_compact_cuda(v_t, m_t, cap, pad)
        want = relalg.unique_compact_plain(v_t, m_t, cap, pad)
        err = 0.0
        for part, g, w_ in zip(("uniq", "mask", "n_unique"), got, want):
            err = max(err, assert_equal(f"unique_compact {part} {tag}", g,
                                        w_))
        if overflow and int(got[2].min()) <= cap:
            raise AssertionError("unique_compact: out_cap not below n_unique")
        del got, want
        w, n = v_t.shape
        offs = torch.arange(w, device=dev, dtype=torch.int64)[:, None] << 32
        keyed = torch.where(m_t, v_t, pad).to(torch.int64) + offs
        isz = v_t.element_size()
        record("unique_compact", f"{tag} out_cap={cap}", err,
               lambda: unique_compact_cuda(v_t, m_t, cap, pad),
               lambda: relalg.unique_compact_plain(v_t, m_t, cap, pad),
               lambda: torch.unique(keyed.view(-1), sorted=True),
               w * n * (isz + 1) + w * cap * (isz + 1) + w * 8,
               w * n * max(1, math.ceil(math.log2(n))), main)

    # ---- unique_compact: n = 2^10 (one radix tile) and n = 2^18 (the main
    # path's row, 64 tiles) in int32, and n = 2^18 in int64 (8 digits, the
    # high ones skipped on the device); out_cap below n_unique
    for n, hi_val, cap, dtype in ((1 << 10, 800, 256, np.int32),
                                  (1 << 18, 1 << 17, 1 << 16, np.int32),
                                  (1 << 18, 1 << 17, 1 << 16, np.int64)):
        v_t = cuda(rng.integers(0, hi_val, (W, n)).astype(dtype))
        m_t = cuda(rng.random((W, n)) < 0.9)
        record_unique(v_t, m_t, cap,
                      f"{np.dtype(dtype).name} n=2^{n.bit_length() - 1}",
                      n == 1 << 18 and dtype == np.int32, True)
    # project_unique of a bucket: B*W rows of the census's shape (n = 2^20
    # into out_cap = 2^20, int32); a valid prefix of 4.57% of each row, the
    # share bucket_by_dest's census saw downstream, ids below 2^21
    n = 1 << 20
    gen = torch.Generator(device=dev).manual_seed(401)
    v_t = torch.randint(0, 1 << 21, (FOLD_B * W, n), device=dev,
                        dtype=torch.int32, generator=gen)
    m_t = (torch.arange(n, device=dev) < round(n * HASH_SHARE)).expand(
        FOLD_B * W, n).contiguous()
    record_unique(v_t, m_t, n, f"folded B={FOLD_B}: project_unique int32 "
                  f"n=2^20 prefix {HASH_SHARE:.2%} -> {FOLD_B * W} rows",
                  False, False)
    del v_t, m_t
    torch.cuda.empty_cache()
    return rows


def attention_errors(got, want) -> tuple[float, float]:
    """Max abs difference, and the largest difference within one output row
    (b, t, h) over the largest magnitude of that row of ``want``."""
    d = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    return float(d.max()), float((d / scale).max())


def phase_flash(torch) -> dict:
    """flash_attention vs its plain version at llama3-8b's and qwen2-moe's
    attention shapes and variants; returns the main row, the shape phase 4's prefill gives
    the kernel (B=4, T=S=4096, bf16, causal)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_cuda, flash_attention_plain, flash_engine)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # Absolute limits as in tests/test_kernels.py.  The per-row limits
    # follow the output's size: two bf16 roundings of one f32 value differ
    # by at most one ulp, 2^-7 of the row's largest magnitude; f32 agrees to
    # summation order.  With unit-normal inputs a row's values shrink as
    # sqrt(1/S), so only the per-row limit would see a dropped key tile at
    # S = 32768 (about 1% of a row in bf16: the f32 32k row holds that).
    tols = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
    main_row = None
    pb, pt = PREFILL
    # (variant, B, T, H, KV, hd, dtype, causal)
    shapes = [
        (f"llama3-8b prefill layer B={pb} T=S={pt} bf16 causal", pb, pt, 32,
         8, 128, torch.bfloat16, True),
        (f"qwen2-moe prefill layer B={pb} T=S={pt} H=KV=16 bf16 causal", pb,
         pt, 16, 16, 128, torch.bfloat16, True),
        ("B=1", 1, 4096, 32, 8, 128, torch.bfloat16, True),
        ("non-causal", 1, 4096, 32, 8, 128, torch.bfloat16, False),
        ("T=S=1000 (masked tail)", 1, 1000, 32, 8, 128, torch.bfloat16,
         True),
        ("f32", 1, 4096, 32, 8, 128, torch.float32, True),
        ("qwen1.5-4b MHA H=KV=20", 1, 4096, 20, 20, 128, torch.bfloat16,
         True),
        ("hd=64", 1, 4096, 32, 8, 64, torch.bfloat16, True),
        ("hd=16", 1, 4096, 32, 8, 16, torch.bfloat16, True),
        ("prefill_32k row T=S=32768", 1, 32768, 32, 8, 128, torch.bfloat16,
         True),
        ("prefill_32k row T=S=32768 f32", 1, 32768, 32, 8, 128,
         torch.float32, True),
        # train-mesh2's local heads: qwen2-moe's 16 over model = 2
        ("train-mesh2 rank's layer B=2 T=S=512 H=KV=8 f32 causal", 2, 512,
         8, 8, 128, torch.float32, True),
    ]
    for variant, b, t, h, kv, hd, dt, causal in shapes:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                         dtype=torch.float32).to(dt)
        q, k, v = rnd(b, t, h, hd), rnd(b, t, kv, hd), rnd(b, t, kv, hd)
        long_row = t > 8192
        with torch.inference_mode():
            got = flash_attention_cuda(q, k, v, causal=causal)
            relaunch_equal = torch.equal(
                got, flash_attention_cuda(q, k, v, causal=causal))
            if long_row:  # a plain 32k x 32k score matrix does not fit
                off = t - 256
                want = flash_attention_plain(q[:, off:], k, v, causal=causal,
                                             q_offset=off)
                tail = flash_attention_cuda(q[:, off:], k, v, causal=causal,
                                            q_offset=off)
                errs = [attention_errors(got[:, off:], want),
                        attention_errors(tail, want)]
                del tail
            else:
                want = flash_attention_plain(q, k, v, causal=causal)
                errs = [attention_errors(got, want)]
            err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            if not (err <= tols[dt][0] and rel <= tols[dt][1]):
                raise AssertionError(
                    f"flash_attention {variant}: max abs err {err} (limit "
                    f"{tols[dt][0]}), max err within a row over its max "
                    f"{rel} (limit {tols[dt][1]})")
            if not relaunch_equal:
                raise AssertionError(f"flash_attention {variant}: two "
                                     f"launches gave different bits")
            del want, got
            reps = 3 if long_row else 20
            ms = time_ms(torch, lambda: flash_attention_cuda(
                q, k, v, causal=causal), reps)
            plain_ms = None if long_row else time_ms(
                torch, lambda: flash_attention_plain(q, k, v, causal=causal),
                reps)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            # SDPA's f32 path with GQA materializes the scores: 128 GiB at 32k
            library_ms = None if long_row and dt == torch.float32 else \
                time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), reps)
        isz = q.element_size()
        bytes_moved = 2 * b * t * h * hd * isz + 2 * b * t * kv * hd * isz
        flops = 4 * b * h * t * t * hd // (2 if causal else 1)
        b_ms, b_by = bound(bytes_moved, flops,
                           FLOPS_PER_S[str(dt).split(".")[1]])
        row = {"phase": "kernels", "kernel": "flash_attention",
               "variant": variant, "shape": {"B": b, "T": t, "S": t, "H": h,
                                             "KV": kv, "hd": hd},
               "dtype": str(dt).split(".")[1], "causal": causal,
               "engine": flash_engine(dt), "max_abs_err": err,
               "max_row_rel_err": rel,
               "tolerance": {"abs": tols[dt][0], "row_rel": tols[dt][1]},
               "checked_rows": "last 256 (q_offset=32512)" if long_row
               else "all", "bit_identical_relaunch": relaunch_equal,
               "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention(enable_gqa=True)",
               "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_moved,
               "ops": flops, "tflops": flops / ms / 1e9,
               "tc_share": tc_share(dt, flops, ms)}
        emit(row)
        if main_row is None:
            main_row = row
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return main_row


def tc_share(dt, flops: int, ms: float) -> float | None:
    """A bf16 row's achieved rate over the tensor cores' dense peak (989
    TFLOP/s); None for float32, which runs on the CUDA cores."""
    import torch

    if dt != torch.bfloat16:
        return None
    return flops / (ms * 1e-3) / BF16_FLOPS_PER_S


def grad_errors(got, want) -> tuple[float, float]:
    """Over the (dq, dk, dv) triples: the largest difference over the
    largest magnitude (at least 1) of its tensor, and the largest
    difference within one gradient row (b, t or s, head) over that row's
    largest magnitude, floored at 1% of the first measure's denominator: a
    row whose exact gradient is 0 (query 0's dq when causal: one visible
    key, so dS = P (dP - D) = 0) holds only rounding noise."""
    worst = [0.0, 0.0]
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs().amax(-1)
        row = w.float().abs().amax(-1)
        top = max(1.0, float(row.max()))
        worst[0] = max(worst[0], float(d.max()) / top)
        worst[1] = max(worst[1], float((d / row.clamp_min(1e-2 * top)).max()))
    return worst[0], worst[1]


def visible_pairs(t: int, s: int, causal: bool, q_offset: int,
                  window: int = 0) -> int:
    """(query, key) pairs the mask lets through: over the queries t, the
    keys below min(S, q_offset + t + 1) when causal (else S), from
    max(0, q_offset + t - window + 1) with a window."""
    qpos = q_offset + np.arange(t, dtype=np.int64)
    hi = np.minimum(s, qpos + 1) if causal else np.full(t, s, np.int64)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else 0
    return int(np.maximum(hi - lo, 0).sum())


# phase 1's windowed and hd-256 forward rows, the hybrid prefill's shape
# first (recurrentgemma-2b: H=10, KV=1, hd=256, window 2048): (variant, B,
# T, S, H, KV, hd, dtype, causal, q_offset, window)
FLASH_WINDOW_SHAPES = [
    ("recurrentgemma-2b prefill layer B=4 T=S=4096 H=10 KV=1 hd=256 bf16 "
     "causal window 2048", 4, 4096, 4096, 10, 1, 256, "bfloat16", True, 0,
     2048),
    ("f32 hd=256 window 2048", 1, 4096, 4096, 10, 1, 256, "float32", True,
     0, 2048),
    ("window 1 (the diagonal)", 1, 4096, 4096, 10, 1, 256, "bfloat16", True,
     0, 1),
    ("window 4096 >= T (the unwindowed bits)", 1, 4096, 4096, 10, 1, 256,
     "bfloat16", True, 0, 4096),
    ("T=1024 S=4096 q_offset=3072 window 2048", 1, 1024, 4096, 10, 1, 256,
     "bfloat16", True, 3072, 2048),
    ("odd T=S=1001 window 300", 1, 1001, 1001, 10, 1, 256, "bfloat16", True,
     0, 300),
    ("hd=256 no window", 1, 4096, 4096, 10, 1, 256, "bfloat16", True, 0, 0),
]
# phase 1's rows at the audio path's shapes (whisper-tiny: H=KV=6, hd=64;
# 1,500 encoder frames, 448 text positions, Whisper's n_text_ctx): the
# encoder's self-attention, the decoder's, its cross-attention to the
# frames in the prefill (B=16) and in a decode step (B=8, T=1)
FLASH_AUDIO_SHAPES = [
    (f"whisper-tiny encoder layer B=16 T=S=1500 H=KV=6 hd=64 {dt} "
     "non-causal", 16, 1500, 1500, 6, 6, 64, dt, False, 0, 0)
    for dt in ("bfloat16", "float32")
] + [
    (f"whisper-tiny cross layer B=16 T=448 S=1500 {dt}", 16, 448, 1500, 6,
     6, 64, dt, False, 0, 0)
    for dt in ("bfloat16", "float32")
] + [
    (f"whisper-tiny decode cross B=8 T=1 S=1500 {dt}", 8, 1, 1500, 6, 6, 64,
     dt, False, 0, 0)
    for dt in ("bfloat16", "float32")
] + [
    ("whisper-tiny decoder self layer B=16 T=S=448 bf16 causal", 16, 448,
     448, 6, 6, 64, "bfloat16", True, 0, 0),
]


def sdpa_backend(torch, fn) -> dict:
    """The CUDA kernel that takes most of ``fn()``'s device time under the
    profiler, and the SDPA backend its name points to."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    self_us = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == cuda), key=self_us, reverse=True)
    top = kernels[0].key if kernels else ""
    low = top.lower()
    backend = ("cudnn" if "cudnn" in low else "flash" if "flash" in low
               else "efficient" if "fmha" in low or "efficient" in low
               else "math")
    return {"backend": backend, "top_kernel": top[:80]}


def phase_flash_window(torch, shapes=FLASH_WINDOW_SHAPES,
                       seed: int = 1) -> dict:
    """The forward kernels against the plain version at ``shapes`` (T and
    S apart, q_offset, window): by default with a window and at hd 256, at
    the hybrid prefill's shape and variants; ``FLASH_AUDIO_SHAPES`` the
    audio path's.  Returns the first row (by default B=4, T=S=4096, H=10,
    KV=1, hd=256, bf16, causal, window 2048)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_cuda, flash_attention_plain, flash_engine)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tols = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
    main_row = None
    for variant, b, t, s, h, kv, hd, dname, causal, off, w in shapes:
        dt = getattr(torch, dname)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                         dtype=torch.float32).to(dt)
        q, k, v = rnd(b, t, h, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd)
        kw = dict(causal=causal, q_offset=off, window=w)
        with torch.inference_mode():
            got = flash_attention_cuda(q, k, v, **kw)
            relaunch_equal = torch.equal(got, flash_attention_cuda(q, k, v,
                                                                   **kw))
            unwindowed_equal = None
            if w >= off + t:  # hides nothing: the unwindowed launch's bits
                unwindowed_equal = torch.equal(got, flash_attention_cuda(
                    q, k, v, causal=causal, q_offset=off))
            want = flash_attention_plain(q, k, v, **kw)
            err, rel = attention_errors(got, want)
            del want, got
            if not (err <= tols[dt][0] and rel <= tols[dt][1]):
                raise AssertionError(
                    f"flash_attention {variant}: max abs err {err} (limit "
                    f"{tols[dt][0]}), max err within a row over its max "
                    f"{rel} (limit {tols[dt][1]})")
            if not relaunch_equal or unwindowed_equal is False:
                raise AssertionError(
                    f"flash_attention {variant}: relaunch bit-identical "
                    f"{relaunch_equal}, equal to the unwindowed launch "
                    f"{unwindowed_equal}")
            ms = time_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw))
            plain_ms = time_ms(torch, lambda: flash_attention_plain(
                q, k, v, **kw), 5)
            # SDPA with the window as a boolean mask, KV heads expanded
            # (no mask where every key is visible)
            qpos = off + torch.arange(t, device=dev)[:, None]
            kpos = torch.arange(s, device=dev)[None, :]
            mask = kpos <= qpos if causal else None
            if w > 0:
                mask = (kpos > qpos - w) if mask is None else \
                    mask & (kpos > qpos - w)
            qt = q.transpose(1, 2)
            kt, vt = (x.transpose(1, 2).repeat_interleave(h // kv, dim=1)
                      for x in (k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask)
            library_ms = time_ms(torch, sdpa, 5)
            library = sdpa_backend(torch, sdpa)
        pairs = visible_pairs(t, s, causal, off, w)
        isz = q.element_size()
        bytes_moved = 2 * b * t * h * hd * isz + 2 * b * s * kv * hd * isz
        flops = 4 * b * h * hd * pairs
        b_ms, b_by = bound(bytes_moved, flops, FLOPS_PER_S[dname])
        row = {"phase": "kernels", "kernel": "flash_attention",
               "variant": variant,
               "shape": {"B": b, "T": t, "S": s, "H": h, "KV": kv, "hd": hd,
                         "q_offset": off, "window": w},
               "dtype": dname, "causal": causal, "engine": flash_engine(dt),
               "max_abs_err": err, "max_row_rel_err": rel,
               "tolerance": {"abs": tols[dt][0], "row_rel": tols[dt][1]},
               "bit_identical_relaunch": relaunch_equal,
               "equals_unwindowed_launch": unwindowed_equal,
               "kernel_ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention(attn_mask=the "
                          "mask or none, KV heads repeated)", **{
                              f"library_{k_}": v_
                              for k_, v_ in library.items()},
               "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_moved,
               "visible_pairs": pairs, "ops": flops,
               "tflops": flops / ms / 1e9, "tc_share": tc_share(dt, flops,
                                                                ms)}
        emit(row)
        if main_row is None:
            main_row = row
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return main_row


# the forward kernels' log-sum-exp against the plain forward's: float32
# sums of the same exponentials in another order (as in the card tests)
LSE_TOL = 1e-5
# phase 1's backward rows, the train phase's shape first (``chip_ab.py
# flash_bwd`` times the bf16 ones): (variant, B, T, S, H, KV, hd, dtype,
# causal, q_offset[, window])
FLASH_BWD_SHAPES = [
    ("qwen1.5-4b train_4k layer B=1 T=S=4096 H=KV=20 bf16 causal", 1, 4096,
     4096, 20, 20, 128, "bfloat16", True, 0),
    ("qwen2-moe train_4k layer H=KV=16", 1, 4096, 4096, 16, 16, 128,
     "bfloat16", True, 0),
    ("llama3-8b GQA H=32 KV=8", 1, 4096, 4096, 32, 8, 128, "bfloat16", True,
     0),
    ("f32", 1, 4096, 4096, 20, 20, 128, "float32", True, 0),
    ("T=1024 S=4096 q_offset=3072", 1, 1024, 4096, 20, 20, 128, "bfloat16",
     True, 3072),
    ("hd=64", 1, 4096, 4096, 32, 8, 64, "bfloat16", True, 0),
    ("non-causal", 1, 4096, 4096, 20, 20, 128, "bfloat16", False, 0),
    ("odd T=S=1001", 1, 1001, 1001, 20, 20, 128, "bfloat16", True, 0),
    # the audio train step's (whisper-tiny, B=16, 448 text positions, 1,500
    # frames): cross-attention, the encoder's and the decoder's own
    ("whisper-tiny cross B=16 T=448 S=1500 H=KV=6 hd=64 non-causal", 16,
     448, 1500, 6, 6, 64, "bfloat16", False, 0),
    ("whisper-tiny encoder B=16 T=S=1500 non-causal", 16, 1500, 1500, 6, 6,
     64, "bfloat16", False, 0),
    ("whisper-tiny decoder self B=16 T=S=448 causal", 16, 448, 448, 6, 6, 64,
     "bfloat16", True, 0),
    # the hybrid train step's (recurrentgemma-2b: H=10, KV=1, hd=256,
    # window 2048), then the window's and hd 256's variants
    ("recurrentgemma-2b train_4k layer B=1 T=S=4096 H=10 KV=1 hd=256 bf16 "
     "causal window 2048", 1, 4096, 4096, 10, 1, 256, "bfloat16", True, 0,
     2048),
    ("f32 hd=256 window 2048", 1, 4096, 4096, 10, 1, 256, "float32", True, 0,
     2048),
    ("f32 hd=256 no window", 1, 4096, 4096, 10, 1, 256, "float32", True, 0,
     0),
    ("window 1 (the diagonal)", 1, 4096, 4096, 10, 1, 256, "bfloat16", True,
     0, 1),
    ("window 4096 >= T (the unwindowed bits)", 1, 4096, 4096, 10, 1, 256,
     "bfloat16", True, 0, 4096),
    ("T=1024 S=4096 q_offset=3072 window 2048", 1, 1024, 4096, 10, 1, 256,
     "bfloat16", True, 3072, 2048),
    ("odd T=S=1001 window 300", 1, 1001, 1001, 10, 1, 256, "bfloat16", True,
     0, 300),
    # train-mesh2's local heads: qwen2-moe's 16 over model = 2
    ("train-mesh2 rank's layer B=2 T=S=512 H=KV=8 f32 causal", 2, 512, 512,
     8, 8, 128, "float32", True, 0),
]


def phase_flash_bwd(torch) -> dict:
    """The flash_attention backward kernel vs its plain version (float32
    math), both fed the plain forward's o and log-sum-exp, and the forward
    kernel's o and log-sum-exp vs the plain forward's, on the same q, k, v
    and dO, at the train phase's shape, moe-train's and variants; two
    launches must give
    the same bits.  The two pipelines (each forward, then its backward)
    are printed against the float32 gradient.  Returns the
    main row: qwen1.5-4b's attention at train_4k's length (B=1, T=S=4096,
    H=KV=20, hd=128, bf16, causal)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_plain, flash_engine)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # The forward's limits, on ``grad_errors``' two measures: f32 agrees to
    # summation order; a bf16 gradient is rounded once from float32, at most
    # 2^-8 of its own magnitude, 2^-7 of its row's largest.
    tols = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
    main_row = None
    for variant, b, t, s, h, kv, hd, dt, causal, off, *rest in \
            FLASH_BWD_SHAPES:
        w = rest[0] if rest else 0
        mk = dict(causal=causal, q_offset=off, window=w)
        dt = getattr(torch, dt)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                         dtype=torch.float32).to(dt)
        q, k, v, do = rnd(b, t, h, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd), \
            rnd(b, t, h, hd)
        # Each kernel against its plain version on inputs the other kernel
        # did not make: the forward kernel's o and LSE against the plain
        # forward's, and the backward kernel against the plain backward,
        # both fed the plain forward's o and LSE.
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **mk)
        o_ref, lse_ref = flash_attention_plain(q, k, v, return_lse=True,
                                               **mk)
        lse_err = float((lse - lse_ref).abs().max())
        lse_ok = bool(((lse - lse_ref).abs() <=
                       LSE_TOL + LSE_TOL * lse_ref.abs()).all())
        o_err = grad_errors([o], [o_ref])
        kern = lambda: flash_attention_bwd_cuda(q, k, v, o_ref, do, lse_ref,
                                                **mk)
        plain = lambda: flash_attention_bwd_plain(q, k, v, o_ref, do, lse_ref,
                                                  **mk)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        identical = all(torch.equal(a, c) for a, c in zip(got, again))
        unwindowed_equal = None
        if w >= off + t:  # hides nothing: the unwindowed launch's bits
            unwindowed_equal = all(torch.equal(a, c) for a, c in zip(
                got, flash_attention_bwd_cuda(q, k, v, o_ref, do, lse_ref,
                                              causal=causal, q_offset=off)))
        want = plain()
        err, rel = grad_errors(got, want)
        del got, again
        # The train path's pipeline (forward kernel, then the backward
        # kernel on its o and LSE) and the plain one, each against the
        # float32 gradient of the same inputs (o not rounded): printed.
        # Both round o to the input dtype before D = rowsum(dO * O), so
        # the two pipelines differ by that rounding, not by a kernel.
        chain = flash_attention_bwd_cuda(q, k, v, o, do, lse, **mk)
        f32 = [x.float() for x in (q, k, v)]
        o32, lse32 = flash_attention_plain(*f32, return_lse=True, **mk)
        exact = flash_attention_bwd_plain(*f32, o32, do.float(), lse32, **mk)
        pipeline = {"kernels_vs_plain": grad_errors(chain, want),
                    "kernels_vs_f32": grad_errors(chain, exact),
                    "plain_vs_f32": grad_errors(want, exact)}
        # SDPA's is_causal aligns top-left at q_offset 0; with an offset or
        # a window the same mask goes in as a (T, S) boolean attn_mask
        mask = None
        if (causal and off) or w > 0:
            kpos = torch.arange(s, device=dev)[None, :]
            qpos = off + torch.arange(t, device=dev)[:, None]
            mask = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
            if w > 0:
                mask = mask & (kpos > qpos - w)
        sdpa = lambda *x: F.scaled_dot_product_attention(
            *x, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        # SDPA's backward against the same float32 gradient: the yardstick
        # of a kernel's error in the input dtype (printed, not gated)
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        sdpa(*leaves).backward(do.transpose(1, 2))
        pipeline["sdpa_vs_f32"] = grad_errors(
            [x.grad.transpose(1, 2) for x in leaves], exact)
        del chain, f32, o32, lse32, exact, want, leaves
        if not lse_ok:
            raise AssertionError(
                f"flash_attention {variant}: the forward's log-sum-exp is "
                f"{lse_err} from the plain forward's (limit {LSE_TOL} + "
                f"{LSE_TOL} of its magnitude)")
        if not (o_err[0] <= tols[dt][0] and o_err[1] <= tols[dt][1]):
            raise AssertionError(
                f"flash_attention {variant}: the forward's o is {o_err} from "
                f"the plain forward's (limits {tols[dt]})")
        if not identical or unwindowed_equal is False:
            raise AssertionError(
                f"flash_attention_bwd {variant}: relaunch bit-identical "
                f"{identical}, equal to the unwindowed launch "
                f"{unwindowed_equal}")
        if not (err <= tols[dt][0] and rel <= tols[dt][1]):
            raise AssertionError(
                f"flash_attention_bwd {variant}: max err over max(1, max "
                f"|grad|) {err} (limit {tols[dt][0]}), max err within a row "
                f"over its max {rel} (limit {tols[dt][1]})")
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = sdpa(qt, kt, vt)
        dot = do.transpose(1, 2)
        library_ms = time_ms(
            torch, lambda: out.backward(dot, retain_graph=True))
        del qt, kt, vt, out, dot, mask, sdpa
        isz = q.element_size()
        # inputs q, o, dO (B, T, H, hd), k, v (B, S, KV, hd) and the
        # log-sum-exp; outputs dq (B, T, H, hd), dk, dv (B, S, KV, hd)
        bytes_moved = (4 * b * t * h * hd + 4 * b * s * kv * hd) * isz + \
            4 * b * h * t
        pairs = visible_pairs(t, s, causal, off, w)
        flops = 10 * b * h * hd * pairs
        b_ms, b_by = bound(bytes_moved, flops,
                           FLOPS_PER_S[str(dt).split(".")[1]])
        row = {"phase": "kernels", "kernel": "flash_attention_bwd",
               "variant": variant, "shape": {"B": b, "T": t, "S": s, "H": h,
                                             "KV": kv, "hd": hd,
                                             "window": w},
               "dtype": str(dt).split(".")[1], "causal": causal,
               "q_offset": off, "engine": flash_engine(dt),
               "max_abs_err": err, "max_row_rel_err": rel,
               "errors": "max |err| / max(1, max |grad|); max |err| in a row"
               " / max(row max, 1% of max(1, max |grad|)); both backwards "
               "fed the plain forward's o and LSE",
               "tolerance": {"abs": tols[dt][0], "row_rel": tols[dt][1]},
               "fwd_o_errors": o_err, "lse_max_abs_err": lse_err,
               "lse_tolerance": f"{LSE_TOL} + {LSE_TOL} x |plain LSE|",
               "pipeline_errors": pipeline,
               "bit_identical_relaunch": identical,
               "equals_unwindowed_launch": unwindowed_equal,
               "kernel_ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention(enable_gqa=True)"
               " backward alone (out.backward(dO, retain_graph=True))",
               "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_moved,
               "visible_pairs": pairs, "ops": flops,
               "tflops": flops / ms / 1e9,
               "tc_share": tc_share(dt, flops, ms)}
        emit(row)
        if main_row is None:
            main_row = row
        del q, k, v, do, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    return main_row


# ------------------------------------------------------------------ phase 2
# device kernels of each DSJ kernel's wrapper, by a part of their names
PORT_KERNELS = {"range_search": ("probe_kernel",),
                "expand": ("expand_scan", "expand_lanes"),
                "bucket_by_dest": ("bucket_",),
                "unique_compact": ("radix_", "compact_", "tile_sums")}


def profile_run(torch, fn) -> dict:
    """``fn()`` once under torch.profiler: wall time, device busy time (sum
    of kernel self times), the idle share of the wall, the kernels taking
    the most device time, and the device time of each DSJ kernel of the
    port (ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == cuda]
    self_us = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)
    busy = sum(self_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=self_us, reverse=True)[:5]
    port = {name: sum(self_us(e) for e in kernels
                      if any(part in e.key for part in parts)) / 1e3
            for name, parts in PORT_KERNELS.items()}
    host = sorted((e for e in averages
                   if e.device_type != cuda and e.key.startswith("aten::")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "kernel_kinds": len(kernels),
            "top": [{"kernel": e.key[:60], "ms": self_us(e) / 1e3,
                     "calls": e.count} for e in top],
            "host_top": [{"op": e.key, "self_cpu_ms":
                          e.self_cpu_time_total / 1e3, "calls": e.count}
                         for e in host],
            "port_kernels_ms": port}


@contextmanager
def shape_census():
    """Counts the DSJ wrappers' launches by shape (rows: the leading axis,
    W or a batch's B*W) while open: the four wrapper functions are replaced
    by counting ones in their modules (the core modules import them at
    each call) and put back on exit."""
    from repro_torch.kernels.relalg_ops import bucket, compact, expand
    from repro_torch.kernels.semijoin import probe

    counts: Counter = Counter()

    def probe_shape(name):
        return lambda keys, probes, *_: (
            name, ("rows", keys.shape[0]), ("N", keys.shape[1]),
            ("M", probes.shape[1]), ("dtype", str(keys.dtype).split(".")[1]))

    shapes = {
        (probe, "range_search_cuda"): probe_shape("range_search"),
        (probe, "span_search_cuda"): probe_shape("span_search"),
        (expand, "expand_cuda"): lambda lo, hi, out_cap: (
            "expand", ("rows", lo.shape[0]), ("n", lo.shape[1]),
            ("out_cap", out_cap)),
        (bucket, "bucket_by_dest_cuda"):
            lambda values, dest, valid, n_dest, cap_peer, *_: (
                "bucket_by_dest", ("rows", values.shape[0]),
                ("n", values.shape[1]), ("k", values.shape[2]),
                ("n_dest", n_dest), ("cap_peer", cap_peer)),
        (compact, "unique_compact_cuda"): lambda values, valid, out_cap, pad: (
            "unique_compact", ("rows", values.shape[0]),
            ("n", values.shape[1]), ("out_cap", out_cap),
            ("dtype", str(values.dtype).split(".")[1])),
    }
    originals = {key: getattr(*key) for key in shapes}

    def counting(fn, shape):
        def wrapper(*args):
            counts[shape(*args)] += 1
            return fn(*args)
        return wrapper

    for (mod, name), shape in shapes.items():
        setattr(mod, name, counting(originals[(mod, name)], shape))
    try:
        yield counts
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)


@contextmanager
def bucket_mix_census(torch):
    """Records, while open, the mix of every bucket_by_dest call by shape:
    its valid share, whether each worker's valid rows form a prefix (and
    the share of that prefix's span that is valid), and whether each
    worker's valid destinations never decrease.  Reads back to the host at
    every call, so it runs in a pass of its own."""
    from repro_torch.kernels.relalg_ops import bucket

    calls: dict[tuple, list[tuple[float, bool, float, bool]]] = {}
    original = bucket.bucket_by_dest_cuda

    def wrapper(values, dest, valid, n_dest, cap_peer, *rest):
        w, n, k = values.shape
        idx = torch.arange(n, device=valid.device)
        span = (torch.where(valid, idx + 1, 0).amax(dim=1)
                if n else torch.zeros(w, dtype=torch.int64))
        count = valid.sum(dim=1)
        dv = torch.where(valid, dest.to(torch.int64), -1)
        ordered = bool((~valid | (dv == torch.cummax(dv, dim=1).values))
                       .all()) if n else True
        calls.setdefault((n, k, n_dest, cap_peer), []).append(
            (float(count.sum()) / max(w * n, 1),
             bool((count == span).all()),
             float(count.sum()) / max(float(span.sum()), 1.0), ordered))
        return original(values, dest, valid, n_dest, cap_peer, *rest)

    bucket.bucket_by_dest_cuda = wrapper
    try:
        yield calls
    finally:
        bucket.bucket_by_dest_cuda = original


def canon(rel, q):
    """A query's answer as its distinct rows in the query's variable order,
    sorted (``torch.unique`` on the answer's device), on the host: routes
    may bind the same rows in another column order."""
    import torch

    from repro_torch.core.relalg import select_cols

    cols = select_cols(rel.cols, tuple(rel.col_of(v) for v in q.vars))
    return torch.unique(cols[rel.valid], dim=0).cpu()


def phase_lubm(torch) -> dict:
    """Returns what the later LUBM phases reuse: the triples, the engine,
    the queries, the cold pass's answers and stats, the launches of the
    cold and warm passes, and the warm queries/s."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.core.substrate import trace_host_syncs
    from repro_torch.data.synthetic_rdf import Workload, lubm_like
    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    d, triples = lubm_like(*LUBM)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng = AdHashEngine(triples, W, adaptive=False, device="cuda")
    store = eng.store
    live = int(store.counts.sum()) * (2 * 3 * 4 + 2 * 8)
    queries = Workload(d, seed=0).sample(60)
    names = sorted({q.name for q in queries})
    if len(names) != 6:
        raise AssertionError(f"workload covers only {names}")

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    with shape_census() as census:
        t1 = time.perf_counter()
        cold = [eng.query(q) for q in queries]
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t1
    launches = dict(LAUNCHES)
    by_kernel: dict[str, int] = {}
    for (name, *_), count in census.items():
        name = "range_search" if name == "span_search" else name
        by_kernel[name] = by_kernel.get(name, 0) + count
    if any(by_kernel.get(k, 0) != launches[k] for k in RDF_KERNELS):
        raise AssertionError(f"census {by_kernel} != launches {launches}")
    emit({"phase": "lubm-census", "what": "launches by shape, cold pass",
          "shapes": [{"kernel": name, "shape": dict(shape), "launches": c}
                     for (name, *shape), c in census.most_common()]})
    missing = [k for k in RDF_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the LUBM path: "
                             f"{missing}")

    # warm pass: same queries again, one at a time
    lat: dict[str, list[float]] = {k: [] for k in names}
    reset_launches()
    t1 = time.perf_counter()
    for q in queries:
        a = time.perf_counter()
        eng.query(q)
        torch.cuda.synchronize()
        lat[q.name].append(time.perf_counter() - a)
    warm_s = time.perf_counter() - t1
    warm_launches = dict(LAUNCHES)

    # a warm case-(i) chain (q1) makes exactly one counted host sync; the
    # sync-debug mode of the CUDA runtime counts the real ones
    q1 = next(q for q in queries if q.name == "q1")
    eng.query(q1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                trace_host_syncs() as tr:
            warnings.simplefilter("always")
            _, st = eng.query(q1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cuda_syncs = sum("synchronizing" in str(w.message) for w in caught)
    if st.route != "single-local-main" or tr.host_transfers != 1 or \
            cuda_syncs > 1:
        raise AssertionError(f"warm chain: route {st.route!r}, "
                             f"{tr.host_transfers} counted host syncs, "
                             f"{cuda_syncs} seen by the CUDA runtime")

    emit({"phase": "lubm", "triples": int(len(triples)), "workers": W,
          "generate_s": gen_s, "startup_s": eng.startup_time_s,
          "store_bytes_padded": store.nbytes(), "store_bytes_live": live,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "queries": len(queries), "cold_s": cold_s,
          "warm_qps": len(queries) / warm_s,
          "p50_ms": {k: float(np.percentile(v, 50)) * 1e3
                     for k, v in lat.items()},
          "p99_ms": {k: float(np.percentile(v, 99)) * 1e3
                     for k, v in lat.items()},
          "launches": launches,
          "warm_chain_counted_syncs": tr.host_transfers,
          "warm_chain_cuda_syncs": cuda_syncs})

    walls = {"to_lubm_line_s": time.perf_counter() - t0}
    # where the device time goes, per template (profiler on: wall times
    # here include its overhead; the warm numbers above are without it)
    t1 = time.perf_counter()
    for name in names:
        picked = [q for q in queries if q.name == name]
        emit({"phase": "lubm-profile", "template": name,
              "queries": len(picked),
              **profile_run(torch, lambda: [eng.query(q) for q in picked])})
    walls["profiles_s"] = time.perf_counter() - t1
    # the mix each bucket_by_dest shape gets, in a pass of its own
    t1 = time.perf_counter()
    with bucket_mix_census(torch) as mixes:
        for q in queries:
            eng.query(q)
    emit({"phase": "lubm-bucket-mix", "what": "bucket_by_dest mixes by shape",
          "shapes": [
              {"shape": dict(zip(("n", "k", "n_dest", "cap_peer"), shape)),
               "calls": len(rows),
               "median_valid_share": float(np.median([r[0] for r in rows])),
               "valid_prefix_share": float(np.mean([r[1] for r in rows])),
               "median_prefix_density": float(np.median([r[2]
                                                         for r in rows])),
               "dest_sorted_share": float(np.mean([r[3] for r in rows]))}
              for shape, rows in sorted(mixes.items(),
                                        key=lambda kv: -len(kv[1]))]})
    walls["bucket_mix_s"] = time.perf_counter() - t1
    # two queries per template against a CPU engine on the same triples:
    # the CPU side runs in the side process (side_lubm); the card's answers
    # are held against it by check_lubm_parity, once it has them
    emit({"phase": "lubm-walls", **walls})
    parity_card = {i: answer_digest(*cold[i])
                   for i in lubm_parity_picks(queries)}
    ref = [(canon(rel, q), st.comm_cells, st.mode)
           for q, (rel, st) in zip(queries, cold)]
    return {"launches": launches, "warm_launches": warm_launches,
            "warm_qps": len(queries) / warm_s, "eng": eng, "d": d,
            "triples": triples, "queries": queries, "ref": ref,
            "parity_card": parity_card}


#: phase 2's graph, its workload and the queries it holds against a CPU
#: engine (the first two of each template)
LUBM = (100, 20, 30, 12, 2)


def lubm_parity_picks(queries) -> list[int]:
    """The indexes of the first two queries of each template."""
    seen: Counter = Counter()
    picks = []
    for i, q in enumerate(queries):
        if seen[q.name] < 2:
            seen[q.name] += 1
            picks.append(i)
    return picks


def answer_digest(rel, st) -> tuple:
    """A query's answer for the parity check: its distinct rows (as
    ``Relation.to_set`` holds them: in the relation's column order) as
    their count and the SHA-256 of the sorted int64 rows, then
    comm_cells, mode, route and n_retries."""
    import hashlib

    rows = np.unique(rel.to_numpy().astype(np.int64), axis=0)
    return (len(rows), hashlib.sha256(rows.tobytes()).hexdigest(),
            st.comm_cells, st.mode, st.route, st.n_retries)


def side_lubm(torch) -> dict:
    """Phase 2's CPU side (the side process): a device="cpu" engine on the
    same LUBM-100 triples answers the picked queries (``answer_digest``:
    rows, comm_cells, mode, route and retries)."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import Workload, lubm_like

    d, triples = lubm_like(*LUBM)
    queries = Workload(d, seed=0).sample(60)
    cpu = AdHashEngine(triples, W, adaptive=False, device="cpu")
    out = {}
    for i in lubm_parity_picks(queries):
        out[i] = answer_digest(*cpu.query(queries[i]))
    return {"answers": out, "names": {i: queries[i].name for i in out}}


def check_lubm_parity(parity_card: dict, side: "SideProcess") -> None:
    """Phase 2's cold answers to the picked queries against the CPU
    engine's (the side process's ``lubm-parity``): rows, comm_cells, mode,
    route and n_retries equal."""
    cs = side.result("lubm-parity")
    checked: Counter = Counter()
    if sorted(cs["answers"]) != sorted(parity_card):
        raise AssertionError(f"lubm-parity: queries {sorted(cs['answers'])} "
                             f"!= {sorted(parity_card)}")
    for i, want in cs["answers"].items():
        got = parity_card[i]
        if got != want:
            raise AssertionError(f"{cs['names'][i]}: gpu {got[2:]} rows "
                                 f"{got[0]} != cpu {want[2:]} rows "
                                 f"{want[0]}")
        checked[cs["names"][i]] += 1
    emit({"phase": "lubm-parity", "checked": dict(checked),
          "equal": ["to_set (count, SHA-256 of the sorted rows)",
                    "comm_cells", "mode", "route", "n_retries"],
          "cpu_side_s": side.seconds["lubm-parity"]})


# ------------------------------------------------------- phases 2b to 2d
def emit_census(phase: str, what: str, census: Counter) -> None:
    emit({"phase": phase, "what": what,
          "shapes": [{"kernel": name, "shape": dict(shape), "launches": c}
                     for (name, *shape), c in census.most_common()]})


def check_answers(tag: str, queries, results, ref) -> None:
    """Each answer, comm_cells and mode against phase 2's cold pass (held
    there against a CPU engine): answers always, the stats where
    ``ref`` gives them."""
    import torch

    for i, (q, (rel, st)) in enumerate(zip(queries, results)):
        want, cells, mode = ref[i]
        got = canon(rel, q)
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: query {i} ({q.name}) has "
                                 f"{len(got)} rows, phase 2 {len(want)}")
        if cells is not None and (st.comm_cells, st.mode) != (cells, mode):
            raise AssertionError(f"{tag}: query {i} ({q.name}) "
                                 f"{(st.comm_cells, st.mode)} != phase 2 "
                                 f"{(cells, mode)}")


def phase_lubm_batch(torch, lubm: dict) -> None:
    """The 60 LUBM-100 queries through ``query_batch`` on phase 2's
    non-adaptive engine, cold and warm: answers, comm_cells and mode equal
    to phase 2's cold sequential pass; launches per kernel against phase
    2's warm sequential pass; the census of the folded launch shapes."""
    from repro_torch.core.batcher import WorkloadBatcher, quantize_batch
    from repro_torch.kernels import LAUNCHES, reset_launches

    eng, queries = lubm["eng"], lubm["queries"]
    # the buckets query_batch files these queries into (no IRD runs on a
    # non-adaptive engine, so no bucket is popped early)
    batcher = WorkloadBatcher()
    for i, q in enumerate(queries):
        plan = eng.planner.plan(q)
        batcher.add(i, q, plan.ordering, plan.join_vars,
                    max(eng.capacity, plan.capacity_hint()))
    buckets = [{"templates": sorted({queries[t].name for t in b.tags}),
                "B": len(b), "B_pad": quantize_batch(len(b))}
               for b in batcher.buckets()]
    dispatches0 = eng.report.n_batch_dispatches
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    with shape_census() as census:
        t0 = time.perf_counter()
        res = eng.query_batch(queries)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    cold_launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_answers("lubm-batch cold", queries, res, lubm["ref"])
    missing = [k for k in RDF_KERNELS if cold_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by query_batch: "
                             f"{missing}")
    del res
    reset_launches()
    t0 = time.perf_counter()
    res = eng.query_batch(queries)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = dict(LAUNCHES)
    dispatches = eng.report.n_batch_dispatches - dispatches0
    check_answers("lubm-batch warm", queries, res, lubm["ref"])
    del res
    emit_census("lubm-batch-census", "launches by shape, cold batch pass",
                census)
    # where the device time goes, per template: each template's queries as
    # one query_batch call, i.e. its bucket (profiler on, as lubm-profile)
    for name in sorted({q.name for q in queries}):
        picked = [q for q in queries if q.name == name]
        emit({"phase": "lubm-batch-profile", "template": name,
              "queries": len(picked),
              **profile_run(torch, lambda: eng.query_batch(picked))})
    emit({"phase": "lubm-batch", "queries": len(queries),
          "buckets": buckets,
          "n_batch_dispatches": dispatches,  # the cold and warm passes
          "cold_s": cold_s, "warm_s": warm_s,
          "warm_qps": len(queries) / warm_s,
          "sequential_warm_qps": lubm["warm_qps"],
          "launches_cold": cold_launches,
          "launches_warm": warm_launches,
          "sequential_launches_warm": lubm["warm_launches"],
          "max_memory_allocated": peak,
          "max_memory_above_phase2": peak - base,
          "equal_to_phase2": ["answers", "comm_cells", "mode"]})


def time_deferred(ird, method: str) -> list[float]:
    """Accumulates the host seconds of an IRD's deferred ``method``, from
    the enqueue to the end of its barrier (``finalize``), into the returned
    one-element list."""
    spent = [0.0]
    enqueue = getattr(ird, method)

    def timed(arg):
        t0 = time.perf_counter()
        pending = enqueue(arg)
        spent[0] += time.perf_counter() - t0
        barrier = pending.finalize

        def finalize():
            t1 = time.perf_counter()
            out = barrier()
            spent[0] += time.perf_counter() - t1
            return out

        pending.finalize = finalize
        return pending

    setattr(ird, method, timed)
    return spent


REPORT_FIELDS = ("n_queries", "n_parallel", "n_parallel_replica",
                 "n_distributed", "comm_cells", "ird_comm_cells",
                 "ird_triples", "n_redistributions", "n_evictions")


def phase_lubm_adaptive(torch, lubm: dict) -> dict:
    """Two adaptive engines (frequency threshold 3, as the JAX package's
    query benchmark sets it), one answering the 60 queries through
    ``query``, one through ``query_batch``, each twice (the second pass is
    the adapted one): equal to each other query by query and in their
    reports and pattern indexes, every answer equal to phase 2's.  Then an
    engine with half the first one's largest per-worker replica count as
    its budget must evict, with unchanged answers.  Returns what the query
    engine's two passes gave (per query, report, history, fingerprint): the
    mesh twin of phase 2k is held to it."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.kernels import LAUNCHES, reset_launches

    triples, queries = lubm["triples"], lubm["queries"]
    answers = [(a, None, None) for a, _, _ in lubm["ref"]]
    make = lambda **kw: AdHashEngine(triples, W, frequency_threshold=3,
                                     device="cuda", **kw)
    seq, bat = make(), make()
    runs = {"query": (seq, lambda: [seq.query(q) for q in queries]),
            "query_batch": (bat, lambda: bat.query_batch(queries))}
    ird_s = {name: time_deferred(eng.ird, "redistribute_deferred")
             for name, (eng, _) in runs.items()}
    results: dict[str, list] = {}  # (comm_cells, mode, vars) per query
    reset_launches()
    for name, (eng, run) in runs.items():
        for pass_ in ("first", "adapted"):
            before = {f: getattr(eng.report, f) for f in REPORT_FIELDS}
            ird0 = ird_s[name][0]
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check_answers(f"lubm-adaptive {name} {pass_}", queries, res,
                          answers)
            results.setdefault(name, []).extend(
                (st.comm_cells, st.mode, [v.name for v in rel.vars])
                for rel, st in res)
            emit({"phase": "lubm-adaptive-pass", "entry": name,
                  "pass": pass_, "queries": len(queries),
                  "qps": len(queries) / dt, "wall_s": dt,
                  "comm_cells": sum(st.comm_cells for _, st in res),
                  "modes": dict(Counter(st.mode for _, st in res)),
                  "report_delta": {f: getattr(eng.report, f) - before[f]
                                   for f in REPORT_FIELDS},
                  "ird_s": ird_s[name][0] - ird0,
                  "replication_ratio": eng.replication_ratio(),
                  "load_balance": eng.load_balance(),
                  "replica_modules": len(eng.replicas.modules),
                  "replica_bytes": eng.replicas.nbytes()})
    launches = dict(LAUNCHES)
    missing = [k for k in RDF_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the adaptive "
                             f"engines: {missing}")

    # the sequential and the batched engine drove one state machine
    for i, (a, b) in enumerate(zip(results["query"], results["query_batch"])):
        if a != b:
            raise AssertionError(f"query {i} ({queries[i % len(queries)].name}"
                                 f"): query() {a} != query_batch() {b}")
    for f in REPORT_FIELDS:
        if getattr(seq.report, f) != getattr(bat.report, f):
            raise AssertionError(f"report {f}: {getattr(seq.report, f)} != "
                                 f"{getattr(bat.report, f)}")
    if [h[:2] for h in seq.report.history] != \
            [h[:2] for h in bat.report.history]:
        raise AssertionError("report history differs")
    if seq.pattern_index.fingerprint() != bat.pattern_index.fingerprint():
        raise AssertionError("pattern index fingerprints differ")
    if seq.report.n_redistributions == 0:
        raise AssertionError("no redistribution at threshold 3")
    # what phase 2k's mesh twin is held to: the two passes through query()
    twin = {"results": results["query"],
            "report": {f: getattr(seq.report, f) for f in REPORT_FIELDS},
            "history": [h[:2] for h in seq.report.history],
            "fingerprint": seq.pattern_index.fingerprint()}

    # where the time goes once adapted (profiler on: a third pass each)
    for name, (eng, run) in runs.items():
        emit({"phase": "lubm-adaptive-profile", "entry": name,
              "pass": "third (adapted)", **profile_run(torch, run)})
    most = int(seq.replicas.per_worker_triples().max())
    emit({"phase": "lubm-adaptive", "queries": len(queries),
          "frequency_threshold": 3, "launches": launches,
          "n_redistributions": seq.report.n_redistributions,
          "fingerprint_edges": seq.pattern_index.n_edges(),
          "max_replica_triples_per_worker": most,
          "equal": ["answers (vs phase 2)", "comm_cells", "mode", "vars",
                    *REPORT_FIELDS, "history[:2]", "fingerprint"]})
    del seq, bat, runs
    gc.collect()
    torch.cuda.empty_cache()

    # a budget of half that count: LRU eviction, unchanged answers
    budget = most // 2
    eng = make(replication_budget=budget)
    t0 = time.perf_counter()
    check_answers("lubm-adaptive budget", queries,
                  [eng.query(q) for q in queries], answers)
    torch.cuda.synchronize()
    if eng.report.n_evictions == 0:
        raise AssertionError(f"budget {budget}: no eviction")
    emit({"phase": "lubm-adaptive-budget", "replication_budget": budget,
          "wall_s": time.perf_counter() - t0,
          "n_evictions": eng.report.n_evictions,
          "n_redistributions": eng.report.n_redistributions,
          "n_parallel_replica": eng.report.n_parallel_replica,
          "max_replica_triples_per_worker":
              int(eng.replicas.per_worker_triples().max()),
          "replication_ratio": eng.replication_ratio()})
    return twin


def phase_card_parity(torch, phase: str, triples, queries, w: int,
                      **kw) -> None:
    """An engine on the card against the CPU port at a small size, through
    ``query`` and through ``query_batch``: answers, stats, the report's
    adaptivity counters, the placement and pattern-index fingerprints, the
    heat map's state, the main store's and every replica store's five
    tensors, bit for bit."""
    from repro_torch.core.engine import AdHashEngine

    out = {}
    for entry in ("query", "query_batch"):
        gpu, cpu = (AdHashEngine(triples, w, device=dev, **kw)
                    for dev in ("cuda", "cpu"))
        if entry == "query":
            g_res = [gpu.query(q) for q in queries]
            c_res = [cpu.query(q) for q in queries]
        else:
            g_res, c_res = gpu.query_batch(queries), cpu.query_batch(queries)
        for i, ((gr, gs), (cr, cs)) in enumerate(zip(g_res, c_res)):
            got = (gr.to_set(), gs.comm_cells, gs.mode, gs.route,
                   gs.n_retries)
            want = (cr.to_set(), cs.comm_cells, cs.mode, cs.route,
                    cs.n_retries)
            if got != want:
                raise AssertionError(f"{phase} {entry} query {i}: "
                                     f"gpu {got[1:]} != cpu {want[1:]}")
        counters = ("n_redistributions", "n_parallel_replica",
                    "n_rebalances", "rebalance_comm_cells",
                    "n_batch_dispatches")
        for what, a, b in (
                *((f, getattr(gpu.report, f), getattr(cpu.report, f))
                  for f in counters),
                ("placement", gpu.placement.fingerprint(),
                 cpu.placement.fingerprint()),
                ("pattern index", gpu.pattern_index.fingerprint(),
                 cpu.pattern_index.fingerprint()),
                ("heat map", gpu.heatmap.to_state(), cpu.heatmap.to_state()),
                ("replica ids", sorted(gpu.replicas.modules),
                 sorted(cpu.replicas.modules))):
            if a != b:
                raise AssertionError(f"{phase} {entry}: {what} {a} != {b}")
        stores = [("main", gpu.store, cpu.store)] + [
            (sid, gpu.replicas.modules[sid], st)
            for sid, st in cpu.replicas.modules.items()]
        for sid, g_st, c_st in stores:
            for a, b in zip(g_st.leaves(), c_st.leaves()):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{phase} {entry}: store {sid} "
                                         f"differs")
        if gpu.report.n_redistributions == 0:
            raise AssertionError(f"{phase} {entry}: no IRD")
        if kw.get("placement") == "directory" and \
                gpu.report.n_rebalances == 0:
            raise AssertionError(f"{phase} {entry}: no rebalance")
        out[entry] = {f: getattr(gpu.report, f) for f in counters}
        out[entry]["replica_modules"] = len(gpu.replicas.modules)
        out[entry]["splits"] = len(getattr(gpu.placement, "entries", ()))
    emit({"phase": phase, "triples": int(len(triples)), "workers": w,
          "queries": len(queries), "engine": kw, **out,
          "equal": ["to_set", "comm_cells", "mode", "route", "n_retries",
                    *counters, "placement fingerprint",
                    "pattern-index fingerprint", "heatmap.to_state",
                    "main and replica stores (5 tensors each)"]})


# ------------------------------------------------------- phases 2e to 2g
def star_answer(triples: np.ndarray, q) -> np.ndarray:
    """A (s, p, ?o) star's objects by a numpy scan of the triples."""
    pat = q.patterns[0]
    hit = (triples[:, 0] == pat.s.id) & (triples[:, 1] == pat.p.id)
    return np.sort(triples[hit, 2])


def phase_skew(torch, skew_in: dict) -> dict:
    """The skew configuration at full width on the card: a hash and a
    directory engine over the same 6.96 M triples, two passes of ``query``
    (the first triggers the directory engine's rebalance) and one of
    ``query_batch`` each.  Returns the directory engine and its query log
    for the recovery phase."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import zipf_workload
    from repro_torch.kernels import LAUNCHES, reset_launches

    triples = skew_in["triples"]
    queries = zipf_workload(48, **SKEW_WORKLOAD)
    out: dict[str, dict] = {}
    engines = {}
    answers: dict[str, list] = {}
    log: list = []
    for placement in ("hash", "directory"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = AdHashEngine(triples, W, placement=placement, device="cuda",
                           **SKEW_ENGINE)
        lb0 = eng.load_balance()
        row = {"time_to_online_s": eng.startup_time_s,
               "max_over_mean_before": lb0["max"] / lb0["mean"]}
        rebalance_s = time_deferred(eng.ird, "rebalance_deferred")
        # the main path: counts set to 0 just before, read just after
        reset_launches()
        with shape_census() as census:
            for pass_ in ("first", "warm"):
                t0 = time.perf_counter()
                res = []
                for q in queries:
                    res.append(eng.query(q))
                    if placement == "directory":
                        log.append(q)
                torch.cuda.synchronize()
                row[f"{pass_}_pass_s"] = time.perf_counter() - t0
                row[f"n_rebalances_after_{pass_}"] = eng.report.n_rebalances
                answers.setdefault(placement, []).append(
                    [canon(rel, q) for q, (rel, _) in zip(queries, res)])
                del res
            t0 = time.perf_counter()
            res = eng.query_batch(queries)
            torch.cuda.synchronize()
            row["query_batch_s"] = time.perf_counter() - t0
            if placement == "directory":
                log.extend(queries)
            answers[placement].append(
                [canon(rel, q) for q, (rel, _) in zip(queries, res)])
            del res
        launches = dict(LAUNCHES)
        need = ("range_search", "expand") + (
            ("bucket_by_dest",) if placement == "directory" else ())
        missing = [k for k in need if launches[k] == 0]
        if missing:
            raise AssertionError(f"skew {placement}: kernels never launched "
                                 f"{missing}")
        emit_census("skew-census", f"{placement} engine: two query passes "
                    f"and one query_batch", census)
        row.update({
            "rebalance_s": rebalance_s[0],
            "warm_qps_query": len(queries) / row["warm_pass_s"],
            "warm_qps_query_batch": len(queries) / row["query_batch_s"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "store_bytes_padded": eng.store.nbytes(),
            "launches": launches, "census": census,
            "n_rebalances": eng.report.n_rebalances,
            "rebalance_comm_cells": eng.report.rebalance_comm_cells,
            "load_balance": eng.load_balance()})
        row["max_over_mean_after"] = (row["load_balance"]["max"]
                                      / row["load_balance"]["mean"])
        if placement == "directory":
            log.extend(queries + queries)  # the profiled passes below
        emit({"phase": "skew-profile", "placement": placement,
              "what": "one warm query pass",
              **profile_run(torch, lambda: [eng.query(q) for q in queries])})
        emit({"phase": "skew-profile", "placement": placement,
              "what": "one warm query_batch",
              **profile_run(torch, lambda: eng.query_batch(queries))})
        engines[placement] = eng
        out[placement] = row
        if placement == "hash":
            del engines["hash"], eng
            gc.collect()
            torch.cuda.empty_cache()

    # both engines, both entry points, both passes: the same answers
    for placement, passes in answers.items():
        for k, got in enumerate(passes):
            for i, (a, b) in enumerate(zip(got, answers["hash"][0])):
                if not torch.equal(a, b):
                    raise AssertionError(f"skew: {placement} pass {k} query "
                                         f"{i} differs from hash pass 0")
    for q, got in list(zip(queries, answers["directory"][0]))[:4]:
        want = star_answer(triples, q)
        if not np.array_equal(got[:, 0].numpy().astype(np.int64), want):
            raise AssertionError(f"skew: star ({q.patterns[0].s.id}, "
                                 f"{q.patterns[0].p.id}) {len(got)} rows != "
                                 f"numpy scan {len(want)}")
    eng = engines["directory"]
    h, d = out["hash"], out["directory"]
    if h["n_rebalances"] != 0 or d["n_rebalances"] == 0:
        raise AssertionError(f"skew: rebalances hash {h['n_rebalances']} "
                             f"directory {d['n_rebalances']}")
    if d["n_rebalances_after_first"] != d["n_rebalances"]:
        raise AssertionError("skew: rebalances did not settle in the first "
                             "pass")
    if d["max_over_mean_after"] > 0.5 * h["max_over_mean_after"]:
        raise AssertionError(f"skew: max/mean {d['max_over_mean_after']} is "
                             f"not half of hash's {h['max_over_mean_after']}")
    counts = eng.store.counts.cpu().numpy()
    if not np.array_equal(counts, np.bincount(
            eng.placement.place_triples_np(triples), minlength=W)):
        raise AssertionError("skew: directory store counts != placement")
    # phase 1's rebalance row is this run's first rebalance
    first_cells = 3 * skew_in["moved_rows"]
    shape = ("bucket_by_dest", ("rows", W),
             ("n", skew_in["vals"].shape[1]), ("k", 3), ("n_dest", W),
             ("cap_peer", skew_in["cap_peer"]))
    entries = sorted(eng.placement.entries)
    if d["census"][shape] != 1 or not set(skew_in["splits"]) <= \
            set(entries) or (d["n_rebalances"] == 1 and (
                entries != sorted(skew_in["splits"]) or
                d["rebalance_comm_cells"] != first_cells or
                not np.array_equal(counts, skew_in["counts_after"]))):
        raise AssertionError(f"skew: rebalance {entries}, census "
                             f"{d['census'][shape]}, cells "
                             f"{d['rebalance_comm_cells']} != phase 1's "
                             f"{skew_in['splits']}, {first_cells}")
    for row in out.values():
        del row["census"]
    emit({"phase": "skew", "triples": int(len(triples)), "workers": W,
          "queries": len(queries), "source": "benchmarks/bench_balance.py:"
          "_skew_engines, n_triples 800,000 -> 8,000,000",
          "splits": {str(s): list(v) for s, v in
                     sorted(eng.placement.entries.items())},
          "hash": h, "directory": d,
          "checked_vs_numpy": 4,
          "equal": ["answers: both engines, query and query_batch",
                    "directory counts == place_triples_np census",
                    "phase 1's rebalance row: splits, shape, cells"]})
    return {"eng": eng, "log": log, "triples": triples}


def phase_lubm_directory(torch, lubm: dict) -> None:
    """Phase 2's 60 LUBM-100 queries on a directory-placement engine (the
    skew detector on, IRD off), a cold and a warm pass: every answer equal
    to phase 2's, no split on this balanced data, and comm_cells and mode
    per template beside phase 2's."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.kernels import LAUNCHES, reset_launches

    triples, queries, ref = lubm["triples"], lubm["queries"], lubm["ref"]
    torch.cuda.reset_peak_memory_stats()
    eng = AdHashEngine(triples, W, placement="directory",
                       frequency_threshold=10**9, device="cuda")
    reset_launches()
    with shape_census() as census:
        t0 = time.perf_counter()
        cold = [eng.query(q) for q in queries]
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    missing = [k for k in RDF_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"lubm-directory: kernels never launched "
                             f"{missing}")
    answers = [(a, None, None) for a, _, _ in ref]
    check_answers("lubm-directory cold", queries, cold, answers)
    t0 = time.perf_counter()
    warm = [eng.query(q) for q in queries]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check_answers("lubm-directory warm", queries, warm, answers)
    if eng.report.n_rebalances or eng.placement.entries:
        raise AssertionError("lubm-directory: a split fired on LUBM")
    per_template = {}
    for name in sorted({q.name for q in queries}):
        idx = [i for i, q in enumerate(queries) if q.name == name]
        per_template[name] = {
            "comm_cells": sum(cold[i][1].comm_cells for i in idx),
            "comm_cells_phase2": sum(ref[i][1] for i in idx),
            "modes": dict(Counter(cold[i][1].mode for i in idx)),
            "modes_phase2": dict(Counter(ref[i][2] for i in idx))}
    emit_census("lubm-directory-census", "launches by shape, cold pass",
                census)
    fanout = ("bucket_by_dest", ("rows", W), ("n", 8 << 20), ("k", 1),
              ("n_dest", W), ("cap_peer", 1 << 20))
    emit({"phase": "lubm-directory", "queries": len(queries),
          "startup_s": eng.startup_time_s, "cold_s": cold_s,
          "warm_s": warm_s, "warm_qps": len(queries) / warm_s,
          "warm_qps_phase2": lubm["warm_qps"], "launches": launches,
          "phase1_directory_row_launches": census.get(fanout, 0),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "per_template": per_template,
          "equal_to_phase2": ["answers (cold and warm)"]})


# ------------------------------------------------------- phases 2h to 2j
NO_BROWNOUT = dict(brownout_enter=(9.0, 10.0), brownout_exit=(8.0, 9.0))
# Zipf popularity over five LUBM templates (benchmarks/bench_serving.py:38)
SERVE_MIX = {"q1": 1.0, "q2": 1 / 2, "q7": 1 / 3, "q9": 1 / 4, "q12": 1 / 5}
FLUSHES = ("full", "deadline", "pressure", "drain", "overlap")


@contextmanager
def count_builds():
    """Counts the kernel library's builds while open; fails if the loaded
    library changed."""
    from repro_torch.kernels import build

    lib, original, calls = build.library(), build.build, [0]

    def counting(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    build.build = counting
    try:
        yield calls
    finally:
        build.build = original
    if build.library() is not lib:
        raise AssertionError("the kernel library was loaded again")


def serve_stream(eng, queries, rate: float, slo: float, seed: int,
                 service_s: float | None = None, **cfg):
    """``queries`` through a new ServeLoop (batch target 4) on a virtual
    clock, open-loop at ``rate`` a second: modelled at ``service_s``
    seconds a dispatch, or measured (wall seconds, the card synchronized)
    when it is None.  Fails on an unexecutable member or a ledger that does
    not balance.  Returns the loop, the arrivals and the completions."""
    from repro_torch.runtime.fault_injection import VirtualClock
    from repro_torch.serving import (ServeConfig, ServeLoop,
                                     open_loop_arrivals, replay_open_loop)

    loop = ServeLoop(eng, ServeConfig(slo_s=slo, batch_target=4, **cfg),
                     clock=VirtualClock(),
                     service_model=(None if service_s is None
                                    else lambda n: service_s))
    arrivals = open_loop_arrivals(queries, rate_qps=rate, seed=seed)
    done, rejected = replay_open_loop(loop, arrivals)
    r = loop.report
    if r.unexecutable:
        raise AssertionError(f"{r.unexecutable} unexecutable members")
    if (r.answered + r.shed + r.rejected != len(queries)
            or len(rejected) != r.rejected or loop.in_flight()):
        raise AssertionError(f"the served ledger does not balance: {r}")
    return loop, arrivals, done


def served(done) -> dict:
    from repro_torch.serving import ServedResult

    return {c.rid: c for c in done if isinstance(c, ServedResult)}


def make_truth(triples, device: str):
    """A query's canonical answer from a non-adaptive engine on
    ``device`` that serves nothing, one ``query`` per distinct query."""
    from repro_torch.core.engine import AdHashEngine

    eng = AdHashEngine(triples, W, adaptive=False, device=device)
    cache: dict[str, object] = {}

    def truth(q):
        key = json.dumps(q.to_json(), sort_keys=True)
        if key not in cache:
            cache[key] = canon(eng.query(q)[0], q)
        return cache[key]

    return truth


def serve_leg(torch, phase: str, leg: str, eng, queries, truth, seen: set,
              **stream) -> tuple:
    """One served stream with the launch counts set to 0 just before and
    read just after, its launch shapes against ``seen`` (updated), its peak
    memory, and every answer against ``truth``.  Each kernel the leg's
    routes run must have launched: probe and ``expand`` on every route,
    all four DSJ kernels once a staged (distributed) query was answered.
    Emits the leg's row; returns the loop, arrivals, completions, row and
    the launch shapes new to ``seen``."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.reset_peak_memory_stats()
    engine_s = eng.report.wall_time_s
    reset_launches()
    with shape_census() as census:
        t0 = time.perf_counter()
        loop, arrivals, done = serve_stream(eng, queries, **stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in RDF_KERNELS}
    answered = served(done)
    modes = Counter(c.stats.mode for c in answered.values())
    staged = any(c.stats.n_dsj for c in answered.values())
    missing = [k for k in (RDF_KERNELS if staged else RDF_KERNELS[:2])
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"{phase} {leg}: {missing} never launched "
                             f"(modes {dict(modes)})")
    new = [dict(shape, kernel=name) for name, *shape in census
           if (name, *shape) not in seen]
    seen.update(census)
    r = loop.report
    row = {"phase": phase, "leg": leg, "requests": len(queries),
           "wall_s": wall, "makespan_s": loop.clock.now(),
           # host seconds of the engine's executions (no sync), summed
           "engine_execute_s": eng.report.wall_time_s - engine_s,
           "answered": r.answered, "shed": r.shed, "rejected": r.rejected,
           "late": r.late, "shed_rate": r.shed_rate,
           "p50_ms": r.p50_s * 1e3, "p99_ms": r.p99_s * 1e3,
           "flush": {f: getattr(r, f"flush_{f}") for f in FLUSHES},
           "adaptivity_deferrals": r.adaptivity_deferrals,
           "brownout_events": len(r.brownout_events), "modes": dict(modes),
           "n_redistributions": eng.report.n_redistributions,
           "launches": launches, "new_launch_shapes": len(new),
           "held_result_bytes": sum(c.relation.cols.nbytes
                                    + c.relation.valid.nbytes
                                    for c in answered.values()),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    for rid, c in answered.items():
        q = queries[rid]
        if not torch.equal(canon(c.relation, q), truth(q)):
            raise AssertionError(f"{phase} {leg}: request {rid} ({q.name}) "
                                 f"differs from the engine that did not "
                                 f"serve")
    emit(row)
    return loop, arrivals, done, row, new


def ledger(loop, done) -> tuple:
    """Everything a served stream says, as plain values: the report's
    fields and each completion in order (answers as row sets)."""
    import dataclasses

    def key(c):
        if type(c).__name__ != "ServedResult":
            return dataclasses.astuple(c)
        return (c.rid, c.finished_s, c.latency_s, c.late,
                c.relation.to_set(), c.stats.mode, c.stats.route,
                c.stats.comm_cells, c.stats.n_retries)

    return dataclasses.asdict(loop.report), [key(c) for c in done]


def phase_serve_parity(torch) -> None:
    """The serving front-end at W = 8 on lubm_like(2, 2, 2, 2), modelled
    service: a stream under saturation equals ``query_batch`` of its query
    log on a twin engine (answers, mode, comm_cells, PI fingerprint) and
    the same stream on a CPU engine (the whole ledger, bit for bit); two
    more identical streams, the last with no kernel build and no new launch
    shape; then a 2x overload on a fresh engine keeps the admitted p99
    under the SLO, sheds, and answers as the CPU port does."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import Workload, lubm_like

    d, triples = lubm_like(2, 2, 2, 2)
    kw = dict(frequency_threshold=2, capacity=256)
    cfg = dict(queue_bound=16, bucket_window=16)
    wl = Workload(d, seed=21)
    qs = wl.sample(6) * 4
    stream = dict(rate=150.0, slo=2.0, seed=21, service_s=0.01, **cfg,
                  **NO_BROWNOUT)
    truth = make_truth(triples, "cpu")
    eng = AdHashEngine(triples, W, device="cuda", **kw)
    seen: set = set()
    with count_builds() as builds:
        loop, arrivals, done, _, _ = serve_leg(
            torch, "serve-parity", "parity", eng, qs, truth, seen, **stream)
        if len(served(done)) != len(qs):
            raise AssertionError("serve-parity: a request under saturation "
                                 "was not answered")
        twin = AdHashEngine(triples, W, device="cuda", **kw)
        offline = twin.query_batch(loop.query_log)
        order = sorted(arrivals, key=lambda r: r.arrival_s)
        answered = served(done)
        for req, (rel, st) in zip(order, offline):
            c = answered[req.rid]
            if (c.relation.to_set(), c.stats.mode, c.stats.comm_cells) != \
                    (rel.to_set(), st.mode, st.comm_cells):
                raise AssertionError(f"serve-parity: request {req.rid} "
                                     f"differs from query_batch")
        if eng.pattern_index.fingerprint() != twin.pattern_index.fingerprint():
            raise AssertionError("serve-parity: PI fingerprint differs from "
                                 "query_batch's")
        cpu = AdHashEngine(triples, W, device="cpu", **kw)
        c_loop, _, c_done = serve_stream(cpu, qs, **stream)
        if ledger(loop, done) != ledger(c_loop, c_done):
            raise AssertionError("serve-parity: the card's served ledger "
                                 "differs from the CPU engine's")
        del loop, done, answered, twin, offline, cpu, c_loop, c_done
        for leg in ("warm 2", "warm 3"):
            new = serve_leg(torch, "serve-parity", leg, eng, qs, truth,
                            seen, **stream)[4]
        if new or builds[0]:
            raise AssertionError(f"serve-parity: warm stream 3 added "
                                 f"{builds[0]} builds and launch shapes "
                                 f"{new}")
    eng2 = AdHashEngine(triples, W, device="cuda", **kw)
    over = serve_leg(
        torch, "serve-parity", "overload", eng2, wl.sample(120), truth, seen,
        rate=400.0, slo=0.2, seed=21, service_s=0.02, **cfg)[3]
    if not (over["p99_ms"] <= 200.0 + 1e-6 and over["shed"] > 0
            and over["answered"] > 0):
        raise AssertionError(f"serve-parity overload: {over}")
    emit({"phase": "serve-parity", "workers": W, "triples": int(len(triples)),
          "builds": builds[0],
          "equal": ["parity stream vs query_batch: answers, mode, "
                    "comm_cells, PI fingerprint",
                    "card vs CPU engine: report fields, latencies, "
                    "completions in order with answers, mode, route, "
                    "comm_cells, n_retries",
                    "every answer vs a CPU engine that did not serve"]})


def phase_serve(torch, lubm: dict) -> None:
    """The reference bench's serving legs (benchmarks/bench_serving.py)
    at LUBM-100 and W = 8: two warm closed-burst streams of 200 requests,
    the measured saturation stream (and one more under the profiler), a
    measured latency stream at half that rate, and a modelled 2x overload
    on a fresh engine; every answer held to an engine that did not serve."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import Workload

    triples = lubm["triples"]
    wl = Workload(lubm["d"], mix=SERVE_MIX, seed=13)
    truth = make_truth(triples, "cuda")
    qs_sat = wl.sample(200)
    burst = dict(rate=1e9, slo=1e6, seed=13, queue_bound=len(qs_sat) + 1,
                 bucket_window=64, **NO_BROWNOUT)
    eng = AdHashEngine(triples, W, frequency_threshold=2, device="cuda")
    seen: set = set()
    summary: dict = {"startup_s": eng.startup_time_s}
    with count_builds() as builds:
        for leg in ("warm 1", "warm 2"):
            serve_leg(torch, "serve", leg, eng, qs_sat, truth, seen, **burst)
        warm_builds = builds[0]
        row, new_sat = serve_leg(torch, "serve", "saturation", eng, qs_sat,
                                 truth, seen, **burst)[3:]
        if row["answered"] != len(qs_sat):
            raise AssertionError(f"serve saturation: {row}")
        sat = len(qs_sat) / row["makespan_s"]
        emit({"phase": "serve-profile", "leg": "saturation (one more "
              "stream, profiler on)",
              **profile_run(torch, lambda: serve_stream(eng, qs_sat,
                                                        **burst))})
        slo = max(0.05, 40.0 / sat)
        lat, new_lat = serve_leg(
            torch, "serve", "latency", eng, wl.sample(120), truth, seen,
            rate=0.5 * sat, slo=slo, seed=13, queue_bound=64,
            bucket_window=32, **NO_BROWNOUT)[3:]
        new = new_sat + new_lat
        if new or builds[0] != warm_builds:
            raise AssertionError(f"serve: after the warm streams "
                                 f"{builds[0] - warm_builds} builds and "
                                 f"new launch shapes {new}")
        summary.update(saturation_qps=sat, latency_rate_qps=0.5 * sat,
                       latency_slo_s=slo, p50_ms=lat["p50_ms"],
                       p99_ms=lat["p99_ms"], latency_answered=lat["answered"],
                       latency_shed=lat["shed"], latency_late=lat["late"],
                       builds_after_warm=builds[0] - warm_builds,
                       new_launch_shapes_after_warm=new)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng = AdHashEngine(triples, W, frequency_threshold=2, device="cuda")
    over = serve_leg(
        torch, "serve", "overload", eng, wl.sample(150), truth, seen,
        rate=400.0, slo=0.2, seed=13, service_s=0.02, queue_bound=16,
        bucket_window=16)[3]
    if not (over["p99_ms"] <= 200.0 + 1e-6 and over["shed"] > 0):
        raise AssertionError(f"serve overload: {over}")
    summary.update(shed_frac=over["shed_rate"],
                   overload_answered=over["answered"],
                   overload_shed=over["shed"],
                   overload_rejected=over["rejected"],
                   overload_p99_ms=over["p99_ms"])
    emit({"phase": "serve", "triples": int(len(triples)), "workers": W,
          "mix": SERVE_MIX, **summary})


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_recovery(torch, skew: dict) -> None:
    """Master recovery of the skew phase's directory engine, in a temporary
    directory: save its state and a full adaptivity snapshot, recover at
    the same W and hold the recovered master bit for bit to the original,
    crash a second snapshot before it is published, and time recovery
    beside a cold bootstrap plus a replay of the whole log."""
    import tempfile

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.runtime.fault_injection import (CheckpointCrash,
                                                     crash_before_publish)
    from repro_torch.runtime.fault_tolerance import (recover_master,
                                                     replay_query_log)

    eng, log, triples = skew["eng"], skew["log"], skew["triples"]

    def state(e) -> tuple:
        reps = tuple((sid, tuple(t.cpu() for t in st.leaves()))
                     for sid, st in sorted(e.replicas.modules.items()))
        return (e.placement.fingerprint(), e.pattern_index.fingerprint(),
                e.heatmap.to_state(), e.replicas.next_id_n, reps)

    def same(a: tuple, b: tuple) -> bool:
        return a[:4] == b[:4] and len(a[4]) == len(b[4]) and all(
            sa == sb and all(torch.equal(x, y) for x, y in zip(ta, tb))
            for (sa, ta), (sb, tb) in zip(a[4], b[4]))

    row: dict = {"log_queries": len(log)}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        mgr = CheckpointManager(root)
        t0 = time.perf_counter()
        mgr.save_engine_state(eng, log)
        row["save_engine_state_s"] = time.perf_counter() - t0
        row["save_engine_state_bytes"] = dir_bytes(root)
        t0 = time.perf_counter()
        mgr.save_adaptivity(eng, step=1)
        row["save_adaptivity_s"] = time.perf_counter() - t0
        row["save_adaptivity_bytes"] = dir_bytes(root) - \
            row["save_engine_state_bytes"]
        saved = state(eng)

        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec = recover_master(CheckpointManager(root), triples, W,
                             device="cuda", **SKEW_ENGINE)
        torch.cuda.synchronize()
        row["recover_master_s"] = time.perf_counter() - t0
        if not same(state(rec), saved):
            raise AssertionError("recovery: recovered master differs")
        q = log[0]
        (r1, s1), (r2, s2) = eng.query(q), rec.query(q)
        if (s1.route, s1.mode) != (s2.route, s2.mode) or \
                not torch.equal(canon(r1, q), canon(r2, q)):
            raise AssertionError(f"recovery: next query {(s2.route, s2.mode)}"
                                 f" != {(s1.route, s1.mode)}")
        row["next_query_route"] = s2.route

        # a crash between writing the second snapshot and publishing it
        try:
            with crash_before_publish():
                mgr.save_adaptivity(eng, step=2)
            raise AssertionError("recovery: the injected crash did not fire")
        except CheckpointCrash:
            pass
        m = mgr.load_adaptivity()
        offset = mgr.restore_adaptivity(rec)
        if m["step"] != 1 or offset != len(log) or not same(state(rec),
                                                             saved):
            raise AssertionError(f"recovery: after the crash step "
                                 f"{m['step']}, offset {offset}")
        del rec, eng, skew["eng"]
        gc.collect()
        torch.cuda.empty_cache()

        # the paper's recovery path (§3.1): bootstrap, then replay the log
        t0 = time.perf_counter()
        cold = AdHashEngine(triples, W, placement="directory",
                            device="cuda", **SKEW_ENGINE)
        row["cold_bootstrap_s"] = time.perf_counter() - t0
        replay_query_log(cold, log)
        torch.cuda.synchronize()
        row["cold_bootstrap_and_replay_s"] = time.perf_counter() - t0
        row["replay_rebalances"] = cold.report.n_rebalances
        if cold.placement.fingerprint() != saved[0] or \
                cold.pattern_index.fingerprint() != saved[1]:
            raise AssertionError("recovery: replayed master differs")
    emit({"phase": "recovery", **row,
          "equal": ["placement fingerprint", "pattern-index fingerprint",
                    "heat map", "replica tensors", "next_id_n",
                    "next query route and answer",
                    "snapshot 1 after a crash mid-save of snapshot 2",
                    "replayed placement and pattern index"]})


# ------------------------------------------------------------------ phase 3
# --------------------------------------------------- phases 2k and 2l: mesh
def collective_expectation(st) -> tuple[int, int]:
    """(all_to_all, all_gather) a query's stage bodies must issue on a mesh:
    two all_to_all (values, mask) at each hash exchange and each reply
    route, two all_gather at each broadcast, none on the shard-local and
    local-main routes."""
    n_hash = sum(p.startswith("dsj[hash]") for p in st.plan)
    n_bcast = sum(p.startswith("dsj[bcast]") for p in st.plan)
    return 2 * (2 * n_hash + n_bcast), 2 * n_bcast


def phase_mesh(torch, mesh_in: dict) -> None:
    """Phase 2k: the multi-device substrate at full width on one card.  A
    world-size-1 NCCL group (a TCPStore on a free localhost port), a
    DistributedSubstrate over it, phase 2's LUBM-100 triples ingested
    through the host-sharded path at W = 8: the 60 queries cold and warm,
    then ``query_batch`` cold and warm, each answer, comm_cells and mode
    equal to phase 2's; per template the collectives its stage bodies
    issued; NCCL time per collective kind; an adaptive twin (threshold 3,
    two passes) equal to lubm-adaptive's query engine."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.core.substrate import (DistributedSubstrate,
                                            trace_collectives,
                                            trace_host_syncs)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import multihost

    triples, queries, ref = (mesh_in[k] for k in ("triples", "queries",
                                                    "ref"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    multihost.ensure_initialized(device="cuda")
    try:
        sub = DistributedSubstrate(device="cuda")
        if (sub.backend, sub.n_devices) != ("nccl", 1):
            raise AssertionError(f"mesh: {sub.backend} x {sub.n_devices}")
        t0 = time.perf_counter()
        chunks = np.array_split(triples, 8)
        eng = AdHashEngine.ingest_stream(chunks, W, substrate=sub,
                                         adaptive=False, device="cuda")
        startup = time.perf_counter() - t0
        if eng.store.mesh is not sub or eng.store.n_workers != W:
            raise AssertionError("mesh: the store is not the mesh's")

        # the main path: counts set to 0 just before, read just after
        reset_launches()
        per_template: dict[str, Counter] = {}
        with shape_census() as seen:
            t0 = time.perf_counter()
            cold = []
            for q in queries:
                with trace_collectives() as tc:
                    rel, st = eng.query(q)
                cold.append((rel, st))
                a2a, ag = collective_expectation(st)
                got = (tc.count("all_to_all", "stage"),
                       tc.count("all_gather", "stage"))
                if got != (a2a, ag) or (st.route.endswith("local-main")
                                        and tc.count(where="stage")):
                    raise AssertionError(
                        f"mesh {q.name}: stage collectives {dict(tc.counts)}"
                        f" for plan {st.plan}, route {st.route!r}")
                per_template.setdefault(q.name, Counter()).update(
                    {f"{k}:{w}": n for (k, w), n in tc.counts.items()})
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        check_answers("mesh cold", queries, cold, ref)
        del cold
        missing = [k for k in RDF_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the mesh: "
                                 f"{missing}")

        with count_builds() as builds, shape_census() as warm_seen:
            t0 = time.perf_counter()
            for q in queries:  # as phase 2's warm pass: a sync a query
                eng.query(q)
                torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            # the same pass with every collective bracketed by CUDA events
            with trace_collectives(timed=True) as tc:
                warm = [eng.query(q) for q in queries]
            nccl_ms = tc.ms()
            nccl_calls = {k: tc.count(k) for k in nccl_ms}
            check_answers("mesh warm", queries, warm, ref)
            del warm
            # query_batch: a cold pass warms its folded shapes
            with shape_census() as batch_seen:
                bat = eng.query_batch(queries)
                torch.cuda.synchronize()
            check_answers("mesh batch", queries, bat, ref)
            del bat
            t0 = time.perf_counter()
            bat = eng.query_batch(queries)
            torch.cuda.synchronize()
            batch_warm_s = time.perf_counter() - t0
            check_answers("mesh batch warm", queries, bat, ref)
            del bat
        new_shapes = sorted(map(str, set(warm_seen) - set(seen)
                                - set(batch_seen)))
        if builds[0] or new_shapes:
            raise AssertionError(f"mesh: after warm-up {builds[0]} builds, "
                                 f"new launch shapes {new_shapes}")

        # a warm case-(i) chain: one counted host sync, its one collective
        # the all_reduce at that sync
        q1 = next(q for q in queries if q.name == "q1")
        eng.query(q1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    trace_host_syncs() as tr, trace_collectives() as tc:
                warnings.simplefilter("always")
                _, st = eng.query(q1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cuda_syncs = sum("synchronizing" in str(w.message) for w in caught)
        if (st.route != "distributed-local-main" or tr.host_transfers != 1
                or dict(tc.counts) != {("all_reduce", "host"): 1}
                or cuda_syncs > 1):
            raise AssertionError(
                f"mesh warm chain: route {st.route!r}, {tr.host_transfers} "
                f"host syncs, collectives {dict(tc.counts)}, {cuda_syncs} "
                f"seen by the CUDA runtime")
        del eng
        gc.collect()
        torch.cuda.empty_cache()

        # the adaptive twin of lubm-adaptive's query engine
        twin_ref = mesh_in["twin"]
        t0 = time.perf_counter()
        twin = AdHashEngine.ingest_stream(chunks, W, substrate=sub,
                                          frequency_threshold=3,
                                          device="cuda")
        answers = [(a, None, None) for a, _, _ in ref]
        got: list = []
        for _ in range(2):
            res = [twin.query(q) for q in queries]
            check_answers("mesh adaptive", queries, res, answers)
            got.extend((st.comm_cells, st.mode, [v.name for v in rel.vars])
                       for rel, st in res)
            del res
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        report = {f: getattr(twin.report, f) for f in REPORT_FIELDS}
        if (got != twin_ref["results"] or report != twin_ref["report"]
                or [h[:2] for h in twin.report.history] != twin_ref["history"]
                or twin.pattern_index.fingerprint() != twin_ref["fingerprint"]):
            bad = next((i for i, (a, b) in enumerate(
                zip(got, twin_ref["results"])) if a != b), None)
            raise AssertionError(f"mesh adaptive twin differs from "
                                 f"lubm-adaptive (first query {bad}; report "
                                 f"{report} vs {twin_ref['report']})")
        emit({"phase": "mesh", "triples": int(len(triples)), "workers": W,
              "ranks": sub.n_devices, "backend": sub.backend,
              "device": str(sub.device), "startup_s": startup,
              "queries": len(queries), "cold_s": cold_s,
              "warm_qps": len(queries) / warm_s,
              "single_substrate_warm_qps": mesh_in["warm_qps"],
              "query_batch_warm_qps": len(queries) / batch_warm_s,
              "launches": launches,
              "collectives_per_template": {k: dict(v) for k, v in
                                           sorted(per_template.items())},
              "nccl_ms_warm_pass": nccl_ms,
              "nccl_calls_warm_pass": nccl_calls,
              "nccl_ms_per_call": {k: nccl_ms[k] / nccl_calls[k]
                                   for k in nccl_ms},
              "warm_chain_host_syncs": tr.host_transfers,
              "warm_chain_cuda_syncs": cuda_syncs,
              "builds_after_warm": builds[0],
              "new_launch_shapes_after_warm": new_shapes,
              "adaptive_twin_s": twin_s,
              "adaptive_twin_redistributions": twin.report.n_redistributions,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "equal": ["answers, comm_cells, mode (cold, warm, batch) vs "
                        "phase 2", "adaptive twin: comm_cells, mode, vars, "
                        "report, history, fingerprint vs lubm-adaptive"]})
        del twin
    finally:
        multihost.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


# phase 2l's two ranks share the one card.  NCCL refuses two ranks on one
# GPU, so they run gloo on it, which takes CUDA tensors for every
# collective the substrate issues (first chip run of the mesh phases).
MESH2_DEVICE, MESH2_BACKEND = "cuda", "gloo"

MESH2_CHILD = r'''
import json
import sys
import tempfile
from collections import Counter

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.placement import DirectoryPlacement
from repro_torch.core.substrate import DistributedSubstrate, trace_collectives
from repro_torch.data.synthetic_rdf import Workload, lubm_like
from repro_torch.kernels import LAUNCHES, reset_launches

assert "jax" not in sys.modules
device = sys.argv[1]
sub = DistributedSubstrate(device=device)
assert sub.n_processes == 2
d, triples = lubm_like(2, 2, 2, 2)
chunks = [c for c in np.array_split(triples, 7) if len(c)]
kw = dict(adaptive=True, frequency_threshold=2, capacity=256, device=device)
out = {"rank": sub.rank, "backend": sub.backend, "device": str(sub.device)}


def answers(results):
    return [(sorted(rel.to_set()), st.comm_cells, st.mode,
             st.route.split("-", 1)[-1], st.n_retries)
            for rel, st in results]


def same(a, b, what):
    if a != b:
        raise AssertionError(f"rank {sub.rank}: {what} differs")


# the host-sharded ingest: this rank's 4 workers, the single store's
dist = AdHashEngine.ingest_stream(iter(chunks), 8, substrate=sub, **kw)
single = AdHashEngine(triples, 8, **kw)
assert dist.store.spo_ps.shape[0] == 4
for a, b in zip(dist.store.host_leaves(), single.store.leaves()):
    assert np.array_equal(a, b.cpu().numpy()), "ingested store"
out["store"] = "equal"
# the adaptive lifecycle, one query at a time.  The launch counts are the
# distributed engines' alone: set to 0 just before each of their passes,
# read just after, before the single-substrate twin runs
launches = Counter()
qs = Workload(d, seed=7).sample(4) * 2
reset_launches()
with trace_collectives() as tc:
    got = answers([dist.query(q) for q in qs])
launches.update(LAUNCHES)
same(got, answers(single.query(q) for q in qs), "sequential answers")
same(dist.pattern_index.fingerprint(), single.pattern_index.fingerprint(),
     "fingerprint")
same(dist.report.ird_comm_cells, single.report.ird_comm_cells, "IRD cells")
assert any(m == "parallel-replica" for _, _, m, _, _ in got)
out["sequential_collectives"] = {f"{k}:{w}": n
                                 for (k, w), n in tc.counts.items()}
# a query_batch pass on a fresh pair
dist2 = AdHashEngine.ingest_stream(iter(chunks), 8, substrate=sub, **kw)
single2 = AdHashEngine(triples, 8, **kw)
reset_launches()
got = answers(dist2.query_batch(qs))
launches.update(LAUNCHES)
same([a[:3] for a in got],
     [a[:3] for a in answers(single2.query(q) for q in qs)], "batch answers")
same(dist2.pattern_index.fingerprint(), single2.pattern_index.fingerprint(),
     "batch fingerprint")
out["launches"] = dict(launches)
# a checkpoint round trip with replicas sharded over both ranks
cm = CheckpointManager(tempfile.mkdtemp())
cm.save_engine_state(dist, qs)
cm.save_adaptivity(dist, step=1)
fresh = AdHashEngine.ingest_stream(iter(chunks), 8, substrate=sub, **kw)
assert cm.restore_adaptivity(fresh) == len(qs)
same(fresh.pattern_index.fingerprint(), dist.pattern_index.fingerprint(),
     "restored fingerprint")
assert fresh.replicas.modules
for sid, st in dist.replicas.modules.items():
    assert fresh.replicas.modules[sid].spo_ps.shape[0] == 4
    for a, b in zip(fresh.replicas.modules[sid].host_leaves(),
                    st.host_leaves()):
        assert np.array_equal(a, b), f"replica {sid}"
out["replica_modules_restored"] = len(fresh.replicas.modules)
# a placement snapshot restored at W' = 16
plc = DirectoryPlacement(8)
assert plc.add_splits([int(np.bincount(triples[:, 0]).argmax())])
cm.save_placement(plc)
same(cm.load_placement(8).fingerprint(), plc.fingerprint(), "placement")
wider = cm.load_placement(16)
assert wider.w == 16 and set(wider.entries) == set(plc.entries)
sub.barrier("mesh2:end")
print("MESH2-OK " + json.dumps(out), flush=True)
'''


def phase_mesh2(torch) -> None:
    """Phase 2l: two ranks x 4 workers (W = 8) launched by
    ``repro_torch.launch.multihost.launch_localhost``, each held to a
    single-substrate engine on the same device in one step each: the
    ingested store, the adaptive lifecycle with its fingerprint, a
    ``query_batch`` pass, a checkpoint round trip with replicas over both
    ranks, a placement snapshot restored at W' = 16 (the reference's
    two-process test, lubm_like(2, 2, 2, 2), threshold 2, capacity 256)."""
    import tempfile

    from repro_torch.launch.multihost import launch_localhost

    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp) / "mesh2_child.py"
        script.write_text(MESH2_CHILD)
        t0 = time.perf_counter()
        results = launch_localhost(2, [str(script), MESH2_DEVICE],
                                   device=MESH2_DEVICE, backend=MESH2_BACKEND,
                                   timeout=240.0)
        wall = time.perf_counter() - t0
    for r in results:
        if not r.ok:
            raise AssertionError(f"mesh2: rank {r.process_id} rc "
                                 f"{r.returncode}\n{r.stderr[-3000:]}")
    # every rank's own line: its launches and collectives
    outs = []
    for r in results:
        line = next((ln for ln in r.stdout.splitlines()
                     if ln.startswith("MESH2-OK ")), None)
        if line is None:
            raise AssertionError(f"mesh2: no result line from rank "
                                 f"{r.process_id}\n{r.stdout}")
        out = json.loads(line[len("MESH2-OK "):])
        if out["rank"] != r.process_id:
            raise AssertionError(f"mesh2: rank {out['rank']} printed for "
                                 f"process {r.process_id}")
        if MESH2_DEVICE == "cuda":
            missing = [k for k in RDF_KERNELS if out["launches"][k] == 0]
            if missing:
                raise AssertionError(f"mesh2: rank {out['rank']}'s mesh "
                                     f"engines never launched {missing}")
        outs.append(out)
    emit({"phase": "mesh2", "ranks": 2, "workers": W,
          "device": MESH2_DEVICE, "backend": MESH2_BACKEND,
          "wall_s": wall, "per_rank": outs,
          "equal": ["store", "sequential answers/stats/fingerprint",
                    "query_batch answers/fingerprint",
                    "checkpoint round trip (replicas over both ranks)",
                    "placement snapshot at W' = 16"]})


#: the Zipf stream's triples (32 M until the run's time had to be won back:
#: 51.8 s of the run at 32 M on an H100 host, most of it host-side
#: generation and ingest)
SCALE_TRIPLES = 16_000_000


def phase_scale(torch) -> None:
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import generate_stream, zipf_workload
    from repro_torch.kernels import LAUNCHES, reset_launches

    n_triples, chunk = SCALE_TRIPLES, 1 << 20
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = AdHashEngine.ingest_stream(generate_stream(n_triples, chunk), W,
                                     adaptive=False, device="cuda")
    online_s = time.perf_counter() - t0
    queries = zipf_workload(32)
    reset_launches()
    results = []
    for i, q in enumerate(queries):
        rel, st = eng.query(q)
        torch.cuda.synchronize()
        if i == 0:
            first_s = time.perf_counter() - t0
        results.append(rel)
    total_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    live = int(eng.store.counts.sum()) * (2 * 3 * 4 + 2 * 8)

    # numpy scan of the same stream: the multiset of o per (s, p) filter
    check = [(q.patterns[0].s.id, q.patterns[0].p.id, rel)
             for q, rel in list(zip(queries, results))[:4]]
    found = {(s, p): [] for s, p, _ in check}
    for ch in generate_stream(n_triples, chunk):
        for s, p, _ in check:
            found[(s, p)].append(ch[(ch[:, 0] == s) & (ch[:, 1] == p), 2])
    for s, p, rel in check:
        want = np.sort(np.concatenate(found[(s, p)]))
        got = np.sort(rel.to_numpy()[:, 0].astype(np.int64))
        if not np.array_equal(got, want):
            raise AssertionError(f"zipf ({s}, {p}): {len(got)} rows != numpy "
                                 f"scan {len(want)} rows")
    emit({"phase": "scale", "triples": n_triples, "workers": W,
          "time_to_online_s": online_s, "time_to_first_answer_s": first_s,
          "queries": len(queries), "all_queries_s": total_s,
          "store_bytes_live": live, "store_bytes_padded": eng.store.nbytes(),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "checked_vs_numpy": len(check),
          "rows_checked": [int(len(r.to_numpy())) for _, _, r in check]})


# ------------------------------------------------------------------ phase 4
def phase_lm(torch) -> dict[str, int]:
    """llama3-8b prefill and decode through the port's entry points."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import AdaptiveShardingController
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import transformer as TT
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("llama3-8b")
    walls: dict[str, float] = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0, dtype=torch.bfloat16)
    batch = make_batch(cfg, *PREFILL, 0, device="cuda")
    torch.cuda.synchronize()
    walls["init_s"] = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    losses, prefill_s = [], []
    for i in range(4):  # one cold call, three warm
        before = LAUNCHES["flash_attention"]
        a = time.perf_counter()
        with torch.inference_mode():  # prefill: no autograd, no remat
            loss = float(model.loss(params, batch))
        prefill_s.append(time.perf_counter() - a)
        losses.append(loss)
        if LAUNCHES["flash_attention"] - before != cfg.n_layers:
            raise AssertionError(
                f"prefill call {i}: {LAUNCHES['flash_attention'] - before} "
                f"flash_attention launches, expected {cfg.n_layers}")
        if not math.isfinite(loss):
            raise AssertionError(f"prefill call {i}: loss {loss}")
    walls["prefill_s"] = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    warm_s = float(np.mean(prefill_s[1:]))
    tokens = int(batch["tokens"].numel())

    # where a warm prefill's device time goes (profiler on: its wall
    # includes the profiler's overhead; the warm times above are without)
    before = LAUNCHES["flash_attention"]
    emit({"phase": "lm-profile", "what": "prefill B=%d T=%d" % PREFILL,
          **profile_run(torch, torch.inference_mode()(
              lambda: model.loss(params, batch)))})
    if LAUNCHES["flash_attention"] - before != cfg.n_layers:
        raise AssertionError("profiled prefill: flash_attention launches "
                             f"{LAUNCHES['flash_attention'] - before}")

    t0 = time.perf_counter()
    ctrl = AdaptiveShardingController(cfg.vocab_size, budget=8192)
    times, plan = serve_loop(model, params, batch_size=8, max_len=128,
                             steps=16, n_batches=4, controller=ctrl)
    walls["decode_s"] = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if launches["flash_attention"] == 0:
        raise AssertionError("flash_attention never launched on the LM path")
    decode_tps = 8 * 16 / float(np.mean(times[1:]))  # serve.py's formula
    emit({"phase": "lm-profile", "what": "decode batch 8 x 16 steps",
          **profile_run(torch, lambda: serve_loop(
              model, params, batch_size=8, max_len=128, steps=16,
              n_batches=1))})
    emit({"phase": "lm", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "weights_dtype": "bfloat16", "weight_bytes": weight_bytes,
          "prefill": {"batch": int(batch["tokens"].shape[0]),
                      "seq": int(batch["tokens"].shape[1]), "tokens": tokens,
                      "cold_s": prefill_s[0], "warm_s": prefill_s[1:],
                      "warm_tokens_per_s": tokens / warm_s,
                      "loss": losses, "flash_launches_per_call": cfg.n_layers,
                      "max_memory_allocated": prefill_peak},
          "decode": {"batch": 8, "max_len": 128, "steps": 16, "batches": 4,
                     "batch_s": times, "steady_tok_per_s": decode_tps,
                     "n_hot": plan.n_hot, "coverage": plan.coverage},
          "launches": launches, "max_memory_allocated":
          torch.cuda.max_memory_allocated()})
    del batch
    t0 = time.perf_counter()
    phase_lm_int8(torch, cfg, params)  # phase 4's weights, no second init
    walls["int8_s"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_lm_int8_parity(torch, cfg)
    walls["int8_parity_s"] = time.perf_counter() - t0

    # two layers at full width, B=1, T=520: the card against the CPU port
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    m2 = build_model(cfg2, device="cuda")
    p2 = m2.init(1, dtype=torch.bfloat16)
    b2 = make_batch(cfg2, 1, 520, 1, device="cuda")
    with torch.inference_mode():
        h_gpu = TT.lm_forward(p2, b2["tokens"], cfg2).float().cpu()
        loss_gpu = float(m2.loss(p2, b2))
    p2 = p2.to("cpu")
    b2 = {k: v.cpu() for k, v in b2.items()}
    cpu = build_model(cfg2, device="cpu")
    a = time.perf_counter()
    with torch.inference_mode():
        h_cpu = TT.lm_forward(p2, b2["tokens"], cfg2).float()
        loss_cpu = float(cpu.loss(p2, b2))
    cpu_s = time.perf_counter() - a
    tol = 2e-2  # bf16 matmuls accumulate in another order on each device
    atol = tol * max(1.0, float(h_cpu.abs().max()))
    loss_tol = 1e-3  # relative; the loss averages 520 tokens' errors
    err = float((h_gpu - h_cpu).abs().max())
    ok = bool(torch.allclose(h_gpu, h_cpu, atol=atol, rtol=tol)) and \
        abs(loss_gpu - loss_cpu) <= loss_tol * abs(loss_cpu)
    walls["parity_s"] = time.perf_counter() - t0
    emit({"phase": "lm-parity", "arch": cfg.name, "n_layers": 2,
          "batch": 1, "seq": 520, "hidden_max_abs_err": err,
          "hidden_tolerance": f"atol {atol:.4g} (= {tol} x max|h_cpu|), "
                              f"rtol {tol}",
          "loss_gpu": loss_gpu, "loss_cpu": loss_cpu,
          "loss_tolerance": f"rtol {loss_tol}",
          "cpu_forward_and_loss_s": cpu_s,
          "ok": ok})
    if not ok:
        raise AssertionError(f"llama3-8b 2-layer prefill: card vs CPU port "
                             f"hidden err {err} (atol {atol}), loss "
                             f"{loss_gpu} vs {loss_cpu}")
    emit({"phase": "lm-walls", **walls})
    return launches


# the reference's decode cache modes: float32 cache math (the default),
# bf16 cache math, and the int8 cache with bf16 math (``--int8-kv``)
CACHE_MODES = {"default": {}, "bf16_cache_math": {"bf16_cache_math": True},
               "int8": {"kv_cache_int8": True, "bf16_cache_math": True}}
CACHE_DECODE = (8, 4096, 16, 4)  # batch, max_len, steps, batches


def tree_bytes(tree: dict) -> int:
    """Bytes of a decode cache's tensors."""
    return sum(t.numel() * t.element_size() for t in tree.values())


def phase_lm_int8(torch, cfg, params) -> None:
    """llama3-8b decode (``serve_loop``: batch 8, max_len 4096, 16 steps, 4
    batches) in each cache mode on phase 4's weights: tokens/s, cache
    bytes, peak memory and a profiled 4-step batch's idle share and host
    ops; then the
    reference test's property (``tests/test_optimizations.py::
    test_int8_kv_cache_decode_close_to_bf16``) at full size: 5 steps of
    the int8 mode against the default from the same greedy tokens, logits
    within 5% of the largest, greedy tokens agreeing on half the rows."""
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import RuntimeOptions

    b, max_len, steps, n = CACHE_DECODE
    models = {mode: build_model(cfg, opts=RuntimeOptions(**kw),
                                device="cuda")
              for mode, kw in CACHE_MODES.items()}
    rows = {}
    for mode, model in models.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = model.init_cache(b, max_len)["kv"]
        dtypes = sorted({str(t.dtype) for t in cache.values()})
        nbytes = tree_bytes(cache)
        del cache
        times, _ = serve_loop(model, params, batch_size=b, max_len=max_len,
                              steps=steps, n_batches=n)
        peak = torch.cuda.max_memory_allocated()
        # 4 steps: a 16-step trace takes the profiler ~30 s to fold
        prof = profile_run(torch, lambda: serve_loop(
            model, params, batch_size=b, max_len=max_len, steps=4,
            n_batches=1))
        rows[mode] = {"cache_bytes": nbytes, "cache_dtypes": dtypes,
                      "batch_s": times,
                      "steady_tok_per_s": b * steps / float(np.mean(
                          times[1:])),
                      "max_memory_allocated": peak,
                      "profiled_batch": {"wall_s": prof["wall_s"],
                                         "device_busy_s":
                                             prof["device_busy_s"],
                                         "idle_share": prof["idle_share"],
                                         "top": prof["top"][:3],
                                         "host_top": prof["host_top"]}}
    ratio = rows["int8"]["cache_bytes"] / rows["default"]["cache_bytes"]

    # the reference test's property, at full size
    base, int8 = models["default"], models["int8"]
    c0, c1 = base.init_cache(b, max_len), int8.init_cache(b, max_len)
    tok = torch.zeros((b, 1), dtype=torch.long, device="cuda")
    for pos in range(5):
        l0, c0 = base.decode(params, c0, {"tokens": tok, "pos": pos})
        l1, c1 = int8.decode(params, c1, {"tokens": tok, "pos": pos})
        tok = torch.argmax(l0[:, -1], -1)[:, None]
    l0, l1 = l0.float(), l1.float()
    rel = float((l0 - l1).abs().max() / l0.abs().max())
    agree = float((torch.argmax(l0[:, -1], -1) ==
                   torch.argmax(l1[:, -1], -1)).float().mean())
    del c0, c1, l0, l1
    ok = ratio <= 0.52 and rel < 0.05 and agree >= 0.5
    emit({"phase": "lm-int8", "arch": cfg.name, "batch": b,
          "max_len": max_len, "steps": steps, "batches": n,
          "modes": rows, "int8_over_default_bytes": ratio,
          "int8_vs_default_5_steps": {"rel": rel, "agree": agree,
                                      "limits": "rel < 0.05, agree >= 0.5"},
          "ok": ok})
    if not ok:
        raise AssertionError(f"lm-int8: cache ratio {ratio}, rel {rel}, "
                             f"agreement {agree}")
    del models
    gc.collect()
    torch.cuda.empty_cache()


@contextmanager
def card_payloads(TA, card_kv: dict):
    """Has ``attention._quantize_kv`` return the card's written payload and
    scale (``card_kv``: each cache leaf's (layers, B, KV[, hd]) entries at
    the step's position) layer by layer, K then V, as ``decode_attention``
    calls it, and records what it computes itself, in call order."""
    inner = TA._quantize_kv
    own: list[tuple] = []

    def spy(x):
        layer, which = divmod(len(own), 2)
        own.append(inner(x))
        n = "kv"[which]
        return (card_kv[n][layer][:, None].to(x.device),
                card_kv[n + "_scale"][layer][:, None].to(x.device))

    TA._quantize_kv = spy
    try:
        yield own
    finally:
        TA._quantize_kv = inner


def phase_lm_int8_parity(torch, cfg) -> None:
    """The int8 cache and bf16 cache math, the card against the CPU port.
    (a) ``_quantize_kv`` at decode's full shape (batch 8, 8 KV heads, hd
    128), float32 and bf16 inputs: payload and scales bit for bit (the
    card must not divide through a reciprocal).  (b) llama3-8b with 2
    layers at full width in float32, 8 int8-cache decode steps (batch 2,
    64 slots, seeded tokens), the CPU's cache set to the card's before
    each step so that each step starts equal.  A payload written from K/V
    that differ by rounding may land one step apart (the entries are
    counted, the step must be at most 1); on such a step the CPU's step is
    run again with every layer's written payload and scale the card's
    (``card_payloads``), so that both compute from what the card wrote.
    The step's logits within 1e-4 of their largest magnitude, and each
    layer's written scales within 1e-6 relative of the CPU's, on every
    step (float32 products summed in another order).  (c) bf16 cache
    math's two routes on the same inputs at decode's full shape (batch 8,
    4096 slots, 32 heads over 8 KV heads): the card's ``torch.bmm(
    out_dtype=float32)`` against the CPU's float32 casts, within 1e-2 of
    the largest output (the softmax weights are rounded to bf16 on each
    side)."""
    import copy
    import dataclasses

    from repro_torch.models import attention as TA
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import RuntimeOptions

    b, L, _, _ = CACHE_DECODE
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device="cuda").manual_seed(3)
    quant_equal = {}
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn((b, 1, kv, hd), generator=gen, device="cuda") *
             torch.rand((b, 1, kv, 1), generator=gen, device="cuda") * 10
             ).to(dt)
        qg, sg = TA._quantize_kv(x)
        qc, sc = TA._quantize_kv(x.cpu())
        quant_equal[str(dt)] = bool(torch.equal(qg.cpu(), qc) and
                                    torch.equal(sg.cpu(), sc))

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    opts = RuntimeOptions(**CACHE_MODES["int8"])
    gpu = build_model(cfg2, opts=opts, device="cuda")
    cpu = build_model(cfg2, opts=opts, device="cpu")
    pg = gpu.init(2)
    pc = copy.deepcopy(pg).to("cpu")
    cg = gpu.init_cache(2, 64)
    toks = np.random.default_rng(2).integers(0, cfg2.vocab_size, (8, 2, 1))
    steps = []
    for pos in range(8):
        before = {name: c.cpu() for name, c in cg["kv"].items()}
        cc = {"kv": {name: c.clone() for name, c in before.items()}}
        t = torch.from_numpy(toks[pos])
        lg, cg = gpu.decode(pg, cg, {"tokens": t.cuda(), "pos": pos})
        card_kv = {name: c[:, :, pos].cpu() for name, c in cg["kv"].items()}
        lc, cc = cpu.decode(pc, cc, {"tokens": t, "pos": pos})
        written = {n: card_kv[n].int() - cc["kv"][n][:, :, pos].int()
                   for n in ("k", "v")}
        differ = sum(int((w != 0).sum()) for w in written.values())
        step = max(int(w.abs().max()) for w in written.values())
        ref = {n: cc["kv"][n][:, :, pos] for n in ("k_scale", "v_scale")}
        if differ:
            again = {"kv": {name: c.clone() for name, c in before.items()}}
            with card_payloads(TA, card_kv) as own:
                lc, _ = cpu.decode(pc, again, {"tokens": t, "pos": pos})
            ref = {n: torch.stack([sc[:, 0] for _, sc in own[i::2]])
                   for i, n in enumerate(("k_scale", "v_scale"))}
        scale_err = [max(float(((card_kv[n][layer] - ref[n][layer]).abs() /
                                ref[n][layer].abs()).max()) for n in ref)
                     for layer in range(2)]
        err = float((lg.cpu() - lc).abs().max() / lc.abs().max())
        steps.append({"logits_err_over_max": err,
                      "payloads_differing": differ, "payload_step": step,
                      "cpu_given_card_payloads": bool(differ),
                      "scale_rel_err": scale_err,
                      "ok": bool(step <= 1 and max(scale_err) <= 1e-6 and
                                 err <= 1e-4)})
    del gpu, cpu, pg, pc, cg, cc
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 cache math: the card's route against the CPU's
    q = torch.randn((b, h, hd), generator=gen, device="cuda").bfloat16()
    ck = torch.randn((b, L, kv, hd), generator=gen, device="cuda").bfloat16()
    cv = torch.randn((b, L, kv, hd), generator=gen, device="cuda").bfloat16()
    visible = torch.arange(L, device="cuda") <= L - 100
    og = TA._bf16_cache_attend(q, ck, cv, visible, hd).cpu()
    oc = TA._bf16_cache_attend(q.cpu(), ck.cpu(), cv.cpu(), visible.cpu(),
                               hd)
    bf16_err = float((og - oc).abs().max() / oc.abs().max())
    del q, ck, cv
    ok = (all(quant_equal.values()) and all(r["ok"] for r in steps) and
          bf16_err <= 1e-2)
    emit({"phase": "lm-int8-parity", "arch": cfg.name,
          "quantize_kv_bit_exact": quant_equal, "n_layers": 2,
          "compute_dtype": "float32", "batch": 2, "max_len": 64,
          "decode_steps": steps,
          "bf16_cache_math_card_vs_cpu": {
              "card": "torch.bmm(out_dtype=float32)",
              "cpu": "float32 casts", "err_over_max": bf16_err,
              "shape": [b, L, h, kv, hd]},
          "limits": "quantize bit for bit; payload step <= 1; logits 1e-4 "
                    "of max and scales 1e-6 relative on every step (the "
                    "CPU given the card's payloads on a step where one "
                    "differs); bf16 routes 1e-2 of max",
          "ok": ok})
    if not ok:
        raise AssertionError("lm-int8-parity: the card's int8 decode or bf16 "
                             "cache math disagrees with the CPU port's")


# limits of a float32 train step, card against CPU port: float32 products
# summed in another order on each device
STEP_TOL = {"loss_rel": 1e-5, "grad_rel_l2": 1e-4, "grad_norm_rel": 1e-5,
            "param_abs": 1e-5, "m_over_sqrt_v_eps": 1e-5, "v_rel": 1e-5}


def step_grads(model, p, batch) -> tuple[float, dict]:
    """(loss, {parameter name: gradient}) of one batch, the parameters'
    ``.grad`` left empty."""
    for x in p.parameters():
        x.grad = None
    loss = model.loss(p, batch)
    loss.backward()
    grads = {n: x.grad for n, x in p.named_parameters()}
    for x in p.parameters():
        x.grad = None
    return float(loss.detach()), grads


def cpu_first_step(torch, cfg2, model, p, seq: int) -> dict:
    """The CPU port's part of ``card_vs_cpu_steps``' first step: the loss,
    the gradients and their global norm at ``p`` on ``make_batch(cfg2, 1,
    seq, 0)``."""
    from repro_torch.data.tokens import make_batch
    from repro_torch.optim.adamw import global_norm

    loss, grads = step_grads(model, p, make_batch(cfg2, 1, seq, 0,
                                                  device="cpu"))
    return {"loss": loss, "grads": grads,
            "norm": float(global_norm(grads.values()))}


def optimizer_errors(torch, params_a, opt_a, params_b, opt_b, dev: str
                     ) -> dict:
    """One device's parameters and ``OptState`` (a) against the other's
    (b), a leaf at a time on ``dev``: the parameters' largest absolute
    difference; v (a sum of squares) relative to b's each element, floored
    at 1e-30; m in units of the step it drives, |dm| / (sqrt(v) + eps)
    (an element of m that cancels to near 0 has no relative precision to
    hold)."""
    from repro_torch.optim.adamw import AdamWConfig
    from torch.utils._pytree import tree_leaves

    on = lambda t: t.detach().to(dev)
    eps = AdamWConfig().eps
    err = {"param": 0.0, "m": 0.0, "v": 0.0}
    for a, b in zip(params_a, params_b):
        err["param"] = max(err["param"], float((on(a) - on(b)).abs().max()))
    for ma, mb, va, vb in zip(tree_leaves(opt_a.m), tree_leaves(opt_b.m),
                              tree_leaves(opt_a.v), tree_leaves(opt_b.v)):
        vb = on(vb)
        err["m"] = max(err["m"], float(
            ((on(ma) - on(mb)).abs() / (vb.sqrt() + eps)).max()))
        err["v"] = max(err["v"], float(
            ((on(va) - vb).abs() / vb.abs().clamp_min(1e-30)).max()))
    return err


def card_vs_cpu_steps(torch, cfg2, n_steps: int, seq: int, models=None,
                      first: dict | None = None):
    """``n_steps`` train steps (B=1, T=``seq``) of the float32 config
    ``cfg2`` on the card and on the CPU port, the parts of a step apart,
    from ``models`` (a list of the card's and the CPU's model and their
    parameters, equal weights, which it empties) or, by default, from both
    built at seed 0.
    Each step: the loss and gradients of each device at its own weights
    (the CPU's first step given as ``first``, ``cpu_first_step``'s result,
    where the side process computed it); then ``adamw_update`` on the card
    from its gradients and on the CPU from the same gradients copied to
    the host, so the optimizers' results are held element by element on
    equal inputs (the CPU port's weights stay the CPU optimizer's).  The
    first step's gradients are also compressed on each device.  The CPU's
    tensors are held against the card's on the card, a leaf at a time.
    Returns the line's fields (``ok`` among them, and the host seconds of
    each part) and the card's model, parameters and optimizer state."""
    import copy

    from repro_torch.data.tokens import make_batch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update, global_norm)
    from repro_torch.optim.compression import compress_tree, ef_init
    from torch.utils._pytree import tree_leaves

    if models is None:
        gpu, cpu = build_model(cfg2, device="cuda"), build_model(
            cfg2, device="cpu")
        pg = gpu.init(0)
        pc = copy.deepcopy(pg).to("cpu")
    else:
        gpu, cpu, pg, pc = models
        models.clear()  # the caller's list holds them no longer
    og, oc = adamw_init(pg), adamw_init(pc)
    opt_cfg = AdamWConfig()
    secs = dict.fromkeys(("grads_card", "grads_cpu", "compress", "adamw",
                          "compare"), 0.0)

    def timed(part: str, t0: float) -> float:
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs[part] += now - t0
        return now

    card = lambda t: t.to("cuda", non_blocking=False)
    grad_rel: dict[str, float] = {}
    compress_equal = False
    train_rows = []
    for i in range(n_steps):
        bg = make_batch(cfg2, 1, seq, i, device="cuda")
        bc = {k: v.cpu() for k, v in bg.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, gg = step_grads(gpu, pg, bg)
        t0 = timed("grads_card", t0)
        if i == 0 and first is not None:
            lc, gc_, cpu_norm = first["loss"], first.pop("grads"), \
                first["norm"]
        else:
            lc, gc_ = step_grads(cpu, pc, bc)
            cpu_norm = float(global_norm(gc_.values()))
        t0 = timed("grads_cpu", t0)
        for n, g in gc_.items():
            gd = card(g)
            grad_rel[n] = max(grad_rel.get(n, 0.0), float(
                (gg[n] - gd).norm() / gd.norm().clamp_min(1e-30)))
        del gc_, gd
        host = {n: g.cpu() for n, g in gg.items()}
        t0 = timed("compare", t0)
        if i == 0:  # the same gradients compressed on each device
            qg, sg, _ = compress_tree(gg, ef_init(gg))
            qc, sc, _ = compress_tree(host, ef_init(host))
            compress_equal = all(torch.equal(qg[n], card(qc[n])) and
                                 torch.equal(sg[n], card(sc[n]))
                                 for n in qc)
            del qg, sg, qc, sc
            t0 = timed("compress", t0)
        pg, og, mg = adamw_update(opt_cfg, pg, gg, og)
        pc, oc, mc = adamw_update(opt_cfg, pc, host, oc)
        del gg, host
        timed("adamw", t0)
        train_rows.append({"loss": [lg, lc],
                           "grad_norm": [float(mg["grad_norm"]), cpu_norm],
                           "grad_norm_same_grads": [float(mg["grad_norm"]),
                                                    float(mc["grad_norm"])]})
    t0 = time.perf_counter()
    moment_err = optimizer_errors(torch, pg.parameters(), og,
                                  pc.parameters(), oc, "cuda")
    param_err = moment_err["param"]
    steps_equal = int(og.step) == int(oc.step) == n_steps
    n_elems = sum(x.numel() for x in pc.parameters())
    del pc, oc, cpu
    timed("compare", t0)
    rel = lambda pair: abs(pair[0] - pair[1]) / abs(pair[1])
    tol = STEP_TOL
    ok = (all(rel(r["loss"]) <= tol["loss_rel"] and
              rel(r["grad_norm"]) <= tol["grad_norm_rel"] and
              rel(r["grad_norm_same_grads"]) <= tol["grad_norm_rel"]
              for r in train_rows) and
          max(grad_rel.values()) <= tol["grad_rel_l2"] and
          param_err <= tol["param_abs"] and
          moment_err["m"] <= tol["m_over_sqrt_v_eps"] and
          moment_err["v"] <= tol["v_rel"] and steps_equal and
          compress_equal)

    return ({"steps": train_rows, "grad_rel_l2_max": max(grad_rel.values()),
             "grad_rel_l2_worst_leaf": max(grad_rel, key=grad_rel.get),
             "param_max_abs_err": param_err, "elements": n_elems,
             "m_max_err_over_sqrt_v_eps": moment_err["m"],
             "v_max_rel_err": moment_err["v"],
             "optimizer_steps_equal": steps_equal, "tolerance": tol,
             "compress_q_and_scales_equal": compress_equal,
             "host_s": secs, "ok": ok},
            gpu, pg, og)


# ------------------------------------------------------------ side process
#: the CPU work of the parity phases that runs in the side process, beside
#: the card phases (what moved, for the walls line)
SIDE_JOBS = {
    "moe-parity": "the CPU port's forward, loss, layer-0 moe_ffn, "
                  "plan forward (lm-mesh-parity) and first train step's "
                  "gradients",
    "hybrid-parity": "the CPU port's forward, loss and first train "
                     "step's gradients",
    "lubm-parity": "phase 2's device=\"cpu\" engine on the LUBM-100 triples "
                   "and its answers to two queries of each template",
}


def side_models(torch, cfg2):
    """The CPU model of ``cfg2`` and the card's seed-0 weights (made on
    the card, as the parity phases make theirs) moved to the CPU; the
    card's memory is freed."""
    from repro_torch.models.model_zoo import build_model

    p = build_model(cfg2, device="cuda").init(0).to("cpu")
    torch.cuda.empty_cache()
    return build_model(cfg2, device="cpu"), p


def side_main(out: str, threads: int) -> None:
    """The side process: the card's seed-0 weights of each job's config
    first (its only card work, then the ``card-done`` marker), then each
    of ``SIDE_JOBS``' CPU parts in order, written to ``out/<job>.pt``
    (atomically, with its seconds) as it is done."""
    import os

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch

    os.nice(10)  # the card phases' host threads come first
    torch.set_num_threads(threads)
    cfg2, text_len, train_len = hybrid_parity_cfg()
    moe = side_models(torch, moe_parity_cfg())
    hybrid = side_models(torch, cfg2)
    Path(f"{out}/card-done").touch()
    jobs = {"moe-parity": lambda: side_moe(torch, *moe),
            "hybrid-parity": lambda: side_family(torch, cfg2, *hybrid,
                                                 text_len, train_len),
            "lubm-parity": lambda: side_lubm(torch)}
    for job, run in jobs.items():
        t0 = time.perf_counter()
        res = run()
        res["side_s"] = time.perf_counter() - t0
        torch.save(res, f"{out}/{job}.tmp")
        os.replace(f"{out}/{job}.tmp", f"{out}/{job}.pt")
        del res
        if job == "moe-parity":
            del moe
        elif job == "hybrid-parity":
            del hybrid


#: the least memory the host may keep available (GiB) before the run stops
#: itself rather than exhaust it
MIN_AVAILABLE_GIB = 6.0


def host_memory() -> dict:
    """This process's resident and peak resident GiB and the host's
    available GiB (``/proc``; a field the kernel does not give is None)."""
    kib = {}
    for path in ("/proc/self/status", "/proc/meminfo"):
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:  # not every kernel exposes it
            continue
        for line in lines:
            name, _, rest = line.partition(":")
            if name in ("VmRSS", "VmHWM", "MemAvailable", "MemFree"):
                kib[name] = int(rest.split()[0])
    gib = lambda name: kib[name] / 2**20 if name in kib else None
    return {"rss_gib": gib("VmRSS"), "peak_rss_gib": gib("VmHWM"),
            "available_gib": gib("MemAvailable") or gib("MemFree")}


def tmp_dir_info() -> dict:
    """The temporary directory the run writes its files to (the side
    process's results, the checkpoints): its file system and free GiB."""
    import os
    import tempfile

    tmp = os.path.realpath(tempfile.gettempdir())
    fs, best = None, ""
    with open("/proc/mounts") as f:
        for line in f:
            _, mount, kind = line.split()[:3]
            if tmp.startswith(mount) and len(mount) > len(best):
                fs, best = kind, mount
    st = os.statvfs(tmp)
    return {"dir": tmp, "fs": fs, "free_gib": st.f_bavail * st.f_frsize
            / 2**30}


class MemoryWatch:
    """A thread that reads the host's available memory every half second,
    keeps its least, and stops the run (its children too) with a line of
    its own before the host runs out of it."""

    def __init__(self):
        import threading

        self.least = float("inf")
        self.children: list = []  # processes to stop with the run
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        import os

        while True:
            avail = host_memory()["available_gib"]
            if avail is None:  # nothing to watch
                return
            self.least = min(self.least, avail)
            if avail < MIN_AVAILABLE_GIB:
                print(json.dumps({"phase": "memory-watch", "stopped": True,
                                  **host_memory()}), flush=True)
                print(f"chip_smoke: the host has {avail:.1f} GiB left; "
                      "stopping", file=sys.stderr, flush=True)
                for proc in self.children:
                    proc.kill()
                os._exit(3)
            time.sleep(0.5)


def lap(side: "SideProcess", walls: dict, name: str, t0: float) -> None:
    """At the end of a phase: its seconds since ``t0`` into ``walls`` and
    the host's memory into ``walls["host_memory_gib"]``; this process takes
    its threads back once the side process has ended."""
    side.poll()
    walls[name] = time.perf_counter() - t0
    mem = host_memory()
    walls.setdefault("host_memory_gib", {})[name] = [
        mem["rss_gib"], mem["available_gib"]]


class SideProcess:
    """The side process, spawned at the top of the run with half of the
    host's threads (at a lower priority), while this process keeps the
    other half until it ends (``poll``); ``result(job)`` waits for a job's
    results (raising if the process died without them) and loads them."""

    def __init__(self):
        import multiprocessing
        import os
        import tempfile

        import torch

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_side_")
        self.threads = max(1, (os.cpu_count() or 2) // 2)
        self.main_threads = torch.get_num_threads()
        torch.set_num_threads(max(1, self.main_threads - self.threads))
        self.seconds: dict[str, float] = {}
        self.waited = 0.0  # seconds the card phases waited for results
        self.waited_card = 0.0  # ... for the side's card work to end
        self.proc = multiprocessing.get_context("spawn").Process(
            target=side_main, args=(self.dir, self.threads), daemon=True)
        self.proc.start()

    def poll(self) -> None:
        """This process takes all its threads back once the side process
        has ended."""
        import torch

        if self.main_threads and not self.proc.is_alive():
            torch.set_num_threads(self.main_threads)
            self.main_threads = 0

    def wait_card(self) -> None:
        """Wait until the side process has ended its work on the card (its
        models' weights), so the card phases time their kernels alone."""
        t0 = time.perf_counter()
        while not (Path(self.dir) / "card-done").exists():
            if not self.proc.is_alive():
                raise RuntimeError(f"side process ended (exit code "
                                   f"{self.proc.exitcode}) before its "
                                   "card work")
            time.sleep(0.2)
        self.waited_card = time.perf_counter() - t0

    def result(self, job: str) -> dict:
        import torch

        path = Path(self.dir) / f"{job}.pt"
        t0 = time.perf_counter()
        while not path.exists():
            if not self.proc.is_alive() and not path.exists():
                raise RuntimeError(f"side process ended (exit code "
                                   f"{self.proc.exitcode}) without {job}")
            time.sleep(0.5)
        res = torch.load(path, weights_only=False)
        path.unlink()
        self.seconds[job] = res.pop("side_s")
        self.waited += time.perf_counter() - t0
        self.poll()
        return res

    def close(self) -> None:
        import shutil

        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(30)
        self.poll()
        shutil.rmtree(self.dir, ignore_errors=True)


# ------------------------------------------------------------ phase 5
TRAIN = (1, 4096)  # train_4k's length; its global batch of 256 cut to 1
#: the vocabulary rows of the checkpoint round trips' models (train-parity's
#: 2 layers and train-mesh's 0 layers, each at its config's width): the
#: whole vocabulary's tables and moments (11.2 GB and 7.47 GB) took 47.4 s
#: and 29.0 s through a 9p temporary directory (~0.9 GB/s written, ~0.45
#: GB/s read back, on an H100 host)
CKPT_VOCAB = 16384


def phase_train(torch) -> dict[str, int]:
    """qwen1.5-4b at full width and depth through ``make_train_step``:
    float32 parameters, bf16 compute, remat on; one warm-up step and three
    timed ones on ``make_batch(cfg, 1, 4096, step)``, then a profiled step;
    then a 2-layer full-width model in float32 on the card against the CPU
    port."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from torch.utils._pytree import tree_leaves

    cfg = get_config("qwen1.5-4b")
    walls: dict[str, float] = {}
    gc.collect()
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    if allocated_before > 1 << 30:
        raise AssertionError(f"train: {allocated_before} bytes still "
                             "allocated on the card before the phase")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    opt = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig())
    batches = [make_batch(cfg, *TRAIN, i, device="cuda") for i in range(5)]
    torch.cuda.synchronize()
    walls["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    steps = []
    for i in range(4):  # one warm-up step, three timed
        fwd, bwd = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]
        a = time.perf_counter()
        params, opt, met = step_fn(params, opt, batches[i])
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        steps.append({"step": i, "s": time.perf_counter() - a, "loss": loss,
                      "grad_norm": gnorm,
                      "flash_fwd": LAUNCHES["flash_attention"] - fwd,
                      "flash_bwd": LAUNCHES["flash_attention_bwd"] - bwd})
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"train step {i}: loss {loss}, grad_norm "
                                 f"{gnorm}")
        # remat runs each block's forward twice (forward, recompute)
        if steps[-1]["flash_fwd"] != 2 * cfg.n_layers or \
                steps[-1]["flash_bwd"] != cfg.n_layers:
            raise AssertionError(f"train step {i}: flash launches {steps[-1]}"
                                 f", expected {2 * cfg.n_layers} forward and "
                                 f"{cfg.n_layers} backward")
    walls["steps_s"] = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.mean([r["s"] for r in steps[1:]]))
    tokens = TRAIN[0] * TRAIN[1]
    prof = profile_run(torch, lambda: step_fn(params, opt, batches[4]))
    emit({"phase": "train-profile", "what": "one train step B=%d T=%d" %
          TRAIN, **{k: v for k, v in prof.items() if k != "port_kernels_ms"},
          "busy_share": 1 - prof["idle_share"]})
    emit({"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.dtype,
          "remat": cfg.remat, "params": n_params,
          "param_count_cfg": cfg.param_count(),
          "batch": TRAIN[0], "seq": TRAIN[1],
          "reduced": "train_4k global batch 256 -> 1 (one card)",
          "allocated_before_bytes": allocated_before, "steps": steps,
          "step_s": step_s, "tokens_per_s": tokens / step_s,
          "flash_launches_per_step": {"forward": 2 * cfg.n_layers,
                                      "backward": cfg.n_layers},
          "max_memory_allocated": peak, "launches": launches})
    del params, opt, model, batches, step_fn, met
    gc.collect()
    torch.cuda.empty_cache()

    # two layers at full width in float32, B=1, T=256: card vs CPU port
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    row, gpu, pg, og = card_vs_cpu_steps(torch, cfg2, 2, 256)
    walls["parity_s"] = time.perf_counter() - t0
    # the checkpoint round trip, bit for bit, into fresh state: the same
    # 2-layer full-width model at CKPT_VOCAB rows after two card steps
    t0 = time.perf_counter()
    del pg, og
    gc.collect()
    torch.cuda.empty_cache()
    ck_cfg = dataclasses.replace(cfg2, vocab_size=CKPT_VOCAB)
    gpu = build_model(ck_cfg, device="cuda")
    pg = gpu.init(0)
    og = adamw_init(pg)
    for i in range(2):
        pg, og, _ = make_train_step(gpu, AdamWConfig())(
            pg, og, make_batch(ck_cfg, 1, 256, i, device="cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(pg, og, 2)
        fresh = gpu.init(5)
        fresh_opt = adamw_init(fresh)
        fresh, fresh_opt, step = mgr.restore_latest(fresh, fresh_opt)
        ckpt_bytes = dir_bytes(Path(tmp))
    ckpt_equal = step == 2 and int(fresh_opt.step) == int(og.step) and all(
        np.array_equal(a, b) for a, b in zip(
            tree_leaves(params_to_numpy(pg)),
            tree_leaves(params_to_numpy(fresh))))
    for name in ("m", "v"):
        ckpt_equal = ckpt_equal and all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves(getattr(og, name)),
                tree_leaves(getattr(fresh_opt, name))))
    walls["checkpoint_s"] = time.perf_counter() - t0
    emit({"phase": "train-parity", "arch": cfg.name, "n_layers": 2,
          "compute_dtype": "float32", "batch": 1, "seq": 256, **row,
          "checkpoint_round_trip_bit_exact": ckpt_equal,
          "checkpoint_vocab": CKPT_VOCAB, "checkpoint_bytes": ckpt_bytes})
    if not row["ok"]:
        raise AssertionError("train-parity: the card's train steps disagree "
                             "with the CPU port's (see the line above)")
    if not ckpt_equal:
        raise AssertionError("train-parity: the checkpoint round trip is "
                             "not bit-exact")
    emit({"phase": "train-walls", **walls})
    return launches


# ------------------------------------------------------------ phase 6
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_HOT = 8  # hot experts replicated (the config's expert_replication)
# train depth: float32 parameters, gradients and both moments of all 24
# layers (14.32 B parameters) need 229 GB; 4 layers keep full width
MOE_TRAIN_LAYERS = 4


def load_stats(diag: dict) -> dict:
    """dropped and the slot loads' max, mean and max/mean of one
    ``moe_ffn`` call (loads are per slot, at most its capacity), and the
    routed counts per logical expert before capacity."""
    load = diag["expert_load"].double()
    routed = diag["route_counts"].double()
    return {"dropped": int(diag["dropped"]), "slots": int(load.numel()),
            "load_max": float(load.max()), "load_mean": float(load.mean()),
            "load_max_over_mean": float(load.max() / load.mean()),
            "routed_max_over_mean": float(routed.max() / routed.mean())}


def phase_moe(torch) -> dict[str, int]:
    """qwen2-moe-a2.7b at full width and depth through the port's entry
    points, bf16 weights from seed 0: prefill (``model.loss`` on B=4,
    T=4096 under ``torch.inference_mode()``, one cold call and three warm,
    24 flash_attention launches each), a profiled prefill, decode
    (``serve_loop``: batch 8, max_len 128, 16 steps, 4 batches, with the
    adaptive controller); then layer 0's ``moe_ffn`` on the prefill's own
    hidden states with no plan and with the 8 hottest experts replicated,
    and twice with no plan, bit-identical."""
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import AdaptiveShardingController
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import embedding as emb
    from repro_torch.models.common import rms_norm
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.moe import moe_ffn, slot_map_for_plan

    cfg = get_config(MOE_ARCH)
    walls: dict[str, float] = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0, dtype=torch.bfloat16)
    batch = make_batch(cfg, *PREFILL, 0, device="cuda")
    torch.cuda.synchronize()
    walls["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    losses, prefill_s = [], []
    for i in range(4):  # one cold call, three warm
        before = LAUNCHES["flash_attention"]
        a = time.perf_counter()
        with torch.inference_mode():  # prefill: no autograd, no remat
            loss = float(model.loss(params, batch))
        prefill_s.append(time.perf_counter() - a)
        losses.append(loss)
        if LAUNCHES["flash_attention"] - before != cfg.n_layers:
            raise AssertionError(
                f"moe prefill call {i}: "
                f"{LAUNCHES['flash_attention'] - before} flash_attention "
                f"launches, expected {cfg.n_layers}")
        if not math.isfinite(loss):
            raise AssertionError(f"moe prefill call {i}: loss {loss}")
    walls["prefill_s"] = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    warm_s = float(np.mean(prefill_s[1:]))
    tokens = int(batch["tokens"].numel())

    t0 = time.perf_counter()
    ctrl = AdaptiveShardingController(
        cfg.vocab_size, budget=cfg.adaptive.embedding_hot_budget)
    times, plan = serve_loop(model, params, batch_size=8, max_len=128,
                             steps=16, n_batches=4, controller=ctrl)
    walls["decode_s"] = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if launches["flash_attention"] == 0:
        raise AssertionError("flash_attention never launched on the moe "
                             "path")
    decode_tps = 8 * 16 / float(np.mean(times[1:]))  # serve.py's formula

    # where a warm prefill's and a decode batch's device time goes (the
    # profiler's overhead is in these walls, not in the times above)
    t0 = time.perf_counter()
    prefill_prof = profile_run(torch, torch.inference_mode()(
        lambda: model.loss(params, batch)))
    # 4 steps: the trace of a step holds ~3,000 events
    decode_prof = profile_run(torch, lambda: serve_loop(
        model, params, batch_size=8, max_len=128, steps=4, n_batches=1))
    for what, prof in (("prefill B=%d T=%d" % PREFILL, prefill_prof),
                       ("decode batch 8 x 4 steps", decode_prof)):
        emit({"phase": "moe-profile", "what": what,
              **{k: v for k, v in prof.items() if k != "port_kernels_ms"},
              "busy_share": 1 - prof["idle_share"]})
    walls["profile_s"] = time.perf_counter() - t0

    # layer 0's moe_ffn on the prefill's hidden states: loads without a
    # plan and with the hottest experts replicated; two calls bit-identical
    t0 = time.perf_counter()
    blk = params.blocks[0]
    with torch.inference_mode():
        x = emb.embed(params.embed, batch["tokens"], cfg)
        h = x + blk.attn(rms_norm(x, blk.ln1, cfg.norm_eps))
        z = rms_norm(h, blk.ln2, cfg.norm_eps)
        out0, d0 = moe_ffn(blk.moe, z, cfg)
        again, _ = moe_ffn(blk.moe, z, cfg)
        hot = tuple(int(e) for e in torch.argsort(
            d0["route_counts"].cpu(), descending=True, stable=True)[:MOE_HOT])
        slot_map = slot_map_for_plan(cfg.moe.n_experts, hot)
        out1, d1 = moe_ffn(blk.moe, z, cfg, slot_map)
        ffn_ms = time_ms(torch, lambda: moe_ffn(blk.moe, z, cfg), reps=10)
        ffn_plan_ms = time_ms(torch, lambda: moe_ffn(blk.moe, z, cfg,
                                                     slot_map), reps=10)
    identical = bool(torch.equal(out0, again))
    finite = bool(torch.isfinite(out0).all() and torch.isfinite(out1).all())
    walls["moe_ffn_s"] = time.perf_counter() - t0
    emit({"phase": "moe", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "experts": [cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared,
                      cfg.moe.d_expert], "vocab": cfg.vocab_size,
          "weights_dtype": "bfloat16", "params": n_params,
          "param_count_cfg": cfg.param_count(),
          "active_param_count_cfg": cfg.active_param_count(),
          "weight_bytes": weight_bytes,
          "prefill": {"batch": PREFILL[0], "seq": PREFILL[1],
                      "tokens": tokens, "cold_s": prefill_s[0],
                      "warm_s": prefill_s[1:],
                      "warm_tokens_per_s": tokens / warm_s, "loss": losses,
                      "flash_launches_per_call": cfg.n_layers,
                      "max_memory_allocated": prefill_peak},
          "decode": {"batch": 8, "max_len": 128, "steps": 16, "batches": 4,
                     "batch_s": times, "steady_tok_per_s": decode_tps,
                     "n_hot": plan.n_hot, "coverage": plan.coverage},
          "launches": launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    emit({"phase": "moe-load", "what": "layer 0's moe_ffn on the prefill's "
          "hidden states (B=%d T=%d)" % PREFILL,
          "capacity_factor": cfg.moe.capacity_factor,
          "no_plan": {**load_stats(d0), "ms": ffn_ms},
          "plan": {"hot_experts": list(hot), **load_stats(d1),
                   "ms": ffn_plan_ms},
          "two_calls_bit_identical": identical, "finite": finite})
    if not (identical and finite):
        raise AssertionError(f"moe_ffn: two calls identical {identical}, "
                             f"finite {finite}")
    del x, h, z, out0, out1, again
    t0 = time.perf_counter()
    # lm-mesh's prefill launches join the moe path's
    launches["flash_attention"] += phase_lm_mesh(torch, cfg, params,
                                                 slot_map)
    walls["mesh_s"] = time.perf_counter() - t0
    emit({"phase": "moe-walls", **walls})
    del params, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


@contextmanager
def collective_spy(torch):
    """Counts the ``torch.distributed`` collectives called while open, by
    kind."""
    import torch.distributed as dist

    calls: Counter = Counter()
    inner = {name: getattr(dist, name) for name in ("all_reduce",
                                                    "all_gather")}

    def spy(name):
        def call(*args, **kw):
            calls[name] += 1
            return inner[name](*args, **kw)
        return call

    for name in inner:
        setattr(dist, name, spy(name))
    try:
        yield calls
    finally:
        for name, fn in inner.items():
            setattr(dist, name, fn)


def mesh_options(torch, cfg, tokens: np.ndarray, slot_map, mesh):
    """The ``RuntimeOptions`` of the moe config's own ``AdaptiveConfig``
    on ``mesh``: the controller's plan of the tokens (its hot budget), the
    cold fraction its ``cold_capacity`` gives them, the sharded moe with
    ``slot_map``."""
    from repro_torch.core.adaptive import AdaptiveShardingController
    from repro_torch.models.transformer import RuntimeOptions

    ctrl = AdaptiveShardingController(
        cfg.vocab_size, budget=cfg.adaptive.embedding_hot_budget)
    ctrl.observe(tokens)
    plan = ctrl.replan()
    n = int(tokens.size)
    return RuntimeOptions(mesh=mesh, sharded_moe=True,
                          adaptive_embedding=True, hot_ids=plan.hot_ids,
                          cold_frac=ctrl.cold_capacity(n) / n,
                          slot_map=slot_map), plan


def phase_lm_mesh(torch, cfg, params, slot_map) -> int:
    """qwen2-moe-a2.7b's prefill (B=4, T=4096, Zipf tokens, as the
    reference's ``serve_loop`` draws them) on ``make_local_mesh()`` (a
    world-size-1 NCCL group) under the options of its ``AdaptiveConfig``
    (hot embedding rows, the cold capacity from the plan's coverage, the
    sharded moe with the moe-load phase's 8-replica plan), with the params
    placed by ``param_specs``, beside the same prefill without options
    (``lm_loss`` with the same plan, params unplaced): tokens/s of each
    (one cold call, three warm), the loss difference, 24 flash launches a
    call, the collectives of a prefill, peak memory, and the overflow of
    ``adaptive_embed`` at ``lm_forward``'s capacity, which must be 0.
    Returns the flash launches of its eight prefills."""
    from repro_torch.data.tokens import zipf_tokens
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import param_specs, place
    from repro_torch.models import embedding as emb
    from repro_torch.models import transformer as TT
    from repro_torch.models.model_zoo import build_model

    b, t = PREFILL
    ids = zipf_tokens(np.random.default_rng(0), cfg.vocab_size,
                      (b, t + 1)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(ids[:, :-1]).cuda(),
             "labels": torch.from_numpy(ids[:, 1:]).cuda()}
    mesh = make_local_mesh("cuda")
    opts, plan = mesh_options(torch, cfg, ids[:, :-1], slot_map, mesh)
    model = build_model(cfg, opts=opts, device="cuda")
    start = LAUNCHES["flash_attention"]

    def run(loss_fn) -> dict:
        losses, secs, flash = [], [], []
        for _ in range(4):  # one cold call, three warm
            before = LAUNCHES["flash_attention"]
            a = time.perf_counter()
            with torch.inference_mode():
                losses.append(float(loss_fn()))
            secs.append(time.perf_counter() - a)
            flash.append(LAUNCHES["flash_attention"] - before)
        return {"loss": losses, "cold_s": secs[0], "warm_s": secs[1:],
                "warm_tokens_per_s": b * t / float(np.mean(secs[1:])),
                "flash_launches_per_call": flash}

    base = run(lambda: TT.lm_loss(params, batch["tokens"], batch["labels"],
                                  cfg, slot_map=slot_map))
    place(params, mesh, param_specs(params, mesh))
    torch.cuda.reset_peak_memory_stats()
    opt = run(lambda: model.loss(params, batch))
    peak = torch.cuda.max_memory_allocated()
    with collective_spy(torch) as calls, torch.inference_mode():
        model.loss(params, batch)
        torch.cuda.synchronize()
    with torch.inference_mode():
        _, over = emb.adaptive_embed(
            params.embed, batch["tokens"], cfg, opts.hot_ids,
            TT.cold_capacity(opts, batch["tokens"]), mesh)
    over = int(over)
    launches = LAUNCHES["flash_attention"] - start
    multihost.shutdown()
    diff = abs(opt["loss"][-1] - base["loss"][-1])
    ok = (over == 0 and all(f == cfg.n_layers for f in
                            base["flash_launches_per_call"] +
                            opt["flash_launches_per_call"]) and
          diff <= 1e-3 * abs(base["loss"][-1]) and
          all(math.isfinite(x) for x in opt["loss"]))
    emit({"phase": "lm-mesh", "arch": cfg.name, "mesh": list(mesh.shape),
          "backend": "nccl", "batch": b, "seq": t, "tokens": "zipf",
          "hot_rows": plan.n_hot, "coverage": plan.coverage,
          "cold_frac": opts.cold_frac,
          "cold_cap": TT.cold_capacity(opts, batch["tokens"]),
          "slot_map": list(slot_map), "without_options": base,
          "options": opt, "loss_diff": diff, "overflow": over,
          "collectives_per_prefill": dict(calls),
          "max_memory_allocated": peak, "ok": ok})
    if not ok:
        raise AssertionError(f"lm-mesh: overflow {over}, loss diff {diff}, "
                             f"flash {opt['flash_launches_per_call']}")
    return launches


@contextmanager
def route_spy(torch, batch: int):
    """Records each moe router call's input and gates (float32, (B, T,
    E)), on the host, in call order, for ``moe_ffn`` and
    ``moe_ffn_sharded`` alike."""
    from repro_torch.models import moe as TM
    from repro_torch.models import moe_sharded as TMS

    seen: list[tuple] = []
    inner = TM.route

    def spy(p, xf, k):
        with torch.no_grad():
            g = torch.softmax((xf @ p.router.to(xf.dtype)).float(), dim=-1)
        seen.append((xf.detach().cpu(), g.reshape(batch, -1, g.shape[-1])
                     .cpu()))
        return inner(p, xf, k)

    TM.route = TMS.route = spy
    try:
        yield seen
    finally:
        TM.route = TMS.route = inner


def near_tie_clear(card: list, host: list, k: int) -> tuple[np.ndarray, list]:
    """The (B, T) tokens no rerouting reached, and each reroute whose input
    no earlier reroute reached: (layer, b, t, the host's k-th and (k+1)-th
    gates, a near-tie (their gap below one bf16 ulp)).  A token whose top-k
    set differs between the devices reaches itself and, through causal
    attention at later layers, the later tokens of its row."""
    reached = np.zeros(tuple(card[0][1].shape[:2]), bool)
    first = []
    for layer, ((_, gc_), (_, gh)) in enumerate(zip(card, host)):
        top = lambda g: np.sort(np.argsort(
            -g.numpy(), -1, kind="stable")[..., :k], -1)
        rerouted = (top(gc_) != top(gh)).any(-1)
        reached = np.logical_or.accumulate(reached, axis=1)
        for b, t in zip(*np.nonzero(rerouted & ~reached)):
            g = np.sort(gh[b, t].numpy())[::-1]
            ulp = 2.0 ** (np.floor(np.log2(g[k - 1])) - 7)
            first.append((layer, int(b), int(t), float(g[k - 1]),
                          float(g[k]), bool(g[k - 1] - g[k] < ulp)))
        reached |= rerouted
    return ~reached, first


def moe_parity_cfg():
    """moe-parity's config: qwen2-moe-a2.7b, 2 layers at full width,
    float32."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH), n_layers=2,
                               dtype="float32")


def side_moe(torch, cpu, pc) -> dict:
    """moe-parity's CPU side (the side process), at the card's seed-0
    weights ``pc`` (``side_models``): the CPU port's hidden states, loss
    and layer 0's ``moe_ffn`` on its own layer-0 input with their routers'
    gates, the plain forward under the hot-expert plan of its layer-0
    loads (lm-mesh-parity's), and the first train step's loss and
    gradients."""
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT
    from repro_torch.models.moe import slot_map_for_plan

    cfg2 = moe_parity_cfg()
    bc = make_batch(cfg2, 1, 256, 0, device="cpu")
    bsz = int(bc["tokens"].shape[0])
    out: dict = {}
    with torch.inference_mode():
        with route_spy(torch, bsz) as host:
            out["h_host"] = TT.lm_forward(pc, bc["tokens"], cfg2)
        out["loss_host"] = float(cpu.loss(pc, bc))
        # layer 0's input on the CPU, given to both
        x0 = host[0][0].reshape(bsz, -1, cfg2.d_model)
        with route_spy(torch, bsz) as ffn_host:
            out["out_h"], out["d_h"] = TM.moe_ffn(pc.blocks[0].moe, x0, cfg2)
        hot = tuple(int(e) for e in torch.argsort(
            out["d_h"]["route_counts"], descending=True,
            stable=True)[:MOE_HOT])
        with route_spy(torch, bsz) as host2:
            out["h_mesh_host"] = TT.lm_forward(
                pc, bc["tokens"], cfg2,
                slot_map=slot_map_for_plan(cfg2.moe.n_experts, hot))
    out.update(host=host, ffn_host=ffn_host, x0=x0, hot=hot,
               mesh_host=host2,
               first=cpu_first_step(torch, cfg2, cpu, pc, 256))
    return out


def phase_moe_parity(torch, side: "SideProcess") -> None:
    """qwen2-moe-a2.7b with 2 layers at full width in float32 (B=1,
    T=256), the card against the CPU port: hidden states, loss and layer
    0's ``moe_ffn`` on the same input (diagnostics bit-exact where both
    devices route every token alike; a token routed differently must be a
    near-tie and is left out with the tokens it reached), then one train
    step's gradients and parameters (phase 5's limits).  The CPU port's
    side comes from the side process (``side_moe``)."""
    import copy

    from repro_torch.data.tokens import make_batch
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT
    from repro_torch.models.model_zoo import build_model

    t0 = time.perf_counter()
    cfg2 = moe_parity_cfg()
    k = cfg2.moe.top_k
    gpu = build_model(cfg2, device="cuda")
    pg = gpu.init(0)
    bg = make_batch(cfg2, 1, 256, 0, device="cuda")
    bsz = int(bg["tokens"].shape[0])
    cs = side.result("moe-parity")
    host, ffn_host, h_host = cs["host"], cs["ffn_host"], cs["h_host"]
    out_h, d_h, loss_host = cs["out_h"], cs["d_h"], cs["loss_host"]
    with torch.inference_mode():
        with route_spy(torch, bsz) as card:
            h_card = TT.lm_forward(pg, bg["tokens"], cfg2).cpu()
        loss_card = float(gpu.loss(pg, bg))
        with route_spy(torch, bsz) as ffn_card:
            out_c, d_c = TM.moe_ffn(pg.blocks[0].moe, cs["x0"].cuda(), cfg2)
    tol = 1e-4  # TOL float32: products summed in another order
    keep, reroutes = near_tie_clear(card, host, k)
    hidden_err = float((h_card[keep] - h_host[keep]).abs().max())
    hidden_ok = bool(torch.allclose(h_card[keep], h_host[keep], atol=tol,
                                    rtol=tol))
    ffn_keep, ffn_reroutes = near_tie_clear(ffn_card, ffn_host, k)
    out_c = out_c.cpu()
    ffn_err = float((out_c[ffn_keep] - out_h[ffn_keep]).abs().max())
    ffn_ok = bool(torch.allclose(out_c[ffn_keep], out_h[ffn_keep],
                                 atol=tol, rtol=tol))
    diag_equal = {name: bool(torch.equal(d_c[name].cpu(), d_h[name]))
                  for name in ("dropped", "expert_load", "route_counts")}
    loss_rel = abs(loss_card - loss_host) / abs(loss_host)
    del card, host, ffn_card, ffn_host, out_c, out_h, h_card, h_host
    forward_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    phase_lm_mesh_parity(torch, cfg2, pg, bg, cs["hot"], cs["mesh_host"],
                         cs["h_mesh_host"])
    mesh_parity_s = time.perf_counter() - t1

    # the train step starts from the card's weights (inference mode left
    # them as they were); the CPU's optimizer steps a copy of them
    t0 = time.perf_counter()
    models = [gpu, build_model(cfg2, device="cpu"), pg,
              copy.deepcopy(pg).to("cpu")]
    del gpu, pg
    row, gpu, pg, og = card_vs_cpu_steps(torch, cfg2, 1, 256, models,
                                         first=cs["first"])
    del models, gpu, pg, og, cs
    gc.collect()
    torch.cuda.empty_cache()
    ok = (hidden_ok and keep.any() and ffn_ok and
          all(r[-1] for r in reroutes + ffn_reroutes) and
          (all(diag_equal.values()) or bool(ffn_reroutes)) and
          loss_rel <= STEP_TOL["loss_rel"] and row["ok"])
    emit({"phase": "moe-parity", "arch": MOE_ARCH, "n_layers": 2,
          "compute_dtype": "float32", "batch": 1, "seq": 256,
          "hidden_max_abs_err": hidden_err, "tolerance": tol,
          "tokens_compared": int(keep.sum()), "tokens": int(keep.size),
          "reroutes": reroutes, "loss": [loss_card, loss_host],
          "loss_rel_err": loss_rel,
          "moe_ffn_layer0": {"diag_equal": diag_equal,
                             "max_abs_err": ffn_err,
                             "reroutes": ffn_reroutes,
                             "load": load_stats(d_h)},
          "train_step": row, "forward_s": forward_s,
          "lm_mesh_parity_s": mesh_parity_s,
          "train_step_s": time.perf_counter() - t0,
          "cpu_side_s": side.seconds["moe-parity"], "ok": ok})
    if not ok:
        raise AssertionError("moe-parity: the card's moe model disagrees "
                             "with the CPU port's (see the line above)")


def phase_lm_mesh_parity(torch, cfg2, pg, bg, hot, host, h_host) -> None:
    """moe-parity's 2-layer float32 models: the card's ``lm_forward``
    under all options (``make_local_mesh()``, world-size-1 NCCL: the
    adaptive embedding with the controller's plan of the batch, the
    sharded moe with ``hot`` replicated) against the CPU port's plain
    forward with the same plan -- the function the options compute --
    within 1e-4, on the tokens no near-tie rerouting reached (the CPU's
    hidden states ``h_host`` and router records ``host`` from the side
    process)."""
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.models.moe import slot_map_for_plan

    slot_map = slot_map_for_plan(cfg2.moe.n_experts, hot)
    mesh = make_local_mesh("cuda")
    opts, plan = mesh_options(torch, cfg2, bg["tokens"].cpu().numpy(),
                              slot_map, mesh)
    bsz = int(bg["tokens"].shape[0])
    with torch.inference_mode():
        with route_spy(torch, bsz) as card:
            h_card = TT.lm_forward(pg, bg["tokens"], cfg2, opts=opts).cpu()
    multihost.shutdown()
    tol = 1e-4  # TOL float32: products summed in another order
    keep, reroutes = near_tie_clear(card, host, cfg2.moe.top_k)
    err = float((h_card[keep] - h_host[keep]).abs().max())
    ok = (bool(torch.allclose(h_card[keep], h_host[keep], atol=tol,
                              rtol=tol)) and keep.any() and
          all(r[-1] for r in reroutes) and len(card) == len(host))
    emit({"phase": "lm-mesh-parity", "arch": MOE_ARCH, "n_layers": 2,
          "compute_dtype": "float32", "batch": bsz,
          "seq": int(bg["tokens"].shape[1]), "mesh": list(mesh.shape),
          "hot_rows": plan.n_hot, "cold_frac": opts.cold_frac,
          "slot_map": list(slot_map), "hidden_max_abs_err": err,
          "tolerance": tol, "tokens_compared": int(keep.sum()),
          "reroutes": reroutes, "ok": ok})
    if not ok:
        raise AssertionError("lm-mesh-parity: the card's forward under the "
                             "options disagrees with the CPU port's")


def phase_moe_train(torch) -> dict[str, int]:
    """qwen2-moe-a2.7b at full width and MOE_TRAIN_LAYERS layers through
    ``make_train_step``: float32 parameters, bf16 compute, remat on; one
    warm-up step and two timed ones on ``make_batch(cfg, 1, 4096, step)``,
    each with 2 x layers forward and layers backward flash launches, then a
    profiled step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    opt = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig())
    batches = [make_batch(cfg, *TRAIN, i, device="cuda") for i in range(4)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    steps = []
    for i in range(3):  # one warm-up step, two timed
        fwd, bwd = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_bwd"]
        a = time.perf_counter()
        params, opt, met = step_fn(params, opt, batches[i])
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        steps.append({"step": i, "s": time.perf_counter() - a, "loss": loss,
                      "grad_norm": gnorm,
                      "flash_fwd": LAUNCHES["flash_attention"] - fwd,
                      "flash_bwd": LAUNCHES["flash_attention_bwd"] - bwd})
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"moe train step {i}: loss {loss}, "
                                 f"grad_norm {gnorm}")
        # remat runs each block's forward twice (forward, recompute)
        if steps[-1]["flash_fwd"] != 2 * cfg.n_layers or \
                steps[-1]["flash_bwd"] != cfg.n_layers:
            raise AssertionError(f"moe train step {i}: flash launches "
                                 f"{steps[-1]}, expected "
                                 f"{2 * cfg.n_layers} forward and "
                                 f"{cfg.n_layers} backward")
    steps_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.mean([r["s"] for r in steps[1:]]))
    tokens = TRAIN[0] * TRAIN[1]
    t0 = time.perf_counter()
    prof = profile_run(torch, lambda: step_fn(params, opt, batches[3]))
    emit({"phase": "moe-train-profile", "what": "one train step B=%d T=%d"
          % TRAIN, **{k: v for k, v in prof.items()
                      if k != "port_kernels_ms"},
          "busy_share": 1 - prof["idle_share"]})
    profile_s = time.perf_counter() - t0
    emit({"phase": "moe-train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "experts": [cfg.moe.n_experts,
                                              cfg.moe.top_k,
                                              cfg.moe.n_shared,
                                              cfg.moe.d_expert],
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.dtype,
          "remat": cfg.remat, "params": n_params,
          "param_count_cfg": cfg.param_count(),
          "batch": TRAIN[0], "seq": TRAIN[1],
          "reduced": f"24 -> {cfg.n_layers} layers (float32 parameters, "
                     "gradients and both moments of all 24 need 229 GB); "
                     "train_4k global batch 256 -> 1 (one card)",
          "allocated_before_bytes": allocated_before, "steps": steps,
          "step_s": step_s, "tokens_per_s": tokens / step_s,
          "flash_launches_per_step": {"forward": 2 * cfg.n_layers,
                                      "backward": cfg.n_layers},
          "max_memory_allocated": peak, "launches": launches,
          "walls": {"init_s": init_s, "steps_s": steps_s,
                    "profile_s": profile_s}})
    del params, opt, model, batches, step_fn, met
    gc.collect()
    torch.cuda.empty_cache()
    return {**launches, "tokens_per_s": tokens / step_s}


# ------------------------------------------------------------ phase 6c
#: the layers of train-mesh's checkpoint round trip, at the config's
#: width and CKPT_VOCAB rows: 0 keeps the embedding table, the LM head and
#: the final norm; a layer adds 6.84 GB, ~30 s of reads and writes where
#: the temporary directory is a 9p file system
MESH_CKPT_LAYERS = 0


def phase_train_mesh(torch, moe_tokens_per_s: float) -> dict[str, int]:
    """moe-train's model (qwen2-moe-a2.7b, MOE_TRAIN_LAYERS layers at full
    width, B=1 T=4096) through the train CLI's path on a world-size-1 NCCL
    mesh: ``make_local_mesh``, ``place``, ``make_train_step(..., mesh)``,
    three steps, then a checkpoint saved and restored through the mesh
    (``restore_latest(..., mesh=)``) into fresh state, of the same config
    at MESH_CKPT_LAYERS layers after one mesh step.  The first step's
    loss and updated parameters must be bit-identical to the unmeshed
    step's from the same weights and batch (held on the card), and the
    restored leaves to the saved ones.  Returns the flash launches of the
    three mesh steps."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import param_specs, place
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from torch.utils._pytree import tree_leaves

    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    model = build_model(cfg, device="cuda")
    batches = [make_batch(cfg, *TRAIN, i, device="cuda") for i in range(3)]
    walls: dict[str, float] = {}
    t0 = time.perf_counter()
    params = model.init(0)
    opt = adamw_init(params)
    params, opt, met = make_train_step(model, AdamWConfig())(
        params, opt, batches[0])
    plain_loss = met["loss"]
    # the unmeshed step's parameters stay on the card (11.62 GB) for the
    # comparison
    plain = dict(params.named_parameters())
    plain_bytes = sum(p.numel() * p.element_size() for p in plain.values())
    del params, opt, met
    gc.collect()
    torch.cuda.empty_cache()
    walls["unmeshed_step_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_local_mesh("cuda")
    try:
        params = model.init(0)
        pspecs = param_specs(params, mesh)
        params = place(params, mesh, pspecs)
        opt = adamw_init(params)
        step_fn = make_train_step(model, AdamWConfig(), mesh)
        # the main path: counts set to 0 just before, read just after
        reset_launches()
        steps = []
        for i in range(3):  # one warm-up step, two timed
            fwd = LAUNCHES["flash_attention"]
            bwd = LAUNCHES["flash_attention_bwd"]
            a = time.perf_counter()
            params, opt, met = step_fn(params, opt, batches[i])
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            steps.append({"step": i, "s": time.perf_counter() - a,
                          "loss": loss, "grad_norm": gnorm,
                          "flash_fwd": LAUNCHES["flash_attention"] - fwd,
                          "flash_bwd": LAUNCHES["flash_attention_bwd"] - bwd})
            if i == 0:
                loss_equal = torch.equal(met["loss"], plain_loss)
                params_equal = all(torch.equal(p.detach(), plain[n].detach())
                                   for n, p in params.named_parameters())
                del plain
            if steps[-1]["flash_fwd"] != 2 * cfg.n_layers or \
                    steps[-1]["flash_bwd"] != cfg.n_layers:
                raise AssertionError(f"train-mesh step {i}: flash launches "
                                     f"{steps[-1]}")
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        walls["mesh_steps_s"] = time.perf_counter() - t0
        step_s = float(np.mean([r["s"] for r in steps[1:]]))

        # the checkpoint round trip through the mesh, into fresh state, on
        # the same config at MESH_CKPT_LAYERS layers and CKPT_VOCAB rows:
        # the four layers' state (34.85 GB) takes ~150 s to write and read
        # back
        t0 = time.perf_counter()
        del params, opt, met
        gc.collect()
        torch.cuda.empty_cache()
        ck_cfg = dataclasses.replace(cfg, n_layers=MESH_CKPT_LAYERS,
                                     vocab_size=CKPT_VOCAB)
        ck_model = build_model(ck_cfg, device="cuda")
        params = ck_model.init(0)
        pspecs = param_specs(params, mesh)
        params = place(params, mesh, pspecs)
        opt = adamw_init(params)
        params, opt, _ = make_train_step(ck_model, AdamWConfig(), mesh)(
            params, opt, make_batch(ck_cfg, *TRAIN, 0, device="cuda"))
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp)
            mgr.save(params, opt, 1)
            ckpt_bytes = dir_bytes(Path(tmp))
            fresh = ck_model.init(5)
            fresh_opt = adamw_init(fresh)
            fresh, fresh_opt, step = mgr.restore_latest(
                fresh, fresh_opt, mesh=mesh, specs=pspecs)
        ckpt_equal = (step == 1 and int(fresh_opt.step) == int(opt.step)
                      and fresh.placement is not None and all(
                          torch.equal(a.detach(), b.detach()) for a, b in
                          zip(params.parameters(), fresh.parameters())))
        for name in ("m", "v"):
            ckpt_equal = ckpt_equal and all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(getattr(opt, name)),
                    tree_leaves(getattr(fresh_opt, name))))
        walls["checkpoint_s"] = time.perf_counter() - t0
        del fresh, fresh_opt
    finally:
        multihost.shutdown()
    tokens = TRAIN[0] * TRAIN[1]
    ok = loss_equal and params_equal and ckpt_equal
    emit({"phase": "train-mesh", "arch": cfg.name, "n_layers": cfg.n_layers,
          "mesh": list(mesh.shape), "backend": "nccl",
          "batch": TRAIN[0], "seq": TRAIN[1], "steps": steps,
          "step_s": step_s, "tokens_per_s": tokens / step_s,
          "moe_train_tokens_per_s": moe_tokens_per_s,
          "flash_launches_per_step": {"forward": 2 * cfg.n_layers,
                                      "backward": cfg.n_layers},
          "max_memory_allocated": peak,
          "of_it_the_unmeshed_parameters_held": plain_bytes,
          "first_step_loss_bit_identical": loss_equal,
          "first_step_params_bit_identical": params_equal,
          "checkpoint_layers": MESH_CKPT_LAYERS,
          "checkpoint_vocab": CKPT_VOCAB, "checkpoint_bytes": ckpt_bytes,
          "checkpoint_round_trip_bit_exact": ckpt_equal,
          "launches": launches, "walls": walls, "ok": ok})
    del params, opt, model, ck_model, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("train-mesh: the mesh step or its checkpoint "
                             "is not bit-identical (see the line above)")
    return launches


#: train-mesh2's legs: (arch, layers (None: the config's), batch, text
#: length, decode).  moe: the expert stacks, QKV and FFN cut over two
#: ranks' model axis; hybrid: one rec/rec/attn group at full width, the
#: RG-LRU cut per channel, 5 query heads a rank over the whole KV head,
#: T past the window (2048); audio: whisper-tiny at full size, 3 heads a
#: rank in each attention, the GeLU MLPs cut (its 51,865-row token table
#: stays whole by the spec); every head vocab-parallel
MESH2_LEGS = {"moe": (MOE_ARCH, 2, 2, 512, False),
              "hybrid": ("recurrentgemma-2b", 3, 2, 2304, True),
              "audio": ("whisper-tiny", None, 2, 448, True)}
MESH2_DECODE = (4, 16)  # teacher-forced decode steps, the cache's max_len

TRAIN_MESH2_CHILD = textwrap.dedent(
    r"""
    import dataclasses
    import json
    import sys
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.mesh import local_mesh_shape, make_local_mesh
    from repro_torch.launch.shardings import (Stats, gather_whole,
                                              param_specs, place)
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.collectives import trace_collectives
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.whisper import whisper_encode

    legs = json.loads(sys.argv[1])
    steps, max_len = json.loads(sys.argv[2])
    rank = dist.get_rank()
    mesh = make_local_mesh("cuda")
    assert tuple(mesh.shape) == local_mesh_shape(2) == (1, 2)


    def decode(model, params, batch):
        # teacher-forced decode steps from a zero cache (the placed
        # model's cache holds its RG-LRU channels); whisper's over its own
        # encoder states
        extra = {}
        if model.cfg.family == "audio":
            with torch.no_grad():
                extra["enc"] = whisper_encode(params, batch["frames"],
                                              model.cfg)
        cache = model.init_cache(batch["tokens"].shape[0], max_len, params)
        out = []
        for pos in range(steps):
            lg, cache = model.decode(params, cache, {
                "tokens": batch["tokens"][:, pos:pos + 1], "pos": pos,
                **extra})
            out.append(lg.float())
        return out


    for leg, (arch, layers, b, t, with_decode) in legs.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        cfg = dataclasses.replace(cfg, dtype="float32")
        model = build_model(cfg, device="cuda")
        whole_bytes = Stats.bytes_of(model.param_specs())  # fake: no storage
        params = model.init(0)
        params = place(params, mesh, param_specs(params, mesh))
        batch = make_batch(cfg, b, t, 0, device="cuda")
        reset_launches()
        with trace_collectives() as events:
            loss, grads = loss_and_grads(model, params, batch, mesh)
        launches = dict(LAUNCHES)
        grads = gather_whole(grads, params.placement)
        logits = decode(model, params, batch) if with_decode else []
        out = {"leg": leg, "arch": cfg.name, "n_layers": cfg.n_layers,
               "batch": b, "seq": t, "rank": rank,
               "param_bytes": Stats.bytes_of(params),
               "whole_param_bytes": whole_bytes, "loss": float(loss),
               "cut": len(params.placement.cut),
               "cut_leaves": sorted(params.placement.cut),
               "collectives_a_step": collective_bytes(events),
               "flash": {"forward": launches["flash_attention"],
                         "backward": launches["flash_attention_bwd"]}}
        out["param_share"] = out["param_bytes"] / whole_bytes
        if rank == 0:  # the card's world-size-1 step on the same weights
            del params
            torch.cuda.empty_cache()
            one = model.init(0)
            loss1, grads1 = loss_and_grads(model, one, batch)
            top = max(float(g.abs().max()) for g in grads1.values())
            worst, worst_leaf = 0.0, None
            for n, g1 in grads1.items():
                # bk's gradient is zero in exact arithmetic: rounding noise
                scale = top if n.endswith(".bk") else float(g1.abs().max())
                err = float((grads[n] - g1).abs().max()) / max(scale, 1e-30)
                if err > worst:
                    worst, worst_leaf = err, n
            del grads1
            out.update(loss_one_rank=float(loss1),
                       loss_rel_err=abs(float(loss) - float(loss1)) /
                       abs(float(loss1)),
                       grad_err_over_leaf_max=worst,
                       grad_worst_leaf=worst_leaf)
            if with_decode:
                want = decode(model, one, batch)
                out["decode_err_over_max"] = max(
                    float((a - w).abs().max() / w.abs().max())
                    for a, w in zip(logits, want))
                out["decode_steps"] = len(want)
            del one
        del grads, logits, batch
        params = None
        torch.cuda.empty_cache()
        out["wall_s"] = time.perf_counter() - t0
        print("TRAINMESH2-OK " + json.dumps(out), flush=True)
        dist.barrier()
    """
)


def phase_train_mesh2(torch) -> dict[str, int]:
    """Two gloo ranks on the card over mesh (1, 2) (``local_mesh_shape(2)``,
    as ``mesh2`` runs its two), in one launch, the legs of
    ``MESH2_LEGS`` in float32: qwen2-moe-a2.7b at 2 layers (B=2, T=512),
    recurrentgemma-2b at one group (B=2, T=2,304) and whisper-tiny at full
    size (B=2, 1,500 frames, 448 tokens), every leaf ``place`` cuts over
    ``model``; each leg's loss and every gradient, gathered whole, against
    the card's world-size-1 step on the same weights and batch (rank 0):
    the loss within 1e-5 relative, each gradient within 1e-5 of its leaf's
    largest magnitude (``bk``, zero in exact arithmetic, of the largest
    gradient's); for the hybrid and audio legs four teacher-forced decode
    steps of the placed model against the whole model's, logits within
    1e-5 of their largest.  Each rank's placed parameter bytes against the
    whole model's, and the step's collectives by kind, are printed.  Gloo
    carries every collective on the card's tensors (all_reduce,
    all_gather, and the RG-LRU's reduce-scatter).  Returns the flash
    launches of both ranks' steps, summed."""
    import tempfile

    from repro_torch.launch.multihost import launch_localhost

    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp) / "train_mesh2_child.py"
        script.write_text(TRAIN_MESH2_CHILD)
        t0 = time.perf_counter()
        results = launch_localhost(
            2, [str(script), json.dumps(MESH2_LEGS),
                json.dumps(MESH2_DECODE)],
            device="cuda", backend="gloo", timeout=300.0)
        wall = time.perf_counter() - t0
    outs: dict[str, list] = {leg: [] for leg in MESH2_LEGS}
    for r in results:
        lines = [json.loads(ln[len("TRAINMESH2-OK "):])
                 for ln in r.stdout.splitlines()
                 if ln.startswith("TRAINMESH2-OK ")]
        if not r.ok or len(lines) != len(MESH2_LEGS):
            raise AssertionError(f"train-mesh2: rank {r.process_id} rc "
                                 f"{r.returncode}\n{r.stderr[-3000:]}")
        for o in lines:
            outs[o["leg"]].append(o)
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    ok = True
    for leg, ranks in outs.items():
        r0 = ranks[0]
        leg_ok = (r0["loss_rel_err"] <= 1e-5 and
                  r0["grad_err_over_leaf_max"] <= 1e-5 and
                  r0.get("decode_err_over_max", 0.0) <= 1e-5 and
                  all(o["cut"] > 0 and o["flash"]["forward"] > 0 and
                      o["flash"]["backward"] > 0 for o in ranks) and
                  ranks[0]["loss"] == ranks[1]["loss"])
        ok = ok and leg_ok
        for o in ranks:
            launches["flash_attention"] += o["flash"]["forward"]
            launches["flash_attention_bwd"] += o["flash"]["backward"]
        emit({"phase": "train-mesh2", "leg": leg, "ranks": 2, "mesh": [1, 2],
              "backend": "gloo", "device": "cuda", "arch": r0["arch"],
              "n_layers": r0["n_layers"], "compute_dtype": "float32",
              "batch": r0["batch"], "seq": r0["seq"], "per_rank": ranks,
              "tolerance": {"loss_rel": 1e-5, "grad_over_leaf_max": 1e-5,
                            "decode_over_max": 1e-5},
              "ok": leg_ok})
    emit({"phase": "train-mesh2-walls", "wall_s": wall,
          "legs_s": {leg: max(o["wall_s"] for o in ranks)
                     for leg, ranks in outs.items()},
          "launches": launches})
    if not ok:
        raise AssertionError("train-mesh2: the two ranks' step or decode "
                             "disagrees with the card's world-size-1 one")
    return launches


# ------------------------------------------------------------ phase 6b
SSM_ARCH = "mamba2-130m"  # the train CLI's default arch, as the reference's
HYBRID_ARCH = "recurrentgemma-2b"
VLM_ARCH = "internvl2-2b"
AUDIO_ARCH = "whisper-tiny"
# the audio prefill and train step: 16 rows of 1,500 encoder frames and 448
# text positions (Whisper's published n_text_ctx)
AUDIO = (16, 448)
# float32 card against CPU port: products summed in another order
PARITY_TOL = 1e-4


@contextmanager
def attention_spy(torch):
    """Records (window, head dim, causal) of every attention call of the
    models (prefill, train and cross-attention) that goes to
    ``flash_attention`` while open."""
    from repro_torch.models import attention as TA

    seen: list[tuple[int, int, bool]] = []
    inner = TA.flash_attention

    def spy(q, k, v, **kw):
        seen.append((int(kw.get("window", 0)), int(q.shape[-1]),
                     bool(kw.get("causal", True))))
        return inner(q, k, v, **kw)

    TA.flash_attention = spy
    try:
        yield seen
    finally:
        TA.flash_attention = inner


def family_serving(torch, phase: str, arch: str, text_len: int,
                   flash_per_call: int, window: int = 0) -> dict[str, int]:
    """``arch`` at full width and depth, bf16 weights from seed 0, through
    the port's entry points: prefill (``model.loss`` on B=4 and
    ``text_len`` tokens under ``torch.inference_mode()``, one cold call and
    three warm, each with ``flash_per_call`` flash_attention launches, all
    with ``window``), a profiled prefill and decode batch, decode
    (``serve_loop``: batch 8, max_len 128, 16 steps, 4 batches, with the
    adaptive controller).  Returns the launches of the run."""
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import AdaptiveShardingController
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.model_zoo import build_model

    cfg = get_config(arch)
    walls: dict[str, float] = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0, dtype=torch.bfloat16)
    batch = make_batch(cfg, PREFILL[0], text_len, 0, device="cuda")
    torch.cuda.synchronize()
    walls["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    prefix = cfg.vlm.n_patches if cfg.vlm is not None else 0
    positions = PREFILL[0] * (prefix + text_len)

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    losses, prefill_s = [], []
    with attention_spy(torch) as calls:
        for i in range(4):  # one cold call, three warm
            before, seen = LAUNCHES["flash_attention"], len(calls)
            a = time.perf_counter()
            with torch.inference_mode():  # prefill: no autograd, no remat
                loss = float(model.loss(params, batch))
            prefill_s.append(time.perf_counter() - a)
            losses.append(loss)
            launched = LAUNCHES["flash_attention"] - before
            if launched != flash_per_call or any(
                    c != (window, cfg.hd, True) for c in calls[seen:]):
                raise AssertionError(
                    f"{phase} prefill call {i}: {launched} flash_attention "
                    f"launches with (window, hd, causal) {calls[seen:]}, "
                    f"expected {flash_per_call} with "
                    f"{(window, cfg.hd, True)}")
            if not math.isfinite(loss):
                raise AssertionError(f"{phase} prefill call {i}: loss {loss}")
    walls["prefill_s"] = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    warm_s = float(np.mean(prefill_s[1:]))

    t0 = time.perf_counter()
    ctrl = AdaptiveShardingController(
        cfg.vocab_size, budget=cfg.adaptive.embedding_hot_budget)
    times, plan = serve_loop(model, params, batch_size=8, max_len=128,
                             steps=16, n_batches=4, controller=ctrl)
    walls["decode_s"] = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    decode_tps = 8 * 16 / float(np.mean(times[1:]))  # serve.py's formula

    # where a warm prefill's and a decode batch's device time goes (the
    # profiler's overhead is in these walls, not in the times above)
    t0 = time.perf_counter()
    prefill_prof = profile_run(torch, torch.inference_mode()(
        lambda: model.loss(params, batch)))
    decode_prof = profile_run(torch, lambda: serve_loop(
        model, params, batch_size=8, max_len=128, steps=4, n_batches=1))
    busy = {}
    for what, prof in (("prefill B=%d T=%d" % (PREFILL[0], prefix + text_len),
                        prefill_prof),
                       ("decode batch 8 x 4 steps", decode_prof)):
        busy[what.split()[0]] = 1 - prof["idle_share"]
        emit({"phase": f"{phase}-profile", "what": what,
              **{k: v for k, v in prof.items() if k != "port_kernels_ms"},
              "busy_share": 1 - prof["idle_share"]})
    walls["profile_s"] = time.perf_counter() - t0
    emit({"phase": phase, "arch": cfg.name, "family": cfg.family,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.n_kv_heads], "hd": cfg.hd,
          "vocab": cfg.vocab_size, "weights_dtype": "bfloat16",
          "params": n_params, "param_count_cfg": cfg.param_count(),
          "weight_bytes": weight_bytes,
          "prefill": {"batch": PREFILL[0], "patches": prefix,
                      "text": text_len, "positions": positions,
                      "cold_s": prefill_s[0], "warm_s": prefill_s[1:],
                      "warm_tokens_per_s": positions / warm_s,
                      "loss": losses, "busy_share": busy["prefill"],
                      "flash_launches_per_call": flash_per_call,
                      "attention_window": window,
                      "max_memory_allocated": prefill_peak},
          "decode": {"batch": 8, "max_len": 128, "steps": 16, "batches": 4,
                     "batch_s": times, "steady_tok_per_s": decode_tps,
                     "busy_share": busy["decode"], "n_hot": plan.n_hot,
                     "coverage": plan.coverage},
          "launches": launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "walls": walls})
    del params, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_ssm_train(torch) -> None:
    """The train CLI's default arch (mamba2-130m, the reference's default)
    on the card: ``launch.train.main`` for two steps with no ``--arch``,
    then ``make_train_step`` at full width and depth (float32 parameters,
    bf16 compute, remat) on ``make_batch(cfg, 1, 4096, step)``: a warm-up
    step and three timed ones, each with finite loss and grad_norm."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.launch import train
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(["--steps", "2", "--batch", "1", "--seq", "4096"])
    cli_s = time.perf_counter() - t0
    text = out.getvalue()
    cli_losses = [float(line.split()[3]) for line in text.splitlines()
                  if line.startswith("step")]
    if f"arch={SSM_ARCH} device=cuda" not in text or not cli_losses or \
            not all(map(math.isfinite, cli_losses)):
        raise AssertionError(f"ssm-train: the train CLI's default run "
                             f"printed {text!r}")
    cfg = get_config(SSM_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    opt = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig())
    batches = [make_batch(cfg, *TRAIN, i, device="cuda") for i in range(4)]
    steps = []
    for i in range(4):  # one warm-up step, three timed
        a = time.perf_counter()
        params, opt, met = step_fn(params, opt, batches[i])
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        steps.append({"step": i, "s": time.perf_counter() - a, "loss": loss,
                      "grad_norm": gnorm})
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"ssm train step {i}: loss {loss}, "
                                 f"grad_norm {gnorm}")
    step_s = float(np.mean([r["s"] for r in steps[1:]]))
    emit({"phase": "ssm-train", "arch": cfg.name,
          "cli": {"argv": "--steps 2 --batch 1 --seq 4096 (no --arch)",
                  "first_line": text.splitlines()[0], "losses": cli_losses,
                  "s": cli_s},
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.dtype,
          "remat": cfg.remat, "batch": TRAIN[0], "seq": TRAIN[1],
          "steps": steps, "step_s": step_s,
          "tokens_per_s": TRAIN[0] * TRAIN[1] / step_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del params, opt, model, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()


def cache_leaves(cache) -> list:
    """The tensors of a decode cache (nested dicts and lists), in order."""
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in cache_leaves(cache[k])]
    if isinstance(cache, (list, tuple)):
        return [t for c in cache for t in cache_leaves(c)]
    return [cache]


def max_err(torch, got, want, scaled: bool = False) -> tuple[float, bool]:
    """Max abs difference of two tensors (``got`` on any device) and
    whether they are close within PARITY_TOL (atol = rtol); with
    ``scaled`` the atol is PARITY_TOL of max(1, the largest magnitude of
    ``want``), as phase 4 holds hidden states: a logit is a sum of D
    products of size ~1 (tens in all), so one near 0 keeps the sum's
    absolute error."""
    g = got.detach().float().cpu()
    w = want.detach().float()
    atol = PARITY_TOL * (max(1.0, float(w.abs().max())) if scaled else 1.0)
    return (float((g - w).abs().max()),
            bool(torch.allclose(g, w, atol=atol, rtol=PARITY_TOL)))


def family_forward(torch, cfg2, p, batch) -> tuple:
    """(hidden states, loss, seconds, the decode's extra inputs) of one
    forward of ``p`` on ``batch``: an audio config's hidden states are
    the encoder states and the decoder's."""
    from repro_torch.models import transformer as TT
    from repro_torch.models import vlm as TV
    from repro_torch.models import whisper as TW

    a = time.perf_counter()
    extra = {}
    with torch.inference_mode():
        if cfg2.family == "audio":
            enc = TW.whisper_encode(p, batch["frames"], cfg2)
            t = batch["tokens"].shape[1]
            x = TW._embed(p, batch["tokens"], cfg2) + \
                p.dec_pos[None, :t].to(cfg2.cdtype)
            text = TW._decode_stack(p, x, enc, cfg2)
            loss = float(TT.chunked_nll(text, batch["labels"],
                                        p.tok.t().to(text.dtype), cfg2))
            h, extra = torch.cat([enc, text], dim=1), {"enc": enc}
        else:
            emb = (TV._project(p, batch["patches"], cfg2)
                   if cfg2.vlm is not None else None)
            h = TT.lm_forward(p, batch["tokens"], cfg2, inputs_embeds=emb)
            text = h if emb is None else h[:, emb.shape[1]:]
            loss = float(TT.hidden_loss(p, text, batch["labels"], cfg2))
    return h, loss, time.perf_counter() - a, extra


def side_family(torch, cfg2, cpu, pc, text_len: int, train_len: int
                ) -> dict:
    """``family_parity``'s CPU side (the side process): the CPU port's
    hidden states and loss of one forward, and the train step's first
    loss and gradients, at the card's seed-0 weights ``pc``."""
    from repro_torch.data.tokens import make_batch

    bc = make_batch(cfg2, 1, text_len, 0, device="cpu")
    h, loss, secs, _ = family_forward(torch, cfg2, pc, bc)
    return {"h_host": h, "loss_host": loss, "s": secs,
            "first": cpu_first_step(torch, cfg2, cpu, pc, train_len)}


def family_parity(torch, phase: str, cfg2, text_len: int,
                  decode_at: tuple[int, int] | None, decode_max_len: int,
                  train: bool, train_len: int | None = None,
                  side: "SideProcess | None" = None) -> None:
    """The float32 config ``cfg2`` at seed 0 on the card and a copy on the
    CPU port: hidden states (one forward each) within PARITY_TOL and the
    loss from them within 1e-5 relative; decode steps at positions
    ``decode_at`` (a range) teacher-forced with the batch's tokens, each
    step's logits (of their largest magnitude) and every cache leaf within
    PARITY_TOL, from caches of
    ``decode_max_len`` filled from a seed when the range starts past 0;
    then, with ``train``, one train step at phase 5's limits on
    ``train_len`` tokens (default ``text_len``).  An audio
    config's hidden states are the encoder states of the batch's frames
    and the decoder's, and its decode steps attend to each device's own
    encoder states.  With ``side``, the CPU port's forward and its first
    train step's gradients come from the side process (``side_family``);
    the decode steps run here, side by side."""
    import copy

    from repro_torch.data.tokens import make_batch
    from repro_torch.models.model_zoo import build_model

    t0 = time.perf_counter()
    gpu, cpu = build_model(cfg2, device="cuda"), build_model(cfg2,
                                                             device="cpu")
    pg = gpu.init(0)
    pc = copy.deepcopy(pg).to("cpu")
    bg = make_batch(cfg2, 1, text_len, 0, device="cuda")
    bc = {k: v.cpu() for k, v in bg.items()}

    h_card, loss_card, card_s, extra_card = family_forward(torch, cfg2, pg,
                                                           bg)
    cs = side.result(phase) if side is not None else None
    if cs is not None:
        h_host, loss_host, host_s = cs["h_host"], cs["loss_host"], cs["s"]
        extra_host = {}
    else:
        h_host, loss_host, host_s, extra_host = family_forward(torch, cfg2,
                                                               pc, bc)
    hidden_err, hidden_ok = max_err(torch, h_card, h_host)
    loss_rel = abs(loss_card - loss_host) / abs(loss_host)
    del h_card, h_host
    forward_s = time.perf_counter() - t0

    decode = None
    if decode_at is not None:
        t0 = time.perf_counter()
        with torch.inference_mode():
            cg = gpu.init_cache(1, decode_max_len)
            cc = cpu.init_cache(1, decode_max_len)
            if decode_at[0] > 0:  # a history the steps continue
                gen = torch.Generator().manual_seed(7)
                for a, b in zip(cache_leaves(cg), cache_leaves(cc)):
                    b.copy_(torch.randn(b.shape, generator=gen))
                    a.copy_(b)
            logits_err, cache_err, ok = 0.0, 0.0, True
            for i, pos in enumerate(range(*decode_at)):
                tok = bc["tokens"][:, i % text_len:i % text_len + 1]
                lg, cg = gpu.decode(pg, cg, {"tokens": tok.cuda(),
                                             "pos": pos, **extra_card})
                lc, cc = cpu.decode(pc, cc, {"tokens": tok, "pos": pos,
                                             **extra_host})
                e, good = max_err(torch, lg, lc, scaled=True)
                logits_err, ok = max(logits_err, e), ok and good
                for a, b in zip(cache_leaves(cg), cache_leaves(cc)):
                    e, good = max_err(torch, a, b)
                    cache_err, ok = max(cache_err, e), ok and good
        decode = {"positions": list(decode_at), "max_len": decode_max_len,
                  "caches_from_seed": decode_at[0] > 0,
                  "logits_max_abs_err": logits_err,
                  "logits_tolerance": f"atol {PARITY_TOL} x max(1, "
                                      f"max|logits|), rtol {PARITY_TOL}",
                  "cache_max_abs_err": cache_err, "ok": ok,
                  "s": time.perf_counter() - t0}
        del cg, cc
    del extra_card, extra_host

    row = None
    models = [gpu, cpu, pg, pc]  # the train step starts from these weights
    del gpu, cpu, pg, pc
    if train:
        t0 = time.perf_counter()
        row = card_vs_cpu_steps(torch, cfg2, 1, train_len or text_len,
                                models, first=cs and cs["first"])[0]
        row["s"] = time.perf_counter() - t0
    side_s = side.seconds[phase] if cs is not None else None
    del models, cs
    gc.collect()
    torch.cuda.empty_cache()
    ok = (hidden_ok and loss_rel <= STEP_TOL["loss_rel"] and
          (decode is None or decode["ok"]) and (row is None or row["ok"]))
    emit({"phase": phase, "arch": cfg2.name, "n_layers": cfg2.n_layers,
          "compute_dtype": cfg2.dtype, "batch": 1, "seq": text_len,
          "patches": cfg2.vlm.n_patches if cfg2.vlm is not None else 0,
          "frames": cfg2.encdec.n_frames if cfg2.encdec is not None else 0,
          "enc_layers": (cfg2.encdec.n_enc_layers if cfg2.encdec is not None
                         else 0),
          "hidden_max_abs_err": hidden_err,
          "tolerance": {"hidden": PARITY_TOL, "loss_rel":
                        STEP_TOL["loss_rel"]},
          "loss": [loss_card, loss_host], "loss_rel_err": loss_rel,
          "decode": decode, "train_step": row,
          "train_seq": (train_len or text_len) if train else None,
          "forward_s": {"card": card_s, "cpu": host_s, "phase": forward_s},
          "cpu_side_s": side_s, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: the card's model disagrees with the "
                             "CPU port's (see the line above)")


def family_train(torch, phase: str, cfg, batch: int, seq: int,
                 spy_calls: list, reduced: str) -> dict[str, int]:
    """``cfg`` through ``make_train_step`` (float32 parameters, bf16
    compute, remat as the config has it) on ``make_batch(cfg, batch, seq,
    step)``: a warm-up step and three timed ones, each with finite loss and
    grad_norm and with the flash launches ``spy_calls`` (the (window, hd,
    causal) of each attention call of a step, remat's recompute
    included) gives: that many forward launches, and one backward launch
    for each call of the forward pass.  Returns the launches of the run."""
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    opt = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig())
    batches = [make_batch(cfg, batch, seq, i, device="cuda")
               for i in range(4)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    want = sorted(spy_calls)
    n_fwd = len(want)
    n_bwd = n_fwd // 2 if cfg.remat else n_fwd

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    steps = []
    with attention_spy(torch) as calls:
        for i in range(4):  # one warm-up step, three timed
            fwd = LAUNCHES["flash_attention"]
            bwd = LAUNCHES["flash_attention_bwd"]
            seen = len(calls)
            a = time.perf_counter()
            params, opt, met = step_fn(params, opt, batches[i])
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            steps.append({"step": i, "s": time.perf_counter() - a,
                          "loss": loss, "grad_norm": gnorm,
                          "flash_fwd": LAUNCHES["flash_attention"] - fwd,
                          "flash_bwd": LAUNCHES["flash_attention_bwd"] - bwd})
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"{phase} step {i}: loss {loss}, "
                                     f"grad_norm {gnorm}")
            if steps[-1]["flash_fwd"] != n_fwd or \
                    steps[-1]["flash_bwd"] != n_bwd or \
                    sorted(calls[seen:]) != want:
                raise AssertionError(
                    f"{phase} step {i}: flash launches {steps[-1]} with "
                    f"(window, hd, causal) {Counter(calls[seen:])}, expected "
                    f"{n_fwd} forward ({Counter(want)}) and {n_bwd} "
                    "backward")
    steps_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    step_s = float(np.mean([r["s"] for r in steps[1:]]))
    tokens = batch * seq
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "hd": cfg.hd, "param_dtype": cfg.param_dtype,
          "compute_dtype": cfg.dtype, "remat": cfg.remat, "params": n_params,
          "batch": batch, "seq": seq,
          "frames": cfg.encdec.n_frames if cfg.encdec is not None else 0,
          "reduced": reduced, "allocated_before_bytes": allocated_before,
          "steps": steps, "step_s": step_s, "tokens_per_s": tokens / step_s,
          "flash_launches_per_step": {
              "forward": n_fwd, "backward": n_bwd,
              "calls": {str(k): v for k, v in Counter(want).items()}},
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches,
          "walls": {"init_s": init_s, "steps_s": steps_s}})
    del params, opt, model, batches, step_fn, met
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_audio(torch) -> dict[str, int]:
    """whisper-tiny at full size, bf16 weights from seed 0, through the
    port's entry points: prefill (``model.loss`` on AUDIO = 16 rows of 1,500
    frames and 448 text tokens under ``torch.inference_mode()``, one cold
    call and three warm, each with 12 flash_attention launches: 4 encoder
    non-causal, 4 decoder causal, 4 cross), ``whisper_encode`` of 8 rows
    alone, decode (``make_serve_step`` over ``batch["enc"]``: batch 8,
    max_len 128, 16 steps, 4 batches, 4 cross launches a step), a profiled
    prefill and decode batch.  Returns the launches of the run."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch, zipf_tokens
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import make_serve_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.whisper import whisper_encode

    cfg = get_config(AUDIO_ARCH)
    walls: dict[str, float] = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0, dtype=torch.bfloat16)
    batch = make_batch(cfg, *AUDIO, 0, device="cuda")
    torch.cuda.synchronize()
    walls["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    n_enc, n_dec = cfg.encdec.n_enc_layers, cfg.n_layers
    frames = cfg.encdec.n_frames
    want = sorted([(0, cfg.hd, False)] * (n_enc + n_dec) +
                  [(0, cfg.hd, True)] * n_dec)
    per_call = len(want)
    positions = AUDIO[0] * (frames + AUDIO[1])

    # the main path: counts set to 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    losses, prefill_s = [], []
    with attention_spy(torch) as calls:
        for i in range(4):  # one cold call, three warm
            before, seen = LAUNCHES["flash_attention"], len(calls)
            a = time.perf_counter()
            with torch.inference_mode():  # prefill: no autograd, no remat
                loss = float(model.loss(params, batch))
            prefill_s.append(time.perf_counter() - a)
            losses.append(loss)
            launched = LAUNCHES["flash_attention"] - before
            if launched != per_call or sorted(calls[seen:]) != want:
                raise AssertionError(
                    f"audio prefill call {i}: {launched} flash_attention "
                    f"launches with (window, hd, causal) "
                    f"{Counter(calls[seen:])}, expected {Counter(want)}")
            if not math.isfinite(loss):
                raise AssertionError(f"audio prefill call {i}: loss {loss}")
    walls["prefill_s"] = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    warm_s = float(np.mean(prefill_s[1:]))

    # the encoder alone on the decode batch's 8 rows
    t0 = time.perf_counter()
    with torch.inference_mode():
        rows8 = batch["frames"][:8]
        encode_ms = time_ms(torch, lambda: whisper_encode(params, rows8, cfg),
                            10)
        enc = whisper_encode(params, rows8, cfg)
    walls["encode_s"] = time.perf_counter() - t0

    # decode: the reference's serve loop has no encoder input, so the
    # decode step is driven as tests/test_archs_smoke.py drives it
    t0 = time.perf_counter()
    serve = make_serve_step(model)
    rng = np.random.default_rng(0)
    times, tokens_ok = [], True

    def decode_batch(steps: int) -> None:
        nonlocal tokens_ok
        cache = model.init_cache(8, 128)
        tok = torch.from_numpy(zipf_tokens(rng, cfg.vocab_size, (8, 1))
                               .astype(np.int64)).cuda()
        for pos in range(steps):
            nxt, cache = serve(params, cache, {"enc": enc, "tokens": tok,
                                               "pos": pos})
            tok = nxt[:, None]
        torch.cuda.synchronize()
        tokens_ok = tokens_ok and bool(((tok >= 0) &
                                        (tok < cfg.vocab_size)).all())

    before = LAUNCHES["flash_attention"]
    for _ in range(4):
        a = time.perf_counter()
        decode_batch(16)
        times.append(time.perf_counter() - a)
    decode_launches = LAUNCHES["flash_attention"] - before
    walls["decode_s"] = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if decode_launches != 4 * 16 * n_dec or not tokens_ok:
        raise AssertionError(f"audio decode: {decode_launches} flash "
                             f"launches (expected {4 * 16 * n_dec}: "
                             f"{n_dec} cross a step), tokens in range "
                             f"{tokens_ok}")
    decode_tps = 8 * 16 / float(np.mean(times[1:]))  # serve.py's formula

    t0 = time.perf_counter()
    prefill_prof = profile_run(torch, torch.inference_mode()(
        lambda: model.loss(params, batch)))
    decode_prof = profile_run(torch, lambda: decode_batch(4))
    busy = {}
    for what, prof in (("prefill B=%d %d frames + %d tokens" %
                        (AUDIO[0], frames, AUDIO[1]), prefill_prof),
                       ("decode batch 8 x 4 steps", decode_prof)):
        busy[what.split()[0]] = 1 - prof["idle_share"]
        emit({"phase": "audio-profile", "what": what,
              **{k: v for k, v in prof.items() if k != "port_kernels_ms"},
              "busy_share": 1 - prof["idle_share"]})
    walls["profile_s"] = time.perf_counter() - t0
    emit({"phase": "audio", "arch": cfg.name, "family": cfg.family,
          "n_layers": n_dec, "n_enc_layers": n_enc, "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.n_kv_heads], "hd": cfg.hd,
          "vocab": cfg.vocab_size, "weights_dtype": "bfloat16",
          "params": n_params, "dec_pos_rows": int(params.dec_pos.shape[0]),
          "prefill": {"batch": AUDIO[0], "frames": frames,
                      "text": AUDIO[1], "positions": positions,
                      "cold_s": prefill_s[0], "warm_s": prefill_s[1:],
                      "warm_positions_per_s": positions / warm_s,
                      "warm_text_tokens_per_s": AUDIO[0] * AUDIO[1] / warm_s,
                      "loss": losses, "busy_share": busy["prefill"],
                      "flash_launches_per_call": per_call,
                      "calls": {str(k): v for k, v in Counter(want).items()},
                      "max_memory_allocated": prefill_peak},
          "encode": {"batch": 8, "frames": frames, "ms": encode_ms,
                     "frames_per_s": 8 * frames / encode_ms * 1e3},
          "decode": {"batch": 8, "max_len": 128, "steps": 16, "batches": 4,
                     "batch_s": times, "steady_tok_per_s": decode_tps,
                     "busy_share": busy["decode"],
                     "flash_launches": decode_launches,
                     "cross_launches_per_step": n_dec},
          "launches": launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "walls": walls})
    del params, batch, model, enc, rows8
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def hybrid_parity_cfg():
    """hybrid-parity's config, forward length and train length: one group
    (3 layers) of recurrentgemma-2b at full width in float32; T = 4096 so
    the window cuts in (its decode crosses the ring's wrap, 2048 slots,
    from caches filled from a seed); the train step on window + 256
    tokens, where the window still cuts in (the CPU port's backward at
    T=4096 takes ~110 s of the card's host)."""
    import dataclasses

    from repro_torch.configs import get_config

    hybrid = get_config(HYBRID_ARCH)
    return (dataclasses.replace(hybrid, n_layers=3, dtype="float32"),
            PREFILL[1], hybrid.hybrid.window + 256)


def phase_families(torch, side: "SideProcess") -> dict[str, int]:
    """The ssm, hybrid, vlm and audio families on the card (phases ssm,
    ssm-parity, hybrid, hybrid-parity, hybrid-train, vlm, vlm-parity,
    audio, audio-parity, audio-train); returns the flash_attention
    launches of the hybrid, vlm and audio prefill paths (the audio decode's
    too) and the flash_attention_bwd launches of the hybrid and audio
    train steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.common import EncDecConfig

    walls: dict[str, float] = {}
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    t0 = time.perf_counter()
    family_serving(torch, "ssm", SSM_ARCH, PREFILL[1], 0)
    phase_ssm_train(torch)
    walls["ssm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    family_parity(torch, "ssm-parity",
                  dataclasses.replace(get_config(SSM_ARCH), n_layers=2,
                                      dtype="float32"),
                  520, (0, 24), 64, train=True)
    walls["ssm_parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hybrid = get_config(HYBRID_ARCH)
    launches["flash_attention"] += family_serving(
        torch, "hybrid", HYBRID_ARCH, PREFILL[1], hybrid.n_layers // 3,
        window=hybrid.hybrid.window)["flash_attention"]
    walls["hybrid_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg2, text_len, train_len = hybrid_parity_cfg()
    w = hybrid.hybrid.window
    family_parity(torch, "hybrid-parity", cfg2, text_len, (w - 8, w + 8),
                  2 * w, train=True, train_len=train_len, side=side)
    walls["hybrid_parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # all 26 layers: remat runs each group's windowed attention twice
    ng = hybrid.n_layers // 3
    launches["flash_attention_bwd"] += family_train(
        torch, "hybrid-train", hybrid, *TRAIN,
        [(w, hybrid.hd, True)] * (2 * ng),
        "train_4k global batch 256 -> 1 (one card)")["flash_attention_bwd"]
    walls["hybrid_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vlm = get_config(VLM_ARCH)
    launches["flash_attention"] += family_serving(
        torch, "vlm", VLM_ARCH, PREFILL[1] - vlm.vlm.n_patches,
        vlm.n_layers)["flash_attention"]
    walls["vlm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    family_parity(torch, "vlm-parity",
                  dataclasses.replace(vlm, n_layers=2, dtype="float32"),
                  264, None, 0, train=True)
    walls["vlm_parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["flash_attention"] += phase_audio(torch)["flash_attention"]
    walls["audio_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    audio = get_config(AUDIO_ARCH)
    # 2 encoder and 2 decoder layers at full width, all 1,500 frames
    family_parity(torch, "audio-parity",
                  dataclasses.replace(audio, n_layers=2, dtype="float32",
                                      encdec=EncDecConfig(n_enc_layers=2,
                                                          n_frames=1500)),
                  AUDIO[1], (0, 16), 32, train=True)
    walls["audio_parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hd = audio.hd
    layer_calls = ([(0, hd, False)] * (audio.encdec.n_enc_layers +
                                       audio.n_layers) +
                   [(0, hd, True)] * audio.n_layers)
    launches["flash_attention_bwd"] += family_train(
        torch, "audio-train", audio, *AUDIO, 2 * layer_calls,
        "none: whisper-tiny at full size, B=16 x (1,500 frames + 448 "
        "tokens)")["flash_attention_bwd"]
    walls["audio_train_s"] = time.perf_counter() - t0
    emit({"phase": "families-walls", **walls})
    return launches


# ------------------------------------------------------------ phase 7
def phase_startup(torch, lubm: dict) -> None:
    """benchmarks/bench_startup.py's rows (paper Table 9) with the port at
    W = 16 on phase 2's LUBM-100 triples (4.74 M; the bench's own
    6,648-triple graph takes milliseconds and puts no work on the card):
    seconds of hash on subject, random and ``mincut_lite`` (8 passes) on
    the host, ``mincut_lite``'s edge cut, and the port's ``AdHashEngine``
    bootstrap on the card, whose answers to phase 2's 60 queries equal
    phase 2's (held there to a CPU engine)."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.core.partition import (edge_cut, mincut_lite,
                                            partition_by_subject,
                                            partition_random)

    w = 16
    triples, queries = lubm["triples"], lubm["queries"]
    n_ids = int(triples.max()) + 1
    t0 = time.perf_counter()
    partition_by_subject(triples, w)
    subj_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    partition_random(triples, w)
    rand_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    a_cut = mincut_lite(triples, w, n_ids=n_ids, passes=8)
    cut_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = AdHashEngine(triples, w, adaptive=False, device="cuda")
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    label = np.zeros(n_ids, dtype=np.int32)
    label[triples[:, 0]] = a_cut
    cut = edge_cut(triples, label)
    # the answers only: comm_cells and mode depend on W
    check_answers("startup", queries, [eng.query(q) for q in queries],
                  [(want, None, None) for want, _, _ in lubm["ref"]])
    emit({"phase": "startup", "triples": int(len(triples)), "workers": w,
          "ids": n_ids, "hash_subj_s": subj_s, "random_s": rand_s,
          "mincut_lite_s": cut_s, "mincut_lite_edge_cut": cut,
          "mincut_over_hash_subj": cut_s / subj_s,
          "engine_bootstrap_s": boot_s,
          "answers_equal_phase2": len(queries)})
    if not cut_s > 5 * subj_s:  # the Table 9 gap, qualitatively
        raise AssertionError(f"startup: mincut_lite {cut_s} s is not 5x "
                             f"hash on subject {subj_s} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {root} holds no src/repro_torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    watch = MemoryWatch()
    # the parity phases' CPU side runs beside the card phases from here
    side = SideProcess()
    watch.children.append(side.proc)
    try:
        return run(torch, smi, side, watch)
    finally:
        side.close()


def run(torch, smi: str, side: SideProcess, watch: MemoryWatch) -> int:
    """The phases, in order, then the kernels line and the last line."""
    from repro_torch.data.synthetic_rdf import (Workload, lubm_like,
                                                zipf_skew, zipf_workload)
    from repro_torch.kernels import build, tuning

    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    table = build.built_table()  # the tuned table this build used
    emit({"phase": "setup", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "tmp": tmp_dir_info(),
          "host_memory_gib": host_memory(),
          "tuned": {"platform": tuning.BUILD_PLATFORM, "table": table,
                    "defines": build.defines(table),
                    "tiles": build.tiles()._asdict()}})
    for line in build.build_log().splitlines():
        if "spill" in line or "registers" in line:
            print(line.strip(), file=sys.stderr)

    walls = {}
    t0 = time.perf_counter()
    skew_in = skew_rebalance_input()
    lap(side, walls, "skew_input_s", t0)
    side.wait_card()  # phase 1 times the kernels with the card to itself
    t0 = time.perf_counter()
    rows = phase_kernels(torch, skew_in)
    rows["flash_attention"] = phase_flash(torch)
    phase_flash_window(torch)
    phase_flash_window(torch, FLASH_AUDIO_SHAPES, seed=2)
    rows["flash_attention_bwd"] = phase_flash_bwd(torch)
    lap(side, walls, "kernels_s", t0)
    t0 = time.perf_counter()
    lubm = phase_lubm(torch)
    launches = lubm["launches"]
    parity_card = lubm.pop("parity_card")
    lap(side, walls, "lubm_s", t0)
    t0 = time.perf_counter()
    phase_lubm_batch(torch, lubm)
    lap(side, walls, "lubm_batch_s", t0)
    del lubm["eng"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_startup(torch, lubm)
    lap(side, walls, "startup_s", t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    twin = phase_lubm_adaptive(torch, lubm)
    lap(side, walls, "lubm_adaptive_s", t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d, triples = lubm_like(2, 2, 2, 2)
    phase_card_parity(torch, "adaptive-parity", triples,
                      Workload(d, seed=0).sample(40), 4,
                      frequency_threshold=2)
    lap(side, walls, "adaptive_parity_s", t0)
    t0 = time.perf_counter()
    # the reference tests' skew shape (tests/test_recovery.py)
    phase_card_parity(
        torch, "skew-parity",
        zipf_skew(n_subjects=64, n_triples=4000, n_objects=64,
                  n_predicates=8, exponent=1.8, seed=0),
        zipf_workload(40, n_subjects=64, n_predicates=8, exponent=1.8,
                      seed=1), 4,
        frequency_threshold=3, skew_threshold=1.2, placement="directory")
    lap(side, walls, "skew_parity_s", t0)
    t0 = time.perf_counter()
    skew = phase_skew(torch, skew_in)
    del skew_in
    lap(side, walls, "skew_s", t0)
    t0 = time.perf_counter()
    phase_lubm_directory(torch, lubm)
    lap(side, walls, "lubm_directory_s", t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_serve_parity(torch)
    lap(side, walls, "serve_parity_s", t0)
    t0 = time.perf_counter()
    phase_serve(torch, lubm)
    lap(side, walls, "serve_s", t0)
    mesh_in = {"twin": twin, **{k: lubm[k] for k in ("triples", "queries",
                                                      "ref", "warm_qps")}}
    del lubm, twin
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_recovery(torch, skew)
    lap(side, walls, "recovery_s", t0)
    del skew
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_mesh(torch, mesh_in)
    lap(side, walls, "mesh_s", t0)
    del mesh_in
    t0 = time.perf_counter()
    phase_mesh2(torch)
    lap(side, walls, "mesh2_s", t0)
    t0 = time.perf_counter()
    phase_scale(torch)
    lap(side, walls, "scale_s", t0)
    t0 = time.perf_counter()
    check_lubm_parity(parity_card, side)
    del parity_card
    lap(side, walls, "lubm_parity_s", t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches["flash_attention"] = phase_lm(torch)["flash_attention"]
    lap(side, walls, "lm_s", t0)
    t0 = time.perf_counter()
    # the backward's launches are the train path's (the forward's stay
    # prefill's: the LM serving path)
    train_launches = phase_train(torch)
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    lap(side, walls, "train_s", t0)
    t0 = time.perf_counter()
    # the moe path's own launches join the dense path's
    launches["flash_attention"] += phase_moe(torch)["flash_attention"]
    lap(side, walls, "moe_s", t0)
    t0 = time.perf_counter()
    phase_moe_parity(torch, side)
    lap(side, walls, "moe_parity_s", t0)
    t0 = time.perf_counter()
    moe_train = phase_moe_train(torch)
    launches["flash_attention_bwd"] += moe_train["flash_attention_bwd"]
    lap(side, walls, "moe_train_s", t0)
    t0 = time.perf_counter()
    # the train CLI's mesh path: its forward and backward launches join
    train_mesh = phase_train_mesh(torch, moe_train["tokens_per_s"])
    for name in ("flash_attention", "flash_attention_bwd"):
        launches[name] += train_mesh[name]
    lap(side, walls, "train_mesh_s", t0)
    t0 = time.perf_counter()
    # both ranks' launches on the card join the mesh train path's
    train_mesh2 = phase_train_mesh2(torch)
    for name in ("flash_attention", "flash_attention_bwd"):
        launches[name] += train_mesh2[name]
    lap(side, walls, "train_mesh2_s", t0)
    t0 = time.perf_counter()
    # the hybrid's windowed, the vlm's and the audio prefill launches join
    # the others, the hybrid and audio train steps' backward launches too
    family_launches = phase_families(torch, side)
    for name in ("flash_attention", "flash_attention_bwd"):
        launches[name] += family_launches[name]
    lap(side, walls, "families_s", t0)
    walls["side"] = {"moved": SIDE_JOBS, "threads": side.threads,
                     "seconds": side.seconds, "waited_s": side.waited,
                     "waited_card_s": side.waited_card}
    walls["host_memory"] = {**host_memory(),
                            "least_available_gib": watch.least,
                            "by_phase": "[rss, available] after each phase"}
    emit({"phase": "walls", **walls})

    sources = {"range_search": ("probe.cu",
                                "src/repro/kernels/semijoin/semijoin.py:57"),
               "expand": ("expand.cu",
                          "src/repro/kernels/relalg_ops/expand.py:73"),
               "bucket_by_dest": ("bucket.cu",
                                  "src/repro/kernels/relalg_ops/bucket.py:72"),
               "unique_compact": ("compact.cu",
                                  "src/repro/kernels/relalg_ops/compact.py:72"),
               # the main path runs the bf16 kernel; f32 runs flash_attn.cu
               "flash_attention": (
                   "flash_attn_sm90.cu",
                   "src/repro/kernels/flash_attention/flash_attention.py:76"),
               # no TPU kernel: the reference differentiates _blocked_attn;
               # the main path runs the bf16 kernel, f32 runs flash_attn_bwd.cu
               "flash_attention_bwd": (
                   "flash_attn_bwd_sm90.cu",
                   "src/repro/models/attention.py:62")}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{src}", "replaces": tpu,
         "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["kernel_ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"]}
        for name, (src, tpu) in sources.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
