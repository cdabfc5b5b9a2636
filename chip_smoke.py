#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100.  It
builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (five
kernels; flash_attention has a bf16 tensor-core and an f32 CUDA-core one),
holds each against its plain PyTorch version on the card, drives the port's
main paths -- the RDF engine on a LUBM-style graph (``query`` with
``adaptive=False``, ``query_batch``, and the adaptive engine through both),
directory placement with hot-key rebalancing on a Zipf hub graph and on
LUBM, the online serving front end (``repro_torch.serving``) over the
adaptive engine, master recovery from a checkpoint, the multi-device
substrate (W split over ``torch.distributed`` ranks: NCCL at world size 1,
two gloo ranks on the card), a 32 M-triple Zipf stream, and the dense LM's serving path (prefill and decode of llama3-8b) -- checks the
answers, and prints one JSON line per phase.  Any mismatch or
exception exits non-zero; without a card it exits 1 before doing anything.

Phases:
  0 setup   card name and power limit, kernel build seconds
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
            shape phase 4's prefill gives it (B=4, T=S=4096), variants,
            and 32k rows in bf16 and f32; each DSJ kernel's main row again
            folded as query_batch folds a bucket of 16 queries (128 rows,
            or 16x the probes a row, phase 2b's census); bucket_by_dest at
            the two shapes directory placement adds: phase 2f's rebalance
            (k = 3, the hash store's 4,713,095-row shards routed by
            triple_dest into cap_peer = 2^21, built on the host before
            phase 1 from the same triples; ``skew-bucket-mix`` prints its
            mix) and the LUBM hash exchange fanned out 8 ways (k = 1,
            n = 8 x 2^20, only replica 0 valid); kernel, plain and
            library-call medians over CUDA events, and the roofline bound
  2 lubm    lubm_like(100, 20, 30, 12, 2) (~4.74 M triples) on 8 workers:
            startup, store bytes, peak memory, 60 workload queries (all six
            templates), each kernel's launch count on that run and, by
            shape, each DSJ kernel's (the census), warm qps and
            per-template p50/p99, a warm chain query's host syncs, a
            profiled warm pass per template (device busy time, idle share,
            top kernels, each DSJ kernel's device time), in a pass of its
            own the mix each bucket_by_dest shape gets (valid share, valid
            prefix, destinations in order), and two queries per template
            held against a device="cpu" engine
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
  3 scale   generate_stream(32_000_000, 2^20) streamed in: time to online,
            time to first answer, live/padded store bytes, 32 zipf queries,
            4 of them checked against a numpy scan of the same stream
  4 lm      llama3-8b at full width and depth, bf16 weights from seed 0:
            prefill (``model.loss`` on B=4, T=4096) cold and 3x warm, with
            32 flash_attention launches per call; a 2-layer full-width
            prefill (B=1, T=520) held against the CPU port; decode
            (``serve_loop``: batch 8, max_len 128, 16 steps, 4 batches)
            with the adaptive controller
Each path's kernels must launch on that path's run (the DSJ kernels on
LUBM, on the directory engines and on the mesh; on a served stream probe and
``expand`` always, all four once a staged answer was served;
flash_attention on the LM).  Each phase prints its wall seconds.  The line before the last holds every kernel's
numbers; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
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
PREFILL = (4, 4096)  # llama3-8b prefill batch and length in phase 4
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
    """flash_attention vs its plain version at llama3-8b's attention shapes
    and variants; returns the main row, the shape phase 4's prefill gives
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
    ]
    for variant, b, t, h, kv, hd, dt, causal in shapes:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                         dtype=torch.float32).to(dt)
        q, k, v = rnd(b, t, h, hd), rnd(b, t, kv, hd), rnd(b, t, kv, hd)
        long_row = t > 8192
        with torch.inference_mode():
            got = flash_attention_cuda(q, k, v, causal=causal)
            torch.cuda.synchronize()
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
               else "all",
               "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention(enable_gqa=True)",
               "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_moved,
               "ops": flops, "tflops": flops / ms / 1e9}
        emit(row)
        if main_row is None:
            main_row = row
        del q, k, v, qt, kt, vt
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
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    self_us = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)
    busy = sum(self_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=self_us, reverse=True)[:5]
    port = {name: sum(self_us(e) for e in kernels
                      if any(part in e.key for part in parts)) / 1e3
            for name, parts in PORT_KERNELS.items()}
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "kernel_kinds": len(kernels),
            "top": [{"kernel": e.key[:60], "ms": self_us(e) / 1e3,
                     "calls": e.count} for e in top],
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
    d, triples = lubm_like(100, 20, 30, 12, 2)
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

    # where the device time goes, per template (profiler on: wall times
    # here include its overhead; the warm numbers above are without it)
    for name in names:
        picked = [q for q in queries if q.name == name]
        emit({"phase": "lubm-profile", "template": name,
              "queries": len(picked),
              **profile_run(torch, lambda: [eng.query(q) for q in picked])})

    # the mix each bucket_by_dest shape gets, in a pass of its own
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

    # two queries per template against a CPU engine on the same triples
    cpu = AdHashEngine(triples, W, adaptive=False, device="cpu")
    checked: dict[str, int] = {}
    for q, (rel, st) in zip(queries, cold):
        if checked.get(q.name, 0) >= 2:
            continue
        rel_c, st_c = cpu.query(q)
        got = (rel.to_set(), st.comm_cells, st.mode, st.route, st.n_retries)
        want = (rel_c.to_set(), st_c.comm_cells, st_c.mode, st_c.route,
                st_c.n_retries)
        if got != want:
            raise AssertionError(f"{q.name}: gpu {got[1:]} rows "
                                 f"{len(got[0])} != cpu {want[1:]} rows "
                                 f"{len(want[0])}")
        checked[q.name] = checked.get(q.name, 0) + 1
    emit({"phase": "lubm-parity", "checked": checked,
          "equal": ["to_set", "comm_cells", "mode", "route", "n_retries"]})
    ref = [(canon(rel, q), st.comm_cells, st.mode)
           for q, (rel, st) in zip(queries, cold)]
    return {"launches": launches, "warm_launches": warm_launches,
            "warm_qps": len(queries) / warm_s, "eng": eng, "d": d,
            "triples": triples, "queries": queries, "ref": ref}


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

    def counting():
        calls[0] += 1
        return original()

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


def phase_scale(torch) -> None:
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import generate_stream, zipf_workload
    from repro_torch.kernels import LAUNCHES, reset_launches

    n_triples, chunk = 32_000_000, 1 << 20
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
          **profile_run(torch, lambda: model.loss(params, batch))})
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
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()

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
    from repro_torch.data.synthetic_rdf import (Workload, lubm_like,
                                                zipf_skew, zipf_workload)
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.library()
    emit({"phase": "setup", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0})
    for line in build.build_log().splitlines():
        if "spill" in line or "registers" in line:
            print(line.strip(), file=sys.stderr)

    walls = {}
    t0 = time.perf_counter()
    skew_in = skew_rebalance_input()
    walls["skew_input_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = phase_kernels(torch, skew_in)
    rows["flash_attention"] = phase_flash(torch)
    walls["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lubm = phase_lubm(torch)
    launches = lubm["launches"]
    walls["lubm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_lubm_batch(torch, lubm)
    walls["lubm_batch_s"] = time.perf_counter() - t0
    del lubm["eng"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    twin = phase_lubm_adaptive(torch, lubm)
    walls["lubm_adaptive_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d, triples = lubm_like(2, 2, 2, 2)
    phase_card_parity(torch, "adaptive-parity", triples,
                      Workload(d, seed=0).sample(40), 4,
                      frequency_threshold=2)
    walls["adaptive_parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the reference tests' skew shape (tests/test_recovery.py)
    phase_card_parity(
        torch, "skew-parity",
        zipf_skew(n_subjects=64, n_triples=4000, n_objects=64,
                  n_predicates=8, exponent=1.8, seed=0),
        zipf_workload(40, n_subjects=64, n_predicates=8, exponent=1.8,
                      seed=1), 4,
        frequency_threshold=3, skew_threshold=1.2, placement="directory")
    walls["skew_parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    skew = phase_skew(torch, skew_in)
    del skew_in
    walls["skew_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_lubm_directory(torch, lubm)
    walls["lubm_directory_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_serve_parity(torch)
    walls["serve_parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_serve(torch, lubm)
    walls["serve_s"] = time.perf_counter() - t0
    mesh_in = {"twin": twin, **{k: lubm[k] for k in ("triples", "queries",
                                                      "ref", "warm_qps")}}
    del lubm, twin
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_recovery(torch, skew)
    walls["recovery_s"] = time.perf_counter() - t0
    del skew
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_mesh(torch, mesh_in)
    walls["mesh_s"] = time.perf_counter() - t0
    del mesh_in
    t0 = time.perf_counter()
    phase_mesh2(torch)
    walls["mesh2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_scale(torch)
    walls["scale_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches["flash_attention"] = phase_lm(torch)["flash_attention"]
    walls["lm_s"] = time.perf_counter() - t0
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
                   "src/repro/kernels/flash_attention/flash_attention.py:76")}
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
