#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100.  It
builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (five
kernels; flash_attention has a bf16 tensor-core and an f32 CUDA-core one),
holds each against its plain PyTorch version on the card, drives the port's
two main paths -- the RDF engine (``AdHashEngine(...).query(q)`` with
``adaptive=False``) on a LUBM-style graph and on a 32 M-triple Zipf stream,
and the dense LM's serving path (prefill and decode of llama3-8b) --
checks the answers, and prints one JSON line per phase.  Any mismatch or
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
            and 32k rows in bf16 and f32; kernel, plain and library-call
            medians over CUDA events, and the roofline bound
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
LUBM, flash_attention on the LM).  Each phase prints its wall seconds.
The line before the last holds every kernel's numbers; the last line is
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


def bucket_bytes(vals, valid, n_dest: int, cap: int) -> int:
    """Bytes bucket_by_dest must move: ``valid`` of every row, ``dest`` and
    ``values`` of the valid rows, all of send and send_valid, max_wanted."""
    w, _, k = vals.shape
    return (valid.size + int(valid.sum()) * (4 + 4 * k) +
            w * n_dest * cap * (4 * k + 1) + 8 * w)


# ------------------------------------------------------------------ phase 1
def phase_kernels(torch) -> dict[str, dict]:
    from repro_torch.core import backend, relalg
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

    # ---- range_search / span_search: the main path's rows (LUBM-100's
    # census, phase 2), then the earlier random rows as variants
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
        del k_t, p_t, q_t, got, want

    # ---- expand: the main path's rows, then the earlier rows as variants
    def check_expand(lo_t, hi_t, cap, tag):
        got = expand_cuda(lo_t, hi_t, cap)
        want = relalg.expand_plain(lo_t, hi_t, cap)
        assert_equal(f"expand valid {tag}", got[2], want[2])
        assert_equal(f"expand total {tag}", got[3], want[3])
        v = want[2]
        assert_equal(f"expand left {tag}", got[0][v], want[0][v])
        return assert_equal(f"expand right_pos {tag}", got[1][v], want[1][v])

    for variant, lo, hi, cap, main in expand_cases():
        lo_t, hi_t = cuda(lo), cuda(hi)
        err = check_expand(lo_t, hi_t, cap, variant)
        w, n = lo.shape
        record("expand", variant, err,
               lambda: expand_cuda(lo_t, hi_t, cap),
               lambda: relalg.expand_plain(lo_t, hi_t, cap), None,
               2 * w * n * 4 + w * cap * 9 + w * 8,
               w * n + w * cap * math.ceil(math.log2(max(n, 2))), main)
        del lo_t, hi_t
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
    for variant, vals, dest, valid, nd, cap, main in bucket_cases():
        v_t, d_t, m_t = cuda(vals), cuda(dest), cuda(valid)
        got = bucket_by_dest_cuda(v_t, d_t, m_t, nd, cap)
        want = relalg.bucket_by_dest_plain(v_t, d_t, m_t, nd, cap)
        err = 0.0
        for part, g, w_ in zip(("send", "send_valid", "max"), got, want):
            err = max(err, assert_equal(f"bucket_by_dest {part} {variant}",
                                        g, w_))
        if "overflow" in variant and int(got[2].min()) <= cap:
            raise AssertionError("bucket_by_dest: no destination overflowed")
        del got, want
        record("bucket_by_dest", variant, err,
               lambda: bucket_by_dest_cuda(v_t, d_t, m_t, nd, cap),
               lambda: relalg.bucket_by_dest_plain(v_t, d_t, m_t, nd, cap),
               None, bucket_bytes(vals, valid, nd, cap), 4 * vals.shape[0] *
               vals.shape[1], main)
        del v_t, d_t, m_t
    torch.cuda.empty_cache()

    # ---- unique_compact: n = 2^10 (one radix tile) and n = 2^18 (the main
    # path's row, 64 tiles) in int32, and n = 2^18 in int64 (8 digits, the
    # high ones skipped on the device); out_cap below n_unique
    for n, hi_val, cap, dtype in ((1 << 10, 800, 256, np.int32),
                                  (1 << 18, 1 << 17, 1 << 16, np.int32),
                                  (1 << 18, 1 << 17, 1 << 16, np.int64)):
        pad = int(np.iinfo(dtype).max)
        vals = rng.integers(0, hi_val, (W, n)).astype(dtype)
        valid = rng.random((W, n)) < 0.9
        v_t, m_t = cuda(vals), cuda(valid)
        got = unique_compact_cuda(v_t, m_t, cap, pad)
        want = relalg.unique_compact_plain(v_t, m_t, cap, pad)
        err = 0.0
        tag = f"{np.dtype(dtype).name} n=2^{n.bit_length() - 1}"
        for part, g, w_ in zip(("uniq", "mask", "n_unique"), got, want):
            err = max(err, assert_equal(f"unique_compact {part} {tag}", g,
                                        w_))
        if int(got[2].min()) <= cap:
            raise AssertionError("unique_compact: out_cap not below n_unique")
        offs = torch.arange(W, device=dev, dtype=torch.int64)[:, None] << 32
        keyed = torch.where(m_t, v_t, pad).to(torch.int64) + offs
        isz = np.dtype(dtype).itemsize
        record("unique_compact", f"{tag} out_cap={cap}", err,
               lambda: unique_compact_cuda(v_t, m_t, cap, pad),
               lambda: relalg.unique_compact_plain(v_t, m_t, cap, pad),
               lambda: torch.unique(keyed.view(-1), sorted=True),
               W * n * (isz + 1) + W * cap * (isz + 1) + W * 8,
               W * n * max(1, math.ceil(math.log2(n))),
               n == 1 << 18 and dtype == np.int32)
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
    """Counts the DSJ wrappers' launches by shape while open: the four
    wrapper functions are replaced by counting ones in their modules (the
    core modules import them at each call) and put back on exit."""
    from repro_torch.kernels.relalg_ops import bucket, compact, expand
    from repro_torch.kernels.semijoin import probe

    counts: Counter = Counter()

    def probe_shape(name):
        return lambda keys, probes, *_: (
            name, ("N", keys.shape[1]), ("M", probes.shape[1]),
            ("dtype", str(keys.dtype).split(".")[1]))

    shapes = {
        (probe, "range_search_cuda"): probe_shape("range_search"),
        (probe, "span_search_cuda"): probe_shape("span_search"),
        (expand, "expand_cuda"): lambda lo, hi, out_cap: (
            "expand", ("n", lo.shape[1]), ("out_cap", out_cap)),
        (bucket, "bucket_by_dest_cuda"):
            lambda values, dest, valid, n_dest, cap_peer, *_: (
                "bucket_by_dest", ("n", values.shape[1]),
                ("k", values.shape[2]), ("n_dest", n_dest),
                ("cap_peer", cap_peer)),
        (compact, "unique_compact_cuda"): lambda values, valid, out_cap, pad: (
            "unique_compact", ("n", values.shape[1]), ("out_cap", out_cap),
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


def phase_lubm(torch) -> dict[str, int]:
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
    t1 = time.perf_counter()
    for q in queries:
        a = time.perf_counter()
        eng.query(q)
        torch.cuda.synchronize()
        lat[q.name].append(time.perf_counter() - a)
    warm_s = time.perf_counter() - t1

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
    return launches


# ------------------------------------------------------------------ phase 3
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
    rows = phase_kernels(torch)
    rows["flash_attention"] = phase_flash(torch)
    walls["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = phase_lubm(torch)
    walls["lubm_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
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
