"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (the kernels are CUDA C++ and have no
CPU mode) and skips without one.  The file imports torch, numpy and the
port only, so it runs on a machine without jax:

    python -m pytest -m cuda tests/test_torch_cuda.py

The DSJ kernels' outputs are integers and must be bit-exact (valid lanes
only for ``expand``).  The flash_attention kernels are held to their plain
version within 1e-4 (float32: summation order) and 2e-2 (bfloat16 output
rounding), atol = rtol; the bf16 tensor-core cases also within 1e-2 of each
output row's largest magnitude (one bf16 ulp is at most 2^-7 of it).  The
mesh substrate runs over a world-size-1 NCCL group here (one rank: NCCL
takes one rank a card), held to the single substrate and, collective by
collective, to a gloo mesh on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import backend as TB
from repro_torch.core import relalg as TR
from repro_torch.kernels import LAUNCHES

I32MAX = 2**31 - 1
I64MAX = 2**63 - 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _probe_case(kind, dtype, w, n, m, rng):
    """(keys, probes) of one range_search case: sorted keys with duplicates
    and a dtype-max padded tail, probes in the mix ``kind`` names."""
    pad = int(np.iinfo(dtype).max)
    live = n - n // 8
    keys = np.full((w, n), pad, np.int64)
    keys[:, :live] = np.sort(rng.integers(0, 4 * n, (w, live)), axis=1)
    hit = keys[np.arange(w)[:, None], rng.integers(0, max(live, 1), (w, m))]
    probes = np.where(rng.random((w, m)) < 0.5, hit,
                      rng.integers(-5, 4 * n + 5, (w, m)))
    if kind == "ascending":
        probes = np.sort(probes, axis=1)
    elif kind == "padding":  # the reply's mix: a few live probes, ascending,
        n_live = max(1, m // 100)  # then one clamped key in every lane
        live_probes = np.sort(probes[:, :n_live], axis=1)
        probes[:] = keys[:, :1]
        probes[:, :n_live] = live_probes
    elif kind == "odd_lane":  # warps of one probe, one other lane in each
        probes[:] = hit[:, :1]
        probes[:, 5::32] = hit[:, 5::32]
    elif kind == "below":
        probes = keys[:, :1] - 1 - rng.integers(0, 3, (w, m))
    elif kind == "pad":
        probes[:, ::3] = pad
    return keys.astype(dtype), probes.astype(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ascending", "padding",
                                  "odd_lane", "below", "pad"])
@pytest.mark.parametrize("n,m", [(5000, 777), (1, 100), (33, 1), (1000, 5),
                                 (4097, 70000), (100_003, 3000)])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_cuda_range_search_matches_plain(cuda_device, dtype, n, m, kind):
    """Bit-exact at key rows shorter and longer than the sampled stride
    (N not a multiple of it), one probe a worker, and the probe mixes the
    kernel special-cases: warps of one probe (padding), one odd lane, probes
    below every key or equal to the pad, ascending and random orders."""
    rng = np.random.default_rng(n + m + len(kind))
    keys, probes = (torch.from_numpy(a) for a in
                    _probe_case(kind, dtype, 4, n, m, rng))
    before = LAUNCHES["range_search"]
    got = TB.range_search(keys.to(cuda_device), probes.to(cuda_device))
    want = TB.range_search_plain(keys, probes)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    lo_keys, hi_keys = probes, torch.flip(probes, [1])  # q < p in half
    got = TB.span_search(keys.to(cuda_device), lo_keys.to(cuda_device),
                         hi_keys.to(cuda_device))
    want = TB.span_search_plain(keys, lo_keys, hi_keys)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert LAUNCHES["range_search"] == before + 2


@pytest.mark.cuda
def test_cuda_range_search_int32_finalize_shape(cuda_device):
    """finalize_join's probe: int32 keys, N = 2^23 per worker (mostly pad),
    2^20 unsorted probes, about 9% live and the rest equal to the pad."""
    rng = np.random.default_rng(23)
    w, n, m = 2, 1 << 23, 1 << 20
    keys = np.full((w, n), I32MAX, np.int32)
    live = n // 10
    keys[:, :live] = np.sort(rng.integers(0, 1 << 24, (w, live)), axis=1)
    probes = np.where(rng.random((w, m)) < 0.09,
                      rng.integers(0, 1 << 24, (w, m)), I32MAX)
    keys, probes = torch.from_numpy(keys), torch.from_numpy(
        probes.astype(np.int32))
    got = TB.range_search(keys.to(cuda_device), probes.to(cuda_device))
    want = TB.range_search_plain(keys, probes)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_span_search_one_probe(cuda_device):
    """match_ranges' form: one [lo_key, hi_key) span a worker over a store
    row, including an empty span with hi_key < lo_key."""
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(np.sort(rng.integers(0, 1 << 40, (8, 594_575)),
                                    axis=1))
    for a, b in ((1 << 38, 1 << 39), (1 << 39, 1 << 38), (0, I64MAX - 1)):
        lo_k = torch.full((8, 1), a, dtype=torch.int64)
        hi_k = torch.full((8, 1), b, dtype=torch.int64)
        got = TB.span_search(keys.to(cuda_device), lo_k.to(cuda_device),
                             hi_k.to(cuda_device))
        want = TB.span_search_plain(keys, lo_k, hi_k)
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)


def _expand_case(kind, rng):
    """(lo, hi, out_cap) of one expand edge case, W = 3."""
    w = 3
    if kind == "all_zero":
        lo = rng.integers(0, 100, (w, 10_000))
        return lo, lo, 5000
    if kind == "row_over_cap":  # one row's count alone exceeds out_cap
        lo = rng.integers(0, 100, (w, 100))
        hi = lo + rng.integers(0, 3, (w, 100))
        hi[:, 40] = lo[:, 40] + 1_000_000
        return lo, hi, 5000
    if kind == "empty_runs":  # non-empty rows only next to tile borders,
        n = 3 * 4096 + 17    # their lanes crossing lane blocks of 2048
        lo = rng.integers(0, 1000, (w, n))
        hi = lo.copy()
        for r in (0, 4095, 4096, 8191, 8192, n - 1):
            hi[:, r] = lo[:, r] + rng.integers(1000, 3000)
        return lo, hi, 1 << 14
    if kind == "first_lane_at_cap":  # row 7 starts exactly at out_cap
        lo = np.zeros((w, 20), np.int64)
        hi = np.full((w, 20), 3)
        hi[:, 3] = 0
        return lo, hi, 7 * 3 - 3
    if kind == "ragged_cap":  # out_cap not a multiple of a lane block
        lo = rng.integers(0, 1 << 20, (w, 5000))
        return lo, lo + rng.integers(0, 6, (w, 5000)), 2048 * 3 + 5
    if kind == "one_row":  # match_rows: n = 1
        lo = rng.integers(0, 1000, (w, 1))
        return lo, lo + 135_000, (1 << 17) + 3
    if kind == "mostly_empty":  # the reply: 2^20 rows, ~0.6% non-empty
        n = 1 << 20
        lo = rng.integers(0, 1 << 20, (w, n))
        return lo, lo + (rng.random((w, n)) < 0.006), 1 << 17
    # total past 2^31 (2^33): the retry ladder reads it unwrapped
    lo = np.zeros((w, 8), np.int64)
    return lo, np.full((w, 8), 1 << 30), 5000


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["all_zero", "row_over_cap", "empty_runs",
                                  "first_lane_at_cap", "ragged_cap",
                                  "one_row", "mostly_empty", "total_2_33"])
def test_cuda_expand_edges(cuda_device, kind):
    """Bit-exact on the valid lanes, the valid mask and the int64 total."""
    lo, hi, cap = _expand_case(kind, np.random.default_rng(len(kind)))
    lo = torch.from_numpy(lo.astype(np.int32))
    hi = torch.from_numpy(hi.astype(np.int32))
    before = LAUNCHES["expand"]
    got = TR.expand(lo.to(cuda_device), hi.to(cuda_device), cap)
    want = TR.expand_plain(lo, hi, cap)
    assert LAUNCHES["expand"] == before + 1
    v = want[2]
    assert torch.equal(got[2].cpu(), v) and torch.equal(got[3].cpu(), want[3])
    assert torch.equal(got[0].cpu()[v], want[0][v])
    assert torch.equal(got[1].cpu()[v], want[1][v])
    if kind == "total_2_33":
        assert got[3].tolist() == [8 << 30] * 3


def _bucket_case(kind, k, rng):
    """(values, dest, valid, n_dest, cap_peer) of one bucket_by_dest case.
    The default n (three tiles of 4096 and 17 rows) is no multiple of the
    tile or of 16, so workers after the first take the unaligned loads."""
    w, n, nd, cap = 4, 3 * 4096 + 17, 8, 4096
    if kind == "empty":
        n = 0
    elif kind == "one_row":
        n = 1
    elif kind == "prefix_sorted":  # the reply routing: many tiles
        n, cap = 50_000, 1 << 14
    elif kind == "one_dest":
        nd = 1
    elif kind == "dest_256":
        nd, cap = 256, 40  # several destinations overflow
    elif kind in ("cap_1", "cap_3", "cap_5"):
        cap = int(kind[-1])
    elif kind == "overflow_mid_tile":
        cap = 3000  # destination 0 passes it in the second tile
    vals = rng.integers(-5, 1 << 30, (w, n, k)).astype(np.int32)
    dest = rng.integers(0, nd, (w, n)).astype(np.int32)
    valid = rng.random((w, n)) < 0.7
    if kind == "all_invalid":
        valid[:] = False
    elif kind in ("prefix_sorted", "prefix_hashed"):
        live = n * 2 // 5
        valid[:, live:] = False
        valid[:, :live] = rng.random((w, live)) < (0.9 if kind ==
                                                   "prefix_sorted" else 1.0)
        if kind == "prefix_sorted":
            dest = np.sort(dest, axis=1)
            dest[:, live:] = nd - 1
    elif kind == "overflow_mid_tile":
        dest = np.where(rng.random((w, n)) < 0.6, 0, dest).astype(np.int32)
    elif kind == "bad_dest":  # valid rows outside [0, n_dest) are dropped
        dest = rng.integers(-3, nd + 3, (w, n)).astype(np.int32)
    return vals, dest, valid, nd, cap


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "prefix_sorted", "prefix_hashed",
                                  "overflow_mid_tile", "all_invalid", "empty",
                                  "one_row", "one_dest", "dest_256", "cap_1",
                                  "cap_3", "cap_5", "bad_dest"])
@pytest.mark.parametrize("k", [1, 3])
def test_cuda_bucket_by_dest_edges(cuda_device, k, kind):
    """Bit-exact (send, send_valid, max_wanted) against the plain version:
    the path's mixes over many tiles, a destination overflowing cap_peer
    mid-tile, no valid row, n = 0 and 1, n not a multiple of the tile, one
    and 256 destinations, cap_peer odd and below 4 (the 16-byte stores'
    head and tail), destinations out of range; one launch a call."""
    rng = np.random.default_rng(len(kind) * 7 + k)
    vals, dest, valid, nd, cap = _bucket_case(kind, k, rng)
    args = [torch.from_numpy(a) for a in (vals, dest, valid)]
    pad = -7 if k == 3 else -1
    before = LAUNCHES["bucket_by_dest"]
    got = TR.bucket_by_dest(*[a.to(cuda_device) for a in args], nd, cap, pad)
    assert LAUNCHES["bucket_by_dest"] == before + 1
    want = TR.bucket_by_dest_plain(*args, nd, cap, pad)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_bucket_by_dest_past_int32_index(cuda_device):
    """send of 8 x 8 x 2^24 x 3 int32: the last destinations' slots lie past
    flat element 2^31.  The live slots equal the plain version's at a
    capacity that holds every row; every later slot is pad."""
    w, n, nd, cap, k = 8, 5000, 8, 1 << 24, 3
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a) for a in (
        rng.integers(0, 1 << 30, (w, n, k)).astype(np.int32),
        rng.integers(0, nd, (w, n)).astype(np.int32),
        rng.random((w, n)) < 0.8)]
    send, svalid, maxw = TR.bucket_by_dest(
        *[a.to(cuda_device) for a in args], nd, cap)
    want = TR.bucket_by_dest_plain(*args, nd, n)
    assert torch.equal(send[:, :, :n].cpu(), want[0])
    assert torch.equal(svalid[:, :, :n].cpu(), want[1])
    assert torch.equal(maxw.cpu(), want[2])
    assert bool((send[:, :, n:] == -1).all())
    assert not bool(svalid[:, :, n:].any())


@pytest.mark.cuda
def test_cuda_relalg_kernels_match_plain(cuda_device):
    before = dict(LAUNCHES)
    rng = np.random.default_rng(7)
    w, n = 4, 3000
    lo = rng.integers(0, 100, (w, n)).astype(np.int32)
    hi = lo + rng.integers(0, 5, (w, n)).astype(np.int32)
    got = TR.expand(torch.from_numpy(lo).to(cuda_device),
                    torch.from_numpy(hi).to(cuda_device), 4096)
    want = TR.expand_plain(torch.from_numpy(lo), torch.from_numpy(hi), 4096)
    v = want[2]
    assert torch.equal(got[2].cpu(), v) and torch.equal(got[3].cpu(), want[3])
    assert torch.equal(got[0].cpu()[v], want[0][v])
    assert torch.equal(got[1].cpu()[v], want[1][v])

    vals = rng.integers(0, 1 << 20, (w, n, 3)).astype(np.int32)
    dest = rng.integers(0, w, (w, n)).astype(np.int32)
    valid = rng.random((w, n)) > 0.2
    args = [torch.from_numpy(a) for a in (vals, dest, valid)]
    got = TR.bucket_by_dest(*[a.to(cuda_device) for a in args], w, 256)
    want = TR.bucket_by_dest_plain(*args, w, 256)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)

    for size in (1000, 40000):  # one radix tile, many radix tiles
        vals1 = torch.from_numpy(rng.integers(0, 5000, (w, size))
                                 .astype(np.int32))
        valid1 = torch.from_numpy(rng.random((w, size)) > 0.3)
        got = TR.unique_compact(vals1.to(cuda_device),
                                valid1.to(cuda_device), 2048, I32MAX)
        want = TR.unique_compact_plain(vals1, valid1, 2048, I32MAX)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    assert LAUNCHES["expand"] == before["expand"] + 1
    assert LAUNCHES["bucket_by_dest"] == before["bucket_by_dest"] + 1
    assert LAUNCHES["unique_compact"] == before["unique_compact"] + 2


@pytest.mark.cuda
def test_cuda_wrapper_rejects_a_cpu_operand(cuda_device):
    keys = torch.zeros((1, 4), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TB.range_search(keys, torch.zeros((1, 2), dtype=torch.int64))


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(cuda_device):
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import lubm_like, lubm_queries
    from repro_torch.kernels import reset_launches

    d, triples = lubm_like(3, 2, 3, 4, 2)
    gpu = AdHashEngine(triples, 4, adaptive=False, device="cuda")
    cpu = AdHashEngine(triples, 4, adaptive=False, device="cpu")
    reset_launches()
    for t in lubm_queries(d).values():
        for c in t.constants[:2]:
            q = t.make(c)
            (grel, gst), (crel, cst) = gpu.query(q), cpu.query(q)
            assert grel.to_set() == crel.to_set()
            assert (gst.comm_cells, gst.mode, gst.route, gst.n_retries) == \
                (cst.comm_cells, cst.mode, cst.route, cst.n_retries)
    rdf = ("range_search", "expand", "bucket_by_dest", "unique_compact")
    assert all(LAUNCHES[k] > 0 for k in rdf), LAUNCHES


def _batch_stage_outputs(store, stage, b=5):
    """(batched outputs, [single-call outputs] * b) of one ``*_batch``
    stage of ``repro_torch.core.dsj`` on ``store``'s device: lane i of the
    batch must equal the i-th single call."""
    from repro_torch.core import dsj
    from repro_torch.core.query import O, S

    dev = store.device
    spo = store.to_numpy()
    preds = np.unique(spo[:, 1])
    pairs = sorted({(int(p), int(q)) for p in preds for q in preds
                    if np.intersect1d(spo[spo[:, 1] == p, 2],
                                      spo[spo[:, 1] == q, 0]).size})[:b]
    consts = torch.tensor([[-1, p, -1] for p, _ in pairs], dtype=torch.int32,
                          device=dev)
    jconsts = torch.tensor([[-1, q, -1] for _, q in pairs],
                           dtype=torch.int32, device=dev)
    spec = dsj.PatternSpec(False, True, False, False, (S, O))
    cols, valid, _ = dsj.match_first_batch(store, consts, spec, 256)
    one = lambda fn: [fn(i) for i in range(b)]
    if stage == "match_first":
        return (dsj.match_first_batch(store, jconsts, spec, 256),
                one(lambda i: dsj.match_first(store, jconsts[i], spec, 256)))
    proj, pv, _ = dsj.project_unique_batch(cols, valid, 1, 128)
    if stage == "project_unique":
        return (dsj.project_unique_batch(cols, valid, 1, 128),
                one(lambda i: dsj.project_unique(cols[i], valid[i], 1, 128)))
    if stage == "exchange_hash":
        return (dsj.exchange_hash_batch(proj, pv, 64),
                one(lambda i: dsj.exchange_hash(proj[i], pv[i], 64)))
    if stage == "exchange_broadcast":
        return (dsj.exchange_broadcast_batch(proj, pv),
                one(lambda i: dsj.exchange_broadcast(proj[i], pv[i])))
    recv, rv, _, _ = dsj.exchange_hash_batch(proj, pv, 128)
    reply = dsj.probe_and_reply_batch(store, recv, rv, jconsts, spec, S,
                                      256, 128)
    if stage == "probe_and_reply":
        return reply, one(lambda i: dsj.probe_and_reply(
            store, recv[i], rv[i], jconsts[i], spec, S, 256, 128))
    if stage == "finalize_join":
        cand, cv = reply[:2]
        return (dsj.finalize_join_batch(cols, valid, cand, cv, 1, S, (),
                                        (O,), 512),
                one(lambda i: dsj.finalize_join(cols[i], valid[i], cand[i],
                                                cv[i], 1, S, (), (O,), 512)))
    if stage == "local_probe_join":
        return (dsj.local_probe_join_batch(store, cols, valid, jconsts, spec,
                                           0, S, (), (O,), 256),
                one(lambda i: dsj.local_probe_join(
                    store, cols[i], valid[i], jconsts[i], spec, 0, S, (),
                    (O,), 256)))
    steps = (dsj.ChainStep(spec, 0, S, (), (O,)),) * 2
    chain = torch.stack([consts, jconsts, consts], dim=1)
    rels, tots = dsj.local_chain_batch(store, chain, spec, (0, 1), steps,
                                       (256, 256, 512))
    singles = one(lambda i: dsj.local_chain(store, chain[i], spec, (0, 1),
                                            steps, (256, 256, 512)))
    flat = lambda rels_, tots_: [t for r in rels_ for t in r] + [tots_]
    return (flat(rels, tots.t()), [flat(r, t) for r, t in singles])


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [
    "match_first", "project_unique", "exchange_hash", "exchange_broadcast",
    "probe_and_reply", "finalize_join", "local_probe_join", "local_chain"])
def test_cuda_batch_stage_folds_match_single_calls(cuda_device, stage):
    """Each batched stage folds its B queries into one launch per kernel:
    on the card, lane i equals the i-th single-query call, and the whole
    batch equals the CPU port's batched stage bit for bit."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import lubm_like

    _, triples = lubm_like(2, 2, 2, 2)
    gpu = AdHashEngine(triples, 4, adaptive=False, device="cuda")
    cpu = AdHashEngine(triples, 4, adaptive=False, device="cpu")
    g_batch, g_single = _batch_stage_outputs(gpu.store, stage)
    c_batch, _ = _batch_stage_outputs(cpu.store, stage)
    for i, single in enumerate(g_single):
        for part, (a, b) in enumerate(zip(g_batch, single)):
            assert torch.equal(a[i], b), (stage, i, part)
    for part, (a, b) in enumerate(zip(g_batch, c_batch)):
        assert torch.equal(a.cpu(), b), (stage, part)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_cuda_adaptive_engine_matches_cpu(cuda_device, batched):
    """The adaptive engine on the card against the CPU port, under a budget
    that forces evictions: answers, stats, report, pattern-index
    fingerprint, heat map and every replica store's five tensors, through
    ``query`` or ``query_batch``."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import Workload, lubm_like

    d, triples = lubm_like(2, 2, 2, 2)
    queries = Workload(d, seed=0).sample(20) * 2
    kw = dict(frequency_threshold=2, capacity=256, replication_budget=16)
    gpu = AdHashEngine(triples, 4, device="cuda", **kw)
    cpu = AdHashEngine(triples, 4, device="cpu", **kw)
    if batched:
        g_res, c_res = gpu.query_batch(queries), cpu.query_batch(queries)
    else:
        g_res = [gpu.query(q) for q in queries]
        c_res = [cpu.query(q) for q in queries]
    for (grel, gst), (crel, cst) in zip(g_res, c_res):
        assert grel.to_set() == crel.to_set()
        assert (gst.comm_cells, gst.mode, gst.route, gst.n_retries,
                gst.plan) == (cst.comm_cells, cst.mode, cst.route,
                              cst.n_retries, cst.plan)
    assert gpu.report.n_redistributions > 0 and gpu.report.n_evictions > 0
    assert [h[:2] for h in gpu.report.history] == \
        [h[:2] for h in cpu.report.history]
    for f in ("n_parallel_replica", "ird_comm_cells", "ird_triples",
              "n_evictions", "n_batch_dispatches"):
        assert getattr(gpu.report, f) == getattr(cpu.report, f), f
    assert gpu.pattern_index.fingerprint() == cpu.pattern_index.fingerprint()
    assert gpu.heatmap.to_state() == cpu.heatmap.to_state()
    assert sorted(gpu.replicas.modules) == sorted(cpu.replicas.modules)
    for sid, st in cpu.replicas.modules.items():
        for a, b in zip(gpu.replicas.modules[sid].leaves(), st.leaves()):
            assert torch.equal(a.cpu(), b), sid
    assert gpu.replication_ratio() == cpu.replication_ratio()


def _assert_engines_equal(gpu, cpu, g_res, c_res) -> None:
    """Answers, stats, report, placement, pattern index, heat map, main
    store and replica stores of a card engine and a CPU engine."""
    for (grel, gst), (crel, cst) in zip(g_res, c_res):
        assert grel.to_set() == crel.to_set()
        assert (gst.comm_cells, gst.mode, gst.route, gst.n_retries,
                gst.plan) == (cst.comm_cells, cst.mode, cst.route,
                              cst.n_retries, cst.plan)
    for f in ("n_parallel_replica", "n_distributed", "n_redistributions",
              "ird_comm_cells", "n_rebalances", "rebalance_comm_cells",
              "n_batch_dispatches"):
        assert getattr(gpu.report, f) == getattr(cpu.report, f), f
    assert gpu.placement.fingerprint() == cpu.placement.fingerprint()
    assert gpu.pattern_index.fingerprint() == cpu.pattern_index.fingerprint()
    assert gpu.heatmap.to_state() == cpu.heatmap.to_state()
    for a, b in zip(gpu.store.leaves(), cpu.store.leaves()):
        assert torch.equal(a.cpu(), b)
    assert sorted(gpu.replicas.modules) == sorted(cpu.replicas.modules)
    for sid, st in cpu.replicas.modules.items():
        for a, b in zip(gpu.replicas.modules[sid].leaves(), st.leaves()):
            assert torch.equal(a.cpu(), b), sid


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_cuda_directory_engine_matches_cpu(cuda_device, batched):
    """A directory-placement engine on the card against the CPU port: five
    hub subjects split and the store moved (the rebalance's bucket_by_dest
    at k = 3), then a workload whose staged exchanges fan out 8 ways."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import Workload, lubm_like

    d, triples = lubm_like(2, 2, 2, 2)
    queries = Workload(d, seed=4).sample(14) * 2
    hubs = np.argsort(-np.bincount(triples[:, 0]), kind="stable")[:5]
    kw = dict(frequency_threshold=2, capacity=256, placement="directory")
    engines = []
    for dev in ("cuda", "cpu"):
        eng = AdHashEngine(triples, 8, device=dev, **kw)
        eng.placement.add_splits(hubs)
        store, moved = eng.ird.rebalance_deferred(eng.placement).finalize()
        eng._publish_store(store)
        engines.append((eng, moved))
    (gpu, g_moved), (cpu, c_moved) = engines
    assert g_moved == c_moved > 0
    before = LAUNCHES["bucket_by_dest"]
    if batched:
        g_res, c_res = gpu.query_batch(queries), cpu.query_batch(queries)
    else:
        g_res = [gpu.query(q) for q in queries]
        c_res = [cpu.query(q) for q in queries]
    assert LAUNCHES["bucket_by_dest"] > before
    _assert_engines_equal(gpu, cpu, g_res, c_res)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_cuda_skew_engine_matches_cpu(cuda_device, batched):
    """The skew detector on the card: the reference tests' Zipf hub shape,
    the same splits, rebalances, moved cells and store as the CPU port."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import zipf_skew, zipf_workload

    triples = zipf_skew(n_subjects=64, n_triples=4000, n_objects=64,
                        n_predicates=8, exponent=1.8, seed=0)
    queries = zipf_workload(40, n_subjects=64, n_predicates=8, exponent=1.8,
                            seed=1)
    kw = dict(frequency_threshold=3, capacity=256, skew_threshold=1.2,
              placement="directory")
    gpu = AdHashEngine(triples, 4, device="cuda", **kw)
    cpu = AdHashEngine(triples, 4, device="cpu", **kw)
    if batched:
        g_res, c_res = gpu.query_batch(queries), cpu.query_batch(queries)
    else:
        g_res = [gpu.query(q) for q in queries]
        c_res = [cpu.query(q) for q in queries]
    assert gpu.report.n_rebalances >= 1
    _assert_engines_equal(gpu, cpu, g_res, c_res)
    assert gpu.load_balance() == cpu.load_balance()


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(cuda_device, tmp_path):
    """A snapshot of a card engine restores onto the card and onto the CPU
    bit for bit, and the recovered masters answer as the original."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import zipf_skew, zipf_workload
    from repro_torch.runtime.fault_tolerance import recover_master

    triples = zipf_skew(n_subjects=64, n_triples=4000, n_objects=64,
                        n_predicates=8, exponent=1.8, seed=0)
    queries = zipf_workload(40, n_subjects=64, n_predicates=8, exponent=1.8,
                            seed=1)
    kw = dict(frequency_threshold=3, capacity=256, skew_threshold=1.2)
    gpu = AdHashEngine(triples, 4, device="cuda", placement="directory",
                       **kw)
    for q in queries:
        gpu.query(q)
    mgr = CheckpointManager(tmp_path)
    mgr.save_engine_state(gpu, queries)
    mgr.save_adaptivity(gpu, step=1)
    recovered = [recover_master(CheckpointManager(tmp_path), triples, 4,
                                device=dev, **kw) for dev in ("cuda", "cpu")]
    r1, s1 = gpu.query(queries[0])
    for dev, rec in zip(("cuda", "cpu"), recovered):
        r2, s2 = rec.query(queries[0])
        assert (s1.route, s1.mode) == (s2.route, s2.mode)
        assert r1.to_set() == r2.to_set()
        assert rec.placement.fingerprint() == gpu.placement.fingerprint()
        assert rec.pattern_index.fingerprint() == \
            gpu.pattern_index.fingerprint()
        assert rec.heatmap.to_state() == gpu.heatmap.to_state()
        assert rec.replicas.next_id_n == gpu.replicas.next_id_n
        for sid, st in gpu.replicas.modules.items():
            got = rec.replicas.modules[sid]
            assert got.device.type == dev
            for a, b in zip(got.leaves(), st.leaves()):
                assert torch.equal(a.cpu(), b.cpu()), sid


@pytest.mark.cuda
def test_cuda_kernels_on_empty_and_tiny_inputs(cuda_device):
    """Edge shapes the main path can produce: no probes, no ranges, no
    rows, all rows invalid, zero-capacity outputs."""
    dev = cuda_device
    keys = torch.tensor([[1, 2, 2, 5]], dtype=torch.int64)
    for probes in (torch.zeros((1, 0), dtype=torch.int64),
                   torch.tensor([[0, 2, 9]], dtype=torch.int64)):
        got = TB.range_search(keys.to(dev), probes.to(dev))
        for a, b in zip(got, TB.range_search_plain(keys, probes)):
            assert torch.equal(a.cpu(), b)
    z = torch.zeros((2, 5), dtype=torch.int32)
    for cap in (0, 7):
        got = TR.expand(z.to(dev), z.to(dev), cap)
        assert not got[2].any() and got[3].tolist() == [0, 0]
    vals = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    for valid in (torch.zeros((2, 6), dtype=torch.bool),
                  torch.ones((2, 6), dtype=torch.bool)):
        for cap in (0, 4, 16):
            got = TR.unique_compact(vals.to(dev), valid.to(dev), cap, I32MAX)
            want = TR.unique_compact_plain(vals, valid, cap, I32MAX)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
            got = TR.bucket_by_dest(vals[..., None].to(dev),
                                    (vals % 3).to(dev), valid.to(dev), 3, cap)
            want = TR.bucket_by_dest_plain(vals[..., None], vals % 3, valid,
                                           3, cap)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)


FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("t", [1, 63, 64, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_cuda_flash_attention_matches_plain(cuda_device, hd, causal, t, group,
                                            dtype):
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)

    g = torch.Generator().manual_seed(hd * 7 + t)
    kv = 2
    q = torch.randn((2, t, kv * group, hd), generator=g).to(dtype)
    k = torch.randn((2, t, kv, hd), generator=g).to(dtype)
    v = torch.randn((2, t, kv, hd), generator=g).to(dtype)
    before = LAUNCHES["flash_attention"]
    with torch.inference_mode():
        got = flash_attention(*(x.to(cuda_device) for x in (q, k, v)),
                              causal=causal)
        want = flash_attention_plain(*(x.to(cuda_device) for x in (q, k, v)),
                                     causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,q_offset", [(200, 333, 0), (200, 333, 133),
                                          (1, 4097, 4096), (130, 70, 5)])
def test_cuda_flash_attention_offsets_and_ragged_keys(cuda_device, t, s,
                                                      q_offset):
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)

    g = torch.Generator().manual_seed(t + s)
    q = torch.randn((1, t, 8, 128), generator=g).to(cuda_device)
    k = torch.randn((1, s, 2, 128), generator=g).to(cuda_device)
    v = torch.randn((1, s, 2, 128), generator=g).to(cuda_device)
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
        want = flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_is_forward_only(cuda_device):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q = torch.randn((1, 8, 2, 64), device=cuda_device, requires_grad=True)
    k = torch.randn((1, 8, 2, 64), device=cuda_device)
    with pytest.raises(NotImplementedError, match="item 12b"):
        flash_attention(q, k, k)
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == q.shape
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.zeros((1, 4, 2, 48), device=cuda_device),
                        torch.zeros((1, 4, 2, 48), device=cuda_device),
                        torch.zeros((1, 4, 2, 48), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-4b"])
def test_cuda_lm_matches_cpu(cuda_device, arch):
    """The smoke model's prefill and decode on the card equal the CPU port
    (float32 weights and compute; 1e-4)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.launch.train import make_serve_step
    from repro_torch.models import transformer as TT
    from repro_torch.models.model_zoo import build_model

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    gpu = build_model(cfg, device="cuda")
    cpu = build_model(cfg, device="cpu")
    params = gpu.init(0)
    params_cpu = TT.init_lm(torch.Generator(), cfg)
    params_cpu.load_state_dict({k: v.cpu()
                                for k, v in params.state_dict().items()})
    before = LAUNCHES["flash_attention"]
    loss = gpu.loss(params, make_batch(cfg, 2, 200, 0, device="cuda"))
    assert LAUNCHES["flash_attention"] == before + cfg.n_layers
    want = cpu.loss(params_cpu, make_batch(cfg, 2, 200, 0, device="cpu"))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    step_g, step_c = make_serve_step(gpu), make_serve_step(cpu)
    cache_g, cache_c = gpu.init_cache(2, 8), cpu.init_cache(2, 8)
    tok = torch.tensor([[3], [7]])
    tok_g = tok.to(cuda_device)
    for pos in range(4):
        n_g, cache_g = step_g(params, cache_g, {"tokens": tok_g, "pos": pos})
        n_c, cache_c = step_c(params_cpu, cache_c, {"tokens": tok, "pos": pos})
        assert torch.equal(n_g.cpu(), n_c)
        tok_g, tok = n_g[:, None], n_c[:, None]


def _edge_row(kind, dtype, w, n, rng):
    """(values, valid, pad) of one edge case of unique_compact's rows."""
    info = np.iinfo(dtype)
    pad = int(info.max)
    valid = rng.random((w, n)) < 0.7
    if kind == "random":
        vals = rng.integers(0, 5000, (w, n))
    elif kind == "all_invalid":
        vals = rng.integers(0, 5000, (w, n))
        valid[:] = False
    elif kind == "all_equal":
        vals = np.full((w, n), 7)
        valid[:] = True
    elif kind == "one_distinct":  # one valid value among invalid noise
        vals = np.where(valid, 42, rng.integers(0, 5000, (w, n)))
    elif kind == "negative":
        vals = rng.integers(info.min // 2, 1 << 10, (w, n))
    elif kind == "below_pad":
        vals = rng.integers(pad - 1000, pad, (w, n))
    else:  # full_range: every key below pad, both signs, all digits
        vals = rng.integers(info.min, pad, (w, n), dtype=dtype)
    return vals.astype(dtype), valid, pad


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "all_invalid", "all_equal",
                                  "one_distinct", "negative", "below_pad",
                                  "full_range"])
@pytest.mark.parametrize("n", [1, 1000, 4096, (1 << 18) + 1])
@pytest.mark.parametrize("w", [1, 8])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_cuda_unique_compact_edge_rows(cuda_device, dtype, w, n, kind):
    """The radix sort's edge rows, bit-exact against the plain version:
    empty and constant rows (every digit skipped), negative keys (the sign
    flip), keys just below pad, full-range keys (no digit skipped), rows of
    one key, of one tile exactly, and not a power of two."""
    rng = np.random.default_rng(n + w + len(kind))
    vals, valid, pad = _edge_row(kind, dtype, w, n, rng)
    v_t, m_t = torch.from_numpy(vals), torch.from_numpy(valid)
    before = LAUNCHES["unique_compact"]
    for cap in (0, 2048):
        got = TR.unique_compact(v_t.to(cuda_device), m_t.to(cuda_device),
                                cap, pad)
        want = TR.unique_compact_plain(v_t, m_t, cap, pad)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    assert LAUNCHES["unique_compact"] == before + 2


def _check_bf16_attention(got, want):
    """bf16 limits of chip_smoke.py: 2e-2 absolute, 1e-2 of each output
    row's largest magnitude."""
    d = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    assert float(d.max()) <= 2e-2, float(d.max())
    assert float((d / scale).max()) <= 1e-2, float((d / scale).max())


def _qkv_bf16(dev, b, t, s, h, kv, hd, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
                 for shape in ((b, t, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [1, 127, 129, 1000])
@pytest.mark.parametrize("t", [1, 127, 129, 1000])
def test_cuda_flash_attention_bf16_tensor_cores(cuda_device, t, s, hd, group,
                                                causal):
    """The tensor-core kernel at ragged T and S (TMA zero-fills the tiles'
    tails), every head dim (each swizzle), MHA and GQA."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain, flash_engine)

    assert flash_engine(torch.bfloat16) == "wgmma"
    q, k, v = _qkv_bf16(cuda_device, 2, t, s, 2 * group, 2, hd,
                        t * 7 + s + hd)
    before = LAUNCHES["flash_attention"]
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _check_bf16_attention(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,q_offset", [(1, 200, 333, 133),
                                            (1, 1, 4097, 4096),
                                            (1, 130, 70, 5),
                                            (3, 300, 300, 0),
                                            (3, 100, 300, 200),
                                            (3, 129, 1000, 871)])
def test_cuda_flash_attention_bf16_offsets_and_batches(cuda_device, b, t, s,
                                                       q_offset):
    """bf16 with q_offset > 0, and B = 3 with S not a multiple of 128: the
    4-D tensor map must zero-fill each batch's tail, never read the next
    batch's keys."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)

    q, k, v = _qkv_bf16(cuda_device, b, t, s, 8, 2, 128, b * t + s)
    with torch.inference_mode():
        for causal in (True, False):
            got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
            want = flash_attention_plain(q, k, v, causal=causal,
                                         q_offset=q_offset)
            _check_bf16_attention(got, want)


def _serve_small(device, rate, service_model, clock=None, wrap=None, **cfg):
    """The 24-request stream of the card's serve-parity phase (W = 8,
    lubm_like(2, 2, 2, 2), threshold 2, brownout off) through a ServeLoop
    on ``device``; ``wrap(engine)`` may instrument the engine first."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.data.synthetic_rdf import Workload, lubm_like
    from repro_torch.runtime.fault_injection import VirtualClock
    from repro_torch.serving import (ServeConfig, ServeLoop,
                                     open_loop_arrivals, replay_open_loop)

    d, triples = lubm_like(2, 2, 2, 2)
    eng = AdHashEngine(triples, 8, frequency_threshold=2, capacity=256,
                       device=device)
    if wrap is not None:
        wrap(eng)
    qs = Workload(d, seed=21).sample(6) * 4
    loop = ServeLoop(eng, ServeConfig(batch_target=4,
                                      brownout_enter=(9.0, 10.0),
                                      brownout_exit=(8.0, 9.0), **cfg),
                     clock=clock if clock is not None else VirtualClock(),
                     service_model=service_model)
    done, rejected = replay_open_loop(
        loop, open_loop_arrivals(qs, rate_qps=rate, seed=21))
    return loop, done, rejected


@pytest.mark.cuda
def test_cuda_served_stream_matches_cpu(cuda_device):
    """Modelled service: the stream served by a card engine gives the CPU
    engine's ledger bit for bit -- every report field, the latencies, each
    completion in order with its timestamps, answer, mode, route and
    comm_cells -- and the same pattern-index fingerprint."""
    import dataclasses

    def key(c):
        if type(c).__name__ != "ServedResult":
            return dataclasses.astuple(c)
        return (c.rid, c.finished_s, c.latency_s, c.late,
                c.relation.to_set(), c.stats.mode, c.stats.route,
                c.stats.comm_cells, c.stats.n_retries)

    sides = []
    for dev in ("cuda", "cpu"):
        loop, done, rejected = _serve_small(
            dev, 150.0, lambda n: 0.01, slo_s=2.0, queue_bound=16,
            bucket_window=16)
        sides.append((dataclasses.asdict(loop.report),
                      [key(c) for c in done], [key(v) for v in rejected],
                      loop.engine.pattern_index.fingerprint()))
    assert sides[0] == sides[1]
    assert sides[0][0]["answered"] == 24


@pytest.mark.cuda
def test_cuda_measured_charges_cover_device_time(cuda_device):
    """Measured mode: each charge to the clock is at least the device time
    of the work it stands for, read from a CUDA event pair around the
    engine's call.  Each call also enqueues ~10 ms of device sleep that the
    host does not wait for, so a charge taken before the card finished
    would fall short."""
    from repro_torch.runtime.fault_injection import VirtualClock

    spans = []  # (kind, start, end, nested spans), in completion order
    charges = []

    class Clock(VirtualClock):
        def advance(self, dt):
            charges.append(dt)
            return super().advance(dt)

    def timed(fn, kind):
        def call(*args, **kwargs):
            first = len(spans)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            torch.cuda._sleep(20_000_000)
            end.record()
            spans.append((kind, start, end, len(spans) - first))
            return out
        return call

    def wrap(eng):
        eng.stream_control_step = timed(eng.stream_control_step, "control")
        eng.execute_bucket = timed(eng.execute_bucket, "bucket")

    loop, _, _ = _serve_small("cuda", 1e9, None, clock=Clock(), wrap=wrap,
                              slo_s=1e6, queue_bound=64, bucket_window=64)
    torch.cuda.synchronize()
    assert loop.report.answered == 24
    assert len(spans) == len(charges)
    assert {k for k, *_ in spans} == {"control", "bucket"}
    for i, (kind, start, end, nested) in enumerate(spans):
        device_s = start.elapsed_time(end) / 1e3
        # a control step's charge excludes the buckets it ran inside
        # (overlapped with IRD); those charged themselves, just before it
        covered = charges[i] + sum(charges[i - nested:i])
        assert covered >= device_s, (i, kind, covered, device_s)


# ------------------------------------------------ the mesh substrate on NCCL
@pytest.fixture
def nccl_world(cuda_device):
    """A world-size-1 NCCL group (the card holds one rank), then none."""
    import torch.distributed as dist

    from repro_torch.launch import multihost

    assert not dist.is_initialized()
    multihost.ensure_initialized(device="cuda")
    yield dist
    multihost.shutdown()


def _mesh_run(eng, queries):
    from repro_torch.core.substrate import trace_collectives

    out, counts = [], []
    for q in queries:
        with trace_collectives() as tc:
            rel, st = eng.query(q)
        out.append((rel.to_set(), st.comm_cells, st.mode,
                    st.route.split("-", 1)[-1], st.n_retries))
        counts.append(dict(tc.counts))
    return out, counts


@pytest.mark.cuda
def test_cuda_mesh_substrate_matches_single_over_nccl(nccl_world):
    """A world-size-1 NCCL mesh on the card: answers and stats equal to the
    single substrate's across the adaptive lifecycle, the four DSJ kernels
    launched, and the same collectives, query by query, as a gloo mesh on
    the CPU over the same queries."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.core.substrate import MeshSubstrate
    from repro_torch.data.synthetic_rdf import Workload, lubm_like
    from repro_torch.kernels import reset_launches

    d, triples = lubm_like(2, 2, 2, 2)
    qs = Workload(d, seed=7).sample(4) * 2
    kw = dict(adaptive=True, frequency_threshold=2, capacity=256)
    sub = MeshSubstrate(device="cuda")
    assert sub.backend == "nccl" and sub.n_devices == 1
    reset_launches()
    mesh = AdHashEngine(triples, 8, substrate=sub, device="cuda", **kw)
    got, counts = _mesh_run(mesh, qs)
    assert all(LAUNCHES[k] > 0 for k in ("range_search", "expand",
                                         "bucket_by_dest", "unique_compact"))
    single = AdHashEngine(triples, 8, device="cuda", **kw)
    assert got == [(rel.to_set(), st.comm_cells, st.mode,
                    st.route.split("-", 1)[-1], st.n_retries)
                   for rel, st in (single.query(q) for q in qs)]
    assert mesh.pattern_index.fingerprint() == \
        single.pattern_index.fingerprint()
    assert any(c.get(("all_to_all", "stage"), 0) for c in counts)
    gloo = nccl_world.new_group(ranks=[0], backend="gloo")
    cpu_mesh = AdHashEngine(triples, 8, device="cpu", **kw,
                            substrate=MeshSubstrate(gloo, device="cpu"))
    cpu_got, cpu_counts = _mesh_run(cpu_mesh, qs)
    assert cpu_got == got and cpu_counts == counts


@pytest.mark.cuda
def test_cuda_mesh_query_batch_over_nccl(nccl_world):
    """``query_batch`` on the NCCL mesh equals the single substrate's
    sequential answers, stats and fingerprint."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.core.substrate import MeshSubstrate
    from repro_torch.data.synthetic_rdf import Workload, lubm_like

    d, triples = lubm_like(2, 2, 2, 2)
    qs = Workload(d, seed=13).sample(5) * 2
    kw = dict(adaptive=True, frequency_threshold=2, capacity=256,
              device="cuda")
    mesh = AdHashEngine(triples, 8, substrate=MeshSubstrate(device="cuda"),
                        **kw)
    single = AdHashEngine(triples, 8, **kw)
    got = [(rel.to_set(), st.comm_cells, st.mode)
           for rel, st in mesh.query_batch(qs)]
    assert got == [(rel.to_set(), st.comm_cells, st.mode)
                   for rel, st in (single.query(q) for q in qs)]
    assert mesh.pattern_index.fingerprint() == \
        single.pattern_index.fingerprint()
