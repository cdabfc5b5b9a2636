"""The port's four kernel primitives against the JAX package's kernels.

Each primitive of ``repro_torch`` has one wrapper: on a CPU tensor it runs
its plain PyTorch version, on a CUDA tensor it launches the hand-written
kernel.  Here the same numpy inputs (from a seed) go through

  * the port's wrapper on CPU tensors (the plain version),
  * the Pallas kernel in interpret mode (``repro.kernels``),
  * the Pallas kernel's jnp oracle (``ref.py`` / the searchsorted path),

over the matrices of tests/test_relalg_kernels.py and tests/test_kernels.py,
plus the int64 expansion total and int32 probe keys.  Outputs are integers
and must be bit-exact (valid lanes only for ``expand``, whose invalid lanes
are unspecified).  tests/test_torch_cuda.py holds each kernel against its
plain version on the card.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in production)
import jax.numpy as jnp

from repro.core import relalg as R
from repro.kernels.relalg_ops import (
    bucket_by_dest_pallas,
    expand_pallas,
    unique_compact_pallas,
)
from repro.kernels.relalg_ops.ops import (
    batched_bucket_by_dest,
    batched_expand,
    batched_unique_compact,
)
from repro.kernels.relalg_ops.ref import (
    bucket_by_dest_ref,
    expand_ref,
    unique_compact_ref,
)
from repro.kernels.semijoin.ops import batched_semijoin_probe
from repro.kernels.semijoin.ref import semijoin_probe_ref
from repro.kernels.semijoin.semijoin import semijoin_probe
from repro_torch.core import backend as TB
from repro_torch.core.placement import splitmix64_np
from repro_torch.core import relalg as TR
from repro_torch.kernels import LAUNCHES

I32MAX = 2**31 - 1
I64MAX = np.iinfo(np.int64).max


def _t(a) -> torch.Tensor:
    """numpy -> CPU tensor with a leading worker axis of 1."""
    return torch.from_numpy(np.ascontiguousarray(a))[None]


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------- probes
def _assert_probe_match(keys, probes):
    lo, hi = TB.range_search(_t(keys), _t(probes))
    for rlo, rhi in (
        semijoin_probe(jnp.asarray(keys), jnp.asarray(probes),
                       interpret=True),
        semijoin_probe_ref(jnp.asarray(keys), jnp.asarray(probes)),
    ):
        np.testing.assert_array_equal(_np(lo)[0], _np(rlo))
        np.testing.assert_array_equal(_np(hi)[0], _np(rhi))
    assert lo.dtype == hi.dtype == torch.int32


@pytest.mark.parametrize("n,m", [(100, 37), (2048, 256), (5000, 1000)])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_range_search_matches_semijoin_probe(n, m, seed, dtype):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 10 * n, n)).astype(dtype)
    probes = rng.integers(-5, 10 * n + 5, m).astype(dtype)
    _assert_probe_match(keys, probes)


@pytest.mark.parametrize("dtype,pad", [(np.int64, I64MAX),
                                       (np.int32, I32MAX)])
def test_range_search_padded_keys(dtype, pad):
    """Dtype-max padding (store rows: int64; candidate keys: int32) never
    matches a probe below the pad."""
    keys = np.concatenate([np.arange(10), [pad] * 6]).astype(dtype)
    probes = np.array([0, 5, 9, 100], dtype)
    _assert_probe_match(keys, probes)
    lo, hi = TB.range_search(_t(keys), _t(probes))
    np.testing.assert_array_equal(_np(hi - lo)[0], [1, 1, 1, 0])


def test_range_search_probe_at_pad_is_searchsorted():
    """A probe equal to the pad follows searchsorted (hi = N), where the
    Pallas masked count returns the padded length: callers mask it."""
    keys = np.array([1, 2, I64MAX, I64MAX], np.int64)
    lo, hi = TB.range_search(_t(keys), _t(np.array([I64MAX], np.int64)))
    rlo, rhi = semijoin_probe_ref(jnp.asarray(keys), jnp.asarray([I64MAX]))
    assert (int(lo[0, 0]), int(hi[0, 0])) == (int(rlo[0]), int(rhi[0])) \
        == (2, 4)


def test_span_search_matches_left_searches():
    rng = np.random.default_rng(5)
    keys = np.sort(rng.integers(0, 1000, 300)).astype(np.int64)
    a = rng.integers(0, 1000, 64).astype(np.int64)
    b = a + rng.integers(0, 50, 64)
    lo, hi = TB.span_search(_t(keys), _t(a), _t(b))
    for got, probe in ((lo, a), (hi, b)):
        want = jnp.searchsorted(jnp.asarray(keys), jnp.asarray(probe),
                                side="left")
        np.testing.assert_array_equal(_np(got)[0], _np(want))


@pytest.mark.parametrize("w", [1, 3])
def test_range_search_batched(w):
    rng = np.random.default_rng(2)
    keys = np.sort(rng.integers(0, 1000, (w, 512)), axis=1).astype(np.int64)
    probes = rng.integers(0, 1000, (w, 100)).astype(np.int64)
    lo, hi = TB.range_search(torch.from_numpy(keys), torch.from_numpy(probes))
    rlo, rhi = batched_semijoin_probe(jnp.asarray(keys), jnp.asarray(probes),
                                      interpret=True)
    np.testing.assert_array_equal(_np(lo), _np(rlo))
    np.testing.assert_array_equal(_np(hi), _np(rhi))


def _probe_mix(kind, dtype, n, m, rng):
    """(keys, probes) in the mixes the LUBM path gives range_search: store
    keys with a dtype-max padded tail; the reply's probes (a few live ones,
    ascending, then one clamped key in every padding lane); warps of one
    probe with one odd lane; probes below every key; finalize_join's
    unsorted probes, most of them equal to the pad."""
    pad = int(np.iinfo(dtype).max)
    live = n - n // 8
    keys = np.full(n, pad, np.int64)
    keys[:live] = np.sort(rng.integers(0, 4 * n, live))
    hits = keys[rng.integers(0, live, m)]
    if kind == "padding":
        probes = np.full(m, keys[0] + 1)
        probes[: m // 100 + 1] = np.sort(hits[: m // 100 + 1])
    elif kind == "odd_lane":
        probes = np.full(m, hits[0])
        probes[5::32] = hits[5::32]
    elif kind == "below":
        probes = keys[0] - 1 - rng.integers(0, 3, m)
    else:  # "finalize": unsorted, 9% live, the rest equal to the pad
        probes = np.where(rng.random(m) < 0.09, hits, pad)
    return keys.astype(dtype), probes.astype(dtype)


@pytest.mark.parametrize("kind", ["padding", "odd_lane", "below",
                                  "finalize"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_range_search_main_path_mixes(kind, dtype):
    """The probe mixes the Hopper kernel special-cases (a lane reuses its
    last answers, a warp searches each distinct probe once), through the
    plain version against the Pallas kernel and its searchsorted oracle.
    The Pallas kernel counts a probe equal to the pad as the padded length
    (see test_range_search_probe_at_pad_is_searchsorted): those lanes are
    held to the oracle only."""
    rng = np.random.default_rng(len(kind) + np.dtype(dtype).itemsize)
    keys, probes = _probe_mix(kind, dtype, 300, 256, rng)
    lo, hi = TB.range_search(_t(keys), _t(probes))
    rlo, rhi = semijoin_probe_ref(jnp.asarray(keys), jnp.asarray(probes))
    np.testing.assert_array_equal(_np(lo)[0], _np(rlo))
    np.testing.assert_array_equal(_np(hi)[0], _np(rhi))
    plo, phi = semijoin_probe(jnp.asarray(keys), jnp.asarray(probes),
                              interpret=True)
    below_pad = probes != np.iinfo(dtype).max
    np.testing.assert_array_equal(_np(lo)[0][below_pad], _np(plo)[below_pad])
    np.testing.assert_array_equal(_np(hi)[0][below_pad], _np(phi)[below_pad])


# ------------------------------------------------------------------- expand
def _assert_expand_match(lo, hi, cap, pallas=True):
    left, pos, valid, total = TR.expand(_t(lo), _t(hi), cap)
    refs = [expand_ref(jnp.asarray(lo), jnp.asarray(hi), cap)]
    if pallas:
        refs.append(expand_pallas(jnp.asarray(lo), jnp.asarray(hi), cap,
                                  interpret=True))
    for r in refs:
        rl, rp, rv, rt = (_np(x) for x in r)
        np.testing.assert_array_equal(_np(valid)[0], rv)
        assert int(total[0]) == int(rt)
        np.testing.assert_array_equal(_np(left)[0][rv], rl[rv])
        np.testing.assert_array_equal(_np(pos)[0][rv], rp[rv])
    assert left.dtype == pos.dtype == torch.int32
    assert total.dtype == torch.int64


@pytest.mark.parametrize("n,cap", [(7, 16), (100, 64), (257, 300), (64, 64)])
@pytest.mark.parametrize("seed", [0, 1])
def test_expand_parity_random(n, cap, seed):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 60, n).astype(np.int32)
    hi = lo + rng.integers(0, 6, n).astype(np.int32)
    _assert_expand_match(lo, hi, cap)


def test_expand_parity_edge_cases():
    z = np.zeros(32, np.int32)
    _assert_expand_match(z, z, 16)  # empty relation
    lo = np.zeros(4, np.int32)
    hi = np.array([5, 0, 11, 0], np.int32)
    _assert_expand_match(lo, hi, 16)  # total == cap
    _assert_expand_match(lo, hi, 15)  # total == cap + 1 -> overflow
    _assert_expand_match(lo, hi, 300)  # cap >> total
    # reversed ranges count as empty
    _assert_expand_match(np.array([5, 3], np.int32),
                         np.array([2, 6], np.int32), 8)


def _expand_mix(kind, rng):
    """(lo, hi, out_cap) in the shapes the LUBM path gives expand: most rows
    empty (the reply), long runs of empty rows between non-empty ones, a
    non-empty row whose first lane is exactly out_cap, one long row."""
    if kind == "mostly_empty":  # ~1% of 600 rows non-empty
        lo = rng.integers(0, 1000, 600)
        return lo, lo + (rng.random(600) < 0.01) * rng.integers(1, 4, 600), 64
    if kind == "empty_runs":
        lo = rng.integers(0, 1000, 500)
        hi = lo.copy()
        hi[[0, 1, 250, 499]] += [3, 1, 40, 7]
        return lo, hi, 128
    if kind == "first_lane_at_cap":  # row 7 starts at lane 18 = out_cap
        lo = np.zeros(20, np.int64)
        hi = np.full(20, 3)
        hi[3] = 0
        return lo, hi, 18
    lo = rng.integers(0, 1000, 1)  # "one_row": match_rows, count > out_cap
    return lo, lo + 500, 300


@pytest.mark.parametrize("kind", ["mostly_empty", "empty_runs",
                                  "first_lane_at_cap", "one_row"])
def test_expand_main_path_mixes(kind):
    lo, hi, cap = _expand_mix(kind, np.random.default_rng(len(kind)))
    _assert_expand_match(lo.astype(np.int32), hi.astype(np.int32), cap)


def test_expand_no_ranges():
    left, pos, valid, total = TR.expand(
        torch.zeros((2, 0), dtype=torch.int32),
        torch.zeros((2, 0), dtype=torch.int32), 8)
    assert valid.shape == (2, 8) and not valid.any()
    assert total.tolist() == [0, 0]


def test_expand_total_survives_int32_overflow():
    """A virtual expansion of 2^33 rows must not wrap: the retry protocol
    reads ``total`` to size the next capacity class."""
    lo = np.zeros(8, np.int32)
    hi = np.full(8, 1 << 30, np.int32)
    *_, total = TR.expand(_t(lo), _t(hi), 32)
    assert int(total[0]) == 8 << 30
    # the Pallas kernel's int32 running cumsum wraps here (its valid-lane
    # outputs are not defined past 2^31); hold the port to the int64 oracle
    _assert_expand_match(lo, hi, 32, pallas=False)


# ----------------------------------------------------------- bucket_by_dest
def _assert_bucket_match(vals, dest, valid, w, cap_peer, pad=-1):
    got = TR.bucket_by_dest(_t(vals), _t(dest), _t(valid), w, cap_peer, pad)
    args = (jnp.asarray(vals), jnp.asarray(dest), jnp.asarray(valid))
    for ref in (
        bucket_by_dest_ref(*args, w, cap_peer, pad),
        bucket_by_dest_pallas(*args, w, cap_peer, pad, interpret=True),
    ):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(_np(a)[0], _np(b))
    assert got[2].dtype == torch.int64


@pytest.mark.parametrize("n,w,cap_peer", [(50, 4, 16), (200, 3, 64),
                                          (65, 7, 8), (128, 1, 128)])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mix", ["random", "prefix_sorted", "prefix_hashed"])
def test_bucket_parity_random(n, w, cap_peer, seed, k, mix):
    """Random rows, and the two mixes the LUBM path gives the kernel: the
    reply routing's valid prefix (a few holes) with destinations that never
    decrease, and the hash exchange's valid prefix of sorted unique values
    with destinations splitmix64(v) % W."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1000, (n, k)).astype(np.int32)
    dest = rng.integers(0, w, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    if mix != "random":
        live = n * 3 // 5
        valid = np.arange(n) < live
    if mix == "prefix_sorted":
        valid[rng.integers(0, live, 2)] = False
        dest = np.where(valid, np.sort(dest), w - 1).astype(np.int32)
    elif mix == "prefix_hashed":
        vals[:live, 0] = np.sort(rng.choice(1 << 20, live, replace=False))
        vals[live:] = -1
        dest = (splitmix64_np(vals[:, 0]) % w).astype(np.int32)
    _assert_bucket_match(vals, dest, valid, w, cap_peer)


def test_bucket_parity_edge_cases():
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 9, (40, 3)).astype(np.int32)
    dest = rng.integers(0, 3, 40).astype(np.int32)
    _assert_bucket_match(vals, dest, np.zeros(40, bool), 3, 8)  # all invalid
    dest_hot = np.zeros(40, np.int32)  # one destination overflows
    _assert_bucket_match(vals, dest_hot, np.ones(40, bool), 3, 8)
    _assert_bucket_match(vals, dest_hot, np.ones(40, bool), 3, 40)
    # input order is kept within a destination
    send, svalid, _ = TR.bucket_by_dest(
        _t(np.arange(40, dtype=np.int32)[:, None]), _t(dest_hot),
        _t(np.ones(40, bool)), 3, 40)
    np.testing.assert_array_equal(_np(send)[0, 0, _np(svalid)[0, 0], 0],
                                  np.arange(40))


# ----------------------------------------------------------- unique_compact
def _assert_unique_match(vals, valid, cap, pad=I32MAX):
    got = TR.unique_compact(_t(vals), _t(valid), cap, pad)
    args = (jnp.asarray(vals), jnp.asarray(valid))
    for ref in (
        unique_compact_ref(*args, cap, pad),
        unique_compact_pallas(*args, cap, pad, interpret=True),
    ):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(_np(a)[0], _np(b))
    assert got[2].dtype == torch.int64


@pytest.mark.parametrize("n,cap", [(17, 8), (100, 200), (64, 64), (33, 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_unique_parity_random(n, cap, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 40, n).astype(np.int32)
    valid = rng.random(n) > 0.3
    _assert_unique_match(vals, valid, cap)


def test_unique_parity_edge_cases():
    _assert_unique_match(np.arange(16, dtype=np.int32), np.zeros(16, bool), 8)
    _assert_unique_match(np.full(50, 7, np.int32), np.ones(50, bool), 16)
    vals = np.arange(30, dtype=np.int32)
    _assert_unique_match(vals, np.ones(30, bool), 30)  # exact capacity
    _assert_unique_match(vals, np.ones(30, bool), 29)  # n_unique > out_cap
    rng = np.random.default_rng(3)  # int64 values against the I64MAX pad
    v64 = rng.integers(0, 1 << 40, 32).astype(np.int64)
    _assert_unique_match(v64, rng.random(32) > 0.4, 16, pad=I64MAX)


# ---------------------------------------------------- W-batched vs batched_*
def test_batched_wrappers_parity():
    rng = np.random.default_rng(4)
    w, n = 3, 64
    lo = rng.integers(0, 30, (w, n)).astype(np.int32)
    hi = lo + rng.integers(0, 4, (w, n)).astype(np.int32)
    tl, tp, tv, tt = TR.expand(torch.from_numpy(lo), torch.from_numpy(hi),
                               128)
    bl, bp, bv, bt = (_np(x) for x in batched_expand(
        jnp.asarray(lo), jnp.asarray(hi), 128, interpret=True))
    np.testing.assert_array_equal(_np(tv), bv)
    np.testing.assert_array_equal(_np(tt), bt)
    np.testing.assert_array_equal(_np(tl)[bv], bl[bv])
    np.testing.assert_array_equal(_np(tp)[bv], bp[bv])

    vals = rng.integers(0, 99, (w, n, 3)).astype(np.int32)
    dest = rng.integers(0, w, (w, n)).astype(np.int32)
    valid = rng.random((w, n)) > 0.25
    got = TR.bucket_by_dest(torch.from_numpy(vals), torch.from_numpy(dest),
                            torch.from_numpy(valid), w, 32)
    ref = batched_bucket_by_dest(jnp.asarray(vals), jnp.asarray(dest),
                                 jnp.asarray(valid), w, 32, interpret=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), _np(b))

    got = TR.unique_compact(torch.from_numpy(vals[:, :, 0].copy()),
                            torch.from_numpy(valid), 32, I32MAX)
    ref = batched_unique_compact(jnp.asarray(vals[:, :, 0]),
                                 jnp.asarray(valid), 32, I32MAX,
                                 interpret=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_cpu_tensors_never_launch_a_kernel():
    """The plain path is chosen by the tensors' device: CPU tensors leave
    every launch count untouched."""
    before = dict(LAUNCHES)
    x = torch.zeros((2, 8), dtype=torch.int32)
    TB.range_search(x, x)
    TR.expand(x, x, 4)
    TR.unique_compact(x, x > 0, 4, I32MAX)
    TR.bucket_by_dest(x[..., None], x, x > 0, 2, 4)
    assert dict(LAUNCHES) == before
