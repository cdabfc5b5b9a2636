"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (the kernels are CUDA C++ and have no
CPU mode) and skips without one.  The file imports torch, numpy and the
port only, so it runs on a machine without jax:

    python -m pytest -m cuda tests/test_torch_cuda.py

Outputs are integers and must be bit-exact (valid lanes only for
``expand``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import backend as TB
from repro_torch.core import relalg as TR
from repro_torch.kernels import LAUNCHES

I32MAX = 2**31 - 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_cuda_range_search_matches_plain(cuda_device, dtype):
    g = torch.Generator().manual_seed(0)
    keys = torch.sort(torch.randint(0, 1 << 20, (4, 5000), generator=g),
                      dim=1).values.to(dtype)
    probes = torch.randint(-5, (1 << 20) + 5, (4, 777), generator=g).to(dtype)
    got = TB.range_search(keys.to(cuda_device), probes.to(cuda_device))
    want = TB.range_search_plain(keys, probes)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


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

    for size in (1000, 40000):  # shared-memory and global sort paths
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
    assert all(v > 0 for v in LAUNCHES.values()), LAUNCHES


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
