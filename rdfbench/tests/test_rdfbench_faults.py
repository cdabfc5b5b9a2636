"""A run of each cell at a size the CPU holds, the card's look skipped:
sound, it comes out correct; with the timed path broken underneath in each
way the cell can break, ``correct`` comes out false."""
import time

import pytest
import torch

from rdfbench.harness import execute
from rdfbench.tests.tiny import CELLS, tiny_cell


def _alter(rel):
    """One id of the answer changed where it is produced."""
    idx = rel.valid.nonzero()
    if len(idx):
        w, r = idx[0].tolist()
        rel.cols[w, r, 0] += 1
    return rel


def _answer_altered(mp):
    from repro_torch.core.executor import Executor
    from repro_torch.core.pattern_index import ParallelExecutor

    for cls in (Executor, ParallelExecutor):
        fn = cls.execute

        def execute(self, *a, _fn=fn, **k):
            rel, st = _fn(self, *a, **k)
            return _alter(rel), st
        mp.setattr(cls, "execute", execute)
    fn_b = Executor.execute_batch

    def execute_batch(self, *a, **k):
        rels, stats = fn_b(self, *a, **k)
        return [_alter(r) for r in rels], stats
    mp.setattr(Executor, "execute_batch", execute_batch)


def _half_batch_left_out(mp):
    """The second half of every bucket's lanes answered by nothing."""
    from repro_torch.core.executor import Executor

    fn_b = Executor.execute_batch

    def execute_batch(self, *a, **k):
        rels, stats = fn_b(self, *a, **k)
        for r in rels[(len(rels) + 1) // 2:]:
            r.valid.zero_()
        return rels, stats
    mp.setattr(Executor, "execute_batch", execute_batch)


def _exchange_left_out(mp):
    """The hash exchange between workers left out: a worker receives only
    what it sent itself."""
    from repro_torch.core.substrate import Substrate

    for name in ("exchange_hash", "exchange_hash_batch"):
        fn = getattr(Substrate, name)

        def exchange(*a, _fn=fn, **k):
            recv, valid, *rest = _fn(*a, **k)
            w = valid.shape[-2]
            eye = torch.eye(w, dtype=torch.bool, device=valid.device)
            return (recv, valid & eye[..., None], *rest)
        mp.setattr(Substrate, name, staticmethod(exchange))


def _queries_given_up(mp):
    """Every other bucket given up on, as an engine whose retry budget ran
    out gives it up: its queries get no answer."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.core.executor import ExecutorError

    fn = AdHashEngine.execute_bucket
    calls = [0]

    def execute_bucket(self, *a, **k):
        calls[0] += 1
        if calls[0] % 2 == 0:
            raise ExecutorError("retry budget exhausted")
        return fn(self, *a, **k)
    mp.setattr(AdHashEngine, "execute_bucket", execute_bucket)


def _queries_given_up(mp):
    """Every other bucket given up on, as an engine whose retry budget ran
    out gives it up: its queries get no answer."""
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.core.executor import ExecutorError

    fn = AdHashEngine.execute_bucket
    calls = [0]

    def execute_bucket(self, *a, **k):
        calls[0] += 1
        if calls[0] % 2 == 0:
            raise ExecutorError("retry budget exhausted")
        return fn(self, *a, **k)
    mp.setattr(AdHashEngine, "execute_bucket", execute_bucket)


FAULTS = {"answer_altered": _answer_altered,
          "queries_given_up": _queries_given_up,
          "queries_given_up": _queries_given_up,
          "half_batch_left_out": _half_batch_left_out,
          "exchange_left_out": _exchange_left_out}


def _run(cell, seed=2**31 + 11):
    return execute(tiny_cell(cell), seed, 0.6, False, time.perf_counter(),
                   device="cpu", log=open("/dev/null", "w"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["compared"]["value"] >= 6
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(cell)
    assert not out["correct"]
    failing = {k for k, c in out["checks"].items()
               if "limit" in c and c["value"] > c["limit"]}
    assert failing == ({"failed_queries"} if fault == "queries_given_up"
                       else {"wrong_answers"})
