"""Distributed Semi-Join data plane (paper §4.1, Algorithm 1 internals).

PyTorch port of ``repro.core.dsj``.  Every stage is a plain function over
tensors with a leading worker axis W (the JAX package ``vmap``s per-worker
bodies over it); each ``*_batch`` stage takes a further leading batch axis
B of queries that share one plan (the JAX package ``vmap``s the stage over
it).  Every stage runs on any leading worker count: on a mesh substrate a
rank calls it on its own worker block.  On one device the worker exchanges
are in-memory transposes (``substrate.MeshSubstrate`` swaps them for
collectives, calling ``hash_send_buffers`` / ``reply_send_buffers`` /
``reply_send_buffers_batch`` for everything before the transpose):

  * the (W_sender, W_receiver) block transpose in ``exchange_hash`` and in
    the ``probe_and_reply`` reply route is the paper's hash distribution /
    point-to-point candidate shipping,
  * the sender-axis broadcast in ``exchange_broadcast`` is the paper's
    projection-column broadcast.

The choice between the two is Observation 1, made by the locality-aware
planner.  Each exchange also returns the number of int32 cells it put on
the wire (off-diagonal traffic only), which the executor sums into the
per-query communication accounting of the paper's experiments.

No stage synchronizes with the host: overflow totals and wire cells come
back as device tensors, fetched by the executor through the chokepoints in
``substrate``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .backend import range_search
from .placement import splitmix64
from .query import O, P, S, TriplePattern, Var
from .relalg import I32MAX, bucket_by_dest, expand, gather_rows_of, \
    select_cols, unique_compact
from .triples import ShardedTripleStore, gather_rows, gather_rows_batch, \
    match_ranges, match_ranges_batch, probe_values, probe_values_batch

__all__ = [
    "PatternSpec",
    "ChainStep",
    "pattern_consts",
    "match_rows",
    "match_first",
    "project_unique",
    "hash_send_buffers",
    "exchange_hash",
    "exchange_broadcast",
    "reply_send_buffers",
    "probe_and_reply",
    "finalize_join",
    "local_probe_join",
    "local_chain",
    "local_chain_from",
    "match_rows_batch",
    "match_first_batch",
    "project_unique_batch",
    "exchange_hash_batch",
    "exchange_broadcast_batch",
    "reply_send_buffers_batch",
    "probe_and_reply_batch",
    "finalize_join_batch",
    "local_probe_join_batch",
    "local_chain_batch",
    "local_chain_from_batch",
]


# ---------------------------------------------------------------------------
# Host-static description of a triple pattern (structure only, no id values).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PatternSpec:
    s_const: bool
    p_const: bool
    o_const: bool
    same_var_so: bool  # pattern like (?x, p, ?x)
    var_cols: tuple[int, ...]  # columns (S/P/O) carrying the pattern's vars

    @classmethod
    def of(cls, q: TriplePattern) -> "PatternSpec":
        return cls(
            s_const=not isinstance(q.s, Var),
            p_const=not isinstance(q.p, Var),
            o_const=not isinstance(q.o, Var),
            same_var_so=isinstance(q.s, Var) and q.s == q.o,
            var_cols=tuple(c for _, c in q.var_cols()),
        )


@dataclass(frozen=True)
class ChainStep:
    """Host-static description of one case-(i) local join in a fused chain
    (the argument block of ``local_probe_join``)."""

    spec: PatternSpec
    join_col_rel: int  # c1: column of the running relation carrying join var
    probe_col: int  # c2: triple column the values bind (S in case (i))
    shared_checks: tuple[tuple[int, int], ...]
    append_cols: tuple[int, ...]


def pattern_consts(q: TriplePattern, device: str | torch.device
                   ) -> torch.Tensor:
    """(3,) int32 on ``device``: constant id per column, -1 where variable."""
    vals = [t.id if not isinstance(t, Var) else -1 for t in (q.s, q.p, q.o)]
    return torch.tensor(vals, dtype=torch.int32, device=device)


def _residual_mask(rows: torch.Tensor, valid: torch.Tensor,
                   spec: PatternSpec, consts: torch.Tensor,
                   probed: tuple[int, ...]) -> torch.Tensor:
    """Enforce pattern constants not already enforced by the index probe,
    plus same-variable (?x p ?x) equality.  ``consts[c]`` is column c's
    constant, broadcastable against ``rows[..., c]`` (a batch passes
    ``_batch_consts``)."""
    for c, is_c in ((S, spec.s_const), (P, spec.p_const), (O, spec.o_const)):
        if is_c and c not in probed:
            valid = valid & (rows[..., c] == consts[c])
    if spec.same_var_so:
        valid = valid & (rows[..., S] == rows[..., O])
    return valid


def _join_output(ltuple: torch.Tensor, rtriple: torch.Tensor,
                 valid: torch.Tensor,
                 shared_checks: tuple[tuple[int, int], ...],
                 append_cols: tuple[int, ...]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared-variable checks + appended columns of a join step's output;
    invalid rows are -1."""
    for rc, tc in shared_checks:
        valid = valid & (ltuple[..., rc] == rtriple[..., tc])
    out = ltuple
    if append_cols:
        out = torch.cat([ltuple, select_cols(rtriple, append_cols)], dim=-1)
    out = torch.where(valid[..., None], out, torch.full_like(out, -1))
    return out, valid


# ---------------------------------------------------------------- first match
def match_rows(
    store: ShardedTripleStore,
    consts: torch.Tensor,  # (3,) int32, -1 = variable
    spec: PatternSpec,
    cap_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local pattern match returning full triple rows.

    Returns (rows (W, cap_out, 3), valid, max_total)."""
    nid = store.n_ids
    none = torch.full_like(consts[0], -1)
    if spec.p_const and spec.s_const:
        use_po, probed = False, (P, S)
        lo, hi = match_ranges(store, consts[P], consts[S], False, nid)
    elif spec.p_const and spec.o_const:
        use_po, probed = True, (P, O)
        lo, hi = match_ranges(store, consts[P], consts[O], True, nid)
    elif spec.p_const:
        use_po, probed = False, (P,)
        lo, hi = match_ranges(store, consts[P], none, False, nid)
    else:
        use_po, probed = False, ()
        lo, hi = match_ranges(store, none, none, False, nid)
    rows, _, valid, totals = gather_rows(store, lo[:, None], hi[:, None],
                                         cap_out, use_po=use_po)
    valid = _residual_mask(rows, valid, spec, consts, probed)
    return rows, valid, totals.max()


def match_first(
    store: ShardedTripleStore,
    consts: torch.Tensor,  # (3,) int32, -1 = variable
    spec: PatternSpec,
    cap_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """answerSubquery(q) on local shards (Algorithm 1 line 10).

    Returns (cols (W, cap_out, k), valid (W, cap_out), max_total (0-d)).
    Index selection mirrors §3.2: (p,s)->PS, (p,o)->PO, (p)->P, else scan."""
    rows, valid, max_total = match_rows(store, consts, spec, cap_out)
    cols = select_cols(rows, spec.var_cols)
    cols = torch.where(valid[..., None], cols, torch.full_like(cols, -1))
    return cols, valid, max_total


# ----------------------------------------------------------------- projection
def project_unique(
    cols: torch.Tensor, valid: torch.Tensor, col_idx: int, cap_proj: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pi_c(RS) with per-worker dedup (the paper ships projected columns).

    Returns (proj (W, cap_proj), proj_valid, max_unique (overflow check))."""
    u, uv, n = unique_compact(cols[..., col_idx].contiguous(), valid,
                              cap_proj, I32MAX)
    return torch.where(uv, u, torch.full_like(u, -1)), uv, n.max()


# ------------------------------------------------------------------ exchanges
def hash_send_buffers(
    proj: torch.Tensor,  # (R, cap_proj): W workers, or a batch's B*W rows
    proj_valid: torch.Tensor,
    n_workers: int,  # the hash modulus
    cap_peer: int,
    spec=None,  # placement.PlacementSpec | None (None = plain hash owner)
    table=None,  # placement.DirectoryTable when spec is directory
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-worker destination bucketing for the hash exchange.

    Under hash placement (``spec=None``) value v goes to its owner
    H(v) mod W.  With a directory placement spec, each value fans out to
    the whole split set of its subject: ``spec.max_split`` replicas a value,
    those past the subject's split factor invalid, all of them in ONE
    bucket_by_dest launch over F*n rows a worker (replica-major, as the
    reference flattens its (F, n) destinations, so the stable bucketing
    keeps its order).  Returns (send (R, n_workers, cap_peer), send_valid,
    max_wanted (R,))."""
    if spec is None:
        dest = (splitmix64(proj) % n_workers).to(torch.int32)
        send, svalid, max_wanted = bucket_by_dest(
            proj[..., None], dest, proj_valid, n_workers, cap_peer)
        return send[..., 0], svalid, max_wanted
    dests, dvalid = spec.value_dests(proj, proj_valid, table)  # (R, F, n)
    r, f, n = dests.shape
    vals = proj[:, None, :].expand(r, f, n).reshape(r, f * n, 1)
    send, svalid, max_wanted = bucket_by_dest(
        vals, dests.reshape(r, f * n), dvalid.reshape(r, f * n), n_workers,
        cap_peer)
    return send[..., 0], svalid, max_wanted


def _off_diagonal(svalid: torch.Tensor) -> torch.Tensor:
    """Valid cells sent to another worker (w -> w stays local), int64.
    ``svalid`` is (..., W, W, cap); one count per leading index."""
    lead = svalid.dim() - 3
    diag = torch.diagonal(svalid, dim1=lead, dim2=lead + 1)
    return (svalid.sum(dim=(-3, -2, -1)) - diag.sum(dim=(-2, -1))
            ).to(torch.int64)


def exchange_hash(
    proj: torch.Tensor,  # (W, cap_proj)
    proj_valid: torch.Tensor,
    cap_peer: int,
    spec=None,
    table=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Observation 1 fast path: hash-distribute the projected join column.

    The placement names the owner(s) of each value: under hash placement
    (``spec=None``) each value goes to exactly one worker; under directory
    placement a split subject's value is replicated to its whole split set
    (see ``hash_send_buffers``).  Returns (recv (W_recv, W_send, cap_peer),
    recv_valid, cells_sent, max_bucket)."""
    w = proj.shape[0]
    send, svalid, maxw = hash_send_buffers(proj, proj_valid, w, cap_peer,
                                           spec=spec, table=table)
    # (W_sender, W_receiver, cap) -> (W_receiver, W_sender, cap)
    recv = send.transpose(0, 1).contiguous()
    recv_valid = svalid.transpose(0, 1).contiguous()
    return recv, recv_valid, _off_diagonal(svalid), maxw.max()


def exchange_broadcast(
    proj: torch.Tensor, proj_valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Observation 1 slow path: every worker receives every projection.

    Returns (recv (W_recv, W_send, cap_proj), recv_valid, cells_sent)."""
    w = proj.shape[0]
    recv = proj[None].expand((w,) + proj.shape)
    recv_valid = proj_valid[None].expand((w,) + proj_valid.shape)
    cells = proj_valid.sum(dtype=torch.int64) * (w - 1)  # to W-1 peers
    return recv, recv_valid, cells


# -------------------------------------------------------------- probe + reply
def reply_send_buffers(
    store: ShardedTripleStore,
    recv: torch.Tensor,  # (W, n_send, cap_peer)
    recv_valid: torch.Tensor,
    consts: torch.Tensor,
    spec: PatternSpec,
    probe_col: int,
    cap_flat: int,
    cap_cand: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local semi-join probe + per-sender candidate bucketing — everything
    ``probe_and_reply`` does before the reply-route transpose.

    Returns (send (W, n_send, cap_cand, 3), send_valid, totals (W,),
    max_bucket (W,))."""
    w, n_send, cap_peer = recv.shape
    flat_vals = recv.reshape(w, n_send * cap_peer)
    flat_valid = recv_valid.reshape(w, n_send * cap_peer)
    lo, hi = probe_values(store, consts[P], flat_vals, flat_valid,
                          probe_col, store.n_ids)
    rows, src, valid, totals = gather_rows(store, lo, hi, cap_flat,
                                           use_po=(probe_col == O))
    valid = _residual_mask(rows, valid, spec, consts, probed=(P, probe_col))
    sender = torch.div(src, cap_peer, rounding_mode="floor")
    send, svalid, maxb = bucket_by_dest(rows, sender, valid, n_send,
                                        cap_cand)
    return send, svalid, totals, maxb


def probe_and_reply(
    store: ShardedTripleStore,
    recv: torch.Tensor,  # (W, W_send, cap_peer) received join-column values
    recv_valid: torch.Tensor,
    consts: torch.Tensor,  # (3,) pattern constants
    spec: PatternSpec,
    probe_col: int,  # S, P or O — the column the values bind (c2)
    cap_flat: int,  # probe expansion capacity (this worker, all senders)
    cap_cand: int,  # per-(replier, sender) candidate capacity
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Each worker semi-joins the received values against its local index
    and routes candidate triples back to their senders (Algorithm 1 lines
    13-23).

    Returns (cand (W_sender, W_replier, cap_cand, 3), cand_valid,
    cells_sent, max_flat, max_bucket) — cand is already routed back."""
    send, svalid, totals, maxb = reply_send_buffers(
        store, recv, recv_valid, consts, spec, probe_col, cap_flat, cap_cand)
    # (W_replier, W_sender, cap, 3) -> (W_sender, W_replier, cap, 3)
    cand = send.transpose(0, 1).contiguous()
    cand_valid = svalid.transpose(0, 1).contiguous()
    return (cand, cand_valid, _off_diagonal(svalid) * 3, totals.max(),
            maxb.max())


# ------------------------------------------------------------------- finalize
def finalize_join(
    rel_cols: torch.Tensor,  # (W, capR, k) current intermediate RS1
    rel_valid: torch.Tensor,
    cand: torch.Tensor,  # (W, R, cap_cand, 3) candidate triples (routed back)
    cand_valid: torch.Tensor,
    join_col_rel: int,  # column of RS1 carrying the join variable (c1)
    probe_col: int,  # column of the candidate triple carrying c2
    # (rel_col, triple_col) equality checks for additional shared variables
    shared_checks: tuple[tuple[int, int], ...],
    append_cols: tuple[int, ...],  # triple columns to append (new variables)
    cap_out: int,
    cap_live: int | None = None,  # slots of each bucket that can be live
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RS1 |><| candidates on RS1.c1 = cand.c2 (local hash join, line 27).

    New columns are appended for the pattern's variables not yet bound.
    ``cap_live`` (see ``_finalize_rows``) narrows the candidates sorted to
    the filled prefix of each bucket; None sorts all ``cap_cand`` slots.
    Returns (out_cols (W, cap_out, k + new), out_valid, max_total)."""
    out, valid, total = _finalize_rows(rel_cols, rel_valid, cand, cand_valid,
                                       join_col_rel, probe_col, shared_checks,
                                       append_cols, cap_out, cap_live)
    return out, valid, total.max()


def _finalize_rows(rel_cols, rel_valid, cand, cand_valid, join_col_rel,
                   probe_col, shared_checks, append_cols, cap_out,
                   cap_live=None):
    """``finalize_join`` row by row: every op works within one worker row,
    so a batch runs it on its B*W rows.  Returns the per-row totals.

    Only the first ``cap_live`` slots of each (replier, cap_cand) bucket are
    keyed and sorted.  ``bucket_by_dest`` fills a destination from slot 0 in
    input order and pads the rest, so a bucket's live candidates are its
    first ``count`` slots; the executor passes ``quantize_capacity(mc)``,
    where ``mc`` is the largest ``count`` that ``probe_and_reply``'s
    overflow check has already read.  The slice keeps every live slot in
    its (replier, slot) order, so the stable sort, the ranges and the
    output are those of the whole row."""
    w, r, cc, _ = cand.shape
    if cap_live is not None and cap_live < cc:
        cand, cand_valid = cand[:, :, :cap_live], cand_valid[:, :, :cap_live]
        cc = cap_live
    flat_cand = cand.reshape(w, r * cc, 3)
    flat_cvalid = cand_valid.reshape(w, r * cc)
    big = torch.full_like(flat_cand[..., 0], I32MAX)
    key = torch.where(flat_cvalid, flat_cand[..., probe_col], big)
    # stable, like jnp.argsort: tied candidates keep their routed order
    skey, order = torch.sort(key, dim=1, stable=True)
    del key
    probe = torch.where(rel_valid, rel_cols[..., join_col_rel],
                        torch.full_like(rel_valid, I32MAX, dtype=torch.int32))
    lo, hi = range_search(skey, probe)
    hi = torch.where(rel_valid & (probe != I32MAX), hi, lo)
    left, pos, valid, total = expand(lo, hi, cap_out)
    ltuple = gather_rows_of(rel_cols, left)
    # the sorted candidates' rows at ``pos``, gathered through ``order``:
    # the whole sorted candidate table (R*cap_cand rows) is never built
    rtriple = gather_rows_of(flat_cand, gather_rows_of(order, pos))
    out, valid = _join_output(ltuple, rtriple, valid, shared_checks,
                              append_cols)
    return out, valid, total


# ----------------------------------------------------- case (i): no-comm join
def local_probe_join(
    store: ShardedTripleStore,
    rel_cols: torch.Tensor,  # (W, capR, k)
    rel_valid: torch.Tensor,
    consts: torch.Tensor,
    spec: PatternSpec,
    join_col_rel: int,
    probe_col: int,  # S in case (i)
    shared_checks: tuple[tuple[int, int], ...],
    append_cols: tuple[int, ...],
    cap_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JoinWithoutCommunication (Algorithm 1 line 7): c2 = pinned subject,
    so every matching triple is already local.  Probe own index directly."""
    vals = rel_cols[..., join_col_rel]
    lo, hi = probe_values(store, consts[P], vals, rel_valid, probe_col,
                          store.n_ids)
    rows, src, valid, totals = gather_rows(store, lo, hi, cap_out,
                                           use_po=(probe_col == O))
    valid = _residual_mask(rows, valid, spec, consts, probed=(P, probe_col))
    ltuple = gather_rows_of(rel_cols, src)
    out, valid = _join_output(ltuple, rows, valid, shared_checks, append_cols)
    return out, valid, totals.max()


# ================================================ fused case-(i) chain bodies
# When every join of a query is case (i) (subject star under hash
# placement — the paper's Observation (i)), the whole query is one
# communication-free per-shard program: match_first followed by N local
# probe joins.  The executor defers every overflow check to one stacked
# totals vector fetched once at chain end (the speculative one-sync retry
# protocol).  Per-stage intermediates are all returned because the retry
# restarts from the last accepted stage.
def local_chain(
    store: ShardedTripleStore,
    consts: torch.Tensor,  # (1+N, 3) int32, row 0 = first pattern
    first_spec: PatternSpec,
    first_keep: tuple[int, ...],
    steps: tuple[ChainStep, ...],
    caps: tuple[int, ...],  # (1+N,) per-stage capacity classes
) -> tuple[tuple[tuple[torch.Tensor, torch.Tensor], ...], torch.Tensor]:
    """Whole case-(i) query: match_first + N local probe joins.

    ``first_keep`` drops duplicate-variable columns after the first match
    (the c1 indices in ``steps`` assume the post-keep layout).  Returns
    (rels, totals): rels[i] = (cols (W, caps[i], k_i), valid) for stage i
    (0 = post-match_first) and totals the (1+N,) stacked per-stage overflow
    vector — the executor's single host sync."""
    cols, valid, t0 = match_first(store, consts[0], first_spec, caps[0])
    if len(first_keep) != len(first_spec.var_cols):
        cols = select_cols(cols, first_keep)
    rels, totals = local_chain_from(store, cols, valid, consts[1:], steps,
                                    caps[1:])
    return ((cols, valid),) + rels, torch.cat([t0[None], totals])


def local_chain_from(
    store: ShardedTripleStore,
    rel_cols: torch.Tensor,  # (W, capR, k) accepted intermediate
    rel_valid: torch.Tensor,
    consts: torch.Tensor,  # (N_tail, 3) aligned with steps
    steps: tuple[ChainStep, ...],
    caps: tuple[int, ...],
) -> tuple[tuple[tuple[torch.Tensor, torch.Tensor], ...], torch.Tensor]:
    """Suffix restart: re-run ``steps`` seeded from an accepted
    intermediate (row i of ``consts`` feeds step i)."""
    cols, valid = rel_cols, rel_valid
    rels = []
    totals = []
    for i, stp in enumerate(steps):
        cols, valid, t = local_probe_join(
            store, cols, valid, consts[i], stp.spec, stp.join_col_rel,
            stp.probe_col, stp.shared_checks, stp.append_cols, caps[i],
        )
        rels.append((cols, valid))
        totals.append(t)
    stacked = (torch.stack(totals) if totals else
               torch.zeros(0, dtype=torch.int64, device=rel_cols.device))
    return tuple(rels), stacked


# ===================================================== batched (multi-query)
# One call evaluates a whole shape bucket of queries stacked on a leading
# batch axis B (the JAX package vmaps the stages above over it).  All
# queries of a bucket share the static arguments (PatternSpec, capacities,
# join structure: what WorkloadBatcher buckets on); only the pattern
# constants, (B, 3), and the flowing tensors differ per query.  Per-query
# scalars (comm cells, overflow totals) come back as (B,) tensors so the
# executor keeps the paper's per-query communication accounting exact.
#
# How a batch folds into the kernels, one launch per stage for the bucket:
#   * probes of the shared store (range_search, span_search): the (B, W, M)
#     probes become (W, B*M) rows of the store's (W, N) keys (triples.py's
#     batched probes); ``match_ranges`` is the span form at M = B;
#   * expand, unique_compact, bucket_by_dest and finalize_join's probe of
#     its own sorted candidates work row by row: (B, W, ...) operands are
#     B*W rows, and bucket_by_dest keeps n_dest = W.
def _batch_consts(consts: torch.Tensor) -> torch.Tensor:
    """(B, 3) constants as the (3, B, 1, 1) columns ``_residual_mask``
    broadcasts against (B, W, cap) rows."""
    return consts.t()[:, :, None, None]


def match_rows_batch(
    store: ShardedTripleStore,
    consts: torch.Tensor,  # (B, 3) int32, -1 = variable
    spec: PatternSpec,
    cap_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``match_rows``: (rows (B, W, cap_out, 3), valid, max_total
    (B,)); one span_search launch at M = B and one expand over B*W rows."""
    nid = store.n_ids
    none = torch.full_like(consts[:, 0], -1)
    if spec.p_const and spec.s_const:
        use_po, probed = False, (P, S)
        lo, hi = match_ranges_batch(store, consts[:, P], consts[:, S], False,
                                    nid)
    elif spec.p_const and spec.o_const:
        use_po, probed = True, (P, O)
        lo, hi = match_ranges_batch(store, consts[:, P], consts[:, O], True,
                                    nid)
    elif spec.p_const:
        use_po, probed = False, (P,)
        lo, hi = match_ranges_batch(store, consts[:, P], none, False, nid)
    else:
        use_po, probed = False, ()
        lo, hi = match_ranges_batch(store, none, none, False, nid)
    rows, _, valid, totals = gather_rows_batch(store, lo[..., None],
                                               hi[..., None], cap_out,
                                               use_po=use_po)
    valid = _residual_mask(rows, valid, spec, _batch_consts(consts), probed)
    return rows, valid, totals.amax(dim=1)


def match_first_batch(
    store: ShardedTripleStore,
    consts: torch.Tensor,  # (B, 3) int32, -1 = variable
    spec: PatternSpec,
    cap_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``match_first``: (cols (B, W, cap_out, k), valid, total
    (B,))."""
    rows, valid, max_total = match_rows_batch(store, consts, spec, cap_out)
    cols = select_cols(rows, spec.var_cols)
    cols = torch.where(valid[..., None], cols, torch.full_like(cols, -1))
    return cols, valid, max_total


def project_unique_batch(
    cols: torch.Tensor,  # (B, W, capR, k)
    valid: torch.Tensor,
    col_idx: int,
    cap_proj: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``project_unique``: (proj (B, W, cap_proj), valid, max
    (B,)); one unique_compact launch over B*W rows."""
    b, w, n = valid.shape
    u, uv, nu = unique_compact(cols[..., col_idx].reshape(b * w, n),
                               valid.reshape(b * w, n), cap_proj, I32MAX)
    u = torch.where(uv, u, torch.full_like(u, -1))
    return (u.view(b, w, cap_proj), uv.view(b, w, cap_proj),
            nu.view(b, w).amax(dim=1))


def exchange_hash_batch(
    proj: torch.Tensor,  # (B, W, cap_proj)
    proj_valid: torch.Tensor,
    cap_peer: int,
    spec=None,
    table=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``exchange_hash``: (recv (B, W_recv, W_send, cap_peer),
    recv_valid, cells (B,), max_bucket (B,)); one bucket_by_dest launch over
    B*W rows with n_dest = W.  The placement table is shared by the whole
    batch."""
    b, w, n = proj.shape
    send, svalid, maxw = hash_send_buffers(proj.reshape(b * w, n),
                                           proj_valid.reshape(b * w, n), w,
                                           cap_peer, spec=spec, table=table)
    send = send.view(b, w, w, cap_peer)
    svalid = svalid.view(b, w, w, cap_peer)
    return (send.transpose(1, 2).contiguous(),
            svalid.transpose(1, 2).contiguous(), _off_diagonal(svalid),
            maxw.view(b, w).amax(dim=1))


def exchange_broadcast_batch(
    proj: torch.Tensor, proj_valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``exchange_broadcast``: (recv (B, W_recv, W_send, cap_proj),
    recv_valid, cells (B,))."""
    b, w, n = proj.shape
    recv = proj[:, None].expand(b, w, w, n)
    recv_valid = proj_valid[:, None].expand(b, w, w, n)
    cells = proj_valid.sum(dim=(1, 2), dtype=torch.int64) * (w - 1)
    return recv, recv_valid, cells


def reply_send_buffers_batch(
    store: ShardedTripleStore,
    recv: torch.Tensor,  # (B, W, W_send, cap_peer)
    recv_valid: torch.Tensor,
    consts: torch.Tensor,  # (B, 3)
    spec: PatternSpec,
    probe_col: int,
    cap_flat: int,
    cap_cand: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``reply_send_buffers``: everything ``probe_and_reply_batch``
    does before the reply-route transpose.  One range_search over (W,
    B*W_send*cap_peer) probes, one expand and one bucket_by_dest over the
    B*W rows, kept worker-major so the rows gather from the store and feed
    bucket_by_dest without a copy.  Returns (send (W_replier, B, W_send,
    cap_cand, 3), send_valid, max_flat (B,), max_bucket (B,))."""
    b, w, n_send, cap_peer = recv.shape
    lo, hi = probe_values_batch(store, consts[:, P],
                                recv.reshape(b, w, n_send * cap_peer),
                                recv_valid.reshape(b, w, n_send * cap_peer),
                                probe_col, store.n_ids)
    rows, src, valid, totals = gather_rows_batch(store, lo, hi, cap_flat,
                                                 use_po=(probe_col == O))
    del lo, hi
    valid = _residual_mask(rows, valid, spec, _batch_consts(consts),
                           probed=(P, probe_col))
    sender = torch.div(src, cap_peer, rounding_mode="floor")
    wm = lambda x: x.transpose(0, 1).reshape((w * b,) + x.shape[2:])
    send, svalid, maxb = bucket_by_dest(wm(rows), wm(sender), wm(valid),
                                        n_send, cap_cand)
    return (send.view(w, b, n_send, cap_cand, 3),
            svalid.view(w, b, n_send, cap_cand), totals.amax(dim=1),
            maxb.view(w, b).amax(dim=0))


def probe_and_reply_batch(
    store: ShardedTripleStore,
    recv: torch.Tensor,  # (B, W, W_send, cap_peer)
    recv_valid: torch.Tensor,
    consts: torch.Tensor,  # (B, 3)
    spec: PatternSpec,
    probe_col: int,
    cap_flat: int,
    cap_cand: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Batched ``probe_and_reply``: (cand (B, W_sender, W_replier,
    cap_cand, 3), cand_valid, cells (B,), max_flat (B,), max_bucket (B,))."""
    send, svalid, max_flat, maxb = reply_send_buffers_batch(
        store, recv, recv_valid, consts, spec, probe_col, cap_flat, cap_cand)
    # (W_replier, B, W_sender, cap, ...) -> (B, W_sender, W_replier, cap, ...)
    cand = send.permute(1, 2, 0, 3, 4).contiguous()
    del send
    cand_valid = svalid.permute(1, 2, 0, 3).contiguous()
    return cand, cand_valid, _off_diagonal(cand_valid) * 3, max_flat, maxb


def finalize_join_batch(
    rel_cols: torch.Tensor,  # (B, W, capR, k)
    rel_valid: torch.Tensor,
    cand: torch.Tensor,  # (B, W, R, cap_cand, 3)
    cand_valid: torch.Tensor,
    join_col_rel: int,
    probe_col: int,
    shared_checks: tuple[tuple[int, int], ...],
    append_cols: tuple[int, ...],
    cap_out: int,
    cap_live: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``finalize_join``: (out (B, W, cap_out, k+new), valid,
    max_total (B,)); each kernel launches once over the B*W rows.
    ``cap_live`` as in ``finalize_join``."""
    b, w = rel_valid.shape[:2]
    rows = lambda x: x.reshape((b * w,) + x.shape[2:])
    out, valid, total = _finalize_rows(
        rows(rel_cols), rows(rel_valid), rows(cand), rows(cand_valid),
        join_col_rel, probe_col, shared_checks, append_cols, cap_out,
        cap_live)
    return (out.view((b, w) + out.shape[1:]), valid.view(b, w, cap_out),
            total.view(b, w).amax(dim=1))


def local_probe_join_batch(
    store: ShardedTripleStore,
    rel_cols: torch.Tensor,  # (B, W, capR, k)
    rel_valid: torch.Tensor,
    consts: torch.Tensor,  # (B, 3)
    spec: PatternSpec,
    join_col_rel: int,
    probe_col: int,
    shared_checks: tuple[tuple[int, int], ...],
    append_cols: tuple[int, ...],
    cap_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``local_probe_join`` (store shared, queries batched):
    (out (B, W, cap_out, k+new), valid, max_total (B,))."""
    b, w, cap_r, k = rel_cols.shape
    lo, hi = probe_values_batch(store, consts[:, P],
                                rel_cols[..., join_col_rel], rel_valid,
                                probe_col, store.n_ids)
    rows, src, valid, totals = gather_rows_batch(store, lo, hi, cap_out,
                                                 use_po=(probe_col == O))
    valid = _residual_mask(rows, valid, spec, _batch_consts(consts),
                           probed=(P, probe_col))
    ltuple = gather_rows_of(rel_cols.reshape(b * w, cap_r, k),
                            src.reshape(b * w, cap_out)
                            ).view(b, w, cap_out, k)
    out, valid = _join_output(ltuple, rows, valid, shared_checks, append_cols)
    return out, valid, totals.amax(dim=1)


def local_chain_batch(
    store: ShardedTripleStore,
    consts: torch.Tensor,  # (B, 1+N, 3)
    first_spec: PatternSpec,
    first_keep: tuple[int, ...],
    steps: tuple[ChainStep, ...],
    caps: tuple[int, ...],
) -> tuple[tuple[tuple[torch.Tensor, torch.Tensor], ...], torch.Tensor]:
    """Batched fused chain for a whole shape bucket: rels[i] leaves gain a
    leading B axis; totals comes back (1+N, B), stage-major, so the
    executor's single host sync takes per-stage maxima."""
    cols, valid, t0 = match_first_batch(store, consts[:, 0], first_spec,
                                        caps[0])
    if len(first_keep) != len(first_spec.var_cols):
        cols = select_cols(cols, first_keep)
    rels, totals = local_chain_from_batch(store, cols, valid, consts[:, 1:],
                                          steps, caps[1:])
    return ((cols, valid),) + rels, torch.cat([t0[None], totals])


def local_chain_from_batch(
    store: ShardedTripleStore,
    rel_cols: torch.Tensor,  # (B, W, capR, k)
    rel_valid: torch.Tensor,
    consts: torch.Tensor,  # (B, N_tail, 3)
    steps: tuple[ChainStep, ...],
    caps: tuple[int, ...],
) -> tuple[tuple[tuple[torch.Tensor, torch.Tensor], ...], torch.Tensor]:
    """Batched suffix restart; totals (N_tail, B) stage-major."""
    cols, valid = rel_cols, rel_valid
    rels = []
    totals = []
    for i, stp in enumerate(steps):
        cols, valid, t = local_probe_join_batch(
            store, cols, valid, consts[:, i], stp.spec, stp.join_col_rel,
            stp.probe_col, stp.shared_checks, stp.append_cols, caps[i],
        )
        rels.append((cols, valid))
        totals.append(t)
    stacked = (torch.stack(totals) if totals else
               torch.zeros((0, rel_cols.shape[0]), dtype=torch.int64,
                           device=rel_cols.device))
    return tuple(rels), stacked
