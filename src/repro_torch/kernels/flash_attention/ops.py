"""Wrapper of the flash_attention kernels and their plain PyTorch version.

Two hand-written kernels serve a CUDA tensor, chosen by its dtype
(``flash_engine``): bfloat16 runs on the tensor cores (``wgmma``, TMA and a
warp-specialised pipeline; ``csrc/flash_attn_sm90.cu``), float32 on the
CUDA cores (``csrc/flash_attn.cu``), because TF32 tensor-core products
would not hold float32's 1e-4.  Both count as ``LAUNCHES["flash_attention"]``.

Under autograd (grad enabled and an operand that requires grad) the call
goes through ``FlashAttentionFn``: its forward launches the same kernel,
which then also writes each row's log-sum-exp, and its backward launches
the hand-written backward on the forward's engine, counted as
``LAUNCHES["flash_attention_bwd"]``: bfloat16 on the tensor cores
(``wgmma``, TMA, warp-specialised dK/dV and dQ passes;
``csrc/flash_attn_bwd_sm90.cu``), float32 on the CUDA cores
(``csrc/flash_attn_bwd.cu``).  The JAX package has no backward kernel: it
differentiates ``_blocked_attn`` by autodiff, and the backward computes
what that autodiff computes.  On CPU tensors the same Function runs the
plain forward and ``flash_attention_bwd_plain``.

Replaces ``repro.kernels.flash_attention.flash_attention.flash_attention_fwd``
(the TPU forward kernel) in the function ``repro.models.attention.
_blocked_attn`` computes: softmax attention with scale ``hd**-0.5``,
grouped-query heads (query head ``h`` reads KV head ``h // (H / KV)``),
keys past ``S`` masked, when causal key ``s`` visible to query ``t`` iff
``s <= q_offset + t`` (top-left alignment, as the Pallas kernel and
``_blocked_attn`` have it; ``attention_ref`` in the JAX package aligns
bottom-right and agrees only when T == S), and with a window ``w > 0`` iff
also ``s > q_offset + t - w`` (``_blocked_attn``'s local attention, which
the TPU kernel does not take: the hybrid family's layers).  Logits, softmax
state and the P.V sum are float32; the output has q's dtype.  A query row
that sees no key at all (only a window can do that, with ``q_offset + t >=
S + w - 1``) is outside the contract: the kernels give it zeros, the plain
version the mean of v, ``_blocked_attn`` the mean over its padded keys.

Both the forward and the backward kernels take head dims 16 to 256
(``HEAD_DIMS``) and a window: the backward computes the autodiff of
``_blocked_attn`` with its local window, so the hybrid family trains on the
card.  A window of at least ``q_offset + T`` hides nothing and gives the
unwindowed launch's bits, in either direction.

The layout is the model's: q (B, T, H, hd), k and v (B, S, KV, hd).  The
TPU wrapper's artefacts are not carried over: KV heads are not repeated,
the head dim is not padded to 128, and T and S need not be block multiples.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_cuda, stream_ptr

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_cuda",
           "flash_attention_bwd_plain", "flash_attention_bwd_cuda",
           "FlashAttentionFn", "flash_engine", "HEAD_DIMS"]

NEG_INF = -1e30
#: head dims the forward and backward kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: dtype -> (engine, exported symbol) of the kernel that serves it
_ENGINES = {torch.bfloat16: ("wgmma", "adhash_flash_attn_bf16"),
            torch.float32: ("cuda-core", "adhash_flash_attn_f32")}
#: dtype -> exported symbol of the backward kernel, on the forward's engine:
#: bf16 on the tensor cores (flash_attn_bwd_sm90.cu), float32 on the CUDA
#: cores (flash_attn_bwd.cu)
_BWD = {torch.bfloat16: "adhash_flash_attn_bwd_bf16",
        torch.float32: "adhash_flash_attn_bwd_f32"}


def flash_engine(dtype: torch.dtype) -> str:
    """The kernel a CUDA tensor of ``dtype`` launches: ``"wgmma"`` (bf16,
    tensor cores) or ``"cuda-core"`` (float32).  Raises on any other
    dtype."""
    if dtype not in _ENGINES:
        raise TypeError(f"flash_attention: no kernel for {dtype}; the kernels "
                        "take bfloat16 (tensor cores) or float32 (CUDA cores)")
    return _ENGINES[dtype][0]


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(
            "flash_attention: expected q (B, T, H, hd) and k, v (B, S, KV, "
            f"hd); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"flash_attention: {q.shape[2]} query heads are not "
                         f"a multiple of {k.shape[2]} KV heads")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys (S == 0)")


def _masked_logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   q_offset: int, window: int = 0) -> torch.Tensor:
    """(B, H, T, S) float32 scaled logits, masked keys at NEG_INF; KV heads
    repeated to the query heads."""
    t, h, hd = q.shape[1:]
    s, kvh = k.shape[1:3]
    kf = k.float().repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), kf) * (hd ** -0.5)
    if causal or window > 0:
        qpos = (q_offset + torch.arange(t, device=q.device))[:, None]
        kpos = torch.arange(s, device=q.device)[None, :]
        hidden = torch.zeros((t, s), dtype=torch.bool, device=q.device)
        if causal:
            hidden |= kpos > qpos
        if window > 0:
            hidden |= kpos <= qpos - window
        logits = logits.masked_fill(hidden, NEG_INF)
    return logits


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          window: int = 0, return_lse: bool = False):
    """Masked float32 softmax attention, GQA by ``repeat_interleave``.
    With ``return_lse`` also each row's log-sum-exp of the scaled logits,
    (B, H, T) float32."""
    _check_shapes(q, k, v)
    h, kvh = q.shape[2], k.shape[2]
    logits = _masked_logits(q, k, causal, q_offset, window)
    vf = v.float().repeat_interleave(h // kvh, dim=2)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", w, vf).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(logits, dim=-1)
    return o


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True, q_offset: int = 0,
                              window: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of the attention output ``o`` for the output gradient
    ``do``, in float32 math from the forward's log-sum-exp ``lse``
    (B, H, T): P = exp(logits - lse), D = rowsum(dO * O), dS = P (dO V^T -
    D), dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO, the KV gradients
    summed over each KV head's query heads.  Returned in the inputs'
    dtype."""
    _check_shapes(q, k, v)
    b, t, h, hd = q.shape
    s, kvh = k.shape[1:3]
    g = h // kvh
    scale = hd ** -0.5
    p = torch.exp(_masked_logits(q, k, causal, q_offset, window) -
                  lse.float()[..., None])
    dof = do.float()
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    dsum = (dof * o.float()).sum(-1).transpose(1, 2)  # (B, H, T)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - dsum[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()) * scale
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dk = dk.reshape(b, s, kvh, g, hd).sum(3)
    dv = dv.reshape(b, s, kvh, g, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous rows on 16-byte aligned storage (the kernel reads 16-byte
    vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_launch(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, q_offset: int, window: int) -> None:
    """What both kernels' launches take: one CUDA device and dtype, a head
    dim they are compiled for, the grid's and the index type's limits."""
    check_cuda(name, q, k, v)
    _check_shapes(q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    flash_engine(q.dtype)
    b, t, h, hd = q.shape
    s = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{name}: B*H = {b * h} exceeds the grid's 65535")
    if max(t, s) >= 2**31:
        raise ValueError(f"{name}: T = {t} or S = {s} is not below 2^31")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset {q_offset} < 0")
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         window: int = 0, return_lse: bool = False):
    """Launch the hand-written forward kernel that ``q``'s dtype selects
    (``flash_engine``).  With ``return_lse`` the kernel also writes each
    row's log-sum-exp, returned as a second (B, H, T) float32 tensor."""
    from repro_torch.kernels.build import check, library

    _check_launch("flash_attention", q, k, v, q_offset, window)
    b, t, h, hd = q.shape
    s, kvh = k.shape[1:3]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b > 0 and t > 0:
        fn = getattr(library(), _ENGINES[q.dtype][1])
        check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, t, s, h, kvh,
                 hd, int(causal), int(q_offset), int(window), stream_ptr(q)),
              "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, q_offset: int = 0,
                             window: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the hand-written backward that ``q``'s dtype selects
    (``flash_engine``): dq, dk and dv in the inputs' dtype, from the
    forward's output ``o`` and log-sum-exp ``lse`` (B, H, T) float32,
    for the mask the forward had (``causal``, ``q_offset``, ``window``)."""
    from repro_torch.kernels.build import BWD_T_PAD, check, library

    _check_launch("flash_attention_bwd", q, k, v, q_offset, window)
    check_cuda("flash_attention_bwd", q, o, do, lse)
    b, t, h, hd = q.shape
    s, kvh = k.shape[1:3]
    if o.shape != q.shape or do.shape != q.shape or \
            o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: o and do must have q's shape "
                         f"{tuple(q.shape)} and dtype {q.dtype}; got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)} "
                         f"{do.dtype}")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: lse must be (B, H, T) = "
                         f"{(b, h, t)} float32; got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    q, k, v, o, do = (_aligned(x) for x in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or t == 0:
        return dq, dk.zero_(), dv.zero_()
    # D = rowsum(dO * O) and, for bf16, L * log2(e), in rows padded to
    # BWD_T_PAD (float32 uses the first B*H*T entries for D)
    t_pad = -(-t // BWD_T_PAD) * BWD_T_PAD
    scratch = torch.empty((2, b, h, t_pad), dtype=torch.float32,
                          device=q.device)
    fn = getattr(library(), _BWD[q.dtype])
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, t, s, h, kvh, hd, int(causal),
             int(q_offset), int(window), stream_ptr(q)),
          "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable attention: the kernels on CUDA tensors, the plain
    versions on CPU tensors.  Saves q, k, v, o and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int, window: int = 0):
        fwd = flash_attention_cuda if q.is_cuda else flash_attention_plain
        o, lse = fwd(q, k, v, causal=causal, q_offset=q_offset,
                     window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset, ctx.window = causal, q_offset, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_cuda if do.is_cuda else \
            flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, do, lse, causal=ctx.causal,
                         q_offset=ctx.q_offset, window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    window: int = 0) -> torch.Tensor:
    """(B, T, H, hd) attention output.  A CUDA tensor launches the kernel
    (or raises); a CPU tensor runs the plain version.  With grad enabled
    and an operand that requires grad, through ``FlashAttentionFn``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, q_offset, window)
    fwd = flash_attention_cuda if q.is_cuda else flash_attention_plain
    return fwd(q, k, v, causal=causal, q_offset=q_offset, window=window)
