"""Wrapper of the flash_attention kernels and their plain PyTorch version.

Two hand-written kernels serve a CUDA tensor, chosen by its dtype
(``flash_engine``): bfloat16 runs on the tensor cores (``wgmma``, TMA and a
warp-specialised pipeline; ``csrc/flash_attn_sm90.cu``), float32 on the
CUDA cores (``csrc/flash_attn.cu``), because TF32 tensor-core products
would not hold float32's 1e-4.  Both count as ``LAUNCHES["flash_attention"]``.

Replaces ``repro.kernels.flash_attention.flash_attention.flash_attention_fwd``
(the TPU forward kernel) in the function ``repro.models.attention.
_blocked_attn`` computes for ``window = 0``: softmax attention with scale
``hd**-0.5``, grouped-query heads (query head ``h`` reads KV head
``h // (H / KV)``), keys past ``S`` masked and, when causal, key ``s``
visible to query ``t`` iff ``s <= q_offset + t`` (top-left alignment, as the
Pallas kernel and ``_blocked_attn`` have it; ``attention_ref`` in the JAX
package aligns bottom-right and agrees only when T == S).  Logits, softmax
state and the P.V sum are float32; the output has q's dtype.

The layout is the model's: q (B, T, H, hd), k and v (B, S, KV, hd).  The
TPU wrapper's artefacts are not carried over: KV heads are not repeated,
the head dim is not padded to 128, and T and S need not be block multiples.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_cuda, stream_ptr

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_cuda",
           "flash_engine", "HEAD_DIMS"]

NEG_INF = -1e30
#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: dtype -> (engine, exported symbol) of the kernel that serves it
_ENGINES = {torch.bfloat16: ("wgmma", "adhash_flash_attn_bf16"),
            torch.float32: ("cuda-core", "adhash_flash_attn_f32")}


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0
                          ) -> torch.Tensor:
    """Masked float32 softmax attention, GQA by ``repeat_interleave``."""
    _check_shapes(q, k, v)
    t, h, hd = q.shape[1:]
    s, kvh = k.shape[1:3]
    kf = k.float().repeat_interleave(h // kvh, dim=2)
    vf = v.float().repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), kf) * (hd ** -0.5)
    if causal:
        qpos = q_offset + torch.arange(t, device=q.device)
        kpos = torch.arange(s, device=q.device)
        logits = logits.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", w, vf).to(q.dtype)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous rows on 16-byte aligned storage (the kernel reads 16-byte
    vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0
                         ) -> torch.Tensor:
    """Launch the hand-written kernel that ``q``'s dtype selects
    (``flash_engine``); forward only."""
    from repro_torch.kernels.build import check, library

    check_cuda("flash_attention", q, k, v)
    _check_shapes(q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    flash_engine(q.dtype)
    b, t, h, hd = q.shape
    s, kvh = k.shape[1:3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds the grid's "
                         "65535")
    if max(t, s) >= 2**31:
        raise ValueError(f"flash_attention: T = {t} or S = {s} is not below "
                         "2^31")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the CUDA kernel is forward-only; its backward "
            "comes with the LM training slice (ROADMAP §1 item 12b). Run "
            "under torch.inference_mode() or torch.no_grad()"
        )
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    if b == 0 or t == 0:
        return o
    fn = getattr(library(), _ENGINES[q.dtype][1])
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, t, s,
             h, kvh, hd, int(causal), int(q_offset), stream_ptr(q)),
          "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """(B, T, H, hd) attention output.  A CUDA tensor launches the kernel
    (or raises); a CPU tensor runs the plain version."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal,
                                    q_offset=q_offset)
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
