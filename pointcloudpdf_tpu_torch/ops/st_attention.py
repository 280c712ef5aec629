"""Stratified-Transformer window attention with contextual relative
position encoding (cRPE), over a fixed-K key set (kernel K5).

Counterpart of ``pointcloudpdf_tpu/ops/pallas_st_attention.py``
``fused_st_attention`` and of the unfused path of
``StratifiedWindowAttention`` (``pointcloudpdf_tpu/models/
stratified_transformer/st.py``).  Per query i, head h and key slot j (a row
``key_idx[i, j]`` of the same sample; ``key_mask`` false -> probability 0):

    bin[axis] = clip(floor((c_i - c_j + 2 ws - 1e-4) / quant), 0, 2L - 1)
    logit = s q_i . k_j + sum_axis s q_i . Tq[axis][bin] + sum_axis k_j . Tk[axis][bin]
    out_i = sum_j softmax_j(logit) (v_j + sum_axis Tv[axis][bin])

with ``s = head_dim ** -0.5`` applied to q once, ahead of both of its
products, and every dot taken over the head's channels.  A query with no
valid key comes out 0.  Tables are the ``(3, 2L, C)`` merged views of the
``(2L, H, head_dim, 3)`` parameters; ``None`` switches a term off.

K5 (csrc/st_attention.cu) gathers the key rows by index inside the kernel
and keeps a head group's slices of the three tables in shared memory: the
query term comes from a product of q with Tq, the value term from a
histogram of the probabilities by bin times Tv, the key term pair by pair,
and the softmax takes all of a query's logits at once (K <= 64 slots, 2L <=
80 bins).  The TPU kernel's gathered payload slab, its bf16 hi/lo
coordinate split, its one-hot table contractions and its query chunks all
dodge that chip's gather cost and are not ported.  ``st_attention_plain``
is the plain PyTorch version (gathers, indexed table rows, a masked
softmax), differentiable; both compute the bins by the same f32 operations
in the same order, so they pick identical bins.

The kernel is inference-only, as in the JAX package:
``StratifiedWindowAttention`` takes the plain version when it trains.  In
eval mode on the card the wrapper launches the kernel, and raises when a
gradient is asked of it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda
from .geometry import divide_exact, gather_rows

ST_ATTENTION_LAUNCHES = 0  # K5 launches since the last reset
HEAD_DIM = 16              # csrc/st_attention.cu: 16 channels a head
_WIDTHS = (32, 64, 96, 128, 192, 256, 384, 512)  # csrc/st_attention.cu
MAX_SLOTS = 64             # key slots a query the kernel takes, at most
MAX_BINS = 80              # table rows (2L) the kernel takes, at most


def st_attention(q, k, v, coord, key_idx, key_mask,
                 tq: Optional[torch.Tensor], tk: Optional[torch.Tensor],
                 tv: Optional[torch.Tensor], num_heads: int,
                 window_size: float, quant_size: float, num_bins: int):
    """q/k/v (B, N, C), coord (B, N, 3), key_idx (B, N, K) per-sample rows,
    key_mask (B, N, K) bool, tq/tk/tv (3, num_bins, C) or None ->
    (B, N, C) float32."""
    args = (q, k, v, coord, key_idx, key_mask, tq, tk, tv, num_heads,
            window_size, quant_size, num_bins)
    if _cuda.use_kernel(q):
        return _st_attention_cuda(*args)
    return st_attention_plain(*args)


def _st_attention_cuda(q, k, v, coord, key_idx, key_mask, tq, tk, tv,
                       num_heads, window_size, quant_size, num_bins):
    global ST_ATTENTION_LAUNCHES
    tables = [t for t in (tq, tk, tv) if t is not None]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, *tables)):
        raise RuntimeError("st_attention has no backward: call it under "
                           "torch.no_grad() / inference_mode(), or use "
                           "st_attention_plain")
    B, N, C = q.shape
    if C != num_heads * HEAD_DIM or C not in _WIDTHS:
        raise ValueError(f"st attention kernel takes head width {HEAD_DIM} "
                         f"and C in {_WIDTHS}, got C {C}, {num_heads} heads")
    if key_idx.shape[-1] > MAX_SLOTS or not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"st attention kernel takes at most {MAX_SLOTS} key "
                         f"slots and 1 to {MAX_BINS} bins, got "
                         f"{key_idx.shape[-1]} slots, {num_bins} bins")
    q, k, v, coord = (t.float().contiguous() for t in (q, k, v, coord))
    key_idx = key_idx.to(torch.int32).contiguous()
    key_mask = key_mask.to(torch.bool).contiguous()
    tables = [None if t is None else t.float().contiguous()
              for t in (tq, tk, tv)]
    for t in tables:
        if t is not None and t.shape != (3, num_bins, C):
            raise ValueError(f"st attention: table {tuple(t.shape)} is not "
                             f"(3, {num_bins}, {C})")
    _cuda.expect_cuda("st_attention", q, k, v, coord, key_idx, key_mask,
                      *[t for t in tables if t is not None])
    out = torch.empty((B, N, C), dtype=torch.float32, device=q.device)
    err = _cuda.library().pcpdf_st_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), coord.data_ptr(),
        key_idx.data_ptr(), key_mask.data_ptr(),
        *[None if t is None else t.data_ptr() for t in tables],
        HEAD_DIM ** -0.5, 2 * window_size, 1e-4, quant_size,
        B, N, C, key_idx.shape[-1], num_bins, out.data_ptr(),
        ctypes.c_void_p(_cuda.stream_of(q)))
    _cuda.check(err, "pcpdf_st_attention")
    ST_ATTENTION_LAUNCHES += 1
    return out


def st_attention_bins(coord, key_idx, window_size: float, quant_size: float,
                      num_bins: int) -> torch.Tensor:
    """Quantized relative-position bins (B, N, K, 3) int64 of every (query,
    key slot, axis): ((c_q - c_k) + 2 ws) - 1e-4, divided by quant, floored
    and clipped.  Every step is an f32 operation of its own, each constant a
    Python double rounded to f32 once, the division a true one on every
    device (the kernel does the same, without contraction)."""
    coord = coord.float()
    rel = coord[:, :, None, :] - gather_rows(coord, key_idx)
    bins = torch.floor(divide_exact(rel + 2 * window_size - 1e-4, quant_size))
    return torch.clamp(bins, 0, num_bins - 1).long()


def st_attention_plain(q, k, v, coord, key_idx, key_mask, tq, tk, tv,
                       num_heads, window_size, quant_size, num_bins):
    """Plain PyTorch version of K5 over gathered (B, N, K, C) tensors, in
    float32 (float64 where q is: a reference to rounding noise); the bins
    are the f32 ones either way."""
    # imported here: the models package imports this module
    from ..models.utils.structure import masked_softmax

    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    B, N, C = q.shape
    K = key_idx.shape[-1]
    H, hd = num_heads, C // num_heads

    def head_sum(x):                       # (B, N, K, C) -> (B, N, K, H)
        return x.reshape(B, N, K, H, hd).sum(-1)

    qf = (q.to(dt) * hd ** -0.5)[:, :, None, :]
    k_g = gather_rows(k.to(dt), key_idx)
    v_g = gather_rows(v.to(dt), key_idx)
    bins = st_attention_bins(coord, key_idx, window_size, quant_size, num_bins)

    logits = head_sum(qf * k_g)
    for axis in range(3):
        if tq is not None:
            logits = logits + head_sum(qf * tq[axis].to(dt)[bins[..., axis]])
        if tk is not None:
            logits = logits + head_sum(k_g * tk[axis].to(dt)[bins[..., axis]])
    attn = masked_softmax(logits, key_mask[..., None], dim=2)  # (B, N, K, H)
    if tv is not None:
        for axis in range(3):
            v_g = v_g + tv[axis].to(dt)[bins[..., axis]]
    out = (attn[..., None] * v_g.reshape(B, N, K, H, hd)).sum(dim=2)
    return out.reshape(B, N, C)
