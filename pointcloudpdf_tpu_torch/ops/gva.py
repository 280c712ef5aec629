"""PT-v2 grouped vector attention, inference forward (kernel K7).

Counterpart of ``pointcloudpdf_tpu/ops/pallas_gva.py``
``fused_grouped_vector_attention`` and of the unfused path of
``GroupedVectorAttention`` (``pointcloudpdf_tpu/models/point_transformer_v2/
ptv2.py``).  Per query i and neighbour slot s (a row ``j = idx[i, s]`` of
the same sample; ``nmask`` false -> probability 0), with
``p = coord[j] - coord[i]``:

    rel   = k[j] - q[i]
    rel   = rel * pem(p)                      if pe_multiplier
    rel   = rel + peb(p),  v_eff = v[j] + peb(p)   if pe_bias (else v[j])
    w     = we(rel)                           (G logits)
    out[i, ch] = sum_s softmax_s(w)[ch // (C / G)] * v_eff[ch]

where ``pem``, ``peb`` and ``we`` are each Linear -> BatchNorm -> ReLU ->
Linear (the reference's ``linear_p_multiplier``, ``linear_p_bias`` and
``weight_encoding``).  The softmax is the masked one of
``models.utils.structure.masked_softmax``; a query with no valid slot
comes out 0.  The MLPs are passed as those ``nn.Sequential`` modules
(``[0]`` Linear, ``[1]`` a ``PointBatchNorm``, ``[3]`` Linear), or None for
a branch that is off.

K7 (csrc/gva.cu) gathers the k/v/coord rows by index inside the kernel and
runs the positional encodings' C x C products and the weight encoding's
C x G one over tiles of pair rows on the tensor cores, in split TF32 (f32
accuracy).  The TPU kernel's gathered ``[k | v | coord_hi | coord_lo |
flag]`` slab, its bf16 payload and its one-hot group-selector matmul dodge
that chip's gather cost and are not ported.  The inference BatchNorms fold
to affines from their running statistics.

The kernel is inference-only, as in the JAX package:
``GroupedVectorAttention`` takes ``gva_plain`` (batch statistics,
differentiable) when it trains.  In eval mode on the card the wrapper
launches the kernel, and raises when a gradient is asked of it.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
from torch.nn import functional as F

from . import _cuda
from .geometry import gather_rows

GVA_LAUNCHES = 0          # K7 launches since the last reset
GVA_LAUNCHES_BY_WIDTH: dict = {}  # ... by C
SHARE = 8                 # channels per weight group the kernel takes
_WIDTHS = (48, 96, 192, 384, 512)  # csrc/gva.cu


def grouped_vector_attention(q, k, v, coord, idx, nmask, pe_multiplier,
                             pe_bias, weight_encoding, groups: int):
    """q/k/v (B, N, C), coord (B, N, 3), idx (B, N, S) per-sample rows,
    nmask (B, N, S) bool, the three MLPs (or None) -> (B, N, C) float32."""
    args = (q, k, v, coord, idx, nmask, pe_multiplier, pe_bias,
            weight_encoding, groups)
    if _cuda.use_kernel(q):
        return _gva_cuda(*args)
    return gva_plain(*args)


def _mlp(seq, x, mask):
    """Linear -> masked BatchNorm -> ReLU -> Linear over (..., C_in)."""
    return seq[3](F.relu(seq[1](seq[0](x), mask)))


def gva_plain(q, k, v, coord, idx, nmask, pe_multiplier, pe_bias,
              weight_encoding, groups: int):
    """Plain PyTorch version of K7 over gathered (B, N, S, C) tensors; the
    BatchNorms take batch statistics over the valid slots in training mode
    and their running statistics in eval.  Differentiable."""
    # imported here: the models package imports this module
    from ..models.utils.structure import masked_softmax

    B, N, C = q.shape
    S = idx.shape[-1]
    k_g = gather_rows(k, idx)
    v_g = gather_rows(v, idx)
    pos = gather_rows(coord, idx) - coord[:, :, None, :]
    rel = k_g - q[:, :, None, :]
    if pe_multiplier is not None:
        rel = rel * _mlp(pe_multiplier, pos, nmask)
    if pe_bias is not None:
        peb = _mlp(pe_bias, pos, nmask)
        rel = rel + peb
        v_g = v_g + peb
    w = masked_softmax(_mlp(weight_encoding, rel, nmask), nmask[..., None],
                       dim=2)                               # (B, N, S, G)
    out = v_g.reshape(B, N, S, groups, C // groups) * w[..., None]
    return out.sum(dim=2).reshape(B, N, C)


def _expect_eval(*mlps):
    if any(m is not None and m[1].training for m in mlps):
        raise ValueError("grouped vector attention kernel folds BatchNorm "
                         "running statistics: call it on modules in eval mode")


def _folded(seq, shape, device):
    """(W1 (in, out), b1, BN scale, BN shift, W2 (out, out), b2) of an MLP in
    eval mode, the BatchNorm folded from its running statistics; zeros of
    ``shape`` = (in, out) for a branch that is off."""
    if seq is None:
        c_in, c = shape
        z = torch.zeros(c, device=device)
        return (torch.zeros(c_in, c, device=device), z, z, z,
                torch.zeros(c, c, device=device), z)
    _expect_eval(seq)
    lin1, norm, _, lin2 = seq
    scale, shift = norm.norm.affine()
    return (lin1.weight.t(), lin1.bias, scale, shift, lin2.weight.t(),
            lin2.bias)


def split_tf32(x):
    """(..., n) float32 -> (..., 2 n): each value as the pair (hi, lo), hi = x
    rounded to TF32 (10 mantissa bits, to nearest, ties away from zero, on
    its bits) and lo = x - hi rounded the same way, as csrc/gva.cu's
    split-TF32 products read them."""
    def tf32(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.float()
    hi = tf32(x)
    return torch.stack([hi, tf32(x - hi)], -1).reshape(*x.shape[:-1], 2 * x.shape[-1])


def pack_params(pe_multiplier, pe_bias, weight_encoding, C: int, G: int):
    """The kernel's buffers: the small parameters packed in the layout of
    csrc/gva.cu ``gva_layout`` (the weight encoding's first matrix last,
    transposed to (G, C)), and the two positional encodings' C x C matrices
    (in, out) split into (hi, lo) pairs, (C, 2 C)."""
    dev = weight_encoding[0].weight.device
    m1w, m1b, ms, mt, m2w, m2b = _folded(pe_multiplier, (3, C), dev)
    b1w, b1b, bs, bt, b2w, b2b = _folded(pe_bias, (3, C), dev)
    e1w, e1b, es, et, e2w, e2b = _folded(weight_encoding, (C, G), dev)
    parts = [m1w, m1b, ms, mt, m2b, b1w, b1b, bs, bt, b2b,
             e1b, es, et, e2w, e2b, e1w.t()]
    small = torch.cat([p.float().reshape(-1) for p in parts])
    return small.contiguous(), split_tf32(m2w), split_tf32(b2w)


def packed_params(pe_multiplier, pe_bias, weight_encoding, C: int, G: int):
    """``pack_params`` once a set of eval modules: kept on
    ``weight_encoding`` and made again when a parameter or running statistic
    of the three MLPs changes its storage or its version counter (a copy,
    an optimizer step, a ``load_state_dict``; a write through ``.data``
    goes unseen).  Modules made under ``torch.inference_mode`` have no
    version counters: they are packed at every call."""
    mlps = [m for m in (pe_multiplier, pe_bias, weight_encoding) if m is not None]
    _expect_eval(*mlps)
    tensors = [t for m in mlps for t in (*m.parameters(), *m.buffers())]
    if any(t.is_inference() for t in tensors):
        return pack_params(pe_multiplier, pe_bias, weight_encoding, C, G)
    key = (C, G, pe_multiplier is not None, pe_bias is not None,
           tuple((t.data_ptr(), t._version) for t in tensors))
    cached = getattr(weight_encoding, "_gva_packed", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_params(pe_multiplier, pe_bias, weight_encoding, C, G))
        weight_encoding._gva_packed = cached
    return cached[1]


def _gva_cuda(q, k, v, coord, idx, nmask, pe_multiplier, pe_bias,
              weight_encoding, groups):
    global GVA_LAUNCHES
    mlps = [m for m in (pe_multiplier, pe_bias, weight_encoding) if m is not None]
    if torch.is_grad_enabled() and (
            any(t.requires_grad for t in (q, k, v))
            or any(p.requires_grad for m in mlps for p in m.parameters())):
        raise RuntimeError("grouped_vector_attention has no backward: call it "
                           "under torch.no_grad() / inference_mode(), or use "
                           "gva_plain")
    B, N, C = q.shape
    if C not in _WIDTHS or C != SHARE * groups:
        raise ValueError(f"grouped vector attention kernel takes C in {_WIDTHS} "
                         f"and {SHARE} channels a group, got C {C}, {groups} groups")
    # the range costs host time on every call, so only while profiling
    scope = (torch.profiler.record_function("K7 pack")
             if torch.autograd._profiler_enabled() else contextlib.nullcontext())
    with torch.no_grad(), scope:
        small, m2w, b2w = packed_params(pe_multiplier, pe_bias, weight_encoding,
                                        C, groups)
    q, k, v, coord = (t.float().contiguous() for t in (q, k, v, coord))
    idx = idx.to(torch.int32).contiguous()
    nmask = nmask.to(torch.bool).contiguous()
    _cuda.expect_cuda("grouped_vector_attention", q, k, v, coord, idx, nmask,
                      small, m2w, b2w)
    lib = _cuda.library()
    if small.numel() != lib.pcpdf_gva_params(C):
        raise ValueError("grouped vector attention: parameter shapes do not match C")
    out = torch.empty((B, N, C), dtype=torch.float32, device=q.device)
    err = lib.pcpdf_gva(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), coord.data_ptr(),
        idx.data_ptr(), nmask.data_ptr(), small.data_ptr(), m2w.data_ptr(),
        b2w.data_ptr(), int(pe_multiplier is not None), int(pe_bias is not None),
        B, N, C, idx.shape[-1], out.data_ptr(),
        ctypes.c_void_p(_cuda.stream_of(q)))
    _cuda.check(err, "pcpdf_gva")
    GVA_LAUNCHES += 1
    GVA_LAUNCHES_BY_WIDTH[C] = GVA_LAUNCHES_BY_WIDTH.get(C, 0) + 1
    return out
