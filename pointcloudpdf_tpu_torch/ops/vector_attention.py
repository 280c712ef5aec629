"""PT-v1 vector attention: inference forward (kernel K3) and the
training forward + backward (kernel K4).

Counterpart of ``pointcloudpdf_tpu/ops/pallas_attention.py``
``fused_vector_attention`` and ``fused_vector_attention_train``.  The
kernels (csrc/vector_attention.cu, csrc/vector_attention_bwd.cu) gather
the neighbour rows of x_k, x_v and coord by index inside the kernel, so
the TPU kernels' gathered payload slab (``_build_payload``) and its bf16
coordinate split are gone, and the backward scatters d x_k / d x_v itself;
the source notes say what bounds each on the card.

- ``vector_attention``: eval / no-grad entry with the BatchNorm affines
  folded from the running statistics; refuses to record a gradient.
  ``layer_attention`` is the same entry for an eval layer's two MLPs: on
  the card it packs their parameters and folded affines once a layer
  (``packed_params``), not at every call.
- ``vector_attention_train``: the same chain with the affines folded from
  the batch's masked statistics (``attention_train_affines``, plain
  differentiable PyTorch, as the JAX package keeps ``attention_train_stats``
  outside its kernel), through ``VectorAttentionFunction``: forward = the
  K3 kernel, backward = one launch of the K4 kernel, which recomputes the
  chain and saves no intermediates.
- ``vector_attention_plain`` / ``vector_attention_train_plain``: the plain
  PyTorch versions with the same signatures; autograd of the latter is the
  plain version of K4.

Weights are (in, out) matrices as in the JAX package.  Output channel
``c`` takes softmax weight group ``c % G`` (the JAX code reshapes C as
``(share, G)``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import comm
from . import _cuda
from .geometry import gather_rows
from .gva import split_tf32

# launches since the last reset: the forward kernel from the inference entry
# (K3), and K4's two halves, the forward kernel from the training entry and
# the backward kernel
ATTENTION_LAUNCHES = 0
ATTENTION_TRAIN_LAUNCHES = 0
ATTENTION_BWD_LAUNCHES = 0
MAX_NEIGHBOURS_BWD = 16     # the backward kernel takes K <= 16
_WIDTHS = (32, 64, 128, 256, 512)


def vector_attention(x_q, x_k, x_v, coord, idx, nmask,
                     p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w, w2_b,
                     bnp_scale, bnp_shift, bnw1_scale, bnw1_shift,
                     bnw2_scale, bnw2_shift, share_planes: int = 8):
    """x_q/x_k/x_v (B, N, C), coord (B, N, 3), idx (B, N, K) per-sample
    rows, nmask (B, N, K) bool -> (B, N, C) float32."""
    args = (x_q, x_k, x_v, coord, idx, nmask, p1_w, p1_b, p2_w, p2_b,
            w1_w, w1_b, w2_w, w2_b, bnp_scale, bnp_shift, bnw1_scale,
            bnw1_shift, bnw2_scale, bnw2_shift)
    if _cuda.use_kernel(x_q):
        return _vector_attention_cuda(*args, share_planes=share_planes)
    return vector_attention_plain(*args, share_planes=share_planes)


def _vector_attention_cuda(x_q, x_k, x_v, coord, idx, nmask,
                           p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w, w2_b,
                           bnp_scale, bnp_shift, bnw1_scale, bnw1_shift,
                           bnw2_scale, bnw2_shift, share_planes):
    _refuse_grad(x_q, x_k, x_v, p2_w, w1_w, w2_w)
    _check_widths(x_q.shape[-1], share_planes)
    params = _pack_params(p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w, w2_b,
                          bnp_scale, bnp_shift, bnw1_scale, bnw1_shift,
                          bnw2_scale, bnw2_shift)
    return _launch_forward(*_kernel_inputs(x_q, x_k, x_v, coord, idx, nmask),
                           params)


def layer_weights(linear_p, linear_w):
    """The four Linear (W, b) pairs of a ``PointTransformerLayer``'s
    positional MLP ``linear_p`` and weight MLP ``linear_w`` as (in, out)
    matrices, in signature order."""
    p1, _, _, p2 = linear_p
    _, _, w1, _, _, w2 = linear_w
    return (p1.weight.t(), p1.bias, p2.weight.t(), p2.bias,
            w1.weight.t(), w1.bias, w2.weight.t(), w2.bias)


def eval_params(linear_p, linear_w):
    """The 14 parameter tensors of the attention in signature order, the
    three BatchNorms folded from their running statistics."""
    return (*layer_weights(linear_p, linear_w), *linear_p[1].affine(),
            *linear_w[0].affine(), *linear_w[3].affine())


def packed_params(linear_p, linear_w):
    """The forward kernel's buffers for an eval layer's two MLPs, the packed
    parameters (``_pack_params``) and W_w1's split pairs (``_split_w1``),
    made once: kept on ``linear_w`` and made again when a parameter or
    running statistic of either changes its storage or its version counter
    (a copy, an optimizer step, a ``load_state_dict``; a write through
    ``.data`` goes unseen).  Modules made under ``torch.inference_mode``
    have no version counters: they are packed at every call."""
    if linear_p.training or linear_w.training:
        raise ValueError("packed_params folds the running statistics: the "
                         "modules must be in eval mode")

    def pack():
        params = _pack_params(*eval_params(linear_p, linear_w))
        return params, _split_w1(params, linear_w[2].in_features)

    tensors = [t for m in (linear_p, linear_w)
               for t in (*m.parameters(), *m.buffers())]
    if any(t.is_inference() for t in tensors):
        return pack()
    key = tuple((t.data_ptr(), t._version) for t in tensors)
    cached = getattr(linear_w, "_attn_packed", None)
    if cached is None or cached[0] != key:
        cached = (key, pack())
        linear_w._attn_packed = cached
    return cached[1]


def layer_attention(x_q, x_k, x_v, coord, idx, nmask, linear_p, linear_w,
                    share_planes: int = 8):
    """``vector_attention`` of an eval ``PointTransformerLayer`` (its
    positional MLP ``linear_p`` and weight MLP ``linear_w``): on CUDA
    tensors kernel K3 on the layer's packed buffer (``packed_params``), on
    CPU tensors the plain version."""
    if not _cuda.use_kernel(x_q):
        return vector_attention_plain(
            x_q, x_k, x_v, coord, idx, nmask,
            *eval_params(linear_p, linear_w), share_planes=share_planes)
    _refuse_grad(x_q, x_k, x_v, *linear_p.parameters(), *linear_w.parameters())
    _check_widths(x_q.shape[-1], share_planes)
    with torch.no_grad():
        params, w1s = packed_params(linear_p, linear_w)
    return _launch_forward(*_kernel_inputs(x_q, x_k, x_v, coord, idx, nmask),
                           params, w1s=w1s)


def _refuse_grad(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("vector_attention has no backward: call it under "
                           "torch.no_grad() / inference_mode(), or use "
                           "vector_attention_train")


def _check_widths(C, share_planes):
    if share_planes != 8 or C not in _WIDTHS:
        raise ValueError(f"vector attention kernel takes share 8 and C in "
                         f"{_WIDTHS}, got share {share_planes}, C {C}")


def _pack_params(p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w, w2_b,
                 bnp_scale, bnp_shift, bnw1_scale, bnw1_shift,
                 bnw2_scale, bnw2_shift):
    """The kernels' packed parameter buffer (csrc/vector_attention.cuh)."""
    return torch.cat([
        p1_w.reshape(-1), p1_b, bnp_scale, bnp_shift,
        p2_w.reshape(-1), p2_b, bnw1_scale, bnw1_shift,
        w1_w.t().reshape(-1), w1_b, bnw2_scale, bnw2_shift,
        w2_w.reshape(-1), w2_b]).float().contiguous()


def _split_w1(params, C):
    """W_w1 of a packed buffer as the forward kernel reads it: (C, 2 G), each
    weight as its TF32 pair (hi, lo) (``gva.split_tf32``, the split of the
    kernels' products)."""
    G = C // 8
    start = 18 + 6 * C  # attn_layout(C, G).w1t
    return split_tf32(params[start:start + G * C].reshape(G, C).t()).contiguous()


def _unpack_params(flat, C, G):
    """A buffer in the packed layout -> the 14 tensors, in signature order
    (p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w, w2_b, then the affines)."""
    sizes = [9, 3, 3, 3, 3 * C, C, C, C, G * C, G, G, G, G * G, G]
    (p1_w, p1_b, s_p, t_p, p2_w, p2_b, s1, t1, w1t, w1_b, s2, t2, w2_w,
     w2_b) = torch.split(flat, sizes)
    return (p1_w.reshape(3, 3), p1_b, p2_w.reshape(3, C), p2_b,
            w1t.reshape(G, C).t(), w1_b, w2_w.reshape(G, G), w2_b,
            s_p, t_p, s1, t1, s2, t2)


def _kernel_inputs(x_q, x_k, x_v, coord, idx, nmask):
    x_q, x_k, x_v, coord = (t.float().contiguous()
                            for t in (x_q, x_k, x_v, coord))
    return (x_q, x_k, x_v, coord, idx.to(torch.int32).contiguous(),
            nmask.to(torch.bool).contiguous())


def _launch_forward(x_q, x_k, x_v, coord, idx, nmask, params, train=False,
                    w1s=None):
    """The forward kernel on the packed ``params``; ``w1s``: their W_w1 split
    (``_split_w1``), made here where not given."""
    global ATTENTION_LAUNCHES, ATTENTION_TRAIN_LAUNCHES
    B, N, C = x_q.shape
    K = idx.shape[-1]
    lib = _cuda.library()
    if params.numel() != lib.pcpdf_vector_attention_params(C):
        raise ValueError("vector attention: parameter shapes do not match C")
    if w1s is None:
        w1s = _split_w1(params, C)
    if w1s.shape != (C, C // 4):
        raise ValueError("vector attention: W_w1's pairs do not match C")
    _cuda.expect_cuda("vector_attention", x_q, x_k, x_v, coord, idx, nmask,
                      params, w1s)
    out = torch.empty((B, N, C), dtype=torch.float32, device=x_q.device)
    err = lib.pcpdf_vector_attention(
        x_q.data_ptr(), x_k.data_ptr(), x_v.data_ptr(), coord.data_ptr(),
        idx.data_ptr(), nmask.data_ptr(), params.data_ptr(), w1s.data_ptr(),
        B, N, C, K, out.data_ptr(), ctypes.c_void_p(_cuda.stream_of(x_q)))
    _cuda.check(err, "pcpdf_vector_attention")
    if train:
        ATTENTION_TRAIN_LAUNCHES += 1
    else:
        ATTENTION_LAUNCHES += 1
    return out


def _launch_backward(x_q, x_k, x_v, coord, idx, nmask, params, dout):
    global ATTENTION_BWD_LAUNCHES
    B, N, C = x_q.shape
    K = idx.shape[-1]
    dout = dout.float().contiguous()
    _cuda.expect_cuda("vector_attention_bwd", x_q, x_k, x_v, coord, idx,
                      nmask, params, dout)
    d_q = torch.empty_like(x_q)
    # the kernel accumulates into these with atomics
    d_k, d_v, d_params = (torch.zeros_like(x_k), torch.zeros_like(x_v),
                          torch.zeros_like(params))
    err = _cuda.library().pcpdf_vector_attention_bwd(
        x_q.data_ptr(), x_k.data_ptr(), x_v.data_ptr(), coord.data_ptr(),
        idx.data_ptr(), nmask.data_ptr(), params.data_ptr(), dout.data_ptr(),
        B, N, C, K, d_q.data_ptr(), d_k.data_ptr(), d_v.data_ptr(),
        d_params.data_ptr(), ctypes.c_void_p(_cuda.stream_of(x_q)))
    _cuda.check(err, "pcpdf_vector_attention_bwd")
    ATTENTION_BWD_LAUNCHES += 1
    return d_q, d_k, d_v, d_params


class VectorAttentionFunction(torch.autograd.Function):
    """K3 forward / K4 backward on CUDA tensors.  Saves its inputs, no
    intermediates.  ``coord`` gets no gradient: it is input data."""

    @staticmethod
    def forward(ctx, x_q, x_k, x_v, coord, idx, nmask, *params):
        packed = _pack_params(*params)
        inputs = _kernel_inputs(x_q, x_k, x_v, coord, idx, nmask)
        ctx.save_for_backward(*inputs, packed)
        ctx.dtypes = [t.dtype for t in (x_q, x_k, x_v, *params)]
        return _launch_forward(*inputs, packed, train=True)

    @staticmethod
    def backward(ctx, dout):
        *inputs, packed = ctx.saved_tensors
        C = inputs[0].shape[-1]
        d_q, d_k, d_v, d_packed = _launch_backward(*inputs, packed, dout)
        grads = (d_q, d_k, d_v, *_unpack_params(d_packed, C, C // 8))
        grads = [g.to(dt) for g, dt in zip(grads, ctx.dtypes)]
        return (*grads[:3], None, None, None, *grads[3:])


def attention_train_affines(x_q, x_k, coord, idx, nmask,
                            p1_w, p1_b, p2_w, p2_b, w1_w, w1_b,
                            bn_p, bn_w1, bn_w2):
    """Masked batch statistics of the three BatchNorm inputs, folded into
    the six affine vectors the kernels take (counterpart of
    ``attention_train_stats``).  The three are sequential: each affine
    feeds the next pre-BN activation.  ``bn_*`` are the layer's
    ``MaskedBatchNorm`` modules; their ``train_affine`` also updates the
    running statistics.  Plain differentiable PyTorch: the gradient through
    mean and variance comes from autograd.  Over several ranks the
    statistics are the global batch's, as a ``MaskedBatchNorm`` takes them.
    Materialises p_r, r and u at (B, N, K, .)."""
    flag = nmask.to(torch.float32)
    n = flag.sum()

    def mstats(x):
        sx, sxx, n_all = comm.sum_moments(
            torch.einsum("bnk,bnkc->c", flag, x),
            torch.einsum("bnk,bnkc->c", flag, x * x), n)
        cnt = torch.clamp(n_all, min=1.0)
        mean = sx / cnt
        return mean, sxx / cnt - mean * mean, cnt

    # statistics in f32 whatever the autocast state, as the kernels compute
    with torch.autocast(x_q.device.type, enabled=False):
        x_q, x_k = x_q.float(), x_k.float()
        p_rel = gather_rows(coord, idx) - coord[:, :, None, :]
        z1 = p_rel @ p1_w + p1_b
        s_p, t_p = bn_p.train_affine(*mstats(z1))
        p_r = torch.relu(z1 * s_p + t_p) @ p2_w + p2_b
        r = gather_rows(x_k, idx) - x_q[:, :, None, :] + p_r
        s1, t1 = bn_w1.train_affine(*mstats(r))
        u = torch.relu(r * s1 + t1) @ w1_w + w1_b
        s2, t2 = bn_w2.train_affine(*mstats(u))
    return s_p, t_p, s1, t1, s2, t2


def vector_attention_train(x_q, x_k, x_v, coord, idx, nmask,
                           p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w, w2_b,
                           bnp_scale, bnp_shift, bnw1_scale, bnw1_shift,
                           bnw2_scale, bnw2_shift, share_planes: int = 8):
    """``vector_attention`` with a gradient for x_q, x_k, x_v, the weights
    and the affines.  CUDA tensors go through ``VectorAttentionFunction``
    (kernels K3 and K4); CPU tensors through the plain version."""
    args = (x_q, x_k, x_v, coord, idx, nmask, p1_w, p1_b, p2_w, p2_b,
            w1_w, w1_b, w2_w, w2_b, bnp_scale, bnp_shift, bnw1_scale,
            bnw1_shift, bnw2_scale, bnw2_shift)
    if not _cuda.use_kernel(x_q):
        return vector_attention_train_plain(*args, share_planes=share_planes)
    _check_widths(x_q.shape[-1], share_planes)
    if idx.shape[-1] > MAX_NEIGHBOURS_BWD:
        raise ValueError(f"vector attention backward kernel takes K <= "
                         f"{MAX_NEIGHBOURS_BWD}, got {idx.shape[-1]}")
    return VectorAttentionFunction.apply(*args)


def attention_preactivations(x_q, x_k, coord, idx, p1_w, p1_b, p2_w, p2_b,
                             w1_w, w1_b, bnp_scale, bnp_shift, bnw1_scale,
                             bnw1_shift, bnw2_scale, bnw2_shift):
    """The plain chain up to its third ReLU: the positional encoding p_r
    (B, N, K, C) and the three ReLU inputs, (B, N, K, 3), (B, N, K, C) and
    (B, N, K, G).  A check of a kernel against the plain version reads the
    inputs to find the pairs that sit on a ReLU's kink."""
    p_rel = gather_rows(coord, idx) - coord[:, :, None, :]
    pre1 = (p_rel @ p1_w + p1_b) * bnp_scale + bnp_shift
    p_r = torch.relu(pre1) @ p2_w + p2_b
    r = gather_rows(x_k, idx) - x_q[:, :, None, :] + p_r
    pre2 = r * bnw1_scale + bnw1_shift
    pre3 = (torch.relu(pre2) @ w1_w + w1_b) * bnw2_scale + bnw2_shift
    return p_r, pre1, pre2, pre3


def mask_off_relu_kinks(x_q, x_k, x_v, coord, idx, nmask,
                        p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w, w2_b,
                        *affines, margin: float = 1e-5):
    """``nmask`` without the (query, neighbour) pairs that have one of the
    chain's ReLU inputs within ``margin`` of 0, relative to that input
    tensor's max magnitude.  Two f32 evaluations that sum in different
    orders can open such a gate on one side only, and then differ by that
    pair's whole term; a comparison of the two at rounding tolerances is
    made on this mask.  The ReLU inputs depend on the pair and the given
    affines alone, so masking a pair moves no other pair's."""
    with torch.no_grad():
        pres = attention_preactivations(
            x_q, x_k, coord, idx, p1_w, p1_b, p2_w, p2_b, w1_w, w1_b,
            *affines)[1:]
        near = [(p.abs() <= margin * p.abs().max()).any(-1) for p in pres]
    return nmask & ~(near[0] | near[1] | near[2])


def vector_attention_plain(x_q, x_k, x_v, coord, idx, nmask,
                           p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w, w2_b,
                           bnp_scale, bnp_shift, bnw1_scale, bnw1_shift,
                           bnw2_scale, bnw2_shift, share_planes: int = 8):
    """Plain PyTorch version of K3 over gathered (B, N, K, C) tensors."""
    # imported here: the models package imports this module
    from ..models.utils.structure import masked_softmax

    B, N, C = x_q.shape
    G = C // share_planes
    p_r, _, _, pre3 = attention_preactivations(
        x_q, x_k, coord, idx, p1_w, p1_b, p2_w, p2_b, w1_w, w1_b,
        bnp_scale, bnp_shift, bnw1_scale, bnw1_shift, bnw2_scale, bnw2_shift)
    logit = torch.relu(pre3) @ w2_w + w2_b                      # (B,N,K,G)
    wgt = masked_softmax(logit, nmask[..., None], dim=2)
    v_pe = (gather_rows(x_v, idx) + p_r).reshape(B, N, -1, share_planes, G)
    out = (v_pe * wgt[..., None, :]).sum(dim=2)
    return out.reshape(B, N, C)


def vector_attention_train_plain(x_q, x_k, x_v, coord, idx, nmask,
                                 p1_w, p1_b, p2_w, p2_b, w1_w, w1_b, w2_w,
                                 w2_b, bnp_scale, bnp_shift, bnw1_scale,
                                 bnw1_shift, bnw2_scale, bnw2_shift,
                                 share_planes: int = 8):
    """Plain version of ``vector_attention_train``: the plain chain on the
    given affines; its autograd is the plain version of kernel K4."""
    return vector_attention_plain(
        x_q, x_k, x_v, coord, idx, nmask, p1_w, p1_b, p2_w, p2_b,
        w1_w, w1_b, w2_w, w2_b, bnp_scale, bnp_shift, bnw1_scale,
        bnw1_shift, bnw2_scale, bnw2_shift, share_planes=share_planes)
