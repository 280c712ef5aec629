"""Kernel-point convolution over a neighbour table (kernel K6).

Counterpart of the KPConv core of ``pointcloudpdf_tpu/models/
stratified_transformer/st.py`` ``KPConvBlock`` (its exact path over a
``ball_query`` table) and of ``pointcloudpdf_tpu/ops/pallas_kpconv.py``
``band_kpconv``:

    y_i = sum_{j in nbr(i)} sum_p max(0, 1 - |x_j - x_i - kp_p| / sigma_r)
                                  * f_j W_p

The TPU kernel finds its neighbours itself, in a z-order rank band (no
gather on that chip), uncapped and missing ~0.06% of in-radius pairs, so
the JAX package's two paths disagree; the port computes the exact path's
function, over the ``max_neighbor`` nearest in-radius points that K1 gives
it.  K6 (csrc/kpconv.cu) gathers the neighbour rows by index inside the
kernel and runs both products on the tensor cores; its source note says
what bounds it on the card.  It takes up to ``MAX_SLOTS`` slots,
``MAX_POINTS`` kernel points, ``MAX_C_IN`` channels in and ``MAX_C_OUT``
out (every KPConv of the shipped ST configs: 34 slots, 15 kernel points,
the stem's 6 -> 48 and its residual block's 12 -> 12; a nine-channel
input's 9 -> 48 too), and the wrapper raises on a larger shape.  ``kpconv_plain``
is its plain PyTorch version: the same direct differences
``(dx*dx + dy*dy) + dz*dz`` (not the matmul identity of the JAX path, whose
rounding near a kernel point is ~1e-3 of ``sigma_r``), differentiable in
``feat`` and ``weight``.

The kernel is inference-only, as in the JAX package: ``KPConvBlock`` takes
the plain version when it trains.  In eval mode on the card the wrapper
launches the kernel, and raises when a gradient is asked of it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .geometry import divide_exact, gather_rows

KPCONV_LAUNCHES = 0  # K6 launches since the last reset
# csrc/kpconv.cu's limits: neighbour slots, kernel points, channels in / out
MAX_SLOTS, MAX_POINTS, MAX_C_IN, MAX_C_OUT = 40, 16, 16, 64


def kpconv(coord, feat, idx, nmask, kp, weight, sigma_r: float):
    """coord (B, N, 3), feat (B, N, C_in), idx (B, N, S) per-sample rows,
    nmask (B, N, S) bool, kp (P, 3) absolute kernel points, weight
    (P, C_in, C_out) -> (B, N, C_out) float32."""
    if _cuda.use_kernel(feat):
        return _kpconv_cuda(coord, feat, idx, nmask, kp, weight, sigma_r)
    return kpconv_plain(coord, feat, idx, nmask, kp, weight, sigma_r)


def _kpconv_cuda(coord, feat, idx, nmask, kp, weight, sigma_r):
    global KPCONV_LAUNCHES
    if torch.is_grad_enabled() and (feat.requires_grad or weight.requires_grad):
        raise RuntimeError("kpconv has no backward: call it under "
                           "torch.no_grad() / inference_mode(), or use "
                           "kpconv_plain")
    coord, feat, kp, weight = (t.float().contiguous()
                               for t in (coord, feat, kp, weight))
    idx = idx.to(torch.int32).contiguous()
    nmask = nmask.to(torch.bool).contiguous()
    _cuda.expect_cuda("kpconv", coord, feat, idx, nmask, kp, weight)
    B, N, c_in = feat.shape
    S = idx.shape[-1]
    P, w_in, c_out = weight.shape
    if w_in != c_in or kp.shape != (P, 3):
        raise ValueError(f"kpconv: weight {tuple(weight.shape)} and kernel "
                         f"points {tuple(kp.shape)} do not fit C_in {c_in}")
    if S > MAX_SLOTS or P > MAX_POINTS or c_in > MAX_C_IN or c_out > MAX_C_OUT:
        raise ValueError(
            f"kpconv: the kernel takes up to {MAX_SLOTS} neighbour slots, "
            f"{MAX_POINTS} kernel points, {MAX_C_IN} channels in and "
            f"{MAX_C_OUT} out; got S={S}, P={P}, C_in={c_in}, C_out={c_out}")
    out = torch.empty((B, N, c_out), dtype=torch.float32, device=feat.device)
    err = _cuda.library().pcpdf_kpconv(
        coord.data_ptr(), feat.data_ptr(), idx.data_ptr(), nmask.data_ptr(),
        kp.data_ptr(), weight.data_ptr(), sigma_r, B, N, S,
        P, c_in, c_out, out.data_ptr(),
        ctypes.c_void_p(_cuda.stream_of(feat)))
    _cuda.check(err, "pcpdf_kpconv")
    KPCONV_LAUNCHES += 1
    return out


def kpconv_plain(coord, feat, idx, nmask, kp, weight, sigma_r: float):
    """Plain PyTorch version of K6 over gathered (B, N, S, .) tensors."""
    coord = coord.float()
    rel = gather_rows(coord, idx) - coord[:, :, None, :]        # (B,N,S,3)
    dx, dy, dz = (rel[..., None, :] - kp.float()).unbind(-1)    # (B,N,S,P)
    dist = torch.sqrt((dx * dx + dy * dy) + dz * dz)
    infl = torch.clamp(1.0 - divide_exact(dist, sigma_r), min=0.0)
    infl = infl * nmask[..., None].to(infl.dtype)
    per_kp = torch.einsum("bnsp,bnsc->bnpc", infl,
                          gather_rows(feat.float(), idx))
    return torch.einsum("bnpc,pcd->bnd", per_kp, weight.float())
