"""Masked normalisation layers for padded point batches.

Counterpart of ``pointcloudpdf_tpu/models/norm.py``: ``MaskedBatchNorm``
(statistics over valid points only) and the prompt-driven norms
``PDMaskedBatchNorm`` / ``PDLayerNorm`` (one bank a dataset condition, an
optional modulation from a context vector).  The state follows torch's
names (``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``) and the reference's nesting (Pointcept
``PDBatchNorm``: ``bns.{i}``, or ``bn`` when not decoupled, and
``modulation.1``), so reference checkpoints load as they are.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..utils import comm


class MaskedBatchNorm(nn.Module):
    """BatchNorm over all leading dims of x (..., C) with a validity mask
    broadcastable to x.shape[:-1].  ``momentum`` follows torch:
    running = (1 - m) * running + m * batch; the running variance is
    unbiased, the normalisation biased.  Without ``affine`` there is no
    weight or bias (torch's ``affine=False``).  In training over several
    ranks the statistics are the global batch's (``comm.sum_moments``), so
    the running statistics stay equal on every rank; eval mode does no
    collective."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if self.training:
            # statistics in f32 (a bfloat16 input under autocast too)
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            if mask is None:
                w = torch.ones(x.shape[:-1], dtype=xf.dtype, device=x.device)
            else:
                w = mask.expand(x.shape[:-1]).to(xf.dtype)
            sx, sxx, n = comm.sum_moments(
                (xf * w[..., None]).sum(dim=dims),
                (xf * xf * w[..., None]).sum(dim=dims), w.sum())
            cnt = torch.clamp(n, min=1.0)
            mean = sx / cnt
            var = sxx / cnt - mean * mean
            var = torch.clamp(var, min=0.0)
            self._update_running(mean, var, cnt)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        if self.weight is None:
            return ((x - mean) * inv).to(x.dtype)
        return ((x - mean) * (inv * self.weight) + self.bias).to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var, cnt):
        # unbiased running variance, biased normalisation (torch)
        unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean)
        self.running_var.mul_(1 - m).add_(m * unbiased)
        self.num_batches_tracked.add_(1)

    def train_affine(self, mean, var, cnt):
        """Training-mode BN folded into ``(scale, shift)`` over batch
        statistics the caller computed (the fused attention's stats pass).
        ``mean``/``var`` are the masked biased statistics over ``cnt``
        entries; the running statistics update exactly as ``forward``
        would.  Differentiable through mean and var."""
        var = torch.clamp(var, min=0.0)
        self._update_running(mean, var, cnt)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return scale, self.bias - mean * scale

    def affine(self):
        """Eval-mode BN folded into ``(scale, shift)``: y = x*scale + shift."""
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        return scale, self.bias - self.running_mean * scale


def _modulation(context_channels: int, features: int, zero_init: bool):
    """The adaptive modulation, SiLU -> Linear(context, 2 C); zero at
    initialisation under ``zero_init`` (training starts at the identity)."""
    mod = nn.Sequential(nn.SiLU(), nn.Linear(context_channels, 2 * features))
    if zero_init:
        nn.init.zeros_(mod[1].weight)
    else:
        nn.init.trunc_normal_(mod[1].weight, std=0.02)
    nn.init.zeros_(mod[1].bias)
    return mod


def _modulate(mod, y, context):
    """y (1 + scale) + shift, the two halves of ``mod(context)``."""
    if context is None:
        raise ValueError("adaptive PDNorm needs a context")
    shift, scale = mod(context.reshape(-1)).chunk(2)
    return y * (1.0 + scale) + shift


def _bank(conditions: Sequence[str], condition: Optional[str]) -> int:
    """The index of ``condition``'s bank."""
    if condition not in conditions:
        raise ValueError(f"PDNorm condition {condition!r} not in {tuple(conditions)}")
    return tuple(conditions).index(condition)


class PDMaskedBatchNorm(nn.Module):
    """Prompt-driven (per-dataset) masked BatchNorm, the counterpart of the
    JAX ``PDMaskedBatchNorm`` (reference ``PDBatchNorm``).  Decoupled, it
    keeps one ``MaskedBatchNorm`` a condition (``bns``) and normalises with
    the bank of ``condition``: only that bank's running statistics move in
    training.  Adaptive, it modulates the output by ``(1 + scale, shift)``
    from the context vector through SiLU and a Linear.

    ``condition`` and ``context`` are attributes, set by the owning model
    before each forward (PT-v2m3 sets them on all its norms), so the norm is
    called as a ``MaskedBatchNorm`` is: ``norm(x, mask)``.  The JAX module
    stacks the banks as ``(n_bank, C)`` leaves; ``bridge.py`` maps them."""

    def __init__(self, num_features: int, conditions: Sequence[str],
                 condition: Optional[str] = None, decouple: bool = True,
                 adaptive: bool = False, affine: bool = True,
                 context_channels: int = 256, momentum: float = 0.01,
                 eps: float = 1e-3, zero_init: bool = True):
        super().__init__()
        self.conditions = tuple(conditions)
        self.condition = condition
        self.context = None
        self.decouple = decouple
        self.adaptive = adaptive
        make = functools.partial(MaskedBatchNorm, num_features, eps, momentum, affine)
        if decouple:
            self.bns = nn.ModuleList([make() for _ in self.conditions])
        else:
            self.bn = make()
        if adaptive:
            self.modulation = _modulation(context_channels, num_features, zero_init)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        bank = (self.bns[_bank(self.conditions, self.condition)]
                if self.decouple else self.bn)
        y = bank(x, mask)
        if self.adaptive:
            y = _modulate(self.modulation, y, self.context)
        return y.to(x.dtype)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        # a JAX tree's single bank comes through the bridge as bns.0, which
        # is ``bn`` when the norm is not decoupled
        if not self.decouple:
            head = prefix + "bns.0."
            for key in [k for k in state_dict if k.startswith(head)]:
                state_dict[prefix + "bn." + key[len(head):]] = state_dict.pop(key)
        super()._load_from_state_dict(state_dict, prefix, *args)


class PDLayerNorm(nn.Module):
    """Prompt-driven LayerNorm, the counterpart of the JAX ``PDLayerNorm``
    (reference ``PDNorm`` over ``LayerNorm``): per-condition affine banks
    under ``norm.{i}`` (one ``norm`` when not decoupled) and the optional
    modulation; statistics in f32 over the channels.  ``condition`` and
    ``context`` are attributes, as in ``PDMaskedBatchNorm``."""

    def __init__(self, num_features: int, conditions: Sequence[str],
                 condition: Optional[str] = None, decouple: bool = True,
                 adaptive: bool = False, affine: bool = True,
                 context_channels: int = 256, eps: float = 1e-6,
                 zero_init: bool = True):
        super().__init__()
        self.conditions = tuple(conditions)
        self.condition = condition
        self.context = None
        self.decouple = decouple
        self.adaptive = adaptive
        make = functools.partial(nn.LayerNorm, num_features, eps,
                                 elementwise_affine=affine)
        self.norm = (nn.ModuleList([make() for _ in self.conditions])
                     if decouple else make())
        if adaptive:
            self.modulation = _modulation(context_channels, num_features, zero_init)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        ln = (self.norm[_bank(self.conditions, self.condition)]
              if self.decouple else self.norm)
        y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
        if self.adaptive:
            y = _modulate(self.modulation, y, self.context)
        return y.to(x.dtype)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        # a JAX tree's single bank comes through the bridge as norm.0, which
        # is ``norm`` when the norm is not decoupled
        if not self.decouple:
            head = prefix + "norm.0."
            for key in [k for k in state_dict if k.startswith(head)]:
                state_dict[prefix + "norm." + key[len(head):]] = state_dict.pop(key)
        super()._load_from_state_dict(state_dict, prefix, *args)


# The JAX package defines ``_bn_factory`` in
# pointcloudpdf_tpu/models/sparse_unet/spconv_unet.py; the port keeps it
# here, beside the norms, and the port's spconv_unet.py re-exports it.
def _bn_factory(conditions=(), condition=None, decouple=True, adaptive=False,
                affine=True, context_channels=256, zero_init=True):
    """Norm constructor: plain masked BN, or per-condition PDNorm when
    ``conditions`` is non-empty (the SpUNet-v1m3 swap,
    reference spconv_unet_v1m3_pdnorm.py:231-268).  Both at momentum 0.01
    and epsilon 1e-3, where a plain ``MaskedBatchNorm`` keeps 0.1 and
    1e-5."""
    if conditions:
        return functools.partial(
            PDMaskedBatchNorm, conditions=tuple(conditions),
            condition=condition, decouple=decouple, adaptive=adaptive,
            affine=affine, context_channels=context_channels,
            zero_init=zero_init, momentum=0.01, eps=1e-3,
        )
    return functools.partial(MaskedBatchNorm, momentum=0.01, eps=1e-3)
