"""Cross-process communication (counterpart of ``pointcloudpdf_tpu/utils/comm.py``).

Host-side queries and object collectives on ``torch.distributed``, and the
few tensor collectives that make a data-parallel step compute what one
process computes on the global batch (the JAX package gets them from
GSPMD): a differentiable sum of statistics over ranks, a sum of weight
counts for the losses' denominators, and a loss's share of a value every
rank computes whole.

Every function gives the single-process answer, and issues no collective,
when ``torch.distributed`` is not initialised.  Once it is (``launch``),
every collective is issued, at world 1 too.  Objects travel over a CPU
gloo group, so they work beside NCCL; tensor collectives are
``all_reduce`` and ``broadcast`` only, the two that gloo also runs on CUDA
tensors (ranks sharing one card).
"""

from __future__ import annotations

import os
from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def get_local_rank() -> int:
    """This process's rank on its machine (``LOCAL_RANK``, set by
    ``launch`` and by torchrun)."""
    return int(os.environ.get("LOCAL_RANK", 0)) if is_distributed() else 0


def is_main_process() -> bool:
    return get_rank() == 0


_OBJECT_GROUPS = {}  # the default group -> its gloo group for objects


def _cpu_group():
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if world not in _OBJECT_GROUPS:
        _OBJECT_GROUPS[world] = dist.new_group(backend="gloo")
    return _OBJECT_GROUPS[world]


def destroy() -> None:
    """Tear the process groups down (``launch``'s exit)."""
    _OBJECT_GROUPS.clear()
    if is_distributed():
        dist.destroy_process_group()


def synchronize() -> None:
    """Barrier across processes."""
    if is_distributed():
        dist.barrier(group=_cpu_group())


def all_gather(data: Any) -> List[Any]:
    """A picklable object from every process, in rank order."""
    if not is_distributed():
        return [data]
    out = [None] * get_world_size()
    dist.all_gather_object(out, data, group=_cpu_group())
    return out


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Objects gathered on rank ``dst`` (the others get [])."""
    if not is_distributed():
        return [data]
    rank = get_rank()
    out = [None] * get_world_size() if rank == dst else None
    dist.gather_object(data, out, dst=dst, group=_cpu_group())
    return out if rank == dst else []


def shared_random_seed() -> int:
    """A seed every process agrees on (rank 0's draw)."""
    return int(all_gather(np.random.randint(2**31))[0])


def reduce_dict(input_dict: dict, average: bool = True) -> dict:
    """Scalar dict values summed (or averaged) over processes."""
    if not is_distributed():
        return dict(input_dict)
    gathered = all_gather({k: float(v) for k, v in input_dict.items()})
    out = {}
    for key in input_dict:
        total = sum(d[key] for d in gathered)
        out[key] = total / get_world_size() if average else total
    return out


# -- tensor collectives of the data-parallel step ----------------------------


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, tensor):
        return all_reduce_(tensor.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone())


def sum_over_ranks(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` summed over ranks, as a new tensor.  Where it needs a
    gradient the sum is differentiable and its backward sums the gradients
    over ranks too (SyncBN's rule), so a statistic of the global batch gets
    the gradient of every rank's loss."""
    if not is_distributed():
        return tensor
    if torch.is_grad_enabled() and tensor.requires_grad:
        return _SumOverRanks.apply(tensor)
    return all_reduce_(tensor.detach().clone())


def sum_moments(sx, sxx, n):
    """A masked BatchNorm's statistics ``(sum w x, sum w x^2, sum w)`` of
    the global batch, summed over ranks in one differentiable all-reduce
    (the JAX package's BatchNorms are global under GSPMD)."""
    if not is_distributed():
        return sx, sxx, n
    c = sx.shape[0]
    total = sum_over_ranks(torch.cat([sx, sxx, n.reshape(1)]))
    return total[:c], total[c:2 * c], total[2 * c]


def rank_share(loss: torch.Tensor) -> torch.Tensor:
    """This rank's share of a loss each rank computes: the trainer sums
    the ranks' losses and gradients, so a loss that every rank computes
    whole (from statistics summed over ranks) or for its own batch alone
    (Lovasz) counts once, as the mean over ranks."""
    if not is_distributed():
        return loss
    return loss / get_world_size()


def all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over ranks in place (gradients, logged losses)."""
    if is_distributed():
        dist.all_reduce(tensor)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``tensor`` with rank ``src``'s, in place."""
    if is_distributed():
        dist.broadcast(tensor, src)
    return tensor
