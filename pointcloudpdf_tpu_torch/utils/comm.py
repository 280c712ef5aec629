"""Cross-process queries (counterpart of ``pointcloudpdf_tpu/utils/comm.py``).

The port runs one process on one device so far, so these give the
single-process answers; the ``torch.distributed`` bodies come with the
multi-process trainer.
"""

from __future__ import annotations

from typing import Any, List


def get_world_size() -> int:
    return 1


def get_rank() -> int:
    return 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier across processes (no-op in one process)."""


def all_gather(data: Any) -> List[Any]:
    """One entry per process."""
    return [data]
