# Copied from pointcloudpdf_tpu/utils/events.py; keep in step.
"""Scalar event storage for training metrics.

Host-side running histories used by hooks/writers; a fresh equivalent of the
reference EventStorage (pointcept/utils/events.py:293-427).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

_CURRENT_STORAGE_STACK = []


def get_event_storage() -> "EventStorage":
    if not _CURRENT_STORAGE_STACK:
        raise RuntimeError("get_event_storage() called outside an EventStorage context")
    return _CURRENT_STORAGE_STACK[-1]


class AverageMeter:
    """Tracks latest value, running average, sum, count, min, max."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.total = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def update(self, value, n: int = 1):
        value = float(value)
        self.val = value
        self.total += value * n
        self.count += n
        self.avg = self.total / max(self.count, 1)
        self.min = min(self.min, value)
        self.max = max(self.max, value)


class HistoryBuffer:
    """Bounded history of (value, iteration) pairs plus running stats."""

    def __init__(self, max_length: int = 1000000):
        self._max_length = max_length
        self._data = []
        self._count = 0
        self._global_sum = 0.0

    def update(self, value: float, iteration: Optional[int] = None):
        if iteration is None:
            iteration = self._count
        self._data.append((float(value), iteration))
        if len(self._data) > self._max_length:
            self._data.pop(0)
        self._count += 1
        self._global_sum += float(value)

    def latest(self) -> float:
        return self._data[-1][0]

    def median(self, window_size: int = 20) -> float:
        values = sorted(v for v, _ in self._data[-window_size:])
        return values[len(values) // 2]

    def avg(self, window_size: int = 20) -> float:
        values = [v for v, _ in self._data[-window_size:]]
        return sum(values) / max(len(values), 1)

    def global_avg(self) -> float:
        return self._global_sum / max(self._count, 1)

    def values(self):
        return list(self._data)


class EventStorage:
    """Container for scalar histories, usable as a context manager."""

    def __init__(self, start_iter: int = 0):
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._latest_scalars: Dict[str, float] = {}
        self._iter = start_iter
        self._meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)

    def put_scalar(self, name: str, value, n: int = 1):
        value = float(value)
        self._history[name].update(value, self._iter)
        self._latest_scalars[name] = value
        self._meters[name].update(value, n=n)

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def history(self, name: str) -> HistoryBuffer:
        if name not in self._history:
            raise KeyError(f"no history for '{name}'")
        return self._history[name]

    def histories(self) -> Dict[str, HistoryBuffer]:
        return dict(self._history)

    def meter(self, name: str) -> AverageMeter:
        return self._meters[name]

    @property
    def latest(self) -> Dict[str, float]:
        return dict(self._latest_scalars)

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, value: int):
        self._iter = int(value)

    def step(self):
        self._iter += 1

    def reset_histories(self):
        self._history.clear()
        self._latest_scalars.clear()
        self._meters.clear()

    def __enter__(self):
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        assert _CURRENT_STORAGE_STACK[-1] is self
        _CURRENT_STORAGE_STACK.pop()
