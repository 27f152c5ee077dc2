"""Metric writers (a copy of ``tauv_vision_tpu/train/metrics.py``'s
stdout and JSONL writers; figures come with a later slice).

Every loss term is logged each step, as the reference logs them.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Dict, Protocol


class MetricWriter(Protocol):
    def log(self, metrics: Dict[str, float], step: int) -> None: ...
    def close(self) -> None: ...


class StdoutWriter:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def log(self, metrics: Dict[str, float], step: int) -> None:
        parts = " ".join(f"{k}={v:.5g}" for k, v in metrics.items())
        print(f"{self.prefix}step={step} {parts}", flush=True)

    def close(self) -> None:
        pass


class JsonlWriter:
    """One JSON record of scalars a line, appended to ``path``."""

    def __init__(self, path: pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fp = open(self.path, "a")

    def log(self, metrics: Dict[str, float], step: int) -> None:
        record = {"step": step, "time": time.time(), **metrics}
        self._fp.write(json.dumps(record) + "\n")
        self._fp.flush()

    def close(self) -> None:
        self._fp.close()


class MultiWriter:
    def __init__(self, *writers: MetricWriter):
        self.writers = [w for w in writers if w is not None]

    def log(self, metrics: Dict[str, float], step: int) -> None:
        for w in self.writers:
            w.log(metrics, step)

    def close(self) -> None:
        for w in self.writers:
            w.close()


def losses_to_metrics(losses, prefix: str) -> Dict[str, float]:
    """A losses dataclass as scalar metrics (one host read a field)."""
    out = {}
    for field in dataclasses.fields(losses):
        value = getattr(losses, field.name)
        if value is not None:
            out[f"{prefix}{field.name}"] = float(value)
    return out
