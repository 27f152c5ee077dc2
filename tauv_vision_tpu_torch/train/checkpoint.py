"""Checkpoints with the configuration beside the weights (counterpart of
``tauv_vision_tpu/train/checkpoint.py``).

Each checkpoint is ``<directory>/<step>/state.pt``: ``torch.save`` of the
model's state dict (parameters and BatchNorm statistics), the optimizer's
and the step count, with the metrics it was saved at in
``metrics.json``.  The configurations are JSON files in the directory
(``save_configs``), so that a reader can rebuild the model.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, List, Optional

import torch

from tauv_vision_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    """Saves and restores ``TrainState``s under ``directory``, every step
    saved kept."""

    def __init__(self, directory: pathlib.Path):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def save_configs(self, configs: Dict[str, Any]) -> None:
        """Write each configuration (a dataclass, or anything JSON takes) as
        ``<name>.json``."""
        for name, config in configs.items():
            payload = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else config
            with open(self.directory / f"{name}.json", "w") as fp:
                json.dump(payload, fp, indent=2)

    def load_config(self, name: str) -> dict:
        with open(self.directory / f"{name}.json") as fp:
            return json.load(fp)

    def all_steps(self) -> List[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, metrics: Optional[dict] = None) -> None:
        target = self.directory / str(step)
        target.mkdir(exist_ok=True)
        tmp = target / (STATE_FILE + ".tmp")
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step}, tmp)
        tmp.replace(target / STATE_FILE)
        if metrics is not None:
            with open(target / "metrics.json", "w") as fp:
                json.dump(metrics, fp)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load a checkpoint (the newest when ``step`` is None) into
        ``state``'s model and optimizer, on the model's device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        device = next(state.model.parameters()).device
        saved = torch.load(self.directory / str(step) / STATE_FILE, map_location=device,
                           weights_only=True)
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        return state

    def close(self) -> None:
        pass
