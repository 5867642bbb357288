"""Checkpoint save and restore (counterpart of
nerfmeshes_tpu/train/checkpoint.py).

The JAX package's policy, kept by orbax there: the top 3 checkpoints by
validation loss under <checkpoints>/<step>/, and always the latest under
<checkpoints>/last/, written to last.tmp/ and renamed, so a crash while
saving never leaves a run without one. Each directory holds one
`state.pt` (torch.save of tensors and plain containers only, read back
with torch.load(weights_only=True)) and `metrics.json` with its val_loss.
A checkpoint without a val_loss ranks below every one with it, as
orbax's -val_loss with a default of -inf does; equal losses keep the
later step.

There is no bridge from orbax checkpoints: orbax needs jax.
"""

from __future__ import annotations

import json
import math
import shutil
from pathlib import Path
from typing import Optional

import torch

_STATE = "state.pt"
_METRICS = "metrics.json"


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        """The numbered checkpoints kept, in step order."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _STATE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _val_loss(self, step: int) -> float:
        loss = json.loads((self.directory / str(step) / _METRICS).read_text()).get("val_loss")
        return math.inf if loss is None else loss

    @staticmethod
    def _write(directory: Path, state: dict, val_loss: Optional[float]) -> None:
        if directory.exists():
            shutil.rmtree(directory)
        directory.mkdir()
        torch.save(state, directory / _STATE)
        (directory / _METRICS).write_text(json.dumps({"val_loss": val_loss}))

    def save(self, state: dict, step: int, *, val_loss: Optional[float] = None) -> None:
        """Write `state` (tensors and plain containers) as checkpoint `step`
        and as `last`, then keep only the best `max_to_keep` numbered ones."""
        val_loss = None if val_loss is None else float(val_loss)
        self._write(self.directory / str(int(step)), state, val_loss)
        ranked = sorted(self.steps(), key=lambda s: -self._val_loss(s))  # worst first
        for old in ranked[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))
        tmp, last = self.directory / "last.tmp", self.directory / "last"
        self._write(tmp, state, val_loss)
        if last.exists():
            shutil.rmtree(last)
        tmp.rename(last)

    def restore(self, step: Optional[int] = None, last: bool = False) -> dict:
        """The state saved as `step`, as `last` when asked (or when no
        numbered checkpoint is kept), else the latest numbered one. Tensors
        come back on the CPU."""
        if last or (step is None and self.latest_step() is None):
            path = self.directory / "last"
        else:
            path = self.directory / str(step if step is not None else self.latest_step())
        return torch.load(path / _STATE, map_location="cpu", weights_only=True)
