"""Metric and image logging (counterpart of nerfmeshes_tpu/utils/logging.py).

An append-only metrics.jsonl (one record per log call: step, time and the
metrics, the JAX package's keys), the console line with acronymised
metric names, the console progress bars (`progress_bar`), validation images as PNGs under <events>/images/ through
the port's own PNG writer, and a TensorBoard event file in <events>
(utils/tb_events.py, written without tensorboard: the GPU host has none)
that gets the scalars, images and texts where the JAX package's
SummaryWriter gets them, and that the depth-projection and tree loggers
(utils/loggers.py) write their meshes and images to (`_tb`).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np

from nerfmeshes_tpu_torch.data.blender import encode_png
from nerfmeshes_tpu_torch.utils.images import cast_to_disparity_image  # noqa: F401
from nerfmeshes_tpu_torch.utils.tb_events import EventWriter


def acronym(name: str) -> str:
    """'train/coarse_loss' -> 't/cl'. Single-word metrics stay whole, so
    'loss' and 'lr' don't both collapse to 'l'."""
    scope, _, metric = name.partition("/")
    if not metric:
        return scope
    parts = [p for p in metric.split("_") if p]
    short = "".join(p[0] for p in parts) if len(parts) > 1 else parts[0]
    return f"{scope[0]}/{short}"


def progress_bar(total: int, desc: str, initial: int = 0, position: int = 0, *,
                 show: bool = True):
    """A console progress bar (JAX's: the train bar and the validation bar
    under it). Enabled when stderr is a TTY, or forced by
    NERFMESHES_PROGRESS (0 or false turns it off, anything else on);
    `show=False` (a rank other than 0) turns it off too. Returns a tqdm
    bar, or an inert stub when disabled or without tqdm (the GPU host has
    none), so call sites never branch."""
    env = os.environ.get("NERFMESHES_PROGRESS")
    enabled = sys.stderr.isatty() if env is None else env not in ("0", "false")
    if enabled and show:
        try:
            from tqdm import tqdm
        except ImportError:
            pass
        else:
            return tqdm(total=total, desc=desc, initial=initial, position=position,
                        dynamic_ncols=True, leave=position == 0)
    return _NoopBar()


class _NoopBar:
    """progress_bar's stand-in: every call does nothing."""

    def update(self, n=1):
        pass

    def set_postfix_str(self, s, refresh=True):
        pass

    def close(self):
        pass


class MetricsLogger:
    def __init__(self, log_dir, use_acronyms: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.use_acronyms = use_acronyms
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = EventWriter(self.log_dir)

    def log_scalars(self, metrics: Dict[str, float], step: int) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v)
            self._tb.add_scalar(k, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_image(self, tag: str, image, step: int) -> None:
        """image: (H, W, 3) float in [0, 1] or uint8, written to
        images/<tag with '/' as '_'>_<step>.png."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        png = encode_png(img)  # one encoding for the event file and the PNG
        self._tb.add_png(tag, png, img.shape if img.ndim == 3 else (*img.shape, 1), step)
        out_dir = self.log_dir / "images"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"{tag.replace('/', '_')}_{step}.png").write_bytes(png)

    def log_text(self, tag: str, text: str, step: int = 0) -> None:
        self._tb.add_text(tag, text, step)

    def console_line(self, metrics: Dict[str, float], step: int) -> str:
        items = [f"{acronym(k) if self.use_acronyms else k}={float(v):.5g}"
                 for k, v in metrics.items()]
        return f"[step {step}] " + " ".join(items)

    def close(self) -> None:
        self._jsonl.close()
        self._tb.close()
