"""The operations the algorithm needs, counted from shapes, and the peak
they are held to.

A point's forward is the FlexibleNeRF's products: 2 operations for each
weight (a multiply and an add), no positional encoding, activations or
padding. The backward needs the dX and dW products, 2x the forward; a
training step is 3x the forward (forward, dX, dW) and a render 1x. No
recompute and no stash: those are choices of today's kernels, not of the
algorithm. A ray has the coarse network's coarse points and the fine
network's coarse + fine points.
"""

from __future__ import annotations

import subprocess

from harness.reference import leaf_shapes

# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, at its 700 W.
PEAK_BF16_FLOPS = 989e12


def field_macs(model: dict) -> int:
    """Multiply-accumulates per point of a FlexibleNeRF with view
    directions: every weight of every product."""
    return sum(shape[0] * shape[1] for name, shape in leaf_shapes(model)
               if name.endswith(".weight"))


def forward_flops_per_ray(cfg: dict, train: bool) -> int:
    """Forward operations of one ray through both fields."""
    mode = cfg["nerf"]["train" if train else "validation"]
    coarse, fine = mode["num_coarse"], mode["num_coarse"] + mode["num_fine"]
    return 2 * (coarse * field_macs(cfg["models"]["coarse"])
                + fine * field_macs(cfg["models"]["fine"]))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why
    they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read ({err})"
    return out.stdout.strip().replace("\n", "; ") or f"not read ({out.stderr.strip()})"
