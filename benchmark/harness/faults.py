"""Faults planted under the timed path, to show that `correct` catches
them. Never applied in a benchmark run: the tests and calibrate.py name
one explicitly. apply() returns the function that takes the fault out."""

from __future__ import annotations

import torch

FAULTS = {
    "train": ("unchanged", "half_batch", "half_loss"),
    "render": ("altered", "stale"),
}


def _patch(module, name: str, wrapper):
    original = getattr(module, name)
    setattr(module, name, wrapper(original))
    return lambda: setattr(module, name, original)


def apply(fault: str, system):
    if fault == "unchanged":
        # A step that returns its state unchanged: the update rule does nothing.
        system.optimizer.rule.step = lambda closure=None: None
        return lambda: delattr(system.optimizer.rule, "step")
    if fault == "half_batch":
        # Half of the batch left out: each step renders the first half of
        # its rays, and its loss is the mean over them.
        from nerfmeshes_tpu_torch.train import step as step_module

        def wrapper(original):
            def half(*args, **kwargs):
                out = original(*args, **kwargs)
                n = out[1].shape[0] // 2
                return tuple(t[:n] if isinstance(t, torch.Tensor) and t.dim() > 0
                             and t.shape[0] == 2 * n else t for t in out)
            return half

        return _patch(step_module, "rays_from_indices", wrapper)
    if fault == "half_loss":
        # Every ray rendered, the loss's mean taken over the first half of
        # them only (a slice or mask fault in the loss).
        from nerfmeshes_tpu_torch.train import step as step_module

        def wrapper(original):
            def half(src, target):
                n = src.shape[0] // 2
                return original(src[:n], target[:n])
            return half

        return _patch(step_module, "img2mse", wrapper)
    if fault == "altered":
        # An answer altered where it is produced: every other fine pass's
        # composited rgb moved by 0.05.
        from nerfmeshes_tpu_torch.train import render as render_module

        def wrapper(original):
            calls = [0]

            def altered(*args, **kwargs):
                out = original(*args, **kwargs)
                calls[0] += 1
                if calls[0] % 4 == 0:
                    out = out._replace(rgb_map=out.rgb_map + 0.05)
                return out
            return altered

        return _patch(render_module, "volume_render", wrapper)
    if fault == "stale":
        # Each view answered with the previous view's maps.
        original = system.query_rays
        last = []

        def stale(*args, **kwargs):
            last.append(original(*args, **kwargs))
            del last[:-2]
            return last[0]

        system.query_rays = stale
        return lambda: delattr(system, "query_rays")
    raise ValueError(f"unknown fault {fault!r}")
