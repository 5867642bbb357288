"""BuFF's adaptive voxel tree (counterpart of nerfmeshes_tpu/buff/tree.py).

- `TreeSampling` is the host controller: the leaf list, its padded device
  arrays of fixed capacity (inactive rows are far-away degenerate boxes),
  consolidation (prune weak voxels, subdivide strong ones best-first) and
  serialization.
- `ray_voxel_intersect` is the deterministic chord-length-proportional
  sampler: the slab test and first-K chord compaction
  (ops/kernels/chords.py, the port of the TPU `_chords_kernel`), a stable
  depth sort of the K chords, and the inverse length mapping with
  torch.searchsorted and gathers. JAX spells the gathers and searches as
  one-hot MXU contractions for its TPU; the values are the same.
- `integrate` folds rendered weights into the per-voxel running mean with
  a scatter-add over the voxels.

The random multinomial sampler (`use_random_sampling`) is not ported yet
(ROADMAP.md); the shipped BuFF configs do not use it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, NamedTuple

import numpy as np
import torch

from nerfmeshes_tpu_torch.ops.kernels.chords import BIG, compact_chords

# Inactive-row sentinel: a degenerate box far outside any scene, so the slab
# test never passes the near/far cap.
_PAD_LO = 1e8
_PAD_HI = 1e8 + 1.0

# Default chord-slot cap: a ray crosses ~3 * outer_count cells of the
# shipped grids, and BuFFSystem doubles the cap when chords are dropped.
AUTO_CHORD_CAP = 64


@dataclass
class Leaf:
    """One leaf cell of the subdivision tree (host side)."""

    lo: np.ndarray  # (3,)
    hi: np.ndarray  # (3,)
    depth: int


@dataclass
class TreeState:
    """The tree on the device: voxels (capacity, 2, 3) f32, active
    (capacity,) bool, memm (capacity,) f32 running mean weight, and the
    integration count, a host int (nothing reads it from the device)."""

    voxels: torch.Tensor
    active: torch.Tensor
    memm: torch.Tensor
    counter: int = 1

    def replace(self, **changes) -> "TreeState":
        return replace(self, **changes)


class TreeSampling:
    """Host-side controller owning the leaf list and the consolidation
    schedule's settings."""

    def __init__(self, cfg):
        tree_cfg = cfg.tree
        self.max_voxels = int(tree_cfg.max_voxel_count)
        self.eps = float(tree_cfg.eps)
        self.max_depth = int(tree_cfg.max_depth)
        self.outer_count = int(tree_cfg.subdivision_outer_count)
        self.inner_count = int(tree_cfg.subdivision_inner_count)
        self.use_random_sampling = bool(tree_cfg.use_random_sampling)
        self.step_size_tree = int(tree_cfg.step_size_tree)
        self.integration_offset = int(tree_cfg.step_size_integration_offset)
        # The cap bounds subdivision, not the initial grid: outer_count^3 may
        # exceed max_voxel_count until the first consolidation prunes.
        self.capacity = max(self.max_voxels, self.outer_count ** 3)

        near, far = float(cfg.dataset.near), float(cfg.dataset.far)
        mean = (near + far) / 2.0
        lo = np.full(3, near - mean, np.float32)
        hi = np.full(3, far - mean, np.float32)
        # Root subdivision: outer_count^3 cells at depth 1.
        self.leaves: List[Leaf] = _subdivide(Leaf(lo, hi, 0), self.outer_count)

    # -- padded device state -----------------------------------------------------
    def device_state(self, device) -> TreeState:
        """The leaves as padded arrays on `device`, memm 0, counter 1."""
        V = len(self.leaves)
        if V > self.capacity:
            raise ValueError(f"{V} leaves exceed capacity {self.capacity}")
        voxels = np.stack([np.stack([leaf.lo, leaf.hi]) for leaf in self.leaves]).astype(np.float32)
        pad = self.capacity - V
        if pad:
            pad_box = np.stack([np.full((3,), _PAD_LO, np.float32),
                                np.full((3,), _PAD_HI, np.float32)])
            voxels = np.concatenate([voxels, np.tile(pad_box, (pad, 1, 1))])
        active = np.zeros(self.capacity, bool)
        active[:V] = True
        return TreeState(
            voxels=torch.from_numpy(voxels).to(device),
            active=torch.from_numpy(active).to(device),
            memm=torch.zeros(self.capacity, dtype=torch.float32, device=device),
        )

    # -- consolidation (host) -----------------------------------------------------
    def consolidate(self, memm, device) -> TreeState:
        """Prune voxels with memm <= eps, subdivide the rest shallow and
        heavy first while the capacity cap allows, and return the new
        tree's state on `device` (integration state reset). `memm` is a
        host array (or tensor) of at least len(leaves) f32 values."""
        if isinstance(memm, torch.Tensor):
            memm = memm.detach().cpu().numpy()
        memm = np.asarray(memm, np.float32)[: len(self.leaves)]
        keep = memm > self.eps
        kept = [self.leaves[i] for i in np.nonzero(keep)[0]]
        inv_w = (1.0 - memm[keep]).tolist()

        # Shallow + heavy first.
        order = sorted(range(len(kept)), key=lambda i: (kept[i].depth, inv_w[i]))
        kept = [kept[i] for i in order]

        inner_size = self.inner_count ** 3 - 1
        current = len(kept)
        children: List[Leaf] = []
        for index, leaf in enumerate(kept):
            projected = len(children) + inner_size + current - index
            if projected < self.max_voxels and leaf.depth < self.max_depth:
                children.extend(_subdivide(leaf, self.inner_count))
            else:
                children.append(leaf)

        if not children:
            raise RuntimeError(f"Tree pruning removed every voxel (eps={self.eps} too high)")
        self.leaves = children
        return self.device_state(device)

    # -- serialization -------------------------------------------------------------
    def serialize(self, state: TreeState) -> dict:
        """The leaves padded to capacity, memm and the counter, as numpy."""
        V = len(self.leaves)
        lo = np.full((self.capacity, 3), _PAD_LO, np.float32)
        hi = np.full((self.capacity, 3), _PAD_HI, np.float32)
        depth = np.zeros((self.capacity,), np.int32)
        lo[:V] = np.stack([leaf.lo for leaf in self.leaves])
        hi[:V] = np.stack([leaf.hi for leaf in self.leaves])
        depth[:V] = [leaf.depth for leaf in self.leaves]
        return {
            "leaf_lo": lo,
            "leaf_hi": hi,
            "leaf_depth": depth,
            "memm": state.memm.detach().cpu().numpy(),
            "counter": np.asarray(state.counter, np.int32),
            "num_leaves": np.asarray(V, np.int32),
        }

    def deserialize(self, data: dict, device) -> TreeState:
        V = int(data["num_leaves"])
        self.leaves = [
            Leaf(np.asarray(data["leaf_lo"][i], np.float32),
                 np.asarray(data["leaf_hi"][i], np.float32),
                 int(data["leaf_depth"][i]))
            for i in range(V)
        ]
        return self.device_state(device).replace(
            memm=torch.as_tensor(np.asarray(data["memm"], np.float32), device=device),
            counter=int(data["counter"]),
        )


def _subdivide(leaf: Leaf, count: int) -> List[Leaf]:
    """Uniform count^3 split."""
    offset = leaf.hi - leaf.lo
    out = []
    for i in range(count):
        for g in range(count):
            for h in range(count):
                ind1 = np.array([i, g, h], np.float32) / count * offset
                ind2 = np.array([i + 1, g + 1, h + 1], np.float32) / count * offset
                out.append(Leaf(leaf.lo + ind1, leaf.lo + ind2, leaf.depth + 1))
    return out


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------


class Intersection(NamedTuple):
    z_vals: torch.Tensor  # (R, S) f32, depth-sorted
    voxel_idx: torch.Tensor  # (R, S) int32
    ray_mask: torch.Tensor  # (R,) bool: the ray crosses an active voxel
    dropped: torch.Tensor  # (R,) int32: chords past the cap


def _unit_linspace(num: int, device) -> torch.Tensor:
    """jnp.linspace(0, 1, num) bit for bit: i / (num - 1) in f32 (JAX's
    start * (1 - step) + stop * step with start 0, stop 1), 1 last. The
    divisor is a device tensor: a CUDA division by a host scalar multiplies
    by its reciprocal instead."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    steps = torch.arange(num, dtype=torch.float32, device=device)
    return steps / torch.full((), num - 1, dtype=torch.float32, device=device)


def ray_voxel_intersect(voxels: torch.Tensor, active: torch.Tensor, origins: torch.Tensor,
                        dirs: torch.Tensor, near, far, *, samples_count: int,
                        use_random_sampling: bool = False, max_chords: int = 0,
                        compact=compact_chords) -> Intersection:
    """Batch ray/voxel intersection and per-ray depth samples, sorted by
    depth (nerfmeshes_tpu/buff/tree.py:217-421).

    voxels (V, 2, 3), active (V,), origins (R, 3) or (3,), dirs (R, 3);
    near / far floats, 0-dim tensors or (R,). Each ray's valid chords are
    compacted into K = min(V, max_chords or AUTO_CHORD_CAP) slots in voxel
    order (`dropped` counts those past K), sorted by entry depth, and
    `samples_count` targets spaced evenly over the total chord length are
    mapped back into the chords. `compact` is the chord compaction
    (tests pass compact_chords_plain to hold the kernel against it)."""
    if use_random_sampling:
        raise NotImplementedError(
            "the random voxel sampler (tree.use_random_sampling) is not ported yet "
            "(queued in ROADMAP.md); the shipped BuFF configs use the deterministic one")
    R = dirs.shape[0]
    V = voxels.shape[0]
    K = min(V, max_chords if max_chords > 0 else AUTO_CHORD_CAP)
    device = dirs.device
    origins = origins.reshape(-1, 3).expand(R, 3).contiguous()
    lo_k, hi_k, ids_k, n_hit = compact(voxels.contiguous(), active.contiguous(), origins,
                                       dirs.contiguous(), near, far, K=K)
    ray_mask = n_hit > 0
    dropped = torch.clamp(n_hit - K, min=0)

    # Depth-sort the K chords (voxels are disjoint, so entry order is chord
    # order). Stable: empty slots tie at BIG, and chords meeting at a face
    # can tie too.
    lo_k, order = torch.sort(lo_k, dim=-1, stable=True)
    hi_k = torch.gather(hi_k, -1, order)
    ids_k = torch.gather(ids_k, -1, order)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    lo_k = torch.where(lo_k >= BIG, zero, lo_k)
    hi_k = torch.where(hi_k >= BIG, zero, hi_k)

    cums = torch.cumsum(hi_k - lo_k, dim=-1)
    samples = _unit_linspace(samples_count, device)[None, :] * cums[:, -1:]  # (R, S)
    bucket = torch.searchsorted(cums, samples, side="left").clamp_(max=K - 1)
    first_in_bucket = torch.searchsorted(bucket, bucket, side="left")
    offset = samples - torch.gather(samples, -1, first_in_bucket)
    z_vals = torch.gather(lo_k, -1, bucket) + offset
    voxel_idx = torch.gather(ids_k, -1, bucket)
    return Intersection(z_vals, voxel_idx, ray_mask, dropped)


def integrate(state: TreeState, voxel_idx: torch.Tensor, weights: torch.Tensor,
              mask_weights: torch.Tensor, ray_mask: torch.Tensor) -> TreeState:
    """Fold rendered sample weights into the per-voxel running mean
    (nerfmeshes_tpu/buff/tree.py:553-603). voxel_idx / weights /
    mask_weights (R, S), ray_mask (R,).

    A scatter-add over the voxels where JAX contracts a one-hot on its MXU.
    On the card index_add_ sums with float atomics, in an order that
    changes from run to run, so memm is not bitwise repeatable there; it
    feeds only the eps = 1e-4 prune at each consolidation."""
    V = state.memm.shape[0]
    rm = ray_mask[:, None].to(weights.dtype)
    flat_idx = voxel_idx.reshape(-1)
    w = (weights * rm).reshape(-1)
    f = (mask_weights * rm).reshape(-1)
    acc = torch.zeros(V, dtype=weights.dtype, device=weights.device).index_add_(0, flat_idx, w)
    freq = torch.zeros(V, dtype=weights.dtype, device=weights.device).index_add_(0, flat_idx, f)
    hit = freq > 0
    one = torch.ones((), dtype=freq.dtype, device=freq.device)
    delta = torch.where(hit, acc / torch.where(hit, freq, one) - state.memm,
                        torch.zeros((), dtype=freq.dtype, device=freq.device))
    counter = torch.full((), state.counter, dtype=torch.float32, device=freq.device)
    return state.replace(memm=state.memm + delta / counter, counter=state.counter + 1)
