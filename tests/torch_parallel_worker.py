"""Port-side ranks for tests/test_torch_parallel*.py. Imports torch and the
port, never jax.

    python tests/torch_parallel_worker.py TASK DIR WORLD [ARGS...]

runs TASK on WORLD gloo ranks on the host (parallel/mesh.py:launch; at
WORLD 1 in this process; task "forced" on a forced one-rank group), and
each rank writes DIR/TASK_wWORLD_rRANK.pt; "checks" and "forced" read
DIR/inputs.pt (tensors and plain containers, written by the test).
Every rank computes what it can of the unsharded reference on its own,
without collectives, so a task can hold the sharded result against it
as well as against JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# The settings both stacks take (dotted keys into each package's schema):
# deterministic (perturb off, sigma noise 0), f32, the nn.Module path.
_FIELD = {"num_layers": 4, "hidden_size": 32, "skip_step": 2, "num_encoding_fn_xyz": 4,
          "num_encoding_fn_dir": 2}
NERF = {
    **{f"models.{m}.{k}": v for m in ("coarse", "fine") for k, v in _FIELD.items()},
    "nerf.train.num_coarse": 16, "nerf.train.num_fine": 16, "nerf.train.perturb": False,
    "nerf.train.radiance_field_noise_std": 0.0, "nerf.train.num_random_rays": 64,
    "nerf.validation.num_coarse": 16, "nerf.validation.num_fine": 16,
    "experiment.compute_dtype": "float32", "experiment.use_fused_kernel": False,
}
BUFF = {**NERF, "experiment.model": "BuFFModel", "models.use_fine": False,
        "tree.subdivision_outer_count": 4, "tree.max_voxel_count": 256,
        "tree.step_size_integration_offset": 0, "tree.step_size_tree": 10_000}
# Gradient accumulation: two micro-batches an update, SGD (continuous in
# the grads, where Adam's first step is +-lr whatever the grad's size).
ACCUM = {**NERF, "optimizer.type": "SGD", "optimizer.lr": 0.05,
         "optimizer.accumulate_steps": 2}
NEAR, FAR = 2.0, 6.0
RENDER_CHUNK = 32
GRID_RES, GRID_TILE, GRID_LIMIT = 17, 1024, 1.2
SPARSE_RES = 32
# Two density blobs (tests/test_mesh.py:248-254): a surface to march.
C1, C2 = np.array([0.3, 0.0, 0.1], np.float32), np.array([-0.4, -0.2, 0.0], np.float32)


def configure(cfg, settings: dict):
    """Set dotted keys on a CfgNode of either package, in place."""
    for key, value in settings.items():
        *path, last = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        node[last] = value
    return cfg


def port_cfg(settings: dict):
    from nerfmeshes_tpu_torch.config import get_default_cfg

    return configure(get_default_cfg(), settings)


def blobs(pts: torch.Tensor) -> torch.Tensor:
    r1 = torch.linalg.norm(pts - torch.from_numpy(C1), dim=-1)
    r2 = torch.linalg.norm(pts - torch.from_numpy(C2), dim=-1)
    return 80.0 * torch.clamp_min(0.45 - r1, 0.0) + 60.0 * torch.clamp_min(0.35 - r2, 0.0)


def _named_grads(models) -> dict:
    return {f"{tag}.{k}": p.grad.detach().clone() for tag, m in models if m is not None
            for k, p in m.named_parameters()}


def _named_params(models) -> dict:
    return {f"{tag}.{k}": p.detach().clone() for tag, m in models if m is not None
            for k, p in m.named_parameters()}


def _spy(optimizer, models, into: list):
    """Record every micro-step's grads as the optimizer receives them."""
    step = optimizer.step

    def spying():
        into.append(_named_grads(models))
        step()

    optimizer.step = spying


def _nerf_state(cfg, weights: dict, device="cpu"):
    from nerfmeshes_tpu_torch.train.optim import build_optimizer
    from nerfmeshes_tpu_torch.train.step import init_train_state
    from nerfmeshes_tpu_torch.train.system import create_models

    coarse, fine = create_models(cfg, device)
    coarse.load_state_dict(weights["coarse"])
    if fine is not None:
        fine.load_state_dict(weights["fine"])
    models = [m for m in (coarse, fine) if m is not None]
    opt = build_optimizer([p for m in models for p in m.parameters()], cfg)
    return init_train_state(coarse, fine, opt, int(cfg.experiment.randomseed), device)


def _rays(batch, rows=slice(None)):
    o, d, t = (torch.as_tensor(a)[rows] for a in batch)
    return (o, d, t, NEAR, FAR, None)


def train_steps(cfg, weights, batches, group):
    """One call per batch of the hierarchical step on this rank's rows:
    (grads of every micro-step, parameters after)."""
    from nerfmeshes_tpu_torch.train.step import make_train_step

    state = _nerf_state(cfg, weights)
    models = [("coarse", state.coarse), ("fine", state.fine)]
    grads: list = []
    _spy(state.optimizer, models, grads)
    fn = make_train_step(cfg, H=1, W=1, focal=1.0, steps_per_call=1, group=group)
    metrics = None
    for batch in batches:
        rows = slice(None) if group is None else group.local_rows(len(batch[0]))
        state, metrics = fn(state, None, rays=_rays(batch, rows))
    return grads, _named_params(models), {k: float(v) for k, v in metrics.items()}


def buff_step(cfg, weights, batch, group):
    """Two calls of the BuFF step on this rank's rows: (grads, memm)."""
    from nerfmeshes_tpu_torch.buff.system import make_buff_train_step
    from nerfmeshes_tpu_torch.buff.tree import TreeSampling

    state = _nerf_state(cfg, weights)
    grads: list = []
    _spy(state.optimizer, [("coarse", state.coarse)], grads)
    tree_state = TreeSampling(cfg).device_state("cpu")
    fn = make_buff_train_step(cfg, H=1, W=1, focal=1.0, steps_per_call=2, group=group)
    rows = slice(None) if group is None else group.local_rows(len(batch[0]))
    state, tree_state, metrics = fn(state, tree_state, None, rays=_rays(batch, rows))
    return grads, tree_state.memm.clone(), tree_state.counter, float(
        metrics["train/dropped_chords"])


def _systems(inp, group):
    from nerfmeshes_tpu_torch.buff.system import BuFFSystem
    from nerfmeshes_tpu_torch.train.system import NeRFSystem

    nerf = NeRFSystem(port_cfg(NERF), device="cpu", group=group).setup_eval()
    nerf.coarse.load_state_dict(inp["nerf"]["coarse"])
    nerf.fine.load_state_dict(inp["nerf"]["fine"])
    buff = BuFFSystem(port_cfg(BUFF), device="cpu", group=group).setup_eval()
    buff.coarse.load_state_dict(inp["buff"]["coarse"])
    active = torch.arange(buff.tree_state.active.shape[0]) % 2 == 0
    buff.tree_state.active = buff.tree_state.active & active
    return nerf, buff


def renders(inp, group) -> dict:
    """render_image through make_render_chunk(group), query_rgb (f32 and
    uint8), a chunk that does not split over the ranks, the dense and the
    sparse grid evals, and the BuFF render through the tree."""
    from nerfmeshes_tpu_torch.mesh.extract import (
        MeshArgs,
        _sparse_density_extract,
        extract_density,
        extract_geometry,
    )
    from nerfmeshes_tpu_torch.train.step import make_render_chunk, render_image

    out = {}
    nerf, buff = _systems(inp, group)
    o, d = inp["render_rays"]
    chunk = make_render_chunk(nerf.cfg, nerf.coarse, nerf.fine, group=group)
    c, f = render_image(chunk, o, d, NEAR, FAR, chunk_size=RENDER_CHUNK)
    out.update({f"coarse.{k}": getattr(c, k) for k in ("rgb_map", "depth_map", "acc_map")})
    out.update({f"fine.{k}": getattr(f, k) for k in ("rgb_map", "depth_map", "disp_map")})
    out["rgb_only_weights_none"] = render_image(chunk, o, d, NEAR, FAR, chunk_size=RENDER_CHUNK,
                                                fields=("rgb_map",))[1].weights is None
    out["query_rgb"] = nerf.query_rgb(o, d, NEAR, FAR, chunk=RENDER_CHUNK)
    out["query_rgb_u8"] = nerf.query_rgb(o, d, NEAR, FAR, chunk=RENDER_CHUNK, as_uint8=True)
    try:
        render_image(chunk, o, d, NEAR, FAR, chunk_size=RENDER_CHUNK + 1)
        out["bad_chunk"] = None
    except ValueError as err:
        out["bad_chunk"] = str(err)
    out["dense_grid"] = extract_density(nerf.sample_points, GRID_LIMIT, GRID_RES,
                                        tile=GRID_TILE, density_fn=nerf.density_points,
                                        device="cpu", group=group)
    grid, _ = _sparse_density_extract(nerf.density_points, GRID_LIMIT, SPARSE_RES, 0.0,
                                      tile=GRID_TILE, clamp_iso=False, device="cpu",
                                      group=group)
    out["sparse_grid"] = None if grid is None else grid.to_dense()
    v, t, n, _ = extract_geometry(None, MeshArgs(res=SPARSE_RES, limit=GRID_LIMIT,
                                                 iso_level=1.0, clamp_iso=False),
                                  density_fn=blobs, device="cpu", group=group)
    out["geometry"] = None if v is None else (v, t, n)
    bo, bd = inp["buff_rays"]
    out["buff_rgb"] = buff.query_rays(bo, bd, NEAR, FAR, chunk=RENDER_CHUNK,
                                      fields=("rgb_map",)).rgb_map
    out["buff_query_rgb"] = buff.query_rgb(bo, bd, NEAR, FAR, chunk=RENDER_CHUNK)
    return out


def integrate_case(inp, group):
    from nerfmeshes_tpu_torch.buff.tree import TreeState, integrate

    case = inp["integrate"]
    state = TreeState(voxels=torch.zeros(len(case["memm"]), 2, 3),
                      active=torch.ones(len(case["memm"]), dtype=torch.bool),
                      memm=torch.as_tensor(case["memm"]), counter=int(case["counter"]))
    rows = slice(None) if group is None else group.local_rows(len(case["ray_mask"]))
    got = integrate(state, *(torch.as_tensor(case[k])[rows]
                             for k in ("voxel_idx", "weights", "mask_weights", "ray_mask")),
                    group=group)
    return got.memm, got.counter


def checks(group, dirname: str) -> None:
    """The sharded paths at this world size, each beside what this rank
    computes of the unsharded one."""
    torch.set_num_threads(1)
    directory = Path(dirname)
    inp = torch.load(directory / "inputs.pt", weights_only=False)
    out = {"rank": group.rank, "world": group.world}
    out["grads"], out["params"], out["metrics"] = train_steps(
        port_cfg(NERF), inp["nerf"], [inp["batch"]], group)
    out["grads_local"] = train_steps(port_cfg(NERF), inp["nerf"], [inp["batch"]], None)[0]
    out["accum_grads"], out["accum_params"], _ = train_steps(
        port_cfg(ACCUM), inp["nerf"], inp["accum_batches"], group)
    out["accum_local"] = train_steps(port_cfg(ACCUM), inp["nerf"], inp["accum_batches"],
                                     None)[:2]
    out["buff"] = buff_step(port_cfg(BUFF), inp["buff"], inp["batch"], group)
    out["buff_local"] = buff_step(port_cfg(BUFF), inp["buff"], inp["batch"], None)
    out["integrate"] = integrate_case(inp, group)
    out.update(renders(inp, group))
    torch.save(out, directory / f"checks_w{group.world}_r{group.rank}.pt")


def forced_world_one(dirname: str) -> None:
    """A forced one-rank group against no group at all: grads, memm and
    the renders, which must agree bit for bit."""
    from nerfmeshes_tpu_torch.mesh.extract import extract_density
    from nerfmeshes_tpu_torch.parallel.mesh import forced

    torch.set_num_threads(1)
    directory = Path(dirname)
    inp = torch.load(directory / "inputs.pt", weights_only=False)
    group = forced("cpu")
    out = {}
    for tag, g in (("forced", group), ("unforced", None)):
        grads, params, _ = train_steps(port_cfg(NERF), inp["nerf"], [inp["batch"]], g)
        bgrads, memm, counter, _ = buff_step(port_cfg(BUFF), inp["buff"], inp["batch"], g)
        nerf, buff = _systems(inp, g if g is not None else _one_rank())
        o, d = inp["render_rays"]
        bo, bd = inp["buff_rays"]
        out[tag] = {"grads": grads, "params": params, "buff_grads": bgrads, "memm": memm,
                    "counter": counter,
                    "rgb": nerf.query_rgb(o, d, NEAR, FAR, chunk=RENDER_CHUNK),
                    "buff_rgb": buff.query_rgb(bo, bd, NEAR, FAR, chunk=RENDER_CHUNK),
                    "grid": extract_density(nerf.sample_points, GRID_LIMIT, GRID_RES,
                                            tile=GRID_TILE, density_fn=nerf.density_points,
                                            device="cpu", group=g)}
    torch.save(out, directory / "forced_w1_r0.pt")


def restore_validate(group, dirname: str, run: str, step: str) -> None:
    """Validation of checkpoint `step` of the run at `run`, restored at this
    world size, at the step's own views (as fit validates before saving).
    The system gets no ExperimentPaths: nothing is written into the run."""
    from nerfmeshes_tpu_torch.config.paths import load_hparams
    from nerfmeshes_tpu_torch.train.checkpoint import CheckpointManager
    from nerfmeshes_tpu_torch.train.factory import build_system

    torch.set_num_threads(1)
    system = build_system(load_hparams(run), group=group).setup_eval()
    system.ckpt = CheckpointManager(Path(run) / "checkpoints")
    system.restore(step=int(step))
    loss = system.validate(log_images=False, step=int(step))["validation/loss"]
    torch.save({"loss": loss, "step": system.state.step},
               Path(dirname) / f"restore_w{group.world}_r{group.rank}.pt")


def buff_fit(group, dirname: str) -> None:
    """tests/test_parallel_render.py::test_buff_fit_multidevice_e2e on the
    port's ranks: a BuFF fit through consolidations at 30, 50 and 70 and a
    binding chord cap, logging and checkpointing to DIR/buffrun; each rank
    saves its tree, parameters and cap."""
    from nerfmeshes_tpu_torch.buff.system import BuFFSystem
    from nerfmeshes_tpu_torch.config.paths import ExperimentPaths
    from nerfmeshes_tpu_torch.config.schema import load_config
    from nerfmeshes_tpu_torch.data.datasets import DatasetType, SyntheticDataset

    torch.set_num_threads(1)
    cfg = load_config(str(REPO / "configs" / "tiny.yml"))
    configure(cfg, {
        "experiment.train_iters": 80, "experiment.validate_every": 40,
        "experiment.print_every": 20, "experiment.steps_per_call": 10,
        "experiment.use_fused_kernel": False, "nerf.train.num_random_rays": 256,
        "nerf.train.num_coarse": 8, "nerf.validation.num_coarse": 8,
        "nerf.train.radiance_field_noise_std": 1.0, "models.coarse.num_layers": 2,
        "models.coarse.hidden_size": 16, "tree.subdivision_outer_count": 4,
        "tree.max_voxel_count": 256, "tree.step_size_integration_offset": 10,
        "tree.step_size_tree": 20, "tree.max_chords_per_ray": 4})
    paths = ExperimentPaths(Path(dirname) / "buffrun").create()
    system = BuFFSystem(cfg, paths, device="cpu", group=group)
    system.setup(SyntheticDataset(cfg, DatasetType.TRAIN, num_images=4, image_size=16,
                                  device="cpu"),
                 SyntheticDataset(cfg, DatasetType.VALIDATION, num_images=2, image_size=16,
                                  device="cpu"))
    v0 = int(system.tree_state.active.sum())
    system.fit()
    leaves = [(leaf.lo.tolist(), leaf.hi.tolist(), leaf.depth) for leaf in system.tree.leaves]
    torch.save({"v0": v0, "leaves": leaves, "memm": system.tree_state.memm,
                "active": system.tree_state.active, "voxels": system.tree_state.voxels,
                "consolidations": system.consolidation_steps, "step": system.state.step,
                "cap": system._effective_max_chords(),
                "params": _named_params([("coarse", system.coarse)])},
               Path(dirname) / f"buff_fit_w{group.world}_r{group.rank}.pt")


def _one_rank():
    from nerfmeshes_tpu_torch.parallel.mesh import single

    return single("cpu")


TASKS = {"checks": checks, "restore_validate": restore_validate, "buff_fit": buff_fit}


def main(argv) -> None:
    """TASK DIR WORLD [ARGS...]: WORLD 1 runs TASK in this process."""
    task, dirname, world, extra = argv[0], argv[1], int(argv[2]), argv[3:]
    if task == "forced":
        forced_world_one(dirname)
    elif world == 1:
        TASKS[task](_one_rank(), dirname, *extra)
    else:
        from nerfmeshes_tpu_torch.parallel.mesh import launch

        launch(TASKS[task], world, "cpu", args=(dirname, *extra))


if __name__ == "__main__":
    main(sys.argv[1:])
