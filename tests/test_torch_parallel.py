"""The port's data parallelism (nerfmeshes_tpu_torch/parallel/mesh.py)
against the JAX package's shard_map programs, on the CPU.

The JAX side runs here on the 8 virtual CPU devices of tests/conftest.py.
The port side runs in subprocess groups of 2 and 4 gloo ranks
(tests/torch_parallel_worker.py, which imports no jax), each under its
own timeout, fed the same injected inputs through a .pt file: weights
start in JAX and are carried across with state_dict_from_flax, rays and
targets are made with numpy from a seed. Settings are deterministic
(perturb off, sigma noise 0), f32, the nn.Module path.

Tolerances:
- grads: each within 1e-5 of its max |grad| against jax.grad of the
  whole batch and against JAX's 8-device pmean (the worst is printed);
  the ranks' parameters after the step are bitwise equal.
- integrate: rtol 1e-5, atol 1e-6 (tests/test_parallel.py); counter equal.
- renders and query_rgb: rtol 1e-5, atol 1e-6 against JAX
  (tests/test_parallel_render.py:37-99); bitwise across world sizes.
- grids: one f16 step (rtol 1e-3) against JAX; bitwise across world
  sizes.
"""

import importlib.util
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from nerfmeshes_tpu.buff import system as j_buff
from nerfmeshes_tpu.buff import tree as j_tree
from nerfmeshes_tpu.config import get_default_cfg
from nerfmeshes_tpu.mesh import extract as j_extract
from nerfmeshes_tpu.ops.math import img2mse as j_img2mse
from nerfmeshes_tpu.parallel.mesh import DATA_AXIS, create_mesh
from nerfmeshes_tpu.train import optim as j_optim
from nerfmeshes_tpu.train import render as j_render
from nerfmeshes_tpu.train import step as j_step
from nerfmeshes_tpu.train import system as j_system
from nerfmeshes_tpu_torch.models.transplant import state_dict_from_flax
from nerfmeshes_tpu_torch.parallel import mesh as t_mesh
from nerfmeshes_tpu_torch.train import step as t_step

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("torch_parallel_worker",
                                               TESTS / "torch_parallel_worker.py")
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)

WORLDS = (2, 4)
GROUP_TIMEOUT = 120  # seconds for one subprocess group
GRAD_BAR = 1e-5  # of max |grad|, the port sharded against the port whole
# Against JAX, tests/test_torch_train.py's bar: the fine samples move
# continuously with the coarse weights, summed in other orders.
JAX_GRAD_BAR = 1e-4


def run_groups(directory: Path, jobs) -> None:
    """Start every (task, world) group at once, each under GROUP_TIMEOUT."""
    procs = [(job, subprocess.Popen(
        [sys.executable, str(TESTS / "torch_parallel_worker.py"), job[0], str(directory),
         str(job[1])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for job in jobs]
    failures = []
    for job, proc in procs:
        try:
            text, _ = proc.communicate(timeout=GROUP_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            failures.append(f"{job} timed out after {GROUP_TIMEOUT} s\n{text[-4000:]}")
            continue
        if proc.returncode != 0:
            failures.append(f"{job} exited {proc.returncode}\n{text[-4000:]}")
    assert not failures, "\n".join(failures)


def jax_cfg(settings):
    return W.configure(get_default_cfg(), settings)


def to_torch(params, node) -> dict:
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), dict(node))
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def scene_batch(R, seed):
    """Rays from the camera sphere at the centre, and random targets."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((R, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-1.5, 1.5, (R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.0, 1.0, (R, 3))
    return tuple(a.astype(np.float32) for a in (o, d, t))


class Jax:
    """The JAX systems whose weights the port takes, and their inputs."""

    def __init__(self):
        self.mesh = create_mesh()
        self.cfg = jax_cfg(W.NERF)
        self.sys = j_system.NeRFSystem(self.cfg, mesh=self.mesh).setup_eval()
        self.params = self.sys.state.params
        self.buff_cfg = jax_cfg(W.BUFF)
        self.buff = j_buff.BuFFSystem(self.buff_cfg, mesh=self.mesh).setup_eval()
        active = np.arange(self.buff.tree_state.active.shape[0]) % 2 == 0
        self.buff.tree_state = self.buff.tree_state._replace(
            active=jnp.asarray(active) & self.buff.tree_state.active)
        self.batch = scene_batch(64, seed=0)
        self.accum_batches = [scene_batch(64, seed=10 + i) for i in range(4)]
        self.render_rays = scene_batch(96, seed=1)[:2]
        self.buff_rays = scene_batch(64, seed=2)[:2]
        rng = np.random.default_rng(3)
        V, R, S = 16, 64, 5
        self.integrate = {
            "memm": rng.uniform(0, 1, (V,)).astype(np.float32), "counter": 4,
            "voxel_idx": rng.integers(0, V, (R, S)).astype(np.int64),
            "weights": rng.uniform(0, 1, (R, S)).astype(np.float32),
            "mask_weights": (rng.uniform(0, 1, (R, S)) > 0.3).astype(np.float32),
            "ray_mask": rng.uniform(0, 1, (R,)) > 0.2,
        }

    def inputs(self) -> dict:
        nerf = {name: to_torch(self.params[name], self.cfg.models[name])
                for name in ("coarse", "fine")}
        buff = {"coarse": to_torch(self.buff.state.params["coarse"],
                                   self.buff_cfg.models.coarse)}
        return {"nerf": nerf, "buff": buff, "batch": self.batch,
                "accum_batches": self.accum_batches, "render_rays": self.render_rays,
                "buff_rays": self.buff_rays, "integrate": self.integrate}

    def loss_fn(self, params, o, d, t):
        settings = j_render.RenderSettings.from_cfg(self.cfg, train=True)
        c, f = j_render.render_rays(self.sys.coarse, self.sys.fine, params, o, d, W.NEAR,
                                    W.FAR, settings, train=True)
        return j_img2mse(c.rgb_map, t) + j_img2mse(f.rgb_map, t)

    def named(self, grads) -> dict:
        out = {}
        for name in ("coarse", "fine"):
            out.update({f"{name}.{k}": v.numpy()
                        for k, v in to_torch(grads[name], self.cfg.models[name]).items()})
        return out

    def grads(self, params, batch) -> dict:
        """jax.grad of the loss on the whole batch, on one device."""
        return self.named(jax.grad(self.loss_fn)(params, *map(jnp.asarray, batch)))

    def sharded_grads(self, params, batch) -> dict:
        """JAX's sharded step body on the batch: per-device grads, pmean."""
        def body(p, o, d, t):
            return jax.lax.pmean(jax.grad(self.loss_fn)(p, o, d, t), DATA_AXIS)

        fn = shard_map(body, mesh=self.mesh, in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS),
                                                       P(DATA_AXIS)),
                       out_specs=P(), check_vma=False)
        return self.named(jax.jit(fn)(params, *map(jnp.asarray, batch)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side, and the port's groups at 2 and 4 ranks and on a forced
    one-rank group, run once for the module."""
    directory = tmp_path_factory.mktemp("parallel")
    jx = Jax()
    torch.save(jx.inputs(), directory / "inputs.pt")
    run_groups(directory, [("checks", w) for w in WORLDS] + [("forced", 1)])

    def load(name):
        return torch.load(directory / name, weights_only=False)

    ranks = {w: [load(f"checks_w{w}_r{r}.pt") for r in range(w)] for w in WORLDS}
    return jx, ranks, load("forced_w1_r0.pt")


def worst(got: dict, want: dict) -> float:
    """Worst |got - want| / max |want| over the named grads."""
    assert got.keys() == want.keys()
    return max(float(np.abs(np.asarray(got[k]) - want[k]).max() / np.abs(want[k]).max())
               for k in want)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grads_match_jax(runs, world):
    jx, ranks, _ = runs
    whole = jx.grads(jx.params, jx.batch)
    sharded = jx.sharded_grads(jx.params, jx.batch)
    got = ranks[world][0]["grads"][0]
    err_whole, err_sharded = worst(got, whole), worst(got, sharded)
    err_local = worst(got, {k: v.numpy() for k, v in ranks[world][0]["grads_local"][0].items()})
    jax_spread = worst(sharded, whole)
    print(f"world {world}: worst grad error {err_whole:.3e} vs jax.grad, {err_sharded:.3e} "
          f"vs JAX's 8-device pmean ({jax_spread:.3e} between JAX's two), {err_local:.3e} "
          "vs the port on the whole batch")
    assert max(err_whole, err_sharded) < JAX_GRAD_BAR
    assert err_local < GRAD_BAR
    # Every rank holds the same reduced grads, parameters and metrics.
    for other in ranks[world][1:]:
        for key in ("grads", "params", "metrics", "accum_params"):
            a, b = ranks[world][0][key], other[key]
            a, b = (a[0], b[0]) if key == "grads" else (a, b)
            for name in a:
                assert torch.equal(torch.as_tensor(a[name]), torch.as_tensor(b[name])), (key,
                                                                                         name)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_accumulation_matches_jax(runs, world):
    """Four micro-batches under accumulate_steps 2 and SGD. Every micro-
    step's reduced grads against the port's on the whole batch; the
    parameters after two updates against JAX's optimizer (optax.MultiSteps
    around sgd, nerfmeshes_tpu/train/optim.py) fed those grads: the
    average sits before the accumulation, as JAX's pmean does."""
    jx, ranks, _ = runs
    got = ranks[world][0]
    local_grads, local_params = got["accum_local"]
    assert len(got["accum_grads"]) == len(local_grads) == 4
    errs = [worst(g, {k: v.numpy() for k, v in lg.items()})
            for g, lg in zip(got["accum_grads"], local_grads)]
    print(f"world {world}: worst micro-step grad error {max(errs):.3e} vs the port's whole "
          "batches")
    assert max(errs) < GRAD_BAR
    opt = j_optim.build_optimizer(jax_cfg(W.ACCUM))
    params = {k: jnp.asarray(v.numpy()) for k, v in jx.inputs()["nerf"]["coarse"].items()}
    params = {f"coarse.{k}": v for k, v in params.items()} | {
        f"fine.{k}": jnp.asarray(v.numpy()) for k, v in jx.inputs()["nerf"]["fine"].items()}
    opt_state = opt.init(params)
    for grads in got["accum_grads"]:
        updates, opt_state = opt.update({k: jnp.asarray(v.numpy()) for k, v in grads.items()},
                                        opt_state, params)
        params = optax.apply_updates(params, updates)
    for name, value in got["accum_params"].items():
        np.testing.assert_allclose(value.numpy(), np.asarray(params[name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(value.numpy(), local_params[name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_integrate_matches_jax(runs, world):
    """tests/test_parallel.py::test_integrate_psum_matches_global_batch's
    case, the port's ranks against JAX's 8-device psum."""
    jx, ranks, _ = runs
    c = jx.integrate
    state = j_tree.TreeState(voxels=jnp.zeros((16, 2, 3)), active=jnp.ones((16,), bool),
                             memm=jnp.asarray(c["memm"]),
                             counter=jnp.asarray(c["counter"], jnp.int32))
    args = tuple(jnp.asarray(c[k]) for k in ("voxel_idx", "weights", "mask_weights",
                                               "ray_mask"))
    sharded = shard_map(partial(j_tree.integrate, axis_name=DATA_AXIS), mesh=jx.mesh,
                        in_specs=(P(),) + (P(DATA_AXIS),) * 4, out_specs=P(), check_vma=False)
    want = jax.jit(sharded)(state, *args)
    for rank in ranks[world]:
        memm, counter = rank["integrate"]
        np.testing.assert_allclose(memm.numpy(), np.asarray(want.memm), rtol=1e-5, atol=1e-6)
        assert counter == int(want.counter)
        assert torch.equal(memm, ranks[world][0]["integrate"][0])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_buff_step_matches_one_process(runs, world):
    """The BuFF step (chords, field, grads, integrate) on the ranks' rows
    against the port on the whole batch: the reduced grads, memm and the
    counter; memm is the same on every rank, so is the consolidated tree."""
    _, ranks, _ = runs
    grads, memm, counter, dropped = ranks[world][0]["buff"]
    l_grads, l_memm, l_counter, l_dropped = ranks[world][0]["buff_local"]
    for g, lg in zip(grads, l_grads):
        assert worst(g, {k: v.numpy() for k, v in lg.items()}) < GRAD_BAR
    np.testing.assert_allclose(memm.numpy(), l_memm.numpy(), rtol=1e-5, atol=1e-6)
    assert counter == l_counter == 3 and dropped == l_dropped / world
    for other in ranks[world][1:]:
        assert torch.equal(other["buff"][1], memm)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_matches_jax(runs, world):
    jx, ranks, _ = runs
    o, d = jx.render_rays
    chunk = j_step.make_render_chunk(jx.cfg, jx.sys.coarse, jx.sys.fine, mesh=jx.mesh)
    c, f = j_step.render_image(chunk, jx.params, o, d, W.NEAR, W.FAR, chunk_size=W.RENDER_CHUNK)
    want_rgb = jx.sys.query_rgb(o, d, W.NEAR, W.FAR, chunk=W.RENDER_CHUNK)
    want_u8 = jx.sys.query_rgb(o, d, W.NEAR, W.FAR, chunk=W.RENDER_CHUNK, as_uint8=True)
    for rank in ranks[world]:
        for name, bundle in (("coarse", c), ("fine", f)):
            for key in ("rgb_map", "acc_map", "disp_map"):
                if f"{name}.{key}" in rank:
                    np.testing.assert_allclose(rank[f"{name}.{key}"], getattr(bundle, key),
                                               rtol=1e-5, atol=1e-6, err_msg=f"{name}.{key}")
            # An eval depth is zeroed where acc < 1: compared away from that edge.
            if f"{name}.depth_map" in rank:
                away = np.abs(np.asarray(bundle.acc_map) - 1.0) > 1e-5
                np.testing.assert_allclose(rank[f"{name}.depth_map"][away],
                                           np.asarray(bundle.depth_map)[away], rtol=1e-5,
                                           atol=1e-6)
        np.testing.assert_allclose(rank["query_rgb"], want_rgb, rtol=1e-5, atol=1e-6)
        assert np.abs(rank["query_rgb_u8"].astype(int) - want_u8.astype(int)).max() <= 1
        assert rank["rgb_only_weights_none"]
        for key in ("fine.rgb_map", "query_rgb", "query_rgb_u8", "buff_rgb"):
            np.testing.assert_array_equal(rank[key], ranks[WORLDS[0]][0][key])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_rejects_a_chunk_that_does_not_split(runs, world):
    _, ranks, _ = runs
    msg = ranks[world][0]["bad_chunk"]
    assert msg == f"chunk {W.RENDER_CHUNK + 1} must be divisible by the mesh size {world}"


def test_round_chunk_matches_jax():
    mesh = create_mesh()
    for chunk in (1024, 1025, 3, 100):
        assert t_mesh.round_chunk(chunk, 8) == j_step.round_chunk(chunk, mesh)
        assert t_mesh.round_chunk(chunk) == j_step.round_chunk(chunk, None)
    assert t_step.round_chunk is t_mesh.round_chunk


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grid_evals_match_jax(runs, world):
    """Dense grid (17^3, tiles that do not divide it) of the field, the
    sparse grid of the field at 32^3, and the sparse geometry of two blobs,
    against JAX's grids over its 8 devices."""
    jx, ranks, _ = runs
    sys_ = jx.sys
    dense = j_extract.extract_density(sys_.sample_points, W.GRID_LIMIT, W.GRID_RES,
                                      tile=W.GRID_TILE, density_fn=sys_.density_points,
                                      mesh=jx.mesh)
    sparse, _ = j_extract._sparse_density_extract(
        sys_.density_apply, W.GRID_LIMIT, W.SPARSE_RES, 0.0, tile=W.GRID_TILE,
        density_params=sys_.finest_params, mesh=jx.mesh, clamp_iso=False)

    def blobs_jax(pts):
        r1 = jnp.linalg.norm(pts - jnp.asarray(W.C1), axis=-1)
        r2 = jnp.linalg.norm(pts - jnp.asarray(W.C2), axis=-1)
        return 80.0 * jnp.maximum(0.45 - r1, 0.0) + 60.0 * jnp.maximum(0.35 - r2, 0.0)

    v_j, t_j, _, _ = j_extract.extract_geometry(
        None, j_extract.MeshArgs(res=W.SPARSE_RES, limit=W.GRID_LIMIT, iso_level=1.0,
                                 clamp_iso=False), density_fn=blobs_jax, mesh=jx.mesh)
    first = ranks[WORLDS[0]][0]
    for rank in ranks[world]:
        np.testing.assert_allclose(rank["dense_grid"], dense, rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(rank["dense_grid"], first["dense_grid"])
    main = ranks[world][0]
    np.testing.assert_allclose(main["sparse_grid"], sparse.to_dense(), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(main["sparse_grid"], first["sparse_grid"])
    v, t, _ = main["geometry"]
    np.testing.assert_array_equal(t, t_j)
    np.testing.assert_allclose(v, v_j, atol=1e-4)
    assert len(t) > 100
    for rank in ranks[world][1:]:  # rank 0 alone reduces and marches
        assert rank["sparse_grid"] is None and rank["geometry"] is None


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_buff_render_matches_jax(runs, world):
    """The BuFF render through a half-active tree (JAX: BuFFSystem over its
    8 devices), query_rays and query_rgb."""
    jx, ranks, _ = runs
    o, d = jx.buff_rays
    want = jx.buff.query_rays(o, d, W.NEAR, W.FAR, chunk=W.RENDER_CHUNK, fields=("rgb_map",))
    want_rgb = jx.buff.query_rgb(o, d, W.NEAR, W.FAR, chunk=W.RENDER_CHUNK)
    for rank in ranks[world]:
        np.testing.assert_allclose(rank["buff_rgb"], want.rgb_map, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rank["buff_query_rgb"], want_rgb, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("what", ["grads", "params", "buff_grads", "memm", "counter", "rgb",
                                  "buff_rgb", "grid"])
def test_forced_world_one_is_the_unforced_path_bit_for_bit(runs, what):
    """force=True on one rank runs the collectives on a one-rank gloo group;
    every number equals the unforced path's (JAX's force_shard)."""
    _, _, forced = runs
    a, b = forced["forced"][what], forced["unforced"][what]
    if isinstance(a, list):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert all(torch.equal(x[k], y[k]) for k in x)
    elif isinstance(a, dict):
        assert all(torch.equal(a[k], b[k]) for k in a)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("world", [3, 5])
def test_num_random_rays_must_split_over_the_ranks(world):
    from nerfmeshes_tpu_torch.buff.system import make_buff_train_step

    cfg = W.port_cfg(W.BUFF)  # 64 rays
    group = t_mesh.DataGroup(rank=0, world=world)
    msg = f"num_random_rays 64 must be divisible by the mesh size {world}"
    with pytest.raises(ValueError, match=msg):
        t_step.make_train_step(cfg, H=4, W=4, focal=1.0, group=group)
    with pytest.raises(ValueError, match=msg):
        make_buff_train_step(cfg, H=4, W=4, focal=1.0, group=group)
    # JAX's message, word for word.
    with pytest.raises(ValueError, match="num_random_rays 64 must be divisible by the mesh "
                                         "size 3"):
        jcfg = jax_cfg(W.NERF)
        mesh = create_mesh(jax.devices()[:3])
        c, f = j_system.create_models(jcfg)
        j_step.make_train_step(jcfg, c, f, j_optim.build_optimizer(jcfg), H=4, W=4, focal=1.0,
                               mesh=mesh)


def test_rank_streams_fold_the_rank_and_step_on_the_host():
    a = t_mesh.RankStream(42, 0, "cpu")
    b = t_mesh.RankStream(42, 1, "cpu")
    draw = [torch.rand(4, generator=s.at(step)) for s in (a, b) for step in (0, 1)]
    assert not torch.equal(draw[0], draw[2]) and not torch.equal(draw[0], draw[1])
    again = torch.rand(4, generator=t_mesh.RankStream(42, 0, "cpu").at(0))
    assert torch.equal(again, draw[0])
