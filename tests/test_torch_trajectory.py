"""Many-step training runs of the port held to the JAX package, on the CPU.

Each case trains the port from JAX's weights (carried across with
state_dict_from_flax) on ray batches of the procedural blobs scene, drawn
once with numpy from a seed, with the port's own step functions
(train/step.py:make_train_step, buff/system.py:make_buff_train_step and
BuFFSystem.on_step, each given the batch), its optimizer and, for BuFF,
its tree. At every step the JAX package runs beside it on the port's
current parameters, batch and tree: JAX's value_and_grad of its loss,
optax's update (its state carried along from the port's grads, through
JAX's own optimizer builder) and, for BuFF, its integration (its memm
carried along from its own render) and its consolidation rule. JAX's
BuFF render takes the port's samples: the two samplers are held apart
(hold_samplers), since where a sample target meets a chord end the order
of f32 sums places it, and on the tree's regular grid a quarter of the
rays have one there. Case d trains on data/hard_llff's forward-facing
views instead (configs/hard-llff.yml's NDC rays, sampled in the [0, 1]
frustum): there each stack loads the scene with its own LLFF loader and
ColmapDataset and makes its own rays of the same numpy-drawn pixels.
Settings are deterministic: perturb off, sigma noise 0.

JAX follows the port's parameters rather than its own: two free runs part
at the render's discontinuities. A ray's last sample has a 1e10 interval,
so when its raw sigma crosses 0 the ray puts all its weight there or none.
Free BuFF runs of 36 steps crossed one within rounding in 4 of 5 batch
seeds (the port's f32 run against its own float64 run, or JAX's against
both): a 2% loss step, a voxel's memm moved by 10%, parameters 1e-2 of
the update apart. Along one trajectory every step is held to rounding.

Tolerances come from floors measured along the run. The port's f32
evaluation is held against a reference evaluation of the port at the same
parameters; the floor is the largest difference of the two over the run
(the rounding of one evaluation has heavy tails: in case a the loss's
relative error against float64 has a median of 4e-8 and a largest of
7e-7, and where a sample sits at a discontinuity the two evaluations can
fall on its two sides), and at least 2^-23 (one f32 ulp):
- loss (relative), grads (norm of the difference over the norm of the
  reference's grads): the port in float64 (cases a, c; BuFF's chord
  sampler stays f32, its inputs being f32 data), the port's f32
  nn.Module (cases b and d, the bf16 fused path);
- the optimizer's update (norm of the difference over the norm of the
  update): the port's optimizer on float64 shadow parameters, fed the
  same grads (OptimizerTwins);
- memm (norm of the difference over the norm of the reference's): the
  float64 run's weights integrated into a float64 memm.
The bar is FACTOR = 4 floors, fixed before any comparison with JAX: JAX's
f32 evaluation stands about one floor from the reference as the port's
does, so the two stand at most two floors apart by the triangle
inequality; the second factor of 2 allows JAX's rounding to be up to
twice the port's (at step 0 of case a its grads sit 1.5x as far from the
float64 ones). The coarse and fine PSNR at the end, on held-out rays at
eval settings, are held within FACTOR x 10 / ln 10 x the larger of the
end's loss floor and the eval's own relative MSE difference from the
reference, in dB (a relative MSE difference r moves PSNR by 10 / ln 10 x
r dB). Case c holds the tree exactly: the consolidation steps, then the
voxel count, boxes and their order (ids) after it, the port's
consolidation of its memm against JAX's of its own.

Case a found the port's Adam leaving optax's. torch.optim.Adam takes its
bias corrections in float64 and optax in float32, where b2 = 0.999 rounds
up, which makes every early update about 6.5e-6 shorter: the port's
update missed optax's by 6.4e-6 of its norm (median over the run) against
a floor of 3.6e-7, and free runs' losses parted by 2e-5 in 30 steps while
the port's float64 run stayed within 4e-7. train/optim.py:OptaxAdam now
takes the corrections as optax does.
"""

import copy
import math
import types
from functools import partial
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerfmeshes_tpu.buff import system as j_buff
from nerfmeshes_tpu.buff import tree as j_tree
from nerfmeshes_tpu.config import get_default_cfg, load_config
from nerfmeshes_tpu.data import colmap_dataset as j_colmap
from nerfmeshes_tpu.data.datasets import DatasetType as JDatasetType
from nerfmeshes_tpu.ops.math import img2mse as j_img2mse
from nerfmeshes_tpu.ops import rays as j_rays
from nerfmeshes_tpu.train import optim as j_optim
from nerfmeshes_tpu.train import render as j_render
from nerfmeshes_tpu.train import system as j_system
from nerfmeshes_tpu_torch.buff import system as t_buff
from nerfmeshes_tpu_torch.buff import tree as t_tree
from nerfmeshes_tpu_torch.data.colmap_dataset import ColmapDataset
from nerfmeshes_tpu_torch.data.datasets import DatasetType
from nerfmeshes_tpu_torch.data.synthetic import make_synthetic_dataset
from nerfmeshes_tpu_torch.models.layers import TorchLinear
from nerfmeshes_tpu_torch.models.transplant import flax_paths, state_dict_from_flax
from nerfmeshes_tpu_torch.ops.kernels import chords as tc
from nerfmeshes_tpu_torch.ops.kernels import fused_mlp as fm
from nerfmeshes_tpu_torch.ops.rays import get_ray_bundle
from nerfmeshes_tpu_torch.train import optim as t_optim
from nerfmeshes_tpu_torch.train import render as t_render
from nerfmeshes_tpu_torch.train import step as t_step
from nerfmeshes_tpu_torch.train import system as t_system

torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL = dict(num_layers=4, hidden_size=128, skip_step=2, num_encoding_fn_xyz=4,
             num_encoding_fn_dir=2)
NEAR, FAR = 2.0, 6.0
LR = 5e-4
FACTOR = 4.0
ULP = 2.0 ** -23
DB = 10.0 / math.log(10.0)
EVAL_RAYS = 256
REPO = Path(__file__).resolve().parents[1]
Z_TOL = 1e-5 * FAR  # tests/test_torch_buff.py: the samplers' cumsums run in other orders


# -- data ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """The blobs scene's rays and targets, 8 views at 16^2 (train) and 2
    held-out views, flattened to (N, 3) numpy f32."""
    def rays(seed, views):
        bundle = make_synthetic_dataset(num_images=views, image_size=16, near=NEAR, far=FAR,
                                        seed=seed, scene="blobs", device=CPU)
        H, W, focal = (float(v) for v in bundle.hwf)
        o, d = get_ray_bundle(int(H), int(W), focal, torch.from_numpy(bundle.poses))
        o = o[:, None, None, :].expand(d.shape)
        return [a.reshape(-1, 3).numpy().astype(np.float32)
                for a in (o, d, torch.from_numpy(bundle.ray_targets))]

    train, held = rays(0, 8), rays(1, 2)
    pick = np.random.default_rng(11).integers(0, held[0].shape[0], EVAL_RAYS)
    return train, [a[pick] for a in held]


@pytest.fixture(scope="module")
def llff():
    """data/hard_llff under configs/hard-llff.yml (400^2 views, NDC, views 0,
    8 and 16 held out): 10 batches of 4 pixels (one train image a step, as
    the train step draws) and EVAL_RAYS pixels of the test views, drawn
    with numpy; each stack's rays, targets and bounds of those pixels from
    its own LLFF loader and ColmapDataset, its rays NDC by its own code
    (the port's rays_from_indices, JAX's _sample_ray_batch's steps on the
    drawn indices). Returns ((port batches, JAX batches), (port held-out,
    JAX held-out)) as numpy f32 triples."""
    cfg = load_config(str(REPO / "configs" / "hard-llff.yml"))
    cfg.dataset.basedir = str(REPO / "data" / "hard_llff")
    rng = np.random.default_rng(3)
    draws = {"train": [(rng.integers(21), rng.integers(0, 400 * 400, 4)) for _ in range(10)],
             "test": [(rng.integers(0, 3, EVAL_RAYS), rng.integers(0, 400 * 400, EVAL_RAYS))]}
    out = {}
    for split, picks in draws.items():
        port = ColmapDataset(cfg, DatasetType(split), device=CPU)
        jds = j_colmap.ColmapDataset(cfg, JDatasetType(split))
        H, W, focal = port.device_arrays()["hwf"]
        t_data = port.device_arrays()
        j_data = {k: jnp.asarray(v) for k, v in jds.device_arrays().items() if k != "hwf"}
        assert t_data["bounds"].tolist() == np.asarray(j_data["bounds"]).tolist() == [0, 1]
        intrinsics = j_rays.CameraIntrinsics.from_hwf(H, W, focal)
        port_rays, jax_rays = [], []
        for img, pix in picks:
            o, d, t, near, far, _ = t_step.rays_from_indices(
                t_data, torch.as_tensor(img), torch.as_tensor(pix), H=H, W=W, focal=focal,
                use_ndc=True)
            assert (float(near), float(far)) == (0.0, 1.0)
            port_rays.append(tuple(a.numpy() for a in (o, d, t)))
            # JAX's _sample_ray_batch (nerfmeshes_tpu/train/step.py:92-110) on
            # these indices.
            pose = j_data["poses"][jnp.asarray(img)]
            dirs = j_rays.pixel_directions(jnp.asarray(pix % W, jnp.float32),
                                           jnp.asarray(pix // W, jnp.float32), intrinsics)
            if pose.ndim == 3:
                d = jnp.einsum("rij,rj->ri", pose[:, :3, :3], dirs)
                o = pose[:, :3, 3]
            else:
                d = jnp.einsum("ij,rj->ri", pose[:3, :3], dirs)
                o = jnp.broadcast_to(pose[:3, 3], d.shape)
            o, d = j_rays.ndc_rays(H, W, focal, 1.0, o, d)
            t = j_data["targets"].reshape(-1, H * W, 3)[jnp.asarray(img), jnp.asarray(pix)]
            jax_rays.append(tuple(np.asarray(a, np.float32) for a in (o, d, t)))
        for g, w in zip(port_rays[-1], jax_rays[-1]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        out[split] = (port_rays, jax_rays)
    (train, j_train), ((held,), (j_held,)) = out["train"], out["test"]
    return (train, j_train), (held, j_held)


def batches(train, steps, R, seed):
    """`steps` batches of R pixels of the train views, drawn with numpy."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, train[0].shape[0], (steps, R))
    return [tuple(a[r] for a in train) for r in rows]


def as_rays(batch, dtype=torch.float32, near=NEAR, far=FAR):
    """A batch as the step functions take it: (origins, directions,
    targets, near, far, depth)."""
    return tuple(torch.from_numpy(a).to(dtype) for a in batch) + (near, far, None)


# -- configs and weights ---------------------------------------------------------------

def hier_cfg(dtype, fused, samples):
    cfg = get_default_cfg()
    for node in (cfg.models.coarse, cfg.models.fine):
        node.update(SMALL)
    for mode in (cfg.nerf.train, cfg.nerf.validation):
        mode.num_coarse = samples
        mode.num_fine = samples
        mode.perturb = False
        mode.radiance_field_noise_std = 0.0
    cfg.experiment.compute_dtype = dtype
    cfg.experiment.use_fused_kernel = fused
    cfg.experiment.steps_per_call = 1
    cfg.optimizer.lr = LR
    return cfg


def buff_cfg():
    """BuFF at SMALL width on a 4^3 grid whose cap of 200 voxels binds at
    the consolidation (so the order of the memm sort decides which voxels
    split); integration from step 8, a consolidation after step 24."""
    cfg = hier_cfg("float32", False, 16)
    cfg.experiment.model = "BuFFModel"
    cfg.models.use_fine = False
    cfg.tree.subdivision_outer_count = 4
    cfg.tree.max_voxel_count = 200
    cfg.tree.step_size_integration_offset = 8
    cfg.tree.step_size_tree = 16
    return cfg


def jax_weights(cfg, fine: bool):
    jc, jf = j_system.create_models(cfg)
    jf = jf if fine else None
    params = jax.jit(partial(j_system.init_params, cfg, jc, jf))(jax.random.key(0))
    return jc, jf, params


def load_jax(models: dict, cfg, params) -> None:
    for tag, model in models.items():
        model.load_state_dict(state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, params[tag]), dict(cfg.models[tag])))


def to_flax(model, values: dict) -> dict:
    """`values` (the port's names -> tensors of `model`'s shapes: its
    parameters or their grads) as the flax tree of JAX's model. The arrays
    are copies: JAX may alias host memory and read it after the call
    returns, when the port's optimizer has moved the parameters."""
    tree = {}
    for path, (key, transposed) in flax_paths(model).items():
        v = values[key].detach().float().numpy()
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = jnp.asarray(np.array(v.T if transposed else v))
    return {"params": tree}


def flax_params(models: dict) -> dict:
    return {t: to_flax(m, dict(m.named_parameters())) for t, m in models.items()}


def from_flax(tree, cfg, tags) -> dict:
    """A flax tree per tag -> {"tag.name": float64 array} in the port's names."""
    return {f"{tag}.{k}": np.asarray(v, np.float64)
            for tag in tags
            for k, v in state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree[tag]),
                                             dict(cfg.models[tag])).items()}


def named(models: dict, grads: bool = False) -> dict:
    return {f"{tag}.{k}": (p.grad if grads else p).detach().double().numpy().copy()
            for tag, m in models.items() for k, p in m.named_parameters()}


def norm_rel(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every name."""
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b)
    den = sum(float(np.sum(b[k] ** 2)) for k in b)
    return math.sqrt(num / den)


def f64_twin(model):
    """A float64 copy of `model` whose linear layers compute in float64."""
    twin = copy.deepcopy(model).double()
    for m in twin.modules():
        if isinstance(m, TorchLinear):
            m.forward = types.MethodType(lambda self, x: F.linear(x, self.weight, self.bias), m)
    return twin


def sync(twins: dict, models: dict) -> None:
    with torch.no_grad():
        for tag, twin in twins.items():
            for a, b in zip(twin.parameters(), models[tag].parameters()):
                a.copy_(b)


def grads_of(models: dict, loss) -> dict:
    for m in models.values():
        m.zero_grad(set_to_none=True)
    loss.backward()
    return named(models, grads=True)


def capture_grads(optimizer, models: dict) -> dict:
    """The grads each optimizer step takes, by name (seen["grads"])."""
    seen = {}
    rule_step = optimizer.step

    def step():
        seen["grads"] = named(models, grads=True)
        rule_step()

    optimizer.step = step
    return seen


class Held:
    """One quantity held to JAX: each step's difference of the port from
    JAX at most FACTOR x the floor, the largest difference of the port
    from its reference over the run (at least ULP)."""

    def __init__(self, label):
        self.label, self.rows = label, []

    def add(self, step, port_vs_ref, port_vs_jax):
        self.rows.append((step, port_vs_ref, port_vs_jax))

    @property
    def floor(self) -> float:
        return max([ULP] + [r for _, r, _ in self.rows])

    @property
    def worst(self) -> float:
        return max(j for _, _, j in self.rows) / self.floor

    def close(self):
        for step, _, port_vs_jax in self.rows:
            assert port_vs_jax <= FACTOR * self.floor, (
                f"{self.label} at step {step}: {port_vs_jax:.3e} from JAX, past {FACTOR} x "
                f"the floor {self.floor:.3e}")


class OptimizerTwins:
    """Each step's update of the port's optimizer held to optax's. The
    port's rule runs on two shadow copies of the parameters, one f32 and
    one float64, fed the port's grads (so the f32 shadow's state is the
    port's, bit for bit); each shadow starts every step from zeros, so its
    parameters after the step are the update itself, unrounded by the
    parameters' own magnitude. optax (JAX's builder) takes the same grads
    at zero parameters. The f32 shadow's update is held to optax's at the
    floor of the float64 shadow's, and the port's parameters to their
    value before the step plus the f32 shadow's update."""

    def __init__(self, cfg, models: dict):
        self.cfg, self.models = cfg, models
        optimizer = j_optim.build_optimizer(cfg)
        self.update = jax.jit(optimizer.update)
        self.zeros = {t: to_flax(m, {k: torch.zeros_like(p) for k, p in m.named_parameters()})
                      for t, m in models.items()}
        self.state = optimizer.init(self.zeros)
        self.shadows = {}
        for dtype in (torch.float32, torch.float64):
            params = {f"{t}.{k}": torch.nn.Parameter(torch.zeros_like(p, dtype=dtype))
                      for t, m in models.items() for k, p in m.named_parameters()}
            self.shadows[dtype] = (params, t_optim.build_optimizer(list(params.values()), cfg))
        self.held = Held("update")

    def _step(self, dtype, grads: dict) -> dict:
        params, optimizer = self.shadows[dtype]
        with torch.no_grad():
            for k, p in params.items():
                p.zero_()
                p.grad = torch.from_numpy(grads[k]).to(dtype)
        optimizer.step()
        return {k: p.detach().double().numpy().copy() for k, p in params.items()}

    def check(self, step, before: dict, grads: dict, after: dict):
        flax = {t: to_flax(m, {k: torch.from_numpy(grads[f"{t}.{k}"])
                               for k, _ in m.named_parameters()})
                for t, m in self.models.items()}
        u, self.state = self.update(flax, self.state, self.zeros)
        want = from_flax(u, self.cfg, list(self.models))
        got, ref = self._step(torch.float32, grads), self._step(torch.float64, grads)
        self.held.add(step, norm_rel(got, ref), norm_rel(got, want))
        for k in got:
            applied = (before[k].astype(np.float32) + got[k].astype(np.float32)).astype(np.float64)
            # One rounding of the largest term: the sum may be fused.
            scale = np.maximum(np.maximum(np.abs(before[k]), np.abs(got[k])), np.abs(after[k]))
            ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
            assert (np.abs(after[k] - applied) <= ulp).all(), f"{k}: step {step} not the update"


def psnr(mse: float) -> float:
    return -10.0 * math.log10(mse)


def mse_of(rgb, target) -> float:
    return float(np.mean((np.asarray(rgb, np.float64) - target) ** 2))


def hold_psnr(label, got: dict, ref: dict, want: dict, loss_floor: float):
    """End PSNRs (MSEs by model) of the port, its reference and JAX."""
    for name in got:
        floor_db = DB * max(loss_floor, abs(got[name] - ref[name]) / ref[name])
        diff = abs(psnr(got[name]) - psnr(want[name]))
        assert diff <= FACTOR * floor_db, (
            f"{label} {name}: PSNR {psnr(got[name])} vs JAX {psnr(want[name])}, past "
            f"{FACTOR} x {floor_db:.3e} dB")


def report(case, losses, helds, mses):
    got, want = mses
    print(f"{case}: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          + "; ".join(f"{h.label} floor {h.floor:.2e}, worst {h.worst:.2f} floors"
                      for h in helds)
          + "; PSNR " + ", ".join(f"{k} {psnr(got[k]):.4f} / JAX {psnr(want[k]):.4f}"
                                  for k in got))


# -- hierarchical ------------------------------------------------------------------------

def jax_hier_fns(cfg, jc, jf, near=NEAR, far=FAR):
    settings = j_render.RenderSettings.from_cfg(cfg, train=True)
    eval_settings = j_render.RenderSettings.from_cfg(cfg, train=False)

    @jax.jit
    def loss_and_grads(p, o, d, t):
        def loss_fn(p):
            c, f = j_render.render_rays(jc, jf, p, o, d, near, far, settings, train=True)
            return j_img2mse(c.rgb_map, t) + j_img2mse(f.rgb_map, t)

        return jax.value_and_grad(loss_fn)(p)

    @jax.jit
    def render(p, o, d):
        c, f = j_render.render_rays(jc, jf, p, o, d, near, far, eval_settings, train=False)
        return c.rgb_map, f.rgb_map

    return loss_and_grads, render


def port_mses(cfg, models: dict, held, dtype=torch.float32, near=NEAR, far=FAR) -> dict:
    settings = t_render.RenderSettings.from_cfg(cfg, train=False)
    with torch.no_grad():
        c, f = t_render.render_rays(models["coarse"], models["fine"],
                                    *(torch.from_numpy(a).to(dtype) for a in held[:2]),
                                    near, far, settings, train=False)
    return {"coarse": mse_of(c.rgb_map.double(), held[2]),
            "fine": mse_of(f.rgb_map.double(), held[2])}


def run_hier(cfg, ref_cfg, data, held, near=NEAR, far=FAR, jax_data=None, jax_held=None):
    """Train the port `len(data)` steps, holding every step to JAX. The
    reference evaluation runs under `ref_cfg`: the port in float64 when it
    is `cfg`, else the port's models as `ref_cfg` builds them (f32). JAX
    takes `jax_data` and `jax_held` (its own rays of the same pixels)
    where they are given, else the port's."""
    jax_data = data if jax_data is None else jax_data
    jax_held = held if jax_held is None else jax_held
    jc, jf, params = jax_weights(cfg, fine=True)
    coarse, fine = t_system.create_models(cfg)
    models = {"coarse": coarse, "fine": fine}
    load_jax(models, cfg, params)
    opt = t_optim.build_optimizer([p for m in models.values() for p in m.parameters()], cfg)
    state = t_step.init_train_state(coarse, fine, opt, 0, CPU)
    step_fn = t_step.make_train_step(cfg, H=16, W=16, focal=1.0)
    seen = capture_grads(opt, models)
    if ref_cfg is cfg:
        twins, ref_dtype = {t: f64_twin(m) for t, m in models.items()}, torch.float64
    else:
        twins, ref_dtype = dict(zip(models, t_system.create_models(ref_cfg))), torch.float32
    loss_and_grads, render = jax_hier_fns(cfg, jc, jf, near, far)
    opt_twins = OptimizerTwins(cfg, models)
    loss_held, grad_held = Held("loss"), Held("grads")
    losses = []
    for s, (batch, j_batch) in enumerate(zip(data, jax_data)):
        before = named(models)
        sync(twins, models)
        ref_loss, _ = t_step.train_loss(ref_cfg, twins["coarse"], twins["fine"],
                                        *as_rays(batch, ref_dtype, near, far)[:5])
        ref_grads = grads_of(twins, ref_loss)
        j_loss, j_grads = loss_and_grads(flax_params(models), *j_batch)
        state, metrics = step_fn(state, None, as_rays(batch, near=near, far=far))
        loss, ref_loss = float(metrics["train/loss"]), float(ref_loss.detach())
        losses.append(loss)
        loss_held.add(s, abs(loss - ref_loss) / ref_loss, abs(loss - float(j_loss)) / ref_loss)
        grad_held.add(s, norm_rel(seen["grads"], ref_grads),
                        norm_rel(seen["grads"], from_flax(j_grads, cfg, models)))
        opt_twins.check(s, before, seen["grads"], named(models))
    assert state.step == len(data)
    for held_ in (loss_held, grad_held, opt_twins.held):
        held_.close()
    sync(twins, models)
    got = port_mses(cfg, models, held, near=near, far=far)
    ref = port_mses(ref_cfg, twins, held, ref_dtype, near, far)
    c_rgb, f_rgb = render(flax_params(models), jax_held[0], jax_held[1])
    want = {"coarse": mse_of(c_rgb, jax_held[2]), "fine": mse_of(f_rgb, jax_held[2])}
    hold_psnr("hierarchical", got, ref, want, loss_held.floor)
    return np.array(losses), (loss_held, grad_held, opt_twins.held), (got, want)


def test_hierarchical_f32_run_follows_jax(scene):
    """a. 2 x 4x128 fields, 16 + 16 samples, 64 rays, 100 Adam steps."""
    train, held = scene
    cfg = hier_cfg("float32", False, 16)
    losses, helds, mses = run_hier(cfg, cfg, batches(train, 100, 64, seed=1), held)
    report("a", losses, helds, mses)
    assert losses[-10:].mean() < 0.5 * losses[:10].mean()  # the run trains


def test_hierarchical_bf16_fused_run_follows_jax(scene):
    """b. The bf16 fused path: JAX's Pallas forward and backward in
    interpret mode, the port's plain versions of its kernels (no launch);
    4 rays, 8 + 8 samples, 10 steps. The floor: the port's f32 nn.Module."""
    train, held = scene
    before = (fm.launches, fm.bwd_launches)
    losses, helds, mses = run_hier(hier_cfg("bfloat16", True, 8), hier_cfg("float32", False, 8),
                                   batches(train, 10, 4, seed=2), held)
    assert (fm.launches, fm.bwd_launches) == before
    report("b", losses, helds, mses)


def test_forward_facing_bf16_fused_run_follows_jax(llff):
    """d. The forward-facing path as in b (the bf16 fused path, JAX's
    interpreted Pallas, the port's plain kernels), on data/hard_llff's NDC
    rays sampled in the [0, 1] frustum, each stack on its own rays of the
    same pixels; 4 rays, 8 + 8 samples, 10 steps."""
    (train, j_train), (held, j_held) = llff
    before = (fm.launches, fm.bwd_launches)
    losses, helds, mses = run_hier(hier_cfg("bfloat16", True, 8), hier_cfg("float32", False, 8),
                                   train, held, near=0.0, far=1.0, jax_data=j_train,
                                   jax_held=j_held)
    assert (fm.launches, fm.bwd_launches) == before
    report("d", losses, helds, mses)


# -- BuFF ----------------------------------------------------------------------------------------

def jax_consolidates(step: int, tree) -> bool:
    """JAX's BuFFSystem rule at one step a call (nerfmeshes_tpu/buff/
    system.py:506-513): after the step count reaches offset + k x
    step_size_tree."""
    offset, size = tree.integration_offset, tree.step_size_tree
    return step >= offset + size and (step - offset) % size < 1


def leaves_of(tree):
    return [(leaf.lo.tolist(), leaf.hi.tolist(), leaf.depth) for leaf in tree.leaves]


def f32_sampler(sample):
    """The chord sampler on f32 rays, its depths in the rays' dtype: the
    float64 reference samples where the f32 run samples."""
    def sampler(voxels, active, origins, dirs, near, far, **kw):
        out = sample(voxels, active, origins.float(), dirs.float(), near, far, **kw)
        return out._replace(z_vals=out.z_vals.to(dirs.dtype))

    return sampler


def jax_buff_fn(cfg, jc):
    """JAX's BuFF loss, grads and integration on the port's samples (its
    buff_render_rays with ray_voxel_intersect answering the port's
    z_vals, voxel_idx, ray_mask and dropped), and JAX's own sampler."""
    settings = j_render.RenderSettings.from_cfg(cfg, train=True)

    @partial(jax.jit, static_argnames="fold")
    def loss_and_grads(p, ts, o, d, t, samples, fold):
        def loss_fn(p):
            with mock.patch.object(j_buff, "ray_voxel_intersect", lambda *a, **k: samples):
                bundle, vox, rmask, _ = j_buff.buff_render_rays(
                    jc, p["coarse"], ts, o, d, NEAR, FAR, settings, train=True,
                    use_random_sampling=False)
            return j_img2mse(bundle.rgb_map, t), (bundle, vox, rmask)

        (loss, (bundle, vox, rmask)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        if fold:
            ts = j_tree.integrate(ts, vox, bundle.weights, bundle.mask_weights, rmask)
        return loss, g, ts

    sampler = jax.jit(partial(j_tree.ray_voxel_intersect, near=NEAR, far=FAR,
                              samples_count=settings.num_coarse))
    return loss_and_grads, sampler


def hold_samplers(step, port, jax_out, voxels, active, o, d) -> int:
    """The port's sampler against JAX's on one batch: ray_mask and dropped
    exact; z_vals within Z_TOL and voxel_idx exact on every ray whose
    sample targets lie clear of its chord ends. A target within 1e-5 of
    the ray's total chord length of a chord end is placed by the order of
    f32 sums (torch's cumsum and JAX's differ), and a bucket's first
    sample sits at its chord's entry, so there the two may differ by up
    to a chord (tests/test_torch_buff.py). Returns the rays at a chord end."""
    z_j, vox_j, mask_j, dropped_j = (np.asarray(a) for a in jax_out)
    np.testing.assert_array_equal(port.ray_mask.numpy(), mask_j, err_msg=f"step {step}")
    np.testing.assert_array_equal(port.dropped.numpy(), dropped_j, err_msg=f"step {step}")
    K = min(voxels.shape[0], t_tree.AUTO_CHORD_CAP)
    lo, hi, _, _ = tc.compact_chords_plain(voxels, active, o, d, NEAR, FAR, K=K)
    lo, order = torch.sort(lo, dim=-1, stable=True)
    hi = torch.gather(hi, -1, order)
    length = torch.where(lo >= tc.BIG, 0.0, (hi - lo).double())
    cums = torch.cumsum(length, -1)
    total = cums[:, -1:]
    S = z_j.shape[1]
    targets = torch.arange(S, dtype=torch.float64)[None, :] / (S - 1) * total
    # The ends shared by two chords: slot j's, where slot j + 1 holds a chord.
    ends = torch.where(lo[:, 1:] < tc.BIG, cums[:, :-1], torch.inf)
    gap = (targets[:, :, None] - ends[:, None, :]).abs().amin(dim=(1, 2))
    at_end = (gap <= 1e-5 * total[:, 0]).numpy() & port.ray_mask.numpy()
    clear = ~at_end
    np.testing.assert_allclose(port.z_vals.numpy()[clear], z_j[clear], rtol=0, atol=Z_TOL,
                               err_msg=f"step {step}")
    np.testing.assert_array_equal(port.voxel_idx.numpy()[clear & mask_j],
                                  vox_j.astype(np.int32)[clear & mask_j], err_msg=f"step {step}")
    return int(at_end.sum())


def test_buff_f32_run_follows_jax_through_a_consolidation(scene, monkeypatch):
    """c. BuFF f32: 36 steps, integration from step 8, one consolidation
    after step 24 (the cap binds), then the losses on to the end; no chord
    or field launch."""
    train, held = scene
    cfg = buff_cfg()
    jc, _, params = jax_weights(cfg, fine=False)
    system = t_buff.BuFFSystem(cfg, device=CPU)
    models = {"coarse": system.coarse}
    load_jax(models, cfg, params)
    step_fn = t_buff.make_buff_train_step(system.cfg, H=16, W=16, focal=1.0)
    seen = capture_grads(system.optimizer, models)
    twins = {"coarse": f64_twin(system.coarse)}
    loss_and_grads, jax_sampler = jax_buff_fn(cfg, jc)
    j_ctl = j_tree.TreeSampling(cfg)
    j_state = j_ctl.device_state()
    ref_tree = t_tree.TreeState(system.tree_state.voxels, system.tree_state.active,
                                torch.zeros_like(system.tree_state.memm, dtype=torch.float64))
    offset = j_ctl.integration_offset
    opt_twins = OptimizerTwins(cfg, models)
    loss_held, grad_held, memm_held = Held("loss"), Held("grads"), Held("memm")
    losses, port_trees, jax_trees = [], [], []
    launches = (fm.launches, fm.bwd_launches, tc.launches)
    settings = t_render.RenderSettings.from_cfg(system.cfg, train=True)
    at_chord_ends = 0
    for s, batch in enumerate(batches(train, 36, 64, seed=3)):
        before = named(models)
        sync(twins, models)
        with monkeypatch.context() as m:
            m.setattr(t_buff, "ray_voxel_intersect", f32_sampler(t_buff.ray_voxel_intersect))
            ref_loss, _, aux = t_buff.buff_train_loss(system.cfg, twins["coarse"],
                                                      system.tree_state,
                                                      *as_rays(batch, torch.float64)[:5])
        ref_grads = grads_of(twins, ref_loss)
        if s >= offset:
            ref_tree = t_tree.integrate(ref_tree, aux["voxel_idx"], aux["weights"],
                                        aux["mask_weights"], aux["ray_mask"])
        o, d = (torch.from_numpy(a) for a in batch[:2])
        port_samples = t_tree.ray_voxel_intersect(system.tree_state.voxels,
                                                  system.tree_state.active, o, d, NEAR, FAR,
                                                  samples_count=settings.num_coarse)
        at_chord_ends += hold_samplers(s, port_samples,
                                       jax_sampler(j_state.voxels, j_state.active, *batch[:2]),
                                       system.tree_state.voxels, system.tree_state.active, o, d)
        samples = tuple(jnp.asarray(np.array(a)) for a in port_samples)
        j_loss, j_grads, j_state = loss_and_grads(flax_params(models), j_state, *batch, samples,
                                                  fold=s >= offset)
        system.state, system.tree_state, metrics = step_fn(system.state, system.tree_state,
                                                           None, as_rays(batch))
        loss, ref_loss = float(metrics["train/loss"]), float(ref_loss.detach())
        losses.append(loss)
        loss_held.add(s, abs(loss - ref_loss) / ref_loss, abs(loss - float(j_loss)) / ref_loss)
        grad_held.add(s, norm_rel(seen["grads"], ref_grads),
                        norm_rel(seen["grads"], from_flax(j_grads, cfg, models)))
        opt_twins.check(s, before, seen["grads"], named(models))
        if s >= offset:
            got = {"memm": system.tree_state.memm.double().numpy()}
            memm_held.add(s, norm_rel(got, {"memm": ref_tree.memm.numpy()}),
                            norm_rel(got, {"memm": np.asarray(j_state.memm, np.float64)}))
        # The consolidations: the port's rule (BuFFSystem.on_step), JAX's.
        done = len(system.consolidation_steps)
        system.on_step(system.state.step, metrics)
        if len(system.consolidation_steps) > done:
            port_trees.append((system.state.step, leaves_of(system.tree)))
            ref_tree = t_tree.TreeState(system.tree_state.voxels, system.tree_state.active,
                                        system.tree_state.memm.double())
        if jax_consolidates(s + 1, j_ctl):
            j_state = j_ctl.consolidate(np.asarray(j_state.memm))
            jax_trees.append((s + 1, leaves_of(j_ctl)))
    assert (fm.launches, fm.bwd_launches, tc.launches) == launches
    for held_ in (loss_held, grad_held, opt_twins.held, memm_held):
        held_.close()
    # The tree: the same steps, count, boxes and ids.
    assert [s for s, _ in port_trees] == [s for s, _ in jax_trees] == [24]
    assert port_trees == jax_trees
    count = len(port_trees[0][1])
    assert 64 < count <= 200, count
    assert system.tree_state.counter == int(j_state.counter)

    sync(twins, models)
    settings = t_render.RenderSettings.from_cfg(system.cfg, train=False)
    with torch.no_grad(), monkeypatch.context() as m:
        got = t_buff.buff_render_rays(system.coarse, system.tree_state,
                                      *(torch.from_numpy(a) for a in held[:2]), NEAR, FAR,
                                      settings, train=False)[0].rgb_map
        m.setattr(t_buff, "ray_voxel_intersect", f32_sampler(t_buff.ray_voxel_intersect))
        ref = t_buff.buff_render_rays(twins["coarse"], system.tree_state,
                                      *(torch.from_numpy(a).double() for a in held[:2]),
                                      NEAR, FAR, settings, train=False)[0].rgb_map
    eval_settings = j_render.RenderSettings.from_cfg(cfg, train=False)
    o, d = (torch.from_numpy(a) for a in held[:2])
    port_samples = t_tree.ray_voxel_intersect(system.tree_state.voxels, system.tree_state.active,
                                              o, d, NEAR, FAR, samples_count=settings.num_coarse)
    at_chord_ends += hold_samplers("eval", port_samples,
                                   jax_sampler(j_state.voxels, j_state.active, *held[:2]),
                                   system.tree_state.voxels, system.tree_state.active, o, d)

    @jax.jit
    def jax_render(p, ts, o, d, samples):
        with mock.patch.object(j_buff, "ray_voxel_intersect", lambda *a, **k: samples):
            return j_buff.buff_render_rays(jc, p, ts, o, d, NEAR, FAR, eval_settings,
                                           train=False, use_random_sampling=False)[0].rgb_map

    want = jax_render(flax_params(models)["coarse"], j_state, held[0], held[1],
                      tuple(jnp.asarray(np.array(a)) for a in port_samples))
    mses = [{"coarse": mse_of(rgb, held[2])} for rgb in (got, ref, want)]
    hold_psnr("BuFF", *mses, loss_held.floor)
    report("c", np.array(losses), (loss_held, grad_held, opt_twins.held, memm_held),
           (mses[0], mses[2]))
    print(f"c: {count} voxels after step 24; {at_chord_ends} of {36 * 64 + EVAL_RAYS} rays "
          "with a sample target at a chord end")
    assert np.mean(losses[-6:]) < np.mean(losses[:6])  # the run trains
