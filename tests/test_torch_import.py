"""The port's reference-checkpoint importer
(nerfmeshes_tpu_torch/cli/import_checkpoint.py) against the JAX package's
(nerfmeshes_tpu/cli/import_checkpoint.py).

Lightning-layout checkpoints are fabricated from seeded numpy under the
reference's names (FlexibleNeRFModel's `layer1`, `layers_xyz.i`,
`fc_feat`, `fc_alpha`, `layers_dir.0`, `fc_rgb`, weights (out, in)): a tiny
NeRF (coarse + fine) and a tiny BuFF whose reference-layout tree mixes
depths 1-3, with hparams.yaml written by PyYAML nested or flat. Both
stacks import each; restored, the runs agree:

- the fields on the same points (1e-5, f32), the step, and the config
  after --override;
- the BuFF tree's serialization, exactly.

Each refusal raises SystemExit with JAX's message in both stacks.
"""

import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nerfmeshes_tpu.cli import import_checkpoint as j_ic
from nerfmeshes_tpu.config.cfgnode import flatten_dict as j_flatten
from nerfmeshes_tpu.config.paths import resolve_paths as j_resolve_paths
from nerfmeshes_tpu.train.factory import build_system as j_build_system
from nerfmeshes_tpu_torch.buff.tree import TreeSampling
from nerfmeshes_tpu_torch.cli import import_checkpoint as ic
from nerfmeshes_tpu_torch.config import load_config
from nerfmeshes_tpu_torch.config.cfgnode import flatten_dict
from nerfmeshes_tpu_torch.config.paths import resolve_paths
from nerfmeshes_tpu_torch.train.factory import build_system

torch.set_num_threads(1)
TINY = str(Path(__file__).resolve().parents[1] / "configs" / "tiny.yml")
BUFF = ["experiment.model", "BuFFModel", "tree.subdivision_outer_count", "4",
        "tree.max_voxel_count", "256"]


def reference_state_dict(model_cfg, prefix: str, seed: int) -> dict:
    """A FlexibleNeRFModel state dict under the reference's names and
    shapes (src/nerf/models.py:4-80), from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    H, L = int(model_cfg["hidden_size"]), int(model_cfg["num_layers"])
    skip = int(model_cfg["skip_step"])
    dim_xyz = 3 + 6 * int(model_cfg["num_encoding_fn_xyz"])
    dim_dir = 3 + 6 * int(model_cfg["num_encoding_fn_dir"])
    shapes = {"layer1": (H, dim_xyz)}
    for i in range(L - 1):
        is_skip = i % skip == 0 and i > 0 and i != L - 1
        shapes[f"layers_xyz.{i}"] = (H, H + (dim_xyz if is_skip else 0))
    shapes.update({"fc_feat": (H, H), "fc_alpha": (1, H), "layers_dir.0": (H // 2, H + dim_dir),
                   "fc_rgb": (3, H // 2)})
    sd = {}
    for name, (out, inp) in shapes.items():
        bound = 1.0 / np.sqrt(inp)
        sd[f"{prefix}{name}.weight"] = torch.from_numpy(
            rng.uniform(-bound, bound, (out, inp)).astype(np.float32))
        sd[f"{prefix}{name}.bias"] = torch.from_numpy(
            rng.uniform(-bound, bound, out).astype(np.float32))
    return sd


def reference_tree(cfg, seed: int) -> dict:
    """A reference-layout tree (src/nerf/tree.py:345-358): the initial 4^3
    grid with cell 5 split into its 8 children (depth 2) and one of those
    into 8 grandchildren (depth 3); seeded memm, counter 7, and the
    pickled `root` Node the reference stores beside them."""
    leaves = TreeSampling(cfg).leaves
    boxes = [np.stack([leaf.lo, leaf.hi]) for leaf in leaves]

    def split(box):
        half = (box[1] - box[0]) / 2.0
        return [np.stack([box[0] + half * np.array(c), box[0] + half * (np.array(c) + 1)])
                for c in np.ndindex(2, 2, 2)]

    children = split(boxes.pop(5))
    grand = split(children.pop(3))
    voxels = np.stack(boxes + children + grand).astype(np.float32)
    rng = np.random.default_rng(seed)
    node_module = sys.modules["nerf.tree"]
    return {"root": node_module.Node(), "voxels": torch.from_numpy(voxels),
            "memm": torch.from_numpy(rng.uniform(0, 1, len(voxels)).astype(np.float32)),
            "counter": 7}


class _ReferenceModules:
    """`nerf.tree.Node` importable while a checkpoint is pickled, gone
    afterwards, so the importers' own stand-ins unpickle it."""

    def __enter__(self):
        self.saved = {k: sys.modules.get(k) for k in ("nerf", "nerf.tree")}
        pkg, mod = types.ModuleType("nerf"), types.ModuleType("nerf.tree")
        node = type("Node", (), {"__module__": "nerf.tree"})
        mod.Node, pkg.tree = node, mod
        sys.modules.update({"nerf": pkg, "nerf.tree": mod})
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _write_hparams(path: Path, cfg, shape: str) -> None:
    data = cfg.to_dict()
    if shape == "flat":
        data = flatten_dict(data)
    path.write_text(yaml.safe_dump(data))


def _fabricate(root: Path, kind: str, shape: str):
    """<root>/run/{checkpoints/model_last.ckpt, hparams.yaml}; returns the
    ckpt path, the config it was written from and the state dict."""
    overrides = ["models.use_fine", "True"] if kind == "nerf" else list(BUFF)
    cfg = load_config(TINY, overrides)
    run = root / "run"
    (run / "checkpoints").mkdir(parents=True)
    if kind == "nerf":
        sd = reference_state_dict(cfg.models.coarse, "model_coarse.", 1)
        sd.update(reference_state_dict(cfg.models.fine, "model_fine.", 2))
        ckpt = {"state_dict": sd, "global_step": 123, "epoch": 4}
    else:
        sd = reference_state_dict(cfg.models.coarse, "model.", 3)
        with _ReferenceModules():
            ckpt = {"state_dict": sd, "global_step": 50, "epoch": 1,
                    "tree": reference_tree(cfg, 4)}
            torch.save(ckpt, run / "checkpoints" / "model_last.ckpt")
    if kind == "nerf":
        torch.save(ckpt, run / "checkpoints" / "model_last.ckpt")
    _write_hparams(run / "hparams.yaml", cfg, shape)
    return run / "checkpoints" / "model_last.ckpt", ckpt


def _import_both(root: Path, ckpt: Path, extra=()):
    """Each stack's import into its own logdir; the restored systems."""
    runs = {}
    for name, main in (("port", ic.main), ("jax", j_ic.main)):
        logdir = root / name
        argv = ["--ckpt", str(ckpt), "--override", "experiment.logdir", str(logdir), *extra]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        (run,) = (logdir / "tiny" / "imported").iterdir()
        runs[name] = run
    cfg, paths = resolve_paths(log_checkpoint=str(runs["port"]))
    port = build_system(cfg, paths, "cpu").restore(last=True)
    jcfg, jpaths = j_resolve_paths(log_checkpoint=str(runs["jax"]))
    jax_system = j_build_system(jcfg, jpaths)
    jax_system.restore(last=True)
    return port, jax_system


def _same_cfg(port, jax_system):
    a = flatten_dict(port.cfg.to_dict())
    b = j_flatten(jax_system.cfg.to_dict())
    a.pop("experiment.logdir")
    b.pop("experiment.logdir")
    assert a == b


def _fields_agree(port_model, jax_model, params, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((64, 3)).astype(np.float32)
    dirs = rng.standard_normal((64, 3)).astype(np.float32)
    with torch.no_grad():
        got = port_model(torch.from_numpy(pts), torch.from_numpy(dirs)).numpy()
    want = np.asarray(jax_model.apply(params, jnp.asarray(pts), jnp.asarray(dirs)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("shape", ["nested", "flat"])
def test_import_nerf_checkpoint_like_jax(tmp_path, shape):
    ckpt_path, ckpt = _fabricate(tmp_path, "nerf", shape)
    port, jax_system = _import_both(tmp_path, ckpt_path)
    assert port.state.step == int(jax_system.state.step) == 123
    _same_cfg(port, jax_system)
    assert port.fine is not None and bool(port.cfg.models.use_fine)
    _fields_agree(port.coarse, jax_system.coarse, jax_system.state.params["coarse"], 0)
    _fields_agree(port.fine, jax_system.fine, jax_system.state.params["fine"], 1)
    # The weights are the checkpoint's, bit for bit.
    sd = ckpt["state_dict"]
    for k, v in port.fine.state_dict().items():
        assert torch.equal(v, sd[f"model_fine.{k}"]), k


@pytest.mark.parametrize("shape", ["nested", "flat"])
def test_import_buff_checkpoint_with_a_mixed_depth_tree(tmp_path, shape):
    ckpt_path, ckpt = _fabricate(tmp_path, "buff", shape)
    port, jax_system = _import_both(tmp_path, ckpt_path)
    assert port.state.step == int(jax_system.state.step) == 50
    _same_cfg(port, jax_system)
    _fields_agree(port.coarse, jax_system.coarse, jax_system.state.params["coarse"], 2)
    got = port.tree.serialize(port.tree_state)
    want = jax_system.tree.serialize(jax_system.tree_state)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    V = int(got["num_leaves"])
    assert V == 64 - 1 + 8 - 1 + 8 and int(got["counter"]) == 7
    assert sorted(set(got["leaf_depth"][:V].tolist())) == [1, 2, 3]
    np.testing.assert_array_equal(got["memm"][:V], ckpt["tree"]["memm"].numpy())
    np.testing.assert_array_equal(
        np.stack([got["leaf_lo"][:V], got["leaf_hi"][:V]], 1), ckpt["tree"]["voxels"].numpy())


def test_overrides_reach_the_imported_run(tmp_path):
    ckpt_path, _ = _fabricate(tmp_path, "nerf", "flat")
    port, jax_system = _import_both(tmp_path, ckpt_path, ["optimizer.lr", "0.0125",
                                                          "experiment.description", "moved"])
    _same_cfg(port, jax_system)
    assert port.cfg.optimizer.lr == 0.0125 and port.cfg.experiment.description == "moved"


def test_convert_reference_tree_equals_jax(tmp_path):
    cfg = load_config(TINY, BUFF)
    with _ReferenceModules():
        tree = reference_tree(cfg, 9)
    from nerfmeshes_tpu.buff.tree import TreeSampling as JTreeSampling
    from nerfmeshes_tpu.config import load_config as j_load_config

    got = ic.convert_reference_tree(tree, TreeSampling(cfg))
    want = j_ic.convert_reference_tree(tree, JTreeSampling(j_load_config(TINY, BUFF)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _refusal_cases(tmp_path):
    """(argv, message) of each refusal, and what to fabricate first."""
    return {
        "missing_ckpt": (["--ckpt", str(tmp_path / "none.ckpt")], "does not exist", None),
        "missing_config": (["--ckpt", "{ckpt}", "--config", str(tmp_path / "none.yaml")],
                           "no config found", "nerf"),
        "wrong_shape": (["--ckpt", "{ckpt}", "--override", "models.coarse.hidden_size", "64"],
                        "has shape", "nerf"),
        "missing_key": (["--ckpt", "{ckpt}", "--override", "models.coarse.num_layers", "4"],
                        "is missing 'model_coarse.layers_xyz.2.weight'", "nerf"),
        "fine_without_use_fine": (["--ckpt", "{ckpt}", "--override", "models.use_fine",
                                   "False"], "has a fine network", "nerf"),
        "not_flexible": (["--ckpt", "{ckpt}", "--override", "models.coarse_type",
                          "SimpleModel"], "does not match the FlexibleNeRFModel layout", "nerf"),
        "tree_over_capacity": (["--ckpt", "{ckpt}", "--override", "tree.max_voxel_count", "32",
                                "tree.subdivision_outer_count", "2"],
                               "reference tree has 78 voxels", "buff"),
    }


@pytest.mark.parametrize("case", ["missing_ckpt", "missing_config", "wrong_shape", "missing_key",
                                  "fine_without_use_fine", "not_flexible",
                                  "tree_over_capacity"])
def test_refusals_raise_systemexit_with_jaxs_message(tmp_path, case):
    argv, message, kind = _refusal_cases(tmp_path)[case]
    ckpt = _fabricate(tmp_path, kind, "flat")[0] if kind else None
    argv = [a.replace("{ckpt}", str(ckpt)) for a in argv]
    for name, main in (("port", ic.main), ("jax", j_ic.main)):
        logdir = ["experiment.logdir", str(tmp_path / name)]
        full = argv + (logdir if "--override" in argv else ["--override", *logdir])
        with pytest.raises(SystemExit, match=message):
            main(full + (["--device", "cpu"] if name == "port" else []))
