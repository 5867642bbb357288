"""The port's CLIs and systems over gloo ranks on the host, end to end
(the port alone; JAX's counterparts are tests/test_parallel_render.py:
168-300).

- `train_nerf --device cpu --gpus 2` fits, validates and checkpoints as
  one run: rank 0 alone writes metrics, events and checkpoints.
- A same-world-size resume continues the trajectory bit for bit; a
  checkpoint written at 2 ranks restores at 1 and one written at 1
  restores at 2, validation reproduced exactly.
- A BuFF fit at 2 ranks through three consolidations and a chord-cap
  growth keeps equal trees and parameters on both ranks.
- eval_nerf, mesh_nerf and surface_ray under torch.distributed.run at 2
  ranks write the same files and print the same PSNR and counts as at 1.

Every subprocess (one group of ranks) runs under its own timeout.
"""

import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
TINY = str(REPO / "configs" / "tiny.yml")
GROUP_TIMEOUT = 120  # seconds for one subprocess group
RUN = "tiny/default/version_0"
# tiny.yml at 2 ranks: 256 rays split 128 + 128, validation and a
# checkpoint every 20 steps. Seed 3: tiny.yml's 42 starts dead in the port.
COMMON = ["--device", "cpu", "--override", "experiment.validate_every", "20",
          "experiment.print_every", "10", "experiment.randomseed", "3"]

_spec = importlib.util.spec_from_file_location("torch_parallel_worker",
                                               TESTS / "torch_parallel_worker.py")
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cli(name, *args, torchrun: int = 0) -> list:
    """The command of a port CLI, under torch.distributed.run with
    `torchrun` ranks when it is not 0."""
    module = f"nerfmeshes_tpu_torch.cli.{name}"
    if torchrun:
        return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                str(torchrun), "--master-port", str(_free_port()), "-m", module,
                *map(str, args)]
    return [sys.executable, "-m", module, *map(str, args)]


def worker(task, directory, world, *args) -> list:
    return [sys.executable, str(TESTS / "torch_parallel_worker.py"), task, str(directory),
            str(world), *map(str, args)]


def run_all(commands) -> list:
    """Run the commands at once from the repo root, each under
    GROUP_TIMEOUT; their stdouts, or the failures."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in commands]
    outs, failures = [], []
    for cmd, proc in zip(commands, procs):
        try:
            text, _ = proc.communicate(timeout=GROUP_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            failures.append(f"{cmd} timed out after {GROUP_TIMEOUT} s\n{text[-4000:]}")
        if proc.returncode != 0:
            failures.append(f"{cmd} exited {proc.returncode}\n{text[-4000:]}")
        outs.append(text)
    assert not failures, "\n".join(failures)
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A: 2 ranks straight to step 40. Run C: 2 ranks to 20, then
    resumed at 2 ranks to 40."""
    root = tmp_path_factory.mktemp("pcli")
    out_a, _ = run_all([
        cli("train_nerf", "--config", TINY, "--gpus", 2, *COMMON, "experiment.logdir",
            root / "a", "experiment.train_iters", 40),
        cli("train_nerf", "--config", TINY, "--gpus", 2, *COMMON, "experiment.logdir",
            root / "c", "experiment.train_iters", 20)])
    run_all([cli("train_nerf", "--log-checkpoint", root / "c" / RUN, "--gpus", 2,
                 "--device", "cpu", "--override", "experiment.train_iters", 40)])
    return root, root / "a" / RUN, root / "c" / RUN, out_a


def _val_loss(run: Path, step) -> float:
    return json.loads((run / "checkpoints" / str(step) / "metrics.json").read_text())[
        "val_loss"]


def test_two_rank_train_writes_one_run(runs):
    root, a, _, out = runs
    assert sorted(p.name for p in (root / "a" / "tiny" / "default").iterdir()) == ["version_0"]
    assert {"20", "40", "last"} <= {p.name for p in (a / "checkpoints").iterdir()}
    assert out.count("Training complete.") == 1
    lines = [json.loads(x) for x in (a / "events" / "metrics.jsonl").read_text().splitlines()]
    steps = [rec["step"] for rec in lines if "train/loss" in rec]
    assert steps == [10, 20, 30, 40]  # one record a print, from rank 0 alone
    assert len([p for p in (a / "events").iterdir() if "tfevents" in p.name]) == 1
    losses = [rec["train/loss"] for rec in lines if "train/loss" in rec]
    assert all(0.0 < x < 1.0 for x in losses)
    assert _val_loss(a, 20) > 0.0 and _val_loss(a, 40) > 0.0


def test_same_topology_resume_is_bit_for_bit(runs):
    """Run C stopped at 20 and resumed at 2 ranks; run A went straight
    through: their step-40 checkpoints hold the same bits."""
    _, a, c, _ = runs
    sa = torch.load(a / "checkpoints" / "40" / "state.pt", weights_only=True)
    sc = torch.load(c / "checkpoints" / "40" / "state.pt", weights_only=True)
    assert sa["step"] == sc["step"] == 40
    for name in ("coarse",):
        for k in sa[name]:
            assert torch.equal(sa[name][k], sc[name][k]), k
    assert torch.equal(sa["generator"], sc["generator"])
    for k, v in sa["optimizer"]["rule"]["state"].items():
        for field in v:
            assert torch.equal(torch.as_tensor(v[field]),
                               torch.as_tensor(sc["optimizer"]["rule"]["state"][k][field]))
    assert _val_loss(a, 40) == _val_loss(c, 40)


def test_topology_change_restores_exactly(runs, tmp_path):
    """2 -> 1 -> 2: run A's step-40 checkpoint (2 ranks) validates at 1
    rank to its recorded loss; a copy resumes at 1 rank to 60; that
    checkpoint validates at 2 ranks to its recorded loss."""
    _, a, _, _ = runs
    t = tmp_path / "t"
    shutil.copytree(a, t)
    run_all([worker("restore_validate", tmp_path, 1, t, 40),
             cli("train_nerf", "--log-checkpoint", t, "--gpus", 1, "--device", "cpu",
                 "--override", "experiment.train_iters", 60)])
    one = torch.load(tmp_path / "restore_w1_r0.pt")
    assert one["step"] == 40 and one["loss"] == _val_loss(a, 40)
    run_all([worker("restore_validate", tmp_path, 2, t, 60)])
    for rank in range(2):
        two = torch.load(tmp_path / f"restore_w2_r{rank}.pt")
        assert two["step"] == 60 and two["loss"] == _val_loss(t, 60)


def test_buff_fit_keeps_equal_trees_on_both_ranks(tmp_path):
    run_all([worker("buff_fit", tmp_path, 2)])
    r0, r1 = (torch.load(tmp_path / f"buff_fit_w2_r{r}.pt") for r in range(2))
    assert r0["step"] == 80 and r0["consolidations"] == [30, 50, 70]
    assert int(r0["active"].sum()) != r0["v0"]  # the tree was rebuilt
    assert r0["cap"] > 4  # the binding cap doubled
    assert r0["leaves"] == r1["leaves"] and r0["cap"] == r1["cap"]
    assert r0["consolidations"] == r1["consolidations"]
    for key in ("memm", "active", "voxels"):
        assert torch.equal(r0[key], r1[key]), key
    assert all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    run = tmp_path / "buffrun"
    assert f"tree.max_chords_per_ray: {r0['cap']}" in (run / "hparams.yaml").read_text()
    assert len([p for p in (run / "events").iterdir() if "tfevents" in p.name]) == 1
    assert {"40", "80", "last"} <= {p.name for p in (run / "checkpoints").iterdir()}


def test_eval_mesh_and_surface_ray_under_torchrun_match_one_rank(runs, tmp_path):
    _, a, _, _ = runs
    legs = {
        "eval_nerf": lambda d: ["--log-checkpoint", a, "--device", "cpu", "--save-dir", d,
                                "--save-images"],
        "mesh_nerf": lambda d: ["--log-checkpoint", a, "--device", "cpu", "--res", 32,
                                "--save-dir", d, "--mesh-name", "mesh.ply"],
        "surface_ray": lambda d: ["--log-checkpoint", a, "--device", "cpu", "--img-size", 16,
                                  "--focal", 0, "--poses-y", 2, "--poses-x", 1,
                                  "--save-path", Path(d) / "points.ply"],
    }
    commands = []
    for name, args in legs.items():
        commands.append(cli(name, *args(tmp_path / f"{name}_1")))
        commands.append(cli(name, *args(tmp_path / f"{name}_2"), torchrun=2))
    outs = run_all(commands)
    for i, name in enumerate(legs):
        one, two = (tmp_path / f"{name}_1", tmp_path / f"{name}_2")
        files = sorted(p.name for p in one.iterdir())
        assert files and files == sorted(p.name for p in two.iterdir()), name
        for f in files:
            assert (one / f).read_bytes() == (two / f).read_bytes(), (name, f)
        key = {"eval_nerf": "dataset:", "mesh_nerf": "Extracted", "surface_ray": "wrote"}[name]

        def said(text):
            return [line.split(" in ")[0].split(" -> ")[0] for line in text.splitlines()
                    if key in line]

        assert said(outs[2 * i]) and said(outs[2 * i]) == said(outs[2 * i + 1]), name
