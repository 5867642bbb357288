"""The port's CLIs (nerfmeshes_tpu_torch/cli/) end to end on
configs/tiny.yml with --device cpu, against the JAX package's CLIs.

- train -> resume -> eval -> mesh in-process, into tmp_path: the run
  directory's layout, metrics.jsonl's records with JAX's keys, checkpoints
  at the validation cadence;
- a run resumed with --log-checkpoint reaches the uninterrupted run's
  parameters, optimizer state and generator bit for bit;
- eval prints JAX's eval lines (per view and the dataset), number for
  number in format, and writes the files JAX's eval writes for each
  combination of --save-images and --save-disparity; mesh writes the mesh
  and the phases line;
- the flags the port refuses (--gpus 2, --synthesis-video) say why, and
  without --device the CLIs need the card.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfmeshes_tpu.cli import eval_nerf as j_eval
from nerfmeshes_tpu.cli import train_nerf as j_train
from nerfmeshes_tpu_torch.cli import eval_nerf, mesh_nerf, train_nerf

torch.set_num_threads(1)
TINY = str(Path(__file__).resolve().parents[1] / "configs" / "tiny.yml")


def _train(root, *extra):
    return train_nerf.main(["--config", TINY, "--device", "cpu", "--override",
                            "experiment.logdir", str(root), "experiment.train_iters", "20",
                            "experiment.validate_every", "10", *extra])


def _records(run):
    return [json.loads(line) for line in (run / "events" / "metrics.jsonl").open()]


def _template(text):
    """The output's lines with every number replaced by N."""
    return [re.sub(r"-?\d+(\.\d+)?", "N", line) for line in text.strip().splitlines()]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLIs' tiny run (10 steps) and its eval output."""
    root = tmp_path_factory.mktemp("jax")
    j_train.main(["--config", TINY, "--override", "experiment.logdir", str(root),
                  "experiment.train_iters", "10", "experiment.validate_every", "10"])
    return root / "tiny" / "default" / "version_0"


def test_train_resume_eval_mesh(tmp_path, jax_run, capsys):
    system = _train(tmp_path / "logs")
    run = tmp_path / "logs" / "tiny" / "default" / "version_0"
    assert system.paths.log_dir == run and system.state.step == 20
    assert (run / "hparams.yaml").exists()
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["10", "20", "last"]
    images = {p.name for p in (run / "events" / "images").iterdir()}
    assert "validation_rgb_coarse_0_20.png" in images
    records = _records(run)
    assert [r["step"] for r in records] == [10, 20, 20]  # val 10; train + val 20
    j_records = _records(jax_run)
    assert {tuple(r) for r in records} == {tuple(r) for r in j_records}

    resumed = train_nerf.main(["--log-checkpoint", str(run), "--device", "cpu",
                               "--override", "experiment.train_iters", "30"])
    assert "Resumed from step 20" in capsys.readouterr().out
    whole = _train(tmp_path / "whole", "experiment.train_iters", "30", "--use-profiler")
    assert (whole.paths.log_dir / "profile" / "trace.json").exists()
    assert resumed.state.step == whole.state.step == 30
    for a, b in zip(resumed.checkpoint_state().values(), whole.checkpoint_state().values()):
        a, b = torch.utils._pytree.tree_flatten(a)[0], torch.utils._pytree.tree_flatten(b)[0]
        assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(a, b))

    capsys.readouterr()
    result = eval_nerf.main(["--log-checkpoint", str(run), "--device", "cpu",
                             "--save-dir", str(tmp_path / "eval"), "--save-images",
                             "--save-disparity"])
    got = capsys.readouterr().out
    j_eval.main(["--log-checkpoint", str(jax_run)])
    want = capsys.readouterr().out
    assert _template(got) == _template(want) == [
        "[N] mse=N psnr=N ssim=N", "[N] mse=N psnr=N ssim=N", "dataset: mse=N psnr=N ssim=N"]
    assert f"psnr={result['psnr']:.2f}" in got
    saved = sorted(p.name for p in (tmp_path / "eval").iterdir())
    assert saved == [f"000{i}_{kind}.png" for i in range(2)
                     for kind in ("disparity", "rgb", "target")]

    vertices, triangles, _, _ = mesh_nerf.main(
        ["--log-checkpoint", str(run), "--device", "cpu", "--res", "32",
         "--save-dir", str(tmp_path / "mesh")])
    out = capsys.readouterr().out
    assert f"Extracted {len(vertices)} vertices" in out and "phases: " in out
    assert (tmp_path / "mesh" / "mesh.obj").exists()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's tiny run at JAX's settings (10 steps)."""
    root = tmp_path_factory.mktemp("port")
    train_nerf.main(["--config", TINY, "--device", "cpu", "--override", "experiment.logdir",
                     str(root), "experiment.train_iters", "10", "experiment.validate_every",
                     "10"])
    return root / "tiny" / "default" / "version_0"


@pytest.mark.parametrize("flags", [["--save-disparity"], ["--save-images"],
                                   ["--save-images", "--save-disparity"], []])
def test_eval_writes_the_files_jax_writes(tmp_path, jax_run, port_run, flags):
    """Disparity PNGs come only with the rgb ones: --save-disparity alone
    writes nothing, in both stacks."""
    j_eval.main(["--log-checkpoint", str(jax_run), "--save-dir", str(tmp_path / "jax"), *flags])
    eval_nerf.main(["--log-checkpoint", str(port_run), "--device", "cpu",
                    "--save-dir", str(tmp_path / "port"), *flags])
    got = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert got == sorted(p.name for p in (tmp_path / "jax").iterdir())
    if "--save-images" not in flags:
        assert got == []


def test_refused_flags_say_why(tmp_path, monkeypatch):
    # --gpus above 1 is no longer refused: on the host it asks for that
    # many gloo ranks (tests/test_torch_parallel_cli.py runs them).
    from nerfmeshes_tpu_torch.parallel import mesh as t_mesh

    spawned = []
    monkeypatch.setattr(t_mesh, "launch",
                        lambda fn, world, device, **kw: spawned.append((world, device)))
    assert train_nerf.main(["--config", TINY, "--gpus", "2", "--device", "cpu"]) is None
    assert spawned == [(2, "cpu")]
    with pytest.raises(SystemExit, match="GIF"):
        eval_nerf.main(["--log-checkpoint", str(tmp_path), "--synthesis-video", "a.gif"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_nerf.main(["--config", TINY, "--override", "experiment.logdir",
                         str(tmp_path / "logs")])


def test_train_writes_the_description_config_and_scalars_to_the_event_file(port_run):
    """As the JAX CLI does: the description and the config text before
    fit, then each metric of metrics.jsonl as a scalar at its step."""
    from nerfmeshes_tpu_torch.config.paths import load_hparams
    from nerfmeshes_tpu_torch.utils.tb_events import event_files, read_events

    files = event_files(port_run / "events")
    events = [e for f in files for e in read_events(f)[1:]]
    texts = {v["tag"]: v["tensor"]["string_val"][0].decode("utf-8")
             for e in events for v in e["summary"] if v["tag"].endswith("/text_summary")}
    cfg = load_hparams(port_run)
    assert texts == {"description/text_summary": cfg.experiment.description,
                     "config/text_summary": cfg.dump()}
    scalars = [(e["step"], v["tag"], v["simple_value"]) for e in events for v in e["summary"]
               if "simple_value" in v]
    want = [(r["step"], k, float(np.float32(v))) for r in _records(port_run)
            for k, v in r.items() if k not in ("step", "time")]
    assert scalars == want and len(want) > 5
    images = {v["tag"] for e in events for v in e["summary"] if "image" in v}
    assert images == {f"validation/{k}/0" for k in ("rgb_coarse", "disparity", "img_target")}
