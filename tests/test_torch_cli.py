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
- --synthesis-video writes JAX's 120 frames in JAX's order into a GIF
  that reads back as JAX's (count, size, 40 ms, loop 0), and a path that
  is not a GIF exits first, with JAX's message;
- --device cuda:N is one rank on card N, cuda spreads ranks over the cards
  (cuda:LOCAL_RANK under torchrun), and one card named beside --gpus 2 or
  under a torchrun world of 2 is refused, saying why (cards faked);
- without --device the CLIs need the card.
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


def test_synthesis_video_writes_jax_frames(tmp_path, jax_run, port_run, capsys):
    """--synthesis-video renders JAX's 120 orbit views, in JAX's order, into
    a looping 40 ms GIF that imageio reads as it reads JAX's, and prints
    JAX's line; with --save-images --save-dir the frames are the PNGs'."""
    import imageio.v2 as imageio

    from nerfmeshes_tpu_torch.data import gif as t_gif

    j_eval.main(["--log-checkpoint", str(jax_run), "--synthesis-video",
                 str(tmp_path / "jax" / "orbit.gif")])
    want_out = capsys.readouterr().out
    eval_nerf.main(["--log-checkpoint", str(port_run), "--device", "cpu", "--synthesis-video",
                    str(tmp_path / "port" / "orbit.gif"), "--save-images", "--save-dir",
                    str(tmp_path / "frames")])
    got_out = capsys.readouterr().out
    assert _template(got_out.replace("/port/", "/")) == _template(want_out.replace("/jax/", "/"))
    assert got_out.strip().splitlines()[-1] == \
        f"wrote 120-frame animation -> {tmp_path / 'port' / 'orbit.gif'}"
    got = t_gif.gif_summary((tmp_path / "port" / "orbit.gif").read_bytes())
    want = t_gif.gif_summary((tmp_path / "jax" / "orbit.gif").read_bytes())
    for key in ("width", "height", "delays", "loop", "trailer"):
        assert got[key] == want[key]
    assert len(got["frames"]) == len(want["frames"]) == 120 and got["delays"] == [4] * 120
    frames = np.stack([f[..., :3] for f in imageio.mimread(tmp_path / "port" / "orbit.gif",
                                                            memtest=False)])
    pngs = np.stack([imageio.imread(tmp_path / "frames" / f"{i:04d}_rgb.png")
                     for i in range(120)])
    assert frames.shape == pngs.shape
    # Frame i is view i: nearest to its own PNG (ties allowed: a 10-step
    # field renders nearly the same image from every side).
    err = np.abs(frames.astype(int)[:, None] - pngs.astype(int)[None, :]).mean(axis=(2, 3, 4))
    np.testing.assert_array_equal(np.diag(err), err.min(axis=1))
    assert np.diag(err).max() < 2.0


def test_refused_flags_say_why(tmp_path, monkeypatch):
    # --gpus above 1 is no longer refused: on the host it asks for that
    # many gloo ranks (tests/test_torch_parallel_cli.py runs them).
    from nerfmeshes_tpu_torch.parallel import mesh as t_mesh

    spawned = []
    monkeypatch.setattr(t_mesh, "launch",
                        lambda fn, world, device, **kw: spawned.append((world, device)))
    assert train_nerf.main(["--config", TINY, "--gpus", "2", "--device", "cpu"]) is None
    assert spawned == [(2, "cpu")]
    # A video path that is not a GIF exits before anything is built (the
    # run directory here holds nothing), with JAX's message.
    with pytest.raises(SystemExit, match=r"only \.gif is supported .*got a\.mp4"):
        eval_nerf.main(["--log-checkpoint", str(tmp_path), "--synthesis-video", "a.mp4"])
    with pytest.raises(SystemExit, match=r"only \.gif is supported .*got a\.mp4"):
        j_eval.main(["--log-checkpoint", str(tmp_path), "--synthesis-video", "a.mp4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_nerf.main(["--config", TINY, "--override", "experiment.logdir",
                         str(tmp_path / "logs")])


def _fake_cards(monkeypatch, t_mesh, n=8):
    """A host with `n` CUDA cards, as far as cli_world and run_cli see:
    spawned launches, joined groups and run bodies are recorded, not run."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(t_mesh, "launch",
                        lambda fn, world, device, **kw: calls.append(("launch", world, device)))
    monkeypatch.setattr(t_mesh, "init_group", lambda rank, world, device, **kw: t_mesh.DataGroup(
        rank=rank, world=world, device=torch.device(device)))
    return calls


@pytest.mark.parametrize("device,gpus,world,launched,ran_on", [
    ("cuda", None, 8, None, None),
    (None, 2, 2, None, None),
    ("cuda:3", None, 1, None, "cuda:3"),
    ("cuda:3", 1, 1, None, "cuda:3"),
    ("cpu", 2, 2, "cpu", None),
])
def test_device_flag_picks_the_ranks_and_cards(monkeypatch, device, gpus, world, launched,
                                               ran_on):
    """--device cuda:N is one rank on card N; cuda (or none) spreads the
    ranks over the cards (cuda:r), cpu over gloo ranks on the host."""
    from types import SimpleNamespace

    from nerfmeshes_tpu_torch.parallel import mesh as t_mesh

    calls = _fake_cards(monkeypatch, t_mesh)
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert t_mesh.cli_world(device, gpus) == world
    groups = []
    t_mesh.run_cli(lambda args, group: groups.append(group), SimpleNamespace(device=device),
                   world)
    if world > 1:
        want = None if device in (None, "cuda") else device
        assert calls == [("launch", world, want)] and groups == []
    else:
        assert calls == [] and [(g.world, g.device) for g in groups] == [
            (1, torch.device(ran_on))]


def test_device_index_beside_gpus_is_refused(monkeypatch):
    from nerfmeshes_tpu_torch.parallel import mesh as t_mesh

    _fake_cards(monkeypatch, t_mesh)
    with pytest.raises(ValueError, match=r"--device cuda:3 .*--gpus 2"):
        t_mesh.cli_world("cuda:3", 2)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_torchrun_ranks_take_their_local_card(monkeypatch, device):
    from nerfmeshes_tpu_torch.parallel import mesh as t_mesh

    _fake_cards(monkeypatch, t_mesh)
    monkeypatch.setenv("WORLD_SIZE", "4")
    for rank in range(4):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("LOCAL_RANK", str(rank))
        group = t_mesh.from_env(device)
        assert (group.rank, group.world, group.device) == (rank, 4, torch.device("cuda", rank))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert t_mesh.from_env(device).device == torch.device("cuda", 0)
    assert t_mesh.from_env("cuda:5").device == torch.device("cuda", 5)


def test_torchrun_refuses_one_card_for_every_rank(monkeypatch):
    from nerfmeshes_tpu_torch.parallel import mesh as t_mesh

    _fake_cards(monkeypatch, t_mesh)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="NCCL takes one rank per card"):
        t_mesh.from_env("cuda:0")


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
