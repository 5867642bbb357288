"""The port's configs (nerfmeshes_tpu_torch/config/) against the JAX
package's and PyYAML, on the CPU.

- Every configs/*.yml loads through the port (its own YAML reader, no
  PyYAML) to JAX's load_config, value for value and type for type.
- yaml_lite reads every config, and JAX-written hparams.yaml files, as
  yaml.safe_load does, scalar by scalar; what it writes, yaml.safe_load
  reads back equal, and JAX's load_hparams reads a port run's hparams.yaml
  to JAX's config.
- merge_from_list and the coercion errors match JAX's case by case, and
  resolve_paths lays runs out as JAX's does.
All comparisons are exact.
"""

import math
import threading
from pathlib import Path

import pytest
import yaml

from nerfmeshes_tpu.config import cfgnode as j_cfgnode
from nerfmeshes_tpu.config import load_config as j_load_config
from nerfmeshes_tpu.config import paths as j_paths
from nerfmeshes_tpu_torch.config import cfgnode as t_cfgnode
from nerfmeshes_tpu_torch.config import get_default_cfg, load_config
from nerfmeshes_tpu_torch.config import paths as t_paths
from nerfmeshes_tpu_torch.config import yaml_lite

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yml"))


def same(a, b) -> bool:
    """Equal values of the same types, nested; NaN equals NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_there_are_configs():
    assert len(CONFIGS) == 12 and "tiny.yml" in CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_to_jax_config(name):
    got = load_config(str(REPO / "configs" / name)).to_dict()
    want = j_load_config(str(REPO / "configs" / name)).to_dict()
    assert same(got, want)


@pytest.mark.parametrize("name", CONFIGS)
def test_yaml_lite_reads_configs_as_pyyaml(name):
    text = (REPO / "configs" / name).read_text()
    assert same(yaml_lite.loads(text), yaml.safe_load(text))


SCALARS = ["1e-3", "5.0E-4", "5.0e-4", "-1.5e+3", "1.", ".5", "True", "true", "TRUE", "yes",
           "No", "on", "off", "~", "null", "Null", "", "0", "-0", "+7", "017", "08", "09.5",
           "0x1F", "0b101", "1_000", "1:30", "190:20:30.15", ".inf", "-.inf", ".nan",
           "a string", "./logs", "float32", "'quoted # not a comment'", '"tab\\tand \\u00e9"',
           "'it''s'", "[1, 2.0, a, 'b c', [true, null]]", "[]", "{}"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_safe_load(text):
    assert same(yaml_lite.load_value(text), yaml.safe_load(text))
    assert same(yaml_lite.loads(f"key: {text}  # note\n")["key"],
                yaml.safe_load(f"key: {text}  # note\n")["key"])


def test_what_it_writes_safe_load_reads_back():
    values = {"a.float": 1e-10, "a.small": 5e-4, "a.big": 1e16, "a.neg": -2.5e-7,
              "a.zero": 0.0, "a.inf": math.inf, "a.ninf": -math.inf, "b.int": 3,
              "b.bool": True, "b.none": None, "c.colon": "x: y", "c.empty": "",
              "c.number_like": "1e-3", "c.null_like": "null", "c.quote": "it's",
              "c.unicode": "é\n", "d.list": [1, 2.5, "a", [False]]}
    text = yaml_lite.dump(values)
    assert same(yaml.safe_load(text), values)
    assert same(yaml_lite.loads(text), values)
    nested = {"a": {"b": 1, "c": {"d": "x"}}, "e": {}}
    assert same(yaml.safe_load(yaml_lite.dump(nested)), nested)


def test_reads_a_jax_written_hparams(tmp_path):
    cfg = j_load_config(str(REPO / "configs" / "buff-hard-250k.yml"))
    cfg.experiment.description = "a long description " * 8  # PyYAML folds it
    cfg.scheduler.options.milestones = [1000, 2000]  # a block sequence
    paths = j_paths.ExperimentPaths(tmp_path).create()
    j_paths.save_hparams(cfg, paths)
    text = paths.hparams_path.read_text()
    assert "\n  " in text and "\n- 1000" in text
    assert same(yaml_lite.loads(text), yaml.safe_load(text))


@pytest.mark.parametrize("name", ["tiny.yml", "hard-blender.yml", "buff-hard-250k.yml"])
def test_hparams_round_trip_between_the_packages(tmp_path, name):
    """Port-written hparams.yaml -> JAX's load_hparams, and JAX-written ->
    the port's load_hparams, each equal to the config."""
    t_cfg = load_config(str(REPO / "configs" / name))
    t_cfg.optimizer.lr = 1e-7  # a float Python writes as '1e-07'
    t_paths.save_hparams(t_cfg, t_paths.ExperimentPaths(tmp_path / "port").create())
    assert same(j_paths.load_hparams(str(tmp_path / "port")).to_dict(), t_cfg.to_dict())
    j_cfg = j_load_config(str(REPO / "configs" / name))
    j_paths.save_hparams(j_cfg, j_paths.ExperimentPaths(tmp_path / "jax").create())
    assert same(t_paths.load_hparams(tmp_path / "jax").to_dict(), j_cfg.to_dict())


OVERRIDES = [
    ["optimizer.lr", "1e-3"],
    ["optimizer.lr", "2"],
    ["optimizer.lr", 3],
    ["experiment.train_iters", "500"],
    ["experiment.train_iters", "5.0"],
    ["experiment.train_iters", 7.0],
    ["experiment.use_fused_kernel", "false"],
    ["experiment.use_fused_kernel", "True"],
    ["experiment.id", "run-1"],
    ["dataset.basedir", "''"],
    ["scheduler.options.gamma", "0.5"],
    ["nerf.train.num_random_rays", "4096", "optimizer.lr", "5.0E-4"],
]
BAD_OVERRIDES = [
    ["no.such.key", "1"],
    ["experiment.nope", "1"],
    ["experiment.train_iters", "5.5"],
    ["experiment.train_iters", "abc"],
    ["experiment.use_fused_kernel", "maybe"],
    ["experiment.use_fused_kernel", "0"],  # parsed as an int first, as in JAX
    ["experiment.id", "1e-3"],  # a number, which a string key refuses
    ["experiment", "1"],
    ["optimizer.lr"],
]


def _outcome(package, opts):
    cfg = package.get_default_cfg()
    try:
        cfg.merge_from_list(list(opts))
    except (KeyError, ValueError) as err:
        return type(err).__name__, str(err)
    return "ok", cfg.to_dict()


@pytest.mark.parametrize("opts", OVERRIDES + BAD_OVERRIDES,
                         ids=[" ".join(map(str, o)) for o in OVERRIDES + BAD_OVERRIDES])
def test_merge_from_list_matches_jax(opts):
    import nerfmeshes_tpu.config as j_config
    import nerfmeshes_tpu_torch.config as t_config

    got, want = _outcome(t_config, opts), _outcome(j_config, opts)
    assert got[0] == want[0]
    assert same(got[1], want[1]) if got[0] == "ok" else got[1] == want[1]
    assert (got[0] == "ok") == (opts in OVERRIDES)


COERCIONS = [(1, 2.0), (2.0, 3), (2.5, 3), ((1, 2), [3]), ([1], (2, 3)), ("true", False),
             ("0", True), ("yes", True), ({"a": 1}, 1), (1, {"a": 1}), ("x", 1), (None, 1),
             (1, None), (True, 1.0)]


@pytest.mark.parametrize("new, old", COERCIONS)
def test_coerce_matches_jax(new, old):
    def outcome(fn):
        try:
            return "ok", fn(new, old, "k")
        except ValueError as err:
            return "ValueError", str(err)

    got, want = outcome(t_cfgnode._coerce), outcome(j_cfgnode._coerce)
    assert got[0] == want[0] and (same(got[1], want[1]) if got[0] == "ok" else got == want)


def test_cfgnode_behaves_as_jax():
    cfg = get_default_cfg()
    with pytest.raises(AttributeError):
        cfg.models.no_such_key
    clone = cfg.clone().freeze()
    with pytest.raises(AttributeError, match="frozen"):
        clone.experiment.id = "x"
    assert clone.clone().is_frozen() and not cfg.is_frozen()
    with pytest.raises(TypeError, match="unsupported"):
        t_cfgnode.CfgNode({"a": object()})
    flat = t_cfgnode.flatten_dict(cfg.to_dict())
    assert flat == j_cfgnode.flatten_dict(cfg.to_dict())
    assert t_cfgnode.nest_dict(flat) == cfg.to_dict()
    assert same(yaml.safe_load(cfg.dump()), cfg.to_dict())


def test_resolve_paths_layout_matches_jax(tmp_path):
    config = str(REPO / "configs" / "tiny.yml")
    opts = ["experiment.logdir", str(tmp_path / "logs"), "experiment.id", "exp"]
    runs = []
    for package in (t_paths, j_paths, t_paths):
        cfg, paths = package.resolve_paths(config_path=config, run_name="r", overrides=opts)
        runs.append(paths.log_dir)
        assert paths.hparams_path.exists() and paths.checkpoint_dir.is_dir()
        assert paths.events_dir.is_dir() and cfg.experiment.id == "exp"
    assert runs == [tmp_path / "logs" / "exp" / "r" / f"version_{k}" for k in range(3)]
    with pytest.raises(ValueError, match="exactly one"):
        t_paths.resolve_paths()
    with pytest.raises(ValueError, match="exactly one"):
        t_paths.resolve_paths(config_path=config, log_checkpoint=str(runs[0]))
    # A resume-time override is persisted; without one, nothing is written.
    cfg, _ = t_paths.resolve_paths(log_checkpoint=str(runs[0]),
                                   overrides=["experiment.train_iters", "30"])
    assert cfg.experiment.train_iters == 30
    assert t_paths.load_hparams(runs[0]).experiment.train_iters == 30
    assert j_paths.load_hparams(str(runs[0])).experiment.train_iters == 30


def test_hparams_are_never_read_half_written(tmp_path):
    """save_hparams replaces hparams.yaml whole: a reader looping beside a
    few hundred saves (an eval CLI beside a run that resumes) reads the old
    config or the new one, never an empty or partial file, and no
    temporary file stays behind."""
    paths = t_paths.ExperimentPaths(tmp_path).create()
    cfgs = [get_default_cfg(), get_default_cfg()]
    cfgs[1].experiment.randomseed = 7
    t_paths.save_hparams(cfgs[0], paths)
    texts = {paths.hparams_path.read_text()}
    t_paths.save_hparams(cfgs[1], paths)
    texts.add(paths.hparams_path.read_text())
    assert len(texts) == 2
    seen, done = [], threading.Event()

    def read():
        while not done.is_set():
            seen.append(paths.hparams_path.read_text())

    reader = threading.Thread(target=read)
    reader.start()
    try:
        for i in range(300):
            t_paths.save_hparams(cfgs[i % 2], paths)
    finally:
        done.set()
        reader.join()
    assert seen and all(text in texts for text in seen)
    assert t_paths.load_hparams(tmp_path).experiment.randomseed == 7
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoints", "events", "hparams.yaml"]
