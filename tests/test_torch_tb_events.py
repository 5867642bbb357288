"""The port's TensorBoard event files (nerfmeshes_tpu_torch/utils/tb_events.py)
against what the JAX package's MetricsLogger writes through
torch.utils.tensorboard.SummaryWriter.

- The same calls (scalars, a float and a uint8 image, text, the tree and
  depth-projection meshes, the memm figure) through both loggers give the
  same events, record by record, read by tensorboard's own loaders: step,
  tag and the serialized value byte for byte (float32 scalars, text
  tensors, mesh tensors and their MeshPluginData); images as decoded
  pixels; the memm figure by tag, step and size (its pixels are
  matplotlib's on one side). Wall times are ignored.
- CRC32C: RFC 3720's check value, tensorboard's CRC on data of every
  length class (the plain loop and the lane path), and a corrupted byte
  makes read_events raise.
- The port's reader reads the SummaryWriter's file.
"""

import io

import numpy as np
import pytest
from PIL import Image
from tensorboard.backend.event_processing.event_file_loader import (
    EventFileLoader,
    LegacyEventFileLoader,
)
from tensorboard.compat.proto import event_pb2
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import crc32c as tb_crc32c

from nerfmeshes_tpu.utils import loggers as j_loggers
from nerfmeshes_tpu.utils.logging import MetricsLogger as JaxLogger
from nerfmeshes_tpu_torch.utils import loggers
from nerfmeshes_tpu_torch.utils import tb_events as tb
from nerfmeshes_tpu_torch.utils.logging import MetricsLogger


def _voxels(rng, V):
    lo = rng.uniform(-2.0, 2.0, (V, 3)).astype(np.float32)
    return np.stack([lo, lo + rng.uniform(0.05, 0.5, (V, 3)).astype(np.float32)], 1)


def _drive(logger, mod, rng_seed=0):
    """One sequence of logger calls; `mod` is the loggers module of the
    logger's stack."""
    rng = np.random.default_rng(rng_seed)
    logger.log_scalars({"train/loss": 0.1234567891, "train/psnr": 21.0625, "train/lr": 5e-4,
                        "train/rays_per_sec": 123456.789}, 25)
    logger.log_image("validation/rgb_fine/0", rng.uniform(0, 1, (12, 16, 3)), 50)
    logger.log_image("validation/img_target/0", rng.integers(0, 256, (9, 7, 3), np.uint8), 50)
    logger.log_text("description", "Tiny synthetic smoke test.")
    logger.log_text("config", "experiment:\n  id: tiny\n  note: µ-scale ✓\n", 3)
    voxels = _voxels(rng, 40)
    active = np.arange(40) % 3 != 0
    mod.TreeLogger().tick(logger._tb, 200, voxels, active)
    mod.TreeWeightsLogger().tick(logger._tb, 201, rng.uniform(0, 1, 40).astype(np.float32),
                                 active)
    R = 64
    o = np.zeros((R, 3), np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    target = rng.uniform(2.0, 6.0, R).astype(np.float32)
    target[::5] = 0.0
    pred = target + rng.choice([0.0, 0.1, 0.5, -1.0], R).astype(np.float32)
    mod.DepthProjectionLogger(step_size=1).tick(logger._tb, 100, o, d, pred, target)
    mod.DepthProjectionLogger(step_size=1).tick(logger._tb, 200, np.zeros(3), d, pred)
    logger.log_scalars({"validation/loss": 0.0, "validation/fine_psnr": float("inf")}, 300)
    logger.close()


@pytest.fixture(scope="module")
def both_files(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax")
    pdir = tmp_path_factory.mktemp("port")
    _drive(JaxLogger(str(jdir)), j_loggers)
    _drive(MetricsLogger(pdir), loggers)
    (jfile,) = jdir.glob("events.out.tfevents.*")
    (pfile,) = tb.event_files(pdir)
    return jfile, pfile


def _pixels(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def _compare(j_events, p_events):
    assert len(p_events) == len(j_events) > 10
    assert p_events[0].file_version == j_events[0].file_version == tb.FILE_VERSION
    for je, pe in zip(j_events[1:], p_events[1:]):
        assert pe.step == je.step
        assert [v.tag for v in pe.summary.value] == [v.tag for v in je.summary.value]
        for jv, pv in zip(je.summary.value, pe.summary.value):
            if jv.HasField("image"):  # as written
                ji, pi = jv.image, pv.image
                assert (pi.height, pi.width, pi.colorspace) == (ji.height, ji.width,
                                                                 ji.colorspace)
                j_png, p_png = ji.encoded_image_string, pi.encoded_image_string
            elif jv.metadata.plugin_data.plugin_name == "images":  # migrated: [w, h, png]
                assert pv.metadata == jv.metadata
                assert pv.tensor.string_val[:2] == jv.tensor.string_val[:2]
                j_png, p_png = jv.tensor.string_val[2], pv.tensor.string_val[2]
            else:
                assert pv.SerializeToString() == jv.SerializeToString(), jv.tag
                continue
            if jv.tag != "Tree Memm":  # matplotlib's pixels on the JAX side
                np.testing.assert_array_equal(_pixels(p_png), _pixels(j_png))


def test_events_match_the_summary_writers_record_by_record(both_files):
    jfile, pfile = both_files
    _compare(list(EventFileLoader(str(jfile)).Load()), list(EventFileLoader(str(pfile)).Load()))


def test_raw_events_match_without_the_loaders_migration(both_files):
    """LegacyEventFileLoader hands the protos over as they were written:
    scalars as simple_value, text and mesh metadata as SummaryWriter
    serializes them."""
    jfile, pfile = both_files
    j_events = list(LegacyEventFileLoader(str(jfile)).Load())
    p_events = list(LegacyEventFileLoader(str(pfile)).Load())
    _compare(j_events, p_events)
    tags = [v.tag for e in p_events[1:] for v in e.summary.value]
    assert {"train/loss", "description/text_summary", "config/text_summary", "Tree_VERTEX",
            "Tree_FACE", "Tree_COLOR", "Point Cloud_VERTEX", "Point Cloud_COLOR",
            "Tree Memm"} <= set(tags)
    loss = next(v for e in p_events for v in e.summary.value if v.tag == "train/loss")
    assert loss.simple_value == np.float32(0.1234567891)


def test_port_reader_reads_both_files(both_files):
    jfile, pfile = both_files
    for path in (jfile, pfile):
        events = tb.read_events(path)
        assert events[0]["file_version"] == tb.FILE_VERSION
        mesh = [v for e in events[1:] for v in e["summary"] if v["tag"] == "Tree_FACE"]
        (face,) = mesh
        plugin = tb.parse_mesh_plugin_data(face["metadata"]["content"])
        assert plugin["name"] == "Tree" and plugin["content_type"] == tb.MESH_FACE
        assert plugin["shape"] == [1, 26 * 12, 3] and plugin["json_config"] == "{}"
        assert face["tensor"]["float_val"].size == 26 * 12 * 3
    j_raw = [event_pb2.Event.FromString(r) for r in tb.read_records(jfile)]
    assert [e.step for e in j_raw] == [e["step"] for e in tb.read_events(jfile)]


def test_a_grown_tree_mesh_round_trips(tmp_path):
    """~1.4 MB of mesh in one record (4096 voxels): the CRC's lane path,
    read back by tensorboard's loader and by the port's reader."""
    rng = np.random.default_rng(3)
    writer = tb.EventWriter(tmp_path)
    voxels = _voxels(rng, 4096)
    loggers.TreeLogger().tick(writer, 7, voxels)
    writer.close()
    (event,) = list(EventFileLoader(str(writer.path)).Load())[1:]
    verts = next(v for v in event.summary.value if v.tag == "Tree_VERTEX")
    want, faces, colors = loggers.voxel_mesh(voxels)
    np.testing.assert_array_equal(np.asarray(verts.tensor.float_val, np.float32),
                                  want.astype(np.float32).reshape(-1))
    ours = tb.read_events(writer.path)[1]["summary"]
    np.testing.assert_array_equal(ours[1]["tensor"]["float_val"], faces.reshape(-1))
    np.testing.assert_array_equal(ours[2]["tensor"]["float_val"], colors.reshape(-1))
    assert writer.path.stat().st_size > 1_300_000


def test_crc32c_check_value_and_tensorboards_crc():
    assert tb.crc32c(b"123456789") == 0xE3069283
    assert tb.crc32c(b"") == 0
    rng = np.random.default_rng(0)
    for n in (1, 3, 4, 5, 255, 4095, 4096, 4097, 65537, 300_001):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tb.crc32c(data) == tb_crc32c(data), n
    zeros = bytes(70_000)
    assert tb.crc32c(zeros) == tb_crc32c(zeros)


@pytest.mark.parametrize("where", ["header", "data", "footer"])
def test_a_corrupted_byte_makes_read_events_raise(tmp_path, where):
    writer = tb.EventWriter(tmp_path)
    writer.add_scalar("a", 1.0, 1)
    writer.add_text("t", "some text", 2)
    writer.close()
    raw = bytearray(writer.path.read_bytes())
    first = 12 + int.from_bytes(raw[:8], "little") + 4  # the file_version record
    offset = {"header": first + 2, "data": first + 14, "footer": len(raw) - 2}[where]
    raw[offset] ^= 0x20
    writer.path.write_bytes(bytes(raw))
    with pytest.raises(tb.CorruptRecordError):
        tb.read_events(writer.path)


def test_truncated_file_raises(tmp_path):
    writer = tb.EventWriter(tmp_path)
    writer.add_scalar("a", 1.0, 1)
    writer.close()
    writer.path.write_bytes(writer.path.read_bytes()[:-3])
    with pytest.raises(tb.CorruptRecordError, match="truncated"):
        tb.read_events(writer.path)


def test_add_image_refuses_what_it_cannot_encode(tmp_path):
    writer = tb.EventWriter(tmp_path)
    with pytest.raises(ValueError, match="uint8"):
        writer.add_image("x", np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        writer.add_image("x", np.zeros((4, 4), np.uint8))
    writer.close()


def test_each_logger_opens_its_own_file(tmp_path):
    a, b = MetricsLogger(tmp_path), MetricsLogger(tmp_path)
    a.log_scalars({"x": 1.0}, 1)
    b.log_scalars({"x": 2.0}, 2)
    files = tb.event_files(tmp_path)
    assert len(files) == 2 and files[0] != files[1]
    values = [e["summary"][0]["simple_value"] for f in files for e in tb.read_events(f)[1:]]
    assert sorted(values) == [1.0, 2.0]
    a.close()
    b.close()
