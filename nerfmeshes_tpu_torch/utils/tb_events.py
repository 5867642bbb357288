"""TensorBoard event files without tensorboard (the part of
torch.utils.tensorboard.SummaryWriter that nerfmeshes_tpu/utils/logging.py
and nerfmeshes_tpu/utils/loggers.py use).

An event file, `events.out.tfevents.<time>.<host>.<pid>.<n>`, is a
sequence of TFRecords: a little-endian u64 length, the masked CRC32C of
those 8 bytes, the data, the masked CRC32C of the data. Each record holds
one `Event` protobuf; the first is `file_version: "brain.Event:2"`. The
protobufs (`Event`, `Summary.Value`, `Summary.Image`, `TensorProto`,
`TensorShapeProto`, `SummaryMetadata`, `PluginData` and the mesh plugin's
`MeshPluginData`) are encoded here by hand, field by field in number
order as protobuf serializes them, with the values torch's SummaryWriter
gives them:

- add_scalar: `simple_value` (float32);
- add_image: a PNG of an (H, W, C) uint8 image (data/blender.py's
  encoder: other bytes than PIL's, the same pixels);
- add_text: the text plugin's (1,) DT_STRING tensor under
  `<tag>/text_summary`;
- add_mesh: one value per part, `<tag>_VERTEX`, `<tag>_FACE`,
  `<tag>_COLOR`, each a (B, N, 3) DT_FLOAT tensor with MeshPluginData
  metadata (json_config "{}").

The writer writes each event through to the file. `read_events` parses a
file back, checking both CRCs of every record.

CRC32C (Castagnoli, reflected polynomial 0x82F63B78): records of a few
KB take a table-driven loop; longer ones (a grown tree's mesh is ~1.4 MB)
are cut into lanes that numpy steps in lockstep, one byte of every lane
at a time, and the lanes' registers are folded together with the linear
map of a lane's worth of zero bytes.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np

from nerfmeshes_tpu_torch.data.blender import encode_png

FILE_VERSION = "brain.Event:2"

# -- CRC32C -------------------------------------------------------------------------

_POLY = 0x82F63B78
_MASK_DELTA = 0xA282EAD8
_LANE_MIN_BYTES = 4096  # shorter data takes the plain loop


def _byte_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        table[i] = c
    return table


_TABLE = _byte_table()
_TABLE_LIST = _TABLE.tolist()


def _crc_loop(data: bytes, reg: int) -> int:
    table = _TABLE_LIST
    for b in data:
        reg = table[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


@lru_cache(maxsize=8)
def _zeros_map(length: int) -> tuple:
    """The register after `length` zero bytes as a linear map of the
    register before: four 256-entry tables, one per byte of it."""
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(length):
        basis = _TABLE[basis & 0xFF] ^ (basis >> 8)
    values = np.arange(256)
    tables = []
    for j in range(4):
        t = np.zeros(256, np.uint32)
        for bit in range(8):
            t ^= np.where((values >> bit) & 1, basis[8 * j + bit], 0).astype(np.uint32)
        tables.append(t.tolist())
    return tuple(tables)


def crc32c(data: bytes) -> int:
    """CRC32C of `data` (initial register and final xor 0xFFFFFFFF)."""
    n = len(data)
    if n < _LANE_MIN_BYTES:
        return _crc_loop(data, 0xFFFFFFFF) ^ 0xFFFFFFFF
    # Lanes of L bytes, the data right-aligned behind leading zeros: zero
    # bytes leave a zero register as it is, and the initial register is
    # the same as its complement xored into the first four data bytes.
    L = 1 << max(8, int(np.log2(np.sqrt(n))))
    lanes = -(-n // L)
    x = np.zeros(lanes * L, np.uint8)
    x[lanes * L - n:] = np.frombuffer(data, np.uint8)
    x[lanes * L - n:lanes * L - n + 4] ^= 0xFF
    cols = np.ascontiguousarray(x.reshape(lanes, L).T).astype(np.uint32)
    reg = np.zeros(lanes, np.uint32)
    for col in cols:
        reg ^= col
        reg = _TABLE[reg & 0xFF] ^ (reg >> 8)
    t0, t1, t2, t3 = _zeros_map(L)
    out = 0
    for r in reg.tolist():
        out = (t0[out & 0xFF] ^ t1[(out >> 8) & 0xFF] ^ t2[(out >> 16) & 0xFF]
               ^ t3[out >> 24] ^ r)
    return out ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# -- protobuf wire format --------------------------------------------------------------

_VARINT, _FIXED64, _BYTES, _FIXED32 = 0, 1, 2, 5

# tensorflow DataType and the mesh plugin's ContentType enums.
DT_FLOAT, DT_STRING = 1, 7
MESH_VERTEX, MESH_FACE, MESH_COLOR = 1, 2, 3
_MESH_PARTS = {MESH_VERTEX: "VERTEX", MESH_FACE: "FACE", MESH_COLOR: "COLOR"}


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1  # negative int32/int64: ten bytes, as protobuf writes them
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _f_varint(number: int, value: int) -> bytes:
    """A proto3 integer field: omitted at 0."""
    return _key(number, _VARINT) + _varint(value) if value else b""


def _f_bytes(number: int, payload: bytes) -> bytes:
    """A length-delimited field, written even when empty (a set message)."""
    return _key(number, _BYTES) + _varint(len(payload)) + payload


def _f_str(number: int, value) -> bytes:
    """A proto3 string/bytes field: omitted when empty."""
    if isinstance(value, str):
        value = value.encode("utf-8")
    return _f_bytes(number, value) if value else b""


def _tensor_proto(dtype: int, shape, *, float_val: Optional[np.ndarray] = None,
                  string_val: Optional[list] = None) -> bytes:
    dims = b"".join(_f_bytes(2, _f_varint(1, int(s))) for s in shape)
    out = _f_varint(1, dtype) + _f_bytes(2, dims)
    if float_val is not None and float_val.size:
        out += _f_bytes(5, np.ascontiguousarray(float_val, "<f4").tobytes())
    for s in string_val or ():
        out += _f_bytes(8, s)
    return out


def _metadata(plugin_name: str, content: bytes = b"") -> bytes:
    return _f_bytes(1, _f_str(1, plugin_name) + _f_str(2, content))


def _value(tag: str, *, simple_value: Optional[float] = None, image: Optional[bytes] = None,
           tensor: Optional[bytes] = None, metadata: Optional[bytes] = None) -> bytes:
    out = _f_str(1, tag)
    if simple_value is not None:
        out += _key(2, _FIXED32) + struct.pack("<f", simple_value)
    if image is not None:
        out += _f_bytes(4, image)
    if tensor is not None:
        out += _f_bytes(8, tensor)
    if metadata is not None:
        out += _f_bytes(9, metadata)
    return _f_bytes(1, out)


def mesh_plugin_data(name: str, content_type: int, components: int, shape) -> bytes:
    """MeshPluginData (version 0, json_config "{}")."""
    packed = b"".join(_varint(int(s)) for s in shape)
    return (_f_str(2, name) + _f_varint(3, content_type) + _f_str(5, "{}")
            + (_f_bytes(6, packed) if packed else b"") + _f_varint(7, components))


# -- the writer ------------------------------------------------------------------------

_file_ids = itertools.count()  # the <n> of each file name this process opens


class EventWriter:
    """Writes one event file under `log_dir`; every add_* call is one event,
    written through to the file."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}."
                f"{os.getpid()}.{next(_file_ids)}")
        self.path = self.log_dir / name
        self._file = open(self.path, "wb")
        self._event(_f_str(3, FILE_VERSION), None, None)

    def _event(self, what: bytes, step: Optional[int], walltime: Optional[float]) -> None:
        wall = time.time() if walltime is None else float(walltime)
        data = (_key(1, _FIXED64) + struct.pack("<d", wall)
                + (_f_varint(2, int(step)) if step is not None else b"") + what)
        header = struct.pack("<Q", len(data))
        self._file.write(header + struct.pack("<I", masked_crc32c(header)) + data
                         + struct.pack("<I", masked_crc32c(data)))
        self._file.flush()

    def _summary(self, values: bytes, step, walltime) -> None:
        self._event(_f_bytes(5, values), step, walltime)

    def add_scalar(self, tag: str, value: float, global_step: Optional[int] = None,
                   walltime: Optional[float] = None) -> None:
        self._summary(_value(tag, simple_value=float(value)), global_step, walltime)

    def add_image(self, tag: str, image: np.ndarray, global_step: Optional[int] = None,
                  walltime: Optional[float] = None) -> None:
        """`image`: (H, W, C) uint8, C in 1, 3, 4."""
        img = np.asarray(image)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3, 4):
            raise ValueError(f"add_image takes (H, W, 1|3|4) uint8, got {img.dtype} {img.shape}")
        png = encode_png(img[..., 0] if img.shape[2] == 1 else img)
        self.add_png(tag, png, img.shape, global_step, walltime)

    def add_png(self, tag: str, png: bytes, shape, global_step: Optional[int] = None,
                walltime: Optional[float] = None) -> None:
        """add_image of an image already encoded: `png` of (H, W, C) pixels."""
        H, W, C = shape
        body = _f_varint(1, H) + _f_varint(2, W) + _f_varint(3, C) + _f_str(4, png)
        self._summary(_value(tag, image=body), global_step, walltime)

    def add_text(self, tag: str, text: str, global_step: Optional[int] = None,
                 walltime: Optional[float] = None) -> None:
        tensor = _tensor_proto(DT_STRING, (1,), string_val=[text.encode("utf-8")])
        self._summary(_value(f"{tag}/text_summary", tensor=tensor, metadata=_metadata("text")),
                      global_step, walltime)

    def add_mesh(self, tag: str, vertices: np.ndarray, colors: Optional[np.ndarray] = None,
                 faces: Optional[np.ndarray] = None, global_step: Optional[int] = None,
                 walltime: Optional[float] = None) -> None:
        """(B, N, 3) vertices, colours and (B, F, 3) faces, as float32
        values (colours and vertex indices are exact there)."""
        parts = [(p, np.asarray(t)) for p, t in ((MESH_VERTEX, vertices), (MESH_FACE, faces),
                                                (MESH_COLOR, colors)) if t is not None]
        components = 0
        for part, t in parts:
            if t.ndim != 3:
                raise ValueError(f"add_mesh takes (B, N, 3) tensors, got {t.shape}")
            components |= 1 << part
        values = b""
        for part, t in parts:
            meta = _metadata("mesh", mesh_plugin_data(tag, part, components, t.shape))
            tensor = _tensor_proto(DT_FLOAT, t.shape, float_val=t.astype(np.float32).reshape(-1))
            values += _value(f"{tag}_{_MESH_PARTS[part]}", tensor=tensor, metadata=meta)
        self._summary(values, global_step, walltime)

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


# -- the reader ------------------------------------------------------------------------


class CorruptRecordError(ValueError):
    pass


def _fields(buf: bytes):
    """(number, wire type, value) of each field of a serialized message:
    an int for varints, bytes otherwise."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        number, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, i = _read_varint(buf, i)
        elif wire == _FIXED64:
            value, i = buf[i:i + 8], i + 8
        elif wire == _FIXED32:
            value, i = buf[i:i + 4], i + 4
        elif wire == _BYTES:
            size, i = _read_varint(buf, i)
            value, i = buf[i:i + size], i + size
        else:
            raise CorruptRecordError(f"unsupported wire type {wire}")
        if i > n:
            raise CorruptRecordError("truncated field")
        yield number, wire, value


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        if i >= len(buf):
            raise CorruptRecordError("truncated varint")
        byte = buf[i]
        i += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, i
        shift += 7


def _parse_tensor(buf: bytes) -> dict:
    out = {"dtype": 0, "shape": [], "float_val": np.zeros(0, np.float32), "string_val": []}
    floats = []
    for number, wire, value in _fields(buf):
        if number == 1:
            out["dtype"] = value
        elif number == 2:
            for n2, _, dim in _fields(value):
                if n2 == 2:
                    out["shape"].append(next((v for k, _, v in _fields(dim) if k == 1), 0))
        elif number == 5:
            floats.append(np.frombuffer(value, "<f4"))
        elif number == 8:
            out["string_val"].append(bytes(value))
    if floats:
        out["float_val"] = np.concatenate(floats)
    return out


def _parse_metadata(buf: bytes) -> dict:
    out = {"plugin_name": "", "content": b"", "display_name": ""}
    for number, _, value in _fields(buf):
        if number == 1:
            for n2, _, v2 in _fields(value):
                if n2 == 1:
                    out["plugin_name"] = v2.decode("utf-8")
                elif n2 == 2:
                    out["content"] = bytes(v2)
        elif number == 2:
            out["display_name"] = value.decode("utf-8")
    return out


def _parse_value(buf: bytes) -> dict:
    out: dict = {"tag": ""}
    for number, _, value in _fields(buf):
        if number == 1:
            out["tag"] = value.decode("utf-8")
        elif number == 2:
            out["simple_value"] = struct.unpack("<f", value)[0]
        elif number == 4:
            img = {"height": 0, "width": 0, "colorspace": 0, "encoded_image_string": b""}
            names = {1: "height", 2: "width", 3: "colorspace", 4: "encoded_image_string"}
            for n2, _, v2 in _fields(value):
                if n2 in names:
                    img[names[n2]] = bytes(v2) if n2 == 4 else v2
            out["image"] = img
        elif number == 8:
            out["tensor"] = _parse_tensor(value)
        elif number == 9:
            out["metadata"] = _parse_metadata(value)
    return out


def parse_mesh_plugin_data(content: bytes) -> dict:
    out = {"version": 0, "name": "", "content_type": 0, "json_config": "", "shape": [],
           "components": 0}
    for number, wire, value in _fields(content):
        if number == 1:
            out["version"] = value
        elif number == 2:
            out["name"] = value.decode("utf-8")
        elif number == 3:
            out["content_type"] = value
        elif number == 5:
            out["json_config"] = value.decode("utf-8")
        elif number == 6:
            if wire == _VARINT:
                out["shape"].append(value)
            else:
                i = 0
                while i < len(value):
                    v, i = _read_varint(value, i)
                    out["shape"].append(v)
        elif number == 7:
            out["components"] = value
    return out


def parse_event(data: bytes) -> dict:
    """An Event as a dict: wall_time, step, and file_version or summary (a
    list of values: tag, and simple_value, image, tensor or metadata)."""
    event: dict = {"wall_time": 0.0, "step": 0}
    for number, _, value in _fields(data):
        if number == 1:
            event["wall_time"] = struct.unpack("<d", value)[0]
        elif number == 2:
            event["step"] = value
        elif number == 3:
            event["file_version"] = value.decode("utf-8")
        elif number == 5:
            event["summary"] = [_parse_value(v) for n2, _, v in _fields(value) if n2 == 1]
    return event


def read_records(path) -> list[bytes]:
    """The data of every record of a TFRecord file; raises
    CorruptRecordError on a bad length or data CRC or a truncated record."""
    buf = Path(path).read_bytes()
    out, i = [], 0
    while i < len(buf):
        if i + 12 > len(buf):
            raise CorruptRecordError(f"{path}: truncated record header at byte {i}")
        header = buf[i:i + 8]
        (length,), (hcrc,) = struct.unpack("<Q", header), struct.unpack("<I", buf[i + 8:i + 12])
        if masked_crc32c(header) != hcrc:
            raise CorruptRecordError(f"{path}: length CRC mismatch at byte {i}")
        start, end = i + 12, i + 12 + length
        if end + 4 > len(buf):
            raise CorruptRecordError(f"{path}: truncated record at byte {i}")
        data = buf[start:end]
        if masked_crc32c(data) != struct.unpack("<I", buf[end:end + 4])[0]:
            raise CorruptRecordError(f"{path}: data CRC mismatch at byte {i}")
        out.append(data)
        i = end + 4
    return out


def read_events(path) -> list[dict]:
    """Every event of an event file, in order (parse_event), each record's
    CRCs checked."""
    return [parse_event(r) for r in read_records(path)]


def event_files(log_dir) -> list[Path]:
    """The event files of a directory, oldest name first."""
    return sorted(Path(log_dir).glob("events.out.tfevents.*"),
                  key=lambda p: (int(p.name.split(".")[3]), int(p.name.rsplit(".", 1)[1])))

