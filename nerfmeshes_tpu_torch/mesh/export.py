"""Mesh file export: OBJ (with vertex colors) and PLY (counterpart of
nerfmeshes_tpu/mesh/export.py; numpy only, byte for byte the same files).

OBJ: `v x y z r g b`, `vn`, `f i//i`, the reference's export_obj layout,
written by the native library's buffered writer. PLY: ASCII, or binary
little-endian through one structured-array write per element.
"""

from __future__ import annotations

import numpy as np

from nerfmeshes_tpu_torch.mesh.native import obj_write_native


def _colors_u8(colors) -> np.ndarray:
    """PLY color bytes: uint8 arrays pass through untouched (already
    quantized); float [0, 1] colors are scaled and truncated."""
    colors = np.asarray(colors)
    if colors.dtype == np.uint8:
        return colors
    return np.clip(colors * 255.0, 0, 255).astype(np.uint8)


def export_obj(vertices, triangles, diffuse, normals, filename: str) -> None:
    vertices = np.asarray(vertices)
    triangles = np.asarray(triangles)
    diffuse = np.asarray(diffuse) if diffuse is not None else np.zeros((0, 3))
    normals = np.asarray(normals) if normals is not None else np.zeros((0, 3))

    if triangles.ndim == 2 and triangles.shape[1] == 3 and obj_write_native(
        filename, vertices, diffuse if len(diffuse) else None, normals, triangles
    ):
        return

    # Layouts the native writer does not take (RGBA colors, colors for only
    # some vertices): the same lines, formatted here.
    with open(filename, "w") as fh:
        for index, v in enumerate(vertices):
            fh.write("v {} {} {}".format(*v))
            if len(diffuse) > index:
                fh.write(" {} {} {}".format(*diffuse[index]))
            fh.write("\n")
        for n in normals:
            fh.write("vn {} {} {}\n".format(*n))
        for f in triangles:
            fh.write("f")
            for index in f:
                fh.write(" {}//{}".format(index + 1, index + 1))
            fh.write("\n")


def import_obj(filename: str):
    """Minimal OBJ reader (v / vn / f), for chamfer targets and tests.

    Returns (vertices, triangles, diffuse | None, normals | None)."""
    verts, colors, normals, faces = [], [], [], []
    with open(filename) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif parts[0] == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(colors, np.float32) if colors else None,
        np.asarray(normals, np.float32) if normals else None,
    )


def export_ply(vertices, triangles=None, colors=None, normals=None, filename="out.ply"):
    vertices = np.asarray(vertices)
    n = len(vertices)
    has_c = colors is not None
    has_n = normals is not None
    tris = np.asarray(triangles) if triangles is not None else np.zeros((0, 3), int)

    with open(filename, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {n}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        if has_n:
            fh.write("property float nx\nproperty float ny\nproperty float nz\n")
        if has_c:
            fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fh.write(f"element face {len(tris)}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        normals_all = np.asarray(normals) if has_n else None
        c_all = _colors_u8(colors) if has_c else None
        for i in range(n):
            row = list(vertices[i])
            if has_n:
                row += list(normals_all[i])
            line = " ".join(f"{x}" for x in row)
            if has_c:
                line += " {} {} {}".format(*c_all[i])
            fh.write(line + "\n")
        for f in tris:
            fh.write("3 {} {} {}\n".format(*f))


def export_ply_binary(vertices, triangles=None, colors=None, normals=None,
                      filename="out.ply"):
    """Binary little-endian PLY, one structured-array write per element:
    the fast writer for meshes of millions of vertices."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    n = len(vertices)
    has_c = colors is not None
    has_n = normals is not None
    tris = (np.ascontiguousarray(triangles, np.int32) if triangles is not None
            else np.zeros((0, 3), np.int32))

    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if has_n:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if has_c:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    vdata = np.empty(n, dtype=fields)
    vdata["x"], vdata["y"], vdata["z"] = vertices.T
    if has_n:
        nrm = np.ascontiguousarray(normals, np.float32)
        vdata["nx"], vdata["ny"], vdata["nz"] = nrm.T
    if has_c:
        vdata["red"], vdata["green"], vdata["blue"] = _colors_u8(colors).T

    fdata = np.empty(len(tris), dtype=[("count", "u1"), ("idx", "<i4", (3,))])
    fdata["count"] = 3
    fdata["idx"] = tris

    with open(filename, "wb") as fh:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += ["property float x", "property float y", "property float z"]
        if has_n:
            header += ["property float nx", "property float ny", "property float nz"]
        if has_c:
            header += ["property uchar red", "property uchar green", "property uchar blue"]
        header += [f"element face {len(tris)}",
                   "property list uchar int vertex_indices", "end_header"]
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        vdata.tofile(fh)
        fdata.tofile(fh)


def read_ply_binary(filename: str):
    """Read back what export_ply_binary writes: (vertices (V, 3) f32,
    triangles (T, 3) int32, normals (V, 3) f32 | None, colors (V, 3) uint8 |
    None)."""
    raw = open(filename, "rb").read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii").splitlines()
    if header[:2] != ["ply", "format binary_little_endian 1.0"]:
        raise ValueError(f"{filename} is not a binary little-endian PLY")
    counts = {line.split()[1]: int(line.split()[2])
              for line in header if line.startswith("element ")}
    props = [line.split()[-1] for line in header if line.startswith("property ")
             and "list" not in line]
    fields = [(p, "u1" if p in ("red", "green", "blue") else "<f4") for p in props]
    vdtype = np.dtype(fields)
    vdata = np.frombuffer(raw, dtype=vdtype, count=counts["vertex"], offset=end)
    fdata = np.frombuffer(raw, dtype=[("count", "u1"), ("idx", "<i4", (3,))],
                          count=counts["face"], offset=end + counts["vertex"] * vdtype.itemsize)
    if not (fdata["count"] == 3).all():
        raise ValueError(f"{filename} holds faces that are not triangles")

    def cols(*names):
        if names[0] not in vdtype.names:
            return None
        return np.stack([vdata[k] for k in names], -1)

    return (cols("x", "y", "z"), fdata["idx"].astype(np.int32), cols("nx", "ny", "nz"),
            cols("red", "green", "blue"))
