"""Own-images pipeline (counterpart of nerfmeshes_tpu/cli/colmap_convert.py,
the same CLI contract): run COLMAP's structure from motion on
<scenedir>/images and convert its sparse/0 model into an LLFF
poses_bounds.npy with per-image depth-percentile bounds.

    python -m nerfmeshes_tpu_torch.cli.colmap_convert <scenedir> --match_type exhaustive_matcher

The COLMAP binaries stay an external process, as in JAX; without a
`colmap` on PATH, a scene that still needs them raises. A scene whose
sparse/0 holds cameras.bin, images.bin and points3D.bin converts without
them.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from nerfmeshes_tpu_torch.data.loaders.colmap import (
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)
from nerfmeshes_tpu_torch.data.loaders.llff import minify


def load_colmap_data(realdir: str):
    """sparse/0 model -> LLFF 3x5 pose stack, the points, the images' order
    by name and the map from image id to row."""
    sparse = Path(realdir) / "sparse" / "0"
    camdata = read_cameras_binary(sparse / "cameras.bin")
    cam = camdata[next(iter(camdata))]
    hwf = np.array([cam.height, cam.width, cam.params[0]], np.float64)

    imdata = read_images_binary(sparse / "images.bin")
    # Map image id -> row index in FILE order: poses/zvals rows below are
    # built by iterating imdata in insertion order, and COLMAP writes
    # images.bin from an unordered map, so ids are not necessarily sorted
    # — a sorted-id mapping would attribute visibility to wrong cameras.
    image_mapping = {k: i for i, k in enumerate(imdata)}
    names = [imdata[k].name for k in imdata]
    perm = np.argsort(names)

    w2c = []
    bottom = np.array([[0, 0, 0, 1.0]])
    for k in imdata:
        im = imdata[k]
        m = np.concatenate(
            [np.concatenate([im.qvec2rotmat(), im.tvec.reshape(3, 1)], 1), bottom], 0
        )
        w2c.append(m)
    c2w = np.linalg.inv(np.stack(w2c))  # (N, 4, 4)

    poses = c2w[:, :3, :4]  # (N, 3, 4)
    hwf_col = np.broadcast_to(hwf.reshape(1, 3, 1), (poses.shape[0], 3, 1))
    poses = np.concatenate([poses, hwf_col], axis=2)  # (N, 3, 5)

    # COLMAP's [r, -u, t] -> LLFF's [-u, r, -t] column convention.
    poses = np.concatenate(
        [poses[:, :, 1:2], poses[:, :, 0:1], -poses[:, :, 2:3], poses[:, :, 3:4],
         poses[:, :, 4:5]],
        axis=2,
    )

    pts3d = read_points3d_binary(sparse / "points3D.bin")
    return poses, pts3d, perm, image_mapping


def save_poses(basedir: str, poses, pts3d, perm, image_mapping) -> None:
    """Per-image 0.1/99.9 depth percentiles + flattened poses ->
    poses_bounds.npy, rows in the images' order by name."""
    n_images = poses.shape[0]
    pts = np.stack([p.xyz for p in pts3d.values()])  # (P, 3)
    vis = np.zeros((len(pts3d), n_images), bool)
    for row, p in enumerate(pts3d.values()):
        for ind in p.image_ids:
            vis[row, image_mapping[ind]] = True

    # Per-image depth of each point along the camera's -z (LLFF back axis).
    # zvals[p, i] = -(pt - cam_center_i) . back_axis_i
    centers = poses[:, :3, 3]  # (N, 3)
    back = poses[:, :3, 2]  # (N, 3)
    zvals = -np.einsum("pnc,nc->pn", pts[:, None, :] - centers[None], back)

    save_arr = []
    for i in perm:
        zs = zvals[vis[:, i], i]
        if zs.size == 0:
            # Image registered but observing no 3D points: fall back to
            # the scene-wide depth range instead of percentile-of-empty.
            zs = zvals[:, i]
        close_depth, inf_depth = np.percentile(zs, 0.1), np.percentile(zs, 99.9)
        save_arr.append(
            np.concatenate([poses[i].ravel(), [close_depth, inf_depth]])
        )
    np.save(os.path.join(basedir, "poses_bounds.npy"), np.array(save_arr))


def run_colmap(basedir: str, match_type: str) -> None:
    """Run the external COLMAP binaries: feature extraction, matching and
    the mapper, their output logged to <basedir>/colmap_output.txt. Without
    a `colmap` on PATH this raises FileNotFoundError naming what to do."""
    if shutil.which("colmap") is None:
        raise FileNotFoundError(
            f"{basedir}: no sparse/0 model (cameras.bin, images.bin, points3D.bin) and no "
            "`colmap` binary on PATH to make one; install COLMAP or run it elsewhere and "
            "copy sparse/0 into the scene")
    log_path = os.path.join(basedir, "colmap_output.txt")
    with open(log_path, "w") as logfile:
        steps = [
            [
                "colmap", "feature_extractor",
                "--database_path", os.path.join(basedir, "database.db"),
                "--image_path", os.path.join(basedir, "images"),
                "--ImageReader.single_camera", "1",
            ],
            [
                "colmap", match_type,
                "--database_path", os.path.join(basedir, "database.db"),
            ],
        ]
        os.makedirs(os.path.join(basedir, "sparse"), exist_ok=True)
        steps.append(
            [
                "colmap", "mapper",
                "--database_path", os.path.join(basedir, "database.db"),
                "--image_path", os.path.join(basedir, "images"),
                "--output_path", os.path.join(basedir, "sparse"),
                "--Mapper.num_threads", "16",
                "--Mapper.init_min_tri_angle", "4",
                "--Mapper.multiple_models", "0",
                "--Mapper.extract_colors", "0",
            ]
        )
        for cmd in steps:
            logfile.write(subprocess.check_output(cmd, universal_newlines=True))
    print(f"Finished running COLMAP, see {log_path} for logs")


def sort_out_images(basedir: str) -> None:
    """Copy only COLMAP-registered images from all_images/ into images/."""
    imfolder = os.path.join(basedir, "images")
    allimfolder = os.path.join(basedir, "all_images")
    if not os.path.exists(allimfolder):
        return  # images/ was the input; nothing to sort
    os.makedirs(imfolder, exist_ok=True)
    imdata = read_images_binary(os.path.join(basedir, "sparse/0/images.bin"))
    for image in imdata.values():
        shutil.copy2(os.path.join(allimfolder, image.name), imfolder)


def gen_poses(basedir: str, match_type: str, factors=None) -> bool:
    needed = [f"{f}.bin" for f in ("cameras", "images", "points3D")]
    sparse0 = os.path.join(basedir, "sparse/0")
    have = os.listdir(sparse0) if os.path.exists(sparse0) else []
    if not all(f in have for f in needed):
        print("Need to run COLMAP")
        run_colmap(basedir, match_type)
    else:
        print("Don't need to run COLMAP")

    poses, pts3d, perm, image_mapping = load_colmap_data(basedir)
    save_poses(basedir, poses, pts3d, perm, image_mapping)
    sort_out_images(basedir)
    if factors:
        for factor in np.atleast_1d(factors):
            minify(basedir, int(factor))
    print("Done with imgs2poses")
    return True


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("scenedir", type=str, help="input scene directory")
    parser.add_argument(
        "--match_type", type=str, default="exhaustive_matcher",
        help="exhaustive_matcher or sequential_matcher",
    )
    args = parser.parse_args(argv)
    if args.match_type not in ("exhaustive_matcher", "sequential_matcher"):
        print(f"ERROR: matcher type {args.match_type} is not valid. Aborting")
        sys.exit(1)
    gen_poses(args.scenedir, args.match_type)


if __name__ == "__main__":
    main()
