"""Write the procedural hard scene as a ScanNet .sens stream: colour frames
1296x968 as baseline 4:2:0 JPEG and depth 640x480 as zlib'd uint16 in
millimetres (depth_shift 1000), ScanNet's published sensor layout, with
OpenCV-convention camera-to-world poses (x right, y down, +z forward) on an
orbit of radius ~4 around the scene at the origin.

The colour intrinsics are near ScanNet's own (fx ~ fy ~ 1170, the
principal point off centre); the depth intrinsics are the colour ones
scaled to 640x480. Depth is the rendered z-depth (the ray parameter along
ScanNet's unnormalised directions), 0 where a ray misses. One frame
(--lost, default 5) carries a -inf pose, as real streams do where
tracking was lost. Beside the stream, digests.json holds the sha256 of
each frame's pixels as PIL decodes them, which chip_smoke.py's JPEG phase
holds the port's decoder to on the card's host (that host has no JPEG
encoder or decoder besides the port's).

The stream trains through data/loaders/scannet.py -> ScanNetDataset
(`dataset.type: scannet`, `dataset.basedir <out>/scene.sens`). With 14
frames, validation reads frames 1 and 9 and test frames 2 and 10.

Usage (needs JAX and PIL, so it runs on the CPU host, not the card's):
  python scripts/make_scannet_scene.py --out data/hard_scannet
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import sys
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

COLOR_HW = (968, 1296)
DEPTH_HW = (480, 640)
# Near ScanNet's colour intrinsics (scene0000_00: fx 1169.6, fy 1167.1,
# cx 646.3, cy 489.9).
FX, FY, CX, CY = 1169.6, 1167.1, 646.3, 489.9


def orbit_pose(theta: float, elevation: float, radius: float):
    """OpenCV camera-to-world looking at the origin from the orbit point at
    azimuth theta and elevation (radians) in the scene's z-up world."""
    import numpy as np

    eye = radius * np.array([np.cos(theta) * np.cos(elevation),
                             np.sin(theta) * np.cos(elevation), np.sin(elevation)])
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, forward, eye
    return c2w


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/hard_scannet")
    ap.add_argument("--n", type=int, default=14)
    ap.add_argument("--lost", type=int, default=5, help="the frame whose pose is -inf")
    ap.add_argument("--quality", type=int, default=90, help="JPEG quality")
    ap.add_argument("--gt-samples", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=16384, help="rays per render step")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from nerfmeshes_tpu.data.loaders.scannet import RGBDFrame, write_sens
    from nerfmeshes_tpu.data.synthetic import render_ground_truth
    from nerfmeshes_tpu.ops.rays import CameraIntrinsics, get_ray_bundle_intrinsics

    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = FX, FY, CX, CY
    Kd = K.copy()
    Kd[0] *= DEPTH_HW[1] / COLOR_HW[1]
    Kd[1] *= DEPTH_HW[0] / COLOR_HW[0]
    Kd[0, 3] = Kd[1, 3] = 0.0

    def intrinsics(mat):
        return CameraIntrinsics(fx=float(mat[0, 0]), fy=float(mat[1, 1]), cx=float(mat[0, 2]),
                                cy=float(mat[1, 2]), z_sign=1.0, flip_y=False, normalize=False)

    chunk = int(args.chunk)

    @jax.jit
    def render_chunk(o, d):
        return render_ground_truth(o, d, 2.0, 6.0, num_samples=args.gt_samples,
                                   with_depth=True, scene="hard")

    def render(hw, mat, pose):
        """(rgb (H, W, 3), z-depth (H, W)) of one camera, chunk by chunk."""
        origin, dirs = get_ray_bundle_intrinsics(hw[0], hw[1], intrinsics(mat),
                                                 jnp.asarray(pose, jnp.float32))
        dirs = np.asarray(dirs).reshape(-1, 3)
        n = dirs.shape[0]
        dirs = np.concatenate([dirs, np.repeat(dirs[-1:], (-n) % chunk, 0)])
        rgb, depth = [], []
        for s in range(0, dirs.shape[0], chunk):
            d = jnp.asarray(dirs[s:s + chunk])
            c, z = render_chunk(jnp.broadcast_to(origin, d.shape), d)
            rgb.append(np.asarray(c))
            depth.append(np.asarray(z))
        return (np.concatenate(rgb)[:n].reshape(*hw, 3), np.concatenate(depth)[:n].reshape(hw))

    rng = np.random.default_rng(12)
    frames, digests = [], []
    for i in range(args.n):
        theta = 2.0 * np.pi * i / args.n + rng.uniform(-0.1, 0.1)
        elevation = np.deg2rad(rng.uniform(18.0, 38.0))
        pose = orbit_pose(theta, elevation, 4.0 + rng.uniform(-0.2, 0.2))
        rgb, _ = render(COLOR_HW, K, pose)
        _, depth = render(DEPTH_HW, Kd, pose)
        buf = io.BytesIO()
        Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=args.quality, subsampling=2)
        jpeg = buf.getvalue()
        depth_mm = np.round(np.clip(depth, 0.0, 65.535) * 1000.0).astype(np.uint16)
        c2w = np.full((4, 4), -np.inf, np.float32) if i == args.lost else pose.astype(np.float32)
        frames.append(RGBDFrame(c2w, i * 33333, i * 33333, jpeg,
                                zlib.compress(depth_mm.tobytes())))
        pixels = np.asarray(Image.open(io.BytesIO(jpeg)))
        digests.append({"frame": i, "shape": list(pixels.shape), "jpeg_bytes": len(jpeg),
                        "sha256": hashlib.sha256(pixels.tobytes()).hexdigest()})
        print(f"frame {i + 1}/{args.n}: {len(jpeg)} B of JPEG, depth hit "
              f"{(depth_mm > 0).mean():.3f}", flush=True)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    write_sens(str(out / "scene.sens"), frames, sensor_name="hard_scannet", intrinsic_color=K,
               intrinsic_depth=Kd, color_size=COLOR_HW[::-1], depth_size=DEPTH_HW[::-1],
               depth_shift=1000.0)
    (out / "digests.json").write_text(json.dumps({
        "decoder": "PIL (libjpeg-turbo), default settings", "quality": args.quality,
        "subsampling": "4:2:0", "frames": digests}, indent=1) + "\n")
    size = (out / "scene.sens").stat().st_size
    print(f"ScanNet stream at {out}/scene.sens: {args.n} frames, {size} B")


if __name__ == "__main__":
    main()
