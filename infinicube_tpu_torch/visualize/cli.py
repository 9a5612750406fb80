"""The viewers: vis-grid, vis-compare, vis-wds and vis-dynamic; counterpart
of ``infinicube_tpu/visualize/cli.py``. viser's interactive viewer when viser
is installed, offscreen orbit renders otherwise (``visualize/render.py``),
on the card unless ``--device cpu``; they write the files the JAX tools
write (pngs through the port's own encoder, ``data.codec.encode_png``:
the card's machine has no PIL).

Usage:
  python -m infinicube_tpu_torch.visualize.cli grid world.npz --output out/
  python -m infinicube_tpu_torch.visualize.cli compare gt.npz pred.npz
  python -m infinicube_tpu_torch.visualize.cli wds data/waymo <clip>
  python -m infinicube_tpu_torch.visualize.cli dynamic static.pkl \\
      --objects_pkl objects.pkl --object_tracks tracks.npz
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from infinicube_tpu_torch.data.codec import encode_png
from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.visualize.render import (
    HAS_VISER, orbit_poses, render_gaussian_scene, render_voxel_points,
    transform_gaussians)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def _parse(ap: argparse.ArgumentParser, argv):
    """The arguments, the device resolved before any file is read."""
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def _load_grid(path):
    d = np.load(path)
    return d["ijk"], d["semantics"], d["voxel_size"], \
        d["origin"] if "origin" in d else d["voxel_size"] / 2


def _grid_orbit_images(path, n, device):
    ijk, sem, vs, org = _load_grid(path)
    pts = ijk * vs + org
    center = pts.mean(0)
    radius = max(np.abs(pts - center).max() * 1.5, 5.0)
    return [render_voxel_points(ijk, sem, vs, org, pose, device=device)
            for pose in orbit_poses(center, radius, radius * 0.6, n)]


def vis_grid(argv=None):
    """vis-grid: orbit renders of one grid npz, ``view_XX.png``."""
    ap = _parser()
    ap.add_argument("grid")
    ap.add_argument("--output", default="visualization/grid")
    ap.add_argument("--views", type=int, default=4)
    args = _parse(ap, argv)
    if HAS_VISER:  # pragma: no cover
        _serve_viser_points(*_load_grid(args.grid))
        return
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(_grid_orbit_images(args.grid, args.views,
                                               args.device)):
        (out / f"view_{i:02d}.png").write_bytes(encode_png(img))
    print(f"renders -> {out}")


def vis_compare(argv=None):
    """vis-compare: ground truth and prediction(s) side by side, one row of
    two orbit views each, ``compare.png``."""
    ap = _parser()
    ap.add_argument("grids", nargs="+")
    ap.add_argument("--output", default="visualization/compare")
    args = _parse(ap, argv)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    rows = [np.concatenate(_grid_orbit_images(g, 2, args.device), axis=1)
            for g in args.grids]
    (out / "compare.png").write_bytes(encode_png(np.concatenate(rows, 0)))
    print(f"comparison -> {out / 'compare.png'}")


def vis_wds(argv=None):
    """vis-wds: a clip's LiDAR frame coloured by semantics,
    ``<clip>_<frame>.png``."""
    ap = _parser()
    ap.add_argument("root")
    ap.add_argument("clip")
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--output", default="visualization/wds")
    args = _parse(ap, argv)
    from infinicube_tpu_torch.data.codec import decode_member
    from infinicube_tpu_torch.data.tario import TarReader
    root = Path(args.root)
    with TarReader(root / "pc" / f"{args.clip}.tar") as r:
        pc = decode_member("npz", r.read(f"{args.frame:06d}.npz"))
    pts = pc["xyz"]
    sem = pc["semantic"] if "semantic" in pc else np.zeros(len(pts))
    center = pts.mean(0)
    pose = orbit_poses(center, 40.0, 25.0, 1)[0]
    img = render_voxel_points(pts / 0.2, sem, 0.2, 0.0, pose,
                              device=args.device)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.clip}_{args.frame:06d}.png").write_bytes(encode_png(img))
    print(f"render -> {out}")


def vis_dynamic(argv=None):
    """vis-dynamic: the static gaussians with each object's moved by its
    track, rendered along an orbit into a video."""
    ap = _parser()
    ap.add_argument("static_pkl")
    ap.add_argument("--objects_pkl", default=None)
    ap.add_argument("--object_tracks", default=None,
                    help="npz gid -> [T,4,4] object poses")
    ap.add_argument("--output", default="visualization/dynamic.mp4")
    ap.add_argument("--frames", type=int, default=24)
    args = _parse(ap, argv)
    from infinicube_tpu_torch.utils.gaussian_io import load_pkl
    static = load_pkl(args.static_pkl)
    objects = load_pkl(args.objects_pkl) if args.objects_pkl else {}
    tracks = dict(np.load(args.object_tracks)) if args.object_tracks else {}
    center = static["means"].mean(0)
    radius = max(np.abs(static["means"] - center).max(), 10.0)
    frames = []
    poses = orbit_poses(center, radius, radius * 0.5, args.frames)
    for t, pose in enumerate(poses):
        g = static
        for gid, od in objects.items():
            tr = tracks.get(str(gid))
            od_t = transform_gaussians(od, tr[t % len(tr)]) if tr is not None \
                else od
            g = {k: np.concatenate([g[k], od_t[k]]) for k in g}
        frames.append(render_gaussian_scene(g, pose, device=args.device))
    from infinicube_tpu_torch.utils.fileio import write_video
    write_video(args.output, np.stack(frames))
    print(f"video -> {args.output}")


def _serve_viser_points(ijk, sem, vs, org):  # pragma: no cover
    import time

    import viser

    from infinicube_tpu_torch.utils.semantic import semantic_to_color
    server = viser.ViserServer()
    pts = ijk * vs + org
    server.scene.add_point_cloud("grid", points=pts.astype(np.float32),
                                 colors=semantic_to_color(sem),
                                 point_size=float(np.mean(vs)))
    print("viser running; ctrl-c to exit")
    while True:
        time.sleep(1)


TOOLS = {"grid": vis_grid, "compare": vis_compare, "wds": vis_wds,
         "dynamic": vis_dynamic}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in TOOLS:
        raise SystemExit(f"usage: python -m infinicube_tpu_torch.visualize."
                         f"cli {{{','.join(TOOLS)}}} ...")
    TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
