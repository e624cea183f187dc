#!/usr/bin/env python3
"""Where the fused mesh of ``fuse-mesh`` goes wrong, on the rendered 1280x960
three-sensor workspace of ``chip_smoke.py`` (whose helpers this script
drives; run it from the root of a checkout, on a machine with a CUDA card).

    python3 scripts/torch_dense_probe.py [--pairs] [--unchecked] [--extra <fuse-mesh flags>]

Runs ``fuse-mesh`` with the flags of chip_smoke.py phase 7 (with
``--unchecked``, without its ``--left_right_check``: the reference tool's
stereo; plus ``--extra``), then prints for every pair its baseline, its raw and filtered
point counts and the vertical error of its filtered cloud against the
analytic terrain (median |error|, the shares more than 5 cm below and above
it), and the fused mesh's error (median, 90th percentile, share within
2 cm). Then it fuses subsets of the same clouds again (``--first_step
mesh_gen`` on copies of the pair directories): the pairs of each sensor
alone, and the pairs with a baseline under 0.7 m, and prints the same mesh
errors for each.

With ``--pairs`` it studies one nav_cam pair (0.45 m baseline) alone instead:
the vertical error of its stereo cloud (valid share, median |error|, shares
more than 5 cm below and above the terrain) for plane_sweep on the card
(float32) and on the CPU (float64), at full, half and quarter resolution
(2x2 and 4x4 block means), winner-take-all and SGM, several correlation
window radii and SGM penalties, and with the left-right check.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def cloud_stats(pair_dir: Path, name: str):
    import numpy as np
    from multiview_tpu_torch.io import depth_io
    from multiview_tpu_torch.utils.synthetic import terrain_height

    xyz, _ = depth_io.read_pcd(pair_dir / name)
    c2w = np.loadtxt(pair_dir / "run_cam2world.txt")
    w = xyz @ c2w[:3, :3].T + c2w[:3, 3]
    e = w[:, 2] - terrain_height(w[:, 0], w[:, 1])
    return len(e), float(np.median(np.abs(e))), float((e < -0.05).mean()), float((e > 0.05).mean())


def mesh_stats(path: Path) -> str:
    import numpy as np
    from multiview_tpu_torch.io import ply
    from multiview_tpu_torch.utils.synthetic import terrain_height

    v = ply.read_ply(path)["vertices"]
    e = v[:, 2] - terrain_height(v[:, 0], v[:, 1])
    a = np.abs(e)
    return (f"{len(v)} vertices, |error| median {np.median(a):.5f} m, 90th percentile "
            f"{np.percentile(a, 90):.5f} m, within 0.02 m {(a < 0.02).mean():.4f}, more than "
            f"0.05 m below {(e < -0.05).mean():.4f}, above {(e > 0.05).mean():.4f}")


def pair_study(torch, card, tmp: Path):
    """One nav_cam pair under stereo variants (see the module docstring)."""
    import numpy as np
    import chip_smoke as cs
    from multiview_tpu_torch.dense import stereo
    from multiview_tpu_torch.geometry import pose as P
    from multiview_tpu_torch.io import nvm as nvm_io
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils import images, synthetic as syn
    from multiview_tpu_torch.utils.synthetic import terrain_height

    ws = tmp / "ws_pair"
    syn.build_rig_workspace(ws, 3, cs.SIZE, cs.FOCAL, workers=3)
    names, mats = nvm_io.read_camera_poses(ws / "cameras.txt")
    nav = [i for i, n in enumerate(names) if Path(n).parent.name == "nav_cam"][:2]
    full = [common.load_gray(names[i]).astype(np.float64) for i in nav]
    w2c = [P.matrix_to_pose(torch.as_tensor(mats[i])) for i in nav]
    r2n = P.pose_compose(w2c[1], P.pose_inverse(w2c[0])).numpy()
    c2w = np.linalg.inv(mats[nav[0]])
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")

    def run(label, factor=1, device=cuda, radius=3, lr=False, **kw):
        W, H = cs.SIZE[0] // factor, cs.SIZE[1] // factor
        imgs = [images.adjust_image_size((W, H), im) for im in full]
        f = np.array([cs.FOCAL, cs.FOCAL]) / factor
        c = (np.array([cs.SIZE[0] / 2.0, cs.SIZE[1] / 2.0]) - 0.5 * (factor - 1)) / factor
        dt = torch.float32 if device.type == "cuda" else torch.float64
        a, b = (torch.as_tensor(i, dtype=dt, device=device) for i in imgs)
        sweep = dict(min_depth=1.5, max_depth=3.0, num_planes=64, radius=radius, **kw)
        res = stereo.plane_sweep(a, b, f, c, r2n, **sweep)
        if lr:
            back = stereo.plane_sweep(b, a, f, c, P.pose_inverse(torch.as_tensor(r2n)).numpy(),
                                      **sweep)
            res = stereo.left_right_check(res, back, f, c, r2n)
        pts = stereo.stereo_pair_to_cloud(res, f, c)
        w = pts @ c2w[:3, :3].T + c2w[:3, 3]
        e = w[:, 2] - terrain_height(w[:, 0], w[:, 1])
        print(f"[probe pair] {label}: {W}x{H} on {device.type}, radius {radius}, {kw or ''}"
              f"{' left-right check' if lr else ''}: valid {len(e) / (W * H):.4f}, |error| "
              f"median {np.median(np.abs(e)):.5f} m, more than 0.05 m below "
              f"{(e < -0.05).mean():.4f}, above {(e > 0.05).mean():.4f} [{card}]", flush=True)

    sgm = dict(aggregate="sgm")
    run("phase 7's settings", **sgm)
    run("phase 7's settings", device=cpu, **sgm)
    run("winner-take-all")
    for factor in (2, 4):
        run("block means", factor=factor, **sgm)
    for radius in (5, 8):
        run("wider window", radius=radius, **sgm)
    run("stronger SGM penalties", sgm_p1=0.1, sgm_p2=1.0, **sgm)
    run("left-right check", lr=True, **sgm)
    run("wider window, left-right check", radius=8, lr=True, **sgm)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", action="store_true",
                    help="study one pair's stereo variants instead of the fused mesh")
    ap.add_argument("--unchecked", action="store_true",
                    help="fuse the depths without the left-right check, as the reference does")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="further fuse-mesh flags, passed through to every run")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_dense_probe.py: no CUDA device; this script only runs on the GPU")
    import chip_smoke as cs
    from multiview_tpu_torch.io import nvm as nvm_io

    card = cs.card_line()
    with tempfile.TemporaryDirectory(prefix="mv_dense_probe_") as tmp:
        tmp = Path(tmp)
        if args.pairs:
            pair_study(torch, card, tmp)
            return 0
        if args.unchecked:
            cs.FUSE_FLAGS.remove("--left_right_check")
        cs.render_workspaces(tmp)
        ws, out = tmp / "ws3", tmp / "fused"
        wall, text = cs.fuse_mesh(torch, out, ws, args.extra)
        print(f"[probe] fuse-mesh {' '.join(cs.FUSE_FLAGS + args.extra)}: wall {wall:.2f} s; "
              f"mesh {mesh_stats(out / 'fused_mesh.ply')} [{card}]", flush=True)
        names, mats = nvm_io.read_camera_poses(ws / "cameras.txt")
        centre = {Path(n).stem: -M[:3, :3].T @ M[:3, 3] for n, M in zip(names, mats)}
        pairs = sorted(out.glob("*/stereo/*"))
        baseline = {}
        for d in pairs:
            a, b = d.name.split("_")
            baseline[d] = float(np.linalg.norm(centre[a] - centre[b]))
            raw = cloud_stats(d, "run-PC.pcd")
            filt = cloud_stats(d, "run-PC-filter.pcd")
            print(f"[probe] {d.parent.parent.name} {d.name}: baseline {baseline[d]:.3f} m; "
                  f"points {raw[0]} raw, {filt[0]} filtered; filtered cloud |error| median "
                  f"{filt[1]:.5f} m, more than 0.05 m below {filt[2]:.4f}, above {filt[3]:.4f} "
                  f"(raw: {raw[1]:.5f}, {raw[2]:.4f}, {raw[3]:.4f})", flush=True)
        subsets = {s: [d for d in pairs if d.parent.parent.name == s]
                   for s in ("nav_cam", "sci_cam", "haz_cam")}
        subsets["baseline under 0.7 m"] = [d for d in pairs if baseline[d] < 0.7]
        for label, sel in subsets.items():
            sub = tmp / "subset"
            shutil.rmtree(sub, ignore_errors=True)
            for d in sel:
                shutil.copytree(d, sub / d.relative_to(out))
            wall, _ = cs.fuse_mesh(torch, sub, ws, args.extra + ["--first_step", "mesh_gen"])
            print(f"[probe] mesh_gen from {len(sel)} pairs ({label}): wall {wall:.2f} s; "
                  f"{mesh_stats(sub / 'fused_mesh.ply')} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
