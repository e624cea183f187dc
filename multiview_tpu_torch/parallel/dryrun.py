"""Multi-device dry run: the port's counterpart of
``__graft_entry__.py::dryrun_multichip``.

    python -m multiview_tpu_torch.parallel.dryrun 8 --device cpu

runs one Schur-LM step of a cube scene with its observations sharded n ways,
one TSDF update of a slab-sharded grid, the same BA step and TSDF update on
an (n/4 x 4) host x chip mesh held to the 1-D ones, and the sharded
front-end matcher held bit for bit to the unsharded one. With ``--device``
the n shards are logical shards of that one device; without it they are the
first n CUDA cards.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.dense import tsdf
from multiview_tpu_torch.parallel import sharding as sh
from multiview_tpu_torch.sfm import pipeline as fe
from multiview_tpu_torch.solver import schur
from multiview_tpu_torch.utils import synthetic as syn
from multiview_tpu_torch.utils.device import resolve_device


def _devices(n_devices: int, device):
    if device is not None:
        return [resolve_device(device)] * n_devices
    count = torch.cuda.device_count()
    if count < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards, "
                           f"found {count}; name a device to run logical shards on it")
    return [torch.device("cuda", i) for i in range(n_devices)]


def _ba_step(scene, state0, mesh):
    obs = sh.shard_observations(scene.observations, mesh)
    state = sh.replicate(state0, mesh)
    cam_mask = prob.build_mask(state, prob.FloatSpec(cam_poses=True, focal=(0,)),
                               no_rig=True, include_points=False)
    solver = schur.make_schur_solver(state, obs, scene.models, prob.BAOptions(no_rig=True),
                                     cam_mask, max_iterations=1, cg_iterations=10)
    return solver(prob.pack_state(state, include_points=False), state.points, obs)


def _tsdf_update(shape, mesh):
    grid = tsdf.make_grid(shape, origin=(-1.0, -1.0, -1.0), voxel_size=0.125, truncation=0.4,
                          device=mesh.lead)
    depth = torch.full((48, 64), 1.5, dtype=torch.float32, device=mesh.lead)
    args = (depth, (60.0, 60.0), (32.0, 24.0), torch.tensor([0, 0, -2.0, 0, 0, 0, 1.0]))
    whole = tsdf.integrate_depth_image(grid, *args)
    sharded = tsdf.integrate_depth_image(sh.shard_tsdf_grid(grid, mesh), *args).gather()
    if not (torch.equal(sharded.tsdf, whole.tsdf) and torch.equal(sharded.weight, whole.weight)):
        raise AssertionError("sharded TSDF update differs from the whole grid's")
    hits = float(sharded.weight.sum())
    if not hits > 0:
        raise AssertionError("sharded TSDF update touched nothing")
    return hits


def _frontend_images():
    rng = np.random.default_rng(0)
    sm = rng.uniform(size=(112, 112)).astype(np.float32)
    for _ in range(2):
        sm = 0.25 * (np.roll(sm, 1, 0) + np.roll(sm, -1, 0)
                     + np.roll(sm, 1, 1) + np.roll(sm, -1, 1))
    return [np.ascontiguousarray(sm[i:i + 96, 2 * i:2 * i + 96]) for i in range(6)]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded BA step, TSDF update and front-end match over ``n_devices``
    shards (logical shards of ``device``, or the first n CUDA cards). Raises
    where a sharded result is not finite or disagrees with its reference;
    returns what it measured."""
    devices = _devices(n_devices, device)
    mesh = sh.make_mesh(devices)
    dtype = torch.float32
    scene = syn.make_cube_scene(n_images=8, n_per_face=3, dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4),
                                pix_noise=0.3, dtype=dtype, device=mesh.lead)
    state0 = syn.perturb_state(scene.true_state, pose_rot=0.005, pose_trans=0.01,
                               point_sigma=0.01)
    out = {}
    res = _ba_step(scene, state0, mesh)
    c0, c1 = float(res.initial_cost), float(res.cost)
    if not np.isfinite(c1):
        raise AssertionError("multichip dry run produced a non-finite cost")
    out["ba_1d"] = (c0, c1)
    out["tsdf_1d_hits"] = _tsdf_update((16 * n_devices, 16, 16), mesh)
    print(f"dryrun_multichip({n_devices}): cost {c0:.4g} -> {c1:.4g} on mesh {mesh.shape}; "
          f"sharded TSDF update {out['tsdf_1d_hits']:.0f} voxel hits")

    if n_devices >= 4 and n_devices % 4 == 0:
        # the 2-D host x chip layout reproduces the 1-D results (the bars of
        # __graft_entry__.dryrun_multichip)
        mesh2 = sh.make_mesh_2d((n_devices // 4, 4), devices)
        res2 = _ba_step(scene, state0, mesh2)
        rel0 = abs(float(res2.initial_cost) - c0) / max(abs(c0), 1e-30)
        rel1 = abs(float(res2.cost) - c1) / max(abs(c1), 1e-30)
        cam_dev = float((res2.cam - res.cam).abs().max())
        if not (rel0 < 1e-4 and rel1 < 1e-6 and cam_dev < 1e-6):
            raise AssertionError(f"2-D mesh deviates: initial {rel0}, final {rel1}, "
                                 f"camera state {cam_dev}")
        out["ba_2d"] = (float(res2.initial_cost), float(res2.cost), cam_dev)
        out["tsdf_2d_hits"] = _tsdf_update((16 * (n_devices // 4), 16 * 4, 16), mesh2)
        print(f"dryrun_multichip({n_devices}): 2-D host x chip mesh {mesh2.shape} BA + "
              f"TSDF OK (cost {res2.initial_cost:.4g} -> {res2.cost:.4g})")

    imgs = _frontend_images()
    cfg = fe.FrontendConfig(max_features=128, num_overlaps=2)
    kps, descs = fe.detect_all(imgs, cfg, device=mesh.lead)
    pair_ids = [(i, j) for i in range(6) for j in range(i + 1, min(i + 3, 6))]
    single = fe.match_pairs_batched(kps, descs, pair_ids, cfg)
    sharded = fe.match_pairs_batched(kps, descs, pair_ids, cfg, mesh=mesh)
    if list(single) != list(sharded) or not single or not all(
            np.array_equal(a, b) for k in single for a, b in zip(single[k], sharded[k])):
        raise AssertionError("sharded front-end matching differs from the single-device one")
    out["frontend_pairs"] = len(single)
    print(f"dryrun_multichip({n_devices}): sharded front-end matching OK "
          f"({len(single)} pairs, bit-identical to single-device)")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", help="run the shards on this one device (e.g. cpu, cuda:0)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
