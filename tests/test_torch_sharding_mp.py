"""The port's multi-process sharded solve: two OS processes join a gloo
process group on localhost, each holds 4 of the 8 CPU shards of the cube
scene of tests/test_sharding.py::TestMultiProcess, and solve twice, the
second time after the deterministic outlier gate of
tests/mp_solver_worker.py has flagged the worst 10% of the pixel
observations (the mask update goes back onto each process's shards).

Bars: the two ranks bit for bit equal (cameras, points, costs, LM and CG
counts, both passes); against the single-process unsharded solve (float64),
the bars of TestMultiProcess: initial cost rtol 1e-10 (pass 2: 1e-8), final
cost rtol 1e-6, cameras rtol 1e-5 / atol 1e-7.

The worker is this file run as a script:

    python tests/test_torch_sharding_mp.py <rank> <world> <port> <out.npz>
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def _scene():
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.utils import synthetic as syn

    scene = syn.make_cube_scene(n_images=8, n_per_face=3, pix_noise=0.3,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), device="cpu")
    state0 = syn.perturb_state(scene.true_state)
    mask = prob.build_mask(state0, prob.FloatSpec(cam_poses=True), no_rig=True,
                           include_points=False)
    return scene, state0, mask, prob.BAOptions(no_rig=True)


def outlier_gate(res, state0, scene, opts) -> np.ndarray:
    """tests/mp_solver_worker.py::compute_outlier_gmask: keep the pixel
    observations whose unrobustified residual norm is at most the 90th
    percentile (the same replicated inputs give the same mask everywhere)."""
    import dataclasses
    from multiview_tpu_torch.calib import problem as prob

    st = dataclasses.replace(prob.unpack_state(res.cam, state0, include_points=False),
                             points=res.points)
    rn = np.concatenate([torch.linalg.norm(prob.pixel_residuals(
        st, o, scene.models[o.sensor], opts, robust=False), dim=-1).numpy()
        for o in scene.observations.pixels])
    return rn <= np.quantile(rn, 0.9)


def worker(rank: int, world: int, port: int, out: str):
    from multiview_tpu_torch.calib import calibrator as cal, problem as prob
    from multiview_tpu_torch.parallel import distributed as pdist, sharding as sh
    from multiview_tpu_torch.solver import schur

    torch.set_num_threads(1)
    active = pdist.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    assert active and pdist.process_count() == world and pdist.process_index() == rank
    mesh = sh.make_mesh(["cpu"] * 4, group=torch.distributed.group.WORLD)
    assert mesh.size == 4 * world and mesh.rank == rank
    scene, state0, mask, opts = _scene()
    obs = sh.shard_observations(scene.observations, mesh)
    solver = schur.make_schur_solver(state0, obs, scene.models, opts, mask,
                                     max_iterations=8, cg_iterations=30)
    cam0 = prob.pack_state(state0, include_points=False)
    res = solver(cam0, state0.points, obs)
    gmask = outlier_gate(res, state0, scene, opts)
    obs2 = cal._scatter_mask_updates(obs, gmask)
    for old, new in zip(obs.pixels, obs2.pixels):
        assert new.row_offsets == old.row_offsets and len(new.shards) == 4
        assert all(a.mask.device == b.mask.device for a, b in zip(old.shards, new.shards))
    assert np.array_equal(cal._global_mask(obs2).numpy(), gmask)
    res2 = solver(cam0, state0.points, obs2)
    np.savez(out, **{f"{k}{tag}": np.asarray(v) for tag, r in (("", res), ("2", res2))
                     for k, v in (("cam", r.cam), ("points", r.points), ("cost", r.cost),
                                  ("initial_cost", r.initial_cost), ("lam", r.lam),
                                  ("iterations", r.iterations),
                                  ("cg", r.cg_iters_total))},
             flagged=int((~gmask).sum()), size=mesh.size, world=pdist.process_count())
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


import pytest  # noqa: E402

from torch_port_scenes import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_two_process_solve_matches_single(tmp_path):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [tmp_path / f"rank{i}.npz" for i in range(2)]
    procs = [subprocess.Popen([sys.executable, "-u", __file__, str(i), "2", str(port),
                               str(outs[i])], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    r0, r1 = (dict(np.load(o)) for o in outs)
    assert int(r0["world"]) == 2 and int(r0["size"]) == 8
    assert int(r0["flagged"]) > 0, "the gate flagged nothing; the mask update is untested"
    assert r0.keys() == r1.keys()
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)     # bit for bit

    from multiview_tpu_torch.calib import calibrator as cal, problem as prob
    from multiview_tpu_torch.solver import schur
    scene, state0, mask, opts = _scene()
    solver = schur.make_schur_solver(state0, scene.observations, scene.models, opts, mask,
                                     max_iterations=8, cg_iterations=30)
    cam0 = prob.pack_state(state0, include_points=False)
    ref = solver(cam0, state0.points)
    gmask = outlier_gate(ref, state0, scene, opts)
    assert int((~gmask).sum()) == int(r0["flagged"])
    ref2 = solver(cam0, state0.points, cal._scatter_mask_updates(scene.observations, gmask))
    for tag, r, initial in (("", ref, 1e-10), ("2", ref2, 1e-8)):
        assert int(r0["iterations" + tag]) == r.iterations
        np.testing.assert_allclose(float(r0["initial_cost" + tag]), float(r.initial_cost),
                                   rtol=initial)
        np.testing.assert_allclose(float(r0["cost" + tag]), float(r.cost), rtol=1e-6)
        np.testing.assert_allclose(r0["cam" + tag], r.cam.numpy(), rtol=1e-5, atol=1e-7)
