"""The LM iteration's step and accept of the port's Schur-LM
(``solver/lm_step.py``), on the CPU.

- The plain ``trial`` and ``accept`` against a float64 NumPy transcription
  of the reference's LM body (``multiview_tpu/solver/schur.py:1241-1295``)
  on seeded inputs: an accepted step, a rejected one, a non-finite trial
  cost, |pred| under the 1e-30 clamp, lam above 1e12 and a relative decrease
  under 1e-10 (with and without bounds, with Jd's rows given as "cg" gives
  them). The decisions, the counters and the selected state are equal; the
  scalars agree to 1e-12 relative (the same float64 sums, in NumPy's
  order; the residuals are dyadic, so the costs are exact in both).
- ``halt``: the plain versions do nothing once it is set, and leave it
  unset where the caller does not ask for it.
- The port's CPU solve against the JAX package's solver (CPU, x64) on the
  graft scene, stopping before ``max_iterations``: the same LM and CG
  counts, cost, lam, cameras and points (1e-10: the two packages' float64
  sums in other orders).
- The same solve with the host reading the LM state at every iteration and
  every second one (``LM_CHECK_EVERY`` 1 and 2): bit for bit equal, and no
  assembly after done.
- The kernel paths refuse a state on the CPU before any build."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from multiview_tpu.calib import problem as JPr
from multiview_tpu.solver import schur as JS
from multiview_tpu_torch.calib import problem as TPr
from multiview_tpu_torch.parallel.sharding import ShardMesh
from multiview_tpu_torch.solver import assembly as asm, lm_step as lm, schur as TS
from multiview_tpu_torch.utils import cuda_build
from torch_port_scenes import one_torch_thread, port_problem  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

C, P = 17, 6
# (rows, components a row, has a camera block, has a point block) of the families
FAMILIES = ((9, 2, True, True), (4, 3, True, False), (3, 3, False, True))


def _inputs(seed: int, bounded: bool = False):
    """Seeded inputs of one iteration's trial and accept (float64 NumPy)."""
    g = np.random.default_rng(seed)
    fams = []
    for n, k, cam, pt in FAMILIES:
        fams.append(dict(n=n, k=k, jc=g.normal(size=(n, k, 16)) if cam else None,
                         jp=g.normal(size=(n, k, 3)) if pt else None,
                         pidx=g.integers(0, P, n)))
    rows = sum(n * k for n, k, _, _ in FAMILIES)
    A = g.normal(size=(P, 3, 3))
    x = dict(cam=g.normal(size=C), points=g.normal(size=(P, 3)), x=0.1 * g.normal(size=C),
             cam_free=(g.uniform(size=C) > 0.2).astype(float),
             hpp_inv=A @ A.transpose(0, 2, 1) + 3 * np.eye(3), g_p=g.normal(size=(P, 3)),
             jtp_u=g.normal(size=(P, 3)), g_c=g.normal(size=C),
             cam_diag=g.uniform(0.5, 2.0, C), pt_diag=g.uniform(0.5, 2.0, (P, 3)),
             u=g.normal(size=rows), fams=fams, lower=None, upper=None,
             # dyadic residuals: |r|^2 is exact in any order, so the costs'
             # difference (rho, rel_decrease) is not a cancellation of two
             # sums taken in other orders
             r=g.integers(-64, 64, rows) / 16.0, r_t=g.integers(-32, 32, rows) / 16.0)
    x["J_t"] = [(None if f["jc"] is None else g.normal(size=f["jc"].shape),
                 None if f["jp"] is None else g.normal(size=f["jp"].shape)) for f in fams]
    if bounded:
        x["lower"] = x["cam"] - 0.05
        x["upper"] = x["cam"] + 0.05
    return x


def _trial_np(x):
    """The reference's trial point (:1241-1250)."""
    dp = np.einsum("pij,pj->pi", x["hpp_inv"], -x["g_p"] - x["jtp_u"])
    cam_new = x["cam"] + x["x"] * x["cam_free"]
    if x["lower"] is not None:
        cam_new = np.clip(cam_new, x["lower"], x["upper"])
    return cam_new, x["points"] + dp, dp, cam_new - x["cam"]


def _accept_np(x, cost, lam, nu, u, trial):
    """The reference's accept (:1251-1295) in float64: the scalars and the
    selected state."""
    cam_new, pts_new, dp, step_c = trial
    new_cost = 0.5 * np.sum(x["r_t"] ** 2)
    parts = []
    off = 0
    for f in x["fams"]:
        m = f["n"] * f["k"]
        jd = u[off:off + m].reshape(f["n"], f["k"]).copy()
        if f["jp"] is not None:
            jd += np.einsum("nkj,nj->nk", f["jp"], dp[f["pidx"]])
        parts.append(jd.reshape(-1))
        off += m
    Jd = np.concatenate(parts)
    pred = -(np.sum(step_c * x["g_c"]) + np.sum(dp * x["g_p"])) - 0.5 * np.sum(Jd * Jd) \
        - 0.5 * lam * (np.sum(x["cam_diag"] * step_c * step_c) + np.sum(x["pt_diag"] * dp * dp))
    with np.errstate(invalid="ignore", over="ignore"):
        good = bool(new_cost < cost and np.isfinite(new_cost))
        rho = (cost - new_cost) / max(abs(pred), 1e-30)
        lam_dec = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam_new = max(lam_dec, 1e-14) if good else lam * nu
        nu_new = 2.0 if good else nu * 2.0
        rel = abs(cost - new_cost) / max(cost, 1e-30)
    done = (good and rel < 1e-10) or lam > 1e12
    return dict(new_cost=new_cost, pred=pred, good=good, rho=rho, lam=lam_new, nu=nu_new,
                rel=rel, done=done, cost=new_cost if good else cost, Jd=Jd,
                cam=cam_new if good else x["cam"], points=pts_new if good else x["points"])


def _port(x, jd_given: bool = False):
    """The inputs as the port's accept takes them (one shard on the CPU)."""
    t = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    fams = [types.SimpleNamespace(point_idx=torch.as_tensor(f["pidx"])) for f in x["fams"]]
    J = [([t(f["jc"]) for f in x["fams"]], [t(f["jp"]) for f in x["fams"]])]
    J_t = [([t(a) for a, _ in x["J_t"]], [t(b) for _, b in x["J_t"]])]
    return fams, J, J_t, {k: t(v) for k, v in x.items()
                          if k not in ("fams", "J_t") and not isinstance(v, list)}


CASES = {
    "accepted": dict(cost=lambda nc: 3.0 * nc),
    "rejected": dict(cost=lambda nc: 0.5 * nc),
    "non-finite trial cost": dict(cost=lambda nc: 3.0 * nc, r_t_inf=True),
    "pred under the clamp": dict(cost=lambda nc: 3.0 * nc, zero_step=True),
    "lam above 1e12": dict(cost=lambda nc: 0.5 * nc, lam=2e12),
    "relative decrease under 1e-10": dict(cost=lambda nc: nc * (1.0 + 1e-12)),
}


def _scalars_close(got, want, rtol=1e-12):
    if not np.isfinite(want):
        assert got == want or (np.isnan(got) and np.isnan(want)), (got, want)
        return
    assert abs(got - want) <= rtol * abs(want) + 1e-300, (got, want)


@pytest.mark.parametrize("bounded", [False, True], ids=["unbounded", "bounded"])
@pytest.mark.parametrize("jd_given", [False, True], ids=["u", "Jd given"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_trial_and_accept_match_the_reference_body(case, jd_given, bounded):
    spec = CASES[case]
    x = _inputs(list(CASES).index(case), bounded)
    if spec.get("zero_step"):
        x["x"][:] = 0.0
        x["jtp_u"] = -x["g_p"]
        x["u"][:] = 0.0
    if spec.get("r_t_inf"):
        x["r_t"][3] = np.inf
    mesh = ShardMesh((torch.device("cpu"),))
    fams, J, J_t, tx = _port(x)
    st = lm.LMState(torch.float64, "cpu")
    lm.init(st, mesh, [tx["r"]], 1e-4)
    assert float(st.values[lm.COST]) == float(st.values[lm.C0]) == pytest.approx(
        0.5 * np.sum(x["r"] ** 2), rel=1e-14)
    new_cost = 0.5 * np.sum(x["r_t"] ** 2)
    cost = spec["cost"](new_cost if np.isfinite(new_cost) else 0.5 * np.sum(x["r"] ** 2))
    lam, nu = spec.get("lam", 3e-3), 4.0
    st.values[lm.COST], st.values[lm.LAM], st.values[lm.NU] = cost, lam, nu
    st.values[lm.ITER], st.values[lm.CG_TOTAL] = 5, 40

    t = lm.trial(st, tx["cam"], tx["points"], tx["x"], tx["cam_free"], tx["lower"], tx["upper"],
                 tx["hpp_inv"], tx["g_p"], tx["jtp_u"])
    ref_t = _trial_np(x)
    for got, want in zip(t, ref_t):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    ref = _accept_np(x, cost, lam, nu, x["u"], ref_t)
    jd = [torch.as_tensor(ref["Jd"])] if jd_given else None
    cam, points, Jn, rn = lm.accept(st, mesh, [fams], 0, J, [tx["r"]], J_t, [tx["r_t"]], t,
                                    tx["cam"], tx["points"], tx["g_c"], tx["g_p"],
                                    tx["cam_diag"], tx["pt_diag"],
                                    None if jd_given else [tx["u"]], jd,
                                    torch.tensor(7), True)
    v = st.values
    assert bool(v[lm.GOOD]) == ref["good"] and bool(v[lm.DONE]) == ref["done"]
    assert bool(st.halt) == ref["done"]
    assert int(v[lm.ITER]) == 6 and int(v[lm.CG_TOTAL]) == 47
    for slot, key in ((lm.NEW_COST, "new_cost"), (lm.PRED, "pred"), (lm.RHO, "rho"),
                      (lm.LAM, "lam"), (lm.NU, "nu"), (lm.REL, "rel"), (lm.COST, "cost")):
        _scalars_close(float(v[slot]), ref[key])
    assert float(st.lam) == float(v[lm.LAM]) and float(st.cost) == float(v[lm.COST])
    np.testing.assert_array_equal(cam.numpy(), t.cam.numpy() if ref["good"] else x["cam"])
    np.testing.assert_array_equal(points.numpy(), t.points.numpy() if ref["good"]
                                  else x["points"])
    want_J = J_t if ref["good"] else J
    for got_side, want_side in zip(Jn[0], want_J[0]):
        for a, b in zip(got_side, want_side):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    assert torch.equal(rn[0], tx["r_t"] if ref["good"] else tx["r"])


def test_the_plain_versions_honour_halt():
    x = _inputs(7)
    mesh = ShardMesh((torch.device("cpu"),))
    fams, J, J_t, tx = _port(x)
    st = lm.LMState(torch.float64, "cpu")
    lm.init(st, mesh, [tx["r"]], 1e-4)
    args = (tx["cam"], tx["points"], tx["x"], tx["cam_free"], None, None, tx["hpp_inv"],
            tx["g_p"], tx["jtp_u"])
    t = lm.trial(st, *args)
    st.values[lm.COST] = 0.0                  # every step rejected: never done by decrease
    st.values[lm.LAM] = 2e12                  # done
    # gate off (debug_unroll_lm): done, but nothing halts
    lm.accept(st, mesh, [fams], 0, J, [tx["r"]], J_t, [tx["r_t"]], t, tx["cam"], tx["points"],
              tx["g_c"], tx["g_p"], tx["cam_diag"], tx["pt_diag"], [tx["u"]], None, None, False)
    assert bool(st.values[lm.DONE]) and not bool(st.halt) and not lm.halted(st)
    lm.accept(st, mesh, [fams], 0, J, [tx["r"]], J_t, [tx["r_t"]], t, tx["cam"], tx["points"],
              tx["g_c"], tx["g_p"], tx["cam_diag"], tx["pt_diag"], [tx["u"]], None, None, True)
    assert bool(st.halt) and lm.halted(st) and lm.read(st) == (True, 2, 0)
    before = st.values.clone()
    assert lm.trial(st, *args) is None
    out = lm.accept(st, mesh, [fams], 0, J, [tx["r"]], J_t, [tx["r_t"]], t, tx["cam"],
                    tx["points"], tx["g_c"], tx["g_p"], tx["cam_diag"], tx["pt_diag"],
                    [tx["u"]], None, torch.tensor(9), True)
    assert torch.equal(st.values, before) and out[0] is tx["cam"] and out[2] is J
    # a singular block raises at the read
    st.singular.fill_(1)
    with pytest.raises(torch.linalg.LinAlgError):
        lm.read(st)


def test_the_kernel_paths_refuse_a_cpu_state(monkeypatch):
    monkeypatch.setattr(cuda_build, "load_library", lambda *a, **k: pytest.fail("built"))
    x = _inputs(3)
    fams, J, J_t, tx = _port(x)
    st = lm.LMState(torch.float64, "cpu")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        lm.trial_cuda(st, tx["cam"], tx["points"], tx["x"], tx["cam_free"], None, None,
                      tx["hpp_inv"], tx["g_p"], tx["jtp_u"])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        lm.init_cuda(st, ShardMesh((torch.device("cpu"),)), [tx["r"]], 1e-4)


KW = dict(max_iterations=40, cg_iterations=60, cg_tolerance=1e-2)


def _graft_scene():
    _, cam0, pts0, scene, state0 = graft._build(8, 3, jnp.float64)
    mask = JPr.build_mask(state0, JPr.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                          include_points=False)
    st, tobs = port_problem(state0, scene.observations)
    solver = TS.make_schur_solver(st, tobs, scene.models, TPr.BAOptions(no_rig=True), mask,
                                  **KW)
    return cam0, pts0, scene, state0, mask, st, solver


def test_the_solve_stops_early_as_the_reference_does():
    cam0, pts0, scene, state0, mask, st, solver = _graft_scene()
    jres = jax.jit(JS.make_schur_solver(state0, scene.observations, scene.models,
                                        JPr.BAOptions(no_rig=True), mask, **KW))(cam0, pts0)
    tres = solver(TPr.pack_state(st, include_points=False), st.points)
    assert 1 < tres.iterations == int(jres.iterations) < KW["max_iterations"]
    assert int(tres.cg_iters_total) == int(jres.cg_iters_total) > 0
    for got, want in ((tres.cost, jres.cost), (tres.initial_cost, jres.initial_cost),
                      (tres.lam, jres.lam)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    np.testing.assert_allclose(tres.cam.numpy(), np.asarray(jres.cam), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tres.points.numpy(), np.asarray(jres.points), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("mode", ["cg_blocks", "dense_schur"])
def test_reading_the_state_every_second_iteration_changes_nothing(monkeypatch, mode):
    """LM_CHECK_EVERY 1 against 2: the same result bit for bit, a read an
    iteration against one every second iteration and after the last on one
    shard of cg_blocks (dense_schur, whose dense solve cannot test the stop
    flag, reads every iteration), and no assembly past done (the iteration
    after an odd one's done is a no-op)."""
    _, _, scene, state0, mask, _, _ = _graft_scene()
    tst, tobs = port_problem(state0, scene.observations)
    calls = {"assemble": 0, "read": 0}
    assemble, read = asm.assemble, lm.read

    def spy_asm(*args):
        calls["assemble"] += 1
        return assemble(*args)

    def spy_read(*args):
        calls["read"] += 1
        return read(*args)

    monkeypatch.setattr(asm, "assemble", spy_asm)
    monkeypatch.setattr(lm, "read", spy_read)
    out = {}
    for every in (1, 2):
        monkeypatch.setattr(TS, "LM_CHECK_EVERY", every)
        calls.update(assemble=0, read=0)
        solver = TS.make_schur_solver(tst, tobs, scene.models, TPr.BAOptions(no_rig=True), mask,
                                      linear_solver=mode, **KW)
        res = solver(TPr.pack_state(tst, include_points=False), tst.points)
        out[every] = (res, dict(calls))
    (a, ca), (b, cb) = out[1], out[2]
    assert a.iterations == b.iterations < KW["max_iterations"]
    assert ca["assemble"] == cb["assemble"] == a.iterations
    assert ca["read"] == a.iterations
    assert cb["read"] == ((a.iterations + 1) // 2 if mode == "cg_blocks" else a.iterations)
    for name in ("cam", "points", "cost", "initial_cost", "lam", "cg_iters_total"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.matvecs == b.matvecs
