"""Batched-hypothesis RANSAC: a 2D affine map (the front end's match
filter), the essential matrix and the homography of a calibrated image pair
with their decompositions into (R, t), and absolute pose (PnP). Port of
``multiview_tpu/sfm/ransac.py`` (the roles of cv::estimateAffine2D in the
reference front end, interest_point.cc:133-143, and of TheiaSfM's two-view
and absolute-pose estimators behind ``theia_sfm``).

A fixed batch of minimal-sample hypotheses is solved and scored at once,
then the best model is refit on its inliers. Every function takes leading
batch dimensions (independent point sets, e.g. the image pairs of one
bucket): the small SVDs of all hypotheses of all pairs are one
``torch.linalg.svd`` call. Hypotheses are drawn by one small sampler,
``sample_hypotheses``, from a ``torch.Generator`` seeded per call; PyTorch
cannot reproduce JAX's random bits, so the parity tests hand the functions
JAX's own draws through ``samples=``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RansacResult(NamedTuple):
    model: torch.Tensor        # [...,2,3] affine
    inliers: torch.Tensor      # [...,N] bool
    num_inliers: torch.Tensor  # [...]


def _fit_affine2d(src, dst, w=None):
    """Weighted least-squares affine fit dst ~ A src + t over the row axis:
    src/dst [...,K,2], w [...,K] -> [...,2,3]."""
    ones = torch.ones(src.shape[:-1] + (1,), dtype=src.dtype, device=src.device)
    A = torch.cat([src, ones], dim=-1)                           # [...,K,3]
    Aw = A if w is None else A * w[..., None]
    H = A.transpose(-1, -2) @ Aw
    H = H + 1e-12 * torch.eye(3, dtype=src.dtype, device=src.device)
    b = Aw.transpose(-1, -2) @ dst                               # [...,3,2]
    sol = torch.linalg.solve_ex(H, b).result                     # [...,3,2]
    return sol.transpose(-1, -2)


def _apply_affine2d(model, pts):
    return pts @ model[..., :, :2].transpose(-1, -2) + model[..., None, :, 2]


def sample_hypotheses(valid: torch.Tensor, num_hypotheses: int, seed: int,
                      size: int = 3) -> torch.Tensor:
    """[..., num_hypotheses, size] row indices drawn with replacement among
    the ``valid`` rows of each point set (``valid`` [N] or [B,N]), uniformly,
    from one generator seeded with ``seed``."""
    gen = torch.Generator(device=valid.device)
    gen.manual_seed(int(seed))
    # no valid row: draw uniformly (the hypotheses then score 0 anyway)
    probs = torch.where(torch.any(valid, dim=-1, keepdim=True), valid.to(torch.float32),
                        torch.ones_like(valid, dtype=torch.float32))
    draws = torch.multinomial(probs, num_hypotheses * size, replacement=True, generator=gen)
    return draws.view(valid.shape[:-1] + (num_hypotheses, size))


def ransac_affine2d(src, dst, valid=None, threshold: float = 20.0,
                    num_hypotheses: int = 512, refit_rounds: int = 2,
                    seed: int = 0, samples: Optional[torch.Tensor] = None
                    ) -> RansacResult:
    """Batched-hypothesis RANSAC for a 2D affine map.

    src, dst [...,N,2] (leading dims: independent point sets, e.g. image
    pairs); valid [...,N] marks rows to use. Hypotheses come from
    ``samples`` [...,H,3] when given, else from ``sample_hypotheses`` with
    ``seed`` (one point set only)."""
    n = src.shape[-2]
    lead = src.shape[:-2]
    if n < 3:
        return RansacResult(
            torch.eye(2, 3, dtype=src.dtype, device=src.device).expand(lead + (2, 3)),
            torch.zeros(lead + (n,), dtype=torch.bool, device=src.device),
            torch.zeros(lead, dtype=torch.int64, device=src.device))
    if valid is None:
        valid = torch.ones(lead + (n,), dtype=torch.bool, device=src.device)
    if samples is None:
        if lead:
            raise ValueError("batched ransac_affine2d needs explicit samples")
        samples = sample_hypotheses(valid, num_hypotheses, seed)
    samples = samples.to(device=src.device, dtype=torch.int64)
    H = samples.shape[-2]

    # [...,H,3,2] minimal sets -> [...,H,2,3] models
    flat = samples.reshape(lead + (H * 3,))
    take = lambda x: torch.gather(x, -2, flat[..., None].expand(flat.shape + (2,)))  # noqa: E731
    s_src = take(src).reshape(lead + (H, 3, 2))
    s_dst = take(dst).reshape(lead + (H, 3, 2))
    models = _fit_affine2d(s_src, s_dst)                          # [...,H,2,3]

    # score every hypothesis over every row: [...,H,N]
    pred = _apply_affine2d(models, src[..., None, :, :])
    err = torch.linalg.norm(pred - dst[..., None, :, :], dim=-1)
    inl = (err <= threshold) & valid[..., None, :]
    scores = inl.sum(-1)
    best = torch.argmax(scores, dim=-1)                           # first max, as jnp.argmax
    model = torch.gather(models, -3, best[..., None, None, None].expand(lead + (1, 2, 3)))
    model = model.squeeze(-3)

    for _ in range(refit_rounds):
        err = torch.linalg.norm(_apply_affine2d(model, src) - dst, dim=-1)
        inl = (err <= threshold) & valid
        model = _fit_affine2d(src, dst, w=inl.to(src.dtype))
    err = torch.linalg.norm(_apply_affine2d(model, src) - dst, dim=-1)
    inliers = (err <= threshold) & valid
    return RansacResult(model, inliers, inliers.sum(-1))


# ----------------------------------------------------------------------------
# Shared pieces of the two-view and absolute-pose estimators
# ----------------------------------------------------------------------------


def _homog(x):
    """[...,K,2] -> [...,K,3] with a last coordinate of one."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _take_rows(x, samples):
    """Rows ``samples`` [...,H,k] of ``x`` [...,N,C] -> [...,H,k,C]."""
    lead, (H, k), C = samples.shape[:-2], samples.shape[-2:], x.shape[-1]
    flat = samples.reshape(lead + (H * k, 1)).expand(lead + (H * k, C))
    return torch.gather(x, -2, flat).reshape(lead + (H, k, C))


def _take_best(x, best, event_dims: int):
    """Entry ``best`` [...] along the axis that precedes the last
    ``event_dims`` axes of ``x`` [...,H,*event]."""
    event = x.shape[x.dim() - event_dims:]
    idx = best.reshape(best.shape + (1,) * (event_dims + 1)).expand(best.shape + (1,) + event)
    return torch.gather(x, best.dim(), idx).squeeze(best.dim())


def _null_vector(A):
    """Right singular vector of the smallest singular value of A [...,M,C]
    with M >= C (its sign is the library's)."""
    return torch.linalg.svd(A, full_matrices=False).Vh[..., -1, :]


def _prepare(x, valid, samples, size, num_hypotheses, seed):
    """Default validity mask and hypothesis samples [...,H,size] (int64, on
    ``x``'s device) of a point set x [...,N,C]."""
    if valid is None:
        valid = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    if samples is None:
        samples = sample_hypotheses(valid, num_hypotheses, seed, size=size)
    return valid, samples.to(device=x.device, dtype=torch.int64)


# ----------------------------------------------------------------------------
# Essential matrix (relative pose for the global SfM initializer)
# ----------------------------------------------------------------------------


def _project_essential(E):
    """Nearest matrix with singular values (s, s, 0)."""
    U, S, Vh = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) / 2.0
    return (U[..., :, :2] * s[..., None, None]) @ Vh[..., :2, :]


def _epipolar_rows(x1, x2, w=None):
    """Rows kron(x2, x1) of the linear system x2^T E x1 = 0: [...,K,9]."""
    A = (_homog(x2)[..., :, None] * _homog(x1)[..., None, :]).flatten(-2)
    return A if w is None else A * w[..., None]


def _fit_essential_8pt(x1, x2):
    """8-point algorithm on unit-plane coordinates x1, x2 [...,8,2] ->
    E [...,3,3] on the essential manifold."""
    A = _epipolar_rows(x1, x2)                                   # [...,8,9]
    Vh = torch.linalg.svd(A, full_matrices=True).Vh              # the null vector: row 9
    return _project_essential(Vh[..., -1, :].reshape(A.shape[:-2] + (3, 3)))


def _sampson_err(E, x1, x2):
    """Sampson error of x1, x2 [...,N,2] under E [...,3,3] -> [...,N]."""
    X1, X2 = _homog(x1), _homog(x2)
    Ex1 = X1 @ E.transpose(-1, -2)
    Etx2 = X2 @ E
    num = torch.sum(X2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp_min(den, 1e-30)


def ransac_essential(x1, x2, valid=None, threshold: float = 1e-3,
                     num_hypotheses: int = 512, seed: int = 1,
                     samples: Optional[torch.Tensor] = None) -> RansacResult:
    """Batched RANSAC essential matrix from unit-plane correspondences
    x1, x2 [...,N,2]; ``threshold`` is on the Sampson error in normalized
    coordinates. Hypotheses come from ``samples`` [...,H,8] when given, else
    from ``sample_hypotheses`` with ``seed``. The model's sign is the SVD
    library's."""
    n = x1.shape[-2]
    lead = x1.shape[:-2]
    if n < 8:
        return RansacResult(
            torch.eye(3, dtype=x1.dtype, device=x1.device).expand(lead + (3, 3)),
            torch.zeros(lead + (n,), dtype=torch.bool, device=x1.device),
            torch.zeros(lead, dtype=torch.int64, device=x1.device))
    valid, samples = _prepare(x1, valid, samples, 8, num_hypotheses, seed)

    models = _fit_essential_8pt(_take_rows(x1, samples), _take_rows(x2, samples))
    err = _sampson_err(models, x1[..., None, :, :], x2[..., None, :, :])   # [...,H,N]
    scores = ((err <= threshold) & valid[..., None, :]).sum(-1)
    E = _take_best(models, torch.argmax(scores, dim=-1), 2)   # first max, as jnp.argmax

    # refit on the full inlier set (weighted 8-point): a minimal-sample model
    # is noise-amplified; the least-squares refit recovers the sqrt(N/8) factor
    for _ in range(2):
        w = ((_sampson_err(E, x1, x2) <= threshold) & valid).to(x1.dtype)
        E = _project_essential(
            _null_vector(_epipolar_rows(x1, x2, w)).reshape(lead + (3, 3)))
    inliers = (_sampson_err(E, x1, x2) <= threshold) & valid
    return RansacResult(E, inliers, inliers.sum(-1))


def _cheirality_count(R, t, x1, x2, inliers):
    """Number of inlier correspondences with positive least-squares depths
    under (R, t): z2 * x2 = R (z1 * x1) + t. R [...,3,3], t [...,3],
    x1, x2 [...,N,2], inliers [...,N] -> [...]."""
    f2 = _homog(x2)
    Rf1 = _homog(x1) @ R.transpose(-1, -2)
    tt = t[..., None, :]
    # [z1, z2]: minimize |z1*Rf1 - z2*f2 + t|^2
    a = torch.sum(Rf1 * Rf1, dim=-1)
    b = -torch.sum(Rf1 * f2, dim=-1)
    c = torch.sum(f2 * f2, dim=-1)
    d = -torch.sum(Rf1 * tt, dim=-1)
    e = torch.sum(f2 * tt, dim=-1)
    det = torch.clamp_min(a * c - b * b, 1e-30)
    z1 = (c * d - b * e) / det
    z2 = (a * e - b * d) / det
    return ((z1 > 0) & (z2 > 0) & inliers).sum(-1)


def _vote(Rs, ts, x1, x2, inliers):
    """Index [...] of the candidate (Rs [...,C,3,3], ts [...,C,3]) with the
    most inliers in front of both cameras; the first one on ties."""
    counts = _cheirality_count(Rs, ts, x1[..., None, :, :], x2[..., None, :, :],
                               inliers[..., None, :])
    return torch.argmax(counts, dim=-1)


def decompose_essential(E, x1, x2, inliers):
    """Recover (R, t) from E by cheirality voting over the 4 candidates.

    Returns the cam1-to-cam2 rotation R [...,3,3] and unit translation
    t [...,3] in the x2 ~ R x1 + t convention."""
    U, _, Vh = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)

    def fix(R):
        return R * torch.sign(torch.linalg.det(R))[..., None, None]

    R1 = fix(U @ W @ Vh)
    R2 = fix(U @ W.T @ Vh)
    t = U[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    best = _vote(Rs, ts, x1, x2, inliers)
    return _take_best(Rs, best, 2), _take_best(ts, best, 1)


# ----------------------------------------------------------------------------
# Homography: planar two-view geometry. Near-planar scenes (nadir surveys,
# walls) make the essential matrix degenerate: the linear 8-point problem
# admits a family of solutions and the recovered rotation can be ten degrees
# off while fitting every correspondence. Estimating H and decomposing it is
# the stable path there.
# ----------------------------------------------------------------------------


def _fit_homography_dlt(x1, x2, w=None):
    """DLT homography on unit-plane coordinates x1, x2 [...,K,2]: x2 ~ H x1.
    Returns H [...,3,3]."""
    X1 = _homog(x1)
    u, v = x2[..., 0:1], x2[..., 1:2]
    zeros = torch.zeros_like(X1)
    r1 = torch.cat([zeros, -X1, v * X1], dim=-1)
    r2 = torch.cat([X1, zeros, -u * X1], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                              # [...,2K,9]
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    # the minimal 4-point fit gives [8,9], where the economy SVD has only 8
    # rows and loses the null vector: a zero row leaves A^T A, hence V, as it is
    if A.shape[-2] < 9:
        A = torch.cat([A, A.new_zeros(A.shape[:-2] + (9 - A.shape[-2], 9))], dim=-2)
    return _null_vector(A).reshape(A.shape[:-2] + (3, 3))


def _transfer_err(H, x1, x2):
    """Squared forward transfer error |H x1 - x2|^2 on the unit plane."""
    Hx = _homog(x1) @ H.transpose(-1, -2)
    z = Hx[..., 2:3]
    z = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    return torch.sum((Hx[..., :2] / z - x2) ** 2, dim=-1)


def ransac_homography(x1, x2, valid=None, threshold: float = 1e-3,
                      num_hypotheses: int = 512, seed: int = 5,
                      samples: Optional[torch.Tensor] = None) -> RansacResult:
    """Batched RANSAC homography from unit-plane correspondences
    x1, x2 [...,N,2]. ``threshold`` gates the squared transfer error, the same
    units as ``ransac_essential``'s Sampson gate, so the inlier counts of the
    two models can be compared for model selection. ``samples`` [...,H,4]."""
    n = x1.shape[-2]
    lead = x1.shape[:-2]
    if n < 4:
        return RansacResult(
            torch.eye(3, dtype=x1.dtype, device=x1.device).expand(lead + (3, 3)),
            torch.zeros(lead + (n,), dtype=torch.bool, device=x1.device),
            torch.zeros(lead, dtype=torch.int64, device=x1.device))
    valid, samples = _prepare(x1, valid, samples, 4, num_hypotheses, seed)

    models = _fit_homography_dlt(_take_rows(x1, samples), _take_rows(x2, samples))
    err = _transfer_err(models, x1[..., None, :, :], x2[..., None, :, :])  # [...,H,N]
    scores = ((err <= threshold) & valid[..., None, :]).sum(-1)
    H = _take_best(models, torch.argmax(scores, dim=-1), 2)
    for _ in range(2):
        w = ((_transfer_err(H, x1, x2) <= threshold) & valid).to(x1.dtype)
        H = _fit_homography_dlt(x1, x2, w=w)
    inliers = (_transfer_err(H, x1, x2) <= threshold) & valid
    return RansacResult(H, inliers, inliers.sum(-1))


def decompose_homography(H, x1, x2, inliers):
    """Recover (R, t, n) from a calibrated homography H ~ R + t n^T / d
    (Faugeras-Lustman SVD method), disambiguated by cheirality voting over
    the 8 candidates. Returns (R [...,3,3], unit t [...,3], plane normal
    n [...,3]) in the x2 ~ R x1 + t convention."""
    U, S, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    s = (torch.linalg.det(U) * torch.linalg.det(V))[..., None, None]
    d1, d2, d3 = S[..., 0], S[..., 1], S[..., 2]
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    eps = 1e-12
    denom = torch.clamp_min(d1 * d1 - d3 * d3, eps)
    aux1 = torch.sqrt(torch.clamp_min(d1 * d1 - d2 * d2, 0.0) / denom)
    aux3 = torch.sqrt(torch.clamp_min(d2 * d2 - d3 * d3, 0.0) / denom)
    cross = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
    signs = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    cands_R, cands_t, cands_n = [], [], []
    # d' > 0: rotation about the plane-intersection axis by theta
    stheta_a = cross / torch.clamp_min((d1 + d3) * d2, eps)
    ctheta = (d2 * d2 + d1 * d3) / torch.clamp_min((d1 + d3) * d2, eps)
    for e1, e3 in signs:
        st = e1 * e3 * stheta_a
        Rp = mat([[ctheta, zero, -st], [zero, one, zero], [st, zero, ctheta]])
        tp = (d1 - d3)[..., None] * torch.stack([e1 * aux1, zero, -e3 * aux3], dim=-1)
        npl = torch.stack([e1 * aux1, zero, e3 * aux3], dim=-1)
        cands_R.append(s * (U @ Rp @ Vh))
        cands_t.append((U @ tp[..., None])[..., 0])
        cands_n.append((V @ npl[..., None])[..., 0])
    # d' < 0: the camera crosses the plane (rarely physical, kept for
    # completeness of the 8-candidate vote)
    sphi_a = cross / torch.clamp_min(torch.abs(d1 - d3) * d2, eps)
    cphi = (d1 * d3 - d2 * d2) / torch.clamp_min(torch.abs(d1 - d3) * d2, eps)
    for e1, e3 in signs:
        sp = e1 * e3 * sphi_a
        Rp = mat([[cphi, zero, sp], [zero, -one, zero], [sp, zero, -cphi]])
        tp = (d1 + d3)[..., None] * torch.stack([e1 * aux1, zero, e3 * aux3], dim=-1)
        npl = torch.stack([e1 * aux1, zero, e3 * aux3], dim=-1)
        cands_R.append(s * (U @ Rp @ Vh))
        cands_t.append((U @ tp[..., None])[..., 0])
        cands_n.append((V @ npl[..., None])[..., 0])

    Rs = torch.stack(cands_R, dim=-3)
    ts = torch.stack(cands_t, dim=-2)
    ns = torch.stack(cands_n, dim=-2)
    ts = ts / torch.clamp_min(torch.linalg.norm(ts, dim=-1, keepdim=True), 1e-12)
    best = _vote(Rs, ts, x1, x2, inliers)
    return _take_best(Rs, best, 2), _take_best(ts, best, 1), _take_best(ns, best, 1)


# ----------------------------------------------------------------------------
# Absolute pose (PnP): the view-registration solver of incremental SfM (the
# role of Theia's RANSAC absolute-pose estimation behind
# --absolute_pose_reprojection_error_threshold and
# --min_num_absolute_pose_inliers, theia_flags.txt:109-114)
# ----------------------------------------------------------------------------


class PnpResult(NamedTuple):
    pose: torch.Tensor         # [...,7] world->cam [tx,ty,tz,qx,qy,qz,qw]
    inliers: torch.Tensor      # [...,N] bool
    num_inliers: torch.Tensor  # [...]


def _nearest_rotation(M):
    """Projection of M [...,3,3] onto SO(3), and the mean singular value."""
    U, S, Vh = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vh)  # +1 for any sane sample; guard anyway
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * d[..., None, None]], dim=-1)
    return U @ Vh, S.mean(-1)


def _dlt_rows(Xh, x, w):
    """The two rows a point contributes to a projective DLT system:
    Xh [...,K,C] homogeneous source, x [...,K,2] image -> [...,2K,3C]."""
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -x[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([z, Xh, -x[..., 1:2] * Xh], dim=-1)
    return torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)


def _fit_pnp_dlt(X, x, w=None):
    """Weighted DLT absolute pose from world points X [...,K,3] and
    unit-plane observations x [...,K,2]: null space of the 2K x 12 system for
    P = [R|t], then projection of the left 3x3 onto SO(3) (scale absorbed
    into t)."""
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    Xh = _homog(X)                                                # [...,K,4]
    P = _null_vector(_dlt_rows(Xh, x, w)).reshape(X.shape[:-2] + (3, 4))
    # the null vector's sign is arbitrary: fix it first by cheirality (the
    # majority of the weighted points must land at positive depth) so that
    # P ~ +s[R|t]; only then is the SO(3) projection well-posed (the left
    # 3x3 of -s[R|t] has three equal singular values)
    z = (Xh @ P[..., 2, :, None])[..., 0]
    sgn = torch.sign(torch.sum(torch.sign(z) * w, dim=-1))
    P = P * torch.where(sgn == 0, torch.ones_like(sgn), sgn)[..., None, None]
    R, scale = _nearest_rotation(P[..., :, :3])
    t = P[..., :, 3] / torch.where(scale > 1e-30, scale, torch.full_like(scale, 1e-30))[..., None]
    return R, t


def _fit_pnp_planar(X, x, w=None):
    """Homography-based absolute pose for (near-)coplanar world points, the
    configuration where the 6-point DLT is rank-deficient. Fits the points'
    plane frame, estimates the plane->image homography
    H ~ [R e1, R e2, R O + t], and recovers (R, t) Zhang-style."""
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-30)
    O = torch.sum(X * w[..., None], dim=-2) / wsum[..., None]
    Xc = X - O[..., None, :]
    VhP = torch.linalg.svd(Xc * w[..., None], full_matrices=False).Vh
    e1, e2 = VhP[..., 0, :], VhP[..., 1, :]
    e3 = torch.linalg.cross(e1, e2, dim=-1)                       # right-handed plane frame
    uv = torch.stack([torch.sum(Xc * e1[..., None, :], dim=-1),
                      torch.sum(Xc * e2[..., None, :], dim=-1)], dim=-1)
    H = _null_vector(_dlt_rows(_homog(uv), x, w)).reshape(X.shape[:-2] + (3, 3))
    # cheirality: the centroid (plane coordinates (0,0)) must land at positive depth
    s = torch.sign(H[..., 2, 2])
    H = H * torch.where(s == 0, torch.ones_like(s), s)[..., None, None]
    lam = 2.0 / torch.clamp_min(torch.linalg.norm(H[..., :, 0], dim=-1)
                                + torch.linalg.norm(H[..., :, 1], dim=-1), 1e-30)
    c1 = H[..., :, 0] * lam[..., None]
    c2 = H[..., :, 1] * lam[..., None]
    RE, _ = _nearest_rotation(
        torch.stack([c1, c2, torch.linalg.cross(c1, c2, dim=-1)], dim=-1))   # ~ R @ E
    E = torch.stack([e1, e2, e3], dim=-1)                         # columns
    R = RE @ E.transpose(-1, -2)
    t = lam[..., None] * H[..., :, 2] - (R @ O[..., None])[..., 0]
    return R, t


def _pnp_err(R, t, X, x):
    """Unit-plane reprojection error [...,N] and camera-frame depth [...,N]."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    zc = torch.where(torch.abs(z) > 1e-30, z, torch.full_like(z, 1e-30))
    return torch.linalg.norm(Xc[..., :2] / zc[..., None] - x, dim=-1), z


def ransac_pnp(X, x, valid=None, threshold: float = 4e-3,
               num_hypotheses: int = 512, refit_rounds: int = 2, seed: int = 2,
               samples: Optional[torch.Tensor] = None) -> PnpResult:
    """Batched-hypothesis RANSAC absolute pose (world->cam) from 2D-3D
    correspondences.

    X [...,N,3] world points; x [...,N,2] unit-plane (undistorted, focal-
    normalized) observations; ``threshold``: reprojection error on the unit
    plane (4 px at 1024-wide images is about 4e-3 at f ~ 1000,
    theia_flags.txt:112). Minimal solvers: the 6-point DLT with an SO(3)
    projection, and the homography pose for coplanar points; scoring
    enforces positive depth. ``samples`` [...,H,6]."""
    from multiview_tpu_torch.geometry import pose as pose_mod

    n = X.shape[-2]
    lead = X.shape[:-2]
    if n < 6:
        return PnpResult(
            pose_mod.pose_identity(X.dtype, X.device).expand(lead + (7,)),
            torch.zeros(lead + (n,), dtype=torch.bool, device=X.device),
            torch.zeros(lead, dtype=torch.int64, device=X.device))
    valid, samples = _prepare(X, valid, samples, 6, num_hypotheses, seed)

    def inliers_of(R, t, X_, x_, valid_):
        err, depth = _pnp_err(R, t, X_, x_)
        return (err <= threshold) & (depth > 0) & valid_

    def dual_fit(Xs, xs, w, X_, x_, valid_):
        """Both minimal solvers, keeping whichever scores higher on
        (X_, x_): the DLT handles general scenes, the homography pose the
        coplanar configuration where the DLT is rank-deficient."""
        Ra, ta = _fit_pnp_dlt(Xs, xs, w=w)
        Rb, tb = _fit_pnp_planar(Xs, xs, w=w)
        na = inliers_of(Ra, ta, X_, x_, valid_).sum(-1)
        nb = inliers_of(Rb, tb, X_, x_, valid_).sum(-1)
        pick = nb > na
        return (torch.where(pick[..., None, None], Rb, Ra),
                torch.where(pick[..., None], tb, ta), torch.maximum(na, nb))

    Rs, ts, scores = dual_fit(_take_rows(X, samples), _take_rows(x, samples), None,
                              X[..., None, :, :], x[..., None, :, :], valid[..., None, :])
    best = torch.argmax(scores, dim=-1)
    R, t = _take_best(Rs, best, 2), _take_best(ts, best, 1)

    for _ in range(refit_rounds):
        cur = inliers_of(R, t, X, x, valid)
        R2, t2, n2 = dual_fit(X, x, cur.to(X.dtype), X, x, valid)
        # keep the refit only if it does not lose inliers
        keep = n2 >= cur.sum(-1)
        R = torch.where(keep[..., None, None], R2, R)
        t = torch.where(keep[..., None], t2, t)
    inliers = inliers_of(R, t, X, x, valid)
    pose = pose_mod.make_pose(t, pose_mod.matrix_to_quat(R))
    return PnpResult(pose, inliers, inliers.sum(-1))
