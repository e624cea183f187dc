"""Port parity for retrieval pair selection
(``multiview_tpu_torch/sfm/retrieval.py``): the same float32 descriptors, made
from a seed with numpy, go through the JAX functions and the port's on the
CPU, the port's k-means seeded with the rows the JAX package draws.

Bars: centroids and VLAD vectors within 1e-5 (float32; the port sums the
residuals as two sums, the JAX package as one); selected pair sets equal;
through ``detect_match_features`` the retrieval branch picks the pairs that
``select_pairs`` gives."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.sfm import retrieval as JRet
from multiview_tpu_torch.sfm import pipeline as TPl
from multiview_tpu_torch.sfm import retrieval as TRet
from torch_port_scenes import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_IMG, K, D = 9, 96, 32


def _descriptors(seed=0):
    """Images in three groups of three: each group shares a set of visual
    words, so an image's nearest neighbours are its group."""
    rng = np.random.default_rng(seed)
    words = rng.normal(size=(3, 12, D))
    descs, valids = [], []
    for i in range(N_IMG):
        w = words[i // 3][rng.integers(0, 12, K)] + 0.15 * rng.normal(size=(K, D))
        w = np.abs(w) / np.linalg.norm(w, axis=-1, keepdims=True)
        descs.append(w.astype(np.float32))
        v = np.ones(K, bool)
        v[K - 5 - i:] = False
        valids.append(v)
    return descs, valids


def _jax_init_rows(valid, k, seed):
    probs = jnp.asarray(valid).astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), len(valid), shape=(k,),
                                      replace=False, p=probs))


def test_kmeans_codebook_and_vlad_match_jax():
    descs, valids = _descriptors()
    pool, pv = np.concatenate(descs), np.concatenate(valids)
    cj = JRet.kmeans_codebook(jnp.asarray(pool), jnp.asarray(pv), k=8, seed=3)
    rows = _jax_init_rows(pv, 8, 3)
    assert pv[rows].all() and len(set(rows.tolist())) == 8
    ct = TRet.kmeans_codebook(torch.as_tensor(pool), torch.as_tensor(pv), k=8,
                              init_rows=torch.as_tensor(rows))
    assert np.abs(np.asarray(cj) - ct.numpy()).max() < 1e-5
    vj = JRet.vlad_descriptors(jnp.asarray(np.stack(descs)), jnp.asarray(np.stack(valids)), cj)
    vt = TRet.vlad_descriptors(torch.as_tensor(np.stack(descs)),
                               torch.as_tensor(np.stack(valids)),
                               torch.as_tensor(np.array(cj)))
    assert vt.shape == (N_IMG, 8 * D)
    assert np.abs(np.asarray(vj) - vt.numpy()).max() < 1e-5
    assert np.abs(np.linalg.norm(vt.numpy(), axis=-1) - 1.0).max() < 1e-5


def test_sample_codebook_rows_draws_distinct_valid_rows():
    valid = torch.as_tensor(np.concatenate(_descriptors()[1]))
    rows = TRet.sample_codebook_rows(valid, 16, seed=5)
    assert len(set(rows.tolist())) == 16 and bool(valid[rows].all())
    assert torch.equal(rows, TRet.sample_codebook_rows(valid, 16, seed=5))
    assert not torch.equal(rows, TRet.sample_codebook_rows(valid, 16, seed=6))


@pytest.mark.parametrize("neighbors", [2, 3])
def test_select_pairs_matches_jax(neighbors):
    descs, valids = _descriptors(seed=1)
    pj = JRet.select_pairs(descs, valids, neighbors, num_clusters=8, seed=0)
    n_train = int(sum(v.sum() for v in valids))
    rows = _jax_init_rows(np.ones(n_train, bool), 8, 0)
    pt = TRet.select_pairs([torch.as_tensor(d) for d in descs],
                           [torch.as_tensor(v) for v in valids], neighbors, num_clusters=8,
                           init_rows=torch.as_tensor(rows))
    assert pt == pj
    # every image's two group mates are among its nearest neighbours
    group_pairs = {(i, j) for i in range(N_IMG) for j in range(i + 1, N_IMG) if i // 3 == j // 3}
    assert group_pairs <= set(pt) and len(pt) >= N_IMG * neighbors // 2


def test_detect_match_features_takes_its_pairs_from_retrieval(monkeypatch):
    """``retrieval_neighbors`` > 0 replaces the temporal pair list by
    ``select_pairs`` of the detected descriptors."""
    from multiview_tpu_torch.sfm import features as feat
    descs, valids = _descriptors(seed=2)
    rng = np.random.default_rng(0)
    kps = [feat.Keypoints(torch.as_tensor(rng.uniform(0, 100, (K, 2)).astype(np.float32)),
                          torch.ones(K), torch.ones(K), torch.zeros(K), torch.as_tensor(v))
           for v in valids]
    monkeypatch.setattr(TPl, "detect_all", lambda images, cfg, device=None, store=None: (
        kps, [torch.as_tensor(d) for d in descs]))
    seen = []
    monkeypatch.setattr(TPl, "match_pair", lambda ki, di, kj, dj, cfg, seed=0: (
        seen.append(seed) or (np.zeros((0, 2)), np.zeros((0, 2)))))
    cfg = TPl.FrontendConfig(retrieval_neighbors=2, retrieval_clusters=8)
    tracks = TPl.detect_match_features([None] * N_IMG, cfg, device="cpu")
    assert tracks.tracks == []
    want = TRet.select_pairs([torch.as_tensor(d) for d in descs],
                             [torch.as_tensor(v) for v in valids], 2, num_clusters=8)
    assert seen == [i * 1000 + j for i, j in want]
    assert seen != [i * 1000 + j for i in range(N_IMG) for j in range(i + 1, min(i + 3, N_IMG))]


def test_sfm_init_with_retrieval_pairs(tmp_path):
    """Pairs picked by global-descriptor retrieval give a reconstruction of
    every view (the bar of TestSfmInitTool::test_sfm_init_retrieval_pairs)."""
    from multiview_tpu_torch.__main__ import main as torch_main
    from multiview_tpu_torch.io import nvm as nvm_io
    from test_torch_sfm_init import N_IMG, _centres, _write_workspace
    ws = tmp_path / "ws"
    ws.mkdir()
    _write_workspace(ws)
    ret = torch_main(["sfm-init", "--device", "cpu", "--rig_config", str(ws / "rig_config.txt"),
                      "--images", str(ws / "images"), "--out_dir", str(tmp_path / "ret"),
                      "--max_features", "300",
                      "--num_nearest_neighbors_for_global_descriptor_matching", "2"])
    assert ret == 0
    nvm = nvm_io.read_nvm(tmp_path / "ret" / "cameras.nvm")
    assert len(nvm.cid_to_filename) == N_IMG and len(nvm.pid_to_cid_fid) > 20
    ctrs = _centres(nvm)
    d = np.linalg.norm(ctrs[:, None] - ctrs[None, :], axis=-1)
    assert np.all(np.isfinite(ctrs)) and np.all(d[np.triu_indices(N_IMG, 1)] > 1e-4)
