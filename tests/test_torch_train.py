"""The port's training against the JAX package's, in quality.

`jax.random` and `torch.Generator` draw different numbers from one seed, so
the trees differ; the contract is their quality on `clustered_data`: the
two-level quantization error within 5% of the JAX tree's, and exact
re-rank recall within 0.03 of it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pqt_tpu as P
from pqt_tpu.models.kmeans import lbg_kmeans as jax_kmeans
from pqt_tpu.ops.distance import brute_force_knn
import pqt_tpu_torch as T
from pqt_tpu_torch.models import kmeans as TK
from pqt_tpu_torch.models.db import encode_part_codes

PAIR_CFG = P.PQTConfig(
    dim=32, p=4, c1=4, c2=4, line_parts=8, hash_size=1 << 16,
    k1_build=4, k1_query=4, max_bins=256, max_candidates=1024,
    max_vec_per_bin=256, kmeans_iters=10, pair_top_m=64)


def _quantization_error(tcfg, tree, data):
    """Mean squared error of the two-level reconstruction (each part's
    encoded (l1, l2) refinement centroid), computed the same way for both
    trees."""
    x = torch.from_numpy(data)
    codes = encode_part_codes(tcfg, tree, x)              # (n, p)
    parts = torch.arange(tcfg.p)[None, :]
    recon = tree.cb2[parts, codes // tcfg.c2, codes % tcfg.c2]   # (n, p, vl)
    return float(((x.reshape(len(x), tcfg.p, tcfg.vl) - recon) ** 2)
                 .sum((1, 2)).mean())


@pytest.mark.parametrize("init", ["kmeans++", "lbg"])
def test_train_quality_matches_jax(clustered_data, init):
    db_vecs, queries = clustered_data
    cfg = PAIR_CFG.replace(kmeans_init=init)
    tcfg = T.PQTConfig.from_json(cfg.to_json())
    jtree = P.train_tree(cfg, db_vecs)
    ttree = T.train_tree(tcfg, db_vecs, device="cpu")
    assert ttree.cb1.shape == (4, 4, 8) and ttree.cb2.shape == (4, 4, 4, 8)
    jtree_t = T.PQTree.from_numpy(tcfg, np.asarray(jtree.cb1),
                                  np.asarray(jtree.cb2), device="cpu")
    err_j = _quantization_error(tcfg, jtree_t, db_vecs)
    err_t = _quantization_error(tcfg, ttree, db_vecs)
    assert err_t <= 1.05 * err_j, (err_t, err_j)

    _, gt = brute_force_knn(jnp.asarray(queries), jnp.asarray(db_vecs), 1)
    gt = np.asarray(gt)[:, 0]
    jdb = P.build_database(cfg, jtree, db_vecs, keep_vectors=True)
    jres = P.query_knn(cfg, jtree, jdb, jnp.asarray(queries), 10, True)
    tdb = T.build_database(tcfg, ttree, db_vecs, keep_vectors=True,
                           device="cpu")
    tres = T.query_knn(tcfg, ttree, tdb, torch.from_numpy(queries), 10, True)
    r1_j = (np.asarray(jres.indices)[:, 0] == gt).mean()
    r1_t = (tres.indices.numpy()[:, 0] == gt).mean()
    assert r1_t >= r1_j - 0.03, (r1_t, r1_j)


def test_train_is_seeded():
    rng = np.random.default_rng(3)
    data = rng.normal(0, 1, (512, 32)).astype(np.float32)
    cfg = T.PQTConfig.from_json(PAIR_CFG.to_json())
    a = T.train_tree(cfg, data, device="cpu")
    b = T.train_tree(cfg, data, device="cpu")
    c = T.train_tree(cfg.replace(seed=cfg.seed + 1), data, device="cpu")
    assert torch.equal(a.cb2, b.cb2)
    assert not torch.equal(a.cb2, c.cb2)


def test_masked_kmeans_matches_jax_quality():
    """One masked population: the port's k-means reaches the JAX package's
    within-cluster error (k-means++ seeding and LBG splitting)."""
    rng = np.random.default_rng(8)
    centers = rng.normal(0, 4, (8, 6))
    x = (centers[rng.integers(0, 8, 3000)] + rng.normal(0, 1, (3000, 6))
         ).astype(np.float32)
    mask = rng.random(3000) < 0.7

    def sse(c):
        d = ((x[mask, None, :] - c[None]) ** 2).sum(-1)
        return d.min(1).sum()

    gen = torch.Generator().manual_seed(0)
    for init in ("kmeans++", "lbg"):
        cj, _ = jax_kmeans(jnp.asarray(x), jnp.asarray(mask), 8, init=init,
                           split_epsilon=0.02)
        ct, at = TK.lbg_kmeans(torch.from_numpy(x), torch.from_numpy(mask), 8,
                               generator=gen, init=init, split_epsilon=0.02)
        assert at.shape == (3000,)
        assert sse(ct.numpy()) <= 1.05 * sse(np.asarray(cj))
    masks = torch.from_numpy(np.stack([mask, ~mask]))
    many = TK.batched_masked_kmeans(torch.from_numpy(x), masks, 8,
                                    generator=gen)
    assert many.shape == (2, 8, 6) and torch.isfinite(many).all()
