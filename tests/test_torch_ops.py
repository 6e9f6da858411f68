"""The port's ops (distance tables, triangle codecs, line codes, bin ids,
compaction, candidate positions, traversal sequence) against the JAX
package's, on the same numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pqt_tpu.ops import binning as JB
from pqt_tpu.ops import distance as JD
from pqt_tpu.ops import distseq as JS
from pqt_tpu.ops import linecodes as JL
from pqt_tpu.ops import triangle as JT
from pqt_tpu_torch.ops import binning as TB
from pqt_tpu_torch.ops import distance as TD
from pqt_tpu_torch.ops import distseq as TS
from pqt_tpu_torch.ops import linecodes as TL
from pqt_tpu_torch.ops import triangle as TT


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("table", ["pairwise", "part", "subpart", "pair"])
def test_distance_tables(table):
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    if table == "pairwise":
        c = rng.uniform(0, 255, (40, 128)).astype(np.float32)
        want = JD.pairwise_sqdist(jnp.asarray(x), jnp.asarray(c))
        got = TD.pairwise_sqdist(_t(x), _t(c))
    elif table == "part":
        cb = rng.uniform(0, 255, (4, 256, 32)).astype(np.float32)
        want = JD.part_sqdist_tables(jnp.asarray(x), jnp.asarray(cb))
        got = TD.part_sqdist_tables(_t(x), _t(cb))
    elif table == "subpart":
        c = rng.uniform(0, 255, (16, 128)).astype(np.float32)
        want = JD.subpart_sqdist_tables(jnp.asarray(x), jnp.asarray(c), 16)
        got = TD.subpart_sqdist_tables(_t(x), _t(c), 16)
    else:
        c = rng.uniform(0, 255, (16, 128)).astype(np.float32)
        want = JD.centroid_pair_sqdist(jnp.asarray(c), 16)
        got = TD.centroid_pair_sqdist(_t(c), 16)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-2)


def test_brute_force_oracle_agrees():
    rng = np.random.default_rng(5)
    db = rng.integers(0, 256, (3000, 32)).astype(np.float32)
    q = rng.integers(0, 256, (20, 32)).astype(np.float32)
    want_d, want_i = JD.brute_force_knn(jnp.asarray(q), jnp.asarray(db), 10)
    got_d, got_i = TD.brute_force_knn(_t(q), _t(db), 10, db_chunk=1000)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5)
    np.testing.assert_array_equal(got_i.numpy()[:, 0],
                                  np.asarray(want_i)[:, 0])


def test_lambda_codecs_bit_exact():
    lam = np.concatenate([
        np.linspace(-5, 5, 20001, dtype=np.float32),
        np.array([-4.0, 4.0, 3.9999998, -4.0000005, 0.0, 1.0], np.float32)])
    u16 = TT.lambda_to_u16(_t(lam)).numpy()
    np.testing.assert_array_equal(u16, np.asarray(
        JT.lambda_to_u16(jnp.asarray(lam))).astype(np.int32))
    u8 = TT.lambda_to_u8(_t(lam)).numpy()
    np.testing.assert_array_equal(u8, np.asarray(
        JT.lambda_to_u8(jnp.asarray(lam))).astype(np.int32))
    codes16 = np.arange(65536, dtype=np.int32)
    np.testing.assert_array_equal(
        TT.u16_to_lambda(_t(codes16)).numpy(),
        np.asarray(JT.u16_to_lambda(jnp.asarray(codes16.astype(np.uint16)))))
    codes8 = np.arange(256, dtype=np.int32)
    np.testing.assert_array_equal(
        TT.u8_to_lambda(_t(codes8)).numpy(),
        np.asarray(JT.u8_to_lambda(jnp.asarray(codes8.astype(np.uint8)))))


def test_triangle_geometry():
    rng = np.random.default_rng(2)
    a2, b2, c2 = (rng.uniform(0, 100, 1000).astype(np.float32)
                  for _ in range(3))
    lam_j, d_j = JT.project_with_residual(*map(jnp.asarray, (a2, b2, c2)))
    lam_t, d_t = TT.project_with_residual(_t(a2), _t(b2), _t(c2))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(
        TT.line_dist(_t(a2), _t(b2), _t(c2), lam_t).numpy(),
        np.asarray(JT.line_dist(*map(jnp.asarray, (a2, b2, c2)), lam_j)),
        rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("lambda_bits", [8, 16])
def test_build_line_codes(lambda_bits):
    """The port's chain from the rows (the line tables' terms, then kernel
    L's plain version and the sum) against the JAX package's from its line
    tables: packed codes equal except where the best line is a near-tie
    (the two frameworks round the tables and the residuals differently); t3
    within 1e-4 relative."""
    rng = np.random.default_rng(lambda_bits)
    centroids = rng.uniform(0, 140, (16, 128)).astype(np.float32)
    x = rng.uniform(0, 140, (2000, 128)).astype(np.float32)
    pair_j = JD.centroid_pair_sqdist(jnp.asarray(centroids), 16)
    pd_j = JD.subpart_sqdist_tables(jnp.asarray(x), jnp.asarray(centroids), 16)
    want_codes, want_t3 = JL.build_line_codes(pd_j, pair_j, lambda_bits)
    got_codes, got_t3 = TL.build_line_codes(
        *TD.subpart_sqdist_terms(_t(x), _t(centroids), 16),
        _t(np.asarray(pair_j)), lambda_bits)
    want_codes = np.asarray(want_codes).astype(np.int64)
    same = got_codes.numpy() == want_codes
    assert same.mean() >= 0.999, same.mean()
    rows_same = same.all(axis=1)
    np.testing.assert_allclose(got_t3.numpy()[rows_same],
                               np.asarray(want_t3)[rows_same], rtol=1e-4,
                               atol=1e-2)
    a, b, lam = TL.unpack_codes(got_codes)
    ja, jb, jlam = JL.unpack_codes(jnp.asarray(want_codes.astype(np.uint32)))
    np.testing.assert_array_equal(a.numpy()[same], np.asarray(ja)[same])
    np.testing.assert_array_equal(lam.numpy()[same], np.asarray(jlam)[same])


@pytest.mark.parametrize("regime", ["exact", "hashed"])
def test_hashed_bin_ids_bit_exact(regime):
    rng = np.random.default_rng(9)
    p = 4
    # 256^4 > 2^20: mixing hash; 16^4 == 2^16: exact mixed-radix ids
    radix, hash_size = (256, 1 << 20) if regime == "hashed" else (16, 1 << 16)
    codes = rng.integers(0, radix, (5000, p)).astype(np.int32)
    codes[0] = radix - 1
    want = np.asarray(JB.hashed_bin_ids(jnp.asarray(codes), radix, hash_size))
    got = TB.hashed_bin_ids(_t(codes), radix, hash_size).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_compact_nonempty_bins_equal():
    rng = np.random.default_rng(4)
    bins = rng.integers(0, 1 << 20, (16, 512)).astype(np.int32)
    counts = rng.integers(0, 3, (16, 512)).astype(np.int32)
    counts[3] = 0                                  # a row with no hit
    for nb in (100, 512):
        wb, wc = jax.jit(JB.compact_nonempty_bins, static_argnums=(2,))(
            jnp.asarray(bins), jnp.asarray(counts), nb)
        gb, gc = TB.compact_nonempty_bins(_t(bins), _t(counts), nb)
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("K,cap", [(1024, 1024), (300, 7)])
def test_gather_candidates_equal(K, cap):
    rng = np.random.default_rng(K + cap)
    counts = rng.integers(0, 12, (16, 128)).astype(np.int32)
    counts[counts < 4] = 0
    counts[5] = 0                                   # no candidates at all
    prefix = rng.integers(0, 10_000, (16, 128)).astype(np.int32)
    wp, wv = jax.jit(JB.gather_candidates, static_argnums=(2, 3))(
        jnp.asarray(prefix), jnp.asarray(counts), K, cap)
    gp, gv = TB.gather_candidates(_t(prefix), _t(counts), K, cap)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


@pytest.mark.parametrize("m,length", [(64, 1024), (128, 512), (5, 40)])
def test_pair_sequence_equal(m, length):
    np.testing.assert_array_equal(TS.pair_sequence(m, length),
                                  JS.pair_sequence(m, length))


def _line_codes(seed, n=300, lp=8, c1=16, dim=64):
    """(packed codes (n, lp) uint32, t3, pair tables, x's line tables) of
    the JAX package on the same numpy inputs."""
    rng = np.random.default_rng(seed)
    centroids = rng.uniform(0, 140, (c1, dim)).astype(np.float32)
    x = rng.uniform(0, 140, (n, dim)).astype(np.float32)
    pair = JD.centroid_pair_sqdist(jnp.asarray(centroids), lp)
    codes, t3 = JL.build_line_codes(
        JD.subpart_sqdist_tables(jnp.asarray(x), jnp.asarray(centroids), lp),
        pair)
    return np.asarray(codes), np.asarray(t3), np.asarray(pair), centroids


def test_line_code_t3_equal():
    """t3 recomputed from packed codes: within float32 rounding of the JAX
    function's (the sum over line parts runs in another order) and of the
    stored t3, on both packages' codes alike."""
    codes, t3, pair, _ = _line_codes(21)
    want = np.asarray(JL.line_code_t3(jnp.asarray(codes), jnp.asarray(pair)))
    got = TL.line_code_t3(_t(codes.astype(np.int64)), _t(pair))
    assert got.dtype == torch.float32 and tuple(got.shape) == (300,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got.numpy(), t3, rtol=1e-4, atol=1e-2)


def test_reconstruct_dists_equal():
    """Distances from packed codes: the JAX function's within float32
    rounding (the one-hot accumulation against a gather)."""
    rng = np.random.default_rng(22)
    codes, t3, _, centroids = _line_codes(22)
    q = rng.uniform(0, 140, (5, 64)).astype(np.float32)
    q_tab = np.asarray(JD.subpart_sqdist_tables(jnp.asarray(q),
                                                jnp.asarray(centroids), 8))
    pick = rng.integers(0, 300, (5, 40))
    want = np.asarray(JL.reconstruct_dists(
        jnp.asarray(codes[pick]), jnp.asarray(q_tab), jnp.asarray(t3[pick])))
    got = TL.reconstruct_dists(_t(codes[pick].astype(np.int64)), _t(q_tab),
                               _t(t3[pick]))
    assert tuple(got.shape) == (5, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-1)


def test_unpack_payload_equal():
    """Wide payload rows -> ids, codes and t3 to the bit."""
    from pqt_tpu.models import db as JDB
    from pqt_tpu_torch.models import db as TDB
    codes, t3, _, _ = _line_codes(23)
    ids = np.arange(300, dtype=np.int32)[::-1].copy()
    rows = JDB.pack_payload(ids, codes, t3)
    w_ids, w_codes, w_t3 = JDB.unpack_payload(jnp.asarray(rows))
    g_ids, g_codes, g_t3 = TDB.unpack_payload(_t(rows))
    np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))
    np.testing.assert_array_equal(g_codes.numpy(),
                                  np.asarray(w_codes).astype(np.int64))
    np.testing.assert_array_equal(g_t3.numpy().view(np.int32),
                                  np.asarray(w_t3).view(np.int32))


@pytest.mark.parametrize("n,hash_size", [(5000, 1 << 12), (7, 64), (0, 16)])
def test_build_csr_equal(n, hash_size):
    """The inverted file to the bit: counts (ids outside the table dropped,
    as the JAX package's scatter drops them), exclusive prefix, and the
    stable order by bin."""
    rng = np.random.default_rng(n)
    bins = rng.integers(0, hash_size, n).astype(np.int32)
    if n > 10:
        bins[:3] = [hash_size, hash_size + 5, hash_size - 1]
    want = JB.build_csr(jnp.asarray(bins), hash_size)
    got = TB.build_csr(_t(bins), hash_size)
    assert isinstance(got, TB.InvertedFile) and got.n_vectors == n
    for name in ("prefix", "counts", "ids", "order"):
        g = getattr(got, name)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)), name)


def test_brute_force_knn_fast_equal():
    """Integer-valued vectors, so every float32 distance is exact: the
    port's selection (kernel A's plain version here) gives the JAX
    function's distances to the bit and its ids wherever the distances are
    untied with their neighbours in the ranking."""
    rng = np.random.default_rng(24)
    db = rng.integers(0, 256, (4000, 32)).astype(np.float32)
    q = rng.integers(0, 256, (16, 32)).astype(np.float32)
    want_d, want_i = JD.brute_force_knn_fast(jnp.asarray(q), jnp.asarray(db),
                                             10)
    got_d, got_i = TD.brute_force_knn_fast(_t(q), _t(db), 10)
    assert got_i.dtype == torch.int32
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    full = np.sort(((q[:, None, :] - db[None]) ** 2).sum(-1), axis=1)[:, :11]
    untied = (full[:, :10] != full[:, 1:11]) & np.concatenate(
        [np.ones((16, 1), bool), full[:, 1:10] != full[:, :9]], axis=1)
    assert untied.mean() > 0.5
    np.testing.assert_array_equal(got_i.numpy()[untied], want_i[untied])
