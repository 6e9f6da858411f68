"""Kernel L, the build's line-code selection (`line_codes`,
csrc/linecodes.cu), against the JAX package, and the build's routing
through it.

On a CPU tensor `line_codes` runs its plain version, `line_codes_plain`;
chip_smoke.py holds the CUDA kernel against that plain version on the card,
to the bit.  Here:

* the plain version with its terms summed is held against the JAX
  package's `build_line_codes` as its encode runs it, jitted (the fused
  reduce XLA makes of pqt_tpu/ops/linecodes.py:77-105, which kernel L
  takes the place of), at SIFT1M's and SIFT1B's (lp, c1) and at both
  lambda widths, on hard rows, and at other c1 (the kernel's loop route);
  and the port's `encode_line_codes` against the JAX package's on one tree
  at SIFT1B width;
* a numpy model of the kernel's walk (one (row, part) at a time, the pairs
  A < B in flat order A * c1 + B, every operation rounded on its own, the
  scan starting at the masked index 0, a NaN the least residual, the
  quantiser's truncation with a NaN lambda at 0) is held to the plain
  version to the bit on the same rows: what the kernel computes, checked
  where no card is;
* the wrapper on CPU tensors equals the plain version to the bit, refuses
  what the kernel does not take, and every build reaches it.

Inputs are made with numpy from a seed; the JAX results are computed once a
module.

Tolerances.  Codes are equal to the bit except where the two picks are a
near-tie: at most 0.1% of the codes may differ, each only where the JAX
pick's residual (recomputed in float64) is within 1e-5 relative of the
port pick's.  Where centroids coincide, two pairs can span one line and
tie in exact arithmetic; XLA's jitted program rounds the residual as
multiply-adds and breaks 2 such ties among the 1200 codes of each of
those cases otherwise than the port: they allow 1% (TIE_SHARE).
Everything else agrees to the bit, the hard rows too: both frameworks
take the first least residual, count a NaN residual as the least (the NaN
row picks the first pair whose residual is NaN), mask the pairs A >= B,
give the divide by 1e-20 of a zero pair distance the same lambda, and
quantise alike at both ends of [-4, 4).  t3 is a float32 sum of lp terms
of both signs, which the frameworks add in different orders, and XLA's
jitted program fuses each term's q * q - q into a multiply-add (lp = 1
rows differ by it alone): |t3 - t3_jax| <= lp * 2^-22 * sum_lp (q^2 +
|q|) * |c2|.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqt_tpu.models import db as JDB
from pqt_tpu.models.tree import PQTree as JTree
from pqt_tpu.ops import linecodes as JL
import pqt_tpu_torch as T
from pqt_tpu_torch.models import db as TDB
from pqt_tpu_torch.models.tree import line_tables
from pqt_tpu_torch.ops import linecodes as TL
from pqt_tpu_torch.ops.cuda import build
from pqt_tpu_torch.ops.cuda import linecodes as LC
from pqt_tpu_torch.ops.cuda.linecodes import line_codes
from pqt_tpu_torch.utils import graphs

BITS = [16, 8]
_JAX_BUILD = jax.jit(JL.build_line_codes, static_argnums=(2,))


def _tables(rng, n, lp, c1, dim=128, noise=8.0):
    """(part_dists (n, lp, c1), pair (lp, c1, c1)) float32: integer rows in
    [0, 255] about a point of the line between two of c1 random centroids
    (lambda in [-0.2, 1.2)), distances taken in float64."""
    cent = rng.uniform(0, 140, (c1, dim))
    i, j = rng.integers(0, c1, n), rng.integers(0, c1, n)
    t = rng.uniform(-0.2, 1.2, (n, 1))
    x = np.clip(np.round((1 - t) * cent[i] + t * cent[j]
                         + rng.normal(0, noise, (n, dim))), 0, 255)
    return _dists(x, cent, lp)


def _dists(x, cent, lp):
    n, dim = x.shape
    c1, lvl = cent.shape[0], dim // lp
    xs = x.reshape(n, lp, lvl)
    cs = cent.reshape(c1, lp, lvl).transpose(1, 0, 2)         # (lp, c1, lvl)
    d = ((xs[:, :, None, :] - cs[None]) ** 2).sum(-1)
    p = ((cs[:, :, None, :] - cs[:, None, :, :]) ** 2).sum(-1)
    return (np.ascontiguousarray(d, np.float32),
            np.ascontiguousarray(p, np.float32))


def _make_cases():
    """{name: (part_dists, pair_dists)} numpy float32."""
    rng = np.random.default_rng(16)
    cases = {"sift1m": _tables(rng, 400, 16, 16),
             "sift1b": _tables(rng, 400, 32, 16)}
    for c1 in (2, 5, 17, 64):
        cases[f"c1_{c1}"] = _tables(rng, 120, 4, c1, dim=32)
    # coincident centroids: pair distances 0 (lambda from a divide by
    # 1e-20; residuals of -inf or NaN), rows on a centroid and about one
    cent = rng.integers(0, 20, (16, 32)).astype(np.float64)
    cent[5] = cent[3]
    cent[9] = cent[10] = cent[11] = cent[12]
    x = cent[rng.integers(0, 16, 300)]
    x[150:] += rng.integers(-2, 3, (150, 32))
    cases["coincident_centroids"] = _dists(x, cent, 4)
    flat = cent.copy()
    flat[:, :8] = flat[0, :8]
    cases["one_point_part"] = _dists(x, flat, 4)
    # small integer distances: exact residual ties everywhere
    cases["integer_ties"] = (
        rng.integers(0, 4, (300, 4, 16)).astype(np.float32),
        rng.integers(0, 4, (4, 16, 16)).astype(np.float32))
    # lambda = -0.5 * (a2 - b2 - 1) on a fine grid about -4 and 4 (b2 100,
    # c2 1, one pair), and far past both ends
    lam = np.concatenate([e + np.arange(-1500, 1500) * 2.0 ** -16
                          for e in (-4.0, 4.0)])
    cases["lambda_ends"] = (
        np.stack([np.full_like(lam, 100.0), 101.0 - 2.0 * lam],
                 1)[:, None, :].astype(np.float32),
        np.array([[[0.0, 1.0], [1.0, 0.0]]], np.float32))
    cases["lambda_far"] = (
        rng.uniform(0, 100, (300, 4, 16)).astype(np.float32),
        rng.uniform(0.1, 1.0, (4, 16, 16)).astype(np.float32))
    # NaN and infinite distances
    d, p = _tables(rng, 60, 4, 16, dim=32)
    d[0] = np.nan
    d[1, 0, 3] = np.nan
    d[2, 1, :] = np.inf
    d[3, 2, 7] = np.inf
    cases["nan_inf"] = (d, p)
    return cases


CASES = _make_cases()
# Coincident centroids make pairs of lines that are one line (A, B) and
# (A', B) with A' = A): their residuals tie in exact arithmetic, and XLA's
# jitted residual (multiply-adds) breaks such ties otherwise than the
# port's rounded passes; these cases allow 1% of their codes at such ties.
TIE_SHARE = {"coincident_centroids": 0.01, "one_point_part": 0.01}


@pytest.fixture(scope="module")
def jax_codes():
    """{(case, bits): (codes (n, lp) int64, t3 (n,) float32)} of the JAX
    package's jitted build_line_codes."""
    out = {}
    for name, (d, p) in CASES.items():
        for bits in BITS:
            codes, t3 = _JAX_BUILD(jnp.asarray(d), jnp.asarray(p), bits)
            out[name, bits] = (np.asarray(codes).astype(np.int64),
                               np.asarray(t3))
    return out


def _residual64(d, p, codes):
    """Each code's (A, B) residual b2 - lambda^2 c2, lambda unquantised, in
    float64 (+inf for A >= B, as the selection masks it)."""
    a, b = codes & 0xFF, (codes >> 8) & 0xFF
    n, lp, _ = d.shape
    rows, parts = np.meshgrid(np.arange(n), np.arange(lp), indexing="ij")
    a2 = d[rows, parts, b].astype(np.float64)
    b2 = d[rows, parts, a].astype(np.float64)
    c2 = np.maximum(p[parts, a, b].astype(np.float64), 1e-20)
    lam = -0.5 * (a2 - b2 - c2) / c2
    return np.where(a < b, b2 - lam * lam * c2, np.inf)


def _term_scale(p, codes):
    """sum_lp (q^2 + |q|) * |c2| of each row's codes: what the rounding of
    its t3 terms scales with (q * q - q cancels near q = 0 and 1)."""
    a, b, q = (x.numpy() for x in TL.unpack_codes(torch.from_numpy(codes)))
    c2 = p[np.arange(p.shape[0])[None, :], a, b].astype(np.float64)
    q = q.astype(np.float64)
    return ((q * q + np.abs(q)) * np.abs(c2)).sum(-1)


def _assert_matches_jax(d, p, got, want, share=0.001):
    codes, t3 = got
    jcodes, jt3 = want
    same = codes.numpy() == jcodes
    assert same.mean() >= 1 - share, same.mean()
    if not same.all():
        r_port = _residual64(d, p, codes.numpy())[~same]
        r_jax = _residual64(d, p, jcodes)[~same]
        np.testing.assert_allclose(r_jax, r_port, rtol=1e-5)
    rows = same.all(axis=1)
    tol = d.shape[1] * 2.0 ** -22 * _term_scale(p, jcodes[rows])
    diff = np.abs(t3.numpy()[rows].astype(np.float64) - jt3[rows])
    assert (diff <= tol).all(), (diff - tol).max()


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax(jax_codes, name, bits):
    d, p = CASES[name]
    codes, terms = TL.line_codes_plain(torch.from_numpy(d),
                                       torch.from_numpy(p), bits)
    assert codes.dtype == torch.int64 and terms.dtype == torch.float32
    assert codes.shape == terms.shape == d.shape[:2]
    _assert_matches_jax(d, p, (codes, torch.sum(terms, dim=-1)),
                        jax_codes[name, bits], TIE_SHARE.get(name, 0.001))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_build_line_codes_matches_jax(jax_codes, name, bits):
    """build_line_codes (the wrapper, then the sum over the line parts)."""
    d, p = CASES[name]
    got = TL.build_line_codes(torch.from_numpy(d), torch.from_numpy(p), bits)
    _assert_matches_jax(d, p, got, jax_codes[name, bits],
                        TIE_SHARE.get(name, 0.001))


def _kernel_model(d, p, bits):
    """csrc/linecodes.cu's walk on numpy float32, all rows at once: every
    operation rounded on its own in the kernel's order; the scan starts at
    the masked flat index 0 (+inf, lambda of the pair (0, 0)) and takes a
    pair whose residual is below the best, or NaN where the best is not;
    then the quantiser and the term of the pick."""
    f32 = np.float32
    n, lp, c1 = d.shape
    eps = f32(1e-20)
    pc = np.where(p < eps, eps, p)           # NaN stays NaN
    parts = np.arange(lp)

    def project(a2, b2, c2, c2c):
        with np.errstate(all="ignore"):
            lam = ((a2 - b2) - c2) * f32(-0.5) / c2c
            return lam, b2 - (lam * lam) * c2c

    best_r = np.full((n, lp), np.inf, f32)
    best_lam, _ = project(d[:, :, 0], d[:, :, 0], p[:, 0, 0], pc[:, 0, 0])
    best = np.zeros((n, lp), np.int64)
    for a in range(c1):
        for b in range(a + 1, c1):
            lam, r = project(d[:, :, b], d[:, :, a], p[:, a, b], pc[:, a, b])
            take = (r < best_r) | (np.isnan(r) & ~np.isnan(best_r))
            best_r = np.where(take, r, best_r)
            best_lam = np.where(take, lam, best_lam)
            best = np.where(take, a * c1 + b, best)
    with np.errstate(all="ignore"):
        f = (best_lam - f32(-4.0)) * f32(8192.0)
    f = np.where(best_lam >= f32(4.0), f32(65535.0),
                 np.where(best_lam < f32(-4.0), f32(0.0), f))
    u = np.where(np.isnan(f), 0, np.trunc(np.nan_to_num(f))).astype(np.int64)
    u = np.clip(u, 0, 65535)
    if bits == 8:
        u = np.minimum((u + 128) >> 8, 255) << 8
    q = u.astype(f32) * f32(1.0 / 8192.0) + f32(-4.0)
    c2 = p[parts[None, :], best // c1, best % c1]
    with np.errstate(all="ignore"):
        terms = (q * q - q) * c2
    return (best // c1) | ((best % c1) << 8) | (u << 16), terms


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_matches_plain(name, bits):
    d, p = CASES[name]
    codes, terms = _kernel_model(d, p, bits)
    want_codes, want_terms = TL.line_codes_plain(torch.from_numpy(d),
                                                 torch.from_numpy(p), bits)
    np.testing.assert_array_equal(codes, want_codes.numpy())
    np.testing.assert_array_equal(terms.view(np.int32),
                                  want_terms.numpy().view(np.int32))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_on_cpu_is_the_plain_version(name, bits):
    d, p = (torch.from_numpy(a) for a in CASES[name])
    launches = line_codes.launches
    codes, terms = line_codes(d, p, bits)
    want_codes, want_terms = TL.line_codes_plain(d, p, bits)
    assert torch.equal(codes, want_codes)
    assert torch.equal(terms.view(torch.int32), want_terms.view(torch.int32))
    assert line_codes.launches == launches       # no kernel on the CPU


def _bad_inputs():
    d = torch.zeros((8, 4, 16))
    p = torch.zeros((4, 16, 16))
    yield "meta device", d.to("meta"), p.to("meta"), 16
    yield "distances on meta", d.to("meta"), p, 16
    yield "non-contiguous", d.transpose(1, 2).contiguous().transpose(1, 2), \
        p, 16
    yield "float64", d.double(), p.double(), 16
    yield "int32", d.int(), p.int(), 16
    yield "pair of another lp", d, torch.zeros((3, 16, 16)), 16
    yield "pair of another c1", d, torch.zeros((4, 8, 8)), 16
    yield "2-D", d[:, 0], p, 16
    yield "lambda_bits 4", d, p, 4
    yield "c1 257", torch.zeros((2, 1, 257)), torch.zeros((1, 257, 257)), 16


@pytest.mark.parametrize("case", list(_bad_inputs()), ids=lambda c: c[0])
def test_wrapper_refuses(case):
    _, d, p, bits = case
    with pytest.raises(ValueError):
        line_codes(d, p, bits)


def test_wrapper_takes_no_rows():
    codes, terms = line_codes(torch.zeros((0, 32, 16)),
                              torch.zeros((32, 16, 16)))
    assert codes.shape == terms.shape == (0, 32)


def test_encode_reaches_the_kernel_wrapper(monkeypatch, clustered_data):
    """encode_line_codes, and so every build, calls
    ops.cuda.linecodes.line_codes once a chunk, with contiguous tables."""
    db_vecs, _ = clustered_data
    cfg = T.PQTConfig(dim=32, p=4, c1=4, c2=4, line_parts=8,
                      hash_size=1 << 10, k1_build=4, k1_query=4,
                      kmeans_iters=3)
    tree = T.train_tree(cfg, db_vecs[:600], device="cpu")
    want = T.build_database(cfg, tree, db_vecs[:600], encode_chunk=256,
                            device="cpu")
    calls = []

    def spy(part_dists, pair_dists, lambda_bits=16):
        calls.append((tuple(part_dists.shape), part_dists.is_contiguous(),
                      lambda_bits))
        return TL.line_codes_plain(part_dists, pair_dists, lambda_bits)

    monkeypatch.setattr(LC, "line_codes", spy)
    got = T.build_database(cfg, tree, db_vecs[:600], encode_chunk=256,
                           device="cpu")
    assert calls == [((256, 8, 4), True, 8), ((256, 8, 4), True, 8),
                     ((88, 8, 4), True, 8)]
    assert torch.equal(got.payload, want.payload)
    calls.clear()
    TDB.encode_line_codes(cfg, tree, torch.from_numpy(db_vecs[:10]))
    assert len(calls) == 1


def test_kernel_is_built_and_counted():
    """The wrapper is one of the counted kernel wrappers; its source is
    built with the others, and its C entry point takes the arguments the
    wrapper's signature declares."""
    assert LC.line_codes in graphs.kernel_wrappers()
    argtypes, _ = build._SIGNATURES["linecodes"]["pqt_line_codes"]
    src = (build.CSRC / "linecodes.cu").read_text()
    params = re.search(r'extern "C" int pqt_line_codes\(([^)]*)\)', src)
    assert params and len(params.group(1).split(",")) == len(argtypes)
    assert LC.LINE_CODES_MAX_C1 == int(
        re.search(r"kMaxC1 = (\d+);", src).group(1))


def test_encode_line_codes_matches_jax():
    """The slice as a whole: the port's encode_line_codes (line tables,
    kernel L's plain version, the sum) against the JAX package's jitted
    encode_line_codes, on one tree at SIFT1B's widths (dim 128, p 4, c1
    16, lp 32) and the compact payload's 8-bit lambda."""
    from pqt_tpu.config import SIFT1B_CONFIG
    rng = np.random.default_rng(7)
    cfg = SIFT1B_CONFIG
    cb1 = rng.uniform(0, 140, (cfg.p, cfg.c1, cfg.vl)).astype(np.float32)
    cb2 = (cb1[:, :, None, :] + rng.normal(
        0, 5, (cfg.p, cfg.c1, cfg.c2, cfg.vl))).astype(np.float32)
    x = rng.integers(0, 256, (300, cfg.dim)).astype(np.float32)
    jtree = JTree.from_codebooks(cfg, jnp.asarray(cb1), jnp.asarray(cb2))
    tcfg = T.PQTConfig.from_json(cfg.to_json())
    ttree = T.PQTree.from_numpy(tcfg, cb1, cb2, device="cpu")
    jcodes, jt3 = JDB.encode_line_codes(cfg, jtree, jnp.asarray(x))
    codes, t3 = TDB.encode_line_codes(tcfg, ttree, torch.from_numpy(x))
    ld = line_tables(tcfg, ttree, torch.from_numpy(x)).contiguous()
    _assert_matches_jax(ld.numpy(), ttree.pair_dists.numpy(), (codes, t3),
                        (np.asarray(jcodes).astype(np.int64),
                         np.asarray(jt3)))
