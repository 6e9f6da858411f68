"""Kernel L, the build's line-code selection (`line_codes`,
csrc/linecodes.cu), against the JAX package, and the build's routing
through it.

Kernel L takes the line tables' terms (the line GEMM's output and the
norms) and forms the segment distances itself.  On CPU tensors `line_codes`
runs its plain version, `line_codes_from_terms_plain`: the tables' passes,
then `line_codes_plain` over the tables; chip_smoke.py holds the CUDA
kernel against that plain version on the card, to the bit.  Here:

* `line_codes_plain` with its terms summed is held against the JAX
  package's `build_line_codes` as its encode runs it, jitted (the fused
  reduce XLA makes of pqt_tpu/ops/linecodes.py:77-105, which kernel L
  takes the place of), at SIFT1M's and SIFT1B's (lp, c1) and at both
  lambda widths, on hard rows, and at other c1 (the kernel's loop route);
  so is the port's `build_line_codes`, fed terms that reproduce each case's
  tables exactly (dot = -d / 2, zero norms); and the port's
  `encode_line_codes` against the JAX package's on one tree at SIFT1B
  width;
* a numpy model of the kernel's walk (one (row, part) at a time, the pairs
  A < B in flat order A * c1 + B, every operation rounded on its own, the
  scan starting at the masked index 0, a NaN the least residual, the
  quantiser's truncation with a NaN lambda at 0) is held to the plain
  version to the bit on the same rows: what the kernel computes, checked
  where no card is;
* the wrapper on CPU tensors equals the plain version to the bit, refuses
  what the kernel does not take, and every build reaches it;
* on real terms (the GEMM's output as it lies, the norms) the wrapper and
  the build's `encode_line_codes` equal `line_codes_plain` over the tables
  `subpart_sqdist_tables` makes, to the bit, at SIFT1M's, SIFT1B's and
  GIST's widths, on rows whose distances clamp at 0 and rows with inf or
  NaN, and so does the numpy model with the kernel's epilogue; the queries'
  `line_tables` is the chain it was.

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
from pqt_tpu_torch.ops import distance as TD
from pqt_tpu_torch.ops import linecodes as TL
from pqt_tpu_torch.ops.cuda import primitives
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


def _as_terms(d):
    """Terms (dot, xn, cn) whose distances clamp_min(xn + cn - 2 dot, 0)
    are the tables d (n, lp, c1) to the bit: dot = -d / 2 (exact: no case
    holds a subnormal or a negative distance) and zero norms."""
    n, lp, c1 = d.shape
    dot = torch.from_numpy(d * np.float32(-0.5))
    xn, cn = torch.zeros((n, lp)), torch.zeros((c1, lp))
    np.testing.assert_array_equal(
        TD.subpart_sqdist_from_terms(dot, xn, cn).numpy(), d)
    return dot, xn, cn


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
    """build_line_codes (the wrapper, then the sum over the line parts), fed
    terms whose distances are the case's tables."""
    d, p = CASES[name]
    got = TL.build_line_codes(*_as_terms(d), torch.from_numpy(p), bits)
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
    d, p = CASES[name]
    launches = line_codes.launches
    codes, terms = line_codes(*_as_terms(d), torch.from_numpy(p), bits)
    want_codes, want_terms = TL.line_codes_plain(torch.from_numpy(d),
                                                 torch.from_numpy(p), bits)
    assert torch.equal(codes, want_codes)
    assert torch.equal(terms.view(torch.int32), want_terms.view(torch.int32))
    assert line_codes.launches == launches       # no kernel on the CPU


def _bad_inputs():
    dot, xn, cn = TD.subpart_sqdist_terms(torch.zeros((8, 64)),
                                          torch.zeros((16, 64)), 4)
    p = torch.zeros((4, 16, 16))
    yield "meta device", dot.to("meta"), xn.to("meta"), cn.to("meta"), \
        p.to("meta"), 16
    yield "dot on meta", dot.to("meta"), xn, cn, p, 16
    yield "xn on meta", dot, xn.to("meta"), cn, p, 16
    yield "cn on meta", dot, xn, cn.to("meta"), p, 16
    yield "non-contiguous pair", dot, xn, cn, \
        p.transpose(1, 2).contiguous().transpose(1, 2), 16
    yield "xn non-contiguous", dot, xn.T.contiguous().T, cn, p, 16
    yield "float64", dot.double(), xn.double(), cn.double(), p.double(), 16
    yield "int32", dot.int(), xn.int(), cn.int(), p.int(), 16
    yield "xn float64", dot, xn.double(), cn, p, 16
    yield "cn int32", dot, xn, cn.int(), p, 16
    yield "pair of another lp", dot, xn, cn, torch.zeros((3, 16, 16)), 16
    yield "pair of another c1", dot, xn, cn, torch.zeros((4, 8, 8)), 16
    yield "dot of another c1", dot[:, :, :8], xn, cn, p, 16
    yield "xn of another lp", dot, xn[:, :3], cn, p, 16
    yield "xn of another n", dot, xn[:7], cn, p, 16
    yield "cn transposed", dot, xn, cn.T.contiguous(), p, 16
    yield "cn of another c1", dot, xn, cn[:8], p, 16
    yield "2-D", dot[:, 0], xn, cn, p, 16
    yield "lambda_bits 4", dot, xn, cn, p, 4
    yield "c1 257", torch.zeros((2, 1, 257)), torch.zeros((2, 1)), \
        torch.zeros((257, 1)), torch.zeros((1, 257, 257)), 16


@pytest.mark.parametrize("case", list(_bad_inputs()), ids=lambda c: c[0])
def test_wrapper_refuses(case):
    _, dot, xn, cn, p, bits = case
    with pytest.raises(ValueError):
        line_codes(dot, xn, cn, p, bits)


def test_wrapper_takes_no_rows():
    codes, terms = line_codes(torch.zeros((0, 32, 16)),
                              torch.zeros((0, 32)), torch.zeros((16, 32)),
                              torch.zeros((32, 16, 16)))
    assert codes.shape == terms.shape == (0, 32)


def test_encode_reaches_the_kernel_wrapper(monkeypatch, clustered_data):
    """encode_line_codes, and so every build, calls ops.cuda.linecodes.
    line_codes once a chunk, with the line GEMM's output as it lies (each
    (row, part)'s c1 values contiguous)."""
    db_vecs, _ = clustered_data
    cfg = T.PQTConfig(dim=32, p=4, c1=4, c2=4, line_parts=8,
                      hash_size=1 << 10, k1_build=4, k1_query=4,
                      kmeans_iters=3)
    tree = T.train_tree(cfg, db_vecs[:600], device="cpu")
    want = T.build_database(cfg, tree, db_vecs[:600], encode_chunk=256,
                            device="cpu")
    calls = []

    def spy(dot, xn, cn, pair_dists, lambda_bits=16):
        calls.append((tuple(dot.shape), dot.stride(), lambda_bits))
        return TL.line_codes_from_terms_plain(dot, xn, cn, pair_dists,
                                              lambda_bits)

    monkeypatch.setattr(LC, "line_codes", spy)
    got = T.build_database(cfg, tree, db_vecs[:600], encode_chunk=256,
                           device="cpu")
    assert calls == [((256, 8, 4), (4, 256 * 4, 1), 8),
                     ((256, 8, 4), (4, 256 * 4, 1), 8),
                     ((88, 8, 4), (4, 88 * 4, 1), 8)]
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
    """The slice as a whole, and the one place the build's route is held
    against the JAX package: the port's encode_line_codes (the line GEMM's
    output and the norms, then kernel L's plain version -- the tables'
    epilogue and the pair walk -- and the sum) against the JAX package's
    jitted encode_line_codes, on one tree at SIFT1B's widths (dim 128, p 4,
    c1 16, lp 32) and the compact payload's 8-bit lambda."""
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


# ---------------------------------------------------------------------------
# real terms: the line GEMM's output and the norms, the tables' epilogue in
# the kernel
# ---------------------------------------------------------------------------

def _make_term_cases():
    """{name: (x (n, dim), centroids (c1, dim), lp)} float32 at the presets'
    widths (c1 16): rows about the line between two centroids, rows equal
    to a centroid (float centroids, so some segment distances round below
    0 and clamp), and rows holding inf and NaN."""
    rng = np.random.default_rng(24)
    cases = {}
    for name, dim, lp in (("sift1m", 128, 16), ("sift1b", 128, 32),
                          ("gist", 960, 32)):
        cent = rng.uniform(0, 140, (16, dim)).astype(np.float32)
        i, j = rng.integers(0, 16, 300), rng.integers(0, 16, 300)
        t = rng.uniform(-0.2, 1.2, (300, 1))
        x = np.clip(np.round((1 - t) * cent[i] + t * cent[j]
                             + rng.normal(0, 8.0, (300, dim))), 0, 255)
        x = x.astype(np.float32)
        x[:40] = cent[rng.integers(0, 16, 40)]
        x[40, 5] = np.inf
        x[41, :] = np.inf
        x[42, 3 * dim // lp] = np.nan
        x[43, 7] = -np.inf
        cases[name] = (x, cent, lp)
    return cases


TERM_CASES = _make_term_cases()


def _terms(name):
    x, cent, lp = TERM_CASES[name]
    return TD.subpart_sqdist_terms(torch.from_numpy(x),
                                   torch.from_numpy(cent), lp)


def _pair(name):
    _, cent, lp = TERM_CASES[name]
    return TD.centroid_pair_sqdist(torch.from_numpy(cent), lp)


def test_term_cases_reach_the_epilogue_edges():
    """Each case has segment distances that clamp at 0, infinite ones and
    NaN ones."""
    for name in TERM_CASES:
        dot, xn, cn = _terms(name)
        with np.errstate(all="ignore"):
            raw = (xn[:, :, None] + cn.T[None]) - 2.0 * dot
        assert (raw < 0).any() and torch.isinf(raw).any()
        assert torch.isnan(raw).any()


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", sorted(TERM_CASES))
def test_wrapper_equals_plain_over_tables(name, bits):
    """The wrapper, and its plain version, equal `line_codes_plain` over the
    tables `subpart_sqdist_tables` makes, to the bit; the GEMM's output
    comes out with each (row, part)'s c1 values contiguous, as the kernel
    reads it."""
    x, cent, lp = TERM_CASES[name]
    dot, xn, cn = _terms(name)
    assert dot.stride(2) == 1
    p = _pair(name)
    tables = TD.subpart_sqdist_tables(torch.from_numpy(x),
                                      torch.from_numpy(cent), lp)
    want = TL.line_codes_plain(tables, p, bits)
    for got in (line_codes(dot, xn, cn, p, bits),
                TL.line_codes_from_terms_plain(dot, xn, cn, p, bits)):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))


def _epilogue_model(dot, xn, cn):
    """csrc/linecodes.cu line_dist on numpy float32: the add, the doubling
    and the subtraction each rounded on its own, then the clamp at 0 with a
    NaN kept."""
    f32 = np.float32
    with np.errstate(all="ignore"):
        t = (xn[:, :, None] + cn.T[None, :, :]) - f32(2.0) * dot
    return np.where(np.isnan(t), t, np.maximum(t, f32(0.0))).astype(f32)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("name", sorted(TERM_CASES))
def test_kernel_model_with_epilogue_matches_plain(name, bits):
    """The numpy model of the kernel on real terms (the epilogue, then the
    walk of `_kernel_model`) equals the plain chain to the bit."""
    dot, xn, cn = _terms(name)
    p = _pair(name)
    d = _epilogue_model(dot.numpy(), xn.numpy(), cn.numpy())
    codes, terms = _kernel_model(d, p.numpy(), bits)
    want_codes, want_terms = TL.line_codes_from_terms_plain(dot, xn, cn, p,
                                                            bits)
    np.testing.assert_array_equal(codes, want_codes.numpy())
    np.testing.assert_array_equal(terms.view(np.int32),
                                  want_terms.numpy().view(np.int32))


@pytest.mark.parametrize("cfg_name", ["SIFT1M_CONFIG", "SIFT1B_CONFIG",
                                      "GIST1M_CONFIG"])
def test_encode_line_codes_equals_plain_over_line_tables(cfg_name):
    """The build's encode_line_codes equals `line_codes_plain` over the
    queries' `line_tables` of the same rows, its terms summed, to the bit,
    at each preset's widths and lambda grid."""
    cfg = getattr(T.config, cfg_name)
    x, cent, _ = TERM_CASES["gist" if cfg.dim == 960 else "sift1b"]
    rng = np.random.default_rng(5)
    cb1 = cent.reshape(16, cfg.p, cfg.vl).transpose(1, 0, 2).copy()
    cb2 = (cb1[:, :, None, :] + rng.normal(
        0, 5, (cfg.p, cfg.c1, cfg.c2, cfg.vl))).astype(np.float32)
    tree = T.PQTree.from_numpy(cfg, cb1, cb2, device="cpu")
    xt = torch.from_numpy(x)
    codes, t3 = TDB.encode_line_codes(cfg, tree, xt)
    want, terms = TL.line_codes_plain(line_tables(cfg, tree, xt),
                                      tree.pair_dists,
                                      cfg.effective_lambda_bits)
    assert torch.equal(codes, want)
    assert torch.equal(t3.view(torch.int32),
                       torch.sum(terms, dim=-1).view(torch.int32))


def test_query_line_tables_unchanged():
    """The queries' line tables (models/tree.py line_tables, through
    subpart_sqdist_tables) are the chain they were before the split, to
    the bit and with the same strides: the einsum, kernel D's norms, the
    centroid norms, then clamp_min(xn + cn - 2 dot, 0)."""
    cfg = T.config.SIFT1M_CONFIG
    x, cent, lp = TERM_CASES["sift1m"]
    rng = np.random.default_rng(6)
    cb1 = cent.reshape(16, cfg.p, cfg.vl).transpose(1, 0, 2).copy()
    cb2 = (cb1[:, :, None, :] + rng.normal(
        0, 5, (cfg.p, cfg.c1, cfg.c2, cfg.vl))).astype(np.float32)
    tree = T.PQTree.from_numpy(cfg, cb1, cb2, device="cpu")
    q = torch.from_numpy(x)
    got = line_tables(cfg, tree, q)
    xp = q.reshape(q.shape[0], lp, -1)
    cp = tree.centroids_full.reshape(16, lp, -1)
    dot = torch.einsum("nlv,clv->nlc", xp, cp)
    xn = primitives.segmented_reduce(q, lp, square=True)
    cn = torch.sum(cp * cp, dim=-1)
    want = torch.clamp_min(xn[:, :, None] + cn.T[None, :, :] - 2.0 * dot,
                           0.0)
    assert got.stride() == want.stride()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
