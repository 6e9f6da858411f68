"""Kernel P, the build's part codes (`part_codes`, csrc/partcodes.cu),
against the JAX package, and the build's routing through it.

On a CPU tensor `part_codes` runs its plain version, `part_codes_plain`
(ops/distance.py: the level-2 tables op by op, then torch.argmin);
chip_smoke.py holds the CUDA kernel against that plain version on the card.
Here:

* the plain version is held against the JAX package's jitted
  `encode_part_codes` (the tables and the argmin XLA fuses, which kernel P
  takes the place of) at a small width and at SIFT1B's, and the port's
  `encode_part_codes` against it on the same trees;
* a numpy model of the kernel's arithmetic (each dot summed by float32
  FMAs in dimension order, the epilogue's roundings (xn + cn) - 2 * dot,
  the clamp, the first least value with a NaN the least) is held to the
  plain version: equal to the bit where every dot is exact (integer rows
  and codebooks, the tie and NaN cases), else every differing pick a
  near-tie -- what the kernel computes, checked where no card is;
* the wrapper on CPU tensors equals the plain version to the bit, refuses
  what the kernel does not take, and every build with k1_build >= c1
  reaches it (and none with k1_build < c1).

Inputs are made with numpy from a seed.

Tolerances.  Two float32 evaluations of (xn + cn) - 2 * dot that sum the
dot in different orders differ by a few units in the last place of the
operands, xn + cn, not of the distance: the identity cancels.  A pick
that differs is a near-tie when the float64 distances of the two picks
are within NEAR_TIE * (xn + cn) of each other (2^-20, 16 units in the last
place of a float32 of that size); at most 0.1% of the codes may differ.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqt_tpu.config import SIFT1B_CONFIG
from pqt_tpu.models import db as JDB
from pqt_tpu.models.tree import PQTree as JTree
import pqt_tpu_torch as T
from pqt_tpu_torch.models import db as TDB
from pqt_tpu_torch.ops import distance as TD
from pqt_tpu_torch.ops.cuda import build
from pqt_tpu_torch.ops.cuda import partcodes as PC
from pqt_tpu_torch.ops.cuda.partcodes import part_codes
from pqt_tpu_torch.utils import graphs

NEAR_TIE = 2.0 ** -20
SMALL_CFG = SIFT1B_CONFIG.replace(dim=32, c1=4, c2=4, line_parts=8,
                                  k1_build=4, k1_query=4, hash_size=1 << 12)
WIDTHS = {"small": SMALL_CFG, "sift1b": SIFT1B_CONFIG}
_JAX_CODES = jax.jit(JDB.encode_part_codes, static_argnums=(0,))


def _trees(cfg, rng):
    """(rows (n, dim) float32 integers in [0, 255], cb1, cb2) about random
    L1 centroids in [0, 140)."""
    cb1 = rng.uniform(0, 140, (cfg.p, cfg.c1, cfg.vl)).astype(np.float32)
    cb2 = (cb1[:, :, None, :] + rng.normal(
        0, 5, (cfg.p, cfg.c1, cfg.c2, cfg.vl))).astype(np.float32)
    pick = rng.integers(0, cfg.c1, (400, cfg.p))
    x = cb1[np.arange(cfg.p)[None, :], pick].reshape(400, cfg.dim)
    x = np.clip(np.round(x + rng.normal(0, 8, x.shape)), 0, 255)
    return x.astype(np.float32), cb1, cb2


TREES = {name: _trees(cfg, np.random.default_rng(22 + i))
         for i, (name, cfg) in enumerate(sorted(WIDTHS.items()))}


def _near_ties(x, cb, got, want):
    """Whether every (row, part) where the picks differ is a near-tie (the
    module docstring), and the share of codes that differ."""
    n, p = got.shape
    differ = got != want
    if not differ.any():
        return True, 0.0
    rows, parts = np.nonzero(differ)
    xs = x.astype(np.float64).reshape(n, p, -1)[rows, parts]
    c = cb.astype(np.float64)

    def dist(j):
        return ((xs - c[parts, j[rows, parts]]) ** 2).sum(-1)

    scale = (xs ** 2).sum(-1) + np.maximum(
        (c[parts, got[rows, parts]] ** 2).sum(-1),
        (c[parts, want[rows, parts]] ** 2).sum(-1))
    near = np.abs(dist(got) - dist(want)) <= NEAR_TIE * scale
    return bool(near.all()), float(differ.mean())


def _flat(cfg, cb2):
    return np.ascontiguousarray(cb2.reshape(cfg.p, cfg.c1 * cfg.c2, cfg.vl))


def _plain(x, cb):
    return TD.part_codes_plain(*TD.part_norms(torch.from_numpy(x),
                                              torch.from_numpy(cb))).numpy()


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_plain_matches_jax(name):
    cfg = WIDTHS[name]
    x, cb1, cb2 = TREES[name]
    jtree = JTree.from_codebooks(cfg, jnp.asarray(cb1), jnp.asarray(cb2))
    want = np.asarray(_JAX_CODES(cfg, jtree, jnp.asarray(x))).astype(np.int64)
    got = _plain(x, _flat(cfg, cb2))
    near, share = _near_ties(x, _flat(cfg, cb2), got, want)
    assert near and share <= 0.001, share
    # the port's encode, which reaches the plain version through the wrapper
    tcfg = T.PQTConfig.from_json(cfg.to_json())
    ttree = T.PQTree.from_numpy(tcfg, cb1, cb2, device="cpu")
    enc = TDB.encode_part_codes(tcfg, ttree, torch.from_numpy(x))
    assert enc.dtype == torch.int64
    np.testing.assert_array_equal(enc.numpy(), got)


def _fma32(a, b, c):
    """float32 a * b + c rounded once, as the kernel's FMA: the product is
    exact in float64, the sum is rounded there with its error kept (two-sum),
    and a float64 sum that lands on a float32 midpoint is rounded toward the
    error's side (numpy has no float32 fma)."""
    with np.errstate(all="ignore"):
        p = a.astype(np.float64) * b
        c = np.broadcast_to(c.astype(np.float64), p.shape)
        s = p + c
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > r64, np.float32(np.inf),
                                     np.float32(-np.inf)))
    mid = (s != r64) & ((r64 + other.astype(np.float64)) * 0.5 == s) \
        & (err != 0)
    toward_other = (err > 0) == (other > r)
    return np.where(mid & toward_other, other, r)


def _kernel_model(x, cb, cn, xn):
    """csrc/partcodes.cu's arithmetic on numpy float32, all rows at once:
    each dot a chain of FMAs in dimension order from +0, then (xn + cn) -
    2 * dot rounded at each step, the clamp, a NaN held as -1, and the first
    least value."""
    n = x.shape[0]
    p, k, vl = cb.shape
    xs = x.reshape(n, p, 1, vl)
    dot = np.zeros((n, p, k), np.float32)
    for v in range(vl):
        dot = _fma32(xs[..., v], cb[None, :, :, v], dot)
    with np.errstate(all="ignore"):
        d = (xn[:, :, None] + cn[None]) - np.float32(2.0) * dot
    val = np.where(np.isnan(d), np.float32(-1.0),
                   np.maximum(d, np.float32(0.0)))
    return np.argmin(val, axis=-1)


def _model_cases():
    """{name: (x (n, p * vl), codebook (p, k, vl)) float32, the share of
    codes that may differ, each at a near-tie}: none where every product
    and sum is an integer that float32 holds."""
    rng = np.random.default_rng(23)
    cases = {}
    for name, cfg in sorted(WIDTHS.items()):
        x, _, cb2 = TREES[name]
        cases[name] = (x, _flat(cfg, cb2), 0.001)
    # GIST's part width (vl 240): the kernel's loop route
    cb = rng.uniform(0, 140, (4, 256, 240)).astype(np.float32)
    x = np.clip(np.round(cb[np.arange(4)[None, :], rng.integers(0, 256, (
        48, 4))].reshape(48, 960) + rng.normal(0, 8, (48, 960))), 0, 255)
    cases["gist_vl240"] = (x.astype(np.float32), cb, 0.001)
    # small integers: exact distances, ties everywhere (the first wins)
    cases["integer_ties"] = (
        rng.integers(0, 3, (300, 4 * 8)).astype(np.float32),
        rng.integers(0, 3, (4, 16, 8)).astype(np.float32), 0.0)
    # rows on a centroid (distance 0), a centroid twice, coincident parts
    cb = rng.integers(0, 20, (4, 16, 8)).astype(np.float32)
    cb[:, 9] = cb[:, 3]
    x = cb[np.arange(4)[None, :], rng.integers(0, 16, (200, 4))]
    cases["on_centroids"] = (x.reshape(200, 32).copy(), cb, 0.0)
    # NaN and infinite rows and centroids: a NaN distance is the least
    x = rng.integers(0, 20, (60, 32)).astype(np.float32)
    cb = rng.integers(0, 20, (4, 16, 8)).astype(np.float32)
    x[0, 0] = np.nan
    x[1] = np.inf
    x[2, 8:16] = -np.inf
    cb[2, 5, 0] = np.nan
    cb[3, 7] = np.inf
    cases["nan_inf"] = (x, cb, 0.0)
    # rows halfway between two centroids of fractional values: ties in
    # exact arithmetic that each float32 evaluation breaks its own way
    cb = rng.uniform(0, 140, (4, 16, 8)).astype(np.float32)
    a, b = rng.integers(0, 16, (2, 400, 4))
    parts = np.arange(4)[None, :]
    x = (cb[parts, a] + cb[parts, b]) * np.float32(0.5)
    cases["midpoints"] = (x.reshape(400, 32), cb, 1.0)
    return cases


MODEL_CASES = _model_cases()


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_kernel_model_matches_plain(name):
    x, cb, share = MODEL_CASES[name]
    xt, cbt, cn, xn = TD.part_norms(torch.from_numpy(x), torch.from_numpy(cb))
    want = TD.part_codes_plain(xt, cbt, cn, xn).numpy()
    got = _kernel_model(x, cb, cn.numpy(), xn.numpy())
    if share == 0.0:
        np.testing.assert_array_equal(got, want)
    near, differ = _near_ties(x, cb, got, want)
    assert near and differ <= share, differ


def test_fma_model_rounds_once():
    """_fma32 against exact rational arithmetic: products that land on a
    float32 midpoint with an addend below float64's reach (the correction),
    and random ones."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    m = np.float32(1 + 2.0 ** -12)   # m * m = 1 + 2^-11 + 2^-24, a midpoint
    a = np.concatenate([[m, m, m], rng.uniform(-1e3, 1e3, 2000)])
    b = np.concatenate([[m, m, m], rng.uniform(-1e3, 1e3, 2000)])
    c = np.concatenate([[2.0 ** -80, -2.0 ** -80, 0.0],
                        rng.uniform(-1e6, 1e6, 2000)])
    a, b, c = (v.astype(np.float32) for v in (a, b, c))
    got = _fma32(a, b, c)
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        r = np.float32(float(exact))
        near = [np.nextafter(r, np.float32(-np.inf)), r,
                np.nextafter(r, np.float32(np.inf))]
        want = min(near, key=lambda f: (abs(Fraction(float(f)) - exact),
                                        int(f.view(np.int32)) & 1))
        assert got[i] == want, (i, a[i], b[i], c[i], got[i], want)
    # toward the addend's side, and the exact midpoint to even (below)
    assert got[0] > got[1] == got[2]


def test_near_tie_rule():
    """_near_ties accepts the two ends of a row halfway between two
    centroids, and refuses a pick of another centroid."""
    rng = np.random.default_rng(24)
    cb = rng.uniform(0, 140, (4, 16, 8)).astype(np.float32)
    a = np.tile(np.arange(16), (4, 1)).T                       # (16, 4)
    b = (a + 1 + rng.integers(0, 15, a.shape)) % 16
    parts = np.arange(4)[None, :]
    x = ((cb[parts, a] + cb[parts, b]) * np.float32(0.5)).reshape(16, 32)
    assert _near_ties(x, cb, a, b) == (True, 1.0)
    c = (b + 1 + rng.integers(0, 14, a.shape)) % 16
    c = np.where(c == a, (c + 1) % 16, c)
    assert not _near_ties(x, cb, a, c)[0]


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_wrapper_on_cpu_is_the_plain_version(name):
    x, cb, _ = MODEL_CASES[name]
    args = TD.part_norms(torch.from_numpy(x), torch.from_numpy(cb))
    launches = part_codes.launches
    got = part_codes(*args)
    assert torch.equal(got, TD.part_codes_plain(*args))
    assert got.dtype == torch.int64 and got.shape == (x.shape[0], cb.shape[0])
    assert part_codes.launches == launches       # no kernel on the CPU


def _bad_inputs():
    x, cb = torch.zeros((8, 32)), torch.zeros((4, 16, 8))
    cn, xn = torch.zeros((4, 16)), torch.zeros((8, 4))
    yield "meta device", x.to("meta"), cb.to("meta"), cn.to("meta"), \
        xn.to("meta")
    yield "codebook on meta", x, cb.to("meta"), cn, xn
    yield "norms on meta", x, cb, cn, xn.to("meta")
    yield "non-contiguous rows", x.T.contiguous().T, cb, cn, xn
    yield "non-contiguous codebook", x, \
        cb.transpose(1, 2).contiguous().transpose(1, 2), cn, xn
    yield "non-contiguous norms", x, cb, cn, xn.T.contiguous().T
    yield "float64", x.double(), cb.double(), cn.double(), xn.double()
    yield "float64 codebook", x, cb.double(), cn, xn
    yield "int32 norms", x, cb, cn.int(), xn
    yield "rows of another width", torch.zeros((8, 24)), cb, cn, xn
    yield "norms of another k", x, cb, torch.zeros((4, 8)), xn
    yield "norms of another p", x, cb, cn, torch.zeros((8, 2))
    yield "norms of other rows", x, cb, cn, torch.zeros((9, 4))
    yield "no centroids", x, torch.zeros((4, 0, 8)), torch.zeros((4, 0)), xn
    yield "1-D rows", x[0], cb, cn, xn
    yield "2-D codebook", x, cb[0], cn, xn


@pytest.mark.parametrize("case", list(_bad_inputs()), ids=lambda c: c[0])
def test_wrapper_refuses(case):
    with pytest.raises(ValueError):
        part_codes(*case[1:])


def test_wrapper_takes_no_rows():
    codes = part_codes(torch.zeros((0, 32)), torch.zeros((4, 16, 8)),
                       torch.zeros((4, 16)), torch.zeros((0, 4)))
    assert codes.shape == (0, 4) and codes.dtype == torch.int64


@pytest.mark.parametrize("k1_build", [4, 2])
def test_encode_reaches_the_kernel_wrapper(monkeypatch, clustered_data,
                                           k1_build):
    """encode_part_codes, and so every build, calls
    ops.cuda.partcodes.part_codes once a chunk with k1_build >= c1, with
    contiguous float32 inputs; with k1_build < c1 it keeps the level-1
    top-k route and never calls it."""
    db_vecs, _ = clustered_data
    cfg = T.PQTConfig(dim=32, p=4, c1=4, c2=4, line_parts=8,
                      hash_size=1 << 10, k1_build=k1_build, k1_query=4,
                      kmeans_iters=3)
    tree = T.train_tree(cfg, db_vecs[:600], device="cpu")
    want = T.build_database(cfg, tree, db_vecs[:600], encode_chunk=256,
                            device="cpu")
    calls = []

    def spy(x, codebook, cn, xn):
        calls.append((tuple(x.shape), tuple(codebook.shape),
                      all(t.is_contiguous() and t.dtype == torch.float32
                          for t in (x, codebook, cn, xn))))
        return TD.part_codes_plain(x, codebook, cn, xn)

    monkeypatch.setattr(PC, "part_codes", spy)
    got = T.build_database(cfg, tree, db_vecs[:600], encode_chunk=256,
                           device="cpu")
    for name in ("prefix", "counts", "payload"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    if k1_build < cfg.c1:
        assert calls == []
        return
    assert calls == [((256, 32), (4, 16, 8), True)] * 2 + [
        ((88, 32), (4, 16, 8), True)]
    calls.clear()
    TDB.encode_bins(cfg, tree, torch.from_numpy(db_vecs[:10]).double())
    assert calls == [((10, 32), (4, 16, 8), True)]


def test_kernel_is_built_and_counted():
    """The wrapper is one of the counted kernel wrappers; its source is
    built with the others, and its C entry point takes the arguments the
    wrapper's signature declares."""
    assert PC.part_codes in graphs.kernel_wrappers()
    argtypes, _ = build._SIGNATURES["partcodes"]["pqt_part_codes"]
    src = (build.CSRC / "partcodes.cu").read_text()
    params = re.search(r'extern "C" int pqt_part_codes\(([^)]*)\)', src)
    assert params and len(params.group(1).split(",")) == len(argtypes)
