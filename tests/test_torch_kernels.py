"""The port's kernel wrappers (plain versions on the CPU) against the JAX
package's Pallas kernels, run in interpret mode as tests/test_pallas_*.py
run them.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import pqt_tpu.utils.cache
from pqt_tpu.models.db import pack_payload_compact
from pqt_tpu.ops.pallas import primitives as PP
from pqt_tpu.ops.pallas.rerank import BLOCK, rerank_fused as pallas_rerank
from pqt_tpu_torch.ops.cuda.gather import gather_rows, lut_gather
from pqt_tpu_torch.ops.cuda.primitives import (bitonic_topk, block_scan,
                                               segmented_reduce)
from pqt_tpu_torch.ops.cuda.rerank import rerank_fused

BENCHMARKS = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"


@pytest.mark.parametrize("n,k", [(16, 8), (1024, 100), (16384, 128)])
def test_topk_matches_pallas_bitonic(n, k):
    rng = np.random.default_rng(n + k)
    x = rng.normal(0, 1, (8, n)).astype(np.float32)
    want_v, want_i = PP.bitonic_topk(jnp.asarray(x), k, interpret=True)
    got_v, got_i = bitonic_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # distinct values: the index of each value is unique
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("n,k", [(512, 16), (1024, 100)])
def test_topk_ties_follow_lax_top_k(n, k):
    """With duplicates (test_pallas_primitives.py's generator) the values
    equal the Pallas kernel's and the indices equal lax.top_k's: ties come
    out lowest index first, which the Pallas network does not promise."""
    rng = np.random.default_rng(3 * n + k)
    x = rng.integers(0, 8, (8, n)).astype(np.float32)
    x[:, ::7] = np.inf
    want_v, _ = PP.bitonic_topk(jnp.asarray(x), k, interpret=True)
    neg, lax_i = jax.lax.top_k(-jnp.asarray(x), k)
    got_v, got_i = bitonic_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_v.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(lax_i))


def test_topk_non_power_of_two_row():
    rng = np.random.default_rng(800)
    x = rng.integers(0, 50, (16, 800)).astype(np.float32)
    neg, lax_i = jax.lax.top_k(-jnp.asarray(x), 100)
    got_v, got_i = bitonic_topk(torch.from_numpy(x), 100)
    np.testing.assert_array_equal(got_v.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(lax_i))


@pytest.mark.parametrize("shape", [(8, 512), (1, 1 << 20)])
@pytest.mark.parametrize("exclusive", [False, True])
def test_block_scan_matches_pallas(shape, exclusive):
    rng = np.random.default_rng(shape[1])
    x = rng.integers(0, 100, shape).astype(np.int32)
    want = PP.block_scan(jnp.asarray(x), exclusive=exclusive, interpret=True)
    got = block_scan(torch.from_numpy(x), exclusive)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_payload(rng, n, lp):
    """test_pallas_rerank.py's generator: random compact payload rows."""
    a = rng.integers(0, 16, (n, lp)).astype(np.uint32)
    b = rng.integers(0, 16, (n, lp)).astype(np.uint32)
    lam8 = rng.integers(0, 256, (n, lp)).astype(np.uint32)
    codes = a | (b << 8) | ((lam8 << 8) << 16)
    ids = np.arange(n, dtype=np.int32)
    t3 = rng.normal(0, 1, n).astype(np.float32)
    return pack_payload_compact(ids, codes, t3)


@pytest.mark.parametrize("B,K,lp", [(4, 1024, 16), (2, 2048, 32),
                                    (3, 1000, 16)])
def test_rerank_matches_pallas(B, K, lp):
    """Row-major (B, K, W) rows, no multiple-of-1024 rule: the ragged K is
    compared against the Pallas kernel on rows padded to a whole block."""
    rng = np.random.default_rng(7 * K + lp)
    rows = np.stack([_random_payload(rng, K, lp) for _ in range(B)])
    q_line = rng.uniform(0.0, 50.0, (B, lp, 16)).astype(np.float32)
    k_pad = -(-K // BLOCK) * BLOCK
    rows_pad = np.concatenate(
        [rows, np.zeros((B, k_pad - K, rows.shape[2]), np.int32)], axis=1)
    q_pad = jnp.pad(jnp.asarray(q_line), ((0, 0), (0, 0), (0, 128 - 16)))
    want = np.asarray(pallas_rerank(
        jnp.asarray(rows_pad).transpose(0, 2, 1), q_pad,
        interpret=True))[:, :K]
    got = rerank_fused(torch.from_numpy(rows), torch.from_numpy(q_line))
    assert got.shape == (B, K)
    # the two sum the line parts in different orders
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,parts", [((8, 128), 4), ((16, 128), 16),
                                         ((8, 96), 1)])
def test_segmented_reduce_matches_pallas(shape, parts):
    rng = np.random.default_rng(shape[0] * parts)
    x = rng.normal(0, 1, shape).astype(np.float32)
    want = PP.segmented_reduce(jnp.asarray(x), parts, interpret=True)
    got = segmented_reduce(torch.from_numpy(x), parts)
    assert got.shape == (shape[0], parts) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def micro_gather():
    """benchmarks/micro_gather{,2}.py as modules.  micro_gather2 turns on
    the persistent compile cache when it is imported; the flag that says it
    is on already is set for the import, so the worker's JAX config stays
    as it was."""
    mods = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pqt_tpu.utils.cache, "_enabled", True)
        for name in ("micro_gather", "micro_gather2"):
            spec = importlib.util.spec_from_file_location(
                f"_bench_{name}", BENCHMARKS / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
    return mods


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run every pl.pallas_call of the benchmark kernels in interpret mode
    (they take no `interpret` argument)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("kernel", ["pallas_gather", "pallas_lut_2d",
                                    "pallas_lut_onehot"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
def test_lut_gather_matches_pallas_lookups(micro_gather, pallas_interpret,
                                           kernel, dtype):
    """The E, F and G lookups, at a (2^14,) int32 (counts, prefix) or
    uint8 (pair occupancy) table and (16, 256) indices; every one equals
    lut_gather exactly."""
    mod = micro_gather["micro_gather" if kernel == "pallas_gather"
                       else "micro_gather2"]
    rng = np.random.default_rng(14)
    table = rng.integers(0, np.iinfo(dtype).max, 1 << 14).astype(dtype)
    idx = rng.integers(0, 1 << 14, (16, 256)).astype(np.int32)
    want = np.asarray(getattr(mod, kernel)(jnp.asarray(table),
                                           jnp.asarray(idx)))
    got = lut_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.numpy().dtype == dtype and got.shape == idx.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, table[idx])


def test_lut_gather_uint8_table():
    """The pair-occupancy lookup: a uint8 table, indices of any shape."""
    rng = np.random.default_rng(8)
    table = rng.integers(0, 2, 2 * 65536).astype(np.uint8)
    idx = rng.integers(0, table.size, (4, 2, 256)).astype(np.int32)
    got = lut_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), table[idx])


@pytest.mark.parametrize("dtype,width", [(np.int32, 10), (np.uint8, 128)])
def test_gather_rows_matches_pallas_dma_gather(micro_gather,
                                               pallas_interpret, dtype,
                                               width):
    """H: a (4096, 10) int32 table (the compact payload's rows) or a
    (4096, 128) uint8 one (SIFT vectors), (4, 64) positions, 8 copies in
    flight."""
    rng = np.random.default_rng(width)
    info = np.iinfo(dtype)
    tab = rng.integers(info.min, info.max, (4096, width)).astype(dtype)
    pos = rng.integers(0, 4096, (4, 64)).astype(np.int32)
    want = np.asarray(micro_gather["micro_gather2"].pallas_dma_gather(
        jnp.asarray(tab), jnp.asarray(pos), inflight=8))
    got = gather_rows(torch.from_numpy(tab), torch.from_numpy(pos))
    assert got.shape == (4, 64, width) and got.numpy().dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,width", [(np.uint8, 128), (np.int32, 2),
                                         (np.float32, 32)])
@pytest.mark.parametrize("span", [1, 4])
def test_gather_rows_any_dtype_and_span(dtype, width, span):
    """uint8 vectors, (start, end) extent rows and float rows; with a span,
    `span` consecutive rows from each position (slab mode)."""
    rng = np.random.default_rng(width + span)
    tab = rng.integers(0, 255, (300, width)).astype(dtype)
    pos = rng.integers(0, 300 - span, (5, 7)).astype(np.int32)
    got = gather_rows(torch.from_numpy(tab), torch.from_numpy(pos), span)
    want = tab[pos[..., None] + np.arange(span)]
    if span == 1:
        want = want[..., 0, :]
    assert got.dtype == torch.from_numpy(tab).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Non-contiguous or non-int32 indices are refused on the CPU too, so
    the CPU runs catch a caller that would fail on the card."""
    table = torch.arange(64, dtype=torch.int32)
    idx = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    with pytest.raises(ValueError):
        lut_gather(table, idx.T)
    with pytest.raises(ValueError):
        lut_gather(table, idx.long())
    with pytest.raises(ValueError):
        gather_rows(table.reshape(16, 4), idx[:, :2])
    with pytest.raises(ValueError):
        segmented_reduce(torch.ones((4, 6)), 4)
    with pytest.raises(ValueError):
        segmented_reduce(torch.ones((4, 8)).T, 2)
