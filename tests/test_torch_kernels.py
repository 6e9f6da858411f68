"""The port's kernel wrappers (plain versions on the CPU) against the JAX
package's Pallas kernels, run in interpret mode as tests/test_pallas_*.py
run them.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pqt_tpu.models.db import pack_payload_compact
from pqt_tpu.ops.pallas import primitives as PP
from pqt_tpu.ops.pallas.rerank import BLOCK, rerank_fused as pallas_rerank
from pqt_tpu_torch.ops.cuda.primitives import bitonic_topk, block_scan
from pqt_tpu_torch.ops.cuda.rerank import rerank_fused


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
