"""The yardstick at small sizes: the generator, the byte counts, the
reference against brute force, its hash against numpy's, its own tree."""

import numpy as np
import pytest
import torch

from portbench import gen, reference as ref, yardstick

MODEL = {"n": 3000, "dim": 16, "n_coarse": 8, "subs_per_coarse": 4,
         "sigma_coarse": 15.0, "sigma_point": 5.0, "center_high": 140.0}


def test_generator_is_deterministic_for_a_seed():
    a = gen.make_inputs(MODEL, {"pool": 50}, 2 ** 31 + 11, "cpu")
    b = gen.make_inputs(MODEL, {"pool": 50}, 2 ** 31 + 11, "cpu")
    c = gen.make_inputs(MODEL, {"pool": 50}, 2 ** 31 + 12, "cpu")
    assert np.array_equal(a.data, b.data)
    assert np.array_equal(a.queries, b.queries)
    assert not np.array_equal(a.data, c.data)
    assert a.data.shape == (3000, 16) and a.data.dtype == np.uint8
    assert a.queries.shape == (50, 16) and a.queries.dtype == np.float32
    assert np.array_equal(a.queries, np.round(a.queries))


def test_rotation_is_a_view_of_the_rows():
    inp = gen.make_inputs(MODEL, {"pool": 5, "rotate_rows": 100}, 9, "cpu")
    assert np.array_equal(inp.rows(0), inp.data)
    r = inp.rows(37)
    assert np.shares_memory(r, inp.ring) and r.flags["C_CONTIGUOUS"]
    assert np.array_equal(r, np.roll(inp.data, -37, axis=0))
    with pytest.raises(ValueError):
        inp.rows(101)
    plain = gen.make_inputs(MODEL, {"pool": 5}, 9, "cpu")
    assert np.array_equal(plain.data, inp.data)
    assert np.array_equal(plain.queries, inp.queries)


def test_zipf_queries_crowd_into_few_subclusters():
    model = dict(MODEL, n=10, n_coarse=64, sigma_point=0.0)
    flat = gen.make_inputs(model, {"pool": 4000}, 4, "cpu")
    skew = gen.make_inputs(model, {"pool": 4000, "query_dist": {
        "kind": "zipf", "s": 1.1}}, 4, "cpu")
    again = gen.make_inputs(model, {"pool": 4000, "query_dist": {
        "kind": "zipf", "s": 1.1}}, 4, "cpu")
    assert np.array_equal(skew.queries, again.queries)
    assert np.array_equal(skew.data, flat.data)

    def top_share(q):
        _, counts = np.unique(q, axis=0, return_counts=True)
        return counts.max() / q.shape[0]
    assert top_share(skew.queries) > 5 * top_share(flat.queries)


def test_line_codes_bound_at_the_chunk_shapes():
    # bytes bind: (rows*lp*c1*4 + lp*c1*c1*4 + rows*lp*12) / 3.35e12
    assert yardstick.line_codes_bound_s(65536, 32, 16) == pytest.approx(
        (65536 * 32 * 16 * 4 + 32 * 256 * 4 + 65536 * 32 * 12) / 3.35e12)
    assert yardstick.line_codes_bound_s(65536, 32, 16) == pytest.approx(
        4.758e-5, rel=1e-3)
    assert yardstick.line_codes_bound_s(65536, 16, 16) == pytest.approx(
        2.379e-5, rel=1e-3)
    # at c1 = 256 the operations bind
    t, what = yardstick.bound(1000 * 4 * 256 * 4, 8 * 1000 * 4 * 256 * 255
                              // 2)
    assert what == "operations"


def test_exact_rerank_bytes():
    assert yardstick.exact_rerank_bytes(10, 2, 128, 128) == \
        10 * (128 + 8) + 2 * 128 * 4


def test_intersection():
    got = np.array([[1, 2, 3], [4, 5, 6]])
    gt = np.array([[3, 2, 9], [7, 8, 9]])
    assert yardstick.intersection_at(got, gt, (3,))["top3_intersection"] \
        == pytest.approx(2 / 6)


def _tiny_cfg(**over):
    cfg = {"dim": 16, "p": 2, "c1": 4, "c2": 4, "line_parts": 4,
           "hash_size": 256, "k1_build": 4, "k1_query": 4, "max_bins": 256,
           "bin_enum_factor": 4, "max_candidates": 4096,
           "max_vec_per_bin": 4096, "pair_top_m": 256, "enum_width": 256,
           "enum_width_cap": 65536, "pair_filter": True,
           "pair_filter_max_table": 1 << 22, "pipeline": "pair",
           "payload_compact": True, "lambda_bits": 16,
           "gather_mode": "rows", "dedup_candidates": False}
    cfg.update(over)
    return cfg


def _brute(data, q, k):
    d = ((data[None].double() - q[:, None].double()) ** 2).sum(-1)
    v, i = torch.sort(d, dim=1, stable=True)
    return i[:, :k], v[:, :k]


def test_reference_query_equals_brute_force_when_the_budget_holds_all():
    cfg = _tiny_cfg()
    inp = gen.make_inputs(MODEL, {"pool": 40}, 3, "cpu")
    data = torch.from_numpy(inp.data)
    q = torch.from_numpy(inp.queries)
    g = torch.Generator().manual_seed(0)
    cb1 = data[torch.randperm(3000, generator=g)[:4]].float().reshape(
        4, 2, 8).permute(1, 0, 2).contiguous()
    cb2 = data[torch.randperm(3000, generator=g)[:16]].float().reshape(
        4, 4, 2, 8).permute(2, 0, 1, 3).contiguous()
    index = ref.build_index(cfg, ref.encode_codes(cfg, cb1, cb2, data))
    assert int(index.counts.sum()) == 3000
    got = ref.query(cfg, cb1, cb2, index, data, q, 10)
    ids, dists = _brute(data, q, 10)
    assert torch.equal(got.dists, dists)
    assert torch.equal(got.n_candidates, torch.full((40,), 3000))
    # the ground truth of the recall: the same distances
    top = ref.exact_top(data, q, 10, row_block=700)
    d_top = ((data[top].double() - q[:, None].double()) ** 2).sum(-1)
    assert torch.equal(torch.sort(d_top, 1).values, dists)


def test_hash_equals_numpy_uint64():
    cfg = _tiny_cfg(p=4, c1=16, c2=16, dim=128, hash_size=1 << 23)
    codes = torch.randint(0, 256, (1000, 4), generator=torch.Generator()
                          .manual_seed(1))
    got = ref.bin_ids(cfg, codes).numpy()
    acc = np.zeros(1000, np.uint64)
    for j in range(4):
        acc = (acc + codes[:, j].numpy().astype(np.uint64)
               * np.uint64(ref.MIX[j])) & np.uint64(0xFFFFFFFF)
    want = ((acc * np.uint64(ref.FINAL)) & np.uint64(0xFFFFFFFF)) >> \
        np.uint64(32 - 23)
    assert np.array_equal(got, want.astype(np.int64))
    assert got.max() < 1 << 23


def test_reference_tree_is_near_a_trained_tree_and_far_from_seeds():
    cfg = _tiny_cfg(kmeans_init="kmeans++", kmeans_iters=30,
                    kmeans_churn_tol=0.0, train_subsample=0)
    data = torch.from_numpy(gen.make_inputs(MODEL, {}, 5, "cpu").data)
    cb1, cb2 = ref.train_tree(cfg, data, 2 ** 31 + 5)
    assert cb1.shape == (2, 4, 8) and cb2.shape == (2, 4, 4, 8)
    again = ref.train_tree(cfg, data, 2 ** 31 + 5)
    assert torch.equal(cb1, again[0]) and torch.equal(cb2, again[1])
    other = ref.train_tree(cfg, data, 2 ** 31 + 6)
    assert abs(ref.tree_excess(cfg, *other, cb1, cb2, data)) < 0.15
    assert ref.tree_excess(cfg, cb1, cb2, cb1, cb2, data) == 0.0
    # seeds alone (no Lloyd step), and a collapsed tree
    seeds = ref.train_tree(dict(cfg, kmeans_iters=0), data, 2 ** 31 + 5)
    assert ref.tree_excess(cfg, *seeds, cb1, cb2, data) > 0.2
    flat1 = cb1[:, :1].expand_as(cb1)
    flat2 = cb2[:, :1, :1].expand_as(cb2)
    assert ref.tree_excess(cfg, flat1, flat2, cb1, cb2, data) > 1.0


def test_kmeanspp_seeds_are_rows_of_their_group():
    x = torch.arange(40, dtype=torch.float64).reshape(20, 2)
    groups = torch.tensor([0] * 5 + [2] * 15)
    seeds = ref._kmeanspp(x, groups, 3, 4, torch.Generator().manual_seed(1))
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(s) in rows for s in seeds[0].tolist() + seeds[2]
               .tolist())
    assert len({tuple(s) for s in seeds[2].tolist()}) == 4
    assert torch.equal(seeds[1], torch.zeros(4, 2, dtype=torch.float64))
    assert all(tuple(s) in {tuple(r) for r in x[:5].tolist()}
               for s in seeds[0].tolist())


def test_unpack_payload_layouts():
    cfg = _tiny_cfg(line_parts=4)
    # compact: parts (A, B, u8) = (1, 2, 3), (4, 5, 6), (7, 8, 9), (0, 1, 2)
    parts = [(1, 2, 3), (4, 5, 6), (7, 8, 9), (0, 1, 2)]
    p16 = [a | b << 4 | u << 8 for a, b, u in parts]
    words = [p16[0] | p16[1] << 16, p16[2] | p16[3] << 16]
    t3 = np.array([1.5], np.float32).view(np.int32)[0]
    rows = torch.tensor([[42, t3] + [w - (1 << 32) if w >= 1 << 31 else w
                                     for w in words]], dtype=torch.int32)
    ids, a, b, lam, t = ref.unpack_payload(cfg, rows)
    assert ids.tolist() == [42] and t.tolist() == [1.5]
    assert a.tolist() == [[1, 4, 7, 0]] and b.tolist() == [[2, 5, 8, 1]]
    assert lam.tolist() == [[3, 6, 9, 2]]
