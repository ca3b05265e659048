"""Native C++ graph kernels must match the numpy fallbacks exactly."""

import numpy as np
import pytest

from anemoi_models_tpu import native


pytestmark = pytest.mark.skipif(not native.available(), reason="native kernels unavailable")


def random_edges(e=5000, ns=300, nd=200, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, ns, e), rng.randint(0, nd, e)]).astype(np.int32), ns, nd


def test_sort_matches_lexsort():
    ei, ns, nd = random_edges()
    perm, dst_ptr = native.sort_edges_csr(ei, ns, nd)
    ref = np.lexsort((ei[0], ei[1]))
    np.testing.assert_array_equal(perm, ref)
    ref_ptr = np.zeros(nd + 1, dtype=np.int64)
    np.add.at(ref_ptr, ei[1].astype(np.int64) + 1, 1)
    np.testing.assert_array_equal(dst_ptr, np.cumsum(ref_ptr))


def test_dense_tables_match_numpy():
    from anemoi_models_tpu.graphs.partition import dense_neighbor_table

    ei, ns, nd = random_edges(seed=1)
    perm, _ = native.sort_edges_csr(ei, ns, nd)
    sorted_ei = ei[:, perm]
    nat = native.dense_tables(sorted_ei, nd)

    # numpy fallback path (bypass native) for comparison
    src, dst = sorted_ei
    counts = np.bincount(dst, minlength=nd)
    max_deg = max(int(counts.max()), 1)
    edge_ids = np.zeros((nd, max_deg), np.int32)
    src_ids = np.zeros((nd, max_deg), np.int32)
    mask = np.zeros((nd, max_deg), bool)
    starts = np.zeros(nd + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(dst)) - starts[dst]
    edge_ids[dst, pos] = np.arange(len(dst), dtype=np.int32)
    src_ids[dst, pos] = src
    mask[dst, pos] = True

    np.testing.assert_array_equal(nat[0], edge_ids)
    np.testing.assert_array_equal(nat[1], src_ids)
    np.testing.assert_array_equal(nat[2], mask)


def test_subdivide_matches_python():
    from anemoi_models_tpu.graphs.build import _icosahedron

    verts, faces = _icosahedron()
    nat_v, nat_f = native.subdivide(verts, faces)
    # python reference (copied logic, kept independent of the dispatcher)
    edge_mid, new_verts, nxt = {}, [verts], len(verts)

    def midpoint(a, b):
        nonlocal nxt
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            m = verts[a] + verts[b]
            m = m / np.linalg.norm(m)
            new_verts.append(m[None])
            edge_mid[key] = nxt
            nxt += 1
        return edge_mid[key]

    ref_f = np.empty((len(faces) * 4, 3), np.int64)
    for i, (a, b, c) in enumerate(faces):
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        ref_f[4 * i:4 * i + 4] = [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    ref_v = np.concatenate(new_verts)
    np.testing.assert_allclose(nat_v, ref_v, atol=1e-12)
    np.testing.assert_array_equal(nat_f, ref_f)


def test_graph_build_uses_native_consistently():
    """Full graph build should give identical results either way."""
    from anemoi_models_tpu.graphs import build_enc_proc_dec_graph

    g = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=1)
    for key, es in g.edge_items():
        assert np.all(np.diff(es.edge_index[1]) >= 0)
        assert es.dst_ptr[-1] == es.num_edges



def test_sort_positions_by_row_matches_numpy():
    rng = np.random.RandomState(3)
    ids = rng.randint(-1, 40, 10_000).astype(np.int64)
    counts, rows_sorted, pos_sorted = native.sort_positions_by_row(ids, 40)

    pos = np.nonzero(ids >= 0)[0]
    rows = ids[pos]
    order = np.argsort(rows, kind="stable")
    np.testing.assert_array_equal(rows_sorted, rows[order])
    np.testing.assert_array_equal(pos_sorted, pos[order])
    np.testing.assert_array_equal(counts, np.bincount(rows, minlength=40))


def test_fill_bucket_tables_matches_numpy():
    rng = np.random.RandomState(4)
    e, ns, nd = 6000, 300, 150
    ei = np.stack([rng.randint(0, ns, e), rng.randint(0, nd, e)]).astype(np.int64)
    order = np.lexsort((ei[0], ei[1]))
    src, dst = ei[0][order], ei[1][order]
    counts = np.bincount(dst, minlength=nd)
    starts = np.zeros(nd + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    cap = 64
    node_ids = np.nonzero(counts <= cap)[0].astype(np.int32)

    edge_ids, src_ids, mask = native.fill_bucket_tables(
        src.astype(np.int32), starts, node_ids, cap
    )
    k = counts[node_ids]
    slots = np.arange(cap, dtype=np.int64)
    ref_mask = slots[None, :] < k[:, None]
    eid = starts[node_ids][:, None] + slots[None, :]
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(edge_ids, np.where(ref_mask, eid, 0).astype(np.int32))
    np.testing.assert_array_equal(
        src_ids, np.where(ref_mask, src[np.minimum(eid, e - 1)], 0).astype(np.int32)
    )


def test_bucketed_tables_native_vs_numpy_fallback(monkeypatch):
    """The full bucketed/transpose build is identical with natives disabled."""
    from anemoi_models_tpu.graphs.partition import (
        bucketed_neighbor_tables,
        transpose_position_tables,
    )

    rng = np.random.RandomState(5)
    e, ns, nd = 4000, 200, 120
    ei = np.stack([rng.randint(0, ns, e), rng.randint(0, nd, e)]).astype(np.int64)
    order = np.lexsort((ei[0], ei[1]))
    ei = ei[:, order]
    ids = np.where(rng.rand(3000) < 0.8, rng.randint(0, ns, 3000), -1).astype(np.int64)

    b_nat, r_nat = bucketed_neighbor_tables(ei, nd)
    t_nat, tr_nat = transpose_position_tables(ids, ns)

    monkeypatch.setattr(native, "fill_bucket_tables", lambda *a, **k: None)
    monkeypatch.setattr(native, "sort_positions_by_row", lambda *a, **k: None)
    monkeypatch.setattr(native, "sort_positions_by_row_masked", lambda *a, **k: None)
    b_np, r_np = bucketed_neighbor_tables(ei, nd)
    t_np, tr_np = transpose_position_tables(ids, ns)

    for (got, ref) in ((b_nat, b_np), (t_nat, t_np)):
        assert len(got) == len(ref)
        for gb, rb in zip(got, ref):
            for g, r in zip(gb, rb):
                np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(r_nat, r_np)
    np.testing.assert_array_equal(tr_nat, tr_np)


def test_transpose_slot_tables_matches_flat():
    from anemoi_models_tpu.graphs.partition import (
        transpose_position_tables,
        transpose_slot_tables,
    )

    rng = np.random.RandomState(6)
    src_ids = rng.randint(0, 80, (50, 16)).astype(np.int32)
    mask = rng.rand(50, 16) < 0.7
    flat = np.where(mask.ravel(), src_ids.ravel().astype(np.int64), -1)
    got_b, got_r = transpose_slot_tables(src_ids, mask, 80)
    ref_b, ref_r = transpose_position_tables(flat, 80)
    assert len(got_b) == len(ref_b)
    for gb, rb in zip(got_b, ref_b):
        for g, r in zip(gb, rb):
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got_r, ref_r)
