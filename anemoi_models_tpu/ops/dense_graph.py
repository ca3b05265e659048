"""Dense (padded-neighbor) graph aggregation ops — the default graph path.

Given the build-time dense neighbor tables (``graphs/partition.py``),
aggregation and per-edge attention become row gathers plus reductions over a
static ``max_degree`` axis: no scatter and no segment ops, forward or
backward. These are numerically identical to the ``ops/segment.py``
reference path (tests assert it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "gather_edges",
    "masked_neighbor_sum",
    "dense_edge_attention",
    "CommutedProj",
    "commuted_edge_attention",
    "PaddedTranspose",
    "TransposeBundle",
    "padded_take",
    "padded_take_rows",
    "padded_transpose_sum",
    "table_take",
    "take_rows",
    "unique_take_rows",
]


class PaddedTranspose(NamedTuple):
    """Single-cap transpose layout (``graphs.partition._padded_transpose``):
    per source row, the gather positions reading it, padded to the max
    multiplicity. Arrays may be traced (shard-sliced inside shard_map)."""

    tab: jnp.ndarray  # (rows, M) int32, −1 = dead
    mask: jnp.ndarray  # (rows, M) bool


def _adjoint_chunks(rows: int, m: int, row_bytes: int) -> int:
    """Reduction-axis chunk count for transpose adjoints.

    The naive adjoint materializes a (rows, M, C) gather before its
    mask-and-sum; at O1280 the decoder mapper's transpose table makes that
    the single largest allocation of the sharded train step. Chunking the
    M axis keeps only an
    (rows, m_chunk, C) transient live (the accumulator is (rows, C)).
    ``ANEMOI_ADJOINT_CHUNK_BYTES`` bounds the transient (default 1 GiB;
    0 disables chunking)."""
    import os

    limit = int(os.environ.get("ANEMOI_ADJOINT_CHUNK_BYTES", str(1 << 30)))
    if limit <= 0 or m <= 1:
        return 1
    total = rows * m * row_bytes
    return max(1, min(m, -(-total // limit)))


def padded_transpose_sum(g: jnp.ndarray, t: PaddedTranspose) -> jnp.ndarray:
    """Adjoint of ``x -> x[ids]`` via a padded transpose: gather the
    cotangent rows at each source row's positions and reduce. ``g`` (P, ...)
    -> (rows, ...). The M-axis reduction is chunked so the gathered
    cotangent transient stays bounded (see :func:`_adjoint_chunks`)."""
    rows, m = t.tab.shape
    extra = 1
    for d in g.shape[1:]:
        extra *= d
    nch = _adjoint_chunks(rows, m, extra * g.dtype.itemsize)
    bounds = [round(i * m / nch) for i in range(nch + 1)]
    dx = None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        tab = t.tab[:, lo:hi]
        safe = jnp.where(tab >= 0, tab, 0)
        got = jnp.take(g, safe, axis=0)  # (rows, hi-lo, ...)
        msk = t.mask[:, lo:hi].reshape(tab.shape + (1,) * (g.ndim - 1))
        part = jnp.where(msk, got, 0).sum(axis=1)
        dx = part if dx is None else dx + part
    return dx


@jax.custom_vjp
def padded_take(x: jnp.ndarray, ids: jnp.ndarray, tab: jnp.ndarray, mask: jnp.ndarray):
    """Row gather whose backward is the padded-transpose reduce. All layout
    arrays are *primal args* (they may be traced, e.g. shard-sliced inside
    shard_map — closure-captured adjoints would leak tracers across the vjp)."""
    return jnp.take(x, ids, axis=0)


def _padded_take_fwd(x, ids, tab, mask):
    # residuals must be arrays: a 0-dim carrier remembers x's dtype
    return jnp.take(x, ids, axis=0), (jnp.zeros((), x.dtype), ids, tab, mask)


def _padded_take_bwd(res, g):
    import numpy as _np

    dtype_carrier, ids, tab, mask = res
    f0 = jax.dtypes.float0
    dx = padded_transpose_sum(g, PaddedTranspose(tab, mask)).astype(dtype_carrier.dtype)
    return (
        dx,
        _np.zeros(ids.shape, dtype=f0),
        _np.zeros(tab.shape, dtype=f0),
        _np.zeros(mask.shape, dtype=f0),
    )


padded_take.defvjp(_padded_take_fwd, _padded_take_bwd)


@jax.custom_vjp
def padded_take_rows(x: jnp.ndarray, ids: jnp.ndarray, tab: jnp.ndarray, mask: jnp.ndarray):
    """Row gather along axis −2 whose backward is a padded-transpose reduce.

    ``x`` (..., R, C), ``ids`` (P,) row per gather position, ``tab`` (R, M)
    gather positions reading each row (0-padded, ``mask`` (R, M) validity).
    Layout arrays are primal args, so they may be traced — e.g. shard-sliced
    inside shard_map (the sharded mapper path, ``parallel/mapper_conv.py``).
    """
    return jnp.take(x, ids, axis=-2)


def _ptr_fwd(x, ids, tab, mask):
    return jnp.take(x, ids, axis=-2), (jnp.zeros((), x.dtype), ids, tab, mask)


def _ptr_bwd(res, g):
    import numpy as _np

    carrier, ids, tab, mask = res
    f0 = jax.dtypes.float0
    r, m = tab.shape
    lead = 1
    for d in g.shape[:-2]:
        lead *= d
    nch = _adjoint_chunks(r, m, lead * g.shape[-1] * g.dtype.itemsize)
    bounds = [round(i * m / nch) for i in range(nch + 1)]
    dx = None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        got = jnp.take(g, tab[:, lo:hi], axis=-2)  # (..., R, hi-lo, C)
        part = jnp.where(mask[:, lo:hi, None], got, 0).sum(axis=-2)
        dx = part if dx is None else dx + part
    dx = dx.astype(carrier.dtype)
    return (
        dx,
        _np.zeros(ids.shape, dtype=f0),
        _np.zeros(tab.shape, dtype=f0),
        _np.zeros(mask.shape, dtype=f0),
    )


padded_take_rows.defvjp(_ptr_fwd, _ptr_bwd)


@jax.custom_vjp
def unique_take_rows(x: jnp.ndarray, ids: jnp.ndarray, inv: jnp.ndarray):
    """Row gather along axis −2 where each source row is read at most once:
    the backward is one masked take at ``inv`` (R,) — the flat gather
    position of each row, −1 = unused. Layout arrays are primal args
    (traced-safe)."""
    return jnp.take(x, ids, axis=-2)


def _utr_fwd(x, ids, inv):
    return jnp.take(x, ids, axis=-2), (jnp.zeros((), x.dtype), ids, inv)


def _utr_bwd(res, g):
    import numpy as _np

    carrier, ids, inv = res
    f0 = jax.dtypes.float0
    dx = _masked_pos_take(g, inv, inv.shape[0], axis=-2).astype(carrier.dtype)
    return (dx, _np.zeros(ids.shape, dtype=f0), _np.zeros(inv.shape, dtype=f0))


unique_take_rows.defvjp(_utr_fwd, _utr_bwd)


@jax.custom_vjp
def table_take(x: jnp.ndarray, tab: jnp.ndarray, mask: jnp.ndarray, inv: jnp.ndarray):
    """Gather rows of ``x`` (P, ...) into a (rows, M, ...) table layout where
    each position appears at most once; the backward is one masked
    position-take over ``inv`` (P,) — flattened (rows·M) slot per position,
    −1 = absent. All layout arrays are primal args (traced-safe)."""
    safe = jnp.where(tab >= 0, tab, 0)
    out = jnp.take(x, safe, axis=0)
    return jnp.where(mask.reshape(mask.shape + (1,) * (x.ndim - 1)), out, 0)


def _table_take_fwd(x, tab, mask, inv):
    return table_take(x, tab, mask, inv), (jnp.zeros((), x.dtype), tab, mask, inv)


def _table_take_bwd(res, g):
    import numpy as _np

    carrier, tab, mask, inv = res
    f0 = jax.dtypes.float0
    flat = g.reshape((-1,) + g.shape[2:])
    dx = _masked_pos_take(flat, inv, inv.shape[0], axis=0).astype(carrier.dtype)
    return (
        dx,
        _np.zeros(tab.shape, dtype=f0),
        _np.zeros(mask.shape, dtype=f0),
        _np.zeros(inv.shape, dtype=f0),
    )


table_take.defvjp(_table_take_fwd, _table_take_bwd)


@jax.tree_util.register_static
class TransposeBundle:
    """Static carrier for the host-side adjoint layout
    (``graphs.partition.bucketed_transpose_bundle``): rides through
    jit/remat as compile-time metadata."""

    def __init__(self, bundle: dict):
        self.per_bucket = bundle["per_bucket"]
        self.node_concat = bundle["node_concat"]
        self.num_src = bundle["num_src"]


@jax.tree_util.register_static
class GatherTables:
    """Static (host-side numpy) bucketed-table set for one edge layout.

    Static rather than traced because the transpose-adjoint ``custom_vjp``
    closures must capture the index arrays as compile-time constants — a
    traced index array leaking into a custom_vjp closure is an
    UnexpectedTracerError. Supports tuple-style indexing for the
    ``(buckets, reassemble)`` call sites."""

    def __init__(self, buckets, reassemble, transpose: "TransposeBundle | None" = None):
        self.buckets = buckets
        self.reassemble = reassemble
        self.transpose = transpose

    def __getitem__(self, i: int):
        return (self.buckets, self.reassemble, self.transpose)[i]

    def __iter__(self):
        return iter((self.buckets, self.reassemble, self.transpose))


def _bucketed_sum_impl(v: jnp.ndarray, buckets, reassemble) -> jnp.ndarray:
    """Shared body of the bucketed position-sum: per-bucket take + masked
    static-width reduce, then one reassemble take. v (..., P, C) ->
    (..., rows, C). ``buckets`` entries are (pos_tab (nb, cap), mask)."""
    outs = []
    for pos_tab, mask in buckets:
        g = jnp.take(v, pos_tab, axis=-2)  # (..., nb, cap, C)
        outs.append(jnp.where(mask[..., None], g, 0).sum(axis=-2))
    cat = jnp.concatenate(outs, axis=-2)
    return jnp.take(cat, reassemble, axis=-2)


def _f0_like(tree):
    import numpy as _np

    f0 = jax.dtypes.float0
    return jax.tree_util.tree_map(lambda a: _np.zeros(a.shape, dtype=f0), tree)


@jax.custom_vjp
def bucketed_position_sum(v: jnp.ndarray, buckets, reassemble, pos_ids):
    """Sum per-position values into rows via degree-bucketed position
    tables. Its adjoint is one masked take at ``pos_ids`` (the row each
    position feeds, −1 = dead) — scatter-free both ways. Layout arrays are
    primal args (traced-safe inside shard_map)."""
    return _bucketed_sum_impl(v, buckets, reassemble)


def _bps_fwd(v, buckets, reassemble, pos_ids):
    out = _bucketed_sum_impl(v, buckets, reassemble)
    return out, (jnp.zeros((), v.dtype), buckets, reassemble, pos_ids)


def _bps_bwd(res, g):
    carrier, buckets, reassemble, pos_ids = res
    dv = _masked_pos_take(g, pos_ids, pos_ids.shape[0], axis=-2).astype(carrier.dtype)
    return dv, _f0_like(buckets), _f0_like(reassemble), _f0_like(pos_ids)


bucketed_position_sum.defvjp(_bps_fwd, _bps_bwd)


@jax.custom_vjp
def position_gather(x: jnp.ndarray, pos_ids, buckets, reassemble):
    """Masked row gather ``x (..., rows, C) -> (..., P, C)`` at ``pos_ids``
    (−1 = zero row) whose adjoint is :func:`bucketed_position_sum` over the
    same tables — the exact transpose pair, so a gather-heavy graph conv
    stays scatter-free through arbitrary differentiation."""
    return _masked_pos_take(x, pos_ids, pos_ids.shape[0], axis=-2)


def _pg_fwd(x, pos_ids, buckets, reassemble):
    out = _masked_pos_take(x, pos_ids, pos_ids.shape[0], axis=-2)
    return out, (jnp.zeros((), x.dtype), pos_ids, buckets, reassemble)


def _pg_bwd(res, g):
    carrier, pos_ids, buckets, reassemble = res
    dx = _bucketed_sum_impl(g, buckets, reassemble).astype(carrier.dtype)
    return dx, _f0_like(pos_ids), _f0_like(buckets), _f0_like(reassemble)


position_gather.defvjp(_pg_fwd, _pg_bwd)


def take_rows(x: jnp.ndarray, ids, axis: int, adjoint=None) -> jnp.ndarray:
    """``jnp.take`` whose backward is a custom gather instead of XLA's
    scatter-add. ``adjoint(g) -> grad_x`` must implement
    the transpose-gather; with ``adjoint=None`` this is plain ``jnp.take``."""
    if adjoint is None:
        return jnp.take(x, ids, axis=axis)

    @jax.custom_vjp
    def f(xx):
        return jnp.take(xx, ids, axis=axis)

    f.defvjp(lambda xx: (f(xx), None), lambda _, g: (adjoint(g).astype(x.dtype),))
    return f(x)


def _masked_pos_take(g: jnp.ndarray, pos, num_rows: int, axis: int) -> jnp.ndarray:
    """Gather rows of ``g`` at ``pos`` (−1 → zero row): the adjoint of a
    one-use-per-row gather (edge/query gathers)."""
    pos = jnp.asarray(pos)
    safe = jnp.where(pos >= 0, pos, 0)
    out = jnp.take(g, safe, axis=axis)
    shape = [1] * out.ndim
    shape[axis] = num_rows
    return out * (pos >= 0).reshape(shape)


def _transpose_sum(g_flat: jnp.ndarray, t_tables, num_src: int) -> jnp.ndarray:
    """Adjoint of a many-uses-per-row gather: bucketed masked position-sum
    over the cotangent slots. ``g_flat`` (..., P, C) -> (..., num_src, C)."""
    t_buckets, t_reassemble = t_tables
    outs = []
    # table layout is (row_ids, pair_ids, positions, mask): the gathered-slot
    # positions live in the src column of the transposed pair list
    for _, _, pos_tab, mask in t_buckets:
        got = jnp.take(g_flat, jnp.asarray(pos_tab), axis=-2)
        outs.append(jnp.where(jnp.asarray(mask)[..., None], got, 0).sum(axis=-2))
    cat = jnp.concatenate(outs, axis=-2)
    return jnp.take(cat, jnp.asarray(t_reassemble), axis=-2)


def gather_edges(x_edges: jnp.ndarray, edge_ids: jnp.ndarray) -> jnp.ndarray:
    """Gather per-edge values into neighbor-table layout.

    x_edges (..., E, C), edge_ids (N, deg) -> (..., N, deg, C).
    """
    return jnp.take(x_edges, edge_ids, axis=-2)


def masked_neighbor_sum(
    x: jnp.ndarray, mask: jnp.ndarray, axis: int = -2
) -> jnp.ndarray:
    """Sum over the padded neighbor axis with validity masking.

    x (..., N, deg, C), mask (N, deg) -> (..., N, C).
    """
    return jnp.where(mask[..., None], x, 0).sum(axis=axis)


def dense_edge_attention(
    query: jnp.ndarray,
    key: jnp.ndarray,
    value: jnp.ndarray,
    edge_attr: Optional[jnp.ndarray],
    src_ids: jnp.ndarray,
    edge_ids: jnp.ndarray,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    """Per-edge attention in dense neighbor-table form.

    query (B, N, H, D) [destination nodes], key/value (B, Ns, H, D),
    edge_attr (B, E, H, D) or None, tables (N, deg). Returns (B, N, H, D).

    Equivalent to :func:`anemoi_models_tpu.layers.conv.graph_transformer_conv`
    (which mirrors reference ``layers/conv.py:79-142``) but with softmax over
    a static degree axis instead of segment softmax.
    """
    out_channels = query.shape[-1]
    k_n = jnp.take(key, src_ids, axis=-3)  # (B, N, deg, H, D)
    v_n = jnp.take(value, src_ids, axis=-3)
    if edge_attr is not None:
        e_n = jnp.take(edge_attr, edge_ids, axis=-3)
        k_n = k_n + e_n
        v_n = v_n + e_n

    scale = 1.0 / jnp.sqrt(jnp.asarray(out_channels, jnp.float32))
    # fp32 accumulation of the q·k contraction (bf16-safe softmax logits)
    logits = jnp.einsum(
        "...nhd,...nkhd->...nkh", query, k_n, preferred_element_type=jnp.float32
    ) * scale
    logits = jnp.where(mask[..., None], logits, -jnp.inf)
    m = jnp.max(logits, axis=-2, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    w = jnp.exp(logits - m)
    w = jnp.where(mask[..., None], w, 0.0)
    denom = jnp.maximum(w.sum(axis=-2, keepdims=True), 1e-16)
    alpha = (w / denom).astype(value.dtype)
    return (v_n * alpha[..., None]).sum(axis=-3)


def bucketed_neighbor_sum(
    x_edges: jnp.ndarray, buckets, reassemble: jnp.ndarray, transpose=None
) -> jnp.ndarray:
    """Sum per-edge values into destinations using degree-bucketed tables.

    x_edges (..., E, C); returns (..., num_dst, C). Pure gathers + static
    reductions — no scatter, and no padding to the global max degree. With a
    :class:`TransposeBundle` the backward is also gather-only.
    """
    num_edges = x_edges.shape[-2]
    outs = []
    for i, (_, edge_ids, _, mask) in enumerate(buckets):
        adjoint = None
        if transpose is not None:
            poe = transpose.per_bucket[i]["pos_of_edge"]
            nb, cap = edge_ids.shape

            def adjoint(g, poe=poe, nb=nb, cap=cap):
                gf = g.reshape(*g.shape[:-3], nb * cap, g.shape[-1])
                return _masked_pos_take(gf, poe, num_edges, axis=-2)

        g = take_rows(x_edges, edge_ids, -2, adjoint)  # (..., nb, cap, C)
        outs.append(jnp.where(mask[..., None], g, 0).sum(axis=-2))
    cat = jnp.concatenate(outs, axis=-2)
    if transpose is not None:
        nc = transpose.node_concat

        def re_adjoint(g, nc=nc):
            return jnp.take(g, jnp.asarray(nc), axis=-2)

        return take_rows(cat, reassemble, -2, re_adjoint)
    return jnp.take(cat, reassemble, axis=-2)


class CommutedProj(NamedTuple):
    """Projection weights for :func:`commuted_edge_attention` — the k/v/edge
    linear maps moved across the gather/softmax onto the query and output
    sides. Probed from the owning ``nn.Dense`` modules at trace time (an
    identity-matrix row through the layer), so the parameter tree is exactly
    the wide path's."""

    w_k: jnp.ndarray  # (C, H, D) key projection (applied to the query)
    w_v: jnp.ndarray  # (C, H, D) value projection (applied to the pooled feats)
    w_e: Optional[jnp.ndarray]  # (A, H, D) edge projection, or None
    b_out: Optional[jnp.ndarray]  # (H, D) value+edge bias, added where edges exist


def commuted_edge_attention(
    query: jnp.ndarray,
    src_feats: jnp.ndarray,
    edge_raw,
    buckets,
    reassemble: jnp.ndarray,
    proj: CommutedProj,
    transpose=None,
    src_feat_transform=None,
) -> jnp.ndarray:
    """Per-edge attention with the k/v/edge projections commuted across the
    gather — the zero-slot-matmul dataflow.

    Identity used: with ``k_j = W_k f_j + b_k + W_e e_j + b_e`` the logits are

        q · k_j  =  (W_kᵀ q) · f_j  +  (W_eᵀ q) · e_j  +  q · (b_k + b_e)

    and the bias term is constant over the neighbors of a destination, so the
    softmax is unchanged when it is dropped. On the value side the α-weighted
    sum commutes with the linear map:

        Σ_j α_j (W_v f_j + W_e e_j + b)  =  W_v (Σ α_j f_j) + W_e (Σ α_j e_j) + b

    (Σα = 1 where the destination has any edge, 0 otherwise). So the conv
    gathers ONE narrow feature tensor (``src_feats``, C- or A-wide) plus the
    raw edge attrs, and runs zero matmuls on the padded slot axis: the wide
    path's per-slot k/v projections become per-*node* projections of the query
    and the pooled output. Halves the mapper/processor gather bytes relative
    to the ``src_transform`` narrow path AND removes its padded-slot FLOPs
    (e.g. the O96 encoder's ~131 GFLOP k/v slot projection).

    ``query`` (B, N, H, D); ``src_feats`` (B, Ns, F) pre-projection source
    features (already LayerNormed when the model LNs before k/v — LN is
    per-row, so it commutes with the row gather and runs on nodes, not slots);
    ``src_feat_transform`` (optional) applies any *nonlinear* per-row prefix
    (e.g. the encoder's embed→LN on raw rows) to the gathered slots, F → C.
    ``edge_raw`` (B, E, A) raw edge attributes or None. Numerically equal to
    the wide path up to fp reassociation of the moved matmuls.
    """
    num_edges = None if edge_raw is None else edge_raw.shape[-2]
    dt = query.dtype
    scale = 1.0 / jnp.sqrt(jnp.asarray(query.shape[-1], jnp.float32))
    outs = []
    for i, (node_ids, edge_ids, src_ids, mask) in enumerate(buckets):
        adj_q = adj_src_flat = adj_e2 = None
        if transpose is not None:
            tb = transpose.per_bucket[i]
            nb, cap = src_ids.shape
            num_src = transpose.num_src
            num_dst = len(transpose.node_concat)

            def adj_q(g, pon=tb["pos_of_node"], nd=num_dst):
                return _masked_pos_take(g, pon, nd, axis=-3)

            def adj_src_flat(g, t=tb["t_src"], nb=nb, cap=cap, ns=num_src):
                gf = g.reshape(*g.shape[:-3], nb * cap, g.shape[-1])
                return _transpose_sum(gf, t, ns)

            def adj_e2(g, poe=tb["pos_of_edge"], nb=nb, cap=cap, ne=num_edges):
                gf = g.reshape(*g.shape[:-3], nb * cap, g.shape[-1])
                return _masked_pos_take(gf, poe, ne, axis=-2)

        q_b = take_rows(query, node_ids, -3, adj_q)  # (B, nb, H, D)
        g_n = take_rows(src_feats, src_ids, -2, adj_src_flat)  # (B, nb, cap, F)
        f_n = g_n if src_feat_transform is None else src_feat_transform(g_n)

        # query-side projections: (B, nb, H, C) / (B, nb, H, A) — per-node
        # matmuls; rounded to the compute dtype so the slot contractions stay
        # on the bf16 tensor-core path
        qk = jnp.einsum(
            "...nhd,chd->...nhc", q_b, proj.w_k, preferred_element_type=jnp.float32
        ).astype(dt)
        logits = jnp.einsum(
            "...nhc,...nkc->...nkh", qk, f_n, preferred_element_type=jnp.float32
        )
        if edge_raw is not None:
            e_n = take_rows(edge_raw, edge_ids, -2, adj_e2)  # (B, nb, cap, A)
            qe = jnp.einsum(
                "...nhd,ahd->...nha", q_b, proj.w_e, preferred_element_type=jnp.float32
            ).astype(dt)
            logits = logits + jnp.einsum(
                "...nha,...nka->...nkh", qe, e_n, preferred_element_type=jnp.float32
            )
        logits = logits * scale
        logits = jnp.where(mask[..., None], logits, -jnp.inf)
        m = jnp.max(logits, axis=-2, keepdims=True)
        m = jnp.where(jnp.isfinite(m), m, 0.0)
        w = jnp.exp(logits - m)
        w = jnp.where(mask[..., None], w, 0.0)
        denom = jnp.maximum(w.sum(axis=-2, keepdims=True), 1e-16)
        alpha = (w / denom).astype(dt)  # (B, nb, cap, H)

        # pooled features, then the commuted value projection per node
        s = jnp.einsum(
            "...nkh,...nkc->...nhc", alpha, f_n, preferred_element_type=jnp.float32
        ).astype(dt)
        out_b = jnp.einsum(
            "...nhc,chd->...nhd", s, proj.w_v, preferred_element_type=jnp.float32
        ).astype(dt)
        if edge_raw is not None:
            se = jnp.einsum(
                "...nkh,...nka->...nha", alpha, e_n, preferred_element_type=jnp.float32
            ).astype(dt)
            out_b = out_b + jnp.einsum(
                "...nha,ahd->...nhd", se, proj.w_e, preferred_element_type=jnp.float32
            ).astype(dt)
        if proj.b_out is not None:
            # Σα is exactly 1 where the destination has any live slot and 0
            # otherwise — use the static mask so the bias lands exactly
            has_edge = mask.any(axis=-1)  # (nb,)
            out_b = out_b + (
                has_edge[:, None, None] * proj.b_out.astype(dt)
            )
        outs.append(out_b)
    cat = jnp.concatenate(outs, axis=-3)
    if transpose is not None:
        nc = transpose.node_concat

        def re_adjoint(g, nc=nc):
            return jnp.take(g, jnp.asarray(nc), axis=-3)

        return take_rows(cat, reassemble, -3, re_adjoint)
    return jnp.take(cat, reassemble, axis=-3)


def bucketed_edge_attention(
    query: jnp.ndarray,
    key: jnp.ndarray,
    value: jnp.ndarray,
    edge_attr,
    buckets,
    reassemble: jnp.ndarray,
    edge_transform=None,
    transpose=None,
    return_partials: bool = False,
    src_transform=None,
) -> jnp.ndarray:
    """Per-edge attention over degree-bucketed tables.

    query (B, N, H, D) [destinations], key/value (B, Ns, H, D). Equivalent to
    :func:`dense_edge_attention` but each degree bucket is padded only to its
    own cap.

    ``edge_attr`` is either (B, E, H, D) projected edge features, or — when
    ``edge_transform`` is given — a *raw* (B, E, A) attribute tensor that is
    gathered narrow (A wide, cheap) and projected per bucket by
    ``edge_transform: (..., cap, A) -> (..., cap, H, D)``. Projecting after
    the gather keeps the E-wide projected tensor out of HBM entirely.

    ``src_transform`` applies the same trick to the *source nodes*: when
    given, ``key`` is a narrow (B, Ns, A) source tensor (``value`` is
    ignored), gathered ONCE per bucket, and
    ``src_transform: (..., cap, A) -> ((..., cap, H, D), (..., cap, H, D))``
    produces k/v per gathered row. Every op between the source rows and k/v
    (embedding, LayerNorm, the k/v projection) is per-row, so it commutes
    with the row gather exactly — this replaces two wide (H*D) gathers with
    one narrow one, trading gather bytes for matmul FLOPs on the padded
    rows (the right trade on a bytes-bound model).

    ``return_partials=True`` emits merge-form ``(num, den, m)`` fp32 partials
    (un-normalized, max −1e30 and den 0 for edge-less destinations) instead
    of the finished output — scatter-free in forward and (with ``transpose``)
    backward, used for the kernel plan's outlier edges.
    """
    num_edges = None if edge_attr is None else edge_attr.shape[-2 if edge_transform is not None else -3]
    outs = []
    for i, (node_ids, edge_ids, src_ids, mask) in enumerate(buckets):
        adj_q = adj_src = adj_e2 = adj_e3 = None
        if transpose is not None:
            tb = transpose.per_bucket[i]
            nb, cap = src_ids.shape
            num_src = transpose.num_src
            num_dst = len(transpose.node_concat)

            def adj_q(g, pon=tb["pos_of_node"], nd=num_dst):
                # query rows appear at most once per bucket
                return _masked_pos_take(g, pon, nd, axis=-3)

            def adj_src(g, t=tb["t_src"], nb=nb, cap=cap, ns=num_src):
                h, d = g.shape[-2:]
                gf = g.reshape(*g.shape[:-4], nb * cap, h * d)
                return _transpose_sum(gf, t, ns).reshape(*g.shape[:-4], ns, h, d)

            def adj_e2(g, poe=tb["pos_of_edge"], nb=nb, cap=cap, ne=num_edges):
                gf = g.reshape(*g.shape[:-3], nb * cap, g.shape[-1])
                return _masked_pos_take(gf, poe, ne, axis=-2)

            def adj_e3(g, poe=tb["pos_of_edge"], nb=nb, cap=cap, ne=num_edges):
                h, d = g.shape[-2:]
                gf = g.reshape(*g.shape[:-4], nb * cap, h, d)
                return _masked_pos_take(gf, poe, ne, axis=-3)

        q_b = take_rows(query, node_ids, -3, adj_q)  # (B, nb, H, D)
        if src_transform is not None:
            adj_src_flat = None
            if transpose is not None:

                def adj_src_flat(g, t=tb["t_src"], nb=nb, cap=cap, ns=num_src):
                    gf = g.reshape(*g.shape[:-3], nb * cap, g.shape[-1])
                    return _transpose_sum(gf, t, ns)

            g_n = take_rows(key, src_ids, -2, adj_src_flat)  # (B, nb, cap, A)
            k_n, v_n = src_transform(g_n)  # each (B, nb, cap, H, D)
        else:
            k_n = take_rows(key, src_ids, -3, adj_src)  # (B, nb, cap, H, D)
            v_n = take_rows(value, src_ids, -3, adj_src)
        if edge_attr is not None:
            if edge_transform is not None:
                e_n = edge_transform(take_rows(edge_attr, edge_ids, -2, adj_e2))
            else:
                e_n = take_rows(edge_attr, edge_ids, -3, adj_e3)
            k_n = k_n + e_n
            v_n = v_n + e_n

        d = q_b.shape[-1]
        scale = 1.0 / jnp.sqrt(jnp.asarray(d, jnp.float32))
        # fp32 accumulation of the q·k contraction (bf16-safe softmax logits)
        logits = jnp.einsum(
            "...nhd,...nkhd->...nkh", q_b, k_n, preferred_element_type=jnp.float32
        ) * scale
        logits = jnp.where(mask[..., None], logits, -1e30 if return_partials else -jnp.inf)
        m = jnp.max(logits, axis=-2, keepdims=True)
        if not return_partials:
            m = jnp.where(jnp.isfinite(m), m, 0.0)
        w = jnp.exp(logits - m)
        w = jnp.where(mask[..., None], w, 0.0)
        if return_partials:
            num_b = jnp.einsum("...nkh,...nkhd->...nhd", w, v_n.astype(jnp.float32))
            outs.append((num_b, w.sum(axis=-2), m[..., 0, :]))
            continue
        denom = jnp.maximum(w.sum(axis=-2, keepdims=True), 1e-16)
        alpha = (w / denom).astype(v_n.dtype)
        outs.append((v_n * alpha[..., None]).sum(axis=-3))
    if return_partials:
        re = lambda t, ax: (  # noqa: E731
            take_rows(
                jnp.concatenate(t, axis=ax), reassemble, ax,
                (lambda g, nc=transpose.node_concat: jnp.take(g, jnp.asarray(nc), axis=ax))
                if transpose is not None else None,
            )
        )
        nums, dens, ms = zip(*outs)
        return re(nums, -3), re(dens, -2), re(ms, -2)
    cat = jnp.concatenate(outs, axis=-3)
    if transpose is not None:
        nc = transpose.node_concat

        def re_adjoint(g, nc=nc):
            return jnp.take(g, jnp.asarray(nc), axis=-3)

        return take_rows(cat, reassemble, -3, re_adjoint)
    return jnp.take(cat, reassemble, axis=-3)
