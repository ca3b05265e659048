"""End-to-end numerics parity vs an independent torch float64 oracle.

The oracle re-implements the full GraphTransformer enc-proc-dec forward —
the reference equations (``models/encoder_processor_decoder.py:168-233``,
``layers/block.py:429-635``, ``layers/conv.py:79-142``) — in plain torch
float64, consuming the *flax parameter tree* directly. This pins the whole
model (node attributes, mappers, processor, residual routing) to the
reference math, not just individual convs, and measures the multi-step
rollout RMSE drift of the fp32 model against the fp64 oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers_models import VARS, make_config

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.models import AnemoiModelEncProcDec

T64 = torch.float64


def t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def dense(p, x):
    return x @ t(p["kernel"]) + t(p["bias"])


def layer_norm(p, x, eps=1e-6):
    ln = p["LayerNorm_0"]
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * t(ln["scale"]) + t(ln["bias"])


def gelu(x):
    return torch.nn.functional.gelu(x)


def dst_mlp(p, x):
    x = layer_norm(p["AutocastLayerNorm_0"], x)
    x = gelu(dense(p["Dense_0"], x))
    return dense(p["Dense_1"], x)


def edge_attention(q, k, v, e, edge_index, num_dst):
    """alpha = softmax_dst(q_i . (k_j + e) / sqrt(d)); out = sum alpha (v_j + e)."""
    src = torch.as_tensor(np.asarray(edge_index[0]), dtype=torch.long)
    dst = torch.as_tensor(np.asarray(edge_index[1]), dtype=torch.long)
    h, d = q.shape[-2:]
    q_i, k_j, v_j = q[dst], k[src] + e, v[src] + e
    logits = (q_i * k_j).sum(-1) / d**0.5  # (E, H)
    out = torch.zeros((num_dst, h, d), dtype=T64)
    for hh in range(h):
        m = torch.full((num_dst,), -torch.inf, dtype=T64)
        m.scatter_reduce_(0, dst, logits[:, hh], reduce="amax")
        ex = torch.exp(logits[:, hh] - m[dst])
        z = torch.zeros(num_dst, dtype=T64).scatter_add_(0, dst, ex)
        alpha = ex / z[dst]
        out[:, hh, :].scatter_add_(0, dst[:, None].expand(-1, d), v_j[:, hh, :] * alpha[:, None])
    return out


def heads(x, num_heads):
    n, c = x.shape
    return x.view(n, num_heads, c // num_heads)


def gt_block(p, x_src, x_dst, edge_attr, edge_index, num_heads, fused_qkvs):
    """GraphTransformer mapper/processor block body (flax layers/block.py)."""
    num_dst = x_dst.shape[0]
    if fused_qkvs:
        xn = layer_norm(p["layer_norm1"], x_dst)
        q, k, v, x_r = dense(p["lin_qkvs"], xn).chunk(4, dim=-1)
    else:
        xs = layer_norm(p["layer_norm1"], x_src)
        xd = layer_norm(p["layer_norm2"], x_dst)
        q, x_r = dense(p["lin_qs"], xd).chunk(2, dim=-1)
        k, v = dense(p["lin_kv"], xs).chunk(2, dim=-1)
    e = dense(p["lin_edge"], edge_attr)
    out = edge_attention(
        heads(q, num_heads), heads(k, num_heads), heads(v, num_heads),
        heads(e, num_heads), edge_index, num_dst,
    ).reshape(num_dst, -1)
    out = dense(p["projection"], out + x_r)
    out = out + x_dst
    return dst_mlp(p["node_dst_mlp"], out) + out


def trainable_cat(p, static_attr):
    return torch.cat([t(static_attr), t(p["trainable"])], dim=-1)


def oracle_forward(params, cfg, di, graph, x_np):
    """Full torch float64 EncProcDec forward from the flax param tree."""
    p = params["params"]
    num_heads = 4
    b, ts, ens, n_grid, n_in = x_np.shape
    assert b == 1 and ens == 1

    # input flattening + node attributes
    x_flat = t(x_np).permute(0, 2, 3, 1, 4).reshape(n_grid, ts * n_in)
    na = p["node_attributes"]
    coords_d = graph["data"].coords
    coords_h = graph["hidden"].coords
    sincos_d = np.concatenate([np.sin(coords_d), np.cos(coords_d)], axis=-1)
    sincos_h = np.concatenate([np.sin(coords_h), np.cos(coords_h)], axis=-1)
    attrs_d = torch.cat([t(sincos_d), t(na["trainable_data"])], dim=-1)
    attrs_h = torch.cat([t(sincos_h), t(na["trainable_hidden"])], dim=-1)
    x_data_latent = torch.cat([x_flat, attrs_d], dim=-1)
    x_hidden_latent = attrs_h

    def edge_inputs(sub_p, es):
        static = es.attr_tensor(["edge_length", "edge_dirs"])
        return trainable_cat(sub_p["trainable"], static), es.edge_index

    # encoder: data -> hidden cross attention
    enc = p["encoder"]
    es_enc = graph[("data", "to", "hidden")]
    e_attr, e_idx = edge_inputs(enc, es_enc)
    # narrow-gather layout keeps emb_nodes_src inside the block scope
    emb_src = enc.get("emb_nodes_src") or enc["proc"]["emb_nodes_src"]
    x_src = dense(emb_src, x_data_latent)
    x_dst = dense(enc["emb_nodes_dst"], x_hidden_latent)
    x_latent = gt_block(enc["proc"], x_src, x_dst, e_attr, e_idx, num_heads, fused_qkvs=False)

    # processor: per-edge attention over the hidden mesh
    proc = p["processor"]
    es_proc = graph[("hidden", "to", "hidden")]
    pe_attr, pe_idx = edge_inputs(proc, es_proc)
    x_h = x_latent
    chunk_names = sorted(k for k in proc if k.startswith("proc_"))
    for cn in chunk_names:
        for bn in sorted(k for k in proc[cn] if k.startswith("blocks_")):
            x_h = gt_block(
                proc[cn][bn], x_h, x_h, pe_attr, pe_idx, num_heads, fused_qkvs=True
            )
    x_latent_proc = x_h + x_latent  # skip connection

    # decoder: hidden -> data
    dec = p["decoder"]
    es_dec = graph[("hidden", "to", "data")]
    de_attr, de_idx = edge_inputs(dec, es_dec)
    x_dst2 = dense(dec["emb_nodes_dst"], x_data_latent)
    x_out = gt_block(dec["proc"], x_latent_proc, x_dst2, de_attr, de_idx, num_heads, fused_qkvs=False)
    x_out = layer_norm(dec["node_data_extractor_norm"], x_out)
    x_out = dense(dec["node_data_extractor"], x_out)

    # prognostic residual
    prog_in = np.asarray(di.internal_model.input.prognostic)
    prog_out = np.asarray(di.internal_model.output.prognostic)
    x_out[:, prog_out] += t(x_np)[0, -1, 0][:, prog_in]
    return x_out  # (n_grid, n_out)


@pytest.fixture(scope="module")
def setup():
    graph = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=2)
    cfg = make_config("graphtransformer")
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=graph)
    n_grid = graph["data"].num_nodes
    n_in = len(di.internal_model.input)
    x = np.random.RandomState(0).randn(1, 2, 1, n_grid, n_in).astype(np.float32)
    params = model.init(jax.random.key(0), jnp.asarray(x))
    # zero-init trainables carry no signal; randomize them so the oracle
    # exercises every parameter path
    params = jax.tree_util.tree_map(
        lambda a: a + 0.02 * np.random.RandomState(1).randn(*a.shape).astype(np.float32)
        if a.ndim >= 1 else a,
        params,
    )
    return graph, cfg, di, model, x, params


def test_full_forward_matches_torch_oracle(setup):
    graph, cfg, di, model, x, params = setup
    ours = np.asarray(model.apply(params, jnp.asarray(x)))[0, 0]  # (grid, n_out)
    oracle = oracle_forward(params, cfg, di, graph, x).numpy()
    scale = np.abs(oracle).mean()
    err = np.abs(ours - oracle).max()
    mean_err = np.abs(ours - oracle).mean()
    # fp32 accumulation noise through ~10 matmul+LN layers; fp64 oracle is exact
    assert err < 2e-3 * max(scale, 1.0), f"e2e forward deviates from fp64 oracle: {err} (scale {scale})"
    assert mean_err < 3e-4 * max(scale, 1.0), f"mean deviation too large: {mean_err}"


def test_rollout_rmse_drift_vs_oracle(setup):
    """Autoregressive rollout: fp32 model vs fp64 oracle, RMSE per step
    (a '72h rollout RMSE delta' harness at test scale)."""
    graph, cfg, di, model, x, params = setup
    n_steps = 4
    prog_in = np.asarray(di.internal_model.input.prognostic)
    prog_out = np.asarray(di.internal_model.output.prognostic)
    force_in = np.asarray(di.internal_model.input.forcing)

    from anemoi_models_tpu.training import make_rollout_fn

    rollout = jax.jit(make_rollout_fn(model, di, n_steps))
    forc = np.zeros((n_steps, 1, 1, x.shape[3], len(force_in)), np.float32)
    _, preds = rollout(params, jnp.asarray(x), jnp.asarray(forc))
    preds = np.asarray(preds)  # (n_steps, 1, 1, grid, n_out)

    # oracle rollout
    xo = x.copy()
    rmses = []
    for s in range(n_steps):
        yo = oracle_forward(params, cfg, di, graph, xo).numpy()  # (grid, n_out)
        rmse = np.sqrt(np.mean((preds[s, 0, 0] - yo) ** 2))
        denom = np.sqrt(np.mean(yo**2)) + 1e-12
        rmses.append(rmse / denom)
        nxt = np.zeros((1, 1, 1, x.shape[3], x.shape[4]), np.float32)
        nxt[0, 0, 0][:, prog_in] = yo[:, prog_out]
        xo = np.concatenate([xo[:, 1:], nxt[:, 0]], axis=1) if False else np.concatenate(
            [xo[:, 1:], nxt.reshape(1, 1, 1, x.shape[3], x.shape[4])], axis=1
        )
    # fp32 drift against the fp64 oracle stays tiny over the rollout
    assert rmses[0] < 1e-4, rmses
    assert rmses[-1] < 5e-3, rmses
    assert all(np.isfinite(rmses))
