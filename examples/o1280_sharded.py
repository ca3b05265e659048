"""O1280 (AIFS production scale) end-to-end sharded proof.

The whole model-sharding architecture exists for this scale — the reference's
model-comm-group design (reference ``distributed/
graph.py:140-298``) shards the 6.6M-point grid because one device cannot hold
the activations. This script is the executable evidence: the full GraphTransformer
enc-proc-dec at true O1280 geometry (6,599,680-point octahedral grid,
refinement-8 hidden mesh; 61.7M/5.2M/19.8M edges) is jitted over an
8-device ``model`` axis of an emulated CPU mesh and EXECUTED — forward and
one optimizer step — with the dense+halo path (processor halo exchange,
GSPMD mappers). The compiled HLO is audited: no collective moves a full
node tensor.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/o1280_sharded.py --leg run --channels 64 --layers 2

A memory budget for one GPU's share of this model is not measured yet.

Smaller geometries for plumbing checks: ``--grid-lat 320 --refinements 6``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def load_or_build_graph(grid_lat: int, refinements: int):
    from anemoi_models_tpu.graphs import HeteroGraph, build_enc_proc_dec_graph

    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"o{grid_lat}_r{refinements}.npz")
    if os.path.exists(path):
        t0 = time.time()
        g = HeteroGraph.load(path)
        log(f"graph loaded from {path} in {time.time() - t0:.0f}s")
        return g
    t0 = time.time()
    g = build_enc_proc_dec_graph(
        grid_lat=grid_lat, grid="octahedral", mesh_refinements=refinements
    )
    log(f"graph built in {time.time() - t0:.0f}s; saving to {path}")
    g.save(path)
    return g


def make_model(graph, *, channels: int, layers: int, heads: int, n_vars: int,
               num_chunks: int = 2, layer_scan: bool = False):
    """AIFS-recipe GraphTransformer enc-proc-dec at the given width."""
    import jax.numpy as jnp

    from anemoi_models_tpu.data_indices import IndexCollection
    from anemoi_models_tpu.models import AnemoiModelEncProcDec
    from anemoi_models_tpu.utils import DotDict

    names = [f"v{i:03d}" for i in range(n_vars)]
    name_to_index = {n: i for i, n in enumerate(names)}
    forcing = names[: min(4, n_vars // 8 + 1)]
    diagnostic = names[-min(3, n_vars // 8 + 1):]
    edge_attrs = ["edge_length", "edge_dirs"]
    cfg = DotDict(
        {
            "data": {"forcing": forcing, "diagnostic": diagnostic, "processors": {}},
            "graph": {"data": "data", "hidden": "hidden"},
            "training": {"multistep_input": 2},
            "model": {
                "num_channels": channels,
                "trainable_parameters": {"hidden": 8},
                "model": {
                    "_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"
                },
                "encoder": {
                    "_target_": "anemoi.models.layers.mapper.GraphTransformerForwardMapper",
                    "num_heads": heads, "trainable_size": 4, "num_chunks": num_chunks,
                    "sub_graph_edge_attributes": edge_attrs,
                },
                "processor": {
                    "_target_": "anemoi.models.layers.processor.GraphTransformerProcessor",
                    "num_layers": layers, "num_chunks": max(layers // 2, 1),
                    "num_heads": heads, "trainable_size": 4,
                    "remat_policy": "full", "layer_scan": layer_scan,
                    "sub_graph_edge_attributes": edge_attrs,
                },
                "decoder": {
                    "_target_": "anemoi.models.layers.mapper.GraphTransformerBackwardMapper",
                    "num_heads": heads, "trainable_size": 4, "num_chunks": num_chunks,
                    "sub_graph_edge_attributes": edge_attrs,
                },
            },
        }
    )
    indices = IndexCollection(cfg, name_to_index)
    model = AnemoiModelEncProcDec(
        model_config=cfg, data_indices=indices, graph_data=graph, dtype=jnp.bfloat16
    )
    return model, indices


def audit_collectives(hlo_text: str, full_node_elems: int) -> dict:
    """Largest collective operand (elements) per op kind.

    The forbidden object is a full DATA-GRID tensor at hidden width
    (n_grid × C — the thing that cannot fit one chip, and what the
    reference's design all-gathers per GNN block, ``block.py:203``). The
    decoder's single narrow-source all-gather (n_mesh × C) and the
    encoder's raw-row gather (n_grid × ~20) are by design and far smaller;
    gradient all-reduces are excluded."""
    biggest: dict[str, int] = {}
    pat = re.compile(r"=\s+(?:\()?[a-z0-9]+\[([0-9,]*)\]")
    for line in hlo_text.splitlines():
        for kind in ("all-gather", "all-reduce", "all-to-all", "collective-permute",
                     "reduce-scatter"):
            if f" {kind}(" in line or f" {kind}-start(" in line:
                m = pat.search(line)
                if m:
                    dims = [int(d) for d in m.group(1).split(",") if d]
                    elems = int(np.prod(dims)) if dims else 1
                    biggest[kind] = max(biggest.get(kind, 0), elems)
    ok = all(v < full_node_elems for k, v in biggest.items() if k != "all-reduce")
    return {"largest_by_kind": biggest, "full_node_elems": full_node_elems, "ok": ok}


def leg_run(args) -> None:
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from anemoi_models_tpu.parallel import make_mesh, use_mesh
    from anemoi_models_tpu.training import make_train_step

    assert jax.default_backend() == "cpu", (
        "the executed leg emulates the mesh on CPU devices; run with "
        "JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8"
    )
    n_dev = jax.device_count()
    graph = load_or_build_graph(args.grid_lat, args.refinements)
    n_grid = graph["data"].num_nodes
    n_mesh = graph["hidden"].num_nodes
    log(f"geometry: grid={n_grid:,} mesh={n_mesh:,} "
        f"enc={graph[('data', 'to', 'hidden')].num_edges:,} "
        f"proc={graph[('hidden', 'to', 'hidden')].num_edges:,} "
        f"dec={graph[('hidden', 'to', 'data')].num_edges:,} edges; rss={rss_gb():.1f}GB")

    model, indices = make_model(
        graph, channels=args.channels, layers=args.layers, heads=args.heads,
        n_vars=args.vars, num_chunks=args.mapper_chunks,
    )
    n_in = len(indices.internal_model.input)
    n_out = len(indices.internal_model.output)
    x = jnp.asarray(np.random.RandomState(0).randn(1, 2, 1, n_grid, n_in), jnp.float32)
    y = jnp.zeros((1, 1, n_grid, n_out), jnp.float32)

    mesh = make_mesh(data=1, model=n_dev)
    batch_spec = NamedSharding(mesh, P(None, None, None, "model", None))
    target_spec = NamedSharding(mesh, P(None, None, "model", None))
    replicated = NamedSharding(mesh, P())

    optimizer = optax.adam(1e-4)
    init_state, train_step = make_train_step(model, optimizer)
    report: dict = {"geometry": {"grid": n_grid, "mesh": n_mesh},
                    "channels": args.channels, "layers": args.layers,
                    "devices": n_dev}

    with use_mesh(mesh):
        x = jax.device_put(x, batch_spec)
        y = jax.device_put(y, target_spec)
        t0 = time.time()
        state = jax.jit(init_state, out_shardings=replicated)(jax.random.key(0), x)
        jax.block_until_ready(state.params)
        n_params = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(state.params))
        log(f"init: {time.time() - t0:.0f}s, {n_params:,} params; rss={rss_gb():.1f}GB")
        report["params"] = n_params

        fwd = jax.jit(model.apply, in_shardings=(replicated, batch_spec))
        t0 = time.time()
        fwd_c = fwd.lower(state.params, x).compile()
        log(f"forward compile: {time.time() - t0:.0f}s; rss={rss_gb():.1f}GB")
        t0 = time.time()
        out = fwd_c(state.params, x)
        jax.block_until_ready(out)
        t_fwd = time.time() - t0
        assert bool(jnp.isfinite(out).all()), "non-finite forward output"
        log(f"forward RUN: {t_fwd:.1f}s on the emulated mesh ({n_dev} shards on "
            f"{os.cpu_count()} cores); rss={rss_gb():.1f}GB")
        report["forward_s"] = round(t_fwd, 1)

        audit = audit_collectives(fwd_c.as_text(), n_grid * args.channels)
        log(f"forward HLO collective audit: {audit}")
        report["forward_audit"] = audit
        assert audit["ok"], "a collective moved a full node tensor"
        del out

        step = jax.jit(
            train_step,
            in_shardings=(replicated, batch_spec, target_spec),
            out_shardings=(replicated, replicated),
            donate_argnums=(0,),
        )
        t0 = time.time()
        step_c = step.lower(state, x, y).compile()
        log(f"train-step compile: {time.time() - t0:.0f}s; rss={rss_gb():.1f}GB")
        t0 = time.time()
        state, loss = step_c(state, x, y)
        loss_v = float(loss)
        t_step = time.time() - t0
        assert np.isfinite(loss_v), f"non-finite loss {loss_v}"
        log(f"train step RUN: {t_step:.1f}s, loss={loss_v:.4f}; rss={rss_gb():.1f}GB")
        report["train_step_s"] = round(t_step, 1)
        report["loss"] = loss_v

        audit = audit_collectives(step_c.as_text(), n_grid * args.channels)
        log(f"train-step HLO collective audit: {audit}")
        report["train_audit"] = audit
        assert audit["ok"], "a collective moved a full node tensor"

    report["peak_rss_gb"] = round(rss_gb(), 1)
    _write_report(args, "run", report)


def _write_report(args, leg: str, payload: dict) -> None:
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"o{args.grid_lat}_{leg}_report.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    log(f"report written to {path}")
    print(json.dumps(payload))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--leg", choices=("run", "graph"), default="run")
    p.add_argument("--grid-lat", type=int, default=1280)
    p.add_argument("--refinements", type=int, default=8)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--vars", type=int, default=8)
    p.add_argument("--mapper-chunks", type=int, default=2,
                   help="dst-row chunks in the sharded mappers (bounds the "
                        "k/v/edge slot slabs, the dominant HBM term at scale)")
    args = p.parse_args()
    if args.leg == "graph":
        load_or_build_graph(args.grid_lat, args.refinements)
    else:
        leg_run(args)


if __name__ == "__main__":
    main()
