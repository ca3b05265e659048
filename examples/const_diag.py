"""Diagnostic: where do graph tables live in the traced train step?

Walks the train-step jaxpr recursively and reports, per level, the total
bytes of (a) top-level consts, (b) consts embedded in nested closed jaxprs
(remat / custom_vjp / shard_map / pjit bodies), and (c) literal operands.
The answer decides the program-size lever for the O1280 compile: top-level
consts can be hoisted to arguments mechanically; embedded consts need the
table plumbing changed.

Run: env JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python examples/const_diag.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def walk(jaxpr, depth, acc, path="top"):
    import jax.core as core

    import numpy as _np
    for eqn in jaxpr.eqns:
        for iv in eqn.invars:
            val = getattr(iv, "val", None)
            if val is not None and hasattr(val, "shape"):
                nb = int(_np.prod(val.shape or (1,))) * val.dtype.itemsize
                if nb > 1 << 20:
                    acc.append((f"{path}/{eqn.primitive.name}.LITERAL", nb, 1))
        for p, v in eqn.params.items():
            sub = None
            if hasattr(v, "jaxpr") and hasattr(v, "consts"):  # ClosedJaxpr
                sub = v
            elif type(v).__name__ == "Jaxpr":
                sub = v
            if sub is None:
                continue
            consts = getattr(sub, "consts", [])
            nbytes = sum(int(_np.prod(getattr(c, "shape", ()) or (1,))) * getattr(c, "dtype", _np.dtype("b")).itemsize for c in consts if hasattr(c, "shape"))
            if nbytes > 1 << 20:
                acc.append((f"{path}/{eqn.primitive.name}.{p}", nbytes, len(consts)))
            inner = sub.jaxpr if hasattr(sub, "jaxpr") else sub
            walk(inner, depth + 1, acc, f"{path}/{eqn.primitive.name}")


def main() -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
    from anemoi_models_tpu.parallel import make_mesh, use_mesh
    from anemoi_models_tpu.training import make_train_step

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from examples.o1280_sharded import make_model

    grid_lat = int(os.environ.get("GRID_LAT", "96"))
    refin = int(os.environ.get("REFIN", "5"))
    channels = int(os.environ.get("C", "64"))
    layers = int(os.environ.get("L", "4"))

    graph = build_enc_proc_dec_graph(grid_lat=grid_lat, grid="octahedral", mesh_refinements=refin)
    model, indices = make_model(graph, channels=channels, layers=layers, heads=4, n_vars=8)
    n_grid = graph["data"].num_nodes
    n_in = len(indices.internal_model.input)
    n_out = len(indices.internal_model.output)
    x = jnp.zeros((1, 2, 1, n_grid, n_in), jnp.float32)
    y = jnp.zeros((1, 1, n_grid, n_out), jnp.float32)

    optimizer = optax.adam(1e-4)
    init_state, train_step = make_train_step(model, optimizer)

    n_dev = jax.device_count()
    mesh = make_mesh(data=1, model=n_dev)
    with use_mesh(mesh):
        state_shape = jax.eval_shape(init_state, jax.random.key(0), x)
        state = jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), state_shape
        )
        closed = jax.make_jaxpr(train_step)(state, x, y)
        def _nb(c):
            return int(np.prod(getattr(c, "shape", ()) or (1,))) * c.dtype.itemsize if hasattr(c, "shape") else 0
        top_bytes = sum(_nb(c) for c in closed.consts)
        print(f"top-level consts: {len(closed.consts)} arrays, {top_bytes/2**20:.1f} MiB")
        for c in sorted(closed.consts, key=lambda c: -_nb(c))[:12]:
            print(f"  const shape={getattr(c,'shape',None)} dtype={getattr(c,'dtype',None)} "
                  f"{_nb(c)/2**20:.1f} MiB")
        acc = []
        walk(closed.jaxpr, 0, acc)
        emb = sum(b for _, b, _ in acc)
        print(f"embedded consts in nested jaxprs: {emb/2**20:.1f} MiB across {len(acc)} sites")
        for path, b, n in sorted(acc, key=lambda t: -t[1])[:20]:
            print(f"  {b/2**20:9.1f} MiB  n={n:3d}  {path}")


if __name__ == "__main__":
    main()
