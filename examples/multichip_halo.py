"""Multi-chip training demo: halo-partitioned GraphTransformer on a mesh.

Runs the full enc-proc-dec model over a (data, model) device mesh. Under the
model axis the processor executes via 1-hop halo exchange — O(boundary)
communication per layer instead of the reference's full-node all-gather
(reference ``layers/block.py:203``).

Try it on CPU with emulated devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_halo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.models import AnemoiModelEncProcDec
from anemoi_models_tpu.parallel import make_mesh, use_mesh
from anemoi_models_tpu.training import make_train_step
from anemoi_models_tpu.utils import DotDict

VARS = {"lsm": 0, "z_500": 1, "t_850": 2, "t2m": 3, "tp": 4}


def main() -> None:
    n_dev = jax.device_count()
    data_ax = 2 if n_dev >= 8 else 1
    model_ax = n_dev // data_ax
    print(f"devices={n_dev} -> mesh (data={data_ax}, model={model_ax})")

    graph = build_enc_proc_dec_graph(grid_lat=16, mesh_refinements=3)
    cfg = DotDict(
        {
            "data": {"forcing": ["lsm"], "diagnostic": ["tp"], "processors": {}},
            "graph": {"data": "data", "hidden": "hidden"},
            "training": {"multistep_input": 2},
            "model": {
                "num_channels": 32,
                "trainable_parameters": {"hidden": 4},
                "model": {
                    "_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"
                },
                "encoder": {
                    "_target_": "anemoi.models.layers.mapper.GraphTransformerForwardMapper",
                    "num_heads": 4, "trainable_size": 2,
                    "sub_graph_edge_attributes": ["edge_length", "edge_dirs"],
                },
                "processor": {
                    "_target_": "anemoi.models.layers.processor.GraphTransformerProcessor",
                    "num_layers": 2, "num_chunks": 1, "num_heads": 4,
                    "trainable_size": 2,
                    "sub_graph_edge_attributes": ["edge_length", "edge_dirs"],
                },
                "decoder": {
                    "_target_": "anemoi.models.layers.mapper.GraphTransformerBackwardMapper",
                    "num_heads": 4, "trainable_size": 2,
                    "sub_graph_edge_attributes": ["edge_length", "edge_dirs"],
                },
            },
        }
    )
    di = IndexCollection(cfg, dict(VARS))
    model = AnemoiModelEncProcDec(model_config=cfg, data_indices=di, graph_data=graph)

    n_grid = graph["data"].num_nodes
    rng = np.random.RandomState(0)
    x = jnp.asarray(
        rng.randn(data_ax, 2, 1, n_grid, len(di.internal_model.input)), jnp.float32
    )
    y = jnp.asarray(
        rng.randn(data_ax, 1, n_grid, len(di.internal_model.output)), jnp.float32
    )

    init_state, train_step = make_train_step(model, optax.adam(1e-3))

    mesh = make_mesh(data=data_ax, model=model_ax)
    with use_mesh(mesh):
        # batch on the data axis; grid sharding + halo exchange are inserted
        # by the model's own annotations under the active mesh
        xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None, None, None)))
        ys = jax.device_put(y, NamedSharding(mesh, P("data", None, None, None)))
        state = jax.jit(init_state, static_argnums=())(jax.random.key(0), xs)
        step = jax.jit(train_step)
        for i in range(3):
            state, loss = step(state, xs, ys)
            print(f"step {i}: loss={float(loss):.5f}")


if __name__ == "__main__":
    main()
