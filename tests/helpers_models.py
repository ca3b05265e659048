import numpy as np
from anemoi_models_tpu.data_indices import IndexCollection
from anemoi_models_tpu.graphs import build_enc_proc_dec_graph
from anemoi_models_tpu.utils import DotDict

VARS = {"lsm": 0, "z_500": 1, "t_850": 2, "t2m": 3, "tp": 4}  # forcing, prog, prog, prog, diag


def make_config(flavor: str = "graphtransformer", num_channels: int = 16, bounding=()):
    mapper_flavor = "gnn" if flavor == "gnn" else "graphtransformer"
    mapper_target = {
        "graphtransformer": "anemoi.models.layers.mapper.GraphTransformer{}Mapper",
        "gnn": "anemoi.models.layers.mapper.GNN{}Mapper",
    }[mapper_flavor]
    processor_target = {
        "graphtransformer": "anemoi.models.layers.processor.GraphTransformerProcessor",
        "gnn": "anemoi.models.layers.processor.GNNProcessor",
        "transformer": "anemoi.models.layers.processor.TransformerProcessor",
    }[flavor]
    proc_extra = {"num_heads": 4, "mlp_hidden_ratio": 4}
    if flavor == "gnn":
        proc_extra = {}
    elif flavor == "transformer":
        proc_extra = {
            "num_heads": 4,
            "mlp_hidden_ratio": 4,
            "window_size": 8,
            "dropout_p": 0.0,
            "attention_impl": "reference",
        }
    mapper_extra = {"num_heads": 4, "mlp_hidden_ratio": 4} if mapper_flavor == "graphtransformer" else {}
    return DotDict(
        {
            "data": {
                "forcing": ["lsm"],
                "diagnostic": ["tp"],
                "processors": {
                    "normalizer": {
                        "_target_": "anemoi.models.preprocessing.normalizer.InputNormalizer",
                        "config": {"default": "mean-std"},
                    },
                },
            },
            "graph": {"data": "data", "hidden": "hidden"},
            "training": {"multistep_input": 2},
            "model": {
                "num_channels": num_channels,
                "trainable_parameters": {"hidden": 4},
                "bounding": list(bounding),
                "model": {
                    "_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"
                },
                "encoder": {
                    "_target_": mapper_target.format("Forward"),
                    "trainable_size": 2,
                    "sub_graph_edge_attributes": ["edge_length", "edge_dirs"],
                    **mapper_extra,
                },
                "processor": {
                    "_target_": processor_target,
                    "num_layers": 2,
                    "num_chunks": 1,
                    **(
                        {"trainable_size": 2, "sub_graph_edge_attributes": ["edge_length", "edge_dirs"]}
                        if flavor != "transformer"
                        else {}
                    ),
                    **proc_extra,
                },
                "decoder": {
                    "_target_": mapper_target.format("Backward"),
                    "trainable_size": 2,
                    "sub_graph_edge_attributes": ["edge_length", "edge_dirs"],
                    **mapper_extra,
                },
            },
        }
    )


def make_statistics(n_vars: int = len(VARS)):
    rng = np.random.RandomState(3)
    return {
        "mean": rng.rand(n_vars) * 10,
        "stdev": rng.rand(n_vars) + 0.5,
        "minimum": np.zeros(n_vars),
        "maximum": np.ones(n_vars) * 20,
    }


_GRAPH_CACHE = {}


def small_graph_cached():
    if "g" not in _GRAPH_CACHE:
        _GRAPH_CACHE["g"] = build_enc_proc_dec_graph(grid_lat=6, mesh_refinements=1)
    return _GRAPH_CACHE["g"]


def flatten_dict(tree: dict, prefix: tuple = ()) -> dict:
    """Nested parameter dict -> {path tuple: leaf}."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten_dict(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def unflatten_dict(flat: dict) -> dict:
    """Inverse of :func:`flatten_dict`."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree
