"""Ready-made model configurations for the flagship architectures.

The reference ships its configs through anemoi-training's hydra tree; a user
switching to this framework gets the equivalent starting points here as
plain :class:`~anemoi_models_tpu.utils.DotDict` builders (drop-in for the
``config`` argument of :class:`~anemoi_models_tpu.interface.
AnemoiModelInterface`, with ``_target_`` paths under ``anemoi.models.*``
resolving to this package's modules).

All presets take the variable routing as arguments and default to the
AIFS-class GraphTransformer recipe (reference
``models/encoder_processor_decoder.py`` + GraphTransformer mappers and
processor, C=1024, 16 layers at production scale — scaled down by default
so the presets run anywhere).
"""

from __future__ import annotations

from typing import Optional, Sequence

from anemoi_models_tpu.utils import DotDict

__all__ = ["enc_proc_dec", "hierarchical", "FLAVORS"]

FLAVORS = ("graphtransformer", "gnn", "transformer")

_MAPPER = {
    "graphtransformer": "anemoi.models.layers.mapper.GraphTransformer{}Mapper",
    "gnn": "anemoi.models.layers.mapper.GNN{}Mapper",
}
_PROCESSOR = {
    "graphtransformer": "anemoi.models.layers.processor.GraphTransformerProcessor",
    "gnn": "anemoi.models.layers.processor.GNNProcessor",
    "transformer": "anemoi.models.layers.processor.TransformerProcessor",
}


def enc_proc_dec(
    *,
    forcing: Sequence[str],
    diagnostic: Sequence[str],
    flavor: str = "graphtransformer",
    num_channels: int = 256,
    num_layers: int = 8,
    num_chunks: int = 2,
    num_heads: int = 16,
    mlp_hidden_ratio: int = 4,
    multistep_input: int = 2,
    trainable_hidden: int = 8,
    trainable_edges: int = 4,
    window_size: int = 512,
    dropout_p: float = 0.0,
    graph_impl: Optional[str] = None,
    remat_policy: str = "full",
    compute_dtype: str = "bfloat16",
    normalizer_default: str = "mean-std",
    bounding: Sequence[dict] = (),
) -> DotDict:
    """Config for the canonical encoder-processor-decoder model.

    ``flavor`` selects the processor family (mappers follow: GNN mappers for
    the GNN flavor, GraphTransformer mappers otherwise, as in AIFS).
    ``graph_impl`` None keeps each layer's default ("dense" degree-bucketed
    gathers); "segment" selects the plain COO reference path.
    """
    assert flavor in FLAVORS, f"flavor must be one of {FLAVORS}, got {flavor!r}"
    assert not isinstance(forcing, str) and not isinstance(diagnostic, str), (
        "forcing/diagnostic take sequences of variable names, not a bare "
        "string (a string would split into characters)"
    )
    mapper_flavor = "gnn" if flavor == "gnn" else "graphtransformer"
    mapper_extra = (
        {"num_heads": num_heads, "mlp_hidden_ratio": mlp_hidden_ratio}
        if mapper_flavor == "graphtransformer"
        else {}
    )
    edge_attrs = ["edge_length", "edge_dirs"]
    proc: dict = {
        "_target_": _PROCESSOR[flavor],
        "num_layers": num_layers,
        "num_chunks": num_chunks,
        "remat_policy": remat_policy,
    }
    if flavor == "transformer":
        proc.update(
            num_heads=num_heads,
            mlp_hidden_ratio=mlp_hidden_ratio,
            window_size=window_size,
            dropout_p=dropout_p,
        )
    else:
        proc.update(
            trainable_size=trainable_edges,
            sub_graph_edge_attributes=edge_attrs,
        )
        if flavor == "graphtransformer":
            proc.update(num_heads=num_heads, mlp_hidden_ratio=mlp_hidden_ratio)
        if graph_impl:
            proc["graph_impl"] = graph_impl
    return DotDict(
        {
            "data": {
                "forcing": list(forcing),
                "diagnostic": list(diagnostic),
                "processors": {
                    "normalizer": {
                        "_target_": "anemoi.models.preprocessing.normalizer.InputNormalizer",
                        "config": {"default": normalizer_default},
                    },
                },
            },
            "graph": {"data": "data", "hidden": "hidden"},
            "training": {"multistep_input": multistep_input},
            "model": {
                "num_channels": num_channels,
                "compute_dtype": compute_dtype,
                "trainable_parameters": {"hidden": trainable_hidden},
                "bounding": list(bounding),
                "model": {
                    "_target_": "anemoi.models.models.encoder_processor_decoder.AnemoiModelEncProcDec"
                },
                "encoder": {
                    "_target_": _MAPPER[mapper_flavor].format("Forward"),
                    "trainable_size": trainable_edges,
                    "sub_graph_edge_attributes": edge_attrs,
                    **mapper_extra,
                },
                "processor": proc,
                "decoder": {
                    "_target_": _MAPPER[mapper_flavor].format("Backward"),
                    "trainable_size": trainable_edges,
                    "sub_graph_edge_attributes": edge_attrs,
                    **mapper_extra,
                },
            },
        }
    )


def hierarchical(
    *,
    forcing: Sequence[str],
    diagnostic: Sequence[str],
    hidden_names: Sequence[str],
    level_process_num_layers: int = 2,
    enable_level_processing: bool = True,
    **kwargs,
) -> DotDict:
    """Config for the hierarchical (mesh-pyramid) model over the node sets
    produced by :func:`anemoi_models_tpu.graphs.build_hierarchical_graph`."""
    cfg = enc_proc_dec(forcing=forcing, diagnostic=diagnostic, **kwargs)
    cfg.graph.hidden = list(hidden_names)
    cfg.model.model._target_ = (
        "anemoi.models.models.hierarchical.AnemoiModelEncProcDecHierarchical"
    )
    cfg.model.enable_hierarchical_level_processing = enable_level_processing
    cfg.model.level_process_num_layers = level_process_num_layers
    return cfg
