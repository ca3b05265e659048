from anemoi_models_tpu.ops.attention import dot_product_attention
from anemoi_models_tpu.ops.dense_graph import (
    bucketed_edge_attention,
    bucketed_neighbor_sum,
    dense_edge_attention,
    gather_edges,
    masked_neighbor_sum,
    take_rows,
)
from anemoi_models_tpu.ops.ring_attention import halo_window_attention
from anemoi_models_tpu.ops.segment import gather_nodes, segment_max, segment_softmax, segment_sum

__all__ = [
    "dot_product_attention",
    "halo_window_attention",
    "gather_nodes",
    "segment_max",
    "segment_softmax",
    "segment_sum",
    "dense_edge_attention",
    "bucketed_edge_attention",
    "bucketed_neighbor_sum",
    "gather_edges",
    "masked_neighbor_sum",
    "take_rows",
]
