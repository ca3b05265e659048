"""Encoder-processor-decoder graph model.

Counterpart of reference ``models/encoder_processor_decoder.py:30-233``: a
weather state on the data grid is encoded onto a coarser hidden mesh,
processed for N layers, decoded back, with a residual connection for
prognostic variables and config-ordered output boundings. Encoder/processor/
decoder are interchangeable via ``_target_`` config entries.

Input layout: (batch, time, ensemble, grid, vars) — batch and ensemble are
merged into one leading axis internally (explicit dim, not the reference's
``(batch ensemble grid)`` token flattening), keeping the grid axis shardable.
"""

from __future__ import annotations

from typing import Any

from anemoi_models_tpu import nn
import jax.numpy as jnp
import numpy as np

from anemoi_models_tpu.layers.graph import NamedNodesAttributes
from anemoi_models_tpu.parallel.api import constrain
from anemoi_models_tpu.utils.config import as_dotdict, instantiate

__all__ = ["AnemoiModelEncProcDec"]


class AnemoiModelEncProcDec(nn.Module):
    """Message passing graph neural network (enc-proc-dec)."""

    model_config: Any
    data_indices: Any
    graph_data: Any
    deterministic: bool = True
    dtype: jnp.dtype = jnp.float32

    def setup(self) -> None:
        # linen freezes dict fields into FrozenDicts; restore dot access
        cfg = as_dotdict(self.model_config)
        self._graph_name_data = cfg.graph.data
        self._graph_name_hidden = cfg.graph.hidden

        self._calculate_shapes_and_indices(self.data_indices)
        self._assert_matching_indices(self.data_indices)

        self.multi_step = cfg.training.multistep_input
        self.num_channels = cfg.model.num_channels

        self.node_attributes = NamedNodesAttributes(
            num_trainable_params=cfg.model.trainable_parameters.hidden,
            graph_data=self.graph_data,
            name="node_attributes",
        )

        input_dim = (
            self.multi_step * self.num_input_channels
            + self.node_attributes.attr_ndims[self._graph_name_data]
        )
        self.input_dim = input_dim

        common = dict(deterministic=self.deterministic, dtype=self.dtype)
        self.encoder = instantiate(
            cfg.model.encoder,
            in_channels_src=input_dim,
            in_channels_dst=self.node_attributes.attr_ndims[self._graph_name_hidden],
            hidden_dim=self.num_channels,
            sub_graph=self.graph_data[(self._graph_name_data, "to", self._graph_name_hidden)],
            src_grid_size=self.node_attributes.num_nodes[self._graph_name_data],
            dst_grid_size=self.node_attributes.num_nodes[self._graph_name_hidden],
            name="encoder",
            **_accepted(cfg.model.encoder, common),
        )
        # graph kwargs are filtered: the TransformerProcessor flavor takes no
        # sub_graph (it attends over mesh positions, not edges)
        self.processor = instantiate(
            cfg.model.processor,
            num_channels=self.num_channels,
            name="processor",
            **_accepted(
                cfg.model.processor,
                {
                    **common,
                    "sub_graph": self.graph_data.edges.get(
                        (self._graph_name_hidden, "to", self._graph_name_hidden)
                    ),
                    "src_grid_size": self.node_attributes.num_nodes[self._graph_name_hidden],
                    "dst_grid_size": self.node_attributes.num_nodes[self._graph_name_hidden],
                },
            ),
        )
        self.decoder = instantiate(
            cfg.model.decoder,
            in_channels_src=self.num_channels,
            in_channels_dst=input_dim,
            hidden_dim=self.num_channels,
            out_channels_dst=self.num_output_channels,
            sub_graph=self.graph_data[(self._graph_name_hidden, "to", self._graph_name_data)],
            src_grid_size=self.node_attributes.num_nodes[self._graph_name_hidden],
            dst_grid_size=self.node_attributes.num_nodes[self._graph_name_data],
            name="decoder",
            **_accepted(cfg.model.decoder, common),
        )

        self.boundings = [
            instantiate(bcfg, name_to_index=self.data_indices.internal_model.output.name_to_index)
            for bcfg in cfg.model.get("bounding", [])
        ]

    # -- index bookkeeping (reference encoder_processor_decoder.py:108-125) --
    def _calculate_shapes_and_indices(self, data_indices: Any) -> None:
        self.num_input_channels = len(data_indices.internal_model.input)
        self.num_output_channels = len(data_indices.internal_model.output)
        self._internal_input_idx = np.asarray(data_indices.internal_model.input.prognostic)
        self._internal_output_idx = np.asarray(data_indices.internal_model.output.prognostic)

    def _assert_matching_indices(self, data_indices: Any) -> None:
        assert len(self._internal_output_idx) == len(data_indices.internal_model.output.full) - len(
            data_indices.internal_model.output.diagnostic
        ), (
            f"Routing-table width check failed: {len(self._internal_output_idx)} internal data outputs vs "
            f"the internal output indices excluding diagnostic variables "
            f"({len(data_indices.internal_model.output.full) - len(data_indices.internal_model.output.diagnostic)})"
        )
        assert len(self._internal_input_idx) == len(self._internal_output_idx), (
            f"Prognostic input/output index vectors diverge: {self._internal_input_idx} vs {self._internal_output_idx}"
        )

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        """x: (batch, time, ensemble, grid, vars) -> (batch, ensemble, grid, vars_out)."""
        batch_size, _, ensemble_size = x.shape[0], x.shape[1], x.shape[2]
        bse = batch_size * ensemble_size

        # (batch, time, ensemble, grid, vars) -> (batch*ensemble, grid, time*vars)
        x_flat = jnp.transpose(x, (0, 2, 3, 1, 4)).reshape(bse, x.shape[3], -1)
        x_flat = constrain(x_flat, ("data", "model", None))

        x_data_latent = jnp.concatenate(
            [x_flat, self.node_attributes(self._graph_name_data, bse).astype(x_flat.dtype)], axis=-1
        )
        x_hidden_latent = self.node_attributes(self._graph_name_hidden, bse)

        x_data_latent, x_latent = self.encoder((x_data_latent, x_hidden_latent), batch_size=bse)

        x_latent_proc = self.processor(x_latent, batch_size=bse)

        # skip connection (hidden -> hidden)
        x_latent_proc = x_latent_proc + x_latent

        x_out = self.decoder((x_latent_proc, x_data_latent), batch_size=bse)

        x_out = x_out.reshape(batch_size, ensemble_size, x.shape[3], self.num_output_channels).astype(
            x.dtype
        )

        # residual connection for prognostic variables only
        x_out = x_out.at[..., self._internal_output_idx].add(
            x[:, -1, :, :, :][..., self._internal_input_idx]
        )

        for bounding in self.boundings:
            x_out = bounding(x_out)

        return x_out


def _accepted(cfg: Any, extra: dict) -> dict:
    """Forward only the extra kwargs the target module actually declares."""
    from anemoi_models_tpu.utils.config import resolve_target

    target = resolve_target(cfg["_target_"])
    fields = getattr(target, "__dataclass_fields__", {})
    return {k: v for k, v in extra.items() if k in fields}
