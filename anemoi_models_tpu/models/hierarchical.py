"""Hierarchical encoder-processor-decoder over a pyramid of hidden meshes.

Counterpart of reference ``models/hierarchical.py:30-308``: multi-level hidden
meshes with ``hidden_dims = num_channels * 2^i``, downscale/upscale mapper
chains, optional per-level processors, and skip connections on the way up.
"""

from __future__ import annotations



from anemoi_models_tpu import nn
import jax.numpy as jnp

from anemoi_models_tpu.layers.graph import NamedNodesAttributes
from anemoi_models_tpu.models.encoder_processor_decoder import AnemoiModelEncProcDec, _accepted
from anemoi_models_tpu.parallel.api import constrain
from anemoi_models_tpu.utils.config import as_dotdict, instantiate

__all__ = ["AnemoiModelEncProcDecHierarchical"]


class AnemoiModelEncProcDecHierarchical(AnemoiModelEncProcDec):
    """Multi-resolution enc-proc-dec: a pyramid of hidden meshes with skip links."""

    def setup(self) -> None:
        cfg = as_dotdict(self.model_config)
        self._graph_name_data = cfg.graph.data
        self._graph_hidden_names = list(cfg.graph.hidden)
        self.num_hidden = len(self._graph_hidden_names)
        self.level_process = cfg.model.get("enable_hierarchical_level_processing", True)

        # feature width doubles with depth (reference hierarchical.py:62-64)
        self.hidden_dims = {
            hidden: cfg.model.num_channels * (2**i) for i, hidden in enumerate(self._graph_hidden_names)
        }

        self._calculate_shapes_and_indices(self.data_indices)
        self._assert_matching_indices(self.data_indices)

        self.multi_step = cfg.training.multistep_input

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
        h0 = self._graph_hidden_names[0]

        # Encoder data -> first hidden level
        self.encoder = instantiate(
            cfg.model.encoder,
            in_channels_src=input_dim,
            in_channels_dst=self.node_attributes.attr_ndims[h0],
            hidden_dim=self.hidden_dims[h0],
            sub_graph=self.graph_data[(self._graph_name_data, "to", h0)],
            src_grid_size=self.node_attributes.num_nodes[self._graph_name_data],
            dst_grid_size=self.node_attributes.num_nodes[h0],
            name="encoder",
            **_accepted(cfg.model.encoder, common),
        )

        # Per-level processors (down and up passes)
        down_procs, up_procs = {}, {}
        if self.level_process:
            for i in range(self.num_hidden):
                name = self._graph_hidden_names[i]
                for procs, tag in ((down_procs, "down"), (up_procs, "up")):
                    if tag == "up" and i == self.num_hidden - 1:
                        continue  # no final upscale processor (hierarchical.py:115-116)
                    procs[name] = instantiate(
                        cfg.model.processor,
                        num_channels=self.hidden_dims[name],
                        sub_graph=self.graph_data[(name, "to", name)],
                        src_grid_size=self.node_attributes.num_nodes[name],
                        dst_grid_size=self.node_attributes.num_nodes[name],
                        num_layers=cfg.model.level_process_num_layers,
                        name=f"{tag}_level_processor_{name}",
                        **_accepted(cfg.model.processor, common),
                    )
        self.down_level_processor = down_procs
        self.up_level_processor = up_procs

        # Downscale mappers (encoder-type) between consecutive levels
        downscale = {}
        for i in range(self.num_hidden - 1):
            src, dst = self._graph_hidden_names[i], self._graph_hidden_names[i + 1]
            downscale[src] = instantiate(
                cfg.model.encoder,
                in_channels_src=self.hidden_dims[src],
                in_channels_dst=self.node_attributes.attr_ndims[dst],
                hidden_dim=self.hidden_dims[dst],
                sub_graph=self.graph_data[(src, "to", dst)],
                src_grid_size=self.node_attributes.num_nodes[src],
                dst_grid_size=self.node_attributes.num_nodes[dst],
                name=f"downscale_{src}",
                **_accepted(cfg.model.encoder, common),
            )
        self.downscale = downscale

        # Upscale mappers (decoder-type) between consecutive levels
        upscale = {}
        for i in range(1, self.num_hidden):
            src, dst = self._graph_hidden_names[i], self._graph_hidden_names[i - 1]
            upscale[src] = instantiate(
                cfg.model.decoder,
                in_channels_src=self.hidden_dims[src],
                in_channels_dst=self.hidden_dims[dst],
                hidden_dim=self.hidden_dims[src],
                out_channels_dst=self.hidden_dims[dst],
                sub_graph=self.graph_data[(src, "to", dst)],
                src_grid_size=self.node_attributes.num_nodes[src],
                dst_grid_size=self.node_attributes.num_nodes[dst],
                name=f"upscale_{src}",
                **_accepted(cfg.model.decoder, common),
            )
        self.upscale = upscale

        # Decoder first hidden level -> data
        self.decoder = instantiate(
            cfg.model.decoder,
            in_channels_src=self.hidden_dims[h0],
            in_channels_dst=input_dim,
            hidden_dim=self.hidden_dims[h0],
            out_channels_dst=self.num_output_channels,
            sub_graph=self.graph_data[(h0, "to", self._graph_name_data)],
            src_grid_size=self.node_attributes.num_nodes[h0],
            dst_grid_size=self.node_attributes.num_nodes[self._graph_name_data],
            name="decoder",
            **_accepted(cfg.model.decoder, common),
        )

        self.boundings = [
            instantiate(bcfg, name_to_index=self.data_indices.internal_model.output.name_to_index)
            for bcfg in cfg.model.get("bounding", [])
        ]

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        batch_size, _, ensemble_size = x.shape[0], x.shape[1], x.shape[2]
        bse = batch_size * ensemble_size
        names = self._graph_hidden_names

        x_flat = jnp.transpose(x, (0, 2, 3, 1, 4)).reshape(bse, x.shape[3], -1)
        x_flat = constrain(x_flat, ("data", "model", None))
        x_trainable_data = jnp.concatenate(
            [x_flat, self.node_attributes(self._graph_name_data, bse).astype(x_flat.dtype)], axis=-1
        )
        x_trainable_hiddens = {h: self.node_attributes(h, bse) for h in names}

        # Run encoder
        x_data_latent, curr_latent = self.encoder(
            (x_trainable_data, x_trainable_hiddens[names[0]]), batch_size=bse
        )

        # Downscale path
        x_encoded_latents = {}
        x_skip = {}
        for i in range(self.num_hidden - 1):
            src, dst = names[i], names[i + 1]
            if self.level_process:
                curr_latent = self.down_level_processor[src](curr_latent, batch_size=bse)
            x_skip[src] = curr_latent
            x_encoded_latents[src], curr_latent = self.downscale[src](
                (curr_latent, x_trainable_hiddens[dst]), batch_size=bse
            )

        # Process the coarsest level
        if self.level_process:
            curr_latent = self.down_level_processor[names[-1]](curr_latent, batch_size=bse)

        # Upscale path with skip connections
        for i in range(self.num_hidden - 1, 0, -1):
            src, dst = names[i], names[i - 1]
            curr_latent = self.upscale[src]((curr_latent, x_encoded_latents[dst]), batch_size=bse)
            curr_latent = curr_latent + x_skip[dst]
            if self.level_process:
                curr_latent = self.up_level_processor[dst](curr_latent, batch_size=bse)

        # Run decoder
        x_out = self.decoder((curr_latent, x_data_latent), batch_size=bse)

        x_out = x_out.reshape(batch_size, ensemble_size, x.shape[3], self.num_output_channels).astype(
            x.dtype
        )
        x_out = x_out.at[..., self._internal_output_idx].add(
            x[:, -1, :, :, :][..., self._internal_input_idx]
        )
        for bounding in self.boundings:
            x_out = bounding(x_out)
        return x_out
