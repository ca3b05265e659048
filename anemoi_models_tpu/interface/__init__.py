"""AnemoiModelInterface: pre-process → model → post-process.

Counterpart of reference ``interface/__init__.py:20-123``, reshaped for JAX:
the interface owns the (stateless) model definition plus the processor
pipelines, while parameters are an explicit pytree the caller holds/threads.
``predict_step`` mirrors the reference semantics: preprocess (not in place),
slice the multi-step window, add the ensemble dim, forward without gradients,
inverse post-process.
"""

from __future__ import annotations

import uuid
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from anemoi_models_tpu.preprocessing import Processors
from anemoi_models_tpu.utils.config import instantiate

__all__ = ["AnemoiModelInterface"]


class AnemoiModelInterface:
    """Wraps an Anemoi model with pre- and post-processing steps."""

    def __init__(
        self,
        *,
        config: Any,
        graph_data: Any,
        statistics: dict,
        data_indices: Any,
        metadata: Optional[dict] = None,
        supporting_arrays: Optional[dict] = None,
    ) -> None:
        self.config = config
        self.id = str(uuid.uuid4())
        self.multi_step = config.training.multistep_input
        self.graph_data = graph_data
        self.statistics = statistics
        self.metadata = metadata or {}
        self.supporting_arrays = supporting_arrays if supporting_arrays is not None else {}
        self.data_indices = data_indices
        self.params = None
        self._predict_fn = None
        self._build_model()

    def _build_model(self) -> None:
        """Instantiate processors and the model from config."""
        processors = [
            [name, instantiate(processor, data_indices=self.data_indices, statistics=self.statistics)]
            for name, processor in self.config.data.processors.items()
        ]
        self.pre_processors = Processors(processors)
        self.post_processors = Processors(processors, inverse=True)

        compute_dtype = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[
            self.config.model.get("compute_dtype", "float32")
        ]
        self.model = instantiate(
            self.config.model.model,
            model_config=self.config,
            data_indices=self.data_indices,
            graph_data=self.graph_data,
            dtype=compute_dtype,
        )

    # -- parameters ------------------------------------------------------
    def example_input(self, batch_size: int = 1, ensemble_size: int = 1) -> jnp.ndarray:
        """Zeros of the model-forward input shape (internal input width)."""
        grid = self.graph_data[self.config.graph.data].num_nodes
        n_in = len(self.data_indices.internal_model.input)
        return jnp.zeros((batch_size, self.multi_step, ensemble_size, grid, n_in), dtype=jnp.float32)

    def init_params(self, rng: jax.Array, example: Optional[jnp.ndarray] = None):
        """Initialize and store model parameters."""
        if example is None:
            example = self.example_input()
        self.params = self.model.init(rng, example)
        return self.params

    # -- forward paths ---------------------------------------------------
    def forward(self, x: jnp.ndarray, params=None) -> jnp.ndarray:
        params = params if params is not None else self.params
        assert params is not None, "Call init_params() (or pass params) before forward()."
        return self.model.apply(params, x)

    def fit_processors(self, batch: jnp.ndarray) -> None:
        """Eagerly fit stateful processors (imputer NaN masks) on a sample."""
        self.pre_processors.fit(batch)

    def predict_step(self, batch: jnp.ndarray, params=None) -> jnp.ndarray:
        """Preprocess → forward → postprocess one batch.

        ``batch``: (batch, time, grid, vars) at the model-input (inference)
        or data (training) variable width, as in the reference.
        """
        params = params if params is not None else self.params
        assert params is not None, "Call init_params() (or pass params) before predict_step()."
        batch = self.pre_processors(batch, in_place=False)
        assert len(batch.shape) == 4, (
            f"predict_step expects a (batch, time, grid, vars) 4-D tensor; received shape {batch.shape}"
        )
        x = batch[:, 0 : self.multi_step, None, ...]  # add ensemble dim
        y_hat = self.model.apply(params, x)
        return self.post_processors(y_hat, in_place=False)

    def make_rollout_fn(self, n_steps: int):
        """Jittable autoregressive rollout over the wrapped model
        (``training.rollout.make_rollout_fn`` bound to this interface)."""
        from anemoi_models_tpu.training import make_rollout_fn

        return make_rollout_fn(self.model, self.data_indices, n_steps)

    def predict_rollout(
        self,
        batch: jnp.ndarray,
        n_steps: int,
        forcings: Optional[jnp.ndarray] = None,
        params=None,
    ) -> jnp.ndarray:
        """Multi-step forecast: preprocess → autoregressive rollout →
        postprocess each lead time (the anemoi-inference serve surface).

        ``batch``: (batch, time, grid, vars) initial window;
        ``forcings``: (n_steps, batch, 1, grid, n_forcing) *preprocessed*
        per-step forcings, or None. Returns (n_steps, batch, ensemble, grid,
        vars_out) at the post-processed (physical) level.
        """
        params = params if params is not None else self.params
        assert params is not None, "Call init_params() (or pass params) first."
        pre = self.pre_processors(batch, in_place=False)
        x0 = pre[:, 0 : self.multi_step, None, ...]
        rollout = self.make_rollout_fn(n_steps)
        _, preds = rollout(params, x0, forcings)
        # every post-processor is per-(grid, variable) and broadcasts over
        # leading dims: one vectorized pass over all lead times, not a
        # host-visible Python loop per step
        return self.post_processors(preds, in_place=False)

    # -- checkpointing ---------------------------------------------------
    def save(
        self,
        path: str,
        opt_state=None,
        step: Optional[int] = None,
        include_graph: bool = True,
    ) -> str:
        """Persist params + processor state + metadata (numpy + JSON).

        With ``include_graph`` (default) the checkpoint is fully
        self-contained: the graph arrays, per-variable statistics, and the
        variable table all ride along, so :meth:`from_checkpoint` can rebuild
        the complete serving interface from the directory alone. Pass
        ``include_graph=False`` to keep checkpoints small when the graph is
        cached separately (``HeteroGraph.save``).
        """
        from anemoi_models_tpu.checkpoint import save_checkpoint

        assert self.params is not None, "No params to save; call init_params() first."
        supporting = dict(self.supporting_arrays)
        if include_graph and hasattr(self.graph_data, "to_arrays"):
            supporting.update(
                {f"graph::{k}": v for k, v in self.graph_data.to_arrays().items()}
            )
        metadata = dict(self.metadata)
        metadata["name_to_index"] = dict(self.data_indices.name_to_index)
        metadata["statistics"] = {
            k: np.asarray(v).tolist() for k, v in self.statistics.items()
        }
        return save_checkpoint(
            path,
            params=self.params,
            processor_state=self.pre_processors.state_dict(),
            opt_state=opt_state,
            step=step,
            metadata=metadata,
            config=self.config.to_dict() if hasattr(self.config, "to_dict") else dict(self.config),
            supporting_arrays=supporting,
            run_id=self.id,
        )

    @classmethod
    def from_checkpoint(cls, path: str, graph_data=None) -> "AnemoiModelInterface":
        """Rebuild a ready-to-serve interface from a checkpoint directory.

        The inverse of :meth:`save`: config, variable routing, statistics,
        graph (unless passed explicitly), parameters, and fitted processor
        state all come from the checkpoint — the anemoi-inference load path
        in one call.
        """
        from anemoi_models_tpu.checkpoint import load_checkpoint
        from anemoi_models_tpu.data_indices import IndexCollection
        from anemoi_models_tpu.utils import DotDict

        restored = load_checkpoint(path)
        meta = dict(restored.get("metadata") or {})
        n2i = meta.pop("name_to_index", None)
        stats = meta.pop("statistics", None)
        if n2i is None or stats is None:
            raise ValueError(
                f"checkpoint {path!r} predates self-contained saves (no variable "
                "table/statistics in its metadata); rebuild the interface by hand "
                "and use load() instead"
            )
        supporting = dict(restored.get("supporting_arrays") or {})
        graph_arrays = {
            k[len("graph::"):]: supporting.pop(k)
            for k in list(supporting)
            if k.startswith("graph::")
        }
        if graph_data is None:
            from anemoi_models_tpu.graphs import HeteroGraph

            if graph_arrays:
                graph_data = HeteroGraph.from_arrays(graph_arrays)
            else:
                # graph-once layout: training runs write the (immutable)
                # graph as a sibling graph.npz instead of re-bundling it
                # into every periodic checkpoint
                import os

                for cand in (os.path.join(path, "graph.npz"),
                             os.path.join(os.path.dirname(os.path.abspath(path)), "graph.npz")):
                    if os.path.exists(cand):
                        graph_data = HeteroGraph.load(cand)
                        break
                else:
                    raise ValueError(
                        f"checkpoint {path!r} was saved with include_graph=False and "
                        "no sibling graph.npz exists; pass graph_data= "
                        "(e.g. HeteroGraph.load(...))"
                    )

        config = DotDict(restored.get("config") or {})
        # JSON floats are doubles; keep them — the normalizer builds its
        # affine tables in float64 before casting, so restoring at float32
        # here would perturb the pipeline at the 1e-6 level
        statistics = {k: np.asarray(v, np.float64) for k, v in stats.items()}
        iface = cls(
            config=config,
            graph_data=graph_data,
            statistics=statistics,
            data_indices=IndexCollection(config, {k: int(v) for k, v in n2i.items()}),
            metadata=meta,
            supporting_arrays=supporting,
        )
        iface.params = restored["params"]
        if "processor_state" in restored:
            iface.pre_processors.load_state_dict(restored["processor_state"])
            iface.post_processors.load_state_dict(restored["processor_state"])
        if restored.get("run_id"):
            iface.id = restored["run_id"]
        return iface

    def load(self, path: str) -> dict:
        """Restore params + processor state; returns the full checkpoint dict."""
        from anemoi_models_tpu.checkpoint import load_checkpoint

        restored = load_checkpoint(path)
        self.params = restored["params"]
        if "processor_state" in restored:
            self.pre_processors.load_state_dict(restored["processor_state"])
            self.post_processors.load_state_dict(restored["processor_state"])
        if restored.get("run_id"):
            self.id = restored["run_id"]
        return restored

    def make_predict_fn(self, donate: bool = False):
        """Return a jitted ``(params, batch) -> prediction`` closure.

        Requires stateful processors to be fitted first (``fit_processors``).
        """

        def fn(params, batch):
            return self.predict_step(batch, params=params)

        return jax.jit(fn, donate_argnums=(1,) if donate else ())
