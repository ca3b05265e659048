"""NaN imputation with static (first-batch) or dynamic (per-batch) masks.

Capability match for the reference ``preprocessing/imputer.py``: replace NaNs
with a statistic or constant per variable, expose a ``loss_mask_training``
zeroing the loss at imputed output locations, and re-insert NaNs on inverse.

Differences from the reference:
- the per-variable Python loops (``imputer.py:148-150,170-172``) become one
  gather → ``jnp.where`` → scatter over the mapped columns;
- the first-batch NaN mask is explicit functional state set by ``fit(x)``
  (eagerly auto-fitted on the first concrete call), never captured inside jit.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from anemoi_models_tpu.preprocessing import BasePreprocessor

__all__ = [
    "BaseImputer",
    "InputImputer",
    "ConstantImputer",
    "DynamicInputImputer",
    "DynamicConstantImputer",
]


class BaseImputer(BasePreprocessor):
    """Base class for imputers."""

    def __init__(
        self,
        config: Any = None,
        data_indices: Optional[Any] = None,
        statistics: Optional[dict] = None,
    ) -> None:
        super().__init__(config, data_indices, statistics)
        self.nan_locations: Optional[jnp.ndarray] = None
        self.loss_mask_training: Optional[jnp.ndarray] = None

    def _validate_indices(self):
        counts = {
            "train-in": len(self.index_training_input),
            "infer-in": len(self.index_inference_input),
            "train-out": len(self.index_training_output),
            "infer-out": len(self.index_inference_output),
            "values": len(self.replacement),
        }
        ok = (
            counts["train-in"] == counts["infer-in"] <= counts["values"]
            and counts["train-out"] == counts["infer-out"] <= counts["values"]
        )
        if not ok:
            raise RuntimeError(f"Imputer column bookkeeping is inconsistent: {counts}")

    def _create_imputation_indices(self, statistics: Optional[dict] = None):
        """Collect (source, per-width destination, replacement) per variable."""
        name_to_index_training_input = self.data_indices.data.input.name_to_index
        name_to_index_inference_input = self.data_indices.model.input.name_to_index
        name_to_index_training_output = self.data_indices.data.output.name_to_index
        name_to_index_inference_output = self.data_indices.model.output.name_to_index

        self.num_training_input_vars = len(name_to_index_training_input)
        self.num_inference_input_vars = len(name_to_index_inference_input)
        self.num_training_output_vars = len(name_to_index_training_output)
        self.num_inference_output_vars = len(name_to_index_inference_output)

        (
            self.index_training_input,
            self.index_inference_input,
            self.index_training_output,
            self.index_inference_output,
            self.replacement,
        ) = ([], [], [], [], [])

        for name in name_to_index_training_input:
            method = self.methods.get(name, self.default)
            if method == "none":
                continue
            self.index_training_input.append(name_to_index_training_input[name])
            self.index_training_output.append(name_to_index_training_output.get(name))
            self.index_inference_input.append(name_to_index_inference_input.get(name))
            self.index_inference_output.append(name_to_index_inference_output.get(name))

            if statistics is None:
                # ConstantImputer: the config key *is* the value
                self.replacement.append(float(method))
            elif isinstance(statistics, dict):
                if method not in statistics:
                    raise KeyError(
                        f"Imputer: statistic '{method}' (for variable '{name}') is not present "
                        f"in the dataset statistics (have: {sorted(statistics)})"
                    )
                self.replacement.append(float(statistics[method][name_to_index_training_input[name]]))
            else:
                raise TypeError(f"Imputer statistics must be a dict or None, got {type(statistics)}")

        # Dense per-width gather/scatter plans (static numpy, baked into jit)
        self._plan_input = {
            self.num_training_input_vars: self._make_plan(self.index_training_input),
            self.num_inference_input_vars: self._make_plan(self.index_inference_input),
        }
        self._plan_output = {
            self.num_training_output_vars: self._make_plan(self.index_training_output),
            self.num_inference_output_vars: self._make_plan(self.index_inference_output),
        }

    def _make_plan(self, dst_indices: list):
        """(dst_cols, src_cols, values) over pairs whose dst exists at this width."""
        dst, src, val = [], [], []
        for idx_src, idx_dst, value in zip(self.index_training_input, dst_indices, self.replacement):
            if idx_dst is not None:
                dst.append(idx_dst)
                src.append(idx_src)
                val.append(value)
        return (
            np.asarray(dst, dtype=np.int32),
            np.asarray(src, dtype=np.int32),
            np.asarray(val, dtype=np.float32),
        )

    # -- state -----------------------------------------------------------
    def get_nans(self, x) -> jnp.ndarray:
        """NaN mask over the trailing (grid, variable) dims of the first
        leading element (reference ``imputer.py:110-114``)."""
        lead = (0,) * (x.ndim - 2)
        return jnp.isnan(x[lead])

    def fit(self, x) -> None:
        """Record NaN locations + build the training loss mask (eager)."""
        self.nan_locations = self.get_nans(x)
        n_out = len(self.data_indices.model.output.name_to_index)
        loss_mask = jnp.ones((x.shape[-2], n_out), dtype=jnp.float32)
        for idx_src, idx_dst in zip(self.index_training_input, self.index_inference_output):
            if idx_dst is not None:
                loss_mask = loss_mask.at[:, idx_dst].set((~self.nan_locations[:, idx_src]).astype(jnp.float32))
        self.loss_mask_training = loss_mask

    def _ensure_fitted(self, x) -> None:
        if self.nan_locations is None:
            if isinstance(x, jax.core.Tracer):
                raise RuntimeError(
                    f"{self.__class__.__name__} used under jit before fit(); "
                    "call pipeline.fit(sample_batch) eagerly first."
                )
            self.fit(x)

    def _select_plan(self, plans: dict, width: int, kind: str):
        if width not in plans:
            raise ValueError(
                f"Imputer got a {width}-wide {kind} tensor; known widths are "
                f"({sorted(plans.keys())})"
            )
        return plans[width]

    # -- transforms ------------------------------------------------------
    def transform(self, x, in_place: bool = False):
        self._ensure_fitted(x)
        dst, src, val = self._select_plan(self._plan_input, x.shape[-1], "input")
        if dst.size == 0:
            return x
        sub = x[..., dst]
        mask = self.nan_locations[:, src]  # (grid, n_mapped), broadcasts over leading dims
        return x.at[..., dst].set(jnp.where(mask, val, sub))

    def inverse_transform(self, x, in_place: bool = False):
        dst, src, _ = self._select_plan(self._plan_output, x.shape[-1], "output")
        if dst.size == 0 or self.nan_locations is None:
            return x
        sub = x[..., dst]
        mask = self.nan_locations[:, src]
        return x.at[..., dst].set(jnp.where(mask, jnp.nan, sub))

    def state_dict(self) -> dict:
        state = {}
        if self.nan_locations is not None:
            state["nan_locations"] = self.nan_locations
            state["loss_mask_training"] = self.loss_mask_training
        return state


class InputImputer(BaseImputer):
    """Imputes missing values using the supplied statistics.

    Config keys are statistic names with variable lists, e.g.
    ``{"default": "none", "mean": ["y"], "maximum": ["x"]}``.
    """

    def __init__(self, config=None, data_indices=None, statistics=None) -> None:
        super().__init__(config, data_indices, statistics)
        self._create_imputation_indices(statistics)
        self._validate_indices()


class ConstantImputer(BaseImputer):
    """Imputes missing values with constants taken from the config keys,
    e.g. ``{"default": "none", 0: ["x"], 3.14: ["q"]}``."""

    def __init__(self, config=None, data_indices=None, statistics=None) -> None:
        super().__init__(config, data_indices, statistics)
        self._create_imputation_indices()
        self._validate_indices()


class DynamicMixin:
    """Recompute the NaN mask from every batch instead of caching it.

    Fully jit-compatible (no state); the inverse is the identity and NaNs are
    never re-inserted, matching reference ``imputer.py:234-273``.
    """

    def transform(self, x, in_place: bool = False):
        dst, _, val = self._select_plan(self._plan_input, x.shape[-1], "input")
        n_out = len(self.data_indices.model.output.name_to_index)
        self.loss_mask_training = jnp.ones((x.shape[-2], n_out), dtype=jnp.float32)
        if dst.size == 0:
            return x
        sub = x[..., dst]
        return x.at[..., dst].set(jnp.where(jnp.isnan(sub), val, sub))

    def inverse_transform(self, x, in_place: bool = False):
        return x

    def fit(self, x) -> None:  # nothing to fit
        return None


class DynamicInputImputer(DynamicMixin, InputImputer):
    """Statistics-based imputation with a per-batch NaN map."""

    def __init__(self, config=None, data_indices=None, statistics=None) -> None:
        super().__init__(config, data_indices, statistics)
        warnings.warn(
            "Dynamic imputation recomputes the NaN map every batch and never restores "
            "NaNs on inverse — the model learns to emit the fill values at missing points."
        )


class DynamicConstantImputer(DynamicMixin, ConstantImputer):
    """Constant imputation with a per-batch NaN map."""

    def __init__(self, config=None, data_indices=None, statistics=None) -> None:
        super().__init__(config, data_indices, statistics)
        warnings.warn(
            "Dynamic imputation recomputes the NaN map every batch and never restores "
            "NaNs on inverse — the model learns to emit the fill values at missing points."
        )
