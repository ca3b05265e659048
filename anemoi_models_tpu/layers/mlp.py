"""Multi-layer perceptron.

Same topology as reference ``layers/mlp.py:22-89``: Linear→act, then
``n_extra_layers + 1`` hidden Linear→act pairs, final Linear, optional final
activation, optional (autocast) LayerNorm. XLA sees a chain of dense
matmuls and fuses the activations.
"""

from __future__ import annotations

from anemoi_models_tpu import nn
import jax.numpy as jnp

from anemoi_models_tpu.layers.utils import AutocastLayerNorm, get_activation

__all__ = ["MLP", "apply_mlp_params"]


class MLP(nn.Module):
    """MLP with the reference's layer layout.

    Attributes
    ----------
    hidden_dim : width of the hidden layers.
    out_features : output width.
    n_extra_layers : extra hidden layers beyond the first (reference adds
        ``n_extra_layers + 1`` hidden Linears).
    activation : activation name ("SiLU", "GELU", ...).
    final_activation : apply activation after the output Linear.
    layer_norm : append an AutocastLayerNorm.
    """

    hidden_dim: int
    out_features: int
    n_extra_layers: int = 0
    activation: str = "SiLU"
    final_activation: bool = False
    layer_norm: bool = True
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        act = get_activation(self.activation)
        x = act(nn.Dense(self.hidden_dim, dtype=self.dtype)(x))
        for _ in range(self.n_extra_layers + 1):
            x = act(nn.Dense(self.hidden_dim, dtype=self.dtype)(x))
        x = nn.Dense(self.out_features, dtype=self.dtype)(x)
        if self.final_activation:
            x = act(x)
        if self.layer_norm:
            x = AutocastLayerNorm()(x)
        return x


def apply_mlp_params(w: dict, x: jnp.ndarray, activation: str, dtype) -> jnp.ndarray:
    """:class:`MLP` (hidden layers + final LayerNorm) as a pure function of
    its parameter tree ``w`` — for code that runs the MLP where a module
    cannot be called, such as inside ``shard_map``."""
    act = get_activation(activation)
    i = 0
    n_dense = sum(1 for k in w if k.startswith("Dense_"))
    while f"Dense_{i}" in w:
        d = w[f"Dense_{i}"]
        x = x @ d["kernel"].astype(dtype) + d["bias"].astype(dtype)
        if i < n_dense - 1:
            x = act(x)
        i += 1
    ln = w["AutocastLayerNorm_0"]["LayerNorm_0"]
    x32 = x.astype(jnp.float32)
    mu = x32.mean(-1, keepdims=True)
    var = x32.var(-1, keepdims=True)
    x = ((x32 - mu) / jnp.sqrt(var + 1e-6)).astype(x.dtype)
    return x * ln["scale"].astype(x.dtype) + ln["bias"].astype(x.dtype)
