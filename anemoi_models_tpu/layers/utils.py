"""Layer utilities: activation registry + autocast layer norm.

Counterpart of reference ``layers/utils.py:16-39``. Activation names accept
the torch-style identifiers the reference configs use ("SiLU", "GELU", ...).
"""

from __future__ import annotations

from typing import Callable

from anemoi_models_tpu import nn
import jax
import jax.numpy as jnp

__all__ = ["get_activation", "AutocastLayerNorm"]

_ACTIVATIONS: dict[str, Callable] = {
    "silu": jax.nn.silu,
    "swish": jax.nn.silu,
    "gelu": jax.nn.gelu,
    "relu": jax.nn.relu,
    "leakyrelu": lambda x: jax.nn.leaky_relu(x),
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "elu": jax.nn.elu,
    "softplus": jax.nn.softplus,
    "mish": lambda x: x * jnp.tanh(jax.nn.softplus(x)),
    "identity": lambda x: x,
}


def get_activation(name: str) -> Callable:
    """Resolve an activation function from its (torch-style) config name."""
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError as exc:
        raise RuntimeError(f"Activation function {name} not supported") from exc


class AutocastLayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and input-dtype IO.

    The reference's AutocastLayerNorm (``layers/utils.py:27-39``) upcasts the
    whole computation to fp32 because torch LayerNorm in bf16 is fully bf16.
    ``nn.LayerNorm`` already accumulates mean/variance in fp32 regardless of
    ``dtype``, so keeping IO in the input dtype preserves the numerical
    discipline while halving the LN's memory traffic in bf16 runs.
    """

    use_bias: bool = True
    use_scale: bool = True

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return nn.LayerNorm(
            use_bias=self.use_bias,
            use_scale=self.use_scale,
            dtype=x.dtype,
        )(x)
