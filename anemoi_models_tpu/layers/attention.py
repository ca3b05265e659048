"""Multi-head self-attention with sliding window.

Counterpart of reference ``layers/attention.py:34-112`` (fused QKV linear,
flash-attn windowed kernel or SDPA fallback). Here the switch is ``impl``:
"chunked" (blockwise, O(N·w) memory) / "reference" (plain jnp) / "halo"
(sequence-parallel under a model axis) / "auto" (see
``ops/attention.py``). Head-vs-sequence parallelism is not an explicit all-to-all as in the
reference (``attention.py:87-107``) — tensors carry named-sharding
constraints and GSPMD inserts the collectives (see ``parallel/``).
"""

from __future__ import annotations

from typing import Optional

from anemoi_models_tpu import nn
import jax.numpy as jnp

from anemoi_models_tpu.ops.attention import dot_product_attention
from anemoi_models_tpu.parallel.api import constrain, get_mesh

__all__ = ["MultiHeadSelfAttention"]


class MultiHeadSelfAttention(nn.Module):
    """MHSA over (batch, seq, channels) tensors."""

    num_heads: int
    embed_dim: int
    bias: bool = False
    is_causal: bool = False
    window_size: Optional[int] = None
    dropout_p: float = 0.0
    attention_impl: str = "auto"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray, deterministic: bool = True) -> jnp.ndarray:
        assert self.embed_dim % self.num_heads == 0, (
            f"Head split impossible: embed_dim {self.embed_dim} is not a multiple of "
            f"({self.num_heads})"
        )
        head_dim = self.embed_dim // self.num_heads
        batch, seq, _ = x.shape

        qkv = nn.Dense(3 * self.embed_dim, use_bias=self.bias, dtype=self.dtype, name="lin_qkv")(x)
        query, key, value = jnp.split(qkv, 3, axis=-1)
        # (B, H, N, D)
        query, key, value = (
            t.reshape(batch, seq, self.num_heads, head_dim).transpose(0, 2, 1, 3)
            for t in (query, key, value)
        )
        drop_rate = self.dropout_p if not deterministic else 0.0
        drop_rng = self.make_rng("dropout") if drop_rate > 0.0 else None
        mesh = get_mesh()
        impl = self.attention_impl
        if (
            impl == "auto"
            and self.window_size is not None
            and not self.is_causal
            and mesh is not None
            and "model" in mesh.axis_names
            and mesh.shape["model"] > 1
        ):
            # sequence-parallel default: windowed attention under a model axis
            # exchanges only +-window halos (ppermute) instead of the two
            # Ulysses all-to-alls; attention-weight dropout runs in-shard
            # (reference dropout_p semantics), so training keeps this path
            impl = "halo"
        if impl == "halo":
            if self.is_causal:
                raise NotImplementedError(
                    "halo attention has no causal mask; use attention_impl="
                    "'chunked' (is_causal is honored there)"
                )
            # sequence-parallel windowed attention: keep the sequence sharded
            # and exchange only ±window halos of k/v over the ring
            # (ops/ring_attention.py) — no all-to-alls at all.
            from anemoi_models_tpu.ops.ring_attention import halo_window_attention

            assert self.window_size is not None, "halo attention requires a window_size"
            assert mesh is not None, "halo attention requires an active mesh"
            out = halo_window_attention(
                query, key, value, window_size=self.window_size, mesh=mesh,
                dropout_rate=drop_rate, dropout_rng=drop_rng,
            )
        else:
            # Ulysses-style resharding, GSPMD edition: outside attention the
            # sequence axis is model-sharded; during attention the head axis
            # is. The sharding constraints make XLA insert the two all-to-alls
            # the reference hand-writes in shard_heads/shard_sequence
            # (``distributed/transformer.py:21-130``).
            query = constrain(query, ("data", "model", None, None))
            key = constrain(key, ("data", "model", None, None))
            value = constrain(value, ("data", "model", None, None))

            out = dot_product_attention(
                query,
                key,
                value,
                window_size=self.window_size,
                is_causal=self.is_causal,
                impl=impl,
                dropout_rate=drop_rate,
                dropout_rng=drop_rng,
            )
            out = constrain(out, ("data", "model", None, None))
        out = out.transpose(0, 2, 1, 3).reshape(batch, seq, self.embed_dim)
        out = constrain(out, ("data", "model", None))
        return nn.Dense(self.embed_dim, use_bias=True, dtype=self.dtype, name="projection")(out)
