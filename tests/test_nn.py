"""The in-repo module system (``anemoi_models_tpu.nn``): parameter-tree
names and shapes, numerics of Dense/LayerNorm, and the remat and scan
transforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anemoi_models_tpu import nn
from anemoi_models_tpu.layers.mlp import MLP, apply_mlp_params


def shapes(tree):
    return {jax.tree_util.keystr(k): tuple(v.shape) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_mlp_param_tree_layout():
    p = MLP(hidden_dim=8, out_features=4).init(jax.random.key(0), jnp.ones((2, 6)))
    assert shapes(p) == {
        "['params']['AutocastLayerNorm_0']['LayerNorm_0']['bias']": (4,),
        "['params']['AutocastLayerNorm_0']['LayerNorm_0']['scale']": (4,),
        "['params']['Dense_0']['bias']": (8,),
        "['params']['Dense_0']['kernel']": (6, 8),
        "['params']['Dense_1']['bias']": (8,),
        "['params']['Dense_1']['kernel']": (8, 8),
        "['params']['Dense_2']['bias']": (4,),
        "['params']['Dense_2']['kernel']": (8, 4),
    }


class _Two(nn.Module):
    @nn.compact
    def __call__(self, x):
        shared = nn.Dense(3)
        y = shared(x) + shared(x)  # one instance, one set of params
        y = nn.Dense(3, name="named")(y)
        return nn.Dense(2)(y) + nn.LayerNorm()(y).sum(-1, keepdims=True)


def test_autonames_and_sharing():
    m = _Two()
    x = jnp.ones((1, 5))
    p = m.init(jax.random.key(0), x)
    assert sorted(p["params"]) == ["Dense_0", "Dense_1", "LayerNorm_0", "named"]
    # apply reads exactly the tree init wrote, twice in a row
    np.testing.assert_array_equal(m.apply(p, x), m.apply(p, x))


def test_apply_missing_parameter_raises():
    p = _Two().init(jax.random.key(0), jnp.ones((1, 5)))
    del p["params"]["named"]
    with pytest.raises(KeyError, match="named/kernel"):
        _Two().apply(p, jnp.ones((1, 5)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dense_and_layernorm_numerics(dtype):
    x = jnp.asarray(np.random.RandomState(0).randn(4, 6), jnp.float32).astype(dtype)
    d = nn.Dense(5, dtype=dtype)
    pd = d.init(jax.random.key(1), x)["params"]
    want = x.astype(dtype) @ pd["kernel"].astype(dtype) + pd["bias"].astype(dtype)
    got = d.apply({"params": pd}, x)
    assert got.dtype == dtype
    np.testing.assert_array_equal(np.asarray(got, np.float32), np.asarray(want, np.float32))

    ln = nn.LayerNorm(dtype=dtype)
    pl = ln.init(jax.random.key(2), x)["params"]
    xf = x.astype(jnp.float32)
    mu = xf.mean(-1, keepdims=True)
    var = jnp.maximum(0.0, (xf * xf).mean(-1, keepdims=True) - mu * mu)
    want = ((xf - mu) * jax.lax.rsqrt(var + 1e-6) * pl["scale"] + pl["bias"]).astype(dtype)
    got = ln.apply({"params": pl}, x)
    assert got.dtype == dtype
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=1e-6, atol=1e-6)


def test_apply_mlp_params_matches_module():
    m = MLP(hidden_dim=8, out_features=4)
    x = jnp.asarray(np.random.RandomState(3).randn(3, 6), jnp.float32)
    p = m.init(jax.random.key(0), x)
    np.testing.assert_allclose(
        np.asarray(apply_mlp_params(p["params"], x, "SiLU", jnp.float32)),
        np.asarray(m.apply(p, x)), rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("policy", [None, jax.checkpoint_policies.dots_with_no_batch_dims_saveable])
def test_remat_matches_plain(policy):
    x = jnp.asarray(np.random.RandomState(4).randn(2, 6), jnp.float32)
    plain = MLP(hidden_dim=8, out_features=4)
    remat = nn.remat(MLP, policy=policy)(hidden_dim=8, out_features=4)
    p = plain.init(jax.random.key(0), x)
    assert shapes(remat.init(jax.random.key(0), x)) == shapes(p)

    def loss(m):
        return lambda p: jnp.sum(m.apply(p, x) ** 2)

    np.testing.assert_array_equal(remat.apply(p, x), plain.apply(p, x))
    for a, b in zip(jax.tree_util.tree_leaves(jax.grad(loss(remat))(p)),
                    jax.tree_util.tree_leaves(jax.grad(loss(plain))(p))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


class _Step(nn.Module):
    width: int

    @nn.compact
    def __call__(self, carry, scale):
        y = nn.Dense(self.width, name="block")(carry) * scale
        return jnp.tanh(y), y.sum()


def test_scan_stacks_params_and_matches_loop():
    layers = nn.scan(_Step, length=3)(width=4)
    x = jnp.asarray(np.random.RandomState(5).randn(2, 4), jnp.float32)
    p = layers.init(jax.random.key(0), x, 0.5)
    assert shapes(p) == {"['params']['block']['bias']": (3, 4), "['params']['block']['kernel']": (3, 4, 4)}
    k = p["params"]["block"]["kernel"]
    assert not np.allclose(k[0], k[1])  # each layer drew its own init
    carry, ys = layers.apply(p, x, 0.5)
    ref = x
    for i in range(3):
        step_p = {"params": {"block": jax.tree_util.tree_map(lambda a: a[i], p["params"]["block"])}}
        ref, y = _Step(width=4).apply(step_p, ref, 0.5)
        np.testing.assert_allclose(np.asarray(ys[i]), np.asarray(y), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(carry), np.asarray(ref), rtol=1e-6, atol=1e-7)


class _Drop(nn.Module):
    @nn.compact
    def __call__(self, x):
        return x * jax.random.uniform(self.make_rng("dropout"), x.shape) + x * jax.random.uniform(
            self.make_rng("dropout"), x.shape
        )


def test_make_rng_streams():
    m = _Drop()
    x = jnp.ones((3,))
    a = m.apply({}, x, rngs={"dropout": jax.random.key(1)})
    b = m.apply({}, x, rngs={"dropout": jax.random.key(1)})
    c = m.apply({}, x, rngs={"dropout": jax.random.key(2)})
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    with pytest.raises(ValueError, match="dropout"):
        m.apply({}, x)


class _Setup(nn.Module):
    width: int

    def setup(self):
        self.proj = nn.Dense(self.width, name="proj")
        self.twice = 2 * self.width

    def __call__(self, x):
        return self.proj(x)


def test_setup_children_and_variables():
    m = _Setup(width=3)
    p = m.init(jax.random.key(0), jnp.ones((1, 2)))
    assert shapes(p) == {"['params']['proj']['bias']": (3,), "['params']['proj']['kernel']": (2, 3)}
    assert m.clone(width=5).width == 5 and m.width == 3
