"""Train-step builder: optax optimizer + value_and_grad over the model.

The reference delegates the training loop to anemoi-training/Lightning; this
module supplies the equivalent single-step primitive, designed to be
``jax.jit``-ed over a (data, model) mesh: gradients are computed by JAX AD
(including through the sharding constraints, so the adjoint collectives the
reference hand-writes in ``distributed/graph.py:140-298`` come for free).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from anemoi_models_tpu.training.loss import weighted_mse
from anemoi_models_tpu.training.rollout import make_rollout_fn

__all__ = ["TrainState", "make_train_step", "make_rollout_train_step", "resolve_remat_policy"]


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jnp.ndarray


def _dropout_rng_for(model: Any, dropout_seed: int):
    """Per-step dropout key derivation, or None for deterministic models.

    A model built with ``deterministic=False`` (reference trains with
    attention-weight dropout, ``layers/attention.py:60``) draws its "dropout"
    stream here: the key is folded from the optimizer step counter, so the
    noise sequence is reproducible and checkpoint-resume continues it exactly.
    """
    if getattr(model, "deterministic", True):
        return None
    base = jax.random.key(dropout_seed)

    def rng_at(step: jnp.ndarray) -> jax.Array:
        return jax.random.fold_in(base, step)

    return rng_at


def make_train_step(
    model: Any,
    optimizer: optax.GradientTransformation,
    loss_fn: Optional[Callable] = None,
    dropout_seed: int = 0,
) -> tuple[Callable, Callable]:
    """Return (init_state, train_step).

    ``train_step(state, x, y) -> (state, loss)`` where
    x: (batch, time, ensemble, grid, vars_in), y: (batch, ensemble, grid,
    vars_out) at the internal model widths.
    """
    loss_fn = loss_fn or (lambda pred, target: weighted_mse(pred, target))
    rng_at = _dropout_rng_for(model, dropout_seed)

    def init_state(rng: jax.Array, example_x: jnp.ndarray) -> TrainState:
        # a non-deterministic model traces its dropout path at init, so the
        # stream must exist (the draw itself creates no parameters)
        rngs = rng if rng_at is None else {"params": rng, "dropout": jax.random.fold_in(rng, 7)}
        params = model.init(rngs, example_x)
        return TrainState(params=params, opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32))

    def train_step(state: TrainState, x: jnp.ndarray, y: jnp.ndarray) -> tuple[TrainState, jnp.ndarray]:
        kwargs = {"rngs": {"dropout": rng_at(state.step)}} if rng_at else {}

        def loss_of(params):
            pred = model.apply(params, x, **kwargs)
            return loss_fn(pred, y)

        loss, grads = jax.value_and_grad(loss_of)(state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), loss

    return init_state, train_step


def make_rollout_train_step(
    model: Any,
    data_indices: Any,
    optimizer: optax.GradientTransformation,
    n_steps: int,
    loss_fn: Optional[Callable] = None,
    dropout_seed: int = 0,
) -> tuple[Callable, Callable]:
    """Train through an ``n_steps`` autoregressive rollout (the reference
    stack's rollout fine-tuning stage, here one ``lax.scan`` program).

    Returns (init_state, train_step) with
    ``train_step(state, x0, truth_inputs, targets) -> (state, loss)``:

    - ``x0``: (batch, multi_step, ensemble, grid, n_in) initial window,
    - ``truth_inputs``: (n_steps, batch, ensemble, grid, n_in) future truth
      at input width — forcings for each lead time are read from it,
    - ``targets``: (n_steps, batch, ensemble, grid, n_out); the loss
      averages over lead times, so every rollout step trains equally.
    """
    import numpy as np

    loss_fn = loss_fn or (lambda pred, target: weighted_mse(pred, target))
    rollout = make_rollout_fn(model, data_indices, n_steps)
    forcing_in = np.asarray(data_indices.internal_model.input.forcing)
    rng_at = _dropout_rng_for(model, dropout_seed)

    def init_state(rng: jax.Array, example_x: jnp.ndarray) -> TrainState:
        # a non-deterministic model traces its dropout path at init, so the
        # stream must exist (the draw itself creates no parameters)
        rngs = rng if rng_at is None else {"params": rng, "dropout": jax.random.fold_in(rng, 7)}
        params = model.init(rngs, example_x)
        return TrainState(params=params, opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32))

    def train_step(
        state: TrainState, x0: jnp.ndarray, truth_inputs: jnp.ndarray, targets: jnp.ndarray
    ) -> tuple[TrainState, jnp.ndarray]:
        forcings = truth_inputs[..., forcing_in] if forcing_in.size else None
        rng = rng_at(state.step) if rng_at else None

        def loss_of(params):
            _, preds = rollout(params, x0, forcings, rng=rng)
            return loss_fn(preds, targets)

        loss, grads = jax.value_and_grad(loss_of)(state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), loss

    return init_state, train_step


def resolve_remat_policy(
    model: Any,
    optimizer: optax.GradientTransformation,
    x_shape: tuple,
    y_shape: tuple,
    *,
    indices: Any = None,
    rollout: int = 1,
    ensemble: int = 1,
    loss_fn: Optional[Callable] = None,
    ema: bool = False,
    limit_bytes: Optional[int] = None,
    headroom: float = 0.85,
    log: Optional[Callable] = None,
) -> str:
    """Pick "none" vs "full" from the COMPILER's memory analysis.

    Skipping rematerialization entirely saves the backward's recompute —
    when the activations fit. This resolves ``remat_policy="auto"``: AOT-compile one train step of
    ``model`` (which must be built with ``remat_policy="none"``), read the
    compiled per-device peak, and keep "none" if it stays under
    ``headroom`` × the device's memory budget; otherwise fall back to the
    reference-equivalent "full". Costs one extra AOT compile only when the
    fallback triggers (the "none" executable is the one used otherwise).

    The compiled proxy must be the step variant the run will actually
    execute (advisor round-4 finding — a plain single-step proxy under-
    states rollout/ensemble/EMA peaks): ``rollout`` > 1 compiles the
    ``make_rollout_train_step`` scan (``indices`` required), ``ensemble``
    multiplies the member axis of ``x_shape``/``y_shape``, ``loss_fn``
    should be the run's loss (CRPS materializes member-pair terms), and
    ``ema=True`` threads a donated EMA tree through the step exactly as
    ``train_run`` does. ``steps_per_call`` needs no proxy: unrolled steps
    donate state between iterations, so the peak matches one step plus the
    (small) extra batch queue.

    ``limit_bytes=None`` reads ``memory_stats()['bytes_limit']`` from the
    first local device (a GPU reports it); when the backend reports no
    budget (CPU), the safe "full" is returned.
    """
    say = log or (lambda s: None)
    dev = jax.local_devices()[0]
    if limit_bytes is None:
        stats_fn = getattr(dev, "memory_stats", None)
        stats = stats_fn() if stats_fn else None
        limit_bytes = (stats or {}).get("bytes_limit")
    if not limit_bytes:
        say("remat auto: unknown device memory budget; using 'full'")
        return "full"
    x_shape = tuple(x_shape)
    y_shape = tuple(y_shape)
    if ensemble > 1:
        x_shape = x_shape[:2] + (x_shape[2] * ensemble,) + x_shape[3:]
        y_shape = y_shape[:1] + (y_shape[1] * ensemble,) + y_shape[2:]
    x_s = jax.ShapeDtypeStruct(x_shape, jnp.float32)
    if rollout > 1:
        assert indices is not None, "rollout remat proxy needs the IndexCollection"
        init_state, base_step = make_rollout_train_step(
            model, indices, optimizer, rollout, loss_fn
        )
        truth_s = jax.ShapeDtypeStruct((rollout,) + x_shape[:1] + x_shape[2:], jnp.float32)
        tgt_s = jax.ShapeDtypeStruct((rollout,) + y_shape, jnp.float32)
        step_args = (truth_s, tgt_s)
    else:
        init_state, base_step = make_train_step(model, optimizer, loss_fn)
        step_args = (jax.ShapeDtypeStruct(y_shape, jnp.float32),)
    state_shape = jax.eval_shape(init_state, jax.random.key(0), x_s)
    if ema:
        from anemoi_models_tpu.training.optim import ema_update

        def train_step(state, ema_tree, x, *rest):
            state, loss = base_step(state, x, *rest)
            return state, ema_update(ema_tree, state.params, 0.999), loss

        proxy_args = (state_shape, state_shape.params, x_s) + step_args
        donate = (0, 1)
    else:
        train_step = base_step
        proxy_args = (state_shape, x_s) + step_args
        donate = (0,)
    try:
        compiled = (
            jax.jit(train_step, donate_argnums=donate).lower(*proxy_args).compile()
        )
        ma = compiled.memory_analysis()
        peak = (
            ma.argument_size_in_bytes
            + ma.output_size_in_bytes
            + ma.temp_size_in_bytes
            - ma.alias_size_in_bytes
        )
    except Exception as exc:  # compiler refused (e.g. hard OOM at lowering)
        say(f"remat auto: 'none' compile failed ({type(exc).__name__}); using 'full'")
        return "full"
    ok = peak < headroom * limit_bytes
    say(
        f"remat auto: peak {peak / 2**30:.2f} GiB vs budget "
        f"{limit_bytes / 2**30:.1f} GiB -> {'none' if ok else 'full'}"
    )
    return "none" if ok else "full"
