#!/usr/bin/env python3
"""Run the system's main path once on one GPU and check what comes out.

    python chip_smoke.py              # one card: the phases below, in order
    python chip_smoke.py --multichip  # four cards: model- and data-parallel
                                      # training against one card, nothing else
    python chip_smoke.py --rehearse   # tiny sizes on any backend (a CPU run
                                      # checks the script, not the card)

Phases (one card):

1. device and environment: the card's name and power limit, JAX, the
   compile-cache directory, which optional packages import; anything but
   the GPU backend ends the run;
2. train: ``training.train_run`` on a synthetic O96 source (40,320 points,
   mesh refinement 5) with the GraphTransformer preset (C=256, L=8, 16
   heads, bf16), batch 1, 8 steps, loader running;
3. forecast: ``predict_rollout`` for 4 steps at B=1 with the trained model;
4. flavors: one forward and one train step of the gnn and transformer
   presets at the same sizes;
5. references at real widths: the dense graph path against the segment
   reference, and the GPU attention route against the reference attention.

A failed check raises, so the run exits non-zero and prints no result. The
last line of standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import anemoi_models_tpu  # noqa: E402

if os.path.dirname(os.path.abspath(anemoi_models_tpu.__file__)) != os.path.join(HERE, "anemoi_models_tpu"):
    sys.exit(f"chip_smoke: anemoi_models_tpu must sit beside this script, found {anemoi_models_tpu.__file__}")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# Published sizes (O96 data grid, refinement-5 hidden mesh, the preset's
# widths), and a tiny stand-in for rehearsals off the card.
SIZES = {
    "full": dict(grid=96, refinements=5, channels=256, layers=8, heads=16, window=512, steps=8),
    "rehearse": dict(grid=12, refinements=2, channels=32, layers=2, heads=4, window=16, steps=4),
}
VARIABLES = [f"var_{i}" for i in range(6)]
FORCING, DIAGNOSTIC = ("var_0",), ("var_5",)
FORECAST_STEPS = 4
MULTICHIP_LAYERS = 2
OPTIONAL_IMPORTS = ("flax", "orbax.checkpoint", "zstandard", "h5py")

# Tolerances (reasons in PERF.md, "Tolerances").
# dense vs segment, float32 under "highest": the two paths sum the same
# terms in another order, so they agree to float32 rounding amplified by
# depth, not bit for bit.
GRAPH_F32_REL_L2 = 1e-4
# GPU attention route (bf16 in, float32 softmax, bf16 probabilities and
# output) vs the float32 reference on the same bf16 inputs: bf16 keeps 8
# significant bits, a relative rounding of up to 2^-9 on each stored value;
# the bound allows four such roundings at the largest output.
ATTN_BF16_MAX_ABS_REL = 2.0**-7  # times max |reference|
ATTN_BF16_REL_L2 = 1e-2
# four cards vs one: model-parallel in float32 under "highest" (the halo
# exchange reorders sums); data-parallel in the bf16 preset (another batch
# shape per card can pick other GEMM algorithms).
MP_F32_REL_L2 = 1e-4
MP_F32_LOSS_REL = 1e-5
DP_BF16_LOSS_REL = 5e-3


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--multichip", action="store_true",
                   help="run the four-card model- and data-parallel comparison only")
    p.add_argument("--rehearse", action="store_true",
                   help="tiny sizes on whatever backend JAX has")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def phases(args: argparse.Namespace) -> list[str]:
    """The phases this invocation runs, in order."""
    if args.multichip:
        return ["device", "multichip"]
    return ["device", "train", "forecast", "flavors", "references"]


def result_line(device: dict) -> str:
    """The last line of a passing run."""
    return json.dumps({
        "ok": True,
        "device": {"platform": device["platform"], "kind": device["kind"], "count": device["count"]},
    })


def say(msg: str) -> None:
    print(msg, flush=True)


class CompileTimer:
    """Seconds JAX spends tracing, lowering and compiling, from its own
    monitoring events."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_) -> None:
        if event in self.EVENTS:
            self.seconds += duration

    def take(self) -> float:
        s, self.seconds = self.seconds, 0.0
        return s


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tree_rel_l2(a, b) -> float:
    la = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(a)])
    lb = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(b)])
    return rel_l2(la, lb)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def peak_bytes() -> int | None:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# -- phase 1 ---------------------------------------------------------------
def phase_device(args) -> dict:
    from anemoi_models_tpu.utils.compile_cache import configure_compile_cache
    from anemoi_models_tpu.utils.device import NVIDIA_SMI_QUERY, device_report, parse_nvidia_smi

    backend = jax.default_backend()
    if backend != "gpu" and not args.rehearse:
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, not the GPU; stopping")
    try:
        smi = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        if not args.rehearse:
            raise
        say(f"nvidia-smi: unavailable ({type(exc).__name__})")
    else:
        for line in smi.stdout.strip().splitlines():
            say(line)
        parse_nvidia_smi(smi.stdout)
    say(f"jax {jax.__version__}  devices {jax.devices()}")
    say(f"compile cache: {configure_compile_cache()}")
    for name in OPTIONAL_IMPORTS:
        try:
            mod = importlib.import_module(name)
        except ImportError:
            say(f"import {name}: missing")
        else:
            say(f"import {name}: {getattr(mod, '__version__', 'present')}")
    return device_report()


# -- shared builders ---------------------------------------------------------
def data_coords(size: dict) -> np.ndarray:
    from anemoi_models_tpu.graphs import octahedral_grid_nodes

    return np.asarray(octahedral_grid_nodes(size["grid"]).coords)


def build_graph(size: dict):
    from anemoi_models_tpu.graphs import build_enc_proc_dec_graph, nodes_from_coords

    return build_enc_proc_dec_graph(
        data_nodes=nodes_from_coords(data_coords(size)), mesh_refinements=size["refinements"]
    )


def build_model(graph, size: dict, flavor: str, dtype: str, graph_impl: str | None = None):
    from anemoi_models_tpu import configs
    from anemoi_models_tpu.data_indices import IndexCollection
    from anemoi_models_tpu.models import AnemoiModelEncProcDec

    cfg = configs.enc_proc_dec(
        forcing=FORCING, diagnostic=DIAGNOSTIC, flavor=flavor,
        num_channels=size["channels"], num_layers=size["layers"], num_heads=size["heads"],
        window_size=size["window"], compute_dtype=dtype, graph_impl=graph_impl,
    )
    if graph_impl:  # the whole model, mappers included
        cfg.model.encoder.graph_impl = cfg.model.decoder.graph_impl = graph_impl
    di = IndexCollection(cfg, {v: i for i, v in enumerate(VARIABLES)})
    model = AnemoiModelEncProcDec(
        model_config=cfg, data_indices=di, graph_data=graph,
        dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32,
    )
    return model, di


def random_batch(graph, di, batch: int, seed: int):
    rs = np.random.RandomState(seed)
    n_grid = graph["data"].num_nodes
    x = jnp.asarray(rs.randn(batch, 2, 1, n_grid, len(di.internal_model.input)), jnp.float32)
    y = jnp.asarray(rs.randn(batch, 1, n_grid, len(di.internal_model.output)), jnp.float32)
    return x, y


# -- phase 2 ---------------------------------------------------------------
def phase_train(args, size: dict, timer: CompileTimer) -> dict:
    from anemoi_models_tpu.training import train_run
    from anemoi_models_tpu.training.dataset import SyntheticSource

    source = SyntheticSource(data_coords(size), num_vars=len(VARIABLES), num_steps=64, seed=args.seed)
    stamps: dict[int, float] = {}

    def log(msg: str) -> None:
        if msg.startswith("step "):
            stamps[int(msg.split()[1])] = time.perf_counter()

    timer.take()
    t0 = time.perf_counter()
    out = train_run(
        source, forcing=FORCING, diagnostic=DIAGNOSTIC, flavor="graphtransformer",
        mesh_refinements=size["refinements"],
        model_kwargs=dict(num_channels=size["channels"], num_layers=size["layers"],
                          num_heads=size["heads"]),
        steps=size["steps"], batch_size=1, seed=args.seed, log_every=1, log=log,
        overlap_calls=False,  # each step's loss is fetched before the next starts
        handle_signals=False,
    )
    wall = time.perf_counter() - t0
    compile_s = timer.take()
    losses = out["losses"]
    check(len(losses) == size["steps"], f"expected {size['steps']} losses, got {len(losses)}")
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    steps = sorted(stamps)
    per_step = [stamps[b] - stamps[a] for a, b in zip(steps, steps[1:])][1:]  # after 2 warm-up steps
    n_grid = out["graph"]["data"].num_nodes
    say(
        f"train: O{size['grid']} grid={n_grid} hidden={out['graph']['hidden'].num_nodes} "
        f"C={size['channels']} L={size['layers']} heads={size['heads']} bf16 B=1 "
        f"steps={len(losses)} losses={[round(v, 5) for v in losses]}"
    )
    say(
        f"train: run wall {wall:.1f} s, compile {compile_s:.1f} s, "
        f"median step {statistics.median(per_step) * 1e3:.1f} ms "
        f"({n_grid / statistics.median(per_step):,.0f} grid-points/s) over {len(per_step)} steps "
        f"(steps 3..{steps[-1]}, each ended by a host fetch of its loss), "
        f"peak_bytes_in_use {peak_bytes()}"
    )
    return out


# -- phase 3 ---------------------------------------------------------------
def phase_forecast(args, size: dict, trained: dict, timer: CompileTimer) -> None:
    iface, graph = trained["interface"], trained["graph"]
    from anemoi_models_tpu.training.dataset import SyntheticSource

    source = SyntheticSource(data_coords(size), num_vars=len(VARIABLES), num_steps=64, seed=args.seed)
    idx = iface.data_indices
    ms = iface.multi_step
    raw = source.window(0, ms + FORECAST_STEPS)[None]
    perm = graph["data"].attrs.get("source_index")
    if perm is not None:
        raw = raw[:, :, np.ascontiguousarray(perm[:, 0]), :]
    data_in = np.asarray(idx.internal_data.input.full)
    forcing_in = np.asarray(idx.internal_model.input.forcing)
    pre = iface.pre_processors(jnp.asarray(raw), in_place=False)
    forcings = jnp.moveaxis(pre[:, ms:, None][..., data_in], 1, 0)[..., forcing_in]
    batch = jnp.asarray(raw[:, :ms][..., data_in])

    forecast = jax.jit(lambda p, b, f: iface.predict_rollout(b, FORECAST_STEPS, f, params=p))
    timer.take()
    preds = jax.block_until_ready(forecast(iface.params, batch, forcings))
    compile_s = timer.take()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        preds = jax.block_until_ready(forecast(iface.params, batch, forcings))
        times.append(time.perf_counter() - t0)
    n_out = len(idx.internal_model.output)
    want = (FORECAST_STEPS, 1, 1, graph["data"].num_nodes, n_out)
    check(tuple(preds.shape) == want, f"forecast shape {preds.shape} != {want}")
    check(bool(jnp.isfinite(preds).all()), "non-finite forecast")
    say(
        f"forecast: predict_rollout {FORECAST_STEPS} steps B=1 shape {tuple(preds.shape)} finite, "
        f"compile {compile_s:.1f} s, {statistics.median(times) / FORECAST_STEPS * 1e3:.1f} ms/step "
        f"(median of 3 forecasts)"
    )


def compile_all(lowered: dict) -> dict:
    """Compile lowered programs at once: XLA's compiler releases the GIL, so
    the programs compile side by side on the host's cores. (Lowering stays
    with the caller: tracing reads the active mesh and matmul precision.)"""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(lowered)) as pool:
        futures = {k: pool.submit(v.compile) for k, v in lowered.items()}
        return {k: f.result() for k, f in futures.items()}


class Stopwatch:
    def __init__(self):
        self.t = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        return dt


# -- phase 4 ---------------------------------------------------------------
def phase_flavors(args, size: dict, graph) -> None:
    import optax

    from anemoi_models_tpu.ops.attention import resolve_attention_impl
    from anemoi_models_tpu.training import make_train_step

    clock = Stopwatch()
    key = jax.random.key(args.seed)
    lowered, runs = {}, {}
    for flavor in ("gnn", "transformer"):
        model, di = build_model(graph, size, flavor, "bfloat16")
        x, y = random_batch(graph, di, 1, args.seed)
        init_state, step = make_train_step(model, optax.adam(1e-4))
        state = jax.eval_shape(init_state, key, x)
        lowered[flavor, "init"] = jax.jit(init_state).lower(key, x)
        lowered[flavor, "forward"] = jax.jit(model.apply).lower(state.params, x)
        lowered[flavor, "step"] = jax.jit(step).lower(state, x, y)
        runs[flavor] = (x, y)
    t_lower = clock.lap()
    compiled = compile_all(lowered)
    t_compile = clock.lap()
    say(f"flavors: traced 6 programs in {t_lower:.1f} s, compiled them side by side in {t_compile:.1f} s")
    for flavor, (x, y) in runs.items():
        state = compiled[flavor, "init"](key, x)
        out = jax.block_until_ready(compiled[flavor, "forward"](state.params, x))
        state, loss = compiled[flavor, "step"](state, x, y)
        loss = float(loss)
        check(bool(jnp.isfinite(out).all()), f"{flavor}: non-finite forward")
        check(np.isfinite(loss), f"{flavor}: non-finite loss {loss}")
        check(all(bool(jnp.isfinite(p).all()) for p in jax.tree_util.tree_leaves(state.params)),
              f"{flavor}: non-finite parameters after the step")
        route = f", attention route {resolve_attention_impl('auto')!r}" if flavor == "transformer" else ""
        say(f"flavor {flavor}: forward {tuple(out.shape)} finite, train-step loss {loss:.5f}{route}")
        del state, out
    del compiled, lowered
    gc.collect()


# -- phase 5 ---------------------------------------------------------------
def phase_references(args, size: dict, graph) -> None:
    from anemoi_models_tpu.checkpoint import _migrate_restore
    from anemoi_models_tpu.ops.attention import _reference_attention, dot_product_attention

    clock = Stopwatch()
    key = jax.random.key(args.seed)
    models = {}
    for dtype in ("float32", "bfloat16"):
        for impl in ("dense", "segment"):
            models[dtype, impl] = build_model(graph, size, "graphtransformer", dtype, impl)[0]
    _, di = build_model(graph, size, "graphtransformer", "float32", "dense")
    x, _ = random_batch(graph, di, 1, args.seed)
    shapes = {impl: jax.eval_shape(models["float32", impl].init, key, x) for impl in ("dense", "segment")}

    n = graph["hidden"].num_nodes
    head_dim = size["channels"] // size["heads"]
    rs = np.random.RandomState(args.seed)
    q, k, v = (jnp.asarray(rs.randn(1, size["heads"], n, head_dim), jnp.bfloat16) for _ in range(3))

    lowered = {"init": jax.jit(models["float32", "dense"].init).lower(key, x)}
    for (dtype, impl), model in models.items():
        if dtype == "float32":
            with jax.default_matmul_precision("highest"):
                lowered[dtype, impl] = jax.jit(model.apply).lower(shapes[impl], x)
        else:
            lowered[dtype, impl] = jax.jit(model.apply).lower(shapes[impl], x)
    lowered["route"] = jax.jit(
        lambda q, k, v: dot_product_attention(q, k, v, window_size=size["window"])
    ).lower(q, k, v)
    with jax.default_matmul_precision("highest"):
        lowered["reference"] = jax.jit(lambda q, k, v: _reference_attention(
            q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32), size["window"], False
        )).lower(q, k, v)
    t_lower = clock.lap()
    compiled = compile_all(lowered)
    t_compile = clock.lap()
    say(f"references: traced {len(lowered)} programs in {t_lower:.1f} s, "
        f"compiled them side by side in {t_compile:.1f} s")

    params = compiled["init"](key, x)
    # the segment path keeps the mapper's source embedding one scope up; the
    # checkpoint migration moves the same arrays there
    p = {"dense": params, "segment": _migrate_restore(params, shapes["segment"])}
    out = {dk: compiled[dk](p[dk[1]], x) for dk in models}
    dense, seg = out["float32", "dense"], out["float32", "segment"]
    err = rel_l2(dense, seg)
    say(f"reference graph: dense vs segment, float32 under 'highest': rel L2 {err:.3e} "
        f"(tolerance {GRAPH_F32_REL_L2:g}), max abs {float(jnp.abs(dense - seg).max()):.3e}")
    check(err <= GRAPH_F32_REL_L2, "dense graph path disagrees with the segment reference")
    dense16, seg16 = out["bfloat16", "dense"], out["bfloat16", "segment"]
    say(f"reference graph: dense vs segment, bf16 at default precision: rel L2 "
        f"{rel_l2(dense16, seg16):.3e} (reported, no bound); each vs float32 dense: "
        f"{rel_l2(dense16, dense):.3e} / {rel_l2(seg16, dense):.3e}")
    del out, p, params, dense, seg, dense16, seg16
    gc.collect()

    route = compiled["route"](q, k, v)
    ref = compiled["reference"](q, k, v)
    max_abs = float(jnp.abs(route.astype(jnp.float32) - ref).max())
    bound = ATTN_BF16_MAX_ABS_REL * float(jnp.abs(ref).max())
    err = rel_l2(route.astype(jnp.float32), ref)
    say(f"reference attention: GPU route vs reference at {n} tokens, {size['heads']} heads, "
        f"head dim {head_dim}, window {size['window']}: bf16 route vs float32 reference under "
        f"'highest': max abs {max_abs:.3e} (tolerance 2^-7 x max|ref| = {bound:.3e}), "
        f"rel L2 {err:.3e} (tolerance {ATTN_BF16_REL_L2:g})")
    check(max_abs <= bound and err <= ATTN_BF16_REL_L2,
          "GPU attention route disagrees with the reference")


# -- four cards ----------------------------------------------------------------
def phase_multichip(args, size: dict) -> None:
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from anemoi_models_tpu.parallel import make_mesh, use_mesh
    from anemoi_models_tpu.training import make_train_step

    check(len(jax.devices()) >= 4, f"--multichip needs 4 devices, found {len(jax.devices())}")
    clock = Stopwatch()
    graph = build_graph(size)
    # depth cut to MULTICHIP_LAYERS: the comparison needs every layer kind,
    # not all eight of them, and four cards are billed by the second
    sized = {**size, "layers": MULTICHIP_LAYERS}
    key = jax.random.key(args.seed)
    opt = optax.adam(1e-4)
    meshes = {"mp": make_mesh(data=1, model=4), "dp": make_mesh(data=4)}

    def shardings(mesh):
        return (NamedSharding(mesh, P()), NamedSharding(mesh, P("data", None, None, "model", None)),
                NamedSharding(mesh, P("data", None, "model", None)))

    cases = {
        # model-parallel: halo-exchange processor over a 4-way model axis
        "mp": dict(dtype="float32", batch=1, precision="highest"),
        # data-parallel: batch 4 over a 4-way data axis, the bf16 preset
        "dp": dict(dtype="bfloat16", batch=4, precision=None),
    }
    lowered, runs = {}, {}
    for name, case in cases.items():
        model, di = build_model(graph, sized, "graphtransformer", case["dtype"])
        x, y = random_batch(graph, di, case["batch"], args.seed)
        init_state, step = make_train_step(model, opt)
        state = jax.eval_shape(init_state, key, x)
        rep, xs, ys = shardings(meshes[name])
        with jax.default_matmul_precision(case["precision"]):
            lowered[name, "init"] = jax.jit(init_state).lower(key, x)
            lowered[name, "step"] = jax.jit(step).lower(state, x, y)
            if name == "mp":
                lowered[name, "forward"] = jax.jit(model.apply).lower(state.params, x)
            with use_mesh(meshes[name]):
                lowered[name, "step4"] = jax.jit(
                    step, in_shardings=(rep, xs, ys), out_shardings=(rep, rep)
                ).lower(state, x, y)
                if name == "mp":
                    lowered[name, "forward4"] = jax.jit(
                        model.apply, in_shardings=(rep, xs)
                    ).lower(state.params, x)
        runs[name] = (x, y, rep, xs, ys)
    t_lower = clock.lap()
    compiled = compile_all(lowered)
    say(f"multichip: traced {len(lowered)} programs in {t_lower:.1f} s, "
        f"compiled them side by side in {clock.lap():.1f} s")

    x, y, rep, xs, ys = runs["mp"]
    state = compiled["mp", "init"](key, x)
    ref_out = compiled["mp", "forward"](state.params, x)
    ref_state, ref_loss = compiled["mp", "step"](state, x, y)
    st4 = jax.device_put(state, rep)
    x4, y4 = jax.device_put(x, xs), jax.device_put(y, ys)
    out = compiled["mp", "forward4"](st4.params, x4)
    new, loss = compiled["mp", "step4"](st4, x4, y4)
    ref_loss, loss = float(ref_loss), float(loss)
    e_out = rel_l2(out, ref_out)
    e_loss = abs(loss - ref_loss) / max(abs(ref_loss), 1e-30)
    e_par = tree_rel_l2(new.params, ref_state.params)
    say(f"multichip model-parallel (data=1, model=4), GraphTransformer C={size['channels']} "
        f"heads={size['heads']} L={MULTICHIP_LAYERS}, O{size['grid']}, float32 under 'highest': "
        f"forward rel L2 {e_out:.3e} (tolerance {MP_F32_REL_L2:g}); train-step loss "
        f"{loss:.6f} vs one card {ref_loss:.6f}, rel {e_loss:.3e} (tolerance {MP_F32_LOSS_REL:g}); "
        f"updated params rel L2 {e_par:.3e} (tolerance {MP_F32_REL_L2:g})")
    check(e_out <= MP_F32_REL_L2 and e_loss <= MP_F32_LOSS_REL and e_par <= MP_F32_REL_L2,
          "model-parallel run disagrees with one card")
    del state, ref_state, new, out, ref_out, st4
    gc.collect()

    x, y, rep, xs, ys = runs["dp"]
    state = compiled["dp", "init"](key, x)
    _, ref_loss = compiled["dp", "step"](state, x, y)
    _, loss = compiled["dp", "step4"](jax.device_put(state, rep), jax.device_put(x, xs),
                                      jax.device_put(y, ys))
    ref_loss, loss = float(ref_loss), float(loss)
    e_loss = abs(loss - ref_loss) / max(abs(ref_loss), 1e-30)
    say(f"multichip data-parallel (data=4), GraphTransformer bf16 L={MULTICHIP_LAYERS}, batch 4: "
        f"loss {loss:.6f} vs one card {ref_loss:.6f}, rel {e_loss:.3e} "
        f"(tolerance {DP_BF16_LOSS_REL:g})")
    check(np.isfinite(loss) and e_loss <= DP_BF16_LOSS_REL, "data-parallel loss disagrees with one card")


def main(argv=None) -> int:
    args = parse_args(argv)
    size = SIZES["rehearse" if args.rehearse else "full"]
    timer = CompileTimer()
    t0 = time.perf_counter()
    device = None
    trained = graph = None
    for name in phases(args):
        t = time.perf_counter()
        if name == "device":
            device = phase_device(args)
        elif name == "train":
            trained = phase_train(args, size, timer)
        elif name == "forecast":
            phase_forecast(args, size, trained, timer)
            graph = trained["graph"]
            trained = None
            gc.collect()
        elif name == "flavors":
            phase_flavors(args, size, graph)
        elif name == "references":
            phase_references(args, size, graph)
        elif name == "multichip":
            phase_multichip(args, size)
        say(f"phase {name}: ok in {time.perf_counter() - t:.1f} s")
    say(f"all phases ok in {time.perf_counter() - t0:.1f} s")
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
