"""Benchmark: grid-points/s/chip for the flagship GraphTransformer enc-proc-dec.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "device": ...,
"gpu": ..., "power_limit": ...}.

Config: O96 — octahedral data grid (40,320 points), icosahedral hidden mesh
at refinement 5 (10,242 nodes), 256 channels, 8 processor layers. Runs on
the GPU and refuses any other backend.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# Published peaks for roofline placement, keyed by ``device_kind``:
# (dense bf16 FLOP/s, HBM bytes/s). NVIDIA H100 data sheet, without
# sparsity, at the full power limit (700 W SXM, 350 W PCIe); a card set
# below it cannot hold these rates, so every result names its power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),  # SXM5
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
}


def device_peaks(kind: str) -> tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) of ``kind``; an unknown device is an error."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add it to bench.PEAKS "
            f"(known: {sorted(PEAKS)})"
        ) from None


def _chain_cost(run, params, x):
    """(flops, hbm_bytes) of a compiled chain.

    FLOPs from XLA's cost analysis (reliable — it counts the executed dots).
    HBM bytes from the OPTIMIZED module via ``utils.hlo_bytes``, whose
    parser was written for another backend's HLO and is not validated
    against GPU HLO — the roofline share it yields is a rough placement."""
    from anemoi_models_tpu.utils.hlo_bytes import hbm_bytes

    compiled = run.lower(params, x).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    flops = float((ca or {}).get("flops", 0.0))
    nbytes = float(hbm_bytes(compiled.as_text()))
    return (flops, nbytes) if flops > 0 and nbytes > 0 else None


def _measured_copy_bw(x_dtype="bfloat16", gib=0.5, iters=8):
    """Achievable HBM bandwidth this session (chain-subtraction, read+write
    stream) — the cross-check denominator when the spec peak looks off."""
    import jax
    import jax.numpy as jnp

    n = int(gib * 2**30 // 2)
    x = jnp.zeros((n,), jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32)

    def chain(k):
        @jax.jit
        def run(x):
            # barrier between links: without it XLA fuses the whole chain
            # into ONE read+write loop fusion (k-invariant traffic) and the
            # subtraction measures pure noise — observed as a "bandwidth"
            # 10^7x over spec. With the barrier each link streams HBM once.
            one = jnp.ones((), x.dtype)
            for _ in range(k):
                x = jax.lax.optimization_barrier(x + one)
            return x

        float(run(x)[0])
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(run(x)[0])
            best = min(best, time.perf_counter() - t0)
        return best

    dt = max(chain(1 + iters) - chain(1), 1e-9) / iters
    return 2.0 * x.nbytes / dt  # one read + one write per link


def _measure_model(model, x, n_out, mode: str, iters: int, batch: int, peaks=None):
    """K-chain subtraction timing for one built model.

    Returns ``(grid-points/s, roofline_frac | None)``. The roofline fraction
    places the measured per-forward device time against the compiler's own
    cost model at the card's peak specs — ``max(flops/peak_flops,
    bytes/peak_bw) / measured``; ``peaks=None`` skips it.
    """
    import jax

    params = jax.jit(model.init)(jax.random.key(0), x)

    def make_chain(k):
        # k steps unrolled in ONE program, each folded back into the input
        # through a numerically negligible (but not constant-foldable) term:
        # a true dependency chain that async runtimes cannot overlap or elide
        if mode == "train":
            import jax.numpy as jnp
            import optax

            from anemoi_models_tpu.training import make_train_step
            from anemoi_models_tpu.training.step import TrainState

            opt = optax.adam(1e-4)
            _, train_step = make_train_step(model, opt)
            y_t = jnp.zeros((x.shape[0], x.shape[2], x.shape[3], n_out), jnp.float32)

            @jax.jit
            def run(params, x):
                state = TrainState(
                    params=params, opt_state=opt.init(params), step=jnp.zeros((), jnp.int32)
                )
                for _ in range(k):
                    state, loss = train_step(state, x, y_t)
                    x = x + (loss * 1e-30).astype(x.dtype)
                return x

            return run

        @jax.jit
        def run(params, x):
            for _ in range(k):
                out = model.apply(params, x)
                x = x + (out.mean() * 1e-30).astype(x.dtype)
            return x

        return run

    chains = {}

    def timed(k, repeats=3):
        print(f"bench: compiling {k}-forward chain...", file=sys.stderr, flush=True)
        run = chains.setdefault(k, make_chain(k))
        float(run(params, x).mean())  # compile + warmup, forced to completion
        print(f"bench: timing {k}-forward chain", file=sys.stderr, flush=True)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(run(params, x).mean())  # fetch forces real completion
            best = min(best, time.perf_counter() - t0)
        return best

    # subtracting the 1-forward program time cancels fixed dispatch/transfer
    # overhead, leaving per-forward device time
    t1 = timed(1)
    tk = timed(1 + iters)
    dt = max(tk - t1, 1e-9)
    gps = batch * x.shape[3] * iters / dt

    roof = None
    if peaks is not None:
        try:
            c1 = _chain_cost(chains[1], params, x)
            ck = _chain_cost(chains[1 + iters], params, x)
            if c1 and ck:
                t_fwd = dt / iters
                flops = (ck[0] - c1[0]) / iters
                nbytes = (ck[1] - c1[1]) / iters
                t_roof = max(flops / peaks[0], nbytes / peaks[1])
                frac = t_roof / t_fwd
                roof = {
                    "roofline_frac": round(frac, 4),
                    "mfu_frac": round(flops / t_fwd / peaks[0], 4),
                    "hbm_frac": round(nbytes / t_fwd / peaks[1], 4),
                }
                print(
                    f"bench: per-fwd cost {flops / 1e9:.0f} GFLOP / "
                    f"{nbytes / 2**30:.2f} GiB HBM (post-fusion) -> roofline "
                    f"{t_roof * 1e3:.1f} ms, measured {t_fwd * 1e3:.1f} ms "
                    f"({frac:.0%} of roofline; MFU {roof['mfu_frac']:.1%}, "
                    f"HBM {roof['hbm_frac']:.0%})",
                    file=sys.stderr, flush=True,
                )
                if frac > 1.05:
                    # >100% of roofline is physically impossible: either the
                    # byte model undercounts or the spec peaks mismatch the
                    # actual chip. Cross-check against the bandwidth this
                    # session actually delivers and report the honest frac.
                    bw = _measured_copy_bw()
                    t_roof_m = max(flops / peaks[0], nbytes / bw)
                    frac_m = t_roof_m / t_fwd
                    roof["bw_measured_gbs"] = round(bw / 1e9, 1)
                    roof["roofline_frac_measured_bw"] = round(frac_m, 4)
                    print(
                        f"bench: WARNING roofline_frac {frac:.2f} > 1.05; "
                        f"measured copy BW {bw / 1e9:.0f} GB/s -> "
                        f"{frac_m:.0%} against delivered bandwidth",
                        file=sys.stderr, flush=True,
                    )
                    assert not os.environ.get("BENCH_STRICT"), (
                        f"roofline_frac {frac:.2f} > 1.05 (BENCH_STRICT)"
                    )
        except Exception as exc:  # noqa: BLE001 — roofline is best-effort
            print(f"bench: roofline unavailable ({type(exc).__name__}: {exc})",
                  file=sys.stderr)
    return gps, roof


def main() -> None:
    import jax

    from anemoi_models_tpu.utils.compile_cache import configure_compile_cache
    from anemoi_models_tpu.utils.device import device_report, gpu_name_and_power_limit

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: backend is {dev.platform!r}, not the GPU; refusing to time it")
    peaks = device_peaks(dev.device_kind)
    gpu_name, power_limit = gpu_name_and_power_limit()

    from __graft_entry__ import _build

    grid_lat = int(os.environ.get("BENCH_GRID_LAT", "96"))
    refinements = int(os.environ.get("BENCH_REFINEMENTS", "5"))
    channels = int(os.environ.get("BENCH_CHANNELS", "256"))
    layers = int(os.environ.get("BENCH_LAYERS", "8"))
    # 4 chained iters: the marginal per-forward time converges with chain
    # length (short chains read optimistic)
    iters = int(os.environ.get("BENCH_ITERS", "4"))
    dtype = os.environ.get("BENCH_DTYPE", "bfloat16")
    mode = os.environ.get("BENCH_MODE", "forward")  # forward | train
    # true O96 octahedral grid by default (40,320 points, uniform density);
    # BENCH_GRID=latlon selects the smaller equal-angle workload
    grid = os.environ.get("BENCH_GRID", "octahedral")
    batch = int(os.environ.get("BENCH_BATCH", "1"))
    remat = os.environ.get("BENCH_REMAT", "full")  # full | save_dots | none
    flavor = os.environ.get("BENCH_FLAVOR", "graphtransformer")  # | gnn | transformer
    graph_impl = os.environ.get("BENCH_GRAPH_IMPL") or None  # dense (default) | segment
    data_order = os.environ.get("BENCH_DATA_ORDER", "rows")
    attention_impl = os.environ.get("BENCH_ATTN_IMPL") or None  # chunked | reference
    extra = {"device": device_report(), "gpu": gpu_name, "power_limit": power_limit}

    # BENCH_MODEL=hierarchical benches the mesh-pyramid model instead of the
    # flat enc-proc-dec (BENCH_LEVELS pyramid depth)
    bench_model = os.environ.get("BENCH_MODEL", "encprocdec")
    if bench_model == "hierarchical":
        from __graft_entry__ import _build_hierarchical

        levels = int(os.environ.get("BENCH_LEVELS", "3"))
        model, x, n_out = _build_hierarchical(
            grid_lat=grid_lat, mesh_refinements=refinements, num_levels=levels,
            num_channels=channels, num_layers=layers, dtype=dtype, grid=grid,
            remat_policy=remat, batch_size=batch, graph_impl=graph_impl,
        )
        gps, roof = _measure_model(model, x, n_out, mode, iters, batch, peaks)
        print(
            json.dumps(
                {
                    "metric": f"hierarchical[{levels}-level{'/' + graph_impl if graph_impl else ''}] "
                    f"{'train-step' if mode == 'train' else 'fwd'} grid-points/s/chip "
                    f"({'O' + str(grid_lat) if grid == 'octahedral' else 'latlon'}"
                    f" grid={x.shape[3]}, B={batch}, mesh_r{refinements}, C={channels}, {dtype})",
                    "value": round(gps, 1),
                    "unit": "grid-points/s",
                    **(roof or {}),
                    **extra,
                }
            )
        )
        return

    model, x, n_out = _build(
        grid_lat=grid_lat,
        mesh_refinements=refinements,
        num_channels=channels,
        num_layers=layers,
        dtype=dtype,
        grid=grid,
        remat_policy=remat,
        flavor=flavor,
        batch_size=batch,
        graph_impl=graph_impl,
        attention_impl=attention_impl,
        data_order=data_order,
    )
    gps, roof = _measure_model(model, x, n_out, mode, iters, batch, peaks)
    print(
        json.dumps(
            {
                "metric": f"enc-proc-dec[{flavor}{'/' + graph_impl if graph_impl else ''}{'/' + attention_impl if attention_impl else ''}] {'train-step' if mode == 'train' else 'fwd'} "
                f"grid-points/s/chip ({'O' + str(grid_lat) if grid == 'octahedral' else 'latlon'}"
                f" grid={x.shape[3]}, B={batch}, mesh_r{refinements}, C={channels}, L={layers}, {dtype})",
                "value": round(gps, 1),
                "unit": "grid-points/s",
                **(roof or {}),
                **extra,
            }
        )
    )


if __name__ == "__main__":
    main()
