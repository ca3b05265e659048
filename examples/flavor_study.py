"""Fidelity study: do the three processor flavors reach the same skill?

The TransformerProcessor (windowed attention over the RCM-ordered hidden
mesh) is the cheapest processor per layer, but speed only matters if its
forecasts are as good. This study trains all three flavors
with identical data, budget, and optimizer, then scores a held-out
autoregressive rollout against persistence.

Run (CPU, ~10 min per flavor at the default size):
    env PYTHONPATH=$PWD JAX_PLATFORMS=cpu python examples/flavor_study.py

Writes one JSON line per flavor to stdout and a summary table at the end.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(
    flavors=("graphtransformer", "gnn", "transformer"),
    grid_lat: int = 16,
    num_vars: int = 6,
    num_steps_data: int = 400,
    steps: int = 250,
    batch_size: int = 4,
    eval_rollout: int = 6,
    seed: int = 0,
) -> dict:
    from anemoi_models_tpu.graphs import latlon_grid_nodes
    from anemoi_models_tpu.training import train_run
    from anemoi_models_tpu.training.dataset import SyntheticSource

    coords = latlon_grid_nodes(grid_lat).coords
    source = SyntheticSource(coords, num_vars=num_vars, num_steps=num_steps_data, seed=seed)

    results = {}
    for flavor in flavors:
        t0 = time.perf_counter()
        out = train_run(
            source,
            forcing=("var_0",),
            flavor=flavor,
            mesh_refinements=2,
            model_kwargs=dict(num_channels=64, num_layers=4, num_heads=4, num_chunks=1),
            steps=steps,
            batch_size=batch_size,
            peak_lr=2e-3,
            eval_every=steps,  # one eval, at the end
            eval_rollout=eval_rollout,
            seed=seed,
            log=lambda s: None,
        )
        ev = out["eval"][-1]
        row = {
            "flavor": flavor,
            "final_loss": out["losses"][-1],
            "eval_rmse": ev["rmse_mean"],
            "skill_vs_persistence": ev["skill_mean"],
            "rmse_per_step": [float(np.mean(r)) for r in np.asarray(ev["rmse"])],
            "train_wall_s": round(time.perf_counter() - t0, 1),
        }
        results[flavor] = row
        print(json.dumps(row), flush=True)

    print(f"\n{'flavor':<18} {'loss':>8} {'rollout rmse':>13} {'skill':>7} {'wall s':>8}")
    for f, r in results.items():
        print(
            f"{f:<18} {r['final_loss']:>8.4f} {r['eval_rmse']:>13.4f} "
            f"{r['skill_vs_persistence']:>+7.3f} {r['train_wall_s']:>8.1f}"
        )
    return results


if __name__ == "__main__":
    main()
