"""GPU cost of the ensemble (CRPS) train step — the AIFS-CRPS recipe.

Runs ``train_run(loss="crps", ensemble=M)`` at the flagship O96 scale
(GraphTransformer, C=256, L=8, bf16 compute) through the full pipeline and
reports steady-state steps/s, so the CRPS fine-tuning recipe
(examples/ensemble_study.py) has a hardware cost per step
rather than only a CPU toy-scale study.

Run on the GPU:  python examples/ensemble_onchip.py
Env: MEMBERS (4), STEPS (12), STEPS_PER_CALL (1), GRID_LAT (96),
CHANNELS (256), LAYERS (8).
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    from anemoi_models_tpu.graphs import octahedral_grid_nodes
    from anemoi_models_tpu.training import train_run
    from anemoi_models_tpu.training.dataset import SyntheticSource

    print("devices:", jax.devices(), flush=True)
    grid_lat = int(os.environ.get("GRID_LAT", 96))
    coords = octahedral_grid_nodes(grid_lat).coords
    members = int(os.environ.get("MEMBERS", 4))
    print(f"grid: {len(coords)} points, ensemble={members}", flush=True)
    source = SyntheticSource(coords, num_vars=8, num_steps=16, seed=0)

    steps = int(os.environ.get("STEPS", 12))
    t0 = time.perf_counter()
    train_run(
        source,
        forcing=("var_0",),
        flavor=os.environ.get("FLAVOR", "graphtransformer"),
        mesh_refinements=5,
        model_kwargs=dict(
            num_channels=int(os.environ.get("CHANNELS", 256)),
            num_layers=int(os.environ.get("LAYERS", 8)),
            num_heads=16,
            num_chunks=2,
        ),
        loss="crps",
        ensemble=members,
        perturb_sigma=0.05,
        steps=steps,
        batch_size=1,
        peak_lr=3e-4,
        steps_per_call=int(os.environ.get("STEPS_PER_CALL", 1)),
        seed=0,
        log_every=int(os.environ.get("LOG_EVERY", 2)),
        log=lambda s: print(s, flush=True),
    )
    wall = time.perf_counter() - t0
    print(f"total wall {wall:.1f}s for {steps} CRPS steps "
          f"({members} members, incl. graph build + compile)")


if __name__ == "__main__":
    main()
