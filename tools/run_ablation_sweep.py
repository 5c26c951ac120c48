"""Run the full reference ablation sweep on the adversarial synthetic world.

The reference evaluates ablations by fanning `offline_odometry` runs over
bash workers and merging `pars.txt` + `result.txt` into one CSV
(`launch/oxford/eval/1..10_*` + `merge_eval.py`). This driver runs the same
9 grids (`parallel/sweep.py:ABLATIONS`) over several seeds of a hardened
synthetic sequence (moving objects, azimuth dropout, interference bursts at
12 m/s — the regime where parameter choices measurably separate; see
`eval_results/ablation_sweep.csv` + `tests/test_ablation_trends.py`).

Usage:
    python tools/run_ablation_sweep.py --output-root /tmp/sweep \
        --csv eval_results/ablation_sweep.csv [--grids filter,resolution]
        [--seeds 11,12,13] [--n-frames 150]

Runs on CPU (each job is an independent in-process `offline_odometry.main`
call; the jit cache is shared across jobs with identical shapes).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main(argv=None):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from cfear_jax.parallel import sweep

    ap = argparse.ArgumentParser()
    ap.add_argument("--output-root", default="/tmp/cfear_sweep")
    ap.add_argument("--csv", default="eval_results/ablation_sweep.csv")
    ap.add_argument("--grids", default=",".join(sweep.ABLATIONS))
    ap.add_argument("--seeds", default="11,12,13")
    ap.add_argument("--n-frames", type=int, default=150)
    ap.add_argument("--speed", type=float, default=12.0)
    ap.add_argument("--max-cells", type=int, default=1024,
                    help="cell budget for sweep jobs (1024: the calibrated "
                         "trend regime, ~3x faster per CPU job than 3072)")
    ap.add_argument("--n-workers", type=int, default=1)
    ap.add_argument("--worker-index", type=int, default=0)
    args = ap.parse_args(argv)

    base = ["--dataset", "synthetic", "--cpu",
            "--n-frames", str(args.n_frames),
            "--speed", str(args.speed),
            "--n-dynamic", "40", "--dropout-prob", "0.5",
            "--speckle-burst-prob", "0.4",
            "--max_cells", str(args.max_cells),
            "--chunk", "25", "--no-save-graph"]
    t0 = time.time()
    n_jobs = 0
    for grid_name in args.grids.split(","):
        grid = sweep.ABLATIONS[grid_name]
        for seed in args.seeds.split(","):
            root = os.path.join(args.output_root, grid_name, f"seed_{seed}")
            print(f"[sweep] grid={grid_name} seed={seed} "
                  f"({len(sweep.expand_grid(grid))} jobs, "
                  f"{time.time() - t0:.0f}s elapsed)", flush=True)
            sweep.run_sweep(root, grid, base + ["--seed", seed],
                            n_workers=args.n_workers,
                            worker_index=args.worker_index)
            n_jobs += len(sweep.expand_grid(grid))
    os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
    n = sweep.merge(args.output_root, args.csv)
    print(f"[sweep] merged {n} rows -> {args.csv} "
          f"({n_jobs} jobs, {time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
