"""Simulator-parameter sensitivity sweep — the simulator-overfit guard.

VERDICT r3 demand #6: the all-synthetic accuracy story needs a defense that
the headline drift isn't tuned to the simulator's own defaults. This sweep
holds the PIPELINE config fixed (CFEAR-3, bench-style budgets) and turns
each SIMULATOR knob away from its default — wall density, texture
contrast, speckle scale, scatterer count, dynamic objects, azimuth
(encoder) jitter, receiver saturation, multipath ghosts — asserting drift
degrades SMOOTHLY (no cliff) across the envelope.

Writes `eval_results/sim_sensitivity.csv`; `tests/test_sim_sensitivity.py`
asserts the trends on the committed artifact.

Usage: python tools/run_sim_sensitivity.py [--n-frames 128] [--seeds 11,12]
"""

import argparse
import csv
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

#: knob -> list of (label, make_sequence overrides); the first level of
#: each knob is the default world (the shared baseline row is run once).
#: Levels span PLAUSIBLE sensor/world variation — the engine must degrade
#: smoothly across them (asserted by tests/test_sim_sensitivity.py).
KNOBS = {
    "wall_density": [("walls_9", dict(n_walls=9)),
                     ("walls_36", dict(n_walls=36))],
    "texture_contrast": [("gamma_1.0", dict(texture_gamma=1.0)),
                         ("gamma_4.0", dict(texture_gamma=4.0))],
    "speckle_scale": [("noise_14", dict(noise_scale=14.0)),
                      ("noise_16", dict(noise_scale=16.0))],
    "scatterers": [("scat_120", dict(n_scatterers=120)),
                   ("scat_800", dict(n_scatterers=800))],
    "dynamic_objects": [("dyn_20", dict(n_dynamic=20)),
                        ("dyn_40", dict(n_dynamic=40))],
    "azimuth_jitter": [("jit_1mrad", dict(azimuth_jitter_rad=1e-3)),
                       ("jit_3mrad", dict(azimuth_jitter_rad=3e-3))],
    "saturation": [("sat_3m", dict(saturation_m=3.0)),
                   ("sat_5m", dict(saturation_m=5.0))],
    "multipath": [("mp_0.15", dict(multipath_gain=0.15)),
                  ("mp_0.3", dict(multipath_gain=0.3))],
}

#: documented FAILURE REGIMES beyond the envelope (rows are recorded with
#: knob="beyond_envelope" and excluded from the no-cliff assertions).
#: Measured cliffs (r4 calibration): a noise floor >= ~1.67x nominal
#: drowns the FIXED z_min=60 detector, seed-dependently from 20 (the
#: standard mitigation is recalibrating z_min to the sensor's floor —
#: the reference exposes the same per-dataset config);
#: receiver saturation past ~2x the min-distance gate injects
#: sensor-static false structure registration can lock onto; <=60
#: scatterers starve feature-poor worlds seed-dependently.
BEYOND = [
    ("noise_20", dict(noise_scale=20.0)),
    ("noise_24", dict(noise_scale=24.0)),
    ("sat_8m", dict(saturation_m=8.0)),
    ("scat_60", dict(n_scatterers=60)),
]

#: the adaptive-threshold mitigation (`filter.z_min_quantile=0.98`,
#: tests/test_adaptive_zmin.py) applied to the noise-floor cliffs: the
#: SAME worlds that collapse with the fixed z_min=60 detector track at
#: ordinary drift when the threshold rides the measured floor — up to
#: ~2x the nominal floor. At 3x (noise_36, SNR ~ 1) even the adaptive
#: detector fails (the threshold rides above much of the genuine signal);
#: that row stays under beyond_envelope WITH the flag on, pinning the
#: physical edge rather than the detector's.
MITIGATED = [
    ("noise_20_q98", dict(noise_scale=20.0)),
    ("noise_24_q98", dict(noise_scale=24.0)),
]
BEYOND_MITIGATED = [
    ("noise_36_q98", dict(noise_scale=36.0)),
]


def main(argv=None):
    import jax
    # CPU unless the caller exported JAX_PLATFORMS (set at import above)
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    from cfear_jax.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import numpy as np
    from cfear_jax.config import preset
    from cfear_jax.datasets import synthetic
    from cfear_jax.models import odometry
    from cfear_jax.eval.kitti import kitti_drift
    from cfear_jax.eval.trajectory import ate_rmse

    ap = argparse.ArgumentParser()
    ap.add_argument("--n-frames", type=int, default=128)
    ap.add_argument("--speed", type=float, default=12.0)
    ap.add_argument("--seeds", default="11,12")
    ap.add_argument("--max-cells", type=int, default=1024)
    ap.add_argument("--out", default="eval_results/sim_sensitivity.csv")
    ap.add_argument("--knobs", default=",".join(KNOBS))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]

    cfg = preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=args.max_cells))

    def run(seed, overrides, cfg_filter=None):
        c = cfg if not cfg_filter else cfg.replace(
            filter=dataclasses.replace(cfg.filter, **cfg_filter))
        images, gt = synthetic.make_sequence(
            seed=seed, n_frames=args.n_frames, cfg=c, speed=args.speed,
            **overrides)
        runner = odometry.OdometryRunner(c, chunk=16)
        runner.process(images)
        traj = np.asarray(runner.trajectory())
        gt = np.asarray(gt)
        path = float(np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0),
                                           axis=1)))
        lengths = tuple(L for L in (50.0, 100.0, 200.0)
                        if L < 0.6 * path)
        d = kitti_drift(traj, gt, lengths=lengths)
        fails = int((~np.asarray(runner.frame_outputs().success)).sum())
        return dict(t_err_percent=round(d["t_err_percent"], 4),
                    r_err_deg_per_m=round(d["r_err_deg_per_m"], 5),
                    ate_m=round(float(ate_rmse(traj[:, :2], gt[:, :2])), 4),
                    registration_failures=fails)

    rows = []
    for seed in seeds:
        t0 = time.time()
        base = run(seed, {})
        rows.append(dict(knob="baseline", level="default", seed=seed,
                         **base))
        print(f"seed {seed} baseline: {base} ({time.time() - t0:.0f}s)",
              flush=True)
        for knob in args.knobs.split(","):
            for label, ov in KNOBS[knob]:
                t0 = time.time()
                r = run(seed, ov)
                rows.append(dict(knob=knob, level=label, seed=seed, **r))
                print(f"seed {seed} {knob}/{label}: {r} "
                      f"({time.time() - t0:.0f}s)", flush=True)
        for label, ov in BEYOND:
            t0 = time.time()
            r = run(seed, ov)
            rows.append(dict(knob="beyond_envelope", level=label, seed=seed,
                             **r))
            print(f"seed {seed} beyond_envelope/{label}: {r} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        for label, ov in MITIGATED:
            t0 = time.time()
            r = run(seed, ov, cfg_filter=dict(z_min_quantile=0.98))
            rows.append(dict(knob="mitigated", level=label, seed=seed, **r))
            print(f"seed {seed} mitigated/{label}: {r} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        for label, ov in BEYOND_MITIGATED:
            t0 = time.time()
            r = run(seed, ov, cfg_filter=dict(z_min_quantile=0.98))
            rows.append(dict(knob="beyond_envelope", level=label, seed=seed,
                             **r))
            print(f"seed {seed} beyond_envelope/{label}: {r} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
