"""Multi-session SLAM merge CLI.

Merges N >= 2 sessions' `simple_graph.npz` artifacts (as written by
`offline_odometry --save-graph`; the reference's `.sgh` hand-off to
TBV-SLAM, `types.h:192-196`, `README.md:150-152`) into one jointly
optimized graph. Sessions are folded in INCREMENTALLY: session k+1 is
ring-key matched and registration-verified against the whole joint graph
built so far, consensus-aligned, and appended with inter-session
LOOP_APPEARANCE edges (`models/multisession.py`); a session without
consensus overlap refuses to merge.

Usage:
  python -m cfear_jax.merge_sessions \
      a/simple_graph.npz b/simple_graph.npz [c/simple_graph.npz ...] \
      --out merged_graph.npz [--preset CFEAR-3] [--dataset synthetic]
      [--tum merged.tum] [--cpu]

Writes the merged graph npz (optimized node poses; each session's nodes
follow the previous sessions') and optionally a TUM-format pose file of
the merged trajectory.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="merge N CFEAR session graphs into one frame")
    ap.add_argument("graphs", nargs="+",
                    help="two or more simple_graph.npz session artifacts")
    ap.add_argument("--out", default="merged_graph.npz")
    ap.add_argument("--preset", default="CFEAR-3")
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--max-cells", type=int, default=0,
                    help="cell budget for verification registrations "
                         "(0 = preset value)")
    ap.add_argument("--tum", default=None,
                    help="also write the merged trajectory in TUM format")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if len(args.graphs) < 2:
        ap.error("need at least two session graphs")

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from cfear_jax.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import dataclasses
    from cfear_jax.config import preset
    from cfear_jax.models import (multisession,
                                                            posegraph)

    cfg = preset(args.preset, dataset=args.dataset)
    if args.max_cells:
        cfg = cfg.replace(feature=dataclasses.replace(
            cfg.feature, max_cells=args.max_cells))
    gbs = [posegraph.GraphBuilder.load(p) for p in args.graphs]
    for p, gb in zip(args.graphs, gbs):
        print(f"session {p}: {len(gb.poses)} nodes, "
              f"{gb.n_constraints(posegraph.ODOMETRY)} odometry edges",
              flush=True)

    opt, joint, merges, offsets = multisession.merge_many(
        gbs, cfg, iters=args.iters)
    n_cross_total = 0
    last_t_ab = None
    for m in merges:
        t_ab = m["t_ab"]
        n_cross_total += len(m["inliers"])
        last_t_ab = t_ab
        print(f"merged session {m['session']}: {len(m['inliers'])} "
              f"cross-session edges, T = [{t_ab[0]:.2f} m, {t_ab[1]:.2f} m, "
              f"{np.degrees(t_ab[2]):.1f} deg]")

    for k in range(len(joint.poses)):
        joint.poses[k] = opt[k]
    joint.save(args.out)
    print(f"wrote {args.out} ({len(joint.poses)} nodes, "
          f"{len(joint.edges)} edges)")
    if args.tum:
        with open(args.tum, "w") as f:
            for k, p in enumerate(joint.poses):
                qz = np.sin(p[2] / 2.0)
                qw = np.cos(p[2] / 2.0)
                f.write(f"{joint.stamps[k]:.6f} {p[0]:.6f} {p[1]:.6f} "
                        f"0.000000 0.000000 0.000000 {qz:.6f} {qw:.6f}\n")
        print(f"wrote {args.tum}")
    return dict(n_nodes=len(joint.poses), n_cross=n_cross_total,
                n_sessions=len(gbs),
                t_ab=[float(x) for x in last_t_ab],
                offsets=[int(o) for o in offsets])


if __name__ == "__main__":
    main()
