"""A/B timing of the association backends on the device, at real widths.

Layer: one jitted `lax.scan` over T source frames (B lanes vmapped) of the
1-NN step of the association, per variant:
  matmul     dense XLA, |s|^2 + |t|^2 - 2 s.t form (registration.nn_dense)
  diff       dense XLA, (sx - tx)^2 + (sy - ty)^2 form
  kernel_r   Pallas kernel with the association radius (tile skipping)
  kernel_inf Pallas kernel with radius = inf (dense)
and of the attribute lookup at the nearest neighbors, per variant:
  gather     one flat gather (registration._associate_world)
  onehot     one-hot(nn) @ attrs contraction
Every variant is checked against `diff` on the rows the radius keeps.

End to end: the batched odometry step (`parallel.mesh.make_batched_runner`
on a one-device mesh) over T frames of B distinct synthetic sequences at
Oxford geometry, per --e2e-cells entry (preset:K, K active keyframes, 0 for
all) and per --e2e-seeds set of sequences, with the association forced to
each backend.

Cells come from rendered synthetic Oxford frames (400 x 3768, k=40,
max_cells=1024, point_budget=8192, Morton-sorted); keyframe windows use the
ground-truth poses. Every timed region ends in `block_until_ready`; each
time is the median of --repeats runs after one untimed run.

Usage: python tools/assoc_ab.py [--layer-only | --no-layer]
           [--e2e-cells CFEAR-3:0,CFEAR-3-s50:8] [--e2e-seeds 100,200]
           [--out assoc_ab.json]
"""

import argparse
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _timed(fn, *args, repeats=3):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


def _cfg(preset_name, k_active):
    from cfear_jax.config import preset
    cfg = preset(preset_name, dataset="oxford")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=1024,
                                    point_budget=8192, spatial_sort=True),
        registration=dataclasses.replace(cfg.registration,
                                         max_active_keyframes=k_active))


def _cells_and_poses(cfg, seed, n_frames):
    """Cells (n_frames, M, ...) of one rendered sequence + GT poses."""
    import jax
    from cfear_jax.datasets import synthetic
    from cfear_jax.ops import features, filtering
    images, gt = synthetic.make_sequence(seed=seed, n_frames=n_frames,
                                         cfg=cfg, speed=6.0)
    pts = jax.jit(jax.vmap(lambda im: filtering.filter_polar_image(
        im, cfg)))(images)
    cells = jax.jit(lambda p: features.compute_cells_batched(p, cfg))(pts)
    return cells, gt.astype(np.float32)


def _matmul_nn(src_xy, tar_xy, tar_valid):
    """The |s|^2 + |t|^2 - 2 s.t form (the former dense association)."""
    import jax
    import jax.numpy as jnp
    src_n2 = jnp.sum(src_xy ** 2, -1)

    def nn_kf(tmean, cvalid):
        d2 = (src_n2[:, None] + jnp.sum(tmean ** 2, -1)[None, :]
              - 2.0 * src_xy @ tmean.T)
        d2 = jnp.where(cvalid[None, :], d2, jnp.inf)
        return jnp.argmin(d2, axis=1).astype(jnp.int32), jnp.min(d2, axis=1)

    return jax.vmap(nn_kf)(tar_xy, tar_valid)


def layer(args, log):
    import jax
    import jax.numpy as jnp
    from cfear_jax.ops import pallas_assoc, registration
    from cfear_jax.utils import se2

    cfg = _cfg("CFEAR-3", 0)
    t_steps = args.layer_steps
    n_frames = max(args.windows) + t_steps + args.batch_max
    cells, gt = _cells_and_poses(cfg, 1, n_frames)
    radius = cfg.registration.assoc_radius
    rows = _LoggedRows(log)
    for s in args.windows:
        for b in args.batches:
            # lane l, step t: source frame s + t + l against frames
            # [t + l, s + t + l) in the source frame's coordinates
            src_xy, src_v, tar_xy, tar_v, attrs = [], [], [], [], []
            for lane in range(b):
                for t in range(t_steps):
                    f0 = t + lane
                    fs = f0 + s
                    inv = se2.inverse(jnp.asarray(gt[fs]))
                    poses = se2.compose(inv[None], jnp.asarray(gt[f0:fs]))
                    kf = jax.tree.map(lambda a: a[f0:fs], cells)
                    at = registration._world_attrs(kf, poses, cfg)
                    attrs.append(at)
                    tar_xy.append(at[..., 0:2])
                    tar_v.append(at[..., 6] > 0.5)
                    src_xy.append(cells.mean[fs])
                    src_v.append(cells.valid[fs])

            def stack(xs):
                a = jnp.stack(xs)
                return a.reshape((b, t_steps) + a.shape[1:])

            xs = tuple(stack(v) for v in (src_xy, src_v, tar_xy, tar_v,
                                          attrs))
            nn_variants = {
                "matmul": lambda sx, sv, tx, tv: _matmul_nn(sx, tx, tv),
                "diff": lambda sx, sv, tx, tv: registration.nn_dense(
                    sx, tx, tv),
                "kernel_inf": lambda sx, sv, tx, tv: pallas_assoc.nn_min(
                    sx, sv, tx, tv),
                "kernel_r": lambda sx, sv, tx, tv: pallas_assoc.nn_min(
                    sx, sv, tx, tv, radius),
            }
            res = {}
            for name, fn in nn_variants.items():
                @jax.jit
                def run(sx, sv, tx, tv, fn=fn):
                    def lane(sx, sv, tx, tv):
                        return jax.lax.scan(
                            lambda c, x: (c, fn(*x)), 0,
                            (sx, sv, tx, tv))[1]
                    return jax.vmap(lane)(sx, sv, tx, tv)

                out, first, sec = _timed(run, *xs[:4], repeats=args.repeats)
                res[name] = out
                rows.append(dict(layer="nn", variant=name, S=s, B=b,
                                 steps=t_steps, first_s=first,
                                 ms_per_call=sec / t_steps * 1e3))
            ref_nn, ref_d2 = map(np.asarray, res["diff"])
            keep = (ref_d2 <= radius * radius) & np.asarray(xs[1])[:, :, None]
            gap_ok = _tie_mask(xs, ref_d2)
            for name, (nn, d2) in res.items():
                nn, d2 = np.asarray(nn), np.asarray(d2)
                bad = int(np.sum(keep & gap_ok & (nn != ref_nn)))
                rows.append(dict(layer="nn_check", variant=name, S=s, B=b,
                                 nn_mismatch_non_tie=bad,
                                 d2_max_rel=float(np.max(
                                     np.abs(d2[keep] - ref_d2[keep])
                                     / np.maximum(1.0, ref_d2[keep])))))
            nn_ref = jnp.asarray(ref_nn)
            m_tar = xs[4].shape[-2]

            def gather(at, nn):
                s_kf = at.shape[0]
                flat = nn + (jnp.arange(s_kf, dtype=jnp.int32)
                             * m_tar)[:, None]
                return at.reshape(s_kf * m_tar, -1)[flat.reshape(-1)]

            def onehot(at, nn):
                oh = (nn[..., None] == jnp.arange(m_tar, dtype=jnp.int32)
                      ).astype(at.dtype)
                return jnp.einsum("snm,smd->snd", oh, at,
                                  preferred_element_type=at.dtype)

            outs = {}
            for name, fn in (("gather", gather), ("onehot", onehot)):
                @jax.jit
                def run_l(at, nn, fn=fn):
                    def lane(at, nn):
                        return jax.lax.scan(lambda c, x: (c, fn(*x)), 0,
                                            (at, nn))[1]
                    return jax.vmap(lane)(at, nn)

                out, first, sec = _timed(run_l, xs[4], nn_ref,
                                         repeats=args.repeats)
                outs[name] = np.asarray(out).reshape(-1)
                rows.append(dict(layer="lookup", variant=name, S=s, B=b,
                                 steps=t_steps, first_s=first,
                                 ms_per_call=sec / t_steps * 1e3))
            rows.append(dict(layer="lookup_check", S=s, B=b,
                             equal=bool(np.array_equal(outs["gather"],
                                                       outs["onehot"]))))
    return rows


class _LoggedRows(list):
    """A list that logs every row appended to it."""

    def __init__(self, log):
        super().__init__()
        self._log = log

    def append(self, row):
        self._log(row)
        super().append(row)


def _tie_mask(xs, ref_d2):
    """Rows whose best and second-best distance differ by more than
    1e-6 * max(1, d2): only such rows have a unique nearest neighbor."""
    import jax
    import jax.numpy as jnp

    def gap(sx, tx, tv):
        d = sx[None, :, None, :] - tx[:, None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        d2 = jnp.where(tv[:, None, :], d2, jnp.inf)
        two = -jax.lax.top_k(-d2, 2)[0]
        return two[..., 1] - two[..., 0]

    @jax.jit
    def run(sx, tx, tv):
        def lane(sx, tx, tv):
            return jax.lax.scan(lambda c, x: (c, gap(*x)), 0,
                                (sx, tx, tv))[1]
        return jax.vmap(lane)(sx, tx, tv)

    g = np.asarray(run(xs[0], xs[2], xs[3]))
    return g > 1e-6 * np.maximum(1.0, ref_d2)


def end_to_end(args, log):
    import jax
    import jax.numpy as jnp
    from cfear_jax.datasets import synthetic
    from cfear_jax.ops import registration
    from cfear_jax.parallel import mesh as pmesh

    rows = _LoggedRows(log)
    dense_forms = {"matmul": _matmul_nn, "diff": registration.nn_dense}
    for (preset_name, k_active), seed0, b in itertools.product(
            args.e2e_cells, args.e2e_seeds, args.e2e_batches):
        base = _cfg(preset_name, k_active)
        t = args.e2e_frames
        images = np.stack([synthetic.make_sequence(
            seed=seed0 + lane, n_frames=t + 1, cfg=base, speed=6.0)[0]
            for lane in range(b)])
        for variant in args.e2e_variants:
            cfg = base.replace(registration=dataclasses.replace(
                base.registration,
                assoc_method="sparse" if variant == "sparse" else "dense"))
            registration.nn_dense = dense_forms.get(variant,
                                                    dense_forms["diff"])
            runner = pmesh.MultiSequenceRunner(
                cfg, b, mesh=pmesh.make_mesh(1), chunk=t, ingest="host")
            inp = runner._prepare(images)
            first = runner.shard_batch(jax.tree.map(
                lambda x: jnp.asarray(x[:, 0]), inp))
            states, _ = runner.bootstrap_batch(runner.states, first)
            chunk = runner.shard_batch(jax.tree.map(
                lambda x: jnp.asarray(x[:, 1:]), inp))
            out, first_s, sec = _timed(runner.step_chunk, states, chunk,
                                       repeats=args.repeats)
            fo = jax.tree.map(np.asarray, out[1])
            rows.append(dict(layer="e2e", preset=preset_name, K=k_active,
                             variant=variant, B=b, seed0=seed0, frames=t,
                             first_s=first_s, seconds=sec,
                             frames_per_s=b * t / sec,
                             failures=int((~fo.success).sum()),
                             mean_outer_iters=float(
                                 fo.reg_iterations.mean())))
        registration.nn_dense = dense_forms["diff"]
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layer-only", action="store_true")
    ap.add_argument("--windows", default="4,16,50")
    ap.add_argument("--batches", default="1,8")
    ap.add_argument("--layer-steps", type=int, default=16)
    ap.add_argument("--no-layer", action="store_true")
    ap.add_argument("--e2e-batches", default="1,8")
    ap.add_argument("--e2e-variants", default="matmul,diff,sparse")
    ap.add_argument("--e2e-frames", type=int, default=48)
    ap.add_argument("--e2e-cells", default="CFEAR-3:0,CFEAR-3-s50:16,"
                    "CFEAR-3-s50:0", help="preset:K active keyframes "
                    "(0: all), comma-separated")
    ap.add_argument("--e2e-seeds", default="100",
                    help="first seed of each set of B sequences")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="assoc_ab.json")
    args = ap.parse_args(argv)
    args.windows = [int(v) for v in args.windows.split(",")]
    args.batches = [int(v) for v in args.batches.split(",")]
    args.batch_max = max(args.batches)
    args.e2e_batches = [int(v) for v in args.e2e_batches.split(",")]
    args.e2e_variants = args.e2e_variants.split(",")
    args.e2e_cells = [(c.split(":")[0], int(c.split(":")[1]))
                      for c in args.e2e_cells.split(",")]
    args.e2e_seeds = [int(v) for v in args.e2e_seeds.split(",")]

    import jax
    from cfear_jax.utils.runtime import setup_compile_cache
    setup_compile_cache()
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip() if dev.platform == "gpu" else "no GPU"
    header = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()), card=card)
    print(json.dumps(header), flush=True)

    def log(row):
        print(json.dumps(row), flush=True)

    rows = [] if args.no_layer else layer(args, log)
    if not args.layer_only:
        rows += end_to_end(args, log)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(header, rows=rows), f, indent=1)


if __name__ == "__main__":
    main()
