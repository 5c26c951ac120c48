"""Device-mesh utilities and batched multi-sequence odometry.

The reference parallelizes evaluation with a bash process fleet — independent
`offline_odometry` processes per (sequence, config) job
(`launch/oxford/eval/utils/{start_workers,worker}`; SURVEY.md §2.3). The
equivalent here is data parallelism over a `jax.sharding.Mesh`: a batch
of sequences (or segments of one long sequence) is sharded across devices on a
`data` axis and stepped in lockstep under one jit — odometry is serial in
time per sequence, so cross-device scale comes from many sequences, per-device
speed from the fixed-shape per-frame kernels.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cfear_jax.config import CFEARConfig
from cfear_jax.models import odometry


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_batched_runner(cfg: CFEARConfig, mesh: Mesh, axis: str = "data",
                        ingest: str = "image"):
    """Build (init_fn, step_chunk_fn) for a sharded batch of sequences.

    States and frame chunks carry a leading batch axis sharded over `axis`;
    each call scans a chunk of frames for every sequence in the batch. The
    per-frame work runs as `make_batched_step` under `shard_map`: each device
    scans its local sub-batch with the hand-batched feature stage (one
    lane-offset scatter for all local lanes — XLA serializes vmapped
    scatters, and GSPMD cannot prove the flattened segment ids are
    shard-local, so explicit shard_map is both the fastest and the only
    partitioning that stays collective-free). `ingest="candidates"` consumes
    host-filtered candidate sets (`native_io.filter_frames_host`).
    """
    import functools
    try:
        from jax import shard_map as _sm       # jax >= 0.8 (check_vma kw)
        shard_map = functools.partial(_sm, check_vma=False)
    except ImportError:                        # pragma: no cover
        from jax.experimental.shard_map import shard_map as _sm
        shard_map = functools.partial(_sm, check_rep=False)

    stepb = odometry.make_batched_step(cfg, ingest)
    bootstrap = odometry.make_bootstrap(cfg, ingest)

    def shard_batch(tree):
        return jax.tree.map(
            lambda a: jax.device_put(
                a, NamedSharding(mesh, P(*( (axis,) + (None,) * (a.ndim - 1))))),
            tree)

    def init_fn(batch: int) -> odometry.OdometryState:
        states = jax.vmap(lambda _: odometry.init_state(cfg))(jnp.arange(batch))
        return shard_batch(states)

    @jax.jit
    def bootstrap_batch(states, first_images):
        """(B, ...) states + (B, A, R) first frames -> initialized states."""
        return jax.vmap(bootstrap)(states, first_images)

    def _chunk_local(states, xs):
        """Per-shard: scan the local sub-batch over the chunk's frames."""
        return jax.lax.scan(stepb, states, xs)

    chunk_sharded = shard_map(
        _chunk_local, mesh=mesh,
        in_specs=(P(axis), P(None, axis)),
        out_specs=(P(axis), P(None, axis)))

    @jax.jit
    def step_chunk(states, images):
        """states: (B, ...) sharded; images: (B, T, A, R) -> outputs (B, T, ...)."""
        xs = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), images)
        states, out = chunk_sharded(states, xs)
        return states, jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), out)

    return init_fn, step_chunk, shard_batch, bootstrap_batch


class MultiSequenceRunner:
    """Host driver for a sharded batch of sequences (the "fleet")."""

    def __init__(self, cfg: CFEARConfig, batch: int, mesh: Optional[Mesh] = None,
                 chunk: int = 16, ingest: str = "image"):
        self.cfg = cfg
        self.chunk = chunk
        self.ingest = ingest
        self.mesh = mesh or make_mesh()
        kind = "image"
        if ingest == "host":
            kind = ("compact" if cfg.filter.method != "cacfar"
                    and cfg.feature.point_budget else "candidates")
        (self.init_fn, self.step_chunk, self.shard_batch,
         self.bootstrap_batch) = make_batched_runner(cfg, self.mesh,
                                                     ingest=kind)
        self.states = self.init_fn(batch)
        self.outputs: list = []

    def _prepare(self, images: np.ndarray):
        """(B, T, A, R) raw frames -> per-frame device inputs."""
        if self.ingest != "host":
            return images
        from cfear_jax.ops.filtering import (
            Candidates, CompactCandidates)
        from cfear_jax.utils import native_io
        f = self.cfg.filter
        b, t = images.shape[:2]
        flat = images.reshape((-1,) + images.shape[2:])
        if f.method == "cacfar":
            bi, it, pk = native_io.cfar_filter_frames_host(flat, self.cfg)
        elif self.cfg.feature.point_budget:
            import math
            radar = self.cfg.radar
            min_bin = int(math.ceil(radar.min_distance / radar.range_res))
            bi, az, it, pk = native_io.filter_frames_host_compact(
                flat, f.k_strongest, f.z_min, f.nms_window,
                self.cfg.feature.point_budget, min_bin,
                z_quantile=f.z_min_quantile)
            shp = (b, t) + bi.shape[1:]
            return CompactCandidates(
                bins=bi.reshape(shp), azimuth=az.reshape(shp),
                intensity=it.reshape(shp), peak=pk.reshape(shp))
        else:
            bi, it, pk = native_io.filter_frames_host(
                flat, f.k_strongest, f.z_min, f.nms_window,
                z_quantile=f.z_min_quantile)
        shp = (b, t) + bi.shape[1:]
        return Candidates(bins=bi.reshape(shp), intensity=it.reshape(shp),
                          peak=pk.reshape(shp))

    def process(self, images: np.ndarray) -> None:
        """images: (B, T, A, R) uint8."""
        inp = self._prepare(images)
        t = images.shape[1]

        def part(lo, hi):
            return self.shard_batch(jax.tree.map(
                lambda x: jnp.asarray(x[:, lo:hi]), inp))

        start = 0
        if t and not bool(np.asarray(self.states.initialized).any()):
            first = self.shard_batch(jax.tree.map(
                lambda x: jnp.asarray(x[:, 0]), inp))
            self.states, out0 = self.bootstrap_batch(self.states, first)
            self.outputs.append(jax.tree.map(
                lambda a: np.asarray(a)[:, None], out0))
            start = 1
        n_full = start + ((t - start) // self.chunk) * self.chunk
        for i in range(start, n_full, self.chunk):
            self.states, out = self.step_chunk(self.states,
                                               part(i, i + self.chunk))
            self.outputs.append(jax.tree.map(np.asarray, out))
        if n_full < t:
            self.states, out = self.step_chunk(self.states, part(n_full, t))
            self.outputs.append(jax.tree.map(np.asarray, out))

    def trajectories(self) -> np.ndarray:
        out = jax.tree.map(lambda *xs: np.concatenate(xs, axis=1),
                           *self.outputs)
        b = out.pose.shape[0]
        return np.stack([
            odometry.compose_trajectory(
                jax.tree.map(lambda a, i=i: a[i], out)) for i in range(b)])
