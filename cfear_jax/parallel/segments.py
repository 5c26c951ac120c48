"""Long-sequence segmentation: parallelize ONE trajectory across devices.

Odometry is serial in time, so a single long sequence cannot be split
naively. This module implements the SURVEY.md §5 "long-context" analogue:

1. the sequence is cut into `n_segments` overlapping windows;
2. every segment runs **independent** odometry from its own bootstrap frame
   (segments form a batch -> vmapped and sharded across the device mesh like
   any multi-sequence batch);
3. consecutive segments are stitched by aligning their pose estimates over
   the shared overlap frames (SE(2) log-mean of the per-frame alignment
   transforms);
4. optionally, all segment keyframes + overlap constraints are refined
   globally with the pose-graph backend.

Accuracy cost: each seam contributes one alignment estimated from `overlap`
frames instead of a continuous solve; with ~10+ overlap frames the seams are
within odometry noise (see tests/test_segments.py).
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cfear_jax.config import CFEARConfig
from cfear_jax.models import odometry
from cfear_jax.utils import se2


def split_indices(t: int, n_segments: int, overlap: int
                  ) -> List[Tuple[int, int]]:
    """[(start, end)) windows covering [0, t) with `overlap` shared frames."""
    if n_segments <= 1:
        return [(0, t)]
    core = int(np.ceil((t + (n_segments - 1) * overlap) / n_segments))
    out = []
    s = 0
    for i in range(n_segments):
        e = min(s + core, t)
        out.append((s, e))
        if e >= t:
            break
        s = e - overlap
    return out


def _se2_mean(poses: np.ndarray) -> np.ndarray:
    """Chordal-ish mean of SE(2) poses via the log map around the first."""
    ref = poses[0]
    ref_j = jnp.asarray(ref)
    twists = []
    for p in poses:
        rel = np.asarray(se2.relative(ref_j, jnp.asarray(p)))
        twists.append(np.asarray(se2.log(jnp.asarray(rel))))
    mean_twist = np.mean(twists, axis=0)
    return np.asarray(se2.compose(ref_j, se2.exp(jnp.asarray(mean_twist))))


def stitch(segment_trajs: List[np.ndarray], windows: List[Tuple[int, int]],
           overlap: int) -> np.ndarray:
    """Compose per-segment trajectories into one global (T, 3) trajectory."""
    t = windows[-1][1]
    world = np.zeros((t, 3))
    offset = np.zeros(3)          # world pose of current segment's origin
    offset_j = jnp.asarray(offset)
    prev_end = 0
    for k, ((s, e), traj) in enumerate(zip(windows, segment_trajs)):
        if k == 0:
            world[s:e] = np.asarray(
                jax.vmap(lambda p: se2.compose(offset_j, p))(
                    jnp.asarray(traj)))
            prev_end = e
            continue
        # alignment: world pose of shared frames vs this segment's local pose
        n_ov = prev_end - s
        aligns = []
        for j in range(n_ov):
            w = world[s + j]
            l = traj[j]
            aligns.append(np.asarray(se2.compose(
                jnp.asarray(w), se2.inverse(jnp.asarray(l)))))
        offset = _se2_mean(np.stack(aligns))
        offset_j = jnp.asarray(offset)
        glob = np.asarray(jax.vmap(lambda p: se2.compose(offset_j, p))(
            jnp.asarray(traj)))
        world[prev_end:e] = glob[prev_end - s:]
        prev_end = e
    return world


def run_segmented(images: np.ndarray, cfg: CFEARConfig, n_segments: int,
                  overlap: int = 8, chunk: int = 16, mesh=None) -> np.ndarray:
    """Segment-parallel odometry over one (T, A, R) sequence.

    Segments are padded to a common length and stepped as a (sharded) batch;
    returns the stitched global (T, 3) trajectory.
    """
    t = images.shape[0]
    windows = split_indices(t, n_segments, overlap)
    seg_len = max(e - s for s, e in windows)
    seg_len = int(np.ceil(seg_len / chunk)) * chunk
    batch = len(windows)
    blocks = np.zeros((batch, seg_len) + images.shape[1:], images.dtype)
    for i, (s, e) in enumerate(windows):
        blocks[i, :e - s] = images[s:e]

    step = odometry.make_step(cfg)
    bootstrap = odometry.make_bootstrap(cfg)

    @jax.jit
    def run(states, imgs):
        states, out0 = jax.vmap(bootstrap)(states, imgs[:, 0])
        states, out = jax.vmap(
            lambda st, im: jax.lax.scan(step, st, im))(states, imgs[:, 1:])
        return states, jax.tree.map(
            lambda a, b: jnp.concatenate([a[:, None], b], axis=1), out0, out)

    states = jax.vmap(lambda _: odometry.init_state(cfg))(jnp.arange(batch))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        shard = lambda x: jax.device_put(x, NamedSharding(
            mesh, P(*(("data",) + (None,) * (x.ndim - 1)))))
        states = jax.tree.map(shard, states)
        blocks_j = shard(jnp.asarray(blocks))
    else:
        blocks_j = jnp.asarray(blocks)

    _, out = run(states, blocks_j)
    out = jax.tree.map(np.asarray, out)
    trajs = [odometry.compose_trajectory(
        jax.tree.map(lambda a, i=i: a[i], out))[:e - s]
        for i, (s, e) in enumerate(windows)]
    return stitch(trajs, windows, overlap)
