"""Block-sparse exact 1-NN association kernel (Pallas, Triton route).

For every source cell and every keyframe, the nearest valid target cell and
its squared distance, computed in the difference form
(sx - tx)^2 + (sy - ty)^2 — no |s|^2 + |t|^2 - 2 s.t cancellation error at
100 m ranges, and the arithmetic of the reference's kd-tree 1-NN
(`pointnormal.cpp:238-254`).

One program handles one (keyframe, source tile of TS rows). It loops over
the keyframe's target tiles of TT columns; a target tile whose bounding box
lies farther than `radius` from the source tile's bounding box is skipped by
a scalar branch. The running (min, argmin) stays in registers. Skipping is
exact for the association gate: a skipped tile holds only distances beyond
the radius, which the gate rejects anyway. Rows whose every tile was skipped
report (+inf, 0), exactly like rows with no valid target at all. With
`radius = inf` nothing is skipped and the kernel is the dense 1-NN.

Cells are spatially coherent in tile order only when the cell maps are
Morton-ordered (`feature.spatial_sort`); otherwise every bounding box spans
the scan and the kernel runs dense.

Each program keeps a (TS, TT) running minimum and the tile it came from,
updated elementwise, and reduces it once at the end. Strict `<` across
tiles and the lowest index among equal minima keep `jnp.argmin`'s
lowest-index tie-break. The wrapper pads both cell axes to
whole tiles (padded targets are invalid, padded source rows are dropped).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# tiles measured fastest of six configurations at S in {4, 16, 50},
# B in {1, 8}, M = 1024 on an H100 (tools/assoc_ab.py)
TS = 32          # source rows per program
TT = 32          # target columns per skip-test tile
NUM_WARPS = 2


def tile_bounds(xy, valid, tile: int):
    """Per-contiguous-tile bounding boxes [xmin, xmax, ymin, ymax].

    xy (..., N, 2), valid (..., N) with N a multiple of `tile` ->
    (..., N / tile, 4). Tiles without a valid point get
    (+inf, -inf, +inf, -inf), which every skip test rejects."""
    shape = xy.shape[:-2] + (xy.shape[-2] // tile, tile)
    x = xy[..., 0].reshape(shape)
    y = xy[..., 1].reshape(shape)
    v = valid.reshape(shape)
    return jnp.stack([jnp.min(jnp.where(v, x, jnp.inf), -1),
                      jnp.max(jnp.where(v, x, -jnp.inf), -1),
                      jnp.min(jnp.where(v, y, jnp.inf), -1),
                      jnp.max(jnp.where(v, y, -jnp.inf), -1)], -1)


def _nn_kernel(r2_ref, sb_ref, sx_ref, sy_ref, tb_ref, tx_ref, ty_ref,
               tm_ref, nn_ref, d2_ref, *, n_tt: int):
    sx = sx_ref[...][:, None]                          # (TS, 1)
    sy = sy_ref[...][:, None]
    r2 = r2_ref[0]
    sxmin, sxmax, symin, symax = sb_ref[0], sb_ref[1], sb_ref[2], sb_ref[3]

    def hit(off, best, boff):
        tx = tx_ref[pl.ds(off, TT)][None, :]           # (1, TT)
        ty = ty_ref[pl.ds(off, TT)][None, :]
        tm = tm_ref[pl.ds(off, TT)][None, :]           # 0 valid, +inf not
        dx = sx - tx                                   # (TS, TT)
        dy = sy - ty
        d2 = dx * dx + dy * dy + tm
        # elementwise running min per (row, column): no cross-thread
        # reduction inside the loop; strict '<' keeps the earliest tile
        better = d2 < best
        return jnp.where(better, d2, best), jnp.where(better, off, boff)

    def body(jt, carry):
        gapx = jnp.maximum(jnp.maximum(tb_ref[4 * jt] - sxmax,
                                       sxmin - tb_ref[4 * jt + 1]), 0.0)
        gapy = jnp.maximum(jnp.maximum(tb_ref[4 * jt + 2] - symax,
                                       symin - tb_ref[4 * jt + 3]), 0.0)
        return jax.lax.cond(gapx * gapx + gapy * gapy <= r2,
                            functools.partial(hit, jt * TT),
                            lambda b, o: (b, o), *carry)

    shape = (sx.shape[0], TT)
    best, boff = jax.lax.fori_loop(
        0, n_tt, body, (jnp.full(shape, jnp.inf, jnp.float32),
                        jnp.zeros(shape, jnp.int32)))
    # one reduction at the end: the lowest target index among the minima
    idx = boff + jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    dmin = jnp.min(best, axis=1)
    nn_ref[...] = jnp.min(jnp.where(best == dmin[:, None], idx,
                                    jnp.iinfo(jnp.int32).max), axis=1)
    d2_ref[...] = dmin


def _pad_axis(a, n: int, value):
    pad = n - a.shape[-1]
    if pad == 0:
        return a
    widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return jnp.pad(a, widths, constant_values=value)


@functools.partial(jax.jit, static_argnames=("interpret",))
def nn_min(src_xy, src_valid, tar_xy, tar_valid, radius=math.inf, *,
           interpret: bool = False):
    """Exact 1-NN within `radius` of each source point per keyframe.

    src_xy (M_src, 2), src_valid (M_src,), tar_xy (S, M_tar, 2),
    tar_valid (S, M_tar), radius scalar (may be traced). Returns
    (nn (S, M_src) int32, d2 (S, M_src) float32): for every valid source row
    whose nearest valid target lies within `radius`, the same (nn, d2) as
    `registration.nn_dense` (jnp.argmin / jnp.min over the same
    difference-form distances). Other rows
    report d2 >= radius^2 (possibly +inf); invalid source rows may report
    anything. `interpret=True` runs the kernel on the CPU (tests only)."""
    s, m_tar = tar_valid.shape
    m_src = src_xy.shape[0]
    n_st = -(-m_src // TS)
    n_tt = -(-m_tar // TT)
    ms_pad, mt_pad = n_st * TS, n_tt * TT

    src_xy = src_xy.astype(jnp.float32)
    tar_xy = tar_xy.astype(jnp.float32)
    sx = _pad_axis(src_xy[:, 0], ms_pad, 0.0)
    sy = _pad_axis(src_xy[:, 1], ms_pad, 0.0)
    sv = _pad_axis(src_valid, ms_pad, False)
    tx = _pad_axis(tar_xy[..., 0], mt_pad, 0.0)
    ty = _pad_axis(tar_xy[..., 1], mt_pad, 0.0)
    tv = _pad_axis(tar_valid, mt_pad, False)
    tm = jnp.where(tv, 0.0, jnp.inf).astype(jnp.float32)
    sb = tile_bounds(jnp.stack([sx, sy], -1), sv, TS)            # (n_st, 4)
    tb = tile_bounds(jnp.stack([tx, ty], -1), tv, TT).reshape(s, n_tt * 4)
    radius = jnp.asarray(radius, jnp.float32)
    r2 = jnp.reshape(radius * radius, (1,))

    nn, d2 = pl.pallas_call(
        functools.partial(_nn_kernel, n_tt=n_tt),
        grid=(s, n_st),
        in_specs=[
            pl.BlockSpec((1,), lambda i, j: (0,)),
            pl.BlockSpec((None, 4), lambda i, j: (j, 0)),
            pl.BlockSpec((TS,), lambda i, j: (j,)),
            pl.BlockSpec((TS,), lambda i, j: (j,)),
            pl.BlockSpec((None, n_tt * 4), lambda i, j: (i, 0)),
            pl.BlockSpec((None, mt_pad), lambda i, j: (i, 0)),
            pl.BlockSpec((None, mt_pad), lambda i, j: (i, 0)),
            pl.BlockSpec((None, mt_pad), lambda i, j: (i, 0)),
        ],
        out_specs=[pl.BlockSpec((None, TS), lambda i, j: (i, j)),
                   pl.BlockSpec((None, TS), lambda i, j: (i, j))],
        out_shape=[jax.ShapeDtypeStruct((s, ms_pad), jnp.int32),
                   jax.ShapeDtypeStruct((s, ms_pad), jnp.float32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="nn_min_sparse",
    )(r2, sb, sx, sy, tb, tx, ty, tm)
    return nn[:, :m_src], d2[:, :m_src]
