"""Distributed pose-graph optimization over device collectives.

The reference has no distributed back-end (its `simple_graph` is serialized
for an external SLAM project; SURVEY.md §2.3/§5). Here multi-session /
loop-closed graphs are optimized across a device mesh: constraint edges are
sharded over the `data` axis, node poses are replicated, and every
Gauss-Newton gradient / J^T J matvec is an edge-local computation followed by
a `psum` — the Schur-style "partial normal equations + all-reduce" pattern.
The CG iteration state is replicated, so all devices walk the same solution.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cfear_jax.models.posegraph import (
    DEFAULT_GNC_START, DEFAULT_LOOP_LOSS, DEFAULT_LOOP_LOSS_LIMIT, PoseGraph,
    adaptive_gnc_start, edge_residuals, gnc_limit, hessian_diag_blocks,
    robust_cost)


def _pad_edges(graph: PoseGraph, n_dev: int) -> PoseGraph:
    e = graph.edge_i.shape[0]
    pad = (-e) % n_dev
    if pad == 0:
        return graph
    return graph._replace(
        edge_i=jnp.pad(graph.edge_i, (0, pad)),
        edge_j=jnp.pad(graph.edge_j, (0, pad)),
        t_ij=jnp.pad(graph.t_ij, ((0, pad), (0, 0))),
        sqrt_info=jnp.pad(graph.sqrt_info, ((0, pad), (0, 0), (0, 0))),
        edge_type=jnp.pad(graph.edge_type, (0, pad)),
        edge_valid=jnp.pad(graph.edge_valid, (0, pad)),
        loop_scale=(None if graph.loop_scale is None
                    else jnp.pad(graph.loop_scale, (0, pad),
                                 constant_values=1.0)),
    )


def distributed_optimize(graph: PoseGraph, mesh: Mesh, axis: str = "data",
                         iters: int = 10, cg_iters: int = 50,
                         damping: float = 1e-6,
                         loop_loss: str = DEFAULT_LOOP_LOSS,
                         loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT,
                         gnc_start: float = DEFAULT_GNC_START):
    """Edge-sharded Gauss-Newton: returns (optimized PoseGraph, final cost).

    Same robust-loop-edge / CANDIDATE-masking / graduated-non-convexity
    semantics as the single-device optimizer (`posegraph.edge_residuals`,
    `posegraph.gnc_limit`, adaptive anneal start, block-Jacobi
    preconditioned CG); the IRLS weights and diag-block partials are
    edge-local, so robustification and preconditioning each add one psum."""
    n_dev = mesh.shape[axis]
    graph = _pad_edges(graph, n_dev)
    # anneal start (mirrors posegraph.optimize): mild fixed start when
    # per-edge drift scales are present, residual-quantile adaptive start
    # for scale-less graphs
    if loop_loss == "None":
        start_dyn = jnp.asarray(gnc_start, jnp.float32)
    elif graph.loop_scale is not None:
        start_dyn = jnp.asarray(1.0, jnp.float32)   # no anneal (see
        # posegraph.optimize: scaled limits replace GNC entirely)
    else:
        start_dyn = adaptive_gnc_start(graph.poses, graph, loop_loss_limit,
                                       gnc_start)

    edge_spec = P(axis)
    repl = P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(repl, repl, edge_spec, edge_spec, edge_spec,
                       edge_spec, edge_spec, edge_spec, edge_spec, repl),
             out_specs=(repl, repl),
             check_vma=False)
    def run(poses, node_valid, ei, ej, tij, sinfo, etype, evalid, lscale,
            start):
        local = PoseGraph(poses, node_valid, ei, ej, tij, sinfo, etype,
                          evalid, lscale)
        n = poses.shape[0]

        def gauge(x):
            return x.at[0].set(0.0)

        def gn_body(k, carry):
            p, _ = carry
            limit_k = gnc_limit(k, iters, loop_loss_limit, start)

            def local_res(q):
                return edge_residuals(q, local._replace(poses=q),
                                      loop_loss, limit_k)

            r, vjp = jax.vjp(local_res, p)
            (grad,) = vjp(r)
            grad = gauge(jax.lax.psum(grad, axis))
            cost = 0.5 * jax.lax.psum(jnp.sum(r * r), axis)

            def hvp(x):
                x = gauge(x)
                _, jv = jax.jvp(local_res, (p,), (x,))
                (h,) = vjp(jv)
                return gauge(jax.lax.psum(h, axis)) + damping * x

            # block-Jacobi preconditioner: edge-local partial diag blocks,
            # ONE psum, replicated 3x3 inverses
            blocks = jax.lax.psum(
                hessian_diag_blocks(p, local._replace(poses=p), loop_loss,
                                    limit_k, num_nodes=n), axis)
            m = blocks + damping * jnp.eye(3, dtype=p.dtype)
            m = m.at[0].set(jnp.eye(3, dtype=p.dtype))
            minv = jnp.linalg.inv(m)

            def precond(x):
                return jnp.einsum("nab,nb->na", minv, x)

            def cg_body(_, state):
                x, rr, pp, rz = state
                Ap = hvp(pp)
                denom = jnp.sum(pp * Ap)
                alpha = rz / jnp.where(denom > 0, denom, 1.0)
                x = x + alpha * pp
                rr = rr - alpha * Ap
                z = precond(rr)
                rz_new = jnp.sum(rr * z)
                beta = rz_new / jnp.where(jnp.abs(rz) > 0, rz, 1.0)
                return x, rr, z + beta * pp, rz_new

            b = -grad
            z0 = precond(b)
            dx, *_ = jax.lax.fori_loop(0, cg_iters, cg_body,
                                       (jnp.zeros_like(b), b, z0,
                                        jnp.sum(b * z0)))
            dx = gauge(dx)

            # damped acceptance (mirrors posegraph.gn_step): psum'd TRUE
            # robust cost over the backtracking ladder {1, 1/2, 1/4, 0}
            def cost_at(p2):
                return jax.lax.psum(
                    robust_cost(p2, local._replace(poses=p2),
                                loop_loss, limit_k), axis)

            ladder = (1.0, 0.5, 0.25, 0.1, 0.04, 0.01)
            alphas = jnp.asarray(ladder + (0.0,), p.dtype)
            costs = jnp.stack([cost_at(p + a * dx) for a in ladder]
                              + [cost_at(p)])
            best = jnp.argmin(costs)
            return p + alphas[best] * dx, cost

        poses_out, cost = jax.lax.fori_loop(
            0, iters, gn_body, (poses, jnp.asarray(0.0, poses.dtype)))
        return poses_out, cost

    lscale = graph.loop_scale if graph.loop_scale is not None \
        else jnp.ones_like(graph.t_ij[:, 0])
    poses_out, cost = run(graph.poses, graph.node_valid, graph.edge_i,
                          graph.edge_j, graph.t_ij, graph.sqrt_info,
                          graph.edge_type, graph.edge_valid, lscale,
                          start_dyn)
    return graph._replace(poses=poses_out), cost
