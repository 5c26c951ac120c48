"""Real multi-process jax.distributed tests: two CPU processes, a global
8-device mesh, cross-process psum and an edge-sharded pose-graph solve."""

import os
import subprocess
import sys

import numpy as np

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")

from cfear_jax.parallel import distributed

pid = int(sys.argv[1])
port = sys.argv[2]
distributed.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2
assert len(jax.devices()) == 8          # 4 local + 4 remote

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

mesh = distributed.global_mesh(("data",))

# cross-process psum through shard_map
@jax.jit
def total(x):
    return jax.shard_map(lambda v: jax.lax.psum(v, "data"),
                         mesh=mesh, in_specs=P("data"), out_specs=P(),
                         check_vma=False)(x)

xs = jax.device_put(jnp.arange(8.0),
                    NamedSharding(mesh, P("data")))
out = np.asarray(jax.jit(total)(xs))[()]
assert out == 28.0, out

# distributed pose-graph GN across both processes
import numpy as onp
from cfear_jax.models import posegraph
from cfear_jax.parallel import pgo
from cfear_jax.utils import se2

gb = posegraph.GraphBuilder()
n = 16
poses = onp.zeros((n, 3))
for i in range(n):
    poses[i] = [1.0 * i, 0.05 * i, 0.02 * i]
    gb.add_node(poses[i] + onp.array([0.1, -0.1, 0.01]) * (i % 3))
info = onp.eye(3) * 50.0
for i in range(1, n):
    t = onp.asarray(se2.relative(jnp.asarray(poses[i - 1]),
                                 jnp.asarray(poses[i])))
    gb.edges.append((i - 1, i, t, info, posegraph.ODOMETRY))
graph = gb.to_arrays()
opt, cost = pgo.distributed_optimize(graph, mesh, iters=4, cg_iters=20)
final = float(posegraph.total_cost(opt))
init = float(posegraph.total_cost(graph))
assert final < init * 0.1, (final, init)
if pid == 0:
    print(f"MULTIHOST_OK psum={out} pgo {init:.3f}->{final:.3f}")
"""


def test_two_process_distributed(tmp_path):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    assert procs[0].returncode == 0, outs[0][-2000:]
    assert procs[1].returncode == 0, outs[1][-2000:]
    assert "MULTIHOST_OK" in outs[0], outs[0][-2000:]
