"""Multi-worker scaling-efficiency proxy (the BASELINE.md >=80% target).

Sequence-parallel radar odometry has NO cross-worker communication in the
hot path (each host/chip owns whole sequences; only the offline pose-graph
solve is collective), so multi-host scaling efficiency is bounded by
per-host interference, not by the network. This tool measures exactly that
bound on the machine it runs on: it pins identical odometry workloads to
disjoint CPU cores and compares per-worker throughput solo vs concurrent —
a 2-"host" weak-scaling proxy this zero-egress single-chip environment can
actually measure (no second accelerator host exists here).

    efficiency = mean(concurrent worker fps) / solo worker fps

Prints ONE JSON line:
  {"metric": "scaling_efficiency_2worker_proxy", "value": ..., ...}
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time


def _run_worker(core: int, args, out_dir: str) -> subprocess.Popen:
    cmd = ["taskset", "-c", str(core), sys.executable, "-m",
           "cfear_jax.offline_odometry",
           "--dataset", "synthetic", "--cpu",
           "--n-frames", str(args.n_frames), "--seed", str(args.seed),
           "--chunk", "10", "--no-save-graph", "--output-dir", out_dir]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # a compile cache of its own: every worker compiles cold, so the solo
    # and concurrent runs do the same work
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(out_dir, "jax_cache")
    # one compute thread per worker: each "host" gets identical resources
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1").strip()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, env=env, text=True)


def _fps(proc: subprocess.Popen) -> float:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"worker failed rc={proc.returncode}")
    for line in out.splitlines()[::-1]:
        m = re.search(r'"fps": ([0-9.]+)', line)
        if m:
            return float(m.group(1))
    raise RuntimeError("no fps in worker output")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-frames", type=int, default=30)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workers", type=int, default=2)
    args = ap.parse_args()

    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < args.workers:
        print(json.dumps({"metric": "scaling_efficiency_2worker_proxy",
                          "value": None,
                          "note": f"only {len(cores)} cores"}))
        return

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="scale_")
    solo = _fps(_run_worker(cores[0], args, os.path.join(tmp, "solo")))
    print(f"solo worker (core {cores[0]}): {solo:.2f} fps "
          f"[{time.time() - t0:.0f}s]", file=sys.stderr)

    procs = [_run_worker(cores[i], args, os.path.join(tmp, f"w{i}"))
             for i in range(args.workers)]
    fps = [_fps(p) for p in procs]
    shutil.rmtree(tmp, ignore_errors=True)
    eff = (sum(fps) / len(fps)) / solo
    print(f"concurrent x{args.workers}: {[round(f, 2) for f in fps]} fps "
          f"-> efficiency {eff:.3f}", file=sys.stderr)
    print(json.dumps({
        "metric": "scaling_efficiency_2worker_proxy",
        "value": round(eff, 4),
        "unit": "fraction",
        "solo_fps": round(solo, 2),
        "concurrent_fps": [round(f, 2) for f in fps],
        "workers": args.workers,
        "note": ("per-worker throughput pinned to disjoint cores, "
                 "concurrent vs solo; sequence-parallel odometry has no "
                 "hot-path communication, so host interference is the "
                 "scaling bound"),
    }))


if __name__ == "__main__":
    main()
