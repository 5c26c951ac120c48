#!/bin/bash
# CFEAR-3-s50 keyframe-gate sweep: frames/s + drift vs max_active_keyframes.
#
# The s50 association/LM cost is linear in the ACTIVE keyframe axis. Each K
# compiles a distinct program (the gated window reshapes to (K, M, ...));
# bench.py keeps compiled programs in the persistent compilation cache
# ($JAX_COMPILATION_CACHE_DIR, else <repo>/.jax_cache). One process at a
# time: each run takes the whole accelerator.
set -u
out="${1:-s50_gate_sweep.log}"
: > "$out"
for k in 0 24 16 12; do
  echo "=== max_active_keyframes=$k ===" >> "$out"
  timeout 3000 python bench.py --preset CFEAR-3-s50 --check-drift \
    --batch 4 --frames 96 --chunk 32 --max-active-keyframes "$k" \
    >> "$out" 2>&1
  echo "exit=$?" >> "$out"
done
