"""Runtime policy: compile-cache location, the GPU smoke script's refusal to
run without a card, and a scan of the package for accelerator-specific code
that must not come back."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax
import pytest

from cfear_jax.utils import runtime

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path,
                                    restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the helper
    changes nothing."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_repo(monkeypatch, restore_cache_config):
    """Without the variable the cache goes to <repo>/.jax_cache, which
    .gitignore lists."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "PYTHONPATH")}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """Without a GPU (or without the package beside it) the smoke script
    exits non-zero and prints no result line."""
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    res = _run_smoke(cwd)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_no_accelerator_specific_code_in_package():
    """No Pallas dialect of another accelerator, no 'not CPU means
    accelerator X' test, no interpret mode chosen from the backend and no
    hard-coded absolute compile-cache path in the package."""
    banned = [
        re.compile(r"pallas\s*import\s+t[p]u|pallas\.t[p]u|\bplt[p]u\b"),
        re.compile(r"default_backend\(\)\s*!=\s*[\"']cpu[\"']"),
        re.compile(r"interpret\s*=\s*jax\.default_backend"),
        re.compile(r"[\"']/[^\"']*\.jax_cache"),
    ]
    hits = []
    for path in (sorted((REPO / "cfear_jax").rglob("*.py"))
                 + sorted((REPO / "tools").glob("*.py"))
                 + [REPO / "bench.py", REPO / "chip_smoke.py"]):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if any(p.search(line) for p in banned):
                hits.append(f"{path.relative_to(REPO)}:{n}: {line.strip()}")
    assert not hits, "\n".join(hits)
