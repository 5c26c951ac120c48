"""Process-level runtime policy: which platform a computation targets, and
where compiled programs are cached.

`platform()` is the ONE place that maps JAX's device to a code path. It
returns "cpu" or "gpu" and raises on anything else, so a new accelerator is
an error to handle, never a silent fallback. `setup_compile_cache()` is
called once by every entry point before its first compilation.
"""

from __future__ import annotations

import os

import jax

_PLATFORMS = ("cpu", "gpu")
_CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def platform() -> str:
    """Platform that new computations are placed on: "cpu" or "gpu".

    Honours `jax.default_device(...)` (a device or a platform name), so a
    CPU cross-check inside a GPU process takes the CPU code paths."""
    dev = jax.config.jax_default_device
    if dev is None:
        name = jax.default_backend()
    elif isinstance(dev, str):
        name = dev
    else:
        name = dev.platform
    name = {"cuda": "gpu"}.get(name, name)
    if name not in _PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: this engine runs on "
            f"{' or '.join(_PLATFORMS)}")
    return name


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `$JAX_COMPILATION_CACHE_DIR`
    when set (JAX already reads it; nothing is changed here), else at
    `<repo>/.jax_cache`. Returns the directory in use."""
    if os.environ.get(_CACHE_ENV):
        return os.environ[_CACHE_ENV]
    jax.config.update("jax_compilation_cache_dir", _REPO_CACHE)
    return _REPO_CACHE
