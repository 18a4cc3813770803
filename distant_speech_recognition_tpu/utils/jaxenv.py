"""Process-level JAX setup shared by the entry points.

`setup_compile_cache` points JAX's persistent compilation cache at one
fixed directory, so a second process (or a second run of the same script)
skips the compiles the first one already paid for.  `host_device` runs the
small weight-table computations on the host CPU backend.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import os
import platform
from pathlib import Path

import jax

__all__ = ["CHECKOUT", "DEFAULT_CACHE_DIR", "host_device", "host_key",
           "setup_compile_cache"]

CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"


@functools.cache
def host_key() -> str:
    """``<machine>-<hash>`` naming the host CPU's model and feature flags."""
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    lines.append(line.strip())
                elif not line.strip() and lines:
                    break  # the first processor's block is enough
    except OSError:
        pass
    if not lines:
        lines = [platform.processor(), platform.platform()]
    digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]
    return f"{platform.machine()}-{digest}"


def setup_compile_cache() -> str | None:
    """Enable the persistent compilation cache; call before the first compile.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets no other path; otherwise the cache is ``<checkout>/.jax_cache``.
    A GPU process also caches its XLA:CPU programs (the CPU references and
    the weight tables), and XLA:CPU compiles for the host's instruction set,
    which JAX's own key leaves out (the device kind is just "cpu").  So
    `host_key` is hashed into every entry's key: a program cached on a host
    with another CPU is never loaded.  When the default backend is the CPU
    nothing is cached (the CPU runs are the tests).  Returns the cache
    directory, or None.
    """
    if jax.default_backend() == "cpu":
        return None
    from jax._src import cache_key  # the key's documented extension hook

    cache_key.custom_hook = host_key
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(DEFAULT_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    return path


@contextlib.contextmanager
def host_device():
    """Run the enclosed eager computations on the host CPU backend.

    Weight tables (manifolds, blocking matrices, superdirective and LCMV
    weights) are tiny and embed into the jitted programs as constants, so
    they are computed with the host's f32 numerics.  Where the platform list
    holds no CPU backend (``JAX_PLATFORMS=cuda``) they run on the default
    device with every matmul at full f32 precision instead.
    """
    try:
        cpu = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        with jax.default_matmul_precision("highest"):
            yield
        return
    with jax.default_device(cpu):
        yield
