"""Where JAX's persistent compilation cache lives.

JAX_COMPILATION_CACHE_DIR, when set, wins everywhere. Otherwise the cache
goes under `<repo>/.jax_cache/` (gitignored), in a subdirectory keyed by
the host CPU's feature flags: XLA:CPU entries bake in the compiling
machine's instruction set, and loading them on a CPU without it can crash
the process. The path holds nothing that changes between runs on one
machine (no hostname, pid, time or temporary name), so a fixed checkout
finds its entries again.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO = Path(__file__).resolve().parent.parent


def cpu_flags() -> str:
    """The host CPU's feature-flag line ('' where /proc/cpuinfo is absent)."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform

    return platform.machine()


def cache_dir(repo_root: Path | None = None) -> str:
    env = os.environ.get(ENV)
    if env:
        return env
    key = hashlib.sha256(cpu_flags().encode()).hexdigest()[:12]
    return str(Path(repo_root or REPO) / ".jax_cache" / key)


def configure() -> str:
    """Point JAX at cache_dir() unless a cache directory is already set
    (JAX reads JAX_COMPILATION_CACHE_DIR into its config at import)."""
    import jax

    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir())
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return jax.config.jax_compilation_cache_dir
