"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device behavior is validated on CPU (xla_force_host_platform_device_count).
Tests marked `gpu` need the card: they skip here and run on a GPU host
(`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`); `python chip_smoke.py` runs the same
checks end to end.
"""

import os

# CPU unless the caller names platforms (a GPU host runs the `gpu` tests
# with JAX_PLATFORMS=cuda,cpu)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# persistent XLA compilation cache: scan kernels compile once per shape
from coati_tpu import compile_cache

compile_cache.configure()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def mg94_table():
    """Default mar-mg 183x15 marginal table (t=0.0133, w=0.2, default pi)."""
    from coati_tpu.models import marginal_p, mg94_p

    pi = (0.308, 0.185, 0.199, 0.308)
    return marginal_p(mg94_p(0.0133, 0.2, pi), pi).astype(np.float32)


# The full suite deterministically segfaulted/aborted inside XLA:CPU
# compile/cache-load (always at the same test, ~1000 compiled executables
# into the process; any large SUBSET of the suite passes). Dropping the
# in-memory executable caches at module boundaries keeps the loaded-code
# population bounded; the CPU-keyed persistent disk cache makes the
# recompiles cheap.
import pytest as _pytest


@_pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    import gc

    jax.clear_caches()
    gc.collect()


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked `gpu`; skips where there is none.
    Decided here, at run time, never while a module is imported."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run on a GPU host: -m gpu)")
