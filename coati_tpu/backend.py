"""The one backend decision: which devices a call runs on, and which DP
implementation runs there.

Platforms are "gpu" and "cpu". The requested platform comes from the CLI's
`--platform {auto,cpu,gpu}` (for the duration of one verb) or from
COATI_TPU_FORCE_PLATFORM; "auto" takes JAX's default backend. Asking for a
platform JAX cannot find is an error, never a silent run elsewhere.

On a GPU the anti-diagonal DP fill runs as the CUDA kernel
(kernels/wavefront.cu) in the modes listed in CUDA_MODES; everything else
runs the XLA scan (align/wavefront.py). The rule is static: it depends on
the platform and the mode only.
"""

from __future__ import annotations

import contextlib
import os

import jax

PLATFORMS = ("gpu", "cpu")
ENV_PLATFORM = "COATI_TPU_FORCE_PLATFORM"
ENV_MAX_DEVICES = "COATI_TPU_MAX_DEVICES"

# DP modes the CUDA kernel serves on a GPU: each beat the XLA scan end to
# end on an H100 (docs/PERF.md, "Kernel decision")
CUDA_MODES = frozenset({"viterbi", "score", "forward"})

_override: str | None = None


def requested_platform() -> str:
    """'auto', 'gpu' or 'cpu'; anything else is a ValueError."""
    p = _override if _override is not None else (
        os.environ.get(ENV_PLATFORM, "") or "auto"
    )
    if p not in ("auto",) + PLATFORMS:
        raise ValueError(
            f"unknown platform {p!r}: choose auto, {', '.join(PLATFORMS)}"
        )
    return p


@contextlib.contextmanager
def platform_override(platform: str):
    """Request `platform` for the calls made inside the block."""
    global _override
    prev = _override
    _override = platform
    try:
        requested_platform()
        yield
    finally:
        _override = prev


def devices() -> list:
    """Every local device of the requested platform (local: under
    jax.distributed each process dispatches to its own devices only),
    capped by COATI_TPU_MAX_DEVICES when set."""
    p = requested_platform()
    if p == "auto":
        devs = jax.local_devices()
    else:
        try:
            devs = jax.local_devices(backend=p)
        except RuntimeError as exc:
            raise RuntimeError(
                f"platform {p!r} was requested but JAX finds no {p} device"
            ) from exc
    cap = int(os.environ.get(ENV_MAX_DEVICES, "0"))
    return list(devs[:cap] if cap > 0 else devs)


def dp_impl(platform: str, mode: str) -> str:
    """'cuda' or 'xla': the DP implementation for a device of `platform`
    in `mode` ('viterbi', 'score' or 'forward')."""
    if mode not in ("viterbi", "score", "forward"):
        raise ValueError(mode)
    return "cuda" if platform == "gpu" and mode in CUDA_MODES else "xla"

