"""The CUDA DP kernel (wavefront.cu) as a JAX operation on NVIDIA GPUs.

The library is compiled with nvcc at first use from the source beside this
file, into `<repo>/build/cuda-<hash>/` (gitignored; the hash covers the
source and the compiler flags), and its three FFI handlers are registered
for the CUDA platform. A missing nvcc or a failed build is an error. The
build targets Hopper (sm_90a, 227 KB of shared memory per block); on any
other GPU the launch fails with CUDA's error rather than running.

`wavefront_cuda` has wavefront_impl's contract for the three modes it
serves: terminal-adjusted corners plus packed backpointers (viterbi),
corners only (score), or corners plus the log-semiring M/D/I planes
(forward). Outputs outside each pair's own (la + k) x (lb + k) rectangle
are unspecified; every consumer reads inside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

_SRC = Path(__file__).with_name("wavefront.cu")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"

# Hopper: sm_90a machine code; -fmad=false keeps every add and multiply
# separately rounded, as in the XLA scan it must reproduce bit for bit
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
# dynamic shared memory one block may use on Hopper (232,448 bytes)
SHARED_BYTES_MAX = 232448
MAX_THREADS = 1024
_TARGETS = {
    "viterbi": "CoatiWavefrontViterbi",
    "score": "CoatiWavefrontScore",
    "forward": "CoatiWavefrontForward",
}
_lib = None


def ring_slots(k: int) -> int:
    """Diagonals the kernel keeps: the max(k, 2) it reads plus the one it
    writes, so one barrier per diagonal suffices."""
    return max(k, 2) + 1


def ring_in_shared(C: int, k: int) -> bool:
    """Whether the [ring, 3, C] f32 ring fits one block's shared memory;
    otherwise it lives in a global scratch result (L2-resident)."""
    return ring_slots(k) * 3 * C * 4 <= SHARED_BYTES_MAX


def block_threads(NA: int, NB: int, k: int) -> int:
    """Threads per block: one per cell of the widest anti-diagonal
    (min(R, C) cells), in whole warps, at most 1024 (threads then stride)."""
    band = min(NA + k, NB + k)
    return min(MAX_THREADS, max(32, -(-band // 32) * 32))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA DP kernel is "
        "built from coati_tpu/kernels/wavefront.cu at first use"
    )


def library_path() -> Path:
    """Where the build for the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / f"cuda-{h.hexdigest()[:16]}" / "libcoati_wavefront.so"


def build() -> Path:
    """Compile the library unless this source's build exists already."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(),
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "building the CUDA DP kernel failed:\n" + " ".join(cmd) + "\n"
            + proc.stdout + proc.stderr
        )
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def _register():
    global _lib
    if _lib is None:
        lib = ctypes.cdll.LoadLibrary(str(build()))
        for sym in _TARGETS.values():
            jax.ffi.register_ffi_target(
                sym, jax.ffi.pycapsule(getattr(lib, sym)), platform="CUDA"
            )
        _lib = lib


def wavefront_cuda(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int,
                   mode: str = "viterbi"):
    """CUDA counterpart of wavefront_impl (tropical semiring for viterbi
    and score, log semiring for forward). Traceable under jit and
    shard_map; returns ((cM, cD, cI), ys) with ys = bp [Dtot, B, C] uint8
    (viterbi), (M, D, I) [Dtot, B, C] f32 (forward) or None (score)."""
    _register()
    B, NA = aseq.shape
    NB = bseq.shape[1]
    C = NB + k
    Dtot = (NA + k) + C - 1
    shared = ring_in_shared(C, k)
    ring_n = 1 if shared else B * ring_slots(k) * 3 * C
    f32 = jnp.float32
    outs = [jax.ShapeDtypeStruct((3, B), f32)]
    if mode == "viterbi":
        outs.append(jax.ShapeDtypeStruct((Dtot, B, C), jnp.uint8))
    elif mode == "forward":
        outs += [jax.ShapeDtypeStruct((Dtot, B, C), f32)] * 3
    elif mode != "score":
        raise ValueError(mode)
    outs.append(jax.ShapeDtypeStruct((ring_n,), f32))
    res = jax.ffi.ffi_call(_TARGETS[mode], outs)(
        aseq.astype(jnp.int32), bseq.astype(jnp.int32),
        lens_a.astype(jnp.int32), lens_b.astype(jnp.int32),
        table.astype(f32), gap_consts.astype(f32),
        k=np.int32(k), threads=np.int32(block_threads(NA, NB, k)),
        ring_in_shared=np.int32(shared),
    )
    corners = (res[0][0], res[0][1], res[0][2])
    if mode == "viterbi":
        return corners, res[1]
    if mode == "forward":
        return corners, (res[1], res[2], res[3])
    return corners, None
