"""The backend decision, the compile-cache rules, the native build, and the
CPU-reachable parts of the CUDA kernel's wrapper (its arithmetic is checked
cell for cell against the XLA scan on the card: chip_smoke.py and the
`gpu` tests)."""

import os
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from coati_tpu import backend, compile_cache, native
from coati_tpu.align.wavefront import dp_fill, gap_consts_array, wavefront
from coati_tpu.kernels import wavefront_cuda as wc
from coati_tpu.structs import GapParams


# --- backend ------------------------------------------------------------------
@pytest.mark.parametrize(
    "env,want", [("", "auto"), ("auto", "auto"), ("gpu", "gpu"),
                 ("cpu", "cpu")],
)
def test_requested_platform(monkeypatch, env, want):
    monkeypatch.setenv(backend.ENV_PLATFORM, env)
    assert backend.requested_platform() == want


@pytest.mark.parametrize("value", ["cuda", "GPU", "metal"])
def test_requested_platform_rejects_unknown(monkeypatch, value):
    monkeypatch.setenv(backend.ENV_PLATFORM, value)
    with pytest.raises(ValueError, match="unknown platform"):
        backend.requested_platform()


def test_platform_override_scopes_and_restores(monkeypatch):
    monkeypatch.setenv(backend.ENV_PLATFORM, "cpu")
    with backend.platform_override("gpu"):
        assert backend.requested_platform() == "gpu"
        with backend.platform_override("auto"):
            assert backend.requested_platform() == "auto"
        assert backend.requested_platform() == "gpu"
    assert backend.requested_platform() == "cpu"
    with pytest.raises(ValueError):
        with backend.platform_override("bogus"):
            pass
    assert backend.requested_platform() == "cpu"


def test_gpu_request_without_gpu_raises(monkeypatch):
    monkeypatch.setenv(backend.ENV_PLATFORM, "gpu")
    with pytest.raises(RuntimeError, match="no gpu device"):
        backend.devices()


def test_devices_cpu_and_cap(monkeypatch):
    monkeypatch.setenv(backend.ENV_PLATFORM, "cpu")
    monkeypatch.delenv(backend.ENV_MAX_DEVICES, raising=False)
    devs = backend.devices()
    assert [d.platform for d in devs] == ["cpu"] * len(jax.devices("cpu"))
    monkeypatch.setenv(backend.ENV_MAX_DEVICES, "2")
    assert backend.devices() == devs[:2]


@pytest.mark.parametrize("mode", ["viterbi", "score", "forward"])
@pytest.mark.parametrize("platform,want", [("gpu", "cuda"), ("cpu", "xla")])
def test_dp_impl(platform, want, mode):
    assert backend.dp_impl(platform, mode) == want


def test_dp_impl_rejects_unknown_mode():
    with pytest.raises(ValueError):
        backend.dp_impl("gpu", "posterior")


def test_dp_impl_follows_cuda_modes(monkeypatch):
    monkeypatch.setattr(backend, "CUDA_MODES", frozenset({"score"}))
    assert backend.dp_impl("gpu", "viterbi") == "xla"
    assert backend.dp_impl("gpu", "score") == "cuda"
    assert backend.dp_impl("cpu", "score") == "xla"


# --- compile cache ------------------------------------------------------------
def test_cache_dir_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_under_repo(monkeypatch):
    import platform as _platform

    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.cache_dir()
    root = str(compile_cache.REPO / ".jax_cache")
    assert os.path.dirname(path) == root
    key = os.path.basename(path)
    assert _platform.node() not in key and str(os.getpid()) not in key
    assert compile_cache.cache_dir() == path  # stable across calls
    monkeypatch.setattr(compile_cache, "cpu_flags", lambda: "other cpu")
    assert compile_cache.cache_dir() != path  # keyed by the CPU


def test_configure_keeps_an_existing_setting():
    # conftest configured the suite's cache; a second call changes nothing
    before = jax.config.jax_compilation_cache_dir
    assert before
    assert compile_cache.configure() == before


# --- native library -----------------------------------------------------------
def test_native_library_keyed_and_untracked(monkeypatch):
    path = native.library_path()
    assert path.parent.parent == compile_cache.REPO / "build"
    assert path.parent.name.startswith("native-")
    monkeypatch.setattr(compile_cache, "cpu_flags", lambda: "other cpu")
    assert native.library_path() != path
    tracked = subprocess.run(
        ["git", "ls-files", "native", "build"], cwd=compile_cache.REPO,
        capture_output=True, text=True,
    ).stdout.split()
    assert not [f for f in tracked if f.endswith(".so")]


def test_native_builds_from_source():
    out = native.build()
    assert out == native.library_path() and out.exists()
    assert native.available()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    src = tmp_path / "native"
    src.mkdir()
    (src / "pairhmm.cc").write_text("this is not C++\n")
    (src / "Makefile").write_text(
        (native._NATIVE_DIR / "Makefile").read_text()
    )
    monkeypatch.setattr(native, "_NATIVE_DIR", src)
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path / "build")
    with pytest.raises(subprocess.CalledProcessError):
        native.build()
    assert not native.library_path().exists()


# --- CUDA kernel wrapper (shapes, layout, choice of ring) ---------------------
@pytest.mark.parametrize("k,c_max", [(1, 6456), (3, 4842)])
def test_ring_in_shared_threshold(k, c_max):
    assert wc.ring_slots(k) == max(k, 2) + 1
    assert wc.ring_in_shared(c_max, k)
    assert not wc.ring_in_shared(c_max + 1, k)


def test_block_threads():
    assert wc.block_threads(192, 192, 1) == 224  # 193 cells -> 7 warps
    assert wc.block_threads(48, 4000, 1) == 64  # band = min(R, C)
    assert wc.block_threads(1536, 1536, 1) == 1024  # threads stride
    assert wc.block_threads(1, 1, 3) == 32


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode", ["viterbi", "score", "forward"])
def test_cuda_output_layout(monkeypatch, mode, k):
    """Result shapes/dtypes match wavefront_impl's contract (the traceback
    walks [Dtot, B, C] uint8 backpointers; samplers read [Dtot, B, C])."""
    monkeypatch.setattr(wc, "_register", lambda: None)
    B, NA, NB = 5, 48, 7000
    S = jax.ShapeDtypeStruct
    args = (S((B, NA), jnp.uint8), S((B, NB), jnp.uint8), S((B,), jnp.int32),
            S((B,), jnp.int32), S((183, 15), jnp.float32),
            S((4,), jnp.float32))
    corners, ys = jax.eval_shape(
        lambda *a: wc.wavefront_cuda(*a, k=k, mode=mode), *args)
    assert [c.shape for c in corners] == [(B,)] * 3
    Dtot = NA + k + NB + k - 1
    if mode == "viterbi":
        assert (ys.shape, ys.dtype) == ((Dtot, B, NB + k), jnp.uint8)
    elif mode == "forward":
        assert [(y.shape, y.dtype) for y in ys] == [
            ((Dtot, B, NB + k), jnp.float32)] * 3
    else:
        assert ys is None
    ref_corners, ref_ys = jax.eval_shape(
        lambda *a: dp_fill(*a, k=k, mode=mode, impl="xla"), *args)
    assert jax.tree.map(lambda x: (x.shape, x.dtype), (corners, ys)) == \
        jax.tree.map(lambda x: (x.shape, x.dtype), (ref_corners, ref_ys))


def test_cuda_library_keyed_by_source(monkeypatch, tmp_path):
    path = wc.library_path()
    assert path.parent.parent == compile_cache.REPO / "build"
    src = tmp_path / "wavefront.cu"
    src.write_text(wc._SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(wc, "_SRC", src)
    assert wc.library_path() != path


def test_cuda_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(wc, "_BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wc.build()


def test_dp_fill_rejects_unknown_impl(mg94_table):
    z = jnp.zeros((1, 3), jnp.int32)
    with pytest.raises(ValueError):
        dp_fill(z, z, jnp.array([3]), jnp.array([3]), mg94_table,
                jnp.zeros(4), k=1, mode="viterbi", impl="pallas")


# --- the rectangle contract the CUDA kernel relies on -------------------------
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode", ["viterbi", "forward"])
def test_rectangle_outputs_ignore_padding(mg94_table, k, mode):
    """Inside each pair's (la + k) x (lb + k) rectangle, the XLA scan's
    outputs for a padded, ragged batch equal those for the pair alone:
    nothing outside the rectangle reaches it. The CUDA kernel computes only
    the rectangle and leaves the rest unwritten on this basis."""
    rng = np.random.default_rng(3 + k)
    gap = GapParams(len=k)
    gc = jnp.asarray(gap_consts_array(gap))
    B, NA, NB = 4, 36, 42
    la = (rng.integers(1, NA // (3 * k) + 1, B) * 3 * k).astype(np.int32)
    lb = (rng.integers(1, NB // k + 1, B) * k).astype(np.int32)
    a = rng.integers(0, 183, (B, NA)).astype(np.int32)
    b = rng.integers(0, 15, (B, NB)).astype(np.int32)
    sem = "log" if mode == "forward" else "tropical"
    cb, yb = wavefront(jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                       jnp.asarray(lb), mg94_table, gc, k=k, semiring=sem,
                       mode=mode)
    for p in range(B):
        c1, y1 = wavefront(
            jnp.asarray(a[p : p + 1, : la[p]]),
            jnp.asarray(b[p : p + 1, : lb[p]]), jnp.asarray(la[p : p + 1]),
            jnp.asarray(lb[p : p + 1]), mg94_table, gc, k=k, semiring=sem,
            mode=mode,
        )
        for x, y in zip(cb, c1):
            assert np.asarray(x)[p] == np.asarray(y)[0]
        R, C = la[p] + k, lb[p] + k
        d = np.arange(R + C - 1)[:, None]
        j = np.arange(C)[None, :]
        inside = (d - j >= 0) & (d - j < R)
        planes = (yb,) if mode == "viterbi" else yb
        ones = (y1,) if mode == "viterbi" else y1
        for full, alone in zip(planes, ones):
            full = np.asarray(full)[: R + C - 1, p, :C]
            alone = np.asarray(alone)[:, 0, :]
            np.testing.assert_array_equal(full[inside], alone[inside])
