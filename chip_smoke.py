#!/usr/bin/env python3
"""Smoke test of the aligner on one NVIDIA GPU: the main path end to end,
through the entry points users call, at the full size of the mixed
ortholog batch, each result checked against the repo's references.

    python chip_smoke.py          # one GPU: phases 0-8 (below)
    python chip_smoke.py --four   # four GPUs: the multi-device paths only

Phases: 0 device, 1 compile each kernel at real widths, 2 the mixed 10k-pair
mar-mg batch vs native C++, 3 the `batch` and `alignpair` verbs, 4 the
oracle parity groups (k=1, k=3, IUPAC, stacked tables), 5 a 32,001-nt
long pair, 6 forward + 200 device samples at 9,999 nt, 7 the tri-mg batch,
8 the kernel decision (CUDA DP kernel vs the XLA scan). Any failure raises
and the script exits non-zero without printing a result. The last line of
standard output is one JSON object naming the device.

One process uses the card(s): every phase, the CLI verbs included, runs in
this process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20260817
N_PAIRS = 10_000
NATIVE_EVERY = 4  # native C++ reference on every 4th pair of the batch
N_CLI_PAIRS = 2_000
LONG_NT = 32_001
SAMPLE_NT = 9_999
N_SAMPLES = 200
TRIPLET = (64, 999, 8)  # pairs, nt, pairs checked against the host engine
PARITY = (("k1", 80), ("k3", 24))
N_LEAVES = 40
N_MESH_PAIRS = 2_000
LONG_FOUR = (4, 16_998)  # long pairs (beyond LONG_PAIR_SLOTS) for --four


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    """`nvidia-smi`'s name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpus(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        raise SystemExit(
            f"needs {n} GPU(s); JAX finds {[d.platform for d in devs]}"
        )
    return devs[:n]


def alloc_count(dev) -> int:
    """Device allocations `dev` has made so far (the allocator's count)."""
    return dev.memory_stats()["num_allocs"]


@contextlib.contextmanager
def allocates_on(dev):
    """Assert that the block allocated device memory on `dev`."""
    before = alloc_count(dev)
    yield
    assert alloc_count(dev) > before, f"nothing was allocated on {dev}"


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def mixed_pairs():
    import bench

    return bench.make_pairs(N_PAIRS, np.random.default_rng(SEED))


def one_pair(rng, nt):
    """One generated pair of `nt` nt with no terminal stop codon."""
    import bench
    from coati_tpu.checks import untrimmed

    while True:
        pair = bench.make_pairs(1, rng, length_mix=[(nt, 1.0)])
        if untrimmed(pair):
            return pair[0]


def run_batch(pairs, table, gap):
    """viterbi_align_batch on `pairs`; returns (results, chunk trace)."""
    import coati_tpu.align.engine as eng
    from coati_tpu.checks import align_pairs

    eng.CHUNK_TRACE = []
    try:
        results = align_pairs(pairs, table, gap)
        return results, eng.CHUNK_TRACE
    finally:
        eng.CHUNK_TRACE = None


@contextlib.contextmanager
def cuda_modes(modes):
    """Serve only `modes` with the CUDA kernel inside the block (the
    kernel decision compares against the XLA scan this way)."""
    from coati_tpu import backend

    prev = backend.CUDA_MODES
    backend.CUDA_MODES = frozenset(modes)
    try:
        yield
    finally:
        backend.CUDA_MODES = prev


# --- phases --------------------------------------------------------------------
def phase_device(n):
    import jax

    devs = require_gpus(n)
    log(card_line())
    log(f"phase 0 device: {devs[0].device_kind} x{len(jax.devices())}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return devs


def phase_compile(dev):
    import jax
    import jax.numpy as jnp

    from coati_tpu.align.engine import RLE_RUNS, _align_step_rle_jit
    from coati_tpu.align.wavefront import dp_fill_jit
    from coati_tpu.kernels import wavefront_cuda

    _, t_build = timed(wavefront_cuda.build)
    S = jax.ShapeDtypeStruct
    tab, gc = S((183, 15), jnp.float32), S((4,), jnp.float32)

    def args(B, NA, NB, dt=jnp.int32):
        return (S((B, NA), dt), S((B, NB), dt), S((B,), jnp.int32),
                S((B,), jnp.int32), tab, gc)

    # the widest mixed-batch bucket at the engine's chunk size
    B = (1 << 30) // (1537 * 1537)
    step = _align_step_rle_jit.lower(
        *args(B, 1536, 1536, jnp.uint8), k=1, impl="cuda", nr=RLE_RUNS
    ).compile()
    log(f"phase 1 compile: CUDA library built in {t_build:.1f}s; fused "
        f"viterbi step B={B} 1536x1536 memory_analysis: "
        f"{step.memory_analysis()}")
    for mode, shape in (("score", (B, 1536, 1536)),
                        ("forward", (1, SAMPLE_NT, SAMPLE_NT + 9))):
        c = dp_fill_jit.lower(*args(*shape), k=1, mode=mode,
                              impl="cuda").compile()
        log(f"phase 1 compile: {mode} B={shape[0]} {shape[1]}x{shape[2]} "
            f"memory_analysis: {c.memory_analysis()}")


def phase_mixed_batch(dev, card, table, gap):
    from coati_tpu.checks import compare_with_native, native_alignments

    pairs = mixed_pairs()
    cells = sum(len(a) * len(d) for a, d in pairs)
    with allocates_on(dev):
        (_, _), t_cold = timed(lambda: run_batch(pairs, table, gap))
        (results, trace), t_warm = timed(lambda: run_batch(pairs, table, gap))
    assert all(c["impl"] == "cuda" for c in trace), trace[:3]
    assert {c["device"] for c in trace} == {dev.id}
    sub = list(range(0, len(pairs), NATIVE_EVERY))
    natives, t_nat = timed(lambda: native_alignments(
        [pairs[i] for i in sub], table, gap))
    n = compare_with_native([results[i] for i in sub], natives)
    log(f"phase 2 mixed batch: {len(pairs)} pairs, {cells / 1e9:.2f} Gcells, "
        f"{len(trace)} chunks; cold {t_cold:.2f}s, warm {t_warm:.3f}s "
        f"({len(pairs) / t_warm:.0f} alignments/s) on {card}; "
        f"{n} pairs string-identical to native C++ "
        f"(native {t_nat:.1f}s)")
    return pairs, results, t_warm, trace


def phase_entry_points(dev, pairs, results):
    from coati_tpu.checks import (
        check_alignpair_example,
        check_batch_cli,
        untrimmed,
    )

    keep = untrimmed(pairs)[:N_CLI_PAIRS]
    with tempfile.TemporaryDirectory() as tmp, allocates_on(dev):
        n, t = timed(lambda: check_batch_cli(
            [pairs[i] for i in keep], [results[i] for i in keep], tmp))
        got = check_alignpair_example(tmp, platform=dev.platform)
    log(f"phase 3 entry points: batch verb {n} pairs == phase 2 "
        f"({t:.1f}s); alignpair --platform {dev.platform} example-001 -> "
        f"{got['alignment']['2']} score {got['score']:.5f}")


def phase_parity(dev):
    from coati_tpu.checks import check_parity_group, check_stacked_tables

    with allocates_on(dev):
        for label, n in PARITY:
            check_parity_group(label, n)
            log(f"phase 4 parity: {label} (IUPAC) {n} pairs == oracle")
        check_stacked_tables(N_LEAVES)
    log(f"phase 4 parity: stacked tables (table_idx) {N_LEAVES} leaves "
        f"== oracle")


def phase_long_pair(dev, table, gap):
    from coati_tpu.checks import check_long_pair

    pair = one_pair(np.random.default_rng(SEED + 5), LONG_NT)
    with allocates_on(dev):
        r, t = timed(lambda: check_long_pair(pair, table, gap))
    log(f"phase 5 long pair: {len(pair[0])}x{len(pair[1])} nt segmented "
        f"path == native C++, score {r.score:.4f} ({t:.1f}s incl. native)")


def phase_sample(dev, table, gap):
    from coati_tpu.checks import check_sample

    pair = one_pair(np.random.default_rng(SEED + 6), SAMPLE_NT)
    with allocates_on(dev):
        (sdev, corners, samples), t = timed(
            lambda: check_sample(pair, table, gap, N_SAMPLES, seed=SEED))
    assert sdev == dev, sdev
    log(f"phase 6 sample: {len(pair[0])}x{len(pair[1])} nt forward on "
        f"{sdev.device_kind}, corner {max(corners):.4f} == native; "
        f"{len(samples)} draws x2 identical, all rescored ({t:.1f}s)")
    return pair


def phase_triplet(dev):
    import jax
    import jax.numpy as jnp

    import bench
    from coati_tpu.checks import check_triplet, triplet_model
    from coati_tpu.triplet_hmm import encode_triplet_pair
    from coati_tpu.triplet_wavefront import (
        _pack_batch,
        _triplet_rows,
        _triplet_traceback,
        triplet_align_batch,
    )

    n_pairs, nt, n_check = TRIPLET
    model = triplet_model()
    pairs = bench.make_pairs(n_pairs, np.random.default_rng(SEED + 7),
                             length_mix=[(nt, 1.0)])
    with allocates_on(dev):
        triplet_align_batch(model, pairs)  # compile
        results, t = timed(lambda: triplet_align_batch(model, pairs))
    check_triplet(model, pairs, results, n_check)

    enc = [encode_triplet_pair(model, a, d) for a, d in pairs]
    anc, des, lt, lm, off, tables, n_cod = _pack_batch(
        model, [e[0] for e in enc], [e[1] for e in enc])
    with jax.default_device(dev):  # part of jit's cache key
        aj, dj, io = jnp.asarray(anc), jnp.asarray(des), jnp.asarray(off)
        lt, lm = jnp.asarray(lt), jnp.asarray(lm)
        fwd = lambda: jax.block_until_ready(
            _triplet_rows(aj, dj, io, *tables, n_cod=n_cod))
        grid, amax = fwd()
        walk = lambda: jax.block_until_ready(_triplet_traceback(
            grid, amax, aj, dj, io, lt, lm, *tables, n_cod=n_cod))
        walk()
        t_fwd, t_walk = timed(fwd)[1], timed(walk)[1]
    log(f"phase 7 triplet: tri-mg {n_pairs}x{nt} nt in {t:.3f}s warm "
        f"(forward {t_fwd * 1e3:.1f} ms, walk {t_walk * 1e3:.1f} ms); "
        f"{n_check} pairs == host engine")


def _time_step(impl, cfg, table, gap, reps=3):
    """Best-of-reps device time (ms) of the fused fill + traceback step at
    one launched chunk's shape, on random codes of that shape."""
    import jax
    import jax.numpy as jnp

    from coati_tpu.align.engine import _align_step_jit
    from coati_tpu.align.wavefront import gap_consts_array

    rng = np.random.default_rng(0)
    B, NA, NB, k = cfg
    args = (
        jnp.asarray(rng.integers(0, 183, (B, NA)).astype(np.int32)),
        jnp.asarray(rng.integers(0, 4, (B, NB)).astype(np.int32)),
        jnp.full((B,), NA, jnp.int32), jnp.full((B,), NB, jnp.int32),
        jnp.asarray(table), jnp.asarray(gap_consts_array(gap)),
    )
    run = lambda: jax.block_until_ready(
        _align_step_jit(*args, k=k, impl=impl))
    run()
    return min(timed(run)[1] for _ in range(reps)) * 1e3


def phase_kernel_decision(dev, card, pairs, t_cuda, trace, sample_pair,
                          table, gap):
    from collections import Counter

    from coati_tpu.align.engine import viterbi_scores_batch
    from coati_tpu.checks import _encode

    shapes = Counter((c["B"], c["NA"], c["NB"], c["k"]) for c in trace)
    for cfg, n in sorted(shapes.items(), key=lambda kv: kv[0][2]):
        ms = {impl: _time_step(impl, cfg, table, gap)
              for impl in ("cuda", "xla")}
        log(f"phase 8 bucket B={cfg[0]} {cfg[1]}x{cfg[2]} x{n} chunks: "
            f"fill+traceback cuda {ms['cuda']:.2f} ms, "
            f"xla {ms['xla']:.2f} ms")
    with cuda_modes({"score", "forward"}):
        run_batch(pairs, table, gap)  # compile the XLA steps
        _, t_xla = timed(lambda: run_batch(pairs, table, gap))
    _, t_cuda2 = timed(lambda: run_batch(pairs, table, gap))
    log(f"phase 8 mixed batch end to end (viterbi): cuda {t_cuda:.3f}s / "
        f"{t_cuda2:.3f}s, xla {t_xla:.3f}s on {card}")

    enc_as, enc_bs = _encode(pairs)
    score_t = {}
    for impl, modes in (("cuda", {"viterbi", "score", "forward"}),
                        ("xla", {"viterbi", "forward"})):
        with cuda_modes(modes):
            viterbi_scores_batch(enc_as, enc_bs, table, gap)
            score_t[impl] = timed(lambda: viterbi_scores_batch(
                enc_as, enc_bs, table, gap))[1]
    log(f"phase 8 mixed batch score-only: cuda {score_t['cuda']:.3f}s, "
        f"xla {score_t['xla']:.3f}s")

    from coati_tpu.align.sample_device import sample_batch_device
    from coati_tpu.checks import _SampleAln
    from coati_tpu.driver import _forward_diag

    (ea,), (eb,) = _encode([sample_pair])

    def sample_long():
        Ms, Ds, Is, corners, _ = _forward_diag(ea, eb, _SampleAln(table, gap))
        return list(sample_batch_device(
            Ms, Ds, Is, corners, ea, eb, table, *sample_pair, gap, SEED,
            N_SAMPLES))

    sample_t = {}
    for impl, modes in (("cuda", {"viterbi", "score", "forward"}),
                        ("xla", {"viterbi", "score"}),
                        ("cuda", {"viterbi", "score", "forward"})):
        with cuda_modes(modes):
            sample_long()
            sample_t.setdefault(impl, []).append(timed(sample_long)[1])
    log(f"phase 8 sample {SAMPLE_NT} nt forward + {N_SAMPLES} device draws: "
        f"cuda {sample_t['cuda'][0]:.3f}s / {sample_t['cuda'][1]:.3f}s, "
        f"xla {sample_t['xla'][0]:.3f}s")


def main_one():
    from coati_tpu.checks import mg94_table
    from coati_tpu.structs import GapParams

    (dev,) = phase_device(1)
    card = card_line().splitlines()[0]  # for the timing lines
    table, gap = mg94_table(), GapParams()
    phase_compile(dev)
    pairs, results, t_warm, trace = phase_mixed_batch(dev, card, table, gap)
    phase_entry_points(dev, pairs, results)
    phase_parity(dev)
    phase_long_pair(dev, table, gap)
    sample_pair = phase_sample(dev, table, gap)
    phase_triplet(dev)
    phase_kernel_decision(dev, card, pairs, t_warm, trace, sample_pair,
                          table, gap)
    import jax

    return dev, len(jax.devices())


def main_four():
    """The engine's round-robin over four local GPUs against the same batch
    on one, and the shard_map mesh path against the engine."""
    from collections import Counter

    from coati_tpu import backend
    from coati_tpu.checks import align_pairs, compare_with_native, mg94_table
    from coati_tpu.parallel.mesh import make_mesh, sharded_viterbi_align_batch
    from coati_tpu.structs import GapParams

    devs = phase_device(4)
    card = card_line().splitlines()[0]  # for the timing lines
    table, gap = mg94_table(), GapParams()
    pairs = mixed_pairs()

    os.environ[backend.ENV_MAX_DEVICES] = "1"
    run_batch(pairs, table, gap)
    (one, _), t_one = timed(lambda: run_batch(pairs, table, gap))
    del os.environ[backend.ENV_MAX_DEVICES]
    run_batch(pairs, table, gap)
    (four, trace), t_four = timed(lambda: run_batch(pairs, table, gap))
    compare_with_native(four, [(r.seq0, r.seq1, r.score) for r in one],
                        rel=0.0)
    chunks = Counter(c["device"] for c in trace)
    cells = Counter()
    for c in trace:
        cells[c["device"]] += c["B"] * (c["NA"] + c["k"]) * (c["NB"] + c["k"])
    for d in devs:
        log(f"four: device {d.id} {chunks[d.id]} chunks, "
            f"{cells[d.id] / 1e9:.2f} Gcells (padded)")
    log(f"four: mixed batch {len(pairs)} pairs on 4 devices {t_four:.3f}s vs "
        f"1 device {t_one:.3f}s on {card}; strings and scores identical")

    # long pairs: the engine sends every one to the first device
    # (ROADMAP R3); allocation counts per card show where they ran
    from coati_tpu.checks import native_alignments

    rng = np.random.default_rng(SEED + 8)
    longs = [one_pair(rng, LONG_FOUR[1]) for _ in range(LONG_FOUR[0])]
    before = [alloc_count(d) for d in devs]
    long_res, t_long = timed(lambda: align_pairs(longs, table, gap))
    allocs = [alloc_count(d) - b for d, b in zip(devs, before)]
    compare_with_native(long_res, native_alignments(longs, table, gap))
    log(f"four: {len(longs)} long pairs of {LONG_FOUR[1]} nt {t_long:.1f}s "
        f"== native C++; device allocations during them: "
        + ", ".join(f"device {d.id} {a}" for d, a in zip(devs, allocs)))

    sub = pairs[:N_MESH_PAIRS]
    from coati_tpu.checks import _encode

    enc_as, enc_bs = _encode(sub)
    mesh = make_mesh(4, devs)
    args = (enc_as, enc_bs, [p[0] for p in sub], [p[1] for p in sub],
            table, gap, mesh)
    sharded_viterbi_align_batch(*args)  # compile
    mesh_res, t_mesh = timed(lambda: sharded_viterbi_align_batch(*args))
    compare_with_native(mesh_res, [(r.seq0, r.seq1, r.score)
                                   for r in one[:N_MESH_PAIRS]], rel=0.0)
    log(f"four: shard_map mesh ('data' x4) {len(sub)} pairs {t_mesh:.3f}s; "
        f"== engine on 1 device")
    return devs[0], 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths")
    args = ap.parse_args(argv)
    import jax

    dev, count = main_four() if args.four else main_one()
    assert len(jax.devices()) == count, jax.devices()
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
