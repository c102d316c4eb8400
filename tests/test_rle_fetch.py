"""Run-length-encoded result fetch (align/engine.py).

The batch engine fetches alignment results as a small RLE blob (one
transfer per chunk) instead of the full packed op stream; parity with the
full-stream path must be exact, including the overflow fallback for pairs
with more runs than the cap. Mirrors the reference's single canonical
alignment per pair (align_pair.cc:249-303)."""

import os

import numpy as np
import pytest

from coati_tpu.align.engine import (
    RLE_RUNS,
    _decode_rle_blob,
    fused_align_ops_rle_impl,
    runs_to_strings,
    viterbi_align_batch,
)
from coati_tpu.structs import GapParams
from coati_tpu.utils import encode_marginal


def _mutate(rng, anc, n_indels, k):
    nts = np.array(list("ACGT"))
    des = list(anc)
    for i in np.nonzero(rng.random(len(des)) < 0.08)[0]:
        des[i] = str(rng.choice(nts))
    des = "".join(des)
    for _ in range(n_indels):
        ln = k * int(rng.integers(1, 3))
        pos = int(rng.integers(0, max(1, len(des) - ln)))
        if rng.random() < 0.5:
            des = des[:pos] + des[pos + ln :]
        else:
            des = des[:pos] + "".join(rng.choice(nts, size=ln)) + des[pos:]
    return des


def _make(rng, n, n_cod, n_indels, k):
    from coati_tpu.constants import CODONS61

    codons = np.array(CODONS61)
    out = []
    for _ in range(n):
        anc = "".join(rng.choice(codons, size=n_cod))
        out.append((anc, _mutate(rng, anc, n_indels, k)))
    return out


def _run_both(pairs, table, gap, monkeypatch):
    enc = [encode_marginal(a, d) for a, d in pairs]
    args = (
        [e[0] for e in enc],
        [e[1] for e in enc],
        [p[0] for p in pairs],
        [p[1] for p in pairs],
        table,
        gap,
    )
    monkeypatch.setenv("COATI_TPU_FETCH_RLE", "0")
    full = viterbi_align_batch(*args)
    monkeypatch.setenv("COATI_TPU_FETCH_RLE", "1")
    rle = viterbi_align_batch(*args)
    return full, rle


@pytest.mark.parametrize("k", [1, 3])
def test_rle_parity_typical(mg94_table, monkeypatch, k):
    rng = np.random.default_rng(5)
    gap = GapParams(len=k)
    pairs = _make(rng, 40, 60, 2, k)
    full, rle = _run_both(pairs, mg94_table, gap, monkeypatch)
    for f, r in zip(full, rle):
        assert (f.seq0, f.seq1, f.score) == (r.seq0, r.seq1, r.score)


def test_rle_overflow_fallback(mg94_table, monkeypatch):
    """Pairs with more runs than RLE_RUNS must take the per-pair
    full-stream rebuild and still match exactly — in a chunk MIXING
    overflow and ordinary pairs, so the non-overflow pairs keep the RLE
    path while the rebuilt ones interleave correctly."""
    rng = np.random.default_rng(6)
    gap = GapParams(len=1)
    pairs = _make(rng, 4, 120, 40, 1)  # ~80 runs/pair >> cap
    pairs += _make(rng, 4, 120, 2, 1)  # ordinary pairs, same bucket

    import coati_tpu.align.engine as eng

    enc = [encode_marginal(a, d) for a, d in pairs]
    args = (
        [e[0] for e in enc], [e[1] for e in enc],
        [p[0] for p in pairs], [p[1] for p in pairs],
        mg94_table, gap,
    )
    monkeypatch.setenv("COATI_TPU_FETCH_RLE", "0")
    full = eng.viterbi_align_batch(*args)

    # install the spy ONLY around the RLE run — the full-stream run above
    # always calls ops_to_strings, which made the old assertion vacuous
    seen = {"overflow": 0}
    orig = eng.ops_to_strings

    def spy(*a, **kw):
        seen["overflow"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(eng, "ops_to_strings", spy)
    monkeypatch.setenv("COATI_TPU_FETCH_RLE", "1")
    rle = eng.viterbi_align_batch(*args)
    assert seen["overflow"] > 0, "overflow fallback never exercised"
    # per-pair rebuild: strictly fewer ops_to_strings calls than pairs
    # would mean whole-chunk fallback was NOT taken for ordinary pairs
    assert seen["overflow"] <= len(pairs)
    for f, r in zip(full, rle):
        assert (f.seq0, f.seq1, f.score) == (r.seq0, r.seq1, r.score)


def test_rle_16bit_guard(mg94_table, monkeypatch):
    """Chunks whose walk-length bound exceeds RLE_MAX_STEPS must be
    launched with rle=False (a >65535-step run would wrap its 16-bit
    length silently). Verified by shrinking the guard threshold and spying
    on the launch."""
    import coati_tpu.align.engine as eng

    rng = np.random.default_rng(8)
    gap = GapParams(len=1)
    pairs = _make(rng, 4, 80, 2, 1)  # la+lb ~ 480 >> patched guard
    enc = [encode_marginal(a, d) for a, d in pairs]
    args = (
        [e[0] for e in enc], [e[1] for e in enc],
        [p[0] for p in pairs], [p[1] for p in pairs],
        mg94_table, gap,
    )

    rle_flags = []
    orig = eng._align_step

    def spy(*a, **kw):
        rle_flags.append(kw.get("rle", False))
        return orig(*a, **kw)

    monkeypatch.setattr(eng, "_align_step", spy)
    monkeypatch.setenv("COATI_TPU_FETCH_RLE", "1")
    baseline = eng.viterbi_align_batch(*args)
    assert rle_flags and all(rle_flags), "control: RLE path taken normally"

    rle_flags.clear()
    monkeypatch.setattr(eng, "RLE_MAX_STEPS", 100)
    guarded = eng.viterbi_align_batch(*args)
    assert rle_flags and not any(rle_flags), (
        "guard did not force the full-stream path"
    )
    for f, r in zip(baseline, guarded):
        assert (f.seq0, f.seq1, f.score) == (r.seq0, r.seq1, r.score)


def test_blob_roundtrip(mg94_table):
    """Decode(encode(ops)) reproduces the run structure and score bits."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    gap = GapParams(len=1)
    pairs = _make(rng, 8, 40, 3, 1)
    enc = [encode_marginal(a, d) for a, d in pairs]
    NA = max(len(e[0]) for e in enc)
    NB = max(len(e[1]) for e in enc)
    aseq = np.zeros((8, NA), np.int32)
    bseq = np.zeros((8, NB), np.int32)
    la = np.array([len(e[0]) for e in enc], np.int32)
    lb = np.array([len(e[1]) for e in enc], np.int32)
    for i, (ea, eb) in enumerate(enc):
        aseq[i, : len(ea)] = ea
        bseq[i, : len(eb)] = eb
    from coati_tpu.align.wavefront import gap_consts_array

    gc = gap_consts_array(gap)
    packed, blob = fused_align_ops_rle_impl(
        jnp.asarray(aseq), jnp.asarray(bseq), jnp.asarray(la),
        jnp.asarray(lb), jnp.asarray(mg94_table), jnp.asarray(gc),
        k=1, impl="xla", nr=RLE_RUNS,
    )
    run_len, run_op, n_runs, score = _decode_rle_blob(
        np.asarray(blob), RLE_RUNS
    )
    # reconstruct via runs and via the op stream; both must agree
    from coati_tpu.align.engine import _unpack_ops, ops_to_strings

    ops = _unpack_ops(np.asarray(packed), packed.shape[0] * 4)[::-1]
    a_strs = [p[0] for p in pairs]
    b_strs = [p[1] for p in pairs]
    ref = ops_to_strings(ops, score, a_strs, b_strs, 1)
    got = runs_to_strings(run_len, run_op, n_runs, score, a_strs, b_strs, 1)
    assert (n_runs >= 1).all() and (n_runs <= RLE_RUNS).all()
    for f, r in zip(ref, got):
        assert (f.seq0, f.seq1, f.score) == (r.seq0, r.seq1, r.score)
    # per-pair run lengths sum to the true walk length
    steps = (ops >= 0).sum(axis=0)
    assert (run_len.sum(axis=0) == steps).all()
