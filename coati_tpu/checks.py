"""End-to-end correctness checks of the main path.

chip_smoke.py runs them on the GPU at full size; the test suite runs the
same functions on the CPU at small sizes (and on a GPU host under the `gpu`
marker). Each check raises AssertionError with the first mismatches and
returns what it compared, so callers can report counts.

References: align/oracle.py (the float32 mirror of the reference DP),
native/pairhmm.cc (the independent C++ reimplementation), align/score.py
(the reference's alignment scorer) and the host triplet engine.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
EXAMPLE_001 = (REPO / "tests" / "data" / "sampledata_golden"
               / "alignpair-001-fasta__a.fasta")
PI = (0.308, 0.185, 0.199, 0.308)


def mg94_table(t: float = 0.0133) -> np.ndarray:
    """The default mar-mg 183x15 marginal table (w=0.2, default pi)."""
    from coati_tpu.models import marginal_p, mg94_p

    return marginal_p(mg94_p(t, 0.2, PI), PI).astype(np.float32)


def _encode(pairs):
    from coati_tpu.utils import encode_marginal

    enc = [encode_marginal(a, d) for a, d in pairs]
    return [e[0] for e in enc], [e[1] for e in enc]


def _mismatch_report(bad, n):
    return f"{len(bad)} of {n} pairs differ; first: {bad[:3]}"


# --- parity groups: engine strings vs the NumPy oracle ------------------------
def parity_group(label: str, rng, n_pairs: int):
    """(gap, pairs) of one parity group: 'k1' and 'k3' carry IUPAC codes
    in ~5% of descendant positions (the 15-column emissions); 'acgt' has
    none. Ancestors are 2..max codons, descendants random lengths."""
    from coati_tpu.constants import CODONS61
    from coati_tpu.structs import GapParams

    k, max_codons, ambig_frac = {
        "k1": (1, 40, 0.05), "k3": (3, 30, 0.05), "acgt": (1, 22, 0.0),
    }[label]
    codons = np.array(CODONS61)
    ambig = np.array(list("RYSWKMBDHVN"))
    nts = np.array(list("ACGT"))
    pairs = []
    for _ in range(n_pairs):
        n_cod = int(rng.integers(2, max_codons + 1))
        anc = "".join(rng.choice(codons, size=n_cod))
        m = int(rng.integers(1, 2 * n_cod + 1)) * 3
        m = max(m - m % k, k)
        des = list(rng.choice(nts, size=m))
        for i in np.nonzero(rng.random(m) < ambig_frac)[0]:
            des[i] = str(rng.choice(ambig))
        pairs.append((anc, "".join(des)))
    return GapParams(len=k), pairs


def check_against_oracle(pairs, gap, table, table_idx=None, tables=None):
    """viterbi_align_batch vs oracle.forward_oracle + traceback: strings
    identical, scores within 1e-4. With table_idx, `table` is the stacked
    [G, 183, 15] table and `tables[g]` the one each pair's oracle uses."""
    from coati_tpu.align import oracle
    from coati_tpu.align.engine import viterbi_align_batch

    enc_as, enc_bs = _encode(pairs)
    results = viterbi_align_batch(
        enc_as, enc_bs, [p[0] for p in pairs], [p[1] for p in pairs],
        table, gap, table_idx=table_idx,
    )
    bad = []
    for n, ((anc, des), ea, eb, r) in enumerate(
        zip(pairs, enc_as, enc_bs, results)
    ):
        t = table if table_idx is None else tables[table_idx[n]]
        w = oracle.forward_oracle(ea, eb, t, gap, "tropical")
        s0, s1, score = oracle.traceback(w, anc, des, gap)
        if (r.seq0, r.seq1) != (s0, s1) or abs(r.score - score) > 1e-4:
            bad.append((anc, des, r.seq0, r.seq1, r.score, s0, s1, score))
    assert not bad, _mismatch_report(bad, len(pairs))
    return len(pairs)


def check_parity_group(label: str, n_pairs: int, seed: int = 20260819):
    gap, pairs = parity_group(label, np.random.default_rng(seed), n_pairs)
    return check_against_oracle(pairs, gap, mg94_table())


def check_stacked_tables(n_leaves: int, seed: int = 20260819):
    """The msa path: every leaf against one reference in ONE engine call,
    per-leaf branch-length tables stacked [G, 183, 15] and selected by
    table_idx (msa.align_leafs), each leaf checked against the oracle
    under its own table."""
    from coati_tpu.structs import GapParams

    rng = np.random.default_rng(seed)
    _, pairs = parity_group("acgt", rng, n_leaves)
    ref = pairs[0][0]
    pairs = [(ref, des) for _, des in pairs]
    lengths = sorted({round(float(t), 4)
                      for t in rng.uniform(0.01, 0.6, n_leaves)})
    tables = [mg94_table(t) for t in lengths]
    table_idx = [int(i) for i in rng.integers(0, len(tables), n_leaves)]
    return check_against_oracle(pairs, GapParams(), np.stack(tables),
                                table_idx=table_idx, tables=tables)


# --- native C++ reference -----------------------------------------------------
def native_alignments(pairs, table, gap, threads: int | None = None):
    """native.viterbi_align for each pair (the C++ fill runs outside the
    GIL, so a thread pool spreads it over the host's cores)."""
    from coati_tpu import native

    enc_as, enc_bs = _encode(pairs)
    native.build()

    def one(n):
        return native.viterbi_align(enc_as[n], enc_bs[n], pairs[n][0],
                                    pairs[n][1], gap, table)

    workers = threads or min(16, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(one, range(len(pairs))))


def compare_with_native(results, natives, rel: float = 1e-5):
    """Strings identical and scores within `rel` (relative) of native."""
    bad = []
    for n, (r, (s0, s1, sc)) in enumerate(zip(results, natives)):
        if (r.seq0, r.seq1) != (s0, s1) or (
            abs(r.score - sc) > rel * max(abs(sc), 1.0)
        ):
            bad.append((n, r.score, sc))
    assert not bad, _mismatch_report(bad, len(results))
    return len(results)


def align_pairs(pairs, table, gap, **kw):
    from coati_tpu.align.engine import viterbi_align_batch

    enc_as, enc_bs = _encode(pairs)
    return viterbi_align_batch(enc_as, enc_bs, [p[0] for p in pairs],
                               [p[1] for p in pairs], table, gap, **kw)


def check_long_pair(pair, table, gap, long_slots: int | None = None):
    """A pair beyond the engine's long-pair bound takes the segmented
    two-pass path; its strings must equal native's exactly."""
    from coati_tpu.align.engine import LONG_PAIR_SLOTS

    bound = LONG_PAIR_SLOTS if long_slots is None else long_slots
    assert len(pair[1]) + gap.len > bound, "pair is not long for the engine"
    (r,) = align_pairs([pair], table, gap, long_slots=long_slots)
    (nat,) = native_alignments([pair], table, gap)
    assert (r.seq0, r.seq1) == nat[:2], "long pair strings differ from native"
    assert abs(r.score - nat[2]) <= 1e-5 * max(abs(nat[2]), 1.0), (
        r.score, nat[2])
    return r


# --- the user entry points ------------------------------------------------------
def untrimmed(pairs):
    """Indices of pairs the CLI passes to the engine unchanged (no
    terminal stop codon to trim)."""
    from coati_tpu import utils
    from coati_tpu.structs import SeqData

    keep = []
    for n, (a, d) in enumerate(pairs):
        data = SeqData(names=["a", "d"], seqs=[a, d])
        utils.trim_end_stops(data)
        if data.stops == ["", ""]:
            keep.append(n)
    return keep


def check_batch_cli(pairs, expected, workdir, platform: str | None = None):
    """`batch` verb on a FASTA of `pairs` (none with a terminal stop): its
    JSONL must hold `expected`'s strings and scores, pair for pair."""
    from coati_tpu.cli import main

    workdir = Path(workdir)
    fasta = workdir / "pairs.fasta"
    with open(fasta, "w") as fh:
        for n, (a, d) in enumerate(pairs):
            fh.write(f">p{n}a\n{a}\n>p{n}d\n{d}\n")
    out = workdir / "pairs.jsonl"
    argv = ["batch", str(fasta), "-o", str(out)]
    if platform:
        argv += ["--platform", platform]
    assert main(argv) == 0, "batch verb failed"
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == len(pairs), (len(rows), len(pairs))
    bad = []
    for row in rows:
        n = row["pair"]
        r = expected[n]
        got = (row["alignment"][f"p{n}a"], row["alignment"][f"p{n}d"])
        if got != (r.seq0, r.seq1) or row["score"] != float(
            np.float32(r.score)
        ):
            bad.append((n, got, row["score"], r.seq0, r.seq1, r.score))
    assert not bad, _mismatch_report(bad, len(rows))
    return len(rows)


def check_alignpair_example(workdir, platform: str | None = None):
    """`alignpair` on example-001 (the golden alignment, gaps stripped):
    CT----ATAGTG at score ~1.50913."""
    from coati_tpu.cli import main

    lines = EXAMPLE_001.read_text().splitlines()
    workdir = Path(workdir)
    inp = workdir / "example-001.fasta"
    inp.write_text("".join(
        ln.replace("-", "") + "\n" for ln in lines
    ))
    out = workdir / "example-001.json"
    argv = ["alignpair", str(inp), "-o", str(out)]
    if platform:
        argv += ["--platform", platform]
    assert main(argv) == 0, "alignpair failed"
    got = json.loads(out.read_text())
    assert got["alignment"]["2"] == "CT----ATAGTG", got
    assert abs(got["score"] - 1.50913) < 1e-5, got
    return got


# --- sampling -------------------------------------------------------------------
class _SampleAln:
    def __init__(self, table, gap):
        self.subst_matrix = table
        self.gap = gap


def check_sample(pair, table, gap, n: int, seed: int = 20260817):
    """Forward on the device, then n device draws, twice with one seed.
    The corner must agree with native.forward_score within 1e-4 relative
    (log semiring: exp/log1p differ by ulps between backends); both draws
    identical; every path a valid alignment of the pair, and its score
    (log posterior) plus the forward total equal to align/score.py's
    rescore within 1e-4 relative. Returns (device, corners, samples)."""
    from coati_tpu import native
    from coati_tpu.align.sample_device import sample_batch_device
    from coati_tpu.align.score import alignment_score
    from coati_tpu.driver import _forward_diag
    from coati_tpu.structs import AlignmentParams, SeqData

    a, b = pair
    (ea,), (eb,) = _encode([pair])
    Ms, Ds, Is, corners, dev = _forward_diag(ea, eb, _SampleAln(table, gap))
    assert {d.platform for d in Ms.devices()} == {dev.platform}
    ref = native.forward_score(ea, eb, table, gap)
    top = max(corners)
    assert abs(top - ref) <= 1e-4 * max(abs(ref), 1.0), (corners, ref)

    def draw():
        return list(sample_batch_device(Ms, Ds, Is, corners, ea, eb, table,
                                        a, b, gap, seed, n))

    first, second = draw(), draw()
    assert first == second, "same seed, different draws"
    total = float(np.logaddexp.reduce(np.asarray(corners, np.float64)))
    bad = []
    for s0, s1, sc in first:
        assert len(s0) == len(s1) and s0.replace("-", "") == a \
            and s1.replace("-", "") == b, "sampled path is not an alignment"
        aln = AlignmentParams()
        aln.gap = gap
        aln.data = SeqData(names=["a", "b"], seqs=[s0, s1])
        rescore = alignment_score(aln, table)
        if abs(sc + total - rescore) > 1e-4 * max(abs(rescore), 1.0):
            bad.append((sc, total, rescore))
    assert not bad, _mismatch_report(bad, n)
    return dev, corners, first


# --- triplet --------------------------------------------------------------------
def triplet_model():
    from coati_tpu.structs import AlignmentParams
    from coati_tpu.triplet_hmm import build_triplet_model

    aln = AlignmentParams()
    aln.model = "tri-mg"
    return build_triplet_model(aln)


def check_triplet(model, pairs, results, n_check: int):
    """The first n_check device results vs the host triplet engine:
    strings equal, scores within 1e-5."""
    from coati_tpu.triplet_hmm import triplet_align

    bad = []
    for (anc, des), (s0, s1, sc) in list(zip(pairs, results))[:n_check]:
        h0, h1, hsc = triplet_align(model, anc, des)
        if (s0, s1) != (h0, h1) or abs(sc - hsc) > 1e-5:
            bad.append((anc[:30], sc, hsc))
    assert not bad, _mismatch_report(bad, n_check)
    return n_check
