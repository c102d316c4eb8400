"""High-level alignment drivers (reference align_marginal.cc:44-88, :536-594).

Viterbi alignment runs the batched engine (align/engine.py) on the devices
backend.py picks; sampling chooses its route by DP size (marg_sample).
"""

from __future__ import annotations

import sys

import numpy as np

from coati_tpu import utils
from coati_tpu.align import oracle
from coati_tpu.io import read_input, write_output
from coati_tpu.io.jsonio import write_json_sample
from coati_tpu.structs import AlignmentParams


def _viterbi_align(aln: AlignmentParams):
    """Viterbi-align aln.data.seqs[0/1] in place (engine dispatch)."""
    anc, des = aln.seq(0), aln.seq(1)
    enc_a, enc_b = utils.encode_marginal(anc, des)
    from coati_tpu.align.engine import viterbi_align_single

    s0, s1, score = viterbi_align_single(
        enc_a, enc_b, anc, des, aln.subst_matrix, aln.gap
    )
    aln.data.seqs = [s0, s1]
    aln.data.score = score


def marg_alignment(aln: AlignmentParams) -> bool:
    """Pairwise alignment with a marginal model (align_marginal.cc:44-88)."""
    aln.data = read_input(aln)
    utils.set_subst(aln)

    if aln.score:
        from coati_tpu.align.score import alignment_score

        print(f"{alignment_score(aln, aln.subst_matrix):g}")
        return True

    utils.process_marginal(aln)
    try:
        _viterbi_align(aln)
    except MemoryError:
        # mirror of the reference's bad_alloc guard (align_marginal.cc:72-75)
        print("ERROR: sequences to align exceed available memory.",
              file=sys.stderr)
        return False
    utils.restore_end_stops(aln.data, aln.gap)
    write_output(aln)
    return True


def _forward_diag(enc_a, enc_b, aln):
    """Run the Forward (log) wavefront on device; return the diagonal-layout
    state matrices [Dtot, C] (device arrays, b=0 slice) and the terminal-
    adjusted corner values (cm, cd, ci) as floats."""
    import jax
    import jax.numpy as jnp

    from coati_tpu import backend
    from coati_tpu.align.wavefront import dp_fill_jit, gap_consts_array

    k = aln.gap.len
    na, nb = len(enc_a), len(enc_b)
    dev = backend.devices()[0]
    with jax.default_device(dev):
        (cm, cd, ci), (Ms, Ds, Is) = dp_fill_jit(
            jnp.asarray(np.asarray(enc_a, np.int32)[None, :]),
            jnp.asarray(np.asarray(enc_b, np.int32)[None, :]),
            jnp.asarray([na], dtype=jnp.int32),
            jnp.asarray([nb], dtype=jnp.int32),
            jnp.asarray(np.asarray(aln.subst_matrix, dtype=np.float32)),
            jnp.asarray(gap_consts_array(aln.gap)),
            k=k, mode="forward", impl=backend.dp_impl(dev.platform, "forward"),
        )
    corners = (float(cm[0]), float(cd[0]), float(ci[0]))
    return Ms[:, 0, :], Ds[:, 0, :], Is[:, 0, :], corners, dev


def _forward_mdi(enc_a, enc_b, aln):
    """Host (i, j)-layout state matrices with the terminal-adjusted corner
    (the layout oracle.sampleback_mdi walks)."""
    import jax

    Ms, Ds, Is, corners, _ = _forward_diag(enc_a, enc_b, aln)
    k = aln.gap.len
    na, nb = len(enc_a), len(enc_b)
    Cc_full = nb + k
    Ms = np.asarray(jax.device_get(Ms))[:, :Cc_full]  # [Dtot, C]
    Ds = np.asarray(jax.device_get(Ds))[:, :Cc_full]
    Is = np.asarray(jax.device_get(Is))[:, :Cc_full]
    R, Cc = na + k, nb + k
    ii = np.arange(R)[:, None]
    jj = np.arange(Cc)[None, :]
    M = Ms[ii + jj, jj]
    D = Ds[ii + jj, jj]
    I = Is[ii + jj, jj]
    M[R - 1, Cc - 1] = corners[0]
    D[R - 1, Cc - 1] = corners[1]
    I[R - 1, Cc - 1] = corners[2]
    return M, D, I


def marg_sample(aln: AlignmentParams, sample_size: int, rng) -> None:
    """Sample alignments via Forward + stochastic traceback
    (align_marginal.cc:536-594)."""
    aln.data = read_input(aln)
    if aln.data.size() != 2:
        raise ValueError("Exactly two sequences required.")

    out_path = str(aln.output)
    if not out_path or out_path == "-":
        out = sys.stdout
        close = False
    else:
        try:
            out = open(out_path, "w")
        except OSError as exc:
            raise ValueError(f"Opening output file {aln.output} failed.") from exc
        close = True

    try:
        len_a = len(aln.seq(0))
        if len_a % 3 != 0 or len_a % aln.gap.len != 0:
            raise ValueError("Length of reference sequence must be multiple of 3.")
        if len(aln.seq(1)) % aln.gap.len != 0:
            raise ValueError(
                f"Length of descendant sequence must be multiple of {aln.gap.len}."
            )

        utils.trim_end_stops(aln.data)
        anc, des = aln.seq(0), aln.seq(1)
        enc_a, enc_b = utils.encode_marginal(anc, des)
        utils.set_subst(aln)

        stops = aln.data.stops
        n_cells = (len(enc_a) + aln.gap.len) * (len(enc_b) + aln.gap.len)
        from coati_tpu import native

        if n_cells <= 4_000_000 and native.available():
            # small/mid inputs: native C++ Forward + tracebacks drawing
            # the SAME Lehmer64 f24 stream as the Python oracle (verified
            # stream-exact: 0/2000 path mismatches, identical RNG
            # consumption) — full reference seed parity, ~50x the
            # pure-Python walk
            samples = native.sampleback_batch(
                enc_a, enc_b, aln.subst_matrix, aln.gap, anc, des,
                sample_size, rng,
            )
        elif n_cells <= 250_000:
            # native lib unavailable: pure-Python oracle (bit-parity with
            # the reference's Lehmer64 f24 draw stream)
            work = oracle.forward_oracle(
                enc_a, enc_b, aln.subst_matrix, aln.gap, "log", save_edges=True
            )
            samples = (
                oracle.sampleback(work, anc, des, aln.gap, rng)
                for _ in range(sample_size)
            )
        else:
            # large inputs: Forward DP on the accelerator, then ALL
            # tracebacks sampled in parallel on device (threefry stream
            # seeded from the Lehmer64 state — deterministic per seed)
            from coati_tpu.align.sample_device import sample_batch_device

            Ms, Ds, Is, corners, _ = _forward_diag(enc_a, enc_b, aln)
            samples = sample_batch_device(
                Ms, Ds, Is, corners, enc_a, enc_b, aln.subst_matrix,
                anc, des, aln.gap, rng.u64(), sample_size,
            )
        for i, (s0, s1, score) in enumerate(samples):
            aln.data.seqs = [s0, s1]
            aln.data.score = score
            aln.data.stops = list(stops)
            utils.restore_end_stops(aln.data, aln.gap)
            write_json_sample(aln.data, out, i, sample_size)
    finally:
        if close:
            out.close()
