"""Long-pair Viterbi alignment with O(n) memory: segmented two-pass traceback.

The reference benchmarks pairs to 32 knt and ships 160 knt sampledata
(benchmark/data/benchmark_32k.fasta, sampledata/example-160k.fasta); its
3-matrix layout (align_pair.hpp:118-147) still costs O(n*m) floats. Storing
full backpointers here would cost Dtot*C bytes — ~4 GB at 32 knt and
impossible at 160 knt — so the DP runs in diagonal segments instead:

  pass 1 (forward): run the wavefront scan segment by segment, carrying the
    K=max(k,2)-diagonal ring state; checkpoint the ring entering each
    segment (K*3*C floats each — O(n) total for fixed segment count).
  pass 2 (traceback): walk backward from the corner; for each segment (last
    to first) recompute its T diagonals FROM its checkpoint with packed
    backpointers [T, 1, C] held on device only for the lifetime of that
    segment's walk, then step the walk through it with a while_loop.

Peak memory: one segment of backpointers (T*C bytes) + checkpoints
(Dtot/T * K*3*C*4 B) — e.g. ~850 MB total for a 160 knt pair at T=4096 vs
~25 GB for full bp. Compute cost is 2x one full DP sweep (fill + recompute),
the classic checkpointed-DP trade.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from coati_tpu.align.wavefront import (
    _argmax_mdi,
    gap_consts_array,
    wavefront_impl,
)


@functools.partial(
    jax.jit, static_argnames=("k", "n_steps", "mode")
)
def _segment(aseq, bseq, la, lb, table, gc, ring, corners, d0, *, k,
             n_steps, mode):
    """One segment of the wavefront DP from a carried ring state.

    mode='score': returns (adjusted corners, carry) — pass 1.
    mode='viterbi': also returns the segment's packed bp [n_steps, B, C]."""
    adj, ys, carry = wavefront_impl(
        aseq, bseq, la, lb, table, gc,
        k=k, semiring="tropical", mode=mode,
        d_start=d0, n_steps=n_steps, ring_init=ring, corner_init=corners,
        return_carry=True,
    )
    return adj, ys, carry


@functools.partial(jax.jit, static_argnames=("k",))
def _walk_segment(bp_seg, d0, i, j, st, s, ops, *, k):
    """Advance the backward traceback walk through one segment.

    bp_seg holds diagonals [d0, d0 + T); the walk proceeds while the current
    cell's diagonal i+j lies inside the segment, then parks until the caller
    supplies the previous segment. Op semantics identical to
    wavefront.traceback_ops_impl."""
    T, B, C = bp_seg.shape
    rows = jnp.arange(B, dtype=jnp.int32)
    max_steps = ops.shape[0]

    def cond(carry):
        i, j, st, s, ops = carry
        active = ((i > k - 1) | (j > k - 1)) & (i + j >= d0)
        return (s < max_steps) & jnp.any(active)

    def body(carry):
        i, j, st, s, ops = carry
        active = ((i > k - 1) | (j > k - 1)) & (i + j >= d0)
        code = bp_seg[jnp.clip(i + j - d0, 0, T - 1), rows, j].astype(
            jnp.int32
        )
        nxt_m = code & 3
        nxt_d = (code >> 2) & 3
        nxt_i = (code >> 4) & 3
        nxt = jnp.where(st == 0, nxt_m, jnp.where(st == 1, nxt_d, nxt_i))
        di = jnp.where(st == 0, 1, jnp.where(st == 1, k, 0))
        dj = jnp.where(st == 0, 1, jnp.where(st == 1, 0, k))
        op = jnp.where(active, st, -1).astype(jnp.int8)
        ops = jax.lax.dynamic_update_slice(ops, op[None, :], (s, 0))
        i = jnp.where(active, i - di, i)
        j = jnp.where(active, j - dj, j)
        st = jnp.where(active, nxt, st)
        return (i, j, st, s + 1, ops)

    return jax.lax.while_loop(cond, body, (i, j, st, s, ops))


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def _pad_group(enc_as, enc_bs, quantum: int):
    """Pad a group of encoded pairs to one shared [B, NA]/[B, NB] shape
    (group max, rounded up to the quantum so repeated calls share
    compiled executables)."""
    B = len(enc_as)
    NA = _round_up(max(max(len(a) for a in enc_as), quantum), quantum)
    NB = _round_up(max(max(len(b) for b in enc_bs), quantum), quantum)
    aseq = np.zeros((B, NA), np.int32)
    bseq = np.zeros((B, NB), np.int32)
    for p, (a, b) in enumerate(zip(enc_as, enc_bs)):
        aseq[p, : len(a)] = a
        bseq[p, : len(b)] = b
    la = jnp.asarray([len(a) for a in enc_as], jnp.int32)
    lb = jnp.asarray([len(b) for b in enc_bs], jnp.int32)
    return aseq, bseq, la, lb, NA, NB


def _viterbi_align_long_xla(
    enc_as, enc_bs, a_strs, b_strs, table, gap, *, seg_diagonals: int,
    quantum: int,
):
    """The batched two-pass segmented sweep on the XLA scan."""
    from coati_tpu.align.engine import ops_to_strings

    k = int(gap.len)
    gc = jnp.asarray(gap_consts_array(gap))
    table32 = jnp.asarray(np.asarray(table, dtype=np.float32))
    aseq, bseq, la, lb, NA, NB = _pad_group(enc_as, enc_bs, quantum)
    aseq = jnp.asarray(aseq)
    bseq = jnp.asarray(bseq)
    B, C = aseq.shape[0], NB + k
    K = max(k, 2)
    Dtot = (NA + k) + C - 1
    T = int(seg_diagonals)
    n_seg = -(-Dtot // T)

    from coati_tpu.constants import F32_LOWEST

    ring = jnp.full((K, 3, B, C), np.float32(F32_LOWEST))
    corners = (
        jnp.full((B,), np.float32(F32_LOWEST)),
        jnp.full((B,), np.float32(F32_LOWEST)),
        jnp.full((B,), np.float32(F32_LOWEST)),
    )

    # ---- pass 1: forward sweep, checkpoint the ring entering each segment
    ckpts = []
    adj = None
    for s in range(n_seg):
        ckpts.append((ring, corners))
        adj, _, (ring, corners) = _segment(
            aseq, bseq, la, lb, table32, gc, ring, corners,
            jnp.int32(s * T), k=k, n_steps=T, mode="score",
        )
    cM, cD, cI = adj  # terminal-adjusted corners from the last segment

    st = _argmax_mdi(cM, cD, cI).astype(jnp.int32)
    score = jnp.maximum(cM, jnp.maximum(cD, cI))
    i = la + jnp.int32(k - 1)
    j = lb + jnp.int32(k - 1)
    s_steps = jnp.int32(0)
    ops = jnp.full((Dtot, B), -1, dtype=jnp.int8)

    # ---- pass 2: recompute each segment's bp from its checkpoint, walk it.
    # Every dispatch chains asynchronously on device, with no host sync per
    # segment (a square pair's walk traverses every segment anyway).
    # Trailing padding segments above the highest corner are skipped
    # statically.
    max_corner = max(
        len(a) + len(b) for a, b in zip(enc_as, enc_bs)
    ) + 2 * (k - 1)
    for seg in range(n_seg - 1, -1, -1):
        if seg * T > max_corner:
            continue
        ring_s, corners_s = ckpts[seg]
        _, bp_seg, _ = _segment(
            aseq, bseq, la, lb, table32, gc, ring_s, corners_s,
            jnp.int32(seg * T), k=k, n_steps=T, mode="viterbi",
        )
        i, j, st, s_steps, ops = _walk_segment(
            bp_seg, jnp.int32(seg * T), i, j, st, s_steps, ops, k=k
        )

    ops_h, score_h = (
        np.asarray(x) for x in jax.device_get((ops, score))
    )
    return ops_to_strings(ops_h[::-1], score_h, a_strs, b_strs, k)


# long pairs batched per segmented sweep, at most
LONG_BATCH_MAX = 8
# cap on pass-1 checkpoint bytes; bounds the batch width for very long
# pairs (checkpoints are per-batch: n_seg * ~16 planes * B * C * 4 B)
LONG_CKPT_BYTES = 4 << 30


def long_batch_width(nb: int, k: int = 1, seg_diagonals: int = 4096,
                     quantum: int = 512) -> int:
    """How many long pairs of descendant length <= nb to batch per sweep."""
    NB = _round_up(max(nb, quantum), quantum)
    C = NB + k
    Dtot = C + NB + 2 * k  # ~worst case NA ~ NB
    n_seg = -(-Dtot // seg_diagonals)
    # per-pair checkpoint: a ring of up to max(k, 2) diagonals x 3 states
    # of C floats per segment; 32 planes leaves headroom
    per_b = n_seg * 32 * C * 4
    return max(1, min(LONG_BATCH_MAX, LONG_CKPT_BYTES // max(per_b, 1)))


def viterbi_align_long_batch(
    enc_as, enc_bs, a_strs, b_strs, table, gap, *,
    seg_diagonals: int = 4096, quantum: int = 512,
):
    """Viterbi-align a GROUP of long pairs with bounded memory, all pairs
    in one batched segmented sweep (pad to the group max — callers should
    group pairs of similar length). Returns a list of engine.AlignResult;
    strings/scores identical to the full-bp path."""
    return _viterbi_align_long_xla(
        enc_as, enc_bs, a_strs, b_strs, table, gap,
        seg_diagonals=int(seg_diagonals), quantum=quantum,
    )


def viterbi_align_long(
    enc_a, enc_b, a_str, b_str, table, gap, *, seg_diagonals: int = 4096,
    quantum: int = 512,
):
    """Viterbi-align one long pair with bounded memory (batch of 1)."""
    return viterbi_align_long_batch(
        [enc_a], [enc_b], [a_str], [b_str], table, gap,
        seg_diagonals=seg_diagonals, quantum=quantum,
    )[0]
