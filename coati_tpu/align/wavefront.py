"""Batched anti-diagonal wavefront pair-HMM DP (XLA path).

A re-design of the reference's sequential cell loop
(align_pair.cc:94-129): one lax.scan step per anti-diagonal d = i + j,
computing every cell of the diagonal for every pair in the batch as wide
vector ops. The anti-diagonal order preserves the reference's exact
per-cell float32 operation order (every cell depends only on earlier
diagonals), so Viterbi results — including tie-breaking and therefore gap
placement — match the C++ implementation.

Layout: diagonal buffers are indexed by absolute column j (slot), shape
[B, C] with C = NB + k. Cell (i, j) lives on diagonal d = i + j at slot j.
Recurrence sources:
    match   <- diagonal d-2,  slot j-1   (i-1, j-1)
    delete  <- diagonal d-k,  slot j     (i-k, j)
    insert  <- diagonal d-k,  slot j-k   (i,   j-k)
so the scan carries a ring of the last max(k, 2) diagonals.

Outputs per mode:
    viterbi: packed 5-bit backpointers per cell (uint8, one byte per cell —
             12x smaller than the reference's three f32 matrices) plus the
             terminal-adjusted corner (M, D, I) scores per pair.
    forward: full (M, D, I) diagonals for stochastic traceback.
    score:   corner scores only (O(diag) memory).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from coati_tpu.constants import F32_LOWEST

# np (not jnp) scalar: a module-level jnp constant would initialize the
# XLA backend at import time, breaking jax.distributed.initialize for
# multi-host runs (it must run before any backend touch)
LOWEST = np.float32(F32_LOWEST)


def _lse(a, b):
    """f32 logSumExp mirroring the reference's piecewise log1p_exp
    (utils.hpp:134-156)."""
    mx = jnp.maximum(a, b)
    y = -jnp.abs(a - b)
    t = jnp.where(
        y <= jnp.float32(-16.0),
        jnp.exp(y),
        jnp.log1p(jnp.exp(jnp.minimum(y, jnp.float32(0.0)))),
    )
    return mx + t


def _shift_right(x, s):
    """result[..., j] = x[..., j-s] with LOWEST fill."""
    if s == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (s,), LOWEST, dtype=x.dtype)
    return jnp.concatenate([pad, x[..., :-s]], axis=-1)


def _argmax_mdi(m, d, i):
    """Reference max_mdi tie-preference: M unless D strictly greater,
    I only if strictly greater than both (align_pair.cc:210-221)."""
    code = jnp.where(d > m, jnp.uint8(1), jnp.uint8(0))
    best = jnp.maximum(m, d)
    return jnp.where(i > best, jnp.uint8(2), code)


def wavefront_impl(
    aseq,  # [B, NA] int32 in [0, 183) (padded with 0)
    bseq,  # [B, NB] int32 in [0, 15)  (padded with 0)
    lens_a,  # [B] int32 true ancestor lengths
    lens_b,  # [B] int32 true descendant lengths
    table,  # [183, 15] float32 marginal log-odds
    gap_consts,  # [4] float32: (no_gap, gap_stop, gap_open, gap_extend)
    *,
    k: int,
    semiring: str = "tropical",
    mode: str = "viterbi",
    unroll: int = 1,
    d_start=None,  # traced int32: first diagonal of this segment (default 0)
    n_steps: int | None = None,  # static: diagonals to run (default all)
    ring_init=None,  # [K, 3, B, C] f32: carried diagonals d_start-1..d_start-K
    corner_init=None,  # (cM, cD, cI) raw captured corners so far
    return_carry: bool = False,  # also return (ring_out, raw corners)
):
    """Anti-diagonal wavefront DP. With the segment arguments this computes
    diagonals [d_start, d_start + n_steps) from a carried ring state — the
    building block for O(n)-memory long-pair two-pass traceback
    (align/longseq.py); the defaults run the whole matrix in one call.
    Only the LAST segment's terminal-adjusted corner return is meaningful;
    segmented callers thread the raw carry instead."""
    B, NA = aseq.shape
    NB = bseq.shape[1]
    R = NA + k
    C = NB + k
    Dtot = R + C - 1
    if n_steps is None:
        n_steps = Dtot
    if d_start is None:
        d_start = jnp.int32(0)

    ng, gs, go, ge = (gap_consts[i] for i in range(4))
    gek1 = ge * jnp.float32(k - 1)
    gek = ge * jnp.float32(k)

    if semiring == "tropical":
        plus2 = jnp.maximum
    elif semiring == "log":
        plus2 = _lse
    else:
        raise ValueError(semiring)

    # --- emission lookup setup ------------------------------------------------
    # Cell (i, j) on diagonal d uses table[a[d-j-k], b[j-k]]. To keep
    # gathers out of the scan body, the lookup is split:
    #   TA[p, c, t] = table[a_rev_pad[p, t], c]   (one bulk gather, setup)
    #   sub[p, j]   = sum_c TA[p, c, d_slice + j] * onehot_b[p, c, j]
    # i.e. a dynamic slice plus a 15-term masked sum per diagonal.
    a_rev = jnp.flip(aseq, axis=1)  # a_rev[t] = a[NA-1-t]
    a_rev_pad = jnp.pad(a_rev, ((0, 0), (C, C + k)), constant_values=0)
    # TA: [B, 15, NA + 2C + k]
    TA = jnp.transpose(jnp.take(table, a_rev_pad, axis=0), (0, 2, 1))
    # b at slot j (j >= k): b[j-k]; one-hot over the 15 nucleotide codes
    b_slot = jnp.pad(bseq, ((0, 0), (k, 0)), constant_values=0)  # [B, C]
    oh_b = jax.nn.one_hot(b_slot, 15, axis=1, dtype=jnp.float32)  # [B, 15, C]

    j_iota = jnp.arange(C, dtype=jnp.int32)

    corner_d = lens_a + lens_b + jnp.int32(2 * (k - 1))  # [B]
    corner_j = lens_b + jnp.int32(k - 1)  # [B]

    K = max(k, 2)

    def empty_diag():
        return jnp.full((B, C), LOWEST, dtype=jnp.float32)

    def margins(d):
        """Values for margin cells of diagonal d (i==k-1 row / j==k-1 col)."""
        i_vec = d - j_iota  # [C]
        jf = j_iota.astype(jnp.float32)
        if_ = i_vec.astype(jnp.float32)
        m_marg = jnp.where(
            (i_vec == k - 1) & (j_iota == k - 1), jnp.float32(0.0), LOWEST
        )
        ins_ok = (
            (i_vec == k - 1)
            & (j_iota >= 2 * k - 1)
            & ((j_iota - (k - 1)) % k == 0)
        )
        i_marg = jnp.where(ins_ok, go + ge * (jf - 1.0), LOWEST)
        del_ok = (
            (j_iota == k - 1)
            & (i_vec >= 2 * k - 1)
            & ((i_vec - (k - 1)) % k == 0)
        )
        d_marg = jnp.where(del_ok, (ng + go) + ge * (if_ - 1.0), LOWEST)
        return m_marg[None, :], d_marg[None, :], i_marg[None, :]

    def step(carry, d):
        ring, (cM, cD, cI) = carry
        # ring[0] = diagonal d-1, ring[1] = d-2, ..., ring[K-1] = d-K
        prev2 = ring[1]
        prevk = ring[k - 1]

        # emission: sub[j] = table[a[d-j-k], b[j-k]] via slice + masked sum
        start = NA - 1 + k - d + C
        ta_sl = jax.lax.dynamic_slice_in_dim(TA, start, C, axis=2)
        sub = jnp.sum(ta_sl * oh_b, axis=1)

        p2M = _shift_right(prev2[0], 1)
        p2D = _shift_right(prev2[1], 1)
        p2I = _shift_right(prev2[2], 1)
        pkM, pkD, pkI = prevk
        pkMs = _shift_right(pkM, k)
        pkIs = _shift_right(pkI, k)

        # into-match (f32 op order identical to align_pair.cc:98-103)
        m2m = ((p2M + ng) + ng) + sub
        d2m = (p2D + gs) + sub
        i2m = ((p2I + gs) + ng) + sub
        # into-delete (:106-113)
        m2d = ((pkM + ng) + go) + gek1
        i2d = ((pkI + gs) + go) + gek1
        d2d = pkD + gek
        # into-insert (:116-119)
        m2i = (pkMs + go) + gek1
        i2i = pkIs + gek

        M = plus2(plus2(m2m, d2m), i2m)
        D = plus2(plus2(m2d, d2d), i2d)
        I = plus2(m2i, i2i)

        # masks: body cells vs margins vs out-of-matrix
        i_vec = d - j_iota
        body = (i_vec >= k) & (i_vec < R) & (j_iota >= k)
        m_marg, d_marg, i_marg = margins(d)
        M = jnp.where(body, M, m_marg)
        D = jnp.where(body, D, d_marg)
        I = jnp.where(body, I, i_marg)

        # capture pre-adjustment corner values for each pair
        sel = (d == corner_d)[:, None]
        idx = corner_j[:, None]
        cM = jnp.where(sel, jnp.take_along_axis(M, idx, axis=1), cM[:, None])[:, 0]
        cD = jnp.where(sel, jnp.take_along_axis(D, idx, axis=1), cD[:, None])[:, 0]
        cI = jnp.where(sel, jnp.take_along_axis(I, idx, axis=1), cI[:, None])[:, 0]

        new_ring = ((M, D, I),) + ring[: K - 1]

        if mode == "viterbi":
            # backpointers use the traceback's comparison values
            # (align_pair.cc:275-296), not the DP-form values, so strict-
            # inequality tie behavior matches the reference exactly.
            bp_m = _argmax_mdi((p2M + ng) + ng, p2D + gs, (p2I + gs) + ng)
            bp_d = _argmax_mdi((pkM + ng) + go, pkD + ge, (pkI + gs) + go)
            bp_i = jnp.where(pkMs + go > pkIs + ge, jnp.uint8(0), jnp.uint8(2))
            ys = bp_m | (bp_d << 2) | (bp_i << 4)
        elif mode == "forward":
            ys = (M, D, I)
        else:
            ys = None
        return (new_ring, (cM, cD, cI)), ys

    if ring_init is None:
        ring0 = tuple(
            (empty_diag(), empty_diag(), empty_diag()) for _ in range(K)
        )
    else:
        ring0 = tuple(
            (ring_init[q, 0], ring_init[q, 1], ring_init[q, 2])
            for q in range(K)
        )
    if corner_init is None:
        corner0 = (
            jnp.full((B,), LOWEST),
            jnp.full((B,), LOWEST),
            jnp.full((B,), LOWEST),
        )
    else:
        corner0 = corner_init
    (ring_out, (cM, cD, cI)), ys = jax.lax.scan(
        step,
        (ring0, corner0),
        jnp.arange(n_steps, dtype=jnp.int32) + d_start,
        unroll=unroll,
    )

    # terminal-state adjustment (align_pair.cc:130-138)
    cMa = (cM + ng) + ng
    cIa = (cI + gs) + ng
    cDa = cD + gs
    if return_carry:
        ring_arr = jnp.stack(
            [jnp.stack(ring_out[q], axis=0) for q in range(K)], axis=0
        )
        return (cMa, cDa, cIa), ys, (ring_arr, (cM, cD, cI))
    return (cMa, cDa, cIa), ys


wavefront = functools.partial(
    jax.jit,
    static_argnames=("k", "semiring", "mode", "unroll", "n_steps",
                     "return_carry"),
)(wavefront_impl)


def dp_fill(aseq, bseq, lens_a, lens_b, table, gap_consts, *, k: int,
            mode: str, impl: str):
    """The whole-matrix DP fill in `mode` ('viterbi', 'score' or 'forward',
    the last in the log semiring) by `impl` ('xla': wavefront_impl; 'cuda':
    kernels/wavefront.cu). Both return ((cM, cD, cI), ys); the CUDA kernel
    leaves ys outside each pair's (la + k) x (lb + k) rectangle unwritten.
    backend.dp_impl chooses `impl`."""
    if impl == "cuda":
        from coati_tpu.kernels.wavefront_cuda import wavefront_cuda

        return wavefront_cuda(aseq, bseq, lens_a, lens_b, table, gap_consts,
                              k=k, mode=mode)
    if impl != "xla":
        raise ValueError(impl)
    semiring = "log" if mode == "forward" else "tropical"
    return wavefront_impl(aseq, bseq, lens_a, lens_b, table, gap_consts,
                          k=k, semiring=semiring, mode=mode)


dp_fill_jit = functools.partial(
    jax.jit, static_argnames=("k", "mode", "impl")
)(dp_fill)


def traceback_ops_impl(bp, corners, lens_a, lens_b, *, k: int):
    """Device-side vectorized traceback walk.

    The per-pair walk is sequential, but all pairs in the batch advance one
    step per scan iteration; only the tiny op sequence [Dtot, B] int8
    leaves the device (the packed bp stack [Dtot, B, C] stays in device
    memory).

    Returns (ops, (start_state, score)): ops[s, p] is the s-th op walking
    BACKWARD from the corner (0=match, 1=delete, 2=insert, -1=inactive).
    """
    cM, cD, cI = corners
    S, B, C = bp.shape

    st0 = _argmax_mdi(cM, cD, cI).astype(jnp.int32)
    score = jnp.maximum(cM, jnp.maximum(cD, cI))
    i_end = jnp.int32(k - 1)
    i0 = lens_a + jnp.int32(k - 1)
    j0 = lens_b + jnp.int32(k - 1)

    # Diagonal-synchronous scan walk: stream the bp rows through a
    # lax.scan sweeping diagonals top-down with no gathers. Each pair
    # extracts its byte from the swept [B, C] plane with a one-hot lane
    # select and emits its op only when the sweep reaches its current
    # diagonal. Waiting iterations (the extra diagonal of an M step; k-1 of
    # D/I at k>1) emit -1 holes, which every downstream consumer skips
    # (string builders filter op < 0; the RLE encoder carries the last
    # valid op across holes).
    U2 = 4 if S % 4 == 0 else (2 if S % 2 == 0 else 1)
    c_iota = jnp.arange(C, dtype=jnp.int32)[None, :]
    bp_c = bp.reshape(S // U2, U2, B, C)
    d_vals = jnp.arange(S, dtype=jnp.int32).reshape(S // U2, U2)

    def body(carry, xs):
        i, j, st = carry
        blk, dv = xs
        op_rows = []
        for u in range(U2 - 1, -1, -1):
            alive = (i > i_end) | (j > k - 1)
            act = alive & ((i + j) == dv[u])
            oh = (c_iota == j[:, None]) & act[:, None]
            code = jnp.max(
                jnp.where(oh, blk[u], jnp.uint8(0)), axis=1
            ).astype(jnp.int32)
            nxt_m = code & 3
            nxt_d = (code >> 2) & 3
            nxt_i = (code >> 4) & 3
            nxt = jnp.where(st == 0, nxt_m,
                            jnp.where(st == 1, nxt_d, nxt_i))
            di = jnp.where(st == 0, 1, jnp.where(st == 1, k, 0))
            dj = jnp.where(st == 0, 1, jnp.where(st == 1, 0, k))
            op_rows.append(jnp.where(act, st, -1).astype(jnp.int8))
            i = jnp.where(act, i - di, i)
            j = jnp.where(act, j - dj, j)
            st = jnp.where(act, nxt, st)
        # ys blocks must be in ascending-d order so a plain reshape
        # reassembles the sweep
        return (i, j, st), jnp.stack(op_rows[::-1])  # [U2, B]

    _, ys = jax.lax.scan(body, (i0, j0, st0), (bp_c, d_vals), reverse=True)
    ops = jnp.flip(ys.reshape(S, B), axis=0)  # backward-walk order

    # left-align: drop the all-hole rows above the highest corner so the
    # first ~max(la+lb)+2k-1 rows hold every real op (the engine trims its
    # fetch to that bound)
    maxlalb = jnp.max(lens_a + lens_b)
    shift = jnp.maximum((S - 1) - (maxlalb + 2 * (k - 1)), 0)
    ops = jnp.roll(ops, -shift, axis=0)
    return ops, (st0, score)


traceback_ops = functools.partial(
    jax.jit, static_argnames=("k",)
)(traceback_ops_impl)


def gap_consts_array(gap) -> np.ndarray:
    from coati_tpu.align.semiring import gap_constants

    return np.array(gap_constants(gap.open, gap.extend), dtype=np.float32)
