"""Batched device forward for the triplet (codon-context) pair-HMM.

Replacement for the compute-heavy half of the reference FST path
(align_fst.cc:45-150): the codon-channel DP runs as a lax.scan over CODON
steps, carrying only the lane-collapsed rows [B, Cc]. The 61 descendant-
codon lanes exist solely INSIDE one scan step (three unrolled row updates,
[B, 61, Cc] — phase is static per unrolled row, so the codon-entry collapse
and the per-phase emission tables involve no dynamic masking), which is why
a row sweep beats an anti-diagonal wavefront here: a diagonal mixes all
three phases, forcing per-slot phase selects and a sliding entry-cost
window.

The in-row insertion recurrence I[j] = max(M[j-1]+go, I[j-1]+ge) + e[j-1]
is solved by the prefix-max closed form (jax.lax.cummax), keeping each row
update a fixed number of full-width vector ops.

Outputs: every lane-collapsed codon-boundary row (the O(n/3 * m) f32
checkpoint grid the host traceback walks with per-block recompute,
triplet_hmm.traceback_from_boundaries) plus per-pair terminal scores.
Arithmetic is float32 throughout; the host recompute runs in float32 too,
so walk decisions agree with device boundaries.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from coati_tpu import backend
from coati_tpu import constants as C

NEG = np.float32(-1.0e30)

import os as _os


def _max3(a, b, c):
    return jnp.maximum(jnp.maximum(a, b), c)


@functools.partial(jax.jit, static_argnames=("n_cod", "keep_grid"))
def _triplet_rows_carry(anc_cods, des_codes, ins_off, logP64, match_emit,
                        gc, carry, *, n_cod: int, keep_grid: bool = True):
    """Factored forward sweep over n_cod codon steps from a carried
    collapsed boundary (see triplet_hmm._DP: 4 + 16 + 16 row variants
    instead of 3 x 61 laned rows; every f32 add mirrors the host
    expression tree bit-for-bit).

    anc_cods: [B, n_cod] int32 codon61 indices (padded arbitrarily)
    des_codes: [B, m] int32 in [0, 5)  (4 = N; padding arbitrary)
    ins_off: [B, m + 1] f32 insertion run offsets, computed on HOST numpy
        (cumsum grouping must match the host engine bit-for-bit; an
        in-graph cumsum may reassociate)
    logP64: [61, 64] f32 codon64-indexed entry costs (NEG at stops)
    match_emit: [4, 5] f32
    gc: [4] f32 (ng, gs, go, ge)
    carry: (Mc, Dc, Ic) [B, Cc] collapsed boundary entering the segment

    Returns ((boundaries [n_cod, 3, B, Cc] f32, amax [n_cod, 3, B, Cc]
    int32 CODON64 lanes) or (None, None) with keep_grid=False, plus the
    exiting carry) — the building block of the segmented O(n)-memory
    long-triplet path."""
    B, m = des_codes.shape
    Cc = m + 1
    ng, gs, go, ge = (gc[i] for i in range(4))
    ng_ng = ng + ng
    gs_ng = gs + ng
    ng_go = ng + go
    gs_go = gs + go
    go_ge = go - ge

    # E[b, x, j] = match emission of intermediate nucleotide x at column j
    E = jnp.concatenate(
        [
            jnp.zeros((B, 4, 1), jnp.float32),
            jnp.transpose(match_emit[:4, des_codes], (1, 0, 2)),
        ],
        axis=2,
    )  # [B, 4, Cc]

    def shiftmax3(M, D, I):
        body = _max3(
            M[..., :-1] + ng_ng, D[..., :-1] + gs, I[..., :-1] + gs_ng
        )
        pad = jnp.full(M.shape[:-1] + (1,), NEG, jnp.float32)
        return jnp.concatenate([pad, body], axis=-1)

    def dmax3(M, D, I):
        return _max3(M + ng_go, D + ge, I + gs_go)

    def row_ins(M, off):
        run = jax.lax.cummax(M - off, axis=M.ndim - 1)
        pad = jnp.full(M.shape[:-1] + (1,), NEG, jnp.float32)
        return jnp.concatenate(
            [pad, run[..., :-1] + (off[..., 1:] + go_ge)], axis=-1
        )

    g16 = jnp.arange(16, dtype=jnp.int32)[None, :, None]
    u_iota = jnp.arange(Cc, dtype=jnp.int32)[None, :]
    neg_inf = jnp.float32(-np.inf)

    def at_g(vals, g):
        """vals[b, g[b, j], j] without a gather: 16-wide masked max."""
        return jnp.max(
            jnp.where(g16 == g[:, None, :], vals, -1), axis=1
        )

    def step(carry, t):
        Mc, Dc, Ic = carry  # collapsed [B, Cc]
        cods = jax.lax.dynamic_index_in_dim(
            anc_cods, t, axis=1, keepdims=False
        )  # [B]
        cost = logP64[cods].reshape(B, 16, 4)  # [B, 16, 4]

        core1 = shiftmax3(Mc, Dc, Ic)                      # [B, Cc]
        M1 = core1[:, None, :] + E                          # [B, 4, Cc]
        D1 = dmax3(Mc, Dc, Ic)                              # [B, Cc]
        I1 = row_ins(M1, ins_off[:, None, :])               # [B, 4, Cc]
        D1b = jnp.broadcast_to(D1[:, None, :], M1.shape)
        core2 = shiftmax3(M1, D1b, I1)                      # [B, 4, Cc]
        M2 = (core2[:, :, None, :] + E[:, None]).reshape(B, 16, Cc)
        D2 = dmax3(M1, D1b, I1)                             # [B, 4, Cc]
        I2 = row_ins(M2, ins_off[:, None, :])               # [B, 16, Cc]
        D2g = jnp.repeat(D2, 4, axis=1)                     # [B, 16, Cc]
        core3 = shiftmax3(M2, D2g, I2)                      # [B, 16, Cc]
        D3 = dmax3(M2, D2g, I2)                             # [B, 16, Cc]
        ce = cost[:, :, :, None] + E[:, None, :, :]         # [B, 16, 4, Cc]
        K = jnp.max(ce, axis=2)                             # [B, 16, Cc]
        Kpay = jnp.argmax(ce, axis=2).astype(jnp.int32)     # first-max x3
        Mlane = core3 + K
        KD = jnp.max(cost, axis=2)                          # [B, 16]
        KDpay = jnp.argmax(cost, axis=2).astype(jnp.int32)
        Dlane = D3 + KD[:, :, None]

        Mc2 = jnp.max(Mlane, axis=1)
        gM = jnp.argmax(Mlane, axis=1).astype(jnp.int32)    # [B, Cc]
        amaxM = gM * 4 + at_g(Kpay, gM)
        Dc2 = jnp.max(Dlane, axis=1)
        gD = jnp.argmax(Dlane, axis=1).astype(jnp.int32)
        amaxD = gD * 4 + at_g(
            jnp.broadcast_to(KDpay[:, :, None], Kpay.shape), gD
        )
        W = Mlane - ins_off[:, None, :]
        Wstar = jnp.max(W, axis=1)
        gW = jnp.argmax(W, axis=1).astype(jnp.int32)
        lane_at_u = gW * 4 + at_g(Kpay, gW)                 # [B, Cc]
        run = jax.lax.cummax(Wstar, axis=1)
        Ic2 = jnp.concatenate(
            [
                jnp.full((B, 1), NEG, jnp.float32),
                run[:, :-1] + (ins_off[:, 1:] + go_ge),
            ],
            axis=1,
        )
        prev_run = jnp.concatenate(
            [jnp.full((B, 1), neg_inf), run[:, :-1]], axis=1
        )
        newmax = Wstar > prev_run
        code = jnp.where(newmax, u_iota * 64 + lane_at_u, -1)
        code_run = jax.lax.cummax(code, axis=1)
        amaxI = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), code_run[:, :-1] % 64], axis=1
        )
        amax = jnp.stack([amaxM, amaxD, amaxI], axis=0)      # [3, B, Cc]
        ys = (jnp.stack([Mc2, Dc2, Ic2], axis=0), amax) if keep_grid else None
        return (Mc2, Dc2, Ic2), ys

    out_carry, ys = jax.lax.scan(
        step, carry, jnp.arange(n_cod, dtype=jnp.int32)
    )
    if keep_grid:
        return ys[0], ys[1], out_carry
    return None, None, out_carry


def triplet_init_carry(des_codes, ins_off, gc):
    """Boundary row 0 (identical to the host init_row)."""
    B, m = des_codes.shape
    Cc = m + 1
    go_ge = gc[2] - gc[3]
    M0 = jnp.full((B, Cc), NEG, jnp.float32).at[:, 0].set(0.0)
    D0 = jnp.full((B, Cc), NEG, jnp.float32)
    run = jax.lax.cummax(M0 - ins_off, axis=1)
    I0 = jnp.concatenate(
        [
            jnp.full((B, 1), NEG, jnp.float32),
            run[:, :-1] + (ins_off[:, 1:] + go_ge),
        ],
        axis=1,
    )
    return M0, D0, I0


@functools.partial(jax.jit, static_argnames=("n_cod",))
def _triplet_rows(anc_cods, des_codes, ins_off, logP64, match_emit, gc, *,
                  n_cod: int):
    """Full-matrix forward: row-0 init + one segment over all codons.
    Returns (boundaries [n_cod + 1, 3, B, Cc], amax [n_cod + 1, 3, B, Cc]
    codon64; row 0 prepended)."""
    B, m = des_codes.shape
    Cc = m + 1
    init = triplet_init_carry(des_codes, ins_off, gc)
    bnd, amax, _ = _triplet_rows_carry(
        anc_cods, des_codes, ins_off, logP64, match_emit, gc, init,
        n_cod=n_cod,
    )
    b0 = jnp.stack(init, axis=0)[None]  # [1, 3, B, Cc]
    a0 = jnp.zeros((1, 3, B, Cc), jnp.int32)  # row 0: never lane-bound
    return (jnp.concatenate([b0, bnd], axis=0),
            jnp.concatenate([a0, amax], axis=0))


def triplet_terminal(Mr, Dr, Ir, lens_m, gc):
    """Terminal state & raw score from the final collapsed boundary
    (align_fst ShortestDistance convention)."""
    ng, gs = gc[0], gc[1]
    bidx = jnp.arange(Mr.shape[0], dtype=jnp.int32)
    tm = Mr[bidx, lens_m] + (ng + ng)
    td = Dr[bidx, lens_m] + gs
    ti = Ir[bidx, lens_m] + (gs + ng)
    st0 = jnp.where(td > tm, 1, 0)
    st0 = jnp.where(ti > jnp.maximum(tm, td), 2, st0).astype(jnp.int32)
    return st0, _max3(tm, td, ti)


@functools.partial(jax.jit, static_argnames=("S",))
def _triplet_walk_seg(grid_seg, amax_seg, anc_seg, des_codes, ins_off,
                          t_lo, state, logP64, match_emit, gc, *, S: int):
    """Walk S codon blocks (global indices t_lo + S - 1 .. t_lo) of the
    batched on-device traceback.

    grid_seg: [S + 1, 3, B, Cc] collapsed boundaries t_lo .. t_lo + S
    amax_seg: [S, 3, B, Cc] codon64 argmax lanes at boundaries
        t_lo + 1 .. t_lo + S
    state: (i, j, st, ops) walk carry. ops is [6 * n_cod_total, B] int32,
        run-encoded: row 6*t_global + phase holds (op | count << 2) for
        codon block t_global, phases in BACKWARD-walk order
        (0: insertion run at row 3, 1: step row3->2, 2: run at row 2,
        3: step row2->1, 4: run at row 1, 5: step row1->boundary);
        count == 0 rows are skipped by the decoder.

    Every active pair sits at a block's TOP boundary row when the block
    starts (crossings drain each walk to exactly the block base), so its
    optimal descendant-codon lane is read straight from the forward's
    stored boundary argmax — and the block's three rows are recomputed
    for THAT SINGLE LANE per pair with the factored arithmetic (phase 1/2
    rows exclude the entry cost, which is common to every same-lane
    candidate; phase 3 carries it via cost + e3, mirroring the forward's
    K term bit-for-bit). Row-0 insertions (i == 0, j > 0) are appended by
    the host.

    The walk inside a block has a FIXED structure — every active pair
    makes exactly 3 down-steps (M/D each consume one row; I never moves
    i), and an insertion run can precede each one — so the block runs as
    SIX static vector phases, no while_loop, no gathers (r4: the while
    version cost 130+ ms at 64x999 nt against a 60 ms forward; ~0.4 ms
    per block of loop/dispatch overhead). The insertion run exits in ONE
    step via its closed form: from state I at column j the sequential
    rule "leave when M[u] + go > I[u] + ge" reduces (go and the offsets
    cancel against the prefix-max identity) to "leave at the LAST column
    u <= j-1 where W[u] = M[u] - off[u] strictly exceeds its running
    max" — exactly the forward's `newmax` positions, so ties reproduce
    the one-edge-at-a-time walk bit-for-bit. Per-cell reads use one-hot
    selects (mask + max; exactly one bit set), not gathers."""
    B, m = des_codes.shape
    Cc = m + 1
    ng, gs, go, ge = (gc[x] for x in range(4))
    ng_ng = ng + ng
    gs_ng = gs + ng
    ng_go = ng + go
    gs_go = gs + go
    bidx = jnp.arange(B, dtype=jnp.int32)
    u_Cc = jnp.arange(Cc, dtype=jnp.int32)[None, :]  # [1, Cc]
    iota64 = jnp.arange(64, dtype=jnp.int32)[None, :]

    def sel_j(plane, oh, fill):
        """plane[b, j*] for the single j* with oh[b, j*] True — exact."""
        return jnp.max(jnp.where(oh, plane, fill), axis=1)

    # insertion offsets arrive host-computed (identical to the forward's)
    go_ge = go - ge

    E = jnp.concatenate(
        [
            jnp.zeros((B, 4, 1), jnp.float32),
            jnp.transpose(match_emit[:4, des_codes], (1, 0, 2)),
        ],
        axis=2,
    )  # [B, 4, Cc]

    def row_ins2(M):  # [B, Cc]
        run = jax.lax.cummax(M - ins_off, axis=1)
        pad = jnp.full((B, 1), NEG, jnp.float32)
        return jnp.concatenate(
            [pad, run[:, :-1] + (ins_off[:, 1:] + go_ge)], axis=1
        )

    def shiftmax3(M, D, I):
        body = _max3(M[:, :-1] + ng_ng, D[:, :-1] + gs, I[:, :-1] + gs_ng)
        return jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.float32), body], axis=1
        )

    def dmax3(M, D, I):
        return _max3(M + ng_go, D + ge, I + gs_go)

    # [S, B, 64] entry costs: ONE bulk gather outside the scan
    cost_rows = jnp.transpose(logP64[anc_seg], (1, 0, 2))

    def amax_pref(a, b, c):
        code = jnp.where(b > a, 1, 0)
        return jnp.where(c > jnp.maximum(a, b), 2, code)

    def one_block(i, j, st, ops, t):
        base_i = 3 * (t_lo + t)
        gr = jax.lax.dynamic_index_in_dim(
            grid_seg, t, axis=0, keepdims=False
        )  # [3, B, Cc]
        Mr, Dr, Ir = gr[0], gr[1], gr[2]

        # bind each active pair's lane at the block's top boundary
        am = jax.lax.dynamic_index_in_dim(
            amax_seg, t, axis=0, keepdims=False
        )  # [3, B, Cc]
        am_st = jnp.where(
            (st == 0)[:, None], am[0],
            jnp.where((st == 1)[:, None], am[1], am[2]),
        )
        oh_j = u_Cc == j[:, None]
        lane = sel_j(am_st, oh_j, 0)  # [B] codon64
        cost_row = jax.lax.dynamic_index_in_dim(
            cost_rows, t, axis=0, keepdims=False
        )  # [B, 64]
        cost_s = sel_j(cost_row, iota64 == lane[:, None], NEG)[:, None]
        x1 = (lane >> 4) & 3
        x2 = (lane >> 2) & 3
        x3 = lane & 3

        def e_at(x):  # E[b, x[b], :] via 4-way select
            return jnp.where(
                (x == 0)[:, None], E[:, 0],
                jnp.where(
                    (x == 1)[:, None], E[:, 1],
                    jnp.where((x == 2)[:, None], E[:, 2], E[:, 3]),
                ),
            )

        e1 = e_at(x1)
        e2 = e_at(x2)
        e3 = e_at(x3)

        core1 = shiftmax3(Mr, Dr, Ir)
        M1 = core1 + e1
        D1 = dmax3(Mr, Dr, Ir)
        I1 = row_ins2(M1)
        core2 = shiftmax3(M1, D1, I1)
        M2 = core2 + e2
        D2 = dmax3(M1, D1, I1)
        I2 = row_ins2(M2)
        core3 = shiftmax3(M2, D2, I2)
        ce3 = cost_s + e3
        M3 = core3 + ce3
        D3 = dmax3(M2, D2, I2) + cost_s
        I3 = row_ins2(M3)
        rows_M = (M1, M2, M3)
        rows_D = (D1, D2, D3)
        rows_I = (I1, I2, I3)

        def run_exit_cols(Mrow, Irow):
            """Ucol[b, j-1] = the column where an insertion run entered
            state I at column j exits into M: the LAST u <= j-1 where the
            walk's LITERAL f32 comparison M[u] + go > I[u] + ge holds
            (bit-identical to the one-edge-at-a-time rule; the
            real-algebra equivalent via W = M - off running maxes would
            round differently near ties)."""
            exit_ok = (Mrow + go) > (Irow + ge)
            return jax.lax.cummax(
                jnp.where(exit_ok, jnp.broadcast_to(u_Cc, (B, Cc)), -1),
                axis=1,
            )

        ops_rows = []
        for ph in range(6):
            act = (i > base_i) & ((i > 0) | (j > 0))
            if ph % 2 == 0:
                # insertion run at row 3 - ph//2 (pairs at this row in
                # state I jump to the run's entry column in ONE phase)
                r = 2 - ph // 2
                run_here = act & (st == 2)
                Ucol = run_exit_cols(rows_M[r], rows_I[r])
                u = sel_j(Ucol, u_Cc == (j - 1)[:, None], 0)
                cnt = jnp.where(run_here, j - u, 0)
                ops_rows.append(jnp.int32(2) | (cnt << 2))
                j = jnp.where(run_here, u, j)
                st = jnp.where(run_here, 0, st)
            else:
                # one M/D down-step; reads the row below (the boundary
                # for the last step — the crossing read, where the
                # codon-entry cost is common to all candidates)
                rb = 1 - ph // 2
                dj = jnp.where(st == 0, 1, 0)
                pj = j - dj
                oh_pj = u_Cc == pj[:, None]
                if ph < 5:
                    Mv, Dv, Iv = rows_M[rb], rows_D[rb], rows_I[rb]
                else:
                    Mv, Dv, Iv = Mr, Dr, Ir
                mv = sel_j(Mv, oh_pj, NEG)
                dv = sel_j(Dv, oh_pj, NEG)
                iv = sel_j(Iv, oh_pj, NEG)
                nxt_m = amax_pref(mv + (ng + ng), dv + gs, iv + (gs + ng))
                nxt_d = amax_pref(mv + (ng + go), dv + ge, iv + (gs + go))
                nxt = jnp.where(st == 0, nxt_m, nxt_d)
                cnt = act.astype(jnp.int32)
                ops_rows.append(st | (cnt << 2))
                i = jnp.where(act, i - 1, i)
                j = jnp.where(act, pj, j)
                st = jnp.where(act, nxt, st)

        # padding blocks of a K-group (t >= S) must not clobber rows
        # already written by the segment above: read-modify-write the
        # 6-row window with a select
        rows6 = jnp.stack(ops_rows)
        off = 6 * (t_lo + jnp.minimum(t, S - 1))
        old = jax.lax.dynamic_slice(ops, (off, 0), (6, ops.shape[1]))
        rows6 = jnp.where(t < S, rows6, old)
        ops = jax.lax.dynamic_update_slice(ops, rows6, (off, 0))
        return i, j, st, ops

    # K blocks per scan step: grouping amortizes the scan's per-step
    # overhead over 8 blocks of vector work. Groups and blocks both run in
    # DESCENDING order; padding blocks (t >= S) are no-ops for every
    # pair (i <= 3S <= base_i there) and their ops rows are masked off.
    K = min(8, S)
    n_groups = -(-S // K)

    def group(carry, tg):
        i, j, st, ops = carry
        for q in range(K):
            t = tg * K + (K - 1 - q)
            i, j, st, ops = one_block(i, j, st, ops, t)
        return (i, j, st, ops), None

    return jax.lax.scan(
        group, state, jnp.arange(n_groups - 1, -1, -1, dtype=jnp.int32)
    )[0]


@functools.partial(jax.jit, static_argnames=("n_cod",))
def _triplet_traceback(grid, amax, anc_cods, des_codes, ins_off, lens_t,
                       lens_m, logP64, match_emit, gc, *, n_cod: int):
    """Full-matrix traceback: one segment over all codon blocks, ONE
    dispatch (the terminal pick, walk, and op assembly all trace into a
    single executable). Returns (run-encoded ops [6*n_cod, B] int32, i_end,
    j_end, score)."""
    B, m = des_codes.shape
    bidx = jnp.arange(B, dtype=jnp.int32)
    st0, score = triplet_terminal(
        grid[lens_t, 0, bidx], grid[lens_t, 1, bidx],
        grid[lens_t, 2, bidx], lens_m, gc,
    )
    ops0 = jnp.zeros((6 * n_cod, B), jnp.int32)
    state = (3 * lens_t, lens_m, st0, ops0)
    i, j, st, ops = _triplet_walk_seg(
        grid[:-1], amax[1:], anc_cods, des_codes, ins_off, jnp.int32(0),
        state, logP64, match_emit, gc, S=n_cod,
    )
    return ops, i, j, score


# boundary-grid cells above which a single long pair routes through the
# segmented two-pass path (the full grid + amax cost ~24 B/cell; 32M
# cells ~ 768 MB)
TRIPLET_LONG_GRID_CELLS = int(_os.environ.get(
    "COATI_TPU_TRI_LONG_CELLS", str(32 * 1024 * 1024)
))


def triplet_align_long(model, anc: str, des: str, *, seg_cods: int = 512):
    """Align ONE long pair under a codon triplet model in bounded memory.

    The checkpointed two-pass recipe of align/longseq.py applied to the
    codon-boundary grid (the reference FST path dies at ~2 knt,
    benchmark/libcoati-benchmark-tests.txt:8-10; the full boundary grid
    is O(n*m) — ~8 GB for one 32 knt pair): pass 1 sweeps the factored
    forward keeping only the collapsed [3, Cc] boundary carry,
    checkpointing it every seg_cods codon blocks; pass 2 recomputes each
    segment's boundary grid + argmax lanes from its checkpoint (last to
    first) and drains the walk through it. Peak memory: ONE segment's
    [S, 3, Cc] grid/amax + n/S checkpoints — O(n + m).

    Strings and score are identical to triplet_align / the batched device
    path (same factored f32 arithmetic, same walk)."""
    from coati_tpu.triplet_hmm import encode_triplet_pair

    if not model.codon:
        raise ValueError("segmented triplet path requires a codon model")
    ea, ed = encode_triplet_pair(model, anc, des)
    anc_p, des_p, lens_t, lens_m, ins_off, tables, n_cod = _pack_batch(
        model, [ea], [ed]
    )
    logP64_t, me_t, gc_t = tables
    S = min(int(seg_cods), n_cod)
    n_full = n_cod // S
    S_rem = n_cod - n_full * S
    seg_spans = [(k * S, S) for k in range(n_full)]
    if S_rem:
        seg_spans.append((n_full * S, S_rem))

    aj = jnp.asarray(anc_p)
    dj = jnp.asarray(des_p)
    io = jnp.asarray(ins_off)
    m = int(lens_m[0])

    # pass 1: forward carry only, checkpoint entering each segment
    carry = triplet_init_carry(dj, io, gc_t)
    ckpts = []
    for t_lo, S_i in seg_spans:
        ckpts.append(carry)
        _, _, carry = _triplet_rows_carry(
            aj[:, t_lo : t_lo + S_i], dj, io, logP64_t, me_t, gc_t,
            carry, n_cod=S_i, keep_grid=False,
        )
    st0, score = triplet_terminal(
        carry[0], carry[1], carry[2], jnp.asarray(lens_m), gc_t
    )

    # pass 2: per segment (last to first) recompute grid + walk
    state = (
        3 * jnp.asarray(lens_t), jnp.asarray(lens_m), st0,
        jnp.zeros((6 * n_cod, 1), jnp.int32),
    )
    # async-chained: no per-segment early-exit sync (the walk traverses
    # every codon block anyway)
    for k in range(len(seg_spans) - 1, -1, -1):
        t_lo, S_i = seg_spans[k]
        bnd, amax, _ = _triplet_rows_carry(
            aj[:, t_lo : t_lo + S_i], dj, io, logP64_t, me_t, gc_t,
            ckpts[k], n_cod=S_i, keep_grid=True,
        )
        grid_seg = jnp.concatenate(
            [jnp.stack(ckpts[k], axis=0)[None], bnd], axis=0
        )
        state = _triplet_walk_seg(
            grid_seg, amax, aj[:, t_lo : t_lo + S_i], dj, io,
            jnp.int32(t_lo), state, logP64_t, me_t, gc_t, S=S_i,
        )

    i, j, _, ops = state
    ops_h, i_h, j_h, score_h = (
        np.asarray(x) for x in jax.device_get((ops, i, j, score))
    )
    s0, s1 = _decode_ops(anc, des, ops_h[:, 0], int(i_h[0]), int(j_h[0]))
    return s0, s1, float(-score_h[0])


def triplet_boundaries_batch(model, anc_encs, des_encs):
    """Device forward for a batch of encoded pairs (codon models).

    anc_encs: list of [n_cod_i] codon61 arrays; des_encs: list of [m_i]
    code arrays. Returns the boundary grid [n_cod_max + 1, 3, B, Cc] as
    numpy f32 (rows beyond a pair's own n_cod/m are padding)."""
    anc_p, des_p, _, _, ins_off, tables, n_cod = _pack_batch(
        model, anc_encs, des_encs
    )
    ys, _ = _triplet_rows(
        jnp.asarray(anc_p), jnp.asarray(des_p), jnp.asarray(ins_off),
        *tables, n_cod=n_cod
    )
    return np.asarray(jax.device_get(ys))


def _pack_batch(model, anc_encs, des_encs):
    B = len(anc_encs)
    n_cod = max(len(a) for a in anc_encs)
    m = max(len(d) for d in des_encs)
    anc_p = np.zeros((B, n_cod), np.int32)
    des_p = np.zeros((B, m), np.int32)
    lens_t = np.zeros(B, np.int32)
    lens_m = np.zeros(B, np.int32)
    for i, (a, d) in enumerate(zip(anc_encs, des_encs)):
        anc_p[i, : len(a)] = a
        des_p[i, : len(d)] = d
        lens_t[i] = len(a)
        lens_m[i] = len(d)

    # insertion run offsets on HOST numpy f32 — the same sequential cumsum
    # and op grouping as triplet_hmm._DP, so host and device walks see
    # bit-identical I-state arithmetic (a device-side cumsum may
    # reassociate); columns past a pair's own length are prefix-consistent
    # padding its walk never reads
    ge32 = np.float32(model.ge)
    e = model.ins_emit[des_p].astype(np.float32)  # [B, m]
    cumE = np.concatenate(
        [np.zeros((B, 1), np.float32), np.cumsum(e, axis=1, dtype=np.float32)],
        axis=1,
    )
    ins_off = cumE + ge32 * np.arange(m + 1, dtype=np.float32)[None, :]

    # device-resident model tables, uploaded ONCE per model PARAMETER SET
    # (keyed on a fingerprint of the numeric tables, so mutating a model
    # in place invalidates the cache)
    import hashlib

    gc = np.array([model.ng, model.gs, model.go, model.ge], np.float32)
    fp = hashlib.sha256(
        np.ascontiguousarray(model.logP).tobytes()
        + np.ascontiguousarray(model.match_emit).tobytes()
        + gc.tobytes()
    ).hexdigest()
    cached = getattr(model, "_device_tables", None)
    if cached is not None and cached[0] == fp:
        tables = cached[1]
    else:
        # codon64-indexed entry costs (NEG at stops) — lane64=x1*16+x2*4+x3
        logP64 = np.full((61, 64), np.float32(NEG), np.float32)
        logP64[:, C.COD61_TO_64] = model.logP.astype(np.float32)
        tables = (
            jnp.asarray(logP64),
            jnp.asarray(model.match_emit.astype(np.float32)),
            jnp.asarray(gc),
        )
        model._device_tables = (fp, tables)
    return anc_p, des_p, lens_t, lens_m, ins_off, tables, n_cod


def _decode_ops(anc, des, runs_b, i_end, j_end):
    """Rebuild aligned strings from the walk's run-encoded op rows
    (row 6*t + phase = op | count << 2, backward-walk order; see
    _triplet_walk_seg) ending at (i_end, j_end); leading row-0
    insertions cover des[:j_end]. Forward order = blocks ascending,
    phases descending within each block."""
    v = np.asarray(runs_b).reshape(-1, 6)[:, ::-1].ravel()  # forward order
    cnt = v >> 2
    keep = cnt > 0
    ops_run = (v & 3)[keep]
    cnt_run = cnt[keep]
    # one op per aligned column after the row-0 insertion prefix, then the
    # same cumsum/scatter string build as the marginal engine
    opsc = np.repeat(ops_run, cnt_run)
    consume_a = opsc != 2
    consume_b = opsc != 1
    idx_a = np.cumsum(consume_a) - 1 + i_end
    idx_b = np.cumsum(consume_b) - 1 + j_end
    a_arr = np.frombuffer(anc.encode("ascii") or b"-", np.uint8)
    b_arr = np.frombuffer(des.encode("ascii") or b"-", np.uint8)
    dash = np.uint8(ord("-"))
    s0 = np.where(consume_a, a_arr[np.minimum(idx_a, len(a_arr) - 1)], dash)
    s1 = np.where(consume_b, b_arr[np.minimum(idx_b, len(b_arr) - 1)], dash)
    return (
        "-" * j_end + s0.tobytes().decode("ascii"),
        des[:j_end] + s1.tobytes().decode("ascii"),
    )


def triplet_align_batch(model, pairs, traceback: str = "device"):
    """Align (anc, des) string pairs under a triplet model on the
    accelerator: batched device forward, then either the batched device
    traceback (default; only op sequences leave the device) or the per-pair
    host walk over the boundary grid (traceback="host" — the recompute
    oracle the device walk is tested against).

    Returns [(seq0, seq1, score), ...]; matches triplet_hmm.triplet_align
    output up to float32 tie-breaks (the dna model routes to the host
    engine — its 1-lane rows are host-cheap and its per-row boundary grid
    would be 3x larger)."""
    from coati_tpu.triplet_hmm import (
        _DP,
        encode_triplet_pair,
        traceback_from_boundaries,
        triplet_align,
    )

    if not model.codon:
        return [triplet_align(model, a, d) for a, d in pairs]

    enc = [encode_triplet_pair(model, a, d) for a, d in pairs]
    anc_encs = [e[0] for e in enc]
    des_encs = [e[1] for e in enc]
    anc_p, des_p, lens_t, lens_m, ins_off, tables, n_cod = _pack_batch(
        model, anc_encs, des_encs
    )

    with jax.default_device(backend.devices()[0]):
        # one upload per array, reused by forward AND traceback
        aj = jnp.asarray(anc_p)
        dj = jnp.asarray(des_p)
        io = jnp.asarray(ins_off)
        grid, amax = _triplet_rows(aj, dj, io, *tables, n_cod=n_cod)

    if traceback == "device":
        logP64_t, match_emit_t, gc_t = tables
        ops, i_end, j_end, score = _triplet_traceback(
            grid, amax, aj, dj,
            io, jnp.asarray(lens_t), jnp.asarray(lens_m),
            logP64_t, match_emit_t, gc_t, n_cod=n_cod
        )
        # ONE host fetch for all four results
        ops, i_end, j_end, score = (
            np.asarray(x)
            for x in jax.device_get((ops, i_end, j_end, score))
        )
        out = []
        for b, (anc, des) in enumerate(pairs):
            s0, s1 = _decode_ops(
                anc, des, ops[:, b], int(i_end[b]), int(j_end[b])
            )
            out.append((s0, s1, float(-score[b])))
        return out

    grid = np.asarray(jax.device_get(grid))
    out = []
    for b, ((anc, des), (ea, ed)) in enumerate(zip(pairs, enc)):
        ncb = len(ea)
        Ccb = len(ed) + 1
        boundaries = [
            (
                grid[t, 0, b, :Ccb].copy(),
                grid[t, 1, b, :Ccb].copy(),
                grid[t, 2, b, :Ccb].copy(),
            )
            for t in range(ncb + 1)
        ]
        Mb, Db, Ib = boundaries[ncb]
        dp = _DP(model, ea, ed, dtype=np.float32)
        term = (
            Mb[-1] + dp.ng_ng,
            Db[-1] + dp.gs,
            Ib[-1] + dp.gs_ng,
        )
        out.append(
            traceback_from_boundaries(model, anc, des, term, boundaries, dp)
        )
    return out
