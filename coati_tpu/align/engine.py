"""Batch alignment engine: length bucketing and fused kernel dispatch.

Pairs are bucketed by padded shape, each bucket runs as few fused
(DP fill + on-device traceback) dispatches as possible, and only op
sequences + scores cross the host link; aligned strings are built by the
native single-pass builder.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os

import numpy as np

import jax
import jax.numpy as jnp

from coati_tpu import backend, compile_cache
from coati_tpu.align.wavefront import (
    dp_fill,
    dp_fill_jit,
    gap_consts_array,
    traceback_ops_impl,
)

# persistent compilation cache: the wavefront scan compiles once per padded
# shape; the cache survives across CLI invocations
compile_cache.configure()


@dataclasses.dataclass
class AlignResult:
    seq0: str
    seq1: str
    score: float


def _argmax_mdi_np(m, d, i):
    """Vectorized reference max_mdi preference (M unless D>, I only if > both)."""
    code = np.where(d > m, 1, 0).astype(np.int8)
    best = np.maximum(m, d)
    return np.where(i > best, 2, code).astype(np.int8)


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


_native_strings_warned = False


def ops_to_strings(ops_fwd, score, a_strs, b_strs, k):
    """Build aligned strings from forward-ordered op codes.

    ops_fwd: [steps, B] int8 with -1 padding (leading, since the walk ran
    backward and was reversed). Uses the native C++ single-pass builder
    when available; numpy cumsum fallback otherwise.
    """
    try:
        from coati_tpu import native

        if native.available():
            pairs = native.ops_to_strings_native(ops_fwd, a_strs, b_strs, k)
            return [
                AlignResult(s0, s1, float(score[p]))
                for p, (s0, s1) in enumerate(pairs)
            ]
    except Exception:
        # a real native-builder bug must not silently degrade every future
        # call to the numpy fallback: log once, loudly
        global _native_strings_warned
        if not _native_strings_warned:
            _native_strings_warned = True
            import logging
            import traceback

            logging.getLogger(__name__).warning(
                "native ops_to_strings failed; falling back to numpy "
                "builder for this and subsequent calls:\n%s",
                traceback.format_exc(),
            )
    results = []
    for p in range(ops_fwd.shape[1]):
        ops = ops_fwd[:, p]
        ops = ops[ops >= 0]
        if k > 1:
            ops = np.repeat(ops, np.where(ops == 0, 1, k))
        a_arr = np.frombuffer(a_strs[p].encode("ascii"), dtype=np.uint8)
        b_arr = np.frombuffer(b_strs[p].encode("ascii"), dtype=np.uint8)
        consume_a = ops != 2
        consume_b = ops != 1
        idx_a = np.cumsum(consume_a) - 1
        idx_b = np.cumsum(consume_b) - 1
        dash = np.uint8(ord("-"))
        s0 = np.where(consume_a, a_arr[np.maximum(idx_a, 0)], dash)
        s1 = np.where(consume_b, b_arr[np.maximum(idx_b, 0)], dash)
        results.append(
            AlignResult(
                s0.astype(np.uint8).tobytes().decode("ascii"),
                s1.astype(np.uint8).tobytes().decode("ascii"),
                float(score[p]),
            )
        )
    return results


# descendants longer than this many slots route to the segmented two-pass
# long-pair path (align/longseq.py): it bounds the full [Dtot, B, C] bp
# stack of the one-pass path (~2*C^2 bytes per pair; ~0.5 GB at 16.5k
# slots). A memory bound only: the speed crossover between the two paths
# is not measured on the card (ROADMAP S4).
LONG_PAIR_SLOTS = int(os.environ.get("COATI_TPU_LONG_SLOTS", "16512"))


def fused_align_ops_impl(aseq, bseq, la, lb, table32, gc, *, k, impl):
    """Fused DP fill + on-device traceback — the per-device alignment step.

    Shared by the single-device jit (below) and the shard_map mesh path
    (parallel/mesh.py), so every execution mode runs the identical step;
    `impl` ('xla' or 'cuda', from backend.dp_impl) picks the DP fill."""
    corners, bp = dp_fill(aseq, bseq, la, lb, table32, gc, k=k,
                          mode="viterbi", impl=impl)
    ops, (_, score) = traceback_ops_impl(bp, corners, la, lb, k=k)
    return ops, score


# One executable per chunk: the packed bp stack never leaves the device,
# and only the op sequences + scores are fetched.
_align_step_jit = functools.partial(
    jax.jit, static_argnames=("k", "impl"),
)(fused_align_ops_impl)


def fused_align_ops_packed_impl(aseq, bseq, la, lb, table32, gc, *, k,
                                impl):
    """fused_align_ops_impl with a host-link-lean output contract.

    Inputs may arrive narrow (uint16 ancestor / uint8 descendant codes) —
    widened on device, cutting h2d bytes 4x. Output ops are packed 2 bits
    per step (-1 -> code 3) so the d2h fetch is 4x smaller, plus `nsteps`,
    the number of meaningful leading rows (walks finish in ~path-length
    steps, about half the worst-case buffer) so callers fetch only those.
    """
    aseq = aseq.astype(jnp.int32)
    bseq = bseq.astype(jnp.int32)
    la = la.astype(jnp.int32)
    lb = lb.astype(jnp.int32)
    ops, score = fused_align_ops_impl(
        aseq, bseq, la, lb, table32, gc, k=k, impl=impl,
    )
    S = ops.shape[0]
    S4 = -(-S // 4) * 4
    o = jnp.pad(ops, ((0, S4 - S), (0, 0)), constant_values=-1)
    o = (o & jnp.int8(3)).astype(jnp.uint8)  # -1 -> 3
    packed = (o[0::4] | (o[1::4] << 2) | (o[2::4] << 4) | (o[3::4] << 6))
    return packed, score


_align_step_packed_jit = functools.partial(
    jax.jit, static_argnames=("k", "impl"),
)(fused_align_ops_packed_impl)


# Max alignment runs (maximal same-op segments) fetched per pair on the
# run-length-encoded path. A pair with g indel events has ~2g+1 runs, so 32
# covers any plausible biological pair; pairs that exceed it fall back to
# fetching the full packed op stream for their chunk.
RLE_RUNS = 32
# Run lengths and n_runs travel as 16-bit fields in the blob; a chunk whose
# walk-length bound exceeds this could hold a single run that silently
# wraps, so such chunks are forced onto the full packed-stream fetch.
RLE_MAX_STEPS = 65535
_ASYNC_FETCH = os.environ.get("COATI_TPU_ASYNC_FETCH", "1") != "0"


def fused_align_ops_rle_impl(aseq, bseq, la, lb, table32, gc, *, k, impl,
                             nr=32):
    """fused_align_ops_packed_impl plus a run-length-encoded result blob.

    Alignments are mostly long match runs, so the op stream compresses to
    a handful of (op, length) runs. The blob packs everything the host
    needs into ONE uint8 matrix so a chunk's results cross the
    (high-latency) host link in a single transfer:

      rows [0, nr)        run lengths, low byte   (runs in backward order)
      rows [nr, 2nr)      run lengths, high byte
      rows [2nr, 2nr+nr/4) run op codes, 2-bit packed
      rows [.., +2)        true run count (lo, hi) — may exceed nr: overflow
      rows [.., +4)        f32 score bytes (bitcast, little-endian)

    ~(2.25*nr + 6) bytes/pair vs ~(la+lb)/4 for the packed stream — ~4x
    less d2h for typical pairs and one device_get instead of two. The full
    packed stream is still returned (device-resident) for overflow pairs.
    """
    assert nr % 4 == 0
    packed, score = fused_align_ops_packed_impl(
        aseq, bseq, la, lb, table32, gc, k=k, impl=impl,
    )
    # re-derive the op stream in packed (uint8, -1 -> 3) space, restoring
    # step order (step t lives in packed row t//4 at bit position t%4)
    o = (
        jnp.stack(
            [packed & 3, (packed >> 2) & 3, (packed >> 4) & 3,
             (packed >> 6) & 3], axis=1,
        ).reshape(-1, packed.shape[1])
    )
    valid = o != 3
    # hole-transparent run detection: the scan traceback interleaves -1
    # holes (waiting diagonals) into the op stream, so a run boundary is
    # "valid op differs from the LAST VALID op", carried across holes by
    # an associative right-biased fill (f(a,b) = b if valid else a)
    filled = jax.lax.associative_scan(
        lambda a, b: jnp.where(b == 3, a, b), o, axis=0
    )
    prev = jnp.concatenate(
        [jnp.full((1, o.shape[1]), 255, o.dtype), filled[:-1]], axis=0
    )
    change = valid & (o != prev)
    run_id = jnp.cumsum(change.astype(jnp.int32), axis=0) - 1
    n_runs = run_id[-1] + 1  # [B] true run count (walk steps precede padding)
    lens = []
    ops_r = []
    for r in range(nr):
        m = run_id == r
        lens.append(jnp.sum(m & valid, axis=0))
        ops_r.append(jnp.max(jnp.where(m & valid, o, jnp.uint8(0)), axis=0))
    run_len = jnp.stack(lens).astype(jnp.uint32)  # [nr, B]
    rop = jnp.stack(ops_r)  # [nr, B] uint8 codes (0 for empty runs)
    rop_p = (rop[0::4] | (rop[1::4] << 2) | (rop[2::4] << 4)
             | (rop[3::4] << 6)).astype(jnp.uint8)
    nr_u = n_runs.astype(jnp.uint32)
    blob = jnp.concatenate(
        [
            (run_len & 0xFF).astype(jnp.uint8),
            ((run_len >> 8) & 0xFF).astype(jnp.uint8),
            rop_p,
            (nr_u & 0xFF).astype(jnp.uint8)[None],
            ((nr_u >> 8) & 0xFF).astype(jnp.uint8)[None],
            jax.lax.bitcast_convert_type(score, jnp.uint8).T,
        ],
        axis=0,
    )
    return packed, blob


_align_step_rle_jit = functools.partial(
    jax.jit, static_argnames=("k", "impl", "nr"),
)(fused_align_ops_rle_impl)


def _decode_rle_blob(blob: np.ndarray, nr: int):
    """Host-side inverse of the RLE blob: returns (run_len [nr, B] int64,
    run_op [nr, B] uint8, n_runs [B], score [B] f32). Runs are in the
    device's backward-walk order (run 0 = tail of the alignment)."""
    run_len = blob[:nr].astype(np.int64) | (
        blob[nr : 2 * nr].astype(np.int64) << 8
    )
    rp = blob[2 * nr : 2 * nr + nr // 4]
    run_op = np.empty((nr, blob.shape[1]), np.uint8)
    run_op[0::4] = rp & 3
    run_op[1::4] = (rp >> 2) & 3
    run_op[2::4] = (rp >> 4) & 3
    run_op[3::4] = (rp >> 6) & 3
    base = 2 * nr + nr // 4
    n_runs = blob[base].astype(np.int64) | (
        blob[base + 1].astype(np.int64) << 8
    )
    score = (
        np.ascontiguousarray(blob[base + 2 : base + 6].T)
        .view(np.float32)
        .ravel()
    )
    return run_len, run_op, n_runs, score


def runs_to_strings(run_len, run_op, n_runs, score, a_strs, b_strs, k):
    """Build aligned strings straight from (op, length) runs — a few string
    slices per pair instead of a per-step walk. Runs arrive in backward
    order (run 0 ends the alignment), so iterate last-to-first."""
    results = []
    for p, (a, b) in enumerate(zip(a_strs, b_strs)):
        ia = ib = 0
        s0 = []
        s1 = []
        for r in range(int(n_runs[p]) - 1, -1, -1):
            op = int(run_op[r, p])
            L = int(run_len[r, p])
            if op == 0:
                s0.append(a[ia : ia + L])
                s1.append(b[ib : ib + L])
                ia += L
                ib += L
            elif op == 1:
                n = L * k
                s0.append(a[ia : ia + n])
                s1.append("-" * n)
                ia += n
            else:
                n = L * k
                s0.append("-" * n)
                s1.append(b[ib : ib + n])
                ib += n
        results.append(
            AlignResult("".join(s0), "".join(s1), float(score[p]))
        )
    return results


def _unpack_ops(packed, nsteps):
    """Host-side inverse of the 2-bit packing: [rows, B] uint8 ->
    [nsteps, B] int8 with code 3 mapped back to -1."""
    rows, B = packed.shape
    o = np.empty((rows * 4, B), np.int8)
    o[0::4] = packed & 3
    o[1::4] = (packed >> 2) & 3
    o[2::4] = (packed >> 4) & 3
    o[3::4] = (packed >> 6) & 3
    o = o[:nsteps]
    return np.where(o == 3, np.int8(-1), o)


def _ancestor_dtype(table32) -> type:
    """Narrowest dtype holding row indices of the (possibly stacked) table."""
    rows = table32.shape[0] if table32.ndim == 2 else (
        table32.shape[0] * table32.shape[1]
    )
    if rows <= 255:
        return np.uint8
    if rows <= 65535:
        return np.uint16
    return np.int32


def _fetch_rle_chunk(launched, n_real, ca, cb, k):
    """Fetch + decode one RLE-launched chunk into AlignResults.

    `launched` is the (packed_ops, nsteps, blob) handle triple from
    _align_step(fetch=False, rle=True). Pairs whose run count exceeded the
    blob cap are
    rebuilt individually from the full packed op stream; the rest keep the
    RLE fast path (the stream transfer is paid once per chunk, decode is
    per-pair)."""
    packed_d, nsteps, blob_d = launched
    blob = np.asarray(jax.device_get(blob_d))
    run_len, run_op, n_runs, score = _decode_rle_blob(blob, RLE_RUNS)
    # clamp so overflow pairs don't index past the blob's nr rows; their
    # (truncated) strings are replaced below
    out = runs_to_strings(
        run_len[:, :n_real], run_op[:, :n_real],
        np.minimum(n_runs[:n_real], RLE_RUNS),
        score[:n_real], ca, cb, k,
    )
    over = np.nonzero(n_runs[:n_real] > RLE_RUNS)[0]
    if over.size:
        pk = np.asarray(jax.device_get(packed_d))
        ops = _unpack_ops(pk, nsteps)[::-1]
        for i in over:
            out[int(i)] = ops_to_strings(
                ops[:, int(i) : int(i) + 1], score[int(i) : int(i) + 1],
                [ca[int(i)]], [cb[int(i)]], k,
            )[0]
    return out


def _fetch_packed(packed_d, nsteps, score_d, n_real):
    """Fetch one launched chunk's results: the packed op rows were already
    trimmed (asynchronously, at launch) to `nsteps`, a host-computed upper
    bound on the walk length — transfer, unpack, reverse to forward order.
    Rows between the realized walk length and the bound hold -1 padding the
    string builders already skip."""
    pk = np.asarray(jax.device_get(packed_d))
    ops = _unpack_ops(pk, nsteps)[::-1, :n_real]
    score = np.asarray(jax.device_get(score_d))[:n_real]
    return ops, score


# when set to a list (bench telemetry), every launched chunk appends its
# static step config — enough to replay one device-identical step on
# synthetic data
CHUNK_TRACE: list | None = None


def _align_step(aseq, bseq, la, lb, table32, gc, k, dev, fetch=True,
                rle=False):
    """Run one fused chunk on `dev`.

    fetch=True returns (ops [steps,B] int8 walked-backward, score [B]) as
    numpy; fetch=False returns the raw device handles
    (packed_ops, nsteps, score) without blocking (async launch) — pass them
    to _fetch_packed. With rle=True (fetch=False only) the handles are
    (packed_ops, nsteps, blob): `blob` is the single-transfer RLE result
    matrix (see fused_align_ops_rle_impl) and packed_ops is fetched only
    for overflow pairs. table32/gc may be numpy or already-device arrays
    (device-resident reuse avoids a re-transfer per chunk)."""
    B0 = aseq.shape[0]
    impl = backend.dp_impl(dev.platform, "viterbi")
    # narrow input dtypes: uint8/uint16 ancestor codes (by stacked-table
    # row count; the single-model 183-row table fits uint8) and uint8
    # descendant nt16 codes. copy=False: callers that padded straight
    # into the narrow dtype (_ancestor_dtype) skip the extra pass.
    if isinstance(aseq, np.ndarray) and table32.shape[0] <= 65535:
        aseq = aseq.astype(
            np.uint8 if table32.shape[0] <= 255 else np.uint16, copy=False,
        )
    if isinstance(bseq, np.ndarray):
        bseq = bseq.astype(np.uint8, copy=False)
    step_jit = _align_step_rle_jit if rle else _align_step_packed_jit
    extra = {"nr": RLE_RUNS} if rle else {}
    if CHUNK_TRACE is not None:
        CHUNK_TRACE.append({
            "B": int(aseq.shape[0]), "NA": int(aseq.shape[1]),
            "NB": int(bseq.shape[1]), "k": int(k), "impl": impl,
            "rle": bool(rle), "device": int(dev.id),
        })
    packed, aux = step_jit(
        jnp.asarray(aseq), jnp.asarray(bseq), jnp.asarray(la),
        jnp.asarray(lb), jnp.asarray(table32), jnp.asarray(gc),
        k=k, impl=impl, **extra,
    )
    # trim the fetch to a host-known walk-length bound: the scan traceback
    # left-aligns the op stream, so every real op (plus -1 waiting holes)
    # lives in the first max(la+lb) + 2k - 1 rows. The slice dispatches
    # asynchronously NOW, so the fetch loop later pays no extra device
    # round trip. Rounded to x32 rows to bound the number of distinct
    # slice executables per bucket.
    nsteps = min(int(np.max(la + lb)) + 2 * k - 1, packed.shape[0] * 4)
    rows = min(_round_up(-(-nsteps // 4), 32), packed.shape[0])
    packed = packed[:rows]
    nsteps = min(nsteps, rows * 4)
    if not fetch:
        return packed, nsteps, aux
    ops, score_h = _fetch_packed(packed, nsteps, aux, B0)
    # forward->backward: callers of the fetch=True path expect the raw
    # backward-ordered buffer (historical contract)
    return ops[::-1], score_h


def _pad_rows(seqs, N, dtype=np.int32):
    """Stack ragged int sequences into a zero-padded [B, N] array.

    Vectorized via a boolean length-mask scatter (row-major order matches
    the concatenation order) — ~10x faster than a per-row Python loop on
    10k-row batches. `dtype` narrow (uint8/uint16) skips a second
    full-array astype pass at upload time."""
    B = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int32, count=B)
    out = np.zeros((B, N), dtype=dtype)
    if B:
        flat = np.concatenate([np.asarray(s).ravel() for s in seqs])
        out[np.arange(N, dtype=np.int32)[None, :] < lens[:, None]] = flat
    return out, lens


def _pad_batch(enc_as, enc_bs, quantum, a_dtype=np.int32, b_dtype=np.int32):
    na = max(len(a) for a in enc_as)
    nb = max(len(b) for b in enc_bs)
    NA = max(_round_up(na, quantum), quantum)
    NB = max(_round_up(nb, quantum), quantum)
    aseq, lens_a = _pad_rows(enc_as, NA, dtype=a_dtype)
    bseq, lens_b = _pad_rows(enc_bs, NB, dtype=b_dtype)
    return aseq, bseq, lens_a, lens_b


def viterbi_align_batch(
    enc_as,
    enc_bs,
    a_strs,
    b_strs,
    table,
    gap,
    quantum: int = 96,
    max_batch_cells: int = 1 << 30,
    table_idx=None,
    long_slots: int | None = None,
) -> list[AlignResult]:
    """Align many pairs: bucket by padded shape, run the wavefront kernel per
    bucket, traceback on host. Results keep input order.

    table_idx: optional per-pair index into a stacked table [G, 183, 15] —
    pairs with different model parameters (e.g. MSA leaves at distinct branch
    lengths) batch into ONE kernel call. The index is folded into the
    ancestor encoding (enc_a + 183*idx against the flattened [G*183, 15]
    table), so the kernels are untouched."""
    k = int(gap.len)
    gc = gap_consts_array(gap)
    table32 = np.asarray(table, dtype=np.float32)
    # run-length-encoded result fetch (one small transfer per chunk);
    # COATI_TPU_FETCH_RLE=0 restores the full packed-op-stream fetch
    use_rle = os.environ.get("COATI_TPU_FETCH_RLE", "1") != "0"
    if table_idx is not None:
        if table32.ndim != 3:
            raise ValueError("table_idx requires a stacked [G, rows, 15] table")
        nrows = table32.shape[1]
        enc_as = [
            np.asarray(a, dtype=np.int32) + np.int32(nrows * int(table_idx[i]))
            for i, a in enumerate(enc_as)
        ]
        table32 = table32.reshape(-1, table32.shape[-1])

    ls = LONG_PAIR_SLOTS if long_slots is None else long_slots
    buckets: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
    long_pairs: list[int] = []
    for idx, (a, b) in enumerate(zip(enc_as, enc_bs)):
        if len(b) + k > ls:
            long_pairs.append(idx)
            continue
        qa = max(_round_up(len(a), quantum), quantum)
        qb = max(_round_up(len(b), quantum), quantum)
        buckets[(qa, qb)].append(idx)
    results: list[AlignResult | None] = [None] * len(enc_as)
    devs = backend.devices()
    # model table + gap consts go device-resident once per batch (per
    # device), not re-transferred with every chunk
    resident = {}
    for dev in devs:
        resident[dev] = (
            jax.device_put(table32, dev),
            jax.device_put(gc, dev),
        )
    # phase 1: launch every chunk asynchronously (jax dispatch is async, so
    # device work for chunk N overlaps host prep of chunk N+1); chunks
    # round-robin across every local device of the chosen platform
    inflight = []
    n_launched = 0
    for (qa, qb), idxs in buckets.items():
        cells = (qa + k) * (qb + k)
        max_b = max(1, max_batch_cells // cells)
        if len(devs) > 1:
            # split big buckets so every device gets work
            max_b = max(1, min(max_b, -(-len(idxs) // len(devs))))
        for s in range(0, len(idxs), max_b):
            chunk = idxs[s : s + max_b]
            # pad short tail chunks with dummy pairs so every chunk of a
            # bucket shares one compiled shape
            n_real = len(chunk)
            pad_n = (max_b - n_real) if (s > 0 and n_real < max_b) else 0
            padded = chunk + [chunk[0]] * pad_n
            aseq, bseq, la, lb = _pad_batch(
                [enc_as[i] for i in padded], [enc_bs[i] for i in padded],
                quantum, a_dtype=_ancestor_dtype(table32),
                b_dtype=np.uint8,
            )
            dev = devs[n_launched % len(devs)]
            n_launched += 1
            table_d, gc_d = resident[dev]
            # 16-bit guard: run lengths/counts travel as uint16 in the RLE
            # blob; a chunk whose walk-length bound exceeds 65535 steps
            # (very long ancestor, few indels) could wrap a single run
            # without tripping the n_runs overflow check — force the full
            # packed-stream fetch for such chunks
            rle_c = use_rle and int(np.max(la + lb)) + 1 <= RLE_MAX_STEPS
            with jax.default_device(dev):
                launched = _align_step(
                    aseq, bseq, la, lb, table_d, gc_d, k, dev, fetch=False,
                    rle=rle_c,
                )
            if rle_c and _ASYNC_FETCH:
                # start the d2h copy of the small result blob now; it
                # overlaps later chunks' compute, so phase 2's device_get
                # pays ~zero link latency
                try:
                    launched[2].copy_to_host_async()
                except (AttributeError, RuntimeError):
                    pass
            inflight.append((chunk, n_real, rle_c, launched))

    # long pairs: segmented two-pass traceback (O(n) memory), batched:
    # similar-length long pairs share one sweep
    if long_pairs:
        from coati_tpu.align.longseq import (
            long_batch_width,
            viterbi_align_long_batch,
        )

        order = sorted(
            long_pairs, key=lambda i: -(len(enc_as[i]) + len(enc_bs[i]))
        )
        groups: list[list[int]] = []
        for idx in order:
            size = len(enc_as[idx]) + len(enc_bs[idx])
            if groups:
                head = groups[-1][0]
                head_size = len(enc_as[head]) + len(enc_bs[head])
                # width from the widest descendant the group would have
                # AFTER adding this pair (members sorted by total size
                # can still carry a larger NB than the head)
                nb_max = max(
                    len(enc_bs[i]) for i in groups[-1] + [idx]
                )
                width = long_batch_width(nb_max, k)
                # only group pairs close enough in size that padding to
                # the group max wastes < ~half the sweep
                if len(groups[-1]) < width and size >= 0.7 * head_size:
                    groups[-1].append(idx)
                    continue
            groups.append([idx])

        with jax.default_device(devs[0]):
            for grp in groups:
                out = viterbi_align_long_batch(
                    [enc_as[i] for i in grp], [enc_bs[i] for i in grp],
                    [a_strs[i] for i in grp], [b_strs[i] for i in grp],
                    table32, gap,
                )
                for i, r in zip(grp, out):
                    results[i] = r

    # phase 2: fetch + build strings in launch order
    for chunk, n_real, rle_c, launched in inflight:
        ca = [a_strs[i] for i in chunk]
        cb = [b_strs[i] for i in chunk]
        if rle_c:
            out = _fetch_rle_chunk(launched, n_real, ca, cb, k)
        else:
            packed_d, nsteps, aux_d = launched
            ops, score = _fetch_packed(packed_d, nsteps, aux_d, n_real)
            out = ops_to_strings(ops, score, ca, cb, k)
        for i, r in zip(chunk, out):
            results[i] = r
    return results  # type: ignore[return-value]


def viterbi_align_single(enc_a, enc_b, a_str, b_str, table, gap) -> tuple:
    r = viterbi_align_batch([enc_a], [enc_b], [a_str], [b_str], table, gap)[0]
    return r.seq0, r.seq1, r.score


def viterbi_scores_batch(
    enc_as, enc_bs, table, gap, quantum: int = 96, max_batch_cells: int = 1 << 30
) -> np.ndarray:
    """Score-only Viterbi (no traceback storage) — O(diagonal) memory."""
    k = int(gap.len)
    gc = gap_consts_array(gap)
    table32 = np.asarray(table, dtype=np.float32)

    buckets: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
    for idx, (a, b) in enumerate(zip(enc_as, enc_bs)):
        qa = max(_round_up(len(a), quantum), quantum)
        qb = max(_round_up(len(b), quantum), quantum)
        buckets[(qa, qb)].append(idx)

    scores = np.zeros(len(enc_as), dtype=np.float32)
    dev = backend.devices()[0]
    impl = backend.dp_impl(dev.platform, "score")
    for (qa, qb), idxs in buckets.items():
        cells = (qa + k) * (qb + k)
        max_b = max(1, max_batch_cells // cells)
        for s in range(0, len(idxs), max_b):
            chunk = idxs[s : s + max_b]
            aseq, bseq, la, lb = _pad_batch(
                [enc_as[i] for i in chunk], [enc_bs[i] for i in chunk], quantum
            )
            with jax.default_device(dev):
                (cm, cd, ci), _ = dp_fill_jit(
                    jnp.asarray(aseq), jnp.asarray(bseq), jnp.asarray(la),
                    jnp.asarray(lb), jnp.asarray(table32), jnp.asarray(gc),
                    k=k, mode="score", impl=impl,
                )
            sc = np.maximum(np.asarray(cm), np.maximum(np.asarray(cd), np.asarray(ci)))
            scores[chunk] = sc
    return scores
