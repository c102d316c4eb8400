"""Device-mesh data parallelism for batch alignment.

The workload is embarrassingly data-parallel over sequence pairs: model
tables (183x15) are tiny and replicated; the pair batch is sharded over a
1-D 'data' mesh axis, each chip runs the fused DP+traceback step on its
shard, and only per-pair op sequences / scores are gathered. This replaces
the reference's single-threaded loop (it has no parallelism at all,
SURVEY.md section 2.3) with jax.sharding + shard_map. The cards of one
host are joined all to all, so the mesh is one flat 'data' axis.

Two production modes exist:
  - shard_map (this module): one jitted executable spanning the mesh; the
    local body is engine.fused_align_ops_impl — the same step the
    single-device engine runs.
  - round-robin (align/engine.py): independent async dispatches per local
    device, which tolerates ragged bucket shapes; used by the batch verb.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from coati_tpu.align.engine import fused_align_ops_impl
from coati_tpu.align.wavefront import wavefront_impl


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first n devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("data",))


@functools.partial(
    jax.jit, static_argnames=("k", "semiring", "mesh")
)
def _sharded_scores(aseq, bseq, lens_a, lens_b, table, gc, *, k, semiring, mesh):
    def local(aseq, bseq, la, lb, table, gc):
        (cm, cd, ci), _ = wavefront_impl(
            aseq, bseq, la, lb, table, gc, k=k, semiring=semiring, mode="score"
        )
        return jnp.maximum(cm, jnp.maximum(cd, ci))

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data"), P(), P()),
        out_specs=P("data"),
        check_vma=False,
    )(aseq, bseq, lens_a, lens_b, table, gc)


def sharded_viterbi_scores(
    enc_as, enc_bs, table, gap, mesh: Mesh, quantum: int = 64
) -> np.ndarray:
    """Viterbi scores for a pair batch, sharded over the mesh's 'data' axis.

    The batch is padded to a multiple of the mesh size; each device computes
    its shard independently (no cross-device communication inside the DP).
    """
    from coati_tpu.align.engine import _pad_batch, _round_up
    from coati_tpu.align.wavefront import gap_consts_array

    n = len(enc_as)
    nd = mesh.devices.size
    k = int(gap.len)
    pad_n = _round_up(max(n, nd), nd)
    enc_as = list(enc_as) + [enc_as[0]] * (pad_n - n)
    enc_bs = list(enc_bs) + [enc_bs[0]] * (pad_n - n)
    aseq, bseq, la, lb = _pad_batch(enc_as, enc_bs, quantum)
    gc = gap_consts_array(gap)

    sharding = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    aseq = jax.device_put(jnp.asarray(aseq), sharding)
    bseq = jax.device_put(jnp.asarray(bseq), sharding)
    la_d = jax.device_put(jnp.asarray(la), sharding)
    lb_d = jax.device_put(jnp.asarray(lb), sharding)
    table_d = jax.device_put(jnp.asarray(table, dtype=jnp.float32), rep)
    gc_d = jax.device_put(jnp.asarray(gc), rep)

    scores = _sharded_scores(
        aseq, bseq, la_d, lb_d, table_d, gc_d,
        k=k, semiring="tropical", mesh=mesh,
    )
    return np.asarray(jax.device_get(scores))[:n]


@functools.partial(jax.jit, static_argnames=("k", "mesh", "impl"))
def sharded_align_step(aseq, bseq, lens_a, lens_b, table, gc, *, k, mesh,
                       impl="xla"):
    """Full data-parallel alignment step: DP fill + on-device traceback walk.

    Returns (ops [steps, B] int8 backward-ordered, scores [B]) with the
    batch dimension sharded over 'data'. The local body is the exact fused
    step the single-device engine runs (`impl` from backend.dp_impl)."""

    def local(aseq, bseq, la, lb, table, gc):
        return fused_align_ops_impl(aseq, bseq, la, lb, table, gc, k=k,
                                    impl=impl)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data"), P(), P()),
        out_specs=(P(None, "data"), P("data")),
        check_vma=False,
    )(aseq, bseq, lens_a, lens_b, table, gc)


def sharded_viterbi_align_batch(
    enc_as, enc_bs, a_strs, b_strs, table, gap, mesh: Mesh,
    quantum: int = 96,
):
    """Production mesh alignment: pad the batch over the 'data' axis, run the
    fused step as ONE executable spanning the mesh, build strings on host.

    Returns a list of AlignResult in input order."""
    from coati_tpu import backend
    from coati_tpu.align.engine import _pad_batch, _round_up, ops_to_strings
    from coati_tpu.align.wavefront import gap_consts_array

    n = len(enc_as)
    nd = mesh.devices.size
    k = int(gap.len)
    impl = backend.dp_impl(mesh.devices.flat[0].platform, "viterbi")

    pad_n = _round_up(max(n, nd), nd)
    enc_pad = list(enc_as) + [enc_as[0]] * (pad_n - n)
    enc_bpad = list(enc_bs) + [enc_bs[0]] * (pad_n - n)
    aseq, bseq, la, lb = _pad_batch(enc_pad, enc_bpad, quantum)
    gc = gap_consts_array(gap)
    table32 = np.asarray(table, dtype=np.float32)

    sharding = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    args = (
        jax.device_put(jnp.asarray(aseq), sharding),
        jax.device_put(jnp.asarray(bseq), sharding),
        jax.device_put(jnp.asarray(la), sharding),
        jax.device_put(jnp.asarray(lb), sharding),
        jax.device_put(jnp.asarray(table32), rep),
        jax.device_put(jnp.asarray(gc), rep),
    )
    ops_d, score_d = sharded_align_step(*args, k=k, mesh=mesh, impl=impl)
    ops = np.asarray(jax.device_get(ops_d))[::-1, :n]
    score = np.asarray(jax.device_get(score_d))[:n]
    return ops_to_strings(ops, score, list(a_strs), list(b_strs), k)


# --- triplet (codon-context) models over the mesh ---------------------------
@functools.partial(jax.jit, static_argnames=("n_cod", "mesh"))
def _sharded_triplet_step(anc_p, des_p, ins_off, lens_t, lens_m, logP64,
                          me, gc, *, n_cod, mesh):
    """Data-parallel triplet forward + device traceback: one executable
    spanning the mesh; the local body is the exact batched step
    triplet_align_batch runs on one device."""
    from coati_tpu.triplet_wavefront import (
        _triplet_rows,
        _triplet_traceback,
    )

    def local(anc_p, des_p, ins_off, lens_t, lens_m, logP64, me, gc):
        grid, amax = _triplet_rows(
            anc_p, des_p, ins_off, logP64, me, gc, n_cod=n_cod
        )
        return _triplet_traceback(
            grid, amax, anc_p, des_p, ins_off, lens_t, lens_m,
            logP64, me, gc, n_cod=n_cod,
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data"), P("data"),
                  P(), P(), P()),
        out_specs=(P(None, "data"), P("data"), P("data"), P("data")),
        check_vma=False,
    )(anc_p, des_p, ins_off, lens_t, lens_m, logP64, me, gc)


def sharded_triplet_align_batch(model, pairs, mesh: Mesh):
    """Triplet alignment for (anc, des) string pairs, pair batch sharded
    over the mesh's 'data' axis. Strings/scores identical to the
    single-device triplet_align_batch (same f32 step, same walk)."""
    from coati_tpu.triplet_hmm import encode_triplet_pair
    from coati_tpu.triplet_wavefront import _decode_ops, _pack_batch
    from coati_tpu.align.engine import _round_up

    nd = mesh.devices.size
    n = len(pairs)
    pad_n = _round_up(max(n, nd), nd)
    pairs_p = list(pairs) + [pairs[0]] * (pad_n - n)
    enc = [encode_triplet_pair(model, a, d) for a, d in pairs_p]
    anc_p, des_p, lens_t, lens_m, ins_off, tables, n_cod = _pack_batch(
        model, [e[0] for e in enc], [e[1] for e in enc]
    )
    logP64_t, me_t, gc_t = tables

    sharding = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    args = (
        jax.device_put(jnp.asarray(anc_p), sharding),
        jax.device_put(jnp.asarray(des_p), sharding),
        jax.device_put(jnp.asarray(ins_off), sharding),
        jax.device_put(jnp.asarray(lens_t), sharding),
        jax.device_put(jnp.asarray(lens_m), sharding),
        jax.device_put(logP64_t, rep),
        jax.device_put(me_t, rep),
        jax.device_put(gc_t, rep),
    )
    ops, i_end, j_end, score = _sharded_triplet_step(
        *args, n_cod=n_cod, mesh=mesh
    )
    ops, i_end, j_end, score = (
        np.asarray(x) for x in jax.device_get((ops, i_end, j_end, score))
    )
    out = []
    for b, (anc, des) in enumerate(pairs):
        s0, s1 = _decode_ops(anc, des, ops[:, b], int(i_end[b]),
                             int(j_end[b]))
        out.append((s0, s1, float(-score[b])))
    return out


# --- forward + stochastic-traceback sampling over the mesh ------------------
def sharded_sample_batch(Ms, Ds, Is, corners, enc_a, enc_b, table, a, b,
                         gap, seed_u64: int, n: int, mesh: Mesh):
    """Draw n alignments from the Forward distribution with the DRAWS
    sharded over the mesh: every device holds the (replicated) state
    matrices and walks its own slice of tracebacks with a per-device key.
    Deterministic for a given (seed, mesh size); yields (s0, s1, score)."""
    from coati_tpu.align.sample_device import (
        _sample_paths,
        decode_sample_ops,
    )
    from coati_tpu.align.semiring import gap_constants

    k = int(gap.len)
    gc4 = np.array(gap_constants(gap.open, gap.extend), np.float32)
    R = len(enc_a) + k
    Cc = len(enc_b) + k
    d_corner = R - 1 + Cc - 1
    F = np.float32
    Ms = jnp.asarray(Ms).at[d_corner, Cc - 1].set(F(corners[0]))
    Ds = jnp.asarray(Ds).at[d_corner, Cc - 1].set(F(corners[1]))
    Is = jnp.asarray(Is).at[d_corner, Cc - 1].set(F(corners[2]))
    n_steps = (R - k) + (Cc - k)

    nd = mesh.devices.size
    per = -(-n // nd)
    keys = jax.random.split(
        jax.random.PRNGKey(seed_u64 & 0x7FFFFFFFFFFFFFFF), nd
    )

    rep = NamedSharding(mesh, P())
    shd = NamedSharding(mesh, P("data"))
    Ms_d = jax.device_put(Ms, rep)
    Ds_d = jax.device_put(Ds, rep)
    Is_d = jax.device_put(Is, rep)
    ea = jax.device_put(jnp.asarray(np.asarray(enc_a, np.int32)), rep)
    eb = jax.device_put(jnp.asarray(np.asarray(enc_b, np.int32)), rep)
    tbl = jax.device_put(jnp.asarray(np.asarray(table, np.float32)), rep)
    gcd = jax.device_put(jnp.asarray(gc4), rep)
    keys_d = jax.device_put(keys, shd)

    @functools.partial(jax.jit, static_argnames=())
    def step(Ms, Ds, Is, ea, eb, tbl, gcd, keys):
        def local(Ms, Ds, Is, ea, eb, tbl, gcd, keys):
            return _sample_paths(
                Ms, Ds, Is, ea, eb, tbl, gcd, keys[0],
                k=k, n_steps=n_steps, n_samples=per, R=R, Cc=Cc,
            )

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(), P(), P(), P("data")),
            out_specs=(P(None, "data"), P("data")),
            check_vma=False,
        )(Ms, Ds, Is, ea, eb, tbl, gcd, keys)

    ops, scores = step(Ms_d, Ds_d, Is_d, ea, eb, tbl, gcd, keys_d)
    ops = np.asarray(jax.device_get(ops))
    scores = np.asarray(jax.device_get(scores))
    out = []
    for s in range(n):
        s0, s1 = decode_sample_ops(ops[:, s], a, b, k)
        out.append((s0, s1, float(scores[s])))
    return out
