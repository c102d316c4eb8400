"""Multi-host (pod-slice) scale-out helpers.

The workload is data-parallel over sequence pairs: each host reads its
shard of the pair stream, all hosts build the same tiny model tables, and
the global mesh shards the batch dimension over every chip in the slice.
Result collation stays host-local (each host writes its own shard's JSONL;
scores can be allgathered for global statistics).

Single-host environments (including this development image) exercise the
same code through an 8-device virtual CPU mesh; the jax.distributed
initialization below is the only multi-host-specific step.
"""

from __future__ import annotations

import jax
import numpy as np


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed (no-op if already initialized or single
    process). Arguments default to JAX's env-based autodetection
    (JAX_COORDINATOR_ADDRESS etc.); where nothing describes a cluster the
    process runs alone."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        # already initialized, or single-process context
        pass


def shard_bounds(n: int, process_index: int | None = None,
                 process_count: int | None = None) -> tuple[int, int]:
    """[lo, hi) global-index bounds of this host's contiguous shard."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    per = -(-n // pc)
    lo = min(pi * per, n)
    return lo, min(lo + per, n)


def host_shard(items: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """This host's contiguous shard of a work list (pair streams are
    sharded before encoding so each host touches only its own input)."""
    lo, hi = shard_bounds(len(items), process_index, process_count)
    return items[lo:hi]


def merge_multihost_outputs(output_base: str, local_scores, n_total: int):
    """Collate a multi-host batch run (outputs and log-weights merged via
    allgather).

    1. Per-pair scores are allgathered across processes into one global,
       order-preserving array; process 0 writes it to
       `{output_base}.scores.json` (error rows carry null).
    2. After a global barrier (every host has closed its shard file),
       process 0 concatenates the per-host `{output_base}.{p}` JSONL
       shards into `{output_base}` whenever all of them are visible on
       its filesystem (single-machine multi-process, shared-FS pods).
       Without a shared FS the per-host shards remain the output and the
       allgathered score manifest is still global.

    local_scores: float32 array over THIS host's shard positions (NaN for
    error rows). Returns (global_scores, merged_path_or_None)."""
    import json

    from jax.experimental import multihost_utils

    pc = jax.process_count()
    per = -(-n_total // pc) if n_total else 0
    pad = np.full(max(per, 1), np.nan, np.float32)
    pad[: len(local_scores)] = np.asarray(local_scores, np.float32)
    gathered = multihost_utils.process_allgather(pad)  # [pc, per]
    scores = np.asarray(gathered).reshape(-1)[:n_total]

    # barrier: every host finished writing + closing its shard before any
    # file-level merge happens
    multihost_utils.sync_global_devices("coati-batch-shards-written")

    merged = None
    if jax.process_index() == 0 and output_base:
        with open(f"{output_base}.scores.json", "w") as f:
            json.dump(
                {
                    "n_pairs": n_total,
                    "scores": [
                        None if np.isnan(s) else float(s) for s in scores
                    ],
                },
                f,
            )
        import os

        shard_files = [f"{output_base}.{p}" for p in range(pc)]
        if all(os.path.exists(s) for s in shard_files):
            with open(output_base, "w") as out:
                for s in shard_files:
                    with open(s) as fh:
                        out.write(fh.read())
            merged = output_base
    multihost_utils.sync_global_devices("coati-batch-merged")
    return scores, merged


def global_scores_allgather(local_scores: np.ndarray, mesh) -> np.ndarray:
    """Allgather per-host score shards across the mesh's data axis (for
    global statistics / manifests)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    arr = jax.device_put(
        jnp.asarray(local_scores), NamedSharding(mesh, P("data"))
    )
    gathered = jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, P())
    )(arr)
    return np.asarray(gathered)
