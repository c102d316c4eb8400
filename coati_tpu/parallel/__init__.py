"""Data-parallel scaling over device meshes."""

from coati_tpu.parallel.mesh import (
    make_mesh,
    sharded_align_step,
    sharded_viterbi_scores,
)

__all__ = ["make_mesh", "sharded_align_step", "sharded_viterbi_scores"]
