"""Tree-guided reference-anchored MSA (reference align_msa.cc).

Batched redesign: all leaf-vs-reference pairwise alignments run as ONE
batched wavefront kernel call per distinct branch length group (the
reference loops leaves sequentially and rebuilds the 61x61 expm per leaf,
align_msa.cc:285-318); the insertion merge up the tree is tiny host logic.
"""

from __future__ import annotations

from coati_tpu import utils
from coati_tpu.io import read_input, write_output
from coati_tpu.msa import tree as treemod
from coati_tpu.msa.insertions import (
    InsertionData,
    InsVector,
    insertion_flags,
    merge_indels,
)
from coati_tpu.structs import AlignmentParams


def align_leafs(inp: AlignmentParams, tree, ref_pos, ref_seq, nodes_ins):
    """Pairwise-align every non-reference leaf against the reference.

    Every leaf goes through ONE batched engine call: per-distinct-branch-
    length subst tables are stacked [G, 183, 15] and each pair carries a
    table index (the reference reruns the expm AND the DP serially per
    leaf, align_msa.cc:285-318; real trees have unique distances, so
    grouping by distance alone would degenerate to batch size 1)."""
    import numpy as np

    from coati_tpu.align.engine import viterbi_align_batch

    # one subst table per distinct branch length, one engine call overall
    group_of_br: dict[float, int] = {}
    leaf_nodes: list[tuple[int, float]] = []
    for node in range(len(tree)):
        if tree[node].is_leaf and tree[node].label != inp.refs:
            br = treemod.distance_ref(tree, ref_pos, node)
            leaf_nodes.append((node, br))
            group_of_br.setdefault(br, len(group_of_br))
    if not leaf_nodes:
        return

    tables = [None] * len(group_of_br)
    for br, g in group_of_br.items():
        inp.br_len = br
        utils.set_subst(inp)
        tables[g] = np.asarray(inp.subst_matrix, dtype=np.float32)

    enc_as, enc_bs, a_strs, b_strs, table_idx = [], [], [], [], []
    for node, br in leaf_nodes:
        leaf_seq = treemod.find_seq(tree[node].label, inp.data)
        ea, eb = utils.encode_marginal(ref_seq, leaf_seq)
        enc_as.append(ea)
        enc_bs.append(eb)
        a_strs.append(ref_seq)
        b_strs.append(leaf_seq)
        table_idx.append(group_of_br[br])

    results = viterbi_align_batch(
        enc_as, enc_bs, a_strs, b_strs, np.stack(tables), inp.gap,
        table_idx=table_idx,
    )
    for (node, _), r in zip(leaf_nodes, results):
        ins = insertion_flags(r.seq0, r.seq1)
        nodes_ins[node] = InsertionData.single(r.seq1, tree[node].label, ins)


def merge_alignments(visited, tree, nodes_ins, inode_indexes):
    """Merge children bottom-up until the root (align_msa.cc:336-374)."""
    while not all(visited):
        progressed = False
        for inode in inode_indexes:
            if visited[inode]:
                continue
            if any(not visited[c] for c in tree[inode].children):
                continue
            visited[inode] = True
            progressed = True
            children = tree[inode].children
            if len(children) == 1:
                nodes_ins[inode] = nodes_ins[children[0]]
                continue
            tmp = [nodes_ins[c].copy() for c in children]
            nodes_ins[inode] = merge_indels(tmp)
        if not progressed:
            # a malformed tree (cycle / unreachable inode) would otherwise
            # spin forever; the reference cannot hit this because Spirit
            # rejects such newick, but our parser is more permissive
            raise ValueError("Malformed tree: could not merge all nodes.")


def ref_indel_alignment(inp: AlignmentParams) -> bool:
    """MSA by collapsing indels along the tree (align_msa.cc:45-118)."""
    if not inp.is_marginal():
        raise ValueError("MSA only supports marginal models.")

    inp.data = read_input(inp)
    if inp.data.size() < 3:
        raise ValueError("At least three sequences required.")

    newick = treemod.read_newick(inp.tree)
    tree = treemod.parse_newick(newick)
    treemod.reroot(tree, inp.refs)
    ref_pos = treemod.find_node(tree, inp.refs)
    ref_seq = treemod.find_seq(inp.refs, inp.data)

    nodes_ins = [None] * len(tree)
    nodes_ins[ref_pos] = InsertionData.single(
        ref_seq, inp.refs, InsVector(2 * len(ref_seq))
    )

    align_leafs(inp, tree, ref_pos, ref_seq, nodes_ins)

    inode_indexes = []
    visited = [False] * len(tree)
    for node in range(len(tree)):
        if not tree[node].is_leaf:
            inode_indexes.append(node)
        else:
            visited[node] = True

    for i in range(len(tree)):
        if tree[i].parent != i:
            tree[tree[i].parent].children.append(i)

    merge_alignments(visited, tree, nodes_ins, inode_indexes)

    root = tree[ref_pos].parent
    out = AlignmentParams()
    out.output = inp.output
    merged = nodes_ins[root]
    for name in inp.data.names:
        idx = merged.names.index(name)
        out.data.names.append(merged.names[idx])
        out.data.seqs.append(merged.sequences[idx])

    write_output(out)
    return True
