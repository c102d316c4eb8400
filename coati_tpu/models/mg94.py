"""Muse & Gaut (1994) codon substitution model and GTR nucleotide model.

The 61x61 P matrix is tiny and computed ONCE per (t, omega, pi, sigma) on
the host in float64 (scipy expm), then replicated to every device as a
constant. The reference computes the same quantity per
alignment call in float32 Eigen (/root/reference/src/lib/mutation_coati.cc:49-125);
we compute it in f64 for accuracy and vectorize the Q construction.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import expm

from coati_tpu.constants import AMINO_GROUP, CODON_NUC, YANG_1994_NUC_Q


def gtr_q(pi, sigma) -> np.ndarray:
    """General Time Reversible 4x4 Q matrix.

    Mirrors reference mutation_coati.cc:317-354: sigma order is
    (AC, AG, AT, CG, CT, GT); entries Q[i,j] = sigma_ij * pi[j].
    """
    sigma = np.asarray(sigma, dtype=np.float64)
    pi = np.asarray(pi, dtype=np.float64)
    if np.any((sigma < 0.0) | (sigma > 1.0)):
        raise ValueError("Sigma values must be in range [0,1].")

    q = np.zeros((4, 4), dtype=np.float64)
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for s, (i, j) in zip(sigma, pairs):
        q[i, j] = s
        q[j, i] = s
    q *= pi[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(axis=1))
    return q


def mg94_q(omega, pi, sigma=None):
    """Unnormalized MG94 61x61 rate matrix Q and the normalization flow d.

    Q[i,j] = omega^(nonsyn) * nuc_q[x,y] for codons one nucleotide apart,
    mirroring mutation_coati.cc:72-119 but fully vectorized.

    Returns (Q, d) where d = sum_i Pi_i * (-Q_ii) is the codon-frequency
    weighted substitution flow used to scale branch length.
    """
    pi = np.asarray(pi, dtype=np.float64)
    if sigma is not None and np.any(np.asarray(sigma, dtype=np.float64) > 0.0):
        nuc_q = gtr_q(pi, sigma)
    else:
        nuc_q = YANG_1994_NUC_Q

    nucs = CODON_NUC  # (61, 3) values 0..3
    diff = nucs[:, None, :] != nucs[None, :, :]  # (61, 61, 3)
    ndiff = diff.sum(axis=2)
    one_apart = ndiff == 1

    # position of the single differing nucleotide (valid only where one_apart)
    pos = np.argmax(diff, axis=2)
    x = np.take_along_axis(nucs[:, None, :].repeat(61, 1), pos[..., None], 2)[..., 0]
    y = np.take_along_axis(nucs[None, :, :].repeat(61, 0), pos[..., None], 2)[..., 0]

    w = np.where(AMINO_GROUP[:, None] == AMINO_GROUP[None, :], 1.0, float(omega))
    q = np.where(one_apart, w * nuc_q[x, y], 0.0)
    np.fill_diagonal(q, 0.0)
    row_sum = q.sum(axis=1)
    q[np.diag_indices(61)] = -row_sum

    codon_pi = pi[nucs[:, 0]] * pi[nucs[:, 1]] * pi[nucs[:, 2]]
    d = float((codon_pi * row_sum).sum())
    return q, d


def mg94_p(br_len, omega, pi, sigma=None) -> np.ndarray:
    """MG94 61x61 substitution probability matrix P = expm(Q * t / d).

    Matches reference mutation_coati.cc:49-125 (which stores P transposed so
    that P[i,j] = P(j | i); the same orientation is returned here: rows are
    ancestral codons, columns descendant codons).
    """
    if br_len <= 0:
        raise ValueError("Branch length must be positive.")
    q, d = mg94_q(omega, pi, sigma)
    return expm(q * (float(br_len) / d))
