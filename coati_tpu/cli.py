"""Command-line interface: coati-tpu <verb> with reference-compatible flags.

Verbs and options mirror the reference CLI11 definitions
(/root/reference/src/lib/utils.cc:93-451, src/coati.cc.in:62-79):
    alignpair | msa | sample | format | genseed | version
"""

from __future__ import annotations

import argparse
import sys

from coati_tpu import __version__
from coati_tpu.models.marginal import AmbiguousNucs, MarginalSubst
from coati_tpu.structs import AlignmentParams

PROG = "coati-tpu"


def _positive_float(s: str) -> float:
    """CLI11 PositiveNumber check parity (utils.cc:107-131): value > 0."""
    v = float(s)
    if not v > 0:
        raise argparse.ArgumentTypeError(f"{s} is not a positive number")
    return v


def _add_model_opts(p, models_help, sample=False):
    p.add_argument("input", help="Input file (FASTA/PHYLIP/JSON accepted)")
    p.add_argument("-m", "--model", default="mar-mg", help=models_help)
    p.add_argument("--sub", default="", dest="rate",
                   help="File with branch lengths and codon subst matrix")
    p.add_argument("-t", "--time", type=_positive_float, default=0.0133,
                   dest="br_len", help="Evolutionary time/branch length")
    p.add_argument("-o", "--output", default="", help="Alignment output file")
    p.add_argument("-g", "--gap-open", type=_positive_float, default=0.001,
                   help="Gap opening score")
    p.add_argument("-e", "--gap-extend", type=_positive_float,
                   default=1.0 - 1.0 / 6.0, help="Gap extension score")
    p.add_argument("-w", "--omega", type=_positive_float, default=0.2,
                   help="Nonsynonymous-synonymous bias")
    p.add_argument("-p", "--pi", type=float, nargs=4,
                   default=[0.308, 0.185, 0.199, 0.308],
                   help="Nucleotide frequencies (A C G T)")
    p.add_argument("-k", "--gap-len", type=int, default=1, help="Gap unit length")
    p.add_argument("-x", "--sigma", type=float, nargs=6, default=[0.0] * 6,
                   help="GTR sigma parameters (AC AG AT CG CT GT)")
    p.add_argument("-a", "--ambiguous", default="SUM",
                   type=lambda s: s.upper(), choices=["SUM", "BEST"],
                   help="Ambiguous nucleotides model")
    p.add_argument("--marginal-sub", default="SUM",
                   type=lambda s: s.upper(), choices=["SUM", "MAX"],
                   help="Marginal substitution option")


def _fill_aln(args) -> AlignmentParams:
    aln = AlignmentParams()
    aln.data.path = args.input
    aln.model = args.model
    aln.rate = getattr(args, "rate", "")
    aln.br_len = args.br_len
    aln.output = args.output
    aln.gap.open = args.gap_open
    aln.gap.extend = args.gap_extend
    aln.gap.len = args.gap_len
    aln.omega = args.omega
    aln.pi = tuple(args.pi)
    aln.sigma = tuple(args.sigma)
    aln.amb = AmbiguousNucs(args.ambiguous)
    aln.sub = MarginalSubst(getattr(args, "marginal_sub", "SUM"))
    if hasattr(args, "base_error"):
        aln.bc_error = args.base_error
    return aln


def cmd_alignpair(argv) -> int:
    p = argparse.ArgumentParser(
        prog=f"{PROG} alignpair",
        description="coati alignpair - pairwise alignment of nucleotide sequences",
    )
    _add_model_opts(p, "Substitution model (dna tri-mg tri-ecm mar-mg mar-ecm)")
    p.add_argument("-r", "--ref", default="", dest="refs",
                   help="Name of reference sequence (default: 1st seq)")
    p.add_argument("-v", "--rev-ref", action="store_true", dest="rev",
                   help="Use 2nd seq as reference")
    p.add_argument("-s", "--score", action="store_true",
                   help="Score input alignment and exit")
    p.add_argument("-b", "--base-error", type=_positive_float, default=0.0001,
                   help="Base calling error rate")
    args = p.parse_args(argv)
    if args.rate and args.model != "mar-mg":
        p.error("--sub excludes --model")
    if args.refs and args.rev:
        p.error("-r excludes -v")

    aln = _fill_aln(args)
    aln.refs = args.refs
    aln.rev = args.rev
    aln.score = args.score

    if aln.is_marginal():
        from coati_tpu.driver import marg_alignment

        return 0 if marg_alignment(aln) else 1
    from coati_tpu.triplet_hmm import triplet_align_driver

    return 0 if triplet_align_driver(aln) else 1


def cmd_sample(argv) -> int:
    p = argparse.ArgumentParser(
        prog=f"{PROG} sample",
        description="coati sample - align two sequences and sample alignments",
    )
    _add_model_opts(p, "Substitution model (mar-mg mar-ecm)", sample=True)
    p.add_argument("-n", "--sample-size", type=int, default=1, help="Sample size")
    p.add_argument("-s", "--seed", nargs="+", default=[],
                   help="Space separated list of seed(s) used for sampling")
    args = p.parse_args(argv)
    if args.rate and args.model != "mar-mg":
        p.error("--sub excludes --model")

    aln = _fill_aln(args)
    if not aln.is_marginal():
        print(
            "ERROR: Sampling only available with models mar-mg or mar-ecm.",
            file=sys.stderr,
        )
        return 1

    from coati_tpu.driver import marg_sample
    from coati_tpu.rng import (
        Lehmer64,
        auto_seed_seq,
        seed_random,
        string_seed_seq,
    )

    rng = Lehmer64()
    ss = string_seed_seq(args.seed) if args.seed else auto_seed_seq()
    seed_random(rng, ss)
    marg_sample(aln, args.sample_size, rng)
    return 0


def cmd_msa(argv) -> int:
    p = argparse.ArgumentParser(
        prog=f"{PROG} msa",
        description="coati msa - multiple sequence alignment of nucleotide sequences",
    )
    _add_model_opts(p, "Substitution model (mar-mg mar-ecm)")
    # reposition positional args: msa takes input tree reference
    p.add_argument("tree", help="Newick phylogenetic tree")
    p.add_argument("reference", help="Name of reference sequence")
    args = p.parse_args(argv)

    aln = _fill_aln(args)
    aln.tree = args.tree
    aln.refs = args.reference

    from coati_tpu.msa.msa import ref_indel_alignment

    return 0 if ref_indel_alignment(aln) else 1


def cmd_format(argv) -> int:
    p = argparse.ArgumentParser(
        prog=f"{PROG} format",
        description="coati format - convert between formats, extract or reorder sequences",
    )
    p.add_argument("input", help="Input file (FASTA/PHYLIP/JSON accepted)")
    p.add_argument("-o", "--output", default="", help="Alignment output file")
    p.add_argument("-p", "--preserve-phase", action="store_true",
                   help="Preserve phase")
    p.add_argument("-c", "--padding", default=None,
                   help="Padding char to format preserve phase")
    p.add_argument("-s", "--cut-seqs", nargs="+", default=[],
                   help="Name of sequences to extract")
    p.add_argument("-x", "--cut-pos", type=int, nargs="+", default=[],
                   help="Position of sequences to extract (1 based)")
    args = p.parse_args(argv)
    if args.cut_seqs and args.cut_pos:
        p.error("-x excludes -s")
    if args.padding is not None and not args.preserve_phase:
        # CLI11: padding option ->needs(phase) (utils.cc:443-445)
        p.error("-c/--padding needs -p/--preserve-phase")

    from coati_tpu.format import FormatArgs, format_sequences
    from coati_tpu.io import read_input

    aln = AlignmentParams()
    aln.data.path = args.input
    aln.output = args.output
    aln.data = read_input(aln)
    fmt = FormatArgs(
        preserve_phase=args.preserve_phase,
        padding=args.padding if args.padding is not None else "?",
        names=list(args.cut_seqs),
        pos=list(args.cut_pos),
    )
    return format_sequences(fmt, aln)


def cmd_genseed(argv) -> int:
    from coati_tpu.rng import (
        Lehmer64,
        auto_seed_seq,
        encode_seed,
        seed_random,
        string_seed_seq,
    )

    rng = Lehmer64()
    ss = string_seed_seq(argv) if argv else auto_seed_seq()
    seed_random(rng, ss)
    print(encode_seed(rng.get_seed_u32x4()))
    return 0


def cmd_version(argv) -> int:
    print(f"{PROG} v{__version__}")
    return 0


def cmd_batch(argv) -> int:
    from coati_tpu.batchrun import cmd_batch as run

    return run(argv)


VERBS = {
    "alignpair": cmd_alignpair,
    "msa": cmd_msa,
    "sample": cmd_sample,
    "format": cmd_format,
    "genseed": cmd_genseed,
    "version": cmd_version,
    "batch": cmd_batch,
}


def _resolve_platform(argv):
    """Parse/strip --platform. Pure: returns (platform, argv-without-the-
    flag), the platform from the flag, else COATI_TPU_FORCE_PLATFORM, else
    'auto'; backend.requested_platform validates it."""
    import os

    from coati_tpu.backend import ENV_PLATFORM

    platform = os.environ.get(ENV_PLATFORM, "auto") or "auto"
    out = []
    i = 0
    while i < len(argv):
        if argv[i] == "--platform" and i + 1 < len(argv):
            platform = argv[i + 1]
            i += 2
            continue
        if argv[i].startswith("--platform="):
            platform = argv[i].split("=", 1)[1]
            i += 1
            continue
        out.append(argv[i])
        i += 1
    return platform, out


def main(argv=None) -> int:
    """`--platform {auto,cpu,gpu}` picks the devices for this verb (see
    backend.py): gpu with no GPU present is an error, and cpu keeps JAX off
    any accelerator."""
    argv = list(sys.argv[1:] if argv is None else argv)
    platform, argv = _resolve_platform(argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(f"Usage: {PROG} command [options]\n\nCommands available:")
        for v in VERBS:
            print(f"  {v}")
        return 0 if argv else 1
    verb = argv[0]
    if verb not in VERBS:
        print(f"ERROR: command {verb} not supported.", file=sys.stderr)
        return 1
    from coati_tpu import backend

    try:
        with backend.platform_override(platform):
            if platform == "cpu":
                import jax

                # before any backend initializes, so no accelerator is
                # touched; once initialized, backend.devices() still
                # picks the CPU
                try:
                    jax.config.update("jax_platforms", "cpu")
                except RuntimeError:
                    pass
            elif platform == "gpu":
                backend.devices()  # fail now when there is no GPU
            # runtime header/library version cross-check (reference
            # verb.hpp:44-49)
            from coati_tpu.version import check_version_number

            rc = check_version_number()
            return rc if rc != 0 else VERBS[verb](argv[1:])
    except SystemExit as exc:  # argparse validation errors (exit code 2)
        return int(exc.code) if exc.code else 0
    except (ValueError, RuntimeError, OSError) as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
