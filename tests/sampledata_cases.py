"""Shared case table for the sampledata byte-parity suite.

Every reference sampledata config is driven over the REAL reference inputs
(/root/reference/sampledata) and compared byte-for-byte against goldens
checked in under tests/data/sampledata_golden/ (generated once by
tools/gen_sampledata_goldens.py from outputs verified against the
reference implementation's published fixtures; e.g. alignpair on
example-001 scores 1.5091344, the value in
/root/reference/src/lib/align_marginal.cc:92-130's test style).

Placeholders: {sd} = sampledata dir, {out} = scratch output dir.
A case's `artifact` is the produced file name, or None when the verb's
product is stdout (captured instead).
"""

SAMPLEDATA = "/root/reference/sampledata"

# (name, argv, artifact-or-None)
CASES = [
    # --- alignpair, marginal models, all output formats ---------------------
    ("alignpair-001-json",
     ["alignpair", "{sd}/example-001.fasta", "-o", "{out}/a.json"], "a.json"),
    ("alignpair-001-fasta",
     ["alignpair", "{sd}/example-001.fasta", "-o", "{out}/a.fasta"],
     "a.fasta"),
    ("alignpair-001-phy",
     ["alignpair", "{sd}/example-001.fasta", "-o", "{out}/a.phy"], "a.phy"),
    ("alignpair-002-ecm-t05",
     ["alignpair", "{sd}/example-002.fasta", "-m", "mar-ecm", "-t", "0.05",
      "-o", "{out}/a.json"], "a.json"),
    ("alignpair-003-params",
     ["alignpair", "{sd}/example-003.fasta", "-t", "0.2", "-w", "0.5",
      "-p", "0.3", "0.2", "0.2", "0.3", "-o", "{out}/a.fasta"], "a.fasta"),
    ("alignpair-003-gap-params",
     ["alignpair", "{sd}/example-003.fasta", "-g", "0.05", "-e", "0.6",
      "-o", "{out}/a.json"], "a.json"),
    ("alignpair-002-rev",
     ["alignpair", "{sd}/example-002.fasta", "-v", "-o", "{out}/a.json"],
     "a.json"),
    ("alignpair-002-ref2",
     ["alignpair", "{sd}/example-002.fasta", "-r", "2", "-o", "{out}/a.json"],
     "a.json"),
    # --- alignpair, triplet models (FST-path replacement) -------------------
    ("alignpair-001-trimg",
     ["alignpair", "{sd}/example-001.fasta", "-m", "tri-mg",
      "-o", "{out}/a.json"], "a.json"),
    ("alignpair-002-triecm",
     ["alignpair", "{sd}/example-002.fasta", "-m", "tri-ecm",
      "-o", "{out}/a.fasta"], "a.fasta"),
    ("alignpair-001-dna",
     ["alignpair", "{sd}/example-001.fasta", "-m", "dna",
      "-o", "{out}/a.json"], "a.json"),
    # --- seeded sampling (streamed JSON array) -------------------------------
    ("sample-003-seed42",
     ["sample", "{sd}/example-003.fasta", "-n", "10", "-s", "42",
      "-o", "{out}/s.json"], "s.json"),
    ("sample-001-seed42-n3",
     ["sample", "{sd}/example-001.fasta", "-n", "3", "-s", "42",
      "-o", "{out}/s.json"], "s.json"),
    # --- msa over the three trees --------------------------------------------
    ("msa-001",
     ["msa", "{sd}/example-msa-001.fasta", "{sd}/example-msa-001.newick",
      "A", "-o", "{out}/m.fasta"], "m.fasta"),
    ("msa-002",
     ["msa", "{sd}/example-msa-002.fasta", "{sd}/example-msa-002.newick",
      "A", "-o", "{out}/m.json"], "m.json"),
    ("msa-003",
     ["msa", "{sd}/example-msa-003.fasta", "{sd}/example-msa-003.newick",
      "A", "-o", "{out}/m.phy"], "m.phy"),
]

# scoring (-s) replays a golden aligned artifact and prints to stdout
SCORE_CASES = [
    ("score-001", "alignpair-001-fasta",
     ["alignpair", "{aligned}", "-s"]),
    ("score-002-ecm", "alignpair-002-ecm-t05",
     ["alignpair", "{aligned}", "-m", "mar-ecm", "-t", "0.05", "-s"]),
]

# the reference rejects these inputs (internal early stop codons, or
# reference length not a codon multiple); we must fail identically with the
# matching diagnostic (utils.cc:488-513, :809-838)
REJECT_CASES = [
    ("reject-10k", ["alignpair", "{sd}/example-10k.fasta"],
     "Early stop codon"),
    ("reject-20k-ecm", ["alignpair", "{sd}/example-20k.fasta",
                        "-m", "mar-ecm"], "Early stop codon"),
    ("reject-40k", ["alignpair", "{sd}/example-40k.fasta"],
     "Early stop codon"),
    ("reject-80k", ["alignpair", "{sd}/example-80k.fasta"],
     "Early stop codon"),
    ("reject-160k", ["alignpair", "{sd}/example-160k.fasta"],
     "Early stop codon"),
    ("reject-001-rev", ["alignpair", "{sd}/example-001.fasta", "-v"],
     "multiple of 3"),
]
