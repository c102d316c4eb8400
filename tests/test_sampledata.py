"""Byte-parity suite over the REAL reference inputs (sampledata/).

Replays every reference sampledata config (alignpair all models/flags/output
formats, seeded sample, msa with newick trees) against checked-in byte
goldens, and asserts the 10k-160k stress inputs are rejected with the
reference's diagnostic (utils.cc:488-513). Mirrors the reference's
driver-level string-compare test style (align_marginal.cc:92-362).
"""

from __future__ import annotations

import contextlib
import io
import os
from pathlib import Path

import pytest

from sampledata_cases import CASES, REJECT_CASES, SAMPLEDATA, SCORE_CASES

GOLDEN = Path(__file__).parent / "data" / "sampledata_golden"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(SAMPLEDATA), reason="reference sampledata not present"
)


def run_cli(argv):
    from coati_tpu.cli import main

    buf = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, buf.getvalue(), err.getvalue()


@pytest.mark.parametrize(
    "name,argv,artifact", CASES, ids=[c[0] for c in CASES]
)
def test_sampledata_golden(name, argv, artifact, tmp_path):
    av = [a.format(sd=SAMPLEDATA, out=str(tmp_path)) for a in argv]
    rc, out, err = run_cli(av)
    assert rc == 0, (name, rc, err)
    data = (tmp_path / artifact).read_bytes() if artifact else out.encode()
    golden = (GOLDEN / f"{name}__{artifact or 'stdout.txt'}").read_bytes()
    assert data == golden, f"{name}: output drifted from golden"


@pytest.mark.parametrize(
    "name,src_case,argv", SCORE_CASES, ids=[c[0] for c in SCORE_CASES]
)
def test_sampledata_score(name, src_case, argv):
    src_name, src_art = next((n, a) for n, _, a in CASES if n == src_case)
    aligned = GOLDEN / f"{src_name}__{src_art}"
    av = [a.format(sd=SAMPLEDATA, aligned=str(aligned)) for a in argv]
    rc, out, err = run_cli(av)
    assert rc == 0, (name, rc, err)
    golden = (GOLDEN / f"{name}__stdout.txt").read_bytes()
    assert out.encode() == golden


@pytest.mark.parametrize(
    "name,argv,msg", REJECT_CASES, ids=[c[0] for c in REJECT_CASES]
)
def test_sampledata_rejected(name, argv, msg):
    av = [a.format(sd=SAMPLEDATA) for a in argv]
    rc, out, err = run_cli(av)
    assert rc != 0, f"{name}: expected rejection"
    assert msg in err, f"{name}: diagnostic drifted: {err!r}"
