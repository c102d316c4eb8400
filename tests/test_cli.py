"""End-to-end CLI verb tests (mirrors reference driver TEST_CASEs)."""

import json

import pytest

from coati_tpu.cli import main


def _write(tmp_path, name, content):
    p = tmp_path / name
    p.write_text(content)
    return str(p)


def test_alignpair_fasta_out(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">1\nCTCTGGATAGTG\n>2\nCTATAGTG\n")
    out = str(tmp_path / "out.fasta")
    assert main(["alignpair", inp, "-o", out]) == 0
    text = (tmp_path / "out.fasta").read_text()
    assert text == ">1\nCTCTGGATAGTG\n>2\nCT----ATAGTG\n"


def test_alignpair_json_out(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">1\nCTCTGGATAGTG\n>2\nCTATAGTG\n")
    out = str(tmp_path / "out.json")
    assert main(["alignpair", inp, "-o", out]) == 0
    obj = json.loads((tmp_path / "out.json").read_text())
    assert obj["alignment"] == {"1": "CTCTGGATAGTG", "2": "CT----ATAGTG"}
    assert obj["score"] == pytest.approx(1.50914, abs=1e-4)


def test_alignpair_refs(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">1\nCTATAGTG\n>2\nCTCTGGATAGTG\n")
    out = str(tmp_path / "out.fasta")
    assert main(["alignpair", inp, "-o", out, "-r", "2"]) == 0
    assert (tmp_path / "out.fasta").read_text() == (
        ">2\nCTCTGGATAGTG\n>1\nCT----ATAGTG\n"
    )


def test_alignpair_rev_ref(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">A\nGCGATTGCTGTT\n>B\nGCGACTGTT\n")
    out = str(tmp_path / "out.phy")
    assert main(["alignpair", inp, "-o", out, "-v", "-m", "mar-ecm"]) == 0
    text = (tmp_path / "out.phy").read_text()
    assert "B         GCGA---CTGTT" in text
    assert "A         GCGATTGCTGTT" in text


def test_alignpair_gap_len3(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">1\nACGTTAAGGGGT\n>2\nACGAAT\n")
    out = str(tmp_path / "out.fasta")
    assert main(["alignpair", inp, "-o", out, "-k", "3"]) == 0
    assert (tmp_path / "out.fasta").read_text() == (
        ">1\nACGTTAAGGGGT\n>2\nAC------GAAT\n"
    )


def test_alignpair_gap_len3_invalid_ref(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">1\nGCGATTGCTGT\n>2\nGCGACTGTT\n")
    assert main(["alignpair", inp, "-k", "3"]) == 1


def test_alignpair_score(tmp_path, capsys):
    inp = _write(tmp_path, "in.fasta", ">1\nCTCTGGATAGTG\n>2\nCT----ATAGTG\n")
    assert main(["alignpair", inp, "-s"]) == 0
    out = capsys.readouterr().out.strip()
    assert float(out) == pytest.approx(1.50914, abs=1e-4)


def test_alignpair_end_stop_codons(tmp_path):
    # stop codon trimmed and restored; descendant-only stop adds gaps
    inp = _write(tmp_path, "in.fasta", ">1\nATGCTT\n>2\nATGCTTTGA\n")
    out = str(tmp_path / "out.fasta")
    assert main(["alignpair", inp, "-o", out]) == 0
    text = (tmp_path / "out.fasta").read_text()
    assert text == ">1\nATGCTT---\n>2\nATGCTTTGA\n"


def test_sample_seeded(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">A\nCCCCCC\n>B\nCCCCCCCC\n")
    out = str(tmp_path / "out.json")
    assert main(["sample", inp, "-o", out, "-n", "3", "-s", "42"]) == 0
    text = (tmp_path / "out.json").read_text()
    arr = json.loads(text)
    assert [x["alignment"]["A"] for x in arr] == [
        "CC--CCCC", "CCCCCC--", "CCCC--CC"
    ]
    assert [x["alignment"]["B"] for x in arr] == ["CCCCCCCC"] * 3
    # byte format: starts with "[\n{" and 2-space indent
    assert text.startswith("[\n{\n  \"alignment\"")


def test_sample_rejects_triplet_models(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">A\nCCCCCC\n>B\nCCCCCC\n")
    assert main(["sample", inp, "-m", "tri-mg"]) == 1


def test_format_convert(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">a\nACGT\n>b\nACGT\n")
    out = str(tmp_path / "out.phy")
    assert main(["format", inp, "-o", out]) == 0
    assert (tmp_path / "out.phy").read_text().startswith("2 4\n")


def test_format_preserve_phase(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">a\nAC-GT\n>b\nACCGT\n")
    out = str(tmp_path / "out.fasta")
    assert main(["format", inp, "-o", out, "-p", "-c", "?"]) == 0
    text = (tmp_path / "out.fasta").read_text()
    assert text == ">a\nAC-??GT\n>b\nACC??GT\n"


def test_format_extract_by_name(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">a\nAAA\n>b\nCCC\n")
    out = str(tmp_path / "out.fasta")
    assert main(["format", inp, "-o", out, "-s", "b", "a"]) == 0
    assert (tmp_path / "out.fasta").read_text() == ">b\nCCC\n>a\nAAA\n"


def test_format_extract_by_pos(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">a\nAAA\n>b\nCCC\n")
    out = str(tmp_path / "out.fasta")
    assert main(["format", inp, "-o", out, "-x", "2"]) == 0
    assert (tmp_path / "out.fasta").read_text() == ">b\nCCC\n"


def test_genseed(capsys):
    assert main(["genseed", "42"]) == 0
    out1 = capsys.readouterr().out.strip()
    assert main(["genseed", "42"]) == 0
    out2 = capsys.readouterr().out.strip()
    assert out1 == out2
    assert len(out1.split("-")) == 4


def test_version(capsys):
    assert main(["version"]) == 0
    assert "coati-tpu" in capsys.readouterr().out


def test_unknown_verb(capsys):
    assert main(["bogus"]) == 1


def test_positive_number_checks(tmp_path, capsys):
    """CLI11 PositiveNumber parity (utils.cc:107-131): -t/-g/-e/-w/-b > 0."""
    inp = _write(tmp_path, "in.fasta", ">1\nCTCTGG\n>2\nCTCTGG\n")
    for flag in ("-t", "-g", "-e", "-w", "-b"):
        assert main(["alignpair", inp, flag, "0"]) != 0, flag
        assert main(["alignpair", inp, flag, "-0.5"]) != 0, flag
    for flag in ("-t", "-g", "-e", "-w"):
        assert main(["sample", inp, flag, "0"]) != 0, flag


def test_sample_sub_excludes_model(tmp_path):
    """--sub excludes --model for sample too (utils.cc:341-343)."""
    inp = _write(tmp_path, "in.fasta", ">1\nCTCTGG\n>2\nCTCTGG\n")
    rate = _write(tmp_path, "r.csv", "0.0133\n")
    assert main(["sample", inp, "--sub", rate, "-m", "mar-ecm"]) != 0


def test_format_padding_needs_preserve_phase(tmp_path):
    """-c/--padding ->needs(-p) (utils.cc:443-445)."""
    inp = _write(tmp_path, "in.fasta", ">a\nACG\n>b\nACG\n")
    assert main(["format", inp, "-c", "?"]) != 0
    assert main(["format", inp, "-p", "-c", "?"]) == 0


def test_version_machinery():
    """version_number_check_equal / version_integer inventory cases
    (reference version.cc:37-58)."""
    from coati_tpu.version import (
        check_version_number,
        version_integer,
        version_integer_from_string,
        version_number_check_equal,
    )

    assert version_number_check_equal(version_integer())
    assert not version_number_check_equal(-1)
    assert check_version_number() == 0
    assert check_version_number(-1) == 1
    # encoding formula parity: (major*1000 + minor)*10000 + patch
    assert version_integer_from_string("1.2.3") == (1000 + 2) * 10000 + 3


def test_user_rate_matrix(tmp_path):
    """--sub CSV path (mar model from user matrix)."""
    import numpy as np

    from coati_tpu.constants import CODONS61
    from coati_tpu.models import mg94_q

    q, d = mg94_q(0.2, (0.308, 0.185, 0.199, 0.308))
    q = q / d
    lines = ["0.0133"]
    for i in range(61):
        for j in range(61):
            lines.append(f"{CODONS61[i]},{CODONS61[j]},{q[i, j]:.10g}")
    csv = _write(tmp_path, "rate.csv", "\n".join(lines) + "\n")
    inp = _write(tmp_path, "in.fasta", ">1\nCTCTGGATAGTG\n>2\nCTATAGTG\n")
    out = str(tmp_path / "out.fasta")
    assert main(["alignpair", inp, "-o", out, "--sub", csv]) == 0
    assert (tmp_path / "out.fasta").read_text() == (
        ">1\nCTCTGGATAGTG\n>2\nCT----ATAGTG\n"
    )


# --- platform / device selection (backend + CLI) -----------------------------
def test_resolve_platform_flag_forms(tmp_path, monkeypatch):
    from coati_tpu.cli import _resolve_platform

    monkeypatch.delenv("COATI_TPU_FORCE_PLATFORM", raising=False)
    p, out = _resolve_platform(["alignpair", "x.fa", "--platform", "gpu"])
    assert p == "gpu" and out == ["alignpair", "x.fa"]
    p, out = _resolve_platform(["alignpair", "--platform=cpu", "x.fa"])
    assert p == "cpu" and out == ["alignpair", "x.fa"]


def test_resolve_platform_auto_by_input_size(tmp_path, monkeypatch):
    """No size rule: 'auto' stays 'auto' (JAX's default backend) for small
    and large inputs alike; the env var or the flag override it."""
    from coati_tpu.cli import _resolve_platform

    monkeypatch.delenv("COATI_TPU_FORCE_PLATFORM", raising=False)
    small = tmp_path / "small.fa"
    small.write_text(">a\nACGT\n")
    p, _ = _resolve_platform(["alignpair", str(small)])
    assert p == "auto"

    big = tmp_path / "big.fa"
    big.write_text(">a\n" + "A" * (1 << 20) + "\n")
    p, _ = _resolve_platform(["alignpair", str(big)])
    assert p == "auto"

    monkeypatch.setenv("COATI_TPU_FORCE_PLATFORM", "gpu")
    p, _ = _resolve_platform(["alignpair", str(small)])
    assert p == "gpu"
    p, _ = _resolve_platform(["alignpair", str(small), "--platform", "cpu"])
    assert p == "cpu"


def test_engine_device_selection(monkeypatch):
    from coati_tpu import backend

    monkeypatch.delenv("COATI_TPU_FORCE_PLATFORM", raising=False)
    devs = backend.devices()
    assert devs and all(d.platform == "cpu" for d in devs)
    monkeypatch.setenv("COATI_TPU_FORCE_PLATFORM", "cpu")
    assert len(backend.devices()) == len(devs)
    monkeypatch.setenv("COATI_TPU_MAX_DEVICES", "1")
    assert len(backend.devices()) == 1


@pytest.mark.parametrize("how", ["flag", "env"])
def test_cli_gpu_request_without_gpu_is_an_error(tmp_path, monkeypatch,
                                                 capsys, how):
    """Asking for the GPU where JAX finds none fails; it never runs on the
    CPU instead."""
    inp = _write(tmp_path, "in.fasta", ">1\nCTCTGGATAGTG\n>2\nCTATAGTG\n")
    out = tmp_path / "out.fasta"
    argv = ["alignpair", inp, "-o", str(out)]
    if how == "flag":
        argv += ["--platform", "gpu"]
    else:
        monkeypatch.setenv("COATI_TPU_FORCE_PLATFORM", "gpu")
    assert main(argv) == 1
    assert "no gpu device" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("value", ["rocm", "cuda", "default"])
def test_cli_rejects_unknown_platform(tmp_path, capsys, value):
    inp = _write(tmp_path, "in.fasta", ">1\nCTCTGGATAGTG\n>2\nCTATAGTG\n")
    assert main(["alignpair", inp, "--platform", value]) == 1
    assert "unknown platform" in capsys.readouterr().err


def test_cli_platform_cpu_runs_on_cpu(tmp_path):
    inp = _write(tmp_path, "in.fasta", ">1\nCTCTGGATAGTG\n>2\nCTATAGTG\n")
    out = tmp_path / "out.fasta"
    assert main(["alignpair", inp, "-o", str(out), "--platform", "cpu"]) == 0
    assert out.read_text() == ">1\nCTCTGGATAGTG\n>2\nCT----ATAGTG\n"
