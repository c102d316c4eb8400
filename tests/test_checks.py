"""The end-to-end checks chip_smoke.py runs on the card, run here on the CPU
at small sizes, and again on a GPU host under the `gpu` marker."""

import numpy as np
import pytest

import bench
from coati_tpu import backend, checks
from coati_tpu.structs import GapParams


def _pairs(n, nt, seed):
    return [bench.make_pairs(1, np.random.default_rng(seed + i),
                             length_mix=[(nt, 1.0)])[0] for i in range(n)]


@pytest.mark.parametrize("label,n", [("k1", 16), ("k3", 10), ("acgt", 12)])
def test_parity_group_matches_oracle(label, n):
    assert checks.check_parity_group(label, n) == n


def test_stacked_tables_match_oracle():
    assert checks.check_stacked_tables(8) == 8


def test_engine_matches_native(mg94_table):
    pairs = bench.make_pairs(24, np.random.default_rng(11),
                             length_mix=[(156, 0.5), (471, 0.5)])
    results = checks.align_pairs(pairs, mg94_table, GapParams())
    natives = checks.native_alignments(pairs, mg94_table, GapParams())
    assert checks.compare_with_native(results, natives) == len(pairs)


def test_compare_with_native_reports_mismatch(mg94_table):
    pairs = bench.make_pairs(2, np.random.default_rng(5),
                             length_mix=[(156, 1.0)])
    results = checks.align_pairs(pairs, mg94_table, GapParams())
    natives = checks.native_alignments(pairs, mg94_table, GapParams())
    natives[1] = (natives[1][0], natives[1][1], natives[1][2] + 1.0)
    with pytest.raises(AssertionError, match="1 of 2 pairs differ"):
        checks.compare_with_native(results, natives)


def test_batch_verb_matches_engine(mg94_table, tmp_path):
    pairs = bench.make_pairs(30, np.random.default_rng(12),
                             length_mix=[(156, 1.0)])
    keep = checks.untrimmed(pairs)
    pairs = [pairs[i] for i in keep]
    expected = checks.align_pairs(pairs, mg94_table, GapParams())
    assert checks.check_batch_cli(pairs, expected, tmp_path,
                                  platform="cpu") == len(pairs)


def test_alignpair_example_001(tmp_path):
    got = checks.check_alignpair_example(tmp_path, platform="cpu")
    assert got["alignment"]["1"] == "CTCTGGATAGTG"


def test_long_pair_segmented_matches_native(mg94_table):
    pair = _pairs(1, 900, 13)[0]
    r = checks.check_long_pair(pair, mg94_table, GapParams(), long_slots=400)
    assert np.isfinite(r.score)


def test_sample_check(mg94_table):
    pair = _pairs(1, 300, 14)[0]
    dev, corners, samples = checks.check_sample(pair, mg94_table,
                                                GapParams(), 24)
    assert dev.platform == "cpu" and len(samples) == 24


def test_triplet_check():
    model = checks.triplet_model()
    pairs = _pairs(4, 120, 15)
    from coati_tpu.triplet_wavefront import triplet_align_batch

    results = triplet_align_batch(model, pairs)
    assert checks.check_triplet(model, pairs, results, 4) == 4


# --- the same checks on the card -------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("label,n", [("k1", 80), ("k3", 24)])
def test_gpu_parity_group(gpu_device, label, n):
    with backend.platform_override("gpu"):
        assert checks.check_parity_group(label, n) == n


@pytest.mark.gpu
def test_gpu_stacked_tables(gpu_device):
    with backend.platform_override("gpu"):
        assert checks.check_stacked_tables(40) == 40


@pytest.mark.gpu
def test_gpu_engine_matches_native(gpu_device, mg94_table):
    pairs = bench.make_pairs(400, np.random.default_rng(16))
    with backend.platform_override("gpu"):
        results = checks.align_pairs(pairs, mg94_table, GapParams())
    natives = checks.native_alignments(pairs, mg94_table, GapParams())
    assert checks.compare_with_native(results, natives) == len(pairs)


@pytest.mark.gpu
def test_gpu_alignpair_example_001(gpu_device, tmp_path):
    checks.check_alignpair_example(tmp_path, platform="gpu")


@pytest.mark.gpu
def test_gpu_sample_check(gpu_device, mg94_table):
    pair = _pairs(1, 2001, 17)[0]
    with backend.platform_override("gpu"):
        dev, _, _ = checks.check_sample(pair, mg94_table, GapParams(), 50)
    assert dev.platform == "gpu"
