"""Row-scan fill + direction traceback vs oracle and golden records."""

import numpy as np
import pytest

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.models.gotoh import GotohAligner
from cse305_parallel_sequence_alignment.models.oracle import (
    oracle_align,
    oracle_tables,
)


def rand_pair(rng, m, n):
    return ("".join(rng.choice(list("ACGT"), m)),
            "".join(rng.choice(list("ACGT"), n)))


def test_tables_match_oracle_all_start_types():
    rng = np.random.default_rng(1)
    a, b = rand_pair(rng, 17, 23)
    for start in [-1, -2, -3, 1, 2, 3]:
        aligner = GotohAligner(start_type=start)
        T1, T2, T3 = aligner.tables(a, b)
        O1, O2, O3 = oracle_tables(a, b, start_type=start)
        np.testing.assert_array_equal(T1, O1)
        np.testing.assert_array_equal(T2, O2)
        np.testing.assert_array_equal(T3, O3)


@pytest.mark.parametrize("g,h", [(1, 2), (2, 1), (1, 0), (3, 5)])
def test_align_matches_oracle_random(g, h):
    rng = np.random.default_rng(2)
    params = ScoringParams(g=g, h=h)
    aligner = GotohAligner(params=params)
    for (m, n) in [(5, 5), (12, 9), (30, 41), (64, 64)]:
        a, b = rand_pair(rng, m, n)
        got = aligner.align(a, b)
        want = oracle_align(a, b, params)
        assert got.chain == want.chain, (a, b, g, h)
        assert got.score == want.score
        assert got.aligned_a == want.aligned_a
        assert got.aligned_b == want.aligned_b


def test_align_golden_pipeline(golden_pipeline):
    for rec in golden_pipeline:
        aligner = GotohAligner(params=ScoringParams(g=rec["g"], h=rec["h"]))
        res = aligner.align(rec["A"], rec["B"])
        assert res.aligned_a == rec["out_a"], rec
        assert res.aligned_b == rec["out_b"], rec


def test_boundary_types_vs_oracle():
    rng = np.random.default_rng(3)
    a, b = rand_pair(rng, 11, 13)
    for start in [-1, -2, -3, 1, 2, 3]:
        for end in [-1, -2, -3, 1, 2, 3]:
            aligner = GotohAligner(start_type=start, end_type=end)
            got = aligner.align(a, b)
            want = oracle_align(a, b, start_type=start, end_type=end)
            assert got.chain == want.chain, (start, end)
            assert got.score == want.score


def test_score_only_matches_align():
    rng = np.random.default_rng(4)
    a, b = rand_pair(rng, 40, 50)
    aligner = GotohAligner()
    assert aligner.score(a, b) == aligner.align(a, b).score
