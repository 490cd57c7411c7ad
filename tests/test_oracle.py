"""Oracle correctness: pinned reference tables + golden parity.

The pinned tables below were printed by the repaired reference's
``non_parallel_tables`` (subproblem_alignment.cpp:357-422) for
A=AGGA, B=AGTGC, g=1, h=2, start=end=-1 (SURVEY.md §4.1).
"""

import numpy as np
import pytest

from cse305_parallel_sequence_alignment.core import NEG_INF, ScoringParams
from cse305_parallel_sequence_alignment.models.oracle import (
    format_alignment,
    oracle_align,
    oracle_tables,
    oracle_traceback,
)

I = NEG_INF

PINNED_T1 = [
    [0, I, I, I, I, I],
    [I, 1, -3, -4, -5, -6],
    [I, -3, 2, -2, -2, -4],
    [I, -4, -1, 2, 0, -2],
    [I, -4, -3, -1, 2, 0],
]
PINNED_T2 = [
    [I, -3, -4, -5, -6, -7],
    [I, -6, -2, -3, -4, -5],
    [I, -7, -5, -1, -2, -3],
    [I, -8, -6, -4, -1, -2],
    [I, -9, -7, -5, -4, -1],
]
PINNED_T3 = [
    [I, I, I, I, I, I],
    [-3, -6, -7, -8, -9, -10],
    [-4, -2, -5, -6, -7, -8],
    [-5, -3, -1, -4, -5, -6],
    [-6, -4, -2, -1, -3, -5],
]


def test_pinned_tables():
    T1, T2, T3 = oracle_tables("AGGA", "AGTGC")
    np.testing.assert_array_equal(T1, np.array(PINNED_T1, np.float32))
    np.testing.assert_array_equal(T2, np.array(PINNED_T2, np.float32))
    np.testing.assert_array_equal(T3, np.array(PINNED_T3, np.float32))


def test_pinned_traceback():
    res = oracle_align("AGGA", "AGTGC")
    assert res.score == 0.0
    assert res.chain == [(1, 1, 1), (2, 2, 1), (0, 3, 2), (3, 4, 1),
                         (4, 5, 1)]
    assert res.aligned_a == "AG-GA"
    assert res.aligned_b == "AGTGC"


def test_golden_pipeline(golden_pipeline):
    for rec in golden_pipeline:
        res = oracle_align(rec["A"], rec["B"],
                           ScoringParams(g=rec["g"], h=rec["h"]))
        assert res.aligned_a == rec["out_a"], rec
        assert res.aligned_b == rec["out_b"], rec


def test_golden_subproblem_boundaries(golden_subproblem):
    for rec in golden_subproblem:
        a, b = rec["A"], rec["B"]
        if len(a) > len(b):  # constructor swap, B8
            a, b = b, a
        params = ScoringParams(g=rec["g"], h=rec["h"])
        T1, T2, T3 = oracle_tables(a, b, params, rec["start"])
        m, n = len(a), len(b)
        got = [T1[m, n], T2[m, n], T3[m, n]]
        want = [NEG_INF if v == "-inf" else float(v) for v in rec["final"]]
        assert got == want, rec
        chain, _, _ = oracle_traceback(a, b, T1, T2, T3, params, rec["end"])
        chain_str = "".join(f"({i},{j},{t})" for (i, j, t) in chain)
        assert chain_str == rec["chain"], rec


def test_format_alignment_gap_rows():
    # a chain with a gap-in-B point (t=3, j stored as 0, quirk B2)
    chain = [(1, 1, 1), (2, 0, 3), (3, 2, 1)]
    row_a, row_b = format_alignment("ACG", "AG", chain)
    assert row_a == "ACG"
    assert row_b == "A-G"


@pytest.mark.parametrize("m,n", [(8, 5), (5, 8)])
def test_parity_swap(m, n):
    rng = np.random.default_rng(0)
    a = "".join(rng.choice(list("ACGT"), m))
    b = "".join(rng.choice(list("ACGT"), n))
    res = oracle_align(a, b)
    swapped = oracle_align(b, a)
    # B8: roles swap when m > n, so both calls see the same problem.
    assert res.chain == swapped.chain
    assert res.score == swapped.score
