"""Banded alignment: wide-band equivalence, narrow-band validity."""

import numpy as np
import pytest

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.models.banded import (
    BandedAligner,
)
from cse305_parallel_sequence_alignment.models.oracle import oracle_align
from cse305_parallel_sequence_alignment.ops.banded import (
    band_check,
    banded_score,
)
from cse305_parallel_sequence_alignment.parallel.partition import (
    score_chain,
)
from cse305_parallel_sequence_alignment.core import encode_seq


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def mutate(rng, s, subs=3, indels=1):
    out = list(s)
    for _ in range(subs):
        p = int(rng.integers(0, len(out)))
        out[p] = rng.choice(list("ACGT"))
    for _ in range(indels):
        p = int(rng.integers(0, len(out)))
        if rng.random() < 0.5:
            out.insert(p, rng.choice(list("ACGT")))
        else:
            del out[p]
    return "".join(out)


def test_band_check():
    band_check(10, 10, 0, 0)
    with pytest.raises(ValueError):
        band_check(10, 20, 5, 5)  # n - m = 10 > w_hi
    with pytest.raises(ValueError):
        band_check(20, 10, 5, 5)


def test_wide_band_equals_full_dp():
    rng = np.random.default_rng(101)
    for _ in range(5):
        m = int(rng.integers(10, 50))
        n = int(rng.integers(max(1, m - 8), m + 8))
        a, b = rand_seq(rng, m), rand_seq(rng, n)
        aligner = BandedAligner(w_lo=m + 2, w_hi=n + 2)
        want = oracle_align(a, b, parity_swap=False)
        got = aligner.align(a, b)
        assert got.score == want.score, (a, b)
        assert got.chain == want.chain, (a, b)
        assert got.aligned_a == want.aligned_a


@pytest.mark.parametrize("start,end", [(-1, -1), (-2, -3), (1, 2),
                                       (3, -2)])
def test_wide_band_boundary_types(start, end):
    """Anchored start/end types through the banded fill and walk equal
    the full-DP oracle when the band covers the grid."""
    rng = np.random.default_rng(107)
    for _ in range(3):
        m = int(rng.integers(8, 30))
        n = int(rng.integers(max(1, m - 6), m + 6))
        a, b = rand_seq(rng, m), rand_seq(rng, n)
        got = BandedAligner(w_lo=m + 2, w_hi=n + 2, start_type=start,
                            end_type=end).align(a, b)
        want = oracle_align(a, b, start_type=start, end_type=end,
                            parity_swap=False)
        assert got.score == want.score, (a, b)
        assert got.chain == want.chain, (a, b)


def test_narrow_band_on_similar_pairs():
    """Mutated copies: a modest band already reaches the true optimum."""
    rng = np.random.default_rng(102)
    for _ in range(4):
        a = rand_seq(rng, 80)
        b = mutate(rng, a, subs=4, indels=2)
        aligner = BandedAligner(w_lo=16, w_hi=16)
        want = oracle_align(a, b, parity_swap=False)
        got = aligner.align(a, b)
        assert got.score == want.score, (a, b)


def test_narrow_band_chain_is_valid():
    """Even when sub-optimal, the banded chain re-scores to its value."""
    rng = np.random.default_rng(103)
    a, b = rand_seq(rng, 60), rand_seq(rng, 60)
    params = ScoringParams()
    aligner = BandedAligner(params=params, w_lo=3, w_hi=3,
                            traceback_mode="full")
    got = aligner.align(a, b)
    full = oracle_align(a, b, parity_swap=False)
    assert got.score <= full.score
    # full-mode chains cover the whole grid: re-scoring is exact
    ea, eb = encode_seq(a), encode_seq(b)
    assert score_chain(ea, eb, got.chain, params) == got.score


def test_banded_score_batch():
    from cse305_parallel_sequence_alignment.ops.banded import (
        banded_score_batch,
    )
    rng = np.random.default_rng(105)
    B, m = 5, 48
    a = np.stack([encode_seq(rand_seq(rng, m)) for _ in range(B)])
    b = np.stack([encode_seq(mutate(rng, bytes(x).decode(), 3, 0))
                  for x in a])
    got = banded_score_batch(a, b, w_lo=12, w_hi=12)
    for k in range(B):
        want = banded_score(a[k], b[k], w_lo=12, w_hi=12)
        np.testing.assert_array_equal(got[k], want)


def test_banded_score_only_matches_align():
    rng = np.random.default_rng(104)
    a = rand_seq(rng, 40)
    b = mutate(rng, a, subs=2, indels=1)
    aligner = BandedAligner(w_lo=10, w_hi=10)
    assert aligner.score(a, b) == aligner.align(a, b).score
