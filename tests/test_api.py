"""Top-level convenience API (api.py)."""

import numpy as np
import pytest

from cse305_parallel_sequence_alignment import (
    align,
    align_pairs,
    score_pairs,
)
from cse305_parallel_sequence_alignment.models.oracle import oracle_align


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def test_align_global_default():
    res = align("AGGA", "AGTGC")
    want = oracle_align("AGGA", "AGTGC")
    assert res.score == want.score and res.aligned_a == want.aligned_a


def test_align_every_mode_runs():
    rng = np.random.default_rng(121)
    a, b = rand_seq(rng, 30), rand_seq(rng, 36)
    assert align(a, b, mode="global").score is not None
    assert align(a, b, mode="local").cigar is not None
    assert align(a, b, mode="semiglobal").cigar is not None
    assert align(a, b, mode="overlap").cigar is not None
    assert align(a, b, mode="banded", band=40).score is not None
    assert align(a, b, mode="partitioned", p=2).score == \
        oracle_align(a, b).score
    with pytest.raises(ValueError):
        align(a, b, mode="nope")


def test_batched_api():
    rng = np.random.default_rng(122)
    pairs = [(rand_seq(rng, 20), rand_seq(rng, 25)) for _ in range(5)]
    scores, tables = score_pairs(pairs)
    results = align_pairs(pairs)
    for k, (a, b) in enumerate(pairs):
        want = oracle_align(a, b)
        assert scores[k] == want.score
        assert results[k].aligned_a == want.aligned_a
