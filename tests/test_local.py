"""Smith-Waterman local mode: scores, traceback, CIGARs vs the SW oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.models.local import (
    LocalBatchAligner,
)
from cse305_parallel_sequence_alignment.models.local_oracle import (
    LOCAL_PARAMS,
    sw_oracle_align,
    sw_oracle_best,
)
from cse305_parallel_sequence_alignment.ops.cigar import (
    cigar_consumed,
)
from cse305_parallel_sequence_alignment.ops.local import sw_score_batch
from cse305_parallel_sequence_alignment.ops.wavefront import PAD_A, PAD_B


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _batch(pairs):
    B = len(pairs)
    m = max(len(a) for a, _ in pairs)
    n = max(len(b) for _, b in pairs)
    a = np.full((B, m), PAD_A, np.uint8)
    b = np.full((B, n), PAD_B, np.uint8)
    la = np.zeros((B,), np.int32)
    lb = np.zeros((B,), np.int32)
    for k, (sa, sb) in enumerate(pairs):
        ea = np.frombuffer(sa.encode(), np.uint8)
        eb = np.frombuffer(sb.encode(), np.uint8)
        la[k], lb[k] = len(ea), len(eb)
        a[k, : len(ea)] = ea
        b[k, : len(eb)] = eb
    return a, b, la, lb


def test_sw_scores_vs_oracle():
    rng = np.random.default_rng(11)
    pairs = [(rand_seq(rng, m), rand_seq(rng, n))
             for (m, n) in [(20, 30), (40, 40), (64, 33), (10, 80)]]
    a, b, la, lb = _batch(pairs)
    g, h, match, mismatch = LOCAL_PARAMS.astuple()
    best = np.asarray(sw_score_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
        g=g, h=h, match=match, mismatch=mismatch))
    for k, (sa, sb) in enumerate(pairs):
        score, bi, bj = sw_oracle_best(sa, sb)
        assert best[k, 0] == score, (k, best[k], score)
        assert (int(best[k, 1]), int(best[k, 2])) == (bi, bj), k


@pytest.mark.parametrize("params", [LOCAL_PARAMS,
                                    ScoringParams(g=2.0, h=1.0, match=3.0,
                                                  mismatch=-2.0)])
def test_sw_ragged_batch_vs_oracle(params):
    """Ragged pairs in one bucket: every pair's best score and end cell
    equal the serial SW oracle's."""
    rng = np.random.default_rng(17)
    pairs = [(rand_seq(rng, int(rng.integers(1, 50))),
              rand_seq(rng, int(rng.integers(1, 50)))) for _ in range(7)]
    scores, ei, ej = LocalBatchAligner(params=params).score_batch(pairs)
    for k, (sa, sb) in enumerate(pairs):
        score, bi, bj = sw_oracle_best(sa, sb, params)
        assert scores[k] == score, k
        if score > 0:
            assert (ei[k], ej[k]) == (bi, bj), k


def test_sw_align_matches_oracle_chain():
    rng = np.random.default_rng(12)
    pairs = [(rand_seq(rng, 30), rand_seq(rng, 42)) for _ in range(6)]
    results = LocalBatchAligner().align_batch(pairs)
    for (sa, sb), res in zip(pairs, results):
        score, chain = sw_oracle_align(sa, sb)
        assert res.score == score
        assert res.chain == chain, (sa, sb)


def test_sw_embedded_motif():
    """A strong shared motif inside unrelated flanks must be recovered."""
    rng = np.random.default_rng(13)
    motif = rand_seq(rng, 25)
    a = rand_seq(rng, 15) + motif + rand_seq(rng, 10)
    b = rand_seq(rng, 30) + motif + rand_seq(rng, 5)
    res = LocalBatchAligner().align_batch([(a, b)])[0]
    g, h, match, mismatch = LOCAL_PARAMS.astuple()
    assert res.score >= match * len(motif)
    # the aligned segment must contain the motif span
    assert a[res.start_a - 1: res.end_a].find(motif) != -1 or \
        res.end_a - res.start_a + 1 >= len(motif)


def test_sw_cigar_consistency():
    rng = np.random.default_rng(14)
    pairs = [(rand_seq(rng, 50), rand_seq(rng, 50)) for _ in range(4)]
    results = LocalBatchAligner().align_batch(pairs)
    for res in results:
        if not res.chain:
            continue
        q, r = cigar_consumed(res.cigar)
        assert q == res.end_a - res.start_a + 1
        assert r == res.end_b - res.start_b + 1
        qx, rx = cigar_consumed(res.cigar_extended)
        assert (qx, rx) == (q, r)


def test_sw_chain_scores_consistent():
    """Re-score the emitted chain independently; must equal the score."""
    rng = np.random.default_rng(15)
    g, h, match, mismatch = LOCAL_PARAMS.astuple()
    for _ in range(5):
        a, b = rand_seq(rng, 40), rand_seq(rng, 40)
        res = LocalBatchAligner().align_batch([(a, b)])[0]
        score, prev_t = 0.0, None
        for (i, j, t) in res.chain:
            if t == 1:
                score += match if a[i - 1] == b[j - 1] else mismatch
            else:
                score -= g + (h if t != prev_t else 0.0)
            prev_t = t
        assert score == res.score, (a, b, res.chain)


def test_sw_identical_sequences():
    s = "ACGTACGTAA"
    res = LocalBatchAligner().align_batch([(s, s)])[0]
    g, h, match, mismatch = LOCAL_PARAMS.astuple()
    assert res.score == match * len(s)
    assert res.cigar == f"{len(s)}M"
    assert res.cigar_extended == f"{len(s)}="
    assert (res.start_a, res.start_b, res.end_a, res.end_b) == (
        1, 1, len(s), len(s))


def test_sw_no_positive_score():
    """All-mismatch pair yields an empty local alignment."""
    res = LocalBatchAligner().align_batch([("AAAA", "TTTT")])[0]
    assert res.score == 0.0 and res.chain == []


def test_sw_other_params():
    rng = np.random.default_rng(16)
    params = ScoringParams(g=2, h=3, match=3, mismatch=-2)
    a, b = rand_seq(rng, 45), rand_seq(rng, 60)
    res = LocalBatchAligner(params=params).align_batch([(a, b)])[0]
    want_score, want_chain = sw_oracle_align(a, b, params)
    assert res.score == want_score
    assert res.chain == want_chain
