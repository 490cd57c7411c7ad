"""Overlap (dovetail) mode: scores/traceback vs the serial oracle."""

import numpy as np

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.models.overlap import (
    OVERLAP_PARAMS,
    OverlapBatchAligner,
    ov_oracle_best,
)


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def test_overlap_scores_vs_oracle():
    rng = np.random.default_rng(111)
    pairs = [(rand_seq(rng, m), rand_seq(rng, n))
             for (m, n) in [(20, 30), (25, 25), (40, 15), (8, 50)]]
    scores, tables, eis, ejs = OverlapBatchAligner().score_batch(pairs)
    for k, (a, b) in enumerate(pairs):
        want, wt, wi, wj = ov_oracle_best(a, b)
        assert scores[k] == want, (k, scores[k], want)
        assert (tables[k], eis[k], ejs[k]) == (wt, wi, wj), k


def test_overlap_suffix_prefix():
    """A's suffix == B's prefix: the canonical dovetail."""
    rng = np.random.default_rng(112)
    core = rand_seq(rng, 22)
    a = rand_seq(rng, 18) + core            # ...core]
    b = core + rand_seq(rng, 25)            # [core...
    res = OverlapBatchAligner().align_batch([(a, b)])[0]
    assert res.score == OVERLAP_PARAMS.match * len(core)
    assert res.cigar == f"{len(core)}M"
    # aligned core ends at A's end and starts at B's start
    assert res.a_span == (len(a) - len(core) + 1, len(a))
    assert res.b_span == (1, len(core))


def test_overlap_chain_rescores():
    rng = np.random.default_rng(113)
    g, h, match, mismatch = OVERLAP_PARAMS.astuple()
    for _ in range(5):
        a, b = rand_seq(rng, 30), rand_seq(rng, 35)
        res = OverlapBatchAligner().align_batch([(a, b)])[0]
        score, prev = 0.0, None
        for (i, j, t) in res.chain:
            if t == 1:
                score += match if a[i - 1] == b[j - 1] else mismatch
            else:
                score -= g + (h if t != prev else 0.0)
            prev = t
        assert score == res.score, (a, b, res.chain)


def test_overlap_other_params():
    rng = np.random.default_rng(114)
    params = ScoringParams(g=2, h=1, match=2, mismatch=-3)
    a, b = rand_seq(rng, 28), rand_seq(rng, 44)
    scores, tables, eis, ejs = OverlapBatchAligner(
        params=params).score_batch([(a, b)])
    want, wt, wi, wj = ov_oracle_best(a, b, params)
    assert scores[0] == want
    assert (tables[0], eis[0], ejs[0]) == (wt, wi, wj)


def test_ov_pallas_outs_match_wavefront():
    """overlap_dirs_batch outs == overlap_score_batch (value, table, end
    cell) across ragged lengths — same end tie order."""
    import jax.numpy as jnp

    from cse305_parallel_sequence_alignment.ops.overlap import (
        overlap_dirs_batch,
        overlap_score_batch,
    )
    from cse305_parallel_sequence_alignment.ops.wavefront import (
        PAD_A,
        PAD_B,
    )

    rng = np.random.default_rng(83)
    B, bm, bn = 7, 40, 60
    a = np.full((B, bm), PAD_A, np.uint8)
    b = np.full((B, bn), PAD_B, np.uint8)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for k in range(B):
        la[k] = int(rng.integers(1, bm + 1))
        lb[k] = int(rng.integers(1, bn + 1))
        a[k, : la[k]] = rng.integers(65, 69, la[k])
        b[k, : lb[k]] = rng.integers(65, 69, lb[k])
    want = np.asarray(overlap_score_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
        jnp.asarray(lb)))
    got, _ = overlap_dirs_batch(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(la), jnp.asarray(lb))
    assert np.array_equal(np.asarray(got)[:, :4], want[:, :4])


def test_ov_pallas_align_matches_wavefront_path(monkeypatch):
    """align_batch with the device walk (the GPU path, forced here) ==
    the host walk: chains, scores, CIGARs, spans."""
    from cse305_parallel_sequence_alignment.ops import select

    rng = np.random.default_rng(89)
    pairs = [(rand_seq(rng, int(rng.integers(5, 50))),
              rand_seq(rng, int(rng.integers(5, 50)))) for _ in range(9)]
    # make a couple of real dovetails so end cells land on both edges
    pairs.append((rand_seq(rng, 30) + "ACGTACGTAC", "ACGTACGTAC"
                  + rand_seq(rng, 25)))
    pairs.append(("ACGTTGCAAC" + rand_seq(rng, 20), rand_seq(rng, 33)
                  + "ACGTTGCAAC"))
    pairs.append((rand_seq(rng, 70), rand_seq(rng, 280)))
    want = OverlapBatchAligner().align_batch(pairs)
    monkeypatch.setattr(select, "on_gpu", lambda: True)
    got = OverlapBatchAligner().align_batch(pairs)
    for g_, w_ in zip(got, want):
        assert g_.score == w_.score
        assert g_.chain == w_.chain
        assert g_.cigar == w_.cigar
        assert g_.a_span == w_.a_span and g_.b_span == w_.b_span
        assert g_.end_table == w_.end_table
