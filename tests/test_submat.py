"""Substitution-matrix scoring: XLA fills + BatchAligner vs the oracle."""

import numpy as np
import pytest

from cse305_parallel_sequence_alignment.core import (
    ScoringParams,
    SubstitutionMatrix,
    end_table_choice,
)
from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.models.oracle import (
    oracle_tables,
    oracle_traceback,
)

# transition (A<->G, C<->T) scored milder than transversion
TRANSITION = SubstitutionMatrix.from_array(
    "ACGT",
    np.array([
        [2, -2, -1, -2],
        [-2, 2, -2, -1],
        [-1, -2, 2, -2],
        [-2, -1, -2, 2],
    ], np.float32))


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def test_matrix_type_checks():
    with pytest.raises(ValueError):
        SubstitutionMatrix("ACGT", (1.0, 2.0))
    with pytest.raises(ValueError):
        TRANSITION.encode("ACGU")
    t = TRANSITION.table()
    assert t.shape == (5, 5)
    assert t[0, 2] == -1 and t[4, 4] == SubstitutionMatrix.PAD_SCORE


def test_matrix_equivalent_to_match_mismatch():
    """A diagonal matrix must reproduce the match/mismatch engine."""
    rng = np.random.default_rng(71)
    mat = SubstitutionMatrix.dna(match=1.0, mismatch=0.0, alphabet="ACGT")
    pairs = [(rand_seq(rng, 20), rand_seq(rng, 30)) for _ in range(4)]
    plain = BatchAligner()
    withm = BatchAligner(matrix=mat)
    s1, _ = plain.score_batch(pairs)
    s2, _ = withm.score_batch(pairs)
    np.testing.assert_array_equal(s1, s2)


def test_matrix_scores_vs_oracle():
    rng = np.random.default_rng(72)
    params = ScoringParams(g=1.0, h=2.0)
    aligner = BatchAligner(params=params, matrix=TRANSITION,
                           parity_swap=False)
    pairs = [(rand_seq(rng, m), rand_seq(rng, n))
             for (m, n) in [(15, 25), (30, 30), (8, 40)]]
    scores, tables = aligner.score_batch(pairs)
    for k, (a, b) in enumerate(pairs):
        T1, T2, T3 = oracle_tables(a, b, params, matrix=TRANSITION)
        t, s = end_table_choice(T1[-1, -1], T2[-1, -1], T3[-1, -1],
                                -1, params.h)
        assert scores[k] == s, (k, scores[k], s)
        assert tables[k] == t


def test_matrix_align_vs_oracle_chain():
    rng = np.random.default_rng(73)
    params = ScoringParams(g=1.0, h=2.0)
    aligner = BatchAligner(params=params, matrix=TRANSITION,
                           parity_swap=False)
    pairs = [(rand_seq(rng, 18), rand_seq(rng, 22)) for _ in range(3)]
    results = aligner.align_batch(pairs)
    for (a, b), res in zip(pairs, results):
        T1, T2, T3 = oracle_tables(a, b, params, matrix=TRANSITION)
        # oracle retrace needs the same f(); use a matrix-aware closure
        chain, table, score = _oracle_chain(a, b, T1, T2, T3, params)
        assert res.score == score
        assert res.chain == chain, (a, b)


def _oracle_chain(a, b, T1, T2, T3, params):
    """Matrix-aware value retrace (mirrors oracle_traceback with f from
    the matrix)."""
    tbl = TRANSITION.table()
    ca, cb = TRANSITION.encode(a), TRANSITION.encode(b)
    g, h = params.g, params.h
    m, n = len(a), len(b)
    table, score = end_table_choice(
        float(T1[m, n]), float(T2[m, n]), float(T3[m, n]), -1, h)
    end_pt = (m, n, 1) if table == 1 else \
        ((0, n, 2) if table == 2 else (m, 0, 3))
    rev = [end_pt]
    i, j, t = m, n, table
    while i > 0 and j > 0:
        if t == 1:
            f = float(tbl[ca[i - 1], cb[j - 1]])
            v = T1[i, j]
            if v == f + T1[i - 1, j - 1]:
                pt, tn = (i - 1, j - 1, 1), 1
            elif v == f + T2[i - 1, j - 1]:
                pt, tn = (0, j - 1, 2), 2
            else:
                pt, tn = (i - 1, 0, 3), 3
            i, j = i - 1, j - 1
        elif t == 2:
            v = T2[i, j]
            if v == -g - h + T1[i, j - 1]:
                pt, tn = (i, j - 1, 1), 1
            elif v == -g + T2[i, j - 1]:
                pt, tn = (0, j - 1, 2), 2
            else:
                pt, tn = (i, 0, 3), 3
            j = j - 1
        else:
            v = T3[i, j]
            if v == -g - h + T1[i - 1, j]:
                pt, tn = (i - 1, j, 1), 1
            elif v == -g - h + T2[i - 1, j]:
                pt, tn = (0, j, 2), 2
            else:
                pt, tn = (i - 1, 0, 3), 3
            i = i - 1
        rev.append(pt)
        t = tn
    return list(reversed(rev))[1:], table, score


def test_fractional_matrix_fused_vs_wavefront():
    """Matrix alignments must NOT truncate fractional substitution
    scores: an integer widening of the float32 lookup would silently
    corrupt any non-integer matrix."""
    rng = np.random.default_rng(74)
    frac = SubstitutionMatrix.from_array(
        "ACGT",
        np.array([
            [1.5, -0.5, -0.25, -0.5],
            [-0.5, 1.5, -0.5, -0.25],
            [-0.25, -0.5, 1.5, -0.5],
            [-0.5, -0.25, -0.5, 1.5],
        ], np.float32))
    params = ScoringParams(g=1.0, h=2.0)
    fused = BatchAligner(params=params, matrix=frac, parity_swap=False)
    pairs = [(rand_seq(rng, 24), rand_seq(rng, 30)) for _ in range(4)]
    results = fused.align_batch(pairs)
    for (a, b), res in zip(pairs, results):
        T1, T2, T3 = oracle_tables(a, b, params, matrix=frac)
        _, s = end_table_choice(T1[-1, -1], T2[-1, -1], T3[-1, -1],
                                -1, params.h)
        assert res.score == pytest.approx(s), (a, b, res.score, s)


def test_pallas_submat_kernel_matches_wavefront_matrix():
    """XLA matrix fill (native gather) == the oracle's tables, DNA and
    BLOSUM62, ragged lengths, two start types."""
    import jax.numpy as jnp

    from cse305_parallel_sequence_alignment.ops.wavefront import (
        wavefront_score_batch_matrix,
    )
    from cse305_parallel_sequence_alignment.utils.matrices import (
        BLOSUM62,
    )

    rng = np.random.default_rng(11)
    for mat, alpha in ((TRANSITION, "ACGT"), (BLOSUM62, None)):
        if alpha is None:
            alpha = mat.alphabet
        k = mat.k
        B, bm, bn = 4, 24, 30
        a = np.full((B, bm), k, np.uint8)
        b = np.full((B, bn), k, np.uint8)
        la = np.zeros(B, np.int32)
        lb = np.zeros(B, np.int32)
        for r in range(B):
            la[r] = int(rng.integers(1, bm + 1))
            lb[r] = int(rng.integers(1, bn + 1))
            a[r, : la[r]] = rng.integers(0, k, la[r])
            b[r, : lb[r]] = rng.integers(0, k, lb[r])
        for st in (-1, -2):
            want = np.asarray(wavefront_score_batch_matrix(
                jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                jnp.asarray(lb), jnp.asarray(mat.table()),
                g=1.0, h=2.0, start_type=st, pad_code=k))
            for r in range(B):
                sa = "".join(mat.alphabet[c] for c in a[r, : la[r]])
                sb = "".join(mat.alphabet[c] for c in b[r, : lb[r]])
                T = oracle_tables(sa, sb, ScoringParams(), start_type=st,
                                  matrix=mat)
                assert np.array_equal(
                    want[r], [t[-1, -1] for t in T]), (alpha[:8], st, r)
