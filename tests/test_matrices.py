"""Shipped substitution matrices + protein alignment end to end."""

import numpy as np

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.models.oracle import (
    oracle_tables,
)
from cse305_parallel_sequence_alignment.core import end_table_choice
from cse305_parallel_sequence_alignment.utils.matrices import (
    BLOSUM62,
    dna_matrix,
)


def test_blosum62_structure():
    arr = np.asarray(BLOSUM62.matrix).reshape(24, 24)
    assert np.array_equal(arr, arr.T)  # symmetric
    # canonical spot values
    idx = {c: i for i, c in enumerate(BLOSUM62.alphabet)}
    assert arr[idx["W"], idx["W"]] == 11
    assert arr[idx["A"], idx["A"]] == 4
    assert arr[idx["C"], idx["C"]] == 9
    assert arr[idx["E"], idx["Z"]] == 4
    assert arr[idx["*"], idx["*"]] == 1
    assert arr[idx["A"], idx["*"]] == -4


def test_protein_alignment_blosum62():
    """Protein global alignment through the matrix engine vs the oracle."""
    rng = np.random.default_rng(81)
    aa = "ARNDCQEGHILKMFPSTWYV"
    params = ScoringParams(g=1.0, h=10.0)
    aligner = BatchAligner(params=params, matrix=BLOSUM62,
                           parity_swap=False)
    for _ in range(3):
        a = "".join(rng.choice(list(aa), 25))
        b = "".join(rng.choice(list(aa), 32))
        scores, tables = aligner.score_batch([(a, b)])
        T1, T2, T3 = oracle_tables(a, b, params, matrix=BLOSUM62)
        t, s = end_table_choice(T1[-1, -1], T2[-1, -1], T3[-1, -1], -1,
                                params.h)
        assert scores[0] == s and tables[0] == t


def test_identical_proteins_score_is_selfsum():
    seq = "MKTAYIAKQR"
    aligner = BatchAligner(matrix=BLOSUM62, parity_swap=False)
    scores, _ = aligner.score_batch([(seq, seq)])
    arr = np.asarray(BLOSUM62.matrix).reshape(24, 24)
    idx = {c: i for i, c in enumerate(BLOSUM62.alphabet)}
    want = sum(arr[idx[c], idx[c]] for c in seq)
    assert scores[0] == want


def test_dna_matrix_helper():
    m = dna_matrix()
    assert m.alphabet == "ACGTN" and m.k == 5
    assert m.table()[0, 0] == 1.0 and m.table()[0, 1] == 0.0


def test_fused_matrix_align_matches_wavefront(monkeypatch):
    """BLOSUM62 full alignments walked on the device (the GPU path,
    forced here) == the same fill walked on the host."""
    from cse305_parallel_sequence_alignment.ops import select

    rng = np.random.default_rng(83)
    aa = "ARNDCQEGHILKMFPSTWYV"
    params = ScoringParams(g=1.0, h=10.0)
    pairs = []
    for _ in range(5):
        m = int(rng.integers(8, 40))
        n = int(rng.integers(8, 40))
        pairs.append(("".join(rng.choice(list(aa), m)),
                      "".join(rng.choice(list(aa), n))))
    aligner = BatchAligner(params=params, matrix=BLOSUM62,
                           parity_swap=False)
    want = aligner.align_batch(pairs)
    monkeypatch.setattr(select, "on_gpu", lambda: True)
    got = aligner.align_batch(pairs)
    for r_g, r_w, p in zip(got, want, pairs):
        assert r_g.score == r_w.score, p
        assert list(r_g.chain) == list(r_w.chain), p
        assert r_g.aligned_a == r_w.aligned_a, p
        assert r_g.aligned_b == r_w.aligned_b, p


def test_fused_matrix_mixed_types(monkeypatch):
    """Per-pair boundary types through the matrix path with the device
    walk (the partition layer's anchored-segment contract)."""
    from cse305_parallel_sequence_alignment.ops import select

    rng = np.random.default_rng(89)
    aa = "ARNDCQEGHILKMFPSTWYV"
    pairs = [("".join(rng.choice(list(aa), 20)),
              "".join(rng.choice(list(aa), 24))) for _ in range(4)]
    sts = [-1, -2, 1, 3]
    ens = [-1, -3, 2, -2]
    aligner = BatchAligner(matrix=BLOSUM62, parity_swap=False)
    want = aligner.align_batch(pairs, traceback_mode="full",
                               start_types=sts, end_types=ens)
    monkeypatch.setattr(select, "on_gpu", lambda: True)
    got = aligner.align_batch(pairs, traceback_mode="full",
                              start_types=sts, end_types=ens)
    for r_g, r_w in zip(got, want):
        assert r_g.score == r_w.score
        assert list(r_g.chain) == list(r_w.chain)
