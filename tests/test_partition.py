"""Balanced partition: crossing points, segment solves, exact stitching."""

import numpy as np
import pytest

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.models.oracle import oracle_align
from cse305_parallel_sequence_alignment.parallel.partition import (
    PartitionedAligner,
    balanced_partition,
    score_chain,
)
from cse305_parallel_sequence_alignment.core import encode_seq
from cse305_parallel_sequence_alignment.models.batch import BatchAligner


def rand_pair(rng, m, n):
    return ("".join(rng.choice(list("ACGT"), m)),
            "".join(rng.choice(list("ACGT"), n)))


def test_partition_points_monotone():
    rng = np.random.default_rng(31)
    a, b = rand_pair(rng, 60, 80)
    pts = balanced_partition(a, b, 4)
    assert pts[0][:2] == (0, 0)
    assert pts[-1][:2] == (60, 80)
    for k in range(len(pts) - 1):
        assert pts[k][0] <= pts[k + 1][0]
        assert pts[k][1] <= pts[k + 1][1]


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_partitioned_align_optimal(p):
    """Stitched alignment must reach the true optimal score (validated by
    independent re-scoring of the emitted chain)."""
    rng = np.random.default_rng(32)
    params = ScoringParams()
    for (m, n) in [(40, 40), (33, 57), (64, 48)]:
        a, b = rand_pair(rng, m, n)
        want = oracle_align(a, b, params)
        aligner = PartitionedAligner(params=params, p=p)
        got = aligner.align(a, b)
        # chain must be a valid full-coverage alignment
        assert got.score == want.score, (a, b, p)
        a_cons = sum(1 for (_, _, t) in got.chain if t in (1, 3))
        b_cons = sum(1 for (_, _, t) in got.chain if t in (1, 2))
        assert (a_cons, b_cons) == (min(m, n), max(m, n))


def test_partitioned_align_other_params():
    rng = np.random.default_rng(33)
    for (g, h) in [(2, 1), (1, 0), (3, 5)]:
        params = ScoringParams(g=g, h=h)
        a, b = rand_pair(rng, 50, 45)
        want = oracle_align(a, b, params)
        got = PartitionedAligner(params=params, p=4).align(a, b)
        assert got.score == want.score, (g, h)


def test_partitioned_align_medium_grid():
    """Integration: 300x400 grid, p=8 — the long-pair path end to end
    (crossing search, anchored segment batch, stitch) vs the oracle."""
    rng = np.random.default_rng(34)
    a, b = rand_pair(rng, 300, 400)
    want = oracle_align(a, b)
    got = PartitionedAligner(p=8).align(a, b)
    assert got.score == want.score
    a_cons = sum(1 for (_, _, t) in got.chain if t in (1, 3))
    b_cons = sum(1 for (_, _, t) in got.chain if t in (1, 2))
    assert (a_cons, b_cons) == (300, 400)


def test_partition_agrees_with_batch_on_dataset_slices():
    """Gene-family slices at 2 kb (the seeded stand-in for the reference
    dataset): the partitioned engine's stitched score must equal the
    direct batched engine's score."""
    from cse305_parallel_sequence_alignment.models.batch import (
        BatchAligner,
    )
    from cse305_parallel_sequence_alignment.utils.synth import gene_family
    _, seqs = gene_family(count=10, min_len=2000, max_len=4000, seed=3)
    pairs = [(seqs[2][:2000], seqs[9][:2000])]
    scores, _ = BatchAligner().score_batch(pairs)
    got = PartitionedAligner(p=8).align(*pairs[0])
    assert got.score == scores[0]


def test_auto_segment_count_memory_bounded():
    """p=0 picks the smallest power-of-two segment count whose segment
    traceback matrix fits the budget, and the result stays optimal."""
    rng = np.random.default_rng(35)
    a, b = rand_pair(rng, 120, 150)
    # budget that forces several segments: full skew dirs would be
    # (120+150+1)*(151) ~ 41k bytes; set 8k -> p >= 4
    al = PartitionedAligner(p=0, mem_budget=8000)
    assert al._pick_p(120, 150) >= 4
    got = al.align(a, b)
    want = oracle_align(a, b)
    assert got.score == want.score


def test_score_chain_evaluator():
    a, b = encode_seq("AGGA"), encode_seq("AGTGC")
    chain = [(1, 1, 1), (2, 2, 1), (0, 3, 2), (3, 4, 1), (4, 5, 1)]
    # 3 matches (A,G ... A/G? positions: (1,1) A=A +1, (2,2) G=G +1,
    # gap open+extend -3, (3,4) G=G +1, (4,5) A vs C mismatch 0 -> 0
    assert score_chain(a, b, chain) == 0.0


def test_partition_long_dataset_pair_ci():
    """A >=20 kb gene pair (seeded family) aligned end-to-end through
    the partition layer on CPU: full traceback + rendered rows, stitched
    score equal to the chain re-score and to the independent batch
    score fill."""
    from cse305_parallel_sequence_alignment.utils.synth import gene_family
    _, seqs = gene_family(count=4, min_len=2000, max_len=21000, seed=4)
    order = sorted(range(len(seqs)), key=lambda k: -len(seqs[k]))
    a, b = seqs[order[0]][:20480], seqs[order[1]][:1536]
    al = PartitionedAligner(p=4)
    got = al.align(a, b)
    ea, eb = encode_seq(a), encode_seq(b)
    if len(ea) > len(eb):
        ea, eb = eb, ea  # aligner's parity swap
    assert got.score == score_chain(ea, eb, got.chain)
    scores, _ = BatchAligner().score_batch([(a, b)])
    assert got.score == scores[0]
    assert len(got.aligned_a) == len(got.aligned_b) >= 20480
    # rendered rows replay to the original sequences
    assert got.aligned_a.replace("-", "") == bytes(ea).decode()
    assert got.aligned_b.replace("-", "") == bytes(eb).decode()


def test_partitioned_aligner_fused_mixed_type_batch():
    """backend="kernel" routes ALL segments (mixed start/end anchor
    types) through ONE kernel batch with per-pair dynamic types; result
    must equal the grouped wavefront path and the unpartitioned
    aligner."""
    rng = np.random.default_rng(57)
    a = "".join(rng.choice(list("ACGT"), 300))
    b = "".join(rng.choice(list("ACGT"), 340))
    fused = PartitionedAligner(p=5, backend="kernel").align(a, b)
    plain = PartitionedAligner(p=5, backend="wavefront").align(a, b)
    whole = oracle_align(a, b)
    assert fused.score == plain.score == whole.score
    assert fused.chain == plain.chain
    assert fused.aligned_a == plain.aligned_a
    assert fused.aligned_b == plain.aligned_b
