"""Wavefront fill + batch aligner vs rowscan/oracle/golden."""

import numpy as np
import pytest
import jax.numpy as jnp

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.models.oracle import (
    oracle_align,
    oracle_tables,
)
from cse305_parallel_sequence_alignment.ops.wavefront import (
    PAD_A,
    PAD_B,
    wavefront_score_batch,
)


def rand_pairs(rng, count, max_len=60, min_len=1):
    out = []
    for _ in range(count):
        m = int(rng.integers(min_len, max_len + 1))
        n = int(rng.integers(min_len, max_len + 1))
        out.append(("".join(rng.choice(list("ACGT"), m)),
                    "".join(rng.choice(list("ACGT"), n))))
    return out


@pytest.mark.parametrize("start", [-1, -2, -3, 1, 2, 3])
def test_wavefront_finals_match_oracle(start):
    rng = np.random.default_rng(7)
    pairs = rand_pairs(rng, 6, max_len=40)
    bm = bn = 48
    B = len(pairs)
    a = np.full((B, bm), PAD_A, np.uint8)
    b = np.full((B, bn), PAD_B, np.uint8)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for k, (s1, s2) in enumerate(pairs):
        la[k], lb[k] = len(s1), len(s2)
        a[k, : la[k]] = np.frombuffer(s1.encode(), np.uint8)
        b[k, : lb[k]] = np.frombuffer(s2.encode(), np.uint8)
    finals = np.asarray(wavefront_score_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
        start_type=start))
    for k, (s1, s2) in enumerate(pairs):
        T1, T2, T3 = oracle_tables(s1, s2, start_type=start)
        want = np.array([T1[-1, -1], T2[-1, -1], T3[-1, -1]], np.float32)
        np.testing.assert_array_equal(finals[k], want, err_msg=str(pairs[k]))


def test_batch_align_matches_oracle():
    rng = np.random.default_rng(8)
    pairs = rand_pairs(rng, 12, max_len=50)
    aligner = BatchAligner(bucket_quantum=32)
    results = aligner.align_batch(pairs)
    for (a, b), got in zip(pairs, results):
        want = oracle_align(a, b)
        assert got.chain == want.chain, (a, b)
        assert got.score == want.score
        assert got.aligned_a == want.aligned_a
        assert got.aligned_b == want.aligned_b


def test_batch_align_golden(golden_pipeline):
    # One bucket quantum keeps compile count low; every golden pair must
    # come back byte-equal through the batched wavefront path. Lengths are
    # capped to bound CPU time; the long cases are covered by the rowscan
    # golden test.
    by_params = {}
    for rec in golden_pipeline:
        if max(len(rec["A"]), len(rec["B"])) > 350:
            continue
        by_params.setdefault((rec["g"], rec["h"]), []).append(rec)
    for (g, h), recs in by_params.items():
        aligner = BatchAligner(params=ScoringParams(g=g, h=h),
                               bucket_quantum=512)
        results = aligner.align_batch([(r["A"], r["B"]) for r in recs])
        for rec, res in zip(recs, results):
            assert res.aligned_a == rec["out_a"], rec
            assert res.aligned_b == rec["out_b"], rec


def test_batch_score_matches_align():
    rng = np.random.default_rng(9)
    pairs = rand_pairs(rng, 8, max_len=40)
    aligner = BatchAligner(bucket_quantum=64)
    scores, tables = aligner.score_batch(pairs)
    results = aligner.align_batch(pairs)
    for k in range(len(pairs)):
        assert scores[k] == results[k].score
        assert tables[k] == results[k].end_table
