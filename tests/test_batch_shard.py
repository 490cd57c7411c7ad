"""Data-sharded batch aligner (parallel/batch_shard.py) on the 8-device
virtual mesh."""

import numpy as np

from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.models.oracle import oracle_align
from cse305_parallel_sequence_alignment.parallel.batch_shard import (
    ShardedBatchAligner,
)


def rand_pairs(rng, count, lo=10, hi=50):
    return [("".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi)))),
             "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi)))))
            for _ in range(count)]


def test_sharded_scores_match_unsharded():
    rng = np.random.default_rng(91)
    pairs = rand_pairs(rng, 19)  # non-multiple of 8: exercises batch pad
    s1, t1 = BatchAligner(backend="wavefront").score_batch(pairs)
    s2, t2 = ShardedBatchAligner().score_batch(pairs)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(t1, t2)


def test_sharded_align_matches_oracle():
    rng = np.random.default_rng(92)
    pairs = rand_pairs(rng, 10)
    res = ShardedBatchAligner().align_batch(pairs)
    for (a, b), r in zip(pairs, res):
        want = oracle_align(a, b)
        assert r.chain == want.chain
        assert r.aligned_a == want.aligned_a
        assert r.score == want.score


def test_sharded_local_scores_match_unsharded():
    from cse305_parallel_sequence_alignment.models.local import (
        LocalBatchAligner,
    )
    from cse305_parallel_sequence_alignment.parallel.batch_shard import (
        ShardedLocalBatchAligner,
    )
    rng = np.random.default_rng(94)
    pairs = rand_pairs(rng, 13)
    s1, e1, f1 = LocalBatchAligner().score_batch(pairs)
    s2, e2, f2 = ShardedLocalBatchAligner().score_batch(pairs)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(e1, e2)
    np.testing.assert_array_equal(f1, f2)


def test_sharded_fewer_devices():
    rng = np.random.default_rng(93)
    pairs = rand_pairs(rng, 6)
    s1, _ = ShardedBatchAligner(num_devices=2).score_batch(pairs)
    s2, _ = BatchAligner(backend="wavefront").score_batch(pairs)
    np.testing.assert_array_equal(s1, s2)
