"""Direct coverage for ops/prefix.py (C5a/C5b counterparts).

The reference's ParallelPrefix (sum, main_alignment.cpp:81-156) and
ParallelPrefixMax (subproblem_alignment.cpp:29-103) are block-scan +
pointer-jumping std::thread implementations; here both are
``lax.associative_scan`` and these tests pin them against numpy.
"""

import numpy as np

from cse305_parallel_sequence_alignment.ops.prefix import (
    prefix_max,
    prefix_sum,
)


def test_prefix_max_matches_numpy():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 97)).astype(np.float32)
    got = np.asarray(prefix_max(x))
    np.testing.assert_array_equal(got, np.maximum.accumulate(x, axis=-1))


def test_prefix_max_axis0_and_neg_inf():
    x = np.array([[-np.inf, 1.0], [0.5, -2.0], [np.inf, -3.0]],
                 np.float32)
    got = np.asarray(prefix_max(x, axis=0))
    np.testing.assert_array_equal(got, np.maximum.accumulate(x, axis=0))


def test_prefix_sum_matches_numpy():
    rng = np.random.default_rng(4)
    # the reference scans vector<long int>; int32 is the exact analog
    x = rng.integers(-50, 50, size=(3, 64)).astype(np.int32)
    got = np.asarray(prefix_sum(x))
    np.testing.assert_array_equal(got, np.cumsum(x, axis=-1))


def test_prefix_sum_reference_shape():
    # the reference's prefix feeds processor assignment over per-
    # subproblem omega estimates (main_alignment.cpp:169-200): a short
    # 1-D vector of work units
    omega = np.array([3, 1, 4, 1, 5, 9], np.int32)
    got = np.asarray(prefix_sum(omega))
    np.testing.assert_array_equal(got, [3, 4, 8, 9, 14, 23])
