"""Long-sequence column-sharded wavefront (parallel/longseq.py).

Runs on the virtual 8-device CPU mesh from conftest; the same shard_map
program runs over NVLink on a multi-GPU host. Validated cell-exact
against the single-device row-scan fill.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.ops.rowscan import rowscan_score
from cse305_parallel_sequence_alignment.parallel.longseq import (
    longseq_score,
)
from cse305_parallel_sequence_alignment.parallel.mesh import (
    make_seq_mesh,
)


def rand_pair(rng, m, n):
    a = rng.integers(65, 69, size=(m,)).astype(np.uint8)
    b = rng.integers(65, 69, size=(n,)).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("shape", [(30, 40, 8), (96, 128, 16), (57, 100, 9),
                                   (128, 96, 32), (7, 200, 4)])
def test_longseq_matches_rowscan(shape):
    m, n, rc = shape
    rng = np.random.default_rng(m * 1000 + n)
    a, b = rand_pair(rng, m, n)
    got = longseq_score(a, b, ScoringParams(), row_chunk=rc)
    want = np.asarray(rowscan_score(jnp.asarray(a), jnp.asarray(b)))
    assert np.allclose(got, want), (got, want)


@pytest.mark.parametrize("params", [ScoringParams(g=2, h=1),
                                    ScoringParams(g=1, h=0),
                                    ScoringParams(g=3, h=5, match=2,
                                                  mismatch=-1)])
def test_longseq_other_params(params):
    rng = np.random.default_rng(77)
    a, b = rand_pair(rng, 64, 80)
    got = longseq_score(a, b, params, row_chunk=16)
    g, h, match, mismatch = params.astuple()
    want = np.asarray(rowscan_score(
        jnp.asarray(a), jnp.asarray(b), g=g, h=h, match=match,
        mismatch=mismatch))
    assert np.allclose(got, want), (got, want)


@pytest.mark.parametrize("start_type", [-1, -2, -3, 1, 2, 3])
def test_longseq_boundary_types(start_type):
    rng = np.random.default_rng(88)
    a, b = rand_pair(rng, 40, 56)
    got = longseq_score(a, b, ScoringParams(), start_type=start_type,
                        row_chunk=8)
    want = np.asarray(rowscan_score(jnp.asarray(a), jnp.asarray(b),
                                    start_type=start_type))
    assert np.allclose(got, want), (start_type, got, want)


def test_longseq_fewer_devices():
    rng = np.random.default_rng(99)
    a, b = rand_pair(rng, 48, 60)
    mesh = make_seq_mesh(4)
    got = longseq_score(a, b, ScoringParams(), mesh=mesh, row_chunk=12)
    want = np.asarray(rowscan_score(jnp.asarray(a), jnp.asarray(b)))
    assert np.allclose(got, want)


@pytest.mark.parametrize("shape", [(30, 40), (0, 20), (17, 100), (64, 64)])
def test_longseq_lastrow_matches_rowscan(shape):
    from cse305_parallel_sequence_alignment.ops.rowscan import (
        rowscan_lastrow,
    )
    from cse305_parallel_sequence_alignment.parallel.longseq import (
        longseq_lastrow,
    )
    m, n = shape
    rng = np.random.default_rng(m + 31 * n)
    a, b = rand_pair(rng, m, n)
    got = longseq_lastrow(a, b, ScoringParams(), row_chunk=8)
    want = np.asarray(rowscan_lastrow(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (3, n + 1)
    assert np.allclose(got, want)


@pytest.mark.parametrize("start_type", [-1, -2, -3, 1, 2, 3])
def test_longseq_lastrow_boundary_types(start_type):
    """The partition layer's sharded capture primitive under every
    anchored start type (its crossing searches use them all)."""
    from cse305_parallel_sequence_alignment.ops.rowscan import (
        rowscan_lastrow,
    )
    from cse305_parallel_sequence_alignment.parallel.longseq import (
        longseq_lastrow,
    )
    rng = np.random.default_rng(89)
    a, b = rand_pair(rng, 36, 52)
    got = longseq_lastrow(a, b, ScoringParams(), start_type=start_type,
                          mesh=make_seq_mesh(4), row_chunk=8)
    want = np.asarray(rowscan_lastrow(jnp.asarray(a), jnp.asarray(b),
                                      start_type=start_type))
    np.testing.assert_array_equal(got, want)


def test_longseq_batch_2d_mesh():
    """Batched ragged pairs over a (data=2, seq=4) mesh, per-pair exact."""
    from cse305_parallel_sequence_alignment.parallel.longseq import (
        longseq_score_batch,
    )
    from cse305_parallel_sequence_alignment.parallel.mesh import (
        make_2d_mesh,
    )
    rng = np.random.default_rng(66)
    mesh = make_2d_mesh(data=2, seq=4)
    pairs = []
    for _ in range(6):
        m, n = int(rng.integers(15, 60)), int(rng.integers(15, 80))
        pairs.append((rng.integers(65, 69, size=(m,)).astype(np.uint8),
                      rng.integers(65, 69, size=(n,)).astype(np.uint8)))
    got = longseq_score_batch(pairs, ScoringParams(), mesh=mesh,
                              row_chunk=8)
    for k, (a, b) in enumerate(pairs):
        want = np.asarray(rowscan_score(jnp.asarray(a), jnp.asarray(b)))
        assert np.allclose(got[k], want), k


def test_partition_with_sharded_fill():
    """PartitionedAligner using the column-sharded crossing search must
    reach the oracle-optimal score (the multi-chip long-pair path)."""
    from cse305_parallel_sequence_alignment.models.oracle import (
        oracle_align,
    )
    from cse305_parallel_sequence_alignment.parallel.partition import (
        PartitionedAligner,
    )
    rng = np.random.default_rng(55)
    a = "".join(rng.choice(list("ACGT"), 70))
    b = "".join(rng.choice(list("ACGT"), 90))
    got = PartitionedAligner(p=4, fill_backend="sharded").align(a, b)
    assert got.score == oracle_align(a, b).score
