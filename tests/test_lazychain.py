"""LazyChain behaves exactly like the eager list it replaces, and the
longseq pipeline accounting is self-consistent."""
import numpy as np

from cse305_parallel_sequence_alignment.core import LazyChain


def _mk():
    tt = np.array([1, 2, 1], np.int32)
    ii = np.array([1, 0, 2], np.int32)
    jj = np.array([1, 2, 3], np.int32)
    return LazyChain(tt, ii, jj), [(1, 1, 1), (0, 2, 2), (2, 3, 1)]


def test_lazychain_list_protocol():
    lc, want = _mk()
    assert len(lc) == 3
    assert bool(lc)
    assert lc == want
    assert want == lc
    assert list(lc) == want
    assert lc[1] == (0, 2, 2)
    assert lc[-1] == (2, 3, 1)
    assert lc + [(9, 9, 9)] == want + [(9, 9, 9)]
    assert [(0, 0, 0)] + lc == [(0, 0, 0)] + want
    assert [t for _, _, t in lc] == [1, 2, 1]
    lc2, _ = _mk()
    assert lc == lc2
    empty = LazyChain(np.zeros(0, np.int32), np.zeros(0, np.int32),
                      np.zeros(0, np.int32))
    assert not empty and len(empty) == 0 and empty == []


def test_lazychain_len_before_materialisation():
    lc, _ = _mk()
    assert len(lc) == 3  # length without building tuples
    assert lc._list is None
    _ = lc[0]
    assert lc._list is not None


def test_longseq_pipeline_stats():
    from cse305_parallel_sequence_alignment.parallel.longseq import (
        longseq_pipeline_stats,
    )
    st = longseq_pipeline_stats(8192, 8192, devices=8, row_chunk=256)
    assert st["chunks"] == 32
    assert st["pipeline_steps"] == 32 + 8 - 1
    assert st["cols_per_device"] == 1024
    assert st["bytes_per_ppermute_per_device"] == 256 * 12
    assert 0 < st["ramp_fraction"] < 1
    assert abs(st["efficiency_bound"] - 32 / 39) < 1e-3
    # degenerate mesh: no ramp, one chunk stream
    st1 = longseq_pipeline_stats(1000, 1000, devices=1, row_chunk=64)
    assert st1["ramp_fraction"] == 0.0
    assert st1["efficiency_bound"] == 1.0
