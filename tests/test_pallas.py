"""The GPU fill kernel (ops/gpu_fill.py, Pallas through Triton, interpret
mode on the CPU) against the XLA wavefront, the XLA row scan and the
oracle; the device walk and the chunk pipeline that consume its words."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cse305_parallel_sequence_alignment.core import ScoringParams
from cse305_parallel_sequence_alignment.models.oracle import (
    oracle_align,
    oracle_tables,
)
from cse305_parallel_sequence_alignment.ops.gpu_fill import gpu_fill
from cse305_parallel_sequence_alignment.ops.rowscan import rowscan_score
from cse305_parallel_sequence_alignment.ops.traceback import (
    traceback_from_dirs,
)
from cse305_parallel_sequence_alignment.ops.wavefront import (
    PAD_A,
    PAD_B,
    wavefront_dirs_batch,
    wavefront_score_batch,
)


def make_batch(rng, count, bm, bn, min_len=1):
    a = np.full((count, bm), PAD_A, np.uint8)
    b = np.full((count, bn), PAD_B, np.uint8)
    la = np.zeros(count, np.int32)
    lb = np.zeros(count, np.int32)
    pairs = []
    for k in range(count):
        m = int(rng.integers(min_len, bm + 1))
        n = int(rng.integers(min_len, bn + 1))
        s1 = "".join(rng.choice(list("ACGT"), m))
        s2 = "".join(rng.choice(list("ACGT"), n))
        pairs.append((s1, s2))
        la[k], lb[k] = m, n
        a[k, :m] = np.frombuffer(s1.encode(), np.uint8)
        b[k, :n] = np.frombuffer(s2.encode(), np.uint8)
    return a, b, la, lb, pairs


def kernel(a, b, la, lb, start=-1, want_dirs=False, g=1.0, h=2.0,
           match=1.0, mismatch=0.0, S=1, C=8, strip=4):
    """gpu_fill in interpret mode at a small tiling (8-lane blocks)."""
    st = jnp.full((a.shape[0],), start, jnp.int32)
    finals, dirs = gpu_fill(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
        st, g=g, h=h, match=match, mismatch=mismatch,
        want_dirs=want_dirs, block=8, strip=strip, S=S, C=C,
        interpret=True)
    return np.asarray(finals), (None if dirs is None else np.asarray(dirs))


def wavefront(a, b, la, lb, start=-1, **kw):
    return np.asarray(wavefront_score_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
        start_type=start, **kw))


@pytest.mark.parametrize("start", [-1, -2, 2])
def test_pallas_score_matches_wavefront(start):
    rng = np.random.default_rng(11)
    a, b, la, lb, _ = make_batch(rng, 10, 14, 18)
    got, _ = kernel(a, b, la, lb, start=start)
    np.testing.assert_array_equal(got, wavefront(a, b, la, lb, start))


@pytest.mark.parametrize("start", [-1, -2, 3])
def test_pallas_rowscan_matches_wavefront(start):
    """The XLA row scan (the long-pair fill) agrees with the wavefront."""
    rng = np.random.default_rng(13)
    a, b, la, lb, _ = make_batch(rng, 9, 17, 21)
    want = wavefront(a, b, la, lb, start)
    for k in range(len(la)):
        got = np.asarray(rowscan_score(
            jnp.asarray(a[k, : la[k]]), jnp.asarray(b[k, : lb[k]]),
            start_type=start))
        np.testing.assert_array_equal(got, want[k])


def test_pallas_rowscan_uniform_la_branch():
    """Every pair fills the bucket (the bucketed production case): final
    cells sit on the last row and column of the last tile."""
    rng = np.random.default_rng(17)
    bm, bn = 16, 24
    a, b, la, lb, _ = make_batch(rng, 9, bm, bn)
    la[:], lb[:] = bm, bn
    a[:] = rng.integers(65, 69, a.shape)
    b[:] = rng.integers(65, 69, b.shape)
    got, _ = kernel(a, b, la, lb, S=2, C=8)
    np.testing.assert_array_equal(got, wavefront(a, b, la, lb))


@pytest.mark.parametrize("start", [-1, -2, 3])
def test_pallas_rowdirs_matches_skew_dirs(start):
    """Dirs words: finals and every valid cell's direction codes (bits
    0-5) equal the XLA wavefront's skew-layout bytes."""
    rng = np.random.default_rng(19)
    a, b, la, lb, _ = make_batch(rng, 7, 13, 17)
    fin_k, dirs_k = kernel(a, b, la, lb, start=start, want_dirs=True,
                           S=2, C=8)
    fin_s, dirs_s = wavefront_dirs_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
        start_type=start)
    dirs_s = np.asarray(dirs_s)
    np.testing.assert_array_equal(fin_k, np.asarray(fin_s))
    for k in range(len(la)):
        m, n = int(la[k]), int(lb[k])
        for i in range(1, m + 1):
            got = dirs_k[i, 1: n + 1, k] & 0x3F
            want = np.array([dirs_s[k, i + j, j] for j in range(1, n + 1)])
            np.testing.assert_array_equal(got, want, err_msg=f"row {i}")


def test_pallas_rowdirs_traceback_rect():
    """The kernel's direction codes walk host-side (rect layout) to the
    oracle's chains."""
    rng = np.random.default_rng(21)
    a, b, la, lb, pairs = make_batch(rng, 6, 12, 15)
    finals, dirs = kernel(a, b, la, lb, want_dirs=True)
    for k, (s1, s2) in enumerate(pairs):
        m, n = int(la[k]), int(lb[k])
        chain, table, score = traceback_from_dirs(
            (dirs[: m + 1, : n + 1, k] & 0x3F).astype(np.uint8), finals[k],
            m, n, h=2.0, end_type=-1, layout="rect")
        want = oracle_align(s1, s2, parity_swap=False)
        assert chain == want.chain, (s1, s2)
        assert score == want.score


def test_pallas_dirs_traceback_matches_oracle():
    rng = np.random.default_rng(12)
    a, b, la, lb, pairs = make_batch(rng, 6, 12, 15)
    finals, dirs = wavefront_dirs_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb))
    finals, dirs = np.asarray(finals), np.asarray(dirs)
    for k, (s1, s2) in enumerate(pairs):
        chain, table, score = traceback_from_dirs(
            dirs[k], finals[k], int(la[k]), int(lb[k]), h=2.0,
            end_type=-1, layout="skew")
        want = oracle_align(s1, s2, parity_swap=False)
        assert chain == want.chain, (s1, s2)


def test_device_walk_matches_host_walker():
    """backend="kernel" fills and walks on the device (interpret mode on
    the CPU); chains must equal the wavefront + host-walker path
    exactly, both modes."""
    from cse305_parallel_sequence_alignment.models.batch import (
        BatchAligner,
    )

    rng = np.random.default_rng(23)
    pairs = []
    for _ in range(9):
        la = int(rng.integers(1, 90))
        lb = int(rng.integers(1, 110))
        pairs.append(("".join(rng.choice(list("ACGT"), la)),
                      "".join(rng.choice(list("ACGT"), lb))))
    dev = BatchAligner(backend="kernel")
    host = BatchAligner(backend="wavefront")
    for mode in ("parity", "full"):
        got = dev.align_batch(pairs, traceback_mode=mode)
        want = host.align_batch(pairs, traceback_mode=mode)
        for g_, w_ in zip(got, want):
            assert g_.chain == w_.chain
            assert g_.score == w_.score
            assert g_.aligned_a == w_.aligned_a


def test_device_walk_offsets():
    """Global-coordinate offsets flow through the device walk."""
    from cse305_parallel_sequence_alignment.models.batch import (
        BatchAligner,
    )

    rng = np.random.default_rng(29)
    pairs = [("".join(rng.choice(list("ACGT"), 40)),
              "".join(rng.choice(list("ACGT"), 50))) for _ in range(3)]
    offs = [(100, 200), (0, 7), (55, 0)]
    dev = BatchAligner(backend="kernel")
    host = BatchAligner(backend="wavefront")
    got = dev.align_batch(pairs, offsets=offs, traceback_mode="full")
    want = host.align_batch(pairs, offsets=offs, traceback_mode="full")
    for g_, w_ in zip(got, want):
        assert g_.chain == w_.chain


def test_align_batch_chunk_pipeline():
    """dirs_budget small enough to force several kernel chunks in one
    bucket: the 2-deep dispatch/collect pipeline must emit every pair's
    result identically to the unchunked run."""
    from cse305_parallel_sequence_alignment.models.batch import (
        BatchAligner,
    )

    rng = np.random.default_rng(31)
    pairs = [("".join(rng.choice(list("ACGT"), 48)),
              "".join(rng.choice(list("ACGT"), 48))) for _ in range(7)]
    # per pair 2 * 129 * 129 bytes of dirs words -> 3 pairs per chunk
    dev = BatchAligner(backend="kernel", dirs_budget=3 * 2 * 129 * 129)
    one = BatchAligner(backend="kernel")
    got = dev.align_batch(pairs)
    want = one.align_batch(pairs)
    assert [len({c[0] for c in r.chain}) for r in got]  # touch chains
    for g_, w_ in zip(got, want):
        assert g_.chain == w_.chain
        assert g_.score == w_.score
        assert g_.aligned_a == w_.aligned_a and g_.aligned_b == w_.aligned_b


def _rle_vs_plain(a, b, la, lb, **fill_kw):
    """Expanded run-length walk over the kernel's words vs the per-step
    walk over the wavefront's skew bytes, up to each pair's edge."""
    from cse305_parallel_sequence_alignment.models.batch import (
        _end_choice_vec,
    )
    from cse305_parallel_sequence_alignment.ops.device_walk import (
        _device_walk,
        _walk_core_rle,
        expand_rle_ops,
    )

    fin, d16 = kernel(a, b, la, lb, want_dirs=True, **fill_kw)
    _, d8 = wavefront_dirs_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb))
    tables, _ = _end_choice_vec(fin, -1, 2.0)
    max_steps = int(la.max() + lb.max()) + 1
    plain = np.asarray(_device_walk(
        d8, jnp.asarray(la), jnp.asarray(lb), jnp.asarray(tables),
        max_steps=max_steps))
    ent, used = jax.jit(
        lambda d, i, j, t: _walk_core_rle(d, i, j, t,
                                          max_steps=max_steps))(
        jnp.asarray(d16), jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(tables))
    dense = expand_rle_ops(np.asarray(ent).T, max_steps)
    for r in range(len(la)):
        stop = np.argmax(plain[r] == 0) if (plain[r] == 0).any() \
            else max_steps
        assert np.array_equal(dense[r, :stop], plain[r, :stop]), r
    assert int(used) >= 1
    return d16


def test_rowdirs_with_runs_rle_walk_equivalence():
    """The run-length walk's expanded op stream is identical to the
    per-step walk until each pair's edge."""
    rng = np.random.default_rng(41)
    a, b, la, lb, _ = make_batch(rng, 5, 70, 90)
    _rle_vs_plain(a, b, la, lb, S=2, C=16)


def test_rle_walk_run_cap():
    """Diagonal runs longer than the 8-bit run field (identical 300 bp
    sequences) cap at 255 and continue in the next walk round."""
    rng = np.random.default_rng(43)
    s = rng.integers(65, 69, 300).astype(np.uint8)
    a = np.stack([s, s])
    b = np.stack([s, s])
    b[1, 150] = 70  # a mismatch splits the second pair's run
    la = np.full(2, 300, np.int32)
    lb = np.full(2, 300, np.int32)
    d16 = _rle_vs_plain(a, b, la, lb, S=8, C=64, strip=8)
    assert int(d16[300, 300, 0]) >> 8 == 255


@pytest.mark.parametrize("start", [-1, -2, -3, 1, 2, 3])
def test_pallas_rowscan2_matches_rowscan(start):
    """Every start type: the kernel (several tiles per diagonal) equals
    the XLA row scan pair by pair."""
    rng = np.random.default_rng(23)
    a, b, la, lb, _ = make_batch(rng, 9, 19, 23)
    got, _ = kernel(a, b, la, lb, start=start, S=2, C=8)
    for k in range(len(la)):
        want = np.asarray(rowscan_score(
            jnp.asarray(a[k, : la[k]]), jnp.asarray(b[k, : lb[k]]),
            start_type=start))
        np.testing.assert_array_equal(got[k], want)


@pytest.mark.parametrize("g,h", [(1, 2), (2, 1), (1, 0), (3, 5)])
def test_pallas_rowscan2_params(g, h):
    rng = np.random.default_rng(29)
    a, b, la, lb, _ = make_batch(rng, 8, 15, 18)
    got, _ = kernel(a, b, la, lb, g=g, h=h)
    np.testing.assert_array_equal(got, wavefront(a, b, la, lb, g=g, h=h))


def test_pallas_rowscan2_uniform_la_branch():
    """Tilings do not change results: one tile per pair, several tiles
    per diagonal, and narrow strips agree with the oracle's tables."""
    rng = np.random.default_rng(31)
    bm, bn = 18, 22
    a, b, la, lb, pairs = make_batch(rng, 9, bm, bn)
    la[:] = bm
    for k in range(len(la)):
        a[k, :] = rng.integers(65, 69, bm)
        pairs[k] = (a[k].tobytes().decode(), pairs[k][1])
    runs = [kernel(a, b, la, lb, S=S, C=C, strip=R)[0]
            for (S, C, R) in ((5, 24, 4), (1, 8, 4), (2, 4, 2))]
    for got in runs[1:]:
        np.testing.assert_array_equal(got, runs[0])
    for k, (s1, s2) in enumerate(pairs):
        T1, T2, T3 = oracle_tables(s1, s2, ScoringParams())
        np.testing.assert_array_equal(
            runs[0][k], [T1[-1, -1], T2[-1, -1], T3[-1, -1]])
