"""GPU fill kernel: tiling, padding, scoring edge cases, the path
selector, and (``gpu`` marker) the kernel as compiled for the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cse305_parallel_sequence_alignment.models.batch import BatchAligner
from cse305_parallel_sequence_alignment.ops import select
from cse305_parallel_sequence_alignment.ops.gpu_fill import (
    gpu_fill,
    tile_shape,
)
from cse305_parallel_sequence_alignment.ops.wavefront import (
    PAD_A,
    PAD_B,
    wavefront_score_batch,
)
from cse305_parallel_sequence_alignment.utils.synth import (
    homologous_pairs,
)


def batch(rng, lens_a, lens_b, bm, bn):
    B = len(lens_a)
    a = np.full((B, bm), PAD_A, np.uint8)
    b = np.full((B, bn), PAD_B, np.uint8)
    for k, (m, n) in enumerate(zip(lens_a, lens_b)):
        a[k, :m] = rng.integers(65, 69, m)
        b[k, :n] = rng.integers(65, 69, n)
    return a, b, np.asarray(lens_a, np.int32), np.asarray(lens_b, np.int32)


def kernel_score(a, b, la, lb, interpret=True, **kw):
    params = dict(g=1.0, h=2.0, match=1.0, mismatch=0.0)
    params.update({k: kw.pop(k) for k in list(kw) if k in params})
    tiling = dict(block=8, strip=4, S=2, C=8)
    tiling.update(kw)
    st = jnp.full((a.shape[0],), -1, jnp.int32)
    fin, _ = gpu_fill(jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                      jnp.asarray(lb), st, want_dirs=False,
                      interpret=interpret, **params, **tiling)
    return np.asarray(fin)


def xla_score(a, b, la, lb, **params):
    return np.asarray(wavefront_score_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
        **params))


@pytest.mark.parametrize("n_pairs,m,n", [
    (256, 2048, 2048), (16384, 256, 256), (7, 128, 128),
    (40, 384, 128), (1, 1, 1)])
def test_tile_shape_covers_the_bucket(n_pairs, m, n):
    """Tiles are whole strips, powers of two past one strip, and the
    tile grid launches enough programs (or one tile per pair when the
    pairs alone fill the card)."""
    strip = 16
    S, C = tile_shape(n_pairs, m, n, strip=strip)
    assert S >= 1 and C >= strip and C % strip == 0
    rows = S * strip
    n_tiles = -(-m // rows) * -(-n // C)
    groups = -(-n_pairs // 32)
    if groups >= 1024:
        assert n_tiles == 1
    assert rows <= max(strip, -(-m // strip) * strip)


@pytest.mark.parametrize("backend,want", [
    ("auto", False), ("kernel", True), ("wavefront", False)])
def test_use_fill_kernel_on_cpu(backend, want):
    assert select.use_fill_kernel(backend) is want


def test_use_fill_kernel_rejects_unknown_backend():
    with pytest.raises(ValueError):
        select.use_fill_kernel("pallas")


def test_kernel_interpret_only_off_the_gpu():
    assert select.kernel_interpret() is True
    assert select.on_gpu() is False


def test_kernel_empty_sequences():
    """Pairs with an empty side end on a border no tile visits."""
    rng = np.random.default_rng(3)
    a, b, la, lb = batch(rng, [0, 5, 0, 9], [7, 0, 0, 16], 16, 16)
    np.testing.assert_array_equal(kernel_score(a, b, la, lb),
                                  xla_score(a, b, la, lb))


def test_kernel_pads_pairs_to_block():
    """11 pairs fill two 8-lane blocks; the padded lanes are dropped."""
    rng = np.random.default_rng(4)
    lens = rng.integers(1, 20, (2, 11))
    a, b, la, lb = batch(rng, lens[0], lens[1], 20, 20)
    got = kernel_score(a, b, la, lb)
    assert got.shape == (11, 3)
    np.testing.assert_array_equal(got, xla_score(a, b, la, lb))


@pytest.mark.parametrize("match,mismatch,g,h", [
    (2.0, -1.0, 1.0, 2.0), (1.5, -0.25, 0.5, 1.25), (1.0, -3.0, 2.0, 0.0)])
def test_kernel_scoring_params(match, mismatch, g, h):
    """Negative mismatches, fractional scores and a zero gap open agree
    bit for bit with the wavefront (same operation order)."""
    rng = np.random.default_rng(5)
    lens = rng.integers(1, 24, (2, 9))
    a, b, la, lb = batch(rng, lens[0], lens[1], 24, 24)
    params = dict(match=match, mismatch=mismatch, g=g, h=h)
    np.testing.assert_array_equal(kernel_score(a, b, la, lb, **params),
                                  xla_score(a, b, la, lb, **params))


def test_score_batch_kernel_vs_wavefront_buckets():
    """BatchAligner.score_batch through the kernel across several
    buckets and chunks equals the XLA path."""
    pairs = homologous_pairs(6, 60, seed=8) + \
        homologous_pairs(5, 150, seed=9)
    want = BatchAligner(backend="wavefront", bucket_quantum=64,
                        max_batch=4).score_batch(pairs)
    got = BatchAligner(backend="kernel", bucket_quantum=64,
                       max_batch=4).score_batch(pairs)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("count,length", [(64, 500), (2048, 100)])
def test_compiled_kernel_score_matches_wavefront(count, length):
    """The kernel as compiled for the card equals the XLA wavefront."""
    assert jax.default_backend() == "gpu"
    pairs = homologous_pairs(count, length, seed=10)
    want = BatchAligner(backend="wavefront").score_batch(pairs)
    got = BatchAligner(backend="kernel").score_batch(pairs)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
def test_compiled_kernel_align_matches_wavefront():
    """Compiled dirs kernel + device run-length walk == XLA fill +
    device walk: scores, chains and rendered rows."""
    assert jax.default_backend() == "gpu"
    pairs = homologous_pairs(48, 700, seed=11)
    got = BatchAligner(backend="kernel").align_batch(pairs)
    want = BatchAligner(backend="wavefront").align_batch(pairs)
    for x, y in zip(got, want):
        assert x.score == y.score
        assert list(x.chain) == list(y.chain)
        assert (x.aligned_a, x.aligned_b) == (y.aligned_a, y.aligned_b)
