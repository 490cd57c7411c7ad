"""Gotoh fill for NVIDIA GPUs: a Pallas kernel through Triton.

Inter-sequence layout, as in the GPU aligners SaLoBa and AnySeq/GPU: the
pairs of a block sit on the lanes (one pair per thread), and each thread
runs the DP recurrence of its own pair. No lane ever reads another
lane, so the kernel needs neither cross-lane shifts nor a prefix max
(which Pallas-Triton cannot lower: its associative scan serves cumsum
only).

The DP matrix is cut into tiles of ``S * R`` rows by ``C`` columns.
Tiles on one anti-diagonal of the tile grid are independent, so one
kernel launch fills all of them for all pairs, and a ``fori_loop`` over
tile diagonals launches the kernel once per diagonal. A tile is swept
in strips of ``R`` rows: the ``R`` cells of one column of a strip stay
in registers, the loop runs over columns. Tiles hand their borders to
their neighbours through device memory:

- ``H[r]`` holds the row above tile row ``r`` (its strips also pass
  their bottom row down through ``H[r + 1]``);
- ``V[c]`` holds the column left of tile column ``c``, its top cell
  being the tile's top-left corner.

Each border cell carries T1, T2, T3 and an int32 ``aux`` word (argmax
of the three, plus the run state below). Many pairs need only one tile
per pair and one launch; few long pairs get smaller tiles so that the
tiles of one diagonal fill the card.

With ``want_dirs`` the kernel also writes, for every cell, the uint16
word the run-length walk (ops/device_walk.py ``_walk_core_rle``) reads:
bits 0-5 the three 2-bit direction codes (core.DIR_T*_SHIFT), bits 6-7
the code after the cell's diagonal run, bits 8-15 the run length
(capped at 255). The layout is pair-minor, ``dirs[i, j, pair]``, so the
lanes of a warp store 64 contiguous bytes.

Semantics (boundaries per pair start type, tie orders, -inf absorbing
float32 scores) are those of ops/wavefront.py; the tests assert equal
finals and identical walks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from cse305_parallel_sequence_alignment.core import (
    DIR_T2_SHIFT,
    DIR_T3_SHIFT,
    NEG_INF,
)
from cse305_parallel_sequence_alignment.ops.wavefront import PAD_A, PAD_B

RUN_CAP = 255
# programs one tile diagonal should launch: with one warp each, ~8 per
# SM of the H200's 132 (measured best of 256 / 1,024 at 2 kb and 256 bp)
TARGET_PROGRAMS = 1024
# bytes the tile borders may take (16 per border cell and pair)
BORDER_BUDGET = 4 << 30


def _argmax3(t1, t2, t3):
    """(max, first argmax) of three, tie order T1 >= T2 >= T3."""
    m12 = jnp.maximum(t1, t2)
    s12 = jnp.where(t1 >= t2, 0, 1)
    return jnp.maximum(m12, t3), jnp.where(m12 >= t3, s12, 2)


def _cell(diag, up, left, a, b, *, g, h, match, mismatch, want_dirs):
    """One DP cell from its three neighbours.

    Each neighbour is (t1, t2, t3, mx, aux) with mx = max3 and, in dirs
    mode, aux = argmax3 | ca << 2 | run << 4. Returns the cell in the
    same form and, in dirs mode, its packed uint16 word (as int32)."""
    f = jnp.where(a == b, jnp.float32(match), jnp.float32(mismatch))
    t1 = f + diag[3]
    # T3 from above: max(T1 - g - h, T2 - g - h, T3 - g)
    um12 = jnp.maximum(up[0], up[1])
    c12 = um12 - g - h
    c3 = up[2] - g
    t3 = jnp.maximum(c12, c3)
    # T2 from the left: max(T1 - g - h, T2 - g, T3 - g - h)
    lm13 = jnp.maximum(left[0], left[2])
    c13 = lm13 - g - h
    c2 = left[1] - g
    t2 = jnp.maximum(c13, c2)
    mx, am = _argmax3(t1, t2, t3)
    if not want_dirs:
        return (t1, t2, t3, mx, None), None
    d3 = jnp.where(c12 >= c3, jnp.where(up[0] >= up[1], 0, 1), 2)
    s13 = jnp.where(left[0] >= left[2], 0, 2)
    win13 = jnp.where(s13 == 0, c13 >= c2, c13 > c2)
    d2 = jnp.where(win13, s13, 1)
    daux = diag[4]
    d1 = daux & 3
    is_run = d1 == 0
    r_prev = daux >> 4
    r = jnp.where(is_run, jnp.minimum(r_prev + 1, RUN_CAP), 0)
    ca = jnp.where(is_run, jnp.where(r_prev >= RUN_CAP, 0,
                                     (daux >> 2) & 3), d1)
    cr = ca | (r << 2)
    word = d1 | (d2 << DIR_T2_SHIFT) | (d3 << DIR_T3_SHIFT) | (cr << 6)
    return (t1, t2, t3, mx, am | (cr << 2)), word


def _fill_kernel(d_ref, a_ref, b_ref, la_ref, lb_ref, *refs, R, S, C,
                 nTR, nTC, g, h, match, mismatch, want_dirs):
    outs = refs[len(refs) // 2:]  # the buffers come in aliased pairs
    if want_dirs:
        h_ref, hx_ref, v_ref, vx_ref, fin_ref, dirs_ref = outs
    else:
        h_ref, v_ref, fin_ref = outs
        hx_ref = vx_ref = dirs_ref = None
    cell = functools.partial(_cell, g=g, h=h, match=match,
                             mismatch=mismatch, want_dirs=want_dirs)
    d = d_ref[0]
    r = jnp.maximum(d - (nTC - 1), 0) + pl.program_id(1)
    c = d - r

    def load(ref, xref, slot, idx):
        t1, t2, t3 = ref[slot, 0, idx, :], ref[slot, 1, idx, :], \
            ref[slot, 2, idx, :]
        mx = jnp.maximum(jnp.maximum(t1, t2), t3)
        return (t1, t2, t3, mx, xref[slot, idx, :] if want_dirs else None)

    def store(ref, xref, slot, idx, v):
        for p in range(3):
            ref[slot, p, idx, :] = v[p]
        if want_dirs:
            xref[slot, idx, :] = v[4]

    @pl.when((r < nTR) & (c >= 0))
    def _():
        c0 = c * C
        la = la_ref[:]
        lb = lb_ref[:]

        def strip(s_loc, _):
            i0 = (r * S + s_loc) * R
            top_slot = jnp.where(s_loc == 0, r, r + 1)
            a_rows = [a_ref[i0 + k, :] for k in range(R)]
            rows0 = tuple(load(v_ref, vx_ref, c, i0 + 1 + k)
                          for k in range(R))
            corner = load(v_ref, vx_ref, c, i0)
            kk = la - (i0 + 1)
            neg = jnp.full(la.shape, NEG_INF, jnp.float32)

            def column(jj, carry):
                tl, rows, fins = carry
                j = c0 + 1 + jj
                top = load(h_ref, hx_ref, top_slot, j)
                bj = b_ref[j - 1, :]
                kc = jnp.where(lb == j, kk, -1)
                diag, up = tl, top
                new_rows = []
                for k in range(R):
                    left = rows[k]
                    cur, word = cell(diag, up, left, a_rows[k], bj)
                    if want_dirs:
                        dirs_ref[i0 + 1 + k, j, :] = word.astype(jnp.uint16)
                    hit = kc == k
                    fins = tuple(jnp.where(hit, cur[p], fins[p])
                                 for p in range(3))
                    new_rows.append(cur)
                    diag, up = left, cur
                store(h_ref, hx_ref, r + 1, j, up)
                return top, tuple(new_rows), fins

            _, rows, fins = jax.lax.fori_loop(
                0, C, column, (corner, rows0, (neg, neg, neg)))
            for k in range(R):
                store(v_ref, vx_ref, c + 1, i0 + 1 + k, rows[k])
            # other tiles of this launch hold the same pairs: store only
            # the lanes whose final cell lies in this strip
            mine = (kk >= 0) & (kk < R) & (lb > c0) & (lb <= c0 + C)
            for p in range(3):
                pltriton.store(fin_ref.at[p], fins[p], mask=mine)

        jax.lax.fori_loop(0, S, strip, None)


def _boundaries(st, m, n, g, h):
    """Row-0 and column-0 values for every pair: (row0 (3, n+1, B),
    col0 (3, m+1, B)), each with the start-type corner at index 0."""
    neg = jnp.float32(NEG_INF)
    st = st[None, :]
    jf = jnp.arange(n + 1, dtype=jnp.float32)[:, None] * jnp.float32(g)
    if_ = jnp.arange(m + 1, dtype=jnp.float32)[:, None] * jnp.float32(g)
    corner = [jnp.where((st == 1) | (st == -1), 0.0, neg),
              jnp.where(st == -2, 0.0, neg),
              jnp.where(st == -3, 0.0, neg)]
    t2 = jnp.where(st == -2, -jf,
                   jnp.where((st == 1) | (st == 3), neg, -h - jf))
    t3 = jnp.where(st == -3, -if_,
                   jnp.where((st == 1) | (st == 2), neg, -h - if_))
    j0 = (jnp.arange(n + 1) == 0)[:, None]
    i0 = (jnp.arange(m + 1) == 0)[:, None]
    row0 = jnp.stack([jnp.where(j0, corner[0], neg),
                      jnp.where(j0, corner[1], t2),
                      jnp.where(j0, corner[2], neg)]).astype(jnp.float32)
    col0 = jnp.stack([jnp.where(i0, corner[0], neg),
                      jnp.where(i0, corner[1], neg),
                      jnp.where(i0, corner[2], t3)]).astype(jnp.float32)
    return row0, col0


def _aux0(t):
    """aux word of a boundary cell: its argmax3, no run."""
    return _argmax3(t[0], t[1], t[2])[1].astype(jnp.int32)


def tile_shape(n_pairs, m, n, block=32, strip=16):
    """(S, C): strips per tile and tile width for a padded (m, n) bucket.

    Pairs fill ``n_pairs / block`` programs. When that fills the card a
    tile is the whole pair; otherwise tiles shrink (to no less than one
    strip square) until a tile diagonal holds ``TARGET_PROGRAMS``, but
    not so far that the tile borders outgrow ``BORDER_BUDGET``."""
    groups = -(-n_pairs // block)
    rows = -(-max(m, 1) // strip) * strip
    want = -(-TARGET_PROGRAMS // groups)
    side = max(strip, -(-max(rows, n) // want))
    side = 1 << (side - 1).bit_length()
    lanes = groups * block
    while side < max(rows, n) and \
            32 * (rows // side + 1) * (n + 1) * lanes > BORDER_BUDGET:
        side *= 2
    S = max(1, min(rows, side) // strip)
    C = max(strip, min(-(-max(n, 1) // strip) * strip, side))
    return S, C


@functools.partial(
    jax.jit,
    static_argnames=("g", "h", "match", "mismatch", "want_dirs", "block",
                     "strip", "S", "C", "interpret"))
def gpu_fill(a, b, la, lb, st, *, g, h, match, mismatch, want_dirs,
             block=32, strip=16, S=1, C=16, interpret=False):
    """Fill a padded bucket. a: (B, m), b: (B, n) uint8; la, lb, st: (B,)
    int32 lengths and per-pair start types.

    Returns (finals (B, 3) float32, dirs) with dirs the (m' + 1, n' + 1,
    B') uint16 pair-minor word matrix (m', n', B' padded to the tiling),
    or None without ``want_dirs``."""
    B, m = a.shape
    n = b.shape[1]
    R = strip
    TR = S * R
    nTR = max(1, -(-m // TR))
    nTC = max(1, -(-n // C))
    mp, np_, Bp = nTR * TR, nTC * C, -(-B // block) * block
    a_t = jnp.full((mp, Bp), int(PAD_A), jnp.int32).at[:m, :B].set(
        a.T.astype(jnp.int32))
    b_t = jnp.full((np_, Bp), int(PAD_B), jnp.int32).at[:n, :B].set(
        b.T.astype(jnp.int32))
    la_p = jnp.zeros((Bp,), jnp.int32).at[:B].set(la)
    lb_p = jnp.zeros((Bp,), jnp.int32).at[:B].set(lb)
    st_p = jnp.full((Bp,), -1, jnp.int32).at[:B].set(st)
    row0, col0 = _boundaries(st_p, mp, np_, g, h)
    hb = jnp.zeros((nTR + 1, 3, np_ + 1, Bp), jnp.float32).at[0].set(row0)
    vb = jnp.zeros((nTC + 1, 3, mp + 1, Bp), jnp.float32).at[0].set(col0)
    vb = vb.at[1:, :, 0].set(jnp.moveaxis(row0[:, C::C][:, :nTC], 1, 0))
    fin = jnp.full((3, Bp), NEG_INF, jnp.float32)
    bufs = [hb]
    if want_dirs:
        hx = jnp.zeros((nTR + 1, np_ + 1, Bp), jnp.int32).at[0].set(
            _aux0(row0))
        vx = jnp.zeros((nTC + 1, mp + 1, Bp), jnp.int32).at[0].set(
            _aux0(col0))
        vx = vx.at[1:, 0].set(_aux0(row0)[C::C][:nTC])
        bufs += [hx, vb, vx, fin,
                 jnp.zeros((mp + 1, np_ + 1, Bp), jnp.uint16)]
    else:
        bufs += [vb, fin]

    def pair_spec(shape):
        nd = len(shape)
        return pl.BlockSpec(shape[:-1] + (block,),
                            lambda gi, k, nd=nd: (0,) * (nd - 1) + (gi,))

    kernel = functools.partial(
        _fill_kernel, R=R, S=S, C=C, nTR=nTR, nTC=nTC, g=float(g),
        h=float(h), match=float(match), mismatch=float(mismatch),
        want_dirs=want_dirs)
    n_in = 5
    call = pl.pallas_call(
        kernel,
        grid=(Bp // block, min(nTR, nTC)),
        in_specs=[pl.BlockSpec((1,), lambda gi, k: (0,))]
        + [pair_spec(x.shape) for x in (a_t, b_t, la_p, lb_p)]
        + [pair_spec(x.shape) for x in bufs],
        out_specs=[pair_spec(x.shape) for x in bufs],
        out_shape=[jax.ShapeDtypeStruct(x.shape, x.dtype) for x in bufs],
        input_output_aliases={n_in + k: k for k in range(len(bufs))},
        # one warp per block of 32 pairs: a pair per thread
        compiler_params=pltriton.CompilerParams(num_warps=block // 32 or 1,
                                                num_stages=1),
        interpret=interpret,
        name="gotoh_fill_dirs" if want_dirs else "gotoh_fill_score",
    )

    def step(dg, bufs):
        return tuple(call(jnp.reshape(dg, (1,)).astype(jnp.int32),
                          a_t, b_t, la_p, lb_p, *bufs))

    bufs = jax.lax.fori_loop(0, nTR + nTC - 1, step, tuple(bufs))
    fin = bufs[-2] if want_dirs else bufs[-1]
    # empty sequences end on a border the kernel never visits
    fin = jnp.where((la_p == 0)[None], jnp.take_along_axis(
        row0, jnp.minimum(lb_p, np_)[None, None, :], axis=1)[:, 0], fin)
    fin = jnp.where((lb_p == 0)[None], jnp.take_along_axis(
        col0, jnp.minimum(la_p, mp)[None, None, :], axis=1)[:, 0], fin)
    finals = fin.T[:B]
    return finals, (bufs[-1] if want_dirs else None)
