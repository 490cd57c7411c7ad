"""On-device batched traceback: walk the packed direction matrix on the
accelerator and ship only op codes to the host.

A batch's direction matrix is hundreds of MB; its walk is sequential
per pair but trivially batched: one XLA while loop gathers the current
cell of every pair at once and records the visited codes. The host
replays the moves (the code sequence fully determines the path) with
exactly the semantics of ops/traceback.py / the native walker
(reference subproblem_alignment.cpp:105-172, quirks B1-B3) — one device
walk serves the global, semi-global and overlap walks, whose
differences are pure host-side replay rules.

Two direction layouts exist:

- uint8 "skew", pair-major (B, m+n+1, n+1), byte of cell (i, j) at
  [b, i + j, j]: the XLA wavefront fills (ops/wavefront.py,
  ops/semiglobal.py, ops/overlap.py); walked one step per gather by
  ``_walk_core``;
- uint16 pair-minor (m'+1, n'+1, B'), word of cell (i, j) at [i, j, b]:
  the GPU fill kernel (ops/gpu_fill.py), whose words carry diagonal run
  lengths; walked one run per gather by ``_walk_core_rle``.
"""

from __future__ import annotations

import functools

import numpy as np

from cse305_parallel_sequence_alignment.core import (
    DIR_T1_SHIFT,
    DIR_T2_SHIFT,
    DIR_T3_SHIFT,
)


_WALK_UNROLL = 8


def _walk_core(dirs, i0, j0, t0, *, max_steps):
    """Traceable walk body over uint8 skew dirs: returns ops as
    (steps_pad, B) uint8 with steps_pad = max_steps rounded up to the
    unroll. Each entry is 1 + the visited cell's 2-bit code for the
    current table (0 = step not taken).

    While i>0 and j>0: read the current cell's code for the CURRENT
    table, move by the current table, continue with table code+1.
    A code of 3 (local-mode "start here") has no successor; the device
    keeps walking diagonally — the host replay stops there, so the
    trailing codes are dead.

    The loop is a while over _WALK_UNROLL-step blocks: the dependent
    per-step gathers are the cost, so the loop exits as soon as every
    pair reached an edge (typical DNA paths are ~(m+n)/2 steps, the
    bound is m+n) and the bookkeeping amortizes over the unroll.
    """
    import jax
    import jax.numpy as jnp

    B = i0.shape[0]
    bidx = jnp.arange(B, dtype=jnp.int32)
    shifts = jnp.array([0, DIR_T1_SHIFT, DIR_T2_SHIFT, DIR_T3_SHIFT],
                       jnp.int32)

    def one(i, j, t, done):
        byte = dirs[bidx, i + j, j].astype(jnp.int32)
        code = (byte >> shifts[t]) & 3
        active = ~done
        di = jnp.where((t == 1) | (t == 3), 1, 0)
        dj = jnp.where((t == 1) | (t == 2), 1, 0)
        i2 = jnp.where(active, i - di, i)
        j2 = jnp.where(active, j - dj, j)
        rec = jnp.where(active, code + 1, 0).astype(jnp.uint8)
        t2 = jnp.where(active, jnp.where(code >= 3, 1, code + 1), t)
        done2 = done | (i2 == 0) | (j2 == 0)
        return i2, j2, t2, done2, rec

    U = _WALK_UNROLL
    nblk = -(-max_steps // U)

    def cond(state):
        _, _, _, done, _, k = state
        return (k < nblk) & ~jnp.all(done)

    def body(state):
        i, j, t, done, ops, k = state
        recs = []
        for _ in range(U):
            i, j, t, done, rec = one(i, j, t, done)
            recs.append(rec)
        ops = jax.lax.dynamic_update_slice(
            ops, jnp.stack(recs, axis=0), (k * U, 0))
        return i, j, t, done, ops, k + 1

    i0 = i0.astype(jnp.int32)
    j0 = j0.astype(jnp.int32)
    t0 = t0.astype(jnp.int32)
    done0 = (i0 == 0) | (j0 == 0)
    ops0 = jnp.zeros((nblk * U, B), jnp.uint8)
    _, _, _, _, ops, _ = jax.lax.while_loop(
        cond, body, (i0, j0, t0, done0, ops0, jnp.int32(0)))
    return ops


def _walk_core_rle(dirs16, i0, j0, t0, *, max_steps):
    """Run-length walk over the pair-minor uint16 dirs of
    ops/gpu_fill.py: one dependent gather consumes a WHOLE diagonal run.

    Each word holds [codes d1|d2|d3 (6) | code-after ca (2) | runlen R
    (8)]. A round at (i, j, t): for t == 1 it takes R rec-1 steps plus
    one rec-(ca+1) step (R+1 diagonal moves); for t in (2, 3) one
    normal step. The round records ONE uint16 entry (op | k << 2) with
    op = rec of the round's last step (2 bits) and k = R (8 bits);
    expand_rle_ops reproduces the per-step op stream of _walk_core
    (tests assert equal chains). Positions may overshoot the DP edge
    (the run jump is not edge-clamped); the host replay cuts at the
    first edge touch exactly as it does for single steps, so trailing
    recs are dead by construction. Returns (entries (rounds_pad, B)
    uint16 device array, rounds_used scalar).
    """
    import jax
    import jax.numpy as jnp

    B = i0.shape[0]
    bidx = jnp.arange(B, dtype=jnp.int32)
    shifts = jnp.array([0, DIR_T1_SHIFT, DIR_T2_SHIFT, DIR_T3_SHIFT],
                       jnp.int32)
    nrows, ncols = dirs16.shape[0], dirs16.shape[1]

    def one(i, j, t, done):
        # overshot pairs are done; clamp their (frozen) coords anyway so
        # gathers never index out of range
        r = jnp.clip(i, 0, nrows - 1)
        c = jnp.clip(j, 0, ncols - 1)
        word = dirs16[r, c, bidx].astype(jnp.int32)
        c_now = (word >> shifts[t]) & 3
        is_run = t == 1
        k = jnp.where(is_run, (word >> 8) & 255, 0)
        op = jnp.where(is_run, (word >> 6) & 3, c_now)
        di = jnp.where(is_run, k + 1, jnp.where(t == 3, 1, 0))
        dj = jnp.where(is_run, k + 1, jnp.where(t == 2, 1, 0))
        active = ~done
        ent = jnp.where(active, (op + 1) | (k << 2), 0).astype(
            jnp.uint16)
        t2 = jnp.where(active, op + 1, t)
        i2 = jnp.where(active, i - di, i)
        j2 = jnp.where(active, j - dj, j)
        done2 = done | (i2 <= 0) | (j2 <= 0)
        return i2, j2, t2, done2, ent

    U = _WALK_UNROLL
    nblk = -(-max_steps // U)

    def cond(state):
        _, _, _, done, _, k = state
        return (k < nblk) & ~jnp.all(done)

    def body(state):
        i, j, t, done, ops, k = state
        ents = []
        for _ in range(U):
            i, j, t, done, ent = one(i, j, t, done)
            ents.append(ent)
        ops = jax.lax.dynamic_update_slice(
            ops, jnp.stack(ents, axis=0), (k * U, 0))
        return i, j, t, done, ops, k + 1

    i0 = i0.astype(jnp.int32)
    j0 = j0.astype(jnp.int32)
    t0 = t0.astype(jnp.int32)
    done0 = (i0 == 0) | (j0 == 0)
    ops0 = jnp.zeros((nblk * U, B), jnp.uint16)
    _, _, _, _, ops, kfin = jax.lax.while_loop(
        cond, body, (i0, j0, t0, done0, ops0, jnp.int32(0)))
    return ops, kfin * U


def expand_rle_ops(entries, max_steps):
    """Expand (B, Rn) RLE walk entries to the dense per-step op stream
    ((B, <=max_steps) uint8) _walk_core would have produced.

    entry = op | k << 2 -> k steps of op 1 (the diagonal run) followed
    by one step of op; op == 0 = round not taken."""
    entries = np.asarray(entries)
    B, Rn = entries.shape
    op = (entries & 3).astype(np.uint8)
    k = (entries >> 2).astype(np.int64)
    lens = np.where(op > 0, k + 1, 0)
    ends = np.cumsum(lens, axis=1)
    total = ends[:, -1] if Rn else np.zeros(B, np.int64)
    L = min(int(total.max(initial=0)), max_steps) if B else 0
    L = max(L, 1)
    dense = np.zeros((B, L), np.uint8)
    pos = np.arange(L, dtype=np.int64)[None, :]
    dense[pos < total[:, None]] = 1
    idx = ends - 1
    valid = (op > 0) & (idx < L)
    bflat = np.broadcast_to(np.arange(B)[:, None], idx.shape)[valid]
    dense[bflat, idx[valid]] = op[valid]
    return dense


@functools.partial(__import__("jax").jit, static_argnames=("max_steps",))
def _device_walk(dirs, i0, j0, t0, *, max_steps):
    """(B, max_steps) uint8 walk ops over skew dirs — see _walk_core."""
    ops = _walk_core(dirs, i0, j0, t0, max_steps=max_steps)
    return ops.T[:, :max_steps]


def _run_walk(dirs_dev, i0, j0, t0):
    """(ops (B, max_steps) uint8, i0, j0, t0) for device skew dirs; the
    run-length walk of the GPU kernel's words runs fused behind its
    fill (models/batch.py ``_fused_fill_walk``)."""
    import jax.numpy as jnp

    i0 = np.asarray(i0, np.int64)
    j0 = np.asarray(j0, np.int64)
    t0 = np.asarray(t0, np.int64)
    # the bucket's longest path, so one compiled walk serves the bucket
    max_steps = dirs_dev.shape[1]
    ops = np.asarray(_device_walk(
        dirs_dev, jnp.asarray(i0, jnp.int32), jnp.asarray(j0, jnp.int32),
        jnp.asarray(t0, jnp.int32), max_steps=max_steps))
    return ops, i0, j0, t0


def replay_ops(ops, la, lb, tables, mode="parity", offsets=None,
               chunk=None):
    """Vectorised host replay of device-walk op codes (global mode).

    The moves are fully determined by the table sequence (t_0 = the end
    table, t_k = ops[k-1]), so positions fall out of two cumulative sums
    instead of a per-step Python loop. Returns (tt, ii, jj, lens) with
    pair r's chain at [r, :lens[r]] in start->end order, quirk-B2 zeros
    and offsets applied — the layout native/walker.py's renderer takes.
    """
    B, L = ops.shape
    if offsets is not None and chunk is not None:
        offs = np.asarray([offsets[chunk[r]] for r in range(B)], np.int32)
        id_a, id_b = offs[:, 0:1], offs[:, 1:2]
    else:
        id_a = id_b = np.zeros((B, 1), np.int32)

    T = np.empty((B, L + 1), np.int32)
    T[:, 0] = tables
    T[:, 1:] = ops
    mv = T[:, :-1]
    di = (mv == 1) | (mv == 3)
    dj = (mv == 1) | (mv == 2)
    pos_i = np.empty((B, L + 1), np.int32)
    pos_j = np.empty((B, L + 1), np.int32)
    pos_i[:, 0] = la
    pos_j[:, 0] = lb
    np.subtract(la[:, None].astype(np.int32),
                np.cumsum(di, axis=1, dtype=np.int32),
                out=pos_i[:, 1:])
    np.subtract(lb[:, None].astype(np.int32),
                np.cumsum(dj, axis=1, dtype=np.int32),
                out=pos_j[:, 1:])
    # first index whose ENTRY position sits on an edge = steps taken
    edge = (pos_i == 0) | (pos_j == 0)
    reached = edge.any(axis=1)
    if not reached.all():
        bad = np.nonzero(~reached)[0]
        raise RuntimeError(
            f"device walk never reached a DP edge for pairs "
            f"{bad[:8].tolist()} (corrupt dirs or undersized max_steps "
            f"{L}); argmax would silently emit empty chains")
    steps = np.argmax(edge, axis=1)
    # B2 (gap nodes store 0 for the gapped index) + global offsets
    pts_i = np.where(T == 2, 0, pos_i + id_a)
    pts_j = np.where(T == 3, 0, pos_j + id_b)

    cap = L + 1 + (int(la.max(initial=0) + lb.max(initial=0))
                   if mode == "full" else 0)
    if mode == "parity":
        # vectorised reversal: out[r, q] = src[r, K_r - 1 - q], q < K_r
        lens = steps.astype(np.int64)
        cap = int(lens.max(initial=0)) if B else 0
        q = np.arange(max(cap, 1))
        idx = lens[:, None] - 1 - q[None, :cap]
        valid = idx >= 0
        idx = np.where(valid, idx, 0)
        tt = np.where(valid, np.take_along_axis(T, idx, axis=1), 0)
        ii = np.where(valid, np.take_along_axis(pts_i, idx, axis=1), 0)
        jj = np.where(valid, np.take_along_axis(pts_j, idx, axis=1), 0)
        return tt, ii, jj, lens
    tt = np.zeros((B, cap), np.int64)
    ii = np.zeros((B, cap), np.int64)
    jj = np.zeros((B, cap), np.int64)
    lens = np.zeros(B, np.int64)
    for r in range(B):
        K = int(steps[r])
        # chain order: appended points K-1..0 reversed (the edge-entry
        # point p_K is dropped — reference B1)
        t_r = T[r, K - 1:: -1] if K else T[r, :0]
        i_r = pts_i[r, K - 1:: -1] if K else pts_i[r, :0]
        j_r = pts_j[r, K - 1:: -1] if K else pts_j[r, :0]
        if mode == "full":
            # forced edge runs from the stop position (I,J) down to the
            # corner, then the whole rev-list loses its LAST appended
            # point — which is now the final edge-run point, so p_K
            # stays in
            si, sj = int(pos_i[r, K]), int(pos_j[r, K])
            parts_t, parts_i, parts_j = [t_r], [i_r], [j_r]
            parts_t.insert(0, np.array([T[r, K]], np.int64))
            parts_i.insert(0, np.array([pts_i[r, K]], np.int64))
            parts_j.insert(0, np.array([pts_j[r, K]], np.int64))
            if sj > 0:  # gap-in-A run along row 0 (chain order: j 0..sj-1)
                run = np.arange(0, sj, dtype=np.int64)
                parts_t.insert(0, np.full(sj, 2, np.int64))
                parts_i.insert(0, np.zeros(sj, np.int64))
                parts_j.insert(0, run + id_b[r, 0])
            if si > 0:  # gap-in-B run along column 0
                run = np.arange(0, si, dtype=np.int64)
                parts_t.insert(0, np.full(si, 3, np.int64))
                parts_i.insert(0, run + id_a[r, 0])
                parts_j.insert(0, np.zeros(si, np.int64))
            # the chain-order FIRST element corresponds to the rev-list's
            # last appended point, which reference B1 drops
            t_r = np.concatenate(parts_t)[1:]
            i_r = np.concatenate(parts_i)[1:]
            j_r = np.concatenate(parts_j)[1:]
        lens[r] = t_r.shape[0]
        tt[r, : lens[r]] = t_r
        ii[r, : lens[r]] = i_r
        jj[r, : lens[r]] = j_r
    return tt, ii, jj, lens


def walk_semiglobal_batch_device(dirs_dev, end_t, end_i, end_j):
    """Semi-global chains (traceback_semiglobal_from_dirs semantics)."""
    ops, end_i, end_j, end_t = _run_walk(dirs_dev, end_i, end_j, end_t)
    chains = []
    for r in range(len(end_i)):
        rev = []
        i, j, t = int(end_i[r]), int(end_j[r]), int(end_t[r])
        row = ops[r]
        k = 0
        while i > 0 and j > 0:
            rev.append((i, j, t) if t == 1 else
                       ((0, j, 2) if t == 2 else (i, 0, 3)))
            code = int(row[k]) - 1
            k += 1
            if t == 1:
                i, j = i - 1, j - 1
            elif t == 2:
                j = j - 1
            else:
                i = i - 1
            t = code + 1
        while i > 0:  # forced leading gap-in-B run along column 0
            rev.append((i, 0, 3))
            i -= 1
        chains.append(list(reversed(rev)))
    return chains


def walk_overlap_batch_device(dirs_dev, end_t, end_i, end_j):
    """Overlap-mode chains (traceback_overlap_from_dirs semantics)."""
    ops, end_i, end_j, end_t = _run_walk(dirs_dev, end_i, end_j, end_t)
    chains = []
    for r in range(len(end_i)):
        rev = []
        i, j, t = int(end_i[r]), int(end_j[r]), int(end_t[r])
        row = ops[r]
        k = 0
        while i > 0 and j > 0:
            rev.append((i, j, t) if t == 1 else
                       ((0, j, 2) if t == 2 else (i, 0, 3)))
            code = int(row[k]) - 1
            k += 1
            if t == 1:
                i, j = i - 1, j - 1
            elif t == 2:
                j = j - 1
            else:
                i = i - 1
            t = code + 1
        chains.append(list(reversed(rev)))
    return chains
