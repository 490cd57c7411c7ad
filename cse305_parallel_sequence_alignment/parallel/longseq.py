"""Long-sequence mode: one giant DP matrix sharded across the device mesh.

The reference's answer to quadratic memory is the balanced-partition layer
(O(m*n/p) per worker); its answer to parallel fill is row-block threads with
a racy OpenMP pragma (partial.cpp:57-78, dead at HEAD). The answer here
is a **column-sharded wavefront pipeline**:

- B's columns are sharded over the ``seq`` mesh axis (device k owns one
  contiguous block); A is replicated.
- Rows are processed in chunks of R. Device k works on row-chunk c at
  pipeline step s = c + k (staircase schedule); between steps each device
  sends the right-edge (T1,T2,T3) column of its freshly computed rows to
  its right neighbour with ``lax.ppermute`` — the halo that carries both
  the intra-row (T2 prefix-max) and diagonal dependencies between
  devices (NVLink on a multi-GPU host).
- The T2 in-block recurrence uses the same prefix-max linearisation as the
  reference (P2) with *global* column offsets, so block-local
  ``associative_scan`` + one scalar carry from the halo reproduce the
  sequential recurrence exactly.

Score-only (O(n/devices) memory per device); the partition layer turns the
result into full tracebacks segment by segment. Runs unchanged on a CPU
host-device mesh (tests) and on the GPUs of one host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from cse305_parallel_sequence_alignment.core import NEG_INF, ScoringParams
from cse305_parallel_sequence_alignment.ops.wavefront import PAD_A, PAD_B
from cse305_parallel_sequence_alignment.parallel.mesh import make_seq_mesh

_NEG = jnp.float32(NEG_INF)


def _row0_t2_at(j, g, h, start_type):
    """Global first-row T2 boundary at 1-based column(s) j (j >= 1)."""
    jf = j.astype(jnp.float32) if hasattr(j, "astype") else jnp.float32(j)
    if start_type == -2:
        return -g * jf
    if start_type in (1, 3):
        return jnp.full_like(jf, NEG_INF)
    return -h - g * jf


def _longseq_local(a_pad, b_loc, len_a, len_b, *, m, n, nc, R, D, g, h,
                   match, mismatch, start_type):
    """Per-device body under shard_map. a_pad: (C*R,) replicated,
    b_loc: (nc,) this device's column block; len_a/len_b: traced true
    lengths (m, n are the padded static shape — under vmap this makes
    ragged batches shareable). Returns ((3,) finals via pmax, (3, nc)
    local block of row len_a)."""
    k = jax.lax.axis_index("seq")
    C = a_pad.shape[0] // R
    S = C + D - 1
    gf, hf = jnp.float32(g), jnp.float32(h)

    # global 1-based column indices of the local block
    j_glob = k * nc + 1 + jnp.arange(nc, dtype=jnp.int32)
    jg = gf * j_glob.astype(jnp.float32)          # j*g, global offsets
    # left-ghost global column (j0-1); 0 means matrix column 0
    j_ghost = k * nc
    jg_ghost = gf * j_ghost.astype(jnp.float32)

    # row 0 boundary for the local block
    row0 = (
        jnp.full((nc,), NEG_INF, jnp.float32),
        _row0_t2_at(j_glob, gf, hf, start_type),
        jnp.full((nc,), NEG_INF, jnp.float32),
    )
    # row-0 ghost (cell (0, j0-1)): corner for k == 0, row0 else
    corner = (
        jnp.float32(0.0 if start_type in (1, -1) else NEG_INF),
        jnp.float32(0.0 if start_type == -2 else NEG_INF),
        jnp.float32(0.0 if start_type == -3 else NEG_INF),
    )
    ghost0 = tuple(
        jnp.where(k == 0, corner[t],
                  jnp.where(jnp.int32(t) == 1,
                            _row0_t2_at(jnp.float32(j_ghost), gf, hf,
                                        start_type),
                            _NEG))
        for t in range(3))

    # mask for the final cell (global column len_b) inside this block
    lb_mask = j_glob == len_b

    def row_step(carry, xs):
        """One DP row for the local block."""
        (p1, p2, p3), (gd1, gd2, gd3), active_row = carry
        a_i, (gc1, gc2, gc3), i_glob = xs
        # ghost-extended previous row: [ghost_diag, prev_row]
        e1 = jnp.concatenate([gd1[None], p1])
        e2 = jnp.concatenate([gd2[None], p2])
        e3 = jnp.concatenate([gd3[None], p3])
        fb = jnp.where(b_loc == a_i, jnp.float32(match),
                       jnp.float32(mismatch))
        t1 = fb + jnp.maximum(jnp.maximum(e1[:-1], e2[:-1]), e3[:-1])
        t3 = jnp.maximum(jnp.maximum(p1 - gf - hf, p2 - gf - hf), p3 - gf)
        # T2 via the prefix-max linearization with *global* column
        # offsets (reference P2, subproblem_alignment.cpp:237-249):
        #   omega_j = j*g + max(T1[i][j-1], T3[i][j-1]) - g - h
        #   T2[i][j] = prefmax_{k<=j}(omega_k) - j*g
        # The j-1 values at the block edge come from the halo ghosts, and
        # the left block's whole prefix state enters through one scalar:
        #   prefmax_{k<j0}(omega_k) = T2[i][j0-1] + g*(j0-1).
        m1 = jnp.concatenate([gc1[None], t1[:-1]])
        m3 = jnp.concatenate([gc3[None], t3[:-1]])
        omega = jg + jnp.maximum(m1, m3) - gf - hf
        seed = gc2 + jg_ghost
        pm = jax.lax.associative_scan(
            jnp.maximum, jnp.concatenate([seed[None], omega]))
        t2 = pm[1:] - jg
        # column-0 ghost (k == 0) is closed-form; others come from halo.
        new_row = (t1, t2, t3)
        upd = lambda new, old: jnp.where(active_row & (i_glob <= len_a),
                                         new, old)
        p1n, p2n, p3n = (upd(t1, p1), upd(t2, p2), upd(t3, p3))
        gd = tuple(upd(gc, gdo) for gc, gdo in
                   zip((gc1, gc2, gc3), (gd1, gd2, gd3)))
        edge = tuple(r[-1] for r in (p1n, p2n, p3n))
        return ((p1n, p2n, p3n), gd, active_row), (edge, new_row)

    def step(carry, s):
        prev_row, ghost_diag, msg_in, finals = carry
        c = s - k                      # this device's chunk index
        active = (c >= 0) & (c < C)
        c_cl = jnp.clip(c, 0, C - 1)
        a_rows = jax.lax.dynamic_slice(a_pad, (c_cl * R,), (R,))
        i_glob = c_cl * R + 1 + jnp.arange(R, dtype=jnp.int32)
        # ghosts for the R rows: from left halo, or closed-form for k == 0
        g1 = jnp.where(k == 0, _NEG, msg_in[:, 0])
        g2 = jnp.where(k == 0, _NEG, msg_in[:, 1])
        # closed-form column-0 T3 boundary (core.boundary_col0 semantics)
        if start_type == -3:
            col0 = -gf * i_glob.astype(jnp.float32)
        elif start_type in (1, 2):
            col0 = jnp.full((R,), NEG_INF, jnp.float32)
        else:
            col0 = -hf - gf * i_glob.astype(jnp.float32)
        g3 = jnp.where(k == 0, col0, msg_in[:, 2])

        (prev_row2, ghost_diag2, _), (edges, rows) = jax.lax.scan(
            row_step, (prev_row, ghost_diag, active),
            (a_rows, (g1, g2, g3), i_glob))

        # capture finals when this chunk contains global row len_a
        t1r, t2r, t3r = rows
        has_m = active & (c_cl * R + 1 <= len_a) & \
            (len_a <= (c_cl + 1) * R)
        r_idx = jnp.clip(len_a - 1 - c_cl * R, 0, R - 1)
        cand = jnp.stack([
            jnp.max(jnp.where(lb_mask, t1r[r_idx], NEG_INF)),
            jnp.max(jnp.where(lb_mask, t2r[r_idx], NEG_INF)),
            jnp.max(jnp.where(lb_mask, t3r[r_idx], NEG_INF))])
        finals = jnp.where(has_m, cand, finals)

        # send right-edge columns of the processed rows to the right
        out_msg = jnp.stack(edges, axis=1)  # (R, 3)
        msg_next = jax.lax.ppermute(
            out_msg, "seq", [(d, (d + 1) % D) for d in range(D)])
        return (prev_row2, ghost_diag2, msg_next, finals), None

    msg0 = jnp.zeros((R, 3), jnp.float32)
    finals0 = jnp.full((3,), NEG_INF, jnp.float32)
    carry0 = (row0, ghost0, msg0, finals0)
    (last_row, _, _, finals), _ = jax.lax.scan(
        step, carry0, jnp.arange(S, dtype=jnp.int32))
    # broadcast the owner's finals to every device; prev_row froze at
    # global row m (updates are gated on i_glob <= m), so it IS row m —
    # the partition layer's capture primitive (each device returns its
    # local column block, reassembled sharded by the caller)
    return jax.lax.pmax(finals, "seq"), jnp.stack(last_row)


@functools.partial(
    jax.jit,
    static_argnames=("m", "n", "nc", "R", "D", "g", "h", "match",
                     "mismatch", "start_type", "mesh_holder"))
def _longseq_jit(a_pad, b_shard, len_a, len_b, m, n, nc, R, D, g, h,
                 match, mismatch, start_type, mesh_holder):
    mesh = mesh_holder.mesh
    body = functools.partial(
        _longseq_local, m=m, n=n, nc=nc, R=R, D=D, g=g, h=h, match=match,
        mismatch=mismatch, start_type=start_type)
    # check_vma off: the pipeline carry starts replicated (closed-form
    # boundary rows) and becomes device-varying via b_shard and the
    # ppermute halo; the static checker cannot express that transition.
    mapped = jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P("seq"), P(), P()),
        out_specs=(P(), P(None, "seq")), check_vma=False)
    return mapped(a_pad, b_shard, len_a, len_b)


@functools.partial(
    jax.jit,
    static_argnames=("m", "n", "nc", "R", "D", "g", "h", "match",
                     "mismatch", "start_type", "mesh_holder"))
def _longseq_batch_jit(a_pad, b_shard, len_a, len_b, m, n, nc, R, D, g, h,
                       match, mismatch, start_type, mesh_holder):
    """Batched 2D-mesh variant: pairs sharded over ``data``, each pair's
    columns over ``seq``. a_pad: (B, C*R); b_shard: (B, nc*D)."""
    mesh = mesh_holder.mesh
    body = functools.partial(
        _longseq_local, m=m, n=n, nc=nc, R=R, D=D, g=g, h=h, match=match,
        mismatch=mismatch, start_type=start_type)
    vbody = jax.vmap(body)
    mapped = jax.shard_map(
        vbody, mesh=mesh,
        in_specs=(P("data"), P("data", "seq"), P("data"), P("data")),
        out_specs=(P("data"), P("data", None, "seq")), check_vma=False)
    return mapped(a_pad, b_shard, len_a, len_b)


class _MeshHolder:
    """Hashable wrapper so a Mesh can ride through static jit args."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash(tuple(d.id for d in self.mesh.devices.flat))

    def __eq__(self, other):
        return isinstance(other, _MeshHolder) and \
            self.mesh == other.mesh


def _row0_stack(n, start_type, g, h):
    from cse305_parallel_sequence_alignment.core import boundary_row0
    return np.stack(boundary_row0(n, start_type, g, h))


def _longseq_run(a, b, params, start_type, mesh, row_chunk):
    from cse305_parallel_sequence_alignment.core import encode_seq
    a_enc = encode_seq(a) if isinstance(a, (str, bytes)) else \
        np.asarray(a, np.uint8)
    b_enc = encode_seq(b) if isinstance(b, (str, bytes)) else \
        np.asarray(b, np.uint8)
    m, n = a_enc.shape[0], b_enc.shape[0]
    if m == 0:  # degenerate: the fill is just the closed-form first row
        g, h, _, _ = params.astuple()
        row0 = _row0_stack(n, start_type, g, h)
        return row0[:, n], row0[:, 1:], m, n
    if n == 0:  # degenerate: closed-form first column
        from cse305_parallel_sequence_alignment.core import boundary_col0
        g, h, _, _ = params.astuple()
        c1, c2, c3 = boundary_col0(m, start_type, g, h)
        finals = np.array([c1[m - 1], c2[m - 1], c3[m - 1]], np.float32)
        return finals, np.zeros((3, 0), np.float32), m, n
    mesh = mesh or make_seq_mesh()
    D = mesh.devices.size
    nc = -(-n // D)
    R = min(row_chunk, max(m, 1))
    C = -(-m // R)

    a_pad = np.full((C * R,), PAD_A, np.uint8)
    a_pad[:m] = a_enc
    b_pad = np.full((nc * D,), PAD_B, np.uint8)
    b_pad[:n] = b_enc

    a_dev = jax.device_put(jnp.asarray(a_pad), NamedSharding(mesh, P()))
    b_dev = jax.device_put(jnp.asarray(b_pad), NamedSharding(mesh,
                                                             P("seq")))
    g, h, match, mismatch = params.astuple()
    finals, lastrow = _longseq_jit(
        a_dev, b_dev, jnp.int32(m), jnp.int32(n), m, n, nc, R, D, g, h,
        match, mismatch, start_type, _MeshHolder(mesh))
    return finals, lastrow, m, n


def longseq_pipeline_stats(m, n, devices, row_chunk=64):
    """Static pipeline accounting for one sharded fill: the halo
    traffic and ramp shape, computable without hardware.

    The pipeline runs S = C + D - 1 macro-steps; each step every device
    processes R rows of its column block and ppermutes one (R, 3) f32
    halo to its right neighbour. Devices idle during the D - 1 ramp
    steps, so C / S bounds pipeline efficiency — pick row_chunk (R) so
    C >> D."""
    D = max(1, int(devices))
    R = min(row_chunk, max(m, 1))
    C = -(-m // R)
    S = C + D - 1
    nc = -(-n // D)
    return {
        "devices": D,
        "rows_per_step": R,
        "chunks": C,
        "pipeline_steps": S,
        "cols_per_device": nc,
        "bytes_per_ppermute_per_device": R * 3 * 4,
        "total_halo_bytes": S * D * R * 3 * 4,
        "ramp_fraction": round((D - 1) / S, 4),
        "efficiency_bound": round(C / S, 4),
        "dispatches": 1,
    }


def longseq_score(a, b, params=ScoringParams(), start_type=-1,
                  mesh=None, row_chunk=64):
    """Sharded score-only fill of one (possibly huge) pair.

    Returns (3,) final-cell (T1, T2, T3) at (m, n), identical to
    rowscan_score. Columns are sharded over the ``seq`` axis of ``mesh``
    (default: all devices)."""
    finals, _, _, _ = _longseq_run(a, b, params, start_type, mesh,
                                   row_chunk)
    return np.asarray(finals)


def longseq_score_batch(pairs, params=ScoringParams(), start_type=-1,
                        mesh=None, row_chunk=64):
    """Batched column-sharded fill over a 2D (data, seq) mesh: many long
    pairs at once, each pair's DP grid sharded across the ``seq`` axis
    while the batch spreads across ``data``. Pairs are padded to the max
    length in the call; per-pair true lengths drive the final-cell
    capture. Returns (B, 3) finals.
    """
    from cse305_parallel_sequence_alignment.core import encode_seq
    from cse305_parallel_sequence_alignment.parallel.mesh import (
        make_2d_mesh,
    )
    enc_a = [encode_seq(a) if isinstance(a, (str, bytes))
             else np.asarray(a, np.uint8) for a, _ in pairs]
    enc_b = [encode_seq(b) if isinstance(b, (str, bytes))
             else np.asarray(b, np.uint8) for _, b in pairs]
    B = len(pairs)
    m = max(x.shape[0] for x in enc_a)
    n = max(x.shape[0] for x in enc_b)
    mesh = mesh or make_2d_mesh(seq=max(
        1, jax.device_count() // max(1, B)))
    Dd = mesh.shape["data"]
    D = mesh.shape["seq"]
    if B % Dd:
        raise ValueError(f"batch {B} must divide data axis {Dd}")
    nc = -(-n // D)
    R = min(row_chunk, max(m, 1))
    C = -(-m // R)

    a_pad = np.full((B, C * R), PAD_A, np.uint8)
    b_pad = np.full((B, nc * D), PAD_B, np.uint8)
    la = np.zeros((B,), np.int32)
    lb = np.zeros((B,), np.int32)
    for k in range(B):
        la[k], lb[k] = enc_a[k].shape[0], enc_b[k].shape[0]
        a_pad[k, : la[k]] = enc_a[k]
        b_pad[k, : lb[k]] = enc_b[k]

    a_dev = jax.device_put(jnp.asarray(a_pad),
                           NamedSharding(mesh, P("data")))
    b_dev = jax.device_put(jnp.asarray(b_pad),
                           NamedSharding(mesh, P("data", "seq")))
    la_dev = jax.device_put(jnp.asarray(la), NamedSharding(mesh,
                                                           P("data")))
    lb_dev = jax.device_put(jnp.asarray(lb), NamedSharding(mesh,
                                                           P("data")))
    g, h, match, mismatch = params.astuple()
    finals, _ = _longseq_batch_jit(
        a_dev, b_dev, la_dev, lb_dev, m, n, nc, R, D, g, h, match,
        mismatch, start_type, _MeshHolder(mesh))
    return np.asarray(finals)


def longseq_lastrow(a, b, params=ScoringParams(), start_type=-1,
                    mesh=None, row_chunk=64):
    """Sharded fill returning the full last row: (3, n+1) values of
    T1/T2/T3 at row m, columns 0..n — identical to rowscan_lastrow's
    final row but O(n/D) memory per device. This is the partition
    layer's capture primitive at multi-chip scale (crossing-point search
    over a 100k x 100k grid, BASELINE config 4)."""
    from cse305_parallel_sequence_alignment.core import (
        boundary_col0,
        boundary_row0,
    )
    g, h, _, _ = params.astuple()
    finals, lastrow, m, n = _longseq_run(a, b, params, start_type, mesh,
                                         row_chunk)
    lastrow = np.asarray(lastrow)[:, :n]  # drop padded columns
    # column 0 of row m comes from the closed-form boundary
    if m == 0:
        r1, r2, r3 = boundary_row0(n, start_type, g, h)
        return np.stack([r1, r2, r3])
    c1, c2, c3 = boundary_col0(m, start_type, g, h)
    col0 = np.array([[c1[m - 1]], [c2[m - 1]], [c3[m - 1]]], np.float32)
    return np.concatenate([col0, lastrow], axis=1)
