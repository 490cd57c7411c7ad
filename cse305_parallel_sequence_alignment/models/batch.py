"""Bucketed many-pairs aligner: the throughput mode (reference P6).

The reference harness runs whole alignments on std::threads
(test_functions/testing.cpp:112-158). Here, pairs are length-bucketed
(static shapes for XLA), padded, and processed in lockstep by one batched
fill: the GPU kernel (ops/gpu_fill.py) on a GPU, the XLA wavefront
elsewhere (ops/select.py decides). Bucketing replaces the reference's
omega work-estimate / processor-assignment machinery
(main_alignment.cpp:158-200): load balance comes from static shape
grouping instead of dynamic thread deals.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cse305_parallel_sequence_alignment.core import (
    AlignmentResult,
    ScoringParams,
    encode_seq,
)
from cse305_parallel_sequence_alignment.models.oracle import (
    format_alignment,
)
from cse305_parallel_sequence_alignment.ops import select
from cse305_parallel_sequence_alignment.ops.device_walk import (
    _run_walk,
    _walk_core_rle,
    expand_rle_ops,
    replay_ops,
)
from cse305_parallel_sequence_alignment.ops.gpu_fill import (
    gpu_fill,
    tile_shape,
)
from cse305_parallel_sequence_alignment.ops.traceback import (
    traceback_from_dirs,
)
from cse305_parallel_sequence_alignment.ops.wavefront import (
    PAD_A,
    PAD_B,
    wavefront_dirs_batch,
    wavefront_dirs_batch_matrix,
    wavefront_score_batch,
    wavefront_score_batch_matrix,
)


def _round_up(x, q):
    return max(q, -(-x // q) * q)


def _encode_many(seqs):
    return [encode_seq(s) if isinstance(s, (str, bytes)) else
            np.asarray(s, np.uint8) for s in seqs]


@functools.partial(
    jax.jit,
    static_argnames=("g", "h", "match", "mismatch", "max_steps", "S",
                     "C", "interpret"))
def _fused_fill_walk(a, b, la, lb, st, en, *, g, h, match, mismatch,
                     max_steps, S, C, interpret):
    """One XLA program: GPU fill kernel (dirs words with diagonal run
    lengths) -> end-table choice -> on-device run-length walk.
    Returns (entries (rounds_pad, B) uint16 ON DEVICE, the capped
    prefix of entries, rounds_used, tables, scores); the caller fetches
    only the used rounds (~steps/run_len entries per pair)."""
    finals, dirs16 = gpu_fill(a, b, la, lb, st, g=g, h=h, match=match,
                              mismatch=mismatch, want_dirs=True, S=S,
                              C=C, interpret=interpret)
    # end-table choice, per-pair dynamic end type (tie order
    # T1 >= T2 >= T3, gap-open refund for forced-into-gap ends)
    f1 = finals[:, 0]
    f2 = finals[:, 1] + jnp.where(en == -2, h, 0.0)
    f3 = finals[:, 2] + jnp.where(en == -3, h, 0.0)
    pick1 = (f1 >= f2) & (f1 >= f3)
    pick2 = ~pick1 & (f2 >= f3)
    tb_free = jnp.where(pick1, 1, jnp.where(pick2, 2, 3))
    sc_free = jnp.where(pick1, f1, jnp.where(pick2, f2, f3))
    forced = en > 0
    sc_forced = jnp.take_along_axis(
        finals, jnp.clip(en - 1, 0, 2)[:, None], axis=1)[:, 0]
    tb = jnp.where(forced, en, tb_free).astype(jnp.int32)
    sc = jnp.where(forced, sc_forced, sc_free)
    entries, used = _walk_core_rle(dirs16, la, lb, tb, max_steps=max_steps)
    # capped prefix ships WITH the scores in one host transfer; the
    # full buffer stays on device for the rare used > cap overflow
    cap = min(entries.shape[0], max(256, max_steps // 16))
    return entries, entries[:cap], used, tb, sc


def _end_choice_vec(finals, end_type, h):
    """Vectorised end-table choice (tie order T1>=T2>=T3, gap-open refund)."""
    t1 = finals[:, 0]
    t2 = finals[:, 1] + (h if end_type == -2 else 0.0)
    t3 = finals[:, 2] + (h if end_type == -3 else 0.0)
    if end_type > 0:
        table = np.full(len(finals), end_type, np.int32)
        score = finals[:, end_type - 1]
        return table, score
    pick1 = (t1 >= t2) & (t1 >= t3)
    pick2 = ~pick1 & (t2 >= t3)
    table = np.where(pick1, 1, np.where(pick2, 2, 3)).astype(np.int32)
    score = np.where(pick1, t1, np.where(pick2, t2, t3))
    return table, score


@dataclasses.dataclass
class BatchAligner:
    """Aligns many pairs at once with length bucketing.

    ``bucket_quantum`` controls padded-shape granularity (compilation cache
    trades against padding waste). ``max_batch`` caps device batch size per
    launch (memory control for the direction matrices). ``backend`` picks
    the fill (ops/select.py): "auto" takes the GPU kernel on a GPU and
    the XLA wavefront elsewhere; "kernel" and "wavefront" force one.
    """

    params: ScoringParams = ScoringParams()
    start_type: int = -1
    end_type: int = -1
    parity_swap: bool = True
    bucket_quantum: int = 128
    max_batch: int = 512
    backend: str = "auto"
    # cap on a single launch's direction-matrix footprint (bytes);
    # align_batch shrinks its chunk size to fit
    dirs_budget: int = 2 << 30
    # optional core.SubstitutionMatrix: full KxK scoring instead of
    # match/mismatch; sequences are alphabet-encoded and the fill uses
    # the matrix-lookup wavefront kernels
    matrix: object = None

    def _use_kernel(self):
        """GPU fill kernel for match/mismatch scoring; substitution
        matrices take the XLA wavefront, which gathers natively."""
        return self.matrix is None and select.use_fill_kernel(self.backend)

    def _matrix_kw(self):
        return dict(g=self.params.g, h=self.params.h,
                    start_type=self.start_type,
                    pad_code=self.matrix.pad_code)

    def _finals(self, a, b, la, lb):
        """(B, 3) final-cell values for a padded bucket."""
        if self.matrix is not None:
            return np.asarray(wavefront_score_batch_matrix(
                jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                jnp.asarray(lb), jnp.asarray(self.matrix.table()),
                **self._matrix_kw()))
        if self._use_kernel():
            kw = self._kw()
            st = np.full(la.shape, kw.pop("start_type"), np.int32)
            S, C = tile_shape(*a.shape, b.shape[1])
            finals, _ = gpu_fill(
                jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                jnp.asarray(lb), jnp.asarray(st), want_dirs=False, S=S,
                C=C, interpret=select.kernel_interpret(), **kw)
            return np.asarray(finals)
        return np.asarray(wavefront_score_batch(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
            jnp.asarray(lb), **self._kw()))

    def _dirs(self, a, b, la, lb):
        """(finals (B,3), skew dirs (B, m+n+1, n+1) uint8) for a padded
        bucket through the XLA wavefront; dirs stay on the device on a
        GPU (the walk runs there too, ops/device_walk.py) and come to
        the host elsewhere (native walker)."""
        if self.matrix is not None:
            finals, dirs = wavefront_dirs_batch_matrix(
                jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                jnp.asarray(lb), jnp.asarray(self.matrix.table()),
                **self._matrix_kw())
        else:
            finals, dirs = wavefront_dirs_batch(
                jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                jnp.asarray(lb), **self._kw())
        if select.on_gpu():
            return np.asarray(finals), dirs
        return np.asarray(finals), np.asarray(dirs)

    def _kw(self):
        g, h, match, mismatch = self.params.astuple()
        return dict(g=g, h=h, match=match, mismatch=mismatch,
                    start_type=self.start_type)

    def _prep(self, pairs):
        enc_a = _encode_many([p[0] for p in pairs])
        enc_b = _encode_many([p[1] for p in pairs])
        if self.parity_swap:
            for k in range(len(pairs)):
                if enc_a[k].shape[0] > enc_b[k].shape[0]:
                    enc_a[k], enc_b[k] = enc_b[k], enc_a[k]
        buckets = {}
        for k, (ea, eb) in enumerate(zip(enc_a, enc_b)):
            key = (_round_up(ea.shape[0], self.bucket_quantum),
                   _round_up(eb.shape[0], self.bucket_quantum))
            buckets.setdefault(key, []).append(k)
        return enc_a, enc_b, buckets

    def _bucket_arrays(self, enc_a, enc_b, idxs, key):
        bm, bn = key
        B = len(idxs)
        if self.matrix is None:
            pa, pb = PAD_A, PAD_B
        else:  # matrix path: device arrays hold alphabet codes
            pa = pb = np.uint8(self.matrix.pad_code)
        a = np.full((B, bm), pa, np.uint8)
        b = np.full((B, bn), pb, np.uint8)
        la = np.zeros((B,), np.int32)
        lb = np.zeros((B,), np.int32)
        for r, k in enumerate(idxs):
            ra, rb = enc_a[k], enc_b[k]
            if self.matrix is not None:
                ra = self.matrix.encode(bytes(ra))
                rb = self.matrix.encode(bytes(rb))
            la[r] = ra.shape[0]
            lb[r] = rb.shape[0]
            a[r, : la[r]] = ra
            b[r, : lb[r]] = rb
        return a, b, la, lb

    def score_batch(self, pairs):
        """Scores for a list of (a, b) pairs. Returns (scores, end_tables).

        ``self.last_launches`` records the device launches of the most
        recent call as (padded_m, padded_n, batch) tuples — the harness
        CSVs' sidecar metadata (per-launch batch size attribution)."""
        enc_a, enc_b, buckets = self._prep(pairs)
        scores = np.zeros(len(pairs), np.float32)
        tables = np.zeros(len(pairs), np.int32)
        self.last_launches = []
        for key, idxs in buckets.items():
            for s in range(0, len(idxs), self.max_batch):
                chunk = idxs[s: s + self.max_batch]
                self.last_launches.append((key[0], key[1], len(chunk)))
                a, b, la, lb = self._bucket_arrays(enc_a, enc_b, chunk, key)
                finals = self._finals(a, b, la, lb)
                tb, sc = _end_choice_vec(finals, self.end_type,
                                         self.params.h)
                scores[chunk] = sc
                tables[chunk] = tb
        return scores, tables

    def align_batch(self, pairs, offsets=None, traceback_mode="parity",
                    start_types=None, end_types=None):
        """Full alignments (device fill + host traceback) for all pairs.

        ``offsets``: optional per-pair (id_a, id_b) global coordinate
        offsets (partitioned segment solves). ``traceback_mode``: see
        ops/traceback.py ("parity" = reference B1; "full" = emit edge
        runs, required when stitching segments). ``start_types``/
        ``end_types``: optional per-pair boundary types overriding the
        aligner's scalars — mixed-type batches (the partition layer's
        anchored segments) run as ONE device dispatch on the kernel
        path; the XLA path subgroups by type."""
        enc_a, enc_b, buckets = self._prep(pairs)
        results: list = [None] * len(pairs)
        pending: list = []
        for key, idxs in buckets.items():
            bm, bn = key
            if self._use_kernel():
                # uint16 dirs words (codes + run lengths)
                per_pair = 2 * (bm + 1) * (bn + 1)
            else:  # uint8 skew layout
                per_pair = (bm + bn + 1) * (bn + 1)
            step = max(1, min(self.max_batch, self.dirs_budget // per_pair))
            if len(idxs) >= 64 and step >= len(idxs):
                # split big single-chunk batches in two so the second
                # chunk's device time hides the first's host replay +
                # render
                step = -(-len(idxs) // 2)
            elif step < len(idxs):
                # equalize chunk sizes: a ragged tail (e.g. 239+17 at
                # the default budget) pays a full walk + sync for a
                # sliver of work
                nchunks = -(-len(idxs) // step)
                step = -(-len(idxs) // nchunks)
            for s in range(0, len(idxs), step):
                chunk = idxs[s: s + step]
                a, b, la, lb = self._bucket_arrays(enc_a, enc_b, chunk, key)
                st_vec = en_vec = None
                if start_types is not None:
                    st_vec = np.asarray(
                        [start_types[k] for k in chunk], np.int32)
                if end_types is not None:
                    en_vec = np.asarray(
                        [end_types[k] for k in chunk], np.int32)
                if self._use_kernel():
                    # single-dispatch path: fill + end choice + walk in
                    # ONE compiled program, ONE host round trip with
                    # run-length op codes
                    handles = self._dispatch_fused(
                        a, b, la, lb, st_vec, en_vec)
                    item = ("fused", chunk, la, lb, handles)
                else:
                    chains, arrays, tables, scores = \
                        self._dirs_walk_grouped(
                            a, b, la, lb, st_vec, en_vec,
                            traceback_mode, offsets, chunk)
                    item = ("done", chunk, chains, arrays, tables, scores)
                # two chunks in flight: the device fills/walks chunk c+1
                # while the host replays + renders chunk c
                pending.append(item)
                while len(pending) > 1:
                    self._emit_chunk(pending.pop(0), enc_a, enc_b,
                                     results, offsets, traceback_mode)
        while pending:
            self._emit_chunk(pending.pop(0), enc_a, enc_b, results,
                             offsets, traceback_mode)
        return results

    def _dirs_walk_grouped(self, a, b, la, lb, st_vec, en_vec, mode,
                           offsets, chunk):
        """XLA fill + walk, subgrouped by boundary type when per-pair
        type vectors are present (the XLA fills key start_type
        statically)."""
        if st_vec is None and en_vec is None:
            finals, dirs = self._dirs(a, b, la, lb)
            tables, scores = _end_choice_vec(
                finals, self.end_type, self.params.h)
            chains, arrays = self._walk_chunk(
                dirs, la, lb, tables, mode, offsets, chunk)
            return chains, arrays, tables, scores
        B = len(chunk)
        sts = st_vec if st_vec is not None else \
            np.full(B, self.start_type, np.int32)
        ens = en_vec if en_vec is not None else \
            np.full(B, self.end_type, np.int32)
        chains = [None] * B
        tables = np.zeros(B, np.int32)
        scores = np.zeros(B, np.float32)
        for (st, en) in sorted({(int(s_), int(e_))
                                for s_, e_ in zip(sts, ens)}):
            rows = [r for r in range(B)
                    if sts[r] == st and ens[r] == en]
            sub = dataclasses.replace(self, start_type=st, end_type=en)
            finals, dirs = sub._dirs(a[rows], b[rows], la[rows], lb[rows])
            tb, sc = _end_choice_vec(finals, en, self.params.h)
            sub_chunk = [chunk[r] for r in rows]
            ch, _ = sub._walk_chunk(dirs, la[rows], lb[rows], tb, mode,
                                    offsets, sub_chunk)
            for w, r in enumerate(rows):
                chains[r] = ch[w]
                tables[r] = tb[w]
                scores[r] = sc[w]
        return chains, None, tables, scores

    def _emit_chunk(self, item, enc_a, enc_b, results, offsets, mode):
        if item[0] == "fused":
            _, chunk, la, lb, handles = item
            chains, arrays, tables, scores = self._collect_fused(
                handles, la, lb, mode, offsets, chunk)
        else:
            _, chunk, chains, arrays, tables, scores = item
        for r, k in enumerate(chunk):
            chain = chains[r]
            if offsets is not None:
                # chain is in global coordinates; the caller renders
                # the stitched result itself
                row_a = row_b = None
            else:
                row_a = row_b = None
                if arrays is not None:
                    from cse305_parallel_sequence_alignment.native \
                        import walker
                    tt, ii, jj, lens = arrays
                    L = int(lens[r])
                    out = walker.render(enc_a[k], enc_b[k], tt[r, :L],
                                        ii[r, :L], jj[r, :L])
                    if out is not None:
                        row_a, row_b = out
                if row_a is None:
                    row_a, row_b = format_alignment(
                        bytes(enc_a[k]), bytes(enc_b[k]), chain)
            results[k] = AlignmentResult(
                score=float(scores[r]), chain=chain,
                aligned_a=row_a, aligned_b=row_b,
                end_table=int(tables[r]))

    def _dispatch_fused(self, a, b, la, lb, st_vec=None, en_vec=None):
        """Queue fill + end choice + walk as ONE compiled dispatch;
        returns device handles (RLE entries, rounds, tables, scores)
        without synchronizing — align_batch keeps two chunks in flight.
        ``st_vec``/``en_vec``: optional per-pair boundary types (the
        partition layer's mixed-type segment batches); default = the
        aligner's scalar types."""
        B = la.shape[0]
        st = np.full((B,), int(self.start_type), np.int32)
        if st_vec is not None:
            st[:] = np.asarray(st_vec, np.int32)
        en = np.full((B,), int(self.end_type), np.int32)
        if en_vec is not None:
            en[:] = np.asarray(en_vec, np.int32)
        # the bucket's longest path, so one compiled program serves it
        max_steps = a.shape[1] + b.shape[1] + 1
        g, h, match, mismatch = self.params.astuple()
        S, C = tile_shape(B, a.shape[1], b.shape[1])
        entries, ent_cap, used, tables, scores = _fused_fill_walk(
            *(jnp.asarray(x) for x in (a, b, la, lb, st, en)), g=g, h=h,
            match=match, mismatch=mismatch, max_steps=max_steps, S=S,
            C=C, interpret=select.kernel_interpret())
        # start device->host copies NOW: by collect time (the pipeline
        # dispatches the next chunk first) the bytes are host-side and
        # the fetch costs ~0 round trips
        for x in (ent_cap, used, tables, scores):
            x.copy_to_host_async()
        return entries, ent_cap, used, tables, scores, max_steps

    def _collect_fused(self, handles, la, lb, mode, offsets, chunk):
        """Fetch a dispatched chunk (scores + the USED rounds of the
        RLE walk entries only), expand the run-length codes, replay,
        and wrap chains as LazyChain views (most consumers never touch
        the tuples)."""
        from cse305_parallel_sequence_alignment.core import LazyChain

        entries_d, ent_cap_d, used_d, tables_d, scores_d, max_steps = \
            handles
        ent, used, tables, scores = jax.device_get(
            (ent_cap_d, used_d, tables_d, scores_d))
        B = len(chunk)
        if int(used) > ent.shape[0]:
            # overflow past the shipped cap (atypical paths): fetch
            # the full used prefix in a second round trip
            rounds_cap = entries_d.shape[0]
            rpad = min(rounds_cap, -(-int(used) // 256) * 256)
            ent = jax.device_get(entries_d[:rpad])
        ent_b = ent.T[:B]
        from cse305_parallel_sequence_alignment.native import walker
        out = walker.replay_rle(ent_b, np.asarray(la, np.int64),
                                np.asarray(lb, np.int64),
                                tables.astype(np.int32), mode,
                                offsets=offsets, chunk=chunk)
        if out is not None:  # thread-parallel C++ replay
            tt, ii, jj, lens = out
        else:
            ops = expand_rle_ops(ent_b, max_steps)
            tt, ii, jj, lens = replay_ops(
                ops[:, :max_steps], np.asarray(la, np.int64),
                np.asarray(lb, np.int64), tables.astype(np.int64),
                mode=mode, offsets=offsets, chunk=chunk)
        # per-row copies so a kept chain doesn't pin the (B, cap) bases
        chains = [LazyChain(tt[r, : lens[r]].copy(),
                            ii[r, : lens[r]].copy(),
                            jj[r, : lens[r]].copy())
                  for r in range(B)]
        arrays = (tt, ii, jj, lens) if offsets is None else None
        return chains, arrays, tables, scores.astype(np.float32)

    def _walk_chunk(self, dirs, la, lb, tables, mode, offsets, chunk):
        """(chains, render_arrays) for every pair of one device chunk:
        on-device walk when the dirs array lives on the accelerator
        (2-bit codes come back instead of the matrix), thread-parallel
        native walk when libtsa is built, per-pair Python walk otherwise
        (identical output — tests assert equality). ``render_arrays`` is
        (tt, ii, jj, lens) in LOCAL coordinates for the native renderer,
        or None (only populated when offsets is None)."""
        if not isinstance(dirs, np.ndarray):  # device-resident
            ops, la64, lb64, t64 = _run_walk(dirs, la, lb, tables)
            tt, ii, jj, lens = replay_ops(ops, la64, lb64, t64, mode=mode,
                                          offsets=offsets, chunk=chunk)
            chains = [list(zip(ii[r, : lens[r]].tolist(),
                               jj[r, : lens[r]].tolist(),
                               tt[r, : lens[r]].tolist()))
                      for r in range(len(chunk))]
            arrays = (tt, ii, jj, lens) if offsets is None else None
            return chains, arrays
        from cse305_parallel_sequence_alignment.native import walker
        out = walker.walk_batch(dirs, la, lb, tables,
                                layout="skew", mode=mode)
        chains = []
        if out is not None:
            tt, ii, jj, lens = out
            for r, k in enumerate(chunk):
                L = int(lens[r])
                t_r = tt[r, :L]
                i_r, j_r = ii[r, :L].copy(), jj[r, :L].copy()
                if offsets is not None:
                    id_a, id_b = offsets[k]
                    # gap points keep their stored zero (quirk B2)
                    i_r[i_r != 0] += id_a
                    j_r[j_r != 0] += id_b
                chains.append(list(zip(i_r.tolist(), j_r.tolist(),
                                       t_r.tolist())))
            return chains, (out if offsets is None else None)
        for r, k in enumerate(chunk):
            id_a, id_b = offsets[k] if offsets else (0, 0)
            chain, _, _ = traceback_from_dirs(
                dirs[r], np.full(3, 0.0), int(la[r]), int(lb[r]),
                self.params.h, tables[r], id_a=id_a, id_b=id_b,
                layout="skew", mode=mode)
            chains.append(chain)
        return chains, None
