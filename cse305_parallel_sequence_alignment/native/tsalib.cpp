// Native host runtime for the alignment framework.
//
// The device (GPU) does the O(m*n) fill; these routines cover the
// inherently sequential / IO-bound host side, mirroring the roles the
// reference implements in C++ (traceback: subproblem_alignment.cpp:105-172;
// FASTA ingestion: test_functions/pull_data.cpp:18-71) but operating on the
// packed direction matrices our kernels emit.
//
// Exposed with a plain C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Walk a packed direction matrix back from (m, n).
//
//   dirs:     base pointer of the uint8 direction array
//   stride_d: byte stride between rows (rect: row i; skew: diagonal d)
//   stride_j: byte stride between columns
//   layout:   0 = rect (cell (i,j) at dirs[i][j]),
//             1 = skew (cell (i,j) at dirs[i+j][j])
//   t0:       end table in {1,2,3}
//
// Writes the predecessor steps in walk order (end -> start) as parallel
// arrays out_t / out_pi / out_pj and returns the number of steps.
// Buffers must hold at least m + n entries.
//
// Direction byte: 2 bits per table, value 0/1/2 = predecessor T1/T2/T3,
// fields at bit 0 (T1), 2 (T2), 4 (T3) — core.py packing.
int64_t tsa_walk(const uint8_t* dirs, int64_t stride_d, int64_t stride_j,
                 int64_t m, int64_t n, int t0, int layout,
                 int32_t* out_t, int64_t* out_pi, int64_t* out_pj) {
    int64_t i = m, j = n;
    int t = t0;
    int64_t k = 0;
    while (i > 0 && j > 0) {
        int64_t row = (layout == 1) ? (i + j) : i;
        uint8_t byte = dirs[row * stride_d + j * stride_j];
        int shift = (t == 1) ? 0 : (t == 2) ? 2 : 4;
        int tn = ((byte >> shift) & 0x3) + 1;
        int64_t pi, pj;
        if (t == 1) {
            pi = i - 1; pj = j - 1; i--; j--;
        } else if (t == 2) {
            pi = i; pj = j - 1; j--;
        } else {
            pi = i - 1; pj = j; i--;
        }
        out_t[k] = tn;
        out_pi[k] = pi;
        out_pj[k] = pj;
        k++;
        t = tn;
    }
    return k;
}

// Render the two aligned text rows directly from a walked chain
// (the reference's print_seq, main_alignment.cpp:32-55).
//
//   a, b:   0-indexed sequences (lengths m, n)
//   tt/ii/jj: chain arrays in start -> end order (1-indexed points)
//   len:    chain length
// Writes len bytes into row_a and row_b.
void tsa_render(const uint8_t* a, const uint8_t* b,
                const int32_t* tt, const int64_t* ii, const int64_t* jj,
                int64_t len, uint8_t* row_a, uint8_t* row_b) {
    for (int64_t k = 0; k < len; k++) {
        int t = tt[k];
        row_a[k] = (t == 1 || t == 3) ? a[ii[k] - 1] : '-';
        row_b[k] = (t == 1 || t == 2) ? b[jj[k] - 1] : '-';
    }
}

// First pass over a FASTA buffer: count records and total sequence bytes.
// Returns 0 on success.
int tsa_fasta_scan(const uint8_t* buf, int64_t size,
                   int64_t* num_records, int64_t* total_seq_bytes) {
    int64_t nrec = 0, nbytes = 0;
    int64_t pos = 0;
    while (pos < size) {
        int64_t eol = pos;
        while (eol < size && buf[eol] != '\n') eol++;
        if (eol > pos) {
            if (buf[pos] == '>') {
                nrec++;
            } else {
                int64_t len = eol - pos;
                if (buf[eol - 1] == '\r') len--;
                nbytes += len;
            }
        }
        pos = eol + 1;
    }
    *num_records = nrec;
    *total_seq_bytes = nbytes;
    return 0;
}

// Second pass: concatenate sequence bytes and record per-record offsets.
// seq_out must hold total_seq_bytes; offsets must hold num_records + 1
// (offsets[k]..offsets[k+1] is record k); name_spans holds 2 entries per
// record (byte offset and length of the header line, '>' included).
int tsa_fasta_parse(const uint8_t* buf, int64_t size,
                    uint8_t* seq_out, int64_t* offsets,
                    int64_t* name_spans) {
    int64_t rec = -1, out = 0, pos = 0;
    while (pos < size) {
        int64_t eol = pos;
        while (eol < size && buf[eol] != '\n') eol++;
        if (eol > pos) {
            int64_t len = eol - pos;
            if (buf[eol - 1] == '\r') len--;
            if (buf[pos] == '>') {
                rec++;
                offsets[rec] = out;
                name_spans[2 * rec] = pos;
                name_spans[2 * rec + 1] = len;
            } else if (rec >= 0) {
                std::memcpy(seq_out + out, buf + pos, len);
                out += len;
            }
        }
        pos = eol + 1;
    }
    offsets[rec + 1] = out;
    return 0;
}

// Batched traceback: walk every pair of a bucket concurrently and emit
// finished chains (start -> end order, reference point semantics:
// t==1 stores (i, j); t==2 stores (0, j); t==3 stores (i, 0) — quirk B2).
//
//   dirs:      shared direction array for the bucket; cell (pair r,
//              diag/row d, column j) lives at
//              dirs[r*stride_r + d*stride_d + j*stride_j]
//              (covers both the (B, m+n+1, n+1) wavefront layout and the
//              (m+n+1, B, n+1) Pallas layout via strides)
//   ms/ns/t0s: per-pair end cell and end table
//   layout:    0 = rect, 1 = skew
//   mode:      0 = parity (stop at the matrix edge, drop the first
//              point — reference B1); 1 = full (emit forced edge runs
//              to (0,0), drop the (0,0) sentinel)
//   cap:       per-pair output slot capacity (>= m + n + 2)
//
// Chain k of pair r is written at out_*[r*cap + k]; out_len[r] holds the
// chain length. Walks are independent -> striped across hardware threads.
static void walk_one_pair(
        const uint8_t* dirs, int64_t stride_r, int64_t stride_d,
        int64_t stride_j, int64_t m, int64_t n, int t0, int layout,
        int mode, int64_t cap, int32_t* out_t, int64_t* out_i,
        int64_t* out_j, int64_t* out_len, int64_t r) {
    const uint8_t* base = dirs + r * stride_r;
    // rev buffers hold end -> start; emit reversed with first dropped
    std::vector<int32_t> rt;
    std::vector<int64_t> ri, rj;
    rt.reserve(cap); ri.reserve(cap); rj.reserve(cap);
    auto push = [&](int64_t i, int64_t j, int t) {
        rt.push_back(t);
        ri.push_back(t == 2 ? 0 : i);
        rj.push_back(t == 3 ? 0 : j);
    };
    int64_t i = m, j = n;
    int t = t0;
    push(i, j, t);
    while (i > 0 && j > 0) {
        int64_t row = (layout == 1) ? (i + j) : i;
        uint8_t byte = base[row * stride_d + j * stride_j];
        int shift = (t == 1) ? 0 : (t == 2) ? 2 : 4;
        int tn = ((byte >> shift) & 0x3) + 1;
        int64_t pi, pj;
        if (t == 1)      { pi = i - 1; pj = j - 1; i--; j--; }
        else if (t == 2) { pi = i;     pj = j - 1; j--; }
        else             { pi = i - 1; pj = j;     i--; }
        push(pi, pj, tn);
        t = tn;
    }
    if (mode == 1) {
        if (i == 0) {
            while (j > 0) { push(0, j - 1, 2); j--; }
        } else {
            while (i > 0) { push(i - 1, 0, 3); i--; }
        }
    }
    // reversed(rev)[1:]: drop the deepest point (rev's last entry, B1 /
    // the (0,0) sentinel) and emit the rest start -> end
    int64_t len = (int64_t)rt.size() - 1;
    if (len < 0) len = 0;
    for (int64_t k = 0; k < len; k++) {
        int64_t src = len - 1 - k;  // rev[len-1] .. rev[0]
        out_t[r * cap + k] = rt[src];
        out_i[r * cap + k] = ri[src];
        out_j[r * cap + k] = rj[src];
    }
    out_len[r] = len;
}

// Replay the run-length walk entries the fused device path emits
// (ops/device_walk.py _walk_core_rle: uint16 entry = op | runlen << 2;
// a round is runlen rec-1 steps then one rec-op step; op == 0 ends the
// stream). Reproduces ops/device_walk.py replay_ops exactly: quirk-B2
// zeros, global offsets, parity (B1: stop at the edge, drop the
// deepest point) or full mode (forced edge runs to the corner).
// Returns -1 in out_len[r] if pair r's stream ends before an edge
// (corrupt entries) — the Python wrapper raises.
static void replay_one(const uint16_t* ent, int64_t Rn, int64_t la,
                       int64_t lb, int t0, int64_t id_a, int64_t id_b,
                       int mode, int64_t cap, int32_t* out_t,
                       int64_t* out_i, int64_t* out_j, int64_t* out_len,
                       int64_t r) {
    std::vector<int32_t> rt;
    std::vector<int64_t> ri, rj;
    rt.reserve(cap); ri.reserve(cap); rj.reserve(cap);
    auto push = [&](int64_t i, int64_t j, int t) {
        rt.push_back(t);
        ri.push_back(t == 2 ? 0 : i + id_a);
        rj.push_back(t == 3 ? 0 : j + id_b);
    };
    int64_t i = la, j = lb;
    int t = t0;
    int64_t e = 0;       // entry cursor
    int64_t run = 0;     // remaining rec-1 steps of the current entry
    int pend = 0;        // the entry's final op (valid when run >= 0)
    bool have = false;
    while (i > 0 && j > 0) {
        push(i, j, t);
        if (!have) {
            if (e >= Rn) { out_len[r] = -1; return; }
            uint16_t b = ent[e++];
            pend = b & 3;
            run = b >> 2;
            if (pend == 0) { out_len[r] = -1; return; }
            have = true;
        }
        int tn;
        if (run > 0) { tn = 1; run--; }
        else         { tn = pend; have = false; }
        // move by the CURRENT table, continue in tn
        if (t == 1)      { i--; j--; }
        else if (t == 2) { j--; }
        else             { i--; }
        t = tn;
    }
    push(i, j, t);  // the edge-entry point (dropped below / kept by runs)
    if (mode == 1) {
        if (i == 0) {
            while (j > 0) { push(0, j - 1, 2); j--; }
        } else {
            while (i > 0) { push(i - 1, 0, 3); i--; }
        }
    }
    int64_t len = (int64_t)rt.size() - 1;
    if (len < 0) len = 0;
    for (int64_t k = 0; k < len; k++) {
        int64_t src = len - 1 - k;
        out_t[r * cap + k] = rt[src];
        out_i[r * cap + k] = ri[src];
        out_j[r * cap + k] = rj[src];
    }
    out_len[r] = len;
}

int tsa_replay_rle_batch(const uint16_t* entries, int64_t Rn,
                         const int64_t* la, const int64_t* lb,
                         const int32_t* t0s, const int64_t* id_a,
                         const int64_t* id_b, int64_t B, int mode,
                         int64_t cap, int32_t* out_t, int64_t* out_i,
                         int64_t* out_j, int64_t* out_len) {
    int64_t nthreads = std::min<int64_t>(
        B, std::max(1u, std::thread::hardware_concurrency()));
    auto worker = [&](int64_t w) {
        for (int64_t r = w; r < B; r += nthreads) {
            replay_one(entries + r * Rn, Rn, la[r], lb[r], t0s[r],
                       id_a ? id_a[r] : 0, id_b ? id_b[r] : 0, mode,
                       cap, out_t, out_i, out_j, out_len, r);
        }
    };
    if (nthreads <= 1) {
        worker(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t w = 0; w < nthreads; w++) pool.emplace_back(worker, w);
        for (auto& th : pool) th.join();
    }
    return 0;
}

int tsa_walk_batch(const uint8_t* dirs, int64_t stride_r, int64_t stride_d,
                   int64_t stride_j, const int64_t* ms, const int64_t* ns,
                   const int32_t* t0s, int64_t B, int layout, int mode,
                   int64_t cap, int32_t* out_t, int64_t* out_i,
                   int64_t* out_j, int64_t* out_len) {
    int64_t nthreads = std::min<int64_t>(
        B, std::max(1u, std::thread::hardware_concurrency()));
    auto worker = [&](int64_t w) {
        for (int64_t r = w; r < B; r += nthreads) {
            walk_one_pair(dirs, stride_r, stride_d, stride_j, ms[r],
                          ns[r], t0s[r], layout, mode, cap, out_t, out_i,
                          out_j, out_len, r);
        }
    };
    if (nthreads <= 1) {
        worker(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t w = 0; w < nthreads; w++) pool.emplace_back(worker, w);
        for (auto& th : pool) th.join();
    }
    return 0;
}

}  // extern "C"
