// plankit: native chunk-plan algebra for dask_array_tpu.
//
// The role of the reference's Rust layer expanders
// (/root/reference/crates/dask-array-python — per-expression task
// expansion): in this runtime the execution plan is one XLA program, so the
// native-worthy hot loops are the *planning* primitives that scale with the
// number of blocks along an axis: slice->blockdim mapping, rechunk
// old->new intersection expansion, boundary-union refinement, and the
// token hash.  Python fallbacks exist for every entry point; version skew
// between this library and the Python wrapper fails loudly
// (PLANKIT_GENERATION handshake, mirroring the reference's
// NATIVE_BUILD_GENERATION discipline).
//
// Build: g++ -O3 -shared -fPIC plankit.cpp -o libplankit.so

#include <cstdint>
#include <cstddef>

extern "C" {

// bumped on every ABI/semantic change; checked by the Python wrapper
int64_t plankit_generation() { return 5; }

static inline int64_t ceil_div(int64_t a, int64_t b) {
    return (a + b - 1) / b;  // b > 0, a >= 0
}

// --- sliced blockdim -------------------------------------------------------
// Given per-block sizes chunks[0..n) along one axis and a normalized slice
// (start, stop, step) with step > 0 over the axis, write the per-block
// selected counts into counts[0..n).  Returns the number of blocks with a
// nonzero count.  (Negative steps are handled by the Python wrapper via the
// reversed-axis transform.)
int64_t sliced_blockdim_pos(
    const int64_t* chunks, int64_t n,
    int64_t start, int64_t stop, int64_t step,
    int64_t* counts)
{
    int64_t nonzero = 0;
    int64_t lo = 0;
    for (int64_t b = 0; b < n; ++b) {
        int64_t hi = lo + chunks[b];
        int64_t lo_eff = lo > start ? lo : start;
        int64_t hi_eff = hi < stop ? hi : stop;
        int64_t count = 0;
        if (hi_eff > lo_eff) {
            // first selected index >= lo_eff on the progression
            int64_t k0 = ceil_div(lo_eff - start, step);
            int64_t first = start + k0 * step;
            if (first < hi_eff) {
                count = (hi_eff - first - 1) / step + 1;
            }
        }
        counts[b] = count;
        if (count) ++nonzero;
        lo = hi;
    }
    return nonzero;
}

// --- rechunk old->new intersection ------------------------------------------
// For one axis: old chunks (n_old) -> new chunks (n_new).  Emits, for every
// new block in order, its decomposition into pieces of old blocks:
//   piece_old[k] = old block index, piece_lo[k]/piece_hi[k] = slice within it
// offsets[j] = first piece index of new block j; offsets[n_new] = n_pieces.
// Returns total piece count, or -1 if max_pieces is too small.
int64_t old_to_new_axis(
    const int64_t* oldc, int64_t n_old,
    const int64_t* newc, int64_t n_new,
    int64_t* piece_old, int64_t* piece_lo, int64_t* piece_hi,
    int64_t* offsets, int64_t max_pieces)
{
    int64_t k = 0;
    int64_t pos = 0;          // global start of current new block
    int64_t ob = 0;           // current old block index
    int64_t ob_start = 0;     // global start of old block ob
    for (int64_t j = 0; j < n_new; ++j) {
        offsets[j] = k;
        int64_t lo = pos;
        int64_t hi = pos + newc[j];
        // advance past old blocks entirely before lo
        while (ob < n_old && ob_start + oldc[ob] <= lo) {
            ob_start += oldc[ob];
            ++ob;
        }
        int64_t b = ob;
        int64_t b_start = ob_start;
        while (b < n_old && b_start < hi) {
            int64_t s = (lo > b_start ? lo : b_start) - b_start;
            int64_t b_end = b_start + oldc[b];
            int64_t e = (hi < b_end ? hi : b_end) - b_start;
            if (e > s) {
                if (k >= max_pieces) return -1;
                piece_old[k] = b;
                piece_lo[k] = s;
                piece_hi[k] = e;
                ++k;
            }
            b_start = b_end;
            ++b;
        }
        pos = hi;
    }
    offsets[n_new] = k;
    return k;
}

// --- boundary-union refinement -----------------------------------------------
// Common refinement of two blockdims with equal totals: merge-walk of both
// boundary sequences.  Writes the refined chunks to out; returns length,
// or -1 if max_out is too small.
int64_t refine_axis(
    const int64_t* a, int64_t na,
    const int64_t* b, int64_t nb,
    int64_t* out, int64_t max_out)
{
    int64_t ia = 0, ib = 0;
    int64_t pa = 0, pb = 0;   // next boundaries
    int64_t prev = 0;
    int64_t k = 0;
    int64_t enda = 0, endb = 0;
    for (int64_t i = 0; i < na; ++i) enda += a[i];
    for (int64_t i = 0; i < nb; ++i) endb += b[i];
    if (enda != endb) return -2;
    pa = (na > 0) ? a[0] : 0;
    pb = (nb > 0) ? b[0] : 0;
    while (ia < na || ib < nb) {
        int64_t nxt;
        if (ia < na && (ib >= nb || pa <= pb)) {
            nxt = pa;
        } else {
            nxt = pb;
        }
        if (ia < na && pa == nxt) { ++ia; if (ia < na) pa += a[ia]; }
        if (ib < nb && pb == nxt) { ++ib; if (ib < nb) pb += b[ib]; }
        if (nxt > prev) {
            if (k >= max_out) return -1;
            out[k++] = nxt - prev;
            prev = nxt;
        }
    }
    return k;
}

// --- moved fraction (rechunk cost model) ----------------------------------------
// Min-model fraction of one axis's elements a src->dst relayout moves:
// each dst chunk is assembled where its largest single-src piece lives.
// Mirrors _rechunk._axis_moved_fraction (and the reference's moved_fraction,
// _expr.py:675); hot in explain/transfer estimates and the unify audition.
// Returns moved fraction in [0,1]; -1.0 on total mismatch.
double moved_fraction_axis(
    const int64_t* src, int64_t n_src,
    const int64_t* dst, int64_t n_dst)
{
    int64_t total = 0;
    for (int64_t i = 0; i < n_src; ++i) total += src[i];
    int64_t total_d = 0;
    for (int64_t j = 0; j < n_dst; ++j) total_d += dst[j];
    if (total == 0) return 0.0;
    if (total != total_d) return -1.0;
    if (n_src == n_dst) {
        bool same = true;
        for (int64_t i = 0; i < n_src; ++i) if (src[i] != dst[i]) { same = false; break; }
        if (same) return 0.0;
    }
    double moved = 0.0;
    int64_t i = 0;
    int64_t src_lo = 0;
    int64_t dst_lo = 0;
    for (int64_t j = 0; j < n_dst; ++j) {
        int64_t dst_hi = dst_lo + dst[j];
        int64_t best = 0;
        for (;;) {
            int64_t src_hi = src_lo + src[i];
            int64_t lo = src_lo > dst_lo ? src_lo : dst_lo;
            int64_t hi = src_hi < dst_hi ? src_hi : dst_hi;
            int64_t overlap = hi - lo;
            if (overlap > best) best = overlap;
            if (src_hi <= dst_hi && i + 1 < n_src) {
                ++i;
                src_lo = src_hi;
            } else {
                break;
            }
        }
        moved += (double)(dst[j] - best);
        dst_lo = dst_hi;
    }
    return moved / (double)total;
}

// --- boundary intersection (coarsest common coarsening) ---------------------------
// Chunks whose boundaries appear in BOTH inputs; equal totals required.
// Writes coarse chunks to out; returns length, -1 if max_out too small,
// -2 on total mismatch.
int64_t coarse_axis(
    const int64_t* a, int64_t na,
    const int64_t* b, int64_t nb,
    int64_t* out, int64_t max_out)
{
    int64_t enda = 0, endb = 0;
    for (int64_t i = 0; i < na; ++i) enda += a[i];
    for (int64_t i = 0; i < nb; ++i) endb += b[i];
    if (enda != endb) return -2;
    int64_t ia = 0, ib = 0;
    int64_t pa = 0, pb = 0;
    int64_t prev = 0, k = 0;
    while (ia < na && ib < nb) {
        int64_t ba = pa + a[ia];
        int64_t bb = pb + b[ib];
        if (ba == bb) {
            if (k >= max_out) return -1;
            out[k++] = ba - prev;
            prev = ba;
            pa = ba; ++ia;
            pb = bb; ++ib;
        } else if (ba < bb) {
            pa = ba; ++ia;
        } else {
            pb = bb; ++ib;
        }
    }
    return k;
}

// --- rechunk stage degree ------------------------------------------------------
// Max number of old blocks feeding any single new block along one axis
// (the planner's fan-in bound; reference _rechunk.py:395 _bound_degree).
int64_t stage_degree_axis(
    const int64_t* oldc, int64_t n_old,
    const int64_t* newc, int64_t n_new)
{
    int64_t deg = 1;
    int64_t pos = 0;
    int64_t ob = 0, ob_start = 0;
    for (int64_t j = 0; j < n_new; ++j) {
        int64_t lo = pos;
        int64_t hi = pos + newc[j];
        while (ob < n_old && ob_start + oldc[ob] <= lo) {
            ob_start += oldc[ob];
            ++ob;
        }
        int64_t b = ob, b_start = ob_start, count = 0;
        while (b < n_old && b_start < hi) {
            ++count;
            b_start += oldc[b];
            ++b;
        }
        if (count > deg) deg = count;
        pos = hi;
    }
    return deg;
}

// --- fingerprint hash -----------------------------------------------------------
// FNV-1a 64-bit over a byte buffer: a fast non-cryptographic fingerprint for
// diagnostics/dedup probes.  Expression tokens stay on blake2b (collision
// resistance matters for content addressing).
uint64_t hash_bytes(const unsigned char* data, int64_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t i = 0; i < n; ++i) {
        h ^= (uint64_t)data[i];
        h *= 1099511628211ULL;
    }
    return h;
}

// --- block-coordinate expansion --------------------------------------------------
// Row-major enumeration helper: for a grid with nblocks[d] blocks per dim
// (ndim dims), fill coords[i*ndim + d] for i in [0, total).  Lets the
// executor's per-block loops consume a flat int64 table instead of
// np.ndindex.  Returns total block count, or -1 if max_total too small.
int64_t expand_grid(
    const int64_t* nblocks, int64_t ndim,
    int64_t* coords, int64_t max_total)
{
    int64_t total = 1;
    for (int64_t d = 0; d < ndim; ++d) total *= nblocks[d];
    if (total > max_total) return -1;
    for (int64_t i = 0; i < total; ++i) {
        int64_t rem = i;
        for (int64_t d = ndim - 1; d >= 0; --d) {
            coords[i * ndim + d] = rem % nblocks[d];
            rem /= nblocks[d];
        }
    }
    return total;
}

// ===========================================================================
// plan records: versioned binary snapshot of a lowered expression plan.
//
// The XLA-native analog of the reference's Rust records grammar
// (/root/reference/crates/dask-array-python/src/common.rs:436-459,
// RECORDS_PROTOCOL_VERSION): where the reference ships per-layer task
// records to its scheduler, this runtime has no scheduler — the plan
// record is the program's structural identity (the executor's compiled-
// executable cache key) and its diagnostics snapshot.  Same discipline:
// the blob self-describes its grammar version in the leading byte; a
// version the decoder does not know is REJECTED (callers fall back to the
// Python tokenize path) rather than misparsed.
//
// Binary grammar (little-endian):
//   PLAN  := u8 version, u32 n_strings, STR*n, u32 n_nodes, NODE*n
//   NODE  := u32 type_idx, u8 ndim, AXIS*ndim, u16 n_ops, OP*n
//   AXIS  := u32 nblk, i64*nblk          (chunk sizes; -1 encodes unknown)
//   OP    := u8 tag,
//            0 Expr{u32 node_id}         (node_id < this node's id)
//            1 Int{i64}
//            2 Float{f64 bits}
//            3 Str{u32 str_idx}
//            4 Bool{u8}
//            5 None{}
//            6 Slice{u8 mask, i64 * popcount(mask&7)}   (start/stop/step)
//            7 Tuple{u16 n, OP*n}        (nested; depth-capped)
//            8 Dtype{u32 str_idx}
//            9 Token{u32 str_idx}        (opaque operand, pre-tokenized)
//           10 Leaf{u32 ordinal}         (buffer placeholder, positional)
//           11 List{u16 n, OP*n}         (like Tuple; distinct so a list
//                                          operand never aliases a tuple)
//   STR   := u32 len, utf8
//
// The encoder consumes a flat int64 tape (built by Python, see
// dask_array_tpu/_planrec.py) mirroring the OP structure one int per
// field; all indices/counts/ids are bounds-checked so a malformed tape
// declines (negative return) instead of emitting a corrupt blob.
// ===========================================================================

const unsigned char PLAN_GRAMMAR_VERSION = 1;

namespace planrec {

struct Writer {
    unsigned char* out;
    int64_t cap;
    int64_t pos;
    bool overflow;

    void u8(uint64_t v) {
        if (pos + 1 > cap) { overflow = true; return; }
        out[pos++] = (unsigned char)(v & 0xff);
    }
    void u16(uint64_t v) {
        if (pos + 2 > cap) { overflow = true; return; }
        out[pos++] = (unsigned char)(v & 0xff);
        out[pos++] = (unsigned char)((v >> 8) & 0xff);
    }
    void u32(uint64_t v) {
        if (pos + 4 > cap) { overflow = true; return; }
        for (int i = 0; i < 4; ++i) out[pos++] = (unsigned char)((v >> (8 * i)) & 0xff);
    }
    void i64v(int64_t v) {
        if (pos + 8 > cap) { overflow = true; return; }
        uint64_t u = (uint64_t)v;
        for (int i = 0; i < 8; ++i) out[pos++] = (unsigned char)((u >> (8 * i)) & 0xff);
    }
    void bytes(const unsigned char* p, int64_t n) {
        if (pos + n > cap) { overflow = true; return; }
        for (int64_t i = 0; i < n; ++i) out[pos++] = p[i];
    }
};

struct Reader {
    const unsigned char* in;
    int64_t n;
    int64_t pos;
    bool fail;

    bool need(int64_t k) {
        if (pos + k > n) { fail = true; return false; }
        return true;
    }
    uint64_t u8() {
        if (!need(1)) return 0;
        return in[pos++];
    }
    uint64_t u16() {
        if (!need(2)) return 0;
        uint64_t v = in[pos] | ((uint64_t)in[pos + 1] << 8);
        pos += 2;
        return v;
    }
    uint64_t u32() {
        if (!need(4)) return 0;
        uint64_t v = 0;
        for (int i = 0; i < 4; ++i) v |= (uint64_t)in[pos + i] << (8 * i);
        pos += 4;
        return v;
    }
    int64_t i64v() {
        if (!need(8)) return 0;
        uint64_t v = 0;
        for (int i = 0; i < 8; ++i) v |= (uint64_t)in[pos + i] << (8 * i);
        pos += 8;
        return (int64_t)v;
    }
};

struct Tape {
    const int64_t* codes;
    int64_t n;
    int64_t pos;
    bool fail;

    int64_t next() {
        if (pos >= n) { fail = true; return 0; }
        return codes[pos++];
    }
};

const int MAX_OP_DEPTH = 32;

// encode one OP from the tape; returns false on malformed tape
static bool encode_op(Tape& t, Writer& w, int64_t node_id, int64_t n_strings, int depth) {
    if (depth > MAX_OP_DEPTH) return false;
    int64_t tag = t.next();
    if (t.fail || tag < 0 || tag > 11) return false;
    w.u8((uint64_t)tag);
    switch (tag) {
        case 0: {  // Expr
            int64_t id = t.next();
            if (t.fail || id < 0 || id >= node_id) return false;
            w.u32((uint64_t)id);
            break;
        }
        case 1: w.i64v(t.next()); break;            // Int
        case 2: w.i64v(t.next()); break;            // Float (f64 bits)
        case 3: case 8: case 9: {                   // Str / Dtype / Token
            int64_t idx = t.next();
            if (t.fail || idx < 0 || idx >= n_strings) return false;
            w.u32((uint64_t)idx);
            break;
        }
        case 4: {                                   // Bool
            int64_t v = t.next();
            if (t.fail || (v != 0 && v != 1)) return false;
            w.u8((uint64_t)v);
            break;
        }
        case 5: break;                              // None
        case 6: {                                   // Slice
            int64_t mask = t.next();
            if (t.fail || mask < 0 || mask > 7) return false;
            w.u8((uint64_t)mask);
            for (int b = 0; b < 3; ++b)
                if (mask & (1 << b)) w.i64v(t.next());
            break;
        }
        case 7: case 11: {                          // Tuple / List
            int64_t cnt = t.next();
            if (t.fail || cnt < 0 || cnt > 65535) return false;
            w.u16((uint64_t)cnt);
            for (int64_t i = 0; i < cnt; ++i)
                if (!encode_op(t, w, node_id, n_strings, depth + 1)) return false;
            break;
        }
        case 10: {                                  // Leaf
            int64_t ord = t.next();
            if (t.fail || ord < 0 || ord > 0xffffffffLL) return false;
            w.u32((uint64_t)ord);
            break;
        }
    }
    return !t.fail && !w.overflow;
}

// decode (skip) one OP, validating; returns false on malformed blob
static bool decode_op(Reader& r, int64_t n_nodes_so_far, int64_t n_strings,
                      int64_t* op_count, int depth) {
    if (depth > MAX_OP_DEPTH) return false;
    uint64_t tag = r.u8();
    if (r.fail || tag > 11) return false;
    ++*op_count;
    switch (tag) {
        case 0: {
            uint64_t id = r.u32();
            if (r.fail || (int64_t)id >= n_nodes_so_far) return false;
            break;
        }
        case 1: case 2: r.i64v(); break;
        case 3: case 8: case 9: {
            uint64_t idx = r.u32();
            if (r.fail || (int64_t)idx >= n_strings) return false;
            break;
        }
        case 4: {
            uint64_t v = r.u8();
            if (r.fail || v > 1) return false;
            break;
        }
        case 5: break;
        case 6: {
            uint64_t mask = r.u8();
            if (r.fail || mask > 7) return false;
            for (int b = 0; b < 3; ++b)
                if (mask & (1u << b)) r.i64v();
            break;
        }
        case 7: case 11: {
            uint64_t cnt = r.u16();
            if (r.fail) return false;
            for (uint64_t i = 0; i < cnt; ++i)
                if (!decode_op(r, n_nodes_so_far, n_strings, op_count, depth + 1))
                    return false;
            break;
        }
        case 10: r.u32(); break;
    }
    return !r.fail;
}

}  // namespace planrec

// Encode a plan tape into the binary grammar.  Returns the encoded byte
// length, -1 if cap is too small, -2 on a malformed tape.
int64_t plan_encode(
    const int64_t* codes, int64_t n_codes,
    const unsigned char* strblob, const int64_t* stroffs, int64_t n_strings,
    unsigned char* out, int64_t cap)
{
    using namespace planrec;
    if (n_strings < 0 || n_strings > 0xffffffffLL) return -2;
    Writer w{out, cap, 0, false};
    Tape t{codes, n_codes, 0, false};

    w.u8(PLAN_GRAMMAR_VERSION);
    w.u32((uint64_t)n_strings);
    for (int64_t s = 0; s < n_strings; ++s) {
        int64_t lo = stroffs[s], hi = stroffs[s + 1];
        if (lo < 0 || hi < lo) return -2;
        w.u32((uint64_t)(hi - lo));
        w.bytes(strblob + lo, hi - lo);
    }

    int64_t n_nodes = t.next();
    if (t.fail || n_nodes < 0 || n_nodes > 0xffffffffLL) return -2;
    w.u32((uint64_t)n_nodes);
    for (int64_t node = 0; node < n_nodes; ++node) {
        int64_t type_idx = t.next();
        if (t.fail || type_idx < 0 || type_idx >= n_strings) return -2;
        w.u32((uint64_t)type_idx);
        int64_t ndim = t.next();
        if (t.fail || ndim < 0 || ndim > 255) return -2;
        w.u8((uint64_t)ndim);
        for (int64_t d = 0; d < ndim; ++d) {
            int64_t nblk = t.next();
            if (t.fail || nblk < 0 || nblk > 0xffffffffLL) return -2;
            w.u32((uint64_t)nblk);
            for (int64_t b = 0; b < nblk; ++b) w.i64v(t.next());
        }
        int64_t n_ops = t.next();
        if (t.fail || n_ops < 0 || n_ops > 65535) return -2;
        w.u16((uint64_t)n_ops);
        for (int64_t i = 0; i < n_ops; ++i)
            if (!encode_op(t, w, node, n_strings, 0))
                return w.overflow ? -1 : -2;
    }
    if (t.fail || t.pos != t.n) return -2;  // trailing garbage on the tape
    if (w.overflow) return -1;
    return w.pos;
}

// Validate an encoded plan blob (full independent re-parse).  On success
// returns n_nodes and fills info[0..3] = version, n_strings, n_nodes,
// total_op_count.  Returns -1 on a malformed blob, -2 on an unknown
// grammar version (the caller must fall back, never guess).
int64_t plan_validate(const unsigned char* blob, int64_t n, int64_t* info)
{
    using namespace planrec;
    Reader r{blob, n, 0, false};
    uint64_t version = r.u8();
    if (r.fail) return -1;
    if (version != PLAN_GRAMMAR_VERSION) return -2;
    uint64_t n_strings = r.u32();
    if (r.fail) return -1;
    for (uint64_t s = 0; s < n_strings; ++s) {
        uint64_t len = r.u32();
        if (r.fail || !r.need((int64_t)len)) return -1;
        r.pos += (int64_t)len;
    }
    uint64_t n_nodes = r.u32();
    if (r.fail) return -1;
    int64_t total_ops = 0;
    for (uint64_t node = 0; node < n_nodes; ++node) {
        uint64_t type_idx = r.u32();
        if (r.fail || type_idx >= n_strings) return -1;
        uint64_t ndim = r.u8();
        if (r.fail) return -1;
        for (uint64_t d = 0; d < ndim; ++d) {
            uint64_t nblk = r.u32();
            if (r.fail || !r.need((int64_t)nblk * 8)) return -1;
            r.pos += (int64_t)nblk * 8;
        }
        uint64_t n_ops = r.u16();
        if (r.fail) return -1;
        for (uint64_t i = 0; i < n_ops; ++i)
            if (!decode_op(r, (int64_t)node, (int64_t)n_strings, &total_ops, 0))
                return -1;
    }
    if (r.fail || r.pos != n) return -1;  // trailing bytes are malformed
    if (info) {
        info[0] = (int64_t)version;
        info[1] = (int64_t)n_strings;
        info[2] = (int64_t)n_nodes;
        info[3] = total_ops;
    }
    return (int64_t)n_nodes;
}

// 128-bit FNV-1a over a byte buffer (fast structural fingerprint; the
// executor's cache key hashes the blob with blake2b on the Python side —
// this is the cheap in-process dedup/diagnostics variant).
void fingerprint128(const unsigned char* data, int64_t n, uint64_t* out2)
{
    unsigned __int128 h = ((unsigned __int128)0x6c62272e07bb0142ULL << 64)
                          | 0x62b821756295c58dULL;           // FNV-128 offset
    const unsigned __int128 prime = ((unsigned __int128)0x1000000ULL << 64)
                                    | 0x000000000000013bULL;  // FNV-128 prime
    for (int64_t i = 0; i < n; ++i) {
        h ^= data[i];
        h *= prime;
    }
    out2[0] = (uint64_t)(h >> 64);
    out2[1] = (uint64_t)h;
}

}  // extern "C"
