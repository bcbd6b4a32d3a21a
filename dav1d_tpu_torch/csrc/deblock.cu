// AV1 deblocking filter over every plane of a frame in one launch, both
// directions (vertical edges, then horizontal) fused in shared memory.
//
// Replaces dav1d_tpu/ops/lf_pallas.py `_pass_fn` (the Pallas TPU kernel
// reached through `plane_fn`, one directional pass per call), with the
// math of dav1d_tpu/ops/lf.py `filter_values` (reference
// src/loopfilter_tmpl.c:37-162) term by term.
//
// Map layout: per plane and direction, cls (int8) and L (uint8) are
// (h4, w4) in plane orientation: vertical entry (y, x) is the edge at
// column 4x for rows 4y..4y+3, horizontal entry (y, x) the edge at row
// 4y for columns 4x..4x+3. E = lut_e[L] << (bd-8), I = lut_i[L] <<
// (bd-8), H = (L >> 4) << (bd-8).
//
// Design. Each 256-thread block owns a TR x TC output tile of one plane
// (the plane is block-uniform and picks the luma or chroma code). AV1
// bounds the filter width by the transform size on both sides of an
// edge, so within one pass no edge reads what another writes, and a
// pixel's vertical-pass value depends only on its own row. So:
//   (1) the raw tile plus a halo of HALO pixels on every side goes to
//       shared memory (A, int32) by 16-byte cp.async, zeros outside the
//       plane (the plain version's zero padding), and the maps of the
//       edges the tile evaluates beside it;
//   (2) each vertical edge that can write a tile column is evaluated
//       once per staged row: the active edges (cls >= 0) are listed
//       first, so that warps decide only those, each storing its write
//       mask (none / wd4 / wd6-8 / wd16) in shared memory and listing
//       the edges that write; the rows' tile columns are copied to B
//       (int16: pixels have at most 12 bits, and the smaller block fits
//       four to a SM). Barriers;
//   (3) every listed edge recomputes its values from A and writes the
//       pixels it owns into B, where random maps can make luma edges
//       overlap, the edge nearer the plane origin owns the pixel (it is
//       the one the plain version writes last), read from the masks of
//       the two edges before it. Barrier;
//   (4) the same over the horizontal edges, reading B (the vertical
//       result for the halo rows too, exact since a row's vertical pass
//       depends on that row alone) and writing the tile into A;
//   (5) the tile goes to a fresh output plane with coalesced 16-byte
//       stores. Every pixel of every plane is written, so the wrapper
//       needs no copy of the input.
// The halo covers every edge whose writes land in the tile and those
// edges' taps: a pixel at row r is written by horizontal edges at rows
// 4y in [r-5, r+6] (luma offsets -6..5), which read rows 4y-7 .. 4y+6,
// so 11 rows on either side suffice (tests/test_torch_lf.py finds 11
// exact and 10 not); HALO is 12, the next multiple of 4, which keeps
// edges and 16-byte chunks aligned.
//
// Bound: memory. One read and one write of each int32 pixel per frame
// plus the four byte maps: ~27 MB for a 1080p 4:2:0 frame, ~8 us at
// 3.35 TB/s. The halo is re-read by neighbouring tiles (mostly from L2),
// and halo rows run the vertical decision once more per tile. On the
// H100 the kernel is held instead by each tile's decisions and
// shared-memory traffic: a tile alone takes ~8 us, and each further
// tile on a SM ~2.6 us (tools/torch_deblock_scaling.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 64, TC = 64, HALO = 12;
constexpr int AR = TR + 2 * HALO, AC = TC + 2 * HALO;
// edges per line that can write into the tile: edges at 4k - 4 (k = 0)
// through TC + 4 relative to the tile's first column (and rows)
constexpr int NE = TC / 4 + 3;
static_assert(TR == TC, "one edge count for both directions");
constexpr int THREADS = 256;
constexpr int MAX_PLANES = 3;
// shared memory: A (int32) | B (int16) | lut_e | lut_i | the byte masks
// of both directions | the staged byte maps (cls, L) of both directions |
// two edge lists (uint16) | four counters
constexpr int LIST = (AR - 2) * NE;
static_assert(LIST >= TC * NE && LIST < 65536, "edge lists");
constexpr int MAPS_BYTES = 2 * (AR / 4) * NE + 2 * NE * (TC / 4);
static_assert(MAPS_BYTES % 4 == 0 && (AR * NE + NE * TC) % 4 == 0,
              "list alignment");
constexpr int SMEM_BYTES = 4 * AR * AC + 2 * AR * TC + 4 * 128 + AR * NE +
                           NE * TC + MAPS_BYTES + 2 * 2 * LIST + 4 * 4;

struct Plane {
    const int32_t *src;
    int32_t *dst;
    const int8_t *vcls;
    const uint8_t *vL;
    const int8_t *hcls;
    const uint8_t *hL;
    int h4, w4, luma, tiles_x, first;
};

struct Args {
    Plane p[MAX_PLANES];
    int n;
    const int *lut_e, *lut_i;
    int bd;
};

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

__device__ __forceinline__ int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void cp_async16(int *sdst, const int32_t *gsrc) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gsrc));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

// p[i] = tap at offset -1-i, q[i] = tap at offset i (i = 0..6; chroma
// uses i < 3)
struct Taps {
    int p[7];
    int q[7];
};

// taps of the vertical edge at column 4k + 8 of a staged row (16-byte
// loads; luma reads columns 4k .. 4k+15, chroma 4k+4 .. 4k+11)
template <bool LUMA>
__device__ __forceinline__ Taps row_taps(const int *row, int k) {
    Taps t;
    const int4 *r4 = reinterpret_cast<const int4 *>(row) + k;
    const int4 b = r4[1], c = r4[2];
    t.p[0] = b.w, t.p[1] = b.z, t.p[2] = b.y, t.p[3] = b.x;
    t.q[0] = c.x, t.q[1] = c.y, t.q[2] = c.z, t.q[3] = c.w;
    if (LUMA) {
        const int4 a = r4[0], d = r4[3];
        t.p[4] = a.w, t.p[5] = a.z, t.p[6] = a.y;
        t.q[4] = d.x, t.q[5] = d.y, t.q[6] = d.z;
    } else {
#pragma unroll
        for (int i = 4; i < 7; i++) t.p[i] = t.q[i] = 0;
    }
    return t;
}

// taps of the horizontal edge at row 4k + 8 of a staged column
template <bool LUMA>
__device__ __forceinline__ Taps col_taps(const int16_t *col, int stride,
                                         int k) {
    Taps t;
    const int16_t *c = col + (4 * k + 8) * stride;
#pragma unroll
    for (int i = 0; i < 7; i++) {
        t.p[i] = (LUMA || i < 3) ? c[-(i + 1) * stride] : 0;
        t.q[i] = (LUMA || i < 3) ? c[i * stride] : 0;
    }
    return t;
}

// write mask code of an edge: 0 none, 1 the narrow filter (fm), 2 wd8
// (luma) / wd6 (chroma), 3 wd16
template <bool LUMA>
__device__ __forceinline__ int edge_code(const Taps &t, int cls, int E,
                                         int I, int F) {
    const int p0 = t.p[0], p1 = t.p[1], p2 = t.p[2];
    const int q0 = t.q[0], q1 = t.q[1], q2 = t.q[2];
    bool fm = iabs(p1 - p0) <= I && iabs(q1 - q0) <= I &&
              iabs(p0 - q0) * 2 + (iabs(p1 - q1) >> 1) <= E;
    const bool e6 = iabs(p2 - p1) <= I && iabs(q2 - q1) <= I;
    bool flat8in = iabs(p2 - p0) <= F && iabs(p1 - p0) <= F &&
                   iabs(q1 - q0) <= F && iabs(q2 - q0) <= F;
    if (LUMA) {
        const int p3 = t.p[3], q3 = t.q[3];
        const bool e8 = iabs(p3 - p2) <= I && iabs(q3 - q2) <= I;
        fm = fm && (cls < 1 || (e6 && e8));
        if (!fm) return 0;
        flat8in = flat8in && iabs(p3 - p0) <= F && iabs(q3 - q0) <= F;
        const bool flat8out =
            iabs(t.p[6] - p0) <= F && iabs(t.p[5] - p0) <= F &&
            iabs(t.p[4] - p0) <= F && iabs(t.q[4] - q0) <= F &&
            iabs(t.q[5] - q0) <= F && iabs(t.q[6] - q0) <= F;
        if (cls >= 2 && flat8out && flat8in) return 3;
        return cls >= 1 && flat8in ? 2 : 1;
    }
    fm = fm && (cls < 1 || e6);
    if (!fm) return 0;
    return cls >= 1 && flat8in ? 2 : 1;
}

// the offsets an edge of mask code `code` (> 0) writes: lo(code) ..
// hi(code)
template <bool LUMA>
__device__ __forceinline__ int lo_of(int code) {
    return LUMA && code == 3 ? -6 : (LUMA && code == 2 ? -3 : -2);
}

template <bool LUMA>
__device__ __forceinline__ int hi_of(int code) {
    return LUMA && code == 3 ? 5 : (LUMA && code == 2 ? 2 : 1);
}

// filtered values val[o + 6], o = -6..5, of an edge with mask code
// `code` (only the offsets it writes are set)
template <bool LUMA>
__device__ __forceinline__ void edge_vals(const Taps &t, int code, int H,
                                          int bd, int (&val)[12]) {
    const int bdm8 = bd - 8;
    const int px_max = (1 << bd) - 1;
    const int lim = 128 << bdm8;
    const int p0 = t.p[0], p1 = t.p[1], p2 = t.p[2], p3 = t.p[3];
    const int p4 = t.p[4], p5 = t.p[5], p6 = t.p[6];
    const int q0 = t.q[0], q1 = t.q[1], q2 = t.q[2], q3 = t.q[3];
    const int q4 = t.q[4], q5 = t.q[5], q6 = t.q[6];
    // narrow (wd4) filter
    const bool hev = iabs(p1 - p0) > H || iabs(q1 - q0) > H;
    const int fdiff = iclip(p1 - q1, -lim, lim - 1);
    const int f = hev ? iclip(3 * (q0 - p0) + fdiff, -lim, lim - 1)
                      : iclip(3 * (q0 - p0), -lim, lim - 1);
    const int f1 = min(f + 4, lim - 1) >> 3;
    const int f2 = min(f + 3, lim - 1) >> 3;
    const int f3 = (f1 + 1) >> 1;
    val[4] = hev ? p1 : iclip(p1 + f3, 0, px_max);
    val[5] = iclip(p0 + f2, 0, px_max);
    val[6] = iclip(q0 - f1, 0, px_max);
    val[7] = hev ? q1 : iclip(q1 - f3, 0, px_max);
    if (LUMA) {
        // wd16 / wd8 as running sums: each output differs from the one
        // before by four taps (the sums equal the filters' weighted sums)
        if (code == 3) {
            int s = p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8;
            val[0] = s >> 4;
            s += p3 + q1 - p6 * 2;
            val[1] = s >> 4;
            s += p2 + q2 - p6 - p5;
            val[2] = s >> 4;
            s += p1 + q3 - p6 - p4;
            val[3] = s >> 4;
            s += p0 + q4 - p6 - p3;
            val[4] = s >> 4;
            s += q0 + q5 - p6 - p2;
            val[5] = s >> 4;
            s += q1 + q6 - p6 - p1;
            val[6] = s >> 4;
            s += q2 + q6 - p5 - p0;
            val[7] = s >> 4;
            s += q3 + q6 - p4 - q0;
            val[8] = s >> 4;
            s += q4 + q6 - p3 - q1;
            val[9] = s >> 4;
            s += q5 + q6 - p2 - q2;
            val[10] = s >> 4;
            s += q6 * 2 - p1 - q3;
            val[11] = s >> 4;
        } else if (code == 2) {
            int s = p3 * 3 + p2 * 2 + p1 + p0 + q0 + 4;
            val[3] = s >> 3;
            s += p1 + q1 - p3 - p2;
            val[4] = s >> 3;
            s += p0 + q2 - p3 - p1;
            val[5] = s >> 3;
            s += q0 + q3 - p3 - p0;
            val[6] = s >> 3;
            s += q1 + q3 - p2 - q0;
            val[7] = s >> 3;
            s += q2 + q3 - p1 - q1;
            val[8] = s >> 3;
        }
    } else if (code == 2) {  // chroma wd6
        val[4] = (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3;
        val[5] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
        val[6] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
        val[7] = (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3;
    }
}

// Append `value` to `list` where `pred` holds, warp by warp (one shared
// atomic a warp; a warp's entries stay in lane order). Every lane of the
// warp calls it.
__device__ __forceinline__ void append(bool pred, int value, uint16_t *list,
                                       int *cnt) {
    const unsigned mask = __ballot_sync(0xffffffffu, pred);
    const int lane = threadIdx.x & 31;
    int base = 0;
    if (lane == 0 && mask) base = atomicAdd(cnt, __popc(mask));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (pred) list[base + __popc(mask & ((1u << lane) - 1))] = (uint16_t)value;
}

// One direction over the staged tile. VERT: lines are the staged rows
// of A, edges along them at A column 4k + 8, results into B (tile
// columns only). !VERT: lines are the TC tile columns of B, edges at B
// row 4k + 8, results into A's tile rows. cls / L: the direction's maps
// as staged for the tile ((AR / 4) x NE for VERT, NE x (TC / 4)
// otherwise; cls -1 outside the plane); the masks go to `m`. The work
// is compacted: (a) lists the active edges, (b) decides their masks and
// lists the edges that write, (c) filters those, so warps run dense
// whatever the share of active edges. list1 / list2: LINES * NE
// entries each; cnt: two counters, zero on entry.
template <bool LUMA, bool VERT, typename TI, typename TO>
__device__ __forceinline__ void pass(const int8_t *cls, const uint8_t *L,
                                     const int *se, const int *si, int bd,
                                     const TI *in, TO *out, uint8_t *m,
                                     uint16_t *list1, uint16_t *list2,
                                     int *cnt) {
    // the first and last staged rows are no horizontal edge's taps, so
    // the vertical pass skips them
    constexpr int LINES = VERT ? AR - 2 : TC, L0 = VERT ? 1 : 0;
    constexpr int IN_S = VERT ? AC : TC;       // row stride of `in`
    constexpr int OUT_S = VERT ? TC : AC;      // row stride of `out`
    const int tid = threadIdx.x;
    const int bdm8 = bd - 8, F = 1 << bdm8;
    // VERT: neighbouring threads take neighbouring edges of one row
    // (their 16-byte tap loads are neighbours); horizontal: neighbouring
    // columns of one edge row
    auto line_of = [&](int i, int &line, int &k) {
        if (VERT) {
            line = i / NE;
            k = i - line * NE;
            line += L0;
        } else {
            k = i / TC;
            line = i - k * TC;
        }
    };
    auto map_idx = [&](int line, int k) {
        return VERT ? (line >> 2) * NE + k : k * (TC / 4) + (line >> 2);
    };
    auto taps = [&](int line, int k) {
        if constexpr (VERT)
            return row_taps<LUMA>(in + line * IN_S, k);
        else
            return col_taps<LUMA>(in + line, IN_S, k);
    };
    auto mask_at = [&](int line, int k) -> uint8_t & {
        return VERT ? m[line * NE + k] : m[k * TC + line];
    };

    // (a) the active edges; masks start at none
    for (int b0 = 0; b0 < LINES * NE; b0 += THREADS) {
        const int i = b0 + tid;
        bool active = false;
        if (i < LINES * NE) {
            int line, k;
            line_of(i, line, k);
            active = cls[map_idx(line, k)] >= 0;
            mask_at(line, k) = 0;
        }
        append(active, i, list1, cnt);
    }
    __syncthreads();
    // (b) their masks, from their taps
    const int n1 = cnt[0];
    for (int b0 = 0; b0 < n1; b0 += THREADS) {
        const int j = b0 + tid;
        int i = 0, code = 0;
        if (j < n1) {
            int line, k;
            i = list1[j];
            line_of(i, line, k);
            const int idx = map_idx(line, k);
            const int l = L[idx];
            code = edge_code<LUMA>(taps(line, k), cls[idx], se[l] << bdm8,
                                   si[l] << bdm8, F);
            mask_at(line, k) = (uint8_t)code;
        }
        append(code > 0, i, list2, cnt + 1);
    }
    __syncthreads();
    // (c) values, each pixel written by its owner only
    constexpr int OLO = LUMA ? -6 : -2, OHI = LUMA ? 5 : 1;
    const int n2 = cnt[1];
    for (int j = tid; j < n2; j += THREADS) {
        int line, k;
        line_of(list2[j], line, k);
        const int code = mask_at(line, k);
        // pixel 4k - 4 + o of the tile is offset o + 4 of edge k - 1 and
        // o + 8 of edge k - 2, whose writes reach further left: they
        // claim a prefix of this edge's offsets
        int first = lo_of<LUMA>(code);
        const int last = hi_of<LUMA>(code);
        if (LUMA && k >= 1) {
            const int c1 = mask_at(line, k - 1);
            if (c1) first = max(first, hi_of<LUMA>(c1) - 3);
        }
        if (LUMA && k >= 2) {
            const int c2 = mask_at(line, k - 2);
            if (c2) first = max(first, hi_of<LUMA>(c2) - 7);
        }
        const int Hl = (L[map_idx(line, k)] >> 4) << bdm8;
        int val[12];
        edge_vals<LUMA>(taps(line, k), code, Hl, bd, val);
#pragma unroll
        for (int o = OLO; o <= OHI; o++) {
            const int t = 4 * k - 4 + o;
            if (o < first || o > last || t < 0 || t >= (VERT ? TC : TR))
                continue;
            if (VERT)
                out[line * OUT_S + t] = (TO)val[o + 6];
            else
                out[(HALO + t) * OUT_S + HALO + line] = (TO)val[o + 6];
        }
    }
    __syncthreads();
}

template <bool LUMA>
__device__ __forceinline__ void tile(const Args &a, const Plane &P, int t,
                                     int *smem) {
    constexpr int CQ = AC / 4, TQ = TC / 4, MR = AR / 4;
    int *A = smem;
    int16_t *B = reinterpret_cast<int16_t *>(A + AR * AC);
    int *se = reinterpret_cast<int *>(B + AR * TC), *si = se + 64;
    uint8_t *vm = reinterpret_cast<uint8_t *>(si + 64);
    uint8_t *hm = vm + AR * NE;
    int8_t *vc = reinterpret_cast<int8_t *>(hm + NE * TC);
    uint8_t *vl = reinterpret_cast<uint8_t *>(vc + MR * NE);
    int8_t *hc = reinterpret_cast<int8_t *>(vl + MR * NE);
    uint8_t *hl = reinterpret_cast<uint8_t *>(hc + NE * TQ);
    uint16_t *list1 = reinterpret_cast<uint16_t *>(hl + NE * TQ);
    uint16_t *list2 = list1 + (AR - 2) * NE;
    int *cnt = reinterpret_cast<int *>(list2 + (AR - 2) * NE);
    const int tid = threadIdx.x;
    const int ty = t / P.tiles_x, tx = t - ty * P.tiles_x;
    const int R0 = ty * TR, C0 = tx * TC;
    const int H = 4 * P.h4, W = 4 * P.w4;

    // (1) stage the tile and its halo; zeros outside the plane (W is a
    // multiple of 4, so a chunk is wholly inside or outside)
    for (int i = tid; i < AR * CQ; i += THREADS) {
        const int r = i / CQ, q = i - r * CQ;
        const int y = R0 - HALO + r, x = C0 - HALO + 4 * q;
        int *d = A + r * AC + 4 * q;
        if (y >= 0 && y < H && x >= 0 && x < W)
            cp_async16(d, P.src + (size_t)y * W + x);
        else
            *reinterpret_cast<int4 *>(d) = make_int4(0, 0, 0, 0);
    }
    // the maps of the edges the tile evaluates (cls -1 outside the
    // plane), while the pixels are in flight
    for (int i = tid; i < MR * NE + NE * TQ; i += THREADS) {
        const bool v = i < MR * NE;
        const int j = v ? i : i - MR * NE;
        const int r = v ? j / NE : j / TQ, c = v ? j - r * NE : j - r * TQ;
        const int my = (R0 >> 2) + r - (v ? HALO / 4 : 1);
        const int mx = (C0 >> 2) + c - (v ? 1 : 0);
        const int8_t *cls = v ? P.vcls : P.hcls;
        const uint8_t *L = v ? P.vL : P.hL;
        const bool ok = my >= 0 && my < P.h4 && mx >= 0 && mx < P.w4;
        const int idx = my * P.w4 + mx;
        (v ? vc : hc)[j] = ok ? cls[idx] : (int8_t)-1;
        (v ? vl : hl)[j] = ok ? L[idx] : (uint8_t)0;
    }
    if (tid < 64) {
        se[tid] = a.lut_e[tid];
        si[tid] = a.lut_i[tid];
    }
    if (tid < 4) cnt[tid] = 0;
    cp_async_wait_all();
    __syncthreads();

    // B starts as the staged rows' tile columns
    for (int i = tid; i < AR * TQ; i += THREADS) {
        const int r = i / TQ, q = i - r * TQ;
        const int4 u = reinterpret_cast<const int4 *>(A)[r * CQ + HALO / 4 + q];
        reinterpret_cast<short4 *>(B)[i] = make_short4(u.x, u.y, u.z, u.w);
    }
    // (2)-(3) vertical edges: A -> B
    pass<LUMA, true>(vc, vl, se, si, a.bd, A, B, vm, list1, list2, cnt);
    // A's tile starts as B's tile rows
    for (int i = tid; i < TR * TQ; i += THREADS) {
        const int r = i / TQ, q = i - r * TQ;
        const short4 u = reinterpret_cast<const short4 *>(B)[(HALO + r) * TQ + q];
        reinterpret_cast<int4 *>(A)[(HALO + r) * CQ + HALO / 4 + q] =
            make_int4(u.x, u.y, u.z, u.w);
    }
    // (4) horizontal edges: B -> A
    pass<LUMA, false>(hc, hl, se, si, a.bd, B, A, hm, list1, list2,
                      cnt + 2);
    // (5) the tile to the output plane
    for (int i = tid; i < TR * TQ; i += THREADS) {
        const int r = i / TQ, q = i - r * TQ;
        const int y = R0 + r, x = C0 + 4 * q;
        if (y < H && x < W)
            *reinterpret_cast<int4 *>(P.dst + (size_t)y * W + x) =
                reinterpret_cast<const int4 *>(A)[(HALO + r) * CQ +
                                                  HALO / 4 + q];
    }
}

// `a` is a __grid_constant__: its planes are read in place, not copied
__global__ void __launch_bounds__(THREADS)
deblock_frame_kernel(const __grid_constant__ Args a) {
    extern __shared__ __align__(16) int smem[];
    const int b = blockIdx.x;
    const int pi = (a.n > 2 && b >= a.p[2].first) ? 2
                 : (a.n > 1 && b >= a.p[1].first) ? 1 : 0;
    const Plane &P = a.p[pi];
    if (P.luma)
        tile<true>(a, P, b - P.first, smem);
    else
        tile<false>(a, P, b - P.first, smem);
}

}  // namespace

// Resident blocks a SM of the deblock kernel (the occupancy query).
extern "C" int deblock_blocks_per_sm() {
    int n = 0;
    cudaFuncSetAttribute(deblock_frame_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    cudaFuncSetAttribute(deblock_frame_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, deblock_frame_kernel,
                                                  THREADS, SMEM_BYTES);
    return n;
}

// Deblock n planes (n <= 3) in one launch on `stream`. ptrs: 6 device
// pointers per plane (src, dst, vcls, vL, hcls, hL); dims: 3 ints per
// plane (h4, w4, luma); src and dst int32 (4*h4, 4*w4), 16-byte aligned
// (16-byte copies and stores), dst written whole; lut_e / lut_i int32
// (64,).
// Returns cudaGetLastError().
extern "C" int deblock_frame(const void *const *ptrs, const int *dims,
                             int n, const void *lut_e, const void *lut_i,
                             int bd, void *stream) {
    static bool attr[64];               // set per device
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!attr[dev]) {
        cudaFuncSetAttribute(deblock_frame_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
        // the largest shared carveout: four blocks a SM
        cudaFuncSetAttribute(deblock_frame_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
        attr[dev] = true;
    }
    if (n < 1 || n > MAX_PLANES) return (int)cudaErrorInvalidValue;
    Args a = {};
    int blocks = 0;
    for (int i = 0; i < n; i++) {
        Plane &P = a.p[i];
        P.src = (const int32_t *)ptrs[6 * i];
        P.dst = (int32_t *)ptrs[6 * i + 1];
        P.vcls = (const int8_t *)ptrs[6 * i + 2];
        P.vL = (const uint8_t *)ptrs[6 * i + 3];
        P.hcls = (const int8_t *)ptrs[6 * i + 4];
        P.hL = (const uint8_t *)ptrs[6 * i + 5];
        P.h4 = dims[3 * i];
        P.w4 = dims[3 * i + 1];
        P.luma = dims[3 * i + 2];
        P.tiles_x = (4 * P.w4 + TC - 1) / TC;
        P.first = blocks;
        blocks += P.tiles_x * ((4 * P.h4 + TR - 1) / TR);
    }
    a.n = n;
    a.lut_e = (const int *)lut_e;
    a.lut_i = (const int *)lut_i;
    a.bd = bd;
    if (blocks > 0)
        deblock_frame_kernel<<<blocks, THREADS, SMEM_BYTES,
                               (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
