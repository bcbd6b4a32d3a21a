// Intra prediction and residuals of a frame's leftover intra units:
// every level of the plan, every plane, in one cooperative launch.
//
// Replaces the eight device programs of dav1d_tpu/ops/ipred.py that a
// level runs: edge_gather_fn (ipred.py:50), splat_family_fn (:67),
// z1_fn (:199), z3_fn (:249), z2_fn (:296) with _filter_edges_batch
// (:148) and _upsample_edges_batch (:181), filter_fn (:357), cfl_fn
// (:413) and scatter_pred_fn (:485), and the residual launches
// dav1d_tpu's recon/ipred_device.py runs after each level; the math is
// the reference's (src/ipred_tmpl.c:44-720,
// src/ipred_prepare_tmpl.c:186-190), rule for rule as ops/ipred.py's
// plain versions compute it, and the residuals are csrc/itx_add.cu's
// (itx_common.cuh).
//
// Tables (int32; ops/ipred.py pack_plan):
//   units (n, NCOL): plane, family, w, h, py, px, tlf, row, p0 .. p7;
//       `row` is the unit's row of `runs`; the family's parameters are
//       those of ops/ipred.py
//   runs (n, NRUN): the unit's edges as four runs, each start, stride,
//       count, size -- left, bottom-left, top, top-right -- and the
//       top-left source. Entry i < size of a run is the source start +
//       stride * min(i, count - 1). The left runs fill the edge buffer
//       (the golden Edge layout, center C = 160) down from C - 1, the
//       bottom-left after the left's size; the top runs up from C + 1,
//       the top-right after the top's size; the top-left source lands
//       at C; every other entry is 0. A source below the plane's H * W
//       is a pixel of the unit's plane, H * W + k the constant k:
//       half + 1, half - 1, half, 0.
//   res (m, 6): ops/itx.py job rows; blocks (nb, BCOL): cls, first,
//       count (ops/itx.py res_blocks, class-uniform) and the plane
//   wht (mw, WCOL): WHT job rows and the plane
//   levels (nl, NLEV): u0, ub, u1, b0, b1, w0, w1 -- the level's units
//       [u0, ub) a block each (64 wide or tall, or of at least
//       ops/ipred.py BLOCK_AREA pixels) and [ub, u1) a warp each (up to
//       32x32), each range sorted by class; its residual blocks [b0, b1)
//       and WHT jobs [w0, w1).
// The units of a level only read pixels that lower levels wrote (the
// plan's level scheduler) and no two write the same pixel; a level's
// residuals land on its own units' pixels (a CFL residual may come at a
// level above its prediction's) after all of them are predicted, and
// before the next level reads.
//
// Bound: memory. A unit reads its two rows, the pixels its family's
// arithmetic uses once, a CFL unit its luma rect, and writes its w x h
// outputs once; a residual job reads its row and coefficients, and its
// pixels are the unit's outputs (chip_smoke.py _ipred_work counts
// them). Even s7's densest frame moves ~11 MB, a few microseconds of
// HBM time, so the launch is bound by its levels' latency: each level a
// step of units, a grid barrier, a step of residuals and a barrier.
//
// Design: persistent blocks of 4 warps, as many as the card holds at once
// (the occupancy API; 2 a SM: the residual body's 64-point transforms take
// ~254 registers a thread), launched cooperatively. (1) Prediction: a large
// unit (64 wide or tall, or of at least ops/ipred.py BLOCK_AREA pixels)
// takes a whole block, a small one a warp (4x4 units are the most common: a
// block would idle most of its threads on them), the warps after the blocks
// that took a large unit; the area was chosen by timing
// (tools/torch_ipred_variants.py areas). The unit's threads expand its runs
// into their shared edge buffer (only the span C -/+ 2 max(w, h) its family
// can read; a thread's loads all in flight at once), apply the Z2 top-left
// 5-6-5 filter, filter or upsample a directional edge in shared memory
// (ipred_tmpl.c:363-407) and store every output straight into the plane
// (pixels past the plane's edge dropped). Filter-intra is a wavefront over
// its 4x2 sub-blocks, a thread a sub-block, the kind's taps in registers;
// CFL's and DC's sums are warp shuffles (and a shared step on a block). (2)
// After a grid barrier, the level's residual blocks, a block row a block
// (the itx_add kernel's body), and its WHT jobs, one a thread; then a
// barrier before the next level (a level without residuals needs only the
// first). The two steps share one dynamic shared-memory region, sized to the
// larger. Plane loads are ordinary (coherent) loads: the planes are written
// inside the launch.

#include <cooperative_groups.h>

#include "itx_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int C = 160;                  // edge buffer center
constexpr int EDGE_LEN = 2 * C + 1;
constexpr int NCOL = 16;                // unit row columns
constexpr int NRUN = 17;                // run row columns
constexpr int NLEV = 7;                 // level row columns
constexpr int BCOL = 4;                 // residual block row columns
constexpr int WCOL = 7;                 // WHT job row columns
constexpr int WARPS = THREADS / 32;     // THREADS: itx_common.cuh's 128
constexpr int C2 = 64;                  // Z2's local buffer center
constexpr int BL = 129;                 // Z2's local buffer length
constexpr int T_LEN = 2 * BL + 2;       // filtered / upsampled edge
constexpr int O_LEN = 32 * 32;          // filter-intra outputs, CFL AC
// a warp's shared words: edge buffer, t, o and the block's reduction
// slots (a whole-block unit uses warp 0's)
constexpr int E_OFF = 0, T_OFF = EDGE_LEN, O_OFF = T_OFF + T_LEN,
              RED_OFF = O_OFF + O_LEN;
constexpr int WARP_WORDS = (RED_OFF + WARPS + 3) & ~3;
constexpr int PRED_BYTES = WARPS * WARP_WORDS * 4;

enum { FAM_S, FAM_F, FAM_Z1, FAM_Z2, FAM_Z3, FAM_CFL };
// dsp modes (ops/ipred_ref.py)
enum { DC_PRED = 0, VERT_PRED = 1, HOR_PRED = 2, LEFT_DC_PRED = 3,
       TOP_DC_PRED = 4, DC_128_PRED = 5, SMOOTH_PRED = 9,
       SMOOTH_V_PRED = 10, SMOOTH_H_PRED = 11, PAETH_PRED = 12 };

__constant__ int c_edge_kernel[3][5] = {
    {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

struct Planes {
    int32_t *p[3];
    int H[3];
    int W[3];
};

struct Args {
    Planes P;
    const int32_t *units, *runs, *res, *blocks, *wht, *levels, *pool,
        *smw, *taps;
    int n_levels, bd, ss_hor, ss_ver;
};

template <typename T> constexpr int smem_bytes() {
    return PRED_BYTES > TILE_WORDS * (int)sizeof(T)
        ? PRED_BYTES : TILE_WORDS * (int)sizeof(T);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__device__ __forceinline__ int log2i(int v) { return __ffs(v) - 1; }

// A unit's threads: N = 32 (a warp) or THREADS (the block).
template <int N> __device__ __forceinline__ void grp_sync() {
    if (N == 32)
        __syncwarp();
    else
        __syncthreads();
}

// The sum of v over the group (every thread of it calls it).
template <int N> __device__ int grp_sum(int v, int *red) {
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (N == 32) return v;
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    int s = 0;
    for (int k = 0; k < N / 32; k++) s += red[k];
    __syncthreads();
    return s;
}

// dc_gen of a w x h block from its top and left sums (ipred_tmpl.c).
__device__ int dc_gen(int st, int sl, int w, int h, int bd) {
    int dc = (st + sl + ((w + h) >> 1)) >> log2i(w + h);
    if (w != h) {
        const bool far = w > 2 * h || h > 2 * w;
        long long mult;
        int sh;
        if (bd == 8) {
            mult = far ? 0x3334 : 0x5556;
            sh = 16;
        } else {
            mult = far ? 0x6667 : 0xAAAB;
            sh = 17;
        }
        dc = (int)(((long long)dc * mult) >> sh);
    }
    return dc;
}

// The DC value of `mode` (DC, DC_128, TOP_DC, LEFT_DC) from the edges.
template <int N>
__device__ int dc_value(const int *e, int mode, int w, int h, int bd,
                        int tid, int *red) {
    if (mode == DC_128_PRED) return (1 << bd) >> 1;
    int st = 0, sl = 0;
    for (int i = tid; i < w; i += N) st += e[C + 1 + i];
    for (int i = tid; i < h; i += N) sl += e[C - 1 - i];
    st = grp_sum<N>(st, red);
    sl = grp_sum<N>(sl, red);
    if (mode == TOP_DC_PRED) return (st + (w >> 1)) >> log2i(w);
    if (mode == LEFT_DC_PRED) return (sl + (h >> 1)) >> log2i(h);
    return dc_gen(st, sl, w, h, bd);
}

// ipred_tmpl.c:363-386: dst[i], i < sz, from e[base + clip(i - 2 + j,
// from, to - 1)]; positions outside [lim_from, lim_to) pass through.
template <int N>
__device__ void filter_edge(int *dst, const int *e, int base, int sz,
                            int from, int to, int lim_from, int lim_to,
                            int strength, int tid) {
    const int *k = c_edge_kernel[strength - 1];
    const int lf = min(sz, lim_from), lt = min(sz, lim_to);
    for (int i = tid; i < sz; i += N) {
        int v;
        if (i < lf || i >= lt) {
            v = e[base + clampi(i, from, to - 1)];
        } else {
            int acc = 0;
            for (int j = 0; j < 5; j++)
                acc += k[j] * e[base + clampi(i - 2 + j, from, to - 1)];
            v = (acc + 8) >> 4;
        }
        dst[i] = v;
    }
}

// ipred_tmpl.c:392-407: the first n_out of the 2 hsz upsampled values,
// from vals[q] = e[base + clip(q - 1, from, to - 1)].
template <int N>
__device__ void upsample_edge(int *dst, const int *e, int base, int hsz,
                              int from, int to, int bdmax, int n_out,
                              int tid) {
    const int n = hsz - 1;
    for (int k = tid; k < n_out; k += N) {
        auto val = [&](int q) { return e[base + clampi(q - 1, from, to - 1)]; };
        int v;
        if (k == 2 * n) {
            v = val(1 + n);
        } else if (k > 2 * n) {
            v = 0;
        } else if (!(k & 1)) {
            v = val(1 + (k >> 1));
        } else {
            const int i = k >> 1;
            v = clampi((-val(i) + 9 * val(i + 1) + 9 * val(i + 2) -
                        val(i + 3) + 8) >> 4, 0, bdmax);
        }
        dst[k] = v;
    }
}

// Predict unit k into its plane with the group's N threads (thread
// `tid` of them) and the shared words `buf` (WARP_WORDS). N = 32 takes
// units up to 32x32 only, N = THREADS any; rows the host tables never
// hold store nothing.
template <int N>
__device__ void predict(const Args &a, int k, int tid, int *buf) {
    int *e = buf + E_OFF, *t = buf + T_OFF, *o = buf + O_OFF,
        *red = buf + RED_OFF;
    const int32_t *u = a.units + (size_t)k * NCOL;
    const int pl = __ldg(u), fam = __ldg(u + 1), w = __ldg(u + 2),
              h = __ldg(u + 3), py = __ldg(u + 4), px = __ldg(u + 5),
              tlf = __ldg(u + 6), row = __ldg(u + 7);
    if (pl < 0 || pl > 2 || !a.P.p[pl] || w < 4 || w > 64 || h < 4 ||
        h > 64 || (w & (w - 1)) || (h & (h - 1)) || fam < FAM_S ||
        fam > FAM_CFL || (N == 32 && (w > 32 || h > 32)) ||
        ((fam == FAM_F || fam == FAM_CFL) && (w > 32 || h > 32)))
        return;
    int p[8];
#pragma unroll
    for (int i = 0; i < 8; i++) p[i] = __ldg(u + 8 + i);
    int32_t *plane = a.P.p[pl];
    const int H = a.P.H[pl], W = a.P.W[pl];
    const int nflat = H * W;
    const int bd = a.bd;
    const int half = (1 << bd) >> 1, bdmax = (1 << bd) - 1;
    const int lw = log2i(w);

    // the edge span this unit can read, expanded from its runs: a
    // thread's entries (at most PER) all loaded before any is stored,
    // so that their pixel loads are in flight together
    const int32_t *ru = a.runs + (size_t)row * NRUN;
    const int span = 2 * max(w, h);
    constexpr int PER = (4 * (N == 32 ? 32 : 64) + N) / N;
    int ev[PER];
#pragma unroll
    for (int j = 0; j < PER; j++) {
        const int i = C - span + tid + j * N;
        int s = -1;                     // no run: 0
        if (i == C) {
            s = __ldg(ru + 16);
        } else if (i <= C + span) {
            int q = i < C ? C - 1 - i : i - C - 1;
            const int32_t *r = ru + (i < C ? 0 : 8);
            const int first = __ldg(r + 3);
            if (q >= first) {
                q -= first;
                r += 4;
            }
            if (q < __ldg(r + 3))
                s = __ldg(r) + __ldg(r + 1) * min(q, __ldg(r + 2) - 1);
        }
        int v = 0;
        if (s >= 0 && s < nflat)
            v = plane[s];
        else if (s >= nflat && s < nflat + 3)
            v = s == nflat ? half + 1 : s == nflat + 1 ? half - 1 : half;
        ev[j] = v;
    }
#pragma unroll
    for (int j = 0; j < PER; j++) {
        const int i = C - span + tid + j * N;
        if (i <= C + span) e[i] = ev[j];
    }
    grp_sync<N>();
    if (tlf && tid == 0)
        e[C] = ((e[C - 1] + e[C + 1]) * 5 + e[C] * 6 + 8) >> 4;
    grp_sync<N>();

    auto store = [&](int y, int x, int v) {
        if (py + y < H && px + x < W)
            plane[(size_t)(py + y) * W + px + x] = v;
    };

    if (fam == FAM_S) {
        const int mode = p[0];
        int dc = 0;
        if (mode == DC_PRED || mode == TOP_DC_PRED ||
            mode == LEFT_DC_PRED || mode == DC_128_PRED)
            dc = dc_value<N>(e, mode, w, h, bd, tid, red);
        const int right = e[C + w], bottom = e[C - h], tl = e[C];
        for (int k2 = tid; k2 < w * h; k2 += N) {
            const int y = k2 >> lw, x = k2 & (w - 1);
            const int top = e[C + 1 + x], left = e[C - 1 - y];
            int v;
            switch (mode) {
            case VERT_PRED: v = top; break;
            case HOR_PRED: v = left; break;
            case PAETH_PRED: {
                const int base = left + top - tl;
                const int ld = abs(left - base), td = abs(top - base),
                          tld = abs(tl - base);
                v = (ld <= td && ld <= tld) ? left : td <= tld ? top : tl;
                break;
            }
            case SMOOTH_PRED: {
                const int wv = __ldg(a.smw + h + y),
                          wh = __ldg(a.smw + w + x);
                v = (wv * top + (256 - wv) * bottom + wh * left +
                     (256 - wh) * right + 256) >> 9;
                break;
            }
            case SMOOTH_V_PRED: {
                const int wv = __ldg(a.smw + h + y);
                v = (wv * top + (256 - wv) * bottom + 128) >> 8;
                break;
            }
            case SMOOTH_H_PRED: {
                const int wh = __ldg(a.smw + w + x);
                v = (wh * left + (256 - wh) * right + 128) >> 8;
                break;
            }
            default: v = dc;
            }
            store(y, x, v);
        }
    } else if (fam == FAM_Z1) {
        const int dx = p[0], st = p[1], up = p[2], wmin = min(w, h);
        int L, max_base, inc;
        if (up) {
            upsample_edge<N>(t, e, C + 1, w + h, -1, w + wmin, bdmax,
                             2 * (w + h), tid);
            L = 2 * (w + h);
            max_base = 2 * (w + h) - 2;
            inc = 2;
        } else {
            L = w + h;
            inc = 1;
            if (st) {
                filter_edge<N>(t, e, C + 1, w + h, -1, w + wmin, 0, w + h,
                               st, tid);
                max_base = w + h - 1;
            } else {
                for (int i = tid; i < L; i += N)
                    t[i] = e[C + 1 + min(i, w + wmin - 1)];
                max_base = w + wmin - 1;
            }
        }
        grp_sync<N>();
        for (int k2 = tid; k2 < w * h; k2 += N) {
            const int y = k2 >> lw, x = k2 & (w - 1);
            const int xpos = dx * (y + 1), frac = xpos & 0x3E;
            const int base = (xpos >> 6) + x * inc;
            const int v = base < max_base
                ? (t[base] * (64 - frac) + t[min(base + 1, L - 1)] * frac +
                   32) >> 6
                : t[max_base];
            store(y, x, v);
        }
    } else if (fam == FAM_Z3) {
        const int dy = p[0], st = p[1], up = p[2], wmin = min(w, h);
        const int base0 = C - (w + h), sfrom = max(w - h, 0);
        int L, anchor, max_base;
        if (up) {
            upsample_edge<N>(t, e, base0, w + h, sfrom, w + h + 1, bdmax,
                             2 * (w + h), tid);
            L = 2 * (w + h);
            anchor = max_base = 2 * (w + h) - 2;
        } else {
            L = w + h;
            anchor = w + h - 1;
            if (st) {
                filter_edge<N>(t, e, base0, w + h, sfrom, w + h + 1, 0,
                               w + h, st, tid);
                max_base = w + h - 1;
            } else {
                for (int i = tid; i < L; i += N) t[i] = e[base0 + i];
                max_base = h + wmin - 1;
            }
        }
        grp_sync<N>();
        const int last = t[clampi(anchor - max_base, 0, L - 1)];
        for (int k2 = tid; k2 < w * h; k2 += N) {
            const int y = k2 >> lw, x = k2 & (w - 1);
            const int ypos = dy * (x + 1), frac = ypos & 0x3E;
            const int base = (ypos >> 6) + y * (1 + up);
            int v = last;
            if (base < max_base) {
                const int i0 = clampi(anchor - base, 0, L - 1);
                const int i1 = clampi(anchor - base - 1, 0, L - 1);
                v = (t[i0] * (64 - frac) + t[i1] * frac + 32) >> 6;
            }
            store(y, x, v);
        }
    } else if (fam == FAM_Z2) {
        const int dx = p[0], dy = p[1], st_t = p[2], st_l = p[3],
                  max_w = p[4], max_h = p[5], ua = p[6], ul = p[7];
        for (int i = tid; i < BL; i += N) t[i] = 0;
        grp_sync<N>();
        if (ua)
            upsample_edge<N>(t + C2, e, C, w + 1, 0, w + 1, bdmax,
                             2 * w + 1, tid);
        else if (st_t)
            filter_edge<N>(t + C2 + 1, e, C + 1, w, -1, w, 0, max_w, st_t,
                           tid);
        else
            for (int i = tid; i < w; i += N) t[C2 + 1 + i] = e[C + 1 + i];
        if (ul)
            upsample_edge<N>(t + C2 - 2 * h, e, C - h, h + 1, 0, h + 1,
                             bdmax, 2 * h + 1, tid);
        else if (st_l)
            filter_edge<N>(t + C2 - h, e, C - h, h, 0, h + 1, h - max_h, h,
                           st_l, tid);
        else
            for (int i = tid; i < h; i += N) t[C2 - h + i] = e[C - h + i];
        grp_sync<N>();
        if (tid == 0) t[C2] = e[C];
        grp_sync<N>();
        for (int k2 = tid; k2 < w * h; k2 += N) {
            const int y = k2 >> lw, x = k2 & (w - 1);
            const int xpos = ((1 + ua) << 6) - dx * (y + 1);
            const int base_x = (xpos >> 6) + x * (1 + ua);
            int v;
            if (base_x >= 0) {
                const int frac = xpos & 0x3E;
                const int ia = clampi(C2 + base_x, 0, BL - 2);
                v = (t[ia] * (64 - frac) + t[ia + 1] * frac + 32) >> 6;
            } else {
                const int ypos = (y << (6 + ul)) - dy * (x + 1);
                const int frac = ypos & 0x3E;
                const int il = clampi(C2 - (1 + ul) - (ypos >> 6), 1,
                                      BL - 1);
                v = (t[il] * (64 - frac) + t[il - 1] * frac + 32) >> 6;
            }
            store(y, x, v);
        }
    } else if (fam == FAM_F) {
        // the kind's (8, 7) taps in registers for the whole wavefront
        const int32_t *tp = a.taps + (size_t)clampi(p[0], 0, 4) * 56;
        int tap[56];
#pragma unroll
        for (int i = 0; i < 56; i++) tap[i] = __ldg(tp + i);
        const int nbx = w >> 2, nby = h >> 1;
        for (int s = 0; s < nbx + nby - 1; s++) {
            const int r = tid, c = s - r;
            if (r < nby && c >= 0 && c < nbx) {
                const int y = 2 * r, x = 4 * c;
                int q[7];
                if (y == 0) {
                    for (int j = 0; j < 5; j++) q[j] = e[C + x + j];
                } else {
                    q[0] = x ? o[(y - 1) * w + x - 1] : e[C - y];
                    for (int j = 0; j < 4; j++)
                        q[1 + j] = o[(y - 1) * w + x + j];
                }
                if (x) {
                    q[5] = o[y * w + x - 1];
                    q[6] = o[(y + 1) * w + x - 1];
                } else {
                    q[5] = e[C - (y + 1)];
                    q[6] = e[C - (y + 2)];
                }
#pragma unroll
                for (int fi = 0; fi < 8; fi++) {
                    int acc = 8;
#pragma unroll
                    for (int j = 0; j < 7; j++) acc += tap[fi * 7 + j] * q[j];
                    o[(y + (fi >> 2)) * w + x + (fi & 3)] =
                        clampi(acc >> 4, 0, bdmax);
                }
            }
            grp_sync<N>();
        }
        for (int k2 = tid; k2 < w * h; k2 += N)
            store(k2 >> lw, k2 & (w - 1), o[k2]);
    } else if (fam == FAM_CFL) {
        const int ypy = p[0], ypx = p[1], nh = p[2], nw = p[3],
                  alpha = p[4], mode = p[5];
        const int32_t *Y = a.P.p[0];
        const int YW = a.P.W[0];
        const int ss_hor = a.ss_hor, ss_ver = a.ss_ver;
        const int shift = 1 + !ss_ver + !ss_hor;
        // the luma AC in batches of CB outputs a lane, the loads of a
        // batch all in flight before any of its sums is stored
        constexpr int CB = 8;
        int part = 0;
        for (int k0 = 0; k0 < w * h; k0 += CB * N) {
            int av[CB];
#pragma unroll
            for (int j = 0; j < CB; j++) {
                const int k2 = k0 + tid + j * N;
                const int bi = min(k2 >> lw, nh - 1),
                          bj = min(k2 & (w - 1), nw - 1);
                const int32_t *s = Y + (size_t)(ypy + (bi << ss_ver)) * YW +
                    ypx + (bj << ss_hor);
                int v = 0;
                if (k2 < w * h) {
                    v = s[0];
                    if (ss_hor) v += s[1];
                    if (ss_ver) {
                        v += s[YW];
                        if (ss_hor) v += s[YW + 1];
                    }
                }
                av[j] = v << shift;
            }
#pragma unroll
            for (int j = 0; j < CB; j++) {
                const int k2 = k0 + tid + j * N;
                if (k2 < w * h) {
                    o[k2] = av[j];
                    part += av[j];
                }
            }
        }
        const int log2sz = lw + log2i(h);
        const int total = (grp_sum<N>(part, red) + ((1 << log2sz) >> 1)) >>
            log2sz;
        const int dc = dc_value<N>(e, mode, w, h, bd, tid, red);
        grp_sync<N>();                  // o[] written by other threads
        for (int k2 = tid; k2 < w * h; k2 += N) {
            const int diff = alpha * (o[k2] - total);
            int v = (abs(diff) + 32) >> 6;
            if (diff < 0) v = -v;
            store(k2 >> lw, k2 & (w - 1), clampi(dc + v, 0, bdmax));
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ipred_frame_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::grid_group grid = cg::this_grid();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int *words = (int *)smem;
    for (int L = 0; L < a.n_levels; L++) {
        const int32_t *lv = a.levels + (size_t)L * NLEV;
        const int u0 = __ldg(lv), ub = __ldg(lv + 1), u1 = __ldg(lv + 2),
                  b0 = __ldg(lv + 3), b1 = __ldg(lv + 4),
                  w0 = __ldg(lv + 5), w1 = __ldg(lv + 6);
        // (1) prediction: large units a block each, then the small ones
        // a warp each, first to the blocks that took no large unit
        for (int k = u0 + blockIdx.x; k < ub; k += gridDim.x) {
            predict<THREADS>(a, k, threadIdx.x, words);
            __syncthreads();
        }
        const int rank = (blockIdx.x + gridDim.x - (ub - u0) % gridDim.x) %
            gridDim.x;
        for (int k = ub + rank * WARPS + warp; k < u1;
             k += gridDim.x * WARPS) {
            predict<32>(a, k, lane, words + warp * WARP_WORDS);
            __syncwarp();
        }
        // (2) residuals, once every unit of the level is predicted
        if (b1 > b0 || w1 > w0) {
            grid.sync();
            for (int b = b0 + blockIdx.x; b < b1; b += gridDim.x) {
                const int32_t *row = a.blocks + (size_t)b * BCOL;
                const int pl = __ldg(row + 3);
                if (pl < 0 || pl > 2 || !a.P.p[pl]) __trap();
                itx_block<T>(a.pool, a.res, row, a.P.p[pl], a.P.H[pl],
                             a.P.W[pl], a.bd, (T *)smem);
                __syncthreads();
            }
            for (int i = w0 + blockIdx.x * THREADS + threadIdx.x; i < w1;
                 i += gridDim.x * THREADS) {
                const int32_t *j = a.wht + (size_t)i * WCOL;
                const int pl = __ldg(j + 6);
                if (pl < 0 || pl > 2 || !a.P.p[pl]) __trap();
                wht_job(a.pool, j, a.P.p[pl], a.P.H[pl], a.P.W[pl], a.bd);
            }
        }
        if (L + 1 < a.n_levels) grid.sync();
    }
}

// Blocks of the kernel at `bd` that fit one SM at once, and the card's
// SM count, per device (the occupancy API).
int blocks_per_sm(int bd, int *sms) {
    int dev = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (bd == 12)
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, ipred_frame_kernel<i64>, THREADS, smem_bytes<i64>());
    else
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, ipred_frame_kernel<i32>, THREADS, smem_bytes<i32>());
    return per;
}

}  // namespace

// The table layout the kernel reads: NCOL, NRUN, NLEV, BCOL, WCOL,
// THREADS.
extern "C" void ipred_layout(int *out) {
    out[0] = NCOL;
    out[1] = NRUN;
    out[2] = NLEV;
    out[3] = BCOL;
    out[4] = WCOL;
    out[5] = THREADS;
}

// Blocks a SM, the SM count and the dynamic shared bytes of a block of
// the kernel at `bd` (out[0..2]).
extern "C" int ipred_occupancy(int bd, int *out) {
    out[1] = 0;
    out[0] = blocks_per_sm(bd, &out[1]);
    out[2] = bd == 12 ? smem_bytes<i64>() : smem_bytes<i32>();
    return (int)cudaGetLastError();
}

// Predict and reconstruct a frame's leftover plan of n_levels levels on
// `stream`: planes p0..p2 (int32, row-major H x W; p1 and p2 null
// without chroma), the tables above (device pointers; a table with no
// rows may be null), pool the frame's int32 coefficient pool, smw the
// (128,) smooth weights, taps the (5, 8, 7) filter-intra taps, ss_hor /
// ss_ver the chroma subsampling. One cooperative launch of the blocks
// that fit the card at once (*grid gets their count; 0: no launch);
// none without levels. Returns a CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the grid does not fit).
extern "C" int ipred_plan(void *p0, void *p1, void *p2, int H0, int W0,
                          int H1, int W1, int H2, int W2, const void *units,
                          const void *runs, const void *res,
                          const void *blocks, const void *wht,
                          const void *levels, int n_levels, const void *pool,
                          const void *smw, const void *taps, int bd,
                          int ss_hor, int ss_ver, void *stream, int *grid) {
    *grid = 0;
    if (n_levels < 0 || (bd != 8 && bd != 10 && bd != 12) || !p0 ||
        !smw || !taps || ss_hor < 0 || ss_hor > 1 || ss_ver < 0 ||
        ss_ver > 1 || (n_levels > 0 && !levels))
        return (int)cudaErrorInvalidValue;
    if (n_levels == 0) return 0;
    Args a;
    a.P = {{(int32_t *)p0, (int32_t *)p1, (int32_t *)p2},
           {H0, H1, H2},
           {W0, W1, W2}};
    a.units = (const int32_t *)units;
    a.runs = (const int32_t *)runs;
    a.res = (const int32_t *)res;
    a.blocks = (const int32_t *)blocks;
    a.wht = (const int32_t *)wht;
    a.levels = (const int32_t *)levels;
    a.pool = (const int32_t *)pool;
    a.smw = (const int32_t *)smw;
    a.taps = (const int32_t *)taps;
    a.n_levels = n_levels;
    a.bd = bd;
    a.ss_hor = ss_hor;
    a.ss_ver = ss_ver;
    int sms = 0;
    const int per = blocks_per_sm(bd, &sms);
    if (per < 1 || sms < 1) {
        const cudaError_t e = cudaGetLastError();
        return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    }
    *grid = per * sms;
    void *args[] = {&a};
    const void *fn = bd == 12 ? (const void *)ipred_frame_kernel<i64>
                              : (const void *)ipred_frame_kernel<i32>;
    const cudaError_t e = cudaLaunchCooperativeKernel(
        fn, dim3(*grid), dim3(THREADS), args,
        bd == 12 ? smem_bytes<i64>() : smem_bytes<i32>(),
        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
