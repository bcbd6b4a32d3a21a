// Intra prediction of one level of leftover intra units: every plane's
// units in one launch, each predicted from its edges and stored into its
// plane.
//
// Replaces the eight device programs of dav1d_tpu/ops/ipred.py that a
// level runs: edge_gather_fn (ipred.py:50), splat_family_fn (:67),
// z1_fn (:199), z3_fn (:249), z2_fn (:296) with _filter_edges_batch
// (:148) and _upsample_edges_batch (:181), filter_fn (:357), cfl_fn
// (:413) and scatter_pred_fn (:485); the math is the reference's
// (src/ipred_tmpl.c:44-720, src/ipred_prepare_tmpl.c:186-190), rule for
// rule as ops/ipred.py's plain versions compute it.
//
// A unit row (int32, NCOL columns; ops/ipred.py):
//   plane, family, w, h, py, px, tlf, row, p0 .. p7
// `row` indexes the (m, 321) index table: entry i of the row is the
// plane-flat position of edge element i (center C = 160, the golden
// Edge layout), or nflat + k for the constant k: half + 1, half - 1,
// half, 0. The family's parameters are those of ops/ipred.py. The
// units of a level only read pixels that lower levels wrote (the plan's
// level scheduler), so blocks run in any order; a CFL unit reads the
// luma plane's rect, written at a lower level.
//
// Bound: memory. A unit must read its row, the index entries its
// family's arithmetic uses and the pixels they name once (4 bytes
// each; an entry naming a constant reads no pixel), a CFL unit its
// luma rect, and write its w x h outputs once (chip_smoke.py
// _ipred_work counts them); the arithmetic is a few tens of integer
// operations an output. A 4x4 DC unit moves 192 bytes; a level of
// even s7's densest frame moves well under a microsecond of HBM time,
// so a launch is bound by its launch and its longest block. The
// kernel stages a wider span (C -/+ 2 max(w, h)) than most families
// read: one loop for every family, and all of it in one cache line
// or two for the common small units.
//
// Design: a block a unit (units are 4x4 to 64x64, the 4x4 ones the
// most common), 64 threads; ptxas: 40 registers, no spills, 6428 bytes
// of static shared memory. The host sorts a level's rows by class
// (family, w, h, upsample flags), so neighbouring blocks take the same
// branch, and no block mixes families. The block gathers the edge span
// it can read (C - 2 max(w, h) .. C + 2 max(w, h)) into shared memory
// through its index row, applies the Z2 top-left 5-6-5 filter, then the
// directional families filter or upsample their edge in shared memory
// (ipred_tmpl.c:363-407) and every thread computes its outputs straight
// from shared memory and stores them into the plane (pixels past the
// plane's edge dropped): no edge buffer or prediction goes through
// device memory. Filter-intra is a wavefront over its 4x2 sub-blocks:
// step s runs the sub-blocks (r, c) with r + c = s, a thread each, a
// barrier between steps, the outputs in shared memory. CFL sums the
// subsampled luma AC and the DC edges with block reductions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 160;                  // edge buffer center
constexpr int EDGE_LEN = 2 * C + 1;
constexpr int NCOL = 16;                // unit row columns
constexpr int THREADS = 64;
constexpr int C2 = 64;                  // Z2's local buffer center
constexpr int BL = 129;                 // Z2's local buffer length

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__device__ __forceinline__ int log2i(int v) { return __ffs(v) - 1; }

// The sum of v over the block (every thread calls it).
__device__ int block_sum(int v, int *red) {
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    int s = 0;
    for (int k = 0; k < THREADS / 32; k++) s += red[k];
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
__device__ int dc_value(const int *e, int mode, int w, int h, int bd,
                        int *red) {
    if (mode == DC_128_PRED) return (1 << bd) >> 1;
    int st = 0, sl = 0;
    for (int i = threadIdx.x; i < w; i += THREADS) st += e[C + 1 + i];
    for (int i = threadIdx.x; i < h; i += THREADS) sl += e[C - 1 - i];
    st = block_sum(st, red);
    sl = block_sum(sl, red);
    if (mode == TOP_DC_PRED) return (st + (w >> 1)) >> log2i(w);
    if (mode == LEFT_DC_PRED) return (sl + (h >> 1)) >> log2i(h);
    return dc_gen(st, sl, w, h, bd);
}

// ipred_tmpl.c:363-386: dst[i], i < sz, from e[base + clip(i - 2 + j,
// from, to - 1)]; positions outside [lim_from, lim_to) pass through.
__device__ void filter_edge(int *dst, const int *e, int base, int sz,
                            int from, int to, int lim_from, int lim_to,
                            int strength) {
    const int *k = c_edge_kernel[strength - 1];
    const int lf = min(sz, lim_from), lt = min(sz, lim_to);
    for (int i = threadIdx.x; i < sz; i += THREADS) {
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
__device__ void upsample_edge(int *dst, const int *e, int base, int hsz,
                              int from, int to, int bdmax, int n_out) {
    const int n = hsz - 1;
    for (int k = threadIdx.x; k < n_out; k += THREADS) {
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

__global__ void __launch_bounds__(THREADS)
ipred_kernel(Planes P, const int32_t *__restrict__ units,
             const int32_t *__restrict__ idx, int m,
             const int32_t *__restrict__ smw,
             const int32_t *__restrict__ taps, int bd, int ss_hor,
             int ss_ver) {
    __shared__ int e[EDGE_LEN];
    __shared__ int t[2 * BL + 2];       // filtered / upsampled edge
    __shared__ int o[32 * 32];          // filter-intra outputs, CFL AC
    __shared__ int red[THREADS / 32];

    const int32_t *u = units + (size_t)blockIdx.x * NCOL;
    const int pl = u[0], fam = u[1], w = u[2], h = u[3], py = u[4],
              px = u[5], tlf = u[6], row = u[7];
    const int p0 = u[8], p1 = u[9], p2 = u[10], p3 = u[11], p4 = u[12],
              p5 = u[13], p6 = u[14], p7 = u[15];
    // rows the host tables never hold: no store
    if (pl < 0 || pl > 2 || !P.p[pl] || row < 0 || row >= m ||
        w < 4 || w > 64 || h < 4 || h > 64 || (w & (w - 1)) ||
        (h & (h - 1)) || fam < FAM_S || fam > FAM_CFL ||
        ((fam == FAM_F || fam == FAM_CFL) && (w > 32 || h > 32)))
        return;
    int32_t *plane = P.p[pl];
    const int H = P.H[pl], W = P.W[pl];
    const long long nflat = (long long)H * W;
    const int half = (1 << bd) >> 1, bdmax = (1 << bd) - 1;
    const int lw = log2i(w);

    // the edge span this unit can read, gathered through its index row
    const int span = 2 * max(w, h);
    const int lo = max(C - span, 0), hi = min(C + span, EDGE_LEN - 1);
    const int32_t *ir = idx + (size_t)row * EDGE_LEN;
    for (int i = lo + threadIdx.x; i <= hi; i += THREADS) {
        const int q = ir[i];
        int v = 0;
        if (q >= 0 && q < nflat) {
            v = plane[q];
        } else if (q >= nflat && q < nflat + 3) {
            const int k = (int)(q - nflat);
            v = k == 0 ? half + 1 : k == 1 ? half - 1 : half;
        }
        e[i] = v;
    }
    __syncthreads();
    if (tlf && threadIdx.x == 0)
        e[C] = ((e[C - 1] + e[C + 1]) * 5 + e[C] * 6 + 8) >> 4;
    __syncthreads();

    auto store = [&](int y, int x, int v) {
        if (py + y < H && px + x < W)
            plane[(size_t)(py + y) * W + px + x] = v;
    };

    if (fam == FAM_S) {
        const int mode = p0;
        int dc = 0;
        if (mode == DC_PRED || mode == TOP_DC_PRED ||
            mode == LEFT_DC_PRED || mode == DC_128_PRED)
            dc = dc_value(e, mode, w, h, bd, red);
        const int right = e[C + w], bottom = e[C - h], tl = e[C];
        for (int k = threadIdx.x; k < w * h; k += THREADS) {
            const int y = k >> lw, x = k & (w - 1);
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
                const int wv = smw[h + y], wh = smw[w + x];
                v = (wv * top + (256 - wv) * bottom + wh * left +
                     (256 - wh) * right + 256) >> 9;
                break;
            }
            case SMOOTH_V_PRED: {
                const int wv = smw[h + y];
                v = (wv * top + (256 - wv) * bottom + 128) >> 8;
                break;
            }
            case SMOOTH_H_PRED: {
                const int wh = smw[w + x];
                v = (wh * left + (256 - wh) * right + 128) >> 8;
                break;
            }
            default: v = dc;
            }
            store(y, x, v);
        }
    } else if (fam == FAM_Z1) {
        const int dx = p0, st = p1, up = p2, wmin = min(w, h);
        int L, max_base, inc;
        if (up) {
            upsample_edge(t, e, C + 1, w + h, -1, w + wmin, bdmax,
                          2 * (w + h));
            L = 2 * (w + h);
            max_base = 2 * (w + h) - 2;
            inc = 2;
        } else {
            L = w + h;
            inc = 1;
            if (st) {
                filter_edge(t, e, C + 1, w + h, -1, w + wmin, 0, w + h, st);
                max_base = w + h - 1;
            } else {
                for (int i = threadIdx.x; i < L; i += THREADS)
                    t[i] = e[C + 1 + min(i, w + wmin - 1)];
                max_base = w + wmin - 1;
            }
        }
        __syncthreads();
        for (int k = threadIdx.x; k < w * h; k += THREADS) {
            const int y = k >> lw, x = k & (w - 1);
            const int xpos = dx * (y + 1), frac = xpos & 0x3E;
            const int base = (xpos >> 6) + x * inc;
            const int v = base < max_base
                ? (t[base] * (64 - frac) + t[min(base + 1, L - 1)] * frac +
                   32) >> 6
                : t[max_base];
            store(y, x, v);
        }
    } else if (fam == FAM_Z3) {
        const int dy = p0, st = p1, up = p2, wmin = min(w, h);
        const int base0 = C - (w + h), sfrom = max(w - h, 0);
        int L, anchor, max_base;
        if (up) {
            upsample_edge(t, e, base0, w + h, sfrom, w + h + 1, bdmax,
                          2 * (w + h));
            L = 2 * (w + h);
            anchor = max_base = 2 * (w + h) - 2;
        } else {
            L = w + h;
            anchor = w + h - 1;
            if (st) {
                filter_edge(t, e, base0, w + h, sfrom, w + h + 1, 0, w + h,
                            st);
                max_base = w + h - 1;
            } else {
                for (int i = threadIdx.x; i < L; i += THREADS)
                    t[i] = e[base0 + i];
                max_base = h + wmin - 1;
            }
        }
        __syncthreads();
        const int last = t[clampi(anchor - max_base, 0, L - 1)];
        for (int k = threadIdx.x; k < w * h; k += THREADS) {
            const int y = k >> lw, x = k & (w - 1);
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
        const int dx = p0, dy = p1, st_t = p2, st_l = p3, max_w = p4,
                  max_h = p5, ua = p6, ul = p7;
        for (int i = threadIdx.x; i < BL; i += THREADS) t[i] = 0;
        __syncthreads();
        if (ua)
            upsample_edge(t + C2, e, C, w + 1, 0, w + 1, bdmax, 2 * w + 1);
        else if (st_t)
            filter_edge(t + C2 + 1, e, C + 1, w, -1, w, 0, max_w, st_t);
        else
            for (int i = threadIdx.x; i < w; i += THREADS)
                t[C2 + 1 + i] = e[C + 1 + i];
        if (ul)
            upsample_edge(t + C2 - 2 * h, e, C - h, h + 1, 0, h + 1, bdmax,
                          2 * h + 1);
        else if (st_l)
            filter_edge(t + C2 - h, e, C - h, h, 0, h + 1, h - max_h, h,
                        st_l);
        else
            for (int i = threadIdx.x; i < h; i += THREADS)
                t[C2 - h + i] = e[C - h + i];
        __syncthreads();
        if (threadIdx.x == 0) t[C2] = e[C];
        __syncthreads();
        for (int k = threadIdx.x; k < w * h; k += THREADS) {
            const int y = k >> lw, x = k & (w - 1);
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
        const int32_t *tp = taps + (size_t)clampi(p0, 0, 4) * 56;
        const int nbx = w >> 2, nby = h >> 1;
        for (int s = 0; s < nbx + nby - 1; s++) {
            const int r = threadIdx.x, c = s - r;
            if (r < nby && c >= 0 && c < nbx) {
                const int y = 2 * r, x = 4 * c;
                int p[7];
                if (y == 0) {
                    for (int j = 0; j < 5; j++) p[j] = e[C + x + j];
                } else {
                    p[0] = x ? o[(y - 1) * w + x - 1] : e[C - y];
                    for (int j = 0; j < 4; j++)
                        p[1 + j] = o[(y - 1) * w + x + j];
                }
                if (x) {
                    p[5] = o[y * w + x - 1];
                    p[6] = o[(y + 1) * w + x - 1];
                } else {
                    p[5] = e[C - (y + 1)];
                    p[6] = e[C - (y + 2)];
                }
                for (int fi = 0; fi < 8; fi++) {
                    int acc = 8;
                    for (int j = 0; j < 7; j++) acc += tp[fi * 7 + j] * p[j];
                    o[(y + (fi >> 2)) * w + x + (fi & 3)] =
                        clampi(acc >> 4, 0, bdmax);
                }
            }
            __syncthreads();
        }
        for (int k = threadIdx.x; k < w * h; k += THREADS)
            store(k >> lw, k & (w - 1), o[k]);
    } else {                            // FAM_CFL
        const int ypy = p0, ypx = p1, nh = p2, nw = p3, alpha = p4,
                  mode = p5;
        const int32_t *Y = P.p[0];
        const int YW = P.W[0];
        const int shift = 1 + !ss_ver + !ss_hor;
        int part = 0;
        for (int k = threadIdx.x; k < w * h; k += THREADS) {
            const int bi = min(k >> lw, nh - 1), bj = min(k & (w - 1), nw - 1);
            const int32_t *s = Y + (size_t)(ypy + (bi << ss_ver)) * YW + ypx +
                (bj << ss_hor);
            int a = s[0];
            if (ss_hor) a += s[1];
            if (ss_ver) {
                a += s[YW];
                if (ss_hor) a += s[YW + 1];
            }
            a <<= shift;
            o[k] = a;
            part += a;
        }
        const int log2sz = lw + log2i(h);
        const int total = (block_sum(part, red) + ((1 << log2sz) >> 1)) >>
            log2sz;
        const int dc = dc_value(e, mode, w, h, bd, red);
        for (int k = threadIdx.x; k < w * h; k += THREADS) {
            const int diff = alpha * (o[k] - total);
            int v = (abs(diff) + 32) >> 6;
            if (diff < 0) v = -v;
            store(k >> lw, k & (w - 1), clampi(dc + v, 0, bdmax));
        }
    }
}

}  // namespace

extern "C" int ipred_ncol() { return NCOL; }

// Launch one level of `n` units on `stream`: planes p0..p2 (int32,
// row-major H x W; p1 and p2 null without chroma), units (n, NCOL), idx
// (m, 321), smw the (128,) smooth weights, taps the (5, 8, 7)
// filter-intra taps, ss_hor / ss_ver the chroma subsampling.
extern "C" int ipred_level(void *p0, void *p1, void *p2, int H0, int W0,
                           int H1, int W1, int H2, int W2,
                           const void *units, int n, const void *idx, int m,
                           const void *smw, const void *taps, int bd,
                           int ss_hor, int ss_ver, void *stream) {
    if (n < 0 || m < 0 || (bd != 8 && bd != 10 && bd != 12) || !p0 ||
        !units || !idx || !smw || !taps || ss_hor < 0 || ss_hor > 1 ||
        ss_ver < 0 || ss_ver > 1)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    Planes P = {{(int32_t *)p0, (int32_t *)p1, (int32_t *)p2},
                {H0, H1, H2},
                {W0, W1, W2}};
    ipred_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
        P, (const int32_t *)units, (const int32_t *)idx, m,
        (const int32_t *)smw, (const int32_t *)taps, bd, ss_hor, ss_ver);
    return (int)cudaGetLastError();
}
