// AV1 film grain synthesis, applied: the grained output copy of a
// frame's luma and both chroma planes in one launch.
//
// Replaces dav1d_tpu/ops/fg.py `_fgy_fn` (fg.py:131) and `_fguv_fn`
// (fg.py:172), the jitted programs the TPU ran per plane; the math is
// the reference's fgy_32x32xn_c / fguv_32x32xn_c
// (src/filmgrain_tmpl.c:169-423), term for term as ops/fg.py
// `fgy_plain` / `fguv_plain` compute it.
//
// Inputs, as the host builds them (ops/fg.py): the clean int32 planes
// (padded; chroma reads the clean luma, never the grained one); the
// (n_rows, n_bx) int32 table of each 32x32 luma block's 8-bit offset
// (the per-32-row LFSR chains; a block's top and top-left offsets are
// the previous row's entries); the grain LUTs, (3, 74, 82) int16 (luma,
// cb, cr) and the scaling LUTs, (3, 2^bd) uint8, kept on the device per
// grain-parameter set. Per plane: grained or copied, and its scaling
// row (chroma reads luma's when chroma scaling comes from luma).
//
// A pixel at (y, x) of a grained plane's visible area, in block (row,
// bx) of (32 >> sy) x (32 >> sx) pixels at (y_in, x_in): its grain is
// LUT[offy(r) + y_in][offx(r) + x_in] for the block's offset r, offx =
// 3 + (2 >> sx)(3 + (r >> 4)), offy = 3 + (2 >> sy)(3 + (r & 15)); with
// overlap, x_in < min(2 >> sx, 2) of a block with bx > 0 blends the
// left block's grain (one block width further right in the LUT) and
// y_in < min(2 >> sy, 2) of a block with row > 0 the top one's (the
// top-left's into the top first), round2(., 5) and clipped to the
// grain range, with W_OVERLAP's weights or, on a subsampled axis,
// W_OVERLAP_SUB's. The noise is round2(scaling[v] * grain,
// scaling_shift), v the source pixel on luma; on chroma the luma at
// (y << sy, x << sx), averaged with its right neighbour when sx, then
// combined with the uv multipliers and offset unless chroma scaling
// comes from luma. Out: clip(src + noise) to the full or restricted
// range (chroma's top 235 or 240 by is_id). Every other pixel of the
// padded planes is the source's.
//
// Bound: memory. Each plane pixel read once and written once, int32: a
// 1080p 4:2:0 frame moves 26.6 MB, 7.9 us at 3.35 TB/s; a few dozen
// integer operations a pixel stay below that. No single PyTorch call
// computes this function: there is no library yardstick.
//
// Design: bytes in flight, and no dependent global round trip. The
// planes are cut into units of one band: 1 << sy luma rows of 128
// columns (32 int4) and the chroma row under them, 128 >> sx columns of
// each chroma plane. Persistent blocks (as many as fit the card at
// once) stage the used scaling rows (3 << bd bytes at most, 768 at
// 8-bit) in shared memory once; then each warp walks the units with a
// stride of the grid's warps. A lane issues all its 16-byte source
// loads of a unit first (its luma int4 of each row, its chroma int4s:
// with sx a half-warp per chroma plane, else both planes a lane), then
// the block offsets and the grain LUT reads of its pixels (read-only
// cache: they do not depend on the source), then shuffles the luma
// pairs that its chroma pixels average from the lanes that loaded them
// (an aligned pair, so the column past an odd width is the luma
// plane's own padding column, as in dav1d_tpu); the scaling lookup,
// which depends on the source, reads shared memory. Every int4 loaded
// is stored once, grained or copied.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 32;                  // luma block side
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNIT_W = 128;             // luma columns of a unit
constexpr int LUT_H = 74, LUT_W = 82;

struct Plane {
    const int32_t *src;
    int32_t *dst;
    int rows, cols;                     // padded shape; cols is the stride
    int apply, scale;                   // grained?; scaling row
};

struct Args {
    Plane pl[3];
    const int32_t *off;
    const int16_t *lut;
    const uint8_t *scal;
    int w, h, cw, ch, n_rows, n_bx, bd, shift;
    int overlap, clip, is_id, csfl, scal_rows;
    int n_bands, n_cols;
    int uv_luma_mult[2], uv_mult[2], uv_offset[2];
};

__device__ __forceinline__ int rnd2(int x, int s) {
    return (x + ((1 << s) >> 1)) >> s;
}

// a block's offset r into the LUT: columns, rows
template <int SX>
__device__ __forceinline__ int offx(int r) {
    return 3 + (2 >> SX) * (3 + (r >> 4));
}

template <int SY>
__device__ __forceinline__ int offy(int r) {
    return 3 + (2 >> SY) * (3 + (r & 15));
}

// chroma plane p (1 or 2) by value: lanes of a warp may differ in p
__device__ __forceinline__ Plane chroma(const Args &a, int p) {
    Plane P;
    P.src = p == 1 ? a.pl[1].src : a.pl[2].src;
    P.dst = p == 1 ? a.pl[1].dst : a.pl[2].dst;
    P.rows = p == 1 ? a.pl[1].rows : a.pl[2].rows;
    P.cols = p == 1 ? a.pl[1].cols : a.pl[2].cols;
    P.apply = p == 1 ? a.pl[1].apply : a.pl[2].apply;
    P.scale = p == 1 ? a.pl[1].scale : a.pl[2].scale;
    return P;
}

__device__ __forceinline__ int4 ld4(const int32_t *p) {
    return __ldg((const int4 *)p);
}

__device__ __forceinline__ int at(const int4 &v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void put(int4 &v, int j, int x) {
    if (j == 0) v.x = x;
    else if (j == 1) v.y = x;
    else if (j == 2) v.z = x;
    else v.w = x;
}

// The offsets of block (row, bx) and, with overlap, of its left, top
// and top-left neighbours (clamped to the table: the values of blocks
// outside the visible area go unused)
__device__ __forceinline__ void offsets(const Args &a, int row, int bx,
                                        int o[4]) {
    row = min(row, a.n_rows - 1);
    bx = min(bx, a.n_bx - 1);
    const int b1 = max(bx - 1, 0), r1 = max(row - 1, 0);
    o[0] = __ldg(a.off + row * a.n_bx + bx);
    o[1] = a.overlap ? __ldg(a.off + row * a.n_bx + b1) : 0;
    o[2] = a.overlap ? __ldg(a.off + r1 * a.n_bx + bx) : 0;
    o[3] = a.overlap ? __ldg(a.off + r1 * a.n_bx + b1) : 0;
}

__device__ __forceinline__ int blend(int a, int b, int wa, int wb, int ctr) {
    return min(max(rnd2(a * wa + b * wb, 5), -ctr), ctr - 1);
}

// The grain of 4 neighbouring pixels at (y_in, x_in .. x_in + 3) of a
// block of plane `lut` with offsets o (x_in a multiple of 4): left, a
// block to the left to blend (overlap and bx > 0); ym, the top block's
// rows to blend (overlap, row > 0 and y_in < min(2 >> SY, 2): the same
// for a whole unit, so no lane of a warp waits on another). The LUT
// reads are issued together and depend on the offsets only.
template <int SX, int SY>
__device__ __forceinline__ void grain_quad(const int16_t *lut, const int o[4],
                                           int y_in, int x_in, bool left,
                                           bool ym, int ctr, int g[4]) {
    constexpr int bsx = BS >> SX, bsy = BS >> SY;
    constexpr int xo = SX ? 1 : 2;              // min(2 >> SX, 2)
    const bool xm = left && x_in == 0;
    const int16_t *m = lut + (offy<SY>(o[0]) + y_in) * LUT_W +
                       offx<SX>(o[0]) + x_in;
    const int16_t *l = lut + (offy<SY>(o[1]) + y_in) * LUT_W +
                       offx<SX>(o[1]) + bsx;
    int v[4], lv[xo];
#pragma unroll
    for (int j = 0; j < 4; j++) v[j] = __ldg(m + j);
#pragma unroll
    for (int j = 0; j < xo; j++) lv[j] = xm ? __ldg(l + j) : 0;
    // W_OVERLAP ((27, 17), (17, 27)) or W_OVERLAP_SUB ((23, 22))
    if (!ym) {
#pragma unroll
        for (int j = 0; j < 4; j++)
            g[j] = j < xo && xm ? blend(lv[j], v[j], SX ? 23 : (j ? 17 : 27),
                                        SX ? 22 : (j ? 27 : 17), ctr)
                                : v[j];
        return;
    }
    const int16_t *t = lut + (offy<SY>(o[2]) + y_in + bsy) * LUT_W +
                       offx<SX>(o[2]) + x_in;
    const int16_t *tl = lut + (offy<SY>(o[3]) + y_in + bsy) * LUT_W +
                        offx<SX>(o[3]) + bsx;
    int tv[4], tlv[xo];
#pragma unroll
    for (int j = 0; j < 4; j++) tv[j] = __ldg(t + j);
#pragma unroll
    for (int j = 0; j < xo; j++) tlv[j] = xm ? __ldg(tl + j) : 0;
    const int wy0 = SY ? 23 : (y_in ? 17 : 27);
    const int wy1 = SY ? 22 : (y_in ? 27 : 17);
#pragma unroll
    for (int j = 0; j < 4; j++) {
        int g1 = v[j], t1 = tv[j];
        if (j < xo && xm) {
            const int wx0 = SX ? 23 : (j ? 17 : 27);
            const int wx1 = SX ? 22 : (j ? 27 : 17);
            g1 = blend(lv[j], v[j], wx0, wx1, ctr);
            t1 = blend(tlv[j], tv[j], wx0, wx1, ctr);
        }
        g[j] = blend(t1, g1, wy0, wy1, ctr);
    }
}

template <int SX, int SY, int NP>
__global__ void __launch_bounds__(THREADS)
film_grain_kernel(const __grid_constant__ Args a) {
    extern __shared__ uint8_t s_scal[];         // scal_rows << bd bytes
    const int n_scal = a.scal_rows << a.bd;
    for (int i = threadIdx.x; i < n_scal; i += THREADS)
        s_scal[i] = a.scal[i];
    __syncthreads();
    constexpr int LR = 1 << SY;                 // luma rows of a unit
    constexpr int NC = NP == 3 ? (SX ? 1 : 2) : 0;  // chroma int4s a lane
    const int lane = threadIdx.x & 31;
    const int bdm8 = a.bd - 8;
    const int px_max = (1 << a.bd) - 1;
    const int n_units = a.n_bands * a.n_cols;
    const int stride = gridDim.x * WARPS;
    for (int u = blockIdx.x * WARPS + (threadIdx.x >> 5); u < n_units;
         u += stride) {
        const int k = u / a.n_cols, c = u - k * a.n_cols;
        // the unit's source loads, all issued before any is used
        const Plane &P0 = a.pl[0];
        const int xl = c * UNIT_W + 4 * lane;
        int4 L[LR];
        bool lin[LR];
#pragma unroll
        for (int dy = 0; dy < LR; dy++) {
            const int y = (k << SY) + dy;
            lin[dy] = y < P0.rows && xl < P0.cols;
            L[dy] = lin[dy] ? ld4(P0.src + (size_t)y * P0.cols + xl)
                            : make_int4(0, 0, 0, 0);
        }
        int4 C[NC > 0 ? NC : 1];
        bool cin[NC > 0 ? NC : 1];
        int cp[NC > 0 ? NC : 1], xc[NC > 0 ? NC : 1];
#pragma unroll
        for (int j = 0; j < NC; j++) {
            cp[j] = SX ? 1 + (lane >> 4) : 1 + j;
            xc[j] = SX ? c * (UNIT_W >> 1) + 4 * (lane & 15)
                       : c * UNIT_W + 4 * lane;
            const Plane P = chroma(a, cp[j]);
            cin[j] = k < P.rows && xc[j] < P.cols;
            C[j] = cin[j] ? ld4(P.src + (size_t)k * P.cols + xc[j])
                          : make_int4(0, 0, 0, 0);
        }
        // the grain of the unit's pixels, from the LUTs only: issued
        // while the source loads are in flight (for every quad, visible
        // or not: the offsets are clamped into the table)
        const int yl0 = k << SY, brow = yl0 >> 5;
        const bool ym = a.overlap && brow > 0 && (yl0 & 31) < 2;
        const int ctr = 128 << bdm8;
        int ol[4];
        offsets(a, brow, xl >> 5, ol);
        int gl[LR][4], nl[LR];
#pragma unroll
        for (int dy = 0; dy < LR; dy++) {
            const int y = yl0 + dy;
            nl[dy] = lin[dy] && P0.apply && y < a.h && xl < a.w
                     ? min(4, a.w - xl) : 0;
            grain_quad<0, 0>(a.lut, ol, y & 31, xl & 31,
                             a.overlap && xl >= BS, ym, ctr, gl[dy]);
        }
        int gc[NC > 0 ? NC : 1][4], nc[NC > 0 ? NC : 1];
        if constexpr (NC > 0) {
            constexpr int bsx = BS >> SX, bsy = BS >> SY;
            int oc[4];
            if constexpr (SX > 0) {
                offsets(a, brow, xc[0] / bsx, oc);
            } else {
#pragma unroll
                for (int i = 0; i < 4; i++) oc[i] = ol[i];
            }
#pragma unroll
            for (int j = 0; j < NC; j++) {
                const int apply = cp[j] == 1 ? a.pl[1].apply
                                             : a.pl[2].apply;
                nc[j] = cin[j] && apply && k < a.ch && xc[j] < a.cw
                        ? min(4, a.cw - xc[j]) : 0;
                grain_quad<SX, SY>(a.lut + cp[j] * LUT_H * LUT_W, oc,
                                   k & (bsy - 1), xc[j] & (bsx - 1),
                                   a.overlap && xc[j] >= bsx, ym, ctr,
                                   gc[j]);
            }
        }
        // luma: the noise of the source
#pragma unroll
        for (int dy = 0; dy < LR; dy++) {
            if (!lin[dy]) continue;
            int4 o = L[dy];
            if (nl[dy]) {
                const uint8_t *sc = s_scal + (P0.scale << a.bd);
                const int mn = a.clip ? 16 << bdm8 : 0;
                const int mx = a.clip ? 235 << bdm8 : px_max;
#pragma unroll
                for (int j = 0; j < 4; j++) {
                    if (j >= nl[dy]) break;
                    const int sv = at(o, j);
                    const int noise = rnd2(
                        (int)sc[min(max(sv, 0), px_max)] * gl[dy][j],
                        a.shift);
                    put(o, j, min(max(sv + noise, mn), mx));
                }
            }
            *(int4 *)(P0.dst + (size_t)((k << SY) + dy) * P0.cols + xl) = o;
        }
        if constexpr (NC == 0) continue;
        // chroma: the luma under each pixel, row k << SY
        int lum[4][2];
        if constexpr (SX > 0) {
            const int q = lane & 15;
            // chroma columns 4q .. 4q + 3 average luma columns 8q .. 8q
            // + 7: lane 2q's int4, then lane 2q + 1's
#pragma unroll
            for (int h = 0; h < 2; h++) {
                const int src = 2 * q + h;
                lum[2 * h][0] = __shfl_sync(0xffffffffu, L[0].x, src);
                lum[2 * h][1] = __shfl_sync(0xffffffffu, L[0].y, src);
                lum[2 * h + 1][0] = __shfl_sync(0xffffffffu, L[0].z, src);
                lum[2 * h + 1][1] = __shfl_sync(0xffffffffu, L[0].w, src);
            }
        } else {
#pragma unroll
            for (int j = 0; j < 4; j++) {
                lum[j][0] = at(L[0], j);
                lum[j][1] = 0;
            }
        }
#pragma unroll
        for (int j = 0; j < NC; j++) {
            if (!cin[j]) continue;
            const int p = cp[j];
            const Plane P = chroma(a, p);
            int4 o = C[j];
            if (nc[j]) {
                const int ulm = p == 1 ? a.uv_luma_mult[0]
                                       : a.uv_luma_mult[1];
                const int um = p == 1 ? a.uv_mult[0] : a.uv_mult[1];
                const int uo = p == 1 ? a.uv_offset[0] : a.uv_offset[1];
                const uint8_t *sc = s_scal + (P.scale << a.bd);
                const int mn = a.clip ? 16 << bdm8 : 0;
                const int mx = a.clip ? (a.is_id ? 235 : 240) << bdm8
                                      : px_max;
#pragma unroll
                for (int i = 0; i < 4; i++) {
                    if (i >= nc[j]) break;
                    const int sv = at(o, i);
                    const int avg = SX ? (lum[i][0] + lum[i][1] + 1) >> 1
                                       : lum[i][0];
                    int v = avg;
                    if (!a.csfl) {
                        const int cmb = avg * ulm + sv * um;
                        v = min(max((cmb >> 6) + uo * (1 << bdm8), 0),
                                px_max);
                    }
                    const int noise = rnd2(
                        (int)sc[min(max(v, 0), px_max)] * gc[j][i],
                        a.shift);
                    put(o, i, min(max(sv + noise, mn), mx));
                }
            }
            *(int4 *)(P.dst + (size_t)k * P.cols + xc[j]) = o;
        }
    }
}

template <int SX, int SY, int NP>
int launch(const Args &a, cudaStream_t stream, int *per_sm_out, int *sms_out) {
    static int blocks[64];              // resident blocks per device
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    const size_t smem = (size_t)3 << 12;        // the most scal_rows << bd
    if (!blocks[dev] || per_sm_out) {
        int per_sm = 0, sms = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, film_grain_kernel<SX, SY, NP>, THREADS, smem);
        const int rc = (int)cudaGetLastError();
        if (rc) return rc;
        if (per_sm < 1 || sms < 1) return (int)cudaErrorInvalidConfiguration;
        blocks[dev] = per_sm * sms;
        if (per_sm_out) {
            *per_sm_out = per_sm;
            *sms_out = sms;
            return 0;
        }
    }
    const long long need = ((long long)a.n_bands * a.n_cols + WARPS - 1) /
                           WARPS;          // a warp a unit at most
    const int grid = (int)(need < blocks[dev] ? need : blocks[dev]);
    film_grain_kernel<SX, SY, NP><<<grid, THREADS,
                                    (size_t)a.scal_rows << a.bd, stream>>>(a);
    return (int)cudaGetLastError();
}

int dispatch(const Args &a, int np, int sx, int sy, cudaStream_t stream,
             int *per_sm, int *sms) {
    if (np == 1) return launch<0, 0, 1>(a, stream, per_sm, sms);
    if (sx && sy) return launch<1, 1, 3>(a, stream, per_sm, sms);
    if (sx) return launch<1, 0, 3>(a, stream, per_sm, sms);
    if (!sy) return launch<0, 0, 3>(a, stream, per_sm, sms);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// The persistent grid of the current device for np planes subsampled
// by (sx, sy): blocks a SM and SMs.
extern "C" int film_grain_occupancy(int np, int sx, int sy, int *per_sm,
                                    int *sms) {
    Args a = {};
    return dispatch(a, np, sx, sy, nullptr, per_sm, sms);
}

// Launch the grain of np (1 or 3) planes on `stream`. ptrs: per plane p
// src, dst at ptrs[2 p ..] (int32, padded, row stride = columns, a
// multiple of 4; 16-byte aligned), then the offsets (n_rows, n_bx)
// int32, the grain LUTs (3, 74, 82) int16 and the scaling LUTs
// (3, 2^bd) uint8. dims: per plane rows, cols, apply, scaling row at
// dims[4 p ..]; then np, w, h (visible luma), n_rows, n_bx, sx, sy, bd,
// scaling_shift, overlap, clip_range, is_id, csfl, uv_luma_mult[2],
// uv_mult[2], uv_offset[2].
extern "C" int film_grain(const void *const *ptrs, const int *dims,
                          void *stream) {
    Args a = {};
    const int *d = dims + 12;
    const int np = d[0];
    a.w = d[1];
    a.h = d[2];
    a.n_rows = d[3];
    a.n_bx = d[4];
    // a single plane is luma: no subsampling
    const int sx = np == 3 ? d[5] : 0, sy = np == 3 ? d[6] : 0;
    a.bd = d[7];
    a.shift = d[8];
    a.overlap = d[9];
    a.clip = d[10];
    a.is_id = d[11];
    a.csfl = d[12];
    for (int k = 0; k < 2; k++) {
        a.uv_luma_mult[k] = d[13 + k];
        a.uv_mult[k] = d[15 + k];
        a.uv_offset[k] = d[17 + k];
    }
    if ((np != 1 && np != 3) || a.w < 1 || a.h < 1 ||
        (a.bd != 8 && a.bd != 10 && a.bd != 12) || sx < 0 || sx > 1 ||
        sy < 0 || sy > 1 || (sy && !sx) ||
        a.shift < 8 || a.shift > 11 ||
        a.n_rows != (a.h + BS - 1) / BS || a.n_bx != (a.w + BS - 1) / BS)
        return (int)cudaErrorInvalidValue;
    a.cw = (a.w + sx) >> sx;
    a.ch = (a.h + sy) >> sy;
    a.scal_rows = 1;
    for (int p = 0; p < np; p++) {
        Plane &P = a.pl[p];
        P.src = (const int32_t *)ptrs[2 * p];
        P.dst = (int32_t *)ptrs[2 * p + 1];
        P.rows = dims[4 * p];
        P.cols = dims[4 * p + 1];
        P.apply = dims[4 * p + 2];
        P.scale = dims[4 * p + 3];
        if (!P.src || !P.dst || P.rows < (p ? a.ch : a.h) ||
            P.cols < (p ? a.cw : a.w) || P.scale < 0 || P.scale > 2 ||
            (P.cols & 3) || ((uintptr_t)P.src & 15) ||
            ((uintptr_t)P.dst & 15))
            return (int)cudaErrorInvalidValue;
        if (P.apply) a.scal_rows = max(a.scal_rows, P.scale + 1);
        // units: bands of 1 << sy luma rows over the chroma rows, and
        // columns of 128 luma (128 >> sx chroma) columns
        const int ur = p ? P.rows : (P.rows + (1 << sy) - 1) >> sy;
        const int uc = (P.cols + (UNIT_W >> (p ? sx : 0)) - 1) /
                       (UNIT_W >> (p ? sx : 0));
        a.n_bands = max(a.n_bands, ur);
        a.n_cols = max(a.n_cols, uc);
    }
    // chroma's luma reads: rows y << sy, columns (x << sx) + sx
    if (np == 3 && (a.pl[0].rows < (a.ch << sy) ||
                    a.pl[0].cols < (a.cw << sx)))
        return (int)cudaErrorInvalidValue;
    a.off = (const int32_t *)ptrs[6];
    a.lut = (const int16_t *)ptrs[7];
    a.scal = (const uint8_t *)ptrs[8];
    if (!a.off || !a.lut || !a.scal) return (int)cudaErrorInvalidValue;
    return dispatch(a, np, sx, sy, (cudaStream_t)stream, nullptr, nullptr);
}
