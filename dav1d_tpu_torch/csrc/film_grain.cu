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
// Design. One block of 256 threads per 32x32 luma block of the padded
// luma plane and its (32 >> sy) x (32 >> sx) chroma blocks: the block's
// four offsets are read once, a warp covers a row of 32 luma pixels
// (coalesced), and the LUTs are read through the read-only cache (a
// LUT is 12 KB; a block touches a 32x34 window of each). Nothing is
// staged: each pixel is read and written once.
//
// Bound: memory. Each source pixel read once (the chroma's luma average
// reads the luma its own block has just read, from cache) and each
// output written once, int32: a 1080p 4:2:0 frame moves about 27 MB,
// some 8 us at 3.35 TB/s; a few dozen integer operations a pixel stay
// below that. No single PyTorch call computes this function: there is
// no library yardstick.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 32;                  // luma block side
constexpr int THREADS = 256;
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
    int np, w, h, cw, ch, n_rows, n_bx, sx, sy, bd, shift;
    int overlap, clip, is_id, csfl;
    int uv_luma_mult[2], uv_mult[2], uv_offset[2];
};

__device__ __forceinline__ int rnd2(int x, int s) {
    return (x + ((1 << s) >> 1)) >> s;
}

__device__ __forceinline__ int lut_at(const int16_t *lut, int r, int sx,
                                      int sy, int y, int x) {
    const int offx = 3 + (2 >> sx) * (3 + (r >> 4));
    const int offy = 3 + (2 >> sy) * (3 + (r & 15));
    return __ldg(lut + (offy + y) * LUT_W + offx + x);
}

// the blended grain at (y_in, x_in) of a block: offs = main, left, top,
// top-left offsets; bsx / bsy the block's width / height
__device__ __forceinline__ int grain_at(const int16_t *lut, const int *offs,
                                        int sx, int sy, int bsx, int bsy,
                                        int y_in, int x_in, bool xm, bool ym,
                                        int ctr) {
    const int g = lut_at(lut, offs[0], sx, sy, y_in, x_in);
    if (!xm && !ym) return g;
    // W_OVERLAP ((27, 17), (17, 27)) or W_OVERLAP_SUB ((23, 22))
    const int wx0 = sx ? 23 : (x_in ? 17 : 27);
    const int wx1 = sx ? 22 : (x_in ? 27 : 17);
    const int wy0 = sy ? 23 : (y_in ? 17 : 27);
    const int wy1 = sy ? 22 : (y_in ? 27 : 17);
    int g1 = g;
    if (xm) {
        const int l = lut_at(lut, offs[1], sx, sy, y_in, x_in + bsx);
        g1 = min(max(rnd2(l * wx0 + g * wx1, 5), -ctr), ctr - 1);
    }
    if (!ym) return g1;
    int t1 = lut_at(lut, offs[2], sx, sy, y_in + bsy, x_in);
    if (xm) {
        const int tl = lut_at(lut, offs[3], sx, sy, y_in + bsy, x_in + bsx);
        t1 = min(max(rnd2(tl * wx0 + t1 * wx1, 5), -ctr), ctr - 1);
    }
    return min(max(rnd2(t1 * wy0 + g1 * wy1, 5), -ctr), ctr - 1);
}

__global__ void __launch_bounds__(THREADS)
film_grain_kernel(const __grid_constant__ Args a) {
    const int tid = threadIdx.x;
    const int bx = blockIdx.x, row = blockIdx.y;
    const int bdm8 = a.bd - 8;
    const int ctr = 128 << bdm8;
    const int px_max = (1 << a.bd) - 1;
    int offs[4] = {0, 0, 0, 0};
    if (row < a.n_rows && bx < a.n_bx) {
        const int b1 = max(bx - 1, 0), r1 = max(row - 1, 0);
        offs[0] = a.off[row * a.n_bx + bx];
        offs[1] = a.off[row * a.n_bx + b1];
        offs[2] = a.off[r1 * a.n_bx + bx];
        offs[3] = a.off[r1 * a.n_bx + b1];
    }
    for (int p = 0; p < a.np; p++) {
        const Plane &P = a.pl[p];
        const int sx = p ? a.sx : 0, sy = p ? a.sy : 0;
        const int bsx = BS >> sx, bsy = BS >> sy;
        const int vh = p ? a.ch : a.h, vw = p ? a.cw : a.w;
        const int16_t *lut = a.lut + p * LUT_H * LUT_W;
        const uint8_t *scal = a.scal + (P.scale << a.bd);
        int mn = 0, mx = px_max;
        if (a.clip) {
            mn = 16 << bdm8;
            mx = (p && !a.is_id ? 240 : 235) << bdm8;
        }
        const bool xm_blk = a.overlap && bx > 0;
        const bool ym_blk = a.overlap && row > 0;
        const int xo = min(2 >> sx, 2), yo = min(2 >> sy, 2);
        for (int i = tid; i < bsx * bsy; i += THREADS) {
            const int y_in = i / bsx, x_in = i - y_in * bsx;
            const int y = row * bsy + y_in, x = bx * bsx + x_in;
            if (y >= P.rows || x >= P.cols) continue;
            const size_t at = (size_t)y * P.cols + x;
            const int sv = P.src[at];
            if (!P.apply || y >= vh || x >= vw) {
                P.dst[at] = sv;
                continue;
            }
            const int g = grain_at(lut, offs, sx, sy, bsx, bsy, y_in, x_in,
                                   xm_blk && x_in < xo, ym_blk && y_in < yo,
                                   ctr);
            int v = sv;
            if (p) {
                const int32_t *l = a.pl[0].src + (size_t)(y << sy) *
                                   a.pl[0].cols + (x << sx);
                int avg = l[0];
                if (sx) avg = (avg + l[1] + 1) >> 1;
                v = avg;
                if (!a.csfl) {
                    const int c = avg * a.uv_luma_mult[p - 1] +
                                  sv * a.uv_mult[p - 1];
                    v = min(max((c >> 6) + a.uv_offset[p - 1] * (1 << bdm8),
                                0), px_max);
                }
            }
            const int noise = rnd2((int)__ldg(scal + min(max(v, 0), px_max))
                                   * g, a.shift);
            P.dst[at] = min(max(sv + noise, mn), mx);
        }
    }
}

}  // namespace

// Launch the grain of np (1 or 3) planes on `stream`. ptrs: per plane p
// src, dst at ptrs[2 p ..] (int32, padded, row stride = columns), then
// the offsets (n_rows, n_bx) int32, the grain LUTs (3, 74, 82) int16
// and the scaling LUTs (3, 2^bd) uint8. dims: per plane rows, cols,
// apply, scaling row at dims[4 p ..]; then np, w, h (visible luma),
// n_rows, n_bx, sx, sy, bd, scaling_shift, overlap, clip_range, is_id,
// csfl, uv_luma_mult[2], uv_mult[2], uv_offset[2].
extern "C" int film_grain(const void *const *ptrs, const int *dims,
                          void *stream) {
    Args a = {};
    const int *d = dims + 12;
    a.np = d[0];
    a.w = d[1];
    a.h = d[2];
    a.n_rows = d[3];
    a.n_bx = d[4];
    a.sx = d[5];
    a.sy = d[6];
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
    if ((a.np != 1 && a.np != 3) || a.w < 1 || a.h < 1 ||
        (a.bd != 8 && a.bd != 10 && a.bd != 12) || a.sx < 0 || a.sx > 1 ||
        a.sy < 0 || a.sy > 1 || a.shift < 8 || a.shift > 11 ||
        a.n_rows != (a.h + BS - 1) / BS || a.n_bx != (a.w + BS - 1) / BS)
        return (int)cudaErrorInvalidValue;
    a.cw = (a.w + a.sx) >> a.sx;
    a.ch = (a.h + a.sy) >> a.sy;
    int gx = 0, gy = 0;
    for (int p = 0; p < a.np; p++) {
        Plane &P = a.pl[p];
        P.src = (const int32_t *)ptrs[2 * p];
        P.dst = (int32_t *)ptrs[2 * p + 1];
        P.rows = dims[4 * p];
        P.cols = dims[4 * p + 1];
        P.apply = dims[4 * p + 2];
        P.scale = dims[4 * p + 3];
        const int sx = p ? a.sx : 0, sy = p ? a.sy : 0;
        if (!P.src || !P.dst || P.rows < (p ? a.ch : a.h) ||
            P.cols < (p ? a.cw : a.w) || P.scale < 0 || P.scale > 2)
            return (int)cudaErrorInvalidValue;
        gx = max(gx, (P.cols + (BS >> sx) - 1) / (BS >> sx));
        gy = max(gy, (P.rows + (BS >> sy) - 1) / (BS >> sy));
    }
    // chroma's luma reads: rows y << sy, columns (x << sx) + sx
    if (a.np == 3 && (a.pl[0].rows < (a.ch << a.sy) ||
                      a.pl[0].cols < (a.cw << a.sx)))
        return (int)cudaErrorInvalidValue;
    a.off = (const int32_t *)ptrs[6];
    a.lut = (const int16_t *)ptrs[7];
    a.scal = (const uint8_t *)ptrs[8];
    if (!a.off || !a.lut || !a.scal) return (int)cudaErrorInvalidValue;
    film_grain_kernel<<<dim3(gx, gy), THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
