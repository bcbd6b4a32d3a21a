// AV1 CDEF of a whole frame: every plane in one launch.
//
// Replaces dav1d_tpu/ops/cdef.py `_cdef_fn` (cdef.py:59), the jitted
// frame program the TPU ran every frame; the math is the reference's
// cdef_find_dir_c and cdef_filter_block_c (src/cdef_tmpl.c:105-305)
// with the strength adjust of cdef_apply_tmpl.c:91-97, term by term as
// ops/cdef.py `cdef_frame_plain` computes it.
//
// Input: the deblocked planes (full padded pictures, int32), the luma
// crop Hy x Wy (the frame's 4x4 grid, bh*4 x bw*4; chroma Hy >> ss_ver
// x Wy >> ss_hor) and per-8x8-luma-block int32 maps (6, nby, nbx):
// y_pri, y_sec, uv_pri, uv_sec (strengths already << bd - 8), y_apply,
// uv_apply. Output: fresh planes written whole: the filtered crop, and
// the input copied through outside it. Taps outside the crop read the
// FILL sentinel (-32768), as the reference's padding does. Input and
// output never alias: every tap reads unfiltered pixels.
//
// Design. One block of 256 threads per 64x64 luma tile (and its
// co-located chroma tiles). (1) The tile's luma plus a 2-pixel apron
// goes to shared memory as int16 (pixels < 2^12 and FILL both fit):
// 68 x 68 x 2 = 9248 bytes. (2) 64 threads each search one 8x8 block's
// direction from registers (the 90 partial sums of cdef_find_dir, the
// costs in int32: at most ~8.8e8) and set the block's luma and chroma
// parameters: the variance-adjusted primary strength, the direction
// (0 where the primary strength of the plane is 0), and whether the
// block filters. The search runs for every block: chroma takes its
// direction from it even where luma's primary strength is 0. (3) Every
// thread filters 16 luma pixels from the window. (4) For each chroma
// plane the window is restaged and filtered with the luma block's
// direction through the layout's UV_DIRS, damping - 1.
//
// Bound: memory or integer operations, by how much of the frame
// filters. Each int32 pixel read and written once and the maps read
// once: a 1080p 4:2:0 frame moves ~25 MB, ~7.5 us at 3.35 TB/s. A
// filtered pixel takes 12 taps of ~10 integer ops (~0.37 G ops a
// 1080p 4:2:0 frame, ~11 us at 33.5 TOP/s if every block filters), a
// block's direction search ~1.5k.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                 // luma tile side
constexpr int APRON = 2;
constexpr int WS = TILE + 2 * APRON;     // window side and row stride
constexpr int THREADS = 256;
constexpr int NB = (TILE / 8) * (TILE / 8);  // 8x8 blocks of a tile
constexpr int FILL = -32768;
enum { M_YPRI, M_YSEC, M_UVPRI, M_UVSEC, M_YAPPLY, M_UVAPPLY };

__constant__ int c_dirs[12 * 2 * 2];     // (dy, dx) of dav1d_cdef_directions
__constant__ int c_uv_dirs[2 * 8];       // UV_DIRS: 4:2:0/4:4:4, 4:2:2

struct Args {
    const int32_t *src[3];
    int32_t *dst[3];
    int h[3], w[3];         // plane shapes (row stride w)
    int n;                  // planes: 1 or 3
    int Hy, Wy;             // luma crop
    int nby, nbx;
    int ss_ver, ss_hor, uv422;
    int bd, damping;
    const int32_t *maps;    // (6, nby, nbx)
    int tiles_x;
};

__device__ __forceinline__ int ulog2c(int v, int cap) {
    // floor(log2(v)) for v >= 1, 0 for v <= 0, at most cap
    int l = v > 0 ? 31 - __clz(v) : 0;
    return l < cap ? l : cap;
}

__device__ __forceinline__ int constrain(int diff, int threshold,
                                         int shift) {
    int adiff = diff < 0 ? -diff : diff;
    int t = threshold - (adiff >> shift);
    int v = min(adiff, t > 0 ? t : 0);
    return diff < 0 ? -v : v;
}

// one pixel of cdef_filter_block_c: win points at the pixel in a
// window of row stride WS
__device__ __forceinline__ int filter_px(const int16_t *win, int px,
                                         int pri, int sec, int dir,
                                         int damp, int bdm8,
                                         const int *dirs) {
    const bool mm = pri != 0 && sec != 0;
    int sum = 0, mn = px, mx = px;
    int pri_tap = 4 - ((pri >> bdm8) & 1);
    const int pri_shift = max(0, damp - ulog2c(max(pri, 1), 10));
    const int sec_shift = damp - ulog2c(max(sec, 1), 10);
#pragma unroll
    for (int k = 0; k < 2; k++) {
        const int dy = dirs[((2 + dir) * 2 + k) * 2];
        const int dx = dirs[((2 + dir) * 2 + k) * 2 + 1];
        const int s0 = win[dy * WS + dx], s1 = win[-dy * WS - dx];
        sum += pri_tap * (constrain(s0 - px, pri, pri_shift) +
                          constrain(s1 - px, pri, pri_shift));
        if (mm) {
            if (s0 != FILL && s0 < mn) mn = s0;
            if (s1 != FILL && s1 < mn) mn = s1;
            mx = max(mx, max(s0, s1));
        }
        pri_tap = (pri_tap & 3) | 2;
    }
#pragma unroll
    for (int k = 0; k < 2; k++) {
        const int sec_tap = 2 - k;
#pragma unroll
        for (int b = 0; b < 2; b++) {
            const int base = b == 0 ? 4 : 0;
            const int dy = dirs[((base + dir) * 2 + k) * 2];
            const int dx = dirs[((base + dir) * 2 + k) * 2 + 1];
            const int s0 = win[dy * WS + dx], s1 = win[-dy * WS - dx];
            sum += sec_tap * (constrain(s0 - px, sec, sec_shift) +
                              constrain(s1 - px, sec, sec_shift));
            if (mm) {
                if (s0 != FILL && s0 < mn) mn = s0;
                if (s1 != FILL && s1 < mn) mn = s1;
                mx = max(mx, max(s0, s1));
            }
        }
    }
    int res = px + ((sum - (sum < 0) + 8) >> 4);
    if (mm) res = min(max(res, mn), mx);
    return res;
}

// cdef_find_dir_c on the 8x8 block at blk (row stride WS): direction
// and variance
__device__ void find_dir(const int16_t *blk, int bdm8, int *dir_out,
                         int *var_out) {
    int hv[2][8], diag[2][15], alt[4][11];
#pragma unroll
    for (int i = 0; i < 8; i++) hv[0][i] = hv[1][i] = 0;
#pragma unroll
    for (int i = 0; i < 15; i++) diag[0][i] = diag[1][i] = 0;
#pragma unroll
    for (int i = 0; i < 11; i++)
        alt[0][i] = alt[1][i] = alt[2][i] = alt[3][i] = 0;
#pragma unroll
    for (int y = 0; y < 8; y++) {
#pragma unroll
        for (int x = 0; x < 8; x++) {
            const int p = (blk[y * WS + x] >> bdm8) - 128;
            diag[0][y + x] += p;
            alt[0][y + (x >> 1)] += p;
            hv[0][y] += p;
            alt[1][3 + y - (x >> 1)] += p;
            diag[1][7 + y - x] += p;
            alt[2][3 - (y >> 1) + x] += p;
            hv[1][x] += p;
            alt[3][(y >> 1) + x] += p;
        }
    }
    const int div_table[7] = {840, 420, 280, 210, 168, 140, 120};
    int cost[8];
    cost[2] = cost[6] = 0;
#pragma unroll
    for (int n = 0; n < 8; n++) {
        cost[2] += hv[0][n] * hv[0][n];
        cost[6] += hv[1][n] * hv[1][n];
    }
    cost[2] *= 105;
    cost[6] *= 105;
    cost[0] = cost[4] = 0;
#pragma unroll
    for (int n = 0; n < 7; n++) {
        const int d = div_table[n];
        cost[0] += (diag[0][n] * diag[0][n] +
                    diag[0][14 - n] * diag[0][14 - n]) * d;
        cost[4] += (diag[1][n] * diag[1][n] +
                    diag[1][14 - n] * diag[1][14 - n]) * d;
    }
    cost[0] += diag[0][7] * diag[0][7] * 105;
    cost[4] += diag[1][7] * diag[1][7] * 105;
#pragma unroll
    for (int n = 0; n < 4; n++) {
        int c = 0;
#pragma unroll
        for (int m = 0; m < 5; m++) c += alt[n][3 + m] * alt[n][3 + m];
        c *= 105;
#pragma unroll
        for (int m = 0; m < 3; m++) {
            const int d = div_table[2 * m + 1];
            c += (alt[n][m] * alt[n][m] + alt[n][10 - m] * alt[n][10 - m])
                * d;
        }
        cost[n * 2 + 1] = c;
    }
    int best = 0, best_cost = cost[0];
#pragma unroll
    for (int d = 1; d < 8; d++) {
        if (cost[d] > best_cost) {
            best = d;
            best_cost = cost[d];
        }
    }
    *dir_out = best;
    *var_out = (best_cost - cost[best ^ 4]) >> 10;
}

// stage the window of the plane's tile at (y0, x0) (its origin, apron
// excluded), rows x cols of it: crop pixels, FILL outside the crop
__device__ void stage(int16_t *win, const int32_t *src, int stride,
                      int ch, int cw, int y0, int x0, int rows,
                      int cols) {
    for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
        const int r = i / cols, c = i - r * cols;
        const int y = y0 - APRON + r, x = x0 - APRON + c;
        win[r * WS + c] = (y >= 0 && y < ch && x >= 0 && x < cw)
            ? (int16_t)src[(size_t)y * stride + x] : (int16_t)FILL;
    }
}

__global__ void __launch_bounds__(THREADS)
cdef_kernel(const __grid_constant__ Args a) {
    __shared__ int16_t s_win[WS * WS];
    __shared__ int s_dirs[12 * 2 * 2];
    __shared__ int s_uv_dirs[8];
    // per 8x8 block: luma (primary, secondary, direction, on) and
    // chroma (the same); off blocks copy their pixels through
    __shared__ int s_y[NB][4], s_uv[NB][4];
    const int tid = threadIdx.x;
    const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x % a.tiles_x;
    const int bdm8 = a.bd - 8;
    if (tid < 12 * 2 * 2) s_dirs[tid] = c_dirs[tid];
    if (tid < 8) s_uv_dirs[tid] = c_uv_dirs[a.uv422 * 8 + tid];
    stage(s_win, a.src[0], a.w[0], a.Hy, a.Wy, ty * TILE, tx * TILE,
          TILE + 2 * APRON, TILE + 2 * APRON);
    __syncthreads();

    if (tid < NB) {
        const int by = ty * 8 + (tid >> 3), bx = tx * 8 + (tid & 7);
        int y[4] = {0, 0, 0, 0}, uv[4] = {0, 0, 0, 0};
        if (by < a.nby && bx < a.nbx) {
            int dir, var;
            find_dir(s_win + (APRON + (tid >> 3) * 8) * WS + APRON +
                     (tid & 7) * 8, bdm8, &dir, &var);
            const size_t plane = (size_t)a.nby * a.nbx;
            const int32_t *m = a.maps + (size_t)by * a.nbx + bx;
            const int y_pri = m[M_YPRI * plane];
            const int t = var >> 6;
            const int i = t ? ulog2c(min(t, 1 << 12), 12) : 0;
            int adj = (y_pri * (4 + i) + 8) >> 4;
            adj = (var != 0 && y_pri != 0) ? adj : 0;
            y[0] = adj;
            y[1] = m[M_YSEC * plane];
            y[2] = y_pri != 0 ? dir : 0;
            y[3] = m[M_YAPPLY * plane] != 0 && (adj != 0 || y[1] != 0);
            const int uv_pri = m[M_UVPRI * plane];
            uv[0] = uv_pri;
            uv[1] = m[M_UVSEC * plane];
            uv[2] = uv_pri != 0 ? s_uv_dirs[dir] : 0;
            uv[3] = m[M_UVAPPLY * plane] != 0 && (uv_pri != 0 || uv[1] != 0);
        }
#pragma unroll
        for (int k = 0; k < 4; k++) {
            s_y[tid][k] = y[k];
            s_uv[tid][k] = uv[k];
        }
    }
    __syncthreads();

    for (int p = 0; p < a.n; p++) {
        const int sv = p ? a.ss_ver : 0, sh = p ? a.ss_hor : 0;
        const int th = TILE >> sv, tw = TILE >> sh;
        const int bv = 8 >> sv, bh = 8 >> sh;
        const int ch = a.Hy >> sv, cw = a.Wy >> sh;
        const int y0 = ty * th, x0 = tx * tw;
        if (p) {
            __syncthreads();     // every read of the previous window done
            stage(s_win, a.src[p], a.w[p], ch, cw, y0, x0,
                  th + 2 * APRON, tw + 2 * APRON);
            __syncthreads();
        }
        const int damp = p ? a.damping - 1 : a.damping;
        const int32_t *src = a.src[p];
        int32_t *dst = a.dst[p];
        for (int i = tid; i < th * tw; i += THREADS) {
            const int r = i / tw, c = i - r * tw;
            const int y = y0 + r, x = x0 + c;
            if (y >= a.h[p] || x >= a.w[p]) continue;
            const size_t o = (size_t)y * a.w[p] + x;
            int v;
            if (y < ch && x < cw) {
                const int *bp = p ? s_uv[(r / bv) * 8 + c / bh]
                                  : s_y[(r / bv) * 8 + c / bh];
                const int16_t *wp = s_win + (r + APRON) * WS + c + APRON;
                v = *wp;
                if (bp[3])
                    v = filter_px(wp, v, bp[0], bp[1], bp[2], damp, bdm8,
                                  s_dirs);
            } else {
                v = src[o];
            }
            dst[o] = v;
        }
    }
}

}  // namespace

// Upload the (12, 2, 2) int32 (dy, dx) direction table and the (2, 8)
// int32 UV_DIRS.
extern "C" int cdef_set_tables(const int32_t *dirs, const int32_t *uv) {
    cudaMemcpyToSymbol(c_dirs, dirs, sizeof(int) * 12 * 2 * 2);
    cudaMemcpyToSymbol(c_uv_dirs, uv, sizeof(int) * 2 * 8);
    return (int)cudaGetLastError();
}

// Launch the CDEF of n planes (1: luma only; 3: luma, u, v) on `stream`.
// ptrs[0..n-1] the int32 input planes, ptrs[3..3+n-1] the outputs (same
// shapes, written whole), ptrs[6] the (6, nby, nbx) int32 maps. dims:
// per plane (h, w) at dims[2 i], then Hy, Wy, nby, nbx, layout (1 4:2:0,
// 2 4:2:2, 3 4:4:4; 0 with n = 1), bd, damping at dims[6 ..].
extern "C" int cdef_frame(const void *const *ptrs, const int *dims, int n,
                          void *stream) {
    if (n != 1 && n != 3) return (int)cudaErrorInvalidValue;
    Args a = {};
    a.n = n;
    for (int p = 0; p < n; p++) {
        a.src[p] = (const int32_t *)ptrs[p];
        a.dst[p] = (int32_t *)ptrs[3 + p];
        a.h[p] = dims[2 * p];
        a.w[p] = dims[2 * p + 1];
    }
    a.maps = (const int32_t *)ptrs[6];
    const int *d = dims + 6;
    a.Hy = d[0];
    a.Wy = d[1];
    a.nby = d[2];
    a.nbx = d[3];
    const int layout = d[4];
    a.ss_ver = layout == 1;
    a.ss_hor = layout != 3;
    a.uv422 = layout == 2;
    a.bd = d[5];
    a.damping = d[6];
    // tiles over every plane's padded area
    int ty = 0, tx = 0;
    for (int p = 0; p < n; p++) {
        const int sv = p ? a.ss_ver : 0, sh = p ? a.ss_hor : 0;
        ty = max(ty, (a.h[p] + (TILE >> sv) - 1) / (TILE >> sv));
        tx = max(tx, (a.w[p] + (TILE >> sh) - 1) / (TILE >> sh));
    }
    a.tiles_x = tx;
    if (ty * tx > 0)
        cdef_kernel<<<ty * tx, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
