// AV1 CDEF of a whole frame: every plane in one launch.
//
// Replaces dav1d_tpu/ops/cdef.py `_cdef_fn` (cdef.py:59), the jitted
// frame program the TPU ran every frame; the math is the reference's
// cdef_find_dir_c and cdef_filter_block_c (src/cdef_tmpl.c:105-305)
// with the strength adjust of cdef_apply_tmpl.c:91-97, term by term as
// ops/cdef.py `cdef_frame_plain` computes it.
//
// Input: the deblocked planes (full padded pictures, int32, each row a
// whole number of 16-byte vectors), the luma crop Hy x Wy (the frame's
// 4x4 grid, bh*4 x bw*4; chroma Hy >> ss_ver x Wy >> ss_hor) and
// per-8x8-luma-block int32 maps (6, nby, nbx): y_pri, y_sec, uv_pri,
// uv_sec (strengths already << bd - 8), y_apply, uv_apply. Output:
// fresh planes written whole: the filtered crop, and the input copied
// through outside it. Taps outside the crop read the FILL sentinel
// (-32768), as the reference's padding does. Input and output never
// alias: every tap reads unfiltered pixels.
//
// Design. One block of 256 threads per 64x64 luma tile (and its
// co-located chroma tiles), at most 64 registers a thread so that 4
// blocks share a SM: a 1080p frame's 510 tiles that touch the crop fit
// the card's 528 slots in one round. A tile wholly outside the crop
// copies its pixels through in 16-byte vectors and returns. Otherwise:
// (1) every plane's window (the tile, 2 rows above and below, 4
// columns left and right) goes to shared memory as int16 in one round
// of 16-byte loads, FILL outside the crop (crop widths are multiples of
// 4 pixels, so a vector lies wholly inside or outside), beside the
// luma pixels' direction-search values (px >> bd - 8) - 128 as int8 and
// the tile's block maps; one barrier. (2) The direction search: warp d
// computes direction d's cost of every 8x8 block of the tile (its line
// sums in registers, the line pattern known at compile time), into
// shared memory; the 8 lanes of a block then take the first maximum by
// a pairwise shuffle reduction that prefers the lower direction on
// equal costs, and the variance from the opposite direction's cost.
// Costs are int32 (at most ~8.8e8). Every block of the crop is
// searched: chroma takes its direction from it even where luma's
// primary strength is 0. (3) Every thread filters runs of 4 pixels of
// one 8x8 block (its parameters and tap offsets read once a run) and
// stores them as one 16-byte vector.
// ptxas: 63 registers, 40064 bytes of shared memory, no spills.
//
// Bound: memory or integer operations, by how much of the frame
// filters. Each int32 pixel read and written once and the maps read
// once: a 1080p 4:2:0 frame moves ~27 MB, ~8 us at 3.35 TB/s. A
// filtered pixel takes 12 taps of ~10 integer ops, a block's
// direction search ~1k.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                 // luma tile side
constexpr int APRON = 2;                 // window rows above and below
constexpr int LEFT = 4;                  // window columns left and right
constexpr int WS = TILE + 2 * LEFT;      // window row stride (int16)
constexpr int WR = TILE + 2 * APRON;     // window rows at most
constexpr int PS = TILE + 8;             // search array row stride (bytes)
constexpr int THREADS = 256;
constexpr int NB = (TILE / 8) * (TILE / 8);  // 8x8 blocks of a tile
constexpr int FILL = -32768;
constexpr unsigned FULL = 0xffffffffu;
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

// the reference's constrain(), sign(diff) * min(|diff|, max(0,
// threshold - (|diff| >> shift))), as a clamp of diff
__device__ __forceinline__ int constrain(int diff, int threshold,
                                         int shift) {
    const int m = max(0, threshold - (abs(diff) >> shift));
    return min(max(diff, -m), m);
}

// the filter parameters of one 8x8 block of one plane
struct Taps {
    int pri, sec, pri_tap, pri_shift, sec_shift;
    bool mm;                 // both strengths: clamp to the taps' range
    int o[6];                // window offsets: primary k = 0, 1; then
                             // secondary (dir + 4, k), (dir, k) by k
};

// one pixel of cdef_filter_block_c: w points at the pixel in a window
// of row stride WS. Straight-line code: a strength of 0 makes its taps'
// terms 0, and the minimum and maximum (Hopper's 3-input DPX
// instructions) count only where both strengths are on. The minimum
// is taken unsigned: FILL (-32768) is then above every pixel, as it is
// below every pixel for the signed maximum.
__device__ __forceinline__ int filter_px(const int16_t *w, int px,
                                         const Taps &t) {
    int sum = 0, mn = px, mx = px;
#pragma unroll
    for (int j = 0; j < 6; j++) {
        const int s0 = w[t.o[j]], s1 = w[-t.o[j]];
        const int tap = j == 0 ? t.pri_tap : j == 1 ? (t.pri_tap & 3) | 2
                                                    : j < 4 ? 2 : 1;
        const int thr = j < 2 ? t.pri : t.sec;
        const int shift = j < 2 ? t.pri_shift : t.sec_shift;
        sum += tap * (constrain(s0 - px, thr, shift) +
                      constrain(s1 - px, thr, shift));
        mn = (int)__vimin3_u32(mn, s0, s1);
        mx = __vimax3_s32(mx, s0, s1);
    }
    int res = px + ((sum - (sum < 0) + 8) >> 4);
    if (t.mm) res = min(max(res, mn), mx);
    return res;
}

// the line of cdef_find_dir_c's partial sums of direction D that pixel
// (y, x) of a block adds to: diag[0], alt[0], hv[0], alt[1], diag[1],
// alt[2], hv[1], alt[3] (reference cdef_tmpl.c:252-274); D, y and x
// are constants where it is called
template <int D>
__device__ __forceinline__ int line_of(int y, int x) {
    return D == 0 ? y + x : D == 1 ? y + (x >> 1) : D == 2 ? y :
           D == 3 ? 3 + y - (x >> 1) : D == 4 ? 7 + y - x :
           D == 5 ? 3 - (y >> 1) + x : D == 6 ? x : (y >> 1) + x;
}

// the number of lines of direction D
template <int D>
struct Lines {
    static constexpr int n = (D & 1) ? 11 : (D == 2 || D == 6) ? 8 : 15;
};

// the cost weight of line i of direction D: 840 over the line's pixels,
// 105 for lines of 8 (the reference's div_table and its * 105)
template <int D>
__device__ __forceinline__ int line_weight(int i) {
    if (D == 2 || D == 6) return 105;
    if (D & 1) {
        const int m = i < 10 - i ? i : 10 - i;
        return m < 3 ? 840 / (2 * m + 2) : 105;
    }
    return 840 / ((i < 14 - i ? i : 14 - i) + 1);
}

// direction D's cost of the 8x8 block whose search values start at pb
// (row stride PS)
template <int D>
__device__ __forceinline__ int dir_cost(const int8_t *pb) {
    int s[Lines<D>::n];
#pragma unroll
    for (int i = 0; i < Lines<D>::n; i++) s[i] = 0;
#pragma unroll
    for (int y = 0; y < 8; y++) {
        const uint2 w = *reinterpret_cast<const uint2 *>(pb + y * PS);
#pragma unroll
        for (int x = 0; x < 8; x++)
            s[line_of<D>(y, x)] +=
                (int)(int8_t)((x < 4 ? w.x : w.y) >> (8 * (x & 3)));
    }
    int c = 0;
#pragma unroll
    for (int i = 0; i < Lines<D>::n; i++)
        c += s[i] * s[i] * line_weight<D>(i);
    return c;
}

__device__ __forceinline__ int dir_cost_of(int d, const int8_t *pb) {
    switch (d) {        // d is the warp's: no divergence
    case 0: return dir_cost<0>(pb);
    case 1: return dir_cost<1>(pb);
    case 2: return dir_cost<2>(pb);
    case 3: return dir_cost<3>(pb);
    case 4: return dir_cost<4>(pb);
    case 5: return dir_cost<5>(pb);
    case 6: return dir_cost<6>(pb);
    default: return dir_cost<7>(pb);
    }
}

__device__ __forceinline__ uint2 pack16(int4 q) {
    return make_uint2((q.x & 0xffff) | ((unsigned)q.y << 16),
                      (q.z & 0xffff) | ((unsigned)q.w << 16));
}

// a tile wholly outside the crop: its pixels of every plane copied
__device__ void copy_tile(const Args &a, int ty, int tx) {
    for (int p = 0; p < a.n; p++) {
        const int sv = p ? a.ss_ver : 0, sh = p ? a.ss_hor : 0;
        const int lg = 4 - sh;               // vectors a tile row, log2
        const int y0 = ty * (TILE >> sv), x0 = tx * (TILE >> sh);
        for (int i = threadIdx.x; i < (TILE >> sv) << lg; i += THREADS) {
            const int y = y0 + (i >> lg);
            const int x = x0 + ((i & ((1 << lg) - 1)) << 2);
            if (y < a.h[p] && x < a.w[p]) {
                const size_t o = (size_t)y * a.w[p] + x;
                *reinterpret_cast<int4 *>(a.dst[p] + o) =
                    *reinterpret_cast<const int4 *>(a.src[p] + o);
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS, 4)
cdef_kernel(const __grid_constant__ Args a) {
    const int tid = threadIdx.x;
    const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x % a.tiles_x;
    if (ty * TILE >= a.Hy || tx * TILE >= a.Wy) {
        copy_tile(a, ty, tx);
        return;
    }
    __shared__ __align__(16) int16_t s_win[3][WR * WS];
    __shared__ __align__(16) int8_t s_p[TILE * PS];
    __shared__ int s_cost[NB * 9];
    __shared__ int s_map[6][NB];
    __shared__ int4 s_prm[2][NB];  // luma, chroma: (pri, sec, dir, on)
    __shared__ int s_off[8][6];
    const int bdm8 = a.bd - 8;

    // (1) tap offsets, block maps and every plane's window
    if (tid < 48) {
        const int d = tid / 6, j = tid - d * 6;
        const int k = j < 2 ? j : (j - 2) >> 1;
        const int base = j < 2 ? 2 : ((j - 2) & 1) ? 0 : 4;
        const int *e = c_dirs + ((base + d) * 2 + k) * 2;
        s_off[d][j] = e[0] * WS + e[1];
    }
    for (int i = tid; i < 6 * NB; i += THREADS) {
        const int m = i >> 6, b = i & (NB - 1);
        const int by = ty * 8 + (b >> 3), bx = tx * 8 + (b & 7);
        s_map[m][b] = by < a.nby && bx < a.nbx
            ? a.maps[((size_t)m * a.nby + by) * a.nbx + bx] : 0;
    }
    for (int p = 0; p < a.n; p++) {
        const int sv = p ? a.ss_ver : 0, sh = p ? a.ss_hor : 0;
        const int ch = a.Hy >> sv, cw = a.Wy >> sh;
        const int y0 = ty * (TILE >> sv) - APRON;
        const int x0 = tx * (TILE >> sh) - LEFT;
        const int rows = (TILE >> sv) + 2 * APRON;
        const int vecs = ((TILE >> sh) >> 2) + 2;
        const int32_t *src = a.src[p];
        int16_t *win = s_win[p];
#pragma unroll 2
        for (int i = tid; i < rows * vecs; i += THREADS) {
            const int r = i / vecs, v = i - r * vecs;
            const int y = y0 + r, x = x0 + 4 * v;
            int4 q = make_int4(FILL, FILL, FILL, FILL);
            if (y >= 0 && y < ch && x >= 0 && x < cw)
                q = *reinterpret_cast<const int4 *>(
                    src + (size_t)y * a.w[p] + x);
            *reinterpret_cast<uint2 *>(win + r * WS + 4 * v) = pack16(q);
            if (p == 0 && r >= APRON && r < APRON + TILE && v >= 1 &&
                v <= TILE / 4) {
                const unsigned b0 = ((q.x >> bdm8) - 128) & 0xff;
                const unsigned b1 = ((q.y >> bdm8) - 128) & 0xff;
                const unsigned b2 = ((q.z >> bdm8) - 128) & 0xff;
                const unsigned b3 = ((q.w >> bdm8) - 128) & 0xff;
                *reinterpret_cast<unsigned *>(
                    s_p + (r - APRON) * PS + 4 * (v - 1)) =
                    b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
            }
        }
    }
    __syncthreads();

    // (2) the direction search: warp d, direction d, blocks lane and
    // lane + 32 (blocks outside the crop search junk, never used)
    {
        const int d = tid >> 5, lane = tid & 31;
#pragma unroll
        for (int k = 0; k < 2; k++) {
            const int b = lane + 32 * k;
            s_cost[b * 9 + d] = dir_cost_of(
                d, s_p + (b >> 3) * 8 * PS + (b & 7) * 8);
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; k++) {
        // lanes 8i..8i+7 of a warp: block b's directions 0..7
        const int b = (tid >> 3) + 32 * k, j = tid & 7;
        const int c = s_cost[b * 9 + j];
        int bc = c, bj = j;
#pragma unroll
        for (int m = 1; m < 8; m <<= 1) {
            const int oc = __shfl_xor_sync(FULL, bc, m);
            const int oj = __shfl_xor_sync(FULL, bj, m);
            if (oc > bc || (oc == bc && oj < bj)) {
                bc = oc;
                bj = oj;
            }
        }
        const int alt = __shfl_sync(FULL, c, (tid & 24) | (bj ^ 4));
        if (j == 0) {
            const int var = (bc - alt) >> 10;
            const int y_pri = s_map[M_YPRI][b];
            const int t = var >> 6;
            const int i = t ? ulog2c(min(t, 1 << 12), 12) : 0;
            int adj = (y_pri * (4 + i) + 8) >> 4;
            adj = (var != 0 && y_pri != 0) ? adj : 0;
            const int y_sec = s_map[M_YSEC][b];
            s_prm[0][b] = make_int4(
                adj, y_sec, y_pri != 0 ? bj : 0,
                s_map[M_YAPPLY][b] != 0 && (adj != 0 || y_sec != 0));
            const int uv_pri = s_map[M_UVPRI][b];
            const int uv_sec = s_map[M_UVSEC][b];
            s_prm[1][b] = make_int4(
                uv_pri, uv_sec, uv_pri != 0 ? c_uv_dirs[a.uv422 * 8 + bj] : 0,
                s_map[M_UVAPPLY][b] != 0 && (uv_pri != 0 || uv_sec != 0));
        }
    }
    __syncthreads();

    // (3) runs of 4 pixels of one block: unit u of a plane is block
    // u / ub, row (u % ub) / gb, column group (u % ub) % gb
    for (int p = 0; p < a.n; p++) {
        const int sv = p ? a.ss_ver : 0, sh = p ? a.ss_hor : 0;
        const int bv = 8 >> sv, bh = 8 >> sh;
        const int lg_gb = 1 - sh, lg_ub = 3 - sv + lg_gb;
        const int ch = a.Hy >> sv, cw = a.Wy >> sh;
        const int y0 = ty * (TILE >> sv), x0 = tx * (TILE >> sh);
        const int damp = p ? a.damping - 1 : a.damping;
        const int16_t *win = s_win[p];
        for (int u = tid; u < NB << lg_ub; u += THREADS) {
            const int b = u >> lg_ub, k = u & ((1 << lg_ub) - 1);
            const int r = (b >> 3) * bv + (k >> lg_gb);
            const int c = (b & 7) * bh + ((k & ((1 << lg_gb) - 1)) << 2);
            const int y = y0 + r, x = x0 + c;
            if (y >= a.h[p] || x >= a.w[p]) continue;
            const size_t o = (size_t)y * a.w[p] + x;
            int4 out;
            if (y < ch && x < cw) {
                const int16_t *wp = win + (r + APRON) * WS + c + LEFT;
                const uint2 raw = *reinterpret_cast<const uint2 *>(wp);
                int v[4] = {(int)(int16_t)(raw.x & 0xffff),
                            (int)(int16_t)(raw.x >> 16),
                            (int)(int16_t)(raw.y & 0xffff),
                            (int)(int16_t)(raw.y >> 16)};
                const int4 prm = s_prm[p ? 1 : 0][b];
                if (prm.w) {
                    Taps t;
                    t.pri = prm.x;
                    t.sec = prm.y;
                    t.mm = prm.x != 0 && prm.y != 0;
                    t.pri_tap = 4 - ((prm.x >> bdm8) & 1);
                    t.pri_shift = max(0, damp - ulog2c(max(prm.x, 1), 10));
                    t.sec_shift = damp - ulog2c(max(prm.y, 1), 10);
#pragma unroll
                    for (int j = 0; j < 6; j++) t.o[j] = s_off[prm.z][j];
#pragma unroll
                    for (int j = 0; j < 4; j++)
                        v[j] = filter_px(wp + j, v[j], t);
                }
                out = make_int4(v[0], v[1], v[2], v[3]);
            } else {
                out = *reinterpret_cast<const int4 *>(a.src[p] + o);
            }
            *reinterpret_cast<int4 *>(a.dst[p] + o) = out;
        }
    }
}

}  // namespace

// Upload the (12, 2, 2) int32 (dy, dx) direction table and the (2, 8)
// int32 UV_DIRS, and let the kernel's blocks take the SM's shared
// memory (4 blocks of ~40 KB).
extern "C" int cdef_set_tables(const int32_t *dirs, const int32_t *uv) {
    cudaMemcpyToSymbol(c_dirs, dirs, sizeof(int) * 12 * 2 * 2);
    cudaMemcpyToSymbol(c_uv_dirs, uv, sizeof(int) * 2 * 8);
    cudaFuncSetAttribute(cdef_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return (int)cudaGetLastError();
}

// Launch the CDEF of n planes (1: luma only; 3: luma, u, v) on `stream`.
// ptrs[0..n-1] the int32 input planes, ptrs[3..3+n-1] the outputs (same
// shapes, written whole), ptrs[6] the (6, nby, nbx) int32 maps; planes
// 16-byte aligned, widths multiples of 4. dims: per plane (h, w) at
// dims[2 i], then Hy, Wy, nby, nbx, layout (1 4:2:0, 2 4:2:2, 3 4:4:4;
// 0 with n = 1), bd, damping at dims[6 ..].
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
        if (a.w[p] % 4 || ((uintptr_t)ptrs[p] | (uintptr_t)ptrs[3 + p]) % 16)
            return (int)cudaErrorInvalidValue;
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
