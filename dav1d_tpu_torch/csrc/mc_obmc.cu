// AV1 overlapped block motion compensation (OBMC) of inter Stage B: the
// 8-tap put of a neighbour's motion blended into the block's
// prediction, every lap of a frame's planes in one launch.
//
// Replaces the `obmc_{y,c}_{1,0}` segments of dav1d_tpu/ops/mc_fused.py
// `_mc_program` (mc_fused.py:576-624), with the math of
// dav1d_tpu/ops/mc_jobs.py `obmc_jobs_fn` (reference src/recon_tmpl.c
// obmc(), mc_tmpl.c put_8tap_c, blend_h_c, blend_v_c).
//
// Job row (int32, the native emitter's OBMC layout):
//   top, plane, ww, hh, lap_h, py, px, slot, dy, dx, amx, amy, ft
// The lap is the clipped 8-tap put of reference `slot` at (dy, dx)
// (window from (dy - 3, dx - 3), each element clamped into the frame's
// (rh, rw)), horizontal taps [ww <= 4][ft & 3][amx] rounded by 6 - ib,
// vertical taps [lap_h <= 4][(ft >> 2) & 3][amy] rounded by 6 + ib. It
// is blended into the plane at (py, px) as (dst (64 - m) + lap m + 32)
// >> 6: a top lap over rows < (hh * 3) >> 2 and columns < ww with m =
// masks[hh + row], a left lap over rows < hh and columns < (ww * 3) >>
// 2 with m = masks[ww + col]. Only the blended region is filtered, and
// only its part inside the plane. A lap's plane is its column 1. Laps
// of one direction never overlap; a block's left laps read its top-left
// corner after its top laps wrote it, so every top lap of the frame is
// blended before any left lap.
//
// Design. A warp per lap, three laps to a block of 96 threads; a
// persistent grid (the blocks that fit the card at once, from the
// occupancy API) launched cooperatively: each warp takes the top laps
// in table order with the stride of the grid's warps, the grid meets at
// a grid-wide barrier, then the left laps the same way (two ordinary
// launches measured no faster: PERF.md). A warp reads its next lap's
// job row while it blends the current one. A lap: (1) its window ((rows
// + 7) x (cols + 7) int32) and the region's plane pixels (rows x cols)
// copied to the warp's shared buffers by cp.async, every element in
// flight at once, so that a lap waits for one memory round trip (the
// buffers are sized to the largest region the emitter blends: a top lap
// <= 24 rows x 64 columns, hh <= 32, ww <= 64; a left lap <= 64 x 24,
// ww <= 32, hh <= 64; a larger one traps); (2) a lane per column, a
// strip of rows each (32 / cols strips of a narrow region), slides down
// the window: the horizontal taps of each mid row into an 8-entry
// register ring, the vertical taps, clip and blend of each output row
// once its 8 mid rows are in (the first 8 unguarded, so their loads
// overlap; taps summed as trees); (3) the region back to the plane.
// 45100 bytes of static shared memory: 5 blocks (15 laps) a SM.
//
// Bound: memory. A lap reads its window and the plane pixels it blends
// and writes them back: a 1080p frame's ~4-8k laps move a few MB, ~2 us
// at 3.35 TB/s. What holds it (PERF.md): each lap's memory round trip,
// the laps a warp takes in turn, and the grid barrier's wait for the
// slowest top lap.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 3;                // laps in flight a block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_REFS = 8;
constexpr int MAX_PLANES = 3;
constexpr int MAX_DIM = 64;             // ww, hh, lap_h
constexpr int LONG = 64, SHORT = 24;    // a blended region's sides
constexpr int WIN = (SHORT + 7) * (LONG + 7);  // window, either direction
constexpr int REG = SHORT * LONG;              // blended region

enum { J_TOP, J_PLANE, J_WW, J_HH, J_LAP_H, J_PY, J_PX, J_SLOT, J_DY,
       J_DX, J_AMX, J_AMY, J_FT, J_N };

__constant__ int c_fb[2][4][16][8];     // subpel taps (warp-uniform reads)
__device__ int g_om[MAX_DIM];

struct Plane {
    const int32_t *refs[MAX_REFS];
    int n_refs, ref_w;
    int32_t *dst;
    int dst_h, dst_w;
    int rh, rw;
};

struct Args {
    Plane p[MAX_PLANES];
    int n;                      // planes
    const int32_t *laps[2];     // the top laps, the left laps
    int n_laps[2];
    int bd;
};

__device__ __forceinline__ int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int rnd(int v, int sh) {
    return (v + ((1 << sh) >> 1)) >> sh;
}

// a / b for 0 <= a < 2^12, 1 <= b <= 128: the float quotient of a + 1/2
// is at least 1 / 256 from an integer, far beyond its rounding error
__device__ __forceinline__ int qdiv(int a, int b) {
    return __float2int_rd(((float)a + 0.5f) * __frcp_rn((float)b));
}

// (y, x) of the flat index lane + 32 k over rows of w elements, k = 0,
// 1, ... in turn
struct Walk {
    int y, x, w, qy, qx;
    __device__ __forceinline__ Walk(int lane, int w_) : w(w_) {
        y = qdiv(lane, w_);
        x = lane - y * w_;
        qy = qdiv(32, w_);
        qx = 32 - qy * w_;
    }
    __device__ __forceinline__ void next() {
        x += qx;
        y += qy;
        if (x >= w) {
            x -= w;
            y++;
        }
    }
};

__device__ __forceinline__ void cp_async4(int *sdst, const int32_t *gsrc) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gsrc));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

// 8 taps of f over w[0..7], summed as a tree (short dependency chains)
__device__ __forceinline__ int tap8(const int *f, const int *w) {
    return ((f[0] * w[0] + f[1] * w[1]) + (f[2] * w[2] + f[3] * w[3])) +
           ((f[4] * w[4] + f[5] * w[5]) + (f[6] * w[6] + f[7] * w[7]));
}

// Blend NC columns (c0, c0 + 32) of output rows o0..o1 - 1: the lane
// slides down mid rows o0..o1 + 6 of its columns, the last 8 horizontal
// sums of each in a register ring, and blends each output row once its
// 8 are in. The first 8 mid rows always exist (o1 > o0) and go without
// a guard, so that their loads and taps overlap. win: the window (rows
// + 7) x ws; reg: the region's plane pixels, rows x cols.
template <int NC>
__device__ __forceinline__ void slide(const int *win, int ws, int *reg,
                                      int cols, int c0, int o0, int o1,
                                      const int *fh_, const int *fv_, int ib,
                                      int px_max, const int *om, int top,
                                      int ww, int hh) {
    int fh[8], fv[8], ring[NC][8];
#pragma unroll
    for (int t = 0; t < 8; t++) {
        fh[t] = fh_[t];
        fv[t] = fv_[t];
    }
    auto blend = [&](int o, int u) {        // output row o, newest slot u
#pragma unroll
        for (int k = 0; k < NC; k++) {
            int m[8];
#pragma unroll
            for (int t = 0; t < 8; t++) m[t] = ring[k][(u + 1 + t) & 7];
            const int px = iclip(rnd(tap8(fv, m), 6 + ib), 0, px_max);
            const int c = c0 + 32 * k;
            const int w = om[top ? hh + o : ww + c];
            int *d = reg + o * cols + c;
            *d = (*d * (64 - w) + px * w + 32) >> 6;
        }
    };
#pragma unroll
    for (int u = 0; u < 8; u++)
#pragma unroll
        for (int k = 0; k < NC; k++)
            ring[k][u] = rnd(tap8(fh, win + (o0 + u) * ws + c0 + 32 * k),
                             6 - ib);
    blend(o0, 7);
    const int n = o1 - o0 + 7;              // mid rows
    for (int b = 8; b < n; b += 8) {
#pragma unroll
        for (int u = 0; u < 8; u++) {
            if (b + u < n) {
#pragma unroll
                for (int k = 0; k < NC; k++)
                    ring[k][u] = rnd(tap8(fh, win + (o0 + b + u) * ws + c0 +
                                               32 * k), 6 - ib);
                blend(o0 + b + u - 7, u);
            }
        }
    }
}

// One lap of direction `top` by the calling warp, from its job row `v`
// (column `lane` of the row; lanes >= 13 hold 0); win and reg are the
// warp's own shared buffers, om the block's copy of the masks.
__device__ __forceinline__ void lap(const Args &a, int v, int top, int lane,
                                    int *win, int *reg, const int *om) {
    int j[J_N];
#pragma unroll
    for (int k = 0; k < J_N; k++) j[k] = __shfl_sync(0xffffffffu, v, k);
    if (j[J_TOP] != top || j[J_PLANE] < 0 || j[J_PLANE] >= a.n ||
        j[J_WW] < 1 || j[J_WW] > MAX_DIM || j[J_HH] < 1 ||
        j[J_HH] > MAX_DIM || j[J_LAP_H] < 1 || j[J_LAP_H] > MAX_DIM ||
        (top ? j[J_HH] : j[J_WW]) > 32 ||
        j[J_AMX] < 0 || j[J_AMX] > 15 || j[J_AMY] < 0 || j[J_AMY] > 15)
        __trap();                   // the host table broke its contract
    const Plane &P = a.p[j[J_PLANE]];
    if (j[J_SLOT] < 0 || j[J_SLOT] >= P.n_refs) __trap();
    // the blended region, cut to the plane (uniform over the warp)
    int rows = top ? (j[J_HH] * 3) >> 2 : j[J_HH];
    int cols = top ? j[J_WW] : (j[J_WW] * 3) >> 2;
    rows = min(rows, P.dst_h - j[J_PY]);
    cols = min(cols, P.dst_w - j[J_PX]);
    if (rows <= 0 || cols <= 0) return;

    // (1) the window and the region's plane pixels to shared memory, all
    // of them in flight at once; (row, column) of a lane's elements
    // advance by 32 elements a step, with no division per element
    const int ws = cols + 7;
    const int32_t *ref = P.refs[j[J_SLOT]];
    for (Walk s(lane, ws); s.y < rows + 7; s.next())
        cp_async4(win + s.y * ws + s.x,
                  ref + (size_t)iclip(j[J_DY] - 3 + s.y, 0, P.rh - 1) *
                            P.ref_w + iclip(j[J_DX] - 3 + s.x, 0, P.rw - 1));
    int32_t *dst = P.dst + (size_t)j[J_PY] * P.dst_w + j[J_PX];
    for (Walk s(lane, cols); s.y < rows; s.next())
        cp_async4(reg + s.y * cols + s.x, dst + (size_t)s.y * P.dst_w + s.x);
    const int *fh = c_fb[j[J_WW] <= 4][j[J_FT] & 3][j[J_AMX]];
    const int *fv = c_fb[j[J_LAP_H] <= 4][(j[J_FT] >> 2) & 3][j[J_AMY]];
    const int ib = a.bd == 12 ? 2 : 4;   // intermediate bits: 4, 4, 2
    const int px_max = (1 << a.bd) - 1;
    cp_async_wait_all();
    __syncwarp();

    // (2) a lane per column, a strip of rows each: columns lane and lane
    // + 32 of a region 33..64 wide; of a narrower one, 32 / cols strips
    // (at most rows) of a column each
    if (cols > 32) {
        if (lane + 32 < cols)
            slide<2>(win, ws, reg, cols, lane, 0, rows, fh, fv, ib, px_max,
                     om, top, j[J_WW], j[J_HH]);
        else
            slide<1>(win, ws, reg, cols, lane, 0, rows, fh, fv, ib, px_max,
                     om, top, j[J_WW], j[J_HH]);
    } else {
        const int strips = min(qdiv(32, cols), rows);
        const int q = qdiv(lane, cols), c = lane - q * cols;
        const int per = qdiv(rows + strips - 1, strips);
        const int o0 = q * per, o1 = min(rows, o0 + per);
        if (q < strips && o0 < o1)
            slide<1>(win, ws, reg, cols, c, o0, o1, fh, fv, ib, px_max, om,
                     top, j[J_WW], j[J_HH]);
    }
    __syncwarp();

    // (3) the blended region back to the plane
    for (Walk s(lane, cols); s.y < rows; s.next())
        dst[(size_t)s.y * P.dst_w + s.x] = reg[s.y * cols + s.x];
    __syncwarp();
}

// `a` is a __grid_constant__: its planes and reference pointers are
// read in place, not copied to the stack
__global__ void __launch_bounds__(THREADS, 5)
mc_obmc_kernel(const __grid_constant__ Args a) {
    __shared__ int s_win[WARPS][WIN];
    __shared__ int s_reg[WARPS][REG];
    __shared__ int s_om[MAX_DIM];
    for (int i = threadIdx.x; i < MAX_DIM; i += THREADS) s_om[i] = g_om[i];
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int first = blockIdx.x * WARPS + warp;
    const int stride = gridDim.x * WARPS;
    for (int dir = 0; dir < 2; dir++) {     // top laps, then left laps
        if (dir) cg::this_grid().sync();
        const int32_t *laps = a.laps[dir];
        const int n = a.n_laps[dir];
        // the next lap's job row is read while this one runs
        int v = first < n && lane < J_N ? laps[(size_t)first * J_N + lane]
                                        : 0;
        for (int i = first; i < n; i += stride) {
            const int next = i + stride;
            const int vn = next < n && lane < J_N
                               ? laps[(size_t)next * J_N + lane] : 0;
            lap(a, v, 1 - dir, lane, s_win[warp], s_reg[warp], s_om);
            v = vn;
        }
    }
}

}  // namespace

// Upload the (2, 4, 16, 8) int32 subpel filter bank (ops/mc.py
// filter_banks) and the 64 int32 OBMC masks (dav1d_obmc_masks), and let
// the kernel's blocks take the SM's shared memory (5 blocks of ~44 KB).
extern "C" int mc_obmc_set_tables(const int32_t *fb_host,
                                  const int32_t *om_host) {
    cudaMemcpyToSymbol(c_fb, fb_host, sizeof(int) * 2 * 4 * 16 * 8);
    cudaMemcpyToSymbol(g_om, om_host, sizeof(int) * MAX_DIM);
    cudaFuncSetAttribute(mc_obmc_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return (int)cudaGetLastError();
}

// Blocks of the kernel that fit one SM at once (the occupancy API).
extern "C" int mc_obmc_blocks_per_sm() {
    int per = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, mc_obmc_kernel,
                                                  THREADS, 0);
    return per;
}

// The grid of a launch over n_top top and n_left left laps: the blocks
// that fit the card at once, fewer where the laps are fewer (0 when the
// occupancy query fails).
extern "C" int mc_obmc_grid(int n_top, int n_left) {
    static int max_blocks = 0;      // the card's resident blocks
    if (!max_blocks) {
        int dev = 0, sms = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        max_blocks = sms * mc_obmc_blocks_per_sm();
    }
    const int want = ((n_top > n_left ? n_top : n_left) + WARPS - 1) / WARPS;
    return want < max_blocks ? want : max_blocks;
}

// Blend the OBMC laps of n planes (n <= 3) on `stream`: n_top top laps
// (`top`), then n_left left laps (`left`), job rows of 13 int32; a lap's
// plane is its column 1, which must be below n. Per plane: ptrs[9 i ..
// 9 i + 7] the device pointers of its int32 reference planes (null past
// n_refs), ptrs[9 i + 8] its int32 destination, blended in place;
// dims[6 i ..]: n_refs, ref_w (the references' row stride), dst_h,
// dst_w, rh, rw (the frame's valid reference rows / columns). One
// cooperative launch of the blocks that fit the card at once (fewer
// where the laps are fewer), none without laps; *launches gets the
// number of kernels launched.
extern "C" int mc_obmc(const void *const *ptrs, const int *dims, int n,
                       const int32_t *top, int n_top, const int32_t *left,
                       int n_left, int bd, void *stream, int *launches) {
    *launches = 0;
    if (n < 1 || n > MAX_PLANES || n_top < 0 || n_left < 0)
        return (int)cudaErrorInvalidValue;
    Args a = {};
    for (int k = 0; k < n; k++) {
        Plane &P = a.p[k];
        const int *d = dims + 6 * k;
        for (int i = 0; i < MAX_REFS; i++)
            P.refs[i] = (const int32_t *)ptrs[9 * k + i];
        P.dst = (int32_t *)ptrs[9 * k + 8];
        P.n_refs = d[0];
        P.ref_w = d[1];
        P.dst_h = d[2];
        P.dst_w = d[3];
        P.rh = d[4];
        P.rw = d[5];
    }
    a.n = n;
    a.laps[0] = top;
    a.laps[1] = left;
    a.n_laps[0] = n_top;
    a.n_laps[1] = n_left;
    a.bd = bd;
    if (n_top + n_left == 0) return (int)cudaGetLastError();
    const int grid = mc_obmc_grid(n_top, n_left);
    if (grid < 1) {
        const cudaError_t e = cudaGetLastError();
        return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    }
    void *args[] = {&a};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        (const void *)mc_obmc_kernel, dim3(grid), dim3(THREADS), args, 0,
        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    *launches = 1;
    return (int)cudaGetLastError();
}
