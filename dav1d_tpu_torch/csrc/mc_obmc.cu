// AV1 overlapped block motion compensation (OBMC) of inter Stage B: one
// lap per job, the 8-tap put of a neighbour's motion blended into the
// block's prediction.
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
// masks[hh + row], a left lap over rows < hh and columns < (ww * 3) >> 2
// with m = masks[ww + col]. Only the blended region is filtered, and
// only its part inside the plane. A launch runs the laps of one
// direction (`top`) of every plane, a lap's plane being its column 1;
// laps of one direction never overlap, and the caller launches the top
// laps before the left laps on one stream (a block's left laps read its
// top-left corner after its top laps wrote it).
//
// Design. One block of 256 threads per lap; geometry at run time up to
// 64 x 64 (the emitter's largest: ww <= 64, hh and lap_h <= 64; a larger
// one traps). (1) The clamped window, (rows + 7) x (cols + 7), to shared
// memory. Barrier. (2) Horizontal taps into a (rows + 7) x cols shared
// intermediate. Barrier. (3) Vertical taps, clip, and the blend with the
// plane's pixel, read and written by the same thread. Taps sit in
// registers (16 per thread, from the filter bank in global memory,
// which the L1 serves to the whole block). int32 throughout.
//
// Bound: memory. A lap reads its window and the plane pixels it blends
// and writes them back: a 1080p frame's ~4-8k laps move a few MB, ~1 us
// at 3.35 TB/s. Small laps leave most of a block's threads idle, so a
// launch costs its latency plus a few waves of short blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_REFS = 8;
constexpr int MAX_PLANES = 3;
constexpr int MAX_DIM = 64;
constexpr int MAX_WIN = (MAX_DIM + 7) * (MAX_DIM + 7);
constexpr int MAX_MID = (MAX_DIM + 7) * MAX_DIM;

enum { J_TOP, J_PLANE, J_WW, J_HH, J_LAP_H, J_PY, J_PX, J_SLOT, J_DY,
       J_DX, J_AMX, J_AMY, J_FT, J_N };

__device__ int g_fb[2][4][16][8];
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
    int n;              // planes
    const int32_t *jobs;
    int bd;
    int top;
};

__device__ __forceinline__ int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int rnd(int v, int sh) {
    return (v + ((1 << sh) >> 1)) >> sh;
}

// `a` is a __grid_constant__: its planes and reference pointers are
// read in place, not copied to the stack
__global__ void __launch_bounds__(THREADS)
mc_obmc_kernel(const __grid_constant__ Args a) {
    __shared__ int s_win[MAX_WIN];
    __shared__ int s_mid[MAX_MID];
    const int tid = threadIdx.x;
    int j[J_N];
    const int32_t *row = a.jobs + (size_t)blockIdx.x * J_N;
#pragma unroll
    for (int k = 0; k < J_N; k++) j[k] = row[k];
    if (j[J_TOP] != a.top || j[J_PLANE] < 0 || j[J_PLANE] >= a.n ||
        j[J_WW] < 1 || j[J_WW] > MAX_DIM || j[J_HH] < 1 ||
        j[J_HH] > MAX_DIM || j[J_LAP_H] < 1 || j[J_LAP_H] > MAX_DIM ||
        j[J_AMX] < 0 || j[J_AMX] > 15 || j[J_AMY] < 0 || j[J_AMY] > 15)
        __trap();                   // the host table broke its contract
    const Plane &P = a.p[j[J_PLANE]];
    if (j[J_SLOT] < 0 || j[J_SLOT] >= P.n_refs) __trap();
    // the blended region, cut to the plane (uniform over the block)
    int rows = a.top ? (j[J_HH] * 3) >> 2 : j[J_HH];
    int cols = a.top ? j[J_WW] : (j[J_WW] * 3) >> 2;
    rows = min(rows, P.dst_h - j[J_PY]);
    cols = min(cols, P.dst_w - j[J_PX]);
    if (rows <= 0 || cols <= 0) return;

    const int ws = cols + 7;
    const int32_t *ref = P.refs[j[J_SLOT]];
    for (int i = tid; i < (rows + 7) * ws; i += THREADS) {
        int y = iclip(j[J_DY] - 3 + i / ws, 0, P.rh - 1);
        int x = iclip(j[J_DX] - 3 + i % ws, 0, P.rw - 1);
        s_win[i] = ref[(size_t)y * P.ref_w + x];
    }
    const int *fh = g_fb[j[J_WW] <= 4][j[J_FT] & 3][j[J_AMX]];
    const int *fv = g_fb[j[J_LAP_H] <= 4][(j[J_FT] >> 2) & 3][j[J_AMY]];
    int h[8], v[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        h[k] = fh[k];
        v[k] = fv[k];
    }
    const int ib = a.bd == 12 ? 2 : 4;   // intermediate bits: 4, 4, 2
    __syncthreads();

    for (int i = tid; i < (rows + 7) * cols; i += THREADS) {
        int y = i / cols, x = i % cols;
        const int *w = s_win + y * ws + x;
        int s = 0;
#pragma unroll
        for (int k = 0; k < 8; k++) s += h[k] * w[k];
        s_mid[i] = rnd(s, 6 - ib);
    }
    __syncthreads();

    const int px_max = (1 << a.bd) - 1;
    for (int i = tid; i < rows * cols; i += THREADS) {
        int y = i / cols, x = i % cols;
        const int *m = s_mid + y * cols + x;
        int s = 0;
#pragma unroll
        for (int k = 0; k < 8; k++) s += v[k] * m[k * cols];
        int lap = iclip(rnd(s, 6 + ib), 0, px_max);
        int w = g_om[a.top ? j[J_HH] + y : j[J_WW] + x];
        int32_t *d = P.dst + (size_t)(j[J_PY] + y) * P.dst_w + j[J_PX] + x;
        *d = (*d * (64 - w) + lap * w + 32) >> 6;
    }
}

}  // namespace

// Upload the (2, 4, 16, 8) int32 subpel filter bank (ops/mc.py
// filter_banks) and the 64 int32 OBMC masks (dav1d_obmc_masks).
extern "C" int mc_obmc_set_tables(const int32_t *fb_host,
                                  const int32_t *om_host) {
    cudaMemcpyToSymbol(g_fb, fb_host, sizeof(int) * 2 * 4 * 16 * 8);
    cudaMemcpyToSymbol(g_om, om_host, sizeof(int) * MAX_DIM);
    return (int)cudaGetLastError();
}

// Launch the OBMC laps of one direction (top 1 or 0) of n planes (n <=
// 3) over n_jobs job rows on `stream`; a lap's plane is its column 1,
// which must be below n. Per plane: ptrs[9 i .. 9 i + 7] the device
// pointers of its int32 reference planes (null past n_refs), ptrs[9 i +
// 8] its int32 destination, blended in place; dims[6 i ..]: n_refs,
// ref_w (the references' row stride), dst_h, dst_w, rh, rw (the frame's
// valid reference rows / columns).
extern "C" int mc_obmc(const void *const *ptrs, const int *dims, int n,
                       const int32_t *jobs, int n_jobs, int bd, int top,
                       void *stream) {
    if (n < 1 || n > MAX_PLANES || n_jobs < 0)
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
    a.jobs = jobs;
    a.bd = bd;
    a.top = top;
    if (n_jobs > 0)
        mc_obmc_kernel<<<n_jobs, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
