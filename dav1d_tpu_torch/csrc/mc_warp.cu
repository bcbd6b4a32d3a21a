// AV1 affine warp of inter Stage B: one 8x8 tile per job (block-level
// local warp and global-motion warp alike).
//
// Replaces the `warp_{y,c}` segments of dav1d_tpu/ops/mc_fused.py
// `_mc_program` (mc_fused.py:537-574), with the math of
// dav1d_tpu/ops/mc_jobs.py `warp_jobs_fn` (reference src/mc_tmpl.c
// warp_affine_8x8_c).
//
// Job row (int32, the native emitter's WARP layout):
//   plane, py, px, slot, dy, dx, mx, my, alpha, beta, gamma, delta
// The tile at (py, px) of plane `plane` comes from the 15x15 window of
// reference `slot` at (dy - 3, dx - 3), each element clamped into the
// frame's (rh, rw) (emu-edge). Horizontal: for window row y < 15 and
// column x < 8, filter row 64 + ((mx + beta y + alpha x + 512) >> 10),
// rounded by 7 - ib; vertical: row 64 + ((my + delta y + gamma x + 512)
// >> 10), rounded by 7 + ib, clipped to [0, 2^bd - 1]. The emitter has
// already folded -4 alpha - 7 beta into mx and -4 gamma - 4 delta into
// my. A valid stream keeps the filter row in 0..192; the kernel clamps
// it there, as dav1d_tpu's gather does. Tiles never overlap.
//
// One launch serves every plane of a frame: a job's plane is its
// column 0.
//
// Bound: memory, and far below it in practice. A tile writes 64 pixels
// and reads at most 225 (neighbouring tiles share most of them): a
// 1080p frame's ~2k tiles move ~1.5 MB, ~0.46 us at 3.35 TB/s, and do
// ~3k integer ops each, ~0.2 us at 33.5 TOP/s. A launch costs its
// latency (the job row, then the window, then two short passes of
// arithmetic, one after the other) and the shared-memory traffic of
// its taps.
//
// Design. A warp per tile, synchronised by __syncwarp alone, so that no
// tile waits for another. A block holds WARPS warps, a tile each, in
// the emitter's order (a block's tiles consecutively, row by row, so
// neighbours that share window columns run together); a frame's tiles
// fill the card in one round (s31 frame 1: 2044 tiles against 528
// resident blocks of 8 warps). The 193x8 filter bank is int8 (taps
// -22..127: 1544 bytes, 97 16-byte vectors), copied once per block by
// one vector load a thread into shared memory, where a filter row is
// one 8-byte read (an int32 bank, 32 bytes a row, made the taps' shared
// reads the kernel's largest cost); the tile's job row and window loads
// go out before that block barrier. (1) The 15x15 window goes to a
// warp-private shared slice, 16 columns a row (a lane's 8 loads are row
// e >> 4, column e & 15, no division), with the clamp only for windows
// that touch the frame's edge (a warp-uniform branch). (2) The 120
// horizontal sums of the 15x8 intermediate: a lane takes 4 of a row,
// its 11 window pixels in registers from three 16-byte reads, into the
// warp's slice. (3) The 64 vertical sums: a lane takes 2 of a column,
// its 9 intermediate rows in registers, stored to the plane. Sums are
// int32 at every bit depth (|taps| sum to < 2^8, pixels < 2^12). The
// row strides (24 words for the window, 12 for the intermediate) spread
// each pass's reads over all 32 banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // tiles in flight per block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_REFS = 8;
constexpr int MAX_PLANES = 3;
constexpr int N_ROWS = 193;              // rows of the warp filter
constexpr int BANK_VECS = (N_ROWS * 8 + 15) / 16;   // 97 int8 vectors
constexpr int WIN = 15;                  // window side
constexpr int WS = 24;                   // window row stride (words)
constexpr int MS = 12;                   // intermediate row stride

enum { J_PLANE, J_PY, J_PX, J_SLOT, J_DY, J_DX, J_MX, J_MY, J_ALPHA,
       J_BETA, J_GAMMA, J_DELTA, J_N };

__device__ __align__(16) int8_t g_wf[BANK_VECS * 16];

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
    int n_jobs;
    int bd;
};

__device__ __forceinline__ int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int rnd(int v, int sh) {
    return (v + ((1 << sh) >> 1)) >> sh;
}

__device__ __forceinline__ int frow(int v) {
    return iclip(64 + ((v + 512) >> 10), 0, N_ROWS - 1);
}

__device__ __forceinline__ int sbyte(unsigned w, int b) {
    return (int)(int8_t)(w >> (8 * b));
}

// The tile's job row: lanes 0..11 load a word each, every lane gets all
// twelve; a plane index or slot past the launch's lists traps.
__device__ __forceinline__ void job_row(const Args &a, int tile, int lane,
                                        int j[J_N]) {
    const int v = lane < J_N ? a.jobs[(size_t)tile * J_N + lane] : 0;
#pragma unroll
    for (int k = 0; k < J_N; k++) j[k] = __shfl_sync(0xffffffffu, v, k);
    if (j[J_PLANE] < 0 || j[J_PLANE] >= a.n) __trap();
    if (j[J_SLOT] < 0 || j[J_SLOT] >= a.p[j[J_PLANE]].n_refs) __trap();
}

// (1) The tile's 15x15 window into win (rows of WS words).
__device__ __forceinline__ void stage_window(const Args &a, const int j[J_N],
                                             int lane, int *win) {
    const Plane &P = a.p[j[J_PLANE]];
    const int32_t *ref = P.refs[j[J_SLOT]];
    const int y0 = j[J_DY] - 3, x0 = j[J_DX] - 3;
    const bool inside = y0 >= 0 && x0 >= 0 && y0 + WIN <= P.rh &&
                        x0 + WIN <= P.rw;
    int v[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        // row 15 and column 15 (not stored) read row / column 14
        const int e = lane + 32 * k;
        int y = y0 + min(e >> 4, WIN - 1), x = x0 + min(e & 15, WIN - 1);
        if (!inside) {
            y = iclip(y, 0, P.rh - 1);
            x = iclip(x, 0, P.rw - 1);
        }
        v[k] = __ldg(ref + (size_t)y * P.ref_w + x);
    }
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const int e = lane + 32 * k, r = e >> 4, c = e & 15;
        if (r < WIN && c < WIN) win[r * WS + c] = v[k];
    }
}

// (2) The 15x8 horizontal intermediate into mid: lane (y, h) = (lane
// >> 1, lane & 1), y < 15, sums outputs x = 4h .. 4h + 3 of row y from
// window columns 4h .. 4h + 10, read as three 16-byte vectors.
__device__ __forceinline__ void horizontal(const int j[J_N], int lane,
                                           const uint2 *wf, const int *win,
                                           int *mid, int ib) {
    if (lane >= 2 * WIN) return;
    const int y = lane >> 1, h = lane & 1;
    const int4 *r = reinterpret_cast<const int4 *>(win + y * WS + 4 * h);
    const int4 a = r[0], b = r[1], c = r[2];
    const int w[11] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y,
                       c.z};
    const int base = j[J_MX] + j[J_BETA] * y + j[J_ALPHA] * 4 * h;
    int out[4];
#pragma unroll
    for (int x = 0; x < 4; x++) {
        const uint2 t = wf[frow(base + j[J_ALPHA] * x)];
        int s = 0;
#pragma unroll
        for (int k = 0; k < 4; k++)
            s += sbyte(t.x, k) * w[x + k] + sbyte(t.y, k) * w[x + 4 + k];
        out[x] = rnd(s, 7 - ib);
    }
    *reinterpret_cast<int4 *>(mid + y * MS + 4 * h) =
        make_int4(out[0], out[1], out[2], out[3]);
}

// (3) The 8x8 vertical sums, stored to the plane: lane (g, x) = (lane
// >> 3, lane & 7) sums rows 2g and 2g + 1 of column x from
// intermediate rows 2g .. 2g + 8.
__device__ __forceinline__ void vertical(const Args &a, const int j[J_N],
                                         int lane, const uint2 *wf,
                                         const int *mid, int ib) {
    const Plane &P = a.p[j[J_PLANE]];
    const int px_max = (1 << a.bd) - 1;
    const int x = lane & 7, y0 = 2 * (lane >> 3);
    int m[9];
#pragma unroll
    for (int k = 0; k < 9; k++) m[k] = mid[(y0 + k) * MS + x];
#pragma unroll
    for (int t = 0; t < 2; t++) {
        const int y = y0 + t;
        const uint2 f = wf[frow(j[J_MY] + j[J_DELTA] * y + j[J_GAMMA] * x)];
        int s = 0;
#pragma unroll
        for (int k = 0; k < 4; k++)
            s += sbyte(f.x, k) * m[t + k] + sbyte(f.y, k) * m[t + 4 + k];
        const int oy = j[J_PY] + y, ox = j[J_PX] + x;
        if (oy < P.dst_h && ox < P.dst_w)
            P.dst[(size_t)oy * P.dst_w + ox] = iclip(rnd(s, 7 + ib), 0,
                                                     px_max);
    }
}

// `a` is a __grid_constant__: its planes and reference pointers are
// read in place, not copied to the stack
__global__ void __launch_bounds__(THREADS)
mc_warp_kernel(const __grid_constant__ Args a) {
    __shared__ uint4 s_wf[BANK_VECS];            // int8 taps, 8 a row
    __shared__ __align__(16) int s_win[WARPS][WIN * WS];
    __shared__ __align__(16) int s_mid[WARPS][WIN * MS];
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int tile = blockIdx.x * WARPS + w;
    int *win = s_win[w], *mid = s_mid[w];
    const uint2 *wf = reinterpret_cast<const uint2 *>(s_wf);
    int j[J_N];
    const bool live = tile < a.n_jobs;
    if (live) {
        job_row(a, tile, lane, j);
        stage_window(a, j, lane, win);
    }
    if (tid < BANK_VECS)
        s_wf[tid] = reinterpret_cast<const uint4 *>(g_wf)[tid];
    __syncthreads();
    if (!live) return;

    const int ib = a.bd == 12 ? 2 : 4;   // intermediate bits: 4, 4, 2
    horizontal(j, lane, wf, win, mid, ib);
    __syncwarp();
    vertical(a, j, lane, wf, mid, ib);
}

}  // namespace

// Upload the (193, 8) warp filter (dav1d_mc_warp_filter) as int8; every
// tap must lie in -128..127.
extern "C" int mc_warp_set_filter(const int8_t *wf_host) {
    int8_t bank[BANK_VECS * 16] = {};
    for (int i = 0; i < N_ROWS * 8; i++) bank[i] = wf_host[i];
    cudaMemcpyToSymbol(g_wf, bank, sizeof(bank));
    return (int)cudaGetLastError();
}

// Launch the warp of n planes (n <= 3) over n_jobs job rows on `stream`;
// a job's plane is its column 0, which must be below n. Per plane:
// ptrs[9 i .. 9 i + 7] the device pointers of its int32 reference
// planes (null past n_refs), ptrs[9 i + 8] its int32 destination,
// written in place; dims[6 i ..]: n_refs, ref_w (the references' row
// stride), dst_h, dst_w, rh, rw (the frame's valid reference rows /
// columns); one block of WARPS warps per WARPS tiles.
extern "C" int mc_warp(const void *const *ptrs, const int *dims, int n,
                       const int32_t *jobs, int n_jobs, int bd,
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
    a.n_jobs = n_jobs;
    a.bd = bd;
    if (n_jobs == 0) return (int)cudaGetLastError();
    const int grid = (n_jobs + WARPS - 1) / WARPS;
    mc_warp_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
