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
// Design. A block of 256 threads runs 4 tiles, 64 threads each. The
// 193x8 filter bank is copied to shared memory once per block: every
// thread picks its own row, and constant memory would serialise the
// divergent addresses. (1) Each tile's 15x15 clamped window goes to
// shared memory. Barrier. (2) 120 horizontal sums of the 15x8
// intermediate, two per thread, into shared memory. Barrier. (3) One
// vertical sum per thread, stored to the plane. Sums are int32 at every
// bit depth (|taps| sum to < 2^8, pixels < 2^12).
//
// Bound: memory, and far below it in practice. A tile writes 64 pixels
// and reads at most 225 (neighbouring tiles share most of them): a
// 1080p frame's ~2k tiles move ~1.3 MB, ~0.4 us at 3.35 TB/s, and do
// ~3k integer ops each, ~0.2 us at 33.5 TOP/s. A launch costs about its
// latency plus one block's three dependent phases.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILES = 4;                 // tiles per block
constexpr int THREADS = 64 * TILES;
constexpr int MAX_REFS = 8;
constexpr int MAX_PLANES = 3;
constexpr int N_ROWS = 193;              // rows of the warp filter
constexpr int WIN = 15;                  // window side

enum { J_PLANE, J_PY, J_PX, J_SLOT, J_DY, J_DX, J_MX, J_MY, J_ALPHA,
       J_BETA, J_GAMMA, J_DELTA, J_N };

__device__ int g_wf[N_ROWS * 8];

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

// `a` is a __grid_constant__: its planes and reference pointers are
// read in place, not copied to the stack
__global__ void __launch_bounds__(THREADS)
mc_warp_kernel(const __grid_constant__ Args a) {
    __shared__ int s_wf[N_ROWS * 8];
    __shared__ int s_win[TILES][WIN * WIN];
    __shared__ int s_mid[TILES][WIN * 8];
    const int tid = threadIdx.x;
    const int t = tid >> 6, l = tid & 63;
    const int job = blockIdx.x * TILES + t;
    const bool live = job < a.n_jobs;
    for (int i = tid; i < N_ROWS * 8; i += THREADS) s_wf[i] = g_wf[i];

    int j[J_N];
    const Plane *P = nullptr;
    if (live) {
        const int32_t *row = a.jobs + (size_t)job * J_N;
#pragma unroll
        for (int k = 0; k < J_N; k++) j[k] = row[k];
        if (j[J_PLANE] < 0 || j[J_PLANE] >= a.n) __trap();
        P = &a.p[j[J_PLANE]];
        if (j[J_SLOT] < 0 || j[J_SLOT] >= P->n_refs) __trap();
        const int32_t *ref = P->refs[j[J_SLOT]];
        for (int i = l; i < WIN * WIN; i += 64) {
            int y = iclip(j[J_DY] - 3 + i / WIN, 0, P->rh - 1);
            int x = iclip(j[J_DX] - 3 + i % WIN, 0, P->rw - 1);
            s_win[t][i] = ref[(size_t)y * P->ref_w + x];
        }
    }
    __syncthreads();

    const int ib = a.bd == 12 ? 2 : 4;   // intermediate bits: 4, 4, 2
    if (live) {
        for (int i = l; i < WIN * 8; i += 64) {
            int y = i >> 3, x = i & 7;
            const int *f = s_wf + 8 * frow(j[J_MX] + j[J_BETA] * y +
                                           j[J_ALPHA] * x);
            const int *w = s_win[t] + y * WIN + x;
            int s = 0;
#pragma unroll
            for (int k = 0; k < 8; k++) s += f[k] * w[k];
            s_mid[t][i] = rnd(s, 7 - ib);
        }
    }
    __syncthreads();

    if (live) {
        int y = l >> 3, x = l & 7;
        const int *f = s_wf + 8 * frow(j[J_MY] + j[J_DELTA] * y +
                                       j[J_GAMMA] * x);
        const int *m = s_mid[t] + y * 8 + x;
        int s = 0;
#pragma unroll
        for (int k = 0; k < 8; k++) s += f[k] * m[8 * k];
        int oy = j[J_PY] + y, ox = j[J_PX] + x;
        if (oy < P->dst_h && ox < P->dst_w)
            P->dst[(size_t)oy * P->dst_w + ox] =
                iclip(rnd(s, 7 + ib), 0, (1 << a.bd) - 1);
    }
}

}  // namespace

// Upload the (193, 8) int32 warp filter (dav1d_mc_warp_filter).
extern "C" int mc_warp_set_filter(const int32_t *wf_host) {
    cudaMemcpyToSymbol(g_wf, wf_host, sizeof(int) * N_ROWS * 8);
    return (int)cudaGetLastError();
}

// Launch the warp of n planes (n <= 3) over n_jobs job rows on `stream`;
// a job's plane is its column 0, which must be below n. Per plane:
// ptrs[9 i .. 9 i + 7] the device pointers of its int32 reference
// planes (null past n_refs), ptrs[9 i + 8] its int32 destination,
// written in place; dims[6 i ..]: n_refs, ref_w (the references' row
// stride), dst_h, dst_w, rh, rw (the frame's valid reference rows /
// columns).
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
    if (n_jobs > 0)
        mc_warp_kernel<<<(n_jobs + TILES - 1) / TILES, THREADS, 0,
                         (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
