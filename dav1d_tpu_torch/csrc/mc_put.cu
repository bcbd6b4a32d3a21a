// AV1 single-reference motion-compensated put: 8-tap subpel and
// bilinear, over a table of jobs (one prediction block each).
//
// Replaces dav1d_tpu/ops/mc_pallas.py `_put8_pallas_fn` (the Pallas TPU
// kernel reached through `put8_pallas`) and the `put_{y,c}_*` / `bilin_*`
// segments of dav1d_tpu/ops/mc_fused.py `_mc_program`, with the math of
// dav1d_tpu/ops/mc_jobs.py `put8_jobs_fn` / `bilin_jobs_fn` (reference
// src/mc_tmpl.c put_8tap / put_bilin).
//
// Job row (int32, the native emitter's PUT layout):
//   plane, h, w, py, px, slot, dy, dx, amx, amy, ft
// `slot` picks one of up to 8 reference planes; ft < 0 is bilinear.
//
// Design. One thread block per job walks the job in 32x32 output tiles.
// Each tile first runs the horizontal taps over its (32+7)-row window
// into a shared-memory int32 intermediate (rounded by 6-ib), then the
// vertical taps (rounded by 6+ib) and the clip. The window is read
// straight from the reference plane with the per-element emu-edge clamp
// (row to [0, rh-1], column to [0, rw-1], window offset 3): no patch
// gather and no padded copies, which existed for the TPU's gathers.
// Bilinear runs the same two stages with the taps {16-m, m, 0...},
// window offset 0 and rounds 4-ib / 4+ib: 16*a + m*(b-a) equals
// (16-m)*a + m*b in integers, so both filters share one loop.
// Taps come from the (2, 4, 16, 8) filter bank in constant memory:
// fh = fb[w<=4][ft&3][amx], fv = fb[h<=4][(ft>>2)&3][amy].
//
// Bound: memory. Each output pixel is written once (4 B) and the
// reference pixels under its window are read (4 B each; neighbouring
// jobs' windows overlap by the 7-pixel apron). A 1080p inter frame's
// puts cover at most the frame (~3.1 Mpx with chroma), ~25 MB, ~7.5 us
// at 3.35 TB/s. This first version is simple, not fast: small jobs
// leave most of the 256 threads idle, and the horizontal stage reads
// each reference pixel 8 times from L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int MAX_REFS = 8;

enum { J_PLANE, J_H, J_W, J_PY, J_PX, J_SLOT, J_DY, J_DX, J_AMX, J_AMY,
       J_FT, J_N };

__constant__ int c_fb[2][4][16][8];

struct Refs {
    const int32_t *p[MAX_REFS];
};

__device__ __forceinline__ int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int rnd(int v, int sh) {
    return (v + ((1 << sh) >> 1)) >> sh;
}

__global__ void __launch_bounds__(THREADS)
mc_put_kernel(Refs refs, int ref_w, const int32_t *__restrict__ jobs,
           int32_t *__restrict__ dst, int dst_h, int dst_w, int rh, int rw,
           int bd) {
    __shared__ int mid[(TILE + 7) * TILE];
    const int32_t *j = jobs + (size_t)blockIdx.x * J_N;
    const int h = j[J_H], w = j[J_W], py = j[J_PY], px = j[J_PX];
    const int32_t *__restrict__ ref = refs.p[j[J_SLOT]];
    const int dy = j[J_DY], dx = j[J_DX], amx = j[J_AMX], amy = j[J_AMY];
    const int ft = j[J_FT];
    const int ib = bd == 8 ? 4 : 14 - bd;
    const int px_max = (1 << bd) - 1;

    int fh[8], fv[8], off, sh1, sh2;
    if (ft < 0) {
#pragma unroll
        for (int t = 0; t < 8; t++) fh[t] = fv[t] = 0;
        fh[0] = 16 - amx;
        fh[1] = amx;
        fv[0] = 16 - amy;
        fv[1] = amy;
        off = 0;
        sh1 = 4 - ib;
        sh2 = 4 + ib;
    } else {
#pragma unroll
        for (int t = 0; t < 8; t++) {
            fh[t] = c_fb[w <= 4][ft & 3][amx][t];
            fv[t] = c_fb[h <= 4][(ft >> 2) & 3][amy][t];
        }
        off = 3;
        sh1 = 6 - ib;
        sh2 = 6 + ib;
    }

    for (int ty0 = 0; ty0 < h; ty0 += TILE) {
        const int th = min(TILE, h - ty0);
        for (int tx0 = 0; tx0 < w; tx0 += TILE) {
            const int tw = min(TILE, w - tx0);
            // horizontal taps over th + 7 window rows
            for (int i = threadIdx.x; i < (th + 7) * tw; i += THREADS) {
                const int r = i / tw, c = i - r * tw;
                const int32_t *src =
                    ref + (size_t)iclip(dy - off + ty0 + r, 0, rh - 1) * ref_w;
                const int c0 = dx - off + tx0 + c;
                int acc = 0;
#pragma unroll
                for (int t = 0; t < 8; t++)
                    acc += fh[t] * src[iclip(c0 + t, 0, rw - 1)];
                mid[r * TILE + c] = rnd(acc, sh1);
            }
            __syncthreads();
            // vertical taps, round, clip, store
            for (int i = threadIdx.x; i < th * tw; i += THREADS) {
                const int r = i / tw, c = i - r * tw;
                int acc = 0;
#pragma unroll
                for (int t = 0; t < 8; t++) acc += fv[t] * mid[(r + t) * TILE + c];
                const int y = py + ty0 + r, x = px + tx0 + c;
                if (y < dst_h && x < dst_w)
                    dst[(size_t)y * dst_w + x] = iclip(rnd(acc, sh2), 0, px_max);
            }
            __syncthreads();
        }
    }
}

}  // namespace

// Copy the (2, 4, 16, 8) int32 filter bank into constant memory; called
// once when the library is loaded.
extern "C" int mc_put_set_filters(const int32_t *fb_host) {
    cudaMemcpyToSymbol(c_fb, fb_host, sizeof(int) * 2 * 4 * 16 * 8);
    return (int)cudaGetLastError();
}

// Launch the put over n jobs on `stream`. refs: n_refs device pointers to
// int32 planes of row stride ref_w; dst: int32 (dst_h, dst_w) plane
// written in place; rh, rw: the frame's valid reference rows/columns.
extern "C" int mc_put(const void *const *ref_ptrs, int n_refs, int ref_w,
                      const int32_t *jobs, int n, int32_t *dst, int dst_h,
                      int dst_w, int rh, int rw, int bd, void *stream) {
    Refs refs;
    for (int i = 0; i < MAX_REFS; i++)
        refs.p[i] = (const int32_t *)(i < n_refs ? ref_ptrs[i] : nullptr);
    if (n > 0)
        mc_put_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
            refs, ref_w, jobs, dst, dst_h, dst_w, rh, rw, bd);
    return (int)cudaGetLastError();
}
