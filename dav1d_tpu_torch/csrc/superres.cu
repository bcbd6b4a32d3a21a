// AV1 super-resolution: the horizontal 8-tap upscale of a frame's
// coded-width planes to the output width, every plane and source (the
// post-CDEF planes and, when loop restoration runs, the pre-CDEF
// snapshot) in one launch.
//
// Replaces dav1d_tpu/ops/superres.py `_resize_fn` (superres.py:41),
// the jitted program the TPU ran per plane and source; the math is the
// reference's resize_c (src/mc_tmpl.c:918-958), term by term as
// ops/superres.py `resize_plane_plain` computes it.
//
// A job resizes rows [0, h) of its source (columns [0, src_w) valid,
// row stride ss) into a destination of H x W (its padded plane, row
// stride W): output column ox < dst_w of row y < h is
//   clip((-sum_i bank[phase][i] * src[y][clip(src_x - 3 + i, 0,
//        src_w - 1)] + 64) >> 7, 0, 2^bd - 1),
// with T = mx0 + ox * step, src_x = (T >> 14) - 1, phase = (T & 0x3fff)
// >> 8 (the closed form of the reference's position recurrence, exact
// for mx0 < 2^14; T in 64 bits). Every other pixel of the destination
// is 0: loop restoration's stripe reads may touch those columns.
//
// Design. A block of 256 threads per tile of 8 rows x 128 output
// columns of a job's destination, one flat grid over every job's tiles.
// The block stages the 64x8 filter bank and the tile's clamped source
// span (8 rows of at most 136 columns: a step of at most 2^14 advances
// the source at most 128 columns over 128 outputs, plus the 8 taps'
// reach) in shared memory, one coalesced pass; then a thread computes
// one output column of 4 rows, the 8 taps from shared memory, and the
// stores of a warp fall on 32 neighbouring columns. Tiles outside
// [0, h) x [0, dst_w) only write zeros.
//
// Bound: memory. Each source pixel read once (the spans of neighbouring
// tiles overlap by 8 columns) and each destination pixel written once,
// int32: a 1080p 4:2:0 frame from 960 columns with its pre-CDEF
// snapshot moves about 40 MB, some 12 us at 3.35 TB/s; 8 multiply-adds
// an output stay well below that. No single PyTorch call computes this
// function: there is no library yardstick.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;                 // output columns per block
constexpr int RT = 8;                   // output rows per block
constexpr int THREADS = 256;
constexpr int SPAN = 144;               // staged source columns (>= 136)
constexpr int MAX_JOBS = 6;

struct Job {
    const int32_t *src;
    int32_t *dst;
    int src_w, ss, h, dst_w, H, W, step, mx0;
    int tiles_x, first;                 // tiles a row; first tile's id
};

struct Args {
    Job job[MAX_JOBS];
    int njobs, bd;
};

__constant__ int8_t c_bank[64 * 8];

__global__ void __launch_bounds__(THREADS)
superres_kernel(const __grid_constant__ Args a) {
    __shared__ int32_t s_src[RT][SPAN];
    __shared__ int16_t s_bank[64][8];
    const int tid = threadIdx.x;
    int k = 0;
    while (k + 1 < a.njobs && (int)blockIdx.x >= a.job[k + 1].first) k++;
    const Job &J = a.job[k];
    const int t = blockIdx.x - J.first;
    const int r0 = (t / J.tiles_x) * RT, c0 = (t % J.tiles_x) * TW;
    const int j = tid & (TW - 1), q = tid / TW;
    const int ox = c0 + j;
    if (r0 >= J.h || c0 >= J.dst_w) {   // padding only: zeros
        if (ox < J.W)
            for (int r = q; r < RT && r0 + r < J.H; r += THREADS / TW)
                J.dst[(size_t)(r0 + r) * J.W + ox] = 0;
        return;
    }
    const int cl = min(c0 + TW, J.dst_w) - 1;
    const int lo = (int)(((long long)J.mx0 + (long long)c0 * J.step) >> 14)
                   - 4;
    const int hi = (int)(((long long)J.mx0 + (long long)cl * J.step) >> 14)
                   + 3;
    const int span = hi - lo + 1;
    if (span > SPAN) __trap();
    for (int i = tid; i < 64 * 8; i += THREADS)
        s_bank[i >> 3][i & 7] = c_bank[i];
    const int rows = min(RT, J.h - r0);
    for (int i = tid; i < rows * span; i += THREADS) {
        const int r = i / span, c = i - r * span;
        s_src[r][c] = J.src[(size_t)(r0 + r) * J.ss +
                            min(max(lo + c, 0), J.src_w - 1)];
    }
    __syncthreads();
    if (ox >= J.W) return;
    const int px_max = (1 << a.bd) - 1;
    int f[8], base = 0;
    const bool on = ox < J.dst_w;
    if (on) {
        const long long T = (long long)J.mx0 + (long long)ox * J.step;
        const int ph = (int)((T & 0x3fff) >> 8);
        base = (int)(T >> 14) - 4 - lo;
#pragma unroll
        for (int i = 0; i < 8; i++) f[i] = s_bank[ph][i];
    }
    for (int r = q; r < RT && r0 + r < J.H; r += THREADS / TW) {
        int v = 0;
        if (on && r < rows) {
            int acc = 0;
#pragma unroll
            for (int i = 0; i < 8; i++) acc += f[i] * s_src[r][base + i];
            v = min(max((-acc + 64) >> 7, 0), px_max);
        }
        J.dst[(size_t)(r0 + r) * J.W + ox] = v;
    }
}

}  // namespace

// Upload the (64, 8) int8 dav1d_resize_filter bank (once per process).
extern "C" int superres_set_filter(const int8_t *bank) {
    cudaMemcpyToSymbol(c_bank, bank, sizeof(c_bank));
    return (int)cudaGetLastError();
}

// Launch the resize of `njobs` (1..6) jobs on `stream`. ptrs: per job
// src, dst (int32). dims: per job src_w, ss (src row stride), h, dst_w,
// H, W (dst rows and columns, its row stride), step, mx0.
extern "C" int superres(const void *const *ptrs, const int *dims,
                        int njobs, int bd, void *stream) {
    if (njobs < 1 || njobs > MAX_JOBS || (bd != 8 && bd != 10 && bd != 12))
        return (int)cudaErrorInvalidValue;
    Args a = {};
    a.njobs = njobs;
    a.bd = bd;
    long long tiles = 0;
    for (int k = 0; k < njobs; k++) {
        Job &J = a.job[k];
        const int *d = dims + 8 * k;
        J.src = (const int32_t *)ptrs[2 * k];
        J.dst = (int32_t *)ptrs[2 * k + 1];
        J.src_w = d[0];
        J.ss = d[1];
        J.h = d[2];
        J.dst_w = d[3];
        J.H = d[4];
        J.W = d[5];
        J.step = d[6];
        J.mx0 = d[7];
        if (!J.src || !J.dst || J.src_w < 1 || J.ss < J.src_w || J.h < 1 ||
            J.H < J.h || J.dst_w < 1 || J.W < J.dst_w || J.step < 1 ||
            J.step > (1 << 14) || J.mx0 < 0 || J.mx0 >= (1 << 14))
            return (int)cudaErrorInvalidValue;
        J.tiles_x = (J.W + TW - 1) / TW;
        J.first = (int)tiles;
        tiles += (long long)J.tiles_x * ((J.H + RT - 1) / RT);
    }
    if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
    superres_kernel<<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
