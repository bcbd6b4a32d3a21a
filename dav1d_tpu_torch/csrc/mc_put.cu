// AV1 single-reference motion-compensated put, 8-tap subpel and
// bilinear, over a class-binned table of jobs (one prediction block
// each).
//
// Replaces dav1d_tpu/ops/mc_pallas.py `_put8_pallas_fn` (the Pallas TPU
// kernel reached through `put8_pallas`) and the `put_{y,c}_*` / `bilin_*`
// segments of dav1d_tpu/ops/mc_fused.py `_mc_program`, with the math of
// dav1d_tpu/ops/mc_jobs.py `put8_jobs_fn` / `bilin_jobs_fn` (reference
// src/mc_tmpl.c put_8tap / put_bilin / put_c).
//
// Job row (int32, the native emitter's PUT layout):
//   plane, h, w, py, px, slot, dy, dx, amx, amy, ft
// `slot` picks one of up to 8 reference planes; ft < 0 is bilinear.
//
// Block row (int32, 5 columns; ops/mc.py put_blocks): cls, first,
// count, ty0, tx0. cls = copy * 25 + (log2 TH - 1) * 5 + log2 TW - 1
// names the tile shape (TH, TW), both in {2, 4, 8, 16, 32}, and whether
// the jobs are copies (amx = amy = 0). A block runs `count` (at most
// jobs_per_block) jobs of exactly TH x TW, or one TH x TW tile at (ty0,
// tx0) of a job larger than 32 in a dimension. The host sorts a plane's
// jobs by class; reordering is exact because the jobs of one call never
// write the same pixel.
//
// One launch serves every plane of a frame: the job table holds the
// planes' jobs, sorted by plane first, and a block's plane is its jobs'
// plane column (no block spans two planes).
//
// Design. 128 threads per block; every phase is one code copy for all
// classes, its geometry taken from the block's class at run time.
// Filtered blocks: (1) every job's window, (TH+7) rows of TW+7 pixels
// with the per-element emu-edge clamp to the frame's (rh, rw), goes to
// shared memory by cp.async: a row in 16-byte chunks from its
// 16-byte-aligned column at or left of the window, one cp.async per
// chunk inside the frame's columns and four clamped 4-byte ones at its
// edges; then each job's two 8-tap rows from the filter bank in global
// memory, also by cp.async (a bilinear job's {16-m, m} rows are
// written directly). Barrier. (2) Horizontal taps, OUT = min(TW, 8)
// columns per thread item from 16-byte shared loads, into a (TH+7)-row
// shared intermediate rounded by 6 - ib (bilinear: 4 - ib, window
// offset 0; 16a + m(b - a) equals (16 - m)a + mb, so both filters share
// the loop). Barrier. (3) Vertical taps in registers over a patch of 4
// rows (2 at TH 2) and 2 columns, rounded by 6 + ib (4 + ib), clipped
// and stored. Copy blocks: a put with amx = amy = 0 is exactly the
// clamped copy ref[clamp(dy + r)][clamp(dx + c)] (the identity row, 64
// at tap 3, gives x << ib and then x; bilinear's 16 likewise; dav1d's
// integer-MV put_c), so they read the reference and store, with no
// window, taps or intermediate.
//
// Bound: memory. Each output pixel written once, each reference window
// read once: a 1080p s7 inter frame's ~4.1k puts move ~7.6 MB, ~2.3 us
// at 3.35 TB/s. A block's time goes mostly to its dependent round trips
// to memory (block row, job rows, windows), so a launch costs about its
// launch latency plus its slowest block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_REFS = 8;
// shared words of a block, and the output pixels a block holds at most
constexpr int SMEM_WORDS = 8192;
constexpr int MAX_PX = 1024;
constexpr int N_CLS = 25;

enum { J_PLANE, J_H, J_W, J_PY, J_PX, J_SLOT, J_DY, J_DX, J_AMX, J_AMY,
       J_FT, J_N };
enum { B_CLS, B_FIRST, B_COUNT, B_TY0, B_TX0, B_N };

// the filter bank in global memory: jobs of one warp pick different
// rows, which the L1 serves together (constant memory would serialise)
__device__ __align__(16) int g_fb[2][4][16][8];

struct Refs {
    const int32_t *p[MAX_REFS];
};

constexpr int MAX_PLANES = 3;

// one destination plane and its references
struct Plane {
    Refs refs;
    int ref_w;
    int32_t *dst;
    int dst_h, dst_w;
    int rh, rw;
    int vec;            // reference rows 16-byte aligned (16-byte copies)
};

struct Args {
    Plane p[MAX_PLANES];
    int n;              // planes
    const int32_t *jobs;
    const int32_t *blocks;
    int bd;
};

// window row stride: a multiple of 4 words (16-byte rows) whose quarter
// is odd (8 neighbouring rows' 16-byte loads hit distinct banks),
// covering the row's 3 words of alignment offset and its tw + 7 pixels
__host__ __device__ constexpr int win_stride(int tw) {
    return tw == 32 ? 44 : (tw == 16 ? 28 : (tw == 2 ? 12 : 20));
}

// intermediate row stride: 16-byte (8-byte at tw 2) stores, odd quarter
__host__ __device__ constexpr int mid_stride(int tw) {
    return tw == 2 ? 4 : (tw == 4 ? 12 : tw + 4);
}

// shared words of one filtered job: window, intermediate, 16 taps
__host__ __device__ constexpr int job_words(int th, int tw) {
    return (th + 7) * (win_stride(tw) + mid_stride(tw)) + 16;
}

__host__ __device__ constexpr int jobs_per_block(int th, int tw, int copy) {
    return copy || SMEM_WORDS / job_words(th, tw) >= MAX_PX / (th * tw)
               ? MAX_PX / (th * tw)
               : SMEM_WORDS / job_words(th, tw);
}

// run-time geometry of a filtered class: shared layout of one job is
// window | intermediate | taps (8 horizontal, 8 vertical). Window row r
// holds the reference row from column x0 & ~3 on (x0 = dx - off + tx0),
// so the window's pixel c sits at word (x0 & 3) + c.
struct Geo {
    int lth, ltw, th, tw, rows, ws, chunks, mids, win, taps, s;
    __device__ Geo(int lh, int lw)
        : lth(lh), ltw(lw), th(1 << lh), tw(1 << lw), rows(th + 7),
          ws(win_stride(tw)), chunks((tw + 13) >> 2), mids(mid_stride(tw)),
          win(rows * ws), taps(win + rows * mids), s(taps + 16) {}
};

__device__ __forceinline__ int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int rnd(int v, int sh) {
    return (v + ((1 << sh) >> 1)) >> sh;
}

__device__ __forceinline__ void cp_async4(int *sdst, const int32_t *gsrc) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gsrc));
}

__device__ __forceinline__ void cp_async16(int *sdst, const int32_t *gsrc) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(sdst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gsrc));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

// the window offset of a job: 3 for 8-tap, 0 for bilinear
__device__ __forceinline__ int win_off(const int32_t *j) {
    return j[J_FT] < 0 ? 0 : 3;
}

// (1) windows and taps of every job of the block, then the barrier
__device__ __forceinline__ void load(const Plane &a, const int32_t *jobs,
                                     int count, int ty0, int tx0,
                                     const Geo &g, int *smem) {
    const int tid = threadIdx.x;
    const int li = g.rows * g.chunks;
#pragma unroll 2
    for (int i = tid; i < count * li; i += THREADS) {
        const int s = i / li, e = i - s * li;
        const int r = e / g.chunks, q = e - r * g.chunks;
        const int32_t *j = jobs + (size_t)s * J_N;
        const int off = win_off(j);
        const int y = iclip(j[J_DY] - off + ty0 + r, 0, a.rh - 1);
        const int xs = ((j[J_DX] - off + tx0) & ~3) + 4 * q;
        const int32_t *src = a.refs.p[j[J_SLOT]] + (size_t)y * a.ref_w;
        int *dst = smem + s * g.s + r * g.ws + 4 * q;
        if (a.vec && xs >= 0 && xs + 3 < a.rw) {
            cp_async16(dst, src + xs);
        } else {
#pragma unroll
            for (int k = 0; k < 4; k++)
                cp_async4(dst + k, src + iclip(xs + k, 0, a.rw - 1));
        }
    }
    // then each job's horizontal and vertical tap rows: two 16-byte
    // copies each from the bank, or bilinear's two taps written here
    for (int i = tid; i < count * 4; i += THREADS) {
        const int s = i >> 2, v = (i >> 1) & 1, half = i & 1;
        const int32_t *j = jobs + (size_t)s * J_N;
        const int ft = j[J_FT];
        int *dst = smem + s * g.s + g.taps + v * 8 + half * 4;
        if (ft < 0) {
            const int m = v ? j[J_AMY] : j[J_AMX];
            *reinterpret_cast<int4 *>(dst) =
                half ? make_int4(0, 0, 0, 0) : make_int4(16 - m, m, 0, 0);
        } else {
            const int *row = v ? g_fb[j[J_H] <= 4][(ft >> 2) & 3][j[J_AMY]]
                               : g_fb[j[J_W] <= 4][ft & 3][j[J_AMX]];
            cp_async16(dst, row + half * 4);
        }
    }
    cp_async_wait_all();
    __syncthreads();
}

// (2) horizontal taps: OUT intermediate columns per item from NQ
// 16-byte loads of the window row; neighbouring threads take
// neighbouring rows (a window row stride of 4 x odd words: no bank
// conflicts). Ends in the barrier.
template <int OUT>
__device__ __forceinline__ void hpass(const int32_t *jobs, int count,
                                      int tx0, int ib, const Geo &g,
                                      int *smem) {
    constexpr int NQ = (OUT + 13) / 4, NV = OUT + 7;
    const int per_job = g.rows * (g.tw / OUT);
    for (int i = threadIdx.x; i < count * per_job; i += THREADS) {
        const int s = i / per_job, e = i - s * per_job;
        const int cb = e / g.rows, r = e - cb * g.rows;
        const int c = cb * OUT;
        const int32_t *j = jobs + (size_t)s * J_N;
        const int off = (j[J_DX] - win_off(j) + tx0) & 3;
        int *base = smem + s * g.s;
        const int4 *w4 =
            reinterpret_cast<const int4 *>(base + r * g.ws + c);
        const int *f = base + g.taps;
        int w[4 * NQ], v[NV], fh[8], o[OUT];
#pragma unroll
        for (int k = 0; k < NQ; k++) {
            const int4 u = w4[k];
            w[4 * k] = u.x;
            w[4 * k + 1] = u.y;
            w[4 * k + 2] = u.z;
            w[4 * k + 3] = u.w;
        }
#pragma unroll
        for (int k = 0; k < NV; k++)         // v[k] = w[off + k]
            v[k] = off == 0 ? w[k] : off == 1 ? w[k + 1]
                 : off == 2 ? w[k + 2] : w[k + 3];
#pragma unroll
        for (int k = 0; k < 8; k++) fh[k] = f[k];
        const int sh = (j[J_FT] < 0 ? 4 : 6) - ib;
#pragma unroll
        for (int u = 0; u < OUT; u++) {
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; k++) acc += fh[k] * v[u + k];
            o[u] = rnd(acc, sh);
        }
        int *m = base + g.win + r * g.mids + c;
        if constexpr (OUT == 2) {
            *reinterpret_cast<int2 *>(m) = make_int2(o[0], o[1]);
        } else {
#pragma unroll
            for (int u = 0; u < OUT / 4; u++)
                reinterpret_cast<int4 *>(m)[u] = make_int4(
                    o[4 * u], o[4 * u + 1], o[4 * u + 2], o[4 * u + 3]);
        }
    }
    __syncthreads();
}

// (3) vertical taps over RR-row x 2-column patches, round, clip, store
template <int RR>
__device__ __forceinline__ void vpass(const Plane &a, const int32_t *jobs,
                                      int count, int ty0, int tx0, int ib,
                                      int bd, const Geo &g,
                                      const int *smem) {
    constexpr int LRR = RR == 4 ? 2 : 1;
    const int lpc = g.ltw - 1, lppj = g.lth - LRR + lpc;
    const int px_max = (1 << bd) - 1;
    for (int i = threadIdx.x; i < count << lppj; i += THREADS) {
        const int s = i >> lppj, e = i & ((1 << lppj) - 1);
        const int r0 = (e >> lpc) * RR, c0 = (e & ((1 << lpc) - 1)) * 2;
        const int32_t *j = jobs + (size_t)s * J_N;
        const int *base = smem + s * g.s;
        const int *f = base + g.taps + 8;
        const int *m = base + g.win + r0 * g.mids + c0;
        int fv[8];
        int2 col[RR + 7];
#pragma unroll
        for (int k = 0; k < 8; k++) fv[k] = f[k];
#pragma unroll
        for (int k = 0; k < RR + 7; k++)
            col[k] = *reinterpret_cast<const int2 *>(m + k * g.mids);
        const int sh = (j[J_FT] < 0 ? 4 : 6) + ib;
        const int py = j[J_PY] + ty0 + r0, px = j[J_PX] + tx0 + c0;
#pragma unroll
        for (int rr = 0; rr < RR; rr++) {
            int a0 = 0, a1 = 0;
#pragma unroll
            for (int k = 0; k < 8; k++) {
                a0 += fv[k] * col[rr + k].x;
                a1 += fv[k] * col[rr + k].y;
            }
            if (py + rr >= a.dst_h) break;
            int32_t *d = a.dst + (size_t)(py + rr) * a.dst_w + px;
            if (px < a.dst_w) d[0] = iclip(rnd(a0, sh), 0, px_max);
            if (px + 1 < a.dst_w) d[1] = iclip(rnd(a1, sh), 0, px_max);
        }
    }
}

// copy blocks: one output pixel per item, read straight from the
// reference with the emu-edge clamp; neighbouring threads take
// neighbouring columns
__device__ __forceinline__ void copy_pass(const Plane &a, const int32_t *jobs,
                                          int count, int ty0, int tx0,
                                          int lth, int ltw) {
    const int lpj = lth + ltw;
    for (int i = threadIdx.x; i < count << lpj; i += THREADS) {
        const int s = i >> lpj, e = i & ((1 << lpj) - 1);
        const int r = ty0 + (e >> ltw), c = tx0 + (e & ((1 << ltw) - 1));
        const int32_t *j = jobs + (size_t)s * J_N;
        const int y = iclip(j[J_DY] + r, 0, a.rh - 1);
        const int x = iclip(j[J_DX] + c, 0, a.rw - 1);
        const int v = __ldg(a.refs.p[j[J_SLOT]] + (size_t)y * a.ref_w + x);
        const int py = j[J_PY] + r, px = j[J_PX] + c;
        if (py < a.dst_h && px < a.dst_w)
            a.dst[(size_t)py * a.dst_w + px] = v;
    }
}

// `a` is a __grid_constant__: its planes and reference pointers are
// indexed in place, not copied to the stack
__global__ void __launch_bounds__(THREADS)
mc_put_kernel(const __grid_constant__ Args a) {
    __shared__ __align__(16) int smem[SMEM_WORDS];
    const int32_t *b = a.blocks + (size_t)blockIdx.x * B_N;
    const int cls = b[B_CLS], count = b[B_COUNT];
    const int ty0 = b[B_TY0], tx0 = b[B_TX0];
    const int copy = cls >= N_CLS, c = cls - copy * N_CLS;
    const int lth = c / 5 + 1, ltw = c % 5 + 1;
    const int32_t *jobs = a.jobs + (size_t)b[B_FIRST] * J_N;
    const int pl = jobs[J_PLANE];
    // the host table broke its contract
    if (cls < 0 || cls >= 2 * N_CLS || count < 1 ||
        count > jobs_per_block(1 << lth, 1 << ltw, copy) || pl < 0 ||
        pl >= a.n)
        __trap();
    const Plane &P = a.p[pl];
    if (copy) {
        copy_pass(P, jobs, count, ty0, tx0, lth, ltw);
        return;
    }
    const int ib = a.bd == 8 ? 4 : 14 - a.bd;
    const Geo g(lth, ltw);
    load(P, jobs, count, ty0, tx0, g, smem);
    if (ltw == 1)
        hpass<2>(jobs, count, tx0, ib, g, smem);
    else if (ltw == 2)
        hpass<4>(jobs, count, tx0, ib, g, smem);
    else
        hpass<8>(jobs, count, tx0, ib, g, smem);
    if (lth == 1)
        vpass<2>(P, jobs, count, ty0, tx0, ib, a.bd, g, smem);
    else
        vpass<4>(P, jobs, count, ty0, tx0, ib, a.bd, g, smem);
}

}  // namespace

// Copy the (2, 4, 16, 8) int32 filter bank to the device; called once
// when the library is loaded.
extern "C" int mc_put_set_filters(const int32_t *fb_host) {
    cudaMemcpyToSymbol(g_fb, fb_host, sizeof(int) * 2 * 4 * 16 * 8);
    return (int)cudaGetLastError();
}

// Launch the put of n planes (n <= 3) over the n_blocks block rows of a
// class-sorted job table on `stream`; a block's plane is its jobs' plane
// column, which must be below n. Per plane: ptrs[9 i .. 9 i + 7] the device
// pointers of its int32 reference planes (null past n_refs), ptrs[9 i +
// 8] its int32 destination, written in place; dims[6 i ..]: n_refs,
// ref_w (the references' row stride), dst_h, dst_w, rh, rw (the frame's
// valid reference rows / columns).
extern "C" int mc_put(const void *const *ptrs, const int *dims, int n,
                      const int32_t *jobs, const int32_t *blocks,
                      int n_blocks, int bd, void *stream) {
    if (n < 1 || n > MAX_PLANES) return (int)cudaErrorInvalidValue;
    Args a = {};
    for (int k = 0; k < n; k++) {
        Plane &P = a.p[k];
        const int *d = dims + 6 * k;
        P.vec = d[1] % 4 == 0;
        for (int i = 0; i < MAX_REFS; i++) {
            P.refs.p[i] = (const int32_t *)ptrs[9 * k + i];
            if (i < d[0]) P.vec &= ((uintptr_t)P.refs.p[i] & 15) == 0;
        }
        P.dst = (int32_t *)ptrs[9 * k + 8];
        P.ref_w = d[1];
        P.dst_h = d[2];
        P.dst_w = d[3];
        P.rh = d[4];
        P.rw = d[5];
    }
    a.n = n;
    a.jobs = jobs;
    a.blocks = blocks;
    a.bd = bd;
    if (n_blocks > 0)
        mc_put_kernel<<<n_blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// jobs_per_block(th, tw, copy) as the kernel computes it, for the host's
// check
extern "C" int mc_put_jobs_per_block(int th, int tw, int copy) {
    return jobs_per_block(th, tw, copy);
}
