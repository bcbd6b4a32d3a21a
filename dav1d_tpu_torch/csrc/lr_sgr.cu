// AV1 loop restoration, self-guided (SGR): the box5 and box3 guided
// filters and their blend for every (restoration unit x stripe) item of
// one plane, in one launch.
//
// Replaces dav1d_tpu/ops/lr.py `_sgr_fn` (lr.py:146), the jitted
// program the TPU ran per frame and plane; the math is the reference's
// sgr_filter_c path (src/looprestoration_tmpl.c), term by term as
// ops/lr.py `sgr_items_plain` computes it.
//
// Inputs, as for csrc/lr_wiener.cu: the edge-padded pre-LR plane `src`
// and pre-CDEF plane `pre`, per item a row table of hmax + 6 rows
// (padded rows -3..hmax+2, already clamped to the reference's
// [-2, h+1] and redirected at stripe edges; rows >= Hp read `pre`), the
// first column of its linear column window, the strengths s0 (box5),
// s1 (box3), the weights w0, w1 (0: that branch off) and where its
// ohs x ows outputs land in `dst`. With S the item's padded window:
//
//   box3 at output rows -1..ohs: 3x3 sums of S and S^2 -> calc_ab(n 9,
//     one_by_x 455); t3 = (win3(A) - win3(B) src + 2^8) >> 9
//   box5 at output rows -1, 1, 3, ...: 5x5 sums -> calc_ab(n 25, 164);
//     even rows (A5 above + below, 6/5 weights) >> 9, odd rows (A5 of
//     the row) >> 8
//   out = clip(src + ((w0 t5 + w1 t3 + 2^10) >> 11))
//
// calc_ab: p = max(a n - b^2, 0), z = (p s + 2^19) >> 20, x =
// x_by_x[min(z, 255)], A = (x sum one_by_x + 2^11) >> 12, B = x. Two
// products leave int32: p s reaches ~4.2e9 (box3 of alternating 0 and
// 2^bd - 1, s1 = 3236) and x sum one_by_x ~4.3e9 (flat 2^12 - 1); both
// are computed in int64. Every other sum fits int32.
//
// Design. One block of 256 threads per (item, tile of <= 32 output
// columns). (1) The (ohs + 6) x (cols + 6) window to shared memory.
// (2) A and B of box3 at (ohs + 2) x (cols + 2) and of box5 at
// ((ohs + 1) / 2 + 1) x (cols + 2) into shared memory, each from its
// 3x3 or 5x5 box in the window. (3) The blend, one output per thread
// and step. The 256-entry dav1d_sgr_x_by_x table is uploaded once per
// library to constant memory and staged in shared memory per block
// (every thread looks up its own entry). 38592 bytes of static
// shared memory; tiles past ows return at once.
//
// Bound: memory. Each restored pixel read and written once and the
// tables read once: a 1080p frame's SGR items move a few MB, a few us
// at 3.35 TB/s. The box sums (~34 adds and ~34 multiplies a box pixel)
// and the blend stay below that for the most part.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;                  // output columns per block
constexpr int HMAX = 64;                // most rows an item restores
constexpr int ROWS = HMAX + 6;
constexpr int THREADS = 256;

__constant__ int c_xbyx[256];           // dav1d_sgr_x_by_x

struct Args {
    const int32_t *src, *pre;
    int32_t *dst;
    const int32_t *rowt, *colbase, *s0, *s1, *w0, *w1, *oy, *ox, *ohs,
        *ows;
    int Hp, Ws;             // rows and row stride of src and pre
    int Wd;                 // row stride of dst
    int hmax, wmax, bd;
};

__device__ __forceinline__ void calc_ab(int sumsq, int sum, int s, int nn,
                                        int one_by_x, int bdm8,
                                        const int *xbyx, int *A, int *B) {
    const int a = (sumsq + ((1 << (2 * bdm8)) >> 1)) >> (2 * bdm8);
    const int b = (sum + ((1 << bdm8) >> 1)) >> bdm8;
    const int p = max(a * nn - b * b, 0);
    const long long z = ((long long)p * s + (1 << 19)) >> 20;
    const int x = xbyx[z < 255 ? (int)z : 255];
    *A = (int)(((long long)x * sum * one_by_x + (1 << 11)) >> 12);
    *B = x;
}

__global__ void __launch_bounds__(THREADS)
lr_sgr_kernel(const __grid_constant__ Args a) {
    __shared__ int s_win[ROWS][TW + 6];
    __shared__ int s_a3[HMAX + 2][TW + 2], s_b3[HMAX + 2][TW + 2];
    __shared__ int s_a5[HMAX / 2 + 1][TW + 2], s_b5[HMAX / 2 + 1][TW + 2];
    __shared__ int s_xbyx[256];
    const int tid = threadIdx.x;
    const int item = blockIdx.x, c0 = blockIdx.y * TW;
    const int ows = a.ows[item], ohs = a.ohs[item];
    if (ohs < 0 || ohs > a.hmax || ows > a.wmax) __trap();
    if (c0 >= ows || ohs == 0) return;
    const int cw = min(TW, ows - c0);
    const int rows = ohs + 6, cols = cw + 6;
    const int w0 = a.w0[item], w1 = a.w1[item];
    const int s0 = a.s0[item], s1 = a.s1[item];
    for (int i = tid; i < 256; i += THREADS) s_xbyx[i] = c_xbyx[i];
    const int32_t *rowt = a.rowt + (size_t)item * (a.hmax + 6);
    const int cb = a.colbase[item] + c0;
    for (int i = tid; i < rows * cols; i += THREADS) {
        const int r = i / cols, c = i - r * cols;
        const int R = rowt[r];
        const int32_t *row = R < a.Hp ? a.src + (size_t)R * a.Ws
                                      : a.pre + (size_t)(R - a.Hp) * a.Ws;
        s_win[r][c] = row[cb + c];
    }
    __syncthreads();

    const int bdm8 = a.bd - 8;
    const int bw = cw + 2;              // A/B columns: output cols -1..cw
    if (w1) {
        // box3 at output row rr - 1, column xx - 1: window rows
        // rr + 1..rr + 3, columns xx + 1..xx + 3
        for (int i = tid; i < (ohs + 2) * bw; i += THREADS) {
            const int rr = i / bw, xx = i - rr * bw;
            int sum = 0, sq = 0;
#pragma unroll
            for (int dy = 1; dy <= 3; dy++) {
#pragma unroll
                for (int dx = 1; dx <= 3; dx++) {
                    const int v = s_win[rr + dy][xx + dx];
                    sum += v;
                    sq += v * v;
                }
            }
            calc_ab(sq, sum, s1, 9, 455, bdm8, s_xbyx, &s_a3[rr][xx],
                    &s_b3[rr][xx]);
        }
    }
    const int nj = (ohs + 1) / 2 + 1;
    if (w0) {
        // box5 at output row 2 j - 1, column xx - 1: window rows
        // 2 j..2 j + 4, columns xx..xx + 4
        for (int i = tid; i < nj * bw; i += THREADS) {
            const int j = i / bw, xx = i - j * bw;
            int sum = 0, sq = 0;
#pragma unroll
            for (int dy = 0; dy < 5; dy++) {
#pragma unroll
                for (int dx = 0; dx < 5; dx++) {
                    const int v = s_win[2 * j + dy][xx + dx];
                    sum += v;
                    sq += v * v;
                }
            }
            calc_ab(sq, sum, s0, 25, 164, bdm8, s_xbyx, &s_a5[j][xx],
                    &s_b5[j][xx]);
        }
    }
    __syncthreads();

    const int px_max = (1 << a.bd) - 1;
    int32_t *dst = a.dst + (size_t)a.oy[item] * a.Wd + a.ox[item] + c0;
    for (int i = tid; i < ohs * cw; i += THREADS) {
        const int r = i / cw, x = i - r * cw;
        const int px = s_win[r + 3][x + 3];
        long long v = 0;
        if (w1) {
            const int rr = r + 1, xx = x + 1;
#define WIN3(M) (4 * (M[rr][xx] + M[rr][xx - 1] + M[rr][xx + 1] +        \
                      M[rr - 1][xx] + M[rr + 1][xx]) +                     \
                 3 * (M[rr - 1][xx - 1] + M[rr - 1][xx + 1] +              \
                      M[rr + 1][xx - 1] + M[rr + 1][xx + 1]))
            const int t3 = (WIN3(s_a3) - WIN3(s_b3) * px + (1 << 8)) >> 9;
#undef WIN3
            v += (long long)w1 * t3;
        }
        if (w0) {
            const int xx = x + 1;
#define HWIN(M, j) (6 * M[j][xx] + 5 * (M[j][xx - 1] + M[j][xx + 1]))
            int t5;
            if (r & 1) {
                const int j = (r + 1) >> 1;
                t5 = (HWIN(s_a5, j) - HWIN(s_b5, j) * px + (1 << 7)) >> 8;
            } else {
                const int j = r >> 1;
                t5 = (HWIN(s_a5, j) + HWIN(s_a5, j + 1) -
                      (HWIN(s_b5, j) + HWIN(s_b5, j + 1)) * px + (1 << 8))
                    >> 9;
            }
#undef HWIN
            v += (long long)w0 * t5;
        }
        const long long res = px + ((v + (1 << 10)) >> 11);
        dst[(size_t)r * a.Wd + x] =
            (int32_t)(res < 0 ? 0 : (res > px_max ? px_max : res));
    }
}

}  // namespace

// Upload the 256-entry int32 dav1d_sgr_x_by_x table.
extern "C" int lr_sgr_set_table(const int32_t *xbyx) {
    cudaMemcpyToSymbol(c_xbyx, xbyx, sizeof(int) * 256);
    return (int)cudaGetLastError();
}

// Launch the SGR of n items on `stream`. ptrs: src, pre (int32,
// (Hp, Ws) each), dst (int32, row stride Wd, written at the items'
// outputs only), rowt (n, hmax + 6), colbase, s0, s1, w0, w1, oy, ox,
// ohs, ows (n,), all int32. dims: Hp, Ws, Wd, n, hmax (<= 64, even),
// wmax, bd.
extern "C" int lr_sgr(const void *const *ptrs, const int *dims,
                      void *stream) {
    Args a = {};
    a.src = (const int32_t *)ptrs[0];
    a.pre = (const int32_t *)ptrs[1];
    a.dst = (int32_t *)ptrs[2];
    a.rowt = (const int32_t *)ptrs[3];
    a.colbase = (const int32_t *)ptrs[4];
    a.s0 = (const int32_t *)ptrs[5];
    a.s1 = (const int32_t *)ptrs[6];
    a.w0 = (const int32_t *)ptrs[7];
    a.w1 = (const int32_t *)ptrs[8];
    a.oy = (const int32_t *)ptrs[9];
    a.ox = (const int32_t *)ptrs[10];
    a.ohs = (const int32_t *)ptrs[11];
    a.ows = (const int32_t *)ptrs[12];
    a.Hp = dims[0];
    a.Ws = dims[1];
    a.Wd = dims[2];
    const int n = dims[3];
    a.hmax = dims[4];
    a.wmax = dims[5];
    a.bd = dims[6];
    if (n < 0 || a.hmax < 2 || a.hmax > HMAX || (a.hmax & 1) || a.wmax < 1)
        return (int)cudaErrorInvalidValue;
    if (n > 0)
        lr_sgr_kernel<<<dim3(n, (a.wmax + TW - 1) / TW), THREADS, 0,
                        (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
