// AV1 loop restoration, self-guided (SGR): the box5 and box3 guided
// filters and their blend for every (restoration unit x stripe) item of
// a frame's planes, in one launch.
//
// Replaces dav1d_tpu/ops/lr.py `_sgr_fn` (lr.py:146), the jitted
// program the TPU ran per frame and plane; the math is the reference's
// sgr_filter_c path (src/looprestoration_tmpl.c), term by term as
// ops/lr.py `sgr_items_plain` computes it.
//
// Inputs, as for csrc/lr_wiener.cu (ops/lr.py frame_tables): per
// plane its pre-LR plane `src` and pre-CDEF plane `pre` (Hp rows each,
// one row stride), the restored plane `dst` and the width w that
// columns clamp to; per item a row of the item table (plane, colbase,
// oy, ox, ohs, ows, the strengths s0 (box5) and s1 (box3), the weights
// w0 and w1 (0: that branch off)) and a row table of at least ohs + 6
// rows (padded rows -3..ohs+2, already clamped to the reference's
// [-2, h+1] and redirected at stripe edges; a row r >= Hp reads row
// r - Hp of `pre`). The window's column c reads column clamp(colbase +
// c, 0, w - 1) of the unpadded planes (colbase = ox - 3): the
// reference's edge replication. With S the item's window:
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
// are computed in int64. Every other sum fits int32: A < 2^21, so the
// 3x3 and 6/5 weighted sums of A and of B times a pixel stay below
// 2^26, t3 and t5 below 2^17, w0 t5 + w1 t3 below 2^25 (|w0| <= 96, w1
// <= 256).
//
// Design. One block of 512 threads per (item, tile of <= 64 output
// columns), from a block table the host builds. (1) One warp per
// window row stages the (ohs + 6) x (cols + 6) window as int16 (its
// row-table entry and plane read once a row, the columns clamped). (2)
// Box sums, separable: a thread per (A/B column, strip of rows) slides
// down its strip two rows at a time, per window row the 3- and 5-wide
// sums of its column's pixels and squares, the last 3 and 5 rows of
// them in registers, so a box3 sum costs 3 + 2 adds and a box5 sum 5 +
// 4 (directly: 8 and 24); calc_ab at each box's last row, A as int32
// and B (x_by_x <= 255) as uint8 in shared memory. (3) The blend: a
// thread per (output column, strip of row pairs) slides down, the 3x3
// weighted sum of A or B as 3 x (three rows' 3-wide sums) + the middle
// row's 3-wide sum + the centre above and below, from a 3-row register
// window (6 shared reads an output, not 18); box5's 6/5 sums one per
// row pair. 42726 bytes of static shared memory and at most 42
// registers a thread: 3 blocks a SM, so s31's 302 luma items a frame
// fit one round on 132 SMs.
//
// Bound: operations. ~150 integer operations a restored pixel (the
// box sums' share, calc_ab of two boxes, the blends), and each
// restored pixel read and written once with the tables read once. What
// holds it (PERF.md): the box phase's instructions (calc_ab with its
// two int64 products, once per box), then the staging's memory round
// trips; every block runs each phase at the same time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;                  // output columns per block
constexpr int HMAX = 64;                // most rows an item restores
constexpr int ROWS = HMAX + 6;          // window rows
constexpr int WC = TW + 6;              // window columns
constexpr int BW = TW + 2;              // A/B columns: output cols -1..TW
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 3;           // resident blocks a SM, at least
// item table columns
enum { I_PLANE, I_COLBASE, I_OY, I_OX, I_OHS, I_OWS, I_S0, I_S1, I_W0,
       I_W1, NCOL };

__constant__ uint8_t c_xbyx[256];       // dav1d_sgr_x_by_x

struct Plane {
    const int32_t *src, *pre;
    int32_t *dst;
    int Hp, ss, ds;         // rows of src and pre, their row stride, dst's
    int w, wmax;            // columns clamp to [0, w); widest item
};

struct Args {
    Plane pl[3];
    int np;
    const int32_t *items, *rowt, *blocks;   // (n, NCOL), (n, rw), (nb, 2)
    int n, rw, bd;
};

// calc_ab of a box: (A, B); ra, sa and rb, sb round the box's sum of
// squares and sum down to 8 bits
__device__ __forceinline__ int2 calc_ab(int sumsq, int sum, int s, int nn,
                                        int one_by_x, int ra, int sa, int rb,
                                        int sb, const uint8_t *xbyx) {
    const int a = (sumsq + ra) >> sa;
    const int b = (sum + rb) >> sb;
    const int p = max(a * nn - b * b, 0);
    const long long z = ((long long)p * s + (1 << 19)) >> 20;
    const int x = xbyx[z < 255 ? (int)z : 255];
    return make_int2(
        (int)(((long long)x * sum * one_by_x + (1 << 11)) >> 12), x);
}

// the 3-wide sum of row k of M at columns x..x + 2, and its centre
#define ROW3(M, k, h, c)                                                   \
    do {                                                                   \
        c = M[k][x + 1];                                                   \
        h = M[k][x] + c + M[k][x + 2];                                     \
    } while (0)
// 6 / 5 weights of row j of M at columns x..x + 2
#define HWIN(M, j) (6 * M[j][x + 1] + 5 * (M[j][x] + M[j][x + 2]))

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
lr_sgr_kernel(const __grid_constant__ Args a) {
    __shared__ int16_t s_win[ROWS][WC];
    __shared__ int s_a3[HMAX + 2][BW];
    __shared__ uint8_t s_b3[HMAX + 2][BW];
    __shared__ int s_a5[HMAX / 2 + 1][BW];
    __shared__ uint8_t s_b5[HMAX / 2 + 1][BW];
    __shared__ uint8_t s_xbyx[256];
    const int tid = threadIdx.x;
    const int item = a.blocks[2 * blockIdx.x];
    const int c0 = a.blocks[2 * blockIdx.x + 1];
    if (item < 0 || item >= a.n) __trap();
    const int32_t *it = a.items + (size_t)item * NCOL;
    const int pi = it[I_PLANE];
    if (pi < 0 || pi >= a.np) __trap();
    const Plane &P = a.pl[pi];
    const int ohs = it[I_OHS], ows = it[I_OWS];
    if (ohs < 0 || ohs > HMAX || ohs + 6 > a.rw || ows > P.wmax) __trap();
    if (c0 >= ows || ohs == 0) return;
    const int cw = min(TW, ows - c0);
    const int rows = ohs + 6, cols = cw + 6;   // the window
    const int cb = it[I_COLBASE] + c0;
    const int s0 = it[I_S0], s1 = it[I_S1], w0 = it[I_W0], w1 = it[I_W1];
    const int32_t *rowt = a.rowt + (size_t)item * a.rw;
    for (int i = tid; i < 256; i += THREADS) s_xbyx[i] = c_xbyx[i];
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int k = 0; k < (ROWS + WARPS - 1) / WARPS; k++) {
        const int r = warp + WARPS * k;
        if (r < rows) {
            const int R = rowt[r];
            const int32_t *row = R < P.Hp ? P.src + (size_t)R * P.ss
                                          : P.pre + (size_t)(R - P.Hp) * P.ss;
#pragma unroll
            for (int m = 0; m < (WC + 31) / 32; m++) {
                const int c = lane + 32 * m;
                if (c < cols)
                    s_win[r][c] = (int16_t)row[min(max(cb + c, 0), P.w - 1)];
            }
        }
    }
    __syncthreads();

    // (2) A and B. Column xx holds output column xx - 1; box3 of A/B row
    // rr (output row rr - 1) sums window rows rr + 1..rr + 3 and columns
    // xx + 1..xx + 3, box5 of row j (output row 2 j - 1) window rows
    // 2 j..2 j + 4 and columns xx..xx + 4. Both end at window row r: box3
    // rr = r - 3 for r in 3..ohs + 4, box5 j = (r - 4) / 2 for even r in
    // 4..2 nj + 2. A strip takes the boxes that end in its rows [e0, e1),
    // e0 odd, and slides down them a pair of rows (even, odd) at a time
    // from e0 - 3.
    const int bw = cw + 2;
    const int S = THREADS / bw;             // strips
    const int xx = tid % bw, q = tid / bw;
    const int per = ((ohs + 3 + S - 1) / S + 1) & ~1;
    const int e0 = 3 + q * per, e1 = min(ohs + 6, e0 + per);
    const int nj = (ohs + 1) / 2 + 1;
    const int sb = a.bd - 8, rb = (1 << sb) >> 1;
    const int sa = 2 * sb, ra = (1 << sa) >> 1;
    if (q < S && e0 < e1) {
        int h3a = 0, h3b = 0, q3a = 0, q3b = 0;     // rows r - 2, r - 1
        int h5a = 0, h5b = 0, h5c = 0, h5d = 0;     // rows r - 4..r - 1
        int q5a = 0, q5b = 0, q5c = 0, q5d = 0;
        for (int r = e0 - 3; r < e1; r += 2) {
            int h3[2], q3[2], h5[2], q5[2];         // rows r, r + 1
#pragma unroll
            for (int k = 0; k < 2; k++) {
                const int16_t *w = &s_win[min(r + k, rows - 1)][xx];
                const int v0 = w[0], v1 = w[1], v2 = w[2], v3 = w[3];
                const int v4 = w[4];
                h3[k] = v1 + v2 + v3;
                q3[k] = v1 * v1 + v2 * v2 + v3 * v3;
                h5[k] = h3[k] + v0 + v4;
                q5[k] = q3[k] + v0 * v0 + v4 * v4;
            }
            if (w1 && r >= e0 && r <= ohs + 4) {
                const int2 ab = calc_ab(q3a + q3b + q3[0], h3a + h3b + h3[0],
                                        s1, 9, 455, ra, sa, rb, sb, s_xbyx);
                s_a3[r - 3][xx] = ab.x;
                s_b3[r - 3][xx] = (uint8_t)ab.y;
            }
            if (w0 && r >= e0 && r < 2 * nj + 4) {
                const int2 ab = calc_ab(q5a + q5b + q5c + q5d + q5[0],
                                        h5a + h5b + h5c + h5d + h5[0], s0, 25,
                                        164, ra, sa, rb, sb, s_xbyx);
                s_a5[(r - 4) >> 1][xx] = ab.x;
                s_b5[(r - 4) >> 1][xx] = (uint8_t)ab.y;
            }
            if (w1 && r + 1 >= e0 && r + 1 < e1 && r + 1 <= ohs + 4) {
                const int2 ab = calc_ab(q3b + q3[0] + q3[1], h3b + h3[0] + h3[1],
                                        s1, 9, 455, ra, sa, rb, sb, s_xbyx);
                s_a3[r - 2][xx] = ab.x;
                s_b3[r - 2][xx] = (uint8_t)ab.y;
            }
            h3a = h3[0];
            h3b = h3[1];
            q3a = q3[0];
            q3b = q3[1];
            h5a = h5c;
            h5b = h5d;
            h5c = h5[0];
            h5d = h5[1];
            q5a = q5c;
            q5b = q5d;
            q5c = q5[0];
            q5d = q5[1];
        }
    }
    __syncthreads();

    // (3) the blend: output column x, rows r0..r1 - 1 of an even r0. Row
    // r's box3 reads A/B rows r..r + 2 (columns x..x + 2); box5 reads row
    // j = r / 2 and j + 1 (even r) or j + 1 (odd r = 2 j + 1).
    const int S3 = THREADS / cw;            // strips
    const int x = tid % cw, q3 = tid / cw;
    const int per3 = (((ohs + S3 - 1) / S3) + 1) & ~1;
    const int r0 = q3 * per3, r1 = min(ohs, r0 + per3);
    if (q3 >= S3 || r0 >= r1) return;
    const int px_max = (1 << a.bd) - 1;
    int ha0 = 0, ha1 = 0, ca0 = 0, ca1 = 0;     // box3 A rows r, r + 1
    int hb0 = 0, hb1 = 0, cb0 = 0, cb1 = 0;     // and B
    if (w1) {
        ROW3(s_a3, r0, ha0, ca0);
        ROW3(s_b3, r0, hb0, cb0);
        ROW3(s_a3, r0 + 1, ha1, ca1);
        ROW3(s_b3, r0 + 1, hb1, cb1);
    }
    int A5 = 0, B5 = 0;                         // box5 of row j
    if (w0) {
        A5 = HWIN(s_a5, r0 >> 1);
        B5 = HWIN(s_b5, r0 >> 1);
    }
    int32_t *dst = P.dst + (size_t)(it[I_OY] + r0) * P.ds + it[I_OX] + c0 + x;
    for (int r = r0; r < r1; r += 2) {
        int A5n = 0, B5n = 0;                   // box5 of row j + 1
        if (w0) {
            A5n = HWIN(s_a5, (r >> 1) + 1);
            B5n = HWIN(s_b5, (r >> 1) + 1);
        }
#pragma unroll
        for (int odd = 0; odd < 2; odd++) {
            const int rr = r + odd;
            if (rr >= r1) break;
            const int px = s_win[rr + 3][x + 3];
            int v = 0;
            if (w1) {
                int ha2, ca2, hb2, cb2;
                ROW3(s_a3, rr + 2, ha2, ca2);
                ROW3(s_b3, rr + 2, hb2, cb2);
                const int wa = 3 * (ha0 + ha1 + ha2) + ha1 + ca0 + ca2;
                const int wb = 3 * (hb0 + hb1 + hb2) + hb1 + cb0 + cb2;
                v += w1 * ((wa - wb * px + (1 << 8)) >> 9);
                ha0 = ha1;
                ha1 = ha2;
                ca0 = ca1;
                ca1 = ca2;
                hb0 = hb1;
                hb1 = hb2;
                cb0 = cb1;
                cb1 = cb2;
            }
            if (w0)
                v += w0 * (odd ? (A5n - B5n * px + (1 << 7)) >> 8
                               : (A5 + A5n - (B5 + B5n) * px + (1 << 8))
                                     >> 9);
            *dst = min(max(px + ((v + (1 << 10)) >> 11), 0), px_max);
            dst += P.ds;
        }
        A5 = A5n;
        B5 = B5n;
    }
}

#undef ROW3
#undef HWIN

}  // namespace

// Upload the 256-entry dav1d_sgr_x_by_x table (uint8: every entry is
// at most 255), and let the kernel's blocks take the SM's shared memory
// (3 blocks of ~42 KB).
extern "C" int lr_sgr_set_table(const uint8_t *xbyx) {
    cudaMemcpyToSymbol(c_xbyx, xbyx, 256);
    cudaFuncSetAttribute(lr_sgr_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return (int)cudaGetLastError();
}

// Launch the SGR pass over the items of up to 3 planes on `stream`.
// ptrs: per plane p src, pre, dst at ptrs[3 p ..] (int32; src and pre
// (Hp, ss), dst row stride ds, written at the items' outputs only),
// then the item table (n, 10), the row tables (n, rw) and the block
// table (nb, 2) of (item, first output column), a block each. dims:
// per plane Hp, ss, ds, w, wmax at dims[5 p ..], then np, n, rw, nb,
// bd.
extern "C" int lr_sgr(const void *const *ptrs, const int *dims,
                      void *stream) {
    Args a = {};
    const int *d = dims + 15;
    a.np = d[0];
    a.n = d[1];
    a.rw = d[2];
    const int nb = d[3];
    a.bd = d[4];
    if (a.np < 1 || a.np > 3 || a.n < 0 || a.rw < 7 || nb < 0)
        return (int)cudaErrorInvalidValue;
    for (int p = 0; p < a.np; p++) {
        Plane &P = a.pl[p];
        P.src = (const int32_t *)ptrs[3 * p];
        P.pre = (const int32_t *)ptrs[3 * p + 1];
        P.dst = (int32_t *)ptrs[3 * p + 2];
        P.Hp = dims[5 * p];
        P.ss = dims[5 * p + 1];
        P.ds = dims[5 * p + 2];
        P.w = dims[5 * p + 3];
        P.wmax = dims[5 * p + 4];
        if (P.w < 1 || P.wmax < 1) return (int)cudaErrorInvalidValue;
    }
    a.items = (const int32_t *)ptrs[9];
    a.rowt = (const int32_t *)ptrs[10];
    a.blocks = (const int32_t *)ptrs[11];
    if (nb > 0 && !a.blocks) return (int)cudaErrorInvalidValue;
    if (nb > 0)
        lr_sgr_kernel<<<nb, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
