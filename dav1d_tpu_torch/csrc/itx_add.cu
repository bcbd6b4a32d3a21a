// AV1 inverse transform + residual add over a table of jobs (one
// transform block each), plus the lossless 4x4 Walsh-Hadamard variant.
//
// Replaces the `res_{y,c}_*` and `wht_{y,c}` segments of
// dav1d_tpu/ops/mc_fused.py `_mc_program` (XLA-jitted, not Pallas),
// with the math of dav1d_tpu/ops/mc_jobs.py `res_tx_fn` / `res_jobs_fn`
// (reference src/itx_tmpl.c:43-121, src/itx_1d.c).
//
// Job row (int32, 6 columns; the launch is per plane):
//   tx, ridx, cidx, py, px, cfoff
// ridx / cidx index the 1-D kinds available at the row / column length
// (dav1d_tpu mc_jobs.res_tx_kinds: DCT, ADST, FLIPADST, IDENTITY up to
// 16 points, DCT and IDENTITY at 32, DCT at 64). The sw x sh
// coefficients (sw = min(w, 32), sh = min(h, 32)) sit x-major at cfoff
// in the frame's int32 coefficient pool.
//
// Design. One block of 64 threads per job. Row pass: thread y < sh
// reads row y of the transposed coefficients, applies the rect2 scale,
// runs the row 1-D transform clamped to the row range, then
// (x + rnd) >> TX_SHIFT and the column-range clamp into a shared
// 32 x 64 int64 tile. Column pass: thread x < w runs the column 1-D
// transform, (v + 8) >> 4, adds to the plane and clips. The 1-D
// butterflies are native/itxnat.cpp's (bit-exact with
// dav1d_tpu/ops/itx_core.py), kept here as __device__ functions with
// int64 intermediates, so no 12-bit product can overflow. The TPU
// version computed every kind and selected per job; here a block runs
// only its own kinds.
//
// Bound: memory for the coefficient reads and plane read-modify-write
// (4 + 8 bytes per pixel), operations in practice: int64 butterflies on
// the CUDA cores. A 1080p s7 inter frame's ~2.5k jobs move a few MB
// (~1 us at 3.35 TB/s). This first version is simple, not fast: small
// transforms leave most of the 64 threads idle, and the int64 locals
// live in local memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using i64 = int64_t;
using i32 = int32_t;

// 1-D type enum (ops/itx_core.py order)
enum { ITX_DCT = 0, ITX_ADST = 1, ITX_FLIPADST = 2, ITX_IDENTITY = 3 };

constexpr int THREADS = 64;
constexpr int WHT_THREADS = 128;

// per tx size: (w4, h4, log2 w4, log2 h4) (dav1d_tpu levels.TXFM_INFO)
__constant__ int kTxInfo[19][4] = {
    {1, 1, 0, 0}, {2, 2, 1, 1}, {4, 4, 2, 2}, {8, 8, 3, 3},
    {16, 16, 4, 4}, {1, 2, 0, 1}, {2, 1, 1, 0}, {2, 4, 1, 2},
    {4, 2, 2, 1}, {4, 8, 2, 3}, {8, 4, 3, 2}, {8, 16, 3, 4},
    {16, 8, 4, 3}, {1, 4, 0, 2}, {4, 1, 2, 0}, {2, 8, 1, 3},
    {8, 2, 3, 1}, {4, 16, 2, 4}, {16, 4, 4, 2},
};
// inter-pass shift per tx (reference itx_tmpl.c:160-178)
__constant__ int kTxShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1,
                                 1, 1, 1, 1, 1, 2, 2, 2, 2};

enum { R_TX, R_RIDX, R_CIDX, R_PY, R_PX, R_OFF, R_N };

// dct64 odd-coefficient seeds {k, src, cst}: a[k] = r12(x[src] * cst)
__constant__ int kSeeds[32][3] = {
    {32, 1, 101}, {33, 31, -2824}, {34, 17, 1660}, {35, 15, -1474},
    {36, 9, 897}, {37, 23, -2191}, {38, 25, 2359}, {39, 7, -700},
    {40, 5, 501}, {41, 27, -2520}, {42, 21, 2019}, {43, 11, -1092},
    {44, 13, 1285}, {45, 19, -1842}, {46, 29, 2675}, {47, 3, -301},
    {48, 3, 4085}, {49, 29, 3102}, {50, 19, 3659}, {51, 13, 3889},
    {52, 11, 3948}, {53, 21, 3564}, {54, 27, 3229}, {55, 5, 4065},
    {56, 7, 4036}, {57, 25, 3349}, {58, 23, 3461}, {59, 9, 3996},
    {60, 15, 3822}, {61, 17, 3745}, {62, 31, 2967}, {63, 1, 4095},
};

// dct64 first butterfly pairs {p, q, swap}
__constant__ int kPairs[16][3] = {
    {32, 33, 0}, {34, 35, 1}, {36, 37, 0}, {38, 39, 1},
    {40, 41, 0}, {42, 43, 1}, {44, 45, 0}, {46, 47, 1},
    {48, 49, 0}, {50, 51, 1}, {52, 53, 0}, {54, 55, 1},
    {56, 57, 0}, {58, 59, 1}, {60, 61, 0}, {62, 63, 1},
};

__device__ __forceinline__ i64 r12(i64 v) { return (v + 2048) >> 12; }
__device__ __forceinline__ i64 r11(i64 v) { return (v + 1024) >> 11; }
__device__ __forceinline__ i64 rsqrt2(i64 v) { return (v * 181 + 128) >> 8; }

struct Clip {
    i64 mn, mx;
    __device__ __forceinline__ i64 operator()(i64 v) const {
        return v < mn ? mn : (v > mx ? mx : v);
    }
};

// ---- 1-D transforms: in -> out (out may alias a distinct buffer) ----------

__device__ void dct4(const i64 *x, i64 *o, Clip C, bool tx64) {
    i64 t0, t1, t2, t3;
    const i64 in0 = x[0], in1 = x[1];
    if (tx64) {
        t0 = t1 = rsqrt2(in0);
        t2 = r12(in1 * 1567);
        t3 = r12(in1 * 3784);
    } else {
        const i64 in2 = x[2], in3 = x[3];
        t0 = rsqrt2(in0 + in2);
        t1 = rsqrt2(in0 - in2);
        t2 = r12(in1 * 1567 - in3 * 3784);
        t3 = r12(in1 * 3784 + in3 * 1567);
    }
    o[0] = C(t0 + t3);
    o[1] = C(t1 + t2);
    o[2] = C(t1 - t2);
    o[3] = C(t0 - t3);
}

__device__ void dct8(const i64 *x, i64 *o, Clip C, bool tx64) {
    i64 e[4], lo[4];
    const int ne = tx64 ? 2 : 4;
    for (int i = 0; i < ne; i++) e[i] = x[2 * i];
    dct4(e, lo, C, tx64);
    i64 t4a, t5a, t6a, t7a;
    const i64 in1 = x[1], in3 = x[3];
    if (tx64) {
        t4a = r12(in1 * 799);
        t5a = r12(in3 * -2276);
        t6a = r12(in3 * 3406);
        t7a = r12(in1 * 4017);
    } else {
        const i64 in5 = x[5], in7 = x[7];
        t4a = r12(in1 * 799 - in7 * 4017);
        t5a = r11(in5 * 1703 - in3 * 1138);
        t6a = r11(in5 * 1138 + in3 * 1703);
        t7a = r12(in1 * 4017 + in7 * 799);
    }
    const i64 t4 = C(t4a + t5a);
    t5a = C(t4a - t5a);
    const i64 t7 = C(t7a + t6a);
    t6a = C(t7a - t6a);
    const i64 t5 = rsqrt2(t6a - t5a);
    const i64 t6 = rsqrt2(t6a + t5a);
    o[0] = C(lo[0] + t7);
    o[1] = C(lo[1] + t6);
    o[2] = C(lo[2] + t5);
    o[3] = C(lo[3] + t4);
    o[4] = C(lo[3] - t4);
    o[5] = C(lo[2] - t5);
    o[6] = C(lo[1] - t6);
    o[7] = C(lo[0] - t7);
}

__device__ void dct16(const i64 *x, i64 *o, Clip C, bool tx64) {
    i64 e[8], lo[8];
    const int ne = tx64 ? 4 : 8;
    for (int i = 0; i < ne; i++) e[i] = x[2 * i];
    dct8(e, lo, C, tx64);
    i64 t8a, t9a, t10a, t11a, t12a, t13a, t14a, t15a;
    const i64 in1 = x[1], in3 = x[3], in5 = x[5], in7 = x[7];
    if (tx64) {
        t8a = r12(in1 * 401);
        t9a = r12(in7 * -2598);
        t10a = r12(in5 * 1931);
        t11a = r12(in3 * -1189);
        t12a = r12(in3 * 3920);
        t13a = r12(in5 * 3612);
        t14a = r12(in7 * 3166);
        t15a = r12(in1 * 4076);
    } else {
        const i64 in9 = x[9], in11 = x[11], in13 = x[13], in15 = x[15];
        t8a = r12(in1 * 401 - in15 * 4076);
        t9a = r11(in9 * 1583 - in7 * 1299);
        t10a = r12(in5 * 1931 - in11 * 3612);
        t11a = r12(in13 * 3920 - in3 * 1189);
        t12a = r12(in13 * 1189 + in3 * 3920);
        t13a = r12(in5 * 3612 + in11 * 1931);
        t14a = r11(in9 * 1299 + in7 * 1583);
        t15a = r12(in1 * 4076 + in15 * 401);
    }
    i64 t8 = C(t8a + t9a);
    i64 t9 = C(t8a - t9a);
    i64 t10 = C(t11a - t10a);
    i64 t11 = C(t11a + t10a);
    i64 t12 = C(t12a + t13a);
    i64 t13 = C(t12a - t13a);
    i64 t14 = C(t15a - t14a);
    i64 t15 = C(t15a + t14a);

    t9a = r12(t14 * 1567 - t9 * 3784);
    t14a = r12(t14 * 3784 + t9 * 1567);
    t10a = r12(-(t13 * 3784 + t10 * 1567));
    t13a = r12(t13 * 1567 - t10 * 3784);

    t8a = C(t8 + t11);
    t9 = C(t9a + t10a);
    t10 = C(t9a - t10a);
    t11a = C(t8 - t11);
    t12a = C(t15 - t12);
    t13 = C(t14a - t13a);
    t14 = C(t14a + t13a);
    t15a = C(t15 + t12);

    t10a = rsqrt2(t13 - t10);
    t13a = rsqrt2(t13 + t10);
    t11 = rsqrt2(t12a - t11a);
    t12 = rsqrt2(t12a + t11a);

    const i64 odds[8] = {t15a, t14, t13a, t12, t11, t10a, t9, t8a};
    for (int i = 0; i < 8; i++) {
        o[i] = C(lo[i] + odds[i]);
        o[15 - i] = C(lo[i] - odds[i]);
    }
}

__device__ void dct32(const i64 *x, i64 *o, Clip C, bool tx64) {
    i64 e[16], lo[16];
    const int ne = tx64 ? 8 : 16;
    for (int i = 0; i < ne; i++) e[i] = x[2 * i];
    dct16(e, lo, C, tx64);
    const i64 i1 = x[1], i3 = x[3], i5 = x[5], i7 = x[7];
    const i64 i9 = x[9], i11 = x[11], i13 = x[13], i15 = x[15];
    i64 t16a, t17a, t18a, t19a, t20a, t21a, t22a, t23a;
    i64 t24a, t25a, t26a, t27a, t28a, t29a, t30a, t31a;
    if (tx64) {
        t16a = r12(i1 * 201);
        t17a = r12(i15 * -2751);
        t18a = r12(i9 * 1751);
        t19a = r12(i7 * -1380);
        t20a = r12(i5 * 995);
        t21a = r12(i11 * -2106);
        t22a = r12(i13 * 2440);
        t23a = r12(i3 * -601);
        t24a = r12(i3 * 4052);
        t25a = r12(i13 * 3290);
        t26a = r12(i11 * 3513);
        t27a = r12(i5 * 3973);
        t28a = r12(i7 * 3857);
        t29a = r12(i9 * 3703);
        t30a = r12(i15 * 3035);
        t31a = r12(i1 * 4091);
    } else {
        const i64 i17 = x[17], i19 = x[19], i21 = x[21], i23 = x[23];
        const i64 i25 = x[25], i27 = x[27], i29 = x[29], i31 = x[31];
        t16a = r12(i1 * 201 - i31 * 4091);
        t17a = r12(i17 * 3035 - i15 * 2751);
        t18a = r12(i9 * 1751 - i23 * 3703);
        t19a = r12(i25 * 3857 - i7 * 1380);
        t20a = r12(i5 * 995 - i27 * 3973);
        t21a = r12(i21 * 3513 - i11 * 2106);
        t22a = r11(i13 * 1220 - i19 * 1645);
        t23a = r12(i29 * 4052 - i3 * 601);
        t24a = r12(i29 * 601 + i3 * 4052);
        t25a = r11(i13 * 1645 + i19 * 1220);
        t26a = r12(i21 * 2106 + i11 * 3513);
        t27a = r12(i5 * 3973 + i27 * 995);
        t28a = r12(i25 * 1380 + i7 * 3857);
        t29a = r12(i9 * 3703 + i23 * 1751);
        t30a = r12(i17 * 2751 + i15 * 3035);
        t31a = r12(i1 * 4091 + i31 * 201);
    }

    i64 t16 = C(t16a + t17a), t17 = C(t16a - t17a);
    i64 t18 = C(t19a - t18a), t19 = C(t19a + t18a);
    i64 t20 = C(t20a + t21a), t21 = C(t20a - t21a);
    i64 t22 = C(t23a - t22a), t23 = C(t23a + t22a);
    i64 t24 = C(t24a + t25a), t25 = C(t24a - t25a);
    i64 t26 = C(t27a - t26a), t27 = C(t27a + t26a);
    i64 t28 = C(t28a + t29a), t29 = C(t28a - t29a);
    i64 t30 = C(t31a - t30a), t31 = C(t31a + t30a);

    t17a = r12(t30 * 799 - t17 * 4017);
    t30a = r12(t30 * 4017 + t17 * 799);
    t18a = r12(-(t29 * 4017 + t18 * 799));
    t29a = r12(t29 * 799 - t18 * 4017);
    t21a = r11(t26 * 1703 - t21 * 1138);
    t26a = r11(t26 * 1138 + t21 * 1703);
    t22a = r11(-(t25 * 1138 + t22 * 1703));
    t25a = r11(t25 * 1703 - t22 * 1138);

    t16a = C(t16 + t19);
    const i64 t17_ = C(t17a + t18a);
    const i64 t18_ = C(t17a - t18a);
    t19a = C(t16 - t19);
    t20a = C(t23 - t20);
    const i64 t21_ = C(t22a - t21a);
    const i64 t22_ = C(t22a + t21a);
    t23a = C(t23 + t20);
    t24a = C(t24 + t27);
    const i64 t25_ = C(t25a + t26a);
    const i64 t26_ = C(t25a - t26a);
    t27a = C(t24 - t27);
    t28a = C(t31 - t28);
    const i64 t29_ = C(t30a - t29a);
    const i64 t30_ = C(t30a + t29a);
    t31a = C(t31 + t28);

    const i64 t18n = r12(t29_ * 1567 - t18_ * 3784);
    const i64 t29n = r12(t29_ * 3784 + t18_ * 1567);
    const i64 t19n = r12(t28a * 1567 - t19a * 3784);
    const i64 t28n = r12(t28a * 3784 + t19a * 1567);
    const i64 t20n = r12(-(t27a * 3784 + t20a * 1567));
    const i64 t27n = r12(t27a * 1567 - t20a * 3784);
    const i64 t21n = r12(-(t26_ * 3784 + t21_ * 1567));
    const i64 t26n = r12(t26_ * 1567 - t21_ * 3784);

    const i64 t16_2 = C(t16a + t23a), t17a2 = C(t17_ + t22_);
    const i64 t18_2 = C(t18n + t21n), t19a2 = C(t19n + t20n);
    const i64 t20a2 = C(t19n - t20n), t21_2 = C(t18n - t21n);
    const i64 t22a2 = C(t17_ - t22_), t23_2 = C(t16a - t23a);
    const i64 t24_2 = C(t31a - t24a), t25a2 = C(t30_ - t25_);
    const i64 t26_2 = C(t29n - t26n), t27a2 = C(t28n - t27n);
    const i64 t28a2 = C(t28n + t27n), t29_2 = C(t29n + t26n);
    const i64 t30a2 = C(t30_ + t25_), t31_2 = C(t31a + t24a);

    const i64 t20f = rsqrt2(t27a2 - t20a2);
    const i64 t27f = rsqrt2(t27a2 + t20a2);
    const i64 t21af = rsqrt2(t26_2 - t21_2);
    const i64 t26af = rsqrt2(t26_2 + t21_2);
    const i64 t22f = rsqrt2(t25a2 - t22a2);
    const i64 t25f = rsqrt2(t25a2 + t22a2);
    const i64 t23af = rsqrt2(t24_2 - t23_2);
    const i64 t24af = rsqrt2(t24_2 + t23_2);

    const i64 odds[16] = {t31_2, t30a2, t29_2, t28a2, t27f, t26af, t25f,
                          t24af, t23af, t22f, t21af, t20f, t19a2, t18_2,
                          t17a2, t16_2};
    for (int k = 0; k < 16; k++) {
        o[k] = C(lo[k] + odds[k]);
        o[31 - k] = C(lo[k] - odds[k]);
    }
}

__device__ void dct64(const i64 *x, i64 *o, Clip C) {
    i64 e[16], lo[32];
    for (int i = 0; i < 16; i++) e[i] = x[2 * i];
    dct32(e, lo, C, /*tx64=*/true);

    // a[32..63] = r12(x[src] * cst)   (odd-coefficient seeds)
    i64 a[64], t[64];
    for (int i = 0; i < 32; i++)
        a[kSeeds[i][0]] = r12(x[kSeeds[i][1]] * kSeeds[i][2]);

    for (int i = 0; i < 16; i++) {
        const int p = kPairs[i][0], q = kPairs[i][1], sw = kPairs[i][2];
        if (!sw) {
            t[p] = C(a[p] + a[q]);
            t[q] = C(a[p] - a[q]);
        } else {
            t[p] = C(a[q] - a[p]);
            t[q] = C(a[q] + a[p]);
        }
    }

    const i64 t33a = r12(t[33] * -4076 + t[62] * 401);
    const i64 t34a = r12(t[34] * -401 + t[61] * -4076);
    const i64 t37a = r11(t[37] * -1299 + t[58] * 1583);
    const i64 t38a = r11(t[38] * -1583 + t[57] * -1299);
    const i64 t41a = r12(t[41] * -3612 + t[54] * 1931);
    const i64 t42a = r12(t[42] * -1931 + t[53] * -3612);
    const i64 t45a = r12(t[45] * -1189 + t[50] * 3920);
    const i64 t46a = r12(t[46] * -3920 + t[49] * -1189);
    const i64 t49a = r12(t[46] * -1189 + t[49] * 3920);
    const i64 t50a = r12(t[45] * 3920 + t[50] * 1189);
    const i64 t53a = r12(t[42] * -3612 + t[53] * 1931);
    const i64 t54a = r12(t[41] * 1931 + t[54] * 3612);
    const i64 t57a = r11(t[38] * -1299 + t[57] * 1583);
    const i64 t58a = r11(t[37] * 1583 + t[58] * 1299);
    const i64 t61a = r12(t[34] * -4076 + t[61] * 401);
    const i64 t62a = r12(t[33] * 401 + t[62] * 4076);

    const i64 t32a = C(t[32] + t[35]), t33_ = C(t33a + t34a);
    const i64 t34_ = C(t33a - t34a), t35a = C(t[32] - t[35]);
    const i64 t36a = C(t[39] - t[36]), t37_ = C(t38a - t37a);
    const i64 t38_ = C(t38a + t37a), t39a = C(t[39] + t[36]);
    const i64 t40a = C(t[40] + t[43]), t41_ = C(t41a + t42a);
    const i64 t42_ = C(t41a - t42a), t43a = C(t[40] - t[43]);
    const i64 t44a = C(t[47] - t[44]), t45_ = C(t46a - t45a);
    const i64 t46_ = C(t46a + t45a), t47a = C(t[47] + t[44]);
    const i64 t48a = C(t[48] + t[51]), t49_ = C(t49a + t50a);
    const i64 t50_ = C(t49a - t50a), t51a = C(t[48] - t[51]);
    const i64 t52a = C(t[55] - t[52]), t53_ = C(t54a - t53a);
    const i64 t54_ = C(t54a + t53a), t55a = C(t[55] + t[52]);
    const i64 t56a = C(t[56] + t[59]), t57_ = C(t57a + t58a);
    const i64 t58_ = C(t57a - t58a), t59a = C(t[56] - t[59]);
    const i64 t60a = C(t[63] - t[60]), t61_ = C(t62a - t61a);
    const i64 t62_ = C(t62a + t61a), t63a = C(t[63] + t[60]);

    const i64 t34a2 = r12(t34_ * -4017 + t61_ * 799);
    const i64 t35_ = r12(t35a * -4017 + t60a * 799);
    const i64 t36_ = r12(t36a * -799 + t59a * -4017);
    const i64 t37a2 = r12(t37_ * -799 + t58_ * -4017);
    const i64 t42a2 = r11(t42_ * -1138 + t53_ * 1703);
    const i64 t43_ = r11(t43a * -1138 + t52a * 1703);
    const i64 t44_ = r11(t44a * -1703 + t51a * -1138);
    const i64 t45a2 = r11(t45_ * -1703 + t50_ * -1138);
    const i64 t50a2 = r11(t45_ * -1138 + t50_ * 1703);
    const i64 t51_ = r11(t44a * -1138 + t51a * 1703);
    const i64 t52_ = r11(t43a * 1703 + t52a * 1138);
    const i64 t53a2 = r11(t42_ * 1703 + t53_ * 1138);
    const i64 t58a2 = r12(t37_ * -4017 + t58_ * 799);
    const i64 t59_ = r12(t36a * -4017 + t59a * 799);
    const i64 t60_ = r12(t35a * 799 + t60a * 4017);
    const i64 t61a2 = r12(t34_ * 799 + t61_ * 4017);

    const i64 t32_ = C(t32a + t39a), t33a2 = C(t33_ + t38_);
    const i64 t34_3 = C(t34a2 + t37a2), t35a2 = C(t35_ + t36_);
    const i64 t36a2 = C(t35_ - t36_), t37_3 = C(t34a2 - t37a2);
    const i64 t38a2 = C(t33_ - t38_), t39_ = C(t32a - t39a);
    const i64 t40_ = C(t47a - t40a), t41a2 = C(t46_ - t41_);
    const i64 t42_3 = C(t45a2 - t42a2), t43a2 = C(t44_ - t43_);
    const i64 t44a2 = C(t44_ + t43_), t45_3 = C(t45a2 + t42a2);
    const i64 t46a2 = C(t46_ + t41_), t47_ = C(t47a + t40a);
    const i64 t48_ = C(t48a + t55a), t49a2 = C(t49_ + t54_);
    const i64 t50_3 = C(t50a2 + t53a2), t51a2 = C(t51_ + t52_);
    const i64 t52a2 = C(t51_ - t52_), t53_3 = C(t50a2 - t53a2);
    const i64 t54a2 = C(t49_ - t54_), t55_ = C(t48a - t55a);
    const i64 t56_ = C(t63a - t56a), t57a2 = C(t62_ - t57_);
    const i64 t58_3 = C(t61a2 - t58a2), t59a2 = C(t60_ - t59_);
    const i64 t60a2 = C(t60_ + t59_), t61_3 = C(t61a2 + t58a2);
    const i64 t62a2 = C(t62_ + t57_), t63_ = C(t63a + t56a);

    const i64 t36_4 = r12(t36a2 * -3784 + t59a2 * 1567);
    const i64 t37a3 = r12(t37_3 * -3784 + t58_3 * 1567);
    const i64 t38_4 = r12(t38a2 * -3784 + t57a2 * 1567);
    const i64 t39a3 = r12(t39_ * -3784 + t56_ * 1567);
    const i64 t40a3 = r12(t40_ * -1567 + t55_ * -3784);
    const i64 t41_4 = r12(t41a2 * -1567 + t54a2 * -3784);
    const i64 t42a3 = r12(t42_3 * -1567 + t53_3 * -3784);
    const i64 t43_4 = r12(t43a2 * -1567 + t52a2 * -3784);
    const i64 t52_4 = r12(t43a2 * -3784 + t52a2 * 1567);
    const i64 t53a3 = r12(t42_3 * -3784 + t53_3 * 1567);
    const i64 t54_4 = r12(t41a2 * -3784 + t54a2 * 1567);
    const i64 t55a2 = r12(t40_ * -3784 + t55_ * 1567);
    const i64 t56a2 = r12(t39_ * 1567 + t56_ * 3784);
    const i64 t57_4 = r12(t38a2 * 1567 + t57a2 * 3784);
    const i64 t58a3 = r12(t37_3 * 1567 + t58_3 * 3784);
    const i64 t59_4 = r12(t36a2 * 1567 + t59a2 * 3784);

    const i64 t32a2 = C(t32_ + t47_), t33_5 = C(t33a2 + t46a2);
    const i64 t34a3 = C(t34_3 + t45_3), t35_5 = C(t35a2 + t44a2);
    const i64 t36a3 = C(t36_4 + t43_4), t37_5 = C(t37a3 + t42a3);
    const i64 t38a3 = C(t38_4 + t41_4), t39_5 = C(t39a3 + t40a3);
    const i64 t40_5 = C(t39a3 - t40a3), t41a3 = C(t38_4 - t41_4);
    const i64 t42_5 = C(t37a3 - t42a3), t43a3 = C(t36_4 - t43_4);
    const i64 t44_5 = C(t35a2 - t44a2), t45a3 = C(t34_3 - t45_3);
    const i64 t46_5 = C(t33a2 - t46a2), t47a2 = C(t32_ - t47_);
    const i64 t48a2 = C(t63_ - t48_), t49_5 = C(t62a2 - t49a2);
    const i64 t50a3 = C(t61_3 - t50_3), t51_5 = C(t60a2 - t51a2);
    const i64 t52a3 = C(t59_4 - t52_4), t53_5 = C(t58a3 - t53a3);
    const i64 t54a3 = C(t57_4 - t54_4), t55_5 = C(t56a2 - t55a2);
    const i64 t56_5 = C(t56a2 + t55a2), t57a3 = C(t57_4 + t54_4);
    const i64 t58_5 = C(t58a3 + t53a3), t59a3 = C(t59_4 + t52_4);
    const i64 t60_5 = C(t60a2 + t51a2), t61a3 = C(t61_3 + t50_3);
    const i64 t62_5 = C(t62a2 + t49a2), t63a2 = C(t63_ + t48_);

    const i64 t40a4 = rsqrt2(t55_5 - t40_5);
    const i64 t41_6 = rsqrt2(t54a3 - t41a3);
    const i64 t42a4 = rsqrt2(t53_5 - t42_5);
    const i64 t43_6 = rsqrt2(t52a3 - t43a3);
    const i64 t44a4 = rsqrt2(t51_5 - t44_5);
    const i64 t45_6 = rsqrt2(t50a3 - t45a3);
    const i64 t46a4 = rsqrt2(t49_5 - t46_5);
    const i64 t47_6 = rsqrt2(t48a2 - t47a2);
    const i64 t48_6 = rsqrt2(t47a2 + t48a2);
    const i64 t49a4 = rsqrt2(t46_5 + t49_5);
    const i64 t50_6 = rsqrt2(t45a3 + t50a3);
    const i64 t51a4 = rsqrt2(t44_5 + t51_5);
    const i64 t52_6 = rsqrt2(t43a3 + t52a3);
    const i64 t53a4 = rsqrt2(t42_5 + t53_5);
    const i64 t54_6 = rsqrt2(t41a3 + t54a3);
    const i64 t55a3 = rsqrt2(t40_5 + t55_5);

    const i64 odds[32] = {
        t63a2, t62_5, t61a3, t60_5, t59a3, t58_5, t57a3, t56_5,
        t55a3, t54_6, t53a4, t52_6, t51a4, t50_6, t49a4, t48_6,
        t47_6, t46a4, t45_6, t44a4, t43_6, t42a4, t41_6, t40a4,
        t39_5, t38a3, t37_5, t36a3, t35_5, t34a3, t33_5, t32a2};
    for (int k = 0; k < 32; k++) {
        o[k] = C(lo[k] + odds[k]);
        o[63 - k] = C(lo[k] - odds[k]);
    }
}

__device__ void adst4(const i64 *x, i64 *o) {
    const i64 in0 = x[0], in1 = x[1], in2 = x[2], in3 = x[3];
    o[0] = r12(1321 * in0 + 3803 * in2 + 2482 * in3 + 3344 * in1);
    o[1] = r12(2482 * in0 - 1321 * in2 - 3803 * in3 + 3344 * in1);
    o[2] = (209 * (in0 - in2 + in3) + 128) >> 8;
    o[3] = r12(3803 * in0 + 2482 * in2 - 1321 * in3 - 3344 * in1);
}

__device__ void adst8(const i64 *x, i64 *o, Clip C) {
    i64 t0a = r12(4076 * x[7] + 401 * x[0]);
    i64 t1a = r12(401 * x[7] - 4076 * x[0]);
    i64 t2a = r12(3612 * x[5] + 1931 * x[2]);
    i64 t3a = r12(1931 * x[5] - 3612 * x[2]);
    i64 t4a = r11(1299 * x[3] + 1583 * x[4]);
    i64 t5a = r11(1583 * x[3] - 1299 * x[4]);
    i64 t6a = r12(1189 * x[1] + 3920 * x[6]);
    i64 t7a = r12(3920 * x[1] - 1189 * x[6]);

    const i64 t0 = C(t0a + t4a);
    const i64 t1 = C(t1a + t5a);
    i64 t2 = C(t2a + t6a);
    i64 t3 = C(t3a + t7a);
    const i64 t4 = C(t0a - t4a);
    const i64 t5 = C(t1a - t5a);
    i64 t6 = C(t2a - t6a);
    i64 t7 = C(t3a - t7a);

    t4a = r12(3784 * t4 + 1567 * t5);
    t5a = r12(1567 * t4 - 3784 * t5);
    t6a = r12(3784 * t7 - 1567 * t6);
    t7a = r12(1567 * t7 + 3784 * t6);

    o[0] = C(t0 + t2);
    o[7] = -C(t1 + t3);
    t2 = C(t0 - t2);
    t3 = C(t1 - t3);
    o[1] = -C(t4a + t6a);
    o[6] = C(t5a + t7a);
    t6 = C(t4a - t6a);
    t7 = C(t5a - t7a);
    o[3] = -rsqrt2(t2 + t3);
    o[4] = rsqrt2(t2 - t3);
    o[2] = rsqrt2(t6 + t7);
    o[5] = -rsqrt2(t6 - t7);
}

__device__ void adst16(const i64 *x, i64 *o, Clip C) {
    i64 t0 = r12(x[15] * 4091 + x[0] * 201);
    i64 t1 = r12(x[15] * 201 - x[0] * 4091);
    i64 t2 = r12(x[13] * 3973 + x[2] * 995);
    i64 t3 = r12(x[13] * 995 - x[2] * 3973);
    i64 t4 = r12(x[11] * 3703 + x[4] * 1751);
    i64 t5 = r12(x[11] * 1751 - x[4] * 3703);
    i64 t6 = r11(x[9] * 1645 + x[6] * 1220);
    i64 t7 = r11(x[9] * 1220 - x[6] * 1645);
    i64 t8 = r12(x[7] * 2751 + x[8] * 3035);
    i64 t9 = r12(x[7] * 3035 - x[8] * 2751);
    i64 t10 = r12(x[5] * 2106 + x[10] * 3513);
    i64 t11 = r12(x[5] * 3513 - x[10] * 2106);
    i64 t12 = r12(x[3] * 1380 + x[12] * 3857);
    i64 t13 = r12(x[3] * 3857 - x[12] * 1380);
    i64 t14 = r12(x[1] * 601 + x[14] * 4052);
    i64 t15 = r12(x[1] * 4052 - x[14] * 601);

    i64 t0a = C(t0 + t8), t1a = C(t1 + t9);
    i64 t2a = C(t2 + t10), t3a = C(t3 + t11);
    i64 t4a = C(t4 + t12), t5a = C(t5 + t13);
    i64 t6a = C(t6 + t14), t7a = C(t7 + t15);
    i64 t8a = C(t0 - t8), t9a = C(t1 - t9);
    i64 t10a = C(t2 - t10), t11a = C(t3 - t11);
    i64 t12a = C(t4 - t12), t13a = C(t5 - t13);
    i64 t14a = C(t6 - t14), t15a = C(t7 - t15);

    t8 = r12(t8a * 4017 + t9a * 799);
    t9 = r12(t8a * 799 - t9a * 4017);
    t10 = r12(t10a * 2276 + t11a * 3406);
    t11 = r12(t10a * 3406 - t11a * 2276);
    t12 = r12(t13a * 4017 - t12a * 799);
    t13 = r12(t13a * 799 + t12a * 4017);
    t14 = r12(t15a * 2276 - t14a * 3406);
    t15 = r12(t15a * 3406 + t14a * 2276);

    t0 = C(t0a + t4a);
    t1 = C(t1a + t5a);
    t2 = C(t2a + t6a);
    t3 = C(t3a + t7a);
    t4 = C(t0a - t4a);
    t5 = C(t1a - t5a);
    t6 = C(t2a - t6a);
    t7 = C(t3a - t7a);
    t8a = C(t8 + t12);
    t9a = C(t9 + t13);
    t10a = C(t10 + t14);
    t11a = C(t11 + t15);
    t12a = C(t8 - t12);
    t13a = C(t9 - t13);
    t14a = C(t10 - t14);
    t15a = C(t11 - t15);

    t4a = r12(t4 * 3784 + t5 * 1567);
    t5a = r12(t4 * 1567 - t5 * 3784);
    t6a = r12(t7 * 3784 - t6 * 1567);
    t7a = r12(t7 * 1567 + t6 * 3784);
    t12 = r12(t12a * 3784 + t13a * 1567);
    t13 = r12(t12a * 1567 - t13a * 3784);
    t14 = r12(t15a * 3784 - t14a * 1567);
    t15 = r12(t15a * 1567 + t14a * 3784);

    o[0] = C(t0 + t2);
    o[15] = -C(t1 + t3);
    t2a = C(t0 - t2);
    t3a = C(t1 - t3);
    o[3] = -C(t4a + t6a);
    o[12] = C(t5a + t7a);
    t6 = C(t4a - t6a);
    t7 = C(t5a - t7a);
    o[1] = -C(t8a + t10a);
    o[14] = C(t9a + t11a);
    t10 = C(t8a - t10a);
    t11 = C(t9a - t11a);
    o[2] = C(t12 + t14);
    o[13] = -C(t13 + t15);
    t14a = C(t12 - t14);
    t15a = C(t13 - t15);

    o[7] = -rsqrt2(t2a + t3a);
    o[8] = rsqrt2(t2a - t3a);
    o[4] = rsqrt2(t6 + t7);
    o[11] = -rsqrt2(t6 - t7);
    o[6] = rsqrt2(t10 + t11);
    o[9] = -rsqrt2(t10 - t11);
    o[5] = -rsqrt2(t14a + t15a);
    o[10] = rsqrt2(t14a - t15a);
}

__device__ void identity_n(const i64 *x, i64 *o, int l2) {
    switch (l2) {
    case 2:
        for (int i = 0; i < 4; i++) o[i] = x[i] + ((x[i] * 1697 + 2048) >> 12);
        break;
    case 3:
        for (int i = 0; i < 8; i++) o[i] = x[i] * 2;
        break;
    case 4:
        for (int i = 0; i < 16; i++)
            o[i] = 2 * x[i] + ((x[i] * 1697 + 1024) >> 11);
        break;
    default:
        for (int i = 0; i < 32; i++) o[i] = x[i] * 4;
        break;
    }
}

__device__ void run_tx1d(int type, int l2, const i64 *in, i64 *out, Clip C) {
    const int n = 1 << l2;
    i64 tmp[64];
    switch (type) {
    case ITX_DCT:
        switch (l2) {
        case 2: dct4(in, out, C, false); return;
        case 3: dct8(in, out, C, false); return;
        case 4: dct16(in, out, C, false); return;
        case 5: dct32(in, out, C, false); return;
        default: dct64(in, out, C); return;
        }
    case ITX_ADST:
    case ITX_FLIPADST: {
        i64 *dst = (type == ITX_FLIPADST) ? tmp : out;
        switch (l2) {
        case 2: adst4(in, dst); break;
        case 3: adst8(in, dst, C); break;
        default: adst16(in, dst, C); break;
        }
        if (type == ITX_FLIPADST)
            for (int i = 0; i < n; i++) out[i] = tmp[n - 1 - i];
        return;
    }
    default:
        identity_n(in, out, l2);
        return;
    }
}

__device__ void wht4x1(const i64 *x, i64 *o) {
    const i64 t0 = x[0] + x[1];
    const i64 t2 = x[2] - x[3];
    const i64 t4 = (t0 - t2) >> 1;
    const i64 t3 = t4 - x[3];
    const i64 t1 = t4 - x[1];
    o[0] = t0 - t3;
    o[1] = t3;
    o[2] = t1;
    o[3] = t2 + t1;
}

// res_tx_kinds index -> 1-D kind at length 2^l2
__device__ __forceinline__ int kind_of(int idx, int l2) {
    if (l2 <= 4) return idx;
    return (l2 == 5 && idx) ? ITX_IDENTITY : ITX_DCT;
}

__device__ __forceinline__ int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(THREADS)
itx_add_kernel(const i32 *__restrict__ pool, const i32 *__restrict__ jobs,
           i32 *__restrict__ dst, int dst_h, int dst_w, int bd) {
    __shared__ i64 tmp[32 * 64];
    const i32 *j = jobs + (size_t)blockIdx.x * R_N;
    const int tx = j[R_TX];
    const int w = 4 * kTxInfo[tx][0], h = 4 * kTxInfo[tx][1];
    const int lw2 = kTxInfo[tx][2] + 2, lh2 = kTxInfo[tx][3] + 2;
    const int sw = min(w, 32), sh = min(h, 32);
    const int shift = kTxShift[tx];
    const i64 rnd = (i64)((1 << shift) >> 1);
    const bool is_rect2 = (w * 2 == h) || (h * 2 == w);
    const int px_max = (1 << bd) - 1;
    i64 row_mn, col_mn;
    if (bd == 8) {
        row_mn = col_mn = -(i64)(1 << 15);
    } else {
        row_mn = -((i64)(px_max + 1) << 7);
        col_mn = -((i64)(px_max + 1) << 5);
    }
    const Clip rowC{row_mn, ~row_mn};
    const Clip colC{col_mn, ~col_mn};
    const i32 *__restrict__ cf = pool + j[R_OFF];

    const int t = threadIdx.x;
    if (t < sh) {                       // row pass: row y = t
        i64 in[32], out[64];
        for (int x = 0; x < sw; x++) {
            i64 v = cf[x * sh + t];
            if (is_rect2) v = (v * 181 + 128) >> 8;
            in[x] = v;
        }
        run_tx1d(kind_of(j[R_RIDX], lw2), lw2, in, out, rowC);
        for (int x = 0; x < w; x++)
            tmp[t * w + x] = colC((out[x] + rnd) >> shift);
    }
    __syncthreads();
    if (t < w) {                        // column pass: column x = t
        i64 in[32], out[64];
        for (int y = 0; y < sh; y++) in[y] = tmp[y * w + t];
        run_tx1d(kind_of(j[R_CIDX], lh2), lh2, in, out, colC);
        const int x = j[R_PX] + t;
        for (int y = 0; y < h; y++) {
            const int yy = j[R_PY] + y;
            if (yy < dst_h && x < dst_w) {
                i32 *p = dst + (size_t)yy * dst_w + x;
                *p = iclip(*p + (i32)((out[y] + 8) >> 4), 0, px_max);
            }
        }
    }
}

// one thread per lossless 4x4 job (reference inv_txfm_add_wht_wht_4x4)
__global__ void __launch_bounds__(WHT_THREADS)
itx_wht_kernel(const i32 *__restrict__ pool, const i32 *__restrict__ jobs, int n,
           i32 *__restrict__ dst, int dst_h, int dst_w, int bd) {
    const int i = blockIdx.x * WHT_THREADS + threadIdx.x;
    if (i >= n) return;
    const i32 *j = jobs + (size_t)i * R_N;
    const i32 *cf = pool + j[R_OFF];
    i64 c[4][4], rows[4][4], cols[4][4];
    for (int x = 0; x < 4; x++)
        for (int y = 0; y < 4; y++) c[x][y] = cf[x * 4 + y] >> 2;
    for (int y = 0; y < 4; y++) {
        const i64 in[4] = {c[0][y], c[1][y], c[2][y], c[3][y]};
        wht4x1(in, rows[y]);
    }
    for (int x = 0; x < 4; x++) {
        const i64 in[4] = {rows[0][x], rows[1][x], rows[2][x], rows[3][x]};
        wht4x1(in, cols[x]);
    }
    const int px_max = (1 << bd) - 1;
    for (int y = 0; y < 4; y++) {
        const int yy = j[R_PY] + y;
        for (int x = 0; x < 4; x++) {
            const int xx = j[R_PX] + x;
            if (yy < dst_h && xx < dst_w) {
                i32 *p = dst + (size_t)yy * dst_w + xx;
                *p = iclip(*p + (i32)cols[x][y], 0, px_max);
            }
        }
    }
}

}  // namespace

// Inverse transform + add over n jobs of one plane on `stream`: the
// general kernel, or the WHT kernel when `wht` is nonzero. pool: the
// frame's int32 coefficient pool; dst: int32 (dst_h, dst_w) plane,
// updated in place.
extern "C" int itx_add(const i32 *pool, const i32 *jobs, int n, i32 *dst,
                       int dst_h, int dst_w, int bd, int wht, void *stream) {
    if (n > 0) {
        if (wht)
            itx_wht_kernel<<<(n + WHT_THREADS - 1) / WHT_THREADS, WHT_THREADS, 0,
                         (cudaStream_t)stream>>>(pool, jobs, n, dst, dst_h,
                                                 dst_w, bd);
        else
            itx_add_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
                pool, jobs, dst, dst_h, dst_w, bd);
    }
    return (int)cudaGetLastError();
}
