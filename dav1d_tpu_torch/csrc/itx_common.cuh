// The device code of the residual pass (inverse transform + add),
// shared by csrc/itx_add.cu (its own kernels) and csrc/ipred.cu (the
// residual step of the intra-leftover frame kernel): the 1-D
// transforms, one_pass, the per-block body `itx_block` and the
// per-job WHT `wht_job`. The design and the job and block rows are
// described in itx_add.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using i64 = int64_t;
using i32 = int32_t;

// 1-D type enum (ops/itx_core.py order)
enum { ITX_DCT = 0, ITX_ADST = 1, ITX_FLIPADST = 2, ITX_IDENTITY = 3 };

constexpr int THREADS = 128;
constexpr int WHT_THREADS = 128;
// the largest shared tile of any class: jobs_per_block * sh * (W + 1),
// reached by 32x32 (4 * 32 * 33)
constexpr int TILE_WORDS = 4 * 32 * 33;

enum { R_TX, R_RIDX, R_CIDX, R_PY, R_PX, R_OFF, R_N };
enum { B_CLS, B_FIRST, B_COUNT, B_N };

template <typename T> __device__ __forceinline__ T r12(T v) {
    return (v + 2048) >> 12;
}
template <typename T> __device__ __forceinline__ T r11(T v) {
    return (v + 1024) >> 11;
}
template <typename T> __device__ __forceinline__ T rsqrt2(T v) {
    return (v * 181 + 128) >> 8;
}

template <typename T> struct Clip {
    T mn, mx;
    __device__ __forceinline__ T operator()(T v) const {
        return v < mn ? mn : (v > mx ? mx : v);
    }
};

// ---- 1-D transforms: x -> o (distinct arrays) -----------------------------
// TX64: the transform is a half of a 64-point DCT, whose upper 32
// coefficients are zero (only x[0 .. n/2) is read).

template <typename T, bool TX64>
__device__ __forceinline__ void dct4(const T *x, T *o, Clip<T> C) {
    T t0, t1, t2, t3;
    const T in0 = x[0], in1 = x[1];
    if constexpr (TX64) {
        t0 = t1 = rsqrt2(in0);
        t2 = r12<T>(in1 * 1567);
        t3 = r12<T>(in1 * 3784);
    } else {
        const T in2 = x[2], in3 = x[3];
        t0 = rsqrt2<T>(in0 + in2);
        t1 = rsqrt2<T>(in0 - in2);
        t2 = r12<T>(in1 * 1567 - in3 * 3784);
        t3 = r12<T>(in1 * 3784 + in3 * 1567);
    }
    o[0] = C(t0 + t3);
    o[1] = C(t1 + t2);
    o[2] = C(t1 - t2);
    o[3] = C(t0 - t3);
}

template <typename T, bool TX64>
__device__ __forceinline__ void dct8(const T *x, T *o, Clip<T> C) {
    T e[4] = {}, lo[4];
#pragma unroll
    for (int i = 0; i < (TX64 ? 2 : 4); i++) e[i] = x[2 * i];
    dct4<T, TX64>(e, lo, C);
    T t4a, t5a, t6a, t7a;
    const T in1 = x[1], in3 = x[3];
    if constexpr (TX64) {
        t4a = r12<T>(in1 * 799);
        t5a = r12<T>(in3 * -2276);
        t6a = r12<T>(in3 * 3406);
        t7a = r12<T>(in1 * 4017);
    } else {
        const T in5 = x[5], in7 = x[7];
        t4a = r12<T>(in1 * 799 - in7 * 4017);
        t5a = r11<T>(in5 * 1703 - in3 * 1138);
        t6a = r11<T>(in5 * 1138 + in3 * 1703);
        t7a = r12<T>(in1 * 4017 + in7 * 799);
    }
    const T t4 = C(t4a + t5a);
    t5a = C(t4a - t5a);
    const T t7 = C(t7a + t6a);
    t6a = C(t7a - t6a);
    const T t5 = rsqrt2<T>(t6a - t5a);
    const T t6 = rsqrt2<T>(t6a + t5a);
    o[0] = C(lo[0] + t7);
    o[1] = C(lo[1] + t6);
    o[2] = C(lo[2] + t5);
    o[3] = C(lo[3] + t4);
    o[4] = C(lo[3] - t4);
    o[5] = C(lo[2] - t5);
    o[6] = C(lo[1] - t6);
    o[7] = C(lo[0] - t7);
}

template <typename T, bool TX64>
__device__ __forceinline__ void dct16(const T *x, T *o, Clip<T> C) {
    T e[8] = {}, lo[8];
#pragma unroll
    for (int i = 0; i < (TX64 ? 4 : 8); i++) e[i] = x[2 * i];
    dct8<T, TX64>(e, lo, C);
    T t8a, t9a, t10a, t11a, t12a, t13a, t14a, t15a;
    const T in1 = x[1], in3 = x[3], in5 = x[5], in7 = x[7];
    if constexpr (TX64) {
        t8a = r12<T>(in1 * 401);
        t9a = r12<T>(in7 * -2598);
        t10a = r12<T>(in5 * 1931);
        t11a = r12<T>(in3 * -1189);
        t12a = r12<T>(in3 * 3920);
        t13a = r12<T>(in5 * 3612);
        t14a = r12<T>(in7 * 3166);
        t15a = r12<T>(in1 * 4076);
    } else {
        const T in9 = x[9], in11 = x[11], in13 = x[13], in15 = x[15];
        t8a = r12<T>(in1 * 401 - in15 * 4076);
        t9a = r11<T>(in9 * 1583 - in7 * 1299);
        t10a = r12<T>(in5 * 1931 - in11 * 3612);
        t11a = r12<T>(in13 * 3920 - in3 * 1189);
        t12a = r12<T>(in13 * 1189 + in3 * 3920);
        t13a = r12<T>(in5 * 3612 + in11 * 1931);
        t14a = r11<T>(in9 * 1299 + in7 * 1583);
        t15a = r12<T>(in1 * 4076 + in15 * 401);
    }
    T t8 = C(t8a + t9a);
    T t9 = C(t8a - t9a);
    T t10 = C(t11a - t10a);
    T t11 = C(t11a + t10a);
    T t12 = C(t12a + t13a);
    T t13 = C(t12a - t13a);
    T t14 = C(t15a - t14a);
    T t15 = C(t15a + t14a);

    t9a = r12<T>(t14 * 1567 - t9 * 3784);
    t14a = r12<T>(t14 * 3784 + t9 * 1567);
    t10a = r12<T>(-(t13 * 3784 + t10 * 1567));
    t13a = r12<T>(t13 * 1567 - t10 * 3784);

    t8a = C(t8 + t11);
    t9 = C(t9a + t10a);
    t10 = C(t9a - t10a);
    t11a = C(t8 - t11);
    t12a = C(t15 - t12);
    t13 = C(t14a - t13a);
    t14 = C(t14a + t13a);
    t15a = C(t15 + t12);

    t10a = rsqrt2<T>(t13 - t10);
    t13a = rsqrt2<T>(t13 + t10);
    t11 = rsqrt2<T>(t12a - t11a);
    t12 = rsqrt2<T>(t12a + t11a);

    const T odds[8] = {t15a, t14, t13a, t12, t11, t10a, t9, t8a};
#pragma unroll
    for (int i = 0; i < 8; i++) {
        o[i] = C(lo[i] + odds[i]);
        o[15 - i] = C(lo[i] - odds[i]);
    }
}

template <typename T, bool TX64>
__device__ __forceinline__ void dct32(const T *x, T *o, Clip<T> C) {
    T e[16] = {}, lo[16];
#pragma unroll
    for (int i = 0; i < (TX64 ? 8 : 16); i++) e[i] = x[2 * i];
    dct16<T, TX64>(e, lo, C);
    const T i1 = x[1], i3 = x[3], i5 = x[5], i7 = x[7];
    const T i9 = x[9], i11 = x[11], i13 = x[13], i15 = x[15];
    T t16a, t17a, t18a, t19a, t20a, t21a, t22a, t23a;
    T t24a, t25a, t26a, t27a, t28a, t29a, t30a, t31a;
    if constexpr (TX64) {
        t16a = r12<T>(i1 * 201);
        t17a = r12<T>(i15 * -2751);
        t18a = r12<T>(i9 * 1751);
        t19a = r12<T>(i7 * -1380);
        t20a = r12<T>(i5 * 995);
        t21a = r12<T>(i11 * -2106);
        t22a = r12<T>(i13 * 2440);
        t23a = r12<T>(i3 * -601);
        t24a = r12<T>(i3 * 4052);
        t25a = r12<T>(i13 * 3290);
        t26a = r12<T>(i11 * 3513);
        t27a = r12<T>(i5 * 3973);
        t28a = r12<T>(i7 * 3857);
        t29a = r12<T>(i9 * 3703);
        t30a = r12<T>(i15 * 3035);
        t31a = r12<T>(i1 * 4091);
    } else {
        const T i17 = x[17], i19 = x[19], i21 = x[21], i23 = x[23];
        const T i25 = x[25], i27 = x[27], i29 = x[29], i31 = x[31];
        t16a = r12<T>(i1 * 201 - i31 * 4091);
        t17a = r12<T>(i17 * 3035 - i15 * 2751);
        t18a = r12<T>(i9 * 1751 - i23 * 3703);
        t19a = r12<T>(i25 * 3857 - i7 * 1380);
        t20a = r12<T>(i5 * 995 - i27 * 3973);
        t21a = r12<T>(i21 * 3513 - i11 * 2106);
        t22a = r11<T>(i13 * 1220 - i19 * 1645);
        t23a = r12<T>(i29 * 4052 - i3 * 601);
        t24a = r12<T>(i29 * 601 + i3 * 4052);
        t25a = r11<T>(i13 * 1645 + i19 * 1220);
        t26a = r12<T>(i21 * 2106 + i11 * 3513);
        t27a = r12<T>(i5 * 3973 + i27 * 995);
        t28a = r12<T>(i25 * 1380 + i7 * 3857);
        t29a = r12<T>(i9 * 3703 + i23 * 1751);
        t30a = r12<T>(i17 * 2751 + i15 * 3035);
        t31a = r12<T>(i1 * 4091 + i31 * 201);
    }

    T t16 = C(t16a + t17a), t17 = C(t16a - t17a);
    T t18 = C(t19a - t18a), t19 = C(t19a + t18a);
    T t20 = C(t20a + t21a), t21 = C(t20a - t21a);
    T t22 = C(t23a - t22a), t23 = C(t23a + t22a);
    T t24 = C(t24a + t25a), t25 = C(t24a - t25a);
    T t26 = C(t27a - t26a), t27 = C(t27a + t26a);
    T t28 = C(t28a + t29a), t29 = C(t28a - t29a);
    T t30 = C(t31a - t30a), t31 = C(t31a + t30a);

    t17a = r12<T>(t30 * 799 - t17 * 4017);
    t30a = r12<T>(t30 * 4017 + t17 * 799);
    t18a = r12<T>(-(t29 * 4017 + t18 * 799));
    t29a = r12<T>(t29 * 799 - t18 * 4017);
    t21a = r11<T>(t26 * 1703 - t21 * 1138);
    t26a = r11<T>(t26 * 1138 + t21 * 1703);
    t22a = r11<T>(-(t25 * 1138 + t22 * 1703));
    t25a = r11<T>(t25 * 1703 - t22 * 1138);

    t16a = C(t16 + t19);
    const T t17_ = C(t17a + t18a);
    const T t18_ = C(t17a - t18a);
    t19a = C(t16 - t19);
    t20a = C(t23 - t20);
    const T t21_ = C(t22a - t21a);
    const T t22_ = C(t22a + t21a);
    t23a = C(t23 + t20);
    t24a = C(t24 + t27);
    const T t25_ = C(t25a + t26a);
    const T t26_ = C(t25a - t26a);
    t27a = C(t24 - t27);
    t28a = C(t31 - t28);
    const T t29_ = C(t30a - t29a);
    const T t30_ = C(t30a + t29a);
    t31a = C(t31 + t28);

    const T t18n = r12<T>(t29_ * 1567 - t18_ * 3784);
    const T t29n = r12<T>(t29_ * 3784 + t18_ * 1567);
    const T t19n = r12<T>(t28a * 1567 - t19a * 3784);
    const T t28n = r12<T>(t28a * 3784 + t19a * 1567);
    const T t20n = r12<T>(-(t27a * 3784 + t20a * 1567));
    const T t27n = r12<T>(t27a * 1567 - t20a * 3784);
    const T t21n = r12<T>(-(t26_ * 3784 + t21_ * 1567));
    const T t26n = r12<T>(t26_ * 1567 - t21_ * 3784);

    const T t16_2 = C(t16a + t23a), t17a2 = C(t17_ + t22_);
    const T t18_2 = C(t18n + t21n), t19a2 = C(t19n + t20n);
    const T t20a2 = C(t19n - t20n), t21_2 = C(t18n - t21n);
    const T t22a2 = C(t17_ - t22_), t23_2 = C(t16a - t23a);
    const T t24_2 = C(t31a - t24a), t25a2 = C(t30_ - t25_);
    const T t26_2 = C(t29n - t26n), t27a2 = C(t28n - t27n);
    const T t28a2 = C(t28n + t27n), t29_2 = C(t29n + t26n);
    const T t30a2 = C(t30_ + t25_), t31_2 = C(t31a + t24a);

    const T t20f = rsqrt2<T>(t27a2 - t20a2);
    const T t27f = rsqrt2<T>(t27a2 + t20a2);
    const T t21af = rsqrt2<T>(t26_2 - t21_2);
    const T t26af = rsqrt2<T>(t26_2 + t21_2);
    const T t22f = rsqrt2<T>(t25a2 - t22a2);
    const T t25f = rsqrt2<T>(t25a2 + t22a2);
    const T t23af = rsqrt2<T>(t24_2 - t23_2);
    const T t24af = rsqrt2<T>(t24_2 + t23_2);

    const T odds[16] = {t31_2, t30a2, t29_2, t28a2, t27f, t26af, t25f,
                        t24af, t23af, t22f, t21af, t20f, t19a2, t18_2,
                        t17a2, t16_2};
#pragma unroll
    for (int k = 0; k < 16; k++) {
        o[k] = C(lo[k] + odds[k]);
        o[31 - k] = C(lo[k] - odds[k]);
    }
}

// x: the 32 coded coefficients; o: 64 outputs
template <typename T>
__device__ __forceinline__ void dct64(const T *x, T *o, Clip<T> C) {
    T e[16], lo[32];
#pragma unroll
    for (int i = 0; i < 16; i++) e[i] = x[2 * i];
    dct32<T, true>(e, lo, C);

    // a[32..63] = r12(x[src] * cst): the odd-coefficient seeds
    T a[64], t[64];
#define SEED(k, src, cst) a[k] = r12<T>(x[src] * (cst));
    SEED(32, 1, 101) SEED(33, 31, -2824) SEED(34, 17, 1660)
    SEED(35, 15, -1474) SEED(36, 9, 897) SEED(37, 23, -2191)
    SEED(38, 25, 2359) SEED(39, 7, -700) SEED(40, 5, 501)
    SEED(41, 27, -2520) SEED(42, 21, 2019) SEED(43, 11, -1092)
    SEED(44, 13, 1285) SEED(45, 19, -1842) SEED(46, 29, 2675)
    SEED(47, 3, -301) SEED(48, 3, 4085) SEED(49, 29, 3102)
    SEED(50, 19, 3659) SEED(51, 13, 3889) SEED(52, 11, 3948)
    SEED(53, 21, 3564) SEED(54, 27, 3229) SEED(55, 5, 4065)
    SEED(56, 7, 4036) SEED(57, 25, 3349) SEED(58, 23, 3461)
    SEED(59, 9, 3996) SEED(60, 15, 3822) SEED(61, 17, 3745)
    SEED(62, 31, 2967) SEED(63, 1, 4095)
#undef SEED
    // first butterflies: (p, q) pairs, every second one swapped
#pragma unroll
    for (int p = 32; p < 64; p += 4) {
        t[p] = C(a[p] + a[p + 1]);
        t[p + 1] = C(a[p] - a[p + 1]);
        t[p + 2] = C(a[p + 3] - a[p + 2]);
        t[p + 3] = C(a[p + 3] + a[p + 2]);
    }

    const T t33a = r12<T>(t[33] * -4076 + t[62] * 401);
    const T t34a = r12<T>(t[34] * -401 + t[61] * -4076);
    const T t37a = r11<T>(t[37] * -1299 + t[58] * 1583);
    const T t38a = r11<T>(t[38] * -1583 + t[57] * -1299);
    const T t41a = r12<T>(t[41] * -3612 + t[54] * 1931);
    const T t42a = r12<T>(t[42] * -1931 + t[53] * -3612);
    const T t45a = r12<T>(t[45] * -1189 + t[50] * 3920);
    const T t46a = r12<T>(t[46] * -3920 + t[49] * -1189);
    const T t49a = r12<T>(t[46] * -1189 + t[49] * 3920);
    const T t50a = r12<T>(t[45] * 3920 + t[50] * 1189);
    const T t53a = r12<T>(t[42] * -3612 + t[53] * 1931);
    const T t54a = r12<T>(t[41] * 1931 + t[54] * 3612);
    const T t57a = r11<T>(t[38] * -1299 + t[57] * 1583);
    const T t58a = r11<T>(t[37] * 1583 + t[58] * 1299);
    const T t61a = r12<T>(t[34] * -4076 + t[61] * 401);
    const T t62a = r12<T>(t[33] * 401 + t[62] * 4076);

    const T t32a = C(t[32] + t[35]), t33_ = C(t33a + t34a);
    const T t34_ = C(t33a - t34a), t35a = C(t[32] - t[35]);
    const T t36a = C(t[39] - t[36]), t37_ = C(t38a - t37a);
    const T t38_ = C(t38a + t37a), t39a = C(t[39] + t[36]);
    const T t40a = C(t[40] + t[43]), t41_ = C(t41a + t42a);
    const T t42_ = C(t41a - t42a), t43a = C(t[40] - t[43]);
    const T t44a = C(t[47] - t[44]), t45_ = C(t46a - t45a);
    const T t46_ = C(t46a + t45a), t47a = C(t[47] + t[44]);
    const T t48a = C(t[48] + t[51]), t49_ = C(t49a + t50a);
    const T t50_ = C(t49a - t50a), t51a = C(t[48] - t[51]);
    const T t52a = C(t[55] - t[52]), t53_ = C(t54a - t53a);
    const T t54_ = C(t54a + t53a), t55a = C(t[55] + t[52]);
    const T t56a = C(t[56] + t[59]), t57_ = C(t57a + t58a);
    const T t58_ = C(t57a - t58a), t59a = C(t[56] - t[59]);
    const T t60a = C(t[63] - t[60]), t61_ = C(t62a - t61a);
    const T t62_ = C(t62a + t61a), t63a = C(t[63] + t[60]);

    const T t34a2 = r12<T>(t34_ * -4017 + t61_ * 799);
    const T t35_ = r12<T>(t35a * -4017 + t60a * 799);
    const T t36_ = r12<T>(t36a * -799 + t59a * -4017);
    const T t37a2 = r12<T>(t37_ * -799 + t58_ * -4017);
    const T t42a2 = r11<T>(t42_ * -1138 + t53_ * 1703);
    const T t43_ = r11<T>(t43a * -1138 + t52a * 1703);
    const T t44_ = r11<T>(t44a * -1703 + t51a * -1138);
    const T t45a2 = r11<T>(t45_ * -1703 + t50_ * -1138);
    const T t50a2 = r11<T>(t45_ * -1138 + t50_ * 1703);
    const T t51_ = r11<T>(t44a * -1138 + t51a * 1703);
    const T t52_ = r11<T>(t43a * 1703 + t52a * 1138);
    const T t53a2 = r11<T>(t42_ * 1703 + t53_ * 1138);
    const T t58a2 = r12<T>(t37_ * -4017 + t58_ * 799);
    const T t59_ = r12<T>(t36a * -4017 + t59a * 799);
    const T t60_ = r12<T>(t35a * 799 + t60a * 4017);
    const T t61a2 = r12<T>(t34_ * 799 + t61_ * 4017);

    const T t32_ = C(t32a + t39a), t33a2 = C(t33_ + t38_);
    const T t34_3 = C(t34a2 + t37a2), t35a2 = C(t35_ + t36_);
    const T t36a2 = C(t35_ - t36_), t37_3 = C(t34a2 - t37a2);
    const T t38a2 = C(t33_ - t38_), t39_ = C(t32a - t39a);
    const T t40_ = C(t47a - t40a), t41a2 = C(t46_ - t41_);
    const T t42_3 = C(t45a2 - t42a2), t43a2 = C(t44_ - t43_);
    const T t44a2 = C(t44_ + t43_), t45_3 = C(t45a2 + t42a2);
    const T t46a2 = C(t46_ + t41_), t47_ = C(t47a + t40a);
    const T t48_ = C(t48a + t55a), t49a2 = C(t49_ + t54_);
    const T t50_3 = C(t50a2 + t53a2), t51a2 = C(t51_ + t52_);
    const T t52a2 = C(t51_ - t52_), t53_3 = C(t50a2 - t53a2);
    const T t54a2 = C(t49_ - t54_), t55_ = C(t48a - t55a);
    const T t56_ = C(t63a - t56a), t57a2 = C(t62_ - t57_);
    const T t58_3 = C(t61a2 - t58a2), t59a2 = C(t60_ - t59_);
    const T t60a2 = C(t60_ + t59_), t61_3 = C(t61a2 + t58a2);
    const T t62a2 = C(t62_ + t57_), t63_ = C(t63a + t56a);

    const T t36_4 = r12<T>(t36a2 * -3784 + t59a2 * 1567);
    const T t37a3 = r12<T>(t37_3 * -3784 + t58_3 * 1567);
    const T t38_4 = r12<T>(t38a2 * -3784 + t57a2 * 1567);
    const T t39a3 = r12<T>(t39_ * -3784 + t56_ * 1567);
    const T t40a3 = r12<T>(t40_ * -1567 + t55_ * -3784);
    const T t41_4 = r12<T>(t41a2 * -1567 + t54a2 * -3784);
    const T t42a3 = r12<T>(t42_3 * -1567 + t53_3 * -3784);
    const T t43_4 = r12<T>(t43a2 * -1567 + t52a2 * -3784);
    const T t52_4 = r12<T>(t43a2 * -3784 + t52a2 * 1567);
    const T t53a3 = r12<T>(t42_3 * -3784 + t53_3 * 1567);
    const T t54_4 = r12<T>(t41a2 * -3784 + t54a2 * 1567);
    const T t55a2 = r12<T>(t40_ * -3784 + t55_ * 1567);
    const T t56a2 = r12<T>(t39_ * 1567 + t56_ * 3784);
    const T t57_4 = r12<T>(t38a2 * 1567 + t57a2 * 3784);
    const T t58a3 = r12<T>(t37_3 * 1567 + t58_3 * 3784);
    const T t59_4 = r12<T>(t36a2 * 1567 + t59a2 * 3784);

    const T t32a2 = C(t32_ + t47_), t33_5 = C(t33a2 + t46a2);
    const T t34a3 = C(t34_3 + t45_3), t35_5 = C(t35a2 + t44a2);
    const T t36a3 = C(t36_4 + t43_4), t37_5 = C(t37a3 + t42a3);
    const T t38a3 = C(t38_4 + t41_4), t39_5 = C(t39a3 + t40a3);
    const T t40_5 = C(t39a3 - t40a3), t41a3 = C(t38_4 - t41_4);
    const T t42_5 = C(t37a3 - t42a3), t43a3 = C(t36_4 - t43_4);
    const T t44_5 = C(t35a2 - t44a2), t45a3 = C(t34_3 - t45_3);
    const T t46_5 = C(t33a2 - t46a2), t47a2 = C(t32_ - t47_);
    const T t48a2 = C(t63_ - t48_), t49_5 = C(t62a2 - t49a2);
    const T t50a3 = C(t61_3 - t50_3), t51_5 = C(t60a2 - t51a2);
    const T t52a3 = C(t59_4 - t52_4), t53_5 = C(t58a3 - t53a3);
    const T t54a3 = C(t57_4 - t54_4), t55_5 = C(t56a2 - t55a2);
    const T t56_5 = C(t56a2 + t55a2), t57a3 = C(t57_4 + t54_4);
    const T t58_5 = C(t58a3 + t53a3), t59a3 = C(t59_4 + t52_4);
    const T t60_5 = C(t60a2 + t51a2), t61a3 = C(t61_3 + t50_3);
    const T t62_5 = C(t62a2 + t49a2), t63a2 = C(t63_ + t48_);

    const T t40a4 = rsqrt2<T>(t55_5 - t40_5);
    const T t41_6 = rsqrt2<T>(t54a3 - t41a3);
    const T t42a4 = rsqrt2<T>(t53_5 - t42_5);
    const T t43_6 = rsqrt2<T>(t52a3 - t43a3);
    const T t44a4 = rsqrt2<T>(t51_5 - t44_5);
    const T t45_6 = rsqrt2<T>(t50a3 - t45a3);
    const T t46a4 = rsqrt2<T>(t49_5 - t46_5);
    const T t47_6 = rsqrt2<T>(t48a2 - t47a2);
    const T t48_6 = rsqrt2<T>(t47a2 + t48a2);
    const T t49a4 = rsqrt2<T>(t46_5 + t49_5);
    const T t50_6 = rsqrt2<T>(t45a3 + t50a3);
    const T t51a4 = rsqrt2<T>(t44_5 + t51_5);
    const T t52_6 = rsqrt2<T>(t43a3 + t52a3);
    const T t53a4 = rsqrt2<T>(t42_5 + t53_5);
    const T t54_6 = rsqrt2<T>(t41a3 + t54a3);
    const T t55a3 = rsqrt2<T>(t40_5 + t55_5);

    const T odds[32] = {
        t63a2, t62_5, t61a3, t60_5, t59a3, t58_5, t57a3, t56_5,
        t55a3, t54_6, t53a4, t52_6, t51a4, t50_6, t49a4, t48_6,
        t47_6, t46a4, t45_6, t44a4, t43_6, t42a4, t41_6, t40a4,
        t39_5, t38a3, t37_5, t36a3, t35_5, t34a3, t33_5, t32a2};
#pragma unroll
    for (int k = 0; k < 32; k++) {
        o[k] = C(lo[k] + odds[k]);
        o[63 - k] = C(lo[k] - odds[k]);
    }
}

template <typename T>
__device__ __forceinline__ void adst4(const T *x, T *o) {
    const T in0 = x[0], in1 = x[1], in2 = x[2], in3 = x[3];
    o[0] = r12<T>(1321 * in0 + 3803 * in2 + 2482 * in3 + 3344 * in1);
    o[1] = r12<T>(2482 * in0 - 1321 * in2 - 3803 * in3 + 3344 * in1);
    o[2] = (209 * (in0 - in2 + in3) + 128) >> 8;
    o[3] = r12<T>(3803 * in0 + 2482 * in2 - 1321 * in3 - 3344 * in1);
}

template <typename T>
__device__ __forceinline__ void adst8(const T *x, T *o, Clip<T> C) {
    T t0a = r12<T>(4076 * x[7] + 401 * x[0]);
    T t1a = r12<T>(401 * x[7] - 4076 * x[0]);
    T t2a = r12<T>(3612 * x[5] + 1931 * x[2]);
    T t3a = r12<T>(1931 * x[5] - 3612 * x[2]);
    T t4a = r11<T>(1299 * x[3] + 1583 * x[4]);
    T t5a = r11<T>(1583 * x[3] - 1299 * x[4]);
    T t6a = r12<T>(1189 * x[1] + 3920 * x[6]);
    T t7a = r12<T>(3920 * x[1] - 1189 * x[6]);

    const T t0 = C(t0a + t4a);
    const T t1 = C(t1a + t5a);
    T t2 = C(t2a + t6a);
    T t3 = C(t3a + t7a);
    const T t4 = C(t0a - t4a);
    const T t5 = C(t1a - t5a);
    T t6 = C(t2a - t6a);
    T t7 = C(t3a - t7a);

    t4a = r12<T>(3784 * t4 + 1567 * t5);
    t5a = r12<T>(1567 * t4 - 3784 * t5);
    t6a = r12<T>(3784 * t7 - 1567 * t6);
    t7a = r12<T>(1567 * t7 + 3784 * t6);

    o[0] = C(t0 + t2);
    o[7] = -C(t1 + t3);
    t2 = C(t0 - t2);
    t3 = C(t1 - t3);
    o[1] = -C(t4a + t6a);
    o[6] = C(t5a + t7a);
    t6 = C(t4a - t6a);
    t7 = C(t5a - t7a);
    o[3] = -rsqrt2<T>(t2 + t3);
    o[4] = rsqrt2<T>(t2 - t3);
    o[2] = rsqrt2<T>(t6 + t7);
    o[5] = -rsqrt2<T>(t6 - t7);
}

template <typename T>
__device__ __forceinline__ void adst16(const T *x, T *o, Clip<T> C) {
    T t0 = r12<T>(x[15] * 4091 + x[0] * 201);
    T t1 = r12<T>(x[15] * 201 - x[0] * 4091);
    T t2 = r12<T>(x[13] * 3973 + x[2] * 995);
    T t3 = r12<T>(x[13] * 995 - x[2] * 3973);
    T t4 = r12<T>(x[11] * 3703 + x[4] * 1751);
    T t5 = r12<T>(x[11] * 1751 - x[4] * 3703);
    T t6 = r11<T>(x[9] * 1645 + x[6] * 1220);
    T t7 = r11<T>(x[9] * 1220 - x[6] * 1645);
    T t8 = r12<T>(x[7] * 2751 + x[8] * 3035);
    T t9 = r12<T>(x[7] * 3035 - x[8] * 2751);
    T t10 = r12<T>(x[5] * 2106 + x[10] * 3513);
    T t11 = r12<T>(x[5] * 3513 - x[10] * 2106);
    T t12 = r12<T>(x[3] * 1380 + x[12] * 3857);
    T t13 = r12<T>(x[3] * 3857 - x[12] * 1380);
    T t14 = r12<T>(x[1] * 601 + x[14] * 4052);
    T t15 = r12<T>(x[1] * 4052 - x[14] * 601);

    T t0a = C(t0 + t8), t1a = C(t1 + t9);
    T t2a = C(t2 + t10), t3a = C(t3 + t11);
    T t4a = C(t4 + t12), t5a = C(t5 + t13);
    T t6a = C(t6 + t14), t7a = C(t7 + t15);
    T t8a = C(t0 - t8), t9a = C(t1 - t9);
    T t10a = C(t2 - t10), t11a = C(t3 - t11);
    T t12a = C(t4 - t12), t13a = C(t5 - t13);
    T t14a = C(t6 - t14), t15a = C(t7 - t15);

    t8 = r12<T>(t8a * 4017 + t9a * 799);
    t9 = r12<T>(t8a * 799 - t9a * 4017);
    t10 = r12<T>(t10a * 2276 + t11a * 3406);
    t11 = r12<T>(t10a * 3406 - t11a * 2276);
    t12 = r12<T>(t13a * 4017 - t12a * 799);
    t13 = r12<T>(t13a * 799 + t12a * 4017);
    t14 = r12<T>(t15a * 2276 - t14a * 3406);
    t15 = r12<T>(t15a * 3406 + t14a * 2276);

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

    t4a = r12<T>(t4 * 3784 + t5 * 1567);
    t5a = r12<T>(t4 * 1567 - t5 * 3784);
    t6a = r12<T>(t7 * 3784 - t6 * 1567);
    t7a = r12<T>(t7 * 1567 + t6 * 3784);
    t12 = r12<T>(t12a * 3784 + t13a * 1567);
    t13 = r12<T>(t12a * 1567 - t13a * 3784);
    t14 = r12<T>(t15a * 3784 - t14a * 1567);
    t15 = r12<T>(t15a * 1567 + t14a * 3784);

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

    o[7] = -rsqrt2<T>(t2a + t3a);
    o[8] = rsqrt2<T>(t2a - t3a);
    o[4] = rsqrt2<T>(t6 + t7);
    o[11] = -rsqrt2<T>(t6 - t7);
    o[6] = rsqrt2<T>(t10 + t11);
    o[9] = -rsqrt2<T>(t10 - t11);
    o[5] = -rsqrt2<T>(t14a + t15a);
    o[10] = rsqrt2<T>(t14a - t15a);
}

template <int N, typename T>
__device__ __forceinline__ void identity(const T *x, T *o) {
#pragma unroll
    for (int i = 0; i < N; i++) {
        if constexpr (N == 4) o[i] = x[i] + ((x[i] * 1697 + 2048) >> 12);
        else if constexpr (N == 8) o[i] = x[i] * 2;
        else if constexpr (N == 16)
            o[i] = 2 * x[i] + ((x[i] * 1697 + 1024) >> 11);
        else o[i] = x[i] * 4;
    }
}

template <int N, typename T>
__device__ __forceinline__ void dct(const T *x, T *o, Clip<T> C) {
    if constexpr (N == 4) dct4<T, false>(x, o, C);
    else if constexpr (N == 8) dct8<T, false>(x, o, C);
    else if constexpr (N == 16) dct16<T, false>(x, o, C);
    else if constexpr (N == 32) dct32<T, false>(x, o, C);
    else dct64<T>(x, o, C);
}

template <int N, typename T>
__device__ __forceinline__ void adst(const T *x, T *o, Clip<T> C) {
    if constexpr (N == 4) adst4<T>(x, o);
    else if constexpr (N == 8) adst8<T>(x, o, C);
    else adst16<T>(x, o, C);
}

// N-point 1-D transform of res_tx_kinds index `idx` (block-uniform):
// any of the four kinds up to 16 points, DCT / IDENTITY at 32, DCT at 64
template <int N, typename T>
__device__ __forceinline__ void tx1d(int idx, const T *x, T *o, Clip<T> C) {
    if constexpr (N == 64) {
        dct<64, T>(x, o, C);
    } else if constexpr (N == 32) {
        if (idx) identity<32, T>(x, o);
        else dct<32, T>(x, o, C);
    } else {
        switch (idx) {
        case ITX_DCT: dct<N, T>(x, o, C); break;
        case ITX_ADST:
        case ITX_FLIPADST: {            // one copy of the ADST for both
            T tmp[N];
            adst<N, T>(x, tmp, C);
            const bool flip = idx == ITX_FLIPADST;
#pragma unroll
            for (int i = 0; i < N; i++) o[i] = flip ? tmp[N - 1 - i] : tmp[i];
            break;
        }
        default: identity<N, T>(x, o); break;
        }
    }
}

__device__ __forceinline__ int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// (W, H, inter-pass shift) per tx: dav1d_tpu levels.TXFM_INFO and the
// reference itx_tmpl.c:160-178
__constant__ int kTx[19][3] = {
    {4, 4, 0},   {8, 8, 1},   {16, 16, 2}, {32, 32, 2}, {64, 64, 2},
    {4, 8, 0},   {8, 4, 0},   {8, 16, 1},  {16, 8, 1},  {16, 32, 1},
    {32, 16, 1}, {32, 64, 1}, {64, 32, 1}, {4, 16, 1},  {16, 4, 1},
    {8, 32, 2},  {32, 8, 2},  {16, 64, 2}, {64, 16, 2},
};

// a block's class geometry (block-uniform): W, min(H, 32) and their
// log2, the tile's row stride W + 1, the inter-pass shift, rect2
struct Geo {
    int w, sh, lw, lsh, stride, shift;
    bool rect2;
};

// One N-point 1-D pass over the block's `count` jobs. Rows (N = W): one
// thread per (job, row) reads the coefficients, applies the rect2
// scale, transforms, and writes (x + rnd) >> shift with the column
// clamp into the shared tile. Columns (N = H): one thread per (job,
// column) reads the tile, transforms, and adds (v + 8) >> 4 to the
// plane. Every class and both passes share the one copy of the code of
// each N, so a launch runs five copies of the butterflies at most and
// the instruction cache stays warm across its blocks.
template <int N, typename T>
__device__ __forceinline__ void one_pass(
        bool row, const Geo &g, int count, const i32 *__restrict__ pool,
        const i32 *__restrict__ jobs, int kidx, i32 *__restrict__ dst,
        int dst_h, int dst_w, int px_max, Clip<T> C, Clip<T> colC,
        T *tile) {
    constexpr int NI = N < 32 ? N : 32;         // coded inputs
    const int t = threadIdx.x;
    const int lper = row ? g.lsh : g.lw;        // log2 threads per job
    const int s = t >> lper, k = t & ((1 << lper) - 1);
    if (s >= count) return;
    const i32 *j = jobs + (size_t)s * R_N;
    T *jt = tile + (s << g.lsh) * g.stride;     // the job's tile
    T in[NI], out[N];
    // the plane's pixels are read all before any is written (a store
    // could alias the next load, which would serialise N round trips);
    // at int32 up to 32 rows they load before the transform and arrive
    // while it runs; at 64 rows after it, at int64 in chunks of 16
    constexpr bool EARLY = sizeof(T) == 4 && N <= 32;
    constexpr int CH = sizeof(T) == 4 ? N : (N < 16 ? N : 16);
    i32 old[N];
    int rows = 0;
    i32 *d = dst;
    if (row) {
        const i32 *cf = pool + j[R_OFF];
#pragma unroll
        for (int x = 0; x < NI; x++) {
            T v = cf[x * (1 << g.lsh) + k];
            if (g.rect2) v = (v * 181 + 128) >> 8;
            in[x] = v;
        }
    } else {
        const int xx = j[R_PX] + k, py = j[R_PY];
        rows = xx < dst_w ? min(N, dst_h - py) : 0;
        d = dst + (size_t)py * dst_w + xx;
        if constexpr (EARLY) {
#pragma unroll
            for (int y = 0; y < N; y++)
                old[y] = y < rows ? d[(size_t)y * dst_w] : 0;
        }
#pragma unroll
        for (int y = 0; y < NI; y++) in[y] = jt[y * g.stride + k];
    }
    tx1d<N, T>(kidx, in, out, C);
    if (row) {
        T *r = jt + k * g.stride;
        const T rnd = (T)((1 << g.shift) >> 1);
#pragma unroll
        for (int x = 0; x < N; x++) r[x] = colC((out[x] + rnd) >> g.shift);
        return;
    }
#pragma unroll
    for (int y0 = 0; y0 < N; y0 += CH) {
        if constexpr (!EARLY) {
#pragma unroll
            for (int y = y0; y < y0 + CH; y++)
                old[y] = y < rows ? d[(size_t)y * dst_w] : 0;
        }
#pragma unroll
        for (int y = y0; y < y0 + CH; y++)
            if (y < rows)
                d[(size_t)y * dst_w] =
                    iclip(old[y] + (i32)((out[y] + 8) >> 4), 0, px_max);
    }
}

// The per-block body of the residual kernel: the block row `b` (cls,
// first, count: `count` jobs of class cls = tx << 4 | ridx << 2 | cidx
// from row `first` of `jobs`) added into dst by the block's THREADS
// threads, through `tile`, the block's TILE_WORDS shared words. A class
// past the 19 sizes or a block of more jobs than its class fits traps.
template <typename T>
__device__ __forceinline__ void itx_block(
        const i32 *__restrict__ pool, const i32 *__restrict__ jobs,
        const i32 *__restrict__ b, i32 *__restrict__ dst, int dst_h,
        int dst_w, int bd, T *tile) {
    const int cls = b[B_CLS], count = b[B_COUNT];
    const int tx = cls >> 4, ridx = (cls >> 2) & 3, cidx = cls & 3;
    if (tx >= 19) __trap();
    Geo g;
    g.w = kTx[tx][0];
    const int h = kTx[tx][1];
    g.shift = kTx[tx][2];
    g.sh = min(h, 32);
    g.lw = __ffs(g.w) - 1;
    g.lsh = __ffs(g.sh) - 1;
    g.stride = g.w + 1;
    g.rect2 = g.w * 2 == h || h * 2 == g.w;
    // jobs per block: the threads over the larger of sh rows and W
    // columns (ops/itx.py jobs_per_block); their tile fits TILE_WORDS
    if (count > THREADS >> max(g.lw, g.lsh)) __trap();
    const i32 *jb = jobs + (size_t)b[B_FIRST] * R_N;
    const int px_max = (1 << bd) - 1;
    T row_mn, col_mn;
    if (bd == 8) {
        row_mn = col_mn = -(T)(1 << 15);
    } else {
        row_mn = -((T)(px_max + 1) << 7);
        col_mn = -((T)(px_max + 1) << 5);
    }
    const Clip<T> rowC{row_mn, (T)~row_mn};
    const Clip<T> colC{col_mn, (T)~col_mn};
#pragma unroll 1
    for (int pass = 0; pass < 2; pass++) {
        const bool row = pass == 0;
        const int kidx = row ? ridx : cidx;
        const Clip<T> C = row ? rowC : colC;
#define PASS(n)                                                              \
    one_pass<n, T>(row, g, count, pool, jb, kidx, dst, dst_h, dst_w, px_max, \
                   C, colC, tile)
        switch (row ? g.w : h) {
        case 4: PASS(4); break;
        case 8: PASS(8); break;
        case 16: PASS(16); break;
        case 32: PASS(32); break;
        default: PASS(64); break;
        }
#undef PASS
        if (row) __syncthreads();
    }
}

__device__ __forceinline__ void wht4x1(const i32 *x, i32 *o) {
    const i32 t0 = x[0] + x[1];
    const i32 t2 = x[2] - x[3];
    const i32 t4 = (t0 - t2) >> 1;
    const i32 t3 = t4 - x[3];
    const i32 t1 = t4 - x[1];
    o[0] = t0 - t3;
    o[1] = t3;
    o[2] = t1;
    o[3] = t2 + t1;
}

// One lossless 4x4 job (reference inv_txfm_add_wht_wht_4x4), the job
// row j, added into dst by one thread; int32 at every bit depth: the
// values are coefficients >> 2 summed four at a time
__device__ __forceinline__ void wht_job(const i32 *__restrict__ pool,
                                        const i32 *__restrict__ j,
                                        i32 *__restrict__ dst, int dst_h,
                                        int dst_w, int bd) {
    const i32 *cf = pool + j[R_OFF];
    i32 c[4][4], rows[4][4], cols[4][4];
#pragma unroll
    for (int x = 0; x < 4; x++)
#pragma unroll
        for (int y = 0; y < 4; y++) c[x][y] = cf[x * 4 + y] >> 2;
#pragma unroll
    for (int y = 0; y < 4; y++) {
        const i32 in[4] = {c[0][y], c[1][y], c[2][y], c[3][y]};
        wht4x1(in, rows[y]);
    }
#pragma unroll
    for (int x = 0; x < 4; x++) {
        const i32 in[4] = {rows[0][x], rows[1][x], rows[2][x], rows[3][x]};
        wht4x1(in, cols[x]);
    }
    const int px_max = (1 << bd) - 1;
    const int py = j[R_PY], px = j[R_PX];
    i32 *d = dst + (size_t)py * dst_w + px;
    i32 old[4][4];                      // all loads before any store
#pragma unroll
    for (int y = 0; y < 4; y++)
#pragma unroll
        for (int x = 0; x < 4; x++)
            old[y][x] = py + y < dst_h && px + x < dst_w
                            ? d[(size_t)y * dst_w + x] : 0;
#pragma unroll
    for (int y = 0; y < 4; y++)
#pragma unroll
        for (int x = 0; x < 4; x++)
            if (py + y < dst_h && px + x < dst_w)
                d[(size_t)y * dst_w + x] =
                    iclip(old[y][x] + cols[x][y], 0, px_max);
}

}  // namespace
