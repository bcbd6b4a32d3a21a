"""Backend-agnostic 1-D inverse transform butterflies.

Single source for both the numpy scalar reference (ops/itx_ref.py) and
the JAX/TPU batched kernels (ops/itx.py): every function maps a list of
column arrays (each shaped (B,) or (B, M)) to a list of output columns,
using only +,-,*,>> and a clip callable — operations defined identically
for numpy int64 and jnp int32 arrays.

Semantics follow the normative AV1 butterflies with the reference's clip
placement (reference src/itx_1d.c:66-1017). Plain-math rotation forms
are used; they equal the reference's anti-overflow split forms exactly
in wide integers (itx_1d.c:39-63).
"""
from __future__ import annotations


def _r12(v):
    return (v + 2048) >> 12


def _r11(v):
    return (v + 1024) >> 11


def _sqrt2(v):
    return (v * 181 + 128) >> 8


def dct4(x, C, tx64=False):
    in0, in1 = x[0], x[1]
    if tx64:
        t0 = t1 = _sqrt2(in0)
        t2 = _r12(in1 * 1567)
        t3 = _r12(in1 * 3784)
    else:
        in2, in3 = x[2], x[3]
        t0 = _sqrt2(in0 + in2)
        t1 = _sqrt2(in0 - in2)
        t2 = _r12(in1 * 1567 - in3 * 3784)
        t3 = _r12(in1 * 3784 + in3 * 1567)
    return [C(t0 + t3), C(t1 + t2), C(t1 - t2), C(t0 - t3)]


def dct8(x, C, tx64=False):
    lo = dct4(x[::2], C, tx64)
    in1, in3 = x[1], x[3]
    if tx64:
        t4a = _r12(in1 * 799)
        t5a = _r12(in3 * -2276)
        t6a = _r12(in3 * 3406)
        t7a = _r12(in1 * 4017)
    else:
        in5, in7 = x[5], x[7]
        t4a = _r12(in1 * 799 - in7 * 4017)
        t5a = _r11(in5 * 1703 - in3 * 1138)
        t6a = _r11(in5 * 1138 + in3 * 1703)
        t7a = _r12(in1 * 4017 + in7 * 799)
    t4 = C(t4a + t5a)
    t5a = C(t4a - t5a)
    t7 = C(t7a + t6a)
    t6a = C(t7a - t6a)
    t5 = _sqrt2(t6a - t5a)
    t6 = _sqrt2(t6a + t5a)
    t0, t1, t2, t3 = lo
    return [C(t0 + t7), C(t1 + t6), C(t2 + t5), C(t3 + t4),
            C(t3 - t4), C(t2 - t5), C(t1 - t6), C(t0 - t7)]


def dct16(x, C, tx64=False):
    lo = dct8(x[::2], C, tx64)
    in1, in3, in5, in7 = x[1], x[3], x[5], x[7]
    if tx64:
        t8a = _r12(in1 * 401)
        t9a = _r12(in7 * -2598)
        t10a = _r12(in5 * 1931)
        t11a = _r12(in3 * -1189)
        t12a = _r12(in3 * 3920)
        t13a = _r12(in5 * 3612)
        t14a = _r12(in7 * 3166)
        t15a = _r12(in1 * 4076)
    else:
        in9, in11, in13, in15 = x[9], x[11], x[13], x[15]
        t8a = _r12(in1 * 401 - in15 * 4076)
        t9a = _r11(in9 * 1583 - in7 * 1299)
        t10a = _r12(in5 * 1931 - in11 * 3612)
        t11a = _r12(in13 * 3920 - in3 * 1189)
        t12a = _r12(in13 * 1189 + in3 * 3920)
        t13a = _r12(in5 * 3612 + in11 * 1931)
        t14a = _r11(in9 * 1299 + in7 * 1583)
        t15a = _r12(in1 * 4076 + in15 * 401)

    t8 = C(t8a + t9a)
    t9 = C(t8a - t9a)
    t10 = C(t11a - t10a)
    t11 = C(t11a + t10a)
    t12 = C(t12a + t13a)
    t13 = C(t12a - t13a)
    t14 = C(t15a - t14a)
    t15 = C(t15a + t14a)

    t9a = _r12(t14 * 1567 - t9 * 3784)
    t14a = _r12(t14 * 3784 + t9 * 1567)
    t10a = _r12(-(t13 * 3784 + t10 * 1567))
    t13a = _r12(t13 * 1567 - t10 * 3784)

    t8a = C(t8 + t11)
    t9 = C(t9a + t10a)
    t10 = C(t9a - t10a)
    t11a = C(t8 - t11)
    t12a = C(t15 - t12)
    t13 = C(t14a - t13a)
    t14 = C(t14a + t13a)
    t15a = C(t15 + t12)

    t10a = _sqrt2(t13 - t10)
    t13a = _sqrt2(t13 + t10)
    t11 = _sqrt2(t12a - t11a)
    t12 = _sqrt2(t12a + t11a)

    odds = [t15a, t14, t13a, t12, t11, t10a, t9, t8a]
    out = [None] * 16
    for i in range(8):
        out[i] = C(lo[i] + odds[i])
        out[15 - i] = C(lo[i] - odds[i])
    return out


def dct32(x, C, tx64=False):
    lo = dct16(x[::2], C, tx64)
    i1, i3, i5, i7 = x[1], x[3], x[5], x[7]
    i9, i11, i13, i15 = x[9], x[11], x[13], x[15]
    if tx64:
        t16a = _r12(i1 * 201)
        t17a = _r12(i15 * -2751)
        t18a = _r12(i9 * 1751)
        t19a = _r12(i7 * -1380)
        t20a = _r12(i5 * 995)
        t21a = _r12(i11 * -2106)
        t22a = _r12(i13 * 2440)
        t23a = _r12(i3 * -601)
        t24a = _r12(i3 * 4052)
        t25a = _r12(i13 * 3290)
        t26a = _r12(i11 * 3513)
        t27a = _r12(i5 * 3973)
        t28a = _r12(i7 * 3857)
        t29a = _r12(i9 * 3703)
        t30a = _r12(i15 * 3035)
        t31a = _r12(i1 * 4091)
    else:
        i17, i19, i21, i23 = x[17], x[19], x[21], x[23]
        i25, i27, i29, i31 = x[25], x[27], x[29], x[31]
        t16a = _r12(i1 * 201 - i31 * 4091)
        t17a = _r12(i17 * 3035 - i15 * 2751)
        t18a = _r12(i9 * 1751 - i23 * 3703)
        t19a = _r12(i25 * 3857 - i7 * 1380)
        t20a = _r12(i5 * 995 - i27 * 3973)
        t21a = _r12(i21 * 3513 - i11 * 2106)
        t22a = _r11(i13 * 1220 - i19 * 1645)
        t23a = _r12(i29 * 4052 - i3 * 601)
        t24a = _r12(i29 * 601 + i3 * 4052)
        t25a = _r11(i13 * 1645 + i19 * 1220)
        t26a = _r12(i21 * 2106 + i11 * 3513)
        t27a = _r12(i5 * 3973 + i27 * 995)
        t28a = _r12(i25 * 1380 + i7 * 3857)
        t29a = _r12(i9 * 3703 + i23 * 1751)
        t30a = _r12(i17 * 2751 + i15 * 3035)
        t31a = _r12(i1 * 4091 + i31 * 201)

    t16 = C(t16a + t17a); t17 = C(t16a - t17a)
    t18 = C(t19a - t18a); t19 = C(t19a + t18a)
    t20 = C(t20a + t21a); t21 = C(t20a - t21a)
    t22 = C(t23a - t22a); t23 = C(t23a + t22a)
    t24 = C(t24a + t25a); t25 = C(t24a - t25a)
    t26 = C(t27a - t26a); t27 = C(t27a + t26a)
    t28 = C(t28a + t29a); t29 = C(t28a - t29a)
    t30 = C(t31a - t30a); t31 = C(t31a + t30a)

    t17a = _r12(t30 * 799 - t17 * 4017)
    t30a = _r12(t30 * 4017 + t17 * 799)
    t18a = _r12(-(t29 * 4017 + t18 * 799))
    t29a = _r12(t29 * 799 - t18 * 4017)
    t21a = _r11(t26 * 1703 - t21 * 1138)
    t26a = _r11(t26 * 1138 + t21 * 1703)
    t22a = _r11(-(t25 * 1138 + t22 * 1703))
    t25a = _r11(t25 * 1703 - t22 * 1138)

    t16a = C(t16 + t19); t17_ = C(t17a + t18a)
    t18_ = C(t17a - t18a); t19a = C(t16 - t19)
    t20a = C(t23 - t20); t21_ = C(t22a - t21a)
    t22_ = C(t22a + t21a); t23a = C(t23 + t20)
    t24a = C(t24 + t27); t25_ = C(t25a + t26a)
    t26_ = C(t25a - t26a); t27a = C(t24 - t27)
    t28a = C(t31 - t28); t29_ = C(t30a - t29a)
    t30_ = C(t30a + t29a); t31a = C(t31 + t28)

    t18n = _r12(t29_ * 1567 - t18_ * 3784)
    t29n = _r12(t29_ * 3784 + t18_ * 1567)
    t19n = _r12(t28a * 1567 - t19a * 3784)
    t28n = _r12(t28a * 3784 + t19a * 1567)
    t20n = _r12(-(t27a * 3784 + t20a * 1567))
    t27n = _r12(t27a * 1567 - t20a * 3784)
    t21n = _r12(-(t26_ * 3784 + t21_ * 1567))
    t26n = _r12(t26_ * 1567 - t21_ * 3784)

    t16_2 = C(t16a + t23a); t17a2 = C(t17_ + t22_)
    t18_2 = C(t18n + t21n); t19a2 = C(t19n + t20n)
    t20a2 = C(t19n - t20n); t21_2 = C(t18n - t21n)
    t22a2 = C(t17_ - t22_); t23_2 = C(t16a - t23a)
    t24_2 = C(t31a - t24a); t25a2 = C(t30_ - t25_)
    t26_2 = C(t29n - t26n); t27a2 = C(t28n - t27n)
    t28a2 = C(t28n + t27n); t29_2 = C(t29n + t26n)
    t30a2 = C(t30_ + t25_); t31_2 = C(t31a + t24a)

    t20f = _sqrt2(t27a2 - t20a2)
    t27f = _sqrt2(t27a2 + t20a2)
    t21af = _sqrt2(t26_2 - t21_2)
    t26af = _sqrt2(t26_2 + t21_2)
    t22f = _sqrt2(t25a2 - t22a2)
    t25f = _sqrt2(t25a2 + t22a2)
    t23af = _sqrt2(t24_2 - t23_2)
    t24af = _sqrt2(t24_2 + t23_2)

    odds = [t31_2, t30a2, t29_2, t28a2, t27f, t26af, t25f, t24af,
            t23af, t22f, t21af, t20f, t19a2, t18_2, t17a2, t16_2]
    out = [None] * 32
    for k in range(16):
        out[k] = C(lo[k] + odds[k])
        out[31 - k] = C(lo[k] - odds[k])
    return out


def dct64(x, C):
    """x: 32 columns (only the first 32 coefficients are coded)."""
    lo = dct32(x[::2], C, tx64=True)
    i = {k: x[k] for k in range(1, 32, 2)}

    consts = [(32, 1, 101), (33, 31, -2824), (34, 17, 1660), (35, 15, -1474),
              (36, 9, 897), (37, 23, -2191), (38, 25, 2359), (39, 7, -700),
              (40, 5, 501), (41, 27, -2520), (42, 21, 2019), (43, 11, -1092),
              (44, 13, 1285), (45, 19, -1842), (46, 29, 2675), (47, 3, -301),
              (48, 3, 4085), (49, 29, 3102), (50, 19, 3659), (51, 13, 3889),
              (52, 11, 3948), (53, 21, 3564), (54, 27, 3229), (55, 5, 4065),
              (56, 7, 4036), (57, 25, 3349), (58, 23, 3461), (59, 9, 3996),
              (60, 15, 3822), (61, 17, 3745), (62, 31, 2967), (63, 1, 4095)]
    a = {}
    for (k, src, cst) in consts:
        a[k] = _r12(i[src] * cst)

    t = {}
    pair_patterns = [(32, 33, 0), (34, 35, 1), (36, 37, 0), (38, 39, 1),
                     (40, 41, 0), (42, 43, 1), (44, 45, 0), (46, 47, 1),
                     (48, 49, 0), (50, 51, 1), (52, 53, 0), (54, 55, 1),
                     (56, 57, 0), (58, 59, 1), (60, 61, 0), (62, 63, 1)]
    for (p, q, swapped) in pair_patterns:
        if not swapped:
            t[p] = C(a[p] + a[q]); t[q] = C(a[p] - a[q])
        else:
            t[p] = C(a[q] - a[p]); t[q] = C(a[q] + a[p])

    t33a = _r12(t[33] * -4076 + t[62] * 401)
    t34a = _r12(t[34] * -401 + t[61] * -4076)
    t37a = _r11(t[37] * -1299 + t[58] * 1583)
    t38a = _r11(t[38] * -1583 + t[57] * -1299)
    t41a = _r12(t[41] * -3612 + t[54] * 1931)
    t42a = _r12(t[42] * -1931 + t[53] * -3612)
    t45a = _r12(t[45] * -1189 + t[50] * 3920)
    t46a = _r12(t[46] * -3920 + t[49] * -1189)
    t49a = _r12(t[46] * -1189 + t[49] * 3920)
    t50a = _r12(t[45] * 3920 + t[50] * 1189)
    t53a = _r12(t[42] * -3612 + t[53] * 1931)
    t54a = _r12(t[41] * 1931 + t[54] * 3612)
    t57a = _r11(t[38] * -1299 + t[57] * 1583)
    t58a = _r11(t[37] * 1583 + t[58] * 1299)
    t61a = _r12(t[34] * -4076 + t[61] * 401)
    t62a = _r12(t[33] * 401 + t[62] * 4076)

    t32a = C(t[32] + t[35]); t33_ = C(t33a + t34a)
    t34_ = C(t33a - t34a); t35a = C(t[32] - t[35])
    t36a = C(t[39] - t[36]); t37_ = C(t38a - t37a)
    t38_ = C(t38a + t37a); t39a = C(t[39] + t[36])
    t40a = C(t[40] + t[43]); t41_ = C(t41a + t42a)
    t42_ = C(t41a - t42a); t43a = C(t[40] - t[43])
    t44a = C(t[47] - t[44]); t45_ = C(t46a - t45a)
    t46_ = C(t46a + t45a); t47a = C(t[47] + t[44])
    t48a = C(t[48] + t[51]); t49_ = C(t49a + t50a)
    t50_ = C(t49a - t50a); t51a = C(t[48] - t[51])
    t52a = C(t[55] - t[52]); t53_ = C(t54a - t53a)
    t54_ = C(t54a + t53a); t55a = C(t[55] + t[52])
    t56a = C(t[56] + t[59]); t57_ = C(t57a + t58a)
    t58_ = C(t57a - t58a); t59a = C(t[56] - t[59])
    t60a = C(t[63] - t[60]); t61_ = C(t62a - t61a)
    t62_ = C(t62a + t61a); t63a = C(t[63] + t[60])

    t34a2 = _r12(t34_ * -4017 + t61_ * 799)
    t35_ = _r12(t35a * -4017 + t60a * 799)
    t36_ = _r12(t36a * -799 + t59a * -4017)
    t37a2 = _r12(t37_ * -799 + t58_ * -4017)
    t42a2 = _r11(t42_ * -1138 + t53_ * 1703)
    t43_ = _r11(t43a * -1138 + t52a * 1703)
    t44_ = _r11(t44a * -1703 + t51a * -1138)
    t45a2 = _r11(t45_ * -1703 + t50_ * -1138)
    t50a2 = _r11(t45_ * -1138 + t50_ * 1703)
    t51_ = _r11(t44a * -1138 + t51a * 1703)
    t52_ = _r11(t43a * 1703 + t52a * 1138)
    t53a2 = _r11(t42_ * 1703 + t53_ * 1138)
    t58a2 = _r12(t37_ * -4017 + t58_ * 799)
    t59_ = _r12(t36a * -4017 + t59a * 799)
    t60_ = _r12(t35a * 799 + t60a * 4017)
    t61a2 = _r12(t34_ * 799 + t61_ * 4017)

    t32_ = C(t32a + t39a); t33a2 = C(t33_ + t38_)
    t34_3 = C(t34a2 + t37a2); t35a2 = C(t35_ + t36_)
    t36a2 = C(t35_ - t36_); t37_3 = C(t34a2 - t37a2)
    t38a2 = C(t33_ - t38_); t39_ = C(t32a - t39a)
    t40_ = C(t47a - t40a); t41a2 = C(t46_ - t41_)
    t42_3 = C(t45a2 - t42a2); t43a2 = C(t44_ - t43_)
    t44a2 = C(t44_ + t43_); t45_3 = C(t45a2 + t42a2)
    t46a2 = C(t46_ + t41_); t47_ = C(t47a + t40a)
    t48_ = C(t48a + t55a); t49a2 = C(t49_ + t54_)
    t50_3 = C(t50a2 + t53a2); t51a2 = C(t51_ + t52_)
    t52a2 = C(t51_ - t52_); t53_3 = C(t50a2 - t53a2)
    t54a2 = C(t49_ - t54_); t55_ = C(t48a - t55a)
    t56_ = C(t63a - t56a); t57a2 = C(t62_ - t57_)
    t58_3 = C(t61a2 - t58a2); t59a2 = C(t60_ - t59_)
    t60a2 = C(t60_ + t59_); t61_3 = C(t61a2 + t58a2)
    t62a2 = C(t62_ + t57_); t63_ = C(t63a + t56a)

    t36_4 = _r12(t36a2 * -3784 + t59a2 * 1567)
    t37a3 = _r12(t37_3 * -3784 + t58_3 * 1567)
    t38_4 = _r12(t38a2 * -3784 + t57a2 * 1567)
    t39a3 = _r12(t39_ * -3784 + t56_ * 1567)
    t40a3 = _r12(t40_ * -1567 + t55_ * -3784)
    t41_4 = _r12(t41a2 * -1567 + t54a2 * -3784)
    t42a3 = _r12(t42_3 * -1567 + t53_3 * -3784)
    t43_4 = _r12(t43a2 * -1567 + t52a2 * -3784)
    t52_4 = _r12(t43a2 * -3784 + t52a2 * 1567)
    t53a3 = _r12(t42_3 * -3784 + t53_3 * 1567)
    t54_4 = _r12(t41a2 * -3784 + t54a2 * 1567)
    t55a2 = _r12(t40_ * -3784 + t55_ * 1567)
    t56a2 = _r12(t39_ * 1567 + t56_ * 3784)
    t57_4 = _r12(t38a2 * 1567 + t57a2 * 3784)
    t58a3 = _r12(t37_3 * 1567 + t58_3 * 3784)
    t59_4 = _r12(t36a2 * 1567 + t59a2 * 3784)

    t32a2 = C(t32_ + t47_); t33_5 = C(t33a2 + t46a2)
    t34a3 = C(t34_3 + t45_3); t35_5 = C(t35a2 + t44a2)
    t36a3 = C(t36_4 + t43_4); t37_5 = C(t37a3 + t42a3)
    t38a3 = C(t38_4 + t41_4); t39_5 = C(t39a3 + t40a3)
    t40_5 = C(t39a3 - t40a3); t41a3 = C(t38_4 - t41_4)
    t42_5 = C(t37a3 - t42a3); t43a3 = C(t36_4 - t43_4)
    t44_5 = C(t35a2 - t44a2); t45a3 = C(t34_3 - t45_3)
    t46_5 = C(t33a2 - t46a2); t47a2 = C(t32_ - t47_)
    t48a2 = C(t63_ - t48_); t49_5 = C(t62a2 - t49a2)
    t50a3 = C(t61_3 - t50_3); t51_5 = C(t60a2 - t51a2)
    t52a3 = C(t59_4 - t52_4); t53_5 = C(t58a3 - t53a3)
    t54a3 = C(t57_4 - t54_4); t55_5 = C(t56a2 - t55a2)
    t56_5 = C(t56a2 + t55a2); t57a3 = C(t57_4 + t54_4)
    t58_5 = C(t58a3 + t53a3); t59a3 = C(t59_4 + t52_4)
    t60_5 = C(t60a2 + t51a2); t61a3 = C(t61_3 + t50_3)
    t62_5 = C(t62a2 + t49a2); t63a2 = C(t63_ + t48_)

    t40a4 = _sqrt2(t55_5 - t40_5)
    t41_6 = _sqrt2(t54a3 - t41a3)
    t42a4 = _sqrt2(t53_5 - t42_5)
    t43_6 = _sqrt2(t52a3 - t43a3)
    t44a4 = _sqrt2(t51_5 - t44_5)
    t45_6 = _sqrt2(t50a3 - t45a3)
    t46a4 = _sqrt2(t49_5 - t46_5)
    t47_6 = _sqrt2(t48a2 - t47a2)
    t48_6 = _sqrt2(t47a2 + t48a2)
    t49a4 = _sqrt2(t46_5 + t49_5)
    t50_6 = _sqrt2(t45a3 + t50a3)
    t51a4 = _sqrt2(t44_5 + t51_5)
    t52_6 = _sqrt2(t43a3 + t52a3)
    t53a4 = _sqrt2(t42_5 + t53_5)
    t54_6 = _sqrt2(t41a3 + t54a3)
    t55a3 = _sqrt2(t40_5 + t55_5)

    odds = [t63a2, t62_5, t61a3, t60_5, t59a3, t58_5, t57a3, t56_5,
            t55a3, t54_6, t53a4, t52_6, t51a4, t50_6, t49a4, t48_6,
            t47_6, t46a4, t45_6, t44a4, t43_6, t42a4, t41_6, t40a4,
            t39_5, t38a3, t37_5, t36a3, t35_5, t34a3, t33_5, t32a2]
    out = [None] * 64
    for k in range(32):
        out[k] = C(lo[k] + odds[k])
        out[63 - k] = C(lo[k] - odds[k])
    return out


def adst4(x, C):
    in0, in1, in2, in3 = x[0], x[1], x[2], x[3]
    return [
        _r12(1321 * in0 + 3803 * in2 + 2482 * in3 + 3344 * in1),
        _r12(2482 * in0 - 1321 * in2 - 3803 * in3 + 3344 * in1),
        (209 * (in0 - in2 + in3) + 128) >> 8,
        _r12(3803 * in0 + 2482 * in2 - 1321 * in3 - 3344 * in1),
    ]


def adst8(x, C):
    i = x
    t0a = _r12(4076 * i[7] + 401 * i[0])
    t1a = _r12(401 * i[7] - 4076 * i[0])
    t2a = _r12(3612 * i[5] + 1931 * i[2])
    t3a = _r12(1931 * i[5] - 3612 * i[2])
    t4a = _r11(1299 * i[3] + 1583 * i[4])
    t5a = _r11(1583 * i[3] - 1299 * i[4])
    t6a = _r12(1189 * i[1] + 3920 * i[6])
    t7a = _r12(3920 * i[1] - 1189 * i[6])

    t0 = C(t0a + t4a)
    t1 = C(t1a + t5a)
    t2 = C(t2a + t6a)
    t3 = C(t3a + t7a)
    t4 = C(t0a - t4a)
    t5 = C(t1a - t5a)
    t6 = C(t2a - t6a)
    t7 = C(t3a - t7a)

    t4a = _r12(3784 * t4 + 1567 * t5)
    t5a = _r12(1567 * t4 - 3784 * t5)
    t6a = _r12(3784 * t7 - 1567 * t6)
    t7a = _r12(1567 * t7 + 3784 * t6)

    out = [None] * 8
    out[0] = C(t0 + t2)
    out[7] = -C(t1 + t3)
    t2 = C(t0 - t2)
    t3 = C(t1 - t3)
    out[1] = -C(t4a + t6a)
    out[6] = C(t5a + t7a)
    t6 = C(t4a - t6a)
    t7 = C(t5a - t7a)
    out[3] = -_sqrt2(t2 + t3)
    out[4] = _sqrt2(t2 - t3)
    out[2] = _sqrt2(t6 + t7)
    out[5] = -_sqrt2(t6 - t7)
    return out


def adst16(x, C):
    i = x
    t0 = _r12(i[15] * 4091 + i[0] * 201)
    t1 = _r12(i[15] * 201 - i[0] * 4091)
    t2 = _r12(i[13] * 3973 + i[2] * 995)
    t3 = _r12(i[13] * 995 - i[2] * 3973)
    t4 = _r12(i[11] * 3703 + i[4] * 1751)
    t5 = _r12(i[11] * 1751 - i[4] * 3703)
    t6 = _r11(i[9] * 1645 + i[6] * 1220)
    t7 = _r11(i[9] * 1220 - i[6] * 1645)
    t8 = _r12(i[7] * 2751 + i[8] * 3035)
    t9 = _r12(i[7] * 3035 - i[8] * 2751)
    t10 = _r12(i[5] * 2106 + i[10] * 3513)
    t11 = _r12(i[5] * 3513 - i[10] * 2106)
    t12 = _r12(i[3] * 1380 + i[12] * 3857)
    t13 = _r12(i[3] * 3857 - i[12] * 1380)
    t14 = _r12(i[1] * 601 + i[14] * 4052)
    t15 = _r12(i[1] * 4052 - i[14] * 601)

    t0a = C(t0 + t8); t1a = C(t1 + t9)
    t2a = C(t2 + t10); t3a = C(t3 + t11)
    t4a = C(t4 + t12); t5a = C(t5 + t13)
    t6a = C(t6 + t14); t7a = C(t7 + t15)
    t8a = C(t0 - t8); t9a = C(t1 - t9)
    t10a = C(t2 - t10); t11a = C(t3 - t11)
    t12a = C(t4 - t12); t13a = C(t5 - t13)
    t14a = C(t6 - t14); t15a = C(t7 - t15)

    t8 = _r12(t8a * 4017 + t9a * 799)
    t9 = _r12(t8a * 799 - t9a * 4017)
    t10 = _r12(t10a * 2276 + t11a * 3406)
    t11 = _r12(t10a * 3406 - t11a * 2276)
    t12 = _r12(t13a * 4017 - t12a * 799)
    t13 = _r12(t13a * 799 + t12a * 4017)
    t14 = _r12(t15a * 2276 - t14a * 3406)
    t15 = _r12(t15a * 3406 + t14a * 2276)

    t0 = C(t0a + t4a); t1 = C(t1a + t5a)
    t2 = C(t2a + t6a); t3 = C(t3a + t7a)
    t4 = C(t0a - t4a); t5 = C(t1a - t5a)
    t6 = C(t2a - t6a); t7 = C(t3a - t7a)
    t8a = C(t8 + t12); t9a = C(t9 + t13)
    t10a = C(t10 + t14); t11a = C(t11 + t15)
    t12a = C(t8 - t12); t13a = C(t9 - t13)
    t14a = C(t10 - t14); t15a = C(t11 - t15)

    t4a = _r12(t4 * 3784 + t5 * 1567)
    t5a = _r12(t4 * 1567 - t5 * 3784)
    t6a = _r12(t7 * 3784 - t6 * 1567)
    t7a = _r12(t7 * 1567 + t6 * 3784)
    t12 = _r12(t12a * 3784 + t13a * 1567)
    t13 = _r12(t12a * 1567 - t13a * 3784)
    t14 = _r12(t15a * 3784 - t14a * 1567)
    t15 = _r12(t15a * 1567 + t14a * 3784)

    out = [None] * 16
    out[0] = C(t0 + t2)
    out[15] = -C(t1 + t3)
    t2a = C(t0 - t2)
    t3a = C(t1 - t3)
    out[3] = -C(t4a + t6a)
    out[12] = C(t5a + t7a)
    t6 = C(t4a - t6a)
    t7 = C(t5a - t7a)
    out[1] = -C(t8a + t10a)
    out[14] = C(t9a + t11a)
    t10 = C(t8a - t10a)
    t11 = C(t9a - t11a)
    out[2] = C(t12 + t14)
    out[13] = -C(t13 + t15)
    t14a = C(t12 - t14)
    t15a = C(t13 - t15)

    out[7] = -_sqrt2(t2a + t3a)
    out[8] = _sqrt2(t2a - t3a)
    out[4] = _sqrt2(t6 + t7)
    out[11] = -_sqrt2(t6 - t7)
    out[6] = _sqrt2(t10 + t11)
    out[9] = -_sqrt2(t10 - t11)
    out[5] = -_sqrt2(t14a + t15a)
    out[10] = _sqrt2(t14a - t15a)
    return out


def identity4(x, C):
    return [v + ((v * 1697 + 2048) >> 12) for v in x[:4]]


def identity8(x, C):
    return [v * 2 for v in x[:8]]


def identity16(x, C):
    return [2 * v + ((v * 1697 + 1024) >> 11) for v in x[:16]]


def identity32(x, C):
    return [v * 4 for v in x[:32]]


def wht4(x):
    in0, in1, in2, in3 = x[0], x[1], x[2], x[3]
    t0 = in0 + in1
    t2 = in2 - in3
    t4 = (t0 - t2) >> 1
    t3 = t4 - in3
    t1 = t4 - in1
    return [t0 - t3, t3, t1, t2 + t1]


DCT, ADST, FLIPADST, IDENTITY = range(4)


def _flip(fn):
    def f(x, C):
        return fn(x, C)[::-1]
    return f


FNS = {
    (2, DCT): dct4, (3, DCT): dct8, (4, DCT): dct16, (5, DCT): dct32,
    (6, DCT): dct64,
    (2, ADST): adst4, (3, ADST): adst8, (4, ADST): adst16,
    (2, FLIPADST): _flip(adst4), (3, FLIPADST): _flip(adst8),
    (4, FLIPADST): _flip(adst16),
    (2, IDENTITY): identity4, (3, IDENTITY): identity8,
    (4, IDENTITY): identity16, (5, IDENTITY): identity32,
}
