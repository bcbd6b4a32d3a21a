"""Inter-frame constants and the distance weights of jnt_comp compounds.

The part of dav1d_tpu's recon/inter_ref.py that the port's native-emitter
route needs: the compound-type enums, the quantized distance tables and
compute_jnt_weights (reference decode.c:3085-3121). The golden
per-block InterReconstructor is not part of this package.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.obu import get_poc_diff

COMP_INTER_NONE = 0
COMP_INTER_WEIGHTED_AVG = 1
COMP_INTER_AVG = 2
COMP_INTER_SEG = 3
COMP_INTER_WEDGE = 4

MM_OBMC = 1
MM_WARP = 2

II_SMOOTH_PRED = 3
SMOOTH_PRED = 9

QUANT_DIST_WEIGHT = ((2, 3), (2, 5), (2, 7))
QUANT_DIST_LOOKUP = ((9, 7), (11, 5), (12, 4), (13, 3))


def compute_jnt_weights(f, refp):
    """reference decode.c:3085-3121."""
    ohb = f.seq_hdr.order_hint_n_bits
    poc = f.frame_hdr.frame_offset
    w = np.zeros((7, 7), np.int32)
    if not (f.seq_hdr.jnt_comp and f.frame_hdr.switchable_comp_refs and
            f.seq_hdr.order_hint) or refp[0] is None:
        return w
    for i in range(7):
        ref0poc = refp[i].poc
        for j in range(i + 1, 7):
            ref1poc = refp[j].poc
            d1 = min(abs(get_poc_diff(ohb, ref0poc, poc)), 31)
            d0 = min(abs(get_poc_diff(ohb, ref1poc, poc)), 31)
            order = int(d0 <= d1)
            for k in range(3):
                c0 = QUANT_DIST_WEIGHT[k][order]
                c1 = QUANT_DIST_WEIGHT[k][1 - order]
                d0_c0, d1_c1 = d0 * c0, d1 * c1
                if (d0 > d1 and d0_c0 < d1_c1) or \
                        (d0 <= d1 and d0_c0 > d1_c1):
                    break
            else:
                k = 3
            w[i][j] = QUANT_DIST_LOOKUP[k][order]
    return w
