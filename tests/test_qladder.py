"""CRF q-ladder calibration (crf_qindex_calc mirror, rc_process.c:781).

The reference ladder on a blobs probe at p6 CRF32 (debug-build ground
truth, 2026-08-19): KF 54, ALT 59, tl1 74, tl2 84, tl3 92, leaves 95-99.
These tests pin the structural properties (ordering, ranges) rather than
exact values — the dispenser is a batched device redesign, so r0 differs in
the third digit."""

import numpy as np
import pytest

from svt_av1_psyex_tpu.codec.tpl import (
    crf_qindex_calc,
    get_deltaq_offset,
    qindex_from_qstep_ratio,
    r0_adjust_factor,
    reduced_tpl_group_level,
    uses_qstep_calc,
)

pytestmark = pytest.mark.quick


def test_qindex_from_qstep_ratio_dc_scan():
    # ratio 1 -> identity; ratio < 1 -> lower qindex (finer)
    assert qindex_from_qstep_ratio(128, 1.0, 8) == 128
    q = qindex_from_qstep_ratio(128, 0.452, 8)
    assert q == 67  # reference debug: ratio 0.452145 -> qindex 67
    assert qindex_from_qstep_ratio(128, 2.0, 8) > 128


def test_reduced_tpl_group_and_adjust():
    # p6 at hl=4: rtg 3 -> adjust 1.6 (reference debug ground truth)
    rtg = reduced_tpl_group_level(6, 4, True, True)
    assert rtg == 3
    assert r0_adjust_factor(rtg, 4, True) == 1.6
    # hl <= rtg collapses to -1 -> no adjustment
    assert reduced_tpl_group_level(6, 3, False, True) == -1
    assert r0_adjust_factor(-1, 3, False) == 0.0
    # slow presets see the whole group
    assert reduced_tpl_group_level(4, 4, False, True) == -1


def test_uses_qstep_layers():
    # hl=4: base + layer1 ride the qstep path; deeper layers interpolate
    assert uses_qstep_calc(0, 4, 3)
    assert uses_qstep_calc(1, 4, 3)
    assert not uses_qstep_calc(2, 4, 3)
    # hl=5: up to layer 2
    assert uses_qstep_calc(2, 5, 4)
    assert not uses_qstep_calc(3, 5, 4)


def test_crf_ladder_shape():
    """KF < ALT < mid layers < leaves = cq, with the refs-q floor."""
    # debug prints show post-division r0 (0.287 / 0.206); the raw inputs
    # are those times adj 1.6
    kf = crf_qindex_calc(128, is_intra=True, layer=0, hl=4, leaf=False,
                         r0=0.287 * 1.6, adj=1.6, tpl_group_size=24)
    assert kf == 67  # exact vs reference debug (same r0 in)
    alt = crf_qindex_calc(128, is_intra=False, layer=0, hl=4, leaf=False,
                          r0=0.206 * 1.6, adj=1.6, tpl_group_size=24,
                          ref_qs=(kf, kf), ref_layers=(0, 0))
    assert alt == 77  # reference debug: r0 0.206 -> ratio 0.51 -> 77
    tl2 = crf_qindex_calc(128, is_intra=False, layer=2, hl=4, leaf=False,
                          r0=None, adj=1.6, tpl_group_size=24,
                          ref_qs=(70, 102), ref_layers=(0, 1),
                          use_qstep=False)
    assert tl2 == 114  # reference debug frame 4: abq 114
    leaf = crf_qindex_calc(128, is_intra=False, layer=4, hl=4, leaf=True,
                           r0=None, adj=1.6, tpl_group_size=24,
                           ref_qs=(70, 118), ref_layers=(3, 3),
                           use_qstep=False)
    assert leaf == 128  # leaves ride the CRF level pre-boost
    assert kf < alt < tl2 < leaf


def test_get_deltaq_offset_walk():
    assert get_deltaq_offset(128, 1.0, False) == 0
    # beta > 1 -> finer q (negative offset), intra more aggressive
    off_inter = get_deltaq_offset(128, 4.0, False)
    off_intra = get_deltaq_offset(128, 4.0, True)
    assert off_intra < off_inter < 0
    # beta < 1 -> coarser q
    assert get_deltaq_offset(128, 0.25, False) > 0


def test_sub_sampled_variance_matches_reference_fixture():
    """sb_variances_8x8 mirrors BLOCK_MEAN_PREC_SUB (even rows, <<8/<<16
    fixed point) — checked against a hand-rolled scalar mirror."""
    from svt_av1_psyex_tpu.codec.psy import sb_variances_8x8

    rng = np.random.default_rng(0)
    luma = rng.integers(0, 256, (64, 64)).astype(np.int64)
    got = sb_variances_8x8(luma, 0, 0)
    for idx in (0, 9, 63):
        by, bx = divmod(idx, 8)
        blk = luma[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8]
        sub = blk[0::2, :]
        mean = (int(sub.sum()) << 8) // 32
        meansq = (int((sub * sub).sum()) << 16) // 32
        assert got[idx] == (meansq - mean * mean) >> 16
