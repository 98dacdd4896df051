"""CDEF strength search + filtering on device.

Device reformulation of ops/cdef.py (itself a batched rewrite of
cdef.c / enc_cdef.c): the whole frame's 8x8 units are processed as one
static-shape lattice — direction search as one-hot matmul partial sums,
per-candidate constrained tap sums as element-wise passes over
gather-free shifted-plane taps — inside two jitted calls:

  * search: -> per-64x64-fb MSE matrices for every candidate strength;
  * apply: filters the frame with the chosen per-fb strengths.

The tiny greedy dual strength selection and the RD decision stay on host
(ops/cdef.py logic). Skip semantics are carried by masks instead of
dynamic block lists so shapes stay static across frames.

The group entry point (`cdef_group_device`) batches BOTH kernels over a
whole group of frames, so one dispatch and one fetch serve the group
(the reference's picture-level parallelism axis, enc_handle.c:478).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cdef import (
    CDEF_SEC_STRENGTHS,
    CDEF_STRENGTH_BITS,
    CDEF_VERY_LARGE,
    _DIR_DX,
    _DIR_DY,
    _DIV_TABLE,
    _PARTIAL_MAPS,
    _PRI_TAPS,
    candidate_strengths,
    joint_strength_search_dual,
)


def _find_dir(blocks: jnp.ndarray, coeff_shift: int):
    """(N, 8, 8) -> (dir (N,), var (N,)). Mirrors ops.cdef.find_dir_batch.

    The decoder re-derives dir/var from its recon (cdef.c:152), so this
    must be INTEGER-EXACT. The 34-bit costs don't fit int32, so each
    cost is kept as an exact (hi, lo) pair with cost = hi*1024 + lo and
    comparisons/differences done pairwise (partials are 8-bit-domain:
    |p| <= 1016, p^2 < 2^20, so hi/lo sums stay < 2^24)."""
    n = blocks.shape[0]
    x = (blocks.reshape(n, 64) >> coeff_shift).astype(jnp.float32) - 128.0
    maps = jnp.asarray(_PARTIAL_MAPS, jnp.float32)  # (8, 64, 15)
    # one-hot f32 matmul, integer-exact: x is an integer in [-128, 127],
    # maps are 0/1 and |partials| <= 1016 << 2^24. HIGHEST keeps every
    # backend on full f32 products (no TF32/bf16 operand rounding).
    partials = jnp.einsum("np,dpb->dnb", x, maps,
                          precision=jax.lax.Precision.HIGHEST
                          ).astype(jnp.int32)
    div = np.asarray(_DIV_TABLE, np.int64)
    his, los = [], []
    for d in range(8):
        p = partials[d]
        p2 = p * p
        p2h, p2l = p2 >> 10, p2 & 1023
        if d in (2, 6):
            terms = [(i, div[8]) for i in range(8)]
        elif d in (0, 4):
            terms = [(7, div[8])] + [(i, div[i + 1]) for i in range(7)] \
                + [(14 - i, div[i + 1]) for i in range(7)]
        else:
            terms = [(i, div[8]) for i in range(3, 8)] \
                + [(j, div[2 * j + 2]) for j in range(3)] \
                + [(10 - j, div[2 * j + 2]) for j in range(3)]
        h = 0
        l = 0
        for i, wgt in terms:
            h = h + p2h[:, i] * int(wgt)
            l = l + p2l[:, i] * int(wgt)
        his.append(h + (l >> 10))
        los.append(l & 1023)
    hi = jnp.stack(his, axis=1)  # (N, 8), < 2^24
    lo = jnp.stack(los, axis=1)  # (N, 8), < 2^10
    # first-max-wins lexicographic argmax (C loop semantics)
    best_dir = jnp.zeros(n, jnp.int32)
    bh = hi[:, 0]
    bl = lo[:, 0]
    for d in range(1, 8):
        better = (hi[:, d] > bh) | ((hi[:, d] == bh) & (lo[:, d] > bl))
        best_dir = jnp.where(better, d, best_dir)
        bh = jnp.where(better, hi[:, d], bh)
        bl = jnp.where(better, lo[:, d], bl)
    nonzero = (bh > 0) | (bl > 0)
    best_dir = jnp.where(nonzero, best_dir, 0)
    idx = jnp.arange(n)
    opp = (best_dir + 4) & 7
    oh, ol = hi[idx, opp], lo[idx, opp]
    # (dh*1024 + dl) >> 10 == dh + (dl >> 10) exactly (arithmetic shift)
    var = (bh - oh) + ((bl - ol) >> 10)
    return best_dir, var


# per-(tap, dir) offsets matching ops.cdef.gather_taps tap order
def _tap_offset_tables():
    dy = np.zeros((12, 8), np.int32)
    dx = np.zeros((12, 8), np.int32)
    for d in range(8):
        i = 0
        for k in range(2):
            for sgn in (1, -1):
                dy[i, d] = sgn * _DIR_DY[d, k]
                dx[i, d] = sgn * _DIR_DX[d, k]
                i += 1
            for dd in ((d + 2) & 7, (d - 2) & 7):
                for sgn in (1, -1):
                    dy[i, d] = sgn * _DIR_DY[dd, k]
                    dx[i, d] = sgn * _DIR_DX[dd, k]
                    i += 1
    return dy, dx


_TAP_DY, _TAP_DX = _tap_offset_tables()


def _shift_blocks(padded, dy: int, dx: int, nvb: int, nhb: int, bs: int):
    """Blocked view of the plane shifted by (dy, dx): (N, bs, bs)."""
    p = padded[2 + dy : 2 + dy + nvb * bs, 2 + dx : 2 + dx + nhb * bs]
    return p.reshape(nvb, bs, nhb, bs).transpose(0, 2, 1, 3) \
        .reshape(nvb * nhb, bs, bs).astype(jnp.int32)


def _gather_taps(padded, nvb: int, nhb: int, bs: int, dirs):
    """(x (N,bs,bs), P/AD/SG (12,N,bs,bs)) — gather-free reformulation of
    ops.cdef.gather_taps: every (tap, dir) pattern is a shifted-plane
    slice; per-block direction selects among the 8 with a one-hot blend
    (XLA fuses the slices; no gather op, which is slow on TPU)."""
    x = _shift_blocks(padded, 0, 0, nvb, nhb, bs)
    if dirs is None:  # fixed dir 0
        P = jnp.stack([_shift_blocks(padded, int(_TAP_DY[t, 0]),
                                     int(_TAP_DX[t, 0]), nvb, nhb, bs)
                       for t in range(12)])
    else:
        oh = (dirs[:, None] == jnp.arange(8)[None, :]).astype(jnp.int32)
        taps = []
        for t in range(12):
            acc = 0
            for d in range(8):
                sb = _shift_blocks(padded, int(_TAP_DY[t, d]),
                                   int(_TAP_DX[t, d]), nvb, nhb, bs)
                acc = acc + oh[:, d, None, None] * sb
            taps.append(acc)
        P = jnp.stack(taps)
    D = P - x[None]
    return x, P, jnp.abs(D), jnp.sign(D)


_PRI_IDX = (0, 1, 6, 7)
_PRI_KS = (0, 0, 1, 1)
_SEC_IDX0 = (2, 3, 4, 5)
_SEC_IDX1 = (8, 9, 10, 11)


def _ilog2(x):
    """floor(log2(max(x, 1))) in pure integer ops. The filter output is
    decoder-visible, so this must be exact on every backend: an f32
    log2 approximation can land just below an integer at exact powers of
    two, flooring one low and shifting the constraint by a full bit
    (seen as +-1-pixel recon diffs vs dav1d at 1080p)."""
    v = jnp.maximum(x, 1)
    r = jnp.zeros_like(v)
    for k in (16, 8, 4, 2, 1):
        hit = v >= (1 << k)
        r = r + jnp.where(hit, k, 0)
        v = jnp.where(hit, v >> k, v)
    return r


def _msb_shift(strength, damping):
    return jnp.maximum(0, damping - _ilog2(strength))


def _pri_sum(taps, pri, damping, coeff_shift: int):
    """pri: (N,) per-block primary strength; damping: traced scalar."""
    x, P, AD, SG = taps
    prib = pri[:, None, None]
    shift = _msb_shift(prib, damping)
    tap_sel = (pri >> coeff_shift) & 1
    pt = jnp.asarray(_PRI_TAPS, jnp.int32)
    acc = jnp.zeros_like(x)
    for i, k in zip(_PRI_IDX, _PRI_KS):
        c = SG[i] * jnp.minimum(AD[i], jnp.maximum(0, prib - (AD[i] >> shift)))
        w = jnp.where(tap_sel == 1, pt[1, k], pt[0, k])[:, None, None]
        acc = acc + w * c
    return jnp.where(prib == 0, 0, acc)


def _sec_sum(taps, sec, damping):
    """sec: (N,) per-block secondary strength; damping: traced scalar."""
    x, P, AD, SG = taps
    sb = sec[:, None, None]
    shift = _msb_shift(sb, damping)
    acc = jnp.zeros_like(x)
    for i in _SEC_IDX0:
        acc = acc + 2 * SG[i] * jnp.minimum(
            AD[i], jnp.maximum(0, sb - (AD[i] >> shift)))
    for i in _SEC_IDX1:
        acc = acc + SG[i] * jnp.minimum(
            AD[i], jnp.maximum(0, sb - (AD[i] >> shift)))
    return jnp.where(sb == 0, 0, acc)


def _combine(taps, pri_sum, sec_sum):
    x, P, _, _ = taps
    mx = jnp.maximum(x, jnp.where(P == CDEF_VERY_LARGE, x[None], P).max(axis=0))
    mn = jnp.minimum(x, P.min(axis=0))
    s = pri_sum + sec_sum
    y = x + ((8 + s - (s < 0)) >> 4)
    return jnp.clip(y, mn, mx)


def _adjust_strength(strength, var):
    v6 = var >> 6
    i = jnp.minimum(_ilog2(v6), 12)
    adj = (strength * (4 + i) + 8) >> 4
    return jnp.where(var != 0, adj, 0)


def _split_gi(gi: int, cs: int):
    pri = gi // CDEF_SEC_STRENGTHS
    sec = gi % CDEF_SEC_STRENGTHS
    sec += sec == 3
    return pri, sec << cs


def _dist_luma(src, dst, coeff_shift: int):
    """enc_cdef.c dist_8xn, f32 (search-only; ranking-stable)."""
    s = src.reshape(-1, 64).astype(jnp.float32)
    d = dst.reshape(-1, 64).astype(jnp.float32)
    sum_s = s.sum(1)
    sum_d = d.sum(1)
    sum_s2 = (s * s).sum(1)
    sum_d2 = (d * d).sum(1)
    sum_sd = (s * d).sum(1)
    svar = sum_s2 - jnp.floor((sum_s * sum_s + 32) / 64)
    dvar = sum_d2 - jnp.floor((sum_d * sum_d + 32) / 64)
    num = (sum_d2 + sum_s2 - 2 * sum_sd) * 0.5 * \
        (svar + dvar + (400 << (2 * coeff_shift)))
    den = jnp.sqrt((20000 << (4 * coeff_shift)) + svar * dvar)
    return jnp.floor(0.5 + num / den)


def _fb_sum(per_block, nv8p: int, nh8p: int):
    """(N,) block values -> (nvfb*nhfb,) sums over 8x8-block fb tiles."""
    g = per_block.reshape(nv8p // 8, 8, nh8p // 8, 8)
    return g.sum(axis=(1, 3)).reshape(-1)


def _search_impl(pad_planes, src_planes, mask, ydamp, cdamp,
                 level: int, bit_depth: int, nv8p: int, nh8p: int,
                 chroma: bool):
    cs = bit_depth - 8
    n = nv8p * nh8p

    pad_y = pad_planes[0]
    luma_blocks = _shift_blocks(pad_y, 0, 0, nv8p, nh8p, 8)
    dirs, var = _find_dir(luma_blocks, cs)

    def blocked(plane, bs):
        return plane.reshape(nv8p, bs, nh8p, bs).transpose(0, 2, 1, 3) \
            .reshape(n, bs, bs)

    src_y = blocked(src_planes[0], 8)
    taps_y = {1: _gather_taps(pad_y, nv8p, nh8p, 8, dirs),
              0: _gather_taps(pad_y, nv8p, nh8p, 8, None)}
    if chroma:
        taps_c = {(pi, nz): _gather_taps(pad_planes[pi], nv8p, nh8p, 4,
                                         dirs if nz else None)
                  for pi in (1, 2) for nz in (0, 1)}
        src_c = [blocked(p, 4) for p in src_planes[1:3]]

    cands = candidate_strengths(level)
    mse0_cols, mse1_cols = [], []
    ones = jnp.ones(n, jnp.int32)
    for gi in cands:
        pri, sec = _split_gi(gi, cs)
        nz = 1 if pri else 0
        t = _adjust_strength((pri << cs) * ones, var)
        out = _combine(taps_y[nz], _pri_sum(taps_y[nz], t, ydamp, cs),
                       _sec_sum(taps_y[nz], sec * ones, ydamp))
        d = _dist_luma(src_y, out, cs) * mask
        mse0_cols.append(_fb_sum(d, nv8p, nh8p))
        if chroma:
            acc = 0.0
            for pi in (1, 2):
                outc = _combine(
                    taps_c[(pi, nz)],
                    _pri_sum(taps_c[(pi, nz)], (pri << cs) * ones, cdamp, cs),
                    _sec_sum(taps_c[(pi, nz)], sec * ones, cdamp))
                e = (outc - src_c[pi - 1]).astype(jnp.float32)
                acc = acc + (e * e).sum(axis=(1, 2)) / (1 << (2 * cs))
            mse1_cols.append(_fb_sum(acc * mask, nv8p, nh8p))
    mse0 = jnp.stack(mse0_cols, axis=1).reshape(-1)
    mse1 = (jnp.stack(mse1_cols, axis=1).reshape(-1) if chroma
            else jnp.zeros_like(mse0))
    return jnp.concatenate([mse0, mse1, dirs.astype(jnp.float32),
                            var.astype(jnp.float32)])


def _apply_impl(pad_planes, dirs, var, y_gi, uv_gi, mask, ydamp, cdamp,
                bit_depth: int, nv8p: int, nh8p: int, chroma: bool,
                h: int, w: int, hc: int, wc: int):
    cs = bit_depth - 8
    pri_y = (y_gi // CDEF_SEC_STRENGTHS) << cs
    sec_y = y_gi % CDEF_SEC_STRENGTHS
    sec_y = (sec_y + (sec_y == 3)) << cs
    t_y = _adjust_strength(pri_y, var)
    d_eff = jnp.where(pri_y != 0, dirs, 0)
    taps = _gather_taps(pad_planes[0], nv8p, nh8p, 8, d_eff)
    out_y = _combine(taps, _pri_sum(taps, t_y, ydamp, cs),
                     _sec_sum(taps, sec_y, ydamp))
    keep = (mask > 0) & (y_gi != 0)
    out_y = jnp.where(keep[:, None, None], out_y, taps[0])
    yplane = out_y.reshape(nv8p, nh8p, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(nv8p * 8, nh8p * 8)[:h, :w]
    outs = [yplane]
    if chroma:
        pri_c = (uv_gi // CDEF_SEC_STRENGTHS) << cs
        sec_c = uv_gi % CDEF_SEC_STRENGTHS
        sec_c = (sec_c + (sec_c == 3)) << cs
        d_c = jnp.where(pri_c != 0, dirs, 0)
        keep_c = (mask > 0) & (uv_gi != 0)
        for pi in (1, 2):
            tc = _gather_taps(pad_planes[pi], nv8p, nh8p, 4, d_c)
            oc = _combine(tc, _pri_sum(tc, pri_c, cdamp, cs),
                          _sec_sum(tc, sec_c, cdamp))
            oc = jnp.where(keep_c[:, None, None], oc, tc[0])
            outs.append(oc.reshape(nv8p, nh8p, 4, 4).transpose(0, 2, 1, 3)
                        .reshape(nv8p * 4, nh8p * 4)[:hc, :wc])
    # single packed transfer
    return jnp.concatenate([o.reshape(-1) for o in outs])


_STATICS_S = ("level", "bit_depth", "nv8p", "nh8p", "chroma")
_STATICS_A = ("bit_depth", "nv8p", "nh8p", "chroma", "h", "w", "hc", "wc")


@partial(jax.jit, static_argnames=_STATICS_S)
def cdef_search_kernel(pads, srcs, mask, ydamp, cdamp, *, level, bit_depth,
                       nv8p, nh8p, chroma):
    return _search_impl(pads, srcs, mask, ydamp, cdamp, level, bit_depth,
                        nv8p, nh8p, chroma)


@partial(jax.jit, static_argnames=_STATICS_S)
def cdef_search_kernel_batch(pads, srcs, masks, ydamps, cdamps, *, level,
                             bit_depth, nv8p, nh8p, chroma):
    def one(p, s, m, yd, cd):
        return _search_impl(p, s, m, yd, cd, level, bit_depth, nv8p, nh8p,
                            chroma)

    return jax.vmap(one)(pads, srcs, masks, ydamps, cdamps)


@partial(jax.jit, static_argnames=_STATICS_A)
def cdef_apply_kernel(pads, dirs, var, y_gi, uv_gi, mask, ydamp, cdamp, *,
                      bit_depth, nv8p, nh8p, chroma, h, w, hc, wc):
    return _apply_impl(pads, dirs, var, y_gi, uv_gi, mask, ydamp, cdamp,
                       bit_depth, nv8p, nh8p, chroma, h, w, hc, wc)


@partial(jax.jit, static_argnames=_STATICS_A)
def cdef_apply_kernel_batch(pads, dirs, var, y_gi, uv_gi, mask, ydamps,
                            cdamps, *, bit_depth, nv8p, nh8p, chroma,
                            h, w, hc, wc):
    def one(p, d, v, yg, ug, m, yd, cd):
        return _apply_impl(p, d, v, yg, ug, m, yd, cd, bit_depth, nv8p,
                           nh8p, chroma, h, w, hc, wc)

    return jax.vmap(one)(pads, dirs, var, y_gi, uv_gi, mask, ydamps, cdamps)


# ---- host glue ---------------------------------------------------------


def _prep_frame(recon_planes, src_planes, skip_g, mi_rows, mi_cols):
    """Build padded planes / padded sources / block mask for one frame.
    Returns None when nothing is filterable."""
    nvfb = (mi_rows + 15) // 16
    nhfb = (mi_cols + 15) // 16
    nv8, nh8 = mi_rows // 2, mi_cols // 2
    nv8p, nh8p = nvfb * 8, nhfb * 8
    g = ~skip_g.astype(bool)
    nonskip = g[0::2, 0::2] | g[1::2, 0::2] | g[0::2, 1::2] | g[1::2, 1::2]
    if not nonskip.any():
        return None
    maskg = np.zeros((nv8p, nh8p), np.float32)
    maskg[:nv8, :nh8] = nonskip

    def pad_to(p, hh, ww, ch, cw):
        # spec 7.15.2 CdefAvailable: everything beyond the CODED area
        # (mi grid) is the large value — chroma planes carry a +4
        # overhang margin that must NOT leak in as real samples
        ph, pw = min(ch, hh), min(cw, ww)
        out = np.full((hh + 4, ww + 4), CDEF_VERY_LARGE, np.int32)
        out[2 : 2 + ph, 2 : 2 + pw] = p[:ph, :pw]
        return out

    def src_pad(p, hh, ww, ch, cw):
        ph, pw = min(ch, hh), min(cw, ww)
        out = np.zeros((hh, ww), np.int32)
        out[:ph, :pw] = p[:ph, :pw]
        return out

    coded = [(mi_rows * 4, mi_cols * 4), (mi_rows * 2, mi_cols * 2),
             (mi_rows * 2, mi_cols * 2)]
    pads = tuple(pad_to(p, nv8p * (8 if i == 0 else 4),
                        nh8p * (8 if i == 0 else 4), *coded[i])
                 for i, p in enumerate(recon_planes))
    srcs = tuple(src_pad(p, nv8p * (8 if i == 0 else 4),
                         nh8p * (8 if i == 0 else 4), *coded[i])
                 for i, p in enumerate(src_planes[: len(recon_planes)]))
    return pads, srcs, maskg, (nvfb, nhfb, nv8p, nh8p)


def _select_strengths(mse0_all, mse1_all, maskg, nvfb, nhfb, cands,
                      rdcost_fn):
    """Greedy dual strength selection + nb_strengths RD (host; tiny)."""
    fb_mask = maskg.reshape(nvfb, 8, nhfb, 8).sum(axis=(1, 3)).reshape(-1) > 0
    act = np.nonzero(fb_mask)[0]
    mse0 = mse0_all[act].astype(np.int64)
    mse1 = mse1_all[act].astype(np.int64)
    n_act = act.size
    best_rd = None
    best = None
    for i in range(4):
        nb = 1 << i
        lev0, lev1, tot = joint_strength_search_dual(nb, mse0, mse1, cands)
        rate = n_act * i + nb * CDEF_STRENGTH_BITS * 2
        rd = rdcost_fn(rate * 512, tot * 16)
        if best_rd is None or rd < best_rd:
            best_rd = rd
            best = (i, lev0, lev1)
    bits, lev0, lev1 = best
    pair_mse = np.stack([mse0[:, l0] + mse1[:, l1]
                         for l0, l1 in zip(lev0, lev1)], axis=1)
    fb_best = np.argmin(pair_mse, axis=1)
    fb_gi_map = np.full((nvfb, nhfb), -1, np.int32)
    fb_gi_map[act // nhfb, act % nhfb] = fb_best
    y_str = [cands[l] for l in lev0]
    uv_str = [cands[l] for l in lev1]
    # per-block strengths over the padded grid
    n = (nvfb * 8) * (nhfb * 8)
    nh8p = nhfb * 8
    blk_fb = (np.arange(n) // nh8p // 8) * nhfb + (np.arange(n) % nh8p) // 8
    sel = np.where(fb_gi_map.reshape(-1)[blk_fb] >= 0,
                   fb_gi_map.reshape(-1)[blk_fb], 0)
    y_gi = np.asarray(y_str, np.int32)[sel]
    uv_gi = np.asarray(uv_str, np.int32)[sel]
    return bits, y_str, uv_str, fb_gi_map, y_gi, uv_gi


def cdef_group_device(jobs: list, level: int, bit_depth: int):
    """Batched CDEF over a group of same-geometry frames.

    jobs: list of dicts with keys recon_planes, src_planes, skip_g,
    mi_rows, mi_cols, base_q_idx, rdcost_fn. Mutates each recon in place
    and returns a list of per-frame results (None where nothing to do),
    each (cdef_bits, y_strengths, uv_strengths, fb_gi_map, damping)."""
    results = [None] * len(jobs)
    prepped = []
    for i, j in enumerate(jobs):
        p = _prep_frame(j["recon_planes"], j["src_planes"], j["skip_g"],
                        j["mi_rows"], j["mi_cols"])
        if p is not None:
            prepped.append((i, j, p))
    if not prepped:
        return results
    nvfb, nhfb, nv8p, nh8p = prepped[0][2][3]
    chroma = len(prepped[0][1]["recon_planes"]) > 1
    cs = bit_depth - 8
    cands = candidate_strengths(level)
    n_cand = len(cands)
    nfb = nvfb * nhfb
    n = nv8p * nh8p

    # stack per-plane across the group
    nplanes = len(prepped[0][2][0])
    pads_b = tuple(jnp.asarray(np.stack([pp[2][0][k] for pp in prepped]))
                   for k in range(nplanes))
    srcs_b = tuple(jnp.asarray(np.stack([pp[2][1][k] for pp in prepped]))
                   for k in range(nplanes))
    masks_b = jnp.asarray(np.stack([pp[2][2].reshape(-1) for pp in prepped]))
    dampings = np.array([3 + (pp[1]["base_q_idx"] >> 6) for pp in prepped],
                        np.int32)
    ydamps = jnp.asarray(dampings + cs)
    cdamps = jnp.asarray(np.maximum(0, dampings + cs - 1))

    packed = np.asarray(cdef_search_kernel_batch(
        pads_b, srcs_b, masks_b, ydamps, cdamps, level=level,
        bit_depth=bit_depth, nv8p=nv8p, nh8p=nh8p, chroma=chroma))

    y_gis, uv_gis, dirs_b, var_b = [], [], [], []
    for row, (i, j, p) in zip(packed, prepped):
        pos = 0
        mse0 = row[pos : pos + nfb * n_cand].reshape(nfb, n_cand); pos += nfb * n_cand
        mse1 = row[pos : pos + nfb * n_cand].reshape(nfb, n_cand); pos += nfb * n_cand
        dirs = row[pos : pos + n].astype(np.int32); pos += n
        var = row[pos : pos + n].astype(np.int32)
        bits, y_str, uv_str, fb_gi_map, y_gi, uv_gi = _select_strengths(
            mse0, mse1, p[2], nvfb, nhfb, cands, j["rdcost_fn"])
        damping = 3 + (j["base_q_idx"] >> 6)
        results[i] = (bits, y_str, uv_str, fb_gi_map, damping)
        y_gis.append(y_gi)
        uv_gis.append(uv_gi)
        dirs_b.append(dirs)
        var_b.append(var)

    # write back the coded area only (spec 7.15: CDEF covers the mi
    # grid); samples beyond it, such as the chroma overhang, stay as
    # they are
    mi_rows, mi_cols = prepped[0][1]["mi_rows"], prepped[0][1]["mi_cols"]
    h, w = mi_rows * 4, mi_cols * 4
    hc, wc = (mi_rows * 2, mi_cols * 2) if chroma else (0, 0)
    packed_out = np.asarray(cdef_apply_kernel_batch(
        pads_b, jnp.asarray(np.stack(dirs_b)), jnp.asarray(np.stack(var_b)),
        jnp.asarray(np.stack(y_gis)), jnp.asarray(np.stack(uv_gis)),
        masks_b, ydamps, cdamps, bit_depth=bit_depth, nv8p=nv8p, nh8p=nh8p,
        chroma=chroma, h=h, w=w, hc=hc, wc=wc))
    for row, (i, j, p) in zip(packed_out, prepped):
        rp = j["recon_planes"]
        rp[0][:h, :w] = row[: h * w].reshape(h, w)
        if chroma:
            rp[1][:hc, :wc] = row[h * w : h * w + hc * wc].reshape(hc, wc)
            rp[2][:hc, :wc] = row[h * w + hc * wc :].reshape(hc, wc)
    return results


def cdef_search_frame_device(recon_planes, src_planes, skip_g, mi_rows: int,
                             mi_cols: int, base_q_idx: int, rdcost_fn,
                             level: int = 3, bit_depth: int = 8):
    """Drop-in for ops.cdef.cdef_search_frame (single frame) with the
    heavy passes on device. Same return contract; mutates recon_planes."""
    res = cdef_group_device([dict(recon_planes=recon_planes,
                                  src_planes=src_planes, skip_g=skip_g,
                                  mi_rows=mi_rows, mi_cols=mi_cols,
                                  base_q_idx=base_q_idx,
                                  rdcost_fn=rdcost_fn)],
                            level, bit_depth)
    return res[0]
