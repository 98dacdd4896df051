"""Alt-ref temporal filtering: motion-compensated non-local-mean denoising
of anchor (ARF) sources before encoding.

Counterpart: the reference's temporal filtering process
(temporal_filtering.c svt_av1_apply_temporal_filter_planewise_medium /
calculate_decay_factor): per-32x32 motion search against each window
frame, per-subblock exp(-err/decay) weights accumulated pixel-wise, with
decay derived from noise level and q. This implementation keeps the same
accumulate/count structure with a 16x16 full-pel search (the anchor
quality comes from averaging many frames, not from subpel MC) and a
single decay combining q and an MAD-based noise estimate.

Encoder-side only: no bitstream syntax. The filtered frame becomes the
coded ARF source; hierarchical B frames then predict from a denoised
anchor.
"""

from __future__ import annotations

import numpy as np

_BLK = 16
_SEARCH = 8  # full-pel raster radius around the co-located block
_WEIGHT_SCALE = 1 << 10  # center-frame anchor weight


def estimate_noise_mad(luma: np.ndarray) -> float:
    """Median-absolute-deviation of the Laplacian — the reference's
    svt_estimate_noise_fp16 shape (temporal_filtering.c noise estimate),
    simplified to a plain float."""
    x = luma.astype(np.int64)
    lap = (4 * x[1:-1, 1:-1] - x[:-2, 1:-1] - x[2:, 1:-1]
           - x[1:-1, :-2] - x[1:-1, 2:])
    mad = np.median(np.abs(lap))
    # median|Laplacian| for N(0,s^2) noise is ~3.0*s (weights 4,-1x4)
    return float(mad) / 3.0


def _block_motion(center: np.ndarray, ref: np.ndarray, by: int, bx: int,
                  bh: int, bw: int) -> tuple[int, int, int]:
    """Full-pel SAD raster search of ref around the co-located block;
    returns (dy, dx, sse_of_best)."""
    h, w = center.shape
    cur = center[by : by + bh, bx : bx + bw].astype(np.int32)
    best = None
    # two-stage: coarse step 2, then refine +-1
    for step, center_mv, rad in ((2, (0, 0), _SEARCH), (1, None, 1)):
        cy, cx = center_mv if center_mv is not None else (best[1], best[2])
        for dy in range(cy - rad, cy + rad + 1, step):
            y0 = by + dy
            if y0 < 0 or y0 + bh > h:
                continue
            for dx in range(cx - rad, cx + rad + 1, step):
                x0 = bx + dx
                if x0 < 0 or x0 + bw > w:
                    continue
                cand = ref[y0 : y0 + bh, x0 : x0 + bw].astype(np.int32)
                sad = int(np.abs(cand - cur).sum())
                if best is None or sad < best[0]:
                    best = (sad, dy, dx)
    _, dy, dx = best
    blk = ref[by + dy : by + dy + bh, bx + dx : bx + dx + bw].astype(np.int64)
    sse = int(((blk - cur) ** 2).sum())
    return dy, dx, sse


def _decay_px(y: np.ndarray, qindex: int, bit_depth: int,
              strength: int) -> float:
    """Per-pixel squared-error decay for the exp weights (shared by the
    host and device paths)."""
    noise = estimate_noise_mad(y)
    q_decay = max(0.5, min(4.0, (qindex / 120.0) ** 2))
    decay = max(12.0 * (1 << (2 * (bit_depth - 8))),
                2.5 * noise * noise) * q_decay
    # --tf-strength 0..4: power-of-two filter strength ladder
    # (temporal_filtering.c:2996 tf_shift_factor; 3 = default)
    return decay * 2.0 ** (min(strength, 4) - 3)


def temporal_filter(center: list, neighbors: list, qindex: int,
                    bit_depth: int = 8, strength: int = 3) -> list:
    """Filter `center` planes [Y,U,V] using `neighbors` (list of plane
    lists). Returns new planes with the same dtypes.

    The search + accumulate runs as one jitted device program
    (device/tf.py); SVT_TPU_HOST_TF=1 selects the original per-block
    host loop (kept as a readable second opinion for tests)."""
    import os

    if not neighbors:
        return center
    if os.environ.get("SVT_TPU_HOST_TF") != "1":
        return _temporal_filter_device(center, neighbors, qindex,
                                       bit_depth, strength)
    return _temporal_filter_host(center, neighbors, qindex, bit_depth,
                                 strength)


def _temporal_filter_device(center, neighbors, qindex, bit_depth,
                            strength) -> list:
    import jax.numpy as jnp

    from ..device.tf import BLK, n_bucket, tf_filter

    y = np.asarray(center[0])
    h, w = y.shape
    hp = -(-h // BLK) * BLK
    wp = -(-w // BLK) * BLK
    ss = []
    for p in range(len(center)):
        ph, pw = np.asarray(center[p]).shape
        ss.append((int(np.log2(h // ph + 0.5)) if ph != h else 0,
                   int(np.log2(w // pw + 0.5)) if pw != w else 0))

    def pad(a, ss_y, ss_x):
        a = np.asarray(a)
        th, tw = hp >> ss_y, wp >> ss_x
        return np.pad(a, ((0, th - a.shape[0]), (0, tw - a.shape[1])),
                      mode="edge")

    nb = n_bucket(len(neighbors))
    cen = tuple(pad(center[p], *ss[p]) for p in range(len(center)))
    stacks = []
    for p in range(len(center)):
        s = [pad(f[p], *ss[p]) for f in neighbors[:nb]]
        while len(s) < nb:         # zero-weight padding slots
            s.append(cen[p])
        stacks.append(np.stack(s))
    decay = np.float32(_decay_px(y, qindex, bit_depth, strength))
    outs = [np.asarray(o) for o in tf_filter(
        cen, tuple(stacks), jnp.int32(min(len(neighbors), nb)), decay,
        bit_depth=bit_depth, planes_ss=tuple(ss))]
    res = []
    for p in range(len(center)):
        src = np.asarray(center[p])
        res.append(outs[p][:src.shape[0], :src.shape[1]]
                   .astype(src.dtype))
    return res


def _temporal_filter_host(center: list, neighbors: list, qindex: int,
                          bit_depth: int = 8, strength: int = 3) -> list:
    y = np.asarray(center[0])
    h, w = y.shape
    ss = []
    for p in range(len(center)):
        ph, pw = np.asarray(center[p]).shape
        ss.append((int(np.log2(h // ph + 0.5)) if ph != h else 0,
                   int(np.log2(w // pw + 0.5)) if pw != w else 0))

    # decay: larger noise / larger q -> heavier filtering
    # (calculate_decay_factor's n_decay^2 * q_decay shape). A perfect MC
    # match of independent noise still shows err ~= 2*sigma^2 per px, so
    # the per-px decay is anchored at ~2.5*sigma^2 to keep such blocks at
    # meaningful weight.
    noise = estimate_noise_mad(y)
    q_decay = max(0.5, min(4.0, (qindex / 120.0) ** 2))
    decay_px = max(12.0 * (1 << (2 * (bit_depth - 8))),
                   2.5 * noise * noise) * q_decay
    # --tf-strength 0..4: power-of-two filter strength ladder
    # (temporal_filtering.c:2996 tf_shift_factor; 3 = default)
    decay_px *= 2.0 ** (min(strength, 4) - 3)

    accum = [np.zeros_like(np.asarray(p), np.int64) for p in center]
    count = [np.zeros_like(np.asarray(p), np.int64) for p in center]
    for p in range(len(center)):
        accum[p] += np.asarray(center[p]).astype(np.int64) * _WEIGHT_SCALE
        count[p] += _WEIGHT_SCALE

    for nb in neighbors:
        nyp = np.asarray(nb[0])
        for by in range(0, h - h % _BLK, _BLK):
            for bx in range(0, w - w % _BLK, _BLK):
                bh = min(_BLK, h - by)
                bw = min(_BLK, w - bx)
                dy, dx, sse = _block_motion(y, nyp, by, bx, bh, bw)
                err = sse / (bh * bw)
                wgt = int(round(
                    np.exp(-min(err / decay_px, 7.0)) * _WEIGHT_SCALE))
                if wgt == 0:
                    continue
                for p in range(len(center)):
                    sy, sx = ss[p]
                    pby, pbx = by >> sy, bx >> sx
                    pbh, pbw = bh >> sy, bw >> sx
                    py0 = pby + (dy >> sy)
                    px0 = pbx + (dx >> sx)
                    ref_p = np.asarray(nb[p])
                    ph, pw = ref_p.shape
                    if py0 < 0 or px0 < 0 or py0 + pbh > ph or px0 + pbw > pw:
                        continue
                    blk = ref_p[py0 : py0 + pbh, px0 : px0 + pbw].astype(np.int64)
                    wgt_p = wgt
                    if p > 0:
                        # planewise: cap by this plane's own MC error
                        # (chroma can move independently of luma)
                        cur_p = np.asarray(center[p])[
                            pby : pby + pbh, pbx : pbx + pbw].astype(np.int64)
                        err_p = float(((blk - cur_p) ** 2).mean())
                        wp = int(round(
                            np.exp(-min(err_p / decay_px, 7.0))
                            * _WEIGHT_SCALE))
                        wgt_p = min(wgt, wp)
                        if wgt_p == 0:
                            continue
                    accum[p][pby : pby + pbh, pbx : pbx + pbw] += wgt_p * blk
                    count[p][pby : pby + pbh, pbx : pbx + pbw] += wgt_p

    out = []
    for p in range(len(center)):
        src = np.asarray(center[p])
        filt = (accum[p] + count[p] // 2) // np.maximum(count[p], 1)
        out.append(filt.astype(src.dtype))
    return out
