"""ctypes frontend for the C CDEF kernels (native/cdef.c).

Same frame contract as ops.cdef.cdef_search_frame / the device variant:
full-grid padded planes + per-8x8-unit mask, per-candidate MSE search,
host greedy dual-strength selection (shared helpers), filter apply in
place. The default CDEF backend; the device path (device/cdef.py) is
opt-in (SVT_TPU_DEVICE_CDEF=1).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops.cdef import candidate_strengths
from .ecenc import get_lib

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)

_registered = False


def _lib():
    global _registered
    lib = get_lib()
    if lib is not None and not _registered and hasattr(lib, "svt_cdef_search"):
        lib.svt_cdef_dirs.argtypes = [_I32P] + [ctypes.c_int] * 4 + [_I32P] * 2
        lib.svt_cdef_search.argtypes = (
            [_I32P, ctypes.c_int, _I32P, _I32P, ctypes.c_int,
             _I32P, ctypes.c_int, _I32P, _I32P, ctypes.c_int,
             _U8P] + [ctypes.c_int] * 3 + [_I32P] * 2 +
            [_I32P, ctypes.c_int] + [ctypes.c_int] * 4 + [_I64P, _I64P])
        lib.svt_cdef_apply.argtypes = (
            [_I32P, ctypes.c_int, _I32P, _I32P, ctypes.c_int,
             _I32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _I32P, _I32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _U8P] + [ctypes.c_int] * 2 + [_I32P] * 4 + [ctypes.c_int] * 4)
        _registered = True
    return lib


def available() -> bool:
    lib = _lib()
    return lib is not None and hasattr(lib, "svt_cdef_search")


def _p32(a):
    return a.ctypes.data_as(_I32P)


def cdef_search_frame_c(recon_planes, src_planes, skip_g, mi_rows: int,
                        mi_cols: int, base_q_idx: int, rdcost_fn,
                        level: int = 3, bit_depth: int = 8):
    """Drop-in for ops.cdef.cdef_search_frame backed by native/cdef.c."""
    from ..device.cdef import _prep_frame, _select_strengths

    prep = _prep_frame(recon_planes, src_planes, skip_g, mi_rows, mi_cols)
    if prep is None:
        return None
    pads, srcs, maskg, (nvfb, nhfb, nv8p, nh8p) = prep
    chroma = len(recon_planes) > 1
    cs = bit_depth - 8
    damping = 3 + (base_q_idx >> 6)
    ydamp, cdamp = damping + cs, max(0, damping + cs - 1)
    cands = np.asarray(candidate_strengths(level), np.int32)
    n_cand = len(cands)
    nfb = nvfb * nhfb
    n = nv8p * nh8p

    lib = _lib()
    mask8 = np.ascontiguousarray(maskg.reshape(-1) > 0).astype(np.uint8)
    dirs = np.empty(n, np.int32)
    var = np.empty(n, np.int32)
    lib.svt_cdef_dirs(_p32(pads[0]), pads[0].shape[1], nv8p, nh8p, cs,
                      _p32(dirs), _p32(var))
    mse0 = np.zeros((nfb, n_cand), np.int64)
    mse1 = np.zeros((nfb, n_cand), np.int64)
    if chroma:
        pu, pv = pads[1], pads[2]
        su, sv = srcs[1], srcs[2]
    else:  # dummies (never dereferenced with chroma=0)
        pu = pv = pads[0]
        su = sv = srcs[0]
    # search-block subsampling at the fast levels (the reference's
    # subsampling_factor, enc_cdef.c): MSE estimated on every ss-th
    # filterable unit, keeping at least one per active 64x64 fb
    from ..ops.cdef import _SEARCH_SUBSAMPLE

    ss = _SEARCH_SUBSAMPLE.get(level, 1)
    smask = mask8
    if ss > 1:
        act = np.nonzero(mask8)[0]
        keep = np.zeros(n, np.uint8)
        keep[act[::ss]] = 1
        fbidx = (act // nh8p // 8) * nhfb + (act % nh8p) // 8
        first = np.r_[True, fbidx[1:] != fbidx[:-1]]
        keep[act[first]] = 1
        smask = keep
    lib.svt_cdef_search(
        _p32(pads[0]), pads[0].shape[1], _p32(pu), _p32(pv), pu.shape[1],
        _p32(srcs[0]), srcs[0].shape[1], _p32(su), _p32(sv), su.shape[1],
        smask.ctypes.data_as(_U8P), nv8p, nh8p, nhfb,
        _p32(dirs), _p32(var), _p32(cands), n_cand,
        ydamp, cdamp, cs, 1 if chroma else 0,
        mse0.ctypes.data_as(_I64P), mse1.ctypes.data_as(_I64P))

    bits, y_str, uv_str, fb_gi_map, y_gi, uv_gi = _select_strengths(
        mse0.astype(np.float64), mse1.astype(np.float64), maskg, nvfb, nhfb,
        list(map(int, cands)), rdcost_fn)

    h, w = recon_planes[0].shape
    if chroma:
        hc, wc = recon_planes[1].shape
        ru, rv = recon_planes[1], recon_planes[2]
    else:
        hc = wc = 0
        ru = rv = recon_planes[0]
    lib.svt_cdef_apply(
        _p32(pads[0]), pads[0].shape[1], _p32(pu), _p32(pv), pu.shape[1],
        _p32(recon_planes[0]), recon_planes[0].shape[1], h, w,
        _p32(ru), _p32(rv), ru.shape[1], hc, wc,
        mask8.ctypes.data_as(_U8P), nv8p, nh8p,
        _p32(dirs), _p32(var),
        _p32(np.ascontiguousarray(y_gi)), _p32(np.ascontiguousarray(uv_gi)),
        ydamp, cdamp, cs, 1 if chroma else 0)
    return bits, y_str, uv_str, fb_gi_map, damping
