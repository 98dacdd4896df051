"""Matmul-form DCTs for the device ANALYSIS tier.

The AV1 integer transforms are butterfly networks whose only
nonlinearities are per-stage roundings; their rounding-free linear map
is a dense (n, n) matrix.  The analysis tier only *decides* (the
conformant commit requantizes through the exact integer chain in C), so
it can run the transforms as float32 matrix products instead of int32
butterfly gathers — the reformulation SURVEY §2.3 prescribes for the
txfm family ("matmul-form butterflies").

Matrices are probed from the reference numpy networks (ops/txfm.py) at
high amplitude so per-stage rounding vanishes: |error| <= n * 2^-A
relative.  Decisions near RD ties may differ from the integer path by
one quantization level; streams remain conformant either way.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import txfm as txfm_ref

_AMP = 1 << 20


@lru_cache(maxsize=None)
def dct1d_mat(n: int, cos_bit: int, inverse: bool) -> np.ndarray:
    """The (n, n) float64 linear map L of the 1D network: net(v) == L @ v
    (rounding-free).  Probed column-by-column at amplitude 2^20."""
    x = np.eye(n, dtype=np.int64) * _AMP
    y = txfm_ref._run_1d("dct", n, x, cos_bit, 62, inverse)
    # row i of y = net(e_i) = L @ e_i = column i of L
    return y.astype(np.float64).T / _AMP


@lru_cache(maxsize=None)
def fwd_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(F_col (cn, n), F_row (cn, n)), shift gains folded in;
    coeffs[:cn,:cn] = F_col @ resid @ F_row.T (cn = min(n, 32))."""
    i = int(np.log2(n)) - 2
    cb_col = txfm_ref._FWD_COS_BIT_COL[i][i]
    cb_row = txfm_ref._FWD_COS_BIT_ROW[i][i]
    s0, s1, s2 = txfm_ref._FWD_SHIFT[(n, n)]
    cn = min(n, 32)
    fc = dct1d_mat(n, cb_col, False)[:cn] * (2.0 ** (s0 + s1))
    fr = dct1d_mat(n, cb_row, False)[:cn] * (2.0 ** s2)
    return (np.ascontiguousarray(fc, np.float32),
            np.ascontiguousarray(fr, np.float32))


@lru_cache(maxsize=None)
def inv_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(G_col (n, cn), G_row (n, cn)); resid = G_col @ dq @ G_row.T."""
    s0, s1 = txfm_ref._INV_SHIFT[(n, n)]
    cn = min(n, 32)
    li = dct1d_mat(n, txfm_ref.INV_COS_BIT, True)
    gc = li[:, :cn] * (2.0 ** s1)
    gr = li[:, :cn] * (2.0 ** s0)
    return (np.ascontiguousarray(gc, np.float32),
            np.ascontiguousarray(gr, np.float32))


def _sep2d(x: jnp.ndarray, mc: np.ndarray, mr: np.ndarray) -> jnp.ndarray:
    """out[b,i,l] = sum_{j,k} mc[i,j] x[b,j,k] mr[l,k] as TWO flat
    matmuls with M = B*n — one large GEMM per pass instead of B tiny
    batched ones."""
    b, n, _ = x.shape
    cn_r, cn_c = mr.shape[0], mc.shape[0]
    hi = jax.lax.Precision.HIGHEST
    # HIGHEST: full f32 products. DEFAULT may round the operands (TF32
    # on tensor cores, bf16 elsewhere), which skews the transform and
    # decouples device RD decisions from the host
    t = jnp.dot(x.reshape(b * n, n), jnp.asarray(mr).T,
                preferred_element_type=jnp.float32, precision=hi)
    t = t.reshape(b, n, cn_r).transpose(0, 2, 1).reshape(b * cn_r, n)
    o = jnp.dot(t, jnp.asarray(mc).T,
                preferred_element_type=jnp.float32, precision=hi)
    return o.reshape(b, cn_r, cn_c).transpose(0, 2, 1)


def fwd_dct2d_mat(resid: jnp.ndarray, n: int) -> jnp.ndarray:
    """(B, n, n) -> (B, cn, cn) float32 DCT_DCT coefficients (analysis)."""
    fc, fr = fwd_mats(n)
    return _sep2d(resid.astype(jnp.float32), fc, fr)


def inv_dct2d_mat(dq: jnp.ndarray, n: int) -> jnp.ndarray:
    """(B, cn, cn) dequantized coeffs -> (B, n, n) float32 residual."""
    gc, gr = inv_mats(n)
    return _sep2d(dq.astype(jnp.float32), gc, gr)
