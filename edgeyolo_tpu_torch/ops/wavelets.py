"""Wavelet filter banks, computed on the host with numpy (no pywt dependency).

The port's own copy of edgeyolo_tpu/ops/wavelets.py: Haar in closed form,
Daubechies dbN by spectral factorization of the Daubechies polynomial
(minimum-phase roots), symN for N<=3 equal to dbN. Filters follow the pywt
convention (`dec_lo` time-reversed relative to the scaling coefficients), so
plain correlation implements the DWT. The 2D analysis kernels are
(k, k, 1, 4) in (LL, LH, HL, HH) order; the DWT module turns them into a
stride-2 depthwise convolution. The synthesis kernels are (k, k, 4), the
inverse Haar's 2 x 2 taps of each band.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["get_filter_bank", "dwt2d_kernel", "idwt2d_kernel", "dwt_pad_each_side",
           "available_wavelets"]


def _daubechies_dec_lo(N: int) -> np.ndarray:
    """Scaling (low-pass decomposition) filter for dbN, length 2N, pywt ordering."""
    if N == 1:
        h = np.array([1.0, 1.0]) / math.sqrt(2.0)
        return h[::-1].copy()
    # P(y) = sum_{k=0}^{N-1} C(N-1+k, k) y^k ; factor B(z) with |roots|<1 (min phase)
    k = np.arange(N)
    P = np.array([math.comb(N - 1 + int(j), int(j)) for j in k], dtype=np.float64)
    # roots of P in y, then map y -> z via y = (2 - z - 1/z)/4  <=>  z^2 - (2-4y) z + 1 = 0
    y_roots = np.roots(P[::-1])
    z_roots = []
    for y in y_roots:
        b = 2.0 - 4.0 * y
        disc = np.sqrt(b * b - 4.0 + 0j)
        z1, z2 = (b + disc) / 2.0, (b - disc) / 2.0
        z_roots.append(z1 if abs(z1) < 1 else z2)  # minimum phase choice
    # h(z) = sqrt(2) * ((1+z)/2)^N * prod (z - z_i)/(1 - z_i)
    poly = np.array([1.0 + 0j])
    for _ in range(N):
        poly = np.convolve(poly, [0.5, 0.5])
    for z in z_roots:
        poly = np.convolve(poly, np.array([1.0, -z]) / (1.0 - z))
    h = np.real(poly) * math.sqrt(2.0)
    h /= np.sum(h) / math.sqrt(2.0)  # exact normalization sum(h)=sqrt(2)
    return h[::-1].copy()  # pywt dec_lo ordering (time-reversed scaling coeffs)


@functools.lru_cache(maxsize=32)
def get_filter_bank(wave: str = "haar") -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Return (dec_lo, dec_hi, rec_lo, rec_hi) float64 1-D filters for a wavelet name."""
    wave = wave.lower()
    if wave in {"haar", "db1", "sym1"}:
        dec_lo = np.array([1.0, 1.0]) / math.sqrt(2.0)
    elif wave.startswith("db") or wave.startswith("sym"):
        n = int(wave[3:] if wave.startswith("sym") else wave[2:])
        if wave.startswith("sym") and n > 3:
            raise ValueError(f"symN with N>3 not supported without pywt (got {wave}); use dbN or haar")
        dec_lo = _daubechies_dec_lo(n)
    else:
        raise ValueError(f"unsupported wavelet '{wave}'; supported: haar, db1-db20, sym1-sym3")
    # QMF relations, pywt sign convention (verified against pywt's published
    # filter banks: haar dec_hi = [-r, r], db2 dec_hi starts negative):
    #   dec_hi[k] = (-1)^(k+1) rec_lo[k]   (flip EVEN indices)
    #   rec_hi[k] = (-1)^k     dec_lo[k]   (flip ODD indices)
    # The previous convention negated both — internally consistent (the two
    # flips cancel through DWT->IWT) but the LH/HL band VALUES came out
    # negated vs the reference's pywt-built kernels, which cross-framework
    # weight transfer of per-band convs can see.
    L = len(dec_lo)
    rec_lo = dec_lo[::-1].copy()
    dec_hi = rec_lo.copy()
    dec_hi[::2] *= -1
    rec_hi = dec_lo.copy()
    rec_hi[1::2] *= -1
    assert len(dec_hi) == L
    return dec_lo, dec_hi, rec_lo, rec_hi


def dwt2d_kernel(wave: str = "haar", dtype=np.float32) -> np.ndarray:
    """2D single-level DWT kernel bank for stride-2 depthwise convolution.

    Returns array of shape (k, k, 1, 4) (HWIO, depthwise multiplier=4) ordered
    (LL, LH, HL, HH). Filters are time-reversed so plain convolution applies the
    analysis bank, matching the reference's `dec_lo[::-1]` construction.
    """
    dec_lo, dec_hi, _, _ = get_filter_bank(wave)
    h0 = dec_lo[::-1]
    h1 = dec_hi[::-1]
    kLL = np.outer(h0, h0)
    kLH = np.outer(h0, h1)  # low rows, high cols (reference ordering)
    kHL = np.outer(h1, h0)
    kHH = np.outer(h1, h1)
    k = np.stack([kLL, kLH, kHL, kHH], axis=-1)[:, :, None, :]  # (k,k,1,4)
    return k.astype(dtype)


def idwt2d_kernel(wave: str = "haar", dtype=np.float32) -> np.ndarray:
    """2D single-level inverse-DWT synthesis kernels, shape (k, k, 4) in
    (LL, LH, HL, HH) order, for a stride-2 transposed depthwise convolution."""
    _, _, rec_lo, rec_hi = get_filter_bank(wave)
    g0, g1 = rec_lo, rec_hi
    k = np.stack([np.outer(g0, g0), np.outer(g0, g1), np.outer(g1, g0), np.outer(g1, g1)], axis=-1)
    return k.astype(dtype)


def available_wavelets() -> list[str]:
    """The wave names DWT2D and WTConv2d accept."""
    return ["haar"] + [f"db{i}" for i in range(1, 21)] + ["sym1", "sym2", "sym3"]


def dwt_pad_each_side(wave: str) -> int:
    """Reflect-padding per side used before the stride-2 analysis conv
    (odd taps: k//2; even taps: k//2-1 — the reference's approximation)."""
    k = len(get_filter_bank(wave)[0])
    return k // 2 if (k % 2 == 1) else max(k // 2 - 1, 0)
