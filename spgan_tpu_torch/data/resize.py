"""cv2's 8-bit resizes in numpy, bit for bit: ``cv2.resize`` with
INTER_LANCZOS4 (the training pipeline's square resize) and INTER_LINEAR
(the synthetic source's upsample) on uint8 images.  Neither cv2 nor PIL
is a dependency of the port.

The arithmetic is cv2's fixed point (imgproc resize.cpp, generic path):
  * source position of destination pixel d: the float32 of
    (d + 0.5) * (1 / (dst / src)) - 0.5, split into floor and fraction;
  * each tap's float32 weight rounded (half to even) to 2048ths;
  * a horizontal pass of int32 sums over taps clamped to the edge, then
    a vertical one over rows clamped to the edge (cv2's int accumulators;
    no sum of 8-bit inputs comes near 2^31);
  * Lanczos4: 8 taps at floor-3 .. floor+4, (v + 2^21) >> 22 saturated to
    uint8; linear: cv2's SIMD rounding of the vertical pass,
    ((b0 (S0 >> 4)) >> 16 + (b1 (S1 >> 4)) >> 16 + 2) >> 2.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

_COEF_SCALE = np.float32(2048)
_S45 = 0.70710678118654752440084436210485
# (sin, cos) factors of cv2's interpolateLanczos4, tap by tap
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45))


def _source_positions(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """(floor (dst,) int64, fraction (dst,) float32) of each destination
    pixel's source position."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def _lanczos4_weights(x: np.float32) -> list:
    """cv2's interpolateLanczos4: float32 operands, double trigonometry,
    float32 normalisation."""
    xp3 = np.float32(x + np.float32(3))
    y0 = float(-xp3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs, total = [], np.float32(0)
    for i, (cs, cc) in enumerate(_LANCZOS_CS):
        yi = np.float32(xp3 - np.float32(i))
        if abs(yi) >= np.float32(1e-6):
            y = float(-yi) * math.pi * 0.25
            c = np.float32((cs * s0 + cc * c0) / (y * y))
        else:
            c = np.float32(1e30)
        coeffs.append(c)
        total = np.float32(total + c)
    inv = np.float32(np.float32(1) / total)
    return [np.float32(c * inv) for c in coeffs]


def _fixed(weights) -> np.ndarray:
    return np.rint(np.asarray(weights, np.float32) * _COEF_SCALE).astype(
        np.int32)


@functools.lru_cache(maxsize=64)
def _lanczos4_axis(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """(source indices (dst, 8), fixed-point weights (dst, 8)) of one axis,
    read-only: they depend on the two sizes only, and cost a Python loop
    per destination pixel to compute."""
    s, f = _source_positions(dst, src)
    idx = np.clip(s[:, None] + np.arange(-3, 5), 0, src - 1)
    weights = _fixed([_lanczos4_weights(v) for v in f])
    idx.setflags(write=False)
    weights.setflags(write=False)
    return idx, weights


def _tap_sum(src: np.ndarray, idx: np.ndarray,
             weights: np.ndarray) -> np.ndarray:
    """sum_t src[idx[:, t]] * weights[:, t] over the first axis of the
    int32 array `src`: (n, ...) from index and weight tables (n, taps)."""
    acc = src[idx[:, 0]]
    acc *= weights[:, 0].reshape((-1,) + (1,) * (src.ndim - 1))
    for t in range(1, idx.shape[1]):
        term = src[idx[:, t]]
        term *= weights[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
        acc += term
    return acc


def _as_hwc(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"want a (H, W) or (H, W, C) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    return img[..., None] if img.ndim == 2 else img


def resize_lanczos4_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LANCZOS4)`` for a
    uint8 (H, W) or (H, W, C) image.  Both passes are exact integer sums
    and cv2 rounds once at the end, so their order does not matter: the
    vertical pass runs first, then the horizontal one on the transposed
    result, both gathering whole rows."""
    src = _as_hwc(img)
    sh, sw = src.shape[:2]
    rows, beta = _lanczos4_axis(h, sh)
    cols, alpha = _lanczos4_axis(w, sw)
    vert = _tap_sum(src.astype(np.int32), rows, beta)
    v = _tap_sum(np.ascontiguousarray(vert.transpose(1, 0, 2)), cols, alpha)
    v += 1 << 21
    v >>= 22
    np.clip(v, 0, 255, out=v)
    out = np.ascontiguousarray(v.transpose(1, 0, 2).astype(np.uint8))
    return out.reshape(out.shape[:2] + img.shape[2:])


def resize_linear_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` for a
    uint8 (H, W) or (H, W, C) image.  (For an exact halving of both sides
    cv2 switches to INTER_AREA; this function stays linear.)"""
    src = _as_hwc(img)
    sh, sw = src.shape[:2]
    sy, fy = _source_positions(h, sh)
    sx, fx = _source_positions(w, sw)
    # columns: a position left of the first or right of the last pixel
    # takes that pixel whole; rows are only clamped
    edge = (sx < 0) | (sx >= sw - 1)
    fx = np.where(edge, np.float32(0), fx)
    sx = np.clip(sx, 0, sw - 1)
    one = np.float32(1)
    a = _fixed(np.stack([one - fx, fx], 1))
    s32 = src.astype(np.int32)
    horiz = s32[:, sx]
    horiz *= a[:, 0, None]
    right = s32[:, np.minimum(sx + 1, sw - 1)]
    right *= a[:, 1, None]
    horiz += right
    horiz >>= 4
    b = _fixed(np.stack([one - fy, fy], 1))
    v = horiz[np.clip(sy, 0, sh - 1)]
    v *= b[:, 0, None, None]
    v >>= 16
    v1 = horiz[np.clip(sy + 1, 0, sh - 1)]
    v1 *= b[:, 1, None, None]
    v1 >>= 16
    v += v1
    v += 2
    v >>= 2
    np.clip(v, 0, 255, out=v)
    out = v.astype(np.uint8)
    return out.reshape(out.shape[:2] + img.shape[2:])
