"""Panorama data preparation: cubemap -> equirectangular projection (the
port's own copy of spgan_tpu/data/pano.py; numpy only).

Replaces the reference's external `cube2sphere` binary + multiprocess driver
(gen_pano_dataset.py:15-28,100-117) with an in-repo vectorized projection.
The reference renders Matterport3D's 6 skybox faces to a 768x384 equirect
image and then clips vertically to the middle 2/3 (edge_cutoff_ratio=0.6667 ==
train_params.partial) giving 768x256.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# Matterport skybox face order used by the reference's cube2sphere call:
# (front, right, back, left, top, bottom) per gen_pano_dataset.py
FACES = ("front", "right", "back", "left", "top", "bottom")


def _face_uv(direction: np.ndarray):
    """Map unit direction vectors (..., 3) to (face_index, u, v) in [0,1]."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)

    face = np.zeros(x.shape, np.int32)
    u = np.zeros(x.shape, np.float64)
    v = np.zeros(x.shape, np.float64)

    # +x: front(0), -x: back(2), +y: right(1), -y: left(3),
    # +z: top(4), -z: bottom(5)
    m = (ax >= ay) & (ax >= az) & (x > 0)
    face[m], u[m], v[m] = 0, (y[m] / ax[m]), (-z[m] / ax[m])
    m = (ax >= ay) & (ax >= az) & (x <= 0)
    face[m], u[m], v[m] = 2, (-y[m] / ax[m]), (-z[m] / ax[m])
    m = (ay > ax) & (ay >= az) & (y > 0)
    face[m], u[m], v[m] = 1, (-x[m] / ay[m]), (-z[m] / ay[m])
    m = (ay > ax) & (ay >= az) & (y <= 0)
    face[m], u[m], v[m] = 3, (x[m] / ay[m]), (-z[m] / ay[m])
    m = (az > ax) & (az > ay) & (z > 0)
    face[m], u[m], v[m] = 4, (y[m] / az[m]), (x[m] / az[m])
    m = (az > ax) & (az > ay) & (z <= 0)
    face[m], u[m], v[m] = 5, (y[m] / az[m]), (-x[m] / az[m])

    return face, (u + 1) / 2, (v + 1) / 2


def cubemap_to_equirect(faces: Dict[str, np.ndarray], width: int = 768,
                        height: int = 384,
                        edge_cutoff_ratio: float = 0.6667,
                        bilinear: bool = True) -> np.ndarray:
    """faces: dict of 6 (S, S, 3) uint8/float arrays keyed by FACES names.
    Returns the vertically-clipped equirect pano
    (round(height*ratio), width, 3).

    bilinear=True matches the reference's cube2sphere renderer
    (gen_pano_dataset.py:15-28 shells out to a GL render, which filters
    bilinearly); nearest is kept for exact-value tests.  Measured on a
    synthetic smooth scene at 768x384/S=256 (the JAX package's
    tests/test_data.py::test_cubemap_bilinear_beats_nearest): bilinear
    cuts the max reconstruction error ~8x and removes the half-texel
    stairstepping nearest leaves along face diagonals.  Filtering stays within one face:
    samples are clamped at face edges (no cross-face blend), which is what
    per-face texture sampling in the renderer does too."""
    lon = (np.arange(width) + 0.5) / width * 2 * np.pi - np.pi
    lat = np.pi / 2 - (np.arange(height) + 0.5) / height * np.pi
    lon, lat = np.meshgrid(lon, lat)
    d = np.stack([np.cos(lat) * np.cos(lon),
                  np.cos(lat) * np.sin(lon),
                  np.sin(lat)], axis=-1)
    face, u, v = _face_uv(d)

    s = faces[FACES[0]].shape[0]
    stack = np.stack([np.asarray(faces[k]) for k in FACES])  # (6,S,S,3)
    if bilinear:
        # texel centers at (i + 0.5)/s: sample position in texel space
        fu = np.clip(u * s - 0.5, 0.0, s - 1.0)
        fv = np.clip(v * s - 0.5, 0.0, s - 1.0)
        u0 = np.floor(fu).astype(np.int32)
        v0 = np.floor(fv).astype(np.int32)
        u1 = np.minimum(u0 + 1, s - 1)
        v1 = np.minimum(v0 + 1, s - 1)
        wu = (fu - u0)[..., None]
        wv = (fv - v0)[..., None]
        sf = stack.astype(np.float32)
        top = sf[face, v0, u0] * (1 - wu) + sf[face, v0, u1] * wu
        bot = sf[face, v1, u0] * (1 - wu) + sf[face, v1, u1] * wu
        out = top * (1 - wv) + bot * wv
        if stack.dtype == np.uint8:
            out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
        else:
            out = out.astype(stack.dtype)
    else:
        ui = np.clip((u * s).astype(np.int32), 0, s - 1)
        vi = np.clip((v * s).astype(np.int32), 0, s - 1)
        out = stack[face, vi, ui]

    clip_h = int(round(height * edge_cutoff_ratio))
    top_row = (height - clip_h) // 2
    return out[top_row:top_row + clip_h]
