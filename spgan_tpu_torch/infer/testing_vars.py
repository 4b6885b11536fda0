"""TestingVars: the bag of inference-time state (meta image, latent fields,
coordinate field, per-layer noises) with save/load and editing
(counterpart of spgan_tpu/infer/testing_vars.py; numpy only).

``save``/``load`` use the JAX package's ``.npz`` keys (global_latent,
local_latent, meta_coords, meta_img, styles, noise_{i}), so a file written
by either package loads in the other.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from spgan_tpu_torch.infer.stitcher import LatticePlan


@dataclass
class TestingVars:
    __test__ = False  # not a pytest class

    meta_img: Optional[np.ndarray]         # (B, H, W, 3)
    global_latent: np.ndarray              # (B, 2, D)
    local_latent: np.ndarray               # (B, zh, zw, C)
    meta_coords: np.ndarray                # (zh, zw, 3)
    noises: List[np.ndarray]               # per layer (B, nh, nw, 1)
    styles: Optional[np.ndarray] = None    # optional W+ styles

    def save(self, path: str) -> None:
        payload = {"global_latent": self.global_latent,
                   "local_latent": self.local_latent,
                   "meta_coords": self.meta_coords}
        if self.meta_img is not None:
            payload["meta_img"] = self.meta_img
        if self.styles is not None:
            payload["styles"] = self.styles
        for i, n in enumerate(self.noises):
            payload[f"noise_{i}"] = n
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str) -> "TestingVars":
        with np.load(path) as d:
            noises = []
            while f"noise_{len(noises)}" in d:
                noises.append(d[f"noise_{len(noises)}"])
            return cls(
                meta_img=d["meta_img"] if "meta_img" in d else None,
                global_latent=d["global_latent"],
                local_latent=d["local_latent"],
                meta_coords=d["meta_coords"],
                noises=noises,
                styles=d["styles"] if "styles" in d else None)

    # ---- editing -------------------------------------------------------
    def update_global_latent(self, new_latent: np.ndarray) -> None:
        self.global_latent = np.asarray(new_latent)

    def update_local_latent(self, new_latent: np.ndarray,
                            selection_map: Optional[np.ndarray] = None
                            ) -> None:
        """selection_map: (zh, zw) {0,1}: paste new values where selected."""
        new_latent = np.asarray(new_latent)
        if selection_map is None:
            self.local_latent = new_latent
        else:
            m = selection_map[None, :, :, None] > 0
            self.local_latent = np.where(m, new_latent, self.local_latent)

    def update_noises(self, new_noises: List[np.ndarray],
                      selection_maps: Optional[List[np.ndarray]] = None
                      ) -> None:
        if selection_maps is None:
            self.noises = [np.asarray(n) for n in new_noises]
            return
        self.noises = [np.where(m[None, :, :, None] > 0, new, cur)
                       for cur, new, m in zip(self.noises, new_noises,
                                              selection_maps)]

    # ---- inversion-record injection -----------------------------------
    def replace_by_records(self, plan: LatticePlan, records: List[Dict],
                           placements: List[float],
                           batch_index: int = 0) -> None:
        """Paste inverted variables into the fields.

        record: {"local_latent": (zh_p, zw_p, C), "noises": [(h,w,1)...],
                 optional "global_latent": (2, D)}
        placement: horizontal centre of the pasted patch as a fraction of
        the panorama width (wrap-aware)."""
        for rec, place in zip(records, placements):
            if "global_latent" in rec:
                self.global_latent[batch_index] = rec["global_latent"]
            zl = np.asarray(rec["local_latent"])
            zh, zw = zl.shape[0], zl.shape[1]
            zc = int(round(place * plan.z_field_w)) % plan.z_field_w
            z0 = (zc - zw // 2) % plan.z_field_w
            zr = (self.local_latent.shape[1] - zh) // 2
            for dx in range(zw):
                col = (z0 + dx) % plan.z_field_w
                self.local_latent[batch_index, zr:zr + zh, col] = zl[:, dx]
            for li, n in enumerate(rec.get("noises", [])):
                n = np.asarray(n)
                field = self.noises[li]
                nw_field = field.shape[2]
                nc = int(round(place * nw_field)) % nw_field
                c0 = (nc - n.shape[1] // 2) % nw_field
                r0 = (field.shape[1] - n.shape[0]) // 2
                for dx in range(n.shape[1]):
                    col = (c0 + dx) % nw_field
                    field[batch_index, r0:r0 + n.shape[0], col] = n[:, dx]


def load_record(path: str) -> Dict:
    """An inversion record file as a replace_by_records record.  Reads the
    layout InversionResult.save writes (z, noiseNN with a batch axis of 1,
    optional gz) and the one the JAX package's REPL expects (local_latent,
    noise_{i}, optional global_latent)."""
    with np.load(path) as d:
        if "z" in d.files:
            rec = {"local_latent": d["z"][0],
                   "noises": [d[k][0] for k in sorted(d.files)
                              if k.startswith("noise")]}
            if "gz" in d.files:
                rec["global_latent"] = d["gz"]
            return rec
        noises = []
        while f"noise_{len(noises)}" in d.files:
            noises.append(d[f"noise_{len(noises)}"])
        rec = {"local_latent": d["local_latent"], "noises": noises}
        if "global_latent" in d.files:
            rec["global_latent"] = d["global_latent"]
        return rec
