"""Phase-artifact cache.

The reference checkpoints every expensive phase as a .pt file keyed by
model + hyperparameters (ref act_aware_utils.py:10,50, sensitivity.py:13,
datautils.py:108) — cache files are effectively a published interface
(README.md:110-114 distributes a sensitivity cache). We keep the same
two-tier design with content-hash keys from ASVDConfig and portable
formats: npz for array dicts, json for nested float dicts.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


class ArtifactCache:
    def __init__(self, cache_dir: str = "cache", enabled: bool = True):
        self.dir = cache_dir
        self.enabled = enabled
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, kind: str, key: str, ext: str) -> str:
        return os.path.join(self.dir, f"{kind}_{key}.{ext}")

    # ---- array dicts (calibration stats, fisher) ----

    def save_arrays(self, kind: str, key: str, arrays: dict) -> str:
        path = self._path(kind, key, "npz")
        np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
        return path

    def load_arrays(self, kind: str, key: str) -> Optional[dict]:
        path = self._path(kind, key, "npz")
        if not (self.enabled and os.path.exists(path)):
            return None
        z = np.load(path)
        return {k: z[k] for k in z.files}

    # ---- nested json (sensitivity dicts {layer: {ratio: ppl}}) ----

    def save_json(self, kind: str, key: str, obj) -> str:
        path = self._path(kind, key, "json")
        with open(path, "w") as f:
            json.dump(obj, f)
        return path

    def load_json(self, kind: str, key: str):
        path = self._path(kind, key, "json")
        if not (self.enabled and os.path.exists(path)):
            return None
        with open(path) as f:
            return json.load(f)

    def load_sensitivity(self, key: str) -> Optional[dict]:
        raw = self.load_json("sensitivity", key)
        if raw is None:
            return None
        # json stringifies the ratio keys; restore floats
        return {name: {float(r): p for r, p in d.items()}
                for name, d in raw.items()}
