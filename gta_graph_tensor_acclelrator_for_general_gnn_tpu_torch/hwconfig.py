"""Hardware and tuning configuration of the port (the reference's
``hardware_info.yaml``; counterpart of the JAX package's ``hwconfig.py``).

A JSON file (path via ``$GTA_HW_CONFIG`` or :func:`load_hw_config`)
overrides the built-in defaults, which are those of one NVIDIA H100
(``configs/h100.json`` in this package is the template):

    smem_budget_bytes:  dynamic shared memory one CUDA block may use, the
                        bound of ``schedule.tile_is_feasible`` (H100:
                        232,448 bytes)
    tile_palette:       list of [block_rows, block_cols, tile_edges, path
                        (, "d<dense_block>")] entries swept by the tuner
    hbm_gbps:           device-memory rate used by analytic cost reports
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Dict, Optional, Tuple

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "h100.json")


@dataclasses.dataclass(frozen=True)
class HwConfig:
    smem_budget_bytes: int = 232_448
    tile_palette: Optional[Tuple[tuple, ...]] = None   # None = built-in
    hbm_gbps: float = 3350.0

    def palette(self):
        """The tuner's tile palette: the config's, else the built-in
        ``tune.search.TILE_PALETTE``."""
        from .compiler import schedule as S
        from .tune.search import TILE_PALETTE
        if self.tile_palette is None:
            return TILE_PALETTE
        out = []
        for entry in self.tile_palette:
            br, bc, te = int(entry[0]), int(entry[1]), int(entry[2])
            path = entry[3] if len(entry) > 3 else S.PATH_ONEHOT
            dense = int(str(entry[4]).lstrip("d")) if len(entry) > 4 else 0
            out.append(S.TileConfig(br, bc, te, path, dense_block=dense))
        return tuple(out)

    def max_tile(self, feat_width: int, dtype_bytes: int = 4):
        """Largest square ``onehot`` tile (doubling from 128) feasible at
        ``feat_width`` under the shared-memory budget, or None."""
        from .compiler import schedule as S
        best = None
        n = 128
        while True:
            tc = S.TileConfig(n, n, min(n, 1024))
            if not S.tile_is_feasible(tc, feat_width, self.smem_budget_bytes,
                                      dtype_bytes=dtype_bytes):
                break
            best = tc
            n *= 2
        return best

    def derived_palette(self, feat_width: int, dtype_bytes: int = 4):
        """The palette derived from the maximal tile: scales {1, .5, .25}
        of the maximal square plus rectangular variants (the reference's
        tile-scale sweep), plus the static palette's non-``onehot``
        entries.  Falls back to the static palette when even 128² does not
        fit."""
        from .compiler import schedule as S
        mx = self.max_tile(feat_width, dtype_bytes)
        if mx is None:
            return self.palette()
        seen, out = set(), []

        def add(br, bc, te, path=S.PATH_ONEHOT):
            br, bc, te = max(br, 128), max(bc, 128), max(te, 128)
            tc = S.TileConfig(br, bc, te, path)
            if tc.key() not in seen and S.tile_is_feasible(
                    tc, feat_width, self.smem_budget_bytes,
                    dtype_bytes=dtype_bytes):
                seen.add(tc.key())
                out.append(tc)

        m = mx.block_rows
        for scale in (1.0, 0.5, 0.25):
            n = max(int(m * scale) // 128 * 128, 128)
            add(n, n, min(n, 1024))
            add(n, n, min(n // 2, 1024))
        add(m // 2, m, min(m, 1024))        # wide-C (gather-heavy shapes)
        add(m, m // 2, min(m, 1024))        # wide-R
        for tc in self.palette():
            if tc.path != S.PATH_ONEHOT:
                out.append(tc)
        return tuple(out)


def load_hw_config(path: Optional[str] = None) -> HwConfig:
    """The config at ``path`` or ``$GTA_HW_CONFIG``; with neither, the
    built-in H100 defaults.  Parsed files are cached per path: feasibility
    checks read the config per tile per candidate."""
    path = path or os.environ.get("GTA_HW_CONFIG")
    if not path:
        return HwConfig()
    return _load_hw_config_cached(path)


@functools.lru_cache(maxsize=16)
def _load_hw_config_cached(path: str) -> HwConfig:
    with open(path) as f:
        data = json.load(f)
    kw: Dict = {}
    if "smem_budget_bytes" in data:
        kw["smem_budget_bytes"] = int(data["smem_budget_bytes"])
    if "tile_palette" in data:
        kw["tile_palette"] = tuple(tuple(e) for e in data["tile_palette"])
    if "hbm_gbps" in data:
        kw["hbm_gbps"] = float(data["hbm_gbps"])
    return HwConfig(**kw)
