"""The work of one forward, counted from a configuration's shapes: every
conv site and every GroupNorm with its operations and bytes, the precision
it runs at, and the least time the H100 could take for it.

Counting rules (the yardstick; no kernel name decides anything):

- a conv site's operations are 2 x output voxels x taps x Cin x Cout; a
  3x3x3 site has 27 taps, a 1x1x1 site 1; an up-sampling site convolves
  the nearest-upsampled input, so it counts its output grid at 27 taps,
  except in int8, where the configuration quantizes the four phase kernels
  of the low-resolution grid (12 taps an output voxel): that is its math;
- its bytes read the site's input once (bf16 also for an int8 site, whose
  quantize is part of the site), write its output once, and read its
  weight once in the precision it runs at (int8 1 byte, bf16 2, f32 4);
- a GroupNorm (with FiLM and SiLU) reads x once and writes y once;
- the bound is the larger of operations / peak and bytes / bandwidth, at
  the site's precision.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from . import peaks
from reference.quant import excluded

DTYPE_BYTES = {"bf16": 2, "int8": 1, "f32": 4}


@dataclasses.dataclass(frozen=True)
class Site:
    name: str          # flax path, as the scales files key it
    taps: int          # 27 or 1; 12 for an int8 up site
    cin: int
    cout: int
    in_voxels: int     # per sample
    out_voxels: int    # per sample
    precision: str     # bf16, int8 or f32

    @property
    def ops(self) -> float:
        return 2.0 * self.out_voxels * self.taps * self.cin * self.cout

    @property
    def bytes(self) -> float:
        act = 4 if self.precision == "f32" else 2
        wbytes = DTYPE_BYTES[self.precision]
        k = 1 if self.taps == 1 else 27
        return (self.in_voxels * self.cin * act
                + self.out_voxels * self.cout * act
                + self.cout * self.cin * k * wbytes + 4 * self.cout)

    def bound_s(self) -> float:
        return max(self.ops / peaks.PEAK_OPS[self.precision],
                   self.bytes / peaks.HBM_BYTES)


@dataclasses.dataclass(frozen=True)
class Norm:
    channels: int
    voxels: int        # per sample
    precision: str     # bf16 or f32

    @property
    def bytes(self) -> float:
        return 2.0 * self.voxels * self.channels * DTYPE_BYTES[self.precision]

    def bound_s(self) -> float:
        return self.bytes / peaks.HBM_BYTES


def _site_precision(site: str, int8: Optional[dict], base: str) -> str:
    if int8 is not None and not excluded("unet/" + site, int8["exclude"]):
        return "int8"
    return base


def forward_work(cfg: dict, patch: Sequence[int]):
    """(sites, norms) of one batch-1 forward at ``patch`` (D, H, W), from
    the layout of the reference the configuration names: the sites that
    its ``int8`` entry quantizes run int8."""
    from . import manifest

    raw_sites, raw_norms = manifest.reference(cfg).layout(cfg, tuple(patch))
    sites: List[Site] = []
    for s in raw_sites:
        prec = _site_precision(s["site"], cfg.get("int8"), s["precision"])
        taps = 1 if s["k"] == 1 else 27
        if prec == "int8" and s["up"] and s["k"] == 3:
            taps = 12
        sites.append(Site(s["site"], taps, s["cin"], s["cout"],
                          s["in_voxels"], s["out_voxels"], prec))
    return sites, [Norm(c, v, p) for c, v, p in raw_norms]


def per_forward(cfg: dict, patch: Sequence[int], batch: int) -> dict:
    """Totals of one forward at ``batch``: conv operations, the conv sites'
    summed bound, the same at each site's peak alone (operations only),
    and the GroupNorms' byte bound; seconds."""
    sites, norms = forward_work(cfg, patch)
    return {
        "sites": len(sites),
        "norms": len(norms),
        "conv_ops": batch * sum(s.ops for s in sites),
        "conv_bound_s": batch * sum(s.bound_s() for s in sites),
        "conv_peak_s": batch * sum(s.ops / peaks.PEAK_OPS[s.precision]
                                   for s in sites),
        "gn_bound_s": batch * sum(n.bound_s() for n in norms),
    }
