"""Speed-of-light accounting: FLOPs/bytes per kernel, roofline share.

The reference has no performance model at all (SURVEY.md §6: its record
is wall-clock sidecar files). Here the question per kernel is where it
sits against the device's two ceilings: float32 arithmetic (the
intersection and shading math is plain f32, outside the tensor cores)
and device-memory bandwidth for streamed buffers.

Peaks come from one table keyed by `device_kind` as JAX reports it. A
device missing from the table is an error: there is no default. All
functions are pure Python over static shapes — trace-time models, not
device counters (the device-side cross-check is the instrumented query
log in tpu_restir.render.intersect).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

# Published dense peaks per device. Source: NVIDIA H100 Tensor Core GPU
# data sheet, SXM5 part (rates at the full 700 W power limit; a card
# capped lower runs below them).
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "f32_tflops": 67.0,     # float32 outside the tensor cores
        "tf32_tflops": 495.0,   # tensor cores, TF32
        "hbm_gbps": 3350.0,     # HBM3, GB/s
    },
}

# --- per-pair-test cost model (fused Woop test, kernels/ray_tri) ----------
# 3 affine rows (~18 FMA) + divide + compares/selects
WOOP_FLOPS_PER_PAIR = 40.0


def device_peaks(device_kind: str) -> Dict[str, float]:
    """Peak table entry for a device; KeyError for an unknown device."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no peak figures for device_kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


@dataclass
class KernelSpec:
    """One kernel invocation's static work model (f32, no tensor cores)."""

    name: str
    flops: float            # total float32 ops
    bytes_hbm: float        # device-memory bytes moved (read + write)

    def sol_time_s(self, device_kind: str) -> float:
        """Speed-of-light time: max of compute- and bandwidth-limited."""
        pk = device_peaks(device_kind)
        return max(self.flops / (pk["f32_tflops"] * 1e12),
                   self.bytes_hbm / (pk["hbm_gbps"] * 1e9))

    def bound(self, device_kind: str) -> str:
        pk = device_peaks(device_kind)
        compute = self.flops / (pk["f32_tflops"] * 1e12)
        memory = self.bytes_hbm / (pk["hbm_gbps"] * 1e9)
        return "compute" if compute >= memory else "memory"

    def report(self, device_kind: str,
               measured_s: Optional[float] = None) -> str:
        sol = self.sol_time_s(device_kind)
        line = (f"{self.name}: {self.flops / 1e9:.2f} GFLOP, "
                f"{self.bytes_hbm / 1e6:.1f} MB, "
                f"{self.bound(device_kind)}-bound, SoL {sol * 1e3:.3f} ms")
        if measured_s is not None and measured_s > 0:
            line += (f", measured {measured_s * 1e3:.3f} ms = "
                     f"{100.0 * sol / measured_s:.1f}% of the published "
                     "peak roofline")
        return line


def fused_query_spec(name: str, n_rays: int, n_tris: int,
                     closest: bool = True) -> KernelSpec:
    """Work model for the fused small-scene kernel (kernels/ray_tri):
    every ray tests every triangle; 32 B of ray data in, 16 B (closest)
    or 4 B (any) out per ray. Any-hit's early exit makes this an upper
    bound on its work."""
    pairs = float(n_rays) * n_tris
    out_bytes = 16 if closest else 4
    return KernelSpec(name=name, flops=pairs * WOOP_FLOPS_PER_PAIR,
                      bytes_hbm=n_rays * (32.0 + out_bytes)
                      + n_tris * 48.0)


def summarize_query_log(log: List[Dict]) -> Dict:
    """Aggregate tpu_restir.render.intersect.QUERY_LOG entries (appended
    at trace time) into per-kind ray/query totals."""
    out: Dict[str, Dict[str, float]] = {}
    for e in log:
        k = out.setdefault(e["kind"], {"queries": 0, "rays": 0})
        k["queries"] += 1
        k["rays"] += e["rays"]
    out["total_rays"] = sum(v["rays"] for v in out.values()
                            if isinstance(v, dict))
    return out
