"""Frozen config dataclasses — the framework's single flag system.

The reference scatters knobs across compile-time constants, static mutable
globals and live ImGui state (SURVEY.md §5.6; reference
pg/RenderParams.h:5-18, pg/ReSTIRIntegrator.cpp:13-33, pg/camera.cpp:86-133).
Here everything is one hashable frozen-dataclass tree: it is both the user
config surface (TOML/JSON + CLI overrides in tpu_restir.cli) and the static
argument that selects the jit-compiled variant of the render pipeline.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


class SpatialMis:
    """Spatial-reuse MIS/debiasing scheme names.

    Mirrors the 5-way SpatialWeightCalculation enum of the reference
    (pg/ReSTIRIntegrator.h:19-25).
    """

    CONSTANT = "constant"                       # 1/M weights (biased)
    CONSTANT_DEBIAS_Z = "constant_debias_z"     # 1/M + 1/|Z| correction
    CONSTANT_DEBIAS_CONTRIB = "constant_debias_contrib"  # 1/M + contrib weight
    BALANCE_HEURISTIC = "balance"               # generalized balance, O(M^2)
    PAIRWISE = "pairwise"                       # pairwise MIS, O(M)

    ALL = (CONSTANT, CONSTANT_DEBIAS_Z, CONSTANT_DEBIAS_CONTRIB,
           BALANCE_HEURISTIC, PAIRWISE)


class PixelSamplerKind:
    """Anti-aliasing pixel sampler strategies (reference pg/PixelSampler.h:6-67)."""

    CENTER = "center"          # always (0,0) offset — pixel corner, no AA
    RANDOM = "random"          # uniform jitter in [0,1)^2
    STRATIFIED = "stratified"  # jittered grid: random cell + in-cell jitter


class DirectStrategy:
    """NEE direct-lighting strategies (reference pg/NEEPathIntegrator.h:7-29)."""

    AREA = "area"    # light-surface-area CDF sampling
    BRDF = "brdf"    # BRDF sampling, count only emissive hits
    MIS = "mis"      # both, power-heuristic weighted
    RIS = "ris"      # per-pixel resampled importance sampling


@dataclass(frozen=True)
class RenderParams:
    """Shared render knobs (reference pg/RenderParams.h:5-18 defaults)."""

    max_bounce_count: int = 5
    bg_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    use_skybox: bool = True
    tonemap: bool = True
    denoise: bool = False
    # "svgf" (variance-guided a-trous, OIDN-parity default) | "bilateral"
    denoiser: str = "svgf"
    gamma_correct: bool = True
    tnear_offset: float = 0.01
    tfar_offset: float = 0.001
    normal_offset: float = 0.001
    russian_roulette: bool = True
    rr_start_bounce: int = 5  # RR kicks in for bounceCount > 5 (pg/NaivePathIntegrator.cpp:31)
    # display-buffer debug pixel painted magenta, (x, y) or None
    # (reference pg/simpleguidx11.cpp:186, 289-290)
    debug_pixel: Optional[Tuple[int, int]] = None


@dataclass(frozen=True)
class RestirParams:
    """ReSTIR pipeline knobs (defaults per pg/ReSTIRIntegrator.cpp:13-33)."""

    m_area: int = 1
    m_brdf: int = 1
    confidence_cap: float = 20.0
    do_visibility_pass: bool = False
    do_temporal_reuse: bool = False
    do_spatial_reuse: bool = False
    spatial_pass_count: int = 1
    spatial_neighbor_count: int = 5
    spatial_reuse_radius: float = 30.0
    spatial_mis: str = SpatialMis.CONSTANT
    reject_dissimilar_neighbors: bool = False
    min_normal_similarity: float = 0.85
    max_depth_difference: float = 0.2
    # paint temporal-rejection reasons into the frame (reference
    # debugReprojection, pg/ReSTIRIntegrator.cpp:647-689)
    debug_reprojection: bool = False


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera (reference pg/camera.h:18-83; up is +z)."""

    width: int = 640
    height: int = 480
    fov_y_deg: float = 45.0
    view_from: Tuple[float, float, float] = (0.0, -3.5, 1.0)
    view_at: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    pixel_sampler: str = PixelSamplerKind.CENTER
    jitter_grid: Tuple[int, int] = (5, 5)
    aperture: float = 0.0  # present-but-disabled in the reference (pg/camera.cpp:30-40)


@dataclass(frozen=True)
class IntersectorConfig:
    """Ray-scene intersection backend selection and tiling knobs."""

    # "brute" | "woop_mxu" | "cluster" | "fcluster" | "bvh" | "fused"
    # | "auto"
    backend: str = "auto"
    ray_chunk: int = 1 << 18   # rays per lax.map chunk
    tri_block: int = 2048      # triangles per scan block
    # auto: the fused Triton kernel up to this many triangles (GPU only).
    # On an H100 it won at 1,034 triangles; its cost grows linearly with
    # the triangle count, which puts the crossover with the culling
    # backends near 2,000 (PERF.md).
    fused_max_tris: int = 2048
    packet_size: int = 256     # fcluster: rays per culling packet
    shortlist_k: int = 8       # fcluster: clusters intersected per round
    # fcluster: sort rays by (origin cell, direction) before packeting.
    # Off by default (primary/shadow streams are already coherent);
    # integrators turn it on for incoherent bounce-ray queries.
    bin_rays: bool = False


@dataclass(frozen=True)
class RenderConfig:
    """Top-level config: one frozen tree = one compiled pipeline variant."""

    camera: CameraConfig = CameraConfig()
    params: RenderParams = RenderParams()
    restir: RestirParams = RestirParams()
    intersector: IntersectorConfig = IntersectorConfig()

    integrator: str = "restir"  # "naive" | "nee" | "restir"
    direct_strategy: str = DirectStrategy.MIS  # for the NEE integrator
    ris_candidates: int = 8  # for DirectStrategy.RIS
    nee_calc_di: bool = True
    nee_calc_gi: bool = True
    # debug view: render MIS weights as R/G colors instead of radiance
    # (reference showWeights, pg/DirectMISIntegrator.cpp:80-81,134-135)
    show_weights: bool = False

    seed: int = 123
    accumulate: bool = True
    max_acc_count: int = 100000
    # run the ReSTIR pipeline pass-by-pass, filling Renderer.timers (the
    # reference's per-pass ms stats, pg/raytracer.cpp:56-75;
    # pg/simpleguidx11.cpp:361-486). Implemented as PREFIX timing of the
    # one true pipeline: the step is re-jitted with profile_stop_after
    # set to each stage and pass time = difference of prefix times — no
    # second copy of the pass schedule to drift, and it works sharded.
    # ~(n_passes/2)x slower than the fused step; profiling mode only.
    profile_passes: bool = False
    # internal: restir_step returns right after this stage ("gbuffer" |
    # "initial" | "visibility" | "temporal" | "spatial"); None = full
    profile_stop_after: Optional[str] = None

    # distribution: rows sharded over this many devices (1 = single chip)
    n_devices: int = 1
    mesh_axis: str = "tiles"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def replace(cfg, **kw):
    """dataclasses.replace that reads as config.replace for sub-configs."""
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Config files: TOML/JSON -> RenderConfig. Section names match the field
# names ([camera], [params], [restir], [intersector]); top-level keys set
# the RenderConfig scalars. CLI flags override file values
# (tpu_restir.cli --config).
# ---------------------------------------------------------------------------

_SECTIONS = {
    "camera": CameraConfig,
    "params": RenderParams,
    "restir": RestirParams,
    "intersector": IntersectorConfig,
}


def _build_section(cls, d: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown {cls.__name__} key {k!r}")
        if isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return cls(**kw)


def config_from_dict(d: dict) -> RenderConfig:
    """Nested dict (parsed TOML/JSON) -> RenderConfig."""
    kw = {}
    top_fields = {f.name for f in dataclasses.fields(RenderConfig)}
    for k, v in d.items():
        if k in _SECTIONS:
            kw[k] = _build_section(_SECTIONS[k], v)
        elif k in top_fields:
            kw[k] = tuple(v) if isinstance(v, list) else v
        else:
            raise KeyError(f"unknown config key {k!r}")
    return RenderConfig(**kw)


def load_config_file(path: str) -> RenderConfig:
    """Load a .toml or .json render config."""
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            return config_from_dict(tomllib.load(f))
    if path.endswith(".json"):
        import json

        with open(path) as f:
            return config_from_dict(json.load(f))
    raise ValueError(f"config file must be .toml or .json, got {path!r}")
