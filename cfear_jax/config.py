"""Configuration surface of the engine.

Mirrors the three Parameters structs of the reference
(`radar_driver.h:35-84`, `odometrykeyframefuser.h:72-195`, and the solver
settings in `n_scan_normal.h:53-81`) as one frozen dataclass tree, so a config
can be used as a static (hashable) argument to jitted functions.

Canonical presets (paper Tab. I, encoded in the reference's
`launch/oxford_demo:33-76`): CFEAR-1, CFEAR-2, CFEAR-3, CFEAR-3-s50, plus
dataset-specific radar geometry (`launch/oxford/oxford_odom.launch:11-16`,
`launch/Mulran/mulran_odom.launch:11-14`).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class RadarConfig:
    """Sensor geometry and ingest parameters (reference `radar_driver.h:40-48`)."""

    n_azimuths: int = 400
    n_bins: int = 3768
    range_res: float = 0.0438
    ccw: bool = False                # radar spins counter-clockwise (MulRan true)
    sensor_period: float = 0.25     # 4 Hz (`odometrykeyframefuser.h:213`)
    min_distance: float = 2.5
    max_distance: float = 200.0
    dataset: str = "oxford"

    @property
    def max_usable_range(self) -> float:
        """Largest range a return can have, bounded by the image extent."""
        return min(self.max_distance, (self.n_bins + 0.5) * self.range_res)


@dataclass(frozen=True)
class FilterConfig:
    """Polar-image return filtering (reference `radar_filters.h`, `cfar.h`)."""

    method: str = "kstrong"          # "kstrong" | "cacfar"
    k_strongest: int = 12
    z_min: int = 60
    # adaptive noise-floor threshold (0 = off, the reference's fixed-z_min
    # behavior): per frame, the effective threshold becomes
    # max(z_min, q_thr + 1) with q_thr the smallest uint8 value whose CDF
    # reaches ceil(q * A * R) pixels — an exact integer rule the native
    # host filter reproduces bit-for-bit. Extends the speckle envelope:
    # the fixed z_min=60 detector drowns at >= 1.67x the nominal noise
    # floor (eval_results/sim_sensitivity.csv beyond_envelope rows), while
    # q=0.98 rides the floor (and leaves nominal worlds untouched: the
    # 0.98-quantile of an exp(12) floor is ~47 < 60)
    z_min_quantile: float = 0.0
    nms_window: int = 3              # axial NMS half-window (`radar_filters.cpp:240`)
    # CA-CFAR (reference `cfar.h:28-42`). The reference dispatches CFAR
    # *instead of* k-strongest and passes z_min as the static threshold and a
    # hard-coded 400 m max distance (`radar_driver.cpp:52-57`).
    cfar_window: int = 40
    cfar_guard: int = 4
    false_alarm_rate: float = 0.01
    # static intensity gate; < 0 means "use z_min" (the reference wiring)
    cfar_static_threshold: float = -1.0
    cfar_max_distance: float = 400.0
    # fixed per-azimuth candidate budget on the CFAR path (the reference
    # emits a variable-length cloud; here detections become a fixed (A, Kc)
    # masked set — overflow beyond Kc drops the weakest detections)
    cfar_max_per_azimuth: int = 50

    @property
    def static_threshold(self) -> float:
        return self.z_min if self.cfar_static_threshold < 0 \
            else self.cfar_static_threshold


@dataclass(frozen=True)
class FeatureConfig:
    """Oriented-surface-point extraction (reference `pointnormal.{h,cpp}`)."""

    res: float = 3.5                 # grid/search radius r (`odometrykeyframefuser.h:97`)
    downsample_factor: float = 1.0   # voxel leaf = res/downsample_factor (`pointnormal.cpp:279`)
    weight_intensity: bool = True
    intensity_floor: float = 60.0    # w = max(I - 60, 0) (`pointnormal.cpp:15`)
    min_samples: int = 6             # >=6 points per cell (`pointnormal.cpp:291`)
    cond_max: float = 10000.0        # validity gates (`pointnormal.cpp:53-56`)
    det_min: float = 1e-5
    max_cells: int = 2048            # fixed-size compacted cell budget per scan
    use_raw_pointcloud: bool = False # ablation: identity cell per point (`pointnormal.h:62`)
    max_cells_raw: int = 4096        # cell budget in raw-pointcloud mode
    # optional input compaction: gather the valid points into a fixed budget
    # of P rows before the feature scatters (the (A, k) candidate array is
    # mostly-invalid slots). 0 = off. Results are IDENTICAL as long as the
    # valid count stays under the budget; on overflow the weakest points are
    # dropped.
    point_budget: int = 0
    # order kept cells by Morton code of their voxel index (valid cells
    # first). The cell map is a SET — ordering changes no semantics (only
    # exact argmin ties between equidistant targets, measure-zero) — but a
    # spatially-coherent order makes contiguous cell tiles compact blobs,
    # which the block-sparse association kernel's bounding-box tile
    # skipping needs to be effective.
    spatial_sort: bool = False


@dataclass(frozen=True)
class RegistrationConfig:
    """N-scan registration solver (reference `n_scan_normal.{h,cpp}`, `registration.h`)."""

    cost: str = "P2L"                # "P2P" | "P2L" | "P2D" (`registration.h:55`)
    loss: str = "Huber"              # None|Huber|Cauchy|SoftLOne|Tukey|Combined
    loss_limit: float = 0.1
    weight_opt: str = "Combined"     # Uniform|Sim_N|Sim_direction|Sim_scale|Combined
    assoc_radius: float = 2.0        # kd 1-NN gate (`registration.h:122`); 2x on 1st itr
    # association backend: "dense" = M x M distance matrix + argmin in XLA;
    # "sparse" = block-sparse Pallas kernel (ops/pallas_assoc.py; skips
    # target tiles beyond the radius, effective with feature.spatial_sort);
    # "grid" = bucketed 3x3 lookup; "auto" = the platform policy of
    # registration.resolve_assoc_method. All give identical accepted
    # associations.
    assoc_method: str = "auto"
    bucket_capacity: int = 12        # max cells per association bucket
    angle_outlier_deg: float = 30.0  # normal gate cos(pi/6) (`n_scan_normal.cpp:219`)
    max_itr_association: int = 8     # outer loop (`n_scan_normal.h:75`)
    # keyframe-axis gating for large submaps (CFEAR-3-s50): register against
    # only the K keyframes NEAREST (by origin distance) to the guess pose.
    # Association/LM cost is linear in the keyframe axis but only keyframes
    # whose cells lie within the association radius of source cells can
    # contribute — beyond ~the scan overlap they produce zero associations
    # while still paying full (M x M) distance work. 0 = use all keyframes
    # (the reference enumeration, `n_scan_normal.cpp:359-367`).
    max_active_keyframes: int = 0
    min_itr: int = 3
    max_itr_solver: int = 20         # inner LM (`n_scan_normal.cpp:9`)
    score_tolerance: float = 1e-5    # (`n_scan_normal.h:74`)
    # Ceres' default ftol is 1e-6 with f64; at f32 that is below the noise
    # floor of the cost reduction — 1e-4 converges identically (verified on
    # synthetic drift) while stopping the LM loop several iterations earlier
    function_tolerance: float = 1e-4
    cov_scale: float = 1.0           # P2D covariance scale (`n_scan_normal.h:72`)
    regularization: float = 0.01     # P2D regularization (`n_scan_normal.h:73`)
    soft_constraint: bool = False
    covariance_scaler: float = 30.0  # Censi-style scaling (`n_scan_normal.cpp:418`)
    disable_registration: bool = False
    # --- divergence-as-failure gates -------------------------------------
    # The reference treats solver failure as a first-class outcome
    # (`odometrykeyframefuser.cpp:190-199`), but its only failure signal is
    # Ceres refusing to solve. A solver that silently follows the guess
    # (e.g. Tukey with a tiny loss limit zeroing every residual) "succeeds"
    # with near-zero cost while the associations collapse — these gates turn
    # that divergence into a counted failure (-> guess fallback upstream):
    # fraction of possible (valid keyframe x valid source cell) pairs that
    # survived association; healthy CFEAR-3 runs sit at 0.3-0.7, collapsed
    # solves under 0.01. 0 disables.
    min_assoc_fraction: float = 0.02
    # absolute score (final_cost / residual scalars) ceiling; inf disables
    max_score: float = math.inf
    # time-continuous registration (`RegisterTimeContinuous`,
    # `n_scan_normal.cpp:67-80`): pre-warp each source cell by the scaled
    # frame velocity at its relative scan time before the solve. The
    # reference keeps it flag-gated off ("doesn't improve results",
    # `n_scan_normal.cpp:227`); same default here. A/B drift artifact:
    # eval_results/TIME_CONTINUOUS_AB.txt
    time_continuous: bool = False
    # unroll the LM and outer association loops into straight-line masked
    # code: identical results, no loop sync — but always pays the maximum
    # iteration count (kept for ablation)
    unroll_solver: bool = False


@dataclass(frozen=True)
class OdometryConfig:
    """Keyframe fuser orchestration (reference `odometrykeyframefuser.h:72-195`)."""

    submap_scan_size: int = 4
    keyframe_min_dist: float = 1.5
    keyframe_min_rot_deg: float = 5.0
    use_keyframe: bool = True
    use_guess: bool = True
    compensate: bool = True
    vel_limit: float = 200.0         # sanity gates (`odometrykeyframefuser.cpp:76-94`)
    acc_limit: float = 200.0
    # covariance by cost sampling (`odometrykeyframefuser.cpp:261-380`)
    estimate_cov_by_sampling: bool = False
    cov_sampling_xy_range: float = 0.4
    cov_sampling_yaw_range: float = 0.0043
    cov_sampling_samples_per_axis: int = 3
    cov_sampling_covariance_scaler: float = 4.0
    store_graph: bool = True
    # --- odometry health signal (reverse-registration consistency) -------
    # Every K frames, re-register the LAST KEYFRAME's cells against the
    # current scan placed at its estimated pose (the reverse problem) and
    # compare the recovered keyframe pose with the stored one. A healthy
    # solve is forward/backward-consistent to ~cm; a degraded-but-
    # "successful" regime (high-speed motion distortion biasing the
    # associations — the documented 12 m/s extent-1000 breaking regime
    # drifts 8.5% with ZERO divergence-gate failures) shows a systematic
    # forward/backward discrepancy that this catches. Runs the service
    # node's IsConsistent idea (`registration_srv_node.cpp:131-142`)
    # against a reverse solve instead of the guess. 0 = off (no cost);
    # K>0 pays ~1/K extra registrations on the single-sequence path
    # (under vmap the reverse solve cannot be skipped on off-frames).
    health_check_every: int = 0
    health_max_dist: float = 0.3
    health_max_rot_deg: float = 1.5


@dataclass(frozen=True)
class CFEARConfig:
    """Top-level configuration tree."""

    radar: RadarConfig = RadarConfig()
    filter: FilterConfig = FilterConfig()
    feature: FeatureConfig = FeatureConfig()
    registration: RegistrationConfig = RegistrationConfig()
    odometry: OdometryConfig = OdometryConfig()
    name: str = "CFEAR-3"

    @property
    def max_points(self) -> int:
        """Fixed point budget per frame: one candidate slot per azimuth
        (k-strongest or CFAR per-azimuth budget, depending on the method)."""
        per_az = self.filter.cfar_max_per_azimuth \
            if self.filter.method == "cacfar" else self.filter.k_strongest
        return self.radar.n_azimuths * per_az

    @property
    def grid_dim(self) -> int:
        """Dense feature-grid dimension covering [-extent, extent]^2."""
        half = int(math.ceil(self.radar.max_usable_range / self.feature.res)) + 2
        return 2 * half

    @property
    def grid_cells(self) -> int:
        return self.grid_dim * self.grid_dim

    def replace(self, **kw) -> "CFEARConfig":
        return dataclasses.replace(self, **kw)

    # -- file round-trip (the reference's 3-layer param plumbing collapses
    # to one dataclass tree + CLI + YAML/JSON files; SURVEY.md §5) ---------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CFEARConfig":
        return cls(
            radar=RadarConfig(**d.get("radar", {})),
            filter=FilterConfig(**d.get("filter", {})),
            feature=FeatureConfig(**d.get("feature", {})),
            registration=RegistrationConfig(**d.get("registration", {})),
            odometry=OdometryConfig(**d.get("odometry", {})),
            name=d.get("name", "custom"),
        )

    def save(self, path: str) -> None:
        import json
        with open(path, "w") as f:
            if path.endswith((".yaml", ".yml")):
                import yaml
                yaml.safe_dump(self.to_dict(), f, sort_keys=False)
            else:
                json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "CFEARConfig":
        import json
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                import yaml
                d = yaml.safe_load(f)
            else:
                d = json.load(f)
        return cls.from_dict(d)


def _dataset_radar(dataset: str) -> RadarConfig:
    """Radar geometry per dataset (reference launch files)."""
    if dataset == "oxford":
        return RadarConfig(range_res=0.0438, ccw=False, min_distance=2.5,
                           n_bins=3768, dataset="oxford")
    if dataset == "mulran":
        return RadarConfig(range_res=0.059523809523809, ccw=True, min_distance=2.5,
                           n_bins=3360, dataset="mulran")
    if dataset == "kvarntorp":
        return RadarConfig(range_res=0.175238, ccw=True, min_distance=4.0,
                           n_bins=832, dataset="kvarntorp")
    if dataset == "volvo":
        return RadarConfig(range_res=0.175238, ccw=True, min_distance=2.5,
                           n_bins=832, dataset="volvo")
    if dataset == "synthetic":
        # small synthetic sensor used in tests/benchmarks
        return RadarConfig(n_azimuths=400, n_bins=1024, range_res=0.175,
                           ccw=False, min_distance=2.5, dataset="synthetic")
    raise ValueError(f"unknown dataset '{dataset}'")


def preset(name: str = "CFEAR-3", dataset: str = "oxford") -> CFEARConfig:
    """Canonical parameter presets (paper Tab. I / `launch/oxford_demo:33-76`)."""
    radar = _dataset_radar(dataset)
    if name == "CFEAR-1":
        return CFEARConfig(
            radar=radar,
            filter=FilterConfig(k_strongest=12, z_min=70),
            feature=FeatureConfig(res=3.5, weight_intensity=True),
            registration=RegistrationConfig(cost="P2L", loss="Huber", loss_limit=0.1,
                                            weight_opt="Combined"),
            odometry=OdometryConfig(submap_scan_size=1),
            name=name,
        )
    if name == "CFEAR-2":
        return CFEARConfig(
            radar=radar,
            filter=FilterConfig(k_strongest=15, z_min=70),
            feature=FeatureConfig(res=3.0, weight_intensity=True),
            registration=RegistrationConfig(cost="P2L", loss="Huber", loss_limit=0.1,
                                            weight_opt="Combined"),
            odometry=OdometryConfig(submap_scan_size=3),
            name=name,
        )
    if name == "CFEAR-3":
        return CFEARConfig(
            radar=radar,
            filter=FilterConfig(k_strongest=40, z_min=60),
            feature=FeatureConfig(res=3.0, weight_intensity=True, max_cells=3072),
            registration=RegistrationConfig(cost="P2P", loss="Huber", loss_limit=0.1,
                                            weight_opt="Combined"),
            odometry=OdometryConfig(submap_scan_size=4),
            name=name,
        )
    if name == "CFEAR-3-s50":
        return CFEARConfig(
            radar=radar,
            filter=FilterConfig(k_strongest=40, z_min=60),
            # spatial_sort: Morton-ordered cells so the large-submap
            # association can run the block-sparse kernel (set semantics
            # unchanged; see FeatureConfig.spatial_sort)
            feature=FeatureConfig(res=3.0, weight_intensity=True,
                                  max_cells=3072, spatial_sort=True),
            registration=RegistrationConfig(cost="P2P", loss="Cauchy", loss_limit=0.1,
                                            weight_opt="Combined"),
            odometry=OdometryConfig(submap_scan_size=50),
            name=name,
        )
    raise ValueError(f"unknown preset '{name}'")
