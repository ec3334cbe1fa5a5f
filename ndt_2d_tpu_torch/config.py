"""Configuration dataclasses: the port's copy of ``ndt_2d_tpu/config.py``.

Parameter names and defaults mirror the reference `ndt_2d` ROS parameters
(reference: src/ndt_mapper.cpp:59-103, src/scan_matcher_ndt.cpp:37-44) so a
user of the reference can map their configuration 1:1.  The static sizing
knobs (padded capacities, grid extents) come from the JAX package's
static-shape compilation model; the port keeps them so one configuration
means the same session in both packages.  Fields, defaults and derived
properties equal the JAX package's (``tests/test_torch_boundary.py``); the
field comments are that package's and speak of its TPU measurements.
"""

from __future__ import annotations

import dataclasses


def _num_steps(size: float, res: float) -> int:
    """Number of iterations of ``for (v = -size; v < size; v += res)``.

    Matches the reference C++ loop trip count EXACTLY, including accumulated
    floating-point error (scan_matcher_ndt.cpp:103,117,119): e.g. the default
    linear search -0.05..0.05 @ 0.005 runs 21 iterations (the 20th
    accumulated value is 0.049999999999999996 < 0.05), so a default match
    evaluates 80 x 21 x 21 = 35 280 candidates.
    """
    v = -float(size)
    n = 0
    while v < size:
        n += 1
        v += res
        if n > 10_000_000:  # guard against res <= 0 misconfiguration
            raise ValueError(f"degenerate search lattice: size={size} res={res}")
    return n


@dataclasses.dataclass(frozen=True)
class ScanMatcherConfig:
    """Configuration of one NDT scan matcher instance.

    Mirrors the namespaced parameters declared in the reference
    (scan_matcher_ndt.cpp:37-44): ``ndt_resolution``,
    ``search_angular_resolution``, ``search_angular_size``,
    ``search_linear_resolution``, ``search_linear_size``, ``laser_max_beams``.
    """

    ndt_resolution: float = 0.25
    search_angular_resolution: float = 0.0025
    search_angular_size: float = 0.1
    search_linear_resolution: float = 0.005
    search_linear_size: float = 0.05
    laser_max_beams: int = 100

    # --- TPU static sizing (no reference analog; the reference allocates a
    # dynamically-sized dense grid per addScans call, scan_matcher_ndt.cpp:66) ---
    # NDT grid extent in cells (static for XLA).  Must cover the bounding box
    # of the scan window poses +- range_max at ndt_resolution.
    grid_cells_x: int = 192
    grid_cells_y: int = 192
    # NOTE: hand-written Pallas scoring kernels were built and measured in
    # rounds 1-3 and retired each time (BASELINE.md "Pallas vs XLA"): the
    # kernel is bound by the packed-table row gather, XLA's native gather
    # beats both the shared-gather kernel (0.21 vs 0.15 ms) and the
    # in-kernel scalar-driven gather (0.73 ms), so the XLA fast path is the
    # only scoring path.
    # Overlapping grids (Biber & Strasser 2003): score against 4 NDT grids
    # whose origins are shifted by half a cell in (x, y, xy) and average.
    # The reference deliberately simplifies to a single grid
    # (README.md:114-118), which makes the score surface discontinuous at
    # cell boundaries and biased toward cell centers; 4 grids smooth it.
    # Costs ~4x the (sub-millisecond) match time.
    overlapping_grids: bool = False
    # Newton polish of the lattice winner (matching/newton.py): > 0 chains
    # this many damped Newton iterations on the smooth NDT score surface
    # after the exhaustive search, giving sub-lattice registration (the
    # reference is quantized to search_linear/angular_resolution).  0 = off
    # (reference-parity behavior, the default).
    refine_iterations: int = 0

    @property
    def num_angles(self) -> int:
        return _num_steps(self.search_angular_size, self.search_angular_resolution)

    @property
    def num_linear(self) -> int:
        return _num_steps(self.search_linear_size, self.search_linear_resolution)

    @property
    def num_candidates(self) -> int:
        return self.num_angles * self.num_linear * self.num_linear

    @property
    def num_cells(self) -> int:
        return self.grid_cells_x * self.grid_cells_y


@dataclasses.dataclass(frozen=True)
class ParticleFilterConfig:
    """AMCL-style particle filter parameters (ndt_mapper.cpp:71-88)."""

    odom_alpha1: float = 0.2
    odom_alpha2: float = 0.2
    odom_alpha3: float = 0.2
    odom_alpha4: float = 0.2
    odom_alpha5: float = 0.2  # declared but unused by the reference sampler
    min_particles: int = 100
    max_particles: int = 500
    kld_err: float = 0.01
    kld_z: float = 2.3
    # KLD histogram bin sizes (particle_filter.cpp:44)
    kld_bin_x: float = 0.5
    kld_bin_y: float = 0.5
    kld_bin_theta: float = 0.2671
    # AMCL w_slow/w_fast recovery (Probabilistic Robotics table 8.3): when
    # the short-term average measurement likelihood w_fast drops below the
    # long-term average w_slow, a max(0, 1 - w_fast/w_slow) fraction of
    # resampled particles is replaced by uniform draws over the map's free
    # space, recovering from kidnapping/divergence.  The reference has NO
    # such recovery (README.md:123-127); 0.0 disables (AMCL's own default).
    # Typical values when enabled: slow 0.001, fast 0.1.
    recovery_alpha_slow: float = 0.0
    recovery_alpha_fast: float = 0.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Pose-graph solver parameters.

    The reference uses Ceres (SPARSE_NORMAL_CHOLESKY, 100 iterations,
    ceres_solver.cpp:39-40).  We run batched Levenberg-Marquardt on TPU with a
    dense Cholesky solve for small graphs and matrix-free preconditioned
    conjugate gradients for large ones.
    """

    max_iterations: int = 100
    # Use the dense normal-equation path while 3*N <= this; otherwise PCG.
    dense_size_limit: int = 3072
    # Robust loss applied to the constraints in solve()'s robust_mask
    # (switchable/loop-closure edges).  The reference stores the switchable
    # flag but never robustifies (ceres_solver.cpp:159-166).  "huber"
    # down-weights suspect loop closures; "geman_mcclure" (redescending)
    # effectively switches gross outliers off.  "none" = reference behavior
    # (the default, for parity).  huber_delta is the loss scale for both.
    robust_loss: str = "none"
    huber_delta: float = 1.0
    cg_max_iterations: int = 250
    cg_tolerance: float = 1e-6
    lm_lambda_init: float = 1e-6
    lm_lambda_up: float = 10.0
    lm_lambda_down: float = 0.5
    tolerance: float = 1e-9


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Top-level mapper parameters (ndt_mapper.cpp:59-103)."""

    resolution: float = 0.05                 # occupancy-grid export resolution
    minimum_travel_distance: float = 0.1
    minimum_travel_rotation: float = 1.0
    rolling_depth: int = 10
    transform_timeout: float = 0.2           # kept for API parity; no TF here
    use_barycenter: bool = True
    global_search_size: float = 0.2          # NOTE: squared-distance radius,
    # matching nanoflann radiusSearch semantics used by the reference
    # (graph.cpp:181 passes it straight through as an L2^2 radius).
    global_search_limit: int = 3
    optimization_node_limit: int = 25
    use_particle_filter: bool = False
    enable_mapping: bool = True
    occupancy_threshold: float = 0.25
    max_range: float = -1.0                  # negative => take from sensor msg

    scan_matcher_type: str = "ndt"           # plugin-style matcher registry key

    local_scan_matcher: ScanMatcherConfig = dataclasses.field(
        default_factory=ScanMatcherConfig)
    global_scan_matcher: ScanMatcherConfig = dataclasses.field(
        default_factory=ScanMatcherConfig)
    particle_filter: ParticleFilterConfig = dataclasses.field(
        default_factory=ParticleFilterConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)

    # --- TPU static capacities ---
    max_points_per_scan: int = 512           # padded laser points per keyframe
    max_scans: int = 4096                    # padded keyframe capacity
    max_constraints: int = 8192

    # Grow a matcher's static NDT grid when a session outgrows it, instead
    # of raising: the tripped matcher is rebuilt at the next 32-cell
    # multiple that fits (one amortized recompile), matching the
    # reference's dynamic per-window sizing that can never overflow
    # (scan_matcher_ndt.cpp:52-67).  False = raise with sizing advice (the
    # rounds-1..4 behavior; predictable compilation signatures).
    auto_grow_grids: bool = True

    # Cadence of the (synchronous) loop-closure pass, in accepted scans.  The
    # reference runs it on a 1 Hz background thread (ndt_mapper.cpp:573); our
    # host loop is single-threaded and deterministic instead.
    loop_closure_every: int = 5

    # Pipelined mapping: keep the pose chain device-resident and allow up to
    # this many mapping steps in flight before blocking on the oldest result
    # (matching.matcher.mapping_step_async).  0 = synchronous per-scan
    # round-trips (reference-shaped behavior, the default).  With a value
    # like 8, per-scan wall time drops from one full host<->device round
    # trip to the overlap-limited dispatch cost; results (pose, score,
    # constraint covariance) drain into the graph asynchronously and are
    # always fully drained before loop closure / optimization / map export /
    # save, so every downstream consumer sees the same graph as the
    # synchronous path.  ScanResult.pose is None for deferred scans — read
    # final poses from the graph (or call Mapper.flush()).
    max_inflight: int = 0

    # Loop-closure acceptance gate: accept when
    # score < loop_closure_gate_scale * EWMA(typical match score).
    # 1.0 = exact reference behavior (score < typical_matcher_response_,
    # ndt_mapper.cpp:645).  The EWMA tracks 10-scan rolling-window matches,
    # which systematically score better (more negative) than any 2-scan
    # candidate-region NDT can, so the parity gate is conservative; values
    # < 1.0 (e.g. 0.85) admit candidates within that fraction of typical
    # quality — pair with solver.robust_loss so a rare wrong closure is
    # switched off in the optimization instead of corrupting the map.
    loop_closure_gate_scale: float = 1.0

    # Confirm all loop-closure candidates of a scan in ONE vmapped device
    # dispatch (matching.matcher.match_scan_batch) instead of the reference's
    # per-candidate rebuild-NDT + match loop (ndt_mapper.cpp:623-663).
    # Semantically equivalent to the sequential path (tests/test_mapper_e2e
    # pins it); False = per-candidate dispatches, kept for plugin matchers
    # and as the equivalence oracle.
    batch_loop_closure: bool = True

    # Pipeline the whole loop-closure pass: dispatch every pending scan's
    # batched confirmation before draining any (host copies issued at
    # dispatch), so a pass costs one relay round-trip instead of one per
    # candidate-bearing scan.  Decision-identical to the per-scan path (an
    # acceptance restarts the pass from the corrected graph;
    # tests/test_mapper_e2e.py::TestPipelinedLoopClosure pins it).  Only
    # applies when batch_loop_closure is in effect.
    pipeline_loop_closure: bool = True

    # Radius-search position space.  "barycenter"/"pose" follow
    # use_barycenter (reference parity: one search in one space,
    # graph.cpp:167-189).  "both" = the union of the barycenter-space and
    # pose-space radius searches per query.  The reference's barycenter
    # convention has a measured blind spot: a REVERSE-DIRECTION revisit
    # places two scans at the same pose with barycenters a full
    # mean-beam-length apart in opposite facings, so neither barycenter
    # search reaches the other — every one of the simlab benchmark's
    # candidate-recall misses (37/37) attributes to exactly this
    # (lc_pr_results miss_causes "barycenter_geometry"), capping recall
    # at 0.83.  "both" closes it with one extra host-side search.
    loop_search_positions: str = "barycenter"

    # Loop-closure candidate source: "radius" = barycenter radius search
    # (Graph::findNearest parity, graph.cpp:167-189); "descriptor" =
    # appearance-based cosine correlation over rotation-invariant keyframe
    # descriptors (ndt_2d_tpu.parallel.loop_search) — drift-robust and the
    # basis of the sharded all-to-all search at district scale; "both" =
    # the deduped union of the two per query (radius proposals first), one
    # confirmation pass — radius recall when drift is small, descriptor
    # reach when it isn't.
    loop_search: str = "radius"

    # Maximum MATCHED separation for an accepted closure, in meters: after
    # confirmation, the corrected query pose must land within this distance
    # of the candidate's pose.  The match itself estimates how far apart
    # the two scans were taken; beyond ~1-1.5 m the NDT overlap (and so the
    # constraint) degrades, and such accepts are the measured bulk of the
    # false-positive class on the office benchmark.  inf = off (reference
    # parity: its gate is score-only, ndt_mapper.cpp:645).
    loop_closure_max_separation: float = float("inf")

    # Run a pose-graph solve BEFORE re-anchoring the tracker when an
    # accepted closure targets the NEWEST scan.  The reference rewrites the
    # scan's pose and never updates its tracker (ndt_mapper.cpp:651 vs
    # :541-545); our tracker re-anchors on the rewritten pose, so a single
    # wrong far closure (an appearance alias) would otherwise inject its
    # jump straight into the pose chain.  With this flag the robust solve
    # arbitrates first — a switched-off alias edge leaves the consensus
    # pose in place and the re-anchor is harmless.  ON by default since
    # round 5: measured bitwise-neutral when the mechanism does not fire
    # (BASELINE.md round 4 robustness note) and it prevents a measured
    # 5.6 m ATE failure when it does
    # (tests/test_mapper_e2e.py::TestSolveBeforeReanchor).  Deliberate
    # deviation from reference parity (docs/PARITY.md); set False for the
    # reference's re-anchor-first behavior.
    loop_closure_solve_before_reanchor: bool = True

    # Acceptance policy within one query's candidate list: "first" = the
    # reference's iteration order (accept any candidate passing the gate as
    # it is reached, ndt_mapper.cpp:645-663); "best" = candidates face the
    # gates in score order (best first, falling through to the next-best on
    # a rejection) and at most ONE closure is added per query per pass — a
    # precision lever when dense confirmation regions let several geometric
    # near-matches through the gate.
    loop_closure_accept: str = "first"

    # Scans per loop-closure candidate region (the NDT the query is matched
    # against).  2 = exact reference parity: its comment says "one
    # additional scan on either side" but its exclusive end bound yields
    # {i-1, i} (ndt_mapper.cpp:627-631).  3 = the stated intent
    # {i-1, i, i+1}; larger regions build denser confirmation NDTs
    # (measured: 3 lifts office confirmation precision/recall — see
    # BASELINE.md round 4 and benchmarks/lc_pr_results.json).
    loop_closure_region_size: int = 2

    # --- far-candidate (coarse-stage) pruning (round 5) ---
    # The expensive arm of a descriptor-mode loop-closure pass is the FAR
    # rows: candidates beyond the radius-search reach run the wide coarse
    # lattice (~85 MB of intermediates per row).  On repeating geometry
    # most far rows are appearance ALIASES of the same few sites, proposed
    # again by every query of the pass and confirmed only to be rejected
    # (measured: 24x the radius-mode wall on the office benchmark,
    # BASELINE.md round 4).  Two pruning levers, applied before dispatch:
    #
    # Spatial dedup within one pipelined pass: among far rows whose query
    # AND candidate positions both lie within this radius (meters) of an
    # already-selected row's, only the highest-descriptor-similarity row
    # dispatches — one representative confirmation per (query region,
    # candidate region) pair per pass.  An acceptance restarts the pass
    # from the corrected graph (unchanged), so true revisits suppressed in
    # one pass get re-proposed in the restart.  0 = off (dispatch every
    # row; reference-shaped, the default).
    loop_closure_far_dedup: float = 0.0
    # Cross-pass negative cache: a far pair whose confirmation CLEARLY
    # missed the score gate (score - gate >= margin * |gate|, or a
    # non-finite score) marks its (query cell, candidate cell) pair — at
    # loop_closure_far_dedup (else 2 m) granularity — and nearby queries
    # skip proposing that site until the cache invalidates (any accepted
    # closure or optimization clears it, since graph corrections change
    # the coarse start poses).  0 = off (the default).
    loop_closure_reject_cache_margin: float = 0.0
    # Hard per-pass cap on far rows, ranked by descriptor similarity
    # (strongest proposals first).  0 = unlimited (the default).
    loop_closure_max_far_rows: int = 0

    descriptor_bins: int = 32
    # Tuned on the 3x-drift office recall benchmark (benchmarks/
    # loop_closure_pr.py, lc_pr_results.json): with DC-free ring
    # descriptors, 0.90 gives candidate recall 0.33 / final ATE 0.80 vs
    # 0.29 / 1.28 at the old untuned 0.95.
    descriptor_min_similarity: float = 0.90
    # Descriptor-mode candidates carry unknown odometry drift, so their NDT
    # confirmation runs coarse-to-fine: this wide/coarse lattice aligns
    # first (starting from the candidate's position), then
    # ``global_scan_matcher`` refines and produces the score + covariance
    # that gate acceptance.  The angular reach matters as much as the
    # linear one: drift corrupts HEADING too (±0.1 rad covered only 1σ of
    # the 3x-drift office's heading error — far candidates were proposed by
    # the rotation-invariant descriptors and then unconfirmable because the
    # true rotation sat outside the lattice).  The LINEAR reach, by
    # contrast, covers the query's offset RELATIVE to the candidate (the
    # start pose sits at the candidate's own position, so global drift
    # largely cancels); ±2.0 m @ 0.1 is the measured-safe reach — a ±1.5 m
    # variant let a 12 m-separation alias through the gates on the config-6
    # benchmark (one catastrophic closure, final ATE 5.9) while ±2.0
    # confirmed cleanly (0.095).
    coarse_scan_matcher: ScanMatcherConfig = dataclasses.field(
        default_factory=lambda: ScanMatcherConfig(
            ndt_resolution=0.5, search_linear_size=2.0,
            search_linear_resolution=0.1, search_angular_size=0.5,
            search_angular_resolution=0.05))


DEFAULT_CONFIG = MapperConfig()
