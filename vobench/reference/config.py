"""The configuration, as the benchmark's reference reads it.

A frozen copy of the port's `VOConfig`, field for field, so that each
`vobench/configs/<config>.json` (every field written out) loads through
`config_from_dict` on both sides. Fields that no reference route reads
(attention, KLT, BA) are kept so the two stay interchangeable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class VOConfig:
    """All tunables of the VO pipeline (algorithm + TPU runtime)."""

    # -- extractor selection ------------------------------------------------
    extractor_type: str = "superpoint"  # "superpoint" or "sift"
    # detection gate on the NMS'd probability heatmap (selection is
    # top-k; this only sets slot validity). The reference's SuperPoint
    # runs at 0.0005 (LightGlue pipeline default); 0.005 starved the
    # corridor-trained detector to ~90 keypoints/frame at 1226x370.
    superpoint_threshold: float = 5e-4
    # dense-head score threshold (sigmoid scale — the 65-way head's
    # cell-softmax scale above doesn't transfer). Chip sweep r5:
    # 0.1-0.5 -> ATE 0.053, 0.7 -> 0.041, 0.95 -> 0.037 at ~117 fps
    # (weak detections below it add PnP noise, not coverage)
    superpoint_dense_threshold: float = 0.95

    # -- global scaling (monocular scale fixed at bootstrap) ----------------
    # (reference: src/config/config.py:12, applied at src/modules/vo.py:100)
    global_scale: float = 20.0

    # -- feature extractor --------------------------------------------------
    max_keypoints: int = 2048  # padded keypoint slot count (multiple of 128)

    # SIFT-style detector tunables (reference: src/config/config.py:19-22)
    sift_n_features: int = 2048
    sift_contrast_threshold: float = 0.03
    sift_edge_threshold: float = 10.0
    sift_sigma: float = 1.6
    sift_num_octaves: int = 4
    sift_scales_per_octave: int = 3
    # -1 = cv2.SIFT's default upsampled base octave (bilinear 2x): half
    # of cv2's keypoints on textured imagery live there (r4 measurement,
    # ops/pyramid.build_pyramid docstring), so long-horizon parity
    # configs want -1; 0 trades that octave for ~2x extraction
    # throughput (the bench operating point's choice).
    sift_first_octave: int = 0
    # orientation/descriptor tap sampling: "auto" = patch-DMA Pallas path
    # on TPU, flat gathers elsewhere; "gather"/"patch" force a path
    sift_sampling: str = "auto"

    # matcher
    # orientation peaks per keypoint (OpenCV emits a keypoint per
    # histogram peak >= 80% of max; 2 reproduces that recall at the same
    # slot count by halving the detection budget — cv2's own accounting,
    # where split keypoints count toward nfeatures)
    sift_orientation_peaks: int = 1
    lowe_ratio: float = 0.75  # (reference: src/modules/frontend.py:104)
    mutual_check: bool = False  # reference BFMatcher uses crossCheck=False
    matcher_backend: str = "auto"  # "auto" | "jnp" | "pallas"
    matcher_type: str = "ratio"  # "ratio" (kNN+Lowe) | "attention"
    # attention-matcher blocks (LightGlue uses 9). Default matches the
    # bundled trained checkpoints (depth 4, trained on real SIFT
    # descriptors — models/matcher_data.py); other depths fall back to
    # identity-residual init (= dual-softmax mutual-NN matching).
    attention_depth: int = 4
    # LightGlue's adaptive-inference mechanisms (the reference's matcher
    # inherits depth/width confidence pruning from the pinned package,
    # reference: src/modules/frontend.py:23) — used when the v2
    # deep-supervision checkpoint is available (models/attention_matcher
    # .adaptive_match): keep the top-P slots per side after block 0
    # (0 = no pruning), and skip remaining blocks once this fraction of
    # points is confident about its assignment (0 = no early exit).
    # Measured at the 4096-slot deployment point (idle chip, r4):
    # prune 1024 -> 81.5 fps, 1536 -> 79.4, 2048 -> 76.5, all at
    # IDENTICAL sim3 ATE 0.0124 / 0 resets — the pruned points are the
    # ones the confidence head already called unmatchable.
    attention_prune_to: int = 1024
    attention_exit_conf: float = 0.95
    attention_compute: str = "bf16"  # matmul compute dtype: "bf16"|"f32"
    # Bundled attention-matcher checkpoint filename override (r5): the
    # default (None) resolves to the v2 precision checkpoint (fixture
    # ATE 0.0124, one held-out fast-flow reset). Set
    # "attention_matcher_sift_v3b.pkl" for the deployment-regime-
    # trained robust checkpoint (0 held-out marathon resets at 2x
    # frame speed, fixture ATE 0.0428 — RESULTS r5 Pareto table).
    attention_weights: str | None = None
    # Förstner structure-tensor subpixel refinement of SuperPoint
    # detections (models/superpoint._forstner_refine). OFF by default:
    # on the soft value-noise render texture it measured neutral-to-
    # slightly-negative (p50 residual 1.59 vs 1.50 px, r4 —
    # scripts/feat_quality.py); on corner-rich real imagery it is the
    # standard cv2.cornerSubPix-class refinement and worth enabling.
    superpoint_forstner: bool = False
    image_size: tuple = (1226, 370)  # (W, H) for kp normalization

    # -- initialization & keyframes (reference: src/config/config.py:25-28) -
    min_median_flow: float = 20.0
    min_inliers: int = 10
    init_ransac_prob: float = 0.999
    init_ransac_thresh: float = 1.0  # px, Sampson-distance gate
    # Initialization-quality gate: the bootstrap pair must register at
    # least this many triangulated landmarks (post cheirality/reproj/
    # parallax gates) or initialization WAITS for a later frame.
    # 0 = reference semantics (src/modules/vo.py:87-117 accepts any
    # recoverPose result). Guards blackout/turn recovery from locking
    # onto a shallow map built from a feature-poor re-init pair —
    # measured on the 256-frame corridor fixture: the engine otherwise
    # re-initializes at the turn apex with <100 landmarks and tracks
    # the final segment at metre-class ATE instead of ~0.1 m.
    min_init_landmarks: int = 0

    # -- triangulation & depth (reference: src/config/config.py:31-32) ------
    min_depth: float = 0.001
    # minimum ray parallax (degrees) for registering a triangulated
    # landmark; 0 = reference semantics (no parallax gate). Guards the
    # map against near-unconstrained tiny-baseline triangulations when
    # keyframes fire on small flows.
    min_parallax_deg: float = 0.0
    max_reproj_err: float = 6.0

    # -- PnP and tracking (reference: src/config/config.py:35-36) -----------
    pnp_reproj_err: float = 4.0
    kf_min_tracked: int = 80

    # -- speed-scale smoothing (reference: src/config/config.py:38-46) ------
    turn_thresh: float = 0.01  # rad
    move_thresh: float = 0.01
    turn_smoothing: float = 0.7
    trans_smoothing: float = 0.6
    baseline_lr: float = 0.01
    scale_clamp_min: float = 0.5
    scale_clamp_max: float = 3.0

    # -- TPU runtime section (new; no reference analog) ---------------------
    map_capacity: int = 20480  # landmark slots (reference caps at 20000,
    #                            src/modules/vo.py:38; rounded to 128 lanes)
    essential_hypotheses: int = 512  # batched RANSAC minimal samples
    essential_solver: str = "5point"  # "5point" (Nistér, = cv2.findEssentialMat's
    #                                   algorithm, planar-safe) | "8point"
    pnp_hypotheses: int = 512  # batched PnP RANSAC hypotheses
    # "p3p": Grunert minimal solver (cv2.solvePnPRansac's class —
    # algebraically exact on its 3 points, 4 candidate poses per
    # sample, estimation/p3p.py); "dlt": 6-point least-squares DLT
    # (r1-r4 default)
    pnp_solver: str = "dlt"
    pnp_refine_iters: int = 8  # damped GN iterations, cold-start round
    # (later IRLS rounds use a third — warm restarts re-converge fast;
    # multi-seed fixture ATE unchanged at 8 vs 10, r3)
    # refine -> re-estimate-inliers rounds (LO-RANSAC local optimization;
    # cv2.solvePnPRansac's trailing LM-over-consensus equivalent)
    pnp_refine_rounds: int = 3
    # Truncated-Huber IRLS shape (multiples of pnp_reproj_err): linear
    # decay starts at pnp_irls_delta x thresh, weight reaches zero at
    # pnp_irls_cut x thresh. The r3 values (1.0, 3.0) killed RANSAC-seed
    # scatter but let stale drifted landmarks at 3-6 px keep weight
    # 0.3-0.7 and drag the pose on long sequences (map-feedback bias —
    # measured: deeper refinement at cut=3 WORSENS 256-frame drift 4.3
    # -> 14.3 m). cv2.solvePnPRansac refines only the hard consensus
    # set; the tightened default keeps the smooth, data-determined
    # optimum near the threshold with cv2-like rejection beyond it.
    pnp_irls_delta: float = 1.0
    pnp_irls_cut: float = 3.0
    seed: int = 0

    # KLT tracking mode (project-statement design; core/klt_step.py)
    klt_levels: int = 3
    klt_radius: int = 4
    klt_iters: int = 10
    klt_min_parallax_deg: float = 1.0
    klt_suppress_radius: float = 8.0

    # sliding-window BA (beyond the reference; north-star configs 1-3)
    ba_window: int = 5  # keyframes in the BA window
    ba_max_landmarks: int = 512  # landmark slots per window
    ba_iters: int = 8
    ba_damping: float = 1e-3
    # propagate the newest window keyframe's BA pose correction into the
    # live tracking pose between chunks (ba/inloop.py). On short windows
    # over deep scenes the monocular scale direction is weakly
    # observable and an unconstrained solve slides metres along it while
    # reducing reprojection cost fractions of a px^2 (measured round 2:
    # window cost 0.37 -> 0.05 px^2, newest pose moved ~0.9 m, fixture
    # ATE doubled); ba_scale_prior_rel adds a radial prior pinning each
    # free pose's distance-from-gauge to its tracked value within the
    # given relative sigma (ba/solver.py:ScalePrior), which removes the
    # slide while leaving lateral/rotational corrections free.
    ba_pose_correction: bool = False
    ba_scale_prior_rel: float = 0.02

    @property
    def padded_keypoints(self) -> int:
        """Keypoint slot count rounded to the 128-lane TPU tile."""
        return _round_up(max(self.max_keypoints, self.sift_n_features), 128)


def config_from_dict(d: dict) -> VOConfig:
    """Build the port's config from `dataclasses.asdict` of a JAX VOConfig.

    Raises on a key this config does not know, so a field added on one
    side only cannot be dropped silently.
    """
    known = {f.name for f in dataclasses.fields(VOConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown VOConfig fields: {unknown}")
    kw = dict(d)
    if "image_size" in kw:
        kw["image_size"] = tuple(kw["image_size"])
    return VOConfig(**kw)
