"""VO state, the per-frame step, the KLT-mode step, the chunked runner,
the host engine and checkpoints."""

from visualodometry_tpu_torch.core.state import (  # noqa: F401
    Keyframe,
    MapState,
    StepOutput,
    VOState,
    init_state,
    landmark_lookup,
    state_from_numpy,
    state_to_numpy,
)
from visualodometry_tpu_torch.core.step import (  # noqa: F401
    make_attention_match_fn,
    make_step_fn,
)
from visualodometry_tpu_torch.core.klt_step import (  # noqa: F401
    init_klt_state,
    klt_state_from_numpy,
    make_klt_step_fn,
)
from visualodometry_tpu_torch.core.runner import (  # noqa: F401
    apply_pose_delta,
    make_chunked_pipeline_fn,
    make_chunked_step_fn,
)
from visualodometry_tpu_torch.core.checkpoint import (  # noqa: F401
    load_state,
    save_state,
)
from visualodometry_tpu_torch.core.pipeline import VOEngine  # noqa: F401
