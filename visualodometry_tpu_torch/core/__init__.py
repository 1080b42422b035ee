"""VO state, the per-frame step and the chunked runner."""

from visualodometry_tpu_torch.core.state import (  # noqa: F401
    StepOutput,
    VOState,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from visualodometry_tpu_torch.core.step import make_step_fn  # noqa: F401
from visualodometry_tpu_torch.core.runner import (  # noqa: F401
    make_chunked_pipeline_fn,
)
