"""VO state, the per-frame step, the chunked runner, the host engine and
checkpoints."""

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
from visualodometry_tpu_torch.core.checkpoint import (  # noqa: F401
    load_state,
    save_state,
)
from visualodometry_tpu_torch.core.pipeline import VOEngine  # noqa: F401
