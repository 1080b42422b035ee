"""The learned models: SuperPoint, the attention matcher, their weights, and
their trainers (train_*.py, vo_distill.py, matcher_data.py, optim.py)."""

from visualodometry_tpu_torch.models.attention_matcher import (  # noqa: F401
    AttentionMatcher,
    adaptive_match,
    assignment_from_scores,
    normalize_kps,
)
from visualodometry_tpu_torch.models.convert import (  # noqa: F401
    attention_state_dict_from_flax,
    load_torch_superpoint,
    superpoint_state_dict_from_flax,
)
from visualodometry_tpu_torch.models.superpoint import (  # noqa: F401
    SuperPointBackbone,
    SuperPointDense,
    heatmap_from_logits,
    init_superpoint,
    is_dense_params,
    nms_heatmap,
    select_keypoints,
    superpoint_extract,
)
from visualodometry_tpu_torch.models.weights import load_flax_pickle  # noqa: F401
