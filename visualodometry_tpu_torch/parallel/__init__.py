"""Several sequences on a card, and work spread over ranks.

Port of visualodometry_tpu/parallel/:
- `multiseq`: B sequences stepped together, one batched K1 launch and two
  host reads a frame for all lanes;
- `mesh`: a ("seq", "map") grid of `torch.distributed` ranks;
- `distributed_ba`: the Schur BA with landmark blocks sharded over "map",
  one all-reduce of the reduced pose system a Gauss-Newton iteration;
- `runtime`: the process group brought up and torn down (NCCL on CUDA,
  gloo on the CPU or for two ranks on one card).
"""

from visualodometry_tpu_torch.parallel.distributed_ba import ba_solve_distributed  # noqa: F401
from visualodometry_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from visualodometry_tpu_torch.parallel.multiseq import (  # noqa: F401
    init_batched_state,
    make_multiseq_step_fn,
    shard_batched,
)
from visualodometry_tpu_torch.parallel.runtime import (  # noqa: F401
    RuntimeSpec,
    initialize_runtime,
    process_local_batch,
    shutdown_runtime,
)
