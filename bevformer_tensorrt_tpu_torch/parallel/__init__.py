"""The parallel layer of the port (port of `bevformer_tensorrt_tpu/parallel/`):
process meshes, partition rules, sequence-parallel hooks and pipelines on
`torch.distributed` with explicit collectives.  `pp_encoder` and
`pp_decoder` import the model and are imported by name."""
from .comm import counts as collective_counts, reset_counts as reset_collective_counts  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    init_distributed,
    make_mesh,
    pick_dp_tp,
    replicated,
)
from .pipeline import (  # noqa: F401
    pipeline_apply,
    stack_stage_params,
    stage_param_sharding,
)
from .sharding import (  # noqa: F401
    DEFAULT_RULES,
    gather_state_dict,
    param_shardings,
    shard_parameters,
    spec_for_path,
)
