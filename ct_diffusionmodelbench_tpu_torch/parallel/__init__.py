from ct_diffusionmodelbench_tpu_torch.parallel.mesh import (
    make_mesh,
    use_mesh,
    current_mesh,
    init_distributed,
    seq_axis_size,
)
from ct_diffusionmodelbench_tpu_torch.parallel.sharding import (
    param_specs,
    data_spec,
    shard_params,
    make_sharded_forward,
)
