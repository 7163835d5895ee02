"""Multi-rank execution over ``torch.distributed``: the (env, prim) mesh,
env-sharded rollouts and train steps, the prim-sharded render."""

from sim_a_splat_torch.parallel.mesh import (
    ENV_AXIS, PRIM_AXIS, initialize_distributed, launch, make_mesh,
    replicate, shard_batch,
)
from sim_a_splat_torch.parallel.render_sharding import (
    rasterize_sharded, rasterize_sharded_sh,
)
from sim_a_splat_torch.parallel.rollout import (
    make_rollout, make_train_step, mean_over_env, shard_vmap,
)

__all__ = [
    "ENV_AXIS", "PRIM_AXIS", "initialize_distributed", "launch", "make_mesh",
    "replicate", "shard_batch", "rasterize_sharded", "rasterize_sharded_sh",
    "make_rollout", "make_train_step", "mean_over_env", "shard_vmap",
]
