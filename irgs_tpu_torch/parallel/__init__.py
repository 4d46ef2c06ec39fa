"""Multi-device training and eval on torch.distributed (≙ irgs_tpu/parallel)."""

from .dp import (Mesh, broadcast_params, eval_mc_sharded,  # noqa: F401
                 launch_ranks, make_mesh, spawn_ranks, stage2_dp_step)
