"""Fleet distributed API: the strategy, the role makers, the coordination
store, the ``fleet`` facade, the local and elastic launchers
(``python -m paddle_tpu_torch.distributed.launch``), the fleet executor's
actor runtime, auto-parallel (the planner, completion and ``Engine``) and
the fused dense-DP collectives (``comm_fusion``), and the process-level
collective API (``init_parallel_env``, groups, the eager collectives)."""

from .auto_parallel import Engine, ProcessMesh, shard_op, shard_tensor
from .collective import (Group, ParallelEnv, TCPStore, all_gather, all_reduce, alltoall, barrier,
                         broadcast, get_rank, get_world_size, init_parallel_env, is_initialized,
                         new_group, scatter)
from .comm_fusion import CommFusionConfig, DpGradReducer
from .fleet import Fleet, fleet
from .fleet_executor import (Carrier, ComputeInterceptor, FleetExecutor, InterceptorMessage,
                             MessageBus, TaskNode)
from .meta_optimizers import (AMPOptimizer, DGCMomentumOptimizer, FP16AllReduceOptimizer,
                              FusedAllReduceOptimizer, GradientMergeOptimizer, LocalSGDOptimizer,
                              MetaOptimizerBase, RecomputeOptimizer, apply_strategy)
from .recompute import recompute, recompute_sequential
from .role_maker import PaddleCloudRoleMaker, Role, RoleMakerBase, UserDefinedRoleMaker
from .strategy import DistributedStrategy

__all__ = ["AMPOptimizer", "Carrier", "CommFusionConfig", "ComputeInterceptor",
           "DGCMomentumOptimizer", "DistributedStrategy", "DpGradReducer", "Engine",
           "FP16AllReduceOptimizer", "Fleet", "FleetExecutor", "FusedAllReduceOptimizer",
           "GradientMergeOptimizer", "Group", "InterceptorMessage", "LocalSGDOptimizer",
           "MessageBus", "MetaOptimizerBase", "PaddleCloudRoleMaker", "ParallelEnv",
           "ProcessMesh", "RecomputeOptimizer", "Role", "RoleMakerBase", "TCPStore", "TaskNode",
           "UserDefinedRoleMaker", "all_gather", "all_reduce", "alltoall", "apply_strategy",
           "barrier", "broadcast", "fleet", "get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "new_group", "recompute", "recompute_sequential", "scatter",
           "shard_op", "shard_tensor"]
