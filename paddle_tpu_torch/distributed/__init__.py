"""Fleet distributed API: the strategy, the role makers, the coordination
store, the ``fleet`` facade, the local and elastic launchers
(``python -m paddle_tpu_torch.distributed.launch``), the fleet executor's
actor runtime, auto-parallel (the planner, completion and ``Engine``) and
the fused dense-DP collectives (``comm_fusion``)."""

from .auto_parallel import Engine, ProcessMesh, shard_op, shard_tensor
from .collective import TCPStore
from .comm_fusion import CommFusionConfig, DpGradReducer
from .fleet import Fleet, fleet
from .fleet_executor import (Carrier, ComputeInterceptor, FleetExecutor, InterceptorMessage,
                             MessageBus, TaskNode)
from .meta_optimizers import apply_strategy
from .recompute import recompute, recompute_sequential
from .role_maker import PaddleCloudRoleMaker, Role, RoleMakerBase, UserDefinedRoleMaker
from .strategy import DistributedStrategy

__all__ = ["Carrier", "CommFusionConfig", "ComputeInterceptor", "DistributedStrategy",
           "DpGradReducer", "Engine", "Fleet",
           "FleetExecutor", "InterceptorMessage", "MessageBus", "PaddleCloudRoleMaker",
           "ProcessMesh", "Role", "RoleMakerBase", "TCPStore", "TaskNode",
           "UserDefinedRoleMaker", "apply_strategy", "fleet", "recompute",
           "recompute_sequential", "shard_op", "shard_tensor"]
