"""Fleet distributed API for the parameter-server job: the strategy, the
role makers, the coordination store, the ``fleet`` facade and the local
launcher (``python -m paddle_tpu_torch.distributed.launch``)."""

from .collective import TCPStore
from .fleet import Fleet, fleet
from .meta_optimizers import apply_strategy
from .recompute import recompute, recompute_sequential
from .role_maker import PaddleCloudRoleMaker, Role, RoleMakerBase, UserDefinedRoleMaker
from .strategy import DistributedStrategy

__all__ = ["DistributedStrategy", "Fleet", "PaddleCloudRoleMaker", "Role", "RoleMakerBase",
           "TCPStore", "UserDefinedRoleMaker", "apply_strategy", "fleet", "recompute",
           "recompute_sequential"]
