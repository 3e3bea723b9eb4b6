from .comm import TPGroup
from .control_plane import ControlPlane, DistPlane, LocalPlane
from .sharding import param_shard_dim, shard_params

__all__ = ["ControlPlane", "DistPlane", "LocalPlane", "TPGroup", "param_shard_dim",
           "shard_params"]
