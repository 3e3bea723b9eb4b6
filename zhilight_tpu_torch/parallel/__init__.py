from .comm import TPGroup
from .control_plane import (ControlPlane, DistPlane, LocalPlane, RelayPlane, TcpPlane,
                            make_control_plane)
from .sharding import param_shard_dim, shard_params

__all__ = ["ControlPlane", "DistPlane", "LocalPlane", "RelayPlane", "TPGroup", "TcpPlane",
           "make_control_plane", "param_shard_dim", "shard_params"]
