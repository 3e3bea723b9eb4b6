from .control_plane import ControlPlane, LocalPlane

__all__ = ["ControlPlane", "LocalPlane"]
