from .convert import params_to_torch

__all__ = ["params_to_torch"]
