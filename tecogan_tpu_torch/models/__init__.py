from .vsr_model import VSRModel

__all__ = ["VSRModel"]
