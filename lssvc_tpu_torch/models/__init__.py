from .dmc import DMC
from .lssvc import LSSVC

__all__ = ["DMC", "LSSVC"]
