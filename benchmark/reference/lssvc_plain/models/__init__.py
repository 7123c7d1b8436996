from .dmc import DMC
from .intra_noar import IntraNoAR
from .intra_ss import IntraSS
from .lssvc import LSSVC

__all__ = ["DMC", "IntraNoAR", "IntraSS", "LSSVC"]
