from .cheng2020 import Cheng2020Anchor
from .dmc import DMC
from .intra_noar import IntraNoAR
from .intra_ss import IntraSS
from .lssvc import LSSVC

# the I-frame models by the names the reference's CLI takes
model_architectures = {
    "IntraNoAR": IntraNoAR,
    "cheng2020-anchor": Cheng2020Anchor,
}

__all__ = ["Cheng2020Anchor", "DMC", "IntraNoAR", "IntraSS", "LSSVC",
           "model_architectures"]
