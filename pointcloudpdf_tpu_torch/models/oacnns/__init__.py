from .oacnns import OACNNs
