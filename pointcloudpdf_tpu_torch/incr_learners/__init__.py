from .builder import INCREMENTALLEARNER, build_incremental_learner
from .pointpdf_incr import PointPdfIncrV1, incr_distill_kl_loss
