"""Loss registry + Criteria (counterpart of
``pointcloudpdf_tpu/models/losses/builder.py``): ``Criteria`` sums a list
of registered losses, each a callable of ``(pred, target)``."""

from ...utils.registry import Registry

LOSSES = Registry("losses")


class Criteria:
    def __init__(self, cfg=None):
        self.cfg = [dict(c) for c in (cfg if cfg is not None else [])]
        self.criteria = [LOSSES.build(c) for c in self.cfg]

    def __call__(self, pred, target):
        if len(self.criteria) == 0:
            # loss computed inside the model
            return pred
        loss = 0.0
        for criterion in self.criteria:
            loss = loss + criterion(pred, target)
        return loss


def build_criteria(cfg):
    return Criteria(cfg)
