"""INCREMENTALLEARNER registry (counterpart of
``pointcloudpdf_tpu/incr_learners/builder.py``)."""

from ..utils.registry import Registry

INCREMENTALLEARNER = Registry("incremental_learner")


def build_incremental_learner(cfg):
    return INCREMENTALLEARNER.build(dict(cfg))
