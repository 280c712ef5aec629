# Copied from pointcloudpdf_tpu/engines/hooks/builder.py; keep in step.
"""Hook registry (reference: pointcept/engines/hooks/builder.py:11)."""

from ...utils.registry import Registry

HOOKS = Registry("hooks")


def build_hooks(cfg_list):
    return [HOOKS.build(cfg) for cfg in (cfg_list or [])]
