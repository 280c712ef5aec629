# Copied from pointcloudpdf_tpu/engines/hooks/default.py; keep in step.
"""Hook base class: six lifecycle no-ops
(reference: pointcept/engines/hooks/default.py:9-32)."""


class HookBase:
    trainer = None  # set by the trainer at registration

    def before_train(self):
        pass

    def before_epoch(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass

    def after_epoch(self):
        pass

    def after_train(self):
        pass
