"""L4 controller layer: the generic reconcile loop (SURVEY.md C15); leader
election is a later slice of the port. The TPUJob-specific controller lives in
``tfk8s_tpu_torch.trainer.tpujob_controller`` next to the trainer it drives.
"""

from tfk8s_tpu_torch.controller.controller import Controller  # noqa: F401
