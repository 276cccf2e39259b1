"""L4 controller layer: generic reconcile loop + leader election
(SURVEY.md C15/C17). The TPUJob-specific controller lives in
``tfk8s_tpu_torch.trainer.tpujob_controller`` next to the trainer it drives.
"""

from tfk8s_tpu_torch.controller.controller import Controller  # noqa: F401
from tfk8s_tpu_torch.controller.leaderelection import LeaderElector  # noqa: F401
