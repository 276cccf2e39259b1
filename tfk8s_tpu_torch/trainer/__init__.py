"""L3 trainer layer (SURVEY.md C18/C19 + gang scheduling): renders a TPUJob
into gang-admitted, host-placed replica pods/services carrying the
``TFK8S_*`` coordination contract, the TPUJob controller that reconciles
them, and the TPUServe controller that reconciles serving replicas.
"""

from tfk8s_tpu_torch.trainer.gang import GangAssignment, SliceAllocator, SliceHandle  # noqa: F401
from tfk8s_tpu_torch.trainer.tpujob_controller import FINALIZER, TPUJobController  # noqa: F401
from tfk8s_tpu_torch.trainer.serve_controller import SERVE_FINALIZER, TPUServeController  # noqa: F401
from tfk8s_tpu_torch.trainer import labels, replicas  # noqa: F401
