"""TPUGateway: the HTTP serving front door of the port: a
copy of the JAX package's ``gateway/``.

One wire entrance for inference traffic: an HTTP transport on the
apiserver's proven stack (:mod:`tfk8s_tpu_torch.gateway.server`), least-queue-
depth routing over the replicas' published load signal
(:mod:`tfk8s_tpu_torch.gateway.router`), and per-tenant token-bucket admission
with priority shedding (:mod:`tfk8s_tpu_torch.gateway.admission`). The thin
pipelined client lives in :mod:`tfk8s_tpu_torch.gateway.client`.
"""

from tfk8s_tpu_torch.gateway.admission import TenantAdmission, shed_threshold
from tfk8s_tpu_torch.gateway.client import GatewayClient
from tfk8s_tpu_torch.gateway.router import RouteTable
from tfk8s_tpu_torch.gateway.server import GatewayServer

__all__ = [
    "GatewayClient",
    "GatewayServer",
    "RouteTable",
    "TenantAdmission",
    "shed_threshold",
]
