"""L5 CLI / entrypoint layer (SURVEY.md C1-C3): options, server, main.

``Server`` is imported on first use: it brings in torch (the kubelet and
the model server), which the ``apiserver`` verb and the kubectl-like verbs
never need, and on the H100 host that import takes most of an apiserver's
start (~10 s). The JAX package imports its ``Server`` here eagerly.
"""

from tfk8s_tpu_torch.cmd.main import main
from tfk8s_tpu_torch.cmd.options import Options


def __getattr__(name):
    if name == "Server":
        from tfk8s_tpu_torch.cmd.server import Server

        return Server
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["main", "Options", "Server"]
