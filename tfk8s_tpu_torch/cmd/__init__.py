"""L5 CLI / entrypoint layer (SURVEY.md C1-C3): options, server, main."""

from tfk8s_tpu_torch.cmd.main import main
from tfk8s_tpu_torch.cmd.options import Options
from tfk8s_tpu_torch.cmd.server import Server

__all__ = ["main", "Options", "Server"]
