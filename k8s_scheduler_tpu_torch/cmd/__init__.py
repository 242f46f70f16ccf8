"""The process layer (`k8s_scheduler_tpu/cmd/`): the CLI (`main.py`), the
health, metrics and debug HTTP server, the file-lease leader election and
the watchtower's arming."""
from .main import main, new_scheduler_command

__all__ = ["main", "new_scheduler_command"]
