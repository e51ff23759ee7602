from .commands import CommandEnv, run_command  # noqa: F401
