from .server import MasterServer  # noqa: F401
