from . import gf256  # noqa: F401
from .codec import DATA_SHARDS, PARITY_SHARDS, TOTAL_SHARDS, get_codec  # noqa: F401
