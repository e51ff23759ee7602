from .needle_map import NeedleMap  # noqa: F401
