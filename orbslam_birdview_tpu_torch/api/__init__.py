from .config import SlamConfig  # noqa: F401
