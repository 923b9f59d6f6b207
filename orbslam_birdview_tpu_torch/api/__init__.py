from .config import SlamConfig  # noqa: F401


def __getattr__(name):
    # lazy: System pulls in the pipeline, which imports api.config —
    # eager import here would be circular
    if name == "System":
        from .system import System

        return System
    raise AttributeError(name)
