from .logging import get_logger, logger

__all__ = ["logger", "get_logger"]
