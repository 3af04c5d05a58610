from .loader import create_dataloader  # noqa: F401
