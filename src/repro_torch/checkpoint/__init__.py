from .store import AsyncCheckpointer, latest_step, read_metadata, restore, save

__all__ = ["AsyncCheckpointer", "latest_step", "read_metadata", "restore",
           "save"]
