from . import adders, multipliers, tables
from .library import ADD16, MUL8S, MUL8U, Circuit, Library, default_library

__all__ = [
    "adders", "multipliers", "tables",
    "Circuit", "Library", "default_library", "MUL8U", "MUL8S", "ADD16",
]
