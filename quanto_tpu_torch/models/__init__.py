"""models of quanto_tpu_torch (see the package docstring)."""

from .serving import BatchedEngine, PagedEngine


__all__ = ["BatchedEngine", "PagedEngine"]
