# A copy of rlaifv_tpu/core/registry.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Component registry (ref: muffin/data/data_processors.py:14-102 —
decorator-registered data sources). Generalized to any component family."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Any] = {}

    def register(self, key: Optional[str] = None) -> Callable:
        def deco(obj):
            k = key or getattr(obj, "__name__", str(obj))
            if k in self._items:
                raise KeyError(f"{self.name}: duplicate key {k!r}")
            self._items[k] = obj
            return obj

        return deco

    def __getitem__(self, key: str):
        if key not in self._items:
            raise KeyError(
                f"{self.name}: unknown key {key!r}; have {sorted(self._items)}"
            )
        return self._items[key]

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def keys(self):
        return self._items.keys()


# global registries mirroring the reference's single data registry
data_sources = Registry("data_sources")
models = Registry("models")
