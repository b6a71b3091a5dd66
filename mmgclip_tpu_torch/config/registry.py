"""Name -> factory registries.

The reference resolves component names through five ad-hoc `globals()` lookups
(network_controller.py:3-19, projection_controller.py:3-24, loss_controller.py:3-23,
experiments_controller.py:3-23, dataset.py:563-585).  Here a single explicit
registry type serves all of them, with registration decorators so components
self-describe instead of relying on module globals.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._factories: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        def wrap(factory: Callable[..., Any]) -> Callable[..., Any]:
            self._factories[name] = factory
            return factory

        return wrap

    def add(self, name: str, factory: Callable[..., Any]) -> None:
        self._factories[name] = factory

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._factories:
            raise ValueError(
                f"Invalid {self.kind} name: {name!r}. Available: {sorted(self._factories)}"
            )
        return self._factories[name]

    def names(self) -> List[str]:
        return sorted(self._factories)

    def __contains__(self, name: str) -> bool:
        return name in self._factories


NETWORKS = Registry("network")
PROJECTIONS = Registry("projection head")
LOSSES = Registry("loss")
EXPERIMENTS = Registry("experiment")
DATASETS = Registry("dataset")
