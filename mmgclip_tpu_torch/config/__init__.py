from .compose import Config, compose, load_config, recompose, resolve
from .registry import DATASETS, EXPERIMENTS, LOSSES, NETWORKS, PROJECTIONS, Registry

__all__ = [
    "Config",
    "compose",
    "load_config",
    "recompose",
    "resolve",
    "Registry",
    "NETWORKS",
    "PROJECTIONS",
    "LOSSES",
    "EXPERIMENTS",
    "DATASETS",
]
