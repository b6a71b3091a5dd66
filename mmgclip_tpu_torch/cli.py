"""Entry-point helpers: Hydra-style CLI parsing and run-dir management
(port of mmgclip_tpu/cli.py)."""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

from .config import Config, compose, save_snapshot

DEFAULT_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def parse_hydra_args(default_config: str,
                     argv: Optional[List[str]] = None) -> Tuple[str, str, List[str]]:
    """``--config-name name key=value ...`` like the reference's Hydra CLIs."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument("--config-name", dest="config_name", default=default_config)
    parser.add_argument("--config-dir", dest="config_dir", default=DEFAULT_CONFIG_DIR)
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_args(argv)
    return args.config_dir, args.config_name, args.overrides


def compose_run(default_config: str, argv: Optional[List[str]] = None,
                snapshot: bool = True) -> Config:
    """Compose the config, create the run dir, snapshot to ``.hydra/``."""
    config_dir, config_name, overrides = parse_hydra_args(default_config, argv)
    cfg = compose(config_dir, config_name, overrides)
    run_dir = cfg.hydra.run.dir
    os.makedirs(run_dir, exist_ok=True)
    if snapshot:
        save_snapshot(cfg, run_dir)
    return cfg
