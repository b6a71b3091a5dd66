"""PyTorch/CUDA port of mmgclip_tpu for one NVIDIA H100.

Mirrors the JAX package's module layout (``models/convnext.py`` here is the
counterpart of ``mmgclip_tpu/models/convnext.py``) and imports nothing of
it.  Hand-written CUDA kernels live in ``csrc/`` and are built at first use
(``ops/_build.py``).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.  The names below are the JAX package's facade
(``mmgclip_tpu/__init__.py``) where the port has them; the plotting helpers
are not ported yet.
"""

from .config import Config, compose, load_config, recompose, save_snapshot
from .data.csv_table import Table, read_csv, write_csv
from .data.datasets import get_dataset
from .data.ingest import create_dataset_df
from .data.loader import DataLoaders, dataloader_percentage
from .data.labels import process_class_list
from .data.paths import create_dataset_path, create_exam_path, create_path, find_similar_item
from .data.reports import (
    map_path_to_features,
    post_process_translated_report,
    preprocess_reports_csv,
    remove_duplicate_sentences,
)
from .data.sampler import ImbalancedDatasetSampler
from .data.split import Subset
from .data.store import load_features, save_features
from .data.tokenizer import Tokenizer
from .evaluation import metrics
from .evaluation.evaluator import Evaluator
from .ingest.encode import (
    ImageFeatureExtractor,
    StudyFeatureExtractor,
    image_feature_extractor,
    study_feature_extractor,
)
from .losses import create_loss
from .models.clip import MMGCLIP
from .models.clip import MMGCLIP as model  # facade alias (reference: __init__.py:7)
from .models.clip import PromptClassifier
from .prompts import (
    generate_gtr_prompt_sentence,
    generate_label_prompt_report,
    generate_label_prompt_sentence,
    seed_prompt_rng,
)
from .training.experiment import ClassifierExperiment, create_experiment
from .utils import logger
from .utils.seeding import seeding

__all__ = [
    "Config", "compose", "load_config", "recompose", "save_snapshot",
    "Table", "read_csv", "write_csv",
    "DataLoaders", "ImbalancedDatasetSampler", "Subset", "Tokenizer", "create_dataset_df",
    "create_dataset_path", "create_exam_path", "create_path", "dataloader_percentage",
    "get_dataset", "load_features", "map_path_to_features", "post_process_translated_report",
    "preprocess_reports_csv", "process_class_list", "remove_duplicate_sentences", "save_features",
    "Evaluator", "metrics",
    "ImageFeatureExtractor", "StudyFeatureExtractor", "image_feature_extractor",
    "study_feature_extractor",
    "create_loss", "model", "MMGCLIP", "PromptClassifier",
    "generate_gtr_prompt_sentence", "generate_label_prompt_report",
    "generate_label_prompt_sentence", "seed_prompt_rng",
    "ClassifierExperiment", "create_experiment", "logger", "seeding", "find_similar_item",
]
