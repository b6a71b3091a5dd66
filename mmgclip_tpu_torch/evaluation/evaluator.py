"""Test-time evaluation harness (port of mmgclip_tpu/evaluation/evaluator.py).

Rebuild of the reference Evaluator (reference: mmgclip/evaluator.py:22-729):
batch-embeds the test split once on the device, then dispatches the
configured evaluation methods per enum class —

* ``zeroshot``       : per-class ["No {c}", "{c}"] prompt pairs, per-class ROC
                       (reference: evaluator.py:258-319);
* ``zeroshot_label_prompt`` : one fixed prompt per class, argmax prediction,
                       per-class + interpolated-mean ROC, 1000x bootstrap 95%
                       CI for binary tasks (reference: evaluator.py:321-478);
* ``confustion_matrix`` (sic — key kept for config parity): all prompts at
                       once, confusion matrix (reference: :147-256);

and, built with ``cnn_eval=True`` (no model, no text tower),
``evaluate_cnn``: the supervised ConvNeXt classifier head over stored pooled
features, one-vs-all ROC per class (reference: evaluator.py:657-729).

The metrics are the JAX package's numpy code on the same numpy RNG.  Plots
need matplotlib; where it does not import, each plot is skipped with a
warning, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.labels import process_class_list
from ..ingest.encode import resolve_device
from ..models.clip import MMGCLIP, l2_normalize
from ..prompts.enums import get_enum_class
from ..utils.logging import logger
from ..utils.seeding import create_directory_if_not_exists
from ..utils.table import Table
from . import metrics as M

_LABEL_PROMPTS = {
    "BenignMalignantDatasetLabels": lambda classes: [f"Finding suggesting {label}." for label in classes],
    "MassShapeLabels": lambda classes: [f"Mass shape is {label}." for label in classes],
    "MassMarginLabels": lambda classes: [f"Mass margin is {label}." for label in classes],
    "HasMassLabels": lambda classes: ["No mass was observed.", "Findings revealed a mass."],
    "HasArchDistortion": lambda classes: ["Normal architecture is visible.", "Displayed architectural distortion."],
    "HasCalcification": lambda classes: ["No calcifications are present.", "Finding suggesting calcifications."],
}


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _scrub(obj):
    """JSON-safe copy: numpy scalars to Python, NaN / inf to null."""
    if isinstance(obj, dict):
        return {str(k): _scrub(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        obj = obj.item()
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


class Evaluator:
    def __init__(self, config, test_dataloader=None, tokenizer=None, model: Optional[MMGCLIP] = None,
                 device=None, cnn_eval: bool = False):
        logger.info("Running evaluator on test split.")
        self.config = config
        if test_dataloader is None:
            raise ValueError("Evaluation requires a test dataloader object.")
        self.test_dataloader = test_dataloader
        self.tokenizer = tokenizer

        if cnn_eval:
            logger.info("Evaluating CNN, use evaluate_cnn method.")
            self.model = None
            self.device = resolve_device(device)
        elif model is not None:
            logger.info("Using trained model instance...")
            self.model = model
            self.device = model.device
        else:
            from ..training.checkpoint import load_checkpoint
            from ..weights import load_clip_params

            self.device = resolve_device(device)
            ckp_path = os.path.join(config.checkpoints.checkpoints_export_dir,
                                    config.checkpoints.checkpoints_file_name)
            if not os.path.isfile(ckp_path):
                raise FileNotFoundError(f'Checkpoint file path "{ckp_path}" does not exist.')
            vocab = tokenizer.vocab_size if tokenizer is not None else None
            self.model = MMGCLIP(config, seed=int(config.base.seed), vocab_size=vocab)
            load_clip_params(self.model, load_checkpoint(ckp_path)["params"])
            self.model.to(self.device)
            logger.info(f"Loaded model from {ckp_path}.")
        create_directory_if_not_exists(config.base.results_export_dir)
        self._prompt_cache: Dict[tuple, np.ndarray] = {}
        self._logit_scale_cache: Optional[float] = None

    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode_text(self, texts) -> np.ndarray:
        """Texts -> normalized projected embeddings (reference: evaluator.py:67-80)."""
        if isinstance(texts, dict):
            tokens = texts
        else:
            key = tuple(texts)
            if key in self._prompt_cache:
                return self._prompt_cache[key]
            tokens = self.tokenizer(list(texts), padding="longest", truncation=True,
                                    max_length=int(self.config.tokenizer.config.sequence_length))
        pooled = self.model.apply_text_tower(tokens)
        emb = l2_normalize(self.model.project_text(pooled)).float().cpu().numpy()
        if not isinstance(texts, dict):
            self._prompt_cache[tuple(texts)] = emb
        return emb

    @torch.no_grad()
    def _encode_image_device(self, batch) -> torch.Tensor:
        feats = torch.as_tensor(np.asarray(batch["image_features"], np.float32), device=self.device)
        return l2_normalize(self.model.project_image(self.model.apply_image_tower(feats)))

    def _logit_scale(self) -> float:
        if self._logit_scale_cache is None:  # one read for the Evaluator's lifetime
            self._logit_scale_cache = float(torch.exp(self.model.logit_scale.detach()))
        return self._logit_scale_cache

    # ------------------------------------------------------------------
    def zeroshot_eval(self, image_embeddings, label_names, classes_dict, key, use_logits=True):
        """Per-class ["No X", "X"] ROC (reference: evaluator.py:258-319)."""
        logger.info(f"Evaluating zero-shot prompt configuration for {key}.")
        labels = [process_class_list([pl[key]]) for pl in label_names]
        classes_prompts = process_class_list(list(classes_dict.keys()))
        results = Table(["Class", "AUROC", "Accuracy", "F1"])
        curves = []

        for class_name in classes_prompts:
            text_emb = self.encode_text([f"No {class_name}", f"{class_name}"])
            sims = (self._logit_scale() if use_logits else 1.0) * image_embeddings @ text_emb.T
            sims = M.softmax(sims, axis=1)
            y_true = np.array([1 if class_name in label else 0 for label in labels])
            if y_true.min() == y_true.max():
                results.add_row([class_name, float("nan"), float("nan"), float("nan")])
                continue
            fpr, tpr, _ = M.roc_curve(y_true, sims[:, 1])
            roc = M.auc(fpr, tpr)
            preds = np.argmax(sims, axis=1)
            results.add_row([class_name, roc, M.accuracy_score(y_true, preds), M.f1_score(y_true, preds)])
            curves.append((class_name, fpr, tpr, roc))

        self._plot_roc(curves, key, subdir="zeroshot")
        return results

    def zeroshot_label_prompt(self, image_embeddings, label_names, classes_dict, key, use_logits=True):
        """Fixed prompt per class, argmax + bootstrap CI
        (reference: evaluator.py:321-478)."""
        logger.info(f"Evaluating zero-shot label prompts for {key}.")
        if key not in _LABEL_PROMPTS:
            # e.g. the gtr_* enums: skip loudly so the other enums' results
            # are still written
            logger.warning(
                f"zeroshot_label_prompt has no prompt bank for {key!r} "
                f"(available: {sorted(_LABEL_PROMPTS)}); skipping this enum.")
            return None
        labels = [process_class_list([pl[key]]) for pl in label_names]
        classes_prompts = process_class_list(list(classes_dict.keys()))
        prompts = _LABEL_PROMPTS[key](classes_prompts)

        text_emb = self.encode_text(prompts)
        sims = (self._logit_scale() if use_logits else 1.0) * image_embeddings @ text_emb.T
        sims = M.softmax(sims, axis=1)

        y_true = np.array([classes_dict[label[0].replace(" ", "").replace("-", "")] for label in labels])
        y_pred = np.argmax(sims, axis=-1)

        results: Dict = {}
        curves = []
        roc_list = []
        for idx, prompt in enumerate(prompts):
            y_bin = y_true == idx
            if 0 < y_bin.sum() < len(y_bin):
                roc = M.roc_auc_score(y_bin, sims[:, idx])
                fpr, tpr, _ = M.roc_curve(y_bin, sims[:, idx])
                curves.append((prompt, fpr, tpr, roc))
                roc_list.append((fpr, tpr))
            else:
                roc = float("nan")
            results[prompt] = {"auc": roc, "accuracy": float(np.mean((y_pred == idx) == y_bin))}

        if roc_list:
            _mean_fpr, _mean_tpr, _std, mean_auc = M.mean_roc_curve(roc_list)
            results["mean_auc"] = mean_auc
        self._plot_roc(curves, key, subdir="zeroshot_label_prompt")

        # bootstrap CI for binary tasks (reference: evaluator.py:421-471)
        if len(prompts) == 2 and len(np.unique(y_true)) == 2:
            ci = M.bootstrap_auc_ci(y_true, sims[:, 1], n_iterations=1000, seed=int(self.config.base.seed))
            results["auc_ci_mean"] = ci["mean"]
            results["auc_ci_lower"] = ci["lower"]
            results["auc_ci_higher"] = ci["upper"]
            self._plot_ci_hist(ci, key)

        results["accuracy"] = M.accuracy_score(y_true, y_pred)
        results["f1score"] = M.f1_score(y_true, y_pred, average="binary" if len(classes_prompts) <= 2 else "micro")
        return results

    def clf_conf_matrix(self, image_embeddings, label_names, classes_dict, key, use_logits=True):
        """All-prompts-at-once confusion matrix (reference: evaluator.py:147-256)."""
        logger.info(f"Evaluating prompt classifier for {key}.")
        labels = [[pl[key]] for pl in label_names]
        y_true = np.array([classes_dict[label[0].replace(" ", "").replace("-", "")] for label in labels])

        classes_prompts = process_class_list(list(classes_dict.keys()))
        if "unknown" in classes_prompts:
            classes_prompts.remove("unknown")

        text_emb = self.encode_text(classes_prompts)
        sims = M.softmax(self._logit_scale() * image_embeddings @ text_emb.T, axis=1)
        y_pred = np.argmax(sims, axis=-1)

        conf = M.confusion_matrix(y_true, y_pred, labels=range(len(classes_prompts)))
        out_dir = create_directory_if_not_exists(
            os.path.join(self.config.base.results_export_dir, "classifier"))
        try:
            plt = _plt()
            fig, ax = plt.subplots(figsize=(8, 6))
            im = ax.imshow(conf, cmap="Blues")
            ax.set_xticks(range(len(classes_prompts)), classes_prompts, rotation=45, ha="right")
            ax.set_yticks(range(len(classes_prompts)), classes_prompts)
            for i in range(conf.shape[0]):
                for j in range(conf.shape[1]):
                    ax.text(j, i, str(conf[i, j]), ha="center", va="center")
            ax.set_title("Confusion Matrix")
            fig.colorbar(im)
            fig.tight_layout()
            fig.savefig(os.path.join(out_dir, f"model_{key}_confusion_matrix.png"))
            plt.close(fig)
        except Exception as exc:  # plotting must never fail an eval run
            logger.warning(f"Confusion-matrix plot failed: {exc}")
        return conf

    # ------------------------------------------------------------------
    def _plot_roc(self, curves, key, subdir):
        out_dir = create_directory_if_not_exists(
            os.path.join(self.config.base.results_export_dir, subdir))
        # raw curves as data, so several runs' ROCs can be overlaid later
        try:
            with open(os.path.join(out_dir, f"model_{key}_roc_curves.json"), "w") as fh:
                json.dump([{"name": name, "auc": float(roc), "fpr": np.asarray(fpr).tolist(),
                            "tpr": np.asarray(tpr).tolist()} for name, fpr, tpr, roc in curves], fh)
        except Exception as exc:
            logger.warning(f"ROC curve dump failed: {exc}")
        try:
            plt = _plt()
            fig, ax = plt.subplots()
            for name, fpr, tpr, roc in curves:
                ax.plot(fpr, tpr, lw=2, label=f"{name} (AUC = {roc:.4f})")
            ax.plot([0, 1], [0, 1], color="navy", lw=2, linestyle="--")
            ax.set_xlabel("False Positive Rate")
            ax.set_ylabel("True Positive Rate")
            ax.set_title("Receiver Operating Characteristic")
            ax.legend(loc="lower right", fontsize=7)
            fig.savefig(os.path.join(out_dir, f"model_{key}_classwise_roc.png"))
            plt.close(fig)
        except Exception as exc:
            logger.warning(f"ROC plot failed: {exc}")

    def _plot_ci_hist(self, ci, key):
        out_dir = create_directory_if_not_exists(
            os.path.join(self.config.base.results_export_dir, "zeroshot_label_prompt"))
        try:
            plt = _plt()
            fig, ax = plt.subplots()
            ax.axvline(ci["mean"], color="green")
            ax.axvline(ci["lower"], color="red", linestyle="--")
            ax.axvline(ci["upper"], color="red", linestyle="--")
            ax.set_title(f"Bootstrap AUC 95% CI ({ci['n_valid']} resamples)")
            fig.savefig(os.path.join(out_dir, f"model_{key}_auc_CI.png"))
            plt.close(fig)
        except Exception as exc:
            logger.warning(f"CI plot failed: {exc}")

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate_cnn(self, classifier_fn) -> Table:
        """Supervised ConvNeXt-classifier baseline on stored features
        (reference: evaluator.py:657-729).  ``classifier_fn``: pooled
        [n, d] features on the device -> [n, n_classes] logits; the
        posteriors are ``softmax(logits / 2)``."""
        label_names: List[str] = []
        posteriors = []
        for batch in self.test_dataloader:
            label_names.extend(batch["image_description"])
            feats = np.asarray(batch["image_features"], np.float32)
            feats = torch.as_tensor(feats.reshape(feats.shape[0], -1), device=self.device)
            logits = classifier_fn(feats).float().cpu().numpy()
            posteriors.append(M.softmax(logits / 2, axis=-1))
        sims = np.concatenate(posteriors, axis=0)

        enum_name = self.config.dataset.eval.enum_classes[0]
        classes_dict = {label.name: label.value for label in get_enum_class(enum_name)}
        results = Table(["Class", "AUROC"])
        curves = []
        for idx, class_name in enumerate(classes_dict.keys()):
            y_true = np.array([1 if class_name in label else 0 for label in label_names])
            if y_true.min() == y_true.max():
                results.add_row([class_name, float("nan")])
                continue
            fpr, tpr, _ = M.roc_curve(y_true, sims[:, idx])
            roc = M.auc(fpr, tpr)
            results.add_row([class_name, roc])
            curves.append((class_name, fpr, tpr, roc))
        self._plot_roc(curves, f"cnn_{enum_name}_ova", subdir="ova")
        return results

    # ------------------------------------------------------------------
    def evaluate_experiment(self) -> List:
        """Embed the test split, run the configured methods, write results.txt
        and results.json (reference: evaluator.py:564-654)."""
        chunks = []
        prompt_labels: List[Dict] = []
        for batch in self.test_dataloader:
            chunks.append(self._encode_image_device(batch))  # stays on the device
            prompt_labels.extend(batch["prompt_labels"])
        image_embeddings = torch.cat(chunks).cpu().numpy()  # one read for the test set

        methods = list(self.config.dataset.eval.method)
        experiments_results = []
        results_json: dict = {}
        for enum_class_name in self.config.dataset.eval.enum_classes:
            enum_class = get_enum_class(enum_class_name)
            classes_dict = {label.name: label.value for label in enum_class}
            results_json[enum_class_name] = {}

            if "zeroshot" in methods:
                results = self.zeroshot_eval(image_embeddings, prompt_labels, classes_dict, enum_class_name)
                logger.info(f"zeroshot results for {enum_class_name}:\n{results}")
                experiments_results.append(results)
                results_json[enum_class_name]["zeroshot"] = {
                    str(row[0]): {"auc": row[1], "accuracy": row[2], "f1": row[3]} for row in results.rows}
            if "zeroshot_label_prompt" in methods:
                results = self.zeroshot_label_prompt(image_embeddings, prompt_labels, classes_dict,
                                                     enum_class_name)
                if results is not None:  # None = no prompt bank, skipped loudly
                    logger.info(f"zeroshot_label_prompt results for {enum_class_name}:\n{results}")
                    experiments_results.append(results)
                    results_json[enum_class_name]["zeroshot_label_prompt"] = results
            if "confustion_matrix" in methods:
                conf = self.clf_conf_matrix(image_embeddings, prompt_labels, classes_dict, enum_class_name)
                results_json[enum_class_name]["confusion_matrix"] = np.asarray(conf).tolist()

        with open(os.path.join(self.config.base.results_export_dir, "results.txt"), "w") as fh:
            for result in experiments_results:
                fh.write(str(result) + "\n\n")
        with open(os.path.join(self.config.base.results_export_dir, "results.json"), "w") as fh:
            json.dump(_scrub(results_json), fh, indent=2, default=str)
        return experiments_results
