"""The training experiment on one device (port of
mmgclip_tpu/training/experiment.py).

Rebuild of the reference train/validate/test life cycle
(reference: mmgclip/experiments/ClassifierExperiment.py:23-344):

* the frozen text tower runs ONCE per dataset at init: EOS-pooled features
  of every row are cached into a device bank (pad-trimmed once for the whole
  bank, fed in padded chunks of 256), and train batches index the bank;
* the fused epoch keeps the feature and text banks on the device and runs
  every step there: the shuffled order is the JAX package's
  (``_epoch_order``, numpy ``default_rng((seed, epoch))``, wrap-around tail),
  the per-step losses accumulate on the device and the epoch reads back one
  number.  On the card it is the counterpart of the JAX ``lax.scan``: the
  first ``GRAPH_WARMUP_STEPS`` steps of the run go eagerly on a side stream
  (real steps), then one step (zero-grad, forward, loss, backward, AdamW)
  is captured as a CUDA graph over a static batch-index buffer, and every
  later step is one index copy and one replay.  The dropout generator is
  registered with the graph, so replays draw what eager steps would and
  checkpoints carry the advanced state; a capture that fails raises;
* a sampler switches to the per-batch loop over the loader;
* validation probes (malignancy / mass-shape / BI-RADS zero-shot AUCs, with
  the pooled probe prompts cached) match the reference's metric set.

The JAX trainer shards the batch over a data mesh; on one card there is no
gather, so this trainer launches no collective.  The JAX package's model /
pipeline / ZeRO / expert layouts raise here (ROADMAP.md).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config.registry import EXPERIMENTS
from ..evaluation import metrics as M
from ..ingest.encode import resolve_device
from ..losses import create_loss
from ..models.bert import eos_pool, trim_padded_tail
from ..models.clip import MMGCLIP, l2_normalize
from ..prompts.enums import BenignMalignantDatasetLabels, MassShapeLabels
from ..utils.logging import logger
from ..utils.profiling import maybe_trace
from ..utils.seeding import create_directory_if_not_exists
from ..utils.tb import ScalarWriter
from .checkpoint import load_checkpoint
from .early_stopping import EarlyStopper
from .optim import create_optimizer, create_scheduler, set_learning_rate


GRAPH_WARMUP_STEPS = 3  # eager steps before the capture (real steps of the run)


def _base_dataset(split):
    node = split
    while hasattr(node, "dataset"):
        node = node.dataset
    return node


def _epoch_order(n: int, bs: int, drop_last: bool, rng) -> np.ndarray:
    """Shuffled sample order for the fused epoch, length a multiple of bs.

    With drop_last=False the tail is COMPLETED by wrapping around the
    permutation (every sample trains each epoch, at the cost of <= bs-1
    duplicates in other batches); drop_last=True drops it."""
    order = rng.permutation(n)
    rem = n % bs
    if rem and not drop_last:
        if n >= bs:
            order = np.concatenate([order, order[: bs - rem]])
        else:  # tiny dataset: tile to one full batch (duplicates unavoidable)
            order = np.resize(order, bs)
    elif rem:
        order = order[: n - rem]
    return order


def _check_single_device_layout(config) -> None:
    """The JAX package's multi-device layouts have no counterpart yet: refuse
    them rather than train a different model silently."""
    requested = []
    if int(config.get_path("parallel.model_axis", 1)) > 1:
        requested.append("parallel.model_axis > 1 (tensor-parallel text tower; with a MoE "
                         "head also expert sharding)")
    if int(config.get_path("parallel.pipeline_stages", 1)) > 1:
        requested.append("parallel.pipeline_stages > 1 (pipelined text tower)")
    if bool(config.get_path("optimizer.config.zero_sharding", False)):
        requested.append("optimizer.config.zero_sharding (ZeRO-1 moments)")
    if requested:
        raise NotImplementedError(
            "the PyTorch trainer runs on one device; not ported yet (ROADMAP.md): "
            + "; ".join(requested))


@EXPERIMENTS.register("classification")
class ClassifierExperiment:
    def __init__(self, config=None, train_dataloader=None, valid_dataloader=None,
                 test_dataloader=None, tokenizer=None, device=None,
                 init_params: Optional[Dict] = None):
        """``init_params``: a JAX-layout trainable tree (nested numpy dicts) to
        start from instead of the seeded init, e.g. the JAX package's."""
        if config is None:
            raise ValueError("Missing training config object.")
        _check_single_device_layout(config)
        self.config = config
        self.device = resolve_device(device)
        self.train_dataloader = train_dataloader
        self.valid_dataloader = valid_dataloader
        self.test_dataloader = test_dataloader
        self.tokenizer = tokenizer
        self.current_epoch = 0
        self._time_start = self._time_end = None
        self.timings: Dict[str, object] = {"epoch_device_ms": [], "epoch_steps": []}

        seed = int(config.base.seed)
        # dropout masks: one explicit generator on the device (the JAX key)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        vocab = tokenizer.vocab_size if tokenizer is not None else None
        self.model = MMGCLIP(config, seed=seed, vocab_size=vocab)
        if init_params is not None:
            from ..weights import load_clip_params

            load_clip_params(self.model, init_params)
        self.model.to(self.device)
        self.params = self.model.trainable_parameters()
        self.model.count_parameters()

        self.loss_name = config.loss.config.loss_name
        self.criterion = create_loss(self.loss_name)
        logger.info(f"Using {self.loss_name} loss.")

        self.optimizer = create_optimizer(self.params,
                                          float(config.optimizer.config.learning_rate),
                                          float(config.optimizer.config.weight_decay))
        self.scheduler = create_scheduler(config)
        logger.info(f"Using {type(self.scheduler).__name__} scheduler.")

        self.ckp_path = os.path.join(
            create_directory_if_not_exists(config.checkpoints.checkpoints_export_dir),
            config.checkpoints.checkpoints_file_name,
        )
        self.early_stopper = EarlyStopper(patience=int(config.base.patience))
        self.writer = ScalarWriter(config.base.tensorboard_export_dir)
        logger.info(f"Training on {self.device}.")

        # ---- frozen-tower text banks -------------------------------------
        self._text_bank = self._impression_bank = None
        if train_dataloader is not None:
            base = _base_dataset(train_dataloader.dataset)
            t0 = time.perf_counter()
            self._text_bank = self._pool_tokens(base._tokens)
            if self.loss_name == "MMGCLIPLoss":
                if getattr(base, "_impression_tokens", None) is None:
                    raise ValueError(
                        "loss=MMGCLIPLoss needs a dataset with impression texts (its T2T term), "
                        f"but {type(base).__name__} provides none — use the exam-reports "
                        "dataset family or switch to loss=CLIPLoss/AveragedMedicalCLIPLoss")
                self._impression_bank = self._pool_tokens(base._impression_tokens)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings["bank_s"] = time.perf_counter() - t0

        self._fused = bool(config.get_path("base.fused_epoch", True)) and train_dataloader is not None
        self._feats_bank = None  # built on the first fused epoch
        # the fused epoch as a CUDA graph (on the card; ``use_cuda_graph =
        # False`` keeps it eager there too)
        self.use_cuda_graph = self.device.type == "cuda"
        self._graph = self._graph_idx = None
        self._warm_steps = 0

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _pool_tokens(self, tokens: Dict[str, np.ndarray], chunk: int = 256) -> torch.Tensor:
        """Run the frozen text tower over all rows once; returns [N, hidden]
        on the device.  The padding tail is trimmed once for the whole bank
        and the last chunk is padded to the chunk size by repeating its last
        row, as the JAX package does (one program shape for every chunk)."""
        tokens = trim_padded_tail(tokens, getattr(self.model, "text_pad_trim_multiple", 32))
        n = tokens["input_ids"].shape[0]
        outs = []
        for start in range(0, n, chunk):
            piece = {k: np.asarray(v[start: start + chunk]) for k, v in tokens.items()}
            valid = piece["input_ids"].shape[0]
            target = chunk if (valid < chunk and n > chunk) else valid
            if valid < target:
                pad = target - valid
                piece = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) for k, v in piece.items()}
            # the tower at the bank's trimmed width (apply_text_tower would
            # trim each chunk again)
            ids, mask = (torch.as_tensor(piece[k], device=self.device)
                         for k in ("input_ids", "attention_mask"))
            types = piece.get("token_type_ids")
            hidden = self.model.text_module(
                ids, attention_mask=mask,
                token_type_ids=None if types is None else torch.as_tensor(types, device=self.device))
            outs.append(eos_pool(hidden, mask)[:valid])
        bank = (torch.cat(outs) if outs
                else torch.zeros((0, self.model.text_output_dimension), device=self.device))
        logger.info(f"Cached frozen text features for {n} rows.")
        return bank

    # ------------------------------------------------------------------
    def _loss(self, image_features, text_features, text_features2, train: bool):
        out = self.model({"image_features": image_features}, train=train,
                         generator=self.generator if train else None,
                         text_features=text_features, text_features2=text_features2)
        loss, _labels = self.criterion(**out)
        return loss, out

    def _train_step(self, image_features, text_features, text_features2) -> torch.Tensor:
        self.optimizer.zero_grad()
        loss, _out = self._loss(image_features, text_features, text_features2, train=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _device_batch(self, batch):
        feats = torch.as_tensor(np.asarray(batch["image_features"], np.float32), device=self.device)
        idx = torch.as_tensor(batch["indices"], device=self.device)
        text = self._text_bank[idx]
        text2 = self._impression_bank[idx] if self._impression_bank is not None else None
        return feats, text, text2

    # ------------------------------------------------------------------
    # fused-epoch path: banks on the device, one read back per epoch
    # ------------------------------------------------------------------
    def _build_fused_epoch(self) -> None:
        loader = self.train_dataloader
        base = _base_dataset(loader.dataset)
        node, chain = loader.dataset, []
        while hasattr(node, "indices"):
            chain.append(np.asarray(node.indices))
            node = node.dataset
        if chain:
            indices = chain[-1]
            for level in reversed(chain[:-1]):
                indices = indices[level]
        else:
            indices = np.arange(len(base))
        self._train_indices = indices
        feats = base._features[indices].reshape(len(indices), -1).astype(np.float32)
        dev_idx = torch.as_tensor(indices, device=self.device)
        self._feats_bank = torch.as_tensor(feats, device=self.device)
        self._text_train_bank = self._text_bank[dev_idx]
        self._text2_train_bank = (self._impression_bank[dev_idx]
                                  if self._impression_bank is not None else None)

    def _bank_step(self, idx: torch.Tensor) -> None:
        """One train step on the bank rows ``idx``; its loss adds to the epoch total."""
        text2 = self._text2_train_bank[idx] if self._text2_train_bank is not None else None
        self._epoch_total.add_(
            self._train_step(self._feats_bank[idx], self._text_train_bank[idx], text2))

    def _capture_step(self, bs: int) -> None:
        """Capture ``_bank_step`` over a static index buffer as a CUDA graph.
        Failure raises: there is no eager fallback on the card."""
        self._graph_idx = torch.zeros(bs, dtype=torch.long, device=self.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph):
            self._bank_step(self._graph_idx)
        self._graph = graph
        logger.info(f"Captured the train step as a CUDA graph after {self._warm_steps} eager steps.")

    def _fused_epoch(self) -> float:
        if self._feats_bank is None:
            self._build_fused_epoch()
            self._epoch_total = torch.zeros((), dtype=torch.float32, device=self.device)
        n = len(self._train_indices)
        bs = self.train_dataloader.batch_size
        rng = np.random.default_rng((int(self.config.base.seed), self.current_epoch))
        order = _epoch_order(n, bs, bool(getattr(self.train_dataloader, "drop_last", False)), rng)
        steps = len(order) // bs
        if steps == 0:
            return float("nan")
        batch_idx = torch.as_tensor(order.reshape(steps, bs), device=self.device)
        cuda = self.device.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        self._epoch_total.zero_()
        if not self.use_cuda_graph:
            for step in range(steps):
                self._bank_step(batch_idx[step])
        else:
            warm = min(steps, max(0, GRAPH_WARMUP_STEPS - self._warm_steps))
            if warm:  # before the capture, on a side stream
                main = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(device=self.device)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    for step in range(warm):
                        self._bank_step(batch_idx[step])
                main.wait_stream(side)
                self._warm_steps += warm
            for step in range(warm, steps):
                if self._graph is None:
                    self._capture_step(bs)
                self._graph_idx.copy_(batch_idx[step])
                self._graph.replay()
        mean_loss = float((self._epoch_total / steps).item())  # the epoch's one read back
        if cuda:
            end.record()
            end.synchronize()
            self.timings["epoch_device_ms"].append(start.elapsed_time(end))
            self.timings["epoch_steps"].append(steps)
        return mean_loss

    def train(self) -> float:
        profile = bool(self.config.get_path("base.profile", False)) and self.current_epoch == 1
        start = time.perf_counter()
        n_samples = 0
        with maybe_trace(profile, self.config.base.tensorboard_export_dir):
            if self._fused and self.train_dataloader.sampler is None:
                epoch_loss = self._fused_epoch()
                n = len(self._train_indices)
                bs = self.train_dataloader.batch_size
                if getattr(self.train_dataloader, "drop_last", False):
                    n_samples = (n // bs) * bs
                else:  # wrap-around tail completion (see _epoch_order)
                    n_samples = -(-n // bs) * bs if n else 0
            else:
                losses = []
                for batch in self.train_dataloader:
                    feats, text, text2 = self._device_batch(batch)
                    losses.append(self._train_step(feats, text, text2))
                    n_samples += feats.shape[0]
                epoch_loss = float(torch.stack(losses).mean().item()) if losses else float("nan")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - start
        self.writer.add_scalar("loss/train", epoch_loss, self.current_epoch + 1)
        if elapsed > 0 and n_samples:
            self.writer.add_scalar("throughput/train_samples_per_s", n_samples / elapsed,
                                   self.current_epoch + 1)
        return epoch_loss

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _probe_embeddings(self, prompts) -> torch.Tensor:
        # the pooled tower output depends only on the fixed prompts: cache it
        # across epochs (the tower is frozen; only the projection changes)
        key = tuple(prompts)
        cache = self.__dict__.setdefault("_probe_pooled_cache", {})
        if key not in cache:
            tokens = self.tokenizer(prompts, padding="max_length", truncation=True,
                                    max_length=int(self.config.tokenizer.config.sequence_length))
            cache[key] = self.model.apply_text_tower(tokens)
        return l2_normalize(self.model.project_text(cache[key]))

    @torch.no_grad()
    def validate(self):
        metrics_list = self.config.experiments.config.metrics
        probes: Dict[str, torch.Tensor] = {}
        targets: Dict[str, list] = {}
        predictions: Dict[str, np.ndarray] = {}

        if "BenignMalignantDatasetLabels" in metrics_list:
            probes["malig"] = self._probe_embeddings(["Finding suggesting malignant."])
        if "MassShapeLabels" in metrics_list:
            self._shapes_list = [f"Mass shape is {label.name}." for label in MassShapeLabels]
            probes["shapes"] = self._probe_embeddings(self._shapes_list)
        if "birads" in metrics_list:
            self._birads_list = ["BIRADS unknown."] + [f"BIRADS score of {i}." for i in range(0, 7)]
            probes["birads"] = self._probe_embeddings(self._birads_list)
        for key in probes:
            targets[key] = []

        # per-batch results stay on the device; one read back per epoch
        losses = []
        sims_dev: Dict[str, list] = {key: [] for key in probes}
        logit_scale = torch.exp(self.model.logit_scale)
        for batch in self.valid_dataloader:
            feats, text, text2 = self._device_batch(batch)
            loss, out = self._loss(feats, text, text2, train=False)
            losses.append(loss)
            image_emb = out["image_embeddings"]

            prompt_labels = batch["prompt_labels"]
            if "malig" in probes:
                first = prompt_labels[0]["BenignMalignantDatasetLabels"]
                if isinstance(first, (int, np.integer)):
                    y = [int(pl["BenignMalignantDatasetLabels"]) for pl in prompt_labels]
                else:
                    y = [BenignMalignantDatasetLabels[pl["BenignMalignantDatasetLabels"]].value
                         for pl in prompt_labels]
                targets["malig"].extend(y)
                sims_dev["malig"].append((logit_scale * image_emb @ probes["malig"].T)[:, 0])
            if "shapes" in probes:
                first = prompt_labels[0]["MassShapeLabels"]
                if isinstance(first, (int, np.integer)):
                    y = [int(pl["MassShapeLabels"]) for pl in prompt_labels]
                else:
                    y = [MassShapeLabels[pl["MassShapeLabels"]].value for pl in prompt_labels]
                targets["shapes"].extend(y)
                sims_dev["shapes"].append(logit_scale * image_emb @ probes["shapes"].T)
            if "birads" in probes:
                y = [-1 if str(pl["BIRADS"]) == "unknown" else int(pl["BIRADS"]) for pl in prompt_labels]
                targets["birads"].extend(y)
                sims_dev["birads"].append(logit_scale * image_emb @ probes["birads"].T)

        for key, chunks in sims_dev.items():
            if chunks:
                predictions[key] = torch.cat(chunks).cpu().numpy()
        epoch_loss = float(torch.stack(losses).mean().item()) if losses else float("nan")
        self.writer.add_scalar("loss/val", epoch_loss, self.current_epoch + 1)

        auc_malig = auc_shapes = auc_birads = -1.0
        auc_list = []
        if "malig" in probes and len(set(targets["malig"])) > 1:
            fpr, tpr, _ = M.roc_curve(targets["malig"], predictions["malig"])
            auc_malig = M.auc(fpr, tpr)
            self.writer.add_scalar("auc/val/malig", auc_malig, self.current_epoch + 1)
            auc_list.append(auc_malig)
        for key, names, offset in (("shapes", getattr(self, "_shapes_list", []), 0),
                                   ("birads", getattr(self, "_birads_list", []), -1)):
            if key not in probes:
                continue
            preds = np.asarray(predictions[key])
            per_class = []
            for idx in range(len(names)):
                y_bin = np.asarray(targets[key]) == idx + offset  # BI-RADS unknown maps to -1
                if 0 < y_bin.sum() < len(y_bin):
                    fpr, tpr, _ = M.roc_curve(y_bin, preds[:, idx])
                    per_class.append(M.auc(fpr, tpr))
            if per_class:
                value = float(np.mean(per_class))
                self.writer.add_scalar(f"auc/val/{key}", value, self.current_epoch + 1)
                auc_list.append(value)
                if key == "shapes":
                    auc_shapes = value
                else:
                    auc_birads = value
        mean_auc = float(np.mean(auc_list)) if len(auc_list) > 1 else -1.0
        if len(auc_list) > 1:
            self.writer.add_scalar("auc/val/average", mean_auc, self.current_epoch + 1)
        return epoch_loss, auc_malig, auc_shapes, auc_birads, mean_auc

    # ------------------------------------------------------------------
    def test(self):
        from ..evaluation.evaluator import Evaluator

        logger.info("Running testing evaluator script.")
        t0 = time.perf_counter()
        Evaluator(config=self.config, test_dataloader=self.test_dataloader,
                  tokenizer=self.tokenizer, model=self.model).evaluate_experiment()
        self.timings["test_s"] = time.perf_counter() - t0

    def _scheduler_state(self) -> dict:
        """Plateau-controller state for the checkpoint (cosine schedules are
        stateless in epoch)."""
        if hasattr(self.scheduler, "step"):
            return {"scheduler": {"lr": self.scheduler.lr, "best": self.scheduler.best,
                                  "counter": self.scheduler.counter}}
        return {}

    def _host_params(self):
        from ..weights import clip_params_tree

        return clip_params_tree(self.model)

    def _host_rng_state(self) -> bytes:
        return bytes(self.generator.get_state().cpu().numpy().tobytes())

    def resume(self) -> bool:
        """Restore the train state if a checkpoint exists.  A checkpoint of
        either package restores params, bookkeeping and the AdamW count,
        moments and hyperparams; a JAX checkpoint's dropout key (threefry)
        does not map onto a ``torch.Generator``, so dropout then restarts
        from the seeded generator."""
        from ..weights import load_clip_params

        if not os.path.isfile(self.ckp_path):
            return False
        state = load_checkpoint(self.ckp_path)
        load_clip_params(self.model, state["params"])
        opt_state = state.get("torch_opt_state", state.get("opt_state"))
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        else:
            logger.warning("Checkpoint has no optimizer state; AdamW restarts from zero moments.")
        if "torch_rng_state" in state:
            self.generator.set_state(torch.frombuffer(bytearray(state["torch_rng_state"]),
                                                      dtype=torch.uint8))
        else:
            logger.warning(
                "Checkpoint has no torch.Generator state: a JAX checkpoint's dropout key is a "
                "threefry key, which does not map onto a torch.Generator; dropout restarts "
                "from the seeded generator.")
        self.current_epoch = state["epoch"] + 1
        self.early_stopper.best_score = state["best_score"]
        self.early_stopper.counter = state["counter"]
        self.early_stopper.val_loss_min = state["val_loss"]
        sched = (state.get("extra") or {}).get("scheduler")
        if sched and hasattr(self.scheduler, "step"):
            self.scheduler.lr = sched["lr"]
            self.scheduler.best = sched["best"]
            self.scheduler.counter = sched["counter"]
        return True

    def run(self):
        self._time_start = time.time()
        logger.info("Classifier training experiment started.")
        total_epochs = int(self.config.scheduler.config.epochs)

        start_epoch = self.current_epoch
        for self.current_epoch in range(start_epoch, total_epochs):
            start = time.time()
            if hasattr(self.scheduler, "lr_at"):
                lr = self.scheduler.lr_at(self.current_epoch)
                set_learning_rate(self.optimizer, lr)

            train_loss = self.train()
            val_loss, auc_malig, auc_shapes, auc_birads, mean_auc = self.validate()

            if hasattr(self.scheduler, "step"):  # plateau controller
                lr = self.scheduler.step(val_loss)
                set_learning_rate(self.optimizer, lr)
            self.writer.add_scalar("lr", lr, self.current_epoch + 1)

            elapsed = time.time() - start
            self.writer.add_scalar("epoch_time_s", elapsed, self.current_epoch + 1)

            self.early_stopper(
                validation_loss=val_loss, epoch=self.current_epoch, params=self._host_params,
                opt_state=self.optimizer.state_dict, path=self.ckp_path,
                rng_state=self._host_rng_state, extra=self._scheduler_state(),
            )
            logger.info(
                f"Epoch: {self.current_epoch + 1}/{total_epochs} | {elapsed:.1f}s | lr: {lr:.6f} | "
                f"train/loss: {train_loss:.4f} | val/loss: {val_loss:.4f} | "
                f"val/auc/malig: {auc_malig:.4f} | val/auc/shapes: {auc_shapes:.4f} | "
                f"val/auc/birads: {auc_birads:.4f} | val/auc/mean: {mean_auc:.4f}"
            )
            if self.early_stopper.early_stop:
                logger.warning(
                    f"Early stopping triggered at epoch {self.current_epoch + 1}. Ending model training.")
                break

        if len(self.config.dataset.eval.enum_classes) > 0 and self.test_dataloader is not None:
            self.test()

        self._time_end = time.time()
        logger.info("Experiment complete. Total time (H:M:S): "
                    + time.strftime("%H:%M:%S", time.gmtime(self._time_end - self._time_start)))
        self.writer.close()


def create_experiment(experiment_name: str):
    """Name -> experiment class (reference: experiments_controller.py:3-23)."""
    return EXPERIMENTS.get(experiment_name)
