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
  later step is one index copy and one replay.  The dropout key is JAX's
  threefry key as an int64 ``[2]`` tensor on the device: each step splits it
  (``jax.random.split``) and copies the new key into it in place, inside the
  graph, so replays draw JAX's masks and checkpoints carry the key in JAX's
  form (``rng_key``); a capture that fails raises.  On the ResNet path the
  captured step holds the tower's forward and the ``layer4`` backward (the
  frozen stages have ``requires_grad=False``; AdamW skips them);
* a sampler switches to the per-batch loop over the loader;
* validation probes (malignancy / mass-shape / BI-RADS zero-shot AUCs, with
  the pooled probe prompts cached) match the reference's metric set.

Across processes (``parallel/multihost.py``: one rank each) the trainer
lays the ranks out as the JAX trainer lays out devices: a [data, model] (or
[data, pipe]) mesh whose data size is ``gcd(batch, ranks // second)``, with
the JAX package's errors and warning.  Each rank then takes its rows of
every batch of the epoch's shared order, projects them (dropout draws the
global batch's masks, ``projections.global_rows``), and the embeddings are
gathered (on the card through the ring transport, ``csrc/ring_all_gather.cu``)
for the global [n, n] loss, which every rank computes whole; a head that is
not row by row (BatchNorm, MoE) runs on the whole batch.  The loss is
divided by the mesh's size for the backward and the gradients of the
replicated parameters are summed over the mesh, which gives the
single-process gradient.  ``parallel.model_axis`` splits the frozen BERT
bank's encode in the Megatron layout and, with a MoE head and
``parallel.expert_sharding``, the experts; ``parallel.pipeline_stages``
pipelines the bank's layers; ``optimizer.config.zero_sharding`` shards the
AdamW moments over ``data`` (skipped, as in JAX, when the experts are
split).  Rank 0 alone writes checkpoints, scalars and ``results.json``, in
the layout a single-process run of either package reads.  With more than
one rank the epoch runs eagerly: gloo, which ranks sharing a card use,
cannot be captured in a CUDA graph.
"""

from __future__ import annotations

import math
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
from ..models.projections import LinearProjectionLayer, MLPProjectionHead, MultiLinearHead, global_rows
from ..ops import dropout as dropout_op
from ..parallel import collectives as C
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, batch_rows, create_mesh, process_index, world_size
from ..prompts.enums import BenignMalignantDatasetLabels, MassShapeLabels
from ..utils import prng
from ..utils.logging import logger
from ..utils.profiling import maybe_trace
from ..utils.seeding import create_directory_if_not_exists
from ..utils.tb import ScalarWriter
from .checkpoint import load_checkpoint
from .early_stopping import EarlyStopper
from .optim import create_optimizer, create_scheduler, resnet_finetune_mask, set_learning_rate


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


# heads whose rows do not depend on each other: a data-parallel rank runs them
# on its own rows (a BatchNorm or MoE head needs the whole batch)
_ROW_BY_ROW = (LinearProjectionLayer, MultiLinearHead, MLPProjectionHead)


class _NoWriter:
    """The scalar writer of a rank other than 0."""

    def add_scalar(self, *_args) -> None:
        pass

    def close(self) -> None:
        pass


def mesh_layout(config, n_ranks: int):
    """The JAX trainer's mesh rule (mmgclip_tpu/training/experiment.py:137-180)
    over ``n_ranks`` -> (data size, second axis size, second axis name)."""
    batch_size = int(config.dataloader.train.batch_size)
    model_axis = int(config.get_path("parallel.model_axis", 1))
    pipe_stages = int(config.get_path("parallel.pipeline_stages", 1))
    if model_axis > 1 and pipe_stages > 1:
        raise ValueError(
            "parallel.model_axis and parallel.pipeline_stages are "
            "alternative layouts for the frozen tower; set at most one > 1")
    second = max(model_axis, pipe_stages, 1)
    if n_ranks % second:
        raise ValueError(f"{n_ranks} devices cannot host a model/pipe axis of size {second}")
    avail = n_ranks // second
    data_size = math.gcd(batch_size, avail) if avail else 1
    if avail > 1 and data_size == 1:
        raise ValueError(
            f"dataloader.train.batch_size={batch_size} shares no factor "
            f"with the {avail} available data-parallel devices — training "
            f"would silently run on 1 of {avail} chips. Pick a batch size "
            f"divisible by {avail} (or by a factor of it).")
    if data_size < avail:
        logger.warning(
            f"batch_size={batch_size} is not divisible by the {avail} "
            f"available data-parallel devices: sharding over "
            f"{data_size} of {avail} (largest common factor). Use a "
            f"batch size divisible by {avail} for full data parallelism.")
    return data_size, second, PIPE_AXIS if pipe_stages > 1 else MODEL_AXIS


@EXPERIMENTS.register("classification")
class ClassifierExperiment:
    def __init__(self, config=None, train_dataloader=None, valid_dataloader=None,
                 test_dataloader=None, tokenizer=None, device=None,
                 init_params: Optional[Dict] = None):
        """``init_params``: a JAX-layout trainable tree (nested numpy dicts) to
        start from instead of the seeded init, e.g. the JAX package's."""
        if config is None:
            raise ValueError("Missing training config object.")
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
        # dropout: jax.random.key(seed) on the device, advanced in place each step
        self.rng_key = prng.key(seed, device=self.device)

        vocab = tokenizer.vocab_size if tokenizer is not None else None
        self.model = MMGCLIP(config, seed=seed, vocab_size=vocab)
        if init_params is not None:
            from ..weights import load_clip_params

            load_clip_params(self.model, init_params)
        self.model.to(self.device)
        self.params = self.model.trainable_parameters()
        self.model.count_parameters()
        self._build_mesh(config)

        self.loss_name = config.loss.config.loss_name
        self.criterion = create_loss(self.loss_name)
        logger.info(f"Using {self.loss_name} loss.")

        # the ResNet fine-tune: only layer4 of the tower trains (the masked chain)
        freeze_mask = (resnet_finetune_mask(self.params)
                       if self.model.image_encoder_name == "ResNet50Encoder" else None)
        self.optimizer = self._create_optimizer(config, freeze_mask)
        self.scheduler = create_scheduler(config)
        logger.info(f"Using {type(self.scheduler).__name__} scheduler.")

        self.ckp_path = os.path.join(
            create_directory_if_not_exists(config.checkpoints.checkpoints_export_dir),
            config.checkpoints.checkpoints_file_name,
        )
        self.early_stopper = EarlyStopper(patience=int(config.base.patience))
        self.writer = (ScalarWriter(config.base.tensorboard_export_dir) if self.is_writer
                       else _NoWriter())
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
        self.use_cuda_graph = self.device.type == "cuda" and not self._dp
        if self.device.type == "cuda" and self._dp:
            logger.info("Data parallel over processes: the epoch runs eagerly (the gloo "
                        "collectives cannot be captured in a CUDA graph).")
        self._graph = self._graph_idx = None
        self._warm_steps = 0

    # ------------------------------------------------------------------
    # the mesh
    # ------------------------------------------------------------------
    def _build_mesh(self, config) -> None:
        """The JAX trainer's mesh over this process group's ranks; with one
        rank every path below is the single-device one."""
        n_ranks = world_size()
        self._model_axis = int(config.get_path("parallel.model_axis", 1))
        self._pipe_stages = int(config.get_path("parallel.pipeline_stages", 1))
        data_size, second, second_name = mesh_layout(config, n_ranks)
        self._second_name = second_name
        self.mesh = create_mesh(data=data_size, model=second, ranks=range(data_size * second),
                                axis_names=(DATA_AXIS, second_name))
        self.is_writer = process_index() == 0
        self._dp = self.mesh.size((DATA_AXIS, second_name)) > 1
        if not self.mesh.member:
            raise ValueError(f"rank {process_index()} is outside the {data_size}x{second} mesh: "
                             f"run {data_size * second} processes")
        self._expert_sharded = False
        if (self._model_axis > 1 and self.model.projection_name == "MoEProjectionHead"
                and bool(config.get_path("parallel.expert_sharding", True))):
            from ..parallel.expert import shard_moe_params

            n_experts = int(config.projection.config.n_experts)
            for head in ("image_projection", "text_projection"):
                shard_moe_params(getattr(self.model, head), self.mesh, n_experts, MODEL_AXIS)
            self.params = self.model.trainable_parameters()
            self._expert_sharded = True
            logger.info(f"MoE expert weights sharded over the model axis "
                        f"({n_experts} experts / {self._model_axis} shards).")
        logger.info(f"Training over mesh {self.mesh.shape}.")

    def _create_optimizer(self, config, freeze_mask):
        lr = float(config.optimizer.config.learning_rate)
        wd = float(config.optimizer.config.weight_decay)
        zero_requested = bool(config.get_path("optimizer.config.zero_sharding", False))
        if zero_requested and self._expert_sharded:
            logger.warning("ZeRO-1 skipped: expert-sharded moments already partition over the mesh.")
        elif zero_requested and self.mesh.size(DATA_AXIS) > 1:
            from ..parallel.zero import ZeroAdamW

            logger.info("Optimizer state sharded over the data axis (ZeRO-1).")
            return ZeroAdamW(self.params, lr, wd, self.mesh, trainable=freeze_mask)
        optimizer = create_optimizer(self.params, lr, wd, freeze_mask=freeze_mask)
        if self._expert_sharded:
            from ..parallel.expert import expert_block, expert_names, gather_experts

            for name, head in expert_names(self.params, self.model).items():
                optimizer.sharded[name] = (lambda t, h=head: gather_experts(t, h),
                                           lambda t, h=head: expert_block(t, h))
        return optimizer

    def barrier(self) -> None:
        """Wait for every rank of the mesh (after rank 0 wrote a checkpoint)."""
        group = self.mesh.group((DATA_AXIS, self._second_name))
        if group is not None:
            torch.distributed.barrier(group=group)

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
        tower = self._text_tower()
        for start in range(0, n, chunk):
            piece = {k: np.asarray(v[start: start + chunk]) for k, v in tokens.items()}
            valid = piece["input_ids"].shape[0]
            target = chunk if (valid < chunk and n > chunk) else valid
            if valid < target:
                pad = target - valid
                piece = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) for k, v in piece.items()}
            if self._pipe_stages > 1 and target % self._pipe_stages:
                # the pipeline splits the chunk into `stages` microbatches
                extra = -(-target // self._pipe_stages) * self._pipe_stages - target
                piece = {k: np.concatenate([v, np.repeat(v[-1:], extra, axis=0)])
                         for k, v in piece.items()}
            # the tower at the bank's trimmed width (apply_text_tower would
            # trim each chunk again)
            ids, mask = (torch.as_tensor(piece[k], device=self.device)
                         for k in ("input_ids", "attention_mask"))
            types = piece.get("token_type_ids")
            types = None if types is None else torch.as_tensor(types, device=self.device)
            hidden = tower(ids, mask, types)
            outs.append(eos_pool(hidden, mask)[:valid])
        bank = (torch.cat(outs) if outs
                else torch.zeros((0, self.model.text_output_dimension), device=self.device))
        logger.info(f"Cached frozen text features for {n} rows.")
        return bank

    def _text_tower(self):
        """The frozen tower for the bank encode, laid out as the parallel
        knobs say: Megatron TP over ``model`` or the GPipe pipeline over
        ``pipe`` for BERT (both equal the plain tower), else the plain one."""
        from ..models.bert import BertEncoder

        module = self.model.text_module
        if self._model_axis > 1 and isinstance(module, BertEncoder):
            from ..parallel.tensor_parallel import shard_text_tower, tp_bert_forward

            shards = shard_text_tower(module, self.mesh)
            logger.info(f"Frozen text tower TP-sharded over model axis of {self._model_axis}.")
            return lambda ids, mask, types: tp_bert_forward(module, shards, ids, mask, types,
                                                            mesh=self.mesh)
        if self._pipe_stages > 1 and isinstance(module, BertEncoder):
            from ..parallel.pipeline import pipelined_bert_forward

            logger.info(f"Frozen text tower pipelined over {self._pipe_stages} stages.")
            return lambda ids, mask, types: pipelined_bert_forward(
                module, ids, mask, mesh=self.mesh, token_type_ids=types)
        return lambda ids, mask, types: module(ids, attention_mask=mask, token_type_ids=types)

    # ------------------------------------------------------------------
    def _loss(self, image_features, text_features, text_features2, key=None):
        out = self.model({"image_features": image_features}, train=key is not None, key=key,
                         text_features=text_features, text_features2=text_features2)
        loss, _labels = self.criterion(**out)
        return loss, out

    def _step_key(self) -> torch.Tensor:
        """``self.rng_key, step_key = jax.random.split(self.rng_key)``, the new
        key copied into the key tensor in place (no read back)."""
        keys = dropout_op.split(self.rng_key, 2)
        self.rng_key.copy_(keys[0])
        return keys[1]

    def _train_step(self, image_features, text_features, text_features2) -> torch.Tensor:
        """One step over a whole batch (every rank holds it; with data
        parallelism each projects its own rows)."""
        self.optimizer.zero_grad()
        if self._dp:
            loss = self._dp_loss(image_features, text_features, text_features2, self._step_key())
            (loss / self.mesh.size((DATA_AXIS, self._second_name))).backward()
            self._sync_grads()
        else:
            loss, _out = self._loss(image_features, text_features, text_features2, self._step_key())
            loss.backward()
        self.optimizer.step()
        return loss.detach()

    # ------------------------------------------------------------------
    # data parallelism
    # ------------------------------------------------------------------
    def _gather_rows(self, emb: torch.Tensor) -> torch.Tensor:
        """This rank's embeddings -> the batch's, over ``data`` (the ring
        transport on the card; its transpose returns each rank its rows'
        gradient)."""
        if emb.is_cuda:
            return C.ring_all_gather_diff(emb, DATA_AXIS, mesh=self.mesh)
        return C.all_gather(emb, DATA_AXIS, mesh=self.mesh)

    def _dp_embed(self, head, features: torch.Tensor, key, image: bool, rows: slice) -> torch.Tensor:
        """``MMGCLIP.embed`` of the whole batch, data parallel.  A head that
        works row by row runs on this rank's rows and its embeddings are
        gathered; another runs on the whole batch on every rank."""
        if head is None or isinstance(head, _ROW_BY_ROW):
            with global_rows(rows.start, features.shape[0]):
                local = self.model.embed(head, features[rows], key, image, train=True)
            return self._gather_rows(local)
        return self.model.embed(head, features, key, image, train=True)

    def _dp_loss(self, image_features, text_features, text_features2, key) -> torch.Tensor:
        """The model's forward + the criterion, each rank projecting its rows."""
        rows = batch_rows(self.mesh, image_features.shape[0])
        out = self.model({"image_features": image_features}, train=True, key=key,
                         text_features=text_features, text_features2=text_features2,
                         embed=lambda head, features, head_key, image: self._dp_embed(
                             head, features, head_key, image, rows))
        C.check_ring(image_features.device)
        return self.criterion(**out)[0]

    def _sync_grads(self) -> None:
        """Sum each parameter's gradient over the ranks that hold it: the
        whole mesh for a replicated one (ZeRO sums over ``data`` itself),
        ``data`` for a split expert leaf."""
        from ..parallel.expert import expert_names

        experts = expert_names(self.params, self.model)
        zero = hasattr(self.optimizer, "sharded_names")
        axes = self._second_name if zero else (DATA_AXIS, self._second_name)
        groups = {axes: [], DATA_AXIS: []}
        for name, p in self.params.items():
            if p.grad is not None:
                groups[DATA_AXIS if name in experts else axes].append(p)
        for axis, params in groups.items():
            if not params or self.mesh.size(axis) == 1:
                continue
            flat = C.psum(torch.cat([p.grad.reshape(-1) for p in params]), axis, mesh=self.mesh)
            offset = 0
            for p in params:
                p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
                offset += p.numel()

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
            loss, out = self._loss(feats, text, text2)
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
        """The trainable tree on the host (with split experts, gathered: every
        rank calls it)."""
        from ..parallel.expert import full_experts
        from ..weights import clip_params_tree

        with full_experts(self.model):
            return clip_params_tree(self.model)

    def _host_rng_key(self) -> list:
        """``jax.random.key_data(rng_key).tolist()``: the key as written to a checkpoint."""
        return [int(v) for v in self.rng_key.cpu().tolist()]

    def resume(self) -> bool:
        """Restore the train state if a checkpoint exists.  A checkpoint of
        either package restores params, bookkeeping, the AdamW count, moments
        and hyperparams, and the dropout key."""
        from ..parallel.expert import full_experts
        from ..weights import load_clip_params

        if not os.path.isfile(self.ckp_path):
            return False
        state = load_checkpoint(self.ckp_path)
        with full_experts(self.model):  # each rank then keeps its experts of the file's
            load_clip_params(self.model, state["params"])
        opt_state = state.get("torch_opt_state", state.get("opt_state"))
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        else:
            logger.warning("Checkpoint has no optimizer state; AdamW restarts from zero moments.")
        if "rng_key" in state:
            with torch.no_grad():  # in place: a captured graph reads this tensor
                self.rng_key.copy_(torch.tensor(state["rng_key"], dtype=torch.int64))
        else:
            logger.warning("Checkpoint has no dropout key (a port checkpoint from before the key "
                           "crossed checkpoints); dropout restarts from the seeded key.")
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
                rng_key=self._host_rng_key, extra=self._scheduler_state(), writer=self.is_writer,
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
            from ..parallel.expert import full_experts

            with full_experts(self.model):
                if self.is_writer:  # results.json: rank 0 alone
                    self.test()
        self.barrier()

        self._time_end = time.time()
        logger.info("Experiment complete. Total time (H:M:S): "
                    + time.strftime("%H:%M:%S", time.gmtime(self._time_end - self._time_start)))
        self.writer.close()


def create_experiment(experiment_name: str):
    """Name -> experiment class (reference: experiments_controller.py:3-23)."""
    return EXPERIMENTS.get(experiment_name)
