"""The parallel layer (port of mmgclip_tpu/parallel): a named mesh over the
ranks of a ``torch.distributed`` process group, its collectives (and their
plain versions over per-rank lists in one process), the ring all-gather
transport between processes, the global contrastive losses, ZeRO-1, expert
and tensor parallelism, the GPipe pipeline and the multi-process launcher."""

from .collectives import (
    all_gather,
    axis_index,
    check_ring,
    launch_ring_all_gather,
    pmean,
    ppermute,
    psum,
    reduce_scatter,
    release_workspaces,
    ring_all_gather,
    ring_all_gather_diff,
    ring_all_gather_plain,
)
from .contrastive import global_clip_loss, global_mmgclip_loss
from .expert import moe_param_specs, shard_moe_params
from .mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SLICE_AXIS,
    batch_sharding,
    create_mesh,
    create_multislice_mesh,
    put_global,
    replicate,
    replicated,
    shard_batch,
)
from .multihost import initialize_distributed
from .pipeline import pipeline_forward, pipelined_bert_forward
from .tensor_parallel import shard_text_tower, text_tower_specs
from .zero import shard_opt_state, zero1_shardings

__all__ = [
    "all_gather",
    "axis_index",
    "check_ring",
    "global_clip_loss",
    "global_mmgclip_loss",
    "initialize_distributed",
    "launch_ring_all_gather",
    "moe_param_specs",
    "pipeline_forward",
    "pipelined_bert_forward",
    "pmean",
    "ppermute",
    "psum",
    "put_global",
    "reduce_scatter",
    "release_workspaces",
    "ring_all_gather",
    "ring_all_gather_diff",
    "ring_all_gather_plain",
    "shard_moe_params",
    "shard_opt_state",
    "shard_text_tower",
    "text_tower_specs",
    "zero1_shardings",
    "DATA_AXIS",
    "EXPERT_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SLICE_AXIS",
    "batch_sharding",
    "create_mesh",
    "create_multislice_mesh",
    "replicate",
    "replicated",
    "shard_batch",
]
