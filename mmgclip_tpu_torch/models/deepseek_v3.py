"""The DeepSeek-V3 family as a frozen CLIP text tower (Moonlight-16B-A3B at
its published widths; LLM2CLIP, arXiv:2411.04997, pools a language model's
hidden state the same way).  The JAX package has no counterpart.

The layer equations (HF ``modeling_deepseek.py`` with ``q_lora_rank`` None,
``scoring_func`` sigmoid, ``topk_method`` noaux_tc, ``n_group`` =
``topk_group`` = 1, no RoPE scaling):

* attention (MLA): h = RMSNorm(x); q = h W_q, per head ``q_nope`` (128) and
  ``q_pe`` (64); h W_kva = [c_kv (512), k_pe (64, shared by every head)];
  c_kv = RMSNorm(c_kv); c_kv W_kvb = per head [k_nope (128), v (128)].
  RoPE rotates ``q_pe`` and ``k_pe`` on adjacent pairs (2i, 2i + 1) at
  theta^(-2i / 64), positions 0..L-1 over each row's valid prefix (what
  DeepSeek's code reaches by de-interleaving before ``rotate_half``; the
  scores are the same).  Scores q.k / sqrt(192) in float32 under the causal
  and padding masks, softmax, P v, then W_o; x += that.
* MLP: h = RMSNorm(x).  Layers before ``first_k_dense_replace`` are a dense
  SwiGLU (``intermediate_size``); the rest are MoE: s = sigmoid(h W_g^T) in
  float32, the experts are the top-k of s + b (``e_score_correction_bias``,
  selection only), their weights s / (sum of the chosen s + 1e-20) *
  ``routed_scaling_factor``; y = sum_e w_e SwiGLU_e(h) + SwiGLU_shared(h),
  the shared MLP ``n_shared_experts`` x ``moe_intermediate_size`` wide.
* a final RMSNorm (float32 out); the CLIP head EOS-pools the last valid token.

Departures: no ``lm_head`` and no multi-token-prediction layers (a text
tower uses neither).  Precision: bfloat16 weights and activations with
float32 accumulation; RMSNorm statistics, RoPE, the scores and the router in
float32.  Every RMSNorm goes through ``ops/rms_norm.py`` (on the card one
pass over each bf16 row, ``kv_a_layernorm`` reading the split ``c_kv`` view
in place; on the CPU its plain version).  The routed experts go through
``ops/moe_experts.py`` (the grouped CUDA kernel on the card, its plain
version on the CPU); the attention after
its projections (RoPE, scores under the causal and padding masks, softmax,
P v) through ``ops/mla_attention.py`` (on the card a causal latent-attention
kernel that reads the projections in place and rotates ``q_pe`` and the
shared ``k_pe`` as it loads them, with no float32 copy; on the CPU its plain
version); the projections and every other product are plain ``torch``
(cuBLAS).

Parameters use HuggingFace's ``[out, in]`` layout under HF-like names, the
routed experts stacked: ``w_gate_up`` ``[E, 2 I, D]`` (each expert's gate
rows, then its up rows) and ``w_down`` ``[E, D, I]``.  The tower is built on
a device (seeded init there) or on ``meta`` and then loaded by
``load_deepseek_v3_weights`` from HF names, so its weights never pass
through the host.

Tracing: while a profiler session records (``utils/profiling.py``), a
forward on the card marks CUDA events in each MoE layer around its routing
(gate, top-k, sort, offsets) and its experts (the grouped kernel, the
combine and the shared experts), hands them up with its tokens per expert
(``Tracer.collect``), and the forward records them once done, under the
caller's open span (the bank chunk's): ``moe.route`` and ``moe.experts`` per
layer and one ``moe.tokens_per_expert`` counter ``[MoE layers, experts]``
(its read-back is the forward's one synchronization, made only then).
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import rms_norm as norms
from ..ops.mla_attention import mla_attention
from ..ops.moe_experts import dispatch, moe_experts
from ..utils.profiling import recorder

# keys of the published config.json that this tower takes only at one value
FIXED_KEYS = {"q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
              "n_group": 1, "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu",
              "attention_bias": False, "rope_scaling": None}


@dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def from_overrides(overrides: Dict) -> "DeepseekV3Config":
        """The fields named in ``networks.text_encoder.config`` (other keys,
        such as ``dtype`` or ``pad_trim_multiple``, are the caller's); a
        published key this tower takes at one value only must have it."""
        for key, value in FIXED_KEYS.items():
            if key in overrides and overrides[key] != value:
                raise ValueError(f"DeepseekV3TextEncoder takes {key}={value!r}, "
                                 f"got {overrides[key]!r}")
        kwargs = {}
        for f in dataclasses.fields(DeepseekV3Config):
            if f.name in overrides and f.name != "dtype":
                kind = type(f.default)
                kwargs[f.name] = kind(overrides[f.name])
        return DeepseekV3Config(**kwargs)

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


def parameter_count(config: DeepseekV3Config) -> int:
    """The tower's parameters (no ``lm_head``), from the config alone."""
    return sum(math.prod(shape) for shape in parameter_shapes(config).values())


def parameter_shapes(config: DeepseekV3Config) -> Dict[str, tuple]:
    """The module's ``state_dict`` names -> shapes."""
    c = config
    D, H = c.hidden_size, c.num_attention_heads
    out = {"embed_tokens": (c.vocab_size, D), "norm.weight": (D,)}
    for i in range(c.num_hidden_layers):
        p = f"layers.{i}."
        out.update({p + "input_layernorm.weight": (D,), p + "post_attention_layernorm.weight": (D,),
                    p + "self_attn.q_proj": (H * c.q_head_dim, D),
                    p + "self_attn.kv_a_proj_with_mqa": (c.kv_lora_rank + c.qk_rope_head_dim, D),
                    p + "self_attn.kv_a_layernorm.weight": (c.kv_lora_rank,),
                    p + "self_attn.kv_b_proj": (H * (c.qk_nope_head_dim + c.v_head_dim),
                                                c.kv_lora_rank),
                    p + "self_attn.o_proj": (D, H * c.v_head_dim)})
        if c.is_moe(i):
            E, I = c.n_routed_experts, c.moe_intermediate_size
            out.update({p + "mlp.gate": (E, D), p + "mlp.e_score_correction_bias": (E,),
                        p + "mlp.w_gate_up": (E, 2 * I, D), p + "mlp.w_down": (E, D, I)})
            if c.n_shared_experts:
                S = c.n_shared_experts * I
                out.update({p + "mlp.shared_experts.gate_proj": (S, D),
                            p + "mlp.shared_experts.up_proj": (S, D),
                            p + "mlp.shared_experts.down_proj": (D, S)})
        else:
            out.update({p + "mlp.gate_proj": (c.intermediate_size, D),
                        p + "mlp.up_proj": (c.intermediate_size, D),
                        p + "mlp.down_proj": (D, c.intermediate_size)})
    return out


def rope_tables(positions: int, dim: int, theta: float, device) -> tuple:
    """cos, sin ``[positions, dim // 2]`` in float32: pair i turns at theta^(-2i / dim)."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    angles = torch.arange(positions, dtype=torch.float32, device=device)[:, None] * inv[None]
    return angles.cos(), angles.sin()


def _param(shape, dtype, device, generator, std: Optional[float], fill: float = 0.0):
    """A frozen parameter: normal(0, std) from ``generator`` or ``fill``
    (``std`` None); nothing drawn on ``meta``."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if t.device.type != "meta":
        if std is None:
            t.fill_(fill)
        else:
            t.normal_(0.0, std, generator=generator)
    return nn.Parameter(t, requires_grad=False)


class _Params:
    """Draws the parameters in construction order: normal(0, 0.02) for the
    projections and embedding (the published ``initializer_range``), ones
    for the norms, zeros for the selection bias."""

    def __init__(self, config: DeepseekV3Config, device, generator):
        self.dtype, self.device, self.generator = config.dtype, device, generator

    def weight(self, *shape):
        return _param(shape, self.dtype, self.device, self.generator, 0.02)

    def ones(self, *shape):
        return _param(shape, self.dtype, self.device, self.generator, None, 1.0)

    def zeros_f32(self, *shape):
        return _param(shape, torch.float32, self.device, self.generator, None, 0.0)


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float, build: _Params):
        super().__init__()
        self.eps = eps
        self.weight = build.ones(width)

    def forward(self, x: torch.Tensor, dtype=None, gate: Optional[torch.Tensor] = None):
        return norms.rms_norm(x, self.weight, self.eps, dtype, gate)


class Attention(nn.Module):
    """Latent attention, without query compression (module docstring)."""

    def __init__(self, c: DeepseekV3Config, build: _Params):
        super().__init__()
        self.c = c
        D, H = c.hidden_size, c.num_attention_heads
        self.q_proj = build.weight(H * c.q_head_dim, D)
        self.kv_a_proj_with_mqa = build.weight(c.kv_lora_rank + c.qk_rope_head_dim, D)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps, build)
        self.kv_b_proj = build.weight(H * (c.qk_nope_head_dim + c.v_head_dim), c.kv_lora_rank)
        self.o_proj = build.weight(D, H * c.v_head_dim)

    def forward(self, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                keys: torch.Tensor) -> torch.Tensor:
        c = self.c
        q = F.linear(h, self.q_proj)
        c_kv, k_pe = F.linear(h, self.kv_a_proj_with_mqa).split(
            [c.kv_lora_rank, c.qk_rope_head_dim], dim=-1)
        kv = F.linear(self.kv_a_layernorm(c_kv), self.kv_b_proj)
        ctx = mla_attention(q, k_pe, kv, cos, sin, keys, c.num_attention_heads)
        return F.linear(ctx, self.o_proj)


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(h)) * up(h))."""

    def __init__(self, width: int, c: DeepseekV3Config, build: _Params):
        super().__init__()
        self.gate_proj = build.weight(width, c.hidden_size)
        self.up_proj = build.weight(width, c.hidden_size)
        self.down_proj = build.weight(c.hidden_size, width)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.linear(F.silu(F.linear(h, self.gate_proj)) * F.linear(h, self.up_proj),
                        self.down_proj)


class MoE(nn.Module):
    """Sigmoid router with a selection bias, top-k routed SwiGLU experts
    (``ops.moe_experts``) and the shared experts.

    ``held``: the routed experts this layer holds (expert parallelism: a
    range of the router's ``n_routed_experts``; default all).  The router
    keeps its full width and normalizes the weights over all k chosen
    experts, held or not; the layer returns the held experts' weighted rows
    and the shared experts, and computes nothing for the others.  The stacks
    hold the held experts in order (row j is expert ``held[j]``)."""

    def __init__(self, c: DeepseekV3Config, build: _Params, held: Optional[range] = None):
        super().__init__()
        self.c = c
        E, I, D = c.n_routed_experts, c.moe_intermediate_size, c.hidden_size
        self.held = range(E) if held is None else held
        self.gate = build.weight(E, D)
        self.e_score_correction_bias = build.zeros_f32(E)
        self.w_gate_up = build.weight(len(self.held), 2 * I, D)
        self.w_down = build.weight(len(self.held), D, I)
        self.shared_experts = (MLP(c.n_shared_experts * I, c, build) if c.n_shared_experts
                               else None)

    def route(self, x: torch.Tensor):
        """``x`` ``[T, D]`` -> (experts ``[T, k]`` int64, weights ``[T, k]``
        float32), the router in float32 as the published gate computes it."""
        c = self.c
        scores = torch.sigmoid(F.linear(x.float(), self.gate.float()))
        chosen = torch.topk(scores + self.e_score_correction_bias.float(), c.num_experts_per_tok,
                            dim=-1).indices
        weights = scores.gather(1, chosen)
        if c.num_experts_per_tok > 1 and c.norm_topk_prob:
            weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
        return chosen, weights * c.routed_scaling_factor

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, s, D = h.shape
        x = h.reshape(b * s, D)
        tracer = recorder()
        start = tracer.mark(h.device)
        experts, weights = self.route(x)
        plan = dispatch(experts, self.c.n_routed_experts, self.held)
        routed = tracer.mark(h.device)
        y = moe_experts(x, plan, weights, self.w_gate_up, self.w_down)
        if self.shared_experts is not None:
            y = y + self.shared_experts(x).float()
        y = y.to(h.dtype).view(b, s, D)
        tracer.collect((start, routed, tracer.mark(h.device), plan.counts))
        return y


def _record_moe(tracer, layers, **attrs) -> None:
    """Record a forward's MoE layers (module docstring): ``layers``, each
    one's (start, routed, end) marks and tokens per expert, or None;
    ``attrs`` go on the counter."""
    if not layers:
        return
    parent = tracer.current()
    counts = torch.stack([c for *_marks, c in layers]).tolist()  # waits for the forward
    for i, (start, routed, end, _c) in enumerate(layers):
        tracer.interval("moe.route", start, routed, parent, layer=i)
        tracer.interval("moe.experts", routed, end, parent, layer=i)
    tracer.interval("moe.tokens_per_expert", end, end, parent, counts=counts, **attrs)


class DecoderLayer(nn.Module):
    def __init__(self, c: DeepseekV3Config, index: int, build: _Params):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, build)
        self.self_attn = Attention(c, build)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, build)
        self.mlp = MoE(c, build) if c.is_moe(index) else MLP(c.intermediate_size, c, build)

    def forward(self, x: torch.Tensor, cos, sin, keys) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, keys)
        return x + self.mlp(self.post_attention_layernorm(x))


def attention_masks(attention_mask: torch.Tensor) -> torch.Tensor:
    """``[b, s]`` -> ``[b, 1, s, s]``: causal, and only the valid keys (the
    plain attention's mask; the kernel applies the same rule itself)."""
    s = attention_mask.shape[1]
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=attention_mask.device))
    return causal[None, None] & (attention_mask[:, None, None, :] > 0)


class DeepseekV3TextEncoder(nn.Module):
    """Embedding, decoder layers and the final RMSNorm; returns the float32
    ``last_hidden_state`` ``[b, s, D]``.

    ``device``: where the parameters live; ``meta`` draws nothing (load
    them with ``load_deepseek_v3_weights``).  ``generator`` draws the seeded
    init and must be on ``device`` (a CPU generator for the CPU)."""

    def __init__(self, config: DeepseekV3Config, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.config = c = config
        device = torch.device("cpu" if device is None else device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        build = _Params(c, device, generator)
        self.embed_tokens = build.weight(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(c, i, build) for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, build)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.config
        b, s = input_ids.shape
        device = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32, device=device)
        x = self.embed_tokens[input_ids.long()]
        cos, sin = rope_tables(s, c.qk_rope_head_dim, c.rope_theta, device)
        tracer = recorder()
        moe_layers = tracer.collecting()
        for layer in self.layers:
            x = layer(x, cos, sin, attention_mask)
        out = self.norm(x, torch.float32)
        _record_moe(tracer, moe_layers)
        return out


# ----------------------------------------------------------------------
# HuggingFace names
# ----------------------------------------------------------------------
_EXPERT = re.compile(r"^layers\.(\d+)\.mlp\.experts\.(\d+)\.(gate|up|down)_proj\.weight$")
_LEFT_OUT = re.compile(r"^(lm_head\.|layers\.(\d+)\.)")  # lm_head; MTP layers past the last


def _hf(name: str) -> str:
    """A module parameter's name (not a routed stack) -> its HF name."""
    if name.endswith(".e_score_correction_bias"):
        return name.replace(".e_score_correction_bias", ".gate.e_score_correction_bias")
    return name if name.endswith(".weight") else name + ".weight"


def hf_names(config: DeepseekV3Config) -> List[str]:
    """Every HF name the tower reads (without ``model.``)."""
    out = []
    for name in parameter_shapes(config):
        stem, _, leaf = name.rpartition(".")
        if leaf in ("w_gate_up", "w_down"):
            projs = ("gate", "up") if leaf == "w_gate_up" else ("down",)
            out += [f"{stem}.experts.{j}.{p}_proj.weight"
                    for j in range(config.n_routed_experts) for p in projs]
        else:
            out.append(_hf(name))
    return out


def _assign(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Set the parameter ``name``: copy into it, or take ``value`` itself
    where the parameter is still on ``meta``."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    current = getattr(owner, leaf)
    if current.shape != value.shape:
        raise ValueError(f"{name}: shape {tuple(value.shape)}, the tower takes {tuple(current.shape)}")
    if current.device.type == "meta":
        setattr(owner, leaf, nn.Parameter(value.to(current.dtype), requires_grad=False))
    else:
        current.copy_(value)


@torch.no_grad()
def load_deepseek_v3_weights(module: DeepseekV3TextEncoder, state_dict: Dict[str, torch.Tensor],
                             device=None, strict: bool = True) -> List[str]:
    """Load HF-named weights (``model.layers.{i}.self_attn.q_proj.weight``,
    ``model.layers.{i}.mlp.experts.{j}.gate_proj.weight``,
    ``model.layers.{i}.mlp.gate.e_score_correction_bias``, ...; ``model.``
    optional) into the tower, in place.  Each tensor the tower reads is
    popped from ``state_dict`` as it goes, so memory peaks near one copy:
    a tensor of the tower's dtype on its device becomes the parameter
    itself; the routed experts are copied into their ``[E, ...]`` stacks
    (allocated on first touch where the tower is on ``meta``).  ``device``:
    where parameters still on ``meta`` go (default: each source's device).
    ``lm_head`` and MTP layers are left in ``state_dict``.  ``strict``:
    every name of ``hf_names`` must have been read.  -> the names read."""
    c = module.config
    I = c.moe_intermediate_size
    names = {_hf(n): n for n, _ in module.named_parameters()}
    read = []
    for key in list(state_dict):
        hf = key[len("model."):] if key.startswith("model.") else key
        left_out = _LEFT_OUT.match(hf)
        if left_out and (hf.startswith("lm_head.") or int(left_out.group(2)) >= c.num_hidden_layers):
            continue
        if ".shared_experts." in hf and not c.n_shared_experts:
            del state_dict[key]  # a tower built without them
            continue
        value = torch.as_tensor(state_dict.pop(key))
        if device is not None:
            value = value.to(device)
        expert = _EXPERT.match(hf)
        if expert:
            layer, j, proj = int(expert.group(1)), int(expert.group(2)), expert.group(3)
            moe = module.layers[layer].mlp
            leaf = "w_down" if proj == "down" else "w_gate_up"
            stack = getattr(moe, leaf)
            if stack.device.type == "meta":
                stack = nn.Parameter(torch.empty(stack.shape, dtype=stack.dtype, device=value.device),
                                     requires_grad=False)
                setattr(moe, leaf, stack)
            rows = {"gate": slice(0, I), "up": slice(I, 2 * I), "down": slice(None)}[proj]
            stack[j, rows].copy_(value)
        else:
            if hf not in names:
                raise KeyError(f"{key}: not a DeepSeek-V3 tower weight")
            _assign(module, names[hf], value)
        read.append(hf)
        del value
    if strict:
        missing = sorted(set(hf_names(c)) - set(read))
        if missing:
            raise KeyError(f"{len(missing)} weights missing, e.g. {missing[:3]}")
    return read


def read_snapshot(module: nn.Module, path: str, device, load=None, names=None) -> None:
    """Load an HF snapshot (a directory of ``*.safetensors`` shards, or one
    file) shard by shard onto ``device``: the host holds one shard at a time.
    ``load`` / ``names``: another tower's loader and ``hf_names`` (default
    this module's)."""
    load = load_deepseek_v3_weights if load is None else load
    names = hf_names if names is None else names
    import glob
    import os

    from ..utils.safetensors_lite import load_file

    files = (sorted(glob.glob(os.path.join(path, "*.safetensors"))) if os.path.isdir(path)
             else [path])
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    read: List[str] = []
    for file in files:
        read += load(module, load_file(file), device=device, strict=False)
    missing = sorted(set(names(module.config)) - set(read))
    if missing:
        raise KeyError(f"{path}: {len(missing)} weights missing, e.g. {missing[:3]}")
