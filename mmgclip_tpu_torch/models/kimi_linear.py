"""Kimi-Linear (Kimi-Linear-48B-A3B at its published widths; "Kimi Linear",
arXiv:2510.26692) as a frozen CLIP text tower, EOS-pooled as LLM2CLIP pools
a language model.  The JAX package has no counterpart.

A hybrid stack: the layers that ``linear_attn_config`` lists as
``kda_layers`` (1-indexed) are Kimi Delta Attention, those it lists as
``full_attn_layers`` latent attention without positions; every layer's MLP
is DeepSeek-V3's (``deepseek_v3.py``: a dense SwiGLU before
``first_k_dense_replace``, then the MoE).  The layer equations, with
h = RMSNorm(x):

* KDA (H = ``num_heads`` heads of d = ``head_dim``): q~, k~, v~ = h W_q,
  h W_k, h W_v (each H d wide); q, k, v = silu(causal depthwise conv_4 of
  each), no bias, zeros before position 0; q and k L2-normalized per head
  (rsqrt(sum of squares + 1e-6)); the decay f = (h W_fa) W_fb (D -> d -> H d),
  g = -exp(A_log[head]) softplus(f + dt_bias) in float32 (``dt_bias`` one a
  channel), alpha = exp(g); beta = sigmoid(h W_b), one a head; per head the
  state S [d, d] in float32 from 0: S <- diag(alpha_t) S; S <- S + beta_t k_t
  (v_t - S^T k_t)^T; o_t = d^-1/2 S^T q_t.  The output gate r = (h W_ga) W_gb
  + b_g (D -> d -> H d); y = RMSNorm_d(o) w_norm * sigmoid(r) per head (one
  ``o_norm`` weight of d shared by the heads, ``rms_norm_eps``);
  x += y W_o.
* MLA (``mla_use_nope``): Moonlight's latent attention (``deepseek_v3.py``)
  without rotation: ``q_pe`` and ``k_pe`` stay as projected, still in the
  scores, scaled by 1 / sqrt(qk_nope + qk_rope).
* MoE: DeepSeek-V3's noaux_tc router (sigmoid scores, selection bias, the
  top ``num_experts_per_token`` of ``num_experts``, weights renormalized
  over the chosen and times ``routed_scaling_factor``), SwiGLU experts of
  ``moe_intermediate_size`` and ``num_shared_experts`` shared.  The layer
  holds the experts ``experts_held`` (expert parallelism: one card's share
  of a deployment over several); it routes over all of them, normalizes
  over all k chosen, and returns its own experts' weighted rows plus the
  shared expert, nothing for the others.  That partial result goes on to
  the next layer.
* a final RMSNorm (float32 out).

Departures: no ``lm_head`` (a text tower uses none).  Precision: bfloat16
weights and activations with float32 accumulation; RMSNorm statistics, the
router, the KDA scan and its gates in float32; ``A_log`` and ``dt_bias``
float32 parameters, as the published model keeps them.  The KDA scan goes
through ``ops/kda.py`` (on the card a kernel fusing the convolutions, norms,
gates and the recurrence; on the CPU its chunked plain version), the norms
and the output gate through ``ops/rms_norm.py`` (on the card one pass over
each row, the gate its epilogue, with no float32 copy), the attention
through ``ops/mla_attention.py`` (its NoPE path), the routed experts through
``ops/moe_experts.py`` over the held range; projections are plain ``torch``
(cuBLAS).  Padding is right padding: the scan is causal, so
it takes each row's valid length and needs no mask.

Parameters use HF's ``[out, in]`` layout and Kimi's published module names
(``q_conv1d``, ``f_a_proj`` / ``f_b_proj``, ``g_a_proj`` / ``g_b_proj``,
``b_proj``, ``A_log``, ``dt_bias``, ``o_norm``; the convolutions ``[H d, 1,
4]``), the MLA, MLP and MoE under DeepSeek-V3's names, the held experts
stacked as there.  The tower is built on a device (seeded init there) or on
``meta`` and then loaded by ``load_kimi_linear_weights``.

Tracing, as ``deepseek_v3.py``'s (``utils/profiling.py``): under a profiler
each KDA layer marks ``kda.layer`` (input norm to ``o_proj``) and inside it
``kda.scan`` (the scan kernel), each MoE layer its ``moe.route`` and
``moe.experts``; the forward records them once done under the caller's open
span, with one ``moe.tokens_per_expert`` counter ``[MoE layers, held
experts]`` carrying the held range as ``held``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.kda import kda
from ..utils.profiling import recorder
from .deepseek_v3 import (MLP, Attention, DeepseekV3Config, MoE, RMSNorm, _assign, _hf, _param,
                          _Params, _record_moe)

# keys of the published config.json that this tower takes only at one value
FIXED_KEYS = {"q_lora_rank": None, "mla_use_nope": True, "moe_router_activation_func": "sigmoid",
              "num_expert_group": 1, "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu",
              "rope_scaling": None, "short_conv_kernel_size": 4}


@dataclass(frozen=True)
class KimiLinearConfig:
    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    num_experts: int = 256
    num_shared_experts: int = 1
    num_experts_per_token: int = 8
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    moe_renormalize: bool = True
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    # linear_attn_config
    kda_layers: Tuple[int, ...] = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23,
                                   25, 26)
    full_attn_layers: Tuple[int, ...] = (4, 8, 12, 16, 20, 24, 27)
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    # the routed experts this tower holds, [start, stop) of num_experts
    experts_held: Tuple[int, int] = (0, 256)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        layers = set(range(1, self.num_hidden_layers + 1))
        kda_set, full = set(self.kda_layers), set(self.full_attn_layers)
        if kda_set & full or kda_set | full != layers:
            raise ValueError(f"kda_layers and full_attn_layers must split "
                             f"1..{self.num_hidden_layers}; got {sorted(kda_set)} and {sorted(full)}")
        start, stop = self.experts_held
        if not 0 <= start < stop <= self.num_experts:
            raise ValueError(f"experts_held {self.experts_held} of {self.num_experts} experts")

    @staticmethod
    def from_overrides(overrides: Dict) -> "KimiLinearConfig":
        """The fields named in ``networks.text_encoder.config``, the published
        ``linear_attn_config`` group read into its flat fields (other keys,
        such as ``dtype``, are the caller's); a published key this tower takes
        at one value only must have it."""
        overrides = dict(overrides)
        linear = dict(overrides.pop("linear_attn_config", None) or {})
        for key, field in (("num_heads", "kda_num_heads"), ("head_dim", "kda_head_dim")):
            if key in linear:
                overrides[field] = linear.pop(key)
        for key in ("kda_layers", "full_attn_layers"):
            if key in linear:
                overrides[key] = linear.pop(key)
        for key, value in {**overrides, **linear}.items():
            if key in FIXED_KEYS and value != FIXED_KEYS[key]:
                raise ValueError(f"KimiLinearTextEncoder takes {key}={FIXED_KEYS[key]!r}, "
                                 f"got {value!r}")
        kwargs = {}
        for f in dataclasses.fields(KimiLinearConfig):
            if f.name in overrides and f.name != "dtype":
                kind = type(f.default)
                value = overrides[f.name]
                kwargs[f.name] = tuple(int(v) for v in value) if kind is tuple else kind(value)
        return KimiLinearConfig(**kwargs)

    def is_kda(self, layer: int) -> bool:
        """Layer ``layer`` (0-based) is KDA; else latent attention."""
        return layer + 1 in self.kda_layers

    @property
    def held(self) -> range:
        return range(*self.experts_held)

    def deepseek(self) -> DeepseekV3Config:
        """The MLA, MLP and MoE widths as ``deepseek_v3.py``'s config."""
        return DeepseekV3Config(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            moe_intermediate_size=self.moe_intermediate_size,
            num_hidden_layers=self.num_hidden_layers, num_attention_heads=self.num_attention_heads,
            kv_lora_rank=self.kv_lora_rank, qk_nope_head_dim=self.qk_nope_head_dim,
            qk_rope_head_dim=self.qk_rope_head_dim, v_head_dim=self.v_head_dim,
            n_routed_experts=self.num_experts, n_shared_experts=self.num_shared_experts,
            num_experts_per_tok=self.num_experts_per_token,
            first_k_dense_replace=self.first_k_dense_replace,
            routed_scaling_factor=self.routed_scaling_factor, norm_topk_prob=self.moe_renormalize,
            rope_theta=self.rope_theta, rms_norm_eps=self.rms_norm_eps, dtype=self.dtype)


class _KimiParams(_Params):
    """``_Params`` with the KDA layer's own inits: ``A_log`` = log U(1, 16),
    ``dt_bias`` the inverse softplus of a log-uniform dt in [1e-3, 1e-1]
    (Mamba-2's), both float32; the convolutions U(-0.5, 0.5)."""

    def _uniform(self, shape, low, high, dtype):
        t = _param(shape, dtype, self.device, self.generator, None)
        if t.device.type != "meta":
            t.uniform_(low, high, generator=self.generator)
        return t

    def a_log(self, heads):
        t = self._uniform((heads,), 1.0, 16.0, torch.float32)
        if t.device.type != "meta":
            t.log_()
        return t

    def dt_bias(self, width):
        t = self._uniform((width,), math.log(1e-3), math.log(1e-1), torch.float32)
        if t.device.type != "meta":
            t.exp_()
            t.copy_(t + torch.log(-torch.expm1(-t)))  # softplus(t + log(1 - e^-t)) = t
        return t

    def conv(self, width):
        return self._uniform((width, 1, 4), -0.5, 0.5, self.dtype)


class _Affine(nn.Module):
    """x W^T + b (the output gate's second projection)."""

    def __init__(self, out: int, into: int, build: _Params):
        super().__init__()
        self.weight = build.weight(out, into)
        self.bias = _param((out,), build.dtype, build.device, build.generator, None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class KimiDeltaAttention(nn.Module):
    """The KDA layer after its input norm (module docstring)."""

    def __init__(self, c: KimiLinearConfig, build: _KimiParams):
        super().__init__()
        self.c = c
        H, d, D = c.kda_num_heads, c.kda_head_dim, c.hidden_size
        self.q_proj, self.k_proj, self.v_proj = (build.weight(H * d, D) for _ in range(3))
        self.q_conv1d, self.k_conv1d, self.v_conv1d = (build.conv(H * d) for _ in range(3))
        self.A_log = build.a_log(H)
        self.f_a_proj = build.weight(d, D)
        self.f_b_proj = build.weight(H * d, d)
        self.dt_bias = build.dt_bias(H * d)
        self.b_proj = build.weight(H, D)
        self.g_a_proj = build.weight(d, D)
        self.g_b_proj = _Affine(H * d, d, build)
        self.o_norm = RMSNorm(d, c.rms_norm_eps, build)
        self.o_proj = build.weight(D, H * d)

    def forward(self, h: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        c = self.c
        H, d = c.kda_num_heads, c.kda_head_dim
        b, s, _ = h.shape
        tracer = recorder()
        q, k, v = (F.linear(h, w) for w in (self.q_proj, self.k_proj, self.v_proj))
        f = F.linear(F.linear(h, self.f_a_proj), self.f_b_proj)
        beta = F.linear(h, self.b_proj)
        lengths = keys.sum(1, dtype=torch.int32)
        start = tracer.mark(h.device)
        o = kda_scan(q, k, v, f, beta, self.q_conv1d.view(H * d, 4), self.k_conv1d.view(H * d, 4),
                     self.v_conv1d.view(H * d, 4), self.A_log, self.dt_bias, lengths)
        tracer.collect(("kda.scan", start, tracer.mark(h.device)))
        del q, k, v, f, beta
        r = self.g_b_proj(F.linear(h, self.g_a_proj))
        y = self.o_norm(o.view(b * s * H, d), gate=r.view(b * s * H, d))
        return F.linear(y.view(b, s, H * d), self.o_proj)


kda_scan = kda  # the layer calls the scan through this module's name


def mla_tables(positions: int, c: KimiLinearConfig, device) -> tuple:
    """The latent attention's rotation tables: none (``mla_use_nope``)."""
    return None, None


class KimiDecoderLayer(nn.Module):
    def __init__(self, c: KimiLinearConfig, index: int, build: _KimiParams):
        super().__init__()
        ds = c.deepseek()
        self.c, self.kda = c, c.is_kda(index)
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, build)
        self.self_attn = KimiDeltaAttention(c, build) if self.kda else Attention(ds, build)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, build)
        self.mlp = (MoE(ds, build, c.held) if ds.is_moe(index)
                    else MLP(c.intermediate_size, ds, build))

    def forward(self, x: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        tracer = recorder()
        if self.kda:
            start = tracer.mark(x.device)
            x = x + self.self_attn(self.input_layernorm(x), keys)
            tracer.collect(("kda.layer", start, tracer.mark(x.device)))
        else:
            cos, sin = mla_tables(x.shape[1], self.c, x.device)
            x = x + self.self_attn(self.input_layernorm(x), cos, sin, keys)
        return x + self.mlp(self.post_attention_layernorm(x))


def _record(tracer, items: List, held: range) -> None:
    """Record a forward's collected marks (module docstring): MoE layers as
    ``deepseek_v3.py`` records them, then each KDA layer's ``kda.layer`` and
    inside it its ``kda.scan``."""
    _record_moe(tracer, [it for it in items if not isinstance(it[0], str)],
                held=[held.start, held.stop])
    parent = tracer.current()
    layer, index = None, 0
    for name, start, end in (it for it in items if isinstance(it[0], str)):
        if name == "kda.scan":
            scan = (start, end)
        else:
            layer = tracer.interval("kda.layer", start, end, parent, layer=index)
            tracer.interval("kda.scan", *scan, layer, layer=index)
            index += 1


class KimiLinearTextEncoder(nn.Module):
    """Embedding, decoder layers and the final RMSNorm; returns the float32
    ``last_hidden_state`` ``[b, s, D]``.  ``device`` and ``generator`` as
    ``DeepseekV3TextEncoder``'s: ``meta`` draws nothing (load the weights with
    ``load_kimi_linear_weights``)."""

    def __init__(self, config: KimiLinearConfig, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.config = c = config
        device = torch.device("cpu" if device is None else device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        build = _KimiParams(c, device, generator)
        self.embed_tokens = build.weight(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(KimiDecoderLayer(c, i, build)
                                    for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, build)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32, device=input_ids.device)
        x = self.embed_tokens[input_ids.long()]
        tracer = recorder()
        items = tracer.collecting()
        for layer in self.layers:
            x = layer(x, attention_mask)
        out = self.norm(x, torch.float32)
        if items:
            _record(tracer, items, self.config.held)
        return out


# ----------------------------------------------------------------------
# HuggingFace names
# ----------------------------------------------------------------------
_EXPERT = re.compile(r"^layers\.(\d+)\.mlp\.experts\.(\d+)\.(gate|up|down)_proj\.weight$")
_OWN = (".A_log", ".dt_bias", ".bias")  # parameters HF names without ``.weight``


def _hf_name(name: str) -> str:
    """A module parameter's name (not a routed stack) -> its HF name."""
    return name if name.endswith(_OWN) else _hf(name)


def parameter_count(config: KimiLinearConfig) -> int:
    """The tower's parameters (the held experts only; no ``lm_head``)."""
    return sum(p.numel() for p in KimiLinearTextEncoder(config, device="meta").parameters())


def hf_names(config: KimiLinearConfig) -> List[str]:
    """Every HF name the tower reads (without ``model.``): of the routed
    experts, the held ones."""
    out = []
    for name, _p in KimiLinearTextEncoder(config, device="meta").named_parameters():
        stem, _, leaf = name.rpartition(".")
        if leaf in ("w_gate_up", "w_down"):
            projs = ("gate", "up") if leaf == "w_gate_up" else ("down",)
            out += [f"{stem}.experts.{j}.{p}_proj.weight" for j in config.held for p in projs]
        else:
            out.append(_hf_name(name))
    return out


@torch.no_grad()
def load_kimi_linear_weights(module: KimiLinearTextEncoder, state_dict: Dict[str, torch.Tensor],
                             device=None, strict: bool = True) -> List[str]:
    """Load HF-named weights into the tower, in place, as
    ``load_deepseek_v3_weights`` does (each tensor popped as it loads; a
    tensor of the tower's dtype on its device becomes the parameter; the
    routed experts copied into their stacks).  Routed experts the tower
    does not hold, ``lm_head`` and layers past the last are left in
    ``state_dict``.  ``strict``: every name of ``hf_names`` must have been
    read.  -> the names read."""
    c = module.config
    I = c.moe_intermediate_size
    held = c.held
    names = {_hf_name(n): n for n, _ in module.named_parameters()}
    read = []
    for key in list(state_dict):
        hf = key[len("model."):] if key.startswith("model.") else key
        layer = re.match(r"^layers\.(\d+)\.", hf)
        if hf.startswith("lm_head.") or (layer and int(layer.group(1)) >= c.num_hidden_layers):
            continue
        expert = _EXPERT.match(hf)
        if expert and int(expert.group(2)) not in held:
            continue
        if ".shared_experts." in hf and not c.num_shared_experts:
            del state_dict[key]  # a tower built without them
            continue
        value = torch.as_tensor(state_dict.pop(key))
        if device is not None:
            value = value.to(device)
        if expert:
            i, j, proj = int(expert.group(1)), int(expert.group(2)) - held.start, expert.group(3)
            moe = module.layers[i].mlp
            leaf = "w_down" if proj == "down" else "w_gate_up"
            stack = getattr(moe, leaf)
            if stack.device.type == "meta":
                stack = nn.Parameter(torch.empty(stack.shape, dtype=stack.dtype,
                                                 device=value.device), requires_grad=False)
                setattr(moe, leaf, stack)
            rows = {"gate": slice(0, I), "up": slice(I, 2 * I), "down": slice(None)}[proj]
            stack[j, rows].copy_(value)
        else:
            if hf not in names:
                raise KeyError(f"{key}: not a Kimi-Linear tower weight")
            _assign(module, names[hf], value)
        read.append(hf)
        del value
    if strict:
        missing = sorted(set(hf_names(c)) - set(read))
        if missing:
            raise KeyError(f"{len(missing)} weights missing, e.g. {missing[:3]}")
    return read
