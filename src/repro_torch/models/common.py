"""Model configuration + shared neural-net primitives.

The port's own copy of `repro.models.common`.

Conventions
-----------
* Parameters are nested dicts of tensors.  Per-layer parameters are
  STACKED on a leading layer axis (the reference's layout, consumed there
  with `jax.lax.scan`); the port loops over the layer axis.
* Every parameter has *logical axes* (a tuple of names parallel to its
  shape), kept as the reference's for the sharding slice to come.
* Activations are bf16, parameters f32 (cast to bf16 at use), matmuls
  accumulate f32.  The paper's technique then *narrows* selected tensors
  further via `repro_torch.quant`.
* Where the reference meets a Python number as a weak-typed scalar, the
  port lifts it to a 0-dim tensor of the array's dtype (`_scalar`): torch
  would otherwise compute ``bf16 * 0.98995`` with the number in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

PyTree = Any

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

VOCAB_PAD_MULTIPLE = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_class: str                 # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention features
    qk_norm: bool = False
    sliding_window: int = 0         # 0 = full causal
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM / RWKV
    ssm_state: int = 0              # mamba2 N
    ssm_head_dim: int = 64          # mamba2 P
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    # hybrid (zamba2): one shared attention block applied every k ssm layers
    shared_attn_period: int = 0
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500         # whisper conv-frontend output length
    # vlm (paligemma)
    n_image_tokens: int = 0
    # miniCPM-style mu-parametrization scales
    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    # numerics
    norm_eps: float = 1e-6
    remat: bool = True
    # unroll factor for the reference's layer scan (no effect in the port)
    scan_unroll: int = 1
    # activation sharding constraint for (batch, seq) dims of the residual
    # stream at layer boundaries; () = unconstrained.  The port runs on one
    # device, so `constrain_act` ignores it.
    act_pspec: tuple = ()
    # cast >=2D params before the training forward pass (training slice)
    train_cast_bf16: bool = False
    train_weight_cast: str = ""    # "" | "bf16" | "int8"
    # KV cache storage: "bf16" or "int8" (paper technique on decode bytes;
    # per-vector absmax scales, dequant fused into the attention read)
    kv_cache_dtype: str = "bf16"
    # quantization policy hook (repro_torch.quant); None = bf16 everywhere
    quant_recipe: Optional[str] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab_size + VOCAB_PAD_MULTIPLE - 1)
                // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.arch_class == "rwkv"

    @property
    def sub_quadratic(self) -> bool:
        """Supports O(1)-state decode (long_500k eligibility)."""
        return self.arch_class in ("rwkv", "hybrid")

    def param_count(self) -> int:
        """Approximate dense parameter count (reporting/roofline only)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_padded, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.arch_class == "rwkv":
            per_layer = 4 * D * D + 3 * D * self.d_ff // 1  # tmix + cmix approx
        elif self.is_moe:
            ffn = 3 * D * self.moe_d_ff * self.n_experts + D * self.n_experts
            if self.shared_expert_d_ff:
                ffn += 3 * D * self.shared_expert_d_ff
            per_layer = attn + ffn
        else:
            per_layer = attn + 3 * D * F
        total = L * per_layer + 2 * V * D
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + 2 * D * F)
        return total


# ---------------------------------------------------------------------------
# nested-dict trees (the reference's pytrees: dict keys in sorted order)
# ---------------------------------------------------------------------------

def tree_items(tree: PyTree, is_leaf: Callable[[Any], bool] = None,
               path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        for k in sorted(tree):
            yield from tree_items(tree[k], is_leaf, path + (k,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree: PyTree, with_path: bool = False,
             is_leaf: Callable[[Any], bool] = None, path: Tuple = ()
             ) -> PyTree:
    """A nested dict of the same keys with `fn` applied to every leaf
    (`fn(path, leaf)` when `with_path`)."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, with_path, is_leaf, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree) if with_path else fn(tree)


# ---------------------------------------------------------------------------
# logical-axis bookkeeping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == ndim
    init: str = "normal"              # normal | zeros | ones | small

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def init_param(generator: torch.Generator, spec: ParamSpec,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One parameter on the generator's device."""
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    scale = 0.02 if spec.init == "normal" else 0.006
    # fan-in scaled normal
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = min(scale, 1.0 / math.sqrt(max(fan_in, 1)))
    out = torch.randn(spec.shape, generator=generator, dtype=dtype,
                      device=dev)
    return out.mul_(_scalar(std, dtype))


def init_tree(generator: torch.Generator, specs: PyTree,
              dtype: torch.dtype = torch.float32) -> PyTree:
    """Every leaf drawn from `generator` in flatten order, on its device."""
    return tree_map(lambda s: init_param(generator, s, dtype), specs,
                    is_leaf=_is_spec)


def axes_tree(specs: PyTree) -> PyTree:
    """The logical-axis tree parallel to the param tree."""
    return tree_map(lambda s: s.axes, specs, is_leaf=_is_spec)


def shape_tree(specs: PyTree) -> PyTree:
    """(shape, dtype) per leaf: the params' shapes, nothing allocated."""
    return tree_map(lambda s: (s.shape, torch.float32), specs,
                    is_leaf=_is_spec)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _scalar(v: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python number as the reference's weak-typed scalar meets an array
    of `dtype`: rounded to that dtype first.  A 0-dim CPU tensor, which
    torch takes as a scalar beside CUDA tensors too: no copy to the card,
    so the host never waits for it."""
    return torch.tensor(v, dtype=dtype)


def constrain_act(x, cfg: "ModelConfig"):
    """The reference's sequence-parallel layout hint; one device has no
    layout to constrain."""
    return x


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The result in `dtype` (default: x's): a block's residual sum comes
    in f32 and its norm goes out in bf16 (`blocks._residual`)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype or x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight + bias
    return out.to(x.dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x @ w over x's last axis: products of `compute_dtype` operands summed
    in f32, an f32 result (the reference's ``preferred_element_type``).

    On the card cuBLAS takes the bf16 operands and writes f32, so its
    split-K partials are reduced in f32 whatever
    ``allow_bf16_reduced_precision_reduction`` says.  On the CPU the
    operands are rounded to `compute_dtype` and multiplied in f32: a
    product of two bf16 values is exact in f32.
    """
    a = x.to(compute_dtype).reshape(-1, x.shape[-1])
    b = w.to(compute_dtype)
    if a.is_cuda:
        out = torch.mm(a, b, out_dtype=torch.float32)
    else:
        out = torch.mm(a.float(), b.float())
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def dense(x: torch.Tensor, w: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x @ w with bf16 compute, f32 accumulation, a bf16 result."""
    return matmul_f32(x, w, compute_dtype).to(compute_dtype)


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu on f32: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def swiglu(x, w_gate, w_up, w_down):
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(silu_f32(g.float()).to(u.dtype) * u, w_down)


def gelu_f32(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu (its default tanh approximation) on f32."""
    c = _scalar(math.sqrt(2 / math.pi), x.dtype)
    k = _scalar(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    h = dense(x, w_up) + b_up.to(torch.bfloat16)
    h = gelu_f32(h.float()).to(torch.bfloat16)
    return dense(h, w_down) + b_down.to(torch.bfloat16)
