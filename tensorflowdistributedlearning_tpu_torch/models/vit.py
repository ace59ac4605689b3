"""Vision Transformer classifier (counterpart of
``tensorflowdistributedlearning_tpu/models/vit.py``), for serving and
training (the model has no dropout and no BatchNorm, so its training-mode
forward is its eval-mode one).

A pre-LN ViT: patch embedding (a VALID stride-p conv), learned position
embeddings, N transformer blocks, a final LayerNorm, a float32 mean pool
over the tokens (no cls token) and the ``logits`` Dense. Module names
mirror the flax tree (``patch_embed``, ``pos_embedding``, ``block{i}`` with
``ln1``, ``attn.qkv``, ``attn.proj``, ``ln2``, ``mlp_in``, ``mlp_out``,
``ln_final``, ``logits``), so ``utils.convert.from_flax`` maps by path.
Inputs are NHWC, as in the JAX package.

The dtype flow repeats flax's under ``ModelConfig.dtype``:

- parameters are float32; each Dense, the patch conv and each LayerNorm
  computes in the compute dtype (bf16 under ``dtype="bfloat16"``), its
  parameters cast to it at the call;
- a Dense is the product, then the bias added on its own (two roundings in
  bf16, as flax's ``dot_general`` then ``+= bias``);
- LayerNorm is flax's: statistics in float32 with the fast variance
  ``E[x^2] - E[x]^2`` clipped at 0, epsilon 1e-6 (PyTorch's default is
  1e-5), ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32,
  then cast to the compute dtype;
- ``gelu`` is jax's default tanh approximation;
- ``remat`` recomputes each transformer block in the backward pass
  (:func:`layers.remat_call`), as flax's ``nn.remat`` per block;
- ``pos_embedding`` is cast to the compute dtype before the add; the pool
  is a float32 mean; the ``logits`` Dense has no dtype, so it computes in
  float32 from the float32 pool.

Each cast of a parameter to the compute dtype is a differentiable
``Tensor.to``: in bf16 compute the float32 parameters receive float32
gradients (the bf16 cotangent cast back), as flax's promotion does under
``jax.grad``.

With ``moe_experts`` set, every other block's MLP (``block2``,
``block4``, ...) is the Switch-style top-1 mixture of experts
:class:`MoEMlp` (module ``moe``, raw parameters under flax's leaf names
``router``, ``w_in``, ``b_in``, ``w_out``, ``b_out``): the router runs once
in float32, the experts in the compute dtype, every expert on this device
(``parallel/expert.dense_moe_apply``) or, with an expert group set, one
expert per rank of it (``parallel/expert.moe_apply``). In training mode it
records its weighted load-balancing loss (``aux_loss``) and its dispatch
fractions (``expert_fraction``), the JAX layer's ``aux_loss`` and
``intermediates`` collections; the train step adds every recorded loss to
its objective (:func:`pop_aux_losses`). A routing pool is one forward's
tokens.

Attention is :func:`ops.flash_attention.flash_attention` under
``use_fused_attention`` (the hand-written kernel on CUDA) and its plain
version otherwise; both keep float32 math, return the compute dtype and
carry gradients (the kernel through its ``autograd.Function``).
The patch conv and the Dense products stay ``torch.matmul``, as the JAX
package leaves them to XLA. Under ``int8-compute`` the Dense layers become
``ops.quant_kernels.QuantLinear`` at load time.

Tensor parallelism (``parallel/tensor.py``): every leaf whose trailing
flax dimension the degree divides is this rank's slice; the Dense layers
and the patch conv take the column form, the LayerNorm leaves, the
position table and the MoE leaves are gathered where they are used, and
attention runs on whole heads on every rank (its input is whole).

Sequence parallelism (``models.set_spatial``; the JAX modules'
``spatial_axis_name``): the input is this rank's block of the rows; its
patches are tokens ``[index·T_local, (index + 1)·T_local)`` of the
row-major global sequence, so the position table is sliced there; the
attention is :func:`parallel.ring_attention.ring_attention` over the
sequence group (``use_fused_attention`` is ignored with a warning, as in
the JAX package), and the pooled tokens are averaged over the group.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
from tensorflowdistributedlearning_tpu_torch.models.layers import (
    Dense, compute_dtype_of, promote_dtype, remat_call, scaled_width,
)
from tensorflowdistributedlearning_tpu_torch.ops import flash_attention as fa
from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh
from tensorflowdistributedlearning_tpu_torch.parallel import expert as expert_lib
from tensorflowdistributedlearning_tpu_torch.parallel.ring_attention import ring_attention

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)`` over the last axis (see the module
    note): ``weight`` is flax's ``scale``.

    Under ``tp`` (``parallel/tensor.py``) ``weight`` and ``bias`` are this
    rank's channel slices, gathered whole where the layer runs: the input
    is whole on every rank of the model group, so each rank computes the
    whole output, and each keeps its own block of the leaves' gradients."""

    tp = None

    def __init__(self, features: int, dtype=None, eps: float = LAYER_NORM_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight, self.bias
        if self.tp is not None:
            weight, bias = self.tp.gather(weight), self.tp.gather(bias)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * weight.float()
        y = (xf - mean) * mul + bias.float()
        return y.to(promote_dtype(x, self.dtype))


class PatchEmbed(nn.Conv2d):
    """flax ``nn.Conv(embed, (p, p), strides=p, padding="VALID")`` over NHWC
    input, returning tokens ``[B, (H/p)(W/p), E]`` in row-major patch order.
    ``weight`` is OIHW (flax's HWIO ``kernel`` transposed). Computed as one
    product of the patches with the filter flattened in (kh, kw, c) order,
    then the bias added. Under ``tp`` the filter and bias are this rank's
    output channels (the column form of ``parallel/tensor.py``)."""

    tp = None

    def __init__(self, in_channels: int, embed: int, patch: int, dtype=None):
        super().__init__(in_channels, embed, patch, stride=patch)
        self.patch = patch
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp.column(self._forward, x) if self.tp is not None else self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.patch
        dt = promote_dtype(x, self.dtype)
        patches = x.to(dt).reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, (h // p) * (w // p), p * p * c)
        kernel = self.weight.to(dt).permute(2, 3, 1, 0).reshape(p * p * c, -1)
        return torch.matmul(patches, kernel) + self.bias.to(dt)


class MultiHeadSelfAttention(nn.Module):
    """QKV projection, softmax attention, output projection. The qkv output
    is laid out ``[B, T, 3, H, hd]``; q, k and v are strided views of it,
    which the kernel reads in place. A ``spatial`` layer attends its
    tokens to the whole sequence by ring attention over the sequence
    group."""

    spatial = False

    def __init__(self, embed: int, num_heads: int, dtype=None, use_fused: bool = False,
                 num_prefix_tokens: int = 0):
        super().__init__()
        self.embed = embed
        self.num_heads = num_heads
        self.use_fused = use_fused
        # auxiliary tokens before the patch tokens (0 here: mean-pool head);
        # kept for the model's structure, it gates nothing in the port
        self.num_prefix_tokens = num_prefix_tokens
        self.qkv = Dense(embed, 3 * embed, dtype)
        self.proj = Dense(embed, embed, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, self.embed // self.num_heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.spatial:
            if self.use_fused:
                warnings.warn(
                    "use_fused_attention is ignored under sequence parallelism: the ring formulation owns the "
                    "attention math there",
                    stacklevel=2,
                )
            out = ring_attention(q, k, v)
            return self.proj(out.reshape(b, t, self.embed))
        attend = fa.flash_attention if self.use_fused else fa.flash_attention_plain
        out = attend(q, k, v)
        return self.proj(out.reshape(b, t, self.embed))


class MoEMlp(nn.Module):
    """The Switch-style top-1 mixture-of-experts FFN (arXiv:2101.03961) in
    place of a block's dense MLP (the JAX package's ``MoEMlp``). Its
    parameters are flax's leaves as they are, not Dense layers: the
    float32 ``router`` ``[D, E]`` and the stacked experts ``w_in [E, D,
    F]``, ``b_in [E, F]``, ``w_out [E, F, D]``, ``b_out [E, D]``, so the
    int8 serving paths, which route Dense layers and quantize kernels,
    leave them float as the JAX package does.

    ``expert_group`` None computes every expert here; a group of E ranks
    (``parallel/mesh.expert_group``) runs expert r on rank r under the
    all-to-all dispatch, with the same numerics. In training mode the
    forward records ``aux_weight · load_balance_loss`` (``aux_loss``) and
    the dispatch fractions (``expert_fraction``) of its routing.

    Under ``tp`` (tensor parallelism) every leaf is this rank's slice of
    its trailing dimension, the JAX package's rule; the forward gathers
    the leaves whole and computes as one rank does (the gather's backward
    keeps this rank's block of each leaf's gradient)."""

    tp = None

    def __init__(self, embed: int, mlp_dim: int, n_experts: int, capacity_factor: float = 1.25,
                 aux_weight: float = 0.01, dtype=None):
        super().__init__()
        self.router = nn.Parameter(torch.zeros(embed, n_experts))
        self.w_in = nn.Parameter(torch.zeros(n_experts, embed, mlp_dim))
        self.b_in = nn.Parameter(torch.zeros(n_experts, mlp_dim))
        self.w_out = nn.Parameter(torch.zeros(n_experts, mlp_dim, embed))
        self.b_out = nn.Parameter(torch.zeros(n_experts, embed))
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        self.dtype = dtype
        self.expert_group = None
        self.aux_loss: Optional[torch.Tensor] = None
        self.expert_fraction: Optional[torch.Tensor] = None

    @staticmethod
    def expert_fn(p, xs: torch.Tensor) -> torch.Tensor:
        """One expert's FFN: product then bias (two roundings in bf16, as
        flax's), tanh-GELU, product then bias."""
        h = F.gelu(torch.matmul(xs, p["w_in"]) + p["b_in"], approximate="tanh")
        return torch.matmul(h, p["w_out"]) + p["b_out"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        names = ("router", "w_in", "b_in", "w_out", "b_out")
        leaves = {n: getattr(self, n) for n in names}
        if self.tp is not None:
            leaves = {n: self.tp.gather(v) for n, v in leaves.items()}
        tokens = x.reshape(b * t, d)
        # one float32 routing feeds the balance loss and the dispatch, so a
        # near tie goes where the loss saw it go
        gate_logits = tokens.float() @ leaves["router"].float()
        if self.training:
            self.aux_loss = self.aux_weight * expert_lib.load_balance_loss(gate_logits)
            with torch.no_grad():
                self.expert_fraction = expert_lib.expert_fractions(gate_logits)
        dt = self.dtype or torch.float32
        tokens = tokens.to(dt)
        if self.expert_group is None:
            stacked = {n: leaves[n].to(dt) for n in names[1:]}
            out = expert_lib.dense_moe_apply(self.expert_fn, stacked, leaves["router"], tokens,
                                             capacity_factor=self.capacity_factor, gate_logits=gate_logits)
        else:
            index = dist.get_rank(self.expert_group)
            mine = {n: leaves[n][index].to(dt) for n in names[1:]}
            out = expert_lib.moe_apply(self.expert_fn, mine, leaves["router"], tokens,
                                       capacity_factor=self.capacity_factor, group=self.expert_group,
                                       gate_logits=gate_logits)
        return out.reshape(b, t, d)


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``; with
    ``moe_experts`` the MLP is :class:`MoEMlp` (module ``moe``)."""

    def __init__(self, embed: int, num_heads: int, mlp_dim: int, dtype=None, use_fused: bool = False,
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25, moe_aux_weight: float = 0.01):
        super().__init__()
        self.ln1 = LayerNorm(embed, dtype)
        self.attn = MultiHeadSelfAttention(embed, num_heads, dtype, use_fused)
        self.ln2 = LayerNorm(embed, dtype)
        if moe_experts:
            self.moe = MoEMlp(embed, mlp_dim, moe_experts, moe_capacity_factor, moe_aux_weight, dtype)
        else:
            self.mlp_in = Dense(embed, mlp_dim, dtype)
            self.mlp_out = Dense(mlp_dim, embed, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        if hasattr(self, "moe"):
            return x + self.moe(self.ln2(x))
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


def moe_layers(model: nn.Module) -> List[MoEMlp]:
    """The :class:`MoEMlp` layers of ``model``, by module name in the
    order of the JAX package's collections (flax sorts the names, so
    ``block10`` comes before ``block2``)."""
    named = sorted(((n, m) for n, m in model.named_modules() if isinstance(m, MoEMlp)), key=lambda nm: nm[0])
    return [m for _, m in named]


def set_expert_group(model: nn.Module, group) -> None:
    """Run the MoE layers of ``model`` one expert per rank of ``group``
    (None: every expert here)."""
    for m in moe_layers(model):
        m.expert_group = group


def pop_aux_losses(model: nn.Module) -> List[torch.Tensor]:
    """The auxiliary losses the last training-mode forward recorded (the
    JAX package's ``aux_loss`` collection, in its order), cleared: the
    train step adds them to its objective."""
    out = []
    for m in moe_layers(model):
        if m.aux_loss is not None:
            out.append(m.aux_loss)
            m.aux_loss = None
    return out


class ViTClassifier(nn.Module):
    """``[B, H, W, C] -> [B, num_classes]`` logits (float32, or the int8
    kernel's bf16 under ``int8-compute``). ``spatial``: the input is this
    rank's block of the rows (see the module's docstring). ``tp``
    (tensor parallelism): ``pos_embedding`` is this rank's slice of the
    embedding width, gathered whole where it is added."""

    spatial = False
    tp = None

    def __init__(self, config: ModelConfig):
        super().__init__()
        if config.num_classes is None:
            raise ValueError("backbone='vit' supports the classification head only (set num_classes)")
        embed = scaled_width(config.embed_dim, config.width_multiplier)
        if embed % config.num_heads != 0:
            raise ValueError(f"scaled embed_dim {embed} not divisible by num_heads {config.num_heads}")
        p = config.patch_size
        h, w = config.input_shape
        if h % p or w % p:
            raise ValueError(f"input_shape {config.input_shape} not divisible by patch_size {p}")
        self.config = config
        self.embed = embed
        dtype = compute_dtype_of(config)
        self.dtype = dtype
        self.patch_embed = PatchEmbed(config.input_channels, embed, p, dtype)
        self.pos_embedding = nn.Parameter(torch.zeros((h // p) * (w // p), embed))
        mlp_dim = int(embed * config.mlp_ratio)
        for i in range(config.vit_layers):
            # Switch-style placement: every other block's FFN is the MoE
            # (block2, block4, ...), as in the JAX package
            is_moe = config.moe_experts > 0 and i % 2 == 1
            self.add_module(
                f"block{i + 1}",
                TransformerBlock(embed, config.num_heads, mlp_dim, dtype, config.use_fused_attention,
                                 config.moe_experts if is_moe else 0, config.moe_capacity_factor,
                                 config.moe_aux_weight),
            )
        self.ln_final = LayerNorm(embed, dtype)
        self.logits = Dense(embed, config.num_classes, None)

    def blocks(self):
        return [getattr(self, f"block{i + 1}") for i in range(self.config.vit_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.config.input_shape
        if self.spatial:
            check_spatial_input(self.config, x)
        elif x.dim() != 4 or x.shape[1] != h or x.shape[2] != w:
            raise ValueError(
                f"input {tuple(x.shape)} does not match the configured input_shape {self.config.input_shape} (NHWC)"
            )
        tokens = embed_tokens(self.config, self, x)
        for block in self.blocks():
            tokens = remat_call(block, tokens, self.config.remat)
        return head_logits(self.config, self, tokens)


# -- pipeline parallelism (train/pipeline_step.py) ----------------------------
#
# The block stack is the GPipe runner's homogeneous-stage case
# (parallel/pipeline.py): stage k of K applies blocks kG+1..kG+G, G = L/K.
# The stage functions are functional, as the JAX package's: a block's
# parameters are a dict of tensors under the block's own names (``ln1.weight``,
# ``attn.qkv.weight``, ...), applied by ``torch.func.functional_call`` to a
# parameterless template block built from the config. The embed and the head
# take the canonical ViTClassifier as their parameters (the counterpart of
# its flax tree). The pipelined forward ignores ``remat``, as JAX's does.


def pipeline_stage_fn(config: ModelConfig):
    """``stage_fn(params, x)``: ONE transformer block of ``config`` (embed
    width, MLP width, compute dtype and attention arm as
    :class:`ViTClassifier` builds them) applied with ``params``, a dict of
    its parameters by their names in the block."""
    embed = scaled_width(config.embed_dim, config.width_multiplier)
    with torch.device("meta"):
        block = TransformerBlock(embed, config.num_heads, int(embed * config.mlp_ratio), compute_dtype_of(config),
                                 config.use_fused_attention)

    def stage_fn(params, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(block, params, (x,))

    return stage_fn


def grouped_pipeline_stage_fn(config: ModelConfig, layers_per_stage: int):
    """``stage_fn(params, x)`` over the grouped stacking: ``params`` a dict
    of ``[layers_per_stage, ...]`` tensors (always the group axis, even at
    1), the blocks applied in order."""
    base = pipeline_stage_fn(config)

    def stage_fn(params, x: torch.Tensor) -> torch.Tensor:
        for i in range(layers_per_stage):
            x = base({name: p[i] for name, p in params.items()}, x)
        return x

    return stage_fn


def block_params(params, index: int):
    """Block ``index`` (1-based) of ``params`` (the canonical names of a
    ViTClassifier's parameters, e.g. ``dict(model.named_parameters())``):
    its tensors by their names in the block."""
    prefix = f"block{index}."
    return {name[len(prefix):]: t for name, t in params.items() if name.startswith(prefix)}


def stack_vit_block_params(params, n_layers: int, n_stages=None):
    """The blocks of ``params`` (canonical names, ``block1..blockN``)
    stacked for the runner: ``[L, ...]`` per leaf with ``n_stages`` None,
    else the grouped ``[K, L/K, ...]`` of :func:`grouped_pipeline_stage_fn`.
    Differentiable: a stacked leaf's gradient reaches its blocks."""
    from tensorflowdistributedlearning_tpu_torch.parallel.pipeline import stack_stage_params

    stacked = stack_stage_params([block_params(params, i + 1) for i in range(n_layers)])
    if n_stages is None:
        return stacked
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} ViT layers not divisible into {n_stages} pipeline stages")
    group = n_layers // n_stages
    return {name: leaf.reshape((n_stages, group) + tuple(leaf.shape[1:])) for name, leaf in stacked.items()}


def embed_tokens(config: ModelConfig, params: "ViTClassifier", x: torch.Tensor) -> torch.Tensor:
    """Patch embedding plus position embeddings in the compute dtype: the
    pre-block half of :meth:`ViTClassifier.forward`, with ``params`` the
    classifier whose parameters apply."""
    dtype = compute_dtype_of(config)
    tokens = params.patch_embed(x.to(dtype))
    t_local = tokens.shape[1]
    offset = mesh.sequence_index() * t_local if getattr(params, "spatial", False) else 0
    pos = params.pos_embedding
    if getattr(params, "tp", None) is not None:
        pos = params.tp.gather(pos)
    return tokens + pos[offset:offset + t_local].to(dtype)[None]


def head_logits(config: ModelConfig, params: "ViTClassifier", tokens: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm, float32 mean pool and the ``logits`` Dense: the
    post-block half of :meth:`ViTClassifier.forward`."""
    pooled = params.ln_final(tokens).float().mean(dim=1)
    if getattr(params, "spatial", False):
        # equal blocks: the global token mean is the mean of the blocks'
        pooled = collectives.pmean(pooled, mesh.sequence_group())
    return params.logits(pooled)


def check_spatial_input(config: ModelConfig, x: torch.Tensor) -> None:
    """The JAX ViT's checks of an H-sharded input: the whole width, the
    sequence degree's blocks adding up to the configured height, whole
    patches in each block."""
    h_total, w_total = config.input_shape
    p = config.patch_size
    h_local, w_actual = x.shape[1], x.shape[2]
    if w_actual != w_total:
        raise ValueError(f"input width {w_actual} != configured input_shape width {w_total}")
    degree = mesh.sequence_parallel_degree()
    if h_local * degree != h_total:
        raise ValueError(
            f"per-shard height {h_local} x sequence degree {degree} != configured input height {h_total}"
        )
    if h_local % p:
        raise ValueError(
            f"per-shard height {h_local} not divisible by patch_size {p} — lower sequence_parallel or the patch size"
        )
