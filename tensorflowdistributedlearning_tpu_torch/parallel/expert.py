"""Expert parallelism: top-1-gated mixture of experts with all-to-all
dispatch (counterpart of the JAX package's ``parallel/expert.py``).

The Switch-style top-1 regime, fixed shapes throughout, as in the JAX
package:

- a linear router gives each token its expert logits; top-1 assignment
  with a per-expert capacity ``C = max(1, ceil(T · capacity_factor / E))``
  (:func:`top1_dispatch`);
- the tokens are bucketed into a dense ``[E, C, D]`` dispatch buffer
  (tokens beyond an expert's capacity are dropped), processed, and
  gathered back to token order, scaled by the gate probability; a dropped
  token's update is zero (the residual carries it through);
- :func:`dense_moe_apply` computes every expert on this device over the
  stacked ``[E, ...]`` parameters; :func:`moe_apply` places one expert per
  rank of the expert group (``parallel/mesh.py``'s model group under
  ``expert_parallel``): the buffer goes out with one all-to-all, so rank e
  holds every rank's tokens for expert e, and comes back with a second
  (``collectives.all_to_all``, whose backward is the same all-to-all).

The two share :func:`_dispatch_buffers` and :func:`_combine`, so they route,
drop and combine alike; they differ only in where the expert products run.

The gradient under expert parallelism. The ranks of an expert group hold
the same rows (the JAX package's batch is replicated over its model axis),
so each computes the same routing, the same combined tokens and the same
loss. In the backward each rank's cotangent of the combined tokens is the
whole one; the all-to-alls hand rank e the cotangents of expert e's tokens
from every rank, E copies of them, so rank e's gradient of expert e's
parameters is E times the dense step's, and its gradient of the other
experts' is zero; the routing, the token path and every shared parameter
get the dense step's gradient on every rank. The group's mean is therefore
the dense step's gradient, leaf by leaf, which is what the JAX step's
automatic psum over the model axis and its ``pmean`` of the MoE output
(``models/vit.py:232-234``) give: the train step averages its gradient
over every rank under expert parallelism (``mesh.gradient_group``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F

from tensorflowdistributedlearning_tpu_torch.parallel import collectives


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``exp(x - max)`` over its
    sum, the max a constant to the gradient."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def top1_dispatch(gate_logits: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, ...]:
    """Greedy top-1 routing with a per-expert capacity. ``gate_logits``:
    ``[T, E]``. Returns ``(expert, slot, keep, prob)``, each ``[T]``: the
    chosen expert (the first on a tie, as ``jnp.argmax``), the token's slot
    in that expert's buffer (the count of earlier tokens, in token order,
    that chose it), whether it fits (``slot < capacity``), and its softmax
    gate probability."""
    probs = _softmax(gate_logits)
    expert = torch.argmax(gate_logits, dim=-1)
    prob = probs.gather(1, expert[:, None])[:, 0]
    # JAX's cumsum(one_hot, axis=0) · one_hot, laid out [E, T] so the scan
    # runs along the contiguous axis (the card scans an outer axis of E = 8
    # columns one thread each); the integers are the same
    one_hot = F.one_hot(expert, gate_logits.shape[-1]).t().contiguous()
    slot = (torch.cumsum(one_hot, dim=1) * one_hot).sum(dim=0) - 1
    return expert, slot, slot < capacity, prob


def capacity_of(tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Each expert's buffer rows: ``max(1, ceil(tokens · factor / E))``."""
    return max(1, math.ceil(tokens * capacity_factor / n_experts))


def _dispatch_buffers(gate_logits: torch.Tensor, x: torch.Tensor, n_experts: int, capacity_factor: float):
    """The routing and the dispatch buffer of both strategies:
    ``(buffer [E, C, D], flat_idx, keep, prob)``. A token lands at row
    ``expert · C + min(slot, C - 1)``; a dropped one adds zeros there, as
    the JAX package adds ``where(keep, x, 0)``."""
    t, d = x.shape
    capacity = capacity_of(t, n_experts, capacity_factor)
    expert, slot, keep, prob = top1_dispatch(gate_logits, capacity)
    flat_idx = expert * capacity + torch.clamp(slot, max=capacity - 1)
    kept = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    buffer = torch.zeros((n_experts * capacity, d), dtype=x.dtype, device=x.device).index_add(0, flat_idx, kept)
    return buffer.view(n_experts, capacity, d), flat_idx, keep, prob


def _combine(returned: torch.Tensor, flat_idx: torch.Tensor, keep: torch.Tensor, prob: torch.Tensor) -> torch.Tensor:
    """The experts' outputs ``[E·C, D]`` back in token order, scaled by the
    gate probability (cast to the outputs' dtype first), the dropped tokens
    zero."""
    out = returned.index_select(0, flat_idx)
    scaled = out * prob[:, None].to(out.dtype)
    return torch.where(keep[:, None], scaled, torch.zeros((), dtype=out.dtype, device=out.device))


def moe_apply(
    expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    my_expert_params: Any,
    gate_kernel: torch.Tensor,
    x: torch.Tensor,
    *,
    capacity_factor: float = 1.25,
    group=None,
    gate_logits: torch.Tensor = None,
) -> torch.Tensor:
    """The expert-parallel MoE layer: ``x`` ``[T, D]`` this rank's tokens
    (the same on every rank of ``group``), ``my_expert_params`` the
    parameters of this rank's expert (expert r of rank r), ``gate_kernel``
    the ``[D, E]`` router with E the group's size. Returns ``[T, D]``, each
    token processed by its expert and scaled by its gate probability (zero
    where capacity dropped it). ``gate_logits`` ``[T, E]`` supplies the
    router's logits (a caller's float32 routing that its load-balancing
    statistics share); by default ``x @ gate_kernel``."""
    n_experts = collectives.world_size(group)
    if gate_kernel.shape[-1] != n_experts:
        raise ValueError(
            f"gate_kernel routes over {gate_kernel.shape[-1]} experts but the expert group has {n_experts} ranks "
            "(one expert each); an over-wide router would dispatch out of the capacity buffer"
        )
    if gate_logits is None:
        gate_logits = x @ gate_kernel
    buffer, flat_idx, keep, prob = _dispatch_buffers(gate_logits, x, n_experts, capacity_factor)
    _, capacity, d = buffer.shape
    # rank e receives every rank's bucket for expert e
    incoming = collectives.all_to_all(buffer, group)
    processed = expert_fn(my_expert_params, incoming.reshape(n_experts * capacity, d))
    # and every rank gets its own tokens back, expert-processed
    returned = collectives.all_to_all(processed.reshape(n_experts, capacity, d), group)
    return _combine(returned.reshape(n_experts * capacity, d), flat_idx, keep, prob)


def dense_moe_apply(
    expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_expert_params: Any,
    gate_kernel: torch.Tensor,
    x: torch.Tensor,
    *,
    capacity_factor: float = 1.25,
    gate_logits: torch.Tensor = None,
) -> torch.Tensor:
    """The all-experts-local twin of :func:`moe_apply`: the same routing,
    capacity and combine, every expert computed here (``expert_fn`` mapped
    over the stacked ``[E, ...]`` parameters, as JAX's ``vmap``)."""
    n_experts = gate_kernel.shape[-1]
    if gate_logits is None:
        gate_logits = x @ gate_kernel
    buffer, flat_idx, keep, prob = _dispatch_buffers(gate_logits, x, n_experts, capacity_factor)
    _, capacity, d = buffer.shape
    processed = torch.func.vmap(expert_fn)(stacked_expert_params, buffer)
    return _combine(processed.reshape(n_experts * capacity, d), flat_idx, keep, prob)


def _mean0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=0)`` of a float32 ``x``: the sum times the float32
    reciprocal of the count."""
    return x.sum(dim=0) * torch.tensor(1.0 / x.shape[0], dtype=x.dtype, device=x.device)


def load_balance_loss(gate_logits: torch.Tensor) -> torch.Tensor:
    """The Switch Transformer's load-balancing loss (arXiv:2101.03961 eq. 4)
    in float32: ``E · Σ_e f_e · P_e``, ``f_e`` the share of tokens whose
    top-1 choice is expert e and ``P_e`` the mean router probability of e;
    1 at a uniform split."""
    probs = _softmax(gate_logits.float())
    return gate_logits.shape[-1] * torch.sum(expert_fractions(gate_logits) * _mean0(probs))


def expert_fractions(gate_logits: torch.Tensor) -> torch.Tensor:
    """``[E]`` float32: the share of the tokens whose top-1 choice is each
    expert (the JAX layer's ``expert_fraction`` intermediate)."""
    n_experts = gate_logits.shape[-1]
    return _mean0(F.one_hot(torch.argmax(gate_logits, dim=-1), n_experts).float())
