"""Mixture-of-Experts with expert parallelism over the mesh axis 'ep'
(counterpart of `mxnet_tpu/parallel/moe.py`).

Switch-style top-1 routing with a capacity factor (Fedus et al.,
Switch Transformers, eq. 4 for the load-balancing loss). The JAX package
builds a one-hot dispatch tensor (tokens, E, C) and contracts it with
einsums; the port routes by index: it gathers each expert's tokens into
its (C, D) buffer and gathers each token's expert output back. Each slot
holds one token and each token at most one slot, so both forms compute
the same values (the einsums add only zeros beside the one product), and
the index form skips the dispatch products.

The routing rules are the JAX package's:

  * capacity is `max(int(capacity_factor * tokens / E), 1)` in Python
    float arithmetic, over the tokens of one call (the composite calls
    it once a microbatch, on this rank's tokens);
  * top-1 by argmax of the softmax, a tie taking the first expert;
  * a token's place in its expert's buffer is the count of the tokens
    routed there before it in flattened (batch, token) order, and a
    token at or past capacity is dropped (its output is zero).

Under `ep` every rank routes over all experts, computes its own E / ep
of them, and the outputs are summed over `ep` (g); the experts' input
enters through f, so its gradient is summed over `ep` too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..context import resolve_device
from . import _comm
from .mesh import P

__all__ = ["moe_ffn", "init_moe_params", "moe_param_specs", "gelu_tanh"]


def gelu_tanh(x):
    """`jax.nn.gelu`'s default, the tanh form (torch's default is the
    erf form, up to 4.7e-4 away)."""
    return F.gelu(x, approximate="tanh")


def init_moe_params(generator, n_experts, d_model, d_ff,
                    dtype=torch.float32, device=None):
    """{"gate" (D, E), "wi" (E, D, F), "wo" (E, F, D)}, normal draws from
    `generator` (on its device) scaled as the JAX package's, on `device`
    (None = `mx.gpu(0)`)."""
    dev = resolve_device(device)
    scale_in = 1.0 / (d_model ** 0.5)
    scale_out = 1.0 / (d_ff ** 0.5)

    def rnd(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(dtype=dtype, device=dev)
    return {"gate": rnd((d_model, n_experts), scale_in),
            "wi": rnd((n_experts, d_model, d_ff), scale_in),
            "wo": rnd((n_experts, d_ff, d_model), scale_out)}


def moe_param_specs(ep_axis="ep"):
    return {"gate": P(), "wi": P(ep_axis, None, None),
            "wo": P(ep_axis, None, None)}


def route(logits, n_experts, capacity_factor):
    """Top-1 routing of `logits` (tokens, E): (expert (tokens,) int64,
    gate value (tokens,), place in the expert's buffer (tokens,) int64,
    kept (tokens,) bool, probs (tokens, E), capacity). The places are
    counts of integers, exact."""
    tokens = logits.shape[0]
    capacity = max(int(capacity_factor * tokens / n_experts), 1)
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argmax(probs, dim=-1)
    gate_val = probs.gather(1, idx[:, None])[:, 0]
    # the running count of each expert's tokens, scanned along the
    # tokens as the inner dim (an outer-dim scan of (tokens, E) runs on E
    # threads)
    counts = F.one_hot(idx, n_experts).t().contiguous().cumsum(1)
    pos = counts.gather(0, idx[None])[0] - 1
    return idx, gate_val, pos, pos < capacity, probs, capacity


def experts(a2, idx, gate_val, pos, keep, wi, wo, first, capacity,
            activation):
    """The outputs (tokens, D) of experts first .. first + len(wi) - 1
    for the routed tokens `a2` (tokens, D), gated; zero rows for tokens
    routed elsewhere or dropped. Tokens go to their (expert, place) slot
    of the (E_loc, C, D) buffer by an index gather (empty slots read a
    zero row), and come back by another."""
    t, d = a2.shape
    e_loc = wi.shape[0]
    n_slots = e_loc * capacity
    local = keep & (idx >= first) & (idx < first + e_loc)
    slot = (idx - first) * capacity + pos
    ar = torch.arange(t, device=a2.device)
    # every token writes its own entry (the others past n_slots), so the
    # table is deterministic; slots no token fills read row t, zeros
    dest = torch.where(local, slot, n_slots + ar)
    src = torch.full((n_slots + t,), t, dtype=torch.long,
                     device=a2.device).scatter_(0, dest, ar)[:n_slots]
    zero = a2.new_zeros((1, d))
    expert_in = torch.cat([a2, zero]).index_select(0, src)
    u = activation(torch.bmm(expert_in.view(e_loc, capacity, d), wi))
    out = torch.bmm(u, wo).reshape(n_slots, d)
    back = torch.where(local, slot, torch.full_like(slot, n_slots))
    return torch.cat([out, zero]).index_select(0, back) * gate_val[:, None]


def moe_ffn(params, x, capacity_factor=1.25, activation=gelu_tanh, *,
            mesh=None, ep_axis="ep"):
    """x: (B, T, D) -> ((B, T, D), aux load-balancing loss).

    With `mesh`, `params["wi"]` / `["wo"]` hold this rank's experts (its
    block of E over `ep_axis`, `moe_param_specs`) and every rank of the
    axis calls it: the output is summed over the axis, which is what the
    JAX function computes under `jit` with `moe_param_specs()`, and the
    gradients are that function's too (x's and gate's whole on every
    rank): the experts' path enters through f, the gate values too, so
    the partial cotangents of this rank's experts are summed over the
    axis, while the routing and the aux loss, which every rank computes
    whole, are not."""
    b, t, d = x.shape
    e = params["gate"].shape[1]
    x2 = x.reshape(b * t, d)
    logits = torch.matmul(x2.float(), params["gate"].float())
    idx, gate_val, pos, keep, probs, capacity = route(logits, e,
                                                      capacity_factor)
    # load-balance aux loss (Switch Transformer eq. 4)
    density = F.one_hot(idx, e).to(probs.dtype).mean(0)
    aux_loss = e * torch.sum(density * probs.mean(0))
    gate_val = gate_val.to(x.dtype)
    first = 0
    if mesh is not None:
        _comm.check_devices(mesh, x, *params.values())
        group = mesh.group(ep_axis)
        x2 = _comm.f_identity_bwd_psum(x2, group)
        gate_val = _comm.f_identity_bwd_psum(gate_val, group)
        first = mesh.axis_index(ep_axis) * params["wi"].shape[0]
    out = experts(x2, idx, gate_val, pos, keep, params["wi"], params["wo"],
                  first, capacity, activation)
    if mesh is not None:
        out = _comm.g_psum_bwd_identity(out, group)
    return out.view(b, t, d), aux_loss
