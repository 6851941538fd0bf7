"""Composite 5-axis parallelism: dp x pp x tp x sp x ep in ONE train step
(counterpart of `mxnet_tpu/parallel/composite.py`, the framework's
flagship distributed path).

The JAX package runs the step as one `shard_map` over a 5-axis mesh.
The port runs one process a card over `torch.distributed` (NCCL on the
cards, gloo when the caller asks for the CPU), and each rank runs the
`shard_map` body on its own blocks:

  dp — batch sharded; gradient sum over 'dp'
  pp — GPipe pipeline: each stage owns n_layers / pp transformer layers,
       microbatch activations rotate with `_comm.ppermute` ticks
       (`pipeline.gpipe_ticks`)
  tp — Megatron tensor parallelism: QKV / FFN-in column-parallel,
       out / FFN-out row-parallel, entered through f (identity forward,
       sum backward) and left through g (sum forward, identity
       backward), the biases added after g
  sp — sequence parallelism, ring (`ring_attention`) or all-to-all
       (`ulysses_attention`) over the flash kernels
  ep — MoE experts sharded; every rank routes over all experts and
       computes its own, the outputs summed over 'ep' through g

The gradient algebra is the JAX package's, explicit:
  * each rank differentiates its local loss, -sum(ll) / (batch *
    seq_len); the loss is summed over ('dp', 'sp') in the forward only;
  * every gradient is summed over ('dp', 'sp');
  * embed / pos also over 'pp' (only stage 0's ranks get their
    cotangent through the pipeline);
  * gate also over 'ep' (each rank backprops its own experts' routing);
  * nothing else over 'tp' / 'ep': f makes the residual stream's
    cotangent whole again at each branch entry.
The update is SGD, p - lr * g, in place under `torch.no_grad()` (the
JAX package donates the parameters).

Every rank runs the same program and issues each group's collectives in
one order: the only branches are the pipeline stage's (the ranks of a
stage skip the same idle ticks) and the mesh's sizes. With
`capacity_factor >= n_experts` no token is dropped and any factorisation
gives the one-rank step's numbers; with a tight capacity, which tokens
overflow depends on the dp / sp shard, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..context import resolve_device
from ..ops.kernels import fused_layer_norm
from . import _comm
from .mesh import P, Sharding, make_mesh
from .moe import experts, gelu_tanh, route
from .pipeline import gpipe_ticks
from .ring_attention import ring_attention
from .ulysses import ulysses_attention

__all__ = ["CompositeConfig", "make_composite_mesh", "init_composite_params",
           "make_composite_train_step", "f_identity_bwd_psum",
           "g_psum_bwd_identity", "composite_param_specs"]

AXES = ("dp", "pp", "tp", "sp", "ep")


class CompositeConfig(NamedTuple):
    vocab: int = 128
    d_model: int = 64
    n_heads: int = 4
    d_head: int = 16
    d_ff: int = 128
    n_experts: int = 4
    d_expert_ff: int = 64
    n_layers: int = 2
    seq_len: int = 32
    batch: int = 8
    n_micro: int = 2
    capacity_factor: float = 2.0
    lr: float = 0.1
    remat: bool = False   # checkpoint each transformer layer: trade
                          # recompute FLOPs for activation memory (long-seq
                          # / big-batch configs)
    sp_strategy: str = "ring"   # 'ring' (ppermute K/V rotation) or
                                # 'alltoall' (Ulysses head reshuffle);
                                # numerically interchangeable, different
                                # comms profiles — see parallel/ulysses.py


# ---------------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------------
def make_composite_mesh(n_devices, priority=("dp", "tp", "sp", "pp", "ep"),
                        devices=None, n_layers=None):
    """Factorise n_devices over the 5 axes (unused axes get size 1).

    Prime factors are dealt round-robin to `priority` so as many axes as
    possible are >1 (e.g. 8 -> dp2*tp2*sp2; 16 -> dp2*tp2*sp2*pp2).

    Pass `n_layers` to keep the factorisation pp-compatible with your
    model: any factor that would make `pp` stop dividing `n_layers`
    is dealt to the next axis in `priority` instead (GPipe needs
    n_layers % pp == 0 — see make_composite_train_step).

    The devices are ranks of the default group (`devices`, default all
    of them, `make_mesh`); every rank calls it.
    """
    sizes = {ax: 1 for ax in AXES}
    n = n_devices
    factors = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.append(d)
            n //= d
        d += 1
    if n > 1:
        factors.append(n)
    for i, f in enumerate(sorted(factors, reverse=True)):
        order = [priority[(i + j) % len(priority)]
                 for j in range(len(priority))]
        ax = next((a for a in order
                   if a != "pp" or n_layers is None
                   or n_layers % (sizes["pp"] * f) == 0), "dp")
        sizes[ax] *= f
    if devices is not None:
        devices = list(devices)[:n_devices]
    return make_mesh({ax: sizes[ax] for ax in AXES}, devices)


# ---------------------------------------------------------------------------
# Megatron's conjugate operators on a mesh axis
# ---------------------------------------------------------------------------
def f_identity_bwd_psum(x, axis_name, *, mesh):
    """Megatron's `f`: marks entry into an `axis_name`-parallel branch.

    Forward is the identity; backward sums the cotangent over `axis_name`,
    restoring replication of the residual-stream gradient so no manual sum
    over the model-parallel axis is ever needed for upstream parameters.
    """
    return _comm.f_identity_bwd_psum(x, mesh.group(axis_name))


def g_psum_bwd_identity(x, axis_name, *, mesh):
    """Megatron's `g`: forward sum over the model-parallel axis, backward
    identity (a bare all-reduce under autograd would sum the cotangent
    again)."""
    return _comm.g_psum_bwd_identity(x, mesh.group(axis_name))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _param_shapes(cfg: CompositeConfig):
    """{name: (shape, init)} of init_composite_params' leaves, the tree
    nested as its own: init "ones", "zeros" or the scale of a normal
    draw."""
    c = cfg
    s_d = 1.0 / (c.d_model ** 0.5)
    s_f = 1.0 / (c.d_ff ** 0.5)
    s_h = 1.0 / ((c.n_heads * c.d_head) ** 0.5)
    s_e = 1.0 / (c.d_expert_ff ** 0.5)
    L, D = c.n_layers, c.d_model
    blocks = {
        "ln1_g": ((L, D), "ones"), "ln1_b": ((L, D), "zeros"),
        "ln2_g": ((L, D), "ones"), "ln2_b": ((L, D), "zeros"),
        "ln3_g": ((L, D), "ones"), "ln3_b": ((L, D), "zeros"),
        "wq": ((L, D, c.n_heads, c.d_head), s_d),
        "wk": ((L, D, c.n_heads, c.d_head), s_d),
        "wv": ((L, D, c.n_heads, c.d_head), s_d),
        "wo": ((L, c.n_heads, c.d_head, D), s_h),
        "bo": ((L, D), "zeros"),
        "w1": ((L, D, c.d_ff), s_d),
        "b1": ((L, c.d_ff), "zeros"),
        "w2": ((L, c.d_ff, D), s_f),
        "b2": ((L, D), "zeros"),
        "gate": ((L, D, c.n_experts), s_d),
        "wi_e": ((L, c.n_experts, D, c.d_expert_ff), s_d),
        "wo_e": ((L, c.n_experts, c.d_expert_ff, D), s_e),
    }
    return {"embed": ((c.vocab, D), 1.0), "pos": ((c.seq_len, D), 0.02),
            "lnf_g": ((D,), "ones"), "lnf_b": ((D,), "zeros"),
            "lm_head": ((D, c.vocab), s_d), "blocks": blocks}


def init_composite_params(generator, cfg: CompositeConfig,
                          dtype=torch.float32, device=None):
    """Global (unsharded) parameter pytree on `device` (None =
    `mx.gpu(0)`), normal draws from `generator` (on its device) scaled as
    the JAX package's. Block params carry a leading layer axis of length
    n_layers that shards over 'pp'."""
    dev = resolve_device(device)

    def make(shape, init):
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * init).to(dtype=dtype, device=dev)
    table = _param_shapes(cfg)
    paths = [p for p, _ in _leaves_with_paths(table)]
    return _rebuild(paths, [make(*v) for _, v in _leaves_with_paths(table)])


def composite_param_specs():
    """PartitionSpec pytree matching init_composite_params."""
    blocks = {
        "ln1_g": P("pp", None), "ln1_b": P("pp", None),
        "ln2_g": P("pp", None), "ln2_b": P("pp", None),
        "ln3_g": P("pp", None), "ln3_b": P("pp", None),
        "wq": P("pp", None, "tp", None),
        "wk": P("pp", None, "tp", None),
        "wv": P("pp", None, "tp", None),
        "wo": P("pp", "tp", None, None),
        "bo": P("pp", None),
        "w1": P("pp", None, "tp"), "b1": P("pp", "tp"),
        "w2": P("pp", "tp", None), "b2": P("pp", None),
        "gate": P("pp", None, None),
        "wi_e": P("pp", "ep", None, None),
        "wo_e": P("pp", "ep", None, None),
    }
    return {"embed": P(), "pos": P(), "lnf_g": P(), "lnf_b": P(),
            "lm_head": P(), "blocks": blocks}


# ---------------------------------------------------------------------------
# per-rank model pieces (the shard_map body)
# ---------------------------------------------------------------------------
def _ln(x, g, b, eps=1e-5):
    """LayerNorm over the last axis: the port's kernel (biased variance,
    the JAX `_ln`'s formula)."""
    return fused_layer_norm(x, g, b, eps)


def _attention(bp, h, cfg, mesh):
    """Megatron TP attention with sequence parallelism over 'sp' — ring
    or all-to-all per cfg.sp_strategy.
    h: (mb, S_loc, D) replicated over tp/ep; weights head-sharded over tp."""
    a = _ln(h, bp["ln1_g"], bp["ln1_b"])
    a = f_identity_bwd_psum(a, "tp", mesh=mesh)
    mb, s, d = a.shape
    _, hl, dh = bp["wq"].shape
    a2 = a.reshape(mb * s, d)
    # (mb, S', Hloc, Dh)
    q, k, v = (torch.matmul(a2, bp[w].reshape(d, hl * dh)).view(
        mb, s, hl, dh) for w in ("wq", "wk", "wv"))
    if cfg.sp_strategy == "alltoall":
        o = ulysses_attention(q, k, v, "sp", causal=True, mesh=mesh)
    else:
        o = ring_attention(*(t.transpose(1, 2).contiguous()
                             for t in (q, k, v)), "sp", causal=True,
                           mesh=mesh).transpose(1, 2)
    out = torch.matmul(o.reshape(mb * s, hl * dh),
                       bp["wo"].reshape(hl * dh, d)).view(mb, s, d)
    out = g_psum_bwd_identity(out, "tp", mesh=mesh) + bp["bo"]
    return h + out


def _dense_ffn(bp, h, mesh):
    """Column/row-parallel MLP over 'tp'."""
    a = _ln(h, bp["ln2_g"], bp["ln2_b"])
    a = f_identity_bwd_psum(a, "tp", mesh=mesh)
    u = gelu_tanh(torch.matmul(a, bp["w1"]) + bp["b1"])
    y = torch.matmul(u, bp["w2"])
    y = g_psum_bwd_identity(y, "tp", mesh=mesh) + bp["b2"]
    return h + y


def _moe_ffn(bp, h, cfg, mesh):
    """Top-1 MoE with experts sharded over 'ep'. Routing is over ALL
    experts (its decisions must be global); this rank computes its
    e / ep experts, and the outputs are summed over 'ep'."""
    a = _ln(h, bp["ln3_g"], bp["ln3_b"])
    a = f_identity_bwd_psum(a, "ep", mesh=mesh)
    mb, s_loc, d = a.shape
    a2 = a.reshape(mb * s_loc, d)
    idx, gate_val, pos, keep, _, capacity = route(
        torch.matmul(a2, bp["gate"]), cfg.n_experts, cfg.capacity_factor)
    e_loc = bp["wi_e"].shape[0]
    out = experts(a2, idx, gate_val, pos, keep, bp["wi_e"], bp["wo_e"],
                  mesh.axis_index("ep") * e_loc, capacity, gelu_tanh)
    out = g_psum_bwd_identity(out.view(mb, s_loc, d), "ep", mesh=mesh)
    return h + out


def _layer(bp, x, cfg, mesh):
    x = _attention(bp, x, cfg, mesh)
    x = _dense_ffn(bp, x, mesh)
    return _moe_ffn(bp, x, cfg, mesh)


def _unstack(blocks_local):
    """The stacked block leaves (L/pp, ...) as one dict of views a layer,
    unbound once a step: the backward then stacks each leaf's layer
    gradients in one copy (taking v[i] a use would add a zero-filled
    full-size gradient for every layer and microbatch)."""
    keys = list(blocks_local)
    return [dict(zip(keys, vals)) for vals in
            zip(*(blocks_local[k].unbind(0) for k in keys))]


def _stage_fn(layers, h, cfg, mesh):
    """Apply this rank's transformer layers (`_unstack`'s list)
    sequentially. With cfg.remat each layer is recomputed in the backward
    (non-reentrant `checkpoint`), which issues its collectives again, in
    the same order on every rank, so only layer BOUNDARY activations are
    kept live."""
    for bp in layers:
        if cfg.remat:
            h = checkpoint(_layer, bp, h, cfg, mesh, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _layer(bp, h, cfg, mesh)
    return h


def _gpipe(blocks_local, x, cfg, mesh, anchor):
    """GPipe over 'pp'. x: (B_loc, S_loc, D); blocks_local leaves:
    (L/pp, ...). Each microbatch goes through the layers on its own, so
    the MoE's capacity is a microbatch's (the JAX package vmaps over
    them)."""
    pp = mesh.shape["pp"]
    n_micro = cfg.n_micro
    b_loc = x.shape[0]
    xm = x.reshape(n_micro, b_loc // n_micro, *x.shape[1:])

    layers = _unstack(blocks_local)

    def stage(h):
        return _stage_fn(layers, h, cfg, mesh)

    if pp == 1:
        return torch.cat([stage(xm[m]) for m in range(n_micro)])
    outs = gpipe_ticks(stage, xm, mesh.group("pp"), pp,
                       mesh.axis_index("pp"), anchor)
    # real outputs live on the last stage (zeros elsewhere); every pp
    # rank gets them
    outs = g_psum_bwd_identity(outs, "pp", mesh=mesh)
    return outs.reshape(b_loc, *x.shape[1:])


def _leaves_with_paths(tree, prefix=()):
    """(path, leaf) of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rebuild(paths, values):
    out = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


# ---------------------------------------------------------------------------
# full train step
# ---------------------------------------------------------------------------
def make_composite_train_step(mesh, cfg: CompositeConfig):
    """Returns (step, shard_params, data_sharding).

    step(params, tokens, targets) -> (params, loss): one SGD step of the
    5-axis-parallel causal LM on this rank, which every rank of `mesh`
    runs. `params` is this rank's blocks (`shard_params` of the global
    tree), updated in place and returned; tokens / targets (int) this
    rank's block of the global (batch, seq_len) arrays
    (`data_sharding.place`); loss the global batch's (a 0-d tensor,
    equal on every rank). The step is eager.
    """
    mesh_shape = dict(mesh.shape)
    if set(mesh_shape) != set(AXES):
        raise ValueError(f"the composite step wants a mesh over {AXES}, "
                         f"got {tuple(mesh_shape)}")
    divisibility = [
        ("n_layers", cfg.n_layers, "pp",
         "pipeline stages each own n_layers/pp layers — rebuild the mesh "
         "with make_composite_mesh(n, n_layers=...) to steer pp"),
        ("n_heads", cfg.n_heads, "tp", "heads are column-split over tp"),
        ("d_ff", cfg.d_ff, "tp", "the MLP hidden dim is split over tp"),
        ("seq_len", cfg.seq_len, "sp", "the sequence is split over sp"),
        ("n_experts", cfg.n_experts, "ep", "experts are sharded over ep"),
    ]
    for name, value, ax, why in divisibility:
        if value % mesh_shape[ax] != 0:
            raise ValueError(
                f"CompositeConfig.{name}={value} is not divisible by the "
                f"mesh's {ax}={mesh_shape[ax]}: {why}")
    if cfg.batch % (mesh_shape["dp"] * cfg.n_micro) != 0:
        raise ValueError(
            f"CompositeConfig.batch={cfg.batch} must be divisible by "
            f"dp*n_micro={mesh_shape['dp']}*{cfg.n_micro} (each dp shard "
            "splits its local batch into n_micro pipeline microbatches)")
    if cfg.sp_strategy not in ("ring", "alltoall"):
        raise ValueError(f"unknown sp_strategy {cfg.sp_strategy!r}")
    if cfg.sp_strategy == "alltoall":
        # ulysses shards the tp-LOCAL head set over 'sp'
        if (cfg.n_heads // mesh_shape["tp"]) % mesh_shape["sp"] != 0:
            raise ValueError(
                f"sp_strategy='alltoall' reshuffles the tp-local head set "
                f"over sp: n_heads/tp={cfg.n_heads // mesh_shape['tp']} "
                f"must be divisible by sp={mesh_shape['sp']} (use "
                f"sp_strategy='ring' or adjust n_heads)")

    n_total_tokens = cfg.batch * cfg.seq_len
    specs = composite_param_specs()
    paths = [p for p, _ in _leaves_with_paths(specs)]
    # the gradients' groups, made here in one order on every rank
    data_axes = mesh.group(("dp", "sp"))
    sum_over = {("embed",): mesh.group(("dp", "pp", "sp")),
                ("pos",): mesh.group(("dp", "pp", "sp")),
                ("blocks", "gate"): mesh.group(("dp", "sp", "ep"))}
    groups = [sum_over.get(p, data_axes) for p in paths]
    sp_idx = mesh.axis_index("sp")

    def loss_fn(p, tokens, targets):
        s_loc = tokens.shape[1]
        x = F.embedding(tokens, p["embed"])
        x = x + p["pos"][sp_idx * s_loc:(sp_idx + 1) * s_loc][None]
        x = _gpipe(p["blocks"], x, cfg, mesh, p["blocks"]["ln1_g"])
        x = _ln(x, p["lnf_g"], p["lnf_b"])
        logits = torch.matmul(x, p["lm_head"])
        # fp32 at least (the JAX step's astype(float32); float64 stays)
        logp = torch.log_softmax(logits.to(torch.promote_types(
            logits.dtype, torch.float32)), dim=-1)
        ll = logp.gather(-1, targets[..., None])[..., 0]
        # differentiate the LOCAL share only; the cross-rank sum happens
        # once, on the gradients below
        return -ll.sum() / n_total_tokens

    def step(params, tokens, targets):
        leaves = [v for _, v in _leaves_with_paths(params)]
        _comm.check_devices(mesh, tokens, targets, *leaves)
        inputs = [v.detach().requires_grad_(True) for v in leaves]
        with torch.enable_grad():
            local = loss_fn(_rebuild(paths, inputs), tokens.long(),
                            targets.long())
            grads = torch.autograd.grad(local, inputs, allow_unused=True)
        loss = _comm.psum(local, data_axes)
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(leaves, grads)]
        _sum_grads(grads, groups)
        # in place: the step owns `params` as the JAX step's donation does
        with torch.no_grad():
            for v, g in zip(leaves, grads):
                v.sub_(g.mul_(cfg.lr).to(v.dtype))
        return params, loss

    def shard_params(params):
        """This rank's blocks of the global tree, fresh copies on the
        mesh's device (the step updates them in place)."""
        return _rebuild(paths, [
            Sharding(mesh, s).place(v).clone(
                memory_format=torch.contiguous_format)
            for (_, v), s in zip(_leaves_with_paths(params),
                                 [s for _, s in _leaves_with_paths(specs)])])

    return step, shard_params, Sharding(mesh, P("dp", "sp"))


def _sum_grads(grads, groups):
    """Sum each gradient over its group, one all-reduce a group over the
    gradients flattened together, in one order on every rank; groups of
    one rank are skipped."""
    by_group = {}
    for i, g in enumerate(groups):
        if dist.get_world_size(g) > 1:
            by_group.setdefault(id(g), (g, []))[1].append(i)
    for g, idx in by_group.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=g)
        off = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[off:off + n].view_as(grads[i])
            off += n
