"""Mixture-of-Experts layer (port of ``repro/models/moe.py``; deepseek-v2-lite,
arctic).

Two implementations, selected by ``cfg.moe_impl``, with the reference's
grouping (``cfg.moe_group`` tokens a group), capacity rounding and drops:

* ``"gshard"``: capacity-bounded one-hot dispatch and combine einsums over
  (group, tokens, E, C).
* ``"sort"``: the same slots filled and read back by index (scatter and
  gather), with no dispatch products.

Both return (output, aux), aux holding the load-balance and router z-losses.
The reference computes all of this outside any Pallas kernel, so it stays
plain PyTorch here (matrix products and einsums).

Two differences from JAX are handled: ``F.one_hot`` raises on an index
>= C where ``jax.nn.one_hot`` gives a zero row (the reference relies on that
for dropped tokens), so ``_one_hot`` compares against ``arange``; and the
top-k breaks ties by the lower expert index, as ``jax.lax.top_k`` does,
through a stable descending sort (bf16 router logits tie often).

Under a mesh (``_moe_mesh``) the layer runs on each rank's rows in whole
groups, its aux losses reduced over the batch split, with expert
parallelism: the expert weights keep their split over ``model`` (the
reference's ``"experts": ("model",)``), each rank runs its own E / m
experts on its slice of the (E, G, C, D) slot table, and the combine's sum
over experts is a partial sum over ``model``, reduced on the (rows, D)
activations.  That is exact for the port's placements: a rank's tokens are
replicated over ``model`` (the batch splits over the batch axes only), so
every rank of a ``model`` group routes the same tokens to the same slots,
and no all-to-all is needed.  (Where the tokens are split over a mesh dim
that splits the experts, they are gathered over it first: an all-to-all
would exchange the slots instead, and no rule of the port places them so.)
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dense_init, dtype_of, glu_mlp,
                                       init_glu_mlp)
from repro_torch.parallel.sharding import (batch_placements, gathered,
                                          local_offset, run_local)


class MoE(nn.Module):
    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        d, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
        dt = dtype_of(cfg.param_dtype)
        self.w_router = dense_init(gen, (d, E), d, dt, device)
        self.experts_wi = dense_init(gen, (E, d, Fe), d, dt, device)
        self.experts_wg = dense_init(gen, (E, d, Fe), d, dt, device)
        self.experts_wo = dense_init(gen, (E, Fe, d), Fe, dt, device)
        if cfg.n_shared_experts:
            self.shared = init_glu_mlp(gen, d, cfg.n_shared_experts * Fe, dt,
                                       device)


def init_moe(gen, cfg: ModelConfig, device) -> MoE:
    return MoE(gen, cfg, device)


def _one_hot(idx, n, dtype):
    """``jax.nn.one_hot``: a zero row where ``idx`` is out of [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(x, k):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, xf, cfg: ModelConfig, n_tokens=None):
    """xf: (G, T, D) grouped tokens -> top-k experts, gates, aux losses.
    With ``n_tokens`` (the global token count, under a mesh) the aux
    terms come back as this rank's sums over ``n_tokens``: (me, ce,
    z) to be reduced over the batch split before the product."""
    E, k = cfg.n_experts, cfg.top_k
    logits = (xf @ p.w_router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, k)  # (G,T,k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    # Switch-style load-balance loss + router z-loss
    first = _one_hot(expert_ids[..., 0], E, torch.float32)
    lse2 = torch.square(torch.logsumexp(logits, dim=-1))
    if n_tokens is not None:
        return expert_ids, gate_vals, (probs.sum(dim=(0, 1)) / n_tokens,
                                       first.sum(dim=(0, 1)) / n_tokens,
                                       lse2.sum() / n_tokens)
    me = probs.mean(dim=(0, 1))  # (E,)
    ce = first.mean(dim=(0, 1))
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(lse2)
    return expert_ids, gate_vals, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def _positions_in_expert(expert_ids, E):
    """expert_ids: (G,T,k) -> per-slot position of each token in its expert's
    queue (G,T,k), counting all slots in token order then slot order."""
    oh = _one_hot(expert_ids, E, torch.int64)  # (G,T,k,E)
    tok_counts = oh.sum(2)  # (G,T,E)
    cum_prev_tokens = torch.cumsum(tok_counts, dim=1) - tok_counts  # exclusive
    intra = torch.cumsum(oh, dim=2) - oh  # slots before this one, same token
    ids = expert_ids[..., None]
    base = cum_prev_tokens[:, :, None, :].expand_as(oh).gather(-1, ids)[..., 0]
    off = intra.gather(-1, ids)[..., 0]
    return base + off  # (G,T,k)


def _capacity(cfg: ModelConfig, T):
    c = int(math.ceil(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8


def _group(cfg: ModelConfig, n: int) -> int:
    """Tokens a group, from the global token count ``n``."""
    grp = cfg.moe_group
    return grp if n % grp == 0 and n >= grp else n


def moe_layer(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """x: (B,S,D) -> (B,S,D), aux losses."""
    B, S, D = x.shape
    cdt = dtype_of(cfg.compute_dtype)
    T = _group(cfg, B * S)
    if isinstance(x, DTensor):
        return _moe_mesh(p, x, cfg, T)
    xf = x.reshape((B * S) // T, T, D).to(cdt)
    expert_ids, gates, aux = _route(p, xf, cfg)
    out = _dispatch(p, xf, expert_ids, gates, cfg, T)
    if cfg.n_shared_experts:
        out = out + glu_mlp(p.shared, xf, cdt)
    return out.reshape(B, S, D).to(x.dtype), aux


def _dispatch(p, xf, expert_ids, gates, cfg, T, experts=None):
    """The routed tokens through the experts and back.  ``experts`` =
    (e0, n): ``p`` holds experts [e0, e0 + n) only (expert parallelism),
    and the output is their share of the combine, a partial sum."""
    C = _capacity(cfg, T)
    pos = _positions_in_expert(expert_ids, cfg.n_experts)  # (G,T,k)
    keep = pos < C
    gates = gates * keep
    experts = experts or (0, cfg.n_experts)
    if cfg.moe_impl == "sort":
        return _moe_sort(p, xf, expert_ids, gates, pos, keep, C, cfg,
                         experts)
    if cfg.moe_impl == "gshard":
        return _moe_gshard(p, xf, expert_ids, gates, pos, keep, C, cfg,
                           experts)
    raise ValueError(f"moe_impl={cfg.moe_impl!r}: gshard | sort")


def _moe_mesh(p, x, cfg: ModelConfig, T):
    """The MoE layer on a DTensor ``x``: the router, the dispatch and the
    experts run on each rank's rows (``run_local``), in groups of ``T``
    tokens chosen from the global token count.  A rank must hold whole
    groups: where its rows do not, they are gathered first (every rank
    then routes every group).  The load-balance loss is E * sum(me * ce)
    of the global means, so each rank's sums are reduced over the batch
    split before the product; the z-loss likewise.  The expert weights are
    read in their compute placements (gathered over the fsdp dims, their
    split of E over ``model`` kept): each rank runs the experts it holds,
    and its output, a partial sum over the experts, is reduced over the
    mesh dims that split them.  Their gradients stay split there and are
    reduced over the batch split.  The shared experts run tensor-parallel
    on the DTensor."""
    B, S, D = x.shape
    E = cfg.n_experts
    cdt = dtype_of(cfg.compute_dtype)
    mesh = x.device_mesh
    whole = [Replicate()] * mesh.ndim
    router = p.w_router.redistribute(mesh, whole)
    ws = [gathered(w) for w in (p.experts_wi, p.experts_wg, p.experts_wo)]
    ep = [i for i, pl in enumerate(ws[0].placements) if pl == Shard(0)]
    e0, n_local = local_offset(ws[0], 0)
    here = batch_placements(x)
    xl = x.redistribute(mesh, [Replicate() if i in ep else pl
                               for i, pl in enumerate(here)])
    if (local_offset(xl, 0)[1] * S) % T:
        xl = xl.redistribute(mesh, whole)
    # every output is a partial sum over the expert dims, so that every
    # input's gradient is one there: the router's statistics, the same on
    # each rank of an expert group, are counted by its first rank alone
    sums = [Partial() if pl == Shard(0) or i in ep else Replicate()
            for i, pl in enumerate(xl.placements)]
    partial = [Partial() if i in ep else pl
               for i, pl in enumerate(xl.placements)]
    own_stats = 1.0 if e0 == 0 else 0.0

    def local(xs, w_router, wi, wg, wo):
        ex = SimpleNamespace(w_router=w_router, experts_wi=wi,
                             experts_wg=wg, experts_wo=wo)
        xf = xs.reshape(-1, T, D).to(cdt)
        expert_ids, gates, stats = _route(ex, xf, cfg, B * S)
        out = _dispatch(ex, xf, expert_ids, gates, cfg, T,
                        experts=(e0, n_local))
        return (out.reshape(xs.shape),) + tuple(t * own_stats for t in stats)

    out, me, ce, z = run_local(local, xl, router, *ws,
                               out=(partial, sums, sums, sums))
    me, ce, z = (t.redistribute(mesh, whole) for t in (me, ce, z))
    out = out.redistribute(mesh, here)
    if cfg.n_shared_experts:
        out = out + glu_mlp(p.shared, x.to(cdt), cdt)
    return out.to(x.dtype), {"moe_lb_loss": E * torch.sum(me * ce),
                             "moe_z_loss": z}


def _expert_ffn(p, xe, cdt):
    """xe: (E, G, C, D) -> (E, G, C, D)."""
    h = torch.einsum("egcd,edf->egcf", xe, p.experts_wi.to(cdt))
    g = torch.einsum("egcd,edf->egcf", xe, p.experts_wg.to(cdt))
    return torch.einsum("egcf,efd->egcd", F.silu(g) * h, p.experts_wo.to(cdt))


def _moe_gshard(p, xf, expert_ids, gates, pos, keep, C, cfg, experts):
    e0, n = experts
    cdt = xf.dtype
    # combine[g,t,e,c] = sum_j gate_j * 1[e=e_j] * 1[c=pos_j], over the
    # experts [e0, e0 + n) held here
    oh_e = _one_hot(expert_ids - e0, n, cdt)  # (G,T,k,n); others: zero rows
    oh_c = _one_hot(pos, C, cdt)  # (G,T,k,C); dropped slots: zero rows
    combine = torch.einsum("gtk,gtke,gtkc->gtec", gates.to(cdt), oh_e, oh_c)
    dispatch = (combine > 0).to(cdt)
    xe = torch.einsum("gtec,gtd->egcd", dispatch, xf)  # (E,G,C,D)
    ye = _expert_ffn(p, xe, cdt)
    return torch.einsum("gtec,egcd->gtd", combine, ye)


def _moe_sort(p, xf, expert_ids, gates, pos, keep, C, cfg, experts):
    """Dispatch without products: scatter tokens into an (E,G,C,D) slot
    table by index, gather back with gates.  Dropped tokens, and tokens
    routed to experts not held here (outside [e0, e0 + n)), go to a trash
    slot."""
    G, T, D = xf.shape
    e0, E = experts
    k = cfg.top_k
    cdt = xf.dtype
    expert_ids = expert_ids - e0
    keep = keep & (expert_ids >= 0) & (expert_ids < E)
    gates = gates * keep
    slot = torch.where(keep, expert_ids * C + pos, E * C)  # E*C = trash
    flat_slots = slot.reshape(G, T * k)
    tok_idx = torch.arange(T, device=xf.device).repeat_interleave(k)
    rows = torch.arange(G, device=xf.device)[:, None]
    # one writer a slot by construction (the trash slot is never read)
    xe = torch.zeros((G, E * C + 1, D), dtype=cdt, device=xf.device)
    xe[rows, flat_slots] = xf[:, tok_idx]
    xe = xe[:, :E * C].reshape(G, E, C, D).permute(1, 0, 2, 3)  # (E,G,C,D)
    ye = _expert_ffn(p, xe, cdt)
    ye = ye.permute(1, 0, 2, 3).reshape(G, E * C, D)
    # gather back per slot and weight by gate (trash slots have gate 0)
    gathered = ye[rows, torch.clamp_max(flat_slots, E * C - 1)]
    gathered = gathered.reshape(G, T, k, D)
    return torch.einsum("gtk,gtkd->gtd", gates.to(cdt), gathered)
