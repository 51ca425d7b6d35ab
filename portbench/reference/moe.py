"""The reference's mixture of experts: which experts hold which tokens, and
the exchange of the experts' partial sums between processes.

A MoE layer routes each token to its ``top_k`` experts, in groups of
``moe_group`` tokens (a group lies within a row: the reference runs row
by row).  Each expert takes at most its capacity of a group's (token,
choice) slots, counted in token order, then choice order; the rest are
dropped.  A token's gates are its router probabilities at its experts,
renormalised to sum to 1, and a dropped slot's gate is 0.

:class:`Routing` holds the experts chosen for a batch: those the program
chose, recorded while it ran (the check then compares arithmetic, not
which side of a near tie rounding put a token), or, where none are given,
the reference's own top-k from a first pass without gradients.  The
load-balance term needs each microbatch's share of first choices by
expert (``ce``), which the routes fix, so the reference still runs row by
row: a row's part of ``E sum_e me_e ce_e`` is ``E sum_e ce_e`` times its
tokens' mean probability of ``e``, and its part of the z-loss its tokens'
mean squared log-sum-exp, each over the rows of the batch.

:class:`Split` gives a process its share of the experts when several
hold them, ``E / world`` each: the routed output is the sum over
processes of each one's experts' part, exchanged by
``torch.distributed.all_reduce``.  Every process computes the rest of the
model whole, on the same rows.  It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def group(m: dict, tokens: int) -> int:
    """Tokens a routing group, for a microbatch of ``tokens``."""
    g = m["moe_group"]
    return g if tokens % g == 0 and tokens >= g else tokens


def capacity(m: dict, T: int) -> int:
    """Slots an expert takes from a group of ``T`` tokens: the capacity
    factor's share, rounded up to a multiple of 8, at least 8."""
    c = math.ceil(m["capacity_factor"] * T * m["top_k"] / m["n_experts"])
    return max(8, -(-c // 8) * 8)


def top_k(probs, k):
    """The k most probable experts, ties to the lower index."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]


def positions(ids, E):
    """Each (token, choice)'s place in its expert's queue within its group:
    the slots before it that chose the same expert, counted in token
    order, then choice order.  ids (G, T, k)."""
    G, T, k = ids.shape
    hot = F.one_hot(ids.reshape(G, T * k), E)  # slots in that order
    return ((torch.cumsum(hot, 1) - hot) * hot).sum(-1).reshape(G, T, k)


class _Combine(torch.autograd.Function):
    """The sum over processes of their partial sums; its gradient, the
    loss's, is the same on every process and passes as it is."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """The identity into a process's experts; its gradient is the sum of
    every process's experts' parts."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class Split:
    """This process's share of every MoE layer's experts: rank ``rank`` of
    ``world`` holds experts [rank E / world, (rank + 1) E / world).  With
    ``world`` 1 it holds them all and exchanges nothing.  ``drop``: the
    rank whose share the combine leaves out (a fault planted to show what
    a lost exchange does to the check)."""

    def __init__(self, rank: int = 0, world: int = 1, group=None,
                 drop: Optional[int] = None):
        self.rank, self.world, self.group, self.drop = rank, world, group, drop

    def experts(self, E: int):
        n = E // self.world
        return self.rank * n, n

    def local(self, t):
        """A whole expert leaf's rows held here."""
        e0, n = self.experts(t.shape[0])
        return t[e0:e0 + n]

    def enter(self, t):
        return t if self.world == 1 else _Enter.apply(t, self.group)

    def combine(self, t):
        if self.drop == self.rank:
            t = t * 0.0
        return t if self.world == 1 else _Combine.apply(t, self.group)

    def total(self, x: float) -> float:
        """The sum over processes of ``x``."""
        if self.world == 1:
            return x
        t = torch.tensor([x], dtype=torch.float64)
        if dist.get_backend(self.group) == "nccl":
            t = t.cuda()
        dist.all_reduce(t, group=self.group)
        return float(t[0])


class Routing:
    """The experts chosen in each step the reference follows, and how the
    processes share them.

    ``routes[step][microbatch][layer]``: (groups, moe_group, top_k) expert
    ids of the microbatch's rows in order, for each MoE layer of the plan
    in order; None for the reference's own choices.  ``microbatches``:
    how the program split a step's rows (the load-balance term is the
    microbatch's).  ``aux`` False leaves the aux losses out (a fault
    planted to show what the check sees).  After the steps, :attr:`stats`
    counts the slots taken (``slots``), those capacity dropped
    (``dropped``), those the reference's own top-k would not have chosen
    (``flips``), and the experts' capacity, in slots (``capacity``)."""

    def __init__(self, m: dict, microbatches: int, routes=None,
                 split: Optional[Split] = None, aux: bool = True):
        self.m, self.n_mb, self.routes = m, microbatches, routes
        self.split = split or Split()
        self.aux = aux
        self.step: Optional[List[List[torch.Tensor]]] = None
        self.i = 0
        self._stats: Dict[tuple, tuple] = {}

    def use(self, i: int, step: List[List[torch.Tensor]]) -> None:
        """Step ``i`` runs on ``step[microbatch][layer]``."""
        self.i, self.step = i, step

    def row(self, b: int, rows: int, record: bool = False) -> "Row":
        """Row ``b`` of a step of ``rows`` rows; ``record``: the row takes
        its own top-k and keeps it (``Row.own``)."""
        per = rows // self.n_mb
        return Row(self, b, b // per, b % per, per, record)

    def assemble(self, own_rows: List["Row"]) -> List[List[torch.Tensor]]:
        """A step's routes from its rows' own choices."""
        per = len(own_rows) // self.n_mb
        return [[torch.cat([r.own[j] for r in own_rows[mb * per:(mb + 1) * per]])
                 for j in range(len(own_rows[0].own))]
                for mb in range(self.n_mb)]

    @property
    def stats(self) -> Dict[str, int]:
        f, d, s, c = (sum(v[k] for v in self._stats.values())
                      for k in range(4))
        return {"flips": f, "dropped": d, "slots": s, "capacity": c}


class Row:
    """One row's routing through the MoE layers, and the aux terms its
    forward leaves (the last forward's: a remat recompute writes the same
    again)."""

    def __init__(self, book: Routing, b: int, mb: int, local: int, per: int,
                 record: bool):
        self.book, self.b, self.mb, self.local = book, b, mb, local
        self.per, self.record = per, record
        self.aux: Dict[int, torch.Tensor] = {}
        self.own: List[torch.Tensor] = []
        self._j: Dict[int, int] = {}  # plan layer -> its MoE layer number

    def group(self, seq_len: int) -> int:
        """Tokens a routing group; a group must lie within a row."""
        T = group(self.book.m, self.per * seq_len)
        if seq_len % T:
            raise ValueError(f"routing groups of {T} tokens span rows of "
                             f"{seq_len}: the reference runs row by row")
        return T

    def j(self, i: int) -> int:
        return self._j.setdefault(i, len(self._j))

    def ids(self, i: int, probs):
        """The row's experts at plan layer ``i``: its own top-k when
        recording (kept in :attr:`own`), else the step's (its own where
        the step's routes hold no choices for the row: a program that
        left rows out)."""
        k = self.book.m["top_k"]
        G = probs.shape[0]
        ids = None if self.record else \
            self.book.step[self.mb][self.j(i)][self.local * G:(self.local + 1) * G]
        if ids is None or ids.shape[0] != G:
            ids = top_k(probs, k)
            if self.record:
                self.own.append(ids)
            return ids
        return ids.to(probs.device).long()

    def count(self, i: int, probs, ids, keep) -> None:
        own = top_k(probs.detach(), ids.shape[-1])
        flips = int((~(ids[..., :, None] == own[..., None, :]).any(-1)).sum())
        G, T, E = probs.shape
        self.book._stats[(self.book.i, self.b, self.j(i))] = (
            flips, int((~keep).sum()), ids.numel(),
            G * E * capacity(self.book.m, T))

    def ce(self, i: int):
        """The row's microbatch's share of first choices by expert at plan
        layer ``i``."""
        first = self.book.step[self.mb][self.j(i)][..., 0].reshape(-1).long()
        return F.one_hot(first, self.book.m["n_experts"]).float().mean(0)

    def add(self, i: int, lb, z) -> None:
        m = self.book.m
        if self.book.aux and not self.record:
            self.aux[i] = m["moe_lb_coef"] * lb + m["moe_z_coef"] * z

    def total(self):
        return sum(self.aux.values())
