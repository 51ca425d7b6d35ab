"""An epicast-like metapopulation SEIR model, batched in torch (paper
Sec. 3.3; the port of ``repro/sim/epidemic.py``).

``u`` is (n, 6) in [0, 1]; ``seir_simulate(u, draws)`` takes the rows'
random draws from ``seir_draws(seeds, device)``: the patch populations'
normals, the seeding uniforms and one normal per patch a day, each from
the row's seed alone (``sim/rng.py``).  The reference's ``lax.scan`` over
days is a Python loop over days on (n, 16) tensors; a CUDA graph captures
the whole loop.

Inputs u (6,) in [0,1]:
  0 beta        base transmission rate      [0.15, 0.60]
  1 latent      1/sigma days                [2.0, 5.0]
  2 infectious  1/gamma days                [3.0, 8.0]
  3 seed        initial exposed fraction    [1e-5, 1e-3] (log)
  4 compliance  NPI contact reduction       [0.0, 0.8]
  5 start_day   NPI start day               [5, 40]
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.sim import rng as R

EPI_BOUNDS = torch.tensor([
    [0.15, 0.60],
    [2.0, 5.0],
    [3.0, 8.0],
    [-5.0, -3.0],   # log10 seed
    [0.0, 0.8],
    [5.0, 40.0],
])

N_PATCH = 16
T_DAYS = 60

# float32 bounds as Python floats (no host data moves inside a capture)
_LO = EPI_BOUNDS[:, 0].tolist()
_SPAN = (EPI_BOUNDS[:, 1] - EPI_BOUNDS[:, 0]).tolist()


def _rescale(u: torch.Tensor):
    """The six rescaled input columns, each (n,)."""
    u = torch.clamp(u, 0, 1)
    return [lo + u[:, j] * span for j, (lo, span) in enumerate(zip(_LO, _SPAN))]


def seir_draws(seeds: torch.Tensor, device: Optional[torch.device] = None,
               t_days: int = T_DAYS) -> Dict[str, torch.Tensor]:
    """Each row's draws from its seed: ``pop`` (n, 16) normals, ``patch``
    (n, 16) uniforms, ``daily`` (n, t_days, 16) normals."""
    seeds = seeds.to(device) if device is not None else seeds
    return {"pop": R.normal(seeds, 1, N_PATCH),
            "patch": R.uniform(seeds, 2, N_PATCH),
            "daily": R.normal(seeds, 3, t_days * N_PATCH).view(
                -1, t_days, N_PATCH)}


def seir_simulate(u: torch.Tensor, draws: Dict[str, torch.Tensor],
                  t_days: int = T_DAYS) -> Dict[str, torch.Tensor]:
    """u: (n, 6) in [0,1] -> dict with daily new cases etc."""
    beta, lat, inf, lseed, comp, d0 = _rescale(u)
    sigma, gamma = (1.0 / lat)[:, None], (1.0 / inf)[:, None]
    seed = torch.pow(10.0, lseed)

    pop = 2000.0 * torch.exp(0.3 * draws["pop"])
    # commuting coupling: mostly local contacts, some global mixing
    mix_t = (0.85 * torch.eye(N_PATCH, device=u.device, dtype=pop.dtype)
             + 0.15 / N_PATCH).T
    seed_patch = draws["patch"] < 0.3
    E0 = pop * seed[:, None] * seed_patch
    S0 = pop - E0

    S, E = S0, E0
    I = torch.zeros_like(pop)
    R_ = torch.zeros_like(pop)
    daily = []
    for t in range(t_days):
        npi = torch.where(t >= d0, 1.0 - comp, torch.ones_like(comp))
        force = (beta * npi)[:, None] * ((I / pop) @ mix_t)
        # exp rounded once from float64: 1 - exp(-force) cancels for forces
        # near 1e-7, where one ulp of a float32 exp is ~10 % of the result,
        # so a correctly rounded exp keeps the CPU, the card and the
        # reference's XLA exp on the same float32 value
        new_e = S * (1 - torch.exp(-force.double()).to(force.dtype))
        # demographic noise, clipped to [0, S] row by row
        new_e = torch.minimum(torch.clamp(
            new_e * (1 + 0.08 * draws["daily"][:, t]), min=0.0), S)
        new_i = sigma * E
        new_r = gamma * I
        S = S - new_e
        E = E + new_e - new_i
        I = I + new_i - new_r
        R_ = R_ + new_r
        daily.append(new_i.sum(-1))
    daily = torch.stack(daily, -1)                        # (n, t_days)
    total = R_.sum(-1) + daily[:, -1]
    return {
        "daily_cases": daily.to(torch.float32),
        "attack_rate": (total / pop.sum(-1)).to(torch.float32),
        "peak_day": torch.argmax(daily, -1).to(torch.float32),
        "peak_cases": daily.max(-1).values.to(torch.float32),
        "inputs": u.to(torch.float32),
    }


seir_simulate.draws_fn = seir_draws
