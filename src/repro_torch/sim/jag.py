"""A JAG-like semi-analytic ICF implosion model, batched in torch (paper
Sec. 3.1; the port of ``repro/sim/jag.py``).

The reference maps one row at a time under ``jax.vmap``; here every
function takes the whole batch: ``u`` is (n, 5) in [0, 1] and every output
leads with n.  The row's random draws come in as an argument,
``jag_simulate(u, draws)``, made by ``jag_draws(seeds, device)`` from each
row's seed alone (``sim/rng.py``), so a parity test can hand both sides
the same numbers and a CUDA graph can capture draws and model together.

Inputs (all in [0,1], rescaled internally):
  0 scale      laser drive scale            [0.85, 1.15]
  1 thickness  shell thickness perturbation [-0.10, 0.10]
  2 asym_p2    P2 drive asymmetry           [-0.08, 0.08]
  3 asym_p4    P4 drive asymmetry           [-0.08, 0.08]
  4 dopant     ablator dopant / mix seed    [0.00, 0.08]
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from repro_torch.sim import rng as R

JAG_BOUNDS = torch.tensor([
    [0.85, 1.15],
    [-0.10, 0.10],
    [-0.08, 0.08],
    [-0.08, 0.08],
    [0.00, 0.08],
])

N_T = 32          # time-series samples
IMG = 16          # image resolution
N_VIEWS = 4


def jag_sample_inputs(rng: Union[int, torch.Generator], n: int) -> torch.Tensor:
    """Uniform (blue-noise stand-in) sampling of the 5-D input space in
    [0,1]: (n, 5) float32 on the CPU, from a seed or a CPU generator."""
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator().manual_seed(int(rng))
    return torch.rand(n, 5, generator=rng)


# float32 lower bounds and spans as Python floats: the model code moves no
# host data to the card, so a CUDA graph can capture it
_LO = JAG_BOUNDS[:, 0].tolist()
_SPAN = (JAG_BOUNDS[:, 1] - JAG_BOUNDS[:, 0]).tolist()


def _linspace(start: float, stop: float, num: int,
              device: torch.device) -> torch.Tensor:
    """``jnp.linspace``'s float32 formula: start*(1-s) + stop*s, s = i/div,
    and the endpoint itself."""
    step = torch.arange(num - 1, device=device, dtype=torch.float32) / float(num - 1)
    end = torch.full((1,), stop, device=device, dtype=torch.float32)
    return torch.cat([start * (1 - step) + stop * step, end])


def _rescale(u: torch.Tensor):
    """The five rescaled input columns, each (n,)."""
    return [lo + u[:, j] * span for j, (lo, span) in enumerate(zip(_LO, _SPAN))]


def jag_draws(seeds: torch.Tensor,
              device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Each row's draws from its seed: the image noise, (n, 4, 16, 16)."""
    seeds = seeds.to(device) if device is not None else seeds
    noise = R.normal(seeds, 0, N_VIEWS * IMG * IMG)
    return {"noise": noise.view(-1, N_VIEWS, IMG, IMG)}


def jag_simulate(u: torch.Tensor,
                 draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """u: (n, 5) in [0,1]; draws: ``jag_draws`` of the rows' seeds ->
    dict of (n,) scalars, (n, 32) series and (n, 4, 16, 16) images."""
    scale, thick, p2, p4, dop = _rescale(torch.clamp(u, 0.0, 1.0))

    # implosion dynamics (Betti-like scalings)
    vel = 340.0 * scale ** 0.6 / (1.0 + 2.0 * thick)          # km/s
    adiabat = 1.8 * (1.0 + 0.5 * torch.abs(thick))
    mix = 0.08 * dop / 0.08 + 3.0 * (p2 ** 2 + p4 ** 2)
    shape_deg = torch.exp(-60.0 * (p2 ** 2) - 90.0 * (p4 ** 2))
    tion = 4.2 * (vel / 340.0) ** 1.25 * (1.0 - 0.5 * mix)     # keV
    rhor = 0.9 * (1.0 + thick) * (scale ** 0.3) * shape_deg
    pressure = 280.0 * (vel / 340.0) ** 2.6 * shape_deg
    yield_ = 5.0e15 * (vel / 340.0) ** 5.8 * shape_deg ** 2 * \
        torch.exp(-8.0 * mix) * (1.0 + thick) ** 1.5
    bang = 8.2 * (1.0 + 1.5 * thick) / (scale ** 0.45)         # ns
    burnwidth = 0.16 * (1.0 + mix) / (scale ** 0.2)

    # "physics failure" region: over-driven thin shells break the solver
    failed = (scale > 1.13) & (thick < -0.085)

    # time series: burn rate + ion temperature trace, (n, N_T)
    t = _linspace(7.0, 10.0, N_T, u.device)
    bw, bt = burnwidth[:, None], bang[:, None]
    burn = yield_[:, None] / (bw * math.sqrt(2 * math.pi)) * \
        torch.exp(-0.5 * ((t - bt) / bw) ** 2)
    tion_t = tion[:, None] * torch.exp(-0.5 * ((t - bt) / (2.5 * bw)) ** 2)

    # images: 4 views of the stagnated hotspot with P2/P4 shape distortion,
    # broadcast to (n, view, IMG, IMG)
    g = _linspace(-1.0, 1.0, IMG, u.device)
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    r = torch.sqrt(xx ** 2 + yy ** 2) + 1e-6
    costh = yy / r
    views = torch.arange(N_VIEWS, device=u.device) * (math.pi / N_VIEWS)
    proj2 = p2[:, None] * torch.cos(2 * views)                  # (n, view)
    proj4 = p4[:, None] * torch.cos(4 * views)
    r0 = 0.45 * (1.0 + (proj2 * 0.5)[..., None, None] * (3 * costh ** 2 - 1)
                 + (proj4 * 0.125)[..., None, None]
                 * (35 * costh ** 4 - 30 * costh ** 2 + 3))
    width = (0.12 * (1 + mix))[:, None, None, None]
    emiss = torch.exp(-0.5 * ((r - r0) / width) ** 2)
    core = torch.exp(-0.5 * (r / (0.3 * r0)) ** 2) * \
        (tion / 4.2)[:, None, None, None]
    images = (emiss + core) * ((yield_ / 5.0e15) ** 0.25)[:, None, None, None]
    images = images + draws["noise"] * 0.01

    nan = torch.full_like(yield_, math.nan)
    return {
        "yield": torch.where(failed, nan, yield_),
        "tion": torch.where(failed, nan, tion),
        "velocity": vel,
        "rhor": rhor,
        "pressure": pressure,
        "adiabat": adiabat,
        "mix": mix,
        "bang_time": bang,
        "burn_width": burnwidth,
        "shape_deg": shape_deg,
        "failed": failed.to(torch.float32),
        "burn_rate": burn.to(torch.float32),
        "tion_trace": tion_t.to(torch.float32),
        "images": images.to(torch.float32),
        "inputs": u.to(torch.float32),
    }


jag_simulate.draws_fn = jag_draws
