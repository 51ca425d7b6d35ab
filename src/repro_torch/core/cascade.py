"""The cascading calibrate->forecast archetype (paper Sec. 3.3) — as ONE
declarative DAG.

Per metro area (a DAG *parameter*, Fig. 1): a pre-ensemble of epidemic
simulations over sampled parameter sets (*samples*) runs against observed
case data; a per-metro selection step scores the fits and keeps the best
draws (an ABC-style posterior); the posterior feeds per-(metro, scenario)
forecast ensembles whose results a packaging step reduces to quantile
bands.

What used to be "phase 2" — a nested ``runtime.run()`` launched from
inside the selection worker — is now an ordinary pair of graph edges:

    presim[METRO] ──→ select[METRO] ──→ forecast[METRO, SCENARIO]
                                              │
                                              └──→ package[METRO, SCENARIO]

``select`` publishes its posterior as a named sample set scoped to its
metro (``ctx.publish_samples("posterior", ...)``); the ``forecast`` nodes
declare ``sample_set="posterior"`` and expand over the extra SCENARIO
parameter, so the DAG compiler's edge matching fans one select instance
out to all of its metro's scenario forecasts.  Parameters (metro x
scenario) stay in the DAG; draws stay samples — the layering that made
this workflow "both intuitive and scalable".
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch import env
from repro_torch.core.bundler import Bundler
from repro_torch.core.ensemble import EnsembleExecutor
from repro_torch.core.runtime import MerlinRuntime
from repro_torch.core.spec import Step, StudySpec


class CalibrationCascade:
    def __init__(self, runtime: MerlinRuntime, simulator: Callable,
                 observed: Dict[str, np.ndarray], n_calib: int = 64,
                 n_posterior: int = 16, scenarios: Optional[Dict[str, Dict]] = None,
                 seed: int = 0, device=None):
        """observed: metro -> daily case curve to calibrate against.
        The ensembles run on ``device``: ``cuda`` unless ``cpu`` is asked
        for (the port's one addition, as in ``OptimizationLoop``)."""
        self.rt = runtime
        self.device = env.device(device)
        self.sim = simulator
        self.observed = observed
        self.n_calib = n_calib
        self.n_post = n_posterior
        self.scenarios = scenarios or {
            "baseline": {"compliance": 0.0},
            "moderate_npi": {"compliance": 0.45},
            "strong_npi": {"compliance": 0.75},
        }
        self.seed = seed
        self.results: Dict[str, Dict] = {}
        self.bundlers: Dict[str, Bundler] = {}
        runtime.register("epi_calibrate", self._calib_sim_step)
        runtime.register("epi_select", self._select_step)
        runtime.register("epi_forecast", self._forecast_sim_step)
        runtime.register("epi_package", self._package_step)

    def spec(self) -> StudySpec:
        """The whole cascade as one multi-stage DAG spec."""
        return StudySpec(
            name="covid-cascade",
            steps=[
                Step(name="presim", fn="epi_calibrate", params=("METRO",)),
                Step(name="select", fn="epi_select", depends=("presim",),
                     over_samples=False, params=("METRO",)),
                Step(name="forecast", fn="epi_forecast", depends=("select",),
                     params=("METRO", "SCENARIO"), sample_set="posterior"),
                Step(name="package", fn="epi_package", depends=("forecast",),
                     over_samples=False, params=("METRO", "SCENARIO")),
            ],
            parameters={"METRO": sorted(self.observed),
                        "SCENARIO": sorted(self.scenarios)})

    def start(self) -> str:
        rng = np.random.default_rng(self.seed)
        samples = rng.uniform(0, 1, (self.n_calib, 6)).astype(np.float32)
        return self.rt.run(self.spec(), samples)

    def _bundler(self, phase: str, metro: str) -> Bundler:
        key = f"{phase}/{metro}"
        if key not in self.bundlers:
            self.bundlers[key] = Bundler(
                os.path.join(self.rt.workspace, "epi", phase, metro))
        return self.bundlers[key]

    def _calib_sim_step(self, ctx) -> None:
        metro = ctx.combo["METRO"]
        # fresh executor objects are cheap: compiled simulators live in the
        # process-wide cache, so per-step construction reuses the programs
        ex = EnsembleExecutor(self.sim, self._bundler("calib", metro),
                              device=self.device)
        ex.run_bundle(ctx.lo, ctx.hi, ctx.sample_block,
                      sub_ranges=ctx.sub_ranges)

    def _select_step(self, ctx) -> None:
        """ABC selection; publishing the posterior IS the phase-2 launch —
        completion of this node unlocks the forecast edges, which iterate
        the published set."""
        metro = ctx.combo["METRO"]
        data = self._bundler("calib", metro).load_all()
        obs = self.observed[metro]
        err = np.mean((data["daily_cases"] - obs[None, :]) ** 2, axis=1)
        keep = np.argsort(err)[: self.n_post]
        posterior = data["inputs"][keep]
        self.results.setdefault(metro, {})["posterior_rmse"] = float(
            np.sqrt(err[keep].mean()))
        ctx.publish_samples("posterior", posterior.astype(np.float32))

    def _forecast_sim_step(self, ctx) -> None:
        metro = ctx.combo["METRO"]
        scen = ctx.combo["SCENARIO"]
        block = np.array(ctx.sample_block)
        comp = self.scenarios[scen]["compliance"]
        block[:, 4] = comp / 0.8  # overwrite compliance dim (rescaled [0,0.8])
        ex = EnsembleExecutor(self.sim, self._bundler(f"fc_{scen}", metro),
                              device=self.device)
        ex.run_bundle(ctx.lo, ctx.hi, block, sub_ranges=ctx.sub_ranges)

    def _package_step(self, ctx) -> None:
        metro = ctx.combo["METRO"]
        scen = ctx.combo["SCENARIO"]
        data = self._bundler(f"fc_{scen}", metro).load_all()
        daily = data["daily_cases"]
        qs = np.quantile(daily, [0.1, 0.5, 0.9], axis=0)
        out = {"metro": metro, "scenario": scen,
               "peak_median": float(np.median(data["peak_cases"])),
               "attack_median": float(np.median(data["attack_rate"]))}
        self.results.setdefault(metro, {})[scen] = out
        path = os.path.join(ctx.workspace, "forecast.json")
        with open(path, "w") as f:
            json.dump({**out, "q10": qs[0].tolist(), "q50": qs[1].tolist(),
                       "q90": qs[2].tolist()}, f)
