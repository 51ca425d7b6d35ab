"""The iterative surrogate-optimization archetype (paper Sec. 3.2; the port
of ``repro/core/active.py``).

Loop per iteration, exactly the HYDRA capsule-robustness workflow:
  simulate batch -> post-process -> collect features -> train ML surrogate
  -> constrained acquisition (maximize expected objective under constraints,
  with robustness samples around candidates) -> choose next batch
  (1/3 around best observed, 1/3 at predicted optimum, 1/3 on the line
  between them — the paper's 128/128/128 split) -> re-enqueue via a worker
  call back into ``merlin run`` (dynamic workflow).

The surrogate is a small MLP deep ensemble (cheap uncertainty); the
simulator is any batched f(u, draws)->dict (JAG here).

Hot-path layout:

* The ensemble's members are stacked on a leading axis (``w``: (M, din,
  dout), ``b``: (M, dout)) and applied with batched matrix products, one
  launch a layer for all members.
* ``train_surrogate`` is a loop of autograd steps with the reference's
  Adam written out by hand (no bias correction: 0.9/0.1, 0.999/0.001,
  eps 1e-8); on the card one step is captured as a CUDA graph and
  replayed.  Training rows are padded to a power-of-two
  bucket (core/ensemble.bucket_for) with a masked loss, sum(w·err²)/sum(w).
* Members start from ``torch.Generator(seed*131+m)`` on the CPU, moved to
  the device, so the CPU and the card start from the same ensemble.
* ``Surrogate.predict`` pads rows to a bucket like the reference.

Everything runs on ``cuda`` unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import env
from repro_torch.core.bundler import Bundler
from repro_torch.core import ensemble
from repro_torch.core.ensemble import EnsembleExecutor, bucket_for, pad_rows
from repro_torch.core.runtime import MerlinRuntime
from repro_torch.core.spec import Step, StudySpec

Stacked = List[Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# MLP surrogate (deep ensemble)
# ---------------------------------------------------------------------------

def _mlp_init(gen: torch.Generator, dims) -> List[Dict[str, torch.Tensor]]:
    """One member's layers on the CPU: He-normal weights, zero biases."""
    params = []
    for i in range(len(dims) - 1):
        w = torch.randn(dims[i], dims[i + 1], generator=gen) * \
            (2.0 / dims[i]) ** 0.5
        params.append({"w": w, "b": torch.zeros(dims[i + 1])})
    return params


def _mlp_apply(stacked: Stacked, X: torch.Tensor) -> torch.Tensor:
    """Every member on the same rows: X (n, d) -> (M, n)."""
    x = X.expand(stacked[0]["w"].shape[0], *X.shape)
    for i, layer in enumerate(stacked):
        x = torch.baddbmm(layer["b"][:, None, :], x, layer["w"])
        if i < len(stacked) - 1:
            x = F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    return x[..., 0]


@torch.no_grad()
def _ensemble_apply(stacked: Stacked, X: torch.Tensor):
    """Batched deep-ensemble forward: mean and population std over members."""
    preds = _mlp_apply(stacked, X)
    return preds.mean(0), preds.std(0, correction=0)


def _stack(members: List[List[Dict[str, torch.Tensor]]]) -> Stacked:
    return [{k: torch.stack([m[i][k] for m in members]) for k in ("w", "b")}
            for i in range(len(members[0]))]


@dataclasses.dataclass
class Surrogate:
    params_list: List

    @property
    def stacked(self) -> Stacked:
        """Members stacked on a leading axis (computed once, cached)."""
        s = getattr(self, "_stacked", None)
        if s is None:
            s = _stack(self.params_list)
            object.__setattr__(self, "_stacked", s)
        return s

    @classmethod
    def from_stacked(cls, stacked: Stacked, n_members: int) -> "Surrogate":
        members = [[{k: v[m] for k, v in layer.items()} for layer in stacked]
                   for m in range(n_members)]
        sur = cls(members)
        object.__setattr__(sur, "_stacked", stacked)
        return sur

    @property
    def device(self) -> torch.device:
        return self.stacked[0]["w"].device

    def predict(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """(mu, sd) over rows; rows padded to a bucket as in the
        reference."""
        X = np.array(X, np.float32)
        n = len(X)
        Xp = torch.from_numpy(np.ascontiguousarray(pad_rows(X, bucket_for(n))))
        mu, sd = _ensemble_apply(self.stacked, Xp.to(self.device))
        return mu[:n].cpu().numpy(), sd[:n].cpu().numpy()


def _fit_members(params0: Stacked, X: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor, steps: int, lr: float) -> Stacked:
    """Deep-ensemble Adam fit, every member in one batched step.

    ``w`` masks padded rows out of the loss (sum(w·err²)/sum(w) equals the
    unpadded mean exactly).  The members' losses are summed: each one's
    parameters get its own gradient.  The update is the reference's Adam
    without bias correction, in place.

    A step is ~100 small launches whose time does not grow with the rows
    (launch-bound on the card), so on the card one step is captured as a
    CUDA graph and replayed ``steps`` times; on the CPU it runs eagerly."""
    leaves = [t.detach().clone().requires_grad_(True)
              for layer in params0 for t in (layer["w"], layer["b"])]
    mom = [torch.zeros_like(t) for t in leaves]
    vel = [torch.zeros_like(t) for t in leaves]
    wsum = w.sum()

    def step():
        p = [{"w": leaves[i], "b": leaves[i + 1]}
             for i in range(0, len(leaves), 2)]
        err = _mlp_apply(p, X) - y
        loss = ((w * err ** 2).sum(-1) / wsum).sum()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p_, m_, v_, g_ in zip(leaves, mom, vel, grads):
                m_.mul_(0.9).add_(0.1 * g_)
                v_.mul_(0.999).add_(0.001 * g_ ** 2)
                p_.sub_(lr * m_ / (torch.sqrt(v_) + 1e-8))

    if X.device.type == "cuda" and steps > 0:
        state = leaves + mom + vel
        start = [t.detach().clone() for t in state]
        # the executor's lock serializes every capture in the process (a
        # gateway's refresh captures while a study's workers capture buckets)
        with ensemble._GRAPH_LOCK:
            side = torch.cuda.Stream(X.device)
            side.wait_stream(torch.cuda.current_stream(X.device))
            with torch.cuda.stream(side):
                step()  # warm-up: autograd and library state outside capture
            torch.cuda.current_stream(X.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                step()
        with torch.no_grad():  # the warm-up step moved the state: undo it
            for t, t0 in zip(state, start):
                t.copy_(t0)
        for _ in range(steps):
            graph.replay()
    else:
        for _ in range(steps):
            step()
    return [{"w": leaves[i].detach(), "b": leaves[i + 1].detach()}
            for i in range(0, len(leaves), 2)]


def init_members(n_members: int, dims, seed: int, device) -> Stacked:
    """Member m from ``torch.Generator`` seed ``seed*131+m`` on the CPU,
    stacked and moved to ``device``."""
    members = [_mlp_init(torch.Generator().manual_seed(seed * 131 + m), dims)
               for m in range(n_members)]
    return [{k: v.to(device) for k, v in layer.items()}
            for layer in _stack(members)]


def train_surrogate(X: np.ndarray, y: np.ndarray, n_members: int = 3,
                    hidden: int = 64, steps: int = 300, lr: float = 3e-3,
                    seed: int = 0, pad: bool = True,
                    device=None) -> Surrogate:
    """Fit a deep ensemble on (X, y) on ``device`` (``cuda`` unless ``cpu``
    is asked for)."""
    dev = env.device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    n = len(X)
    cap = bucket_for(n) if pad else n
    w = np.zeros(cap, np.float32)
    w[:n] = 1.0
    params0 = init_members(n_members, (X.shape[1], hidden, hidden, 1), seed,
                           dev)

    def put(a):
        return torch.from_numpy(np.array(pad_rows(a, cap), np.float32)).to(dev)
    params = _fit_members(params0, put(X), put(y), torch.from_numpy(w).to(dev),
                          steps, lr)
    return Surrogate.from_stacked(params, n_members)


# ---------------------------------------------------------------------------
# serving snapshot
# ---------------------------------------------------------------------------

class SurrogateSnapshot:
    """A resident, reloadable serving view of a study's surrogate ensemble.

    The gateway tier (``repro_torch.serve.gateway``) answers
    predict/calibrate/what-if requests against this object: it holds the
    trained :class:`Surrogate` in memory (stacked members on the device) and tracks the study's bundle archive through
    ``Bundler.load_since`` deltas — ``refresh()`` reads only bundles that
    appeared since the last call, appends their rows, and retrains,
    bumping ``version``.  Serving and refreshing are concurrent-safe: the
    retrain happens under the snapshot lock and the new model swaps in
    with a single attribute assignment, so in-flight ``predict`` calls
    finish on the old ensemble and the next batch picks up the new one
    (no request ever observes a half-trained model).

    ``min_new_rows`` batches refresh work: deltas accumulate until at
    least that many new rows arrived, then one retrain covers them all
    (retrains are the expensive part).
    """

    def __init__(self, root: str, objective_key: str = "yield",
                 input_key: str = "inputs", n_members: int = 3,
                 hidden: int = 64, steps: int = 300, lr: float = 3e-3,
                 seed: int = 0, min_new_rows: int = 1, device=None,
                 state: Optional[Dict] = None):
        """``state`` resumes a trained snapshot instead of training one:
        ``{"surrogate", "X", "y", "version", "cursor"}`` as
        ``convert.snapshot_from_jax`` builds it from the reference's."""
        self.device = env.device(device)
        self.bundler = Bundler(root)
        self.objective_key = objective_key
        self.input_key = input_key
        self.n_members, self.hidden = int(n_members), int(hidden)
        self.steps, self.lr, self.seed = int(steps), float(lr), int(seed)
        self.min_new_rows = max(1, int(min_new_rows))
        self._lock = threading.Lock()
        self._cursor = None
        self._X: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._pending_rows = 0
        self._sur: Optional[Surrogate] = None
        self.version = 0
        if state is not None:
            self._sur, self._X, self._y = (state["surrogate"], state["X"],
                                           state["y"])
            self.version, self._cursor = int(state["version"]), state["cursor"]
        else:
            self.refresh()
        if self._sur is None:
            raise ValueError(
                f"no training rows under {root!r}: bundles must carry "
                f"'{input_key}' and '{objective_key}' arrays")

    @property
    def rows(self) -> int:
        X = self._X
        return 0 if X is None else len(X)

    @property
    def dims(self) -> int:
        X = self._X
        return 0 if X is None else X.shape[1]

    def refresh(self) -> bool:
        """Pull new bundles since the last refresh and retrain if at least
        ``min_new_rows`` accumulated; returns True when the served model
        changed (``version`` bumped)."""
        with self._lock:
            data, self._cursor = self.bundler.load_since(self._cursor)
            X_new = data.get(self.input_key)
            y_new = data.get(self.objective_key)
            if X_new is not None and y_new is not None and len(X_new):
                X_new = np.asarray(X_new, np.float32)
                y_new = np.asarray(y_new, np.float32).reshape(len(X_new))
                if X_new.ndim == 1:
                    X_new = X_new[:, None]
                if self._X is None:
                    self._X, self._y = X_new, y_new
                else:
                    self._X = np.concatenate([self._X, X_new])
                    self._y = np.concatenate([self._y, y_new])
                self._pending_rows += len(X_new)
            if self._X is None or not len(self._X):
                return False
            if self._sur is not None and self._pending_rows < self.min_new_rows:
                return False
            self._sur = train_surrogate(
                self._X, self._y, n_members=self.n_members,
                hidden=self.hidden, steps=self.steps, lr=self.lr,
                seed=self.seed, device=self.device)
            self._pending_rows = 0
            self.version += 1
            return True

    def predict(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """(mu, sd) over rows — lock-free: the model reference is read
        once, so a concurrent refresh never tears a batch."""
        sur = self._sur
        if sur is None:
            raise RuntimeError("snapshot has no trained model yet")
        return sur.predict(X)


# ---------------------------------------------------------------------------
# acquisition
# ---------------------------------------------------------------------------

def robust_objective(sur: Surrogate, X: np.ndarray, n_perturb: int = 16,
                     radius: float = 0.02, seed: int = 0) -> np.ndarray:
    """Expected objective under manufacturing-tolerance perturbations
    (the paper's 'expected yield under random draws about a design')."""
    rng = np.random.default_rng(seed)
    Xp = X[:, None, :] + rng.normal(0, radius, (len(X), n_perturb, X.shape[1]))
    mu, _ = sur.predict(np.clip(Xp, 0, 1).reshape(-1, X.shape[1]))
    return mu.reshape(len(X), n_perturb).mean(1)


def propose_batch(sur_obj: Surrogate, sur_con: Optional[Surrogate],
                  X_seen: np.ndarray, y_seen: np.ndarray, n: int,
                  dims: int, con_max: float = np.inf, seed: int = 0
                  ) -> np.ndarray:
    """The paper's 3-way split: around best / at predicted opt / connecting."""
    rng = np.random.default_rng(seed)
    best = X_seen[int(np.argmax(y_seen))]
    # predicted constrained optimum via random search on the surrogate
    cand = rng.uniform(0, 1, (4096, dims)).astype(np.float32)
    obj = robust_objective(sur_obj, cand, seed=seed)
    if sur_con is not None:
        cmu, _ = sur_con.predict(cand)
        obj = np.where(cmu <= con_max, obj, -np.inf)
    pred_opt = cand[int(np.argmax(obj))]
    k = n // 3
    around_best = np.clip(best + rng.normal(0, 0.04, (k, dims)), 0, 1)
    around_opt = np.clip(pred_opt + rng.normal(0, 0.04, (k, dims)), 0, 1)
    t = rng.uniform(0, 1, (n - 2 * k, 1))
    line = np.clip(best * (1 - t) + pred_opt * t
                   + rng.normal(0, 0.02, (n - 2 * k, dims)), 0, 1)
    return np.concatenate([around_best, around_opt, line]).astype(np.float32)


# ---------------------------------------------------------------------------
# the full loop as a dynamic Merlin study
# ---------------------------------------------------------------------------

class OptimizationLoop:
    """Self-re-enqueueing optimization chain (Fig. 8)."""

    def __init__(self, runtime: MerlinRuntime, simulator: Callable,
                 objective_key: str = "yield", constraint_key: str = "velocity",
                 constraint_max: float = 360.0, dims: int = 5,
                 batch_per_iter: int = 48, max_iters: int = 3, seed: int = 0,
                 device=None):
        self.rt = runtime
        self.device = env.device(device)
        self.dims = dims
        self.batch = batch_per_iter
        self.max_iters = max_iters
        self.obj_key = objective_key
        self.con_key = constraint_key
        self.con_max = constraint_max
        self.seed = seed
        self.history: List[Dict] = []
        self.simulator = simulator
        self.root = os.path.join(runtime.workspace, "opt_results")
        # all-iteration view (load_all/crawl walk recursively); its per-file
        # cache makes each funnel's load incremental over the archive
        self.bundler = Bundler(self.root)
        # per-iteration executors live for the whole loop: bundler handles
        # are reused across every task of an iteration, and the bucket
        # programs are shared process-wide across iterations
        self._executors: Dict[int, EnsembleExecutor] = {}
        self._exec_lock = threading.Lock()
        runtime.register("opt_simulate", self._sim_step)
        runtime.register("opt_analyze", self._analyze_step)

    def _executor(self, iteration: int) -> EnsembleExecutor:
        with self._exec_lock:
            ex = self._executors.get(iteration)
            if ex is None:
                # one bundler sub-tree per iteration: sample ids restart at
                # 0 each iteration, so results must not collide across them
                b = Bundler(os.path.join(self.root, f"iter{iteration:03d}"))
                ex = EnsembleExecutor(self.simulator, b, device=self.device)
                self._executors[iteration] = ex
            return ex

    def _sim_step(self, ctx) -> None:
        it = int(ctx.variables["ITER"])
        self._executor(it).run_bundle(ctx.lo, ctx.hi, ctx.sample_block,
                                      sub_ranges=ctx.sub_ranges)

    def _spec(self, iteration: int) -> StudySpec:
        return StudySpec(
            name=f"opt-iter{iteration}",
            steps=[
                Step(name="simulate", fn="opt_simulate"),
                Step(name="analyze", fn="opt_analyze",
                     depends=("simulate_*",), over_samples=False),
            ],
            variables={"ITER": iteration})

    def start(self, rng: Optional[np.random.Generator] = None) -> str:
        rng = rng or np.random.default_rng(self.seed)
        X0 = rng.uniform(0, 1, (self.batch, self.dims)).astype(np.float32)
        return self.rt.run(self._spec(0), X0)

    def _analyze_step(self, ctx) -> None:
        """Funnel: train surrogates, log progress, launch the next iteration
        from inside a worker task (the dynamic re-enqueue of Sec. 3.2)."""
        it = int(ctx.variables["ITER"])
        data = self.bundler.load_all()
        ok = np.isfinite(data[self.obj_key])
        X = data["inputs"][ok]
        y = np.log10(np.maximum(data[self.obj_key][ok], 1e10))
        y = (y - y.min()) / max(y.max() - y.min(), 1e-9)
        c = data[self.con_key][ok]
        sur = train_surrogate(X, y, seed=self.seed + it, device=self.device)
        sur_c = train_surrogate(X, c / max(abs(c).max(), 1e-9),
                                seed=self.seed + 71 + it, device=self.device)
        self.history.append({
            "iter": it, "n": int(ok.sum()),
            "best": float(np.nanmax(data[self.obj_key]))})
        if it + 1 < self.max_iters:
            Xn = propose_batch(sur, sur_c, X, y, self.batch, self.dims,
                               con_max=self.con_max / max(abs(c).max(), 1e-9),
                               seed=self.seed + it)
            ctx.runtime.run(self._spec(it + 1), Xn)
