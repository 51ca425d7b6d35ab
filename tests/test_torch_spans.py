"""The port's span recorder (``repro_torch.spans``) on the CPU: off, a tiny
training step records nothing, registers no gradient hook, creates no
CUDA event and computes bit for bit what it computes under a profiler; on
(a CPU ``torch.profiler`` session), the span tree of one step; and the
spans' host clock against the profiler's own events.

CUDA is stood in for by a counting stub of ``torch.cuda.Event`` where a
test counts events, so that the on path's events are seen to be made
while the off path makes none.  On the CPU the autograd engine runs the
backward, its gradient hooks and remat's recompute on the calling thread
(on a card, on its device thread)."""
import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.configs import registry
from repro_torch.train import optimizer as popt
from repro_torch.train import trainstep

ROWS, SEQ, MB = 4, 16, 2


def tiny(arch, remat="full"):
    cfg = registry.reduced_config(arch).replace(
        n_repeat=1, microbatch=MB, compute_dtype="float32", remat=remat)
    return cfg.replace(n_layers=len(cfg.prologue) + len(cfg.superblock))


def one_step(cfg):
    """A fresh state from a fixed seed after one step, and its metrics."""
    opt = popt.make_optimizer("adamw", cfg=cfg)
    state = trainstep.init_state(torch.Generator().manual_seed(0), cfg, opt)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (ROWS, SEQ), generator=g)
             for k in ("tokens", "labels")}
    return trainstep.make_train_step(cfg, opt)(state, batch)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class StubEvent:
    made = 0

    def __init__(self, enable_timing=False):
        StubEvent.made += 1

    def record(self):
        pass

    def elapsed_time(self, other):
        return 0.0


@pytest.fixture
def recorder(monkeypatch):
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    return rec


@pytest.fixture
def counted(monkeypatch):
    """Counts of gradient hooks registered and CUDA events made, with the
    recorder believing it runs on a card."""
    hooks = []
    register = torch.Tensor.register_hook

    def counting(self, hook):
        hooks.append(hook)
        return register(self, hook)
    monkeypatch.setattr(torch.Tensor, "register_hook", counting)
    monkeypatch.setattr(StubEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", StubEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return hooks


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_off_records_nothing_and_changes_nothing(arch, recorder, counted):
    cfg = tiny(arch)
    off_state, off_met = one_step(cfg)
    assert recorder.records == [] and counted == [] and StubEvent.made == 0
    with cpu_profile():
        on_state, on_met = one_step(cfg)
    # the same step recorded: hooks and events were made, and the numbers
    # are the off step's bit for bit
    assert recorder.records and counted and StubEvent.made > 0
    assert StubEvent.made == 2 * len(recorder.records)
    for k in ("loss", "grad_norm"):
        assert torch.equal(off_met[k], on_met[k])
    off_p = dict(off_state.params.named_parameters())
    for k, p in on_state.params.named_parameters():
        assert torch.equal(p, off_p[k]), k
    for k in ("m", "v"):
        for name, t in on_state.opt[k].items():
            assert torch.equal(t, off_state.opt[k][name]), (k, name)


def _children(recs, parent):
    """The indices of ``parent``'s children, in the order they opened."""
    return [i for i, r in enumerate(recs) if r.parent == parent]


def _names(recs, parent):
    return [(recs[i].name, recs[i].phase) for i in _children(recs, parent)]


@pytest.mark.parametrize("remat", ["full", "none"])
def test_the_span_tree_of_a_train_step(remat, recorder):
    cfg = tiny("zamba2-1.2b", remat)
    kinds = [f"layer.{s.kind}" for s in cfg.plan]
    n_pro = len(cfg.prologue)
    with cpu_profile():
        one_step(cfg)
    recs = recorder.resolve()
    me = threading.get_ident()
    assert all(r.host_close >= r.host_open for r in recs)
    (top,) = _children(recs, -1)
    assert recs[top].name == "train_step" and recs[top].anchor
    assert [n for n, _ in _names(recs, top)] == \
        ["grad_accum"] + ["microbatch"] * MB + ["optimizer"]
    for mb in [i for i in _children(recs, top)
               if recs[i].name == "microbatch"]:
        assert [n for n, _ in _names(recs, mb)] == \
            ["forward", "backward", "grad_accum"]
        fwd, bwd = _children(recs, mb)[:2]
        assert _names(recs, fwd) == \
            [(k, "forward") for k in kinds] + [("head_loss", "forward")]
        # each layer's backward, last layer first, on the thread that runs
        # the backward; under remat full the layers after the prologue
        # recompute their forward inside it
        lb = _children(recs, bwd)
        assert [(recs[i].name, recs[i].phase) for i in lb] == \
            [(k + ".backward", "backward") for k in reversed(kinds)]
        assert all(recs[i].thread == me for i in lb)
        for i, k in zip(lb, reversed(range(len(kinds)))):
            again = remat == "full" and k >= n_pro
            assert _names(recs, i) == \
                ([(kinds[k], "recompute")] if again else [])
    recompute = [r for r in recs if r.phase == "recompute"]
    assert len(recompute) == (MB * (len(kinds) - n_pro)
                              if remat == "full" else 0)


def test_an_untraced_step_starts_the_next_session_anew(recorder):
    with cpu_profile():
        with spans.step("s", "step"):
            pass
    assert len(recorder.records) == 1  # kept after the session
    with spans.step("s", "step"), spans.span("inner"):
        pass
    assert len(recorder.records) == 1
    with cpu_profile():
        with spans.step("s", "step"):
            with spans.span("inner"):
                pass
    assert [r.name for r in recorder.records] == ["s", "inner"]


def test_the_spans_clock_is_the_profilers(recorder, tmp_path):
    """A ``record_function`` range beside a span lies at the span's host
    times once its ``ts`` (µs) is offset by the trace's base, which is the
    Unix time rounded down to a multiple of 7,889,238 s."""
    with cpu_profile() as prof:
        with record_function("clock"), spans.span("clock"):
            time.sleep(0.02)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    (r,) = recorder.resolve()
    base_s = r.host_open // 10**9 // 7_889_238 * 7_889_238
    if "baseTimeNanoseconds" in data:
        assert data["baseTimeNanoseconds"] == base_s * 10**9
    (ev,) = [e for e in data["traceEvents"] if e.get("name") == "clock"
             and e.get("ph") == "X"]
    t0 = base_s * 1e6 + float(ev["ts"])
    assert abs(t0 - r.host_open / 1e3) < 2e3
    assert abs(t0 + float(ev["dur"]) - r.host_close / 1e3) < 2e3
