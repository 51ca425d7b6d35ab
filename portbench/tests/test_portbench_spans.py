"""The join of the program's spans with the device trace (``lib/spans.py``)
and the eight readers over it: a training step and a decode step laid out
by hand (device events, nested spans on two threads, idle gaps inside and
outside the program), the readers' values against sums made by hand, and
None where there is nothing to join."""
import time
from types import SimpleNamespace

import pytest

from portbench.lib import manifest, runner, trace
from portbench.lib import spans as join_spans
from portbench.tests import tiny
from repro_torch import spans as program_spans

T0 = 1_792_334_460_123_456_789  # the first step's anchor, Unix ns
MAIN, AUTOGRAD = 1, 2
READERS = ["forward_ms.train", "recompute_ms.train", "backward_ms.train",
           "optimizer_ms.train", "layer_elementwise_ms.train",
           "idle_in_program_ms.train", "decode_attention_ms.decode",
           "idle_in_program_ms.decode"]


def test_the_base_is_kinetos():
    # the base a trace printed beside its Unix time
    assert join_spans.base_ns(1792334460 * 10**9) == 1790857026 * 10**9


def _span(name, phase, parent, thread, dev, host, anchor=False):
    """Times in µs from the anchor."""
    ns = [T0 + round(1e3 * t) for t in dev + host]
    return program_spans.Span(name, phase, parent, thread, ns[2], ns[3],
                              ns[0], ns[1], anchor)


def _events(rel):
    off = (T0 - join_spans.base_ns(T0)) / 1e3
    return [(name, off + t, d) for name, t, d in rel]


TRAIN_SPANS = [
    _span("train_step", "step", -1, MAIN, (0, 1000), (0, 1005), True),
    _span("forward", "forward", 0, MAIN, (10, 400), (5, 100)),
    _span("layer.mamba2", "forward", 1, MAIN, (20, 200), (10, 40)),
    _span("layer.shared_attn", "forward", 1, MAIN, (210, 390), (40, 80)),
    _span("backward", "backward", 0, MAIN, (400, 900), (100, 880)),
    _span("layer.shared_attn.backward", "backward", 4, AUTOGRAD, (410, 600),
          (120, 300)),
    _span("layer.shared_attn", "recompute", 5, AUTOGRAD, (420, 480),
          (130, 200)),
    _span("layer.mamba2.backward", "backward", 4, AUTOGRAD, (600, 890),
          (300, 500)),
    _span("optimizer", "optimizer", 0, MAIN, (900, 1000), (880, 1000)),
]
TRAIN_EVENTS = _events([
    ("feed_elementwise_kernel", -50, 40),      # the harness's feed
    ("elementwise_kernel_a", 30, 50),          # layer.mamba2 forward
    ("nvjet_tst_gemm", 90, 60),                # a product
    ("direct_copy_kernel_cuda", 220, 40),      # layer.shared_attn forward
    ("nvjet_tst_gemm", 300, 80),
    ("elementwise_kernel_b", 430, 40),         # the recompute
    ("flash_bwd_bf16_kernel", 490, 100),       # hand-written
    ("vectorized_elementwise_kernel", 610, 90),  # layer.mamba2.backward
    ("adam_elementwise_kernel", 910, 80),      # optimizer
    ("Memcpy DtoH (Device -> Pageable)", 1100, 10),  # the loss's read
])
DECODE_SPANS = [
    _span("decode_step", "decode", -1, MAIN, (0, 500), (0, 520), True),
    _span("layer.shared_attn", "decode", 0, MAIN, (10, 300), (5, 60)),
    _span("decode_attention", "decode", 1, MAIN, (20, 290), (10, 50)),
]
DECODE_EVENTS = _events([
    ("direct_copy_kernel_cuda", 30, 200),
    ("gemvx_kernel", 240, 30),
    ("argmax_kernel", 400, 50),
    ("Memcpy DtoH (Device -> Pageable)", 600, 5),
])


def _ctx(kind, events, steps=1):
    return SimpleNamespace(kind=kind, trace=trace.Trace(events, 1.0, steps),
                           steps=steps)


@pytest.fixture
def given(monkeypatch):
    """Make the program's records the given list."""
    def use(recs):
        monkeypatch.setattr(join_spans, "records", lambda: recs)
    return use


def _read(ctx):
    return {m: manifest.reader(m)(ctx) for m in READERS}


def test_a_training_step_by_hand(given):
    given(TRAIN_SPANS)
    ctx = _ctx("train", TRAIN_EVENTS)
    got = _read(ctx)
    want = {"forward_ms.train": 0.230,   # 50 + 60 + 40 + 80 µs
            "recompute_ms.train": 0.040,
            "backward_ms.train": 0.190,  # 40 + 100 + 90, less the recompute
            "optimizer_ms.train": 0.080,
            # other and copy_cast kernels under the innermost layer span:
            # mamba2 50 + 90, shared_attn 40 + 40
            "layer_elementwise_ms.train": 0.220,
            # the gaps' 570 µs less the 10 before the step and the 95
            # after its host span closed
            "idle_in_program_ms.train": 0.465,
            "decode_attention_ms.decode": None,
            "idle_in_program_ms.decode": None}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == (None if v is None else pytest.approx(v)), k
    j = join_spans.join(ctx)
    assert j.device_s[("train_step", "step")] == pytest.approx(540e-6)
    assert j.covered_s / j.busy_s == pytest.approx(540 / 590)
    assert j.layer_elementwise_s == pytest.approx(
        {"mamba2": 140e-6, "shared_attn": 80e-6})
    idle = {k: 1e6 * v for k, v in j.idle_s.items()}
    assert idle == pytest.approx({
        join_spans.OUTSIDE: 105, "train_step": 10, "forward": 15,
        "layer.mamba2": 20, "layer.shared_attn": 50,
        "layer.shared_attn.backward": 60, "layer.mamba2.backward": 70,
        "backward": 200, "optimizer": 40})
    # the anchor lies 10 µs after the feed's kernel, 30 before the step's
    ((before, after, prev, nxt),) = j.margins
    assert (before, after) == pytest.approx((10, 30))
    assert (prev, nxt) == ("feed_elementwise_kernel", "elementwise_kernel_a")
    out = j.readout()
    assert out["phases_over_step"] == pytest.approx((230 + 230 + 80) / 540)
    assert out["coverage_pct"] == pytest.approx(100 * 540 / 590, abs=1e-3)


def test_a_decode_step_by_hand(given):
    given(DECODE_SPANS)
    got = _read(_ctx("decode", DECODE_EVENTS))
    assert got["decode_attention_ms.decode"] == pytest.approx(0.230)
    # the gaps [0, 30) (from the anchor), [230, 240), [270, 400) and
    # [450, 520) under decode_step's host span; [520, 600) outside
    assert got["idle_in_program_ms.decode"] == pytest.approx(0.240)
    assert {k for k, v in got.items() if v is not None} == \
        {"decode_attention_ms.decode", "idle_in_program_ms.decode"}


def test_steps_outside_the_trace_are_left_out(given):
    """Records of an earlier step (kept until a step runs untraced) that
    no device event of this trace meets do not count."""
    earlier = [s._replace(
        host_open=s.host_open - 10**9, host_close=s.host_close - 10**9,
        dev_open=s.dev_open - 10**9, dev_close=s.dev_close - 10**9)
        for s in TRAIN_SPANS]
    n = len(earlier)
    given(earlier + [s._replace(parent=s.parent + n if s.parent >= 0 else -1)
                     for s in TRAIN_SPANS])
    assert manifest.reader("forward_ms.train")(
        _ctx("train", TRAIN_EVENTS)) == pytest.approx(0.230)


def test_nothing_to_join_reads_none(given):
    given(TRAIN_SPANS)
    assert set(_read(_ctx("train", [])).values()) == {None}  # no card
    given(None)  # a program without spans
    assert set(_read(_ctx("train", TRAIN_EVENTS)).values()) == {None}
    given([])  # no step traced
    assert set(_read(_ctx("train", TRAIN_EVENTS)).values()) == {None}


def test_the_harness_profiler_turns_the_spans_on(monkeypatch):
    """A traced run of a cell at a small size on the CPU: the harness's
    profiler turns the program's spans on (every step under a
    ``train_step``), and with no device events the readers read None."""
    rec = program_spans.Recorder()
    monkeypatch.setattr(program_spans, "RECORDER", rec)
    small = tiny.cell("zamba2-1.2b.train-4k")
    r = runner.run_cell(small.name, 7, 0.1, True, "cpu", time.monotonic(),
                        cell=small)
    assert not {m for m in READERS if m in r["metrics"]}
    steps = [s for s in rec.records if s.name == "train_step"]
    assert len(steps) == small.traffic["trace_steps"]
    assert {s.name for s in rec.records} >= {
        "forward", "backward", "optimizer", "layer.mamba2",
        "layer.shared_attn", "layer.mamba2.backward"}
