"""The yardstick's arithmetic on fixed shapes: roofline bounds, model
FLOPs a token, the trace's reduction, and the readers built on them."""
from types import SimpleNamespace

import pytest

from portbench import layers
from portbench.lib import manifest, trace, work
from portbench.tests import tiny

mamba2, rwkv6, shared_attn = (layers.get(k) for k in ("mamba2", "rwkv6",
                                                       "shared_attn"))

PAIRS_4096 = 4096 * 4097 // 2


def test_bound_is_the_slower_of_bytes_and_products():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_valid_pairs():
    assert work.valid_pairs(4096, 4096, True, None, 0) == PAIRS_4096
    assert work.valid_pairs(8, 8, False, None, 0) == 64
    assert work.valid_pairs(10, 10, True, 4, 0) == 1 + 2 + 3 + 4 * 7


def test_flash_bounds_at_the_zamba2_training_shape():
    B, S, H, D = 16, 4096, 32, 128
    ops = 4 * B * H * D * PAIRS_4096 / 989e12
    nbytes = (4 * B * S * H * D * 2 + B * H * S * 4) / 3.35e12
    assert ops > nbytes
    assert shared_attn.flash_fwd_bound(B, S, H, H, D) == pytest.approx(ops)
    bwd = 10 * D * B * H * PAIRS_4096 / 989e12
    assert shared_attn.flash_bwd_bound(B, S, H, H, D) == pytest.approx(bwd)
    assert work.flash_flops(B, S, S, H, D, D, True) == 4 * B * H * D * PAIRS_4096


def test_scan_bounds_are_bytes_bound_at_the_training_shapes():
    B, S, H, P, N = 16, 4096, 64, 64, 64
    nbytes = (3 * B * S * H * P * 2 + 4 * B * S * N * 2
              + 2 * (B * S * H + H) * 4)
    assert mamba2.ssd_bwd_bound(B, S, H, P, N) == pytest.approx(nbytes / 3.35e12)
    fwd = ((2 * B * S * H * P + 2 * B * S * N) * 2 + (B * S * H + H) * 4)
    assert mamba2.ssd_fwd_bound(B, S, H, P, N) == pytest.approx(fwd / 3.35e12)
    B, H, D = 8, 40, 64
    wkv = 7 * B * S * H * D * 2 + 2 * (B * S * H * D + H * D) * 4
    assert rwkv6.wkv_bwd_bound(B, S, H, D) == pytest.approx(wkv / 3.35e12)
    assert work.scan_flops(B, S, H, D, D, backward=True) == 12.0 * B * S * H * D * D


def test_model_flops_a_token_by_hand():
    m = {"family": "rwkv6", "d_model": 8, "vocab_size": 256, "head_dim": 4,
         "d_ff": 16, "lora_decay": 2, "superblock": ["rwkv6"], "n_repeat": 3}
    products = 8 * 256 + 3 * (6 * 64 + 2 * 8 * 2 + 2 * 8 * 16)
    scans = 3 * (4 + 12) * 2 * 4 * 4  # 2 heads of 4 x 4 states
    assert work.train_flops_per_token(m, 64) == 6 * products + scans
    assert work.decode_flops_per_token(m, 99) == 2 * products + 3 * 4 * 2 * 4 * 4


def test_zamba2_model_flops_a_token():
    m = manifest.cell("zamba2-1.2b.train-4k").config["model"]
    mamba = 2048 * (2 * 4096 + 2 * 64 + 64) + 4096 * 2048 + 4 * (4096 + 128)
    shared = 2 * 2048 * 3 * 4096 + 4096 * 2048 + 3 * 2048 * 8192
    products = 2048 * 32000 + 33 * mamba + 5 * shared
    attn = 5 * 2 * 32 * PAIRS_4096 * (2 * 128 + 5 * 128) / 4096
    scans = 33 * 16 * 64 * 64 * 64
    assert work.train_flops_per_token(m, 4096) == pytest.approx(
        6 * products + attn + scans)


def test_every_kind_in_a_plan_has_its_module_and_kernels_differ():
    entries = set()
    for w in tiny.with_staged()["workloads"]:
        m = tiny.full(w["name"]).config["model"]
        entries |= set(m.get("prologue", [])) | set(m["superblock"])
    for entry in entries:
        for mod in layers.parts(entry):
            assert callable(mod.forward) and callable(mod.products)
    ks = layers.kernels()
    assert sorted(k.name for k in ks) == ["flash_attention", "ssd_scan",
                                          "wkv6_scan"]
    own = [f for k in ks for f in k.own]
    assert len(own) == len(set(own))  # a fragment is one kernel's own
    # kinds that share a kernel declare it each at its own shape and bound
    assert sorted(layers.kernel_kinds("flash_attention")) == ["mla",
                                                              "shared_attn"]


def _trace(events, window_s=1.0, steps=1):
    return trace.Trace([(n, ts, d) for n, ts, d in events], window_s, steps)


def test_busy_is_the_union_of_device_intervals():
    tr = _trace([("a", 0, 100), ("b", 50, 100), ("c", 400, 100)], 1e-3)
    assert tr.busy_s == pytest.approx(250e-6)
    assert tr.seconds(lambda n: True) == pytest.approx(300e-6)
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps == [["after b", pytest.approx(250e-6)]]


def test_kernel_groups_and_families():
    tr = _trace([("void flash_fwd_bf16_kernel<128>", 0, 10),
                 ("void flash_bwd_bf16_kernel<128>", 10, 20),
                 ("void ssd_tc_kernel<64, 64>", 30, 30),
                 ("void ssd_chunk_kernel<64, 64>", 60, 40),
                 ("void scan_chunks_kernel<64>", 100, 5),
                 ("void at::native::unrolled_elementwise_kernel<copy_>", 105, 7),
                 ("sm90_xmma_gemm_bf16bf16", 112, 50)])
    assert tr.kernel_seconds("ssd_scan") == pytest.approx(75e-6)
    assert tr.kernel_seconds("flash_attention") == pytest.approx(30e-6)
    assert tr.kernel_seconds("wkv6_scan") == 0
    assert tr.group_seconds("hand_written") == pytest.approx(105e-6)
    assert tr.group_seconds("copy_cast") == pytest.approx(7e-6)
    assert tr.group_seconds("gemm") == pytest.approx(50e-6)
    nocast = _trace([
        ("elementwise_kernel<gpu_kernel_impl_nocast<BinaryFunctor<float>>>",
         0, 10),
        ("elementwise_kernel<gpu_kernel_impl_nocast<direct_copy_kernel_cuda>>",
         10, 20),
        ("vectorized_elementwise_kernel<bfloat16_copy_kernel_cuda>", 30, 5),
        ("unrolled_elementwise_kernel<CUDAFunctor_add<float>, "
         "memory::LoadWithoutCast, memory::StoreWithoutCast>", 40, 3)])
    assert nocast.group_seconds("copy_cast") == pytest.approx(25e-6)
    assert nocast.group_seconds("other") == pytest.approx(13e-6)
    both = _trace(tr.events + [("void wkv_sum_kernel<64>", 200, 10)])
    assert both.kernel_seconds("ssd_scan") == pytest.approx(70e-6)
    assert both.kernel_seconds("wkv6_scan") == pytest.approx(10e-6)


def _ctx(kind, events, **kw):
    base = dict(kind=kind, trace=_trace(events, 2.0, 2), counters={},
                shapes={}, model={}, traffic={}, tokens_per_s=0.0, steps=2,
                flops_per_token=0.0)
    base.update(kw)
    return SimpleNamespace(**base)


def test_roofline_readers():
    shape = dict(B=16, S=4096, H=64, P=64, N=64)
    f, b = mamba2.ssd_fwd_bound(**shape), mamba2.ssd_bwd_bound(**shape)
    spent_us = 1e6 * (63 * f + 33 * b) * 4  # a quarter of the roofline
    ctx = _ctx("train", [("void ssd_tc_kernel<64, 64>", 0, spent_us)],
               counters={"ssd_scan": 63, "ssd_scan_bwd": 33},
               shapes={"ssd_scan": {"mamba2": shape}})
    assert manifest.reader("ssd_scan_roofline.train")(ctx) == pytest.approx(25.0)
    assert manifest.reader("wkv6_scan_roofline.train")(ctx) is None
    assert manifest.reader("flash_attention_roofline.train")(ctx) is None


def test_mfu_idle_and_copy_readers():
    ev = [("void direct_copy_kernel_cuda", 0, 0.5e6), ("sm90_gemm", 1e6, 0.5e6)]
    ctx = _ctx("train", ev, tokens_per_s=1000.0, flops_per_token=9.89e9)
    assert manifest.reader("train_mfu")(ctx) == pytest.approx(1.0)
    assert manifest.reader("decode_mfu")(ctx) is None
    assert manifest.reader("device_idle_share.train")(ctx) == pytest.approx(50.0)
    assert manifest.reader("copy_cast_ms.train")(ctx) == pytest.approx(250.0)
    empty = _ctx("train", [], tokens_per_s=1000.0, flops_per_token=9.89e9)
    assert manifest.reader("train_mfu")(empty) is None
    assert manifest.reader("device_idle_share.train")(empty) is None
