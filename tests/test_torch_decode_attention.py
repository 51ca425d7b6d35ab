"""The decode attention's dispatch, split plan, split-path merge and
argument checks, on the CPU.  The CUDA kernel itself is held to
``ref.decode_attention_ref`` on the card by tests/test_torch_cuda.py and
chip_smoke.py; here its wrapper's host side and the plain versions run.
"""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import flops, ops, ref
from repro_torch.models import lm

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, T, H, KV, D, dtype="float32", cache_dtype=None):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(2 * rng.standard_normal((B, 1, H, D),
                                                 dtype=np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((B, T, KV, D),
                                                   dtype=np.float32))
              for _ in range(2))
    cdt = TDT[cache_dtype or dtype]
    return q.to(TDT[dtype]), ck.to(cdt), cv.to(cdt)


CASES = [  # (B, T, H, KV, D, kv_len, window, softcap)
    (2, 64, 4, 2, 32, 64, None, None),
    (2, 64, 4, 2, 32, 40, None, None),
    (1, 90, 6, 2, 64, 90, 17, None),
    (3, 50, 4, 4, 32, 33, None, 20.0),
    (2, 128, 12, 1, 128, 100, 64, 30.0),
]


@pytest.mark.parametrize("B,T,H,KV,D,kv_len,window,softcap", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_on_the_cpu_is_the_plain_version(B, T, H, KV, D, kv_len,
                                                 window, softcap, dtype):
    q, ck, cv = _qkv(B + T, B, T, H, KV, D, dtype)
    kw = dict(kv_len=kv_len, window=window, softcap_val=softcap)
    want = ref.decode_attention_ref(q, ck, cv, **kw)
    before = dak.launches
    for mode in ("never", "auto"):
        got = ops.decode_attention(q, ck, cv, use_pallas=mode, **kw)
        assert got.dtype == q.dtype and torch.equal(got, want)
    assert torch.equal(dak.decode_attention(q, ck, cv, **kw), want)
    assert dak.launches == before


def test_dispatch_rejects_unknown_mode():
    q, ck, cv = _qkv(0, 1, 16, 2, 2, 32)
    with pytest.raises(ValueError, match="use_pallas"):
        ops.decode_attention(q, ck, cv, kv_len=16, use_pallas="interpret")


@pytest.mark.parametrize("B,KV,T,sms,want", [
    (128, 32, 4096, 132, 1),   # the benchmark's decode cell: 4,096 blocks
    (8, 33, 4096, 132, 1),     # exactly two waves
    (1, 32, 4096, 132, 8),     # one row: 264 // 32
    (1, 8, 4096, 132, 33),     # 264 // 8
    (1, 8, 1000, 132, 15),     # capped at 64 positions a split
    (4, 4, 552, 132, 8),       # the serve phase's short caches
    (4, 32, 552, 132, 2),      # a third run would start a second wave
    (1, 8, 63, 132, 1),        # too few positions to split
    (1, 32, 4096, 66, 4),      # half the SMs: 132 // 32
])
def test_split_count_is_a_function_of_the_shape(B, KV, T, sms, want):
    assert dak.num_splits(B, KV, T, sms) == want


@pytest.mark.parametrize("B,T,H,KV,D,kv_len,window,softcap", CASES)
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16])
def test_split_merge_equals_the_whole(B, T, H, KV, D, kv_len, window, softcap,
                                      splits):
    q, ck, cv = _qkv(3 * T + splits, B, T, H, KV, D)
    kw = dict(kv_len=kv_len, window=window, softcap_val=softcap)
    torch.testing.assert_close(
        ref.decode_attention_split_ref(q, ck, cv, splits=splits, **kw),
        ref.decode_attention_ref(q, ck, cv, **kw), atol=2e-6, rtol=1e-5)


def test_attended_positions():
    assert dak.attended(100, None) == (0, 100)
    assert dak.attended(100, 30) == (70, 100)
    assert dak.attended(10, 30) == (0, 10)


def test_wrapper_checks_what_the_kernel_takes():
    q = torch.zeros(2, 1, 8, 64)
    kv = torch.zeros(2, 16, 4, 64)
    dak.check_args(q, kv, kv, kv_len=16)  # accepted
    dak.check_args(q.bfloat16(), kv.bfloat16(), kv.bfloat16(), kv_len=3,
                   window=2, softcap_val=50.0)
    dak.check_args(q, kv.bfloat16(), kv.bfloat16(), kv_len=16)  # f32 q
    wide = torch.zeros(2, 16, 8, 64)  # a rank's KV heads, as a view
    dak.check_args(q, wide[:, :, 2:6], wide[:, :, 2:6], kv_len=16)
    meta = torch.zeros(2, 4096, 32, 128, dtype=torch.bfloat16, device="meta")
    dak.check_args(torch.zeros(2, 1, 32, 128, dtype=torch.bfloat16,
                               device="meta"), meta, meta, kv_len=4096)
    bad = [
        ((torch.zeros(2, 1, 8, 48), torch.zeros(2, 16, 4, 48),
          torch.zeros(2, 16, 4, 48)), {}, "head dim"),
        ((torch.zeros(2, 1, 8, 16), torch.zeros(2, 16, 4, 16),
          torch.zeros(2, 16, 4, 16)), {}, "head dim"),
        ((q.half(), kv.half(), kv.half()), {}, "dtypes"),
        ((q, kv.to(torch.int8), kv.to(torch.int8)), {}, "dtypes"),
        ((q, kv, kv.bfloat16()), {}, "dtypes"),
        ((q, torch.zeros(2, 16, 3, 64), torch.zeros(2, 16, 3, 64)), {},
         "multiple"),
        ((torch.zeros(2, 1, 6, 64), kv, kv), {}, "multiple"),
        ((q, kv, torch.zeros(2, 17, 4, 64)), {}, "shape mismatch"),
        ((torch.zeros(2, 2, 8, 64), kv, kv), {}, "one query token"),
        ((q, kv.transpose(1, 2).contiguous().transpose(1, 2),
          kv.transpose(1, 2).contiguous().transpose(1, 2)), {}, "contiguous"),
        ((q, torch.zeros(2, 16, 4, 128)[..., :64],
          torch.zeros(2, 16, 4, 128)[..., :64]), {}, "contiguous"),
        ((q, kv, wide[:, :, 2:6]), {}, "contiguous"),
        ((torch.zeros(2, 1, 8, 128)[..., :64], kv, kv), {},
         "q must be contiguous"),
        ((q, kv, kv), {"kv_len": 0}, "kv_len"),
        ((q, kv, kv), {"kv_len": 17}, "kv_len"),
        ((q, kv, kv), {"window": 0}, "window"),
        ((q, kv, kv), {"softcap_val": 0.0}, "softcap"),
    ]
    for args, kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            dak.check_args(*args, **{"kv_len": 16, **kw})
    with pytest.raises(ValueError, match="gradient"):
        dak.check_args(q.requires_grad_(), kv, kv, kv_len=16)


def test_wrapper_refuses_a_device_without_the_kernel():
    q = torch.zeros(1, 1, 2, 32, device="meta")
    kv = torch.zeros(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="device"):
        dak.decode_attention(q, kv, kv, kv_len=8)


def test_counted_flops_are_the_plain_versions():
    """A counter on the card sees ``flops.decode_flops`` for the kernel: what
    a dispatch counter counts of the plain version the dry run runs."""
    q, ck, cv = _qkv(5, 2, 96, 8, 2, 64)
    with FlopCounterMode(display=False) as m:
        ref.decode_attention_ref(q, ck, cv, kv_len=70, window=32)
    assert m.get_total_flops() == flops.decode_flops(q, ck)


@pytest.mark.parametrize("arch", ["jag-surrogate", "zamba2-1.2b"])
@torch.inference_mode()
def test_model_decode_takes_the_configs_dispatch(arch):
    """``_attn_decode_rolling`` hands ``cfg.use_pallas`` on: on the CPU both
    modes decode the same logits."""
    cfg = registry.reduced_config(arch).replace(compute_dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for mode in ("auto", "never"):
        c = cfg.replace(use_pallas=mode)
        _, caches = lm.prefill(params, toks, c, max_len=16)
        out[mode], _ = lm.decode_step(params, toks[:, -1:], caches, c)
    assert torch.equal(out["auto"], out["never"])
