#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. environment: versions, the card's name and power limit;
  2. build: every CUDA source under src/repro_torch/kernels/csrc with nvcc
     for sm_90a, into build/ (flash_attention, flash_attention_bwd,
     wkv6_scan, ssd_scan), where the D-192 flash forward instances must
     report 0 spill bytes; then the tensor-core instructions of each kernel
     function (cuobjdump -sass), which every bf16 instance of the flash
     forward (D 16-192), the flash backward's tensor-core grid, WKV6 and
     SSD must have, 24 in all (the fp32 kernels and the backward's D_i
     pass report 0);
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and the edge cases, with the tolerance stated, and
     device times of kernel, plain version and PyTorch's own call (where
     one call computes the same function) beside the card's bound; the
     flash forward also at phi4's GQA 24:8, gemma2's 6144-token local and
     global layers (softcap 50: no library call), deepseek's D-192 MLA
     prefill, whisper-tiny's non-causal encoder (1500 x 1500, H 6) and
     cross-attention over 1500 frames at S 400 and S 1 (decode),
     llama-3.2-vision-11b's GQA 32:8 self- and cross-attention over 1600
     image tokens (S 512 and S 1) and starcoder2-15b's GQA 48:4 prefill.
     The flash backward (dq, dk, dv) is held to
     ref.flash_attention_bwd_ref on the forward kernel's output and
     log-sum-exp at BWD_SHAPES (jag's
     training shapes, zamba2's 512 shape, GQA, window + softcap, D 16 and
     128, ragged S, cross S != T, two fp32 shapes), in bf16 also to the
     mirror of its rounding points ref.flash_attention_bwd_tc_ref; the
     autograd Function must give the same gradients, and its library time
     is scaled_dot_product_attention's backward;
  4. serve: jag-surrogate, rwkv6-3b, zamba2-1.2b, phi4-mini-3.8b,
     deepseek-v2-lite-16b, whisper-tiny, llama-3.2-vision-11b and
     starcoder2-15b at full width and full depth, gemma2-27b at full
     width and 8 of its 46 layers, through ServeEngine (random weights from
     seed 0; batch 4, prompts of 32, 200 and 512 tokens, 32 new tokens
     each; gemma2: batch 1, one prompt of 6144 tokens, past its 4096
     window; whisper: prompts of 32, 200 and 400, inside its 448-token
     context).  whisper and llama-vision get random bf16 frame / patch
     embeddings from seed 1 in every call, and llama-vision's xgates are
     set to 1.0, so its cross-attention reaches the logits.  Every launch
     count is set to 0 just before each model's run and read just after;
     the counts must be exact, prefill and decode (jag 12 flash; rwkv6-3b
     96 WKV; zamba2 99 SSD and 15 flash; phi4 96, gemma2 8 and deepseek 81
     flash, and 81 more for deepseek's run with int8 latent caches;
     whisper 3 x (12 + 31 x 4) = 408 and llama-vision 3 x (40 + 31 x 8) =
     864, its cross-attention running at every decode step; starcoder2
     120), and the first-token and first decode-step logits are held
     against a run of the plain versions from the plain run's own caches
     (MoE layers at the kernel run's routes).  A float32-compute
     prefill must launch one prefill's count.  One prefill and 8 decode
     steps of the longest prompt are then profiled: device time by kernel
     group, the flash kernel's share of it, and the idle share.  deepseek
     also holds its int8 caches' first decode step to the plain run's, and
     ``moe_impl="sort"`` to ``gshard``: first-token logits, and greedy
     tokens in float32;
  5. merlin: the Merlin loop as ``python -m repro_torch.launch.quickstart``
     runs it: 512 JAG samples through MerlinRuntime and a WorkerPool of 4
     workers, one CUDA graph a bucket in the EnsembleExecutor, into a
     Bundler; a 3-member surrogate (400 steps) on half the rows must reach
     R^2 >= 0.9 on the other half, every sample must be bundled and the
     captures stay within len(bucket_schedule(64)).  The same study on the
     CPU in this process must give the same bundles (row-rel 1e-4, NaNs and
     ``failed`` equal), and a surrogate trained on the CPU from the same
     init the same predictions (1e-3).  Then run_bundle throughput for JAG
     and SEIR at 1,024, 16,384 and 131,072 samples (device ms of one graph
     replay, host wall of the blocking call) and the surrogate's training
     time at 4,096 rows x 3 members x 400 steps.  This path runs none of
     the CUDA kernels above; their counts are read around it all the same.
  6. merlin_net: the quickstart study (512 JAG samples from seed 0, 4
     workers, bundles of 64) three times: over mem://, over one
     ``broker-serve`` subprocess on tcp://127.0.0.1 and over two shard
     subprocesses (``quickstart --two-process`` / ``--sharded``).  Each run
     bundles 512 of 512 with R^2 >= 0.9, and the three runs' bundles agree
     at row-rel 1e-6 (NaNs and ``failed`` equal).  The subprocesses are
     stopped at the end of each run, whatever its result;
  7. gateway: a SurrogateSnapshot on the card over that study's rows
     (merlin-serve's defaults: 3 members, hidden 64, 300 steps) behind a
     SurrogateGateway with its ContinuousBatcher (max_batch_rows 256,
     max_inflight 64).  16 client threads send 64 /v1/predict requests of
     1-32 points each over localhost HTTP, plus one /v1/calibrate and one
     /v1/what-if; halfway through, a new bundle is written and /v1/refresh
     retrains and captures while the predicts keep coming.  No response
     may be a 5xx, the version advances by one, and afterwards the
     predictions agree within 1e-3 with a CPU snapshot over the same rows;
  8. cascade: ``launch/covid_calibration`` as the example shapes it (3
     metros, 128 draws, a posterior of 24, 3 scenarios, bundles of 32, 3
     workers) on the card, then on the CPU with the same observations:
     calibration bundles at row-rel 3.4e-4, each metro's posterior RMSE
     within rel 1e-3, and on the card strong NPIs lower the median peak;
  9. icf: ``launch/icf_ensemble`` at 10,000 samples with 30 % worker deaths
     and crawl-and-resubmit passes: 10,000 of 10,000 on disk at the end
     and loaded one row a sample (a sample written twice must agree);
 10. optimization_loop: ``launch/optimization_loop`` (96 a batch, 4
     iterations, 3 workers): ``best`` does not go down from the first
     iteration to the last.
Phases 6-10 launch none of the kernels: their counts are set to 0
before each phase and must read 0 after it.
 11. train: ``python -m repro_torch.launch.train`` (jag-surrogate at full
     width and depth, AdamW, remat full) in this process: 200 steps over the
     quickstart study's bundles (phase 6's archive), where the mean loss of
     the last 10 steps must be below the first 10's; 20 more steps resumed
     from its last checkpoint (the rerun must start at step 201); 50
     synthetic steps at batch 8 x seq 128; 20 float32-compute steps whose
     losses must agree with the CPU port's run from the same seed and
     batches within rel 1e-3.  Each run's counts are set to 0 before it and
     must be exact: 2 flash forwards (one a recompute) and 1 backward a
     layer and step, no WKV6 or SSD launch.  Step ms, tokens/s, peak memory,
     and a torch.profiler reading of the device's busy time and idle share
     a step.
 12. train_encdec: whisper-tiny at full width and depth through
     ``python -m repro_torch.launch.train --arch whisper-tiny`` (bf16 frame
     embeddings in every batch, 8 microbatches a step): 30 steps on the
     quickstart's bundles, where the loss must fall, and 10 synthetic
     steps at batch 8 x seq 128 (uniform tokens, nothing to learn); 10
     float32-compute steps (batch 1) against the CPU port's at rel 1e-3.
     llama-3.2-vision-11b at full width and 5 of its 40 layers (one
     xattn, four attn; xgates 1.0) trains 10 steps at batch 8 x seq 128
     right after the serve phases (its ~60 GB peak does not fit beside the
     CUDA graph pools that the Merlin phases keep).  Counts exact from the
     config (a microbatch: each encoder layer 1 forward and 1 backward;
     each decoder attention 2 forwards, one a recompute, and 1 backward;
     no WKV6 or SSD); step ms, tokens/s, peak memory, and a torch.profiler
     reading of busy time and idle share a step;
 13. mesh: a one-rank NCCL group and a (1, 1) ("data", "model")
     DeviceMesh.  The train phase's jag-surrogate checkpoint restored
     through restore(..., shardings=param_spec_tree(...)), optimizer
     state included, and two steps under the mesh: each loss equals the
     unsharded step's within rel 1e-5, the first step's flash launches
     exact, on the DTensors' local shards, the second step timed warm;
     int8_psum on one rank equals quantize-dequantize; an EnsembleExecutor
     over the device tuple (cuda:0, cuda:0) gives the single-device
     bundles bit for bit for an exact simulator and JAG's within rel 1e-3,
     with mesh launches; device_mesh() is None on one card.  The group is
     destroyed at the end, whatever the result.
The last line is {"ok": true, "device": {...}}.  Without a card, or without
the rest of the repository beside it, the script exits non-zero before it.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import env  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import ssd_scan as ssdk  # noqa: E402
from repro_torch.kernels import wkv6_scan as wkvk  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.serve.engine import ServeEngine, extra_shapes  # noqa: E402
from repro_torch.core import active  # noqa: E402
from repro_torch.data.pipeline import regression_dataset  # noqa: E402
from repro_torch.core import ensemble as ens  # noqa: E402
from repro_torch.core.bundler import Bundler  # noqa: E402
from repro_torch.launch import covid_calibration  # noqa: E402
from repro_torch.launch import icf_ensemble  # noqa: E402
from repro_torch.launch import optimization_loop  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.serve.gateway import SurrogateGateway  # noqa: E402
from repro_torch.sim import jag_simulate, seir_simulate  # noqa: E402
from repro_torch.sim import rng as sim_rng  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
TOL = {torch.float32: (2e-5, 1e-3), torch.bfloat16: (2e-2, 1e-2)}
BF16, F32 = torch.bfloat16, torch.float32

# (name, B, S, T, H, KV, D, dtype, causal, window, softcap, q_pos0)
SHAPES = [
    ("jag_prefill_512", 4, 512, 512, 4, 4, 64, BF16, True, None, None, 0),
    ("jag_prefill_200", 4, 200, 200, 4, 4, 64, BF16, True, None, None, 0),
    ("jag_prefill_32", 4, 32, 32, 4, 4, 64, BF16, True, None, None, 0),
    ("ragged", 2, 200, 200, 4, 4, 64, BF16, True, None, None, 0),
    ("granite_gqa", 1, 1024, 1024, 32, 8, 128, BF16, True, None, None, 0),
    ("cross", 1, 33, 70, 4, 1, 64, F32, False, None, None, 0),
    ("window64_softcap30", 2, 300, 300, 4, 2, 32, F32, True, 64, 30.0, 0),
    ("q_pos0_16", 1, 48, 64, 4, 4, 64, F32, True, None, None, 16),
    # zamba2-1.2b's shared attention: 32 heads of 64 over concat(x, x0)
    ("zamba2_prefill_512", 4, 512, 512, 32, 32, 64, BF16, True, None, None, 0),
    ("zamba2_prefill_200", 4, 200, 200, 32, 32, 64, BF16, True, None, None, 0),
    ("zamba2_prefill_32", 4, 32, 32, 32, 32, 64, BF16, True, None, None, 0),
    # bf16 on the tensor cores: every feature and ragged edge of the tiling
    ("bf16_window64_softcap30_D32", 2, 300, 300, 4, 2, 32, BF16, True, 64,
     30.0, 0),
    ("bf16_D16", 1, 130, 130, 2, 1, 16, BF16, True, None, None, 0),
    ("bf16_D128_gqa_ragged", 2, 200, 200, 8, 2, 128, BF16, True, None, None,
     0),
    ("bf16_cross", 1, 33, 70, 4, 1, 64, BF16, False, None, None, 0),
    ("bf16_S1_q_pos0_100", 2, 1, 101, 4, 4, 64, BF16, True, None, None, 100),
    ("bf16_ragged_S45_T83", 1, 45, 83, 4, 2, 64, BF16, False, None, None, 0),
    # phi4-mini-3.8b: GQA 24:8 at D 128
    ("phi4_prefill_512", 4, 512, 512, 24, 8, 128, BF16, True, None, None, 0),
    # gemma2-27b at a prompt past its window: local (window 4096) and global
    # layers, attention softcap 50 on both
    ("gemma2_local", 1, 6144, 6144, 32, 16, 128, BF16, True, 4096, 50.0, 0),
    ("gemma2_global", 1, 6144, 6144, 32, 16, 128, BF16, True, None, 50.0, 0),
    # deepseek-v2-lite's MLA prefill: q/k at qk_nope 128 + qk_rope 64, v
    # zero-padded to 192
    ("deepseek_mla_prefill_512", 4, 512, 512, 16, 16, 192, BF16, True, None,
     None, 0),
    ("f32_D192_ragged", 2, 77, 130, 4, 2, 192, F32, False, None, None, 0),
    ("bf16_D192_window64_softcap30", 2, 300, 300, 4, 2, 192, BF16, True, 64,
     30.0, 0),
    ("bf16_D192_S1_q_pos0_100", 2, 1, 101, 4, 4, 192, BF16, True, None, None,
     100),
    # whisper-tiny: the non-causal encoder over 1500 frames, the decoder's
    # self-attention, and cross-attention to the encoder's 1500 states at
    # the longest prompt and at every decode step (S = 1)
    ("whisper_encoder_1500", 4, 1500, 1500, 6, 6, 64, BF16, False, None, None,
     0),
    ("whisper_self_400", 4, 400, 400, 6, 6, 64, BF16, True, None, None, 0),
    ("whisper_cross_400", 4, 400, 1500, 6, 6, 64, BF16, False, None, None, 0),
    ("whisper_cross_decode", 4, 1, 1500, 6, 6, 64, BF16, False, None, None, 0),
    # llama-3.2-vision-11b: self-attention GQA 32:8, and its gated
    # cross-attention layers over 1600 image tokens at prefill and decode
    ("llama_vision_self_512", 4, 512, 512, 32, 8, 128, BF16, True, None, None,
     0),
    ("llama_vision_cross_512", 4, 512, 1600, 32, 8, 128, BF16, False, None,
     None, 0),
    ("llama_vision_cross_decode", 4, 1, 1600, 32, 8, 128, BF16, False, None,
     None, 0),
    # starcoder2-15b: GQA 48:4
    ("starcoder2_prefill_512", 4, 512, 512, 48, 4, 128, BF16, True, None, None,
     0),
]
MAIN_PATH = ("jag_prefill_512", "jag_prefill_200", "jag_prefill_32",
             "zamba2_prefill_512", "zamba2_prefill_200", "zamba2_prefill_32",
             "phi4_prefill_512", "gemma2_local", "gemma2_global",
             "deepseek_mla_prefill_512", "whisper_encoder_1500",
             "whisper_self_400", "whisper_cross_400", "whisper_cross_decode",
             "llama_vision_self_512", "llama_vision_cross_512",
             "llama_vision_cross_decode", "starcoder2_prefill_512")
# kernel -> (module, its launch counter); flash_attention_bwd is built from
# csrc/flash_attention_bwd.cu and counted by the flash wrapper
KERNELS = {"flash_attention": (fak, "launches"),
           "flash_attention_bwd": (fak, "bwd_launches"),
           "wkv6_scan": (wkvk, "launches"), "ssd_scan": (ssdk, "launches")}
# the serve lines' names of the counts
COUNT_KEYS = {"flash_attention": "flash_launches",
              "flash_attention_bwd": "flash_bwd_launches",
              "wkv6_scan": "wkv6_launches", "ssd_scan": "ssd_launches"}

# Scans: max |kernel - plain| / max |plain| below SCAN_REL.  float32 is
# tests/test_kernels.py's bar; a bf16 output is rounded to 8 mantissa bits
# and summed in another order than the plain version's.
SCAN_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (name, B, S, H, D, decay, dtype, chunk): rwkv6-3b's prefills (H=40, D=64,
# chunk min(64, S); 200 tokens are padded to 256), then the edge cases.
# decay "sigmoid": w = sigmoid(N(0,1) + 2); "strong": w = exp(-exp(N(1, 2))),
# which reaches the clip at 1e-12 as rwkv6-3b's decays can.
WKV_SHAPES = [
    ("rwkv6_prefill_512", 4, 512, 40, 64, "sigmoid", BF16, 64),
    ("rwkv6_prefill_200", 4, 256, 40, 64, "sigmoid", BF16, 64),
    ("rwkv6_prefill_32", 4, 32, 40, 64, "sigmoid", BF16, 32),
    ("f32_D64", 2, 256, 8, 64, "sigmoid", F32, 64),
    ("f32_D16", 2, 128, 4, 16, "sigmoid", F32, 64),
    ("f32_D32_ragged", 1, 100, 4, 32, "sigmoid", F32, 100),
    ("bf16_B1_ragged", 1, 77, 40, 64, "sigmoid", BF16, 77),
    ("strong_rwkv6_512", 4, 512, 40, 64, "strong", BF16, 64),
    ("strong_S1", 2, 1, 40, 64, "strong", BF16, 1),
    ("strong_S15", 2, 15, 40, 64, "strong", BF16, 15),
    ("strong_S17", 2, 17, 40, 64, "strong", BF16, 17),
    ("strong_B1_H40", 1, 77, 40, 64, "strong", BF16, 77),
]
WKV_MAIN = ("rwkv6_prefill_512", "rwkv6_prefill_200", "rwkv6_prefill_32")
# (name, B, S, H, P, N, decay, dtype, chunk): zamba2-1.2b's prefills (H=64,
# P=N=64, chunk min(256, S)), then the edge cases.  decay "normal": dt =
# softplus(N(0,1)) / 2, A = -exp(N(0,1)); "strong": dt = softplus(N(0,1)),
# A = -exp(N(1.5,1)), about e^-3 a step, held to the sequential oracle (the
# chunked form's long cumsums cancel in their differences).
SSD_SHAPES = [
    ("zamba2_prefill_512", 4, 512, 64, 64, 64, "normal", BF16, 256),
    ("zamba2_prefill_200", 4, 200, 64, 64, 64, "normal", BF16, 200),
    ("zamba2_prefill_32", 4, 32, 64, 64, 64, "normal", BF16, 32),
    ("f32_P64", 2, 256, 8, 64, 64, "normal", F32, 128),
    ("f32_P16_N16", 2, 128, 4, 16, 16, "normal", F32, 64),
    ("f32_P32_N128_ragged", 1, 100, 4, 32, 128, "normal", F32, 100),
    ("bf16_B1_ragged", 1, 77, 64, 64, 64, "normal", BF16, 77),
    # bf16 on the tensor cores: every P and N split and ragged edge
    ("bf16_P16_N16", 2, 128, 4, 16, 16, "normal", BF16, 64),
    ("bf16_P32_N128_ragged", 1, 100, 4, 32, 128, "normal", BF16, 100),
    ("bf16_S1", 2, 1, 64, 64, 64, "normal", BF16, 1),
    ("bf16_S65", 2, 65, 64, 64, 64, "normal", BF16, 65),
    ("strong_zamba2_512", 4, 512, 64, 64, 64, "strong", BF16, 256),
]
SSD_MAIN = ("zamba2_prefill_512", "zamba2_prefill_200", "zamba2_prefill_32")
# float32-compute serve run against its plain run: rounding only
FP32_SERVE_REL = 1e-3


def _serve(counts, batch=4, prompts=(32, 200, 512), new_tokens=32,
           n_repeat=None, decode_counts=None):
    """One model's serve run: ``counts(cfg)`` is the launches each prefill
    must make, per kernel, and ``decode_counts(cfg)`` those of each decode
    step (None: none); ``n_repeat`` cuts the depth (None: full)."""
    return {"counts": counts, "batch": batch, "prompts": prompts,
            "new_tokens": new_tokens, "n_repeat": n_repeat,
            "decode_counts": decode_counts or (lambda cfg: {})}


SERVE = {
    "jag-surrogate": _serve(lambda cfg: {"flash_attention": cfg.n_layers}),
    "rwkv6-3b": _serve(lambda cfg: {"wkv6_scan": _count(cfg, "rwkv6")}),
    "zamba2-1.2b": _serve(lambda cfg: {
        "ssd_scan": _count(cfg, "mamba2"),
        "flash_attention": _count(cfg, "shared_attn")}),
    "phi4-mini-3.8b": _serve(lambda cfg: {
        "flash_attention": _count(cfg, "attn")}),
    # full width; 46 layers are ~104 GB of float32 weights, so the depth is
    # cut to 4 superblocks (4 local + 4 global layers).  One prompt past the
    # 4096 window: the window mask, the local caches' roll at prefill and
    # decode past the window run on the card.
    "gemma2-27b": _serve(lambda cfg: {"flash_attention": _count(cfg, "attn")},
                         batch=1, prompts=(6144,), n_repeat=4),
    # full width and depth (~62 GB of float32 weights); MLA + MoE
    "deepseek-v2-lite-16b": _serve(lambda cfg: {
        "flash_attention": _count(cfg, "mla")}),
    # full width and depth; a prefill runs the 4 encoder layers over 1500
    # frames and each decoder layer's self- and cross-attention, a decode
    # step each decoder layer's cross-attention (S = 1 against 1500).  A
    # prompt plus 32 new tokens stays inside whisper's 448-token context.
    "whisper-tiny": _serve(
        lambda cfg: {"flash_attention": cfg.n_enc_layers
                     + 2 * _count(cfg, "dec")},
        prompts=(32, 200, 400),
        decode_counts=lambda cfg: {"flash_attention": _count(cfg, "dec")}),
    # full width and depth (~37 GB of float32 weights): 32 self-attention
    # and 8 gated cross-attention layers over 1600 image tokens, the latter
    # again at each decode step
    "llama-3.2-vision-11b": _serve(
        lambda cfg: {"flash_attention": cfg.n_layers},
        decode_counts=lambda cfg: {"flash_attention": _count(cfg, "xattn")}),
    # full width and depth (~64 GB of float32 weights)
    "starcoder2-15b": _serve(lambda cfg: {
        "flash_attention": _count(cfg, "attn")}),
}


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def device_ms(fn, rounds=7, reps=20):
    """Median over rounds of the mean device time of ``reps`` back-to-back
    calls.  A spin kernel holds the stream while the host queues the calls,
    so host overhead between them is hidden and the events time the device."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def valid_pairs(S, T, causal, window, q_pos0):
    """(query, key) pairs the mask keeps: the work these inputs need."""
    n = 0
    for s in range(S):
        qpos = q_pos0 + s
        hi = min(T, qpos + 1) if causal else T
        lo = max(0, qpos - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def _sdpa(qt, kt, vt, causal, scale):
    """scaled_dot_product_attention on (B,H,S,D) views; GQA when the KV
    heads are fewer."""
    return torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=scale,
        enable_gqa=qt.shape[1] != kt.shape[1])


def sdpa_backends(qt, kt, vt, causal, scale):
    """Device ms of scaled_dot_product_attention restricted to each backend
    (None where the backend refuses these inputs), to say which one its
    default dispatch matches."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name)

        def call():
            with sdpa_kernel([backend]):
                _sdpa(qt, kt, vt, causal, scale)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError:
            out[name] = None
            continue
        out[name] = device_ms(call)
    return out


def time_kernel(q, k, v, out, kw):
    """Device times of the kernel, its plain version and PyTorch's own
    attention call on the same inputs (by default and per backend), beside
    the card's bound.  No one PyTorch call applies a softcap or a window,
    so those shapes have no library time (None)."""
    B, S, H, D = q.shape
    T = k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    flops = 4 * B * H * D * valid_pairs(S, T, kw["causal"], kw["window"],
                                        kw["q_pos0"])
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    # a long prompt's plain version takes tens of ms a call
    rounds, reps = (3, 5) if S * T > 2 ** 24 else (7, 20)
    library = kw["softcap_val"] is None and kw["window"] is None
    scale = 1.0 / D ** 0.5
    t = {
        "ms": device_ms(lambda: fak.flash_attention(q, k, v, **kw),
                        rounds, reps),
        "plain_ms": device_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                              rounds, reps),
        "library_ms": device_ms(
            lambda: _sdpa(qt, kt, vt, kw["causal"], scale), rounds, reps)
        if library else None,
        "library_backend_ms": sdpa_backends(qt, kt, vt, kw["causal"], scale)
        if library else None,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops}
    t["kernel_over_bound"] = t["ms"] / t["bound_ms"]
    t["kernel_over_library"] = (t["ms"] / t["library_ms"] if library
                                else None)
    return t


def phase_env():
    snap = env.snapshot()
    say("env", **snap)
    if not snap["nvidia_smi"]:
        raise RuntimeError("nvidia-smi did not report the card")
    return snap


def phase_build():
    t0 = time.monotonic()
    libs = _build.build_all()
    secs = time.monotonic() - t0
    for name, log in _build.logs.items():
        for line in log.splitlines():  # per instance: entry, spills, registers
            if "spill" in line or ("ptxas info" in line and (
                    "registers" in line or "Compiling" in line)):
                print(f"[build] {name}: {line.strip()}", flush=True)
    # the D-192 flash forward instances (MLA's prefill) must not spill: ptxas
    # prints an entry's spills on the line after its name
    spills, entry = {}, None
    for line in _build.logs.get("flash_attention", "").splitlines():
        found = re.search(r"entry function '(\S*flash_fwd_\w+ILi192E\S*)'",
                          line)
        if found:
            entry = found.group(1)
        elif entry and "spill" in line:
            spills[entry] = [int(n) for n in re.findall(
                r"(\d+) bytes spill", line)]
            entry = None
    say("build", seconds=round(secs, 3), libraries=sorted(libs),
        built_now=sorted(_build.logs), d192_spill_bytes=spills)
    missing = sorted(set(KERNELS) - set(libs))
    if missing:
        raise RuntimeError(f"libraries missing after build: {missing}")
    if "flash_attention" in _build.logs and (
            len(spills) != 2 or any(any(v) for v in spills.values())):
        raise RuntimeError(f"the D-192 flash forward instances spill (or "
                           f"were not reported): {spills}")


def phase_sass():
    """Tensor-core instructions (HMMA, HGMMA) per kernel function of each
    built library, read from ``cuobjdump -sass``.  Every bf16 instance of
    the four kernels must have some: their products run on the tensor
    cores (5 flash forward and 4 flash backward head dims, 3 WKV head dims,
    3 x 4 SSD P and N)."""
    nvcc = env.nvcc_path()
    tool = shutil.which("cuobjdump") or (
        os.path.join(os.path.dirname(nvcc), "cuobjdump") if nvcc else None)
    if tool is None or not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found beside nvcc")
    counts = {}
    for name in KERNELS:
        text = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        fn = None
        for line in text.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                fn = found.group(1)
                counts[fn] = 0
            elif fn and re.search(r"\bH(G)?MMA\b", line):
                counts[fn] += 1
    say("sass", tensor_core_instructions=counts)
    bf16 = [fn for fn in counts if "flash_fwd_bf16" in fn
            or "flash_bwd_bf16" in fn
            or ("wkv6_kernel" in fn and "bfloat16" in fn)
            or "ssd_tc_kernel" in fn]
    if len(bf16) != 24 or not all(counts[fn] for fn in bf16):
        raise RuntimeError(f"bf16 flash forward / flash backward / WKV6 / "
                           f"SSD instances without tensor-core instructions "
                           f"(or not 24 of them): {counts}")


def phase_flash(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, timing = {}, {}
    for (name, B, S, T, H, KV, D, dt, causal, window, softcap,
         q_pos0) in SHAPES:
        q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, T, KV, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, T, KV, D, generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=window, softcap_val=softcap,
                  q_pos0=q_pos0)
        got = fak.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, **kw)
        diff = (got.float() - want.float()).abs()
        atol, rtol = TOL[dt]
        ok = bool(torch.isfinite(got.float()).all()
                  and (diff <= atol + rtol * want.float().abs()).all())
        err = float(diff.max())
        errs[name] = err
        say("kernel_vs_plain", kernel="flash_attention", shape=name,
            B=B, S=S, T=T, H=H, KV=KV, D=D, dtype=str(dt).split(".")[-1],
            causal=causal, window=window, softcap=softcap, q_pos0=q_pos0,
            max_abs_err=err, atol=atol, rtol=rtol, ok=ok)
        if not ok:
            raise RuntimeError(f"flash_attention disagrees with its plain "
                               f"version at {name}: max abs err {err}")
        if name in MAIN_PATH:
            t = timing[name] = time_kernel(q, k, v, got, kw)
            say("kernel_time", kernel="flash_attention", shape=name,
                measured_on=torch.cuda.get_device_name(0),
                nvidia_smi=env.nvidia_smi_line(), kernel_ms=t["ms"],
                **{key: val for key, val in t.items() if key != "ms"})
    return errs, timing


def _count(cfg, kind):
    return sum(spec.kind == kind for spec in cfg.plan)


def _bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _tiles(S, tile=64):
    """Row counts of the kernels' 64-row time tiles over S."""
    return [min(tile, S - t0) for t0 in range(0, S, tile)]


def wkv_work(r, k, v, w, u):
    """Bytes (r, k, v, y in r's dtype, w and u in float32, each once) and
    the products of the chunked algorithm at the kernel's 16-row chunks:
    att over the pairs s < t, the bonus, att.v, the inter-chunk term and the
    state update."""
    B, S, H, D = r.shape
    nbytes = 4 * r.numel() * r.element_size() + (w.numel() + u.numel()) * 4
    flops = 0
    for n in _tiles(S, 16):
        pairs = n * (n - 1) // 2
        flops += 3 * pairs * D + 3 * n * D + 2 * (pairs + n) * D \
            + 4 * n * D * D + D * D
    return _bound(nbytes, B * H * flops)


def ssd_work(x, dt, A, Bm, Cm):
    """Bytes (x, y, B, C in x's dtype, dt and A in float32, each once) and
    the products of the chunked algorithm at the kernel's 64-row tiles:
    C.B^T and W over the pairs s <= t, W.x, C.h^T and the state update."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nbytes = (2 * x.numel() + 2 * Bm.numel()) * x.element_size() \
        + (dt.numel() + A.numel()) * 4
    flops = 0
    for n in _tiles(S):
        pairs = n * (n + 1) // 2
        flops += 2 * pairs * N + 3 * pairs + 2 * pairs * P + 4 * n * N * P \
            + P * N
    return _bound(nbytes, B * H * flops)


def wkv_inputs(gen, dev, B, S, H, D, decay, dt):
    r, k, v = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
               for _ in range(3))
    n = torch.randn(B, S, H, D, generator=gen, device=dev)
    w = torch.exp(-torch.exp(1.0 + 2.0 * n)) if decay == "strong" \
        else torch.sigmoid(n + 2.0)
    u = torch.randn(H, D, generator=gen, device=dev) * 0.1
    return r, k, v, w, u


def ssd_inputs(gen, dev, B, S, H, P, N, decay, dt):
    strong = decay == "strong"
    x = torch.randn(B, S, H, P, generator=gen, device=dev).to(dt)
    dtv = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device=dev))
    dtv = dtv if strong else dtv * 0.5
    A = -torch.exp(torch.randn(H, generator=gen, device=dev)
                   + (1.5 if strong else 0.0))
    Bm = torch.randn(B, S, N, generator=gen, device=dev).to(dt)
    Cm = torch.randn(B, S, N, generator=gen, device=dev).to(dt)
    return x, dtv, A, Bm, Cm


def phase_scan(dev, name, mod, plain, shapes, main, make, work):
    """One scan kernel against its plain version at every shape, timed at
    the main path's shapes.  ``plain`` maps each shape's decay kind (the
    last of its dims) to the plain version it is held to."""
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, timing = {}, {}
    for shape, *dims, dt, chunk in shapes:
        args = make(gen, dev, *dims, dt)
        got = getattr(mod, name)(*args, chunk=chunk)
        torch.cuda.synchronize()
        want = plain[dims[-1]](*args, chunk=chunk)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        ok = bool(torch.isfinite(got.float()).all() and rel < SCAN_REL[dt])
        errs[shape] = err
        say("kernel_vs_plain", kernel=name, shape=shape, dims=dims,
            dtype=str(dt).split(".")[-1], chunk=chunk, max_abs_err=err,
            rel_err=rel, rel_tol=SCAN_REL[dt], ok=ok)
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version at "
                               f"{shape}: rel err {rel}")
        if shape in main:
            t = timing[shape] = {
                "ms": device_ms(lambda: getattr(mod, name)(*args, chunk=chunk)),
                "plain_ms": device_ms(
                    lambda: plain[dims[-1]](*args, chunk=chunk)),
                "library_ms": None,  # no one PyTorch call computes the scan
                **work(*args)}
            t["kernel_over_bound"] = t["ms"] / t["bound_ms"]
            say("kernel_time", kernel=name, shape=shape,
                measured_on=torch.cuda.get_device_name(0),
                nvidia_smi=env.nvidia_smi_line(), kernel_ms=t["ms"],
                **{key: val for key, val in t.items() if key != "ms"})
    return errs, timing


def _launches():
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _free():
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _routes(record=None, replay=None):
    """Record the MoE layers' expert choices of a run (appended to the list
    ``record``, one (G,T,k) tensor a layer call) or replay those of another
    run (``replay``), whose gates are then this run's own router
    probabilities at the replayed experts.  The top-k choice is
    discontinuous: two bf16 runs that differ by rounding pick other experts
    for near-tied tokens, and a deep model carries that far past any
    rounding bar.  At the same routes two runs differ by rounding alone.
    Models without MoE layers never reach the router."""
    orig = MOE._route
    pinned = iter(replay) if replay is not None else None

    def route(p, xf, cfg):
        ids, gates, aux = orig(p, xf, cfg)
        if pinned is not None:
            ids = next(pinned)
            probs = torch.softmax((xf @ p.w_router.to(xf.dtype)).float(), -1)
            g = probs.gather(-1, ids)
            gates = g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9)
        if record is not None:
            record.append(ids)
        return ids, gates, aux
    MOE._route = route
    try:
        yield
    finally:
        MOE._route = orig


def _flips(a, b):
    """(token, slot) routing choices on which two recorded runs differ."""
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def _serve_int8(cfg, params, requests, max_len, new_tokens, want, bf16_decode):
    """deepseek's second run: MLA's latent and rope-key caches in int8.
    The prefill attends within its chunk, so the first decode step is the
    first to read the int8 cache; its logits are held to the plain run's
    through int8 caches of its own.  Returns (launches, line, failures)."""
    eng = ServeEngine(cfg, params, max_len=max_len, cache_dtype=torch.int8)
    plain = ServeEngine(cfg.replace(use_pallas="never"), params,
                        max_len=max_len, cache_dtype=torch.int8)
    _zero_launches()
    outs = [eng.generate(t, new_tokens) for t in requests]
    launches = _launches()
    failures = [] if launches == want else [
        f"int8 cache: kernel launches {launches}, expected {want}"]
    rels, vs_bf16 = [], []
    for t, ld16 in zip(requests, bf16_decode):
        rec = []
        with _routes(record=rec):
            lk, ck = eng.prefill_fn(params, t)
            tok = lk[:, -1].argmax(-1)[:, None]
            ld, _ = eng.decode_fn(params, tok, ck)
        with _routes(replay=rec):
            lp, cp = plain.prefill_fn(params, t)
            lpd, _ = plain.decode_fn(params, tok, cp)
        if not all(c[k].dtype == torch.int8 for c in ck["layers"]
                   for k in ("latent", "k_rope")):
            failures.append("int8 cache: a latent cache is not int8")
        if not torch.isfinite(ld.float()).all():
            failures.append("int8 cache: non-finite decode logits")
        rels.append(_rel(ld, lpd))
        vs_bf16.append(_rel(ld, ld16))
        if rels[-1] > 5e-2:
            failures.append(f"int8 cache: decode logits differ from the plain "
                            f"run by rel {rels[-1]} at prompt {t.shape[1]}")
    for out in outs:
        if tuple(out.shape) != (requests[0].shape[0], new_tokens):
            failures.append(f"int8 cache: generated shape {tuple(out.shape)}")
    s = eng.stats
    line = {"int8_cache_launches": {COUNT_KEYS[n]: k
                                    for n, k in launches.items()},
            "int8_first_decode_rel_err": rels, "int8_rel_tol": 5e-2,
            "int8_vs_bf16_cache_decode_rel": vs_bf16,
            "int8_prefill_tok_per_s": s["prefill_tokens"] / s["prefill_s"],
            "int8_decode_tok_per_s": s["decode_tokens"] / s["decode_s"]}
    return launches, line, failures


def _serve_sort(cfg, params, eng, requests, max_len, new_tokens, bf16_tokens):
    """deepseek's MoE by ``moe_impl="sort"`` against the served ``gshard``:
    first-token logits at the same routes (bf16 bar), and greedy tokens in
    float32 compute at the longest prompt, which must be equal.  The bf16
    tokens' agreement is reported.  Returns (line, failures)."""
    sort = ServeEngine(cfg.replace(moe_impl="sort"), params, max_len=max_len)
    rels, failures = [], []
    for t in requests:
        rec = []
        with _routes(record=rec):
            lg, _ = eng.prefill_fn(params, t)
        with _routes(replay=rec):
            ls, _ = sort.prefill_fn(params, t)
        rels.append(_rel(ls, lg))
        if rels[-1] > 5e-2:
            failures.append(f"sort: first-token logits differ from gshard's "
                            f"by rel {rels[-1]} at prompt {t.shape[1]}")
    bf16_sort = sort.generate(requests[-1], new_tokens)
    cfg32 = cfg.replace(compute_dtype="float32")
    t32 = {impl: ServeEngine(cfg32.replace(moe_impl=impl), params,
                             max_len=max_len).generate(requests[-1], new_tokens)
           for impl in ("gshard", "sort")}
    equal32 = bool(torch.equal(t32["gshard"], t32["sort"]))
    if not equal32:
        failures.append("sort: float32 greedy tokens differ from gshard's")
    line = {"sort_first_token_rel_err": rels, "sort_rel_tol": 5e-2,
            "sort_fp32_greedy_tokens_equal": equal32,
            "sort_bf16_greedy_token_agreement": float(
                (bf16_sort == bf16_tokens).float().mean())}
    return line, failures


def _extras(cfg, batch, gen, dev):
    """Random bf16 N(0, 1) stub-frontend inputs of one request, in
    ``extra_shapes`` order (empty for a model that reads none)."""
    return {key: torch.randn(shape, generator=gen, device=dev).to(BF16)
            for key, shape in extra_shapes(cfg, batch).items()}


SERVE_PROFILE_STEPS = 8


# kernel-name fragments of the matrix products (cuBLAS / cuBLASLt) and of
# the copies and dtype casts (the float32 weights' casts to bf16)
_GEMM = ("gemm", "nvjet", "xmma", "cutlass")
_COPY = ("copy", "cast")


def _device_groups(fn):
    """Device time (ms) of ``fn()`` under torch.profiler by kernel group
    (the flash forward, matrix products, copies and casts, the rest) and
    by kernel name (the five longest); (None, None) where the profiler
    records no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups, names = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        names[e.name[:100]] = names.get(e.name[:100], 0.0) + ms
        low = e.name.lower()
        name = ("flash_fwd" if "flash_fwd" in low else
                "gemm" if any(f in low for f in _GEMM) else
                "copy_cast" if any(f in low for f in _COPY) else "other")
        groups[name] = groups.get(name, 0.0) + ms
    if not groups:
        return None, None
    return groups, sorted(names.items(), key=lambda kv: -kv[1])[:5]


def serve_profile(eng, params, t, xs, steps=SERVE_PROFILE_STEPS):
    """One prefill of ``t`` and ``steps`` greedy decode steps after it: wall
    ms of each (synchronized, without the profiler), and under
    torch.profiler the device ms by kernel group, the flash kernel's share
    of the device time, and the device's idle share (1 - device busy /
    wall).  Kernels run on one stream, so their summed times are the busy
    time."""
    state = {}

    def prefill():
        state["logits"], state["caches"] = eng.prefill_fn(params, t, *xs)

    def decode():
        tok = state["logits"][:, -1].argmax(-1)[:, None]
        caches = state["caches"]
        for _ in range(steps):
            logits, caches = eng.decode_fn(params, tok, caches)
            tok = logits.argmax(-1)[:, None]

    out = {"prompt_len": t.shape[1], "decode_steps": steps}
    # decode writes its caches in place at the same positions each time it
    # runs from the prefill's state, so both of its runs do the same work
    for name, fn, n in (("prefill", prefill, 1),
                        ("decode_step", decode, steps)):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3 / n
        groups, top = _device_groups(fn)
        busy = sum(groups.values()) / n if groups else None
        out[name] = {"wall_ms": wall, "device_busy_ms": busy}
        if groups:
            out[name].update(
                device_ms_by_group={k: v / n for k, v in sorted(groups.items())},
                top_kernels_ms=[[k, v / n] for k, v in top],
                flash_share_of_device=groups.get("flash_fwd", 0.0) / n / busy,
                idle_share=1.0 - busy / wall)
    return out


@torch.inference_mode()
def phase_serve(dev, arch):
    """Serve one model at full width (and full depth unless SERVE cuts it);
    returns its launch counts.  Every check runs before the first failure
    is raised, so the serve line holds all of them."""
    t_phase = time.monotonic()
    opt = SERVE[arch]
    batch, prompts, new_tokens = opt["batch"], opt["prompts"], opt["new_tokens"]
    full = registry.get_config(arch)
    cfg = full if opt["n_repeat"] is None else full.replace(
        n_repeat=opt["n_repeat"], n_layers=len(full.prologue)
        + len(full.superblock) * opt["n_repeat"])
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    for p, spec in zip(params.layers, cfg.plan):
        if spec.kind == "xattn":  # tanh(0) at init would hide the layer
            p.xgate.fill_(1.0)
    max_len = max(prompts) + new_tokens + 8
    eng = ServeEngine(cfg, params, max_len=max_len)
    gen = torch.Generator(device=dev).manual_seed(1)
    requests = [torch.randint(0, cfg.vocab_size, (batch, n), generator=gen,
                              device=dev) for n in prompts]
    # the stub frontends' inputs (whisper's frames, llama-vision's patches),
    # one set a request, in ServeEngine's order
    extras = [_extras(cfg, batch, gen, dev) for _ in prompts]
    eng.generate(requests[0][:, :8], 2, extra=extras[0])  # warm-up
    eng.stats = {k: type(v)() for k, v in eng.stats.items()}

    _zero_launches()
    outs = [eng.generate(t, new_tokens, extra=ex)
            for t, ex in zip(requests, extras)]
    launches = _launches()

    per_prefill = opt["counts"](cfg)
    per_step = opt["decode_counts"](cfg)
    want = {name: len(prompts) * (per_prefill.get(name, 0) + (new_tokens - 1)
                                  * per_step.get(name, 0))
            for name in KERNELS}
    failures = []
    if launches != want:
        failures.append(f"kernel launches {launches} in the serve run, "
                        f"expected {want}")
    for t, out in zip(requests, outs):
        if tuple(out.shape) != (batch, new_tokens):
            failures.append(f"generated shape {tuple(out.shape)}")
        if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
            failures.append("generated tokens out of vocabulary range")

    # The plain versions the kernels are held to: for rwkv6 the chunked WKV
    # algorithm the kernel computes.  A deep random-weight model amplifies
    # bf16 rounding, so the bf16 bar is 5e-2 or, where the model has two
    # plain versions (rwkv6: blocked, which rounds its operands to bf16, and
    # chunked), the distance between those two, whichever is larger.  A
    # float32-compute run at the longest prompt holds the kernels' arithmetic
    # end to end at FP32_SERVE_REL.  MoE models compare at the kernel run's
    # routes (_routes); the plain run's own routes are reported beside.
    plain = ServeEngine(cfg.replace(use_pallas="never", wkv_impl="chunked"),
                        params, max_len=max_len)
    blocked = (ServeEngine(cfg.replace(use_pallas="never"), params,
                           max_len=max_len)
               if cfg.wkv_impl == "blocked" else None)
    moe = bool(cfg.n_experts)
    rels, dec_rels, bars = [], [], []
    free_rels, flips, decode_logits = [], [], []
    for t, ex in zip(requests, extras):
        xs = list(ex.values())
        rec = []
        with _routes(record=rec):
            lk, caches = eng.prefill_fn(params, t, *xs)
            tok = lk[:, -1].argmax(-1)[:, None]
            ld, _ = eng.decode_fn(params, tok, caches)
        before = _launches()
        # the plain run decodes the kernel run's first token from its own
        # caches: the decode step's kernels (cross-attention's S = 1 flash)
        # are held to their plain versions at the served shapes too
        with _routes(replay=rec):
            lp, cp = plain.prefill_fn(params, t, *xs)
            lpd, _ = plain.decode_fn(params, tok, cp)
        lb = blocked.prefill_fn(params, t, *xs)[0].float() if blocked else None
        if moe:
            free = []
            with _routes(record=free):
                lf, _ = plain.prefill_fn(params, t, *xs)
            free_rels.append(_rel(lk, lf))
            flips.append(_flips(rec, free))
        if _launches() != before:
            failures.append("the plain run launched a kernel")
        decode_logits.append(ld)
        lk, lp, ld = lk.float(), lp.float(), ld.float()
        if not (torch.isfinite(lk).all() and torch.isfinite(ld).all()):
            failures.append("non-finite logits")
        rel, dec_rel = _rel(lk, lp), _rel(ld, lpd)
        bar = max(5e-2, _rel(lb, lp)) if lb is not None else 5e-2
        rels.append(rel)
        dec_rels.append(dec_rel)
        bars.append(bar)
        if rel > bar:
            failures.append(f"first-token logits differ from the plain run "
                            f"by rel {rel} > {bar} at prompt {t.shape[1]}")
        if dec_rel > bar:
            failures.append(f"first decode-step logits differ from the plain "
                            f"run by rel {dec_rel} > {bar} at prompt "
                            f"{t.shape[1]}")
    del caches, cp
    xs = list(extras[-1].values())
    cfg32 = cfg.replace(compute_dtype="float32")
    rec = []
    before = _launches()
    with _routes(record=rec):
        lk32 = ServeEngine(cfg32, params, max_len=max_len).prefill_fn(
            params, requests[-1], *xs)[0]
    ran = {name: n - before[name] for name, n in _launches().items()}
    if ran != {name: per_prefill.get(name, 0) for name in KERNELS}:
        failures.append(f"the float32 prefill launched {ran}")
    with _routes(replay=rec):
        lp32 = ServeEngine(cfg32.replace(use_pallas="never",
                                         wkv_impl="chunked"),
                           params, max_len=max_len).prefill_fn(
                               params, requests[-1], *xs)[0]
    rel32 = _rel(lk32, lp32)
    if not rel32 < FP32_SERVE_REL:
        failures.append(f"float32 first-token logits differ from the plain "
                        f"run by rel {rel32}")
    s = eng.stats
    line = dict(
        arch=cfg.arch_id, batch=batch, prompt_lens=list(prompts),
        new_tokens=new_tokens, n_layers=cfg.n_layers,
        full_depth_n_layers=full.n_layers,
        d_model=cfg.d_model,
        **{COUNT_KEYS[name]: n for name, n in launches.items()},
        expected_launches=want,
        expected_per_prefill=per_prefill, expected_per_decode_step=per_step,
        first_token_rel_err=rels, first_decode_rel_err=dec_rels,
        rel_tol=bars,
        fp32_first_token_rel_err=rel32, fp32_rel_tol=FP32_SERVE_REL,
        prefill_tok_per_s=s["prefill_tokens"] / s["prefill_s"],
        decode_tok_per_s=s["decode_tokens"] / s["decode_s"],
        stats=s, extras=sorted(extras[0]),
        profile=serve_profile(eng, params, requests[-1], xs))
    if moe:
        line.update(routes_replayed=True,
                    first_token_rel_err_own_routes=free_rels,
                    route_flips_own_routes=flips)
    if _count(cfg, "mla"):
        n8, extra, bad = _serve_int8(cfg, params, requests, max_len,
                                     new_tokens, want, decode_logits)
        line.update(extra)
        failures += bad
        launches = {name: launches[name] + n8[name] for name in KERNELS}
    if moe:
        extra, bad = _serve_sort(cfg, params, eng, requests, max_len,
                                 new_tokens, outs[-1])
        line.update(extra)
        failures += bad
    say("serve", **line, max_memory_allocated=torch.cuda.max_memory_allocated(),
        phase_s=time.monotonic() - t_phase, failures=failures, **_card())
    del eng, plain, blocked, params
    _free()
    if failures:
        raise RuntimeError(f"{arch}: " + "; ".join(failures))
    return launches


MERLIN_SAMPLES = 512
MERLIN_R2 = 0.9
MERLIN_BUNDLE_REL = 1e-4      # card bundles against the CPU port's, per row
MERLIN_PREDICT_REL = 1e-3     # surrogate predictions, card against CPU
THROUGHPUT_SAMPLES = (1024, 16384, 131072)


def _row_rel(got, want):
    """max |got - want| / max |want| over each row of two (n, ...) arrays,
    the worst row; NaNs must sit at the same places."""
    g = got.reshape(len(got), -1).astype("float64")
    w = want.reshape(len(want), -1).astype("float64")
    nan_g, nan_w = g != g, w != w
    if (nan_g != nan_w).any():
        raise RuntimeError("NaNs at other places")
    diff = abs(g - w)
    diff[nan_w] = 0.0
    w = abs(w)
    w[nan_w] = 0.0
    num, den = diff.max(1), w.max(1)
    rel = num / den.clip(min=1e-300)
    rel[num == 0] = 0.0
    return float(rel.max())


def _sorted_rows(data):
    order = data["_sample_ids"].argsort()
    return {k: v[order] for k, v in data.items()}


def phase_merlin(dev):
    """The Merlin loop on the card; raises on any miss."""
    _zero_launches()
    card, data, sur = quickstart.run_study(dev, samples=MERLIN_SAMPLES)
    launches = _launches()
    bound = len(ens.bucket_schedule(quickstart.BUNDLE))
    ids = sorted(int(i) for i in data["_sample_ids"])
    say("merlin_study", **card, kernel_launches=launches,
        capture_bound=bound, r2_min=MERLIN_R2,
        measured_on=torch.cuda.get_device_name(0),
        nvidia_smi=env.nvidia_smi_line())
    if ids != list(range(MERLIN_SAMPLES)):
        raise RuntimeError(f"{len(ids)} of {MERLIN_SAMPLES} samples bundled")
    if not card["r2"] >= MERLIN_R2:
        raise RuntimeError(f"surrogate R^2 {card['r2']} < {MERLIN_R2}")
    if not 1 <= card["captures"] <= bound:
        raise RuntimeError(f"{card['captures']} graph captures, bound {bound}")

    cpu, data_cpu, _ = quickstart.run_study("cpu", samples=MERLIN_SAMPLES)
    a, b = _sorted_rows(data), _sorted_rows(data_cpu)
    if set(a) != set(b):
        raise RuntimeError(f"bundle keys {sorted(a)} != {sorted(b)}")
    rels = {k: _row_rel(a[k], b[k]) for k in sorted(a)}
    if not (a["failed"] == b["failed"]).all():
        raise RuntimeError("failed flags differ between card and CPU")
    bad = {k: r for k, r in rels.items() if not r <= MERLIN_BUNDLE_REL}
    if bad:
        raise RuntimeError(f"card bundles differ from the CPU's: {bad}")
    X, y = regression_dataset(data, target="yield")
    half = len(X) // 2
    sur_cpu = active.train_surrogate(X[:half], y[:half],
                                     steps=quickstart.STEPS, device="cpu")
    mu, sd = sur.predict(X[half:])
    mu_c, sd_c = sur_cpu.predict(X[half:])
    scale = float(abs(mu_c).max())
    pred_rel = float(max(abs(mu - mu_c).max(), abs(sd - sd_c).max()) / scale)
    say("merlin_parity", bundle_row_rel=rels, bundle_rel_tol=MERLIN_BUNDLE_REL,
        failed_rows=int(a["failed"].sum()), prediction_rel=pred_rel,
        prediction_rel_tol=MERLIN_PREDICT_REL, cpu_r2=cpu["r2"],
        cpu_sim_time=cpu["sim_time"], cpu_surrogate_s=cpu["surrogate_s"])
    if not pred_rel <= MERLIN_PREDICT_REL:
        raise RuntimeError(f"card and CPU surrogates differ by {pred_rel}")

    gen = torch.Generator().manual_seed(2)
    for sim, d in ((jag_simulate, 5), (seir_simulate, 6)):
        ex = ens.EnsembleExecutor(sim, device=dev)
        for n in THROUGHPUT_SAMPLES:
            X = torch.rand(n, d, generator=gen).numpy()
            out = ex.run_bundle(0, n, X)          # capture, then a warm call
            if not all(v.shape[0] == n for v in out.values()):
                raise RuntimeError("run_bundle returned the wrong rows")
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                ex.run_bundle(0, n, X)
                walls.append(time.perf_counter() - t0)
            pending = ex.run_bundle(0, n, X, block=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for v in pending.values():
                v.cpu()
            host_copy = time.perf_counter() - t0
            del pending
            graph = ex.program(n, d).graph
            reps = 3 if n > 20000 else 10
            replay = device_ms(graph.replay, rounds=5, reps=reps)
            wall = statistics.median(walls)
            out_bytes = sum(v.nbytes for v in out.values())
            say("merlin_throughput", simulator=sim.__name__, samples=n,
                samples_per_s=n / wall, wall_s=wall, walls_s=walls,
                host_copy_s=host_copy,
                replay_ms=replay, replay_samples_per_s=n / (replay / 1e3),
                output_bytes=out_bytes,
                output_gb_per_s=out_bytes / (replay / 1e3) / 1e9,
                measured_on=torch.cuda.get_device_name(0),
                nvidia_smi=env.nvidia_smi_line())
        del ex, out
        _free()

    rng = torch.Generator().manual_seed(3)
    Xs = torch.rand(4096, 5, generator=rng).numpy()
    ys = (Xs[:, 0] ** 2 - 0.5 * Xs[:, 1]).astype("float32")
    for rows in (256, 4096):
        active.train_surrogate(Xs[:rows], ys[:rows], steps=5, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        active.train_surrogate(Xs[:rows], ys[:rows], steps=quickstart.STEPS,
                               device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        say("merlin_surrogate", rows=rows, members=3, hidden=64,
            steps=quickstart.STEPS, seconds=secs, ms_per_step=secs * 1e3 /
            quickstart.STEPS, measured_on=torch.cuda.get_device_name(0),
            nvidia_smi=env.nvidia_smi_line())
    _free()


NET_BUNDLE_REL = 1e-6         # bundles of the three deployments, per row
GATEWAY_CLIENTS = 16
GATEWAY_REQUESTS = 64         # a client
GATEWAY_PREDICT_REL = 1e-3    # after the refresh, card against CPU
CASCADE_BUNDLE_REL = 3.4e-4   # SEIR's float32 bar (card against CPU)
CASCADE_RMSE_REL = 1e-3


def _zero_launches():
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def _no_launches(phase):
    got = _launches()
    if any(got.values()):
        raise RuntimeError(f"{phase}: kernel launches {got}, expected none")
    return got


def _card():
    return {"measured_on": torch.cuda.get_device_name(0),
            "nvidia_smi": env.nvidia_smi_line()}


def phase_merlin_net(dev):
    """The quickstart study over the three deployments; returns the
    in-process run's archive (the gateway phase serves it)."""
    runs = {}
    for mode in ("mem", "tcp", "sharded"):
        _zero_launches()
        summary, data, _ = quickstart.run_study(dev, samples=MERLIN_SAMPLES,
                                                broker_mode=mode)
        launches = _no_launches(f"merlin_net {mode}")
        ids = sorted(int(i) for i in data["_sample_ids"])
        say("merlin_net", mode=mode, **summary, kernel_launches=launches,
            r2_min=MERLIN_R2, **_card())
        if ids != list(range(MERLIN_SAMPLES)):
            raise RuntimeError(f"{mode}: {len(ids)} of {MERLIN_SAMPLES} "
                               "samples bundled")
        if not summary["r2"] >= MERLIN_R2:
            raise RuntimeError(f"{mode}: surrogate R^2 {summary['r2']}")
        runs[mode] = _sorted_rows(data)
    base = runs["mem"]
    rels = {}
    for mode in ("tcp", "sharded"):
        other = runs[mode]
        if set(other) != set(base):
            raise RuntimeError(f"{mode}: bundle keys {sorted(other)}")
        if not (other["failed"] == base["failed"]).all():
            raise RuntimeError(f"{mode}: failed flags differ from mem://")
        rels[mode] = {k: _row_rel(other[k], base[k]) for k in sorted(base)}
        bad = {k: r for k, r in rels[mode].items() if not r <= NET_BUNDLE_REL}
        if bad:
            raise RuntimeError(f"{mode}: bundles differ from mem://: {bad}")
    say("merlin_net_parity", bundle_row_rel=rels, rel_tol=NET_BUNDLE_REL,
        failed_rows=int(base["failed"].sum()))
    return base


def _http(conn, method, path, body=None):
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read() or b"{}")


def phase_gateway(dev, data):
    """The surrogate gateway on the card under 16 clients, with a refresh
    (retrain and capture) halfway through."""
    import http.client
    import threading
    X, y = regression_dataset(data, target="yield")
    first = (3 * len(X)) // 4
    grid = torch.rand(256, X.shape[1],
                      generator=torch.Generator().manual_seed(4)).numpy()
    _zero_launches()
    with tempfile.TemporaryDirectory() as root:
        Bundler(root).write_bundle(0, first, {"inputs": X[:first],
                                              "yield": y[:first]})
        t0 = time.perf_counter()
        snap = active.SurrogateSnapshot(root, device=dev)
        build_s = time.perf_counter() - t0
        gw = SurrogateGateway(snap, max_batch_rows=256, max_inflight=64,
                              auth_token=None).start()
        lat, statuses, errors = [], [], []
        lock = threading.Lock()
        done = [0]
        half = threading.Event()
        total = GATEWAY_CLIENTS * GATEWAY_REQUESTS

        def client(i):
            rng = torch.Generator().manual_seed(100 + i)
            conn = http.client.HTTPConnection("127.0.0.1", gw.port,
                                              timeout=60)
            try:
                for _ in range(GATEWAY_REQUESTS):
                    n = int(torch.randint(1, 33, (1,), generator=rng))
                    pts = torch.rand(n, X.shape[1], generator=rng).tolist()
                    t = time.perf_counter()
                    st, out = _http(conn, "POST", "/v1/predict",
                                    {"points": pts})
                    dt = time.perf_counter() - t
                    with lock:
                        lat.append(dt)
                        statuses.append(st)
                        done[0] += 1
                        if done[0] >= total // 2:
                            half.set()
                    if st == 200 and len(out["mu"]) != n:
                        raise RuntimeError(f"{len(out['mu'])} of {n} rows")
            except Exception as e:  # raised below
                errors.append(e)
            finally:
                conn.close()
        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(GATEWAY_CLIENTS)]
            for t in threads:
                t.start()
            conn = http.client.HTTPConnection("127.0.0.1", gw.port,
                                              timeout=120)
            other = [_http(conn, "POST", "/v1/calibrate",
                           {"target": 0.5, "n_candidates": 256, "top_k": 4}),
                     _http(conn, "POST", "/v1/what-if",
                           {"point": [0.5] * X.shape[1], "radius": 0.05,
                            "n_perturb": 64})]
            if not half.wait(timeout=300):
                raise RuntimeError("half of the predicts did not finish")
            version0 = snap.version
            Bundler(root).write_bundle(first, len(X), {"inputs": X[first:],
                                                       "yield": y[first:]})
            t0 = time.perf_counter()
            st_refresh, refresh = _http(conn, "POST", "/v1/refresh", {})
            refresh_s = time.perf_counter() - t0
            in_flight = GATEWAY_CLIENTS * GATEWAY_REQUESTS - done[0]
            for t in threads:
                t.join(timeout=300)
            st_grid, after = _http(conn, "POST", "/v1/predict",
                                   {"points": grid.tolist()})
            conn.close()
        finally:
            gw.stop(drain=True, timeout=30)
        stats = gw.stats()
        launches = _no_launches("gateway")
        if errors:
            raise RuntimeError(f"gateway clients failed: {errors[0]!r}")
        cpu = active.SurrogateSnapshot(root, device="cpu")
    mu_c, sd_c = cpu.predict(grid)
    mu, sd = np.asarray(after["mu"]), np.asarray(after["sigma"])
    scale = float(abs(mu_c).max())
    pred_rel = float(max(abs(mu - mu_c).max(), abs(sd - sd_c).max()) / scale)
    lat_ms = sorted(x * 1e3 for x in lat)
    said = {st for st in statuses} | {st for st, _ in other} | {
        st_refresh, st_grid}
    say("gateway", clients=GATEWAY_CLIENTS, requests=len(lat),
        predict_p50_ms=statistics.median(lat_ms),
        predict_p99_ms=lat_ms[int(0.99 * (len(lat_ms) - 1))],
        predict_max_ms=lat_ms[-1], statuses=sorted(said),
        batches=stats["batcher"]["batches"],
        avg_requests_per_batch=stats["batcher"]["avg_requests_per_batch"],
        snapshot_build_s=build_s, refresh_s=refresh_s, refresh=refresh,
        predicts_left_at_refresh=in_flight, version_before=version0,
        version_after=snap.version, rows=snap.rows,
        prediction_rel_vs_cpu=pred_rel, rel_tol=GATEWAY_PREDICT_REL,
        http=stats["http"], kernel_launches=launches, **_card())
    if any(st >= 500 for st in said) or said != {200}:
        raise RuntimeError(f"gateway statuses {sorted(said)}")
    if not (refresh.get("refreshed") and snap.version == version0 + 1):
        raise RuntimeError(f"refresh {refresh}: version {version0} -> "
                           f"{snap.version}")
    if len(lat) != GATEWAY_CLIENTS * GATEWAY_REQUESTS:
        raise RuntimeError(f"{len(lat)} predicts answered")
    if not pred_rel <= GATEWAY_PREDICT_REL:
        raise RuntimeError(f"refreshed gateway and CPU snapshot differ by "
                           f"{pred_rel}")


def phase_cascade(dev):
    """The COVID cascade on the card and on the CPU."""
    obs = covid_calibration.synth_observations(device=dev)
    _zero_launches()
    card, calib = covid_calibration.run_cascade(dev, observed=obs)
    launches = _no_launches("cascade")
    cpu, calib_cpu = covid_calibration.run_cascade("cpu", observed=obs)
    rels, rmse = {}, {}
    for m in covid_calibration.METROS:
        a, b = _sorted_rows(calib[m]), _sorted_rows(calib_cpu[m])
        if list(a["_sample_ids"]) != list(range(covid_calibration.N_CALIB)):
            raise RuntimeError(f"{m}: {len(a['_sample_ids'])} draws bundled")
        rels[m] = max(_row_rel(a[k], b[k]) for k in b)
        rmse[m] = (card[m]["posterior_rmse"], cpu[m]["posterior_rmse"])
    peaks = {m: {s: card[m][s]["peak_median"] for s in card[m]
                 if s != "posterior_rmse"} for m in covid_calibration.METROS}
    say("cascade", wall_s=card["wall_s"], cpu_wall_s=cpu["wall_s"],
        calib_row_rel=rels, rel_tol=CASCADE_BUNDLE_REL,
        posterior_rmse_card_cpu=rmse, rmse_rel_tol=CASCADE_RMSE_REL,
        peak_median=peaks, kernel_launches=launches, **_card())
    for m in covid_calibration.METROS:
        if not rels[m] <= CASCADE_BUNDLE_REL:
            raise RuntimeError(f"{m}: calibration bundles differ by {rels[m]}")
        a, b = rmse[m]
        if not abs(a - b) <= CASCADE_RMSE_REL * abs(b):
            raise RuntimeError(f"{m}: posterior RMSE {a} against {b}")
        if not peaks[m]["strong_npi"] <= peaks[m]["baseline"] + 1e-6:
            raise RuntimeError(f"{m}: strong NPIs raise the peak: {peaks[m]}")


def phase_icf(dev):
    _zero_launches()
    res = icf_ensemble.run_icf(dev, log=lambda line: None)
    launches = _no_launches("icf")
    say("icf", **res, paper_failure_pct=0.22, kernel_launches=launches,
        **_card())
    n = icf_ensemble.N_SAMPLES
    if res["on_disk"] != n or res["rows"] != n:
        raise RuntimeError(f"icf: {res['on_disk']} of {n} on disk, "
                           f"{res['rows']} rows loaded")
    if not res["duplicates_agree"]:
        raise RuntimeError(f"icf: {res['duplicate_rows']} rows written twice "
                           f"differ from their first copy")


def phase_optimization_loop(dev):
    _zero_launches()
    history, wall = optimization_loop.run_loop(dev)
    launches = _no_launches("optimization_loop")
    say("optimization_loop", history=history, wall_s=wall,
        gain=history[-1]["best"] / history[0]["best"],
        kernel_launches=launches, **_card())
    if not history[-1]["best"] >= history[0]["best"]:
        raise RuntimeError(f"best went down: {history}")


# Flash backward: (name, B, S, T, H, KV, D, dtype, causal, window, softcap).
# jag's training shapes (synthetic S 128; the quickstart's bundles, S 8),
# zamba2's 512 prefill shape, then every option and ragged edge.
BWD_SHAPES = [
    ("jag_train_128", 8, 128, 128, 4, 4, 64, BF16, True, None, None),
    ("jag_bundles_8", 8, 8, 8, 4, 4, 64, BF16, True, None, None),
    ("zamba2_512", 4, 512, 512, 32, 32, 64, BF16, True, None, None),
    ("gqa_8_2", 2, 256, 256, 8, 2, 64, BF16, True, None, None),
    ("window64_softcap30", 2, 300, 300, 4, 2, 32, BF16, True, 64, 30.0),
    ("D16", 1, 130, 130, 2, 1, 16, BF16, True, None, None),
    ("D128_gqa", 2, 200, 200, 8, 2, 128, BF16, True, None, None),
    ("ragged_100", 2, 100, 100, 4, 4, 64, BF16, True, None, None),
    ("cross_S45_T83", 1, 45, 83, 4, 2, 64, BF16, False, None, None),
    ("f32_D64", 2, 256, 256, 4, 4, 64, F32, True, None, None),
    ("f32_window16_softcap30_gqa", 2, 100, 100, 4, 2, 32, F32, True, 16,
     30.0),
    # the encoder archs' training shapes (one microbatch row): whisper's
    # 1500-frame encoder (23 full 64-row tiles and 28 rows), its decoder's
    # cross-attention (2 query tiles a dK/dV block) and llama-vision's GQA
    # 32:8 cross-attention over 1600 image tokens
    ("whisper_enc_1500", 1, 1500, 1500, 6, 6, 64, BF16, False, None, None),
    ("whisper_cross_128", 1, 128, 1500, 6, 6, 64, BF16, False, None, None),
    ("llama_vision_cross_128", 1, 128, 1600, 32, 8, 128, BF16, False, None,
     None),
]
BWD_MAIN = ("jag_train_128", "jag_bundles_8")
BWD_ENCDEC = ("whisper_enc_1500", "whisper_cross_128",
              "llama_vision_cross_128")
BWD_TIMED = BWD_MAIN + ("zamba2_512", "D128_gqa") + BWD_ENCDEC
# max |kernel - plain| / max |plain| of dq, dk, dv: float32 sums in another
# order; the bf16 kernel rounds P and dS to bf16 as operands and its outputs
# once.  Against the mirror of those rounding points (bf16 only) the rest
# is the order of fp32 sums and a rounding tie flipped by it.  The
# forward's log-sum-exp against flash_attention_lse_ref's: absolute, in nats.
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_TC_REL = 1e-2
LSE_ATOL = 1e-3


def sdpa_backward(q, k, v, do, causal, scale):
    """Device ms of scaled_dot_product_attention's backward alone (autograd
    over a kept graph), by default dispatch and per backend (None where a
    backend refuses these inputs)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    gqa = q.shape[2] != k.shape[2]

    def time_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=gqa)
        return device_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))

    per = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                per[name] = time_bwd()
        except RuntimeError:
            per[name] = None
    return {"library_ms": time_bwd(), "library_backend_ms": per}


def bwd_work(q, k, kw):
    """Bytes (q, k, v, o, dO, lse read once; dq, dk, dv written once) and
    the products of the backward over the kept (query, key) pairs: Q K^T,
    dO V^T, P^T dO, dS K and dS^T Q, 2 D each."""
    B, S, H, D = q.shape
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + B * H * S * 4
    pairs = valid_pairs(S, k.shape[1], kw["causal"], kw["window"], 0)
    return _bound(nbytes, 10 * D * B * H * pairs)


def phase_flash_backward(dev):
    """The backward kernel against its plain version at every BWD_SHAPES
    entry (bf16 also against the mirror of its rounding points), from the
    forward kernel's output and log-sum-exp (held to its plain version
    too); the autograd Function gives the same gradients as the direct
    calls.  Timed at BWD_TIMED beside the forward with and
    without the log-sum-exp store and scaled_dot_product_attention's
    backward."""
    gen = torch.Generator(device=dev).manual_seed(5)
    errs, timing = {}, {}
    for name, B, S, T, H, KV, D, dt, causal, window, softcap in BWD_SHAPES:
        q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, T, KV, D, generator=gen, device=dev).to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap_val=softcap)
        out, lse = fak.flash_attention_lse(q, k, v, **kw)
        got = fak.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        _, lse_plain = ref.flash_attention_lse_ref(q, k, v, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, **kw)
        lse_err = float((lse - lse_plain).abs().max())
        rels = {g: _rel(a, b) for g, a, b in zip(("dq", "dk", "dv"), got,
                                                 want)}
        rels_tc = {}
        if dt == BF16:
            mirror = ref.flash_attention_bwd_tc_ref(q, k, v, out, do, lse,
                                                    **kw)
            rels_tc = {g: _rel(a, b) for g, a, b in
                       zip(("dq", "dk", "dv"), got, mirror)}
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        qa, ka, va = (x.detach().requires_grad_() for x in (q, k, v))
        fak.flash_attention(qa, ka, va, **kw).backward(do)
        same = all(torch.equal(x.grad, g) for x, g in zip((qa, ka, va), got))
        ok = bool(all(torch.isfinite(g.float()).all() for g in got)
                  and max(rels.values()) < BWD_REL[dt]
                  and max(rels_tc.values(), default=0.0) < BWD_TC_REL
                  and lse_err < LSE_ATOL and same)
        errs[name] = err
        say("kernel_vs_plain", kernel="flash_attention_bwd", shape=name,
            B=B, S=S, T=T, H=H, KV=KV, D=D, dtype=str(dt).split(".")[-1],
            causal=causal, window=window, softcap=softcap, max_abs_err=err,
            rel_err=rels, rel_tol=BWD_REL[dt], tc_mirror_rel_err=rels_tc,
            tc_mirror_rel_tol=BWD_TC_REL if rels_tc else None,
            lse_abs_err=lse_err,
            lse_atol=LSE_ATOL, autograd_equals_direct=same, ok=ok)
        if not ok:
            raise RuntimeError(f"flash_attention_bwd disagrees with its plain "
                               f"version at {name}: {rels}, mirror "
                               f"{rels_tc}, lse {lse_err}, autograd equal "
                               f"{same}")
        if name in BWD_TIMED:
            scale = 1.0 / D ** 0.5
            t = timing[name] = {
                "ms": device_ms(lambda: fak.flash_attention_bwd(
                    q, k, v, out, lse, do, **kw)),
                "plain_ms": device_ms(lambda: ref.flash_attention_bwd_ref(
                    q, k, v, out, do, lse, **kw)),
                "fwd_lse_ms": device_ms(lambda: fak.flash_attention_lse(
                    q, k, v, **kw)),
                "fwd_ms": device_ms(lambda: fak.flash_attention(q, k, v, **kw)),
                **sdpa_backward(q, k, v, do, causal, scale),
                **bwd_work(q, k, kw)}
            t["kernel_over_bound"] = t["ms"] / t["bound_ms"]
            t["kernel_over_library"] = t["ms"] / t["library_ms"]
            say("kernel_time", kernel="flash_attention_bwd", shape=name,
                kernel_ms=t["ms"], **{key: val for key, val in t.items()
                                      if key != "ms"}, **_card())
    return errs, timing


TRAIN_BUNDLE_STEPS = 200      # jag at full width on the quickstart's bundles
TRAIN_RESUME_STEPS = 20       # then resumed from its last checkpoint
TRAIN_SYNTH_STEPS = 50        # synthetic tokens, batch 8 x seq 128
FP32_TRAIN_STEPS = 20         # float32 compute, card against the CPU port
FP32_TRAIN_REL = 1e-3
# a JAG record's tokens as an LM sees them: 5 inputs and 4 scalars, less one
RECORD_SEQ = 5 + len(launch_train.SCALAR_KEYS) - 1


def _train_launches(cfg, steps):
    """Exact counts of a training run under remat="full": each layer's
    forward runs twice a microbatch (once more in the backward's recompute),
    its backward once."""
    if cfg.remat != "full":
        raise RuntimeError(f"jag-surrogate's remat is {cfg.remat!r}")
    n = cfg.n_layers * max(1, cfg.microbatch) * steps
    return {"flash_attention": 2 * n, "flash_attention_bwd": n,
            "wkv6_scan": 0, "ssd_scan": 0}


def _train_run(label, args, tokens, want):
    """``python -m repro_torch.launch.train ARGS`` in this process, its
    launch counts read around it (``tokens``: a step's); returns (summary,
    trainer, launches)."""
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()):  # said below instead
        summary, tr = launch_train.main(args)
    launches = _launches()
    dts = sorted(h["dt"] for h in tr.history[1:]) or [float("nan")]
    say("train", run=label, **summary, expected_launches=want,
        kernel_launches=launches, tokens_per_step=tokens,
        step_ms_median=1e3 * statistics.median(dts),
        step_ms_p90=1e3 * dts[int(0.9 * (len(dts) - 1))],
        tokens_per_s_at_median=tokens / statistics.median(dts),
        first10_loss=[h["loss"] for h in tr.history[:10]],
        last10_loss=[h["loss"] for h in tr.history[-10:]],
        max_memory_allocated=torch.cuda.max_memory_allocated(), **_card())
    if launches != want:
        raise RuntimeError(f"train {label}: kernel launches {launches}, "
                           f"expected {want}")
    if not all(np.isfinite(h["loss"]) for h in tr.history):
        raise RuntimeError(f"train {label}: non-finite loss")
    return summary, tr, launches


PROFILE_STEPS = 5


def profile_steps(tr, step_ms):
    """Device time of PROFILE_STEPS steps of ``tr`` (restored from its last
    checkpoint) under torch.profiler: see ``profile_run``."""
    state = tr.restore_or_init()
    batches = [next(tr.data) for _ in range(PROFILE_STEPS + 1)]
    return profile_run(tr.step_fn, state, batches, step_ms)


def profile_run(step_fn, state, batches, step_ms):
    """Device time of the steps of ``batches[1:]`` (``batches[0]`` warms)
    under torch.profiler, by kernel group, and the device's idle share of a
    step: 1 - device busy per step / ``step_ms`` (the median step wall of
    the same run without the profiler).  Kernels run on one stream, so
    their summed times are the busy time.  None where the profiler records
    no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = len(batches) - 1
    state, m = step_fn(state, batches[0])  # warm
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[1:]:
            state, m = step_fn(state, b)
        float(m["loss"])
        torch.cuda.synchronize()
    groups, n_events = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n_events += 1
        low = e.name.lower()
        name = ("flash_fwd" if "flash_fwd" in low else
                "flash_bwd" if "flash_bwd" in low else
                "gemm" if any(f in low for f in _GEMM) else
                "copy_cast" if any(f in low for f in _COPY) else "other")
        groups[name] = groups.get(name, 0.0) + e.time_range.elapsed_us()
    if not n_events:
        return {"device_busy_ms_per_step": None, "idle_share": None}
    busy = sum(groups.values()) / 1e3 / n
    return {"device_busy_ms_per_step": busy,
            "device_ms_per_step_by_group": {
                k: v / 1e3 / n for k, v in sorted(groups.items())},
            "device_events_per_step": n_events / n,
            "step_ms": step_ms, "idle_share": 1.0 - busy / step_ms}


def _write_study(data, root):
    """The quickstart study's archive written back as bundles of
    quickstart.BUNDLE under ``root``; returns ``root``."""
    n = len(data["inputs"])
    for lo in range(0, n, quickstart.BUNDLE):
        Bundler(root).write_bundle(lo, min(n, lo + quickstart.BUNDLE), {
            k: v[lo:lo + quickstart.BUNDLE] for k, v in data.items()
            if not k.startswith("_")})
    return root


def phase_train(data, keep):
    """jag-surrogate at full width through launch.train on the card: on
    the quickstart study's bundles (its archive, written back as bundles of
    64) for TRAIN_BUNDLE_STEPS, where the loss must fall; resumed from its
    last checkpoint; synthetic at batch 8 x seq 128; then launch.train's
    Trainer in float32 compute on the card against the same on the CPU,
    from one seed and one batch stream.  The synthetic run's checkpoints
    are copied to ``keep`` (for the mesh phase).  Returns the card runs'
    summed launch counts."""
    cfg = registry.get_config("jag-surrogate")
    total = {name: 0 for name in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        root = _write_study(data, os.path.join(tmp, "study"))
        wd = os.path.join(tmp, "bundles")
        runs = [
            ("bundles", ["--data", root, "--steps", str(TRAIN_BUNDLE_STEPS),
                         "--ckpt-every", "100", "--workdir", wd],
             TRAIN_BUNDLE_STEPS, 8 * RECORD_SEQ),
            ("bundles_resumed",
             ["--data", root, "--ckpt-every", "100", "--workdir", wd,
              "--steps", str(TRAIN_BUNDLE_STEPS + TRAIN_RESUME_STEPS)],
             TRAIN_RESUME_STEPS, 8 * RECORD_SEQ),
            ("synthetic", ["--batch", "8", "--seq", "128", "--steps",
                           str(TRAIN_SYNTH_STEPS), "--ckpt-every", "50",
                           "--workdir", os.path.join(tmp, "synthetic")],
             TRAIN_SYNTH_STEPS, 8 * 128)]
        trainers = {}
        for label, args, steps, tokens in runs:
            summary, tr, launches = _train_run(label, args, tokens,
                                               _train_launches(cfg, steps))
            trainers[label] = tr
            for name, k in launches.items():
                total[name] += k
        shutil.copytree(trainers["synthetic"].ckpt.root, keep)
        for label in ("synthetic", "bundles"):
            tr = trainers[label]
            dts = sorted(h["dt"] for h in tr.history[1:])
            say("train_profile", run=label, profiled_steps=PROFILE_STEPS,
                **profile_steps(tr, 1e3 * statistics.median(dts)), **_card())
        first, last = _loss_fell("train on bundles",
                                 trainers["bundles"].history)
        resumed = trainers["bundles_resumed"].history
        if resumed[0]["step"] != TRAIN_BUNDLE_STEPS + 1 or len(resumed) != \
                TRAIN_RESUME_STEPS:
            raise RuntimeError(f"the rerun did not resume at step "
                               f"{TRAIN_BUNDLE_STEPS + 1}: {resumed[:1]}")
        # float32 compute: the Trainer launch.train builds, on the card
        # and on the CPU, from one seed over one synthetic stream
        cfg32 = cfg.replace(compute_dtype="float32")
        f32 = {}
        for dev in ("cuda", "cpu"):
            _zero_launches()
            tr = Trainer(cfg32, os.path.join(tmp, f"f32_{dev}"),
                         iter(SyntheticTokens(8, 128, cfg.vocab_size)),
                         ckpt_every=FP32_TRAIN_STEPS, device=dev)
            tr.train(FP32_TRAIN_STEPS)
            launches = _launches()
            want = (_train_launches(cfg, FP32_TRAIN_STEPS) if dev == "cuda"
                    else {name: 0 for name in KERNELS})
            dts = sorted(h["dt"] for h in tr.history[1:])
            say("train", run=f"float32_{dev}", steps=FP32_TRAIN_STEPS,
                expected_launches=want, kernel_launches=launches,
                step_ms_median=1e3 * statistics.median(dts), **_card())
            if launches != want:
                raise RuntimeError(f"float32 {dev}: kernel launches "
                                   f"{launches}, expected {want}")
            if dev == "cuda":
                for name, k in launches.items():
                    total[name] += k
            f32[dev] = np.array([h["loss"] for h in tr.history])
    got, want = f32["cuda"], f32["cpu"]
    rel = float(abs(got - want).max() / abs(want).max())
    say("train_parity", steps=FP32_TRAIN_STEPS, loss_rel=rel,
        rel_tol=FP32_TRAIN_REL, card_losses=got.tolist(),
        cpu_losses=want.tolist(), loss_fell_bundles=[first, last])
    if not rel < FP32_TRAIN_REL:
        raise RuntimeError(f"float32 training on the card and the CPU differ "
                           f"by rel {rel}")
    _free()
    return total


ENCDEC_BUNDLE_STEPS = 30      # whisper-tiny on the quickstart's bundles
ENCDEC_SYNTH_STEPS = 10       # ... and on synthetic tokens, batch 8 x 128
ENCDEC_F32_STEPS = 10         # float32 compute, card against the CPU port
ENCDEC_F32_BATCH = 1          # ... at batch 1 (a CPU step takes ~1.5 s)
VISION_LAYERS = 5             # llama-vision: one xattn and four attn layers
VISION_STEPS = 10


def _encdec_launches(cfg, steps):
    """Exact counts of a training run of an encoder arch under remat="full",
    from the config: a microbatch runs each encoder layer's non-causal
    flash forward once (the encoder runs outside remat, as the reference's
    unrematted scan does) and its backward once, and each attention of a
    decoder layer (dec: self and cross; attn and xattn: one) forward twice
    (once more in the recompute) and backward once."""
    if cfg.remat != "full" or cfg.prologue:
        raise RuntimeError(f"{cfg.arch_id}: remat {cfg.remat!r}, prologue "
                           f"{cfg.prologue}")
    n_mb = max(1, cfg.microbatch) * steps
    attn = sum({"dec": 2, "attn": 1, "xattn": 1}[spec.kind]
               for spec in cfg.plan)
    return {"flash_attention": n_mb * (cfg.n_enc_layers + 2 * attn),
            "flash_attention_bwd": n_mb * (cfg.n_enc_layers + attn),
            "wkv6_scan": 0, "ssd_scan": 0}


def _loss_fell(label, history):
    first = statistics.mean(h["loss"] for h in history[:10])
    last = statistics.mean(h["loss"] for h in history[-10:])
    if not last < first:
        raise RuntimeError(f"{label}: the loss did not fall ({first} -> "
                           f"{last})")
    return first, last


def phase_train_encdec(dev, data):
    """whisper-tiny at full width and depth through launch.train, with
    random bf16 frame embeddings in every batch: ENCDEC_BUNDLE_STEPS steps
    on the quickstart study's bundles (``data``, the archive), where the
    loss must fall, and ENCDEC_SYNTH_STEPS on synthetic tokens at batch 8 x
    seq 128 (uniform tokens: nothing to learn, so no fall is asked), both
    with exact launch counts, the synthetic run profiled; then
    ENCDEC_F32_STEPS float32-compute steps on the
    card against the CPU port from one seed and batch stream.  Returns the
    card runs' summed launch counts."""
    total = {name: 0 for name in KERNELS}
    cfg = registry.get_config("whisper-tiny")
    with tempfile.TemporaryDirectory() as tmp:
        root = _write_study(data, os.path.join(tmp, "study"))
        runs = [("whisper_bundles",
                 ["--data", root, "--steps", str(ENCDEC_BUNDLE_STEPS)],
                 ENCDEC_BUNDLE_STEPS, 8 * RECORD_SEQ),
                ("whisper_synthetic", ["--seq", "128", "--steps",
                                       str(ENCDEC_SYNTH_STEPS)],
                 ENCDEC_SYNTH_STEPS, 8 * 128)]
        trainers = {}
        for label, args, steps, tokens in runs:
            _, tr, launches = _train_run(
                label, ["--arch", "whisper-tiny", "--batch", "8",
                        "--ckpt-every", str(steps), "--workdir",
                        os.path.join(tmp, label)] + args,
                tokens, _encdec_launches(cfg, steps))
            trainers[label] = tr
            for name, k in launches.items():
                total[name] += k
        fell = _loss_fell("whisper-tiny on bundles",
                          trainers["whisper_bundles"].history)
        tr = trainers["whisper_synthetic"]
        dts = sorted(h["dt"] for h in tr.history[1:])
        say("train_profile", run="whisper_synthetic",
            profiled_steps=PROFILE_STEPS,
            **profile_steps(tr, 1e3 * statistics.median(dts)), **_card())
        cfg32 = cfg.replace(compute_dtype="float32",
                            microbatch=ENCDEC_F32_BATCH)
        extras = {"enc_embed": ((ENCDEC_F32_BATCH, cfg.enc_len, cfg.d_model),
                                "bfloat16")}
        f32 = {}
        for where in ("cuda", "cpu"):
            _zero_launches()
            tr = Trainer(cfg32, os.path.join(tmp, f"f32_{where}"),
                         launch_train.with_extras(SyntheticTokens(
                             ENCDEC_F32_BATCH, 128, cfg.vocab_size), extras),
                         ckpt_every=ENCDEC_F32_STEPS, device=where)
            tr.train(ENCDEC_F32_STEPS)
            launches = _launches()
            want = (_encdec_launches(cfg32, ENCDEC_F32_STEPS)
                    if where == "cuda" else {name: 0 for name in KERNELS})
            dts = sorted(h["dt"] for h in tr.history[1:])
            say("train", run=f"whisper_float32_{where}",
                steps=ENCDEC_F32_STEPS, batch=ENCDEC_F32_BATCH,
                expected_launches=want, kernel_launches=launches,
                step_ms_median=1e3 * statistics.median(dts), **_card())
            if launches != want:
                raise RuntimeError(f"whisper float32 {where}: kernel launches "
                                   f"{launches}, expected {want}")
            if where == "cuda":
                for name, k in launches.items():
                    total[name] += k
            f32[where] = np.array([h["loss"] for h in tr.history])
    got, want = f32["cuda"], f32["cpu"]
    rel = float(abs(got - want).max() / abs(want).max())
    say("train_parity", arch="whisper-tiny", steps=ENCDEC_F32_STEPS,
        loss_rel=rel, rel_tol=FP32_TRAIN_REL, card_losses=got.tolist(),
        cpu_losses=want.tolist(), loss_fell_bundles=list(fell))
    if not rel < FP32_TRAIN_REL:
        raise RuntimeError(f"whisper float32 training on the card and the "
                           f"CPU differ by rel {rel}")
    _free()
    return total


def phase_train_vision(dev):
    """llama-3.2-vision-11b at full width and VISION_LAYERS of its 40
    layers (every xgate 1.0, so its cross-attention reaches the loss),
    VISION_STEPS steps through make_train_step with exact counts, its peak
    memory (~60 GB) and a profiled reading.  It runs before the Merlin
    phases, whose executors keep their CUDA graphs' memory pools for the
    rest of the process.  Returns the launch counts."""
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.trainstep import init_state, make_train_step
    full = registry.get_config("llama-3.2-vision-11b")
    cfg = full.replace(n_repeat=1, n_layers=len(full.superblock))
    if cfg.n_layers != VISION_LAYERS:
        raise RuntimeError(f"llama-vision cut to {cfg.n_layers} layers")
    opt = make_optimizer(cfg.optimizer, lr=3e-4)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, opt)
    with torch.no_grad():
        for layer, spec in zip(state.params.layers, cfg.plan):
            if spec.kind == "xattn":
                layer.xgate.fill_(1.0)
    n_params = sum(p.numel() for p in state.params.parameters())
    step = make_train_step(cfg, opt)
    data = launch_train.with_extras(
        SyntheticTokens(8, 128, cfg.vocab_size),
        {"img_embed": ((8, cfg.n_img_tokens, cfg.d_vision), "bfloat16")})
    _zero_launches()
    losses, dts = [], []
    for _ in range(VISION_STEPS):
        batch = next(data)
        t0 = time.monotonic()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        dts.append(time.monotonic() - t0)
    launches = _launches()
    want = _encdec_launches(cfg, VISION_STEPS)
    med = statistics.median(sorted(dts[1:]))
    say("train", run="llama_vision_5_layers", arch=cfg.arch_id,
        layers=cfg.n_layers, params=n_params, steps=VISION_STEPS,
        expected_launches=want, kernel_launches=launches, losses=losses,
        step_ms_median=1e3 * med, tokens_per_s_at_median=8 * 128 / med,
        max_memory_allocated=torch.cuda.max_memory_allocated(), **_card())
    if launches != want:
        raise RuntimeError(f"llama-vision: kernel launches {launches}, "
                           f"expected {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"llama-vision: non-finite loss {losses}")
    batches = [next(data) for _ in range(3)]
    say("train_profile", run="llama_vision_5_layers", profiled_steps=2,
        **profile_run(step, state, batches, 1e3 * med), **_card())
    del state, step, batches
    _free()
    return launches


MESH_LOSS_REL = 1e-5          # the (1, 1) mesh step against the plain one
MESH_JAG_REL = 1e-3           # JAG's split bundles against one program


def exact_sim(u, draws):
    """An IEEE-exact simulator (add/mul/div/sqrt and the rows' uniform
    draws): the split must give the single-device bundles bit for bit."""
    s = u * 2.0 + 0.25
    return {"v": s / (1.0 + u) + draws["noise"] * 0.001,
            "w": torch.sqrt(s), "s": (u * u).sum(-1)}


exact_sim.draws_fn = lambda seeds, device=None: {
    "noise": sim_rng.uniform(seeds, 0, 5)}


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_mesh(dev, ckpt_root):
    """The sharded path on a one-rank NCCL group and a (1, 1) ("data",
    "model") DeviceMesh: the train phase's jag-surrogate checkpoint
    restored through restore(..., shardings=param_spec_tree(...)) with
    its optimizer state, two steps under the mesh against the same steps
    unsharded (losses within MESH_LOSS_REL, the first step's flash
    launches exact, on the DTensors' local shards, the second timed
    warm); int8_psum on one rank against quantize-dequantize; an
    EnsembleExecutor over the device tuple (cuda:0, cuda:0) against one
    device (the exact simulator bit for bit, JAG within MESH_JAG_REL, the
    mesh used); device_mesh() None on one card.  The group is destroyed at
    the end, whatever the result.  Returns the launch counts."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.parallel.collectives import int8_psum
    from repro_torch.parallel.sharding import param_spec_tree
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.trainer import state_tree
    from repro_torch.train.trainstep import (init_state, make_train_step,
                                             named_params, opt_shardings,
                                             place_params)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = registry.get_config("jag-surrogate")
        opt = make_optimizer(cfg.optimizer, lr=3e-4)
        ckpt = CheckpointManager(ckpt_root)
        latest = ckpt.latest_step()
        batch = SyntheticTokens(8, 128, cfg.vocab_size).batch_at(latest)
        runs = {}
        for label in ("unsharded", "mesh"):
            state = init_state(torch.Generator().manual_seed(1), cfg, opt,
                               dev)
            shardings = None
            if label == "mesh":
                named = named_params(state.params)
                specs = param_spec_tree(named, mesh)
                shardings = (specs, opt_shardings(state.opt, named, specs),
                             None)
            params, opt_state, step = ckpt.restore(latest, state_tree(state),
                                                   shardings)
            place_params(state.params, params)
            state = state._replace(opt=opt_state, step=step)
            if label == "mesh" and not all(
                    isinstance(p, DTensor)
                    for p in named_params(state.params).values()):
                raise RuntimeError("the restored parameters are not DTensors")
            step_fn = make_train_step(cfg, opt, mesh=mesh if label == "mesh"
                                      else None)
            _zero_launches()
            t0 = time.monotonic()
            state, m = step_fn(state, batch)
            loss = float(m["loss"])
            runs[label] = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                           "step_ms": 1e3 * (time.monotonic() - t0),
                           "launches": _launches()}
            # a second, warm step from the placed optimizer state: its
            # wall time apart from the first step's cold start
            t0 = time.monotonic()
            _, m = step_fn(state, SyntheticTokens(
                8, 128, cfg.vocab_size).batch_at(latest + 1))
            runs[label]["loss_2"] = float(m["loss"])
            runs[label]["warm_step_ms"] = 1e3 * (time.monotonic() - t0)
        want = _train_launches(cfg, 1)
        rel = max(abs(runs["mesh"][k] - runs["unsharded"][k])
                  / abs(runs["unsharded"][k]) for k in ("loss", "loss_2"))
        ok = (rel < MESH_LOSS_REL and runs["mesh"]["launches"] == want
              and runs["unsharded"]["launches"] == want)
        say("mesh", check="train_step", restored_step=latest,
            mesh_shape={"data": 1, "model": 1}, expected_launches=want,
            **runs,
            loss_rel=rel, rel_tol=MESH_LOSS_REL, ok=ok)
        if not ok:
            raise RuntimeError(f"mesh step: {runs}, rel {rel}")
        launches = runs["mesh"]["launches"]
        x = torch.randn(64, 16, generator=torch.Generator(device=dev)
                        .manual_seed(3), device=dev)
        got = int8_psum(x)
        scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
        qdq = torch.clamp(torch.round(x / scale), -127, 127) * scale
        psum_equal = bool(torch.equal(got, qdq))
        say("mesh", check="int8_psum", equal=psum_equal)
        if not psum_equal:
            raise RuntimeError("int8_psum on one rank is not "
                               "quantize-dequantize")
    finally:
        dist.destroy_process_group()
    sizes = [32, 32, 16, 5]
    blocks = [np.random.default_rng(5).random((n, 5)).astype(np.float32)
              for n in sizes]
    for sim, exact in ((exact_sim, True), (jag_simulate, False)):
        outs = {}
        for label, mesh_arg in (("single", None), ("split", (dev, dev))):
            ex = ens.EnsembleExecutor(sim, mesh=mesh_arg, device=dev,
                                      share_cache=False)
            lo, outs[label] = 0, []
            for blk in blocks:
                outs[label].append(ex.run_bundle(lo, lo + len(blk), blk))
                lo += len(blk)
            outs[f"{label}_stats"] = dict(ex.stats)
        equal = all(np.array_equal(a[k], b[k], equal_nan=True)
                    for a, b in zip(outs["single"], outs["split"]) for k in a)
        rel = max(_row_rel(b[k], a[k]) for a, b in zip(outs["single"],
                                                        outs["split"])
                  for k in a)
        ml = outs["split_stats"]["mesh_launches"]
        ok = ((equal if exact else rel <= MESH_JAG_REL) and ml >= 1
              and outs["split_stats"]["devices"] == 2
              and outs["single_stats"]["mesh_launches"] == 0)
        say("mesh", check="ensemble", simulator=sim.__name__, sizes=sizes,
            bit_equal=equal, max_row_rel=rel, mesh_launches=ml,
            devices=outs["split_stats"]["devices"], ok=ok)
        if not ok:
            raise RuntimeError(f"ensemble split over (cuda:0, cuda:0) "
                               f"disagrees: {sim.__name__}, equal {equal}, "
                               f"rel {rel}, mesh launches {ml}")
    if ens.device_mesh() is not None:
        raise RuntimeError(f"device_mesh() on one card: {ens.device_mesh()}")
    say("mesh", check="device_mesh", device_mesh=None,
        device_count=torch.cuda.device_count())
    _free()
    return launches


SOURCES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:26",
    # no TPU kernel: the gradient the reference takes with jax.grad of
    "flash_attention_bwd": "src/repro/kernels/ref.py:55",
    "wkv6_scan": "src/repro/kernels/wkv6_scan.py:18",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:21",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 2
    dev = env.device("cuda")
    snap = phase_env()
    phase_build()
    phase_sass()
    errs, timing = {}, {}
    errs["flash_attention"], t = phase_flash(dev)
    timing["flash_attention"] = t["jag_prefill_512"]
    main_shapes = {"flash_attention": MAIN_PATH}
    errs["flash_attention_bwd"], t = phase_flash_backward(dev)
    timing["flash_attention_bwd"] = t["jag_train_128"]
    main_shapes["flash_attention_bwd"] = BWD_MAIN
    for name, mod, plain, shapes, main_, make, work in (
            ("wkv6_scan", wkvk, {"sigmoid": ref.wkv6_chunked_ref,
                                 "strong": ref.wkv6_chunked_ref},
             WKV_SHAPES, WKV_MAIN, wkv_inputs, wkv_work),
            ("ssd_scan", ssdk, {"normal": ref.ssd_chunked_ref,
                                "strong": ref.ssd_scan_ref},
             SSD_SHAPES, SSD_MAIN, ssd_inputs, ssd_work)):
        errs[name], t = phase_scan(dev, name, mod, plain, shapes, main_, make,
                                   work)
        timing[name] = t[main_[0]]
        main_shapes[name] = main_
    _free()
    launches = {name: 0 for name in KERNELS}
    for arch in SERVE:  # each model's counts are read around its own run
        for name, n in phase_serve(dev, arch).items():
            launches[name] += n
    for name, n in phase_train_vision(dev).items():
        launches[name] += n
    phase_merlin(dev)
    data = phase_merlin_net(dev)
    phase_gateway(dev, data)
    phase_cascade(dev)
    phase_icf(dev)
    phase_optimization_loop(dev)
    with tempfile.TemporaryDirectory() as keep:
        ckpt = os.path.join(keep, "jag_ckpt")
        for name, n in phase_train(data, ckpt).items():
            launches[name] += n
        for name, n in phase_train_encdec(dev, data).items():
            launches[name] += n
        for name, n in phase_mesh(dev, ckpt).items():
            launches[name] += n
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": SOURCES[name],
        "launches": launches[name],
        "max_abs_err": max(errs[name][n] for n in main_shapes[name]),
        **{key: timing[name][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name in KERNELS]}), flush=True)
    print(snap["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
