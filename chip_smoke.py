#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. environment: versions, the card's name and power limit;
  2. build: every CUDA source under src/repro_torch/kernels/csrc with nvcc
     for sm_90a, into build/ (flash_attention, flash_attention_bwd,
     wkv6_scan, ssd_scan, wkv6_scan_bwd, ssd_scan_bwd, decode_attention),
     where the D-192
     flash forward instances must report 0 spill bytes (the D-192 backward
     and the scans' backward kernels are reported); then the tensor-core
     instructions of each kernel function (cuobjdump -sass), which every
     bf16 instance of the flash forward (D 16-192), the flash backward's
     tensor-core grid (D 16-192), WKV6 and SSD, and the scans' bf16
     backward kernels (chunk summaries and chunk / sub-tile gradients) must
     have, 55 in all (the fp32 kernels, the backward's D_i pass, the scans'
     chunk scan and sum kernels report 0);
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
     is scaled_dot_product_attention's backward; D 192 (deepseek's MLA) at
     a training microbatch of the bundles and at 8 x 128.  The scans'
     backward kernels are held to ref.wkv6_scan_bwd_ref /
     ref.ssd_scan_bwd_ref at WKV_BWD_SHAPES / SSD_BWD_SHAPES (the training
     shapes, 4096-step rows, ragged S, every bf16 head size: WKV6's D
     16 / 32 / 64 and SSD's twelve P x N pairs, SSD's one-group path,
     float32, WKV6 decays at the clip), in bf16 also to the mirrors of their rounding
     points (ref.*_scan_bwd_tc_ref); two calls must give bitwise-equal
     gradients and the autograd Functions the direct calls'; timed against
     their bound (bytes, or the products at the bf16 peak; no one PyTorch
     call computes them).  The decode attention kernel is held to
     ref.decode_attention_ref at DECODE_SHAPES (the benchmark's decode cell,
     128 rows over a 4096-position cache at D 128; the served archs' decode
     shapes; one row through the split path; float32, float32 compute over
     a bf16 cache, D 32, a window, 20 query heads a KV head, kv_len 1) at
     DECODE_REL, and timed at DECODE_MAIN beside its plain version, the
     bound (the attended cache read once) and scaled_dot_product_attention
     over the attended positions as the yardstick (none with a softcap);
  4. serve: jag-surrogate, rwkv6-3b, zamba2-1.2b, phi4-mini-3.8b,
     whisper-tiny and llama-3.2-vision-11b at full width and full depth,
     deepseek-v2-lite-16b at full width and 14 of its 27 layers (the dense
     prologue and 13 MoE layers), starcoder2-15b at full width and 20 of
     its 40, gemma2-27b at full width and 8 of its 46 layers, through
     ServeEngine (random weights from
     seed 0; batch 4, prompts of 32, 200 and 512 tokens, 32 new tokens
     each; gemma2: batch 1, one prompt of 6144 tokens, past its 4096
     window; whisper: prompts of 32, 200 and 400, inside its 448-token
     context).  whisper and llama-vision get random bf16 frame / patch
     embeddings from seed 1 in every call, and llama-vision's xgates are
     set to 1.0, so its cross-attention reaches the logits.  Every launch
     count is set to 0 just before each model's run and read just after;
     the counts must be exact, prefill and decode (jag 12 flash; rwkv6-3b
     96 WKV; zamba2 99 SSD and 15 flash; phi4 96, gemma2 8 and deepseek 42
     flash, and 42 more for deepseek's run with int8 latent caches;
     whisper 3 x (12 + 31 x 4) = 408 and llama-vision 3 x (40 + 31 x 8) =
     864, its cross-attention running at every decode step; starcoder2
     60; and the decode attention kernel once a self-attention layer and
     decode step: 3 x 31 x 4 for jag and whisper, x 5 for zamba2, x 32
     for phi4 and llama-vision, x 8 for gemma2, x 20 for starcoder2, none
     for rwkv6 and deepseek), and the first-token and first decode-step
     logits are held
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
 10b. train_scan_archs (right after the dryrun phase, on the quickstart
     study's bundles drawn on the CPU): zamba2-1.2b at full width and
     depth, rwkv6-3b at full width and 16 of 32 layers, deepseek-v2-lite-16b
     at its dense prologue and 2 MoE layers, SCAN_TRAIN_STEPS steps each
     through ``python -m repro_torch.launch.train`` (no checkpoint):
     launch counts exact (each layer's kernel forward twice a microbatch,
     once in a prologue layer, its backward kernel once: WKV6, SSD, the
     flash kernels at D 64 and 192), the loss falls, step wall, peak
     memory and a profiled busy time (one step, warm from the run); then
     one float32 step's forward and backward on the card equal to the
     CPU's at rel 1e-4 (the loss and every parameter's gradient, leaf by
     leaf; full width, the depth cut; deepseek at the card's routes);
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
     embeddings in every batch, 8 microbatches a step): 20 steps on the
     quickstart's bundles, where the loss must fall, and 10 synthetic
     steps at batch 8 x seq 128 (uniform tokens, nothing to learn); 5
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
 14. dryrun (run right after llama-vision's training, before the Merlin
     phases' graph pools): a one-rank NCCL group and a (1, 1) host mesh
     (launch/mesh.make_host_mesh).  The meta-device dry run
     (launch/dryrun.lower_cell + analyze) of llama-3.2-vision-11b at full
     width and 5 layers, one train step of 8 x 128, against the card: the
     placed state and batch hold the predicted argument bytes within the
     allocator's 512-byte rounding a tensor, the step's peak is no more
     than argument + saved bytes + the stated margin (the dry run's live
     peak beyond the saved bytes x 1.10, 5 % of the saved bytes, 256 MiB),
     and the dry run's LocalCounter counts the same FLOPs on the card's
     step as on meta, exactly.  Then make_prefill_fn / make_decode_fn
     under the mesh serve jag-surrogate and whisper-tiny at full width
     (batch 4, 32-token prompts, 8 tokens; whisper's cross-attention at
     S = 1 through the flash kernel), their logits bit-equal to
     ServeEngine(mesh=...).generate's and their flash and decode
     attention launches exact; and
     a `mesh` line: deepseek-v2-lite-16b at full width, its dense prologue
     layer and one MoE layer, evaluates under the mesh (the D-192 flash
     forward on the local shards, 2 launches) to the unsharded loss and
     aux losses within rel 1e-4.
The last line is {"ok": true, "device": {...}}.  Without a card, or without
the rest of the repository beside it, the script exits non-zero before it.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import math
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
from repro_torch.kernels import decode_attention as dak  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import flops as kflops  # noqa: E402
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
# kernel -> (module, its launch counter); each backward is built from
# csrc/<name>.cu and counted by its forward's wrapper
KERNELS = {"flash_attention": (fak, "launches"),
           "flash_attention_bwd": (fak, "bwd_launches"),
           "wkv6_scan": (wkvk, "launches"), "ssd_scan": (ssdk, "launches"),
           "wkv6_scan_bwd": (wkvk, "bwd_launches"),
           "ssd_scan_bwd": (ssdk, "bwd_launches"),
           "decode_attention": (dak, "launches")}
# the serve lines' names of the counts
COUNT_KEYS = {"flash_attention": "flash_launches",
              "flash_attention_bwd": "flash_bwd_launches",
              "wkv6_scan": "wkv6_launches", "ssd_scan": "ssd_launches",
              "wkv6_scan_bwd": "wkv6_bwd_launches",
              "ssd_scan_bwd": "ssd_bwd_launches",
              "decode_attention": "decode_attention_launches"}

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
# The scans' backward kernels, held to ref.wkv6_scan_bwd_ref /
# ref.ssd_scan_bwd_ref (chunk 16) at SCAN_REL, in bf16 also to the mirrors
# ref.*_scan_bwd_tc_ref: (name, B, S, H, D, decay, dtype) and (name, B, S,
# H, P, N, decay, dtype).  A train phase's microbatch is one row of the
# quickstart's bundles (8 tokens: the main path, first), then a 128-token
# microbatch of 8 rows, one row of the reference's train_4k length (4096
# steps: 64 chunks), ragged S, WKV6 decays at the clip, every bf16 head size
# (WKV6 D 16 / 32 / 64; SSD P 16 / 32 / 64 with each N of 16 / 32 / 64 /
# 128, the kernel's twelve instances) within a 16-step sub-tile and over
# several chunks, SSD's one group of all heads (4 heads a block: dB and dC
# written whole, no partial rows), and float32 (PR 23's kernel) past its
# 64-step chunks at every head size.
WKV_BWD_SHAPES = [
    ("rwkv6_train_bundles", 1, 8, 40, 64, "sigmoid", BF16),
    ("rwkv6_train_128", 8, 128, 40, 64, "sigmoid", BF16),
    ("rwkv6_train_4096", 1, 4096, 40, 64, "sigmoid", BF16),
    ("rwkv6_train_128_clip", 8, 128, 40, 64, "strong", BF16),
    ("bf16_ragged_77_clip", 2, 77, 40, 64, "strong", BF16),
    ("bf16_D32_S17_clip", 2, 17, 4, 32, "strong", BF16),
    ("bf16_D16_ragged_150", 1, 150, 2, 16, "sigmoid", BF16),
    ("f32_D64", 2, 64, 4, 64, "sigmoid", F32),
    ("f32_D32_ragged_clip", 1, 137, 3, 32, "strong", F32),
    ("f32_D16", 1, 150, 2, 16, "sigmoid", F32),
]
WKV_BWD_TIMED = ("rwkv6_train_bundles", "rwkv6_train_128", "rwkv6_train_4096")
SSD_BWD_SHAPES = [
    ("zamba2_train_bundles", 1, 8, 64, 64, 64, "normal", BF16),
    ("zamba2_train_128", 8, 128, 64, 64, 64, "normal", BF16),
    ("zamba2_train_4096", 1, 4096, 64, 64, 64, "normal", BF16),
    ("bf16_ragged_77", 2, 77, 64, 64, 64, "normal", BF16),
    ("bf16_strong_128", 2, 128, 64, 64, 64, "strong", BF16),
    ("bf16_P16_N16_S8", 2, 8, 4, 16, 16, "normal", BF16),
    ("bf16_P32_N128_ragged", 1, 137, 3, 32, 128, "normal", BF16),
    ("bf16_P16_N32_ragged", 2, 137, 3, 16, 32, "normal", BF16),
    ("bf16_P16_N64_ragged", 1, 137, 3, 16, 64, "normal", BF16),
    ("bf16_P16_N128_strong", 1, 137, 2, 16, 128, "strong", BF16),
    ("bf16_P32_N16_ragged", 2, 137, 3, 32, 16, "normal", BF16),
    ("bf16_P32_N32_ragged", 1, 137, 3, 32, 32, "normal", BF16),
    ("bf16_P32_N64_one_group", 4, 2112, 4, 32, 64, "normal", BF16),
    ("bf16_P64_N16_ragged", 1, 137, 3, 64, 16, "normal", BF16),
    ("bf16_P64_N32_ragged", 2, 137, 2, 64, 32, "normal", BF16),
    ("bf16_P64_N128_ragged", 1, 137, 3, 64, 128, "normal", BF16),
    ("f32_P64", 2, 64, 4, 64, 64, "normal", F32),
    ("f32_P32_N128_ragged", 1, 137, 3, 32, 128, "normal", F32),
    ("f32_P16_N16", 1, 150, 2, 16, 16, "normal", F32),
]
SSD_BWD_TIMED = ("zamba2_train_bundles", "zamba2_train_128",
                 "zamba2_train_4096")
# Decode attention (csrc/decode_attention.cu) against ref.decode_attention_ref:
# (name, B, H, KV, D, T, kv_len, window, softcap, q dtype, cache dtype).
# The benchmark's decode cell (zamba2-1.2b at head size 128, 128 rows over
# a full 4096-position cache), then the served archs' self-attention decode
# at the serve phase's shapes (batch 4, a 552-position cache; gemma2 batch
# 1 past its 4096 window, softcap 50), then the edges: the split path at
# one row, float32, float32 compute over a bf16 cache, a group wider than
# 16 query heads, ragged tiles, kv_len 1, a window.  Held at
# max |kernel - plain| / max |plain| below DECODE_REL: float32 sums in
# another order, and a bf16 output rounded once from them.
DECODE_SHAPES = [
    ("zamba2_decode_b128", 128, 32, 32, 128, 4096, 4096, None, None, BF16,
     BF16),
    ("zamba2_decode_b1", 1, 32, 32, 128, 4096, 4096, None, None, BF16, BF16),
    ("jag_decode", 4, 4, 4, 64, 552, 540, None, None, BF16, BF16),
    ("zamba2_registry_decode", 4, 32, 32, 64, 552, 540, None, None, BF16,
     BF16),
    ("phi4_decode", 4, 24, 8, 128, 552, 540, None, None, BF16, BF16),
    ("gemma2_local_decode", 1, 32, 16, 128, 4096, 4096, None, 50.0, BF16,
     BF16),
    ("gemma2_global_decode", 1, 32, 16, 128, 6184, 6150, None, 50.0, BF16,
     BF16),
    ("starcoder2_decode", 4, 48, 4, 128, 552, 540, None, None, BF16, BF16),
    ("llama_vision_self_decode", 4, 32, 8, 128, 552, 540, None, None, BF16,
     BF16),
    ("arctic_decode", 4, 56, 8, 128, 552, 540, None, None, BF16, BF16),
    ("whisper_self_decode", 4, 6, 6, 64, 440, 420, None, None, BF16, BF16),
    ("f32_D32_window_softcap", 2, 8, 2, 32, 300, 250, 64, 30.0, F32, F32),
    ("f32_q_bf16_cache", 4, 8, 8, 64, 200, 150, None, None, F32, BF16),
    ("f32_D128_split", 1, 16, 4, 128, 3000, 2999, None, None, F32, F32),
    ("bf16_D32_ragged", 3, 4, 4, 32, 77, 77, None, None, BF16, BF16),
    ("bf16_g20_two_groups", 2, 40, 2, 64, 300, 290, None, None, BF16, BF16),
    ("bf16_kv_len_1", 2, 4, 2, 64, 128, 1, None, None, BF16, BF16),
    ("bf16_window_1", 1, 8, 8, 128, 2048, 2000, 1, None, BF16, BF16),
]
DECODE_MAIN = ("zamba2_decode_b128", "zamba2_decode_b1", "jag_decode",
               "zamba2_registry_decode", "phi4_decode", "gemma2_local_decode",
               "gemma2_global_decode", "starcoder2_decode",
               "llama_vision_self_decode", "arctic_decode",
               "whisper_self_decode")
DECODE_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# float32-compute serve run against its plain run: rounding only
FP32_SERVE_REL = 1e-3


def _serve(counts, batch=4, prompts=(32, 200, 512), new_tokens=32,
           n_repeat=None, decode_counts=None):
    """One model's serve run: ``counts(cfg)`` is the launches each prefill
    must make, per kernel, and ``decode_counts(cfg)`` those of each decode
    step beyond the decode attention kernel's, which every self-attention
    layer launches once a step; ``n_repeat`` cuts the depth (None:
    full)."""
    more = decode_counts or (lambda cfg: {})
    return {"counts": counts, "batch": batch, "prompts": prompts,
            "new_tokens": new_tokens, "n_repeat": n_repeat,
            "decode_counts": lambda cfg: {
                "decode_attention": _self_attn_layers(cfg), **more(cfg)}}


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
    # full width; MLA + MoE.  The dense prologue and 13 of the 26 MoE
    # layers (~31 GB of float32 weights; full depth, ~62 GB, served in
    # 54-64 s, past this script's time): every layer kind still runs
    "deepseek-v2-lite-16b": _serve(lambda cfg: {
        "flash_attention": _count(cfg, "mla")}, n_repeat=13),
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
    # full width; 20 of its 40 layers (~32 GB of float32 weights; full
    # depth, ~64 GB, served in 22-27 s, past this script's time)
    "starcoder2-15b": _serve(lambda cfg: {
        "flash_attention": _count(cfg, "attn")}, n_repeat=20),
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
    # the D-192 flash forward instances (MLA's prefill) must not spill; the
    # backward's D-192 instances and the scans' backward kernels are
    # reported.  ptxas prints an entry's spills on the line after its name
    spills = _spills("flash_attention", r"flash_fwd_\w+ILi192E")
    say("build", seconds=round(secs, 3), libraries=sorted(libs),
        built_now=sorted(_build.logs), d192_spill_bytes=spills,
        d192_bwd_spill_bytes=_spills("flash_attention_bwd",
                                     r"flash_bwd_\w+ILi192E"),
        scan_bwd_spill_bytes={
            **_spills("wkv6_scan_bwd", r"wkv\w*_kernel"),
            **_spills("ssd_scan_bwd", r"ssd_\w*_kernel")})
    missing = sorted(set(KERNELS) - set(libs))
    if missing:
        raise RuntimeError(f"libraries missing after build: {missing}")
    if "flash_attention" in _build.logs and (
            len(spills) != 2 or any(any(v) for v in spills.values())):
        raise RuntimeError(f"the D-192 flash forward instances spill (or "
                           f"were not reported): {spills}")


def _spills(lib, pattern):
    """{entry: [spill store bytes, spill load bytes]} of the entries of
    ``lib`` (this run's build log) whose name matches ``pattern``."""
    spills, entry = {}, None
    for line in _build.logs.get(lib, "").splitlines():
        found = re.search(r"entry function '(\S*" + pattern + r"\S*)'", line)
        if found:
            entry = found.group(1)
        elif entry and "spill" in line:
            spills[entry] = [int(n) for n in re.findall(
                r"(\d+) bytes spill", line)]
            entry = None
    return spills


def phase_sass():
    """Tensor-core instructions (HMMA, HGMMA) per kernel function of each
    built library, read from ``cuobjdump -sass``.  Every bf16 instance of
    the flash forward and backward, WKV6 and SSD, and of the scans' bf16
    backward kernels must have some: their products run on the tensor
    cores (5 flash forward and 5 flash backward head dims, 3 WKV head dims,
    3 x 4 SSD P and N; the backward's chunk summaries and chunk / sub-tile
    gradients: 2 x 3 WKV6, 2 x 12 SSD)."""
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
            or "ssd_tc_kernel" in fn
            or re.search(r"wkv_su[mb]_kernel|ssd_(sum|chunk)_kernel", fn)]
    if len(bf16) != 55 or not all(counts[fn] for fn in bf16):
        raise RuntimeError(f"bf16 flash forward / flash backward / WKV6 / "
                           f"SSD / scan backward instances without "
                           f"tensor-core instructions (or not 55 of them): "
                           f"{counts}")


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


def decode_inputs(gen, dev, B, H, KV, D, T, qdt, cdt):
    """q at twice the cache's scale, so the softmax is peaked as well as
    flat across rows."""
    q = 2.0 * torch.randn(B, 1, H, D, generator=gen, device=dev)
    ck, cv = (torch.randn(B, T, KV, D, generator=gen, device=dev).to(cdt)
              for _ in range(2))
    return q.to(qdt), ck, cv


def decode_work(q, ck, kv_len, window):
    """Bytes (q read and the output written in q's dtype, K and V over the
    attended positions in the cache's, each once) and the two products
    over them."""
    B, _, H, D = q.shape
    lo, hi = dak.attended(kv_len, window)
    nbytes = 2 * q.numel() * q.element_size() \
        + 2 * B * (hi - lo) * ck.shape[2] * D * ck.element_size()
    return _bound(nbytes, 4 * B * H * (hi - lo) * D)


def phase_decode_attention(dev):
    """The decode attention kernel against ref.decode_attention_ref at
    DECODE_SHAPES (the split path's launches counted), timed at
    DECODE_MAIN beside the plain version, the bound and, where no softcap
    or window applies, scaled_dot_product_attention over the attended
    positions as the yardstick (the port never calls it)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, timing = {}, {}
    for (name, B, H, KV, D, T, kv_len, window, softcap, qdt,
         cdt) in DECODE_SHAPES:
        q, ck, cv = decode_inputs(gen, dev, B, H, KV, D, T, qdt, cdt)
        kw = dict(kv_len=kv_len, window=window, softcap_val=softcap)
        lo, hi = dak.attended(kv_len, window)
        splits0 = dak.split_launches
        got = dak.decode_attention(q, ck, cv, **kw)
        torch.cuda.synchronize()
        split = dak.split_launches - splits0
        want = ref.decode_attention_ref(q, ck, cv, **kw)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        ok = bool(torch.isfinite(got.float()).all() and rel < DECODE_REL[qdt]
                  and got.dtype == qdt
                  and split == (dak.num_splits(B, KV, hi - lo) > 1))
        errs[name] = err
        say("kernel_vs_plain", kernel="decode_attention", shape=name, B=B,
            H=H, KV=KV, D=D, T=T, kv_len=kv_len, window=window,
            softcap=softcap, q_dtype=str(qdt).split(".")[-1],
            cache_dtype=str(cdt).split(".")[-1],
            splits=dak.num_splits(B, KV, hi - lo), max_abs_err=err,
            rel_err=rel, rel_tol=DECODE_REL[qdt], ok=ok)
        if not ok:
            raise RuntimeError(f"decode_attention disagrees with its plain "
                               f"version at {name}: rel err {rel}, split "
                               f"launches {split}")
        if name not in DECODE_MAIN:
            continue
        big = B * T * KV * D > 2 ** 28  # the plain version's copies take ms
        rounds, reps = (3, 5) if big else (7, 20)
        library = softcap is None and window is None
        kt, vt = (x[:, :kv_len].transpose(1, 2) for x in (ck, cv))
        t = timing[name] = {
            "ms": device_ms(lambda: dak.decode_attention(q, ck, cv, **kw)),
            "plain_ms": device_ms(
                lambda: ref.decode_attention_ref(q, ck, cv, **kw),
                rounds, reps),
            "library_ms": device_ms(lambda: _sdpa(
                q.transpose(1, 2), kt, vt, False, 1.0 / D ** 0.5))
            if library else None,
            **decode_work(q, ck, kv_len, window)}
        t["kernel_over_bound"] = t["ms"] / t["bound_ms"]
        say("kernel_time", kernel="decode_attention", shape=name,
            measured_on=torch.cuda.get_device_name(0),
            nvidia_smi=env.nvidia_smi_line(), kernel_ms=t["ms"],
            **{key: val for key, val in t.items() if key != "ms"})
        del q, ck, cv, kt, vt, got, want
        _free()
    return errs, timing


def _count(cfg, kind):
    return sum(spec.kind == kind for spec in cfg.plan)


def _self_attn_layers(cfg):
    """Layers whose decode step attends a self-attention cache (one decode
    attention launch each)."""
    return sum(spec.kind in ("attn", "shared_attn", "dec")
               for spec in cfg.plan)


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


def wkv_bwd_work(r, k, v, w, u, dy):
    """Bytes (r, k, v, dy read and dr, dk, dv written in r's dtype; w, u
    read and dw, du written in float32; each once) and the backward's
    state products (kernels/flops.scan_flops: 6 D x D a token and head)
    at the tensor cores' bf16 peak, as for every kernel: the bf16 kernel
    runs them on mma.sync (the float32 kernel, PR 23's, on the CUDA cores
    is held to the same bound)."""
    nbytes = 7 * r.numel() * r.element_size() + 2 * (w.numel() + u.numel()) * 4
    return _bound(nbytes, kflops.scan_flops(r, r.shape[-1], backward=True))


def ssd_bwd_work(x, dt, A, Bm, Cm, dy):
    """Bytes (x, dy read and dx written in x's dtype; B, C read and dB, dC
    written; dt, A read and ddt, dA written in float32; each once) and the
    backward's state products (6 P x N a token and head) at the bf16
    peak, as ``wkv_bwd_work``."""
    nbytes = 3 * x.numel() * x.element_size() \
        + 4 * Bm.numel() * Bm.element_size() + 2 * (dt.numel() + A.numel()) * 4
    return _bound(nbytes, kflops.scan_flops(x, Bm.shape[-1], backward=True))


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


def phase_scan_backward(dev, name, fwd, bwd, plain, mirror, shapes, timed,
                        make, work):
    """One scan's backward kernel (``bwd``) against its plain version at
    every shape, on an output gradient drawn in the inputs' dtype, in bf16
    also against the mirror of its rounding points (``mirror``); a second
    call gives bitwise-equal gradients, and the autograd Function (``fwd``
    under grad, then ``backward``) the same gradients as the direct call.
    Timed at ``timed`` beside the plain version and the bound; no one
    PyTorch call computes it (library None)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    errs, timing = {}, {}
    for shape, *dims, dt in shapes:
        args = make(gen, dev, *dims, dt)
        dy = torch.randn(args[0].shape, generator=gen, device=dev).to(dt)
        got = bwd(*args, dy)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, bwd(*args, dy)))
        want = plain(*args, dy, chunk=16)
        rels = [_rel(a, b) for a, b in zip(got, want)]
        mirror_rels = None if dt == F32 else [
            _rel(a, b) for a, b in zip(got, mirror(*args, dy))]
        xs = [a.detach().clone().requires_grad_() for a in args]
        fwd(*xs).backward(dy)
        same = all(torch.equal(x.grad, g) for x, g in zip(xs, got))
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        ok = bool(all(torch.isfinite(g.float()).all() for g in got)
                  and max(rels + (mirror_rels or [])) < SCAN_REL[dt]
                  and same and bitwise)
        errs[shape] = err
        say("kernel_vs_plain", kernel=name, shape=shape, dims=dims,
            dtype=str(dt).split(".")[-1], max_abs_err=err, rel_err=rels,
            tc_mirror_rel_err=mirror_rels, rel_tol=SCAN_REL[dt],
            bitwise_equal_calls=bitwise, autograd_equals_direct=same, ok=ok)
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version at "
                               f"{shape}: rel errs {rels}, mirror "
                               f"{mirror_rels}, autograd equal {same}, two "
                               f"calls equal {bitwise}")
        if shape in timed:
            t = timing[shape] = {
                "ms": device_ms(lambda: bwd(*args, dy)),
                "plain_ms": device_ms(lambda: plain(*args, dy, chunk=16),
                                      rounds=3, reps=3),
                "library_ms": None,  # no one PyTorch call computes it
                **work(*args, dy)}
            t["kernel_over_bound"] = t["ms"] / t["bound_ms"]
            say("kernel_time", kernel=name, shape=shape, kernel_ms=t["ms"],
                **{key: val for key, val in t.items() if key != "ms"},
                **_card())
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

    def route(p, xf, cfg, *rest):
        ids, gates, aux = orig(p, xf, cfg, *rest)
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
# the scans' kernel functions (csrc/*.cu), forward and backward
_SCAN_FWD = ("wkv6_kernel", "ssd_tc_kernel", "ssd_f32_kernel")
_SCAN_BWD = ("wkv6_bwd_kernel", "ssd_bwd_kernel", "sum_rows_kernel",
             "sum_mid_kernel", "wkv_sum_kernel", "wkv_sub_kernel",
             "ssd_sum_kernel", "ssd_chunk_kernel", "ssd_finish_kernel",
             "scan_chunks_kernel")


def _device_groups(fn):
    """Device time (ms) of ``fn()`` under torch.profiler by kernel group
    (the flash forward, decode attention, matrix products, copies and
    casts, the rest) and
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
                "decode_attn" if "decode_attn" in low else
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
    # deepseek-v2-lite's MLA at D 192 (q/k at nope 128 + rope 64, v padded
    # to 192): a train phase's microbatch (one row of 8 tokens), a 128-token
    # microbatch of 8 rows, and the edges
    ("deepseek_mla_bundles_8", 1, 8, 8, 16, 16, 192, BF16, True, None, None),
    ("deepseek_mla_128", 8, 128, 128, 16, 16, 192, BF16, True, None, None),
    ("D192_cross_S45_T83", 1, 45, 83, 4, 2, 192, BF16, False, None, None),
    ("D192_window64_softcap30", 2, 300, 300, 4, 2, 192, BF16, True, 64,
     30.0),
    ("f32_D192_ragged", 2, 100, 100, 4, 2, 192, F32, True, None, None),
]
BWD_MAIN = ("jag_train_128", "jag_bundles_8")
BWD_D192 = ("deepseek_mla_bundles_8", "deepseek_mla_128")
BWD_ENCDEC = ("whisper_enc_1500", "whisper_cross_128",
              "llama_vision_cross_128")
BWD_TIMED = BWD_MAIN + ("zamba2_512", "D128_gqa") + BWD_ENCDEC + BWD_D192
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
            "wkv6_scan": 0, "ssd_scan": 0,
            "wkv6_scan_bwd": 0, "ssd_scan_bwd": 0, "decode_attention": 0}


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
        name = _kernel_group(e.name)
        groups[name] = groups.get(name, 0.0) + e.time_range.elapsed_us()
    return _busy(groups, n_events, n, step_ms)


def _kernel_group(name):
    low = name.lower()
    return ("flash_fwd" if "flash_fwd" in low else
            "flash_bwd" if "flash_bwd" in low else
            "scan_bwd" if any(f in low for f in _SCAN_BWD) else
            "scan_fwd" if any(f in low for f in _SCAN_FWD) else
            "gemm" if any(f in low for f in _GEMM) else
            "copy_cast" if any(f in low for f in _COPY) else "other")


def _busy(groups, n_events, n, step_ms):
    """The profile line's keys from the device µs summed by kernel group
    over ``n`` steps."""
    if not n_events:
        return {"device_busy_ms_per_step": None, "idle_share": None}
    busy = sum(groups.values()) / 1e3 / n
    return {"device_busy_ms_per_step": busy,
            "device_ms_per_step_by_group": {
                k: v / 1e3 / n for k, v in sorted(groups.items())},
            "device_events_per_step": n_events / n,
            "step_ms": step_ms, "idle_share": 1.0 - busy / step_ms}


def profile_run_trace(step_fn, state, batches, step_ms):
    """``profile_run`` for steps of ~10^5 kernels run warm already (the
    same shapes trained just before): every batch is profiled, CUDA
    activity alone, the device events read from the exported trace
    (JSON), not through the profiler's event tree, whose Python objects
    take minutes to build for a zamba2 step."""
    from torch.profiler import ProfilerActivity, profile
    n = len(batches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches:
            state, m = step_fn(state, b)
        float(m["loss"])
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    groups, n_events = {}, 0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            n_events += 1
            name = _kernel_group(e.get("name", ""))
            groups[name] = groups.get(name, 0.0) + float(e.get("dur", 0.0))
    return _busy(groups, n_events, n, step_ms)


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


ENCDEC_BUNDLE_STEPS = 20      # whisper-tiny on the quickstart's bundles
ENCDEC_SYNTH_STEPS = 10       # ... and on synthetic tokens, batch 8 x 128
ENCDEC_F32_STEPS = 5          # float32 compute, card against the CPU port
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
            "wkv6_scan": 0, "ssd_scan": 0,
            "wkv6_scan_bwd": 0, "ssd_scan_bwd": 0, "decode_attention": 0}


def _loss_fell(label, history, window=10):
    first = statistics.mean(h["loss"] for h in history[:window])
    last = statistics.mean(h["loss"] for h in history[-window:])
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
    opt = make_optimizer(cfg.optimizer, lr=3e-4, cfg=cfg)
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


# rwkv6-3b, zamba2-1.2b and deepseek-v2-lite-16b train through the scans'
# and D-192 attention's backward kernels: (arch, superblock repeats or None
# for full depth, batch).  zamba2's 16 microbatches need 16 rows; rwkv6 at
# 16 of its 32 layers (the dry run predicts 55.7 GB at 8 x 128: `tools/
# mesh_step_memory.py --arch rwkv6-3b --repeats 16 --batch 8 --predict 1`);
# deepseek at its dense prologue and two MoE layers.
SCAN_TRAIN = (("zamba2-1.2b", None, 16), ("rwkv6-3b", 16, 8),
              ("deepseek-v2-lite-16b", 2, 8))
# the float32 step against the CPU at full width and a cut depth (the CPU
# step of the whole ~1.5 B parameters takes 25-40 s): zamba2 one
# superblock after its prologue (10 layers), rwkv6 2 layers, deepseek its
# prologue and one MoE layer
SCAN_F32_REPEATS = {"zamba2-1.2b": 1, "rwkv6-3b": 2,
                    "deepseek-v2-lite-16b": 1}
SCAN_TRAIN_STEPS = 6          # on the quickstart's bundles: the loss falls
SCAN_LOSS_WINDOW = 3          # ... from the first 3 steps' mean to the last 3's
SCAN_PROFILE_STEPS = 1        # zamba2: ~139,000 kernels a step
SCAN_F32_BATCH, SCAN_F32_SEQ = 2, 32  # one float32 step, card against CPU
SCAN_F32_REL = 1e-4           # the loss and each parameter's gradient


def _scan_train_launches(cfg, steps):
    """Exact counts of a training run under remat="full": a microbatch runs
    each layer's kernel forward twice (once more in the backward's
    recompute; a prologue layer, outside remat, once) and its backward
    kernel once."""
    if cfg.remat != "full":
        raise RuntimeError(f"{cfg.arch_id}'s remat is {cfg.remat!r}")
    n = max(1, cfg.microbatch) * steps
    n_pro = len(cfg.prologue)
    want = {name: 0 for name in KERNELS}
    for i, spec in enumerate(cfg.plan):
        kernel = {"attn": "flash_attention", "mla": "flash_attention",
                  "shared_attn": "flash_attention", "rwkv6": "wkv6_scan",
                  "mamba2": "ssd_scan"}.get(spec.kind)
        if kernel:
            want[kernel] += n * (1 if i < n_pro else 2)
            want[f"{kernel}_bwd"] += n
    return want


def _cut(cfg, repeats):
    """``cfg`` at its prologue and ``repeats`` superblocks (None: whole)."""
    if repeats is None:
        return cfg
    return cfg.replace(n_repeat=repeats, n_layers=len(cfg.prologue)
                       + repeats * len(cfg.superblock))


def _f32_grad_parity(cfg, dev):
    """The forward and backward of one float32-compute train step (one
    microbatch of SCAN_F32_BATCH x SCAN_F32_SEQ synthetic tokens through
    the step's own ``trainstep._run_loss``) on the card and on the CPU
    from the same weights (drawn on the card, copied to the CPU): the loss
    and every parameter's gradient, leaf by leaf, as rel = |card - cpu| /
    |cpu| (0 where both are 0).  MoE layers run the card's routes on the
    CPU (``_routes``).  Returns (line, expected launches, worst rel)."""
    from repro_torch.train.trainstep import _run_loss, named_params, to_device
    cfg32 = cfg.replace(compute_dtype="float32", microbatch=1)
    batch = SyntheticTokens(SCAN_F32_BATCH, SCAN_F32_SEQ,
                            cfg.vocab_size).batch_at(0)
    card = lm.init_params(cfg32, torch.Generator(device=dev).manual_seed(0),
                          dev)
    cpu = copy.deepcopy(card).cpu()
    routes, out, grads = [], {}, {}
    for where, model, ctx in (
            ("cuda", card, lambda: _routes(record=routes)),
            ("cpu", cpu, lambda: _routes(replay=[t.cpu() for t in routes]))):
        params = named_params(model)
        _zero_launches()
        t0 = time.monotonic()
        with ctx():
            loss, _, gs = _run_loss(
                model, to_device(batch, next(iter(params.values())).device),
                cfg32, None, list(params.values()))
            out[f"loss_{where}"] = float(loss.detach())
        out[f"{where}_s"] = time.monotonic() - t0
        out[f"{where}_launches"] = _launches()
        grads[where] = dict(zip(params, (g.detach() for g in gs)))
    del card, cpu
    rels, sq = {}, {"cuda": 0.0, "cpu": 0.0}
    for k, got in grads["cuda"].items():  # compared on the card
        want = grads["cpu"][k].to(got.device)
        diff = float(torch.linalg.vector_norm(got - want))
        sq["cuda"] += float(torch.sum(torch.square(got)))
        sq["cpu"] += float(torch.sum(torch.square(want)))
        norm = float(torch.linalg.vector_norm(want))
        rels[k] = diff / norm if norm else (0.0 if diff == 0 else math.inf)
    finite = all(bool(torch.isfinite(g).all()) for g in grads["cuda"].values())
    del grads, got, want
    _free()
    worst = max(rels, key=rels.get)
    loss_rel = abs(out["loss_cuda"] - out["loss_cpu"]) / abs(out["loss_cpu"])
    out.update(loss_rel=loss_rel, grad_leaves=len(rels), worst_leaf=worst,
               worst_leaf_rel=rels[worst], finite=finite,
               grad_norm_card=math.sqrt(sq["cuda"]),
               grad_norm_cpu=math.sqrt(sq["cpu"]))
    return out, _scan_train_launches(cfg32, 1), max(loss_rel, rels[worst])


def phase_train_scan_archs(dev, data):
    """rwkv6-3b, zamba2-1.2b and deepseek-v2-lite-16b at full width
    (SCAN_TRAIN's depths) through ``python -m repro_torch.launch.train`` on
    the quickstart study's bundles (``data``), SCAN_TRAIN_STEPS steps each:
    exact launch counts of every kernel forward and backward, the loss
    falls, step wall and peak memory, and a torch.profiler reading of the
    device's busy time; then one float32-compute step's loss and gradients
    on the card against the CPU's (``_f32_grad_parity``).  Returns the
    card runs' launches."""
    from repro_torch.train.trainstep import init_state
    total = {name: 0 for name in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        root = _write_study(data, os.path.join(tmp, "study"))
        for arch, repeats, batch in SCAN_TRAIN:
            t0 = time.monotonic()
            cfg = _cut(registry.get_config(arch), repeats)
            # no checkpoint: the state is 15-25 GB, whose save outlasts
            # the steps (the jag and whisper phases test resuming)
            args = ["--arch", arch, "--batch", str(batch), "--data", root,
                    "--steps", str(SCAN_TRAIN_STEPS), "--ckpt-every", "0",
                    "--workdir", os.path.join(tmp, arch)]
            if repeats is not None:
                args += ["--repeats", str(repeats)]
            label = f"{arch}_bundles"
            _, tr, launches = _train_run(
                label, args, batch * RECORD_SEQ,
                _scan_train_launches(cfg, SCAN_TRAIN_STEPS))
            for name, k in launches.items():
                total[name] += k
            fell = _loss_fell(f"{arch} on bundles", tr.history,
                              SCAN_LOSS_WINDOW)
            dts = sorted(h["dt"] for h in tr.history[1:])
            # the step's work does not depend on the weights: a fresh state
            # drawn on the card, not the checkpoint read back through the CPU
            state = init_state(torch.Generator(device=dev).manual_seed(0),
                               tr.cfg, tr.optimizer)
            batches = [next(tr.data) for _ in range(SCAN_PROFILE_STEPS)]
            t1 = time.monotonic()
            say("train_profile", run=label, layers=cfg.n_layers,
                params=sum(p.numel() for p in lm.init_params(
                    cfg, torch.Generator(), "meta").parameters()),
                profiled_steps=SCAN_PROFILE_STEPS,
                **profile_run_trace(tr.step_fn, state, batches,
                                    1e3 * statistics.median(dts)), **_card())
            del state, batches
            walls = {"train_s": t1 - t0, "profile_s": time.monotonic() - t1}
            del tr
            _free()
            cut32 = _cut(registry.get_config(arch), SCAN_F32_REPEATS[arch])
            t1 = time.monotonic()
            out, want, rel = _f32_grad_parity(cut32, dev)
            walls["parity_s"] = time.monotonic() - t1
            for name, k in out["cuda_launches"].items():
                total[name] += k
            ok = (rel < SCAN_F32_REL and out["cuda_launches"] == want
                  and out["finite"] and not any(out["cpu_launches"].values()))
            say("train_parity", arch=arch, layers=cut32.n_layers,
                batch=SCAN_F32_BATCH, seq=SCAN_F32_SEQ, rel=rel,
                rel_tol=SCAN_F32_REL, expected_launches=want,
                kernel_launches=out.pop("cuda_launches"),
                loss_fell_bundles=list(fell),
                phase_s=time.monotonic() - t0, walls_s=walls,
                **{k: v for k, v in out.items() if k != "cpu_launches"},
                **_card())
            if not ok:
                raise RuntimeError(
                    f"{arch}: the float32 step's loss or gradients on the "
                    f"card and the CPU differ by rel {rel} (worst leaf "
                    f"{out['worst_leaf']}; launches expected {want})")
    return total


# the dry run's check on the card: the caching allocator rounds each
# block up to 512 bytes; the peak may exceed the saved bytes by what the
# dry run's live-tensor peak holds beyond them (gradients, the optimizer's
# new moments) plus 10 % (a CUDA operator's internal scratch, which no
# dispatch mode sees, and tensors freed only by the garbage collector),
# 5 % of the saved bytes and 256 MiB
ALLOC_ROUND = 512
PEAK_SLACK, PEAK_MARGIN = 1.10, 256 << 20
# deepseek's (1, 1) mesh eval against the unsharded one: the MoE aux means
# are sums over the global token count there
DEEPSEEK_EVAL_REL = 1e-4
SERVE_FNS = (("jag-surrogate", 32, 8), ("whisper-tiny", 32, 8))


def _serve_flash(cfg, new_tokens):
    """Flash launches of one prefill and ``new_tokens - 1`` decode steps:
    each encoder layer, self- and cross-attention at prefill; each
    cross-attention again at every decode step (self-attention decodes
    through the decode attention kernel)."""
    pre = cfg.n_enc_layers + sum({"dec": 2}.get(spec.kind, 1)
                                 for spec in cfg.plan
                                 if spec.kind not in ("rwkv6", "mamba2"))
    dec = sum(1 for spec in cfg.plan if spec.kind in ("dec", "xattn"))
    return pre + (new_tokens - 1) * dec


def _whole(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def phase_dryrun(dev):
    """The meta-device dry run held to the card, and the sharded serving
    and MoE paths, on a one-rank NCCL group and a (1, 1) host mesh
    (``launch.mesh.make_host_mesh``): ``_dryrun_memory_flops``,
    ``_dryrun_serve_fns`` and ``_deepseek_mesh_eval``.  The group is
    destroyed at the end, whatever the result.  Returns the launch
    counts."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    launches = {name: 0 for name in KERNELS}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        for part in (_dryrun_memory_flops, _dryrun_serve_fns,
                     _deepseek_mesh_eval):
            for name, n in part(dev, mesh).items():
                launches[name] += n
            _free()
    finally:
        dist.destroy_process_group()
    return launches


def _dryrun_memory_flops(dev, mesh):
    """llama-3.2-vision-11b at full width and VISION_LAYERS layers, one
    train step of 8 x 128 tokens.  ``dryrun.lower_cell`` + ``analyze`` on
    meta predict the step's argument bytes, saved bytes, live peak and
    FLOPs; then the real state is placed on the card (argument bytes
    within the allocator's rounding of the prediction), one step is run
    (its peak no more than argument_bytes + temp_bytes + the margin above)
    and a second one under the dry run's ``LocalCounter`` (its FLOPs equal
    the meta count).  Returns the launch counts."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.trainstep import (init_state, make_train_step,
                                             shard_state)
    full = registry.get_config("llama-3.2-vision-11b")
    cfg = full.replace(n_repeat=1, n_layers=len(full.superblock))
    shape = ShapeConfig("chip_smoke_train", "train", 128, 8)
    t0 = time.monotonic()
    cell = dryrun.lower_cell(cfg.arch_id, shape, mesh, cfg=cfg)
    pred = dryrun.analyze(cell)
    dry_s = time.monotonic() - t0
    del cell
    _free()
    opt = make_optimizer(cfg.optimizer, lr=3e-4, cfg=cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = shard_state(init_state(torch.Generator(device=dev)
                                   .manual_seed(0), cfg, opt), mesh)
    batch = registry.input_specs(cfg, shape, abstract=False,
                                 gen=torch.Generator().manual_seed(1),
                                 device=dev)
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    n_tensors = (len(list(state.params.parameters())) + len(batch) + 1
                 + sum(1 for _ in _leaves(state.opt)))
    mem = pred["memory"]
    args = mem["argument_bytes"]
    args_ok = 0 <= held - args <= ALLOC_ROUND * n_tensors
    step = make_train_step(cfg, opt, mesh)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    state, m1 = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    margin = (max(0, mem["peak_live_bytes"] - mem["temp_bytes"]) * PEAK_SLACK
              + 0.05 * mem["temp_bytes"] + PEAK_MARGIN)
    bound = args + mem["temp_bytes"] + margin
    counter = dryrun.LocalCounter()
    with kflops.counting(counter), counter:
        state, m2 = step(state, batch)
    torch.cuda.synchronize()
    got = _launches()
    want = _encdec_launches(cfg, 2)
    flops_equal = counter.flops == pred["flops"]
    losses = [float(m1["loss"]), float(m2["loss"])]
    ok = (args_ok and peak <= bound and flops_equal and got == want
          and all(np.isfinite(losses)))
    say("dryrun", check="memory_flops", arch=cfg.arch_id, layers=cfg.n_layers,
        batch=8, seq=128, mesh_shape=[1, 1], dry_run_s=dry_s, predicted=mem,
        measured_argument_bytes=held, argument_rel=(held - args) / args,
        tensors=n_tensors, alloc_round_bar=ALLOC_ROUND * n_tensors,
        measured_peak_bytes=peak, peak_bound_bytes=bound, margin_bytes=margin,
        predicted_flops=pred["flops"], measured_flops=counter.flops,
        kernel_flops=pred["kernel_flops"],
        measured_kernel_flops=counter.kernel_flops, flops_equal=flops_equal,
        collectives=pred["collectives"], losses=losses, kernel_launches=got,
        expected_launches=want, ok=ok, **_card())
    if not ok:
        raise RuntimeError(f"dry run against the card: arguments {held} vs "
                           f"{args}, peak {peak} vs bound {bound}, flops "
                           f"{counter.flops} vs {pred['flops']}, launches "
                           f"{got} vs {want}")
    return got


def _dryrun_serve_fns(dev, mesh):
    """``make_prefill_fn`` / ``make_decode_fn`` under the mesh serve
    jag-surrogate and whisper-tiny at full width (whisper's
    cross-attention at S = 1 through the flash kernel, self-attention
    through the decode attention kernel on the local shards): their logits
    bit-equal to ``ServeEngine(mesh=...).generate``'s, their flash and
    decode attention launches exact.  Returns the launch counts."""
    from repro_torch.parallel.sharding import shard_module
    from repro_torch.serve.engine import make_decode_fn, make_prefill_fn
    launches = {name: 0 for name in KERNELS}
    for arch, prompt, new in SERVE_FNS:
        cfg = registry.get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = shard_module(lm.init_params(cfg, gen, dev), mesh)
        toks = torch.randint(0, cfg.vocab_size, (4, prompt), generator=gen,
                             device=dev)
        extra = _extras(cfg, 4, gen, dev)
        max_len = prompt + new
        seen = []

        def keep(fn):
            def run(*a):
                out = fn(*a)
                seen.append(_whole(out[0]))
                return out
            return run
        with torch.inference_mode():
            prefill = make_prefill_fn(cfg, max_len, mesh)
            decode = make_decode_fn(cfg, mesh)
            _zero_launches()
            logits, caches = prefill(params, toks, *extra.values())
            fn_logits = [_whole(logits)[:, -1]]
            for _ in range(new - 1):
                tok = torch.argmax(fn_logits[-1], -1)[:, None]
                logits, caches = decode(params, tok, caches)
                fn_logits.append(_whole(logits))
            torch.cuda.synchronize()
            fn_counts = _launches()
            eng = ServeEngine(cfg, params, max_len=max_len, mesh=mesh)
            eng.prefill_fn = keep(eng.prefill_fn)
            eng.decode_fn = keep(eng.decode_fn)
            _zero_launches()
            out = eng.generate(toks, new, extra)
            torch.cuda.synchronize()
            eng_counts = _launches()
        for name in KERNELS:
            launches[name] += fn_counts[name] + eng_counts[name]
        seen[0] = seen[0][:, -1]
        equal = len(seen) == len(fn_logits) and all(
            torch.equal(a, b) for a, b in zip(fn_logits, seen))
        want = {"flash_attention": _serve_flash(cfg, new),
                "flash_attention_bwd": 0, "wkv6_scan": 0, "ssd_scan": 0,
                "wkv6_scan_bwd": 0, "ssd_scan_bwd": 0,
                "decode_attention": (new - 1) * _self_attn_layers(cfg)}
        ok = (equal and fn_counts == want and eng_counts == want
              and tuple(out.shape) == (4, new)
              and all(bool(torch.isfinite(x).all()) for x in seen))
        say("dryrun", check="serve_fns", arch=arch, mesh_shape=[1, 1],
            batch=4, prompt=prompt, new_tokens=new, bit_equal=equal,
            fn_launches=fn_counts, engine_launches=eng_counts,
            expected_launches=want, ok=ok)
        if not ok:
            raise RuntimeError(f"{arch}: serve fns under the mesh: equal "
                               f"{equal}, launches {fn_counts} / "
                               f"{eng_counts}, expected {want}")
        del params, caches, eng
        _free()
    return launches


def _deepseek_mesh_eval(dev, mesh):
    """deepseek-v2-lite-16b at full width, cut to its dense prologue layer
    and one MoE layer: ``make_eval_step`` under the mesh (the D-192 flash
    forward on the local shards, the MoE router on the local rows) against
    the unsharded eval, launches exact.  Returns the launch counts."""
    from repro_torch.parallel.sharding import shard_module
    from repro_torch.train.trainstep import make_eval_step
    full = registry.get_config("deepseek-v2-lite-16b")
    cfg = full.replace(n_repeat=1,
                       n_layers=len(full.prologue) + len(full.superblock))
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    batch = SyntheticTokens(8, 128, cfg.vocab_size).batch_at(0)
    plain = make_eval_step(cfg)(params, batch)
    shard_module(params, mesh)
    _zero_launches()
    got = make_eval_step(cfg, mesh)(params, batch)
    torch.cuda.synchronize()
    counts = _launches()
    rel = {k: abs(float(got[k]) - float(plain[k])) / abs(float(plain[k]))
           for k in ("loss", "moe_lb_loss", "moe_z_loss")}
    want = {"flash_attention": cfg.n_layers, "flash_attention_bwd": 0,
            "wkv6_scan": 0, "ssd_scan": 0,
            "wkv6_scan_bwd": 0, "ssd_scan_bwd": 0, "decode_attention": 0}
    ok = counts == want and max(rel.values()) <= DEEPSEEK_EVAL_REL
    say("mesh", check="deepseek_eval", arch=cfg.arch_id,
        layers=[s.kind + "/" + s.mlp for s in cfg.plan], mesh_shape=[1, 1],
        batch=8, seq=128, loss={k: float(v) for k, v in got.items()},
        unsharded_loss={k: float(v) for k, v in plain.items()}, rel=rel,
        rel_tol=DEEPSEEK_EVAL_REL, kernel_launches=counts,
        expected_launches=want, ok=ok)
    if not ok:
        raise RuntimeError(f"deepseek mesh eval: rel {rel}, launches "
                           f"{counts}, expected {want}")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
        opt = make_optimizer(cfg.optimizer, lr=3e-4, cfg=cfg)
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
    # no TPU kernel: the gradients the reference takes with jax.grad of
    "flash_attention_bwd": "src/repro/kernels/ref.py:55",
    "wkv6_scan": "src/repro/kernels/wkv6_scan.py:18",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:21",
    "wkv6_scan_bwd": "src/repro/kernels/ref.py:253",
    "ssd_scan_bwd": "src/repro/kernels/ref.py:167",
    # no TPU kernel: the reference's decode attention is plain
    "decode_attention": "src/repro/kernels/ref.py:105",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 2
    dev = env.device("cuda")
    t_start = time.monotonic()
    walls = {}  # phase -> seconds since the previous mark

    def mark(name):
        walls[name] = time.monotonic() - t_start - sum(walls.values())
    snap = phase_env()
    phase_build()
    phase_sass()
    mark("env_build_sass")
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
    for name, fwd, bwd, plain, mirror, shapes, timed, make, work in (
            ("wkv6_scan_bwd", wkvk.wkv6_scan, wkvk.wkv6_scan_bwd,
             ref.wkv6_scan_bwd_ref, ref.wkv6_scan_bwd_tc_ref,
             WKV_BWD_SHAPES, WKV_BWD_TIMED, wkv_inputs, wkv_bwd_work),
            ("ssd_scan_bwd", ssdk.ssd_scan, ssdk.ssd_scan_bwd,
             ref.ssd_scan_bwd_ref, ref.ssd_scan_bwd_tc_ref, SSD_BWD_SHAPES,
             SSD_BWD_TIMED, ssd_inputs, ssd_bwd_work)):
        errs[name], t = phase_scan_backward(dev, name, fwd, bwd, plain,
                                            mirror, shapes, timed, make,
                                            work)
        timing[name] = t[timed[0]]
        main_shapes[name] = timed[:1]
    errs["decode_attention"], t = phase_decode_attention(dev)
    timing["decode_attention"] = t[DECODE_MAIN[0]]
    main_shapes["decode_attention"] = DECODE_MAIN
    _free()
    mark("kernels")
    launches = {name: 0 for name in KERNELS}
    for arch in SERVE:  # each model's counts are read around its own run
        for name, n in phase_serve(dev, arch).items():
            launches[name] += n
    mark("serve")
    for name, n in phase_train_vision(dev).items():
        launches[name] += n
    mark("train_vision")
    for name, n in phase_dryrun(dev).items():
        launches[name] += n
    mark("dryrun")
    # the quickstart study's bundles, drawn on the CPU: the Merlin phases
    # below keep CUDA graph pools that these models' steps do not fit beside
    _, scan_data, _ = quickstart.run_study(torch.device("cpu"),
                                           samples=MERLIN_SAMPLES)
    for name, n in phase_train_scan_archs(dev, scan_data).items():
        launches[name] += n
    mark("train_scan_archs")
    phase_merlin(dev)
    data = phase_merlin_net(dev)
    phase_gateway(dev, data)
    phase_cascade(dev)
    phase_icf(dev)
    phase_optimization_loop(dev)
    mark("merlin_workflows")
    with tempfile.TemporaryDirectory() as keep:
        ckpt = os.path.join(keep, "jag_ckpt")
        for name, n in phase_train(data, ckpt).items():
            launches[name] += n
        mark("train")
        for name, n in phase_train_encdec(dev, data).items():
            launches[name] += n
        mark("train_encdec")
        for name, n in phase_mesh(dev, ckpt).items():
            launches[name] += n
        mark("mesh")
    say("timing", seconds=time.monotonic() - t_start, phases=walls)
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
