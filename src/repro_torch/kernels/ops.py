"""Dispatch between the CUDA kernels and their plain versions (port of
``repro/kernels/ops.py``).

Dispatch policy (``use_pallas``, the reference's field name):
  * ``"auto"``  — the CUDA kernel for a CUDA tensor, the plain version on
                  every other device (cpu, meta), as the reference takes its
                  plain path on every device but a TPU.  No fallback: a CUDA
                  tensor the kernel cannot take raises.
  * ``"never"`` — always the plain version (tests and ``chip_smoke.py``'s
                  yardstick; the main path never sets it).

Gradients.  On a CPU tensor the plain versions are differentiated by
autograd, as the reference differentiates its plain path.  On a CUDA tensor
each kernel under grad goes through its wrapper's autograd Function:
``flash_attention`` the forward kernel with its row log-sum-exp, then the
backward kernel; ``wkv6_scan`` and ``ssd_scan`` the forward kernel, saving
their inputs, then the backward kernel, which recomputes the states.

DTensors (a step under a mesh) reach the kernels as each rank's local
batch rows and heads, through ``parallel.sharding.run_local``
(``local_map``): the dispatch above then reads the local shard's device.
Where the query heads are split over ``model`` and the KV heads are not
(they do not divide it), each rank selects the KV heads its query heads
read by their global index, so that the kernel's local ratio H / KV
holds (decode attention's kernel takes such a selection as a view: its
cache strides need only the heads and head dim packed).  Decode attention
over a cache split along its positions (``kv_seq``) is a softmax over a
split dim: each rank attends over its own positions with the plain
version and the partial rows are merged (max, then sums) over the mesh
dims that split them.

FLOP accounting.  While a counter is registered (``counting``; the dry
run's ``LocalFlopCounter``), each kernel call adds the work its inputs
need (valid query-key pairs, not padded tiles) through ``flops.count``, the
same number for the kernel and its plain version, and the plain version
runs with the counter's dispatch modes suspended; on a meta or CPU
tensor under grad flash then goes through :class:`_PlainFlashFn`, which
saves what the kernel's autograd Function saves (q, k, v, out, lse), and
the scans through :class:`_PlainScanFn` (their inputs), so that a dry run
counts and holds what the card's step does.  Decode attention's kernel
adds what the counter's dispatch mode counts of its plain version (its two
products over every cache position, ``flops.decode_flops``); the plain
version's float32 copies of the cache, which a dry run holds, the kernel
does not make.

The scans pad a ragged S to a multiple of ``chunk`` as the reference does
(zeros; w with 1.0, whose log-decay 0 makes the padding inert) and slice the
result back.  On the kernel path the inputs are made contiguous, since the
model hands over slices of a fused projection.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import spans
from repro_torch.kernels import decode_attention as dak
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels.flops import (count, counting_active, decode_flops,
                                      flash_flops, scan_flops, uncounted)
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssdk
from repro_torch.kernels import wkv6_scan as wkvk
from repro_torch.parallel.sharding import (batch_placements, local_offset,
                                          run_local, split_like)

def _use_kernel(use_pallas, x) -> bool:
    if use_pallas not in ("auto", "never"):
        raise ValueError(f"use_pallas={use_pallas!r}: the port takes "
                         "'auto' or 'never'")
    return use_pallas == "auto" and x.device.type == "cuda"


class _PlainFlashFn(torch.autograd.Function):
    """The plain flash forward and backward (``ref.flash_attention_lse_ref``,
    ``ref.flash_attention_bwd_ref``) as one autograd Function saving what
    ``FlashAttentionFn`` saves, counted as the kernels are: the dry run's
    path, where a meta tensor stands in for the card's."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = uncounted(ref.flash_attention_lse_ref, q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        count("flash_attention", flash_flops, q, k, v, kw["causal"],
              kw["window"], 0)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        kw = ctx.kw
        count("flash_attention_bwd", flash_flops, q, k, v, kw["causal"],
              kw["window"], 0, backward=True)
        dq, dk, dv = uncounted(ref.flash_attention_bwd_ref, q, k, v, out,
                               dout, lse, **kw)
        return dq, dk, dv, None


class _PlainScanFn(torch.autograd.Function):
    """A scan's plain forward (``fwd``) and plain backward (``bwd``) as one
    autograd Function saving what the kernel's Function saves (the
    inputs), its backward counted as the kernel's is and holding what the
    kernel's call holds: its outputs (one a input, in the input's dtype)
    and ``scratch(*args)``, allocated where the counter sees them (the
    plain backward's own tensors it does not).  The dry run's path.
    ``name`` is the backward kernel's, ``n`` the state's second dim."""

    @staticmethod
    def forward(ctx, fwd, bwd, scratch, name, n, *args):
        ctx.save_for_backward(*args)
        ctx.bwd, ctx.scratch, ctx.name, ctx.n = bwd, scratch, name, n
        return uncounted(fwd, *args)

    @staticmethod
    def backward(ctx, dy):
        args = ctx.saved_tensors
        count(ctx.name, scan_flops, args[0], ctx.n, backward=True)
        outs = [torch.empty_like(a) for a in args]
        held = ctx.scratch(*args)
        grads = uncounted(ctx.bwd, *args, dy.to(args[0].dtype))
        uncounted(lambda: [o.copy_(g) for o, g in zip(outs, grads)])
        del held
        return (None, None, None, None, None, *outs)


def _plain_scan(fwd, bwd, scratch, name, n, *args):
    """A scan's plain version: under a counter and grad through
    :class:`_PlainScanFn`, else ``fwd`` itself (autograd differentiates it
    on the CPU)."""
    if counting_active() and torch.is_grad_enabled() and any(
            t.requires_grad for t in args):
        return _PlainScanFn.apply(fwd, bwd, scratch, name, n, *args)
    return uncounted(fwd, *args)


def _flash_local(q, k, v, use_pallas, kw):
    if _use_kernel(use_pallas, q):
        count("flash_attention", flash_flops, q, k, v, kw["causal"],
              kw["window"], kw["q_pos0"])
        return fak.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)
    if not counting_active():
        return ref.flash_attention_ref(q, k, v, **kw)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _PlainFlashFn.apply(q, k, v, {
            key: kw[key] for key in ("causal", "scale", "softcap_val",
                                     "window")})
    count("flash_attention", flash_flops, q, k, v, kw["causal"], kw["window"],
          kw["q_pos0"])
    return uncounted(ref.flash_attention_ref, q, k, v, **kw)


def _kv_heads(q, k):
    """(placements for k / v, selector of the KV heads a rank's query heads
    read or None).  ``q`` is placed with its batch and heads split.  KV
    heads are split with q's where their count divides the split; else
    they stay whole on the rank and the selector picks, for the query
    heads [h0, h0 + n), KV heads (h0 + i) // g: a contiguous run where
    the query heads hold whole groups or lie in one, else one a head."""
    H, KV = q.shape[2], k.shape[2]
    mesh = q.device_mesh
    n = math.prod(mesh.size(i) for i, p in enumerate(q.placements)
                  if p == Shard(2))
    if KV % n == 0:
        return [p if p in (Shard(0), Shard(2)) else Replicate()
                for p in q.placements], None
    g = H // KV
    h0, hn = local_offset(q, 2)
    if hn % g == 0:
        sel = slice(h0 // g, (h0 + hn) // g)
    elif g % hn == 0:
        sel = slice(h0 // g, h0 // g + 1)
    else:
        sel = (h0 + torch.arange(hn)) // g
    return [p if p == Shard(0) else Replicate() for p in q.placements], sel


def flash_attention(q, k, v, *, causal=True, scale=None, softcap_val=None,
                    window=None, q_pos0=0, use_pallas="auto"):
    kw = dict(causal=causal, scale=scale, softcap_val=softcap_val,
              window=window, q_pos0=q_pos0)
    if not isinstance(q, DTensor):
        return _flash_local(q, k, v, use_pallas, kw)
    q = q.redistribute(q.device_mesh, batch_placements(q, keep=2))
    kp, sel = _kv_heads(q, k)
    k, v = (t.redistribute(t.device_mesh, kp) for t in (k, v))

    def local(q, k, v):
        if sel is not None:
            k, v = k[:, :, sel], v[:, :, sel]
        return _flash_local(q, k, v, use_pallas, kw)
    return run_local(local, q, k, v)


def decode_attention(q, ck, cv, *, kv_len, scale=None, softcap_val=None,
                     window=None, use_pallas="auto"):
    """One decode step's attention over the caches, the span
    ``decode_attention``: the CUDA decode attention kernel on a CUDA
    tensor, the plain version elsewhere; a cache split along its positions
    stays plain (``_decode_split``)."""
    kw = dict(kv_len=kv_len, scale=scale, softcap_val=softcap_val,
              window=window)
    with spans.span("decode_attention"):
        return _decode_attention(q, ck, cv, use_pallas, kw)


def _decode_local(q, ck, cv, use_pallas, kw):
    if _use_kernel(use_pallas, q):
        count("decode_attention", decode_flops, q, ck)
        return dak.decode_attention(q.contiguous(), ck, cv, **kw)
    return ref.decode_attention_ref(q, ck, cv, **kw)


def _decode_attention(q, ck, cv, use_pallas, kw):
    if not isinstance(q, DTensor):
        return _decode_local(q, ck, cv, use_pallas, kw)
    seq = [i for i, p in enumerate(ck.placements) if p == Shard(1)]
    if not seq:  # the cache is split over heads (or not at all)
        q = q.redistribute(q.device_mesh, batch_placements(q, keep=2))
        kp, sel = _kv_heads(q, ck)
        if sel is None and list(ck.placements) != kp:
            ck, cv = (t.redistribute(t.device_mesh, kp) for t in (ck, cv))

        def local(q, ck, cv):
            if sel is not None:
                ck, cv = ck[:, :, sel], cv[:, :, sel]
            return _decode_local(q, ck, cv, use_pallas, kw)
        return run_local(local, q, ck, cv)
    # the cache is split along its positions: every head here, a partial
    # softmax over this rank's positions, merged over the mesh dims in seq
    q = q.redistribute(q.device_mesh, batch_placements(q))
    t0 = local_offset(ck, 1)[0]
    mesh = ck.device_mesh
    return run_local(lambda q, ck, cv: _decode_split(
        q, ck, cv, t0, [(mesh, i) for i in seq], **kw), q, ck, cv)


def _decode_split(q, ck, cv, t0, groups, *, kv_len, scale, softcap_val,
                  window):
    """``ref.decode_attention_ref`` over the cache positions [t0, t0 + T)
    this rank holds, merged with the other ranks' over ``groups``."""
    from torch.distributed import _functional_collectives as funcol
    B, _, H, D = q.shape
    T, KV = ck.shape[1], ck.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, KV, g, D).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qf, ck.float()) * scale
    if softcap_val is not None:
        logits = softcap_val * torch.tanh(logits / softcap_val)
    t = t0 + torch.arange(T, device=q.device)
    mask = t < kv_len
    if window is not None:
        mask &= t >= kv_len - window
    logits = torch.where(mask, logits, ref.NEG_INF)
    m = logits.amax(-1, keepdim=True)
    for grp in groups:
        m = funcol.all_reduce(m, "max", grp)
    p = torch.exp(logits - m) * mask
    den = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", p, cv.float())
    for grp in groups:
        den = funcol.all_reduce(den, "sum", grp)
        out = funcol.all_reduce(out, "sum", grp)
    return (out / den).reshape(B, 1, H, D).to(q.dtype)


def _pad_seq(arrs, chunk, value=0.0):
    """Pad each tensor along axis 1 to a multiple of chunk."""
    S = arrs[0].shape[1]
    Sp = -(-S // chunk) * chunk
    if Sp == S:
        return list(arrs)
    out = []
    for a in arrs:
        pad = [0, 0] * (a.dim() - 2) + [0, Sp - S]  # last axis first
        out.append(F.pad(a, pad, value=value))
    return out


def ssd_scan(x, dt, A, B_, C, *, chunk=128, use_pallas="auto"):
    """Under a mesh, on each rank's rows and its heads of ``x``."""
    if isinstance(x, DTensor):
        x = x.redistribute(x.device_mesh, batch_placements(x, keep=2))
        dt = split_like(dt.redistribute(dt.device_mesh, batch_placements(dt)),
                        2, x, 2)
        A = split_like(A, 0, x, 2)
        B_, C = (t.redistribute(t.device_mesh, batch_placements(t))
                 for t in (B_, C))
    return run_local(lambda *a: _ssd_scan(*a, chunk=chunk,
                                          use_pallas=use_pallas),
                     x, dt, A, B_, C)


def _ssd_scan(x, dt, A, B_, C, *, chunk, use_pallas):
    S = x.shape[1]
    chunk = min(chunk, S)
    count("ssd_scan", scan_flops, x, B_.shape[-1])
    # zero-pad ragged sequences: x=0, dt=0 contribute nothing to the state
    x, dt, B_, C = _pad_seq((x, dt, B_, C), chunk)
    if _use_kernel(use_pallas, x):
        y = ssdk.ssd_scan(x.contiguous(), dt.float().contiguous(),
                          A.float().contiguous(), B_.contiguous(),
                          C.contiguous(), chunk=chunk)
    else:
        y = _plain_scan(
            lambda *a: ref.ssd_chunked_ref(*a, chunk=chunk),
            lambda *a: ref.ssd_scan_bwd_ref(*a, chunk=chunk),
            lambda x, dt, A, B_, C: ssdk.bwd_scratch(x, B_), "ssd_scan_bwd", B_.shape[-1], x, dt, A, B_, C)
    return y[:, :S]


def ssd_decode(h, x, dt, A, B_, C):
    """One step; under a mesh on the heads the state ``h`` holds."""
    if isinstance(h, DTensor):
        x = split_like(x, 1, h, 1)
        dt = split_like(dt, 1, h, 1)
        A = split_like(A, 0, h, 1)
        return run_local(ref.ssd_decode_ref, h, x, dt, A, B_, C,
                         out=(list(h.placements), list(x.placements)))
    return ref.ssd_decode_ref(h, x, dt, A, B_, C)


def wkv6_scan(r, k, v, w, u, *, chunk=128, use_pallas="auto", impl="chunked",
              subchunk=16):
    """Under a mesh, on each rank's rows and its heads of ``r``."""
    if isinstance(r, DTensor):
        r = r.redistribute(r.device_mesh, batch_placements(r, keep=2))
        k, v, w = (t.redistribute(t.device_mesh, r.placements)
                   for t in (k, v, w))
        u = split_like(u, 0, r, 2)
    return run_local(lambda *a: _wkv6_scan(
        *a, chunk=chunk, use_pallas=use_pallas, impl=impl, subchunk=subchunk),
        r, k, v, w, u)


def _wkv6_scan(r, k, v, w, u, *, chunk, use_pallas, impl, subchunk):
    S = r.shape[1]
    chunk = min(chunk, S)
    count("wkv6_scan", scan_flops, r, r.shape[-1])
    # pad ragged sequences: r/k/v = 0 and w = 1 (log-decay 0) are inert
    r, k, v = _pad_seq((r, k, v), chunk)
    (w,) = _pad_seq((w,), chunk, value=1.0)
    if _use_kernel(use_pallas, r):
        y = wkvk.wkv6_scan(r.contiguous(), k.contiguous(), v.contiguous(),
                           w.float().contiguous(), u.float().contiguous(),
                           chunk=chunk)
    elif impl == "blocked":
        sub = min(subchunk, chunk)
        while chunk % sub:  # snap to a divisor of the chunk
            sub -= 1
        y = _plain_scan(
            lambda *a: ref.wkv6_blocked_ref(*a, chunk=chunk, subchunk=sub),
            lambda *a: ref.wkv6_scan_bwd_ref(*a, chunk=chunk),
            lambda r, *_: wkvk.bwd_scratch(r), "wkv6_scan_bwd", r.shape[-1],
            r, k, v, w, u)
    else:
        y = _plain_scan(
            lambda *a: ref.wkv6_chunked_ref(*a, chunk=chunk),
            lambda *a: ref.wkv6_scan_bwd_ref(*a, chunk=chunk),
            lambda r, *_: wkvk.bwd_scratch(r), "wkv6_scan_bwd", r.shape[-1],
            r, k, v, w, u)
    return y[:, :S]


def wkv6_decode(state, r, k, v, w, u):
    """One step; under a mesh on the heads the state holds."""
    if isinstance(state, DTensor):
        r, k, v, w = (split_like(t, 1, state, 1) for t in (r, k, v, w))
        u = split_like(u, 0, state, 1)
        return run_local(ref.wkv6_decode_ref, state, r, k, v, w, u,
                         out=(list(state.placements), list(r.placements)))
    return ref.wkv6_decode_ref(state, r, k, v, w, u)
