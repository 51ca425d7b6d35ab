"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

``flash_attention_ref`` is the plain version of the CUDA flash kernel: the CPU
path of the port, the yardstick ``chip_smoke.py`` holds the kernel against on
the card, and the ``use_pallas="never"`` path.  It is chunked over KV blocks
with the same online softmax, so its memory stays O(S·block).  It computes in
the Pallas kernel's order: ``q·scale`` in float32, the dot, softcap, then the
mask.  ``flash_attention_tc_ref`` mirrors the bf16 tensor-core kernel's
rounding points (the logits scaled after the product, P rounded to bf16).
``flash_attention_lse_ref`` adds the row log-sum-exp the forward kernel
stores for training, and ``flash_attention_bwd_ref`` is the plain version of
the backward kernel (dq, dk, dv from q, k, v, o, dO and that log-sum-exp);
``flash_attention_bwd_tc_ref`` mirrors the bf16 backward kernel's rounding
points (P and dS rounded to bf16 as operands).

``naive_attention`` is the O(S²) oracle, in the reference's own order (dot,
then scale).  ``decode_attention_ref`` is one token against a cache, the
plain version of the CUDA decode attention kernel (the reference has none:
its decode attention is this plain function on every device);
``decode_attention_split_ref`` is the kernel's split path, the attended
positions in runs whose partial (out, max, sum) are then merged.

The scans follow the reference function for function: ``ssd_scan_ref`` and
``wkv6_scan_ref`` are the sequential oracles; ``ssd_chunked_ref`` and
``wkv6_chunked_ref`` are the chunked algorithms the CUDA scan kernels
compute, and their yardsticks on the card; ``wkv6_blocked_ref`` is the
factored form with the reference's bf16 casts and clamps (the CPU path of
``wkv_impl="blocked"``); ``wkv6_subtile_ref`` mirrors the WKV kernel's
16-row chunks and split bf16 products, ``ssd_subtile_ref`` the SSD kernel's
64-row tiles and split products; the ``*_decode_ref`` functions are one
decode step, plain on every device as in the reference.  The three mirrors
are for tests only: no served path calls them.  ``wkv6_scan_bwd_ref`` and
``ssd_scan_bwd_ref`` are the plain versions of the scans' backward kernels:
the gradients written out chunk by chunk, with no autograd (tests, the card's
yardstick, and the dry run's counted backward); ``wkv6_scan_bwd_tc_ref`` and
``ssd_scan_bwd_tc_ref`` mirror the bf16 backward kernels' chunk-parallel
order and split products (tests only).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _apply_softcap(logits, cap):
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _mask(qpos, kpos, causal, window):
    mask = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def naive_attention(q, k, v, *, causal=True, scale=None, softcap_val=None,
                    window=None, q_pos0=0):
    """O(S^2)-memory oracle. q: (B,S,H,D), k/v: (B,T,KV,D)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, S, KV, g, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * scale
    logits = _apply_softcap(logits, softcap_val)
    qpos = (torch.arange(S, device=q.device) + q_pos0)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = _mask(qpos, kpos, causal, window)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def _online_softmax_attention(q, k, v, *, causal, scale, softcap_val, window,
                              q_pos0, block_k, scale_logits, p_dtype,
                              with_lse=False):
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, S, KV, g, D).float()
    if not scale_logits:
        qf = qf * scale
    qpos = (torch.arange(S, device=q.device) + q_pos0)[:, None]
    m = torch.full((B, KV, g, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, g, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, g, S, D), dtype=torch.float32, device=q.device)
    for start in range(0, T, block_k):
        kc = k[:, start:start + block_k].float()
        vc = v[:, start:start + block_k].float()
        logits = torch.einsum("bskgd,btkd->bkgst", qf, kc)
        if scale_logits:
            logits = logits * scale
        logits = _apply_softcap(logits, softcap_val)
        kpos = start + torch.arange(kc.shape[1], device=q.device)[None, :]
        logits = torch.where(_mask(qpos, kpos, causal, window), logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(p_dtype).float(), vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.reshape(B, H, S, D).transpose(1, 2)  # (B,S,H,D) with H = KV*g
    out = out.to(q.dtype).contiguous()
    if with_lse:
        return out, (m + torch.log(torch.clamp_min(l, 1e-30))).reshape(B, H, S)
    return out


def flash_attention_ref(q, k, v, *, causal=True, scale=None, softcap_val=None,
                        window=None, q_pos0=0, block_k=1024):
    """Flash-style chunked attention (online softmax over KV blocks)."""
    return _online_softmax_attention(
        q, k, v, causal=causal, scale=scale, softcap_val=softcap_val,
        window=window, q_pos0=q_pos0, block_k=block_k, scale_logits=False,
        p_dtype=torch.float32)


def flash_attention_tc_ref(q, k, v, *, causal=True, scale=None,
                           softcap_val=None, window=None, q_pos0=0,
                           block_k=64):
    """Plain mirror of the bf16 tensor-core flash kernel's rounding points:
    the fp32 logits of the unscaled q and k are multiplied by the scale, and
    P is rounded to q's dtype as the operand of P·V while l sums the
    unrounded P; 64-key blocks as the kernel's tiles.  For float32 inputs
    nothing is rounded.  No served path calls it."""
    return _online_softmax_attention(
        q, k, v, causal=causal, scale=scale, softcap_val=softcap_val,
        window=window, q_pos0=q_pos0, block_k=block_k, scale_logits=True,
        p_dtype=q.dtype)


def flash_attention_lse_ref(q, k, v, *, causal=True, scale=None,
                            softcap_val=None, window=None, q_pos0=0,
                            block_k=1024):
    """``flash_attention_ref``'s output and each row's log-sum-exp of its
    masked, softcapped, scaled logits (natural log, float32 (B,H,S)): what
    the forward kernel stores for the backward."""
    return _online_softmax_attention(
        q, k, v, causal=causal, scale=scale, softcap_val=softcap_val,
        window=window, q_pos0=q_pos0, block_k=block_k, scale_logits=False,
        p_dtype=torch.float32, with_lse=True)


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, scale=None,
                            softcap_val=None, window=None, q_pos0=0,
                            block_k=1024):
    """Plain version of the backward kernel: (dq, dk, dv) of
    ``flash_attention_ref`` at output ``o`` with gradient ``do``, from the
    row log-sum-exp ``lse`` (B,H,S), chunked over KV blocks in float32
    (FlashAttention-2's backward): D = rowsum(dO o O), P = exp(s - lse)
    (0 where masked), dV = P^T dO, dS = P o (dO V^T - D) times the softcap's
    derivative, dQ = scale dS K, dK = scale dS^T Q.  Nothing is rounded
    inside: the float32 kernel's mirror, and the bf16 kernel's yardstick."""
    return _flash_bwd(q, k, v, o, do, lse, causal=causal, scale=scale,
                      softcap_val=softcap_val, window=window, q_pos0=q_pos0,
                      block_k=block_k, op_dtype=torch.float32)


def flash_attention_bwd_tc_ref(q, k, v, o, do, lse, *, causal=True,
                               scale=None, softcap_val=None, window=None,
                               q_pos0=0, block_k=64):
    """Plain mirror of the bf16 tensor-core backward kernel's rounding
    points: the logits are float32 sums of q·k, then scaled; P is rounded to
    q's dtype as the operand of Pᵀ·dO, and dS (from the unrounded P) as the
    operand of dS·K and dSᵀ·Q; the outputs are rounded once.  For float32
    inputs nothing is rounded and it is ``flash_attention_bwd_ref``.  No
    training path calls it."""
    return _flash_bwd(q, k, v, o, do, lse, causal=causal, scale=scale,
                      softcap_val=softcap_val, window=window, q_pos0=q_pos0,
                      block_k=block_k, op_dtype=q.dtype)


def _flash_bwd(q, k, v, o, do, lse, *, causal, scale, softcap_val, window,
               q_pos0, block_k, op_dtype):
    """The backward, with P and dS rounded to ``op_dtype`` as the operands
    of the three products they enter."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, S, KV, g, D).float()
    dof = do.reshape(B, S, KV, g, D).float()
    delta = (dof * o.reshape(B, S, KV, g, D).float()).sum(-1)  # (B,S,KV,g)
    delta = delta.permute(0, 2, 3, 1)[..., None]               # (B,KV,g,S,1)
    lse = lse.reshape(B, KV, g, S, 1).float()
    qpos = (torch.arange(S, device=q.device) + q_pos0)[:, None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for start in range(0, T, block_k):
        kc = k[:, start:start + block_k].float()
        vc = v[:, start:start + block_k].float()
        raw = torch.einsum("bskgd,btkd->bkgst", qf, kc) * scale
        if softcap_val is None:
            x, dcap = raw, 1.0
        else:
            t = torch.tanh(raw / softcap_val)
            x, dcap = softcap_val * t, 1.0 - t * t
        kpos = start + torch.arange(kc.shape[1], device=q.device)[None, :]
        keep = _mask(qpos, kpos, causal, window)
        p = torch.where(keep, torch.exp(x - lse), 0.0)
        dvs.append(torch.einsum("bkgst,bskgd->btkd", p.to(op_dtype).float(),
                                dof))
        dp = torch.einsum("bskgd,btkd->bkgst", dof, vc)
        ds = p * (dp - delta) * dcap
        ds = ds.to(op_dtype).float()
        dq += torch.einsum("bkgst,btkd->bskgd", ds, kc) * scale
        dks.append(torch.einsum("bkgst,bskgd->btkd", ds, qf) * scale)
    return (dq.reshape(B, S, H, D).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype), torch.cat(dvs, dim=1).to(v.dtype))


def decode_attention_ref(q, ck, cv, *, kv_len, scale=None, softcap_val=None,
                         window=None):
    """Single-token decode attention over a (B, T, KV, D) cache.

    kv_len is the number of valid cache entries (the new token is at
    kv_len-1).
    """
    B, S, H, D = q.shape
    if S != 1:
        raise ValueError(f"decode attention takes one query token, got S={S}")
    T, KV = ck.shape[1], ck.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, KV, g, D).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qf, ck.float()) * scale
    logits = _apply_softcap(logits, softcap_val)
    t = torch.arange(T, device=q.device)
    mask = t < kv_len
    if window is not None:
        mask &= t >= kv_len - window
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, cv.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_attention_split_ref(q, ck, cv, *, kv_len, scale=None,
                               softcap_val=None, window=None, splits=1):
    """``decode_attention_ref`` as the kernel's split path computes it: the
    attended positions [lo, hi) in ``splits`` runs of ceil((hi - lo) /
    splits), each run's unnormalised output o = sum_t exp(s_t - m) v_t, max
    m and sum l = sum_t exp(s_t - m), then the merge o = sum_r o_r
    exp(m_r - M) / sum_r l_r exp(m_r - M), M the largest m_r."""
    B, _, H, D = q.shape
    KV = ck.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lo = 0 if window is None else max(0, kv_len - window)
    chunk = -(-(kv_len - lo) // splits)
    qf = q.reshape(B, KV, g, D).float()
    os, ms, ls = [], [], []
    for a in range(lo, kv_len, chunk):
        b = min(kv_len, a + chunk)
        s = torch.einsum("bkgd,btkd->bkgt", qf, ck[:, a:b].float()) * scale
        s = _apply_softcap(s, softcap_val)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        os.append(torch.einsum("bkgt,btkd->bkgd", p, cv[:, a:b].float()))
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
    M = torch.stack(ms).amax(0)
    f = [torch.exp(m - M) for m in ms]
    out = sum(o * w for o, w in zip(os, f)) / sum(l * w for l, w in zip(ls, f))
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

def ssd_scan_ref(x, dt, A, B_, C, *, chunk=None):
    """Mamba2 state-space dual, sequential-over-time oracle.

    x: (B,S,H,P); dt: (B,S,H) > 0; A: (H,) < 0; B_, C: (B,S,N) shared by
    heads -> y (B,S,H,P).  State h (B,H,P,N):
    h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T;  y_t = h_t C_t.
    """
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B_.float(), C.float()
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dtf[:, t]
        decay = torch.exp(Af[None, :, None, None] * dtt[:, :, None, None])
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtt[..., None], Bf[:, t])
        h = h * decay + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def _states_entering(G, decay):
    """The inter-chunk recurrence h <- h * decay_c + G_c from h = 0: the
    state entering each chunk.  G: (B, nc, *state); decay broadcasts to G."""
    hst = torch.zeros_like(G[:, 0])
    h_in = []
    for c in range(G.shape[1]):
        h_in.append(hst)
        hst = hst * decay[:, c] + G[:, c]
    return torch.stack(h_in, dim=1)


def ssd_chunked_ref(x, dt, A, B_, C, *, chunk=64):
    """Chunked SSD (the algorithm of the scan kernels): an intra-chunk
    quadratic term plus an inter-chunk state recurrence."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    xf = x.float().reshape(Bb, nc, chunk, H, P)
    dtf = dt.float().reshape(Bb, nc, chunk, H)
    Bf = B_.float().reshape(Bb, nc, chunk, N)
    Cf = C.float().reshape(Bb, nc, chunk, N)
    Af = A.float()

    a = Af[None, None, None, :] * dtf  # (B,nc,L,H)
    acs = torch.cumsum(a, dim=2)

    # intra-chunk: y[t] = C_t . sum_{s<=t} exp(acs_t - acs_s) dt_s x_s B_s^T
    Lmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=x.device))
    acs_h = acs.permute(0, 1, 3, 2)  # (B,nc,H,L)
    diff = acs_h[..., :, None] - acs_h[..., None, :]  # (B,nc,H,t,s)
    decay_ts = torch.exp(torch.where(Lmask, diff, -torch.inf))
    cb = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    w = cb[:, :, None] * decay_ts
    y_intra = torch.einsum("bchts,bcsh,bcshp->bcthp", w, dtf, xf)

    # chunk summary state: G_c = sum_s exp(acs_L - acs_s) dt_s x_s B_s^T
    tail = torch.exp(acs[:, :, -1:, :] - acs)
    G = torch.einsum("bcsh,bcshp,bcsn->bchpn", tail * dtf, xf, Bf)
    chunk_decay = torch.exp(acs[:, :, -1, :])  # (B,nc,H)

    h_in = _states_entering(G, chunk_decay[..., None, None])  # (B,nc,H,P,N)

    y_inter = torch.einsum("bcth,bctn,bchpn->bcthp", torch.exp(acs), Cf, h_in)
    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    return y.to(x.dtype)


def ssd_subtile_ref(x, dt, A, B_, C, *, tile=64):
    """Plain mirror of the bf16 SSD kernel's design: the chunked algorithm
    at tiles of ``tile`` rows (a ragged last one cut, so any S), with the
    kernel's rounding points: W·x, C·hᵀ and the state update xᵀ·(tail·B)
    are split products in x's dtype (``_split_einsum``; x, B and C are exact
    in it, so each is hi·b + lo·b), exp(acs_t) scales C·hᵀ after the product,
    and the state is decayed and summed in float32.  For float32 inputs
    nothing is rounded.  No served path calls it."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B_.float(), C.float()
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, S, tile):
        xs, ds, bs, cs = (v[:, t0:t0 + tile] for v in (xf, dtf, Bf, Cf))
        n = xs.shape[1]
        acs = torch.cumsum(Af * ds, dim=1)  # (B,n,H)
        acs_h = acs.transpose(1, 2)  # (B,H,n)
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                       device=x.device))
        decay = torch.exp(torch.where(
            causal, acs_h[..., :, None] - acs_h[..., None, :], -torch.inf))
        w = torch.einsum("btn,bsn->bts", cs, bs)[:, None] * decay \
            * ds.transpose(1, 2)[:, :, None, :]  # (B,H,t,s)
        y = _split_einsum("bhts,bshp->bthp", w, xs, x.dtype) \
            + torch.exp(acs)[..., None] * _split_einsum(
                "btn,bhpn->bthp", cs, h, x.dtype)
        tail = torch.exp(acs[:, -1:] - acs) * ds  # (B,n,H)
        h = h * torch.exp(acs[:, -1])[..., None, None] + _split_einsum(
            "bshp,bshn->bhpn", xs, tail[..., None] * bs[:, :, None], x.dtype)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype)


def _pad_time(t, S, value=0.0):
    """``t`` in float32, padded along axis 1 to S."""
    t = t.float()
    pad = S - t.shape[1]
    if not pad:
        return t
    return torch.cat([t, t.new_full((t.shape[0], pad, *t.shape[2:]), value)],
                     dim=1)


def _exit_grads(Q, decay):
    """The gradient with respect to the state leaving each chunk, from the
    last chunk back: g_{nc-1} = 0, g_{c-1} = Q_c + decay_c g_c (Q_c: the
    gradient a chunk's own outputs put on the state entering it)."""
    g = torch.zeros_like(Q[:, 0])
    out = []
    for c in reversed(range(Q.shape[1])):
        out.append(g)
        g = Q[:, c] + decay[:, c] * g
    return torch.stack(out[::-1], dim=1)


def ssd_scan_bwd_ref(x, dt, A, B_, C, dy, *, chunk=64):
    """(dx, ddt, dA, dB, dC) of ``ssd_scan_ref``: the plain version of the
    backward kernel, chunk by chunk, no autograd.  Per chunk (acs the
    inclusive cumsum of A dt) the states h_t and h_{t-1} and the state
    gradients Gh_t = sum_{tau >= t} exp(acs_tau - acs_t) dy_tau C_tau^T +
    exp(acs_last - acs_t) g (g from the later chunks) are written out:
    dx = dt Gh B, dB = sum_h dt Gh^T x, dC = sum_h h^T dy, ddt = x.Gh B +
    A a <Gh, h_{t-1}>, dA = sum dt a <Gh, h_{t-1}>.  Any S (padded inside
    with x = dt = 0, inert).  dx in x's dtype, dB and dC in B_'s."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    L = min(chunk, S)
    Sp = -(-S // L) * L
    nc = Sp // L
    xf, yf = (_pad_time(t, Sp).reshape(Bb, nc, L, H, P) for t in (x, dy))
    dtf = _pad_time(dt, Sp).reshape(Bb, nc, L, H)
    Bf, Cf = (_pad_time(t, Sp).reshape(Bb, nc, L, N) for t in (B_, C))
    Af = A.float()
    a = Af * dtf
    acs = torch.cumsum(a, dim=2)
    tail = torch.exp(acs[:, :, -1:] - acs)
    G = torch.einsum("bcsh,bcshp,bcsn->bchpn", tail * dtf, xf, Bf)
    chunk_decay = torch.exp(acs[:, :, -1])[..., None, None]  # (B,nc,H,1,1)
    h_in = _states_entering(G, chunk_decay)
    Q = torch.einsum("bcth,bcthp,bctn->bchpn", torch.exp(acs), yf, Cf)
    g_out = _exit_grads(Q, chunk_decay)
    incl = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    outs = []
    for c in range(nc):
        ac = acs[:, c]  # (B,L,H)
        E = torch.exp(torch.where(incl[None, :, :, None],
                                  ac[:, :, None] - ac[:, None], -torch.inf))
        xc, yc, dc, bc, cc = xf[:, c], yf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        h = torch.exp(ac)[..., None, None] * h_in[:, c, None] + torch.einsum(
            "btsh,bsh,bshp,bsn->bthpn", E, dc, xc, bc)
        h_prev = torch.cat([h_in[:, c, None], h[:, :-1]], dim=1)
        gh = torch.einsum("bxth,bxhp,bxn->bthpn", E, yc, cc) + torch.exp(
            ac[:, -1:] - ac)[..., None, None] * g_out[:, c, None]
        q1 = torch.einsum("bthpn,btn->bthp", gh, bc)
        q2 = (gh * h_prev).sum((-1, -2))  # (B,L,H)
        decay = torch.exp(a[:, c])
        outs.append((dc[..., None] * q1,
                     (xc * q1).sum(-1) + Af * decay * q2,
                     (dc * decay * q2).sum((0, 1)),
                     torch.einsum("bthpn,bth,bthp->btn", gh, dc, xc),
                     torch.einsum("bthpn,bthp->btn", h, yc)))
    dx, ddt, dA, dB, dC = zip(*outs)
    return (torch.cat(dx, 1)[:, :S].to(x.dtype), torch.cat(ddt, 1)[:, :S],
            sum(dA), torch.cat(dB, 1)[:, :S].to(B_.dtype),
            torch.cat(dC, 1)[:, :S].to(C.dtype))


def _excl_cumsum(t, dim):
    """Exclusive cumsum along ``dim``: the running sum before each entry."""
    return torch.cumsum(t, dim) - t


def ssd_scan_bwd_tc_ref(x, dt, A, B_, C, dy, *, chunk=64):
    """Plain mirror of the bf16 SSD backward kernel: ``ssd_scan_bwd_ref``'s
    gradients in the kernel's chunk-parallel order and at its rounding
    points.  (a) Each 64-step chunk's summaries G = xᵀ (tail dt B) and
    Q = dyᵀ (exp(acs) C) with the scaled operand split (``_split_einsum``);
    (b) the scan over chunks (``_states_entering`` / ``_exit_grads``);
    (c) each chunk on its own, every product an L x L strip or an input
    times a split operand: dx = dt (Mᵀ dy + exp(acs_L - acs) B g_outᵀ) with
    M = C Bᵀ decayed; dC = M2 B + exp(acs) dy h_in with M2 = dy xᵀ decayed
    times dt; dB = dt (M3ᵀ C + exp(acs_L - acs) x g_out); and the decay's
    gradient <Gh_t, a_t h_{t-1}> expanded into the corner sums of
    Z = M2 o C Bᵀ (τ >= t > s), a reverse cumsum of the h_in side, a
    cumsum of the g_out side and exp(acs_L) <g_out, h_in>: every exponent
    a difference of cumsums <= 0, nothing cancels.  Any S (padded with
    x = dt = 0).  For float32 nothing is rounded.  No training path calls
    it."""
    op = x.dtype
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    L = chunk
    nc = -(-S // L)
    Sp = nc * L
    xf, yf = (_pad_time(t, Sp).reshape(Bb, nc, L, H, P) for t in (x, dy))
    dtf = _pad_time(dt, Sp).reshape(Bb, nc, L, H)
    Bf, Cf = (_pad_time(t, Sp).reshape(Bb, nc, L, N) for t in (B_, C))
    Af = A.float()
    acs = torch.cumsum(Af * dtf, dim=2)  # (B,nc,L,H)
    acs_l = acs[:, :, -1:]  # the chunk's last row (past S: dt = 0)
    tail = torch.exp(acs_l - acs)  # (B,nc,L,H)
    # (a) + (b)
    G = _split_einsum("bcshp,bcshn->bchpn", xf,
                      (tail * dtf)[..., None] * Bf[:, :, :, None], op)
    Q = _split_einsum("bcthp,bcthn->bchpn", yf,
                      torch.exp(acs)[..., None] * Cf[:, :, :, None], op)
    dec = torch.exp(acs_l[:, :, 0])[..., None, None]  # (B,nc,H,1,1)
    h_in = _states_entering(G, dec)
    g_out = _exit_grads(Q, dec)
    # (c): rows t, columns s (or τ) of each chunk, per head
    t_ge_s = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ah = acs.permute(0, 1, 3, 2)  # (B,nc,H,L)
    dts = dtf.permute(0, 1, 3, 2)
    # exp(acs_t - acs_s) for s <= t
    E = torch.exp(torch.where(t_ge_s, ah[..., :, None] - ah[..., None, :],
                              -torch.inf))
    cb = torch.einsum("bctn,bcsn->bcts", Cf, Bf)[:, :, None]  # (B,nc,1,t,s)
    dx_ = torch.einsum("bcthp,bcshp->bchts", yf, xf)  # dy_t . x_s
    MT = (cb * E).transpose(-1, -2)  # [t, τ] = C_τ.B_t exp(acs_τ - acs_t)
    M2 = dx_ * E * dts[..., None, :]  # [t, s]
    M3T = (dx_ * E).transpose(-1, -2)  # [t, τ] = x_t.dy_τ exp(..)
    tl = tail.permute(0, 1, 3, 2)[..., None]  # (B,nc,H,L,1)
    et = torch.exp(ah)[..., None]
    bg = _split_einsum("bctn,bchpn->bchtp", Bf, g_out, op)  # B_t g_out^T
    dxr = _split_einsum("bchtu,bcuhp->bchtp", MT, yf, op) + tl * bg
    dx = dts[..., None] * dxr
    dB = dts[..., None] * (_split_einsum("bchtu,bcun->bchtn", M3T, Cf, op)
                           + tl * _split_einsum("bcthp,bchpn->bchtn", xf,
                                                g_out, op))
    dC = _split_einsum("bchts,bcsn->bchtn", M2, Bf, op) \
        + et * _split_einsum("bcthp,bchpn->bchtn", yf, h_in, op)
    ch = _split_einsum("bctn,bchpn->bchtp", Cf, h_in, op)  # C_t h_in^T
    xt, yt = xf.permute(0, 1, 3, 2, 4), yf.permute(0, 1, 3, 2, 4)
    u = et[..., 0] * (yt * ch).sum(-1)  # (B,nc,H,L)
    v = tl[..., 0] * dts * (xt * bg).sum(-1)
    kk = torch.exp(acs_l[:, :, 0]) * (g_out * h_in).sum((-1, -2))  # (B,nc,H)
    Z = M2 * cb  # [τ, s], s <= τ
    corner = (torch.where(t_ge_s, _excl_cumsum(Z, -1), 0.0)).sum(-2)
    dla = corner + torch.flip(torch.cumsum(torch.flip(u, [-1]), -1), [-1]) \
        + _excl_cumsum(v, -1) + kk[..., None]
    ddt = (xt * dxr).sum(-1) + Af[:, None] * dla  # (B,nc,H,L)
    dA = (dts * dla).sum((0, 1, 3))

    def rows(t):  # (B,nc,H,L,*) -> (B,S,H,*)
        return t.transpose(2, 3).reshape(Bb, Sp, H, *t.shape[4:])[:, :S]
    return (rows(dx).to(x.dtype), rows(ddt[..., None])[..., 0], dA,
            rows(dB).sum(2).to(B_.dtype), rows(dC).sum(2).to(C.dtype))


def ssd_decode_ref(h, x, dt, A, B_, C):
    """One decode step. h: (B,H,P,N); x: (B,H,P); dt: (B,H); B_,C: (B,N)."""
    decay = torch.exp(A.float()[None, :, None, None] * dt[:, :, None, None])
    h = h * decay + torch.einsum("bhp,bn->bhpn", x * dt[..., None], B_)
    y = torch.einsum("bhpn,bn->bhp", h, C)
    return h, y.to(x.dtype)


# ---------------------------------------------------------------------------
# RWKV6 (Finch) WKV
# ---------------------------------------------------------------------------

def wkv6_scan_ref(r, k, v, w, u):
    """RWKV6 time-mix core, sequential oracle.

    r,k,v: (B,S,H,D); w: (B,S,H,D) per-step decay in (0,1); u: (H,D) bonus
    for the current token.  State (B,H,D,D):
    out_t = r_t . (S + u * k_t v_t^T);  S <- diag(w_t) S + k_t v_t^T.
    """
    Bb, S, H, D = r.shape
    rf, kf, vf, wf, uf = r.float(), k.float(), v.float(), w.float(), u.float()
    state = torch.zeros((Bb, H, D, D), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = torch.einsum("bhd,bhe->bhde", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhd,bhde->bhe", rf[:, t],
                               state + uf[None, :, :, None] * kv))
        state = state * wf[:, t, ..., None] + kv
    return torch.stack(ys, dim=1).to(r.dtype)


def _log_decay(w):
    return torch.log(torch.clamp(w.float(), 1e-12, 1.0))


def wkv6_chunked_ref(r, k, v, w, u, *, chunk=64):
    """Chunked WKV6 (the algorithm of the scan kernels), in float32.

    Within a chunk the (t,s) interactions use per-channel log-decay
    differences, exp(ecl_t - cl_s) for s < t; a (D,D) state is carried
    across chunks.
    """
    Bb, S, H, D = r.shape
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    rf = r.float().reshape(Bb, nc, chunk, H, D)
    kf = k.float().reshape(Bb, nc, chunk, H, D)
    vf = v.float().reshape(Bb, nc, chunk, H, D)
    lw = _log_decay(w).reshape(Bb, nc, chunk, H, D)
    uf = u.float()

    ecl = torch.cumsum(lw, dim=2) - lw  # exclusive cumsum over the chunk
    smask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=r.device), diagonal=-1)  # s < t
    e_t = ecl[:, :, :, None]  # (B,nc,t,1,H,D)
    e_s = (ecl + lw)[:, :, None]  # (B,nc,1,s,H,D)
    expo = torch.where(smask[:, :, None, None], e_t - e_s, -torch.inf)
    att = torch.einsum("bcthd,bctshd,bcshd->bctsh", rf, torch.exp(expo), kf)
    y_intra = torch.einsum("bctsh,bcshe->bcthe", att, vf)
    bonus = torch.einsum("bcthd,hd,bcthd->bcth", rf, uf, kf)
    y_bonus = bonus[..., None] * vf

    cl = ecl + lw
    tailw = torch.exp(cl[:, :, -1:] - cl)
    G = torch.einsum("bcshd,bcshe->bchde", tailw * kf, vf)
    chunk_decay = torch.exp(cl[:, :, -1])  # (B,nc,H,D)

    h_in = _states_entering(G, chunk_decay[..., None])  # (B,nc,H,D,D)
    y_inter = torch.einsum("bcthd,bchde->bcthe", rf * torch.exp(ecl), h_in)

    y = (y_intra + y_bonus + y_inter).reshape(Bb, S, H, D)
    return y.to(r.dtype)


def wkv6_scan_bwd_ref(r, k, v, w, u, dy, *, chunk=64):
    """(dr, dk, dv, dw, du) of ``wkv6_chunked_ref``: the plain version of the
    backward kernel, chunk by chunk, no autograd.  Per chunk (cl / ecl the
    inclusive / exclusive cumsums of lw = log clip(w, 1e-12, 1)) the states
    S_t entering each step and the state gradients G_{t+1} = sum_{tau > t}
    exp(ecl_tau - cl_t) r_tau dy_tau^T + exp(cl_last - cl_t) g (g from the
    later chunks) are written out: dr = S dy + u k (v.dy), dk = G v + r u
    (v.dy), dv = G^T k + (r.u.k) dy, dw = sum_e G S where w lies in [1e-12,
    1] (torch.clamp's gradient), du = sum r k (v.dy).  dw is read off the
    states, never divided by a decay.  Any S (padded inside with r = k = v
    = 0 and w = 1, inert).  dr, dk, dv in r's dtype; dw, du float32."""
    Bb, S, H, D = r.shape
    L = min(chunk, S)
    Sp = -(-S // L) * L
    nc = Sp // L
    rf, kf, vf, yf = (_pad_time(t, Sp).reshape(Bb, nc, L, H, D)
                      for t in (r, k, v, dy))
    wf = _pad_time(w, Sp, 1.0).reshape(Bb, nc, L, H, D)
    inside = (wf >= 1e-12) & (wf <= 1.0)
    lw = _log_decay(wf)
    uf = u.float()
    cl = torch.cumsum(lw, dim=2)
    ecl = cl - lw
    tailw = torch.exp(cl[:, :, -1:] - cl)
    G = torch.einsum("bcshd,bcshe->bchde", tailw * kf, vf)
    chunk_decay = torch.exp(cl[:, :, -1])[..., None]  # (B,nc,H,D,1)
    h_in = _states_entering(G, chunk_decay)
    Q = torch.einsum("bcthd,bcthe->bchde", rf * torch.exp(ecl), yf)
    g_out = _exit_grads(Q, chunk_decay)
    vy = (vf * yf).sum(-1, keepdim=True)  # (B,nc,L,H,1)
    ruk = (rf * uf * kf).sum(-1, keepdim=True)
    before = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    outs = []
    for c in range(nc):
        e, l = ecl[:, c], cl[:, c]  # (B,L,H,D)
        E = torch.exp(torch.where(before[None, :, :, None, None],
                                  e[:, :, None] - l[:, None], -torch.inf))
        rc, kc, vc, yc = rf[:, c], kf[:, c], vf[:, c], yf[:, c]
        st = torch.exp(e)[..., None] * h_in[:, c, None] + torch.einsum(
            "btshd,bshd,bshe->bthde", E, kc, vc)
        gt = torch.einsum("bxthd,bxhd,bxhe->bthde", E, rc, yc) + torch.exp(
            l[:, -1:] - l)[..., None] * g_out[:, c, None]
        outs.append((torch.einsum("bthde,bthe->bthd", st, yc)
                     + uf * kc * vy[:, c],
                     torch.einsum("bthde,bthe->bthd", gt, vc)
                     + rc * uf * vy[:, c],
                     torch.einsum("bthde,bthd->bthe", gt, kc)
                     + ruk[:, c] * yc,
                     torch.where(inside[:, c], (gt * st).sum(-1), 0.0),
                     (rc * kc * vy[:, c]).sum((0, 1))))
    dr, dk, dv, dw, du = zip(*outs)
    return tuple(torch.cat(t, 1)[:, :S].to(r.dtype) for t in (dr, dk, dv)) \
        + (torch.cat(dw, 1)[:, :S], sum(du))


def _rev_excl_cumsum(t, dim):
    """The sum of the entries after each one along ``dim``."""
    return torch.flip(_excl_cumsum(torch.flip(t, [dim]), dim), [dim])


def wkv6_scan_bwd_tc_ref(r, k, v, w, u, dy, *, chunk=64, sub=16):
    """Plain mirror of the bf16 WKV6 backward kernel: ``wkv6_scan_bwd_ref``'s
    gradients in the kernel's order and at its rounding points.  (a) Each
    64-step chunk's summaries G = (k exp(cl_L - cl))ᵀ v and
    Q = (r exp(ecl))ᵀ dy, the scaled operand split (``_split_einsum``);
    (b) the scan over chunks; (c) each 16-step sub-tile on its own: the
    state entering it S^j (h_in decayed plus the chunk's earlier rows) and
    the gradient leaving it G^j (g_out decayed plus the chunk's later rows),
    each a split product whose decays are sums anchored at the sub-tile's
    edge; then dY S^jᵀ, V G^jᵀ (S^j, G^j split) and the sub-tile's
    pairwise (t, s, d) terms with exponents ecl_t - cl_s <= 0; dv =
    attᵀ dY + (k exp(cL - cl)) G^j (both split) + the bonus; dw read off
    the states, sum_e G_{t+1} S_t, expanded into <G^j, S^j>, the G^j Vᵀ and
    S^j dYᵀ sides and the triple terms, each a product of factors <= 1,
    0 where clip(w, 1e-12, 1) cuts.  Any S (padded with r = k = v = 0,
    w = 1).  For float32 nothing is rounded.  No training path calls it."""
    op = r.dtype
    Bb, S, H, D = r.shape
    L = chunk
    nc = -(-S // L)
    Sp = nc * L
    rf, kf, vf, yf = (_pad_time(t, Sp).reshape(Bb, nc, L, H, D)
                      for t in (r, k, v, dy))
    wf = _pad_time(w, Sp, 1.0).reshape(Bb, nc, L, H, D)
    inside = (wf >= 1e-12) & (wf <= 1.0)
    lw = _log_decay(wf)
    uf = u.float()
    # (a) + (b)
    G = _split_einsum("bcshd,bcshe->bchde",
                      kf * torch.exp(_rev_excl_cumsum(lw, 2)), vf, op)
    Q = _split_einsum("bcthd,bcthe->bchde",
                      rf * torch.exp(_excl_cumsum(lw, 2)), yf, op)
    dec = torch.exp(lw.sum(2))[..., None]  # (B,nc,H,D,1)
    h_in = _states_entering(G, dec)
    g_out = _exit_grads(Q, dec)
    before = torch.tril(torch.ones((sub, sub), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    outs = []
    for a in range(0, L, sub):
        b = a + sub
        lb, la = lw[:, :, :a], lw[:, :, b:]
        st = torch.exp(lb.sum(2))[..., None] * h_in
        if a:
            st = st + _split_einsum(
                "bcshd,bcshe->bchde",
                kf[:, :, :a] * torch.exp(_rev_excl_cumsum(lb, 2)),
                vf[:, :, :a], op)
        gt = torch.exp(la.sum(2))[..., None] * g_out
        if b < L:
            gt = gt + _split_einsum(
                "bcthd,bcthe->bchde",
                rf[:, :, b:] * torch.exp(_excl_cumsum(la, 2)), yf[:, :, b:],
                op)
        rs, ks, vs, ys, ls = (t[:, :, a:b] for t in (rf, kf, vf, yf, lw))
        ecl = _excl_cumsum(ls, 2)
        cl = ecl + ls
        c_l = cl[:, :, -1:]
        # E1[t, s] = exp(ecl_t - cl_s) for s < t: (B,nc,t,s,H,D)
        E1 = torch.exp(torch.where(before[:, :, None, None],
                                   ecl[:, :, :, None] - cl[:, :, None],
                                   -torch.inf))
        sy = _split_einsum("bcthe,bchde->bcthd", ys, st, op)
        gv = _split_einsum("bcthe,bchde->bcthd", vs, gt, op)
        vy = torch.einsum("bcthe,bcshe->bchts", ys, vs)  # dy_t . v_s
        vyd = torch.diagonal(vy, dim1=-2, dim2=-1).permute(0, 1, 3, 2)
        vyd = vyd[..., None]  # dy_t . v_t, (B,nc,L,H,1)
        # att[t, s] (s < t) with the bonus r_t.u.k_t on its diagonal
        att = torch.einsum("bcthd,bctshd,bcshd->bchts", rs, E1, ks) \
            + torch.diag_embed((rs * uf * ks).sum(-1).transpose(2, 3))
        tail = torch.exp(c_l - cl)
        head = torch.exp(ecl)
        dv = _split_einsum("bchts,bcthe->bcshe", att, ys, op) \
            + _split_einsum("bcthd,bchde->bcthe", ks * tail, gt, op)
        dr = head * sy + torch.einsum("bctshd,bcshd,bchts->bcthd", E1, ks, vy) \
            + uf * ks * vyd
        dk = torch.einsum("bctshd,bcthd,bchts->bcshd", E1, rs, vy) \
            + tail * gv + rs * uf * vyd
        gs = (gt * st).sum(-1)[:, :, None]  # <G^j, S^j> by row d
        a2 = torch.einsum("bctshd,bcshd,bcshd->bcthd", E1, ks, gv)
        a3 = torch.einsum("bctshd,bcthd,bcthd->bcshd", E1, rs, sy)
        a4 = torch.einsum("bcxthd,bctshd,bcxhd,bcshd,bchxs->bcthd", E1, E1, rs,
                          ks, vy)
        dw = torch.where(inside[:, :, a:b],
                         tail * head * gs + tail * a2 + head * a3 + a4, 0.0)
        outs.append((dr, dk, dv, dw, (rs * ks * vyd).sum((0, 1, 2))))
    dr, dk, dv, dw, du = zip(*outs)

    def rows(ts):
        return torch.cat(ts, 2).reshape(Bb, Sp, H, D)[:, :S]
    return tuple(rows(t).to(r.dtype) for t in (dr, dk, dv)) \
        + (rows(dw), sum(du))


def _split_einsum(eq, a, b, dtype):
    """The kernel's split product: with x_hi = x rounded to ``dtype`` and
    x_lo = (x - x_hi) rounded to it, a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi
    summed in float32.  For float32 it is the plain product."""
    def split(x):
        hi = x.to(dtype).float()
        return hi, (x - hi).to(dtype).float()

    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo) \
        + torch.einsum(eq, a_hi, b_hi)


def wkv6_subtile_ref(r, k, v, w, u, *, sub=16):
    """Plain mirror of the WKV kernel's design: the chunked algorithm at
    chunks of ``sub`` rows (a ragged last one cut, so any S), with the
    kernel's rounding points: every product of att, r·exp(ecl),
    k·exp(cl_last - cl) or the state with v or the state is a split
    product in r's dtype (``_split_einsum``), the state is decayed and
    summed in float32.  For float32 inputs nothing is rounded.  No served
    path calls it."""
    Bb, S, H, D = r.shape
    f32 = torch.float32
    rf, kf, vf, uf = r.float(), k.float(), v.float(), u.float()
    lw = _log_decay(w)
    state = torch.zeros((Bb, H, D, D), dtype=f32, device=r.device)
    ys = []
    for t0 in range(0, S, sub):
        rs, ks, vs, ls = (x[:, t0:t0 + sub] for x in (rf, kf, vf, lw))
        n = rs.shape[1]
        cl = torch.cumsum(ls, dim=1)
        ecl = cl - ls
        smask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                      device=r.device), diagonal=-1)
        expo = torch.where(smask[:, :, None, None],
                           ecl[:, :, None] - cl[:, None], -torch.inf)
        att = torch.einsum("bthd,btshd,bshd->bhts", rs, torch.exp(expo), ks)
        att = att + torch.diag_embed(torch.einsum("bthd,hd,bthd->bht", rs, uf, ks))
        y = _split_einsum("bhts,bshe->bthe", att, vs, r.dtype) \
            + _split_einsum("bthd,bhde->bthe", rs * torch.exp(ecl), state,
                            r.dtype)
        ktail = ks * torch.exp(cl[:, -1:] - cl)
        state = state * torch.exp(cl[:, -1])[..., None] \
            + _split_einsum("bshd,bshe->bhde", ktail, vs, r.dtype)
        ys.append(y)
    return torch.cat(ys, dim=1).to(r.dtype)


def wkv6_blocked_ref(r, k, v, w, u, *, chunk=64, subchunk=16):
    """Blocked WKV6: off-diagonal sub-blocks factor per channel through the
    block-end reference c_j, exp(ecl_t - cl_s) = exp(ecl_t - c_j) *
    exp(c_j - cl_s), so only the (subchunk, subchunk, D) diagonal blocks keep
    the pairwise form.  Every (S, D)-sized factor and product operand is in
    r's dtype, the log-decay cumsum and the state in float32, with the
    reference's clamps (±60, -120…0) at the same places.
    """
    Bb, S, H, D = r.shape
    if S % chunk or chunk % subchunk:
        raise ValueError(f"S={S}, chunk={chunk}, subchunk={subchunk} do not "
                         "divide")
    nc, nb = S // chunk, chunk // subchunk
    L, Ls = chunk, subchunk
    cdt = r.dtype if r.dtype.is_floating_point else torch.bfloat16
    f32 = torch.float32
    rf = r.to(cdt).reshape(Bb, nc, nb, Ls, H, D)
    kf = k.to(cdt).reshape(Bb, nc, nb, Ls, H, D)
    vf = v.to(cdt).reshape(Bb, nc, nb, Ls, H, D)
    lw = _log_decay(w).reshape(Bb, nc, nb, Ls, H, D)
    uf = u.to(cdt)

    lw_c = lw.reshape(Bb, nc, L, H, D)
    cl = torch.cumsum(lw_c, dim=2)  # inclusive, float32
    ecl = cl - lw_c  # exclusive
    cl_b = cl.reshape(Bb, nc, nb, Ls, H, D)
    ecl_b = ecl.reshape(Bb, nc, nb, Ls, H, D)
    cj = cl_b[:, :, :, -1]  # (B,nc,nb,H,D): block end

    # diagonal sub-blocks: exact pairwise form
    smask = torch.tril(torch.ones((Ls, Ls), dtype=torch.bool, device=r.device),
                       diagonal=-1)
    expo = torch.where(smask[:, :, None, None],
                       ecl_b[:, :, :, :, None] - cl_b[:, :, :, None, :],
                       -torch.inf)
    att_d = torch.einsum("bcnthd,bcntshd,bcnshd->bcntsh", rf,
                         torch.exp(expo).to(cdt), kf).to(cdt)
    y = torch.einsum("bcntsh,bcnshe->bcnthe", att_d, vf).to(f32)

    # off-diagonal: factored through the block-end reference c_j
    ke = kf * torch.exp(torch.clamp(cj[:, :, :, None] - cl_b, -60.0, 60.0)).to(cdt)
    kv = torch.einsum("bcnshd,bcnshe->bcnhde", ke, vf).to(f32)
    state = torch.zeros((Bb, nc, H, D, D), dtype=f32, device=r.device)
    ref_c = None
    for i in range(nb):
        if i > 0:
            qi = rf[:, :, i] * torch.exp(torch.clamp(
                ecl_b[:, :, i] - ref_c[:, :, None], -120.0, 0.0)).to(cdt)
            y[:, :, i] += torch.einsum("bcthd,bchde->bcthe", qi,
                                       state.to(cdt)).to(f32)
        if i == 0:
            state = kv[:, :, 0]
        else:
            decay = torch.exp(torch.clamp(cj[:, :, i] - ref_c, -120.0, 0.0))
            state = state * decay[..., None] + kv[:, :, i]
        ref_c = cj[:, :, i]

    # current-token bonus
    bonus = torch.einsum("bcnthd,hd,bcnthd->bcnth", rf, uf, kf).to(f32)
    y = y + bonus[..., None] * vf.to(f32)

    # inter-chunk: carry the full (D,D) state across chunks
    kf_c = kf.reshape(Bb, nc, L, H, D)
    vf_c = vf.reshape(Bb, nc, L, H, D)
    tailw = torch.exp(torch.clamp(cl[:, :, -1:] - cl, -120.0, 0.0)).to(cdt)
    G = torch.einsum("bcshd,bcshe->bchde", tailw * kf_c, vf_c).to(f32)
    chunk_decay = torch.exp(cl[:, :, -1])

    h_in = _states_entering(G, chunk_decay[..., None])
    y_inter = torch.einsum("bcthd,bchde->bcthe",
                           rf.reshape(Bb, nc, L, H, D) * torch.exp(ecl).to(cdt),
                           h_in.to(cdt)).to(f32)
    y = y.reshape(Bb, nc, L, H, D) + y_inter
    return y.reshape(Bb, S, H, D).to(r.dtype)


def wkv6_decode_ref(state, r, k, v, w, u):
    """One decode step. state: (B,H,D,D); r,k,v,w: (B,H,D); u: (H,D)."""
    kv = torch.einsum("bhd,bhe->bhde", k.float(), v.float())
    out = torch.einsum("bhd,bhde->bhe", r.float(),
                       state + u.float()[None, :, :, None] * kv)
    state = state * w.float()[..., None] + kv
    return state, out.to(r.dtype)
