"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

``flash_attention_ref`` is the plain version of the CUDA flash kernel: the CPU
path of the port, the yardstick ``chip_smoke.py`` holds the kernel against on
the card, and the ``use_pallas="never"`` path.  It is chunked over KV blocks
with the same online softmax, so its memory stays O(S·block).  It computes in
the Pallas kernel's order: ``q·scale`` in float32, the dot, softcap, then the
mask.  ``flash_attention_tc_ref`` mirrors the bf16 tensor-core kernel's
rounding points (the logits scaled after the product, P rounded to bf16).

``naive_attention`` is the O(S²) oracle, in the reference's own order (dot,
then scale).  ``decode_attention_ref`` is one token against a cache; the
reference has no kernel for it, so it stays plain on every device.

The scans follow the reference function for function: ``ssd_scan_ref`` and
``wkv6_scan_ref`` are the sequential oracles; ``ssd_chunked_ref`` and
``wkv6_chunked_ref`` are the chunked algorithms the CUDA scan kernels
compute, and their yardsticks on the card; ``wkv6_blocked_ref`` is the
factored form with the reference's bf16 casts and clamps (the CPU path of
``wkv_impl="blocked"``); ``wkv6_subtile_ref`` mirrors the WKV kernel's
16-row chunks and split bf16 products, ``ssd_subtile_ref`` the SSD kernel's
64-row tiles and split products; the ``*_decode_ref`` functions are one
decode step, plain on every device as in the reference.  The three mirrors
are for tests only: no served path calls them.
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
                              q_pos0, block_k, scale_logits, p_dtype):
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
    return out.to(q.dtype).contiguous()


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
