"""The plain reference's pieces, in PyTorch: the precision it computes in,
norms, rotary embeddings, attention and the two scans.  The layer kinds
(``portbench/layers/<kind>.py``) build on them.

It computes in float32 with TF32 off, or, for the control, with every
operand of a product rounded to float8 e4m3 at a scale per tensor.  It
imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

FP8_MAX = 448.0  # largest finite float8 e4m3


class Precision:
    """``float32`` leaves an operand as it is; ``fp8`` rounds it to
    float8 e4m3 at the scale amax / 448 (the gradient passes straight
    through).  ``carry=False`` drops the state the scans carry from one
    chunk to the next: a fault planted to show that the comparison sees
    it."""

    def __init__(self, name: str = "float32", carry: bool = True):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}: float32 | fp8")
        self.name = name
        self.carry = carry

    @property
    def exact(self) -> bool:
        """The reference itself: float32 with every chunk's state."""
        return self.name == "float32" and self.carry

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        xd = x.detach()
        s = xd.abs().amax().clamp_min(1e-30) / FP8_MAX
        y = (xd / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return x + (y - xd)

    def mm(self, a, b):
        return self(a) @ self(b)


def pin_float32() -> None:
    """Full float32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False



def rmsnorm(x, s, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + s)


def rope(x, positions, theta):
    """x (B, S, H, D) rotated by position in two halves."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, window, prec, heads_a_block=8):
    """Causal softmax attention, keys at most ``window - 1`` positions back;
    q, k, v (B, S, H, D) with as many key heads as query heads."""
    B, S, H, D = q.shape
    t = torch.arange(S, device=q.device)
    keep = (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - window)
    outs = []
    for h0 in range(0, H, heads_a_block):
        sl = slice(h0, h0 + heads_a_block)
        qh, kh, vh = (z[:, :, sl].transpose(1, 2) for z in (q, k, v))
        logits = prec(qh) @ prec(kh).transpose(-1, -2) / math.sqrt(D)
        p = torch.softmax(logits.masked_fill(~keep, float("-inf")), -1)
        outs.append((prec(p) @ prec(vh)).transpose(1, 2))
    return torch.cat(outs, 2)


def causal_conv(x, w):
    """Depthwise causal conv: out_t = sum_i w_i x_{t - W + 1 + i}."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(W))


def _chunks(S, chunk):
    return -(-S // chunk) * chunk - S


def ssd(x, dt, A, Bm, Cm, chunk=64, carry=True):
    """y_t = C_t h_t with h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T, h_0 = 0,
    by chunks: the pairs inside a chunk as a masked product, the state
    carried between chunks (zeroed with ``carry=False``).  x (B,S,H,P),
    dt (B,S,H), A (H), B, C (B,S,N)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = _chunks(S, chunk)
    x, Bm, Cm = (F.pad(z, (0, 0) * (z.dim() - 2) + (0, pad)) for z in (x, Bm, Cm))
    dt = F.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    x = x.reshape(Bb, nc, chunk, H, P)
    dt = dt.reshape(Bb, nc, chunk, H)
    Bm, Cm = Bm.reshape(Bb, nc, chunk, N), Cm.reshape(Bb, nc, chunk, N)
    acs = torch.cumsum(dt * A, 2)  # (B,nc,L,H)
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                  device=x.device))
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]  # (B,nc,t,s,H)
    decay = torch.exp(seg.masked_fill(~lower[:, :, None], float("-inf")))
    cb = torch.einsum("bctn,bcsn->bcts", Cm, Bm)
    w = cb[..., None] * decay * dt[:, :, None]
    y = torch.einsum("bctsh,bcshp->bcthp", w, x)
    tail = torch.exp(acs[:, :, -1:] - acs) * dt
    G = torch.einsum("bcsh,bcshp,bcsn->bchpn", tail, x, Bm)
    cdecay = torch.exp(acs[:, :, -1])  # (B,nc,H)
    h = torch.zeros_like(G[:, 0])
    h_in = []
    for c in range(nc):
        h_in.append(h if carry else torch.zeros_like(h))
        h = h * cdecay[:, c, :, None, None] + G[:, c]
    y = y + torch.einsum("bcth,bctn,bchpn->bcthp", torch.exp(acs), Cm,
                         torch.stack(h_in, 1))
    return y.reshape(Bb, nc * chunk, H, P)[:, :S]


def wkv(r, k, v, lw, u, chunk=16, carry=True):
    """RWKV6's WKV: out_t = r_t (S_{t-1} + diag(u) k_t v_t^T) with
    S_t = diag(w_t) S_{t-1} + k_t v_t^T, from the log-decays lw = log w,
    by chunks (the state between chunks zeroed with ``carry=False``);
    every exponent inside a chunk is <= 0.  r, k, v, lw (B,S,H,D); u
    (H,D)."""
    Bb, S, H, D = r.shape
    pad = _chunks(S, chunk)
    r, k, v, lw = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (r, k, v, lw))
    nc = r.shape[1] // chunk
    r, k, v, lw = (z.reshape(Bb, nc, chunk, H, D) for z in (r, k, v, lw))
    cl = torch.cumsum(lw, 2)
    ecl = cl - lw
    before = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    expo = ecl[:, :, :, None] - cl[:, :, None]  # (B,nc,t,s,H,D)
    expo = expo.masked_fill(~before[:, :, None, None], float("-inf"))
    att = torch.einsum("bcthd,bctshd,bcshd->bctsh", r, torch.exp(expo), k)
    y = torch.einsum("bctsh,bcshe->bcthe", att, v)
    y = y + torch.einsum("bcthd,hd,bcthd->bcth", r, u, k)[..., None] * v
    G = torch.einsum("bcshd,bcshe->bchde", torch.exp(cl[:, :, -1:] - cl) * k, v)
    cdecay = torch.exp(cl[:, :, -1])  # (B,nc,H,D)
    h = torch.zeros_like(G[:, 0])
    h_in = []
    for c in range(nc):
        h_in.append(h if carry else torch.zeros_like(h))
        h = h * cdecay[:, c, :, :, None] + G[:, c]
    y = y + torch.einsum("bcthd,bchde->bcthe", r * torch.exp(ecl),
                         torch.stack(h_in, 1))
    return y.reshape(Bb, nc * chunk, H, D)[:, :S]


def shift(x):
    """The sequence moved one position later, zeros first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]
