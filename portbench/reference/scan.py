"""The selective scan of mamba-1 in plain PyTorch, float32, with its
gradient written out.

  h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   h_0 = 0
  y_t = C_t . h_t + D x_t

x, dt (B, S, Di); A (Di, N); B, C (B, S, N); D (Di,).  Channels are
independent, so both passes run over blocks of channels, each holding
its (B, S, block, N) states only while it is worked.  In time, the
linear recurrence h_t = a_t h_{t-1} + b_t is an inclusive scan of the
pairs (a, b), taken in place by doubling (log2 S levels); the backward is the same
scan run in reverse, g_t = dh_t + a_{t+1} g_{t+1}, then

  da_t = g_t h_{t-1},  db_t = g_t,
  dA += sum da a dt,  ddt += sum_n (da a A + db x B),
  dx += sum_n db dt B + dy D,  dB += sum_c db dt x,  dC += sum_c dy h.
"""

from __future__ import annotations

import torch

BLOCK_BYTES = 1 << 28  # one (B, S, block, N) f32 tensor of a block


def _doubling(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1 (h_{-1} =
    0), in place on ``a`` and ``b`` (both consumed; the result is ``b``).

    Level by level, each pair of adjacent blocks of ``w`` steps becomes
    one: the second block's steps compose with the first block's last,
    which is already final.  Time is padded to a power of two with
    identity steps (a = 1, b = 0)."""
    S = a.shape[1]
    P = 1 << max(S - 1, 0).bit_length()
    if P != S:
        pad = [0, 0] * (a.dim() - 2) + [0, P - S]
        a = torch.nn.functional.pad(a, pad, value=1.0)
        b = torch.nn.functional.pad(b, pad, value=0.0)
    rest = a.shape[2:]
    w = 1
    while w < P:
        av = a.view(a.shape[0], P // (2 * w), 2, w, *rest)
        bv = b.view(b.shape[0], P // (2 * w), 2, w, *rest)
        bv[:, :, 1].addcmul_(av[:, :, 1], bv[:, :, 0, w - 1:w])
        av[:, :, 1].mul_(av[:, :, 0, w - 1:w])
        w *= 2
    return b[:, :S]


def _block(Bsz: int, S: int, Di: int, N: int) -> int:
    return max(1, min(Di, BLOCK_BYTES // max(Bsz * S * N * 4, 1)))


def _states(x, dt, A, Bm, sl):
    """a = exp(dt A) and h over the channels ``sl``: (B, S, c, N)."""
    dtc = dt[:, :, sl]
    a = torch.exp(dtc[..., None] * A[sl])
    b = (dtc * x[:, :, sl])[..., None] * Bm[:, :, None, :]
    return a, _doubling(a.clone(), b)


class SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D):
        Bsz, S, Di = x.shape
        N = A.shape[1]
        y = torch.empty_like(x)
        blk = _block(Bsz, S, Di, N)
        for c0 in range(0, Di, blk):
            sl = slice(c0, min(c0 + blk, Di))
            _, h = _states(x, dt, A, Bm, sl)
            y[:, :, sl] = torch.einsum("bscn,bsn->bsc", h, Cm) + D[sl] * x[:, :, sl]
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, Cm, D = ctx.saved_tensors
        Bsz, S, Di = x.shape
        N = A.shape[1]
        dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
        dA, dD = torch.zeros_like(A), torch.zeros_like(D)
        dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
        blk = _block(Bsz, S, Di, N)
        for c0 in range(0, Di, blk):
            sl = slice(c0, min(c0 + blk, Di))
            a, h = _states(x, dt, A, Bm, sl)
            dyc, xc, dtc = dy[:, :, sl], x[:, :, sl], dt[:, :, sl]
            dC += torch.einsum("bsc,bscn->bsn", dyc, h)
            dh = dyc[..., None] * Cm[:, :, None, :]
            # reverse scan: g_t = dh_t + a_{t+1} g_{t+1}
            ar = torch.zeros_like(a)
            ar[:, :-1] = a[:, 1:]
            g = _doubling(ar.flip(1), dh.flip(1)).flip(1)
            del ar, dh
            hprev = torch.zeros_like(h)
            hprev[:, 1:] = h[:, :-1]
            da_a = g * hprev * a  # da * a
            del hprev, h
            ddt[:, :, sl] += torch.einsum("bscn,cn->bsc", da_a, A[sl])
            dA[sl] += torch.einsum("bscn,bsc->cn", da_a, dtc)
            del da_a
            gB = torch.einsum("bscn,bsn->bsc", g, Bm)  # sum_n db B
            ddt[:, :, sl] += gB * xc
            dx[:, :, sl] += gB * dtc + dyc * D[sl]
            dB += torch.einsum("bscn,bsc->bsn", g, dtc * xc)
            dD[sl] += (dyc * xc).sum((0, 1))
        return dx, ddt, dA, dB, dC, dD


def selective_scan(x, dt, A, Bm, Cm, D) -> torch.Tensor:
    return SelectiveScan.apply(x, dt, A, Bm, Cm, D)
