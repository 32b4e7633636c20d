"""Plain reference of the ``dense`` family (granite-34b): pre-norm
blocks of causal multi-query attention with rotary positions and an
ungated (or gated) MLP, then the final norm and the LM head.

Float32 throughout, written from the layer equations:

  h = rms(x) g_a;  q = h Wq, k = h Wk, v = h Wv;  rope(q), rope(k)
  x = x + softmax(q k^T / sqrt(Dh) + causal) v Wo
  h = rms(x) g_m;  x = x + act(h Wi) Wo'          (act(h Wg) * (h Wi) if gated)
  logits = rms(x) g_f Wout

The parameters come as the benchmark made them (the program's layout,
stacked on a leading layer axis) and are widened to float32 here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import common as C

SEG = ("dec", 0, "b0_global")


def layout(m: Mapping) -> List[Tuple[Tuple, Tuple[int, ...], str, str]]:
    """``(path, shape, dtype, init rule)`` of every parameter."""
    D, H, KH, Dh, F, V, L = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                             m["head_dim"], m["d_ff"], m["vocab"], m["layers"])
    dt = m["dtype"]
    a, p = SEG + ("attn",), SEG + ("mlp",)
    out = [
        (("io", "tok"), (V, D), dt, "normal:0.02"),
        (("io", "norm_f", "scale"), (D,), "float32", "ones"),
        (a + ("norm", "scale"), (L, D), "float32", "ones"),
        (a + ("wq",), (L, D, H, Dh), dt, "fan_in:1"),
        (a + ("wk",), (L, D, KH, Dh), dt, "fan_in:1"),
        (a + ("wv",), (L, D, KH, Dh), dt, "fan_in:1"),
        (a + ("wo",), (L, H * Dh, D), dt, "fan_in:1"),
        (p + ("norm", "scale"), (L, D), "float32", "ones"),
        (p + ("wi",), (L, D, F), dt, "fan_in:1"),
        (p + ("wo",), (L, F, D), dt, "fan_in:1"),
    ]
    if m.get("mlp_gated"):
        out.append((p + ("wg",), (L, D, F), dt, "fan_in:1"))
    if not m.get("tie_embeddings"):
        out.append((("io", "out"), (D, V), dt, "fan_in:0"))
    return out


def _attention(q, k, v, c0: int, scale: float) -> torch.Tensor:
    """Causal attention of the queries at positions ``c0 ..`` over keys
    ``0 .. c0 + len(q)``: q (B, c, H, Dh), k / v (B, c0 + c, KH, Dh)."""
    B, c, H, Dh = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, c, KH, H // KH, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    qpos = torch.arange(c0, c0 + c, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(B, c, H * Dh)


def layer(lp: Dict[str, Any], x: torch.Tensor, m: Mapping, quant: bool,
          chunk: int = 1024) -> torch.Tensor:
    B, S, D = x.shape
    H, KH, Dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m["norm_eps"]
    grad = torch.is_grad_enabled()
    h = C.rms_norm(x, lp["attn"]["norm"]["scale"], eps)
    pos = torch.arange(S, device=x.device)
    q = C.rope(C.mm(h, lp["attn"]["wq"], quant), pos, m["rope_theta"])
    k = C.rope(C.mm(h, lp["attn"]["wk"], quant), pos, m["rope_theta"])
    v = C.mm(h, lp["attn"]["wv"], quant)
    scale = 1.0 / math.sqrt(Dh)
    outs = []
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        args = (q[:, c0:c1], k[:, :c1], v[:, :c1], c0, scale)
        outs.append(checkpoint(_attention, *args, use_reentrant=False)
                    if grad else _attention(*args))
    o = torch.cat(outs, dim=1)
    x = x + C.mm(o, lp["attn"]["wo"], quant)
    h = C.rms_norm(x, lp["mlp"]["norm"]["scale"], eps)
    act = C.gelu_tanh if m["act"] == "gelu_tanh" else C.silu
    if m.get("mlp_gated"):
        z = act(C.mm(h, lp["mlp"]["wg"], quant)) * C.mm(h, lp["mlp"]["wi"], quant)
    else:
        z = act(C.mm(h, lp["mlp"]["wi"], quant))
    return x + C.mm(z, lp["mlp"]["wo"], quant)


def _layers(params) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked segment, taken apart by one
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would add a zero tensor of the whole
    stacked leaf for every layer."""
    return C.unbind_layers(C.get(params, SEG))


def final_hidden(params, tokens: torch.Tensor, m: Mapping,
                 quant: bool) -> torch.Tensor:
    """The normed hidden state after the last layer, (B, S, D)."""
    x = C.stream(params["io"]["tok"][tokens.long()], quant)
    grad = torch.is_grad_enabled()
    for lp in _layers(params):
        x = C.stream(checkpoint(layer, lp, x, m, quant, use_reentrant=False)
                     if grad else layer(lp, x, m, quant), quant)
    return C.rms_norm(x, params["io"]["norm_f"]["scale"], m["norm_eps"])


def head(params, m: Mapping) -> torch.Tensor:
    io = params["io"]
    return io["tok"].T if m.get("tie_embeddings") else io["out"]
