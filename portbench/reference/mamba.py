"""Plain reference of the ``mamba`` family (falcon-mamba-7b): pre-norm
mamba-1 mixers, then the final norm and the LM head.

Float32 throughout, written from the layer equations:

  h = rms(x) g;  u = h W_x, z = h W_gate
  u = silu(causal_conv(u, w_conv) + b_conv)
  (dt_low, B, C) = u W_proj;  dt = softplus(dt_low W_dt + b_dt)
  y = selective_scan(u, dt, -exp(A_log), B, C, D) * silu(z)
  x = x + y W_out
  logits = rms(x) g_f W_head
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import common as C
from portbench.reference.scan import selective_scan

SEG = ("dec", 0, "b0_mamba", "mix")


def layout(m: Mapping) -> List[Tuple[Tuple, Tuple[int, ...], str, str]]:
    D, Di, N, R, Wc, V, L = (m["d_model"], m["d_inner"], m["ssm_state"],
                             m["dt_rank"], m["conv_width"], m["vocab"],
                             m["layers"])
    dt = m["dtype"]
    s = SEG
    out = [
        (("io", "tok"), (V, D), dt, "normal:0.02"),
        (("io", "norm_f", "scale"), (D,), "float32", "ones"),
        (s + ("norm", "scale"), (L, D), "float32", "ones"),
        (s + ("in_x",), (L, D, Di), dt, "fan_in:1"),
        (s + ("in_gate",), (L, D, Di), dt, "fan_in:1"),
        (s + ("conv_w",), (L, Wc, Di), dt, f"normal:{Wc ** -0.5}"),
        (s + ("conv_b",), (L, Di), dt, "zeros"),
        (s + ("x_proj",), (L, Di, R + 2 * N), dt, "fan_in:1"),
        (s + ("dt_proj",), (L, R, Di), dt, "fan_in:1"),
        (s + ("dt_bias",), (L, Di), "float32", "dt_bias:0.001:0.1"),
        (s + ("a_log",), (L, Di, N), "float32", "a_log"),
        (s + ("d_skip",), (L, Di), "float32", "ones"),
        (s + ("out_proj",), (L, Di, D), dt, "fan_in:1"),
    ]
    if not m.get("tie_embeddings"):
        out.append((("io", "out"), (D, V), dt, "fan_in:0"))
    return out


def layer(lp: Dict[str, Any], x: torch.Tensor, m: Mapping,
          quant: bool) -> torch.Tensor:
    N, R = m["ssm_state"], m["dt_rank"]
    h = C.rms_norm(x, lp["norm"]["scale"], m["norm_eps"])
    u = C.mm(h, lp["in_x"], quant)
    z = C.mm(h, lp["in_gate"], quant)
    w = lp["conv_w"]  # (Wc, Di)
    Wc, S = w.shape[0], u.shape[1]
    up = torch.nn.functional.pad(u, (0, 0, Wc - 1, 0))
    u = sum(up[:, i:i + S] * w[i] for i in range(Wc)) + lp["conv_b"]
    u = C.silu(u)
    dbc = C.mm(u, lp["x_proj"], quant)
    dt_low, bm, cm = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    dt = C.softplus(C.mm(dt_low, lp["dt_proj"], quant) + lp["dt_bias"])
    y = selective_scan(u, dt, -torch.exp(lp["a_log"]), bm, cm, lp["d_skip"])
    return x + C.mm(y * C.silu(z), lp["out_proj"], quant)


def _layers(params) -> List[Dict[str, Any]]:
    return C.unbind_layers(C.get(params, SEG))


def final_hidden(params, tokens: torch.Tensor, m: Mapping,
                 quant: bool) -> torch.Tensor:
    x = C.stream(params["io"]["tok"][tokens.long()], quant)
    grad = torch.is_grad_enabled()
    for lp in _layers(params):
        x = C.stream(checkpoint(layer, lp, x, m, quant, use_reentrant=False)
                     if grad else layer(lp, x, m, quant), quant)
    return C.rms_norm(x, params["io"]["norm_f"]["scale"], m["norm_eps"])


def head(params, m: Mapping) -> torch.Tensor:
    io = params["io"]
    return io["tok"].T if m.get("tie_embeddings") else io["out"]
