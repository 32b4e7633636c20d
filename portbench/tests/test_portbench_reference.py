"""The plain reference against the program's CPU path at the port's
``SMOKE`` widths (float32), and the reference scan against the
recurrence step by step."""

import copy
import time

import pytest
import torch

from portbench import harness, manifest as mf, program, weights
from portbench.reference import common as C, family, logits_at
from portbench.reference import scan

from conftest import tiny_mix

MIXES = {"granite-34b": "train.8k", "falcon-mamba-7b": "train.2x4k"}


def smoke_config(name):
    from repro_torch.configs.registry import SMOKE

    cfg = copy.deepcopy(mf.config(name))
    s = SMOKE[cfg["arch"]]
    m = cfg["model"]
    for key, field in program.FIELDS.items():
        if key in m:
            m[key] = getattr(s, field)
    m["dtype"] = "float32"
    return cfg


@pytest.mark.parametrize("name", sorted(MIXES))
def test_forward_logits_agree(name):
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx

    cfg = smoke_config(name)
    m = cfg["model"]
    specs = family(m["family"]).layout(m)
    model = build_model(program.arch_config(cfg))
    assert weights.check_layout(specs, model.abstract_init(RunCtx())[0]) == []
    params = weights.make_tree(specs, 2**31 + 5, "cpu")
    toks = torch.randint(0, m["vocab"], (1, 48), generator=torch.Generator().manual_seed(3))
    got = model.train_logits(params, RunCtx(remat="none"), {"inputs": toks})[0]
    want = logits_at(m, params, toks[0], range(48))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()


@pytest.mark.parametrize("name", sorted(MIXES))
def test_training_readings_agree(name):
    r = harness.Run(workload={"name": name, "chips": 1}, cfg=smoke_config(name),
                    mix=tiny_mix(MIXES[name]), seed=2**31 + 12345, seconds=1.0,
                    trace=False, device=torch.device("cpu"),
                    t_start=time.monotonic(), limits={})
    drv = mf.driver("train")
    from portbench import check
    from portbench.traffic import train as traffic

    m = r.cfg["model"]
    specs = family(m["family"]).layout(m)
    host = traffic.batches(r.mix, m["vocab"], r.seed)
    p = drv.program_readings(r, specs, host, keep_first=True)
    ref = drv.reference_readings(r, specs, host, keep_first=True)
    numbers = check.training_numbers(p, ref)
    assert "grad_diff" in numbers
    for k, v in numbers.items():
        assert v["value"] < 1e-4, (k, v)


def test_scan_matches_the_recurrence_and_its_gradient():
    g = torch.Generator().manual_seed(0)
    B, S, Di, N = 2, 37, 5, 3
    f64 = dict(dtype=torch.float64)
    x = torch.randn(B, S, Di, generator=g, **f64).requires_grad_()
    dt = (torch.rand(B, S, Di, generator=g, **f64) * 0.5).requires_grad_()
    A = (-torch.rand(Di, N, generator=g, **f64) * 3).requires_grad_()
    Bm = torch.randn(B, S, N, generator=g, **f64).requires_grad_()
    Cm = torch.randn(B, S, N, generator=g, **f64).requires_grad_()
    D = torch.randn(Di, generator=g, **f64).requires_grad_()

    def stepwise(x, dt, A, Bm, Cm, D):
        h = torch.zeros(B, Di, N, **f64)
        ys = []
        for t in range(S):
            h = torch.exp(dt[:, t, :, None] * A) * h + (
                dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
            ys.append((h * Cm[:, t, None, :]).sum(-1) + D * x[:, t])
        return torch.stack(ys, 1)

    ins = [x, dt, A, Bm, Cm, D]
    y1, y2 = scan.selective_scan(*ins), stepwise(*ins)
    w = torch.randn(y1.shape, generator=g, **f64)
    g1 = torch.autograd.grad((y1 * w).sum(), ins)
    g2 = torch.autograd.grad((y2 * w).sum(), ins)
    assert torch.allclose(y1, y2, atol=1e-12)
    for a, b in zip(g1, g2):
        assert torch.allclose(a, b, atol=1e-11)


def test_fp8_control_rounds_to_float8():
    x = torch.linspace(-3, 3, 1001)
    q = C.fp8_round(x)
    assert not torch.equal(q, x)
    assert len(torch.unique(q)) <= 256  # float8 holds 256 codes
    # e4m3 keeps 3 mantissa bits: a rounding moves at most 2**-4 of a value
    assert bool(((q - x).abs() <= 2 ** -4 * x.abs() + 1e-6).all())
