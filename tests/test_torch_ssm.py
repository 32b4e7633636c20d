"""The port's selective scan and causal conv against the JAX reference.

The plain selective scan against the reference's ``lax.scan`` oracle and
its Pallas kernel (interpret mode), the final state against the
reference's ``_mamba_final_state``, strided B/C views, the causal conv,
and ``launch.serve --full``.  The falcon-mamba-7b model itself is held
against the reference in ``tests/test_torch_recurrent.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import ssm_scan as jssm
from repro.models import layers as jlayers
from repro_torch.configs.registry import SMOKE
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan
from repro_torch.launch import serve
from repro_torch.models import layers

ARCH = "falcon-mamba-7b"
# the reference's own kernel-vs-oracle tolerance (tests/test_kernels.py)
SCAN_TOL = 3e-5
# the reference's selective-scan test shapes: B, S, Di, N, block_d, block_s
SCAN_SHAPES = [(2, 128, 256, 16, 128, 32), (1, 64, 512, 16, 512, 64),
               (2, 96, 128, 8, 64, 32)]


def _scan_inputs(B, S, Di, N, seed=0):
    """Value ranges as the model makes them: dt a softplus output in
    [1e-3, 1e-1], A = -(1..N) per channel, x, B, C and D of order one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, Di)).astype(np.float32)
    dt = rng.uniform(1e-3, 1e-1, size=(B, S, Di)).astype(np.float32)
    a = -np.tile(np.arange(1, N + 1, dtype=np.float32), (Di, 1))
    a *= rng.uniform(0.5, 1.0, size=(Di, 1)).astype(np.float32)
    b = rng.normal(size=(B, S, N)).astype(np.float32)
    c = rng.normal(size=(B, S, N)).astype(np.float32)
    d = rng.normal(size=(Di,)).astype(np.float32)
    return x, dt, a, b, c, d


@pytest.mark.parametrize("B,S,Di,N,bd,bs", SCAN_SHAPES)
def test_plain_scan_matches_oracle_and_pallas_kernel(B, S, Di, N, bd, bs):
    args = _scan_inputs(B, S, Di, N)
    got = ref.selective_scan(*map(torch.from_numpy, args)).numpy()
    oracle = np.asarray(jref.selective_scan(*map(jnp.asarray, args)))
    pallas = np.asarray(jssm.selective_scan(
        *map(jnp.asarray, args), block_d=bd, block_s=bs, interpret=True))
    np.testing.assert_allclose(got, oracle, atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(got, pallas, atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("S", [1, 37])
def test_final_state_matches_reference(S):
    """``ops.selective_scan(final_state=True)`` on the CPU: the plain scan
    and the plain second scan, which the reference's
    ``_mamba_final_state`` computes; odd S, B > 1."""
    x, dt, a, b, c, d = _scan_inputs(3, S, 64, 16, seed=1)
    y, h = ops.selective_scan(*map(torch.from_numpy, (x, dt, a, b, c, d)),
                              final_state=True)
    want = np.asarray(jlayers._mamba_final_state(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(b)))
    assert h.dtype == torch.float32 and h.shape == (3, 64, 16)
    np.testing.assert_allclose(h.numpy(), want, atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jref.selective_scan(*map(jnp.asarray, (
            x, dt, a, b, c, d)))), atol=SCAN_TOL, rtol=SCAN_TOL)


def test_scan_takes_strided_b_and_c_views():
    """B and C as the layer slices them out of one projection."""
    x, dt, a, b, c, d = _scan_inputs(2, 19, 32, 8, seed=2)
    dbc = torch.from_numpy(np.concatenate(
        [np.zeros((2, 19, 5), np.float32), b, c], -1))
    bv, cv = dbc[..., 5:13], dbc[..., 13:]
    assert not bv.is_contiguous()
    t = [torch.from_numpy(v) for v in (x, dt, a)]
    got = ops.selective_scan(*t, bv, cv, torch.from_numpy(d))
    want = ref.selective_scan(*t, torch.from_numpy(b), torch.from_numpy(c),
                              torch.from_numpy(d))
    assert torch.equal(got, want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only: CPU data goes to the
    plain version through ``ops``, never to a silent fallback."""
    args = [torch.from_numpy(v) for v in _scan_inputs(1, 4, 8, 4)]
    before = ssm_scan.selective_scan.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssm_scan.selective_scan(*args)
    with pytest.raises(ValueError, match="no selective_scan"):
        ops.selective_scan(*[t.to("meta") for t in args])
    assert ssm_scan.selective_scan.launches == before


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 16)).astype(np.float32) if with_state else None
    jy, js = jlayers.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
    ty, ts = layers.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_serve_main_full_serves_the_published_config(capsys, monkeypatch):
    """``--full`` (documented in the README) takes the config from ARCHS,
    not SMOKE: with ARCHS swapped for a 2-layer cut, the run shows it."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import build

    cut = dataclasses.replace(SMOKE[ARCH], n_layers=2)
    monkeypatch.setattr(registry, "ARCHS", {ARCH: cut})
    built = []
    real = build.build_model
    monkeypatch.setattr(build, "build_model",
                        lambda cfg: built.append(cfg) or real(cfg))
    serve.main(["--arch", ARCH, "--full", "--device", "cpu", "--requests", "2",
                "--batch", "2", "--max-new", "2"])
    assert built == [cut]
    assert "requests: 2" in capsys.readouterr().out
