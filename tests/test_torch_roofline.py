"""Roofline math on the H100's peaks (``launch/roofline.py``), the
reference's formulas by value, and one home for the card's constants.

``model_flops`` and ``analytic_memory_bytes`` equal the reference's for
all 33 runnable cells at 1, 256 and 512 chips; ``derive`` is checked with
the H100's constants as ``tests/test_roofline.py`` checks it with the
TPU's; ``chip_smoke.py``'s kernel bounds, now from ``kernels/cost.py``,
are the numbers of ``PERF.md`` §6's bound column.
"""

import json

import pytest
import torch

import chip_smoke
from repro.configs.registry import runnable_cells as j_runnable_cells
from repro.launch import roofline as jroofline
from repro_torch.configs.registry import runnable_cells
from repro_torch.kernels import cost
from repro_torch.launch import roofline

CELLS = runnable_cells()


def test_runnable_cells_count():
    # 10 archs x 4 shapes - 7 long_500k skips = 33
    assert len(CELLS) == 33 and CELLS == j_runnable_cells()
    assert ("llama3-405b", "long_500k") not in CELLS
    assert ("falcon-mamba-7b", "long_500k") in CELLS


@pytest.mark.parametrize("arch,shape", CELLS)
def test_formulas_equal_the_reference(arch, shape):
    assert roofline.model_flops(arch, shape) == jroofline.model_flops(
        arch, shape)
    for chips in (1, 256, 512):
        assert roofline.analytic_memory_bytes(arch, shape, chips) == \
            jroofline.analytic_memory_bytes(arch, shape, chips)


def test_model_flops_train_vs_decode():
    t = roofline.model_flops("qwen3-4b", "train_4k")
    d = roofline.model_flops("qwen3-4b", "decode_32k")
    p = roofline.model_flops("qwen3-4b", "prefill_32k")
    assert t / d == (3 * 4096 * 256) / 128
    assert p / d == 32768 * 32 / 128


def _rec(**kw):
    rec = {
        "status": "ok", "arch": "qwen3-4b", "shape": "train_4k",
        "mesh": "single", "tag": "t", "n_devices": 256,
        "cost": {"flops": 1e14, "bytes_accessed": 1e12},
        "collectives": {"per_type": {}, "total": 5e12},
        "memory": {},
    }
    rec.update(kw)
    return rec


def test_derive_terms_and_dominance_on_h100_peaks():
    d = roofline.derive(_rec())
    assert abs(d["t_compute_s"] - 1e14 / 989e12) < 1e-12
    want_mem = roofline.analytic_memory_bytes("qwen3-4b", "train_4k", 256)
    assert abs(d["t_memory_s"] - want_mem / 3.35e12) < 1e-12
    assert d["sched_bytes_dev"] == 1e12
    # a collective's operand read once and written once at the HBM rate
    assert abs(d["t_collective_s"] - 2 * 5e12 / 3.35e12) < 1e-12
    assert d["dominant"] == "collective"
    assert 0 < d["roofline_fraction"] <= 1.5
    assert roofline.derive({"status": "error"}) is None


def test_derive_divides_global_counts_by_the_chips():
    per_dev = roofline.derive(_rec())
    glob = roofline.derive(_rec(counts="global",
                                cost={"flops": 256e14, "bytes_accessed": 256e12},
                                collectives={"per_type": {}, "total": 256 * 5e12}))
    for k in ("t_compute_s", "t_memory_s", "t_collective_s",
              "roofline_fraction", "useful_ratio"):
        assert abs(glob[k] - per_dev[k]) <= 1e-9 * abs(per_dev[k])
    # a cell cut from the registry's shape prices its own dims
    cut = roofline.derive(_rec(shape_dims={"kind": "train", "seq_len": 4096,
                                           "global_batch": 2}, n_devices=1,
                               memory={"argument_size_in_bytes": 81e9}))
    assert cut["model_flops"] == 6.0 * 4096 * 2 * \
        roofline.ARCHS["qwen3-4b"].param_counts()[1]
    assert cut["fits_one_card"] is False and cut["arg_bytes_dev"] == 81e9


def test_table_reads_records(tmp_path):
    for i, rec in enumerate([_rec(memory={"argument_size_in_bytes": 4e9}),
                             {**_rec(), "status": "error", "error": "boom"}]):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    out = roofline.table(str(tmp_path))
    lines = out.splitlines()
    assert lines[0].startswith("| arch | shape | mesh |") and len(lines) == 4
    assert "**collective**" in lines[2] and "| 4.00 | yes |" in lines[2]
    assert "ERROR: boom" in lines[3]


def test_card_constants_have_one_home():
    assert chip_smoke.HBM_BYTES_PER_S is cost.HBM_BYTES_PER_S == 3.35e12
    assert chip_smoke.PEAK_FLOPS is cost.PEAK_FLOPS
    assert cost.PEAK_FLOPS == {torch.bfloat16: 989e12, torch.float32: 67e12}
    assert roofline.HBM_BYTES_PER_S is cost.HBM_BYTES_PER_S


def _us(ms):
    return round(1e3 * ms, 3)


def test_chip_smoke_bounds_are_perf_md_bound_column():
    """Every bound of ``PERF.md`` §6's table, as ``chip_smoke.py`` prints
    it from ``kernels/cost.py``, to the digit."""
    c = chip_smoke
    bf16, f32 = torch.bfloat16, torch.float32
    lens = c.kernel_phase_lengths()
    assert _us(c.kernel_bound_ms(bf16, lens)[0]) == 2.466
    assert _us(c.kernel_bound_ms(f32, lens)[0]) == 4.932
    assert _us(c.kernel_bound_ms(bf16, c.SERVED_LENGTHS)[0]) == 1.487
    assert [_us(c.kernel_bound_ms(bf16, lens, hq, hkv)[0])
            for hq, hkv in c.ZOO_HEADS] == [0.362, 2.584]
    row = (1 << 24)  # 16 MiB a rank, 8 ranks
    assert [_us(1e3 * cost.gascore_bytes(n, 8, row) / cost.HBM_BYTES_PER_S)
            for n in ("ring_shift", "perm_put", "offset_put",
                      "ring_all_gather", "ring_reduce_scatter")] == [
        80.130, 80.130, 80.130, 360.585, 45.073]
    names = ("flash_attention_fwd", "flash_attention_dkv", "flash_attention_dq")
    train = {dt: c.flash_bounds(c.TRAIN_SHAPE + (dt,)) for dt in (bf16, f32)}
    assert [_us(train[bf16][n]["bound_ms"]) for n in names] == [
        69.518, 139.035, 104.277]
    assert [_us(train[f32][n]["bound_ms"]) for n in names] == [
        1026.165, 2052.329, 1539.247]
    zoo = [c.flash_bounds(case) for case in c.FLASH_ZOO]
    assert [[_us(z[n]["bound_ms"]) for z in zoo] for n in names] == [
        [8.685, 104.277, 60.807], [17.371, 208.553, 121.614],
        [13.028, 156.415, 91.210]]
    ssm, lru = c.SSM_FULL[0], c.LRU_FULL[0]
    assert _us(c.scan_bounds("selective_scan", ssm, bf16)["bound_ms"]) == 10.349
    assert _us(c.scan_bounds("selective_scan", ssm, f32)["bound_ms"]) == 15.367
    assert _us(c.scan_bounds("gated_linear_scan", lru, f32)["bound_ms"]) == 37.561
    assert _us(c.scan_bounds("gated_linear_scan", lru, bf16)["bound_ms"]) == 18.780
    assert [_us(c.router_bounds(T, 384, 8)["bound_ms"])
            for T in (128, 8, 8192)] == [0.063, 0.004, 4.010]


def test_attention_pairs_closed_form_equals_the_mask():
    from repro_torch.kernels import ref

    for Sq, Sk, causal, window in [(64, 64, True, None), (64, 64, False, None),
                                   (96, 96, True, 20), (64, 64, False, 7),
                                   (48, 80, True, None), (80, 48, False, 9),
                                   (32, 32, True, 0)]:
        want = int(ref.attention_mask(Sq, Sk, causal, window, "cpu").sum())
        assert cost.attention_pairs(Sq, Sk, causal, window) == want
