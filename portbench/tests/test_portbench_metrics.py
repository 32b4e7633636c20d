"""Each per-layer metric's arithmetic on synthetic profiler sums."""

import pytest

from portbench import manifest as mf, work
from portbench.trace import Categories, Spans, reduce

from conftest import SERVE_MIX

GRANITE = mf.config("granite-34b")["model"]
FALCON = mf.config("falcon-mamba-7b")["model"]


def read(name, obs):
    return mf.reader(name)(obs)


def _trace(by_cat, busy=9.0, own=("flash.fwd", "flash.dkv", "flash.dq",
                                  "ssm_scan.fwd", "ssm_scan.bwd",
                                  "ssm_scan.bwd_reduce", "paged_attention")):
    return {"seen": True, "by_cat": by_cat, "busy_s": busy, "own": list(own)}


def test_training_splits_and_shares():
    mix = mf.mix("train.8k")
    cats = {"gemm": {"s": 3.0, "n": 100}, "other": {"s": 4.0, "n": 900},
            "copy": {"s": 0.5, "n": 4},
            "flash.fwd": {"s": 0.2, "n": 16}, "flash.dkv": {"s": 0.6, "n": 8},
            "flash.dq": {"s": 0.3, "n": 8}}
    obs = {"model": GRANITE, "mix": mix, "trace": _trace(cats, busy=8.0),
           "window_s": 10.0, "steps": 4, "flops": 4e15, "peak_bytes": 3 * 2**30}
    assert read("elementwise_ms.train", obs) == pytest.approx(1e3 * 4.0 / 4)
    assert read("gemm_ms.train", obs) == pytest.approx(1e3 * 3.0 / 4)
    assert read("device_idle.train", obs) == pytest.approx(20.0)
    assert read("mfu.train", obs) == pytest.approx(100 * 4e15 / (10 * 989e12))
    assert read("peak_gib.train", obs) == pytest.approx(3.0)
    w = work.flash_work(1, 48, 1, 8192, 8192, 128, True, None, "bfloat16")
    bound = (16 * max(w["fwd"][0] / 3.35e12, w["fwd"][1] / 989e12)
             + 8 * max(w["dkv"][0] / 3.35e12, w["dkv"][1] / 989e12)
             + 8 * max(w["dq"][0] / 3.35e12, w["dq"][1] / 989e12))
    assert read("flash_roofline.train", obs) == pytest.approx(100 * bound / 1.1)
    assert read("scan_roofline.train", obs) is None  # no scan in a dense model


def test_scan_roofline():
    mix = mf.mix("train.2x4k")
    cats = {"ssm_scan.fwd": {"s": 0.5, "n": 64}, "ssm_scan.bwd": {"s": 1.0, "n": 32},
            "ssm_scan.bwd_reduce": {"s": 0.1, "n": 64}}
    obs = {"model": FALCON, "mix": mix, "trace": _trace(cats)}
    case = (2, 4096, 8192, 16)
    fb, ff = work.scan_work("fwd", case, "bfloat16")
    bb, bf = work.scan_work("bwd", case, "bfloat16")
    bound = 64 * max(fb / 3.35e12, ff / 989e12) + 32 * max(bb / 3.35e12, bf / 989e12)
    assert read("scan_roofline.train", obs) == pytest.approx(100 * bound / 1.6)
    assert read("flash_roofline.train", obs) is None


def test_serving_ticks_and_paged_attention():
    mix = SERVE_MIX
    ticks = ([{"s": 0.1 * (i + 1), "admitted": 1, "live": 8} for i in range(20)]
             + [{"s": 0.02, "admitted": 0, "live": 8}] * 9
             + [{"s": 0.03, "admitted": 0, "live": 8}] * 10
             + [{"s": 5.0, "admitted": 0, "live": 0}])
    lengths = [[100, 2000], [101, 2001]]
    cats = {"paged_attention": {"s": 1e-3, "n": 16}}
    obs = {"model": GRANITE, "mix": mix, "trace": _trace(cats, busy=6.0),
           "window_s": 8.0, "ticks": ticks, "paged_lengths": lengths,
           "page_tokens": 16, "flops": 2e14}
    # p95 of 100..2000 ms in steps of 100: 1905 ms (interpolated)
    assert read("prefill_tick_ms_p95.serve", obs) == pytest.approx(1905.0)
    assert read("decode_tick_ms_p50.serve", obs) == pytest.approx(30.0)
    nb = sum(work.paged_attention_work(l, 48, 1, 128, 16, "bfloat16")[0]
             for l in lengths)
    assert read("paged_attention_roofline.serve", obs) == pytest.approx(
        100 * 8 * nb / 3.35e12 / 1e-3)
    assert read("device_idle.serve", obs) == pytest.approx(25.0)
    assert read("mfu.serve", obs) == pytest.approx(100 * 2e14 / (8 * 989e12))


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = {"model": GRANITE, "mix": mf.mix("train.8k"), "trace": {"seen": False}}
    for m in mf.load_manifest()["per_layer"]:
        assert read(m["name"], empty) is None, m["name"]


def test_reduce_busy_gaps_and_categories():
    cats = Categories()
    spans = Spans()
    spans.items.append(("server tick", 100.0, 101.0))
    ev = [("marker", 10.0, 10.001),
          ("void flash::(anonymous namespace)::fwd_bf16_kernel<128>(x)", 10.1, 10.2),
          ("nvjet_tst_192x192_64x3", 10.15, 10.3),
          ("Memcpy DtoH (Device -> Pageable)", 10.4, 10.45),
          ("void (anonymous namespace)::ssm_scan_bwd_kernel<bf16, 16>(x)", 10.6, 10.7),
          ("void (anonymous namespace)::reduce_bc<bf16>(x)", 10.7, 10.71)]
    red = reduce(ev, cats, host_t0=100.0, spans=spans, default_label="between")
    assert red["busy_s"] == pytest.approx(0.001 + 0.2 + 0.05 + 0.11)
    assert red["by_cat"]["flash.fwd"] == {"s": pytest.approx(0.1), "n": 1}
    assert red["by_cat"]["gemm"]["n"] == 1
    assert red["by_cat"]["copy"]["n"] == 1
    assert red["by_cat"]["ssm_scan.bwd"]["n"] == 1
    assert red["by_cat"]["ssm_scan.bwd_reduce"]["n"] == 1
    assert red["by_cat"]["other"]["n"] == 1  # the marker
    # longest gap first: 10.45 -> 10.6 lies in the host's tick span
    assert red["idle_gaps"][0] == ["server tick", pytest.approx(0.15)]
    assert red["device_ops"][0][0].startswith("nvjet")
