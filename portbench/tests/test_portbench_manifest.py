"""BENCHMARK.json and the files it names."""

import json

import pytest

from portbench import manifest as mf, program


def test_manifest_is_sound():
    man = mf.load_manifest()
    assert mf.problems(man) == []
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_keep_to_the_charset(key):
    for entry in mf.load_manifest()[key]:
        assert mf.NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert mf.UNIT.match(entry["unit"]), entry["unit"]
        for field in ("why", "layer", "source"):
            if field in entry:
                assert 1 <= len(entry[field]) <= 200 and "\n" not in entry[field]


def test_every_cell_finds_its_files_by_name():
    man = mf.load_manifest()
    for w in man["workloads"]:
        cfg = mf.config(w["config"])
        mix = mf.mix(w["traffic"])
        assert cfg["name"] == w["config"]
        assert callable(mf.driver(mix["kind"]).run)
        for m in mf.metrics_of(man, w["name"], trace=True):
            assert callable(mf.reader(m["name"]))
        ends = {m["name"] for m in mf.metrics_of(man, w["name"], trace=False)}
        assert "setup_s" in ends and len(ends) >= 2
        assert mf.metrics_of(man, w["name"], trace=True)


def test_per_layer_metrics_move_a_metric_their_cells_report():
    man = mf.load_manifest()
    for m in man["per_layer"]:
        for w in m["workloads"]:
            ends = {e["name"] for e in mf.metrics_of(man, w, trace=False)}
            assert m["moves"] in ends, (m["name"], w)


@pytest.mark.parametrize("name", ["granite-34b", "falcon-mamba-7b"])
def test_configs_keep_the_ports_widths_and_cut_only_what_they_list(name):
    from repro_torch.configs.registry import ARCHS

    cfg = mf.config(name)
    man = {c["name"]: c for c in mf.load_manifest()["configs"]}
    if name in man:  # falcon's file is here with no cell (PERF.md)
        assert man[name]["reduced"] == list(cfg["reduced"])
    ours = program.arch_config(cfg)
    port = ARCHS[cfg["arch"]]
    for field in program.FIELDS.values():
        if field == "n_layers":
            assert ours.n_layers == cfg["reduced"][next(iter(cfg["reduced"]))][1]
            assert port.n_layers == cfg["reduced"][next(iter(cfg["reduced"]))][0]
        else:
            assert getattr(ours, field) == getattr(port, field), field
    assert ours.dtype == port.dtype
    assert len(json.dumps(cfg["source"])) <= 202
