"""A configuration, a mix, a metric or a kernel-name file added as a new
file is taken up by name, with no edit of a file already there."""

import json
import shutil

from portbench import manifest as mf
from portbench.trace import Categories


def test_new_files_are_found_without_an_edit(tmp_path):
    src = mf.ROOT
    root = tmp_path / "portbench"
    shutil.copytree(src, root, ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(mf.manifest_path(src).read_text())
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
              if p.is_file()}

    cfg = json.loads((root / "configs" / "granite-34b.json").read_text())
    cfg["name"] = "granite-34b-deep"
    (root / "configs" / "granite-34b-deep.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "train.8k.json").read_text())
    mix["seq_len"] = 16384
    (root / "traffic" / "train.16k.json").write_text(json.dumps(mix))
    (root / "metrics" / "steps.train.py").write_text(
        "def read(obs):\n    return obs.get('steps')\n")
    (root / "kernels" / "extra.json").write_text(json.dumps(
        {"own": True, "patterns": {"rglru.fwd": ["\\blru_kernel\\b"]}}))
    (root / "limits" / "granite-34b-deep.train.16k.json").write_text(
        (root / "limits" / "granite-34b.train.8k.json").read_text())

    man["configs"].append(dict(man["configs"][0], name="granite-34b-deep",
                               file="portbench/configs/granite-34b-deep.json"))
    man["workloads"].append({"name": "granite-34b-deep.train.16k",
                             "config": "granite-34b-deep", "traffic": "train.16k",
                             "chips": 1, "why": "a longer context"})
    man["per_layer"].append({"name": "steps.train", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "whole step", "moves": "train_tok_s",
                             "workloads": ["granite-34b-deep.train.16k"]})
    for m in man["end_to_end"]:
        if m["name"] == "train_tok_s":
            m["workloads"].append("granite-34b-deep.train.16k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    got = mf.load_manifest(root)
    assert mf.problems(got, root) == []
    w = mf.cell(got, "granite-34b-deep.train.16k")
    assert mf.config(w["config"], root)["name"] == "granite-34b-deep"
    assert mf.mix(w["traffic"], root)["seq_len"] == 16384
    assert callable(mf.driver("train", root).run)
    names = [m["name"] for m in mf.metrics_of(got, w["name"], trace=True)]
    assert names == ["steps.train"]
    assert mf.reader("steps.train", root)({"steps": 7}) == 7
    cats = Categories(root / "kernels")
    assert cats.of("void (anonymous namespace)::lru_kernel<float>(float*)") == "rglru.fwd"
    assert cats.of("nvjet_tst_192x192") == "gemm"
    assert "rglru.fwd" in cats.own

    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and p.relative_to(root) in before}
    assert after == before  # nothing that was there changed


def test_a_manifest_that_names_a_missing_file_is_refused(tmp_path):
    src = mf.ROOT
    root = tmp_path / "portbench"
    shutil.copytree(src, root, ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(mf.manifest_path(src).read_text())
    man["per_layer"].append(dict(man["per_layer"][0], name="nothing.train"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    assert mf.problems(mf.load_manifest(root), root) == [
        "reader of nothing.train"]
