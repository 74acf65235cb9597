"""Every file of the benchmark is found by its name, and BENCHMARK.json
keeps to the benchmark's contract."""
import json
import re
import shutil

import pytest

from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [m for m in b["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_finds_its_files(cell):
    from harness import registry
    conf = registry.spec(REPO, cell)
    assert conf["traffic"]["driver"] in ("train", "serve")
    assert registry.driver(conf["traffic"]["driver"]).run
    assert conf["cell"]["limits"]
    flops = registry.flops(conf)
    assert flops["train"] > flops["forward"] > 0
    for m in conf["per_layer"]:
        assert callable(registry.layer_metric(conf, m["name"]))


@pytest.mark.parametrize("config", [c["name"] for c in _bench()["configs"]])
def test_the_programs_flags_state_the_configuration(config):
    """The flags the program parses give the sizes and the optimizer that
    the reference reads from the same file."""
    from byol_tpu_torch import cli
    b = _bench()
    entry = next(c for c in b["configs"] if c["name"] == config)
    conf = json.loads((REPO / entry["file"]).read_text())
    cfg = cli.config_from_args(cli.build_parser().parse_args(conf["flags"]))
    opt = conf["optimizer"]
    assert cfg.device.half
    assert cfg.task.image_size_override == conf["image_size"]
    assert cfg.model.head_latent_size == conf["heads"]["head_latent_size"]
    assert cfg.model.projection_size == conf["heads"]["projection_size"]
    assert (cfg.optim.optimizer, cfg.optim.lr, cfg.optim.warmup,
            cfg.task.epochs) == (opt["name"], opt["lr"],
                                 opt["warmup_epochs"], opt["epochs"])
    assert cfg.regularizer.weight_decay == opt["weight_decay"]
    assert cfg.model.base_decay == opt["base_decay"]
    assert cfg.regularizer.polyak_ema == opt["polyak_ema"]


def test_a_new_cell_is_found_with_no_edit(tmp_path):
    """A cell added as files and an entry of BENCHMARK.json runs through
    the same registry, with no file of the harness edited."""
    from harness import registry
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    b["workloads"].append({"name": "rn50.train.b1024", "config": "rn50_byol",
                           "traffic": "train.b1024", "chips": 1,
                           "why": "a new cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = json.loads((BENCH / "traffic" / "train.b4096.json").read_text())
    traffic.update(batch_size=1024, accum_steps=4)
    (tmp_path / "benchmark" / "traffic" / "train.b1024.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "cells" / "rn50.train.b1024.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.1}}))
    conf = registry.spec(tmp_path, "rn50.train.b1024")
    assert conf["traffic"]["batch_size"] == 1024
    assert conf["cell"]["limits"] == {"loss_gap": 0.1}
    assert [m["name"] for m in conf["end_to_end"]] == ["setup_s"]
