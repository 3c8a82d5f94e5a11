"""chip_smoke.py's ``fleet`` phase, and its ``serve`` phase on both
servers, rehearsed on the CPU at a small size.

The fleet phase starts a store server, two model_builder replicas
(``LO_FLEET_REPLICA`` 0 and 1, rf 2) and the router as child processes,
waits for both heartbeats to list the five checkpoints, builds Titanic
on replica 0 and checks its publish-time warmups, reads an async build's
``/wait`` as an event stream, drives closed loops through the router and
straight at replica 0 (every answer held to the plain CPU forward), and
kills the drill model's primary with -9 under load.

Here the children run ``main(device='cpu')`` and count their plain
K6 forwards as launches (which only the card's kernels count); the
closed loops are cut to 4 clients x 5 requests and the drill's to 4 x 20.
The serve phase runs with its server's plane and app on the CPU and the
launch counts stubbed; it must serve on the loop, then on the threaded
server and on the loop again.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu_torch.ml.checkpoint import load_model  # noqa: E402
from learningorchestra_tpu_torch.serve import ServePlane  # noqa: E402
from learningorchestra_tpu_torch.services.model_builder import create_app  # noqa: E402
from tests.test_torch_smoke_batch import Launches  # noqa: E402

# a replica or router child on the CPU whose plain K6 forwards count as
# the card's launches would
CPU_FLEET_CHILD = """
from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.ml import trees

def counted(plain, name):
    def call(*args, **kwargs):
        kernels.count_launch(name)
        return plain(*args, **kwargs)
    return call

trees._ensemble_forward = counted(trees._ensemble_forward, "tree_ensemble_forward")
trees._gbt_forward = counted(trees._gbt_forward, "gbt_forward")
from learningorchestra_tpu_torch.services.runner import main
main(device="cpu")
"""


@pytest.fixture()
def fleet_on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "FLEET_COMMAND", [sys.executable, "-c", CPU_FLEET_CHILD])
    monkeypatch.setattr(chip_smoke, "FLEET_CHILD_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "FLEET_CLIENTS", 4)
    monkeypatch.setattr(chip_smoke, "FLEET_REQUESTS", 5)
    monkeypatch.setattr(chip_smoke, "FLEET_DRILL_REQUESTS", 20)
    monkeypatch.setattr(chip_smoke, "FLEET_KILL_AFTER", 10)
    monkeypatch.setattr(chip_smoke, "load_model", lambda path, device="cpu": load_model(path, device="cpu"))


def test_fleet_phase_runs_on_the_cpu(fleet_on_the_cpu, capsys):
    record = chip_smoke.phase_fleet(torch, "cpu rehearsal")
    assert sorted(record["boot_s"]) == ["replica0", "replica1", "router", "store"]
    assert set(record["warmup"]["jobs"].values()) == {"finished"} and len(record["warmup"]["jobs"]) == 5
    assert all(added == {"jit_compiles": 0, "registry_misses": 0}
               for added in record["warmup"]["first_predicts"].values())
    assert record["sse_done_frame"] is True
    assert sorted(record["load"]) == [f"{label}:{rows}" for label in ("replica0", "router") for rows in (1, 64)]
    assert all(loop["answers_checked"] == 20 for loop in record["loops"].values())
    assert all(sum(counts.values()) > 0 for counts in record["launches"].values())
    drill = record["drill"]
    assert drill["answers"] == 80 and drill["killed_after_answers"] < 80
    assert drill["retries"]["after_kill"] > drill["retries"]["before"]
    assert drill["retries"]["after_recovery"] == drill["retries"]["after_kill"]
    assert drill["health"] == {str(drill["killed_replica"]): False, str(1 - drill["killed_replica"]): True}
    out = capsys.readouterr().out
    assert '"phase": "fleet"' in out


def test_serve_phase_runs_on_both_servers(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "create_app", lambda store, **kw: create_app(store, device="cpu", **kw))
    monkeypatch.setattr(chip_smoke, "ServePlane", lambda: ServePlane(device="cpu"))
    monkeypatch.setattr(chip_smoke, "kernels", Launches())
    monkeypatch.setattr(chip_smoke.serve_config, "max_rows", lambda: 64)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.delenv("LO_WEB_ASYNC", raising=False)
    record = chip_smoke.phase_serve(torch, "cpu rehearsal")
    servers = record["servers"]
    assert len(servers["loop"]) == 2 and len(servers["threaded"]) == 1
    for runs in servers.values():
        for run in runs:
            assert set(run) == {"p50_single_row_ms", "p99_single_row_ms", "p50_concurrent_ms", "p99_concurrent_ms"}
            assert 0 < run["p50_single_row_ms"] <= run["p99_single_row_ms"]
    # 5 models x (16 singles + 8 concurrent + 1 full) on the loop, then
    # 5 x (16 + 8) on each of the two other runs
    assert record["answers_checked"] == 5 * 25 + 2 * 5 * 24
    assert "LO_WEB_ASYNC" not in os.environ
    assert '"phase": "serve"' in capsys.readouterr().out
