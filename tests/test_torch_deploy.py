"""The port's bring-up: its preflight held to ``deploy/run.sh``'s, and
``deploy.run`` and the runner's boot knobs.

The preflight heredoc is read out of ``deploy/run.sh`` (the lines
between ``python - <<'EOF'`` and ``EOF``) and run under
``JAX_PLATFORMS=cpu``, beside ``python -m
learningorchestra_tpu_torch.deploy.preflight``, over one table of knob
values: each is accepted by both or refused by both. Each side runs the
whole table in one process of its own (the environment set row by row),
so the table costs two interpreter starts. Then the port's own knobs
(``LO_DEVICE``, ``LO_DIST_BACKEND``: the reference's heredoc has no
counterpart, so only the port's side is held), and the entry points: the
runner refuses a malformed knob and, with ``LO_DEVICE`` unset and no
card, raises; ``deploy.run`` refuses bring-up on a bad knob before it
execs the runner, and with ``LO_DEVICE=cpu`` serves.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_SH = pathlib.Path(_ROOT, "deploy", "run.sh")

# (environment, verdict): every row is a deployment both preflights judge
TABLE = (
    ({}, "accepted"),
    ({"LO_JOB_WORKERS": "4", "LO_SCHED_QUEUE_CAP": "32"}, "accepted"),
    ({"LO_JOB_WORKERS": "four"}, "refused"),
    ({"LO_COALESCE_MAX_JOBS": "1.5"}, "refused"),
    ({"LO_DEVCACHE_BYTES": "1e9", "LO_SHM_BYTES": "0"}, "accepted"),
    ({"LO_DTYPE_POLICY": "bf16"}, "accepted"),
    ({"LO_DTYPE_POLICY": "f16"}, "refused"),
    ({"LO_SERVE_BYTES": "lots"}, "refused"),
    ({"LO_FLEET_RF": "0"}, "refused"),
    ({"LO_PROF_HZ": "-1"}, "refused"),
    ({"LO_WEB_ASYNC": "2"}, "refused"),
    ({"LO_AOT": "1", "LO_AOT_MAX_PROGRAMS": "0", "LO_AOT_PUBLISH": "0"}, "accepted"),
    ({"LO_AOT": "yes"}, "refused"),
    ({"LO_AOT_MAX_PROGRAMS": "6.5"}, "refused"),
    ({"LO_AOT_PUBLISH": "on"}, "refused"),
    ({"LO_REPLICATION": "true"}, "refused"),
    ({"LO_FOLLOWER_PORT": "0"}, "refused"),
    ({"LO_STORE_PORT": "0", "LO_PORT": "0", "LO_COORD_PORT": "12355"}, "accepted"),
    ({"LO_COORD_PORT": "70000"}, "refused"),
    ({"LO_AUTO_PROMOTE_S": "0"}, "refused"),
    ({"LO_SPMD_TIMEOUT_S": "0", "LO_RESTART_DELAY": "0.5"}, "accepted"),
    ({"LO_RESTART_DELAY": "-1"}, "refused"),
    ({"LO_WORKERS": "1.5"}, "refused"),
    ({"LO_SHARDS": "2", "LO_TOTAL_PROCESSES": "2", "LO_PROCESS_BASE": "1"}, "accepted"),
    ({"LO_INGEST_SLAB_BYTES": "1e6"}, "accepted"),
    ({"LO_PROGRAM_ROW_STEPS": "0"}, "refused"),
    ({"LO_SHARD_STRIPE_ROWS": "0"}, "refused"),
    ({"LO_RESUME": "2"}, "refused"),
    ({"LO_SLO_WINDOW_S": "0"}, "refused"),
    ({"LO_FAULT_BUILDER_PHASE": "sometimes"}, "refused"),
    ({"LO_TSDB_COLLECT": "0", "LO_EPHEMERAL": "1"}, "accepted"),
)

# one process runs a table: row by row, the environment set, the
# preflight run, its verdict recorded
_DRIVER = """
import json, os, runpy, sys
rows = json.loads(sys.argv[1])
heredoc = open(sys.argv[2]).read() if sys.argv[2] != "-" else None
base = dict(os.environ)
verdicts = []
for env in rows:
    os.environ.clear()
    os.environ.update(base)
    os.environ.update(env)
    try:
        if heredoc is None:
            runpy.run_module("learningorchestra_tpu_torch.deploy.preflight", run_name="__main__")
        else:
            exec(compile(heredoc, "deploy/run.sh", "exec"), {"__name__": "__main__"})
        verdict = "accepted"
    except SystemExit as stop:
        verdict = "accepted" if stop.code in (None, 0) else "refused"
    except Exception:
        verdict = "refused"
    verdicts.append(verdict)
print(json.dumps(verdicts))
"""


def heredoc() -> str:
    """The preflight's Python in ``deploy/run.sh``, as bash hands it to
    ``python -``."""
    text = RUN_SH.read_text()
    start = text.index("python - <<'EOF'\n") + len("python - <<'EOF'\n")
    return text[start:text.index("\nEOF\n", start) + 1]


def _verdicts(rows, side: str, tmp_path) -> list:
    env = {key: value for key, value in os.environ.items() if not key.startswith("LO_")}
    env["PYTHONPATH"] = _ROOT
    if side == "reference":
        env["JAX_PLATFORMS"] = "cpu"
        source = tmp_path / "preflight_heredoc.py"
        source.write_text(heredoc())
        argument = str(source)
    else:
        argument = "-"
    result = subprocess.run([sys.executable, "-c", _DRIVER, json.dumps(rows), argument],
                            capture_output=True, text=True, cwd=_ROOT, env=env, timeout=300)
    assert result.returncode == 0, result.stderr[-2000:]
    return json.loads(result.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def verdicts(tmp_path_factory):
    rows = [env for env, _ in TABLE]
    folder = tmp_path_factory.mktemp("preflight")
    return {side: _verdicts(rows, side, folder) for side in ("reference", "port")}


def test_the_heredoc_is_the_preflight():
    source = heredoc()
    assert source.startswith("import os\nfrom learningorchestra_tpu.sched import config\n")
    assert "faults.validate_env()" in source and "compile_config.validate_env()" in source


@pytest.mark.parametrize("row", range(len(TABLE)), ids=[
    ",".join(f"{k}={v}" for k, v in env.items()) or "defaults" for env, _ in TABLE])
def test_both_preflights_judge_alike(verdicts, row):
    expected = TABLE[row][1]
    assert verdicts["reference"][row] == verdicts["port"][row] == expected


# the knobs the port adds (the reference's heredoc knows neither)
PORT_KNOBS = (
    ({"LO_DEVICE": "cuda"}, "accepted"),
    ({"LO_DEVICE": "cpu", "LO_DIST_BACKEND": "gloo"}, "accepted"),
    ({"LO_DIST_BACKEND": "nccl"}, "accepted"),
    ({"LO_DEVICE": "gpu"}, "refused"),
    ({"LO_DEVICE": "cuda:0"}, "refused"),
    ({"LO_DIST_BACKEND": "mpi"}, "refused"),
)


@pytest.fixture(scope="module")
def port_knob_verdicts(tmp_path_factory):
    return _verdicts([env for env, _ in PORT_KNOBS], "port", tmp_path_factory.mktemp("knobs"))


@pytest.mark.parametrize("row", range(len(PORT_KNOBS)), ids=[
    ",".join(f"{k}={v}" for k, v in env.items()) for env, _ in PORT_KNOBS])
def test_the_port_knobs(port_knob_verdicts, row):
    """``LO_DEVICE`` and ``LO_DIST_BACKEND``, judged by the port's
    preflight."""
    assert port_knob_verdicts[row] == PORT_KNOBS[row][1]


def test_the_preflight_entry_point_exits_as_it_judges(tmp_path):
    env = {key: value for key, value in os.environ.items() if not key.startswith("LO_")}
    command = [sys.executable, "-m", "learningorchestra_tpu_torch.deploy.preflight"]
    ok = subprocess.run(command, capture_output=True, text=True, cwd=_ROOT, env=env, timeout=120)
    bad = subprocess.run(command, capture_output=True, text=True, cwd=_ROOT,
                         env={**env, "LO_WEB_HANDLERS": "0"}, timeout=120)
    assert ok.returncode == 0 and bad.returncode != 0 and "LO_WEB_HANDLERS" in bad.stderr


def _runner(env, tmp_path, module="learningorchestra_tpu_torch.services.runner", *args):
    base = {key: value for key, value in os.environ.items() if not key.startswith("LO_")}
    base["LO_DATA_DIR"] = str(tmp_path / "lo_data")
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True, cwd=_ROOT,
                          env={**base, "CUDA_VISIBLE_DEVICES": "", **env}, timeout=120)


def test_the_runner_without_lo_device_needs_a_card(tmp_path):
    result = _runner({}, tmp_path)
    assert result.returncode != 0 and "no CUDA device is available" in result.stderr
    assert not (tmp_path / "lo_data").exists()


@pytest.mark.parametrize("env,words", [
    ({"LO_DEVICE": "gpu"}, "LO_DEVICE must be one of cuda|cpu"),
    ({"LO_DEVICE": "cpu", "LO_DIST_BACKEND": "mpi"}, "LO_DIST_BACKEND must be one of nccl|gloo"),
])
def test_the_runner_refuses_a_malformed_knob(tmp_path, env, words):
    result = _runner(env, tmp_path)
    assert result.returncode != 0 and words in result.stderr
    assert not (tmp_path / "lo_data").exists()


def test_run_refuses_bring_up_on_a_bad_knob(tmp_path):
    """``deploy.run`` runs the preflight first: a malformed knob exits
    non-zero and the runner never starts (its boot line never prints)."""
    result = _runner({"LO_DEVICE": "cpu", "LO_AOT": "yes"}, tmp_path, "learningorchestra_tpu_torch.deploy.run",
                     str(tmp_path / "data"))
    assert result.returncode != 0 and "LO_AOT must be 0 or 1" in result.stderr
    assert "runner starting" not in result.stdout


def test_run_without_lo_device_needs_a_card(tmp_path):
    result = _runner({}, tmp_path, "learningorchestra_tpu_torch.deploy.run", str(tmp_path / "data"))
    assert result.returncode != 0 and "no CUDA device is available" in result.stderr


def test_run_serves_on_the_cpu_when_asked(tmp_path):
    """``python -m learningorchestra_tpu_torch.deploy.run <data_dir>`` with
    ``LO_DEVICE=cpu``: the preflight passes, the runner boots on the CPU
    over a store in ``data_dir`` and serves the seven services."""
    env = {key: value for key, value in os.environ.items() if not key.startswith("LO_")}
    env.update(LO_DEVICE="cpu", LO_EPHEMERAL="1", LO_TSDB_COLLECT="0", CUDA_VISIBLE_DEVICES="")
    data_dir = tmp_path / "data"
    log = tmp_path / "run.log"
    with open(log, "w") as handle:
        process = subprocess.Popen(
            [sys.executable, "-m", "learningorchestra_tpu_torch.deploy.run", str(data_dir)],
            stdout=handle, stderr=subprocess.STDOUT, cwd=str(tmp_path), env={**env, "PYTHONPATH": _ROOT},
            start_new_session=True)
    try:
        deadline = time.time() + 120
        while "serving all services" not in log.read_text() and process.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        text = log.read_text()
        assert "serving all services" in text, text[-3000:]
        assert "device=cpu" in text and "compile config: {'LO_AOT': 0" in text
        assert f"data in {data_dir}" in text
    finally:
        process.terminate()
        process.wait(30)
