"""The JAX package's cluster-driver tests (``tests/test_cluster.py``),
run on the port's driver, ``learningorchestra_tpu_torch/deploy/cluster.py``.

Their source is read and run here with the driver and the supervisor
pointed at the port's modules (``python -m
learningorchestra_tpu_torch.deploy.cluster``, ``...deploy.stack``) and
``LO_DEVICE=cpu`` with ``LO_DIST_BACKEND=gloo`` in place of
``JAX_PLATFORMS=cpu``: the two-machine build and heal over the local
transport (a head with the store and the coordinator, a worker-only
machine with one SPMD process, a build over REST, the worker's runner
killed and every machine's group relaunched, a second build), and every
unit class of the reference (ssh quoting, the remote kill, the stdin
watchdog, each manifest section's validation and plumbing, the metrics
scrape and push) on the port's module. Each build's labels are held
equal to the port's ``build_model`` in this process, and every
``machine_plans`` call the classes make is held, key for key, to the
reference's on the same manifest.
"""

import copy
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_cluster.py")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DRIVER = '[\n            sys.executable,\n            "-m",\n            "learningorchestra_tpu_torch.deploy.cluster",'
# (text in the reference's tests, its count, the port's text)
EDITS = (
    ('            "JAX_PLATFORMS": "cpu",\n            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",\n', 1,
     '            "LO_DEVICE": "cpu",\n            "LO_DIST_BACKEND": "gloo",\n'),
    ('[\n            sys.executable,\n            os.path.join(_REPO_ROOT, "deploy", "cluster.py"),', 2, PORT_DRIVER),
    ('        cwd=str(tmp_path),\n        start_new_session=True,\n', 1,
     '        cwd=str(tmp_path),\n        env={**os.environ, "PYTHONPATH": _REPO_ROOT},\n'
     '        start_new_session=True,\n'),
    ('        os.path.join(_REPO_ROOT, "deploy", "cluster.py"),\n', 1,
     '        os.path.join(_REPO_ROOT, "learningorchestra_tpu_torch", "deploy", "cluster.py"),\n'),
    ('            os.path.join(_REPO_ROOT, "deploy", "stack.py"),\n', 1,
     '            os.path.join(_REPO_ROOT, "learningorchestra_tpu_torch", "deploy", "stack.py"),\n'),
    ('assert remote.endswith("python3 deploy/stack.py")', 1,
     'assert remote.endswith("python3 -m learningorchestra_tpu_torch.deploy.stack")'),
    ('assert command[1].endswith("stack.py")', 1,
     'assert command[1:] == ["-m", "learningorchestra_tpu_torch.deploy.stack"]'),
    ('"pkill -f deploy/stack.py"', 2, '"pkill -f learningorchestra_tpu_torch.deploy.stack"'),
    ('assert "deploy/stack.py" in launch', 1, 'assert "learningorchestra_tpu_torch.deploy.stack" in launch'),
    ('        assert float(body["result"][0]["accuracy"]) > 0.7\n', 1,
     '        assert float(body["result"][0]["accuracy"]) > 0.7\n'
     '        held_to_in_process(state["ports"]["store"], name, str(csv_path), preprocessor, "nb")\n'),
)

_source = REFERENCE_TESTS.read_text()
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
assert "JAX_PLATFORMS" not in _source and '_REPO_ROOT, "deploy"' not in _source


def held_to_in_process(store_port: int, name: str, csv_path: str, preprocessor: str, classifier: str) -> None:
    """The labels the cluster stored for ``name``'s build (read from the
    head's store server) equal those of the port's ``build_model`` on the
    same CSV in this process (CPU)."""
    from learningorchestra_tpu_torch.core.ingest import ingest_csv, write_ingest_metadata
    from learningorchestra_tpu_torch.core.store import InMemoryStore
    from learningorchestra_tpu_torch.core.store_service import connect
    from learningorchestra_tpu_torch.ml.builder import build_model
    from learningorchestra_tpu_torch.ops.dtype import convert_field_types

    collection = f"{name}_prediction_{classifier}"
    remote = connect(f"http://127.0.0.1:{store_port}")
    try:
        served = remote.read_column_arrays(collection, ["prediction"])["prediction"].to_float64()
    finally:
        remote.close()
    store = InMemoryStore()
    write_ingest_metadata(store, name, "file://" + csv_path)
    ingest_csv(store, name, "file://" + csv_path)
    convert_field_types(store, name, {"f1": "number", "f2": "number", "label": "number"})
    build_model(store, name, name, preprocessor, [classifier], device="cpu")
    local = store.read_column_arrays(collection, ["prediction"])["prediction"].to_float64()
    assert len(served) == len(local) == 120
    np.testing.assert_array_equal(served, local)


exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def _reference_cluster():
    spec = importlib.util.spec_from_file_location(
        "lo_reference_deploy_cluster", os.path.join(_ROOT, "deploy", "cluster.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_plans(got: list, want: list) -> None:
    """The port's plans and the reference's: the same machines, each with
    the same environment, key for key."""
    assert [(plan["name"], plan["host"], plan["ssh"]) for plan in got] == [
        (plan["name"], plan["host"], plan["ssh"]) for plan in want]
    for mine, theirs in zip(got, want):
        assert sorted(mine["env"]) == sorted(theirs["env"]), mine["name"]
        for key in theirs["env"]:
            assert mine["env"][key] == theirs["env"][key], (mine["name"], key)


_port_cluster_module = _load_cluster_module  # noqa: F821 (the reference's loader, pointed at the port)
_REFERENCE = _reference_cluster()


def _load_cluster_module():  # noqa: F811
    """The port's driver, its ``machine_plans`` held to the reference's on
    every manifest a test hands it."""
    module = _port_cluster_module()
    plans = module.machine_plans

    def held(manifest):
        got = plans(manifest)
        _same_plans(got, _REFERENCE.machine_plans(copy.deepcopy(manifest)))
        return got

    module.machine_plans = held
    return module


# the manifests the unit classes build: the base (ssh and local transport)
# and each section as the classes set it
SECTIONS = {
    "base": {},
    "extra env": {"env": {"LO_EXTRA": "a b", "LO_QUOTE": "it's", "LO_TSDB_COLLECT": "1"}},
    "replication": {"replication": {"enabled": True, "sync_repl": 1}},
    "sharding": {"sharding": {"shards": 3, "stripe_rows": 4096, "map_ttl_s": 2}},
    "sharding and replication": {"replication": {"enabled": True}, "sharding": {"shards": 2}},
    "sched": {"sched": {"job_workers": 4, "queue_cap": 32}},
    "dataplane": {"dataplane": {"devcache_bytes": 123456, "store_compress": 1, "write_overlap": 0}},
    "wire": {"wire": {"shm_bytes": 268435456, "dtype_policy": "bf16"}},
    "coalescing": {"coalescing": {"window_ms": 5, "max_jobs": 16}},
    "serving": {"serving": {"serve_bytes": 500_000_000, "batch_window_ms": 2, "max_batch": 32,
                            "max_rows": 2048, "queue_cap": 128, "timeout_s": 10}},
    "fleet": {"fleet": {"replicas": 4, "rf": 2, "model_qps": 10, "down_s": 1.5}},
    "profiling": {"profiling": {"prof_hz": 19, "prof_window_s": 30}},
    "web": {"web": {"async": 1, "handlers": 8, "max_conns": 10000, "wait_cap_s": 60}},
    "resume": {"resume": {"enabled": 1, "every_segments": 4}},
    "compile": {"compile": {"aot": 1, "max_programs": 128, "publish": 0}},
    "observability": {"tsdb": {"points": 128, "interval_s": 15, "trace_ring": 512},
                      "slo": {"window_s": 300, "serve_p99_s": 0.25, "http_5xx_rate": 1,
                              "queue_depth": 32, "replication_lag": 500}},
    "models dir": {"models_dir": "/shared/models"},
}


@pytest.mark.parametrize("transport", ["ssh", "local"])
@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_machine_plans_match_the_reference(tmp_path, section, transport):
    """Each manifest, loaded by each driver: the port's plans equal the
    reference's, every machine's environment key for key."""
    manifest = _manifest(transport=transport)  # noqa: F821 (the reference's manifest)
    manifest.update(copy.deepcopy(SECTIONS[section]))
    path = tmp_path / "m.json"
    path.write_text(json.dumps(manifest))
    port = _port_cluster_module()
    got = port.machine_plans(port.load_manifest(str(path)))
    want = _REFERENCE.machine_plans(_REFERENCE.load_manifest(str(path)))
    _same_plans(got, want)


def test_a_machine_env_of_its_own(tmp_path):
    """The port's one addition to the schema: a machine's own ``env``,
    laid over the shared one for that machine alone, under the driver's
    wiring; anything but strings refused."""
    cluster = _port_cluster_module()
    manifest = _manifest(env={"LO_JIT_CACHE": "/shared/kernels", "LO_DIST_BACKEND": "gloo"})  # noqa: F821
    manifest["workers"][0]["env"] = {"LO_JIT_CACHE": "/var/lo_kernels", "LO_PROCESS_BASE": "7"}
    path = tmp_path / "m.json"
    path.write_text(json.dumps(manifest))
    head, worker = cluster.machine_plans(cluster.load_manifest(str(path)))
    assert head["env"]["LO_JIT_CACHE"] == "/shared/kernels"
    assert worker["env"]["LO_JIT_CACHE"] == "/var/lo_kernels"
    assert worker["env"]["LO_DIST_BACKEND"] == head["env"]["LO_DIST_BACKEND"] == "gloo"
    assert worker["env"]["LO_PROCESS_BASE"] == "1"   # the wiring wins
    for bad in ({"LO_JIT_CACHE": 1}, ["LO_JIT_CACHE"]):
        manifest["workers"][0]["env"] = bad
        path.write_text(json.dumps(manifest))
        with pytest.raises(SystemExit):
            cluster.load_manifest(str(path))
