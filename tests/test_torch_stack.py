"""The JAX package's supervisor tests (``tests/test_stack.py``), run on
the port's supervisor, ``python -m learningorchestra_tpu_torch.deploy.stack``.

Their source is read and run here with the supervisor's command pointed
at the port and ``LO_DEVICE=cpu`` with ``LO_DIST_BACKEND=gloo`` in place
of ``JAX_PLATFORMS=cpu`` (the port's children run on the card unless
asked for the CPU): the stack comes up (store server and seven service
processes, ports published in ``stack_ports.json``), serves, restarts a
service killed with SIGKILL; and the multi-host topology (``LO_WORKERS=1``:
store, coordinator and one SPMD worker in one gloo group) builds over
REST, heals a worker's death by relaunching the whole group and builds
again. The same assertions, and each build's labels are held equal to
the port's ``build_model`` on the same CSV in this process.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_stack.py")
# (text in the reference's tests, its count, the port's text)
EDITS = (
    ('    env["JAX_PLATFORMS"] = "cpu"\n    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"\n', 2,
     '    env["LO_DEVICE"] = "cpu"\n    env["LO_DIST_BACKEND"] = "gloo"\n'),
    ('[sys.executable, os.path.join(_REPO_ROOT, "deploy", "stack.py"),\n         str(data_dir)]', 2,
     '[sys.executable, "-m", "learningorchestra_tpu_torch.deploy.stack",\n         str(data_dir)]'),
    ('        assert float(body["result"][0]["accuracy"]) > 0.8\n', 1,
     '        assert float(body["result"][0]["accuracy"]) > 0.8\n'
     '        held_to_in_process(state["ports"]["store"], name, str(csv_path), pre, "lr")\n'),
)

_source = REFERENCE_TESTS.read_text()
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
assert "learningorchestra_tpu." not in _source and "JAX_PLATFORMS" not in _source


def held_to_in_process(store_port: int, name: str, csv_path: str, preprocessor: str, classifier: str) -> None:
    """The labels the stack stored for ``name``'s build (read from its
    store server) equal those of the port's ``build_model`` on the same
    CSV in this process (CPU)."""
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


def test_the_reference_tests_run_on_the_port():
    """The supervisor the tests start is the port's, and its children are
    the port's processes."""
    from learningorchestra_tpu_torch.deploy import stack

    assert "learningorchestra_tpu_torch.deploy.stack" in _source
    assert stack.RUNNER_COMMAND[-1] == "learningorchestra_tpu_torch.services.runner"
    assert stack.STORE_COMMAND[-1] == "learningorchestra_tpu_torch.core.store_service"


def test_a_rendezvous_port_of_zero_is_picked_at_launch(tmp_path):
    """``LO_COORD_PORT=0``: the supervisor picks a free port for the
    group's rendezvous before it launches the group (every member must
    know it before rank 0 binds it), and the group comes up on it."""
    import os
    import re
    import signal
    import subprocess
    import sys
    import time

    env = {key: value for key, value in os.environ.items() if not key.startswith("LO_")}
    env.update(LO_DEVICE="cpu", LO_DIST_BACKEND="gloo", LO_EPHEMERAL="1", LO_STORE_PORT="0", LO_WORKERS="1",
               LO_COORD_PORT="0", LO_TSDB_COLLECT="0", PYTHONPATH=_REPO_ROOT, PYTHONUNBUFFERED="1")  # noqa: F821
    log = tmp_path / "stack.log"
    with open(log, "w") as handle:
        supervisor = subprocess.Popen(
            [sys.executable, "-m", "learningorchestra_tpu_torch.deploy.stack", str(tmp_path / "data")],
            env=env, stdout=handle, stderr=subprocess.STDOUT, cwd=_REPO_ROOT, start_new_session=True)  # noqa: F821
    try:
        deadline = time.time() + 180
        while "[stack] runtime up" not in log.read_text():
            assert supervisor.poll() is None and time.time() < deadline, log.read_text()[-3000:]
            time.sleep(0.2)
        addresses = set(re.findall(r"LO_COORDINATOR='127\.0\.0\.1:(\d+)'", log.read_text()))
        assert len(addresses) == 1 and int(addresses.pop()) > 0
    finally:
        supervisor.send_signal(signal.SIGTERM)
        try:
            supervisor.wait(30)
        finally:
            try:
                os.killpg(supervisor.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
