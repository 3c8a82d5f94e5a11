"""The JAX package's store-service tests (``tests/test_store_service.py``),
run on the port's ``core/store_service.py`` on the CPU.

Their source is read and run here with every module path pointed at the
port: the ``RemoteStore`` conformance over a live server (collections,
documents, columns, paged reads, operators, aggregation, the error
mapping, a service over the wire), WAL replication (catch-up, the
follower's 503, the epoch resync, promotion), automatic failover (the
writes that ride a takeover, the promote response, the revived and the
live stale primary fenced, both followers healing) and the landed-ok
replays. Where the reference's tests make ``requests`` raise its
connection or HTTP errors, they raise the port's transport's
(``utils/httpclient.py``), which ``RemoteStore`` catches; their own
calls to the servers keep ``requests``.

The seven-process topology (``test_multiprocess_stack_titanic``) runs
too: a store server and seven runners, one a service (``LO_SERVICE``,
``LO_PORT=0``), each started as ``main(device='cpu')``, driven by the
JAX package's client (the port serves its routes).

Below them: the cross-package parity of the frames (byte-identical
``encode_frame`` in v1, v2 and compressed form) and of the wire (each
package's ``RemoteStore`` reads the other's server), and the ``;`` URL's
shard groups.
"""

import pathlib
import re

import numpy as np
import pytest

from learningorchestra_tpu.core import store_service as jax_store_service
from learningorchestra_tpu.core import wire as jax_wire
from learningorchestra_tpu.core.columns import Column as JaxColumn
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore
from learningorchestra_tpu.utils.web import ServerThread as JaxServerThread
from learningorchestra_tpu_torch.core import store_service as port_store_service
from learningorchestra_tpu_torch.core import wire as port_wire
from learningorchestra_tpu_torch.core.columns import Column as PortColumn
from learningorchestra_tpu_torch.utils import httpclient

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_store_service.py")
NOT_PORTED: dict = {}
# (text in the reference's tests, its count, the port's text)
EDITS = (
    ('raise requests.ConnectionError("primary died mid-write")', 1,
     'raise httpclient.ConnectionError("primary died mid-write")'),
    ('raise rq.HTTPError("500", response=self)', 1,
     'raise httpclient.HTTPError("500", response=self)'),
    ('raise rq.ConnectionError("died after the server applied")', 1,
     'raise httpclient.ConnectionError("died after the server applied")'),
    ('                "-m",\n                "learningorchestra_tpu.services.runner",\n', 1,
     '                "-c",\n'
     '                "from learningorchestra_tpu.services.runner import main; main(device=\'cpu\')",\n'),
)

_source = REFERENCE_TESTS.read_text()
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
# the client SDK stays the JAX package's: the port serves its routes
_source = _source.replace("learningorchestra_tpu_torch.client", "learningorchestra_tpu.client")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102
for _name in NOT_PORTED:
    del globals()[_name]


def test_the_reference_tests_run_on_the_port():
    """The tests above use the port's store service and server."""
    assert RemoteStore is port_store_service.RemoteStore  # noqa: F821
    assert create_store_app is port_store_service.create_store_app  # noqa: F821
    assert set(re.findall(r"learningorchestra_tpu\.\w+", _source)) == {"learningorchestra_tpu.client"}
    assert "from learningorchestra_tpu_torch.services.runner import main; main(device='cpu')" in _source


# --- the two packages on one wire ----------------------------------------------


def cells(column):
    """A column's cells, NaN as a string, so that NaN equals NaN."""
    return ["nan" if isinstance(v, float) and v != v else v for v in column.tolist()]


def seeded_values(rows=1_000, seed=5):
    """Columns of every common kind, made from a seed: float64 with NaN
    and None, int64, strings with None, booleans."""
    rng = np.random.default_rng(seed)
    floats = rng.normal(size=rows)
    floats[::17] = np.nan
    return {
        "f": [None if i % 23 == 0 else float(v) for i, v in enumerate(floats)],
        "i": [int(v) for v in rng.integers(-1_000, 1_000, size=rows)],
        "s": [None if i % 11 == 0 else f"s{int(v)}" for i, v in enumerate(rng.integers(0, 50, size=rows))],
        "b": [bool(v) for v in rng.integers(0, 2, size=rows)],
    }


@pytest.mark.parametrize("version", [1, 2])
def test_frames_are_byte_identical_across_the_packages(version):
    values = seeded_values()
    ours = port_wire.encode_frame(
        {name: PortColumn.from_values(v) for name, v in values.items()}, {"rev": 7}, version=version
    )
    theirs = jax_wire.encode_frame(
        {name: JaxColumn.from_values(v) for name, v in values.items()}, {"rev": 7}, version=version
    )
    assert ours == theirs
    assert port_wire.compress_frame(ours) == jax_wire.compress_frame(theirs)
    decoded, extra = port_wire.decode_frame(jax_wire.decode_body(
        jax_wire.compress_frame(theirs), jax_wire.WIRE_COMPRESSION))
    assert extra == {"rev": 7}
    for name, column in decoded.items():
        assert cells(column) == cells(PortColumn.from_values(values[name])), name


def _serve(package):
    if package == "port":
        return port_store_service.ServerThread(
            port_store_service.create_store_app(port_store_service.InMemoryStore(), shm=False),
            "127.0.0.1", 0,
        ).start()
    return JaxServerThread(
        jax_store_service.create_store_app(JaxStore(), shm=False), "127.0.0.1", 0
    ).start()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("server_package,client_package", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("compress", [False, True])
def test_each_packages_client_reads_the_others_server(server_package, client_package, writer, compress):
    """Columns written by either package's client over the binary verbs,
    and documents, read back by the other package's client (paged, v2
    frames, optionally compressed) equal what was written."""
    clients = {"port": port_store_service.RemoteStore, "jax": jax_store_service.RemoteStore}
    server = _serve(server_package)
    try:
        url = f"http://127.0.0.1:{server.port}"
        values = seeded_values()
        source = clients[writer](url, shm_bytes=0, compress=compress)
        source.insert_columns("ds", values, start_id=1)
        source.insert_one("docs", {"_id": 1, "name": "a", "x": [1.5, None]})
        reader = clients[client_package](url, shm_bytes=0, compress=compress)
        reader.wire_rows_bin = 300     # four chunks, the read-ahead on
        got = reader.read_column_arrays("ds", [*values, "_id"])
        for name, column in values.items():
            assert cells(got[name]) == cells(PortColumn.from_values(column)), name
        assert got["_id"].tolist() == list(range(1, 1_001))
        assert reader.find_one("docs", {"_id": 1}) == {"_id": 1, "name": "a", "x": [1.5, None]}
        assert reader.collection_rev("ds") == source.collection_rev("ds") > 0
        assert sorted(reader.list_collections()) == ["docs", "ds"]
    finally:
        server.stop()


def test_shard_groups_build_a_sharded_store():
    """A ``;``-separated URL names shard groups: two or more build a
    ``ShardedStore`` over one ``RemoteStore`` a group, each with its own
    replica list, the first the meta group; one group stays a plain
    ``RemoteStore``."""
    from learningorchestra_tpu_torch.core.shardstore import ShardedStore

    store = port_store_service.connect("http://a:1,http://b:2;http://c:3,http://d:4")
    assert type(store) is ShardedStore
    assert [type(group) for group in store.groups] == [port_store_service.RemoteStore] * 2
    assert [group.urls for group in store.groups] == [["http://a:1", "http://b:2"], ["http://c:3", "http://d:4"]]
    store = port_store_service.connect("http://a:1,http://b:2")
    assert type(store) is port_store_service.RemoteStore
    assert store.urls == ["http://a:1", "http://b:2"]


def test_the_transport_raises_requests_kinds_of_error():
    """A refused connection is a ``ConnectionError``, a 4xx or 5xx a
    ``HTTPError`` carrying its response, and a closed kept-alive
    connection is opened again rather than failing the next request."""
    server = _serve("port")
    url = f"http://127.0.0.1:{server.port}"
    session = httpclient.Session()
    assert session.get(f"{url}/collections").json() == {"collections": []}
    missing = session.get(f"{url}/nowhere")
    with pytest.raises(httpclient.HTTPError) as raised:
        missing.raise_for_status()
    assert raised.value.response.status_code == 404
    server.stop()
    restarted = port_store_service.ServerThread(
        port_store_service.create_store_app(port_store_service.InMemoryStore()), "127.0.0.1", server.port
    ).start()
    try:
        assert session.get(f"{url}/health").json()["ok"] is True
    finally:
        restarted.stop()
    with pytest.raises(httpclient.ConnectionError):
        session.get(f"{url}/health")


def test_the_runner_serves_over_a_store_server(tmp_path, titanic_csv):
    """``services.runner.main`` with ``LO_STORE_URL`` opens a
    ``RemoteStore`` on it (no local WAL): a dataset already on the
    server is listed by ``GET /files``, one ingested through ``POST
    /files`` lands on the server, and the boot line states the wire's
    shm and v2 settings."""
    import json
    import os
    import re
    import subprocess
    import sys
    import time
    import urllib.request

    from learningorchestra_tpu_torch.core.store import InMemoryStore as PortStore

    backing = PortStore()
    server = port_store_service.ServerThread(
        port_store_service.create_store_app(backing), "127.0.0.1", 0).start()
    url = f"http://127.0.0.1:{server.port}"
    port_store_service.RemoteStore(url).insert_one("ds", {"_id": 0, "filename": "ds", "finished": True})
    env = dict(
        os.environ, LO_STORE_URL=url, LO_EPHEMERAL="1", LO_DATA_DIR=str(tmp_path / "lo_data"),
        LO_SHM_BYTES="0", PYTHONPATH=REPO_ROOT, PYTHONUNBUFFERED="1",  # noqa: F821
    )
    child = subprocess.Popen(
        [sys.executable, "-c", "from learningorchestra_tpu_torch.services.runner import main; main(device='cpu')"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO_ROOT,  # noqa: F821
    )
    try:
        lines = []
        deadline = time.time() + 120
        while time.time() < deadline and not any("serving all services" in line for line in lines):
            line = child.stdout.readline()
            if not line and child.poll() is not None:
                break
            lines.append(line)
        assert any(f"data in {url}" in line for line in lines), lines
        assert any(line.startswith("wire config: shm_bytes=0 dtype_policy=f32 v2=True") for line in lines)
        port = next(int(m.group(1)) for line in lines for m in [re.search(r"service database_api on [\d.]+:(\d+)", line)] if m)
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

        def call(method, path, payload=None):
            request = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}", method=method,
                data=None if payload is None else json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            with opener.open(request, timeout=30) as answer:
                return answer.status, json.loads(answer.read())

        status, listed = call("GET", "/files")
        assert status == 200 and [entry["filename"] for entry in listed["result"]] == ["ds"]
        status, _ = call("POST", "/files", {"filename": "titanic", "url": titanic_csv})
        assert status == 201
        deadline = time.time() + 60
        while time.time() < deadline and not backing.is_finished("titanic"):
            time.sleep(0.05)
        assert backing.is_finished("titanic") and backing.count("titanic") > 1
        assert not (tmp_path / "lo_data" / "wal.jsonl").exists()   # no local store
    finally:
        child.kill()
        child.wait(timeout=30)
        server.stop()
