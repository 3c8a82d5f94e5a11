"""The JAX package's sharded-store tests (``tests/test_shardstore.py``),
run on the port's ``core/shardmap.py`` and ``core/shardstore.py``.

Their source is read and run here with every module path pointed at the
port's: the stripe arithmetic, the knobs, scatter-gather parity with the
unsharded store in memory and over the wire, the shard-map topology
contract, the single group's byte-identical wire traffic, the journal's
shard scope and the kill-one-shard-primary drill (the fast in-process
variant; the subprocess variant stays ``slow``, as in the reference, and
starts ``python -m learningorchestra_tpu_torch.core.store_service``).
One edit: the reference records the single group's wire traffic with a
WSGI middleware, and the port's server takes an app with ``handle``, so
the recorder wraps that instead. Their own calls to the servers keep
``requests``.

Below them, the port against the JAX package on the CPU:

- ``ShardLayout`` places ids 1..100,000 identically;
- the same writes through each package's ``ShardedStore`` over two and
  three in-process groups read back the same documents, columns and
  ``aggregate`` results, and their revs move in the same order;
- a five-classifier Titanic build over each package's ``ShardedStore``
  gives the same labels and metrics within ``tests/test_torch_builder.py``'s
  ``METRIC_TOL`` (1e-6) and its probability tolerances;
- the runner's ``shard config:`` boot line, and its refusal of a bad
  ``LO_SHARD_STRIPE_ROWS``.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from learningorchestra_tpu.core import shardmap as jax_shardmap
from learningorchestra_tpu.core import shardstore as jax_shardstore
from learningorchestra_tpu.core.columns import Column as JaxColumn
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore
from learningorchestra_tpu_torch.core import shardmap as port_shardmap
from learningorchestra_tpu_torch.core import shardstore as port_shardstore
from learningorchestra_tpu_torch.core import store_service as port_store_service
from learningorchestra_tpu_torch.core.columns import Column as PortColumn
from learningorchestra_tpu_torch.core.store import InMemoryStore as PortStore

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_shardstore.py")
# (text in the reference's tests, its count, the port's text)
EDITS = (
    ('''        def record(app, log):
            def middleware(environ, start_response):
                body = environ["wsgi.input"].read()
                log.append(
                    (
                        environ["REQUEST_METHOD"],
                        environ["PATH_INFO"],
                        environ.get("QUERY_STRING", ""),
                        body,
                    )
                )
                from io import BytesIO

                environ["wsgi.input"] = BytesIO(body)
                environ["CONTENT_LENGTH"] = str(len(body))
                return app(environ, start_response)

            return middleware
''', 1, '''        def record(app, log):
            class Recorder:
                name = app.name

                def handle(self, request):
                    log.append((request.method, request.path, sorted(request.args.items()), request.data))
                    return app.handle(request)

            return Recorder()
'''),
)

_source = REFERENCE_TESTS.read_text()
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def test_the_reference_tests_run_on_the_port():
    """The tests above use the port's shard map, sharded store, store
    service, journal scope and server, and its slow drill starts the
    port's store server."""
    assert ShardLayout is port_shardmap.ShardLayout  # noqa: F821
    assert ShardedStore is port_shardstore.ShardedStore  # noqa: F821
    assert connect is port_store_service.connect  # noqa: F821
    assert shardmap is port_shardmap  # noqa: F821
    assert re.findall(r"learningorchestra_tpu\.\w+", _source) == []
    assert '"learningorchestra_tpu_torch.core.store_service"' in _source
    drill = test_kill_shard_primary_mid_ingest_subprocess  # noqa: F821
    assert {mark.name for mark in drill.pytestmark} >= {"slow"}
    tests = [
        name for name, value in list(globals().items())
        if name.startswith("Test") or (name.startswith("test_") and callable(value))
    ]
    assert len(tests) >= 8


# --- the port against the JAX package ---------------------------------------


@pytest.mark.parametrize("stripe", [8, 8192])
@pytest.mark.parametrize("shards", [2, 3, 5])
def test_placement_is_the_references(shards, stripe):
    """Every id of 1..100,000 goes to the same group at the same local
    id, and back; ``decompose`` cuts a range into the same runs."""
    ours = port_shardmap.ShardLayout(shards, stripe)
    theirs = jax_shardmap.ShardLayout(shards, stripe)
    ids = range(1, 100_001)
    placed = [ours.global_to_local(gid) for gid in ids]
    assert placed == [theirs.global_to_local(gid) for gid in ids]
    assert [ours.local_to_global(shard, local) for shard, local in placed[::97]] == list(ids)[::97]
    for start, rows in ((1, 100_000), (777, 54_321)):
        assert ours.decompose(start, rows) == theirs.decompose(start, rows)
    counts = np.bincount([shard for shard, _ in placed], minlength=shards)
    assert counts.sum() == 100_000 and (counts > 0).all()


PACKAGE_STORES = {
    "port": (port_shardstore.ShardedStore, PortStore, PortColumn),
    "jax": (jax_shardstore.ShardedStore, JaxStore, JaxColumn),
}


def _writes(package: str, groups: int, stripe: int):
    """One sequence of writes into a package's ``ShardedStore``; returns
    the store, its groups and the collection's rev after each write."""
    sharded_class, store_class, column = PACKAGE_STORES[package]
    members = [store_class() for _ in range(groups)]
    store = sharded_class(members, stripe_rows=stripe, map_ttl_s=0)
    rng = np.random.default_rng(11)
    rows = 300
    revs = []
    store.create_collection("ds")
    store.insert_one("ds", {"_id": 0, "filename": "ds", "finished": False, "fields": "processing"})
    revs.append(store.collection_rev("ds"))
    for start in range(1, rows + 1, 100):
        store.insert_column_arrays("ds", {
            "x": column.from_numpy(rng.random(100)),
            "y": column.from_numpy((np.arange(start, start + 100) % 7).astype(np.int64)),
            "s": column.from_strings([f"s{i % 5}" for i in range(start, start + 100)]),
        })
        revs.append(store.collection_rev("ds"))
    store.insert_one("ds", {"_id": rows + 1_000, "note": "overlay", "y": 3})
    store.set_column("ds", "x", column.from_numpy(np.full(25, 0.5)), start_id=40)
    store.set_field_values("ds", "y", {5: 70, rows: 71, 0: 72, rows + 1_000: 73})
    store.update_one("ds", {"_id": 0}, {"finished": True, "fields": ["x", "y", "s"]})
    store.update_one("ds", {"y": 71}, {"s": "last"})
    revs.append(store.collection_rev("ds"))
    return store, members, revs


@pytest.mark.parametrize("groups", [2, 3])
def test_writes_read_back_as_the_references(groups):
    ours, our_groups, our_revs = _writes("port", groups, 16)
    theirs, their_groups, their_revs = _writes("jax", groups, 16)
    assert list(ours.find("ds")) == list(theirs.find("ds"))
    for query in ({"y": 3}, {"_id": {"$lte": 20}}, {"_id": 300}, {"s": "last"}):
        assert list(ours.find("ds", query)) == list(theirs.find("ds", query)), query
    for fields, start, limit in ((None, 0, None), (["_id", "x"], 17, 50), (["s"], 290, 20)):
        got = ours.read_column_arrays("ds", fields, start, limit)
        want = theirs.read_column_arrays("ds", fields, start, limit)
        assert {name: column.tolist() for name, column in got.items()} == {
            name: column.tolist() for name, column in want.items()
        }
    for pipeline in (
        [{"$group": {"_id": "$y", "count": {"$sum": 1}}}],
        [{"$match": {"_id": {"$lte": 120}}}, {"$group": {"_id": "$s", "count": {"$sum": 1}}}],
        [{"$group": {"_id": "$_id", "count": {"$sum": 1}}}],
    ):
        assert ours.aggregate("ds", pipeline) == theirs.aggregate("ds", pipeline), pipeline
    assert [group.collection_block_rows("ds") for group in our_groups] == [
        group.collection_block_rows("ds") for group in their_groups
    ]
    assert ours.count("ds") == theirs.count("ds") == 302
    assert ours.shard_signature == theirs.shard_signature == f"sh{groups}x16"
    assert np.argsort(our_revs, kind="stable").tolist() == np.argsort(their_revs, kind="stable").tolist()
    assert all(a < b for a, b in zip(our_revs, our_revs[1:]))
    assert ours.find_one(port_shardmap.SHARDMAP_COLLECTION, {"_id": 1}) == theirs.find_one(
        jax_shardmap.SHARDMAP_COLLECTION, {"_id": 1}
    )


def test_a_titanic_build_over_shards_is_the_references(tmp_path, monkeypatch):
    """All five classifiers over each package's ``ShardedStore`` (two
    groups, 2-row stripes, so the 8 rows and every prediction collection
    are spread over both): the same labels, the metrics within
    ``METRIC_TOL`` and dt's, rf's and nb's probabilities within
    ``PROB_TOL`` (the tolerances of ``tests/test_torch_builder.py``, and
    why they are what they are, are stated there)."""
    from learningorchestra_tpu.ml import builder as jax_builder
    from learningorchestra_tpu_torch.ml import builder, trees
    from tests import test_torch_builder as parity

    monkeypatch.setattr(trees.RandomForestClassifier, "fit", parity.rf_on_reference_draws)
    monkeypatch.setattr(jax_builder, "make_classifier", parity.small(jax_builder.make_classifier))
    monkeypatch.setattr(builder, "make_classifier", parity.small(builder.make_classifier))
    path = tmp_path / "titanic.csv"
    path.write_text(parity.TITANIC_LIKE_CSV)
    files = {"train": str(path), "test": str(path)}
    results = {}
    for package, (sharded_class, store_class, _) in PACKAGE_STORES.items():
        sharded = lambda: sharded_class([store_class(), store_class()], stripe_rows=2)  # noqa: E731
        monkeypatch.setitem(parity.PACKAGES[package], "store", sharded)
        results[package] = parity.build(
            package, files, parity.TITANIC_NUMBERS, parity.DOCUMENTED_PREPROCESSOR
        )
    store = results["port"][0]
    assert isinstance(store, port_shardstore.ShardedStore)
    assert all(group.collection_block_rows("train") > 0 for group in store.groups)
    for name in parity.NAMES:
        ours, theirs = results["port"][1][name], results["jax"][1][name]
        np.testing.assert_allclose(
            [float(ours["accuracy"]), float(ours["F1"])],
            [float(theirs["accuracy"]), float(theirs["F1"])],
            rtol=0, atol=parity.METRIC_TOL,
        )
        our_rows, their_rows = results["port"][2][name], results["jax"][2][name]
        assert [row["_id"] for row in our_rows] == [row["_id"] for row in their_rows]
        assert [row["prediction"] for row in our_rows] == [row["prediction"] for row in their_rows]
        if name in parity.TITANIC_PROBS:
            np.testing.assert_allclose(
                [row["probability"] for row in our_rows],
                [row["probability"] for row in their_rows],
                **parity.PROB_TOL[name],
            )


_RUNNER = "from learningorchestra_tpu_torch.services.runner import main; main(device='cpu')"


def _runner(tmp_path, **env):
    return subprocess.Popen(
        [sys.executable, "-c", _RUNNER], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(REFERENCE_TESTS.parent.parent),
        env=dict(os.environ, LO_DATA_DIR=str(tmp_path / "lo_data"), **env),
    )


def test_the_runner_states_its_shard_config(tmp_path):
    """Two ``;`` groups give the reference's boot line, before the runner
    opens its store."""
    runner = _runner(
        tmp_path, LO_STORE_URL="http://127.0.0.1:9,http://127.0.0.1:10;http://127.0.0.1:11",
        LO_SHARD_STRIPE_ROWS="64", LO_SHARDMAP_TTL_S="2.5",
    )
    try:
        lines = []
        for line in runner.stdout:
            lines.append(line)
            if line.startswith("shard config:"):
                break
    finally:
        runner.kill()
        runner.wait(timeout=30)
    assert lines[-1].strip() == "shard config: groups=2 stripe_rows=64 map_ttl_s=2.5", lines


@pytest.mark.parametrize("bad", ["0", "-3", "eight"])
def test_the_runner_refuses_a_bad_stripe(tmp_path, bad):
    runner = _runner(tmp_path, LO_STORE_URL="http://127.0.0.1:9;http://127.0.0.1:10", LO_SHARD_STRIPE_ROWS=bad)
    out, err = runner.communicate(timeout=120)
    assert runner.returncode != 0
    assert "LO_SHARD_STRIPE_ROWS must be" in err
    assert "shard config:" not in out
    assert not (tmp_path / "lo_data").exists()


def test_the_shard_gauges_are_the_references():
    """``register_sharded_store`` of each package over the same writes:
    one set of ``lo_store_shard_*`` gauges a group, the fan-out histogram
    of the routed calls, and the shard map's rev, rendered alike."""
    from learningorchestra_tpu.telemetry import metrics as jax_metrics
    from learningorchestra_tpu_torch.telemetry import metrics as port_metrics

    texts, revs = {}, {}
    for side, metrics in (("port", port_metrics), ("jax", jax_metrics)):
        store, _, _ = _writes(side, 2, 16)
        registry = metrics.MetricsRegistry()
        metrics.register_sharded_store(store, registry=registry)
        store.read_column_arrays("ds", ["x"], 10, 100)
        text = registry.render()
        revs[side] = store.shardmap_rev()
        assert f"lo_store_shardmap_rev {revs[side]}\n" in text
        texts[side] = [line for line in text.splitlines() if not line.startswith("lo_store_shardmap_rev ")]
    assert texts["port"] == texts["jax"]
    for shard in ("0", "1"):
        for family in ("collections", "wal_bytes", "spill_bytes"):
            assert any(line.startswith(f'lo_store_shard_{family}{{shard="{shard}"}}') for line in texts["port"])
    assert any(line.startswith("lo_store_shard_fanout_count") for line in texts["port"])
