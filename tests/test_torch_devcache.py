"""The JAX package's device-cache tests (``tests/test_devcache.py``), run
on the port's ``core/devcache.py`` on the CPU.

Their source is read and run here with every module path pointed at the
port: rev-keyed invalidation by every mutating store operation, the
store-wide rev sequence, a backend without revs never caching, the LRU's
capacity bound, recency and pass-through, concurrent readers, the
content-addressed device matrices and labels of frames, the image
pipeline's atomic inputs and its cache hit on a second embed, the
builder's overlapped write-back (and a failing write failing the build),
the capacity knob's validation and a second build's cached reads, the
cluster manifest's dataplane section (on the port's cluster driver,
``deploy/cluster.py`` of the port), and the cases over a ``RemoteStore``
(rev probes over the wire, the mid-stream fault's purge and its
in-place retry, paged reads with the read-ahead, wire compression). The port's entry points default to the
card, so the calls that would take it are given ``device="cpu"``; where
the reference's tests make ``requests`` raise its connection error, they
raise the port's transport's (``utils/httpclient.py``).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learningorchestra_tpu.core import devcache as jax_devcache  # noqa: E402
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore  # noqa: E402
from learningorchestra_tpu_torch.utils import httpclient  # noqa: E402,F401 (the edits name it)

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_devcache.py")
CLUSTER_IMPORT = (
    '        sys.path.insert(0, "deploy")\n        try:\n            import cluster\n'
    '        finally:\n            sys.path.pop(0)\n'
)
# (text in the reference's tests, its count, the port's text)
EDITS = (
    ('raise requests.ConnectionError("injected', 2, 'raise httpclient.ConnectionError("injected'),
    ("with pytest.raises(requests.ConnectionError):", 1,
     "with pytest.raises(httpclient.ConnectionError):"),
    ('.device_matrix("features")', 3, '.device_matrix("features", "cpu")'),
    ('device_labels("label")', 1, 'device_labels("label", "cpu")'),
    ('device_labels(\n            "label"\n        )', 1, 'device_labels("label", "cpu")'),
    ('dataset_embedding_inputs(\n            store, "ds", cache=cache\n        )', 2,
     'dataset_embedding_inputs(store, "ds", "cpu", cache=cache)'),
    ('dataset_embedding_inputs(store, "ds", cache=cache)', 1,
     'dataset_embedding_inputs(store, "ds", "cpu", cache=cache)'),
    (CLUSTER_IMPORT, 1, "        from learningorchestra_tpu_torch.deploy import cluster\n"),
    ("pca_embedding(X)", 1, 'pca_embedding(X, device="cpu")'),
    ("pca_embedding(shard_matrix(X))", 1, 'pca_embedding(shard_matrix(X, "cpu"), device="cpu")'),
    ('"pca", render=False', 2, '"pca", device="cpu"'),
    ("            list(classifiers),\n        )", 1,
     '            list(classifiers),\n            device="cpu",\n        )'),
)

_source = REFERENCE_TESTS.read_text()
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


@pytest.fixture(autouse=True, scope="module")
def reference_registry_in_step():
    """After this module, the JAX package's process-wide metrics registry
    holds the families that the port's code here registers in the port's
    (the device cache's gauges, the fits' segment counters), as the
    reference's own code registers them when it does the same work:
    tests/test_torch_builder_routes.py holds the port's families to be
    among the reference's in one worker process."""
    yield
    from learningorchestra_tpu.core import devcache as reference_devcache
    from learningorchestra_tpu.ml import progress as reference_progress

    reference_devcache.global_devcache()
    reference_progress._saved_counter()
    reference_progress._skipped_counter()


def test_the_reference_tests_run_on_the_port():
    """The classes above use the port's cache, and none of the JAX
    package's modules."""
    from learningorchestra_tpu_torch.core import devcache as port_devcache

    assert DeviceCache is port_devcache.DeviceCache  # noqa: F821
    assert devcache is port_devcache  # noqa: F821
    assert "learningorchestra_tpu." not in _source


def test_same_keys_and_counts_as_the_reference():
    """One script of lookups, puts, evictions and invalidations gives the
    port's cache and the reference's the same answers and the same
    counters."""
    caches = {"port": devcache.DeviceCache(capacity=100), "jax": jax_devcache.DeviceCache(capacity=100)}  # noqa: F821
    seen = {}
    for name, cache in caches.items():
        answers = []
        for i in range(6):
            cache.put("s", f"c{i % 3}", ("k",), rev=i // 3, value=i, nbytes=30)
            answers.append(cache.get("s", f"c{(i + 1) % 3}", ("k",), rev=i // 3))
        answers.append(cache.invalidate("c1"))
        answers.append(cache.invalidate(scope="s"))
        seen[name] = (answers, cache.stats())
    assert seen["port"] == seen["jax"]


def test_device_entries_are_keyed_by_device_and_policy():
    """The device's signature and the policy ride every device key: the
    same bytes on another device are another entry."""
    X = np.arange(12.0).reshape(4, 3)
    cache = devcache.global_devcache()  # noqa: F821
    first = devcache.content_device_matrix(X, "cpu")  # noqa: F821
    assert devcache.content_device_matrix(X.copy(), "cpu") is first  # noqa: F821
    assert first.dtype == torch.float32 and first.device.type == "cpu"
    keys = [key for key in cache._entries if key[1] == devcache.CONTENT]  # noqa: F821
    assert keys and all(key[2][2] == ("cpu", None) and key[2][3] == "f32" for key in keys)


def test_table_bytes_charge_the_reference_footprint():
    """The host tier charges a table as the reference does: its arrays'
    bytes, and 48 bytes a boxed string."""
    store, jax_store = InMemoryStore(), JaxStore()  # noqa: F821
    for target in (store, jax_store):
        target.insert_columns("t", {"x": [1.0, 2.0, 3.0], "s": ["a", None, "c"]})
    ours = devcache._table_nbytes(devcache.dataset_table(store, "t", cache=DeviceCache(0)))  # noqa: F821
    theirs = jax_devcache._table_nbytes(
        jax_devcache.dataset_table(jax_store, "t", cache=jax_devcache.DeviceCache(0))
    )
    assert ours == theirs > 0
