"""The port's serving lane (learningorchestra_tpu_torch/serve, services)
against the JAX package's, on the CPU.

Covers the registry (hit, reload after a rewrite, eviction, a deleted
artifact), the micro-batcher (a burst joined into fewer dispatches, an
error delivered to every request of its group) and the predict route: the
JAX app and the port app answer the same checkpoints with the same status,
labels and probabilities (trees within 1e-6, lr and nb within 1e-5), and
refuse the same requests with identical bodies; other methods and
malformed bodies get byte-identical answers, in process and over
sockets.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learningorchestra_tpu.core.store import InMemoryStore  # noqa: E402
from learningorchestra_tpu.ml.checkpoint import save_model as jax_save_model  # noqa: E402
from learningorchestra_tpu.ml.logistic import LogisticRegression  # noqa: E402
from learningorchestra_tpu.ml.naive_bayes import NaiveBayes  # noqa: E402
from learningorchestra_tpu.ml.trees import (  # noqa: E402
    DecisionTreeClassifier,
    GBTClassifier,
    RandomForestClassifier,
)
from learningorchestra_tpu.serve import ServePlane as JaxServePlane  # noqa: E402
from learningorchestra_tpu.services import model_builder as jax_model_builder  # noqa: E402
from learningorchestra_tpu_torch.core.store import InMemoryStore as PortStore  # noqa: E402
from learningorchestra_tpu_torch.ml.checkpoint import (  # noqa: E402
    checkpoint_path,
    load_model,
    save_model,
    write_checkpoint,
)
from learningorchestra_tpu_torch.serve import (  # noqa: E402
    MicroBatcher,
    ModelNotFoundError,
    ModelRegistry,
    ServePlane,
)
from learningorchestra_tpu_torch.serve.registry import model_nbytes  # noqa: E402
from learningorchestra_tpu_torch.services import model_builder  # noqa: E402

FEATURES = 6
MAX_ROWS = 256
NAMES = ("dt", "rf", "gb", "lr", "nb")
TOLERANCES = {
    "dt": dict(rtol=0, atol=1e-6),
    "rf": dict(rtol=0, atol=1e-6),
    "gb": dict(rtol=0, atol=1e-6),
    "lr": dict(rtol=1e-5, atol=1e-5),
    "nb": dict(rtol=1e-5, atol=1e-5),
}


def make_rows(seed, rows):
    return np.random.default_rng(seed).normal(size=(rows, FEATURES)).astype(np.float32)


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    """dt, rf, gb, lr and nb fitted by the JAX package at a small size and
    saved as ``.model`` checkpoints."""
    directory = tmp_path_factory.mktemp("models")
    X = make_rows(0, 320)
    y = ((X[:, 0] - X[:, 1]) > 0).astype(np.int32)
    estimators = {
        "dt": DecisionTreeClassifier(max_depth=3),
        "rf": RandomForestClassifier(num_trees=4, max_depth=3),
        "gb": GBTClassifier(rounds=4, max_depth=3),
        "lr": LogisticRegression(max_iter=20),
        "nb": NaiveBayes(),
    }
    for name, estimator in estimators.items():
        model = estimator.fit(np.abs(X) if name == "nb" else X, y)
        jax_save_model(model, checkpoint_path(str(directory), name))
    return str(directory)


def cpu_plane(**knobs):
    settings = dict(capacity=10**9, window_s=0.0, max_batch=8, inbox_cap=64)
    settings.update(knobs)
    return ServePlane(device="cpu", **settings)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

def test_registry_hit_reload_evict_and_not_found(models_dir, tmp_path):
    path = str(tmp_path / "m.model")
    save_model(load_model(checkpoint_path(models_dir, "rf"), device="cpu"), path)
    registry = ModelRegistry(capacity=10**9, device="cpu")
    first = registry.get(path)
    assert registry.get(path) is first
    assert (registry.hits, registry.misses) == (1, 1)
    assert registry.status(path)["resident"] is True
    assert registry.bytes == model_nbytes(first)

    # an os.replace rewrite moves the rev: reloaded, never served stale
    save_model(load_model(checkpoint_path(models_dir, "gb"), device="cpu"), path)
    second = registry.get(path)
    assert second is not first and type(second).__name__ == "GBTModel"
    assert (registry.misses, registry.invalidations) == (2, 1)

    # a budget of one model: the second model evicts the first
    other = str(tmp_path / "other.model")
    save_model(load_model(checkpoint_path(models_dir, "gb"), device="cpu"), other)
    small = ModelRegistry(capacity=model_nbytes(second), device="cpu")
    small.get(path)
    small.get(other)
    assert small.evictions == 1
    assert small.stats()["models"] == 1 and small.bytes <= small.capacity
    assert small.status(path) == {"resident": False}

    # a deleted artifact: not found, and its entry is dropped
    os.remove(path)
    with pytest.raises(ModelNotFoundError):
        registry.get(path)
    assert registry.stats()["models"] == 0


def test_registry_over_budget_hands_over_without_pinning(models_dir):
    registry = ModelRegistry(capacity=0, device="cpu")
    model = registry.get(checkpoint_path(models_dir, "lr"))
    assert model.predict(make_rows(1, 2)).shape == (2,)
    assert registry.stats()["models"] == 0 and registry.bytes == 0


# --------------------------------------------------------------------------
# Batcher
# --------------------------------------------------------------------------

def test_burst_of_single_rows_joins_into_fewer_dispatches(models_dir):
    plane = cpu_plane(window_s=0.2, max_batch=16)
    path = checkpoint_path(models_dir, "rf")
    rows = make_rows(2, 8)
    pending: list = [None] * 8
    barrier = threading.Barrier(8)

    def submit(index):
        barrier.wait(timeout=30)
        pending[index] = plane.submit(path, rows[index : index + 1])

    try:
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(8)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=30)
            assert not thread.is_alive()
        for request in pending:
            assert request.wait(30) and request.error is None
        stats = plane.stats()
        assert stats["batched_requests"] == 8
        assert stats["batches"] < 8 and stats["mean_batch_size"] > 1
        labels, probs = load_model(path, device="cpu").predict_both(rows)
        np.testing.assert_array_equal(
            np.concatenate([r.labels for r in pending]), labels
        )
        np.testing.assert_allclose(np.concatenate([r.probs for r in pending]), probs)
    finally:
        plane.close()


class _FailingModel:
    def predict_both(self, X):
        raise RuntimeError("injected forward failure")


class _FailingRegistry:
    def get(self, path):
        return _FailingModel()


def test_forward_error_reaches_every_request_of_its_group():
    batcher = MicroBatcher(_FailingRegistry(), window_s=0.2, max_batch=8, inbox_cap=8)
    try:
        requests = [batcher.submit("model", np.zeros((1, 3), np.float32)) for _ in range(4)]
        for request in requests:
            assert request.wait(30)
            assert isinstance(request.error, RuntimeError)
            assert "injected forward failure" in str(request.error)
        assert batcher.stats()["batches"] == 0
    finally:
        batcher.close()


# --------------------------------------------------------------------------
# The route: JAX app and port app on the same checkpoints
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clients(models_dir):
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("LO_SERVE_MAX_ROWS", str(MAX_ROWS))
        jax_plane = JaxServePlane(capacity=10**9, window_s=0.0, max_batch=8, inbox_cap=64)
        jax_app = jax_model_builder.create_app(
            InMemoryStore(), models_dir=models_dir, serve=jax_plane
        )
        port_plane = cpu_plane()
        port_app = model_builder.create_app(
            PortStore(), models_dir=models_dir, serve=port_plane, device="cpu"
        )
    yield jax_app.test_client(), port_app.test_client()
    jax_plane.close()
    port_plane.close()


@pytest.mark.parametrize("rows", [1, 8, MAX_ROWS])
@pytest.mark.parametrize("name", NAMES)
def test_predict_matches_the_jax_app(clients, name, rows):
    X = make_rows(3 + rows, rows)
    if name == "nb":
        X = np.abs(X)
    answers = [
        client.post(f"/models/{name}/predict", json={"rows": X.tolist()})
        for client in clients
    ]
    assert [answer.status_code for answer in answers] == [200, 200]
    expected, got = (answer.get_json()["result"] for answer in answers)
    assert got["model"] == expected["model"] == name
    assert got["predictions"] == expected["predictions"]
    np.testing.assert_allclose(
        got["probabilities"], expected["probabilities"], **TOLERANCES[name]
    )


def _nan_rows():
    rows = make_rows(4, 2).tolist()
    rows[1][2] = float("nan")
    return rows


@pytest.mark.parametrize(
    "path, body",
    [
        ("/models/missing/predict", {"rows": [[0.0] * FEATURES]}),
        ("/models/..%2Fdt/predict", {"rows": [[0.0] * FEATURES]}),
        ("/models/dt/predict", {}),
        ("/models/dt/predict", {"row": [[0.0] * FEATURES]}),
        ("/models/dt/predict", {"rows": [[0.0] * FEATURES, [0.0]]}),
        ("/models/dt/predict", {"rows": [["a"] * FEATURES]}),
        ("/models/dt/predict", {"rows": []}),
        ("/models/dt/predict", {"rows": _nan_rows()}),
        ("/models/lr/predict", {"rows": [[0.0] * FEATURES, [None] * FEATURES]}),
        ("/models/gb/predict", {"rows": make_rows(5, MAX_ROWS + 1).tolist()}),
    ],
)
def test_refusals_match_the_jax_app(clients, path, body):
    answers = [client.post(path, json=body) for client in clients]
    expected, got = answers
    assert expected.status_code in (404, 406, 413)
    assert got.status_code == expected.status_code
    assert got.get_json() == expected.get_json()


def test_listing_and_description_match_the_jax_app(clients):
    expected, got = (client.get("/models").get_json() for client in clients)
    assert got["result"] == expected["result"] == sorted(NAMES)
    for name in NAMES:
        expected, got = (
            client.get(f"/models/{name}").get_json()["result"] for client in clients
        )
        assert (got["kind"], got["size_bytes"]) == (expected["kind"], expected["size_bytes"])
    expected, got = (client.get("/models/missing") for client in clients)
    assert (got.status_code, got.get_json()) == (expected.status_code, expected.get_json())


# paths whose rules are the same in both apps (the port has no POST /models
# yet, so /models itself would list another Allow)
SERVE_METHOD_CASES = [
    (method, path)
    for method in ("HEAD", "PUT", "PATCH", "OPTIONS")
    for path in ("/models/dt", "/models/missing", "/models/dt/predict")
]


@pytest.mark.parametrize("method, path", SERVE_METHOD_CASES)
def test_methods_answer_as_the_jax_app(clients, method, path):
    """HEAD on a GET rule: the GET's status and Content-Type, no body; a
    method a path's rules lack: werkzeug's 405 page and its Allow."""
    expected, got = (client.open(path, method=method) for client in clients)
    assert (got.status_code, got.headers.get("Content-Type"), got.headers.get("Allow"), got.data) == (
        expected.status_code, expected.headers.get("Content-Type"), expected.headers.get("Allow"),
        expected.data,
    )
    assert got.status_code in (200, 404, 405)


def test_methods_and_error_pages_answer_as_the_jax_app_over_a_socket(models_dir):
    """Both apps over real HTTP: HEAD, PUT, PATCH and OPTIONS, a malformed
    and an undeclared predict body (the route reads its body silently:
    406 JSON in both), exact on status, Content-Type, Allow,
    Content-Length and body bytes."""
    import http.client

    from learningorchestra_tpu.utils.web import ServerThread as JaxServerThread
    from learningorchestra_tpu_torch.utils.web import ServerThread

    def answer(port, method, path, body=None, content_type=None):
        connection = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            headers = {} if content_type is None else {"Content-Type": content_type}
            connection.request(method, path, body=body, headers=headers)
            response = connection.getresponse()
            return (
                response.status,
                *(response.getheader(key) for key in ("Content-Type", "Allow", "Content-Length")),
                response.read(),
            )
        finally:
            connection.close()

    jax_plane = JaxServePlane(capacity=10**9, window_s=0.0, max_batch=8, inbox_cap=64)
    port_plane = cpu_plane()
    theirs = JaxServerThread(
        jax_model_builder.create_app(InMemoryStore(), models_dir=models_dir, serve=jax_plane),
        "127.0.0.1", 0,
    ).start()
    ours = ServerThread(model_builder.create_app(PortStore(), models_dir=models_dir, serve=port_plane, device="cpu")).start()
    try:
        for method, path in SERVE_METHOD_CASES:
            want = answer(theirs.port, method, path)
            assert answer(ours.port, method, path) == want, (method, path)
        for body, content_type in ((b"{bad", "application/json"), (b'{"rows": [[0]]}', "text/plain")):
            want = answer(theirs.port, "POST", "/models/dt/predict", body, content_type)
            assert want[0] == 406
            assert answer(ours.port, "POST", "/models/dt/predict", body, content_type) == want
    finally:
        theirs.stop()
        ours.stop()
        jax_plane.close()
        port_plane.close()


def test_create_app_without_a_device_needs_cuda(models_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_builder.create_app(PortStore(), models_dir=models_dir)


def test_port_checkpoint_served_by_the_port_app(models_dir, tmp_path):
    """A model the port writes is served back by the port's own app."""
    gathered = ("logistic", {
        "w": np.eye(FEATURES, 2, dtype=np.float32),
        "b": np.zeros(2, np.float32),
        "mean": np.zeros(FEATURES, np.float32),
        "scale": np.ones(FEATURES, np.float32),
    }, {})
    write_checkpoint(gathered, checkpoint_path(str(tmp_path), "eye"))
    plane = cpu_plane()
    try:
        client = model_builder.create_app(
            PortStore(), models_dir=str(tmp_path), serve=plane, device="cpu"
        ).test_client()
        answer = client.post("/models/eye/predict", json={"rows": [[2.0, 1.0, 0, 0, 0, 0]]})
        assert answer.status_code == 200
        assert answer.get_json()["result"]["predictions"] == [0]
    finally:
        plane.close()


def test_server_takes_a_burst_of_concurrent_connections():
    """64 clients connecting at once are all answered: the server listens
    with the reference's werkzeug backlog (128), not socketserver's 5,
    which reset most of them."""
    import time
    import urllib.request

    from learningorchestra_tpu_torch.utils.web import ServerThread, WebApp

    app = WebApp("burst")

    @app.route("/slow", methods=("POST",))
    def slow(request):
        time.sleep(0.02)
        return {"ok": True}

    server = ServerThread(app).start()
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    clients = 64
    barrier = threading.Barrier(clients)
    answers, errors = [], []

    def one():
        barrier.wait(timeout=30)
        request = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/slow", data=b"{}", method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with opener.open(request, timeout=60) as response:
                answers.append(response.status)
        except OSError as error:
            errors.append(repr(error))

    workers = [threading.Thread(target=one) for _ in range(clients)]
    try:
        for worker in workers:
            worker.start()
        for worker in workers:
            worker.join(timeout=90)
        assert not any(worker.is_alive() for worker in workers)
    finally:
        server.stop()
    assert errors == [] and answers == [200] * clients
