"""The port's image lane held against the JAX reference on the CPU: the
store and table copies, the embedding inputs, and the tsne and pca image
services (``POST /images/<parent>``, ``GET /images``, ``GET`` and
``DELETE /images/<name>``).

Both packages get equal stores (the same table written by each package's
own ``write_table``). The services must answer the same status codes,
messages and listings, and, in process and over sockets, byte for byte
the same answers to HEAD, PUT, PATCH and OPTIONS and to a malformed or
undeclared body; the PNG is the port's own (a stdlib writer, since
the card's machine has no matplotlib), checked for its signature, its
IHDR and its pixels. The embeddings behind the images are held against
the reference in tests/test_torch_tsne.py.
"""

import json
import os
import struct
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learningorchestra_tpu.core import devcache as jax_devcache  # noqa: E402
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore  # noqa: E402
from learningorchestra_tpu.core.table import ColumnTable as JaxTable  # noqa: E402
from learningorchestra_tpu.core.table import write_table as jax_write_table  # noqa: E402
from learningorchestra_tpu.ops import images as jax_images_ops  # noqa: E402
from learningorchestra_tpu.services import images as jax_images  # noqa: E402
from learningorchestra_tpu.services import validators as jax_validators  # noqa: E402
from learningorchestra_tpu_torch.core import devcache  # noqa: E402
from learningorchestra_tpu_torch.core.store import InMemoryStore  # noqa: E402
from learningorchestra_tpu_torch.core.table import ColumnTable, write_table  # noqa: E402
from learningorchestra_tpu_torch.ops import images as port_images_ops  # noqa: E402
from learningorchestra_tpu_torch.services import images, validators  # noqa: E402
from learningorchestra_tpu_torch.utils.web import ServerThread  # noqa: E402

ROWS = 40
FIELDS = ["a", "b", "c", "label"]


def raw_columns(seed=0):
    """40 rows: three numeric columns around two centres, a string label;
    one missing number and one missing label (dropped by dropna)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, ROWS)
    columns = {
        name: (rng.normal(size=ROWS) + labels * 6.0).tolist() for name in FIELDS[:3]
    }
    columns["label"] = [("yes", "no")[v] for v in labels]
    columns["a"][3] = None
    columns["label"][7] = None
    return columns


def stores(columns=None):
    """A JAX store and a port store, each holding the same ``numbers``
    dataset written by its own package."""
    columns = columns or raw_columns()
    metadata = {"filename": "numbers", "finished": True, "fields": list(columns)}
    jax_store, port_store = JaxStore(), InMemoryStore()
    jax_write_table(jax_store, "numbers", JaxTable.from_lists(columns), dict(metadata))
    write_table(port_store, "numbers", ColumnTable.from_lists(columns), dict(metadata))
    return jax_store, port_store


def answer(response):
    return response.status_code, json.loads(response.data)


def test_store_and_table_round_trip_as_the_reference():
    jax_store, port_store = stores()
    assert port_store.list_collections() == jax_store.list_collections()
    assert port_store.find_one("numbers", {"_id": 0}) == jax_store.find_one("numbers", {"_id": 0})
    assert list(port_store.find("numbers", {})) == list(jax_store.find("numbers", {}))
    theirs = JaxTable.from_store(jax_store, "numbers")
    ours = ColumnTable.from_store(port_store, "numbers")
    assert ours.field_names == theirs.field_names == FIELDS
    for name in FIELDS:
        assert ours.dtype_of(name) == theirs.dtype_of(name)
        np.testing.assert_array_equal(ours.columns[name], theirs.columns[name])
    ours, theirs = ours.dropna(), theirs.dropna()
    assert ours.num_rows == theirs.num_rows == ROWS - 2
    (ours_encoded, ours_vocab), (theirs_encoded, theirs_vocab) = ours.encoded(), theirs.encoded()
    assert ours_vocab == theirs_vocab == {"label": ["no", "yes"]}  # sorted vocabulary
    np.testing.assert_array_equal(ours_encoded.matrix(), theirs_encoded.matrix())
    assert ours_encoded.matrix().dtype == np.float64
    # a CSV read straight into a table: the same columns, types and nulls
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    for name in ("titanic_train.csv", "titanic_test.csv"):
        ours = ColumnTable.from_csv(os.path.join(data, name))
        theirs = JaxTable.from_csv(os.path.join(data, name))
        assert ours.field_names == theirs.field_names
        for field in ours.field_names:
            assert ours.dtype_of(field) == theirs.dtype_of(field), field
            np.testing.assert_array_equal(ours.columns[field], theirs.columns[field])


def test_embedding_inputs_match_the_reference():
    jax_store, port_store = stores()
    encoded, vocabularies, X = devcache.dataset_embedding_inputs(port_store, "numbers", "cpu")
    theirs_encoded, theirs_vocab, theirs_X = jax_devcache.dataset_embedding_inputs(
        jax_store, "numbers", cache=jax_devcache.DeviceCache(0)
    )
    assert vocabularies == theirs_vocab
    assert X.dtype == torch.float32 and X.device.type == "cpu"
    # the whole table, label column included, as the reference embeds it
    assert X.shape == (ROWS - 2, len(FIELDS))
    np.testing.assert_array_equal(X.numpy(), np.asarray(theirs_X.data)[: len(theirs_X)])
    np.testing.assert_array_equal(
        encoded.columns["label"], theirs_encoded.columns["label"]
    )
    table = devcache.dataset_table(port_store, "numbers", ["b"])
    assert table.field_names == ["b"] and table.num_rows == ROWS


def test_validator_messages_are_the_reference_text():
    for name in (
        "MESSAGE_INVALID_FILENAME", "MESSAGE_DUPLICATE_FILE", "MESSAGE_INVALID_LABEL",
        "MESSAGE_NOT_FOUND", "MESSAGE_MISSING_FIELDS",
    ):
        assert getattr(validators, name) == getattr(jax_validators, name)
    _, port_store = stores()
    assert validators.metadata_fields(port_store, "numbers") == FIELDS
    validators.label_in_metadata(port_store, "numbers", None)
    with pytest.raises(validators.ValidationError, match="invalid_field"):
        validators.label_in_metadata(port_store, "numbers", "nope")
    with pytest.raises(validators.ValidationError, match="invalid_filename"):
        validators.filename_exists(port_store, "missing")


def read_png(data: bytes):
    """(width, height, pixels) of an 8-bit RGB PNG with unfiltered rows."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, position = {}, 8
    while position < len(data):
        (length,) = struct.unpack(">I", data[position : position + 4])
        kind = data[position + 4 : position + 8]
        body = data[position + 8 : position + 8 + length]
        (crc,) = struct.unpack(">I", data[position + 8 + length : position + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks.setdefault(kind, b"")
        chunks[kind] += body
        position += 12 + length
    assert list(chunks)[0] == b"IHDR" and list(chunks)[-1] == b"IEND"
    width, height, depth, colour, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert (depth, colour) == (8, 2)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(height, -1)
    assert (rows[:, 0] == 0).all()
    return width, height, rows[:, 1:].reshape(height, width, 3)


@pytest.mark.parametrize("method", ["pca", "tsne"])
def test_image_services_answer_as_the_reference(method, tmp_path, monkeypatch):
    # few iterations keep the reference's t-SNE quick; the port's follows
    monkeypatch.setattr(
        port_images_ops, "EMBEDDINGS",
        {**port_images_ops.EMBEDDINGS,
         "tsne": lambda X, device=None: port_images_ops.tsne_embedding(
             X, iterations=50, device=device)},
    )
    monkeypatch.setattr(
        jax_images_ops, "EMBEDDINGS",
        {**jax_images_ops.EMBEDDINGS,
         "tsne": lambda X: jax_images_ops.tsne_embedding(X, iterations=50)},
    )
    jax_store, port_store = stores()
    theirs = jax_images.create_app(jax_store, str(tmp_path / "jax"), method).test_client()
    ours = images.create_app(
        port_store, str(tmp_path / "port"), method, device="cpu"
    ).test_client()
    key = f"{method}_filename"
    requests = [
        ("post", "/images/numbers", {key: "img", "label_name": "label"}),
        ("get", "/images", None),
        ("post", "/images/numbers", {key: "img", "label_name": None}),      # duplicate
        ("post", "/images/numbers", {key: "img2", "label_name": "nope"}),   # bad label
        ("post", "/images/numbers", {key: "../up", "label_name": None}),    # unsafe name
        ("post", "/images/missing", {key: "img3", "label_name": None}),     # no dataset
        ("post", "/images/numbers", {key: "plain", "label_name": None}),
        ("get", "/images/absent", None),
        ("get", "/images/..%2Fsecret", None),
        ("delete", "/images/img", None),
        ("delete", "/images/img", None),
        ("get", "/images/img", None),
        ("delete", "/images/..%2Fsecret", None),
    ]
    for verb, path, payload in requests:
        kwargs = {} if payload is None else {"json": payload}
        want = getattr(theirs, verb)(path, **kwargs)
        got = getattr(ours, verb)(path, **kwargs)
        want_json = json.loads(want.get_data())
        if verb == "get" and path == "/images":
            want_json["result"] = sorted(want_json["result"])
        status, body = answer(got)
        if verb == "get" and path == "/images":
            body["result"] = sorted(body["result"])
        assert (status, body) == (want.status_code, want_json), (verb, path, payload)
    assert answer(ours.get("/images")) == (200, {"result": ["plain.png"]})
    response = ours.get("/images/plain")
    assert response.status_code == 200
    assert response.headers["Content-Type"] == "image/png"
    width, height, pixels = read_png(response.data)
    assert (width, height) == (port_images_ops.WIDTH, port_images_ops.HEIGHT)
    assert response.data == (tmp_path / "port" / "plain.png").read_bytes()
    # points in the palette's first colour on a white canvas in a black frame
    colours = {tuple(c) for c in pixels.reshape(-1, 3)}
    assert (255, 255, 255) in colours and (0, 0, 0) in colours
    assert tuple(port_images_ops.PALETTE[0]) in colours
    assert sorted(os.listdir(tmp_path / "port")) == ["plain.png"]


def test_hue_colours_follow_the_label(tmp_path):
    embedded = np.array([[0.0, 0.0], [1.0, 1.0], [0.5, 0.2]], np.float32)
    canvas = port_images_ops._scatter_canvas(embedded, np.array([1.0, 0.0, 1.0]))
    colours = {tuple(c) for c in canvas.reshape(-1, 3)}
    assert tuple(port_images_ops.PALETTE[0]) in colours
    assert tuple(port_images_ops.PALETTE[1]) in colours
    assert tuple(port_images_ops.PALETTE[2]) not in colours
    # non-finite points are left out; an empty or constant embedding still draws
    port_images_ops._scatter_canvas(np.array([[np.nan, 0.0], [1.0, 1.0]]), None)
    port_images_ops._scatter_canvas(np.zeros((0, 2)), None)
    port_images_ops._scatter_canvas(np.ones((5, 2)), None)
    path = tmp_path / "x.png"
    port_images_ops._scatter_png(embedded, None, str(path))
    assert read_png(path.read_bytes())[:2] == (640, 480)


def test_create_embedding_image_writes_the_png(tmp_path):
    _, port_store = stores()
    path = port_images_ops.create_embedding_image(
        port_store, "numbers", "label", "blobs_pca", str(tmp_path / "out"), "pca", "cpu"
    )
    assert path == str(tmp_path / "out" / "blobs_pca.png")
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError, match="unsafe image filename"):
        port_images_ops.create_embedding_image(
            port_store, "numbers", None, "../x", str(tmp_path), "pca", "cpu"
        )


def test_a_failed_create_leaves_no_claim_and_no_png(tmp_path):
    _, port_store = stores()

    def create(parent_filename, label_name, output_filename):
        (tmp_path / f"{output_filename}.png").write_bytes(b"half")
        raise RuntimeError("embedding failed")

    client = images.create_app(port_store, str(tmp_path), "pca", create=create).test_client()
    response = client.post("/images/numbers", json={"pca_filename": "img", "label_name": None})
    assert response.status_code == 500
    assert b"RuntimeError: embedding failed" in response.data
    assert os.listdir(tmp_path) == []


def test_the_services_need_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, port_store = stores()
    client = images.create_app(port_store, str(tmp_path), "tsne").test_client()
    response = client.post("/images/numbers", json={"tsne_filename": "img", "label_name": None})
    assert response.status_code == 500
    assert b"no CUDA device" in response.data
    assert os.listdir(tmp_path) == []


def test_images_over_http(tmp_path):
    """GET and DELETE through the port's stdlib server, over a socket."""
    _, port_store = stores()
    server = ServerThread(
        images.create_app(port_store, str(tmp_path), "pca", device="cpu")
    ).start()
    base = f"http://127.0.0.1:{server.port}"

    def call(method, path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        request = urllib.request.Request(base + path, data=data, method=method)
        if data is not None:
            request.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(request, timeout=60) as response:
                return response.status, response.headers["Content-Type"], response.read()
        except urllib.error.HTTPError as error:
            return error.code, error.headers["Content-Type"], error.read()

    try:
        status, _, body = call("POST", "/images/numbers", {"pca_filename": "img", "label_name": "label"})
        assert (status, json.loads(body)) == (201, {"result": "created_file"})
        status, kind, body = call("GET", "/images/img")
        assert (status, kind) == (200, "image/png")
        assert read_png(body)[:2] == (640, 480)
        status, _, body = call("DELETE", "/images/img")
        assert (status, json.loads(body)) == (200, {"result": "deleted_file"})
        status, _, body = call("GET", "/images/img")
        assert (status, json.loads(body)) == (404, {"result": "file_not_found"})
    finally:
        server.stop()


@pytest.mark.parametrize("method", ["pca", "tsne"])
@pytest.mark.parametrize(
    "body, content_type, status",
    [
        (b"{bad", "application/json", 400),                       # does not parse
        (b'{"pca_filename": "x"}', "text/plain", 415),            # not declared JSON
    ],
)
def test_a_malformed_body_answers_as_the_reference(method, body, content_type, status, tmp_path):
    """werkzeug's get_json raises 400 and 415, and the reference keeps
    that status; the port's web layer answers the same, not a 500."""
    from learningorchestra_tpu_torch.utils.web import Request

    jax_store, port_store = stores()
    theirs = jax_images.create_app(jax_store, str(tmp_path / "jax"), method).test_client()
    ours = images.create_app(port_store, str(tmp_path / "port"), method, device="cpu")
    want = theirs.post("/images/x", data=body, content_type=content_type)
    got = ours.handle(Request("POST", "/images/x", {"Content-Type": content_type}, body))
    assert got.status_code == want.status_code == status
    # werkzeug's HTML page, its description escaped as werkzeug escapes it
    assert got.headers["Content-Type"] == want.headers["Content-Type"] == "text/html; charset=utf-8"
    assert got.data == want.data
    assert os.listdir(tmp_path / "port") == []


def _socket_answer(port: int, method: str, path: str, body=None, content_type=None):
    """(status, Content-Type, Allow, Content-Length, body) of one request
    over a socket."""
    import http.client

    connection = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        connection.request(
            method, path, body=body, headers={} if content_type is None else {"Content-Type": content_type}
        )
        response = connection.getresponse()
        return (
            response.status, *(response.getheader(key) for key in ("Content-Type", "Allow", "Content-Length")),
            response.read(),
        )
    finally:
        connection.close()


METHOD_CASES = [
    (method, path)
    for method in ("HEAD", "PUT", "PATCH", "OPTIONS")
    for path in ("/images", "/images/nothing", "/images/numbers", "/nothing")
]
ERROR_BODIES = [(b"{bad", "application/json"), (b'{"pca_filename": "x"}', "text/plain")]


@pytest.mark.parametrize("method, path", METHOD_CASES)
def test_methods_answer_as_the_reference_in_process(method, path, tmp_path):
    """HEAD on a GET rule answers the GET's status and headers with no
    body; a method the path's rules lack answers werkzeug's 405 page with
    its Allow header (in werkzeug's order); an unknown path 404 JSON."""
    from learningorchestra_tpu_torch.utils.web import Request

    jax_store, port_store = stores()
    theirs = jax_images.create_app(jax_store, str(tmp_path / "jax"), "pca").test_client()
    ours = images.create_app(port_store, str(tmp_path / "port"), "pca", device="cpu")
    want = theirs.open(path, method=method)
    got = ours.handle(Request(method, path))
    assert (got.status_code, got.headers.get("Content-Type"), got.headers.get("Allow"), got.data) == (
        want.status_code, want.headers.get("Content-Type"), want.headers.get("Allow"), want.data
    )
    assert got.status_code in (200, 404, 405)


def test_methods_and_error_pages_answer_as_the_reference_over_a_socket(tmp_path):
    """The same over real HTTP, both apps served at once: HEAD, PUT,
    PATCH and OPTIONS, then a malformed and an undeclared body, exact on
    status, Content-Type, Allow, Content-Length and body bytes."""
    from learningorchestra_tpu.utils.web import ServerThread as JaxServerThread

    jax_store, port_store = stores()
    theirs = JaxServerThread(
        jax_images.create_app(jax_store, str(tmp_path / "jax"), "pca"), "127.0.0.1", 0
    ).start()
    ours = ServerThread(images.create_app(port_store, str(tmp_path / "port"), "pca", device="cpu")).start()
    try:
        for method, path in METHOD_CASES:
            want = _socket_answer(theirs.port, method, path)
            assert _socket_answer(ours.port, method, path) == want, (method, path)
        for body, content_type in ERROR_BODIES:
            want = _socket_answer(theirs.port, "POST", "/images/x", body, content_type)
            assert want[0] in (400, 415)
            assert _socket_answer(ours.port, "POST", "/images/x", body, content_type) == want
    finally:
        theirs.stop()
        ours.stop()
    assert os.listdir(tmp_path / "port") == []


def test_silent_get_json_still_gives_none():
    from learningorchestra_tpu_torch.utils.web import Request

    assert Request("POST", "/", {"Content-Type": "text/plain"}, b"{}").get_json(silent=True) is None
    assert Request("POST", "/", {"Content-Type": "application/json"}, b"{bad").get_json(silent=True) is None
    assert Request("POST", "/", {"Content-Type": "application/vnd.x+json"}, b"[1]").get_json() == [1]


def test_pca_of_one_row_answers_201_as_the_reference(tmp_path):
    """One row: the reference's covariance is 0/0, its embedding NaN, and
    its PNG has no points; the port answers the same without eigh of a
    NaN matrix."""
    columns = {"a": [1.0], "b": [2.0], "c": [3.0], "label": ["yes"]}
    jax_store, port_store = stores(columns)
    theirs = jax_images.create_app(jax_store, str(tmp_path / "jax"), "pca").test_client()
    ours = images.create_app(port_store, str(tmp_path / "port"), "pca", device="cpu").test_client()
    request = {"pca_filename": "one", "label_name": "label"}
    want = theirs.post("/images/numbers", json=request)
    got = ours.post("/images/numbers", json=request)
    assert answer(got) == (want.status_code, json.loads(want.get_data())) == (201, {"result": "created_file"})
    _, _, pixels = read_png((tmp_path / "port" / "one.png").read_bytes())
    colours = {tuple(c) for c in pixels.reshape(-1, 3)}
    assert colours == {(255, 255, 255), (0, 0, 0)}   # the frame, no points
    assert (tmp_path / "jax" / "one.png").exists()


def test_pca_of_fewer_than_two_rows_is_nan_and_of_two_is_not():
    from learningorchestra_tpu_torch.ops import pca as port_pca

    X = torch.tensor([[1.0, 2.0, 3.0]])
    for mask in (torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool)):
        embedded, components, explained = port_pca._pca(X, mask, 2)
        assert embedded.shape == (1, 2) and components.shape == (3, 2) and explained.shape == (2,)
        assert torch.isnan(embedded).all() and torch.isnan(components).all()
        assert torch.isnan(explained).all()
    embedded = port_pca.pca_embedding(np.array([[0.0, 1.0], [2.0, 5.0]]), device="cpu")
    assert np.isfinite(embedded).all()


@pytest.mark.parametrize("method", ["tsne", "pca"])
def test_a_dataset_that_dropna_empties_answers_as_the_reference(method, tmp_path):
    """Every row holds a missing value, so ``dropna`` leaves none: the
    reference's t-SNE fails in its calibration (a maximum over no columns)
    and answers 500 with that error, no PNG and its claim released; its
    PCA answers 201 with an empty plot. The port answers the same."""
    columns = {
        "a": [None, 1.0, 2.0], "b": [1.0, None, 3.0], "c": [1.0, 2.0, None],
        "label": ["yes", "no", "yes"],
    }
    jax_store, port_store = stores(columns)
    theirs = jax_images.create_app(jax_store, str(tmp_path / "jax"), method).test_client()
    ours = images.create_app(port_store, str(tmp_path / "port"), method, device="cpu").test_client()
    request = {f"{method}_filename": "empty", "label_name": "label"}
    want = theirs.post("/images/numbers", json=request)
    got = ours.post("/images/numbers", json=request)
    assert got.status_code == want.status_code == (500 if method == "tsne" else 201)
    assert got.data == want.get_data()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert os.listdir(tmp_path / "port") == ([] if method == "tsne" else ["empty.png"])

