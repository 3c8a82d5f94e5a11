"""The four data services and the service routes, on the port.

The JAX package's ``tests/test_services.py`` is read and run here with
its module paths pointed at the port's apps
(``learningorchestra_tpu_torch/services/``): ``/files`` (async ingest,
the job listing, 406, 409, the page cap of 20, reads and deletes, the
query pass-through and its 400s), ``/projections``, ``/fieldtypes``,
``/histograms`` (their validators and the one-winner race of two equal
creates), the model builder's validators and async builds, and the PCA
image routes; ``model_builder`` and ``images`` run on the CPU
(``device="cpu"``).

Added here: each data route held against the reference's app in
process. The same requests go to both packages' apps, each over its own
store holding the same CSV, and the status and JSON body must be equal,
byte for byte once parsed: the 201 (200 for ``/fieldtypes``), the 406s,
the 409s and the 429 of a full host queue; then the documents the
routes wrote (the ingested rows, the projection, the cast columns, the
histogram) must be equal too.
"""

import json
import pathlib
import re
import threading
import time

import pytest

from learningorchestra_tpu.core.jobs import JobManager as JaxJobManager
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore
from learningorchestra_tpu.sched.scheduler import Scheduler as JaxScheduler
from learningorchestra_tpu.services import data_type_handler as jax_dtype_app
from learningorchestra_tpu.services import database_api as jax_database_api
from learningorchestra_tpu.services import histogram as jax_histogram
from learningorchestra_tpu.services import projection as jax_projection
from learningorchestra_tpu_torch.core.jobs import JobManager as PortJobManager
from learningorchestra_tpu_torch.core.store import InMemoryStore as PortStore
from learningorchestra_tpu_torch.sched.scheduler import Scheduler as PortScheduler
from learningorchestra_tpu_torch.services import data_type_handler as port_dtype_app
from learningorchestra_tpu_torch.services import database_api as port_database_api
from learningorchestra_tpu_torch.services import histogram as port_histogram
from learningorchestra_tpu_torch.services import projection as port_projection

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_services.py")

_source = REFERENCE_TESTS.read_text().replace(
    "learningorchestra_tpu.", "learningorchestra_tpu_torch."
)
for _pattern, _replacement, _count in (
    (r'model_builder\.create_app\((\w+)\)', r'model_builder.create_app(\1, device="cpu")', 3),
    (r'images\.create_app\(([^()]*(?:\([^()]*\))?[^()]*), "pca"\)', r'images.create_app(\1, "pca", device="cpu")', 7),
):
    _source, _n = re.subn(_pattern, _replacement, _source)
    assert _n == _count, (_pattern, _n)
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


@pytest.fixture()
def store():
    return PortStore()


def test_the_reference_tests_run_on_the_port():
    from learningorchestra_tpu_torch.services import database_api as port_module

    assert database_api is port_module  # noqa: F821
    assert "learningorchestra_tpu." not in _source
    classes = [name for name in globals() if name.startswith("Test")]
    assert len(classes) == 13, classes


# --------------------------------------------------------------------------
# The data routes against the reference's apps
# --------------------------------------------------------------------------

PACKAGES = {
    "reference": (JaxStore, JaxJobManager, JaxScheduler, jax_database_api,
                  jax_projection, jax_dtype_app, jax_histogram),
    "port": (PortStore, PortJobManager, PortScheduler, port_database_api,
             port_projection, port_dtype_app, port_histogram),
}


class _Stack:
    """One package's four data apps over one store and one job manager
    (one host worker, a queue of one, so a held job and one queued job
    fill it)."""

    def __init__(self, package: str):
        (store_cls, manager_cls, scheduler_cls, files, projection_module,
         dtype_module, histogram_module) = PACKAGES[package]
        self.store = store_cls()
        self.jobs = manager_cls(scheduler=scheduler_cls(host_width=1, queue_cap=1))
        self.clients = {
            "files": files.create_app(self.store, self.jobs).test_client(),
            "projections": projection_module.create_app(self.store, self.jobs).test_client(),
            "fieldtypes": dtype_module.create_app(self.store, self.jobs).test_client(),
            "histograms": histogram_module.create_app(self.store, self.jobs).test_client(),
        }

    def send(self, service: str, method: str, path: str, payload) -> tuple:
        client = self.clients[service]
        response = getattr(client, method)(path, json=payload)
        return response.status_code, json.loads(response.get_data()), response.headers.get("Retry-After")

    def ingest(self, name: str, url: str) -> tuple:
        answer = self.send("files", "post", "/files", {"filename": name, "url": url})
        if answer[0] == 201:
            self.jobs.wait(f"ingest:{name}", timeout=30)
        return answer

    def fill_host_queue(self) -> threading.Event:
        """A held job running and one queued: the next host submit is
        refused with 429."""
        gate = threading.Event()
        self.jobs.submit("hold", gate.wait)
        deadline = time.time() + 5
        while self.jobs.get("hold").state == "pending":
            assert time.time() < deadline
            time.sleep(0.005)
        self.jobs.submit("queued", lambda: None)
        return gate

    def documents(self, collection: str) -> list:
        return sorted(
            (json.dumps(d, sort_keys=True, default=repr) for d in self.store.find(collection, {})
             if "time_created" not in d),
        )


REQUESTS = [
    # (service, method, path, body)
    ("files", "post", "/files", "bad-url"),
    ("files", "post", "/files", "duplicate"),
    ("projections", "post", "/projections/titanic",
     {"projection_filename": "proj", "fields": ["Name", "Sex", "Age"]}),
    ("projections", "post", "/projections/titanic",
     {"projection_filename": "proj", "fields": ["Name"]}),
    ("projections", "post", "/projections/ghost",
     {"projection_filename": "proj2", "fields": ["Name"]}),
    ("projections", "post", "/projections/titanic",
     {"projection_filename": "proj3", "fields": []}),
    ("projections", "post", "/projections/titanic",
     {"projection_filename": "proj4", "fields": ["Nope"]}),
    ("fieldtypes", "patch", "/fieldtypes/titanic",
     {"Age": "number", "Fare": "number", "Survived": "number"}),
    ("fieldtypes", "patch", "/fieldtypes/ghost", {"Age": "number"}),
    ("fieldtypes", "patch", "/fieldtypes/titanic", {}),
    ("fieldtypes", "patch", "/fieldtypes/titanic", {"Age": "float"}),
    ("fieldtypes", "patch", "/fieldtypes/titanic", {"Nope": "number"}),
    ("histograms", "post", "/histograms/titanic",
     {"histogram_filename": "hist", "fields": ["Sex", "Survived", "Age"]}),
    ("histograms", "post", "/histograms/titanic",
     {"histogram_filename": "hist", "fields": ["Sex"]}),
    ("histograms", "post", "/histograms/ghost",
     {"histogram_filename": "hist2", "fields": ["Sex"]}),
    ("histograms", "post", "/histograms/titanic",
     {"histogram_filename": "hist3", "fields": ["Nope"]}),
]


def _body(payload, titanic_csv, bad_url):
    if payload == "bad-url":
        return {"filename": "bad", "url": bad_url}
    if payload == "duplicate":
        return {"filename": "titanic", "url": titanic_csv}
    return payload


def test_data_routes_answer_as_the_reference(titanic_csv, tmp_path):
    """Every request answers the reference's status and body, and the
    collections the 201s wrote hold the reference's documents."""
    bad_url = tmp_path / "bad.html"
    bad_url.write_text("<html></html>")
    stacks = {name: _Stack(name) for name in PACKAGES}
    answers = {}
    for name, stack in stacks.items():
        answers[name] = [stack.ingest("titanic", titanic_csv)] + [
            stack.send(service, method, path, _body(payload, titanic_csv, str(bad_url)))
            for service, method, path, payload in REQUESTS
        ]
    assert answers["port"] == answers["reference"]
    statuses = [status for status, _, _ in answers["port"]]
    assert statuses == [201, 406, 409, 201, 409, 406, 406, 406,
                        200, 406, 406, 406, 406, 201, 409, 406, 406]
    for collection in ("titanic", "proj", "hist"):
        assert stacks["port"].documents(collection) == stacks["reference"].documents(collection)


@pytest.mark.parametrize(
    "service, method, path, payload, collection",
    [
        ("files", "post", "/files", "flood", "flood"),
        ("projections", "post", "/projections/titanic",
         {"projection_filename": "proj", "fields": ["Name"]}, "proj"),
        ("fieldtypes", "patch", "/fieldtypes/titanic", {"Age": "number"}, None),
        ("histograms", "post", "/histograms/titanic",
         {"histogram_filename": "hist", "fields": ["Sex"]}, "hist"),
    ],
    ids=["files", "projections", "fieldtypes", "histograms"],
)
def test_full_host_queue_answers_the_references_429(titanic_csv, service, method, path, payload, collection):
    """A full host queue: each route answers the reference's 429 body and
    ``Retry-After``, and releases its name claim (the same request then
    succeeds once the queue drains)."""
    answers = {}
    for name in PACKAGES:
        stack = _Stack(name)
        stack.ingest("titanic", titanic_csv)
        body = {"filename": "flood", "url": titanic_csv} if payload == "flood" else payload
        gate = stack.fill_host_queue()
        try:
            answers[name] = stack.send(service, method, path, body)
        finally:
            gate.set()
        stack.jobs.wait("queued", timeout=30)
        if collection is not None:
            assert collection not in stack.store.list_collections()
        retried = stack.send(service, method, path, body)
        assert retried[0] in (200, 201), retried
    assert answers["port"] == answers["reference"]
    status, result, retry_after = answers["port"]
    assert status == 429 and result["result"] == "queue_full" and int(retry_after) >= 1
