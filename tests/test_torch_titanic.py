"""The documented Titanic walkthrough on the port, end to end over REST.

Two JAX-package test files are read and run here with their module paths
pointed at the port, on the CPU:

- ``tests/test_titanic_golden.py``: ingest the regenerated Titanic
  (``tests/data/titanic_*.csv``) through ``/files``, project the
  documented fields, cast them through ``/fieldtypes``, then ``POST
  /models`` with the verbatim published preprocessor and all five
  classifiers. Each classifier's accuracy and F1 must fall in the
  reference's bands (the leak classifiers >= 0.95, nb the weak learner;
  with the leak removed, every classifier in 0.70-0.95).
- ``tests/test_integration.py``: all seven services of the port's runner
  (``start_all(ephemeral=True, device="cpu")``) driven by the JAX
  package's client, unchanged: ingest, projection, cast, histogram, a
  build, a PCA plot, the client's error semantics, and one stitched
  Chrome trace (``GET /traces/<cid>``) of a client-driven ingest,
  projection and histogram, with a process row per service.

Added here: the same walkthrough through the reference's apps and the
port's, each over its own store: the projected and cast collections hold
equal documents, and the verbatim preprocessor assembles bit-equal
training, evaluation and test frames from them in each package.
"""

import json
import pathlib
import re

import numpy as np
import pytest

from learningorchestra_tpu.core.jobs import JobManager as JaxJobManager
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore
from learningorchestra_tpu.frame.pyspark_compat import run_preprocessor as jax_run_preprocessor
from learningorchestra_tpu.ml.builder import load_dataframe as jax_load_dataframe
from learningorchestra_tpu.services import data_type_handler as jax_dtype_app
from learningorchestra_tpu.services import database_api as jax_database_api
from learningorchestra_tpu.services import projection as jax_projection
from learningorchestra_tpu_torch.core.jobs import JobManager as PortJobManager
from learningorchestra_tpu_torch.core.store import InMemoryStore as PortStore
from learningorchestra_tpu_torch.frame.pyspark_compat import run_preprocessor as port_run_preprocessor
from learningorchestra_tpu_torch.ml.builder import load_dataframe as port_load_dataframe
from learningorchestra_tpu_torch.services import data_type_handler as port_dtype_app
from learningorchestra_tpu_torch.services import database_api as port_database_api
from learningorchestra_tpu_torch.services import projection as port_projection

_HERE = pathlib.Path(__file__)


def _port_source(name: str, replacements) -> str:
    source = (
        _HERE.with_name(name)
        .read_text()
        .replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
        # the client stays the JAX package's: the port serves its routes
        .replace("learningorchestra_tpu_torch.client", "learningorchestra_tpu.client")
    )
    for pattern, replacement, count in replacements:
        source, n = re.subn(pattern, replacement, source)
        assert n == count, (pattern, n)
    return source


def _run(name: str, replacements) -> tuple:
    """Run a JAX-package test file, rewritten for the port, in a namespace
    of its own."""
    source = _port_source(name, replacements)
    namespace = {"__name__": f"tests.torch_{name[:-3]}", "__file__": str(_HERE.with_name(name))}
    exec(compile(source, str(_HERE.with_name(name)), "exec"), namespace)  # noqa: S102
    return source, namespace


_golden_source, _golden = _run(
    "test_titanic_golden.py",
    [(r"model_builder\.create_app\(store\)", 'model_builder.create_app(store, device="cpu")', 1)],
)
_integration_source, _integration = _run(
    "test_integration.py",
    [
        (
            r"start_all\(store, images_dir, ephemeral=True\)",
            'start_all(store, images_dir, ephemeral=True, device="cpu")',
            1,
        ),
    ],
)

NOT_PORTED = ()

test_documented_walkthrough_runs_verbatim = _golden["test_documented_walkthrough_runs_verbatim"]
test_clean_pipeline_matches_canonical_titanic_quality = _golden[
    "test_clean_pipeline_matches_canonical_titanic_quality"
]
stack = _integration["stack"]
test_titanic_walkthrough = _integration["test_titanic_walkthrough"]
test_pretty_response_returns_json_string = _integration["test_pretty_response_returns_json_string"]
test_client_pipeline_yields_one_stitched_trace = _integration["test_client_pipeline_yields_one_stitched_trace"]


@pytest.fixture()
def store():
    return PortStore()


def test_the_reference_tests_run_on_the_port():
    """The rewritten sources drive the port's apps and runner, and only
    the client is the JAX package's."""
    from learningorchestra_tpu_torch.services import runner

    assert _integration["start_all"] is runner.start_all
    assert _golden["database_api"] is port_database_api
    assert not re.findall(r"learningorchestra_tpu\.\w+", _golden_source)
    assert set(re.findall(r"learningorchestra_tpu\.\w+", _integration_source)) == {"learningorchestra_tpu.client"}
    tests = [name for name in _integration if name.startswith("test_")]
    assert sorted(tests) == sorted(
        ["test_titanic_walkthrough", "test_pretty_response_returns_json_string",
         "test_client_pipeline_yields_one_stitched_trace", *NOT_PORTED]
    )


# --------------------------------------------------------------------------
# The walkthrough's frames against the reference's
# --------------------------------------------------------------------------

PACKAGES = {
    "reference": (JaxStore, JaxJobManager, jax_database_api, jax_projection, jax_dtype_app,
                  jax_load_dataframe, jax_run_preprocessor),
    "port": (PortStore, PortJobManager, port_database_api, port_projection, port_dtype_app,
             port_load_dataframe, port_run_preprocessor),
}


def _walk(package: str) -> tuple:
    """Ingest, project and cast the two CSVs through one package's apps;
    returns the store."""
    store_cls, manager_cls, files, projection, dtype_app, _, _ = PACKAGES[package]
    store = store_cls()
    jobs = manager_cls()
    db = files.create_app(store, jobs).test_client()
    proj = projection.create_app(store, jobs).test_client()
    dtype = dtype_app.create_app(store, jobs).test_client()
    for name, path in (("titanic_training", _golden["TRAIN_CSV"]), ("titanic_testing", _golden["TEST_CSV"])):
        assert db.post("/files", json={"filename": name, "url": path}).status_code == 201
        jobs.wait(f"ingest:{name}", timeout=60)
        fields = [f for f in _golden["PROJECTION_FIELDS"] if name == "titanic_training" or f != "Survived"]
        response = proj.post(
            f"/projections/{name}", json={"projection_filename": f"{name}_projection", "fields": fields}
        )
        assert response.status_code == 201
        types = {f: "number" for f in ("Age", "Parch", "PassengerId", "Pclass", "SibSp")}
        if name == "titanic_training":
            types["Survived"] = "number"
        assert dtype.patch(f"/fieldtypes/{name}_projection", json=types).status_code == 200
    return store


def _documents(store, collection: str) -> list:
    return [
        json.dumps(document, sort_keys=True, default=repr)
        for document in store.find(collection, {})
        if "time_created" not in document
    ]


@pytest.fixture(scope="module")
def walked():
    return {package: _walk(package) for package in PACKAGES}


@pytest.mark.parametrize("collection", ["titanic_training_projection", "titanic_testing_projection"])
def test_projected_and_cast_collections_equal_the_references(walked, collection):
    assert _documents(walked["port"], collection) == _documents(walked["reference"], collection)


@pytest.mark.parametrize("preprocessor", ["documented", "clean"])
def test_assembled_frames_are_bit_equal_to_the_references(walked, preprocessor):
    code = {
        "documented": _golden["PREPROCESSING_CODE"],
        "clean": _golden["CLEAN_PREPROCESSING_CODE"],
    }[preprocessor]
    frames = {}
    for package, store in walked.items():
        load, run = PACKAGES[package][5], PACKAGES[package][6]
        frames[package] = run(
            code, load(store, "titanic_training_projection"), load(store, "titanic_testing_projection")
        )
    for key in ("features_training", "features_evaluation", "features_testing"):
        port, reference = frames["port"][key], frames["reference"][key]
        assert port.columns == reference.columns, key
        np.testing.assert_array_equal(port.feature_matrix(), reference.feature_matrix())
        assert port.feature_matrix().dtype == reference.feature_matrix().dtype
        np.testing.assert_array_equal(port.label_vector(), reference.label_vector())
