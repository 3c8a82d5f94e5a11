"""The JAX package's frame tests (``tests/test_frame.py``), run on the
port's copy of the frame (``learningorchestra_tpu_torch/frame/``) and of
the ingest, the field-type casts and the table they go through.

Their source is read and run here with every module path pointed at the
port: expressions, verbs, the feature stages, the documented preprocessor
verbatim over an ingested CSV, and the review regressions. Then the
``pyspark`` shim's isolation: the JAX package registers its shim in
``sys.modules`` and keeps whatever ``pyspark`` it finds there, so the
port resolves ``pyspark`` inside its own exec scope and never touches
``sys.modules``. In one process, whichever package runs preprocessor
code first, each runs against its own classes, and both give the same
assembled matrices.
"""

import pathlib
import sys

import numpy as np
import pytest

from learningorchestra_tpu.frame import feature as jax_feature
from learningorchestra_tpu.frame import expressions as jax_expressions
from learningorchestra_tpu.frame.pyspark_compat import run_preprocessor as jax_run_preprocessor
from learningorchestra_tpu.frame.dataframe import DataFrame as JaxDataFrame
from learningorchestra_tpu.core.table import ColumnTable as JaxTable
from learningorchestra_tpu_torch.core.store import InMemoryStore as PortStore
from learningorchestra_tpu_torch.frame import expressions as port_expressions
from learningorchestra_tpu_torch.frame import feature as port_feature

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_frame.py")
_source = REFERENCE_TESTS.read_text().replace(
    "learningorchestra_tpu.", "learningorchestra_tpu_torch."
)
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


@pytest.fixture()
def store():
    return PortStore()


def test_the_reference_tests_run_on_the_port():
    from learningorchestra_tpu_torch.frame import dataframe

    assert DataFrame is dataframe.DataFrame  # noqa: F821
    assert "learningorchestra_tpu." not in _source


# --------------------------------------------------------------------------
# The pyspark shim, in a process that holds both packages
# --------------------------------------------------------------------------

PROBE = """
from pyspark.ml import Pipeline
from pyspark.ml.feature import StringIndexer, VectorAssembler
import pyspark.sql.functions
from pyspark.sql.functions import col, lit, mean, regexp_extract, split, when
features_training = (Pipeline, StringIndexer, VectorAssembler, pyspark.sql.functions.col,
                     col, lit, mean, regexp_extract, split, when)
features_testing = features_evaluation = None
"""


def own_classes(feature, expressions):
    return (
        feature.Pipeline, feature.StringIndexer, feature.VectorAssembler, expressions.col,
        expressions.col, expressions.lit, expressions.mean, expressions.regexp_extract,
        expressions.split, expressions.when,
    )


PACKAGES = {
    "jax": (jax_run_preprocessor, own_classes(jax_feature, jax_expressions)),
    "port": (run_preprocessor, own_classes(port_feature, port_expressions)),  # noqa: F821
}


def pyspark_entries() -> dict:
    return {
        name: module for name, module in sys.modules.items()
        if name == "pyspark" or name.startswith("pyspark.")
    }


@pytest.fixture()
def no_pyspark():
    """A process with no ``pyspark`` registered; the entries as they were
    come back after the test."""
    saved = pyspark_entries()
    for name in saved:
        del sys.modules[name]
    yield
    for name in pyspark_entries():
        del sys.modules[name]
    sys.modules.update(saved)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_each_package_runs_its_preprocessor_against_its_own_shim(first, no_pyspark):
    second = "port" if first == "jax" else "jax"
    for turn, name in enumerate((first, second, first)):
        runner, classes = PACKAGES[name]
        got = runner(PROBE, None, None)["features_training"]
        assert got == classes, name
        if turn == 0 and name == "port":
            assert pyspark_entries() == {}  # the port leaves sys.modules alone
    assert sys.modules["pyspark.ml.feature"].VectorAssembler is jax_feature.VectorAssembler


@pytest.mark.parametrize("first", ["jax", "port"])
def test_documented_preprocessor_gives_the_same_matrices_in_either_order(first, no_pyspark, titanic_csv):
    tables = {"jax": JaxTable.from_csv(titanic_csv), "port": ColumnTable.from_csv(titanic_csv)}  # noqa: F821
    frames = {"jax": JaxDataFrame, "port": DataFrame}  # noqa: F821
    out = {}
    for name in (first, "port" if first == "jax" else "jax"):
        runner, _ = PACKAGES[name]
        training = frames[name].from_table(tables[name])
        testing = frames[name].from_table(tables[name]).drop("Survived")
        out[name] = runner(DOCUMENTED_PREPROCESSOR, training, testing)  # noqa: F821
        assert type(out[name]["features_training"]) is frames[name]
    for key in ("features_training", "features_evaluation", "features_testing"):
        np.testing.assert_array_equal(
            out["port"][key].feature_matrix(), out["jax"][key].feature_matrix()
        )
        np.testing.assert_array_equal(
            out["port"][key].label_vector(), out["jax"][key].label_vector()
        )
