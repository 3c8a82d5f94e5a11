"""`pyspark` import shim + the preprocessor-code runner.

The reference ``exec()``s user code that begins with real PySpark imports
(``from pyspark.ml import Pipeline``, ``from pyspark.sql.functions import
...``, ``from pyspark.ml.feature import ...`` — reference
docs/model_builder.md example). For that exact code to run unchanged,
those module paths must resolve to this package's expression and feature
implementations.

The port's copy of ``learningorchestra_tpu/frame/pyspark_compat.py``,
with one difference: :func:`run_preprocessor` resolves ``pyspark.*``
through an ``__import__`` of its own exec scope, and the port never
reads or writes ``sys.modules`` (it has no ``install_pyspark_shim``).
The JAX package registers its shim there and keeps whatever ``pyspark``
it finds, so in a process that holds both packages each package's user
code runs against its own classes, whichever ran first.

Running user-supplied code is the reference's documented contract
(model_builder.py:144-145 ``exec(preprocessor_code, ...)``), arbitrary
code execution included; deployments that need isolation should sandbox
the model-builder service process, exactly as they would the reference's.
"""

from __future__ import annotations

import builtins
import functools
import types

from learningorchestra_tpu_torch.frame import expressions as _expressions
from learningorchestra_tpu_torch.frame import feature as _feature


def _module(name: str, **attrs) -> types.ModuleType:
    module = types.ModuleType(name)
    for key, value in attrs.items():
        setattr(module, key, value)
    return module


@functools.lru_cache(maxsize=None)
def pyspark_modules() -> dict[str, types.ModuleType]:
    """``{dotted name: module}`` of the shim, built once."""
    functions = _module(
        "pyspark.sql.functions",
        col=_expressions.col,
        lit=_expressions.lit,
        when=_expressions.when,
        mean=_expressions.mean,
        split=_expressions.split,
        regexp_extract=_expressions.regexp_extract,
    )
    feature = _module(
        "pyspark.ml.feature",
        StringIndexer=_feature.StringIndexer,
        VectorAssembler=_feature.VectorAssembler,
    )
    ml = _module("pyspark.ml", Pipeline=_feature.Pipeline, feature=feature)
    sql = _module("pyspark.sql", functions=functions)
    pyspark = _module("pyspark", ml=ml, sql=sql)
    return {
        "pyspark": pyspark,
        "pyspark.ml": ml,
        "pyspark.ml.feature": feature,
        "pyspark.sql": sql,
        "pyspark.sql.functions": functions,
    }


def _shim_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` for preprocessor code: ``pyspark`` and its
    submodules from the shim, everything else as usual."""
    if level == 0 and (name == "pyspark" or name.startswith("pyspark.")):
        modules = pyspark_modules()
        if name not in modules:
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        # `import a.b` binds `a`; `from a.b import c` takes from `a.b`
        return modules[name] if fromlist else modules["pyspark"]
    return builtins.__import__(name, globals, locals, fromlist, level)


def fields_from_dataframe(dataframe, is_string: bool) -> list[str]:
    """The helper the reference exposes to preprocessor code
    (model_builder.py:118-131): classify columns by the type of the
    first row's value."""
    first_row = dataframe.first()
    names = []
    for column in dataframe.schema.names:
        value = first_row[column] if first_row is not None else None
        if is_string == isinstance(value, str):
            names.append(column)
    return names


def run_preprocessor(code: str, training_df, testing_df) -> dict:
    """Execute user preprocessing code with the reference's environment
    contract (docs/model_builder.md): ``training_df``/``testing_df`` in
    scope; the code must bind ``features_training``, ``features_testing``
    and ``features_evaluation`` (None allowed)."""

    class _SelfProxy:
        """The reference exec()s code inside a method, so user code can
        call ``self.fields_from_dataframe(...)``."""

        @staticmethod
        def fields_from_dataframe(dataframe, is_string):
            return fields_from_dataframe(dataframe, is_string)

    scope = {
        "__builtins__": {**vars(builtins), "__import__": _shim_import},
        "training_df": training_df,
        "testing_df": testing_df,
        "self": _SelfProxy(),
        "fields_from_dataframe": fields_from_dataframe,
    }
    exec(code, scope, scope)
    missing = [
        name
        for name in ("features_training", "features_testing", "features_evaluation")
        if name not in scope
    ]
    if missing:
        raise KeyError(
            f"preprocessor_code must define {missing} "
            "(reference contract, docs/model_builder.md)"
        )
    return {
        "features_training": scope["features_training"],
        "features_testing": scope["features_testing"],
        "features_evaluation": scope["features_evaluation"],
    }
