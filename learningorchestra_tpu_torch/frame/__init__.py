"""Host-side columnar dataframe with the PySpark surface the reference
exposes to user preprocessing code.

The reference ``exec()``s user-supplied PySpark against ``training_df`` /
``testing_df`` (reference: microservices/model_builder_image/
model_builder.py:144-149) and documents exactly which verbs that code may
use (reference: docs/model_builder.md "preprocessor_code example"):
withColumn / withColumnRenamed / replace / na.fill / drop / randomSplit,
the functions ``col, lit, when, regexp_extract, split, mean``, and the
feature stages ``StringIndexer`` / ``VectorAssembler`` (plus ``Pipeline``).
That documented surface is the compatibility contract — full PySpark
emulation is explicitly out of scope.

Design: eager numpy columns (numeric → float64 with NaN, strings →
object with None, assembled vectors → 2-D float64), expression trees
evaluated per-frame. Preprocessing is host work; the device path starts
when the assembled ``features`` matrix reaches an estimator.

The port's copy of ``learningorchestra_tpu/frame/``: host numpy, copied
as it is (``randomSplit(seed=33)`` splits the same rows in either
package). The device copies of ``DataFrame`` go to a ``torch.device``,
and ``run_preprocessor`` resolves ``pyspark`` imports without touching
``sys.modules``.
"""

from learningorchestra_tpu_torch.frame.dataframe import DataFrame
from learningorchestra_tpu_torch.frame.expressions import (
    col,
    lit,
    mean,
    regexp_extract,
    split,
    when,
)
from learningorchestra_tpu_torch.frame.feature import (
    Pipeline,
    StringIndexer,
    VectorAssembler,
)

__all__ = [
    "DataFrame",
    "col",
    "lit",
    "mean",
    "regexp_extract",
    "split",
    "when",
    "Pipeline",
    "StringIndexer",
    "VectorAssembler",
]
