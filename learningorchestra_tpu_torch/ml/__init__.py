"""Estimators: the fits of the five classifiers (lr, dt, rf, gb and nb,
``make_classifier``) and the predict half of every checkpoint kind (see
``checkpoint``).

Counterpart of ``learningorchestra_tpu/ml/__init__.py:17-29``.
"""

from learningorchestra_tpu_torch.ml.base import CLASSIFIER_NAMES, make_classifier
from learningorchestra_tpu_torch.ml.evaluation import accuracy_score, f1_score
from learningorchestra_tpu_torch.ml.logistic import LogisticRegression
from learningorchestra_tpu_torch.ml.naive_bayes import NaiveBayes
from learningorchestra_tpu_torch.ml.trees import (
    DecisionTreeClassifier,
    GBTClassifier,
    RandomForestClassifier,
)

__all__ = [
    "CLASSIFIER_NAMES",
    "make_classifier",
    "accuracy_score",
    "f1_score",
    "LogisticRegression",
    "NaiveBayes",
    "DecisionTreeClassifier",
    "RandomForestClassifier",
    "GBTClassifier",
]
