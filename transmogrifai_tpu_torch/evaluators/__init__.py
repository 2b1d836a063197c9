"""Evaluators (reference: core/.../evaluators/)."""
from .base import EvalMetrics, Evaluator  # noqa: F401
from .binary import BinaryClassificationEvaluator  # noqa: F401
from .multiclass import MultiClassificationEvaluator  # noqa: F401
from .regression import RegressionEvaluator  # noqa: F401
from .forecast import ForecastEvaluator  # noqa: F401
from .binscore import BinScoreEvaluator  # noqa: F401
