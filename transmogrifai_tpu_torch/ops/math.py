"""Math transformers: arithmetic on numeric features.

Reference: core/.../stages/impl/feature/MathTransformers.scala (binary
+, -, *, / with their empty-value truth tables, the scalar variants, and
unary abs / ceil / floor / round / exp / sqrt / log / power /
round-digits). Each is a columnar function of (values, mask) pairs in
float64 on the host, as in ``transmogrifai_tpu/ops/math.py``, so values and
masks equal the reference's bit for bit.

Truth tables (MathTransformers.scala:43-49, :83-89, :131-137, :178-184):
  plus / minus: one side missing -> that side is the identity (x, or -y
                for minus); both missing -> missing.
  multiply / divide: either side missing -> missing; a result that is not
                finite (division by zero, overflow) -> missing.
The unary stages make a result that is not finite (log or sqrt out of
domain, overflow) missing.
"""
from __future__ import annotations

import numpy as np

from ..stages.base import Transformer
from ..types import OPNumeric, Real
from ..types.columns import Column, NumericColumn


def _vals(col: Column) -> tuple[np.ndarray, np.ndarray]:
    assert isinstance(col, NumericColumn), type(col)
    return col.values.astype(np.float64), col.mask


class _BinaryMath(Transformer):
    """Two-feature arithmetic producing Real."""

    input_types = (OPNumeric, OPNumeric)
    output_type = Real
    #: a single present side passes through (plus / minus)
    identity_on_missing = False

    def __init__(self, uid: str | None = None):
        super().__init__(self.op_name, uid=uid)

    def _op(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        (x, mx), (y, my) = _vals(cols[0]), _vals(cols[1])
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            both = self._op(np.where(mx, x, 0.0), np.where(my, y, 0.0))
        if self.identity_on_missing:
            out = np.where(
                mx & my, both,
                np.where(mx, self._left_only(x), self._right_only(y)),
            )
            mask = mx | my
        else:
            out = both
            mask = mx & my
        finite = np.isfinite(out)
        return NumericColumn(Real, np.where(finite, out, 0.0), mask & finite)

    def _left_only(self, x: np.ndarray) -> np.ndarray:
        return x

    def _right_only(self, y: np.ndarray) -> np.ndarray:
        return y


class AddTransformer(_BinaryMath):
    """MathTransformers.scala:50."""

    op_name = "plus"
    identity_on_missing = True

    def _op(self, x, y):
        return x + y


class SubtractTransformer(_BinaryMath):
    """MathTransformers.scala:90: empty - y = -y, x - empty = x."""

    op_name = "minus"
    identity_on_missing = True

    def _op(self, x, y):
        return x - y

    def _right_only(self, y):
        return -y


class MultiplyTransformer(_BinaryMath):
    """MathTransformers.scala:138: both sides required."""

    op_name = "multiply"

    def _op(self, x, y):
        return x * y


class DivideTransformer(_BinaryMath):
    """MathTransformers.scala:185: both sides required, x / 0 missing."""

    op_name = "divide"

    def _op(self, x, y):
        return x / y


class _UnaryMath(Transformer):
    """Single-feature math producing Real."""

    input_types = (OPNumeric,)
    output_type = Real

    def __init__(self, uid: str | None = None):
        super().__init__(self.op_name, uid=uid)

    def _op(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        x, mask = _vals(cols[0])
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            out = self._op(np.where(mask, x, 0.0))
        finite = np.isfinite(out)
        return NumericColumn(Real, np.where(finite, out, 0.0), mask & finite)


class ScalarAddTransformer(_UnaryMath):
    op_name = "scalarPlus"

    def __init__(self, scalar: float, uid: str | None = None):
        self.scalar = float(scalar)
        super().__init__(uid=uid)

    def get_params(self):
        return {"scalar": self.scalar}

    def _op(self, x):
        return x + self.scalar


class ScalarSubtractTransformer(ScalarAddTransformer):
    op_name = "scalarMinus"

    def _op(self, x):
        return x - self.scalar


class ScalarMultiplyTransformer(ScalarAddTransformer):
    op_name = "scalarMultiply"

    def _op(self, x):
        return x * self.scalar


class ScalarDivideTransformer(ScalarAddTransformer):
    op_name = "scalarDivide"

    def _op(self, x):
        return x / self.scalar


class AbsoluteValueTransformer(_UnaryMath):
    op_name = "absoluteValue"

    def _op(self, x):
        return np.abs(x)


class CeilTransformer(_UnaryMath):
    op_name = "ceil"

    def _op(self, x):
        return np.ceil(x)


class FloorTransformer(_UnaryMath):
    op_name = "floor"

    def _op(self, x):
        return np.floor(x)


class RoundTransformer(_UnaryMath):
    op_name = "round"

    def _op(self, x):
        # Scala math.round: half away from zero (numpy rounds half to even)
        return np.sign(x) * np.floor(np.abs(x) + 0.5)


class RoundDigitsTransformer(_UnaryMath):
    """MathTransformers.scala:381: round half away from zero to ``digits``
    decimal places."""

    op_name = "roundDigits"

    def __init__(self, digits: int, uid: str | None = None):
        self.digits = int(digits)
        super().__init__(uid=uid)

    def get_params(self):
        return {"digits": self.digits}

    def _op(self, x):
        scale = 10.0 ** self.digits
        return np.sign(x) * np.floor(np.abs(x) * scale + 0.5) / scale


class ExpTransformer(_UnaryMath):
    op_name = "exp"

    def _op(self, x):
        return np.exp(x)


class SqrtTransformer(_UnaryMath):
    op_name = "sqrt"

    def _op(self, x):
        return np.sqrt(x)


class LogTransformer(_UnaryMath):
    """MathTransformers.scala:335: log to ``base`` (e by default)."""

    op_name = "log"

    def __init__(self, base: float = np.e, uid: str | None = None):
        self.base = float(base)
        super().__init__(uid=uid)

    def get_params(self):
        return {"base": self.base}

    def _op(self, x):
        return np.log(x) / np.log(self.base)


class PowerTransformer(_UnaryMath):
    op_name = "power"

    def __init__(self, power: float, uid: str | None = None):
        self.power = float(power)
        super().__init__(uid=uid)

    def get_params(self):
        return {"power": self.power}

    def _op(self, x):
        return np.power(x, self.power)
