"""Stage ABI: PipelineStage / Transformer / Model / Estimator.

Stages declare typed input features and produce one output feature.
``Transformer.transform_columns(*cols, num_rows)`` is columnar: it maps
whole columns, not rows; per-row scoring runs it over a batch of one.
``Transformer.transform(dataset)`` appends the output column to a
dataset; ``Estimator.fit(dataset)`` learns a ``Model`` from one.
"""
from __future__ import annotations

from typing import Any

from ..types import FeatureType
from ..types.columns import Column
from ..utils import uid as uid_util


class PipelineStage:
    """Base of every stage."""

    output_type: type = FeatureType

    def __init__(self, operation_name: str, uid: str | None = None):
        self.operation_name = operation_name
        self.uid = uid or uid_util.make_uid(type(self))
        self.input_features: tuple[Any, ...] = ()  # tuple[Feature, ...]
        #: fitted-stage summary ledger, carried over from the saved manifest
        self.metadata: dict[str, Any] = {}

    def set_input(self, *features: Any) -> "PipelineStage":
        """Wire the input features (checked against ``input_types`` where a
        stage declares them). A wired stage is not rewired."""
        if self.input_features and tuple(features) != self.input_features:
            raise ValueError(
                f"{self} is already wired to {self.input_names}; create a new "
                "stage instead of rewiring"
            )
        types = getattr(self, "input_types", None)
        if types is not None:
            if len(features) != len(types):
                raise ValueError(
                    f"{self}: expected {len(types)} inputs, got {len(features)}"
                )
            for f, want in zip(features, types):
                if not issubclass(f.ftype, want):
                    raise TypeError(
                        f"{self}: input '{f.name}' has type "
                        f"{f.ftype.__name__}, expected {want.__name__}"
                    )
        self.input_features = tuple(features)
        return self

    @property
    def input_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.input_features)

    @property
    def output_name(self) -> str:
        """The output column name: the fixed name the loader sets, else
        the reference's derived ``<inputs>_<operation>_<uid suffix>``."""
        fixed = getattr(self, "_fixed_output_name", None)
        if fixed is not None:
            return fixed
        _, suffix = uid_util.from_string(self.uid)
        base = "-".join(self.input_names) if self.input_features else "out"
        return f"{base[:80]}_{self.operation_name}_{suffix}"

    def get_output(self) -> Any:
        """The output Feature, with this stage as origin."""
        from ..features.feature import Feature

        if not self.input_features:
            raise ValueError(f"{self}: inputs must be wired before get_output")
        self._fixed_output_name = self.output_name
        return Feature(
            name=self._fixed_output_name,
            ftype=self.output_type,
            origin_stage=self,
            parents=tuple(self.input_features),
            is_response=any(f.is_response for f in self.input_features),
        )

    def get_params(self) -> dict[str, Any]:
        """JSON-able constructor params for saving: the inverse of the
        class's ``from_params`` or constructor. A stage without params
        returns ``{}``."""
        return {}

    def set_params(self, **params: Any) -> "PipelineStage":
        """Apply overrides by attribute name (OpWorkflow.setStageParameters)."""
        for k, v in params.items():
            if not hasattr(self, k):
                raise AttributeError(f"{self} has no param '{k}'")
            setattr(self, k, v)
        return self

    def to(self, device) -> "PipelineStage":
        """Place the stage's fitted arrays on ``device`` for the predict
        path; host-only stages keep this no-op."""
        return self

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.uid})"


class Transformer(PipelineStage):
    """A pure columnar function of its input features."""

    def transform_columns(self, *cols: Column, num_rows: int) -> Column:
        raise NotImplementedError

    def transform(self, dataset) -> Any:
        """Append this stage's output column to ``dataset``."""
        cols = [dataset[name] for name in self.input_names]
        out = self.transform_columns(*cols, num_rows=dataset.num_rows)
        return dataset.with_column(self.output_name, out)


class Model(Transformer):
    """A fitted transformer."""

    def get_arrays(self) -> dict[str, Any]:
        """The fitted arrays a save writes (keyed by name); ``{}`` where the
        params hold everything."""
        return {}


class Estimator(PipelineStage):
    """Learns a Model from data."""

    def fit(self, dataset) -> Model:
        model = self.fit_model(dataset)
        model.input_features = self.input_features
        model.operation_name = self.operation_name
        # the model's output replaces the estimator's declared output name
        model._fixed_output_name = self.output_name
        model.metadata = dict(self.metadata)
        return model

    def fit_model(self, dataset) -> Model:
        raise NotImplementedError
