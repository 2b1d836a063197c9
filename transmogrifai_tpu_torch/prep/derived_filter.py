"""FeatureRemovalModel — the SanityChecker's fitted form: an index-keep mask
applied to the feature vector, with metadata subset to match."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..stages.base import Model
from ..stages.metadata import VectorMetadata
from ..types import OPVector
from ..types.columns import Column, VectorColumn


class FeatureRemovalModel(Model):
    output_type = OPVector

    def __init__(
        self,
        indices_to_keep: Sequence[int],
        remove_bad_features: bool,
        new_metadata: VectorMetadata | None,
        operation_name: str = "featureRemoval",
        uid: str | None = None,
    ):
        super().__init__(operation_name, uid=uid)
        self.indices_to_keep = np.asarray(indices_to_keep, dtype=np.intp)
        self.remove_bad_features = remove_bad_features
        self.new_metadata = new_metadata

    def get_params(self):
        return {
            "indices_to_keep": [int(i) for i in self.indices_to_keep],
            "remove_bad_features": self.remove_bad_features,
            "new_metadata": (
                self.new_metadata.to_json() if self.new_metadata else None
            ),
        }

    def get_arrays(self):
        return {"indices_to_keep": np.asarray(self.indices_to_keep, dtype=np.int64)}

    @classmethod
    def from_params(cls, params, arrays):
        meta_json = params.get("new_metadata")
        return cls(
            indices_to_keep=arrays["indices_to_keep"],
            remove_bad_features=params["remove_bad_features"],
            new_metadata=(
                VectorMetadata.from_json(meta_json) if meta_json else None
            ),
        )

    def fused_gather_indices(self) -> np.ndarray | None:
        """The keep-index gather of the fused graph, or None where this
        model passes the vector through."""
        if not self.remove_bad_features:
            return None
        return np.asarray(self.indices_to_keep, dtype=np.int32)

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        # inputs are (label, vector); the vector is always the last input
        vec = cols[-1]
        if not isinstance(vec, VectorColumn):
            raise TypeError(f"expected a vector column, got {type(vec).__name__}")
        if not self.remove_bad_features:
            return vec
        meta = self.new_metadata
        if meta is None and vec.metadata is not None:
            meta = self.new_metadata = vec.metadata.select(self.indices_to_keep)
        # np.asarray densifies a sparse plane, as the reference does
        values = np.asarray(vec.values)[:, self.indices_to_keep]
        return VectorColumn(OPVector, values, meta)
