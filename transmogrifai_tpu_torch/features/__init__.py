"""Feature graph."""
from .feature import Feature, FeatureGeneratorStage  # noqa: F401
from .builder import FeatureBuilder, from_dataset  # noqa: F401
