"""Feature graph."""
from .feature import Feature, FeatureGeneratorStage  # noqa: F401
