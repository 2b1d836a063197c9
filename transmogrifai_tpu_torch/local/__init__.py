"""Local (cluster-free) scoring."""
from .scoring import score_function  # noqa: F401
