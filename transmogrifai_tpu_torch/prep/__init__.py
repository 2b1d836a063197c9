"""Data preparation: the SanityChecker and its fitted removal model."""
from .sanity_checker import SanityChecker  # noqa: F401
