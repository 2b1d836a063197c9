"""Insights plane of the port: only the attribution ledger
(:mod:`.ledger`), which the model registry's canary gate reads. LOCO
attributions, model insights, attribution drift and correlation are not
ported yet (``ROADMAP.md`` A10)."""
from . import ledger  # noqa: F401
