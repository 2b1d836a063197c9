"""Model interpretability (reference: ModelInsights, RecordInsightsLOCO),
the port of the JAX package's ``insights/``: the batched LOCO sweep
(:mod:`.loco`), correlation insights (:mod:`.correlation`), model insights
(:mod:`.model_insights`), attribution drift (:mod:`.drift`) and the
process-wide attribution ledger (:mod:`.ledger`, the ``attribution``
source of the exposition)."""
from . import ledger  # noqa: F401
from . import ledger as attribution_ledger  # noqa: F401
from .correlation import RecordInsightsCorr, RecordInsightsCorrModel  # noqa: F401
from .drift import (  # noqa: F401
    AttributionDriftMonitor,
    compute_attribution_profile,
)
from .loco import (  # noqa: F401
    RecordInsightsLOCO,
    column_groups,
    explain_batch,
    top_k_maps,
)
from .model_insights import feature_contributions, model_insights  # noqa: F401
