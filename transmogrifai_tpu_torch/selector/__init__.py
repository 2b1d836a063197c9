"""Model selection (reference: core/.../stages/impl/selector/): the
validators and the model selector with its three factories. The selector
combiner is not ported yet (``ROADMAP.md`` A9)."""
from .validators import CrossValidator, TrainValidationSplit  # noqa: F401
from .model_selector import (  # noqa: F401
    BINARY_CLASSIFICATION_MODELS,
    BinaryClassificationModelSelector,
    ModelSelector,
    MULTI_CLASSIFICATION_MODELS,
    MultiClassificationModelSelector,
    REGRESSION_MODELS,
    RegressionModelSelector,
    SelectedModel,
    make_candidates,
)
