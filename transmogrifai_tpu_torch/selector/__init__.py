"""Model selection (reference: core/.../stages/impl/selector/): the
validators, the model selector with its three factories, and the selector
combiner."""
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
from .combiner import (  # noqa: F401
    CombinationStrategy,
    CombinedModel,
    SelectedModelCombiner,
)
