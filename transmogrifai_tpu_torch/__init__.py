"""transmogrifai_tpu_torch — the PyTorch / CUDA port of transmogrifai_tpu.

It serves models that ``transmogrifai_tpu`` trained and saved: load one
with ``workflow.persistence.load_workflow_model`` and score rows with
``local.scoring.score_function``. It trains the binary XGBoost and
random-forest classifiers, the GBT, XGBoost and random-forest regressors
(``models/gbdt.py``), and binary logistic and linear regression
(``models/logistic.py``, ``models/linear.py``), through each estimator's
``fit_arrays``, ``fit_model`` and ``fit_arrays_batched_masks``. The tree
kernels run as hand-written CUDA for Hopper (``csrc/*.cu``); the GLM
solvers are PyTorch tensor code. The feature side of the flagship flow
runs too: ``readers.infer_csv_dataset``, ``features.from_dataset``,
``ops.transmogrify`` (the reference's vectorizer for every type of its
default dispatch: numeric, categorical, smart text, dates, sets, phones,
lists, geolocations and maps; ``testkit`` draws typed tables of them),
``label.sanity_check(vec)`` (``prep.SanityChecker``, its statistics on the
card) and ``workflow.fit.fit_and_transform_dag``, on the featurize plane
(``featurize/``: interning, fused block assembly, the chunked pool,
``featurizeStats``; the host kernels of ``native/tptpu_native.cpp``, built
with ``g++`` by ``native.py``). Entry points run on the
card unless the caller passes ``device="cpu"``, which runs the plain
PyTorch versions. The whole five-line flow runs:
``selector.BinaryClassificationModelSelector`` (and the regression and
multiclass factories) over ``selector.validators`` and ``evaluators``,
``workflow.workflow.Workflow().train()`` (with ``with_workflow_cv()``,
``workflow/cv.py``), ``model.score``, ``model.evaluate``,
``model.summary_pretty()`` and ``model.save``, in the JAX package's saved
format. ``score_function`` serves batches above the host-predict cutoff
through the fused scoring graph (``compiler/fused.py``: one upload, the
plan on the card, one download). The DSL's text vocabulary builds text
pipelines (``ops/text_stages.py``, ``nlp/``, ``utils/analyzers.py``), with
word2vec and LDA fitted on the card (``ops/embeddings.py``) and
sensitive-feature detection in ``train()``. The other planes are not
ported yet (``ROADMAP.md`` A).
"""
from . import dsl  # noqa: F401  (installs Feature.sanity_check)
from . import types  # noqa: F401
from .dataset import Dataset  # noqa: F401
from .local.scoring import score_function  # noqa: F401
from .workflow.persistence import load_workflow_model  # noqa: F401
from .workflow.workflow import Workflow  # noqa: F401

__version__ = "0.1.0"
