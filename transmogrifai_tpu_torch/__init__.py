"""transmogrifai_tpu_torch — the PyTorch / CUDA port of transmogrifai_tpu.

It serves models that ``transmogrifai_tpu`` trained and saved: load one
with ``workflow.persistence.load_workflow_model`` and score rows with
``local.scoring.score_function``. The tree traversal runs in a
hand-written CUDA kernel for Hopper (``csrc/serve_trees.cu``). Entry points
run on the card unless the caller passes ``device="cpu"``, which runs the
plain PyTorch versions. Training is not ported yet.
"""
from . import types  # noqa: F401
from .dataset import Dataset  # noqa: F401
from .local.scoring import score_function  # noqa: F401
from .workflow.persistence import load_workflow_model  # noqa: F401

__version__ = "0.1.0"
