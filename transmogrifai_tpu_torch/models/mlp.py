"""Multilayer perceptron classifier, the port of the JAX package's
``models/mlp.py``.

Reference: core/.../stages/impl/classification/
OpMultilayerPerceptronClassifier.scala (Spark MLP: sigmoid hidden layers,
a softmax output, full-batch optimization). The fit is the reference's
full-batch Adam loop on the device: the parameters start where
``_init_params`` puts them (``utils.prng``: ``key, sub = split(key)`` per
layer, ``normal(sub) * sqrt(2 / fan_in)``, equal to the reference's bit
for bit), the loss is the mask-weighted mean softmax cross-entropy, the
gradients come from ``torch.autograd``, and optax's Adam update (b1 0.9,
b2 0.999, eps 1e-8, bias-corrected ``mu_hat / (sqrt(nu_hat) + eps)``) is
written out. ``compute_dtype="bfloat16"`` rounds each layer's operands to
bfloat16 and accumulates in float32 (params and optimizer state stay
float32). Under an execution mesh the fit is data parallel: rows pad to
the data-axis multiple with mask 0, each rank takes its block, and the
loss and every gradient are all-reduced over the data axis in rank order,
so every rank takes the same Adam steps.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..parallel.mesh import execution_mesh
from ..utils import prng
from ..utils.device import resolve_device
from .base import PredictorEstimator, PredictorModel, num_classes
from .solvers import _check_precision, _row_sum, to_device

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _init_params(seed: int, sizes: Sequence[int]) -> list[dict]:
    """The reference's ``_init_params(PRNGKey(seed), sizes)`` as its jitted
    fit computes it, float32 numpy: He-scaled normal weights, zero
    biases."""
    key = prng.prng_key(seed)
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        key, sub = prng.split(key)
        scale = np.sqrt(np.float32(2.0 / fan_in), dtype=np.float32)
        w = prng.normal(sub, (fan_in, fan_out), scale=scale)
        params.append({"w": w, "b": np.zeros(fan_out, dtype=np.float32)})
    return params


def _matmul(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            compute_dtype) -> torch.Tensor:
    """One layer's product. With a low-precision compute dtype the operands
    are rounded to it and the products accumulate in float32 (a bfloat16
    product is exact in float32)."""
    if compute_dtype is None:
        return h @ w + b
    return h.to(compute_dtype).float() @ w.to(compute_dtype).float() + b


def _forward(params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    h = x
    for layer in params[:-1]:
        # Spark MLP's hidden activations are sigmoids
        h = torch.sigmoid(_matmul(h, layer["w"], layer["b"], compute_dtype))
    last = params[-1]
    return _matmul(h, last["w"], last["b"], compute_dtype)


def train_mlp(x, y1h, row_mask, sizes, num_iters: int, step_size: float,
              seed: int, compute_dtype=None, device=None, mesh=None):
    """The reference's ``_train_mlp``: (final float32 parameters as numpy
    layers, the per-step losses [num_iters] as numpy). With ``mesh`` the
    rows are this rank's block: the count, the loss and the gradients are
    all-reduced over its data axis."""
    red = _row_sum(mesh)
    dev = resolve_device(device)
    _check_precision(dev)
    cd = None if compute_dtype is None else getattr(torch, str(compute_dtype))
    x = to_device(x, dev)
    y1h = to_device(y1h, dev)
    row_mask = to_device(row_mask, dev)
    n = torch.clamp_min(red("mlp_count", row_mask.sum()), 1.0)
    params = [{k: torch.from_numpy(v).to(dev).requires_grad_(True)
               for k, v in layer.items()}
              for layer in _init_params(seed, sizes)]
    flat = [layer[k] for layer in params for k in ("w", "b")]
    mu = [torch.zeros_like(p) for p in flat]
    nu = [torch.zeros_like(p) for p in flat]
    lr = float(np.float32(step_size))
    losses = []
    for step in range(1, num_iters + 1):
        logits = _forward(params, x, cd)
        ll = -(y1h * torch.log_softmax(logits, dim=-1)).sum(-1) * row_mask
        loss = ll.sum() / n
        grads = [red("mlp_grad", gr)
                 for gr in torch.autograd.grad(loss, flat)]
        losses.append(red("mlp_loss", loss.detach()))
        # optax's bias corrections, 1 - decay**count, in float32
        c1 = float(np.float32(1) - np.float32(_B1) ** np.float32(step))
        c2 = float(np.float32(1) - np.float32(_B2) ** np.float32(step))
        with torch.no_grad():
            for p, g, m, v in zip(flat, grads, mu, nu):
                m.mul_(_B1).add_((1 - _B1) * g)
                v.mul_(_B2).add_((1 - _B2) * g * g)
                p.add_(-lr * ((m / c1) / (torch.sqrt(v / c2) + _EPS)))
    out = [{k: t.detach().cpu().numpy() for k, t in layer.items()}
           for layer in params]
    return out, torch.stack(losses).cpu().numpy() if losses else np.zeros(0)


class MLPClassifierModel(PredictorModel):
    def __init__(self, params, num_classes: int, uid=None):
        super().__init__("mlp", uid=uid)
        self.params = [{"w": np.asarray(layer["w"], dtype=np.float32),
                        "b": np.asarray(layer["b"], dtype=np.float32)}
                       for layer in params]
        self.num_classes = num_classes
        self.device: torch.device | None = None
        #: where a fitted model places itself at its first predict
        self.default_device: torch.device | None = None
        self._dev_params: list | None = None

    def get_arrays(self):
        out = {}
        for i, layer in enumerate(self.params):
            out[f"w{i}"] = layer["w"]
            out[f"b{i}"] = layer["b"]
        return out

    def get_params(self):
        return {"num_classes": self.num_classes,
                "layer_sizes": [int(layer["w"].shape[0]) for layer in self.params]
                + [int(self.params[-1]["w"].shape[1])]}

    @classmethod
    def from_params(cls, params, arrays):
        layers = []
        i = 0
        while f"w{i}" in arrays:
            layers.append({"w": arrays[f"w{i}"], "b": arrays[f"b{i}"]})
            i += 1
        return cls(layers, params["num_classes"])

    def to(self, device) -> "MLPClassifierModel":
        device = torch.device(device)
        if self.device != device:
            self._dev_params = [
                {k: torch.from_numpy(v).to(device) for k, v in layer.items()}
                for layer in self.params]
            self.device = device
        return self

    def predict_arrays(self, x: np.ndarray):
        """The float32 forward pass on the model's device, then the
        reference's float64 softmax on the host."""
        if self.device is None:
            self.to(self.default_device if self.default_device is not None
                    else resolve_device(None))
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)
                              ).to(self.device)
        with torch.no_grad():
            logits = _forward(self._dev_params, xt).cpu().numpy()
        logits64 = logits.astype(np.float64)
        shifted = logits64 - logits64.max(axis=1, keepdims=True)
        e = np.exp(shifted)
        prob = e / e.sum(axis=1, keepdims=True)
        return prob.argmax(axis=1).astype(np.float64), prob, logits64


class MLPClassifier(PredictorEstimator):
    """Spark MLP defaults: maxIter=100 (Adam at 1e-2 here), hidden layers
    user-specified."""

    model_type = "OpMultilayerPerceptronClassifier"

    def __init__(
        self,
        hidden_layers: Sequence[int] = (10,),
        max_iter: int = 100,
        step_size: float = 0.01,
        seed: int = 42,
        compute_dtype: str | None = None,
        device=None,
        uid: str | None = None,
    ):
        super().__init__("mlp", uid=uid)
        self.hidden_layers = tuple(hidden_layers)
        self.max_iter = max_iter
        self.step_size = step_size
        self.seed = seed
        #: e.g. "bfloat16": operands rounded to bf16, float32 accumulation
        self.compute_dtype = compute_dtype
        #: ``None`` fits on the card; ``"cpu"`` runs on the CPU
        self.device = device

    def get_params(self):
        return {
            "hidden_layers": list(self.hidden_layers),
            "max_iter": self.max_iter,
            "step_size": self.step_size,
            "seed": self.seed,
            "compute_dtype": self.compute_dtype,
        }

    def fit_arrays(self, x, y, row_mask):
        row_mask = np.asarray(row_mask, dtype=np.float32)
        n_classes = num_classes(y, row_mask)
        sizes = (int(np.shape(x)[1]), *self.hidden_layers, n_classes)
        y1h = np.eye(n_classes, dtype=np.float32)[np.asarray(y).astype(np.int64)]
        dev = resolve_device(self.device)
        x = np.asarray(x, dtype=np.float32)
        mesh = execution_mesh()
        if mesh is not None:
            # the data-parallel fit: this rank's block of the rows,
            # padded past the end with mask-0 rows
            x, y1h, row_mask = (mesh.local_rows(a)
                                for a in (x, y1h, row_mask))
        params, losses = train_mlp(
            x, y1h, row_mask, sizes,
            int(self.max_iter), float(self.step_size), int(self.seed),
            compute_dtype=self.compute_dtype, device=dev, mesh=mesh,
        )
        self.metadata["finalLoss"] = float(losses[-1])
        model = MLPClassifierModel(params, n_classes)
        model.default_device = dev
        return model
