"""Training solvers for the logistic (binary and multinomial) and linear
GLMs, in PyTorch on an explicit device: the port of the JAX package's
``models/solvers.py``.

Losses follow Spark semantics: mean log-loss / squared error over the
unmasked rows + lambda * (alpha*||w||_1 + (1-alpha)/2*||w||_2^2), the
intercept unregularized, features standardized internally (per lane, and
implicitly: the shared matrix is never copied per lane) with the
coefficients mapped back to the original scale.

The reference runs each solver as one scanned XLA program: a fixed
iteration count, ``jnp.where`` in place of every branch, converged lanes
frozen in place. The port keeps that shape: each optimizer is a Python
``for`` over the iteration count whose body issues device work only, with
no ``.item()``, ``bool(tensor)`` or host ``if`` on a tensor value, so a fit
runs without a host sync until its caller downloads the result. The K
fits of a sweep (folds x grid points) advance together as the rows of one
[K, P] parameter matrix, every product a GEMM over the shared x.

The products run in float32 (``torch.matmul``: cuBLAS on the card, the CPU
BLAS here), whose blocking differs from XLA's, so fits agree with the
reference within stated tolerances, not bit for bit
(``tests/test_torch_solvers.py``). On the card they must run in full
float32: ``_check_precision`` refuses a fit while TF32 matmuls are on.

Data parallel (``mesh=``, ``parallel/fit.py``): every rank passes its
block of the rows, and every sum over rows inside the solver (counts,
moments, the masked min / max, the loss and the gradient) is all-reduced
over the mesh's data axis in rank order (``Mesh.all_reduce``, taped as
``glm_count``, ``glm_moments``, ``glm_loss``, ``glm_grad``, ...), so every
rank holds the same bits and takes the same steps. A mesh of one rank is the
identity: the fit equals the one without a mesh.

``fit_linear_svc`` runs FISTA on the Huberized hinge; ``fit_glm_irls``
runs iteratively reweighted least squares, one ``torch.linalg.solve`` of
the [D+1, D+1] normal equations per iteration, the reference's
``lax.switch`` over the family and link codes becoming Python branches on
the static code.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .trees import _xla_sigmoid


class GLMParams(NamedTuple):
    weights: torch.Tensor    # [D] or [K, D]
    intercept: torch.Tensor  # scalar or [K]


def _check_precision(dev: torch.device) -> None:
    """Every float32 GEMM of a fit must run in full float32 on the card: a
    TF32 setting made anywhere in the process would round the products'
    inputs to 10 mantissa bits."""
    if dev.type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "GLM fits need full-float32 matmuls on the card: "
            "torch.backends.cuda.matmul.allow_tf32 is "
            f"{torch.backends.cuda.matmul.allow_tf32} and the float32 matmul "
            f"precision is '{torch.get_float32_matmul_precision()}' (need "
            "False and 'highest')"
        )


def to_device(a, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A numpy array (or tensor) as a tensor of ``dtype`` on ``dev``. The
    host-to-card copy is issued without blocking (the card's copy engine
    takes it from a staging buffer), so an upload is not a host sync."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dtype)
    return t.to(dev, non_blocking=True)


def packed_lanes(params: GLMParams) -> torch.Tensor:
    """A fit's lanes as one [K, D + 1] tensor on its device: the weights,
    then the intercept (one lane for a single fit)."""
    d = params.weights.shape[-1]
    return torch.cat([params.weights.reshape(-1, d),
                      params.intercept.reshape(-1, 1)], dim=1)


def download_lanes(lanes: list[torch.Tensor]) -> np.ndarray:
    """Packed lanes (``packed_lanes``) of one or more fits, [sum K, D + 1]
    float32, in one device-to-host copy: the sweep's one host sync."""
    return torch.cat(lanes).cpu().numpy()


def _f32(v) -> float:
    """A Python float holding the float32 rounding of ``v``."""
    return float(np.float32(v))


def _effectively_constant(std: torch.Tensor, scale: torch.Tensor,
                          rel_tol: float = 1e-5) -> torch.Tensor:
    """Columns whose std is ~float noise relative to their magnitude
    (a column stuck at c within the mask computes var ~ (c eps)^2 > 0)."""
    return std <= torch.clamp_min(rel_tol * scale, 1e-12)


def _masked_minmax(x: torch.Tensor, rm: torch.Tensor, mesh=None):
    """Per-(lane, column) masked min/max: ``([K, D] min, [K, D] max)`` for
    x [N, D] under masks rm [K, N].

    Memory: the broadcast form would make a [K, N, D] temporary (1.9 GB at
    32 lanes x 16384 x 928); this loops over the lanes as the reference's
    ``lax.map`` does, so the peak extra memory is one [N, D] buffer. min
    and max are exact under any order, so the result equals the
    reference's bit for bit, and the constant-column gate built on it
    agrees exactly."""
    big = torch.finfo(x.dtype).max
    mins, maxs = [], []
    for k in range(rm.shape[0]):
        mb = rm[k][:, None] > 0
        mins.append(torch.where(mb, x, big).amin(dim=0))
        maxs.append(torch.where(mb, x, -big).amax(dim=0))
    if not mins:
        empty = x.new_empty((0, x.shape[1]))
        return empty, empty
    if mesh is not None:
        # one exact all-reduce: the minimum of [min | -max]
        d = x.shape[1]
        both = mesh.all_reduce("glm_range", torch.cat(
            [torch.stack(mins), -torch.stack(maxs)], dim=1), op="min")
        return both[:, :d], -both[:, d:]
    return torch.stack(mins), torch.stack(maxs)


def _row_sum(mesh) -> Callable:
    """``red(name, t)``, the sum over rows across ranks: ``t`` itself
    without a mesh, else the all-reduce of each rank's partial over the
    data axis, taped under ``name``."""
    if mesh is None:
        return lambda name, t: t
    return mesh.all_reduce


def _col_mean(x: torch.Tensor, mesh, num_rows) -> torch.Tensor:
    """Column means over the global rows: ``x.mean`` on one rank (so a
    mesh of one equals no mesh), else the all-reduced sums over
    ``num_rows``, the global count of real rows (padding rows are
    zero)."""
    if mesh is None or mesh.shape["data"] == 1:
        return x.mean(dim=0)
    return mesh.all_reduce("glm_shift", x.sum(dim=0)) / float(num_rows)


def _standardize(x: torch.Tensor, row_mask: torch.Tensor, red=None):
    red = red or _row_sum(None)
    n = torch.clamp_min(red("glm_count", row_mask.sum()), 1.0)
    mean = red("glm_moments", (x * row_mask[:, None]).sum(0)) / n
    var = red("glm_moments", ((x - mean) ** 2 * row_mask[:, None]).sum(0)) / n
    std = torch.sqrt(var)
    const = _effectively_constant(std, torch.sqrt(var + mean**2))
    safe = torch.where(const, 1.0, std)
    xs = torch.where(row_mask[:, None] != 0, (x - mean) / safe, 0.0)
    # zero the constant columns entirely: (x - mean) there is pure noise
    xs = torch.where(const[None, :], 0.0, xs)
    return xs, mean, safe, const


def _scale_only(x: torch.Tensor, row_mask: torch.Tensor, std, const):
    """Scale without centering, for fit_intercept=False (Spark parity:
    centering would bake an implicit mean*w offset into training that
    predict never applies); constant columns stay zeroed."""
    xs = torch.where(row_mask[:, None] > 0, x / std, 0.0)
    return torch.where(const[None, :], 0.0, xs)


def _soft_threshold(w: torch.Tensor, t) -> torch.Tensor:
    # torch.sign(0) == 0, as jnp.sign(0)
    return torch.sign(w) * torch.clamp_min(torch.abs(w) - t, 0.0)


def _fista(grad_fn, prox_fn, w0, step, num_iters: int):
    """Accelerated proximal gradient, fixed iterations. The momentum
    sequence t_k does not depend on the data, so it is taken on the host in
    float32 (the reference's scalar carry) and enters as a scalar."""
    w_prev, z = w0, w0
    t = np.float32(1.0)
    for _ in range(num_iters):
        g = grad_fn(z)
        w_next = prox_fn(z - step * g, step)
        t_next = np.float32(0.5) * (
            np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        z = w_next + float((t - np.float32(1.0)) / t_next) * (w_next - w_prev)
        w_prev, t = w_next, np.float32(t_next)
    return w_prev


def fit_linear_batched(
    x, y, row_masks, reg_params, elastic_nets, num_iters: int = 200,
    fit_intercept: bool = True, device=None, mesh=None, num_rows=None,
) -> GLMParams:
    """K elastic-net linear regressions sharing one feature matrix x [N, D]
    (y [N], row_masks [K, N], reg_params and elastic_nets [K]), as lanes of
    one FISTA: per iteration one [N, K] forward GEMM and one [K, D]
    gradient GEMM on the shared x, with each lane's standardization applied
    implicitly (x globally shifted so the one-pass lane moments do not
    cancel in float32). Returns weights [K, D], intercept [K] on the
    device. With ``mesh`` the rows are this rank's block and
    ``num_rows`` the global count of real rows."""
    dev = resolve_device(device)
    _check_precision(dev)
    red = _row_sum(mesh)
    x = to_device(x, dev)
    y = to_device(y, dev)
    rm = to_device(row_masks, dev)
    reg_params = to_device(reg_params, dev)
    elastic_nets = to_device(elastic_nets, dev)
    n = torch.clamp_min(red("glm_count", rm.sum(dim=1)), 1.0)  # [K]
    gshift = _col_mean(x, mesh, num_rows)
    xc = x - gshift[None, :]
    s1 = red("glm_moments", rm @ xc)                        # [K, D]
    s2 = red("glm_moments", rm @ (xc * xc))
    mean_shift = s1 / n[:, None]
    var = torch.clamp_min(s2 / n[:, None] - mean_shift**2, 0.0)
    std = torch.sqrt(var)
    mean_true = mean_shift + gshift[None, :]
    # fold-constant detection must be exact (masked min/max): an
    # all-zero-in-mask column has mean_true ~ 0, where the std-relative
    # test degenerates
    xmin, xmax = _masked_minmax(x, rm, mesh)                # [K, D] each
    const = (xmax <= xmin) | _effectively_constant(
        std, torch.sqrt(var + mean_true**2))
    safe = torch.where(const, 1.0, std)
    if not fit_intercept:
        # Spark parity: scale only, never center x or y
        mean_shift = torch.zeros_like(mean_shift)
        xc = x
        ym = torch.zeros_like(n)
    else:
        ym = red("glm_target_mean", rm @ y) / n             # [K]
    yc = torch.where(rm > 0, y[None, :] - ym[:, None], 0.0)  # [K, N]
    l1 = (reg_params * elastic_nets)[:, None]
    l2 = (reg_params * (1.0 - elastic_nets))[:, None]

    def grad(w_std):
        # w_std [K, D] in standardized space; const columns pinned at 0
        v = torch.where(const, 0.0, w_std / safe)           # [K, D]
        logits = xc @ v.T - (mean_shift * v).sum(dim=1)[None, :]  # [N, K]
        r = (logits.T - yc) * rm                            # [K, N]
        g_raw = (red("glm_grad", r @ xc)
                 - mean_shift * red("glm_grad_sum", r.sum(dim=1))[:, None])
        g = torch.where(const, 0.0, g_raw / safe) / n[:, None]
        return g + l2 * w_std

    def prox(w, step):
        return _soft_threshold(w, step * l1)

    # per-lane standardized column second moments: 1 for centered columns,
    # (var + mean^2)/std^2 for the scale-only no-intercept path
    if fit_intercept:
        col2 = torch.where(const, 0.0, 1.0)
    else:
        col2 = torch.where(const, 0.0, (var + mean_true**2) / (safe * safe))
    lip = col2.sum(dim=1)[:, None] + l2                     # [K, 1]
    step = 1.0 / torch.clamp_min(lip, 1e-6)
    w0 = torch.zeros((rm.shape[0], x.shape[1]), dtype=x.dtype, device=dev)
    w_std = _fista(grad, prox, w0, step, num_iters)
    w = torch.where(const, 0.0, w_std / safe)
    b = ym - (w_std * torch.where(const, 0.0, mean_true / safe)).sum(dim=1)
    if not fit_intercept:
        b = torch.zeros_like(b)
    return GLMParams(weights=w, intercept=b)


def fit_linear(
    x, y, row_mask, reg_param, elastic_net, num_iters: int = 200,
    fit_intercept: bool = True, device=None, mesh=None, num_rows=None,
) -> GLMParams:
    """Linear regression with elastic net, one fit (Spark WLS semantics
    for alpha=0 through converged FISTA). Weights [D], intercept scalar on
    the device. With ``mesh`` the rows are this rank's block."""
    dev = resolve_device(device)
    _check_precision(dev)
    red = _row_sum(mesh)
    x = to_device(x, dev)
    y = to_device(y, dev)
    row_mask = to_device(row_mask, dev)
    n = torch.clamp_min(red("glm_count", row_mask.sum()), 1.0)
    xs, mean, std, const = _standardize(x, row_mask, red)
    if not fit_intercept:
        # Spark parity: scale only, never center x or y
        mean = torch.zeros(x.shape[1], dtype=x.dtype, device=dev)
        xs = _scale_only(x, row_mask, std, const)
        ym = torch.zeros((), dtype=x.dtype, device=dev)
    else:
        ym = red("glm_target_mean", (y * row_mask).sum()) / n
    yc = torch.where(row_mask > 0, y - ym, 0.0)
    l1 = _f32(np.float32(reg_param) * np.float32(elastic_net))
    l2 = _f32(np.float32(reg_param) * (np.float32(1.0) - np.float32(elastic_net)))

    def grad(w):
        r = (xs @ w - yc) * row_mask
        return red("glm_grad", xs.T @ r) / n + l2 * w

    def prox(w, step):
        return _soft_threshold(w, step * l1)

    col = red("glm_lipschitz", (xs * xs).sum(0)) / n
    lip = col.sum() + l2
    step = 1.0 / torch.clamp_min(lip, 1e-6)
    w0 = torch.zeros(x.shape[1], dtype=x.dtype, device=dev)
    w_std = _fista(grad, prox, w0, step, num_iters)
    w = w_std / std
    b = ym - (w_std * mean / std).sum()
    return GLMParams(weights=w, intercept=b if fit_intercept
                     else torch.zeros_like(b))


# --------------------------------------------------------------------------
# Batched L-BFGS / OWL-QN (Spark LogisticRegression's optimizer). K fits
# advance in lockstep as rows of one [K, P] parameter matrix; the line
# search evaluates every step candidate with one GEMM ([T*K] lanes); a
# fixed iteration count, converged lanes frozen in place. OWL-QN (Andrew &
# Gao 2007) handles per-lane L1 through the pseudo-gradient and the orthant
# projection; lanes with l1=0 are plain L-BFGS.
# --------------------------------------------------------------------------

_LBFGS_M = 8           # history pairs
_LS_STEPS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003)  # Armijo candidates
_LS_C1 = 1e-4


def _lbfgs_owlqn(
    value_grad: Callable,        # W [K, P] -> (F [K], g_smooth [K, P])
    candidates_value: Callable,  # Wc [T, K, P] -> F [T, K]
    p0: torch.Tensor,            # [K, P] initial params
    l1_mat: torch.Tensor,        # [K, P] per-component l1 (0 on intercepts)
    gamma0: torch.Tensor,        # [K] initial inverse-Hessian scale
    num_iters: int,
    gtol: float = 1e-7,
) -> torch.Tensor:
    """Returns argmin params [K, P]. The loop body is branchless: every
    decision is a ``torch.where`` on the device, so the loop issues work
    and never waits for it."""
    k_fits, p_dim = p0.shape
    m = _LBFGS_M
    dev, dt = p0.device, p0.dtype
    n_steps = len(_LS_STEPS)
    ts = to_device(np.asarray(_LS_STEPS, dtype=np.float32), dev, dt)
    step_ids = torch.arange(n_steps, device=dev)
    l1_on = l1_mat > 0

    def pseudo_grad(w, g):
        # d(f + l1|w|): the sign(w)-side derivative away from 0; at 0 the
        # steepest one-sided descent direction, 0 inside the [-l1, l1] band
        gp = g + l1_mat
        gm = g - l1_mat
        at0 = torch.where(gm > 0, gm, torch.where(gp < 0, gp, 0.0))
        return torch.where(w > 0, gp, torch.where(w < 0, gm, at0))

    def two_loop(pg, S, Y, rho, gamma):
        q = pg
        alphas = []
        for i in range(m - 1, -1, -1):
            a = rho[i] * (S[i] * q).sum(-1)          # [K]
            q = q - a[:, None] * Y[i]
            alphas.append(a)
        r = gamma[:, None] * q
        for i in range(m):
            a = alphas[m - 1 - i]
            b = rho[i] * (Y[i] * r).sum(-1)
            r = r + S[i] * (a - b)[:, None]
        return -r

    gamma00 = gamma0.to(dt)
    w, (f_cur, g) = p0, value_grad(p0)
    S = torch.zeros((m, k_fits, p_dim), dtype=dt, device=dev)
    Y = torch.zeros((m, k_fits, p_dim), dtype=dt, device=dev)
    rho = torch.zeros((m, k_fits), dtype=dt, device=dev)
    gamma = gamma00
    for _ in range(num_iters):
        pg = pseudo_grad(w, g)
        d = two_loop(pg, S, Y, rho, gamma)
        # OWL-QN: keep d a descent direction of the pseudo-gradient on
        # l1-active components (l1=0 lanes pass through untouched)
        d = torch.where(l1_on & (d * pg >= 0), 0.0, d)
        # the orthant: sign(w), or sign(-pg) where w is 0 (sign(0) == 0 on
        # both sides, so a component with w == 0 and pg == 0 projects any
        # nonzero candidate to 0, as the reference does)
        xi = torch.where(w != 0, torch.sign(w), torch.sign(-pg))
        cand = w[None] + ts[:, None, None] * d[None]          # [T, K, P]
        cand = torch.where(l1_on & (cand * xi < 0), 0.0, cand)
        f_cand = candidates_value(cand)                       # [T, K]
        pgd = ((cand - w[None]) * pg[None]).sum(-1)           # [T, K]
        accept = f_cand <= f_cur[None] + _LS_C1 * pgd
        # jnp.argmax over booleans takes the first True (the largest
        # accepted step); torch.argmax is not defined on bool, so it runs
        # on int32, where it too returns the first maximal index
        first_ok = accept.to(torch.int32).argmax(dim=0)
        fallback = f_cand.argmin(dim=0)
        idx = torch.where(accept.any(dim=0), first_ok, fallback)
        # the one-hot selection as the reference writes it: a NaN or inf
        # candidate in an unselected step turns the sum into NaN (0 * inf),
        # there as here
        sel = (step_ids[:, None] == idx[None, :]).to(dt)      # [T, K]
        w_sel = (cand * sel[:, :, None]).sum(0)
        f_sel = (f_cand * sel).sum(0)
        conv = pg.abs().amax(-1) <= gtol * torch.clamp_min(f_cur.abs(), 1.0)
        move = (f_sel < f_cur) & ~conv
        w_next = torch.where(move[:, None], w_sel, w)
        f_next_sel, g_next = value_grad(w_next)
        f_next = torch.where(move, f_next_sel, f_cur)
        s = w_next - w
        yv = g_next - g
        sy = (s * yv).sum(-1)
        # relative curvature gate: a tiny positive f32 sy would give a huge
        # rho and a garbage direction
        s_nrm = torch.sqrt((s * s).sum(-1))
        y_nrm = torch.sqrt((yv * yv).sum(-1))
        valid = move & (sy > 1e-8 * s_nrm * y_nrm + 1e-20)
        # a failed line search away from convergence resets the lane to
        # steepest descent with the 1/Lipschitz scale
        fail = ~move & ~conv
        s = torch.where(valid[:, None], s, 0.0)
        yv = torch.where(valid[:, None], yv, 0.0)
        rho_new = torch.where(valid, 1.0 / torch.where(valid, sy, 1.0), 0.0)
        vslot = valid[None, :, None]
        S_next = torch.where(vslot, torch.cat([S[1:], s[None]]), S)
        Y_next = torch.where(vslot, torch.cat([Y[1:], yv[None]]), Y)
        rho_next = torch.where(
            valid[None, :], torch.cat([rho[1:], rho_new[None]]), rho)
        S = torch.where(fail[None, :, None], 0.0, S_next)
        Y = torch.where(fail[None, :, None], 0.0, Y_next)
        rho = torch.where(fail[None, :], 0.0, rho_next)
        gamma_next = torch.where(
            valid, sy / torch.clamp_min((yv * yv).sum(-1), 1e-20), gamma)
        gamma = torch.where(fail, gamma00, gamma_next)
        w, f_cur, g = w_next, f_next, g_next
    return w


def fit_logistic_binary(
    x, y, row_mask, reg_param, elastic_net, num_iters: int = 100,
    fit_intercept: bool = True, standardization: bool = True, device=None,
    mesh=None, num_rows=None,
) -> GLMParams:
    """Binary logistic regression by L-BFGS/OWL-QN: the K=1 lane of
    ``fit_logistic_binary_batched``, so the sweep and the winner's refit
    run the same math. Weights [D], intercept scalar on the device."""
    dev = resolve_device(device)
    out = fit_logistic_binary_batched(
        x, y, to_device(row_mask, dev)[None, :],
        np.asarray([reg_param], dtype=np.float32),
        np.asarray([elastic_net], dtype=np.float32),
        num_iters=num_iters, fit_intercept=fit_intercept,
        standardization=standardization, device=dev, mesh=mesh,
        num_rows=num_rows,
    )
    return GLMParams(weights=out.weights[0], intercept=out.intercept[0])


def fit_logistic_binary_batched(
    x, y, row_masks, reg_params, elastic_nets, num_iters: int = 100,
    fit_intercept: bool = True, standardization: bool = True, device=None,
    mesh=None, num_rows=None,
) -> GLMParams:
    """K binary logistic L-BFGS/OWL-QN fits sharing one feature matrix x
    [N, D] (y [N] in {0, 1}, row_masks [K, N], reg_params and elastic_nets
    [K]). Lanes batch as GEMM columns on the shared x (per iteration: one
    [T*K]-lane line-search GEMM and one gradient GEMM pair), each lane's
    standardization applied implicitly:
        xs^T r = (x^T (r m) - mean sum(r m)) / std
    Returns weights [K, D], intercept [K] on the device. With ``mesh``
    the rows are this rank's block and ``num_rows`` the global count of
    real rows."""
    dev = resolve_device(device)
    _check_precision(dev)
    red = _row_sum(mesh)
    x = to_device(x, dev)
    y = to_device(y, dev)
    rm = to_device(row_masks, dev)
    reg_params = to_device(reg_params, dev)
    elastic_nets = to_device(elastic_nets, dev)
    k_fits = rm.shape[0]
    n = torch.clamp_min(red("glm_count", rm.sum(dim=1)), 1.0)  # [K]
    # shifted-data moments: center on the global column means first so the
    # one-pass per-lane variance does not cancel in f32 for large-mean
    # columns; without standardization nothing is centered
    if standardization:
        gshift = _col_mean(x, mesh, num_rows)               # [D]
    else:
        gshift = torch.zeros(x.shape[1], dtype=x.dtype, device=dev)
    xc = x - gshift[None, :]
    s1 = red("glm_moments", rm @ xc)                        # [K, D]
    s2 = red("glm_moments", rm @ (xc * xc))                 # [K, D]
    mean_raw = s1 / n[:, None]
    var = torch.clamp_min(s2 / n[:, None] - mean_raw**2, 0.0)
    std = torch.sqrt(var)
    # fold-constant detection is exact and order-invariant (masked
    # min/max), so it equals the reference's
    xmin, xmax = _masked_minmax(x, rm, mesh)                # [K, D] each
    const = xmax <= xmin
    # near-constant columns: clamp std to the one-pass noise floor rather
    # than gating (a continuous guard)
    noise_floor = 2e-3 * torch.sqrt(s2 / n[:, None]) + 1e-12
    if standardization:
        safe = torch.where(const, 1.0, torch.maximum(std, noise_floor))
        if fit_intercept:
            mean_c = mean_raw
        else:
            # no intercept: scale only, never center (Spark parity); the
            # gradients then see raw x
            mean_c = torch.zeros_like(mean_raw)
            xc = x
    else:
        mean_c = torch.zeros_like(mean_raw)
        safe = torch.ones_like(std)
        xc = x
    l1 = (reg_params * elastic_nets)[:, None]               # [K, 1]
    l2 = (reg_params * (1.0 - elastic_nets))[:, None]
    d_cols = x.shape[1]
    zero = x.new_zeros(())

    def _loss_terms(logits, w_std):
        # logits [..., K, N], w_std [..., K, D] -> objective [..., K];
        # jax.nn.softplus is logaddexp(x, 0) (torch's softplus returns x
        # itself above its threshold of 20)
        ll = torch.logaddexp(logits, zero) - y * logits
        f = red("glm_loss", (ll * rm).sum(-1)) / n
        f = f + 0.5 * l2[:, 0] * (w_std * w_std).sum(-1)
        return f + l1[:, 0] * torch.abs(w_std).sum(-1)

    def _logits_of(ws, b):
        # ws [..., K, D] (already scaled by 1/safe) -> logits [..., K, N];
        # every candidate of the line search in one GEMM
        lead = ws.shape[:-1]
        lin = (xc @ ws.reshape(-1, d_cols).T).T.reshape(*lead, -1)
        out = lin - (mean_c * ws).sum(-1)[..., None]
        if fit_intercept:
            out = out + b[..., None]
        return out

    def candidates_value(cand):                             # [T, K, P]
        w_std, b = cand[..., :-1], cand[..., -1]
        return _loss_terms(_logits_of(w_std / safe, b), w_std)

    def value_grad(params):                                 # [K, P]
        w_std, b = params[:, :-1], params[:, -1]
        ws = w_std / safe
        logits = _logits_of(ws, b)
        f_total = _loss_terms(logits, w_std)
        # jax.nn.sigmoid as XLA's CPU backend evaluates it (the tree
        # port's twin), which takes one source of difference out
        p = _xla_sigmoid(logits)
        r = (p - y[None, :]) * rm                           # [K, N]
        xr = red("glm_grad", r @ xc)                        # [K, D]
        rsum = red("glm_grad_sum", r.sum(dim=1))[:, None]
        gw = (xr - mean_c * rsum) / safe / n[:, None] + l2 * w_std
        if standardization:
            # constant columns are cancellation noise: pin them at 0
            gw = torch.where(const, 0.0, gw)
        gb = rsum[:, 0] / n if fit_intercept else torch.zeros_like(n)
        return f_total, torch.cat([gw, gb[:, None]], dim=1)

    # tr(Xs^T Xs)/n per lane: the count of non-constant columns when
    # centered and standardized; (var + mean^2)/std^2 scaled but not
    # centered; the raw masked second moment without standardization
    if standardization and fit_intercept:
        col_sum = (~const).sum(dim=1).to(x.dtype)
    elif standardization:
        raw_second = var + (gshift[None, :] + mean_raw) ** 2
        col_sum = torch.where(const, 0.0, raw_second / safe**2).sum(dim=1)
    else:
        col_sum = (s2 / n[:, None]).sum(dim=1)
    lip = 0.25 * col_sum + l2[:, 0]
    gamma0 = 1.0 / torch.clamp_min(lip, 1e-6)              # [K]

    # l1 applies to the weights only, never the intercept slot
    l1_mat = torch.cat([l1.expand(k_fits, d_cols),
                        torch.zeros((k_fits, 1), dtype=x.dtype, device=dev)],
                       dim=1)
    params0 = torch.zeros((k_fits, d_cols + 1), dtype=x.dtype, device=dev)
    params = _lbfgs_owlqn(value_grad, candidates_value, params0, l1_mat,
                          gamma0, num_iters)
    w_std, b_std = params[:, :-1], params[:, -1]
    w = w_std / safe
    mean_total = gshift[None, :] + mean_c
    b = b_std - (w_std * mean_total / safe).sum(dim=1)
    return GLMParams(weights=w, intercept=b if fit_intercept
                     else torch.zeros_like(b))


def fit_logistic_multinomial_batched(
    x, y, row_masks, reg_params, elastic_nets, num_classes: int,
    num_iters: int = 200, fit_intercept: bool = True,
    standardization: bool = True, device=None, mesh=None, num_rows=None,
) -> GLMParams:
    """K softmax regressions (Spark multinomial logistic parity) sharing
    one feature matrix x [N, D] (y [N] class ids, row_masks [K, N],
    reg_params and elastic_nets [K]): the reference's per-lane FISTA
    (``fit_logistic_multinomial`` under ``vmap``) with the lanes batched.
    Each lane standardizes explicitly, as the reference does (``xs``
    [K, N, D], made lane by lane by ``_standardize``); per iteration one
    batched [N, D] x [D, C] product, a softmax, and one batched [D, N] x
    [N, C] gradient product. Returns weights [K, D, C], intercept [K, C] on
    the device. With ``mesh`` the rows are this rank's block."""
    dev = resolve_device(device)
    _check_precision(dev)
    red = _row_sum(mesh)
    x = to_device(x, dev)
    y = to_device(y, dev)
    rm = to_device(row_masks, dev)
    regs = to_device(reg_params, dev)
    ens = to_device(elastic_nets, dev)
    k_fits, (n_rows, d) = rm.shape[0], x.shape
    c = int(num_classes)
    n = torch.clamp_min(red("glm_count", rm.sum(dim=1)), 1.0)  # [K]
    xs = torch.empty((k_fits, n_rows, d), dtype=x.dtype, device=dev)
    mean = torch.zeros((k_fits, d), dtype=x.dtype, device=dev)
    std = torch.ones((k_fits, d), dtype=x.dtype, device=dev)
    for k in range(k_fits):
        if standardization:
            xs_k, mean_k, std_k, const_k = _standardize(x, rm[k], red)
            if fit_intercept:
                mean[k] = mean_k
            else:
                xs_k = _scale_only(x, rm[k], std_k, const_k)
            std[k] = std_k
        else:
            xs_k = torch.where(rm[k][:, None] > 0, x, 0.0)
        xs[k] = xs_k
    y1h = (y[:, None] == torch.arange(c, device=dev, dtype=y.dtype)[None, :]
           ).to(x.dtype)                                    # [N, C]
    l1 = (regs * ens)[:, None]                              # [K, 1]
    l2 = (regs * (1.0 - ens))[:, None, None]                # [K, 1, 1]
    dc = d * c
    rmc = rm[:, :, None]

    def unpack(params):
        return params[:, :dc].reshape(k_fits, d, c), params[:, dc:]

    def grad(params):
        w, b = unpack(params)
        logits = torch.bmm(xs, w)
        if fit_intercept:
            logits = logits + b[:, None, :]
        r = (torch.softmax(logits, dim=-1) - y1h[None]) * rmc  # [K, N, C]
        gw = (red("glm_grad", torch.bmm(xs.transpose(1, 2), r))
              / n[:, None, None] + l2 * w)
        gb = (red("glm_grad_sum", r.sum(dim=1)) / n[:, None] if fit_intercept
              else torch.zeros_like(b))
        return torch.cat([gw.reshape(k_fits, dc), gb], dim=1)

    def prox(params, step):
        return torch.cat([_soft_threshold(params[:, :dc], step * l1),
                          params[:, dc:]], dim=1)

    col = red("glm_lipschitz", (xs * xs).sum(dim=1)) / n[:, None]  # [K, D]
    lip = 0.5 * col.sum(dim=1, keepdim=True) + l2[:, :, 0]  # [K, 1]
    step = 1.0 / torch.clamp_min(lip, 1e-6)
    params0 = torch.zeros((k_fits, dc + c), dtype=x.dtype, device=dev)
    params = _fista(grad, prox, params0, step, num_iters)
    del xs
    w_std, b_std = unpack(params)
    w = w_std / std[:, :, None]
    b = b_std - (w_std * (mean / std)[:, :, None]).sum(dim=1)
    return GLMParams(weights=w, intercept=b if fit_intercept
                     else torch.zeros_like(b))


def fit_logistic_multinomial(
    x, y, row_mask, reg_param, elastic_net, num_classes: int,
    num_iters: int = 200, fit_intercept: bool = True,
    standardization: bool = True, device=None, mesh=None, num_rows=None,
) -> GLMParams:
    """Softmax regression, one fit: the K=1 lane of
    ``fit_logistic_multinomial_batched``. Weights [D, C], intercept [C] on
    the device."""
    dev = resolve_device(device)
    out = fit_logistic_multinomial_batched(
        x, y, to_device(row_mask, dev)[None, :],
        np.asarray([reg_param], dtype=np.float32),
        np.asarray([elastic_net], dtype=np.float32), num_classes,
        num_iters=num_iters, fit_intercept=fit_intercept,
        standardization=standardization, device=dev, mesh=mesh,
    )
    return GLMParams(weights=out.weights[0], intercept=out.intercept[0])


def fit_linear_svc(
    x, y, row_mask, reg_param, num_iters: int = 400,
    fit_intercept: bool = True, standardization: bool = True, device=None,
) -> GLMParams:
    """Linear SVM (OpLinearSVC parity) through the Huberized hinge + L2:
    the hinge smoothed on a band of width ``delta`` = 0.1, so FISTA has a
    true Lipschitz constant. y [N] in {0, 1}. Weights [D], intercept scalar
    on the device."""
    dev = resolve_device(device)
    _check_precision(dev)
    x = to_device(x, dev)
    y = to_device(y, dev)
    row_mask = to_device(row_mask, dev)
    n = torch.clamp_min(row_mask.sum(), 1.0)
    d = x.shape[1]
    if standardization:
        xs, mean, std, const = _standardize(x, row_mask)
        if not fit_intercept:
            mean = torch.zeros(d, dtype=x.dtype, device=dev)
            xs = _scale_only(x, row_mask, std, const)
    else:
        xs = torch.where(row_mask[:, None] > 0, x, 0.0)
        mean = torch.zeros(d, dtype=x.dtype, device=dev)
        std = torch.ones(d, dtype=x.dtype, device=dev)
    s = 2.0 * y - 1.0
    delta = _f32(0.1)
    reg = _f32(reg_param)

    def grad(params):
        w, b = params[:-1], params[-1]
        z = xs @ w
        if fit_intercept:
            z = z + b
        margin = s * z
        # dL/dmargin of the Huberized hinge: -1 below the band, linear in it
        slope = -torch.clamp((1.0 - margin) / delta, 0.0, 1.0)
        r = slope * s * row_mask
        gw = (xs * r[:, None]).sum(0) / n + reg * w
        gb = r.sum() / n if fit_intercept else torch.zeros_like(b)
        return torch.cat([gw, gb.reshape(1)])

    def prox(params, _step):
        return params

    col = (xs * xs).sum(0) / n
    lip = (col.sum() + 1.0) / delta + reg
    step = 1.0 / torch.clamp_min(lip, 1e-6)
    params0 = torch.zeros(d + 1, dtype=x.dtype, device=dev)
    params = _fista(grad, prox, params0, step, num_iters)
    w_std, b_std = params[:-1], params[-1]
    w = w_std / std
    b = b_std - (w_std * mean / std).sum()
    return GLMParams(weights=w, intercept=b if fit_intercept
                     else torch.zeros_like(b))


# GLM family and link codes (Spark GeneralizedLinearRegression parity)
GLM_FAMILIES = {"gaussian": 0, "binomial": 1, "poisson": 2, "gamma": 3}
GLM_LINKS = {"identity": 0, "log": 1, "logit": 2, "inverse": 3, "sqrt": 4}
GLM_DEFAULT_LINK = {
    "gaussian": "identity", "binomial": "logit", "poisson": "log",
    "gamma": "inverse",
}


def _glm_linkinv(link: int, eta, eps):
    if link == 0:
        return eta
    if link == 1:
        return torch.exp(eta)
    if link == 2:
        return torch.sigmoid(eta)
    if link == 3:
        return 1.0 / torch.where(torch.abs(eta) > eps, eta, eps)
    return eta * eta


def _glm_dmu_deta(link: int, eta, mu, eps):
    if link == 0:
        return torch.ones_like(eta)
    if link == 1:
        return mu
    if link == 2:
        return mu * (1.0 - mu)
    if link == 3:
        return -mu * mu
    return 2.0 * torch.sqrt(torch.clamp_min(mu, eps))


def _glm_variance(family: int, mu):
    if family == 0:
        return torch.ones_like(mu)
    if family == 1:
        return mu * (1.0 - mu)
    if family == 2:
        return mu
    return mu * mu


def _glm_init_eta(family: int, link: int, y, eps):
    """The family-aware starting point on the linear scale."""
    if family == 0:
        mu0 = y
    elif family == 1:
        mu0 = (y + 0.5) / 2.0
    elif family == 2:
        mu0 = torch.clamp_min(y, 0.0) + 0.1
    else:
        mu0 = torch.clamp_min(y, eps)
    if link == 0:
        return mu0
    if link == 1:
        return torch.log(torch.clamp_min(mu0, eps))
    if link == 2:
        return torch.log(torch.clamp_min(mu0, eps)
                         / torch.clamp_min(1.0 - mu0, eps))
    if link == 3:
        return 1.0 / torch.clamp_min(mu0, eps)
    return torch.sqrt(torch.clamp_min(mu0, 0.0))


def fit_glm_irls(
    x, y, row_mask, reg_param, family: int = 0, link: int = 0,
    num_iters: int = 25, fit_intercept: bool = True, device=None,
) -> GLMParams:
    """Iteratively reweighted least squares for generalized linear models
    (OpGeneralizedLinearRegression parity, Spark GLR's IRLS with L2 only):
    a fixed ``num_iters`` of float32 normal-equation solves
    (``torch.linalg.solve``), the intercept unregularized. Weights [D],
    intercept scalar on the device."""
    dev = resolve_device(device)
    _check_precision(dev)
    x = to_device(x, dev)
    y = to_device(y, dev)
    row_mask = to_device(row_mask, dev)
    n = torch.clamp_min(row_mask.sum(), 1.0)
    if fit_intercept:
        xa = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype,
                                      device=dev)], dim=1)
    else:
        xa = x
    da = xa.shape[1]
    eps = torch.tensor(1e-7, dtype=x.dtype, device=dev)
    eye = torch.eye(da, dtype=x.dtype, device=dev)
    reg = _f32(reg_param) * eye
    if fit_intercept:  # the intercept is not regularized
        reg[da - 1, da - 1] = 0.0

    def normal_eq(w, z):
        xw = xa * w[:, None]
        return xw.T @ xa / n, xw.T @ z / n

    eta0 = _glm_init_eta(family, link, y, eps)
    xtwx0, xtwz0 = normal_eq(row_mask, eta0)
    beta = torch.linalg.solve(
        xtwx0 + (_f32(reg_param) + eps) * eye, xtwz0)
    for _ in range(num_iters):
        eta = xa @ beta
        mu = _glm_linkinv(link, eta, eps)
        dmu = _glm_dmu_deta(link, eta, mu, eps)
        dmu = torch.where(torch.abs(dmu) > eps, dmu, eps)
        var = torch.maximum(_glm_variance(family, mu), eps)
        z = eta + (y - mu) / dmu
        xtwx, xtwz = normal_eq(row_mask * dmu * dmu / var, z)
        beta = torch.linalg.solve(xtwx + reg + eps * eye, xtwz)
    if fit_intercept:
        return GLMParams(weights=beta[:-1], intercept=beta[-1])
    return GLMParams(weights=beta,
                     intercept=torch.zeros((), dtype=x.dtype, device=dev))
