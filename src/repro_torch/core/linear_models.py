"""Linear and kernel classifiers for the paper's Table 1 / Figure 2
experiments (port of ``repro.core.linear_models``).

The paper trains LIBLINEAR on random features and LIBSVM on exact kernels.
The stand-ins, on torch tensors on their own device:

  * ``train_linear`` — L2-regularized {logistic | squared-hinge} linear
    classifier by full-batch Newton-CG: a fixed 20 Newton steps of 25 CG
    steps each, with Hessian-vector products in the closed forms of the
    two losses (the reference takes them as ``jvp`` of ``grad``). The
    primal problem class LIBLINEAR solves.
  * ``train_kernel_ridge`` — exact-kernel baseline: ``(K + lam N I) alpha =
    y`` in host fp64 numpy (Cholesky with a jitter fallback), plus a
    squared-hinge Newton active-set refinement for ±1 labels (primal L2-SVM,
    Chapelle 2007), word for word the reference's.
  * ``train_kernel_svm`` — dual L2-SVM by projected coordinate ascent on the
    exact Gram matrix (small N; the LIBSVM stand-in): N x ``n_epochs``
    sequential coordinate steps, on the Gram's device with no host sync.

Every trainer returns a ``Classifier`` with ``decision`` / ``predict`` /
``accuracy``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Classifier",
    "train_linear",
    "train_featurized_linear",
    "train_kernel_ridge",
    "train_kernel_svm",
]


@dataclasses.dataclass
class Classifier:
    decision_fn: Callable[[torch.Tensor], torch.Tensor]

    def decision(self, X: torch.Tensor) -> torch.Tensor:
        return self.decision_fn(X)

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        return torch.sign(self.decision(X))

    def accuracy(self, X: torch.Tensor, y: torch.Tensor) -> float:
        pred = self.predict(X)
        y = torch.as_tensor(y, device=pred.device)
        return float((pred == torch.sign(y)).float().mean())


# ---------------------------------------------------------------------------
# Primal linear models (LIBLINEAR stand-in)
# ---------------------------------------------------------------------------
def _loss_derivatives(loss: str, margins: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(l'(m), l''(m))`` of the per-example loss at the margins ``m``,
    each divided by N (the loss is a mean). The squared hinge's ``l''`` is
    the generalized second derivative ``2 [1 - m > 0]``."""
    n = margins.shape[0]
    if loss == "squared_hinge":
        slack = 1.0 - margins
        d1 = -2.0 * torch.clamp_min(slack, 0.0)
        d2 = 2.0 * (slack > 0).float()
    elif loss == "logistic":
        s = torch.sigmoid(-margins)
        d1 = -s
        d2 = s * (1.0 - s)
    else:
        raise ValueError(f"unknown loss {loss!r}; available: "
                         "('logistic', 'squared_hinge')")
    return d1 / n, d2 / n


def _fit_linear(X, y, lam: float, loss: str, n_iters: int,
                cg_iters: int = 25):
    """Inexact Newton with CG on the (PSD) Gauss-Newton/Hessian of
    ``mean l(y (X w + b)) + lam/2 |w|^2``; returns (w, b). Scalars stay on
    the device: no step reads a value back to the host."""
    w = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
    b = torch.zeros((), dtype=torch.float32, device=X.device)

    def dot(a, c):                       # over the pair (w-part, b-part)
        return (a[0] * c[0]).sum() + a[1] * c[1]

    for _ in range(n_iters):
        d1, d2 = _loss_derivatives(loss, y * (X @ w + b))
        gy = d1 * y
        g = (X.T @ gy + lam * w, gy.sum())
        curv = d2 * y * y

        def hvp(v):
            t = curv * (X @ v[0] + v[1])
            return (X.T @ t + lam * v[0], t.sum())

        x = (torch.zeros_like(w), torch.zeros_like(b))
        r, p, rs = g, g, dot(g, g)
        for _ in range(cg_iters):
            hp = hvp(p)
            alpha = rs / torch.clamp_min(dot(p, hp), 1e-12)
            x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
            r = (r[0] - alpha * hp[0], r[1] - alpha * hp[1])
            rs_new = dot(r, r)
            beta = rs_new / torch.clamp_min(rs, 1e-30)
            p = (r[0] + beta * p[0], r[1] + beta * p[1])
            rs = rs_new
        # backtracking-free damped step (the loss is convex and smooth)
        w, b = w - x[0], b - x[1]
    return w, b


def train_linear(
    X: torch.Tensor,
    y: torch.Tensor,
    lam: float = 1e-4,
    loss: str = "squared_hinge",
    n_iters: int = 20,
) -> Classifier:
    """Train an L2-regularized linear classifier on X's device; y in {-1,
    +1}."""
    X = torch.as_tensor(X).float()
    y = torch.as_tensor(y, device=X.device).float()
    w, b = _fit_linear(X, y, float(lam), loss, n_iters)
    return Classifier(decision_fn=lambda Z: torch.as_tensor(Z).float() @ w + b)


def train_featurized_linear(
    fmap,
    X: torch.Tensor,
    y: torch.Tensor,
    lam: float = 1e-4,
    loss: str = "squared_hinge",
    n_iters: int = 20,
) -> Classifier:
    """The paper's pipeline in one call: featurize with ``fmap`` (any map
    object exposing ``apply``: ``RMFeatureMap``, ``SketchFeatureMap``, ...),
    fit a linear model. Train-time and decision-time featurization both run
    through the map's fused single-launch path, so the returned
    ``Classifier.decision`` takes RAW inputs, not features."""
    def featurize(Z):
        return fmap.apply(torch.as_tensor(Z).float())

    base = train_linear(featurize(X), y, lam=lam, loss=loss, n_iters=n_iters)
    return Classifier(decision_fn=lambda Z: base.decision(featurize(Z)))


# ---------------------------------------------------------------------------
# Exact-kernel baselines (LIBSVM stand-ins)
# ---------------------------------------------------------------------------
def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _chol_solve(system: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """Stabilized host-side fp64 SPD solve: Cholesky with an escalating
    jitter retry, general least-squares as the last resort."""
    n = system.shape[0]
    jitter = 0.0
    for _ in range(4):
        try:
            chol = np.linalg.cholesky(system + jitter * np.eye(n))
            return np.linalg.solve(chol.T, np.linalg.solve(chol, rhs))
        except np.linalg.LinAlgError:
            jitter = max(jitter * 10.0,
                         1e-10 * max(np.trace(system) / n, 1.0))
    return np.linalg.lstsq(system, rhs, rcond=None)[0]


def train_kernel_ridge(
    gram: torch.Tensor, y: torch.Tensor, lam: float = 1e-3,
    kernel_fn: Optional[Callable] = None,
    X_train: Optional[torch.Tensor] = None,
    refine: str | bool = "auto", max_newton_iters: int = 50,
) -> Tuple[torch.Tensor, Classifier]:
    """Solve (K + lam N I) alpha = y. Returns (alpha, clf using kernel_fn).

    The solve runs host-side in float64 via Cholesky with a jitter
    fallback — at small ``lam`` the regularized Gram matrix is
    ill-conditioned and an fp32 on-device solve loses precision near the
    margin.

    As the LIBSVM stand-in baseline, binary ``±1`` labels additionally get
    a Newton active-set refinement on the primal squared-hinge objective
    (Chapelle 2007): each step re-solves the ridge system restricted to
    current margin violators ``y_i f(x_i) < 1``. ``refine`` is ``"auto"``
    (refine iff labels are all ±1), ``True``, or ``False`` (plain ridge
    regression). ``alpha`` comes back in the Gram's dtype, on its device.
    """
    n = gram.shape[0]
    gram_host = _host64(gram)
    rhs = _host64(y)
    ridge = lam * n * np.eye(n)
    alpha_host = _chol_solve(gram_host + ridge, rhs)

    is_binary = bool(np.all(np.abs(np.abs(rhs) - 1.0) < 1e-12))
    if refine is True or (refine == "auto" and is_binary):
        prev_sv = None
        for _ in range(max_newton_iters):
            margin_violation = rhs * (gram_host @ alpha_host) < 1.0
            idx = np.where(margin_violation)[0]
            if prev_sv is not None and np.array_equal(idx, prev_sv):
                break
            prev_sv = idx
            if idx.size == 0:
                break
            sub = _chol_solve(
                gram_host[np.ix_(idx, idx)] + lam * n * np.eye(idx.size),
                rhs[idx])
            alpha_host = np.zeros(n)
            alpha_host[idx] = sub

    alpha = torch.as_tensor(alpha_host, dtype=gram.dtype, device=gram.device)

    def decision(Xt):
        if kernel_fn is None or X_train is None:
            raise ValueError("provide kernel_fn and X_train for prediction")
        return kernel_fn(Xt, X_train) @ alpha

    return alpha, Classifier(decision_fn=decision)


def _svm_epoch(gram, y, q_diag, alpha, ay, C, coords) -> None:
    """Coordinate steps of the dual L2-loss SVM over ``coords``, in order,
    updating ``alpha`` and ``ay = alpha * y`` in place."""
    for i in coords:
        # G_i = y_i * (K @ (alpha*y))_i + alpha_i/(2C) - 1
        g = y[i] * (gram[i] @ ay) + alpha[i] / (2.0 * C) - 1.0
        new_ai = torch.clamp_min(alpha[i] - g / q_diag[i], 0.0)
        alpha[i] = new_ai
        ay[i] = new_ai * y[i]


def _svm_epochs_graphed(gram, y, q_diag, alpha, ay, C, n_epochs) -> None:
    """``n_epochs`` epochs of :func:`_svm_epoch` on a CUDA Gram: one epoch
    captured into a ``torch.cuda.CUDAGraph`` over ``alpha`` / ``ay`` (zeros
    on entry) and replayed. One step is first run eagerly on a side stream
    on scratch copies, so the libraries it calls are initialized before
    the capture; the capture itself runs nothing."""
    side = torch.cuda.Stream(device=gram.device)
    side.wait_stream(torch.cuda.current_stream(gram.device))
    with torch.cuda.stream(side):
        _svm_epoch(gram, y, q_diag, alpha.clone(), ay.clone(), C, range(1))
    torch.cuda.current_stream(gram.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        _svm_epoch(gram, y, q_diag, alpha, ay, C, range(gram.shape[0]))
    for _ in range(n_epochs):
        graph.replay()


def train_kernel_svm(
    gram: torch.Tensor,
    y: torch.Tensor,
    C: float = 1.0,
    n_epochs: int = 40,
    kernel_fn: Optional[Callable] = None,
    X_train: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Classifier]:
    """Dual L2-loss SVM by coordinate ascent over the exact Gram matrix.

    Solves max_a  sum a_i - 1/2 sum a_i a_j y_i y_j Q_ij, 0 <= a_i,
    with Q = K + I/(2C) (L2-loss SVM dual — unbounded above, diagonal
    shift). Coordinates are visited in order 0..N-1, ``n_epochs`` times, as
    in the reference; each step is a few device operations on the Gram's
    device, with no read back to the host.

    On the CPU the epochs run as a Python loop (the plain version). On a
    CUDA Gram one epoch, its N steps with exactly the loop's operations,
    is captured once into a CUDA graph over static ``alpha`` / ``ay``
    buffers and replayed ``n_epochs`` times (the reference compiles the
    same loop with ``lax.scan``): the graph runs the loop's kernels in the
    loop's order, so ``alpha`` is bitwise the loop's, without N x the
    launches' host cost an epoch. A failed capture raises.
    """
    y = torch.as_tensor(y, device=gram.device).to(gram.dtype)
    n = gram.shape[0]
    q_diag = torch.diagonal(gram) + 1.0 / (2.0 * C)
    alpha = torch.zeros(n, dtype=gram.dtype, device=gram.device)
    ay = torch.zeros_like(alpha)                     # alpha * y, kept current
    if gram.device.type == "cuda" and n > 0 and n_epochs > 0:
        _svm_epochs_graphed(gram, y, q_diag, alpha, ay, C, n_epochs)
    else:
        for _ in range(n_epochs):
            _svm_epoch(gram, y, q_diag, alpha, ay, C, range(n))

    coef = alpha * y

    def decision(Xt):
        if kernel_fn is None or X_train is None:
            raise ValueError("provide kernel_fn and X_train for prediction")
        return kernel_fn(Xt, X_train) @ coef

    return alpha, Classifier(decision_fn=decision)
