"""Linear Discriminant Analysis in closed form on device.

Reimplements sklearn's ``LinearDiscriminantAnalysis(solver="svd")`` — the
classifier the reference uses both as its "Bayes" heads and as the KNN
dimensionality reducer (`Reconocimiento de Objetos/source.py:526-577`) — as
pure JAX linear algebra:

* within-class whitening via SVD of the pooled, std-scaled centered data;
* between-class SVD in the whitened space;
* ``transform`` = projection onto the discriminant axes;
* ``decision_function`` = Gaussian log-posterior affine map;
* ``predict_proba`` = softmax (binary: sigmoid of the contrast), identical
  to sklearn's.

Rank truncation is done by masking near-zero singular directions (tolerance
1e-4, sklearn's default) instead of dynamic slicing, keeping every shape
static for jit.  Numerical parity vs sklearn is asserted in tests on real
HOG descriptors.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

# parity-path float products: full f32, never TF32 (exactness vs the
# float64 reference / CPU backend is what these stages are checked on)
_HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class LDAParams:
    """Fitted model; arrays are numpy for easy checkpointing."""

    classes: np.ndarray  # [C] sorted class labels
    xbar: np.ndarray  # [D] overall (prior-weighted) mean
    scalings: np.ndarray  # [D, K] transform matrix (zero-padded rank)
    coef: np.ndarray  # [C, D]
    intercept: np.ndarray  # [C]

    def save(self, path: str) -> None:
        np.savez(
            path,
            classes=self.classes,
            xbar=self.xbar,
            scalings=self.scalings,
            coef=self.coef,
            intercept=self.intercept,
        )

    @classmethod
    def load(cls, path: str) -> "LDAParams":
        z = np.load(path)
        return cls(
            classes=z["classes"],
            xbar=z["xbar"],
            scalings=z["scalings"],
            coef=z["coef"],
            intercept=z["intercept"],
        )


def lda_fit(X: jnp.ndarray, y: np.ndarray, tol: float = 1e-4) -> LDAParams:
    """Fit LDA on [N, D] float data with integer labels.

    Follows the svd-solver algorithm step for step so that decision values,
    probabilities and the transform agree with sklearn to float precision.

    Fitting runs in host numpy: it is train-time-only closed-form algebra on
    small matrices, and a tall-matrix SVD is a poor fit for an accelerator
    (the distributed SPMD trainer in parallel/train.py uses the
    sufficient-statistics formulation instead).  Inference (transform /
    decision / predict_proba) stays on device.
    """
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    classes = np.unique(y)
    n, d = X.shape
    c = len(classes)

    onehot = (y[:, None] == classes[None, :]).astype(np.float32)
    counts = onehot.sum(axis=0)  # [C]
    priors = counts / n
    means = (onehot.T @ X) / counts[:, None]  # [C, D]
    xbar = priors @ means  # [D]

    Xc = X - onehot @ means  # center by class mean
    std = Xc.std(axis=0)
    std[std == 0] = 1.0
    # degenerate guard: with n == c (one sample per class, tiny --limit
    # runs) the within-class variance estimate is undefined; clamp the
    # denominator so the fit stays finite (sklearn raises here instead)
    fac = 1.0 / max(n - c, 1)
    Xs = np.sqrt(fac) * (Xc / std)
    _, S, Vt = np.linalg.svd(Xs, full_matrices=False)
    rank_mask = (S > tol).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_s = np.where(S > tol, 1.0 / np.maximum(S, 1e-30), 0.0)
    scalings1 = (Vt / std[None, :]).T * (inv_s * rank_mask)[None, :]  # [D, R]

    Xb = (
        np.sqrt((n * priors) * fac)[:, None] * (means - xbar)
    ) @ scalings1  # [C, R]
    _, S2, Vt2 = np.linalg.svd(Xb, full_matrices=False)
    mask2 = (S2 > tol * S2[0]).astype(np.float32)
    k = min(c - 1, Vt2.shape[0])
    proj = (Vt2 * mask2[:, None]).T[:, :k]  # [R, K]
    scalings = scalings1 @ proj  # [D, K]

    coef_k = (means - xbar) @ scalings  # [C, K]
    intercept = -0.5 * np.sum(coef_k**2, axis=1) + np.log(priors)
    coef = coef_k @ scalings.T  # [C, D]
    intercept = intercept - coef @ xbar

    return LDAParams(
        classes=np.asarray(classes),
        xbar=np.asarray(xbar, np.float32),
        scalings=np.asarray(scalings, np.float32),
        coef=np.asarray(coef, np.float32),
        intercept=np.asarray(intercept, np.float32),
    )


def lda_transform(params: LDAParams, X: jnp.ndarray) -> jnp.ndarray:
    """[N, D] -> [N, K] discriminant coordinates (sklearn .transform)."""
    return jnp.matmul(jnp.asarray(X, jnp.float32) - jnp.asarray(params.xbar),
                      jnp.asarray(params.scalings), precision=_HI)


def lda_decision(params: LDAParams, X: jnp.ndarray) -> jnp.ndarray:
    """[N, D] -> [N, C] Gaussian log-posterior scores."""
    return jnp.matmul(jnp.asarray(X, jnp.float32),
                      jnp.asarray(params.coef).T,
                      precision=_HI) + jnp.asarray(params.intercept)


def lda_predict_proba(params: LDAParams, X: jnp.ndarray) -> jnp.ndarray:
    """[N, D] -> [N, C] class probabilities (softmax; sigmoid when C == 2)."""
    scores = lda_decision(params, X)
    if len(params.classes) == 2:
        p1 = jax.nn.sigmoid(scores[:, 1] - scores[:, 0])
        return jnp.stack([1.0 - p1, p1], axis=-1)
    return jax.nn.softmax(scores, axis=-1)
