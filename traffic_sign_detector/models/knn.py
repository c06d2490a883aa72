"""k-nearest-neighbour classification as a distance matmul + top-k.

Replaces sklearn's KNeighborsClassifier(4) over LDA-reduced features
(`Reconocimiento de Objetos/source.py:582-596`): squared Euclidean distances
are one Gram matmul on device, neighbours via lax.top_k, prediction by
majority vote with sklearn's tie-break (smallest class label wins ties).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
from jax import lax


@dataclasses.dataclass(frozen=True)
class KNNParams:
    train_x: np.ndarray  # [M, K]
    train_y: np.ndarray  # [M] integer labels
    classes: np.ndarray  # [C] sorted unique labels
    k: int = 4

    def save(self, path: str) -> None:
        np.savez(path, train_x=self.train_x, train_y=self.train_y,
                 classes=self.classes, k=self.k)

    @classmethod
    def load(cls, path: str) -> "KNNParams":
        z = np.load(path)
        return cls(train_x=z["train_x"], train_y=z["train_y"],
                   classes=z["classes"], k=int(z["k"]))


def knn_fit(train_x: np.ndarray, train_y: np.ndarray, k: int = 4) -> KNNParams:
    return KNNParams(
        train_x=np.asarray(train_x, np.float32),
        train_y=np.asarray(train_y),
        classes=np.unique(train_y),
        k=k,
    )


def knn_predict(params: KNNParams, X: jnp.ndarray) -> jnp.ndarray:
    """[N, K] -> [N] predicted labels."""
    xq = jnp.asarray(X, jnp.float32)
    xt = jnp.asarray(params.train_x)
    yt = jnp.asarray(params.train_y)
    classes = jnp.asarray(params.classes)

    d2 = (
        jnp.sum(xq * xq, axis=1, keepdims=True)
        - 2.0 * jnp.matmul(xq, xt.T, precision=lax.Precision.HIGHEST)
        + jnp.sum(xt * xt, axis=1)[None, :]
    )
    _, nn_idx = lax.top_k(-d2, params.k)  # [N, k]
    nn_labels = yt[nn_idx]
    votes = jnp.sum(
        nn_labels[..., None] == classes[None, None, :], axis=1
    )  # [N, C]
    best = jnp.argmax(votes, axis=-1)  # first max -> smallest label on ties
    return classes[best]
