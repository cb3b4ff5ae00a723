"""Vector test functions with known sensitivity structure.

Counterpart of the reference's ``romcomma/user/functions.py``, which wraps
SALib's Ishigami / Sobol-G / Oakley2004 evaluators. SALib is not a dependency
here — the (public, standard) formulas are implemented directly:

  Ishigami:   y = sin(x1) + A sin^2(x2) + B x3^4 sin(x1),   x ~ U[-pi, pi]^3
  Sobol-G':   y = prod_j ((1+alpha_j)|2 x_j - 1|^{alpha_j} + a_j) / (1 + a_j)
  Oakley2004: y = a1.x + a2.sin(x) + a3.cos(x) + x M x^T

A ``Scalar`` calls its formula on ``loc + scale * X[:, :m]``; a ``Vector`` is
a named dict of Scalars concatenated column-wise (reference functions.py:30-123).
The module-level instances reproduce the reference's parameterizations
(functions.py:143-173) so generated repositories match.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np


def ishigami(X: np.ndarray, A: float = 7.0, B: float = 0.1) -> np.ndarray:
    """Ishigami function (SALib-compatible)."""
    return (np.sin(X[:, 0]) + A * np.sin(X[:, 1]) ** 2
            + B * (X[:, 2] ** 4) * np.sin(X[:, 0]))


def sobol_g(X: np.ndarray, a: np.ndarray, delta: np.ndarray | None = None,
            alpha: np.ndarray | None = None) -> np.ndarray:
    """Modified Sobol G' function (SALib-compatible)."""
    a = np.asarray(a, dtype=float)
    delta = np.zeros_like(a) if delta is None else np.asarray(delta, dtype=float)
    alpha = np.ones_like(a) if alpha is None else np.asarray(alpha, dtype=float)
    x = X[:, :len(a)] + delta[None, :]
    x = x - np.floor(x)
    g = ((1 + alpha[None, :]) * np.abs(2 * x - 1) ** alpha[None, :] + a[None, :]) / (1 + a[None, :])
    return np.prod(g, axis=1)


def oakley2004(X: np.ndarray, A: Sequence[np.ndarray], M: np.ndarray) -> np.ndarray:
    """Oakley & O'Hagan (2004) function (SALib-compatible)."""
    a1, a2, a3 = (np.asarray(v, dtype=float) for v in A)
    M = np.asarray(M, dtype=float)
    return (X @ a1 + np.sin(X) @ a2 + np.cos(X) @ a3
            + np.einsum('nm,mk,nk->n', X, M, X))


class Scalar:
    """A scalar function: ``scalar(X) = call(loc + scale * X[:, :m], **kwargs)``
    (reference functions.py:30-70)."""

    def __init__(self, call: Callable[..., np.ndarray], loc, scale, m: int, **kwargs):
        self._call, self._loc, self._scale, self._m, self._kwargs = call, loc, scale, m, kwargs

    @property
    def call(self):
        return self._call

    @property
    def loc(self):
        return self._loc

    @property
    def scale(self):
        return self._scale

    @property
    def m(self) -> int:
        return self._m

    @property
    def kwargs(self):
        return self._kwargs

    def __call__(self, X: np.ndarray, **kwargs) -> np.ndarray:
        return np.reshape(self._call(self._loc + self._scale * X[:, :self._m],
                                     **(self._kwargs | kwargs)), (X.shape[0], 1))


class Vector(dict):
    """A named dict of Scalars, concatenated column-wise on call
    (reference functions.py:73-123)."""

    def __init__(self, name: str, **kwargs: Scalar):
        super().__init__(**kwargs)
        self._name = name

    @classmethod
    def concat(cls, name: str, vectors: Sequence['Vector']) -> 'Vector':
        result = cls(name)
        for vector in vectors:
            result.update({f'{vector.name}.{key}': scalar for key, scalar in vector.items()})
        return result

    @property
    def name(self) -> str:
        return self._name

    @property
    def meta(self) -> Dict:
        return {'name': self._name, 'call': {l: f for l, f in enumerate(self.keys())}}

    def subVector(self, name: str, scalars: Sequence[str]) -> 'Vector':
        return Vector(name, **{scalar: self[scalar] for scalar in scalars})

    def __call__(self, X: np.ndarray, **kwargs) -> np.ndarray:
        return np.concatenate([scalar(X, **kwargs) for scalar in self.values()], axis=1)


_ISHIGAMI = {'call': ishigami, 'loc': -np.pi, 'scale': 2 * np.pi}
_SOBOL_G = {'call': sobol_g, 'loc': 0, 'scale': 1}
_OAKLEY2004 = {'call': oakley2004, 'loc': -1, 'scale': 2}


def linspace(start: float, stop: float, shape: Sequence[int]) -> np.ndarray:
    """Multi-dimensional np.linspace (reference functions.py:131-140)."""
    return np.reshape(np.linspace(start, stop, int(np.prod(shape)), endpoint=True), shape)


ISHIGAMI = Vector(name='ishigami',
                  standard=Scalar(**_ISHIGAMI, m=3, A=7.0, B=0.1),
                  balanced=Scalar(**_ISHIGAMI, m=3, A=20.0, B=1.0),
                  sin=Scalar(**_ISHIGAMI, m=3, A=0.0, B=0.0),
                  )  #: 3 Ishigami functions, requiring M >= 3.

SOBOL_G = Vector(name='sobol_g',
                 weak5_2=Scalar(**_SOBOL_G, m=5, a=np.array([3, 6, 9, 18, 27]), alpha=np.ones((5,)) * 2.0),
                 strong5_2=Scalar(**_SOBOL_G, m=5, a=np.array([1 / 2, 1, 2, 4, 8]), alpha=np.ones((5,)) * 2.0),
                 strong5_4=Scalar(**_SOBOL_G, m=5, a=np.array([1 / 2, 1, 2, 4, 8]), alpha=np.ones((5,)) * 4.0),
                 )  #: 3 modified Sobol G-functions, requiring M >= 5.

OAKLEY2004_5 = Vector(name='oakley2004',
                      lin7=Scalar(**_OAKLEY2004, m=5, A=[linspace(5.0, 5.0 / 2, [5]), np.zeros([5]), np.zeros([5])],
                                  M=np.zeros([5, 5])),
                      quad7=Scalar(**_OAKLEY2004, m=5, A=[linspace(5.0, 5.0 / 2, [5]), np.zeros([5]), np.zeros([5])],
                                   M=linspace(5.0, 1.0, [5, 5])),
                      balanced_quad7=Scalar(**_OAKLEY2004, m=5, A=[-linspace(5.0, 5.0 / 2, [5]), np.zeros([5]), np.zeros([5])],
                                            M=linspace(1.0, 5.0, [5, 5])),
                      )  #: 3 modified Oakley2004 functions, requiring M >= 5.

OAKLEY2004 = Vector(name='oakley2004',
                    lin7=Scalar(**_OAKLEY2004, m=7, A=[linspace(7.0, 7.0 / 2, [7]), np.zeros([7]), np.zeros([7])],
                                M=np.zeros([7, 7])),
                    quad7=Scalar(**_OAKLEY2004, m=7, A=[linspace(7.0, 7.0 / 2, [7]), np.zeros([7]), np.zeros([7])],
                                 M=linspace(7.0, 1.0, [7, 7])),
                    balanced_quad7=Scalar(**_OAKLEY2004, m=7, A=[-linspace(7.0, 7.0 / 2, [7]), np.zeros([7]), np.zeros([7])],
                                          M=linspace(1.0, 7.0, [7, 7])),
                    )  #: 3 modified Oakley2004 functions, requiring M >= 7.

ALL = Vector.concat(name='all', vectors=(ISHIGAMI, SOBOL_G, OAKLEY2004))


def ishigami_analytic_sobol(A: float = 7.0, B: float = 0.1) -> Dict[str, np.ndarray]:
    """Analytic Sobol indices of the Ishigami function — a test oracle.

    Returns first-order S, total ST, and total variance D.
    """
    pi = np.pi
    D1 = B * pi ** 4 / 5 + B ** 2 * pi ** 8 / 50 + 0.5
    D2 = A ** 2 / 8
    D13 = B ** 2 * pi ** 8 * 8 / 225
    D = D1 + D2 + D13
    S = np.array([D1 / D, D2 / D, 0.0])
    ST = np.array([(D1 + D13) / D, D2 / D, D13 / D])
    return {'S': S, 'ST': ST, 'D': D}
