"""The covariant MOGP's model FLOPs, counted from shapes as perfbench/flops.py
counts the variant GP's; nothing here is read from the program.

A value and gradient of the lengthscale-frozen covariant LML over an
(LN, LN) system: the Cholesky factor (LN^3 / 3), K^-1 from it (2 LN^3 / 3)
and the block sums of W o unit that give the gradient in F (2 LN^2). The
unit gram's cross term (2 LN^2 M) is computed once a call, before its
descent."""

from __future__ import annotations


def valgrad_flops(LN: int) -> float:
    """One value and gradient of an (LN, LN) covariant system."""
    return LN ** 3 / 3.0 + 2.0 * LN ** 3 / 3.0 + 2.0 * LN * LN


def unit_gram_flops(LN: int, M: int) -> float:
    """The unit gram's cross term, once a call."""
    return 2.0 * LN * LN * M


def window_flops(LN: int, M: int, evaluations: int, calls: int) -> float:
    """A window's model FLOPs: ``evaluations`` value and gradients and the
    unit grams of the ``calls`` it started."""
    return evaluations * valgrad_flops(LN) + calls * unit_gram_flops(LN, M)
