# Copied from pfemfort_tpu/elements/quadrature.py.
"""Gauss quadrature rules (host-side numpy tables, float64).

Same rule set and weight conventions as the reference's QuadratureUtilities
(/root/reference/src/elemutilitiesquadrature.F): triangle weights are
pre-divided by 2 (:187-247), tetra weights by 6 (:251-323), prism rules are
(triangle x 1D-Gauss) products with the 1/2 triangle factor (:328-415).
Quad/Hexa rules are tensor products of the 1D Gauss-Legendre rules (:95-183).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _gauss_1d(n: int) -> Tuple[np.ndarray, np.ndarray]:
    # numpy's Gauss-Legendre is exact; the reference hard-codes the same
    # nodes/weights to ~15 digits (elemutilitiesquadrature.F:24-83).
    return np.polynomial.legendre.leggauss(n)


_TRIA_RULES = {
    1: (np.array([[1 / 3, 1 / 3]]), np.array([1.0])),
    3: (np.array([[1 / 6, 1 / 6], [1 / 6, 4 / 6], [4 / 6, 1 / 6]]),
        np.array([1 / 3, 1 / 3, 1 / 3])),
    4: (np.array([[1 / 3, 1 / 3], [0.6, 0.2], [0.2, 0.6], [0.2, 0.2]]),
        np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48])),
    6: (np.array([
        [0.10810301816807022736, 0.44594849091596488632],
        [0.44594849091596488632, 0.10810301816807022736],
        [0.44594849091596488632, 0.44594849091596488632],
        [0.81684757298045851308, 0.09157621350977074346],
        [0.09157621350977074346, 0.81684757298045851308],
        [0.09157621350977074346, 0.09157621350977074346]]),
        np.array([0.22338158967801146570] * 3 + [0.10995174365532186764] * 3)),
    7: (np.array([
        [1 / 3, 1 / 3],
        [0.79742698535308732240, 0.10128650732345633880],
        [0.10128650732345633880, 0.79742698535308732240],
        [0.10128650732345633880, 0.10128650732345633880],
        [0.05971587178976982045, 0.47014206410511508977],
        [0.47014206410511508977, 0.05971587178976982045],
        [0.47014206410511508977, 0.47014206410511508977]]),
        np.array([0.225] + [0.12593918054482715260] * 3
                 + [0.13239415278850618074] * 3)),
}

_A4, _B4 = 0.5854101966249685, 0.1381966011250105
_TETRA_RULES = {
    1: (np.array([[0.25, 0.25, 0.25]]), np.array([1.0])),
    4: (np.array([[_A4, _B4, _B4], [_B4, _B4, _B4],
                  [_B4, _B4, _A4], [_B4, _A4, _B4]]),
        np.array([0.25] * 4)),
    5: (np.array([[0.25, 0.25, 0.25],
                  [0.5, 1 / 6, 1 / 6],
                  [1 / 6, 1 / 6, 1 / 6],
                  [1 / 6, 1 / 6, 0.5],
                  [1 / 6, 0.5, 1 / 6]]),
        np.array([-0.8, 0.45, 0.45, 0.45, 0.45])),
}


def gauss_rule(shape: str, ngp: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (points (nGP, pdim), weights (nGP,)) for a reference shape.

    shape in {'line','tria','quad','tetra','hexa','prism'}.  Weights include
    the simplex volume normalization exactly as the reference tables do.
    """
    if shape == "line":
        p, w = _gauss_1d(ngp)
        return p[:, None], w
    if shape == "tria":
        p, w = _TRIA_RULES[ngp]
        return p.astype(np.float64), 0.5 * w.astype(np.float64)
    if shape == "tetra":
        p, w = _TETRA_RULES[ngp]
        return p.astype(np.float64), (1.0 / 6.0) * w.astype(np.float64)
    if shape == "quad":
        n1 = int(round(np.sqrt(ngp)))
        assert n1 * n1 == ngp, f"quad rule needs a square ngp, got {ngp}"
        p, w = _gauss_1d(n1)
        P = np.stack(np.meshgrid(p, p, indexing="ij"), axis=-1)
        # reference order: ii (xi1) fast, jj (xi2) slow (quadrature.F:123-131)
        pts = np.stack([P[..., 0].T.ravel(), P[..., 1].T.ravel()], axis=1)
        wts = np.outer(w, w).ravel()
        return pts, wts
    if shape == "hexa":
        n1 = int(round(ngp ** (1 / 3)))
        assert n1 ** 3 == ngp, f"hexa rule needs a cubic ngp, got {ngp}"
        p, w = _gauss_1d(n1)
        xi3, xi2, xi1 = np.meshgrid(p, p, p, indexing="ij")
        pts = np.stack([xi1.ravel(), xi2.ravel(), xi3.ravel()], axis=1)
        w3, w2, w1 = np.meshgrid(w, w, w, indexing="ij")
        return pts, (w1 * w2 * w3).ravel()
    if shape == "prism":
        # (triangle point set) x (1D Gauss in the extrusion direction);
        # composite rules 1/2/3/6 as in quadrature.F:328-415.
        tri_n = {1: 1, 2: 1, 3: 3, 6: 3}[ngp]
        line_n = {1: 1, 2: 2, 3: 1, 6: 2}[ngp]
        tp, tw = gauss_rule("tria", tri_n)
        lp, lw = _gauss_1d(line_n) if line_n > 1 else (np.array([0.0]), np.array([2.0]))
        pts, wts = [], []
        for lk in range(line_n):
            for tk in range(tri_n):
                pts.append([tp[tk, 0], tp[tk, 1], lp[lk]])
                wts.append(tw[tk] * lw[lk])
        return np.asarray(pts), np.asarray(wts)
    raise ValueError(f"unknown quadrature shape {shape!r}")
