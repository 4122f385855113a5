"""Huber weights, chi2 gates and the unrolled 6x6 solve (port of
spslam_tpu/solver/robust.py)."""

from __future__ import annotations

import torch

# Chi-square 95% quantiles used by the reference for outlier gates.
CHI2_2D = 5.991   # monocular (2-dof) observations
CHI2_3D = 7.815   # stereo/RGB-D (3-dof) observations


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight: 1 if chi2 <= delta2 else sqrt(delta2 / chi2)."""
    s = torch.clamp_min(chi2, 1e-12)
    return torch.where(s <= delta2, 1.0, torch.sqrt(delta2 / s))


def octave_inv_sigma2(octave: torch.Tensor, scale_factor: float = 1.2) -> torch.Tensor:
    """1 / scale^(2*octave) — the reference's mvInvLevelSigma2."""
    return torch.pow(scale_factor, -2.0 * octave.to(torch.float32))


def solve6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD 6x6 systems H x = b by an unrolled Cholesky (batched).

    Elementwise ops only: no host sync, no LAPACK call per LM iteration.
    """
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)
