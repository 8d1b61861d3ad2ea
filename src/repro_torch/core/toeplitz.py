"""Block-(lower)-triangular Toeplitz operators (paper §2.3-2.4).

The parameter-to-observable (p2o) map of a discretized linear autonomous
dynamical system is a block lower-triangular Toeplitz matrix whose first
block column (N_t, N_d, N_m) is all that is stored.  ``F`` embeds in a
block-circulant matrix of block dimension 2*N_t, which the DFT
block-diagonalizes: in Fourier space the matvec is a batched
block-diagonal matvec.

Layouts (paper §C.1 "SOTI/TOSI"): time-domain block vectors are
space-outer-time-inner (SOTI) so the FFT runs over the minor axis;
Fourier-space data is frequency-outer-space-inner (TOSI).

    m  : (N_m, N_t)   SOTI parameter vector
    d  : (N_d, N_t)   SOTI observable vector
    F_col: (N_t, N_d, N_m)  first block column (block index major)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.backend import default_device


def dense_from_block_column(F_col: torch.Tensor) -> torch.Tensor:
    """Materialize the full (N_t*N_d, N_t*N_m) matrix.  Test-scale only."""
    N_t, N_d, N_m = F_col.shape
    F = F_col.new_zeros((N_t * N_d, N_t * N_m))
    for i in range(N_t):
        for j in range(i + 1):
            F[i * N_d:(i + 1) * N_d, j * N_m:(j + 1) * N_m] = F_col[i - j]
    return F


def dense_matvec(F_col: torch.Tensor, m_soti: torch.Tensor) -> torch.Tensor:
    """Reference O(N_t^2) matvec: d_i = sum_{j<=i} F_{i-j} m_j.  SOTI in/out."""
    N_t, N_d, _ = F_col.shape
    dt = torch.promote_types(F_col.dtype, m_soti.dtype)
    m_blocks = m_soti.T.to(dt)
    out = []
    for i in range(N_t):
        acc = F_col.new_zeros((N_d,), dtype=dt)
        for j in range(i + 1):
            acc = acc + F_col[i - j].to(dt) @ m_blocks[j]
        out.append(acc)
    return torch.stack(out, dim=0).T


def dense_rmatvec(F_col: torch.Tensor, d_soti: torch.Tensor) -> torch.Tensor:
    """Reference adjoint matvec m = F^T d (F_col is real).  SOTI in/out."""
    N_t, _, N_m = F_col.shape
    dt = torch.promote_types(F_col.dtype, d_soti.dtype)
    d_blocks = d_soti.T.to(dt)
    out = []
    for j in range(N_t):
        acc = F_col.new_zeros((N_m,), dtype=dt)
        for i in range(j, N_t):
            acc = acc + F_col[i - j].to(dt).T @ d_blocks[i]
        out.append(acc)
    return torch.stack(out, dim=0).T


def fourier_block_column(F_col: torch.Tensor, dtype=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase-0 setup: batched rfft of the zero-padded first block column.

    Always computed in f64 (the paper computes setup in FP64).  Returns
    TOSI split planes ``(F_hat_re, F_hat_im)``, each contiguous of shape
    (N_t + 1, N_d, N_m) at ``dtype`` (default f64).  The complex
    transform is dropped before returning: at the paper shape it is 8 GB.
    """
    N_t = F_col.shape[0]
    F_hat = torch.fft.rfft(F_col.to(torch.float64), n=2 * N_t, dim=0)
    out = dtype if dtype is not None else torch.float64
    re = F_hat.real.to(out).contiguous()
    im = F_hat.imag.to(out).contiguous()
    return re, im


# ---------------------------------------------------------------------------
# Operator construction helpers
# ---------------------------------------------------------------------------

def random_block_column(generator: torch.Generator, N_t: int, N_d: int,
                        N_m: int, decay: float = 0.5,
                        dtype=torch.float32) -> torch.Tensor:
    """Random p2o-like block column with a geometrically decaying impulse
    response, drawn on the generator's device.  Same law as the JAX
    package's ``random_block_column``; the streams differ."""
    dev = generator.device
    blocks = torch.randn((N_t, N_d, N_m), generator=generator, device=dev,
                         dtype=torch.float32)
    scale = decay ** torch.arange(N_t, device=dev, dtype=torch.float32)
    return (blocks * scale[:, None, None] / math.sqrt(N_m)).to(dtype)


def random_unrepresentable(generator: torch.Generator, shape,
                           scale: float = 1.0) -> torch.Tensor:
    """Random f64 values guaranteed to lose ~1/3 ulp(f32) when cast to f32
    (paper §4.2.1): the 29 mantissa bits an f32 cast drops are set to an
    alternating 0101... pattern through an int64 bit view."""
    x = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float64) * 0.5 + 0.5
    bits = x.view(torch.int64)
    mask = (1 << 29) - 1
    bits = (bits & ~mask) | 0x0AAAAAAA
    return bits.view(torch.float64) * scale


def heat_equation_p2o(N_t: int, N_d: int, N_m: int, kappa: float = 0.05,
                      dt: float = 0.02, dtype=torch.float64,
                      device=None) -> torch.Tensor:
    """First block column of the p2o map of a 1-D periodic heat equation
    (forward Euler on N_m points, N_d sensors): F_k = B A^{k-1} C dt.
    ``device=None`` means the card."""
    device = default_device(device)
    n = N_m
    lam = kappa * dt * (n ** 2) / (2.0 * math.pi) ** 2

    def step(u):
        return u + lam * (torch.roll(u, 1, dims=-1) - 2.0 * u
                          + torch.roll(u, -1, dims=-1))

    # numpy's linspace, so the truncated sensor indices match the JAX package
    sensor_idx = torch.as_tensor(
        np.linspace(0, n - 1, N_d).astype(np.int64), device=device)
    u = torch.eye(n, dtype=dtype, device=device) * dt
    cols = []
    for _ in range(N_t):
        cols.append(u[sensor_idx, :])
        u = step(u)
    return torch.stack(cols, dim=0)
