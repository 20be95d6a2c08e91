"""The structured Bethe–Salpeter matrix H = [[A, B], [−B, −A]] (real):
A = Q·diag(a)·Qᵀ, B = Q·diag(b)·Qᵀ with Q orthogonal from the QR of an
n × n Gaussian (n = N/2), a_i = 1 + 2·(i + u_i)/n, b_i = 0.5·(2u'_i − 1),
u, u' uniform — all from the seed.  Its exact positive spectrum is
√(a² − b²); ‖H‖₂ = max √(a² − b²) < 3.  A frozen copy of
``chip_smoke.structured_bse_on_device`` (the port's
``models.structured_pseudo_hermitian`` built on the card)."""

from __future__ import annotations

import torch

from portbench.matrices import Problem
from portbench.seeds import generator


def make(cfg: dict, seed: int, device) -> Problem:
    N = int(cfg["N"])
    n = N // 2
    g = generator(device, seed, "bse_structured")
    f64 = dict(dtype=torch.float64, device=device)
    Q, _ = torch.linalg.qr(torch.randn((n, n), generator=g, **f64))
    a = 1.0 + 2.0 * (torch.arange(n, **f64)
                     + torch.rand(n, generator=g, **f64)) / n
    b = 0.5 * (2.0 * torch.rand(n, generator=g, **f64) - 1.0)
    H = torch.empty((N, N), **f64)
    for cols, d in ((slice(0, n), a), (slice(n, N), b)):
        M = (Q * d) @ Q.T
        H[:n, cols] = (M + M.T) / 2
        del M
    del Q
    H[n:, :n] = -H[:n, n:]
    H[n:, n:] = -H[:n, :n]
    H = H.to(getattr(torch, cfg["dtype"]))
    return Problem(H=H, inputs={"a": a, "b": b},
                   norm=float(torch.sqrt(a * a - b * b).max()))
