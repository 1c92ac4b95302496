"""Small fp32 point transforms in the JAX package's CPU order.

XLA's CPU backend computes the geometry's small ``precision="highest"``
einsums (``...ij,...nj->...ni`` with j = 2 to 4: the affines, the
intrinsics, the rotations of picopose_tpu/geom/) as a chain of fused
multiply-adds in j's order: ``acc = M[i, 0] x[0]``, then
``acc = fma(M[i, j], x[j], acc)``, one rounding per step.  ``torch.matmul``
on the CPU sums in another order, which depends on the host's vector width
(MKL and oneDNN pick AVX2 or AVX-512 kernels), and a truncation downstream
(train/keypoints.py) turns a last-bit difference into a whole pixel.  So
on the CPU ``apply_rows`` computes XLA's chain bit for bit, on every host;
on the card it is ``torch.matmul``, as it always was, and so it is where
autograd records the product (the chain goes through integer bits).
"""

from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once.  The product of two fp32 values is
    exact in fp64; the fp64 sum is made round-to-odd (an inexact sum whose
    last bit is even moves one ulp toward the exact value), which makes the
    final rounding to fp32 the correctly rounded one."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)  # TwoSum: s + err == p + cd exactly
    bits = s.view(torch.int64)
    fix = ((bits & 1) == 0) & (err != 0) & torch.isfinite(s)
    toward = torch.where((err > 0) == (s > 0), 1, -1)  # +1 grows |s| in sign-magnitude bits
    return torch.where(fix, bits + toward, bits).view(torch.float64).float()


def apply_rows(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., I, J) matrices applied to (..., N, J) points -> (..., N, I),
    i.e. ``x @ M^T``: XLA's fused multiply-add chain on the CPU (module
    docstring), ``torch.matmul`` on the card and under autograd."""
    graded = torch.is_grad_enabled() and (x.requires_grad or M.requires_grad)
    if x.device.type != "cpu" or x.dtype != torch.float32 or graded:
        return torch.matmul(x, M.transpose(-1, -2))
    Mt, xs = M.unsqueeze(-3), x.unsqueeze(-2)  # (..., 1, I, J), (..., N, 1, J)
    acc = Mt[..., 0] * xs[..., 0]
    for j in range(1, M.shape[-1]):
        acc = fma32(Mt[..., j], xs[..., j], acc)
    return acc
