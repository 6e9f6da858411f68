"""Line-projection (triangle) geometry and the lambda codecs.

Port of pqt_tpu/ops/triangle.py.  Given a triangle with squared side
lengths a2 = |CB|^2, b2 = |CA|^2, c2 = |AB|^2, the projection X of C onto
line AB divides AB at fraction lambda, and |CX|^2 follows from the law of
cosines without square roots.  Codes are held in int32 tensors (torch's
uint16 arithmetic is patchy on CUDA); the values are those of the JAX
package's uint16/uint8 codes, bit for bit.
"""

from __future__ import annotations

import torch

# lambda is clamped to [-4, 4) and stored in 16 bits.
_LAMBDA_LO = -4.0
_LAMBDA_RANGE = 8.0
_LAMBDA_SCALE = 65536.0 / _LAMBDA_RANGE


def lambda_to_u16(lam: torch.Tensor) -> torch.Tensor:
    """Encode lambda in [-4, 4) to a 16-bit code (int32 tensor)."""
    f = (lam - _LAMBDA_LO) * _LAMBDA_SCALE
    f = torch.where(lam >= 4.0, 65535.0, torch.where(lam < -4.0, 0.0, f))
    return f.to(torch.int32).clamp_(0, 65535)


def u16_to_lambda(u: torch.Tensor) -> torch.Tensor:
    """Decode a 16-bit lambda code."""
    return u.to(torch.float32) * (1.0 / _LAMBDA_SCALE) + _LAMBDA_LO


def lambda_to_u8(lam: torch.Tensor) -> torch.Tensor:
    """Encode lambda to 8 bits on the u16 grid (multiples of 256), so u8 and
    u16 decoders agree exactly on representable values."""
    u16 = lambda_to_u16(lam)
    return torch.clamp_max((u16 + 128) >> 8, 255)


def u8_to_lambda(u: torch.Tensor) -> torch.Tensor:
    """Decode the 8-bit lambda code."""
    return (u.to(torch.float32) * 256.0) * (1.0 / _LAMBDA_SCALE) + _LAMBDA_LO


def project(a2, b2, c2, eps=1e-20):
    """Fraction lambda at which C projects onto AB:
    lambda = -0.5 * (a2 - b2 - c2) / c2."""
    return -0.5 * (a2 - b2 - c2) / torch.clamp_min(c2, eps)


def project_with_residual(a2, b2, c2, eps=1e-20):
    """(lambda, d2): projection fraction and squared distance C<->line,
    d2 = b2 - lambda^2 * c2."""
    lam = project(a2, b2, c2, eps)
    d2 = b2 - lam * lam * torch.clamp_min(c2, eps)
    return lam, d2


def line_dist(a2, b2, c2, lam):
    """Squared distance |CX|^2 where X divides AB at fraction lam:
    d2 = b2 + lam^2 * c2 + lam * (a2 - b2 - c2)."""
    return b2 + lam * lam * c2 + lam * (a2 - b2 - c2)
