"""IMU preintegration (counterpart of rover_slam_tpu/imu/preintegration.py).

Forster et al. midpoint preintegration with the 15x15 covariance and the bias
Jacobians, as the reference's IMU::Preintegrated does it. The JAX package
scans a window padded to a fixed length with a validity mask; here the same
steps run as a Python loop over the samples, a masked step leaving the state
exactly as it was, so a window without padding gives the same result.

Covariance state order: [dR(0:3), dV(3:6), dP(6:9), bg(9:12), ba(12:15)].
`calib_from_numpy` and `preint_from_numpy` carry the JAX package's
NamedTuples (or any object with the same fields) over as tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import lie

GRAVITY = 9.81
GRAVITY_VEC = (0.0, 0.0, -GRAVITY)


def gravity_vec(like: torch.Tensor) -> torch.Tensor:
    """(0, 0, -9.81) on like's device, made there (a tensor built from a
    Python tuple is a host copy, and a host sync, per call)."""
    g = torch.full((1,), GRAVITY_VEC[2], dtype=like.dtype, device=like.device)
    return torch.nn.functional.pad(g, (2, 0))


class ImuCalib(NamedTuple):
    """Noise densities already scaled to per-sample sigmas."""
    Rbc: torch.Tensor      # [3,3] camera-to-body rotation (Tbc)
    tbc: torch.Tensor      # [3]
    sigma_g: torch.Tensor  # gyro noise
    sigma_a: torch.Tensor  # accel noise
    walk_g: torch.Tensor   # gyro bias random walk per sample
    walk_a: torch.Tensor


class PreintState(NamedTuple):
    dR: torch.Tensor   # [3,3]
    dV: torch.Tensor   # [3]
    dP: torch.Tensor   # [3]
    C: torch.Tensor    # [15,15] covariance (dR,dV,dP,bg,ba)
    JRg: torch.Tensor  # [3,3] d(dR)/d(bg)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    dt: torch.Tensor   # scalar total time
    bg: torch.Tensor   # [3] linearization gyro bias
    ba: torch.Tensor   # [3] linearization accel bias


def as_numpy(x) -> np.ndarray:
    """x (a tensor on any device, an array, a scalar) as a float32 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def calib_from_numpy(calib, device=None) -> ImuCalib:
    """An ImuCalib of f32 tensors from any object with its fields (numpy
    arrays, the JAX package's ImuCalib, tensors)."""
    return ImuCalib(*(torch.tensor(as_numpy(getattr(calib, f)), device=device)
                      for f in ImuCalib._fields))


def preint_from_numpy(state, device=None) -> PreintState:
    """A PreintState of f32 tensors from any object with its fields."""
    return PreintState(*(torch.tensor(as_numpy(getattr(state, f)), device=device)
                         for f in PreintState._fields))


def init_state(bg=None, ba=None, device=None, dtype=torch.float32) -> PreintState:
    z3 = torch.zeros(3, dtype=dtype, device=device)
    z33 = torch.zeros((3, 3), dtype=dtype, device=device)
    return PreintState(
        dR=torch.eye(3, dtype=dtype, device=device), dV=z3, dP=z3,
        C=torch.zeros((15, 15), dtype=dtype, device=device),
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        dt=torch.zeros((), dtype=dtype, device=device),
        bg=z3 if bg is None else bg, ba=z3 if ba is None else ba)


def _blocks(rows) -> torch.Tensor:
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _integrate_one(state: PreintState, acc, gyro, dt, calib: ImuCalib) -> PreintState:
    """One midpoint step (reference src/ImuTypes.cc:247-324 semantics)."""
    a = acc - state.ba
    w = gyro - state.bg
    Ra = state.dR @ a
    # Position and velocity with the old dR (the reference updates P, V first).
    dP = state.dP + state.dV * dt + 0.5 * Ra * dt * dt
    dV = state.dV + Ra * dt
    dRa = state.dR @ lie.so3_hat(a)
    # Bias Jacobians, before the rotation update.
    JPa = state.JPa + state.JVa * dt - 0.5 * state.dR * dt * dt
    JPg = state.JPg + state.JVg * dt - 0.5 * dRa @ state.JRg * dt * dt
    JVa = state.JVa - state.dR * dt
    JVg = state.JVg - dRa @ state.JRg * dt
    phi = w * dt
    dRi = lie.so3_exp(phi)
    Jr = lie.so3_right_jacobian(phi)
    dR = lie.normalize_rotation(state.dR @ dRi)
    # Covariance: x' = A x + B n with per-sample noise n = [ng, na].
    I3 = torch.eye(3, dtype=dP.dtype, device=dP.device)
    Z3 = torch.zeros_like(I3)
    A = _blocks([[dRi.T, Z3, Z3],
                 [-dRa * dt, I3, Z3],
                 [-0.5 * dRa * dt * dt, I3 * dt, I3]])
    B = _blocks([[Jr * dt, Z3], [Z3, state.dR * dt], [Z3, 0.5 * state.dR * dt * dt]])
    Nga = _blocks([[calib.sigma_g ** 2 * I3, Z3], [Z3, calib.sigma_a ** 2 * I3]])
    walk = _blocks([[calib.walk_g ** 2 * I3, Z3], [Z3, calib.walk_a ** 2 * I3]])
    C9 = A @ state.C[:9, :9] @ A.T + B @ Nga @ B.T
    Z96 = torch.zeros((9, 6), dtype=dP.dtype, device=dP.device)
    C = _blocks([[C9, Z96], [Z96.T, state.C[9:15, 9:15] + walk * dt]])
    JRg = dRi.T @ state.JRg - Jr * dt
    return PreintState(dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg,
                       JPa=JPa, dt=state.dt + dt, bg=state.bg, ba=state.ba)


def integrate(acc, gyro, dts, mask, calib: ImuCalib, bg=None, ba=None) -> PreintState:
    """Preintegrate a window: acc/gyro [N,3], dts [N], mask [N] bool (True =
    a real sample, None = all real). A masked-out step leaves the state as it
    was. Returns the final PreintState."""
    state = init_state(bg, ba, device=acc.device, dtype=acc.dtype)
    for i in range(acc.shape[0]):
        new = _integrate_one(state, acc[i], gyro[i], dts[i], calib)
        if mask is not None:
            new = PreintState(*(torch.where(mask[i], n, o) for n, o in zip(new, state)))
        state = new
    return state


# ---------------------------------------------------------------------------
# Bias-corrected getters (reference GetDeltaRotation(b) etc.)
# ---------------------------------------------------------------------------

def delta_rotation(state: PreintState, bg) -> torch.Tensor:
    return lie.normalize_rotation(state.dR @ lie.so3_exp(state.JRg @ (bg - state.bg)))


def delta_velocity(state: PreintState, bg, ba) -> torch.Tensor:
    return state.dV + state.JVg @ (bg - state.bg) + state.JVa @ (ba - state.ba)


def delta_position(state: PreintState, bg, ba) -> torch.Tensor:
    return state.dP + state.JPg @ (bg - state.bg) + state.JPa @ (ba - state.ba)


def predict_state(Rwb0, pwb0, vwb0, state: PreintState, bg, ba):
    """Body state propagated through the preintegrated delta (reference
    Tracking::PredictStateIMU). Returns (Rwb1, pwb1, vwb1)."""
    t = state.dt
    g = gravity_vec(Rwb0)
    dR = delta_rotation(state, bg)
    dV = delta_velocity(state, bg, ba)
    dP = delta_position(state, bg, ba)
    Rwb1 = lie.normalize_rotation(Rwb0 @ dR)
    vwb1 = vwb0 + g * t + Rwb0 @ dV
    pwb1 = pwb0 + vwb0 * t + 0.5 * g * t * t + Rwb0 @ dP
    return Rwb1, pwb1, vwb1


def merge(first: PreintState, second: PreintState) -> PreintState:
    """Exact concatenation of two segments that share a linearization bias
    (reference Preintegrated::MergePrevious): dR = dRa dRb,
    dV = dVa + dRa dVb, dP = dPa + dVa dtb + dRa dPb; the bias Jacobians by
    the product rule, the 9x9 covariance through the linearized maps F (first
    segment) and G (second)."""
    dtb = second.dt
    dRa, dRb = first.dR, second.dR
    dR = lie.normalize_rotation(dRa @ dRb)
    dV = first.dV + dRa @ second.dV
    dP = first.dP + first.dV * dtb + dRa @ second.dP
    hat_dVb = lie.so3_hat(second.dV)
    hat_dPb = lie.so3_hat(second.dP)
    JRg = dRb.T @ first.JRg + second.JRg
    JVg = first.JVg - dRa @ hat_dVb @ first.JRg + dRa @ second.JVg
    JVa = first.JVa + dRa @ second.JVa
    JPg = first.JPg + first.JVg * dtb - dRa @ hat_dPb @ first.JRg + dRa @ second.JPg
    JPa = first.JPa + first.JVa * dtb + dRa @ second.JPa
    I3 = torch.eye(3, dtype=dV.dtype, device=dV.device)
    Z3 = torch.zeros_like(I3)
    F9 = _blocks([[dRb.T, Z3, Z3], [-dRa @ hat_dVb, I3, Z3], [-dRa @ hat_dPb, I3 * dtb, I3]])
    G9 = _blocks([[I3, Z3, Z3], [Z3, dRa, Z3], [Z3, Z3, dRa]])
    C9 = F9 @ first.C[:9, :9] @ F9.T + G9 @ second.C[:9, :9] @ G9.T
    Z96 = torch.zeros((9, 6), dtype=dV.dtype, device=dV.device)
    C = _blocks([[C9, Z96], [Z96.T, first.C[9:15, 9:15] + second.C[9:15, 9:15]]])
    return PreintState(dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg,
                       JPa=JPa, dt=first.dt + dtb, bg=first.bg, ba=first.ba)


def information_9(state: PreintState, eps: float = 1e-9) -> torch.Tensor:
    """9x9 information of the (dR, dV, dP) residual: the inverse of C[:9,:9],
    symmetrized. Batched over leading dims; `inv_ex` reads no error flag on
    the host (a singular C gives non-finite entries, which callers mask)."""
    C9 = state.C[..., :9, :9]
    C9 = 0.5 * (C9 + C9.transpose(-1, -2)) + eps * torch.eye(9, dtype=C9.dtype,
                                                           device=C9.device)
    return torch.linalg.inv_ex(C9).inverse
