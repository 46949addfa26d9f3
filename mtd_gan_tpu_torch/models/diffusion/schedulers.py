"""The four noise schedulers of the diffusion family (counterpart of
``mtd_gan_tpu/models/diffusion/schedulers.py``; reference
arch/Diffusion/generative/networks/schedulers/):

  DDPMScheduler  linear betas 1e-4 .. 2e-2 over T = 1000, epsilon
                 prediction, x0 clipped to [-1, 1], FIXED_SMALL variance
                 (ddpm.py)
  DDIMScheduler  eta = 0 (deterministic), x0 clipped, eps recomputed from
                 the clipped x0 (ddim.py)
  PNDMScheduler  PLMS (skip_prk_steps): Adams-Bashforth of order 1 -> 4,
                 the re-step at counter 1, no clipping (pndm.py)
  DPMSolverMultistepScheduler  DPM-Solver++(2M), data prediction, first
                 order at the last step, no clipping (dpm_multi.py)

The reverse chain is a Python loop: ``sample`` calls ``eps_fn(x, t)`` with
``t`` a Python int, then the scheduler's ``step`` on an explicit carry
(the sample first). Every timestep is known on the host, so each step's
coefficients are numpy float32 scalars computed as the JAX package
computes them in float32 (``linear_betas`` and the ``np.cumprod`` table
are float32; DPM's alpha, sigma and lambda tables are taken from that
float32 table in numpy, as there), and the tensors see one multiply or add
per term. DDPM's per-step noise ``z`` comes from the caller's
``z_fn(k)``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
EpsFn = Callable[[Tensor, int], Tensor]
ONE = np.float32(1.0)


def linear_betas(num_train_timesteps: int = 1000, beta_start: float = 1e-4,
                 beta_end: float = 2e-2) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)


def _f(v) -> float:
    """A float32 scalar as the Python float that holds it exactly (a
    tensor op casts it back to float32 without rounding)."""
    return float(np.float32(v))


class BaseScheduler:
    clip_sample = True
    default_inference_steps = 50
    needs_z = False

    def __init__(self, num_train_timesteps: int = 1000):
        self.num_train_timesteps = num_train_timesteps
        self.betas = linear_betas(num_train_timesteps)
        self.alphas_cumprod = np.cumprod(ONE - self.betas)  # float32
        self._acp_tensors = {}

    def _acp(self, device: torch.device) -> Tensor:
        if device not in self._acp_tensors:
            self._acp_tensors[device] = torch.from_numpy(self.alphas_cumprod).to(device)
        return self._acp_tensors[device]

    def add_noise(self, x0: Tensor, noise: Tensor, t: Tensor) -> Tensor:
        """q(x_t | x_0) = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps, ``t`` (N,)."""
        acp = self._acp(x0.device)[t]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        return torch.sqrt(acp).reshape(shape) * x0 + torch.sqrt(1.0 - acp).reshape(shape) * noise

    def timesteps(self, n: int) -> List[int]:
        """The ``t`` given to ``eps_fn`` at each of the ``n`` steps: T / n
        apart, descending to 0."""
        ratio = self.num_train_timesteps // n
        return [k * ratio for k in reversed(range(n))]

    def init_carry(self, noise: Tensor) -> Tuple:
        return (noise,)

    def step(self, carry: Tuple, k: int, t: int, eps: Tensor, n: int,
             z: Optional[Tensor] = None) -> Tuple:
        raise NotImplementedError

    def sample(self, eps_fn: EpsFn, noise: Tensor, num_inference_steps: Optional[int] = None,
               z_fn: Optional[Callable[[int], Tensor]] = None) -> Tensor:
        """The reverse chain from ``noise``; ``z_fn(k)`` gives step k's noise
        where the scheduler draws one (DDPM, t > 0)."""
        n = num_inference_steps or self.default_inference_steps
        carry = self.init_carry(noise)
        for k, t in enumerate(self.timesteps(n)):
            eps = eps_fn(carry[0], t)
            z = z_fn(k) if self.needs_z and t > 0 else None
            carry = self.step(carry, k, t, eps, n, z)
        return carry[0]

    def _pred_x0(self, sample: Tensor, eps: Tensor, acp_t: np.float32) -> Tensor:
        x0 = (sample - _f(np.sqrt(ONE - acp_t)) * eps) / _f(np.sqrt(acp_t))
        return x0.clamp(-1.0, 1.0) if self.clip_sample else x0


class DDPMScheduler(BaseScheduler):
    default_inference_steps = 1000
    needs_z = True

    def step(self, carry, k, t, eps, n, z=None):
        (x,) = carry
        acp = self.alphas_cumprod
        acp_t = acp[t]
        acp_prev = acp[t - 1] if t > 0 else ONE
        x0 = self._pred_x0(x, eps, acp_t)
        # posterior mean coefficients (DDPM eq. 7)
        beta_t = self.betas[t]
        coef_x0 = np.sqrt(acp_prev) * beta_t / (ONE - acp_t)
        coef_xt = np.sqrt(ONE - beta_t) * (ONE - acp_prev) / (ONE - acp_t)
        mean = _f(coef_x0) * x0 + _f(coef_xt) * x
        if t == 0:  # FIXED_SMALL variance, no noise at t == 0
            return (mean,)
        var = beta_t * (ONE - acp_prev) / (ONE - acp_t)
        return (mean + _f(np.sqrt(max(var, np.float32(1e-20)))) * z,)


class DDIMScheduler(BaseScheduler):
    """eta = 0: no noise is drawn."""

    def step(self, carry, k, t, eps, n, z=None):
        (x,) = carry
        acp = self.alphas_cumprod
        acp_t = acp[t]
        t_prev = t - self.num_train_timesteps // n
        acp_prev = acp[t_prev] if t_prev >= 0 else ONE
        x0 = self._pred_x0(x, eps, acp_t)
        # eps recomputed from the (clipped) x0, as the reference does
        eps_hat = (x - _f(np.sqrt(acp_t)) * x0) / _f(np.sqrt(ONE - acp_t))
        direction = _f(np.sqrt(max(ONE - acp_prev, np.float32(0.0)))) * eps_hat
        return (_f(np.sqrt(acp_prev)) * x0 + direction,)


class PNDMScheduler(BaseScheduler):
    """PLMS (skip_prk_steps=True, reference pndm.py:140-145). The carry is
    (sample, the sample remembered at counter 0, the eps history, newest
    last, at most 4)."""

    clip_sample = False  # the reference's PLMS applies no x0 clipping

    def init_carry(self, noise):
        return (noise, None, [])

    def _prev_sample(self, sample: Tensor, t: int, t_prev: int, eps: Tensor) -> Tensor:
        acp = self.alphas_cumprod
        acp_t = acp[t]
        acp_prev = acp[t_prev] if t_prev >= 0 else ONE
        beta_t = ONE - acp_t
        beta_prev = ONE - acp_prev
        sample_coeff = np.sqrt(acp_prev / acp_t)
        denom = acp_t * np.sqrt(beta_prev) + np.sqrt(acp_t * beta_t * acp_prev)
        return _f(sample_coeff) * sample - _f(acp_prev - acp_t) * eps / _f(denom)

    def step(self, carry, k, t, eps, n, z=None):
        # the counter semantics of the reference PLMS loop (pndm.py:255-276):
        # counter 0: plain eps, remember the sample; counter 1: re-step the
        # first transition from the remembered sample with the averaged eps
        # (t and t_prev shifted up by one ratio); counters >= 2:
        # Adams-Bashforth of order min(len(ets), 4)
        x, cur_sample, ets = carry
        ratio = self.num_train_timesteps // n
        if k == 1:
            eps_used = (eps + ets[-1]) / 2.0
            return (self._prev_sample(cur_sample, t + ratio, t, eps_used), cur_sample, ets)
        ets = (ets + [eps])[-4:]
        if len(ets) == 1:
            eps_used = eps
        elif len(ets) == 2:
            eps_used = (3 * ets[-1] - ets[-2]) / 2.0
        elif len(ets) == 3:
            eps_used = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12.0
        else:
            eps_used = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3] - 9 * ets[-4]) / 24.0
        cur_sample = x if k == 0 else cur_sample
        return (self._prev_sample(x, t, t - ratio, eps_used), cur_sample, ets)


class DPMSolverMultistepScheduler(BaseScheduler):
    """DPM-Solver++(2M): second order while a previous x0 exists and not at
    the last step (reference dpm_multi.py defaults). The carry is (sample,
    the previous step's x0 or None)."""

    clip_sample = False

    def timesteps(self, n):
        # linspace over [0, T - 1], descending (diffusers / MONAI style)
        ts = np.linspace(0, self.num_train_timesteps - 1, n + 1).round()[::-1][:-1]
        return [int(t) for t in ts.astype(np.int64)]

    def tables(self, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """alpha, sigma and lambda at the n + 1 boundary points (t = 0
        appended), in float32 from the float32 ``alphas_cumprod``."""
        t_bound = np.asarray(self.timesteps(n) + [0])
        acp = self.alphas_cumprod
        alpha_t = np.sqrt(acp[t_bound])
        sigma_t = np.sqrt(1.0 - acp[t_bound])
        return alpha_t, sigma_t, np.log(alpha_t) - np.log(sigma_t)

    def init_carry(self, noise):
        return (noise, None)

    def step(self, carry, k, t, eps, n, z=None):
        x, x0_prev = carry
        alpha, sigma, lam = self.tables(n)
        a_i, s_i = alpha[k], sigma[k]
        x0 = (x - _f(s_i) * eps) / _f(a_i)
        h = lam[k + 1] - lam[k]
        a_next, s_next = alpha[k + 1], sigma[k + 1]
        # first-order (DPM-Solver++(1)) update
        x_next = _f(s_next / s_i) * x - _f(a_next * np.expm1(-h)) * x0
        if x0_prev is not None and k < n - 1:
            # the second-order multistep correction
            h_prev = lam[k] - lam[max(k - 1, 0)]
            r = h_prev / (ONE if h == 0 else h)
            d1 = (x0 - x0_prev) / _f(ONE if r == 0 else r)
            x_next = x_next - _f(np.float32(0.5) * a_next * np.expm1(-h)) * d1
        return (x_next, x0)
