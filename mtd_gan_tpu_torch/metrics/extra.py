"""Extended image-quality metrics, the piq tail (counterpart of
``mtd_gan_tpu/metrics/extra.py``; the reference vendors piq under
module/piq/): 3-D SSIM, MS-SSIM, total variation, GMSD, VIF, FSIM, HaarPSI,
MDSI, BRISQUE, KID, Inception Score, VSI, MSID and the geometry score.

Images are NHWC (NDHWC for 3-D) tensors, as in the JAX package; each
function works in NCHW inside. Depthwise filters are grouped ``F.conv2d``,
the DFTs ``torch.fft``, ``gammaln`` is ``torch.lgamma``, and
``map_coordinates`` is :func:`_sample_linear`. KID, MSID and the geometry
score are numpy, as there (MSID draws from the global ``np.random`` stream
in the reference's order; the geometry score needs ``gudhi``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mtd_gan_tpu_torch.metrics.pixel import gaussian_window

Tensor = torch.Tensor


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _depthwise(x: Tensor, kernel2d, padding=0) -> Tensor:
    """One 2-D kernel applied to every channel of NCHW ``x`` (zero padding
    ``padding`` on each side; 0 = valid)."""
    c = x.shape[1]
    k = torch.as_tensor(np.asarray(kernel2d, np.float32), device=x.device).to(x.dtype)
    return F.conv2d(x, k.expand(c, 1, *k.shape), padding=padding, groups=c)


def _gaussian_kernel2d(size: int, sigma: float) -> np.ndarray:
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs[:, None] ** 2 + xs[None, :] ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _avgpool(x: Tensor, k: int) -> Tensor:
    return F.avg_pool2d(x, k, k)


# ---------------------------------------------------------------------------
# 3-D SSIM (reference module/pytorch_ssim_3d.py:17-143)
# ---------------------------------------------------------------------------

def ssim3d(vol1: Tensor, vol2: Tensor, data_range: float = 1.0,
           window_size: int = 11) -> Tensor:
    """Mean 3-D SSIM over NDHWC volumes (Gaussian window, zero padding)."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()
    win = torch.as_tensor(np.einsum("i,j,k->ijk", g, g, g).astype(np.float32),
                          device=vol1.device).to(vol1.dtype)
    c = vol1.shape[-1]
    k = win.expand(c, 1, *win.shape)
    pad = window_size // 2
    v1, v2 = vol1.permute(0, 4, 1, 2, 3), vol2.permute(0, 4, 1, 2, 3)
    conv = lambda v: F.conv3d(v, k, padding=pad, groups=c)
    mu1, mu2 = conv(v1), conv(v2)
    s1 = conv(v1 * v1) - mu1 * mu1
    s2 = conv(v2 * v2) - mu2 * mu2
    s12 = conv(v1 * v2) - mu1 * mu2
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))
    return torch.mean(m)


# ---------------------------------------------------------------------------
# MS-SSIM (piq ms_ssim semantics, 5 scales)
# ---------------------------------------------------------------------------

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _ssim_parts(x: Tensor, y: Tensor, data_range: float, win: np.ndarray):
    pad = win.shape[0] // 2
    mu1, mu2 = _depthwise(x, win, pad), _depthwise(y, win, pad)
    s1 = _depthwise(x * x, win, pad) - mu1 * mu1
    s2 = _depthwise(y * y, win, pad) - mu2 * mu2
    s12 = _depthwise(x * y, win, pad) - mu1 * mu2
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    ssim = ((2 * mu1 * mu2 + c1) / (mu1 ** 2 + mu2 ** 2 + c1)) * cs
    return torch.mean(ssim), torch.mean(cs)


def ms_ssim(x: Tensor, y: Tensor, data_range: float = 1.0) -> Tensor:
    win = gaussian_window(11, 1.5)
    x, y = _nchw(x), _nchw(y)
    levels = len(_MSSSIM_WEIGHTS)
    out = x.new_tensor(1.0)
    for i, w in enumerate(_MSSSIM_WEIGHTS):
        s, cs = _ssim_parts(x, y, data_range, win)
        v = s if i == levels - 1 else cs
        out = out * torch.clamp(v, min=0.0) ** w
        if i < levels - 1:
            x, y = _avgpool(x, 2), _avgpool(y, 2)
    return out


# ---------------------------------------------------------------------------
# Total variation, GMSD
# ---------------------------------------------------------------------------

def total_variation(x: Tensor) -> Tensor:
    dh = torch.abs(x[:, 1:, :, :] - x[:, :-1, :, :])
    dw = torch.abs(x[:, :, 1:, :] - x[:, :, :-1, :])
    return torch.mean(dh.sum(dim=(1, 2, 3)) + dw.sum(dim=(1, 2, 3)))


_PREWITT = np.array([[1, 0, -1], [1, 0, -1], [1, 0, -1]], np.float32) / 3


def gmsd(x: Tensor, y: Tensor, data_range: float = 1.0, c: float = 0.00261) -> Tensor:
    """Gradient-magnitude similarity deviation (lower = more similar)."""
    x = _avgpool(_nchw(x / data_range), 2)
    y = _avgpool(_nchw(y / data_range), 2)
    grad = lambda z: torch.sqrt(_depthwise(z, _PREWITT, 1) ** 2
                                + _depthwise(z, _PREWITT.T, 1) ** 2 + 1e-12)
    gx, gy = grad(x), grad(y)
    gms = (2 * gx * gy + c) / (gx ** 2 + gy ** 2 + c)
    return torch.sqrt(torch.mean((gms - torch.mean(gms)) ** 2))


# ---------------------------------------------------------------------------
# VIF, pixel domain (reference module/piq/vif.py:33-125)
# ---------------------------------------------------------------------------

def vif_p(pred: Tensor, target: Tensor, sigma_n_sq: float = 2.0,
          data_range: float = 1.0) -> Tensor:
    """Visual Information Fidelity over NHWC gray batches; ``pred`` is the
    distorted image. Inputs of at least 41x41."""
    if pred.shape[1] < 41 or pred.shape[2] < 41:
        raise ValueError(f"vif_p needs inputs of at least 41x41, got {tuple(pred.shape[1:3])}")
    eps = 1e-8
    p = _nchw(pred.float() / data_range)
    t = _nchw(target.float() / data_range)
    num = p.new_zeros(p.shape[0])
    den = p.new_zeros(p.shape[0])
    for scale in range(1, 5):
        ksize = 2 ** (5 - scale) + 1
        kern = _gaussian_kernel2d(ksize, ksize / 5.0)
        if scale > 1:
            p = _depthwise(p, kern)[:, :, ::2, ::2]
            t = _depthwise(t, kern)[:, :, ::2, ::2]
        mu_t, mu_p = _depthwise(t, kern), _depthwise(p, kern)
        s_tt = F.relu(_depthwise(t * t, kern) - mu_t * mu_t)
        s_pp = F.relu(_depthwise(p * p, kern) - mu_p * mu_p)
        s_tp = _depthwise(t * p, kern) - mu_t * mu_p
        g = s_tp / (s_tt + eps)
        sv = s_pp - g * s_tp
        zero = torch.zeros_like(g)
        g = torch.where(s_tt >= eps, g, zero)
        sv = torch.where(s_tt >= eps, sv, s_pp)
        s_tt = torch.where(s_tt >= eps, s_tt, zero)
        g = torch.where(s_pp >= eps, g, zero)
        sv = torch.where(s_pp >= eps, sv, zero)
        sv = torch.where(g >= 0, sv, s_pp)
        g = F.relu(g)
        sv = torch.where(sv > eps, sv, torch.full_like(sv, eps))
        num = num + torch.log10(1.0 + g ** 2 * s_tt / (sv + sigma_n_sq)).sum(dim=(1, 2, 3))
        den = den + torch.log10(1.0 + s_tt / sigma_n_sq).sum(dim=(1, 2, 3))
    return torch.mean((num + eps) / (den + eps))


# ---------------------------------------------------------------------------
# FSIM, gray (reference module/piq/fsim.py:18-444)
# ---------------------------------------------------------------------------

def _ifftshift_np(a: np.ndarray) -> np.ndarray:
    return np.roll(a, [-(s // 2) for s in a.shape], axis=tuple(range(a.ndim)))


def _meshgrid_np(h: int, w: int):
    # piq get_meshgrid (functional/base.py:12-31)
    x = np.arange(-((h - 1) / 2) if h % 2 else -h / 2, h / 2) / (h - 1 if h % 2 else h)
    y = np.arange(-((w - 1) / 2) if w % 2 else -w / 2, w / 2) / (w - 1 if w % 2 else w)
    return np.meshgrid(x, y, indexing="ij")


def _fsim_filters(h: int, w: int, scales: int, orientations: int, min_length: int,
                  mult: int, sigma_f: float, delta_theta: float) -> np.ndarray:
    """(O*S, H, W) log-Gabor x angular-spread filter bank
    (reference module/piq/fsim.py:127-210)."""
    theta_sigma = np.pi / (orientations * delta_theta)
    gx, gy = _meshgrid_np(h, w)
    radius = _ifftshift_np(np.sqrt(gx ** 2 + gy ** 2))
    theta = _ifftshift_np(np.arctan2(-gy, gx))
    radius[0, 0] = 1.0
    sintheta, costheta = np.sin(theta), np.cos(theta)
    lp = _ifftshift_np(1.0 / (1.0 + (np.sqrt(gx ** 2 + gy ** 2) / 0.45) ** (2 * 15)))
    log_gabor = []
    for s in range(scales):
        omega0 = 1.0 / (min_length * mult ** s)
        g = np.exp(-(np.log(radius / omega0) ** 2) / (2 * np.log(sigma_f) ** 2)) * lp
        g[0, 0] = 0.0
        log_gabor.append(g)
    spread = []
    for o in range(orientations):
        angl = o * np.pi / orientations
        ds = sintheta * np.cos(angl) - costheta * np.sin(angl)
        dc = costheta * np.cos(angl) + sintheta * np.sin(angl)
        dtheta = np.abs(np.arctan2(ds, dc))
        spread.append(np.exp(-(dtheta ** 2) / (2 * theta_sigma ** 2)))
    return np.stack([spread[o] * log_gabor[s] for o in range(orientations)
                     for s in range(scales)]).astype(np.float32)


def _median(x: Tensor, dim: int) -> Tensor:
    """The median along ``dim``, the mean of the two middle values for an
    even count (numpy's; ``torch.median`` takes the lower one)."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    hi = s.narrow(dim, n // 2, 1)
    return hi if n % 2 else (s.narrow(dim, n // 2 - 1, 1) + hi) / 2


def _phase_congruency(x: Tensor, scales: int = 4, orientations: int = 4,
                      min_length: int = 6, mult: int = 2, sigma_f: float = 0.55,
                      delta_theta: float = 1.2, k: float = 2.0) -> Tensor:
    """(N, H, W) gray -> (N, H, W) phase congruency
    (reference module/piq/fsim.py:212-338)."""
    eps = np.finfo(np.float32).eps
    n, h, w = x.shape
    filters = torch.as_tensor(_fsim_filters(h, w, scales, orientations, min_length, mult,
                                            sigma_f, delta_theta), device=x.device)
    eo = torch.fft.ifft2(torch.fft.fft2(x.float())[:, None] * filters[None])
    even = eo.real.reshape(n, orientations, scales, h, w)
    odd = eo.imag.reshape(n, orientations, scales, h, w)
    an = torch.sqrt(even ** 2 + odd ** 2)

    filters_ifft = (torch.fft.ifft2(filters).real * np.sqrt(h * w)).reshape(
        1, orientations, scales, h, w)
    f2 = filters.reshape(1, orientations, scales, h, w)
    em_n = torch.sum(f2[:, :, :1] ** 2, dim=(-2, -1), keepdim=True)

    sum_e = even.sum(dim=2, keepdim=True)
    sum_o = odd.sum(dim=2, keepdim=True)
    x_energy = torch.sqrt(sum_e ** 2 + sum_o ** 2) + eps
    mean_e, mean_o = sum_e / x_energy, sum_o / x_energy
    energy = torch.sum(even * mean_e + odd * mean_o - torch.abs(even * mean_o - odd * mean_e),
                       dim=2, keepdim=True)

    abs_eo2 = (even[:, :, :1] ** 2 + odd[:, :, :1] ** 2).reshape(n, orientations, 1, 1, h * w)
    mean_e2n = -_median(abs_eo2, dim=-1) / np.log(0.5)
    noise_power = mean_e2n / em_n
    sum_an2 = torch.sum(torch.sum(filters_ifft ** 2, dim=2, keepdim=True), dim=(-2, -1),
                        keepdim=True)
    sum_ai_aj = torch.zeros((1, orientations, 1, 1, 1), device=x.device)
    for s in range(scales - 1):
        sum_ai_aj = sum_ai_aj + torch.sum(
            torch.sum(filters_ifft[:, :, s:s + 1] * filters_ifft[:, :, s + 1:], dim=2,
                      keepdim=True), dim=(-2, -1), keepdim=True)
    noise_energy2 = 2 * noise_power * sum_an2 + 4 * noise_power * sum_ai_aj
    tau = torch.sqrt(noise_energy2 / 2.0)
    noise_energy = tau * np.sqrt(np.pi / 2.0)
    noise_sigma = torch.sqrt((2.0 - np.pi / 2.0) * tau ** 2)
    t_thresh = (noise_energy + k * noise_sigma) / 1.7
    energy = torch.clamp(energy - t_thresh, min=0.0)
    return (energy.sum(dim=(1, 2)) + eps) / (an.sum(dim=(1, 2)) + eps)


_SCHARR = np.array([[-3.0, 0, 3], [-10, 0, 10], [-3, 0, 3]], np.float32) / 16


def _grad_magnitude(z: Tensor, kernel: np.ndarray) -> Tensor:
    """sqrt(gx^2 + gy^2) of NCHW ``z``, ``kernel`` and its transpose, zero
    padding 1."""
    return torch.sqrt(_depthwise(z, kernel, 1) ** 2 + _depthwise(z, kernel.T, 1) ** 2)


def fsim(pred: Tensor, target: Tensor, data_range: float = 1.0, scales: int = 4,
         orientations: int = 4, min_length: int = 6, mult: int = 2, sigma_f: float = 0.55,
         delta_theta: float = 1.2, k: float = 2.0) -> Tensor:
    """FSIM over NHWC gray batches (piq's ``chromatic=False``)."""
    x = _nchw(pred.float() / data_range * 255.0)
    y = _nchw(target.float() / data_range * 255.0)
    ksize = max(1, round(min(x.shape[2], x.shape[3]) / 256))
    if ksize > 1:
        x, y = _avgpool(x, ksize), _avgpool(y, ksize)
    xl, yl = x[:, 0], y[:, 0]
    pc_x = _phase_congruency(xl, scales, orientations, min_length, mult, sigma_f,
                             delta_theta, k)
    pc_y = _phase_congruency(yl, scales, orientations, min_length, mult, sigma_f,
                             delta_theta, k)
    gm_x = _grad_magnitude(x[:, :1], _SCHARR)[:, 0]
    gm_y = _grad_magnitude(y[:, :1], _SCHARR)[:, 0]
    t1, t2 = 0.85, 160.0
    pc_sim = (2 * pc_x * pc_y + t1) / (pc_x ** 2 + pc_y ** 2 + t1)
    gm_sim = (2 * gm_x * gm_y + t2) / (gm_x ** 2 + gm_y ** 2 + t2)
    pc_max = torch.maximum(pc_x, pc_y)
    score = gm_sim * pc_sim * pc_max
    return torch.mean(score.sum(dim=(1, 2)) / pc_max.sum(dim=(1, 2)))


# ---------------------------------------------------------------------------
# HaarPSI, gray (reference module/piq/haarpsi.py:23-144)
# ---------------------------------------------------------------------------

def _haar_kernel(size: int) -> np.ndarray:
    k = np.ones((size, size), np.float32) / size
    k[size // 2:, :] *= -1.0
    return k


def haarpsi(pred: Tensor, target: Tensor, data_range: float = 1.0, scales: int = 3,
            subsample: bool = True, c: float = 30.0, alpha: float = 4.2) -> Tensor:
    """HaarPSI over NHWC gray batches."""
    x = _nchw(pred.float() / data_range * 255.0)
    y = _nchw(target.float() / data_range * 255.0)
    if subsample:
        pad = (0, x.shape[3] % 2, 0, x.shape[2] % 2)
        x, y = _avgpool(F.pad(x, pad), 2), _avgpool(F.pad(y, pad), 2)

    def coeffs(z):  # channels [s1h s1v s2h s2v s3h s3v]
        outs = []
        for s in range(scales):
            ks = 2 ** (s + 1)
            up, dn = ks // 2 - 1, ks // 2
            zp = F.pad(z, (up, dn, up, dn))
            kern = _haar_kernel(ks)
            outs += [_depthwise(zp, kern), _depthwise(zp, kern.T)]
        return torch.cat(outs, dim=1)

    cx, cy = coeffs(x), coeffs(y)
    weights = torch.maximum(cx[:, 4:6].abs(), cy[:, 4:6].abs())
    sims = []
    for o in range(2):
        mx, my = cx[:, [o, o + 2]].abs(), cy[:, [o, o + 2]].abs()
        sm = (2.0 * mx * my + c) / (mx ** 2 + my ** 2 + c)
        sims.append(sm.sum(dim=1, keepdim=True) / 2.0)
    sim_map = torch.cat(sims, dim=1)
    eps = np.finfo(np.float32).eps
    score = ((torch.sigmoid(sim_map * alpha) * weights).sum(dim=(1, 2, 3)) + eps) / (
        weights.sum(dim=(1, 2, 3)) + eps)
    score = (torch.log(score / (1.0 - score)) / alpha) ** 2
    return torch.mean(score)


# ---------------------------------------------------------------------------
# MDSI (reference module/piq/mdsi.py:18-113, 'sum' combination)
# ---------------------------------------------------------------------------

_LHM = np.array([[0.2989, 0.587, 0.114], [0.3, 0.04, -0.35], [0.34, -0.6, 0.17]],
                np.float32)


def _pow_complex(base: Tensor, exp: float) -> Tuple[Tensor, Tensor]:
    """base ** exp for a possibly negative real base, as (re, im) (piq
    pow_for_complex)."""
    r = torch.abs(base) ** exp
    phi = torch.where(base >= 0, torch.zeros_like(base), torch.full_like(base, np.pi)) * exp
    return r * torch.cos(phi), r * torch.sin(phi)


def mdsi(pred: Tensor, target: Tensor, data_range: float = 1.0, c1: float = 140.0,
         c2: float = 55.0, c3: float = 550.0, alpha: float = 0.6, rho: float = 1.0,
         q: float = 0.25, o: float = 0.25) -> Tensor:
    """MDSI over NHWC batches (gray repeated to RGB, as piq does)."""
    x, y = pred.float(), target.float()
    if x.shape[-1] == 1:
        x, y = x.expand(*x.shape[:-1], 3), y.expand(*y.shape[:-1], 3)
    x, y = _nchw(x / data_range * 255.0), _nchw(y / data_range * 255.0)
    ksize = max(1, round(min(x.shape[2], x.shape[3]) / 256))
    if ksize > 1:
        up, dn = (ksize - 1) // 2, ksize // 2
        x = _avgpool(F.pad(x, (up, dn, up, dn)), ksize)
        y = _avgpool(F.pad(y, (up, dn, up, dn)), ksize)
    lhm = torch.as_tensor(_LHM, device=x.device)
    xl = torch.einsum("nchw,dc->ndhw", x, lhm)
    yl = torch.einsum("nchw,dc->ndhw", y, lhm)
    grad = lambda z: _grad_magnitude(z[:, :1], _PREWITT)
    gm_x, gm_y, gm_avg = grad(xl), grad(yl), grad((xl + yl) / 2.0)
    sim = lambda a, b, cc: (2.0 * a * b + cc) / (a ** 2 + b ** 2 + cc)
    gs = sim(gm_x, gm_y, c1) + sim(gm_x, gm_avg, c2) - sim(gm_y, gm_avg, c2)
    hx, mx, hy, my = xl[:, 1:2], xl[:, 2:], yl[:, 1:2], yl[:, 2:]
    cs = (2.0 * (hx * hy + mx * my) + c3) / (hx ** 2 + hy ** 2 + mx ** 2 + my ** 2 + c3)
    gcs = alpha * gs + (1.0 - alpha) * cs
    re, im = _pow_complex(gcs, q)
    dev = torch.sqrt((re - re.mean(dim=(2, 3), keepdim=True)) ** 2
                     + (im - im.mean(dim=(2, 3), keepdim=True)) ** 2)
    return torch.mean(torch.mean(dev ** rho, dim=(1, 2, 3)) ** (o / rho))


# ---------------------------------------------------------------------------
# BRISQUE (reference module/piq/brisque.py:20-250)
# ---------------------------------------------------------------------------

_GAMMA_TABLE = np.arange(0.2, 10.001, 0.001, dtype=np.float64)


def _gamma_table(device) -> Tensor:
    return torch.as_tensor(_GAMMA_TABLE.astype(np.float32), device=device)


def _ggd_parameters(x: Tensor):
    """Generalised Gaussian fit by the rho / r(gamma) table (reference
    brisque.py:135-151). x: (N, H, W)."""
    gamma = _gamma_table(x.device)
    r_table = torch.exp(torch.lgamma(1.0 / gamma) + torch.lgamma(3.0 / gamma)
                        - 2 * torch.lgamma(2.0 / gamma))
    sigma_sq = torch.mean(x ** 2, dim=(-1, -2))
    e = torch.mean(torch.abs(x), dim=(-1, -2))
    rho = sigma_sq / e ** 2
    idx = torch.argmin(torch.abs(rho[:, None] - r_table[None]), dim=-1)
    return gamma[idx], torch.sqrt(sigma_sq)


def _aggd_parameters(x: Tensor):
    """Asymmetric GGD fit (reference brisque.py:154-180)."""
    gamma = _gamma_table(x.device)
    r_table = torch.exp(2 * torch.lgamma(2.0 / gamma) - torch.lgamma(1.0 / gamma)
                        - torch.lgamma(3.0 / gamma))
    mask_l, mask_r = (x < 0).float(), (x > 0).float()
    count_l, count_r = mask_l.sum(dim=(-1, -2)), mask_r.sum(dim=(-1, -2))
    sigma_l = torch.sqrt(((x * mask_l) ** 2).sum(dim=(-1, -2)) / count_l)
    sigma_r = torch.sqrt(((x * mask_r) ** 2).sum(dim=(-1, -2)) / count_r)
    gamma_hat = sigma_l / sigma_r
    rho_hat = torch.mean(torch.abs(x), dim=(-1, -2)) ** 2 / torch.mean(x ** 2, dim=(-1, -2))
    rho_norm = (rho_hat * (gamma_hat ** 3 + 1) * (gamma_hat + 1)) / (gamma_hat ** 2 + 1) ** 2
    idx = torch.argmin(torch.abs(rho_norm[:, None] - r_table[None]), dim=-1)
    return gamma[idx], sigma_l, sigma_r


def _natural_scene_statistics(luma: Tensor, kernel_size: int = 7,
                              sigma: float = 7.0 / 6) -> Tensor:
    """(N, H, W) luma -> (N, 18) NSS features (reference brisque.py:183-213)."""
    kern = _gaussian_kernel2d(kernel_size, sigma)
    pad = kernel_size // 2
    x4 = luma[:, None]
    mu = _depthwise(x4, kern, pad)[:, 0]
    std = torch.sqrt(torch.abs(_depthwise(x4 ** 2, kern, pad)[:, 0] - mu ** 2))
    nrm = (luma - mu) / (std + 1.0)
    alpha, sig = _ggd_parameters(nrm)
    feats = [alpha, sig ** 2]
    for shift in ((0, 1), (1, 0), (1, 1), (-1, 1)):
        a, s_l, s_r = _aggd_parameters(nrm * torch.roll(nrm, shift, dims=(-2, -1)))
        eta = (s_r - s_l) * torch.exp(torch.lgamma(2.0 / a)
                                      - (torch.lgamma(1.0 / a) + torch.lgamma(3.0 / a)) / 2)
        feats += [a, eta, s_l ** 2, s_r ** 2]
    return torch.stack(feats, dim=-1)


_BRISQUE_RANGES = np.array(
    [[0.338, 10], [0.017204, 0.806612], [0.236, 1.642],
     [-0.123884, 0.20293], [0.000155, 0.712298], [0.001122, 0.470257],
     [0.244, 1.641], [-0.123586, 0.179083], [0.000152, 0.710456],
     [0.000975, 0.470984], [0.249, 1.555], [-0.135687, 0.100858],
     [0.000174, 0.684173], [0.000913, 0.534174], [0.258, 1.561],
     [-0.143408, 0.100486], [0.000179, 0.685696], [0.000888, 0.536508],
     [0.471, 3.264], [0.012809, 0.703171], [0.218, 1.046],
     [-0.094876, 0.187459], [1.5e-005, 0.442057], [0.001272, 0.40803],
     [0.222, 1.042], [-0.115772, 0.162604], [1.6e-005, 0.444362],
     [0.001374, 0.40243], [0.227, 0.996],
     [-0.117188, 0.09832299999999999], [3e-005, 0.531903],
     [0.001122, 0.369589], [0.228, 0.99], [-0.12243, 0.098658],
     [2.8e-005, 0.530092], [0.001118, 0.370399]], np.float32)


def brisque_features(x: Tensor, kernel_size: int = 7, kernel_sigma: float = 7.0 / 6,
                     data_range: float = 1.0) -> Tensor:
    """NHWC gray batch -> (N, 36) scaled BRISQUE features (reference
    brisque.py:51-66, 216-234). H and W even (the 2x nearest downsample is
    then a stride-2 slice)."""
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"brisque_features needs even H, W; got {tuple(x.shape[1:3])}")
    luma = x[..., 0].float() / data_range * 255.0
    feats = []
    for _ in range(2):
        feats.append(_natural_scene_statistics(luma, kernel_size, kernel_sigma))
        luma = luma[:, ::2, ::2]
    f = torch.cat(feats, dim=-1)
    rng = torch.as_tensor(_BRISQUE_RANGES, device=x.device)
    return -1.0 + 2.0 * (f - rng[:, 0]) / (rng[:, 1] - rng[:, 0])


def brisque(x: Tensor, sv_coef: np.ndarray, sv: np.ndarray, gamma: float = 0.05,
            rho: float = -153.591, data_range: float = 1.0) -> Tensor:
    """BRISQUE score with piq's pretrained SVR (sv_coef (M, 1), sv (36, M),
    brisque_svm_weights.pt); lower = better."""
    f = brisque_features(x, data_range=data_range)
    sv_t = torch.as_tensor(np.asarray(sv, np.float32), device=x.device)
    coef = torch.as_tensor(np.asarray(sv_coef, np.float32).reshape(-1), device=x.device)
    dist = torch.sum((f[:, :, None] - sv_t[None]) ** 2, dim=1)
    return torch.exp(-dist * gamma) @ coef - rho


# ---------------------------------------------------------------------------
# KID (polynomial kernel, piq kid semantics), host numpy
# ---------------------------------------------------------------------------

def kid(feats_x: np.ndarray, feats_y: np.ndarray, degree: int = 3, gamma=None,
        coef0: float = 1.0) -> float:
    x = np.asarray(feats_x, np.float64)
    y = np.asarray(feats_y, np.float64)
    g = 1.0 / x.shape[1] if gamma is None else gamma
    kxx = (g * x @ x.T + coef0) ** degree
    kyy = (g * y @ y.T + coef0) ** degree
    kxy = (g * x @ y.T + coef0) ** degree
    m, n = x.shape[0], y.shape[0]
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    return float(sum_xx + sum_yy - 2 * kxy.mean())


# ---------------------------------------------------------------------------
# Inception Score (piq isc semantics)
# ---------------------------------------------------------------------------

def inception_score(features: Tensor, num_splits: int = 10) -> Tuple[Tensor, Tensor]:
    """Inception Score from raw InceptionV3 logits (N, n_classes): softmax,
    per split exp(mean KL(p(y|x) || p(y))), then (mean, std with ddof 1)
    over the splits (reference module/piq/isc.py:20-56). The logits come
    from :func:`mtd_gan_tpu_torch.features.inception.inception_logits`."""
    probas = torch.softmax(torch.as_tensor(features).float(), dim=-1)
    part = probas.shape[0] // num_splits
    scores = []
    for i in range(num_splits):
        subset = probas[i * part:(i + 1) * part]
        p_y = subset.mean(dim=0)
        kl = torch.sum(subset * (torch.log(subset + 1e-30) - torch.log(p_y + 1e-30)[None]),
                       dim=-1)
        scores.append(torch.exp(kl.mean()))
    scores = torch.stack(scores)
    return scores.mean(), scores.std(unbiased=True)


def inception_score_diff(pred_logits: Tensor, target_logits: Tensor,
                         num_splits: int = 10) -> Tensor:
    """piq's IS metric value, |IS(target) - IS(pred)| (reference
    module/piq/isc.py:59-99)."""
    return torch.abs(inception_score(target_logits, num_splits)[0]
                     - inception_score(pred_logits, num_splits)[0])


# ---------------------------------------------------------------------------
# VSI (reference module/piq/vsi.py:18-264)
# ---------------------------------------------------------------------------

_RGB2LMN = np.array([[0.06, 0.63, 0.27], [0.30, 0.04, -0.35], [0.34, -0.6, 0.17]],
                    np.float32)
_RGB2XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                     [0.2126729, 0.7151522, 0.0721750],
                     [0.0193339, 0.1191920, 0.9503041]], np.float32)
_D50_2 = np.array([0.9642119944211994, 1.0, 0.8251882845188288], np.float32)


def _mix_channels(x: Tensor, m: np.ndarray) -> Tensor:
    """NCHW: out[:, d] = sum_c m[d, c] x[:, c]."""
    return torch.einsum("nchw,dc->ndhw", x, torch.as_tensor(m, device=x.device))


def _rgb2lab(x: Tensor, data_range: float = 255.0) -> Tensor:
    """NCHW sRGB -> CIELAB, D50/2 illuminant (piq colour_conversion.py:22-87)."""
    x = x / data_range
    srgb = torch.where(x <= 0.04045, x / 12.92, torch.abs((x + 0.055) / 1.055) ** 2.4)
    tmp = _mix_channels(srgb, _RGB2XYZ) / torch.as_tensor(
        _D50_2, device=x.device).reshape(1, 3, 1, 1)
    tmp = torch.where(tmp > 0.008856, torch.sign(tmp) * tmp.abs() ** (1.0 / 3),
                      (903.3 * tmp + 16.0) / 116.0)
    w = np.array([[0, 116.0, 0], [500.0, -500.0, 0], [0, 200.0, -200.0]], np.float32)
    shift = torch.tensor([-16.0, 0.0, 0.0], device=x.device).reshape(1, 3, 1, 1)
    return _mix_channels(tmp, w) + shift


def _sample_linear(x: Tensor, rows: Tensor, cols: Tensor) -> Tensor:
    """NCHW ``x`` sampled bilinearly at the grid ``rows`` x ``cols`` (float
    pixel coordinates inside the image), ``map_coordinates(order=1)``."""
    h, w = x.shape[-2:]
    r0 = rows.floor().clamp(0, h - 1)
    c0 = cols.floor().clamp(0, w - 1)
    fr, fc = (rows - r0)[:, None], (cols - c0)[None, :]
    r0, c0 = r0.long(), c0.long()
    r1, c1 = (r0 + 1).clamp(max=h - 1), (c0 + 1).clamp(max=w - 1)
    top = x[..., r0, :][..., c0] * (1 - fc) + x[..., r0, :][..., c1] * fc
    bottom = x[..., r1, :][..., c0] * (1 - fc) + x[..., r1, :][..., c1] * fc
    return top * (1 - fr) + bottom * fr


def _resize_align_corners(x: Tensor, size) -> Tensor:
    """NCHW bilinear resize with torch ``align_corners=True`` coordinates."""
    h, w = x.shape[-2:]
    oh, ow = size
    rows = torch.arange(oh, device=x.device, dtype=torch.float32) * ((h - 1) / max(oh - 1, 1))
    cols = torch.arange(ow, device=x.device, dtype=torch.float32) * ((w - 1) / max(ow - 1, 1))
    return _sample_linear(x, rows, cols)


def _sdsp_tables(size: int, omega_0: float, sigma_f: float, sigma_d: float):
    gx, gy = _meshgrid_np(size, size)
    radius = np.sqrt(gx ** 2 + gy ** 2)
    r = _ifftshift_np(radius * (radius <= 0.5))
    r[0, 0] = 1.0
    with np.errstate(divide="ignore"):  # r = 0 outside the disc: log -> -inf, lg -> 0
        lg = np.exp(-(np.log(r / omega_0) ** 2) / (2 * sigma_f ** 2))
    lg[0, 0] = 0.0
    coords = (np.stack([gx, gy]) * size + 1).astype(np.float32)
    s_d = np.exp(-np.sum(coords ** 2, axis=0) / sigma_d ** 2).astype(np.float32)
    return lg.astype(np.float32), s_d


def _minmax(x: Tensor) -> Tensor:
    eps = np.finfo(np.float32).eps
    mn = x.amin(dim=(2, 3), keepdim=True)
    mx = x.amax(dim=(2, 3), keepdim=True)
    return (x - mn) / (mx - mn + eps)


def _sdsp(x: Tensor, omega_0=0.021, sigma_f=1.34, sigma_d=145.0, sigma_c=0.001) -> Tensor:
    """SDSP salient regions (reference vsi.py:197-239): NCHW RGB in
    [0, 255] -> (N, 1, H, W) saliency in [0, 1]."""
    n, _, h, w = x.shape
    size = 256
    xs = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                       antialias=True)
    lab = _rgb2lab(xs, data_range=255.0)
    lg, s_d = (torch.as_tensor(t, device=x.device)
               for t in _sdsp_tables(size, omega_0, sigma_f, sigma_d))
    rr = torch.fft.ifft2(torch.fft.fft2(lab) * lg).real
    s_f = torch.sqrt(torch.sum(rr ** 2, dim=1))
    norm = torch.sum(_minmax(lab)[:, 1:] ** 2, dim=1)
    s_c = 1.0 - torch.exp(-norm / sigma_c ** 2)
    vs_m = (s_f * s_d * s_c)[:, None]
    return _minmax(_resize_align_corners(vs_m, (h, w)))


def vsi(pred: Tensor, target: Tensor, data_range: float = 1.0, c1: float = 1.27,
        c2: float = 386.0, c3: float = 130.0, alpha: float = 0.4, beta: float = 0.02,
        omega_0: float = 0.021, sigma_f: float = 1.34, sigma_d: float = 145.0,
        sigma_c: float = 0.001) -> Tensor:
    """Visual Saliency-induced Index over NHWC batches (gray repeated to
    RGB, as piq does)."""
    if pred.shape[-1] == 1:
        pred = pred.expand(*pred.shape[:-1], 3)
        target = target.expand(*target.shape[:-1], 3)
    p = _nchw(pred.float() * 255.0 / data_range)
    t = _nchw(target.float() * 255.0 / data_range)
    vs_p = _sdsp(p, omega_0, sigma_f, sigma_d, sigma_c)
    vs_t = _sdsp(t, omega_0, sigma_f, sigma_d, sigma_c)
    p_lmn, t_lmn = _mix_channels(p, _RGB2LMN), _mix_channels(t, _RGB2LMN)
    ks = max(1, round(min(p.shape[2], p.shape[3]) / 256))
    if ks > 1:
        up, bp = ks // 2, (ks - 1) // 2
        pool = lambda z: _avgpool(F.pad(z, (up, bp, up, bp), mode="replicate"), ks)
        vs_p, vs_t, p_lmn, t_lmn = pool(vs_p), pool(vs_t), pool(p_lmn), pool(t_lmn)
    sim = lambda a, b, c: (2.0 * a * b + c) / (a ** 2 + b ** 2 + c)
    s_vs = sim(vs_p, vs_t, c1)
    s_gm = sim(_grad_magnitude(p_lmn[:, :1], _SCHARR), _grad_magnitude(t_lmn[:, :1], _SCHARR),
               c2)
    s_c = sim(p_lmn[:, 1:2], t_lmn[:, 1:2], c3) * sim(p_lmn[:, 2:3], t_lmn[:, 2:3], c3)
    # the real part of s_c ** beta for a possibly negative s_c
    s_c_pow = torch.abs(s_c) ** beta * torch.cos(beta * torch.atan2(torch.zeros_like(s_c), s_c))
    s = s_vs * torch.abs(s_gm) ** alpha * s_c_pow
    vs_max = torch.maximum(vs_p, vs_t)
    eps = np.finfo(np.float32).eps
    return torch.mean(((s * vs_max).sum(dim=(1, 2, 3)) + eps) / (vs_max.sum(dim=(1, 2, 3)) + eps))


# ---------------------------------------------------------------------------
# MSID (reference module/piq/msid.py, arXiv:1905.11141), host numpy
# ---------------------------------------------------------------------------

_MSID_EPS = 1e-6
_MSID_NORMALIZATION = 1e6


def _msid_knn_adjacency(x: np.ndarray, k: int) -> np.ndarray:
    """Symmetric unweighted kNN adjacency (dense): the k + 1 nearest by
    squared distance, self excluded, symmetrised (msid.py:26-37)."""
    n = len(x)
    dd = np.sum(x * x, axis=1)
    a = np.zeros((n, n), np.float64)
    for i in range(n):
        idx = np.argpartition(dd - 2 * x[i] @ x.T, k + 1)[:k + 1]
        a[i, idx[idx != i]] = 1.0
    a = (a + a.T) / 2
    a[a > 0] = 1.0
    return a


def _msid_laplacian(a: np.ndarray, normalized: bool = True) -> np.ndarray:
    deg = a.sum(axis=1)
    if not normalized:
        return np.diag(deg) - a
    inv_sqrt = 1.0 / np.sqrt(deg)
    return np.eye(len(a)) - (a * inv_sqrt[:, None]) * inv_sqrt[None, :]


def _msid_lanczos(a: np.ndarray, m: int, nv: int, rademacher: bool):
    """Block Lanczos with full reorthogonalisation over nv random starts;
    the (nv, m, m) tridiagonal matrices (msid.py:49-135). One
    ``np.random.randn(n, nv)`` draw from the global stream."""
    n = a.shape[0]
    v0 = np.random.randn(n, nv)
    if rademacher:
        v0 = np.sign(v0)
    v0 = v0 / np.linalg.norm(v0, axis=0)
    V = np.zeros((n, m, nv))
    T = np.zeros((nv, m, m))
    V[:, 0, :] = v0
    w = a @ v0
    alpha = np.einsum("ij,ij->j", w, v0)
    w = w - alpha[None, :] * v0
    beta = np.sqrt(np.einsum("ij,ij->j", w, w))
    T[:, 0, 0] = alpha
    T[:, 0, 1] = beta
    T[:, 1, 0] = beta
    V[:, 1, :] = w / beta[None, :]
    for i in range(1, m):
        v_prev, v_cur = V[:, i - 1, :], V[:, i, :]
        w = a @ v_cur - beta[None, :] * v_prev
        alpha = np.einsum("ij,ij->j", w, v_cur)
        T[:, i, i] = alpha
        if i == m - 1:
            break
        w = w - alpha[None, :] * v_cur
        w = w - np.einsum("ijk,jk->ik", V, np.einsum("ijk,ik->jk", V, w))
        beta = np.sqrt(np.einsum("ij,ij->j", w, w))
        w = w / beta[None, :]
        T[:, i, i + 1] = beta
        T[:, i + 1, i] = beta
        converged = False
        for _ in range(100):
            inner = np.einsum("ijk,ik->jk", V, w)
            if not (inner > 1e-5).sum():
                converged = True
                break
            w = w - np.einsum("ijk,jk->ik", V, inner)
            w = w / np.linalg.norm(w, axis=0)[None, :]
        V[:, i + 1, :] = w
        if (np.abs(beta) > 1e-6).sum() == 0 or not converged:
            break
    return T


def _msid_heat_traces(lap: np.ndarray, m: int, niters: int, ts: np.ndarray,
                      rademacher: bool) -> np.ndarray:
    """Variance-reduced SLQ estimate of tr(exp(-t L)) per temperature
    (msid.py:139-225)."""
    eigvals, eigvecs = np.linalg.eigh(_msid_lanczos(lap, m, niters, rademacher))
    sq_first = eigvecs[:, 0, :] ** 2
    n = lap.shape[0]
    traces = np.zeros((2, len(ts)))
    for fi, f in enumerate((np.exp, lambda z: z)):
        e = f(-np.outer(ts, eigvals)).reshape(len(ts), niters, m)
        traces[fi] = n * (e * sq_first).sum(-1).mean(-1)
    return (traces[0] - traces[1] / np.exp(ts)) - ts * n / np.exp(ts)


def msid_descriptor(x: np.ndarray, ts=None, k: int = 5, m: int = 10, niters: int = 100,
                    rademacher: bool = False, normalized_laplacian: bool = True,
                    normalize: str = "empty") -> np.ndarray:
    """Normalised heat-kernel trace descriptor of one sample set
    (msid.py:258-291)."""
    if ts is None:
        ts = np.logspace(-1, 1, 256)
    lap = _msid_laplacian(_msid_knn_adjacency(np.asarray(x, np.float64), k),
                          normalized_laplacian)
    n = lap.shape[0]
    desc = _msid_heat_traces(lap, m, niters, ts, rademacher)
    if normalize == "empty":
        desc = desc / n
    elif normalize == "complete":
        desc = desc / (1 + (n - 1) * np.exp(-(1 + 1 / (n - 1)) * ts))
    elif normalize == "er":
        xs = np.linspace(0, 1, n)
        er_spectrum = 4 / np.sqrt(k) * xs + 1 - 2 / np.sqrt(k)
        desc = desc / (np.exp(-np.outer(ts, er_spectrum)).sum(-1) + _MSID_EPS)
    elif normalize not in ("none", None):
        raise ValueError(f"unknown normalization {normalize!r}")
    return desc * _MSID_NORMALIZATION


def msid(pred_features: np.ndarray, target_features: np.ndarray, ts=None, k: int = 5,
         m: int = 10, niters: int = 100, rademacher: bool = False,
         normalized_laplacian: bool = True, normalize: str = "empty",
         msid_mode: str = "max") -> float:
    """MSID score between two feature sets (msid.py:293-397)."""
    if ts is None:
        ts = np.logspace(-1, 1, 256)
    d_p = msid_descriptor(pred_features, ts, k, m, niters, rademacher, normalized_laplacian,
                          normalize)
    d_t = msid_descriptor(target_features, ts, k, m, niters, rademacher,
                          normalized_laplacian, normalize)
    if msid_mode == "l2":
        return float(np.linalg.norm(d_p - d_t))
    if msid_mode == "max":
        return float(np.amax(np.exp(-2 * (ts + 1 / ts)) * np.abs(d_p - d_t)))
    raise ValueError("msid_mode must be 'l2' or 'max'")


# ---------------------------------------------------------------------------
# Geometry score (reference module/piq/gs.py, arXiv:1802.02664), host numpy
# ---------------------------------------------------------------------------

def _gs_rlt(intervals, alpha_max: float, i_max: int = 100) -> np.ndarray:
    """Relative living times of beta_1 from H1 persistence intervals
    (gs.py:18-63)."""
    ivals = np.array([[lo, alpha_max if np.isinf(hi) else hi] for lo, hi in intervals],
                     np.float64).reshape(-1, 2)
    rlt = np.zeros(i_max)
    if len(ivals) == 0:
        rlt[0] = 1.0
        return rlt
    points = np.sort(np.unique(np.concatenate([ivals.flatten(), [0.0, alpha_max]])))
    mids = (points[:-1] + points[1:]) / 2
    alive = ((mids[:, None] >= ivals[None, :, 0])
             & (mids[:, None] < ivals[None, :, 1])).sum(axis=1)
    for s, span in zip(alive, np.diff(points)):
        if s < i_max:
            rlt[s] += span
    return rlt / alpha_max


def _gs_witness_intervals(features: np.ndarray, sample_size: int, gamma=None):
    """H1 persistence intervals of a witness complex over random landmarks
    (gs.py:86-120). Needs gudhi."""
    try:
        import gudhi
    except ImportError as e:
        raise ImportError(
            "geometry_score needs the `gudhi` library (witness-complex persistence); "
            "the reference's module/piq/gs.py has the same hard dependency. Install "
            "gudhi to enable GS.") from e
    n = features.shape[0]
    if gamma is None:
        gamma = 1.0 / 128 * n / 5000
    landmarks = features[np.random.choice(n, sample_size)]
    d2 = np.sqrt(np.maximum(np.sum(features ** 2, 1)[:, None]
                            + np.sum(landmarks ** 2, 1)[None]
                            - 2 * features @ landmarks.T, 0.0))
    order = np.argsort(d2, axis=1)
    wc = gudhi.WitnessComplex(np.dstack([order, np.take_along_axis(d2, order, axis=1)]))
    alpha_max = float(np.max(d2)) * gamma
    st = wc.create_simplex_tree(max_alpha_square=alpha_max, limit_dimension=2)
    st.persistence(homology_coeff_field=2)
    return st.persistence_intervals_in_dimension(1), alpha_max


def geometry_score(pred_features: np.ndarray, target_features: np.ndarray,
                   sample_size: int = 64, num_iters: int = 1000, gamma=None,
                   i_max: int = 100) -> float:
    """1000 x the sum of squared differences of the mean RLTs of the two
    feature sets (gs.py:168-190)."""
    def mean_rlt(feats: np.ndarray) -> np.ndarray:
        return np.vstack([_gs_rlt(*_gs_witness_intervals(feats, sample_size, gamma), i_max)
                          for _ in range(num_iters)]).mean(axis=0)

    mp = mean_rlt(np.asarray(pred_features, np.float64))
    mt = mean_rlt(np.asarray(target_features, np.float64))
    return float(np.sum((mp - mt) ** 2) * 1000)
