"""The FFT passes on the radix steps of mtd_gan_tpu_torch/csrc/rdft_rows.cuh,
modelled in float64 numpy on the CPU: K4's row rDFT (rdft_w_kernel), its
inverse (irdft_w_kernel), which K6, K1 and K2 run, the column pass at a
power-of-two H (columns_mixed.cuh with no odd step, as K1 runs it at its
squares), K2's backward column pass
(block_bwd.cu column_bwd_kernel), K5's and K8's mixed-radix column pass
(columns_mixed.cuh) and K7 (spectral_fused.cu), which runs those row and
column steps in one cluster per sample. Each model follows the kernel's
schedule step by step (the radix plan, the radix-2 step fused with the
load, the in-place decimation-in-frequency steps and their twiddle
indices into the host table, the digit-reversed read-out, the odd step;
for the inverse the Hermitian fold and the conjugation that lets it reuse
the forward steps; for the column pass the mix in digit-reversed order
and the decimation-in-time steps back; for K2's pass the weighted load,
the mask, dmix and the transposed mix in digit-reversed order and the
scales folded into the sums and the store), so an indexing slip shows here at
1e-12 against ``np.fft``. The kernels themselves run only on the card
(tests/test_torch_cuda.py); this file imports no JAX."""

import numpy as np
import pytest
import torch

from mtd_gan_tpu_torch.ops.cuda_pipeline import rdft_twiddles
from mtd_gan_tpu_torch.ops.fft_conv import spectral_branch

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

# both lengths' odd parts (200 = 8 * 25, 449 prime), the smallest W, and
# powers of two with and without the fused first step
WIDTHS = [2, 3, 64, 200, 449, 512, 1024]
TOL = 1e-12


def _plan(w, direct=True):
    """rdft_plan(w, direct): (P, Q, direct, [(log_r, log_m), ...])."""
    log_p = 0
    while w % (2 << log_p) == 0:
        log_p += 1
    p, q = 1 << log_p, w >> log_p
    direct = direct and q == 1 and p >= 8
    steps, rest = [], log_p
    for lr in ([1] if direct else []) + [3] * ((log_p - direct) // 3):
        rest -= lr
        steps.append((lr, rest))
    if rest > 0:
        steps.append((rest, 0))
    return p, q, direct, steps


def _position(k, steps):
    """rdft_position: digit s of k (in the steps' mixed radix) at span M_s."""
    pos = 0
    for lr, lm in steps:
        pos += (k & ((1 << lr) - 1)) << lm
        k >>= lr
    return pos


def _decimated(m, p, q):
    return (m % q) * p + m // q


def _dft_step(buf, w, p, q, lr, lm, tw):
    """dif_butterfly<lr> over every butterfly of every P-point sequence:
    the R points b L + j + r M, an R-point DFT, output s times tw[j s W/L],
    written where input s was read."""
    r_, m_ = 1 << lr, 1 << lm
    g = np.arange(p // r_)
    j = g & (m_ - 1)
    p0 = ((g >> lm) << (lm + lr)) + j
    r = np.arange(r_)
    dft = np.exp(-2j * np.pi * np.outer(r, r) / r_)
    twid = tw[(j[:, None] * r[None, :] * (w // (r_ * m_))) % w]
    for qq in range(q):
        idx = qq * p + p0[:, None] + r[None, :] * m_
        buf[:, idx] = np.einsum("sr,abr->abs", dft, buf[:, idx]) * twid


def _dit_step(buf, w, lr, lm, tw):
    """dit_butterfly<lr> over every butterfly (W a power of two): the
    transpose of _dft_step, input r times tw[j r W/L] first, then the
    R-point DFT, output s written where input s was read."""
    r_, m_ = 1 << lr, 1 << lm
    g = np.arange(w // r_)
    j = g & (m_ - 1)
    p0 = ((g >> lm) << (lm + lr)) + j
    r = np.arange(r_)
    dft = np.exp(-2j * np.pi * np.outer(r, r) / r_)
    twid = tw[(j[:, None] * r[None, :] * (w // (r_ * m_))) % w]
    idx = p0[:, None] + r[None, :] * m_
    buf[:, idx] = np.einsum("sr,abr->abs", dft, buf[:, idx] * twid)


def _value(buf, m, w, p, q, steps, tw):
    """rdft_value: X[m] at its digit-reversed position, through the odd
    step for Q > 1."""
    pm = _position(m % p, steps)
    acc = buf[:, pm].copy()
    for qq in range(1, q):
        acc += tw[(qq * m) % w] * buf[:, qq * p + pm]
    return acc


def _k4_model(x, tw, direct=True):
    """rdft_w_kernel on real rows x (2 * pairs, W) -> (A, B) half spectra,
    each (pairs, K); ``direct=False``: the plan without the radix-2 step
    fused with the load, as K7's row phase runs it."""
    w = x.shape[1]
    p, q, direct, steps = _plan(w, direct)
    z = x[0::2] + 1j * x[1::2]
    buf = np.empty_like(z)
    if direct:
        # step 0 from the rows themselves: columns c and c + W/2
        half = w // 2
        c = np.arange(half)
        v0, v1 = z[:, c], z[:, c + half]
        buf[:, c], buf[:, c + half] = v0 + v1, (v0 - v1) * tw[c]
    else:
        buf[:, [_decimated(m, p, q) for m in range(w)]] = z
    for lr, lm in steps[int(direct):]:
        _dft_step(buf, w, p, q, lr, lm, tw)
    k = np.arange(w // 2 + 1)
    zk = np.stack([_value(buf, m, w, p, q, steps, tw) for m in k], 1)
    zc = np.stack([_value(buf, (w - m) % w, w, p, q, steps, tw) for m in k], 1)
    scale = 1 / np.sqrt(w)
    return (zk + np.conj(zc)) / 2 * scale, (zk - np.conj(zc)) / 2j * scale


def _k6_model(a, b, tw, direct=True):
    """irdft_w_kernel on the half spectra a, b (pairs, K) of rows 2j and
    2j + 1 -> the real rows (2 * pairs, W), without the residual;
    ``direct=False`` as K7's inverse row phase runs it."""
    w = tw.shape[0]
    p, q, direct, steps = _plan(w, direct)
    edge = [0] + ([w // 2] if w % 2 == 0 else [])
    a, b = a.copy(), b.copy()
    a[:, edge], b[:, edge] = a[:, edge].real, b[:, edge].real
    conj_zk = lambda k: np.conj(a[:, k] + 1j * b[:, k])                    # conj Z[k]
    conj_zwk = lambda k: np.conj(np.conj(a[:, k]) + 1j * np.conj(b[:, k]))  # conj Z[W - k]
    buf = np.empty((a.shape[0], w), complex)
    if direct:
        # step 0 fused with the load: unit k takes the bins k and W/2 - k
        half = w // 2
        for k in range(w // 4 + 1):
            k2 = half - k
            v0, v1 = conj_zk(k), conj_zwk(k2)
            buf[:, k], buf[:, k + half] = v0 + v1, (v0 - v1) * tw[k]
            if k not in (0, k2):
                v0, v1 = conj_zk(k2), conj_zwk(k)
                buf[:, k2], buf[:, k2 + half] = v0 + v1, (v0 - v1) * tw[k2]
    else:
        for k in range(w // 2 + 1):
            buf[:, _decimated(k, p, q)] = conj_zk(k)
            if k not in edge:
                buf[:, _decimated(w - k, p, q)] = conj_zwk(k)
    for lr, lm in steps[int(direct):]:
        _dft_step(buf, w, p, q, lr, lm, tw)
    y = np.stack([_value(buf, m, w, p, q, steps, tw) for m in range(w)], 1)
    out = np.empty((2 * a.shape[0], w))
    out[0::2], out[1::2] = y.real / np.sqrt(w), -y.imag / np.sqrt(w)
    return out


def _table(w):
    """The host table as the kernels read it, widened back to complex128."""
    return rdft_twiddles(w).numpy().astype(np.complex128)


@pytest.mark.parametrize("w", WIDTHS)
def test_k6_inverse_twiddles_are_the_conjugate_table(w):
    """The inverse reads K4's table: its twiddles exp(+2 pi i t / W) are
    the table's conjugates, within 1e-7 of numpy (one complex64 rounding),
    so K6 needs no second table or cache."""
    want = np.exp(2j * np.pi * np.arange(w) / w)
    assert np.abs(np.conj(_table(w)) - want).max() <= 1e-7


@pytest.mark.parametrize("w", WIDTHS)
def test_k4_row_schedule_matches_rfft(w):
    """K4's schedule in float64 (its table widened) equals np.fft.rfft of
    each row, ortho: 4 row pairs, the fused first step for W = 64, 512 and
    1024, staged loads and the odd step for 3, 200 and 449."""
    rng = np.random.default_rng(w)
    x = rng.standard_normal((8, w))
    tw = np.exp(-2j * np.pi * np.arange(w) / w)
    a, b = _k4_model(x, tw)
    want = np.fft.rfft(x, axis=1, norm="ortho")
    assert np.abs(a - want[0::2]).max() <= TOL
    assert np.abs(b - want[1::2]).max() <= TOL


@pytest.mark.parametrize("w", WIDTHS)
def test_k6_row_schedule_matches_irfft(w):
    """K6's schedule in float64 equals np.fft.irfft (ortho) of each row's
    half spectrum with the imaginary parts of the bins 0 and, for even W,
    W/2 zeroed: the Hermitian fold, the conjugation, the forward steps and
    their digit-reversed order, the odd step. The spectra are not
    Hermitian at the edges, as K5's output is not."""
    rng = np.random.default_rng(100 + w)
    k = w // 2 + 1
    a, b = (rng.standard_normal((4, k)) + 1j * rng.standard_normal((4, k)) for _ in range(2))
    tw = np.exp(-2j * np.pi * np.arange(w) / w)
    got = _k6_model(a, b, tw)
    spec = np.empty((8, k), complex)
    spec[0::2], spec[1::2] = a, b
    spec[:, 0] = spec[:, 0].real
    if w % 2 == 0:
        spec[:, -1] = spec[:, -1].real
    want = np.fft.irfft(spec, n=w, axis=1, norm="ortho")
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("w", [64, 200, 1024])
def test_k6_row_schedule_inverts_k4_on_the_fp32_table(w):
    """K4 then K6 on the table as the kernels read it (complex64, widened):
    the rows come back within fp32 rounding of the table (5e-6 absolute on
    unit-variance rows); the kernels run fp32 throughout, so this is the
    size of error the table alone brings."""
    rng = np.random.default_rng(w)
    x = rng.standard_normal((8, w))
    tw = _table(w)
    back = _k6_model(*_k4_model(x, tw), tw)
    assert np.abs(back - x).max() <= 5e-6


def _column_model(z, mix, mb, tw):
    """The column pass at a power-of-two H (columns_mixed.cuh with no odd
    step: K1's at its squares) on the columns z (C, H) of one bin: the forward DIF steps leave X in digit-reversed order; the
    mix is pointwise in h, so it runs there; it writes conj of its output,
    the DIT steps in reverse order bring that back to natural order, and
    the store takes conj again: the inverse FFT, with no permutation."""
    c, h = z.shape
    _, _, _, steps = _plan(h, direct=False)
    buf = z.copy()
    for lr, lm in steps:
        _dft_step(buf, h, h, 1, lr, lm, tw)
    scale = 1 / np.sqrt(h)
    v = np.concatenate([buf.real, buf.imag]) * scale
    o = np.maximum(mix @ v + mb[:, None], 0)
    buf = o[:c] - 1j * o[c:]
    for lr, lm in reversed(steps):
        _dit_step(buf, h, lr, lm, tw)
    return np.conj(buf) * scale


@pytest.mark.parametrize("h", [2, 8, 64, 128, 256, 512])
def test_k1_column_schedule_matches_fft(h):
    """K1's column pass in float64 equals the plain one: the ortho FFT
    along H, relu(mix [Re; Im] + bias), the ortho inverse FFT (as
    cuda_staged.spectral_mix_h_reference computes it), at 4 channels."""
    rng = np.random.default_rng(h)
    c = 4
    z = rng.standard_normal((c, h)) + 1j * rng.standard_normal((c, h))
    mix = rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)
    mb = rng.standard_normal(2 * c) * 0.1
    tw = np.exp(-2j * np.pi * np.arange(h) / h)
    zf = np.fft.fft(z, axis=1, norm="ortho")
    o = np.maximum(mix @ np.concatenate([zf.real, zf.imag]) + mb[:, None], 0)
    want = np.fft.ifft(o[:c] + 1j * o[c:], axis=1, norm="ortho")
    assert np.abs(_column_model(z, mix, mb, tw) - want).max() <= TOL


def _k2_column_model(a, b, edge, mix, mb, tw):
    """K2's backward column pass (column_bwd_kernel) on one bin: a (C, H)
    the row spectrum of hin, b (C, H) that of g. b is weighted c_k (2
    inside, 1 at the bins 0 and W/2 with its imaginary part zeroed), both
    go through the DIF steps and stay in digit-reversed order, unscaled;
    the mask is that of K1's mix at each position; dmix and dmb are summed
    there with the scales folded in; the transposed mix is written
    conjugated, the DIT steps bring it back to natural order, and the store
    conjugates and scales by scale^2 / c_k. Returns (the new b, dmix, dmb)."""
    c, h = a.shape
    _, _, _, steps = _plan(h, direct=False)
    wk = 1.0 if edge else 2.0
    buf = np.concatenate([a, (b.real + 1j * (0.0 if edge else 1.0) * b.imag) * wk])
    for lr, lm in steps:
        _dft_step(buf, h, h, 1, lr, lm, tw)
    scale = 1 / np.sqrt(h)
    s_in = np.concatenate([buf[:c].real, buf[:c].imag])           # / scale
    s_pre = mix @ (s_in * scale) + mb[:, None]
    sbar = np.concatenate([buf[c:].real, buf[c:].imag]) * (s_pre > 0)  # / scale
    dmix = sbar @ s_in.T * scale ** 2
    dmb = sbar.sum(1) * scale
    t = mix.T @ sbar
    back = t[:c] - 1j * t[c:]
    for lr, lm in reversed(steps):
        _dit_step(back, h, lr, lm, tw)
    return np.conj(back) * scale ** 2 / wk, dmix, dmb


def _k2_spectral_model(hin, g, mix, mb, tw, column=_k2_column_model):
    """K2's spectral path on one sample (C, H, W), H == W: K4's rows of hin
    and of g, the backward column pass bin by bin (``column``: one CTA a
    bin, or _k2_column_split_model's cluster), K6's rows of the result (the
    adjoint of the forward rFFT). Returns (hbar's spectral part, dmix,
    dmb)."""
    c, h, w = hin.shape
    k = w // 2 + 1
    rows = lambda x: np.stack(_k4_model(x.reshape(-1, w), tw), 1)  # (C H / 2, 2, K)
    spec = lambda x: rows(x).reshape(c, h, k).transpose(0, 2, 1)   # (C, K, H)
    sa, sg = spec(hin), spec(g)
    back = np.empty_like(sg)
    dmix, dmb = 0.0, 0.0
    for kk in range(k):
        back[:, kk], dm, db = column(sa[:, kk], sg[:, kk], kk in (0, k - 1), mix, mb, tw)
        dmix, dmb = dmix + dm, dmb + db
    pairs = back.transpose(0, 2, 1).reshape(c * h // 2, 2, k)
    return _k6_model(pairs[:, 0], pairs[:, 1], tw).reshape(c, h, w), dmix, dmb


@pytest.mark.parametrize("c", [4, 8])
@pytest.mark.parametrize("h", [16, 64])
def test_k2_column_schedule_matches_autograd(h, c):
    """K2's spectral adjoint on K4's, K6's and its own column schedule, in
    float64, equals autograd through the plain spectral branch (the
    gradients of hin, mix and the mix bias for the cotangent g) to 1e-12."""
    rng = np.random.default_rng(h + c)
    hin, g = rng.standard_normal((2, c, h, h))
    mix = rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)
    mb = rng.standard_normal(2 * c) * 0.1
    tw = np.exp(-2j * np.pi * np.arange(h) / h)
    leaves = [torch.tensor(v, requires_grad=True) for v in (hin[None], mix, mb)]
    want = torch.autograd.grad(spectral_branch(*leaves), leaves, torch.tensor(g[None]))
    got = _k2_spectral_model(hin, g, mix, mb, tw)
    for a, b in zip(got, (want[0][0], want[1], want[2])):
        assert np.abs(a - b.numpy()).max() <= TOL


# positions a CTA of column_bwd_cluster_kernel stages at a time (kBwdChunk
# in csrc/block_bwd.cu)
K2_CHUNK = 64


def _k2_column_split_model(a, b, edge, mix, mb, tw, s=2):
    """column_bwd_cluster_kernel on one bin, on a cluster of S CTAs: CTA r
    holds the channels [r C/S, (r + 1) C/S) of a and b (weighted as in
    _k2_column_model) and runs their DIF steps; between the two cluster
    syncs it takes the digit-reversed positions [r H/S, (r + 1) H/S),
    K2_CHUNK at a time: it stages all 2C channels of both spectra there
    from every CTA, masks b by K1's mix of the staged a, adds its partials
    of dmix and dmb, and writes conj(mix^T b) into the owners' a; after the
    second sync each CTA runs its channels' DIT steps and its store. The
    per-CTA partials are summed. Returns (the new b, dmix, dmb)."""
    c, h = a.shape
    cl = c // s
    _, _, _, steps = _plan(h, direct=False)
    wk = 1.0 if edge else 2.0
    scale = 1 / np.sqrt(h)
    ctas = []
    for r in range(s):
        own = slice(r * cl, (r + 1) * cl)
        gb = (b[own].real + 1j * (0.0 if edge else 1.0) * b[own].imag) * wk
        buf = np.concatenate([a[own], gb])  # this CTA's a rows, then its b rows
        for lr, lm in steps:
            _dft_step(buf, h, h, 1, lr, lm, tw)
        ctas.append(buf)
    parts = []
    for r in range(s):
        dmix, dmb = np.zeros((2 * c, 2 * c)), np.zeros(2 * c)
        for p0 in range(r * h // s, (r + 1) * h // s, K2_CHUNK):
            pos = np.arange(p0, p0 + K2_CHUNK)
            za = np.concatenate([cta[:cl, pos] for cta in ctas])
            zb = np.concatenate([cta[cl:, pos] for cta in ctas])
            va, vb = np.concatenate([za.real, za.imag]), np.concatenate([zb.real, zb.imag])
            vb = vb * (mix @ (va * scale) + mb[:, None] > 0)
            dmix += vb @ va.T
            dmb += vb.sum(1)
            t = mix.T @ vb
            for q, cta in enumerate(ctas):
                cta[:cl, pos] = t[q * cl:(q + 1) * cl] - 1j * t[c + q * cl:c + (q + 1) * cl]
        parts.append((dmix * scale ** 2, dmb * scale))
    back = []
    for cta in ctas:
        own = cta[:cl].copy()
        for lr, lm in reversed(steps):
            _dit_step(own, h, lr, lm, tw)
        back.append(np.conj(own) * scale ** 2 / wk)
    return np.concatenate(back), sum(p[0] for p in parts), sum(p[1] for p in parts)


@pytest.mark.parametrize("h,s", [(256, 2), (512, 2), (512, 4)])
def test_k2_column_split_schedule_matches_autograd(h, s):
    """K2's spectral adjoint with the column pass on a cluster of S CTAs per
    bin (column_bwd_cluster_kernel's split: channels for the FFTs, position
    shares staged K2_CHUNK at a time for the mask, dmix and mix^T), in
    float64 on one sample, equals autograd through the plain spectral
    branch to 1e-12 of each gradient's largest element (sums over 128 x
    257 positions at 512^2)."""
    c = 4
    rng = np.random.default_rng(h + s)
    hin, g = rng.standard_normal((2, c, h, h))
    mix = rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)
    mb = rng.standard_normal(2 * c) * 0.1
    tw = np.exp(-2j * np.pi * np.arange(h) / h)
    leaves = [torch.tensor(v, requires_grad=True) for v in (hin[None], mix, mb)]
    want = torch.autograd.grad(spectral_branch(*leaves), leaves, torch.tensor(g[None]))
    split = lambda *args: _k2_column_split_model(*args, s=s)
    got = _k2_spectral_model(hin, g, mix, mb, tw, column=split)
    for a, b in zip(got, (want[0][0], want[1], want[2])):
        assert np.abs(a - b.numpy()).max() <= TOL * np.abs(b.numpy()).max()


# columns_mixed.cuh odd_branch: the odd step runs in place in registers as a
# dense DFT for Q <= 11 and as two radix-5 steps for Q = 25; any other Q
# runs out of place
MAX_ODD_DENSE = 11


def _dit_step_mixed(buf, h, p, q, lr, lm, tw):
    """dit_butterfly<lr> over every butterfly of every P-point sequence
    (rdft_steps<true> with Q > 1): the transpose of _dft_step, input r
    times tw[j r H/L] first, then the R-point DFT."""
    r_, m_ = 1 << lr, 1 << lm
    g = np.arange(p // r_)
    j = g & (m_ - 1)
    p0 = ((g >> lm) << (lm + lr)) + j
    r = np.arange(r_)
    dft = np.exp(-2j * np.pi * np.outer(r, r) / r_)
    twid = tw[(j[:, None] * r[None, :] * (h // (r_ * m_))) % h]
    for qq in range(q):
        idx = qq * p + p0[:, None] + r[None, :] * m_
        buf[:, idx] = np.einsum("sr,abr->abs", dft, buf[:, idx] * twid)


def _dft_5x5(v, tw, p):
    """odd_25's DFT on v (C, 25, P): with n = 5 a + b and s = ka + 5 kb,
    five 5-point DFTs over a, the twist tw[b ka P], five 5-point DFTs over
    b on w_5^j = tw[5 j P]. Returns the outputs (C, 25, P), index s."""
    j = np.arange(5)
    w5 = tw[(np.outer(j, j) % 5) * 5 * p]                    # [k, a]
    x = v.reshape(v.shape[0], 5, 5, -1)                      # [c, a, b, k1]
    z = np.einsum("ia,cabz->cbiz", w5, x)                     # [c, b, ka, k1]
    z = z * tw[np.outer(j, j) * p][None, :, :, None]         # w_25^(b ka)
    out = np.einsum("lb,cbiz->cilz", w5, z)                   # [c, ka, kb, k1]
    return out.transpose(0, 2, 1, 3).reshape(v.shape)         # s = ka + 5 kb


def _odd_registers(buf, h, p, q, steps, tw, transpose):
    """odd_in_place<transpose> on every (channel, k1): the Q values at
    q P + pos(k1); forward, each twisted by tw[q k1], then the Q-point DFT
    (dense on tw[t P] for Q <= 11, _dft_5x5 for 25), output s written at
    s P + pos(k1); transposed, the DFT first and output s twisted by
    tw[s k1]. The twiddle indices stay below H, so no index wraps."""
    k1, qs = np.arange(p), np.arange(q)
    pk = np.array([_position(k, steps) for k in k1])
    idx = qs[:, None] * p + pk[None, :]                     # (Q, P) positions
    twist = tw[qs[:, None] * k1[None, :]]
    v = buf[:, idx]
    if not transpose:
        v = v * twist
    if q == 25:
        out = _dft_5x5(v, tw, p)
    else:
        assert q <= MAX_ODD_DENSE
        out = np.einsum("sq,cqk->csk", tw[(np.outer(qs, qs) % q) * p], v)
    buf[:, idx] = out * twist if transpose else out


def _odd_two_buffers(buf, h, p, q, steps, tw):
    """The forward odd step out of place (rdft_value<true> for every m):
    nat[m] = sum_q tw[q m mod H] buf[q P + pos(m mod P)], natural order."""
    m, qs = np.arange(h), np.arange(q)
    pm = np.array([_position(k, steps) for k in range(p)])[m % p]
    idx = qs[:, None] * p + pm[None, :]
    return np.einsum("qm,cqm->cm", tw[(np.outer(qs, m)) % h], buf[:, idx])


def _odd_two_buffers_transposed(nat, h, p, q, steps, tw):
    """odd_transposed_value for every (q, k1): sum_k2 tw[q (k1 + P k2) mod
    H] nat[k1 + P k2], written at q P + pos(k1)."""
    k1, qs = np.arange(p), np.arange(q)
    pk = np.array([_position(k, steps) for k in k1])
    twid = tw[(qs[:, None, None] * (k1[None, :, None] + p * qs[None, None, :])) % h]
    by = nat.reshape(nat.shape[0], q, p)                     # [c, k2, k1]
    out = np.einsum("qkt,ctk->cqk", twid, by)
    buf = np.empty_like(nat)
    buf[:, qs[:, None] * p + pk[None, :]] = out
    return buf


def _mixed_column_model(z, mix, mb, tw, s):
    """columns_mixed_kernel on the columns z (C, H) of one bin, on a
    cluster of S CTAs, each holding C/S channels: the load in decimated
    order, the P-point DIF steps, the odd step (in registers for Q <= 11
    and Q = 25, else out of place), then the mix by position (CTA r takes the positions
    [r H / S, (r + 1) H / S) of every CTA's channels and writes conj of its
    outputs back there), the odd step transposed, the DIT steps in reverse
    order, and the store from the decimated positions, conjugated."""
    c, h = z.shape
    p, q, _, steps = _plan(h, direct=False)
    two = q > MAX_ODD_DENSE and q != 25
    dec = np.array([_decimated(m, p, q) for m in range(h)])
    ctas = []
    for r in range(s):
        buf = np.empty((c // s, h), complex)
        buf[:, dec] = z[r * c // s:(r + 1) * c // s]
        for lr, lm in steps:
            _dft_step(buf, h, p, q, lr, lm, tw)
        if two:
            buf = _odd_two_buffers(buf, h, p, q, steps, tw)
        elif q > 1:
            _odd_registers(buf, h, p, q, steps, tw, transpose=False)
        ctas.append(buf)
    scale = 1 / np.sqrt(h)
    owner = np.full(h, -1)
    for r in range(s):
        lo, hi = r * h // s, (r + 1) * h // s
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = r
        x = np.concatenate([b[:, lo:hi] for b in ctas])
        o = np.maximum(mix @ np.concatenate([x.real, x.imag]) * scale + mb[:, None], 0)
        y = o[:c] - 1j * o[c:]
        for rr, b in enumerate(ctas):
            b[:, lo:hi] = y[rr * c // s:(rr + 1) * c // s]
    assert (owner >= 0).all()
    out = []
    for buf in ctas:
        if two:
            buf = _odd_two_buffers_transposed(buf, h, p, q, steps, tw)
        elif q > 1:
            _odd_registers(buf, h, p, q, steps, tw, transpose=True)
        for lr, lm in reversed(steps):
            _dit_step_mixed(buf, h, p, q, lr, lm, tw)
        out.append(np.conj(buf[:, dec]) * scale)
    return np.concatenate(out)


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("h", [2, 3, 64, 200, 448, 449, 768, 800, 1024, 130, 120, 1000])
def test_k5_k8_column_schedule_matches_fft(h, s):
    """K5's and K8's column pass (columns_mixed.cuh) in float64 equals the
    plain one: the ortho FFT along H, relu(mix [Re; Im] + bias), the ortho
    inverse FFT, at 8 channels on a cluster of 1, 2 or 4 CTAs. H covers
    both branches of the odd step (registers: 448 = 64 * 7 and 768 = 256 *
    3 dense, 200 and 800 = 8, 32 * 25 as 5 x 5; two buffers: 449, prime,
    130 = 2 * 65, 120 = 8 * 15, 1000 = 8 * 125), no odd step (2, 64,
    1024) and the smallest odd H (3 = 1 * 3, dense)."""
    rng = np.random.default_rng(h + s)
    c = 8
    z = rng.standard_normal((c, h)) + 1j * rng.standard_normal((c, h))
    mix = rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)
    mb = rng.standard_normal(2 * c) * 0.1
    tw = np.exp(-2j * np.pi * np.arange(h) / h)
    zf = np.fft.fft(z, axis=1, norm="ortho")
    o = np.maximum(mix @ np.concatenate([zf.real, zf.imag]) + mb[:, None], 0)
    want = np.fft.ifft(o[:c] + 1j * o[c:], axis=1, norm="ortho")
    assert np.abs(_mixed_column_model(z, mix, mb, tw, s) - want).max() <= TOL


# spectral_fused.cu: CTAs per sample (the cluster), the bins a CTA owns
K7_CLUSTER = 8


def _k7_owned(w):
    """The bins k = r + 8 b of each CTA r (b < its count) and the largest
    count, which sizes a CTA's share of the scratch."""
    k = w // 2 + 1
    owned = [list(range(r, k, K7_CLUSTER)) for r in range(K7_CLUSTER)]
    return owned, -(-k // K7_CLUSTER)


def _k7_pairs(c, h):
    """The row pairs (2p, 2p + 1 of the flat c H + h) of each CTA."""
    pairs = c * h // 2
    per = -(-pairs // K7_CLUSTER)
    return [range(min(pairs, r * per), min(pairs, (r + 1) * per)) for r in range(K7_CLUSTER)]


def _k7_model(x, mix, mb, tw_w, tw_h, residual=None, group=None):
    """spectral_fused_kernel on one sample x (C, H, W), step by step: CTA r
    takes its eighth of the row pairs (_k7_pairs) through K4's row steps
    (no fused first step) and stores bin k of each row,
    natural order, into the bin block of CTA k % 8 at slot k / 8; each CTA
    moves its bins into the column pass's decimated order, runs all of them
    (or ``group`` at a time, as in scratch mode; one at a time where the odd
    step takes two buffers) through the DIF steps, the odd step, the mix,
    the transposed odd step and the DIT steps together, and moves them
    back, unscaled and conjugated; then each CTA gathers
    its rows' bins and runs K6's inverse steps on them, the scales of H and
    W applied in the store with the residual."""
    c, h, w = x.shape
    k = w // 2 + 1
    owned, _ = _k7_owned(w)
    ph, qh, _, steps_h = _plan(h, direct=False)
    two = qh > MAX_ODD_DENSE and qh != 25
    dec = np.array([_decimated(m, ph, qh) for m in range(h)])
    blocks = {kk: np.empty((c, h), complex) for kk in range(k)}  # natural order
    flat = x.reshape(c * h, w)
    spans = [sp for sp in _k7_pairs(c, h) if len(sp)]
    for sp in spans:
        a, b = _k4_model(flat[2 * sp.start:2 * sp.stop], tw_w, direct=False)
        for kk in range(k):
            rows = blocks[kk].reshape(-1)
            rows[2 * sp.start:2 * sp.stop:2], rows[2 * sp.start + 1:2 * sp.stop:2] = a[:, kk], b[:, kk]
    scale_h = 1 / np.sqrt(h)
    for r in range(K7_CLUSTER):
        mine = owned[r]
        step = 1 if two else group or max(1, len(mine))
        for g0 in range(0, len(mine), step):
            ks = mine[g0:g0 + step]
            buf = np.empty((len(ks) * c, h), complex)
            for i, kk in enumerate(ks):
                buf[i * c:(i + 1) * c, dec] = blocks[kk]
            for lr, lm in steps_h:
                _dft_step(buf, h, ph, qh, lr, lm, tw_h)
            if two:
                buf = _odd_two_buffers(buf, h, ph, qh, steps_h, tw_h)
            elif qh > 1:
                _odd_registers(buf, h, ph, qh, steps_h, tw_h, transpose=False)
            for i in range(len(ks)):
                v = buf[i * c:(i + 1) * c]
                o = np.maximum(mix @ np.concatenate([v.real, v.imag]) * scale_h + mb[:, None], 0)
                buf[i * c:(i + 1) * c] = o[:c] - 1j * o[c:]
            if two:
                buf = _odd_two_buffers_transposed(buf, h, ph, qh, steps_h, tw_h)
            elif qh > 1:
                _odd_registers(buf, h, ph, qh, steps_h, tw_h, transpose=True)
            for lr, lm in reversed(steps_h):
                _dit_step_mixed(buf, h, ph, qh, lr, lm, tw_h)
            for i, kk in enumerate(ks):
                blocks[kk] = buf[i * c:(i + 1) * c, dec]
    out = np.empty_like(flat)
    for sp in spans:
        spec = np.stack([np.conj(blocks[kk].reshape(-1)[2 * sp.start:2 * sp.stop])
                         for kk in range(k)], 1) * scale_h     # (rows, K)
        out[2 * sp.start:2 * sp.stop] = _k6_model(spec[0::2], spec[1::2], tw_w, direct=False)
    out = out.reshape(c, h, w)
    return out if residual is None else residual + out


def _plain_branch(x, mix, mb):
    """irfft2(relu(mix [Re; Im] rfft2 x + mb)) in float64 numpy, ortho,
    the imaginary parts of the W bins 0 and W/2 dropped before the c2r (as
    fft_conv.spectral_branch)."""
    c, h, w = x.shape
    xf = np.fft.rfft2(x, norm="ortho")
    o = np.einsum("oi,ihk->ohk", mix, np.concatenate([xf.real, xf.imag])) + mb[:, None, None]
    o = np.maximum(o, 0)
    z = np.fft.ifft(o[:c] + 1j * o[c:], axis=1, norm="ortho")
    z[:, :, 0] = z[:, :, 0].real
    if w % 2 == 0:
        z[:, :, -1] = z[:, :, -1].real
    return np.fft.irfft(z, n=w, axis=2, norm="ortho")


@pytest.mark.parametrize("w", [2, 27, 72, 96, 127, 128])
def test_k7_every_bin_has_one_owner(w):
    """K7's ownership at its cluster of 8: every bin k <= W/2 has exactly
    one owner, CTA k % 8 at slot k / 8; no CTA owns more than the
    largest count, and the scratch places (r, slot) are distinct; every
    row pair of C in {8, 16, 32} belongs to exactly one CTA, C / 8 whole
    channels each for even H."""
    k = w // 2 + 1
    owned, most = _k7_owned(w)
    seen = {}
    for r, ks in enumerate(owned):
        assert len(ks) <= most
        for b, kk in enumerate(ks):
            assert kk not in seen and kk % K7_CLUSTER == r and kk // K7_CLUSTER == b
            seen[kk] = r * most + b
    assert sorted(seen) == list(range(k))
    assert len(set(seen.values())) == k and max(seen.values()) < K7_CLUSTER * most
    for c in (8, 16, 32):
        for h in (2, 33, 96):
            spans = _k7_pairs(c, h)
            assert sorted(p for sp in spans for p in sp) == list(range(c * h // 2))
            if h % 2 == 0:
                assert all(len(sp) == c // K7_CLUSTER * h // 2 for sp in spans)


@pytest.mark.parametrize("h,w,group", [(96, 96, None), (100, 72, None), (33, 27, None),
                                       (97, 66, None), (66, 20, None), (128, 128, 2),
                                       (2, 2, None), (24, 40, 3)])
def test_k7_schedule_matches_rfft2(h, w, group):
    """K7's schedule in float64 equals the plain spectral branch plus the
    residual (np.fft.rfft2, the mix, the inverse), at C = 8: H with the odd
    step in registers (96 = 32 * 3, 100 = 4 * 25, 24 = 8 * 3), in two
    buffers (33, 97 and 66 = 2 * 33, which needs the reorder), none (128,
    2); W with an odd part (27, 72 = 8 * 9, 66, 20) or none; all owned bins
    at once, or 2 and 3 at a time as in scratch mode."""
    rng = np.random.default_rng(h * w)
    c = 8
    x = rng.standard_normal((c, h, w))
    res = rng.standard_normal((c, h, w))
    mix = rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)
    mb = rng.standard_normal(2 * c) * 0.1
    tw_w, tw_h = (np.exp(-2j * np.pi * np.arange(n) / n) for n in (w, h))
    got = _k7_model(x, mix, mb, tw_w, tw_h, residual=res, group=group)
    assert np.abs(got - (res + _plain_branch(x, mix, mb))).max() <= TOL
