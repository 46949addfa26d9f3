"""Helpers of the CPU tests of K3's bf16 operand path
(``mtd_gan_tpu_torch/csrc/conv3x3_tc.cuh``): B as the kernel stages it and
the k16 steps of its products emulated in float32. No tests here, and no
JAX: ``tests/test_torch_bf16_kernels.py`` holds the arithmetic against
float64, ``tests/test_torch_tc_bf16_tile.py`` the tile and fragment maps
against these steps."""

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to bf16 to nearest even (``__float2bfloat16_rn``),
    widened back to float32."""
    return a.to(BF16).float()


def _staged_b(weight: torch.Tensor, c_in: int, adjoint: bool) -> torch.Tensor:
    """B as conv3x3_tc_kernel stages it on its bf16 path: B[k, co] (k = tap
    * C_in + ci), rounded to bf16, at (((k >> 3) * NT + (co >> 3)) * 8 +
    (co & 7)) * 8 + (k & 7), KB = 16 * S16 rows, the rows past 9 C_in zero.
    ``weight``: (C_out, C_in, 3, 3), or with ``adjoint`` the transposed
    conv's (C_in, C_out, 3, 3)."""
    co = weight.shape[1] if adjoint else weight.shape[0]
    nt, k_real = co // 8, 9 * c_in
    kb = 16 * ((9 * (c_in // 8) + 1) // 2)
    k = torch.arange(kb)[:, None]
    c = torch.arange(co)[None, :]
    tap, ci = (k % k_real) // c_in, (k % k_real) % c_in
    w = (weight[ci, c, 2 - tap // 3, 2 - tap % 3] if adjoint
         else weight[c, ci, tap // 3, tap % 3])
    w = torch.where(k < k_real, _bf16(w), torch.zeros(()))
    flat = torch.zeros(kb * co)
    flat[((((k >> 3) * nt + (c >> 3)) * 8 + (c & 7)) * 8 + (k & 7)).reshape(-1)] = w.reshape(-1)
    return flat


def _bf16_tc_steps(x: torch.Tensor, weight: torch.Tensor, adjoint: bool):
    """The bf16 operand path's k16 steps: for each step s, (A, B) with B
    the 16 rows read through the step's descriptor (start 2 s NT 64
    elements, 8-k groups NT * 64 apart, 8-channel groups 64 apart) and A
    (N, H, W, 16) the input at the (tap, channel) of the step's groups 2 s
    and 2 s + 1 (a zero group past 9 C_in), both bf16 values in float32."""
    n, c_in, h, w = x.shape
    ci8 = c_in // 8
    co = weight.shape[1] if adjoint else weight.shape[0]
    nt = co // 8
    b16 = _staged_b(weight, c_in, adjoint)
    xp = F.pad(_bf16(x), (1, 1, 1, 1))
    col = torch.arange(co)
    steps = []
    for s in range((9 * ci8 + 1) // 2):
        a_cols, b_rows = [], []
        for hh in range(2):
            kg = 2 * s + hh
            kk = torch.arange(8)
            at = 2 * s * nt * 64 + hh * nt * 64 + (col[None] >> 3) * 64 + (col[None] & 7) * 8
            b_rows.append(b16[at + kk[:, None]])
            if kg < 9 * ci8:
                tap, kc = divmod(kg, ci8)
                dy, dx = divmod(tap, 3)
                a_cols.append(xp[:, kc * 8:kc * 8 + 8, dy:dy + h, dx:dx + w].permute(0, 2, 3, 1))
            else:
                a_cols.append(torch.zeros(n, h, w, 8))
        steps.append((torch.cat(a_cols, -1), torch.cat(b_rows, 0)))
    return steps


def _tc_sum(steps) -> torch.Tensor:
    """One product a step, the steps summed in float32: (N, C_out, H, W)."""
    acc = 0
    for a, b in steps:
        acc = acc + a @ b
    return acc.permute(0, 3, 1, 2)


def _bf16_tc_conv(x: torch.Tensor, weight: torch.Tensor, adjoint: bool) -> torch.Tensor:
    """The bf16 operand path in float32: bf16 operands, one product a k16
    step (``_bf16_tc_steps``) and the steps summed in float32."""
    return _tc_sum(_bf16_tc_steps(x, weight, adjoint))
