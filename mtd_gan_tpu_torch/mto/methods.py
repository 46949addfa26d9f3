"""Multi-task optimisation of the stacked discriminator loss (counterpart of
the PCGrad path of ``mtd_gan_tpu/mto/methods.py``; reference
module/weight_methods.py:409-468).

* :func:`per_task_grads`: one ``torch.autograd.grad`` per task over the
  parameters (the semantics of ``per_task_grads_pruned``: a parameter a
  task's loss does not reach gets a zero gradient for that task);
* :func:`pcgrad_shared`: PCGrad in Gram / coefficient space. Each task's
  gradient is projected in turn against the ORIGINAL gradients of the
  tasks, in a random order per task; the result stays in their span, so the
  projection runs on a K x K Gram matrix and one weighted sum;
* :func:`combine_grads`: shared parameters get the PCGrad result,
  ``task`` parameters the plain sum, ``unassigned`` ones (the CLS
  ``c_fc``) no gradient at all, as in the reference.

The projection order comes from a JAX PRNG in the JAX package, which torch
cannot replay, so it is an argument here: ``(K, K)`` integer rows, one
permutation per task, drawn from a ``torch.Generator`` when not given.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

Tensor = torch.Tensor

METHODS = ("ls", "scaleinvls", "stl", "uw", "rlw", "imtl", "dwa",
           "pcgrad", "cagrad", "mgda", "nashmtl")
PORTED = ("pcgrad",)


def check_method(name: Optional[str]) -> Optional[str]:
    """``None`` / ``""`` (the plain summed backward) or a ported method."""
    if not name:
        return None
    if name not in METHODS:
        raise KeyError(f"unknown MTO method {name!r}; known: {METHODS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"MTO method {name!r} is not ported yet (ROADMAP.md queue 1, "
            f"item 12); ported: {PORTED}")
    return name


def per_task_grads(losses: Tensor, params: Sequence[Tensor]) -> List[List[Tensor]]:
    """``[task][param]`` gradients of each entry of ``losses`` (zeros where a
    task does not reach a parameter). The graph is kept for the caller."""
    out = []
    for i in range(losses.shape[0]):
        grads = torch.autograd.grad(losses[i], params, retain_graph=True,
                                    allow_unused=True)
        out.append([torch.zeros_like(p) if g is None else g
                    for p, g in zip(params, grads)])
    return out


def random_order(n_tasks: int, generator: Optional[torch.Generator] = None) -> Tensor:
    """One random permutation of the tasks per task, ``(K, K)``."""
    return torch.stack([torch.randperm(n_tasks, generator=generator)
                        for _ in range(n_tasks)])


def pcgrad_coefficients(gram: Tensor, order: Tensor) -> Tensor:
    """Task weights ``w`` such that the PCGrad-combined gradient is
    ``sum_i w_i g_i``: task i starts at ``e_i`` and, for each j in
    ``order[i]``, drops its component along ``g_j`` when the two conflict."""
    k = gram.shape[0]
    w = torch.zeros(k, dtype=gram.dtype, device=gram.device)
    for i in range(k):
        c = torch.zeros(k, dtype=gram.dtype, device=gram.device)
        c[i] = 1.0
        for j in order[i].tolist():
            dot = c @ gram[:, j]
            coef = torch.where(dot < 0, dot / (gram[j, j] + 1e-12), torch.zeros_like(dot))
            c[j] = c[j] - coef
        w = w + c
    return w


def pcgrad_shared(task_grads: List[List[Tensor]], order: Tensor) -> List[Tensor]:
    """PCGrad of per-task gradients ``[task][param]`` of the shared params."""
    k = len(task_grads)
    flat = torch.stack([torch.cat([g.reshape(-1).float() for g in gs])
                        for gs in task_grads])
    w = pcgrad_coefficients(flat @ flat.t(), order.to(flat.device))
    return [sum(w[t].to(gs[t].dtype) * gs[t] for t in range(k))
            for gs in zip(*task_grads)]


def combine_grads(method: Optional[str], task_grads: List[List[Tensor]],
                  labels: Sequence[str], order: Optional[Tensor] = None
                  ) -> List[Optional[Tensor]]:
    """One gradient per parameter (``None`` = the parameter takes no step).

    ``method=None``: the sum over tasks on every parameter (the reference's
    summed backward). ``"pcgrad"``: shared parameters get PCGrad with
    ``order``, task parameters the sum, unassigned ones ``None``."""
    summed = [sum(gs) for gs in zip(*task_grads)]
    if method is None:
        return summed
    if method != "pcgrad":
        check_method(method)
    shared = [p for p, lab in enumerate(labels) if lab == "shared"]
    projected = pcgrad_shared([[gs[p] for p in shared] for gs in task_grads], order)
    out: List[Optional[Tensor]] = [None] * len(labels)
    for p, g in zip(shared, projected):
        out[p] = g
    for p, lab in enumerate(labels):
        if lab == "task":
            out[p] = summed[p]
    return out

