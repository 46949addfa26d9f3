"""Multi-task optimisation of the stacked discriminator loss: the eleven
methods of ``mtd_gan_tpu/mto/methods.py`` (reference
module/weight_methods.py) on the port's ``[task][param]`` gradient lists.

* :func:`per_task_grads`: one ``torch.autograd.grad`` per task over the
  parameters (the semantics of ``per_task_grads_pruned``: a parameter a
  task's loss does not reach gets a zero gradient for that task);
* weighting methods (``ls``, ``scaleinvls``, ``stl``, ``uw``, ``rlw``,
  ``imtl``, ``dwa``, ``mgda``, ``nashmtl``): task weights ``w``, every
  parameter gets ``sum_i w_i g_i``; ``nashmtl`` then clips the global norm
  of the shared part at ``nash_max_norm``, ``mgda`` scales its weights by
  K and ``dwa`` divides its by K (the reference's mean);
* ``pcgrad``: each task's gradient projected in turn against the ORIGINAL
  gradients of the tasks, in a random order per task; ``task`` parameters
  get the plain sum, ``unassigned`` ones (the CLS ``c_fc``) no gradient;
* ``cagrad``: the conflict-averse gradient on the shared parameters only,
  every other parameter no gradient.

Every method that reads the gradients' geometry (``imtl``, ``nashmtl``,
``mgda``, ``pcgrad``, ``cagrad``) reads it from the K x K Gram matrix of
the shared gradients: the combined gradient always lies in their span, so
each method reduces to task weights and one weighted sum. The Gram matrix
is accumulated in float64, and the solvers run the JAX package's fixed
iteration counts (Frank-Wolfe 250, projected gradient 200, Newton 20) in
float64 on the host, since K = 3. At the reference init the consistency
task's gradient is ~0 and IMTL weights the other two ~1e-6, as one minus
a sum near one: a float32 solve gives those weights, which steer the
step, percent errors.

The JAX package draws PCGrad's orders and RLW's normals from a JAX PRNG,
which torch cannot replay, so both are arguments here (``order``: ``(K,
K)`` integer rows, one permutation per task; ``draw``: ``(K,)`` normals),
drawn from a ``torch.Generator`` when not given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

METHODS = ("ls", "scaleinvls", "stl", "uw", "rlw", "imtl", "dwa",
           "pcgrad", "cagrad", "mgda", "nashmtl")
_SURGERY = ("pcgrad", "cagrad")


@dataclasses.dataclass
class MTOState:
    """Union state of the methods (unused fields stay ``None``): the step
    count, UW's learnable log-sigma, DWA's FIFO cost history ``(2 window,
    K)`` and its last weights, NashMTL's previous alpha."""

    step: int = 0
    logsigma: Optional[Tensor] = None
    costs: Optional[Tensor] = None
    dwa_weights: Optional[Tensor] = None
    prvs_alpha: Optional[Tensor] = None

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}



@dataclasses.dataclass(frozen=True)
class MTOMethod:
    """A method and its hyperparameters (reference train.py:120)."""

    name: str
    n_tasks: int = 3
    main_task: int = 0          # stl
    cagrad_c: float = 0.4       # cagrad
    dwa_window: int = 25        # dwa
    dwa_temp: float = 2.0       # dwa
    nash_max_norm: float = 1.0  # nashmtl
    nash_niter: int = 20        # nashmtl
    mgda_normalization: str = "none"
    mgda_iters: int = 250

    @property
    def kind(self) -> str:
        return "surgery" if self.name in _SURGERY else "weighting"

    def init_state(self) -> MTOState:
        k = self.n_tasks
        ones = lambda *s: torch.ones(s, dtype=torch.float32)
        if self.name == "uw":
            return MTOState(logsigma=torch.zeros(k))
        if self.name == "dwa":
            return MTOState(costs=ones(2 * self.dwa_window, k), dwa_weights=ones(k))
        if self.name == "nashmtl":
            return MTOState(prvs_alpha=ones(k))
        return MTOState()


def check_method(name: Optional[str]) -> Optional[str]:
    """``None`` / ``""`` (the plain summed backward) or a method's name."""
    if not name:
        return None
    if name not in METHODS:
        raise KeyError(f"unknown MTO method {name!r}; known: {METHODS}")
    return name


def get_method(name: str, n_tasks: int = 3, **kwargs) -> MTOMethod:
    return MTOMethod(name=check_method(name), n_tasks=n_tasks, **kwargs)


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


def gram(task_grads: List[List[Tensor]]) -> Tensor:
    """The K x K Gram matrix of ``[task][param]`` gradients, accumulated in
    float64 one parameter at a time (no float64 copy of all of them)."""
    out = 0
    for gs in zip(*task_grads):
        flat = torch.stack([g.reshape(-1) for g in gs]).double()
        out = out + flat @ flat.t()
    return out


def pcgrad_coefficients(gram_m: Tensor, order: Tensor) -> Tensor:
    """Task weights ``w`` such that the PCGrad-combined gradient is
    ``sum_i w_i g_i``: task i starts at ``e_i`` and, for each j in
    ``order[i]``, drops its component along ``g_j`` when the two conflict."""
    k = gram_m.shape[0]
    w = torch.zeros(k, dtype=gram_m.dtype, device=gram_m.device)
    for i in range(k):
        c = torch.zeros(k, dtype=gram_m.dtype, device=gram_m.device)
        c[i] = 1.0
        for j in order[i].tolist():
            dot = c @ gram_m[:, j]
            coef = torch.where(dot < 0, dot / (gram_m[j, j] + 1e-12), torch.zeros_like(dot))
            c[j] = c[j] - coef
        w = w + c
    return w


def simplex_project(v: Tensor) -> Tensor:
    """Euclidean projection onto the probability simplex (sorted algorithm)."""
    k = v.shape[0]
    u = torch.sort(v, descending=True).values
    css = torch.cumsum(u, 0)
    idx = torch.arange(1, k + 1, dtype=v.dtype, device=v.device)
    rho = int((u + (1.0 - css) / idx > 0).sum()) - 1
    lam = (1.0 - css[rho]) / (rho + 1.0)
    return torch.clamp(v + lam, min=0.0)


def cagrad_coefficients(gram_m: Tensor, c: float = 0.4, iters: int = 200) -> Tensor:
    """Task weights of the CAGrad direction (reference :509-543): ``min_w
    w^T G b + c' ||g_w||`` over the simplex by projected gradient descent on
    the Gram matrix, then ``K / (1 + c^2) (g_mean + lambda g_w)`` written as
    one weighted sum of the task gradients."""
    k = gram_m.shape[0]
    cc = c * torch.sqrt(gram_m.mean() + 1e-8) + 1e-8
    b = torch.full((k,), 1.0 / k, dtype=gram_m.dtype, device=gram_m.device)
    w = b
    for i in range(iters):
        gw_norm = torch.sqrt(w @ gram_m @ w + 1e-8)
        grad = gram_m @ b + cc * (gram_m @ w) / gw_norm
        w = simplex_project(w - 0.2 / (1.0 + i * 0.05) * grad)
    lmbda = cc / (torch.sqrt(w @ gram_m @ w) + 1e-8)
    return float(k) / (1.0 + c ** 2) * (b + lmbda * w)


def task_weights(method: MTOMethod, state: MTOState, losses: Tensor,
                 gram_m: Optional[Tensor], draw: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor, MTOState]:
    """``(effective gradient weights, reported weights, new state)`` of a
    weighting method, in the dtype of ``losses`` (``gram_m``: the Gram
    matrix of the shared gradients, for ``imtl``, ``nashmtl`` and ``mgda``;
    ``draw``: RLW's normals). The state's ``step`` is not advanced here."""
    k, name = method.n_tasks, method.name
    dt, dev = losses.dtype, losses.device
    ones = torch.ones(k, dtype=dt, device=dev)
    eye = torch.eye(k, dtype=dt, device=dev)
    if name == "ls":
        return ones, ones, state
    if name == "scaleinvls":
        return ones / (losses + 1e-12), ones, state
    if name == "stl":
        return eye[method.main_task], eye[method.main_task], state
    if name == "rlw":
        w = torch.softmax(draw.to(dt), 0)
        return w, w, state
    if name == "uw":
        # L = sum 0.5 (exp(-s) l + s): each gradient weighted 0.5 exp(-s)
        w = torch.exp(-state.logsigma.to(dt))
        return 0.5 * w, w, state
    if name == "dwa":
        win = method.dwa_window
        costs = torch.roll(state.costs, -1, 0)
        costs[-1] = losses.detach().to(costs.dtype)
        ws = costs[win:].mean(0) / costs[:win].mean(0)
        e = torch.exp(ws / method.dwa_temp)
        w = k * e / e.sum() if state.step > win else state.dwa_weights
        # reference: loss = (w * losses).mean(): effective weight w / K
        return (w / k).to(dt), w.to(dt), dataclasses.replace(
            state, costs=costs, dwa_weights=w)
    g = gram_m.to(dt)
    if name == "imtl":
        # D = g_0 - g_{1:}, U = u_0 - u_{1:} with u_i = g_i / ||g_i||, all
        # from the Gram matrix: gu[i, j] = <g_i, u_j>
        gu = g / torch.sqrt(torch.diagonal(g) + 1e-12)[None, :]
        first = gu[0, 0] - gu[0, 1:]
        dut = gu[0, 0] - gu[0, 1:][None, :] - gu[1:, 0][:, None] + gu[1:, 1:]
        rest = first @ torch.linalg.inv(dut + 1e-8 * eye[1:, 1:])
        alpha = torch.cat([1.0 - rest.sum(0, keepdim=True), rest])
        return alpha, alpha, state
    if name == "nashmtl":
        # damped Newton on F(a) = G a - 1 / a, G the normalised Gram matrix
        gtg = g / (torch.linalg.norm(g) + 1e-10)
        alpha = state.prvs_alpha.to(dt)
        for _ in range(method.nash_niter):
            f = gtg @ alpha - 1.0 / (alpha + 1e-10)
            jac = gtg + torch.diag(1.0 / (alpha + 1e-10) ** 2)
            alpha = torch.clamp(alpha - torch.linalg.solve(jac + 1e-8 * eye, f), min=1e-6)
        return alpha, alpha, dataclasses.replace(
            state, prvs_alpha=alpha.to(state.prvs_alpha.dtype))
    if name == "mgda":
        # gradient normalizers (reference min_norm_solvers.py:201-219)
        norms = torch.sqrt(torch.diagonal(g) + 1e-12)
        gn = {"norm": norms, "loss": losses.to(dt),
              "loss+": losses.to(dt) * norms}.get(method.mgda_normalization, ones)
        m = g / (gn[:, None] * gn[None, :] + 1e-12)
        sol = ones / k
        for _ in range(method.mgda_iters):  # Frank-Wolfe, exact line search
            d = eye[int(torch.argmin(m @ sol))] - sol
            gamma = torch.clamp(-(sol @ m @ d) / (d @ m @ d + 1e-12), 0.0, 1.0)
            sol = sol + gamma * d
        sol = sol * k  # the reference scales the weights to sum to K (:369)
        return sol, sol, state
    raise KeyError(name)


def uw_logsigma_grad(state: MTOState, losses: Tensor) -> Tensor:
    """d/ds [0.5 (exp(-s) l + s)] = 0.5 (1 - exp(-s) l), per task."""
    return 0.5 * (1.0 - torch.exp(-state.logsigma) * losses.detach().to(state.logsigma))


def _weighted(ws: Tensor, gs: Sequence[Tensor]) -> Tensor:
    return sum(ws[t].to(g.dtype) * g for t, g in enumerate(gs))


def combine_grads(method: Optional[MTOMethod], task_grads: List[List[Tensor]],
                  labels: Sequence[str], order: Optional[Tensor] = None,
                  losses: Optional[Tensor] = None, state: Optional[MTOState] = None,
                  draw: Optional[Tensor] = None):
    """One gradient per parameter (``None`` = the parameter takes no step),
    the method's new state and its reported task weights.

    ``method=None``: the sum over tasks on every parameter (the reference's
    summed backward); state and weights ``None``. Otherwise ``losses`` (the
    K task losses) and ``state`` (``method.init_state()`` on the first
    step) are needed where the method reads them; ``order``: PCGrad's
    projection orders; ``draw``: RLW's normals. The host solvers run on the
    Gram matrix in float64; the weighted sums keep the gradients' dtype."""
    if method is None:
        return [sum(gs) for gs in zip(*task_grads)], None, None
    k = method.n_tasks
    state = state if state is not None else method.init_state()
    new_state = dataclasses.replace(state, step=state.step + 1)
    shared = [p for p, lab in enumerate(labels) if lab == "shared"]
    per_param = list(zip(*task_grads))
    need_gram = method.name in ("imtl", "nashmtl", "mgda", "pcgrad", "cagrad")
    g_host = (gram([[gs[p] for p in shared] for gs in task_grads]).cpu()
              if need_gram else None)
    out: List[Optional[Tensor]] = [None] * len(labels)

    if method.kind == "weighting":
        losses_h = losses.detach().to("cpu", torch.float64)
        eff, rep, w_state = task_weights(method, state, losses_h, g_host, draw)
        dev = task_grads[0][0].device
        eff_d = eff.to(dev)
        out = [_weighted(eff_d, gs) for gs in per_param]
        if method.name == "nashmtl" and method.nash_max_norm > 0:
            # clip the global norm of the shared part only (reference :264-266)
            norm = torch.sqrt(eff @ g_host @ eff)
            clip = torch.clamp(method.nash_max_norm / (norm + 1e-6), max=1.0).to(dev)
            for p in shared:
                out[p] = out[p] * clip.to(out[p].dtype)
        return out, dataclasses.replace(w_state, step=new_state.step), rep

    if method.name == "pcgrad":
        if order is None:
            order = random_order(k)
        coef = pcgrad_coefficients(g_host, order)
    else:
        coef = cagrad_coefficients(g_host, method.cagrad_c)
    coef_d = coef.to(task_grads[0][0].device)
    for p in shared:
        out[p] = _weighted(coef_d, per_param[p])
    if method.name == "pcgrad":
        for p, lab in enumerate(labels):
            if lab == "task":
                out[p] = sum(per_param[p])
    return out, new_state, torch.full((k,), 1.0 / k)
