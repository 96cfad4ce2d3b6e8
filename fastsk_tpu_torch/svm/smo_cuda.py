"""Wrappers of kernels B and C (``csrc/smo.cu``): the fused SMO loops.

``smo_solve`` (kernel B) is the counterpart of
``fastsk_tpu/svm/smo_pallas.py:smo_solve_fused``, LIBSVM's Solver::Solve;
``smo_nu_solve`` (kernel C) that of ``smo_solve_nu_fused``, Solver_NU.
Each loop runs from a feasible start to the eps-KKT stop and returns
``(alpha, grad, iters)``; the caller computes the bias
(``svm/kernel_svm.py:_finalize_rho`` / ``_finalize_nu``). A CPU tensor
takes the plain twin (``smo_loop_plain`` / ``smo_nu_loop_plain``); a CUDA
tensor launches the kernel or raises. Every solve on the card goes
through a kernel, at every n. Both kernels run one thread-block cluster
a problem; ``smo_solve`` also takes a batch of problems over one Q (the
Platt folds: one launch, one cluster a problem). Each solve is the span
``smo.solve`` (``utils/observe.py``); the counters ``smo_solve.launches``,
``smo_solve.problems`` and ``smo_nu_solve.launches`` count the card's
launches and kernel B's problems, and ``smo.iterations`` adds each call
of ``smo_solve``'s longest problem's iterations, on the card and the CPU
alike: the serial loop's length, which sets the launch's time.

No padding is needed: the kernels loop over exactly n rows. Rows whose
C is 0 (the Platt folds' held-out rows) can join neither I_up nor I_low,
so they are inert in both versions.
"""

from __future__ import annotations

import torch

from .. import _build
from ..ops.pairs import full_f32_matmul
from ..utils.observe import count, span

_NEG_INF = -1e30
_TAU = 1e-12


def smo_loop_plain(Q, y, C_vec, qd, alpha0, grad0, eps: float, max_iter: int):
    """The SMO loop in plain PyTorch, one iteration per Python step.

    Operation order is ``fastsk_tpu/svm/kernel_svm.py:_smo_solve_general``'s
    body, in f32; ties in argmax/argmin go to the lowest index."""
    alpha = alpha0.clone()
    grad = grad0.clone()
    eps_t = torch.tensor(eps, dtype=torch.float32)
    pos = y > 0
    it = 0
    viol = torch.tensor(float("inf"), dtype=torch.float32)
    while it < max_iter and bool(viol.cpu() >= eps_t):
        up = torch.where(pos, alpha < C_vec, alpha > 0)
        low = torch.where(pos, alpha > 0, alpha < C_vec)
        minus_yg = -y * grad
        up_sc = torch.where(up, minus_yg, _NEG_INF)
        i = int(torch.argmax(up_sc))
        gmax = up_sc[i]
        gmax2 = torch.max(torch.where(low, -minus_yg, _NEG_INF))

        row_i = Q[i]
        yi = y[i]
        b = gmax + y * grad
        a_coef = qd[i] + qd - 2.0 * yi * y * row_i
        a_coef = torch.where(a_coef <= 0, _TAU, a_coef)
        obj_diff = -(b * b) / a_coef
        cand = low & (b > 0)
        j = int(torch.argmin(torch.where(cand, obj_diff, -_NEG_INF)))

        yj = y[j]
        quad = qd[i] + qd[j] - 2.0 * yi * yj * row_i[j]
        quad = torch.where(quad <= 0, _TAU, quad)
        ai, aj = alpha[i].clone(), alpha[j].clone()
        gi, gj = grad[i], grad[j]
        same = bool(yi == yj)
        if same:
            new_ai = ai - (gi - gj) / quad
            s_term = ai + aj
            lo_i = torch.clamp_min(s_term - C_vec[j], 0.0)
            hi_i = torch.minimum(C_vec[i], s_term)
        else:
            new_ai = ai + (-gi - gj) / quad
            s_term = ai - aj
            lo_i = torch.clamp_min(s_term, 0.0)
            hi_i = torch.minimum(C_vec[i], C_vec[j] + s_term)
        new_ai = torch.minimum(torch.maximum(new_ai, lo_i), hi_i)
        new_aj = s_term - new_ai if same else new_ai - s_term

        grad = grad + row_i * (new_ai - ai) + Q[j] * (new_aj - aj)
        alpha[i] = new_ai
        alpha[j] = new_aj
        it += 1
        viol = gmax + gmax2
    return alpha, grad, it


def smo_nu_loop_plain(Q, y, C_vec, qd, alpha0, grad0, eps: float, max_iter: int):
    """The Solver_NU loop in plain PyTorch, one iteration per Python step.

    Operation order is ``fastsk_tpu/svm/kernel_svm.py:_smo_solve_nu``'s
    body, in f32; ties in argmax/argmin go to the lowest index, so an
    empty candidate set (every score -1e30) gives index 0, as ``jnp.argmax``
    does."""
    alpha = alpha0.clone()
    grad = grad0.clone()
    eps_t = torch.tensor(eps, dtype=torch.float32)
    tau = torch.tensor(_TAU, dtype=torch.float32, device=Q.device)
    pos = y > 0
    neg = y < 0
    it = 0
    viol = torch.tensor(float("inf"), dtype=torch.float32)
    while it < max_iter and bool(viol.cpu() >= eps_t):
        # class-wise candidate sets (svm.cpp:1049-1068)
        upP = pos & (alpha < C_vec)
        lowP = pos & (alpha > 0)
        upN = neg & (alpha > 0)
        lowN = neg & (alpha < C_vec)
        sp = torch.where(upP, -grad, _NEG_INF)
        ip = int(torch.argmax(sp))
        gmaxp = sp[ip]
        sn = torch.where(upN, grad, _NEG_INF)
        in_ = int(torch.argmax(sn))
        gmaxn = sn[in_]
        gmaxp2 = torch.max(torch.where(lowP, grad, _NEG_INF))
        gmaxn2 = torch.max(torch.where(lowN, -grad, _NEG_INF))

        # j: global second-order choice across both classes; i follows j
        bP = gmaxp + grad
        bN = gmaxn - grad
        aP = qd[ip] + qd - 2.0 * Q[ip]
        aN = qd[in_] + qd - 2.0 * Q[in_]
        objP = -(bP * bP) / torch.maximum(aP, tau)
        objN = -(bN * bN) / torch.maximum(aN, tau)
        candP = lowP & (bP > 0)
        candN = lowN & (bN > 0)
        obj_all = torch.where(candP, objP, torch.where(candN, objN, -_NEG_INF))
        j = int(torch.argmin(obj_all))
        i = ip if bool(y[j] > 0) else in_

        quad = qd[i] + qd[j] - 2.0 * Q[i, j]
        quad = torch.where(quad <= 0, _TAU, quad)
        ai, aj = alpha[i].clone(), alpha[j].clone()
        delta = (grad[i] - grad[j]) / quad  # same-class pair update
        s_term = ai + aj
        lo_i = torch.clamp_min(s_term - C_vec[j], 0.0)
        hi_i = torch.minimum(C_vec[i], s_term)
        new_ai = torch.minimum(torch.maximum(ai - delta, lo_i), hi_i)
        new_aj = s_term - new_ai
        grad = grad + Q[i] * (new_ai - ai) + Q[j] * (new_aj - aj)
        alpha[i] = new_ai
        alpha[j] = new_aj
        it += 1
        viol = torch.maximum(gmaxp + gmaxp2, gmaxn + gmaxn2)
    return alpha, grad, it


def initial_state(Q, p, alpha0):
    """``(grad0, diag(Q))`` for a solve from ``alpha0``.

    ``grad0 = Q alpha0 + p`` is computed in full f32 (no TF32): grad is only
    ever updated incrementally afterwards, so a rounded start would bias
    the stop rule and rho for the whole solve."""
    with full_f32_matmul():
        grad0 = torch.mv(Q, alpha0) + p
    return grad0, torch.diagonal(Q).contiguous()


def _check_problem(Q, vecs, names: str) -> int:
    """n of a square f32 Q whose companion vectors lie on its device, are
    f32 and contiguous (shapes are checked by the callers)."""
    n = Q.shape[0]
    if Q.dim() != 2 or Q.shape[1] != n:
        raise ValueError(f"Q must be square; got {tuple(Q.shape)}")
    for v in (Q, *vecs):
        if v.dtype != torch.float32 or v.device != Q.device:
            raise ValueError(f"Q, {names} must be f32 on one device")
    if not all(v.is_contiguous() for v in (Q, *vecs)):
        raise ValueError(f"Q, {names} must be contiguous")
    if Q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the SMO kernels run on CUDA or CPU tensors, not {Q.device}")
    return n


def smo_cluster_size() -> int:
    """CTAs of kernel B's and kernel C's cluster per problem on the card:
    16 (a non-portable cluster), the faster of 8 and 16 at KAT2B in
    ``chip_smoke.py``'s phases 4 and 10."""
    return 16


def _cluster(cluster) -> int:
    cluster = smo_cluster_size() if cluster is None else int(cluster)
    if not 1 <= cluster <= 16:
        raise ValueError(f"cluster must be 1 to 16 CTAs; got {cluster}")
    return cluster


def smo_smem_path(n: int, cluster: int, solver: str = "B") -> bool:
    """Whether kernel ``solver`` ("B" or "C") keeps an n-row problem's
    slices in shared memory at ``cluster`` CTAs a problem (the kernel's
    own rule: 6 floats a row for B, 7 for C, within 220 KB a CTA)."""
    if solver not in ("B", "C"):
        raise ValueError(f"solver must be 'B' or 'C'; got {solver!r}")
    return bool(_build.kernels().smo_solve_smem(n, cluster, int(solver == "C")))


def smo_solve(Q, y, C_vec, p, alpha0, eps: float, max_iter: int, *, cluster=None):
    """Solver::Solve (kernel B) of one problem or a batch over one Q.

    ``y`` and ``p`` are ``[n]``; ``C_vec`` and ``alpha0`` are both ``[n]``
    (one problem: returns ``(alpha [n], grad [n], iters)``) or both ``[b,
    n]`` (b problems, one launch of b clusters: returns ``(alpha [b, n],
    grad [b, n], [iters] * b)``). Each problem's result is bit for bit
    that of solving it alone. A CPU tensor runs ``smo_loop_plain`` once per
    problem; a CUDA tensor launches the kernel (``cluster`` CTAs a
    problem, ``smo_cluster_size()`` by default) or raises."""
    n = _check_problem(Q, (y, C_vec, p, alpha0), "y, C, p and alpha0")
    if y.shape != (n,) or p.shape != (n,):
        raise ValueError(f"y and p must have shape ({n},)")
    batched = C_vec.dim() == 2
    if C_vec.shape != alpha0.shape or C_vec.shape[-1:] != (n,) or C_vec.dim() > 2 or (
        batched and C_vec.shape[0] < 1
    ):
        raise ValueError(
            f"C and alpha0 must both have shape ({n},) or (b, {n}); got "
            f"{tuple(C_vec.shape)} and {tuple(alpha0.shape)}"
        )
    C2, A0 = C_vec.reshape(-1, n), alpha0.reshape(-1, n)
    b = C2.shape[0]
    with span("smo.solve"):
        # one mv a problem: the same grad0 as a lone solve of it, bit for bit
        grad0 = torch.stack([initial_state(Q, p, a)[0] for a in A0])
        qd = torch.diagonal(Q).contiguous()
        if Q.device.type == "cpu":
            runs = [
                smo_loop_plain(Q, y, C2[f], qd, A0[f], grad0[f], eps, max_iter)
                for f in range(b)
            ]
            alpha = torch.stack([r[0] for r in runs])
            grad = torch.stack([r[1] for r in runs])
            iters = [r[2] for r in runs]
        else:
            cluster = _cluster(cluster)
            alpha = torch.empty_like(grad0)
            grad = torch.empty_like(grad0)
            row = torch.empty_like(grad0)
            it = torch.empty(b, dtype=torch.int32, device=Q.device)
            lib = _build.kernels()
            with torch.cuda.device(Q.device):
                status = lib.smo_solve_launch(
                    Q.data_ptr(), y.data_ptr(), C2.data_ptr(), qd.data_ptr(),
                    A0.data_ptr(), grad0.data_ptr(), alpha.data_ptr(), grad.data_ptr(),
                    row.data_ptr(), it.data_ptr(), n, b, float(eps), int(max_iter),
                    cluster, torch.cuda.current_stream().cuda_stream,
                )
            _build.check_launch(status, "smo_solve")
            count("smo_solve.launches")
            count("smo_solve.problems", b)
            iters = it.tolist()
    count("smo.iterations", max(iters))
    if batched:
        return alpha, grad, iters
    return alpha[0], grad[0], iters[0]


def smo_nu_solve(Q, y, C_vec, p, alpha0, eps: float, max_iter: int, *, cluster=None):
    """One Solver_NU solve (kernel C): ``(alpha, grad, iters)`` at the
    eps-KKT point; the per-class sums of ``alpha0`` are conserved. A CPU
    tensor takes ``smo_nu_loop_plain``; a CUDA tensor launches the kernel
    (one thread-block cluster of ``cluster`` CTAs, ``smo_cluster_size()``
    by default) or raises."""
    vecs = (y, C_vec, p, alpha0)
    n = _check_problem(Q, vecs, "y, C, p and alpha0")
    if any(v.shape != (n,) for v in vecs):
        raise ValueError(f"y, C, p and alpha0 must have shape ({n},)")
    if cluster is not None:
        _cluster(cluster)
    with span("smo.solve"):
        grad0, qd = initial_state(Q, p, alpha0)
        if Q.device.type == "cpu":
            return smo_nu_loop_plain(Q, y, C_vec, qd, alpha0, grad0, eps, max_iter)
        cluster = _cluster(cluster)
        alpha = torch.empty_like(alpha0)
        grad = torch.empty_like(grad0)
        rows = torch.empty((2, n), dtype=torch.float32, device=Q.device)
        iters = torch.empty(1, dtype=torch.int32, device=Q.device)
        lib = _build.kernels()
        with torch.cuda.device(Q.device):
            status = lib.smo_nu_solve_launch(
                Q.data_ptr(), y.data_ptr(), C_vec.data_ptr(), qd.data_ptr(),
                alpha0.data_ptr(), grad0.data_ptr(), alpha.data_ptr(),
                grad.data_ptr(), rows.data_ptr(), iters.data_ptr(), n, float(eps),
                int(max_iter), cluster, torch.cuda.current_stream().cuda_stream,
            )
        _build.check_launch(status, "smo_nu_solve")
        count("smo_nu_solve.launches")
        return alpha, grad, int(iters.item())
