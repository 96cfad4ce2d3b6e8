"""Wrappers of kernels B and C (``csrc/smo.cu``): the fused SMO loops.

``smo_solve`` (kernel B) is the counterpart of
``fastsk_tpu/svm/smo_pallas.py:smo_solve_fused``, LIBSVM's Solver::Solve;
``smo_nu_solve`` (kernel C) that of ``smo_solve_nu_fused``, Solver_NU.
Each loop runs from a feasible start to the eps-KKT stop and returns
``(alpha, grad, iters)``; the caller computes the bias
(``svm/kernel_svm.py:_finalize_rho`` / ``_finalize_nu``). A CPU tensor
takes the plain twin (``smo_loop_plain`` / ``smo_nu_loop_plain``); a CUDA
tensor launches the kernel or raises. Every solve on the card goes
through a kernel, at every n.

No padding is needed: the kernel loops over exactly n lanes. Rows whose
C is 0 (the Platt folds' held-out rows) can join neither I_up nor I_low,
so they are inert in both versions.
"""

from __future__ import annotations

import torch

from .. import _build
from ..ops.pairs import full_f32_matmul

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


def _solve(wrapper, kernel, plain, Q, y, C_vec, p, alpha0, eps, max_iter):
    """Check the inputs, then run ``plain`` on a CPU tensor, or on a CUDA
    one launch the C entry point named after ``wrapper`` and add one to
    ``wrapper.launches``."""
    n = Q.shape[0]
    if Q.dim() != 2 or Q.shape[1] != n:
        raise ValueError(f"Q must be square; got {tuple(Q.shape)}")
    vecs = (y, C_vec, p, alpha0)
    for v in (Q, *vecs):
        if v.dtype != torch.float32 or v.device != Q.device:
            raise ValueError("Q, y, C, p and alpha0 must be f32 on one device")
    if any(v.shape != (n,) for v in vecs):
        raise ValueError(f"y, C, p and alpha0 must have shape ({n},)")
    if not all(v.is_contiguous() for v in (Q, *vecs)):
        raise ValueError("Q, y, C, p and alpha0 must be contiguous")
    grad0, qd = initial_state(Q, p, alpha0)
    if Q.device.type == "cpu":
        return plain(Q, y, C_vec, qd, alpha0, grad0, eps, max_iter)
    if Q.device.type != "cuda":
        raise ValueError(f"kernel {kernel} runs on CUDA or CPU tensors, not {Q.device}")

    alpha = torch.empty_like(alpha0)
    grad = torch.empty_like(grad0)
    iters = torch.empty(1, dtype=torch.int32, device=Q.device)
    name = wrapper.__name__
    lib = _build.kernels()
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, f"{name}_launch")(
            Q.data_ptr(), y.data_ptr(), C_vec.data_ptr(), qd.data_ptr(),
            alpha0.data_ptr(), grad0.data_ptr(), alpha.data_ptr(),
            grad.data_ptr(), iters.data_ptr(), n, float(eps), int(max_iter),
            stream,
        )
    _build.check_launch(status, name)
    wrapper.launches += 1
    return alpha, grad, int(iters.item())


def smo_solve(Q, y, C_vec, p, alpha0, eps: float, max_iter: int):
    """One Solver::Solve (kernel B): ``(alpha, grad, iters)`` at the
    eps-KKT point."""
    return _solve(
        smo_solve, "B", smo_loop_plain, Q, y, C_vec, p, alpha0, eps, max_iter
    )


def smo_nu_solve(Q, y, C_vec, p, alpha0, eps: float, max_iter: int):
    """One Solver_NU solve (kernel C): ``(alpha, grad, iters)`` at the
    eps-KKT point; the per-class sums of ``alpha0`` are conserved."""
    return _solve(
        smo_nu_solve, "C", smo_nu_loop_plain, Q, y, C_vec, p, alpha0, eps,
        max_iter,
    )


smo_solve.launches = 0  # kernel launches; the CPU path does not count
smo_nu_solve.launches = 0
