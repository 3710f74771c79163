"""Plain coverage maps and the plain placement step, from :mod:`.trace` and :mod:`.em`.

A map sums each order's valid paths coherently per receiver and adds the
orders' powers, as a call of the port's ``power_map_chunked`` per order
does. The placement step is ``parallel.streamed_placement_step``'s
arithmetic, held whole: the loss is the negated mean dB power over the
grid (each pixel's power floored at 1e-30 W), and its gradient to the TX
and the permittivity flows through the valid paths' vertices (traced
again with a graph, :func:`.trace.path_chain`) and the EM chain. With
hard masks an invalid path adds nothing and no gradient, so the valid
paths are the whole sum.
"""

import torch

from . import em, trace

POWER_FLOOR = 1e-30


def order_sums(city: trace.City, tx, rx, candidates, n_complex, frequency) -> torch.Tensor:
    """``[R]`` complex64: the sum of one order's valid paths' amplitudes at each receiver."""
    ri, ci, vertices = trace.valid_paths(city, tx, rx, candidates)
    bounce = city.normals[candidates[ci]] if candidates.shape[1] else vertices.new_zeros((vertices.shape[0], 0, 3))
    a = em.amplitudes(vertices, bounce, n_complex, frequency)
    out = torch.zeros(rx.shape[0], dtype=torch.complex64, device=rx.device)
    return out.index_add(0, ri, a)


def power_map(city: trace.City, tx, rx, candidate_sets, eta_r, conductivity, frequency) -> torch.Tensor:
    """``[R]`` float64 W: the orders' powers added, each from its coherent sum."""
    n_complex = em.refractive_index(eta_r, conductivity, frequency)
    total = torch.zeros(rx.shape[0], dtype=torch.float64, device=rx.device)
    for candidates in candidate_sets:
        s = order_sums(city, tx, rx, candidates, n_complex, frequency).to(torch.complex128)
        total = total + (s.real**2 + s.imag**2) / em.Z_0
    return total


def placement_loss(city: trace.City, tx, rx, candidate_sets, eta_r, conductivity, frequency):
    """The placement loss at ``tx [1, 3]`` and ``eta_r [1]``, differentiable in both (float32)."""
    n_complex = em.refractive_index(eta_r, conductivity, frequency)
    re = torch.zeros(rx.shape[0], device=rx.device)
    im = torch.zeros(rx.shape[0], device=rx.device)
    for candidates in candidate_sets:
        with torch.no_grad():
            ri, ci, _ = trace.valid_paths(city, tx.detach(), rx, candidates)
        cand = candidates[ci]
        tris = city.triangle_vertices[cand]
        dtype = tris.dtype
        vertices = trace.path_chain(tx[0].to(dtype), rx[ri].to(dtype), tris[:, :, 0, :], city.normals[cand])
        a = em.amplitudes(vertices, city.normals[cand], n_complex, frequency)
        re = re.index_add(0, ri, a.real)
        im = im.index_add(0, ri, a.imag)
    power = (re**2 + im**2) / em.Z_0
    return -torch.mean(10.0 * torch.log10(torch.clamp(power, min=POWER_FLOOR)))


def placement_gradient(city, tx, eta_r, conductivity, rx, candidate_sets, frequency):
    """The loss at ``(tx, eta_r)`` and its gradients ``(loss, g_tx, g_eta)``."""
    tx_leaf = tx.detach().float().clone().requires_grad_()
    eta_leaf = eta_r.detach().float().clone().requires_grad_()
    loss = placement_loss(city, tx_leaf, rx, candidate_sets, eta_leaf, conductivity, frequency)
    g_tx, g_eta = torch.autograd.grad(loss, (tx_leaf, eta_leaf))
    return float(loss.detach()), g_tx, g_eta


def placement_steps(city, tx, eta_r, conductivity, rx, candidate_sets, frequency, lr_tx, lr_eta, steps):
    """``steps`` plain gradient steps from ``(tx, eta_r)``: the state after each and its step's loss."""
    out = []
    tx, eta_r = tx.detach().float(), eta_r.detach().float()
    for _ in range(steps):
        loss, g_tx, g_eta = placement_gradient(city, tx, eta_r, conductivity, rx, candidate_sets, frequency)
        tx = tx - lr_tx * g_tx
        eta_r = eta_r - lr_eta * g_eta
        out.append((tx, eta_r, loss))
    return out
