"""Parity of the port's UTD module (``em/_utd.py``) with the JAX package.

Inputs come from ``numpy.random.default_rng``. Tolerances: the Fresnel
integrals ``atol=1e-6`` on [-40, 40] (both are the single-precision Cephes
``fresnlf``), their gradient ``atol=1e-6`` against ``jax.grad``; ``F`` and
the diffraction coefficients within 1e-4 of the largest magnitude on the
grid, PEC and lossy, with the grid's ``|eps|`` inside and just outside the
0.005 window of the singular limit.

``F`` multiplies the error of its bracket by about ``2 sqrt(z)`` (110 at
``z = 3000``), and XLA's fusion of the jitted ``F`` costs it 5e-4 there, so
the JAX side of ``F`` and of the coefficients runs op by op
(``jax.disable_jit()``), as the port runs. The reference's discarded
``where`` branches compute NaN (the Fresnel integrals' asymptotic branch at
0), which ``jax_debug_nans`` would raise on op by op: it is off for the
JAX side.
"""

import contextlib
import doctest
import importlib
import math

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
import numpy as np
import pytest
import torch

from differt_tpu import em as jax_em
from differt_tpu.em import _utd as jax_utd
from differt_tpu_torch import em
from differt_tpu_torch.em import _utd

from . import torch_parity  # noqa: F401  (its import takes the CPU math's first calls)

FRESNEL_ATOL = 1e-6
COEFF_RTOL = 1e-4


@contextlib.contextmanager
def _op_by_op():
    """The JAX side unjitted, without the NaN check (see the module docstring)."""
    with jax.disable_jit(), jax.debug_nans(False):
        yield


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_err(port, ref) -> float:
    port, ref = _np(port), _np(ref)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def test_fresnel_matches_jax() -> None:
    x = np.concatenate((
        np.linspace(-40.0, 40.0, 200_001, dtype=np.float32),
        np.float32([0.0, -0.0, 1.6, -1.6, 36_973.0, 36_975.0, -1e6, np.inf, -np.inf]),
    ))
    s, c = em.fresnel(torch.from_numpy(x))
    with jax.debug_nans(False):
        s_ref, c_ref = jsp.fresnel(jnp.asarray(x))
    np.testing.assert_allclose(_np(s), _np(s_ref), atol=FRESNEL_ATOL, rtol=0)
    np.testing.assert_allclose(_np(c), _np(c_ref), atol=FRESNEL_ATOL, rtol=0)
    assert s.dtype == torch.float32 and s.shape == x.shape


def test_fresnel_gradient_matches_jax() -> None:
    x = np.linspace(-40.0, 40.0, 20_001, dtype=np.float32)
    w = np.random.default_rng(0).normal(size=(2, x.size)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    s, c = em.fresnel(xt)
    ((s * torch.from_numpy(w[0])).sum() + (c * torch.from_numpy(w[1])).sum()).backward()

    def loss(x):
        s, c = jsp.fresnel(x)
        return jnp.sum(s * w[0]) + jnp.sum(c * w[1])

    with jax.debug_nans(False):
        grad = jax.grad(loss)(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), _np(grad), atol=FRESNEL_ATOL, rtol=0)


def test_fresnel_keeps_other_dtypes() -> None:
    s, c = em.fresnel(torch.tensor([0.5, 2.0], dtype=torch.float64))
    assert s.dtype == c.dtype == torch.float64
    s32, c32 = em.fresnel(torch.tensor([0.5, 2.0]))
    torch.testing.assert_close(s.float(), s32, atol=0, rtol=0)
    torch.testing.assert_close(c.float(), c32, atol=0, rtol=0)


def test_f_matches_jax() -> None:
    z = np.concatenate((
        np.float32([0.0, 1e-6, 1e-3]),
        np.random.default_rng(1).uniform(0.0, 3000.0, 4_000).astype(np.float32),
    ))
    with _op_by_op():
        ref = jax_em.F(jnp.asarray(z))
    port = em.F(torch.from_numpy(z))
    assert port.dtype == torch.complex64
    assert _rel_err(port, ref) <= COEFF_RTOL


def _grid(seed: int, num: int = 3_000) -> dict:
    """A seeded grid of (n, phi', phi, sin beta_0, L) whose phi - phi' and
    phi + phi' put a cotangent's ``|eps|`` inside, at and just outside the
    0.005 window of the singular limit, and elsewhere."""
    rng = np.random.default_rng(seed)
    n = rng.choice(np.float32([1.5, 1.25, 1.75, 2.0]), num)
    phi_i = rng.uniform(0.05, 1.0, num).astype(np.float32) * n * np.float32(np.pi)
    phi_d = rng.uniform(0.0, 1.0, num).astype(np.float32) * n * np.float32(np.pi)
    # The shadow (phi = pi + phi') and reflection (phi = pi - phi')
    # boundaries, each moved by eps / (2 n) for eps around +-0.005.
    eps = rng.choice(np.float32([0.0, 1e-3, -1e-3, 0.0049, -0.0049, 0.0051, -0.0051, 0.02]), num)
    kind = rng.integers(0, 3, num)
    shadow = (np.pi + phi_i + eps / (2.0 * n)).astype(np.float32)
    reflect = (np.pi - phi_i + eps / (2.0 * n)).astype(np.float32)
    phi_d = np.where(kind == 0, shadow, np.where(kind == 1, reflect, phi_d)).astype(np.float32)
    sin_beta_0 = rng.uniform(0.3, 1.0, num).astype(np.float32)
    length = rng.uniform(0.01, 1.0, num).astype(np.float32)
    return {"n": n, "phi_i": phi_i, "phi_d": phi_d, "sin_beta_0": sin_beta_0, "length_i": length}


K = np.float32(2.0 * np.pi * 2.4e9 / 299_792_458.0)


def _lossy_faces(seed: int, num: int):
    rng = np.random.default_rng(seed)
    faces = []
    for _ in range(2):
        r = (rng.uniform(-1, 1, (2, num)) + 1j * rng.uniform(-0.5, 0.5, (2, num))).astype(np.complex64)
        faces.append(r)
    return faces


@pytest.mark.parametrize("lossy", [False, True], ids=["pec", "lossy"])
def test_diffraction_coefficients_match_jax(lossy: bool) -> None:
    grid = _grid(2)
    num = grid["n"].size
    kw_t = {k: torch.from_numpy(v) for k, v in grid.items()}
    kw_j = {k: jnp.asarray(v) for k, v in grid.items()}
    if lossy:
        r_o, r_n = _lossy_faces(3, num)
        kw_t |= {"r_o": tuple(torch.from_numpy(x) for x in r_o), "r_n": tuple(torch.from_numpy(x) for x in r_n)}
        kw_j |= {"r_o": tuple(jnp.asarray(x) for x in r_o), "r_n": tuple(jnp.asarray(x) for x in r_n)}
    d_s, d_h = em.diffraction_coefficients(torch.tensor(K), **kw_t)
    with _op_by_op():
        r_s, r_h = jax_em.diffraction_coefficients(K, **kw_j)
    assert d_s.dtype == torch.complex64
    assert np.isfinite(_np(d_s)).all() and np.isfinite(_np(d_h)).all()
    assert _rel_err(d_s, r_s) <= COEFF_RTOL
    assert _rel_err(d_h, r_h) <= COEFF_RTOL


def test_diffraction_coefficients_take_separate_lengths() -> None:
    grid = _grid(4, 500)
    rng = np.random.default_rng(5)
    lengths = {k: rng.uniform(0.01, 1.0, 500).astype(np.float32) for k in ("length_r_o", "length_r_n")}
    d = em.diffraction_coefficients(
        torch.tensor(K), **{k: torch.from_numpy(v) for k, v in (grid | lengths).items()}
    )
    with _op_by_op():
        r = jax_em.diffraction_coefficients(K, **{k: jnp.asarray(v) for k, v in (grid | lengths).items()})
    for port, ref in zip(d, r):
        assert _rel_err(port, ref) <= COEFF_RTOL


def test_coefficient_gradients_are_finite_where_jax_are() -> None:
    """At and near the singular points the guards keep ``0 * inf`` out of the backward."""
    grid = _grid(6, 400)
    phi_d = torch.from_numpy(grid["phi_d"]).requires_grad_()
    length = torch.from_numpy(grid["length_i"]).requires_grad_()
    args = {k: torch.from_numpy(v) for k, v in grid.items() if k not in ("phi_d", "length_i")}
    d_s, d_h = em.diffraction_coefficients(torch.tensor(K), phi_d=phi_d, length_i=length, **args)
    (d_s.abs().sum() + d_h.abs().sum()).backward()

    def loss(phi_d, length):
        rs, rh = jax_em.diffraction_coefficients(
            K, phi_d=phi_d, length_i=length, **{k: jnp.asarray(v) for k, v in grid.items() if k not in ("phi_d", "length_i")}
        )
        return jnp.sum(jnp.abs(rs)) + jnp.sum(jnp.abs(rh))

    with _op_by_op():
        g_phi, g_len = jax.grad(loss, argnums=(0, 1))(jnp.asarray(grid["phi_d"]), jnp.asarray(grid["length_i"]))
    jax_finite = np.isfinite(_np(g_phi)) & np.isfinite(_np(g_len))
    assert jax_finite.all()
    assert torch.isfinite(phi_d.grad).all() and torch.isfinite(length.grad).all()
    for port, ref in ((phi_d.grad, g_phi), (length.grad, g_len)):
        assert _rel_err(port, ref) <= 1e-3


@pytest.mark.parametrize("mode", ["+", "-"])
def test_n_and_a_plus_minus_match(mode: str) -> None:
    rng = np.random.default_rng(7)
    beta = rng.uniform(-2 * np.pi, 4 * np.pi, 1_000).astype(np.float32)
    n = rng.uniform(1.0, 2.0, 1_000).astype(np.float32)
    np.testing.assert_array_equal(
        _np(_utd._n_plus_minus(torch.from_numpy(beta), torch.from_numpy(n), mode)),
        _np(jax_utd._n_plus_minus(beta, n, mode)),
    )
    np.testing.assert_allclose(
        _np(_utd._a_plus_minus(torch.from_numpy(beta), torch.from_numpy(n), mode)),
        _np(jax_utd._a_plus_minus(beta, n, mode)),
        atol=1e-6,
    )


def test_l_i_forms_match() -> None:
    rng = np.random.default_rng(8)
    s_d, sin2, r1, r2, re, s_i = (rng.uniform(0.5, 50.0, 100).astype(np.float32) for _ in range(6))
    sin2 = sin2 / 50.0
    t = lambda *xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    for port, ref in (
        (em.L_i(*t(s_d, sin2)), jax_em.L_i(s_d, sin2)),
        (em.L_i(*t(s_d, sin2), s_i=torch.from_numpy(s_i)), jax_em.L_i(s_d, sin2, s_i=s_i)),
        (em.L_i(*t(s_d, sin2, r1, r2, re)), jax_em.L_i(s_d, sin2, r1, r2, re)),
    ):
        np.testing.assert_allclose(_np(port), _np(ref), rtol=1e-6)


@pytest.mark.parametrize(
    ("kwargs", "message"),
    [
        ({"rho_1_i": 1.0, "rho_2_i": 1.0, "rho_e_i": 1.0, "s_i": 1.0}, "If 's_i' is provided"),
        ({"rho_1_i": 1.0}, "All three of"),
        ({"rho_1_i": 1.0, "rho_2_i": 1.0, "s_i": 1.0}, "If 's_i' is provided"),
    ],
)
def test_l_i_raises_as_jax(kwargs: dict, message: str) -> None:
    with pytest.raises(ValueError, match=message):
        em.L_i(1.0, 0.5, **kwargs)
    with pytest.raises(ValueError, match=message):
        jax_em.L_i(1.0, 0.5, **kwargs)


def test_cot_matches() -> None:
    x = np.random.default_rng(9).uniform(0.1, 3.0, 100).astype(np.float32)
    np.testing.assert_allclose(_np(_utd._cot(torch.from_numpy(x))), _np(jax_utd._cot(x)), rtol=1e-6)
    assert math.isclose(float(_utd._cot(torch.tensor(math.pi / 4))), 1.0, rel_tol=1e-6)


def test_doctests() -> None:
    result = doctest.testmod(importlib.import_module("differt_tpu_torch.em._utd"), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0
