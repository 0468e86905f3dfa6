"""Gradients of the fused geometric-embedding op, port against the JAX
package on the CPU.

On the CPU the port's autograd Function runs the plain versions of K2
(forward) and K3 (backward).  The JAX side is `jax.grad` through
`geo_embed_maxk` with its Pallas kernels in interpret mode (custom VJP),
and through the plain XLA formulation of the same function.

Tolerances (relative, Frobenius, per gradient):
* bfloat16 against the Pallas kernel: both round the bases, the
  cotangent and each tie share to bfloat16 and sum exact products in
  float32, so only the summation order differs; but dMd and dMa are
  returned in bfloat16 (the dtype of Md and Ma), and a float32 sum taken
  in another order can round to the neighbouring bfloat16 value, one
  step (2^-8 relative) at a few elements: 1e-3;
* float32 against the XLA formulation: float32 products and sums on both
  sides: 1e-5;
* float32 against the Pallas kernel: 5e-3.  The Pallas backward rounds
  the bases and the cotangent to bfloat16 even in float32 mode; the port
  keeps float32 products there (ROADMAP §3), so the two differ by
  bfloat16 rounding (2^-9 per operand), averaged over many terms.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sam6d_tpu.config import GeoEmbeddingConfig as JCfg
from sam6d_tpu.models.pem.geo_embedding import (
    GeometricStructureEmbedding as JGeo,
    _cheb_sinusoid_coeffs,
)
from sam6d_tpu.ops.pallas.geo_embed import (
    _cheb_basis,
    _norm_idx,
    geo_embed_maxk as j_geo_embed_maxk,
)
from sam6d_tpu_torch.config import GeoEmbeddingConfig as TCfg
from sam6d_tpu_torch.models.pem.geo_embedding import (
    GeometricStructureEmbedding as TGeo,
)
from sam6d_tpu_torch.ops.geo_embed import geo_embed_maxk
from sam6d_tpu_torch.params import flax_to_state_dict

torch.set_num_threads(2)

HI_D, HI_A, D = 20.0, 12.0, 32


def _inputs(ties: bool, seed=0, B=2, N=13):
    rng = np.random.RandomState(seed)
    d_idx = (rng.rand(B, N, N) * HI_D).astype(np.float32)
    a_idx = (rng.rand(B, N, N, 3) * HI_A).astype(np.float32)
    if ties:
        # Exact ties across k: k=1 repeats k=0 everywhere, and k=2 too on
        # every other row, so two- and three-way ties both occur.
        a_idx[..., 1] = a_idx[..., 0]
        a_idx[:, ::2, :, 2] = a_idx[:, ::2, :, 0]
    kd = rng.randn(D, D).astype(np.float32) / np.sqrt(D)
    ka = rng.randn(D, D).astype(np.float32) / np.sqrt(D)
    Md = (_cheb_sinusoid_coeffs(40, D, HI_D) @ kd).astype(np.float32)
    Ma = (_cheb_sinusoid_coeffs(28, D, HI_A) @ ka).astype(np.float32)
    bias = (0.1 * rng.randn(D)).astype(np.float32)
    cot = rng.randn(B, N, N, D).astype(np.float32)
    return d_idx, a_idx, Md, Ma, bias, cot


def _port_grads(d_idx, a_idx, Md, Ma, bias, cot, dtype):
    t = {k: torch.from_numpy(v) for k, v in
         dict(Md=Md, Ma=Ma, bias=bias).items()}
    Mdt = t["Md"].to(dtype).requires_grad_()
    Mat = t["Ma"].to(dtype).requires_grad_()
    bt = t["bias"].requires_grad_()
    out = geo_embed_maxk(torch.from_numpy(d_idx), torch.from_numpy(a_idx),
                         Mdt, Mat, bt, HI_D, HI_A, dtype)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return [g.float().numpy() for g in (Mdt.grad, Mat.grad, bt.grad)]


def _pallas_grads(d_idx, a_idx, Md, Ma, bias, cot, jdt):
    def loss(md, ma, b):
        out = j_geo_embed_maxk(jnp.asarray(d_idx), jnp.asarray(a_idx), md,
                               ma, b[None], HI_D, HI_A, jdt, True)
        return jnp.sum(out.astype(jnp.float32) * cot)

    g = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(Md, jdt), jnp.asarray(Ma, jdt), jnp.asarray(bias))
    return [np.asarray(x, np.float32) for x in g]


def _xla_grads(d_idx, a_idx, Md, Ma, bias, cot):
    """jax.grad of the same function written in plain jnp (float32)."""
    def loss(md, ma, b):
        td = jnp.stack(_cheb_basis(_norm_idx(jnp.asarray(d_idx), HI_D), 40),
                       -1)
        ta = jnp.stack(_cheb_basis(_norm_idx(jnp.asarray(a_idx), HI_A), 28),
                       -1)
        out = td @ md + jnp.max(ta @ ma, axis=3) + b
        return jnp.sum(out * cot)

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(Md), jnp.asarray(Ma),
                                          jnp.asarray(bias))
    return [np.asarray(x) for x in g]


def _close(got, want, rtol):
    for name, a, b in zip(("dMd", "dMa", "dbias"), got, want):
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err <= rtol, f"{name}: relative error {err:.3g} > {rtol}"


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype,rtol", [
    (torch.bfloat16, 1e-3),  # final rounding to bf16; see above
    (torch.float32, 5e-3),  # the Pallas kernel rounds to bf16; see above
])
def test_grads_match_pallas_interpret(ties, dtype, rtol):
    inp = _inputs(ties)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _close(_port_grads(*inp, dtype), _pallas_grads(*inp, jdt), rtol)


@pytest.mark.parametrize("ties", [False, True])
def test_float32_grads_match_xla_formulation(ties):
    inp = _inputs(ties, seed=4)
    _close(_port_grads(*inp, torch.float32), _xla_grads(*inp), 1e-5)


def test_tie_shares_split_evenly():
    # All three k equal: dMa is the (summed) one-k gradient, whatever the
    # split; so a three-way tie must give exactly the no-max result.
    d_idx, a_idx, Md, Ma, bias, cot = _inputs(False, seed=2)
    a_idx[...] = a_idx[..., :1]
    got = _port_grads(d_idx, a_idx, Md, Ma, bias, cot, torch.float32)
    want = _xla_grads(d_idx, a_idx, Md, Ma, bias, cot)
    _close(got, want, 1e-5)


def test_module_param_grads_through_the_fused_path():
    """proj_d / proj_a gradients of the fused module (the Function with the
    sentinel deltas added to its output in place) against the JAX module's
    XLA path, at the 2e-3 the JAX package holds its own fused/plain pair
    to (tests/test_geo_embed_fused.py): the two formulations clamp and
    correct the bg sentinel differently."""
    rng = np.random.RandomState(11)
    B, N = 2, 17
    pts = rng.randn(B, N - 1, 3).astype(np.float32)
    pts /= np.abs(pts).max()
    pts = np.concatenate([np.full((B, 1, 3), 100.0, np.float32), pts], 1)
    variables = {"params": {
        n: {"kernel": (rng.randn(D, D) / np.sqrt(D)).astype(np.float32),
            "bias": (0.1 * rng.randn(D)).astype(np.float32)}
        for n in ("proj_d", "proj_a")}}
    cot = rng.randn(B, N, N, D).astype(np.float32)
    jmod = JGeo(dataclasses.replace(JCfg(hidden_dim=D), fused="off"))
    g = jax.grad(lambda p: jnp.sum(jmod.apply({"params": p}, pts) * cot))(
        variables["params"])
    want = flax_to_state_dict({"params": g})
    tmod = TGeo(TCfg(hidden_dim=D, fused="on"))
    tmod.load_state_dict(flax_to_state_dict(variables))
    (tmod(torch.from_numpy(pts)) * torch.from_numpy(cot)).sum().backward()
    for name, p in tmod.named_parameters():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=2e-3,
                                   atol=2e-3 * scale, err_msg=name)
