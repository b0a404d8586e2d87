"""Exact Lindblad master-equation backend (vec(rho) superoperator).

Port of ``yaqs_tpu.analog.lindblad``.  The operators are built on the host
(numpy and scipy, as in the JAX package) in the row-major vec convention

    ``vec(A rho B) = (A kron B^T) vec(rho)``

and the evolution runs on the device:

- dense route (:func:`lindblad_expectations`, vec(rho) up to
  ``MAX_PROPAGATOR_VEC_DIM`` entries): the step propagator ``expm(L dt)``,
  built with ``torch.linalg.matrix_exp`` in complex128 (a library call
  outside the kernels, where the JAX package calls scipy), then one launch
  of kernel K22 a step, the step and its trace rows;
- sparse route (:func:`lindblad_rk4_expectations`): fixed-grid RK4 on the
  sparse Liouvillian with ``ceil(dt ||L||_1 / 0.5)`` substeps a step, each
  substep four launches of kernel K21 (the CSR matvec with the stage
  updates fused), the trace rows by kernel K23 after each step.

Both return ``(n_obs, num_steps + 1)`` real rows on the uniform grid ``t_j =
j dt``.  Exponential in the system size: the simulator warns above
``RECOMMENDED_MAX_QUBITS`` sites.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.coo_rows import coo_rows, coo_table
from ..kernels.csr_spmm import csr_from_scipy, rk4_substep
from ..kernels.lindblad_step import lindblad_step, trace_table
from .embedding import embed_one_site, embed_operator, operator_schmidt_factors

__all__ = [
    "MAX_PROPAGATOR_VEC_DIM",
    "RECOMMENDED_MAX_QUBITS",
    "build_liouvillian",
    "build_liouvillian_sparse",
    "lindblad_expectations",
    "lindblad_rk4_expectations",
    "noise_model_jump_ops",
    "noise_model_jump_ops_sparse",
    "propagate_dense",
    "rk4_evolve",
    "rk4_substeps",
]

# above this vec(rho) size the dense expm(L dt) propagator is not built and
# the run takes fixed-grid RK4 on the sparse Liouvillian
MAX_PROPAGATOR_VEC_DIM = 4096
# density-matrix evolution is exponential in the chain length: warn beyond it
RECOMMENDED_MAX_QUBITS = 10


def _embed_one_site_sparse(op, site: int, length: int, d: int = 2):
    """``op`` at ``site`` as a scipy CSR operator, site 0 least significant.

    The JAX package's chain of ``kron``s with identities, built at once: row
    ``i``, whose digit at ``site`` is ``a``, holds ``op[a, b]`` at column ``i
    + (b - a) d^site`` for each nonzero ``op[a, b]`` (the same entries, in
    the same order)."""
    import scipy.sparse as sp

    op = sp.csr_matrix(np.asarray(op, dtype=complex))  # drops op's zeros, as the kron chain does
    n, stride = d**length, d**site
    digit = (np.arange(n) // stride) % d
    counts = np.diff(op.indptr)[digit]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    row = np.repeat(np.arange(n), counts)
    a = digit[row]
    k = op.indptr[a] + np.arange(indptr[-1]) - indptr[row]
    return sp.csr_matrix((op.data[k], row + (op.indices[k] - a) * stride, indptr), shape=(n, n))


def noise_model_jump_ops(noise_model, length: int, d: int = 2) -> list[np.ndarray]:
    """Embedded jump operators ``sqrt(gamma) L`` for each noise process."""
    ops: list[np.ndarray] = []
    if noise_model is None:
        return ops
    for proc in noise_model.processes:
        gamma = float(proc["strength"])
        if gamma == 0.0:
            continue
        sites = proc["sites"]
        if len(sites) == 1:
            full = embed_one_site(proc["matrix"], sites[0], length, d)
        elif "factors" in proc:
            f0, f1 = proc["factors"]
            full = embed_operator({sites[0]: f0, sites[1]: f1}, length, d)
        else:
            # adjacent two-site matrix: operator-Schmidt sum of products
            full = sum(
                embed_operator({sites[0]: a_k, sites[1]: b_k}, length, d)
                for a_k, b_k in operator_schmidt_factors(proc["matrix"], d)
            )
        ops.append(np.sqrt(gamma) * full)
    return ops


def noise_model_jump_ops_sparse(noise_model, length: int, d: int = 2) -> list:
    """Sparse (CSR) embedded jump operators ``sqrt(gamma) L``."""
    ops = []
    if noise_model is None:
        return ops
    for proc in noise_model.processes:
        gamma = float(proc["strength"])
        if gamma == 0.0:
            continue
        sites = proc["sites"]
        if len(sites) == 1:
            full = _embed_one_site_sparse(proc["matrix"], sites[0], length, d)
        elif "factors" in proc:
            f0, f1 = proc["factors"]
            full = _embed_one_site_sparse(f0, sites[0], length, d) @ _embed_one_site_sparse(f1, sites[1], length, d)
        else:
            # adjacent two-site matrix: operator-Schmidt sum of products
            full = None
            for a_k, b_k in operator_schmidt_factors(proc["matrix"], d):
                term = _embed_one_site_sparse(a_k, sites[0], length, d) @ _embed_one_site_sparse(
                    b_k, sites[1], length, d
                )
                full = term if full is None else full + term
        ops.append(np.sqrt(gamma) * full)
    return ops


def build_liouvillian(h: np.ndarray, jump_ops: list[np.ndarray]) -> np.ndarray:
    """Dense Liouvillian: ``-i[H, .] + sum_k (L . L^dag - 1/2 {L^dag L, .})``;
    ``jump_ops`` carry their rates (``sqrt(gamma) * L``).

    Assembled sparse (:func:`build_liouvillian_sparse`, the same terms added
    in the same order) and then made dense: each dense ``kron`` of the JAX
    package's loop writes all ``dim^4`` entries (about 15 s at vec(rho)
    4096 on the card's host), the sparse ones only the nonzero ones."""
    import scipy.sparse as sp

    csr = build_liouvillian_sparse(sp.csr_matrix(np.asarray(h, dtype=complex)),
                                   [sp.csr_matrix(np.asarray(j, dtype=complex)) for j in jump_ops])
    return csr.toarray()


def build_liouvillian_sparse(h_sparse, jump_ops_sparse: list):
    """Sparse (CSR) Liouvillian, the convention of :func:`build_liouvillian`
    without a dense intermediate, summed in the JAX package's order (the
    same entries and pattern)."""
    import scipy.sparse as sp

    dim = h_sparse.shape[0]
    eye = sp.identity(dim, dtype=complex, format="csr")
    h = h_sparse.tocsr().astype(complex)
    liou = -1j * (sp.kron(h, eye, format="csr") - sp.kron(eye, h.T, format="csr"))
    for jump in jump_ops_sparse:
        j = jump.tocsr().astype(complex)
        ld_l = (j.conj().T @ j).tocsr()
        liou = liou + sp.kron(j, j.conj(), format="csr")
        liou = liou - 0.5 * (sp.kron(ld_l, eye, format="csr") + sp.kron(eye, ld_l.T, format="csr"))
    return liou.tocsr()


def rk4_substeps(liou_sparse, dt: float) -> int:
    """RK4 substeps a step: ``ceil(dt ||L||_1 / 0.5)`` (RK4's stability
    region reaches about 2.8 on the imaginary axis; the substep keeps
    ``||L||_1 h <= 0.5`` for accuracy as well)."""
    onenorm = float(np.abs(liou_sparse.tocsr()).sum(axis=0).max())
    return max(1, int(np.ceil(dt * onenorm / 0.5)))


def lindblad_rk4_expectations(
    liou_sparse,
    rho0_vec,
    observables_sparse: list,
    dt: float,
    num_steps: int,
    substeps: int | None = None,
    return_final: bool = False,
    *,
    device="cuda",
    dtype: torch.dtype | None = None,
):
    """Fixed-grid RK4 on ``d vec(rho) / dt = L vec(rho)`` with the sparse
    Liouvillian, from ``rho0_vec (dim^2,)``; rows ``Re Tr(O rho)`` of the
    sparse observables at ``t_j = j dt``.

    ``dtype`` defaults to complex64 on a CUDA device and complex128
    elsewhere.  Returns the rows ``(n_obs, num_steps + 1)`` (real, on
    ``device``), and with ``return_final`` the pair ``(rows, vec_rho_final)``.
    """
    from .run import check_device, resolve_dtype

    check_device(device)
    dtype = resolve_dtype(device, dtype)
    liou_csr = liou_sparse.tocsr()
    n = liou_csr.shape[0]
    dim = int(round(np.sqrt(n)))
    if substeps is None:
        substeps = rk4_substeps(liou_csr, dt)
    a = csr_from_scipy(liou_csr, device, dtype)
    table = coo_table(observables_sparse, n, device, dtype)
    # a copy (torch.tensor): v becomes a work buffer of the substeps
    v = torch.tensor(np.asarray(rho0_vec, dtype=np.complex128).reshape(-1)).to(device=device, dtype=dtype)
    vals, v = rk4_evolve(a, table, v, dt / substeps, substeps, num_steps, dim)
    return (vals, v) if return_final else vals


def rk4_evolve(a, table, v: torch.Tensor, h: float, substeps: int, num_steps: int, dim: int):
    """The device loop of :func:`lindblad_rk4_expectations`: ``substeps``
    RK4 substeps of length ``h`` a step on the device CSR ``a`` (kernel
    K21), the trace rows of ``table`` after each step (K23).  ``v`` (vec(rho),
    ``dim^2`` entries) becomes a work buffer.  Returns the rows ``(n_obs,
    num_steps + 1)`` and the final vec(rho)."""
    acc, stage = torch.empty_like(v), (torch.empty_like(v), torch.empty_like(v))
    vals = v.real.new_empty((num_steps + 1, table.num_obs))
    vals[0] = coo_rows(table, v, "trace", dim)
    for j in range(num_steps):
        for _ in range(substeps):
            v, acc = rk4_substep(a, v, h, stage, acc), v  # the result lands in acc; the old v is the next acc
        vals[j + 1] = coo_rows(table, v, "trace", dim)
    return vals.T, v


def propagate_dense(liou: np.ndarray, vec0, observables: list[np.ndarray], dt: float, num_steps: int, *, device,
                    dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense route from ``vec0 (dim^2,)``: ``P = expm(L dt)`` by
    ``torch.linalg.matrix_exp`` in complex128 on ``device`` (then cast to
    ``dtype``), one K22 launch a step (and one for the rows at t = 0).
    Returns the rows ``(n_obs, num_steps + 1)`` and the final vec(rho)."""
    dim = int(round(np.sqrt(liou.shape[0])))
    p = torch.linalg.matrix_exp(torch.as_tensor(liou * dt).to(device=device, dtype=torch.complex128)).to(dtype)
    obs = np.stack(observables) if observables else np.zeros((0, dim, dim))
    obs_t = trace_table(torch.as_tensor(obs).to(device=device, dtype=dtype))
    # a copy (torch.tensor): v becomes a work buffer of the steps
    v = torch.tensor(np.asarray(vec0, dtype=np.complex128).reshape(-1)).to(device=device, dtype=dtype)
    vals = v.real.new_empty((num_steps + 1, obs_t.shape[0]))
    spare = torch.empty_like(v)
    lindblad_step(None, v, obs_t, out=spare, rows=vals[0])  # the rows at t = 0
    for j in range(num_steps):
        spare, _ = lindblad_step(p, v, obs_t, out=spare, rows=vals[j + 1])
        v, spare = spare, v
    return vals.T, v


def lindblad_expectations(
    h: np.ndarray,
    jump_ops: list[np.ndarray],
    psi0: np.ndarray,
    observables: list[np.ndarray],
    dt: float,
    num_steps: int,
    *,
    device="cuda",
    dtype: torch.dtype = torch.complex128,
) -> torch.Tensor:
    """Evolve ``rho = |psi0><psi0|`` through the dense step propagator and
    return ``(n_obs, num_steps + 1)`` real rows ``Re Tr(O rho)`` on the
    uniform grid ``t_j = j dt`` (complex128 by default on every device, as
    the JAX package's numpy loop)."""
    from .run import check_device

    check_device(device)
    liou = build_liouvillian(np.asarray(h, dtype=np.complex128), jump_ops)
    psi0 = np.asarray(psi0, dtype=np.complex128)
    vals, _ = propagate_dense(liou, np.outer(psi0, psi0.conj()).reshape(-1), observables, dt, num_steps,
                              device=device, dtype=dtype)
    return vals
