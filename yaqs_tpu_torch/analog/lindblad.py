"""Lindblad helpers of the MCWF backend (numpy).

Port of ``yaqs_tpu.analog.lindblad.noise_model_jump_ops``, the one function
of the JAX module that the MCWF state-vector path needs; the Lindblad
backend itself is not ported yet.
"""

from __future__ import annotations

import numpy as np

from .embedding import embed_one_site, embed_operator, operator_schmidt_factors

__all__ = ["noise_model_jump_ops"]


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
