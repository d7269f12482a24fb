"""EM E-step: probabilistic correspondence weights (port of the JAX
package's ``ops/weights.py``).

One vectorized pass over the whole (N, K) padded association table:
per-slot log-probability, masked row logsumexp, posterior softmax and (for
the t-distribution) the expected-precision factor. Reference:
probabilistic_weights.hpp:48-105; golden vectors in tests/test_weights.py
(test/ProbabilisticWeightsTest.cc:35-66).

  t-distribution (dof = v < inf), d = residual dimension:
    log_prob        = -(v + d)/2 * log1p(e2 / v) - log_norm_constant
    expected_weight = (v + d) / (v + e2)
    weight          = softmax_row(log_prob) * expected_weight

  Gaussian (v = inf):
    log_prob = -e2/2 + (d/2) log(2 pi)
    weight   = softmax_row(log_prob)

The Gaussian branch *adds* the normalization constant, a sign quirk of the
reference (probabilistic_weights.hpp:42-45, 69) that cancels in the row
softmax; it is reproduced so intermediate log-probs match too. Masked slots
contribute nothing; fully-masked rows give all-zero weights.
"""
from __future__ import annotations

import math

import torch


def _t_constants(dof: float, dimension: int):
    t_exponent = -(dof + dimension) / 2.0
    log_norm_constant = (
        math.lgamma(dof / 2.0)
        - math.lgamma((dof + dimension) / 2.0)
        + (dof / 2.0) * math.log(math.pi * dof)
    )
    return t_exponent, log_norm_constant


def update_weights(sq_errors: torch.Tensor, mask: torch.Tensor, *, dof: float,
                   dimension: int) -> torch.Tensor:
    """Posterior association weights for one EM E-step.

    Args:
      sq_errors: (N, K) squared residual norms per association slot.
      mask: (N, K) bool; True where the slot holds a real association.
      dof: t-distribution degrees of freedom; ``inf`` selects the Gaussian.
      dimension: residual dimension d (3 in registration).

    Returns:
      (N, K) weights; zero at masked slots and on fully-masked rows.
    """
    # Constants made on the device (no host copy, so a CUDA graph can hold
    # the E-step).
    neg_inf = sq_errors.new_full((), -math.inf)
    zero = sq_errors.new_zeros(())

    if math.isinf(dof):
        log_norm_constant = (dimension / 2.0) * math.log(2.0 * math.pi)
        log_prob = -sq_errors / 2.0 + log_norm_constant
        expected_weight = None
    else:
        t_exponent, log_norm_constant = _t_constants(dof, dimension)
        log_prob = t_exponent * torch.log1p(sq_errors / dof) - log_norm_constant
        expected_weight = (dof + dimension) / (dof + sq_errors)

    log_prob = torch.where(mask, log_prob, neg_inf)
    # Max-shifted logsumexp over the row (probabilistic_weights.hpp:77-87).
    row_max = torch.amax(log_prob, dim=-1, keepdim=True)
    any_valid = row_max > neg_inf
    safe_max = torch.where(any_valid, row_max, zero)
    sum_exp = torch.sum(
        torch.where(mask, torch.exp(log_prob - safe_max), zero), dim=-1, keepdim=True
    )
    log_marginal = torch.log(torch.where(any_valid, sum_exp, zero + 1.0)) + safe_max

    weights = torch.where(mask & any_valid, torch.exp(log_prob - log_marginal), zero)
    if expected_weight is not None:
        weights = weights * expected_weight
    return weights
