"""Weighted Sharpness-Aware Minimization (KDD'23), functional form.

Port of ``dlrover_tpu/optimizers/wsam.py``: two-pass SAM where the final
gradient mixes the base gradient and the sharpness gradient with weight
``alpha = gamma / (1 - gamma)``.  ``wsam_gradients`` runs both passes
over a ``loss_and_grad_fn(params, batch) -> (loss, grads)`` on trees of
tensors and returns the combined gradient for any optimizer.
"""

from typing import Callable, Tuple

import torch

from dlrover_tpu_torch.common.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm over every leaf (fp32)."""
    return torch.sqrt(sum(torch.sum(x.float() * x.float())
                          for x in tree_leaves(tree)))


def _normalized_perturbation(grads, params, rho, adaptive, eps):
    if adaptive:
        scaled = tree_map(lambda p, g: torch.abs(p) * g, params, grads)
    else:
        scaled = grads
    scale = rho / (global_norm(scaled) + eps)
    if adaptive:
        return tree_map(lambda p, g: p * p * g * scale, params, grads)
    return tree_map(lambda g: g * scale, grads)


@torch.no_grad()
def _add(a, b):
    return tree_map(torch.add, a, b)


def wsam_gradients(
    loss_and_grad_fn: Callable,
    params,
    batch,
    rho: float = 0.05,
    gamma: float = 0.9,
    adaptive: bool = False,
    decouple: bool = True,
    eps: float = 1e-12,
) -> Tuple[torch.Tensor, object, object]:
    """Returns ``(loss, combined_grads, sharpness_grads)``.

    - coupled (``decouple=False``): combined = (1-alpha) g_w + alpha g_adv,
      sharpness all zeros;
    - decoupled (default): combined = g_w; sharpness = g_adv - g_w,
      which the caller applies as an extra ``-lr * alpha * sharpness``
      step (:func:`wsam_apply_sharpness`).
    """
    alpha = gamma / (1.0 - gamma)
    loss, g_w = loss_and_grad_fn(params, batch)
    with torch.no_grad():
        e_w = _normalized_perturbation(g_w, params, rho, adaptive, eps)
        params_adv = _add(params, e_w)
    _, g_adv = loss_and_grad_fn(params_adv, batch)
    with torch.no_grad():
        if decouple:
            return loss, g_w, tree_map(torch.sub, g_adv, g_w)
        combined = tree_map(
            lambda gw, ga: (1.0 - alpha) * gw + alpha * ga, g_w, g_adv)
        return loss, combined, tree_map(torch.zeros_like, g_w)


@torch.no_grad()
def wsam_apply_sharpness(params, sharpness, learning_rate, gamma):
    """The decoupled sharpness correction step (new tensors)."""
    alpha = gamma / (1.0 - gamma)
    return tree_map(lambda p, s: p - learning_rate * alpha * s, params,
                    sharpness)
