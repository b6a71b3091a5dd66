"""t-SNE in torch ops on the device, for ``tools.tsne_eval`` (the card's
machine has no scikit-learn).

The JAX tool calls ``sklearn.manifold.TSNE(n_components=2, perplexity=p,
random_state=seed, init="pca")`` with its defaults: Barnes-Hut gradients
(``angle`` 0.5) over a k-nearest-neighbour P.  ``tsne`` minimises the same
objective with the same schedule, but with the exact P and the exact
gradient, step for step as scikit-learn's ``method="exact"``
(``sklearn/manifold/_t_sne.py`` of scikit-learn 1.9):

* P: float32 squared distances (computed in float64, ``pairwise_distances``
  with ``squared=True``), a binary search per row for the precision whose
  conditional entropy is ``log(perplexity)`` within 1e-5 (at most 100 steps,
  float64), then ``P = max((P + P^T) / sum, eps)`` off the diagonal;
* init: PCA to two components (the SVD of the centred float32 data with the
  ``svd_flip`` sign rule of the right singular vectors), scaled so that the
  first coordinate has standard deviation 1e-4;
* Student-t Q with one degree of freedom, ``Q = max(w / sum(w), eps)``;
* gradient descent with gains (+0.2 / x0.8, floor 0.01), 250 iterations at
  momentum 0.5 with P x 12, then up to 1,000 in all at momentum 0.8, the
  learning rate ``max(N / 12 / 4, 50)``; every 50 iterations the KL
  divergence and the gradient norm decide an early stop (no progress for
  250 / 300 iterations, or a norm <= 1e-7).

scikit-learn's dtypes are kept: the embedding, gains and gradient are
float32, the distances, P, Q and the gradient sums float64, the momentum
update float64 (a float64 learning rate times the float32 gradient).  From
the same starting embedding (``optimize``) the CPU run gives scikit-learn's
exact-method coordinates and KL divergence; the tests hold them within 1e-5
relative (bit-equal where they were written).  The PCA init itself comes
from another SVD routine than SciPy's and agrees to ~1e-6 relative, and
t-SNE's early iterations amplify a difference that small to O(1) in the
coordinates, so runs from their own inits (and card against CPU, whose
sums run in another order) are compared by KL divergence and
trustworthiness instead.

Why this is the JAX tool's result: Barnes-Hut approximates both P (the
3 x perplexity nearest neighbours) and the gradient (the quadtree's far
field) of this same objective; the exact method removes both
approximations, so its KL(P || Q) is at most Barnes-Hut's and its
neighbourhoods are as well kept (held against the JAX tool's own output in
the tests).  The quadtree is serial pointer-chasing on the host; the
exact gradient is dense O(N^2) work per iteration, which the card does well.

Memory: P is held whole (N^2 float64, as scikit-learn's exact method holds
it: 2.1 GB at N = 16,384); every per-iteration pairwise term is computed in
blocks of rows, O(block x N).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MACHINE_EPSILON = float(np.finfo(np.double).eps)
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))  # scikit-learn's C float constants
EPSILON_DBL = float(np.float32(1e-8))
BINARY_SEARCH_STEPS = 100
N_ITER_CHECK = 50
EXPLORATION_MAX_ITER = 250
EARLY_EXAGGERATION = 12.0
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
MIN_GAIN = 0.01
MAX_ITER = 1000
PAIR_BUDGET = 1 << 23  # pairs per row block: [block, N] float64 terms of 64 MiB


@dataclass
class TSNEResult:
    embedding: np.ndarray  # [N, 2] float32
    kl_divergence: float  # at the last evaluated iteration, as sklearn's kl_divergence_
    n_iter: int  # the last iteration run (sklearn's n_iter_)


def _blocks(n: int):
    """Row blocks of at most ``PAIR_BUDGET`` pairs."""
    rows = max(1, min(n, PAIR_BUDGET // n))
    for start in range(0, n, rows):
        yield start, min(start + rows, n)


def _squared_distances(x64: torch.Tensor, norms: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Rows ``start:end`` of the float32 squared distance matrix, computed in
    float64 as ``||a||^2 - 2 a.b + ||b||^2``, clipped at 0, diagonal 0."""
    d = -2.0 * (x64[start:end] @ x64.T)
    d += norms[start:end, None]
    d += norms[None, :]
    d = d.float().clamp_(min=0.0)
    rows = torch.arange(end - start, device=x64.device)
    d[rows, rows + start] = 0.0
    return d


def joint_probabilities(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """[N, N] float64 P (zero diagonal) for float32 data ``x``."""
    n = x.shape[0]
    desired_entropy = math.log(float(np.float32(perplexity)))
    conditional = torch.zeros(n, n, dtype=torch.float64, device=x.device)
    x64 = x.double()
    norms = (x64 * x64).sum(dim=1)
    for start, end in _blocks(n):
        d = _squared_distances(x64, norms, start, end).double()
        rows = torch.arange(end - start, device=x.device)
        off_diagonal = torch.ones_like(d, dtype=torch.bool)
        off_diagonal[rows, rows + start] = False
        beta = torch.ones(end - start, dtype=torch.float64, device=x.device)
        beta_min = torch.full_like(beta, -math.inf)
        beta_max = torch.full_like(beta, math.inf)
        active = torch.ones_like(beta, dtype=torch.bool)
        block = conditional[start:end]
        for _ in range(BINARY_SEARCH_STEPS):
            p = torch.exp(-d * beta[:, None]) * off_diagonal
            sum_p = p.sum(dim=1)
            sum_p = torch.where(sum_p == 0.0, torch.full_like(sum_p, EPSILON_DBL), sum_p)
            p /= sum_p[:, None]
            entropy = torch.log(sum_p) + beta * (d * p).sum(dim=1)
            diff = entropy - desired_entropy
            block[active] = p[active]  # a row keeps the P of its last step
            done = diff.abs() <= PERPLEXITY_TOLERANCE
            step = active & ~done
            up = step & (diff > 0.0)
            down = step & (diff <= 0.0)
            beta_min = torch.where(up, beta, beta_min)
            beta_max = torch.where(down, beta, beta_max)
            beta = torch.where(up, torch.where(torch.isinf(beta_max), beta * 2.0, (beta + beta_max) / 2.0),
                               beta)
            beta = torch.where(down, torch.where(torch.isinf(beta_min), beta / 2.0, (beta + beta_min) / 2.0),
                               beta)
            active = step
            if not bool(active.any()):
                break
    p = conditional + conditional.T
    del conditional
    sum_p = max(float(p.sum()), MACHINE_EPSILON)
    p /= sum_p
    p.clamp_(min=MACHINE_EPSILON)
    p.fill_diagonal_(0.0)
    return p


def pca_init(x: torch.Tensor) -> torch.Tensor:
    """The first two principal coordinates (float32) with the first scaled
    to standard deviation 1e-4, as sklearn's ``init="pca"``."""
    centred = x - x.mean(dim=0)
    u, s, vh = torch.linalg.svd(centred, full_matrices=False)
    # svd_flip(u_based_decision=False): each right singular vector's largest
    # |entry| is positive
    cols = vh.abs().argmax(dim=1)
    signs = torch.sign(vh[torch.arange(vh.shape[0], device=x.device), cols])
    emb = u[:, :2] * signs[:2] * s[:2]
    return emb / emb[:, 0].std(unbiased=False) * 1e-4


def _objective(y: torch.Tensor, p: torch.Tensor, compute_error: bool):
    """-> (KL divergence or nan, float32 gradient) of the exact t-SNE
    objective at the float32 embedding ``y`` (sklearn's ``_kl_divergence``)."""
    n = y.shape[0]
    y64 = y.double()

    def pair_terms(start, end):
        """-> (w with a zero diagonal, the float32 differences sklearn
        multiplies, the largest squared distance)."""
        diff = y64[start:end, None, :] - y64[None, :, :]  # [B, N, 2]
        d = (diff * diff).sum(dim=-1)
        w = 1.0 / (1.0 + d)
        rows = torch.arange(end - start, device=y.device)
        w[rows, rows + start] = 0.0
        return w, diff.float(), d.amax()

    # one pass: z = sum(w), and the attraction / repulsion sums apart, exact
    # while no Q falls under the eps floor (checked; else a second pass)
    z = torch.zeros((), dtype=torch.float64, device=y.device)
    d_max = torch.zeros((), dtype=torch.float64, device=y.device)
    attract = torch.empty(n, 2, dtype=torch.float64, device=y.device)
    repulse = torch.empty_like(attract)
    for start, end in _blocks(n):
        w, diff32, block_max = pair_terms(start, end)
        z += w.sum()
        d_max = torch.maximum(d_max, block_max)
        attract[start:end] = ((p[start:end] * w)[..., None] * diff32).sum(dim=1)
        repulse[start:end] = ((w * w)[..., None] * diff32).sum(dim=1)
    floored = bool(1.0 / (1.0 + d_max) / z < MACHINE_EPSILON)  # the smallest Q
    kl = math.nan
    if compute_error or floored:
        grad64 = torch.empty_like(attract)
        kl_sum = torch.zeros((), dtype=torch.float64, device=y.device)
        for start, end in _blocks(n):
            w, diff32, _ = pair_terms(start, end)
            pb = p[start:end]
            q = torch.clamp(w / z, min=MACHINE_EPSILON)
            if compute_error:
                off = w > 0.0
                kl_sum += (pb[off] * torch.log(torch.clamp(pb[off], min=MACHINE_EPSILON) / q[off])).sum()
            if floored:
                grad64[start:end] = (((pb - q) * w)[..., None] * diff32).sum(dim=1)
        if compute_error:
            kl = float(kl_sum)
    if not floored:
        grad64 = attract - repulse / z
    return kl, (4.0 * grad64).float()  # 2 (dof + 1) / dof with dof = 1


def _gradient_descent(y0, p, it, max_iter, momentum, learning_rate, n_iter_without_progress):
    """sklearn's ``_gradient_descent`` with ``n_iter_check`` 50."""
    y = y0.clone()
    update = torch.zeros_like(y, dtype=torch.float64)
    gains = torch.ones_like(y)
    error = best_error = math.inf
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        error, grad = _objective(y, p, check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad.double()
        y = (y.double() + update).float()
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return y, error, i


def optimize(p: torch.Tensor, y0: torch.Tensor) -> TSNEResult:
    """sklearn's two stages from the embedding ``y0`` ([N, 2] float32) over
    ``p`` (``joint_probabilities``; scaled by 12 and back in place)."""
    learning_rate = max(p.shape[0] / EARLY_EXAGGERATION / 4, 50.0)
    p *= EARLY_EXAGGERATION
    y, kl, it = _gradient_descent(y0, p, 0, EXPLORATION_MAX_ITER, 0.5, learning_rate,
                                  EXPLORATION_MAX_ITER)
    p /= EARLY_EXAGGERATION
    y, kl, it = _gradient_descent(y, p, it + 1, MAX_ITER, 0.8, learning_rate,
                                  N_ITER_WITHOUT_PROGRESS)
    return TSNEResult(y.cpu().numpy(), kl, it)


def tsne(x, perplexity: float = 30.0, device="cpu") -> TSNEResult:
    """Embed ``x`` ([N, D], cast to float32) in two dimensions on ``device``."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    n = x.shape[0]
    if perplexity >= n:
        raise ValueError(f"perplexity ({perplexity}) must be less than n_samples ({n})")
    return optimize(joint_probabilities(x, perplexity), pca_init(x))
