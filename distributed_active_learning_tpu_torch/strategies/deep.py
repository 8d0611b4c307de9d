"""Deep-AL acquisition functions over MC predictive samples (the port of
``strategies/deep.py``).

- predictive entropy  ``H[E_s p]``; BALD ``H[E_s p] - E_s H[p]``;
  mean-std (population std over samples, averaged over classes); variation
  ratio ``1 - max_c E_s p``; margin (negative top-2 gap of ``E_s p``);
- BatchBALD: greedy ``I(y_1..y_k; w)`` over the ``candidate_pool`` best
  unlabeled points by marginal BALD, with the exact joint as ``[S, C^t]``
  while ``C^t <= max_configs`` and then ``mc_samples`` sampled
  configurations, importance-weighted, carried normalized with a log-space
  offset;
- coreset: k-Center-Greedy over features (squared L2);
- BADGE: k-means++ seeding over hallucinated-label gradient embeddings,
  ``<g_i (x) h_i, g_j (x) h_j> = <g_i, g_j> <h_i, h_j>`` so the ``[n, C D]``
  embedding is never formed.

Every function is a pure function of its tensors and reads nothing back to
the host, so the neural chunk captures them into its CUDA graph. JAX unrolls
the greedy loops under jit; here they are Python loops with static shapes at
each pick (the exact -> MC switch of BatchBALD is decided from shapes, as in
JAX). ``log`` is XLA's float32 polynomial (``ops/xla_f32.log_f32``), a
division by a count its float32 reciprocal, and every random draw the
threefry stream of the JAX code (``ops/threefry.py``), so the picks equal the
JAX package's on the same inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from distributed_active_learning_tpu_torch import prng
from distributed_active_learning_tpu_torch.ops import threefry
from distributed_active_learning_tpu_torch.ops.topk import stable_top_k
from distributed_active_learning_tpu_torch.ops.xla_f32 import div_const, log_f32

_EPS = 1e-12
_INF = float("inf")


def _mean0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=0)``: the sum times the count's float32
    reciprocal."""
    return div_const(x.sum(0), x.shape[0])


def predictive_entropy(probs_samples: torch.Tensor) -> torch.Tensor:
    """H of the posterior-mean predictive, per point ``[n]`` (nats)."""
    mean = _mean0(probs_samples)
    return -(mean * log_f32(mean + _EPS)).sum(-1)


def expected_conditional_entropy(probs_samples: torch.Tensor) -> torch.Tensor:
    """``E_s H[p_s]``, per point ``[n]`` (nats)."""
    ent = -(probs_samples * log_f32(probs_samples + _EPS)).sum(-1)
    return _mean0(ent)


def bald_score(probs_samples: torch.Tensor) -> torch.Tensor:
    """Mutual information between label and parameters, per point ``[n]``."""
    return predictive_entropy(probs_samples) - expected_conditional_entropy(probs_samples)


def mean_std_score(probs_samples: torch.Tensor) -> torch.Tensor:
    """Mean over classes of the per-class population std over samples."""
    mean = _mean0(probs_samples)
    std = torch.sqrt(_mean0((probs_samples - mean) ** 2))
    return div_const(std.sum(-1), std.shape[-1])


def variation_ratio(probs_samples: torch.Tensor) -> torch.Tensor:
    """``1 - max_c E_s p``, per point ``[n]``."""
    return 1.0 - _mean0(probs_samples).max(-1).values


def margin_score(probs_samples: torch.Tensor) -> torch.Tensor:
    """Negative top-2 margin of the posterior mean, per point ``[n]``."""
    top2 = stable_top_k(_mean0(probs_samples), 2)[0]
    return -(top2[..., 0] - top2[..., 1])


def _joint_entropy_candidates(joint: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """H of (chosen batch, candidate i) for every candidate: ``joint [S, J]``,
    ``probs [S, m, C]`` -> ``[m]``."""
    q = div_const(torch.einsum("sj,sic->ijc", joint, probs), joint.shape[0])
    return -(q * log_f32(q + _EPS)).sum((1, 2))


def _set(mask: torch.Tensor, j: torch.Tensor, value: bool = True) -> torch.Tensor:
    """``mask.at[j].set(value)`` for a 0-d device index."""
    return mask.index_fill(0, j.reshape(1), value)


def _at(t: torch.Tensor, j: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``t[j]`` along ``dim`` for a 0-d device index. (Indexing with a 0-d
    integer tensor reads it back to the host, which a CUDA graph capture
    refuses.)"""
    return t.index_select(dim, j.reshape(1)).squeeze(dim)


def batchbald_select(
    probs_samples: torch.Tensor,
    unlabeled_mask: torch.Tensor,
    k: int,
    max_configs: int = 4096,
    candidate_pool: int = 512,
    mc_samples: int = 256,
    key: Optional[prng.Key] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy BatchBALD batch of ``k`` points: ``(picked_idx [k], scores_at_pick
    [k])`` as pool indices. ``key`` seeds the MC configuration draws
    (``None``: ``key(0)``)."""
    S, n, C = probs_samples.shape
    dev = probs_samples.device
    key = prng.key(0, dev) if key is None else key.to(dev)
    bald = bald_score(probs_samples)

    m = min(candidate_pool, n)
    if m < k:
        m = min(n, k)
    _, cand = stable_top_k(torch.where(unlabeled_mask, bald, -_INF), m)
    cand_probs = probs_samples[:, cand, :]
    cond_ent = expected_conditional_entropy(cand_probs)
    chosen = ~unlabeled_mask[cand]

    joint = torch.ones((S, 1), dtype=probs_samples.dtype, device=dev)
    W = offs = None
    sum_cond = torch.zeros((), dtype=probs_samples.dtype, device=dev)
    exact = True
    picked, scores = [], []
    for _ in range(k):
        if exact and joint.shape[1] * C > max_configs:
            exact = False
            log_pm = log_f32(_mean0(joint) + _EPS)
            keys = prng.split(key)
            key, k_cfg = keys[0], keys[1]
            cfg = threefry.categorical(k_cfg, log_pm, mc_samples).long()
            W = joint[:, cfg]
            pm = _mean0(W)
            offs = log_f32(pm + _EPS)
            W = W / (pm[None, :] + _EPS)
        if exact:
            h_joint = _joint_entropy_candidates(joint, cand_probs)
        else:
            qn = div_const(torch.einsum("sm,sic->imc", W, cand_probs), S)
            h_joint = div_const(-(qn * (log_f32(qn + _EPS) + offs[None, :, None])).sum((1, 2)),
                                mc_samples)
        score = h_joint - (sum_cond + cond_ent)
        score = torch.where(chosen, -_INF, score)
        j = torch.argmax(score)
        picked.append(_at(cand, j))
        scores.append(_at(score, j))
        chosen = _set(chosen, j)
        sum_cond = sum_cond + _at(cond_ent, j)
        p_j = _at(cand_probs, j, 1)
        if exact:
            joint = (joint[:, :, None] * p_j[:, None, :]).reshape(S, -1)
        else:
            cls_logits = log_f32(div_const(torch.einsum("sm,sc->mc", W, p_j), S) + _EPS)
            keys = prng.split(key)
            key, k_cls = keys[0], keys[1]
            cls = threefry.categorical(k_cls, cls_logits, mc_samples).long()
            W = W * p_j[:, cls]
            alpha = _mean0(W)
            offs = offs + log_f32(alpha + _EPS)
            W = W / (alpha[None, :] + _EPS)
    return torch.stack(picked), torch.stack(scores)


def coreset_min_dists(features: torch.Tensor, labeled_mask: torch.Tensor,
                      chunk: int = 512) -> torch.Tensor:
    """Squared L2 distance of every pool point to its nearest labeled center,
    in ``[chunk, n]`` Gram blocks; with no labeled center every distance is
    ``norms.max() + 1``."""
    n = features.shape[0]
    x = features.reshape(n, -1).to(torch.float32)
    norms = (x * x).sum(1)
    col_inf = torch.where(labeled_mask, 0.0, _INF)
    out = []
    for lo in range(0, n, chunk):
        xc, nc = x[lo:lo + chunk], norms[lo:lo + chunk]
        g = nc[:, None] + norms[None, :] - 2.0 * (xc @ x.T)
        out.append((g + col_inf[None, :]).min(1).values)
    min_dist = torch.cat(out)
    return torch.where(torch.isfinite(min_dist), min_dist, norms.max() + 1.0)


def coreset_select(features: torch.Tensor, labeled_mask: torch.Tensor, k: int, chunk: int = 512,
                   selectable_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-Center-Greedy: ``(picked_idx [k], distance_at_pick [k])``.
    ``labeled_mask`` marks the centers, ``selectable_mask`` (default
    ``~labeled_mask``) the pickable rows."""
    n = features.shape[0]
    x = features.reshape(n, -1).to(torch.float32)
    norms = (x * x).sum(1)
    min_dist = coreset_min_dists(features, labeled_mask, chunk)
    selectable = ~labeled_mask if selectable_mask is None else selectable_mask
    picked, dists = [], []
    for _ in range(k):
        d = torch.where(selectable, min_dist, -_INF)
        j = torch.argmax(d)
        picked.append(j)
        dists.append(_at(d, j))
        selectable = _set(selectable, j, False)
        d2_j = norms + _at(norms, j) - 2.0 * (x @ _at(x, j))
        min_dist = torch.minimum(min_dist, d2_j)
    return torch.stack(picked), torch.stack(dists)


def badge_embedding_norms(probs: torch.Tensor, embeddings: torch.Tensor):
    """BADGE's ``g = p - onehot(argmax p)``, the flattened float32 ``h`` and
    ``|g (x) h|^2 = |g|^2 |h|^2`` per row."""
    classes = torch.arange(probs.shape[-1], device=probs.device)
    g = probs - (torch.argmax(probs, -1)[:, None] == classes).to(probs.dtype)
    h = embeddings.reshape(embeddings.shape[0], -1).to(torch.float32)
    return g, h, (g * g).sum(1) * (h * h).sum(1)


def badge_select(probs: torch.Tensor, embeddings: torch.Tensor, selectable_mask: torch.Tensor,
                 k: int, key: prng.Key) -> torch.Tensor:
    """BADGE batch: k-means++ seeding (the first center uniform over the
    selectable rows, then D^2 draws) over the gradient embeddings;
    ``picked_idx [k]``."""
    dev = probs.device
    g, h, sq = badge_embedding_norms(probs, embeddings)
    keys = prng.split(key.to(dev), k)
    zero = torch.zeros((), device=dev)

    def dist_to(j):
        return sq + _at(sq, j) - 2.0 * (g @ _at(g, j)) * (h @ _at(h, j))

    j = threefry.categorical(keys[0], torch.where(selectable_mask, zero, -_INF), 1)[0].long()
    picked = [j]
    selectable = _set(selectable_mask, j, False)
    min_d = dist_to(j)
    for t in range(1, k):
        w = torch.where(selectable, torch.clamp_min(min_d, 1e-12), zero)
        j = threefry.categorical(keys[t], log_f32(w), 1)[0].long()
        picked.append(j)
        selectable = _set(selectable, j, False)
        min_d = torch.minimum(min_d, dist_to(j))
    return torch.stack(picked)
