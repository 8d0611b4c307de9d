"""LAL, "Learning Active Learning" (Konyushkova et al.): the port of
``strategies/lal.py``.

The reference's ``ActiveLearnerLAL`` (``classes/active_learner.py:240-343``)
builds five features per unlabeled point and scores them with a pretrained
random-forest regressor of the expected error reduction, taking the argmax.
Here the features are the columns of one ``[n, 5]`` tensor and the
regressor is a forest evaluated over it (``aux.lal_forest``, from
``models/lal_training.py``):

- f_1: the positive-vote fraction of the base forest;
- f_2: the SD of the per-tree Bernoulli votes, ``sqrt(p (1 - p))``;
- f_3: the share of positive labels in the labeled set (a scalar);
- f_6: the mean of f_2 over the unlabeled pool (a scalar);
- f_8: the number of labeled points (a scalar).

The arithmetic is the JAX package's as its CPU code computes it: ``votes /
T`` as a multiply by f32(1/T) (``xla_f32.div_const``), ``1 - p`` contracted
(``scoring.vote_sd``), and the pool sum of f_6 in XLA's reduce order
(``xla_f32.row_sum``).
"""

from __future__ import annotations

import torch

from distributed_active_learning_tpu_torch.config import StrategyConfig
from distributed_active_learning_tpu_torch.ops import forest_eval, scoring, trees_multi
from distributed_active_learning_tpu_torch.ops.xla_f32 import div_const, row_sum
from distributed_active_learning_tpu_torch.strategies.base import Strategy, StrategyAux, register_strategy


def lal_features(forest, state) -> torch.Tensor:
    """The ``[n, 5]`` feature matrix (columns f_1, f_2, f_3, f_6, f_8) of
    the pool under the base forest."""
    votes = forest_eval.votes(forest, state.x).to(torch.float32)
    T = forest.n_trees
    f1 = div_const(votes, T)
    f2 = scoring.vote_sd(votes, T)
    # valid_mask keeps mesh-padding rows (marked labeled) out of the labeled
    # statistics; a no-op on an unpadded pool.
    labeled = (state.labeled_mask & state.valid_mask).to(torch.float32)
    n_labeled = labeled.sum()
    f3 = (labeled * (state.oracle_y == 1)).sum() / torch.clamp_min(n_labeled, 1.0)
    # The mean forest variance over the unlabeled pool (the reference divides
    # by the unlabeled count, as the training-data generator does).
    unlabeled = 1.0 - labeled
    n_unlabeled = torch.clamp_min(unlabeled.sum(), 1.0)
    f6 = row_sum((f2 * unlabeled)[None])[0] / n_unlabeled
    n = state.n_pool
    return torch.stack([f1, f2, f3.expand(n), f6.expand(n), n_labeled.expand(n)], dim=1)


@register_strategy("lal")
def _lal(cfg: StrategyConfig) -> Strategy:
    """Score = the LAL regressor's predicted error reduction, descending
    (``active_learner.py:319-328``). Needs ``aux.lal_forest``: the loop
    loads or trains one from the strategy's options
    (``models.lal_training.load_or_train_lal_regressor``)."""

    def score(forest, state, key, aux: StrategyAux):
        del key
        if trees_multi.is_multi(forest):
            raise ValueError(
                "the lal strategy is binary-only: its 5 features (positive-"
                "vote fraction, vote SD, positive-label proportion) are "
                "defined over a binary forest (active_learner.py:280-296); "
                "use uncertainty/entropy/margin on multiclass pools"
            )
        if aux.lal_forest is None:
            raise ValueError(
                "LAL strategy needs aux.lal_forest (the pretrained error-"
                "reduction regressor); see models/lal_training.py"
            )
        return forest_eval.value(aux.lal_forest, lal_features(forest, state))

    return Strategy(name="lal", score=score, higher_is_better=True)
