"""BatchNorm-statistics recompute (paper Algorithm 2, line 3; counterpart
of ``repro.core.bnstats``).

After forming the averaged weights W̿ the BN running statistics belong to
no trained model. The SWA/HWA fix: one pass over training batches under
W̿, averaging the batch means and variances. Only the ResNet-CIFAR config
carries BN; the transformer archs' norms are stateless.
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_map
from repro_torch.models.convnet import BN_MOMENTUM, apply_resnet


@torch.no_grad()
def recompute_bn_stats(cfg, params, bn_state_template, batches):
    """Average the batch statistics observed under ``params``.

    ``batches`` is an iterable of NHWC inputs. Returns a fresh bn_state:
    the mean of the batch means and of the batch variances. Each batch's
    statistic is read back from a ``train=True`` apply as the reference
    reads it, ``(new − m·old)/(1 − m)`` with m = ``BN_MOMENTUM``, so the
    rounding is the reference's."""
    acc = tree_map(torch.zeros_like, bn_state_template)
    n = 0
    for x in batches:
        _, new_state = apply_resnet(cfg, params, bn_state_template, x,
                                    train=True)
        stats = tree_map(
            lambda new, old: (new - BN_MOMENTUM * old) / (1.0 - BN_MOMENTUM),
            new_state, bn_state_template)
        acc = tree_map(torch.add, acc, stats)
        n += 1
    if n == 0:
        return bn_state_template
    return tree_map(lambda a: a / n, acc)
