"""ResNet-CIFAR with BatchNorm — the paper's own architecture family
(counterpart of ``repro.models.convnet``).

The CIFAR ResNet of He et al.: 3 stages x n blocks, widths 16/32/64,
stride-2 stage transitions, identity shortcuts with zero-padded
channels. The paper's pipeline runs on it end to end (SGD momentum 0.9,
weight decay 5e-4, cosine LR, HWA with H = one epoch), with the
BatchNorm-statistics recompute of Algorithm 2 line 3 (``core.bnstats``).

The leaves are the reference's: HWIO conv weights, NHWC activations,
so a bridged tree, the packed sync buffer and an npz checkpoint need no
transposes. The convolutions run on ``permute`` views (an NHWC tensor
seen as NCHW is ``channels_last``, which cuDNN takes as it is). Two
points where PyTorch's defaults differ from the reference:

- ``padding="SAME"`` at stride 2 on an even input pads 0 before and 1
  after (XLA's rule: the total ``(out - 1)·s + k - n`` split with the
  smaller half first); ``F.conv2d(padding=1)`` would pad 1 on both sides
  and read other pixels. :func:`_conv` pads explicitly.
- BatchNorm's batch variance is the biased one (``jnp.var``), and the
  running state is ``0.9·old + 0.1·batch`` of it. The statistics are
  computed here; ``F.batch_norm``'s running update (unbiased variance)
  is not used.

API (BN has running state, so this is not the LM API)::

    params, bn_state = init_resnet(cfg, gen, device=...)
    logits, new_bn_state = apply_resnet(cfg, params, bn_state, x, train=True)
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.types import ModelConfig

BN_MOMENTUM = 0.9


def resnet_cifar_config(depth: int = 20, n_classes: int = 10,
                        image_size: int = 32) -> ModelConfig:
    if (depth - 2) % 6:
        raise ValueError(f"CIFAR ResNet depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    return ModelConfig(
        name=f"resnet{depth}-cifar", family="convnet", n_layers=depth,
        d_model=64, n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=n_classes,
        widths=(16, 32, 64), blocks_per_stage=n, image_size=image_size,
        n_classes=n_classes, dtype="float32",
        source="[He et al. 2016; paper §V]")


def _conv_init(gen, k, cin, cout, device):
    fan_in = k * k * cin
    return torch.randn((k, k, cin, cout), generator=gen, device=device) \
        * math.sqrt(2.0 / fan_in)


def _bn_init(c, device):
    params = {"scale": torch.ones((c,), device=device),
              "bias": torch.zeros((c,), device=device)}
    state = {"mean": torch.zeros((c,), device=device),
             "var": torch.ones((c,), device=device)}
    return params, state


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: (before, after)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """``SAME`` convolution, x NHWC, w HWIO -> NHWC."""
    k = w.shape[0]
    (ht, hb), (wl, wr) = (_same_pads(x.shape[1], k, stride),
                          _same_pads(x.shape[2], k, stride))
    if ht == hb and wl == wr:
        pad = (ht, wl)
    else:
        x = F.pad(x, (0, 0, wl, wr, ht, hb))
        pad = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _bn(p, s, x, train: bool, eps=1e-5):
    if train:
        mean = x.mean((0, 1, 2))
        var = torch.square(x - mean).mean((0, 1, 2))
        new_s = {"mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean,
                 "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    y = (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y, new_s


def init_resnet(cfg: ModelConfig, gen: torch.Generator, device=None):
    """(params, bn_state) drawn from ``gen`` on ``device``; the draws
    differ from the reference's threefry streams (parity tests bridge
    its tree)."""
    widths = cfg.widths
    n = cfg.blocks_per_stage
    params, state = {}, {}
    params["stem"] = _conv_init(gen, 3, 3, widths[0], device)
    params["stem_bn"], state["stem_bn"] = _bn_init(widths[0], device)
    cin = widths[0]
    for si, w in enumerate(widths):
        for bi in range(n):
            blk, blk_state = {}, {}
            blk["conv1"] = _conv_init(gen, 3, cin, w, device)
            blk["bn1"], blk_state["bn1"] = _bn_init(w, device)
            blk["conv2"] = _conv_init(gen, 3, w, w, device)
            blk["bn2"], blk_state["bn2"] = _bn_init(w, device)
            params[f"s{si}b{bi}"], state[f"s{si}b{bi}"] = blk, blk_state
            cin = w
    params["fc_w"] = torch.randn((widths[-1], cfg.n_classes), generator=gen,
                                 device=device) / math.sqrt(widths[-1])
    params["fc_b"] = torch.zeros((cfg.n_classes,), device=device)
    return params, state


def apply_resnet(cfg: ModelConfig, params, bn_state, x, train: bool = True):
    """x: (N, H, W, 3) f32 -> (logits (N, n_classes), new bn_state)."""
    new_state = {}
    h = _conv(x, params["stem"])
    h, new_state["stem_bn"] = _bn(params["stem_bn"], bn_state["stem_bn"], h,
                                  train)
    h = torch.relu(h)
    for si, w in enumerate(cfg.widths):
        for bi in range(cfg.blocks_per_stage):
            name = f"s{si}b{bi}"
            blk, blk_s = params[name], bn_state[name]
            stride = 2 if (si > 0 and bi == 0) else 1
            ns = {}
            y = _conv(h, blk["conv1"], stride)
            y, ns["bn1"] = _bn(blk["bn1"], blk_s["bn1"], y, train)
            y = torch.relu(y)
            y = _conv(y, blk["conv2"])
            y, ns["bn2"] = _bn(blk["bn2"], blk_s["bn2"], y, train)
            if stride != 1 or h.shape[-1] != w:
                # identity shortcut: stride-2 subsample + zero-pad channels
                sc = h[:, ::stride, ::stride]
                sc = F.pad(sc, (0, w - sc.shape[-1]))
            else:
                sc = h
            h = torch.relu(y + sc)
            new_state[name] = ns
    h = h.mean((1, 2))
    return h @ params["fc_w"] + params["fc_b"], new_state


def resnet_loss(cfg, params, bn_state, batch, train: bool = True):
    """Mean cross-entropy of ``batch["tokens"]`` (images) against
    ``batch["targets"]``; metrics carry the loss, the accuracy and the
    new BN state."""
    logits, new_state = apply_resnet(cfg, params, bn_state,
                                     batch["tokens"], train)
    targets = batch["targets"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, targets[:, None]).mean()
    acc = (logits.argmax(-1) == targets).float().mean()
    return loss, {"loss": loss, "acc": acc, "bn_state": new_state}
