"""The paper's own protocol: ResNet-CIFAR + BatchNorm + SGD (momentum 0.9,
weight decay 5e-4) + cosine LR + HWA with H = one epoch, including
Algorithm 2's BatchNorm-statistics recompute under W̿ (counterpart of the
JAX package's ``examples/resnet_cifar_hwa.py``), on the synthetic
prototype-image task.

  PYTHONPATH=src python -m repro_torch.launch.resnet_cifar --device cpu \
      --epochs 6 [--depth 8 --k 2 --window 3 --batch-size 32]

Runs on the card unless ``--device cpu``. Each epoch: every replica
steps on its own batches, ``hwa_sync`` at the epoch's end, the BN
statistics recomputed under W̿ over the first 1,024 training images (in
batches of 256), then W̿'s test accuracy, with the recomputed
statistics and with the averaged running state it would have without
the recompute. The BN running state rides in the averaged tree
(``{"p": params, "bn": state}``) as in the reference: the inner steps
leave it to weight decay alone, and the recompute replaces it.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from repro_torch.core.bnstats import recompute_bn_stats
from repro_torch.core.hwa import HWAConfig, hwa_init, hwa_inner_step, \
    hwa_sync
from repro_torch.data import make_prototype_image_dataset, \
    replica_batch_indices
from repro_torch.device import resolve_device
from repro_torch.models.convnet import (apply_resnet, init_resnet,
                                        resnet_cifar_config, resnet_loss)
from repro_torch.optim import cosine_schedule, sgd

#: the recompute's pass: the first BN_IMAGES training images, BN_BATCH at
#: a time (the reference's example)
BN_IMAGES, BN_BATCH = 1024, 256
#: the reference example's fixed settings: 10 classes, image noise 0.6,
#: 5% of the training labels flipped; SGD momentum 0.9, weight decay
#: 5e-4, a cosine LR from 0.1 over the run; dataset and init from seed 0,
#: the batch order from seed 1
N_CLASSES, NOISE, LABEL_NOISE = 10, 0.6, 0.05
LR, MOMENTUM, WEIGHT_DECAY = 0.1, 0.9, 5e-4
SEED, DATA_SEED = 0, 1


@dataclasses.dataclass(frozen=True)
class ResNetCifarConfig:
    """The run; the defaults are the reference example's."""
    depth: int = 8
    epochs: int = 6
    k: int = 2                       # HWA replicas K
    window: int = 3                  # I
    batch_size: int = 32             # per replica
    image_size: int = 16
    n_train: int = 2048
    n_test: int = 512
    use_kernels: bool = False        # the fused sync kernel


def _sync_device(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_resnet_cifar(rc: ResNetCifarConfig, device=None, *,
                       log=print) -> dict:
    """Run the protocol. Returns the per-epoch history (mean training
    loss, W̿'s test accuracy with and without the recompute, replica
    divergence), the per-step losses, the wall times of every replica
    step, sync and recompute (ms, the device synchronized) and the final
    HWA state and recomputed BN state."""
    dev = resolve_device(device)
    cfg = resnet_cifar_config(depth=rc.depth, n_classes=N_CLASSES,
                              image_size=rc.image_size)
    ds = make_prototype_image_dataset(
        n_classes=N_CLASSES, image_size=rc.image_size, n_train=rc.n_train,
        n_test=rc.n_test, noise=NOISE, label_noise=LABEL_NOISE, seed=SEED,
        device=dev)
    steps_per_epoch = ds.n_train // rc.batch_size
    total_steps = steps_per_epoch * rc.epochs
    opt = sgd(momentum=MOMENTUM, weight_decay=WEIGHT_DECAY)
    sched = cosine_schedule(LR, total_steps)
    hcfg = HWAConfig(n_replicas=rc.k, sync_period=steps_per_epoch,
                     window=rc.window, use_kernels=rc.use_kernels)
    params, bn_state = init_resnet(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    state = hwa_init(hcfg, {"p": params, "bn": bn_state}, opt)
    del params, bn_state

    def loss_fn(bundle, batch):
        return resnet_loss(cfg, bundle["p"], bundle["bn"], batch)

    def batches_at(step):
        idx = [replica_batch_indices(DATA_SEED, r, step, ds.n_train,
                                     rc.batch_size, device=dev)
               for r in range(rc.k)]
        return {"tokens": torch.stack([ds.train_inputs[i] for i in idx]),
                "targets": torch.stack([ds.train_targets[i] for i in idx])}

    @torch.no_grad()
    def accuracy(p, bn):
        logits, _ = apply_resnet(cfg, p, bn, ds.test_inputs, train=False)
        return float((logits.argmax(-1) == ds.test_targets).float().mean())

    history, losses = [], []
    times = {"step_ms": [], "sync_ms": [], "bn_ms": []}
    bn = None
    for step in range(total_steps):
        batches = batches_at(step)
        _sync_device(dev)
        t0 = time.perf_counter()
        state, metrics = hwa_inner_step(hcfg, state, batches, loss_fn, opt,
                                        sched(step))
        _sync_device(dev)
        times["step_ms"].append((time.perf_counter() - t0) * 1e3 / rc.k)
        losses.append(metrics["loss"])
        if (step + 1) % steps_per_epoch:
            continue
        t0 = time.perf_counter()
        state, m = hwa_sync(hcfg, state)
        _sync_device(dev)
        times["sync_ms"].append((time.perf_counter() - t0) * 1e3)
        wa = state.wa
        t0 = time.perf_counter()
        # Algorithm 2 line 3: recompute the BN statistics under W̿
        bn = recompute_bn_stats(cfg, wa["p"], wa["bn"],
                                [ds.train_inputs[i:i + BN_BATCH]
                                 for i in range(0, min(BN_IMAGES,
                                                       ds.n_train),
                                                BN_BATCH)])
        _sync_device(dev)
        times["bn_ms"].append((time.perf_counter() - t0) * 1e3)
        epoch_losses = torch.stack(losses[-steps_per_epoch:])
        rec = {"epoch": (step + 1) // steps_per_epoch,
               "train_loss": float(epoch_losses.mean()),
               "wa_acc": accuracy(wa["p"], bn),
               "wa_acc_stale_bn": accuracy(wa["p"], wa["bn"]),
               "replica_divergence": float(m["replica_divergence"])}
        history.append(rec)
        log(f"epoch {rec['epoch']}: train loss {rec['train_loss']:.4f}  "
            f"W̿ test acc {rec['wa_acc']:.4f} (without the BN recompute "
            f"{rec['wa_acc_stale_bn']:.4f})  replica divergence "
            f"{rec['replica_divergence']:.3f}")
    return {"history": history, "losses": [float(x) for x in losses],
            "times": times, "state": state, "bn": bn,
            "median_step_ms": statistics.median(times["step_ms"])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--window", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rc = ResNetCifarConfig(depth=args.depth, epochs=args.epochs, k=args.k,
                           window=args.window, batch_size=args.batch_size)
    out = train_resnet_cifar(rc, args.device)
    dev = resolve_device(args.device)
    print(f"[resnet_cifar] resnet{rc.depth} K{rc.k} I{rc.window} on {dev}: "
          f"final W̿ test acc {out['history'][-1]['wa_acc']:.4f}, median "
          f"replica step {out['median_step_ms']:.2f} ms")


if __name__ == "__main__":
    main()
