"""Training entry point.

Counterpart of `xmask3d_tpu/engine/train.py` on one device: config and
overrides, seeding, the two-group AdamW train step, the contra-loss warm-up
gate (`start_contra`), per-step learning rates, metric logging every
`print_freq` steps, validation every `eval_freq` epochs and checkpoints
every `save_freq` epochs, and `--resume`.

    python -m xmask3d_tpu_torch.engine.train \\
        --config configs/scannet/xmask3d_scannet_B15N4.yaml --synthetic \\
        batch_size 2 epochs 1 steps_per_epoch 3

Runs on the GPU; `main(argv, device="cpu")` runs the plain versions of the
kernels on the CPU (with `--tiny` for a model of that size). Synthetic
runs draw the train and validation streams from distinct seeds;
`synthetic_points` sets the points of a synthetic view (2000 by default).
On real data `workers` threads build the train batches ahead of the step
(`make_data_iter`).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from xmask3d_tpu_torch.config import Config, load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.prefetch import parallel_map_iterator, to_device
from xmask3d_tpu_torch.device import resolve_device
from xmask3d_tpu_torch.engine.builder import (
    build_statics,
    build_train_model,
    capacities_from_cfg,
    data_tokenizer,
)
from xmask3d_tpu_torch.engine.train_step import create_train_state, make_optimizer, make_train_step
from xmask3d_tpu_torch.engine.validate import make_validate_step, run_validation
from xmask3d_tpu_torch.checkpoint.torch_io import Checkpointer
from xmask3d_tpu_torch.utils.logging import MetricsWriter, get_logger

logger = get_logger()

# config keys the JAX trainer obeys and this one does not: what it does
# instead, and the ROADMAP item that ports the key
UNHONOURED_KEYS = {
    "mesh_shape": "the step runs on one device; distribution is ROADMAP A 6",
    "donate_state": "the step updates parameters, masters and optimizer state in place "
                    "whatever its value, so there is nothing to donate and no ROADMAP item",
    "remat_backbone": "the SD backbone keeps its activations (no block remat); "
                      "ROADMAP A 7",
}


def log_unhonoured_keys(cfg: Config) -> None:
    """One warning for each key of UNHONOURED_KEYS the config sets."""
    for key, why in UNHONOURED_KEYS.items():
        if key in cfg:
            logger.warning(f"config key {key} = {cfg[key]!r} is not honoured: {why}")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("xmask3d_tpu_torch training")
    p.add_argument("--config", required=True)
    p.add_argument("--save_path", default="runs/default")
    p.add_argument("--resume", default="",
                   help="any non-empty value: continue from the latest checkpoint under "
                        "--save_path")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic data (no ScanNet assets needed)")
    p.add_argument("--tiny", action="store_true", help="tiny model variant (smoke runs)")
    p.add_argument("--allow_hash_tokenizer", action="store_true",
                   help="permit the HashTokenizer fallback on real data "
                        "(from-scratch runs only; incompatible with pretrained CLIP weights)")
    p.add_argument("opts", nargs="*", help="KEY VALUE override pairs")
    return p


def make_data_iter(cfg: Config, caps: Capacities, synthetic: bool, tiny: bool = False,
                   split: str = "train", allow_hash_tokenizer: bool = False, device=None):
    """(batch iterator, samples per epoch or None for synthetic data, the
    ScanNetViews dataset or None). The trainer sets `.epoch` on the val
    dataset before each validation pass (deterministic view iteration).

    With `workers` > 0 the train split of real data is built by that many
    threads (`data/prefetch.py`), as the JAX trainer does: this thread hands
    out each batch's indices with one seed drawn from the loader's rng, the
    batch draws its views and grid jitter from that seed alone, and the
    workers build CPU tensors that this thread pins and copies to `device`.
    So any worker count gives the same batches; `workers` 0 builds them
    serially from the loader's rng, as the JAX loader does. Synthetic
    streams and validation stay serial."""
    if synthetic:
        from xmask3d_tpu_torch.data.synthetic import synthetic_batch

        kw = dict(num_points=cfg.get("synthetic_points", 2000))
        if tiny:
            kw = dict(num_points=400, image_size=(64, 64), mask_shape=tuple(cfg.mask_shape),
                      context_length=16, vocab_size=512)
        # the val stream is never the train stream
        seed0 = 0 if split == "train" else 1_000_000

        def it():
            seed = seed0
            while True:
                yield synthetic_batch(cfg.batch_size, caps, seed=seed, num_classes=cfg.classes,
                                      device=device, **kw)
                seed += 1

        return it(), None, None

    from xmask3d_tpu_torch.data.scannet import ScanNetConfig, ScanNetViews
    from xmask3d_tpu_torch.data.tokenizer import require_real_tokenizer

    train = split == "train"
    cs = cfg.category_split
    ds_cfg = ScanNetConfig(
        data_root=cfg.data_root, data_root_2d=cfg.data_root_2d, caption_path=cfg.caption_path,
        label_2d=cfg.label_2d, base_category=cs.base_category,
        novel_category=cs.novel_category, ignore_category=cs.ignore_category,
        voxel_size=cfg.voxel_size, split=split, aug=cfg.aug if train else False,
        loop=cfg.loop if train else 1, input_color=cfg.input_color, scannet200=cfg.scannet200,
    )
    tok = data_tokenizer(cfg, tiny=tiny)
    require_real_tokenizer(tok, allow_hash_tokenizer)
    ds = ScanNetViews(ds_cfg, caps, tok, seed=cfg.manual_seed)
    order = np.random.RandomState(cfg.manual_seed).permutation(len(ds))

    def index_iter():
        i = 0
        while True:
            yield [order[(i + k) % len(order)] for k in range(cfg.batch_size)]
            i += cfg.batch_size

    workers = int(cfg.get("workers", 0))
    if workers > 0 and train:
        dev = resolve_device(device)

        def seeded():
            for idx in index_iter():
                yield idx, int(ds.rng.randint(2**31 - 1))

        built = parallel_map_iterator(lambda a: ds.batch(a[0], device="cpu", seed=a[1]),
                                      seeded(), workers)
        return (to_device(b, dev) for b in built), len(order), ds
    return (ds.batch(idx, device=device) for idx in index_iter()), len(order), ds


def val_batch_count(val_samples, batch_size: int, val_batches_default: int = 4) -> int:
    """Batches a validation pass: all of a real split, ceil(|val| / batch);
    synthetic runs (val_samples None) take `val_batches`."""
    if val_samples is not None:
        return max(1, -(-val_samples // batch_size))
    return val_batches_default


def main(argv=None, device=None):
    """Train; returns {"step", "best_iou", "last_metrics", "val"} of the run."""
    args = get_parser().parse_args(argv)
    dev = resolve_device(device)
    cfg = load_config(args.config, args.opts)
    caps = capacities_from_cfg(cfg)
    log_unhonoured_keys(cfg)
    np.random.seed(cfg.manual_seed)
    torch.manual_seed(cfg.manual_seed)

    data, n_samples, _ = make_data_iter(cfg, caps, args.synthetic, tiny=args.tiny,
                                        allow_hash_tokenizer=args.allow_hash_tokenizer,
                                        device=dev)
    logger.info("=> creating model ...")
    model = build_train_model(cfg, tiny=args.tiny, seed=cfg.manual_seed, device=dev)
    statics = build_statics(model, cfg, device=dev)

    # epoch length from the dataset (its `loop` included); synthetic runs
    # take the steps_per_epoch knob
    if n_samples is not None:
        steps_per_epoch = max(1, n_samples // cfg.batch_size)
    else:
        steps_per_epoch = max(1, cfg.get("steps_per_epoch", 100))
    total_steps = cfg.epochs * steps_per_epoch
    optimizer = make_optimizer(model, cfg.lr_3d, cfg.lr_others, total_steps,
                               schedule=cfg.learning_rate_type, power=cfg.power)
    state = create_train_state(model, optimizer, seed=cfg.manual_seed)
    train_step = make_train_step(dict(cfg.loss_weight))

    ckpt = Checkpointer(os.path.join(args.save_path, "model"))
    start_epoch, best_iou = cfg.start_epoch, 0.0
    if args.resume:
        state, meta = ckpt.restore(state)
        start_epoch = meta["step"] // steps_per_epoch
        best_iou = float(meta.get("best_iou", 0.0))
        logger.info(f"resumed from step {meta['step']} (best_iou {best_iou:.4f})")

    writer = MetricsWriter(args.save_path)
    val_data = val_ds = validate_step = None
    if cfg.evaluate:
        val_data, val_samples, val_ds = make_data_iter(
            cfg, caps, args.synthetic, tiny=args.tiny, split="val",
            allow_hash_tokenizer=args.allow_hash_tokenizer, device=dev)
        validate_step = make_validate_step(model, cfg)

    metrics, summary = {}, {}
    for epoch in range(start_epoch, cfg.epochs):
        contra_on = 1.0 if (cfg.mask_contra_3d and epoch >= cfg.start_contra) else 0.0
        t_data = t_step = 0.0
        for it in range(steps_per_epoch):
            t0 = time.time()
            batch = next(data)
            t1 = time.time()
            metrics = train_step(state, batch, statics, contra_on)
            float(metrics["loss_total"])  # waits for the step
            t_data += t1 - t0
            t_step += time.time() - t1
            if state.step % cfg.print_freq == 0:
                host = _host(metrics)
                inter = metrics["metric_train_inter"].cpu().numpy()
                union = metrics["metric_train_union"].cpu().numpy()
                host["train_mIoU"] = float((inter / np.maximum(union, 1e-10)).mean())
                logger.info(f"epoch {epoch} it {it} step {state.step} "
                            f"loss {host['loss_total']:.4f} mIoU {host['train_mIoU']:.3f} "
                            f"data {t_data:.1f}s step {t_step:.1f}s")
                writer.add_scalars(host, state.step, prefix="train/")
        if cfg.evaluate and (epoch + 1) % cfg.eval_freq == 0:
            if val_ds is not None:
                val_ds.epoch = epoch - 1  # deterministic val-view iteration
            n_val = val_batch_count(val_samples, cfg.batch_size, cfg.get("val_batches", 4))
            summary = run_validation(validate_step, statics, (next(val_data) for _ in range(n_val)),
                                     cfg.category_split.base_category,
                                     cfg.category_split.novel_category)
            logger.info(f"val epoch {epoch}: {summary}")
            writer.add_scalars(summary, state.step, prefix="val/")
            best_iou = max(best_iou, summary.get("hIoU", 0.0))
        if (epoch + 1) % cfg.save_freq == 0:
            ckpt.save(state.step, state, best_iou=best_iou)
            logger.info(f"saved checkpoint at step {state.step} (best_iou {best_iou:.4f})")
    writer.close()
    return {"step": state.step, "best_iou": best_iou, "last_metrics": _host(metrics),
            "val": summary}


def _host(metrics):
    """The loggable scalars of a step's metrics: the final layer's losses,
    the total and the gradient norms, as floats."""
    return {k: float(v) for k, v in metrics.items()
            if not k.startswith(("loss_ce_", "loss_mask_", "loss_dice_", "metric_"))}


if __name__ == "__main__":
    main()
