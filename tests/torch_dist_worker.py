"""Rank processes for `tests/test_torch_distributed.py`.

`spawn_ranks(job, tmp, args)` starts two processes (the `spawn` method, one
torch thread each) that join a gloo group through a file under `tmp`, run
`JOBS[job](tmp, *args)` on their rank and save its result as
`tmp/<job>_<rank>.pt` (a traceback as `.err` on failure). It fails if a rank
fails or has not ended within the timeout. This module imports no JAX, so
the ranks start quickly.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback

import torch

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"


def _tiny_cfg(over):
    from xmask3d_tpu_torch.config import load_config

    cfg = load_config(CONFIG)
    cfg.update(over)
    return cfg


def batchnorm_job(tmp):
    """A MaskedBatchNorm in training mode on this rank's rows of a batch:
    its output, the input's gradient of the global sum(y * g) and the
    parameters' local gradients, and the running statistics."""
    from xmask3d_tpu_torch.models.minkunet import MaskedBatchNorm
    from xmask3d_tpu_torch.parallel.mesh import rows_of_rank

    d = torch.load(os.path.join(tmp, "bn_in.pt"))
    bn = MaskedBatchNorm(d["x"].shape[-1])
    bn.load_state_dict(d["state"])
    x = rows_of_rank(d["x"]).clone().requires_grad_()
    y = bn(x, rows_of_rank(d["valid"]))
    (y * rows_of_rank(d["g"])).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "scale_grad": bn.scale.grad,
            "bias_grad": bn.bias.grad, "mean": bn.mean, "var": bn.var}


def train_step_job(tmp, over):
    """One train step of the tiny model on this rank's rows of the saved
    batch and point draws: the step's metrics, AdamW's first moments, the
    parameters and buffers after it."""
    from xmask3d_tpu_torch.engine.builder import build_train_model
    from xmask3d_tpu_torch.engine.train_step import (
        create_train_state, make_optimizer, make_train_step)
    from xmask3d_tpu_torch.parallel.mesh import broadcast_module, rows_of_rank

    d = torch.load(os.path.join(tmp, "step_in.pt"), weights_only=False)
    cfg = _tiny_cfg(over)
    model = build_train_model(cfg, tiny=True, seed=int(os.environ["RANK"]) + 1, device="cpu")
    if int(os.environ["RANK"]) == 0:
        model.load_state_dict(d["state"])
    broadcast_module(model)  # rank 1 built other weights: rank 0's replace them
    state = create_train_state(model, make_optimizer(model, cfg.lr_3d, cfg.lr_others,
                                                     d["total_steps"]))
    metrics = make_train_step(dict(cfg.loss_weight))(
        state, rows_of_rank(d["batch"]), d["statics"], 1.0,
        draws=rows_of_rank(d["draws"], dim=1))
    adam = state.optimizer.adamw.state
    name = {id(p): n for n, p in model.named_parameters()}
    return {"metrics": metrics,
            "mu": {name[id(p)]: adam[m]["exp_avg"] for pairs in state.optimizer.pairs.values()
                   for p, m in pairs},
            "buffers": dict(model.named_buffers())}


def eval_job(tmp, over, n_scenes):
    """`run_eval_scenes` of the tiny eval model over this rank's scenes of
    `n_scenes` synthetic ones: the summary and each scene's meters."""
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_scene
    from xmask3d_tpu_torch.engine import infer_cli
    from xmask3d_tpu_torch.engine.builder import build_model
    from xmask3d_tpu_torch.parallel.mesh import scenes_of_rank

    d = torch.load(os.path.join(tmp, "eval_in.pt"), weights_only=False)
    cfg = _tiny_cfg(over)
    model = build_model(cfg, tiny=True, device="cpu", fused_gn=True)
    model.load_state_dict(d["state"])
    step, route = infer_cli.make_infer_step(model, cfg)
    caps = Capacities(cfg.max_points, cfg.max_voxels, cfg.max_targets)
    ids = scenes_of_rank(n_scenes)
    record = []
    summary = infer_cli.run_eval_scenes(
        [synthetic_scene(caps, seed=100 + i, **d["scene_kw"]) for i in ids], len(ids), cfg=cfg,
        caps=caps, statics=d["statics"], infer_step=step, route_2d=route, device="cpu",
        record=record)
    return {"ids": ids, "summary": summary, "acc": [r["acc"] for r in record]}


def validation_job(tmp, over):
    """`run_validation` of the tiny model over the saved validation batches,
    each rank on its rows of every batch."""
    from xmask3d_tpu_torch.engine.builder import build_train_model
    from xmask3d_tpu_torch.engine.validate import make_validate_step, run_validation
    from xmask3d_tpu_torch.parallel.mesh import rows_of_rank

    d = torch.load(os.path.join(tmp, "val_in.pt"), weights_only=False)
    cfg = _tiny_cfg(over)
    model = build_train_model(cfg, tiny=True, device="cpu")
    model.load_state_dict(d["state"])
    split = cfg.category_split
    return run_validation(make_validate_step(model, cfg), d["statics"],
                          (rows_of_rank(b) for b in d["batches"]), split.base_category,
                          split.novel_category)


def trainer_job(tmp, argv):
    """The trainer's CLI, each rank with its own --save_path."""
    from xmask3d_tpu_torch.engine import train as trainer

    save = os.path.join(tmp, f"run_{os.environ['RANK']}")
    return trainer.main(list(argv) + ["--save_path", save], device="cpu")


JOBS = {"batchnorm": batchnorm_job, "train_step": train_step_job, "eval": eval_job,
        "validation": validation_job, "trainer": trainer_job}


def _rank_main(rank, world, tmp, job, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        from xmask3d_tpu_torch.parallel.mesh import init_distributed

        init_distributed("cpu", init_method=f"file://{os.path.join(tmp, 'rendezvous_' + job)}")
        out = JOBS[job](tmp, *args)
        torch.save(out, os.path.join(tmp, f"{job}_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"{job}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(job, tmp, args=(), world: int = 2, timeout: float = 180.0):
    """Each rank's result of `job`; raises if a rank failed or hung."""
    tmp = str(tmp)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, tmp, job, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(0.1, deadline - time.time()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r in range(world):
        err = os.path.join(tmp, f"{job}_{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{job}: ranks {hung} did not end within {timeout} s; exit codes "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(os.path.join(tmp, f"{job}_{r}.pt"), weights_only=False)
            for r in range(world)]
