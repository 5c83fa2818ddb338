"""Rank processes for `tests/test_torch_distributed.py`,
`tests/test_torch_tensor_parallel.py` and `tests/test_torch_act_sharding.py`.

`spawn_ranks(job, tmp, args, world)` starts `world` processes (two by
default; the `spawn` method, one torch thread each) that join a gloo group
through a file under `tmp`, run `JOBS[job](tmp, *args)` on their rank and
save its result as `tmp/<job>_<rank>.pt` (a traceback as `.err` on
failure). It fails if a rank fails or has not ended within the timeout.
This module imports no JAX, so the ranks start quickly.
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


def load_jax_sharded(model, variables):
    """Fill a sharded model straight from the JAX `{params, batch_stats}`
    tree (numpy): each leaf through the weight bridge's rule, then this
    rank's slice of it where the model holds one (`shard_tensor`, by the
    tensor-parallel rules' layout)."""
    import numpy as np

    from xmask3d_tpu_torch.checkpoint.from_jax import _flatten, bridge_tensors
    from xmask3d_tpu_torch.parallel.tensor import shard_tensor, sharded_tensors

    flat = {col: _flatten(variables.get(col, {})) for col in ("params", "batch_stats")}
    names = {id(m): n for n, m in model.named_modules()}
    shards = sharded_tensors(model)
    with torch.no_grad():
        for col, path, mod, name, t, fn in bridge_tensors(model):
            arr = flat[col].pop(path)
            full = torch.from_numpy(np.array(fn(arr) if fn is not None else arr))
            key = f"{names[id(mod)]}.{name}" if names[id(mod)] else name
            t.copy_(shard_tensor(full, *shards[key]) if key in shards else full)
    left = [p for col in flat.values() for p in col]
    if left:
        raise KeyError(f"JAX leaves the model did not take: {left[:8]}")


TP_OUTPUTS = ("pred_logits", "fused_pred_feature", "2d_pred_feature", "pure3d_pred_feature",
              "mask_embed_clip", "binary_sig", "pred_scores", "pred_masks", "final_mask_3d",
              "pred_labels", "final_mask_valid", "binary_pred", "covered")


def tp_forward(tmp, over, mesh):
    """The tiny eval model's forward on `mesh`, the sharded model filled
    straight from the saved JAX variables (`load_jax_sharded`)."""
    from xmask3d_tpu_torch.engine.builder import build_model
    from xmask3d_tpu_torch.parallel.tensor import shard_params

    d = torch.load(os.path.join(tmp, "tp_fwd_in.pt"), weights_only=False)
    model = shard_params(build_model(_tiny_cfg(over), tiny=True, device="cpu"), mesh)
    load_jax_sharded(model, d["variables"])
    with torch.no_grad():
        out = model.eval_forward(d["batch"], d["statics"])
    return {k: out[k] for k in TP_OUTPUTS}


def _first_moments(state, whole):
    """{parameter name: AdamW's first moment}, each sharded one made whole
    (`whole`) or left as this rank's slice."""
    from xmask3d_tpu_torch.parallel.tensor import gather_tensor, sharded_tensors

    shards = sharded_tensors(state.model)
    adam = state.optimizer.adamw.state
    name = {id(p): n for n, p in state.model.named_parameters()}
    out = {}
    for pairs in state.optimizer.pairs.values():
        for p, m in pairs:
            n = name[id(p)]
            mu = adam[m]["exp_avg"]
            out[n] = gather_tensor(mu, *shards[n]) if whole and n in shards else mu.clone()
    return out


def tp_step_job(tmp, over, data_axis, model_axis, round_trip):
    """One train step of the tiny model on a (data_axis, model_axis) mesh:
    every rank builds the model from its own seed, takes rank 0's weights,
    keeps its slices and steps on its data rank's rows of the saved batch
    and draws. Returns the metrics, the first moments made whole and as
    held (`local`), the buffers and the sharded tensors' layouts. With
    `round_trip`: the eval forward (`tp_forward`) and
    `gather_params(shard_params(m))` against the state dict first; after
    the step, a checkpoint saved under this mesh (rank 0
    writes tmp/ckpt_tp) with the whole masters and moments, then the
    one-process checkpoint tmp/ckpt_one restored (the slices it gives) and
    one more step from it on the `draws2`."""
    from xmask3d_tpu_torch.checkpoint.torch_io import Checkpointer
    from xmask3d_tpu_torch.engine.builder import build_train_model
    from xmask3d_tpu_torch.engine.train_step import (
        create_train_state, make_optimizer, make_train_step)
    from xmask3d_tpu_torch.parallel.mesh import broadcast_module, create_mesh, rows_of_rank
    from xmask3d_tpu_torch.parallel.tensor import (
        gather_params, gather_tensor, shard_params, sharded_tensors)

    d = torch.load(os.path.join(tmp, "tp_step_in.pt"), weights_only=False)
    cfg = _tiny_cfg(over)
    mesh = create_mesh(data_axis, model_axis)
    model = build_train_model(cfg, tiny=True, seed=int(os.environ["RANK"]) + 1, device="cpu")
    if int(os.environ["RANK"]) == 0:
        model.load_state_dict(d["state"])
    broadcast_module(model)
    out = {"mesh": mesh.shape, "data_rank": mesh.data_rank, "model_rank": mesh.model_rank}
    if round_trip:
        out["forward"] = tp_forward(tmp, over, mesh)
        whole = {k: v.clone() for k, v in model.state_dict().items()}
        gathered = gather_params(shard_params(model, mesh)).state_dict()
        out["round_trip_equal"] = gathered.keys() == whole.keys() and all(
            torch.equal(v, whole[k]) and v.dtype == whole[k].dtype for k, v in gathered.items())
    shard_params(model, mesh)
    out["sharded"] = sharded_tensors(model)
    state = create_train_state(model, make_optimizer(model, cfg.lr_3d, cfg.lr_others,
                                                     d["total_steps"]))
    step = make_train_step(dict(cfg.loss_weight))
    batch = rows_of_rank(d["batch"])
    out["metrics"] = step(state, batch, d["statics"], 1.0, draws=rows_of_rank(d["draws"], dim=1))
    out["mu"] = _first_moments(state, whole=True)
    out["local"] = _first_moments(state, whole=False)
    out["buffers"] = {k: v.clone() for k, v in model.named_buffers()}
    if round_trip:
        Checkpointer(os.path.join(tmp, "ckpt_tp")).save(1, state, best_iou=0.25)
        shards = sharded_tensors(model)
        name = {id(p): n for n, p in model.named_parameters()}
        adam = state.optimizer.adamw.state
        masters = {name[id(p)]: m for pairs in state.optimizer.pairs.values() for p, m in pairs}
        out["saved"] = {n: [gather_tensor(t, *shards[n]) if n in shards else t.detach().clone()
                            for t in (m, adam[m]["exp_avg"], adam[m]["exp_avg_sq"])]
                        for n, m in masters.items()}
        state, _ = Checkpointer(os.path.join(tmp, "ckpt_one")).restore(state)
        adam = state.optimizer.adamw.state  # restored as new tensors
        out["restored"] = {n: [t.detach().clone() for t in (m, adam[m]["exp_avg"],
                                                             adam[m]["exp_avg_sq"])]
                           for n, m in masters.items()}
        out["restored_step"] = state.step
        out["metrics2"] = step(state, batch, d["statics"], 1.0,
                               draws=rows_of_rank(d["draws2"], dim=1))
        out["mu2"] = _first_moments(state, whole=True)
    return out


def _unet_loss(out):
    eps, taps = out
    return eps.square().sum() + sum(t.square().sum() for t in taps)


def _unet_grads(unet, d, mesh, tp=False):
    """The UNet's full forward at the 16^2 latent under bands and its
    sum-of-squares loss's gradients: every parameter's (summed over the
    model group by `reduce_band_grads`; a sharded slice made whole), and
    `context`'s and `cond_emb`'s."""
    from xmask3d_tpu_torch.parallel.spatial import activation_sharding, reduce_band_grads
    from xmask3d_tpu_torch.parallel.tensor import gather_tensor, sharded_tensors

    unet.zero_grad(set_to_none=True)
    ctx = d["ctx16"].clone().requires_grad_()
    cond = d["cond16"].clone().requires_grad_()
    with activation_sharding(mesh):
        _unet_loss(unet(d["x16"], d["t16"], ctx, cond, full=True)).backward()
        summed = reduce_band_grads(unet)
    shards = sharded_tensors(unet) if tp else {}
    grads = {n: (gather_tensor(p.grad, *shards[n], mesh) if n in shards else p.grad.clone())
             for n, p in unet.named_parameters()}
    return {"params": grads, "context": ctx.grad, "cond_emb": cond.grad, "summed": summed}


def act_shard_job(tmp):
    """Every case of `tests/test_torch_act_sharding.py` on a (1, 2) mesh:
    the UNet's full forward at 32^2 in bands; its gradients at 16^2 with
    remat off and on, and with `shard_params` too (once more with the
    reduce-scatter and all-to-all in the all-reduce and all-gather forms
    that gloo runs on CUDA tensors); the VAE encode at 64^2 plain and with
    `fused_gn` (with its parameters' gradients); what runs replicated (a
    7-row latent, an 8^2 UNet latent, sharding off); the tiny train step
    with `shard_params` and bands."""
    from xmask3d_tpu_torch.engine.builder import build_train_model
    from xmask3d_tpu_torch.engine.train_step import (
        create_train_state, make_optimizer, make_train_step)
    from xmask3d_tpu_torch.models.layers import set_remat
    from xmask3d_tpu_torch.models.sd_unet import SDUNet, UNET_TINY
    from xmask3d_tpu_torch.models.vae import AutoencoderKL, VAE_TINY
    from xmask3d_tpu_torch.parallel import spatial
    from xmask3d_tpu_torch.parallel.mesh import create_mesh
    from xmask3d_tpu_torch.parallel.spatial import activation_sharding, shard_spatial
    from xmask3d_tpu_torch.parallel.tensor import shard_params

    d = torch.load(os.path.join(tmp, "act_in.pt"), weights_only=False)
    mesh = create_mesh(1, 2)
    out = {}
    unet = SDUNet(UNET_TINY)
    unet.load_state_dict(d["unet"])
    with torch.no_grad(), activation_sharding(mesh):
        out["unet32"] = unet(d["x32"], d["t32"], d["ctx32"], full=True)
        out["unet8"] = unet(d["x32"][:, :8, :8], d["t32"], d["ctx32"], full=True)
        out["shard7"] = shard_spatial(d["x32"][:, :7])
    with torch.no_grad():
        out["unet32_off"] = unet(d["x32"], d["t32"], d["ctx32"], full=True)
    out["grads"] = _unet_grads(unet, d, mesh)
    set_remat(unet, True)
    out["grads_remat"] = _unet_grads(unet, d, mesh)
    shard_params(unet, mesh)
    out["sliced"] = len({id(getattr(m, n)) for m in unet.modules() if hasattr(m, "shard_dims")
                         for n in m.shard_dims()})
    out["grads_tp"] = _unet_grads(unet, d, mesh, tp=True)
    native = spatial._gloo_cuda
    spatial._gloo_cuda = lambda t, m: True
    try:
        out["grads_tp_gloo_cuda_forms"] = _unet_grads(unet, d, mesh, tp=True)
    finally:
        spatial._gloo_cuda = native
    del unet

    for fused in (False, True):
        vae = AutoencoderKL(VAE_TINY, fused_gn=fused)
        vae.load_state_dict(d["vae"])
        with torch.no_grad(), activation_sharding(mesh):
            out[f"encode_{fused}"] = vae.encode(d["img64"])
            out[f"decode7_{fused}"] = vae.decode(d["lat7"])
        if fused:
            with activation_sharding(mesh):
                latent, taps = vae.encode(d["img64"])
                (latent.square().sum() + sum(t.square().sum() for t in taps)).backward()
                spatial.reduce_band_grads(vae.encoder)  # quant_conv reads the gathered map
            out["encode_grads"] = {n: p.grad for n, p in vae.named_parameters()
                                   if p.grad is not None}

    cfg = _tiny_cfg(d["over"])
    model = build_train_model(cfg, tiny=True, seed=int(os.environ["RANK"]) + 1, device="cpu")
    model.load_state_dict(d["state"])
    shard_params(model, mesh)
    state = create_train_state(model, make_optimizer(model, cfg.lr_3d, cfg.lr_others,
                                                     d["total_steps"]))
    with activation_sharding(mesh):
        out["metrics"] = make_train_step(dict(cfg.loss_weight))(
            state, d["batch"], d["statics"], 1.0, draws=d["draws"])
    out["mu"] = _first_moments(state, whole=True)
    out["buffers"] = {k: v.clone() for k, v in model.named_buffers()}
    return out


JOBS = {"tp_step": tp_step_job, "act_shard": act_shard_job,
        "batchnorm": batchnorm_job, "train_step": train_step_job, "eval": eval_job,
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
