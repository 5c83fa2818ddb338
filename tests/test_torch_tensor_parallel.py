"""Tensor parallelism of the dense towers (`xmask3d_tpu_torch/parallel/
tensor.py`, the `model` axis of `parallel/mesh.py`) on the CPU.

Ranks are spawned over gloo by `tests/torch_dist_worker.py` (one torch
thread each, `spawn_ranks`' own timeout), on the reduced tiny configuration
of `test_torch_train.py` and its JAX step, which runs as that file runs it
(jitted on the CPU, with the zero-safe cosine).

- The rule set: the port's `param_sharding_rules` on every 2-D kernel of
  the full-width B15N4 model, built on the `meta` device (nothing is
  allocated), gives the sharded (path, dimension) the JAX
  `param_sharding_rules` gives on the same path and shape (a Dense kernel
  as (in, out), the bridge's transpose), at a model axis of 2 and 4; more
  than 100 kernels are sharded, as the JAX test requires. At 3 the JAX rules
  shard CLIP's packed in-projection and the port raises, naming the tower
  (its 16 heads do not split 3 ways; a deliberate difference).
- The forward: the tiny model's eval forward on a model axis of 2, filled
  straight from the JAX tree, against the port's one process and the JAX
  `eval_forward`, by the JAX TP test's rule (`tests/test_tensor_parallel.py`:
  at least 98% of elements within 2e-4 and every element within 5e-2);
  masks, labels and routing exactly as one process's, save mask decisions
  within 1e-4 of a threshold.
- The train step at model 2 x data 1 (2 ranks) and data 2 x model 2 (4
  ranks) on `test_torch_distributed.py`'s unequal batch, against one
  process at batch 2 and the JAX `make_train_step`, with
  `test_torch_train.py`'s tolerances (losses 2e-4; each trainable leaf's
  gradient, made whole, 1e-2 relative L2 and 3e-2 of its largest value;
  running statistics 1e-5; the IoU histograms exact); the gradient norms
  within 1e-4 of one process's; a model group's replicated gradients and
  statistics bit-equal across its ranks.
- Gather and shard: `gather_params(shard_params(m))` is the state dict bit
  for bit; a checkpoint saved under model 2 holds the whole tensors and
  restores under model 1 bit for bit, one saved by one process restores
  under model 2 to each rank's slices, and one more step from it equals
  the one-process step.
- `create_mesh` raises where the world does not fit, as the JAX one asserts.
- The trainer's CLI with `mesh_shape` {data: 1, model: 2} on 2 ranks: two
  steps and one validation; only rank 0 writes; its losses equal one
  process's within 2e-4, its validation IoUs within 1e-2 (validation on
  the same weights is held by the forward case above).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import _near_claim, to_port_batch
from test_torch_train import (
    CONFIG,
    GRAD_L2_TOL,
    GRAD_MAX_TOL,
    GRAD_ZERO_TOL,
    LOSS_TOL,
    REDUCED,
    STATS_TOL,
    TOTAL_STEPS,
    _leaves,
    _tiny_argv,
    jax_and_port_step,
    synthetic_train_batch,
)
from torch_dist_worker import TP_OUTPUTS, spawn_ranks
from xmask3d_tpu.config import load_config as jax_load_config
from xmask3d_tpu.engine.builder import model_config_from_cfg as jax_model_config
from xmask3d_tpu.models.xmask3d import XMask3D as JaxXMask3D
from xmask3d_tpu.parallel.mesh import create_mesh as jax_create_mesh
from xmask3d_tpu.parallel.mesh import param_sharding_rules as jax_rules
from xmask3d_tpu_torch.checkpoint.from_jax import bridge_tensors, load_jax_variables
from xmask3d_tpu_torch.checkpoint.torch_io import Checkpointer
from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.engine import train as trainer
from xmask3d_tpu_torch.engine.builder import (
    build_model, build_statics, build_train_model, model_config_from_cfg)
from xmask3d_tpu_torch.engine.train_step import create_train_state, make_optimizer, make_train_step
from xmask3d_tpu_torch.models.clip import MultiHeadAttention, heads_of
from xmask3d_tpu_torch.models.layers import resize
from xmask3d_tpu_torch.models.sd_unet import BasicTransformerBlock
from xmask3d_tpu_torch.models.xmask3d import XMask3D
from xmask3d_tpu_torch.ops.point_sample import point_draws
from xmask3d_tpu_torch.parallel import mesh as port_mesh
from xmask3d_tpu_torch.parallel.mesh import Mesh
from xmask3d_tpu_torch.parallel.tensor import (
    GatheredLinear, param_sharding_rules, shard_params, sharded_tensors, take_shard)

# the JAX TP test's rule (tests/test_tensor_parallel.py:52-68)
TP_CLOSE, TP_SHARE, TP_MAX = 2e-4, 0.98, 5e-2
NORM_RTOL = 1e-4
VAL_IOU_TOL = 1e-2
FLOAT_OUTPUTS = ("pred_logits", "fused_pred_feature", "2d_pred_feature", "pure3d_pred_feature",
                 "mask_embed_clip", "binary_sig", "pred_scores", "pred_masks")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs test files in parallel worker processes; torch's
    default of one OpenMP thread per core oversubscribes the CPU there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg():
    cfg = load_config(CONFIG)
    cfg.update(REDUCED)
    return cfg


# ---------------------------------------------------------------------------
# the rule set at full width, and the mesh's errors
# ---------------------------------------------------------------------------


def _meta_model():
    with torch.device("meta"):
        return XMask3D(model_config_from_cfg(load_config(CONFIG)))


@pytest.fixture(scope="module")
def full_width_meta():
    """The B15N4 model at full width on the meta device, each 2-D kernel's
    (JAX path, JAX-layout shape), and its (port tensor name, whether the
    bridge transposes it)."""
    model = _meta_model()
    names = {id(m): n for n, m in model.named_modules()}
    kernels, tensors = {}, {}
    for bt in bridge_tensors(model):
        shape = tuple(bt.tensor.shape)
        if bt.path.endswith("kernel") and len(shape) == 2:
            kernels[bt.path] = shape[::-1] if bt.transform is not None else shape
            mod = names[id(bt.module)]
            tensors[bt.path] = (f"{mod}.{bt.name}" if mod else bt.name,
                                bt.transform is not None)
    return model, kernels, tensors


def _jax_dim(path, shape, mesh):
    spec = jax_rules(tuple(path.split("/")), types.SimpleNamespace(shape=shape, ndim=len(shape)),
                     mesh).spec
    return {(None, "model"): 1, ("model", None): 0}.get(tuple(spec))


@pytest.mark.parametrize("m", [2, 4])
def test_rules_equal_the_jax_rules_at_full_width(full_width_meta, m):
    """The rules equal JAX's, and `shard_params` cuts exactly the weights
    they shard, on the rule's dimension (the bridge's transpose undone),
    with the bias of each column-parallel weight."""
    model, kernels, tensors = full_width_meta
    jmesh = jax_create_mesh(data=1, model=m, devices=jax.devices()[:m])
    port = Mesh(data=1, model=m, data_rank=0, model_rank=0)
    got = {p: param_sharding_rules(p, s, port) for p, s in kernels.items()}
    want = {p: _jax_dim(p, s, jmesh) for p, s in kernels.items()}
    assert got == want
    sharded = {p for p, d in got.items() if d is not None}
    assert len(sharded) > 100, len(sharded)  # tests/test_tensor_parallel.py:140
    for key in ("in_proj", "mlp_c_fc", "ff_geglu", "to_q", "emb_proj", "ffn2", "linear2"):
        assert any(key in p for p in sharded), key
    # every other tensor is replicated on both sides
    for bt in bridge_tensors(model):
        if bt.path not in kernels:
            shape = tuple(bt.tensor.shape)
            assert param_sharding_rules(bt.path, shape, port) is None
            assert _jax_dim(bt.path, shape, jmesh) is None, bt.path
    assert all(p.is_meta for p in model.parameters())

    cut = shard_params(_meta_model(), Mesh(1, m, 0, m - 1))
    held = sharded_tensors(cut)
    want = {tensors[p][0]: (1 - d if tensors[p][1] else d) for p, d in got.items()
            if d is not None}
    assert {n: d for n, (d, _) in held.items() if n.endswith(".weight")} == want
    assert {n for n, (d, _) in held.items() if n.endswith(".bias")} == {
        n[:-len("weight")] + "bias" for n, d in want.items()
        if d == 0 and getattr(cut.get_submodule(n[:-len(".weight")]), "bias") is not None}
    whole, params = dict(model.named_parameters()), dict(cut.named_parameters())
    for n, d in want.items():
        assert params[n].shape[d] * m == whole[n].shape[d], n
    assert all(p.is_meta for p in cut.parameters())
    # the sharded GEGLUs feed a gathering `ff_out`; CLIP's attentions know
    # their first head (for the slice of a mask with a head axis)
    mods = list(cut.modules())
    blocks = [b for b in mods if isinstance(b, BasicTransformerBlock)]
    assert blocks and all(isinstance(b.ff_out, GatheredLinear) for b in blocks)
    attns = [a for a in mods if isinstance(a, MultiHeadAttention)]
    assert attns and all(a.first_head == (m - 1) * a.heads // m for a in attns)


def test_rules_raise_where_the_heads_do_not_split(full_width_meta):
    """A model axis of 3 divides CLIP ViT-L's packed 3 x 1024 in-projection,
    which the JAX rules then shard, but not its 16 heads: the port raises
    at `shard_params`, naming the tower. At full width the towers take 1, 2
    and 4 (8, 12 and 16 heads); the tiny towers (2 heads) refuse 4."""
    _, kernels, _ = full_width_meta
    jmesh = jax_create_mesh(data=1, model=3, devices=jax.devices()[:3])
    path = "clip/visual/transformer/resblock_0/attn/in_proj/kernel"
    assert _jax_dim(path, kernels[path], jmesh) == 1
    with torch.device("meta"):
        model = XMask3D(model_config_from_cfg(load_config(CONFIG)))
    with pytest.raises(ValueError, match=r"does not divide the 16 heads of clip\.visual"):
        shard_params(model, Mesh(1, 3, 0, 0))
    with torch.device("meta"):
        model = XMask3D(model_config_from_cfg(load_config(CONFIG)))
    n = sum(p.numel() for p in model.parameters())
    shard_params(model, Mesh(1, 4, 0, 3))
    assert sum(p.numel() for p in model.parameters()) < n
    tiny = build_model(_port_cfg(), tiny=True, device="cpu")
    with pytest.raises(ValueError, match="does not divide the 2 heads"):
        shard_params(tiny, Mesh(1, 4, 0, 0))


def test_a_rank_takes_its_heads_of_a_mask_with_a_head_axis():
    """CLIP's attention on a rank's heads takes their slice of a mask or
    bias that has a head axis; MaskCLIP's and the text tower's broadcast
    over the heads and pass as they are."""
    m = torch.arange(2 * 4 * 3 * 3).reshape(2, 4, 3, 3)
    assert torch.equal(heads_of(m, 2, 2), m[:, 2:4])
    one = m[:, :1]
    assert heads_of(one, 2, 2) is one and heads_of(None, 0, 2) is None


def test_grad_norms_reduce_on_the_masters_device(monkeypatch):
    """Under a model axis each group's sum of squares of its sharded
    masters is summed over the model group, that of a group without one
    (B15N4's 3d group) too: a zero on the masters' device, which NCCL
    takes (a CPU tensor would raise there)."""
    from xmask3d_tpu_torch.engine import train_step as ts

    masters = [torch.ones(3, device="meta", requires_grad=True) for _ in range(3)]
    for t in masters:
        t.grad = torch.ones(3, device="meta")
    opt = object.__new__(ts.MasterAdamW)
    opt.pairs = {"3d": [(masters[0], masters[0])], "others": [(t, t) for t in masters[1:]]}
    opt.sharded, opt._reduced = {id(masters[2])}, True
    reduced = []
    monkeypatch.setattr(ts, "model_size", lambda: 2)
    monkeypatch.setattr(ts, "current_mesh", lambda: Mesh(1, 2, 0, 0, model_group="model"))
    monkeypatch.setattr(ts.dist, "all_reduce",
                        lambda t, group=None: reduced.append((t.device.type, t.shape, group)))
    norms = opt.grad_norms()
    assert reduced == [("meta", torch.Size([]), "model")] * 2
    assert {g: n.device.type for g, n in norms.items()} == {"3d": "meta", "others": "meta"}


def test_create_mesh_raises_where_the_world_does_not_fit(monkeypatch):
    """Where the JAX `create_mesh` asserts; the rank layout of a fitting
    mesh is its reshape(data, model); `rows_of_rank` and
    `shard_batch_by_host` then cut by the data axis."""
    assert port_mesh.world_size() == 1
    with pytest.raises(ValueError, match="not divisible by model=2"):
        port_mesh.create_mesh(-1, 2)
    with pytest.raises(ValueError, match=r"mesh 4x1 != 1 ranks"):
        port_mesh.create_mesh(4, 1)
    monkeypatch.setattr(port_mesh, "_MESH", None)
    monkeypatch.setattr(port_mesh, "world_size", lambda: 6)
    monkeypatch.setattr(port_mesh, "rank", lambda: 5)
    monkeypatch.setattr(port_mesh.dist, "new_group", lambda ranks: tuple(ranks))
    with pytest.raises(ValueError, match="mesh 2x2 != 6 ranks"):
        port_mesh.create_mesh(2, 2)
    m = port_mesh.create_mesh(-1, 3)
    assert (m.data, m.model, m.data_rank, m.model_rank) == (2, 3, 1, 2)
    assert m.data_group == (2, 5) and m.model_group == (3, 4, 5)
    x = torch.arange(8)
    assert torch.equal(port_mesh.rows_of_rank(x), x[4:])
    np.testing.assert_array_equal(port_mesh.shard_batch_by_host(np.arange(7)), [1, 3, 5])
    assert port_mesh.scenes_of_rank(5) == [1, 3]


# ---------------------------------------------------------------------------
# the forward, the step and the checkpoints on ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_case(tmp_path_factory):
    """The JAX and one-process port steps on the unequal batch (4 and 3
    valid masks, 400 and 300 valid points, one view all novel, one all
    base), the JAX and port eval forwards of the same weights, and the
    inputs of the rank jobs under a temporary directory: the start state,
    batch, statics and two steps' draws, the JAX variables, and the
    one-process checkpoint after the first step."""
    tmp = tmp_path_factory.mktemp("tp")
    batch_np = synthetic_train_batch()
    batch_np["point_valid"][1, 300:] = False
    case = jax_and_port_step(batch_np)
    variables = jax.device_get(case["variables"])
    pcfg = _port_cfg()
    batch = to_port_batch(batch_np)

    start = build_train_model(pcfg, tiny=True, device="cpu")
    load_jax_variables(start, variables)
    start_state = {k: v.clone() for k, v in start.state_dict().items()}
    eval_model = build_model(pcfg, tiny=True, device="cpu")
    load_jax_variables(eval_model, variables)
    statics = build_statics(eval_model, pcfg, device="cpu")
    with torch.no_grad():
        one_out = eval_model.eval_forward(batch, statics)

    jcfg = jax_load_config(CONFIG)
    jcfg.update(REDUCED)
    jmodel = JaxXMask3D(cfg=jax_model_config(jcfg, tiny=True))
    j_out = jax.device_get(jax.jit(lambda v, b, st: jmodel.apply(
        v, b, st, train=False, rngs={"points": jax.random.PRNGKey(0)})[1])(
        variables, jax.tree_util.tree_map(jnp.asarray, batch_np),
        {k: jnp.asarray(v.numpy()) for k, v in statics.items()}))

    mc = start.cfg
    t = batch["target_labels"].shape[1]
    draws2 = point_draws(torch.Generator().manual_seed(11), mc.dec_layers + 1, 2, t,
                         mc.num_points, mc.oversample_ratio, mc.importance_sample_ratio,
                         device="cpu")
    torch.save({"state": start_state, "batch": batch, "statics": case["statics"],
                "draws": case["draws"], "draws2": draws2, "total_steps": TOTAL_STEPS},
               tmp / "tp_step_in.pt")
    torch.save({"variables": variables, "batch": batch, "statics": statics}, tmp / "tp_fwd_in.pt")
    Checkpointer(str(tmp / "ckpt_one")).save(1, case["state"], best_iou=0.25)

    # the one process's second step, from that checkpoint
    model2 = build_train_model(pcfg, tiny=True, device="cpu")
    model2.load_state_dict(start_state)
    state2 = create_train_state(model2, make_optimizer(model2, pcfg.lr_3d, pcfg.lr_others,
                                                      TOTAL_STEPS))
    state2, _ = Checkpointer(str(tmp / "ckpt_one")).restore(state2)
    metrics2 = make_train_step(dict(pcfg.loss_weight))(state2, batch, case["statics"], 1.0,
                                                       draws=draws2)
    case.update(tmp=tmp, start_state=start_state, one_out=one_out, jax_out=j_out,
                batch_np=batch_np, metrics2=metrics2, state2=state2)
    return case


@pytest.fixture(scope="module")
def model2_ranks(tp_case):
    """The forward, the step and the checkpoint round trip on a (1, 2) mesh."""
    return spawn_ranks("tp_step", tp_case["tmp"], (REDUCED, 1, 2, True), world=2)


def _tp_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    assert (diff <= TP_CLOSE).mean() >= TP_SHARE, f"{what}: {(diff <= TP_CLOSE).mean():.4f}"
    assert diff.max() < TP_MAX, f"{what}: {diff.max()}"


def test_tp_forward_equals_one_process_and_jax(tp_case, model2_ranks):
    one, j_out = tp_case["one_out"], tp_case["jax_out"]
    r0, r1 = (r["forward"] for r in model2_ranks)
    for k in TP_OUTPUTS:  # the model group agrees
        assert torch.equal(r0[k], r1[k]), k
    for k in FLOAT_OUTPUTS:
        _tp_close(r0[k].numpy(), one[k].numpy(), k)
        _tp_close(r0[k].numpy(), j_out[k], f"{k} (JAX)")
        if k != "pred_masks":
            np.testing.assert_allclose(r0[k].numpy(), one[k].numpy(), rtol=2e-3, atol=2e-3,
                                       err_msg=k)
    # discrete outputs: one process's, save mask decisions near a threshold
    mh, mw = REDUCED["mask_shape"]
    masks = resize(one["pred_masks"], (mh, mw), (2, 3), "bilinear", antialias=False).numpy()
    near_pix = _near_claim(masks, one["pred_scores"].numpy(), one["final_mask_valid"].numpy())
    bnp = tp_case["batch_np"]
    rows = np.arange(masks.shape[0])[:, None]
    near = near_pix[rows, :, bnp["x_label"], bnp["y_label"]].transpose(0, 2, 1)
    diff = r0["final_mask_3d"].numpy() != one["final_mask_3d"].numpy()
    assert not (diff & ~near).any(), "final_mask_3d differs away from a threshold"
    for k in ("pred_labels", "final_mask_valid", "binary_pred", "covered"):
        np.testing.assert_array_equal(r0[k].numpy(), one[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(r0[k].numpy(), np.asarray(j_out[k]), err_msg=f"{k} (JAX)")


def _check_step(ranks, case, metrics, mu):
    """The ranks' step against one process's (`metrics`, first moments
    `mu`: {name: tensor}) and JAX's (`case`)."""
    got = ranks[0]["metrics"]
    jax_metrics = case["jax"]
    assert float(jax_metrics["loss_3d_contra"]) > 0
    for k, want in metrics.items():
        for r in ranks[1:]:
            assert torch.equal(r["metrics"][k], got[k]), k
        if k.startswith("grad_norm"):
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=NORM_RTOL, err_msg=k)
            continue
        if k.startswith("metric_"):
            assert torch.equal(got[k], want), k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jax_metrics[k]), err_msg=k)
            continue
        for ref in (want.numpy(), np.asarray(jax_metrics[k])):
            np.testing.assert_allclose(got[k].numpy(), ref, rtol=LOSS_TOL, atol=LOSS_TOL,
                                       err_msg=k)

    state = case["state"]
    groups = {id(p): g for g, pairs in state.optimizer.pairs.items() for p, _ in pairs}
    names = {n for n, _ in state.model.named_parameters()}
    top = max(float(v.abs().max()) for v in ranks[0]["mu"].values())
    shards = ranks[0]["sharded"]
    checked = sharded_trainable = 0
    for name, t, col, path, fn in _leaves(state.model):
        if col != "params" or id(t) not in groups:
            continue
        g = ranks[0]["mu"][name].numpy()
        for r in ranks[1:]:
            assert torch.equal(r["mu"][name], ranks[0]["mu"][name]), name
        if name in shards:
            sharded_trainable += 1
        else:  # a replicated gradient: bit-equal on every rank, as held
            for r in ranks:
                assert torch.equal(r["local"][name], ranks[0]["local"][name]), name
        jax_mu = case["mu"][groups[id(t)]][path]
        for want in (mu[name].numpy(), fn(jax_mu) if fn is not None else jax_mu):
            if name.endswith("k_proj.bias"):
                assert max(np.abs(g).max(), np.abs(want).max()) <= GRAD_ZERO_TOL * top, name
                continue
            l2 = float(np.linalg.norm(g - want) / np.linalg.norm(want))
            worst = float(np.abs(g - want).max() / np.abs(want).max())
            assert l2 <= GRAD_L2_TOL and worst <= GRAD_MAX_TOL, f"{name}: L2 {l2}, max {worst}"
        checked += 1
    assert checked == len(ranks[0]["mu"]) > 100
    # the trainable sharded leaves: per decoder layer ffn1 (weight, bias),
    # ffn2 and both out_proj weights, per encoder layer linear1 (weight,
    # bias) and linear2's weight
    assert sharded_trainable == 5 * REDUCED["dec_layers"] + 3 * REDUCED["pixel_enc_layers"]
    assert set(shards) <= names and len(shards) > 100

    for name, t, col, path, fn in _leaves(state.model):
        if col == "batch_stats":
            b0 = ranks[0]["buffers"][name]
            for r in ranks[1:]:
                assert torch.equal(r["buffers"][name], b0), name
            for want in (t.numpy(), case["stats"][path]):
                np.testing.assert_allclose(b0.numpy(), want, rtol=0, atol=STATS_TOL, err_msg=name)


def _one_process_mu(state):
    adam = state.optimizer.adamw.state
    name = {id(p): n for n, p in state.model.named_parameters()}
    return {name[id(p)]: adam[m]["exp_avg"] for pairs in state.optimizer.pairs.values()
            for p, m in pairs}


def test_tp_step_model2_equals_one_process_and_jax(tp_case, model2_ranks):
    assert [(r["data_rank"], r["model_rank"]) for r in model2_ranks] == [(0, 0), (0, 1)]
    _check_step(model2_ranks, tp_case, tp_case["port"], _one_process_mu(tp_case["state"]))


def test_tp_step_data2_model2_equals_one_process_and_jax(tp_case):
    """Four ranks: data 2 x model 2, one view a model group."""
    ranks = spawn_ranks("tp_step", tp_case["tmp"], (REDUCED, 2, 2, False), world=4)
    assert [(r["data_rank"], r["model_rank"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    _check_step(ranks, tp_case, tp_case["port"], _one_process_mu(tp_case["state"]))
    # the two model groups hold different rows: their replicated BatchNorm
    # statistics agree only through the data group's sums
    assert ranks[0]["mesh"] == {"data": 2, "model": 2}


def test_gather_shard_and_checkpoints_between_meshes(tp_case, model2_ranks):
    tmp = tp_case["tmp"]
    assert all(r["round_trip_equal"] for r in model2_ranks)
    shards = model2_ranks[0]["sharded"]
    assert os.listdir(tmp / "ckpt_tp") == ["step_1.pt"]

    # saved under model 2, restored under model 1: the ranks' whole tensors
    model = build_train_model(_port_cfg(), tiny=True, device="cpu")
    model.load_state_dict(tp_case["start_state"])
    state = create_train_state(model, make_optimizer(model, 1e-3, 1e-4, TOTAL_STEPS))
    state, meta = Checkpointer(str(tmp / "ckpt_tp")).restore(state)
    assert meta == {"step": 1, "best_iou": 0.25} and state.step == 1
    adam = state.optimizer.adamw.state
    name = {id(p): n for n, p in model.named_parameters()}
    saved = model2_ranks[0]["saved"]
    for pairs in state.optimizer.pairs.values():
        for p, m in pairs:
            n = name[id(p)]
            for got, want in zip((m, adam[m]["exp_avg"], adam[m]["exp_avg_sq"]), saved[n]):
                assert torch.equal(got, want), n
            assert torch.equal(p, m), n
    for r in model2_ranks[1:]:
        assert all(all(torch.equal(a, b) for a, b in zip(v, saved[k]))
                   for k, v in r["saved"].items())

    # saved by one process, restored under model 2: each rank's slices
    one = tp_case["state"]
    one_adam = one.optimizer.adamw.state
    name = {id(p): n for n, p in one.model.named_parameters()}
    whole = {name[id(p)]: (m, one_adam[m]["exp_avg"], one_adam[m]["exp_avg_sq"])
             for pairs in one.optimizer.pairs.values() for p, m in pairs}
    for r in model2_ranks:
        assert r["restored_step"] == 1
        for n, tensors in r["restored"].items():
            for got, full in zip(tensors, whole[n]):
                want = take_shard(full, *shards[n], 2, r["model_rank"]) if n in shards else full
                assert torch.equal(got, want), n

    # one more step from it equals the one process's second step
    _check_step_two(model2_ranks, tp_case)


def _check_step_two(ranks, case):
    got, want = ranks[0]["metrics2"], case["metrics2"]
    for k, v in want.items():
        assert torch.equal(ranks[1]["metrics2"][k], got[k]), k
        if k.startswith("metric_"):
            assert torch.equal(got[k], v), k
        elif k.startswith("grad_norm"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=NORM_RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=LOSS_TOL, atol=LOSS_TOL,
                                       err_msg=k)
    mu = _one_process_mu(case["state2"])
    top = max(float(v.abs().max()) for v in mu.values())
    for n, want in mu.items():
        g, w = ranks[0]["mu2"][n].numpy(), want.numpy()
        if n.endswith("k_proj.bias"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= GRAD_ZERO_TOL * top, n
            continue
        l2 = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        worst = float(np.abs(g - w).max() / np.abs(w).max())
        assert l2 <= GRAD_L2_TOL and worst <= GRAD_MAX_TOL, f"{n}: L2 {l2}, max {worst}"


def test_trainer_on_a_model_axis_of_two(tmp_path):
    argv = _tiny_argv(tmp_path / "one")
    one = trainer.main(argv, device="cpu")
    i = argv.index("--save_path")
    tp_argv = argv[:i] + argv[i + 2:] + ["mesh_shape.data", "1", "mesh_shape.model", "2"]
    ranks = spawn_ranks("trainer", tmp_path, (tp_argv,))
    assert ranks[0] == ranks[1]
    assert os.listdir(tmp_path / "run_0" / "model")
    assert not [f for _, _, files in os.walk(tmp_path / "run_1") for f in files]
    assert ranks[0]["step"] == one["step"] == 2
    assert set(ranks[0]["val"]) == set(one["val"]) and ranks[0]["val"]
    for k, v in one["last_metrics"].items():
        if k.startswith("loss"):
            np.testing.assert_allclose(ranks[0]["last_metrics"][k], v, rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
    # after two steps whose updates differ in rounding (AdamW's first step
    # is about lr * sign(g), so a gradient near 0 may move either way) a few
    # validation points may flip: the IoUs stay close, not equal
    for k, v in one["val"].items():
        assert np.isfinite(ranks[0]["val"][k]) and abs(ranks[0]["val"][k] - v) <= VAL_IOU_TOL, k
