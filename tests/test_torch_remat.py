"""Block remat of the SD backbone (`remat_backbone`, `models/layers.py`
`RematBlock`) against the same model without it.

- The blocks: exactly those the JAX package wraps in `nn.remat` (the VAE's
  ResnetBlock and AttnBlock, the UNet's UNetResBlock and
  SpatialTransformer), counted per class from the flax module tree of the
  tiny LDM extractor under `jax.eval_shape` (no step is compiled).
- One training step of the reduced tiny model, fp32 on the CPU, with remat
  on and off from the same seed, batch and point draws: identical losses,
  every leaf gradient within 1e-6 relative L2 (recomputation repeats the
  same fp32 arithmetic), equal BatchNorm statistics. The step checkpoints
  only the UNet blocks that run before the last tap: the VAE's see no
  input or parameter that requires grad.
- Eval outputs are identical with remat on, and nothing is checkpointed
  (grad mode on: the served model's weights require no grad).
- A VAE ResnetBlock on kernel K4's wrapper (`fused_gn`) and an AttnBlock on
  K2's, checkpointed, take back the same gradients (the wrappers'
  autograd Functions recompute inside the block's backward).
"""

import collections

import numpy as np
import pytest
import torch

from xmask3d_tpu_torch.config import load_config
from xmask3d_tpu_torch.data.batching import Capacities
from xmask3d_tpu_torch.data.synthetic import synthetic_batch
from xmask3d_tpu_torch.engine.builder import build_model, build_statics, build_train_model
from xmask3d_tpu_torch.engine.train_step import weight_losses
from xmask3d_tpu_torch.models import layers
from xmask3d_tpu_torch.models.layers import RematBlock, set_remat
from xmask3d_tpu_torch.models.ldm_extractor import LDM_TINY, LdmExtractor
from xmask3d_tpu_torch.models.vae import AttnBlock, ResnetBlock
from xmask3d_tpu_torch.ops.point_sample import point_draws

CONFIG = "configs/scannet/xmask3d_scannet_B15N4.yaml"
REDUCED = {"arch_3d": "MinkUNet14A", "arch_binary_head": "MinkUNet14A", "mask_shape": [24, 32],
           "compute_dtype": "float32", "dec_layers": 2, "pixel_enc_layers": 2}
GRAD_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(remat: bool):
    cfg = load_config(CONFIG)
    cfg.update(REDUCED)
    cfg.update(remat_backbone=remat)
    return cfg


def _batch():
    caps = Capacities(max_points=512, max_voxels=256, max_targets=8)
    b = synthetic_batch(2, caps, seed=3, num_points=400, image_size=(128, 128),
                        mask_shape=(24, 32), context_length=16, vocab_size=512, device="cpu")
    b["binary_label_3d"][0] = 0.0  # one all-novel and one all-base view: loss_3d_contra
    b["binary_label_3d"][1] = 1.0
    return b


class CountCheckpoints:
    """Counts the blocks `RematBlock` hands to torch.utils.checkpoint."""

    def __init__(self, monkeypatch):
        self.by_class = collections.Counter()
        real = layers.checkpoint

        def counting(fn, *args, **kwargs):
            self.by_class[type(fn.__self__).__name__] += 1
            return real(fn, *args, **kwargs)

        monkeypatch.setattr(layers, "checkpoint", counting)


def test_the_blocks_are_those_the_jax_package_remats():
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from xmask3d_tpu.models.ldm_extractor import LDM_TINY as JAX_LDM_TINY
    from xmask3d_tpu.models.ldm_extractor import LdmExtractor as JaxLdmExtractor

    c = JAX_LDM_TINY
    model = JaxLdmExtractor(c, remat=True)
    wrapped = collections.Counter()

    def intercept(next_fun, args, kwargs, context):
        name = type(context.module).__name__
        if name.startswith("Checkpoint"):  # the class nn.remat makes
            wrapped[name[len("Checkpoint"):]] += 1
        return next_fun(*args, **kwargs)

    img = jnp.zeros((1, 64, 64, 3))
    cond = jnp.zeros((1, c.text.context_length, c.text.width))
    toks = jnp.zeros((1, c.text.context_length), jnp.int32)
    with fnn.intercept_methods(intercept):  # init_all calls every block once
        jax.eval_shape(lambda r: model.init(r, img, cond, toks, method=model.init_all),
                       jax.random.PRNGKey(0))

    with torch.device("meta"):
        port = LdmExtractor(LDM_TINY)
    assert not any(m.remat for m in port.modules() if isinstance(m, RematBlock))
    assert set_remat(port, True) == 64
    ours = collections.Counter(type(m).__name__ for m in port.modules()
                               if isinstance(m, RematBlock) and m.remat)
    assert ours == wrapped
    assert sum(ours.values()) == 64


def test_a_training_step_with_remat_equals_one_without(monkeypatch):
    counter = CountCheckpoints(monkeypatch)
    runs = {}
    for remat in (False, True):
        cfg = _cfg(remat)
        model = build_train_model(cfg, tiny=True, seed=1, device="cpu")
        assert model.cfg.remat_backbone is remat
        assert {m.remat for m in model.modules() if isinstance(m, RematBlock)} == {remat}
        statics = build_statics(model, cfg, device="cpu")
        draws = point_draws(torch.Generator().manual_seed(0), model.cfg.dec_layers + 1, 2, 8,
                            model.cfg.num_points)
        counter.by_class.clear()
        losses, _ = model(_batch(), statics, train=True, draws=draws)
        weight_losses(losses, dict(cfg.loss_weight), contra_on=1.0).backward()
        runs[remat] = ({k: v.detach() for k, v in losses.items()},
                       {n: p.grad.detach().clone() for n, p in model.named_parameters()
                        if p.grad is not None},
                       {n: b.detach().clone() for n, b in model.named_buffers()},
                       dict(counter.by_class))
    (l_off, g_off, s_off, c_off), (l_on, g_on, s_on, c_on) = runs[False], runs[True]
    assert not c_off
    # the UNet's blocks up to its last tap (the VAE's record nothing)
    assert c_on == {"UNetResBlock": 21, "SpatialTransformer": 15}
    assert l_on.keys() == l_off.keys()
    for k in l_off:
        assert torch.equal(l_on[k], l_off[k]), k
    assert l_off["loss_3d_contra"] > 0
    assert g_on.keys() == g_off.keys() and len(g_off) > 100
    assert any(n.startswith("backbone.feature_extractor.clip_project") for n in g_off)
    for n, want in g_off.items():
        gap = float((g_on[n] - want).norm() / want.norm().clamp(min=1e-30))
        assert gap <= GRAD_TOL, (n, gap)
    for n, want in s_off.items():
        assert torch.equal(s_on[n], want), n


def test_eval_outputs_do_not_change(monkeypatch):
    counter = CountCheckpoints(monkeypatch)
    outs = []
    for remat in (False, True):
        cfg = _cfg(remat)
        model = build_model(cfg, tiny=True, seed=2, device="cpu")
        statics = build_statics(model, cfg, device="cpu")
        batch = synthetic_batch(1, Capacities(512, 256, 8), seed=5, num_points=400,
                                image_size=(128, 128), mask_shape=(24, 32), context_length=16,
                                vocab_size=512, device="cpu")
        outs.append(model.eval_forward(batch, statics))  # grad mode on, frozen weights
    assert not counter.by_class
    for k, want in outs[0].items():
        if torch.is_tensor(want):
            assert torch.equal(outs[1][k], want), k


@pytest.mark.parametrize("block", ["resnet_fused_gn", "attn"])
def test_kernel_functions_recompute_inside_a_checkpointed_block(block, monkeypatch):
    """K4 (`gn_silu_conv`) and K2 (`attention`) wrappers inside a checkpointed
    block: the same output and gradients as without remat, each wrapper
    called once more in the backward (its recompute)."""
    from xmask3d_tpu_torch.ops import _build

    counter = CountCheckpoints(monkeypatch)
    calls = collections.Counter()
    monkeypatch.setattr(_build, "RECORDER", lambda name, args: calls.update([name]))
    torch.manual_seed(0)
    if block == "attn":
        mods = [AttnBlock(64) for _ in range(2)]
        kernel = "flash_attention"
    else:
        mods = [ResnetBlock(64, 96, fused_gn=True) for _ in range(2)]
        kernel = "gn_silu_conv"
    mods[1].remat = True
    mods[1].load_state_dict(mods[0].state_dict())
    x = torch.randn(2, 8, 8, 64, dtype=torch.float32)
    got = []
    for m in mods:
        calls.clear()
        xi = x.clone().requires_grad_()
        y = m(xi)
        ct = torch.from_numpy(np.random.RandomState(1).randn(*y.shape).astype(np.float32))
        grads = torch.autograd.grad(y, [xi, *m.parameters()], ct)
        got.append((y.detach(), grads, calls[kernel]))
    (y0, g0, n0), (y1, g1, n1) = got
    assert counter.by_class == {type(mods[1]).__name__: 1}
    assert torch.equal(y0, y1)
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= GRAD_TOL * max(1.0, float(a.abs().max()))
    assert n0 >= 1 and n1 == 2 * n0
