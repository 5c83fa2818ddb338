"""Guards of the port's ground rules.

- The port and `chip_smoke.py` import neither JAX nor the JAX package; the
  conversion tool runs where neither they nor yaml can be imported.
- Entry points run on the GPU unless the caller asks for the CPU; without a
  GPU they raise instead of falling back, and `chip_smoke.py` exits
  non-zero without printing a result. `init_distributed` follows the same
  rule, and no environment switch routes a kernel wrapper's CUDA tensor to
  its plain version.
- The port's own config loader reads what the JAX package's reads.
- `load_jax_variables` carries every leaf by its rule and rejects a
  missing, extra or misshapen one.
"""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from xmask3d_tpu.config import load_config as jax_load_config
from xmask3d_tpu_torch.checkpoint.from_jax import load_jax_variables
from xmask3d_tpu_torch.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "xmask3d_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "xmask3d_tpu")


def _port_modules():
    mods = []
    for path in sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_sources_import_nothing_of_jax():
    """AST scan of every port source and chip_smoke.py."""
    files = glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    """Every module of the port, and chip_smoke's own imports, in a fresh
    interpreter: neither jax nor any xmask3d_tpu module gets loaded."""
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke.kernel_table()\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_import_guards_cover_the_parallel_and_sampling_modules():
    """The scans above walk the whole package: the data- and
    tensor-parallel layers and the diffusion sampling modules are among
    what they import."""
    mods = set(_port_modules())
    for m in ("parallel.mesh", "parallel.tensor", "models.diffusion", "models.txt2img",
              "models.resample"):
        assert f"xmask3d_tpu_torch.{m}" in mods, m


def test_no_environment_switch_reaches_the_kernel_wrappers():
    """A wrapper takes its plain version for CPU tensors only: the kernel
    wrappers and the parallel layers read no environment variable but
    the toolkit's location and torchrun's rank variables, so nothing
    outside the call can send a CUDA tensor to the plain version (the env
    switches the port has, such as XMASK3D_FUSED_GN, choose modules, not
    routes of a kernel)."""
    allowed = {"CUDA_HOME", "RANK", "WORLD_SIZE", "LOCAL_RANK"}
    files = glob.glob(os.path.join(PORT, "ops", "*.py"))
    files += glob.glob(os.path.join(PORT, "parallel", "*.py"))
    assert len(files) >= 10
    read, bad = set(), []
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for stmt in ast.walk(tree):
            if isinstance(stmt, (ast.If, ast.While)):
                part = stmt.test  # the condition, not the body
            elif isinstance(stmt, ast.stmt) and not isinstance(
                    stmt, (ast.FunctionDef, ast.ClassDef, ast.Try, ast.For, ast.With)):
                part = stmt
            else:
                continue
            if not any(isinstance(n, ast.Attribute) and n.attr in ("environ", "getenv")
                       for n in ast.walk(part)):
                continue
            names = {n.value for n in ast.walk(part) if isinstance(n, ast.Constant)
                     and isinstance(n.value, str) and n.value.isupper()}
            read |= names
            if not names or names - allowed:
                bad.append(f"{os.path.relpath(path, ROOT)}:{stmt.lineno} {sorted(names)}")
    assert not bad, bad
    assert read == allowed, read


def test_init_distributed_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    """Without torchrun's variables: no process group, this process's
    device. With them: a gloo group for `device="cpu"`; without CUDA and
    without that request it raises, before any group is made."""
    import torch.distributed as dist

    from xmask3d_tpu_torch.parallel import mesh

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.init_distributed()
    assert mesh.init_distributed("cpu") == torch.device("cpu") and not mesh.distributed()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.init_distributed(init_method=f"file://{tmp_path / 'rdzv'}")
    assert not mesh.distributed()
    try:
        dev = mesh.init_distributed("cpu", init_method=f"file://{tmp_path / 'rdzv'}")
        assert dev.type == "cpu" and mesh.distributed() and dist.get_backend() == "gloo"
        assert (mesh.rank(), mesh.world_size()) == (0, 1)
        x = torch.arange(4.0)
        assert torch.equal(mesh.global_sum(x), x)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_conversion_cli_runs_without_yaml_jax_or_the_jax_package(tmp_path):
    """`python -m xmask3d_tpu_torch.tools.convert_checkpoints` in a fresh
    interpreter where yaml, jax and every xmask3d_tpu module are
    unimportable, on tiny files in the released layouts: it writes its npz
    and loads none of them."""
    from test_torch_convert import write_tiny_released

    paths = write_tiny_released(tmp_path)
    out = str(tmp_path / "converted.npz")
    blocked = FORBIDDEN + ("yaml",)
    argv = ["convert_checkpoints", "--xmask3d", paths["xmask3d"], "--sd", paths["sd"],
            "--clip", paths["clip"], "--out", out]
    code = (
        "import runpy, sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"sys.argv = {argv!r}\n"
        "runpy.run_module('xmask3d_tpu_torch.tools.convert_checkpoints', run_name='__main__')\n"
        f"bad = [m for m, v in sys.modules.items() if v is not None "
        f"and m.split('.')[0] in {blocked!r}]\n"
        "print('loaded', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "loaded []" in r.stdout
    with np.load(out) as f:
        keys = f.files
    assert any(k.startswith("batch_stats/") for k in keys)
    assert any(k.startswith("params/clip/") for k in keys)
    assert any(k.startswith("params/backbone/feature_extractor/ldm_extractor/") for k in keys)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_batch
    from xmask3d_tpu_torch.engine import builder, serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(os.path.join(ROOT, "configs/scannet/xmask3d_scannet_B15N4.yaml"))
    cfg.update(arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A", mask_shape=[24, 32],
               compute_dtype="float32")
    caps = Capacities(max_points=64, max_voxels=32, max_targets=4)
    small = dict(num_points=60, image_size=(64, 64), mask_shape=(24, 32),
                 context_length=16, vocab_size=512)
    with pytest.raises(RuntimeError, match="CUDA"):
        builder.build_model(cfg, tiny=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        builder.build_model(cfg, tiny=True, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_batch(1, caps, **small)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.fresh_vote_state(64, 19)
    model = builder.build_model(cfg, tiny=True, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        builder.build_statics(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.make_view_body(model, cfg)
    batch = synthetic_batch(1, caps, device="cpu", **small)
    assert batch["img"].device.type == "cpu"
    statics = builder.build_statics(model, cfg, device="cpu")
    votes, counter = serve.fresh_vote_state(64, 19, device="cpu")
    votes, counter = serve.make_view_body(model, cfg, device="cpu")(batch, statics, votes, counter)
    assert int(counter.sum()) == int(batch["point_valid"].sum())


def test_scene_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    """The whole-scene CLI (`main`, `run_scene`, `run_eval_scenes`) and the
    fused model build follow the device rule; on the CPU they run."""
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_scene
    from xmask3d_tpu_torch.engine import builder, infer_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(ROOT, "configs/scannet/xmask3d_scannet_B15N4.yaml")
    cfg = load_config(config)
    caps = Capacities(max_points=64, max_voxels=32, max_targets=4)
    scene = synthetic_scene(caps, num_points=80, num_views=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_cli.main(["--config", config, "--synthetic", "--tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        builder.build_model(cfg, tiny=True, fused_gn=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_cli.run_scene(scene, None, None, {}, caps, 19)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_cli.run_eval_scenes([scene], 1, cfg=cfg, caps=caps, statics={}, infer_step=None,
                                  route_2d=None)
    cfg.update(arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A", mask_shape=[24, 32],
               compute_dtype="float32")
    model = builder.build_model(cfg, tiny=True, device="cpu", fused_gn=True)
    step, route = infer_cli.make_infer_step(model, cfg)
    statics = builder.build_statics(model, cfg, device="cpu")
    pred = infer_cli.run_scene(scene, step, route, statics, caps, 19, device="cpu")
    assert set(pred) == {"pred", "pred_2d", "pred_3d"}
    assert all(len(p) == len(scene["coords"]) for p in pred.values())


def test_serving_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    """The scene scan, stacked scene views, the scene batch of scene reuse
    and the CLI's serving model follow the device rule; a CUDA device named
    without an index is the current one (a model on cuda:0 is on "cuda")."""
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.data.synthetic import synthetic_scene
    from xmask3d_tpu_torch.device import resolve_device
    from xmask3d_tpu_torch.engine import builder, infer_cli, scene_reuse, serve
    from xmask3d_tpu_torch.engine.graphs import GraphStep

    cfg = load_config(os.path.join(ROOT, "configs/scannet/xmask3d_scannet_B15N4.yaml"))
    cfg.update(arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A", mask_shape=[24, 32],
               compute_dtype="float32")
    caps = Capacities(max_points=64, max_voxels=32, max_targets=4)
    scene = synthetic_scene(caps, num_points=80, num_views=1)
    model = builder.build_model(cfg, tiny=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: serve.make_scene_scan_step(model, cfg),
                 lambda: serve.stack_scene_views(scene, caps, 15),
                 lambda: scene_reuse.scene_3d_batch(scene["coords"], None, caps),
                 lambda: infer_cli.build_serving_model(cfg, tiny=True),
                 lambda: GraphStep(lambda: None, "cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    stacked, idxseq, n = serve.stack_scene_views(scene, caps, 15, device="cpu")
    assert stacked["img"].device.type == "cpu" and n == 80 and idxseq.tolist() == [0]
    assert serve.make_scene_scan_step(model, cfg, device="cpu").step.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == resolve_device(None) == torch.device("cuda", 0)


def test_train_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    """The trainer's `main`, the training build and its data stream follow
    the device rule."""
    from xmask3d_tpu_torch.data.batching import Capacities
    from xmask3d_tpu_torch.engine import builder, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(ROOT, "configs/scannet/xmask3d_scannet_B15N4.yaml")
    cfg = load_config(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--config", config, "--synthetic", "--tiny", "--save_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        builder.build_train_model(cfg, tiny=True)
    data, _, _ = train.make_data_iter(cfg, Capacities(64, 32, 4), synthetic=True, tiny=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(data)


def test_chip_smoke_fails_without_cuda_or_outside_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_wrappers_report_their_calls_to_the_recorder_hook():
    """Each kernel wrapper hands its checked arguments, all positional, to
    `_build.RECORDER` when it is set, and nothing when it is None."""
    from xmask3d_tpu_torch.ops import _build
    from xmask3d_tpu_torch.ops import deform_attn as tda
    from xmask3d_tpu_torch.ops import flash_attention as tfa
    from xmask3d_tpu_torch.ops import sparse_conv as tsc

    feats, w = torch.ones(1, 4, 3), torch.ones(2, 3, 5)
    kmap = torch.tensor([[[0, 1, -1, 3], [-1, 2, 0, 0]]], dtype=torch.int32)
    valid = torch.tensor([[True, True, False, False]])
    q = torch.ones(1, 2, 3, 4)
    value, loc, aw = torch.ones(1, 4, 2, 8), torch.full((1, 3, 2, 1, 1, 2), 0.5), torch.ones(1, 3, 2, 1, 1)
    seen = []
    assert _build.RECORDER is None
    _build.RECORDER = lambda name, args: seen.append((name, args))
    try:
        tsc.sparse_conv(feats, w, kmap, out_valid=valid)
        tfa.attention(q, q, q)
        tda.ms_deform_attn(value, [(2, 2)], loc, aw)
    finally:
        _build.RECORDER = None
    tfa.attention(q, q, q)
    assert [n for n, _ in seen] == ["sparse_conv", "flash_attention", "deform_attn"]
    assert seen[0][1][0] is feats and seen[0][1][3] is None and seen[0][1][4] is valid
    assert len(seen[1][1]) == 3 and seen[2][1][1] == [(2, 2)]


def test_chip_smoke_counts_sparse_conv_bytes_of_live_outputs_only():
    """K1's bound: map columns of live outputs and the feature rows they
    reference, each once; weights, mask and the whole output in full."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    feats, w = torch.ones(1, 6, 3), torch.ones(2, 3, 5)
    # live outputs 0 and 1 reference rows {0, 1, 2}; the padded columns
    # reference rows 4 and 5, which the kernel never reads
    kmap = torch.tensor([[[0, 1, 4, 5], [-1, 2, 5, -1]]], dtype=torch.int32)
    valid = torch.tensor([[True, True, False, False]])
    out = torch.zeros(1, 4, 5)
    moved, ops = chip_smoke.work("sparse_conv", (feats, w, kmap, None, valid), out)
    assert moved == 2 * 2 * 4 + 3 * 3 * 4 + w.numel() * 4 + 4 + out.numel() * 4
    assert ops == 2 * 3 * 3 * 5


def test_chip_smoke_counts_variants_and_refuses_cuda_core_ones():
    """`counting_variants` names the variant of every K1 / K2 call through the
    recorder hook; `check_variants` fails when a call took a CUDA-core variant
    or when the counts do not add up to the expected launches."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from xmask3d_tpu_torch.ops import _build
    from xmask3d_tpu_torch.ops import flash_attention as tfa
    from xmask3d_tpu_torch.ops import sparse_conv as tsc

    table = chip_smoke.kernel_table()
    feats, w = torch.ones(1, 4, 8).bfloat16(), torch.ones(2, 8, 16).bfloat16()
    kmap = torch.tensor([[[0, 1, -1, 3], [-1, 2, 0, 0]]], dtype=torch.int32)
    q = torch.ones(1, 2, 3, 40).bfloat16()
    counts = {}
    with chip_smoke.counting_variants(table, counts):
        tsc.sparse_conv(feats, w, kmap)
        tfa.attention(q, q, q)
        tfa.attention(q, q, q)
    assert _build.RECORDER is None
    assert counts == {"sparse_conv": {tsc.variant(feats, w, kmap): 1},
                      "flash_attention": {"mma_d48_one_tile": 2}}
    expected = {"sparse_conv": 1, "flash_attention": 2, "gn_silu_conv": 0, "deform_attn": 0}
    chip_smoke.check_variants(counts, expected, 1)
    with pytest.raises(AssertionError, match="add up"):
        chip_smoke.check_variants(counts, expected, 2)
    # a kernel with no expected count is an error, not a kernel to skip
    with pytest.raises(KeyError, match="deform_attn"):
        chip_smoke.check_variants(counts, {"sparse_conv": 1, "flash_attention": 2,
                                           "gn_silu_conv": 0}, 1)
    with chip_smoke.counting_variants(table, counts):
        tfa.attention(q.float(), q.float(), q.float())
    with pytest.raises(AssertionError, match="CUDA-core"):
        chip_smoke.check_variants(counts, dict(expected, flash_attention=3), 1)


def test_chip_smoke_refuses_slow_k3_and_k4_variants():
    """K4's bf16 calls must take a tensor-core (`wgmma_`) variant and K3's its
    16-byte-gather (`vec_`) one; a K4 call in fp32 or a K3 head dim the vector
    kernel does not take fails `check_variants`."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from xmask3d_tpu_torch.ops import deform_attn as tda
    from xmask3d_tpu_torch.ops import gn_conv as tgc

    table = chip_smoke.kernel_table()
    x = torch.zeros(1, 4, 6, 32).bfloat16()
    w, v = torch.zeros(3, 3, 32, 16), torch.ones(32)
    value = torch.zeros(1, 5, 2, 32).bfloat16()
    loc, aw = torch.zeros(1, 3, 2, 1, 4, 2), torch.zeros(1, 3, 2, 1, 4)
    counts = {}
    with chip_smoke.counting_variants(table, counts):
        tgc.gn_silu_conv(x, v, v, w, v[:16])
        tda.ms_deform_attn(value, [(1, 5)], loc, aw)
    assert counts == {"gn_silu_conv": {"wgmma_n64": 1}, "deform_attn": {"vec_d32_any": 1}}
    none = {"sparse_conv": 0, "flash_attention": 0, "gn_silu_conv": 0, "deform_attn": 0}
    chip_smoke.check_variants(counts, dict(none, gn_silu_conv=1, deform_attn=1), 1)
    for name, fn, args in (
            ("gn_silu_conv", tgc.gn_silu_conv, (x.float(), v, v, w, v[:16])),
            ("deform_attn", tda.ms_deform_attn,
             (torch.zeros(1, 5, 2, 36).bfloat16(), [(1, 5)], loc, aw))):
        got = {}
        with chip_smoke.counting_variants(table, got):
            fn(*args)
        with pytest.raises(AssertionError, match="scalar variant"):
            chip_smoke.check_variants(got, dict(none, **{name: 1}), 1)
    # K4's only tensor-core variants are the wgmma ones: an mma.sync name fails
    with pytest.raises(AssertionError, match="wgmma_"):
        chip_smoke.check_variants({"gn_silu_conv": {"mma_n128": 1}},
                                  dict(none, gn_silu_conv=1), 1)


def test_resource_usage_reads_ptxas_lines():
    from xmask3d_tpu_torch.ops import _build

    log = (
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__0db9_14_sparse_conv_cu_010b"
        "22sparse_conv_mma_kernelILi64ELi32ELi4EEEvPK13__nv_bfloat16' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN47_x\n"
        "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 80 registers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__666b9db0_14_deform_attn_cu_d4c53d10"
        "18deform_attn_kernelIfEEvPKT_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 16896 bytes smem, 400 bytes cmem[0]\n")
    assert _build.resource_usage(log) == [
        {"kernel": "sparse_conv_mma_kernel<64, 32, 4>", "registers": 80, "spill_stores": 8,
         "spill_loads": 12, "static_smem": 0},
        {"kernel": "deform_attn_kernel", "registers": 40, "spill_stores": 0, "spill_loads": 0,
         "static_smem": 16896}]


def test_gpu_test_file_imports_no_jax():
    """The card's machine has no JAX: the GPU tests must import none of it."""
    path = os.path.join(ROOT, "tests", "test_torch_kernels_gpu.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)]


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs/scannet/xmask3d_*.yaml"))))
def test_config_equals_jax_loader(name):
    """The port parses the YAML subset itself (no PyYAML on the card's
    machine); every value must equal the JAX package's PyYAML reading."""
    path = os.path.join(ROOT, "configs/scannet", name)
    want = jax_load_config(path)
    got = load_config(path)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert dict(got) == dict(want)
    over = ["classes", "20", "mask_shape", "[24, 32]", "category_split.novel_category", "[1]"]
    assert dict(load_config(path, list(over))) == dict(jax_load_config(path, list(over)))


# --------------------------------------------------------------------------
# the weight bridge
# --------------------------------------------------------------------------


def _pairs():
    """(JAX module, its init args, port module, forward args) covering the
    bridge's rules: Conv, GroupNorm, Dense, LayerNorm and MaskedBatchNorm
    (params + batch_stats). Sparse kernels and the rest are carried in
    tests/test_torch_model.py."""
    from xmask3d_tpu.models import backbone as jb, minkunet as jm, pixel_decoder as jp
    from xmask3d_tpu_torch.models import backbone as tb, minkunet as tm, pixel_decoder as tp

    rng = np.random.RandomState(0)
    x = rng.randn(1, 4, 4, 32).astype(np.float32)
    src = rng.randn(1, 20, 16).astype(np.float32)
    pos = rng.randn(1, 20, 16).astype(np.float32)
    ref = rng.uniform(0, 1, (1, 20, 2, 2)).astype(np.float32)
    shapes = [(4, 4), (2, 2)]
    feats = rng.randn(1, 10, 8).astype(np.float32)
    valid = np.ones((1, 10), bool)
    return [
        (jb.BottleneckBlock(64, 16), (x,), tb.BottleneckBlock(32, 64, 16), (x,)),
        (jp.MSDeformAttnLayer(d_model=16, heads=2, points=2, levels=2, ffn_dim=32),
         (src, pos, ref, shapes),
         tp.MSDeformAttnLayer(16, 2, 2, 2, 32), (src, pos, ref, shapes)),
        # eval mode on both sides: the running statistics (the port's
        # module has a train mode too, the default of a new torch module)
        (jm.MaskedBatchNorm(), (feats, valid, False), tm.MaskedBatchNorm(8).eval(),
         (feats, valid)),
    ]


# port module type -> {port tensor: (JAX leaf, transform)}, restated from
# the bridge's documented rules
RULES = {
    "Linear": {"weight": ("kernel", lambda a: a.T)},
    "Conv": {"weight": ("kernel", lambda a: a.transpose(3, 2, 0, 1))},
    "LayerNorm": {"weight": ("scale", None)},
    "GroupNorm": {"weight": ("scale", None)},
}


def _random_like(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: rng.randn(*np.shape(a)).astype(np.float32) + 1.5, tree)


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_bridge_round_trips_every_leaf(idx):
    jmod, jargs, tmod, targs = _pairs()[idx]
    variables = jmod.init(jax.random.PRNGKey(0), *jargs)
    variables = _random_like(jax.device_get(dict(variables)), idx)
    load_jax_variables(tmod, variables)
    flat = {f"{c}/{'/'.join(str(getattr(k, 'key', k)) for k in path)}": leaf
            for c in variables
            for path, leaf in jax.tree_util.tree_flatten_with_path(variables[c])[0]}
    sd = tmod.state_dict()
    assert len(sd) == len(flat)
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        kind = type(tmod.get_submodule(".".join(mods))).__name__
        jleaf, fn = RULES.get(kind, {}).get(leaf, (leaf, None))
        col = "batch_stats" if leaf in ("mean", "var") else "params"
        arr = flat["/".join([col] + mods + [jleaf])]
        np.testing.assert_array_equal(t.numpy(), fn(arr) if fn else arr, err_msg=key)
    # and the two modules compute the same thing
    want = np.asarray(jmod.apply(variables, *jargs))
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in targs])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_bridge_rejects_missing_extra_and_misshapen_leaves():
    jmod, jargs, tmod, _ = _pairs()[0]
    good = jax.device_get(dict(jmod.init(jax.random.PRNGKey(0), *jargs)))

    def edited(fn):
        v = jax.tree_util.tree_map(np.array, good)
        fn(v)
        return v

    with pytest.raises(KeyError, match="1 missing"):
        load_jax_variables(tmod, edited(lambda v: v["params"]["norm2"].pop("bias")))
    with pytest.raises(KeyError, match="1 unused"):
        load_jax_variables(tmod, edited(lambda v: v["params"].update(extra={"kernel": np.ones(3)})))
    with pytest.raises(KeyError, match="1 shape"):
        load_jax_variables(tmod, edited(
            lambda v: v["params"]["conv1"].update(kernel=np.ones((1, 1, 32, 17), np.float32))))
    with pytest.raises(KeyError, match="collections"):
        load_jax_variables(tmod, edited(lambda v: v.update(cache={})))
    load_jax_variables(tmod, good)
