"""The port's C++ kernel-map builder (`data/native.py`, `csrc/kernel_maps.cpp`)
against its numpy builder and the JAX package's `build_hierarchy`.

- Every leaf of the hierarchy, bit for bit, on random coordinate sets, on
  coords at the grid's edges (0 and 1023, whose neighbour offsets step
  outside it: those map entries are -1 on both routes) and at capacities
  that overflow at every level.
- `sparse_quantize_native`'s inverse map.
- No fallback: without a compiler, or with one that fails, the default
  route raises; the numpy builder runs only when asked for; threads that
  ask for the library at once build it once.
"""

import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from xmask3d_tpu.ops import sparse_conv as jsc
from xmask3d_tpu_torch.data import native
from xmask3d_tpu_torch.data.batching import Capacities, ViewSample, collate_views
from xmask3d_tpu_torch.ops import sparse_conv as tsc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unique(rng, n, lo, hi):
    return np.unique(rng.randint(lo, hi, (n, 3)).astype(np.int32), axis=0)


def _edges():
    """Voxels on the faces, edges and corners of [0, 1023]^3 and beside them,
    in a shuffled order."""
    rng = np.random.RandomState(3)
    vals = np.array([0, 1, 2, 511, 512, 1021, 1022, 1023], np.int32)
    grid = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1).reshape(-1, 3)
    return grid[rng.permutation(len(grid))]


CASES = {
    # (coords, capacities)
    "random": (lambda: _unique(np.random.RandomState(0), 600, 0, 24), (1024, 512, 256, 128, 64)),
    "sparse_wide": (lambda: _unique(np.random.RandomState(1), 500, 0, 1024),
                    (512, 256, 128, 64, 32)),
    "edges": (_edges, (512, 256, 128, 64, 32)),
    # every level overflows its capacity: voxels past it are dropped
    "overflow": (lambda: _unique(np.random.RandomState(2), 3000, 0, 40), (700, 120, 40, 16, 16)),
    "empty": (lambda: np.zeros((0, 3), np.int32), (64, 32, 16, 16, 16)),
}


def _leaves(h):
    """(name, array) of every leaf of a port HostHierarchy."""
    out = []
    for f in dataclasses.fields(h):
        v = getattr(h, f.name)
        if v is None:  # the brick metadata, built only with a brick_divisor
            continue
        if isinstance(v, list):
            out += [(f"{f.name}[{i}]", np.asarray(x)) for i, x in enumerate(v)]
        else:
            out.append((f.name, np.asarray(v)))
    return out


def _jax_leaves(h):
    """The JAX SparseHierarchy's leaves in the port's order."""
    levels = h.levels
    out = [(f"coords[{i}]", l.coords) for i, l in enumerate(levels)]
    out += [(f"valid[{i}]", l.valid) for i, l in enumerate(levels)]
    out += [(f"kmap3[{i}]", l.kmap3) for i, l in enumerate(levels)]
    out += [(f"num[{i}]", np.int32(l.num)) for i, l in enumerate(levels)]
    out += [(f"down[{i}]", x) for i, x in enumerate(h.down)]
    out += [(f"up_parent[{i}]", x) for i, x in enumerate(h.up_parent)]
    out += [(f"up_octant[{i}]", x) for i, x in enumerate(h.up_octant)]
    out.append(("kmap5", h.kmap5))
    return [(n, np.asarray(x)) for n, x in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_equals_numpy_equals_jax(case):
    make, caps = CASES[case]
    coords = make()
    got = _leaves(tsc.build_hierarchy(coords, caps, builder="native"))
    oracle = _leaves(tsc.build_hierarchy(coords, caps, builder="numpy"))
    want = _jax_leaves(jsc.build_hierarchy(coords, caps))
    assert [n for n, _ in got] == [n for n, _ in oracle] == [n for n, _ in want]
    for (name, g), (_, o), (_, w) in zip(got, oracle, want):
        assert g.dtype == o.dtype and (name.startswith("num") or g.dtype == w.dtype), name
        np.testing.assert_array_equal(g, o, err_msg=name)
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_offsets_past_the_grid_map_to_minus_one():
    """The corner voxels' neighbours outside [0, 1023] are -1 in every map
    of both routes; the corners' in-grid neighbours are found."""
    coords = np.array([[0, 0, 0], [1023, 1023, 1023], [1, 1, 1], [1022, 1022, 1022]], np.int32)
    caps = (16, 16, 16, 16, 16)
    for builder in ("native", "numpy"):
        h = tsc.build_hierarchy(coords, caps, builder=builder)
        k3 = h.kmap3[0]
        assert k3[0, 0] == -1 and k3[13, 0] == 0 and k3[26, 0] == 2  # (-1,-1,-1), self, (+1,+1,+1)
        assert k3[26, 1] == -1 and k3[13, 1] == 1 and k3[0, 1] == 3
        assert (h.kmap5[:, 0][[0, 31, 62]] == [-1, -1, 0]).all()  # (-2,-2,-2), (-1,-1,-1), self
        assert (h.kmap5[124, 1] == -1) and (h.kmap5[:, 4:] == -1).all()


def test_sparse_quantize_native_inverse():
    rng = np.random.RandomState(1)
    base = _unique(rng, 100, 0, 6)
    coords = np.concatenate([base, base[::-1], base[::3]])[rng.permutation(2 * len(base) +
                                                                          len(base[::3]))]
    inds, inverse = native.sparse_quantize_native(coords)
    assert len(inds) == len(base)
    np.testing.assert_array_equal(coords[inds][inverse], coords)
    # representatives in first-occurrence order
    assert (np.diff(inds) > 0).all()
    assert len(np.unique(coords[inds], axis=0)) == len(inds)


def test_native_refuses_coords_it_cannot_hash():
    for bad in (np.array([[-1, 0, 0]], np.int32), np.array([[0, 1 << 20, 0]], np.int32)):
        with pytest.raises(ValueError, match="lie in"):
            tsc.build_hierarchy(bad, (16, 16, 16, 16, 16), builder="native")
    with pytest.raises(ValueError, match="builder"):
        tsc.build_hierarchy(np.zeros((1, 3), np.int32), (16,) * 5, builder="torch")


@pytest.fixture
def fresh_library(monkeypatch, tmp_path):
    """The native module pointed at a library path of its own, not built."""
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "libkernel_maps.so")
    monkeypatch.setattr(native, "_LIB", None)
    return tmp_path / "libkernel_maps.so"


def _sample(coords):
    n = len(coords)
    return ViewSample(voxel_coords=coords, voxel_feats=np.zeros((n, 3), np.float32),
                      inds_reconstruct=np.arange(n), labels_3d=np.zeros(n, np.int64),
                      binary_label_3d=np.zeros(n, np.float32), x_label=np.zeros(n, np.int64),
                      y_label=np.zeros(n, np.int64), img=np.zeros((8, 8, 3), np.float32),
                      label_2d=np.zeros((8, 8), np.int64),
                      binary_label_2d=np.zeros((8, 8), np.float32),
                      caption_tokens=np.zeros(4, np.int32))


def test_a_missing_compiler_raises_and_nothing_falls_back(monkeypatch, fresh_library):
    """Without a C++ compiler the default route (`build_hierarchy`,
    `collate_views`) raises; only an explicit builder="numpy" runs."""
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    coords = _unique(np.random.RandomState(4), 50, 0, 8)
    caps = Capacities(max_points=64, max_voxels=64, max_targets=4)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        tsc.build_hierarchy(coords, caps.level_caps())
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        collate_views([_sample(coords)], caps, device="cpu")
    assert not fresh_library.exists() and native._LIB is None
    h = collate_views([_sample(coords)], caps, device="cpu", builder="numpy")["hierarchy"]
    assert int(h.levels[0].num[0]) == len(coords)


def test_a_failing_build_raises_with_the_compilers_output(monkeypatch, fresh_library, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed") as err:
        native.get_lib()
    assert "broken.cpp" in str(err.value) and not fresh_library.exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_threads_that_ask_at_once_build_the_library_once(monkeypatch, fresh_library):
    built = []
    real_build = native.build

    def counting_build(*args):
        built.append(threading.get_ident())
        real_build(*args)

    monkeypatch.setattr(native, "build", counting_build)
    coords = _unique(np.random.RandomState(5), 200, 0, 10)
    want = tsc.build_hierarchy(coords, (256, 128, 64, 32, 16), builder="numpy")
    out, errors = [None] * 4, []

    def work(i):
        try:
            out[i] = tsc.build_hierarchy(coords, (256, 128, 64, 32, 16))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(built) == 1 and fresh_library.exists()
    for h in out:
        for (name, g), (_, w) in zip(_leaves(h), _leaves(want)):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_a_newer_source_rebuilds_the_library(monkeypatch, fresh_library, tmp_path):
    src = tmp_path / "kernel_maps.cpp"
    src.write_text(native.SOURCE.read_text())
    monkeypatch.setattr(native, "SOURCE", src)
    native.get_lib()
    first = fresh_library.stat().st_mtime
    os.utime(src, (first + 10, first + 10))
    monkeypatch.setattr(native, "_LIB", None)
    native.get_lib()
    assert fresh_library.stat().st_mtime > first


def test_the_port_loads_its_own_library_not_the_jax_packages():
    """After the port builds a hierarchy, the process has mapped
    `xmask3d_tpu_torch/_build/libkernel_maps.so` and not the JAX package's
    `native/libkernel_maps.so`."""
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from xmask3d_tpu_torch.ops.sparse_conv import build_hierarchy\n"
        "build_hierarchy(np.zeros((1, 3), np.int32), (16,) * 5)\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('port' if 'xmask3d_tpu_torch/_build/libkernel_maps.so' in maps else 'none')\n"
        "print('jax' if 'native/libkernel_maps.so' in maps else 'clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["port", "clean"]
    assert native.LIBRARY.parent.name == "_build" and native.SOURCE.parent.name == "csrc"
    assert "xmask3d_tpu_torch" in native.LIBRARY.parts


def test_jax_hierarchies_stack_like_the_ports():
    """The port's stacked batch tree equals the JAX package's stacked tree."""
    cs = [CASES["random"][0](), CASES["edges"][0]()[:400]]
    caps = (1024, 512, 256, 128, 64)
    got = tsc.stack_hierarchies([tsc.build_hierarchy(c, caps) for c in cs])
    want = jsc.stack_hierarchies([jsc.build_hierarchy(c, caps) for c in cs])
    for lt, lj in zip(got.levels, want.levels):
        for name in ("coords", "valid", "kmap3", "num"):
            np.testing.assert_array_equal(getattr(lt, name).numpy(), np.asarray(getattr(lj, name)))
    for name in ("down", "up_parent", "up_octant"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.kmap5.numpy(), np.asarray(want.kmap5))


def test_scene_loop_on_either_builder_records_its_host_stages():
    """`run_scene` with the native and the numpy builder gives the same
    predictions and votes, and records each view's host seconds for every
    stage of `STAGES`."""
    import torch

    from xmask3d_tpu_torch.config import load_config
    from xmask3d_tpu_torch.data.synthetic import synthetic_scene
    from xmask3d_tpu_torch.engine import builder, infer_cli

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = load_config(os.path.join(ROOT, "configs/scannet/xmask3d_scannet_B15N4.yaml"))
        cfg.update(arch_3d="MinkUNet14A", arch_binary_head="MinkUNet14A", mask_shape=[24, 32],
                   compute_dtype="float32", dec_layers=2, pixel_enc_layers=2)
        caps = Capacities(max_points=512, max_voxels=256, max_targets=8)
        scene = synthetic_scene(caps, seed=3, num_points=900, num_views=2,
                                num_classes=cfg.test_classes)
        model = builder.build_model(cfg, tiny=True, device="cpu")
        step, route = infer_cli.make_infer_step(model, cfg)
        statics = builder.build_statics(model, cfg, device="cpu")
        records = {}
        preds = {}
        for b in ("native", "numpy"):
            records[b] = {}
            preds[b] = infer_cli.run_scene(scene, step, route, statics, caps, 19, device="cpu",
                                           record=records[b], builder=b)
    finally:
        torch.set_num_threads(n_threads)
    for k in preds["native"]:
        np.testing.assert_array_equal(preds["native"][k], preds["numpy"][k])
    assert records["native"]["counter"] == records["numpy"]["counter"]
    for rec in records.values():
        assert list(rec["host_seconds"]) == list(infer_cli.STAGES)
        assert all(len(v) == 2 and min(v) >= 0 for v in rec["host_seconds"].values())
        assert min(rec["host_seconds"]["hierarchy"]) > 0
