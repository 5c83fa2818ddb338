"""ctypes bindings of the C++ kernel-map builder (`csrc/kernel_maps.cpp`).

Counterpart of `xmask3d_tpu/data/native.py`. The library is built at first
use with `g++ -O3 -fPIC -shared -std=c++17` into `xmask3d_tpu_torch/_build/`
and rebuilt when its source is newer, under the kernels' build lock
(`ops/_build.py`): threads that ask for it at once build it once. The
compiler writes a temporary file that is then renamed, so processes that
build at once never load a half-written library.

There is no fallback: a missing compiler or a failed build raises, with
the compiler's output. The numpy builder (`ops/sparse_conv.py`,
`builder="numpy"`) runs only when a caller asks for it.

Every function takes non-negative int32 coordinates below 2^20 per axis
(checked here): the C++ integer division truncates toward zero where numpy
floors, and the two agree only on such values. The foreign calls release
the GIL, so prefetch threads build maps in parallel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from xmask3d_tpu_torch.ops import _build

SOURCE = _build.CSRC / "kernel_maps.cpp"
LIBRARY = _build.BUILD_DIR / "libkernel_maps.so"
EXTENT = 1 << 20  # the hash keys hold 20 bits per axis

_LIB: Optional[ctypes.CDLL] = None


def cxx_path() -> str:
    """The C++ compiler: $CXX, else g++ on PATH."""
    found = os.environ.get("CXX") or shutil.which("g++")
    if not found:
        raise RuntimeError("the native kernel-map builder needs a C++ compiler: "
                           "put g++ on PATH or set CXX")
    return found


def build(source: Path, library: Path) -> None:
    """Compile `source` into `library`; raises with the compiler's output."""
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_suffix(f".{os.getpid()}.tmp")
    # no -march=native: a library built on one host must run on another
    cmd = [cxx_path(), "-O3", "-fPIC", "-shared", "-std=c++17", "-o", str(tmp), str(source)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)} did not run: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, library)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first when it is missing or older than its
    source."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _build._LOCK:
        if _LIB is None:
            if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
                build(SOURCE, LIBRARY)
            lib = ctypes.CDLL(str(LIBRARY))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64, i32 = ctypes.c_int64, ctypes.c_int32
            lib.xm_build_kmap.argtypes = [i32p, i64, i32p, i64, i32p, i32, i64, i32p]
            lib.xm_build_kmap.restype = None
            lib.xm_unique_parents.argtypes = [i32p, i64, i32, i64, i32p]
            lib.xm_unique_parents.restype = i64
            lib.xm_parent_octant.argtypes = [i32p, i64, i32p, i64, i32, i64, i32p, i32p]
            lib.xm_parent_octant.restype = None
            lib.xm_sparse_quantize.argtypes = [i32p, i64, i32p, i32p]
            lib.xm_sparse_quantize.restype = i64
            _LIB = lib
    return _LIB


def _coords(c: np.ndarray, what: str) -> np.ndarray:
    c = np.ascontiguousarray(c, dtype=np.int32)
    if c.ndim != 2 or c.shape[1] != 3:
        raise ValueError(f"{what}: coords must be (N, 3), got {c.shape}")
    if len(c) and (c.min() < 0 or c.max() >= EXTENT):
        raise ValueError(f"{what}: coords must lie in [0, {EXTENT}) per axis, "
                         f"got [{c.min()}, {c.max()}]")
    return c


def build_kmap(coords: np.ndarray, out_coords: np.ndarray, offsets: np.ndarray,
               capacity: int) -> np.ndarray:
    """(K, capacity) int32: for each offset and output coord, the row of
    `coords` at out + offset, or -1; columns past the outputs are -1."""
    coords = _coords(coords, "build_kmap")
    out_coords = _coords(out_coords, "build_kmap")
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    if offsets.ndim != 2 or offsets.shape[1] != 3:
        raise ValueError(f"build_kmap: offsets must be (K, 3), got {offsets.shape}")
    if len(out_coords) > capacity:
        raise ValueError(f"build_kmap: {len(out_coords)} outputs over capacity {capacity}")
    kmap = np.empty((len(offsets), capacity), np.int32)
    get_lib().xm_build_kmap(coords, len(coords), out_coords, len(out_coords), offsets,
                            len(offsets), capacity, kmap)
    return kmap


def unique_parents(coords: np.ndarray, stride: int, capacity: int) -> np.ndarray:
    """The distinct (c // stride * stride) in first-occurrence order, at most
    `capacity` of them."""
    coords = _coords(coords, "unique_parents")
    out = np.empty((capacity, 3), np.int32)
    m = get_lib().xm_unique_parents(coords, len(coords), stride, capacity, out)
    return out[:m].copy()


def parent_octant(coords: np.ndarray, parent_coords: np.ndarray, stride: int,
                  capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """((capacity,) parent row, (capacity,) octant) of each coord at the
    next level (stride 2 * `stride`): the row of its parent in
    `parent_coords` or -1, and x*4 + y*2 + z of (c // stride) % 2; -1 and 0
    past the coords."""
    coords = _coords(coords, "parent_octant")
    parent_coords = _coords(parent_coords, "parent_octant")
    if len(coords) > capacity:
        raise ValueError(f"parent_octant: {len(coords)} coords over capacity {capacity}")
    pidx = np.empty((capacity,), np.int32)
    octant = np.empty((capacity,), np.int32)
    get_lib().xm_parent_octant(coords, len(coords), parent_coords, len(parent_coords), stride,
                               capacity, pidx, octant)
    return pidx, octant


def sparse_quantize_native(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact dedup: (inds, inverse), the first point of each distinct coord in
    first-occurrence order (not the key order of `voxelizer.sparse_quantize`)
    and each point's voxel row."""
    coords = _coords(coords, "sparse_quantize_native")
    n = len(coords)
    inds = np.empty((n,), np.int32)
    inverse = np.empty((n,), np.int32)
    m = get_lib().xm_sparse_quantize(coords, n, inds, inverse)
    return inds[:m].copy(), inverse
