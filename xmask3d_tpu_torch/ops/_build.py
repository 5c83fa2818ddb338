"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface and loaded with `ctypes`. Wrappers pass raw device
pointers (`tensor.data_ptr()`) and PyTorch's current stream as `c_void_p`;
every C entry point returns `cudaGetLastError()` after its launch and
`check` raises when that is not 0.

Libraries go to `xmask3d_tpu_torch/_build/` (git-ignored) and are rebuilt
when their source is newer. `build_all` starts one `nvcc` per source at once
and returns nvcc's output, which holds ptxas' resource usage per kernel
(`resource_usage` parses it).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("sparse_conv", "flash_attention", "deform_attn", "gn_conv")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> function that sets argtypes/restype on the loaded library
BINDERS: Dict[str, Callable[[ctypes.CDLL], None]] = {}
_LOCK = threading.Lock()

# Optional hook, None by default: when set, every kernel wrapper calls
# RECORDER(name, args) with its checked arguments, all positional, before it
# runs (kernel or plain version). `chip_smoke.py` records a view's calls so.
# It is not called while a CUDA graph is being captured: what it does with
# the arguments (copies, host reads) does not belong in the graph.
RECORDER: Optional[Callable[[str, Tuple], None]] = None


def record(name: str, *args) -> None:
    if RECORDER is not None and not _capturing():
        RECORDER(name, args)


def _capturing() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])  # shared headers
    return not lib.exists() or lib.stat().st_mtime < newest


def _command(name: str) -> List[str]:
    src, lib = _paths(name)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    return [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v",  # registers, spills and shared memory per kernel, into the build log
        "-o", str(tmp), str(src),
    ]


def build_all(names: Iterable[str] = KERNELS) -> str:
    """Compile every stale source in parallel; returns nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        if _stale(name):
            cmd = _command(name)
            procs.append((name, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
    log = []
    failed = []
    for name, cmd, p in procs:
        out, _ = p.communicate()
        log.append(f"[{name}] {out}")
        tmp = Path(cmd[cmd.index("-o") + 1])
        if p.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _paths(name)[1])
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return "\n".join(log)


def resource_usage(log: str) -> List[dict]:
    """ptxas' verbose lines of a build log as one dict per compiled kernel:
    its name with its integer template arguments, registers, spill
    stores/loads and static shared memory (bytes)."""
    import re

    rows, name = [], None
    spill = (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            # the mangled name holds <length><function name>, then I Li<n>E ... E
            # (every suffix of a digit run is tried: a hash may end in digits)
            for ln in re.finditer(r"(?=(\d+)[a-z])", name):
                start = ln.end(1)
                end = start + int(ln.group(1))
                if name[start:end].endswith("_kernel"):
                    args = re.match(r"I((?:Li\d+E)+)E", name[end:])
                    ints = re.findall(r"Li(\d+)E", args.group(1)) if args else []
                    name = name[start:end] + (f"<{', '.join(ints)}>" if ints else "")
                    break
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append({"kernel": name, "registers": int(m.group(1)),
                         "spill_stores": spill[0], "spill_loads": spill[1],
                         "static_smem": int(smem.group(1)) if smem else 0})
            name = None
    return rows


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(str(_paths(name)[1]))
            BINDERS[name](lib)
            _LIBS[name] = lib
        return _LIBS[name]


def plain_vjp(plain: Callable, args: Tuple, needs: Iterable[bool], grad) -> Tuple:
    """The backward of a kernel's autograd Function, as the JAX package takes
    its kernels' backward through `custom_vjp`: recompute the plain version
    `plain(*args)` on the saved inputs under autograd and return its VJP
    with cotangent `grad`, one gradient (in the argument's dtype) for each
    argument whose `needs` flag is set and None for the others. The
    recompute is plain PyTorch: it records and launches no kernel, and its
    graph is freed when this returns."""
    import torch

    needs = list(needs)
    if not any(needs):
        return (None,) * len(args)
    xs = [a.detach().requires_grad_() if n else a for a, n in zip(args, needs)]
    wrt = [x for x, n in zip(xs, needs) if n]
    with torch.enable_grad():
        out = plain(*xs)
        grads = torch.autograd.grad(out, wrt, grad.contiguous(), allow_unused=True)
    grads = iter(grads)
    result = []
    for x, n in zip(xs, needs):
        if not n:
            result.append(None)
            continue
        gx = next(grads)
        result.append(torch.zeros_like(x) if gx is None else gx.to(x.dtype))
    return tuple(result)


def require_contiguous(what: str, *tensors) -> None:
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous, got strides {t.stride()}")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
