"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``gbp_poplar_tpu_torch/_build/`` (listed in
.gitignore), keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once. Each ``.cu`` file is compiled
by its own ``nvcc`` process, all started together, and the objects are
then linked into the library.

Flags: ``-O3`` and no ``--use_fast_math`` (it changes division, sqrt and
denormals, and with them relinearisation decisions). ``-fmad=false`` keeps
the compiler from contracting a multiply and an add into one FMA: every
``+ - * /`` then rounds as the plain PyTorch version's separate elementwise
operations do, so kernel and plain version take the same discrete
decisions (relinearise, Huber, PSD holds) on all but borderline lanes.
``-Xptxas -v`` records registers and spills in ``_build/ptxas-<hash>.log``.

Nothing here runs at import: this module is imported on machines without
nvcc or a GPU, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
ptxas_log = None          # path of the -Xptxas -v output of the build


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (see the module docstring).
    Raises RuntimeError with nvcc's output if the build fails."""
    global _lib, ptxas_log
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    tag = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libgbp_kernels-{tag}.so")
    log = os.path.join(BUILD_DIR, f"ptxas-{tag}.log")
    if not os.path.exists(so):
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            nvcc = _nvcc()
            jobs = []
            for src in (s for s in srcs if s.endswith(".cu")):
                obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            out = ""
            for cmd, _, proc in jobs:
                text = proc.communicate()[0]
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                        f"{text}")
                out += text
            tmp = os.path.join(tmpdir, "lib.so")
            cmd = [nvcc, "-shared", "-o", tmp, *[o for _, o, _ in jobs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}"
                    f"\n{proc.stdout}\n{proc.stderr}")
            with open(log, "w") as f:
                f.write(out)
            os.replace(tmp, so)
    ptxas_log = log
    lib = ctypes.CDLL(so)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gbp_tables_launch.argtypes = [p, i, p, p, i, p, p]
    lib.gbp_reduce_launch.argtypes = [p, ll, i, p, i, p, p, i, p]
    lib.gbp_sweep_launch.argtypes = [p] * 12 + [i, p]
    lib.gbp_sweep_planes_launch.argtypes = [p] * 10 + [i, p]
    lib.gbp_reduce_chunks_launch.argtypes = [p, ll, i, p, p, p, p, p, i, i,
                                             i, i, i, p, p, p, p]
    lib.gbp_gather_launch.argtypes = [p, ll, i, p, p, ll, p]
    lib.gbp_sweep_config.argtypes = [p] * 4
    lib.gbp_sweep_config.restype = None
    lib.gbp_reduce_chunks_smem.argtypes = [i]
    lib.gbp_reduce_chunks_smem.restype = i
    for fn in (lib.gbp_tables_launch, lib.gbp_reduce_launch,
               lib.gbp_reduce_chunks_launch, lib.gbp_sweep_launch,
               lib.gbp_sweep_planes_launch, lib.gbp_gather_launch):
        fn.restype = i
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def sweep_config() -> tuple[int, int, int, int]:
    """The launch shape of H1 and H4: (warps per block, stages per warp,
    H1's and H4's dynamic shared memory per block in bytes)."""
    vals = [ctypes.c_int() for _ in range(4)]
    library().gbp_sweep_config(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)
