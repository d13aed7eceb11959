"""Build and bind the port's CUDA kernels (``openintel_tpu_torch/csrc``).

``nvcc`` compiles each ``.cu`` source for ``sm_90a`` (one process per
source, all started together) and links the objects into one shared
library with a plain C interface; ``ctypes`` loads it. The library lands in
``build/openintel_tpu_torch/`` beside the package, named by a hash of the
sources, headers and flags, so it is built once per source change and
reused after that. The build runs at first use, never at import. Without
``nvcc`` it raises :class:`KernelBuildError`: there is no fallback.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises :class:`KernelLaunchError`
when that is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "openintel_tpu_torch"
CUDA_ROOT = "/usr/local/cuda"  # searched for bin/nvcc after PATH and CUDA_HOME
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: pointers and the stream as void*, sizes as int.
_SIGNATURES = {
    # q, corpus, k1, k2, s1, s2, b_pad, dim, n_super, group, sub, stream
    "oi_i8_top2g": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, corpus, k1, k2, s1, s2, steps, b_pad, dim, n_super, group, sub, stream
    "oi_i8_top2g_tma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # steps, k1, k2, s1, s2, b_pad, n_super, group, sub, stream
    "oi_i8_fold": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, corpus, out, b_pad, dim, n_super, stream
    "oi_turbo_bf16_tma": [_P, _P, _P, _I, _I, _I, _P],
    # q, docs, is_bf16, part_vals, part_ids, out_vals, out_ids,
    # b, n_docs, dim, k, n_split, split_len, stream
    "oi_fused_topk": [
        _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P
    ],
    # q, docs, is_bf16, shared_thr, part_vals, part_ids, tmp_vals, tmp_ids,
    # out_vals, out_ids, b, n_docs, dim, k, qt, n_split, split_len, cap,
    # sort_len, list_in_smem, stream
    "oi_fused_topk_v2": [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    # q, docs, shared_thr, part_vals, part_ids, tmp_vals, tmp_ids, out_vals,
    # out_ids, b, n_docs, dim, k, n_lists, stream
    "oi_fused_topk_v2_tma": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
    ],
    # q, corpus, out, is_bf16, b_pad, dim, n_super, stream
    "oi_turbo_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    # q, packed corpus, out, slots, b_pad, dim, n_super, stream
    "oi_turbo_i4": [_P, _P, _P, _I, _I, _I, _I, _P],
    # q, packed corpus, out, parts_out, slots, b_pad, dim, n_super, max_parts,
    # stream
    "oi_turbo_i4_tma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, corpus, out, slots, b_pad, dim, n_super, stream
    "oi_turbo_i8": [_P, _P, _P, _I, _I, _I, _I, _P],
    # q, corpus, out, parts_out, slots, b_pad, dim, n_super, max_parts, stream
    "oi_turbo_i8_tma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, corpus, out, b_pad, dim, n_super, stream
    "oi_dot_only": [_P, _P, _P, _I, _I, _I, _P],
    # q, corpus, out, b_pad, dim, n_super, paired, run_cap, stream
    "oi_dot_only_tma": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built (no nvcc, or nvcc failed)."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, under ``$CUDA_HOME/bin`` or under
    ``CUDA_ROOT/bin``. Raises :class:`KernelBuildError` if none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), CUDA_ROOT):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels need the CUDA toolkit to build"
    )


def library_path(extra_flags: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra_flags)).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libopenintel_tpu_torch_{h.hexdigest()[:16]}.so"


def build(extra_flags: tuple[str, ...] = ()) -> tuple[Path, float]:
    """Compile the kernels unless the library for these sources exists.
    Returns (library path, seconds spent compiling; 0.0 when cached). The
    compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``<name>.log``. ``extra_flags`` (measurement builds, such as
    ``-DOI_STREAM_ABLATE=1``) name a library of their own."""
    so = library_path(extra_flags)
    if so.exists():
        return so, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources(), objs)
    ]
    logs = [f"== {src.name}\n{p.communicate()[0]}" for src, p in zip(sources(), procs)]
    failed = [src.name for src, p in zip(sources(), procs) if p.returncode]
    tmp = so.with_name(f"{tag}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(f"== link\n{link.stdout}")
        if link.returncode:
            failed.append("link")
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    so.with_suffix(".log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {failed}:\n{log[-4000:]}")
    os.replace(tmp, so)
    return so, seconds


@functools.cache
def load_library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process and
    set of extra flags."""
    so, _ = build(extra_flags)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.oi_error_string.argtypes = [ctypes.c_int]
    lib.oi_error_string.restype = ctypes.c_char_p
    return lib


_flags: tuple[str, ...] = ()  # the library launch() uses: built with these added


@contextlib.contextmanager
def extra_flags(flags: tuple[str, ...]):
    """Inside the block, :func:`launch` calls the library built with
    ``flags`` added (a measurement build); the wrappers are unchanged."""
    global _flags
    saved, _flags = _flags, tuple(flags)
    try:
        yield
    finally:
        _flags = saved


def launch(name: str, *args) -> None:
    """Call the C entry point ``name``; raise if it reports a CUDA error."""
    lib = load_library(_flags)
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.oi_error_string(rc).decode("ascii", "replace")
        raise KernelLaunchError(f"{name}: CUDA error {rc} ({msg})")


def ptr(t, offset: int = 0) -> ctypes.c_void_p:
    """A tensor's device address, plus ``offset`` bytes, as a C pointer."""
    return ctypes.c_void_p(t.data_ptr() + offset)


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
