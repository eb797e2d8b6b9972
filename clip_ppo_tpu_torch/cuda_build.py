"""Build and load the package's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, from the sources in this checkout only, into
``_build/`` beside this file; a library's file name carries a hash of its
source and of the shared headers (``csrc/*.cuh``), so an edited source or
header is always rebuilt. All sources compile in
parallel, one ``nvcc`` process each.

Every kernel wrapper counts its launches in :data:`LAUNCHES`, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = {
    "disturb": "disturb.cu",
    "attn_block": "attn_block.cu",
    "mlp_block": "mlp_block.cu",
    "mlp_stream": "mlp_stream.cu",
    "fused_qkv": "fused_qkv.cu",
    "attn_stream": "attn_stream.cu",
    "mlp_chunked": "mlp_chunked.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launches of each kernel since the last reset_launches(); each wrapper adds
# one where it launches its kernel and nowhere else. fused_qkv.cu has two
# entry points, K4 ("fused_qkv") and K8 ("packed_attention"), counted apart.
LAUNCHES: dict[str, int] = {name: 0 for name in [*SOURCES, "packed_attention"]}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
        "kernels of clip_ppo_tpu_torch need the CUDA toolkit to build"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


@functools.lru_cache(maxsize=1)
def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel and load all of them.
    Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, out)
    errors = []
    for name, (proc, tmp, out) in pending.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    libs = {name: ctypes.CDLL(str(_lib_path(name))) for name in SOURCES}
    _declare(libs)
    return libs


def build_log(name: str) -> str:
    """nvcc's output (register and shared-memory use) from this build."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def _declare(libs: dict[str, ctypes.CDLL]) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    u32 = ctypes.c_uint32
    sig = {
        ("disturb", "disturb_launch"): [*[p] * 7, i, i, i, i, f, i, i, i, i, p],
        ("disturb", "disturb_empty_launch"): [i, i, p],
        ("disturb", "philox_normal_launch"): [p, u32, u32, i, p],
        ("attn_block", "attn_block_launch"): [*[p] * 11, i, i, i, i, i, f, p],
        ("mlp_block", "mlp_block_launch"): [*[p] * 10, i, i, i, f, p],
        ("mlp_stream", "mlp_stream_launch"): [*[p] * 10, i, i, i, f, p],
        ("fused_qkv", "fused_qkv_launch"): [p, p, i, i, i, i, p],
        ("fused_qkv", "packed_attention_launch"): [p, p, p, p, i, i, i, *[ll] * 9, p],
        ("attn_stream", "attn_stream_launch"): [*[p] * 11, i, i, i, i, i, f, p],
        ("mlp_chunked", "mlp_chunked_launch"): [*[p] * 10, i, i, i, i, f, p],
    }
    for (lib, fn), argtypes in sig.items():
        func = getattr(libs[lib], fn)
        func.argtypes = argtypes
        func.restype = ctypes.c_int


def launch(lib: str, fn: str, *args) -> None:
    """Call a C entry point; raise if it reports a CUDA error. While
    torch.profiler records, the call runs inside a range named after the
    entry point (``mlp_stream_launch``, ...), so a trace gives each ported
    kernel its own device time where several share one template (the GEMM of
    K2 and K5, the LayerNorm statistics, the attention tile)."""
    import torch

    entry = getattr(build_all()[lib], fn)
    if torch._C._autograd._profiler_enabled():
        with torch.profiler.record_function(fn):
            err = entry(*args)
    else:
        err = entry(*args)
    if err != 0:
        raise RuntimeError(f"{lib}.{fn} failed with CUDA error {err}")


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream, read as
    PyTorch's own generated kernels read it: ``torch.cuda.current_stream``
    builds a ``Stream`` object on every call, which costs about as much host
    time as the kernel's launch itself."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def ptr(t) -> int | None:
    """Device pointer of a tensor (None passes NULL)."""
    return None if t is None else t.data_ptr()
