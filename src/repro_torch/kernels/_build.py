"""Build the CUDA kernel library at first use and load it with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` (plain C interface, no PyTorch headers,
so a build takes seconds) for ``sm_90a``, one process per source, all
started together, and links the objects into one library in
``build/repro_torch/`` at the root of the checkout, under a name that
carries a hash of the sources, the headers they include (``csrc/*.cuh``)
and the flags: a changed source is rebuilt, an unchanged one is loaded as
built.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["BuildInfo", "load_library", "nvcc_command", "link_command",
           "find_nvcc"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -fmad=false: the plain versions round every product and sum separately,
# and a contracted a*b+c would round once
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_int, _c_ptr, _c_float = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_c_int64 = ctypes.c_longlong
_SIGNATURES = {
    # x, W, i_sites, gumbel, x_out, C, n, S, D, stream
    "gibbs_sweep_launch": [_c_ptr] * 5 + [_c_int] * 4 + [_c_ptr],
    # n, D, mgpmh (0: the Gibbs ring), out (3 int32: chunk, chunks,
    # shared-memory bytes)
    "sweep_ring_plan": [_c_int, _c_int, _c_int, _c_ptr],
    # x (in place), offsets, records, sites, gumbel, C, n, m, D, stream
    "gibbs_class_sweep_launch": [_c_ptr] * 5 + [_c_int] * 4 + [_c_ptr],
    # x, W, row_pack, i_sites, B, u_idx, u_alias, gumbel, logu, x_out,
    # accepts, C, n, S, K, D, scale, stream
    "mgpmh_sweep_launch": [_c_ptr] * 11 + [_c_int] * 5 + [_c_float, _c_ptr],
    # x, W, row_pack, i_sites, B, seed, x_out, accepts, C, n, S, K, D,
    # scale, stream
    "mgpmh_sweep_rng_launch": [_c_ptr] * 8 + [_c_int] * 5 + [_c_float, _c_ptr],
    # x, node_pack, row_pack, i_sites, B, u_node, u_nacc, u_row, u_racc,
    # gumbel, cache, x_out, cache_out, C, n, S, K, D, lscale, stream
    "min_gibbs_sweep_launch": [_c_ptr] * 13 + [_c_int] * 5 + [_c_float,
                                                             _c_ptr],
    # x, node_pack, row_pack, i_sites, B, cache, seed, x_out, cache_out,
    # C, n, S, K, D, lscale, stream
    "min_gibbs_sweep_rng_launch": [_c_ptr] * 9 + [_c_int] * 5 + [_c_float,
                                                                _c_ptr],
    # x, row_pack, node_pack, i_sites, B1, u_idx, u_alias, gumbel, B2,
    # u_node, u_nacc, u_row, u_racc, logu, cache, x_out, cache_out, accepts,
    # C, n, S, K1, K2, D, scale1, lscale2, stream
    "double_min_sweep_launch": [_c_ptr] * 18 + [_c_int] * 6 + [_c_float] * 2
                               + [_c_ptr],
    # x, row_pack, node_pack, i_sites, B1, B2, cache, seed, x_out, cache_out,
    # accepts, C, n, S, K1, K2, D, scale1, lscale2, stream
    "double_min_sweep_rng_launch": [_c_ptr] * 11 + [_c_int] * 6
                                   + [_c_float] * 2 + [_c_ptr],
    # w, v, out, C, K, D, stream
    "bucket_energy_launch": [_c_ptr] * 3 + [_c_int] * 3 + [_c_ptr],
    # x, W, i_sites, seed, x_out, C, n, S, B, D, scale, stream
    "local_gibbs_sweep_launch": [_c_ptr] * 5 + [_c_int] * 5 + [_c_float,
                                                               _c_ptr],
    # q, k, v, out, lse2 (or null), B, Sq, Sk, H, KVH, hd, window, causal,
    # is_bf16, scale, stream
    "flash_attention_launch": [_c_ptr] * 5 + [_c_int] * 9 + [_c_float,
                                                             _c_ptr],
    # 17 carry fields (kernels/telemetry_update.py CARRY_FIELDS), x_old,
    # x_new, accept_delta, stat_prop, stat_acc, sites, cache, C, n, K,
    # head, new_head, live, count_new, second, count_h_new, hi, delta_kind,
    # stats_kind, S, upd, decay, stream
    "telemetry_update_launch": [_c_ptr] * 24 + [_c_int] * 13
                               + [_c_float] * 2 + [_c_ptr],
    # hd -> the bf16 block's dynamic shared memory in bytes
    "flash_attention_bf16_smem": [_c_int],
    # q, k, v, out, dout, dq, dk, dv, lse2, float32 scratch, int32
    # scratch, B, Sq, Sk, H, KVH, hd, window, causal, scale, stream
    "flash_attention_bwd_launch": [_c_ptr] * 11 + [_c_int] * 8
                                  + [_c_float, _c_ptr],
    # hd, kernel (0: dK/dV, 1: dQ) -> a block's dynamic shared memory
    "flash_attention_bwd_smem": [_c_int, _c_int],
    # dt, x, z, B, C, A, D, y, ckpt (or null), bsz, S, d_inner, N, z's row
    # stride, stream
    "selective_scan_launch": [_c_ptr] * 9 + [_c_int] * 4 + [_c_int64,
                                                            _c_ptr],
    # bsz, S, d_inner, N, out (4 int32: lanes, channels, threads, tile)
    "selective_scan_layout": [_c_int] * 4 + [_c_ptr],
    # dt, x, z, B, C, A, D, dy, ckpt, ddt, dx, dz, dBC, dAD, part_bc,
    # part_ad, bsz, S, d_inner, N, z's row stride, stream
    "selective_scan_bwd_launch": [_c_ptr] * 16 + [_c_int] * 4 + [_c_int64,
                                                                 _c_ptr],
    # bsz, S, d_inner, N, out (7 int32: lanes, channels, threads, tile,
    # chunks, channel blocks, shared memory bytes)
    "selective_scan_bwd_layout": [_c_int] * 4 + [_c_ptr],
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """The loaded library and how it was made."""
    lib: ctypes.CDLL
    fns: dict           # launch name -> its ctypes function, typed once
    path: Path
    seconds: float      # nvcc wall time; 0.0 when an earlier build was reused
    log: str            # nvcc's output (-Xptxas -v: registers, smem, spills)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "are built from source at first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def nvcc_command(nvcc: str, source: Path, obj: Path):
    """Compile one source into an object file."""
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(source)]


def link_command(nvcc: str, objects, out: Path):
    """Link the objects into the shared library (for the same target, so
    nvcc does not assume its deprecated default one)."""
    return [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(out),
            *map(str, objects)]


def _compile_and_link(nvcc: str, sources, out: Path, tmpdir: Path) -> str:
    """Compile every source in its own nvcc process, all at once, then link;
    returns the compilers' output.  Raises if any step fails."""
    objects = [tmpdir / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen(nvcc_command(nvcc, src, obj),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        text = proc.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    proc = subprocess.run(link_command(nvcc, objects, out),
                          capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    return log


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def load_library() -> BuildInfo:
    """Build (if needed) and load the kernel library; one per process."""
    sources = _sources()
    out = BUILD_DIR / f"libkernels-{_digest(sources)}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build in a temporary directory, then rename: a concurrent process
        # never loads a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            fresh = Path(tmp) / out.name
            t0 = time.perf_counter()
            log = _compile_and_link(find_nvcc(), sources, fresh, Path(tmp))
            seconds = time.perf_counter() - t0
            os.replace(fresh, out)
    lib = ctypes.CDLL(str(out))
    fns = {}
    for name, argtypes in _SIGNATURES.items():
        fn = fns[name] = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return BuildInfo(lib=lib, fns=fns, path=out, seconds=seconds, log=log)
