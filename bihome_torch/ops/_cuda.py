"""Build and load the port's CUDA kernels (``bihome_torch/csrc/*.cu``).

Each source is compiled by nvcc for ``sm_90a`` into a shared library with a
plain C interface and loaded with ctypes. Nothing is built at import: the
first wrapper call on a CUDA tensor builds its library, and
:func:`build` compiles several sources in parallel (one nvcc each).
Libraries land in ``build/kernels/`` at the repository root (gitignored),
named by a hash of the source and flags so a changed source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    path = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin/nvcc'
    if path.exists():
        return str(path)
    raise RuntimeError('nvcc not found: the CUDA kernels build only where '
                       'the CUDA toolkit is installed')


def library_path(name: str) -> Path:
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha1(src.read_bytes()
                          + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources, all nvcc processes started together.

    Returns nvcc's output (ptxas register/spill report) per source built;
    sources whose library already exists are skipped. Raises on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs: Dict[str, str] = {}
    failed = []
    for name, out, tmp, proc in procs:
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc failed for {name}.cu:\n{logs[name]}')
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return logs


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Load (building first if needed) ``lib<name>``; ``signatures`` maps
    each C entry point to its ctypes argtypes. Every entry returns int."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check_status(status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f'{what}: CUDA error {status}')


def check_cuda_tensor(t, name: str, dim: int,
                      dtype: torch.dtype = torch.float32) -> None:
    """The kernels take contiguous tensors of ``dtype`` (float32 unless
    stated) on the current device."""
    if t.device.type != 'cuda':
        raise ValueError(f'{name} must be a CUDA tensor, got {t.device}')
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f'{name} is on {t.device}, not the current device '
                         f'cuda:{torch.cuda.current_device()}')
    if t.dtype != dtype:
        raise ValueError(f'{name} must be {dtype}, got {t.dtype}')
    if t.dim() != dim:
        raise ValueError(f'{name} must have {dim} dims, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def stream_ptr(index: int) -> int:
    """The current CUDA stream of device ``index`` as the pointer the C
    entry points take (without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(index)
