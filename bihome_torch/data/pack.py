"""Image packs (``.bhpk``) for the port: the writer, the dataset and the
prefetching batch loader (counterparts of ``bihome_tpu/data/pack.py``).

All images of a split live in one contiguous uint8 file. The reader is
the framework-free C++ library ``native/pack_reader.cc`` (mmap, a
parallel memcpy gather, an epoch prefetch ring), bound here with ctypes.
It is built on first use with ``g++`` into ``build/native/`` at the
repository root (gitignored), named by a hash of the source and flags so
a changed source rebuilds; the JAX package's ``native/Makefile`` output
is not used. ``PackDataset(path, prefer_native=False)`` reads the pack
through a numpy memmap instead. Unlike the JAX package, a native reader
that was asked for and cannot be built or loaded raises rather than
falling back to the memmap.

Pack format v1 (little-endian):
    0: b'BHPK'  4: u32 version=1  8: u64 count
    16: u32 height  20: u32 width  24: u32 channels  28: u32 reserved
    32: count*H*W*C uint8, image-major
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from bihome_torch.data.datasets import EpochSampler

_MAGIC = b'BHPK'
_HEADER = struct.Struct('<4sIQIIII')   # magic, version, count, H, W, C, rsvd
HEADER_BYTES = _HEADER.size
assert HEADER_BYTES == 32

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / 'native' / 'pack_reader.cc'
BUILD_DIR = _REPO / 'build' / 'native'
# No -march=native: the library may be built on one host and run on
# another that shares the checkout.
CXX_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-shared', '-pthread')
_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def write_pack(path: str, images) -> None:
    """Write an iterable of [H,W,C] uint8 images (all same shape) as .bhpk."""
    it = iter(images)
    try:
        first = np.ascontiguousarray(next(it), dtype=np.uint8)
    except StopIteration:
        raise ValueError('cannot write an empty pack')
    if first.ndim == 2:
        first = first[..., None]
    h, w, c = first.shape
    count = 0
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(_HEADER.pack(_MAGIC, 1, 0, h, w, c, 0))
        for img in [first] + list(it):
            img = np.ascontiguousarray(img, dtype=np.uint8)
            if img.ndim == 2:
                img = img[..., None]
            if img.shape != (h, w, c):
                raise ValueError(
                    f'image {count} shape {img.shape} != {(h, w, c)}')
            img.tofile(f)
            count += 1
        f.seek(0)
        f.write(_HEADER.pack(_MAGIC, 1, count, h, w, c, 0))
    os.replace(tmp, path)


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + ' '.join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'libbihome_io-{digest}.so'


def load_native() -> ctypes.CDLL:
    """Build (once per source and flags) and load the native reader.
    Raises RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out = library_path()
        try:
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f'.{os.getpid()}.tmp')
                subprocess.run(['g++', *CXX_FLAGS, str(SOURCE), '-o',
                                str(tmp)], check=True, capture_output=True,
                               text=True, timeout=300)
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
        except subprocess.CalledProcessError as exc:
            raise RuntimeError(f'building the native pack reader failed:\n'
                               f'{exc.stderr}') from exc
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f'the native pack reader is unavailable: '
                               f'{exc}') from exc
        lib.bhpk_open.restype = ctypes.c_void_p
        lib.bhpk_open.argtypes = [ctypes.c_char_p]
        lib.bhpk_close.argtypes = [ctypes.c_void_p]
        lib.bhpk_count.restype = ctypes.c_int64
        lib.bhpk_count.argtypes = [ctypes.c_void_p]
        for name in ('bhpk_height', 'bhpk_width', 'bhpk_channels'):
            getattr(lib, name).restype = ctypes.c_int32
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.bhpk_gather.restype = ctypes.c_int
        lib.bhpk_gather.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.bhpk_epoch_start.restype = ctypes.c_void_p
        lib.bhpk_epoch_start.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.bhpk_epoch_next.restype = ctypes.c_int
        lib.bhpk_epoch_next.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint8)]
        lib.bhpk_epoch_finish.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _int64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _uint8_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class PackDataset:
    """A .bhpk pack as a dataset (``load_image``, like ImageFolderDataset),
    read by the native reader (``prefer_native``, the default) or a numpy
    memmap. :meth:`gather` and :meth:`epoch_batches` are the batch paths."""

    def __init__(self, path: str, prefer_native: bool = True):
        self.path = path
        with open(path, 'rb') as f:
            magic, version, count, h, w, c, _ = _HEADER.unpack(
                f.read(HEADER_BYTES))
        if magic != _MAGIC or version != 1:
            raise ValueError(f'{path} is not a bhpk v1 pack')
        self.count, self.height, self.width, self.channels = count, h, w, c
        self._handle = None
        self._lib = load_native() if prefer_native else None
        if self._lib is not None:
            self._handle = self._lib.bhpk_open(path.encode())
            if not self._handle:                      # corrupt per C++ checks
                raise ValueError(f'native reader rejected {path}')
        else:
            self._mm = np.memmap(path, dtype=np.uint8, mode='r',
                                 offset=HEADER_BYTES,
                                 shape=(count, h, w, c))

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __len__(self) -> int:
        return self.count

    def load_image(self, idx: int) -> np.ndarray:
        return self.gather(np.asarray([idx], dtype=np.int64))[0]

    def gather(self, indices: np.ndarray, threads: int = 4) -> np.ndarray:
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        n = len(indices)
        if self._handle is not None:
            out = np.empty((n, self.height, self.width, self.channels),
                           dtype=np.uint8)
            rc = self._lib.bhpk_gather(self._handle, _int64_ptr(indices), n,
                                       _uint8_ptr(out), threads)
            if rc != 0:
                raise IndexError('pack gather index out of range')
            return out
        return np.array(self._mm[indices])

    def epoch_batches(self, indices: Sequence[int], batch_size: int,
                      prefetch: int = 4, threads: int = 2,
                      use_ring: Optional[bool] = None
                      ) -> Iterator[np.ndarray]:
        """Prefetched batch iterator over ``indices`` (truncated to a
        multiple of batch_size), in BatchLoader.epoch()'s order. The native
        prefetch ring runs when a spare core can feed it (``use_ring``
        None: more than 2 CPUs); otherwise each batch is one gather."""
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        steps = len(indices) // batch_size
        if steps == 0:
            return
        if use_ring is None:
            use_ring = (os.cpu_count() or 1) > 2
        if self._handle is None or not use_ring:
            for s in range(steps):
                yield self.gather(
                    indices[s * batch_size:(s + 1) * batch_size])
            return
        epoch = self._lib.bhpk_epoch_start(
            self._handle, _int64_ptr(indices), steps * batch_size,
            batch_size, prefetch, threads)
        if not epoch:
            raise RuntimeError('bhpk_epoch_start failed')
        try:
            while True:
                out = np.empty(
                    (batch_size, self.height, self.width, self.channels),
                    dtype=np.uint8)
                if not self._lib.bhpk_epoch_next(epoch, _uint8_ptr(out)):
                    return
                yield out
        finally:
            self._lib.bhpk_epoch_finish(epoch)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.bhpk_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PackBatchLoader:
    """:class:`datasets.BatchLoader`'s interface over a pack, its batches
    from the native prefetch ring."""

    def __init__(self, dataset: PackDataset, batch_size: int,
                 samples_per_epoch: int, random_seed: Optional[int] = None,
                 prefetch: int = 4, threads: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = EpochSampler(len(dataset), samples_per_epoch,
                                    random_seed)
        self.prefetch = prefetch
        self.threads = threads

    def __len__(self) -> int:
        return self.sampler.samples_per_epoch // self.batch_size

    def epoch(self) -> Iterator[np.ndarray]:
        return self.dataset.epoch_batches(
            self.sampler.epoch_indices(), self.batch_size,
            prefetch=self.prefetch, threads=self.threads)
