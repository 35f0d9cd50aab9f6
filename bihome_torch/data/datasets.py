"""Host-side datasets of the port: file listing, decode, the seeded epoch
sampler and the prefetching batch loader (the port's own copy of
``bihome_tpu/data/datasets.py``).

The pairs are made on the device (``data/pipeline.py``); the host lists
files, decodes images (PIL; ``.npy`` files load as they are), samples
each epoch's indices with the reference's seeded choice and streams uint8
batches from one producer thread. When a dataset directory is missing,
:func:`make_dataset` falls back to :class:`SyntheticDataset`, as the JAX
package does.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from bihome_torch.data import synthetic


def _decode_image(path: str) -> np.ndarray:
    if path.endswith('.npy'):
        return np.load(path, allow_pickle=True)
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert('RGB'))


def rescale_keep_aspect(image: np.ndarray,
                        target_wh: Tuple[int, int]) -> np.ndarray:
    """Aspect-preserving resize covering target (ref: transforms.py:11-46)."""
    h, w = image.shape[:2]
    target_w, target_h = target_wh
    src_ratio = h / w
    if src_ratio < target_h / target_w:
        new_w, new_h = int(np.round(target_h / src_ratio)), target_h
    else:
        new_w, new_h = target_w, int(np.round(target_w * src_ratio))
    from PIL import Image
    return np.asarray(Image.fromarray(image).resize((new_w, new_h),
                                                    Image.BILINEAR))


def center_crop(image: np.ndarray,
                target_wh: Tuple[int, int]) -> np.ndarray:
    """Center crop (ref: transforms.py:87-122)."""
    h, w = image.shape[:2]
    new_w, new_h = target_wh
    top = (h - new_h) // 2 if h != new_h else 0
    left = (w - new_w) // 2 if w != new_w else 0
    return image[top:top + new_h, left:left + new_w]


def fit_image(img: np.ndarray, image_size: Tuple[int, int]) -> np.ndarray:
    """A decoded image as [H,W,3] uint8 at ``image_size`` (W, H): grayscale
    tiled to 3 channels, then rescaled to cover and center-cropped when its
    size differs (``bihome_tpu/data/datasets.py:79-86``)."""
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    w, h = image_size
    if img.shape[:2] != (h, w):
        img = center_crop(rescale_keep_aspect(img, (w, h)), (w, h))
    return np.ascontiguousarray(img[..., :3], dtype=np.uint8)


class ImageFolderDataset:
    """Directory of .jpg/.jpeg/.npy images (COCO/FLIR-ADAS style,
    ref: src/data/coco/dataset.py:17-103)."""

    EXTENSIONS = ('.jpg', '.jpeg', '.npy')

    def __init__(self, dataset_root: str,
                 image_size: Tuple[int, int] = (320, 240)):
        self.dataset_root = dataset_root
        self.image_size = image_size
        self.filenames: List[str] = sorted(
            f for f in os.listdir(dataset_root)
            if f.lower().endswith(self.EXTENSIONS))
        if not self.filenames:
            raise FileNotFoundError(f'no images under {dataset_root}')
        self.filepaths = [os.path.join(dataset_root, f)
                          for f in self.filenames]

    def __len__(self) -> int:
        return len(self.filepaths)

    def load_image(self, idx: int) -> np.ndarray:
        return fit_image(_decode_image(self.filepaths[idx]), self.image_size)

    def preprocess_offline(self, output_root: str) -> None:
        """Rescale+CenterCrop -> .npy dump
        (ref: src/data/coco/preprocess_offline.py:9-29)."""
        os.makedirs(output_root, exist_ok=True)
        for idx, name in enumerate(self.filenames):
            out = os.path.join(
                output_root, '.'.join(name.rsplit('.')[:-1]) + '.npy')
            np.save(out, self.load_image(idx), allow_pickle=True)


class HostPrepDataset:
    """Wraps any dataset with a host-side pre-datagen transform chain
    (``PairSpec.host_prep``: Rescale / RandomCrop / CenterCrop /
    ToGrayscale / Standardize parsed from the config TRANSFORMS list,
    ref: train.py:110-120). ``random_state`` is the RandomState the chain
    draws from (RandomCrop), exposed for checkpoints."""

    def __init__(self, dataset, host_prep, random_seed=None):
        from bihome_torch.data import transforms_host
        self.dataset = dataset
        self.random_state = np.random.RandomState(random_seed)
        self.apply = transforms_host.build_host_prep(host_prep,
                                                     self.random_state)

    def __len__(self) -> int:
        return len(self.dataset)

    def load_image(self, idx: int) -> np.ndarray:
        return self.apply(self.dataset.load_image(idx))


class SyntheticDataset:
    """Deterministic stand-in when no dataset directory exists."""

    def __init__(self, num_images: int = 256,
                 image_size: Tuple[int, int] = (320, 240), seed: int = 0):
        w, h = image_size
        self.pool = synthetic.make_image_pool(num_images, h, w, seed=seed)

    def __len__(self) -> int:
        return len(self.pool)

    def load_image(self, idx: int) -> np.ndarray:
        return self.pool[idx]


class EpochSampler:
    """Seeded per-epoch index choice with replacement
    (ref: src/data/coco/dataset.py:136-142)."""

    def __init__(self, dataset_len: int, samples_per_epoch: int,
                 random_seed: Optional[int] = None):
        self.dataset_len = dataset_len
        self.samples_per_epoch = samples_per_epoch
        self.random_state = (np.random.RandomState(random_seed)
                             if random_seed is not None else np.random)

    def epoch_indices(self) -> np.ndarray:
        return self.random_state.choice(np.arange(self.dataset_len),
                                        self.samples_per_epoch)


class BatchLoader:
    """Streams [B,H,W,C] batches of ``dataset`` in the order of the seeded
    epoch sampler, decoded by one background producer thread that runs up
    to ``prefetch`` batches ahead (``bihome_tpu/data/datasets.py:150``)."""

    def __init__(self, dataset, batch_size: int, samples_per_epoch: int,
                 random_seed: Optional[int] = None, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = EpochSampler(len(dataset), samples_per_epoch,
                                    random_seed)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return self.sampler.samples_per_epoch // self.batch_size

    def epoch(self) -> Iterator[np.ndarray]:
        indices = self.sampler.epoch_indices()
        steps = len(self)
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        failure: List[BaseException] = []

        def producer():
            try:
                for s in range(steps):
                    batch_idx = indices[s * self.batch_size:
                                        (s + 1) * self.batch_size]
                    q.put(np.stack([self.dataset.load_image(int(i))
                                    for i in batch_idx]))
            except BaseException as exc:  # re-raised in the consumer
                failure.append(exc)
            finally:
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is None:
                thread.join()
                if failure:
                    raise failure[0]
                return
            yield item


def describe(ds) -> str:
    """The dataset's class (and the one a HostPrepDataset wraps)."""
    if isinstance(ds, HostPrepDataset):
        return f'{type(ds.dataset).__name__} + HostPrepDataset'
    return type(ds).__name__


def make_dataset(split_path: str, image_size=(320, 240),
                 synthetic_fallback: bool = True, synthetic_seed: int = 0,
                 dataset_name: str = 'coco'):
    """Dataset of a config split (``bihome_tpu/data/datasets.py:191``):
    a ``.bhpk`` pack (or a directory holding ``pack.bhpk``) ->
    :class:`pack.PackDataset` on the native reader; a directory ->
    :class:`clevr_change.ClevrChangeDataset` ('clevr_change' in DATA.NAME),
    :class:`cifar10.Cifar10Dataset` ('cifar'; the test batch when 'test' is
    in the path) or :class:`ImageFolderDataset`; a missing path (or a
    directory without images) -> :class:`SyntheticDataset` seeded by
    ``synthetic_seed``, unless ``synthetic_fallback`` is off."""
    pack_path = None
    if split_path.endswith('.bhpk') and os.path.isfile(split_path):
        pack_path = split_path
    elif (os.path.isdir(split_path)
          and os.path.isfile(os.path.join(split_path, 'pack.bhpk'))):
        pack_path = os.path.join(split_path, 'pack.bhpk')
    if pack_path is not None:
        from bihome_torch.data.pack import PackDataset
        return PackDataset(pack_path)
    if os.path.isdir(split_path):
        try:
            if 'clevr_change' in dataset_name:
                from bihome_torch.data.clevr_change import ClevrChangeDataset
                return ClevrChangeDataset(split_path, image_size)
            if 'cifar' in dataset_name:
                from bihome_torch.data.cifar10 import Cifar10Dataset
                return Cifar10Dataset(split_path,
                                      train='test' not in split_path)
            # 'coco' and 'flir_adas' are image folders (.jpg/.jpeg/.npy).
            return ImageFolderDataset(split_path, image_size)
        except FileNotFoundError:
            if not synthetic_fallback:
                raise
    elif not synthetic_fallback:
        raise FileNotFoundError(split_path)
    return SyntheticDataset(image_size=image_size, seed=synthetic_seed)
