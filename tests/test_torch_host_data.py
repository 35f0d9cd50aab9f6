"""The port's host data path against the JAX package's, on files each test
writes: the blob keys of build_model, the host transforms, the datasets
``make_dataset`` picks, and the batch loaders' epochs.

Tolerance: exact. The same seeds and files must give the same dataset
class, the same bytes and the same epochs on both sides (both decode
with PIL and crop with the same RandomState calls).
"""

import os
import pickle

import numpy as np
import pytest

from bihome_torch import config as tconfig
from bihome_torch.data import clevr_change as tclevr
from bihome_torch.data import datasets as tds
from bihome_torch.data import pack as tpack
from bihome_torch.data import transforms_host as tth

DETONE = 'config/s-coco/detone-orig-lr-5e-3.yaml'


# ------------------------------------------------ fixtures and writers
# Shared with the other test_torch_* files of the host data path.

THREADS = 2


@pytest.fixture
def cpu_test_env(request):
    """torch on THREADS threads for the test (and OMP_NUM_THREADS for the
    processes it starts): the tests run beside other workers, and
    oversubscribed CPU kernels slow every worker down many times over.
    The test's tmp_path (checkpoints of 10-21 M parameters with their Adam
    moments, a few hundred MB each) is removed when it ends."""
    import shutil

    import torch
    tmp = (request.getfixturevalue('tmp_path')
           if 'tmp_path' in request.fixturenames else None)
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    mp = pytest.MonkeyPatch()
    mp.setenv('OMP_NUM_THREADS', str(THREADS))
    yield
    mp.undo()
    torch.set_num_threads(before)
    if tmp is not None:
        shutil.rmtree(tmp, ignore_errors=True)


def images(n, h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3),
                                               dtype=np.uint8)


def write_jpegs(root, imgs, quality=90, ext='jpg'):
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(os.path.join(root, f'{i:04d}.{ext}'),
                                  quality=quality)
    return str(root)


def write_npys(root, imgs):
    os.makedirs(root, exist_ok=True)
    for i, img in enumerate(imgs):
        np.save(os.path.join(root, f'{i:04d}.npy'), img)
    return str(root)


def write_cifar(root, per_batch=8, seed=0):
    """A ``cifar-10-batches-py`` directory under ``root`` holding all five
    train batches and the test batch."""
    sub = os.path.join(root, 'cifar-10-batches-py')
    os.makedirs(sub, exist_ok=True)
    rs = np.random.RandomState(seed)
    for name in [f'data_batch_{i}' for i in range(1, 6)] + ['test_batch']:
        data = {'data': rs.randint(0, 256, (per_batch, 3072),
                                   dtype=np.uint8),
                'labels': list(range(per_batch))}
        with open(os.path.join(sub, name), 'wb') as f:
            pickle.dump(data, f)
    return str(root)


def write_clevr(root, n, h, w, seed=0):
    """A CLEVR-Change layout: images/, nsc_images/ and sc_images/ PNGs."""
    from PIL import Image
    base = images(n, h, w, seed)
    for k, sub in enumerate(('images', 'nsc_images', 'sc_images')):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i, img in enumerate(base):
            shifted = np.clip(img.astype(np.int16) + 9 * k, 0, 255)
            Image.fromarray(shifted.astype(np.uint8)).save(
                os.path.join(root, sub, f'CLEVR_{i:04d}.png'))
    return str(root)


# ----------------------------------------------------------------- blobs

def test_blob_keys_build_into_both_specs_and_the_port_refuses_them():
    """JAX reads DATA.AUGMENT_BLOB_POROSITY / AUGMENT_BLOBINESS into both
    pair specs (``bihome_tpu/config.py:98-115``); the port reads them the
    same way. It refused a porosity above 0 until it had the blob
    occlusion (``bihome_torch/data/blobs.py``, held to JAX's in
    tests/test_torch_datagen_leftovers.py); now it builds it into both
    specs as JAX does."""
    from bihome_tpu import config as jconfig

    def load(module, sets):
        config = module.load_config(DETONE)
        return module.apply_overrides(config, sets)

    sets = ['DATA.AUGMENT_BLOB_POROSITY=0.5', 'DATA.AUGMENT_BLOBINESS=2']
    built = jconfig.build_model(load(jconfig, sets))
    assert built.pair_spec.blob_porosity == 0.5
    assert built.test_pair_spec.blob_porosity == 0.5
    assert built.pair_spec.blobiness == 2.0
    built = tconfig.build_model(load(tconfig, sets))
    assert built.pair_spec.blob_porosity == 0.5
    assert built.test_pair_spec.blob_porosity == 0.5
    assert built.pair_spec.blobiness == 2.0
    for module in (jconfig, tconfig):
        built = module.build_model(load(module, []))
        assert built.pair_spec.blob_porosity == 0.0
        assert built.test_pair_spec.blob_porosity == 0.0


# ------------------------------------------------------------ transforms

def _both(name, *args, seed=3):
    from bihome_tpu.data import transforms_host as jth
    return [getattr(m, name)(*args, random_state=np.random.RandomState(seed))
            for m in (jth, tth)]


@pytest.mark.parametrize('name,args', [
    ('Rescale', (100,)), ('Rescale', ((96, 64),)), ('Rescale', ((40, 90),)),
    ('CenterCrop', ((30, 20),)), ('CenterCrop', (17,)),
    ('RandomCrop', ((21, 33),)), ('RandomCrop', (16,)),
    ('Standardize', ([0.443], [0.129]))])
def test_host_transform_matches_jax(name, args):
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 256, (48, 71, 3), dtype=np.uint8),
            rs.randint(0, 256, (61, 50, 3), dtype=np.uint8)]
    jt, tt = _both(name, *args)
    for _ in range(3):   # the RandomState advances alike
        (j1, j2), _ = jt((list(imgs), None))
        (t1, t2), _ = tt((list(imgs), None))
        for a, b in ((j1, t1), (j2, t2)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_grayscale_photometric_and_to_tensor_match_jax():
    from bihome_tpu.data import transforms_host as jth
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (9, 11, 3)).astype(np.float32)
    (jg,), _ = jth.ToGrayscale()(([img], None))
    (tg,), _ = tth.ToGrayscale()(([img], None))
    np.testing.assert_array_equal(jg, tg)
    jp, tp = _both('PhotometricDistort', ['image_1', 'image_2'], seed=7)
    for _ in range(4):
        data = {'image_1': img, 'image_2': img[::-1].copy()}
        a, b = jp(dict(data)), tp(dict(data))
        for key in data:
            np.testing.assert_array_equal(a[key], b[key])
    ji, jt = jth.ToTensorWithTarget()(([img, img], [1, 2]))
    ti, tt = tth.ToTensorWithTarget()(([img, img], [1, 2]))
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jt, tt)


@pytest.mark.parametrize('entries', [
    (('Rescale', ((128, 96),)), ('RandomCrop', ((64, 48),))),
    (('CenterCrop', ((40, 30),)), ('ToGrayscale', ()),
     ('Standardize', (0.5, 0.25)))])
def test_build_host_prep_and_host_prep_dataset_match_jax(entries):
    from bihome_tpu.data import datasets as jds
    from bihome_tpu.data import transforms_host as jth
    base = tds.SyntheticDataset(num_images=4, image_size=(90, 70), seed=2)
    jf = jth.build_host_prep(entries, np.random.RandomState(5))
    tf = tth.build_host_prep(entries, np.random.RandomState(5))
    jd = jds.HostPrepDataset(jds.SyntheticDataset(4, (90, 70), seed=2),
                             entries, random_seed=11)
    td = tds.HostPrepDataset(base, entries, random_seed=11)
    for i in (0, 3, 3, 1):
        img = base.load_image(i)
        np.testing.assert_array_equal(jf(img), tf(img))
        np.testing.assert_array_equal(jd.load_image(i), td.load_image(i))


# -------------------------------------------------------------- datasets

def _jax_make(path, **kw):
    from bihome_tpu.data import datasets as jds
    return jds.make_dataset(path, **kw)


def _same_dataset(jd, td, indices):
    assert type(jd).__name__ == type(td).__name__
    assert len(jd) == len(td)
    for i in indices:
        a, b = jd.load_image(i), td.load_image(i)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('kind', ['jpeg', 'npy', 'gray', 'odd'])
def test_image_folder_matches_jax(kind, tmp_path):
    """A JPEG folder at 2x the size (rescaled and center-cropped), .npy
    files at the size, grayscale JPEGs, and odd sizes of either aspect."""
    root = tmp_path / 'images'
    if kind == 'jpeg':
        write_jpegs(root, images(3, 96, 128, 0))
    elif kind == 'npy':
        write_npys(root, images(3, 48, 64, 1))
    elif kind == 'gray':
        from PIL import Image
        os.makedirs(root)
        for i, img in enumerate(images(2, 50, 70, 2)[..., 0]):
            Image.fromarray(img, mode='L').save(root / f'{i}.jpeg')
    else:
        write_jpegs(root, images(2, 77, 53, 3))
        np.save(root / 'z.npy', images(1, 31, 97, 4)[0])
    kw = dict(image_size=(64, 48))
    _same_dataset(_jax_make(str(root), **kw),
                  tds.make_dataset(str(root), **kw),
                  range(len(os.listdir(root))))


def test_packs_clevr_cifar_and_missing_paths_match_jax(tmp_path):
    imgs = images(5, 12, 16, 5)
    file_pack = str(tmp_path / 'a.bhpk')
    tpack.write_pack(file_pack, imgs)
    os.makedirs(tmp_path / 'packdir')
    tpack.write_pack(str(tmp_path / 'packdir' / 'pack.bhpk'), imgs)
    clevr = write_clevr(str(tmp_path / 'clevr'), 3, 30, 40)
    cifar = write_cifar(str(tmp_path / 'cifar'))
    cases = [(file_pack, {}), (str(tmp_path / 'packdir'), {}),
             (clevr, {'dataset_name': 'clevr_change',
                      'image_size': (20, 16)}),
             (cifar, {'dataset_name': 'cifar10'}),
             (str(tmp_path / 'missing'), {'image_size': (40, 30),
                                          'synthetic_seed': 3}),
             (str(tmp_path / 'packdir'), {'dataset_name': 'clevr_change'})]
    for path, kw in cases:
        jd, td = _jax_make(path, **kw), tds.make_dataset(path, **kw)
        n = len(td) * (3 if 'clevr_change' in kw.get('dataset_name', '')
                       and not path.endswith('packdir') else 1)
        _same_dataset(jd, td, [0, n - 1, n // 2])
    assert tds.make_dataset(file_pack).native
    with pytest.raises(FileNotFoundError):
        tds.make_dataset(str(tmp_path / 'missing'), synthetic_fallback=False)
    os.makedirs(tmp_path / 'empty')
    with pytest.raises(FileNotFoundError):
        tds.make_dataset(str(tmp_path / 'empty'), synthetic_fallback=False)
    assert isinstance(tds.make_dataset(str(tmp_path / 'empty')),
                      tds.SyntheticDataset)


# --------------------------------------------------------------- loaders

def test_batch_loaders_give_jax_epochs(tmp_path):
    from bihome_tpu.data import clevr_change as jclevr
    from bihome_tpu.data import datasets as jds
    from bihome_tpu.data import pack as jpack
    root = write_npys(tmp_path / 'npy', images(7, 10, 12, 6))
    jl = jds.BatchLoader(jds.make_dataset(root, image_size=(12, 10)), 2, 6,
                         random_seed=42)
    tl = tds.BatchLoader(tds.make_dataset(root, image_size=(12, 10)), 2, 6,
                         random_seed=42)
    path = str(tmp_path / 'p.bhpk')
    tpack.write_pack(path, images(9, 8, 6, 7))
    jp = jpack.PackBatchLoader(jpack.PackDataset(path), 3, 7, random_seed=1)
    tp = tpack.PackBatchLoader(tpack.PackDataset(path), 3, 7, random_seed=1)
    clevr = write_clevr(str(tmp_path / 'clevr'), 4, 12, 16)
    jc = jclevr.ClevrPairLoader(jclevr.ClevrChangeDataset(clevr, (16, 12)),
                                2, 4, mode='both', random_seed=3)
    tc = tclevr.ClevrPairLoader(tclevr.ClevrChangeDataset(clevr, (16, 12)),
                                2, 4, mode='both', random_seed=3)
    for j, t in ((jl, tl), (jp, tp), (jc, tc)):
        assert len(j) == len(t)
        for _ in range(2):
            jb, tb = list(j.epoch()), list(t.epoch())
            assert len(jb) == len(tb) == len(t)
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(a, b)


def test_batch_loader_raises_what_its_producer_raised(tmp_path):
    class Broken:
        def __len__(self):
            return 4

        def load_image(self, idx):
            raise OSError(f'cannot decode {idx}')

    with pytest.raises(OSError, match='cannot decode'):
        list(tds.BatchLoader(Broken(), 2, 4, random_seed=0).epoch())
