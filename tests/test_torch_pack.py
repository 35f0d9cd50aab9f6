"""The port's ``.bhpk`` packs against the JAX package's: a pack written by
either is read by the other, through the native reader (the port's own
build of ``native/pack_reader.cc``) and through the numpy memmap; and a
native reader that was asked for and cannot be built raises. Tolerance:
exact bytes."""

import numpy as np
import pytest

from bihome_torch.data import pack as tpack
from tests.test_torch_host_data import images


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_packs_cross_read_native_and_memmap(writer, tmp_path):
    from bihome_tpu.data import pack as jpack
    imgs = images(6, 10, 14, 8)
    path = str(tmp_path / 'x.bhpk')
    (tpack if writer == 'port' else jpack).write_pack(path, iter(imgs))
    idx = np.array([5, 0, 3, 3], dtype=np.int64)
    readers = [tpack.PackDataset(path), tpack.PackDataset(path, False),
               jpack.PackDataset(path, prefer_native=False)]
    assert [r.native for r in readers[:2]] == [True, False]
    for r in readers:
        assert (len(r), r.height, r.width, r.channels) == (6, 10, 14, 3)
        np.testing.assert_array_equal(r.gather(idx), imgs[idx])
        np.testing.assert_array_equal(r.load_image(2), imgs[2])
    for use_ring in (True, False):
        batches = list(readers[0].epoch_batches(idx, 2, use_ring=use_ring))
        np.testing.assert_array_equal(np.concatenate(batches), imgs[idx])
    with open(path, 'rb') as f:
        data = f.read()
    other = str(tmp_path / 'y.bhpk')
    (jpack if writer == 'port' else tpack).write_pack(other, iter(imgs))
    with open(other, 'rb') as f:
        assert f.read() == data


def test_grayscale_pack_and_bad_files(tmp_path):
    gray = images(3, 5, 7, 9)[..., 0]
    path = str(tmp_path / 'g.bhpk')
    tpack.write_pack(path, gray)
    ds = tpack.PackDataset(path)
    assert ds.channels == 1
    np.testing.assert_array_equal(ds.load_image(1)[..., 0], gray[1])
    with pytest.raises(ValueError, match='empty'):
        tpack.write_pack(str(tmp_path / 'e.bhpk'), [])
    with pytest.raises(ValueError, match='shape'):
        tpack.write_pack(str(tmp_path / 'm.bhpk'),
                         [gray[0], np.zeros((4, 4), np.uint8)])
    bad = tmp_path / 'bad.bhpk'
    bad.write_bytes(b'NOPE' + bytes(28))
    with pytest.raises(ValueError, match='not a bhpk'):
        tpack.PackDataset(str(bad))
    with pytest.raises(IndexError):
        ds.gather(np.array([3]))


def test_native_reader_raises_when_it_cannot_be_built(tmp_path, monkeypatch):
    """JAX falls back to the memmap silently (``bihome_tpu/data/pack.py:
    84-86``); the port raises when the native reader it was asked for
    cannot be built, so a run never measures the slower route unknowingly."""
    path = str(tmp_path / 'p.bhpk')
    tpack.write_pack(path, images(2, 4, 4, 0))
    broken = tmp_path / 'broken.cc'
    broken.write_text('this is not C++\n')
    monkeypatch.setattr(tpack, '_lib', None)
    monkeypatch.setattr(tpack, 'SOURCE', broken)
    monkeypatch.setattr(tpack, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='building the native pack'):
        tpack.PackDataset(path)
    assert not tpack.PackDataset(path, prefer_native=False).native
