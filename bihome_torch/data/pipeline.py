"""On-device synthetic homography-pair generation (counterpart of
``bihome_tpu/data/pipeline.py``).

Ported: ``PairSpec.from_transforms``, the deterministic pair assembly with
the '4_points' and 'all_points' targets, ``_assemble_pairs`` (one
window-first path for both of the JAX branches: when a head consumes
``image_1`` the whole frame is distorted and emitted beside the pair),
the PDS photometric distortion
(:mod:`bihome_torch.data.photometric`) of either copy, per-sample
synthesis (the eval protocol: each sample's draws come from its own
``torch.Generator`` seeded by (seed, sample ordinal), so synthesis does
not depend on how samples are grouped into batches) and ``generate_pairs``
(the training draws, one generator per batch; corners, deltas and
photometric draws can be injected), and ``ChangeAwarePrep`` (CLEVR-Change:
real (original, changed) pairs, no synthetic homography). Also the
dict-stage ``PhotometricDistort`` (the full SSD chain on each key it
names, after the pair and before grayscale and standardize,
``bihome_tpu/data/pipeline.py:306-315``), emitting ``image_2`` (the
whole distorted frame warped by the pair's homography, ``:302-304``;
eval's ``--vis`` reads it) and the blob occlusion of the training pairs
(:mod:`bihome_torch.data.blobs`, ``:397-402``), each with injectable
draws. The host-side prep transforms run on the host
(:mod:`bihome_torch.data.transforms_host`), before the pairs are made.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from bihome_torch import geometry, tracing
from bihome_torch.data import blobs, photometric
from bihome_torch.ops import color
from bihome_torch.parallel import mesh

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PairSpec:
    """Static datagen configuration; the same fields as
    ``bihome_tpu.data.pipeline.PairSpec`` (ref: src/data/transforms.py:
    441-454 plus the grayscale/standardize transforms)."""
    rho: int = 32
    patch_size: int = 128
    photometric_keys: Tuple[str, ...] = ('image_1', 'image_2')
    max_delta: float = 32.0
    target_gen: str = '4_points'            # '4_points' | 'all_points'
    grayscale_keys: Tuple[str, ...] = ('patch_1', 'patch_2')
    standardize_mean: float = 0.443
    standardize_std: float = 0.129
    standardize_keys: Tuple[str, ...] = ('patch_1', 'patch_2')
    emit_images: Tuple[str, ...] = ()
    change_aware_keys: Tuple[str, ...] = ()
    blob_porosity: float = 0.0
    blobiness: float = 1.0
    # Dtype of patch_2's warp source ('float32' | 'bfloat16'): the train
    # spec of a bf16 model rounds the (grayscale) source to bf16 before the
    # warp (``bihome_tpu/data/pipeline.py:70-75,277-281``).
    warp_dtype: str = 'float32'
    host_prep: Tuple[Tuple[str, Tuple[Any, ...]], ...] = ()
    photometric_full_keys: Tuple[str, ...] = ()

    @staticmethod
    def from_transforms(transforms: Sequence[Dict[str, List[Any]]],
                        emit_images: Sequence[str] = ()) -> 'PairSpec':
        """Build from a reference-format TRANSFORMS yaml list, each entry
        {ClassName: [args...]} (ref: train.py:110-120)."""
        kwargs: Dict[str, Any] = {}
        host_prep: List[Tuple[str, Tuple[Any, ...]]] = []
        for entry in transforms:
            (name, args), = entry.items()
            if name == 'HomographyNetPrep':
                kwargs['rho'] = int(args[0])
                kwargs['patch_size'] = int(args[1])
                kwargs['photometric_keys'] = tuple(args[2] or ())
                if len(args) > 3:
                    kwargs['max_delta'] = float(args[3])
                if len(args) > 4:
                    kwargs['target_gen'] = str(args[4])
            elif name == 'DictToGrayscale':
                kwargs['grayscale_keys'] = tuple(args[0])
            elif name == 'DictStandardize':
                mean, std = args[0], args[1]
                kwargs['standardize_mean'] = float(
                    mean[0] if isinstance(mean, (list, tuple)) else mean)
                kwargs['standardize_std'] = float(
                    std[0] if isinstance(std, (list, tuple)) else std)
                kwargs['standardize_keys'] = tuple(args[2])
            elif name == 'ChangeAwarePrep':
                keys = tuple(args[0]) if args and args[0] else (
                    'patch_1', 'patch_2')
                kwargs['change_aware_keys'] = keys
            elif name in ('DictToTensor', 'ToTensorWithTarget'):
                pass  # NHWC layout throughout; nothing to do.
            elif name == 'PhotometricDistort':
                kwargs['photometric_full_keys'] = tuple(args[0])
            elif name in ('Rescale', 'RandomCrop', 'CenterCrop'):
                size = args[0]
                size = tuple(size) if isinstance(size, (list, tuple)) else size
                host_prep.append((name, (size,)))
            elif name == 'ToGrayscale':
                host_prep.append((name, ()))
            elif name == 'Standardize':
                host_prep.append((name, (args[0], args[1])))
            else:
                raise ValueError(f'Unknown transform in config: {name}')
        return PairSpec(emit_images=tuple(emit_images),
                        host_prep=tuple(host_prep), **kwargs)


def check_ported(spec: PairSpec) -> None:
    """Raise for the datagen features this port does not have yet."""
    missing = []
    unported_images = sorted(set(spec.emit_images) - {'image_1', 'image_2'})
    if unported_images:
        missing.append(f'emitting {unported_images}')
    if spec.target_gen not in ('4_points', 'all_points'):
        missing.append(f'target_gen {spec.target_gen!r}')
    if spec.warp_dtype not in ('float32', 'bfloat16'):
        missing.append(f'warp_dtype {spec.warp_dtype!r}')
    if missing:
        raise ValueError('not ported yet: ' + ', '.join(missing))


def _corners_from_position(pos_x: Tensor, pos_y: Tensor,
                           patch_size: int) -> Tensor:
    """[(x0,y0),(x1,y0),(x1,y1),(x0,y1)] per sample
    (ref: src/data/transforms.py:517-520)."""
    half = patch_size // 2
    x0, x1 = pos_x - half, pos_x + half
    y0, y1 = pos_y - half, pos_y + half
    return torch.stack([torch.stack([x0, y0], -1), torch.stack([x1, y0], -1),
                        torch.stack([x1, y1], -1), torch.stack([x0, y1], -1)],
                       dim=1)


def patch_windows(images: Tensor, homography: Tensor, corners0: Tensor,
                  patch_size: int, rho: int
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """(windows [B,ws,ws,C], u, v [B,ps²]): the (ps+2·rho)² window around
    each patch and the points of its warped second patch inside it,
    patch(i, j) = image(H · (x0+j, y0+i))."""
    ps = patch_size
    _, h, w, _ = images.shape
    ws_x = min(ps + 2 * rho, w)
    ws_y = min(ps + 2 * rho, h)
    ox = (corners0[:, 0].long() - rho).clamp(0, w - ws_x)
    oy = (corners0[:, 1].long() - rho).clamp(0, h - ws_y)
    windows = geometry.crop_integer(images, ox, oy, (ws_y, ws_x)).contiguous()
    u, v = geometry.homography_grid(homography, (ps, ps),
                                    offset=corners0.float())
    return windows, u - ox.float()[:, None], v - oy.float()[:, None]


def _warp_patches(images: Tensor, homography: Tensor, corners0: Tensor,
                  patch_size: int, rho: int) -> Tensor:
    """Sample the warped second patches directly from the window around
    each patch (:func:`patch_windows`)."""
    b, _, _, c = images.shape
    out = geometry.batched_sample(*patch_windows(
        images, homography, corners0, patch_size, rho))
    return out.reshape(b, patch_size, patch_size, c)


def _perspective_field(homography: Tensor, corners0: Tensor,
                       patch_size: int) -> Tensor:
    """The dense 'all_points' target over the patch: pf(p) = H·p - p at the
    absolute coordinates p of its pixels (``bihome_tpu/data/pipeline.py:
    216-229``; ref: src/data/transforms.py:635-685). -> [B,ps,ps,2]."""
    ps = patch_size
    ys, xs = torch.meshgrid(torch.arange(ps, dtype=torch.float32,
                                         device=homography.device),
                            torch.arange(ps, dtype=torch.float32,
                                         device=homography.device),
                            indexing='ij')
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)   # [P,2]
    pts = grid[None] + corners0[:, None, :]
    diff = geometry.transform_points(homography, pts) - pts
    return diff.reshape(-1, ps, ps, 2)


def generate_pairs_deterministic(
        image: Tensor, corners: Tensor, delta: Tensor, spec: PairSpec,
        image_1: Optional[Tensor] = None,
        image_2: Optional[Tensor] = None,
        full_params: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Pair assembly given sampled (corners, delta): image/image_1/image_2
    [B,H,W,3] float (image_1/image_2 the distorted copies, default image),
    corners [B,4,2] (integer-valued), delta [B,4,2]. ``image_1`` and
    ``image_2`` (warped by the homography) are emitted when the spec asks
    for them. ``full_params`` [K,B,12], one row of draws per key of
    ``spec.photometric_full_keys``, applies the full SSD chain to each key
    the batch holds (None skips it, as JAX's ``pdf_keys=None``)."""
    check_ported(spec)
    image_1 = image if image_1 is None else image_1
    image_2 = image if image_2 is None else image_2
    ps = spec.patch_size
    x0 = corners[:, 0, 0].long()
    y0 = corners[:, 0, 1].long()
    full_keys = spec.photometric_full_keys if full_params is not None else ()

    # Grayscale commutes with cropping and bilinear warping (both linear in
    # pixel values): convert first and sample one channel instead of three
    # (not for a patch the non-linear full chain distorts first).
    patch_1_gray = ('patch_1' in spec.grayscale_keys
                    and 'patch_1' not in full_keys
                    and image_1.shape[-1] == 3)
    patch_2_gray = ('patch_2' in spec.grayscale_keys
                    and 'patch_2' not in full_keys
                    and image_2.shape[-1] == 3)
    patch_1_src = color.rgb_to_grayscale(image_1) if patch_1_gray else image_1
    patch_2_src = color.rgb_to_grayscale(image_2) if patch_2_gray else image_2

    patch_1 = geometry.crop_integer(patch_1_src, x0, y0, (ps, ps))
    homography = geometry.four_point_to_homography(corners, delta)
    if spec.warp_dtype == 'bfloat16':
        # The source in bf16; the warp samples it in float32 (as the Pallas
        # kernel does) and the patch stays float32.
        patch_2_src = patch_2_src.to(torch.bfloat16)
    patch_2 = _warp_patches(patch_2_src, homography, corners[:, 0].float(),
                            ps, spec.rho)

    batch: Dict[str, Tensor] = {
        'patch_1': patch_1,
        'patch_2': patch_2,
        'corners': corners.float(),
        'delta': delta.float(),
        'homography': homography,
    }
    if spec.target_gen == '4_points':
        batch['target'] = batch['delta']
    else:
        batch['target'] = _perspective_field(homography,
                                             batch['corners'][:, 0], ps)
    if 'image_1' in spec.emit_images:
        batch['image_1'] = image_1
    if 'image_2' in spec.emit_images:
        batch['image_2'] = geometry.warp_image(image_2, homography)
    return _gray_standardize(_distort_full(batch, spec, full_params), spec)


def _distort_full(batch: Dict[str, Tensor], spec: PairSpec,
                  full_params: Optional[Tensor]) -> Dict[str, Tensor]:
    """The full SSD chain (dict-stage PhotometricDistort) on each of the
    spec's keys that ``batch`` holds, key i with the draws
    ``full_params[i]`` [B,12] (``pipeline.py:306-315``), in place."""
    if full_params is None:
        return batch
    for i, name in enumerate(spec.photometric_full_keys):
        if name in batch:
            batch[name] = photometric.photometric_distort_full(
                batch[name], full_params[i])
    return batch


def _gray_standardize(batch: Dict[str, Tensor],
                      spec: PairSpec) -> Dict[str, Tensor]:
    """Grayscale, then standardize, the spec's keys of ``batch`` (in
    place), in the order of the config's transform list."""
    for key in spec.grayscale_keys:
        if key in batch and batch[key].shape[-1] != 1:
            batch[key] = color.rgb_to_grayscale(batch[key])
    for key in spec.standardize_keys:
        if key in batch:
            batch[key] = ((batch[key] / 255.0 - spec.standardize_mean)
                          / spec.standardize_std)
    return batch


def take_images(pool: Tensor, idx: Tensor) -> Tensor:
    """``pool[idx]`` as one row gather (``index_select``): [N,...] pool,
    [B] indices on the pool's device -> [B,...], bytes unchanged. JAX's
    TPU form is a one-hot product (``bihome_tpu/data/pipeline.py:
    329-345``), a workaround for the TPU's scalarized gather; off the TPU
    it is ``jnp.take``, this."""
    return pool.index_select(0, idx)


def sample_seed(seed: int, ordinal: int) -> int:
    """Seed of sample ``ordinal``'s generator under run seed ``seed``."""
    return (int(seed) << 32) + int(ordinal)


def _photometric_copies(spec: PairSpec) -> Tuple[bool, bool]:
    """Whether image_1 / image_2 are distorted (``bihome_tpu/data/
    pipeline.py:455-456``)."""
    on = spec.max_delta > 0
    return (on and 'image_1' in spec.photometric_keys,
            on and 'image_2' in spec.photometric_keys)


def _draw_photometric(batch: int, spec: PairSpec,
                      generator: Optional[torch.Generator]
                      ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """The distortion draws of image_1 then image_2 ([batch, 12] each, CPU),
    None for a copy that is not distorted."""
    return tuple(photometric.draw_photometric_params(batch, spec.max_delta,
                                                     generator) if on
                 else None for on in _photometric_copies(spec))


def draw_full_photometric(batch: int, spec: PairSpec,
                          generator: Optional[torch.Generator]
                          ) -> Optional[Tensor]:
    """The full SSD chain's draws [K,batch,12] (CPU), one row per key of
    ``spec.photometric_full_keys`` in order; None without the transform."""
    if not spec.photometric_full_keys:
        return None
    return torch.stack([photometric.draw_photometric_full_params(
        batch, generator) for _ in spec.photometric_full_keys])


def draw_per_sample(seeds: Sequence[int], image_hw: Tuple[int, int],
                    spec: PairSpec):
    """Per-sample draws, each sample from its own ``torch.Generator``, in
    the order patch centre, corner perturbations, the photometric draws of
    image_1 then image_2, the full chain's (CPU) -> (corners [B,4,2],
    delta [B,4,2], pd1, pd2, pdf), pd1/pd2 [B,12] or None, pdf [K,B,12]
    or None.

    Patch centres are uniform in [rho + ps/2, dim - rho - ps/2] (ref:
    src/data/transforms.py:504-509), deltas uniform in [-rho, rho)
    (np.random.randint semantics, ref: transforms.py:538)."""
    h, w = image_hw
    ps, rho = spec.patch_size, spec.rho
    pos, deltas, pds, pdfs = [], [], [], []
    for seed in seeds:
        gen = torch.Generator().manual_seed(seed)
        if ps != w:
            px = torch.randint(rho + ps // 2, w - rho - ps // 2 + 1, (),
                               generator=gen)
            py = torch.randint(rho + ps // 2, h - rho - ps // 2 + 1, (),
                               generator=gen)
        else:
            px, py = torch.tensor(w // 2), torch.tensor(h // 2)
        pos.append(torch.stack([px, py]))
        deltas.append(torch.randint(-rho, rho, (4, 2), generator=gen))
        pds.append(_draw_photometric(1, spec, gen))
        pdfs.append(draw_full_photometric(1, spec, gen))
    pos_t = torch.stack(pos)
    corners = _corners_from_position(pos_t[:, 0], pos_t[:, 1], ps)
    pd1, pd2 = (None if p[0] is None else torch.cat(p) for p in zip(*pds))
    pdf = None if pdfs[0] is None else torch.cat(pdfs, dim=1)
    return corners, torch.stack(deltas), pd1, pd2, pdf


def _params_to(device, pd1: Optional[Tensor], pd2: Optional[Tensor]):
    """Both copies' photometric draws on ``device``, in one copy."""
    drawn = [p for p in (pd1, pd2) if p is not None]
    if not drawn:
        return pd1, pd2
    moved = iter(tracing.to_device(torch.stack(drawn), device).unbind(0))
    return tuple(None if p is None else next(moved) for p in (pd1, pd2))


def generate_pairs_per_sample(images: Tensor, seeds: Sequence[int],
                              spec: PairSpec) -> Dict[str, Tensor]:
    """uint8/float images [B,H,W,3] + one seed per sample -> batch dict.
    Every sample's randomness derives only from its own seed (the eval
    protocol's batch-size invariance, ref: eval.py:360)."""
    images = images.float()
    corners, delta, pd1, pd2, pdf = draw_per_sample(seeds, images.shape[1:3],
                                                    spec)
    return _assemble_pairs(images, tracing.to_device(corners, images.device),
                           tracing.to_device(delta, images.device), spec,
                           *_params_to(images.device, pd1, pd2),
                           full_params=_to(pdf, images.device))


def _to(t: Optional[Tensor], device) -> Optional[Tensor]:
    return None if t is None else tracing.to_device(t, device)


def _assemble_pairs(images: Tensor, corners: Tensor, delta: Tensor,
                    spec: PairSpec, pd1: Optional[Tensor] = None,
                    pd2: Optional[Tensor] = None,
                    full_params: Optional[Tensor] = None
                    ) -> Dict[str, Tensor]:
    """Photometric distortion of the two copies with the draws ``pd1`` and
    ``pd2`` ([B,12] on the images' device), then the pair
    (``bihome_tpu/data/pipeline.py:443-488``), window-first: patch_1 and
    patch_2 read only the (ps+2·rho)² window around the patch, so only the
    window is cropped, distorted and converted. The distortion is per
    pixel under per-sample draws, so this equals JAX's full-image branch
    too, which a spec that emits ``image_1`` or ``image_2`` takes: here
    the whole frame is distorted with pd1 and emitted beside the pair
    (image_1), or distorted with pd2 and warped by the pair's absolute
    homography (image_2). ``full_params`` [K,B,12]: the full SSD chain's
    draws (:func:`generate_pairs_deterministic`). Returns absolute-frame
    corners and homography."""
    check_ported(spec)
    on_1, on_2 = _photometric_copies(spec)
    if (on_1 and pd1 is None) or (on_2 and pd2 is None):
        raise ValueError('photometric distortion needs its draws')
    _, h, w, _ = images.shape
    ps, rho = spec.patch_size, spec.rho
    ws_x = min(ps + 2 * rho, w)
    ws_y = min(ps + 2 * rho, h)
    ox = (corners[:, 0, 0] - rho).clamp(0, w - ws_x)
    oy = (corners[:, 0, 1] - rho).clamp(0, h - ws_y)
    windows = geometry.crop_integer(images, ox, oy, (ws_y, ws_x))
    with tracing.span('datagen.photometric'):
        win_1 = (photometric.apply_photometric(windows, pd1) if on_1
                 else windows)
        win_2 = (photometric.apply_photometric(windows, pd2) if on_2
                 else windows)
    origin = torch.stack([ox, oy], dim=-1)[:, None, :]             # [B,1,2]
    with tracing.span('datagen.warp'):
        batch = generate_pairs_deterministic(
            windows, (corners - origin).float(), delta.float(),
            dataclasses.replace(spec, emit_images=()), win_1, win_2,
            full_params)
    batch['corners'] = corners.float()
    batch['homography'] = geometry.four_point_to_homography(
        batch['corners'], batch['delta'])
    frames = {}
    if 'image_1' in spec.emit_images:
        frames['image_1'] = (photometric.apply_photometric(images, pd1)
                             if on_1 else images)
    if 'image_2' in spec.emit_images:
        frames['image_2'] = geometry.warp_image(
            photometric.apply_photometric(images, pd2) if on_2 else images,
            batch['homography'])
    if frames:
        batch.update(_gray_standardize(
            _distort_full(frames, spec, full_params), spec))
    return batch


def draw_corners_delta_batch(batch: int, image_hw: Tuple[int, int],
                             spec: PairSpec,
                             generator: Optional[torch.Generator] = None
                             ) -> Tuple[Tensor, Tensor]:
    """Training draws for a whole batch from one generator (CPU, int64):
    patch centres uniform in [rho + ps/2, dim - rho - ps/2] and deltas
    uniform in [-rho, rho) (ref: bihome_tpu/data/pipeline.py:145-160,
    383-386)."""
    h, w = image_hw
    ps, rho = spec.patch_size, spec.rho
    if ps != w:
        pos_x = torch.randint(rho + ps // 2, w - rho - ps // 2 + 1, (batch,),
                              generator=generator)
        pos_y = torch.randint(rho + ps // 2, h - rho - ps // 2 + 1, (batch,),
                              generator=generator)
    else:
        pos_x = torch.full((batch,), w // 2, dtype=torch.long)
        pos_y = torch.full((batch,), h // 2, dtype=torch.long)
    delta = torch.randint(-rho, rho, (batch, 4, 2), generator=generator)
    return _corners_from_position(pos_x, pos_y, ps), delta


def assemble_change_pairs(pairs: Tensor, spec: PairSpec) -> Dict[str, Tensor]:
    """ChangeAwarePrep (``bihome_tpu/data/pipeline.py:353-367``; ref:
    src/data/transforms.py:399-418): real (original, changed) render pairs
    [B,2,H,W,3] -> the batch dict keyed by ``spec.change_aware_keys``, with
    grayscale and standardize applied. There is no homography and no
    ``delta``."""
    k1, k2 = spec.change_aware_keys[:2]
    imgs = pairs.float()
    return _gray_standardize({k1: imgs[:, 0], k2: imgs[:, 1]}, spec)


def generate_pairs(images: Tensor, spec: PairSpec,
                   generator: Optional[torch.Generator] = None,
                   corners: Optional[Tensor] = None,
                   delta: Optional[Tensor] = None,
                   photometric_params: Optional[Sequence[Optional[Tensor]]]
                   = None, full_params: Optional[Tensor] = None,
                   blob_draws: Optional[Tuple[Tensor, int]] = None,
                   rows: Optional[Tuple[int, int]] = None
                   ) -> Dict[str, Tensor]:
    """Training pair synthesis (counterpart of
    ``bihome_tpu/data/pipeline.py:generate_pairs``): uint8/float images
    [B,H,W,3] -> batch dict. The corners and deltas are drawn from
    ``generator`` unless both are given (integer-valued [B,4,2]), then the
    photometric draws of image_1 and image_2 unless ``photometric_params``
    = (pd1, pd2) gives them ([B,12] or None each), then the full SSD
    chain's unless ``full_params`` [K,B,12] gives them (a spec with the
    dict-stage PhotometricDistort), then, with DATA.AUGMENT_BLOB_POROSITY
    > 0 and a global batch over 1, the blob occlusion's unless
    ``blob_draws`` = (noise [B,ps,ps], shift) gives them
    (:mod:`bihome_torch.data.blobs`, applied last, to the standardized
    patches, ``pipeline.py:397-402``). With
    ``spec.change_aware_keys`` set, ``images`` is [B,2,H,W,3] of real
    pairs and :func:`assemble_change_pairs` runs instead (no draws).

    With ``rows`` = (lo, total) the images are rows [lo, lo + B) of a
    global batch of ``total`` (a rank's slice): every draw made here is
    the global batch's, in the order above, of which those rows are kept,
    so the slices of the ranks make up the one-process batch. The blob
    occlusion rolls patch_1 over the global batch: its donors come from
    every rank's patch_1, gathered in one collective
    (``parallel.mesh.gather_over_ranks``), so each rank calls this at the
    same point with the same ``total``."""
    if spec.change_aware_keys:
        return assemble_change_pairs(images, spec)
    images = images.float()
    b = images.shape[0]
    lo, total = rows if rows is not None else (0, b)
    keep = slice(lo, lo + b)
    with tracing.span('datagen.draws'):
        if corners is None or delta is None:
            corners, delta = (t[keep] for t in draw_corners_delta_batch(
                total, tuple(images.shape[1:3]), spec, generator))
        if photometric_params is None:
            photometric_params = tuple(
                None if p is None else p[keep]
                for p in _draw_photometric(total, spec, generator))
        if full_params is None:
            full_params = draw_full_photometric(total, spec, generator)
            full_params = (None if full_params is None
                           else full_params[:, keep])
        corners = tracing.to_device(corners.long(), images.device)
        delta = tracing.to_device(delta.long(), images.device)
        pd1, pd2 = _params_to(images.device, *photometric_params)
        full_params = _to(full_params, images.device)
    batch = _assemble_pairs(images, corners, delta, spec, pd1, pd2,
                            full_params=full_params)
    if spec.blob_porosity > 0 and total > 1:
        if blob_draws is None:
            noise, shift = blobs.draw_blobs(
                total, batch['patch_2'].shape[1:3], generator)
            blob_draws = (noise[keep], shift)
        donors = batch['patch_1']
        if total != b:
            donors = mesh.gather_over_ranks(donors)
            if donors.shape[0] != total:
                raise ValueError(f'rows {rows}: the blob occlusion needs '
                                 f'the {total} rows of every rank')
        batch = blobs.apply_blob_augmentation(
            batch, *blob_draws, porosity=spec.blob_porosity,
            blobiness=spec.blobiness, donors_from=donors, lo=lo)
    return batch
