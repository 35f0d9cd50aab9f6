"""Offline dataset preprocessor of the port (counterpart of the root
``preprocess_offline.py``; ref: src/data/coco/preprocess_offline.py).

Rescale (aspect-preserving) + center-crop every image to WxH and dump
.npy, or write one contiguous ``pack.bhpk`` that the train and eval
entry points stream through the native reader (``data/pack.py``):

    python -m bihome_torch.preprocess_offline --input_dir DIR \\
        --output_dir OUT [--width 320 --height 240] [--pack | --pack_only]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from bihome_torch.data.datasets import ImageFolderDataset
from bihome_torch.data.pack import write_pack


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--input_dir', required=True)
    parser.add_argument('--output_dir', required=True)
    parser.add_argument('--width', type=int, default=320)
    parser.add_argument('--height', type=int, default=240)
    parser.add_argument('--pack', action='store_true',
                        help='also write pack.bhpk')
    parser.add_argument('--pack_only', action='store_true',
                        help='write only pack.bhpk, skip the .npy dump')
    args = parser.parse_args(argv)

    ds = ImageFolderDataset(args.input_dir,
                            image_size=(args.width, args.height))
    if not args.pack_only:
        ds.preprocess_offline(args.output_dir)
        print(f'Wrote {len(ds)} .npy files to {args.output_dir}')
    if args.pack or args.pack_only:
        os.makedirs(args.output_dir, exist_ok=True)
        out = os.path.join(args.output_dir, 'pack.bhpk')
        write_pack(out, (ds.load_image(i) for i in range(len(ds))))
        print(f'Wrote {len(ds)}-image pack to {out}')


if __name__ == '__main__':
    main()
