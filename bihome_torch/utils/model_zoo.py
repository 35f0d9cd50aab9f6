"""Weight cache: the reference's ``cache_url`` without the download
(counterpart of ``bihome_tpu/utils/model_zoo.py``; ref:
src/utils/model_zoo.py:21-62).

``resolve_weights`` maps a URL or a path to a local file:

* a plain path passes through (FileNotFoundError if it does not exist);
* a URL is looked up in the cache directory by its basename (placed there
  by the user: there is no download);
* rank 0 alone checks the cache, then every rank waits at a barrier
  before it reads (the reference's rank-0 download and barrier).
"""

from __future__ import annotations

import os
from typing import Optional
from urllib.parse import urlparse

from bihome_torch.parallel import dist_util


def default_cache_dir() -> str:
    return os.environ.get(
        'BIHOME_MODEL_ZOO',
        os.path.join(os.path.expanduser('~'), '.cache', 'bihome_torch'))


def resolve_weights(url_or_path: str,
                    model_dir: Optional[str] = None) -> str:
    """URL or path -> local file path. Raises FileNotFoundError with a clear
    message when a URL's cached copy is absent (no network access)."""
    if not (url_or_path.startswith('http://')
            or url_or_path.startswith('https://')):
        if not os.path.exists(url_or_path):
            raise FileNotFoundError(url_or_path)
        return url_or_path

    model_dir = model_dir or default_cache_dir()
    filename = os.path.basename(urlparse(url_or_path).path)
    cached = os.path.join(model_dir, filename)
    if dist_util.is_main_process() and not os.path.exists(cached):
        raise FileNotFoundError(
            f'{url_or_path} is not cached at {cached} and this environment '
            f'has no network access; place the file there manually '
            f'(reference behavior: rank-0 download, '
            f'ref: src/utils/model_zoo.py:50-58).')
    dist_util.synchronize()
    return cached
