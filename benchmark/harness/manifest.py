"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.<ext>``), its correctness limits
(``limits/<workload>.json``) and each metric's reader
(``metrics/<metric>.py``, a function ``read(ctx)``). Adding a cell, a mix
or a metric adds files and entries; no existing file changes."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]
TRAFFIC_EXTS = ('.json', '.jsonl', '.toml', '.txt', '.csv')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def load(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / 'BENCHMARK.json').read_text())


def find(directory: Path, name: str, exts=('.json',)) -> Path:
    """The one file ``<name><ext>`` in ``directory``."""
    if not NAME.match(name):
        raise ValueError(f'not a name: {name!r}')
    found = [directory / (name + e) for e in exts
             if (directory / (name + e)).is_file()]
    if len(found) != 1:
        raise FileNotFoundError(f'{directory}/{name}{{{",".join(exts)}}}: '
                                f'{len(found)} files')
    return found[0]


def read_traffic(path: Path) -> Dict[str, Any]:
    """A traffic file's parameters: a JSON object (.json), its first line
    (.jsonl), TOML (.toml), or key = value lines (.txt, .csv as key,value),
    values read as JSON where they parse."""
    text = path.read_text()
    if path.suffix == '.json':
        return json.loads(text)
    if path.suffix == '.jsonl':
        return json.loads(text.splitlines()[0])
    if path.suffix == '.toml':
        import tomllib
        return tomllib.loads(text)
    out: Dict[str, Any] = {}
    sep = ',' if path.suffix == '.csv' else '='
    for line in text.splitlines():
        if line.strip() and not line.lstrip().startswith('#'):
            key, value = (s.strip() for s in line.split(sep, 1))
            try:
                out[key] = json.loads(value)
            except json.JSONDecodeError:
                out[key] = value
    return out


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, manifest: Dict[str, Any], workload: str,
                 bench: Path = BENCH):
        entries = {w['name']: w for w in manifest['workloads']}
        if workload not in entries:
            raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
        self.entry = entries[workload]
        self.name = workload
        self.chips = int(self.entry['chips'])
        configs = {c['name']: c for c in manifest['configs']}
        self.config_entry = configs[self.entry['config']]
        self.config = json.loads((bench.parent
                                  / self.config_entry['file']).read_text())
        self.traffic = read_traffic(find(bench / 'traffic',
                                         self.entry['traffic'],
                                         TRAFFIC_EXTS))
        limits = bench / 'limits' / f'{workload}.json'
        self.limits: Optional[Dict[str, float]] = (
            json.loads(limits.read_text())['limits']
            if limits.is_file() else None)
        self.manifest = manifest

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        """The metrics this cell reports: the end-to-end ones without a
        trace, the per-layer ones with it, each where its ``workloads``
        names this cell or where it has none."""
        group = self.manifest['per_layer' if trace else 'end_to_end']
        return [m for m in group
                if self.name in m.get('workloads', [self.name])]


def reader(name: str, bench: Path = BENCH) -> Callable[[Dict], Any]:
    """``read`` of ``metrics/<name>.py``."""
    path = find(bench / 'metrics', name, ('.py',))
    spec = importlib.util.spec_from_file_location(
        f'benchmark_metric_{len(name)}_{abs(hash(name))}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
