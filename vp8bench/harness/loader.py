"""Find the benchmark's files by the names BENCHMARK.json gives them.

A data file is `<kind>/<name>.json`; a code file is `<kind>/<name>.py`,
loaded from its path, so that a name may hold dots
(`layer_metrics/dec.entropy_ms_per_frame.py`).
"""
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
_modules = {}


def path(kind, name, ext):
    return os.path.join(HERE, kind, f"{name}{ext}")


def data(kind, name):
    with open(path(kind, name, ".json")) as f:
        return json.load(f)


def exists(kind, name, ext=".py"):
    return os.path.isfile(path(kind, name, ext))


def module(kind, name):
    """The module `<kind>/<name>.py`, loaded once per process."""
    key = (kind, name)
    if key not in _modules:
        file = path(kind, name, ".py")
        if not os.path.isfile(file):
            raise FileNotFoundError(f"no {kind} named {name!r} ({file})")
        spec = importlib.util.spec_from_file_location(
            f"vp8bench.{kind}.{name.replace('.', '_')}", file)
        mod = importlib.util.module_from_spec(spec)
        # registered, so that pickle finds its classes (reference workers)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return _modules[key]


def spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)
