"""Spans the benchmark wraps around calls into the program.

A target is `"package.module:Owner.attr"` (a method, a staticmethod or a
module-level function). Each per-layer metric that reads a span lists its
targets in `SPANS`, as dicts with the keys `target`, `name` (the span's
name; several targets may share one), `sync` (bracket the call with
`torch.cuda.synchronize()`, which removes overlap: traced runs only) and
`consume` (the target is a generator function: the wrapper runs it to its
end and hands back an iterator over what it yielded).

`Patches` installs wrappers and takes them off again. A target that no
longer exists is skipped and named in `missing`: the metric that reads it
then finds nothing and reads null.
"""
import collections
import importlib
import inspect
import threading
import time


def resolve(target):
    """(owner, attribute name) of "module:Owner.attr" or "module:func"."""
    mod_name, _, qual = target.partition(":")
    owner = importlib.import_module(mod_name)
    *path, attr = qual.split(".")
    for part in path:
        owner = getattr(owner, part)
    if not hasattr(owner, attr):
        raise AttributeError(f"{target} does not exist")
    return owner, attr


class Patches:
    """Wrappers installed over program attributes; `remove` restores each
    attribute as it was (a method inherited from a base class is deleted
    from the subclass again)."""

    def __init__(self):
        self._saved = []
        self.missing = []

    def wrap(self, target, make_wrapper):
        """Replace `target` by make_wrapper(original function)."""
        try:
            owner, attr = resolve(target)
        except (ImportError, AttributeError):
            self.missing.append(target)
            return False
        raw = inspect.getattr_static(owner, attr)
        static = isinstance(raw, staticmethod)
        fn = raw.__func__ if static else getattr(owner, attr)
        wrapper = make_wrapper(fn)
        self._saved.append((owner, attr, owner.__dict__.get(attr, None),
                            attr in owner.__dict__))
        setattr(owner, attr, staticmethod(wrapper) if static else wrapper)
        return True

    def remove(self):
        for owner, attr, orig, own in reversed(self._saved):
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._saved = []


class SpanRecorder:
    """Seconds and calls per span name, summed over threads."""

    def __init__(self):
        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self._lock = threading.Lock()

    def add(self, name, dt):
        with self._lock:
            self.seconds[name] += dt
            self.calls[name] += 1


def _sync_fn():
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.synchronize
    return None


def timed_wrapper(spec, recorder):
    """A wrapper that adds each call's wall time to `recorder`."""
    name, consume = spec["name"], spec.get("consume", False)
    sync = _sync_fn() if spec.get("sync") else None

    def make(fn):
        def wrapper(*a, **k):
            if sync:
                sync()
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
                if consume:
                    out = iter(list(out))
                return out
            finally:
                if sync:
                    sync()
                recorder.add(name, time.perf_counter() - t0)
        return wrapper
    return make


def marked_wrapper(spec):
    """A wrapper that opens a profiler range named `vp8bench:<name>`
    around each call (no clock, no synchronize), for the profiled tail."""
    from torch.profiler import record_function
    label, consume = "vp8bench:" + spec["name"], spec.get("consume", False)

    def make(fn):
        def wrapper(*a, **k):
            with record_function(label):
                out = fn(*a, **k)
                if consume:
                    out = iter(list(out))
                return out
        return wrapper
    return make


def capture_wrapper(records, capture):
    """A wrapper that appends capture(args, kwargs) to `records` before
    each call: the launch shapes a roofline reads after the tail."""
    def make(fn):
        def wrapper(*a, **k):
            records.append(capture(a, k))
            return fn(*a, **k)
        return wrapper
    return make
