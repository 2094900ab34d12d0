"""Support for the port's CPU tests: golden files of the JAX side of the
slower ones, and the torch thread count.

A port test calls ``jax_reference(compute, inputs)``
(``jax_engine_reference`` for an engine call, ``jax_vjp_reference`` for a
function's values and vjp) for its JAX side. In the tier-1 run that reads
the test module's golden file,
``sasktran2_tpu_torch/data/golden_<module>.npz``, under the test's name,
so the run compiles no JAX graph for it.
``tools/make_torch_golden.py --case tests`` writes the files: it runs the
port's tests in record mode (``RECORD_ENV`` set), where ``compute()`` makes
the reference with the JAX package from the test's own numpy inputs.
Either way the port's side of the test runs as before, at the same
tolerance.

Each reference is stored with the ``digest`` of the inputs it was made
from (the arrays, the configuration objects, and the functions with the
values their closures hold), and a test whose inputs no longer match
its recorded digest fails, naming the command that records it anew.

It also holds ``one_torch_thread``, the fixture that runs a port test
module's torch ops on one thread, and ``reference_native_lib``, which
loads the JAX package's native ray tracer past a concurrent build.
"""

import enum
import fcntl
import functools
import hashlib
import json
import os
import tempfile
import time
import types

import numpy as np
import pytest
import torch

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "sasktran2_tpu_torch", "data",
)
# set (to any value) by ``tools/make_torch_golden.py --case tests`` while it
# runs the port's tests in record mode
RECORD_ENV = "SASKTRAN2_TORCH_RECORD_GOLDEN"
# module name -> {key: tree}, filled in record mode
RECORDED = {}
_LOADED = {}
_CALLS = {}


def path(module):
    """The golden file of a test module (``test_torch_engine`` ->
    ``golden_test_torch_engine.npz``)."""
    return os.path.join(DATA, f"golden_{module}.npz")


def _current_test():
    """(module name, test name with its parameters) of the running test."""
    nodeid = os.environ["PYTEST_CURRENT_TEST"].rsplit(" ", 1)[0]
    file, name = nodeid.split("::", 1)
    return os.path.splitext(os.path.basename(file))[0], name


def jax_reference(compute, inputs, key=None):
    """The JAX side of the running test, a tree (dicts, lists) of numpy
    arrays: read from the test module's golden file, under the test's
    name (or ``key``), after checking that the digest of ``compute``
    (with its closure) and ``inputs`` is the one recorded with it.
    ``inputs`` holds what ``compute`` reads: arrays, configuration
    objects, functions. In record mode ``compute()`` makes
    the reference with the JAX package and it is kept, with the digest,
    for the golden file. A test that takes several references gets them
    under its name, then its name and "#1", "#2"."""
    module, name = _current_test()
    if key is None:
        # a test's n-th reference (n > 0) gets "#n" after its name
        n = _CALLS.get((module, name), 0)
        _CALLS[(module, name)] = n + 1
        key = name if n == 0 else f"{name}#{n}"
    want = digest((compute, inputs))
    if os.environ.get(RECORD_ENV):
        tree = _to_numpy(compute())
        RECORDED.setdefault(module, {})[key] = {"tree": tree,
                                                "digest": np.array(want)}
        return tree
    if module not in _LOADED:
        _LOADED[module] = read(module)
    rerun = f"tools/make_torch_golden.py --case tests --tests {module}"
    if key not in _LOADED[module]:
        msg = f"{key} is not in {path(module)}: run {rerun}"
        raise KeyError(msg)
    stored = _LOADED[module][key]
    if str(stored["digest"]) != want:
        msg = (f"the inputs of {key} differ from those its reference in "
               f"{path(module)} was made from: run {rerun}")
        raise AssertionError(msg)
    return stored["tree"]


def digest(inputs):
    """sha256 (hex) of a test's inputs: arrays (numpy, JAX or torch) by
    dtype, shape and bytes; numbers, strings and enums by value; dicts,
    lists and tuples by their items; a function by its qualified name,
    its defaults and the values of its closure; any other object by its
    class name and attributes. An object met twice counts once."""
    h = hashlib.sha256()
    _feed(h, inputs, set())
    return h.hexdigest()


def _feed(h, x, seen):
    def tag(*parts):
        h.update(("|".join(str(p) for p in parts) + ";").encode())

    if x is None or isinstance(x, (bool, int, float, complex, str, bytes)):
        tag(type(x).__name__, repr(x))
    elif isinstance(x, enum.Enum):
        tag("enum", type(x).__qualname__, x.name)
    elif isinstance(x, (type, types.ModuleType, types.BuiltinFunctionType,
                        np.ufunc)):
        tag("name", getattr(x, "__qualname__", x.__name__))
    elif isinstance(x, torch.Tensor):
        _feed(h, x.detach().cpu().numpy(), seen)
    elif isinstance(x, np.ndarray) and x.dtype == object:
        tag("objects", x.shape)
        for v in x.ravel():
            _feed(h, v, seen)
    elif isinstance(x, (np.ndarray, np.generic)) or hasattr(x, "__array__"):
        a = np.ascontiguousarray(x)
        tag("array", a.dtype.str, a.shape)
        h.update(a.tobytes())
    elif id(x) in seen:
        tag("seen", type(x).__qualname__)
    elif isinstance(x, dict):
        seen.add(id(x))
        tag("dict", len(x))
        for k in sorted(x, key=repr):
            _feed(h, k, seen)
            _feed(h, x[k], seen)
    elif isinstance(x, (list, tuple, set, frozenset)):
        seen.add(id(x))
        items = sorted(x, key=repr) if isinstance(x, (set, frozenset)) else x
        tag(type(x).__name__, len(x))
        for v in items:
            _feed(h, v, seen)
    elif isinstance(x, types.FunctionType):
        seen.add(id(x))
        tag("function", x.__qualname__)
        _feed(h, x.__defaults__, seen)
        _feed(h, [c.cell_contents for c in x.__closure__ or ()], seen)
    elif isinstance(x, types.MethodType):
        _feed(h, (x.__func__, x.__self__), seen)
    elif isinstance(x, functools.partial):
        _feed(h, (x.func, x.args, x.keywords), seen)
    elif hasattr(x, "__dict__") or hasattr(x, "__slots__"):
        seen.add(id(x))
        tag("object", type(x).__qualname__)
        attrs = dict(getattr(x, "__dict__", {}))
        for k in getattr(type(x), "__slots__", ()):
            if hasattr(x, k):
                attrs[k] = getattr(x, k)
        _feed(h, attrs, seen)
    else:
        msg = f"digest: no rule for {type(x)!r}"
        raise TypeError(msg)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree)


def _encode(tree, leaves):
    if isinstance(tree, dict):
        return {"d": {k: _encode(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, list):
        return {"l": [_encode(v, leaves) for v in tree]}
    leaves.append(tree)
    return {"a": len(leaves) - 1}


def _decode(node, arrays):
    if "d" in node:
        return {k: _decode(v, arrays) for k, v in node["d"].items()}
    if "l" in node:
        return [_decode(v, arrays) for v in node["l"]]
    return arrays[f"a{node['a']}"]


def write(module, trees):
    """Write a module's golden file from {key: {"tree": tree, "digest":
    the inputs' digest}}."""
    leaves = []
    index = {k: _encode(v, leaves) for k, v in sorted(trees.items())}
    np.savez_compressed(
        path(module), index=np.array(json.dumps(index)),
        **{f"a{i}": a for i, a in enumerate(leaves)},
    )


def read(module):
    """{key: {"tree": tree, "digest": digest}} of a module's golden
    file."""
    with np.load(path(module)) as arrays:
        loaded = {k: arrays[k] for k in arrays.files}
    index = json.loads(str(loaded["index"]))
    return {k: _decode(v, loaded) for k, v in index.items()}


def dataset_tree(out, **extra):
    """An engine output ``Dataset`` as a golden tree: every variable's
    values and dimension names, the coordinates, and ``extra`` values (the
    route)."""
    return {
        "values": {k: out[k].to_numpy() for k in out.keys()},
        "dims": {k: np.array(out[k].dims) for k in out.keys()},
        "coords": {k: np.asarray(v) for k, v in out.coords.items()},
        "extra": extra,
    }


class GoldenDataset:
    """A golden tree of ``dataset_tree`` with the keys, dims and
    ``to_numpy`` of an output ``Dataset``; ``extra`` holds the rest."""

    def __init__(self, tree):
        self._values = tree["values"]
        self._dims = {k: tuple(str(d) for d in v)
                      for k, v in tree["dims"].items()}
        self.coords = tree["coords"]
        self.extra = {k: v.item() if np.ndim(v) == 0 else v
                      for k, v in tree.get("extra", {}).items()}

    def keys(self):
        return self._values.keys()

    def __getitem__(self, key):
        return _Variable(self._values[key], self._dims[key])


def jax_engine_reference(compute, inputs, key=None):
    """``jax_reference`` of an engine call: ``compute()`` returns the JAX
    engine and its output ``Dataset``; ``inputs`` are the call's
    (config, geometry, viewing geometry, atmosphere) before it runs. The
    golden file keeps the output and the engine's route
    (``twostream_fast_ok``, ``polarized_fast_ok``), and this returns a
    ``GoldenDataset``."""

    def tree():
        engine, out = compute()
        return dataset_tree(
            out, twostream_fast_ok=engine._twostream_fast_ok(),
            polarized_fast_ok=engine._polarized_fast_ok(),
        )

    return GoldenDataset(jax_reference(tree, inputs, key))


def jax_vjp_reference(ref_fn, inputs, cotangents, key=None):
    """``jax_reference`` of a JAX function's values and vjp: ``ref_fn``
    (a JAX function of ``inputs``, numpy arrays) returns an array or a
    list of arrays; ``cotangents(outputs)`` gives the cotangent of each
    output (the test's own seeded recipe, which the test applies to the
    port's outputs too). The digest covers ``inputs`` and both functions
    with their closures. Returns (outputs, gradients), lists of
    arrays."""

    def compute():
        import jax
        import jax.numpy as jnp

        ref, vjp = jax.vjp(jax.jit(ref_fn), *[jnp.asarray(x) for x in inputs])
        many = isinstance(ref, (list, tuple))
        outs = list(ref) if many else [ref]
        cts = [jnp.asarray(c) for c in cotangents(outs)]
        return {"out": outs,
                "grad": list(vjp(type(ref)(cts) if many else cts[0]))}

    tree = jax_reference(compute, (inputs, ref_fn, cotangents), key)
    return tree["out"], tree["grad"]


class _Variable:
    def __init__(self, values, dims):
        self._values, self.dims = values, dims

    def to_numpy(self):
        return self._values


def carry_atmosphere(ref_atmo, geometry, config):
    """``params.atmosphere_from_reference`` of a JAX-side atmosphere after
    its constituent pipeline has run (``internal_object``): the carried
    state is what the JAX engine would read, whether or not a JAX engine
    ran on it in this process (a test whose JAX side comes from a golden
    file runs none)."""
    from sasktran2_tpu_torch.params import atmosphere_from_reference

    ref_atmo.internal_object()
    return atmosphere_from_reference(ref_atmo, geometry, config)


def rel_err(got, ref):
    scale = np.max(np.abs(ref))
    return np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0)


def assert_outputs_match(got, ref, tol=1e-10):
    """Every output of the port's engine against the reference's: the
    same variables and dimension names, finite values, and each variable
    (each Stokes component apart) within ``tol`` of its largest
    magnitude."""
    assert set(got.keys()) == set(ref.keys())
    for key in ref.keys():
        a, b = got[key], ref[key]
        assert tuple(a.dims) == tuple(b.dims), key
        dims = tuple(a.dims)
        a, b = a.to_numpy(), b.to_numpy()
        assert a.shape == b.shape, key
        assert np.all(np.isfinite(a)), key
        if "stokes" in dims:
            ax = dims.index("stokes")
            for c in range(a.shape[ax]):
                err = rel_err(np.take(a, c, axis=ax), np.take(b, c, axis=ax))
                assert err <= tol, (key, c, err)
        else:
            assert rel_err(a, b) <= tol, (key, rel_err(a, b))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch ops on one intra-op thread (a module
    imports this fixture to have it). In the tier-1 run's six xdist
    workers on the CPU, torch's default pool (a thread per core in every
    worker) oversubscribes the cores, and the port's small tensors then
    spend most of their time waiting for threads: the 8-stream vector
    solver test took 44 s with 8 threads and 2 s with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_native_lib(timeout_s=120.0):
    """The JAX package's native ray tracer, loaded for certain.

    The JAX package compiles ``raytracer.cpp`` straight into its
    ``_sk_native.so`` (``g++ -o``), with no lock between processes and no
    rename. In a fresh checkout several xdist workers build it at once,
    and a worker that starts while another is writing the file finds it
    present but short ("file too short" from ``dlopen``): it caches the
    failure and traces with numpy from then on. This takes an
    inter-process lock (so the port's test workers build it one at a
    time), and while the library does not load, forgets the cached
    failure and tries again, until a concurrent build by any other
    process has finished. Raises ``RuntimeError`` if it never loads."""
    from sasktran2_tpu import native

    lock_path = os.path.join(tempfile.gettempdir(),
                             "sasktran2_tpu_native_build.lock")
    deadline = time.monotonic() + timeout_s
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while True:
                lib = native.get_native_lib()
                if lib is not None:
                    return lib
                if time.monotonic() > deadline:
                    msg = ("the JAX package's native ray tracer did not "
                           f"load within {timeout_s:g} s")
                    raise RuntimeError(msg)
                time.sleep(0.5)
                with native._LOCK:
                    native._TRIED = False
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
