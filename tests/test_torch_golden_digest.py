"""The golden files of the port's tests (``tests/torch_support.py``): a
reference is read only for the inputs it was made from.

``digest`` tells apart inputs that differ in values, dtype, shape,
configuration or closure, and gives equal inputs one digest;
``jax_reference`` refuses a stored reference whose digest differs from
its test's inputs, and names the command that records it anew.
"""

import enum

import numpy as np
import pytest
import torch

from tests import torch_support


class _Mode(enum.Enum):
    A = 1
    B = 2


class _Config:
    def __init__(self, n, mode):
        self.n, self.mode = n, mode
        self.arr = np.linspace(0.0, 1.0, n)


def _fn(scale):
    def f(x):
        return scale * x
    return f


def test_equal_inputs_share_a_digest():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4))
    inputs = [a, {"c": _Config(5, _Mode.A), "k": 2.5}, _fn(np.ones(2))]
    same = [a.copy(), {"k": 2.5, "c": _Config(5, _Mode.A)},
            _fn(np.ones(2))]
    assert torch_support.digest(inputs) == torch_support.digest(same)
    assert (torch_support.digest(torch.tensor(a))
            == torch_support.digest(a))


@pytest.mark.parametrize("change", [
    "value", "dtype", "shape", "attribute", "enum", "closure",
])
def test_changed_inputs_change_the_digest(change):
    a = np.arange(6.0).reshape(2, 3)
    base = [a, _Config(4, _Mode.A), _fn(2.0)]
    other = {
        "value": lambda: [a + 1e-15 * (a == 5.0), *base[1:]],
        "dtype": lambda: [a.astype(np.float32), *base[1:]],
        "shape": lambda: [a.reshape(3, 2), *base[1:]],
        "attribute": lambda: [a, _Config(5, _Mode.A), base[2]],
        "enum": lambda: [a, _Config(4, _Mode.B), base[2]],
        "closure": lambda: [a, base[1], _fn(3.0)],
    }[change]()
    assert torch_support.digest(base) != torch_support.digest(other)


def test_stale_reference_is_refused(monkeypatch):
    """A reference stored under the test's name with another input's
    digest fails the test; the matching digest returns the tree."""
    module, name = torch_support._current_test()
    x = np.arange(3.0)

    def compute():
        return x

    stored = {"tree": x, "digest": np.array(
        torch_support.digest((compute, x + 1.0)))}
    monkeypatch.delenv(torch_support.RECORD_ENV, raising=False)
    monkeypatch.setitem(torch_support._LOADED, module, {name: stored})
    with pytest.raises(AssertionError, match="--case tests --tests"):
        torch_support.jax_reference(compute, x, key=name)
    stored["digest"] = np.array(torch_support.digest((compute, x)))
    np.testing.assert_array_equal(
        torch_support.jax_reference(compute, x, key=name), x)
