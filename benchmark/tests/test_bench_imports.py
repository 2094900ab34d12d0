"""What a run may load: nothing of JAX or the JAX package, compared by
whole top-level names, and a reference that loads nothing of the port."""

import subprocess
import sys
import types

import pytest

import core
from conftest import BENCH


@pytest.mark.parametrize("name,foreign", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("sasktran2_tpu", True), ("sasktran2_tpu.engine", True),
    ("sasktran2_tpu_torch", False), ("sasktran2_tpu_torch.engine", False),
    ("jaxtyping", False), ("jax_like", False),
])
def test_foreign_modules_compare_whole_names(monkeypatch, name, foreign):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in core.foreign_modules()) is foreign


def test_reference_imports_no_port_and_no_jax():
    names = core.reference_imports()
    assert not names & {"jax", "jaxlib", "flax", "sasktran2_tpu",
                        "sasktran2_tpu_torch"}
    assert {"numpy", "torch"} <= names


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "import reference.ground16, reference.ground16_f64, reference.limb16\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sasktran2_tpu', 'sasktran2_tpu_torch')]\n"
        "assert not bad, bad\n" % BENCH)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
