"""The reference package's own dist engine as the oracle of the port's: both
run in tests/_torch_dist_script.py under a forced host device count (the
reference pins one shard per JAX device, and the count must be set before
JAX starts), and are compared bit for bit after every refresh — labels,
pair-d2, the meter, query answers and ``state_dict`` — as
tests/test_dist_backend.py runs its own script.  The quick layout and the
tree cells are tier 1; the sweep over the other layouts and the orderings
are ``slow``, as the reference marks its own."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.data import spatial as tsp  # noqa: E402

SCRIPT = os.path.join(os.path.dirname(__file__), "_torch_dist_script.py")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def run_script(arg: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, SCRIPT, arg], capture_output=True, text=True,
                          timeout=1800, env=env)
    assert proc.returncode == 0, f"{arg} failed:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


def test_equals_reference_dist_quick():
    out = run_script("linked_ovals")
    assert "ALL_OK" in out and out.count("PASS") == 3


def test_tree_on_dist_equals_reference_dist():
    out = run_script("hier")
    assert "ALL_OK" in out and out.count("PASS hier") == 2


@pytest.mark.slow
@pytest.mark.parametrize("layout", sorted(set(tsp.PHASE2_LAYOUTS) - {"linked_ovals"}))
def test_equals_reference_dist_sweep(layout):
    out = run_script(layout)
    assert "ALL_OK" in out and out.count("PASS") == 3


@pytest.mark.slow
def test_ingest_evict_orderings_equal_reference_dist():
    out = run_script("orderings")
    assert "ALL_OK" in out and "PASS orderings" in out
