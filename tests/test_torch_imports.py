"""Import and device hygiene of the port: it never imports JAX or the
reference package, and its entry points never fall back to the CPU on
their own."""
import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def _port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


def test_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr


def test_every_submodule_listed():
    names = set(_port_modules())
    assert {"repro_torch.kernels.ops", "repro_torch.kernels._build",
            "repro_torch.core.ddc", "repro_torch.core.partitioner",
            "repro_torch.data.spatial", "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssd_scan", "repro_torch.models.layers",
            "repro_torch.models.transformer", "repro_torch.models.config",
            "repro_torch.configs", "repro_torch.configs.qwen3_8b",
            "repro_torch.configs.mamba2_1_3b", "repro_torch.serve.engine",
            "repro_torch.ddc", "repro_torch.ddc.api", "repro_torch.ddc.backends",
            "repro_torch.ddc.config", "repro_torch.serve.query_tier",
            "repro_torch.serve.faults", "repro_torch.core.simulate",
            "repro_torch.serve.cluster_service", "repro_torch.serve.journal",
            "repro_torch.serve.hierarchy", "repro_torch.serve.tracking",
            "repro_torch.serve.dist_service", "repro_torch.launch", "repro_torch.launch.mesh",
            "repro_torch.launch.serve", "repro_torch.parallel.compress",
            "repro_torch.launch.ranks", "repro_torch.launch.dryrun_ddc",
            "repro_torch.data.pipeline", "repro_torch.data.curation",
            "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_scaleout",
            "repro_torch.launch.cost", "repro_torch.launch.roofline"} <= names
    for name in names:
        importlib.import_module(name)


def test_no_jax_or_reference_import_lines():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "examples" / "quickstart_torch.py",
                                          ROOT / "examples" / "data_curation_torch.py",
                                          ROOT / "examples" / "train_lm_torch.py",
                                          ROOT / "examples" / "serve_lm_torch.py",
                                          ROOT / "tests" / "_torch_ranks_probe.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if FORBIDDEN.match(line)]
    assert not bad, bad


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.core import ddc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ddc.DDCConfig(schedule="sync", block_sparse="never")
    with pytest.raises(RuntimeError, match="CUDA"):
        ddc.make_ddc_fn(cfg, 2)
    ddc.make_ddc_fn(cfg, 2, device="cpu")  # the explicit CPU request works


def test_cuda_tensors_go_to_the_kernel_route(monkeypatch):
    """A CUDA tensor never reaches the plain version: the wrapper takes the
    kernel route (its input checks are replaced here to observe that
    without a card)."""
    from repro_torch.kernels import pairwise_dist

    class FakeCudaTensor:
        device = torch.device("cuda")

    def kernel_route(*args):
        raise RuntimeError("kernel route")

    monkeypatch.setattr(pairwise_dist, "_check_points", kernel_route)
    with pytest.raises(RuntimeError, match="kernel route"):
        pairwise_dist.neighbor_count(FakeCudaTensor(), None, 0.1)
