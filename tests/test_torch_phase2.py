"""The port's one-device sync pipeline against the NumPy host oracle:
``make_ddc_fn`` must give the same clustering as ``ddc_host(...,
contour="grid")`` on every layout of the reference's schedule-equivalence
table (tests/_phase2_script.py::CASES, copied as
``repro_torch.data.spatial.PARITY_CASES``) at 2, 4 and 8 shards, with no
cluster budget overflow."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ddc  # noqa: E402
from repro_torch.data import spatial  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def layouts():
    return {}


@pytest.mark.parametrize("k", (2, 4, 8))
@pytest.mark.parametrize("name", list(spatial.PARITY_CASES))
def test_same_clustering_as_host_oracle(name, k, layouts):
    make, eps, min_pts, grid, max_verts, max_clusters = spatial.PARITY_CASES[name]
    if name not in layouts:
        layouts[name] = make()
    pts = layouts[name]
    cfg = ddc.DDCConfig(eps=eps, min_pts=min_pts, grid=grid, max_verts=max_verts,
                        max_clusters=max_clusters, schedule="sync", block_sparse="never")
    glabels, gcs, _ = ddc.make_ddc_fn(cfg, k, device="cpu")(pts, np.ones(len(pts), bool))
    host, _, _ = ddc.ddc_host(pts, k, eps, min_pts, contour="grid")
    assert not bool(gcs.overflow)
    assert ddc.same_clustering(glabels.numpy(), host)


def test_parity_table_matches_reference_script():
    """The copied table holds the reference script's layouts and sizes."""
    assert list(spatial.PARITY_CASES) == [
        "blobs", "clustered", "d1", "d2", "worm_default",
        *spatial.PHASE2_LAYOUTS]
    assert spatial.PARITY_CASES["d2"][1:] == (0.03, 4, 36, 104, 12)
    assert len(spatial.PARITY_CASES["rings"][0]()) == 2048
