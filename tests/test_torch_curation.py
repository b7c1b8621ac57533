"""The port's data pipeline and DDC curation against the reference
package's, on the CPU.

The reference's mesh path runs ``make_ddc_fn`` inside ``shard_map``, so it
needs one device per lane: ``tests/_torch_ref_script.py curation`` runs its
``curate(emb, mesh=make_host_mesh(8))`` on 8 host devices in a subprocess,
started with the module so that it works while the in-process tests run.
The tests hold the port's ``curate(emb, mesh=make_lane_mesh(8, "cpu"))``
to it, the host path and ``apply_to_data_config`` to the reference in
process, and the pipeline's batches and embeddings bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_ref_script import CURATION_CASES, example_corpus  # noqa: E402
from repro.data import curation as jcur  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.data import curation as tcur  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("labels", "n_clusters", "cluster_sizes", "sample_weights", "exchanged_fraction")


def dcfg(pipe, **kw):
    base = dict(vocab=512, seq_len=32, global_batch=4, seed=3, n_latent_clusters=8)
    return pipe.DataConfig(**(base | kw))


def data_cases(pipe):
    """tests/test_data.py's three curation inputs and the example's."""
    e6, i6 = pipe.doc_embeddings(dcfg(pipe, n_latent_clusters=6), 1200)
    e4, i4 = pipe.doc_embeddings(dcfg(pipe, n_latent_clusters=4), 800)
    keep = (i4 != 0) | (np.arange(800) % 4 == 0)
    e400, i400 = pipe.doc_embeddings(dcfg(pipe, n_latent_clusters=4), 400)
    _, ex, exi = example_corpus(pipe)
    return {"structure": (e6, i6), "skewed": (e4[keep], i4[keep]),
            "apply": (e400, i400), "example": (ex, exi)}


def fields_of(res) -> dict:
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def assert_same_result(got, want: dict):
    """``got``'s fields equal the arrays of ``want`` in dtype, shape and value."""
    for f in FIELDS:
        g, w = np.asarray(getattr(got, f)), want[f]
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.fixture(autouse=True, scope="module")
def _reference_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("curation") / "reference.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_ref_script.py"),
                             "curation", str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def mesh_reference(_reference_run):
    proc, path = _reference_run
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


PIPE_CONFIGS = {
    "plain": {},
    "audio": dict(frontend="audio_stub", frontend_seq=10, d_model=16),
    "prefix": dict(prefix_len=6, d_model=16),
    "weighted": dict(curation_weights=np.array([5.0, 1, 1, 1, 0.5, 1, 1, 2])),
}


@pytest.mark.parametrize("name", list(PIPE_CONFIGS))
def test_pipeline_equals_reference(name):
    """batch_at, iterate and doc_embeddings bit for bit, and the config's
    fields alike."""
    kw = PIPE_CONFIGS[name]
    t, j = dcfg(tpipe, **kw), dcfg(jpipe, **kw)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for i in (0, 1, 7):
        a, b = tpipe.batch_at(t, i), jpipe.batch_at(j, i)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    it_t, it_j = tpipe.iterate(t, 3), jpipe.iterate(j, 3)
    for _ in range(2):
        np.testing.assert_array_equal(next(it_t)["tokens"], next(it_j)["tokens"])
    for got, want in zip(tpipe.doc_embeddings(t, 300, seed=5),
                         jpipe.doc_embeddings(j, 300, seed=5)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["structure", "skewed", "apply", "example"])
def test_host_curate_equals_reference(case):
    """The host path (ddc_host over 8 shards): labels, sizes, weights,
    cluster count and exchanged fraction."""
    emb, _ = data_cases(tpipe)[case]
    got = tcur.curate(emb)
    assert_same_result(got, fields_of(jcur.curate(emb)))
    assert got.n_clusters >= 4


@pytest.mark.parametrize("case", ["apply", "example"])
def test_apply_to_data_config_equals_reference(case):
    """The installed weights, from the port's result into the port's
    DataConfig and from the reference's into the reference's, and the
    batches drawn under them."""
    emb, ids = data_cases(tpipe)[case]
    k = int(ids.max()) + 1
    t_cfg, j_cfg = dcfg(tpipe, n_latent_clusters=k), dcfg(jpipe, n_latent_clusters=k)
    t_new = tcur.apply_to_data_config(t_cfg, tcur.curate(emb), ids)
    j_new = jcur.apply_to_data_config(j_cfg, jcur.curate(emb), ids)
    assert isinstance(t_new, tpipe.DataConfig)
    np.testing.assert_array_equal(t_new.curation_weights, j_new.curation_weights)
    np.testing.assert_array_equal(tpipe.batch_at(t_new, 2)["tokens"],
                                  jpipe.batch_at(j_new, 2)["tokens"])


@pytest.mark.parametrize("name", list(CURATION_CASES))
def test_mesh_curate_equals_reference(name, mesh_reference):
    """curate over 8 CPU lanes against the reference's curate on an
    8-device host mesh: labels, sizes, weights and the exchanged fraction
    (the reference's formula: log2 K buffers for async)."""
    fields = CURATION_CASES[name]
    cfg = None if fields is None else tddc.DDCConfig(**fields)
    _, emb, _ = example_corpus(tpipe)
    got = tcur.curate(emb, mesh=tmesh.make_lane_mesh(8, "cpu"), cfg=cfg)
    assert_same_result(got, {f: mesh_reference[f"{name}/{f}"] for f in FIELDS})


@pytest.mark.parametrize("schedule", ["sync", "tree"])
def test_mesh_exchanged_fraction(schedule):
    """The reference's wire formula on 8 lanes for sync and the tree: K − 1
    ClusterSet buffers over the embeddings' bytes (the tree counted as
    sync's, ROADMAP C); async's log2 K is held to the reference above."""
    cfg = tddc.DDCConfig(eps=0.04, min_pts=4, grid=128, max_clusters=64, max_verts=64,
                         schedule=schedule)
    _, emb, _ = example_corpus(tpipe)
    got = tcur.curate(emb, mesh=tmesh.make_lane_mesh(8, "cpu"), cfg=cfg)
    assert got.exchanged_fraction == cfg.buffer_bytes() * 7 / (len(emb) * 4 * 2)
    assert got.n_clusters == 8


def test_host_and_mesh_paths_agree():
    """On the example's corpus the host path (hull contours, exact overlap)
    and 8 lanes (grid contours) find the same clustering; the default
    config is the reference's."""
    _, emb, _ = example_corpus(tpipe)
    host = tcur.curate(emb)
    lanes = tcur.curate(emb, mesh=tmesh.make_lane_mesh(8, "cpu"))
    assert tddc.same_clustering(host.labels, lanes.labels)
    np.testing.assert_array_equal(np.sort(host.cluster_sizes), np.sort(lanes.cluster_sizes))
    assert dataclasses.asdict(tcur.DEFAULT_CONFIG) == dataclasses.asdict(
        tddc.DDCConfig(eps=0.04, min_pts=4, grid=128, max_clusters=64, max_verts=64))


def test_mesh_pads_to_the_lane_count():
    """A corpus that does not split into the lanes is padded and masked:
    the padded rows get no label, and 7 lanes give the same clusters."""
    _, emb, _ = example_corpus(tpipe)
    cfg = tddc.DDCConfig(eps=0.04, min_pts=4, grid=128, max_clusters=64, max_verts=64,
                         schedule="sync")
    res = tcur.curate(emb[:3001], mesh=tmesh.make_lane_mesh(7, "cpu"), cfg=cfg)
    assert res.labels.shape == (3001,) and res.n_clusters == 8


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv,want", [([], (8, "cuda")),
                                       (["--lanes", "4", "--device", "cpu"], (4, "cpu")),
                                       (["--lanes", "0"], None)])
def test_example_runs_lanes_on_the_card_by_default(monkeypatch, argv, want):
    """examples/data_curation_torch.py: 8 lanes on ``cuda`` unless told
    otherwise; ``--lanes 0`` takes the host path (no lanes)."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import data_curation_torch as example
    finally:
        sys.path.remove(str(ROOT / "examples"))
    made = []

    def curate(emb, mesh=None):
        made.append(mesh)
        raise _Stop

    monkeypatch.setattr(example.mesh_mod, "make_lane_mesh", lambda n, dev: (n, dev))
    monkeypatch.setattr(example.curation, "curate", curate)
    with pytest.raises(_Stop):
        example.main(argv)
    assert made == [want]
