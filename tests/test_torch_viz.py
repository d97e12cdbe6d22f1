"""The port's interpretability plots and utils against the JAX
package's, on the CPU.

The renderers are held to JAX's on one shared adjacency (figure artists
and cv2 pixels exactly: argsort's tie order is only comparable on the
same input); ``visualize_checkpoint`` and ``plot_given_question`` end to
end on the same files and the same f32 weights (a JAX parameter tree
through ``state_dict_from_jax_params``): the same CSV rows, figure names
and predictions, adjacencies within 1e-5 x max|A|. The port's ``viz``
and ``cli.plot`` import without matplotlib and cv2.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from vqa_project_tpu import utils as j_utils
from vqa_project_tpu import viz as j_viz
from vqa_project_tpu.config import ModelConfig as JModelConfig
from vqa_project_tpu.data import Batcher as JBatcher
from vqa_project_tpu.data import GraphVQADataset as JDataset
from vqa_project_tpu.data.synthetic import ensure_synthetic_images
from vqa_project_tpu.data.synthetic import generate_synthetic_vqa as j_gen
from vqa_project_tpu.train.loop import build_model as j_build_model
from vqa_project_tpu.viz import cv2_plots as j_cv2
from vqa_project_tpu.viz import plots as j_plots
from vqa_project_tpu_torch import utils
from vqa_project_tpu_torch import viz
from vqa_project_tpu_torch.config import ModelConfig
from vqa_project_tpu_torch.data import GraphVQADataset
from vqa_project_tpu_torch.models import state_dict_from_jax_params
from vqa_project_tpu_torch.train import build_model
from vqa_project_tpu_torch.viz import cv2_plots

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OBJ, QLEN, BS, N_BATCHES = 8, 10, 8, 2
GEN = dict(n_images=8, n_questions=96, n_obj=N_OBJ, feat_dim=16,
           q_vocab=12, n_answers=6)
MODEL = dict(emb_dim=16, hid_dim=24, combined_dim=12, n_kernels=3,
             neighbourhood_size=3, dropout=0.1, max_qlen=QLEN,
             compute_dtype="float32")
ADJ_TOL = 1e-5     # x max|A|: f32 on both sides


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX generator's files with raw JPEGs; both packages' val
    split; the JAX model with random f32 weights and the port's model
    holding the same weights."""
    d = str(tmp_path_factory.mktemp("viz"))
    j_gen(d, **GEN)
    image_dir = ensure_synthetic_images(d)
    jds = JDataset.vqa2(d, "val", emb_dim=16, n_obj=N_OBJ, max_qlen=QLEN)
    pds = GraphVQADataset.vqa2(d, "val", emb_dim=16, n_obj=N_OBJ,
                               max_qlen=QLEN)
    jmodel = j_build_model(JModelConfig(**MODEL), jds)
    sample = next(iter(JBatcher(jds, 2)))
    params = jmodel.init(jax.random.key(0), jnp.asarray(sample["question"]),
                         jnp.asarray(sample["image"]),
                         jnp.asarray(sample["qlen"]))
    model = build_model(ModelConfig(**MODEL), pds, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    return jds, pds, jmodel, params, model, image_dir


def _boxes_adjacency(k, ties=False, seed=0):
    rng = np.random.default_rng(seed)
    xy1 = rng.uniform(0, 0.5, size=(k, 2))
    wh = rng.uniform(0.05, 0.4, size=(k, 2))
    boxes = np.concatenate([xy1, xy1 + wh], axis=-1).astype(np.float32)
    if ties:   # many equal row sums: argsort's order decides the top-N
        adj = rng.integers(0, 3, size=(k, k)).astype(np.float32)
    else:
        adj = rng.uniform(size=(k, k)).astype(np.float32)
    return boxes, adj


def _artists(fig):
    """Every drawn property the renderer sets."""
    ax = fig.axes[0]
    return {
        "title": ax.get_title(),
        "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
        "rects": [(p.get_xy(), p.get_width(), p.get_height(),
                   tuple(p.get_edgecolor()), p.get_linewidth(),
                   p.get_alpha()) for p in ax.patches],
        "lines": [(ln.get_xydata().tolist(), ln.get_linewidth(),
                   ln.get_alpha(), ln.get_color()) for ln in ax.lines],
        "images": [im.get_array().tolist() for im in ax.images],
    }


# ---------------- utils ----------------

@pytest.mark.parametrize("name", ["xyxy2xywh", "xywh2xyxy"])
def test_box_converters_match_jax(name):
    x = np.random.default_rng(3).uniform(0, 2, size=(7, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(getattr(utils, name)(x),
                                  getattr(j_utils, name)(x))


@pytest.mark.parametrize("s", ["a|b@c?", "plain", "x€y¿z (1+2)=3;",
                               "¡hola! ¨´><"])
def test_clean_str_matches_jax(s):
    assert utils.clean_str(s) == j_utils.clean_str(s)


# ---------------- host helpers ----------------

def test_exports_are_jax_exports_plus_the_halves():
    assert viz.__all__ == j_viz.__all__ + ["collect_graphs", "render_graphs",
                                           "given_question_graph"]
    assert all(callable(getattr(viz, name)) for name in viz.__all__)


@pytest.mark.parametrize("shape", [(5, 5), (3, 6, 6)])
def test_node_weights_match_jax(shape):
    adj = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    np.testing.assert_array_equal(viz.node_weights_from_adjacency(adj),
                                  j_viz.node_weights_from_adjacency(adj))


def test_make_segments_matches_jax():
    x, y = np.linspace(0, 1, 9), np.linspace(2, -1, 9) ** 2
    np.testing.assert_array_equal(viz.make_segments(x, y),
                                  j_viz.make_segments(x, y))


@pytest.mark.parametrize("query", [
    ("what color is the sky", None), ("How many dogs?", "7"),
    ("How many dogs?", "9"), ("missing?", None), ("  HOW MANY DOGS", None)])
def test_find_question_matches_jax(query):
    rows = [{"question": "What color is the sky?", "image_id": "42"},
            {"question": "How many dogs?", "image_id": "3"},
            {"question": "How many dogs?", "image_id": "7"}]
    assert (viz.find_question(rows, *query)
            == j_viz.find_question(rows, *query))


def test_resolve_image_path_and_load_image_match_jax(tmp_path):
    d = str(tmp_path)
    img = np.random.default_rng(2).integers(0, 255, (8, 8, 3), np.uint8)
    for name in ("COCO_val2014_000000000042.jpg",
                 "COCO_test2015_000000000005.jpg", "synpic123.jpg",
                 "x.png"):
        plt.imsave(os.path.join(d, name), img)
    for iid in (42, "42", 5, "synpic123.jpg", "synpic123", "x", 999,
                "nope"):
        assert viz.resolve_image_path(d, iid) == j_viz.resolve_image_path(
            d, iid)
    assert viz.resolve_image_path(None, 42) is None
    assert viz.load_image(None) is None
    path = viz.resolve_image_path(d, 42)
    np.testing.assert_array_equal(viz.load_image(path),
                                  j_viz.load_image(path))


def test_predictions_csv_and_read_adj_match_jax(tmp_path):
    rows = [{"image_id": "1", "question": "q, with comma?",
             "prediction": "a", "answer": "b"},
            {"image_id": "2", "question": 'say "hi"', "prediction": "",
             "answer": ""}]
    viz.save_predictions_csv(rows, str(tmp_path / "p" / "preds.csv"))
    j_viz.save_predictions_csv(rows, str(tmp_path / "j" / "preds.csv"))
    assert ((tmp_path / "p" / "preds.csv").read_bytes()
            == (tmp_path / "j" / "preds.csv").read_bytes())
    adj = np.random.default_rng(4).uniform(size=(3, 5, 5)).astype(
        np.float32)
    p = str(tmp_path / "adj.npz")
    np.savez_compressed(p, adjacency=adj, index=np.arange(3))
    mine, theirs = viz.read_adj(p), j_viz.read_adj(p)
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])


# ---------------- renderers on one shared adjacency ----------------

@pytest.mark.parametrize("case", ["canvas", "raster", "ties", "top_all"])
def test_plot_adjacency_graph_artists_equal_jax(case):
    k = 10
    boxes, adj = _boxes_adjacency(k, ties=case == "ties")
    kw = dict(question="what is this?", prediction="cat", answer="dog")
    if case == "raster":
        kw["image"] = np.random.default_rng(5).integers(
            0, 255, size=(60, 80, 3), dtype=np.uint8)
    if case == "top_all":
        kw.update(top_nodes=k + 3, question="", prediction="", answer="")
    mine = viz.plot_adjacency_graph(boxes, adj, **kw)
    theirs = j_viz.plot_adjacency_graph(boxes, adj, **kw)
    got, want = _artists(mine), _artists(theirs)
    plt.close(mine)
    plt.close(theirs)
    assert got == want
    assert len(got["rects"]) == min(kw.get("top_nodes", 7), k)


def test_plot_adjacency_graph_writes_jpeg(tmp_path):
    boxes, adj = _boxes_adjacency(9)
    path = str(tmp_path / "fig.jpg")
    fig = viz.plot_adjacency_graph(boxes, adj, question="q?", path=path)
    assert os.path.getsize(path) > 5_000
    assert not plt.fignum_exists(fig.number)     # saved and closed


def test_colorline_matches_jax():
    x, y = np.linspace(0, 1, 6), np.linspace(0, 2, 6)
    figs = []
    for fn in (viz.colorline, j_viz.colorline):
        fig, ax = plt.subplots()
        lc = fn(ax, x, y, linewidth=2, alpha=0.5)
        figs.append((fig, lc))
    (f1, a), (f2, b) = figs
    np.testing.assert_array_equal(np.asarray(a.get_segments()),
                                  np.asarray(b.get_segments()))
    np.testing.assert_array_equal(a.get_array(), b.get_array())
    assert (a.get_linewidth() == b.get_linewidth()).all()
    assert a.get_alpha() == b.get_alpha()
    plt.close(f1)
    plt.close(f2)


@pytest.mark.parametrize("case", ["canvas", "raster", "ties"])
def test_cv2_plot_boxes_pixels_equal_jax(tmp_path, case):
    boxes, adj = _boxes_adjacency(9, ties=case == "ties", seed=7)
    image = None
    if case == "raster":
        image = np.random.default_rng(8).integers(0, 255, (120, 160, 3),
                                                  dtype=np.uint8)
    kw = dict(image=image, caption="what is this? pred: cat", top_edges=12)
    mine = cv2_plots.plot_boxes(boxes, adj, path=str(tmp_path / "p.jpg"),
                                **kw)
    theirs = j_cv2.plot_boxes(boxes, adj, path=str(tmp_path / "j.jpg"),
                              **kw)
    np.testing.assert_array_equal(mine, theirs)
    assert ((tmp_path / "p.jpg").read_bytes()
            == (tmp_path / "j.jpg").read_bytes())


# ---------------- end to end on shared weights ----------------

def test_visualize_checkpoint_matches_jax(setup, tmp_path):
    jds, pds, jmodel, params, model, image_dir = setup
    assert pds.n_questions > BS * N_BATCHES        # a subset is rendered
    j_out = j_viz.visualize_checkpoint(
        jmodel, params, jds, str(tmp_path / "j"), batch_size=BS,
        n_batches=N_BATCHES, num_devices=1, image_dir=image_dir)
    p_out = viz.visualize_checkpoint(
        model, pds, str(tmp_path / "p"), batch_size=BS,
        n_batches=N_BATCHES, image_dir=image_dir)
    names = sorted(os.listdir(p_out))
    assert names == sorted(os.listdir(j_out))
    assert sum(n.endswith(".jpg") for n in names) == BS * N_BATCHES
    csv = "infer_predictions.csv"
    with open(os.path.join(p_out, csv), "rb") as a, \
            open(os.path.join(j_out, csv), "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(p_out, "summary.json")) as a, \
            open(os.path.join(j_out, "summary.json")) as b:
        got, want = json.load(a), json.load(b)
    assert got.pop("accuracy") == pytest.approx(want.pop("accuracy"),
                                                abs=1e-4)
    assert got == want == {"figures": BS * N_BATCHES,
                           "eval_batches": N_BATCHES}
    got, want = (viz.read_adj(os.path.join(o, "adjacencies.npz"))
                 for o in (p_out, j_out))
    np.testing.assert_array_equal(got["index"], want["index"])
    assert got["adjacency"].dtype == np.float32
    assert got["adjacency"].shape == (BS * N_BATCHES, N_OBJ, N_OBJ)
    scale = float(np.abs(want["adjacency"]).max())
    np.testing.assert_allclose(got["adjacency"], want["adjacency"], rtol=0,
                               atol=ADJ_TOL * scale)


def test_collect_graphs_writes_no_figure(setup, tmp_path):
    _, pds, _, _, model, image_dir = setup
    out = str(tmp_path / "c")
    graphs = viz.collect_graphs(model, pds, out, batch_size=BS, n_batches=1)
    assert sorted(os.listdir(out)) == ["adjacencies.npz",
                                       "infer_predictions.csv",
                                       "summary.json"]
    assert len(graphs.rows) == BS and graphs.adjacency.shape[0] == BS
    assert viz.render_graphs(pds, graphs, out, image_dir=image_dir) == BS
    qids = {pds.vqa[i]["question_id"] for i in graphs.index}
    assert {f"adj_{q}.jpg" for q in qids} <= set(os.listdir(out))


def _jax_question_graph(jmodel, params, jds, idx):
    t = jds.table
    logits, adjacency, _ = jmodel.apply(
        params, jnp.asarray(t.tokens[idx:idx + 1]),
        jnp.asarray(jds.store.batch(t.image_row[idx:idx + 1])),
        jnp.asarray(t.qlen[idx:idx + 1]))
    pred = jds.a_itow[int(jnp.argmax(logits[0][:-1]))]
    return np.asarray(adjacency[0]), pred


@pytest.mark.parametrize("row", [0, 5, 17])
def test_given_question_graph_matches_jax(setup, row):
    jds, pds, jmodel, params, model, _ = setup
    q = pds.vqa[row]["question"]
    iid = pds.vqa[row]["image_id"]
    g = viz.given_question_graph(model, pds, q, image_id=iid)
    idx = j_plots.find_question(jds.vqa, q, iid)
    assert g.index == idx
    adj, pred = _jax_question_graph(jmodel, params, jds, idx)
    assert g.prediction == pred
    assert g.adjacency.dtype == np.float32
    np.testing.assert_allclose(g.adjacency, adj, rtol=0,
                               atol=ADJ_TOL * float(np.abs(adj).max()))
    np.testing.assert_array_equal(
        g.boxes, np.asarray(jds.store.boxes[jds.table.image_row[idx]]))


def test_plot_given_question_matches_jax(setup, tmp_path):
    jds, pds, jmodel, params, model, image_dir = setup
    q = pds.vqa[3]["question"]
    mine = viz.plot_given_question(model, pds, q, image_dir=image_dir)
    theirs = j_viz.plot_given_question(jmodel, params, jds, q,
                                       image_dir=image_dir)
    got, want = _artists(mine), _artists(theirs)
    plt.close(mine)
    plt.close(theirs)
    assert got["title"] == want["title"]          # question + prediction
    assert got["images"] == want["images"]
    # boxes and colours exactly; widths and alphas follow the adjacency
    assert ([r[:3] + (r[3][:3],) for r in got["rects"]]
            == [r[:3] + (r[3][:3],) for r in want["rects"]])
    np.testing.assert_allclose(
        [(r[3][3],) + r[4:] for r in got["rects"]],
        [(r[3][3],) + r[4:] for r in want["rects"]], rtol=1e-4)
    path = str(tmp_path / "one.jpg")
    viz.plot_given_question(model, pds, q, path=path)
    assert os.path.getsize(path) > 5_000
    with pytest.raises(KeyError):
        viz.plot_given_question(model, pds, "not a real question?")


def test_given_question_excludes_the_pad_column(setup):
    """A classifier bias that sends every argmax to the answer
    vocabulary's pad slot (the last column, which has no word) still
    yields a word: the argmax runs over logits[:-1], as in JAX."""
    _, pds, _, _, model, _ = setup
    bias = model.out_2.bias
    saved = bias.detach().clone()
    try:
        with torch.no_grad():
            bias[-1] = 1e6
        g = viz.given_question_graph(model, pds, pds.vqa[0]["question"])
    finally:
        with torch.no_grad():
            bias.copy_(saved)
    assert g.prediction in pds.a_wtoi


def test_imports_without_the_plotting_stack():
    code = ("import sys\n"
            "for m in ('matplotlib', 'cv2', 'PIL'):\n"
            "    sys.modules[m] = None\n"
            "import vqa_project_tpu_torch.viz\n"
            "import vqa_project_tpu_torch.viz.cv2_plots\n"
            "import vqa_project_tpu_torch.cli.plot\n"
            "import vqa_project_tpu_torch.data.synthetic\n"
            "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"
