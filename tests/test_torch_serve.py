"""The port's InferenceServer on CPU against the JAX server, on the same
weights and the same synthetic dataset."""

import dataclasses
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vqa_project_tpu.config import ModelConfig as JaxConfig
from vqa_project_tpu.data import GraphVQADataset
from vqa_project_tpu.data.synthetic import generate_synthetic_vqa
from vqa_project_tpu.serve import InferenceServer as JaxServer
from vqa_project_tpu.train.loop import build_model
from vqa_project_tpu_torch.config import ModelConfig
from vqa_project_tpu_torch.models import (GraphVQAModel,
                                          state_dict_from_jax_params)
from vqa_project_tpu_torch.serve import InferenceServer, make_http_server

N_OBJ, FEAT = 8, 24

MCFG = JaxConfig(emb_dim=24, hid_dim=32, combined_dim=16, n_kernels=4,
                 neighbourhood_size=4, dropout=0.1, max_qlen=10,
                 compute_dtype="float32")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_synth"))
    generate_synthetic_vqa(d, n_images=12, n_questions=64, n_obj=N_OBJ,
                           feat_dim=FEAT, q_vocab=30, n_answers=9)
    ds = GraphVQADataset.vqa2(d, "val", n_obj=N_OBJ, max_qlen=10)
    jmodel = build_model(MCFG, ds)
    params = jmodel.init(
        jax.random.key(0),
        jnp.zeros((2, ds.max_qlen), jnp.int32),
        jnp.zeros((2, ds.n_obj, ds.feat_dim), jnp.float32),
        jnp.ones((2,), jnp.int32))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in
                         dataclasses.asdict(jmodel.cfg).items()
                         if k in fields})
    model = GraphVQAModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    jsrv = JaxServer(jmodel, params, ds, batch_size=4, max_wait_ms=30.0,
                     top_k=3)
    tsrv = InferenceServer(model, ds, device="cpu", batch_size=4,
                           max_wait_ms=30.0, top_k=3)
    yield jsrv, tsrv, ds
    jsrv.close()
    tsrv.close()


def _questions(ds, n=12):
    iids = list(ds.store.id_to_row)
    return [(f"what color is object {i} ?", iids[i % len(iids)])
            for i in range(n)]


def test_same_top1_as_jax_server(servers):
    jsrv, tsrv, ds = servers
    for question, iid in _questions(ds):
        want = jsrv.predict(question, image_id=iid)
        got = tsrv.predict(question, image_id=iid)
        assert got["answer"] == want["answer"]
        assert len(got["top_k"]) == 3
        np.testing.assert_allclose(
            [t["prob"] for t in got["top_k"]],
            [t["prob"] for t in want["top_k"]], rtol=1e-4, atol=1e-5)


def test_pad_column_never_returned(servers):
    """Answer id n_answers-1 is the padding slot: not in any top-k."""
    _, tsrv, ds = servers
    q, image, qlen = tsrv.pad_batch([])
    _, idxs = tsrv._forward(q, image, qlen)
    assert (idxs != ds.n_answers - 1).all()
    assert idxs.shape == (tsrv.batch_size, 3)


def test_concurrent_submits_are_batched(servers):
    _, tsrv, ds = servers
    futs = [tsrv.submit(q, image_id=iid) for q, iid in _questions(ds)]
    outs = [f.result(timeout=60) for f in futs]
    assert len(outs) == 12
    assert max(o["batch_size"] for o in outs) > 1


def test_http_keep_alive(servers):
    _, tsrv, ds = servers
    httpd = make_http_server(tsrv, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        host, port = httpd.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["ok"] and health["warmup_s"] > 0
        iid = next(iter(ds.store.id_to_row))
        answers = []
        for question in ("what color", "is there a dog"):
            conn.request("POST", "/predict", body=json.dumps(
                {"question": question, "image_id": iid}))
            resp = conn.getresponse()
            assert resp.status == 200
            answers.append(json.loads(resp.read())["answer"])
        assert all(a in ds.a_itow.values() for a in answers)
        # a body sent to an unknown path is drained: the connection
        # stays in sync for the next request
        conn.request("POST", "/nope", body=json.dumps({"question": "x"}))
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        conn.request("POST", "/predict", body=json.dumps(
            {"question": "no image"}))
        resp = conn.getresponse()
        assert resp.status == 400
        resp.read()
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_worker_survives_batch_failure(servers):
    _, tsrv, ds = servers
    iid = next(iter(ds.store.id_to_row))

    class Boom:
        def get(self, *a, **k):
            raise RuntimeError("answer table exploded")

    real = tsrv.ds.a_itow
    tsrv.ds.a_itow = Boom()
    try:
        with pytest.raises(RuntimeError, match="exploded"):
            tsrv.predict("what color", image_id=iid, timeout=30)
    finally:
        tsrv.ds.a_itow = real
    assert tsrv._worker.is_alive()
    assert tsrv.predict("what color", image_id=iid,
                        timeout=30)["answer"] in ds.a_itow.values()


def test_cuda_server_needs_a_card(servers):
    _, tsrv, ds = servers
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(tsrv.model, ds)  # device defaults to "cuda"
    assert not next(tsrv.model.parameters()).is_cuda
