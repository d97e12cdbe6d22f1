"""Checkpoint interchange on the CPU: the port reads the JAX package's
flax-msgpack checkpoints without flax (every array bit for bit as
``flax.serialization.msgpack_restore`` gives it, bfloat16 Adam moments,
chunked arrays, the legacy (n, in, d) conv layout), evaluates and takes
one Adam step from one as JAX does (f32), resumes a mid-epoch one at its
batch, exports the reference's bare ``.pt`` as the JAX package's export
does, and gives one accuracy through ``cli.run --eval`` from all three
kinds. chip_smoke.py's flax-free writer is read back by flax."""

import dataclasses
import functools
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from tests.test_model import CFG, make_batch
from vqa_project_tpu.cli import export_torch as j_export
from vqa_project_tpu.config import ModelConfig as JModelConfig
from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu.data import GraphVQADataset as JDataset
from vqa_project_tpu.models import GraphVQAModel as JaxModel
from vqa_project_tpu.ops import losses as j_losses
from vqa_project_tpu.train.loop import build_model as j_build_model
from vqa_project_tpu.train.state import create_train_state
from vqa_project_tpu.train.state import load_checkpoint as j_load
from vqa_project_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_project_tpu.train.state import save_checkpoint as j_save
from vqa_project_tpu_torch.cli import export_torch, run
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import generate_synthetic_vqa
from vqa_project_tpu_torch.models import (GraphVQAModel,
                                          load_reference_checkpoint,
                                          state_dict_from_jax_params)
from vqa_project_tpu_torch.train import (build_model, fit, load_checkpoint,
                                         make_optimizer, save_checkpoint,
                                         train_step)
from vqa_project_tpu_torch.train._msgpack import read_flax_msgpack

LR = 1e-3
SPE = 3                     # steps per epoch of the schedule
JCFG = dataclasses.replace(CFG, use_pallas=False, dropout=0.0)


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _port_cfg(**kw) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    base = {k: v for k, v in dataclasses.asdict(JCFG).items()
            if k in fields}
    base.update(kw)
    return ModelConfig(**base)


def _batch(rng, b=4):
    q, image, qlen = (np.array(a) for a in make_batch(rng, b))
    answers = (rng.uniform(size=(b, CFG.out_dim))
               * (rng.uniform(size=(b, CFG.out_dim)) < 0.2)
               ).astype(np.float32)
    return {"question": q, "image": image, "qlen": qlen, "answers": answers,
            "votes": np.zeros_like(answers),
            "mask": np.ones((b,), np.float32)}


def _jax_loss(model, params, batch):
    logits, _, _ = model.apply(params, jnp.asarray(batch["question"]),
                               jnp.asarray(batch["image"]),
                               jnp.asarray(batch["qlen"]))
    return j_losses.multilabel_soft_margin_loss(
        logits, jnp.asarray(batch["answers"]), jnp.asarray(batch["mask"]))


JMODEL = JaxModel(cfg=JCFG)


@functools.lru_cache(maxsize=None)
def _tx(mu_dtype):
    return j_make_optimizer(JTrainConfig(lr=LR, adam_mu_dtype=mu_dtype), SPE)


@functools.lru_cache(maxsize=None)
def _jax_step(mu_dtype):
    """JAX's Adam step (its moments in ``mu_dtype``), jitted."""
    tx = _tx(mu_dtype)

    def step(state, batch):
        grads = jax.grad(lambda p: _jax_loss(JMODEL, p, batch))(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return state.replace(
            params=optax.apply_updates(state.params, updates),
            opt_state=opt_state, step=state.step + 1)
    return jax.jit(step)


def _jax_checkpoint(path, mu_dtype="float32", steps=2, epoch=1, extra=None):
    """A JAX checkpoint after ``steps`` Adam steps (nonzero moments);
    returns its template state."""
    rng = np.random.default_rng(7)
    state = create_train_state(JMODEL, JCFG, _tx(mu_dtype), _batch(rng),
                               seed=3)
    template = state
    for _ in range(steps):
        state = _jax_step(mu_dtype)(state, _batch(rng))
    j_save(str(path), state, epoch=epoch, extra=extra)
    return template


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ck") / "jax.ckpt"
    return str(path), _jax_checkpoint(path)


def _bits(x):
    """An array's bytes and dtype name, bfloat16 as its bits."""
    if torch.is_tensor(x):
        name = str(x.dtype).replace("torch.", "")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return name, x.numpy().tobytes(), tuple(x.shape)
    x = np.asarray(x)
    return x.dtype.name, x.tobytes(), x.shape


def _assert_same_tree(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        g_name, g_bytes, g_shape = _bits(got)
        w_name, w_bytes, w_shape = _bits(want)
        assert (g_name, g_shape) == (w_name, w_shape), where
        assert g_bytes == w_bytes, where
    else:
        assert got == want and type(got) is type(want), where


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_reader_matches_flax(tmp_path, mu_dtype):
    path = tmp_path / "jax.ckpt"
    _jax_checkpoint(path, mu_dtype, extra={"step_in_epoch": 2})
    data = path.read_bytes()
    got = read_flax_msgpack(data)
    _assert_same_tree(got, flax.serialization.msgpack_restore(data))
    mu = got["opt_state"]["0"]["mu"]["params"]["out_2"]["v"]
    assert mu.dtype == getattr(torch, mu_dtype) and mu.abs().max() > 0
    assert got["extra"] == {"step_in_epoch": 2} and got["step"] == 2


def test_reader_joins_chunked_arrays(tmp_path, monkeypatch, jax_ckpt):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    path = tmp_path / "chunked.ckpt"
    _jax_checkpoint(path)
    data = path.read_bytes()
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(read_flax_msgpack(data),
                      flax.serialization.msgpack_restore(data))
    # the same weights as the unchunked file of the same run
    a = load_checkpoint(str(path))["state_dict"]
    b = load_checkpoint(jax_ckpt[0])["state_dict"]
    assert all(torch.equal(a[k], b[k]) for k in b)


def _legacy(tree, n_kernels):
    """The pre-fusion (n, in, d) conv layout, as
    tests/test_ckpt_migration.py writes it."""
    if not isinstance(tree, dict):
        return
    for key, val in tree.items():
        if key == "conv_kernels" and getattr(val, "ndim", 0) == 2:
            in_dim, nd = val.shape
            tree[key] = (np.asarray(val).reshape(in_dim, n_kernels,
                                                 nd // n_kernels)
                         .transpose(1, 0, 2))
        else:
            _legacy(val, n_kernels)


def _restored(path):
    model = GraphVQAModel(_port_cfg(), device="cpu")
    optimizer, scheduler = make_optimizer(model, TrainConfig(lr=LR), SPE)
    payload = load_checkpoint(path, model, optimizer, scheduler)
    return model, optimizer, scheduler, payload


def test_legacy_conv_checkpoint_loads_as_the_fused_one(tmp_path, jax_ckpt):
    payload = flax.serialization.msgpack_restore(
        open(jax_ckpt[0], "rb").read())
    _legacy(payload, JCFG.n_kernels)
    assert payload["params"]["params"]["graph_convolution_1"][
        "conv_kernels"].ndim == 3
    legacy = tmp_path / "legacy.ckpt"
    legacy.write_bytes(flax.serialization.msgpack_serialize(payload))
    data = legacy.read_bytes()
    _assert_same_tree(read_flax_msgpack(data),
                      flax.serialization.msgpack_restore(data))
    m1, o1, _, _ = _restored(jax_ckpt[0])
    m2, o2, _, _ = _restored(str(legacy))
    for k, v in m1.state_dict().items():
        assert torch.equal(v, m2.state_dict()[k]), k
    s1, s2 = o1.state_dict()["state"], o2.state_dict()["state"]
    for i in s1:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s1[i][key], s2[i][key]), (i, key)


def test_refusals(tmp_path):
    bad = tmp_path / "complex.ckpt"
    bad.write_bytes(msgpack.packb(
        {"params": msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))},
        use_bin_type=True))
    with pytest.raises(ValueError, match="complex"):
        load_checkpoint(str(bad))
    other = tmp_path / "other.ckpt"
    other.write_bytes(msgpack.packb({"weights": 1}))
    with pytest.raises(ValueError, match="no params"):
        load_checkpoint(str(other))
    cut = tmp_path / "cut.ckpt"
    cut.write_bytes(b"\x85\xa6params\x80")
    with pytest.raises(ValueError, match="not a complete flax msgpack"):
        load_checkpoint(str(cut))


def test_eval_forward_matches_jax(jax_ckpt, rng):
    path, template = jax_ckpt
    _, state = j_load(path, template)
    q, image, qlen = make_batch(rng, 6)
    want, want_adj, _ = JMODEL.apply(state.params, q, image, qlen)
    port = GraphVQAModel(_port_cfg(), device="cpu")
    payload = load_checkpoint(path, port)
    assert payload["epoch"] == 1 and payload["step"] == 2
    got, adj, _ = port(*(torch.from_numpy(np.array(a))
                         for a in (q, image, qlen)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(adj.numpy(), np.asarray(want_adj), rtol=1e-4,
                               atol=1e-4)


def _norm_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adam_step_after_resume_matches_jax(tmp_path, mu_dtype):
    """One Adam step from the same JAX file: the moments restored are the
    file's (bfloat16 ones widened to f32 bit for bit), the step count and
    the learning rate follow it, and the parameters after the step agree
    within 1e-5 of each tensor's scale with JAX's step from that file in
    float32 moments: a port Adam configured for float32 moments widens
    the file's, as JAX does when its template asks for float32 (the next
    test resumes into bfloat16 moments)."""
    path = str(tmp_path / "jax.ckpt")
    _jax_checkpoint(path, mu_dtype)
    batch = _batch(np.random.default_rng(11))
    template = create_train_state(JMODEL, JCFG, _tx("float32"), batch,
                                  seed=0)
    _, state = j_load(path, template)
    new = _jax_step("float32")(state, batch)

    model, optimizer, scheduler, _ = _restored(path)
    adam = read_flax_msgpack(open(path, "rb").read())["opt_state"]["0"]
    mu = state_dict_from_jax_params(jax.tree.map(
        lambda x: x.float().numpy(), adam["mu"]))
    names = {id(p): k for k, p in model.named_parameters()}
    for p, s in optimizer.state.items():
        assert torch.equal(s["exp_avg"], mu[names[id(p)]])
        assert int(s["step"]) == int(adam["count"]) == 2
    assert scheduler.last_epoch == 2
    train_step(model, optimizer, scheduler, batch)
    want = state_dict_from_jax_params(new.params)
    for name, p in model.named_parameters():
        err = _norm_err(p.detach().numpy(), want[name].numpy())
        assert err <= 1e-5, (name, err)


def test_adam_step_after_resume_into_bf16_moments_matches_jax(tmp_path):
    """A JAX file with bfloat16 first moments resumed into a port Adam
    configured for bfloat16 moments: the moments restored are the file's
    bit for bit and stay bfloat16, and one step lands within 1e-5 of each
    tensor's scale of JAX's step (bfloat16 products rounded) from that
    file into a bfloat16 template."""
    path = str(tmp_path / "jax.ckpt")
    _jax_checkpoint(path, "bfloat16")
    batch = _batch(np.random.default_rng(12))
    template = create_train_state(JMODEL, JCFG, _tx("bfloat16"), batch,
                                  seed=0)
    _, state = j_load(path, template)
    grads = jax.jit(jax.grad(lambda p: _jax_loss(JMODEL, p, batch)))(
        state.params)
    # optax's update with every bfloat16 product rounded, as its
    # functions are written: by default XLA:CPU keeps b1 * mu in f32
    # (tests/test_torch_adam_dtypes.py)
    update = jax.jit(
        lambda g, st, p: optax.apply_updates(
            p, _tx("bfloat16").update(g, st, p)[0]),
        compiler_options={"xla_allow_excess_precision": False})
    new_params = update(grads, state.opt_state, state.params)
    model = GraphVQAModel(_port_cfg(), device="cpu")
    optimizer, scheduler = make_optimizer(
        model, TrainConfig(lr=LR, adam_mu_dtype="bfloat16"), SPE)
    load_checkpoint(path, model, optimizer, scheduler)
    adam = read_flax_msgpack(open(path, "rb").read())["opt_state"]["0"]
    assert all(x.dtype == torch.bfloat16
               for x in jax.tree.leaves(adam["mu"]))
    mu = state_dict_from_jax_params(jax.tree.map(
        lambda x: x.float().numpy(), adam["mu"]))
    names = {id(p): k for k, p in model.named_parameters()}
    for p, st in optimizer.state.items():
        assert st["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(st["exp_avg"].float(), mu[names[id(p)]])
        assert st["exp_avg_sq"].dtype == torch.float32
    train_step(model, optimizer, scheduler, batch)
    want = state_dict_from_jax_params(new_params)
    for name, p in model.named_parameters():
        err = _norm_err(p.detach().numpy(), want[name].numpy())
        assert err <= 1e-5, (name, err)
        assert optimizer.state[p]["exp_avg"].dtype == torch.bfloat16


@pytest.mark.parametrize("mu,nu", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32")])
def test_grid_checkpoint_named_pt_loads_as_a_port_checkpoint(
        tmp_path, monkeypatch, mu, nu):
    """The medical grid's checkpoint, ``{prefix}_{n_obj}_{kernels}_{neigh}_
    {acc}.pt``, is told by its content, not its suffix: load_checkpoint
    reads it as a port checkpoint (never as a reference .pt), with its
    weights, step, epoch and extra, the scheduler at its step (the grid
    saves none) and the Adam moments bit for bit in the configured
    dtypes."""
    tcfg = TrainConfig(lr=LR, lr_milestones=(1,), adam_mu_dtype=mu,
                       adam_nu_dtype=nu)
    model = GraphVQAModel(_port_cfg(), device="cpu", seed=1)
    optimizer, scheduler = make_optimizer(model, tcfg, SPE)
    rng = np.random.default_rng(3)
    for _ in range(4):
        train_step(model, optimizer, scheduler, _batch(rng))
    path = str(tmp_path / "clef_51_8_19_12.50.pt")
    save_checkpoint(path, model, optimizer, step=4, epoch=2,
                    model_cfg=model.cfg, train_cfg=tcfg,
                    extra={"accuracy": 12.5})
    from vqa_project_tpu_torch.train import state as state_mod

    def refuse(*a, **k):
        raise AssertionError("read as a reference .pt")

    monkeypatch.setattr(state_mod, "_restore_reference", refuse)
    fresh = GraphVQAModel(_port_cfg(), device="cpu", seed=2)
    opt2, sched2 = make_optimizer(fresh, tcfg, SPE)
    payload = load_checkpoint(path, fresh, opt2, sched2)
    assert state_mod.is_port_checkpoint(payload)
    assert (payload["step"], payload["epoch"]) == (4, 2)
    assert payload["extra"] == {"accuracy": 12.5}
    assert payload["train_config"]["adam_mu_dtype"] == mu
    assert sched2.last_epoch == 4 and sched2.get_last_lr() == [LR * 0.5]
    assert opt2.param_groups[0]["lr"] == LR * 0.5
    trained = dict(model.named_parameters())
    for name, p in fresh.named_parameters():
        assert torch.equal(p, trained[name]), name
        st, want = opt2.state[p], optimizer.state[trained[name]]
        assert st["exp_avg"].dtype == getattr(torch, mu)
        assert st["exp_avg_sq"].dtype == getattr(torch, nu)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(st[key], want[key]), (name, key)


# the in-memory synthetic task of tests/test_torch_resume.py, dropout 0
GEN = dict(n_images=10, n_questions=80, n_obj=6, feat_dim=12, q_vocab=16,
           n_answers=8, seed=21)
MODEL = dict(hid_dim=16, combined_dim=8, n_kernels=4, neighbourhood_size=3,
             dropout=0.0, compute_dtype="float32")
BS, EMB = 12, 10          # 60 train questions: 5 steps an epoch


def test_mid_epoch_jax_checkpoint_resumes_at_its_batch(tmp_path):
    """A JAX checkpoint written after step 3 of epoch 1 (epoch 1, its
    ``step_in_epoch`` 3) resumes epoch 1 from batch 4, as the port's own
    checkpoint of the same weights, moments and position does."""
    ds = generate_synthetic_vqa(**GEN, emb_dim=EMB, max_qlen=8)
    jcfg = JModelConfig(**MODEL, use_pallas=False, vocab_size=17,
                        emb_dim=EMB, feat_dim=16, out_dim=9, n_obj=6,
                        max_qlen=8)
    tx = j_make_optimizer(JTrainConfig(), 5)
    sample = {"question": np.zeros((2, 8), np.int32),
              "image": np.zeros((2, 6, 16), np.float32),
              "qlen": np.ones((2,), np.int32)}
    state = create_train_state(JaxModel(cfg=jcfg), jcfg, tx, sample, seed=1)
    state = state.replace(step=jnp.asarray(3, jnp.int32))
    msgpack_path = str(tmp_path / "jax.ckpt")
    j_save(msgpack_path, state, epoch=1, extra={"step_in_epoch": 3})

    tcfg = TrainConfig(lr=5e-3, epochs=2, batch_size=BS, log_interval=1,
                       eval_interval=0, seed=4)
    model = build_model(ModelConfig(**MODEL), ds["train"], device="cpu")
    optimizer, scheduler = make_optimizer(model, tcfg, 5)
    load_checkpoint(msgpack_path, model, optimizer, scheduler)
    port_path = str(tmp_path / "port.ckpt")
    save_checkpoint(port_path, model, optimizer, scheduler, step=3, epoch=1,
                    generator=torch.Generator().manual_seed(tcfg.seed),
                    extra={"step_in_epoch": 3})

    runs = []
    for resume in (msgpack_path, port_path):
        jsonl = str(tmp_path / f"{os.path.basename(resume)}.jsonl")
        m, _, _ = fit(tcfg, ModelConfig(**MODEL), ds["train"], device="cpu",
                      resume_path=resume, jsonl_path=jsonl)
        with open(jsonl) as f:
            recs = [json.loads(line) for line in f]
        runs.append((m, recs))
    (m_jax, recs_jax), (m_port, recs_port) = runs
    assert [(r["epoch"], r["step"]) for r in recs_jax] == (
        [(0, 4), (0, 5)] + [(1, s) for s in range(6, 11)])
    keys = ("epoch", "step", "loss", "vqa_acc", "lr")
    assert ([[r[k] for k in keys] for r in recs_jax]
            == [[r[k] for k in keys] for r in recs_port])
    for k, v in m_port.state_dict().items():
        assert torch.equal(v, m_jax.state_dict()[k]), k


def test_export_matches_jax_export(jax_ckpt, tmp_path):
    path = jax_ckpt[0]
    ours, theirs = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    export_torch.main([path, ours])
    j_export.main([path, theirs])
    got = torch.load(ours, weights_only=True)
    want = torch.load(theirs, weights_only=True)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    model = GraphVQAModel(_port_cfg(), device="cpu")
    model.load_state_dict(load_reference_checkpoint(ours))
    loaded = load_checkpoint(path)["state_dict"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, loaded[k]), k
    # the port's own checkpoint exports to the same file
    port_ckpt = str(tmp_path / "port.ckpt")
    save_checkpoint(port_ckpt, model)
    again = str(tmp_path / "again.pt")
    export_torch.main([port_ckpt, again])
    assert all(torch.equal(torch.load(again, weights_only=True)[k], v)
               for k, v in want.items())


SMALL = ["--synthetic", "--hid", "64", "--n_kernels", "4",
         "--neighbourhood_size", "5", "--bsize", "32", "--device", "cpu",
         "--compute_dtype", "float32"]


def test_three_kinds_give_one_accuracy(tmp_path, monkeypatch, capsys):
    """One set of weights as a JAX msgpack, its exported reference .pt and
    the port's checkpoint: ``cli.run --eval`` prints one accuracy and
    writes one result.json from each."""
    data = str(tmp_path / "data")
    args, _, _ = run.input_args(["--eval", *SMALL, "--data_dir", data])
    sdir = run.synthetic_dir(args)
    jds = JDataset.vqa2(sdir, "val", args.emb, args.n_obj)
    mcfg = JModelConfig(hid_dim=64, n_kernels=4, neighbourhood_size=5,
                        compute_dtype="float32", use_pallas=False)
    jmodel = j_build_model(mcfg, jds)
    tx = j_make_optimizer(JTrainConfig(), 4)
    sample = {"question": np.zeros((2, jds.max_qlen), np.int32),
              "image": np.zeros((2, jds.n_obj, jds.feat_dim), np.float32),
              "qlen": np.ones((2,), np.int32)}
    state = create_train_state(jmodel, jmodel.cfg, tx, sample, seed=5)
    paths = {"jax": str(tmp_path / "jax.ckpt"), "pt": str(tmp_path / "m.pt"),
             "port": str(tmp_path / "m.ckpt")}
    j_save(paths["jax"], state, epoch=2)
    export_torch.main([paths["jax"], paths["pt"]])
    ds = run._dataset(args, "val")
    model = build_model(run.make_configs(args)[0], ds, device="cpu")
    load_checkpoint(paths["jax"], model)
    save_checkpoint(paths["port"], model, step=8, epoch=2)
    monkeypatch.chdir(tmp_path)
    accs, results = {}, {}
    for kind, path in paths.items():
        capsys.readouterr()
        run.main(["--eval", *SMALL, "--data_dir", data, "--model_path",
                  path])
        (line,) = [x for x in capsys.readouterr().out.splitlines()
                   if x.startswith("accuracy: ")]
        accs[kind] = line
        with open("result.json") as f:
            results[kind] = json.load(f)
    assert len(set(accs.values())) == 1, accs
    assert results["jax"] == results["pt"] == results["port"]
    assert len(results["jax"]) == jds.n_questions


def test_chip_smoke_writer_is_read_by_flax(tmp_path):
    """chip_smoke.py writes phase 16's JAX-layout checkpoint without flax:
    flax reads it back bit for bit, JAX restores it into its train state,
    and the port reads back the weights and Adam state it came from."""
    model = GraphVQAModel(_port_cfg(), device="cpu", seed=5)
    optimizer, scheduler = make_optimizer(model, TrainConfig(lr=LR), SPE)
    rng = np.random.default_rng(2)
    for _ in range(2):
        train_step(model, optimizer, scheduler, _batch(rng))
    path = str(tmp_path / "written.ckpt")
    chip_smoke.write_jax_checkpoint(path, model, optimizer, step=2, epoch=1,
                                    extra={"step_in_epoch": 0})
    restored = flax.serialization.msgpack_restore(open(path, "rb").read())
    _assert_same_tree(restored["params"],
                      chip_smoke.jax_layout(model.state_dict()))
    assert (restored["step"], restored["epoch"]) == (2, 1)
    # JAX's own reader takes it into a train state of the same model
    template = create_train_state(JMODEL, JCFG, _tx("float32"), _batch(rng),
                                  seed=0)
    _, state = j_load(path, template)
    want = state_dict_from_jax_params(state.params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    m2, o2, s2, payload = _restored(path)
    assert payload["extra"] == {"step_in_epoch": 0} and s2.last_epoch == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, m2.state_dict()[k]), k
    params2 = dict(m2.named_parameters())
    for name, p in model.named_parameters():
        s, s_2 = optimizer.state[p], o2.state[params2[name]]
        assert torch.equal(s["exp_avg"], s_2["exp_avg"]), name
        assert torch.equal(s["exp_avg_sq"], s_2["exp_avg_sq"]), name
        assert int(s_2["step"]) == 2
