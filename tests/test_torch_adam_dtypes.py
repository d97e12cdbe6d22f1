"""The port's Adam (``train/state.py::Adam``) against the JAX package's
optax Adam, with each moment stored in float32 or bfloat16.

The same parameters and 5 steps of the same gradients (numpy, from a
seed) go through the port's ``make_optimizer`` and JAX's
``make_optimizer(TrainConfig(adam_mu_dtype=..., adam_nu_dtype=...))``,
over a MultiStepLR milestone: the parameters agree within 1e-6 of their
largest, and the stored moments are equal bit for bit (bfloat16 as its
bits). optax runs op by op, as its functions are written: jitted, XLA's
CPU fusions contract and reorder the multiply-adds and keep bfloat16
products in f32, which moves the last bits. A resumed optimizer goes on
bit for bit, and the CLIs resolve --fast_math as the JAX CLI does.

The fused step's CPU side: on CPU tensors ``adam_fused_step`` is the
plain ``adam_reference``; its table's refusals; the host part of a
graphed step (counts, lr, bias corrections) across the milestone equal
to an eager step's; and the state Adam owns. The kernel itself is held
to the plain version on the card (``tests/test_torch_train_graph.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqa_project_tpu.cli.run import input_args as j_input_args
from vqa_project_tpu.cli.run import resolve_dtype_knobs as j_resolve
from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_project_tpu_torch.cli import medical
from vqa_project_tpu_torch.cli import run
from vqa_project_tpu_torch.config import TrainConfig
from vqa_project_tpu_torch.ops.adam import (AdamTable, adam_fused_step,
                                            adam_reference)
from vqa_project_tpu_torch.train.state import Adam, adam_step, make_optimizer

SHAPES = {"w": (37, 11), "b": (5,), "u": (64, 3)}
LR, SPE, STEPS = 1e-3, 2, 5
# the milestone after epoch 1 = step 2: steps 3-5 run at LR / 2
MILESTONES = (1,)
PAIRS = [(mu, nu) for mu in ("float32", "bfloat16")
         for nu in ("float32", "bfloat16")]


def _inputs(seed=0):
    """Parameters and STEPS gradients spread over six decades."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 2, s)
                  ).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


class _Params(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(
                k, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _port(params, grads, mu, nu, model=None, opt=None):
    """The port's optimizer and scheduler after len(grads) steps."""
    if model is None:
        model = _Params(params)
        opt = make_optimizer(model, TrainConfig(
            lr=LR, lr_milestones=MILESTONES, adam_mu_dtype=mu,
            adam_nu_dtype=nu), SPE)
    optimizer, scheduler = opt
    for g in grads:
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        optimizer.step()
        scheduler.step()
    return model, (optimizer, scheduler)


def _jax(params, grads, mu, nu):
    """JAX's parameters and ScaleByAdamState after the steps, op by op."""
    tx = j_make_optimizer(JTrainConfig(lr=LR, lr_milestones=MILESTONES,
                                       adam_mu_dtype=mu, adam_nu_dtype=nu),
                          SPE)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, p)
        p = optax.apply_updates(p, updates)
    (adam,) = [s for s in jax.tree.leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return p, adam


def _bits(x) -> np.ndarray:
    """A moment's bits: bfloat16 as int16, float32 as int32."""
    if torch.is_tensor(x):
        wide = x.dtype == torch.float32
        return x.view(torch.int32 if wide else torch.int16).numpy()
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int16)


@pytest.mark.parametrize("mu,nu", PAIRS)
def test_matches_optax_over_a_milestone(mu, nu):
    params, grads = _inputs()
    model, (optimizer, scheduler) = _port(params, grads, mu, nu)
    jp, adam = _jax(params, grads, mu, nu)
    assert scheduler.get_last_lr()[0] == LR * 0.5
    for k, p in model.named_parameters():
        want = np.asarray(jp[k])
        err = np.abs(p.detach().numpy() - want).max()
        assert err <= 1e-6 * np.abs(want).max(), (k, err)
        st = optimizer.state[p]
        assert st["exp_avg"].dtype == getattr(torch, mu)
        assert st["exp_avg_sq"].dtype == getattr(torch, nu)
        assert np.array_equal(_bits(st["exp_avg"]), _bits(adam.mu[k])), k
        assert np.array_equal(_bits(st["exp_avg_sq"]), _bits(adam.nu[k])), k
        assert int(st["step"]) == int(adam.count) == STEPS


@pytest.mark.parametrize("mu,nu", PAIRS)
def test_resume_goes_on_bit_for_bit(mu, nu):
    """2 steps, the optimizer's and scheduler's state into fresh ones,
    3 more: the parameters and moments of 5 uninterrupted steps."""
    params, grads = _inputs(1)
    whole, (o_whole, _) = _port(params, grads, mu, nu)
    first, (o1, s1) = _port(params, grads[:2], mu, nu)
    model = _Params({k: p.detach().numpy()
                     for k, p in first.named_parameters()})
    opt = make_optimizer(model, TrainConfig(
        lr=LR, lr_milestones=MILESTONES, adam_mu_dtype=mu,
        adam_nu_dtype=nu), SPE)
    opt[0].load_state_dict(o1.state_dict())
    opt[1].load_state_dict(s1.state_dict())
    resumed, (o2, _) = _port(None, grads[2:], mu, nu, model, opt)
    for (k, a), (_, b) in zip(whole.named_parameters(),
                              resumed.named_parameters()):
        assert torch.equal(a, b), k
        sa, sb = o_whole.state[a], o2.state[b]
        for key in ("exp_avg", "exp_avg_sq"):
            assert sa[key].dtype == sb[key].dtype
            assert np.array_equal(_bits(sa[key]), _bits(sb[key])), (k, key)


def test_load_casts_to_the_configured_dtypes():
    """float32 moments loaded into a bfloat16-moment Adam round to
    bfloat16 as jnp.asarray(x, bfloat16) does (JAX's resume into a
    bfloat16 template); bfloat16 moments into float32 widen exactly."""
    params, grads = _inputs(2)
    model, (o32, _) = _port(params, grads[:3], "float32", "float32")
    to16 = Adam(model.parameters(), mu_dtype=torch.bfloat16,
                nu_dtype=torch.bfloat16)
    to16.load_state_dict(o32.state_dict())
    for p in model.parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            got = to16.state[p][key]
            want = jnp.asarray(o32.state[p][key].numpy(), jnp.bfloat16)
            assert got.dtype == torch.bfloat16
            assert np.array_equal(_bits(got), _bits(want))
    back = Adam(model.parameters())
    back.load_state_dict(to16.state_dict())
    for p in model.parameters():
        assert torch.equal(back.state[p]["exp_avg"],
                           to16.state[p]["exp_avg"].float())
        assert back.state[p]["exp_avg"].dtype == torch.float32


def test_refuses_other_moment_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        Adam([torch.nn.Parameter(torch.zeros(2))], mu_dtype=torch.float16)


# (argv, the Adam dtypes both CLIs resolve); JAX's third knob,
# grad_reduce, has no counterpart on one card
FAST_MATH = [
    ([], ("float32", "float32")),
    (["--fast_math"], ("bfloat16", "bfloat16")),
    (["--fast_math", "--adam_nu_dtype", "float32"],
     ("bfloat16", "float32")),
    (["--fast_math", "--adam_mu_dtype", "float32"],
     ("float32", "bfloat16")),
    (["--adam_mu_dtype", "bfloat16"], ("bfloat16", "float32")),
    (["--adam_nu_dtype", "bfloat16"], ("float32", "bfloat16")),
]


@pytest.mark.parametrize("argv,want", FAST_MATH,
                         ids=lambda a: " ".join(a) or "none"
                         if isinstance(a, list) else None)
def test_fast_math_resolves_as_the_jax_cli(argv, want):
    args, _, unparsed = run.input_args(argv)
    assert not unparsed
    assert run.resolve_dtype_knobs(args) == want
    assert j_resolve(j_input_args(argv)[0])[:2] == want
    _, tcfg = run.make_configs(args)
    assert (tcfg.adam_mu_dtype, tcfg.adam_nu_dtype) == want
    margs, _, unparsed = medical.medical_input_args(argv)
    assert not unparsed
    _, mtcfg = medical.make_configs(margs)
    assert (mtcfg.adam_mu_dtype, mtcfg.adam_nu_dtype) == want


# ---------------- the fused step's CPU side ----------------

def _moment_lists(params, grads, mu, nu, seed=3):
    rng = np.random.default_rng(seed)
    ps = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    gs = [torch.from_numpy(grads[0][k].copy()) for k in SHAPES]
    mus = [torch.from_numpy(rng.standard_normal(SHAPES[k]).astype(
        np.float32) * 1e-2).to(getattr(torch, mu)) for k in SHAPES]
    nus = [torch.from_numpy(rng.uniform(size=SHAPES[k]).astype(
        np.float32) * 1e-3).to(getattr(torch, nu)) for k in SHAPES]
    return ps, gs, mus, nus


@pytest.mark.parametrize("mu,nu", PAIRS)
def test_cpu_tensors_take_the_plain_version(mu, nu):
    """On CPU tensors adam_fused_step is adam_reference, bit for bit,
    with the moments written into the given tensors and no launch."""
    params, grads = _inputs(4)
    ps, gs, mus, nus = _moment_lists(params, grads, mu, nu)
    want_p = [p.clone() for p in ps]
    want_mu, want_nu = adam_reference(want_p, gs, mus, nus, LR, 0.19, 0.00199)
    table = AdamTable(ps, gs, mus, nus)
    assert table.key is None and not table.matches(ps, gs, mus, nus)
    held = [m for m in mus]
    launches = adam_fused_step.launches
    adam_fused_step(table, torch.tensor([LR, 0.19, 0.00199]))
    assert adam_fused_step.launches == launches
    for got, want in zip(ps + mus + nus, want_p + want_mu + want_nu):
        assert got.dtype == want.dtype
        assert np.array_equal(_bits(got), _bits(want))
    assert all(a is b for a, b in zip(held, table.mus))


@pytest.mark.parametrize("bad", ["length", "device", "param_dtype",
                                 "mixed_moments", "moment_dtype", "shape",
                                 "scalars"])
def test_table_refusals(bad):
    params, grads = _inputs(5)
    ps, gs, mus, nus = _moment_lists(params, grads, "float32", "bfloat16")
    scalars = torch.tensor([LR, 0.1, 0.001])
    if bad == "length":
        gs = gs[:-1]
    elif bad == "device":
        nus[1] = nus[1].to("meta")
    elif bad == "param_dtype":
        ps[0] = ps[0].double()
    elif bad == "mixed_moments":
        mus[2] = mus[2].to(torch.bfloat16)
    elif bad == "moment_dtype":
        nus = [v.half() for v in nus]
    elif bad == "shape":
        mus[0] = mus[0].reshape(-1)
    elif bad == "scalars":
        scalars = scalars[:2]
    error = TypeError if "dtype" in bad or bad == "mixed_moments" \
        else ValueError
    with pytest.raises(error):
        adam_fused_step(AdamTable(ps, gs, mus, nus), scalars)


# the schedule steps before the launch here, as in a graphed step, whose
# key's first (eager) call has called optimizer.step() already
@pytest.mark.filterwarnings("ignore:Detected call of")
@pytest.mark.parametrize("mu,nu", PAIRS)
def test_host_part_over_a_milestone_is_an_eager_step(mu, nu):
    """Adam's host part (``_advance``: the counts, then lr, 1 - b1^t and
    1 - b2^t in f32) followed by the launch, with the schedule stepped
    between them, as a graphed step orders them, gives each step the lr
    and bias corrections of an eager step and the same parameters,
    moments and counts bit for bit, across the milestone."""
    params, grads = _inputs(6)
    eager, (o_e, s_e) = _port(params, [], mu, nu)
    split, (o_s, s_s) = _port(params, [], mu, nu)
    b1, b2 = o_s.param_groups[0]["betas"]
    for t, g in enumerate(grads, start=1):
        for (k, p), q in zip(eager.named_parameters(), split.parameters()):
            p.grad = torch.from_numpy(g[k].copy())
            q.grad = torch.from_numpy(g[k].copy())
        lr_before = o_e.param_groups[0]["lr"]
        o_e.step()
        s_e.step()
        qs = list(split.parameters())
        lists = o_s._launch_lists(0, qs)
        scalars = o_s._advance(0, qs)
        s_s.step()
        with torch.no_grad():
            adam_fused_step(AdamTable(*lists), scalars)
        lr, bc1, bc2 = scalars.tolist()
        assert lr == float(torch.tensor(lr_before, dtype=torch.float32))
        assert lr_before == (LR if t <= SPE else LR * 0.5)
        assert bc1 == float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        assert bc2 == float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
        assert adam_step(o_s) == adam_step(o_e) == t
    for p, q in zip(eager.parameters(), split.parameters()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            a, b = o_e.state[p][key], o_s.state[q][key]
            assert a.dtype == b.dtype and torch.equal(a, b), key
    assert s_s.get_last_lr() == s_e.get_last_lr()


def test_adam_owns_its_state():
    """The moments of a group are views of one buffer each and the
    counts of one CPU tensor; a loaded state is copied in, never shared
    with the optimizer it came from."""
    params, grads = _inputs(7)
    model, (opt, _) = _port(params, grads[:2], "bfloat16", "float32")
    pack = opt._packs[0]
    for p in model.parameters():
        st = opt.state[p]
        assert st["exp_avg"].untyped_storage().data_ptr() == \
            pack.mu.untyped_storage().data_ptr()
        assert st["exp_avg"].is_contiguous()
        assert st["exp_avg"].data_ptr() % 16 == 0
        assert st["step"].untyped_storage().data_ptr() == \
            pack.steps.untyped_storage().data_ptr()
    other = Adam(model.parameters(), mu_dtype=torch.bfloat16)
    other.load_state_dict(opt.state_dict())
    for p in model.parameters():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            a, b = opt.state[p][key], other.state[p][key]
            assert torch.equal(a, b)
            assert a.untyped_storage().data_ptr() != \
                b.untyped_storage().data_ptr()
    before = {p: opt.state[p]["exp_avg"].clone() for p in model.parameters()}
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    other.step()
    for p in model.parameters():
        assert torch.equal(opt.state[p]["exp_avg"], before[p])
        assert int(opt.state[p]["step"]) == 2
        assert int(other.state[p]["step"]) == 3
