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
from vqa_project_tpu_torch.train.state import Adam, make_optimizer

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
