"""The port's training (``storm_tpu_torch.parallel.train``,
``storm_tpu_torch.data.train_to_convergence``, ``save_checkpoint``)
against storm_tpu's on the CPU.

Both packages start from the same parameters, seeded numpy trees in the
JAX layout (the port's ``init_params``; storm_tpu's where a test says so),
and take the same numpy batches. Each family's step runs
three times; each port step after the first starts from storm_tpu's
parameters, optimizer moments and BatchNorm state after the steps before
it, so every comparison is one step of each package from one point: the
loss within 1e-5 relative, the parameters, both Adam moments, the
BatchNorm statistics and ``moe_aux_loss`` within 1e-4.

Why the family steps run AdamW at eps = 1.0 (in both packages) and not
optax's 1e-8: a leaf whose gradient is zero in exact arithmetic (the key
projection's bias under the softmax, the Mixer token MLP's output bias
and MobileNetV2's projection BatchNorm bias under a following LayerNorm
or train-mode BatchNorm) gets rounding noise of ~1e-8 for a gradient,
which Adam's first step at eps = 1e-8 turns into a full learning-rate
step in a direction set by rounding. Optax's defaults themselves (and
PyTorch's other decay default) are held by the lenet5 tests below, which
have no such leaf, and by ``train_to_convergence``.

Conditioning: a ReLU input within f32 rounding of zero takes either side
in two implementations of one forward. ResNet-20 and MobileNetV2 run at
16x16 with 4 rows. From storm_tpu's own init, ResNet-20 at 32x32 with 8
rows has one input of its last block 1.7e-6 from zero, and one ulp of
input moves its gradient by 0.8 % of the largest; MobileNetV2 had such an
input on every batch tried, its gradient at initialization determined to
~1 % in f32 (the port's own f32 and f64 gradients differ that much, as
storm_tpu's and the port's do). So MobileNetV2's moments are held to 3e-2
of the largest moment of the model, its loss, state and parameters to the bounds
above (at eps = 1.0 a gradient error moves a parameter by about the
learning rate times it).

storm_tpu compiles each family's step (and builds its init eagerly) for
seconds on the CPU, so the comparisons are spread over files that each
take under 25 s alone: the steps of moe_vit_tiny, mixer_tiny and
longseq_tiny are in ``tests/test_torch_train_zoo.py``, mobilenetv2's in
``tests/test_torch_train_mobilenet.py``, ``train_to_convergence`` and the
exported initial parameters in ``tests/test_torch_train_init.py`` and
``tests/test_torch_train_init_deep.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from storm_tpu.data import train_to_convergence as jax_train_to_convergence
from storm_tpu.models.registry import build_model as jax_build_model
from storm_tpu.models.registry import init_params as jax_init_params
from storm_tpu.parallel.train import make_train_step as jax_make_train_step
from storm_tpu_torch.config import ModelConfig
from storm_tpu_torch.data import load_digits_nhwc, train_to_convergence
from storm_tpu_torch.models.convert import (
    host_tree, state_tensors, trainable_params, tree_leaves)
from storm_tpu_torch.models.registry import (
    check_checkpoint, load_checkpoint, model_def, save_checkpoint)
from storm_tpu_torch.parallel.train import (
    ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY, Optimizer, adam_moments,
    make_train_step, train_one_step)

LR = 1e-3
STEP_EPS = 1.0
ROWS = 4
FAMILIES = {
    "lenet5": {"input_shape": (32, 32, 1)},
    "resnet20": {"input_shape": (16, 16, 3)},
    "vit_tiny": {},
    "moe_vit_tiny": {},
    "mixer_tiny": {},
    "mobilenetv2": {"input_shape": (16, 16, 3)},
    "longseq_tiny": {},
}
# The families whose steps this file holds.
HERE = ("lenet5", "resnet20", "vit_tiny")
# MobileNetV2's moments, relative to the model's largest (see above).
MOMENT_TOL = {"mobilenetv2": 3e-2}


def _items(tree, prefix=()):
    """``(path, leaf)`` of a tree of dicts and lists, JAX or torch leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (i,))
    else:
        yield prefix, tree


def _np(tree) -> dict:
    return {p: (v.detach().numpy() if isinstance(v, torch.Tensor) else np.array(v))
            for p, v in _items(tree)}


def _close(got, want, tol: float, what: str, relative: bool = False) -> None:
    """Every leaf within ``tol``; with ``relative``, of the largest
    magnitude over all of ``want``'s leaves."""
    g, w = _np(got), _np(want)
    assert g.keys() == w.keys(), (what, sorted(map(str, g.keys() ^ w.keys()))[:4])
    scale = max(float(np.abs(a).max()) for a in w.values()) if relative else 1.0
    for k in w:
        err = float(np.abs(g[k] - w[k]).max()) / scale
        assert err <= tol, (what, k, err)


def _port_opt(eps: float) -> Optimizer:
    return lambda params: torch.optim.AdamW(
        tree_leaves(params), lr=LR, betas=ADAMW_BETAS, eps=eps,
        weight_decay=ADAMW_WEIGHT_DECAY)


def _take_state(params, opt_state, jp, jos) -> None:
    """The port's leaves and AdamW state set to storm_tpu's, path by path."""
    adam = jos[0]
    ref = {name: _np(t) for name, t in (("p", jp), ("mu", adam.mu), ("nu", adam.nu))}
    with torch.no_grad():
        for path, leaf in _items(params):
            leaf.copy_(torch.from_numpy(ref["p"][path]))
            st = opt_state.state[leaf]
            st["exp_avg"].copy_(torch.from_numpy(ref["mu"][path]))
            st["exp_avg_sq"].copy_(torch.from_numpy(ref["nu"][path]))
            st["step"].fill_(float(adam.count))


def _batches(md, n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        draw = rng.randn if md.name == "mobilenetv2" else rng.rand
        x = draw(ROWS, *md.input_shape).astype(np.float32)
        yield x, rng.randint(0, md.num_classes, ROWS).astype(np.int32)


def _start(name: str, kw: dict):
    """storm_tpu's model, the port's, and the port's seeded ``(params,
    state)`` as JAX arrays."""
    md = model_def(name, **kw)
    params, state = md.init(np.random.RandomState(0))
    return (jax_build_model(name, **kw), md, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, state))


def check_train_steps(name: str) -> None:
    """Three steps, each held after it: loss, parameters, moments, state."""
    jm, md, jp, js = _start(name, FAMILIES[name])
    jstep, jopt = jax_make_train_step(jm, optax.adamw(LR, eps=STEP_EPS))
    jos = jopt.init(jp)
    params = trainable_params(jax.tree.map(np.asarray, jp), "cpu")
    step, opt = make_train_step(md, _port_opt(STEP_EPS), device="cpu")
    opt_state = opt(params)
    state = state_tensors(jax.tree.map(np.asarray, js), "cpu")
    rel = MOMENT_TOL.get(name)
    for i, (x, y) in enumerate(_batches(md, 3)):
        if i:
            _take_state(params, opt_state, jp, jos)
            state = state_tensors(jax.tree.map(np.asarray, js), "cpu")
        jp, jos, js, jloss = jstep(jp, jos, js, jnp.asarray(x), jnp.asarray(y))
        params, opt_state, state, loss = step(params, opt_state, state, x, y)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), (i, loss, jloss)
        _close(host_tree(params), jp, 1e-4, f"params after step {i + 1}")
        mu, nu = adam_moments(params, opt_state)
        _close(mu, jos[0].mu, rel or 1e-4, f"mu after step {i + 1}", relative=bool(rel))
        _close(nu, jos[0].nu, rel or 1e-4, f"nu after step {i + 1}", relative=bool(rel))
        _close(host_tree(state), js, 1e-4, f"state after step {i + 1}")
    assert ("moe_aux_loss" in js) == ("moe_aux_loss" in state) == (name == "moe_vit_tiny")


@pytest.mark.parametrize("name", HERE)
def test_train_step_matches_storm_tpu(name):
    check_train_steps(name)


def test_default_optimizer_is_optax_adamw_and_its_steps_match():
    """``adamw`` is optax's (betas 0.9 / 0.999, eps 1e-8, decay 1e-4 on
    every leaf; PyTorch's default decay is 1e-2); three lenet5 steps of
    the default optimizer through ``train_one_step``, the port running
    on its own, within the bounds above."""
    assert (ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY) == ((0.9, 0.999), 1e-8, 1e-4)
    name = "lenet5"
    jm, md, jp, js = _start(name, FAMILIES[name])
    jstep, jopt = jax_make_train_step(jm)
    jos = jopt.init(jp)
    params = trainable_params(jax.tree.map(np.asarray, jp), "cpu")
    step, opt = make_train_step(md, device="cpu")
    opt_state = opt(params)
    group = opt_state.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == \
        (LR, ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY)
    assert len(group["params"]) == len(jax.tree.leaves(jp))
    state = {}
    for x, y in _batches(md, 3, seed=1):
        jp, jos, js, jloss = jstep(jp, jos, js, jnp.asarray(x), jnp.asarray(y))
        params, opt_state, state, loss = train_one_step(step, params, opt_state, state, x, y)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _close(host_tree(params), jp, 1e-4, "params")
    mu, nu = adam_moments(params, opt_state)
    _close(mu, jos[0].mu, 1e-4, "mu")
    _close(nu, jos[0].nu, 1e-4, "nu")


def test_training_entry_points_run_on_the_card_unless_asked():
    """No card on this box: every training entry point raises unless the
    caller passes ``device="cpu"``."""
    md = model_def("lenet5")
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(md)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainable_params(md.init(np.random.RandomState(0))[0])
    x = np.zeros((2, 28, 28, 1), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_to_convergence(md, x, np.zeros(2, np.int32), max_epochs=1, batch_size=2)


def test_save_checkpoint_round_trip(tmp_path):
    """A trained resnet20's params and BatchNorm state through
    ``save_checkpoint``: ``load_checkpoint`` gives them back bit for bit,
    ``check_checkpoint`` and ``ModelConfig.from_checkpoint`` accept it,
    and a model built from it computes what the trained leaves compute."""
    md = model_def("resnet20", input_shape=(16, 16, 3))
    params, state = md.init(np.random.RandomState(0))
    step, opt = make_train_step(md, device="cpu")
    tp, ts = trainable_params(params, "cpu"), state_tensors(state, "cpu")
    x, y = next(_batches(md, 1))
    tp, _opt, ts, _loss = step(tp, opt(tp), ts, x, y)
    params, state = host_tree(tp), host_tree(ts)
    path = save_checkpoint(tmp_path / "resnet20.npz", params, state, md)
    got_p, got_s, meta = load_checkpoint(str(path))
    for want, got in ((params, got_p), (state, got_s)):
        w, g = _np(want), _np(got)
        assert w.keys() == g.keys() and all(np.array_equal(w[k], g[k]) for k in w)
    check_checkpoint(md, got_p, got_s, meta, str(path))
    cfg = ModelConfig.from_checkpoint(str(path))
    assert (cfg.name, cfg.input_shape, cfg.num_classes) == ("resnet20", (16, 16, 3), 10)
    from storm_tpu_torch.models.convert import from_jax_params

    model = from_jax_params(got_p, md, got_s, device="cpu")
    with torch.no_grad():
        want, _ = md.apply(tp, ts, torch.from_numpy(x), train=False)
        np.testing.assert_array_equal(model(torch.from_numpy(x)).numpy(), want.numpy())
    with pytest.raises(ValueError, match="does not fit"):
        check_checkpoint(md, got_p, {}, meta, str(path))
