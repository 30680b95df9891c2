"""``train_to_convergence`` against storm_tpu's on the CPU, and
storm_tpu's initial parameters for the card.

``export_torch_checkpoints.py`` writes storm_tpu's ``init_params(model,
0)`` of the four digits models at their input shapes to
``checkpoints_torch/<model>_init.npz``; ``chip_smoke.py`` trains from them,
so that only arithmetic separates the card's run from storm_tpu's. Each
file must hold storm_tpu's eager ``init_params`` bit for bit and fit the
port's model (lenet5 and vit_tiny here, resnet20 and moe_vit_tiny in
``tests/test_torch_train_init_deep.py``: building them costs storm_tpu
seconds of op-by-op compiles)."""

import jax
import numpy as np
import pytest

from storm_tpu.data import train_to_convergence as jax_train_to_convergence
from storm_tpu.models.registry import build_model as jax_build_model
from storm_tpu.models.registry import init_params as jax_init_params
from storm_tpu_torch.data import load_digits_nhwc, train_to_convergence
from storm_tpu_torch.models.convert import trainable_params
from storm_tpu_torch.models.registry import (
    CHECKPOINTS, check_checkpoint, load_checkpoint, model_def)
from storm_tpu_torch.parallel.train import make_train_step
from tests.test_torch_train import _close, _items, _np

# The snapshot's bound after train_to_convergence's 20 steps at optax's
# eps 1e-8: one learning rate (see the test).
SNAPSHOT_TOL = 1e-3
INIT_TAGS = {"lenet5_init": ("lenet5", (32, 32, 1)), "vit_tiny_init": ("vit_tiny", (32, 32, 3))}


def check_exported_init(tag: str, name: str, shape: tuple) -> None:
    jp, js = jax_init_params(jax_build_model(name, input_shape=shape), 0)
    params, state, meta = load_checkpoint(str(CHECKPOINTS / f"{tag}.npz"))
    for want, got in ((jp, params), (js, state)):
        w, g = _np(want), _np(got)
        assert w.keys() == g.keys() and all(np.array_equal(w[k], g[k]) for k in w)
    assert (meta["model"], tuple(meta["input_shape"]), meta["num_classes"]) == (name, shape, 10)
    check_checkpoint(model_def(name, input_shape=shape), params, state, meta, tag)


@pytest.mark.parametrize("tag", sorted(INIT_TAGS))
def test_exported_init_parameters_are_storm_tpus(tag):
    check_exported_init(tag, *INIT_TAGS[tag])


def test_train_to_convergence_matches_storm_tpu_on_lenet5():
    """Two epochs on the 1347 digits training rows from storm_tpu's init,
    the default optimizer: each epoch's mean loss within 1e-5 relative,
    the held-out accuracy equal, the snapshot within SNAPSHOT_TOL. At eps
    1e-8 Adam steps an element whose gradient is near rounding level by up
    to the learning rate in a direction rounding sets, and storm_tpu's own
    rounding moves with XLA's threading: after these 20 steps every leaf
    lay within 7.3e-05 of storm_tpu's in one process, and the kernel of
    c2 2.7e-04 away in another."""
    x_tr, y_tr, x_te, y_te = load_digits_nhwc((32, 32, 1))
    jm = jax_build_model("lenet5", input_shape=(32, 32, 1))
    jp0, js0 = jax_init_params(jm, 0)
    want_p, want_s, want_h = jax_train_to_convergence(jm, x_tr, y_tr, x_te, y_te, max_epochs=2)
    md = model_def("lenet5", input_shape=(32, 32, 1))
    got_p, got_s, got_h = train_to_convergence(
        md, x_tr, y_tr, x_te, y_te, max_epochs=2, device="cpu",
        init=(jax.tree.map(np.asarray, jp0), jax.tree.map(np.asarray, js0)))
    assert [h["epoch"] for h in got_h] == [h["epoch"] for h in want_h] == [0, 1]
    for g, w in zip(got_h, want_h):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * w["loss"]
        assert g["val_acc"] == w["val_acc"]
    _close(got_p, want_p, SNAPSHOT_TOL, "snapshot")
    assert got_s == {} == want_s
    assert all(isinstance(a, np.ndarray) for _p, a in _items(got_p))


def test_train_to_convergence_persists_only_the_declared_state():
    """A moe_vit_tiny run: the training state carries ``moe_aux_loss``,
    the snapshot does not (restore matches ``model.init``'s structure)."""
    md = model_def("moe_vit_tiny")
    x_tr, y_tr, x_te, y_te = load_digits_nhwc((32, 32, 3))
    params, state, hist = train_to_convergence(md, x_tr[:64], y_tr[:64], x_te[:32], y_te[:32],
                                               batch_size=32, max_epochs=1, device="cpu")
    assert state == {} and len(hist) == 1 and 0 <= hist[0]["val_acc"] <= 1
    step, opt = make_train_step(md, device="cpu")
    tp = trainable_params(params, "cpu")
    *_, st, _loss = step(tp, opt(tp), {}, x_tr[:8], y_tr[:8])
    assert set(st) == {"moe_aux_loss"} and float(st["moe_aux_loss"]) > 0
