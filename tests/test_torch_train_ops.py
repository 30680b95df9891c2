"""The port's kernel wrappers and layers under autograd, against storm_tpu
on the CPU: the gradients of the fused residual norm (x, r, scale, bias)
against ``jax.vjp`` of storm_tpu's ``_fused`` (its custom VJP), of flash
attention (q, k, v, the head dim padded and not) against ``jax.vjp`` of
``attention_reference`` (what storm_tpu's train step differentiates),
BatchNorm's train mode, ReLU6's gradient at its kinks and the MoE
layer's load-balancing loss.

On CPU tensors the wrappers run their plain versions, which autograd
could differentiate without any help; on the card the kernels write their
outputs outside autograd. The stub-kernel tests send CPU tensors down the
kernel branch with a launch that fills the outputs from the plain version
(no graph), so only the wrappers' autograd functions can carry the
gradient: they are the CPU check that would catch a wrapper without one.

Tolerances: gradients and outputs in float32 within 1e-5 of the largest
magnitude of storm_tpu's (absolute where the values are O(1)); bfloat16
BatchNorm within one bf16 rounding (1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import storm_tpu.ops.layers as JL
import storm_tpu.parallel.moe as jax_moe
from storm_tpu.ops.attention import attention_reference as jax_attention_reference
from storm_tpu.ops.fused_norm import _fused
from storm_tpu_torch.models.convert import init_params, trainable_params, tree_leaves
from storm_tpu_torch.models.registry import model_def
from storm_tpu_torch.ops import flash_attention as fa
from storm_tpu_torch.ops import fused_norm as fn
from storm_tpu_torch.ops import layers as L
from storm_tpu_torch.ops import quant_matmul as qm
from storm_tpu_torch.ops._build import KERNELS
from storm_tpu_torch.parallel.moe import moe_layer

TOL = 1e-5


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


# ---- the fused residual norm ------------------------------------------------


def _norm_inputs(rows: int, d: int, seed: int):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, d).astype(np.float32), rng.randn(rows, d).astype(np.float32),
            (1 + 0.1 * rng.randn(d)).astype(np.float32), (0.1 * rng.randn(d)).astype(np.float32),
            rng.randn(rows, d).astype(np.float32), rng.randn(rows, d).astype(np.float32))


@jax.jit
def _norm_vjp(x, r, g, b, cy, cout):
    return jax.vjp(lambda *a: _fused(*a, 1e-6), x, r, g, b)[1]((cy, cout))


@jax.jit
def _attention_vjp(q, k, v, cot):
    return jax.vjp(jax_attention_reference, q, k, v)[1](cot)


def _storm_tpu_norm_vjp(*arrays):
    return _norm_vjp(*map(jnp.asarray, arrays))


def _storm_tpu_attention_vjp(*arrays):
    return _attention_vjp(*map(jnp.asarray, arrays))


def _port_norm_grads(x, r, g, b, cy, cout):
    tx, tr, tg, tb = _leaves(x, r, g, b)
    y, out = fn.residual_layernorm({"scale": tg, "bias": tb}, tx, tr)
    torch.autograd.backward((y, out), (torch.from_numpy(cy), torch.from_numpy(cout)))
    return tx.grad, tr.grad, tg.grad, tb.grad


@pytest.mark.parametrize("rows,d", [(24, 64), (10, 48), (6, 768)])
def test_fused_norm_gradients_match_storm_tpu_vjp(rows, d):
    """Cotangents on both outputs (the residual stream and the normed
    one): x (the branch), r (the stream), scale and bias, against storm_tpu's
    custom VJP, which is ``jax.vjp`` of its unfused reference."""
    x, r, g, b, cy, cout = _norm_inputs(rows, d, d)
    want = _storm_tpu_norm_vjp(x, r, g, b, cy, cout)
    got = _port_norm_grads(x, r, g, b, cy, cout)
    for name, gw, gg in zip(("x", "r", "scale", "bias"), want, got):
        assert gg is not None and _rel(gg, gw) <= TOL, name


def test_fused_norm_gradient_of_one_output_only():
    """A loss of the normed output alone (the stream unused) still reaches
    the four inputs, as storm_tpu's VJP with a zero cotangent does."""
    x, r, g, b, _cy, cout = _norm_inputs(8, 64, 3)
    want = _storm_tpu_norm_vjp(x, r, g, b, np.zeros_like(x), cout)
    tx, tr, tg, tb = _leaves(x, r, g, b)
    (fn.residual_layernorm({"scale": tg, "bias": tb}, tx, tr)[1]
     * torch.from_numpy(cout)).sum().backward()
    for gw, gg in zip(want, (tx.grad, tr.grad, tg.grad, tb.grad)):
        assert _rel(gg, gw) <= TOL


# ---- flash attention --------------------------------------------------------


def _qkv(shape, seed: int):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape", [
    (2, 2, 17, 16),   # a kernel head dim, unpadded
    (1, 4, 65, 8),    # longseq_tiny's D = 8, padded to 16
    (1, 2, 33, 24),   # D = 24, padded to 32
    (2, 3, 197, 64),  # ViT-B/16's sequence and head dim
])
def test_flash_gradients_match_storm_tpu_attention_vjp(shape):
    """q, k and v gradients against ``jax.vjp`` of storm_tpu's
    ``attention_reference`` (its train step differentiates that, never
    the Pallas kernel), the head dim padded as the wrapper pads it."""
    q, k, v, cot = _qkv(shape, shape[-1])
    want = _storm_tpu_attention_vjp(q, k, v, cot)
    tq, tk, tv = _leaves(q, k, v)
    out = fa.flash_attention(tq, tk, tv)
    assert out.shape == shape
    out.backward(torch.from_numpy(cot))
    for name, gw, gg in zip("qkv", want, (tq.grad, tk.grad, tv.grad)):
        assert _rel(gg, gw) <= TOL, name


# ---- the kernel branch under autograd (stub launches) -----------------------


@pytest.fixture
def stub_kernels(monkeypatch):
    """Route CPU tensors to the kernel branch of the three wrappers, with
    launches that write the plain versions' outputs into the buffers the
    wrappers allocated, outside autograd, as the CUDA kernels do. Yields
    the launches made, by kernel name."""
    launched = []

    def launch_norm(name):
        def launch(_dev, _code, _pcode, x2, r2, g, b, y, out, *_rest):
            with torch.no_grad():
                ry, rout = fn.fused_add_layernorm_reference(x2, r2, g, b, 1e-6)
                y.copy_(ry)
                out.copy_(rout)
            launched.append(name)
        return launch

    def launch_flash(name):
        def launch(_dev, _code, q, k, v, out, _bh, _s, _d, scale):
            with torch.no_grad():
                out.copy_(fa.flash_attention_reference(q, k, v, scale))
            launched.append(name)
        return launch

    def launch_w8a16(name):
        def launch(_dev, _code, x2, q, s, out, *_rest):
            with torch.no_grad():
                out.copy_(qm.w8a16_matmul_reference(x2, q, s))
            launched.append(name)
        return launch

    for module in (fn, fa, qm):
        monkeypatch.setattr(module, "route", lambda *_a: True)
        monkeypatch.setattr(module, "check_cuda", lambda _n, *t: t[0].device)
    for name, make in ((fn.SM90_VARIANT, launch_norm), (fa.F32_VARIANT, launch_flash),
                       (qm.F32_VARIANT, launch_w8a16)):
        monkeypatch.setattr(KERNELS[name], "launch", make(name))
    yield launched


def test_stub_kernels_cut_the_graph_without_the_functions(stub_kernels):
    """The trap the autograd functions close: the kernel branch's outputs
    carry no ``grad_fn``, so a bare call gives nothing upstream a gradient."""
    x, r, g, b, _cy, _cout = _norm_inputs(4, 64, 5)
    tx, tr, tg, tb = _leaves(x, r, g, b)
    y, out = fn.fused_add_layernorm(tx, tr, tg, tb)
    q, k, v, _cot = _qkv((1, 2, 9, 16), 6)
    attn = fa._flash_forward(*_leaves(q, k, v), None, None)
    assert stub_kernels == [fn.SM90_VARIANT, fa.F32_VARIANT]
    assert not any(t.requires_grad for t in (y, out, attn))


def test_stub_kernels_fused_norm_gradients_flow_and_match(stub_kernels):
    x, r, g, b, cy, cout = _norm_inputs(12, 64, 7)
    want = _storm_tpu_norm_vjp(x, r, g, b, cy, cout)
    got = _port_norm_grads(x, r, g, b, cy, cout)
    assert stub_kernels == [fn.SM90_VARIANT]
    for gw, gg in zip(want, got):
        assert gg is not None and _rel(gg, gw) <= TOL


@pytest.mark.parametrize("shape", [(1, 2, 21, 16), (1, 2, 21, 8)])
def test_stub_kernels_flash_gradients_flow_and_match(stub_kernels, shape):
    q, k, v, cot = _qkv(shape, 8)
    want = _storm_tpu_attention_vjp(q, k, v, cot)
    tq, tk, tv = _leaves(q, k, v)
    fa.flash_attention(tq, tk, tv).backward(torch.from_numpy(cot))
    assert stub_kernels == [fa.F32_VARIANT]
    for gw, gg in zip(want, (tq.grad, tk.grad, tv.grad)):
        assert gg is not None and _rel(gg, gw) <= TOL


def test_stub_kernels_vit_block_gives_every_leaf_a_gradient(stub_kernels):
    """A vit_tiny forward in train mode down the kernel branch: every
    parameter leaf gets a nonzero gradient, and the kernels launched."""
    md = model_def("vit_tiny")
    params = trainable_params(init_params(md, 0)[0], "cpu")
    x = torch.from_numpy(np.random.RandomState(9).rand(4, 32, 32, 3).astype(np.float32))
    logits, _ = md.apply(params, {}, x, train=True)
    torch.nn.functional.cross_entropy(logits, torch.tensor([1, 2, 3, 4])).backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in tree_leaves(params))
    assert stub_kernels.count(fn.SM90_VARIANT) == 2 and stub_kernels.count(fa.F32_VARIANT) == 2


# ---- w8a16: refused under grad on the card ----------------------------------


def _w8a16_inputs(requires_grad: bool):
    rng = np.random.RandomState(10)
    x = torch.tensor(rng.randn(4, 32).astype(np.float32), requires_grad=requires_grad)
    q = torch.from_numpy(rng.randint(-127, 128, (32, 16)).astype(np.int8))
    s = torch.from_numpy((rng.rand(16) * 0.01).astype(np.float32))
    return x, q, s


def test_w8a16_refuses_a_graph_on_the_kernel_branch(stub_kernels):
    """An input that requires grad, under grad mode, down the kernel
    branch: refused before any launch, never an output cut from the graph."""
    x, q, s = _w8a16_inputs(True)
    with pytest.raises(RuntimeError, match="no gradient on the card"):
        qm.w8a16_matmul(x, q, s)
    assert stub_kernels == []
    with torch.no_grad():
        out = qm.w8a16_matmul(x, q, s)
    x2, q, s = _w8a16_inputs(False)
    out2 = qm.w8a16_matmul(x2, q, s)
    assert stub_kernels == [qm.F32_VARIANT] * 2
    np.testing.assert_array_equal(out.numpy(), out2.numpy())


def test_w8a16_plain_version_stays_differentiable_on_the_cpu():
    x, q, s = _w8a16_inputs(True)
    qm.w8a16_matmul(x, q, s).sum().backward()
    want = (q.float() * s).sum(dim=1)
    np.testing.assert_allclose(x.grad.numpy(), np.broadcast_to(want.numpy(), (4, 32)),
                               rtol=1e-6)


# ---- BatchNorm's train mode, ReLU6, the MoE aux loss ------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_storm_tpu(dtype):
    """Output and new running statistics: the batch's f32 mean and biased
    variance over all axes but the last, ``0.9 * old + 0.1 * batch``."""
    jd, td, tol = {"float32": (jnp.float32, torch.float32, TOL),
                   "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}[dtype]
    rng = np.random.RandomState(11)
    x = (rng.randn(4, 5, 5, 16) * 2 + 1).astype(np.float32)
    scale, bias = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    mean, var = rng.randn(16).astype(np.float32), (rng.rand(16) + 0.1).astype(np.float32)
    want, want_s = JL.batchnorm({"scale": jnp.asarray(scale, jd), "bias": jnp.asarray(bias, jd)},
                                {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                                jnp.asarray(x, jd), train=True)
    got, got_s = L.batchnorm({"scale": torch.from_numpy(scale).to(td),
                              "bias": torch.from_numpy(bias).to(td)},
                             {"mean": torch.from_numpy(mean), "var": torch.from_numpy(var)},
                             torch.from_numpy(x).to(td), train=True)
    assert got.dtype == td and got_s["mean"].dtype == got_s["var"].dtype == torch.float32
    assert _rel(got, np.asarray(want, np.float32)) <= tol
    for k in ("mean", "var"):
        assert _rel(got_s[k], want_s[k]) <= TOL, k


def test_batchnorm_train_mode_gradients_match_storm_tpu():
    rng = np.random.RandomState(12)
    x = rng.randn(6, 3, 3, 8).astype(np.float32)
    scale, bias, cot = rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32), \
        rng.randn(6, 3, 3, 8).astype(np.float32)
    state = {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}

    def f(x, scale, bias):
        return JL.batchnorm({"scale": scale, "bias": bias},
                            {k: jnp.asarray(v) for k, v in state.items()}, x, train=True)[0]

    want = jax.jit(lambda *a: jax.vjp(f, *a[:3])[1](a[3]))(
        *map(jnp.asarray, (x, scale, bias, cot)))
    tx, ts, tb = _leaves(x, scale, bias)
    y, new_s = L.batchnorm({"scale": ts, "bias": tb},
                           {k: torch.from_numpy(v) for k, v in state.items()}, tx, train=True)
    assert not new_s["mean"].requires_grad and not new_s["var"].requires_grad
    y.backward(torch.from_numpy(cot))
    for gw, gg in zip(want, (tx.grad, ts.grad, tb.grad)):
        assert _rel(gg, gw) <= TOL


def test_relu6_gradient_at_its_kinks_is_jnp_clips():
    """``jnp.clip`` gives half the gradient at exactly 0 and 6 (a train-mode
    BatchNorm over a constant channel gives exactly 0); ``torch.clamp``
    would give all of it."""
    pts = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    want = jax.grad(lambda a: JL.relu6(a).sum())(jnp.asarray(pts))
    t = torch.tensor(pts, requires_grad=True)
    L.relu6(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


def test_moe_layer_returns_storm_tpus_load_balancing_loss():
    rng = np.random.RandomState(13)
    e, d, h = 4, 16, 32
    p = {"gate": rng.randn(d, e) / 4, "w_in": rng.randn(e, d, h) / 4,
         "b_in": rng.randn(e, h) * 0.1, "w_out": rng.randn(e, h, d) / 6,
         "b_out": rng.randn(e, d) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(2, 24, d).astype(np.float32)
    want_y, want_aux = jax.jit(jax_moe.moe_layer)({k: jnp.asarray(v) for k, v in p.items()},
                                                  jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got_y, got_aux = moe_layer(tp, torch.from_numpy(x))
    assert _rel(got_y, want_y) <= TOL
    assert abs(float(got_aux) - float(want_aux)) <= TOL * abs(float(want_aux))
    assert moe_layer(tp, torch.from_numpy(x), aux_loss_weight=None)[1] is None
