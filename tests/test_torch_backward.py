"""The port's ``append_backward`` / ``gradients`` against the JAX
package's, on the cases of tests/test_backward.py that the ported ops
cover: fc, multi-use accumulation, stop_gradient, the dropout grad op and
its grad-maker collision, the same var in two slots, the same input
under different attrs, softmax cross-entropy and global-norm clipping.

Each case builds the same program in both packages under
``unique_name.guard()``: the backward must append the same ops (types,
slots, var names: ``@RENAME@`` partials and their ``sum``,
``@ZERO`` fills, ``@UNUSED`` placeholders; attrs), and on the same numpy
inputs and weights (the JAX startup scope copied across) the fetched
gradients agree within 1e-5 in f32 (the same math in another summation
order).  Dropout draws differ between the packages, so its cases hold
the port to the semantics (the grad is the forward's mask) instead.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as treg

TOL = 1e-5


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if not k.startswith("__")})
            for op in program.global_block().ops]


def _fc_grad(fluid):
    L = fluid.layers
    x = L.data("x", shape=[4, 3], append_batch_size=False)
    loss = L.mean(L.fc(x, size=2, act="tanh"))
    pg = fluid.backward.append_backward(loss)
    feed = {"x": np.random.default_rng(0).standard_normal((4, 3))}
    return feed, [g.name for _, g in pg] + [loss.name]


def _multi_use(fluid):
    # y = x*x + x -> dy/dx = 2x + 1; x feeds two ops -> a sum op
    L = fluid.layers
    x = L.data("x", shape=[1, 3], append_batch_size=False)
    x.stop_gradient = False
    loss = L.reduce_sum(L.elementwise_add(L.elementwise_mul(x, x), x))
    grads = fluid.gradients(loss, x)
    return {"x": np.array([[1.0, -2.0, 3.0]])}, [g.name for g in grads]


def _stop_gradient(fluid):
    L = fluid.layers
    x = L.data("x", shape=[2, 2], append_batch_size=False)
    y = L.fc(x, size=2)
    y.stop_gradient = True
    loss = L.mean(L.fc(y, size=2))
    pg = fluid.backward.append_backward(loss)
    return ({"x": np.random.default_rng(1).standard_normal((2, 2))},
            [g.name for _, g in pg])


def _softmax_ce(fluid):
    L = fluid.layers
    x = L.data("x", shape=[5, 4], append_batch_size=False)
    x.stop_gradient = False
    lbl = L.data("l", shape=[5, 1], dtype="int64", append_batch_size=False)
    loss = L.mean(L.softmax_with_cross_entropy(x, lbl))
    grads = fluid.gradients(loss, x)
    return ({"x": np.random.default_rng(2).standard_normal((5, 4)),
             "l": np.array([[0], [1], [2], [3], [0]], np.int64)},
            [g.name for g in grads])


def _grad_maker_collision(fluid):
    # s = x + dropout(x, p=0): the maker's '<x>@GRAD' must not collide
    # with the generic partial -> ds/dx = 2
    L = fluid.layers
    x = L.data("x", shape=[1, 3], append_batch_size=False)
    x.stop_gradient = False
    s = L.elementwise_add(x, L.dropout(x, dropout_prob=0.0))
    grads = fluid.gradients(L.reduce_sum(s), x)
    return {"x": np.array([[1.0, 2.0, 3.0]])}, [g.name for g in grads]


def _two_slots(fluid):
    # gram = x x^T: x in both slots of one op -> two partials, one sum
    L = fluid.layers
    x = L.data("x", shape=[3, 4], append_batch_size=False)
    x.stop_gradient = False
    grads = fluid.gradients(L.reduce_sum(L.matmul(x, x, transpose_y=True)),
                            x)
    return ({"x": np.random.default_rng(3).standard_normal((3, 4))},
            [g.name for g in grads])


def _self_difference(fluid):
    L = fluid.layers
    x = L.data("x", shape=[2, 2], append_batch_size=False)
    x.stop_gradient = False
    grads = fluid.gradients(L.reduce_sum(L.elementwise_sub(x, x)), x)
    return {"x": np.ones((2, 2))}, [g.name for g in grads]


def _different_attrs(fluid):
    # two scale ops over x, only one differentiated: the primal-reuse
    # cache must key on the attrs
    L = fluid.layers
    x = L.data("x", [2, 2], append_batch_size=False)
    y1 = L.scale(x, scale=2.0)
    y1.stop_gradient = True
    loss = L.mean(L.scale(x, scale=3.0))
    fluid.backward.append_backward(loss, parameter_list=[x.name])
    L.mean(y1)
    return {"x": np.ones((2, 2))}, ["x@GRAD"]


def _global_norm_clip(fluid):
    L = fluid.layers
    x = L.data("x", shape=[2, 2], append_batch_size=False)
    loss = L.reduce_sum(L.fc(x, size=2)) * 1e6  # huge grads
    fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(1.0))
    fluid.optimizer.SGD(learning_rate=1.0).minimize(loss)
    params = [p.name for p in fluid.default_main_program().all_parameters()]
    return {"x": np.ones((2, 2))}, [loss.name] + params


CASES = {
    "fc_grad": _fc_grad,
    "multi_use_accumulation": _multi_use,
    "stop_gradient": _stop_gradient,
    "softmax_ce": _softmax_ce,
    "grad_maker_collision": _grad_maker_collision,
    "same_var_two_slots": _two_slots,
    "self_difference_is_zero": _self_difference,
    "same_input_different_attrs": _different_attrs,
    "global_norm_clip": _global_norm_clip,
}


def _build(fluid, case):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feed, fetch = CASES[case](fluid)
    return main, startup, feed, fetch


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax(case):
    jm, js, feed, fetch = _build(jfluid, case)
    tm, ts, _, tfetch = _build(tfluid, case)
    assert tfetch == fetch
    assert _ops(tm) == _ops(jm)
    for n, v in jm.global_block().vars.items():
        tv = tm.global_block().vars[n]
        assert (tv.shape, str(tv.dtype)) == (v.shape, str(v.dtype)), n
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    tscope = tfluid.Scope.from_numpy(
        {n: np.asarray(v) for n, v in jscope.vars.items() if v is not None},
        device="cpu")
    feed = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in feed.items()}
    want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
    got = tfluid.Executor(device="cpu").run(tm, feed=feed, fetch_list=fetch,
                                            scope=tscope)
    assert len(got) == len(fetch) > 0
    for name, a, b in zip(fetch, want, got):
        a = np.asarray(a)
        assert b.shape == a.shape, name
        np.testing.assert_allclose(b, a, atol=TOL, rtol=TOL, err_msg=name)


def test_analytic_values():
    """The port's grads against closed forms, independent of the JAX
    package: 2x + 1, 2 (collision), column sums, 0, 3/4."""
    def run(case):
        tm, ts, feed, fetch = _build(tfluid, case)
        scope = tfluid.Scope()
        exe = tfluid.Executor(device="cpu")
        exe.run(ts, scope=scope)
        return feed, exe.run(tm, feed={k: v.astype(np.float32)
                                       for k, v in feed.items()},
                             fetch_list=fetch, scope=scope)

    feed, (g,) = run("multi_use_accumulation")
    np.testing.assert_allclose(g, 2 * feed["x"] + 1, rtol=1e-6)
    _, (g,) = run("grad_maker_collision")
    np.testing.assert_allclose(g, np.full((1, 3), 2.0), rtol=1e-6)
    feed, (g,) = run("same_var_two_slots")
    np.testing.assert_allclose(
        g, 2.0 * feed["x"].sum(0, keepdims=True).repeat(3, 0), rtol=1e-5)
    _, (g,) = run("self_difference_is_zero")
    np.testing.assert_array_equal(g, np.zeros((2, 2)))
    _, (g,) = run("same_input_different_attrs")
    np.testing.assert_allclose(g, np.full((2, 2), 0.75), rtol=1e-6)


def test_dropout_grad_uses_the_forward_mask():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        L = tfluid.layers
        x = L.data("x", shape=[128], append_batch_size=False)
        x.stop_gradient = False
        y = L.dropout(x, dropout_prob=0.5)
        (gx,) = tfluid.gradients(L.reduce_sum(y), x)
    types = [op.type for op in main.global_block().ops]
    assert "dropout_grad" in types and "dropout_grad" == types[-1]
    out, g = tfluid.Executor(device="cpu").run(
        main, feed={"x": np.ones(128, np.float32)}, fetch_list=[y, gx],
        scope=tfluid.Scope())
    np.testing.assert_array_equal(g, (out != 0).astype(np.float32))
    assert 0.3 < (out != 0).mean() < 0.7


def test_registry_flags_match_jax():
    """no_vjp_grad / stop_gradient / grad makers of every op the port
    registers are the JAX package's."""
    from paddle_tpu.ops import registry as jreg

    for name in treg.registered_ops():
        t, j = treg.get(name), jreg.get(name)
        if t.generic_vjp:
            continue
        assert j is not None, name
        assert (t.no_vjp_grad, t.stop_gradient, t.grad_maker is None) == (
            j.no_vjp_grad, j.stop_gradient, j.grad_maker is None), name
    assert treg.get("dropout_grad").no_vjp_grad
    assert treg.get("mul_grad").generic_vjp
    assert treg.get("adam_grad") is None  # no grad through an update


def test_generic_grad_without_captured_forward_reruns_it():
    """A grad op whose forward ran in another step (the fallback
    emitter) gives the same grads as the primal-reuse path."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        L = tfluid.layers
        x = L.data("x", shape=[3, 4], append_batch_size=False)
        x.stop_gradient = False
        y = L.fc(x, size=5, act="tanh")
        (gx,) = tfluid.gradients(L.reduce_sum(L.elementwise_mul(y, y)), x)
    scope = tfluid.Scope()
    exe = tfluid.Executor(device="cpu")
    exe.run(startup, scope=scope)
    feed = {"x": np.random.default_rng(4).standard_normal((3, 4))
            .astype(np.float32)}
    (want,) = exe.run(main, feed=feed, fetch_list=[gx], scope=scope)
    ops = main.global_block().ops
    n_fwd = next(i for i, op in enumerate(ops) if op.type == "fill_constant")
    env = {"x": torch.as_tensor(feed["x"])}
    env.update({n: scope.find_var(n) for n in scope.vars})
    with torch.no_grad():
        treg.emit_ops(treg.EmitContext(device="cpu"), ops[:n_fwd], env)
        treg.emit_ops(treg.EmitContext(device="cpu"), ops[n_fwd:], env)
    np.testing.assert_allclose(env[gx.name].numpy(), want, atol=1e-6)
